"""Batched witness engine of the port: verify-with-NTT circuit."""

from .api import CircuitWitness, circuit_witness
from .engine import WitnessBatch, generate_witness_ntt, witness_engine
from .export_device import packer_ntt
from .layout import bound_width, interleave_witness, num_witness

__all__ = [
    "CircuitWitness",
    "WitnessBatch",
    "bound_width",
    "circuit_witness",
    "generate_witness_ntt",
    "interleave_witness",
    "num_witness",
    "packer_ntt",
    "witness_engine",
]
