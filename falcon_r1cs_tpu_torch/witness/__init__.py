"""Batched witness engines of the port: verify-with-NTT, dual-NTT and
schoolbook circuits."""

from .api import CircuitWitness, circuit_witness
from .engine import WitnessBatch, generate_witness_ntt, witness_engine
from .engine_dual import generate_witness_dual, interleave_witness_dual, witness_engine_dual
from .engine_schoolbook import (
    generate_witness_schoolbook,
    interleave_witness_schoolbook,
    witness_engine_schoolbook,
)
from .export_device import packer_dual, packer_ntt, packer_schoolbook
from .layout import bound_width, export_witness_limbs, interleave_witness, num_witness

__all__ = [
    "CircuitWitness",
    "WitnessBatch",
    "bound_width",
    "circuit_witness",
    "export_witness_limbs",
    "generate_witness_dual",
    "generate_witness_ntt",
    "generate_witness_schoolbook",
    "interleave_witness",
    "interleave_witness_dual",
    "interleave_witness_schoolbook",
    "num_witness",
    "packer_dual",
    "packer_ntt",
    "packer_schoolbook",
    "witness_engine",
    "witness_engine_dual",
    "witness_engine_schoolbook",
]
