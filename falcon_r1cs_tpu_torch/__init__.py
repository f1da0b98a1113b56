"""falcon_r1cs_tpu_torch: the PyTorch + CUDA port of falcon_r1cs_tpu.

The main path of the JAX package, from wire-format Falcon signatures to
verify-with-NTT witnesses and a CRT satisfiability verdict, and the
dual-NTT and schoolbook witness paths, in torch, with the TPU kernels on
those paths rewritten by hand in CUDA C++ for Hopper (csrc/).  The JAX
package is the unchanged reference the port is tested against.  The host
layers that contain no JAX (parameter sets, circuits, constraint system,
COO compilation, the clear-side Falcon codecs and the native C) are the
JAX package's own and are re-exported here; this package never imports
JAX.
"""

from falcon_r1cs_tpu import (
    ConstraintSystem,
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
)
from falcon_r1cs_tpu.params import FALCON_512, FALCON_1024, Q, FalconParams, get_params
from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS, compile_circuit

from .parallel.sat_check import ResidueSystem
from .pipeline import ProverInputPipeline, ProverInputs
from .utils.config import RuntimeConfig

__all__ = [
    "CompiledR1CS",
    "ConstraintSystem",
    "FALCON_1024",
    "FALCON_512",
    "FalconDualNTTVerificationCircuit",
    "FalconNTTVerificationCircuit",
    "FalconParams",
    "FalconSchoolBookVerificationCircuit",
    "ProverInputPipeline",
    "ProverInputs",
    "Q",
    "ResidueSystem",
    "RuntimeConfig",
    "compile_circuit",
    "get_params",
]
