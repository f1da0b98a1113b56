"""falcon_r1cs_tpu_torch: the PyTorch + CUDA port of falcon_r1cs_tpu.

The main path of the JAX package, from wire-format Falcon signatures to
verify-with-NTT witnesses and a CRT satisfiability verdict, the dual-NTT
and schoolbook witness paths, and the Groth16 prover's G1 MSMs, in torch,
with the TPU kernels on those paths rewritten by hand in CUDA C++ for
Hopper (csrc/).  The JAX package is the unchanged reference the port is
tested against.  The host layers (parameter sets, circuits, gadgets,
constraint system, COO compilation, the clear-side Falcon codecs, the
host SNARK and the native C) are the port's own copies of the JAX
package's; this package imports neither JAX nor the JAX package.
"""

from .circuits import (
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
)
from .gadgets import *  # noqa: F401,F403  (gadget layer is public surface)
from .gadgets import __all__ as _gadgets_all
from .params import FALCON_512, FALCON_1024, FIELD_MODULUS, Q, FalconParams, get_params
from .parallel.sat_check import ResidueSystem
from .pipeline import ProverInputPipeline, ProverInputs
from .r1cs import Boolean, CompiledR1CS, ConstraintSystem, FpVar, SynthesisError, compile_circuit
from .utils.config import RuntimeConfig

__all__ = [
    "Boolean",
    "CompiledR1CS",
    "ConstraintSystem",
    "FALCON_1024",
    "FALCON_512",
    "FIELD_MODULUS",
    "FalconDualNTTVerificationCircuit",
    "FalconNTTVerificationCircuit",
    "FalconParams",
    "FalconSchoolBookVerificationCircuit",
    "FpVar",
    "ProverInputPipeline",
    "ProverInputs",
    "Q",
    "ResidueSystem",
    "RuntimeConfig",
    "SynthesisError",
    "compile_circuit",
    "get_params",
] + list(_gadgets_all)
