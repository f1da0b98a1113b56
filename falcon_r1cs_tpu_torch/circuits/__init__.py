"""Circuit layer: the three verification circuits
(`falcon-r1cs/src/circuits/mod.rs`)."""

from .falcon_dual_ntt import FalconDualNTTVerificationCircuit
from .falcon_ntt import FalconNTTVerificationCircuit, const_q_power_vars
from .falcon_schoolbook import FalconSchoolBookVerificationCircuit

__all__ = [
    "FalconDualNTTVerificationCircuit",
    "FalconNTTVerificationCircuit",
    "FalconSchoolBookVerificationCircuit",
    "const_q_power_vars",
]
