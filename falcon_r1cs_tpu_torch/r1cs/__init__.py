"""R1CS core: constraint system, linear combinations, symbolic wires."""

from .system import (
    ONE,
    ConstraintSystem,
    SynthesisError,
    is_witness,
    lc_add_into,
    lc_scale,
    var_index,
    var_instance,
    var_witness,
)
from .wires import Boolean, FpVar

__all__ = [
    "Boolean",
    "ConstraintSystem",
    "FpVar",
    "ONE",
    "SynthesisError",
    "is_witness",
    "lc_add_into",
    "lc_scale",
    "var_index",
    "var_instance",
    "var_witness",
]

from .coo import CompiledR1CS, compile_circuit

__all__ += ["CompiledR1CS", "compile_circuit"]
