"""Gadget layer: public surface mirrors the reference's `pub use gadgets::*`
(`falcon-r1cs/src/lib.rs:8`,
`falcon-r1cs/src/gadgets/mod.rs`)."""

from .arithmetics import (
    add_mod,
    inner_product_mod,
    mod_q,
    mul_mod,
    sub_mod,
    vector_matrix_mul_mod,
)
from .dual_poly import DualNTTPolyVar, DualPolyVar
from .misc import (
    enforce_decompose,
    inv_ntt_param_var,
    l2_norm_var,
    l2_norm_var_without_range_check,
    ntt_param_var,
)
from .poly import NTTPolyVar, PolyVar
from .range_proofs import (
    enforce_less_than_1024,
    enforce_less_than_norm_bound,
    enforce_less_than_q,
    is_less_than_6144,
)

__all__ = [
    "DualNTTPolyVar",
    "DualPolyVar",
    "NTTPolyVar",
    "PolyVar",
    "add_mod",
    "enforce_decompose",
    "enforce_less_than_1024",
    "enforce_less_than_norm_bound",
    "enforce_less_than_q",
    "inner_product_mod",
    "inv_ntt_param_var",
    "is_less_than_6144",
    "l2_norm_var",
    "l2_norm_var_without_range_check",
    "mod_q",
    "mul_mod",
    "ntt_param_var",
    "sub_mod",
    "vector_matrix_mul_mod",
]
