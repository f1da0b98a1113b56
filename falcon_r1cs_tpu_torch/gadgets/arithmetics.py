"""Hint-based mod-q arithmetic gadgets in the big SNARK field.

Re-derivation of `falcon-r1cs/src/gadgets/arithmetics.rs`:
witness the quotient t and remainder, constrain `expr - t*q = rem`, then
range-prove `rem < q`.  Assumes field order > q^2 (no overflow), exactly as
the reference notes (`arithmetics.rs:50-52`).

Measured costs under the pinned wire model (reference doc-comment values in
parentheses where they differ -- the goldens force ours):
  mod_q / add_mod           : 30 constraints, 29 witnesses
  mul_mod                   : 31 constraints, 30 witnesses (doc said 30; the
                              a*b product wire costs 1/1 on top)
  sub_mod                   : 31 constraints, 30 witnesses
  inner_product_mod         : 30 + len constraints (doc said 29 + len)
  vector_matrix_mul_mod     : (30 + len) * rows
"""

from __future__ import annotations

from ..params import Q
from ..r1cs import ConstraintSystem, FpVar
from .range_proofs import enforce_less_than_q


def _hint_divmod(value: int) -> tuple[int, int]:
    """Integer quotient/remainder hint by q (the BigUint computation at
    `arithmetics.rs:73-80,127-134`).  Values in these circuits are < 2^161,
    far below the field modulus, so the field value IS the integer."""
    return divmod(value, Q)


def mod_q(cs: ConstraintSystem, a: FpVar, modulus_var: FpVar) -> FpVar:
    """b = a mod q.  30 constraints (`arithmetics.rs:105-149`)."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    t_int, b_int = _hint_divmod(a_val)
    t_var = FpVar.new_witness(cs, t_int)
    b_var = FpVar.new_witness(cs, b_int)
    # (1) a - t*q = b
    left = a - t_var * modulus_var
    left.enforce_equal(b_var)
    # (2) b < q
    enforce_less_than_q(cs, b_var)
    return b_var


def mul_mod(cs: ConstraintSystem, a: FpVar, b: FpVar, modulus_var: FpVar) -> FpVar:
    """c = a*b mod q for a, b < q.  30 constraints (`arithmetics.rs:157-209`)."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    b_val = 1 if cs.is_in_setup_mode() else b._val()
    t_int, c_int = _hint_divmod(a_val * b_val % cs.p)
    t_var = FpVar.new_witness(cs, t_int)
    c_var = FpVar.new_witness(cs, c_int)
    # (1) a*b - t*q = c    (the a*b mul allocates its own product wire)
    ab_var = a * b
    left = ab_var - t_var * modulus_var
    left.enforce_equal(c_var)
    # (2) c < q
    enforce_less_than_q(cs, c_var)
    return c_var


def add_mod(cs: ConstraintSystem, a: FpVar, b: FpVar, modulus_var: FpVar) -> FpVar:
    """c = a+b mod q.  30 constraints (`arithmetics.rs:214-262`)."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    b_val = 1 if cs.is_in_setup_mode() else b._val()
    t_int, c_int = _hint_divmod((a_val + b_val) % cs.p)
    t_var = FpVar.new_witness(cs, t_int)
    c_var = FpVar.new_witness(cs, c_int)
    left = (a + b) - t_var * modulus_var
    left.enforce_equal(c_var)
    enforce_less_than_q(cs, c_var)
    return c_var


def sub_mod(cs: ConstraintSystem, a: FpVar, b: FpVar, modulus_var: FpVar) -> FpVar:
    """c = a-b mod q, requires a < q; proves b + c = a mod q
    (`arithmetics.rs:269-302`).  31 constraints."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    b_val = 1 if cs.is_in_setup_mode() else b._val()
    c_int = (a_val - b_val % Q) % Q
    c_var = FpVar.new_witness(cs, c_int)
    a.enforce_equal(add_mod(cs, b, c_var, modulus_var))
    return c_var


def inner_product_mod(
    cs: ConstraintSystem, a: list[FpVar], b: list[FpVar], modulus_var: FpVar
) -> FpVar:
    """c = <a, b> mod q for a_i, b_i < q.  30 + len constraints
    (`arithmetics.rs:34-100`; its setup-mode stub hardcodes length N at
    :58-67 -- a latent bug we do not reproduce; the gadget here is decoupled
    from the global N, see SURVEY.md Appendix A item 3)."""
    if len(a) != len(b) or not a:
        raise ValueError(f"invalid input length: a {len(a)} vs b {len(b)}")
    if cs.is_in_setup_mode():
        ab_val = len(a)  # sum of 1*1 placeholders
    else:
        ab_val = 0
        for ai, bi in zip(a, b):
            ab_val += ai._val() * bi._val()
        ab_val %= cs.p
    t_int, c_int = _hint_divmod(ab_val)
    t_var = FpVar.new_witness(cs, t_int)
    c_var = FpVar.new_witness(cs, c_int)
    # a_0*b_0 + ... + a_k*b_k - t*q = c ; each product allocates a wire
    ab_var = a[0] * b[0]
    for ai, bi in zip(a[1:], b[1:]):
        ab_var = ab_var + ai * bi
    left = ab_var - t_var * modulus_var
    left.enforce_equal(c_var)
    enforce_less_than_q(cs, c_var)
    return c_var


def vector_matrix_mul_mod(
    cs: ConstraintSystem,
    a: list[FpVar],
    b: list[list[FpVar]],
    modulus_var: FpVar,
) -> list[FpVar]:
    """c = a * B mod q, row-by-row inner products (`arithmetics.rs:14-27`)."""
    if not a or not b:
        raise ValueError(f"invalid input length: a {len(a)} vs b {len(b)}")
    return [inner_product_mod(cs, a, b_i, modulus_var) for b_i in b]
