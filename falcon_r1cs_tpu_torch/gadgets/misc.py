"""Bit recomposition, l2 norms, and NTT parameter wires.

Re-derivation of `falcon-r1cs/src/gadgets/misc.rs`.
"""

from __future__ import annotations

from ..params import FalconParams
from ..r1cs import Boolean, ConstraintSystem, FpVar, SynthesisError


def enforce_decompose(a: FpVar, bits: list[Boolean]) -> None:
    """Constrain a = bits[0] + 2*bits[1] + 4*bits[2] + ...
    (`misc.rs:9-24`): build the LC top-down by doubling, one enforce_equal."""
    if not bits:
        raise SynthesisError(f"invalid input length: {len(bits)}")
    res = FpVar.from_boolean(bits[-1])
    for e in reversed(bits[:-1]):
        res = res.double() + FpVar.from_boolean(e)
    res.enforce_equal(a)


def l2_norm_var(
    cs: ConstraintSystem, inputs: list[FpVar], modulus_var: FpVar
) -> FpVar:
    """Squared l2 norm of coefficients in [0, q), centered to [-6144, 6144)
    via an is_less_than_6144 select (`misc.rs:30-51`).

    Per coefficient: is_less_than_6144 (17 cns) + conditionally_select (1)
    + square (1) = 19 constraints, 18 witnesses.
    """
    from .range_proofs import is_less_than_6144

    first = FpVar.conditionally_select(
        is_less_than_6144(cs, inputs[0]),
        inputs[0],
        modulus_var - inputs[0],
    )
    res = first * first
    for e in inputs[1:]:
        tmp = FpVar.conditionally_select(
            is_less_than_6144(cs, e), e, modulus_var - e
        )
        res = res + tmp * tmp
    return res


def l2_norm_var_without_range_check(inputs: list[FpVar]) -> FpVar:
    """Squared l2 norm assuming coefficients already in [0, 6144)
    (`misc.rs:55-65`; the assumption is documented but unenforced --
    SURVEY.md Appendix A item 7).  1 constraint per coefficient."""
    res = inputs[0] * inputs[0]
    for e in inputs[1:]:
        res = res + e * e
    return res


def ntt_param_var(cs: ConstraintSystem, params: FalconParams) -> list[FpVar]:
    """The forward NTT table as N constant wires (`misc.rs:67-77`)."""
    return [FpVar.constant(cs, e) for e in params.ntt_table]


def inv_ntt_param_var(cs: ConstraintSystem, params: FalconParams) -> list[FpVar]:
    """API-parity stub for the reference's dead `inv_ntt_param_var`
    (`misc.rs:80-90`), which (buggily) returns the FORWARD table; we
    reproduce that behavior verbatim rather than "fix" it into the count
    path (SURVEY.md Appendix A item 1).  Never called by any circuit."""
    return [FpVar.constant(cs, e) for e in params.ntt_table]
