"""Hand-optimized bit-decomposition range proofs.

Re-derivation of `falcon-r1cs/src/gadgets/range_proofs.rs`:
each bound's binary structure is exploited to beat the ~1264-constraint
generic arkworks `enforce_cmp` (`range_proofs.rs:12`).

Measured costs under the pinned wire model (reference doc comments in
parentheses where stale):
  enforce_less_than_1024          : 11 constraints, 10 witnesses (doc: 15)
  enforce_less_than_q             : 29 constraints, 27 witnesses (doc: 28)
  enforce_less_than_norm_bound_512: 52 constraints, 50 witnesses (doc: 47)
  enforce_less_than_norm_bound_1024: 54 constraints, 52 witnesses (doc: 54)
  is_less_than_6144               : 17 constraints, 16 witnesses (doc: 18)

The 29 / 52 / 54 values are forced by the published circuit totals
(`falcon-r1cs/README.md:41-56`); the gadgets not on any published-total
path (1024-bound is on the 1024 path; less_than_1024 and is_less_than_6144
costs are forced via the verify-circuit reconciliation).

Runtime `cs.validate` replaces the reference's `#[cfg(not(test))] panic!`
guards (`range_proofs.rs:55-60,112-117,203-208`; SURVEY.md Appendix A 13).
"""

from __future__ import annotations

from ..params import FalconParams, Q
from ..r1cs import Boolean, ConstraintSystem, FpVar
from .misc import enforce_decompose


def _bits_of(value: int, count: int) -> list[int]:
    """Least-significant `count` bits of the field value (the analog of
    `into_repr().to_bits_le()` + take(count), `range_proofs.rs:62-69`)."""
    return [(value >> i) & 1 for i in range(count)]


def _alloc_bits(cs: ConstraintSystem, a: FpVar, count: int) -> list[Boolean]:
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    return [Boolean.new_witness(cs, b) for b in _bits_of(a_val, count)]


def enforce_less_than_1024(cs: ConstraintSystem, a: FpVar) -> None:
    """a < 1024 via a 10-bit decomposition (`range_proofs.rs:13-37`)."""
    bits = _alloc_bits(cs, a, 10)
    enforce_decompose(a, bits)


def enforce_less_than_q(cs: ConstraintSystem, a: FpVar) -> None:
    """a < q = 12289 = 2^13 + 2^12 + 1 (`range_proofs.rs:42-94`).

    14-bit decomposition, then enforce:
      a[13] == 0, or (a[12] == 0, or all of a[0..12] == 0).
    """
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    if cs.validate and not cs.is_in_setup_mode() and a_val >= Q:
        raise ValueError(f"invalid input to enforce_less_than_q: {a_val}")
    bits = _alloc_bits(cs, a, 14)
    enforce_decompose(a, bits)
    f = Boolean.FALSE(cs)
    (
        bits[13]
        .is_eq(f)
        .or_(
            bits[12]
            .is_eq(f)
            .or_(Boolean.kary_or(bits[0:12]).is_eq(f))
        )
        .enforce_equal(Boolean.TRUE(cs))
    )


def _enforce_less_than_norm_bound_512(cs: ConstraintSystem, a: FpVar) -> None:
    """a < 34034726 = 0b10000001110101010000100110 (26 bits)
    (`range_proofs.rs:100-186`)."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    if cs.validate and not cs.is_in_setup_mode() and a_val >= 34034726:
        raise ValueError(f"invalid input to norm bound 512: {a_val}")
    bits = _alloc_bits(cs, a, 26)
    enforce_decompose(a, bits)
    f = Boolean.FALSE(cs)
    # mirror of the nested or/and tree at range_proofs.rs:146-184
    expr = bits[25].is_eq(f).or_(
        Boolean.kary_or(bits[19:25]).is_eq(f).and_(
            Boolean.kary_and(bits[16:19]).is_eq(f).or_(
                bits[15].is_eq(f).and_(
                    bits[14].is_eq(f).or_(
                        bits[13].is_eq(f).and_(
                            bits[12].is_eq(f).or_(
                                bits[11].is_eq(f).and_(
                                    bits[10].is_eq(f).or_(
                                        Boolean.kary_or(bits[6:10]).is_eq(f).and_(
                                            bits[5].is_eq(f).or_(
                                                Boolean.kary_or(bits[3:5]).is_eq(f).and_(
                                                    Boolean.kary_and(bits[1:3]).is_eq(f)
                                                )
                                            )
                                        )
                                    )
                                )
                            )
                        )
                    )
                )
            )
        )
    )
    expr.enforce_equal(Boolean.TRUE(cs))


def _enforce_less_than_norm_bound_1024(cs: ConstraintSystem, a: FpVar) -> None:
    """a < 70265242 = 0b100001100000010100110011010 (27 bits)
    (`range_proofs.rs:192-272`; its doc comment saying 34034726 is stale,
    SURVEY.md Appendix A item 2)."""
    a_val = 1 if cs.is_in_setup_mode() else a._val()
    if cs.validate and not cs.is_in_setup_mode() and a_val >= 70265242:
        raise ValueError(f"invalid input to norm bound 1024: {a_val}")
    bits = _alloc_bits(cs, a, 27)
    enforce_decompose(a, bits)
    f = Boolean.FALSE(cs)
    # mirror of the nested or/and tree at range_proofs.rs:235-270
    expr = bits[26].is_eq(f).or_(
        Boolean.kary_or(bits[22:26]).is_eq(f).and_(
            Boolean.kary_and(bits[20:22]).is_eq(f).or_(
                Boolean.kary_or(bits[14:20]).is_eq(f).and_(
                    bits[13].is_eq(f).or_(
                        bits[12].is_eq(f).and_(
                            bits[11].is_eq(f).or_(
                                Boolean.kary_or(bits[9:11]).is_eq(f).and_(
                                    Boolean.kary_and(bits[7:9]).is_eq(f).or_(
                                        Boolean.kary_or(bits[5:7]).is_eq(f).and_(
                                            Boolean.kary_and(bits[3:5]).is_eq(f).or_(
                                                Boolean.kary_or(bits[1:3]).is_eq(f)
                                            )
                                        )
                                    )
                                )
                            )
                        )
                    )
                )
            )
        )
    )
    expr.enforce_equal(Boolean.TRUE(cs))


def enforce_less_than_norm_bound(
    cs: ConstraintSystem, a: FpVar, params: FalconParams
) -> None:
    """Dispatch on the parameter set (`range_proofs.rs:274-284`; runtime
    config instead of cargo features)."""
    if params.n == 512:
        _enforce_less_than_norm_bound_512(cs, a)
    else:
        _enforce_less_than_norm_bound_1024(cs, a)


def is_less_than_6144(cs: ConstraintSystem, a: FpVar) -> Boolean:
    """Returns a Boolean wire: a < 6144 = 2^12 + 2^11
    (`range_proofs.rs:289-333`).  Input allowed to exceed 6144.

    14-bit decomposition, result = (a[13]==0) and (a[12]==0 or a[11]==0).
    """
    bits = _alloc_bits(cs, a, 14)
    enforce_decompose(a, bits)
    f = Boolean.FALSE(cs)
    res = (
        bits[13]
        .is_eq(f)
        .and_(bits[12].is_eq(f).or_(bits[11].is_eq(f)))
        .is_eq(Boolean.TRUE(cs))
    )
    return res
