"""Dual (pos, neg) polynomial wires with disjoint-support enforcement.

Re-derivation of `falcon-r1cs/src/gadgets/dual_poly.rs`.
"""

from __future__ import annotations

from ..params import FalconParams
from ..r1cs import Boolean, ConstraintSystem, FpVar
from ..falcon.poly import DualPolynomial
from .poly import NTTPolyVar, PolyVar


class DualPolyVar:
    """pos/neg coefficient wires; allocation enforces sum pos[i]*neg[i] == 0
    (disjoint support, `dual_poly.rs:23-28`)."""

    def __init__(self, pos: PolyVar, neg: PolyVar):
        self.pos = pos
        self.neg = neg

    @classmethod
    def alloc_vars(
        cls, cs: ConstraintSystem, dual: DualPolynomial, mode: str
    ) -> "DualPolyVar":
        pos = PolyVar.alloc_vars(cs, dual.pos.coeffs, mode)
        neg = PolyVar.alloc_vars(cs, dual.neg.coeffs, mode)
        acc = pos.coeffs[0] * neg.coeffs[0]
        for p, n in zip(pos.coeffs[1:], neg.coeffs[1:]):
            acc = acc + p * n
        acc.is_zero().enforce_equal(Boolean.TRUE(cs))
        return cls(pos, neg)


class DualNTTPolyVar:
    """NTT-domain dual wires: two plain NTT circuits (`dual_poly.rs:40-52`)."""

    def __init__(self, pos: NTTPolyVar, neg: NTTPolyVar):
        self.pos = pos
        self.neg = neg

    @staticmethod
    def ntt_circuit(
        cs: ConstraintSystem,
        inp: DualPolyVar,
        const_vars: list[FpVar],
        param: list[FpVar],
        params: FalconParams,
    ) -> "DualNTTPolyVar":
        return DualNTTPolyVar(
            NTTPolyVar.ntt_circuit(cs, inp.pos, const_vars, param, params),
            NTTPolyVar.ntt_circuit(cs, inp.neg, const_vars, param, params),
        )
