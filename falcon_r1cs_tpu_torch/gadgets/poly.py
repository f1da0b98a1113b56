"""Polynomial wire vectors and the flagship n*log n native-field NTT gadget.

Re-derivation of `falcon-r1cs/src/gadgets/poly.rs`:
`PolyVar` (coefficient domain) / `NTTPolyVar` (NTT domain) wrap a list of
FpVars; the NTT circuit runs all N/2*log N butterflies as *free* linear
combinations with bound tracking (after round l all values < 2^(l+1)*q^(l+2),
`poly.rs:126-134`; max ~2^160 << field modulus) and pays for a single final
per-coefficient mod_q -- 30*N constraints total (`poly.rs:98`,
`falcon-r1cs/README.md:43,54`).
"""

from __future__ import annotations

import numpy as np

from ..params import FalconParams
from ..r1cs import ConstraintSystem, FpVar
from .arithmetics import mod_q


class _PolyVarBase:
    def __init__(self, coeffs: list[FpVar]):
        self.coeffs = list(coeffs)

    def coeff(self) -> list[FpVar]:
        return self.coeffs

    def __len__(self) -> int:
        return len(self.coeffs)

    @classmethod
    def alloc_vars(cls, cs: ConstraintSystem, values, mode: str):
        """Allocate one wire per coefficient (`poly.rs:195-211,47-63`).

        values: array-like of ints in [0, q); mode in {"constant", "witness",
        "input"} (AllocationMode parity).
        """
        vals = np.asarray(values, dtype=np.int64)
        return cls([FpVar.new_variable(cs, int(v), mode) for v in vals])

    # elementwise ops without mod reduction (`poly.rs:14-38,162-186`)
    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __mul__(self, other):
        return type(self)([a * b for a, b in zip(self.coeffs, other.coeffs)])

    @staticmethod
    def enforce_product(a, b, c) -> None:
        """c = a * b elementwise, no mod (`poly.rs:66-72,214-220`)."""
        for ai, bi, ci in zip(a.coeffs, b.coeffs, c.coeffs):
            (ai * bi).enforce_equal(ci)

    @staticmethod
    def enforce_sum(a, b, c) -> None:
        """c = a + b elementwise, no mod (`poly.rs:75-81,223-229`)."""
        for ai, bi, ci in zip(a.coeffs, b.coeffs, c.coeffs):
            (ai + bi).enforce_equal(ci)


class PolyVar(_PolyVarBase):
    """Coefficient-domain polynomial wires."""


class NTTPolyVar(_PolyVarBase):
    """NTT-domain polynomial wires."""

    def mod_q(self, cs: ConstraintSystem, modulus_var: FpVar) -> "NTTPolyVar":
        """Reduce every coefficient (`poly.rs:83-90`)."""
        return NTTPolyVar([mod_q(cs, x, modulus_var) for x in self.coeffs])

    @staticmethod
    def ntt_circuit(
        cs: ConstraintSystem,
        inp: PolyVar,
        const_vars: list[FpVar],
        param: list[FpVar],
        params: FalconParams,
    ) -> "NTTPolyVar":
        """The NTT conversion circuit (`poly.rs:104-159`).

        Inputs:
          const_vars: the [q, 2*q^2, ..., 2^log_n * q^(log_n+1)] constant
            wires (`falcon_ntt.rs:31-39`);
          param: the forward NTT table constant wires.

        Stage l butterfly on pair (j, j+ht) with twiddle s = param[m+i]:
            u     = out[j]
            v     = out[j+ht] * s                (wire x constant: free LC)
            neg_v = const_vars[l+1] - v          (bound 2^l*q^(l+2) >= v, a
                                                  multiple of q: subtraction
                                                  without wraparound)
            out[j], out[j+ht] = u + v, u + neg_v (both < 2^(l+1)*q^(l+2))

        All butterflies are constraint-free; the final per-coefficient mod_q
        is the only non-native reduction (30*N constraints).
        """
        n, log_n = params.n, params.log_n
        if len(inp) != n:
            raise ValueError(f"input length {len(inp)} is not N={n}")
        output = list(inp.coeffs)
        t = n
        for l in range(log_n):
            m = 1 << l
            ht = t // 2
            j1 = 0
            for i in range(m):
                s = param[m + i]
                for j in range(j1, j1 + ht):
                    u = output[j]
                    v = output[j + ht] * s
                    neg_v = const_vars[l + 1] - v
                    output[j] = u + v
                    output[j + ht] = u + neg_v
                j1 += t
            t = ht
        return NTTPolyVar(
            [mod_q(cs, e, const_vars[0]) for e in output]
        )
