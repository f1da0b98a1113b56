"""Polynomial value types over Z_q: the clear-side data layer.

TPU-native equivalent of the falcon-rust polynomial layer (`Polynomial`,
`NTTPolynomial`, `DualPolynomial` -- see SURVEY.md section 2.3 and use sites
`falcon-r1cs/src/circuits/falcon_ntt.rs:27-28,44-51`,
`falcon-r1cs/src/circuits/falcon_dual_ntt.rs:27,47-51`).

Values are numpy int64 arrays shape (n,) (or (batch, n) in the batched
engine); these thin wrappers exist for API parity and carry the conversion
semantics that the reference gets from falcon-rust:

- `Polynomial`: coefficients lifted to [0, q).
- `NTTPolynomial`: NTT-domain coefficients in [0, q).
- `DualPolynomial {pos, neg}`: nonnegative split with disjoint support;
  coefficient c in [0, q) maps to pos = c if c < 6144 else 0,
  neg = q - c if c >= 6144 else 0 (the centering used by
  `l2_norm_var_without_range_check`'s documented assumption,
  `falcon-r1cs/src/gadgets/misc.rs:53-65`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import Q
from .ntt import intt, ntt

_HALF = 6144  # centering threshold, = (q - 1) / 2 rounded up to 2^12+2^11


def _as_modq(arr) -> np.ndarray:
    a = np.asarray(arr, dtype=np.int64) % Q
    return a


@dataclass
class Polynomial:
    """Coefficient-domain polynomial, coeffs in [0, q)."""

    coeffs: np.ndarray

    def __post_init__(self):
        self.coeffs = _as_modq(self.coeffs)

    @property
    def n(self) -> int:
        return self.coeffs.shape[-1]

    def coeff(self) -> np.ndarray:
        return self.coeffs

    @classmethod
    def rand(cls, rng: np.random.Generator, n: int) -> "Polynomial":
        """Uniform random polynomial (the analog of `Polynomial::rand`,
        `falcon-r1cs/src/gadgets/poly.rs:268`)."""
        return cls(rng.integers(0, Q, size=n, dtype=np.int64))

    def ntt(self) -> "NTTPolynomial":
        return NTTPolynomial(ntt(self.coeffs))

    def __mul__(self, other: "Polynomial") -> "Polynomial":
        """Negacyclic product mod (x^n + 1, q)."""
        return Polynomial(
            intt(ntt(self.coeffs) * ntt(other.coeffs) % Q)
        )

    def __add__(self, other: "Polynomial") -> "Polynomial":
        return Polynomial((self.coeffs + other.coeffs) % Q)

    def __sub__(self, other: "Polynomial") -> "Polynomial":
        return Polynomial((self.coeffs - other.coeffs) % Q)

    def centered(self) -> np.ndarray:
        """Signed representatives in [-6144, 6145): c if c < 6144 else c - q."""
        c = self.coeffs
        return np.where(c < _HALF, c, c - Q)

    def l2_norm_sq(self) -> int:
        """Squared l2 norm of the centered representatives."""
        c = self.centered()
        return int(np.sum(c * c))


@dataclass
class NTTPolynomial:
    """NTT-domain polynomial, coeffs in [0, q)."""

    coeffs: np.ndarray

    def __post_init__(self):
        self.coeffs = _as_modq(self.coeffs)

    @property
    def n(self) -> int:
        return self.coeffs.shape[-1]

    def coeff(self) -> np.ndarray:
        return self.coeffs

    def intt(self) -> Polynomial:
        return Polynomial(intt(self.coeffs))

    def __mul__(self, other: "NTTPolynomial") -> "NTTPolynomial":
        return NTTPolynomial(self.coeffs * other.coeffs % Q)

    def __add__(self, other: "NTTPolynomial") -> "NTTPolynomial":
        return NTTPolynomial((self.coeffs + other.coeffs) % Q)

    def inverse(self) -> "NTTPolynomial":
        """Pointwise inverse; requires all coeffs nonzero."""
        if np.any(self.coeffs == 0):
            raise ZeroDivisionError("NTT coefficient is zero; not invertible")
        inv = np.array(
            [pow(int(c), Q - 2, Q) for c in self.coeffs], dtype=np.int64
        )
        return NTTPolynomial(inv)


@dataclass
class DualPolynomial:
    """(pos, neg) nonnegative split with disjoint support.

    Mirrors falcon-rust's `DualPolynomial` as consumed at
    `falcon-r1cs/src/circuits/falcon_dual_ntt.rs:27,51` and
    `falcon-r1cs/src/gadgets/dual_poly.rs:15-31`.
    """

    pos: Polynomial
    neg: Polynomial

    @classmethod
    def from_polynomial(cls, p: Polynomial) -> "DualPolynomial":
        c = p.coeffs
        pos = np.where(c < _HALF, c, 0)
        neg = np.where(c < _HALF, 0, (Q - c) % Q)
        return cls(Polynomial(pos), Polynomial(neg))

    @classmethod
    def from_signed(cls, signed: np.ndarray) -> "DualPolynomial":
        s = np.asarray(signed, dtype=np.int64)
        pos = np.where(s >= 0, s, 0)
        neg = np.where(s < 0, -s, 0)
        return cls(Polynomial(pos), Polynomial(neg))

    def signed(self) -> np.ndarray:
        return self.pos.coeffs - self.neg.coeffs
