"""Scalar-field (Fr) polynomial arithmetic: radix-2 FFT domains.

The reference gets these from ark-poly's Radix2EvaluationDomain (used
inside ark-groth16's proving path); this is the from-scratch equivalent.
Fr = BLS12-381 scalar field, 2-adicity 32, so domains up to 2^32 exist —
far beyond the 2^21 needed by the largest Falcon circuit (schoolbook-1024,
1.156M constraints).

Pure-Python reference path; the native C backend (native/groth16_native.c)
implements the same FFT over Montgomery representation and is tested
against this module.
"""

from __future__ import annotations

from .bls12_381 import R

# multiplicative generator: 5 is a quadratic non-residue mod R (verified at
# import) => 5^((R-1)/2^k) generates the order-2^k subgroup exactly.
_QNR = 5
assert pow(_QNR, (R - 1) // 2, R) == R - 1
TWO_ADICITY = 32
assert (R - 1) % (1 << TWO_ADICITY) == 0 and (R - 1) // (1 << TWO_ADICITY) % 2 == 1


def root_of_unity(log_size: int) -> int:
    """Primitive 2^log_size-th root of unity in Fr."""
    if not 0 <= log_size <= TWO_ADICITY:
        raise ValueError(f"no 2^{log_size} root of unity in Fr")
    return pow(_QNR, (R - 1) >> log_size, R)


def batch_inverse(xs: list[int]) -> list[int]:
    """Montgomery batch inversion: one modexp + 3(n-1) mults."""
    n = len(xs)
    prefix = [1] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x % R
    inv_all = pow(prefix[n], -1, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R
        inv_all = inv_all * xs[i] % R
    return out


def _bit_reverse_permute(a: list[int]) -> None:
    n = len(a)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]


def fft(values: list[int], omega: int) -> list[int]:
    """In-place iterative radix-2 Cooley-Tukey NTT over Fr.

    `omega` must be a primitive n-th root of unity for n = len(values)
    (power of two).  Returns evaluations [f(omega^0), ..., f(omega^{n-1})]
    when given coefficients, i.e. the usual polynomial-evaluation FFT.
    """
    a = [v % R for v in values]
    n = len(a)
    assert n & (n - 1) == 0
    _bit_reverse_permute(a)
    length = 2
    while length <= n:
        w_step = pow(omega, n // length, R)
        half = length >> 1
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u = a[k]
                t = a[k + half] * w % R
                a[k] = (u + t) % R
                a[k + half] = (u - t) % R
                w = w * w_step % R
        length <<= 1
    return a


def ifft(evals: list[int], omega: int) -> list[int]:
    """Inverse NTT: coefficients from evaluations on the omega-domain."""
    n = len(evals)
    inv_n = pow(n, -1, R)
    out = fft(evals, pow(omega, -1, R))
    return [x * inv_n % R for x in out]


class Domain:
    """Radix-2 evaluation domain of size 2^log_size over Fr."""

    def __init__(self, min_size: int):
        log_size = max(1, (min_size - 1).bit_length())
        self.log_size = log_size
        self.size = 1 << log_size
        self.omega = root_of_unity(log_size)
        self.omega_inv = pow(self.omega, -1, R)

    def fft(self, coeffs: list[int]) -> list[int]:
        c = list(coeffs) + [0] * (self.size - len(coeffs))
        return fft(c, self.omega)

    def ifft(self, evals: list[int]) -> list[int]:
        return ifft(evals, self.omega)

    def coset_fft(self, coeffs: list[int], g: int) -> list[int]:
        """Evaluations on the coset {g * omega^i}."""
        c = list(coeffs) + [0] * (self.size - len(coeffs))
        scale = 1
        for i in range(self.size):
            c[i] = c[i] * scale % R
            scale = scale * g % R
        return fft(c, self.omega)

    def coset_ifft(self, evals: list[int], g: int) -> list[int]:
        c = ifft(evals, self.omega)
        ginv = pow(g, -1, R)
        scale = 1
        for i in range(self.size):
            c[i] = c[i] * scale % R
            scale = scale * ginv % R
        return c

    def vanishing_on_coset(self, g: int) -> int:
        """Z(g*omega^i) = g^n - 1: constant across the coset."""
        return (pow(g, self.size, R) - 1) % R

    def lagrange_coeffs_at(self, tau: int) -> list[int]:
        """[L_j(tau)]_j for the domain: L_j(tau) = Z(tau) w^j / (n (tau - w^j)).

        Falls back to the exact delta values when tau is in the domain.
        """
        n = self.size
        z_tau = (pow(tau, n, R) - 1) % R
        pows = [0] * n
        w = 1
        for j in range(n):
            pows[j] = w
            w = w * self.omega % R
        if z_tau == 0:
            return [1 if tau % R == pows[j] else 0 for j in range(n)]
        denoms = [(tau - pows[j]) % R for j in range(n)]
        invs = batch_inverse(denoms)
        n_inv = pow(n, -1, R)
        zn = z_tau * n_inv % R
        return [zn * pows[j] % R * invs[j] % R for j in range(n)]
