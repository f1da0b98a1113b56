"""Falcon NTRU key generation: f, g, F, G with f*G - g*F = q mod (x^n + 1).

Completes the capability the reference outsources to falcon-rust's FFI into
the Falcon C code (`KeyPair::keygen`, SURVEY.md section 2.3).  Implemented
from the Falcon specification / the Pornin-Prest field-norm ("tower of
rings") NTRU solver:

  - sample f, g with discrete-Gaussian-like coefficients,
    sigma_fg = 1.17 * sqrt(q / 2n);
  - require f invertible mod q and the Gram-Schmidt norm bound
    max(||(g, -f)||, ||q*(adj f, adj g) / (f adj f + g adj g)||) <= 1.17 sqrt(q);
  - NTRU solve by recursion over field norms N(f)(x^2) = f(x) f(-x):
    solve at half degree, lift, and size-reduce with Babai rounding against
    (f, g) using scaled float FFTs for the quotient;
  - exact integer polynomial arithmetic throughout via Kronecker
    substitution (coefficients packed into one big int; Python's bigint
    multiply does the convolution).

Pure host-side code: keygen exists to produce test vectors / benchmark
inputs and is off the TPU hot path (as in the reference, where it lives in
C behind FFI).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..params import FalconParams, Q

# ---------------------------------------------------------------------------
# exact integer polynomial arithmetic in Z[x]/(x^m + 1)
# ---------------------------------------------------------------------------


def _max_abs(f) -> int:
    return max((abs(int(c)) for c in f), default=0)


def poly_mul(f: list[int], g: list[int]) -> list[int]:
    """Negacyclic product via Kronecker substitution (exact, fast)."""
    m = len(f)
    fm, gm = _max_abs(f), _max_abs(g)
    if fm == 0 or gm == 0:
        return [0] * m
    # coefficient bound of the linear convolution
    bound = fm * gm * m
    b = bound.bit_length() + 2  # slack bit for sign handling
    off = 1 << (b - 1)
    # pack with offset so digits are nonnegative
    def pack(p):
        acc = 0
        for c in reversed(p):
            acc = (acc << b) | (int(c) + off)
        # subtract the offset contribution: sum off * x^i
        return acc - off * ((1 << (b * len(p))) - 1) // ((1 << b) - 1)

    prod = pack(f) * pack(g)
    # unpack 2m-1 signed digits
    digits = []
    mask = (1 << b) - 1
    carry = 0
    acc = prod
    for _ in range(2 * m):
        d = (acc & mask)
        acc >>= b
        if d >= off:
            d -= 1 << b
            acc += 1
        digits.append(d)
    out = [0] * m
    for i, d in enumerate(digits):
        if i < m:
            out[i] += d
        else:
            out[i - m] -= d
    return out


def poly_sub_scaled(F: list[int], k: list[int], f: list[int]) -> list[int]:
    """F - k*f (negacyclic)."""
    kf = poly_mul(k, f)
    return [a - b for a, b in zip(F, kf)]


def galois_conjugate(f: list[int]) -> list[int]:
    """f(-x) in Z[x]/(x^m + 1)."""
    return [c if i % 2 == 0 else -c for i, c in enumerate(f)]


def field_norm(f: list[int]) -> list[int]:
    """N(f) of degree m/2: N(f)(x^2) = f(x) * f(-x) mod (x^m + 1).

    With f = fe(x^2) + x fo(x^2): N(f) = fe^2 - x * fo^2 (in x^(m/2)+1)."""
    m = len(f)
    fe = f[0::2]
    fo = f[1::2]
    fe2 = poly_mul(fe, fe)
    fo2 = poly_mul(fo, fo)
    # subtract x * fo^2 (negacyclic shift by one)
    out = list(fe2)
    for i in range(m // 2):
        j = i + 1
        if j < m // 2:
            out[j] -= fo2[i]
        else:
            out[0] += fo2[i]  # x^(m/2) = -1
    return out


def lift(f: list[int], m: int) -> list[int]:
    """f(x^2) in Z[x]/(x^m + 1) for f of degree m/2."""
    out = [0] * m
    out[0::2] = f
    return out


def adjoint(f: list[int]) -> list[int]:
    """f*(x) = f(x^-1) mod (x^m + 1): f*_0 = f_0, f*_k = -f_{m-k}."""
    return [f[0]] + [-c for c in reversed(f[1:])]


# -- float FFT over R[x]/(x^m + 1) (negacyclic, via 2m-th root twist) -------


def _fft(f) -> np.ndarray:
    m = len(f)
    twist = np.exp(1j * np.pi * np.arange(m) / m)
    return np.fft.fft(np.asarray(f, dtype=np.float64) * twist)


def _ifft(F: np.ndarray) -> np.ndarray:
    m = len(F)
    twist = np.exp(-1j * np.pi * np.arange(m) / m)
    return (np.fft.ifft(F) * twist).real


def _scaled_floats(f: list[int], shift: int) -> list[float]:
    if shift <= 0:
        return [float(int(c)) for c in f]
    return [float(int(c) >> shift) for c in f]


def reduce_FG(f, g, F, G) -> tuple[list[int], list[int]]:
    """Babai size reduction (the scaled-descent of the Pornin-Prest
    solver): repeatedly F -= (k*f) << D, G -= (k*g) << D where
    k = round(((F >> SF)(adj f >> Sf) + ...) / ((f >> Sf)(adj f >> Sf) + ...))
    with both operand pairs scaled to ~53-bit floats and D = SF - Sf.  The
    float quotient only steers the descent (~50 bits of size reduction per
    iteration); the integer updates preserve f G - g F = q exactly."""
    max_iters = 512  # descent removes ~50 bits/iteration; far above any
    # legitimate run, so hitting the cap means the float steering stalled
    stalls = 0
    for _ in range(max_iters):
        size_fg = max(
            53, _max_abs(f).bit_length(), _max_abs(g).bit_length()
        )
        actual_FG = max(_max_abs(F).bit_length(), _max_abs(G).bit_length())
        size_FG = max(53, actual_FG)
        if size_FG < size_fg:
            break
        sf = size_fg - 53
        sF = size_FG - 53
        delta = sF - sf
        ff = _fft(_scaled_floats(f, sf))
        gf = _fft(_scaled_floats(g, sf))
        Ff = _fft(_scaled_floats(F, sF))
        Gf = _fft(_scaled_floats(G, sF))
        den = ff * np.conj(ff) + gf * np.conj(gf)
        num = Ff * np.conj(ff) + Gf * np.conj(gf)
        kf = _ifft(num / den)
        k = [int(round(c)) for c in kf]
        if all(c == 0 for c in k):
            break
        kf_poly = poly_mul(k, f)
        kg_poly = poly_mul(k, g)
        if delta > 0:
            kf_poly = [c << delta for c in kf_poly]
            kg_poly = [c << delta for c in kg_poly]
        new_F = [a - b for a, b in zip(F, kf_poly)]
        new_G = [a - b for a, b in zip(G, kg_poly)]
        new_actual = max(
            _max_abs(new_F).bit_length(), _max_abs(new_G).bit_length()
        )
        if new_actual >= actual_FG:
            if delta == 0:
                break  # converged: rounding can no longer shrink F, G
            # equal bit-length at delta > 0 can still be progress in the
            # low-order bits; only a sustained plateau means the float
            # steering stalled -- then abort so keygen resamples rather
            # than looping forever
            stalls += 1
            if stalls > 16:
                raise NTRUSolveError("size reduction stalled")
        else:
            stalls = 0
        F, G = new_F, new_G
    else:
        raise NTRUSolveError("size reduction did not converge")
    return F, G


def _xgcd(a: int, b: int) -> tuple[int, int, int]:
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        qq = old_r // r
        old_r, r = r, old_r - qq * r
        old_s, s = s, old_s - qq * s
        old_t, t = t, old_t - qq * t
    return old_r, old_s, old_t


class NTRUSolveError(ValueError):
    pass


def ntru_solve(f: list[int], g: list[int], q: int = Q):
    """Find F, G with f G - g F = q in Z[x]/(x^m + 1)."""
    m = len(f)
    if m == 1:
        d, u, v = _xgcd(f[0], g[0])
        if d == 0 or q % d:
            raise NTRUSolveError(f"gcd {d} does not divide q")
        return [-v * (q // d)], [u * (q // d)]
    fp = field_norm(f)
    gp = field_norm(g)
    Fp, Gp = ntru_solve(fp, gp, q)
    F = poly_mul(lift(Fp, m), galois_conjugate(g))
    G = poly_mul(lift(Gp, m), galois_conjugate(f))
    return reduce_FG(f, g, F, G)


# ---------------------------------------------------------------------------
# key generation
# ---------------------------------------------------------------------------


@dataclass
class SecretKey:
    f: list[int]
    g: list[int]
    F: list[int]
    G: list[int]
    params: FalconParams

    def h(self) -> np.ndarray:
        """Public key h = g * f^-1 mod (q, x^n + 1)."""
        from .ntt import intt, ntt

        f_ntt = ntt(np.asarray(self.f) % Q)
        g_ntt = ntt(np.asarray(self.g) % Q)
        f_inv = np.array([pow(int(c), Q - 2, Q) for c in f_ntt], dtype=np.int64)
        return intt(g_ntt * f_inv % Q)


def _sample_fg(rng: np.random.Generator, n: int) -> list[int]:
    """Falcon-spec f/g coefficients: each is the sum of 2^(10-logn) exact
    CDT draws from the base discrete Gaussian D_{Z, 1.17 sqrt(q/2^11)}
    (falcon/sampler.sample_fg_spec — the spec's mkgauss construction,
    summed variance (1.17)^2 q/(2n)), replacing the round-1 rounded
    normal."""
    from .sampler import sample_fg_spec

    return sample_fg_spec(rng, n)


def _gs_norm_ok(f: list[int], g: list[int], n: int) -> bool:
    """Falcon's Gram-Schmidt norm check: both GS vectors <= 1.17 sqrt(q)."""
    bound = (1.17**2) * Q
    nrm1 = sum(c * c for c in f) + sum(c * c for c in g)
    if nrm1 > bound:
        return False
    ff = _fft([float(c) for c in f])
    gf = _fft([float(c) for c in g])
    den = ff * np.conj(ff) + gf * np.conj(gf)
    if np.any(np.abs(den) < 1e-9):
        return False
    ft = Q * np.conj(ff) / den
    gt = Q * np.conj(gf) / den
    nrm2 = (np.sum(np.abs(ft) ** 2) + np.sum(np.abs(gt) ** 2)) / len(f)
    return nrm2 <= bound


def keygen(rng: np.random.Generator, params: FalconParams) -> SecretKey:
    """Generate a Falcon key pair (retry loop per the spec's conditions)."""
    from .ntt import ntt

    n = params.n
    while True:
        f = _sample_fg(rng, n)
        g = _sample_fg(rng, n)
        if np.any(ntt(np.asarray(f) % Q) == 0):
            continue  # f not invertible mod q
        if not _gs_norm_ok(f, g, n):
            continue
        try:
            F, G = ntru_solve(f, g)
        except NTRUSolveError:
            continue
        # sanity: f G - g F == q exactly
        chk = [
            a - b
            for a, b in zip(poly_mul(f, G), poly_mul(g, F))
        ]
        if chk[0] != Q or any(c != 0 for c in chk[1:]):
            continue
        return SecretKey(f=f, g=g, F=F, G=G, params=params)
