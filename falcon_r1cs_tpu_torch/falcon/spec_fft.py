"""Reference-implementation-exact floating-point FFT layer for Falcon.

The reference repo's signer is the Falcon reference C implementation
behind falcon-rust FFI (`falcon-r1cs/Cargo.toml:11`, used
by `sign_with_seed` at `src/circuits/falcon_ntt.rs:133-141`).  Its value
computation is IEEE-754 double arithmetic in a FIXED operation order
(fft.c of the reference implementation, FALCON_FPNATIVE build).  This
module reproduces that computation op-for-op so the full sign path is
bit-for-bit deterministic and directly comparable against reference
vectors (falcon/spec_sign.py builds on it; same KAT-readiness contract
as falcon/spec_rng.py).

Key facts reproduced here (all public, from the reference implementation
and the Falcon specification v1.2):

* Representation ("FFT representation"): a real polynomial f of degree
  n = 2^logn is stored as n doubles where complex value j (j < n/2) has
  its real part in slot j and imaginary part in slot j + n/2.  Only the
  first n/2 of the n complex evaluations are kept (the rest are
  conjugates).  The evaluation ordering is BIT-REVERSED: element j holds
  f(w^rev(j')) per the reference's iterative schedule, not the spec's
  natural order.
* Twiddles: GM[k] = w^rev10(k) with w = exp(i*pi/1024) and rev10 the
  10-bit reversal; one table serves every logn <= 10 (indices for
  smaller n land on even reversed exponents, which are exactly the
  roots of the smaller cyclotomic).  The reference hardcodes this table
  as correctly-rounded doubles; here it is recomputed correctly-rounded
  from 60-digit Decimal Taylor series (tests pin the round-trip and the
  algebraic characterization; any official-vector mismatch would point
  first at halfway-rounding of a table entry, see PARITY_NOTES.md).
* Elementwise complex macros FPC_ADD/SUB/MUL/DIV and the poly_* ops in
  the reference's exact expression trees.  numpy float64 elementwise ops
  are IEEE doubles with per-element rounding and no fusion/reassociation,
  so vectorizing the per-element loops preserves bit-exactness.

No jax here: this layer exists for reference-fidelity, not throughput
(the throughput signer is the batched engine path).
"""

from __future__ import annotations

import functools
from decimal import Decimal, getcontext

import numpy as np

# --------------------------------------------------------------------------
# Correctly-rounded twiddle table
# --------------------------------------------------------------------------

_PI_60 = Decimal(
    "3.14159265358979323846264338327950288419716939937510582097494"
)


def _cos_sin(frac: Decimal) -> tuple[float, float]:
    """cos(pi*frac), sin(pi*frac) as correctly-rounded doubles, via
    60-digit Decimal Taylor series (Python's Decimal has no trig; libm
    is close-but-unpinned, so we compute at high precision and round
    once)."""
    getcontext().prec = 60
    x = _PI_60 * frac
    x2 = x * x
    # cos: sum (-1)^k x^(2k) / (2k)!
    term = Decimal(1)
    c = Decimal(1)
    k = 0
    while True:
        k += 1
        term = -term * x2 / ((2 * k - 1) * (2 * k))
        c += term
        if abs(term) < Decimal("1e-58"):
            break
    # sin: x * sum (-1)^k x^(2k) / (2k+1)!
    term = x
    s = x
    k = 0
    while True:
        k += 1
        term = -term * x2 / ((2 * k) * (2 * k + 1))
        s += term
        if abs(term) < Decimal("1e-58"):
            break
    # exact zeros (cos(pi/2), sin(0)) leave a ~1e-60 Taylor residual that
    # doubles CAN represent; snap it (real entries are >= ~3e-3)
    if abs(c) < Decimal("1e-40"):
        c = Decimal(0)
    if abs(s) < Decimal("1e-40"):
        s = Decimal(0)
    return float(c), float(s)


def _rev10(x: int) -> int:
    r = 0
    for _ in range(10):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=1)
def gm_tab() -> np.ndarray:
    """(2048,) doubles: GM[2k], GM[2k+1] = Re, Im of w^rev10(k),
    w = exp(i*pi/1024) (the reference's fpr_gm_tab layout)."""
    out = np.empty(2048, dtype=np.float64)
    for k in range(1024):
        c, s = _cos_sin(Decimal(_rev10(k)) / 1024)
        out[2 * k] = c
        out[2 * k + 1] = s
    return out


# --------------------------------------------------------------------------
# FFT / iFFT (reference fft.c loop structure, FPC macros expanded)
# --------------------------------------------------------------------------


def fft(f: np.ndarray, logn: int) -> np.ndarray:
    """In the reference's in-place FFT order; returns a new array.

    First iteration (m=1 -> 2) is a no-op in this representation (its
    twiddle is GM[1] = w^512 = i, and pairing f[j] with i*f[j+hn] is
    exactly how the storage is laid out), so the loop starts at m=2.
    """
    gm = gm_tab()
    n = 1 << logn
    hn = n >> 1
    f = np.array(f, dtype=np.float64, copy=True)
    assert f.shape == (n,)
    t = hn
    m = 2
    for _u in range(1, logn):
        ht = t >> 1
        hm = m >> 1
        for i1 in range(hm):
            j1 = i1 * t
            s_re = gm[((m + i1) << 1) + 0]
            s_im = gm[((m + i1) << 1) + 1]
            x_re = f[j1 : j1 + ht].copy()
            x_im = f[j1 + hn : j1 + hn + ht].copy()
            y_re = f[j1 + ht : j1 + t].copy()
            y_im = f[j1 + ht + hn : j1 + t + hn].copy()
            # FPC_MUL(y, y, s)
            z_re = y_re * s_re - y_im * s_im
            z_im = y_re * s_im + y_im * s_re
            # FPC_ADD / FPC_SUB
            f[j1 : j1 + ht] = x_re + z_re
            f[j1 + hn : j1 + hn + ht] = x_im + z_im
            f[j1 + ht : j1 + t] = x_re - z_re
            f[j1 + ht + hn : j1 + t + hn] = x_im - z_im
        t = ht
        m <<= 1
    return f


def ifft(f: np.ndarray, logn: int) -> np.ndarray:
    """Inverse of fft (reference iFFT): Gentleman-Sande with conjugated
    twiddles, final scale by 2^(1-logn) (exact power of two; the last
    radix-2 level is a no-op in this representation, hence N/2)."""
    gm = gm_tab()
    n = 1 << logn
    hn = n >> 1
    f = np.array(f, dtype=np.float64, copy=True)
    assert f.shape == (n,)
    t = 1
    m = n
    for _u in range(logn, 1, -1):
        hm = m >> 1
        dt = t << 1
        i1 = 0
        for j1 in range(0, hn, dt):
            s_re = gm[((hm + i1) << 1) + 0]
            s_im = -gm[((hm + i1) << 1) + 1]
            x_re = f[j1 : j1 + t].copy()
            x_im = f[j1 + hn : j1 + hn + t].copy()
            y_re = f[j1 + t : j1 + dt].copy()
            y_im = f[j1 + t + hn : j1 + dt + hn].copy()
            # FPC_ADD
            f[j1 : j1 + t] = x_re + y_re
            f[j1 + hn : j1 + hn + t] = x_im + y_im
            # FPC_SUB then FPC_MUL by s
            d_re = x_re - y_re
            d_im = x_im - y_im
            f[j1 + t : j1 + dt] = d_re * s_re - d_im * s_im
            f[j1 + t + hn : j1 + dt + hn] = d_re * s_im + d_im * s_re
            i1 += 1
        t = dt
        m = hm
    if logn > 0:
        f *= 2.0 ** (1 - logn)  # exact: exponent shift only
    return f


# --------------------------------------------------------------------------
# Elementwise poly ops on FFT representations (reference fft.c)
# --------------------------------------------------------------------------


def _halves(f: np.ndarray):
    hn = f.shape[0] >> 1
    return f[:hn], f[hn:]


def poly_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a + b


def poly_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a - b


def poly_neg(a: np.ndarray) -> np.ndarray:
    return -a


def poly_adj_fft(a: np.ndarray) -> np.ndarray:
    out = a.copy()
    hn = a.shape[0] >> 1
    out[hn:] = -out[hn:]
    return out


def poly_mul_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a_re, a_im = _halves(a)
    b_re, b_im = _halves(b)
    return np.concatenate(
        [a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re]
    )


def poly_muladj_fft(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * adj(b) — reference poly_muladj_fft's exact expressions."""
    a_re, a_im = _halves(a)
    b_re, b_im = _halves(b)
    return np.concatenate(
        [a_re * b_re + a_im * b_im, a_im * b_re - a_re * b_im]
    )


def poly_mulselfadj_fft(a: np.ndarray) -> np.ndarray:
    """a * adj(a): real; imaginary half is exactly zero."""
    a_re, a_im = _halves(a)
    return np.concatenate(
        [a_re * a_re + a_im * a_im, np.zeros_like(a_re)]
    )


def poly_mulconst(a: np.ndarray, x: float) -> np.ndarray:
    return a * np.float64(x)


def poly_split_fft(f: np.ndarray, logn: int):
    """FFT-domain split (reference poly_split_fft): even/odd complex
    pairs -> (f0, f1) with f(x) = f0(x^2) + x f1(x^2).  The odd-pair
    difference is rotated by conj(GM[u + hn]) and both halves are
    halved (exact *0.5)."""
    gm = gm_tab()
    n = 1 << logn
    hn = n >> 1
    qn = hn >> 1
    f0 = np.zeros(hn, dtype=np.float64)
    f1 = np.zeros(hn, dtype=np.float64)
    if qn == 0:
        # logn == 1: one complex value; split is (re, im) passthrough
        f0[0] = f[0]
        f1[0] = f[hn]
        return f0, f1
    a_re = f[0 : hn : 2]
    a_im = f[hn : n : 2]
    b_re = f[1 : hn : 2]
    b_im = f[hn + 1 : n : 2]
    f0[:qn] = (a_re + b_re) * 0.5
    f0[qn:] = (a_im + b_im) * 0.5
    t_re = a_re - b_re
    t_im = a_im - b_im
    u = np.arange(qn)
    s_re = gm[((u + hn) << 1) + 0]
    s_im = -gm[((u + hn) << 1) + 1]
    f1[:qn] = (t_re * s_re - t_im * s_im) * 0.5
    f1[qn:] = (t_re * s_im + t_im * s_re) * 0.5
    return f0, f1


def poly_merge_fft(f0: np.ndarray, f1: np.ndarray, logn: int) -> np.ndarray:
    """Inverse of poly_split_fft (reference poly_merge_fft)."""
    gm = gm_tab()
    n = 1 << logn
    hn = n >> 1
    qn = hn >> 1
    f = np.zeros(n, dtype=np.float64)
    if qn == 0:
        f[0] = f0[0]
        f[hn] = f1[0]
        return f
    a_re = f0[:qn]
    a_im = f0[qn:]
    u = np.arange(qn)
    s_re = gm_tab()[((u + hn) << 1) + 0]
    s_im = gm[((u + hn) << 1) + 1]
    b_re = f1[:qn] * s_re - f1[qn:] * s_im
    b_im = f1[:qn] * s_im + f1[qn:] * s_re
    f[0:hn:2] = a_re + b_re
    f[hn:n:2] = a_im + b_im
    f[1:hn:2] = a_re - b_re
    f[hn + 1 : n : 2] = a_im - b_im
    return f


def poly_LDL_fft(g00: np.ndarray, g01: np.ndarray, g11: np.ndarray):
    """Reference poly_LDL_fft: in the self-adjoint Gram
    [[g00, g01], [adj(g01), g11]], compute mu = g01/g00 (FPC_DIV's
    normalize-then-multiply order), d11 = g11 - mu*adj(g01), and store
    adj(mu) over g01.  Returns (new_g01, new_g11); g00 is unchanged."""
    hn = g00.shape[0] >> 1
    g00_re, g00_im = g00[:hn], g00[hn:]
    g01_re, g01_im = g01[:hn].copy(), g01[hn:].copy()
    g11_re, g11_im = g11[:hn], g11[hn:]
    # FPC_DIV(mu, g01, g00)
    m = g00_re * g00_re + g00_im * g00_im
    m = 1.0 / m
    c_re = g00_re * m
    c_im = (-g00_im) * m
    mu_re = g01_re * c_re - g01_im * c_im
    mu_im = g01_re * c_im + g01_im * c_re
    # FPC_MUL(p, mu, adj(g01))
    p_re = mu_re * g01_re - mu_im * (-g01_im)
    p_im = mu_re * (-g01_im) + mu_im * g01_re
    new_g11 = np.concatenate([g11_re - p_re, g11_im - p_im])
    new_g01 = np.concatenate([mu_re, -mu_im])
    return new_g01, new_g11
