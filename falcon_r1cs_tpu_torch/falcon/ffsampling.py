"""Falcon fast Fourier sampling — the spec's O(n log n) randomized signer.

The reference obtains its signatures from falcon-rust, which FFIs into the
Falcon C implementation's ffSampling signer
(`falcon-r1cs/src/circuits/falcon_ntt.rs:133-141` via
`sign_with_seed`).  Round 1/2 covered that capability with a QR-based
Babai/Klein-GPV signer (sign.py) — distribution-correct but O(n^2) per
signature and O(n^3) setup.  This module implements the actual spec
algorithms (Falcon specification v1.2, Algorithms 8/9/11: splitfft /
mergefft, ffLDL*, ffSampling_n) from first principles:

  * per key:   Gram of the FFT basis  ->  ffLDL* tree  (O(n log n))
  * per sig:   target t = (hm|0) * B^-1  ->  ffSampling down the tree
               (one SamplerZ draw per leaf)  ->  s = (hm|0) - z*B

FFT layout: values of p at the 2n-th primitive roots, ordered so that
positions (2i, 2i+1) hold p(zeta_i) and p(-zeta_i) and the squares
zeta_i^2 follow the same layout one level down — exactly the pairing
splitfft/mergefft need.  Unlike the real-input numpy twist FFT in
keygen.py, no hermitian symmetry is assumed: the LDL tree's polynomials
are complex in coefficient domain below the root, so every level carries
the full complex value vector.

Statistical correctness: ffSampling with per-leaf sigmas sigma/||b*_i||
computes the SAME distribution as Klein-GPV over the Gram-Schmidt basis
(the tree's leaves ARE the GS norms, reorganized by the FFT butterfly);
tests/test_ffsampling.py checks the two agree distributionally and that
leaf sigmas match the QR diagonal's.
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import Q
from .sampler import _SIGMA0, sample_z_ccs


# --------------------------------------------------------------------------
# FFT in the paired (zeta, -zeta) layout
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _roots(n: int) -> np.ndarray:
    """Roots of x^n + 1 in the paired layout: _roots(n)[2i]**2 ==
    _roots(n//2)[i] and _roots(n)[2i+1] == -_roots(n)[2i]."""
    if n == 1:
        return np.array([-1.0 + 0.0j])
    half = np.sqrt(_roots(n // 2))  # principal branch keeps the invariant
    out = np.empty(n, dtype=np.complex128)
    out[0::2] = half
    out[1::2] = -half
    return out


def fft(f: np.ndarray) -> np.ndarray:
    """Evaluate the (real or complex) polynomial f at the paired-layout
    roots of x^n + 1.  Recursive radix-2 over x = (f0(x^2), x*f1(x^2))."""
    f = np.asarray(f, dtype=np.complex128)
    n = f.shape[0]
    if n == 1:
        return f.copy()
    F0 = fft(f[0::2])
    F1 = fft(f[1::2])
    zeta = _roots(n)[0::2]
    t = zeta * F1
    out = np.empty(n, dtype=np.complex128)
    out[0::2] = F0 + t
    out[1::2] = F0 - t
    return out


def ifft(F: np.ndarray) -> np.ndarray:
    """Inverse of fft (returns complex coefficients; callers round)."""
    F = np.asarray(F, dtype=np.complex128)
    n = F.shape[0]
    if n == 1:
        return F.copy()
    F0, F1 = split_fft(F)
    out = np.empty(n, dtype=np.complex128)
    out[0::2] = ifft(F0)
    out[1::2] = ifft(F1)
    return out


def split_fft(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """FFT-domain split: F = fft(f)  ->  (fft(f0), fft(f1)) with
    f(x) = f0(x^2) + x f1(x^2)  (spec Algorithm `splitfft`)."""
    n = F.shape[0]
    zeta = _roots(n)[0::2]
    even, odd = F[0::2], F[1::2]
    return 0.5 * (even + odd), 0.5 * (even - odd) / zeta


def merge_fft(F0: np.ndarray, F1: np.ndarray) -> np.ndarray:
    """Inverse of split_fft (spec Algorithm `mergefft`)."""
    n = 2 * F0.shape[0]
    zeta = _roots(n)[0::2]
    out = np.empty(n, dtype=np.complex128)
    t = zeta * F1
    out[0::2] = F0 + t
    out[1::2] = F0 - t
    return out


# --------------------------------------------------------------------------
# ffLDL* tree
# --------------------------------------------------------------------------

class FfTree:
    """One node of the LDL tree: l10 (FFT values, length n) plus two
    children, each either an FfTree (n >= 2) or a float leaf sigma' =
    sigma / sqrt(d)  (the per-coordinate SamplerZ sigma)."""

    __slots__ = ("l", "child0", "child1")

    def __init__(self, l, child0, child1):
        self.l = l
        self.child0 = child0
        self.child1 = child1


def _ffldl(g00: np.ndarray, g01: np.ndarray, g11: np.ndarray, sigma: float):
    """ffLDL* (spec Algorithm 8) on the self-adjoint Gram
    [[g00, g01], [adj(g01), g11]] given in FFT values; leaves are stored
    pre-normalized as sigma / sqrt(d)."""
    n = g00.shape[0]
    l10 = np.conj(g01) / g00          # G[1][0] / d00
    d00 = g00
    d11 = g11 - l10 * np.conj(l10) * g00
    if n == 1:
        s0 = float(sigma / np.sqrt(d00[0].real))
        s1 = float(sigma / np.sqrt(d11[0].real))
        if max(s0, s1) > _SIGMA0 + 1e-12:
            raise ValueError(
                f"leaf sigma {max(s0, s1):.4f} exceeds SamplerZ base"
                f" sigma0={_SIGMA0} (key fails the GS-norm condition)"
            )
        return FfTree(l10, s0, s1)
    d0, d1 = split_fft(d00)
    child0 = _ffldl(d0, d1, d0, sigma)
    e0, e1 = split_fft(d11)
    child1 = _ffldl(e0, e1, e0, sigma)
    return FfTree(l10, child0, child1)


def tree_leaf_sigmas(tree) -> list[float]:
    """All leaf sigmas in sampling order (diagnostics/tests)."""
    if not isinstance(tree, FfTree):
        return [tree]
    return tree_leaf_sigmas(tree.child0) + tree_leaf_sigmas(tree.child1)


# --------------------------------------------------------------------------
# ffSampling
# --------------------------------------------------------------------------

def _draw_z(rng, center: float, sigma: float) -> int:
    """Leaf SamplerZ dispatch: a numpy Generator runs the spec-shaped
    sampler (falcon/sampler.py); a falcon.spec_rng.SpecSampler (anything
    exposing .sample_z) runs the spec-EXACT ChaCha20+RCDT SamplerZ —
    the KAT-ready flag path of falcon/spec_rng.py."""
    if hasattr(rng, "sample_z"):
        return rng.sample_z(center, sigma)
    return sample_z_ccs(rng, center, sigma)


def _ffsampling(t0, t1, tree: FfTree, rng) -> tuple[np.ndarray, np.ndarray]:
    """Spec Algorithm 11: sample integer-vector FFTs (z0, z1) with
    z ~ D_{Z^2n, sigma, t} along the tree."""
    if t0.shape[0] == 1:
        z1 = _draw_z(rng, t1[0].real, tree.child1)
        t0b = t0[0] + (t1[0] - z1) * tree.l[0]
        z0 = _draw_z(rng, t0b.real, tree.child0)
        return (
            np.array([z0], dtype=np.complex128),
            np.array([z1], dtype=np.complex128),
        )
    z1 = merge_fft(*_ffsampling(*split_fft(t1), tree.child1, rng))
    t0b = t0 + (t1 - z1) * tree.l
    z0 = merge_fft(*_ffsampling(*split_fft(t0b), tree.child0, rng))
    return z0, z1


class FfSampler:
    """Per-key ffSampling state: FFT basis + LDL tree (built once,
    O(n log n)); `sample(hm, rng)` draws one GPV lattice sample and
    returns the exact integer signature halves (s1, s2)."""

    def __init__(self, f, g, F, G, sigma: float):
        self.f = [int(c) for c in f]
        self.g = [int(c) for c in g]
        self.F = [int(c) for c in F]
        self.G = [int(c) for c in G]
        fh, gh = fft(np.asarray(f, float)), fft(np.asarray(g, float))
        Fh, Gh = fft(np.asarray(F, float)), fft(np.asarray(G, float))
        # B rows: b0 = (g, -f), b1 = (G, -F);  Gram = B B*
        g00 = gh * np.conj(gh) + fh * np.conj(fh)
        g01 = gh * np.conj(Gh) + fh * np.conj(Fh)
        g11 = Gh * np.conj(Gh) + Fh * np.conj(Fh)
        self.tree = _ffldl(g00.real.astype(np.complex128), g01, g11, sigma)
        # target map: t = (hm | 0) B^-1 = (1/q) (-hm*F, hm*f)   [det B = q]
        self._tmap0 = -Fh / Q
        self._tmap1 = fh / Q

    def sample(self, hm: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
        hm_fft = fft(np.asarray(hm, dtype=np.float64))
        z0f, z1f = _ffsampling(
            hm_fft * self._tmap0, hm_fft * self._tmap1, self.tree, rng
        )
        z0 = np.rint(ifft(z0f).real).astype(np.int64)
        z1 = np.rint(ifft(z1f).real).astype(np.int64)
        # exact integer lattice point v = z B (Kronecker big-int mults)
        from .keygen import poly_mul

        z0l, z1l = [int(c) for c in z0], [int(c) for c in z1]
        v0 = np.asarray(poly_mul(z0l, self.g), np.int64) + np.asarray(
            poly_mul(z1l, self.G), np.int64
        )
        s2 = np.asarray(poly_mul(z0l, self.f), np.int64) + np.asarray(
            poly_mul(z1l, self.F), np.int64
        )
        s1 = np.asarray(hm, dtype=np.int64) - v0
        return s1, s2
