"""Reference-implementation-exact Falcon signer (dynamic-tree ffSampling).

Completes the spec-exactness program that falcon/spec_rng.py started
(round-3) and the round-3 VERDICT asked to finish: the reference repo
signs through falcon-rust's FFI into the Falcon reference C
implementation (`falcon-r1cs/Cargo.toml:11`,
`src/circuits/falcon_ntt.rs:133-141`), whose per-signature value
computation is IEEE-754 double arithmetic in a fixed operation order.
This module reproduces the whole of that computation:

  sign_dyn (reference sign.c do_sign_dyn):
    basis -> FFT -> Gram (g00, g01, g11)          [spec_fft, exact order]
    target (t0, t1) = (hm|0) B^-1 / q
    ffSampling_fft_dyntree                        [LDL + split + sample]
    recompute basis; (s1, s2) by FFT mul + rint
    saturating uint32 norm check (is_short_half)
    retry loop with per-attempt prng_init from one SHAKE256 stream

The SamplerZ layer underneath (ChaCha20 PRNG, RCDT gaussian0, BerExp) is
falcon/spec_rng.py, already pinned to published vectors.  Floating-point
notes: Python/numpy float64 ops are IEEE doubles with per-element
rounding and no FMA or reassociation, so following the reference's
expression trees reproduces its exact bit patterns; the twiddle/constant
tables are correctly-rounded from high-precision Decimal (provenance
caveats in PARITY_NOTES.md "Spec-exact signing").

Deterministic contract (pinned in tests/test_spec_sign.py): same key,
seed, and message -> identical signature, forever.  KAT auto-load:
tests/vectors/falcon_sign_kat_{512,1024}.json, if ever provided, is
compared byte-for-byte (zero-egress image; no official vectors can be
fetched).
"""

from __future__ import annotations

import hashlib
from decimal import Decimal

import numpy as np

from ..params import Q
from . import spec_fft as sf
from .spec_rng import ChaCha20Prng, SIGMA_MIN, sampler_z

# --------------------------------------------------------------------------
# Per-logn constants (reference fpr.c tables, entries for logn 9/10).
#
# fpr_inv_sigma[logn] = 1/sigma_{2^logn} as the correctly-rounded double
# of the high-precision decimal (the spec's sigma values, Table 3.3:
# sigma_512 = 165.736617183, sigma_1024 = 168.388571447); the module
# asserts consistency of the decimal strings against 1/sigma at import.
# fpr_sigma_min[logn] = sigma/(1.17*sqrt(q)) — the smallest leaf sigma.
# --------------------------------------------------------------------------

INV_SIGMA = {
    9: float(Decimal("0.0060336696681577241031668062510953022")),
    10: float(Decimal("0.0059386453095331159950250124336477482")),
}
_SIGMA = {9: Decimal("165.736617183"), 10: Decimal("168.388571447")}
for _ln, _inv in INV_SIGMA.items():
    assert abs(Decimal(_inv) * _SIGMA[_ln] - 1) < Decimal("1e-9"), _ln

SIGMA_MIN_LOGN = {9: SIGMA_MIN[512], 10: SIGMA_MIN[1024]}

# l2bound[logn]: floor(beta^2) per parameter set (spec section 2.5.1;
# same values as params.sig_l2_bound)
L2BOUND = {9: 34034726, 10: 70265242}

_INV_Q = 1.0 / 12289.0  # correctly rounded (IEEE division)
assert Q == 12289


# --------------------------------------------------------------------------
# ffSampling, dynamic-tree variant (reference sign.c ffSampling_fft_dyntree)
# --------------------------------------------------------------------------


def _ff_sampling_dyntree(samp, t0, t1, g00, g01, g11, orig_logn, logn):
    """Returns (z0, z1) sampled along the LDL tree computed on the fly.

    Mirrors the reference's recursion exactly: LDL at this level, split
    d00/d11 into half-size quasicyclic Grams, recurse on t1's split with
    the d11 sub-Gram, form tb0 = t0 + (t1 - z1) * l10, recurse on its
    split with the d00 sub-Gram.  At logn == 0 the leaf value is g00[0];
    leaf isigma = sqrt(leaf) * inv_sigma[orig_logn] feeds SamplerZ for
    t0 and then t1 — reference order: t0 drawn FIRST at the leaf, but
    the t1-subtree recursion runs before the t0-subtree at every inner
    level."""
    if logn == 0:
        leaf = g00[0]
        isigma = np.sqrt(leaf) * INV_SIGMA[orig_logn]
        z0 = float(samp(float(t0[0]), float(isigma)))
        z1 = float(samp(float(t1[0]), float(isigma)))
        return np.array([z0]), np.array([z1])

    hn = 1 << (logn - 1)
    # LDL: l10 (stored adjointed) over g01, d11 over g11; d00 = g00
    l10_adj, d11 = sf.poly_LDL_fft(g00, g01, g11)
    # split d00 / d11 into half-size sub-Grams (d0, d1) each; the
    # sub-Gram of a self-adjoint autocorrelation is [[d0, d1], [adj(d1),
    # d0]], passed as (g00', g01', g11') = (d0, d1, d0-copy)
    d00_0, d00_1 = sf.poly_split_fft(g00, logn)
    d11_0, d11_1 = sf.poly_split_fft(d11, logn)

    t1_0, t1_1 = sf.poly_split_fft(t1, logn)
    z1_0, z1_1 = _ff_sampling_dyntree(
        samp, t1_0, t1_1, d11_0, d11_1, d11_0.copy(), orig_logn, logn - 1
    )
    z1 = sf.poly_merge_fft(z1_0, z1_1, logn)

    # tb0 = t0 + (t1 - z1) * l10   (l10 = adj of what LDL stored)
    # The reference keeps l10 from poly_LDL_fft output (which stores
    # adj(mu)) and multiplies (t1 - z1) by it directly.
    tb0 = sf.poly_add(t0, sf.poly_mul_fft(sf.poly_sub(t1, z1), l10_adj))

    t0_0, t0_1 = sf.poly_split_fft(tb0, logn)
    z0_0, z0_1 = _ff_sampling_dyntree(
        samp, t0_0, t0_1, d00_0, d00_1, d00_0.copy(), orig_logn, logn - 1
    )
    z0 = sf.poly_merge_fft(z0_0, z0_1, logn)
    return z0, z1


# --------------------------------------------------------------------------
# is_short_half (reference common.c): saturating uint32 norm acceptance
# --------------------------------------------------------------------------


def _is_short_half(sqn: int, ng: int, s2: np.ndarray, logn: int) -> bool:
    """sqn/ng carry the s1 partial sum and its overflow-sticky OR; adds
    s2's squares with the same uint32 saturation semantics."""
    M32 = 0xFFFFFFFF
    for z in s2:
        sqn = (sqn + int(z) * int(z)) & M32
        ng |= sqn
    if ng >> 31:
        sqn = M32
    return sqn <= L2BOUND[logn]


# --------------------------------------------------------------------------
# do_sign_dyn (reference sign.c): one sampling attempt
# --------------------------------------------------------------------------


def _smallints_fft(v, logn: int) -> np.ndarray:
    return sf.fft(np.asarray(v, dtype=np.float64), logn)


def _do_sign_dyn(samp, f, g, F, G, hm, logn):
    """One attempt: returns (s1, s2) int arrays or None if the vector is
    not short enough (the caller re-seeds the PRNG and retries)."""
    n = 1 << logn

    # basis B = [[g, -f], [G, -F]] in FFT; reference FFT call order:
    # b01 (f), b00 (g), b11 (F), b10 (G), then negate b01 and b11
    b01 = _smallints_fft(f, logn)
    b00 = _smallints_fft(g, logn)
    b11 = _smallints_fft(F, logn)
    b10 = _smallints_fft(G, logn)
    b01 = sf.poly_neg(b01)
    b11 = sf.poly_neg(b11)

    # Gram (reference order of operations):
    #   t0 <- b01*adj(b01); t1 <- b00*adj(b10)
    #   g00 = b00*adj(b00) + t0
    #   g01 = b01*adj(b11) + t1
    #   g11 = b10*adj(b10) + b11*adj(b11)
    t0g = sf.poly_mulselfadj_fft(b01)
    t1g = sf.poly_muladj_fft(b00, b10)
    g00 = sf.poly_add(sf.poly_mulselfadj_fft(b00), t0g)
    g01 = sf.poly_add(sf.poly_muladj_fft(b01, b11), t1g)
    g11 = sf.poly_add(
        sf.poly_mulselfadj_fft(b10), sf.poly_mulselfadj_fft(b11)
    )
    b11_saved = b11  # reference keeps b11 and b01 for the target
    b01_saved = b01

    # target: t0 = FFT(hm) * b11 / q ; t1 = -FFT(hm) * b01 / q
    t0 = sf.fft(np.asarray(hm, dtype=np.float64), logn)
    t1 = t0.copy()
    t1 = sf.poly_mul_fft(t1, b01_saved)
    t1 = sf.poly_mulconst(t1, -_INV_Q)
    t0 = sf.poly_mul_fft(t0, b11_saved)
    t0 = sf.poly_mulconst(t0, _INV_Q)

    # sampling (destroys the Gram arrays in the reference; ours are
    # functional)
    z0, z1 = _ff_sampling_dyntree(samp, t0, t1, g00, g01, g11, logn, logn)

    # recompute the basis (the reference overwrote it with the Gram)
    b01 = _smallints_fft(f, logn)
    b00 = _smallints_fft(g, logn)
    b11 = _smallints_fft(F, logn)
    b10 = _smallints_fft(G, logn)
    b01 = sf.poly_neg(b01)
    b11 = sf.poly_neg(b11)

    # lattice point: tx = z0*b00 + z1*b10 ; t1' = z0*b01 + z1*b11
    tx = sf.poly_add(sf.poly_mul_fft(z0, b00), sf.poly_mul_fft(z1, b10))
    ty = sf.poly_mul_fft(z0, b01)
    t1v = sf.poly_add(sf.poly_mul_fft(z1, b11), ty)
    t0v = sf.ifft(tx, logn)
    t1v = sf.ifft(t1v, logn)

    # s1 = hm - rint(t0v), with saturating uint32 norm accumulation
    M32 = 0xFFFFFFFF
    sqn = 0
    ng = 0
    s1 = np.empty(n, dtype=np.int64)
    for u in range(n):
        z = int(hm[u]) - int(np.rint(t0v[u]))
        sqn = (sqn + z * z) & M32
        ng |= sqn
        s1[u] = z
    s2 = np.empty(n, dtype=np.int64)
    for u in range(n):
        s2[u] = -int(np.rint(t1v[u]))
    if _is_short_half(sqn, ng, s2, logn):
        return s1, s2
    return None


# --------------------------------------------------------------------------
# public entry: the retry loop with per-attempt prng_init
# --------------------------------------------------------------------------


class _ShakeStream:
    """Incremental SHAKE256 squeeze (reference inner-SHAKE rng context:
    each signing attempt extracts the NEXT 56 bytes of one stream)."""

    def __init__(self, seed: bytes):
        self._shake = hashlib.shake_256(seed)
        self._off = 0

    def next(self, k: int) -> bytes:
        out = self._shake.digest(self._off + k)[self._off :]
        self._off += k
        return out


def sign_dyn(f, g, F, G, hm, seed: bytes, logn: int):
    """Spec-exact signature halves (s1, s2) for hashed message hm under
    the secret basis (f, g, F, G), deterministic in `seed`.

    Reference flow (sign.c falcon_sign_dyn + nist.c): one SHAKE256
    stream from `seed`; per attempt, prng_init extracts 56 bytes into a
    fresh ChaCha20 PRNG; do_sign_dyn runs one ffSampling pass; retry
    until the aggregate vector is short."""
    if logn not in INV_SIGMA:
        raise ValueError("spec-exact signing supports logn 9 and 10 only")
    sigma_min = SIGMA_MIN_LOGN[logn]
    stream = _ShakeStream(seed)
    for _ in range(64):
        prng = ChaCha20Prng(stream.next(56))

        def samp(mu: float, isigma: float) -> int:
            return sampler_z(prng, mu, isigma, sigma_min)

        out = _do_sign_dyn(samp, f, g, F, G, hm, logn)
        if out is not None:
            return out
    raise RuntimeError("signature sampling failed to converge")
