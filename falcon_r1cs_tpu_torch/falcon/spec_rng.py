"""Spec-exact Falcon signing RNG: ChaCha20 PRNG + RCDT SamplerZ.

KAT-readiness layer (round-2 VERDICT Next #6).  The reference repo's
signing randomness is the Falcon reference C behind falcon-rust FFI
(falcon-r1cs/Cargo.toml:11, used from
examples/pok_sig.rs:15-21); `falcon/sampler.py` here is spec-SHAPED
(distributionally correct, numpy RNG).  This module is spec-EXACT: the
Falcon specification's published constants and integer/double algorithm
flow, so that given the same seed/inputs the outputs are bit-for-bit
reproducible and directly comparable against official SamplerZ /
signature KAT vectors the day one is available (the image has zero
egress; tests/test_spec_sampler.py auto-loads vector files if present).

Components (Falcon spec v1.2, Algorithms 12-15 + reference-impl layout):

- `ChaCha20Prng` — the spec's PRNG: a 56-byte SHAKE256-derived state
  (48-byte key block + 64-bit counter), refilled 8 ChaCha20 blocks at a
  time with the AVX2-interleaved output order the reference implements
  (block u's word v lands at byte 4*u + 32*v), `get_u64`/`get_u8` with
  the reference's exact refill boundaries (u64 refills at ptr > 503,
  u8 refills after consuming byte 511).
- `gaussian0` — BaseSampler: 72 random bits vs the published 18-entry
  RCDT for the half-Gaussian at sigma_max = 1.8205 (Table 3.1 of the
  spec; validated digit-for-digit against a 60-digit decimal
  recomputation in tests).
- `expm_p63` — ApproxExp: the published 13-coefficient 63-bit
  fixed-point polynomial for ccs * exp(-x) (FACCT, eprint 2018/1234),
  with the reference's exact top-64-bits product truncation.
- `ber_exp` — BerExp: exact byte-wise lazy Bernoulli(ccs * exp(-x)).
- `sampler_z` — SamplerZ(mu, 1/sigma): rejection-samples
  D_{Z, sigma, mu} via gaussian0 + sign flip + ber_exp.

All floating-point steps are IEEE-754 double ops in the reference's
operation order (Python floats are IEEE doubles; no FMA/x87 here), so
they round identically to the C.  Distribution tests + the RFC 8439
quarter-round/block pins: tests/test_spec_sampler.py.
"""

from __future__ import annotations

import hashlib
import math

_M32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF

# ChaCha20 "expand 32-byte k" constants (RFC 8439 section 2.3).
CW = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _qround(s, a, b, c, d):
    """One ChaCha20 quarter-round on list s (in place)."""
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 16) | (s[d] >> 16)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 12) | (s[b] >> 20)) & _M32
    s[a] = (s[a] + s[b]) & _M32
    s[d] ^= s[a]
    s[d] = ((s[d] << 8) | (s[d] >> 24)) & _M32
    s[c] = (s[c] + s[d]) & _M32
    s[b] ^= s[c]
    s[b] = ((s[b] << 7) | (s[b] >> 25)) & _M32


def chacha20_core(state16):
    """20 ChaCha rounds + feed-forward add on a 16-word initial state.

    The shared permutation under both the RFC 8439 block function (which
    pins this core in tests) and the Falcon PRNG's refill below."""
    s = list(state16)
    for _ in range(10):
        _qround(s, 0, 4, 8, 12)
        _qround(s, 1, 5, 9, 13)
        _qround(s, 2, 6, 10, 14)
        _qround(s, 3, 7, 11, 15)
        _qround(s, 0, 5, 10, 15)
        _qround(s, 1, 6, 11, 12)
        _qround(s, 2, 7, 8, 13)
        _qround(s, 3, 4, 9, 14)
    return [(x + y) & _M32 for x, y in zip(s, state16)]


class ChaCha20Prng:
    """The Falcon spec's signing PRNG (reference-impl rng layout).

    State: 14 little-endian u32 words from SHAKE256 (words 0-11 are the
    per-block key material; words 12-13 form a 64-bit block counter).
    Each refill emits 8 ChaCha20 blocks whose output words are
    interleaved (block u, word v -> buffer bytes [4u + 32v, 4u + 32v + 4))
    — the AVX2 lane order the reference fixes for ALL implementations so
    the stream is implementation-independent."""

    BUF = 512

    def __init__(self, seed56: bytes):
        if len(seed56) != 56:
            raise ValueError("ChaCha20Prng state seed must be 56 bytes")
        self.key = [
            int.from_bytes(seed56[4 * i : 4 * i + 4], "little")
            for i in range(12)
        ]
        # words 12/13 combine into the 64-bit counter: cc = tl + (th<<32)
        tl = int.from_bytes(seed56[48:52], "little")
        th = int.from_bytes(seed56[52:56], "little")
        self.cc = (tl + (th << 32)) & _M64
        self.buf = bytearray(self.BUF)
        self.ptr = 0
        self._refill()

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaCha20Prng":
        """SHAKE256(seed) -> 56-byte PRNG state (the spec's prng_init
        extraction from an inner-SHAKE256 context)."""
        return cls(hashlib.shake_256(seed).digest(56))

    def _refill(self):
        cc = self.cc
        key = self.key
        for u in range(8):
            init = list(CW) + key
            init[14] ^= cc & _M32
            init[15] ^= (cc >> 32) & _M32
            out = chacha20_core(init)
            for v in range(16):
                off = (u << 2) + (v << 5)
                self.buf[off : off + 4] = out[v].to_bytes(4, "little")
            cc = (cc + 1) & _M64
        self.cc = cc
        self.ptr = 0

    def get_u64(self) -> int:
        u = self.ptr
        if u >= self.BUF - 9:  # the reference's exact (conservative) bound
            self._refill()
            u = 0
        self.ptr = u + 8
        return int.from_bytes(self.buf[u : u + 8], "little")

    def get_u8(self) -> int:
        v = self.buf[self.ptr]
        self.ptr += 1
        if self.ptr == self.BUF:
            self._refill()
        return v


# --- BaseSampler: the published reverse-CDT ---------------------------------

# Half-Gaussian at sigma_max = 1.8205, 72-bit precision, 18 entries
# (Falcon spec Table 3.1; stored as (hi24, mid24, lo24) like the
# reference's dist[]).  RCDT[i] = round(2^72 * P(X > i)), X ~ D+_{sigma
# max}; tests recompute the table from the distribution at 60-digit
# precision and require digit-for-digit equality.
_RCDT_TRIPLES = (
    (10745844, 3068844, 3741698),
    (5559083, 1580863, 8248194),
    (2260429, 13669192, 2736639),
    (708981, 4421575, 10046180),
    (169348, 7122675, 4136815),
    (30538, 13063405, 7650655),
    (4132, 14505003, 7826148),
    (417, 16768101, 11363290),
    (31, 8444042, 8086568),
    (1, 12844466, 265321),
    (0, 1232676, 13644283),
    (0, 38047, 9111839),
    (0, 870, 6138264),
    (0, 14, 12545723),
    (0, 0, 3104126),
    (0, 0, 28824),
    (0, 0, 198),
    (0, 0, 1),
)
RCDT = tuple(
    (hi << 48) | (mid << 24) | lo for hi, mid, lo in _RCDT_TRIPLES
)


def gaussian0(prng: ChaCha20Prng) -> int:
    """BaseSampler (spec Algorithm 12): z0 = #{i : u < RCDT[i]} for a
    72-bit draw u, consumed as one u64 + one u8 exactly like the
    reference (9 bytes per call)."""
    lo = prng.get_u64()
    hi = prng.get_u8()
    u = lo | (hi << 64)  # 72-bit uniform
    z = 0
    for r in RCDT:
        z += u < r
    return z


# --- ApproxExp / BerExp ------------------------------------------------------

# 63-bit fixed-point polynomial for exp(-x) on [0, ln 2] (FACCT,
# eprint 2018/1234; Falcon spec Algorithm 13's C[] table).
C_EXPM = (
    0x00000004741183A3,
    0x00000036548CFC06,
    0x0000024FDCBF140A,
    0x0000171D939DE045,
    0x0000D00CF58F6F84,
    0x000680681CF796E3,
    0x002D82D8305B0FEA,
    0x011111110E066FD0,
    0x0555555555070F00,
    0x155555555581FF00,
    0x400000000002B400,
    0x7FFFFFFFFFFF4800,
    0x8000000000000000,
)

_PTWO63 = 9223372036854775808.0  # 2^63 as a double (exact)
# ln 2 / 1/ln 2 as correctly-rounded doubles (the reference's fpr
# constants round to the same values)
_LOG2 = float.fromhex("0x1.62e42fefa39efp-1")
_INV_LOG2 = float.fromhex("0x1.71547652b82fep+0")
# 1/(2 * 1.8205^2), the reference's fpr_inv_2sqrsigma0
_INV_2SQRSIGMA0 = 0.150865048875372721532312163019


def expm_p63(x: float, ccs: float) -> int:
    """ApproxExp: ~2^63 * ccs * exp(-x) for x in [0, ln 2], ccs in [0,1].

    Fixed-point Horner over C_EXPM.  Each step keeps the top 64 bits of
    the 128-bit product z*y — Python's exact `(z*y) >> 64` equals the
    reference's 32x32 carry-split truncation identically (the discarded
    low half can never carry into bit 64)."""
    y = C_EXPM[0]
    z = (int(x * _PTWO63) << 1) & _M64
    for c in C_EXPM[1:]:
        y = (c - ((z * y) >> 64)) & _M64
    z = (int(ccs * _PTWO63) << 1) & _M64
    return (z * y) >> 64


def ber_exp(prng: ChaCha20Prng, x: float, ccs: float) -> bool:
    """BerExp (spec Algorithm 14): Bernoulli(ccs * exp(-x)), x >= 0.

    Splits x = s*ln2 + r, compares the 64-bit fixed-point probability
    (2*ApproxExp - 1) >> s against lazily drawn bytes, high byte first,
    stopping at the first difference."""
    s = int(x * _INV_LOG2)  # trunc(x / ln 2)
    r = x - s * _LOG2
    s = min(s, 63)
    z = ((((expm_p63(r, ccs) << 1) - 1) & _M64) >> s)
    i = 64
    while True:
        i -= 8
        w = prng.get_u8() - ((z >> i) & 0xFF)
        if w != 0 or i == 0:
            break
    return w < 0


def sampler_z(prng: ChaCha20Prng, mu: float, isigma: float,
              sigma_min: float) -> int:
    """SamplerZ (spec Algorithm 15): one draw from D_{Z, 1/isigma, mu}.

    Requires sigma in [sigma_min, sigma_max=1.8205].  Flow, constants,
    and randomness consumption order match the reference exactly."""
    s = math.floor(mu)
    r = mu - s
    dss = 0.5 * (isigma * isigma)
    ccs = isigma * sigma_min
    while True:
        z0 = gaussian0(prng)
        b = prng.get_u8() & 1
        z = b + (2 * b - 1) * z0
        x = ((z - r) * (z - r)) * dss - (z0 * z0) * _INV_2SQRSIGMA0
        if ber_exp(prng, x, ccs):
            return s + z


# --- parameter-set constants -------------------------------------------------

# Smallest leaf sigma the ffSampling tree can request (spec Table 3.3);
# the ccs = sigma_min/sigma factor in SamplerZ keeps rejection rates
# uniform across leaves.
SIGMA_MIN = {512: 1.2778336969128337, 1024: 1.298280334344292}
SIGMA_MAX = 1.8205


class SpecSampler:
    """Adapter presenting the spec-exact SamplerZ under the same
    (center, sigma) call shape the ffSampling tree uses, carrying its
    own ChaCha20 PRNG.  Pass as `rng` to FalconSecretKey.sign(...,
    spec_exact path) — ffsampling dispatches on this type."""

    def __init__(self, seed: bytes, n: int):
        if n not in SIGMA_MIN:
            raise ValueError(f"no sigma_min for n={n}")
        self.prng = ChaCha20Prng.from_seed(seed)
        self.sigma_min = SIGMA_MIN[n]

    def sample_z(self, center: float, sigma: float) -> int:
        if not self.sigma_min <= sigma <= SIGMA_MAX + 1e-9:
            raise ValueError(
                f"sigma'={sigma} outside [{self.sigma_min}, {SIGMA_MAX}]"
            )
        return sampler_z(self.prng, center, 1.0 / sigma, self.sigma_min)
