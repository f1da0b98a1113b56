"""NIST KAT harness: the official Falcon `.rsp` vector format, end to end.

Closes the round-4 VERDICT gap (#5 / PARITY_NOTES caveat (d)): the
reference repo inherits bit-compatible keygen/sign through falcon-rust's
FFI into the Falcon reference C (`falcon-r1cs/
Cargo.toml:11`, used at `src/circuits/falcon_ntt.rs:133-141`), so its
KAT story is the C implementation's own.  This image has zero egress and
no C vectors, so what CAN be closed offline is the *plumbing*: dropping
an official `falcon{512,1024}-KAT.rsp` file into tests/vectors/ must
validate keygen+sign byte-for-byte with ZERO code changes.  This module
provides every piece the NIST KAT framework wraps around the signer:

  - AES-256-CTR DRBG (the KAT framework's rng.c `randombytes`): pure-
    Python AES-256 (S-box and key schedule computed from the FIPS-197
    definitions at import; block function pinned to the FIPS-197 C.3
    vector in tests) + the CTR-DRBG update/generate flow with no
    derivation function.
  - Secret-key codec: header 0x50|logn, then f and g at
    max_fg_bits[logn] (6 bits at n=512, 5 at n=1024) and F at 8 bits,
    two's-complement MSB-first (the C codec.c trim_i8 format; the most
    negative pattern is invalid, as there).
  - `complete_private`: recover G from (f, g, F) via the NTRU equation
    f*G - g*F = q  =>  G = g*F/f (mod q), centered — exactly how the C
    recomputes the un-stored G — then verified EXACTLY over Z[x]/(x^n+1)
    with the keygen layer's Kronecker negacyclic multiply.
  - Raw Golomb-Rice `comp_encode`/`comp_decode` (the un-padded variable-
    length signature body the KAT `sm` embeds; falcon/codec.py holds the
    fixed-size padded wire format).
  - The nist.c crypto_sign_keypair / crypto_sign flows: per-case DRBG
    draw order (keypair seed 48 B; nonce 40 B, then signing seed 48 B),
    hash-to-point over SHAKE256(nonce || msg), the spec-exact dyntree
    signer (falcon/spec_sign.py), and the
      sm = sig_len(2 BE) || nonce || msg || (0x20|logn) || comp_encode(s2)
    envelope.
  - `.rsp` parsing and `validate_case`, the per-vector checker the
    auto-load tests drive.

Honesty note (PARITY_NOTES "Spec-exact signing" caveats): `keygen_from_
seed` derives its sampler stream from SHAKE256 of the KAT seed via OUR
keygen (falcon/keygen.py), which follows the spec's construction but has
never been bit-matched against the C's inner-SHAKE keygen.  On a real
vector file `validate_case` therefore reports the keygen comparison
SEPARATELY from the sign comparison — the sign check exercises the
vector's own decoded (f, g, F) + completed G, so it stands on its own.
The self-generated fixture (tests/test_nist_kat.py) proves the whole
pipe round-trips in the exact official format.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from ..params import Q, FalconParams, get_params
from .codec import CodecError, _BitReader, _BitWriter, encode_public_key
from .hash_to_point import NONCE_LEN, hash_to_point
from .keygen import SecretKey, keygen, poly_mul
from .ntt import intt, ntt
from .spec_sign import sign_dyn

# ---------------------------------------------------------------------------
# AES-256 block encryption (FIPS-197), encrypt-only — the KAT DRBG's core
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _make_sbox() -> bytes:
    # multiplicative inverses in GF(2^8) via the 3-generator log tables
    log = [0] * 256
    alog = [0] * 256
    x = 1
    for i in range(255):
        alog[i] = x
        log[x] = i
        x = _gf_mul(x, 3)
    sbox = bytearray(256)
    for v in range(256):
        inv = 0 if v == 0 else alog[(255 - log[v]) % 255]
        s = inv
        for k in (1, 2, 3, 4):
            s ^= ((inv << k) | (inv >> (8 - k))) & 0xFF
        sbox[v] = s ^ 0x63
    return bytes(sbox)


_SBOX = _make_sbox()
_XTIME = bytes(_gf_mul(v, 2) for v in range(256))
_RCON = [1]
for _ in range(13):
    _RCON.append(_gf_mul(_RCON[-1], 2))


def _expand_key_256(key: bytes) -> list[bytes]:
    """AES-256 key schedule -> 15 round keys of 16 bytes."""
    assert len(key) == 32
    w = [key[4 * i : 4 * i + 4] for i in range(8)]
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = bytes(
                _SBOX[b] for b in (t[1], t[2], t[3], t[0])
            )
            t = bytes([t[0] ^ _RCON[i // 8 - 1], t[1], t[2], t[3]])
        elif i % 8 == 4:
            t = bytes(_SBOX[b] for b in t)
        w.append(bytes(a ^ b for a, b in zip(w[i - 8], t)))
    return [b"".join(w[4 * r : 4 * r + 4]) for r in range(15)]


def _aes_rounds(state: bytearray, rks: list[bytes]) -> bytes:
    s = bytearray(a ^ b for a, b in zip(state, rks[0]))
    for rnd in range(1, 15):
        # SubBytes
        for i in range(16):
            s[i] = _SBOX[s[i]]
        # ShiftRows (column-major state: byte r + 4c)
        s = bytearray(
            [
                s[0], s[5], s[10], s[15],
                s[4], s[9], s[14], s[3],
                s[8], s[13], s[2], s[7],
                s[12], s[1], s[6], s[11],
            ]
        )
        if rnd < 14:
            # MixColumns
            for c in range(0, 16, 4):
                a0, a1, a2, a3 = s[c : c + 4]
                s[c] = _XTIME[a0] ^ _XTIME[a1] ^ a1 ^ a2 ^ a3
                s[c + 1] = a0 ^ _XTIME[a1] ^ _XTIME[a2] ^ a2 ^ a3
                s[c + 2] = a0 ^ a1 ^ _XTIME[a2] ^ _XTIME[a3] ^ a3
                s[c + 3] = _XTIME[a0] ^ a0 ^ a1 ^ a2 ^ _XTIME[a3]
        rk = rks[rnd]
        for i in range(16):
            s[i] ^= rk[i]
    return bytes(s)


def aes256_ecb_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One AES-256 block encryption (pinned to FIPS-197 C.3 in tests)."""
    assert len(block) == 16
    return _aes_rounds(bytearray(block), _expand_key_256(key))


# ---------------------------------------------------------------------------
# NIST AES-256-CTR DRBG (the KAT framework's rng.c, no derivation function)
# ---------------------------------------------------------------------------


class NistDrbg:
    """randombytes_init / randombytes with the rng.c state machine:
    V increments big-endian before each block; a keystream-only Update
    reshapes (Key, V) after every generate call."""

    def __init__(self, seed48: bytes, personalization: bytes | None = None):
        if len(seed48) != 48:
            raise ValueError("DRBG entropy input must be 48 bytes")
        material = bytearray(seed48)
        if personalization:
            for i in range(48):
                material[i] ^= personalization[i]
        self._key = bytes(32)
        self._v = bytes(16)
        self._update(bytes(material))

    @staticmethod
    def _inc(v: bytearray) -> None:
        for j in range(15, -1, -1):
            if v[j] == 0xFF:
                v[j] = 0
            else:
                v[j] += 1
                break

    def _update(self, provided: bytes | None) -> None:
        rks_v = bytearray(self._v)
        temp = bytearray()
        for _ in range(3):
            self._inc(rks_v)
            temp += aes256_ecb_encrypt_block(self._key, bytes(rks_v))
        if provided is not None:
            for i in range(48):
                temp[i] ^= provided[i]
        self._key = bytes(temp[:32])
        self._v = bytes(temp[32:48])

    def random_bytes(self, n: int) -> bytes:
        out = bytearray()
        v = bytearray(self._v)
        while len(out) < n:
            self._inc(v)
            out += aes256_ecb_encrypt_block(self._key, bytes(v))
        self._v = bytes(v)
        self._update(None)
        return bytes(out[:n])


# ---------------------------------------------------------------------------
# secret-key codec (C codec.c trim_i8 format)
# ---------------------------------------------------------------------------

MAX_FG_BITS = {9: 6, 10: 5}  # codec.c max_fg_bits[logn]
MAX_FG_LIM = {9: 1 << 5, 10: 1 << 4}


def sk_bytes(params: FalconParams) -> int:
    logn = params.n.bit_length() - 1
    return 1 + 2 * (params.n * MAX_FG_BITS[logn] // 8) + params.n


def encode_secret_key(f, g, F, params: FalconParams) -> bytes:
    """sk = 0x50|logn, then f, g at max_fg_bits and F at 8 bits, each
    two's-complement MSB-first (all three sections are byte-aligned at
    the supported logn)."""
    logn = params.n.bit_length() - 1
    fg_bits = MAX_FG_BITS[logn]
    w = _BitWriter()
    for coeffs, bits in ((f, fg_bits), (g, fg_bits), (F, 8)):
        if len(coeffs) != params.n:
            raise CodecError("bad secret polynomial length")
        lim = 1 << (bits - 1)
        for c in coeffs:
            c = int(c)
            if c <= -lim or c >= lim:
                raise CodecError(
                    f"coefficient {c} out of range for {bits}-bit encoding"
                )
            w.put_uint(c & ((1 << bits) - 1), bits)
    return bytes([0x50 | logn]) + w.finish()


def decode_secret_key(data: bytes) -> tuple[np.ndarray, np.ndarray,
                                            np.ndarray, FalconParams]:
    """-> (f, g, F, params).  Rejects the most negative bit pattern per
    section, as trim_i8_decode does."""
    if not data:
        raise CodecError("empty secret key")
    header = data[0]
    logn = header & 0x0F
    if (header & 0xF0) != 0x50 or logn not in (9, 10):
        raise CodecError(f"bad secret key header {header:#x}")
    params = get_params(1 << logn)
    if len(data) != sk_bytes(params):
        raise CodecError(
            f"secret key is {len(data)} bytes, want {sk_bytes(params)}"
        )
    r = _BitReader(data[1:])
    out = []
    for bits in (MAX_FG_BITS[logn], MAX_FG_BITS[logn], 8):
        lim = 1 << (bits - 1)
        poly = np.empty(params.n, dtype=np.int64)
        for i in range(params.n):
            v = r.get_uint(bits)
            if v >= lim:
                v -= 1 << bits
            if v == -lim:
                raise CodecError("most negative coefficient is invalid")
            poly[i] = v
        out.append(poly)
    return out[0], out[1], out[2], params


def complete_private(f, g, F, params: FalconParams) -> np.ndarray:
    """Recover the un-stored G from the NTRU equation f*G - g*F = q:
    G = g*F/f (mod q) centered to (-q/2, q/2], then verified EXACTLY
    over Z[x]/(x^n + 1) (Kronecker negacyclic multiply) — any decode or
    completion error is caught here, not downstream."""
    fn = ntt(np.asarray(f, dtype=np.int64) % Q)
    if np.any(fn == 0):
        raise CodecError("f is not invertible mod q")
    gn = ntt(np.asarray(g, dtype=np.int64) % Q)
    Fn = ntt(np.asarray(F, dtype=np.int64) % Q)
    finv = np.array([pow(int(c), Q - 2, Q) for c in fn], dtype=np.int64)
    G = intt(gn * Fn % Q * finv % Q)
    G = np.where(G > Q // 2, G - Q, G).astype(np.int64)
    if int(np.max(np.abs(G))) > 127:
        raise CodecError("completed G out of the 8-bit coefficient range")
    lhs = np.asarray(
        poly_mul([int(c) for c in f], [int(c) for c in G]), dtype=object
    ) - np.asarray(
        poly_mul([int(c) for c in g], [int(c) for c in F]), dtype=object
    )
    if int(lhs[0]) != Q or any(int(c) != 0 for c in lhs[1:]):
        raise CodecError("NTRU equation f*G - g*F = q does not hold")
    return G


# ---------------------------------------------------------------------------
# raw compressed signature body (codec.c comp_encode / comp_decode)
# ---------------------------------------------------------------------------


def comp_encode(s: np.ndarray) -> bytes:
    """Minimal-length Golomb-Rice body: per coefficient one sign bit,
    7 low bits, then the high magnitude in unary; final partial byte
    zero-padded.  (codec.py's compress_signature wraps this same coding
    in the fixed-size padded wire format.)"""
    w = _BitWriter()
    for c in np.asarray(s, dtype=np.int64):
        c = int(c)
        mag = -c if c < 0 else c
        if mag > 2047:
            raise CodecError(f"coefficient magnitude {mag} too large")
        w.put(1 if c < 0 else 0)
        w.put_uint(mag & 0x7F, 7)
        for _ in range(mag >> 7):
            w.put(0)
        w.put(1)
    return w.finish()


def comp_decode(data: bytes, n: int) -> np.ndarray:
    """Inverse of comp_encode over an exactly-sized buffer: all padding
    bits after the last coefficient must be zero."""
    r = _BitReader(data)
    s = np.empty(n, dtype=np.int64)
    for i in range(n):
        sign = r.get()
        mag = r.get_uint(7)
        high = 0
        while r.get() == 0:
            high += 1
            if high > 16:
                raise CodecError("unary run too long")
        mag |= high << 7
        if sign and mag == 0:
            raise CodecError("negative zero encoding is invalid")
        s[i] = -mag if sign else mag
    if (r.acc & ((1 << r.bits) - 1)) or any(r.data[r.pos :]):
        raise CodecError("nonzero padding in compressed signature")
    return s


# ---------------------------------------------------------------------------
# nist.c crypto_sign_keypair / crypto_sign flows
# ---------------------------------------------------------------------------


def keygen_from_seed(kseed: bytes, params: FalconParams) -> SecretKey:
    """Keygen deterministically from the KAT keypair seed.

    The C keygen consumes an inner-SHAKE256 stream of `kseed` directly
    in its samplers; our keygen (falcon/keygen.py) follows the spec's
    construction over a numpy Generator, so the stream is derived as
    SHAKE256(kseed) -> Generator entropy.  Deterministic and routed —
    but NOT bit-compatible with the C keygen (PARITY_NOTES caveats);
    validate_case reports this comparison separately from the sign
    check for exactly that reason."""
    entropy = int.from_bytes(hashlib.shake_256(kseed).digest(32), "little")
    return keygen(np.random.default_rng(entropy), params)


def crypto_sign_keypair(drbg: NistDrbg, params: FalconParams):
    """KAT keypair flow: one 48-byte DRBG draw seeds keygen; returns
    (pk_bytes, sk_bytes, SecretKey)."""
    kseed = drbg.random_bytes(48)
    sk = keygen_from_seed(kseed, params)
    pk = encode_public_key(sk.h(), params)
    skb = encode_secret_key(sk.f, sk.g, sk.F, params)
    return pk, skb, sk


def crypto_sign(msg: bytes, f, g, F, G, params: FalconParams,
                drbg: NistDrbg) -> bytes:
    """KAT signing flow (nist.c crypto_sign): nonce then signing seed
    from the DRBG, hash-to-point over SHAKE256(nonce || msg), the
    spec-exact dyntree signer, and the KAT envelope
      sm = sig_len(2 BE) || nonce || msg || 0x20|logn || comp_encode(s2)
    with sig_len counting the header byte."""
    logn = params.n.bit_length() - 1
    nonce = drbg.random_bytes(NONCE_LEN)
    hm = hash_to_point(msg, nonce, params.n)
    seed = drbg.random_bytes(48)
    _, s2 = sign_dyn(f, g, F, G, hm, seed, logn)
    esig = bytes([0x20 | logn]) + comp_encode(s2)
    return len(esig).to_bytes(2, "big") + nonce + msg + esig


# ---------------------------------------------------------------------------
# .rsp parsing and per-case validation
# ---------------------------------------------------------------------------

_HEX_FIELDS = {"seed", "msg", "pk", "sk", "sm"}
_INT_FIELDS = {"count", "mlen", "smlen"}


def parse_rsp(text: str) -> list[dict]:
    """The NIST `.rsp` shape: `# comment` lines, blank separators, and
    `key = value` fields; a `count` field starts a new case."""
    cases: list[dict] = []
    cur: dict | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith("["):
            continue
        key, sep, val = line.partition("=")
        if not sep:
            raise CodecError(f"unparseable .rsp line: {raw!r}")
        key = key.strip()
        val = val.strip()
        if key == "count":
            if cur is not None:
                cases.append(cur)
            cur = {}
        if cur is None:
            raise CodecError(".rsp fields before the first count")
        if key in _HEX_FIELDS:
            try:
                cur[key] = bytes.fromhex(val)
            except ValueError as e:
                raise CodecError(f"bad hex for {key}: {e}") from e
        elif key in _INT_FIELDS:
            cur[key] = int(val)
        else:
            cur[key] = val
    if cur is not None:
        cases.append(cur)
    return cases


def write_rsp(cases: list[dict], params: FalconParams) -> str:
    """Emit cases in the official format (fixture generation)."""
    out = [f"# Falcon-{params.n}", ""]
    for case in cases:
        out.append(f"count = {case['count']}")
        out.append(f"seed = {case['seed'].hex().upper()}")
        out.append(f"mlen = {case['mlen']}")
        out.append(f"msg = {case['msg'].hex().upper()}")
        out.append(f"pk = {case['pk'].hex().upper()}")
        out.append(f"sk = {case['sk'].hex().upper()}")
        out.append(f"smlen = {case['smlen']}")
        out.append(f"sm = {case['sm'].hex().upper()}")
        out.append("")
    return "\n".join(out) + "\n"


def validate_case(case: dict, params: FalconParams) -> dict:
    """Run one KAT case end to end; returns the per-check verdicts
    {"keygen": bool, "sign": bool, "consistent": bool, ...} so real
    vectors report the keygen and sign comparisons independently.

    The DRBG draw order must mirror the KAT framework exactly: keypair
    seed (48), then nonce (40), then signing seed (48), all from one
    randombytes_init(case seed)."""
    drbg = NistDrbg(case["seed"])
    out: dict = {}

    # keypair phase (always consumes its DRBG draw, matching the C flow)
    pk_ours, sk_ours, _ = crypto_sign_keypair(drbg, params)
    out["keygen"] = pk_ours == case["pk"] and sk_ours == case["sk"]

    # decode the VECTOR's own keys; complete G; structural consistency
    f, g, F, dec_params = decode_secret_key(case["sk"])
    if dec_params.n != params.n:
        raise CodecError("sk parameter set does not match the file")
    G = complete_private(f, g, F, params)
    from .codec import decode_public_key

    h, _ = decode_public_key(case["pk"])
    fn = ntt(np.asarray(f) % Q)
    gn = ntt(np.asarray(g) % Q)
    finv = np.array([pow(int(c), Q - 2, Q) for c in fn], dtype=np.int64)
    out["consistent"] = bool(
        np.array_equal(intt(gn * finv % Q), np.asarray(h) % Q)
    )

    # sign phase with the vector's keys and the continued DRBG stream
    sm = crypto_sign(case["msg"], f, g, F, G, params, drbg)
    out["sign"] = sm == case["sm"]
    out["smlen"] = len(sm) == case.get("smlen", len(sm))

    # independent verification of the vector's own sm (decode + verify)
    sig_len = int.from_bytes(case["sm"][:2], "big")
    nonce = case["sm"][2 : 2 + NONCE_LEN]
    mlen = len(case["sm"]) - 2 - NONCE_LEN - sig_len
    msg = case["sm"][2 + NONCE_LEN : 2 + NONCE_LEN + mlen]
    esig = case["sm"][2 + NONCE_LEN + mlen :]
    logn = params.n.bit_length() - 1
    ok = esig[:1] == bytes([0x20 | logn]) and msg == case["msg"]
    if ok:
        s2 = comp_decode(esig[1:], params.n)
        hm = hash_to_point(msg, nonce, params.n)
        s2h = intt(ntt(np.asarray(s2) % Q) * ntt(np.asarray(h) % Q) % Q)
        s1 = (np.asarray(hm, np.int64) - s2h) % Q
        s1 = np.where(s1 > Q // 2, s1 - Q, s1)
        norm = int(np.sum(s1 * s1) + np.sum(s2 * s2))
        ok = norm <= params.sig_l2_bound
    out["sm_verifies"] = bool(ok)
    return out


def validate_rsp(path: str | Path, n: int) -> list[dict]:
    """Validate every case of a `.rsp` file for parameter set n."""
    params = get_params(n)
    return [
        {"count": case.get("count"), **validate_case(case, params)}
        for case in parse_rsp(Path(path).read_text())
    ]
