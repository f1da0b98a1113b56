"""Falcon wire-format codecs: public keys and compressed signatures.

TPU-native equivalent of the encode/decode layer the reference inherits from
falcon-rust (`(&Signature).into::<Polynomial>()`, `(&PublicKey).into()`,
`Signature::nonce()` -- use sites
`falcon-r1cs/src/circuits/falcon_ntt.rs:27-28,44`).

Formats per the Falcon specification:

- Public key: 1 header byte (0x00 | log_n), then n 14-bit big-endian packed
  coefficients of h.  Sizes: 897 bytes (n=512), 1793 bytes (n=1024).
- Signature (falcon-rust layout): 1 header byte (0x30 | log_n), 40-byte
  nonce, then the COMPRESSED (Golomb-Rice) encoding of the signed s2
  coefficients, zero-padded to the fixed signature length.
  Per coefficient: 1 sign bit, 7 low-magnitude bits, then the high part
  (magnitude >> 7) in unary (that many 0 bits followed by a 1).
"""

from __future__ import annotations

import numpy as np

from ..params import FalconParams, get_params
from .hash_to_point import NONCE_LEN


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------------------
# public key (14-bit packing)
# ---------------------------------------------------------------------------


def encode_public_key(h: np.ndarray, params: FalconParams) -> bytes:
    """Pack h (n coeffs in [0, q)) into the Falcon public-key byte format."""
    n = params.n
    if h.shape != (n,):
        raise CodecError(f"h must have shape ({n},)")
    out = bytearray([params.header_pk])
    acc = 0
    acc_bits = 0
    for c in h.astype(np.int64):
        acc = (acc << 14) | int(c)
        acc_bits += 14
        while acc_bits >= 8:
            acc_bits -= 8
            out.append((acc >> acc_bits) & 0xFF)
    if acc_bits > 0:
        out.append((acc << (8 - acc_bits)) & 0xFF)
    if len(out) != params.pk_bytes:
        raise CodecError(f"encoded pk is {len(out)} bytes, want {params.pk_bytes}")
    return bytes(out)


def decode_public_key(data: bytes) -> tuple[np.ndarray, FalconParams]:
    """Unpack a Falcon public key; returns (h, params)."""
    if not data:
        raise CodecError("empty public key")
    header = data[0]
    log_n = header & 0x0F
    if header != log_n or log_n not in (9, 10):
        raise CodecError(f"bad public key header {header:#x}")
    params = get_params(1 << log_n)
    if len(data) != params.pk_bytes:
        raise CodecError(
            f"public key is {len(data)} bytes, want {params.pk_bytes}"
        )
    n = params.n
    h = np.empty(n, dtype=np.int64)
    acc = 0
    acc_bits = 0
    pos = 1
    for i in range(n):
        while acc_bits < 14:
            acc = (acc << 8) | data[pos]
            pos += 1
            acc_bits += 8
        acc_bits -= 14
        c = (acc >> acc_bits) & 0x3FFF
        if c >= params.q:
            raise CodecError(f"pk coefficient {i} = {c} >= q")
        h[i] = c
    # remaining padding bits must be zero
    if acc & ((1 << acc_bits) - 1):
        raise CodecError("nonzero padding bits in public key")
    return h, params


# ---------------------------------------------------------------------------
# signature (COMPRESSED / Golomb-Rice)
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.bits = 0

    def put(self, bit: int):
        self.acc = (self.acc << 1) | bit
        self.bits += 1
        if self.bits == 8:
            self.out.append(self.acc)
            self.acc = 0
            self.bits = 0

    def put_uint(self, value: int, width: int):
        for k in range(width - 1, -1, -1):
            self.put((value >> k) & 1)

    def finish(self) -> bytes:
        if self.bits:
            self.out.append(self.acc << (8 - self.bits))
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.bits = 0

    def get(self) -> int:
        if self.bits == 0:
            if self.pos >= len(self.data):
                raise CodecError("signature bitstream exhausted")
            self.acc = self.data[self.pos]
            self.pos += 1
            self.bits = 8
        self.bits -= 1
        return (self.acc >> self.bits) & 1

    def get_uint(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.get()
        return v


def compress_signature(
    s: np.ndarray, nonce: bytes, params: FalconParams
) -> bytes:
    """Encode signed coefficients s into the fixed-size signature format."""
    if len(nonce) != NONCE_LEN:
        raise CodecError(f"nonce must be {NONCE_LEN} bytes")
    if s.shape != (params.n,):
        raise CodecError(f"s must have shape ({params.n},)")
    w = _BitWriter()
    for c in s.astype(np.int64):
        c = int(c)
        sign = 1 if c < 0 else 0
        mag = -c if c < 0 else c
        if mag > 2047:
            raise CodecError(f"coefficient magnitude {mag} too large")
        w.put(sign)
        w.put_uint(mag & 0x7F, 7)
        high = mag >> 7
        for _ in range(high):
            w.put(0)
        w.put(1)
    payload = w.finish()
    room = params.sig_bytes - 1 - NONCE_LEN
    if len(payload) > room:
        raise CodecError(
            f"compressed payload {len(payload)} bytes exceeds {room}"
        )
    return (
        bytes([params.header_sig])
        + nonce
        + payload
        + b"\x00" * (room - len(payload))
    )


def decompress_signature(data: bytes) -> tuple[np.ndarray, bytes, FalconParams]:
    """Decode a signature; returns (signed coeffs, nonce, params)."""
    if not data:
        raise CodecError("empty signature")
    header = data[0]
    log_n = header & 0x0F
    if (header & 0xF0) != 0x30 or log_n not in (9, 10):
        raise CodecError(f"bad signature header {header:#x}")
    params = get_params(1 << log_n)
    if len(data) != params.sig_bytes:
        raise CodecError(
            f"signature is {len(data)} bytes, want {params.sig_bytes}"
        )
    nonce = data[1 : 1 + NONCE_LEN]
    r = _BitReader(data[1 + NONCE_LEN :])
    s = np.empty(params.n, dtype=np.int64)
    for i in range(params.n):
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
    # remaining payload bits must be zero padding
    rest = r.data[r.pos :]
    if (r.acc & ((1 << r.bits) - 1)) or any(rest):
        raise CodecError("nonzero padding in signature")
    return s, nonce, params
