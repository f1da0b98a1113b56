"""Falcon hash-to-point: SHAKE256 rejection sampling, bit-exact per spec.

TPU-native equivalent of falcon-rust's `Polynomial::from_hash_of_message`
(used at `falcon-r1cs/src/circuits/falcon_ntt.rs:44` and
`falcon-r1cs/examples/pok_sig.rs:35`).  Per the Falcon
specification ("HashToPoint"): SHAKE256 over (40-byte nonce || message);
squeeze 16-bit big-endian chunks t; accept t < 61445 (= 5*q); output t mod q,
until n coefficients are produced.

Inherently host-side and sequential per message (rejection sampling); the
batched witness engine precomputes hm for a whole batch on host (optionally
via the native C extension, native/) and overlaps with device
compute -- see SURVEY.md section 7 "hard parts" item 4.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..params import Q

NONCE_LEN = 40
_ACCEPT_BOUND = 5 * Q  # 61445


def hash_to_point(msg: bytes, nonce: bytes, n: int) -> np.ndarray:
    """Hash (msg, nonce) to a degree-n polynomial with coeffs in [0, q)."""
    if len(nonce) != NONCE_LEN:
        raise ValueError(f"nonce must be {NONCE_LEN} bytes, got {len(nonce)}")
    shake = hashlib.shake_256()
    shake.update(nonce)
    shake.update(msg)
    # Squeeze generously; top up in the (rare) case rejections exhaust it.
    out = np.empty(n, dtype=np.int64)
    filled = 0
    # Expected acceptance rate is 61445/65536 ~ 93.8%; 2*n chunks is plenty
    # in almost all cases.
    budget = 2 * n * 2
    stream = shake.digest(budget)
    pos = 0
    while filled < n:
        if pos + 2 > len(stream):
            budget *= 2
            stream = hashlib.shake_256(nonce + msg).digest(budget)
        t = (stream[pos] << 8) | stream[pos + 1]
        pos += 2
        if t < _ACCEPT_BOUND:
            out[filled] = t % Q
            filled += 1
    return out


def hash_to_point_batch(msgs, nonces, n: int) -> np.ndarray:
    """Batch hash-to-point -> (batch, n) int64 array.

    Uses the native C extension when available (see native/), else the
    pure-Python path above.
    """
    try:
        from ..native import native_hash_to_point_batch

        return native_hash_to_point_batch(msgs, nonces, n)
    except (ImportError, OSError):
        return np.stack([hash_to_point(m, nc, n) for m, nc in zip(msgs, nonces)])
