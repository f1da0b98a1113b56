"""Verification-instance generation and clear-side signature verification.

The reference obtains (pk, msg, sig) test tuples from falcon-rust's
keygen/sign (FFI into the Falcon C code, e.g.
`falcon-r1cs/src/circuits/falcon_ntt.rs:133-141`).  That
native layer exists only to *produce test vectors* -- the circuits themselves
prove the verification equation

    v = hm - sig * pk  (mod q, mod x^n + 1),   ||(sig | v)||_2^2 < beta^2

This module provides:

- `verify`: the clear verification check (the analog of falcon-rust's
  `verify_rust`, `falcon-r1cs/src/circuits/falcon_ntt.rs:141`).
- `make_instance` / `make_instance_batch`: trapdoor-free generation of valid
  instances: sample small (sig, v) Gaussian-like vectors, derive
  h := (hm - v) * sig^{-1} in the NTT domain.  The resulting tuple satisfies
  the exact verification statement, so the circuits cannot distinguish it
  from a real Falcon signature; no secret key is needed -- the fast path
  for bulk benchmarks.  Real NTRU keygen + signing live in the JAX
  package's keygen.py / sign.py (not part of the port);
  `instance_from_signature` bridges real signatures into the circuit layer.

The host half of `falcon_r1cs_tpu/falcon/instances.py`; its batched device
verify (`verify_batch`) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import FalconParams, Q
from .hash_to_point import NONCE_LEN, hash_to_point
from .ntt import intt, ntt
from .poly import _HALF

# Falcon's signing sigma is ~165.7 for n=512 / ~168.4 for n=1024; sampling at
# sigma=160 keeps ||(sig|v)||^2 comfortably below beta^2 with overwhelming
# probability while matching realistic coefficient magnitudes.
_SIGMA = 160.0


@dataclass
class VerificationInstance:
    """One (pk, msg, sig) verification instance plus derived clear values."""

    params: FalconParams
    h: np.ndarray            # public key poly, [0, q), shape (n,)
    msg: bytes
    nonce: bytes             # 40 bytes
    sig_signed: np.ndarray   # signed signature coeffs, shape (n,)
    hm: np.ndarray           # hash_to_point(msg, nonce), [0, q)
    v_signed: np.ndarray     # v = hm - sig*h, centered signed representative

    @property
    def sig_lifted(self) -> np.ndarray:
        """Signature coefficients lifted to [0, q) (as `Polynomial::from(&sig)`
        yields, `falcon-r1cs/src/circuits/falcon_ntt.rs:27`)."""
        return self.sig_signed % Q

    @property
    def v_lifted(self) -> np.ndarray:
        return self.v_signed % Q

    def l2_norm_sq(self) -> int:
        return int(
            np.sum(self.sig_signed.astype(np.int64) ** 2)
            + np.sum(self.v_signed.astype(np.int64) ** 2)
        )


def verify(
    h: np.ndarray, msg: bytes, nonce: bytes, sig_signed: np.ndarray,
    params: FalconParams,
) -> bool:
    """Clear Falcon verification: recompute v and check the norm bound."""
    hm = hash_to_point(msg, nonce, params.n)
    v = (hm - intt(ntt(sig_signed % Q) * ntt(h) % Q)) % Q
    v_signed = np.where(v < _HALF, v, v - Q)
    norm = int(np.sum(sig_signed.astype(np.int64) ** 2)) + int(
        np.sum(v_signed**2)
    )
    return norm < params.sig_l2_bound


def _sample_small(rng: np.random.Generator, n: int) -> np.ndarray:
    """Discrete-Gaussian-like small vector (rounded normal, sigma ~ Falcon's)."""
    return np.rint(rng.normal(0.0, _SIGMA, size=n)).astype(np.int64)


def make_instance(
    rng: np.random.Generator,
    params: FalconParams,
    msg: bytes = b"testing message",
) -> VerificationInstance:
    """Build a valid verification instance without a secret key.

    Choose small sig and v; set h := (hm - v) * sig^{-1} mod (q, x^n+1) in
    the NTT domain (resampling sig until it is NTT-invertible).  Then
    v = hm - sig*h holds exactly and the norm bound is met by construction.
    """
    n = params.n
    nonce = rng.bytes(NONCE_LEN)
    hm = hash_to_point(msg, nonce, n)
    while True:
        sig = _sample_small(rng, n)
        sig_ntt = ntt(sig % Q)
        if np.all(sig_ntt != 0):
            break
    while True:
        v = _sample_small(rng, n)
        norm = int(np.sum(sig * sig)) + int(np.sum(v * v))
        if norm < params.sig_l2_bound:
            break
    sig_ntt_inv = np.array(
        [pow(int(c), Q - 2, Q) for c in sig_ntt], dtype=np.int64
    )
    h_ntt = (hm % Q - v % Q) % Q
    h_ntt = ntt(np.asarray(h_ntt))  # hm - v in NTT domain
    h_ntt = h_ntt * sig_ntt_inv % Q
    h = intt(h_ntt)
    inst = VerificationInstance(
        params=params,
        h=h,
        msg=msg,
        nonce=nonce,
        sig_signed=sig,
        hm=hm,
        v_signed=v,
    )
    # belt and braces: the instance must verify in the clear
    assert verify(h, msg, nonce, sig, params)
    return inst


def instance_from_signature(
    h: np.ndarray,
    msg: bytes,
    nonce: bytes,
    sig_signed: np.ndarray,
    params: FalconParams,
) -> VerificationInstance:
    """Build a VerificationInstance from a REAL (pk, msg, sig) triple (e.g.
    produced by falcon.sign.KeyPair), mirroring the reference's circuit
    test setup (`falcon-r1cs/src/circuits/falcon_ntt.rs:133-150`)."""
    hm = hash_to_point(msg, nonce, params.n)
    v = (hm - intt(ntt(sig_signed % Q) * ntt(h) % Q)) % Q
    v_signed = np.where(v < _HALF, v, v - Q)
    inst = VerificationInstance(
        params=params,
        h=np.asarray(h) % Q,
        msg=msg,
        nonce=nonce,
        sig_signed=np.asarray(sig_signed),
        hm=hm,
        v_signed=v_signed,
    )
    assert verify(h, msg, nonce, sig_signed, params)
    return inst


def make_instance_batch(
    rng: np.random.Generator,
    params: FalconParams,
    batch: int,
    msg: bytes = b"testing message",
) -> list[VerificationInstance]:
    return [make_instance(rng, params, msg) for _ in range(batch)]
