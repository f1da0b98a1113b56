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
  for bulk benchmarks.  Real NTRU keygen + signing live in keygen.py /
  sign.py; `instance_from_signature` bridges real signatures into the
  circuit layer.
- `verify_batch`: batched verification on the device, hash-to-point on
  the host (the counterpart of the JAX package's `verify_batch`, whose
  device check is a jitted chain of jnp ops; here a chain of torch ops).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.modq import mul_mod_q, sub_mod_q
from ..params import FalconParams, Q
from ..utils.device import entry_device
from .hash_to_point import NONCE_LEN, hash_to_point, hash_to_point_batch
from .ntt import intt, intt_torch, ntt, ntt_torch
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


def verify_batch(
    h: np.ndarray,
    msgs: list[bytes],
    nonces: list[bytes],
    sig_signed: np.ndarray,
    params: FalconParams,
    device="cuda",
) -> np.ndarray:
    """Batched Falcon verification on `device`: hash-to-point on the host
    (native C when built), then one chain of torch ops over the whole batch
    (`_verify_cached`).

    h: (B, n) or (n,) public keys; sig_signed: (B, n) signed s2.  Returns a
    (B,) numpy bool array, as the JAX package's `verify_batch` does, with
    its verdicts: a coefficient of s2 is reduced mod q and re-signed around
    q/2 before it is squared (the clear `verify` squares it as given).
    """
    dev = entry_device(device)
    n = params.n
    sig_signed = np.atleast_2d(np.asarray(sig_signed, dtype=np.int64))
    B = sig_signed.shape[0]
    h2 = np.atleast_2d(np.asarray(h, dtype=np.int64))
    hm = hash_to_point_batch(msgs, nonces, n)
    check = _verify_cached(n, int(params.sig_l2_bound))
    ok = check(
        torch.from_numpy(sig_signed).to(dev),
        torch.from_numpy(h2).to(dev).expand(B, n),
        torch.from_numpy(hm).to(dev),
    )
    return ok.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _verify_cached(n: int, bound: int):
    """The device check of `verify_batch` for one (n, bound): (s2, h, hm)
    integer tensors of shape (B, n) on one device, s2 and h any integers
    (reduced mod q here), hm in [0, q) -> (B,) bool.  The NTT tables are
    cached per device (falcon/ntt.py).

    The JAX package splits the norm into 16-bit halves because the TPU has
    no int64; the squares sum here in int64, which is exact (2n squares
    below 2^26 each), and the test is the same `norm < bound`."""

    def check(s2, h, hm):
        s2 = (s2 % Q).to(torch.int32)
        h = (h % Q).to(torch.int32)
        prod = mul_mod_q(ntt_torch(s2, n), ntt_torch(h, n))
        v = sub_mod_q(hm.to(torch.int32), intt_torch(prod, n))
        v_signed = torch.where(v < _HALF, v, v - Q).to(torch.int64)
        s2_signed = torch.where(s2 < _HALF, s2, s2 - Q).to(torch.int64)
        norm = (v_signed * v_signed).sum(-1) + (s2_signed * s2_signed).sum(-1)
        return norm < bound

    return check


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
