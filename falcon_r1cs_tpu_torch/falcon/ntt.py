"""Clear-side NTT over Z_q: numpy on the host, torch on int32 tensors.

The numpy `ntt`, `intt` and `negacyclic_mul` are copies of the JAX
package's `falcon_r1cs_tpu/falcon/ntt.py`; `ntt_torch` and `intt_torch`
are the device half (`ntt_jax`, `intt_jax` there).

The torch passes are plain torch, as the JAX package leaves these to XLA.
Every butterfly reduces with the exact division-free ops of ops/modq.py, so
each output is the canonical residue in [0, q) and equals the JAX and numpy
NTTs bit for bit, whatever the order of the passes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q
from ..params import Q, get_params

__all__ = ["intt", "intt_torch", "negacyclic_mul", "ntt", "ntt_torch"]


def ntt(coeffs: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT of int array(s) with trailing axis n. mod q.

    Accepts shape (..., n).  Stage-wise Cooley-Tukey: at stage l the array is
    viewed as (..., 2^l, 2, half) and each pair of halves is combined with the
    per-group twiddle table[2^l + i] -- the same access pattern as
    `falcon-r1cs/src/gadgets/poly.rs:122`.
    """
    x = np.asarray(coeffs, dtype=np.int64) % Q
    n = x.shape[-1]
    p = get_params(n)
    table = np.asarray(p.ntt_table, dtype=np.int64)
    batch = x.shape[:-1]
    for l in range(p.log_n):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(*(1,) * len(batch), m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :] * s % Q
        x = np.stack([(u + v) % Q, (u - v) % Q], axis=-2)
    return x.reshape(*batch, n).astype(np.int64)


def intt(coeffs: np.ndarray) -> np.ndarray:
    """Inverse negacyclic NTT (Gentleman-Sande), mod q. Shape (..., n).

    Clear-side only: the reference circuits contain no inverse NTT.  Needed
    by the instance generator and verifier.
    """
    x = np.asarray(coeffs, dtype=np.int64) % Q
    n = x.shape[-1]
    p = get_params(n)
    table = np.asarray(p.inv_ntt_table, dtype=np.int64)
    batch = x.shape[:-1]
    for l in range(p.log_n - 1, -1, -1):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(*(1,) * len(batch), m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = np.stack([(u + v) % Q, (u - v) * s % Q], axis=-2)
    x = x.reshape(*batch, n)
    n_inv = pow(n, Q - 2, Q)
    return x * n_inv % Q


def negacyclic_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """c = a * b mod (x^n + 1, q) via NTT. Shapes broadcast over (..., n)."""
    return intt(ntt(a) * ntt(b) % Q)


@functools.lru_cache(maxsize=None)
def _table(n: int, inverse: bool, device: torch.device):
    p = get_params(n)
    table = p.inv_ntt_table if inverse else p.ntt_table
    return torch.tensor(table, dtype=torch.int32, device=device)


def ntt_torch(coeffs, n: int):
    """Batched forward negacyclic NTT, (..., n) -> (..., n) int32.

    Inputs must already be in [0, q) (any integer dtype).  Stage l views the
    row as (2^l, 2, half) and combines each pair of halves with the group
    twiddle table[2^l + i]."""
    p = get_params(n)
    table = _table(n, False, coeffs.device)
    x = coeffs.to(torch.int32)
    batch = tuple(x.shape[:-1])
    for l in range(p.log_n):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(m, 1)
        u = x[..., 0, :]
        v = mul_mod_q(x[..., 1, :], s)
        x = torch.stack([add_mod_q(u, v), sub_mod_q(u, v)], dim=-2)
    return x.reshape(*batch, n)


def intt_torch(coeffs, n: int):
    """Batched inverse negacyclic NTT (Gentleman-Sande), (..., n) int32.
    Inputs must already be in [0, q)."""
    p = get_params(n)
    table = _table(n, True, coeffs.device)
    x = coeffs.to(torch.int32)
    batch = tuple(x.shape[:-1])
    for l in range(p.log_n - 1, -1, -1):
        m = 1 << l
        half = n >> (l + 1)
        x = x.reshape(*batch, m, 2, half)
        s = table[m : 2 * m].reshape(m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        x = torch.stack([add_mod_q(u, v), mul_mod_q(sub_mod_q(u, v), s)], dim=-2)
    x = x.reshape(*batch, n)
    return mul_mod_q(x, pow(n, Q - 2, Q))
