"""Clear-side NTT over Z_q on int32 tensors: the device half of
`falcon_r1cs_tpu/falcon/ntt.py` (`ntt_jax`, `intt_jax`).

Plain torch, as the JAX package leaves these to XLA.  Every butterfly
reduces with the exact division-free ops of ops/modq.py, so each output is
the canonical residue in [0, q) and equals the JAX and numpy NTTs bit for
bit, whatever the order of the passes.  The numpy `ntt`/`intt` are the JAX
package's own and are re-exported here.
"""

from __future__ import annotations

import functools

import torch

from falcon_r1cs_tpu.falcon.ntt import intt, ntt
from falcon_r1cs_tpu.params import Q, get_params

from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q

__all__ = ["intt", "intt_torch", "ntt", "ntt_torch"]


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
