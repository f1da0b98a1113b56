"""The coefficient-sharded NTT, on torch.distributed point-to-point
exchanges: the sequence-parallel analog.

The counterpart of `falcon_r1cs_tpu/parallel/ntt_sharded.py`.  With the
coefficient axis sharded over D ranks of a group (shard width w = n/D),
Cooley-Tukey stage l pairs positions j and j + n/2^(l+1):

  * the first log2(D) stages pair across shards: each rank exchanges its
    whole block with its butterfly partner, the rank whose coordinate is
    r ^ (D >> (l+1)), through one batch_isend_irecv pair, then computes
    its half of the butterflies locally; within those stages a shard lies
    inside one twiddle group, so the twiddle is a per-shard scalar
    table[m + (r >> (log2(D) - l))];
  * the remaining log2(n) - log2(D) stages are local, with the twiddles
    offset by the shard.

`r` is the rank's coordinate on the sharded dim (its rank in that dim's
group), and the peer of a send is the global rank of the partner's
coordinate in that group.  Everything is plain torch on the rank's
device: the JAX package's coefficient-sharded path runs no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.limbs import NUM_LIMBS, divmod_q, from_small, int_to_limbs, normalize
from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q
from ..ops.ntt_limb import SEMI_LIMBS, _semi_norm
from ..params import FalconParams


def exchange(x, group, send_to: int | None = None, recv_from: int | None = None):
    """Send x to the rank of `group` at coordinate `send_to` and receive a
    tensor like x from the one at `recv_from`, as one batch_isend_irecv;
    either may be None.  Returns the received tensor (None if nothing was
    received).  `exchange.calls` counts the calls."""
    ops, got = [], None
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        got = torch.empty_like(x)
        ops.append(dist.P2POp(dist.irecv, got,
                              dist.get_global_rank(group, recv_from), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    exchange.calls += 1
    return got


exchange.calls = 0


def _log2_shards(params: FalconParams, D: int) -> int:
    """log2(D), checking that D is a power of two dividing n."""
    if D & (D - 1) or params.n % D:
        raise ValueError(f"coeff dim {D} must be a power of two dividing n={params.n}")
    return D.bit_length() - 1


def ntt_sharded(mesh, params: FalconParams, axis: str = "coeff"):
    """(B, w) -> (B, w): the forward NTT of this rank's coefficient block,
    the coefficient axis sharded over the `axis` dim of `mesh`.  Inputs in
    [0, q); the blocks in coordinate order are the clear NTT."""
    n, log_n = params.n, params.log_n
    group = mesh.get_group(axis)
    D = dist.get_world_size(group)
    log_d = _log2_shards(params, D)
    w = n // D
    r = dist.get_rank(group)
    table = torch.tensor(params.ntt_table, dtype=torch.int32)

    def run(x):
        x = x.to(torch.int32)
        tbl = table.to(x.device)
        # cross-shard stages: the lo rank forms u + v, the hi rank u - v
        for l in range(log_d):
            m = 1 << l
            dist_ = D >> (l + 1)
            partner = r ^ dist_
            other = exchange(x, group, partner, partner)
            s = tbl[m + (r >> (log_d - l))]
            if r & dist_ == 0:
                x = add_mod_q(x, mul_mod_q(other, s))
            else:
                x = sub_mod_q(other, mul_mod_q(x, s))
        # local stages, twiddles offset by the shard
        B = x.shape[0]
        for l in range(log_d, log_n):
            m = 1 << l
            half = n >> (l + 1)
            mloc = m // D
            xm = x.reshape(B, mloc, 2, half)
            s = tbl[m + r * mloc:m + (r + 1) * mloc].reshape(1, mloc, 1)
            u = xm[:, :, 0, :]
            v = mul_mod_q(xm[:, :, 1, :], s)
            x = torch.stack([add_mod_q(u, v), sub_mod_q(u, v)], dim=2)
        return x.reshape(B, w)

    return run


def ntt_with_hints_local(x, group, params: FalconParams, D: int):
    """The bound-tracked NTT with quotient hints of this rank's coefficient
    block, the coefficient axis sharded over the D ranks of `group`: the
    sharded twin of ops/ntt_limb.ntt_with_hints.

    The first log2(D) stages exchange whole limb blocks with the partner
    (per-shard scalar twiddles); the rest are local.  The limb arithmetic
    (semi-normalised carries, the bound constants, the final normalise and
    divmod) is ntt_limb's, so (t, b) are bit-equal to the single-device
    engine's.  x: (B, w) int32, w = n / D.  Returns (t (11, B, w),
    b (B, w))."""
    n, log_n = params.n, params.log_n
    if D != dist.get_world_size(group):
        raise ValueError(f"D={D} but the group has {dist.get_world_size(group)} ranks")
    log_d = _log2_shards(params, D)
    w = n // D
    L = SEMI_LIMBS
    r = dist.get_rank(group)
    dev = x.device
    table = torch.tensor(params.ntt_table, dtype=torch.int32, device=dev)
    bounds = torch.from_numpy(
        np.stack([int_to_limbs(c, L) for c in params.const_q_powers])
    ).to(dev)

    B = x.shape[0]
    out = from_small(x.to(torch.int32), L)  # (L, B, w)
    for l in range(log_d):
        m = 1 << l
        dist_ = D >> (l + 1)
        partner = r ^ dist_
        other = exchange(out, group, partner, partner)
        s = table[m + (r >> (log_d - l))]
        if r & dist_ == 0:
            out = _semi_norm(out + _semi_norm(other * s))           # u + v
        else:
            c = bounds[l + 1].reshape(L, 1, 1)
            out = _semi_norm(other + (c - _semi_norm(out * s)))     # u + neg_v

    for l in range(log_d, log_n):
        m = 1 << l
        half = n >> (l + 1)
        mloc = m // D
        o = out.reshape(L, B, mloc, 2, half)
        u = o[:, :, :, 0, :]
        hi = o[:, :, :, 1, :]
        s = table[m + r * mloc:m + (r + 1) * mloc].reshape(1, 1, mloc, 1)
        v = _semi_norm(hi * s)
        c = bounds[l + 1].reshape(L, 1, 1, 1)
        new0 = _semi_norm(u + v)
        new1 = _semi_norm(u + (c - v))
        out = torch.stack([new0, new1], dim=3).reshape(L, B, w)

    t_limbs, b = divmod_q(normalize(out))
    return t_limbs[:NUM_LIMBS], b
