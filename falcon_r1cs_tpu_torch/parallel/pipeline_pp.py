"""Pipeline parallelism (PP) over the NTT's stage axis: a demonstrator,
with the data-parallel comparator on the same ranks.

The counterpart of `falcon_r1cs_tpu/parallel/pipeline_pp.py`.  GPipe
schedule on a `stage` dim of S ranks: the log2(n) butterfly stages of the
forward NTT split into S contiguous groups, front-loaded, one a rank; T
microbatches stream through.  At step t (0 <= t < T + S - 1) each rank
first hands its previous output to rank s + 1 and takes rank s - 1's with
one exchange (`ntt_sharded.exchange`), then applies its stage group:
rank 0 to microbatch t, rank s to microbatch t - s, valid while
0 <= t - s < T -- the conveyor with an (S - 1)-step fill and drain.  The
last rank keeps the finished microbatches and broadcasts them at the end
(the JAX version's psum).

The JAX package measured PP 7.7x slower than DP on the TPU: DP moves no
bytes between devices, PP moves every activation at every stage boundary.
Here PP is ported and bit-exact; its measurement against DP needs a host
with two or more cards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.modq import add_mod_q, mul_mod_q, sub_mod_q
from ..params import FalconParams
from .ntt_sharded import exchange


def _stage_groups(log_n: int, n_stages: int) -> list[tuple[int, int]]:
    """Split butterfly stages 0..log_n-1 into n_stages contiguous
    [start, stop) groups, sizes as equal as possible (front-loaded)."""
    base, extra = divmod(log_n, n_stages)
    groups, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        groups.append((start, start + size))
        start += size
    return groups


def _apply_stages(x, table, n: int, l0: int, l1: int):
    """Butterfly stages [l0, l1) of the iterative forward NTT on a full
    (mb, n) block."""
    mb = x.shape[0]
    for l in range(l0, l1):
        m = 1 << l
        half = n >> (l + 1)
        xm = x.reshape(mb, m, 2, half)
        s = table[m:2 * m].reshape(1, m, 1)
        u = xm[:, :, 0, :]
        v = mul_mod_q(xm[:, :, 1, :], s)
        x = torch.stack([add_mod_q(u, v), sub_mod_q(u, v)], dim=2).reshape(mb, n)
    return x


def pp_ntt(mesh, params: FalconParams, axis: str = "stage",
           microbatch: int = 8, n_micro: int = 8):
    """(T*mb, n) -> (T*mb, n): the forward NTT through the S-rank pipeline
    above.  Every rank of the `axis` dim passes the same input (the feed,
    read by rank 0) and gets the whole output.  Inputs in [0, q); outputs
    bit-equal to the single-device NTT."""
    n, log_n = params.n, params.log_n
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    if S < 2:
        raise ValueError("pipeline needs >= 2 stage ranks")
    s = dist.get_rank(group)
    l0, l1 = _stage_groups(log_n, S)[s]
    T, mb = n_micro, microbatch
    send_to = s + 1 if s < S - 1 else None
    recv_from = s - 1 if s > 0 else None

    def run(x):
        if x.shape[0] != T * mb:
            raise ValueError(f"batch {x.shape[0]} != n_micro*microbatch {T * mb}")
        feed = x.to(torch.int32).reshape(T, mb, n)
        table = torch.tensor(params.ntt_table, dtype=torch.int32, device=x.device)
        state = torch.zeros((mb, n), dtype=torch.int32, device=x.device)
        outbuf = torch.zeros((T, mb, n), dtype=torch.int32, device=x.device)
        for t in range(T + S - 1):
            recv = exchange(state, group, send_to, recv_from)
            state = _apply_stages(feed[min(t, T - 1)] if s == 0 else recv,
                                  table, n, l0, l1)
            if s == S - 1 and t >= S - 1:
                outbuf[t - (S - 1)] = state
        dist.broadcast(outbuf, dist.get_global_rank(group, S - 1), group=group)
        return outbuf.reshape(T * mb, n)

    return run


def dp_ntt(mesh, params: FalconParams, axis: str = "stage"):
    """The DP comparator on the same dim: (rows, n) -> (rows, n), every
    stage of the NTT on this rank's own rows, no exchange at all.  This is
    what the production engines do; pp_ntt exists to measure why."""
    del mesh, axis  # the comparator's whole point: it needs no peer
    n, log_n = params.n, params.log_n

    def run(x):
        table = torch.tensor(params.ntt_table, dtype=torch.int32, device=x.device)
        return _apply_stages(x.to(torch.int32), table, n, 0, log_n)

    return run
