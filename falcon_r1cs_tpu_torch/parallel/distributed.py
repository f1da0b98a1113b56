"""The process group, the global mesh, each rank's share of a batch, and the
data-parallel scaling sweep, on torch.distributed.

The counterpart of `falcon_r1cs_tpu/parallel/distributed.py`.  Each rank
is one process with one device: `cuda:<LOCAL_RANK>` over NCCL, or the CPU
over gloo when the caller asks for it.  A multi-card host launches the
ranks with torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR/MASTER_PORT; `parallel/launch.run_group` spawns them on one
host with a file store instead.  Without that environment the process is
a world of one.

`make_global_arrays` has no counterpart object: in eager torch a rank
holds its own block of a batch and nothing assembles a global tensor.
`mesh.place_batch` cuts that block from a host batch, and
`mesh.gather_segments` assembles the global result where a check needs it.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..params import Q
from ..utils.device import entry_device, rank_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def maybe_init_distributed(device="cuda", init_method: str | None = None,
                           timeout_s: float | None = None) -> bool:
    """Initialise the default process group, once, for `device`: NCCL for
    "cuda", gloo for "cpu".  With RANK and WORLD_SIZE in the environment
    (torchrun's launch) the group spans that world, rendezvousing through
    `init_method` (default "env://": MASTER_ADDR and MASTER_PORT);
    otherwise it is a world of one.  Returns whether the world has more
    than one rank.

    The group is settled before any device is touched: only then is the
    rank's card (LOCAL_RANK, default 0) made the current device.  A group
    already initialised for the other backend raises; nothing moves to
    gloo or to the CPU on its own."""
    dev = entry_device(device)
    backend = _BACKEND[dev.type]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()}, device={str(device)!r} "
                f"needs {backend}"
            )
        return dist.get_world_size() > 1
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
            **kwargs,
        )
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **kwargs)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return dist.get_world_size() > 1


def global_mesh(batch_axis: int | None = None, device="cuda"):
    """(batch, coeff) mesh over every rank of the world."""
    from .mesh import make_mesh

    maybe_init_distributed(device)
    return make_mesh(None, batch_axis, device)


def host_local_batch(rng: np.random.Generator, n: int, global_batch: int):
    """This rank's rows of a batch-sharded synthetic input set: each rank
    draws only its own global_batch / world rows from `rng` (per-rank
    input I/O), as numpy (sig, pk_ntt, hm_ntt) uniform in [0, q)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_rank = global_batch // world
    sig = rng.integers(0, Q, size=(per_rank, n), dtype=np.int32)
    pk = rng.integers(0, Q, size=(per_rank, n), dtype=np.int32)
    hm = rng.integers(0, Q, size=(per_rank, n), dtype=np.int32)
    return sig, pk, hm


@dataclass
class ScalingPoint:
    devices: int
    witnesses_per_sec: float
    efficiency: float  # vs linear scaling from the smallest point


def scaling_sweep(n: int = 1024, batch_per_device: int = 256, device="cuda"):
    """Witnesses/s of the data-parallel engine on 1, 2, 4, ... ranks (every
    power of two up to the world), and the efficiency against linear
    scaling from the smallest point.  Every rank calls it.

    At each point the first d ranks run `sharded_engine` on a (d, 1) mesh,
    batch_per_device rows each, after a barrier; the rest wait.  A rank's
    time per call is the iteration-count slope of `utils.profiling
    .throughput` (CUDA events on the card, wall clock on the CPU); the rate
    is the global batch over the slowest rank's time.  On one card it is
    one point."""
    from ..utils.profiling import throughput
    from .mesh import make_mesh, place_batch, sharded_engine

    maybe_init_distributed(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(0)
    points: list[ScalingPoint] = []
    base_rate = None
    d = 1
    while d <= world:
        mesh = make_mesh(d, d, device)
        batch = batch_per_device * d
        sig, pk, hm = (rng.integers(0, Q, size=(batch, n), dtype=np.int32)
                       for _ in range(3))
        dist.barrier()
        seconds = 0.0
        if rank < d:
            args = place_batch(mesh, sig, pk, hm)
            rate, _ = throughput(sharded_engine(n, mesh), args, batch_per_device)
            seconds = batch_per_device / rate
        slowest = torch.tensor([seconds], dtype=torch.float64,
                               device=rank_device(device))
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        rate = batch / float(slowest.item())
        if base_rate is None:
            base_rate = rate / d
        points.append(ScalingPoint(d, rate, rate / (base_rate * d)))
        d *= 2
    return points
