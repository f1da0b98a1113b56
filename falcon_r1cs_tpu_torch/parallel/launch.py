"""Spawn a group of ranks on one host and return what rank 0 returned.

torch has no virtual devices: where the JAX package runs its sharded paths
on the virtual CPU devices of one process, the port runs one process per
rank.  `run_group(fn, world, device, *args)` spawns `world` processes
(the `spawn` start method: each imports the port afresh), makes each a
rank of one process group through `distributed.maybe_init_distributed`
(RANK, WORLD_SIZE and LOCAL_RANK set per child; NCCL on the cards
cuda:0 .. cuda:world-1, or gloo on the CPU) and calls fn(*args) in
every rank.

The group meets through a file store in a fresh temporary directory, not
a TCP port, so that groups started side by side never collide.  Every
wait is bounded: the rendezvous and each collective by `timeout_s`, and
the parent's wait for the results by the same; on expiry, or as soon as
one rank fails, the children are killed and the parent raises with the
failing rank's traceback.

`fn` is pickled by its import path, so it must live in this package: a
function of a test module would make every child import that module, and
with it the JAX package.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import entry_device
from .distributed import maybe_init_distributed


class GroupError(RuntimeError):
    """A rank of a spawned group failed, died or did not finish in time."""


def _rank_main(rank, world, device, store, timeout_s, fn, args, results):
    """The body of one spawned rank: join the group, run fn(*args), report
    (rank, ok, rank 0's result or the traceback)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        maybe_init_distributed(device, init_method=f"file://{store}", timeout_s=timeout_s)
        out = fn(*args)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_group(fn, world: int, device, *args, timeout_s: float = 300.0):
    """fn(*args) in each of `world` spawned ranks on `device` ("cuda": one
    card a rank, so world <= torch.cuda.device_count(); "cpu": gloo).
    Returns rank 0's return value; raises GroupError if a rank fails, dies
    or is still running after `timeout_s` seconds."""
    dev = entry_device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"{world} ranks need {world} cards; this host has {torch.cuda.device_count()}"
        )
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="falcon_group_") as tmp:
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world, dev.type, os.path.join(tmp, "store"), timeout_s, fn,
                      args, results),
                daemon=True,
            )
            for r in range(world)
        ]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, time.monotonic() + timeout_s)
        finally:
            # drained (or given up on) before any join
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def _collect(procs, results, deadline):
    """Rank 0's result, once every rank reported success."""
    done = {}
    while len(done) < len(procs):
        try:
            rank, ok, out = results.get(timeout=1.0)
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            if dead:
                _kill(procs)
                raise GroupError(f"rank(s) died without a result: {dead}") from None
            if time.monotonic() > deadline:
                _kill(procs)
                raise GroupError(
                    f"{len(procs) - len(done)} rank(s) still running at the time limit"
                ) from None
            continue
        if not ok:
            _kill(procs)
            raise GroupError(f"rank {rank} failed:\n{out}")
        done[rank] = out
    return done[0]


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
