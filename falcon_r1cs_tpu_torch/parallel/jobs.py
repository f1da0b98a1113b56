"""Rank bodies: each drives one path of the parallel layer on host (numpy)
inputs inside a rank of a process group and returns host results, the
same on every rank.  `entry.dryrun_multichip` and the tests run them in
groups spawned by `launch.run_group` (whose ranks must find their body in
this package), a list of them in one group through `run_all`.

Every body takes the device type last ("cuda" or "cpu") and builds its
own mesh over the whole world.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..params import FALCON_512, get_params
from ..snark.gpu_msm import g1_msm_gpu_sharded
from ..utils.device import rank_device
from .distributed import global_mesh, host_local_batch, maybe_init_distributed
from .mesh import (
    _all_gather,
    gather_segments,
    make_mesh,
    place_batch,
    sharded_engine,
    sharded_engine_dual,
    sharded_engine_schoolbook,
)
from .ntt_sharded import exchange, ntt_sharded
from .pipeline_pp import dp_ntt, pp_ntt
from .sat_check import ResidueSystem

_ENGINES = {"ntt": sharded_engine, "dual": sharded_engine_dual,
           "schoolbook": sharded_engine_schoolbook}


def run_all(jobs):
    """Each (body, args) of `jobs` in turn; the list of their results."""
    return [body(*args) for body, args in jobs]


def _host(t):
    return t.cpu().numpy()


def _line_mesh(name: str, device):
    """A one-dim mesh named `name` over the whole world."""
    maybe_init_distributed(device)
    return init_device_mesh(torch.device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=(name,))


def rank_facts(device):
    """What a rank sees of its world: maybe_init_distributed's answer, the
    group's rank and world size, the RANK and WORLD_SIZE it was started
    with, global_mesh(2)'s shape and the rows of host_local_batch(., 512,
    8)."""
    rows = host_local_batch(np.random.default_rng(0), 512, 8)[0].shape[0]
    return (maybe_init_distributed(device), dist.get_rank(), dist.get_world_size(),
            os.environ.get("RANK"), os.environ.get("WORLD_SIZE"),
            tuple(global_mesh(2, device).shape), rows)


def ntt_job(n: int, x, device):
    """ntt_sharded of x (B, n) over a coeff mesh of the world; the blocks
    gathered in coordinate order."""
    mesh = _line_mesh("coeff", device)
    group = mesh.get_group("coeff")
    w = n // dist.get_world_size(group)
    r = dist.get_rank(group)
    local = torch.from_numpy(np.ascontiguousarray(x[:, r * w:(r + 1) * w]))
    out = ntt_sharded(mesh, get_params(n))(local.to(rank_device(device)))
    return _host(_all_gather(out, group, 1))


def engine_job(kind: str, n: int, batch_axis: int, arrays, device):
    """The sharded engine of `kind` ("ntt", "dual" or "schoolbook") on a
    (batch_axis, world / batch_axis) mesh over the host batch `arrays`:
    (the gathered segments, the partner exchanges of the call)."""
    mesh = make_mesh(None, batch_axis, device)
    engine = _ENGINES[kind](n, mesh)
    blocks = place_batch(mesh, *arrays)
    before = exchange.calls
    seg = engine(*blocks)
    calls = exchange.calls - before
    return {k: _host(v) for k, v in gather_segments(mesh, seg).items()}, calls


def sat_job(seed: int, bump_at: int, device):
    """check_device_sharded over a batch mesh of the world on the full
    assignment of a Falcon-512 verify-with-NTT instance made from `seed`,
    and on a copy with value `bump_at` plus one: the two verdicts."""
    from ..circuits import FalconNTTVerificationCircuit as circuit
    from ..falcon import make_instance
    from ..r1cs import ConstraintSystem, compile_circuit

    mesh = make_mesh(None, None, device)
    inst = make_instance(np.random.default_rng(seed), FALCON_512)
    compiled = compile_circuit(circuit, inst, cache=False)
    cs = ConstraintSystem()
    circuit.build_circuit(inst).generate_constraints(cs)
    good = cs.full_assignment()
    bad = list(good)
    bad[bump_at] += 1
    rs = ResidueSystem(compiled, rank_device(device))
    w_res = rs.witness_residues(np.asarray([good, bad], dtype=object))
    return rs.check_device_sharded(w_res, mesh, "batch").cpu().tolist()


def msm_job(points, scalars, window: int, device):
    """g1_msm_gpu_sharded over a batch mesh of the world."""
    return g1_msm_gpu_sharded(points, scalars, window, make_mesh(None, None, device))


def pp_job(n: int, microbatch: int, n_micro: int, x, device):
    """pp_ntt over a stage mesh of the world: (its output, its exchanges)."""
    mesh = _line_mesh("stage", device)
    run = pp_ntt(mesh, get_params(n), "stage", microbatch, n_micro)
    before = exchange.calls
    out = run(torch.from_numpy(x).to(rank_device(device)))
    return _host(out), exchange.calls - before


def dp_job(n: int, x, device):
    """dp_ntt over a stage mesh of the world, each rank on its share of the
    rows of x: (the rows gathered, the exchanges of the NTT)."""
    mesh = _line_mesh("stage", device)
    group = mesh.get_group("stage")
    rows = x.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    local = torch.from_numpy(np.ascontiguousarray(x[r * rows:(r + 1) * rows]))
    before = exchange.calls
    out = dp_ntt(mesh, get_params(n))(local.to(rank_device(device)))
    calls = exchange.calls - before
    return _host(_all_gather(out, group, 0)), calls
