"""The port's parallel layer on torch.distributed: the (batch, coeff) device
mesh, the sharded witness engines, the coefficient-sharded NTT, the
sharded CRT satisfiability check, the pipeline-parallel demonstrator, and
the spawn helper that runs a group of ranks on one host (launch.py).
The public names are the counterparts of `falcon_r1cs_tpu.parallel`'s."""

from .distributed import global_mesh, host_local_batch, maybe_init_distributed, scaling_sweep
from .launch import run_group
from .mesh import (
    gather_segments,
    make_mesh,
    place_batch,
    sharded_engine,
    sharded_engine_dual,
    sharded_engine_schoolbook,
)
from .ntt_sharded import ntt_sharded
from .pipeline_pp import dp_ntt, pp_ntt
from .sat_check import ResidueSystem, crt_primes

__all__ = [
    "ResidueSystem",
    "crt_primes",
    "dp_ntt",
    "gather_segments",
    "global_mesh",
    "host_local_batch",
    "make_mesh",
    "maybe_init_distributed",
    "ntt_sharded",
    "place_batch",
    "pp_ntt",
    "run_group",
    "scaling_sweep",
    "sharded_engine",
    "sharded_engine_dual",
    "sharded_engine_schoolbook",
]
