"""Pipeline parallelism (`parallel/pipeline_pp.py`) against data
parallelism on the same ranks and the same total work.

The port of the JAX package's `tools/pp_vs_dp.py`: S ranks spawned by
`parallel.launch.run_group` on a one-dim "stage" mesh (NCCL, one card a
rank, on "cuda", the default; gloo on the host CPU with `--device cpu`),
one input for both, `np.random.default_rng(0)` integers in [0, q) of
shape (T mb, n).  PP runs `pp_ntt` over all of it (the GPipe conveyor of
T microbatches of mb rows through S stage groups); DP runs `dp_ntt` on
each rank's T mb / S rows, as the JAX `dp_ntt` shards them.  The outputs
must be equal bit for bit (DP's rows gathered, before the timing).  Rank 0
times each strategy between barriers, the device synchronised: the best
of 5, as the JAX tool reports, and the median beside it.  Each rank runs
torch on cores / S threads.  Printed: the JAX tool's lines (the analytic
bubble (S - 1) / (T + S - 1) and the conveyor's (T + S - 2) mb n 4
bytes, plus the final broadcast of the output), then one JSON line.

    python -m falcon_r1cs_tpu_torch.tools.pp_vs_dp [S] [n] [microbatch] [n_micro]
        [--device cuda|cpu]

On "cuda" S ranks need S cards: with fewer, `run_group` raises its
ValueError and `main` exits 2 with its message; nothing moves to gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..examples.pok_sig import synchronize
from ..params import get_params
from ..parallel.launch import run_group
from ..parallel.mesh import _all_gather
from ..parallel.pipeline_pp import dp_ntt, pp_ntt
from ..utils.device import DeviceUnavailableError, rank_device

REPS = 5
SEED = 0


def inputs(n: int, mb: int, T: int) -> np.ndarray:
    """The one input of both strategies: (T mb, n) int32 in [0, q)."""
    return np.random.default_rng(SEED).integers(
        0, get_params(n).q, size=(T * mb, n)).astype(np.int32)


def _rank(n: int, mb: int, T: int, x: np.ndarray, device: str) -> dict:
    """One rank: PP over the whole input and DP over this rank's rows,
    checked equal, then timed in turns; rank 0's dict holds the seconds
    of each run, the threads a rank and PP's output."""
    S = dist.get_world_size()
    threads = max(1, len(os.sched_getaffinity(0)) // S)
    torch.set_num_threads(threads)
    mesh = init_device_mesh(torch.device(device).type, (S,), mesh_dim_names=("stage",))
    group = mesh.get_group("stage")
    r = dist.get_rank(group)
    dev = rank_device(device)
    params = get_params(n)
    whole = torch.from_numpy(x).to(dev)
    rows = x.shape[0] // S
    local = whole[r * rows:(r + 1) * rows].contiguous()
    pp = pp_ntt(mesh, params, "stage", mb, T)
    dp = dp_ntt(mesh, params, "stage")
    out_pp = pp(whole)
    out_dp = _all_gather(dp(local), group, 0)
    if not torch.equal(out_pp, out_dp):
        raise RuntimeError(f"rank {r}: PP's output != DP's")

    def seconds(fn, arg):
        dist.barrier(group)
        synchronize(dev)
        t0 = time.perf_counter()
        fn(arg)
        synchronize(dev)
        dist.barrier(group)
        return time.perf_counter() - t0

    pp_s, dp_s = [], []
    for _ in range(REPS):
        pp_s.append(seconds(pp, whole))
        dp_s.append(seconds(dp, local))
    return {"pp_s": pp_s, "dp_s": dp_s, "threads": threads, "out": out_pp.cpu().numpy()}


def run(S: int = 8, n: int = 512, mb: int = 32, T: int = 64, device="cuda", log=print) -> dict:
    """PP against DP over S ranks on `device`.  Returns {"S", "n", "mb",
    "T", "device", "threads" (a rank), "pp_ms", "dp_ms" (best of 5),
    "pp_median_ms", "dp_median_ms", "ratio" (best PP / best DP),
    "bubble", "conveyor_bytes", "broadcast_bytes", "out" (PP's output,
    equal to DP's)}.  Raises DeviceUnavailableError without a card on
    "cuda", and ValueError with fewer cards than S or a batch that S
    does not divide."""
    if T * mb % S:
        raise ValueError(f"T mb = {T * mb} rows do not split over {S} ranks")
    res = run_group(_rank, S, device, n, mb, T, inputs(n, mb, T), torch.device(device).type)
    pp_s, dp_s = min(res["pp_s"]), min(res["dp_s"])
    out = {"S": S, "n": n, "mb": mb, "T": T, "device": str(device), "threads": res["threads"],
           "pp_ms": pp_s * 1e3, "dp_ms": dp_s * 1e3,
           "pp_median_ms": statistics.median(res["pp_s"]) * 1e3,
           "dp_median_ms": statistics.median(res["dp_s"]) * 1e3, "ratio": pp_s / dp_s,
           # the GPipe schedule's idle share: S - 1 fill and drain steps of
           # T + S - 1; the JAX tool's count of the bytes PP hands between
           # ranks and DP does not: one (mb, n) int32 block a conveyor step
           "bubble": (S - 1) / (T + S - 1), "conveyor_bytes": (T + S - 2) * mb * n * 4,
           "broadcast_bytes": T * mb * n * 4, "out": res["out"]}
    where = "gloo on the host CPU" if out["device"] == "cpu" else "NCCL, one card a rank"
    log(f"devices={S} n={n} batch={T * mb} (T={T} x mb={mb}); {where}, "
        f"{out['threads']} torch thread(s) a rank")
    log(f"DP:  {out['dp_ms']:8.2f} ms   (0 inter-device bytes; median of {REPS} "
        f"{out['dp_median_ms']:.2f} ms)")
    log(f"PP:  {out['pp_ms']:8.2f} ms   ({out['ratio']:.2f}x DP; analytic bubble "
        f"{out['bubble']:.1%}; conveyor traffic {out['conveyor_bytes'] / 1e6:.1f} MB "
        f"+ full-output broadcast {out['broadcast_bytes'] / 1e6:.1f} MB; median of {REPS} "
        f"{out['pp_median_ms']:.2f} ms)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.pp_vs_dp",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("S", nargs="?", type=int, default=8)
    ap.add_argument("n", nargs="?", type=int, choices=(512, 1024), default=512)
    ap.add_argument("microbatch", nargs="?", type=int, default=32)
    ap.add_argument("n_micro", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        out = run(args.S, args.n, args.microbatch, args.n_micro, args.device)
    except (DeviceUnavailableError, ValueError) as e:
        print(f"pp_vs_dp: {e}", file=sys.stderr)
        return 2
    print(json.dumps({k: v for k, v in out.items() if k != "out"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
