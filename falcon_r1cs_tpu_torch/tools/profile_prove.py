"""Per-stage timing of one Falcon-512 Groth16 prove on the port, and where
each G1 MSM's time goes on the card.

The port of the JAX package's `tools/profile_prove.py`: the
verify-with-NTT circuit at Falcon-512, the instance from
`make_instance(np.random.default_rng(5), ...)`, its COO, the assignment
from the host trace (`cs.instance_values + cs.witness_values`) as (N, 4)
u64 limb rows, and the CRS loaded from `--crs` or the port's artifact
directory, else set up (and saved there with `--save-crs`).  One warm-up
`prove` (the native build and the point caches: with the G1 MSMs on the
card, K4 once a query), then the mean over `iters` of each stage of the
JAX tool: `witness_map`, the G1 MSMs of the a, b_g1, l and h queries,
the G2 MSM of the b_g2 query (host C), and the whole `prove`.

With `--g1-backend gpu` (the default) each G1 MSM runs through
`snark.gpu_msm.g1_msm_gpu` on the device and must equal the native C's
on the same inputs; `msm_split` gives its device recode (the scalar
upload included), device window sums (CUDA events) and host fold, its
recode, K5, K6 and merge-level launches, and the native C's time beside
it.  With `native` every G1 MSM is the host C's.

    python -m falcon_r1cs_tpu_torch.tools.profile_prove [iters]
        [--g1-backend gpu|native] [--device cuda] [--crs PATH] [--save-crs]

Prints each stage as it ends, then one JSON line with the stage
milliseconds, each G1 MSM's split and the proof.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..circuits import FalconNTTVerificationCircuit
from ..examples.pok_sig import synchronize
from ..falcon import make_instance
from ..ops.fq import mont_mul_cuda, point_add_aff_cuda, point_add_cuda
from ..ops.msm_bucket import bucket_level_cuda
from ..ops.msm_recode import signed_digits_cuda
from ..params import get_params
from ..r1cs import ConstraintSystem
from ..r1cs.coo import compile_circuit
from ..snark import gpu_msm, prove, verify
from ..snark.points import ints_to_limbs
from ..utils.device import DeviceUnavailableError, entry_device
from .msm_multi import _native
from .prove_large import G1_BACKENDS, Stages, proof_json, proving_key

CIRCUIT = FalconNTTVerificationCircuit
N = 512
INSTANCE_SEED = 5
# the kernels an MSM launches, by the names of their launch counts
MSM_KERNELS = {"signed_digits_kernel": signed_digits_cuda, "mont_mul_kernel": mont_mul_cuda,
               "point_add_kernel": point_add_cuda, "point_add_aff_kernel": point_add_aff_cuda,
               "bucket_level_kernel": bucket_level_cuda}


def trace_assignment(inst):
    """The host trace's full assignment of the verify-with-NTT circuit:
    (the public inputs, with the constant one first; the assignment as
    (N, 4) u64 limb rows)."""
    cs = ConstraintSystem(mode="prove")
    CIRCUIT.build_circuit(inst).generate_constraints(cs)
    z = [int(x) for x in cs.instance_values] + [int(x) for x in cs.witness_values]
    return z[:cs.num_instance_variables], ints_to_limbs(z, 4)


def _timed_ms(fn, dev: torch.device):
    """(fn(), milliseconds): CUDA events on a card, the host clock on the
    CPU."""
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def msm_split(points, scalars, device, iters: int = 1, groups=None, samples: int = 1) -> dict:
    """Where one warm `g1_msm_gpu` over `points` goes (their Montgomery
    form already cached on `device`), beside the native C's `g1_msm` on the
    same inputs, which the whole MSM and the split's own fold must equal.

    Returns {"native_ms", "gpu_ms": the whole MSM by the host clock, mean
    of `iters`; "launches": the kernels' launches of one whole MSM;
    "recode_ms": the signed-digit recode that `g1_msm_gpu` runs, on
    `device`, by the host clock to a synchronise (the scalars' host
    normalisation and upload included); "group": groups[0];
    "sums_ms": {G: `samples` device window sums at G windows a group,
    CUDA events (the host clock on the CPU), the groups in turns after one
    warm-up each}; "held_gib", "peak_gib": {G: the warm-up's peak device
    memory over the held_gib held before} (None on the CPU); "fold_ms":
    the host Horner fold of groups[0]'s warm-up, "sum": its affine point;
    "window_sums": G -> one run of the window sums}.  `groups` defaults
    to the device's own group (`gpu_msm._group_windows`)."""
    dev = torch.device(device)
    native = _native()
    t0 = time.perf_counter()
    for _ in range(iters):
        want = native.g1_msm(points, scalars)
    native_ms = (time.perf_counter() - t0) / iters * 1e3
    before = {k: w.launches for k, w in MSM_KERNELS.items()}
    t0 = time.perf_counter()
    for _ in range(iters):
        got = gpu_msm.g1_msm_gpu(points, scalars, device=dev)
    synchronize(dev)
    gpu_ms = (time.perf_counter() - t0) / iters * 1e3
    launches = {k: (w.launches - before[k]) // iters for k, w in MSM_KERNELS.items()}
    if got != want:
        raise RuntimeError(f"g1_msm_gpu over {len(points)} points != the native C")

    window = gpu_msm.WINDOW
    n_pad = max(8, 1 << (len(points) - 1).bit_length())
    nw = (255 + window - 1) // window
    synchronize(dev)
    t0 = time.perf_counter()
    digits, overflow = gpu_msm._point_digits(points, scalars, window, n_pad, dev)
    synchronize(dev)
    recode_ms = (time.perf_counter() - t0) * 1e3
    xm, ym = gpu_msm._points_mont(points, n_pad, dev)
    groups = tuple(groups) if groups else (gpu_msm._group_windows(n_pad, nw, device=dev),)

    def window_sums(G):
        return gpu_msm._window_sums(digits, xm, ym, window, G)

    cuda = dev.type == "cuda"
    synchronize(dev)
    held = torch.cuda.memory_allocated(dev) / 2**30 if cuda else None
    peak = {}
    for G in groups:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ws = window_sums(G)
        synchronize(dev)
        peak[G] = torch.cuda.max_memory_allocated(dev) / 2**30 - held if cuda else None
        if G == groups[0]:
            t0 = time.perf_counter()
            folded = gpu_msm._fold_windows_host(ws, nw, 1, window, overflow)[0]
            fold_ms = (time.perf_counter() - t0) * 1e3
            if folded != want:
                raise RuntimeError(f"the split's window sums over {len(points)} points "
                                   "!= the native C")
        del ws
    sums_ms = {G: [] for G in groups}
    for rep in range(samples):
        for G in groups if rep % 2 == 0 else groups[::-1]:
            sums_ms[G].append(_timed_ms(lambda: window_sums(G), dev)[1])
    return {"native_ms": native_ms, "gpu_ms": gpu_ms, "launches": launches,
            "recode_ms": recode_ms, "group": groups[0], "sums_ms": sums_ms,
            "held_gib": held, "peak_gib": peak, "fold_ms": fold_ms, "sum": folded,
            "window_sums": window_sums}


def run(iters: int = 3, g1_backend: str = "gpu", device="cuda", crs=None,
        save_crs: bool = False, toxic=None, r=None, s=None, pk=None, log=print) -> dict:
    """The JAX tool's stages of one Falcon-512 prove, each the mean of
    `iters` after one warm-up prove, with the G1 MSMs on `device`
    (g1_backend "gpu") or in the host C ("native").

    pk: a proving key of the circuit to use (else `prove_large`'s
    proving_key with crs, save_crs, toxic); r, s: the blinding of every
    prove (random if None).  Returns {"ms": {stage: mean ms}, "splits":
    {query: msm_split's dict} (gpu only), "seconds": the set-up stages,
    "proof": the last prove's, "pk", "compiled", "publics",
    "assignment"}; raises if an MSM differs from the native C's or the
    proof does not verify."""
    if g1_backend not in G1_BACKENDS:
        raise ValueError(f"g1_backend={g1_backend!r}: one of {G1_BACKENDS}")
    dev = entry_device(device)
    native = _native()
    timed = Stages(dev, log)
    inst = make_instance(np.random.default_rng(INSTANCE_SEED), get_params(N))
    compiled = timed("compile (direct COO)", compile_circuit, CIRCUIT, inst)
    publics, z = timed("trace (host)", trace_assignment, inst)
    if pk is None:
        pk = proving_key(compiled, CIRCUIT, N, timed, crs, save_crs, toxic)
    kw = dict(r=r, s=s, g1_backend=g1_backend, msm_device=dev)
    timed("warm-up prove", prove, pk, compiled, z, **kw)

    ms, splits = {}, {}

    def mean_ms(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        synchronize(dev)
        ms[label] = (time.perf_counter() - t0) / iters * 1e3
        log(f"{label:26s} {ms[label]:9.1f} ms")
        return out

    h, _ = mean_ms("witness_map", native.witness_map, compiled, z)
    ni = compiled.num_instance
    queries = (("a", "msm A (a_query)", pk.a_query, z),
               ("b_g1", "msm B1 (b_g1_query)", pk.b_g1_query, z),
               ("b_g2", "msm B2 (b_g2_query, G2)", pk.b_g2_query, z),
               ("l", "msm L (l_query)", pk.l_query, z[ni:]),
               ("h", "msm H (h_query)", pk.h_query, h))
    for name, label, pts, sc in queries:
        if name == "b_g2":
            mean_ms(label, native.g2_msm, pts, sc)
        elif g1_backend == "native":
            mean_ms(label, native.g1_msm, pts, sc)
        else:
            sp = splits[name] = msm_split(pts, sc, dev, iters, samples=iters)
            ms[label] = sp["gpu_ms"]
            log(f"{label:26s} {sp['gpu_ms']:9.1f} ms  (device; native C "
                f"{sp['native_ms']:.1f} ms, equal; device recode {sp['recode_ms']:.1f} ms, "
                f"device window sums {statistics.median(sp['sums_ms'][sp['group']]):.1f} ms "
                f"({sp['group']} windows a group), host fold {sp['fold_ms']:.1f} ms; "
                f"K5 {sp['launches']['point_add_kernel']}, "
                f"K6 {sp['launches']['point_add_aff_kernel']})")
    proof = mean_ms("prove (total)", prove, pk, compiled, z, **kw)
    if not verify(pk.vk, publics, proof):
        raise RuntimeError("the Falcon-512 proof does not verify")
    return {"ms": ms, "splits": splits, "seconds": timed.seconds, "proof": proof, "pk": pk,
            "compiled": compiled, "publics": publics, "assignment": z}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.profile_prove",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("iters", nargs="?", type=int, default=3)
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="gpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crs", default=None, help="a .pk.npz to load instead of a setup")
    ap.add_argument("--save-crs", action="store_true",
                    help="save a fresh setup's CRS in the artifact directory")
    args = ap.parse_args(argv)
    try:
        out = run(args.iters, args.g1_backend, args.device, args.crs, args.save_crs)
    except DeviceUnavailableError as e:
        print(f"profile_prove: {e}", file=sys.stderr)
        return 2
    splits = {name: {k: v for k, v in sp.items() if k not in ("window_sums", "sum")}
              for name, sp in out["splits"].items()}
    print(json.dumps({"g1_backend": args.g1_backend, "iters": args.iters, "ms": out["ms"],
                      "splits": splits, "seconds": out["seconds"],
                      "proof": proof_json(out["proof"])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
