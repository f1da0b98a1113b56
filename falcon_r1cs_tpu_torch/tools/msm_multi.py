"""The K-fold G1 MSM on the device at the Groth16 h query's shape, and the
half-digit scalars of the signed recode at scale.

The port of the JAX package's `tools/bench_tpu_msm_multi.py`:
`snark.gpu_msm.g1_msm_gpu_multi` over an h query's points with K
full-width random scalar vectors, its milliseconds a MSM beside the
native C's `g1_msm_multi` on the same inputs, which must give equal
points.  The default shape is the Falcon-1024 verify-with-NTT circuit's
h query (2^18 - 1 points, n_pad 2^18); `--n 512` gives the JAX tool's
2^17.  The points come from `--crs` (that circuit's .pk.npz) or are made
directly, [tau^i Z(tau) / delta]_1 by the native fixed-base, as the
setup makes them.

`half_digit_check` holds `g1_msm_gpu` and `g1_msm_gpu_multi` against the
native C and the group law on points tiled from a few base points, with
scalars whose signed-digit recode hits the digit +half = 2^(w-1) exactly
(the recode fault the reference found only at 2^20 points and more).

    python -m falcon_r1cs_tpu_torch.tools.msm_multi [--n 1024] [--k 1 2 4 8]
        [--iters 2] [--device cuda] [--crs PATH] [--half-digits LOG2_POINTS]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..circuits import FalconNTTVerificationCircuit
from ..examples.pok_sig import synchronize
from ..falcon import make_instance
from ..params import get_params
from ..r1cs.coo import compile_circuit
from ..snark import G1_GEN, R, native_backend
from ..snark.bls12_381 import g1_add, g1_from_affine, g1_mul, g1_to_affine
from ..snark.gpu_msm import WINDOW, _window_digits_signed, g1_msm_gpu, g1_msm_gpu_multi
from ..snark.groth16 import load_pk
from ..snark.points import G1Array, ints_to_limbs
from ..snark.qap import qap_domain
from ..utils.device import DeviceUnavailableError, entry_device
from .prove_large import Stages


def _native():
    if not native_backend.available():
        raise RuntimeError("the native C Groth16 backend did not build")
    return native_backend


def h_query_points(n: int = 1024, seed: int = 1, crs=None) -> G1Array:
    """The h query of the Falcon-n verify-with-NTT circuit: from `crs` (a
    .pk.npz of that circuit), or [tau^i Z(tau) / delta]_1 for i < domain
    size - 1 with tau and delta drawn from `seed`, by the native
    fixed-base (the setup's own h-query step, without the rest of the
    CRS)."""
    if crs is not None:
        return load_pk(crs).h_query
    rng = np.random.default_rng(seed)
    inst = make_instance(rng, get_params(n))
    size = qap_domain(compile_circuit(FalconNTTVerificationCircuit, inst, cache=False)).size
    tau, delta = (int.from_bytes(rng.bytes(32), "little") % (R - 1) + 1 for _ in range(2))
    cur = (pow(tau, size, R) - 1) * pow(delta, -1, R) % R
    scalars = [0] * (size - 1)
    for i in range(size - 1):
        scalars[i] = cur
        cur = cur * tau % R
    return _native().g1_fixed_base_batch(scalars)


def random_scalars(rng, K: int, n: int) -> np.ndarray:
    """(K, n, 4) u64 full-width scalars below r: three uniform limbs under
    a top limb drawn below r's."""
    sc = rng.integers(0, 2**64, size=(K, n, 4), dtype=np.uint64)
    sc[..., 3] = rng.integers(0, R >> 192, size=(K, n), dtype=np.uint64)
    return sc


def run(n: int = 1024, Ks=(1, 2, 4, 8), iters: int = 2, device="cuda", points=None,
        crs=None, seed: int = 1, window: int | None = None, log=print) -> list:
    """For each K: the first g1_msm_gpu_multi call (the K4 conversion
    when the point set is new), then `iters` timed calls, and the native
    C's g1_msm_multi on the same scalars, equal to both.  `points`
    replaces the h query; `window` the engine's default 12.  Returns one
    dict a K: {"K", "first_s", "gpu_ms_per_msm", "native_ms_per_msm"}."""
    dev = entry_device(device)
    pts = points if points is not None else h_query_points(n, seed, crs)
    rng = np.random.default_rng(seed)
    rows = []
    for K in Ks:
        sc = random_scalars(rng, K, len(pts))
        t0 = time.perf_counter()
        first = g1_msm_gpu_multi(pts, list(sc), window, dev)
        synchronize(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            got = g1_msm_gpu_multi(pts, list(sc), window, dev)
        synchronize(dev)
        gpu_s = (time.perf_counter() - t0) / iters
        t0 = time.perf_counter()
        want = _native().g1_msm_multi(pts, sc)
        native_s = time.perf_counter() - t0
        if first != want or got != want:
            raise RuntimeError(f"g1_msm_gpu_multi K={K} n={len(pts)} != the native C")
        rows.append({"K": K, "first_s": first_s, "gpu_ms_per_msm": gpu_s / K * 1e3,
                     "native_ms_per_msm": native_s / K * 1e3})
        log(f"msm_multi K={K} n={len(pts)} ({dev}): {gpu_s / K * 1e3:.1f} ms/MSM "
            f"(first call {first_s:.3f} s); native C g1_msm_multi "
            f"{native_s / K * 1e3:.1f} ms/MSM; equal")
    return rows


def half_digit_scalars(windows=(WINDOW, 16)) -> list:
    """Scalars whose signed recode at window width w hits the digit +half
    = 2^(w-1) exactly, for each w: half at window 0; at window 1; at
    window 1 after a carry out of window 0; half in every window below
    2^254 (the native test's dense pattern, kept below r so that no
    reduction mod r disturbs it); then 12345 and r - 1."""
    out = []
    for w in windows:
        half = 1 << (w - 1)
        out += [half, half << w, ((1 << w) - 1) | ((half - 1) << w),
                sum(half << (w * i) for i in range(254 // w))]
    return out + [12345, R - 1]


def tiled_points(n: int, m: int = 8):
    """n points cycling through the m base points k G, k = 2 .. m + 1
    (the native half-digit test's tiling): (the base points, the G1Array)."""
    gen = g1_from_affine(G1_GEN)
    base = [g1_to_affine(g1_mul(gen, k)) for k in range(2, m + 2)]
    blk = G1Array.from_affine_list(base)
    reps = -(-n // m)
    arr = G1Array(np.tile(blk.xs, (reps, 1))[:n], np.tile(blk.ys, (reps, 1))[:n],
                  np.zeros(n, dtype=np.uint8))
    return base, arr


def _as_ints(sc: np.ndarray) -> np.ndarray:
    """(n, 4) u64 -> (n,) object array of Python ints."""
    a = sc.astype(object)
    return a[:, 0] + (a[:, 1] << 64) + (a[:, 2] << 128) + (a[:, 3] << 192)


def half_digit_check(n: int, K: int = 2, window: int | None = None, windows=(WINDOW, 16),
                     device="cuda", m: int = 8, seed: int = 7, log=print) -> dict:
    """g1_msm_gpu (the first vector) and g1_msm_gpu_multi (all K) at
    `window` (default 12) over n points tiled from m base points, with K
    scalar vectors: full-width random rows, and every third row one of
    half_digit_scalars(windows) in turn.  Each must equal the native C's
    g1_msm / g1_msm_multi and the group-law sum over the base points;
    the engineered rows must recode to the digit +half at `window`.
    Returns {"seconds": {step: s}, "points", "scalars" (K, n, 4) u64,
    "sums": the K affine sums}."""
    window = WINDOW if window is None else window
    dev = entry_device(device)
    native = _native()
    tricky = ints_to_limbs(half_digit_scalars(windows), 4)
    half = 1 << (window - 1)
    if not (_window_digits_signed(tricky, window) == half).any():
        raise RuntimeError(f"no engineered scalar recodes to +{half} at window {window}")
    base, arr = tiled_points(n, m)
    rng = np.random.default_rng(seed)
    vecs = random_scalars(rng, K, n)
    rows = np.arange(0, n, 3)
    for k in range(K):
        vecs[k, rows] = tricky[(np.arange(len(rows)) + k) % len(tricky)]
    want = []
    for k in range(K):
        vals = _as_ints(vecs[k])
        acc = None
        for j in range(m):
            s = int(vals[j::m].sum()) % R
            if s:
                acc = g1_add(acc, g1_mul(g1_from_affine(base[j]), s))
        want.append(g1_to_affine(acc) if acc is not None else None)
    timed = Stages(dev, log)
    single = timed("g1_msm_gpu", g1_msm_gpu, arr, vecs[0], window, dev)
    multi = timed(f"g1_msm_gpu_multi K={K}", g1_msm_gpu_multi, arr, list(vecs), window, dev)
    nat = timed("native g1_msm", native.g1_msm, arr, vecs[0])
    nat_multi = timed(f"native g1_msm_multi K={K}", native.g1_msm_multi, arr, vecs)
    if not single == nat == want[0]:
        raise RuntimeError(f"half digits n={n}: g1_msm_gpu, native C, group law disagree")
    if not multi == nat_multi == want:
        raise RuntimeError(f"half digits n={n}: g1_msm_gpu_multi, native C, group law disagree")
    log(f"half digits n={n} window {window} ({len(rows)} engineered rows a vector, "
        f"K={K}): g1_msm_gpu == native g1_msm == group law; g1_msm_gpu_multi == "
        "native g1_msm_multi == group law")
    return {"seconds": timed.seconds, "points": arr, "scalars": vecs, "sums": multi}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.msm_multi",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, choices=(512, 1024), default=1024)
    ap.add_argument("--k", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crs", default=None,
                    help="a .pk.npz of the verify-with-NTT circuit whose h query to use")
    ap.add_argument("--half-digits", type=int, default=None, metavar="LOG2_POINTS",
                    help="also run half_digit_check over 2^LOG2_POINTS tiled points")
    args = ap.parse_args(argv)
    try:
        rows = run(args.n, args.k, args.iters, args.device, crs=args.crs)
        half = (half_digit_check(1 << args.half_digits, device=args.device)["seconds"]
                if args.half_digits is not None else None)
    except DeviceUnavailableError as e:
        print(f"msm_multi: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"msm_multi": rows, "half_digits": half}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
