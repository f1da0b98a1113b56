"""K Groth16 proofs of Falcon-512 verify-with-NTT over one CRS on the port,
batched against single proves.

The port of the JAX package's `tools/bench_prove_batch.py`: the CRS of
the circuit compiled from `make_instance(np.random.default_rng(5), ...)`
(loaded from `--crs` or the port's artifact directory, else set up, as
`prove_large` finds or makes it); K assignments from
`make_instance(np.random.default_rng(7), ...)`, their witnesses in one
engine call on the device (K1 twice: on sig and on v) and one packer
call; a warm-up `prove_batch` of two; then `iters` single proves of the
first assignment and `iters` batches of all K, with the same r and s.
`--g1-backend native` runs the host C's K-fold multi-MSMs; `gpu` (the
default) makes `prove_batch` prove each assignment with `prove`, its
four G1 MSMs on the device.  Every proof must verify, the batch's first
must equal the single prove, and a tampered public input must be
rejected.

    python -m falcon_r1cs_tpu_torch.tools.prove_batch [K] [iters]
        [--g1-backend gpu|native] [--device cuda] [--crs PATH] [--save-crs]

Prints the JAX tool's three lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import secrets
import sys
import time

import numpy as np

from ..examples.pok_sig import synchronize
from ..falcon import make_instance
from ..params import Q, get_params
from ..r1cs.coo import compile_circuit
from ..snark import R, prove, prove_batch, verify
from ..utils.device import DeviceUnavailableError, entry_device
from .profile_prove import CIRCUIT, N
from .profile_prove import INSTANCE_SEED as CRS_SEED
from .prove_large import G1_BACKENDS, Stages, assignments, proving_key

INSTANCE_SEED = 7


def run(K: int = 16, iters: int = 2, g1_backend: str = "gpu", device="cuda", crs=None,
        save_crs: bool = False, toxic=None, rs=None, ss=None, pk=None, log=print) -> dict:
    """K proofs of Falcon-512 verify-with-NTT over one CRS, batched and
    single.

    pk: a proving key of the circuit to use (else `prove_large`'s
    proving_key with crs, save_crs, toxic); rs, ss: the K blindings
    (random if None).  Returns {"seconds": the set-up stages, "single_s",
    "batch_s" (means of `iters`), "per_proof_s", "speedup", "proofs",
    "single", "publics", "assignments", "pk", "compiled"}; raises if a
    proof does not verify, the batch differs from the single prove or
    the tampered input verifies."""
    if g1_backend not in G1_BACKENDS:
        raise ValueError(f"g1_backend={g1_backend!r}: one of {G1_BACKENDS}")
    dev = entry_device(device)
    timed = Stages(dev, log)
    params = get_params(N)
    compiled = timed("compile (direct COO)", compile_circuit, CIRCUIT,
                     make_instance(np.random.default_rng(CRS_SEED), params))
    rng = np.random.default_rng(INSTANCE_SEED)
    insts = [make_instance(rng, params) for _ in range(K)]
    publics, zs = timed(f"witness x{K} (device)", assignments, CIRCUIT, insts, dev)
    if pk is None:
        pk = proving_key(compiled, CIRCUIT, N, timed, crs, save_crs, toxic)
    rs = list(rs) if rs is not None else [secrets.randbelow(R) for _ in range(K)]
    ss = list(ss) if ss is not None else [secrets.randbelow(R) for _ in range(K)]
    kw = dict(g1_backend=g1_backend, msm_device=dev)
    timed("warm-up prove_batch", prove_batch, pk, compiled, zs[:2], **kw)

    t0 = time.perf_counter()
    for _ in range(iters):
        single = prove(pk, compiled, zs[0], r=rs[0], s=ss[0], **kw)
    synchronize(dev)
    single_s = (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        proofs = prove_batch(pk, compiled, zs, rs=rs, ss=ss, **kw)
    synchronize(dev)
    batch_s = (time.perf_counter() - t0) / iters

    if (proofs[0].a, proofs[0].b, proofs[0].c) != (single.a, single.b, single.c):
        raise RuntimeError("prove_batch's first proof != prove's with the same r, s")
    for k in range(K):
        if not verify(pk.vk, publics[k], proofs[k]):
            raise RuntimeError(f"batch proof {k} does not verify")
    bad = list(publics[0])
    bad[1] = (bad[1] + 1) % Q
    if verify(pk.vk, bad, proofs[0]):
        raise RuntimeError("a tampered public input verified")

    log(f"single prove:        {single_s * 1e3:8.1f} ms  ({1 / single_s:5.2f} proofs/s)")
    log(f"batch K={K:<3d}:        {batch_s * 1e3:8.1f} ms  ({K / batch_s:5.2f} proofs/s, "
        f"{batch_s / K * 1e3:6.1f} ms/proof)")
    log(f"speedup vs K singles: {single_s * K / batch_s:5.2f}x")
    return {"seconds": timed.seconds, "single_s": single_s, "batch_s": batch_s,
            "per_proof_s": batch_s / K, "speedup": single_s * K / batch_s, "proofs": proofs,
            "single": single, "publics": publics, "assignments": zs, "pk": pk,
            "compiled": compiled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.prove_batch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("K", nargs="?", type=int, default=16)
    ap.add_argument("iters", nargs="?", type=int, default=2)
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="gpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crs", default=None, help="a .pk.npz to load instead of a setup")
    ap.add_argument("--save-crs", action="store_true",
                    help="save a fresh setup's CRS in the artifact directory")
    args = ap.parse_args(argv)
    try:
        out = run(args.K, args.iters, args.g1_backend, args.device, args.crs, args.save_crs)
    except DeviceUnavailableError as e:
        print(f"prove_batch: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"K": args.K, "iters": args.iters, "g1_backend": args.g1_backend,
                      **{k: out[k] for k in ("seconds", "single_s", "batch_s", "per_proof_s",
                                             "speedup")}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
