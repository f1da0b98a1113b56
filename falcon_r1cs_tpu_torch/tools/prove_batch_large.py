"""K Groth16 proofs over one CRS at the large circuits on the port:
dual-1024 and schoolbook-1024 through the port's `prove_batch`.

The port of the JAX package's `tools/bench_prove_batch_large.py`: K
instances from `make_instance(np.random.default_rng(11), ...)`, their
witnesses in one engine call on the device, one CRS (as `prove_large`
finds or makes it); a warm-up `prove_batch` of two; then one single
`prove`, `prove_batch` of all K, and one single `prove` again, whose
mean stands beside the batch's seconds a proof.  `--g1-backend gpu` (the
default) makes `prove_batch` prove each assignment with `prove`, its
witness map and four G1 MSMs on the device; `native` runs the host C's
K-fold multi-MSMs.  Every proof must verify, the batch's must equal the
single proves' with the same r and s, and a tampered public input must
be rejected.

    python -m falcon_r1cs_tpu_torch.tools.prove_batch_large [dual|schoolbook] [K]
        [--n 1024] [--g1-backend gpu|native] [--device cuda] [--crs PATH]
        [--save-crs]
"""

from __future__ import annotations

import argparse
import json
import resource
import secrets
import sys

import numpy as np

from ..falcon import make_instance
from ..params import Q, get_params
from ..r1cs.coo import compile_circuit
from ..snark import R, prove, prove_batch, verify
from ..utils.device import DeviceUnavailableError, entry_device
from .prove_large import CIRCUITS, G1_BACKENDS, Stages, assignments, peak_gib, proving_key, reset_peak

INSTANCE_SEED = 11


def run(which: str = "schoolbook", K: int = 8, n: int = 1024, g1_backend: str = "gpu",
        device="cuda", crs=None, save_crs: bool = False, toxic=None, rs=None, ss=None,
        pk=None, log=print) -> dict:
    """K proofs of the `which` circuit at Falcon-n over one CRS.

    pk: a proving key of this circuit to use (else `prove_large`'s
    proving_key with crs, save_crs, toxic); rs, ss: the K blindings
    (random if None).  Returns {"seconds": {stage: s}, "single_s",
    "batch_s", "per_proof_s", "speedup", "peak_rss_gib",
    "peak_device_gib", "proofs", "publics"}; raises if a proof does not
    verify, the batch differs from the single proves or the tampered
    input verifies."""
    if which not in CIRCUITS:
        raise ValueError(f"which={which!r}: one of {sorted(CIRCUITS)}")
    if g1_backend not in G1_BACKENDS:
        raise ValueError(f"g1_backend={g1_backend!r}: one of {G1_BACKENDS}")
    dev = entry_device(device)
    reset_peak(dev)
    timed = Stages(dev, log)
    rng = np.random.default_rng(INSTANCE_SEED)
    insts = [make_instance(rng, get_params(n)) for _ in range(K)]
    compiled = timed("compile (direct COO)", compile_circuit, CIRCUITS[which], insts[0])
    log(f"  constraints={compiled.num_constraints} variables={compiled.num_variables}")
    publics, zs = timed(f"witness x{K} (device)", assignments, which, insts, dev)
    if pk is None:
        pk = proving_key(compiled, which, n, timed, crs, save_crs, toxic)
    rs = list(rs) if rs is not None else [secrets.randbelow(R) for _ in range(K)]
    ss = list(ss) if ss is not None else [secrets.randbelow(R) for _ in range(K)]
    kw = dict(g1_backend=g1_backend, msm_device=dev)
    timed("warm-up prove_batch", prove_batch, pk, compiled, zs[:2], **kw)
    j = 1 % K
    first = timed("prove (single)", prove, pk, compiled, zs[0], r=rs[0], s=ss[0], **kw)
    proofs = timed(f"prove_batch K={K}", prove_batch, pk, compiled, zs, rs=rs, ss=ss, **kw)
    again = timed("prove (single, again)", prove, pk, compiled, zs[j], r=rs[j], s=ss[j], **kw)

    for k, single in ((0, first), (j, again)):
        if (proofs[k].a, proofs[k].b, proofs[k].c) != (single.a, single.b, single.c):
            raise RuntimeError(f"prove_batch's proof {k} != prove's with the same r, s")
    for k in range(K):
        if not verify(pk.vk, publics[k], proofs[k]):
            raise RuntimeError(f"{which}-{n}: batch proof {k} does not verify")
    bad = list(publics[0])
    bad[1] = (bad[1] + 1) % Q
    if verify(pk.vk, bad, proofs[0]):
        raise RuntimeError(f"{which}-{n}: a tampered public input verified")

    sec = timed.seconds
    single = (sec["prove (single)"] + sec["prove (single, again)"]) / 2
    batch = sec[f"prove_batch K={K}"]
    out = {"seconds": sec, "single_s": single, "batch_s": batch, "per_proof_s": batch / K,
           "speedup": single * K / batch,
           "peak_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "peak_device_gib": peak_gib(dev), "proofs": proofs, "publics": publics}
    log(f"{which}-{n} batch K={K} (G1 MSMs {g1_backend} on {dev}): single prove "
        f"{single:.3f} s; batch {batch:.3f} s = {batch / K:.3f} s/proof "
        f"({out['speedup']:.2f}x K singles); peak RSS {out['peak_rss_gib']:.2f} GiB; "
        "every proof verifies, == the single proves, tampered input rejected")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.prove_batch_large",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", choices=tuple(CIRCUITS), default="schoolbook")
    ap.add_argument("K", nargs="?", type=int, default=8)
    ap.add_argument("--n", type=int, choices=(512, 1024), default=1024)
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="gpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crs", default=None, help="a .pk.npz to load instead of a setup")
    ap.add_argument("--save-crs", action="store_true",
                    help="save a fresh setup's CRS in the artifact directory")
    args = ap.parse_args(argv)
    try:
        out = run(args.which, args.K, args.n, args.g1_backend, args.device, args.crs,
                  args.save_crs)
    except DeviceUnavailableError as e:
        print(f"prove_batch_large: {e}", file=sys.stderr)
        return 2
    print(json.dumps({k: out[k] for k in ("seconds", "single_s", "batch_s", "per_proof_s",
                                          "speedup", "peak_rss_gib", "peak_device_gib")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
