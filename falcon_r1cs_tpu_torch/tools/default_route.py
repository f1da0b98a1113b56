"""The prover's default route on the card: the two proving commands of
`python -m falcon_r1cs_tpu_torch` at their default backend, in turns
across checkouts, and the parts of a cold prove.

    python -m falcon_r1cs_tpu_torch.tools.default_route [--trees DIR ...]
        [--n 1024] [--cold]

Each tree is the root of a checkout of this repo (default: the one this
module is in), run in the order given: parent, change, change, parent
compares two commits on one card.  Each tree first runs both commands
once, untimed (its kernels build, the CRS is set up and cached); then,
tree by tree in that order, `pok-sig n` and `aggregate --n n --k 8
--prove 2`, each in a subprocess from the tree with no `--g1-backend`.
A run's record: the backend its prove line names, that line's seconds
(the command prints them to 0.01 s) and the command's wall seconds.

--cold then times, in this process, the parts of the first prove of a
Falcon-n verify-with-NTT proving key at the default backend: each G1
query's conversion to Montgomery words on the card (`gpu_msm.
_points_mont`: the host's limbs of the points, their upload and K4), the
host limbs alone, the circuit's A, B, C values as host limbs
(`native_backend._compiled_cache`, which the host C's map needs too),
the witness map's tables and CSR upload (`gpu_qap._cache`), the prove
that follows them, and two warm proves; before them, a whole cold prove
of the same key and circuit, each loaded afresh.

Prints the card's name and power limit, a line a run, and one JSON line
last.  Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..utils.device import DeviceUnavailableError, entry_device

COMMANDS = {
    "pok-sig": (["pok-sig", "{n}"],
                re.compile(r"Groth16 prove \(device-packed witness, G1 MSMs (\w+)\): ([\d.]+)s")),
    "aggregate --prove 2": (["aggregate", "--n", "{n}", "--k", "8", "--prove", "2"],
                            re.compile(r"prove_batch K=\d+ \(G1 MSMs (\w+)\): ([\d.]+)s")),
}
HERE = Path(__file__).resolve().parents[2]


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_command(tree: Path, name: str, n: int, timeout: float = 900) -> dict:
    """One CLI command from `tree` in a subprocess: {backend, prove_s,
    wall_s}; raises if it fails or prints no prove line."""
    argv, pattern = COMMANDS[name]
    cmd = [sys.executable, "-m", "falcon_r1cs_tpu_torch", *(a.format(n=n) for a in argv)]
    env = dict(os.environ, PYTHONPATH=str(tree))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: {' '.join(cmd[2:])} exited {out.returncode}:\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    found = pattern.search(out.stdout)
    if found is None:
        raise RuntimeError(f"{tree}: {name}: no prove line in\n{out.stdout[-2000:]}")
    return {"backend": found.group(1), "prove_s": float(found.group(2)), "wall_s": wall}


def turns(trees: list[Path], n: int, log=print) -> list[dict]:
    """Both commands once untimed in each distinct tree, then timed, tree
    by tree in the order given."""
    for tree in dict.fromkeys(trees):
        for name in COMMANDS:
            run_command(tree, name, n)
        log(f"warm-up {tree}: done")
    rows = []
    for i, tree in enumerate(trees):
        for name in COMMANDS:
            row = {"turn": i, "tree": str(tree), "command": name, **run_command(tree, name, n)}
            rows.append(row)
            log(f"turn {i} {tree} {name}: G1 MSMs {row['backend']}, prove line "
                f"{row['prove_s']} s, wall {row['wall_s']} s")
    return rows


def cold_prove(n: int, dev: torch.device, log=print) -> dict:
    """Seconds of the parts of a first prove at the default backend (see
    the module's docstring), each ended by a synchronise."""
    from ..circuits import FalconNTTVerificationCircuit
    from ..examples.pok_sig import load_or_setup_crs, synchronize
    from ..falcon import make_instance
    from ..params import get_params
    from ..r1cs.coo import compile_circuit, cache_dir
    from ..snark import gpu_msm, gpu_qap, groth16, native_backend
    from .prove_large import assignments

    def timed(fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        return out, time.perf_counter() - t0

    inst = make_instance(np.random.default_rng(0), get_params(n))
    compiled = compile_circuit(FalconNTTVerificationCircuit, inst)
    _, (z,) = assignments(FalconNTTVerificationCircuit, [inst], dev)
    pk, _, _ = load_or_setup_crs(compiled, n)
    r, s = 3, 5
    want, cold_s = timed(lambda: groth16.prove(pk, compiled, z, r=r, s=s))

    path = cache_dir() / f"{FalconNTTVerificationCircuit.__name__}_{n}.pk.npz"
    pk = groth16.load_pk(path)
    for key in ("_gpu_qap_cache", "_g16_native_cache"):
        compiled.__dict__.pop(key, None)
    out = {"cold_prove_s": cold_s, "queries": {}}
    for name in ("a_query", "b_g1_query", "l_query", "h_query"):
        points = getattr(pk, name)
        n_pad = max(8, 1 << (len(points) - 1).bit_length())
        _, limbs_s = timed(lambda: gpu_msm._points_std_limbs(points, n_pad))
        _, conv_s = timed(lambda: gpu_msm._points_mont(points, n_pad, dev))
        out["queries"][name] = {"points": len(points), "host_limbs_s": limbs_s,
                                "conversion_s": conv_s}
    _, out["host_csr_s"] = timed(lambda: native_backend._compiled_cache(compiled))
    _, out["tables_s"] = timed(lambda: gpu_qap._cache(compiled, dev))
    got, out["first_prove_after_s"] = timed(lambda: groth16.prove(pk, compiled, z, r=r, s=s))
    out["warm_prove_s"] = [timed(lambda: groth16.prove(pk, compiled, z, r=r, s=s))[1]
                           for _ in range(2)]
    if (got.a, got.b, got.c) != (want.a, want.b, want.c):
        raise RuntimeError("the cold prove's proof != the warm prove's with the same r, s")
    conv = sum(q["conversion_s"] for q in out["queries"].values())
    log(f"cold prove Falcon-{n} (auto on {dev}): {cold_s} s whole; parts: CRS conversion "
        f"{conv} s ({ {k: q['conversion_s'] for k, q in out['queries'].items()} }, host limbs "
        f"{ {k: q['host_limbs_s'] for k, q in out['queries'].items()} }), A, B, C values as "
        f"host limbs {out['host_csr_s']} s, witness map tables {out['tables_s']} s, the "
        f"prove after them {out['first_prove_after_s']} s; warm {out['warm_prove_s']} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.default_route",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=Path, default=[HERE])
    ap.add_argument("--n", type=int, choices=(512, 1024), default=1024)
    ap.add_argument("--cold", action="store_true")
    args = ap.parse_args(argv)
    try:
        dev = entry_device("cuda")
    except DeviceUnavailableError as e:
        print(f"default_route: {e}", file=sys.stderr)
        return 2
    name = card()
    print(name, flush=True)
    out = {"card": name, "n": args.n,
           "runs": turns([t.resolve() for t in args.trees], args.n,
                         log=lambda *a: print(*a, flush=True))}
    if args.cold:
        out["cold"] = cold_prove(args.n, dev, log=lambda *a: print(*a, flush=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
