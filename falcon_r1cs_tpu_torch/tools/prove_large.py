"""Groth16 at the reference's full envelope on the port: schoolbook-1024
(1,156,150 constraints, QAP domain 2^21, an h query of 2^21 - 1 points)
and dual-1024 (193,598 constraints, domain 2^18).

The port of the JAX package's `tools/prove_large.py`, step by step: the
instance from `make_instance(np.random.default_rng(9), ...)`; the COO
from `r1cs.coo.compile_circuit`; the witness on the device at B = 1
through `witness.circuit_witness` and its packer (schoolbook: K3 once;
dual: K1 four times); the assignment, the JAX tool's public inputs (one,
then pk and hm: coefficients for schoolbook, NTT-domain for dual)
followed by the witness, as (N, 4) u64 limb rows; the CRS loaded from
`--crs` or the port's artifact directory, else set up (and saved there
with `--save-crs`); `prove` cold, then warm, its four G1 MSMs on the
device (`--g1-backend gpu`, the default) or in the host C (`native`);
`verify`, and a tampered public input rejected.

    python -m falcon_r1cs_tpu_torch.tools.prove_large [schoolbook|dual]
        [--n 1024] [--g1-backend gpu|native] [--device cuda] [--crs PATH]
        [--save-crs]

Prints each stage's seconds as it ends, then one JSON line with the
stage seconds, the peak device memory and the proof.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..circuits import (
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
)
from ..examples.pok_sig import synchronize
from ..falcon import make_instance, ntt
from ..params import Q, get_params
from ..r1cs.coo import cache_dir, compile_circuit
from ..snark import prove, setup, verify
from ..snark.groth16 import load_pk, save_pk
from ..snark.points import ints_to_limbs, packed_to_limb_rows
from ..utils.device import DeviceUnavailableError, entry_device
from ..witness import circuit_witness

CIRCUITS = {"schoolbook": FalconSchoolBookVerificationCircuit,
            "dual": FalconDualNTTVerificationCircuit}
G1_BACKENDS = ("gpu", "native")
INSTANCE_SEED = 9


class Stages:
    """Host seconds of named stages, each ended by a device synchronise
    and logged as it ends."""

    def __init__(self, dev: torch.device, log=print):
        self.dev, self.log, self.seconds = dev, log, {}

    def __call__(self, label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(self.dev)
        self.seconds[label] = time.perf_counter() - t0
        self.log(f"{label:26s} {self.seconds[label]:9.3f} s")
        return out


def circuit_class(which):
    """`which`: a CIRCUITS key, or a circuit class (the verify-with-NTT
    circuit of the Falcon-512 tools, which is not a `which` choice)."""
    return CIRCUITS[which] if isinstance(which, str) else which


def engine_inputs(which, insts):
    """The (B, n) int32 engine inputs of the JAX tools: schoolbook (sig
    lifted to [0, q), pk, hm), dual (sig signed, ntt(pk), ntt(hm)),
    verify-with-NTT (sig lifted, ntt(pk), ntt(hm);
    tools/bench_prove_batch.py).  The last two are the public inputs."""
    cls = circuit_class(which)
    if cls is FalconSchoolBookVerificationCircuit:
        cols = [(i.sig_lifted, i.h, i.hm) for i in insts]
    elif cls is FalconDualNTTVerificationCircuit:
        cols = [(i.sig_signed, ntt(i.h), ntt(i.hm)) for i in insts]
    elif cls is FalconNTTVerificationCircuit:
        cols = [(i.sig_lifted, ntt(i.h), ntt(i.hm)) for i in insts]
    else:
        raise TypeError(f"no engine inputs for {cls!r}")
    return tuple(np.stack(c).astype(np.int32) for c in zip(*cols))


def assignments(which, insts, device):
    """The witnesses of `insts` (circuit `which`: a CIRCUITS key or a
    circuit class) on `device`, one engine and one packer call over the
    batch: (each instance's public inputs, its full assignment as (N, 4)
    u64 limb rows)."""
    dev = torch.device(device)
    cw = circuit_witness(circuit_class(which), insts[0].params.n, dev)
    sig, pk_in, hm_in = engine_inputs(which, insts)
    seg = cw.engine(*(torch.from_numpy(a).to(dev) for a in (sig, pk_in, hm_in)))
    packed = cw.pack(seg).cpu().numpy()
    publics, rows = [], []
    for b in range(len(insts)):
        pub = [1] + pk_in[b].tolist() + hm_in[b].tolist()
        publics.append(pub)
        rows.append(np.concatenate([ints_to_limbs(pub, 4), packed_to_limb_rows(packed[b])]))
    return publics, rows


def crs_path(which, n: int) -> Path:
    """The CRS's place in the port's artifact directory (the JAX
    package's name for it in its own)."""
    return cache_dir() / f"{circuit_class(which).__name__}_{n}.pk.npz"


def proving_key(compiled, which, n: int, timed: Stages, crs=None,
                save_crs: bool = False, toxic=None):
    """The proving key: loaded from `crs` (a .pk.npz saved by either
    package), else from the port's artifact directory unless fixed toxic
    waste is given, else set up with `toxic` (random if None) and, with
    `save_crs`, saved there."""
    path = Path(crs) if crs is not None else crs_path(which, n)
    if crs is not None or (toxic is None and path.exists()):
        return timed("load CRS", load_pk, path)
    pk = timed("setup (CRS)", setup, compiled, toxic)
    if save_crs:
        path.parent.mkdir(parents=True, exist_ok=True)
        timed("save CRS", save_pk, pk, path)
    return pk


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev: torch.device):
    """Peak device memory allocated since reset_peak, in GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def run(which: str = "schoolbook", n: int = 1024, g1_backend: str = "gpu",
        device="cuda", crs=None, save_crs: bool = False, toxic=None, r=None, s=None,
        log=print) -> dict:
    """Prove the `which` circuit at Falcon-n, cold then warm, and verify.

    toxic: a snark.groth16.SetupToxic for a fresh setup (then no cached
    CRS is read); r, s: the blinding of both proves (random if None).
    Returns {"seconds": {stage: s}, "peak_device_gib", "proof", "pk",
    "compiled", "publics", "assignment"}; raises if the proof does not
    verify or the tampered input does."""
    if which not in CIRCUITS:
        raise ValueError(f"which={which!r}: one of {sorted(CIRCUITS)}")
    if g1_backend not in G1_BACKENDS:
        raise ValueError(f"g1_backend={g1_backend!r}: one of {G1_BACKENDS}")
    dev = entry_device(device)
    reset_peak(dev)
    timed = Stages(dev, log)
    inst = make_instance(np.random.default_rng(INSTANCE_SEED), get_params(n))
    compiled = timed("compile (direct COO)", compile_circuit, CIRCUITS[which], inst)
    log(f"  constraints={compiled.num_constraints} instance={compiled.num_instance} "
        f"variables={compiled.num_variables}")
    (publics,), (z,) = timed("witness (device)", assignments, which, [inst], dev)
    pk = proving_key(compiled, which, n, timed, crs, save_crs, toxic)
    kw = dict(r=r, s=s, g1_backend=g1_backend, msm_device=dev)
    proof = timed("prove (cold)", prove, pk, compiled, z, **kw)
    timed("prove (warm)", prove, pk, compiled, z, **kw)
    if not timed("verify", verify, pk.vk, publics, proof):
        raise RuntimeError(f"{which}-{n}: the proof does not verify")
    bad = list(publics)
    bad[1] = (bad[1] + 1) % Q
    if verify(pk.vk, bad, proof):
        raise RuntimeError(f"{which}-{n}: a tampered public input verified")
    log(f"{which}-{n} (G1 MSMs {g1_backend} on {dev}): prove + verify passed, "
        "tampered input rejected")
    return {"seconds": timed.seconds, "peak_device_gib": peak_gib(dev), "proof": proof,
            "pk": pk, "compiled": compiled, "publics": publics, "assignment": z}


def proof_json(proof) -> dict:
    """The proof's affine coordinates as hex strings."""
    (bx0, bx1), (by0, by1) = proof.b
    return {"a": [hex(v) for v in proof.a], "b": [[hex(bx0), hex(bx1)], [hex(by0), hex(by1)]],
            "c": [hex(v) for v in proof.c]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch.tools.prove_large",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("which", nargs="?", choices=tuple(CIRCUITS), default="schoolbook")
    ap.add_argument("--n", type=int, choices=(512, 1024), default=1024)
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="gpu")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crs", default=None, help="a .pk.npz to load instead of a setup")
    ap.add_argument("--save-crs", action="store_true",
                    help="save a fresh setup's CRS in the artifact directory")
    args = ap.parse_args(argv)
    try:
        out = run(args.which, args.n, args.g1_backend, args.device, args.crs, args.save_crs)
    except DeviceUnavailableError as e:
        print(f"prove_large: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"which": args.which, "n": args.n, "g1_backend": args.g1_backend,
                      "seconds": out["seconds"], "peak_device_gib": out["peak_device_gib"],
                      "proof": proof_json(out["proof"])}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
