"""Batched aggregate verification: the realization of the reference's
empty `falcon-aggregate-sig` workspace stub
(`falcon-aggregate-sig/src/main.rs:1-3` is "Hello, world!"), on the port.

K wire-format (pk, msg, sig) triples -> one device pass
(`ProverInputPipeline.run_wire`) producing, for every signature, the full
R1CS witness of the verify-with-NTT circuit and its packed canonical
export -> a batched CRT satisfiability verdict on the device, from the
packed export.  `--prove K` also proves the first K signatures as a batch
over one CRS (`prove_batch`, the witness maps and G1 MSMs on
`--g1-backend`: "auto", the default, is the card on `--device cuda`, a
prove an assignment, and the host C's batched multi-MSMs on `--device
cpu`).  The port's counterpart of the repo's `examples/aggregate_sig.py`.

    python -m falcon_r1cs_tpu_torch aggregate [--k 64] [--n 512]
        [--prove K] [--device cuda] [--g1-backend auto|native|gpu|python]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import FalconNTTVerificationCircuit
from ..falcon import compress_signature, encode_public_key, make_instance
from ..params import get_params
from ..parallel.sat_check import ResidueSystem
from ..pipeline import ProverInputPipeline
from ..r1cs.coo import compile_circuit
from ..utils.device import entry_device
from .pok_sig import G1_BACKENDS, load_or_setup_crs, synchronize

# signatures a CRT check call: its residues take 24 x 4 bytes a wire of
# each signature (15 MB at Falcon-1024) and each sparse product 8 bytes a
# nonzero, so the batch is checked in slices
SAT_CHUNK = 64


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch aggregate")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--n", type=int, choices=(512, 1024), default=512)
    ap.add_argument(
        "--prove", type=int, default=0, metavar="K",
        help="also Groth16-prove the first K signatures as a batch over "
        "the shared CRS (prove_batch) and verify every proof",
    )
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="auto")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    params = get_params(args.n)
    rng = np.random.default_rng(0)

    t0 = time.time()
    insts = [make_instance(rng, params, msg=b"msg %d" % i)
             for i in range(args.k)]
    pk_bytes = [encode_public_key(i.h, params) for i in insts]
    sig_bytes = [
        compress_signature(i.sig_signed, i.nonce, params) for i in insts
    ]
    print(f"built {args.k} wire-format instances: {time.time()-t0:.1f}s")

    pipe = ProverInputPipeline(params, dev, pack=True)
    t0 = time.time()
    out = pipe.run_wire(pk_bytes, [i.msg for i in insts], sig_bytes)
    synchronize(dev)
    dt = time.time() - t0
    print(f"decode + hash-to-point + witness + pack: {dt:.2f}s "
          f"({args.k/dt:,.1f} sigs/s incl. host stages; device {dev})")

    # batched satisfiability verdict straight from the packed export
    compiled = compile_circuit(FalconNTTVerificationCircuit, insts[0])
    rs = ResidueSystem(compiled, dev)
    instance_vals = torch.cat(
        [torch.ones((args.k, 1), dtype=torch.int64, device=dev),
         out.pk_ntt.long(), out.hm_ntt.long()], dim=1,
    )
    t0 = time.time()
    verdict = torch.cat([
        rs.check_device(rs.witness_residues_from_packed(
            instance_vals[i : i + SAT_CHUNK], out.packed[i : i + SAT_CHUNK]))
        for i in range(0, args.k, SAT_CHUNK)
    ])
    print(f"batched CRT satisfiability: all {args.k} valid = "
          f"{bool(verdict.all())} ({time.time()-t0:.2f}s)")
    assert verdict.all()

    if args.prove:
        # proof-side aggregation: K proofs over ONE CRS via prove_batch
        from ..snark import prove_batch, verify
        from ..snark.groth16 import resolve_g1_backend
        from ..snark.points import ints_to_limbs, packed_to_limb_rows

        kp = min(args.prove, args.k)
        pk, seconds, loaded = load_or_setup_crs(compiled, args.n)
        print(f"CRS loaded from cache: {seconds:.1f}s" if loaded
              else f"Groth16 setup (CRS cached): {seconds:.1f}s")
        packed = out.packed[:kp].cpu().numpy()
        publics = instance_vals[:kp].tolist()
        assigns = [
            np.concatenate(
                [ints_to_limbs(publics[i], 4), packed_to_limb_rows(packed[i])]
            )
            for i in range(kp)
        ]
        backend = resolve_g1_backend(args.g1_backend, dev)
        t0 = time.time()
        proofs = prove_batch(pk, compiled, assigns, g1_backend=backend, msm_device=dev)
        synchronize(dev)
        dt = time.time() - t0
        print(f"prove_batch K={kp} (G1 MSMs {backend}): {dt:.2f}s "
              f"({kp/dt:.2f} proofs/s)")
        t0 = time.time()
        assert all(
            verify(pk.vk, publics[i], proofs[i]) for i in range(kp)
        ), "a batched proof failed verification"
        print(f"all {kp} proofs verify ({time.time()-t0:.2f}s)")


if __name__ == "__main__":
    main()
