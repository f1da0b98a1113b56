"""Proof-of-knowledge-of-signature: the full analog of the reference's
`examples/pok_sig.rs` (`falcon-r1cs/examples/pok_sig.rs`), on the port.

Reference flow (pok_sig.rs:15-47):
  keygen -> sign -> build circuit -> Groth16 setup -> prove -> verify.

The port's counterpart of the repo's `examples/pok_sig.py`:

  real NTRU keygen + signing -> circuit synthesis (cached COO) ->
  witness generation on the device (`witness_engine`) -> CRT
  satisfiability check on the device (`ResidueSystem`) -> Groth16 setup
  (CRS cached in the port's artifact directory) -> prove from the
  device-packed witness, the G1 MSMs on `--g1-backend` -> pairing verify
  -> the tampered public input rejected.

    python -m falcon_r1cs_tpu_torch pok-sig [512|1024] [--device cuda]
        [--g1-backend auto|native|gpu|python]

`--g1-backend` is passed to `prove(g1_backend=..., msm_device=device)`:
"gpu" runs the witness map and the four G1 MSMs on the device
(snark/gpu_qap.py, snark/gpu_msm.py), "native" in the host C; "auto" (the
default) follows the device, as snark/backend_policy.py says: gpu on
`--device cuda`, native on `--device cpu`.  The prove line names the
backend it resolved to.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import FalconNTTVerificationCircuit
from ..falcon import KeyPair, instance_from_signature, ntt
from ..params import get_params
from ..parallel.sat_check import ResidueSystem
from ..r1cs.coo import cache_dir, compile_circuit
from ..snark import prove, setup, verify
from ..snark.groth16 import load_pk, resolve_g1_backend, save_pk
from ..snark.points import ints_to_limbs, packed_to_limb_rows
from ..utils.device import entry_device
from ..witness import interleave_witness, packer_ntt, witness_engine

G1_BACKENDS = ("auto", "native", "gpu", "python")


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def load_or_setup_crs(compiled, n: int):
    """The Groth16 proving key of the verify-with-NTT circuit at n, cached
    in the port's artifact directory: (pk, seconds, loaded)."""
    path = cache_dir() / f"{FalconNTTVerificationCircuit.__name__}_{n}.pk.npz"
    t0 = time.time()
    if path.exists():
        return load_pk(path), time.time() - t0, True
    pk = setup(compiled)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_pk(pk, path)
    return pk, time.time() - t0, False


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch pok-sig")
    ap.add_argument("n", nargs="?", type=int, choices=(512, 1024), default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--g1-backend", choices=G1_BACKENDS, default="auto")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    rng = np.random.default_rng(0)
    params = get_params(args.n)
    print(f"parameter set: Falcon-{params.n}; device {dev}")

    # real keygen + deterministic signing (the reference's pok_sig flow:
    # `pok_sig.rs:15-21`), then clear verification
    t0 = time.time()
    keypair = KeyPair.generate(rng, params)
    msg = b"testing message"
    sig = keypair.signer.sign_with_seed(b"test seed", msg)
    assert keypair.verify(msg, sig)
    print(f"keygen+sign+verify: {time.time()-t0:.2f}s "
          f"(|s2|max={abs(sig.s2).max()})")
    inst = instance_from_signature(keypair.h, msg, sig.nonce, sig.s2, params)

    # circuit-specific synthesis: shape-only trace -> compiled COO (cached)
    t0 = time.time()
    compiled = compile_circuit(FalconNTTVerificationCircuit, inst)
    print(f"synthesis (trace+compile, cached): {time.time()-t0:.2f}s; "
          f"{compiled.num_constraints} constraints, nnz={compiled.nnz()}")

    # witness generation on the device
    t0 = time.time()

    def upload(a):
        return torch.from_numpy(np.asarray(a)[None].astype(np.int32)).to(dev)

    run = witness_engine(params.n)
    seg = run(upload(inst.sig_lifted), upload(ntt(inst.h)), upload(ntt(inst.hm)))
    synchronize(dev)
    wit = interleave_witness(seg, params)
    print(f"witness (device engine): {time.time()-t0:.2f}s")

    # public inputs in the contract order: one || pk_ntt || hm_ntt
    public_inputs = [1] + seg["pk_ntt"][0].tolist() + seg["hm_ntt"][0].tolist()
    assignment = public_inputs + [int(v) for v in wit[0]]

    # fast sanity: the R1CS satisfiability check on the device
    rs = ResidueSystem(compiled, dev)
    ok = rs.is_satisfied(np.asarray(assignment, dtype=object)[None])
    print(f"R1CS satisfied (device CRT check): {bool(ok[0])}")
    assert ok[0]

    # Groth16 setup (pok_sig.rs:30-32) -- CRS cached beside the R1CS
    pk, seconds, loaded = load_or_setup_crs(compiled, params.n)
    print(f"CRS load (cached): {seconds:.2f}s" if loaded else f"Groth16 setup: {seconds:.2f}s")

    # prove (pok_sig.rs:36-37) -- witness limbs straight from the device
    # packer (no Python bigint round trip)
    t0 = time.time()
    packed = packer_ntt(params.n, dev)(seg).cpu().numpy()
    assignment_limbs = np.concatenate(
        [ints_to_limbs(public_inputs, 4), packed_to_limb_rows(packed[0])]
    )
    backend = resolve_g1_backend(args.g1_backend, dev)
    proof = prove(pk, compiled, assignment_limbs, g1_backend=backend, msm_device=dev)
    synchronize(dev)
    print(f"Groth16 prove (device-packed witness, G1 MSMs {backend}): "
          f"{time.time()-t0:.2f}s")

    # verify (pok_sig.rs:39-47)
    t0 = time.time()
    assert verify(pk.vk, public_inputs, proof)
    print(f"Groth16 verify: OK {time.time()-t0:.2f}s")

    bad = list(public_inputs)
    bad[1] = (bad[1] + 1) % params.q
    assert not verify(pk.vk, bad, proof)
    print("tampered public input rejected")


if __name__ == "__main__":
    main()
