"""Command-line entry: python -m falcon_r1cs_tpu_torch <command>.

The port's counterpart of `python -m falcon_r1cs_tpu`, with the same
commands, defaults and exit codes (the reference exposes `cargo run
--example constraint_counts` and `--example pok_sig`):

  counts           golden constraint-count table, both parameter sets
                   (host only)
  pok-sig [n]      keygen -> sign -> synthesize -> witness -> sat-check
                   -> Groth16 setup/prove/verify   (512 or 1024)
  aggregate ...    batched wire-bytes -> witness -> sat verdict
                   (--k, --n, --prove K)
  selftest         golden drive: counts + satisfiability for verify-512
                   (host only)
  verify [k]       batched signature verification on the device (demo on
                   freshly generated instances, the last one tampered)

pok-sig, aggregate and verify run on the card: `--device` (default cuda)
names the torch device, and `--device cpu` asks for the CPU.  pok-sig and
aggregate take `--g1-backend {auto,native,gpu,python}`, the backend of
the proof's witness map and G1 MSMs: "auto" (the default) is the card on
`--device cuda` (gpu) and the host C on `--device cpu` (native);
`--g1-backend native` asks for the host C on any device.  Without a card
and without `--device cpu` a command exits with code 2 and says so.
"""

from __future__ import annotations

import argparse
import sys

from .utils.device import DeviceUnavailableError, entry_device


def _selftest(argv) -> int:
    argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch selftest").parse_args(argv)
    import numpy as np

    from . import ConstraintSystem, FalconNTTVerificationCircuit, get_params
    from .falcon import make_instance

    rng = np.random.default_rng(0)
    inst = make_instance(rng, get_params(512))
    cs = ConstraintSystem()
    FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
    golden = (1025, 78386, 81460)
    got = (
        cs.num_instance_variables,
        cs.num_witness_variables,
        cs.num_constraints,
    )
    ok = got == golden and cs.is_satisfied()
    print(f"verify-512 counts {got} vs golden {golden}; satisfied={ok}")
    return 0 if ok else 1


def _verify_demo(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch verify")
    ap.add_argument("k", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = entry_device(args.device)
    import numpy as np

    from .falcon import make_instance, verify_batch
    from .params import FALCON_512

    k = args.k
    rng = np.random.default_rng(0)
    insts = [make_instance(rng, FALCON_512, msg=b"m%d" % i) for i in range(k)]
    h = np.stack([i.h for i in insts])
    s2 = np.stack([i.sig_signed for i in insts])
    msgs = [i.msg for i in insts]
    msgs[-1] = b"tampered"
    out = verify_batch(h, msgs, [i.nonce for i in insts], s2, FALCON_512, device=dev)
    print(f"batched device verification ({k} sigs, last tampered):",
          out.tolist())
    return 0 if out[:-1].all() and not out[-1] else 1


def _run(cmd: str, rest: list[str]) -> int:
    if cmd == "counts":
        from .examples import constraint_counts

        constraint_counts.main(rest)
        return 0
    if cmd == "pok-sig":
        from .examples import pok_sig

        pok_sig.main(rest)
        return 0
    if cmd == "aggregate":
        from .examples import aggregate_sig

        aggregate_sig.main(rest)
        return 0
    if cmd == "selftest":
        return _selftest(rest)
    if cmd == "verify":
        return _verify_demo(rest)
    print(f"unknown command {cmd!r}\n")
    print(__doc__)
    return 2


def main(argv: list[str]) -> int:
    """Run one command; returns its exit code (argparse's own on a usage
    error or --help, 2 when the device is a card that is not there)."""
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        return _run(argv[0], list(argv[1:]))
    except DeviceUnavailableError as e:
        print(f"{argv[0]}: {e}", file=sys.stderr)
        return 2
    except SystemExit as e:  # argparse: usage error or --help
        return e.code if isinstance(e.code, int) else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
