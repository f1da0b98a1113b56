"""Golden-count benchmark: the analog of the reference's
`examples/constraint_counts.rs` (`falcon-r1cs/examples/
constraint_counts.rs:12-138`), printing the same table for BOTH parameter
sets in one run (runtime config instead of cargo features).

The port's counterpart of the repo's `examples/constraint_counts.py`, on
the port's own host layer; it runs on the host only and prints the same
text.

    python -m falcon_r1cs_tpu_torch counts [--n 512|1024]
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import (
    ConstraintSystem,
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
    Q,
)
from ..circuits import const_q_power_vars
from ..falcon import make_instance, ntt
from ..gadgets import NTTPolyVar, PolyVar, enforce_less_than_q, ntt_param_var
from ..params import get_params
from ..utils.counters import CounterLog


def count_ntt_conversion(params, rng):
    cs = ConstraintSystem()
    param_vars = ntt_param_var(cs, params)
    poly = rng.integers(0, Q, size=params.n)
    poly_var = PolyVar.alloc_vars(cs, poly, "witness")
    const_vars = const_q_power_vars(cs, params)
    before = cs.counters()
    out = NTTPolyVar.ntt_circuit(cs, poly_var, const_vars, param_vars, params)
    after = cs.counters()
    clear = ntt(poly)
    assert [v._val() for v in out.coeff()] == [int(x) for x in clear]
    assert cs.is_satisfied()
    return tuple(a - b for a, b in zip(after, before))


def count_circuit(cls, inst):
    cs = ConstraintSystem()
    cls.build_circuit(inst).generate_constraints(cs)
    assert cs.is_satisfied()
    return cs.counters()


def section_breakdown(inst):
    """Per-section counter demo (the aux-subsystem replacement for the
    reference's commented-out println probes, SURVEY.md section 5)."""
    cs = ConstraintSystem()
    log = CounterLog(cs)
    params = inst.params
    with log.section("constants"):
        const_q_power_vars(cs, params)
        ntt_param_var(cs, params)
    with log.section("alloc sig"):
        sig_var = PolyVar.alloc_vars(cs, inst.sig_lifted, "witness")
    with log.section("range proofs (one coeff)"):
        enforce_less_than_q(cs, sig_var.coeff()[0])
    return log.table()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m falcon_r1cs_tpu_torch counts")
    ap.add_argument("--n", type=int, choices=(512, 1024), default=None)
    args = ap.parse_args(argv)
    ns = [args.n] if args.n else [512, 1024]
    rng = np.random.default_rng(0)
    for n in ns:
        params = get_params(n)
        inst = make_instance(rng, params)
        print(f"Falcon-{n}:        # instance variables |      # witness |      #constraints |")
        rows = [
            ("ntt conversion", count_ntt_conversion(params, rng)),
            ("verify with ntt", count_circuit(FalconNTTVerificationCircuit, inst)),
            ("verify with dual ntt", count_circuit(FalconDualNTTVerificationCircuit, inst)),
            ("verify with schoolbook", count_circuit(FalconSchoolBookVerificationCircuit, inst)),
        ]
        for name, (i, w, c) in rows:
            print(f"{name:22s} {i:20} | {w:14} | {c:17} |")
        print()
        print(section_breakdown(inst))
        print()


if __name__ == "__main__":
    main()
