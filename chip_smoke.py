"""Chip smoke of the PyTorch + CUDA port (falcon_r1cs_tpu_torch).

Drives the port's paths once on one CUDA card at full Falcon-1024 width:

- the main path: 1024 distinct wire-format signatures ->
  ProverInputPipeline -> packed verify-with-NTT witnesses -> CRT
  satisfiability verdict, with the default v chain and with the fused
  INTT + hint kernel;
- the dual-NTT path: 512 signatures -> circuit_witness engine + packer ->
  CRT verdict plus the host check of the field rows;
- the schoolbook path: 128 signatures -> circuit_witness engine + packer
  (1,150,004 witnesses of 8 limbs each) -> CRT verdict plus field rows;
- the Groth16 path: one signature of the main path's batch -> its packed
  witness as prover scalars -> `prove()` at its defaults (g1_backend
  "auto" on the CUDA msm_device: "gpu"), whose witness
  map (domain 2^18) runs on the Fr kernels and whose four G1 MSMs (n_pad
  = 2^18) run on the recode, Fq and merge-level kernels, against the
  native C prover with the same r and s; h from the card against the
  native C's witness map limb for limb (also at 2^21 in the large phase
  and 2^17 in the tools phase); each MSM against the native C MSM;
- the semi-carry hint path: `ntt_with_hints_v3` on 1024 rows of
  Falcon-1024 coefficients, one launch of the semi-carry kernel (its
  hints epilogue, which normalises and divides by q in registers), its
  (t, b) equal to the hint kernel's on the same rows;
- device verify: `falcon.verify_batch` on the main path's 1024
  signatures with three rows tampered, its verdicts equal to its CPU run;
- the user entry points: `python -m falcon_r1cs_tpu_torch` in-process
  (`selftest`, `verify 1024`, `aggregate --n 1024 --k 1024`, `pok-sig
  1024`, `aggregate --n 1024 --k 8 --prove 2`), each exit code 0,
  aggregate and pok-sig launching K1, and the two proving commands, at
  their default backend, the recode, K4, K5, K6, the merge level and the
  six Fr kernels of a warm witness map; and `entry()`'s step;
- the parallel layer at world size 1 over NCCL, in-process: the DP,
  dual and schoolbook sharded engines on the main, dual and schoolbook
  batches, gathered equal to the single-device engines (K1 2 and 4, K3
  1); the sharded CRT check; the sharded MSM over the h query (K4, K5,
  K6), and at windows 5 and 17, which divide 255, over 2^16 tiled points
  on r - 1, all-ones and random full-width scalars, each equal to the
  native C; ntt_sharded at D = 1; `dryrun_multichip(1)` in a spawned rank;
  `scaling_sweep`'s one point;
- the large prover and K-fold MSM tools (`falcon_r1cs_tpu_torch.tools`):
  schoolbook-1024 (K3 once, four G1 MSMs of n_pad 2^21) and dual-1024 (K1
  four times, four of 2^18) proven with `g1_backend="gpu"` by
  `prove_large.run`, each proof identical to the native C's with the same
  r and s, verified, a tampered input and a swapped proof rejected; the
  2^21-point h-query MSM alone against the native C, its stages and its
  peak device memory at the card's group (a quarter of its memory) and at
  one window a group (the 6 GB rule before); half-digit
  scalars on 2^21 tiled points through `g1_msm_gpu` and
  `g1_msm_gpu_multi` (K = 2), equal to the native C and the group law;
  `msm_multi.run` at 2^18 for K = 1, 2, 4 against the native C's
  `g1_msm_multi`; `prove_batch_large.run` at dual-1024, K = 2, on gpu and
  on native with the same r and s, identical proofs;
- the Falcon-512 tools: `profile_prove.run` (verify-with-NTT, 81,460
  constraints, a fresh setup) with the four G1 MSMs (n_pad 2^17) on the
  card, each equal to the native C's and split into device recode, device
  window sums and host fold, the proof identical to the native C prover's
  with the same r and s; `prove_batch.run` at K = 4 (the K witnesses from
  one engine call, K1 twice) on gpu and native, every proof equal to its
  native single prove; `pp_vs_dp.run` over 2 ranks, refused on one card;
- the benchmark: `bench_torch.py`'s four cells (BENCHMARK.json), the
  main path from wire bytes at B = 1024, the Falcon-512 prove with the
  G1 MSMs on the card, the dual-NTT witnesses of B = 512 decoded
  signatures and the schoolbook witnesses of B = 128, each once at
  `--samples 3 --seconds 0`: gate passed, every metric the file names
  printed and positive.

It builds the kernels from csrc/, checks that each path launched its
kernels (counts set to 0 just before the path, read just after), holds
each kernel against its plain torch version on the card (all integer
arithmetic: bit-exact, the MSM's recode kernel at 2^17 and 2^21 points
(K = 1 and 4, infinity points, its overflow flag) and its merge-level
kernel at the 2^17 and 2^18 window groups (levels 1, 2 and the root, the
bucket planes included) and the witness map's seven Fr kernels at the
Falcon-1024 prove's 2^18 included, except the
Fq kernels K4, K5 and K6, whose
coordinates must agree mod q, compared in canonical form, and whose flags
must be equal; K5 and K6 also on rows far from canonical; K1 and K2 also
on rows of all q - 1, all 0 and one-hot), and times both with CUDA events,
K1, K2, K4, K5, K6 and K8 also by profiler device time, with their
ptxas registers, stack, spill and shared memory (K8: both epilogues).
Each kernel's bound is the larger of its bytes over the card's memory
rate and its int32 multiply(-add)s over the card's int32 rate (H100_*
below); K8's operations are the compiled kernel's own SASS, pipe by pipe
(`sass_pipe_ops`).  K7's launch
path is costed step by step beside torch.add.

    python3 chip_smoke.py

Exits non-zero, printing no result, when no CUDA card is present or any
check fails.  The last line of standard output is one JSON object with
the device; the line before it is the card's name and power limit, and
the line before that the per-kernel JSON record.
"""

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_SIGS = 1024          # the main path's batch
N_TRACE = 2            # signatures held against the host trace
N_SAT = 64             # signatures through the CRT check
N_DUAL = 512           # the dual-NTT path's batch (bench.py bench_dual)
N_DUAL_SAT = 16
N_SB = 128             # the schoolbook path's batch (bench.py bench_schoolbook)
N_SB_TRACE = 1
N_SB_SAT = 4
M_FQ = 1 << 16         # points per Fq kernel launch in the kernel-vs-plain phase
TIMING_REPS = 20
# the large phase: the K-fold MSM's K (tools.msm_multi) and the batch's K
# (tools.prove_batch_large), the first to shrink if the smoke nears its limit
LARGE_KS = (1, 2, 4)
LARGE_BATCH_K = 2
# the tools phase's batch (tools.prove_batch, Falcon-512)
TOOLS_BATCH_K = 4
# the CLI phase's commands, run in-process on the card (the default device)
# (the two that prove at their default backend, which is the card's)
CLI_COMMANDS = (["selftest"], ["verify", "1024"], ["aggregate", "--n", "1024", "--k", "1024"],
                ["pok-sig", "1024"], ["aggregate", "--n", "1024", "--k", "8", "--prove", "2"])
# the kernels a prove on the card launches: the G1 MSMs' (K4 where a CRS
# is converted, as each command's fresh proving key is) and a warm
# witness map's
PROVE_KERNELS = ("signed_digits_kernel", "mont_mul_kernel", "point_add_kernel",
                 "point_add_aff_kernel", "bucket_level_kernel", "fr_to_mont_kernel",
                 "fr_spmv_kernel", "fr_ntt_tile_kernel", "fr_ntt_stage_kernel",
                 "fr_quotient_kernel", "fr_from_mont_kernel")

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s fp32 outside the
# tensor cores = 132 SMs x 128 fp32 lanes x 2 x 1.98 GHz.  An SM has 64 int32
# lanes, so its int32 multiply-add peak is 132 x 64 x 1.98e9 per second.
H100_BYTES_PER_S = 3.35e12
H100_INT32_MAD_PER_S = 132 * 64 * 1.98e9
# Each of an SM's four partitions issues one warp instruction a clock, 128
# lanes a clock an SM.  The integer ALU pipe (these opcodes) has 64 lanes
# an SM; IMAD (multiplies, and the adds and moves the compiler puts there)
# issues on the FMA pipe, also 64 lanes, beside it.
H100_ALU_OPCODES = frozenset(
    ("IADD3", "LOP3", "LEA", "SHF", "ISETP", "SEL", "IMNMX", "PRMT", "PLOP3", "BMSK", "SGXT"))
# int32 multiplies of one 381-bit Montgomery product, the least the card
# needs for it: over 12 words of 32 bits (CIOS, R' = 2^384), a b is 144
# word products, each a mul.lo and a mul.hi (288), and the reduction per
# word is m = t_0 q' (1) plus m q (12 words, lo and hi: 24), 12 x 25 = 300;
# 288 + 300 = 588.  A square a a needs only the 12 x 13 / 2 = 78 distinct
# word products (156 multiplies) and the same reduction: 456.  It counts
# the bounds of K4, K5 and K6 alike, whatever form each kernel computes in;
# an equality test of canonical words is a compare, no multiply.  (Before,
# the count followed the 35-limb form of the TPU kernels: 35 x 35 + 34 x
# 35 / 2 + 34 x 35 = 3,010 multiply-adds a product and 35 + 37 x 30 = 1,145
# a CRT equality test.)
MONT_MUL_MULS = 2 * 12 * 12 + 12 * (1 + 2 * 12)
MONT_SQR_MULS = 2 * 12 * 13 // 2 + 12 * (1 + 2 * 12)


def log(*args):
    print(*args, flush=True)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the bytes the function
    must move and its int32 operations (`ops`: the multiply(-add)s of
    K1-K6, K8's SASS in 64-lane units), each over the card's peak rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT32_MAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def record(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops,
           library_ms=None, **extra):
    """One entry of the kernels line, with its `bound`; `extra` keys follow
    the contract's."""
    bound_ms, bound_by = bound(nbytes, ops)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms, **extra,
    )


def sass_pipe_ops(kernel):
    """({alu, imad, issued}, ops) of one kernel of the built library, whose
    mangled name holds `kernel`, a thread: its SASS instructions on the
    integer ALU pipe, its IMADs, every instruction but NOP; and the
    instructions in units of the 64-lane int32 rate, the largest of the
    ALU count, the IMAD count and half the issued count.  The kernel must
    be straight-line code (no branch but the one after EXIT), so what the
    listing holds is what a thread issues."""
    from falcon_r1cs_tpu_torch.ops import _build

    (name, ops), = [(k, v) for k, v in _build.sass_counts(_build.library_path()).items()
                    if kernel in k]
    assert ops["BRA"] <= 1, f"{name} is not straight-line code: {dict(ops)}"
    pipes = {"alu": sum(v for k, v in ops.items() if k in H100_ALU_OPCODES),
             "imad": ops["IMAD"], "issued": sum(v for k, v in ops.items() if k != "NOP")}
    return pipes, max(pipes["alu"], pipes["imad"], pipes["issued"] / 2)


def cuda_ms(fn, reps=TIMING_REPS, inner=5, warmup=3):
    """Median milliseconds per fn() on the current stream: CUDA events
    around `inner` back-to-back calls, `reps` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def max_abs_err(got, want):
    return max(
        int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
        for a, b in zip(got, want)
    )


def counted_run(counted, fn):
    """fn() with every launch count set to 0 just before and read just
    after (the device synchronised): (result, seconds, counts)."""
    for wrapper in counted.values():
        wrapper.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    return out, seconds, {k: w.launches for k, w in counted.items()}


def check_against_trace(port, circuit, insts, packed, instance):
    """The packed witnesses and the instance vector of each signature equal
    the host trace's."""
    from falcon_r1cs_tpu_torch.witness.export_device import unpack

    t0 = time.perf_counter()
    vals = unpack(packed)
    for b, inst in enumerate(insts):
        cs = port.ConstraintSystem()
        circuit.build_circuit(inst).generate_constraints(cs)
        assert vals[b].tolist() == cs.witness_values, f"signature {b} != host trace"
        full = cs.full_assignment()
        assert instance[b].tolist() == full[: instance.shape[1]], f"instance {b}"
    return time.perf_counter() - t0


def check_verdicts(rs, instance, packed, bumps):
    """CRT on the device plus the host field rows, (B,) bool, for the packed
    witnesses and for each (signature, witness slot) bump of one limb-0
    value: all True, then False exactly on the bumped signature.  Returns
    the seconds of the unbumped check and the per-bump (CRT, field) lists."""
    from falcon_r1cs_tpu_torch.witness.export_device import unpack

    base = unpack(packed)
    inst_obj = instance.cpu().numpy().astype(object)

    def verdict(pk, vals):
        torch.cuda.synchronize()
        t = time.perf_counter()
        crt = rs.check_device(rs.witness_residues_from_packed(instance, pk)).cpu()
        field = [
            rs.check_field_rows_host(np.concatenate([inst_obj[b], vals[b]]))
            for b in range(pk.shape[0])
        ]
        return crt.tolist(), field, time.perf_counter() - t

    crt, field, seconds = verdict(packed, base)
    assert all(crt) and all(field), (crt, field)
    outcomes = []
    for sig, slot in bumps:
        bad = packed.clone()
        bad[sig, slot, 0] += 1
        vals = base.copy()
        vals[sig, slot] = unpack(bad[sig : sig + 1, slot : slot + 1])[0, 0]
        crt, field = verdict(bad, vals)[:2]
        both = [c and f for c, f in zip(crt, field)]
        assert [b for b, ok in enumerate(both) if not ok] == [sig], (crt, field)
        outcomes.append((crt, field))
    return seconds, outcomes


def upload(arrays, dev):
    """Rows of small integers (|x| < 2^15) -> (B, n) int16 on the device."""
    return torch.from_numpy(np.stack(arrays).astype(np.int16)).to(dev)


def dual_path(port, dev, insts, counted):
    """The dual-NTT path at n = 1024, B = N_DUAL, through circuit_witness:
    K1 four times per engine call, packed witnesses equal to the host
    trace, CRT plus field rows all True and False exactly where bumped."""
    from falcon_r1cs_tpu_torch.falcon import ntt_torch
    from falcon_r1cs_tpu_torch.witness import circuit_witness

    circuit, n = port.FalconDualNTTVerificationCircuit, 1024
    batch = insts[:N_DUAL]
    sig = upload([i.sig_signed for i in batch], dev)
    pk_ntt = ntt_torch(upload([i.h for i in batch], dev), n)
    hm_ntt = ntt_torch(upload([i.hm for i in batch], dev), n)
    cw = circuit_witness(circuit, n, dev)
    assert cw.export_limbs == 5

    def path():
        return cw.pack(cw.engine(sig, pk_ntt, hm_ntt))

    runs = [counted_run(counted, path) for _ in range(2)]
    for _, _, d in runs:
        assert d == dict.fromkeys(counted, 0) | {"ntt_hints_kernel": 4}, d
    packed, warm_s, launches = runs[-1]
    assert packed.shape == (N_DUAL, 190520, 5) and packed.dtype == torch.int32
    log(f"dual path n={n} B={N_DUAL}: first {runs[0][1]:.3f} s, warm {warm_s:.3f} s; "
        f"launches per call {launches}")

    instance = torch.cat(
        [torch.ones((N_DUAL, 1), dtype=torch.int64, device=dev),
         pk_ntt.long(), hm_ntt.long()], dim=1,
    )
    trace_s = check_against_trace(
        port, circuit, batch[:N_TRACE], packed[:N_TRACE], instance[:N_TRACE]
    )
    log(f"dual: packed witnesses and instance of {N_TRACE} signatures == host "
        f"trace ({trace_s:.1f} s)")

    t0 = time.perf_counter()
    compiled = port.compile_circuit(circuit, batch[0], cache=False)
    rs = port.ResidueSystem(compiled, dev)
    setup_s = time.perf_counter() - t0
    # sig_pos[3] (integer rows) on signature 5; the first is_zero bit
    # (integer rows and its field row) on signature 9
    sat_s, outcomes = check_verdicts(
        rs, instance[:N_DUAL_SAT], packed[:N_DUAL_SAT], [(5, 3), (9, 3 * n)]
    )
    assert not outcomes[1][1][9], "the field row missed the bumped is_zero bit"
    log(f"dual CRT + field rows ({len(compiled.field_rows)} rows): {N_DUAL_SAT} valid -> "
        f"all True ({sat_s:.3f} s; compile + ResidueSystem {setup_s:.1f} s); "
        "bumped sig_pos / is_zero bit -> exactly that signature False")

    dev_ms = cuda_ms(path, reps=5, inner=2)
    eng_ms = cuda_ms(lambda: cw.engine(sig, pk_ntt, hm_ntt), reps=5, inner=2)
    log(f"dual device engine {eng_ms:.3f} ms + packer = {dev_ms:.3f} ms per "
        f"{N_DUAL}-batch = {N_DUAL / dev_ms * 1e3:.1f} witnesses/s device-only")


def schoolbook_path(port, dev, insts, counted):
    """The schoolbook path at n = 1024, B = N_SB, through circuit_witness:
    K3 once per engine call, `valid` all 1, packed witnesses equal to the
    host trace, CRT plus field rows all True and False exactly where
    bumped.  Returns the count of K3 launches of the counted run."""
    from falcon_r1cs_tpu_torch.witness import circuit_witness

    circuit, n = port.FalconSchoolBookVerificationCircuit, 1024
    batch = insts[:N_SB]
    sig = upload([i.sig_lifted for i in batch], dev)
    pk = upload([i.h for i in batch], dev)
    hm = upload([i.hm for i in batch], dev)
    cw = circuit_witness(circuit, n, dev)
    assert cw.export_limbs == 8

    def path():
        seg = cw.engine(sig, pk, hm)
        return seg, cw.pack(seg)

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    (seg, packed), seconds, launches = counted_run(counted, path)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert launches == dict.fromkeys(counted, 0) | {"schoolbook_prods_kernel": 1}, launches
    assert packed.shape == (N_SB, 1150004, 8) and packed.dtype == torch.int32
    assert seg["valid"].tolist() == [1] * N_SB, "schoolbook: an invalid flag"
    log(f"schoolbook path n={n} B={N_SB}: {seconds:.3f} s (first call); launches "
        f"{launches}; packed {packed.numel() * 4 / 1e9:.2f} GB; peak device "
        f"memory {peak_gib:.2f} GiB, of which {held_gib:.2f} GiB held before the path")

    instance = torch.cat(
        [torch.ones((N_SB, 1), dtype=torch.int64, device=dev), pk.long(), hm.long()],
        dim=1,
    )
    trace_s = check_against_trace(
        port, circuit, batch[:N_SB_TRACE], packed[:N_SB_TRACE], instance[:N_SB_TRACE]
    )
    log(f"schoolbook: packed witnesses and instance of {N_SB_TRACE} signature == "
        f"host trace, {packed.shape[1]} values ({trace_s:.1f} s)")

    t0 = time.perf_counter()
    compiled = port.compile_circuit(circuit, batch[0], cache=False)
    rs = port.ResidueSystem(compiled, dev)
    setup_s = time.perf_counter() - t0
    main0 = n + 28 * n  # column 0's block [t, c | n prods | 27 | 5] in the witness
    neq1 = int(seg["iseq"][2, 0, 0])
    mult = main0 + n + (30 if neq1 else 32)  # column 0's unequal is_eq multiplier
    sat_s, outcomes = check_verdicts(
        rs, instance[:N_SB_SAT], packed[:N_SB_SAT], [(1, main0 + 2), (2, mult)]
    )
    crt, field = outcomes[1]
    assert all(crt) and not field[2], "the multiplier bump must fail its field row only"
    log(f"schoolbook CRT + field rows ({len(compiled.field_rows)} rows): {N_SB_SAT} "
        f"valid -> all True ({sat_s:.3f} s; compile + ResidueSystem {setup_s:.1f} s); "
        "bumped mul wire -> CRT False there; bumped is_eq multiplier -> CRT all "
        "True, field rows False exactly there")
    del seg, packed

    dev_ms = cuda_ms(lambda: cw.pack(cw.engine(sig, pk, hm)), reps=5, inner=2)
    eng_ms = cuda_ms(lambda: cw.engine(sig, pk, hm), reps=5, inner=2)
    log(f"schoolbook device engine {eng_ms:.3f} ms + packer = {dev_ms:.3f} ms per "
        f"{N_SB}-batch = {N_SB / dev_ms * 1e3:.1f} witnesses/s device-only")
    return launches["schoolbook_prods_kernel"]


def k5_per_group(n_pad: int, window: int) -> int:
    """K5 launches of one window group of the MSM engine: one per merge
    tree level above level 1, then the weighted bucket sum's tree sums and
    suffix scans (snark/gpu_msm.py)."""
    from falcon_r1cs_tpu_torch.snark import gpu_msm

    def scan(nbk):  # _hs_suffix_weighted: shift steps, then the tree
        p2 = 1 << max(1, (nbk - 2).bit_length())
        return 2 * (p2.bit_length() - 1)

    levels = n_pad.bit_length() - 2
    nb = (1 << (window - 1)) + 1
    if not gpu_msm._wsum_decomp(nb):
        return levels + scan(nb)
    cl = gpu_msm.wsum_weights(nb)[0]
    ch = (nb - 1) // cl
    return levels + (cl.bit_length() - 1) + (ch.bit_length() - 1) + scan(ch) + scan(cl)


def msm_launches(counted, n: int, K: int = 1, window: int | None = None,
                 nw: int | None = None) -> dict:
    """The launches of one MSM (K = 1, g1_msm_gpu, or the sharded MSM at
    one rank) or one K-fold MSM (g1_msm_gpu_multi) over n cached points
    at `window` (default 12) with nw windows an MSM (default ceil(255 /
    w); the sharded MSM's is n_windows_carry(w)) (+1 K4 when the point
    set is new): the recode once, K6 once, K5 k5_per_group times and the
    merge-level kernel once a level (log2 n_pad) a window group, the
    K x nw windows in groups of _group_windows."""
    from falcon_r1cs_tpu_torch.ops.msm_recode import n_windows
    from falcon_r1cs_tpu_torch.snark import gpu_msm

    window = gpu_msm.WINDOW if window is None else window
    nw = K * (n_windows(window) if nw is None else nw)
    n_pad = max(8, 1 << (n - 1).bit_length())  # 2^18 at Falcon-1024
    groups = nw // gpu_msm._group_windows(n_pad, nw, device="cuda")
    return dict.fromkeys(counted, 0) | {
        "signed_digits_kernel": 1, "point_add_aff_kernel": groups,
        "point_add_kernel": groups * k5_per_group(n_pad, window),
        "bucket_level_kernel": groups * (n_pad.bit_length() - 1)}


def witness_map_launches(counted, compiled, proves: int = 1) -> dict:
    """The Fr kernels' launches of `proves` witness maps on the card
    (snark/gpu_qap.py) over `compiled`'s domain of 2^k points, the first
    with the set-up of its cache (the CSR values of A, B and C entered,
    four tables): z entered, three sparse products, seven transforms (k -
    10 wide stages each; the tiles of the first six in one round-trip
    launch, the last one's alone), the quotient, the exit: 8 + 7 (k - 10)
    a warm map."""
    from falcon_r1cs_tpu_torch.ops.fr import TILE_LOG
    from falcon_r1cs_tpu_torch.snark.qap import qap_domain

    wide = max(0, qap_domain(compiled).log_size - TILE_LOG)
    return {k: v for k, v in {
        "fr_to_mont_kernel": proves + 3, "fr_spmv_kernel": 3 * proves,
        "fr_ntt_tile_kernel": 2 * proves, "fr_ntt_stage_kernel": 7 * wide * proves,
        "fr_quotient_kernel": proves, "fr_from_mont_kernel": proves,
        "fr_powers_kernel": 4}.items() if k in counted}


def check_h_on_card(compiled, z, dev, h) -> float:
    """witness_map_gpu(compiled, z) on the card equals the native C's h
    limb for limb, top coefficient 0; returns its host ms to the top
    coefficient's read (the cache warm)."""
    from falcon_r1cs_tpu_torch.snark.gpu_qap import witness_map_gpu

    t0 = time.perf_counter()
    got, top = witness_map_gpu(compiled, z, dev)
    ms = (time.perf_counter() - t0) * 1e3
    assert top == 0 and got.device.type == "cuda", top
    assert np.array_equal(got.cpu().numpy().view(np.uint64), h), "h on the card != native C"
    return ms


# the sharded MSM at the windows that divide 255: points tiled from 8 base
# points (tools.msm_multi.tiled_points), padded to 2^16
CARRY_MSM_N = (1 << 16) - 3
CARRY_MSM_WINDOWS = (5, 17)


def carry_msm_scalars(n: int) -> dict:
    """{name: (n, 4) u64}: r - 1, all ones below 2^255 and random scalars
    below 2^255 on every point (at ceil(255 / w) windows the top window
    carries out of the first two at w = 5 and 17, and of ~45 % of the
    third)."""
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R

    def rows(value):
        return np.tile(np.array([value >> (64 * j) & (2**64 - 1) for j in range(4)],
                                dtype=np.uint64), (n, 1))

    rand = np.random.default_rng(20261030).integers(0, 2**64, size=(n, 4), dtype=np.uint64)
    rand[:, 3] >>= np.uint64(1)
    return {"r-1": rows(R - 1), "ones": rows((1 << 255) - 1), "random": rand}


def carry_msm_cases(counted, mesh) -> dict:
    """g1_msm_gpu_sharded on the world-1 mesh at windows 5 and 17 over
    CARRY_MSM_N tiled points, on each of carry_msm_scalars: each equal to
    the native C MSM, with the launches of one MSM of n_windows_carry(w)
    windows (52 and 16), K4 once on the new point set.  Returns
    {f"msm w={w}": the first run's launches}."""
    from falcon_r1cs_tpu_torch.ops.msm_recode import n_windows, n_windows_carry
    from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend
    from falcon_r1cs_tpu_torch.tools.msm_multi import tiled_points

    _, pts = tiled_points(CARRY_MSM_N)
    out, cold = {}, 1
    for window in CARRY_MSM_WINDOWS:
        nw = n_windows_carry(window)
        assert nw == n_windows(window) + 1, (window, nw)
        for name, sc in carry_msm_scalars(CARRY_MSM_N).items():
            want_counts = msm_launches(counted, CARRY_MSM_N, window=window, nw=nw)
            want_counts["mont_mul_kernel"] = cold
            got, seconds, counts = counted_run(
                counted, lambda: gpu_msm.g1_msm_gpu_sharded(pts, sc, window, mesh))
            assert counts == want_counts, (window, name, counts, want_counts)
            t0 = time.perf_counter()
            want = native_backend.g1_msm(pts, sc)
            native_s = time.perf_counter() - t0
            assert got == want and want is not None, f"sharded MSM w={window} {name} != native C"
            out.setdefault(f"msm w={window}", {k: v for k, v in counts.items() if v})
            log(f"parallel MSM w={window} ({nw} windows) n={CARRY_MSM_N} tiled, {name} "
                f"scalars: sharded {seconds:.3f} s{' cold' if cold else ''} against the "
                f"native C {native_s:.3f} s (host clock, one sample each); == native C; "
                f"launches {out[f'msm w={window}'] if cold else 'as msm_launches'}")
            cold = 0
    return out


def device_kernel_ms(fn, keep=("point_add",)):
    """(wall ms, device ms of all CUDA kernels, the top 8 kernels and any
    other whose name holds one of `keep`, the count of all kernel
    launches) of one fn() run under torch.profiler; device time sums the
    CUDA rows only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler keeps only device activity stamped after its start,
        # which it reads on the host's clock: a launch right after the
        # start can land before it and be dropped, so start launching later
        # (50 ms dropped one launch of ten in three windows running on a
        # loaded host), and leave the last records time to arrive
        time.sleep(0.2)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        time.sleep(0.05)
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def us(e):
        v = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if v is None else v

    rows.sort(key=us, reverse=True)
    busy = sum(us(e) for e in rows) / 1e3
    shown = rows[:8] + [e for e in rows[8:] if any(k in e.key for k in keep)]
    return (wall, busy, [(e.key[:60], us(e) / 1e3, e.count) for e in shown],
            sum(e.count for e in rows))


def groth16_path(port, dev, compiled, packed, instance, counted):
    """One Falcon-1024 verify-with-NTT proof with the witness map and the
    G1 MSMs on the card: setup on the host, the assignment from the main
    path's packed export, prove() at its default backend ("auto" on the
    default CUDA msm_device: "gpu") identical to
    prove(g1_backend="native") with the same r and s, its launches those
    of the four MSMs and of one witness map with its tables' set-up, h
    from the card equal to the native C's, verify True and False on a
    tampered proof or input; then each of the four G1 MSMs against the
    native C MSM, cold (with the K4 conversion) and warm.  Returns the
    prove run's launch counts, the h query's MSM (points, scalars) and
    (compiled, z)."""
    from falcon_r1cs_tpu_torch.snark import gpu_msm, groth16, native_backend
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R
    from falcon_r1cs_tpu_torch.snark.points import ints_to_limbs, packed_to_limb_rows

    assert native_backend.available(), "the native C Groth16 backend did not build"
    rng = np.random.default_rng(20261018)
    t0 = time.perf_counter()
    pk = groth16.setup(
        compiled, toxic=groth16.SetupToxic(*(int.from_bytes(rng.bytes(32), "little") % R
                                             for _ in range(5)))
    )
    log(f"groth16 setup (host, native C fixed-base): {time.perf_counter() - t0:.1f} s")
    public = instance[0].tolist()
    z = np.concatenate([ints_to_limbs(public, 4), packed_to_limb_rows(packed[0].cpu().numpy())])
    assert len(z) == compiled.num_variables
    r, s = (int.from_bytes(rng.bytes(32), "little") % R for _ in range(2))

    assert groth16.resolve_g1_backend() == "gpu", "prove's default backend is not the card's"
    proof, gpu_s, launches = counted_run(counted, lambda: groth16.prove(pk, compiled, z, r=r, s=s))
    t0 = time.perf_counter()
    groth16.prove(pk, compiled, z, r=r, s=s, g1_backend="gpu")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = groth16.prove(pk, compiled, z, r=r, s=s, g1_backend="native")
    native_s = time.perf_counter() - t0
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c), "gpu proof != native"
    t0 = time.perf_counter()
    assert groth16.verify(pk.vk, public, proof), "the proof does not verify"
    verify_s = time.perf_counter() - t0
    bad = list(public)
    bad[1] = (bad[1] + 1) % port.Q
    assert not groth16.verify(pk.vk, bad, proof), "a wrong public input verified"
    assert not groth16.verify(pk.vk, public, groth16.Proof(a=proof.c, b=proof.b, c=proof.a))
    h, _ = native_backend.witness_map(compiled, z)
    ni = compiled.num_instance
    msms = [("a", pk.a_query, z), ("b_g1", pk.b_g1_query, z),
            ("l", pk.l_query, z[ni:]), ("h", pk.h_query, h)]

    expect = {k: sum(msm_launches(counted, len(p))[k] for _, p, _ in msms) for k in counted}
    expect["mont_mul_kernel"] = len(msms)  # each new point set converts once
    expect |= witness_map_launches(counted, compiled)
    assert launches == expect, (launches, expect)
    wm_ms = check_h_on_card(compiled, z, dev, h)
    log(f"groth16 prove, default g1_backend (auto: gpu): {gpu_s:.3f} s (first, incl. the CRS "
        f"conversion and the witness map's tables), {warm_s:.3f} s (second); native: "
        f"{native_s:.3f} s; identical proofs; verify True "
        f"({verify_s:.3f} s), wrong input / tampered proof False; launches {launches}; "
        f"h on the card (2^{len(h).bit_length()}) == native C, {wm_ms:.2f} ms warm (host "
        "clock to the top coefficient's read)")

    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    for name, pts, sc in msms:
        t0 = time.perf_counter()
        want = native_backend.g1_msm(pts, sc)
        nat_s = time.perf_counter() - t0
        del pts._gpu_mont_cache  # time the first use of a point set again
        got, cold_s, d_cold = counted_run(counted, lambda: gpu_msm.g1_msm_gpu(pts, sc))
        got2, warm_s, d_warm = counted_run(counted, lambda: gpu_msm.g1_msm_gpu(pts, sc))
        assert got == want and got2 == want, f"MSM {name} != native"
        assert d_warm == msm_launches(counted, len(pts)), d_warm
        assert d_cold == d_warm | {"mont_mul_kernel": 1}, d_cold
        log(f"G1 MSM {name} n={len(pts)}: gpu cold {cold_s:.3f} s, "
            f"warm {warm_s:.3f} s; native C {nat_s:.3f} s; equal")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"G1 MSM peak device memory {peak_gib:.2f} GiB, of which {held_gib:.2f} GiB "
        "held before")

    # where one warm MSM's time goes: device recode, device window sums, host fold
    msm_stages(dev, counted, pk.h_query, h, "h")
    return launches, (pk.h_query, h), (compiled, z)


def semi_path(dev, counted):
    """The semi-carry hint entry at n = 1024, B = N_SIGS: exactly one
    launch of K8 and none of any other kernel, (t, b) equal to K1's on the
    same rows.  Returns the launch counts of the counted run."""
    from falcon_r1cs_tpu_torch import FALCON_1024, Q
    from falcon_r1cs_tpu_torch.ops import cuda_ntt, ntt_v3

    p = FALCON_1024
    x = torch.from_numpy(
        np.random.default_rng(20261020).integers(0, Q, size=(N_SIGS, p.n))
        .astype(np.int32)
    ).to(dev)
    (t, b), seconds, launches = counted_run(counted, lambda: ntt_v3.ntt_with_hints_v3(x, p))
    assert launches == dict.fromkeys(counted, 0) | {"ntt_semi_kernel": 1}, launches
    t1, b1 = cuda_ntt.ntt_with_hints_cuda(x, p)
    assert t.shape == (11, N_SIGS, p.n) and b.shape == (N_SIGS, p.n)
    assert torch.equal(t, t1) and torch.equal(b, b1), "ntt_with_hints_v3 != K1"
    log(f"semi-carry path n={p.n} B={N_SIGS}: {seconds:.3f} s (first call); launches "
        f"{launches}; (t, b) == the hint kernel's")
    return launches


def verify_phase(port, dev, insts, counted, card):
    """Device verify at Falcon-1024, B = N_SIGS, on the smoke's signatures
    with three rows tampered: a changed message (row 1), s2 past the norm
    bound (row 2), a coefficient |s2| > q/2 of the same residue (row 3,
    which verify_batch re-signs after % q, so it stays valid).  The card's
    verdicts equal verify_batch(device="cpu") row for row, all True on the
    untouched rows; no kernel of the port is launched (a chain of torch
    ops, as the JAX package's is of jnp ops).  Times: host hash-to-point,
    the device check alone (CUDA events) and its kernels under the
    profiler, the whole call; medians of 7 samples each."""
    from falcon_r1cs_tpu_torch.falcon import hash_to_point_batch, verify_batch
    from falcon_r1cs_tpu_torch.falcon.instances import _verify_cached

    params = port.FALCON_1024
    n, B = params.n, N_SIGS
    h = np.stack([i.h for i in insts[:B]])
    s2 = np.stack([i.sig_signed for i in insts[:B]])
    msgs = [i.msg for i in insts[:B]]
    nonces = [i.nonce for i in insts[:B]]
    msgs[1] = b"tampered"
    s2[2] = 4000
    s2[3, 0] += port.Q
    assert not port.falcon.verify(h[3], msgs[3], nonces[3], s2[3], params)

    def call():
        return verify_batch(h, msgs, nonces, s2, params, device=dev)

    got, first_s, launches = counted_run(counted, call)
    assert launches == dict.fromkeys(counted, 0), launches
    want = verify_batch(h, msgs, nonces, s2, params, device="cpu")
    assert got.tolist() == want.tolist(), "verify_batch: the card != the CPU"
    assert [r for r in range(B) if not got[r]] == [1, 2], np.flatnonzero(~got)

    def host_ms(fn, reps=7):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    h2p_ms = host_ms(lambda: hash_to_point_batch(msgs, nonces, n))
    call_ms = host_ms(call)
    check = _verify_cached(n, params.sig_l2_bound)
    hm = hash_to_point_batch(msgs, nonces, n)
    args = tuple(torch.from_numpy(a).to(dev) for a in (s2, h, hm))
    assert check(*args).cpu().numpy().tolist() == got.tolist()
    dev_ms = cuda_ms(lambda: check(*args), reps=7, inner=5)
    wall, busy, top, kernels = device_kernel_ms(lambda: check(*args), keep=())
    log(f"verify_batch n={n} B={B}: the card's verdicts == the CPU's, untouched rows "
        f"all True, rows 1 (message) and 2 (norm) False, row 3 (|s2| > q/2, same "
        f"residue) True; launches {launches}")
    log(f"verify_batch times: host hash-to-point {h2p_ms:.3f} ms, device check "
        f"{dev_ms:.4f} ms (CUDA events; {busy:.4f} ms of {kernels} kernel launches under "
        f"the profiler, idle share {1 - busy / dev_ms:.3f}), whole call "
        f"{call_ms:.3f} ms = {B / call_ms * 1e3:.1f} signatures/s ({B / dev_ms * 1e3:.1f} "
        f"device-only); first call {first_s:.3f} s; {card}")
    for key, ms, count in top:
        log(f"  {ms:9.4f} ms  x{count:<5d} {key}")


def cli_phase(dev, counted):
    """`python -m falcon_r1cs_tpu_torch` in-process on the card, one
    command after another (CLI_COMMANDS), every count set to 0 just before
    each and read just after: each returns 0; aggregate and pok-sig launch
    K1, and a command that proves (pok-sig, and aggregate with --prove),
    at its default backend, every kernel of PROVE_KERNELS: its witness
    maps and G1 MSMs ran on the card.  Then
    entry(): its step on the card launches K1 twice and equals
    entry("cpu").  Returns {command: (seconds, launches)}."""
    from falcon_r1cs_tpu_torch.__main__ import main as cli
    from falcon_r1cs_tpu_torch.entry import entry

    runs = {}
    for argv in CLI_COMMANDS:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc, seconds, launches = counted_run(counted, lambda: cli(argv))
        cmd = " ".join(argv)
        for line in printed.getvalue().splitlines():
            log(f"  | {line[:160]}" + (" ..." if len(line) > 160 else ""))
        assert rc == 0, f"{cmd}: exit code {rc}"
        runs[cmd] = (seconds, {k: v for k, v in launches.items() if v})
        log(f"cli {cmd}: rc 0, {seconds:.1f} s, launches {runs[cmd][1]}")
        if argv[0] in ("aggregate", "pok-sig"):
            assert runs[cmd][1].get("ntt_hints_kernel", 0) > 0, (cmd, runs[cmd])
        if argv[0] == "pok-sig" or "--prove" in argv:
            assert all(runs[cmd][1].get(k, 0) > 0 for k in PROVE_KERNELS), (cmd, runs[cmd])
    step, args = entry(dev)
    got, seconds, launches = counted_run(counted, lambda: step(*args))
    assert launches == dict.fromkeys(counted, 0) | {"ntt_hints_kernel": 2}, launches
    cpu_step, cpu_args = entry("cpu")
    for a, b in zip(got, cpu_step(*cpu_args)):
        assert torch.equal(a.cpu(), b), "entry(): the card != the CPU"
    log(f"entry(): step on (8, 1024) {seconds:.3f} s (first call), launches "
        f"{ {k: v for k, v in launches.items() if v} }, == entry('cpu')")
    return runs


def parallel_phase(port, dev, insts, out, rs, instance, packed, h_msm, counted):
    """The parallel layer at world size 1 on the card, over NCCL, in this
    process (make_mesh(1, 1, "cuda")), at full size, every count set to 0
    just before each sharded call and read just after: the DP engine on
    the main batch (K1 2), the dual engine at B = N_DUAL (K1 4), the
    schoolbook engine at B = N_SB (K3 1), each gathered equal to its
    single-device engine on every key; the sharded CRT check on N_SAT
    signatures, all True and False exactly where bumped; the sharded MSM
    over the h query (2^18 points, window 12) equal to g1_msm_gpu and the
    native C (K4 1 cold, K5 and K6 as msm_launches), and at windows 5 and
    17 over 2^16 tiled points on full-width scalars (carry_msm_cases);
    ntt_sharded at D = 1 equal to the clear NTT; dryrun_multichip(1), a
    spawned rank over NCCL; and scaling_sweep's one point.  Returns {path: launches} of the sharded
    calls."""
    import torch.distributed as dist

    from falcon_r1cs_tpu_torch.entry import dryrun_multichip
    from falcon_r1cs_tpu_torch.falcon import ntt, ntt_torch
    from falcon_r1cs_tpu_torch.parallel import (
        gather_segments,
        make_mesh,
        ntt_sharded,
        place_batch,
        scaling_sweep,
        sharded_engine,
        sharded_engine_dual,
        sharded_engine_schoolbook,
    )
    from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend
    from falcon_r1cs_tpu_torch.witness import (
        witness_engine,
        witness_engine_dual,
        witness_engine_schoolbook,
    )

    n = 1024
    mesh = make_mesh(1, 1, "cuda")
    log(f"parallel: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, backend "
        f"{dist.get_backend()}, world size {dist.get_world_size()}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    sharded = {}

    def engine_case(path, make, single, arrays, kernel, launches):
        """The sharded engine's gathered segments == the single-device
        engine's on every key; its launches; both CUDA-event times."""
        blocks = place_batch(mesh, *arrays)
        run = make(n, mesh)
        got, seconds, counts = counted_run(counted, lambda: gather_segments(mesh, run(*blocks)))
        assert counts == dict.fromkeys(counted, 0) | {kernel: launches}, (path, counts)
        want = single(n)(*blocks)
        assert sorted(got) == sorted(want), (path, sorted(got))
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (path, k)
        sharded_ms = cuda_ms(lambda: gather_segments(mesh, run(*blocks)), reps=5, inner=2)
        single_ms = cuda_ms(lambda: single(n)(*blocks), reps=5, inner=2)
        # at world size 1 each all_gather is NCCL's copy of one segment
        mb = sum(t.numel() * t.element_size() for t in got.values()) / 1e6
        extra = sharded_ms - single_ms
        rate = f"{mb / extra:.1f} GB/s of the difference" if extra > 0 else "no difference"
        log(f"parallel {path} engine B={blocks[0].shape[0]}: gathered == single-device on "
            f"{len(want)} segments; launches {kernel} {launches}; {sharded_ms:.3f} ms "
            f"sharded + gather against {single_ms:.3f} ms single-device (CUDA events): "
            f"{mb:.1f} MB gathered, {rate}; first call {seconds:.3f} s")
        sharded[path] = {kernel: launches}

    sig = np.stack([i.sig_lifted for i in insts[:N_SIGS]])
    engine_case("dp", sharded_engine, witness_engine, (sig, out.pk_ntt, out.hm_ntt),
                "ntt_hints_kernel", 2)
    dual = insts[:N_DUAL]
    engine_case("dual", sharded_engine_dual, witness_engine_dual,
                (np.stack([i.sig_signed for i in dual]),
                 ntt_torch(upload([i.h for i in dual], dev), n),
                 ntt_torch(upload([i.hm for i in dual], dev), n)),
                "ntt_hints_kernel", 4)
    sb = insts[:N_SB]
    engine_case("schoolbook", sharded_engine_schoolbook, witness_engine_schoolbook,
                tuple(np.stack([getattr(i, k) for i in sb]) for k in ("sig_lifted", "h", "hm")),
                "schoolbook_prods_kernel", 1)

    w_res = rs.witness_residues_from_packed(instance[:N_SAT], packed[:N_SAT])
    bad = packed[:N_SAT].clone()
    bad[5, 3, 0] += 1
    t0 = time.perf_counter()
    ok = rs.check_device_sharded(w_res, mesh, "batch").cpu()
    sat_s = time.perf_counter() - t0
    assert ok.tolist() == [True] * N_SAT, ok
    assert torch.equal(ok, rs.check_device(w_res).cpu())
    verdict = rs.check_device_sharded(
        rs.witness_residues_from_packed(instance[:N_SAT], bad), mesh, "batch").cpu()
    assert [b for b in range(N_SAT) if not verdict[b]] == [5], verdict
    log(f"parallel CRT check, rows split over 1 rank: {N_SAT} valid -> all True "
        f"({sat_s:.3f} s, partition and upload included), one bumped witness -> "
        "exactly that signature False")

    pts, sc = h_msm
    warm = msm_launches(counted, len(pts))
    got, cold_s, cold = counted_run(
        counted, lambda: gpu_msm.g1_msm_gpu_sharded(pts, sc, gpu_msm.WINDOW, mesh))
    got2, warm_s, counts = counted_run(
        counted, lambda: gpu_msm.g1_msm_gpu_sharded(pts, sc, gpu_msm.WINDOW, mesh))
    assert cold == warm | {"mont_mul_kernel": 1} and counts == warm, (cold, counts)
    one, one_s, _ = counted_run(counted, lambda: gpu_msm.g1_msm_gpu(pts, sc))
    want = native_backend.g1_msm(pts, sc)
    assert got == want and got2 == want and one == want, "sharded MSM != native C"
    sharded["msm"] = {k: v for k, v in cold.items() if v}
    log(f"parallel MSM h n={len(pts)} (1 shard): sharded cold {cold_s:.3f} s, "
        f"warm {warm_s:.3f} s against g1_msm_gpu warm {one_s:.3f} s (host clock, one "
        f"sample each); == g1_msm_gpu == native C; launches cold {sharded['msm']}")
    sharded.update(carry_msm_cases(counted, mesh))

    x = np.random.default_rng(20261021).integers(0, port.Q, size=(N_SIGS, n)).astype(np.int32)
    got = ntt_sharded(mesh, port.FALCON_1024)(torch.from_numpy(x).to(dev))
    assert np.array_equal(got.cpu().numpy(), ntt(x)), "ntt_sharded at D = 1 != the clear NTT"
    log(f"parallel ntt_sharded D=1 B={N_SIGS}: == the clear NTT")

    t0 = time.perf_counter()
    checked = dryrun_multichip(1)
    log(f"parallel dryrun_multichip(1), one spawned rank over NCCL: {checked} passed "
        f"({time.perf_counter() - t0:.1f} s)")
    pts_sweep = scaling_sweep(n, N_SIGS)
    assert [p.devices for p in pts_sweep] == [1], pts_sweep
    log(f"parallel scaling_sweep({n}, {N_SIGS}): {pts_sweep[0].witnesses_per_sec:.1f} "
        f"witnesses/s device-only engine, 1 rank (no scaling figure: one card)")
    dist.destroy_process_group()
    return sharded


def sublog(line):
    log(f"  | {line}")


def large_prove(dev, counted, which, witness_launches, seed):
    """`tools.prove_large.run(which, 1024, "gpu")` with the setup's toxic
    waste and r, s from `seed`: the witness at B = 1, a fresh setup, the
    prove cold (K4 4 times, the CRS conversion) and warm, verify, the
    tampered public input rejected; every count set to 0 just before the
    run and read just after: exactly `witness_launches`, K4 4, and K5 and
    K6 twice (cold and warm) msm_launches summed over the four MSMs.  The
    proof equals prove(g1_backend="native")'s with the same r, s, and a
    swapped proof is rejected.  Returns (the run's result, the launches,
    the four MSMs as (name, points, scalars))."""
    from falcon_r1cs_tpu_torch import Q
    from falcon_r1cs_tpu_torch.snark import groth16, native_backend
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R
    from falcon_r1cs_tpu_torch.tools import prove_large

    rng = np.random.default_rng(seed)
    draw = [int.from_bytes(rng.bytes(32), "little") % (R - 1) + 1 for _ in range(7)]
    toxic, (r, s) = groth16.SetupToxic(*draw[:5]), draw[5:]
    out, seconds, launches = counted_run(
        counted, lambda: prove_large.run(which, 1024, "gpu", dev, toxic=toxic, r=r, s=s,
                                         log=sublog))
    pk, compiled, z, publics, proof = (out[k] for k in ("pk", "compiled", "assignment",
                                                        "publics", "proof"))
    h, _ = native_backend.witness_map(compiled, z)
    ni = compiled.num_instance
    msms = [("a", pk.a_query, z), ("b_g1", pk.b_g1_query, z), ("l", pk.l_query, z[ni:]),
            ("h", pk.h_query, h)]
    expect = {k: 2 * sum(msm_launches(counted, len(p))[k] for _, p, _ in msms) for k in counted}
    expect |= {"mont_mul_kernel": len(msms)} | witness_launches
    expect |= witness_map_launches(counted, compiled, proves=2)
    assert launches == expect, (which, launches, expect)
    wm_ms = check_h_on_card(compiled, z, dev, h)
    t0 = time.perf_counter()
    want = groth16.prove(pk, compiled, z, r=r, s=s, g1_backend="native")
    native_s = time.perf_counter() - t0
    assert (proof.a, proof.b, proof.c) == (want.a, want.b, want.c), f"{which}: gpu proof != native"
    assert not groth16.verify(pk.vk, publics, groth16.Proof(a=proof.c, b=proof.b, c=proof.a))
    bad = list(publics)
    bad[-1] = (bad[-1] + 1) % Q
    assert not groth16.verify(pk.vk, bad, proof), f"{which}: a tampered input verified"
    sec = out["seconds"]
    log(f"{which}-1024 prove, g1_backend=gpu: setup {sec['setup (CRS)']:.1f} s, prove cold "
        f"{sec['prove (cold)']:.3f} s (with the CRS conversion), warm {sec['prove (warm)']:.3f} "
        f"s; native C prove {native_s:.3f} s, identical proof; verify True "
        f"({sec['verify']:.3f} s), tampered input / swapped proof False; MSM points "
        f"{[len(p) for _, p, _ in msms]}; peak device memory {out['peak_device_gib']:.2f} GiB "
        f"over the run; launches {({k: v for k, v in launches.items() if v})}; h on the card "
        f"== native C, {wm_ms:.2f} ms warm; {seconds:.1f} s in all")
    return out, launches, msms


# the device recode's ms (host clock to a synchronise, the scalar upload
# included) of each msm_stages call, by n_pad: the recode record reports them
MSM_RECODE_MS = {}


def msm_stages(dev, counted, pts, sc, name):
    """One warm g1_msm_gpu over `pts` (their Montgomery form cached)
    against the native C, then where its time goes, by
    tools.profile_prove.msm_split: the device recode (into
    MSM_RECODE_MS), the device window sums
    (CUDA events, 3 samples each in turns, with their peak device memory)
    at the card's group (a quarter of its memory) and, where it differs,
    at the group of the 6 GB rule (the JAX engine's, the port's before),
    their kernels under the profiler, the host fold."""
    from falcon_r1cs_tpu_torch.snark import gpu_msm
    from falcon_r1cs_tpu_torch.tools import profile_prove

    n_pad = max(8, 1 << (len(pts) - 1).bit_length())
    nw = (255 + gpu_msm.WINDOW - 1) // gpu_msm.WINDOW
    default = gpu_msm._group_windows(n_pad, nw, device=dev)
    groups = tuple(dict.fromkeys((default, gpu_msm._group_windows(n_pad, nw))))
    sp, _, d = counted_run(counted, lambda: profile_prove.msm_split(
        pts, sc, dev, groups=groups, samples=3))
    want = msm_launches(counted, len(pts))
    assert sp["launches"] == {k: want[k] for k in sp["launches"]}, sp["launches"]
    assert not any(v for k, v in d.items() if k not in sp["launches"]), d
    MSM_RECODE_MS.setdefault(n_pad, []).append(sp["recode_ms"])
    for G in groups:
        log(f"MSM {name} n={len(pts)} window sums, {G} window(s) a group ({nw // G} groups): "
            f"{', '.join(f'{t:.1f}' for t in sp['sums_ms'][G])} ms (CUDA events, in turns); "
            f"peak device memory {sp['peak_gib'][G]:.2f} GiB over the {sp['held_gib']:.2f} GiB "
            "held before")
    sums_ms = statistics.median(sp["sums_ms"][default])
    wall, busy, top, _ = device_kernel_ms(lambda: sp["window_sums"](default),
                                          keep=("point_add", "bucket_level", "index_put"))
    # the bucket writes are the merge-level kernel's: no row scatter is left
    assert not any("index_put" in key for key, _, _ in top), top
    log(f"MSM {name} n={len(pts)}: gpu warm {sp['gpu_ms'] / 1e3:.3f} s, native C "
        f"{sp['native_ms'] / 1e3:.3f} s, equal; device recode {sp['recode_ms']:.2f} ms "
        f"(the scalar upload included), device "
        f"window sums {sums_ms:.1f} ms ({default} windows a group), host fold "
        f"{sp['fold_ms']:.1f} ms; kernels busy {busy:.1f} ms (idle share "
        f"{1 - busy / sums_ms:.3f}; {wall:.1f} ms wall under the profiler)")
    for key, ms, count in top:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key}")


def large_phase(dev, counted, h_points):
    """The large-circuit prover and the K-fold MSM tools on the card, every
    count set to 0 just before each step and read just after:
    schoolbook-1024 (K3 1; four MSMs of n_pad 2^21, G1 on the card) and
    dual-1024 (K1 4; four of 2^18) through tools.prove_large, each proof
    identical to the native C's; the h query's 2^21-point MSM on its own
    and its stages; half-digit scalars on 2^21 tiled points through
    g1_msm_gpu and g1_msm_gpu_multi (K = 2); tools.msm_multi at 2^18 (the
    verify-with-NTT h query, `h_points`) for K in LARGE_KS; and
    tools.prove_batch_large at dual-1024, K = LARGE_BATCH_K, on gpu and
    native with the same r and s, identical proofs.  Returns {step:
    launches}."""
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R
    from falcon_r1cs_tpu_torch.tools import msm_multi, prove_batch_large

    steps = {}

    def step(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"large step {name}: {time.perf_counter() - t:.1f} s")
        return out

    out, steps["schoolbook-1024 prove"], msms = step(
        "schoolbook-1024 prove", large_prove, dev, counted, "schoolbook",
        {"schoolbook_prods_kernel": 1}, 20261022)
    step("schoolbook-1024 h MSM stages", msm_stages, dev, counted, msms[3][1], msms[3][2], "h")
    del out, msms
    dual, steps["dual-1024 prove"], _ = step(
        "dual-1024 prove", large_prove, dev, counted, "dual", {"ntt_hints_kernel": 4}, 20261023)

    def half_digits():
        n, K = 1 << 21, 2
        _, seconds, d = counted_run(
            counted, lambda: msm_multi.half_digit_check(n, K, device=dev, log=sublog))
        expect = {k: msm_launches(counted, n)[k] + msm_launches(counted, n, K)[k]
                  for k in counted} | {"mont_mul_kernel": 1}
        assert d == expect, (d, expect)
        return d

    steps["half digits 2^21"] = step("half digits 2^21", half_digits)

    def k_fold():
        iters = 2
        cached = hasattr(h_points, "_gpu_mont_cache")
        rows, _, d = counted_run(
            counted, lambda: msm_multi.run(1024, LARGE_KS, iters, dev, points=h_points,
                                           log=sublog))
        expect = {k: sum((1 + iters) * msm_launches(counted, len(h_points), K)[k]
                         for K in LARGE_KS) for k in counted}
        expect["mont_mul_kernel"] = 0 if cached else 1
        assert d == expect, (d, expect)
        return d

    steps["k-fold 2^18"] = step("k-fold 2^18", k_fold)

    def batch():
        K = LARGE_BATCH_K
        rng = np.random.default_rng(20261024)
        rs, ss = ([int.from_bytes(rng.bytes(32), "little") % R for _ in range(K)]
                  for _ in range(2))
        pk = dual["pk"]
        runs = {}
        for backend in ("gpu", "native"):
            runs[backend] = counted_run(counted, lambda: prove_batch_large.run(
                "dual", K, 1024, backend, dev, rs=rs, ss=ss, pk=pk, log=sublog))
        (gpu, _, d), (native, _, d_native) = runs["gpu"], runs["native"]
        assert [(p.a, p.b, p.c) for p in gpu["proofs"]] == \
            [(p.a, p.b, p.c) for p in native["proofs"]], "batch: gpu proofs != native"
        four = [pk.a_query, pk.b_g1_query, pk.l_query, pk.h_query]
        proves = min(2, K) + 2 + K  # the warm-up batch, two singles, the batch
        expect = {k: proves * sum(msm_launches(counted, len(p))[k] for p in four)
                  for k in counted} | {"ntt_hints_kernel": 4}
        expect |= witness_map_launches(counted, dual["compiled"], proves)
        assert d == expect, (d, expect)
        assert d_native == dict.fromkeys(counted, 0) | {"ntt_hints_kernel": 4}, d_native
        log(f"batch dual-1024 K={K}: gpu {gpu['per_proof_s']:.3f} s/proof (single "
            f"{gpu['single_s']:.3f} s), native {native['per_proof_s']:.3f} s/proof (single "
            f"{native['single_s']:.3f} s); identical proofs, all verify")
        return d

    steps["batch dual-1024 K=2"] = step("batch dual-1024", batch)
    return {k: {name: v for name, v in d.items() if v} for k, d in steps.items()}


def tools_phase(dev, counted):
    """The Falcon-512 tools on the card, every count set to 0 just before
    each step and read just after, the artifact directory a temp dir:
    tools.profile_prove with g1_backend="gpu" (a fresh setup from fixed
    toxic waste; each G1 MSM equal to the native C's, with its split; K4
    4, the CRS conversion; K5 and K6 five MSM runs a query: the warm-up
    prove, the split's whole MSM, warm-up and sample, the whole prove; the
    recode four: the same but for the sample's, and the split's own) and
    with "native" on the same key, r and s: identical proofs that verify;
    msm_stages at its h query (n_pad 2^17);
    tools.prove_batch at K = TOOLS_BATCH_K on gpu (K1 2, one engine call
    at n = 512; K4 0; K5 and K6 the MSMs of 2 + 1 + K proves) and native
    (K1 2 only) with the same r and s: identical proofs, each equal to the
    native C's single prove; tools.pp_vs_dp over 2 ranks: refused with
    the card count on one card, over NCCL on two.  Returns {step:
    launches}."""
    import tempfile

    from falcon_r1cs_tpu_torch.snark import groth16, gpu_msm, native_backend
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R
    from falcon_r1cs_tpu_torch.tools import pp_vs_dp, profile_prove, prove_batch
    from falcon_r1cs_tpu_torch.tools.prove_large import artifacts_in

    def draw(rng, k):
        return [int.from_bytes(rng.bytes(32), "little") % (R - 1) + 1 for _ in range(k)]

    rng = np.random.default_rng(20261025)
    toxic, (r, s) = groth16.SetupToxic(*draw(rng, 5)), draw(rng, 2)
    K = TOOLS_BATCH_K
    rs, ss = draw(rng, K), draw(rng, K)
    steps = {}
    with tempfile.TemporaryDirectory(prefix="falcon_smoke_") as tmp, artifacts_in(tmp):
        t = time.perf_counter()
        prof, _, d = counted_run(counted, lambda: profile_prove.run(
            1, "gpu", dev, toxic=toxic, r=r, s=s, log=sublog))
        pk, compiled, z = prof["pk"], prof["compiled"], prof["assignment"]
        h, _ = native_backend.witness_map(compiled, z)
        four = {"a": pk.a_query, "b_g1": pk.b_g1_query, "l": pk.l_query, "h": pk.h_query}
        pads = {name: max(8, 1 << (len(p) - 1).bit_length()) for name, p in four.items()}
        nw = (255 + gpu_msm.WINDOW - 1) // gpu_msm.WINDOW
        groups = {name: gpu_msm._group_windows(n_pad, nw, device=dev)
                  for name, n_pad in pads.items()}
        expect = {k: 5 * sum(msm_launches(counted, len(p))[k] for p in four.values())
                  for k in counted} | {"mont_mul_kernel": len(four),
                                       "signed_digits_kernel": 4 * len(four)}
        # the warm-up prove (the tables' set-up) and the whole prove
        expect |= witness_map_launches(counted, compiled, proves=2)
        assert d == expect, (d, expect)
        wm_ms = check_h_on_card(compiled, z, dev, h)
        log(f"profile_prove Falcon-512: h on the card (2^17) == native C, {wm_ms:.2f} ms warm")
        steps["profile_prove gpu"] = d
        native, _, d_native = counted_run(counted, lambda: profile_prove.run(
            1, "native", dev, pk=pk, r=r, s=s, log=sublog))
        assert d_native == dict.fromkeys(counted, 0), d_native
        got, want = prof["proof"], native["proof"]
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c), "Falcon-512: gpu proof != native"
        log(f"profile_prove Falcon-512 (81,460 constraints): prove (total) gpu "
            f"{prof['ms']['prove (total)']:.1f} ms, native {native['ms']['prove (total)']:.1f} "
            f"ms; identical proofs, verify True; MSM points "
            f"{ {k: len(p) for k, p in four.items()} }, n_pad {pads}, windows a group "
            f"{groups}; launches {({k: v for k, v in d.items() if v})}; "
            f"{time.perf_counter() - t:.1f} s")
        msm_stages(dev, counted, four["h"], h, "h (Falcon-512)")

        t = time.perf_counter()
        runs = {}
        for backend in ("gpu", "native"):
            runs[backend] = counted_run(counted, lambda: prove_batch.run(
                K, 1, backend, dev, rs=rs, ss=ss, pk=pk, log=sublog))
        (gpu, _, d), (nat, _, d_native) = runs["gpu"], runs["native"]
        proves = 2 + 1 + K  # the warm-up batch, the single, the batch
        expect = {k: proves * sum(msm_launches(counted, len(p))[k] for p in four.values())
                  for k in counted} | {"ntt_hints_kernel": 2}
        expect |= witness_map_launches(counted, gpu["compiled"], proves)
        assert d == expect, (d, expect)
        assert d_native == dict.fromkeys(counted, 0) | {"ntt_hints_kernel": 2}, d_native
        steps[f"prove_batch gpu K={K}"], steps[f"prove_batch native K={K}"] = d, d_native
        assert [(p.a, p.b, p.c) for p in gpu["proofs"]] == \
            [(p.a, p.b, p.c) for p in nat["proofs"]], "batch: gpu proofs != native"
        for k, zk in enumerate(nat["assignments"]):
            single = groth16.prove(pk, compiled, zk, r=rs[k], s=ss[k], g1_backend="native")
            assert (single.a, single.b, single.c) == (nat["proofs"][k].a, nat["proofs"][k].b,
                                                      nat["proofs"][k].c), f"batch proof {k}"
        log(f"prove_batch Falcon-512 K={K}: gpu {gpu['per_proof_s']:.3f} s/proof (single "
            f"{gpu['single_s']:.3f} s, {gpu['speedup']:.2f}x K singles), native "
            f"{nat['per_proof_s']:.3f} s/proof (single {nat['single_s']:.3f} s, "
            f"{nat['speedup']:.2f}x); every batch proof == its single prove and verifies, "
            f"tampered input rejected; {time.perf_counter() - t:.1f} s")

    cards = torch.cuda.device_count()
    if cards < 2:
        try:
            pp_vs_dp.run(2, device=dev, log=sublog)
        except ValueError as e:
            assert f"this host has {cards}" in str(e), e
            log(f"pp_vs_dp S=2 on cuda refused on {cards} card: {e}")
        else:
            raise AssertionError("pp_vs_dp ran 2 ranks on one card")
    else:
        pp = pp_vs_dp.run(2, device=dev, log=sublog)
        log(f"pp_vs_dp S=2 over NCCL: PP {pp['pp_ms']:.2f} ms, DP {pp['dp_ms']:.2f} ms "
            f"(best of 5; medians {pp['pp_median_ms']:.2f}, {pp['dp_median_ms']:.2f}), "
            f"{pp['ratio']:.2f}x; equal")
    return {k: {name: v for name, v in d.items() if v} for k, d in steps.items()}


def bench_phase(counted):
    """bench_torch.py's cells, each once at --samples 3 --seconds 0 (a
    timed window of 3 calls) through its main() in-process (its lines
    shown indented), every count set to 0 just before each cell and read
    just after: exit code 0, the gate passed, and the cell's end-to-end,
    set-up and per-layer metrics that BENCHMARK.json names printed on its
    last line, each with a positive value; each kernel its workload lists
    under `kernels` launched (the main path K1; the prove K1 for its
    assignment, K4 for the CRS conversion, the recode, K5, K6 and the
    merge-level kernel; the dual-NTT cell K1).  Returns {step: launches}."""
    import bench_torch

    spec = json.loads((Path(__file__).resolve().parent / "BENCHMARK.json").read_text())
    steps = {}
    for cell in spec["workloads"]:
        name = cell["name"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, seconds, d = counted_run(counted, lambda: bench_torch.main(
                ["--cell", name, "--samples", "3", "--seconds", "0"]))
        *lines, last = buf.getvalue().splitlines()
        for line in lines:
            sublog(line)
        assert rc == 0, f"bench_torch.py --cell {name}: exit code {rc}"
        got = json.loads(last)["cells"][name]
        assert got["gate"] == "passed", got["gate"]
        names = [cell["metric"]["name"], cell["setup_metric"]] + [
            k for k, v in spec["layer_metrics"].items() if name in v["workloads"]]
        values = {k: got["metrics"][k]["value"] for k in names}
        assert all(v is not None and v > 0 for v in values.values()), values
        assert cell["kernels"] and all(d[k] > 0 for k in cell["kernels"]), (cell["kernels"], d)
        steps[f"bench {name}"] = d
        log(f"bench {name}: {len(names)} metrics of BENCHMARK.json printed, all positive; "
            f"{cell['metric']['name']} {values[cell['metric']['name']]:.4g}; launches "
            f"{({k: v for k, v in d.items() if v})}; {seconds:.1f} s")
    return {k: {n: v for n, v in d.items() if v} for k, d in steps.items()}


def semi_kernel_vs_plain(dev, launches, build_log):
    """K8 against its plain versions at n = 512 and 1024, B = N_SIGS, with
    one row of all q - 1, one of all 0 and a one-hot row: the semi
    epilogue against ntt_semi limb for limb; the entry (the hints
    epilogue) against its plain version, ntt_with_hints and K1, bit for
    bit, one device kernel under the profiler.  K8's record describes the
    instantiation its path launches, the hints epilogue: the entry's
    CUDA-event and profiler device times beside its plain version's, its
    bound from its bytes and its own SASS by pipe, its ptxas; the semi
    epilogue's numbers are the semi_* keys."""
    from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q
    from falcon_r1cs_tpu_torch.ops import cuda_ntt, ntt_limb, ntt_v3

    wrapper, entry = ntt_v3.ntt_semi_cuda, ntt_v3.ntt_with_hints_v3
    for p in (FALCON_512, FALCON_1024):
        x = torch.from_numpy(
            np.random.default_rng(p.n + 2).integers(0, Q, size=(N_SIGS, p.n))
            .astype(np.int32)
        ).to(dev)
        x[-3], x[-2], x[-1] = Q - 1, 0, 0
        x[-1, 7] = 1
        got = wrapper(x, p)
        want = wrapper.plain(x, p)
        err = max_abs_err([got], [want])
        assert err == 0, f"ntt_semi_kernel n={p.n} differs from its plain version"
        redundant = int(((want < 0) | (want > 0xFFFF)).any(2).any(0).sum())
        assert redundant > 0, "no row where parallel and sequential carries differ"
        got = entry(x, p)
        entry_err = max_abs_err(got, entry.plain(x, p))
        assert entry_err == 0, f"ntt_with_hints_v3 n={p.n} differs from its plain version"
        for a, c, k1 in zip(got, ntt_limb.ntt_with_hints(x, p),
                            cuda_ntt.ntt_with_hints_cuda(x, p)):
            assert torch.equal(a, c) and torch.equal(a, k1), \
                f"ntt_with_hints_v3 n={p.n} != ntt_with_hints or K1"
        # ten entry calls in one window: every kernel it caught is K8 (no
        # torch normalise or divmod), at most one a call (the profiler can
        # drop rows: a window of one call caught none in five tries, run CJ;
        # the launch counts of semi_path hold one K8 launch a call exactly)
        _, _, kernels, _ = device_kernel_ms(lambda: [entry(x, p) for _ in range(10)], keep=())
        assert kernels and all("ntt_semi_kernel" in key for key, _, _ in kernels) and \
            sum(c for _, _, c in kernels) <= 10, f"ten entry calls ran {kernels}, not K8 alone"
        ms = cuda_ms(lambda: wrapper(x, p))
        dev_ms = kernel_device_ms(wrapper, (x, p), "ntt_semi_kernel")
        plain_ms = cuda_ms(lambda: wrapper.plain(x, p), reps=10, inner=2)
        entry_ms = cuda_ms(lambda: entry(x, p))
        entry_dev_ms = kernel_device_ms(entry, (x, p), "ntt_semi_kernel")
        entry_plain_ms = cuda_ms(lambda: entry.plain(x, p), reps=10, inner=2)
        k1_ms = cuda_ms(lambda: cuda_ntt.ntt_with_hints_cuda(x, p))
        log(f"ntt_semi_kernel n={p.n} B={N_SIGS}: semi epilogue {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bit-equal ({redundant} rows hold "
            f"limbs outside [0, 2^16)); hints epilogue, ntt_with_hints_v3 {entry_ms:.4f} ms "
            f"(device {entry_dev_ms:.4f} ms, one kernel), plain {entry_plain_ms:.4f} ms, "
            f"== ntt_with_hints == hint kernel {k1_ms:.4f} ms on the same rows")
    # x read once, 12 limb planes written (semi) or t's 11 and b (hints),
    # the stage tables (twiddles, bound limbs) read once
    coeffs = N_SIGS * p.n
    nbytes = 4 * (13 * coeffs + p.log_n * p.n + (p.log_n + 1) * 12)
    # the operations: each instantiation's own SASS a thread, by pipe
    # (sass_pipe_ops), times n / 4 threads a row and N_SIGS rows.  The
    # counts before, for PERF.md: the multiplies alone (12 limbs, every
    # stage; PR 4) and 9 instructions a live limb of a pair-stage (more
    # than the compiled kernel issues on its integer pipes)
    threads = p.n // 4
    semi_sass, semi_ops = sass_pipe_ops("15ntt_semi_kernelILi10ELb0E")
    hints_sass, hints_ops = sass_pipe_ops("15ntt_semi_kernelILi10ELb1E")
    semi_ops *= threads * N_SIGS
    hints_ops *= threads * N_SIGS
    muls = N_SIGS * p.log_n * (p.n // 2) * 12
    semi_bound, semi_by = bound(nbytes, semi_ops)
    log(f"ntt_semi_kernel bound n={p.n}: bytes {nbytes / H100_BYTES_PER_S * 1e3:.4f} ms; "
        f"SASS a thread, semi {semi_sass}, hints {hints_sass}: "
        f"{semi_ops / H100_INT32_MAD_PER_S * 1e3:.4f} ms (semi), "
        f"{hints_ops / H100_INT32_MAD_PER_S * 1e3:.4f} ms (hints); the multiplies alone "
        f"{muls / H100_INT32_MAD_PER_S * 1e3:.4f} ms; 9 instructions a live limb "
        f"{9 * N_SIGS * (p.n // 2) * sum(ntt_v3.live_limbs(p)) / H100_INT32_MAD_PER_S * 1e3:.4f}"
        " ms")
    # one CTA a row, n / 4 threads; the exchange planes in static shared memory
    semi_stats = ptxas(build_log, "15ntt_semi_kernelILi10ELb0E", threads)
    hints_stats = ptxas(build_log, "15ntt_semi_kernelILi10ELb1E", threads)
    return record(
        "ntt_semi_kernel", "falcon_r1cs_tpu_torch/csrc/ntt_v3.cu",
        "tools/pallas_ntt_v3.py:49", launches["ntt_semi_kernel"], entry_err, entry_ms,
        entry_plain_ms, nbytes, hints_ops, epilogue="hints", device_ms=entry_dev_ms,
        sass=hints_sass, k1_ms=k1_ms, semi_max_abs_err=err, semi_ms=ms,
        semi_plain_ms=plain_ms, semi_device_ms=dev_ms, semi_bound_ms=semi_bound,
        semi_bound_by=semi_by, semi_sass=semi_sass, semi_ptxas=semi_stats, **hints_stats,
    )


def ptxas_stats(log_text, kernel):
    """Registers, stack, spill and static shared bytes of one kernel from
    `-Xptxas -v`; `kernel` is a fragment of its (mangled) name."""
    lines = log_text.splitlines()
    for k, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            block = "\n".join(lines[k : k + 4])
            regs = re.search(r"Used (\d+) registers", block)
            stack = re.search(r"(\d+) bytes stack frame", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            smem = re.search(r"(\d+) bytes smem", block)
            return {
                "registers": int(regs.group(1)) if regs else None,
                "stack": int(stack.group(1)) if stack else None,
                "spill_stores": int(spill.group(1)) if spill else None,
                "spill_loads": int(spill.group(2)) if spill else None,
                "smem": int(smem.group(1)) if smem else 0,
            }
    raise RuntimeError(f"no ptxas lines for {kernel}")


def resident(registers, threads, smem=0):
    """(blocks, warps) an H100 SM holds at this register count and static
    shared memory: 65,536 registers, allocated per warp in units of 256;
    233,472 B of shared memory, 1 KB of it reserved a block; at most 32
    blocks and 64 warps."""
    warps = threads // 32
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(32, 64 // warps, 65536 // (per_warp * warps), 233472 // (smem + 1024))
    return blocks, blocks * warps


def ptxas(build_log, kernel, threads, dyn_smem=0):
    """ptxas_stats of one kernel, logged with its SM residency at `threads`
    a block ({} when the library was already built: no log)."""
    if not build_log:
        return {}
    stats = ptxas_stats(build_log, kernel)
    blocks, warps = resident(stats["registers"], threads, stats["smem"] + dyn_smem)
    log(f"{kernel} ptxas: {stats}; {blocks} blocks, {warps} warps an SM")
    return stats


def kernel_device_ms(wrapper, args, kernel, calls=10, tries=5, alone=False):
    """The kernel alone: profiler device ms a launch, from a window of
    `calls` wrapper calls that caught exactly `calls` launches of the
    kernels whose names hold `kernel`.  The device time is every kernel's
    of the window, or with `alone` only those rows' (a wrapper that also
    fills a tensor, as the recode's flag), and then over the launches the
    window caught.  The CUDA-event time of back-to-back wrapper calls is
    the longer of this and the wrapper's host cost a call.  The profiler
    can drop rows (one of ten in every window: the round-trip tile in runs
    CF and CH, the K8 entry in CK; PERF.md section 7), so up to `tries`
    windows are taken; if none was whole, the kernel's own rows over the
    launches the last window caught, logged as such (each row carries its
    own launches' time); raises if it caught none."""
    for _ in range(tries):
        _, busy, rows, _ = device_kernel_ms(lambda: [wrapper(*args) for _ in range(calls)],
                                         keep=(kernel,))
        caught = sum(c for key, _, c in rows if kernel in key)
        own = sum(ms for key, ms, _ in rows if kernel in key)
        if alone and caught:
            return own / caught
        if caught == calls:
            return busy / calls
    if not caught:
        raise RuntimeError(f"{calls} launches of {kernel} expected, the profiler caught {rows}")
    log(f"{kernel}: no profiler window of {tries} caught all {calls} launches; device ms "
        f"over the {caught} the last one caught")
    return own / caught


def select_path_rows(m, dev, seed=20261019):
    """m random Montgomery G1 points and a second operand with rows 0:64
    doubling, 64:96 P + (-P), 96:128 inf1, 128:160 inf2, the rest chord
    (the select paths of the JAX package's tests/test_pallas_fq.py)."""
    from falcon_r1cs_tpu_torch.ops import fq, fq_mont
    from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend

    rng = np.random.default_rng(seed)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, m)])
    xs, ys = gpu_msm._points_std_limbs(arr, m)
    r2 = fq_mont.consts(dev)["r2"][:, None].expand(fq_mont.NL, m).contiguous()
    X = fq.mont_mul_cuda(torch.from_numpy(xs.T.copy()).to(dev), r2)
    Y = fq.mont_mul_cuda(torch.from_numpy(ys.T.copy()).to(dev), r2)
    perm = torch.from_numpy(rng.permutation(m)).to(dev)
    X2, Y2 = X[:, perm].clone(), Y[:, perm].clone()
    X2[:, :96] = X[:, :96]
    Y2[:, :64] = Y[:, :64]
    Y2[:, 64:96] = fq_mont.sub_mod(torch.zeros_like(Y[:, 64:96]), Y[:, 64:96])
    inf1 = torch.zeros(m, dtype=torch.bool, device=dev)
    inf1[96:128] = True
    inf2 = torch.zeros(m, dtype=torch.bool, device=dev)
    inf2[128:160] = True
    one = fq_mont.consts(dev)["one"][:, None].expand(fq_mont.NL, m).contiguous()
    return (X, Y, one, inf1), (X2, Y2, one.clone(), inf2)


# int32 operations of one digit of the recode, counted from
# csrc/msm_recode.cu: two 64-bit shifts, an or and a mask (two words each:
# 8), the carry add, the compare, the select and the packing or (4)
RECODE_OPS_A_DIGIT = 12


def recode_kernel_vs_plain(dev, launches, build_log):
    """The recode kernel against its plain version
    (`ops.msm_recode.signed_digits`, run on the same card tensors), digits
    and overflow flag bit for bit: window 12 at n = 2^17 - 1 and 2^21 - 1
    points (the h queries of a Falcon-512 prove and of schoolbook-1024;
    n_pad 2^17 and 2^21), K = 1 and 4, random scalars below 2^255 whose
    limbs 0-2 span the full u64 range (top bits set), rows 0, r - 1 and
    all ones below 2^255, every 97th point infinite; window 5 over the
    2^17 rows at its default 51 windows (51 x 5 = 255 bits: r - 1 and the
    all-ones rows carry out of the top window, so the flag is set, as in
    its plain version) and at the sharded MSM's n_windows_carry(5) = 52
    (flag 0).  Times at K = 1: CUDA events of the wrapper, the plain
    version, profiler device ms; bound: the bytes (scalars, mask read,
    digits written) over the card's rate; its ptxas line.  The 52-window
    recode's numbers go under the key "carry_w5"."""
    from falcon_r1cs_tpu_torch.ops import msm_recode
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R

    wrapper = msm_recode.signed_digits_cuda
    window = 12
    rng = np.random.default_rng(20261026)
    out = {}
    for log_n in (17, 21):
        n_pad = 1 << log_n
        n = n_pad - 1
        for K in (1, 4):
            sc = rng.integers(0, 2**64, size=(K, n, 4), dtype=np.uint64)
            sc[..., 3] >>= np.uint64(1)
            sc[:, 0] = 0
            sc[:, 1] = [(R - 1) >> (64 * j) & (2**64 - 1) for j in range(4)]
            sc[:, 2] = [2**64 - 1] * 3 + [2**63 - 1]
            sc = torch.from_numpy(sc.view(np.int64)).to(dev)
            inf = torch.zeros(n, dtype=torch.bool, device=dev)
            inf[5::97] = True
            args = (sc if K > 1 else sc[0], inf)
            counts = [(window, None)]
            if (log_n, K) == (17, 1):
                counts += [(5, None), (5, msm_recode.n_windows_carry(5))]
            for w, nw in counts:
                got = wrapper(*args, w, n_pad, nw)
                torch.cuda.synchronize()
                want = wrapper.plain(*args, w, n_pad, nw)
                assert all(g.dtype == h.dtype and torch.equal(g, h) for g, h in zip(got, want)), \
                    f"recode kernel n={n} K={K} w={w} nw={nw} differs from its plain version"
                flagged = w == 5 and nw is None
                assert got[1].item() == flagged, f"overflow flag {got[1].item()} at w={w}, nw={nw}"
            if K > 1:
                continue
            ms = cuda_ms(lambda: wrapper(*args, window, n_pad))
            plain_ms = cuda_ms(lambda: wrapper.plain(*args, window, n_pad), reps=5, inner=1)
            dev_ms = kernel_device_ms(wrapper, (*args, window, n_pad), "signed_digits_kernel",
                                      alone=True)
            nw = msm_recode.n_windows(window)
            nbytes = 32 * n + n + 4 * nw * n_pad + 4
            ops = RECODE_OPS_A_DIGIT * nw * n_pad
            bound_ms, bound_by = bound(nbytes, ops)
            log(f"signed_digits_kernel n={n} (n_pad 2^{log_n}) w={window}: kernel {ms:.4f} ms "
                f"(device {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); bit-equal with the flag, K = 1 and 4, w = 5 overflow flagged")
            out[log_n] = (ms, plain_ms, dev_ms, nbytes, ops)
            if log_n == 17:
                nw = msm_recode.n_windows_carry(5)
                carry_args = (*args, 5, n_pad, nw)
                c_ms = cuda_ms(lambda: wrapper(*carry_args))
                c_plain = cuda_ms(lambda: wrapper.plain(*carry_args), reps=5, inner=1)
                c_dev = kernel_device_ms(wrapper, carry_args, "signed_digits_kernel", alone=True)
                c_bytes = 32 * n + n + 4 * nw * n_pad + 4
                c_bound = bound(c_bytes, RECODE_OPS_A_DIGIT * nw * n_pad)
                log(f"signed_digits_kernel n={n} w=5 at {nw} windows (the sharded MSM's): "
                    f"kernel {c_ms:.4f} ms (device {c_dev:.4f} ms), plain {c_plain:.4f} ms, "
                    f"bound {c_bound[0]:.4f} ms ({c_bound[1]}); bit-equal, flag 0 (r - 1 and "
                    "the all-ones rows included)")
                carry = {"window": 5, "nw": nw, "ms": c_ms, "plain_ms": c_plain,
                         "device_ms": c_dev, "bound_ms": c_bound[0], "bound_by": c_bound[1]}
    ms, plain_ms, dev_ms, nbytes, ops = out[17]
    big = out[21]
    return record(
        "signed_digits_kernel", "falcon_r1cs_tpu_torch/csrc/msm_recode.cu",
        "none: the JAX package recodes on the host (falcon_r1cs_tpu/snark/tpu_msm.py:813)",
        launches, 0, ms, plain_ms, nbytes, ops, device_ms=dev_ms,
        **ptxas(build_log, "signed_digits_kernel", 256),
        n_pad_2e21={"ms": big[0], "plain_ms": big[1], "device_ms": big[2],
                    "bound_ms": bound(big[3], big[4])[0]},
        carry_w5=carry,
    )


def bucket_level_bytes(kf, kl, affine):
    """(bytes, buckets written) of one merge level for these keys (W, c),
    its selects decided a lane as csrc/msm_bucket.cu decides them.  The
    bytes it must move: its four keys a lane; a lane's sources read once
    each (the bridge where a select or the closed lT takes it, lH and rT
    where H' and T' keep them, lT and rH where their segments close; 3
    coordinates of 35 int32 limbs and a flag byte, the affine leaves 2);
    H', T', kf', kl' written; 105 words and a flag byte for each bucket
    written."""
    c2 = kf.shape[1] // 2
    lkf, rkf, lkl, rkl = kf[:, :c2], kf[:, c2:], kl[:, :c2], kl[:, c2:]
    same, ls, rs = lkl == rkf, lkf == lkl, rkf == rkl
    h_br, t_br = same & ls, same & rs
    emit_a, emit_b = ~ls & ~t_br, ~same & ~rs
    lanes = same.numel()
    src = 35 * 4 * (2 if affine else 3) + 1
    need_b = h_br | t_br | (emit_a & same)
    reads = (16 * lanes + (35 * 4 * 3 + 1) * int(need_b.sum())
             + src * int((~h_br).sum() + (~t_br).sum() + (emit_a & ~same).sum() + emit_b.sum()))
    emitted = int(emit_a.sum() + emit_b.sum())
    if c2 == 1:  # the root's H' and, where it differs, its T'
        emitted += lanes + int((rkl != lkf).sum())
    return reads + lanes * 2 * (35 * 4 * 3 + 1 + 4) + emitted * (35 * 4 * 3 + 1), emitted


def bucket_emissions(keys):
    """The buckets each merge level of a group writes, level 1 first, from
    its sorted bit-reversed keys (W, n) alone (a level of c lanes has
    kf = keys[:, :c], kl = keys[:, n - c:])."""
    n = keys.shape[1]
    counts, c = [], n
    while c > 1:
        counts.append(bucket_level_bytes(keys[:, :c], keys[:, n - c:], c == n)[1])
        c //= 2
    return counts


def bucket_kernel_vs_plain(dev, launches, build_log, z512):
    """The merge-level kernel against its plain version
    (`ops.msm_bucket.bucket_level`, run on the same card tensors), bit for
    bit: H', T', kf', kl' and the whole bank, which starts as random limbs
    and flags, so a column the level must not write shows.  Three groups
    of 22 windows, their keys recoded at window 12, sorted and placed
    bit-reversed as `gpu_msm._window_sums` does (`ops.tune_msm_bucket`):
    random scalars below r at n_pad 2^17 (cell B's h query) and 2^18 (the
    Falcon-1024 prove), and cell B's a query at 2^17, the digits of the
    Falcon-512 assignment z512 (62.5 % zero scalars, windows 12-21 all
    zero; no point masked infinite); H, T and the bridge random limbs and
    flags (the level moves them, whatever they hold).  Every level of both
    2^17 groups (17 launches each: level 1 over the affine leaves, the
    root the last), levels 1, 2 and the root at 2^18, each bit-equal, in
    the form the entry picks (`msm_bucket.lanes_a_cta`).  Times of each
    level but the 2^18 root: CUDA events of the wrapper, profiler device
    ms, and the plain version's (not for the a query); bound: the bytes
    that level's data needs (`bucket_level_bytes`) over the card's rate,
    and its share of the device time; the buckets each level writes,
    which sum to the group's distinct (window, key) pairs; each 2^17
    group's summed device ms and bound; the ptxas lines of every
    instantiation (`ptxas_forms`; level 1's are the affine ones)."""
    from falcon_r1cs_tpu_torch.ops import msm_bucket
    from falcon_r1cs_tpu_torch.ops import tune_msm_bucket as tune

    wrapper = msm_bucket.bucket_level_cuda
    g = torch.Generator(device=dev).manual_seed(20261027)
    groups = {"random 2^17": tune.random_keys(17, dev),
              "a query 2^17": tune.witness_keys(z512, dev),
              "random 2^18": tune.random_keys(18, dev, seed=20261028)}
    out, sums = {}, {}
    for gname, keys in groups.items():
        W, n = keys.shape
        emissions = bucket_emissions(keys)
        distinct = sum(int(keys[w].unique().numel()) for w in range(W))
        assert sum(emissions) == distinct, (sum(emissions), distinct)
        # every level of the 2^17 groups (level 1 the widest, the root at
        # c = 2), the widest two and the root at 2^18
        levels = [n >> i for i in range(n.bit_length() - 1)] if n == 1 << 17 else [n, n // 2, 2]
        for c in levels:
            args = tune.level_inputs(keys, c, g)
            bridge, H, T, kf, kl, bank, nb = args
            got_bank = tuple(a.clone() for a in bank)
            args = (bridge, H, T, kf, kl, got_bank, nb)
            got = wrapper(*args)
            torch.cuda.synchronize()
            want = msm_bucket.bucket_level(bridge, H, T, kf, kl, bank, nb)
            for a, b in zip(got[0] + got[1] + got[2:] + got_bank,
                            want[0] + want[1] + want[2:] + bank):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    f"bucket_level_kernel {gname} c={c} differs from its plain version"
            if c == 2 and n != 1 << 17:
                continue
            del got, want
            ms = cuda_ms(lambda: wrapper(*args))
            plain_ms = (cuda_ms(lambda: msm_bucket.bucket_level(*args), reps=5, inner=1)
                        if gname.startswith("random") else None)
            dev_ms = kernel_device_ms(wrapper, args, "bucket_level_kernel", calls=4)
            nbytes, emitted = bucket_level_bytes(kf, kl, c == n)
            bound_ms, _ = bound(nbytes, 0)
            level = tune.level_of(n, c)
            lanes = msm_bucket.lanes_a_cta(W, c)
            log(f"bucket_level_kernel {gname}, {W} windows, level {level} ({c} lanes in, "
                f"{lanes} a CTA, {emitted} buckets written): kernel {ms:.4f} ms (device "
                f"{dev_ms:.4f} ms), plain "
                + ("not timed" if plain_ms is None else f"{plain_ms:.4f} ms")
                + f", bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB, "
                f"{100 * bound_ms / dev_ms:.1f} % of the device time); bit-equal, the bank "
                "included")
            out[(gname, level)] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                                       bound_ms=bound_ms, bound_share=bound_ms / dev_ms,
                                       nbytes=nbytes, buckets=emitted, lanes_a_cta=lanes)
            del args, H, T, bridge, bank, got_bank
        out[(gname, "emissions")] = emissions
        log(f"bucket_level_kernel {gname}: buckets written a level, level 1 first: "
            f"{emissions} ({distinct} in all, the group's distinct (window, key) pairs)")
        if n == 1 << 17:
            rows = [v for k, v in out.items() if k[0] == gname and k[1] != "emissions"]
            dev_sum = sum(v["device_ms"] for v in rows)
            bound_sum = sum(v["bound_ms"] for v in rows)
            sums[gname] = dict(device_ms=dev_sum, bound_ms=bound_sum,
                               bound_share=bound_sum / dev_sum)
            log(f"bucket_level_kernel {gname}: the group's 17 levels {dev_sum:.4f} ms device, "
                f"bound {bound_sum:.4f} ms ({100 * bound_sum / dev_sum:.1f} %)")
    main = out[("random 2^17", 2)]
    forms = {f"{'affine' if a else 'jacobian'} {L}": ptxas(
        build_log, f"bucket_level_kernelILb{a}ELi{L}E", 256) for a in (0, 1)
        for L in msm_bucket.LANE_FORMS}
    assert all(not v or (v["spill_stores"], v["spill_loads"], v["stack"]) == (0, 0, 0)
               for v in forms.values()), forms
    return record(
        "bucket_level_kernel", "falcon_r1cs_tpu_torch/csrc/msm_bucket.cu",
        "none: the JAX package's bucket selects and scatters are XLA "
        "(falcon_r1cs_tpu/snark/tpu_msm_blocks.py:216)",
        launches, 0, main["ms"], main["plain_ms"], main["nbytes"], 0,
        device_ms=main["device_ms"], **forms["jacobian 256"], ptxas_forms=forms,
        levels={f"{k[0]} level {k[1]}": v for k, v in out.items() if k[1] != "emissions"},
        buckets_a_level={k[0]: v for k, v in out.items() if k[1] == "emissions"},
        group_sums=sums,
    )


def fq_kernels_vs_plain(dev, launches, build_log):
    """K4 (depth 1 and 4), K5 and K6 against their plain versions by value
    at m = M_FQ points with the doubling, P + (-P) and infinity rows of
    the JAX package's tests; K5 and K6 also on rows far from canonical;
    their ptxas lines; times, bounds and records."""
    from falcon_r1cs_tpu_torch.ops import fq, fq_check, fq_mont

    m = M_FQ
    p1, p2 = select_path_rows(m, dev)
    (X, Y, _, inf1), (X2, Y2, _, inf2) = p1, p2
    limb_bytes = fq_mont.NL * 4 * m

    def compare(name, wrapper, args, plain_reps=3):
        """By value (fq_check.value_check): the largest difference of the
        canonical coordinates and the flags against the reference, the
        exact referee deciding a point add's rows where the plain version
        errs."""
        got = wrapper(*args)
        torch.cuda.synchronize()
        want = wrapper.plain(*args)
        if wrapper is fq.mont_mul_cuda:
            err, referee_rows = fq_check.value_check((got,), (want,))
            assert torch.equal(fq_mont.canonical(got), got), f"{name}: not canonical"
        else:
            err, referee_rows = fq_check.value_check(got, want, *args)
        assert err == 0, f"{name} differs by value from its reference"
        ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: wrapper.plain(*args), reps=plain_reps, inner=1, warmup=1)
        return err, ms, kernel_device_ms(wrapper, args, name), plain_ms, referee_rows

    def far_rows(wrapper, fed, others):
        """value_check on 4,096 rows of `fed` (coordinates made far from
        canonical, each kind) against each of `others`: the rows the exact
        referee decided, by kind."""
        rows = 4096
        head = tuple(c[..., :rows].contiguous() for c in fed)
        referred = {}
        for kind in ("wide", "pos", "neg", "sub"):
            far = tuple(fq_check.far_reps(fq_mont.canonical(c), kind, 70 + i).contiguous()
                        for i, c in enumerate(head[:-1])) + (head[-1],)
            referred[kind] = 0
            for other in others:
                other = tuple(c[..., :rows].contiguous() for c in other)
                far_err, n = fq_check.value_check(wrapper(far, other), wrapper.plain(far, other),
                                                  far, other)
                assert far_err == 0, f"{wrapper.__name__} differs by value on {kind} rows"
                referred[kind] += n
        return referred

    records = []
    for depth in (4, 1):
        err, ms, dev_ms, plain_ms, referee_rows = compare("mont_mul_kernel", fq.mont_mul_cuda,
                                                          (X, Y2, depth))
        log(f"mont_mul_kernel depth={depth} m={m}: kernel {ms:.4f} ms (device {dev_ms:.4f} "
            f"ms), plain {plain_ms:.4f} ms, equal by value (canonical mod q), canonical out")
    wide = (X.repeat(1, 8), Y2.repeat(1, 8), 1)
    log(f"mont_mul_kernel depth=1 m={8 * m} (the shape of the CRS conversion, X|Y at "
        f"n_pad 2^18): kernel {cuda_ms(lambda: fq.mont_mul_cuda(*wide)):.4f} ms (device "
        f"{kernel_device_ms(fq.mont_mul_cuda, wide, 'mont_mul_kernel'):.4f} ms)")
    records.append(record(
        "mont_mul_kernel", "falcon_r1cs_tpu_torch/csrc/fq_mont.cu",
        "falcon_r1cs_tpu/ops/pallas_fq.py:280", launches["mont_mul_kernel"], err, ms,
        plain_ms, 3 * limb_bytes, MONT_MUL_MULS * m, referee_rows=referee_rows,
        device_ms=dev_ms, **ptxas(build_log, "mont_mul_kernel", 128),
    ))
    err, ms, dev_ms, plain_ms, referee_rows = compare("point_add_kernel", fq.point_add_cuda,
                                                      (p1, p2))
    log(f"point_add_kernel m={m}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, equal by value (canonical mod q), flags equal; "
        f"{referee_rows} rows decided by the exact host reference")
    stats = ptxas(build_log, "point_add_kernel", 128)
    # a K5 output with Z != one plus itself (the tangent) and plus an
    # affine point (the chord)
    fed = fq.point_add_cuda(p1, p2)
    referred = far_rows(fq.point_add_cuda, fed, (fed, p2))
    log("point_add_kernel on 4096 rows far from canonical (limbs at +-(2^12 + 2), "
        "values near +-2^13 q, sub_mod(0, .) negatives; a K5 output with Z != one "
        "plus itself and plus an affine point): equal by value, flags equal; rows "
        f"where the plain version erred, decided by the exact host reference: {referred}")
    # the select-path rows: 64 infinity rows (no product), 64 doubling rows
    # (the prefix's 9 products less Z1 Z2, then 7: 8 products, 7 squares),
    # the rest chord (the prefix's 9, then 7: 12 products, 4 squares)
    muls = ((m - 128) * (12 * MONT_MUL_MULS + 4 * MONT_SQR_MULS)
            + 64 * (8 * MONT_MUL_MULS + 7 * MONT_SQR_MULS))
    records.append(record(
        "point_add_kernel", "falcon_r1cs_tpu_torch/csrc/fq_mont.cu",
        "falcon_r1cs_tpu/ops/pallas_fq.py:325", launches["point_add_kernel"], err, ms,
        plain_ms, 9 * limb_bytes + 3 * m, muls,
        referee_rows=referee_rows + sum(referred.values()), device_ms=dev_ms, **stats,
    ))
    a1, a2 = (X, Y, inf1), (X2, Y2, inf2)
    err, ms, dev_ms, plain_ms, referee_rows = compare("point_add_aff_kernel",
                                                      fq.point_add_aff_cuda, (a1, a2))
    log(f"point_add_aff_kernel m={m}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, equal by value (canonical mod q), flags equal; "
        f"{referee_rows} rows decided by the exact host reference")
    stats = ptxas(build_log, "point_add_aff_kernel", 128)
    # X and Y far from canonical plus the same point (the tangent) and plus
    # the other affine operand (the chord, every select path)
    referred = far_rows(fq.point_add_aff_cuda, a1, (a1, a2))
    log("point_add_aff_kernel on 4096 rows far from canonical (X and Y of each "
        "kind, plus the same point and plus another affine point): equal by value, "
        f"flags equal; rows decided by the exact host reference: {referred}")
    # Z1 = Z2 = one: 64 doubling rows (1 product, 5 squares), the rest but
    # the 64 infinity rows chord (4 products, 2 squares)
    records.append(record(
        "point_add_aff_kernel", "falcon_r1cs_tpu_torch/csrc/fq_mont.cu",
        "falcon_r1cs_tpu/ops/pallas_fq.py:398", launches["point_add_aff_kernel"], err,
        ms, plain_ms, 7 * limb_bytes + 3 * m,
        (m - 128) * (4 * MONT_MUL_MULS + 2 * MONT_SQR_MULS)
        + 64 * (MONT_MUL_MULS + 5 * MONT_SQR_MULS),
        referee_rows=referee_rows + sum(referred.values()), device_ms=dev_ms, **stats,
    ))
    return records


# int32 multiplies of one Fr Montgomery product over 8 words of 32 bits
# (CIOS, R' = 2^256): a b is 64 word products, each a mul.lo and a mul.hi
# (128); the reduction per word is m = t_0 n0' (1) plus m r (8 words, lo and
# hi: 16), 8 x 17 = 136; 264 in all
FR_MONT_MULS = 2 * 8 * 8 + 8 * (1 + 2 * 8)


def falcon512_witness():
    """(compiled, z) of cell B's Falcon-512 verify-with-NTT proof (domain
    2^17): the circuit and the host trace's assignment, as the card test
    and tools.profile_prove take them."""
    from falcon_r1cs_tpu_torch import FALCON_512
    from falcon_r1cs_tpu_torch.falcon import make_instance
    from falcon_r1cs_tpu_torch.r1cs.coo import compile_circuit
    from falcon_r1cs_tpu_torch.tools.profile_prove import CIRCUIT, trace_assignment

    inst = make_instance(np.random.default_rng(5), FALCON_512)
    _, z = trace_assignment(inst)
    return compile_circuit(CIRCUIT, inst, cache=False), z


def spmv_bytes_ops(row_ptr, nnz, nz, n):
    """(bytes, int32 multiplies) of one sparse product: row_ptr, cols, the
    row order, the values, z and out each moved once; a product a
    nonzero."""
    return 4 * (row_ptr.shape[0] + nnz + n) + 32 * (nnz + nz + n), FR_MONT_MULS * nnz


def tile_bytes_ops(n, t, nvec, round_trip, scaled):
    """(bytes, int32 multiplies) of one tile launch over nvec vectors of n
    in tiles of t: x read and written, the scale (one table for all
    vectors) and the twiddle prefixes (t each) read once; a product a
    butterfly of the log2 t stages (twice that in the round trip) and a
    scaled element."""
    stages = t.bit_length() - 1
    tables = 2 if round_trip else 1
    nbytes = 32 * (2 * nvec * n + (n if scaled else 0) + tables * t)
    products = nvec * (n // 2 * stages * tables + (n if scaled else 0))
    return nbytes, FR_MONT_MULS * products


def fr_sass(kernel):
    """The static SASS opcode counts of one Fr kernel of the built library:
    IMAD, BRA, and every instruction but NOP (`issued`)."""
    from falcon_r1cs_tpu_torch.ops import _build

    (opcodes,) = [v for key, v in _build.sass_counts(_build.library_path()).items()
                  if kernel in key]
    return {"imad": opcodes["IMAD"], "bra": opcodes["BRA"],
            "issued": sum(v for k, v in opcodes.items() if k != "NOP")}


def z_warp_top_words(z) -> dict:
    """Warps of 32 consecutive rows of z by the highest word that one of
    their rows has nonzero (-1: every row 0): the rounds whose a b_i the
    entry runs in that warp are those up to it."""
    from falcon_r1cs_tpu_torch.snark.native_backend import z_rows

    words = z_rows(z).view(np.uint32).reshape(-1, 8) != 0
    top = np.where(words.any(axis=1), 7 - np.argmax(words[:, ::-1], axis=1), -1)
    top = np.concatenate([top, np.full(-len(top) % 32, -1)]).reshape(-1, 32).max(axis=1)
    return {str(w): int((top == w).sum()) for w in range(-1, 8) if (top == w).any()}


def fr_kernels_vs_plain(dev, launches, witness, witness512, build_log):
    """The witness map's seven Fr kernels (csrc/fr_mont.cu) against their
    plain versions (ops/fr.py, run on the same card tensors), word for
    word, at the shapes of the Falcon-1024 prove's witness map (domain
    2^18; `witness` the groth16 path's (compiled, z), its cache on the
    card): the entry of z, A's sparse product (B's and C's timed beside
    it, and A's short and long rows each alone), the round-trip tile over
    a, b and c (the DIF tile with h's scale, and the six single-form tiles
    that the round trip replaces, timed beside it), the widest DIF stage,
    the quotient, the exit with the bit-reversed rows; the power tables
    (the stage twiddles of w, the bit-reversed scales of 5) at 2^17, 2^18
    and 2^21.  The four redesigned kernels, the entry, the sparse product, the
    tile and the exit, also at cell B's Falcon-512 witness map (2^17;
    `witness512`, from `falcon512_witness`); the entry also on A's CSR
    values (full-width rows) at 2^18, with z's warps by their highest
    nonzero word at both maps; the exit also at 2^21; both with their
    static SASS counts.  Times: CUDA events
    of the wrapper and of the plain version, profiler device ms; bound:
    the bytes each must move (each input read once, each output written
    once) and its int32 multiplies (FR_MONT_MULS a product, the entry's
    and the exit's too, whatever their kernels skip; the power tables' a
    distinct value, n / 2 twiddles or n scales); ptxas and SM
    residency.  The whole
    witness map by CUDA events and under the profiler, at both domains,
    rides in the entry's record.  `launches`: the groth16 path's prove
    run."""
    from falcon_r1cs_tpu_torch.ops import fr
    from falcon_r1cs_tpu_torch.snark import gpu_qap, native_backend
    from falcon_r1cs_tpu_torch.snark.native_backend import z_rows

    def timed(name, wrapper, args, make, nbytes, ops, plain_reps=3, kernel=None):
        """Equal word for word to the plain version on make()'s inputs, then
        ms, plain ms, device ms and the bound of wrapper(*args)."""
        got = wrapper(*make())
        torch.cuda.synchronize()
        want = wrapper.plain(*make())
        err = max_abs_err([got], [want])
        assert err == 0 and got.dtype == want.dtype, f"{name} differs from its plain version"
        del got, want
        ms = cuda_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: wrapper.plain(*make()), reps=plain_reps, inner=1)
        dev_ms = kernel_device_ms(wrapper, args, kernel or name, alone=True)
        bound_ms, bound_by = bound(nbytes, ops)
        return dict(err=err, ms=ms, plain_ms=plain_ms, device_ms=dev_ms, bound_ms=bound_ms,
                    bound_by=bound_by, bound_share=bound_ms / dev_ms, nbytes=nbytes, ops=ops)

    def line(label, k, rec):
        log(f"{label} at 2^{k}: kernel {rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms), "
            f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}; {100 * rec['bound_share']:.1f} % of it); equal word for word")

    def map_on_card(compiled, z, k):
        wm = lambda: gpu_qap.witness_map_gpu(compiled, z, dev)  # noqa: E731
        wm_ms = cuda_ms(wm, reps=5, inner=2)
        _, busy, top, count = device_kernel_ms(wm, keep=("fr_",))
        log(f"witness map 2^{k} on the card: {wm_ms:.3f} ms (CUDA events), device "
            f"{busy:.3f} ms in {count} rows (idle share {1 - busy / wm_ms:.3f})")
        for key, kms, c in top:
            log(f"  {kms:9.4f} ms  x{c:<4d} {key}")
        return {"ms": wm_ms, "device_ms": busy, "launches": count,
                "idle_share": 1 - busy / wm_ms}

    def spmv_subset(cache, keep_long, zt, n):
        """A's CSR with only its long rows (keep_long) or only its short
        rows: the other rows emptied, their bins rebuilt."""
        row_ptr, cols, vals = cache["a"]
        order, n_long = cache["a_bins"]
        rp = row_ptr.cpu().numpy().astype(np.int64)
        lengths = np.diff(rp)
        is_long = np.zeros(len(lengths), dtype=bool)
        is_long[order[:n_long].cpu().numpy()] = True
        keep = is_long if keep_long else ~is_long
        new_lengths = np.where(keep, lengths, 0)
        new_rp = np.zeros(len(rp), dtype=np.int32)
        np.cumsum(new_lengths, out=new_rp[1:])
        entries = np.repeat(keep, lengths)
        idx = torch.from_numpy(np.flatnonzero(entries)).to(dev)
        sub_order, sub_long = fr.spmv_order(new_rp, n)
        return (torch.from_numpy(new_rp).to(dev), cols[idx].contiguous(),
                vals[:, idx].contiguous(), zt, n, 0), \
            (torch.from_numpy(sub_order).to(dev), sub_long), int(entries.sum())

    at = {}
    for compiled, z in (witness, witness512):
        cache = gpu_qap._cache(compiled, dev)
        n, k = cache["dom"].size, cache["dom"].log_size
        ni = compiled.num_instance
        zrows = torch.from_numpy(z_rows(z).view(np.int64)).to(dev)
        zt = fr.to_mont_cuda(zrows)
        nz = zt.shape[1]
        evals = torch.empty((3, fr.WORDS, n), dtype=torch.int32, device=dev)
        for x, m in zip(evals, "abc"):
            fr.spmv_cuda(*cache[m], zt, n, ni if m == "a" else 0, bins=cache[f"{m}_bins"], out=x)
        recs = {"z_warp_top_words": z_warp_top_words(z)}
        log(f"z at 2^{k}: warps of 32 rows by their highest nonzero word (-1: all 0): "
            f"{recs['z_warp_top_words']}")
        recs["entry"] = timed("fr_to_mont_kernel", fr.to_mont_cuda, (zrows,), lambda: (zrows,),
                              64 * nz, FR_MONT_MULS * nz)
        line(f"fr_to_mont_kernel (z, {nz} rows)", k, recs["entry"])
        recs["exit"] = timed("fr_from_mont_kernel", fr.from_mont_cuda, (evals[0],),
                             lambda: (evals[0],), 64 * n, FR_MONT_MULS * n)
        line("fr_from_mont_kernel", k, recs["exit"])
        for m in "abc":
            row_ptr, cols, _ = cache[m]
            margs = (*cache[m], zt, n, ni if m == "a" else 0)
            bins = cache[f"{m}_bins"]
            call = lambda *a, bins=bins: fr.spmv_cuda(*a, bins=bins)  # noqa: E731
            call.plain = lambda *a, bins=bins: fr.spmv(*a, bins=bins)
            call.launches = 0
            nbytes, ops = spmv_bytes_ops(row_ptr, cols.shape[0], nz, n)
            recs[m] = timed(f"fr_spmv_kernel {m}", call, margs, lambda margs=margs: margs,
                            nbytes, ops, kernel="fr_spmv_kernel")
            recs[m] |= {"nnz": cols.shape[0], "long_rows": bins[1]}
            line(f"fr_spmv_kernel {m.upper()} ({cols.shape[0]} nonzeros, {bins[1]} long rows)",
                 k, recs[m])
        for keep_long in (True, False):
            margs, bins, nnz = spmv_subset(cache, keep_long, zt, n)
            call = lambda *a, bins=bins: fr.spmv_cuda(*a, bins=bins)  # noqa: E731
            call.plain = lambda *a, bins=bins: fr.spmv(*a, bins=bins)
            nbytes, ops = spmv_bytes_ops(margs[0], nnz, nz, n)
            key = "a_long_rows" if keep_long else "a_short_rows"
            recs[key] = timed(f"fr_spmv_kernel {key}", call, margs, lambda margs=margs: margs,
                              nbytes, ops, plain_reps=1, kernel="fr_spmv_kernel")
            recs[key] |= {"nnz": nnz, "long_rows": bins[1]}
            line(f"fr_spmv_kernel A, {'long' if keep_long else 'short'} rows alone ({nnz} "
                 "nonzeros)", k, recs[key])
        tw, tw_inv, scale = cache["tw"], cache["tw_inv"], cache["scale"]
        t = min(n, 1 << fr.TILE_LOG)
        nbytes, ops = tile_bytes_ops(n, t, 3, True, True)
        trip = (evals.clone(), tw_inv, True, scale, tw)
        recs["tile"] = timed("fr_ntt_tile_kernel round trip", fr.ntt_tile_cuda, trip,
                             lambda: (evals.clone(), tw_inv, True, scale, tw), nbytes, ops,
                             kernel="fr_ntt_tile_kernel")
        line("fr_ntt_tile_kernel round trip (a, b, c: DIF over w^-1, scale, DIT over w)", k,
             recs["tile"])
        h = evals[0].clone()
        nbytes, ops = tile_bytes_ops(n, t, 1, False, True)
        recs["tile_dif_scale"] = timed(
            "fr_ntt_tile_kernel DIF + scale", fr.ntt_tile_cuda,
            (h, tw_inv, True, cache["scale_inv"]),
            lambda: (evals[0].clone(), tw_inv, True, cache["scale_inv"]), nbytes, ops,
            kernel="fr_ntt_tile_kernel")
        line("fr_ntt_tile_kernel DIF + scale (h's last tile)", k, recs["tile_dif_scale"])
        single = evals.clone()

        def six():
            for v in single:
                fr.ntt_tile_cuda(v, tw_inv, True, scale)
                fr.ntt_tile_cuda(v, tw, False)

        six_ms = cuda_ms(six)
        _, six_busy, _, _ = device_kernel_ms(six, keep=("fr_ntt_tile",))
        recs["six_single_tiles"] = {"ms": six_ms, "device_ms": six_busy}
        log(f"the same three vectors as six single-form tile launches (DIF + scale, DIT): "
            f"{six_ms:.4f} ms (device {six_busy:.4f} ms) against the round trip's "
            f"{recs['tile']['ms']:.4f} ms (device {recs['tile']['device_ms']:.4f} ms)")
        recs["witness_map"] = map_on_card(compiled, z, k)
        at[k] = recs
        del evals, single, h, trip

    compiled, z = witness
    cache = gpu_qap._cache(compiled, dev)
    dom = cache["dom"]
    n, k = dom.size, dom.log_size
    zt = fr.to_mont_cuda(torch.from_numpy(z_rows(z).view(np.int64)).to(dev))
    evals = [fr.spmv_cuda(*cache[m], zt, n, compiled.num_instance if m == "a" else 0,
                          bins=cache[f"{m}_bins"]) for m in "abc"]
    x = evals[0]
    cases = [
        ("fr_ntt_stage_kernel", fr.ntt_stage_cuda,
         lambda: (x.clone(), cache["tw_inv"], k - 1, True), 32 * (2 * n + n // 2),
         FR_MONT_MULS * n // 2, "fr_ntt_stage_kernelILb1", 256),
        ("fr_quotient_kernel", fr.quotient_cuda,
         lambda: (evals[0].clone(), *evals[1:], cache["zinv"]),
         32 * (4 * n + 1), 2 * FR_MONT_MULS * n, "fr_quotient_kernel", 256),
    ]
    # the DIT forms, which three of the seven transforms run: held to their
    # plain versions, not timed
    for wrapper, make in ((fr.ntt_tile_cuda, lambda: (x.clone(), cache["tw"], False)),
                          (fr.ntt_stage_cuda, lambda: (x.clone(), cache["tw"], k - 1, False))):
        got = wrapper(*make())
        torch.cuda.synchronize()
        assert torch.equal(got, wrapper.plain(*make())), f"DIT {wrapper.__name__} != plain"
        log(f"DIT {wrapper.__name__} at 2^{k}: equal word for word")
    source = "falcon_r1cs_tpu_torch/csrc/fr_mont.cu"
    replaces = ("none: the JAX package's witness map is host C "
                "(falcon_r1cs_tpu/snark/native_backend.py:312)")
    records = []
    for name, wrapper, make, nbytes, ops, mangled, threads in cases:
        rec = timed(name, wrapper, make(), make, nbytes, ops)
        extra = {}
        if name == "fr_quotient_kernel":
            # two products and a subtraction, no loop: what a product
            # issues, against the FR_MONT_MULS the bounds count
            extra["sass"] = fr_sass("fr_quotient_kernel")
            log(f"fr_quotient_kernel SASS a thread (two products): {extra['sass']}; the bounds "
                f"count {FR_MONT_MULS} multiplies a product")
        line(name, k, rec)
        records.append(record(
            name, source, replaces, launches[name], rec["err"], rec["ms"], rec["plain_ms"],
            nbytes, ops, device_ms=rec["device_ms"], **ptxas(build_log, mangled, threads),
            **extra))
    # the power tables, both modes at cell B's domain, the Falcon-1024 map's
    # and prove_large's, each with a random c: the stage twiddles of w, the
    # bit-reversed scales of 5.  Bound: 32 bytes an element written and the
    # 33 elements read, a product a distinct value (n / 2 twiddles, n
    # scales), whatever the kernel does; beside it the square-and-multiply
    # count (a product a set exponent bit) that bounded the form before.
    rng = np.random.default_rng(23)
    powers_at = {}
    for kk in (17, 18, 21):
        nn = 1 << kk
        cc = fr.planes_of([int.from_bytes(rng.bytes(32), "little") % fr.R], dev)
        for label, base, mode in (("stage", pow(5, (fr.R - 1) >> kk, fr.R), fr.MODE_STAGE),
                                  ("bitrev", 5, fr.MODE_BITREV)):
            args = (fr.squares_of(base, dev), cc, kk, mode)
            distinct = nn // 2 if mode == fr.MODE_STAGE else nn
            nbytes = 32 * (nn + fr.MAX_LOG + 1)
            rec = timed(f"fr_powers_kernel {label}", fr.powers_cuda, args, lambda args=args: args,
                        nbytes, FR_MONT_MULS * distinct, plain_reps=1 if kk > k else 3,
                        kernel="fr_powers_kernel")
            e = fr.exponents(nn, kk, mode)
            steps = sum(int(((e >> b) & 1).sum()) for b in range(kk))
            rec |= {"tile_s_t": fr.powers_tile(kk, mode), "steps": steps,
                    "steps_bound_ms": bound(nbytes, FR_MONT_MULS * steps)[0]}
            line(f"fr_powers_kernel {label} (s, t = {rec['tile_s_t']})", kk, rec)
            log(f"  against the square-and-multiply count ({steps} products): bound "
                f"{rec['steps_bound_ms']:.4f} ms, "
                f"{100 * rec['steps_bound_ms'] / rec['device_ms']:.1f} % of it")
            powers_at[f"{label} 2^{kk}"] = rec
    sass = fr_sass("fr_powers_kernel")
    log(f"fr_powers_kernel static SASS a thread (the tables and the element loop): {sass}")
    pw = powers_at[f"stage 2^{k}"]
    records.append(record(
        "fr_powers_kernel", source, replaces, launches["fr_powers_kernel"], pw["err"], pw["ms"],
        pw["plain_ms"], pw["nbytes"], pw["ops"], device_ms=pw["device_ms"],
        **ptxas(build_log, "fr_powers_kernel", fr.POW_THREADS), sass=sass, at=powers_at))
    # the entry: z at both maps (above), A's CSR values at 2^18 (full-width,
    # no round skipped: 1 launch of 3 a new circuit)
    a_vals = torch.from_numpy(np.ascontiguousarray(
        native_backend._compiled_cache(compiled)["a"][2]).view(np.int64)).to(dev)
    nnz = a_vals.shape[0]
    csr = timed("fr_to_mont_kernel A values", fr.to_mont_cuda, (a_vals,), lambda: (a_vals,),
                64 * nnz, FR_MONT_MULS * nnz, kernel="fr_to_mont_kernel")
    line(f"fr_to_mont_kernel on A's CSR values ({nnz} full-width rows)", k, csr)
    entry, exit_ = at[k]["entry"], at[k]["exit"]
    sass = fr_sass("fr_to_mont_kernel")
    log(f"fr_to_mont_kernel static SASS a thread ({fr.ENTRY_PER} rows, every round's branch): "
        f"{sass}")
    records.insert(0, record(
        "fr_to_mont_kernel", source, replaces, launches["fr_to_mont_kernel"], entry["err"],
        entry["ms"], entry["plain_ms"], entry["nbytes"], entry["ops"],
        device_ms=entry["device_ms"], **ptxas(build_log, "fr_to_mont_kernel", fr.ENTRY_THREADS),
        sass=sass, a_csr_values=csr,
        at={f"2^{kk}": {m: at[kk][m] for m in ("entry", "z_warp_top_words")} for kk in at},
        witness_map={f"2^{kk}": at[kk]["witness_map"] for kk in at}))
    # the exit: both maps (above) and prove_large's domain, 2^21
    x21 = fr.to_mont_cuda(torch.from_numpy(np.random.default_rng(21).integers(
        0, 2**63, size=(1 << 21, 4), dtype=np.int64)).to(dev))
    exit21 = timed("fr_from_mont_kernel", fr.from_mont_cuda, (x21,), lambda: (x21,), 64 << 21,
                   FR_MONT_MULS << 21, plain_reps=1)
    line("fr_from_mont_kernel", 21, exit21)
    del x21
    sass = fr_sass("fr_from_mont_kernel")
    log(f"fr_from_mont_kernel static SASS a thread ({fr.EXIT_PER} elements and the store "
        f"loop): {sass}")
    exit_threads = (1 << (2 * fr.EXIT_SIDE_LOG)) // fr.EXIT_PER
    records.insert(len(records) - 1, record(
        "fr_from_mont_kernel", source, replaces, launches["fr_from_mont_kernel"], exit_["err"],
        exit_["ms"], exit_["plain_ms"], exit_["nbytes"], exit_["ops"],
        device_ms=exit_["device_ms"], **ptxas(build_log, "fr_from_mont_kernel", exit_threads),
        sass=sass, at={**{f"2^{kk}": at[kk]["exit"] for kk in at}, "2^21": exit21}))
    spmv, tile = at[k]["a"], at[k]["tile"]
    records.insert(1, record(
        "fr_spmv_kernel", source, replaces, launches["fr_spmv_kernel"], spmv["err"],
        spmv["ms"], spmv["plain_ms"], spmv["nbytes"], spmv["ops"], device_ms=spmv["device_ms"],
        **ptxas(build_log, "fr_spmv_kernel", fr.SPMV_THREADS),
        at={f"2^{kk}": {m: at[kk][m] for m in ("a", "b", "c", "a_long_rows", "a_short_rows")}
            for kk in at}))
    records.insert(2, record(
        "fr_ntt_tile_kernel", source, replaces, launches["fr_ntt_tile_kernel"], tile["err"],
        tile["ms"], tile["plain_ms"], tile["nbytes"], tile["ops"], device_ms=tile["device_ms"],
        **ptxas(build_log, "fr_ntt_tile_kernelILi2E", (1 << fr.TILE_LOG) // fr.TILE_PER),
        dif_ptxas=ptxas(build_log, "fr_ntt_tile_kernelILi0E", (1 << fr.TILE_LOG) // fr.TILE_PER),
        at={f"2^{kk}": {m: at[kk][m] for m in ("tile", "tile_dif_scale", "six_single_tiles")}
            for kk in at}))
    return records


def launch_path_costs(y):
    """K7's launch path on y, step by step: host microseconds a call of
    each step alone (perf_counter over many calls), then CUDA-event ms of
    three forms of the whole launch -- the earlier one (a device context, a
    torch.cuda.Stream object, getattr on the library), a Stream object with
    no context, and the form `_build.launch` takes (raw stream, context
    only off the current device) -- beside torch.add(y, 1)."""
    from falcon_r1cs_tpu_torch.ops import _build

    lib = _build.library()
    fn = _build._FN["add_one_launch"]
    dev, n = y.device, y.numel()
    out = torch.empty_like(y)
    ptr_y, ptr_o = y.data_ptr(), out.data_ptr()

    def host_us(step, calls=20000):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    def with_device():
        with torch.cuda.device(dev):
            pass

    steps = {
        "dtype + contiguity checks": lambda: y.dtype == torch.int32 and y.is_contiguous(),
        "torch.empty_like": lambda: torch.empty_like(y),
        "data_ptr x2": lambda: (y.data_ptr(), out.data_ptr()),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: _build._raw_stream(dev.index),
        "torch.cuda.device context": with_device,
        "torch._C._cuda_getDevice": _build._get_device,
        "getattr(lib, name)": lambda: getattr(lib, "add_one_launch"),
        "ctypes call (launch)": lambda: fn(ptr_y, ptr_o, n, _build._raw_stream(dev.index)),
        "_build.launch": lambda: _build.launch("add_one_launch", dev, ptr_y, ptr_o, n),
        "add_one (whole wrapper)": lambda: _build.add_one(y),
        "torch.add(y, 1)": lambda: torch.add(y, 1),
    }
    costs = {k: host_us(v) for k, v in steps.items()}

    def legacy():
        o = torch.empty_like(y)
        with torch.cuda.device(dev):
            rc = getattr(lib, "add_one_launch")(
                y.data_ptr(), o.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(rc, "add_one_launch")

    def stream_object():
        o = torch.empty_like(y)
        _build.check_launch(
            fn(y.data_ptr(), o.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream),
            "add_one_launch")

    forms = {
        "context + Stream object + getattr": cuda_ms(legacy),
        "Stream object, no context": cuda_ms(stream_object),
        "_build.launch (raw stream)": cuda_ms(lambda: _build.add_one(y)),
        "torch.add(y, 1)": cuda_ms(lambda: torch.add(y, 1)),
    }
    return costs, forms


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    import falcon_r1cs_tpu_torch as port
    from falcon_r1cs_tpu_torch.falcon import (
        compress_signature,
        encode_public_key,
        make_instance,
        ntt,
    )
    from falcon_r1cs_tpu_torch.ops import _build, cuda_ntt, fq, fr, msm_bucket, msm_recode, ntt_v3
    from falcon_r1cs_tpu_torch.ops.ntt_limb import intt_then_hints
    from falcon_r1cs_tpu_torch.ops.schoolbook import schoolbook_prods_cuda
    from falcon_r1cs_tpu_torch.witness import packer_ntt, witness_engine

    # -- 1. environment ---------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0),
        "count", torch.cuda.device_count())
    log(subprocess.run(
        [_build._nvcc(), "--version"], check=True, capture_output=True, text=True
    ).stdout.strip().splitlines()[-1])
    dev = torch.device("cuda")

    # -- 2. build from the sources in the checkout -------------------------
    so, build_s, build_log = _build.build()
    log(f"build: {so.name} nvcc {build_s:.3f} s"
        + ("" if build_s else " (library already built for these sources)"))
    for line in build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry",
                                   "Function properties")):
            log("  ptxas:", line.strip())

    # -- wire-format inputs: N_SIGS distinct Falcon-1024 signatures --------
    params = port.FALCON_1024
    t0 = time.perf_counter()
    rng = np.random.default_rng(20261016)
    insts = [make_instance(rng, params, msg=b"msg %d" % i) for i in range(N_SIGS)]
    pk_bytes = [encode_public_key(i.h, params) for i in insts]
    sig_bytes = [compress_signature(i.sig_signed, i.nonce, params) for i in insts]
    msgs = [i.msg for i in insts]
    log(f"made {N_SIGS} wire-format instances: {time.perf_counter() - t0:.1f} s")

    # -- 3. the main path: counts reset just before, read just after ------
    t_phase = time.perf_counter()
    counted = {
        "ntt_hints_kernel": cuda_ntt.ntt_with_hints_cuda,
        "intt_ntt_hints_kernel": cuda_ntt.intt_ntt_hints_cuda,
        "add_one_kernel": _build.add_one,
    }
    for wrapper in counted.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()

    def run(pipe):
        before = {k: w.launches for k, w in counted.items()}
        t = time.perf_counter()
        out = pipe.run_wire(pk_bytes, msgs, sig_bytes)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        return out, seconds, {k: w.launches - before[k] for k, w in counted.items()}

    pipe = port.ProverInputPipeline(params, dev, pack=True)
    chunks = -(-N_SIGS // pipe.max_chunk)
    out, first_s, d_first = run(pipe)       # first call: loads + self-tests
    out, warm_s, d_warm = run(pipe)
    fused = port.ProverInputPipeline(
        params, dev, pack=True, config=port.RuntimeConfig(fused_intt=True)
    )
    out_f, first_f_s, d_first_f = run(fused)
    out_f, warm_f_s, d_warm_f = run(fused)
    launches = {k: w.launches for k, w in counted.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    log(f"main path: first call {first_s:.3f} s (library load + self-test), "
        f"warm {warm_s:.3f} s = {N_SIGS / warm_s:.1f} witnesses/s "
        f"(fused_intt off, wall clock incl. host decode + hash-to-point)")
    log(f"main path fused_intt on: first {first_f_s:.3f} s, warm {warm_f_s:.3f} s "
        f"= {N_SIGS / warm_f_s:.1f} witnesses/s; peak device memory {peak_gib:.2f} GiB")
    log("launches per call:", d_first, d_warm, d_first_f, d_warm_f)
    assert d_first["add_one_kernel"] == 1, d_first
    for d in (d_first, d_warm):
        assert d["ntt_hints_kernel"] == 2 * chunks, d
        assert d["intt_ntt_hints_kernel"] == 0, d
    for d in (d_first_f, d_warm_f):
        assert d["ntt_hints_kernel"] == chunks, d
        assert d["intt_ntt_hints_kernel"] == chunks, d
    assert all(v > 0 for v in launches.values()), launches

    # -- 4. is the main path's output right? -------------------------------
    circuit = port.FalconNTTVerificationCircuit
    packed = out.packed
    assert packed.shape == (N_SIGS, 156724, 5) and packed.dtype == torch.int32
    assert torch.equal(out_f.packed, packed), "fused_intt changed the packed export"
    h = np.stack([i.h for i in insts])
    hm = np.stack([i.hm for i in insts])
    assert np.array_equal(out.pk_ntt.cpu().numpy(), ntt(h))
    assert np.array_equal(out.hm_ntt.cpu().numpy(), ntt(hm))
    instance = torch.cat(
        [torch.ones((N_SIGS, 1), dtype=torch.int64, device=dev),
         out.pk_ntt.long(), out.hm_ntt.long()], dim=1,
    )
    trace_s = check_against_trace(
        port, circuit, insts[:N_TRACE], packed[:N_TRACE], instance[:N_TRACE]
    )
    log(f"packed witnesses and instance of {N_TRACE} signatures == host trace "
        f"({trace_s:.1f} s)")

    t0 = time.perf_counter()
    compiled = port.compile_circuit(circuit, insts[0], cache=False)
    rs = port.ResidueSystem(compiled, dev)
    log(f"compile_circuit + ResidueSystem: {time.perf_counter() - t0:.1f} s "
        f"(nnz A/B/C {compiled.nnz()})")
    # one sig coefficient of signature 5
    sat_s, _ = check_verdicts(rs, instance[:N_SAT], packed[:N_SAT], [(5, 3)])
    log(f"CRT check: {N_SAT} valid -> all True ({sat_s:.3f} s); "
        "one bumped witness -> exactly that signature False")

    # -- 4b. the dual-NTT and schoolbook paths: counts reset per path ------
    # the other kernels join the counts only here, after the main path's
    # all-launched check: each later path launches exactly its own
    path_counted = dict(
        counted, schoolbook_prods_kernel=schoolbook_prods_cuda,
        mont_mul_kernel=fq.mont_mul_cuda, point_add_kernel=fq.point_add_cuda,
        point_add_aff_kernel=fq.point_add_aff_cuda, ntt_semi_kernel=ntt_v3.ntt_semi_cuda,
        signed_digits_kernel=msm_recode.signed_digits_cuda,
        bucket_level_kernel=msm_bucket.bucket_level_cuda, **fr.KERNELS,
    )
    log(f"phase main path: {time.perf_counter() - t_phase:.1f} s")

    def phase(name, fn, *args):
        t = time.perf_counter()
        result = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return result

    phase("dual-NTT path", dual_path, port, dev, insts, path_counted)
    sb_launches = phase("schoolbook path", schoolbook_path, port, dev, insts, path_counted)
    g16_launches, h_msm, g16_witness = phase("groth16", groth16_path, port, dev, compiled,
                                             packed, instance, path_counted)
    semi_launches = phase("semi-carry path", semi_path, dev, path_counted)
    del out_f
    t_phase = time.perf_counter()

    # -- 5. each kernel against its plain version, on the card -------------
    records = []
    for p in (port.FALCON_512, port.FALCON_1024):
        x = torch.from_numpy(
            np.random.default_rng(p.n).integers(0, port.Q, size=(N_SIGS, p.n))
            .astype(np.int32)
        ).to(dev)
        # the edge rows: all q - 1 (the largest values at every stage), all
        # 0 and a one-hot row
        x[-3], x[-2], x[-1] = port.Q - 1, 0, 0
        x[-1, 7] = 1
        for name, mangled, wrapper, replaces in (
            ("ntt_hints_kernel", "16ntt_hints_kernelILi", cuda_ntt.ntt_with_hints_cuda,
             "falcon_r1cs_tpu/ops/pallas_ntt.py:168"),
            ("intt_ntt_hints_kernel", "21intt_ntt_hints_kernelILi",
             cuda_ntt.intt_ntt_hints_cuda, "falcon_r1cs_tpu/ops/pallas_ntt.py:186"),
        ):
            got = wrapper(x, p)
            torch.cuda.synchronize()
            want = wrapper.plain(x, p)
            err = max_abs_err(got, want)
            assert err == 0, f"{name} n={p.n} differs from its plain version"
            ms = cuda_ms(lambda: wrapper(x, p))
            dev_ms = kernel_device_ms(wrapper, (x, p), name)
            plain_ms = cuda_ms(lambda: wrapper.plain(x, p))
            log(f"{name} n={p.n} B={N_SIGS}: kernel {ms:.4f} ms (device {dev_ms:.4f} "
                f"ms), plain {plain_ms:.4f} ms, bit-equal (rows of all q - 1, all 0 "
                "and one-hot included)")
            # n / 8 threads a row
            stats = ptxas(build_log, f"{mangled}{p.log_n}E", p.n // 8)
            if p is params and wrapper is cuda_ntt.intt_ntt_hints_cuda:
                # the choice fused_intt makes: K2 vs torch INTT + K1
                unfused_ms = cuda_ms(lambda: intt_then_hints(x, p, False))
                log(f"v chain n={p.n} B={N_SIGS}: fused_intt on {ms:.4f} ms, "
                    f"off (torch INTT + hint kernel) {unfused_ms:.4f} ms")
            if p is params:
                # x read, t (11 limbs) and b written, the stage tables; the
                # limb sweep's multiply-adds (one per active limb per
                # butterfly) and the divmod's (one per limb per value)
                coeffs = N_SIGS * p.n
                nbytes = 4 * (13 * coeffs + p.log_n * p.n + (p.log_n + 1) * 11)
                mads = coeffs * (sum(cuda_ntt._active_limbs(p)) // 2 + 11)
                if wrapper is cuda_ntt.intt_ntt_hints_cuda:
                    # v written, the inverse tables; the INTT's Montgomery
                    # steps (4 per butterfly) and the n^-1 scaling (3 a value)
                    nbytes += 4 * (coeffs + p.log_n * p.n)
                    mads += N_SIGS * (p.log_n * p.n // 2 * 4 + 3 * p.n)
                records.append(record(
                    name, "falcon_r1cs_tpu_torch/csrc/ntt_hints.cu", replaces,
                    launches[name], err, ms, plain_ms, nbytes, mads,
                    device_ms=dev_ms, **stats,
                ))
    for p in (port.FALCON_512, port.FALCON_1024):
        rng = np.random.default_rng(p.n + 1)
        sig = torch.from_numpy(
            rng.integers(0, port.Q, size=(N_SB, p.n)).astype(np.int32)).to(dev)
        pk = torch.from_numpy(
            rng.integers(0, port.Q, size=(N_SB, p.n)).astype(np.int32)).to(dev)
        sig[0, :3] = port.Q - 1
        pk[0, :2] = torch.tensor([port.Q - 1, 0], dtype=torch.int32)
        wrapper = schoolbook_prods_cuda
        err = max_abs_err(wrapper(sig, pk, p.n), wrapper.plain(sig, pk, p.n))
        assert err == 0, f"schoolbook_prods_kernel n={p.n} differs from its plain version"
        ms = cuda_ms(lambda: wrapper(sig, pk, p.n))
        plain_ms = cuda_ms(lambda: wrapper.plain(sig, pk, p.n))
        gbs = N_SB * p.n * p.n * 4 / (ms * 1e-3) / 1e9
        log(f"schoolbook_prods_kernel n={p.n} B={N_SB}: kernel {ms:.4f} ms "
            f"({gbs:.0f} GB/s of prods written), plain {plain_ms:.4f} ms, bit-equal")
        if p is params:
            # sig, pk read, prods, H, L written; one multiply a product
            records.append(record(
                "schoolbook_prods_kernel", "falcon_r1cs_tpu_torch/csrc/schoolbook.cu",
                "falcon_r1cs_tpu/ops/pallas_schoolbook.py:45", sb_launches, err,
                ms, plain_ms, 4 * N_SB * p.n * (p.n + 4), N_SB * p.n * p.n,
            ))
        del sig, pk
    y = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    err = max_abs_err([_build.add_one(y)], [_build.add_one.plain(y)])
    assert err == 0
    k7_ms = cuda_ms(lambda: _build.add_one(y))
    add_ms = cuda_ms(lambda: torch.add(y, 1))
    records.append(record(
        "add_one_kernel", "falcon_r1cs_tpu_torch/csrc/ntt_hints.cu",
        "falcon_r1cs_tpu/ops/pallas_support.py:17", launches["add_one_kernel"],
        err, k7_ms, cuda_ms(lambda: _build.add_one.plain(y)), 2 * y.numel() * 4, 0,
        library_ms=add_ms,
    ))
    costs, forms = launch_path_costs(y)
    log(f"add_one_kernel (8, 128): {k7_ms:.4f} ms against torch.add {add_ms:.4f} ms"
        + (" (K7 loses)" if k7_ms > add_ms else ""))
    log("  launch forms, CUDA events ms a call: "
        + "; ".join(f"{k} {v:.4f}" for k, v in forms.items()))
    log("  launch path, host us a call of each step: "
        + "; ".join(f"{k} {v:.2f}" for k, v in costs.items()))
    records += fq_kernels_vs_plain(dev, g16_launches, build_log)
    records.append(recode_kernel_vs_plain(dev, g16_launches["signed_digits_kernel"], build_log))
    witness512 = falcon512_witness()
    records.append(bucket_kernel_vs_plain(dev, g16_launches["bucket_level_kernel"], build_log,
                                          witness512[1]))
    records += fr_kernels_vs_plain(dev, g16_launches, g16_witness, witness512, build_log)
    records.append(semi_kernel_vs_plain(dev, semi_launches, build_log))

    # device part of the main path alone: engine + packer on uploaded inputs
    engine = witness_engine(params.n)
    pack = packer_ntt(params.n, dev)
    sig = torch.from_numpy(
        np.stack([i.sig_lifted for i in insts]).astype(np.int16)
    ).to(dev)
    dev_ms = cuda_ms(lambda: pack(engine(sig, out.pk_ntt, out.hm_ntt)), reps=5, inner=2)
    eng_ms = cuda_ms(lambda: engine(sig, out.pk_ntt, out.hm_ntt), reps=5, inner=2)
    log(f"device engine {eng_ms:.3f} ms + packer = {dev_ms:.3f} ms per "
        f"{N_SIGS}-batch = {N_SIGS / dev_ms * 1e3:.1f} witnesses/s device-only")

    log(f"phase kernels vs plain: {time.perf_counter() - t_phase:.1f} s")

    # -- 6. device verify and the user entry points ------------------------
    # after the kernels' timing windows: a profiler window of this phase
    # holds ~700 launches, and the kernels' windows must catch every launch
    phase("device verify", verify_phase, port, dev, insts, path_counted, card)
    phase("cli", cli_phase, dev, path_counted)
    sharded = phase("parallel", parallel_phase, port, dev, insts, out, rs, instance, packed,
                    h_msm, path_counted)
    large = phase("large prover", large_phase, dev, path_counted, h_msm[0])
    tools = phase("tools", tools_phase, dev, path_counted)
    bench = phase("bench", bench_phase, path_counted)
    for rec in records:
        if rec["name"] == "signed_digits_kernel":
            rec["path_recode_ms"] = {f"n_pad 2^{n.bit_length() - 1}": ms
                                     for n, ms in sorted(MSM_RECODE_MS.items())}
            assert len(MSM_RECODE_MS) == 3, MSM_RECODE_MS  # 2^17, 2^18, 2^21
        for key, steps in (("sharded_launches", sharded), ("large_launches", large),
                           ("tools_launches", tools), ("bench_launches", bench)):
            rec[key] = {path: counts[rec["name"]]
                        for path, counts in steps.items() if rec["name"] in counts}

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "falcon_r1cs_tpu")]
    assert not loaded, f"the port loaded JAX or the JAX package: {loaded}"
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
