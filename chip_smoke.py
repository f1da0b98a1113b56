"""Chip smoke of the PyTorch + CUDA port (falcon_r1cs_tpu_torch).

Drives the port's paths once on one CUDA card at full Falcon-1024 width:

- the main path: 1024 distinct wire-format signatures ->
  ProverInputPipeline -> packed verify-with-NTT witnesses -> CRT
  satisfiability verdict, with the default v chain and with the fused
  INTT + hint kernel;
- the dual-NTT path: 512 signatures -> circuit_witness engine + packer ->
  CRT verdict plus the host check of the field rows;
- the schoolbook path: 128 signatures -> circuit_witness engine + packer
  (1,150,004 witnesses of 8 limbs each) -> CRT verdict plus field rows.

It builds the kernels from csrc/, checks that each path launched its
kernels (counts set to 0 just before the path, read just after), holds
each kernel against its plain torch version on the card (bit-exact: all
integer arithmetic), and times both with CUDA events.

    python3 chip_smoke.py

Exits non-zero, printing no result, when no CUDA card is present or any
check fails.  The last line of standard output is one JSON object with
the device; the line before it is the card's name and power limit, and
the line before that the per-kernel JSON record.
"""

import json
import statistics
import subprocess
import sys
import time

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
TIMING_REPS = 20


def log(*args):
    print(*args, flush=True)


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


def unpack(packed):
    """(B, W, L) int32 u32 limbs -> (B, W) object array of Python ints.
    Only the values with a nonzero high limb are assembled limb by limb."""
    packed = packed.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    vals = packed[:, :, 0].astype(object)
    for b, w in zip(*np.nonzero(packed[:, :, 1:].any(axis=-1))):
        v = 0
        for k in range(packed.shape[2] - 1, -1, -1):
            v = (v << 32) | int(packed[b, w, k])
        vals[b, w] = v
    return vals


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
    from falcon_r1cs_tpu_torch.ops import _build, cuda_ntt
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
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
    path_counted = dict(counted, schoolbook_prods_kernel=schoolbook_prods_cuda)
    dual_path(port, dev, insts, path_counted)
    sb_launches = schoolbook_path(port, dev, insts, path_counted)

    # -- 5. each kernel against its plain version, on the card -------------
    records = []
    for p in (port.FALCON_512, port.FALCON_1024):
        x = torch.from_numpy(
            np.random.default_rng(p.n).integers(0, port.Q, size=(N_SIGS, p.n))
            .astype(np.int32)
        ).to(dev)
        for name, wrapper, replaces in (
            ("ntt_hints_kernel", cuda_ntt.ntt_with_hints_cuda,
             "falcon_r1cs_tpu/ops/pallas_ntt.py:168"),
            ("intt_ntt_hints_kernel", cuda_ntt.intt_ntt_hints_cuda,
             "falcon_r1cs_tpu/ops/pallas_ntt.py:186"),
        ):
            got = wrapper(x, p)
            want = wrapper.plain(x, p)
            err = max_abs_err(got, want)
            assert err == 0, f"{name} n={p.n} differs from its plain version"
            ms = cuda_ms(lambda: wrapper(x, p))
            plain_ms = cuda_ms(lambda: wrapper.plain(x, p))
            log(f"{name} n={p.n} B={N_SIGS}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bit-equal")
            if p is params and wrapper is cuda_ntt.intt_ntt_hints_cuda:
                # the choice fused_intt makes: K2 vs torch INTT + K1
                unfused_ms = cuda_ms(lambda: intt_then_hints(x, p, False))
                log(f"v chain n={p.n} B={N_SIGS}: fused_intt on {ms:.4f} ms, "
                    f"off (torch INTT + hint kernel) {unfused_ms:.4f} ms")
            if p is params:
                records.append(dict(
                    name=name, route="cuda",
                    source="falcon_r1cs_tpu_torch/csrc/ntt_hints.cu",
                    replaces=replaces, launches=launches[name],
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
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
            records.append(dict(
                name="schoolbook_prods_kernel", route="cuda",
                source="falcon_r1cs_tpu_torch/csrc/schoolbook.cu",
                replaces="falcon_r1cs_tpu/ops/pallas_schoolbook.py:45",
                launches=sb_launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            ))
        del sig, pk
    y = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    err = max_abs_err([_build.add_one(y)], [_build.add_one.plain(y)])
    assert err == 0
    records.append(dict(
        name="add_one_kernel", route="cuda",
        source="falcon_r1cs_tpu_torch/csrc/ntt_hints.cu",
        replaces="falcon_r1cs_tpu/ops/pallas_support.py:17",
        launches=launches["add_one_kernel"], max_abs_err=err,
        ms=cuda_ms(lambda: _build.add_one(y)),
        plain_ms=cuda_ms(lambda: _build.add_one.plain(y)),
    ))

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

    assert "jax" not in sys.modules, "the port loaded JAX"
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
