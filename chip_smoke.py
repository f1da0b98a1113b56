"""Chip smoke of the PyTorch + CUDA port (falcon_r1cs_tpu_torch).

Drives the port's main path once on one CUDA card at full Falcon-1024
width: 1024 distinct wire-format signatures -> ProverInputPipeline ->
packed verify-with-NTT witnesses -> CRT satisfiability verdict, with the
default v chain and with the fused INTT + hint kernel.  It builds the
kernels from csrc/, checks that the main path launched each of them,
holds each kernel against its plain torch version on the card (bit-exact:
all integer arithmetic), and times both with CUDA events.

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
    """(B, W, 5) int32 u32 limbs -> (B, W) object array of Python ints."""
    packed = packed.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    vals = np.zeros(packed.shape[:2], dtype=object)
    for k in range(packed.shape[2] - 1, -1, -1):
        vals = (vals << 32) + packed[:, :, k]
    return vals


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
    t0 = time.perf_counter()
    vals = unpack(packed[:N_TRACE])
    for b in range(N_TRACE):
        cs = port.ConstraintSystem()
        circuit.build_circuit(insts[b]).generate_constraints(cs)
        assert list(vals[b]) == cs.witness_values, f"signature {b} != host trace"
    log(f"packed witnesses of {N_TRACE} signatures == host trace "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    compiled = port.compile_circuit(circuit, insts[0], cache=False)
    rs = port.ResidueSystem(compiled, dev)
    log(f"compile_circuit + ResidueSystem: {time.perf_counter() - t0:.1f} s "
        f"(nnz A/B/C {compiled.nnz()})")
    instance = torch.cat(
        [
            torch.ones((N_SAT, 1), dtype=torch.int64, device=dev),
            out.pk_ntt[:N_SAT].long(),
            out.hm_ntt[:N_SAT].long(),
        ],
        dim=1,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verdict = rs.check_device(rs.witness_residues_from_packed(instance, packed[:N_SAT]))
    torch.cuda.synchronize()
    sat_s = time.perf_counter() - t0
    assert verdict.all().item(), "a valid signature failed the CRT check"
    bad = packed[:N_SAT].clone()
    bad[5, 3, 0] += 1  # one sig coefficient of signature 5
    verdict_bad = rs.check_device(rs.witness_residues_from_packed(instance, bad))
    assert (~verdict_bad).nonzero().flatten().tolist() == [5], verdict_bad
    log(f"CRT check: {N_SAT} valid -> all True ({sat_s:.3f} s); "
        "one bumped witness -> exactly that signature False")

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
