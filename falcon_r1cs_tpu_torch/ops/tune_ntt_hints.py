"""Layout variants of the hint kernels K1 and K2, built side by side from
`csrc/ntt_hints.cu` and timed in turns on one CUDA card.

    python -m falcon_r1cs_tpu_torch.ops.tune_ntt_hints [--out DIR]

Each variant is the committed source with one change of layout:

- `two_regions` (the committed form): one row a CTA, n / 8 threads, two
  shared regions used in turn, one barrier an exchange;
- `one_region`: one region, a barrier before and after each exchange's
  writes (half the shared memory, twice the barriers);
- `one_region_8_ctas`: that, with `__launch_bounds__(n / 8, 8)` so that 8
  CTAs (1,056 rows) fit the card at once;
- `streaming_stores`: t and b written with `__stcs` (evict-first);
- `persistent_G`: at most G CTAs, each looping over rows (row +=
  gridDim.x, a barrier between rows), so that a CTA's next row computes
  while its last row's stores drain.

For each it prints the ptxas lines, then, on rows random but for one of
all q - 1, one of all 0 and a one-hot one, at (n, B) = (1024, 1024),
(1024, 512) (the dual-NTT path's) and (512, 1024): bit-equality with the plain
versions, the median CUDA-event ms a call (20 samples of 5 back-to-back
calls) and the profiler device ms a launch (20 launches), in the order
variants, then variants reversed.  For the committed form it also counts
the SASS instructions of each kernel by opcode (`cuobjdump -sass`): the
kernels are fully unrolled, so the count is the instructions a thread
issues.  Needs nvcc and a card; builds under DIR (default build/tune in
the checkout).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..params import FALCON_512, FALCON_1024, Q
from . import _build, cuda_ntt


def _one_region(s):
    s = s.replace("__shared__ u32 sh[2 * kXchgWords * N];", "__shared__ u32 sh[kXchgWords * N];")
    s = s.replace("sh + (X & 1) * kXchgWords * N", "sh")
    return s.replace("  const int from = swz(own<HFrom>(t)), to = swz(own<HTo>(t));\n",
                     "  __syncthreads();\n"
                     "  const int from = swz(own<HFrom>(t)), to = swz(own<HTo>(t));\n")


def _min_blocks(s, blocks):
    return s.replace("__launch_bounds__((1 << LOG_N) / kPer)",
                     f"__launch_bounds__((1 << LOG_N) / kPer, {blocks})")


def _streaming(s):
    s = re.sub(r"dst\[(\d)\] = make_int4\(", r"__stcs(dst + \1, make_int4(", s)
    return re.sub(r"(__stcs\(dst \+ \d, make_int4\([^;]*\));", r"\1);", s)


def _persistent(s, grid):
    s = s.replace("  const int row = blockIdx.x, t = threadIdx.x;\n",
                  "  const int t = threadIdx.x;\n"
                  "  for (int row = blockIdx.x; row < batch; row += gridDim.x) {\n")
    s = s.replace("  divmod_store<LOG_N>(x, t_out, b_out, row, batch, t);\n}\n",
                  "  divmod_store<LOG_N>(x, t_out, b_out, row, batch, t);\n"
                  "  __syncthreads();\n  }\n}\n")
    return s.replace("<<<batch, ", f"<<<batch < {grid} ? batch : {grid}, ")


def variants(src: str) -> dict:
    """name -> source text; each transform must change the source."""
    out = {
        "two_regions": src,
        "one_region": _one_region(src),
        "one_region_8_ctas": _min_blocks(_one_region(src), 8),
        "streaming_stores": _streaming(src),
    }
    for grid in (256, 342, 512, 660):
        out[f"persistent_{grid}"] = _persistent(src, grid)
    assert len(set(out.values())) == len(out), "a transform no longer applies"
    return out


def _build_all(root: Path, sources: dict) -> dict:
    """Compile each variant into its own library, all nvcc processes at
    once; print the ptxas lines; name -> loaded library."""
    header = _build._CSRC / "carry_chain.cuh"
    procs = {}
    for name, text in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / "ntt_hints.cu").write_text(text)
        shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "ntt_hints.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        for line in log.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.ntt_hints_launch.argtypes = _build._ARGTYPES["ntt_hints_launch"]
        lib.intt_ntt_hints_launch.argtypes = _build._ARGTYPES["intt_ntt_hints_launch"]
        libs[name] = lib
    return libs


def sass_counts(so: Path) -> dict:
    """kernel name -> Counter of SASS opcodes (without modifiers)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[name][m.group(2)] += 1
    return counts


def _cuda_ms(fn, reps=20, inner=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_ms(fn, calls=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) / 1e3 / calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune"))
    root = Path(ap.parse_args().out)
    if root.exists():
        shutil.rmtree(root)
    libs = _build_all(root, variants((_build._CSRC / "ntt_hints.cu").read_text()))
    for kernel, ops in sass_counts(root / "two_regions" / "lib.so").items():
        if "ILi10E" in kernel:
            print(f"SASS {kernel}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    for p, rows in ((FALCON_1024, 1024), (FALCON_1024, 512), (FALCON_512, 1024)):
        x = torch.from_numpy(np.random.default_rng(p.n).integers(0, Q, size=(rows, p.n))
                             .astype(np.int32)).to(dev)
        x[-3], x[-2], x[-1] = Q - 1, 0, 0
        x[-1, 7] = 1
        tab = cuda_ntt._tables(p.n, dev)
        want = {"K1": cuda_ntt.ntt_with_hints_cuda.plain(x, p),
                "K2": cuda_ntt.intt_ntt_hints_cuda.plain(x, p)}
        batch, n = x.shape
        t = torch.empty((11, batch, n), dtype=torch.int32, device=dev)
        b = torch.empty((batch, n), dtype=torch.int32, device=dev)
        v = torch.empty((batch, n), dtype=torch.int32, device=dev)

        def launch(lib, kernel):
            stream = torch.cuda.current_stream().cuda_stream
            if kernel == "K1":
                rc = lib.ntt_hints_launch(x.data_ptr(), tab["roots"].data_ptr(),
                                          tab["bound_words"].data_ptr(), t.data_ptr(),
                                          b.data_ptr(), batch, p.log_n, stream)
            else:
                rc = lib.intt_ntt_hints_launch(
                    x.data_ptr(), tab["roots"].data_ptr(), tab["inv_roots"].data_ptr(),
                    tab["bound_words"].data_ptr(), t.data_ptr(), b.data_ptr(), v.data_ptr(),
                    batch, p.log_n, stream)
            _build.check_launch(rc, kernel)

        res = collections.defaultdict(list)
        for name in list(libs) + list(libs)[::-1]:
            for kernel in ("K1", "K2"):
                t.zero_()
                launch(libs[name], kernel)
                torch.cuda.synchronize()
                got = (t, b) if kernel == "K1" else (t, b, v)
                assert all(torch.equal(g, w) for g, w in zip(got, want[kernel])), (name, kernel)
                res[kernel, name].append((_cuda_ms(lambda: launch(libs[name], kernel)),
                                          _device_ms(lambda: launch(libs[name], kernel))))
        for (kernel, name), vals in sorted(res.items()):
            print(f"n={p.n} B={batch} {kernel} {name:18s} bit-equal; "
                  + "; ".join(f"events {e:.4f} ms, device {d:.4f} ms" for e, d in vals))


if __name__ == "__main__":
    main()
