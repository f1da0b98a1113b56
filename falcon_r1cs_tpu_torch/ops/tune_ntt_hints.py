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
calls) and the profiler device ms a launch (from a window of 20 launches
that caught all 20; up to three windows, else it raises), in the order
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
import functools
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


def build_variants(root: Path, filename: str, sources: dict, entries) -> dict:
    """Compile each variant (name -> text of `csrc/<filename>`) into its own
    library, all nvcc processes at once, beside a copy of the headers;
    print the ptxas lines; bind the C `entries`; name -> loaded library."""
    procs = {}
    for name, text in sources.items():
        d = root / name
        d.mkdir(parents=True)
        (d / filename).write_text(text)
        for header in _build._CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / filename)],
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
        for entry in entries:
            getattr(lib, entry).argtypes = _build._ARGTYPES[entry]
        libs[name] = lib
    return libs


def print_sass(so: Path, fragment: str = "ILi10E") -> None:
    """The SASS opcode counts of each kernel of `so` whose name holds
    `fragment`: the kernels are fully unrolled, so the count is the
    instructions a thread issues."""
    for kernel, ops in _build.sass_counts(so).items():
        if fragment in kernel:
            print(f"SASS {kernel}: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common()))


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


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


def _device_ms(fn, kernel, calls=20, tries=3):
    """Profiler device ms a launch of `calls` fn() calls, from a window that
    caught exactly `calls` launches of one kernel, whose name holds
    `kernel`.  The profiler can drop rows (PERF.md section 7), so up to
    `tries` windows are taken; if none was whole but the last caught only
    that kernel, its time over the launches it caught (each row carries
    its own launch's time); if it caught none, nan; either said so on
    stdout.  It raises if a window caught another kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if len(rows) == 1 and kernel in rows[0].key and rows[0].count == calls:
            return rows[0].self_device_time_total / 1e3 / calls
    if len(rows) == 1 and kernel in rows[0].key and rows[0].count:
        print(f"{kernel}: no window of {tries} caught all {calls} launches; device ms over "
              f"the {rows[0].count} the last one caught")
        return rows[0].self_device_time_total / 1e3 / rows[0].count
    if not rows:
        print(f"{kernel}: no window of {tries} caught a launch; device ms nan")
        return float("nan")
    raise RuntimeError(f"{calls} launches of {kernel} expected, the profiler caught "
                       f"{[(e.key[:60], e.count) for e in rows]}")


def in_turns(libs: dict, kinds: dict, check, launch) -> dict:
    """Each variant, in order, then reversed, and each kind (kind -> a
    fragment of its kernel's name): `check(lib, kind)` launches once and
    asserts bit-equality, then `launch(lib, kind)` is timed by CUDA events
    and profiler device time; (kind, name) -> [(events ms, device ms)]."""
    res = collections.defaultdict(list)
    for name in list(libs) + list(libs)[::-1]:
        for kind, kernel in kinds.items():
            check(libs[name], kind)
            run = functools.partial(launch, libs[name], kind)
            res[kind, name].append((_cuda_ms(run), _device_ms(run, kernel)))
    return res


def print_turns(res: dict, label: str) -> None:
    for (kind, name), vals in sorted(res.items()):
        print(f"{label} {kind:5s} {name:18s} bit-equal; "
              + "; ".join(f"events {e:.4f} ms, device {d:.4f} ms" for e, d in vals))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(_build._BUILD_DIR.parent / "tune"))
    root = Path(ap.parse_args().out)
    if root.exists():
        shutil.rmtree(root)
    src = (_build._CSRC / "ntt_hints.cu").read_text()
    libs = build_variants(root, "ntt_hints.cu", variants(src),
                          ("ntt_hints_launch", "intt_ntt_hints_launch"))
    print_sass(root / "two_regions" / "lib.so")
    print(card_name())
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

        def check(lib, kernel):
            t.zero_()
            launch(lib, kernel)
            torch.cuda.synchronize()
            got = (t, b) if kernel == "K1" else (t, b, v)
            assert all(torch.equal(g, w) for g, w in zip(got, want[kernel])), kernel

        kinds = {"K1": "ntt_hints_kernel", "K2": "intt_ntt_hints_kernel"}
        print_turns(in_turns(libs, kinds, check, launch), f"n={p.n} B={batch}")


if __name__ == "__main__":
    main()
