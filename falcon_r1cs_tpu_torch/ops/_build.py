"""Build, load, self-test and launch the port's CUDA kernels.

The counterpart of `falcon_r1cs_tpu/ops/pallas_support.py`.  The sources
under `csrc/` are compiled with `nvcc` for sm_90a, one compiler process
per source, all started together, and linked into one shared library
with a plain C interface, at first use, into `build/kernels/` beside the
package (a directory git ignores), under a name keyed by a hash of the
sources and the flags.  The library is loaded with ctypes.  Right after
loading, the x + 1 kernel (`add_one`, the port of the Pallas capability
probe) runs once and the load raises if its result is wrong.

Every kernel launch of the port goes through `launch(name, device,
*args)`, one path for all wrappers.  Its form, the fastest of those timed
on the card (chip_smoke.py `launch_path_costs`, PERF.md section 6): each
C entry point is bound once, when the library loads, and published
(`_FN`) once the self-test has passed; it is called with the raw handle
of the current stream from `torch._C._cuda_getCurrentRawStream` (no
`torch.cuda.Stream` object); a device context is entered only when the
tensors' device is not the current one; a non-zero return raises.  Nothing is cached per stream,
so a caller's `torch.cuda.stream(...)` is always honoured.

This is not a probe that picks a fallback: a failed build, load,
self-test or launch raises, and nothing here runs on a machine without a
CUDA card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "ntt_hints_launch": [_P] * 5 + [_I, _I, _P],
    "intt_ntt_hints_launch": [_P] * 7 + [_I, _I, _P],
    "ntt_semi_launch": [_P, _P, _P, _P, _I, _I, _P],
    "ntt_semi_hints_launch": [_P] * 5 + [_I, _I, _P],
    "add_one_launch": [_P, _P, _I, _P],
    "schoolbook_prods_launch": [_P, _P, _P, _P, _P, _I, _I, _P],
    "mont_mul_launch": [_P, _P, _P, _I, _I, _P],
    "point_add_launch": [_P] * 12 + [_I, _P],
    "point_add_aff_launch": [_P] * 10 + [_I, _P],
    "signed_digits_launch": [_P] * 4 + [_I] * 5 + [_P],
    "bucket_level_launch": [_P] * 21 + [_I] * 4 + [_P],
    "fr_to_mont_launch": [_P, _P, _I, _P],
    "fr_from_mont_launch": [_P, _P, _I, _I, _P],
    "fr_spmv_launch": [_P, _P, _P, _I, _P, _I, _P] + [_I] * 3 + [_P, _I, _P],
    "fr_ntt_tile_launch": [_P] * 4 + [_I] * 4 + [_P],
    "fr_ntt_stage_launch": [_P, _P] + [_I] * 3 + [_P],
    "fr_quotient_launch": [_P] * 4 + [_I, _P],
    "fr_powers_launch": [_P] * 3 + [_I] * 3 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(f"nvcc not found (CUDA_HOME={cuda_home}, PATH)")


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libfalcon_r1cs_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, float, str]:
    """Compile the kernels if the keyed library is missing.

    Returns (library path, seconds spent compiling and linking, nvcc's
    log).  Each source compiles to an object in its own nvcc process, all
    at once; the link writes to a temporary file that is renamed into
    place, so a concurrent or interrupted build never leaves a partial
    library."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs = sorted(_CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in srcs]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(srcs, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [
            src.name for src, proc in zip(srcs, procs) if proc.returncode != 0
        ]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = str(Path(tmp) / so.name)
        proc = subprocess.run(
            [nvcc, *LINK_FLAGS, "-o", lib, *objs], capture_output=True, text=True
        )
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(lib, so)
    return so, time.perf_counter() - t0, log


def sass_counts(so: Path) -> dict:
    """kernel name -> Counter of the SASS opcodes (without modifiers) of a
    built library, from `cuobjdump -sass` beside nvcc."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
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


def check_launch(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


# the library's C entry points, published by `library()` once its
# self-test has passed
_FN: dict = {}
# torch's current device and raw current stream (a CPU-only build of torch
# has neither, and launches nothing)
_get_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C launcher `name` with `args` (ints: pointers from
    `data_ptr()`, sizes) and the raw handle of the current stream of
    `device` (a CUDA device with its index); raise on a CUDA error."""
    fn = _FN.get(name)
    if fn is None:
        library()
        fn = _FN[name]
    index = device.index
    if index == _get_device():
        rc = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, _raw_stream(index))
    if rc != 0:
        check_launch(rc, name)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded, bound and self-tested once per
    process.  Its entry points reach `_FN` only after the self-test
    passed, so a library that failed it is never launched, and the next
    launch tries (and raises) again."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    fns = {}
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    _self_test(fns["add_one_launch"])
    _FN.update(fns)
    return lib


def _self_test(add_one_launch) -> None:
    """x + 1 on (8, 128) through the freshly bound entry point, on the
    current device; K7's one launch a process, counted by `add_one`."""
    x = torch.arange(8 * 128, dtype=torch.int32, device="cuda").reshape(8, 128)
    out = torch.empty_like(x)
    check_launch(
        add_one_launch(x.data_ptr(), out.data_ptr(), x.numel(), _raw_stream(_get_device())),
        "add_one_launch",
    )
    add_one.launches += 1
    if not torch.equal(out, x + 1):
        raise RuntimeError("kernel library self-test (x + 1) failed")


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 on a contiguous int32 tensor: the CUDA kernel for a CUDA
    tensor, plain torch for a CPU tensor."""
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("add_one wants a contiguous int32 tensor")
    if x.device.type == "cpu":
        return add_one.plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    out = torch.empty_like(x)
    launch("add_one_launch", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    add_one.launches += 1
    return out


add_one.launches = 0
add_one.plain = lambda x: x + 1
