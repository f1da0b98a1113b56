"""Native host-side primitives: ctypes bindings for falcon_native.c.

The port's copy of `falcon_r1cs_tpu/native`.  The C sources are built with
gcc at first use into the git-ignored `build/native/` beside the package,
never beside the source, under a name keyed by a hash of the sources, the
flags and the host CPU's feature flags: `-march=native` ties a library to
the CPU it was built on, so a library built on one host is never loaded on
another.  `build_library` also builds the Groth16 backend
(snark/native_backend.py).  Falls back cleanly (ImportError/OSError) so
pure-Python paths keep working when no compiler is present.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parents[1] / "build" / "native"
_SRC = _HERE / "falcon_native.c"
_FLAGS = ("-O3", "-shared", "-fPIC", "-march=native", "-fopenmp")
# retried without openmp/march (portability)
_PLAIN_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


@functools.lru_cache(maxsize=None)
def _host_cpu() -> str:
    """The host CPU's feature flags (the first `flags` line of
    /proc/cpuinfo), or the platform's machine name where there is none."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return os.uname().machine


def build_library(src: Path, deps=()) -> Path:
    """gcc `src` (with the headers `deps` beside it) into a shared library
    under build/native/ keyed by sources, flags and host CPU; return its
    path.  A finished library is reused; the build writes to a temporary
    file renamed into place, so a concurrent or interrupted build never
    leaves a partial library."""
    h = hashlib.sha256(" ".join(_FLAGS + _PLAIN_FLAGS).encode())
    h.update(_host_cpu().encode())
    for path in (src, *deps):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    so = _BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        out = str(Path(tmp) / so.name)
        try:
            subprocess.run(
                ["gcc", *_FLAGS, str(src), "-o", out],
                check=True, capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            subprocess.run(
                ["gcc", *_PLAIN_FLAGS, str(src), "-o", out],
                check=True, capture_output=True,
            )
        os.replace(out, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(_SRC)))
    lib.hash_to_point_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
        ctypes.c_long,
    ]
    lib.shake256.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    for fn in (lib.decode_pk_batch, lib.decode_sig_batch):
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.c_long,
        ]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def native_shake256(data: bytes, out_len: int) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(out_len)
    lib.shake256(data, len(data), out, out_len)
    return out.raw


def native_hash_to_point_batch(msgs, nonces, n: int) -> np.ndarray:
    """Batched hash-to-point -> (batch, n) int64, bit-exact with the
    pure-Python hashlib path."""
    lib = _load()
    batch = len(msgs)
    blob = b"".join(msgs)
    offsets = np.zeros(batch + 1, dtype=np.int64)
    np.cumsum([len(m) for m in msgs], out=offsets[1:])
    nonce_len = len(nonces[0])
    for nc in nonces:
        if len(nc) != nonce_len:
            raise ValueError("all nonces must have equal length")
    nblob = b"".join(nonces)
    out = np.empty((batch, n), dtype=np.int32)
    lib.hash_to_point_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nblob,
        nonce_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        batch,
        n,
    )
    return out.astype(np.int64)


def native_decode_pk_batch(pk_bytes_list, n: int) -> np.ndarray:
    """Batched public-key decode (bodies after the header byte) -> (B, n)
    int32 coefficients.  Raises ValueError on any malformed key."""
    lib = _load()
    stride = len(pk_bytes_list[0]) - 1
    if any(len(pkb) != stride + 1 for pkb in pk_bytes_list):
        raise ValueError("mixed public-key lengths in batch")
    bodies = b"".join(pkb[1:] for pkb in pk_bytes_list)
    out = np.empty((len(pk_bytes_list), n), dtype=np.int32)
    rc = lib.decode_pk_batch(
        bodies, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(pk_bytes_list), n,
    )
    if rc:
        raise ValueError("malformed public key in batch")
    return out


def native_decode_sig_batch(sig_bytes_list, n: int, nonce_len: int = 40):
    """Batched signature decode -> ((B, n) int32 signed coeffs, list of
    nonces).  Raises ValueError on any malformed signature."""
    lib = _load()
    stride = len(sig_bytes_list[0]) - 1 - nonce_len
    if any(len(s) != stride + 1 + nonce_len for s in sig_bytes_list):
        raise ValueError("mixed signature lengths in batch")
    bodies = b"".join(s[1 + nonce_len:] for s in sig_bytes_list)
    nonces = [s[1:1 + nonce_len] for s in sig_bytes_list]
    out = np.empty((len(sig_bytes_list), n), dtype=np.int32)
    rc = lib.decode_sig_batch(
        bodies, stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sig_bytes_list), n,
    )
    if rc:
        raise ValueError("malformed signature in batch")
    return out, nonces
