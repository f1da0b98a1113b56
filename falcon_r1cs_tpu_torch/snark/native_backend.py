"""ctypes bindings for native/groth16_native.c (the MSM/FFT hot path).

The port's copy of `falcon_r1cs_tpu/snark/native_backend.py`.  The library
is built at first use by `native.build_library` into the git-ignored
`build/native/`, keyed by its sources, flags and the host CPU; every entry
point is differentially tested against the pure-Python implementations.
Interchange forms are defined in points.py (standard-form u64 limbs).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..native import build_library
from .bls12_381 import R
from .fr import Domain
from .points import G1Array, G2Array, ints_to_limbs, limbs_to_int
from .qap import qap_domain

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_SRC = _NATIVE / "groth16_native.c"
_HEADERS = (_NATIVE / "adx_mont.h", _NATIVE / "ifma52.h")

_lib = None
_available: bool | None = None

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library(_SRC, _HEADERS)))
    lib.g16_selftest.restype = ctypes.c_int
    lib.g1_fixed_base_batch.argtypes = [_U64P, ctypes.c_long, _U64P, _U64P, _U8P]
    lib.g2_fixed_base_batch.argtypes = [_U64P, ctypes.c_long, _U64P, _U64P, _U8P]
    for fn in (lib.g1_msm, lib.g2_msm, lib.g1_msm_pre):
        fn.argtypes = [_U64P, _U64P, _U8P, _U64P, ctypes.c_long, _U64P, _U64P]
        fn.restype = ctypes.c_int
    for fn in (lib.g1_msm_multi_pre, lib.g2_msm_multi):
        fn.argtypes = [_U64P, _U64P, _U8P, _U64P, ctypes.c_long,
                       ctypes.c_long, _U64P, _U64P, _U8P]
        fn.restype = ctypes.c_int
    lib.g1_to_mont.argtypes = [_U64P, _U64P, ctypes.c_long, _U64P, _U64P]
    lib.fr_fft.argtypes = [_U64P, ctypes.c_long, _U64P, ctypes.c_int]
    lib.fr_scale_powers.argtypes = [_U64P, ctypes.c_long, _U64P, ctypes.c_int]
    lib.fr_quotient.argtypes = [_U64P, _U64P, _U64P, _U64P, ctypes.c_long, _U64P]
    lib.fr_spmv.argtypes = [_I32P, _I32P, _U64P, ctypes.c_long, _U64P, _U64P]
    lib.fr_batch_to_mont.argtypes = [_U64P, ctypes.c_long, _U64P]
    _lib = lib
    return lib


def available() -> bool:
    """True iff the .so builds/loads and its selftest passes."""
    global _available
    if _available is None:
        try:
            _available = _load().g16_selftest() == 0
        except Exception:
            _available = False
    return _available


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _scalars_to_limbs(scalars) -> np.ndarray:
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint64:
        return np.ascontiguousarray(scalars)
    return ints_to_limbs([int(s) % R for s in scalars], 4)


# --- fixed-base (CRS generation) -----------------------------------------


def g1_fixed_base_batch(scalars) -> G1Array:
    lib = _load()
    sc = _scalars_to_limbs(scalars)
    n = len(sc)
    xs = np.empty((n, 6), dtype=np.uint64)
    ys = np.empty((n, 6), dtype=np.uint64)
    inf = np.empty(n, dtype=np.uint8)
    lib.g1_fixed_base_batch(_p64(sc), n, _p64(xs), _p64(ys),
                            inf.ctypes.data_as(_U8P))
    return G1Array(xs, ys, inf)


def g2_fixed_base_batch(scalars) -> G2Array:
    lib = _load()
    sc = _scalars_to_limbs(scalars)
    n = len(sc)
    xs = np.empty((n, 12), dtype=np.uint64)
    ys = np.empty((n, 12), dtype=np.uint64)
    inf = np.empty(n, dtype=np.uint8)
    lib.g2_fixed_base_batch(_p64(sc), n, _p64(xs), _p64(ys),
                            inf.ctypes.data_as(_U8P))
    return G2Array(xs, ys, inf)


# --- variable-base MSM ----------------------------------------------------


def g1_msm(points: G1Array, scalars):
    """MSM over a G1Array -> affine (x, y) tuple or None.

    The standard->Montgomery conversion of the point array is cached on
    the G1Array (the prover reuses each proving-key query across proofs,
    so the conversion is paid once per key, not once per MSM)."""
    lib = _load()
    sc = _scalars_to_limbs(scalars)
    assert len(sc) == len(points)
    mx, my = _mont_cache(points)
    ox = np.empty(6, dtype=np.uint64)
    oy = np.empty(6, dtype=np.uint64)
    rc = lib.g1_msm_pre(
        _p64(mx), _p64(my), points.inf.ctypes.data_as(_U8P),
        _p64(sc), len(sc), _p64(ox), _p64(oy),
    )
    if rc:
        return None
    return (limbs_to_int(ox), limbs_to_int(oy))


def _mont_cache(points: G1Array):
    mont = getattr(points, "_mont", None)
    if mont is None:
        lib = _load()
        n = len(points)
        mx = np.empty((n, 6), dtype=np.uint64)
        my = np.empty((n, 6), dtype=np.uint64)
        lib.g1_to_mont(_p64(points.xs), _p64(points.ys), n, _p64(mx),
                       _p64(my))
        mont = points._mont = (mx, my)
    return mont


def g1_msm_multi(points: G1Array, scalars_multi) -> list:
    """K MSMs over ONE G1 point set — the batched Groth16 prover's shape
    (every proof reuses the same CRS query points, so the Montgomery
    conversion, digit recode buffers, and the K x window x chunk OpenMP
    task grid amortize across the batch).

    scalars_multi: (K, n, 4) u64 limb array (or a list of K per-proof
    scalar sequences).  Returns a list of K affine (x, y) tuples / None.
    """
    lib = _load()
    if isinstance(scalars_multi, np.ndarray) and scalars_multi.ndim == 3:
        sc = np.ascontiguousarray(scalars_multi, dtype=np.uint64)
    else:
        sc = np.stack([_scalars_to_limbs(s) for s in scalars_multi])
    K, n = sc.shape[0], sc.shape[1]
    assert n == len(points)
    mx, my = _mont_cache(points)
    oxs = np.empty((K, 6), dtype=np.uint64)
    oys = np.empty((K, 6), dtype=np.uint64)
    oinf = np.empty(K, dtype=np.uint8)
    lib.g1_msm_multi_pre(
        _p64(mx), _p64(my), points.inf.ctypes.data_as(_U8P), _p64(sc),
        n, K, _p64(oxs), _p64(oys), oinf.ctypes.data_as(_U8P),
    )
    return [
        None if oinf[k] else (limbs_to_int(oxs[k]), limbs_to_int(oys[k]))
        for k in range(K)
    ]


def g2_msm_multi(points: G2Array, scalars_multi) -> list:
    """K G2 MSMs over one point set (the batched B2 MSM); one point
    Montgomery conversion per call.  Returns K affine pairs / None."""
    lib = _load()
    if isinstance(scalars_multi, np.ndarray) and scalars_multi.ndim == 3:
        sc = np.ascontiguousarray(scalars_multi, dtype=np.uint64)
    else:
        sc = np.stack([_scalars_to_limbs(s) for s in scalars_multi])
    K, n = sc.shape[0], sc.shape[1]
    assert n == len(points)
    oxs = np.empty((K, 12), dtype=np.uint64)
    oys = np.empty((K, 12), dtype=np.uint64)
    oinf = np.empty(K, dtype=np.uint8)
    lib.g2_msm_multi(
        _p64(points.xs), _p64(points.ys), points.inf.ctypes.data_as(_U8P),
        _p64(sc), n, K, _p64(oxs), _p64(oys), oinf.ctypes.data_as(_U8P),
    )
    out = []
    for k in range(K):
        if oinf[k]:
            out.append(None)
            continue
        out.append((
            (limbs_to_int(oxs[k][:6]), limbs_to_int(oxs[k][6:])),
            (limbs_to_int(oys[k][:6]), limbs_to_int(oys[k][6:])),
        ))
    return out


def g2_msm(points: G2Array, scalars):
    lib = _load()
    sc = _scalars_to_limbs(scalars)
    assert len(sc) == len(points)
    ox = np.empty(12, dtype=np.uint64)
    oy = np.empty(12, dtype=np.uint64)
    rc = lib.g2_msm(
        _p64(points.xs), _p64(points.ys), points.inf.ctypes.data_as(_U8P),
        _p64(sc), len(sc), _p64(ox), _p64(oy),
    )
    if rc:
        return None
    return (
        (limbs_to_int(ox[:6]), limbs_to_int(ox[6:])),
        (limbs_to_int(oy[:6]), limbs_to_int(oy[6:])),
    )


# --- Fr transforms --------------------------------------------------------


def fr_fft(a: np.ndarray, omega: int, inverse: bool) -> np.ndarray:
    """NTT of (n,4) standard-form limbs.  For the inverse pass, give the
    inverse root and inverse=True (adds the 1/n scaling)."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    n = len(a)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    om = ints_to_limbs([omega], 4)
    lib.fr_fft(_p64(a), log_n, _p64(om), 1 if inverse else 0)
    return a


def fr_scale_powers(a: np.ndarray, g: int, invert: bool) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    gl = ints_to_limbs([g], 4)
    lib.fr_scale_powers(_p64(a), len(a), _p64(gl), 1 if invert else 0)
    return a


def fr_quotient(a, b, c, zinv: int) -> np.ndarray:
    lib = _load()
    n = len(a)
    out = np.empty((n, 4), dtype=np.uint64)
    zl = ints_to_limbs([zinv], 4)
    lib.fr_quotient(_p64(a), _p64(b), _p64(c), _p64(zl), n, _p64(out))
    return out


def fr_spmv(rows, cols, vals_limbs, z_mont, num_rows: int) -> np.ndarray:
    lib = _load()
    out = np.zeros((num_rows, 4), dtype=np.uint64)
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    lib.fr_spmv(
        rows.ctypes.data_as(_I32P), cols.ctypes.data_as(_I32P),
        _p64(vals_limbs), len(rows), _p64(z_mont), _p64(out),
    )
    return out


def fr_batch_to_mont(a: np.ndarray) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    out = np.empty_like(a)
    lib.fr_batch_to_mont(_p64(a), len(a), _p64(out))
    return out


# --- Groth16 witness map (h polynomial) -----------------------------------

_COSET_G = 5


def _compiled_cache(compiled):
    cache = getattr(compiled, "_g16_native_cache", None)
    if cache is None:
        dom = qap_domain(compiled)
        cache = {"dom": dom}
        for name in ("a", "b", "c"):
            rows, cols, vals = getattr(compiled, name)
            cache[name] = (
                np.ascontiguousarray(rows, dtype=np.int32),
                np.ascontiguousarray(cols, dtype=np.int32),
                ints_to_limbs([int(v) % R for v in vals], 4),
            )
        object.__setattr__(compiled, "_g16_native_cache", cache)
    return cache


def witness_map(compiled, z):
    """Native h(X) computation; mirrors qap.witness_map bit-for-bit.

    Returns ((n-1, 4) u64 standard-form h coefficients, top coefficient as
    int — nonzero iff the assignment is unsatisfying).
    """
    cache = _compiled_cache(compiled)
    dom: Domain = cache["dom"]
    nc = compiled.num_constraints
    ni = compiled.num_instance
    if isinstance(z, np.ndarray) and z.ndim == 2:
        # already (N, 4) u64 canonical limb rows (the packed-witness path)
        z_limbs = np.ascontiguousarray(z, dtype=np.uint64)
    else:
        try:
            # most wire values fit one limb; the numpy path needs no mod
            # (values < 2^64 < r) and skips 79k Python bigint mods.  The
            # ~2^147 quotient wires overflow it -> bigint fallback
            z_limbs = ints_to_limbs(np.asarray(z, dtype=np.uint64), 4)
        except (OverflowError, TypeError, ValueError):
            z_limbs = ints_to_limbs([int(x) % R for x in z], 4)
    z_mont = fr_batch_to_mont(z_limbs)

    evals = {}
    for name in ("a", "b", "c"):
        rows, cols, vals = cache[name]
        acc = fr_spmv(rows, cols, vals, z_mont, dom.size)
        if name == "a":
            acc[nc : nc + ni] = z_limbs[:ni]
        evals[name] = acc

    coset = {}
    for name in ("a", "b", "c"):
        coeffs = fr_fft(evals[name], dom.omega_inv, inverse=True)
        fr_scale_powers(coeffs, _COSET_G, invert=False)
        coset[name] = fr_fft(coeffs, dom.omega, inverse=False)

    zinv = pow(dom.vanishing_on_coset(_COSET_G), -1, R)
    h_evals = fr_quotient(coset["a"], coset["b"], coset["c"], zinv)
    h = fr_fft(h_evals, dom.omega_inv, inverse=True)
    fr_scale_powers(h, _COSET_G, invert=True)
    top = limbs_to_int(h[dom.size - 1])
    return np.ascontiguousarray(h[: dom.size - 1]), top
