"""G1 multi-scalar multiplication on a CUDA card: the Groth16 prover's hot
loop, on the hand-written Fq kernels K4, K5 and K6 (csrc/fq_mont.cu).

The port of the JAX package's wide-tree Pallas engine
(`falcon_r1cs_tpu/snark/tpu_msm_blocks.py`, reached from
`tpu_msm.g1_msm_tpu` with Pallas on) and of its host helpers in
`falcon_r1cs_tpu/snark/tpu_msm.py`.  Per MSM:

- device, once per point set: the CRS points to Montgomery limb-major
  (35, n) tensors by K4 (`to_mont` = mont_mul by R^2) and the infinity
  mask, cached on the G1Array;
- device: the scalars, uploaded as int64, -> signed window digits
  (magnitude | sign << w, buckets 1..2^(w-1)) by one launch of the
  recode kernel (`ops/msm_recode.py`, the host's numpy loop in the JAX
  package); the scalars of infinity points are zeroed, so a leaf is
  infinite iff its digit is 0;
- device, per group of G windows: one stable sort of the digits, a
  bit-reversed leaf placement (position p holds sorted element brev(p),
  so every merge level pairs the two contiguous halves), the merge tree
  over the sorted run with one point add per merge -- K6 at level 1
  (both leaves affine), K5 at every other level -- and one launch of the
  merge-level kernel a level (`ops/msm_bucket.py`), which selects the
  next level's nodes and writes each bucket's total, once over the tree,
  into limb-major bucket planes (35, W nb); then the weighted bucket sum
  sum_d d B_d by two tree sums and two short suffix scans (K5) over
  those planes;
- host: the Horner fold of the per-window sums in exact bigints.

Differences from the JAX engine, with the same results: coordinates are
(35, m) limb-major with no (8, 128) blocks and no padding to 1024-point
kernel blocks; groups run in a Python loop (lax.map there), the group
size is an argument (an environment variable there) and its memory
budget on a card a quarter of the card (6 GB there); the digit sort is
`torch.sort(stable=True)` plus a gather (a variadic sort there); a merge
level's selects and bucket writes are one kernel (XLA selects and
scatters there).  Left out: the XLA row-layout engine, the dispatch
watchdog, and the bank and weighted-sum switches (the JAX engine's
"limb" bank layout and its automatic weighted-sum rule stay).

`g1_msm_gpu_sharded` is the point-axis data-parallel MSM of
`tpu_msm.g1_msm_tpu_sharded`: each rank of a device mesh runs the whole
engine on its slice of the points, and the D partial sums are folded on
the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..ops import fq_mont as fq
from ..ops.fq import mont_mul_cuda, point_add_aff_cuda, point_add_cuda
from ..ops.msm_bucket import bucket_bank, bucket_level_cuda
from ..ops.msm_recode import n_windows_carry, signed_digits_cuda
from ..utils.device import rank_device
from .bls12_381 import P as Q381, R as FR_R
from .bls12_381 import g1_add, g1_double, g1_from_affine, g1_to_affine
from .points import G1Array, ints_to_limbs

WINDOW = 12
LIMB12 = 12


# --------------------------------------------------------------------------
# host helpers (tpu_msm.py)
# --------------------------------------------------------------------------


def _u64_rows_to_limb12(rows: np.ndarray, nl: int | None = None) -> np.ndarray:
    """(n, k) u64 little-endian -> (n, nl) int32 12-bit limbs, by
    vectorised bit-slicing."""
    if nl is None:
        nl = fq.NL
    rows = np.ascontiguousarray(rows, dtype=np.uint64)
    n, k = rows.shape
    out = np.zeros((n, nl), dtype=np.int32)
    for l in range(nl):
        bit = LIMB12 * l
        i, r = divmod(bit, 64)
        if i >= k:
            break
        v = rows[:, i] >> np.uint64(r)
        if r + LIMB12 > 64 and i + 1 < k:
            v = v | (rows[:, i + 1] << np.uint64(64 - r))
        out[:, l] = (v & np.uint64((1 << LIMB12) - 1)).astype(np.int32)
    return out


def _window_digits(scalars_u64: np.ndarray, window: int = WINDOW) -> np.ndarray:
    """(n, 4) u64 -> (nw, n) int32 window digits (the host reference of the
    recode kernel, as `_window_digits_signed`)."""
    sc = np.ascontiguousarray(scalars_u64, dtype=np.uint64)
    nw = (255 + window - 1) // window
    out = np.zeros((nw, sc.shape[0]), dtype=np.int32)
    mask = np.uint64((1 << window) - 1)
    for w in range(nw):
        bit = w * window
        i, r = divmod(bit, 64)
        if i >= sc.shape[1]:
            break
        v = sc[:, i] >> np.uint64(r)
        if r + window > 64 and i + 1 < sc.shape[1]:
            v = v | (sc[:, i + 1] << np.uint64(64 - r))
        out[w] = (v & mask).astype(np.int32)
    return out


def _window_digits_signed(scalars_u64: np.ndarray,
                          window: int = WINDOW) -> np.ndarray:
    """Signed-digit recode: digits in [-(2^(w-1)-1), 2^(w-1)] packed as
    magnitude | (sign << w).  Standard carry recode: v = d + carry;
    v > 2^(w-1) emits v - 2^w and carries 1.  Scalars are < r < 2^255, so
    the top window absorbs the final carry (checked)."""
    d = _window_digits(scalars_u64, window)
    half = 1 << (window - 1)
    full = 1 << window
    out = np.zeros_like(d)
    carry = np.zeros(d.shape[1], dtype=np.int32)
    for w in range(d.shape[0]):
        v = d[w] + carry
        neg = v > half
        carry = neg.astype(np.int32)
        sv = np.where(neg, v - full, v)
        out[w] = np.abs(sv) | (np.where(sv < 0, 1, 0) << window)
    if carry.any():
        raise ValueError("signed recode: top-window carry overflow")
    return out


def _points_std_limbs(points, n_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """G1Array -> standard-form (n_pad, 35) int32 limbs of X and Y, the
    padding rows zero (padding carries zero scalars)."""
    n = len(points)
    pad = np.zeros((n_pad - n, fq.NL), np.int32)
    xs = np.concatenate([_u64_rows_to_limb12(points.xs), pad])
    ys = np.concatenate([_u64_rows_to_limb12(points.ys), pad])
    return xs, ys


def _jac_mont_to_affine(ox, oy, oz):
    """Montgomery-limb Jacobian -> standard affine ints (host side)."""
    rinv = pow(fq.R_MONT, -1, Q381)
    xi = fq.limbs_to_int(ox) * rinv % Q381
    yi = fq.limbs_to_int(oy) * rinv % Q381
    zi = fq.limbs_to_int(oz) * rinv % Q381
    zinv = pow(zi, -1, Q381)
    zi2 = zinv * zinv % Q381
    return (xi * zi2 % Q381, yi * zi2 % Q381 * zinv % Q381)


def _scalars_u64(scalars) -> np.ndarray:
    if isinstance(scalars, np.ndarray) and scalars.dtype == np.uint64:
        return np.ascontiguousarray(scalars)
    return ints_to_limbs([int(s) % FR_R for s in scalars], 4)


# --------------------------------------------------------------------------
# the wide-tree engine (tpu_msm_blocks.py)
# --------------------------------------------------------------------------


def _flat(add):
    """A point add over flat (35, ..., m) points: reshape the batch axes
    into one contiguous (35, M) launch and back (the counterpart of the
    JAX engine's `_flat_add_factory` and `_flat_aff_add_factory`, with no
    padding to kernel blocks)."""

    def run(p1, p2):
        shp = p1[-1].shape
        m = int(np.prod(shp))

        def prep(pt):
            return tuple(
                c.reshape(fq.NL, m).contiguous() for c in pt[:-1]
            ) + (pt[-1].reshape(m).contiguous(),)

        out = add(prep(p1), prep(p2))
        return tuple(c.reshape((fq.NL,) + shp) for c in out[:3]) + (
            out[3].reshape(shp),
        )

    return run


_add = _flat(point_add_cuda)          # K5
_aff_add = _flat(point_add_aff_cuda)  # K6


def _bucket_reduce_flat(pt_aff, keys, nb: int):
    """Bucket sums of a key-sorted, bit-reversed run of AFFINE leaves:
    X, Y (35, W, n), flags (W, n), keys (W, n).  Each merge tree node
    summarises its range by (H, T, kf, kl): the sums of its first and last
    segments and their keys; merging costs one point add (the bridge
    T_left + H_right), and each segment's total is written into the bucket
    planes at the unique merge where both its ends become interior (the
    root's two at the last level).  Level 1 adds two affine leaves (K6)
    and writes nothing (a level-1 node is one segment); every level's
    selects and writes are one launch of the merge-level kernel
    (`ops.msm_bucket`), which writes only the buckets the level closes.
    Returns the bucket planes X, Y, Z (35, W*nb) + flags (W*nb,); the
    column of a bucket that no leaf reached stays infinity."""
    W, n = keys.shape
    assert n & (n - 1) == 0 and n >= 2
    bank = bucket_bank(W, nb, keys.device)
    c2 = n // 2
    leaves = (pt_aff[0], pt_aff[1], None, pt_aff[2])
    bridge = _aff_add(tuple(a[..., :c2] for a in pt_aff), tuple(a[..., c2:] for a in pt_aff))
    H, T, kf, kl = bucket_level_cuda(bridge, leaves, leaves, keys, keys, bank, nb)
    c = c2
    while c > 1:
        c2 = c // 2
        bridge = _add(tuple(a[..., :c2] for a in T), tuple(a[..., c2:] for a in H))
        H, T, kf, kl = bucket_level_cuda(bridge, H, T, kf, kl, bank, nb)
        c = c2
    return bank


def _tree_sum_flat(pt):
    """Fold the (power-of-two) last axis by pairwise adds of its halves."""
    c = pt[0].shape[-1]
    assert c & (c - 1) == 0
    while c > 1:
        c2 = c // 2
        pt = _add(tuple(a[..., :c2] for a in pt), tuple(a[..., c2:c] for a in pt))
        c = c2
    return pt


def _hs_suffix_weighted(pt, nbk: int):
    """sum_{j>=1} j X_j over the last axis of pt = (coords (35, W, nbk),
    inf (W, nbk)): a Hillis-Steele suffix prefix over the reversed order
    (dropping the weight-0 slot) plus a pairwise tree.  Returns coords
    (35, W, 1) + inf (W, 1)."""
    pt = tuple(a[..., 1:].flip(-1) for a in pt)
    L = nbk - 1
    P2 = 1 << max(1, (L - 1).bit_length())

    def pad_end(x, fill):
        f = torch.full(x.shape[:-1] + (P2 - L,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, f], dim=-1)

    pt = (pad_end(pt[0], 0), pad_end(pt[1], 0), pad_end(pt[2], 0), pad_end(pt[3], True))
    s = 1
    while s < P2:
        shifted = tuple(
            torch.cat([torch.zeros_like(a[..., :s]), a[..., : P2 - s]], dim=-1)
            for a in pt[:3]
        ) + (torch.cat([torch.ones_like(pt[3][..., :s]), pt[3][..., : P2 - s]], dim=-1),)
        pt = _add(pt, shifted)
        s <<= 1
    live = torch.arange(P2, device=pt[3].device) < L
    pt = (pt[0], pt[1], pt[2], pt[3] | ~live[None, :])
    return _tree_sum_flat(pt)


def _wsum_decomp(nb: int) -> bool:
    """The bucket-index decomposition applies when L = nb - 1 is a power
    of two >= 4 (every window >= 3 of the signed recode); else the full
    Hillis-Steele sum."""
    L = nb - 1
    return L >= 4 and not L & (L - 1)


def wsum_weights(nb: int) -> list:
    """Static weights of the part columns `_weighted_bucket_sum_flat`
    returns (powers of two, applied by the host fold as doublings)."""
    if not _wsum_decomp(nb):
        return [1]
    L = nb - 1
    clb = (L.bit_length() - 1) // 2
    return [1 << clb, 1, L]


def _weighted_bucket_sum_flat(bufs, W: int, nb: int):
    """Per-window weighted bucket sums over the (35, W*nb) bucket planes.

    With d = CL*hi + lo (CL*CH = L = nb-1, the top bucket L its own part):
      sum_d d B_d = CL sum_hi hi C_hi + sum_lo lo D_lo + L B_L,
      C_hi = sum_lo B[hi, lo],  D_lo = sum_hi B[hi, lo]:
    two tree sums over the planes, reshaped (no copy), and two short
    suffix scans.
    Returns part columns: coords (35, W, P) + inf (W, P) with the weights
    wsum_weights(nb)."""
    bx, by, bz, binf = bufs
    bx = bx.reshape(fq.NL, W, nb)
    by = by.reshape(fq.NL, W, nb)
    bz = bz.reshape(fq.NL, W, nb)
    binf = binf.reshape(W, nb)
    if not _wsum_decomp(nb):
        return _hs_suffix_weighted((bx, by, bz, binf), nb)
    L = nb - 1
    CL = 1 << ((L.bit_length() - 1) // 2)
    CH = L // CL
    body = (
        bx[..., :L].reshape(fq.NL, W, CH, CL),
        by[..., :L].reshape(fq.NL, W, CH, CL),
        bz[..., :L].reshape(fq.NL, W, CH, CL),
        binf[..., :L].reshape(W, CH, CL),
    )
    C = tuple(t[..., 0] for t in _tree_sum_flat(body))  # sum over lo
    D = tuple(t[..., 0] for t in _tree_sum_flat(tuple(t.transpose(-1, -2) for t in body)))
    S1 = _hs_suffix_weighted(C, CH)  # sum hi C_hi
    S2 = _hs_suffix_weighted(D, CL)  # sum lo D_lo
    top = (bx[..., L:], by[..., L:], bz[..., L:], binf[..., L:])
    return tuple(torch.cat([S1[i], S2[i], top[i]], dim=-1) for i in range(4))


@functools.lru_cache(maxsize=None)
def _brev(n: int) -> np.ndarray:
    bits = (n - 1).bit_length()
    out = np.zeros(n, dtype=np.int64)
    for p in range(n):
        r, x = 0, p
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        out[p] = r
    return out


# bytes of a wide-tree group's live state on the CPU: the JAX engine's
# budget (tpu_msm_blocks._group_windows)
GROUP_BYTES_CPU = 6e9


def _group_bytes(device) -> float:
    """The group budget on `device`: a quarter of a card's memory (on an
    80 GB H100, two of the 22 windows of a 2^21-point MSM a group, all 22
    at 2^18), or GROUP_BYTES_CPU on the CPU.  At 6 GB a 2^21-point MSM
    ran one window a group, 22 groups whose launches left the card idle
    (PERF.md §5)."""
    device = torch.device(device)
    if device.type != "cuda":
        return GROUP_BYTES_CPU
    return torch.cuda.get_device_properties(device).total_memory / 4


def _group_windows(n: int, nw: int, cap: int | None = None, device="cpu") -> int:
    """Windows per wide-tree group: the largest divisor of nw within `cap`
    (default: a group's live top-level tree state, ~4 x 3 coords x 35 x
    W x n int32, within `_group_bytes(device)`)."""
    if cap is None:
        cap = int(_group_bytes(device) // (4 * 3 * fq.NL * n * 4))
    cap = max(1, min(nw, cap))
    for g in range(cap, 0, -1):
        if nw % g == 0:
            return g
    return 1


def _sorted_leaves(digits, window: int):
    """(idx, d, s) (nW, n): each window's digit magnitudes sorted
    (stable), their points' indices and signs, placed bit-reversed."""
    mag = digits & ((1 << window) - 1)
    sign = digits >> window
    d_sorted, order = torch.sort(mag, dim=1, stable=True)
    s_sorted = torch.gather(sign, 1, order)
    brev = torch.from_numpy(_brev(digits.shape[1])).to(digits.device)
    return order[:, brev], d_sorted[:, brev], s_sorted[:, brev]


def _leaves(Xm, Ym, idx, d, s):
    """The AFFINE leaves (implicit Z = one) of sorted windows: X, Y (35,
    W, n) gathered, Y negated on negative digits, a zero digit an
    infinity."""
    Yg = Ym[:, idx]
    Yg = torch.where(s[None] == 1, -Yg, Yg)
    return (Xm[:, idx], Yg, d == 0)


def _window_sums(digits, Xm, Ym, window: int, G: int):
    """Per-window bucket-weighted part sums of one point set.

    digits (nW, n) int32 signed-packed on the device (any stack of windows
    over the points Xm, Ym (35, n) Montgomery limbs: one MSM's nw windows
    or K MSMs' nw*K); returns coords (35, nW, P) + inf (nW, P).  Windows
    run G at a time."""
    nb = (1 << (window - 1)) + 1  # magnitudes 0..2^(w-1)
    nW = digits.shape[0]
    assert nW % G == 0, (nW, G)
    idx_all, d_all, s_all = _sorted_leaves(digits, window)
    parts = []
    for g in range(nW // G):
        sl = slice(g * G, (g + 1) * G)
        bufs = _bucket_reduce_flat(_leaves(Xm, Ym, idx_all[sl], d_all[sl], s_all[sl]),
                                   d_all[sl], nb)
        parts.append(_weighted_bucket_sum_flat(bufs, G, nb))
    return (
        torch.cat([p[0] for p in parts], dim=1),
        torch.cat([p[1] for p in parts], dim=1),
        torch.cat([p[2] for p in parts], dim=1),
        torch.cat([p[3] for p in parts], dim=0),
    )


def _device_key(device) -> str:
    """The point caches' key of a device: "cuda" and "cuda:<current>"
    name one card (a caller's device or the digits' tensor device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _points_mont(points, n_pad: int, device):
    """Montgomery-domain limb-major (35, n_pad) coordinate tensors on
    `device`, converted by one K4 launch (mont_mul by R^2) over X|Y (on the
    card canonical limbs; on the CPU the plain version's relaxed ones) and
    cached on the G1Array: the prover reuses the same CRS queries for
    every proof (the G1Array must not be mutated after first use)."""
    device = torch.device(device)
    key = (n_pad, _device_key(device))
    cache = points.__dict__.setdefault("_gpu_mont_cache", {})
    if key in cache:
        return cache[key]
    xs, ys = _points_std_limbs(points, n_pad)
    std = torch.from_numpy(np.ascontiguousarray(np.concatenate([xs, ys]).T)).to(device)
    r2 = fq.consts(device)["r2"][:, None].expand_as(std).contiguous()
    mont = mont_mul_cuda(std, r2)
    out = (mont[:, :n_pad].contiguous(), mont[:, n_pad:].contiguous())
    cache[key] = out
    return out


def _fold_windows_host(ws, nw: int, K: int, window: int, overflow):
    """Horner-fold the per-window part sums on the host, exactly:
    S_{w,k} = sum_p weight_p part_{w,k,p} (weights applied as doublings),
    total_k = sum_w 2^(window w) S_{w,k}, over Jacobian bigints.  Returns
    K affine tuples / None.  `overflow`, the recode's flag, is read once
    the sums are on the host (the device is then idle): a set flag
    raises."""
    nb = (1 << (window - 1)) + 1
    shifts = [wt.bit_length() - 1 for wt in wsum_weights(nb)]
    P = len(shifts)
    ox, oy, oz, oinf = (t.cpu().numpy() for t in ws)
    if overflow.item():
        raise ValueError("signed recode: top-window carry overflow")
    ox = ox.reshape(fq.NL, nw, K, P)
    oy = oy.reshape(fq.NL, nw, K, P)
    oz = oz.reshape(fq.NL, nw, K, P)
    oinf = oinf.reshape(nw, K, P)
    rinv = pow(fq.R_MONT, -1, Q381)
    out = []
    for k in range(K):
        total = None
        for w in range(nw - 1, -1, -1):
            if total is not None:
                for _ in range(window):
                    total = g1_double(total)
            for p in range(P):
                if bool(oinf[w, k, p]):
                    continue
                pt = (
                    fq.limbs_to_int(ox[:, w, k, p]) * rinv % Q381,
                    fq.limbs_to_int(oy[:, w, k, p]) * rinv % Q381,
                    fq.limbs_to_int(oz[:, w, k, p]) * rinv % Q381,
                )
                for _ in range(shifts[p]):
                    pt = g1_double(pt)
                total = g1_add(total, pt)
        out.append(g1_to_affine(total) if total is not None else None)
    return out


def g1_msm_blocks(points, digits, overflow, window: int, group: int | None = None):
    """Single MSM through the wide tree: device digits (nw, n_pad) int32,
    zero on the infinity points, and their overflow flag
    (`_point_digits`).  Returns an affine point or None."""
    n_pad = digits.shape[1]
    Xm, Ym = _points_mont(points, n_pad, digits.device)
    nw = digits.shape[0]
    G = _group_windows(n_pad, nw, group, Xm.device)
    ws = _window_sums(digits, Xm, Ym, window, G)
    return _fold_windows_host(ws, nw, 1, window, overflow)[0]


def g1_msm_blocks_multi(points, digits, overflow, K: int, window: int,
                        group: int | None = None):
    """K MSMs over one point set: device digits (nw K, n_pad) int32,
    w-major (row w K + k), so all nw K windows share one group loop.
    Returns a list of K affine points / None."""
    n_pad = digits.shape[1]
    Xm, Ym = _points_mont(points, n_pad, digits.device)
    nw = digits.shape[0] // K
    G = _group_windows(n_pad, nw * K, group, Xm.device)
    ws = _window_sums(digits, Xm, Ym, window, G)
    return _fold_windows_host(ws, nw, K, window, overflow)


def _points_inf(points, device):
    """The point set's infinity mask (n,) bool on `device`, uploaded once
    and cached beside the Montgomery points (`_points_mont`)."""
    key = ("inf", _device_key(device))
    cache = points.__dict__.setdefault("_gpu_mont_cache", {})
    if key not in cache:
        cache[key] = torch.from_numpy(points.inf.astype(bool)).to(device)
    return cache[key]


def _point_digits(points, scalars, window: int, n_pad: int, device, nw: int | None = None):
    """(digits, overflow) on `device`: the signed window digits (nw K,
    n_pad) int32 of the scalars ((n,) or (n, 4) u64, or (K, n, 4) u64 for
    K MSMs), zero on the infinity points (a leaf is infinite iff its digit
    is 0) and on the padding, and the recode's overflow flag.  nw is the
    recode's window count (`ops.msm_recode`: ceil(255 / w) by default).
    The scalars are uploaded once as int64; the recode kernel runs on a
    card, its plain version on the CPU."""
    sc = _scalars_u64(scalars)
    sc = torch.from_numpy(sc.view(np.int64)).to(device)
    return signed_digits_cuda(sc, _points_inf(points, device), window, n_pad, nw)


def g1_msm_gpu(points, scalars, window: int | None = None, device="cuda",
               group: int | None = None):
    """MSM over a points.G1Array on `device`; returns an affine point or
    None.  `window` trades bucket count (2^(w-1)) against window count;
    None uses 12.  `group` caps the windows per tree (default: by the
    device's memory, `_group_bytes`).
    Points pad to the next power of two >= 8 (infinities, zero scalars)."""
    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    n = len(points)
    n_pad = max(8, 1 << (n - 1).bit_length())
    digits, overflow = _point_digits(points, scalars, window, n_pad, device)
    return g1_msm_blocks(points, digits, overflow, window, group)


def g1_msm_gpu_multi(points, scalars_multi, window: int | None = None,
                     device="cuda", group: int | None = None):
    """K MSMs over one G1Array, (K, n) scalars, recoded in one launch;
    returns a list of K affine points / None."""
    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    n = len(points)
    n_pad = max(8, 1 << (n - 1).bit_length())
    sc = np.stack([_scalars_u64(s) for s in scalars_multi])
    digits, overflow = _point_digits(points, sc, window, n_pad, device)
    return g1_msm_blocks_multi(points, digits, overflow, len(sc), window, group)


def _point_shard(points, d: int, per: int) -> G1Array:
    """Points d*per .. (d+1)*per - 1 (fewer, or none, at the end) as their
    own G1Array, cached on `points` so that a shard's Montgomery form
    (_points_mont) is converted once per point set."""
    cache = points.__dict__.setdefault("_gpu_shard_cache", {})
    if (d, per) not in cache:
        sl = slice(d * per, (d + 1) * per)
        cache[(d, per)] = G1Array(points.xs[sl], points.ys[sl], points.inf[sl])
    return cache[(d, per)]


def g1_msm_gpu_sharded(points, scalars, window: int | None, mesh):
    """The point-axis data-parallel MSM over every rank of `mesh` (a
    DeviceMesh spanning the world; every rank calls it with the same
    points and scalars).  The points pad to D shards of
    per = max(8, next power of two >= ceil(n / D)); rank d recodes its
    shard's scalars and runs g1_msm_blocks on shard d on its device, with
    no exchange until the D affine partial sums, which every rank gathers
    and folds on the host with the group law.  Returns the affine point
    or None, on every rank.

    The recode takes n_windows_carry(w) windows, one more than ceil(255 /
    w) where w divides 255 (w = 3, 5, 15, 17): so every scalar below r
    fits at every window, as in the JAX package's sharded MSM, whose
    unsigned digits always fit.  g1_msm_gpu and g1_msm_gpu_multi keep
    ceil(255 / w) windows, and raise where the top window carries out, as
    the JAX package's Pallas engine does."""
    if window is None:
        window = WINDOW
    assert isinstance(points, G1Array)
    D = mesh.size()
    if D != dist.get_world_size():
        raise ValueError(f"the mesh spans {D} ranks of a world of {dist.get_world_size()}")
    d = mesh.mesh.flatten().tolist().index(dist.get_rank())
    n = len(points)
    per = max(8, 1 << ((n + D - 1) // D - 1).bit_length())
    shard = _point_shard(points, d, per)
    sc = _scalars_u64(scalars)[d * per:(d + 1) * per]
    digits = _point_digits(shard, sc, window, per, rank_device(mesh.device_type),
                           n_windows_carry(window))
    part = g1_msm_blocks(shard, *digits, window)
    parts = [None] * D
    dist.all_gather_object(parts, part)
    acc = None
    for aff in parts:
        if aff is not None:
            acc = g1_add(acc, g1_from_affine(aff))
    return g1_to_affine(acc) if acc is not None else None
