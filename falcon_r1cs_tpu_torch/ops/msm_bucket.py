"""The G1 MSM's bucket reduction, one merge level at a time: its plain
torch version and the wrapper of the hand-written CUDA kernel
(`csrc/msm_bucket.cu`).

It has no Pallas counterpart: it is the glue of the JAX package's wide
tree around its point adds (`falcon_r1cs_tpu/snark/tpu_msm_blocks.py`
`_bucket_reduce_flat`: the `_sel` selects and the `_scatter` into the
"limb" bucket bank, which XLA runs there).

Points are limb-major: X, Y, Z (35, W, c) int32 Montgomery limbs and
infinity flags (W, c) bool; an affine point has Z None (the Montgomery
one).  The bucket bank is `bucket_bank(W, nb)`: X, Y, Z planes (35, W nb)
int32 and flags (W nb,) bool, every column infinity until a level writes
it.  `bucket_level_cuda(bridge, H, T, kf, kl, bank, nb)` runs one merge
level of c lanes: with the bridge T_left + H_right (35, W, c/2) given,
it returns the next level's (H', T', kf', kl') and writes into the bank
the totals of the segments this merge closes, at column w nb + key, and
nothing else; at the last level (c = 2) also the root's H' and T'.  Level
1 passes the affine leaves as both H and T and the keys as both kf and
kl (the merge of single leaves closes no segment).  Every bucket's total
is written once over the tree (snark/gpu_msm.py `_bucket_reduce_flat`).

`bucket_level` is the plain version, bit-equal to the kernel (the level
only moves data).  `bucket_level_cuda` takes it for CPU tensors, launches
`bucket_level_kernel` for CUDA tensors and raises for anything else;
there is no fallback from a CUDA tensor to the plain path.  `.launches`
counts kernel launches, one a level.

The kernel runs a level in CTAs of 256 threads that each take L lanes
(`LANE_FORMS`: 256, or 32 down to 1), in three phases: all threads copy
H' and T' limb by limb, the lane fastest; a thread a lane decides the
bucket writes and lists them in shared memory (at the narrow levels for
the CTA's nodes in key order, so that neighbouring records close
neighbouring keys); all threads write the listed buckets limb by limb,
the record fastest.  The C entry picks L from W c/2 (`SPLIT`, which
`lanes_a_cta` reads): 256 at the wide levels, fewer at the narrow ones,
so their few lanes still spread over the card.  `lanes=` forces a form
(the tuner `ops/tune_msm_bucket.py` and the card tests); every form
computes the same function.
"""

from __future__ import annotations

import torch

from . import _build
from . import fq_mont as fq
from .fq import _check

NL = fq.NL
# the kernel's forms: lanes a CTA of 256 threads
LANE_FORMS = (256, 32, 16, 8, 4, 2, 1)
# the entry's split (csrc/msm_bucket.cu kSplit): (lanes W c/2 from, lanes
# a CTA), the first row a level reaches
SPLIT = ((90112, 256), (11264, 32), (5632, 16), (704, 8), (352, 4), (44, 2), (0, 1))


def lanes_a_cta(W: int, c: int) -> int:
    """The lanes a CTA the C entry picks for a level of c lanes over W
    windows (lanes = 0)."""
    m2 = W * (c // 2)
    return next(L for start, L in SPLIT if m2 >= start)


def bucket_bank(W: int, nb: int, device):
    """The empty bucket planes: X, Y, Z (35, W nb) int32 zero (views of one
    block) and flags (W nb,) bool, all infinity."""
    coords = torch.zeros((3, NL, W * nb), dtype=torch.int32, device=device)
    return (*coords.unbind(), torch.ones(W * nb, dtype=torch.bool, device=device))


def _jacobian(pt):
    """(X, Y, Z, inf) with an affine point's Z the Montgomery one."""
    if pt[2] is not None:
        return pt
    one = torch.from_numpy(fq.ONE_MONT_LIMBS).to(pt[0].device)
    return (pt[0], pt[1], one[:, None, None].expand_as(pt[0]), pt[3])


def _sel(cond, a, b):
    return tuple(torch.where(cond[None], x, y) for x, y in zip(a[:3], b[:3])) + (
        torch.where(cond, a[3], b[3]),)


def _emit(bank, key, val, valid, nb: int):
    """Write the valid lanes of val (coords (35, W, c), flags (W, c)) into
    the bank at column w nb + key; the other lanes write nothing."""
    W = key.shape[0]
    col = (key.long() + torch.arange(W, device=key.device)[:, None] * nb)[valid]
    for plane, v in zip(bank[:3], val[:3]):
        plane[:, col] = v[:, valid]
    bank[3][col] = val[3][valid]


def bucket_level(bridge, H, T, kf, kl, bank, nb: int):
    """One merge level in plain torch (see the module docstring)."""
    c = kf.shape[-1]
    c2 = c // 2
    H, T = _jacobian(H), _jacobian(T)
    lH = tuple(a[..., :c2] for a in H)
    rH = tuple(a[..., c2:] for a in H)
    lT = tuple(a[..., :c2] for a in T)
    rT = tuple(a[..., c2:] for a in T)
    lkf, rkf = kf[..., :c2], kf[..., c2:]
    lkl, rkl = kl[..., :c2], kl[..., c2:]
    same = lkl == rkf
    ls = lkf == lkl  # the left node is one segment
    rs = rkf == rkl
    Hn = _sel(same & ls, bridge, lH)
    Tn = _sel(same & rs, bridge, rT)
    _emit(bank, lkl, _sel(same, bridge, lT), ~ls & ~(same & rs), nb)
    _emit(bank, rkf, rH, ~same & ~rs, nb)
    if c2 == 1:
        _emit(bank, lkf, Hn, torch.ones_like(same), nb)
        _emit(bank, rkl, Tn, rkl != lkf, nb)
    return Hn, Tn, lkf.contiguous(), rkl.contiguous()


def bucket_level_cuda(bridge, H, T, kf, kl, bank, nb: int, lanes: int = 0):
    """One merge level: the kernel on CUDA tensors, the plain version on
    CPU tensors.  Writes into `bank`; returns (H', T', kf', kl').  Every
    key must lie in [0, nb) (the recode's magnitudes do); the kernel does
    not check it, which would take a read back from the card.  `lanes`:
    the kernel's lanes a CTA, one of LANE_FORMS, or 0 for the entry's
    own choice (`lanes_a_cta`)."""
    name = "bucket_level_cuda"
    if lanes and lanes not in LANE_FORMS:
        raise ValueError(f"{name}: lanes = {lanes}, want 0 or one of {LANE_FORMS}")
    tensors = [*bridge, *(a for a in H + T if a is not None), kf, kl, *bank]
    if all(t.device.type == "cpu" for t in tensors):
        return bucket_level_cuda.plain(bridge, H, T, kf, kl, bank, nb)
    dev = kf.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if kf.dim() != 2:
        raise ValueError(f"{name}: want (W, c) keys, got {tuple(kf.shape)}")
    W, c = kf.shape
    if c < 2 or c & (c - 1) or nb < 1:
        raise ValueError(f"{name}: c = {c} lanes (a power of two >= 2), nb = {nb}")
    if (H[2] is None) != (T[2] is None):
        raise ValueError(f"{name}: H and T must both be affine or both Jacobian")
    c2 = c // 2
    # the flags are torch.bool, one byte of 0 or 1 each: the kernel reads
    # and writes them as uint8
    for pt in (H, T):
        for a in pt[:3]:
            if a is not None:
                _check(name, a, (NL, W, c), torch.int32, dev)
        _check(name, pt[3], (W, c), torch.bool, dev)
    for k in (kf, kl):
        _check(name, k, (W, c), torch.int32, dev)
    for a in bridge[:3]:
        _check(name, a, (NL, W, c2), torch.int32, dev)
    _check(name, bridge[3], (W, c2), torch.bool, dev)
    for a in bank[:3]:
        _check(name, a, (NL, W * nb), torch.int32, dev)
    _check(name, bank[3], (W * nb,), torch.bool, dev)
    out = torch.empty((2, 3, NL, W, c2), dtype=torch.int32, device=dev)
    out_inf = torch.empty((2, W, c2), dtype=torch.bool, device=dev)
    out_keys = torch.empty((2, W, c2), dtype=torch.int32, device=dev)

    def ptr(a):
        return 0 if a is None else a.data_ptr()

    _build.launch("bucket_level_launch", dev, *(ptr(a) for a in H + T), kf.data_ptr(),
                  kl.data_ptr(), *(a.data_ptr() for a in bridge), out.data_ptr(),
                  out_inf.data_ptr(), out_keys.data_ptr(), *(a.data_ptr() for a in bank),
                  W, c, nb, lanes)
    bucket_level_cuda.launches += 1
    (h, t), (h_inf, t_inf) = out.unbind(), out_inf.unbind()
    return (*h.unbind(), h_inf), (*t.unbind(), t_inf), *out_keys.unbind()


bucket_level_cuda.launches = 0
bucket_level_cuda.plain = bucket_level
