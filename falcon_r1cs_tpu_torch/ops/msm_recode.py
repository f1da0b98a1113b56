"""The G1 MSM's signed-digit recode: its plain torch version and the
wrapper of the hand-written CUDA kernel (`csrc/msm_recode.cu`).

It has no Pallas counterpart: the JAX package recodes on the host
(`falcon_r1cs_tpu/snark/tpu_msm.py` `_window_digits_signed`, a numpy
loop, as `snark/gpu_msm.py` keeps it for reference).  From the scalars
(n, 4) or (K, n, 4) as int64 (the u64 limbs, little-endian, viewed as
int64), the point set's infinity mask (n,) bool, the window w, the
padded width n_pad and the window count nw:

    digits (nw K, n_pad) int32, row j K + k the window-j digits of MSM k,
        each |d| | (d < 0) << w, d in [-(2^(w-1) - 1), 2^(w-1)]; zero on
        the infinity points and on the padding;
    overflow (1,) int32, 1 iff a scalar's top window took a carry out
        (the scalar does not fit the nw windows).

nw is `n_windows(w)` = ceil(255 / w) by default, the JAX package's count,
or `n_windows_carry(w)` = 255 // w + 1: one more where w divides 255
(w = 1, 3, 5, 15, 17), a top window over bits 255 and up whose digit is
the carry in, so that no scalar below 2^255 overflows.  The first
n_windows(w) windows are the same at both counts.

`signed_digits` is the plain version, bit-equal to the numpy recode with
the infinity zeroing and the padding.  `signed_digits_cuda` takes it for
CPU tensors, launches `signed_digits_kernel` for CUDA tensors and raises
for anything else; there is no fallback from a CUDA tensor to the plain
path.  `.launches` counts kernel launches.  Neither raises on overflow:
the caller reads the flag where it synchronises anyway
(`snark/gpu_msm._fold_windows_host`).
"""

from __future__ import annotations

import torch

from . import _build

LIMBS = 4


def n_windows(window: int) -> int:
    """Windows of w bits over a scalar below 2^255."""
    return (255 + window - 1) // window


def n_windows_carry(window: int) -> int:
    """Windows of w bits over a scalar below 2^255 and the top window's
    carry: n_windows(w), plus one where w divides 255."""
    return 255 // window + 1


def signed_digits(scalars, inf, window: int, n_pad: int, nw: int | None = None):
    """(digits, overflow) of the carry recode in plain torch.  torch's
    int64 `>>` is arithmetic, so every shifted limb is masked to the bits
    below its old top bit before use: limbs 0-2 can have it set."""
    sc = scalars if scalars.dim() == 3 else scalars[None]
    K, n = sc.shape[:2]
    sc = torch.where(inf[None, :, None], 0, sc)
    if nw is None:
        nw = n_windows(window)
    half, full = 1 << (window - 1), 1 << window
    out = torch.zeros((nw, K, n_pad), dtype=torch.int32, device=sc.device)
    carry = torch.zeros((K, n), dtype=torch.int64, device=sc.device)
    for w in range(nw):
        j, r = divmod(w * window, 64)
        if r + window <= 64:
            v = (sc[..., j] >> r) & ((1 << window) - 1)
        else:
            v = (sc[..., j] >> r) & ((1 << (64 - r)) - 1)
            if j + 1 < LIMBS:
                v = v | ((sc[..., j + 1] & ((1 << (r + window - 64)) - 1)) << (64 - r))
        d = v + carry
        neg = d > half
        carry = neg.long()
        sv = torch.where(neg, d - full, d)
        out[w, :, :n] = (sv.abs() | ((sv < 0).long() << window)).int()
    overflow = carry.any().reshape(1).int()
    return out.reshape(nw * K, n_pad), overflow


def signed_digits_cuda(scalars, inf, window: int, n_pad: int, nw: int | None = None):
    """(digits, overflow) of the recode: the kernel on CUDA tensors, the
    plain version on CPU tensors.  nw (default n_windows(w)) must be
    n_windows(w) or n_windows_carry(w) on every device."""
    name = "signed_digits_cuda"
    if not 1 <= window <= 30:
        raise ValueError(f"{name}: window {window}")
    if nw is None:
        nw = n_windows(window)
    if nw not in (n_windows(window), n_windows_carry(window)):
        raise ValueError(f"{name}: {nw} windows at w = {window}, want {n_windows(window)} "
                         f"or {n_windows_carry(window)}")
    if scalars.device.type == "cpu" and inf.device.type == "cpu":
        return signed_digits_cuda.plain(scalars, inf, window, n_pad, nw)
    dev = scalars.device
    if dev.type != "cuda" or inf.device != dev:
        raise ValueError(f"{name}: scalars on {dev}, mask on {inf.device}")
    if scalars.dtype != torch.int64 or inf.dtype != torch.bool:
        raise ValueError(f"{name}: want int64 scalars and a bool mask, got "
                         f"{scalars.dtype}, {inf.dtype}")
    if inf.dim() != 1 or scalars.dim() not in (2, 3) or \
            tuple(scalars.shape[-2:]) != (inf.shape[0], LIMBS):
        raise ValueError(f"{name}: want (n, 4) or (K, n, 4) scalars over an (n,) mask, got "
                         f"{tuple(scalars.shape)}, {tuple(inf.shape)}")
    if not (scalars.is_contiguous() and inf.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if scalars.data_ptr() % 16:
        raise ValueError(f"{name}: scalars must be 16-byte aligned")
    n = inf.shape[0]
    K = scalars.shape[0] if scalars.dim() == 3 else 1
    if n_pad < max(n, 1):
        raise ValueError(f"{name}: n_pad {n_pad} for n = {n}")
    digits = torch.empty((nw * K, n_pad), dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    _build.launch("signed_digits_launch", dev, scalars.data_ptr(), inf.data_ptr(),
                  digits.data_ptr(), overflow.data_ptr(), n, n_pad, K, window, nw)
    signed_digits_cuda.launches += 1
    return digits, overflow


signed_digits_cuda.launches = 0
signed_digits_cuda.plain = signed_digits
