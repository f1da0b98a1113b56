"""The schoolbook circuit's negacyclic product block: its plain torch
version and the wrapper of the hand-written CUDA kernel (K3,
`csrc/schoolbook.cu`).

The counterpart of `falcon_r1cs_tpu/ops/pallas_schoolbook.py`.  From sig
and pk, (B, n) int32 in [0, q):

    prods[b, i, j] = sig[b, j] * buf[b, n-1-i+j],   buf = flip([q - pk || pk])
    H, L (B, n):     the exact base-2^16 split of each row sum over j

`schoolbook_prods` is the plain version, the XLA formulation of the JAX
engine (`witness/engine_schoolbook.py`, `use_pallas=False`); every sum is
int32 and exact (products < q^2 < 2^28, low-half sums < n 2^16, high-half
sums < n 2^12).  `schoolbook_prods_cuda` takes it for a CPU tensor,
launches the kernel for a CUDA tensor, and raises for anything else;
`.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..params import Q, get_params
from . import _build
from .cuda_ntt import _check_input


def schoolbook_prods(sig, pk, n: int):
    """(prods (B, n, n), H (B, n), L (B, n)) int32, in plain torch."""
    sig = sig.to(torch.int32)
    pk = pk.to(torch.int32)
    buf = torch.flip(torch.cat([Q - pk, pk], dim=-1), dims=[-1])  # (B, 2n)
    ar = torch.arange(n, device=sig.device)
    idx = (n - 1) - ar[:, None] + ar[None, :]
    cols = buf[:, idx]                                  # cols[b, i, j]
    prods = sig[:, None, :] * cols
    lo = torch.sum(prods & 0xFFFF, dim=-1, dtype=torch.int32)
    hi = torch.sum(prods >> 16, dim=-1, dtype=torch.int32)
    return prods, hi + (lo >> 16), lo & 0xFFFF


def schoolbook_prods_cuda(sig, pk, n: int):
    """The product block of sig and pk: K3 on a CUDA tensor, the plain
    version on a CPU tensor."""
    if sig.device.type == "cpu" and pk.device.type == "cpu":
        return schoolbook_prods_cuda.plain(sig, pk, n)
    params = get_params(n)
    _check_input(sig, params, "schoolbook_prods_cuda")
    _check_input(pk, params, "schoolbook_prods_cuda")
    if pk.device != sig.device or pk.shape != sig.shape:
        raise ValueError(
            "schoolbook_prods_cuda: sig and pk must share device and shape, "
            f"got {tuple(sig.shape)} on {sig.device}, {tuple(pk.shape)} on {pk.device}"
        )
    if sig.data_ptr() % 16:
        raise ValueError("schoolbook_prods_cuda: sig must be 16-byte aligned")
    batch = sig.shape[0]
    prods = torch.empty((batch, n, n), dtype=torch.int32, device=sig.device)
    h = torch.empty((batch, n), dtype=torch.int32, device=sig.device)
    l = torch.empty((batch, n), dtype=torch.int32, device=sig.device)
    if batch == 0:
        return prods, h, l
    _build.launch(
        "schoolbook_prods_launch", sig.device,
        sig.data_ptr(), pk.data_ptr(), prods.data_ptr(), h.data_ptr(),
        l.data_ptr(), batch, n,
    )
    schoolbook_prods_cuda.launches += 1
    return prods, h, l


schoolbook_prods_cuda.launches = 0
schoolbook_prods_cuda.plain = schoolbook_prods
