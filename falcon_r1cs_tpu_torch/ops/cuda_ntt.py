"""Wrappers, launch counters and host tables of the hand-written CUDA hint
kernels in `csrc/ntt_hints.cu`.

The counterpart of `falcon_r1cs_tpu/ops/pallas_ntt.py`:

- `ntt_with_hints_cuda` launches `ntt_hints_kernel` (the port of
  `_make_kernel`, K1): (B, n) int32 in [0, q) -> t (11, B, n), b (B, n).
- `intt_ntt_hints_cuda` launches `intt_ntt_hints_kernel` (the port of
  `_make_kernel_vchain`, K2): NTT-domain w (B, n) -> t, b and v = INTT(w).

Each wrapper takes its plain torch version (`.plain`, from ops/ntt_limb.py)
for a CPU tensor, launches its kernel for a CUDA tensor, and raises for
anything else; there is no fallback from a CUDA tensor to the plain path.
`.launches` counts kernel launches.

The host tables are built from the same `params.py` sources as the JAX
package's and compared with them in the tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import FalconParams, Q, get_params
from . import _build
from .limbs import LIMB_BITS, NUM_LIMBS, int_to_limbs
from .ntt_limb import SEMI_LIMBS, intt_with_hints, ntt_with_hints

# 32-bit words a coefficient of the hint kernels holds (every value < 2^164)
WORDS = 6


def _stage_tables(params: FalconParams):
    """(log_n, n) per-position twiddles and (log_n + 1, 11) bound limbs."""
    n, log_n = params.n, params.log_n
    table = np.asarray(params.ntt_table, dtype=np.int32)
    tw = np.zeros((log_n, n), dtype=np.int32)
    j = np.arange(n)
    for l in range(log_n):
        half = n >> (l + 1)
        tw[l] = table[(1 << l) + j // (2 * half)]
    bounds = np.stack(
        [int_to_limbs(c, NUM_LIMBS) for c in params.const_q_powers]
    ).astype(np.int32)
    return tw, bounds


def _active_limbs(params: FalconParams):
    """Per-stage active limb counts: after stage l every value is below
    const_q_powers[l+1] and the stage's intermediates below twice that, so
    only ceil((bits + 2) / 16) limb rows take part; the rows above stay
    zero from initialization.  The hint kernels hold ceil(act / 2) words of
    32 bits a stage (`kActiveWords` in csrc/ntt_hints.cu)."""
    return [
        min(
            NUM_LIMBS,
            (params.const_q_powers[l + 1].bit_length() + 2 + LIMB_BITS - 1)
            // LIMB_BITS,
        )
        for l in range(params.log_n)
    ]


def _bound_words(params: FalconParams):
    """(log_n + 1, WORDS) 32-bit words of the stage bounds
    (const_q_powers), least first, as int32 bit patterns."""
    words = [[(c >> (32 * w)) & 0xFFFFFFFF for w in range(WORDS)]
             for c in params.const_q_powers]
    return np.asarray(words, dtype=np.uint32).view(np.int32)


def tables_from_params(params: FalconParams, device) -> dict:
    """The kernels' tables for one parameter set, as int32 tensors on
    `device`.  The hint kernels K1 and K2: roots (n,) = ntt_table, inv_roots
    (n,) = inv_ntt_table premultiplied by 2^16 mod q (the INTT's Montgomery
    domain), bound_words (log_n + 1, WORDS).  The semi-carry kernel K8:
    the per-position twiddles tw (log_n, n) and the bound limbs bounds
    (log_n + 1, 11)."""
    tw, bounds = _stage_tables(params)
    inv = np.asarray(params.inv_ntt_table, dtype=np.int64)
    host = {
        "roots": np.asarray(params.ntt_table, dtype=np.int32),
        "inv_roots": ((inv << 16) % Q).astype(np.int32),
        "bound_words": _bound_words(params),
        "tw": tw,
        "bounds": bounds,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


@functools.lru_cache(maxsize=None)
def _tables(n: int, device: torch.device) -> dict:
    return tables_from_params(get_params(n), device)


@functools.lru_cache(maxsize=None)
def _semi_tables(n: int, device: torch.device) -> dict:
    """The semi-carry kernel's tables: K1's twiddles tw (log_n, n) and its
    bound limbs widened by a zero column to (log_n + 1, SEMI_LIMBS), as
    tools/pallas_ntt_v3.py pads them."""
    tab = _tables(n, device)
    pad = SEMI_LIMBS - NUM_LIMBS
    return {"tw": tab["tw"], "bounds": torch.nn.functional.pad(tab["bounds"], (0, pad))}


def _check_layout(x, params: FalconParams, name: str):
    if x.dtype != torch.int32:
        raise ValueError(f"{name}: want int32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != params.n:
        raise ValueError(f"{name}: want (B, {params.n}), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _check_input(x, params: FalconParams, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    _check_layout(x, params, name)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: input must be 16-byte aligned")


def ntt_with_hints_cuda(x, params: FalconParams):
    """(t_limbs (11, B, n), b (B, n)) of the bound-tracked hint NTT."""
    if x.device.type == "cpu":
        return ntt_with_hints_cuda.plain(x, params)
    _check_input(x, params, "ntt_with_hints_cuda")
    batch, n = x.shape
    t = torch.empty((NUM_LIMBS, batch, n), dtype=torch.int32, device=x.device)
    b = torch.empty((batch, n), dtype=torch.int32, device=x.device)
    if batch == 0:
        return t, b
    tab = _tables(n, x.device)
    _build.launch(
        "ntt_hints_launch", x.device,
        x.data_ptr(), tab["roots"].data_ptr(), tab["bound_words"].data_ptr(),
        t.data_ptr(), b.data_ptr(), batch, params.log_n,
    )
    ntt_with_hints_cuda.launches += 1
    return t, b


ntt_with_hints_cuda.launches = 0
ntt_with_hints_cuda.plain = ntt_with_hints


def intt_ntt_hints_cuda(w, params: FalconParams):
    """(v_t (11, B, n), v_b (B, n), v (B, n)) with v = INTT(w)."""
    if w.device.type == "cpu":
        return intt_ntt_hints_cuda.plain(w, params)
    _check_input(w, params, "intt_ntt_hints_cuda")
    batch, n = w.shape
    t = torch.empty((NUM_LIMBS, batch, n), dtype=torch.int32, device=w.device)
    b = torch.empty((batch, n), dtype=torch.int32, device=w.device)
    v = torch.empty((batch, n), dtype=torch.int32, device=w.device)
    if batch == 0:
        return t, b, v
    tab = _tables(n, w.device)
    _build.launch(
        "intt_ntt_hints_launch", w.device,
        w.data_ptr(), tab["roots"].data_ptr(), tab["inv_roots"].data_ptr(),
        tab["bound_words"].data_ptr(), t.data_ptr(), b.data_ptr(), v.data_ptr(),
        batch, params.log_n,
    )
    intt_ntt_hints_cuda.launches += 1
    return t, b, v


intt_ntt_hints_cuda.launches = 0
intt_ntt_hints_cuda.plain = intt_with_hints
