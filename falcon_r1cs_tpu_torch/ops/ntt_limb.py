"""The bound-tracked NTT over exact 176-bit limb tensors, in plain torch,
and the dispatch to the hand-written CUDA kernels.

The counterpart of `falcon_r1cs_tpu/ops/ntt_limb.py`.  Stage l of the
constraint-free butterfly recursion of the NTT gadget:

    v     = out[j+ht] * s               (s = table[m+i] < q)
    neg_v = 2^l * q^(l+2) - v           (const_q_powers[l+1])
    out[j], out[j+ht] = out[j] + v, out[j] + neg_v

then the final mod-q hint per coefficient: quotient t = floor(V/q) (the
~2^146 witness) and remainder b = V mod q.

The plain versions of the kernels that compute it:

- `ntt_semi`, the stage loop over SEMI_LIMBS redundant limbs with one
  parallel carry round per step, is that of the semi-carry kernel (K8,
  ops/ntt_v3.py);
- `ntt_with_hints`, `ntt_semi` then the exact normalisation and divmod,
  is that of the hint kernel (K1) and of K8's hints epilogue;
- `intt_with_hints` is that of the fused INTT + hint kernel (K2).

The wrappers in ops/cuda_ntt.py and ops/ntt_v3.py take them for CPU
tensors, and the tests and the chip smoke hold the kernels against them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..falcon.ntt import intt_torch
from ..params import FalconParams
from .limbs import NUM_LIMBS, divmod_q, from_small, int_to_limbs, normalize

SEMI_LIMBS = NUM_LIMBS + 1  # 192-bit headroom: top limb never carries out


def _semi_norm(x):
    """One parallel carry round: (x & 0xFFFF) + shift_up(x >> 16).

    Limbs stay in [-3, 2^16 + 2], which keeps limb * s inside int32 for the
    next stage while preserving the redundant value exactly."""
    low = x & 0xFFFF
    carry = x >> 16  # arithmetic shift: signed-safe
    shifted = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]], dim=0)
    return low + shifted


def ntt_semi(x, params: FalconParams):
    """The stage loop of the bound-tracked NTT of (batch, n) int32
    coefficients in [0, q), over SEMI_LIMBS redundant 16-bit limbs.

    Returns the semi-normalised state (SEMI_LIMBS, batch, n) int32: each
    limb in about [-3, 2^16 + 2], the top limb zero, the value exact."""
    n, log_n = params.n, params.log_n
    L = SEMI_LIMBS
    dev = x.device
    table = torch.tensor(params.ntt_table, dtype=torch.int32, device=dev)
    bounds = torch.from_numpy(
        np.stack([int_to_limbs(c, L) for c in params.const_q_powers])
    ).to(dev)

    batch = x.shape[0]
    out = from_small(x.to(torch.int32), L)  # (L, batch, n)
    for l in range(log_n):
        m = 1 << l
        half = n >> (l + 1)
        o = out.reshape(L, batch, m, 2, half)
        u = o[:, :, :, 0, :]
        hi = o[:, :, :, 1, :]
        s = table[m : 2 * m].reshape(1, 1, m, 1)
        v = _semi_norm(hi * s)  # |limb * s| < 2^31
        c = bounds[l + 1].reshape(L, 1, 1, 1)
        new0 = _semi_norm(u + v)
        new1 = _semi_norm(u + (c - v))
        out = torch.stack([new0, new1], dim=3).reshape(L, batch, n)
    return out


def ntt_with_hints(x, params: FalconParams):
    """Bound-tracked NTT of (batch, n) int32 coefficients in [0, q).

    Returns (t_limbs, b):
      t_limbs: (11, batch, n) int32 -- mod-q quotient hints
      b:       (batch, n) int32           -- NTT outputs in [0, q)
    """
    t_limbs, b = divmod_q(normalize(ntt_semi(x, params)))
    return t_limbs[:NUM_LIMBS], b


def intt_with_hints(w, params: FalconParams):
    """The v chain in plain torch: NTT-domain w -> (v_t, v_b, v) with
    v = INTT(w) and (v_t, v_b) its forward hint-NTT outputs."""
    v = intt_torch(w, params.n)
    t, b = ntt_with_hints(v, params)
    return t, b, v


def ntt_hints(x, params: FalconParams):
    """The hint NTT, dispatched by the tensor's device: the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    from .cuda_ntt import ntt_with_hints_cuda

    return ntt_with_hints_cuda(x, params)


def intt_then_hints(w, params: FalconParams, fused_intt: bool = False):
    """The v derivation chain: NTT-domain w = (hm - sig_ntt*pk) mod q ->
    (v_t, v_b, v).  With `fused_intt` the fused INTT + hint kernel runs;
    otherwise the torch INTT, then the hint NTT."""
    if fused_intt:
        from .cuda_ntt import intt_ntt_hints_cuda

        return intt_ntt_hints_cuda(w, params)
    v = intt_torch(w, params.n)
    t, b = ntt_hints(v, params)
    return t, b, v
