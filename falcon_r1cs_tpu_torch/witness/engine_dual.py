"""Batched witness engine for the dual-NTT verification circuit, in torch.

The counterpart of `falcon_r1cs_tpu/witness/engine_dual.py`.  The four
limb-NTT hint computations (sig_pos, sig_neg, v_pos, v_neg) go through
`ops/ntt_limb.ntt_hints`: the hand-written kernel K1 on a CUDA device,
its plain version on the CPU.  Everything else is elementwise torch.

Witness layout (allocation order of FalconDualNTTVerificationCircuit, per
signature):
  sig_pos (n) | sig_neg (n)
  sig orthogonality: n mul wires (pos_i*neg_i partial products) |
      is_zero pair [is_neq bit, multiplier]
  v_pos (n) | v_neg (n) | v orthogonality (n + 2)
  sig_pos NTT mod_q (n, 29) | sig_neg NTT (n, 29)
  v_pos NTT (n, 29) | v_neg NTT (n, 29)
  pointwise (n, 60): [mul_L, t_L, b_L, 27] | [mul_R, t_R, b_R, 27]
                     (stored split: vals (6, B, n) int32 + two int8 tails)
  norm squares (4n)
  bound (50 | 52)

The is_zero multiplier is 1 when the accumulated pos*neg product is zero
(always, for disjoint-support duals): arkworks' equal-branch convention.
Segments keep the JAX engine's keys, dtypes and layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..falcon.ntt import intt_torch
from ..ops.modq import divmod_q as fast_divmod_q
from ..ops.modq import mul_mod_q, sub_mod_q
from ..ops.ntt_limb import ntt_hints
from ..params import FalconParams, Q, get_params
from .engine import _bound_block_512, _bound_block_1024, _modq_block
from .layout import _host, modq_seg

_HALF = 6144


def _dual_split(c):
    """[0, q) coeffs -> (pos, neg) with disjoint support (poly.py
    centering)."""
    pos = torch.where(c < _HALF, c, 0)
    neg = torch.where(c < _HALF, 0, Q - c)
    return pos, neg


def generate_witness_dual(sig_signed, pk_ntt, hm_ntt, params: FalconParams) -> dict:
    """All witness values of FalconDualNTTVerificationCircuit for a batch.

    sig_signed: (B, n) SIGNED signature coefficients; pk_ntt and hm_ntt
    (B, n) in the NTT domain [0, q), all on one device."""
    n = params.n
    sig_signed = sig_signed.to(torch.int32)
    pk_ntt = pk_ntt.to(torch.int32)
    hm_ntt = hm_ntt.to(torch.int32)

    sig_pos = torch.where(sig_signed >= 0, sig_signed, 0)
    sig_neg = torch.where(sig_signed < 0, -sig_signed, 0)

    # sig's hints first: the NTT is linear, so NTT(sig) = (sp_b - sn_b)
    # mod q and the hint NTTs' reduced outputs serve the v derivation
    sp_t, sp_b = ntt_hints(sig_pos, params)
    sn_t, sn_b = ntt_hints(sig_neg, params)

    # v = hm - sig*pk mod (q, x^n+1) via the NTT domain
    sig_ntt = sub_mod_q(sp_b, sn_b)
    v = intt_torch(sub_mod_q(hm_ntt, mul_mod_q(sig_ntt, pk_ntt)), n)
    v_pos, v_neg = _dual_split(v)

    vp_t, vp_b = ntt_hints(v_pos, params)
    vn_t, vn_b = ntt_hints(v_neg, params)

    # pointwise: left = mod_q(hm + vn + sn*pk), right = mod_q(vp + sp*pk)
    mul_l = sn_b * pk_ntt
    t_l, b_l = fast_divmod_q(hm_ntt + vn_b + mul_l)
    mul_r = sp_b * pk_ntt
    t_r, b_r = fast_divmod_q(vp_b + mul_r)

    # norm: squares over v_pos || v_neg || sig_pos || sig_neg
    coeffs = torch.cat([v_pos, v_neg, sig_pos, sig_neg], dim=-1)
    sq = coeffs * coeffs
    sum_lo = torch.sum(sq & 0xFFFF, dim=-1, dtype=torch.int32)
    sum_hi = torch.sum(sq >> 16, dim=-1, dtype=torch.int32)
    norm_lo = sum_lo & 0xFFFF
    norm_hi = sum_hi + (sum_lo >> 16)
    bound_block = _bound_block_512 if n == 512 else _bound_block_1024

    return {
        # orthogonality mul wires pos_i * neg_i: all zero for disjoint
        # support, but the allocation order is the contract
        "sig_pos": sig_pos, "sig_neg": sig_neg, "sig_orth": sig_pos * sig_neg,
        "v_pos": v_pos, "v_neg": v_neg, "v_orth": v_pos * v_neg,
        "sp_t": sp_t, "sp_b": sp_b, "sp_tail": _modq_block(sp_b),
        "sn_t": sn_t, "sn_b": sn_b, "sn_tail": _modq_block(sn_b),
        "vp_t": vp_t, "vp_b": vp_b, "vp_tail": _modq_block(vp_b),
        "vn_t": vn_t, "vn_b": vn_b, "vn_tail": _modq_block(vn_b),
        # feature-first (6, B, n) int32 and two (B, n, 27) int8 tails
        "pointwise_vals": torch.stack([mul_l, t_l, b_l, mul_r, t_r, b_r], dim=0),
        "pointwise_tail_l": _modq_block(b_l),
        "pointwise_tail_r": _modq_block(b_r),
        "norm_sq": sq, "bound": bound_block(norm_lo, norm_hi),
        "pk_ntt": pk_ntt, "hm_ntt": hm_ntt,
    }


def witness_engine_dual(n: int):
    """The dual-NTT witness generator for one parameter set: (sig_signed,
    pk_ntt, hm_ntt) -> segment dict.  The counterpart of
    `jitted_engine_dual`; torch runs eagerly, so nothing is compiled
    here."""
    params = get_params(n)

    def run(sig_signed, pk_ntt, hm_ntt):
        return generate_witness_dual(sig_signed, pk_ntt, hm_ntt, params)

    return run


def interleave_witness_dual(seg: dict, params: FalconParams) -> np.ndarray:
    """(B, num_witness) object array of Python ints in allocation order."""
    n = params.n

    def o(k):
        return _host(seg[k]).astype(object)

    B = _host(seg["sig_pos"]).shape[0]
    # is_zero pair on the valid path: [is_neq bit 0, multiplier 1]
    is_zero = np.tile(np.array([0, 1], dtype=object), (B, 1))

    # re-interleave the 60-wide pointwise block from the split segments
    pw = np.empty((B, n, 60), dtype=object)
    vals = o("pointwise_vals")
    pw[:, :, 0], pw[:, :, 1], pw[:, :, 2] = vals[0], vals[1], vals[2]
    pw[:, :, 3:30] = o("pointwise_tail_l")
    pw[:, :, 30], pw[:, :, 31], pw[:, :, 32] = vals[3], vals[4], vals[5]
    pw[:, :, 33:] = o("pointwise_tail_r")
    parts = [
        o("sig_pos"), o("sig_neg"), o("sig_orth"), is_zero,
        o("v_pos"), o("v_neg"), o("v_orth"), is_zero,
        *(modq_seg(seg, k).reshape(B, -1) for k in ("sp", "sn", "vp", "vn")),
        pw.reshape(B, -1),
        o("norm_sq"),
        o("bound"),
    ]
    return np.concatenate(parts, axis=1)
