"""Batched witness engine for the verify-with-NTT circuit, in torch.

The counterpart of `falcon_r1cs_tpu/witness/engine.py`: one function
computes every witness value of `FalconNTTVerificationCircuit` for a whole
batch of signatures as dense tensors, bit-exactly equal to the host trace's
`cs.witness_values` once interleaved (witness/layout.py).  The two limb-NTT
hint computations go through the CUDA kernels on a CUDA device
(ops/ntt_limb.py dispatch); everything else is elementwise torch.

Witness layout (allocation order of the circuit, per signature):
  sig            (n,)        input coefficients [0, q)
  v              (n,)        v = hm - sig*pk lifted to [0, q)
  range_v        (n, 27)     per coeff: 14 bits | w1..w11 | w12 | w13
  sig_ntt mod_q  (n, 29)     per coeff: t | b | 14 bits | 13 chain
  v_ntt mod_q    (n, 29)     (t is the ~2^146 big quotient, limb-encoded)
  pointwise      (n, 30)     per coeff: prod | t | c | 14 bits | 13 chain
  norm           (2n, 18)    per coeff (v then sig): 14 bits | nor | and |
                             select | square
  bound          (50 | 52,)  26/27 bits | kary chain | binary chain

Segments keep the JAX engine's dtypes and layouts: bit and boolean-chain
tensors int8, values int32, hint limbs (11, B, n), and the norm block
feature-first, `norm_bits` (16, B, 2n) and `norm_vals` (2, B, 2n).

Boolean-chain value semantics: `or` allocates the NOR (1-a)(1-b); `and`
allocates the product; kary folds left.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.modq import divmod_q as fast_divmod_q
from ..ops.modq import mul_mod_q, sub_mod_q
from ..ops.ntt_limb import intt_then_hints, ntt_hints
from ..params import FalconParams, Q, get_params


def _bits(x, count):
    """(...,) int32 -> (..., count) int8 bits, little-endian."""
    shifts = torch.arange(count, dtype=torch.int32, device=x.device)
    return ((x[..., None] >> shifts) & 1).to(torch.int8)


def _lt_q_chain(bits14, val):
    """The 13 logic witnesses of enforce_less_than_q after the 14 bits:
    w_k = prod_{i<=k}(1-b_i) for k=1..11; w12 = b12*(1-w11);
    w13 = b13*w12.  The prefix products are [val mod 2^(k+1) == 0]."""
    masks = torch.tensor(
        [(1 << (k + 1)) - 1 for k in range(1, 12)],
        dtype=torch.int32, device=val.device,
    )
    w = ((val[..., None] & masks) == 0).to(torch.int8)
    w12 = bits14[..., 12] * (1 - w[..., -1])
    w13 = bits14[..., 13] * w12
    return torch.cat([w, w12[..., None], w13[..., None]], dim=-1)


def _modq_block(b_val):
    """[bits | chain] (..., 27) int8 of a mod-q remainder b < q."""
    bits = _bits(b_val, 14)
    return torch.cat([bits, _lt_q_chain(bits, b_val)], dim=-1)


def _norm_block(c):
    """is_less_than_6144 + select + square for coeffs c (..., 2n) in
    [0, q), feature axis last: bits16 (..., 2n, 16) int8 = 14 bits |
    nor=b12*b11 | and=(1-b13)(1-nor); sel and sq (..., 2n) int32.  The
    schoolbook engine's canonical 18-wide block is [bits16 | sel | sq]."""
    bits = _bits(c, 14)
    w_nor = bits[..., 12] * bits[..., 11]
    w_and = (1 - bits[..., 13]) * (1 - w_nor)
    sel = torch.where(w_and == 1, c, Q - c)
    sq = sel * sel
    bits16 = torch.cat([bits, w_nor[..., None], w_and[..., None]], dim=-1)
    return bits16, sel, sq


def _norm_block_t(c):
    """_norm_block with the feature axis first, for coeffs c (B, 2n):
    bits16 (16, B, 2n) int8; sel and sq (B, 2n) int32."""
    shifts = torch.arange(14, dtype=torch.int32, device=c.device)[:, None, None]
    bits = ((c[None, :, :] >> shifts) & 1).to(torch.int8)
    w_nor = bits[12] * bits[11]
    w_and = (1 - bits[13]) * (1 - w_nor)
    sel = torch.where(w_and == 1, c, Q - c)
    sq = sel * sel
    bits16 = torch.cat([bits, w_nor[None], w_and[None]], dim=0)
    return bits16, sel, sq


def _nor_prefix(bits):
    """kary_or witness values: prefix products of (1-b)."""
    return torch.cumprod(1 - bits, dim=-1, dtype=torch.int8)


def _and_prefix(bits):
    """kary_and witness values: prefix products of b."""
    return torch.cumprod(bits, dim=-1, dtype=torch.int8)


def _bound_block_512(norm_lo, norm_hi):
    """The 50 norm-bound witnesses for Falcon-512 in allocation order
    (norm = norm_hi * 2^16 + norm_lo, norm_lo < 2^16)."""
    bits = torch.cat([_bits(norm_lo, 16), _bits(norm_hi, 10)], dim=-1)
    b = [bits[..., i] for i in range(26)]

    u = _nor_prefix(bits[..., 19:25])[..., 1:]   # u1..u5
    v_ = _and_prefix(bits[..., 16:19])[..., 1:]  # v1, v2
    up = _nor_prefix(bits[..., 6:10])[..., 1:]   # u'1..u'3
    k4 = (1 - b[3]) * (1 - b[4])
    vp = b[1] * b[2]

    a6 = k4 * (1 - vp)
    o6 = b[5] * (1 - a6)
    a5 = up[..., -1] * (1 - o6)
    o5 = b[10] * (1 - a5)
    a4 = (1 - b[11]) * (1 - o5)
    o4 = b[12] * (1 - a4)
    a3 = (1 - b[13]) * (1 - o4)
    o3 = b[14] * (1 - a3)
    a2 = (1 - b[15]) * (1 - o3)
    o2 = v_[..., -1] * (1 - a2)
    a1 = u[..., -1] * (1 - o2)
    o1 = b[25] * (1 - a1)

    tail = torch.stack(
        [k4, vp, a6, o6, a5, o5, a4, o4, a3, o3, a2, o2, a1, o1], dim=-1
    )
    return torch.cat([bits, u, v_, up, tail], dim=-1)


def _bound_block_1024(norm_lo, norm_hi):
    """The 52 norm-bound witnesses for Falcon-1024 in allocation order."""
    bits = torch.cat([_bits(norm_lo, 16), _bits(norm_hi, 11)], dim=-1)
    b = [bits[..., i] for i in range(27)]

    u = _nor_prefix(bits[..., 22:26])[..., 1:]    # u1..u3 (kary_or 22..25)
    v1 = b[20] * b[21]                            # kary_and 20..21
    up = _nor_prefix(bits[..., 14:20])[..., 1:]   # u'1..u'5 (kary_or 14..19)
    w1 = (1 - b[9]) * (1 - b[10])                 # kary_or 9..10
    x1 = b[7] * b[8]                              # kary_and 7..8
    y1 = (1 - b[5]) * (1 - b[6])                  # kary_or 5..6
    z1 = b[3] * b[4]                              # kary_and 3..4
    q1 = (1 - b[1]) * (1 - b[2])                  # kary_or 1..2

    o6 = z1 * (1 - q1)
    a6 = y1 * (1 - o6)
    o5 = x1 * (1 - a6)
    a5 = w1 * (1 - o5)
    o4 = b[11] * (1 - a5)
    a4 = (1 - b[12]) * (1 - o4)
    o3 = b[13] * (1 - a4)
    a3 = up[..., -1] * (1 - o3)
    o2 = v1 * (1 - a3)
    a2 = u[..., -1] * (1 - o2)
    o1 = b[26] * (1 - a2)

    tail = torch.stack(
        [w1, x1, y1, z1, q1, o6, a6, o5, a5, o4, a4, o3, a3, o2, a2, o1],
        dim=-1,
    )
    return torch.cat([bits, u, v1[..., None], up, tail], dim=-1)


@dataclass
class WitnessBatch:
    """Device-resident witness values for a batch (compact segment form)."""

    params: FalconParams
    sig: torch.Tensor             # (B, n) int32
    v: torch.Tensor               # (B, n) int32
    range_v: torch.Tensor         # (B, n, 27) int8 bits+chain
    sig_ntt_t: torch.Tensor       # (11, B, n) int32 limbs
    sig_ntt_b: torch.Tensor       # (B, n) int32
    sig_ntt_tail: torch.Tensor    # (B, n, 27) int8 bits+chain
    v_ntt_t: torch.Tensor         # (11, B, n) int32
    v_ntt_b: torch.Tensor         # (B, n) int32
    v_ntt_tail: torch.Tensor      # (B, n, 27) int8
    pointwise: torch.Tensor       # (B, n, 3) int32 [prod | t | c]
    pointwise_tail: torch.Tensor  # (B, n, 27) int8 bits+chain
    norm_bits: torch.Tensor       # (16, B, 2n) int8 bits|nor|and
    norm_vals: torch.Tensor       # (2, B, 2n) int32 [select | square]
    bound: torch.Tensor           # (B, 50|52) int8
    pk_ntt: torch.Tensor          # (B, n) int32 public input
    hm_ntt: torch.Tensor          # (B, n) int32 public input


def generate_witness_ntt(
    sig, pk_ntt, hm_ntt, params: FalconParams, fused_intt: bool = False
) -> WitnessBatch:
    """All witness values of FalconNTTVerificationCircuit for a batch.

    Inputs: (B, n) integer tensors on one device: sig lifted to [0, q),
    pk and hm in the NTT domain [0, q).  `fused_intt` selects the fused
    INTT + hint kernel for the v chain (ops/ntt_limb.intt_then_hints)."""
    sig = sig.to(torch.int32)
    pk_ntt = pk_ntt.to(torch.int32)
    hm_ntt = hm_ntt.to(torch.int32)

    # sig's hints first: the hint NTT's reduced output sig_b IS the clear
    # NTT of sig, so the v derivation reuses it
    sig_t, sig_b = ntt_hints(sig, params)

    # v = hm - sig*pk mod (q, x^n+1)
    w = sub_mod_q(hm_ntt, mul_mod_q(sig_b, pk_ntt))
    v_t, v_b, v = intt_then_hints(w, params, fused_intt)

    v_bits = _bits(v, 14)
    range_v = torch.cat([v_bits, _lt_q_chain(v_bits, v)], dim=-1)

    # pointwise: hm = v_ntt + sig_ntt*pk_ntt mod q
    prod = sig_b * pk_ntt                     # < q^2 < 2^27
    t_pw, c_pw = fast_divmod_q(v_b + prod)
    pointwise = torch.stack([prod, t_pw, c_pw], dim=-1)

    # l2 norm over v || sig (feature-first)
    norm_bits, sel, sq = _norm_block_t(torch.cat([v, sig], dim=-1))
    norm_vals = torch.stack([sel, sq], dim=0)
    # exact 37-bit sum as an int32 pair
    sum_lo = torch.sum(sq & 0xFFFF, dim=-1, dtype=torch.int32)
    sum_hi = torch.sum(sq >> 16, dim=-1, dtype=torch.int32)
    norm_lo = sum_lo & 0xFFFF
    norm_hi = sum_hi + (sum_lo >> 16)
    bound_block = _bound_block_512 if params.n == 512 else _bound_block_1024

    return WitnessBatch(
        params=params,
        sig=sig,
        v=v,
        range_v=range_v,
        sig_ntt_t=sig_t,
        sig_ntt_b=sig_b,
        sig_ntt_tail=_modq_block(sig_b),
        v_ntt_t=v_t,
        v_ntt_b=v_b,
        v_ntt_tail=_modq_block(v_b),
        pointwise=pointwise,
        pointwise_tail=_modq_block(c_pw),
        norm_bits=norm_bits,
        norm_vals=norm_vals,
        bound=bound_block(norm_lo, norm_hi),
        pk_ntt=pk_ntt,
        hm_ntt=hm_ntt,
    )


def witness_engine(n: int, fused_intt: bool = False):
    """The witness generator for one parameter set: (sig, pk_ntt, hm_ntt)
    -> segment dict.  The counterpart of the JAX package's `jitted_engine`;
    torch runs eagerly, so nothing is compiled here."""
    params = get_params(n)

    def run(sig, pk_ntt, hm_ntt):
        return _seg_dict(
            generate_witness_ntt(sig, pk_ntt, hm_ntt, params, fused_intt)
        )

    return run


def _seg_dict(wb: WitnessBatch) -> dict:
    return {
        "sig": wb.sig, "v": wb.v, "range_v": wb.range_v,
        "sig_ntt_t": wb.sig_ntt_t, "sig_ntt_b": wb.sig_ntt_b,
        "sig_ntt_tail": wb.sig_ntt_tail,
        "v_ntt_t": wb.v_ntt_t, "v_ntt_b": wb.v_ntt_b,
        "v_ntt_tail": wb.v_ntt_tail,
        "pointwise": wb.pointwise, "pointwise_tail": wb.pointwise_tail,
        "norm_bits": wb.norm_bits, "norm_vals": wb.norm_vals,
        "bound": wb.bound,
        "pk_ntt": wb.pk_ntt, "hm_ntt": wb.hm_ntt,
    }
