"""Batched witness engine for the schoolbook verification circuit, in torch.

The counterpart of `falcon_r1cs_tpu/witness/engine_schoolbook.py`.  The
heavy section is the n x n negacyclic product block: every one of the n^2
products is a witness (the mul wires inside inner_product_mod), so the
engine is dominated by the (B, n, n) product tensor.  It comes from
`ops/schoolbook.schoolbook_prods_cuda`: the hand-written kernel K3 on a
CUDA device, its plain version on the CPU.

Witness layout (allocation order of FalconSchoolBookVerificationCircuit):
  sig (n)
  v block (n, 28): per coeff [v_i | 14 bits | 13 chain]
  main loop (n, n+34): per column i:
      [t_i, c_i | n mul wires | 27 range chain of c_i |
       is_eq(rhs, v): [neq1, mult1] | is_eq(rhs, v+q): [neq2, mult2] |
       or wire]
  norm (2n, 18)  (v coeffs then sig coeffs)
  bound (50 | 52)

The is_eq multipliers take only three values on the valid path -- 1
(equal branch), q^-1 mod p and -(q^-1) mod p -- kept on the device as
codes {0, 1, 2} and expanded to field integers by the interleaver and the
packer.  Segments keep the JAX engine's keys, dtypes and layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..falcon.ntt import intt_torch, ntt_torch
from ..ops.modq import divmod_q as fast_divmod_q
from ..ops.modq import mul_mod_q, sub_mod_q
from ..ops.schoolbook import schoolbook_prods_cuda
from ..params import FIELD_MODULUS, FalconParams, Q, get_params
from .engine import _bits, _bound_block_512, _bound_block_1024, _lt_q_chain, _norm_block
from .layout import _host

Q_INV_MOD_P = pow(Q, FIELD_MODULUS - 2, FIELD_MODULUS)
NEG_Q_INV_MOD_P = FIELD_MODULUS - Q_INV_MOD_P


def _mult_code(d):
    """is_eq multiplier code of a valid-path difference d in {0, +-q}:
    0 -> 1 (equal), 1 -> q^-1 (d == q), 2 -> -q^-1 (d == -q)."""
    return torch.where(
        d == 0, 0, torch.where(d == Q, 1, 2)
    ).to(torch.int32)


def generate_witness_schoolbook(sig, pk, hm, params: FalconParams) -> dict:
    """All witness values for a batch.  Inputs (B, n) integer tensors on
    one device: sig lifted to [0, q); pk and hm in the COEFFICIENT domain
    (the circuit's public inputs here, unlike the NTT circuits)."""
    n = params.n
    sig = sig.to(torch.int32)
    pk = pk.to(torch.int32)
    hm = hm.to(torch.int32)

    # v = hm - sig*pk mod (q, x^n+1)
    v = intt_torch(
        sub_mod_q(ntt_torch(hm, n), mul_mod_q(ntt_torch(sig, n), ntt_torch(pk, n))),
        n,
    )
    v_bits = _bits(v, 14)
    v_block = torch.cat(
        [v[..., None], v_bits.to(torch.int32), _lt_q_chain(v_bits, v).to(torch.int32)],
        dim=-1,
    )  # (B, n, 28)

    prods, H, L = schoolbook_prods_cuda(sig, pk, n)
    tq, r = fast_divmod_q(H)
    tl, c = fast_divmod_q((r << 16) + L)
    t = (tq << 16) + tl                                  # quotient hint

    c_bits = _bits(c, 14)
    c_chain = _lt_q_chain(c_bits, c)

    # rhs = hm + q - c; valid path: rhs == v or rhs == v + q
    rhs = hm + Q - c
    d1 = rhs - v
    d2 = rhs - v - Q
    neq1 = (d1 != 0).to(torch.int32)
    neq2 = (d2 != 0).to(torch.int32)
    or_wire = neq1 * neq2
    # validity flag: for in-range inputs the diffs are provably in
    # {0, +q} / {0, -q}; anything else means out-of-range data, whose
    # code-expanded multipliers would diverge from the host trace.
    # (B,) int32, 1 = trustworthy
    ok = ((d1 == 0) | (d1 == Q)) & ((d2 == 0) | (d2 == -Q))
    valid = ok.all(dim=-1).to(torch.int32)

    tc = torch.stack([t, c], dim=-1)                             # (B, n, 2)
    c_tail = torch.cat([c_bits, c_chain], dim=-1)                # (B, n, 27)
    iseq = torch.stack(
        [neq1, _mult_code(d1), neq2, _mult_code(d2), or_wire], dim=-1
    )                                                            # (B, n, 5)

    # norm over v || sig: the canonical 18-wide block, int32
    nbits16, sel, sq = _norm_block(torch.cat([v, sig], dim=-1))
    norm = torch.cat([nbits16.to(torch.int32), sel[..., None], sq[..., None]], dim=-1)
    sum_lo = torch.sum(sq & 0xFFFF, dim=-1, dtype=torch.int32)
    sum_hi = torch.sum(sq >> 16, dim=-1, dtype=torch.int32)
    norm_lo = sum_lo & 0xFFFF
    norm_hi = sum_hi + (sum_lo >> 16)
    bound_block = _bound_block_512 if n == 512 else _bound_block_1024

    return {
        "sig": sig, "v_block": v_block,
        "tc": tc, "prods": prods, "c_tail": c_tail, "iseq": iseq,
        "norm": norm, "bound": bound_block(norm_lo, norm_hi),
        "pk": pk, "hm": hm, "valid": valid,
    }


def witness_engine_schoolbook(n: int):
    """The schoolbook witness generator for one parameter set: (sig, pk,
    hm) -> segment dict.  The counterpart of `jitted_engine_schoolbook`;
    torch runs eagerly, so nothing is compiled here."""
    params = get_params(n)

    def run(sig, pk, hm):
        return generate_witness_schoolbook(sig, pk, hm, params)

    return run


_MULT_VALUES = np.asarray([1, Q_INV_MOD_P, NEG_Q_INV_MOD_P], dtype=object)


def interleave_witness_schoolbook(seg: dict, params: FalconParams) -> np.ndarray:
    """(B, num_witness) object array of Python ints in allocation order,
    with the multiplier codes expanded to field integers."""
    def o(k):
        return _host(seg[k]).astype(object)

    B = _host(seg["sig"]).shape[0]
    iseq = o("iseq")
    codes = _host(seg["iseq"]).astype(np.int64)
    for slot in (1, 3):  # mult1, mult2
        iseq[:, :, slot] = _MULT_VALUES[codes[:, :, slot]]
    main = np.concatenate([o("tc"), o("prods"), o("c_tail"), iseq], axis=-1)
    parts = [
        o("sig"),
        o("v_block").reshape(B, -1),
        main.reshape(B, -1),
        o("norm").reshape(B, -1),
        o("bound"),
    ]
    return np.concatenate(parts, axis=1)
