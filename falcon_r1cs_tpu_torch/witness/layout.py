"""Witness layout: interleaving the engine's compact segments into the
canonical flat witness vector (arkworks allocation order), on the host,
and its dense limb export.

The counterpart of `falcon_r1cs_tpu/witness/layout.py`, rebased on the
port's ops/limbs.py.  Segments may be torch tensors (any device) or numpy
arrays; the flat order is the contract checked bit-exactly against the
host trace (`ConstraintSystem.witness_values`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.limbs import limbs_to_ints
from ..params import FalconParams


def bound_width(params: FalconParams) -> int:
    return 50 if params.n == 512 else 52


def num_witness(params: FalconParams) -> int:
    n = params.n
    return n + n + 27 * n + 29 * n * 2 + 30 * n + 18 * 2 * n + bound_width(params)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def modq_seg(seg: dict, prefix: str) -> np.ndarray:
    """(B, n, 29) object array of one mod_q block [t | b | 27 bits+chain]
    from the segments `prefix`_t (11, B, n) limbs, `prefix`_b (B, n) and
    `prefix`_tail (B, n, 27)."""
    b = _host(seg[prefix + "_b"])
    out = np.empty(b.shape + (29,), dtype=object)
    out[:, :, 0] = limbs_to_ints(_host(seg[prefix + "_t"]))
    out[:, :, 1] = b.astype(object)
    out[:, :, 2:] = _host(seg[prefix + "_tail"]).astype(object)
    return out


def interleave_witness(seg: dict, params: FalconParams) -> np.ndarray:
    """(B, num_witness) object array of Python ints from the engine's
    segment dict."""
    def obj(name):
        return _host(seg[name]).astype(object)

    sig = obj("sig")
    B = sig.shape[0]

    # canonical 30-wide pointwise block = [prod, t, c | bits+chain]
    pointwise = np.concatenate([obj("pointwise"), obj("pointwise_tail")], axis=-1)
    # canonical 18-wide norm block = [bits|nor|and | select, square];
    # the engine emits these feature-first (16|2, B, 2n)
    norm = np.concatenate(
        [obj("norm_bits").transpose(1, 2, 0), obj("norm_vals").transpose(1, 2, 0)],
        axis=-1,
    )
    parts = [
        sig, obj("v"), obj("range_v"), modq_seg(seg, "sig_ntt"), modq_seg(seg, "v_ntt"),
        pointwise, norm, obj("bound"),
    ]
    out = np.concatenate([p.reshape(B, -1) for p in parts], axis=1)
    assert out.shape == (B, num_witness(params))
    return out


def export_witness_limbs(seg: dict, params: FalconParams) -> np.ndarray:
    """Canonical dense export: (B, num_witness, 5) uint32 little-endian
    32-bit limbs of the interleaved witness (every value is below 2^160;
    the ~255-bit field embedding pads with zero limbs).  The split runs
    limb by limb over the whole object array, not value by value."""
    rest = interleave_witness(seg, params)
    out = np.empty(rest.shape + (5,), dtype=np.uint32)
    for k in range(5):
        out[..., k] = (rest & 0xFFFFFFFF).astype(np.uint32)
        rest = rest >> 32
    if (rest != 0).any():
        raise ValueError("a witness value is negative or not below 2^160")
    return out
