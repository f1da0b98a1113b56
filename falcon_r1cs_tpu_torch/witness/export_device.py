"""Device-side canonical witness export: (B, num_witness, L) int32 holding
the little-endian 32-bit limbs of every witness value.

The counterpart of `falcon_r1cs_tpu/witness/export_device.py`: one packer
per circuit, built once per (n, device) with its slot index tensors on the
device.  Each packer allocates one zeroed (B, W, L) tensor and places each
engine segment into its canonical positions by index assignment through
the limb planes.

- `packer_ntt`, `packer_dual`: L = 5.  Only the NTT quotient hints
  (< 2^147) occupy limbs 1..4; everything else fits limb 0.
- `packer_schoolbook`: L = 8.  The is_eq multipliers are full ~255-bit
  field values, expanded on the device from their codes {0, 1, 2} through
  a constant (3, 8) limb table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import get_params
from .engine_schoolbook import NEG_Q_INV_MOD_P, Q_INV_MOD_P
from .layout import bound_width, num_witness

NUM_U32 = 5
SCHOOLBOOK_U32 = 8


def _take(widths) -> tuple[dict, int]:
    """Consecutive slot ranges (numpy int64) for (name, count) pairs, and
    the total width."""
    idx = {}
    base = 0
    for name, count in widths:
        idx[name] = np.arange(base, base + count, dtype=np.int64)
        base += count
    return idx, base


def _split_modq(idx: dict, names, n: int) -> None:
    """Within each (n, 29) mod_q block: slot 0 = t, 1 = b, 2.. = tail."""
    for name in names:
        block = idx[name].reshape(n, 29)
        idx[name + "_t"] = np.ascontiguousarray(block[:, 0])
        idx[name + "_b"] = np.ascontiguousarray(block[:, 1])
        idx[name + "_tail"] = np.ascontiguousarray(block[:, 2:])


def _device_indices(idx: dict, device) -> dict:
    return {k: torch.from_numpy(v.reshape(-1)).to(device) for k, v in idx.items()}


@functools.lru_cache(maxsize=None)
def _ntt_layout_indices(n: int) -> dict:
    """Slot index arrays (numpy int64) for each segment of the
    verify-with-NTT layout, split like the engine's segments."""
    params = get_params(n)
    idx, W = _take([
        ("sig", n), ("v", n), ("range_v", 27 * n), ("sig_ntt", 29 * n),
        ("v_ntt", 29 * n), ("pointwise", 30 * n), ("norm", 18 * 2 * n),
        ("bound", bound_width(params)),
    ])
    assert W == num_witness(params)
    pw = idx["pointwise"].reshape(n, 30)
    idx["pointwise_vals"] = np.ascontiguousarray(pw[:, :3])
    idx["pointwise_tail"] = np.ascontiguousarray(pw[:, 3:])
    # feature-first, like the engine's norm segments (16|2, B, 2n)
    nb = idx["norm"].reshape(2 * n, 18)
    idx["norm_bits"] = np.ascontiguousarray(nb[:, :16].T)
    idx["norm_vals"] = np.ascontiguousarray(nb[:, 16:].T)
    _split_modq(idx, ("sig_ntt", "v_ntt"), n)
    return idx


def _limbs16_to_u32(t_limbs):
    """(11, B, n) 16-bit limbs -> (5, B, n) int32 32-bit limbs (value
    < 2^160, so a 6th u32 limb would always be zero).  The high half of
    a pair may set the sign bit: the int32 holds the u32 bit pattern."""
    pairs = [t_limbs[2 * k] + (t_limbs[2 * k + 1] << 16) for k in range(NUM_U32)]
    return torch.stack(pairs)


@functools.lru_cache(maxsize=None)
def packer_ntt(n: int, device):
    """Device packer for one parameter set and device: engine segment dict
    -> (B, W, 5) int32."""
    W = num_witness(get_params(n))
    idx = _device_indices(_ntt_layout_indices(n), device)

    def pack(seg):
        B = seg["sig"].shape[0]
        out = torch.zeros((B, W, NUM_U32), dtype=torch.int32, device=device)
        plane0 = out[:, :, 0]

        def put(name, vals):
            plane0[:, idx[name]] = vals.reshape(B, -1).to(torch.int32)

        sig_t32 = _limbs16_to_u32(seg["sig_ntt_t"])
        v_t32 = _limbs16_to_u32(seg["v_ntt_t"])
        put("sig", seg["sig"])
        put("v", seg["v"])
        put("range_v", seg["range_v"])
        put("sig_ntt_t", sig_t32[0])
        put("sig_ntt_b", seg["sig_ntt_b"])
        put("sig_ntt_tail", seg["sig_ntt_tail"])
        put("v_ntt_t", v_t32[0])
        put("v_ntt_b", seg["v_ntt_b"])
        put("v_ntt_tail", seg["v_ntt_tail"])
        put("pointwise_vals", seg["pointwise"])
        put("pointwise_tail", seg["pointwise_tail"])
        # feature-first (F, B, 2n) -> (B, F, 2n), matching the index order
        put("norm_bits", seg["norm_bits"].transpose(0, 1))
        put("norm_vals", seg["norm_vals"].transpose(0, 1))
        put("bound", seg["bound"])
        for k in range(1, NUM_U32):
            out[:, idx["sig_ntt_t"], k] = sig_t32[k]
            out[:, idx["v_ntt_t"], k] = v_t32[k]
        return out

    return pack


@functools.lru_cache(maxsize=None)
def _dual_layout_indices(n: int) -> tuple[dict, int]:
    """Slot index arrays of the dual-NTT layout, split like the engine's
    segments, and the witness width."""
    idx, W = _take([
        ("sig_pos", n), ("sig_neg", n), ("sig_orth", n), ("orth1", 2),
        ("v_pos", n), ("v_neg", n), ("v_orth", n), ("orth2", 2),
        ("sp", 29 * n), ("sn", 29 * n), ("vp", 29 * n), ("vn", 29 * n),
        ("pointwise", 60 * n), ("norm_sq", 4 * n),
        ("bound", bound_width(get_params(n))),
    ])
    _split_modq(idx, ("sp", "sn", "vp", "vn"), n)
    # pointwise: values feature-first (6, n) like the engine's (6, B, n)
    pwb = idx["pointwise"].reshape(n, 60)
    idx["pointwise_vals"] = np.ascontiguousarray(pwb[:, [0, 1, 2, 30, 31, 32]].T)
    idx["pointwise_tail_l"] = np.ascontiguousarray(pwb[:, 3:30])
    idx["pointwise_tail_r"] = np.ascontiguousarray(pwb[:, 33:60])
    return idx, W


@functools.lru_cache(maxsize=None)
def packer_dual(n: int, device):
    """Device packer for the dual-NTT circuit: engine segment dict ->
    (B, W, 5) int32.  The two is_zero pairs are constants on the valid
    path (is_neq bit 0, multiplier 1)."""
    idx_np, W = _dual_layout_indices(n)
    idx = _device_indices(idx_np, device)
    pair = torch.tensor([0, 1], dtype=torch.int32, device=device)

    def pack(seg):
        B = seg["sig_pos"].shape[0]
        out = torch.zeros((B, W, NUM_U32), dtype=torch.int32, device=device)
        plane0 = out[:, :, 0]

        def put(name, vals):
            plane0[:, idx[name]] = vals.reshape(B, -1).to(torch.int32)

        for k in ("sig_pos", "sig_neg", "sig_orth", "v_pos", "v_neg", "v_orth",
                  "pointwise_tail_l", "pointwise_tail_r", "norm_sq", "bound"):
            put(k, seg[k])
        put("orth1", pair.expand(B, 2))
        put("orth2", pair.expand(B, 2))
        # feature-first (6, B, n) -> (B, 6, n), matching the index order
        put("pointwise_vals", seg["pointwise_vals"].transpose(0, 1))
        t32 = {}
        for nm in ("sp", "sn", "vp", "vn"):
            t32[nm] = _limbs16_to_u32(seg[nm + "_t"])
            put(nm + "_t", t32[nm][0])
            put(nm + "_b", seg[nm + "_b"])
            put(nm + "_tail", seg[nm + "_tail"])
        for k in range(1, NUM_U32):
            for nm in ("sp", "sn", "vp", "vn"):
                out[:, idx[nm + "_t"], k] = t32[nm][k]
        return out

    return pack


@functools.lru_cache(maxsize=None)
def _schoolbook_layout_indices(n: int) -> tuple[dict, int]:
    """Slot index arrays of the schoolbook layout, split like the engine's
    segments, and the witness width."""
    idx, W = _take([
        ("sig", n), ("v_block", 28 * n), ("main", n * (n + 34)),
        ("norm", 36 * n), ("bound", bound_width(get_params(n))),
    ])
    main = idx["main"].reshape(n, n + 34)
    idx["tc"] = np.ascontiguousarray(main[:, :2])
    idx["prods"] = np.ascontiguousarray(main[:, 2 : n + 2])
    idx["c_tail"] = np.ascontiguousarray(main[:, n + 2 : n + 29])
    idx["iseq"] = np.ascontiguousarray(main[:, n + 29 :])
    idx["mult"] = np.ascontiguousarray(main[:, [n + 30, n + 32]])
    return idx, W


@functools.lru_cache(maxsize=None)
def packer_schoolbook(n: int, device):
    """Device packer for the schoolbook circuit: engine segment dict ->
    (B, W, 8) int32, the multiplier codes expanded to their field values'
    limbs on the device."""
    idx_np, W = _schoolbook_layout_indices(n)
    idx = _device_indices(idx_np, device)
    # (3, 8) u32 limbs of the multipliers 1, q^-1 and -q^-1 mod p, indexed
    # by the engine's code
    table = np.zeros((3, SCHOOLBOOK_U32), dtype=np.uint32)
    for code, v in enumerate((1, Q_INV_MOD_P, NEG_Q_INV_MOD_P)):
        for k in range(SCHOOLBOOK_U32):
            table[code, k] = v & 0xFFFFFFFF
            v >>= 32
    mult = torch.from_numpy(table.view(np.int32)).to(device)

    def pack(seg):
        B = seg["sig"].shape[0]
        out = torch.zeros((B, W, SCHOOLBOOK_U32), dtype=torch.int32, device=device)
        plane0 = out[:, :, 0]
        for k in ("sig", "v_block", "tc", "prods", "c_tail", "iseq", "norm", "bound"):
            plane0[:, idx[k]] = seg[k].reshape(B, -1).to(torch.int32)
        # (B, n, 2) codes -> (B, 2n, 8) limbs, overwriting the codes
        limbs = mult[seg["iseq"][:, :, [1, 3]].long()].reshape(B, -1, SCHOOLBOOK_U32)
        for k in range(SCHOOLBOOK_U32):
            out[:, idx["mult"], k] = limbs[:, :, k]
        return out

    return pack
