"""Device-side canonical witness export: (B, num_witness, 5) int32 holding
the little-endian 32-bit limbs of every witness value.

The counterpart of `packer_ntt` in `falcon_r1cs_tpu/witness/export_device.py`.
Precomputed slot indices place each engine segment into its canonical
positions by index assignment on the device; only the NTT quotient hints
(< 2^147) occupy limbs 1..4, everything else fits limb 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from falcon_r1cs_tpu.params import get_params

from .layout import bound_width, num_witness

NUM_U32 = 5


@functools.lru_cache(maxsize=None)
def _ntt_layout_indices(n: int) -> dict:
    """Slot index arrays (numpy int64) for each segment of the
    verify-with-NTT layout, split like the engine's segments."""
    params = get_params(n)
    idx = {}
    base = 0
    for name, count in (
        ("sig", n), ("v", n), ("range_v", 27 * n), ("sig_ntt", 29 * n),
        ("v_ntt", 29 * n), ("pointwise", 30 * n), ("norm", 18 * 2 * n),
        ("bound", bound_width(params)),
    ):
        idx[name] = np.arange(base, base + count, dtype=np.int64)
        base += count
    assert base == num_witness(params)
    pw = idx["pointwise"].reshape(n, 30)
    idx["pointwise_vals"] = np.ascontiguousarray(pw[:, :3])
    idx["pointwise_tail"] = np.ascontiguousarray(pw[:, 3:])
    # feature-first, like the engine's norm segments (16|2, B, 2n)
    nb = idx["norm"].reshape(2 * n, 18)
    idx["norm_bits"] = np.ascontiguousarray(nb[:, :16].T)
    idx["norm_vals"] = np.ascontiguousarray(nb[:, 16:].T)
    # within each (n, 29) mod_q block: slot 0 = t, slot 1 = b, 2.. = tail
    for name in ("sig_ntt", "v_ntt"):
        block = idx[name].reshape(n, 29)
        idx[name + "_t"] = np.ascontiguousarray(block[:, 0])
        idx[name + "_b"] = np.ascontiguousarray(block[:, 1])
        idx[name + "_tail"] = np.ascontiguousarray(block[:, 2:])
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
    idx = {
        k: torch.from_numpy(v.reshape(-1)).to(device)
        for k, v in _ntt_layout_indices(n).items()
    }

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
