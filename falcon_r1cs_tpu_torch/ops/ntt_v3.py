"""The semi-carry limb NTT (K8) and the hint entry point over it.

The counterpart of `tools/pallas_ntt_v3.py`:

- `ntt_semi_cuda` launches `ntt_semi_kernel` (`csrc/ntt_v3.cu`, the port
  of the Pallas `kernel`) with its semi epilogue: (B, n) int32 in [0, q)
  -> the semi-normalised state (12, B, n), whose limbs each stage rounds
  with one parallel carry round, never a sequential chain.  Its plain
  version is `ntt_limb.ntt_semi`, bit for bit on inputs in [0, q): the
  kernel computes only the limbs `live_limbs` proves can be non-zero for
  such inputs, and neither wrapper checks the range.
- `ntt_with_hints_v3` is the port of `ntt_with_hints_pallas_v3`, which
  runs the kernel, then the exact normalisation and divmod by q as XLA
  ops outside it.  On a CUDA tensor it is one launch of the same kernel
  with its hints epilogue, which normalises and divides in registers; on
  a CPU tensor it is its plain version: `ntt_semi`, then
  `limbs.normalize` and `limbs.divmod_q`.  Either way it gives the same
  (t (11, B, n), b (B, n)) as the hint kernel K1, on inputs in [0, q).
  The tool's `block` argument, a TPU grid knob, has no counterpart.
- `live_limbs` is the interval bound behind the kernel's limb trim
  (`kLiveLimbs` in the source).

The wrappers check dtype, width and contiguity on every device, then take
the plain version for a CPU tensor, launch the kernel for a CUDA tensor
and raise for anything else; there is no fallback from a CUDA tensor to
the plain path.  `ntt_semi_cuda.launches` counts the kernel's launches,
of either epilogue.
"""

from __future__ import annotations

import torch

from ..params import Q, FalconParams
from . import _build
from .cuda_ntt import _check_layout, _semi_tables, _stage_tables
from .limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS, divmod_q, int_to_limbs, normalize
from .ntt_limb import SEMI_LIMBS, ntt_semi


def _launch(entry, x, params: FalconParams, *outs):
    """One launch of the kernel through the C entry `entry`."""
    tab = _semi_tables(params.n, x.device)
    _build.launch(
        entry, x.device,
        x.data_ptr(), tab["tw"].data_ptr(), tab["bounds"].data_ptr(),
        *(o.data_ptr() for o in outs), x.shape[0], params.log_n,
    )
    ntt_semi_cuda.launches += 1


def ntt_semi_cuda(x, params: FalconParams):
    """The semi state (SEMI_LIMBS, B, n) int32 of the bound-tracked NTT."""
    _check_layout(x, params, "ntt_semi_cuda")
    if x.device.type == "cpu":
        return ntt_semi_cuda.plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_semi_cuda: unsupported device {x.device}")
    batch, n = x.shape
    semi = torch.empty((SEMI_LIMBS, batch, n), dtype=torch.int32, device=x.device)
    if batch:
        _launch("ntt_semi_launch", x, params, semi)
    return semi


ntt_semi_cuda.launches = 0
ntt_semi_cuda.plain = ntt_semi


def ntt_with_hints_v3(x, params: FalconParams):
    """(t_limbs (11, B, n), b (B, n)) of the bound-tracked hint NTT, through
    the semi-carry kernel: one launch on a CUDA tensor."""
    _check_layout(x, params, "ntt_with_hints_v3")
    if x.device.type == "cpu":
        return ntt_with_hints_v3.plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_with_hints_v3: unsupported device {x.device}")
    batch, n = x.shape
    t = torch.empty((NUM_LIMBS, batch, n), dtype=torch.int32, device=x.device)
    b = torch.empty((batch, n), dtype=torch.int32, device=x.device)
    if batch:
        _launch("ntt_semi_hints_launch", x, params, t, b)
    return t, b


def _with_hints_plain(x, params: FalconParams):
    """The tool's glue after the kernel, in torch: normalise, divide by q."""
    t_limbs, b = divmod_q(normalize(ntt_semi(x, params)))
    return t_limbs[:NUM_LIMBS], b


ntt_with_hints_v3.plain = _with_hints_plain


# -- the limb trim -----------------------------------------------------------

_INT32 = (-(1 << 31), (1 << 31) - 1)


def _mask(iv):
    lo, hi = iv
    if lo >> LIMB_BITS == hi >> LIMB_BITS:
        return lo & LIMB_MASK, hi & LIMB_MASK
    return 0, LIMB_MASK


def _semi_round(x):
    """One parallel carry round over limb intervals: mask, then add the
    arithmetic shift of the limb below (the mask and the shift of one limb
    are taken as independent, which only widens the intervals)."""
    out = []
    for k, iv in enumerate(x):
        lo, hi = _mask(iv)
        if k:
            lo, hi = lo + (x[k - 1][0] >> LIMB_BITS), hi + (x[k - 1][1] >> LIMB_BITS)
        out.append((lo, hi))
    return out


def live_limbs(params: FalconParams) -> list[int]:
    """[W_l]: after stage l of `ntt_semi` only the low W_l limbs can be
    non-zero, for every input in [0, q).

    A sound over-approximation: every limb is tracked as an interval
    through the stage's three rounds (the multiply by the range of the
    stage's twiddles, the mask, the arithmetic shift, the adds and the
    subtract); the two outputs of a butterfly share one interval a limb;
    W_l is one above the highest limb whose interval is not {0}, never
    below W_{l-1}.  Raises if any interval leaves int32, where the
    analysis would no longer describe the kernel's wrapping arithmetic."""
    tw, _ = _stage_tables(params)
    state = [(0, Q - 1)] + [(0, 0)] * (SEMI_LIMBS - 1)
    live = [1]
    for l in range(params.log_n):
        s_lo, s_hi = int(tw[l].min()), int(tw[l].max())
        c = [int(v) for v in int_to_limbs(params.const_q_powers[l + 1], SEMI_LIMBS)]
        prod = [(min(lo * s_lo, lo * s_hi), max(hi * s_lo, hi * s_hi)) for lo, hi in state]
        v = _semi_round(prod)
        low = [(a[0] + b[0], a[1] + b[1]) for a, b in zip(state, v)]
        high = [(a[0] + ck - b[1], a[1] + ck - b[0]) for a, b, ck in zip(state, v, c)]
        lo_out, hi_out = _semi_round(low), _semi_round(high)
        for ivs in (prod, v, low, high, lo_out, hi_out):
            if any(lo < _INT32[0] or hi > _INT32[1] for lo, hi in ivs):
                raise OverflowError(f"stage {l}: a limb interval leaves int32")
        state = [(min(a[0], b[0]), max(a[1], b[1])) for a, b in zip(lo_out, hi_out)]
        top = max((k + 1 for k, iv in enumerate(state) if iv != (0, 0)), default=0)
        live.append(max(live[-1], top))
    return live[1:]
