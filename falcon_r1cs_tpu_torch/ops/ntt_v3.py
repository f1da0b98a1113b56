"""The semi-carry limb NTT (K8) and the hint entry point over it.

The counterpart of `tools/pallas_ntt_v3.py`:

- `ntt_semi_cuda` launches `ntt_semi_kernel` (`csrc/ntt_v3.cu`, the port
  of the Pallas `kernel`): (B, n) int32 in [0, q) -> the semi-normalised
  state (12, B, n), whose limbs each stage rounds with one parallel carry
  round, never a sequential chain.  Its plain version is
  `ntt_limb.ntt_semi`, bit for bit.
- `ntt_with_hints_v3` is the port of `ntt_with_hints_pallas_v3`: the
  kernel, then the exact normalisation and divmod by q as torch ops
  outside it (XLA ops outside the Pallas kernel in the tool).  It gives
  the same (t (11, B, n), b (B, n)) as the hint kernel K1.  The tool's
  `block` argument, a TPU grid knob, has no counterpart.

The wrapper checks dtype, width and contiguity on every device, then takes
the plain version for a CPU tensor, launches the kernel for a CUDA tensor
and raises for anything else; there is no fallback from a CUDA tensor to
the plain path.  `.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..params import FalconParams
from . import _build
from .cuda_ntt import _check_layout, _semi_tables
from .limbs import NUM_LIMBS, divmod_q, normalize
from .ntt_limb import SEMI_LIMBS, ntt_semi


def ntt_semi_cuda(x, params: FalconParams):
    """The semi state (SEMI_LIMBS, B, n) int32 of the bound-tracked NTT."""
    _check_layout(x, params, "ntt_semi_cuda")
    if x.device.type == "cpu":
        return ntt_semi_cuda.plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_semi_cuda: unsupported device {x.device}")
    batch, n = x.shape
    semi = torch.empty((SEMI_LIMBS, batch, n), dtype=torch.int32, device=x.device)
    if batch == 0:
        return semi
    tab = _semi_tables(n, x.device)
    _build.launch(
        "ntt_semi_launch", x.device,
        x.data_ptr(), tab["tw"].data_ptr(), tab["bounds"].data_ptr(),
        semi.data_ptr(), batch, params.log_n,
    )
    ntt_semi_cuda.launches += 1
    return semi


ntt_semi_cuda.launches = 0
ntt_semi_cuda.plain = ntt_semi


def ntt_with_hints_v3(x, params: FalconParams):
    """(t_limbs (11, B, n), b (B, n)) of the bound-tracked hint NTT, through
    the semi-carry kernel."""
    t_limbs, b = divmod_q(normalize(ntt_semi_cuda(x, params)))
    return t_limbs[:NUM_LIMBS], b
