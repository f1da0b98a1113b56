"""Fixed-width big integers as 16-bit limbs in int32 tensors.

The counterpart of `falcon_r1cs_tpu/ops/limbs.py`.  The NTT gadget's
bound-tracking invariant caps every witness intermediate at
2^log_n * q^(log_n+1) < 2^164, so L = 11 limbs of 16 bits (176 bits) are
exact for both parameter sets.

Layout: the limb axis leads, (L, batch, n) int32, as in the JAX package.

Value representations:
  normalized: every limb in [0, 2^16)
  redundant:  int32 limbs, possibly negative, from butterfly add/sub;
              normalized before the next multiply so limb*s fits int32.
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
NUM_LIMBS = 11  # 176 bits >= 164-bit bound


# -- host converters --------------------------------------------------------

def int_to_limbs(value: int, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    out = np.empty(num_limbs, dtype=np.int32)
    for k in range(num_limbs):
        out[k] = value & LIMB_MASK
        value >>= LIMB_BITS
    if value:
        raise OverflowError("value does not fit in limbs")
    return out


def ints_to_limbs(values, num_limbs: int = NUM_LIMBS) -> np.ndarray:
    """(...,) python-int array -> (num_limbs, ...) int32."""
    arr = np.asarray(values, dtype=object)
    out = np.empty((num_limbs,) + arr.shape, dtype=np.int32)
    oflat = out.reshape(num_limbs, -1)
    for i, v in enumerate(arr.reshape(-1)):
        oflat[:, i] = int_to_limbs(int(v), num_limbs)
    return out


def limbs_to_ints(limbs) -> np.ndarray:
    """(num_limbs, ...) -> (...,) object array of python ints."""
    limbs = np.asarray(limbs)
    out = np.zeros(limbs.shape[1:], dtype=object)
    for k in range(limbs.shape[0] - 1, -1, -1):
        out = (out << LIMB_BITS) + limbs[k].astype(object)
    return out


# -- device ops -------------------------------------------------------------

def normalize(x):
    """Carry-propagate redundant int32 limbs to normalized [0, 2^16) limbs.

    Sequential over the leading limb axis; `>>` on int32 is arithmetic, so
    negative limbs are fine as long as the total value is nonnegative.
    """
    out = []
    carry = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        t = x[k] + carry
        out.append(t & LIMB_MASK)
        carry = t >> LIMB_BITS
    return torch.stack(out)


def from_small(values, num_limbs: int = NUM_LIMBS):
    """Embed int32 values < 2^16 as normalized limb tensors."""
    out = torch.zeros(
        (num_limbs,) + tuple(values.shape), dtype=values.dtype,
        device=values.device,
    )
    out[0] = values
    return out


def divmod_q(x):
    """(t, r) with x = t*q + r, 0 <= r < q, for normalized limbs x.

    Base-2^16 long division from the top limb: r < q < 2^14, so the running
    numerator r*2^16 + limb < 2^30 fits int32.  Returns t as (L, ...)
    normalized limbs and r as (...,) int32.
    """
    from .modq import divmod_q as _divmod_q_fast

    r = torch.zeros_like(x[0])
    t = []
    for k in range(x.shape[0] - 1, -1, -1):
        tk, r = _divmod_q_fast((r << LIMB_BITS) + x[k])
        t.append(tk)
    t.reverse()
    return torch.stack(t), r
