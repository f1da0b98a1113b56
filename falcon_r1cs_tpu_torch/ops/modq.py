"""Division-free mod-q arithmetic on int32 tensors.

The counterpart of `falcon_r1cs_tpu/ops/modq.py`.  For 0 <= x < 2^30 an
f32 reciprocal multiply gives the quotient within +-1 (f32 ulp at 2^30 is
2^6, so the error is < (2^6 + q/2)/q < 1), fixed up with two predicated
corrections: exact for every input in range.  The reciprocal is an explicit
float32 tensor so the product is taken in float32 on every device.
"""

from __future__ import annotations

import torch

from ..params import Q

_INV_Q_F32 = torch.tensor(1.0 / Q, dtype=torch.float32)


def divmod_q(x):
    """(x // q, x % q) for int32 0 <= x < 2^30, division-free and exact."""
    t = torch.floor(x.to(torch.float32) * _INV_Q_F32).to(torch.int32)
    r = x - t * Q
    over = (r >= Q).to(torch.int32)
    t = t + over
    r = r - over * Q
    under = (r < 0).to(torch.int32)
    t = t - under
    r = r + under * Q
    return t, r


def mod_q(x):
    """x % q for int32 0 <= x < 2^30."""
    return divmod_q(x)[1]


def mul_mod_q(a, b):
    """a*b % q for 0 <= a, b < q (product < 2^28)."""
    return mod_q(a * b)


def add_mod_q(a, b):
    """(a + b) % q for 0 <= a, b < q: one predicated subtract."""
    s = a + b
    return torch.where(s >= Q, s - Q, s)


def sub_mod_q(a, b):
    """(a - b) % q for 0 <= a, b < q: one predicated add."""
    d = a - b
    return torch.where(d < 0, d + Q, d)
