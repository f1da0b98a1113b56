"""K5's value contract, checked on the card: operands far from canonical,
and the row-by-row comparison of K5 (`point_add_kernel`, csrc/fq_mont.cu)
with its plain version by value, with an exact host referee.

Used by chip_smoke.py and tests/test_torch_cuda.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fq
from . import fq_mont as fqm


def far_reps(c, kind: str, seed: int):
    """Representatives of canonical limbs c (35, m) far from canonical:
    "wide" (limbs 0..32 at +-(2^12 + 2), a value of its own), "pos" and
    "neg" (c + (2^13 - 2) q and c - (2^13 - 1) q), "sub" (sub_mod(0, q -
    c): every limb <= 0)."""
    q = fqm.consts(c.device)["q"][:, None]
    k = (1 << 13) - 2
    if kind == "wide":
        w = np.random.default_rng(seed).choice([-(2**12 + 2), 2**12 + 2], size=c.shape)
        w[33] = -np.sign(w[32])
        w[34] = 0
        return torch.from_numpy(w.astype(np.int32)).to(c.device)
    if kind == "pos":
        return fqm.full_carry(c + k * q)
    if kind == "neg":
        return -fqm.full_carry((k + 1) * q - c)
    return fqm.sub_mod(torch.zeros_like(c), fqm.full_carry(q - c))


def value_check(got, want, p1, p2) -> tuple[int, int]:
    """K5's contract, row by row: coordinates congruent mod q to the plain
    version's, flags equal.  The reference is the plain version's output,
    except on the rows where the two differ: there the exact host
    reference `fq.point_add_exact` decides (the plain version's f32-steered
    equality test can call equal points unequal).  Returns (the largest
    absolute difference between `fq_mont.canonical` of K5's coordinates and
    of the reference's, and between the flags as 0/1, over all rows; the
    rows the exact reference decided)."""
    ref = [fqm.canonical(w) for w in want[:3]] + [want[3].clone()]
    canon = [fqm.canonical(g) for g in got[:3]] + [got[3]]
    diff = canon[3] != ref[3]
    for g, w in zip(canon[:3], ref[:3]):
        diff |= (g != w).any(dim=0)
    rows = torch.nonzero(diff).flatten()
    if len(rows):
        exact = fq.point_add_exact(tuple(c[..., rows] for c in p1),
                                   tuple(c[..., rows] for c in p2))
        for k in range(3):
            ref[k][:, rows] = fqm.canonical(exact[k]).to(ref[k].device)
        ref[3][rows] = exact[3].to(ref[3].device)
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(canon, ref))
    return err, len(rows)
