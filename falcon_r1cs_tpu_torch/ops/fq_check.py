"""The value contract of the Fq kernels K4, K5 and K6 (`csrc/fq_mont.cu`),
checked on the card: operands far from canonical, and the row-by-row
comparison of a kernel with its plain version by value, with an exact
host referee for the point adds.

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


def jacobian(p):
    """An affine point (X, Y, inf) lifted to (X, Y, one, inf), Z the
    canonical limbs of one; a Jacobian point (X, Y, Z, inf) as it is."""
    if len(p) == 4:
        return p
    X, Y, inf = p
    return (X, Y, fqm.consts(X.device)["one"][:, None].expand_as(X), inf)


def value_check(got, want, p1=None, p2=None) -> tuple[int, int]:
    """A kernel's value contract, row by row: each coordinate ((35, m)
    int32 limbs) congruent mod q to the plain version's, each flag ((m,)
    bool) equal.  got, want: tuples, (K4's product,) or a point add's
    coordinates and flag.  The reference is the plain version's output,
    except, for a point add of p1 and p2 (Jacobian, or affine and lifted
    by `jacobian`), on the rows where the two differ: there the exact host
    reference `fq.point_add_exact` decides (the plain version's
    f32-steered equality test can call equal points unequal).  Returns
    (the largest absolute difference between `fq_mont.canonical` of the
    kernel's coordinates and of the reference's, and between the flags as
    0/1, over all rows; the rows the exact reference decided)."""

    def canon(t):
        return t.clone() if t.dtype == torch.bool else fqm.canonical(t)

    ref = [canon(w) for w in want]
    mine = [canon(g) for g in got]
    m = got[0].shape[-1]
    diff = torch.zeros(m, dtype=torch.bool, device=got[0].device)
    for g, w in zip(mine, ref):
        diff |= (g != w).reshape(-1, m).any(dim=0)
    rows = torch.nonzero(diff).flatten()
    decided = 0
    if p1 is not None and len(rows):
        exact = fq.point_add_exact(*(tuple(c[..., rows] for c in jacobian(p)) for p in (p1, p2)))
        for r, e in zip(ref, exact):
            r[..., rows] = canon(e).to(r.device)
        decided = len(rows)
    err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
              for g, w in zip(mine, ref))
    return err, decided
