"""Multi-scalar multiplication (host reference path).

The reference's ark-groth16 uses ark-ec's VariableBaseMSM/FixedBase
(Pippenger + windowed fixed-base); these are the same algorithms in pure
Python, generic over G1/G2 via the field-op tables in bls12_381.  The
native C backend (native/groth16_native.c) supersedes this for large
inputs; both are differentially tested against each other.

Points here are Jacobian tuples (or None for infinity); scalars are ints
mod R.
"""

from __future__ import annotations

from .bls12_381 import (
    R,
    _FQ2_OPS,
    _FQ_OPS,
    _add,
    _dbl,
    _from_affine,
    _to_affine,
)


def _msm_pippenger(ops, points, scalars, window_bits: int | None = None):
    """Sum_i scalars[i] * points[i] (Jacobian in, Jacobian out)."""
    n = len(points)
    assert n == len(scalars)
    if n == 0:
        return None
    scalars = [s % R for s in scalars]
    if window_bits is None:
        # classic Pippenger window heuristic
        window_bits = max(3, n.bit_length() - 4) if n > 32 else 3
    num_bits = R.bit_length()
    num_windows = (num_bits + window_bits - 1) // window_bits
    mask = (1 << window_bits) - 1
    window_sums = []
    for w in range(num_windows):
        shift = w * window_bits
        buckets = [None] * (1 << window_bits)
        for s, pt in zip(scalars, points):
            idx = (s >> shift) & mask
            if idx:
                buckets[idx] = _add(ops, buckets[idx], pt)
        # running-sum bucket reduction
        running = None
        acc = None
        for idx in range(len(buckets) - 1, 0, -1):
            running = _add(ops, running, buckets[idx])
            acc = _add(ops, acc, running)
        window_sums.append(acc)
    # combine windows from the top down
    total = None
    for acc in reversed(window_sums):
        if total is not None:
            for _ in range(window_bits):
                total = _dbl(ops, total)
        total = _add(ops, total, acc)
    return total


class FixedBaseTable:
    """Windowed table for many scalar-mults of one base (CRS generation).

    table[w][d] = d * 2^(w*window_bits) * base; a scalar-mult is then
    num_windows additions, amortizing the doublings across the batch.
    """

    def __init__(self, ops, base_jac, window_bits: int = 8):
        self.ops = ops
        self.window_bits = window_bits
        num_bits = R.bit_length()
        self.num_windows = (num_bits + window_bits - 1) // window_bits
        self.mask = (1 << window_bits) - 1
        self.table = []
        cur = base_jac
        for _ in range(self.num_windows):
            row = [None] * (1 << window_bits)
            for d in range(1, 1 << window_bits):
                row[d] = _add(ops, row[d - 1], cur)
            self.table.append(row)
            for _ in range(window_bits):
                cur = _dbl(ops, cur)

    def mul(self, scalar: int):
        scalar %= R
        acc = None
        for w in range(self.num_windows):
            idx = (scalar >> (w * self.window_bits)) & self.mask
            if idx:
                acc = _add(self.ops, acc, self.table[w][idx])
        return acc

    def mul_batch(self, scalars) -> list:
        return [self.mul(s) for s in scalars]


# --- public G1/G2 entry points -------------------------------------------


def g1_msm(points_jac, scalars):
    return _msm_pippenger(_FQ_OPS, points_jac, scalars)


def g2_msm(points_jac, scalars):
    return _msm_pippenger(_FQ2_OPS, points_jac, scalars)


def g1_fixed_base(base_affine) -> FixedBaseTable:
    return FixedBaseTable(_FQ_OPS, _from_affine(_FQ_OPS, base_affine))


def g2_fixed_base(base_affine) -> FixedBaseTable:
    return FixedBaseTable(_FQ2_OPS, _from_affine(_FQ2_OPS, base_affine))


def g1_normalize_batch(points_jac) -> list:
    """Jacobian -> affine for a batch (one inversion via batch trick)."""
    return _normalize_batch(_FQ_OPS, points_jac)


def g2_normalize_batch(points_jac) -> list:
    return _normalize_batch(_FQ2_OPS, points_jac)


def _normalize_batch(ops, points_jac) -> list:
    # batch-invert the Z coordinates (Montgomery trick over the group field)
    idxs = [i for i, pt in enumerate(points_jac) if pt is not None]
    zs = [points_jac[i][2] for i in idxs]
    n = len(zs)
    out = [None] * len(points_jac)
    if n == 0:
        return out
    prefix = [ops.one] * (n + 1)
    for i, z in enumerate(zs):
        prefix[i + 1] = ops.mul(prefix[i], z)
    inv_all = ops.inv(prefix[n])
    invs = [ops.zero] * n
    for i in range(n - 1, -1, -1):
        invs[i] = ops.mul(prefix[i], inv_all)
        inv_all = ops.mul(inv_all, zs[i])
    for k, i in enumerate(idxs):
        X, Y, _Z = points_jac[i]
        zi = invs[k]
        zi2 = ops.sqr(zi)
        out[i] = (ops.mul(X, zi2), ops.mul(ops.mul(Y, zi), zi2))
    return out
