"""Limb-array containers for curve-point batches (CRS queries).

Numpy-native interchange form shared by the pure-Python path, the C
backend, and disk serialization: little-endian u64 limbs in STANDARD
(non-Montgomery) form — G1 affine = (n,6)+(n,6), G2 affine = (n,12)+(n,12)
with c0 limbs before c1 — plus a uint8 infinity-flag vector.
"""

from __future__ import annotations

import numpy as np

from .bls12_381 import P


def ints_to_limbs(vals, num_limbs: int) -> np.ndarray:
    """list[int] -> (n, num_limbs) u64 little-endian.

    Fast path: R1CS wire vectors are structurally small (bits, mod-q
    values, <2^28 quotient hints), so when every value fits one limb the
    whole conversion is a single numpy store instead of 396k bigint
    to_bytes calls (was ~20% of a warm falcon-512 prove)."""
    try:
        arr = np.asarray(vals, dtype=np.uint64)
    except (OverflowError, TypeError, ValueError):
        nbytes = num_limbs * 8
        blob = b"".join(int(v).to_bytes(nbytes, "little") for v in vals)
        return np.frombuffer(blob, dtype="<u8").reshape(
            len(vals), num_limbs).copy()
    out = np.zeros((len(vals), num_limbs), dtype=np.uint64)
    out[:, 0] = arr
    return out


def limbs_to_int(row: np.ndarray) -> int:
    return int.from_bytes(row.astype("<u8").tobytes(), "little")


def packed_to_limb_rows(packed: np.ndarray) -> np.ndarray:
    """(W, L) u32 canonical witness limbs (witness/export_device.py) ->
    (W, 4) u64 scalar rows for the prover — all-numpy, no Python ints.

    The export packer stores each wire as L little-endian 32-bit limbs:
    five for the verify-with-NTT and dual-NTT circuits (values < 2^160 <
    r), eight for the schoolbook circuit's field values; this folds them
    into the (N, 4) u64 form prove()/witness_map consume directly."""
    p = np.asarray(packed).view(np.uint32).astype(np.uint64)
    out = np.zeros((p.shape[0], 4), dtype=np.uint64)
    for k in range(p.shape[1]):
        out[:, k // 2] |= p[:, k] << np.uint64(32 * (k % 2))
    return out


class G1Array:
    """Batch of G1 affine points as limb arrays."""

    LIMBS = 6

    def __init__(self, xs: np.ndarray, ys: np.ndarray, inf: np.ndarray):
        self.xs = np.ascontiguousarray(xs, dtype=np.uint64)
        self.ys = np.ascontiguousarray(ys, dtype=np.uint64)
        self.inf = np.ascontiguousarray(inf, dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.inf)

    @classmethod
    def from_affine_list(cls, pts) -> "G1Array":
        n = len(pts)
        xs = np.zeros((n, cls.LIMBS), dtype=np.uint64)
        ys = np.zeros((n, cls.LIMBS), dtype=np.uint64)
        inf = np.zeros(n, dtype=np.uint8)
        fill_x, fill_y, idx = [], [], []
        for i, pt in enumerate(pts):
            if pt is None:
                inf[i] = 1
            else:
                idx.append(i)
                fill_x.append(pt[0] % P)
                fill_y.append(pt[1] % P)
        if idx:
            xs[idx] = ints_to_limbs(fill_x, cls.LIMBS)
            ys[idx] = ints_to_limbs(fill_y, cls.LIMBS)
        return cls(xs, ys, inf)

    def to_affine_list(self) -> list:
        out = []
        for i in range(len(self)):
            if self.inf[i]:
                out.append(None)
            else:
                out.append((limbs_to_int(self.xs[i]), limbs_to_int(self.ys[i])))
        return out

    def __getitem__(self, i: int):
        if self.inf[i]:
            return None
        return (limbs_to_int(self.xs[i]), limbs_to_int(self.ys[i]))


class G2Array:
    """Batch of G2 affine points (on the twist, Fq2 coords) as limb arrays.

    Each coordinate row is 12 limbs: c0 (6) then c1 (6).
    """

    LIMBS = 12

    def __init__(self, xs: np.ndarray, ys: np.ndarray, inf: np.ndarray):
        self.xs = np.ascontiguousarray(xs, dtype=np.uint64)
        self.ys = np.ascontiguousarray(ys, dtype=np.uint64)
        self.inf = np.ascontiguousarray(inf, dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.inf)

    @staticmethod
    def _pack_fq2(v) -> bytes:
        return int(v[0] % P).to_bytes(48, "little") + int(v[1] % P).to_bytes(
            48, "little"
        )

    @classmethod
    def from_affine_list(cls, pts) -> "G2Array":
        n = len(pts)
        xs = np.zeros((n, cls.LIMBS), dtype=np.uint64)
        ys = np.zeros((n, cls.LIMBS), dtype=np.uint64)
        inf = np.zeros(n, dtype=np.uint8)
        for i, pt in enumerate(pts):
            if pt is None:
                inf[i] = 1
            else:
                xs[i] = np.frombuffer(cls._pack_fq2(pt[0]), dtype="<u8")
                ys[i] = np.frombuffer(cls._pack_fq2(pt[1]), dtype="<u8")
        return cls(xs, ys, inf)

    def __getitem__(self, i: int):
        if self.inf[i]:
            return None
        x = (limbs_to_int(self.xs[i, :6]), limbs_to_int(self.xs[i, 6:]))
        y = (limbs_to_int(self.ys[i, :6]), limbs_to_int(self.ys[i, 6:]))
        return (x, y)

    def to_affine_list(self) -> list:
        return [self[i] for i in range(len(self))]
