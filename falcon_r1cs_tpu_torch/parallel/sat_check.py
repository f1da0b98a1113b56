"""Device satisfiability checking, (A.w) o (B.w) - C.w == 0, on one device.

The counterpart of the single-device half of
`falcon_r1cs_tpu/parallel/sat_check.py`.  Every constraint row except the
tagged `field_rows` holds exactly over the signed integers with
|A.w| * |B.w| < 2^330, so satisfiability is checked by CRT over enough
15-bit primes m_k that prod m_k > 2^331:

    (A.w)(B.w) - C.w  ==  0  (mod m_k)

Per prime the sparse matvec is a gather of witness residues, a product
with the matrix residues reduced mod m, and an `index_add_` over the
constraint rows, all in int64 on the device and batched over signatures.

The tagged field rows (the is_zero / is_eq multiplier rows: none in the
verify-with-NTT circuit, 2 in the dual-NTT circuit, 2n in the schoolbook
circuit) hold only mod p.  `check_device` masks them out; they are
checked in exact host arithmetic by `check_field_rows_host`, and
`is_satisfied` gives the full verdict from both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..r1cs.coo import CompiledR1CS
from ..utils.config import RuntimeConfig


@functools.lru_cache(maxsize=None)
def crt_primes(count: int) -> tuple[int, ...]:
    """The `count` largest primes below 2^15, largest first."""
    primes = []
    x = (1 << 15) - 1
    while len(primes) < count and x > 2:
        for d in range(2, int(x**0.5) + 1):
            if x % d == 0:
                break
        else:
            primes.append(x)
        x -= 2
    return tuple(primes)


class ResidueSystem:
    """Residue form of a CompiledR1CS, resident on one device."""

    def __init__(
        self, compiled: CompiledR1CS, device,
        config: RuntimeConfig = RuntimeConfig(),
    ):
        self.compiled = compiled
        self.device = torch.device(device)
        self.primes = np.asarray(crt_primes(config.num_crt_primes), dtype=np.int64)

        def residues(which):
            signs, limbs = compiled.vals_limbs(which)
            return np.stack(
                [CompiledR1CS.limb_residues(signs, limbs, int(m)) for m in self.primes]
            ).astype(np.int32)

        def to_dev(x):
            return torch.from_numpy(np.asarray(x)).to(self.device)

        # per matrix: rows, cols (nnz,) int64 and residues (P, nnz) int32
        self.tables = {
            which: (
                to_dev(getattr(compiled, which)[0].astype(np.int64)),
                to_dev(getattr(compiled, which)[1].astype(np.int64)),
                to_dev(residues(which)),
            )
            for which in ("a", "b", "c")
        }
        mask = np.ones(compiled.num_constraints, dtype=bool)
        mask[compiled.field_rows] = False
        self.int_row_mask = to_dev(mask)

    def witness_residues(self, assignments) -> torch.Tensor:
        """(B, V) object ints (full assignments, instance first) -> (P, B, V)
        int32 residues on the device.  Field-sized values (the is_eq
        multipliers) reduce mod m from their mod-p representative, which
        is harmless: the field rows are masked out of the CRT check."""
        assignments = np.asarray(assignments, dtype=object)
        B, V = assignments.shape
        signs, limbs = CompiledR1CS.signed_to_limbs(assignments.reshape(-1))
        out = np.stack([
            CompiledR1CS.limb_residues(signs, limbs, int(m)).reshape(B, V)
            for m in self.primes
        ]).astype(np.int32)
        return torch.from_numpy(out).to(self.device)

    def witness_residues_from_packed(self, instance, packed) -> torch.Tensor:
        """(P, B, V) int32 residues from the device-packed witness
        (B, W, L) int32 u32 limbs and the (B, I) instance values."""
        packed = packed.to(self.device, torch.int64) & 0xFFFFFFFF
        instance = instance.to(self.device, torch.int64)
        B, W, L = packed.shape
        I = instance.shape[1]
        out = torch.empty(
            (len(self.primes), B, I + W), dtype=torch.int32, device=self.device
        )
        for k, m in enumerate(self.primes.tolist()):
            weights = torch.tensor(
                [pow(2, 32 * j, m) for j in range(L)],
                dtype=torch.int64, device=self.device,
            )
            out[k, :, :I] = instance % m
            out[k, :, I:] = ((packed % m) * weights).sum(dim=-1) % m
        return out

    def check_device(self, w_res) -> torch.Tensor:
        """The CRT check on the device.  w_res: (P, B, V) int32 residues.
        Returns (B,) bool: True = all integer rows satisfied."""
        nc = self.compiled.num_constraints
        w_res = w_res.to(self.device)
        B = w_res.shape[1]
        fails = torch.zeros(B, dtype=torch.bool, device=self.device)
        for k, m in enumerate(self.primes.tolist()):
            w = w_res[k].to(torch.int64)

            def matvec(rows, cols, vals):
                prod = (vals[k].to(torch.int64)[None, :] * w[:, cols]) % m
                acc = torch.zeros((B, nc), dtype=torch.int64, device=self.device)
                acc.index_add_(1, rows, prod)
                return acc % m

            aw = matvec(*self.tables["a"])
            bw = matvec(*self.tables["b"])
            cw = matvec(*self.tables["c"])
            bad = (aw * bw - cw) % m != 0
            fails |= (bad & self.int_row_mask[None, :]).any(dim=1)
        return ~fails

    @functools.cached_property
    def _field_entries(self) -> dict:
        """Per matrix, the COO entries (rows, cols, vals) that lie in a field
        row, picked once with numpy."""
        field = self.compiled.field_rows
        out = {}
        for which in ("a", "b", "c"):
            rows, cols, vals = getattr(self.compiled, which)
            sel = np.isin(rows, field)
            out[which] = (rows[sel].tolist(), cols[sel].tolist(), vals[sel].tolist())
        return out

    def check_field_rows_host(self, assignment) -> bool:
        """Exact mod-p evaluation of the tagged field rows for one full
        assignment (indexable by column: list or object array of ints)."""
        comp = self.compiled
        if not len(comp.field_rows):
            return True
        p = comp.p

        def row_vals(which):
            acc = dict.fromkeys(comp.field_rows.tolist(), 0)
            for r, c, v in zip(*self._field_entries[which]):
                acc[r] += int(v) * int(assignment[c])
            return acc

        a, b, c = row_vals("a"), row_vals("b"), row_vals("c")
        return all((a[r] % p) * (b[r] % p) % p == c[r] % p for r in a)

    def is_satisfied(self, assignments) -> np.ndarray:
        """The full batched verdict: the device CRT check of the integer
        rows, then the host check of the field rows for every signature
        that passed it.  assignments: (B, V) object ints.  Returns (B,)
        bool."""
        assignments = np.asarray(assignments, dtype=object)
        ok = self.check_device(self.witness_residues(assignments)).cpu().numpy()
        for b in np.flatnonzero(ok):
            ok[b] = self.check_field_rows_host(assignments[b])
        return ok
