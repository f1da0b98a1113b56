"""Device satisfiability checking, (A.w) o (B.w) - C.w == 0.

The counterpart of `falcon_r1cs_tpu/parallel/sat_check.py`.  Every
constraint row except the tagged `field_rows` holds exactly over the
signed integers with |A.w| * |B.w| < 2^330, so satisfiability is checked
by CRT over enough 15-bit primes m_k that prod m_k > 2^331:

    (A.w)(B.w) - C.w  ==  0  (mod m_k)

Per prime the sparse matvec is a gather of witness residues, a product
with the matrix residues reduced mod m, and an `index_add_` over the
constraint rows, all in int64 on the device and batched over signatures.

The tagged field rows (the is_zero / is_eq multiplier rows: none in the
verify-with-NTT circuit, 2 in the dual-NTT circuit, 2n in the schoolbook
circuit) hold only mod p.  `check_device` masks them out; they are
checked in exact host arithmetic by `check_field_rows_host`, and
`is_satisfied` gives the full verdict from both.

`check_device_sharded` splits the constraint rows over the ranks of a mesh
dim (sat_check.py:178 of the JAX package): each rank checks its own rows
and the verdicts are combined with one all_reduce(MAX) of the fail flags.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

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


def row_partition(a_rows, nc: int, D: int) -> list[int]:
    """The D + 1 row bounds of a D-way split of the constraint rows: A's
    entries (rows sorted) cut into D equal nnz ranges, each cut moved to
    its entry's row so that a row's A, B and C entries stay together, the
    bounds made non-decreasing from row 0 to nc."""
    bounds = [0]
    for d in range(1, D):
        bounds.append(int(a_rows[len(a_rows) * d // D]) if len(a_rows) else nc * d // D)
    bounds.append(nc)
    for d in range(1, len(bounds)):
        bounds[d] = max(bounds[d], bounds[d - 1])
    return bounds


def shard_coo(rows, cols, res, bounds: list[int], nc: int):
    """A matrix's COO triples split by row bounds, (D, L) rows and cols and
    (D, P, L) residues, each rank's padded to the longest (at least 1) with
    entries on the sink row nc, column 0, residue 0."""
    D = len(bounds) - 1
    splits = [np.nonzero((rows >= bounds[d]) & (rows < bounds[d + 1]))[0]
              for d in range(D)]
    width = max(max(len(s) for s in splits), 1)
    r_out = np.full((D, width), nc, dtype=rows.dtype)
    c_out = np.zeros((D, width), dtype=cols.dtype)
    v_out = np.zeros((D, res.shape[0], width), dtype=res.dtype)
    for d, s in enumerate(splits):
        r_out[d, :len(s)] = rows[s]
        c_out[d, :len(s)] = cols[s]
        v_out[d, :, :len(s)] = res[:, s]
    return r_out, c_out, v_out


class ResidueSystem:
    """Residue form of a CompiledR1CS, on the host and on one device."""

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

        # per matrix, on the host: rows, cols (nnz,) int64 and residues
        # (P, nnz) int32; and the same tensors on the device
        self.host_tables = {
            which: (
                getattr(compiled, which)[0].astype(np.int64),
                getattr(compiled, which)[1].astype(np.int64),
                residues(which),
            )
            for which in ("a", "b", "c")
        }
        self.tables = {
            which: tuple(self._to_dev(x) for x in coo)
            for which, coo in self.host_tables.items()
        }
        mask = np.ones(compiled.num_constraints, dtype=bool)
        mask[compiled.field_rows] = False
        self.host_int_row_mask = mask
        self.int_row_mask = self._to_dev(mask)

    def _to_dev(self, x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

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

    def _fails(self, w_res, tables, mask) -> torch.Tensor:
        """(B,) bool: some row of `tables` (rows, cols, residues per matrix)
        with `mask` set fails mod some prime.  The rows index len(mask)."""
        nr = mask.shape[0]
        w_res = w_res.to(self.device)
        B = w_res.shape[1]
        fails = torch.zeros(B, dtype=torch.bool, device=self.device)
        for k, m in enumerate(self.primes.tolist()):
            w = w_res[k].to(torch.int64)

            def matvec(rows, cols, vals):
                prod = (vals[k].to(torch.int64)[None, :] * w[:, cols]) % m
                acc = torch.zeros((B, nr), dtype=torch.int64, device=self.device)
                acc.index_add_(1, rows, prod)
                return acc % m

            aw = matvec(*tables["a"])
            bw = matvec(*tables["b"])
            cw = matvec(*tables["c"])
            bad = (aw * bw - cw) % m != 0
            fails |= (bad & mask[None, :]).any(dim=1)
        return fails

    def check_device(self, w_res) -> torch.Tensor:
        """The CRT check on the device.  w_res: (P, B, V) int32 residues.
        Returns (B,) bool: True = all integer rows satisfied."""
        return ~self._fails(w_res, self.tables, self.int_row_mask)

    def check_device_sharded(self, w_res, mesh, axis: str = "batch") -> torch.Tensor:
        """The CRT check with the constraint rows split over the D ranks of
        the `axis` dim of `mesh` (every rank of the dim calls it with the
        same w_res, replicated: it is small beside the matrices).

        The rows split at `row_partition`'s bounds, so each constraint's A,
        B and C entries lie on one rank; `shard_coo` pads each rank's
        triples to one length with no-op entries on a sink row nc.  Each
        rank checks its rows as check_device does, and one all_reduce(MAX)
        of the fail flags over the dim gives every rank the verdict.
        Returns (B,) bool."""
        group = mesh.get_group(axis)
        D, d = dist.get_world_size(group), dist.get_rank(group)
        nc = self.compiled.num_constraints
        bounds = row_partition(self.host_tables["a"][0], nc, D)
        tables = {
            which: tuple(self._to_dev(x[d]) for x in shard_coo(*coo, bounds, nc))
            for which, coo in self.host_tables.items()
        }
        mask = self._to_dev(np.concatenate([self.host_int_row_mask, [False]]))
        fails = self._fails(w_res, tables, mask).to(torch.int32)
        dist.all_reduce(fails, op=dist.ReduceOp.MAX, group=group)
        return fails == 0

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
