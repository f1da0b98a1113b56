"""Compiled R1CS artifacts: COO matrices, signed-integer views, caching.

The trace phase is slow, host-side Python (like arkworks' setup-mode pass);
its product -- sparse (A, B, C) + layout metadata -- is a compile artifact
cached to disk keyed by circuit/parameter set (the checkpoint subsystem the
reference lacks, SURVEY.md section 5 "Checkpoint/resume").

Signed-value view: a coefficient c mod p is reinterpreted as the signed
integer c - p when c > p/2.  Every constraint of these circuits EXCEPT the
is_eq/is_neq multiplier rows (`ConstraintSystem.field_rows`) then holds
exactly over the integers -- e.g. a mod_q row a - t*q = b balances exactly
because the bound-tracking invariant keeps all values below 2^164 << p.
This is what lets the device satisfiability checker run in small-residue
CRT arithmetic (parallel/sat_check.py) instead of 255-bit field ops.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..params import FIELD_MODULUS
from .system import ConstraintSystem


def _signed(c: int, p: int) -> int:
    return c - p if c > p // 2 else c


@dataclass
class CompiledR1CS:
    """Frozen R1CS: COO triples with signed-integer values + metadata."""

    num_instance: int
    num_witness: int
    num_constraints: int
    field_rows: np.ndarray          # int32 sorted row indices (mod-p-only)
    # per matrix: (rows int32, cols int32, vals object[signed python ints])
    a: tuple
    b: tuple
    c: tuple
    p: int = FIELD_MODULUS

    @classmethod
    def from_cs(cls, cs: ConstraintSystem) -> "CompiledR1CS":
        mats = []
        for rows in (cs.a_rows, cs.b_rows, cs.c_rows):
            r, co, v = [], [], []
            for i, lc in enumerate(rows):
                for var, coeff in sorted(lc.items()):
                    r.append(i)
                    co.append(cs.global_col(var))
                    v.append(_signed(coeff, cs.p))
            mats.append(
                (
                    np.asarray(r, dtype=np.int32),
                    np.asarray(co, dtype=np.int32),
                    np.asarray(v, dtype=object),
                )
            )
        return cls(
            num_instance=cs.num_instance_variables,
            num_witness=cs.num_witness_variables,
            num_constraints=cs.num_constraints,
            field_rows=np.asarray(sorted(cs.field_rows), dtype=np.int32),
            a=mats[0],
            b=mats[1],
            c=mats[2],
            p=cs.p,
        )

    @property
    def num_variables(self) -> int:
        return self.num_instance + self.num_witness

    def vals_limbs(self, which: str):
        """Cached limb form of a matrix's values ('a'|'b'|'c'); persisted
        with the pickled artifact so the one-time Python big-int pass
        amortizes across processes."""
        cache = getattr(self, "_limb_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_limb_cache", cache)
        if which not in cache:
            cache[which] = self.signed_to_limbs(getattr(self, which)[2])
        return cache[which]

    @staticmethod
    def signed_to_limbs(vals, num_limbs: int = 8):
        """Object ints -> (signs int64, (nnz, num_limbs) int64 magnitude
        limbs base 2^32).  One Python pass; residue computation against
        many primes then vectorizes in numpy (see parallel/sat_check)."""
        n = len(vals)
        signs = np.empty(n, dtype=np.int64)
        limbs = np.zeros((n, num_limbs), dtype=np.int64)
        for i, v in enumerate(vals):
            v = int(v)
            signs[i] = -1 if v < 0 else 1
            v = abs(v)
            k = 0
            while v:
                limbs[i, k] = v & 0xFFFFFFFF
                v >>= 32
                k += 1
        return signs, limbs

    @staticmethod
    def limb_residues(signs, limbs, m: int):
        """(vals mod m) as int64 >= 0, vectorized: sum_k limb_k * (2^32k
        mod m) stays below 2^51 for 15-bit primes."""
        num_limbs = limbs.shape[1]
        weights = np.array(
            [pow(2, 32 * k, m) for k in range(num_limbs)], dtype=np.int64
        )
        acc = (limbs % m) @ weights % m
        return (signs * acc) % m

    def nnz(self) -> tuple[int, int, int]:
        return (len(self.a[0]), len(self.b[0]), len(self.c[0]))

    # -- exact host evaluation (reference oracle) --------------------------
    def eval_row(self, mat, i_mask, assignment) -> list:
        rows, cols, vals = mat
        out = [0] * self.num_constraints
        for r, c, v in zip(rows, cols, vals):
            out[r] += int(v) * assignment[c]
        return out

    def is_satisfied_host(self, assignment: list[int]) -> bool:
        """Exact mod-p check on host (the test oracle)."""
        a = self.eval_row(self.a, None, assignment)
        b = self.eval_row(self.b, None, assignment)
        c = self.eval_row(self.c, None, assignment)
        p = self.p
        return all(
            (ai % p) * (bi % p) % p == ci % p for ai, bi, ci in zip(a, b, c)
        )

    # -- disk cache --------------------------------------------------------
    def save(self, path: str | Path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load(cls, path: str | Path) -> "CompiledR1CS":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, cls):
            raise TypeError(f"{path} is not a CompiledR1CS artifact")
        return obj


def cache_dir() -> Path:
    """The port's own artifact directory (RuntimeConfig.artifact_cache,
    ~/.cache/falcon_r1cs_tpu_torch): the JAX package pickles its
    artifacts under the same keys as instances of its own class."""
    from ..utils.config import RuntimeConfig

    return Path(RuntimeConfig().artifact_cache)


def _direct_emitter(name: str):
    from .direct import (
        direct_compile_dual_ntt,
        direct_compile_schoolbook,
        direct_compile_verify_ntt,
    )

    return {
        "FalconNTTVerificationCircuit": direct_compile_verify_ntt,
        "FalconSchoolBookVerificationCircuit": direct_compile_schoolbook,
        "FalconDualNTTVerificationCircuit": direct_compile_dual_ntt,
    }.get(name)


def compile_circuit(
    circuit_cls, instance, cache: bool = True, use_direct: bool = True
) -> CompiledR1CS:
    """Compile a circuit to (cached) COO matrices.

    Cache key: circuit class + parameter set (the matrices depend only on
    the shape, mirroring setup-mode synthesis -- SURVEY.md section 3.2).
    Circuits with a direct structured emitter (r1cs/direct.py) skip the
    Python trace entirely (10-160x faster, bit-identical — enforced by
    tests/test_direct_synthesis.py); use_direct=False forces the trace.
    """
    key = f"{circuit_cls.__name__}_{instance.params.n}.r1cs"
    path = cache_dir() / key
    if cache and path.exists():
        return CompiledR1CS.load(path)
    emit = _direct_emitter(circuit_cls.__name__) if use_direct else None
    if emit is not None:
        compiled = emit(instance.params.n)
    else:
        cs = ConstraintSystem(mode="setup")
        circuit_cls.build_circuit(instance).generate_constraints(cs)
        compiled = CompiledR1CS.from_cs(cs)
    if cache:
        # populate the limb caches BEFORE persisting so the one-time
        # Python big-int pass really does amortize across processes
        for which in ("a", "b", "c"):
            compiled.vals_limbs(which)
        cache_dir().mkdir(parents=True, exist_ok=True)
        compiled.save(path)
    return compiled
