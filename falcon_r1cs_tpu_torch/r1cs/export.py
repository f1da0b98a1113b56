"""Interchange export of (A, B, C, witness) for external SNARK provers.

The reference feeds its constraint system straight into ark-groth16
(`falcon-r1cs/examples/pok_sig.rs:30-32`); a SNARK prover
is out of scope for this framework's north star (SURVEY.md section 2.3,
ark-groth16 row), so the deliverable is a self-describing artifact an
external prover can consume:

  <name>.r1cs.npz:
    header: [num_instance, num_witness, num_constraints, limbs_per_value]
    field_modulus_limbs: little-endian u32 limbs of p
    {a,b,c}_rows, {a,b,c}_cols: int32 COO indices
    {a,b,c}_vals: (nnz, L) u32 little-endian limbs of the value mod p
    field_rows: int32 indices of mod-p-only rows

  <name>.wit.npz:
    instance: (B, num_instance, L) u32 limbs (incl. the leading one-wire)
    witness:  (B, num_witness, L) u32 limbs

Everything is numpy-native (no pickle), so any toolchain can load it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .coo import CompiledR1CS

EXPORT_LIMBS = 8  # full ~255-bit field values


def _int_to_u32(value: int, num_limbs: int = EXPORT_LIMBS) -> np.ndarray:
    out = np.zeros(num_limbs, dtype=np.uint32)
    for k in range(num_limbs):
        out[k] = value & 0xFFFFFFFF
        value >>= 32
    assert value == 0
    return out


def _ints_to_u32(vals, p: int, num_limbs: int = EXPORT_LIMBS) -> np.ndarray:
    out = np.zeros((len(vals), num_limbs), dtype=np.uint32)
    for i, v in enumerate(vals):
        out[i] = _int_to_u32(int(v) % p, num_limbs)
    return out


def export_r1cs(compiled: CompiledR1CS, path: str | Path) -> Path:
    """Write the constraint system as <path>.r1cs.npz."""
    path = Path(str(path) + ".r1cs.npz" if not str(path).endswith(".npz") else path)
    p = compiled.p
    data = {
        "header": np.asarray(
            [
                compiled.num_instance,
                compiled.num_witness,
                compiled.num_constraints,
                EXPORT_LIMBS,
            ],
            dtype=np.int64,
        ),
        "field_modulus_limbs": _int_to_u32(p),
        "field_rows": compiled.field_rows,
    }
    for name, mat in (("a", compiled.a), ("b", compiled.b), ("c", compiled.c)):
        rows, cols, vals = mat
        data[f"{name}_rows"] = rows
        data[f"{name}_cols"] = cols
        data[f"{name}_vals"] = _ints_to_u32(vals, p)
    np.savez_compressed(path, **data)
    return path


def load_r1cs_arrays(path: str | Path) -> dict:
    """Load an exported artifact back into plain numpy arrays + ints."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    return out


def export_witness(
    instance_limbs: np.ndarray, witness_limbs: np.ndarray, path: str | Path
) -> Path:
    """Write (B, I, L) instance + (B, W, L) witness u32 limbs."""
    path = Path(str(path) + ".wit.npz" if not str(path).endswith(".npz") else path)
    np.savez_compressed(
        path,
        instance=np.asarray(instance_limbs, dtype=np.uint32),
        witness=np.asarray(witness_limbs, dtype=np.uint32),
    )
    return path
