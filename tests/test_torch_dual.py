"""The port's dual-NTT path against the JAX package and the host trace,
bit for bit.

Inputs are Falcon instances made from a numpy seed.  The JAX engine runs
on the CPU through its plain XLA path; the port runs on CPU tensors
through the plain version of the hint kernel K1.  Everything is integer
arithmetic: tolerance 0.
"""

import jax
import numpy as np
import pytest
import torch

import falcon_r1cs_tpu_torch.witness.engine_dual as engine_dual
from falcon_r1cs_tpu import ConstraintSystem, FalconDualNTTVerificationCircuit
from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem as JaxResidueSystem
from falcon_r1cs_tpu.params import get_params as jax_params
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu.witness import export_device as jax_export
from falcon_r1cs_tpu.witness.engine_dual import generate_witness_dual as jax_generate
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, compile_circuit
from falcon_r1cs_tpu_torch import FalconDualNTTVerificationCircuit as PortDualCircuit
from falcon_r1cs_tpu_torch.falcon import make_instance, ntt
from falcon_r1cs_tpu_torch.parallel import ResidueSystem
from falcon_r1cs_tpu_torch.witness import (
    interleave_witness_dual,
    packer_dual,
    witness_engine_dual,
)


def _inputs(params, count, seed):
    rng = np.random.default_rng(seed)
    insts = [make_instance(rng, params) for _ in range(count)]
    sig = np.stack([i.sig_signed for i in insts]).astype(np.int32)
    pk_ntt = np.stack([ntt(i.h) for i in insts]).astype(np.int32)
    hm_ntt = np.stack([ntt(i.hm) for i in insts]).astype(np.int32)
    return insts, (sig, pk_ntt, hm_ntt)


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_engine(params):
    jp = jax_params(params.n)
    return jax.jit(lambda s, p, h: jax_generate(s, p, h, jp, use_pallas=False))


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_engine_segments_match_jax(params):
    """Every segment: same keys, dtypes, shapes and values as the JAX
    engine, B=2."""
    _, arrays = _inputs(params, 2, seed=31)
    want = _jax_engine(params)(*arrays)
    got = witness_engine_dual(params.n)(*_torch(arrays))
    assert sorted(got) == sorted(want)
    for k in want:
        j = np.array(want[k])
        t = got[k].numpy()
        assert (t.dtype, t.shape) == (j.dtype, j.shape), k
        assert np.array_equal(t, j), k


def test_engine_runs_four_hint_ntts(monkeypatch):
    """The engine goes through the hint-NTT dispatch (K1 on a card) four
    times per call: sig_pos, sig_neg, v_pos, v_neg."""
    calls = []
    orig = engine_dual.ntt_hints

    def counting(x, params):
        calls.append(tuple(x.shape))
        return orig(x, params)

    monkeypatch.setattr(engine_dual, "ntt_hints", counting)
    _, arrays = _inputs(FALCON_512, 2, seed=32)
    witness_engine_dual(512)(*_torch(arrays))
    assert calls == [(2, 512)] * 4


def test_interleave_matches_host_trace():
    """The port's engine, interleaved, equals cs.witness_values (n=512)."""
    params = FALCON_512
    insts, arrays = _inputs(params, 2, seed=33)
    seg = witness_engine_dual(params.n)(*_torch(arrays))
    mat = interleave_witness_dual(seg, params)
    for b, inst in enumerate(insts):
        cs = ConstraintSystem()
        FalconDualNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
        assert mat.shape[1] == cs.num_witness_variables
        assert [int(x) for x in mat[b]] == cs.witness_values


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_packer_matches_jax(params):
    """packer_dual on the JAX engine's segments equals the JAX packer, and
    the port's engine + packer give the same export."""
    _, arrays = _inputs(params, 2, seed=34)
    seg_j = _jax_engine(params)(*arrays)
    want = np.array(jax_export.packer_dual(params.n)(seg_j))
    pack = packer_dual(params.n, torch.device("cpu"))
    got = pack({k: torch.from_numpy(np.array(v)) for k, v in seg_j.items()})
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    seg_p = witness_engine_dual(params.n)(*_torch(arrays))
    assert np.array_equal(pack(seg_p).numpy(), want)


def test_is_satisfied_matches_jax():
    """ResidueSystem.is_satisfied on host assignments of dual-NTT-512, the
    same verdicts as the JAX one: True on the valid one; False after
    corrupting a witness in an integer row (a sig coefficient) and after
    corrupting the first is_zero bit, which its field row
    (sum of the orthogonality wires) * multiplier = bit also catches.
    The zero sum leaves that multiplier free: bumping it keeps True."""
    params = FALCON_512
    insts, _ = _inputs(params, 1, seed=35)
    cs = ConstraintSystem()
    FalconDualNTTVerificationCircuit.build_circuit(insts[0]).generate_constraints(cs)
    comp = compile_circuit(PortDualCircuit, insts[0], cache=False)
    assert len(comp.field_rows) == 2
    rs = ResidueSystem(comp, "cpu")
    jrs = JaxResidueSystem(
        jax_compile_circuit(FalconDualNTTVerificationCircuit, insts[0], cache=False)
    )

    good = np.asarray(cs.full_assignment(), dtype=object)
    n, I = params.n, comp.num_instance
    is_neq = I + 3 * n  # sig orthogonality's is_zero pair [bit, multiplier]
    assert (good[is_neq], good[is_neq + 1]) == (0, 1)
    batch = np.stack([good] * 4)
    batch[1, I + 3] += 1  # sig_pos[3]
    batch[2, is_neq] += 1
    batch[3, is_neq + 1] += 1
    assert rs.check_device(rs.witness_residues(batch)).tolist() == [True, False, False, True]
    field = [rs.check_field_rows_host(a) for a in batch]
    assert field == [True, True, False, True]
    assert field == [jrs.check_field_rows_host(list(a)) for a in batch]
    got = rs.is_satisfied(batch)
    assert got.tolist() == [True, False, False, True]
    assert np.array_equal(got, jrs.is_satisfied(batch))
    assert np.array_equal(
        rs.witness_residues(batch).numpy(), jrs.witness_residues(batch)
    )
