"""The port's witness engine, layout and packer against the JAX package
and the host trace, bit for bit.

Inputs are Falcon instances made from a numpy seed; the JAX engine runs
on the CPU through its plain XLA path, the port on CPU tensors through
its plain kernel versions.
"""

import numpy as np
import pytest
import torch

import falcon_r1cs_tpu_torch as port
from falcon_r1cs_tpu import ConstraintSystem, FalconNTTVerificationCircuit
from falcon_r1cs_tpu.witness import export_device as jax_export
from falcon_r1cs_tpu.witness.engine import jitted_engine
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024
from falcon_r1cs_tpu_torch.falcon import make_instance, ntt
from falcon_r1cs_tpu_torch.witness import (
    circuit_witness,
    export_device,
    interleave_witness,
    num_witness,
    packer_ntt,
    witness_engine,
)


def _inputs(params, count, seed):
    rng = np.random.default_rng(seed)
    insts = [make_instance(rng, params) for _ in range(count)]
    sig = np.stack([i.sig_lifted for i in insts]).astype(np.int32)
    pk_ntt = np.stack([ntt(i.h) for i in insts]).astype(np.int32)
    hm_ntt = np.stack([ntt(i.hm) for i in insts]).astype(np.int32)
    return insts, (sig, pk_ntt, hm_ntt)


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _unpack(packed):
    packed = np.asarray(packed).astype(np.int64) & 0xFFFFFFFF
    vals = np.zeros(packed.shape[:2], dtype=object)
    for k in range(packed.shape[2] - 1, -1, -1):
        vals = (vals << 32) + packed[:, :, k]
    return vals


@pytest.mark.parametrize(
    "params,fused_intt",
    [(FALCON_512, False), (FALCON_512, True), (FALCON_1024, False)],
)
def test_engine_segments_match_jax(params, fused_intt):
    """Every segment: same keys, dtypes, shapes and values as the JAX
    engine, B=2."""
    _, arrays = _inputs(params, 2, seed=11)
    want = jitted_engine(params.n)(*arrays)
    got = witness_engine(params.n, fused_intt)(*_torch(arrays))
    assert sorted(got) == sorted(want)
    for k in want:
        j = np.array(want[k])
        t = got[k].numpy()
        assert (t.dtype, t.shape) == (j.dtype, j.shape), k
        assert np.array_equal(t, j), k


def test_interleave_matches_host_trace():
    """The port's engine, interleaved, equals cs.witness_values (n=512)."""
    params = FALCON_512
    insts, arrays = _inputs(params, 2, seed=12)
    seg = witness_engine(params.n)(*_torch(arrays))
    mat = interleave_witness(seg, params)
    assert mat.shape == (2, num_witness(params))
    for b, inst in enumerate(insts):
        cs = ConstraintSystem()
        FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
        assert [int(x) for x in mat[b]] == cs.witness_values


@pytest.mark.parametrize("n", [512, 1024])
def test_packer_index_tables_match_jax(n):
    want = jax_export._ntt_layout_indices(n)
    got = export_device._ntt_layout_indices(n)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_packer_matches_jax(params):
    """packer_ntt on the JAX engine's segments equals the JAX packer, and
    the port's engine + packer give the same packed export."""
    _, arrays = _inputs(params, 2, seed=13)
    seg_j = jitted_engine(params.n)(*arrays)
    want = np.array(jax_export.packer_ntt(params.n)(seg_j))
    pack = packer_ntt(params.n, torch.device("cpu"))
    got = pack({k: torch.from_numpy(np.array(v)) for k, v in seg_j.items()})
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    seg_p = witness_engine(params.n)(*_torch(arrays))
    assert np.array_equal(pack(seg_p).numpy(), want)


def test_circuit_witness_api():
    """All three circuits give working machinery: engine, packer and
    interleaver agree on one signature, with 5/5/8 export limbs."""
    params = FALCON_512
    inst, (sig, pk_ntt, hm_ntt) = _inputs(params, 1, seed=14)
    inputs = {
        port.FalconNTTVerificationCircuit: (sig, pk_ntt, hm_ntt),
        port.FalconDualNTTVerificationCircuit: (
            inst[0].sig_signed[None].astype(np.int32), pk_ntt, hm_ntt,
        ),
        port.FalconSchoolBookVerificationCircuit: (
            sig, inst[0].h[None].astype(np.int32), inst[0].hm[None].astype(np.int32),
        ),
    }
    limbs = {}
    for cls, arrays in inputs.items():
        cw = circuit_witness(cls, 512, "cpu")
        seg = cw.engine(*_torch(arrays))
        packed = cw.pack(seg)
        assert packed.shape[2] == cw.export_limbs
        assert (_unpack(packed) == cw.interleave(seg)).all(), cls.__name__
        limbs[cls] = cw.export_limbs
    assert list(limbs.values()) == [5, 5, 8]
    with pytest.raises(TypeError):
        circuit_witness(int, 512, "cpu")
