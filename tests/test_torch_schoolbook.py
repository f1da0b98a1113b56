"""The port's schoolbook path against the JAX package and the host trace,
bit for bit.

Inputs are Falcon instances or uniform coefficients made from a numpy
seed.  The JAX engine runs on the CPU through its plain XLA path (and K3
itself in interpret mode); the port runs on CPU tensors through its plain
kernel versions.  Everything is integer arithmetic: tolerance 0.  The K3
kernel is held against its plain version on a CUDA card in
test_torch_cuda.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import falcon_r1cs_tpu.ops.pallas_schoolbook as psb
from falcon_r1cs_tpu import ConstraintSystem, FalconSchoolBookVerificationCircuit
from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem as JaxResidueSystem
from falcon_r1cs_tpu.params import get_params as jax_params
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu.witness import export_device as jax_export
from falcon_r1cs_tpu.witness.engine_schoolbook import (
    generate_witness_schoolbook as jax_generate,
)
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q, compile_circuit
from falcon_r1cs_tpu_torch import FalconSchoolBookVerificationCircuit as PortSchoolBookCircuit
from falcon_r1cs_tpu_torch.falcon import make_instance
from falcon_r1cs_tpu_torch.ops.schoolbook import schoolbook_prods, schoolbook_prods_cuda
from falcon_r1cs_tpu_torch.parallel import ResidueSystem
from falcon_r1cs_tpu_torch.witness import (
    interleave_witness_schoolbook,
    packer_schoolbook,
    witness_engine_schoolbook,
)
from falcon_r1cs_tpu_torch.witness.export_device import _schoolbook_layout_indices


def _inputs(params, count, seed):
    rng = np.random.default_rng(seed)
    insts = [make_instance(rng, params) for _ in range(count)]
    sig = np.stack([i.sig_lifted for i in insts]).astype(np.int32)
    pk = np.stack([i.h for i in insts]).astype(np.int32)
    hm = np.stack([i.hm for i in insts]).astype(np.int32)
    return insts, (sig, pk, hm)


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_engine(params):
    jp = jax_params(params.n)
    return jax.jit(lambda s, p, h: jax_generate(s, p, h, jp, use_pallas=False))


def _eq(want, got):
    j = np.array(want)
    t = got.numpy()
    assert (t.dtype, t.shape) == (j.dtype, j.shape)
    assert np.array_equal(t, j)


@pytest.fixture()
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k)
    )
    psb._build.cache_clear()
    yield
    psb._build.cache_clear()


def test_plain_prods_match_pallas_interpret(interpret_mode):
    """K3's plain version against the Pallas kernel itself, in interpret
    mode, n=512, B=2, with coefficients 0 and q-1 on both inputs."""
    n = 512
    rng = np.random.default_rng(21)
    sig = rng.integers(0, Q, size=(2, n)).astype(np.int32)
    pk = rng.integers(0, Q, size=(2, n)).astype(np.int32)
    sig[0, :3] = [0, Q - 1, Q - 1]
    pk[0, :2] = [Q - 1, 0]
    pk[1, -2:] = [0, Q - 1]
    want = psb.schoolbook_prods_pallas(sig, pk, n)
    got = schoolbook_prods(*_torch((sig, pk)), n)
    for w, g in zip(want, got):
        _eq(w, g)


def test_prods_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the plain version reads buf[n-1-i+j] as pk[i-j] for j <= i
    and q - pk[n+i-j] otherwise."""
    n = 512
    rng = np.random.default_rng(22)
    sig, pk = _torch(rng.integers(0, Q, size=(2, 2, n)).astype(np.int32))
    before = schoolbook_prods_cuda.launches
    prods, H, L = schoolbook_prods_cuda(sig, pk, n)
    assert schoolbook_prods_cuda.launches == before
    for w, g in zip(schoolbook_prods(sig, pk, n), (prods, H, L)):
        assert torch.equal(w, g)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pk_np = pk.numpy().astype(np.int64)
    col = np.where(j <= i, pk_np[:, i - j], Q - pk_np[:, (n + i - j) % n])
    direct = sig.numpy()[:, None, :].astype(np.int64) * col
    assert np.array_equal(prods.numpy(), direct)
    sums = direct.sum(axis=-1)
    assert np.array_equal(H.numpy().astype(np.int64) * 65536 + L.numpy(), sums)
    assert (L.numpy() < 65536).all()


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_engine_segments_match_jax(params):
    """Every segment: same keys, dtypes, shapes and values as the JAX
    engine (use_pallas=False), B=2."""
    _, arrays = _inputs(params, 2, seed=23)
    want = _jax_engine(params)(*arrays)
    got = witness_engine_schoolbook(params.n)(*_torch(arrays))
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(want[k], got[k])


def test_interleave_matches_host_trace():
    """The port's engine, interleaved, equals cs.witness_values (n=512)."""
    params = FALCON_512
    insts, arrays = _inputs(params, 2, seed=24)
    seg = witness_engine_schoolbook(params.n)(*_torch(arrays))
    mat = interleave_witness_schoolbook(seg, params)
    for b, inst in enumerate(insts):
        cs = ConstraintSystem()
        FalconSchoolBookVerificationCircuit.build_circuit(inst).generate_constraints(cs)
        assert mat.shape[1] == cs.num_witness_variables
        assert [int(x) for x in mat[b]] == cs.witness_values


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_packer_matches_jax(params):
    """packer_schoolbook on the JAX engine's segments equals the JAX
    packer, and the port's engine + packer give the same export."""
    _, arrays = _inputs(params, 2, seed=25)
    seg_j = _jax_engine(params)(*arrays)
    want = np.array(jax_export.packer_schoolbook(params.n)(seg_j))
    pack = packer_schoolbook(params.n, torch.device("cpu"))
    got = pack({k: torch.from_numpy(np.array(v)) for k, v in seg_j.items()})
    assert want.shape[1:] == (_schoolbook_layout_indices(params.n)[1], 8)
    _eq(want, got)
    seg_p = witness_engine_schoolbook(params.n)(*_torch(arrays))
    assert np.array_equal(pack(seg_p).numpy(), want)


def test_valid_flag():
    """1 on in-range inputs, 0 when an out-of-range input would make the
    code-expanded is_eq multipliers diverge from the host trace; the same
    flags as the JAX engine."""
    n = 512
    rng = np.random.default_rng(26)
    sig, pk, hm = rng.integers(0, Q, (3, 2, n)).astype(np.int32)
    engine = witness_engine_schoolbook(n)
    out = engine(*_torch((sig, pk, hm)))
    assert out["valid"].tolist() == [1, 1]
    bad_hm = hm.copy()
    bad_hm[1, 0] = 5 * Q + 3  # diff becomes 5q: not encodable
    out2 = engine(*_torch((sig, pk, bad_hm)))
    assert out2["valid"].tolist() == [1, 0]
    _eq(_jax_engine(FALCON_512)(sig, pk, bad_hm)["valid"], out2["valid"])


def test_is_satisfied_matches_jax():
    """ResidueSystem.is_satisfied on the host assignment of schoolbook-512:
    the JAX verdict, True; False after corrupting a witness in an integer
    row (a mul wire) and, separately, an is_eq multiplier, which only a
    field row checks."""
    params = FALCON_512
    insts, arrays = _inputs(params, 1, seed=27)
    cs = ConstraintSystem()
    FalconSchoolBookVerificationCircuit.build_circuit(insts[0]).generate_constraints(cs)
    comp = compile_circuit(PortSchoolBookCircuit, insts[0], cache=False)
    assert len(comp.field_rows) == 2 * params.n
    rs = ResidueSystem(comp, "cpu")
    jrs = JaxResidueSystem(
        jax_compile_circuit(FalconSchoolBookVerificationCircuit, insts[0], cache=False)
    )

    good = np.asarray(cs.full_assignment(), dtype=object)
    n, I = params.n, comp.num_instance
    main0 = I + n + 28 * n  # column 0's block [t, c | n prods | 27 | 5]
    # the multiplier of column 0's unequal is_eq (the equal one's is free)
    neq1 = int(witness_engine_schoolbook(n)(*_torch(arrays))["iseq"][0, 0, 0])
    mult = main0 + n + (30 if neq1 else 32)
    assert good[mult] != 1
    bad_int = good.copy()
    bad_int[main0 + 2] += 1  # column 0's first mul wire
    bad_field = good.copy()
    bad_field[mult] += 1
    batch = np.stack([good, bad_int, bad_field])
    # the multiplier sits in field rows only: the CRT check alone passes it
    assert rs.check_device(rs.witness_residues(batch)).tolist() == [True, False, True]
    assert rs.check_field_rows_host(good) and not rs.check_field_rows_host(bad_field)
    got = rs.is_satisfied(batch)
    assert got.tolist() == [True, False, False]
    assert np.array_equal(got, jrs.is_satisfied(batch))
    assert np.array_equal(
        rs.witness_residues(batch).numpy(), jrs.witness_residues(batch)
    )
