"""The port's pipeline and CRT satisfiability check against the JAX
package, bit for bit: wire bytes -> packed witness, device residues and
verdicts, valid and corrupted, and chunked runs."""

import numpy as np
import pytest
import torch

import falcon_r1cs_tpu
from falcon_r1cs_tpu.parallel import sat_check as jax_sat
from falcon_r1cs_tpu.params import get_params as jax_params
from falcon_r1cs_tpu.pipeline import ProverInputPipeline as JaxPipeline
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu_torch import (
    FALCON_512,
    FALCON_1024,
    FalconNTTVerificationCircuit,
    ProverInputPipeline,
    ResidueSystem,
    RuntimeConfig,
    compile_circuit,
)
from falcon_r1cs_tpu_torch.falcon import compress_signature, encode_public_key, make_instance
from falcon_r1cs_tpu_torch.parallel.sat_check import crt_primes


def _wire(params, count, seed):
    rng = np.random.default_rng(seed)
    insts = [make_instance(rng, params) for _ in range(count)]
    pk_bytes = [encode_public_key(i.h, params) for i in insts]
    sig_bytes = [compress_signature(i.sig_signed, i.nonce, params) for i in insts]
    return insts, (pk_bytes, [i.msg for i in insts], sig_bytes)


@pytest.fixture(scope="module")
def wire_512():
    return _wire(FALCON_512, 5, seed=21)


@pytest.fixture(scope="module")
def out_2(wire_512):
    """The port's run_wire on the first two signatures, with the instance
    values [1 | pk_ntt | hm_ntt]."""
    _, wire = wire_512
    out = ProverInputPipeline(FALCON_512, "cpu").run_wire(*[w[:2] for w in wire])
    instance = torch.cat(
        [torch.ones((2, 1), dtype=torch.int64), out.pk_ntt.long(), out.hm_ntt.long()],
        dim=1,
    )
    return out, instance


@pytest.fixture(scope="module")
def residue_systems(wire_512):
    insts, _ = wire_512
    jax_compiled = jax_compile_circuit(
        falcon_r1cs_tpu.FalconNTTVerificationCircuit, insts[0], cache=False
    )
    compiled = compile_circuit(FalconNTTVerificationCircuit, insts[0], cache=False)
    return jax_sat.ResidueSystem(jax_compiled), ResidueSystem(compiled, "cpu")


def test_run_wire_matches_jax_pipeline(wire_512, out_2):
    _, wire = wire_512
    want = JaxPipeline(jax_params(512), pack=True).run_wire(*[w[:2] for w in wire])
    got, _ = out_2
    assert np.array_equal(got.packed.numpy(), np.array(want.packed))
    assert np.array_equal(got.pk_ntt.numpy(), np.array(want.pk_ntt))
    assert np.array_equal(got.hm_ntt.numpy(), np.array(want.hm_ntt))
    for k in want.seg:
        assert np.array_equal(got.seg[k].numpy(), np.array(want.seg[k])), k


@pytest.mark.parametrize("fused_intt", [False, True])
def test_run_wire_chunking_matches_single_pass(wire_512, fused_intt):
    _, wire = wire_512
    cfg = RuntimeConfig(fused_intt=fused_intt)
    a = ProverInputPipeline(FALCON_512, "cpu", max_chunk=2048, config=cfg).run_wire(*wire)
    b = ProverInputPipeline(FALCON_512, "cpu", max_chunk=2, config=cfg).run_wire(*wire)
    assert torch.equal(a.packed, b.packed)
    for k in a.seg:
        assert torch.equal(a.seg[k], b.seg[k]), k


def test_run_wire_rejects_mixed_params(wire_512):
    _, wire = wire_512
    with pytest.raises(ValueError):
        ProverInputPipeline(FALCON_1024, "cpu", pack=False).run_wire(*wire)


def test_crt_primes_match_jax():
    for count in (1, 24, 30):
        assert crt_primes(count) == jax_sat.crt_primes(count)


def test_residue_tables_match_jax(residue_systems):
    jrs, trs = residue_systems
    assert np.array_equal(trs.primes, jrs.primes)
    for which in ("a", "b", "c"):
        rows, cols, res = trs.tables[which]
        assert np.array_equal(rows.numpy(), getattr(jrs, which + "_rows"))
        assert np.array_equal(cols.numpy(), getattr(jrs, which + "_cols"))
        assert np.array_equal(res.numpy(), getattr(jrs, which + "_res"))
    assert np.array_equal(trs.int_row_mask.numpy(), jrs.int_row_mask)


def test_sat_verdicts_match_jax(out_2, residue_systems):
    """Device residues equal witness_residues_from_packed; verdicts equal
    JAX check_device, valid and with one witness of one signature bumped."""
    jrs, trs = residue_systems
    out, instance = out_2
    w_res = trs.witness_residues_from_packed(instance, out.packed)
    want = jrs.witness_residues_from_packed(instance.numpy(), out.packed.numpy())
    assert w_res.dtype == torch.int32
    assert np.array_equal(w_res.numpy(), want)
    assert trs.check_device(w_res).tolist() == [True, True]
    assert np.array(jrs.check_device(want)).tolist() == [True, True]

    bad = out.packed.clone()
    bad[1, 3, 0] += 1  # a sig coefficient of signature 1
    w_bad = trs.witness_residues_from_packed(instance, bad)
    assert trs.check_device(w_bad).tolist() == [True, False]
    assert np.array(jrs.check_device(w_bad.numpy())).tolist() == [True, False]


def test_sat_catches_random_corruptions(out_2, residue_systems):
    """Soundness sweep: a random delta at a random witness slot of one
    signature flips that signature's verdict, and only that one."""
    _, trs = residue_systems
    out, instance = out_2
    rng = np.random.default_rng(22)
    count = 12
    packed = out.packed[:1].repeat(count + 1, 1, 1)
    slots = rng.choice(packed.shape[1], size=count, replace=False)
    deltas = rng.integers(1, 1 << 20, size=count)
    for row, (slot, delta) in enumerate(zip(slots, deltas), start=1):
        packed[row, slot, 0] += int(delta)
    inst = instance[:1].repeat(count + 1, 1)
    verdict = trs.check_device(trs.witness_residues_from_packed(inst, packed))
    assert verdict.tolist() == [True] + [False] * count
