"""The port's host copies of the signer, its spec and NIST KAT layers, the
constraint counters and the R1CS / witness exports against the JAX
package's, from the same seeds: equal keys, signatures, KAT bytes, counter
tables and exported arrays."""

import numpy as np
import pytest
import torch

import falcon_r1cs_tpu as jax_pkg
import falcon_r1cs_tpu_torch as port
from falcon_r1cs_tpu.falcon import KeyPair as JaxKeyPair
from falcon_r1cs_tpu.falcon import nist_kat as jax_kat
from falcon_r1cs_tpu.falcon.spec_sign import sign_dyn as jax_sign_dyn
from falcon_r1cs_tpu.r1cs import export as jax_export
from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS as JaxCompiledR1CS
from falcon_r1cs_tpu.utils.counters import CounterLog as JaxCounterLog
from falcon_r1cs_tpu.witness import jitted_engine
from falcon_r1cs_tpu.witness.layout import export_witness_limbs as jax_export_limbs
from falcon_r1cs_tpu_torch.falcon import KeyPair, hash_to_point, make_instance, ntt
from falcon_r1cs_tpu_torch.falcon import nist_kat
from falcon_r1cs_tpu_torch.falcon.spec_sign import sign_dyn
from falcon_r1cs_tpu_torch.r1cs import export
from falcon_r1cs_tpu_torch.r1cs.coo import CompiledR1CS
from falcon_r1cs_tpu_torch.utils import CounterLog
from falcon_r1cs_tpu_torch.witness import export_witness_limbs, witness_engine


@pytest.fixture(scope="module")
def keypairs():
    """One Falcon-512 key pair from the same seed in each package."""
    return (KeyPair.generate(np.random.default_rng(0), port.FALCON_512),
            JaxKeyPair.generate(np.random.default_rng(0), jax_pkg.FALCON_512))


def test_keygen_matches_jax(keypairs):
    got, want = keypairs
    for k in ("f", "g", "F", "G"):
        assert np.array_equal(np.asarray(getattr(got.secret_key, k)),
                              np.asarray(getattr(want.secret_key, k))), k
    assert np.array_equal(got.h, want.h)


@pytest.mark.parametrize("spec_exact", [False, True])
def test_sign_with_seed_matches_jax(keypairs, spec_exact):
    got, want = keypairs
    msg = b"testing message"
    a = got.signer.sign_with_seed(b"test seed", msg, spec_exact=spec_exact)
    b = want.signer.sign_with_seed(b"test seed", msg, spec_exact=spec_exact)
    assert a.nonce == b.nonce and np.array_equal(a.s2, b.s2)
    assert got.verify(msg, a)
    assert not got.verify(b"another message", a)


def test_sign_dyn_matches_jax(keypairs):
    sk = keypairs[0].secret_key
    hm = hash_to_point(b"m", bytes(40), 512)
    got = sign_dyn(sk.f, sk.g, sk.F, sk.G, hm, b"seed", 9)
    want = jax_sign_dyn(sk.f, sk.g, sk.F, sk.G, hm, b"seed", 9)
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(got, want))


def _kat_cases(kat, params, count=2):
    """`count` KAT cases through one package's keypair and sign flows."""
    cases = []
    for i in range(count):
        seed = bytes([(i * 37 + j) & 0xFF for j in range(48)])
        drbg = kat.NistDrbg(seed)
        pk, skb, sk = kat.crypto_sign_keypair(drbg, params)
        msg = bytes([(i + j) & 0xFF for j in range(33)])
        sm = kat.crypto_sign(msg, sk.f, sk.g, sk.F, sk.G, params, drbg)
        cases.append({"count": i, "seed": seed, "mlen": len(msg), "msg": msg,
                      "pk": pk, "sk": skb, "smlen": len(sm), "sm": sm})
    return kat.write_rsp(cases, params)


def test_kat_rsp_matches_jax_and_validates(tmp_path):
    """keygen_from_seed, sign_dyn and write_rsp of two KAT cases equal the
    JAX package's byte for byte, and validate_rsp round-trips them."""
    text = _kat_cases(nist_kat, port.FALCON_512)
    assert text == _kat_cases(jax_kat, jax_pkg.FALCON_512)
    sk = nist_kat.keygen_from_seed(b"k" * 48, port.FALCON_512)
    want = jax_kat.keygen_from_seed(b"k" * 48, jax_pkg.FALCON_512)
    assert [list(getattr(sk, k)) for k in "fgFG"] == [list(getattr(want, k)) for k in "fgFG"]
    path = tmp_path / "falcon512-KAT.rsp"
    path.write_text(text)
    results = nist_kat.validate_rsp(path, 512)
    assert [r["count"] for r in results] == [0, 1]
    for r in results:
        assert r["keygen"] and r["sign"] and r["consistent"] and r["sm_verifies"], r
    assert nist_kat.parse_rsp(text) == jax_kat.parse_rsp(text)


def _section_table(pkg, log_cls):
    cs = pkg.ConstraintSystem()
    log = log_cls(cs)
    params = pkg.get_params(512)
    with log.section("constants"):
        pkg.ntt_param_var(cs, params)
    with log.section("range proofs (two coeffs)"):
        for v in (5, 12288):
            pkg.enforce_less_than_q(cs, pkg.FpVar.new_witness(cs, v))
    return log.table()


def test_counter_log_table_matches_jax():
    got = _section_table(port, CounterLog)
    assert got == _section_table(jax_pkg, JaxCounterLog)
    assert got.splitlines()[0].startswith("section")


def _small_system(pkg, compiled_cls):
    """A satisfied system of range proofs: (compiled, instance, witness)."""
    cs = pkg.ConstraintSystem()
    pkg.FpVar.new_input(cs, 7)
    for v in (0, 1, 6143, 12288):
        pkg.enforce_less_than_q(cs, pkg.FpVar.new_witness(cs, v))
    assert cs.is_satisfied()
    full = cs.full_assignment()
    return compiled_cls.from_cs(cs), full[: cs.num_instance_variables], full[cs.num_instance_variables:]


def test_exports_match_jax(tmp_path):
    """export_r1cs and export_witness write equal arrays in both packages."""
    comp, inst, wit = _small_system(port, CompiledR1CS)
    jcomp, jinst, jwit = _small_system(jax_pkg, JaxCompiledR1CS)
    assert (inst, wit) == (jinst, jwit)
    got = export.load_r1cs_arrays(export.export_r1cs(comp, tmp_path / "port"))
    want = jax_export.load_r1cs_arrays(jax_export.export_r1cs(jcomp, tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    il = np.stack([export._int_to_u32(v) for v in inst])[None]
    wl = np.stack([export._int_to_u32(v) for v in wit])[None]
    p = export.export_witness(il, wl, tmp_path / "w_port")
    q = jax_export.export_witness(il, wl, tmp_path / "w_jax")
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files) == ["instance", "witness"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


def test_export_witness_limbs_matches_jax():
    """The vectorised limb split gives the JAX package's double loop's
    (B, W, 5) uint32 on the segments of one Falcon-512 witness."""
    inst = make_instance(np.random.default_rng(4), port.FALCON_512)
    arrays = (inst.sig_lifted[None].astype(np.int32), ntt(inst.h)[None].astype(np.int32),
              ntt(inst.hm)[None].astype(np.int32))
    seg = witness_engine(512)(*(torch.from_numpy(a) for a in arrays))
    jseg = {k: np.asarray(v) for k, v in jitted_engine(512)(*arrays).items()}
    got = export_witness_limbs(seg, port.FALCON_512)
    want = jax_export_limbs(jseg, jax_pkg.FALCON_512)
    assert got.dtype == want.dtype == np.uint32
    assert got.shape == want.shape == (1, 78386, 5)
    assert np.array_equal(got, want)
    assert got[..., 1:].any(), "no value above 2^32: the limb split is untested"
