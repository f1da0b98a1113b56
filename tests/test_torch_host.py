"""The port's own host layer against the JAX package's: the copied
parameter sets, circuits, COO compilation, instance generation and native
codecs give the same values, and importing the port loads neither JAX nor
any module of the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import falcon_r1cs_tpu
import falcon_r1cs_tpu_torch as port
from falcon_r1cs_tpu.falcon import codec as jax_codec
from falcon_r1cs_tpu.falcon import hash_to_point_batch as jax_hash_to_point_batch
from falcon_r1cs_tpu.falcon import make_instance as jax_make_instance
from falcon_r1cs_tpu.native import native_decode_pk_batch as jax_decode_pk
from falcon_r1cs_tpu.native import native_decode_sig_batch as jax_decode_sig
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu_torch import native
from falcon_r1cs_tpu_torch.falcon import (
    compress_signature,
    encode_public_key,
    hash_to_point_batch,
    make_instance,
)
from falcon_r1cs_tpu_torch.r1cs import coo

REPO = Path(__file__).resolve().parents[1]

# published golden (instance, witness, constraints) counts at n = 512
GOLDEN_512 = {
    "FalconNTTVerificationCircuit": (1025, 78386, 81460),
    "FalconSchoolBookVerificationCircuit": (1025, 312882, 315956),
    "FalconDualNTTVerificationCircuit": (1025, 95286, 96828),
}


@pytest.fixture(scope="module")
def insts():
    """One Falcon-512 instance from the same seed in each package."""
    return (
        make_instance(np.random.default_rng(5), port.FALCON_512),
        jax_make_instance(np.random.default_rng(5), falcon_r1cs_tpu.FALCON_512),
    )


def test_port_loads_no_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves no
    `jax` and no `falcon_r1cs_tpu.*` module in sys.modules."""
    mods = []
    for path in sorted((REPO / "falcon_r1cs_tpu_torch").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'falcon_r1cs_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "falcon_r1cs_tpu_torch.snark.gpu_msm" in mods
    assert "falcon_r1cs_tpu_torch.circuits.falcon_ntt" in mods
    assert {f"falcon_r1cs_tpu_torch.tools.{m}"
            for m in ("prove_large", "prove_batch_large", "msm_multi", "profile_prove",
                      "prove_batch", "pp_vs_dp")} <= set(mods)


@pytest.mark.parametrize("name", sorted(GOLDEN_512))
def test_compile_circuit_matches_jax(name, insts):
    """compile_circuit(..., cache=False) of the port's circuit equals the
    JAX package's, COO array for COO array, and has the golden counts."""
    got = port.compile_circuit(getattr(port, name), insts[0], cache=False)
    want = jax_compile_circuit(getattr(falcon_r1cs_tpu, name), insts[1], cache=False)
    assert type(got) is coo.CompiledR1CS
    counts = (got.num_instance, got.num_witness, got.num_constraints)
    assert counts == GOLDEN_512[name]
    assert counts == (want.num_instance, want.num_witness, want.num_constraints)
    assert np.array_equal(got.field_rows, want.field_rows)
    for which in ("a", "b", "c"):
        for g, w in zip(getattr(got, which), getattr(want, which)):
            assert g.dtype == w.dtype and np.array_equal(g, w), which


def test_trace_matches_golden(insts):
    """The port's own ConstraintSystem traces the verify-with-NTT circuit
    to the golden counts and a satisfied system."""
    cs = port.ConstraintSystem()
    port.FalconNTTVerificationCircuit.build_circuit(insts[0]).generate_constraints(cs)
    assert (cs.num_instance_variables, cs.num_witness_variables,
            cs.num_constraints) == GOLDEN_512["FalconNTTVerificationCircuit"]
    assert cs.is_satisfied()


def test_artifact_cache_is_the_ports_own():
    """The port caches artifacts in a directory of its own, so it never
    unpickles an artifact of the JAX package's class."""
    assert coo.cache_dir().name == "falcon_r1cs_tpu_torch"


@pytest.mark.parametrize("params", [port.FALCON_512, port.FALCON_1024])
def test_make_instance_matches_jax(params):
    jp = falcon_r1cs_tpu.get_params(params.n)
    got = make_instance(np.random.default_rng(7), params, msg=b"m")
    want = jax_make_instance(np.random.default_rng(7), jp, msg=b"m")
    assert (got.msg, got.nonce) == (want.msg, want.nonce)
    for k in ("h", "sig_signed", "hm", "v_signed"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert port.falcon.verify(got.h, got.msg, got.nonce, got.sig_signed, params)


def test_native_codecs_and_hash_match_jax():
    """The port's native batch decoders and hash-to-point equal the JAX
    package's on one batch of wire-format Falcon-512 signatures."""
    params = port.FALCON_512
    jp = falcon_r1cs_tpu.get_params(512)
    rng = np.random.default_rng(8)
    insts = [make_instance(rng, params, msg=b"msg %d" % i) for i in range(3)]
    pk = [encode_public_key(i.h, params) for i in insts]
    sig = [compress_signature(i.sig_signed, i.nonce, params) for i in insts]
    assert pk == [jax_codec.encode_public_key(i.h, jp) for i in insts]
    assert sig == [jax_codec.compress_signature(i.sig_signed, i.nonce, jp) for i in insts]
    assert np.array_equal(native.native_decode_pk_batch(pk, 512), jax_decode_pk(pk, 512))
    got_sig, got_nonces = native.native_decode_sig_batch(sig, 512)
    want_sig, want_nonces = jax_decode_sig(sig, 512)
    assert np.array_equal(got_sig, want_sig) and got_nonces == want_nonces
    msgs = [i.msg for i in insts]
    assert np.array_equal(
        hash_to_point_batch(msgs, got_nonces, 512),
        jax_hash_to_point_batch(msgs, want_nonces, 512),
    )
    assert np.array_equal(got_sig, np.stack([i.sig_signed for i in insts]))


def test_native_library_is_keyed_by_host():
    """The native libraries build into build/native/ under a name keyed by
    the sources, flags and the host CPU, never beside the source."""
    so = native.build_library(native._SRC)
    assert so.parent == REPO / "build" / "native"
    assert so.name.startswith("falcon_native_") and so.exists()
    assert not list((REPO / "falcon_r1cs_tpu_torch" / "native").glob("*.so"))
