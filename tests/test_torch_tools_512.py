"""The port's Falcon-512 tools (falcon_r1cs_tpu_torch/tools/profile_prove.py,
prove_batch.py and pp_vs_dp.py) against the JAX package and its tools, on
the CPU: the batch tool's assignments against the JAX tool's steps
(tools/bench_prove_batch.py:36-53), its proofs and the profile's on a CRS
the JAX package set up, against the JAX package's prove and prove_batch,
the MSM split against the native C, and PP against DP and the JAX
pipeline in a gloo group of 2.

Everything is integer or group arithmetic: every comparison is equality.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import falcon_r1cs_tpu as jfr
from falcon_r1cs_tpu.falcon import make_instance as jax_make_instance
from falcon_r1cs_tpu.falcon import ntt as jax_ntt
from falcon_r1cs_tpu.params import FALCON_512 as JAX_FALCON_512
from falcon_r1cs_tpu.parallel import pipeline_pp as jax_pp
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu.snark import groth16 as jax_groth16
from falcon_r1cs_tpu.snark import native_backend as jax_native
from falcon_r1cs_tpu.snark.points import G1Array as JaxG1Array
from falcon_r1cs_tpu.snark.points import ints_to_limbs as jax_ints_to_limbs
from falcon_r1cs_tpu.witness import interleave_witness, jitted_engine
from falcon_r1cs_tpu_torch import FALCON_512
from falcon_r1cs_tpu_torch.falcon import make_instance
from falcon_r1cs_tpu_torch.r1cs import coo
from falcon_r1cs_tpu_torch.snark import groth16
from falcon_r1cs_tpu_torch.tools import (
    msm_multi,
    pp_vs_dp,
    profile_prove,
    prove_batch,
    prove_large,
)

REPO = Path(__file__).resolve().parent.parent
TOXIC = dict(tau=1234567, alpha=7654321, beta=1111111, gamma=2222221, delta=3333331)
RS = (0x1234567890ABCDEF, 0x0FEDCBA987654321)
SS = (0x1111111122222222, 0x3333333344444444)
JAX_STAGES = ["witness_map", "msm A (a_query)", "msm B1 (b_g1_query)",
              "msm B2 (b_g2_query, G2)", "msm L (l_query)", "msm H (h_query)", "prove (total)"]


def _quiet(*_):
    pass


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread: the plain MSM is thousands of small
    ops, and with every core busy (the suite's other workers) a pool of
    threads a process waits on the others at each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def port_cache(tmp_path, monkeypatch):
    """The port's artifact directory in a tmp dir."""
    monkeypatch.setattr(coo, "cache_dir", lambda: tmp_path)
    monkeypatch.setattr(prove_large, "cache_dir", lambda: tmp_path)
    return tmp_path


@pytest.fixture(scope="module")
def crs_512(tmp_path_factory):
    """The JAX package's setup of Falcon-512 verify-with-NTT (the circuit
    of the JAX tools' instance seed 5) with fixed toxic waste, saved with
    its save_pk: (the JAX compiled circuit, its proving key, the file)."""
    path = tmp_path_factory.mktemp("crs") / "ntt512.pk.npz"
    inst = jax_make_instance(np.random.default_rng(5), jfr.get_params(512))
    compiled = jax_compile_circuit(jfr.FalconNTTVerificationCircuit, inst, cache=False)
    jpk = jax_groth16.setup(compiled, toxic=jax_groth16.SetupToxic(**TOXIC))
    jax_groth16.save_pk(jpk, path)
    return compiled, jpk, path


def _jax_tool_assignments(K):
    """tools/bench_prove_batch.py:36-53 with the JAX engine on the CPU:
    (assignments as (N, 4) u64 limb rows, publics)."""
    rng = np.random.default_rng(7)
    insts = [jax_make_instance(rng, jfr.get_params(512)) for _ in range(K)]
    sig = np.stack([i.sig_lifted for i in insts]).astype(np.int32)
    pk_ntt = np.stack([jax_ntt(i.h) for i in insts]).astype(np.int32)
    hm_ntt = np.stack([jax_ntt(i.hm) for i in insts]).astype(np.int32)
    seg = {k: np.asarray(v) for k, v in jitted_engine(512)(sig, pk_ntt, hm_ntt).items()}
    wit = interleave_witness(seg, JAX_FALCON_512)
    assignments, publics = [], []
    for k in range(K):
        pub = [1] + [int(v) for v in seg["pk_ntt"][k]] + [int(v) for v in seg["hm_ntt"][k]]
        assignments.append(jax_ints_to_limbs(pub + [int(v) for v in wit[k]], 4))
        publics.append(pub)
    return assignments, publics


def test_assignments_match_jax_tool():
    """prove_large.assignments with the verify-with-NTT circuit (engine and
    packer on CPU tensors, the packer's 5 u32 limbs folded into u64 rows)
    gives the JAX tool's public inputs and assignments for K = 3 instances
    of seed 7, where the JAX tool interleaves on the host."""
    rng = np.random.default_rng(prove_batch.INSTANCE_SEED)
    insts = [make_instance(rng, FALCON_512) for _ in range(3)]
    publics, zs = prove_large.assignments(profile_prove.CIRCUIT, insts, "cpu")
    want_z, want_publics = _jax_tool_assignments(3)
    assert publics == want_publics
    for z, w in zip(zs, want_z, strict=True):
        assert z.dtype == np.uint64 and np.array_equal(z, w)


def test_prove_batch_matches_jax_prove_batch(crs_512, port_cache):
    """prove_batch.run(K=2, iters=1, native) on the JAX package's CRS with
    fixed r and s: every proof verifies and the first equals the single
    prove (both checked inside the run); each equals the port's single
    prove with its r and s, and the JAX package's prove_batch on the same
    key, the JAX tool's assignments, r and s."""
    compiled, jpk, path = crs_512
    out = prove_batch.run(K=2, iters=1, g1_backend="native", device="cpu", crs=path, rs=RS,
                          ss=SS, log=_quiet)
    got = [(p.a, p.b, p.c) for p in out["proofs"]]
    for k, z in enumerate(out["assignments"]):
        p = groth16.prove(out["pk"], out["compiled"], z, r=RS[k], s=SS[k], g1_backend="native")
        assert (p.a, p.b, p.c) == got[k]
    zs, publics = _jax_tool_assignments(2)
    want = jax_groth16.prove_batch(jpk, compiled, zs, rs=list(RS), ss=list(SS))
    assert got == [(p.a, p.b, p.c) for p in want]
    assert out["publics"] == publics
    assert out["per_proof_s"] == out["batch_s"] / 2
    assert list(out["seconds"]) == ["compile (direct COO)", "witness x2 (device)", "load CRS",
                                    "warm-up prove_batch"]


def test_profile_prove_native_stages(crs_512, port_cache):
    """profile_prove.run(iters=1, native) on the JAX package's CRS: the JAX
    tool's stages (the whole prove last), a proof that verifies (checked
    inside) and equals the JAX package's prove of the JAX tool's host
    trace with the same r and s."""
    compiled, jpk, path = crs_512
    out = profile_prove.run(iters=1, g1_backend="native", device="cpu", crs=path, r=RS[0],
                            s=SS[0], log=_quiet)
    assert list(out["ms"]) == JAX_STAGES and out["splits"] == {}
    assert all(v > 0 for v in out["ms"].values())
    inst = jax_make_instance(np.random.default_rng(5), jfr.get_params(512))
    cs = jfr.ConstraintSystem(mode="prove")
    jfr.FalconNTTVerificationCircuit.build_circuit(inst).generate_constraints(cs)
    z = list(cs.instance_values) + list(cs.witness_values)
    assert np.array_equal(out["assignment"], jax_ints_to_limbs([int(v) for v in z], 4))
    want = jax_groth16.prove(jpk, compiled, z, r=RS[0], s=SS[0], g1_backend="native")
    assert (out["proof"].a, out["proof"].b, out["proof"].c) == (want.a, want.b, want.c)


def test_msm_split_cpu_sums_to_native():
    """msm_split on CPU tensors (the plain recode, K4, K5, K6) over 2^10 points
    tiled from 8 base points, every 97th an infinity (its scalar must be
    masked, as in a CRS query): the whole MSM and the fold of the split's
    window sums equal the native C (checked inside) and the JAX package's
    native MSM; one sample of the window sums at the default group; no
    kernel launched."""
    _, arr = msm_multi.tiled_points(1 << 10)
    arr.inf[::97] = 1
    sc = msm_multi.random_scalars(np.random.default_rng(3), 1, 1 << 10)[0]
    sp = profile_prove.msm_split(arr, sc, "cpu")
    assert sp["sum"] == jax_native.g1_msm(JaxG1Array(arr.xs, arr.ys, arr.inf), sc)
    assert sp["sum"] is not None
    assert sp["group"] == 22 and list(sp["sums_ms"]) == [22] and len(sp["sums_ms"][22]) == 1
    assert sp["launches"] == dict.fromkeys(profile_prove.MSM_KERNELS, 0)
    assert sp["held_gib"] is None and sp["peak_gib"] == {22: None}


def _jax_tool_line(argv, capsys, monkeypatch):
    """The JAX tools/pp_vs_dp.py's PP line at `argv`, run in this process
    on its virtual CPU devices."""
    spec = importlib.util.spec_from_file_location("jax_pp_vs_dp", REPO / "tools" / "pp_vs_dp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["pp_vs_dp.py"] + [str(a) for a in argv])
    capsys.readouterr()
    mod.main()
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("PP:")][0]


def test_pp_vs_dp_matches_jax(capsys, monkeypatch):
    """pp_vs_dp.run over 2 gloo ranks, n = 512, mb = 4, T = 4: PP equals DP
    (checked inside) and the JAX package's pp_ntt and dp_ntt on 2 virtual
    devices over the same input; the bubble and byte counts are the JAX
    tool's formulas, and its PP line prints the same bubble and conveyor
    traffic."""
    S, n, mb, T = 2, 512, 4, 4
    lines = []
    out = pp_vs_dp.run(S, n, mb, T, device="cpu", log=lines.append)
    x = pp_vs_dp.inputs(n, mb, T)
    assert np.array_equal(x, np.random.default_rng(0).integers(
        0, JAX_FALCON_512.q, size=(T * mb, n)).astype(np.int32))
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("stage",))
    want = np.asarray(jax_pp.pp_ntt(mesh, jfr.get_params(n), microbatch=mb, n_micro=T)(x))
    assert np.array_equal(out["out"], want)
    assert np.array_equal(out["out"], np.asarray(jax_pp.dp_ntt(mesh, jfr.get_params(n))(x)))
    assert out["bubble"] == (S - 1) / (T + S - 1)
    assert out["conveyor_bytes"] == (T + S - 2) * mb * n * 4
    assert out["broadcast_bytes"] == T * mb * n * 4
    assert len(out["out"]) == T * mb and out["threads"] >= 1
    assert out["pp_ms"] <= out["pp_median_ms"] and out["dp_ms"] <= out["dp_median_ms"]
    jax_line = _jax_tool_line((S, n, mb, T), capsys, monkeypatch)
    fields = jax_line.split("; ")[1:]  # "analytic bubble ...", "conveyor traffic ... MB"
    port_line = [line for line in lines if line.startswith("PP:")][0]
    assert fields[0] in port_line and fields[1].split(" + ")[0] in port_line


def test_pp_vs_dp_refuses_more_ranks_than_cards(monkeypatch, capsys):
    """On "cuda" S ranks need S cards: on a one-card host run raises
    run_group's ValueError naming the count, and main exits 2 with it;
    nothing moves to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards; this host has 1"):
        pp_vs_dp.run(2, device="cuda")
    assert pp_vs_dp.main(["2"]) == 2
    assert "this host has 1" in capsys.readouterr().err
