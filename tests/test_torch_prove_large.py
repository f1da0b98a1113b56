"""The port's large-circuit prover tools (falcon_r1cs_tpu_torch/tools/)
against the JAX package, on the CPU: the signed-digit recode at 2^20 and
2^21 scalars with engineered half digits, the window grouping at 2^21
points, the tool's assignment against the JAX tool's steps
(tools/prove_large.py:56-80), a dual-512 proof from the tool against the
JAX package's setup + prove, the K-fold MSM on half-digit scalars, the
batch tool, and the tools' refusal to fall back to the CPU.

Everything is integer or group arithmetic: every comparison is equality.
"""

import numpy as np
import pytest

import falcon_r1cs_tpu as jfr
import falcon_r1cs_tpu.snark.tpu_msm as tm
import falcon_r1cs_tpu.snark.tpu_msm_blocks as tmb
from falcon_r1cs_tpu.falcon import make_instance as jax_make_instance
from falcon_r1cs_tpu.falcon import ntt as jax_ntt
from falcon_r1cs_tpu.r1cs.coo import compile_circuit as jax_compile_circuit
from falcon_r1cs_tpu.snark import groth16 as jax_groth16
from falcon_r1cs_tpu.snark import native_backend as jax_native
from falcon_r1cs_tpu.snark.points import G1Array as JaxG1Array
from falcon_r1cs_tpu.snark.points import ints_to_limbs as jax_ints_to_limbs
from falcon_r1cs_tpu_torch import FALCON_512
from falcon_r1cs_tpu_torch.falcon import make_instance
from falcon_r1cs_tpu_torch.r1cs import coo
from falcon_r1cs_tpu_torch.snark import R, groth16, gpu_msm
from falcon_r1cs_tpu_torch.tools import (
    default_route,
    msm_multi,
    pp_vs_dp,
    profile_prove,
    prove_batch,
    prove_batch_large,
    prove_large,
)
from falcon_r1cs_tpu_torch.utils.device import DeviceUnavailableError

TOXIC = dict(tau=1234567, alpha=7654321, beta=1111111, gamma=2222221, delta=3333331)
RS = (0x1234567890ABCDEF, 0xFEDCBA0987654321)


def _quiet(*_):
    pass


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread: the plain MSM is thousands of small
    ops, and with every core busy (the suite's other workers) a pool of
    threads a process waits on the others at each op (~20x slower)."""
    import torch

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


def _scalars_with_half_digits(log_n, seed):
    """2^log_n full-width random scalars below r, the first rows the
    engineered half-digit scalars at windows 12 and 16."""
    sc = msm_multi.random_scalars(np.random.default_rng(seed), 1, 1 << log_n)[0]
    tricky = msm_multi.half_digit_scalars((12, 16))
    sc[: len(tricky)] = jax_ints_to_limbs(tricky, 4)
    return sc, len(tricky)


@pytest.mark.parametrize("window", [12, 16])
@pytest.mark.parametrize("log_n", [20, 21])
def test_window_digits_signed_at_scale(log_n, window):
    """The port's recode is bit-equal to the JAX package's at 2^20 and 2^21
    scalars; every digit lies in [-(half - 1), half] with no negative
    zero; the engineered rows hit +half; and sum_i d_i 2^(w i) equals the
    scalar on every row: exactly, by carrying the signed digits back into
    unsigned window digits (int64, vectorised; the carry out of the top
    window must be 0) equal to the slicing _window_digits, and over Python
    ints on a seeded sample of rows that holds every engineered row."""
    sc, n_tricky = _scalars_with_half_digits(log_n, 100 + log_n)
    got = gpu_msm._window_digits_signed(sc, window)
    assert np.array_equal(got, tm._window_digits_signed(sc, window))
    half, mask = 1 << (window - 1), (1 << window) - 1
    mag, neg = got & mask, got >> window
    assert mag.max() == half and not (neg & (mag == 0)).any()
    assert ((neg == 0) | (mag < half)).all()
    assert (got[:, :n_tricky] == half).any()

    d = np.where(neg == 1, -mag, mag).astype(np.int64)
    carry = np.zeros(d.shape[1], dtype=np.int64)
    unsigned = np.zeros_like(d)
    for w in range(d.shape[0]):
        t = d[w] + carry
        unsigned[w] = t & mask
        carry = t >> window
    assert not carry.any()
    assert np.array_equal(unsigned, gpu_msm._window_digits(sc, window))

    sample = np.concatenate([np.arange(n_tricky),
                             np.random.default_rng(log_n).integers(0, len(sc), 256)])
    for i, want in zip(sample, msm_multi._as_ints(sc[sample])):
        assert sum(int(v) << (window * w) for w, v in enumerate(d[:, i])) == want


def test_group_windows_at_2_21_points():
    """The memory rule pinned on the CPU (the JAX engine's 6 GB): a group's
    live tree state is ~4 x 3 coordinates x 35 limbs x 4 B = 1,680 B a
    point a window, 3.52 GB a window at n_pad = 2^21, so 6 GB holds one
    window: the 22 windows of a 2^21-point MSM (and the 44 of a K = 2
    K-fold) run one a group.  At 2^18 (440 MB a window) 13 fit, and the
    largest divisor of 22 within 13 is 11, of 176 (K = 8) 11.  The JAX
    engine agrees."""
    assert 1680 * (1 << 21) > 6e9 / 2
    for n_pad, windows, group in ((1 << 21, 22, 1), (1 << 21, 44, 1),
                                  (1 << 18, 22, 11), (1 << 18, 176, 11)):
        assert gpu_msm._group_windows(n_pad, windows) == group
        assert tmb._group_windows(n_pad, windows) == group


@pytest.mark.parametrize("gib, groups", [
    (80, ((1 << 21, 22, 2), (1 << 21, 44, 4), (1 << 18, 22, 22), (1 << 18, 176, 44))),
    (16, ((1 << 21, 22, 1), (1 << 21, 44, 1), (1 << 18, 22, 2), (1 << 18, 176, 8))),
])
def test_group_windows_on_a_card(monkeypatch, gib, groups):
    """On a card the budget is a quarter of its memory: on an 80 GB H100
    21.5 GB, 6 windows of 3.52 GB at 2^21 (two of 22 a group, four of 44),
    48 of 440 MB at 2^18 (all 22; 44 of a K = 8 K-fold's 176); on a 16 GB
    card 4.3 GB, one window at 2^21 and 9 at 2^18 (2 of 22, 8 of 176)."""
    import torch

    class Props:
        total_memory = gib * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    for n_pad, windows, group in groups:
        assert gpu_msm._group_windows(n_pad, windows, device="cuda") == group
    assert gpu_msm._group_windows(1 << 21, 22, device="cpu") == 1


def _jax_tool_assignment(which, n):
    """tools/prove_large.py:56-80 at Falcon-n with the JAX engines on the
    CPU: (publics, assignment limb rows)."""
    from falcon_r1cs_tpu.witness import (
        interleave_witness_dual,
        interleave_witness_schoolbook,
        jitted_engine_dual,
        jitted_engine_schoolbook,
    )

    params = jfr.get_params(n)
    inst = jax_make_instance(np.random.default_rng(9), params)
    if which == "schoolbook":
        engine, interleave = jitted_engine_schoolbook, interleave_witness_schoolbook
        sig = inst.sig_lifted[None].astype(np.int32)
        pk_in = inst.h[None].astype(np.int32)
        hm_in = inst.hm[None].astype(np.int32)
    else:
        engine, interleave = jitted_engine_dual, interleave_witness_dual
        sig = inst.sig_signed[None].astype(np.int32)
        pk_in = jax_ntt(inst.h)[None].astype(np.int32)
        hm_in = jax_ntt(inst.hm)[None].astype(np.int32)
    seg = {k: np.asarray(v) for k, v in engine(n)(sig, pk_in, hm_in).items()}
    wit = interleave(seg, params)
    publics = [1] + [int(v) for v in pk_in[0]] + [int(v) for v in hm_in[0]]
    return publics, jax_ints_to_limbs(publics + [int(v) for v in wit[0]], 4)


@pytest.mark.parametrize("which", ["dual", "schoolbook"])
def test_assignment_matches_jax_tool(which):
    """The tool's public inputs and assignment (engine and packer on CPU
    tensors, the packer's 5 or 8 u32 limbs folded into u64 rows) equal
    the ones the JAX tool builds for the same instance seed, at n = 512."""
    inst = make_instance(np.random.default_rng(prove_large.INSTANCE_SEED), FALCON_512)
    (publics,), (z,) = prove_large.assignments(which, [inst], "cpu")
    want_publics, want_z = _jax_tool_assignment(which, 512)
    assert publics == want_publics
    assert z.dtype == np.uint64 and np.array_equal(z, want_z)


@pytest.fixture(scope="module")
def dual_512(tmp_path_factory):
    """The JAX package's setup of dual-512 with fixed toxic waste, saved
    with its save_pk; then the tool's run("dual", n=512,
    g1_backend="native", device="cpu") on that CRS (--crs) with fixed r,
    s, its artifact directory in a tmp dir: (the JAX compiled circuit and
    proving key, the run's result)."""
    tmp = tmp_path_factory.mktemp("artifacts")
    inst = jax_make_instance(np.random.default_rng(9), jfr.get_params(512))
    compiled = jax_compile_circuit(jfr.FalconDualNTTVerificationCircuit, inst, cache=False)
    jpk = jax_groth16.setup(compiled, toxic=jax_groth16.SetupToxic(**TOXIC))
    jax_groth16.save_pk(jpk, tmp / "dual512.pk.npz")
    mp = pytest.MonkeyPatch()
    mp.setattr(coo, "cache_dir", lambda: tmp)
    mp.setattr(prove_large, "cache_dir", lambda: tmp)
    try:
        out = prove_large.run("dual", 512, "native", "cpu", crs=tmp / "dual512.pk.npz",
                              r=RS[0], s=RS[1], log=_quiet)
    finally:
        mp.undo()
    return compiled, jpk, out


def test_run_dual_512_matches_jax_setup_and_prove(dual_512):
    """The tool's proof, on the CRS the JAX package set up and saved, is
    identical to the JAX package's prove on the JAX tool's assignment
    with the same toxic waste, r and s; every stage was timed."""
    compiled, jpk, out = dual_512
    publics, z = _jax_tool_assignment("dual", 512)
    want = jax_groth16.prove(jpk, compiled, z, r=RS[0], s=RS[1], g1_backend="native")
    got = out["proof"]
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert out["publics"] == publics
    assert list(out["seconds"]) == ["compile (direct COO)", "witness (device)", "load CRS",
                                    "prove (cold)", "prove (warm)", "verify"]
    assert out["peak_device_gib"] is None


def test_proving_key_from_the_artifact_directory(dual_512, port_cache, monkeypatch):
    """proving_key: with no --crs and no toxic waste a CRS in the artifact
    directory is loaded; fixed toxic waste always sets up afresh (and
    --save-crs saves it there)."""
    _, _, out = dual_512
    timed = prove_large.Stages(torch_cpu(), _quiet)
    groth16.save_pk(out["pk"], prove_large.crs_path("dual", 512))
    pk = prove_large.proving_key(out["compiled"], "dual", 512, timed)
    assert list(timed.seconds) == ["load CRS"] and pk.delta_g1 == out["pk"].delta_g1
    monkeypatch.setattr(prove_large, "setup", lambda compiled, toxic: out["pk"])
    prove_large.crs_path("dual", 512).unlink()
    prove_large.proving_key(out["compiled"], "dual", 512, timed, save_crs=True,
                            toxic=groth16.SetupToxic(**TOXIC))
    assert list(timed.seconds) == ["load CRS", "setup (CRS)", "save CRS"]
    assert prove_large.crs_path("dual", 512).exists()


def torch_cpu():
    import torch

    return torch.device("cpu")


def test_prove_batch_large_dual_512_native(dual_512, port_cache):
    """K = 2 over the tool's CRS: both proofs verify and equal single
    proves with the same r and s (both checked inside the run), and the
    batch's seconds a proof are reported."""
    out = prove_batch_large.run("dual", 2, 512, "native", "cpu", rs=RS, ss=RS[::-1],
                                pk=dual_512[2]["pk"], log=_quiet)
    assert len(out["proofs"]) == 2 and out["per_proof_s"] == out["batch_s"] / 2
    assert out["publics"][0][0] == 1 and len(out["publics"][1]) == 1 + 2 * 512


def test_msm_multi_half_digits_cpu():
    """The K-fold MSM on CPU tensors (the plain versions of K4, K5, K6) at
    window 4 (half = 8) over 64 points tiled from 8 base points, K = 2,
    every third scalar engineered to hit +8 (with the rows for windows 12
    and 16): equal to the port's native g1_msm_multi and the group law
    (checked inside half_digit_check, with the single MSM) and to the JAX
    package's native g1_msm_multi.  The tiling makes doublings and P + (-P)
    merges, where the JAX package's relaxed equality test once sent a row
    down the chord (ROADMAP Queue 3)."""
    out = msm_multi.half_digit_check(64, K=2, window=4, windows=(4, 12, 16), device="cpu",
                                     log=_quiet)
    assert list(out["seconds"]) == ["g1_msm_gpu", "g1_msm_gpu_multi K=2", "native g1_msm",
                                    "native g1_msm_multi K=2"]
    arr = out["points"]
    want = jax_native.g1_msm_multi(JaxG1Array(arr.xs, arr.ys, arr.inf), out["scalars"])
    assert out["sums"] == want and all(p is not None for p in want)


def test_msm_multi_run_cpu():
    """The tool's timing loop on CPU tensors over a toy point set, window
    4: one row a K, each equal to the native C (checked inside)."""
    _, arr = msm_multi.tiled_points(8, m=4)
    rows = msm_multi.run(Ks=(1, 2), iters=1, device="cpu", points=arr, window=4, log=_quiet)
    assert [r["K"] for r in rows] == [1, 2]
    assert all(r["gpu_ms_per_msm"] > 0 and r["native_ms_per_msm"] > 0 for r in rows)


def test_half_digit_scalars_hit_half():
    """Each window width's engineered rows recode to +half there, and every
    one is below r."""
    for w in (4, 12, 16):
        tricky = msm_multi.half_digit_scalars((w,))
        assert all(0 < s < R for s in tricky)
        digits = gpu_msm._window_digits_signed(jax_ints_to_limbs(tricky, 4), w)
        assert (digits[:, :4] == 1 << (w - 1)).any(axis=0).all()


@pytest.mark.parametrize("tool, argv", [
    (prove_large, ["dual"]),
    (prove_batch_large, ["schoolbook", "8"]),
    (profile_prove, ["1"]),
    (prove_batch, ["16", "2"]),
])
def test_prover_tools_default_to_the_card_backend(tool, argv, monkeypatch):
    """Each prover tool's run() and its parsed --g1-backend default to
    "gpu" (the witness map and the G1 MSMs on the card); --g1-backend
    native asks for the host C."""
    import inspect

    signature = inspect.signature(tool.run)
    assert signature.parameters["g1_backend"].default == "gpu"
    seen = []

    def no_card(*args, **kwargs):
        seen.append(signature.bind(*args, **kwargs).arguments["g1_backend"])
        raise DeviceUnavailableError("no card")

    monkeypatch.setattr(tool, "run", no_card)
    assert tool.main(argv) == 2
    assert tool.main(argv + ["--g1-backend", "native"]) == 2
    assert seen == ["gpu", "native"]


def test_default_route_needs_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_route.main(["--n", "512"]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("tool, argv", [
    (prove_large, ["dual", "--n", "512"]),
    (prove_batch_large, ["dual", "2", "--n", "512"]),
    (msm_multi, ["--n", "512", "--k", "1"]),
    (profile_prove, ["1", "--g1-backend", "native"]),
    (prove_batch, ["2", "1", "--g1-backend", "native"]),
    (pp_vs_dp, ["2", "512", "4", "4"]),
])
def test_tools_default_to_the_card(tool, argv, monkeypatch, capsys):
    """Without a card each tool's run raises DeviceUnavailableError and its
    main exits 2 naming --device cpu: no silent CPU fallback."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err
    with pytest.raises(DeviceUnavailableError):
        tool.run()
