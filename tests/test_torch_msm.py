"""The port's G1 MSM engine (snark/gpu_msm.py) and Groth16 prover hook
against the JAX package: the host recode and limb slicing, MSMs on CPU
tensors (the plain versions of K4, K5 and K6) against the JAX package's
native C MSM and the pure-Python sum, and proofs against the JAX native
prover.  Exact results: every comparison is equality."""

import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.snark.tpu_msm as tm
import falcon_r1cs_tpu.snark.tpu_msm_blocks as tmb
from falcon_r1cs_tpu.r1cs.system import ConstraintSystem as JaxConstraintSystem
from falcon_r1cs_tpu.snark import groth16 as jax_groth16
from falcon_r1cs_tpu.snark import native_backend as jax_native
from falcon_r1cs_tpu.snark.points import G1Array as JaxG1Array
from falcon_r1cs_tpu_torch.ops import fq
from falcon_r1cs_tpu_torch.r1cs import CompiledR1CS, ConstraintSystem
from falcon_r1cs_tpu_torch.snark import bls12_381 as bls
from falcon_r1cs_tpu_torch.snark import groth16, gpu_msm
from falcon_r1cs_tpu_torch.snark.backend_policy import choose_g1_backend
from falcon_r1cs_tpu_torch.snark.points import G1Array, ints_to_limbs
from falcon_r1cs_tpu_torch.utils.device import DeviceUnavailableError

rng = np.random.default_rng(20261017)


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


def _scalars_u64(n):
    sc = rng.integers(0, 2**63, size=(n, 4), dtype=np.uint64) * np.uint64(2)
    sc[:, 3] >>= np.uint64(2)  # < 2^254 < r
    return sc


def test_recode_and_limb_slicing_match_jax():
    sc = _scalars_u64(64)
    sc[0] = np.uint64(2**64 - 1)
    sc[0, 3] = np.uint64(2**62 - 1)
    sc[1] = 0
    for window in (4, 5, 12):
        assert np.array_equal(gpu_msm._window_digits(sc, window),
                              tm._window_digits(sc, window))
        assert np.array_equal(gpu_msm._window_digits_signed(sc, window),
                              tm._window_digits_signed(sc, window))
    arr = jax_native.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, 16)])
    for rows in (arr.xs, arr.ys, sc):
        assert np.array_equal(gpu_msm._u64_rows_to_limb12(rows), tm._u64_rows_to_limb12(rows))
    xs, ys = gpu_msm._points_std_limbs(arr, 32)
    jx, jy, _ = tm._points_std_limbs(arr, 32)
    assert np.array_equal(xs, np.asarray(jx)) and np.array_equal(ys, np.asarray(jy))


@pytest.mark.parametrize("nb", [9, 17, 2049, 6])
def test_tree_helpers_match_jax(nb):
    assert gpu_msm.wsum_weights(nb) == tmb.wsum_weights(nb)
    n = 1 << max(3, nb.bit_length())
    assert np.array_equal(gpu_msm._brev(n), tmb._brev(n))
    assert gpu_msm._group_windows(1 << 18, 22) == tmb._group_windows(1 << 18, 22)
    assert gpu_msm._group_windows(32, 64, cap=32) == 32


def _host_sum(pts, sc):
    acc = None
    for p, s in zip(pts, sc):
        s = int(s) % bls.R
        if p is None or s == 0:
            continue
        acc = bls.g1_add(acc, bls.g1_mul(bls.g1_from_affine(p), s))
    return bls.g1_to_affine(acc) if acc is not None else None


@pytest.fixture(scope="module")
def msm_case():
    """n = 32 points with an infinity, zero scalars and a long run of
    equal window digits (split segments in the merge tree)."""
    n = 32
    jarr = jax_native.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, n)])
    inf = jarr.inf.copy()
    inf[9] = 1
    arr = G1Array(jarr.xs, jarr.ys, inf)
    sc = [int(x) for x in rng.integers(0, 2**62, n)]
    sc[3] = sc[17] = 0
    for i in range(6, 26):
        sc[i] = 0x55555  # digit 5 in every window of width 4
    pts = arr.to_affine_list()
    want = _host_sum(pts, sc)
    assert want == jax_native.g1_msm(JaxG1Array(jarr.xs, jarr.ys, inf), sc)
    return arr, sc, want


@pytest.mark.parametrize("group", [None, 32])
def test_msm_cpu_matches_native_and_host(msm_case, group):
    """window 4: 64 windows in one group, or in two groups of 32."""
    arr, sc, want = msm_case
    launches = (fq.mont_mul_cuda.launches, fq.point_add_cuda.launches)
    got = gpu_msm.g1_msm_gpu(arr, sc, window=4, device="cpu", group=group)
    assert got == want
    assert (fq.mont_mul_cuda.launches, fq.point_add_cuda.launches) == launches


def test_msm_multi_cpu_matches_native(msm_case):
    arr, sc, want = msm_case
    sc2 = [int(x) for x in rng.integers(0, 2**62, len(sc))]
    got = gpu_msm.g1_msm_gpu_multi(arr, [sc, sc2], window=4, device="cpu")
    assert got == [want, _host_sum(arr.to_affine_list(), sc2)]
    # the Montgomery points were converted once and cached on the array,
    # the infinity mask uploaded once beside them
    assert list(arr._gpu_mont_cache) == [("inf", "cpu"), (32, "cpu")]


def test_msm_all_zero_is_none(msm_case):
    arr, sc, _ = msm_case
    assert gpu_msm.g1_msm_gpu(arr, [0] * len(sc), window=4, device="cpu") is None


def _toy_circuit(cs_cls):
    """x^3 + x + 5 = out, witness x = 3, public out = 35 (the toy circuit
    of tests/test_snark.py)."""
    cs = cs_cls(mode="prove")
    x = cs.new_witness_variable(3)
    out = cs.new_input_variable(35)
    x2 = cs.new_witness_variable(9)
    x3 = cs.new_witness_variable(27)
    one = 0
    cs.enforce_constraint({x: 1}, {x: 1}, {x2: 1})
    cs.enforce_constraint({x2: 1}, {x: 1}, {x3: 1})
    cs.enforce_constraint({x3: 1, x: 1, one: 5}, {one: 1}, {out: 1})
    assert cs.is_satisfied()
    return cs


@pytest.fixture(scope="module")
def toy():
    from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS as JaxCompiledR1CS

    tox = dict(tau=11, alpha=12, beta=13, gamma=14, delta=15)
    compiled = CompiledR1CS.from_cs(_toy_circuit(ConstraintSystem))
    jcompiled = JaxCompiledR1CS.from_cs(_toy_circuit(JaxConstraintSystem))
    pk = groth16.setup(compiled, toxic=groth16.SetupToxic(**tox))
    jpk = jax_groth16.setup(jcompiled, toxic=jax_groth16.SetupToxic(**tox))
    want = jax_groth16.prove(jpk, jcompiled, [1, 35, 3, 9, 27], r=21, s=22,
                             g1_backend="native")
    return compiled, pk, jcompiled, jpk, want


def test_prove_gpu_backend_matches_jax_native(toy):
    """The port's prove with its G1 MSMs on the CUDA engine's plain path
    equals the JAX package's native prove (same toxic waste, r, s)."""
    compiled, pk, _, _, want = toy
    got = groth16.prove(pk, compiled, [1, 35, 3, 9, 27], r=21, s=22,
                        g1_backend="gpu", msm_device="cpu")
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert groth16.verify(pk.vk, [1, 35], got)
    assert not groth16.verify(pk.vk, [1, 36], got)
    native = groth16.prove(pk, compiled, [1, 35, 3, 9, 27], r=21, s=22,
                           g1_backend="native")
    assert (native.a, native.b, native.c) == (want.a, want.b, want.c)


def test_jax_saved_pk_loads_into_port(toy, tmp_path):
    """A CRS saved by the JAX package (npz, numpy arrays) loads into the
    port and proves the same."""
    compiled, _, _, jpk, want = toy
    path = tmp_path / "crs.npz"
    jax_groth16.save_pk(jpk, path)
    pk = groth16.load_pk(path)
    got = groth16.prove(pk, compiled, [1, 35, 3, 9, 27], r=21, s=22,
                        g1_backend="gpu", msm_device="cpu")
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert groth16.verify(pk.vk, [1, 35], got)


@pytest.mark.parametrize("msm_device, native_built, want", [
    ("cpu", True, "native"),
    ("cpu", False, "python"),
    ("cuda", True, "gpu"),
    ("cuda", False, "gpu"),
    ("cuda:0", True, "gpu"),
    (torch.device("cuda"), True, "gpu"),
    (torch.device("cpu"), True, "native"),
])
def test_backend_policy(msm_device, native_built, want, monkeypatch):
    """The backend follows msm_device: the card on any CUDA device, given
    as a string, with an index or as a torch.device, whether the host C is
    built or not; the host C on the CPU, pure Python without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert choose_g1_backend(native_built, msm_device) == want


def test_backend_policy_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        choose_g1_backend(True, "cuda")
    assert choose_g1_backend(True, "cpu") == "native"


def test_prove_auto_on_cpu_matches_jax_native(toy):
    """g1_backend "auto" on a CPU msm_device is the host C prover: the
    JAX package's native proof with the same toxic waste, r and s."""
    compiled, pk, _, _, want = toy
    got = groth16.prove(pk, compiled, [1, 35, 3, 9, 27], r=21, s=22, msm_device="cpu")
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert groth16.resolve_g1_backend("auto", "cpu") == "native"


def _no_prover_work(monkeypatch):
    """Make every witness map and MSM of the prover fail the test."""
    def forbidden(*args, **kwargs):
        raise AssertionError("the prover ran before its device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(groth16, "witness_map_dispatch", forbidden)
    monkeypatch.setattr(gpu_msm, "g1_msm_gpu", forbidden)
    monkeypatch.setattr(groth16.native_backend, "g1_msm", forbidden)
    monkeypatch.setattr(groth16.native_backend, "g1_msm_multi", forbidden)


@pytest.mark.parametrize("native_built", [True, False])
@pytest.mark.parametrize("entry", ["prove", "prove_batch"])
@pytest.mark.parametrize("g1_backend, msm_device", [
    ("auto", "cuda"), ("auto", "cuda:0"), ("gpu", "cuda"),
])
def test_card_backend_without_a_card_raises(toy, entry, native_built, g1_backend, msm_device,
                                            monkeypatch):
    """A CUDA msm_device under "auto" (the default) or "gpu" raises
    DeviceUnavailableError without a card, before any witness map or MSM,
    whether the host C is built or not: no quiet fallback to the host."""
    compiled, pk, _, _, _ = toy
    _no_prover_work(monkeypatch)
    if not native_built:
        monkeypatch.setattr(groth16, "_native", lambda: None)
    z = [1, 35, 3, 9, 27]
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        if entry == "prove":
            groth16.prove(pk, compiled, z, r=21, s=22, g1_backend=g1_backend,
                          msm_device=msm_device)
        else:
            groth16.prove_batch(pk, compiled, [z, z], rs=[21, 1], ss=[22, 2],
                                g1_backend=g1_backend, msm_device=msm_device)


def test_host_backends_ignore_msm_device(toy, monkeypatch):
    """An explicit "native" or "python" never looks at msm_device: the
    default "cuda" without a card proves on the host.  "python" with the
    host C built takes the C's h as limb rows (the JAX package's prove
    raises OverflowError there)."""
    compiled, pk, _, _, want = toy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend, use_native in (("native", True), ("python", True), ("python", False)):
        got = groth16.prove(pk, compiled, [1, 35, 3, 9, 27], r=21, s=22, g1_backend=backend,
                            use_native=use_native)
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c), backend


# toy assignments: x, public out = x^3 + x + 5, x^2, x^3
TOY_ZS = [[1, 35, 3, 9, 27], [1, 15, 2, 4, 8], [1, 73, 4, 16, 64]]


@pytest.mark.parametrize("g1_backend, use_native", [("auto", True), ("python", False)])
def test_prove_batch_on_cpu_matches_jax(toy, g1_backend, use_native):
    """prove_batch on a CPU msm_device against the JAX package's
    prove_batch (its native C multi-MSMs) with the same r and s: "auto"
    runs the host C's batch, "python" without the C a prove an
    assignment (the branch a CUDA msm_device takes with "gpu"); the
    assignments mix int lists and u64 limb rows."""
    compiled, pk, jcompiled, jpk, _ = toy
    rs, ss = [21, 31, 41], [22, 32, 42]
    want = jax_groth16.prove_batch(jpk, jcompiled, TOY_ZS, rs=rs, ss=ss)
    zs = [TOY_ZS[0], ints_to_limbs(TOY_ZS[1], 4), TOY_ZS[2]]
    got = groth16.prove_batch(pk, compiled, zs, rs=rs, ss=ss, g1_backend=g1_backend,
                              use_native=use_native, msm_device="cpu")
    assert [(p.a, p.b, p.c) for p in got] == [(p.a, p.b, p.c) for p in want]
    assert all(groth16.verify(pk.vk, z[:2], p) for z, p in zip(TOY_ZS, got))
