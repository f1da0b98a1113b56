"""The port's parallel layer (falcon_r1cs_tpu_torch/parallel/) against the
JAX package's, bit for bit.

The port's sharded paths run in gloo groups of 2 and 4 CPU processes
spawned by `parallel.launch.run_group`, every check of one world size in
one group (a module-scoped fixture).  The JAX package runs in this test
process only, on the first 2 or 4 of its 8 virtual CPU devices
(conftest.py).  Inputs are made from numpy seeds; everything is integer
arithmetic, so the tolerance is 0: equal arrays, dtypes and counts.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from falcon_r1cs_tpu.params import get_params as jax_params
from falcon_r1cs_tpu.parallel import mesh as jax_mesh
from falcon_r1cs_tpu.parallel import pipeline_pp as jax_pp
from falcon_r1cs_tpu.parallel.ntt_sharded import ntt_sharded as jax_ntt_sharded
from falcon_r1cs_tpu.witness import jitted_engine
from falcon_r1cs_tpu.witness.engine_dual import jitted_engine_dual
from falcon_r1cs_tpu.witness.engine_schoolbook import jitted_engine_schoolbook
from falcon_r1cs_tpu_torch import Q
from falcon_r1cs_tpu_torch.entry import dryrun_multichip
from falcon_r1cs_tpu_torch.falcon import ntt
from falcon_r1cs_tpu_torch.parallel import jobs, make_mesh, mesh, pipeline_pp, scaling_sweep
from falcon_r1cs_tpu_torch.parallel.launch import GroupError, run_group
from falcon_r1cs_tpu_torch.pipeline import _batch_axis, stitch_segments
from falcon_r1cs_tpu_torch.utils.device import DeviceUnavailableError
from falcon_r1cs_tpu_torch.utils.profiling import device_trace, throughput
from falcon_r1cs_tpu_torch.witness import witness_engine, witness_engine_dual

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_rng = np.random.default_rng(20261017)


def _uniform(rows, n):
    return _rng.integers(0, Q, size=(rows, n)).astype(np.int32)


NTT_X = {n: _uniform(3, n) for n in (512, 1024)}
ENGINE = {512: tuple(_uniform(8, 512) for _ in range(3)),
          1024: tuple(_uniform(4, 1024) for _ in range(3))}
DUAL = (_rng.integers(-6144, 6145, size=(8, 512)).astype(np.int32),
        _uniform(8, 512), _uniform(8, 512))
SCHOOLBOOK = tuple(_uniform(8, 512) for _ in range(3))
MICROBATCH, N_MICRO = 3, 4
PP_X = _uniform(MICROBATCH * N_MICRO, 512)
BATCH_AXES = (4, 2, 1)
# (world, batch dim) of the DP-only engines' further meshes: (1, 2) at
# world 2, (4, 1) and (1, 4) at world 4
WHOLE_ROW_MESHES = ((2, 1), (4, 4), (4, 1))
WHOLE_ROW_INPUTS = {"dual": DUAL, "schoolbook": SCHOOLBOOK}


def _jobs(world):
    """Every check of one world size: (name, body, args)."""
    cases = [("facts", jobs.rank_facts, ())]
    cases += [(f"ntt{n}", jobs.ntt_job, (n, NTT_X[n])) for n in (512, 1024)]
    cases += [("pp", jobs.pp_job, (512, MICROBATCH, N_MICRO, PP_X)),
              ("dp", jobs.dp_job, (512, PP_X))]
    if world == 2:
        cases += [("dual", jobs.engine_job, ("dual", 512, 2, DUAL)),
                  ("schoolbook", jobs.engine_job, ("schoolbook", 512, 2, SCHOOLBOOK)),
                  ("sweep", scaling_sweep, (512, 2))]
    else:
        cases += [(f"engine{b}", jobs.engine_job, ("ntt", 512, b, ENGINE[512]))
                  for b in BATCH_AXES]
        cases += [("engine1024", jobs.engine_job, ("ntt", 1024, 1, ENGINE[1024]))]
        # the DP-only engines on a (2, 2) mesh: replicated over coeff
        cases += [("dual22", jobs.engine_job, ("dual", 512, 2, DUAL)),
                  ("schoolbook22", jobs.engine_job, ("schoolbook", 512, 2, SCHOOLBOOK))]
    cases += [(f"{kind}-b{b}", jobs.engine_job, (kind, 512, b, arrays))
              for w, b in WHOLE_ROW_MESHES if w == world
              for kind, arrays in WHOLE_ROW_INPUTS.items()]
    return cases


@pytest.fixture(scope="module")
def ranks():
    """{world: {name: rank 0's result}} from one gloo group a world size."""
    out = {}
    for world in (2, 4):
        cases = _jobs(world)
        results = run_group(jobs.run_all, world, "cpu",
                            [(body, args + ("cpu",)) for _, body, args in cases],
                            timeout_s=240)
        out[world] = {name: r for (name, _, _), r in zip(cases, results)}
    return out


def _devices(d):
    return np.asarray(jax.devices()[:d])


def _assert_segments_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("world", [2, 4])
def test_ntt_sharded_matches_jax_and_clear(ranks, world, n):
    """The coefficient-sharded NTT over D = world ranks equals the JAX
    package's ntt_sharded on D devices and the clear NTT."""
    got = ranks[world][f"ntt{n}"]
    fn = jax_ntt_sharded(Mesh(_devices(world), ("coeff",)), jax_params(n))
    assert np.array_equal(got, np.asarray(fn(NTT_X[n])))
    assert np.array_equal(got, ntt(NTT_X[n]))


@pytest.mark.parametrize("batch_axis", BATCH_AXES)
def test_sharded_engine_matches_jax(ranks, batch_axis):
    """World 4, every (batch, coeff) factorisation, n = 512, B = 8: the
    gathered segments equal JAX's sharded_engine on make_mesh(4,
    batch_axis) and its single-device jitted_engine."""
    got, _ = ranks[4][f"engine{batch_axis}"]
    want = jax_mesh.sharded_engine(512, jax_mesh.make_mesh(4, batch_axis))(*ENGINE[512])
    _assert_segments_equal(got, want)
    _assert_segments_equal(got, jitted_engine(512)(*ENGINE[512]))


def test_sharded_engine_1024_matches_jax(ranks):
    """Falcon-1024 on the coefficient-sharded (1, 4) mesh, B = 4."""
    got, _ = ranks[4]["engine1024"]
    want = jax_mesh.sharded_engine(1024, jax_mesh.make_mesh(4, 1))(*ENGINE[1024])
    _assert_segments_equal(got, want)
    _assert_segments_equal(got, jitted_engine(1024)(*ENGINE[1024]))


@pytest.mark.parametrize("case", [f"engine{b}" for b in BATCH_AXES] + ["engine1024"])
def test_sharded_engine_exchange_count(ranks, case):
    """The counterpart of test_sharded_engine_collective_schedule: a call
    of the engine on a coeff dim of D makes 2 log2(D) partner exchanges
    (log2(D) for each of the two hint NTTs), none at D = 1."""
    batch_axis = 1 if case == "engine1024" else int(case[len("engine"):])
    d_coeff = 4 // batch_axis
    _, calls = ranks[4][case]
    assert calls == 2 * (d_coeff.bit_length() - 1)


def test_sharded_engine_dual_matches_jax(ranks):
    got, calls = ranks[2]["dual"]
    mesh2 = jax_mesh.make_mesh(2, 2)
    _assert_segments_equal(got, jax_mesh.sharded_engine_dual(512, mesh2)(*DUAL))
    _assert_segments_equal(got, jitted_engine_dual(512)(*DUAL))
    assert calls == 0


def test_sharded_engine_schoolbook_matches_jax(ranks):
    got, calls = ranks[2]["schoolbook"]
    mesh2 = jax_mesh.make_mesh(2, 2)
    _assert_segments_equal(got, jax_mesh.sharded_engine_schoolbook(512, mesh2)(*SCHOOLBOOK))
    _assert_segments_equal(got, jitted_engine_schoolbook(512)(*SCHOOLBOOK))
    assert calls == 0


def test_sharded_engine_dual_coeff_mesh_matches_jax(ranks):
    """World 4 on a (2, 2) mesh, n = 512, B = 8: each coeff rank runs the
    whole dual engine on its batch row's gathered polynomials, and the
    segments, gathered over the batch dim only, equal JAX's
    sharded_engine_dual on make_mesh(4, batch_axis=2) (replicated over
    "coeff") and its jitted_engine_dual; no partner exchange."""
    got, calls = ranks[4]["dual22"]
    mesh22 = jax_mesh.make_mesh(4, batch_axis=2)
    _assert_segments_equal(got, jax_mesh.sharded_engine_dual(512, mesh22)(*DUAL))
    _assert_segments_equal(got, jitted_engine_dual(512)(*DUAL))
    assert calls == 0


def test_sharded_engine_schoolbook_coeff_mesh_matches_jax(ranks):
    """The schoolbook engine on the same (2, 2) mesh, n = 512, B = 8."""
    got, calls = ranks[4]["schoolbook22"]
    mesh22 = jax_mesh.make_mesh(4, batch_axis=2)
    _assert_segments_equal(got, jax_mesh.sharded_engine_schoolbook(512, mesh22)(*SCHOOLBOOK))
    _assert_segments_equal(got, jitted_engine_schoolbook(512)(*SCHOOLBOOK))
    assert calls == 0


@pytest.mark.parametrize("kind", sorted(WHOLE_ROW_INPUTS))
@pytest.mark.parametrize("world, batch_axis", WHOLE_ROW_MESHES)
def test_whole_row_engine_meshes_match_jax(ranks, world, batch_axis, kind):
    """The dual and schoolbook engines on the (1, 2) mesh at world 2 and
    the (4, 1) and (1, 4) meshes at world 4, n = 512, B = 8: the segments
    equal JAX's sharded_engine_{dual,schoolbook} on make_mesh(world,
    batch_axis) (replicated over "coeff") and its single-device jitted
    engine; no partner exchange."""
    got, calls = ranks[world][f"{kind}-b{batch_axis}"]
    arrays = WHOLE_ROW_INPUTS[kind]
    sharded = {"dual": jax_mesh.sharded_engine_dual,
               "schoolbook": jax_mesh.sharded_engine_schoolbook}[kind]
    single = {"dual": jitted_engine_dual, "schoolbook": jitted_engine_schoolbook}[kind]
    _assert_segments_equal(got, sharded(512, jax_mesh.make_mesh(world, batch_axis))(*arrays))
    _assert_segments_equal(got, single(512)(*arrays))
    assert calls == 0


@pytest.mark.parametrize("world", [2, 4])
def test_pp_ntt_matches_jax(ranks, world):
    """The GPipe conveyor over S = world ranks (at S = 4 the 9 stages of
    Falcon-512 split 3/2/2/2) equals the JAX pipeline and the clear NTT,
    with one exchange a schedule step: T + S - 1."""
    got, calls = ranks[world]["pp"]
    fn = jax_pp.pp_ntt(Mesh(_devices(world), ("stage",)), jax_params(512),
                       microbatch=MICROBATCH, n_micro=N_MICRO)
    assert np.array_equal(got, np.asarray(fn(PP_X)))
    assert np.array_equal(got, ntt(PP_X))
    assert calls == N_MICRO + world - 1


@pytest.mark.parametrize("log_n, stages", [(9, 4), (9, 2), (10, 8), (10, 3), (10, 4)])
def test_pp_stage_groups_match_jax(log_n, stages):
    """Uneven splits are front-loaded, as in the JAX package."""
    got = pipeline_pp._stage_groups(log_n, stages)
    assert got == jax_pp._stage_groups(log_n, stages)
    assert [l for a, b in got for l in range(a, b)] == list(range(log_n))


@pytest.mark.parametrize("world", [2, 4])
def test_dp_ntt_matches_jax_without_exchange(ranks, world):
    got, calls = ranks[world]["dp"]
    fn = jax_pp.dp_ntt(Mesh(_devices(world), ("stage",)), jax_params(512))
    assert np.array_equal(got, np.asarray(fn(PP_X)))
    assert calls == 0


def test_scaling_sweep_world_two(ranks):
    """One point a power of two of ranks, efficiency 1 at the first."""
    pts = ranks[2]["sweep"]
    assert [p.devices for p in pts] == [1, 2]
    assert all(p.witnesses_per_sec > 0 for p in pts)
    assert pts[0].efficiency == 1.0


@pytest.mark.parametrize("world", [2, 4])
def test_maybe_init_distributed_in_group(ranks, world):
    """Started with RANK and WORLD_SIZE (the launcher's environment), the
    process group spans that world; global_mesh(2) is (2, world / 2) over
    it, and host_local_batch gives a rank its 8 / world rows."""
    assert ranks[world]["facts"] == (True, 0, world, "0", str(world), (2, world // 2),
                                     8 // world)


def test_run_group_reports_a_failing_rank():
    """A batch that does not divide the mesh's batch dim raises in every
    rank; the parent raises GroupError with the rank's traceback."""
    arrays = tuple(a[:3] for a in ENGINE[512])
    with pytest.raises(GroupError, match="batch 3 not divisible by the batch dim 2"):
        run_group(jobs.engine_job, 2, "cpu", "ntt", 512, 2, arrays, "cpu", timeout_s=120)


def test_throughput_and_device_trace_on_cpu(tmp_path):
    """utils/profiling: a positive rate from the iteration-count slope, and
    a Chrome trace written for a profiled block."""
    x = torch.from_numpy(NTT_X[512])
    engine = witness_engine(512)
    rate, details = throughput(engine, (x, x, x), items_per_call=3, iters=(1, 3), trials=1)
    assert rate > 0 and details["rates"] == [rate]
    with device_trace(str(tmp_path), device="cpu") as prof:
        engine(x, x, x)
    assert prof.key_averages() and (tmp_path / "trace.json").stat().st_size > 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("launcher_env", [False, True])
def test_maybe_init_distributed_alone(launcher_env):
    """In a fresh process: without the launcher's environment a world of
    one; with RANK=0, WORLD_SIZE=1 and a MASTER_ADDR/PORT, that world."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    if launcher_env:
        env.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()))
    code = ("import torch.distributed as dist\n"
            "from falcon_r1cs_tpu_torch.parallel import maybe_init_distributed\n"
            "multi = maybe_init_distributed('cpu')\n"
            "print(multi, dist.get_world_size(), dist.get_rank(), dist.get_backend())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "1", "0", "gloo"]


def test_card_default_raises_without_card(monkeypatch):
    """The parallel entry points default to the card: without one they
    raise DeviceUnavailableError, before any process group or rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        make_mesh(2, 1)
    with pytest.raises(DeviceUnavailableError):
        dryrun_multichip(2)
    with pytest.raises(DeviceUnavailableError):
        run_group(jobs.run_all, 2, "cuda", [])
    assert not torch.distributed.is_initialized()


def test_stitch_dual_chunks_equals_whole_batch():
    """Re-stitching two dual-engine sub-batches puts every segment on its
    batch axis, the feature-first pointwise_vals (6, B, n) on axis 1: equal
    to one call on the whole batch."""
    engine = witness_engine_dual(512)
    sig, pk, hm = (torch.from_numpy(a[:4]) for a in DUAL)
    whole = engine(sig, pk, hm)
    stitched = stitch_segments([engine(sig[:2], pk[:2], hm[:2]),
                                engine(sig[2:], pk[2:], hm[2:])])
    assert sorted(stitched) == sorted(whole)
    for k in whole:
        assert torch.equal(stitched[k], whole[k]), k


def test_dual_limb_keys_follow_batch_axis():
    """The dual engine's segments with the batch on axis 1 are exactly
    _DUAL_LIMB_KEYS, those of the JAX package."""
    seg = witness_engine_dual(512)(*(torch.from_numpy(a[:1]) for a in DUAL))
    assert {k for k in seg if _batch_axis(k) == 1} == mesh._DUAL_LIMB_KEYS
    assert mesh._DUAL_LIMB_KEYS == jax_mesh._DUAL_LIMB_KEYS
