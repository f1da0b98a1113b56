"""The port's sharded CRT check, sharded G1 MSM and dry run against the
JAX package, bit for bit.

The port runs in gloo groups of 2 and 4 CPU processes spawned by
`parallel.launch.run_group` (one group a world size, a module-scoped
fixture); the JAX package in this test process, on its virtual CPU
devices.  Verdicts and points are compared for equality, and the row
partition of the sharded check against a numpy transcription of the JAX
package's (falcon_r1cs_tpu/parallel/sat_check.py:199-226).
"""

import numpy as np
import pytest

from falcon_r1cs_tpu import FalconNTTVerificationCircuit as JaxCircuit
from falcon_r1cs_tpu.falcon import make_instance as jax_make_instance
from falcon_r1cs_tpu.params import FALCON_512 as JAX_FALCON_512
from falcon_r1cs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from falcon_r1cs_tpu.parallel.sat_check import ResidueSystem as JaxResidueSystem
from falcon_r1cs_tpu.r1cs import ConstraintSystem as JaxConstraintSystem
from falcon_r1cs_tpu.r1cs.coo import CompiledR1CS as JaxCompiledR1CS
from falcon_r1cs_tpu.snark import bls12_381 as jax_bls
from falcon_r1cs_tpu.snark import msm as jax_msm
from falcon_r1cs_tpu_torch import FALCON_512, FalconNTTVerificationCircuit, compile_circuit
from falcon_r1cs_tpu_torch.entry import dryrun_multichip
from falcon_r1cs_tpu_torch.falcon import make_instance
from falcon_r1cs_tpu_torch.parallel import ResidueSystem, jobs
from falcon_r1cs_tpu_torch.parallel.launch import run_group
from falcon_r1cs_tpu_torch.parallel.sat_check import row_partition, shard_coo
from falcon_r1cs_tpu_torch.snark import bls12_381 as bls
from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend
from falcon_r1cs_tpu_torch.snark.points import G1Array

SEED, BUMP_AT = 7, 5555  # the instance; the assignment value bumped by one
MSM_WINDOW = 4


def _msm_inputs():
    """40 points (not a multiple of 8: the shards pad), one at infinity,
    one zero scalar (tests/test_tpu_msm.py:168-186)."""
    rng = np.random.default_rng(20261017)
    gen = bls.g1_from_affine(bls.G1_GEN)
    pts = [bls.g1_to_affine(bls.g1_mul(gen, int(k))) for k in rng.integers(1, 501, 40)]
    pts[11] = None
    scalars = [int.from_bytes(rng.bytes(32), "little") % bls.R for _ in range(40)]
    scalars[7] = 0
    return pts, scalars


MSM_POINTS, MSM_SCALARS = _msm_inputs()
# r - 1 on every point but the zero scalar's
MSM_TOP = [0 if s == 0 else bls.R - 1 for s in MSM_SCALARS]
FULL_WIDTH = {"random": MSM_SCALARS, "r-1": MSM_TOP}
# windows 3 and 5 divide 255: the top window carries out of ceil(255 / w)
# windows on most scalars below r; 4 and 12 leave it room.  Window 12
# (2049 buckets, ~17 s a shard on the CPU) runs on r - 1 only.
MSM_CASES = [(w, name) for w in (3, 4, 5) for name in sorted(FULL_WIDTH)] + [(12, "r-1")]


@pytest.fixture(scope="module")
def ranks():
    """{world: {case: rank 0's result}}: the sharded check ("sat") and the
    sharded MSM over the 40 points at each (window, FULL_WIDTH scalars) of
    MSM_CASES, at 2 and 4 ranks."""
    out = {}
    arr = G1Array.from_affine_list(MSM_POINTS)
    for world in (2, 4):
        cases = {"sat": (jobs.sat_job, (SEED, BUMP_AT, "cpu"))}
        for window, name in MSM_CASES:
            cases[window, name] = (jobs.msm_job, (arr, FULL_WIDTH[name], window, "cpu"))
        results = run_group(jobs.run_all, world, "cpu", list(cases.values()), timeout_s=240)
        out[world] = dict(zip(cases, results))
    return out


@pytest.fixture(scope="module")
def jax_assignments():
    """The JAX package's compiled system and [valid, bumped] assignments
    of the same instance."""
    inst = jax_make_instance(np.random.default_rng(SEED), JAX_FALCON_512)
    cs = JaxConstraintSystem()
    JaxCircuit.build_circuit(inst).generate_constraints(cs)
    good = cs.full_assignment()
    bad = list(good)
    bad[BUMP_AT] += 1
    return JaxCompiledR1CS.from_cs(cs), np.asarray([good, bad], dtype=object)


@pytest.mark.parametrize("world", [2, 4])
def test_check_device_sharded_matches_jax(ranks, jax_assignments, world):
    """The row-sharded check over `world` ranks: the valid assignment True,
    the bumped one False, equal to JAX's check_device_sharded on `world`
    devices."""
    compiled, assign = jax_assignments
    rs = JaxResidueSystem(compiled)
    want = rs.check_device_sharded(rs.witness_residues(assign),
                                   jax_make_mesh(world, batch_axis=world), axis="batch")
    assert ranks[world]["sat"] == [True, False] == np.asarray(want).tolist()


@pytest.fixture(scope="module")
def port_system():
    inst = make_instance(np.random.default_rng(SEED), FALCON_512)
    return ResidueSystem(compile_circuit(FalconNTTVerificationCircuit, inst, cache=False),
                         "cpu")


def _jax_partition(rs, D):
    """sat_check.py:199-226 of the JAX package, transcribed in numpy over
    the port's host tables: the row bounds and the padded COO shards."""
    nc = rs.compiled.num_constraints
    a_rows = rs.host_tables["a"][0]
    row_bounds = [0]
    for d in range(1, D):
        if len(a_rows):
            row_bounds.append(int(a_rows[len(a_rows) * d // D]))
        else:
            row_bounds.append(nc * d // D)
    row_bounds.append(nc)
    for d in range(1, len(row_bounds)):
        row_bounds[d] = max(row_bounds[d], row_bounds[d - 1])

    def shard(rows, cols, res):
        splits = [np.nonzero((rows >= row_bounds[d]) & (rows < row_bounds[d + 1]))[0]
                  for d in range(D)]
        max_len = max(max(len(s) for s in splits), 1)
        r_out = np.full((D, max_len), nc, dtype=np.int32)
        c_out = np.zeros((D, max_len), dtype=np.int32)
        v_out = np.zeros((D, len(rs.primes), max_len), dtype=np.int32)
        for d, s in enumerate(splits):
            r_out[d, : len(s)] = rows[s]
            c_out[d, : len(s)] = cols[s]
            v_out[d, :, : len(s)] = res[:, s]
        return r_out, c_out, v_out

    return row_bounds, {w: shard(*rs.host_tables[w]) for w in ("a", "b", "c")}


@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_row_partition_matches_jax_transcription(port_system, D):
    """row_partition and shard_coo equal the transcription, and every
    constraint's A, B and C entries land on one rank."""
    nc = port_system.compiled.num_constraints
    bounds = row_partition(port_system.host_tables["a"][0], nc, D)
    want_bounds, want = _jax_partition(port_system, D)
    assert bounds == want_bounds
    assert bounds[0] == 0 and bounds[-1] == nc and bounds == sorted(bounds)
    for which, coo in port_system.host_tables.items():
        for got, expect in zip(shard_coo(*coo, bounds, nc), want[which]):
            assert np.array_equal(got, expect), which
        rows = shard_coo(*coo, bounds, nc)[0]
        for d in range(D):
            real = rows[d][rows[d] < nc]
            assert ((real >= bounds[d]) & (real < bounds[d + 1])).all()
        assert (rows < nc).sum() == len(coo[0])


def test_msm_sharded_matches_single_and_host(ranks):
    """g1_msm_gpu_sharded over 2 ranks (shards of 32 and 8 points) equals
    g1_msm_gpu on one device and the JAX package's host MSM."""
    got = ranks[2][MSM_WINDOW, "random"]
    arr = G1Array.from_affine_list(MSM_POINTS)
    assert got == gpu_msm.g1_msm_gpu(arr, MSM_SCALARS, MSM_WINDOW, device="cpu")
    jac = [jax_bls.g1_from_affine(p) for p in MSM_POINTS]
    assert got == jax_bls.g1_to_affine(jax_msm.g1_msm(jac, MSM_SCALARS))
    assert got is not None


@pytest.mark.parametrize("window, scalars", MSM_CASES)
@pytest.mark.parametrize("world", [2, 4])
def test_msm_sharded_full_width_matches_host(ranks, world, window, scalars):
    """g1_msm_gpu_sharded over 2 and 4 ranks (shards of 32 + 8, and 16 +
    16 + 8 + none) at windows 3 and 5, which divide 255, and 4, on r - 1
    and on random scalars below r, and at 12 on r - 1: equal to the JAX package's host
    MSM, which its g1_msm_tpu_sharded returns, and to the port's native C.
    Each rank recodes to 255 // w + 1 windows, so no top window carries
    out (at ceil(255 / w) windows w = 3 and 5 raised the recode's
    overflow)."""
    got = ranks[world][window, scalars]
    sc = FULL_WIDTH[scalars]
    jac = [jax_bls.g1_from_affine(p) for p in MSM_POINTS]
    want = jax_bls.g1_to_affine(jax_msm.g1_msm(jac, sc))
    assert got == want and want is not None
    assert got == native_backend.g1_msm(G1Array.from_affine_list(MSM_POINTS), sc)


def test_dryrun_multichip_cpu():
    """dryrun_multichip(4) over gloo: the (2, 2) and (4, 1) engines, the
    dual and schoolbook engines and the sharded CRT check, each bit-equal
    to the single-device engine inside the ranks."""
    assert dryrun_multichip(4, device="cpu") == [
        "ntt DP+SP", "ntt DP", "dual DP", "schoolbook DP", "sharded CRT"]
