"""The port's device ops against the JAX package, bit for bit.

Same numpy-seeded inputs through the JAX function and its torch
counterpart: mod-q and limb arithmetic, the clear NTT, the plain versions
of the two hint kernels (also against the Pallas kernels in interpret
mode) and the kernels' host tables.  All of it is integer arithmetic:
every comparison is exact.  The kernels themselves are held against their
plain versions on a CUDA card in test_torch_cuda.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import falcon_r1cs_tpu.ops.limbs as jlimbs
import falcon_r1cs_tpu.ops.modq as jmodq
import falcon_r1cs_tpu.ops.ntt_limb as jntt_limb
import falcon_r1cs_tpu.ops.pallas_ntt as pn
from falcon_r1cs_tpu.falcon.ntt import intt_jax, ntt_jax
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q
from falcon_r1cs_tpu_torch.falcon import intt, intt_torch, ntt, ntt_torch
from falcon_r1cs_tpu_torch.ops import _build, cuda_ntt, limbs, modq, ntt_limb

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    """numpy or JAX array -> CPU torch tensor (copying: JAX arrays are
    read-only)."""
    return torch.from_numpy(np.array(a))


def _eq(jax_out, torch_out):
    j = np.array(jax_out)
    t = torch_out.cpu().numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert np.array_equal(j, t)


def test_modq_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.integers(0, 1 << 30, size=4096),
        [0, 1, Q - 1, Q, Q + 1, (1 << 30) - 1, (1 << 30) - Q],
        np.arange(0, 40 * Q, 97),
    ]).astype(np.int32)
    for j, t in zip(jmodq.divmod_q(jnp.asarray(x)), modq.divmod_q(_t(x))):
        _eq(j, t)
    _eq(jmodq.mod_q(jnp.asarray(x)), modq.mod_q(_t(x)))
    a = rng.integers(0, Q, size=4096).astype(np.int32)
    b = rng.integers(0, Q, size=4096).astype(np.int32)
    a[:2], b[:2] = Q - 1, Q - 1
    for jf, tf in (
        (jmodq.mul_mod_q, modq.mul_mod_q),
        (jmodq.add_mod_q, modq.add_mod_q),
        (jmodq.sub_mod_q, modq.sub_mod_q),
    ):
        _eq(jf(jnp.asarray(a), jnp.asarray(b)), tf(_t(a), _t(b)))


def test_limbs_match_jax():
    rng = np.random.default_rng(2)
    vals = np.array(
        [0, 1, Q, 2**160 - 1, 2**175 + 12345]
        + [int(v) << 100 for v in rng.integers(0, 1 << 60, size=8)],
        dtype=object,
    )
    limbs_np = limbs.ints_to_limbs(vals)
    assert np.array_equal(limbs_np, jlimbs.ints_to_limbs(vals))
    assert list(limbs.limbs_to_ints(limbs_np)) == list(vals)
    assert np.array_equal(limbs.int_to_limbs(2**150 + 7), jlimbs.int_to_limbs(2**150 + 7))
    with pytest.raises(OverflowError):
        limbs.int_to_limbs(2**176)

    # redundant limbs with a nonnegative total: normalized limbs plus a
    # signed perturbation that a carry of the neighbour limb cancels
    base = rng.integers(0, 1 << 16, size=(11, 3, 64)).astype(np.int32)
    base[-1] = rng.integers(1, 1 << 14, size=(3, 64))
    d = rng.integers(-(1 << 12), 1 << 12, size=(10, 3, 64)).astype(np.int32)
    red = base.copy()
    red[:-1] += d << 16
    red[1:] -= d
    _eq(jlimbs.normalize(jnp.asarray(red)), limbs.normalize(_t(red)))

    small = rng.integers(0, 1 << 16, size=(3, 64)).astype(np.int32)
    _eq(jlimbs.from_small(jnp.asarray(small)), limbs.from_small(_t(small)))
    for j, t in zip(jlimbs.divmod_q(jnp.asarray(base)), limbs.divmod_q(_t(base))):
        _eq(j, t)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_ntt_matches_jax(params):
    rng = np.random.default_rng(3)
    x = rng.integers(0, Q, size=(4, params.n)).astype(np.int32)
    _eq(ntt_jax(jnp.asarray(x), params.n), ntt_torch(_t(x), params.n))
    _eq(intt_jax(jnp.asarray(x), params.n), intt_torch(_t(x), params.n))
    assert np.array_equal(ntt_torch(_t(x), params.n).numpy(), ntt(x))
    assert np.array_equal(intt_torch(_t(x), params.n).numpy(), intt(x))
    # int16 uploads (the pipeline's planes) give the same NTT
    _eq(ntt_jax(jnp.asarray(x), params.n), ntt_torch(_t(x.astype(np.int16)), params.n))


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_plain_hints_match_jax(params):
    """K1's plain version against ntt_limb.ntt_with_hints, K2's against
    intt_jax followed by it, B=4."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, Q, size=(4, params.n)).astype(np.int32)
    x[0, :3] = [0, Q - 1, Q - 1]
    t_j, b_j = jax.jit(lambda a: jntt_limb.ntt_with_hints(a, params))(x)
    t_p, b_p = ntt_limb.ntt_with_hints(_t(x), params)
    _eq(t_j, t_p)
    _eq(b_j, b_p)

    v_j = jax.jit(lambda w: intt_jax(w, params.n))(x)
    vt_j, vb_j = jax.jit(lambda a: jntt_limb.ntt_with_hints(a, params))(v_j)
    vt_p, vb_p, v_p = ntt_limb.intt_with_hints(_t(x), params)
    _eq(v_j, v_p)
    _eq(vt_j, vt_p)
    _eq(vb_j, vb_p)


@pytest.fixture()
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k)
    )
    pn._build.cache_clear()
    pn._build_vchain.cache_clear()
    yield
    pn._build.cache_clear()
    pn._build_vchain.cache_clear()


def test_plain_hints_match_pallas_interpret(interpret_mode):
    """The plain versions against the Pallas kernels K1 and K2 themselves,
    run in interpret mode at n=512."""
    params = FALCON_512
    rng = np.random.default_rng(5)
    x = rng.integers(0, Q, size=(4, params.n)).astype(np.int32)
    t_k, b_k = pn.ntt_with_hints_pallas(x, params, block=4)
    t_p, b_p = cuda_ntt.ntt_with_hints_cuda.plain(_t(x), params)
    _eq(t_k, t_p)
    _eq(b_k, b_p)
    t_k, b_k, v_k = pn.intt_ntt_hints_pallas(x, params, block=4)
    t_p, b_p, v_p = cuda_ntt.intt_ntt_hints_cuda.plain(_t(x), params)
    _eq(t_k, t_p)
    _eq(b_k, b_p)
    _eq(v_k, v_p)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_kernel_tables_match_jax(params):
    tab = cuda_ntt.tables_from_params(params, "cpu")
    tw, _, bounds = pn._stage_tables(params)
    assert np.array_equal(tab["tw"].numpy(), tw)
    assert np.array_equal(tab["bounds"].numpy(), bounds)
    # the hint kernels' (n,) root tables, read at the index the kernels
    # compute for stage l and position j, are the JAX package's
    # per-position tables (the INTT's in the 2^16 Montgomery domain)
    j = np.arange(params.n)
    itw = pn._inv_stage_tables(params)
    for l in range(params.log_n):
        at = (1 << l) + (j >> (params.log_n - l))
        assert np.array_equal(tab["roots"].numpy()[at], tw[l])
        assert np.array_equal(tab["inv_roots"].numpy()[at], itw[l])
    assert cuda_ntt._active_limbs(params) == pn._active_limbs(params)
    assert all(t.dtype == torch.int32 for t in tab.values())


def test_wrappers_take_plain_version_on_cpu():
    """On a CPU tensor each wrapper runs its plain version and launches
    nothing; the fused and unfused v chains agree."""
    params = FALCON_512
    rng = np.random.default_rng(6)
    x = _t(rng.integers(0, Q, size=(2, params.n)).astype(np.int32))
    before = (
        cuda_ntt.ntt_with_hints_cuda.launches,
        cuda_ntt.intt_ntt_hints_cuda.launches,
        _build.add_one.launches,
    )
    t, b = ntt_limb.ntt_hints(x, params)
    t_ref, b_ref = ntt_limb.ntt_with_hints(x, params)
    assert torch.equal(t, t_ref) and torch.equal(b, b_ref)
    fused = ntt_limb.intt_then_hints(x, params, fused_intt=True)
    plain = ntt_limb.intt_then_hints(x, params, fused_intt=False)
    for a, c in zip(fused, plain):
        assert torch.equal(a, c)
    assert torch.equal(_build.add_one(x), x + 1)
    after = (
        cuda_ntt.ntt_with_hints_cuda.launches,
        cuda_ntt.intt_ntt_hints_cuda.launches,
        _build.add_one.launches,
    )
    assert before == after


def test_kernel_library_key_follows_sources():
    """The build cache is keyed by the sources and flags; every CUDA
    source is under the package's csrc/."""
    path = _build.library_path()
    assert path.parent == REPO / "build" / "kernels"
    assert path == _build.library_path()
    assert sorted(p.name for p in _build._CSRC.glob("*.cu")) == [
        "fq_mont.cu", "msm_bucket.cu", "msm_recode.cu", "ntt_hints.cu", "ntt_v3.cu",
        "schoolbook.cu",
    ]
    for name in ("schoolbook_prods_launch", "mont_mul_launch", "point_add_launch",
                 "point_add_aff_launch", "ntt_semi_launch", "bucket_level_launch"):
        assert name in _build._ARGTYPES


def test_kernel_library_key_follows_headers(tmp_path, monkeypatch):
    """A change to a shared header (csrc/*.cuh) gives the library a new
    key, as a change to a source does."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in list(_build._CSRC.glob("*.cu")) + list(_build._CSRC.glob("*.cuh")):
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", csrc)
    key = _build.library_path()
    header = csrc / "carry_chain.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.library_path() != key


def test_port_imports_no_jax():
    """Importing every module of the port loads no JAX and no module of
    the JAX package."""
    mods = []
    for path in sorted((REPO / "falcon_r1cs_tpu_torch").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'falcon_r1cs_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15

