"""The port's semi-carry limb NTT (K8) against the JAX package, bit for bit.

Same numpy-seeded inputs through the JAX side and the port on the CPU:
the Pallas kernel of `tools/pallas_ntt_v3.py` in interpret mode (its semi
state captured at the `pallas_call`) against the plain version
`ntt_limb.ntt_semi`, the entry `ntt_with_hints_v3` against the tool's
entry, the port's hint NTT (K1's plain version) and the JAX package's
`ntt_with_hints`; the semi state's invariants; the 12-limb tables; the
wrapper's guards.  All integer arithmetic: every comparison is exact.  The
kernel itself is held against `ntt_semi` on a CUDA card in
test_torch_cuda.py.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import falcon_r1cs_tpu.ops.ntt_limb as jntt_limb
import falcon_r1cs_tpu.ops.pallas_ntt as pn
from falcon_r1cs_tpu import params as jparams
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q
from falcon_r1cs_tpu_torch.ops import cuda_ntt, ntt_limb, ntt_v3
from falcon_r1cs_tpu_torch.ops.limbs import limbs_to_ints

REPO = Path(__file__).resolve().parents[1]
SEMI_LO, SEMI_HI = -3, (1 << 16) + 2  # the tool's stated limb range


def _tool():
    """tools/pallas_ntt_v3.py, loaded by file path (not a package module)."""
    path = REPO / "tools" / "pallas_ntt_v3.py"
    spec = importlib.util.spec_from_file_location("pallas_ntt_v3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _redundant(semi):
    """(B,) bool: the rows whose semi state holds a limb outside [0, 2^16),
    where one parallel carry round and a sequential carry chain differ."""
    return ((semi < 0) | (semi > 0xFFFF)).flatten(2).any(2).any(0)


def _rows(params, batch, seed):
    """(batch, n) int32: random rows, then two rows whose semi state is
    redundant (picked from a seeded pool of 256), then one row of all 0 and
    one of all q - 1."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, Q, size=(256, params.n)).astype(np.int32)
    picked = _redundant(ntt_limb.ntt_semi(torch.from_numpy(pool), params))
    assert int(picked.sum()) >= 2
    x = np.concatenate([
        rng.integers(0, Q, size=(batch - 4, params.n)).astype(np.int32),
        pool[picked.numpy()][:2],
        np.zeros((1, params.n), np.int32),
        np.full((1, params.n), Q - 1, np.int32),
    ])
    return x


def _eq(jax_out, torch_out):
    j = np.array(jax_out)
    t = torch_out.cpu().numpy()
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert np.array_equal(j, t)


def _check_semi_state(semi, t, b):
    """Limbs in the tool's range, the top limb zero, and the value the semi
    state holds equal to t * q + b."""
    assert semi.dtype == torch.int32 and semi.shape[0] == ntt_limb.SEMI_LIMBS
    assert int(semi.min()) >= SEMI_LO and int(semi.max()) <= SEMI_HI
    assert not semi[-1].any()
    value = limbs_to_ints(semi.numpy())
    assert (value == limbs_to_ints(t.numpy()) * Q + b.numpy().astype(object)).all()


def test_semi_matches_pallas_v3_interpret(monkeypatch):
    """The plain version equals the Pallas kernel's semi state, captured at
    its pallas_call in interpret mode, and the entry equals the tool's
    (t, b): n = 512, B = 8, two grid steps of 4 rows."""
    v3 = _tool()
    orig = pl.pallas_call
    captured = []

    def capturing(*a, **k):
        call = orig(*a, interpret=True, **k)

        def run(*args):
            out = call(*args)
            captured.append(np.asarray(out))
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", capturing)
    v3._build.cache_clear()
    try:
        x = _rows(FALCON_512, 8, 71)
        t_k, b_k = v3.ntt_with_hints_pallas_v3(x, jparams.FALCON_512, block=4)
    finally:
        v3._build.cache_clear()
    assert len(captured) == 1
    _eq(captured[0], ntt_limb.ntt_semi(torch.from_numpy(x), FALCON_512))
    t, b = ntt_v3.ntt_with_hints_v3(torch.from_numpy(x), FALCON_512)
    _eq(t_k, t)
    _eq(b_k, b)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_v3_matches_k1_and_jax(params):
    """ntt_with_hints_v3 on a CPU tensor equals the port's hint NTT (K1's
    plain version) and the JAX package's ntt_with_hints, edge rows
    included."""
    x = _rows(params, 8, 72)
    t, b = ntt_v3.ntt_with_hints_v3(torch.from_numpy(x), params)
    t_k1, b_k1 = cuda_ntt.ntt_with_hints_cuda(torch.from_numpy(x), params)
    assert torch.equal(t, t_k1) and torch.equal(b, b_k1)
    jp = jparams.get_params(params.n)
    t_j, b_j = jax.jit(lambda a: jntt_limb.ntt_with_hints(a, jp))(x)
    _eq(t_j, t)
    _eq(b_j, b)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_semi_state_invariants(params):
    """The semi state at both n: in range, top limb zero, value t * q + b;
    and redundant exactly on the two picked rows, so a sequential carry
    chain would have given other limbs there."""
    x = torch.from_numpy(_rows(params, 8, 73))
    semi = ntt_v3.ntt_semi_cuda(x, params)
    _check_semi_state(semi, *ntt_v3.ntt_with_hints_v3(x, params))
    assert _redundant(semi)[4:6].all() and not _redundant(semi)[6:].any()


@pytest.mark.parametrize("seed, edge", [(75, 0.0), (76, 0.5), (77, 0.9), (78, 1.0)])
def test_semi_state_edge_mix(seed, edge):
    """Rows with a share `edge` of their coefficients drawn from {0, 1,
    q - 1}: the same invariants, and the same (t, b) as K1's plain
    version."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=(2, FALCON_512.n)).astype(np.int32)
    mask = rng.random(x.shape) < edge
    x[mask] = rng.choice(np.array([0, 1, Q - 1], dtype=np.int32), size=int(mask.sum()))
    x = torch.from_numpy(x)
    t, b = ntt_v3.ntt_with_hints_v3(x, FALCON_512)
    _check_semi_state(ntt_limb.ntt_semi(x, FALCON_512), t, b)
    t_k1, b_k1 = ntt_limb.ntt_with_hints(x, FALCON_512)
    assert torch.equal(t, t_k1) and torch.equal(b, b_k1)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_semi_tables_match_tool(params):
    """The kernel's tables: K1's twiddles and the bound limbs padded to 12
    by a zero column, as the tool pads the JAX package's."""
    tab = cuda_ntt._semi_tables(params.n, torch.device("cpu"))
    tw, _, bounds = pn._stage_tables(jparams.get_params(params.n))
    assert np.array_equal(tab["tw"].numpy(), tw)
    want = np.pad(bounds, ((0, 0), (0, _tool().V3_LIMBS - bounds.shape[1])))
    assert np.array_equal(tab["bounds"].numpy(), want)
    assert tab["bounds"].shape == (params.log_n + 1, ntt_limb.SEMI_LIMBS)
    assert all(v.dtype == torch.int32 and v.is_contiguous() for v in tab.values())


def test_semi_wrapper_rejects_bad_inputs():
    """A meta tensor, a wrong dtype, a wrong width and a non-contiguous
    input each raise; a CPU tensor takes the plain version and launches
    nothing."""
    good = torch.from_numpy(_rows(FALCON_512, 4, 74))
    for bad in (
        torch.zeros((2, 512), dtype=torch.int32, device="meta"),
        good.long(),
        good[:, :256].contiguous(),
        torch.zeros((512, 2), dtype=torch.int32).t(),
    ):
        with pytest.raises(ValueError):
            ntt_v3.ntt_semi_cuda(bad, FALCON_512)
        with pytest.raises(ValueError):
            ntt_v3.ntt_with_hints_v3(bad, FALCON_512)
    before = ntt_v3.ntt_semi_cuda.launches
    assert torch.equal(ntt_v3.ntt_semi_cuda(good, FALCON_512),
                       ntt_limb.ntt_semi(good, FALCON_512))
    assert ntt_v3.ntt_semi_cuda.launches == before
    assert ntt_v3.ntt_semi_cuda.plain is ntt_limb.ntt_semi
