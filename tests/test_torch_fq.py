"""The port's Fq arithmetic and the plain versions of the point-add kernels
against the JAX package, limb for limb.

Inputs are made from a numpy seed; the JAX side runs on the CPU (its XLA
`fq_mont` and `tpu_msm.point_add`, and the Pallas affine-add kernel K6 in
interpret mode).  The port's tensors are limb-major (35, m), the JAX
package's (m, 35): the tests transpose.  Everything is integer arithmetic:
tolerance 0.  The CUDA kernels are held against these plain versions on a
card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.ops.fq_mont as jfq
import falcon_r1cs_tpu.ops.pallas_fq as pfq
import falcon_r1cs_tpu.snark.tpu_msm as tm
from falcon_r1cs_tpu_torch.ops import fq
from falcon_r1cs_tpu_torch.ops import fq_mont as tfq
from falcon_r1cs_tpu_torch.snark import native_backend as nb

rng = np.random.default_rng(20261016)


def _rand_fq(r):
    return tfq.int_to_limbs(
        [int.from_bytes(rng.bytes(47), "little") % tfq.Q381 for _ in range(r)]
    )


def _t(rows):
    """(m, 35) rows -> (35, m) limb-major torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(rows).T))


def _rows(t):
    return t.numpy().T


def test_constants_match_jax():
    assert np.array_equal(tfq.Q_LIMBS, jfq.Q_LIMBS)
    assert np.array_equal(tfq.MU_LIMBS, jfq.MU_LIMBS)
    assert np.array_equal(tfq._CARRY_W, jfq._CARRY_W)
    assert np.array_equal(tfq._ALPHA_W, jfq._ALPHA_W)
    assert np.array_equal(tfq._CRT_PRIMES, jfq._CRT_PRIMES)
    assert np.array_equal(tfq._CRT_W, jfq._CRT_W)
    assert np.array_equal(tfq._CRT_RECIP, jfq._CRT_RECIP)
    assert (tfq.R2, tfq.MU) == (jfq.R2, jfq.MU)


def test_mont_mul_and_chain_match_jax():
    a, b = _rand_fq(256), _rand_fq(256)
    want = jfq.mont_mul(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(_rows(tfq.mont_mul(_t(a), _t(b))), np.asarray(want))
    for _ in range(2):
        want = jfq.mont_mul(want, jnp.asarray(b))
    got = fq.mont_mul_cuda(_t(a), _t(b), 3)  # a CPU tensor takes the plain chain
    assert np.array_equal(_rows(got), np.asarray(want))


def test_conversions_add_sub_match_jax():
    a, b = _rand_fq(256), _rand_fq(256)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert np.array_equal(_rows(tfq.to_mont(_t(a))), np.asarray(jfq.to_mont(ja)))
    assert np.array_equal(_rows(tfq.from_mont(_t(a))), np.asarray(jfq.from_mont(ja)))
    assert np.array_equal(_rows(tfq.add_mod(_t(a), _t(b))), np.asarray(jfq.add_mod(ja, jb)))
    assert np.array_equal(_rows(tfq.sub_mod(_t(a), _t(b))), np.asarray(jfq.sub_mod(ja, jb)))


def test_is_zero_mod_q_matches_jax():
    """Relaxed differences: one in three is a value minus itself under
    another representative (zero mod q), the rest are not."""
    a, b = _rand_fq(256), _rand_fq(256)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    z = np.array(jfq.sub_mod(ja, jb))
    x = jfq.mont_mul(ja, jb)
    same = jfq.sub_mod(jfq.add_mod(x, ja), jfq.add_mod(ja, x))
    z[::3] = np.asarray(same)[::3]
    want = np.asarray(jfq.is_zero_mod_q(jnp.asarray(z)))
    got = tfq.is_zero_mod_q(_t(z)).numpy()
    assert np.array_equal(got, want)
    assert want[::3].all() and not want[1::3].any()
    assert np.array_equal(
        tfq.eq_mod_q(_t(a), _t(a)).numpy(), np.asarray(jfq.eq_mod_q(ja, ja))
    )


def _path_rows(R, affine: bool):
    """Montgomery points and a second operand hitting every select path:
    rows 0:64 doubling, 64:96 P + (-P), 96:128 inf1, 128:160 inf2, the
    rest the chord (tests/test_pallas_fq.py's rows)."""
    seeds = [int(s) for s in rng.integers(1, 2**31, R)]
    arr = nb.g1_fixed_base_batch(seeds)
    Xs, Ys, _ = tm._points_std_limbs(arr, R)
    X = np.asarray(jfq.to_mont(Xs))
    Y = np.asarray(jfq.to_mont(Ys))
    Z = np.broadcast_to(tfq.ONE_MONT_LIMBS, (R, tfq.NL)).copy()
    perm = rng.permutation(R)
    X2, Y2, Z2 = X[perm].copy(), Y[perm].copy(), Z.copy()
    X2[:96] = X[:96]
    Y2[:64] = Y[:64]
    Y2[64:96] = np.asarray(jfq.sub_mod(jnp.zeros_like(Y[64:96]), jnp.asarray(Y[64:96])))
    inf1 = np.zeros(R, bool)
    inf1[96:128] = True
    inf2 = np.zeros(R, bool)
    inf2[128:160] = True
    if affine:
        return (X, Y, inf1), (X2, Y2, inf2)
    return (X, Y, Z, inf1), (X2, Y2, Z2, inf2)


def _port_point(pt):
    return tuple(_t(c) for c in pt[:-1]) + (torch.from_numpy(pt[-1]),)


def test_point_add_plain_matches_jax_all_paths():
    """Plain K5 (`ops.fq.point_add`) == tpu_msm.point_add on the chord,
    doubling, P + (-P) and infinity rows, limb for limb."""
    p1, p2 = _path_rows(256, affine=False)
    want = tm.point_add(
        tuple(jnp.asarray(c) for c in p1), tuple(jnp.asarray(c) for c in p2)
    )
    got = fq.point_add_cuda(_port_point(p1), _port_point(p2))  # plain on CPU
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(_rows(g), np.asarray(w))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].numpy()[64:96].all()


def test_point_add_aff_plain_matches_pallas_kernel():
    """Plain K6 (`ops.fq.point_add_aff`) == the Pallas affine-add kernel in
    interpret mode, limb for limb, on every select path."""
    R = pfq.BLK
    a1, a2 = _path_rows(R, affine=True)

    def blocks(pt):
        return (pfq.to_blocks(jnp.asarray(pt[0])), pfq.to_blocks(jnp.asarray(pt[1])),
                pfq.flags_to_blocks(jnp.asarray(pt[2])))

    gx, gy, gz, ginf = pfq.point_add_aff_pallas(blocks(a1), blocks(a2), interpret=True)
    got = fq.point_add_aff(_port_point(a1), _port_point(a2))
    for g, w in zip(got[:3], (gx, gy, gz)):
        assert np.array_equal(_rows(g), np.asarray(pfq.from_blocks(w)))
    assert np.array_equal(got[3].numpy(), np.asarray(pfq.flags_from_blocks(ginf)))
    assert got[3].numpy()[64:96].all() and not got[3].numpy()[160:].any()


def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing; a bad
    depth raises."""
    a = _t(_rand_fq(8))
    before = (fq.mont_mul_cuda.launches, fq.point_add_cuda.launches,
              fq.point_add_aff_cuda.launches)
    assert torch.equal(fq.mont_mul_cuda(a, a, 2), tfq.mont_mul_chain(a, a, 2))
    flags = torch.zeros(8, dtype=torch.bool)
    fq.point_add_cuda((a, a, a, flags), (a, a, a, flags))
    fq.point_add_aff_cuda((a, a, flags), (a, a, flags))
    assert (fq.mont_mul_cuda.launches, fq.point_add_cuda.launches,
            fq.point_add_aff_cuda.launches) == before
    with pytest.raises(ValueError):
        fq.mont_mul_cuda(a, a, 0)


def test_point_add_aff_equals_point_add_in_value():
    """Plain K6 and plain K5 with Z = one give the same infinity flags and
    the same normalized affine points, though not the same limbs (the
    contract of the JAX package's affine kernel)."""
    from falcon_r1cs_tpu_torch.snark.gpu_msm import _jac_mont_to_affine

    p1, p2 = _path_rows(256, affine=False)
    a1, a2 = (p1[0], p1[1], p1[3]), (p2[0], p2[1], p2[3])
    got = fq.point_add_aff(_port_point(a1), _port_point(a2))
    want = fq.point_add(_port_point(p1), _port_point(p2))
    assert torch.equal(got[3], want[3])
    g = [_rows(c) for c in got[:3]]
    w = [_rows(c) for c in want[:3]]
    for i in np.flatnonzero(~got[3].numpy()):
        assert _jac_mont_to_affine(*(c[i] for c in g)) == _jac_mont_to_affine(*(c[i] for c in w)), i
