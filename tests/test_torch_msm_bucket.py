"""The G1 MSM's bucket reduction (ops/msm_bucket.py, snark/gpu_msm.py
`_bucket_reduce_flat`) on the CPU: the port's plain merge levels against
the JAX package's wide tree in its "limb" bank layout
(`tpu_msm_blocks._bucket_reduce_flat`), bucket planes and flags by value,
on digit runs that split segments, all-zero digits, one key a window,
tiled points that force doublings and P + (-P), and three patterns aimed
at the bucket writes: a witness's digits (mostly 0 and 1, the top
windows all zero), runs of exactly a node's size (one level closes every
lane) and three keys a window (the root writes three buckets in every
window); every bucket written once over the tree; the Montgomery one and
the lanes-a-CTA split compiled into csrc/msm_bucket.cu.

Both trees add with the port's plain K5 and K6 (`gpu_msm._add`,
`_aff_add`), handed to the JAX function as its `add` and `aff_add`, so
what is compared is the tree around the adds: the selects, the keys and
the bank writes.  The adds themselves are held against the JAX package in
tests/test_torch_fq.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.snark.tpu_msm_blocks as tmb
from falcon_r1cs_tpu_torch.ops import fq_check, fq_mont, msm_bucket
from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend

CSRC = Path(__file__).resolve().parents[1] / "falcon_r1cs_tpu_torch" / "csrc" / "msm_bucket.cu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread (as in tests/test_torch_msm.py: the
    plain adds are many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def limb_bank(monkeypatch):
    """The JAX engine's "limb" bucket bank, read at trace time: the jitted
    window sums are cleared before and after."""
    monkeypatch.setenv("FALCON_R1CS_TPU_MSM_BANK", "limb")
    tmb.msm_window_sums_jit.cache_clear()
    yield
    tmb.msm_window_sums_jit.cache_clear()


def _to_jax(port_add):
    """A port point add over torch (35, ..., m) points as the JAX tree's
    `add` / `aff_add` over jnp arrays."""

    def add(p1, p2):
        def torch_pt(p):
            return tuple(torch.from_numpy(np.array(a)) for a in p)

        out = port_add(torch_pt(p1), torch_pt(p2))
        return tuple(jnp.asarray(a.numpy()) for a in out)

    return add


def _points(n, seed, tile=None):
    """Montgomery limb-major X, Y (35, n) of n points: distinct, or `tile`
    base points repeated."""
    rng = np.random.default_rng(seed)
    base = tile or n
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, base)])
    X, Y = gpu_msm._points_mont(arr, base, "cpu")
    reps = -(-n // base)
    return X.repeat(1, reps)[:, :n], Y.repeat(1, reps)[:, :n]


def _digits(kind, W, n, window, seed):
    """(W, n) signed-packed digits, |d| | (d < 0) << w, |d| <= 2^(w-1)."""
    rng = np.random.default_rng(seed)
    half = 1 << (window - 1)
    mag = rng.integers(0, half + 1, size=(W, n))
    neg = rng.integers(0, 2, size=(W, n))
    if kind == "runs":
        # the test_torch_msm pattern: scalar 0x55555 gives digit 5 in every
        # window of width 4, a long run that several merge levels split
        mag[:, n // 5 : 4 * n // 5] = 5
        neg[:, n // 5 : 4 * n // 5] = 0
    elif kind == "zero":
        mag[:] = 0
    elif kind == "single":
        mag[:] = rng.integers(1, half + 1, size=(W, 1))
    elif kind == "tiled":
        # four buckets over points tiled from four bases: equal points meet
        # (doublings) and, with the signs alternating, P meets -P
        mag = np.tile(np.array([3, 3, 7, 7]), (W, n // 4)) * (1 + np.arange(W))[:, None]
        neg = np.tile(np.array([0, 0, 0, 1]), (W, n // 4))
    elif kind == "witness":
        # a witness's digits (cell B's a query): 62 % zero, 28 % one
        # (positive), the rest spread; the top third of the windows zero
        zeros, ones = round(0.62 * n), round(0.28 * n)
        u = np.stack([rng.permutation(n) for _ in range(W)])
        mag = np.where(u < zeros, 0, np.where(u < zeros + ones, 1, np.maximum(mag, 2)))
        neg = np.where(mag == 1, 0, neg)
        mag[W - max(1, W // 3):] = 0
    elif kind == "node":
        # runs of exactly `size` equal digits, one key each: the level that
        # merges two-run nodes closes every lane twice (emit_a and emit_b)
        size = max(4, n // half)
        mag = np.stack([rng.permutation(np.repeat(np.arange(n // size), size))
                        for _ in range(W)])
    elif kind == "root":
        # three keys a window over a quarter, a half and a quarter of the
        # leaves: the root closes the middle one and writes H' and T' at
        # the other two (kl' != kf' in every window)
        k0 = 1 + np.arange(W) % (half - 2)
        mag = np.stack([rng.permutation(np.repeat([k, k + 1, k + 2], [n // 4, n // 2, n // 4]))
                        for k in k0])
    mag = np.minimum(mag, half)
    neg = np.where(mag == 0, 0, neg)
    return torch.from_numpy((mag | (neg << window)).astype(np.int32))


CASES = [
    # kind, window, W, n
    ("random", 4, 3, 64),
    ("random", 12, 3, 1024),
    ("random", 4, 1, 8),
    ("runs", 4, 3, 32),
    ("runs", 12, 1, 512),
    ("zero", 12, 3, 8),
    ("zero", 4, 1, 16),
    ("single", 4, 3, 16),
    ("single", 12, 1, 128),
    ("tiled", 12, 1, 256),
    ("tiled", 4, 3, 64),
    ("witness", 12, 3, 1024),
    ("witness", 4, 3, 64),
    ("node", 12, 3, 1024),
    ("node", 4, 1, 64),
    ("root", 12, 3, 256),
    ("root", 4, 3, 16),
]


def _case(kind, window, W, n):
    X, Y = _points(n, 7 + n, tile=4 if kind == "tiled" else None)
    idx, d, s = gpu_msm._sorted_leaves(_digits(kind, W, n, window, 11 + n + W), window)
    return gpu_msm._leaves(X, Y, idx, d, s), d


@pytest.mark.parametrize("kind,window,W,n", CASES)
def test_bucket_planes_match_jax_limb_bank(limb_bank, kind, window, W, n):
    """The port's plain bucket reduction equals the JAX package's wide tree
    in its "limb" layout, bucket planes and flags, by value; no kernel is
    launched on the CPU."""
    pt, keys = _case(kind, window, W, n)
    nb = (1 << (window - 1)) + 1
    before = msm_bucket.bucket_level_cuda.launches
    got = gpu_msm._bucket_reduce_flat(pt, keys, nb)
    assert msm_bucket.bucket_level_cuda.launches == before
    want = tmb._bucket_reduce_flat(
        tuple(jnp.asarray(a.numpy()) for a in pt), jnp.asarray(keys.numpy()), nb,
        _to_jax(gpu_msm._add), _to_jax(gpu_msm._aff_add))
    want = tuple(torch.from_numpy(np.array(a)) for a in want)
    assert [tuple(a.shape) for a in got] == [(35, W * nb)] * 3 + [(W * nb,)]
    assert got[3].dtype == torch.bool
    assert fq_check.value_check(got, want) == (0, 0)
    assert torch.equal(got[3], want[3])
    # every bucket some leaf reached is written, and only those
    present = torch.zeros(W * nb, dtype=torch.bool)
    present[(keys.long() + torch.arange(W)[:, None] * nb).flatten()] = True
    written = (torch.stack(got[:3]) != 0).any(dim=1).any(dim=0) | ~got[3]
    assert not (written & ~present).any()


@pytest.mark.parametrize("kind,window,W,n", CASES[:6] + CASES[9:])
def test_each_bucket_written_once(kind, window, W, n, monkeypatch):
    """Over the whole tree each bank column is written at most once, and
    exactly the (window, key) pairs of the leaves are: the levels write no
    lane they do not close, so no write is lost or repeated."""
    pt, keys = _case(kind, window, W, n)
    nb = (1 << (window - 1)) + 1
    cols = []
    emit = msm_bucket._emit

    def recording(bank, key, val, valid, nb_):
        cols.extend((key.long() + torch.arange(key.shape[0])[:, None] * nb_)[valid].tolist())
        emit(bank, key, val, valid, nb_)

    monkeypatch.setattr(msm_bucket, "_emit", recording)
    gpu_msm._bucket_reduce_flat(pt, keys, nb)
    assert len(cols) == len(set(cols))
    want = {w * nb + int(k) for w in range(W) for k in keys[w].unique()}
    assert set(cols) == want


def test_level_one_writes_nothing_and_keeps_leaves():
    """Level 1 over affine leaves (H = T = the leaves, kf = kl = the keys)
    below the root writes no bucket, keeps a split pair's leaves with
    Z = one and takes the bridge where the keys agree."""
    pt, keys = _case("random", 4, 3, 16)
    nb = 9
    bank = msm_bucket.bucket_bank(3, nb, "cpu")
    leaves = (pt[0], pt[1], None, pt[2])
    bridge = gpu_msm._aff_add(tuple(a[..., :8] for a in pt), tuple(a[..., 8:] for a in pt))
    H, T, kf, kl = msm_bucket.bucket_level_cuda(bridge, leaves, leaves, keys, keys, bank, nb)
    assert torch.equal(kf, keys[:, :8]) and torch.equal(kl, keys[:, 8:])
    assert bank[3].all() and not torch.stack(bank[:3]).any()
    same = keys[:, :8] == keys[:, 8:]
    one = torch.from_numpy(fq_mont.ONE_MONT_LIMBS)[:, None]
    for got, x, y in ((H, pt[0][..., :8], pt[1][..., :8]),
                      (T, pt[0][..., 8:], pt[1][..., 8:])):
        assert torch.equal(got[0][:, ~same], x[:, ~same])
        assert torch.equal(got[1][:, ~same], y[:, ~same])
        assert (got[2][:, ~same] == one).all()
        assert torch.equal(got[0][:, same], bridge[0][:, same])


def test_one_mont_table_in_source():
    """The kernel's compiled-in Montgomery one (Z of an affine leaf) is
    fq_mont.ONE_MONT_LIMBS, limb for limb."""
    body = re.search(r"kOneMont\[kNL\] = \{([^}]*)\}", CSRC.read_text()).group(1)
    assert [int(v) for v in body.replace("\n", " ").split(",")] == \
        fq_mont.ONE_MONT_LIMBS.tolist()


def _levels(kind, window, W, n, monkeypatch):
    """The bucket writes of each merge level of the plain tree, root last:
    [(c / 2, [valid masks (W, c/2) of emit_a, emit_b(, the root's H' and
    T')])], and the digits."""
    pt, keys = _case(kind, window, W, n)
    levels = []
    emit = msm_bucket._emit

    def recording(bank, key, val, valid, nb_):
        if not levels or levels[-1][0] != valid.shape[1] or len(levels[-1][1]) == 4:
            levels.append((valid.shape[1], []))
        levels[-1][1].append(valid.clone())
        emit(bank, key, val, valid, nb_)

    monkeypatch.setattr(msm_bucket, "_emit", recording)
    gpu_msm._bucket_reduce_flat(pt, keys, (1 << (window - 1)) + 1)
    return levels, _digits(kind, W, n, window, 11 + n + W)


@pytest.mark.parametrize("window,W,n", [(12, 3, 1024), (4, 3, 64)])
def test_witness_digits_pattern(window, W, n, monkeypatch):
    """The witness-like digits are 62 % zero and 28 % one in each window
    below the top ones, which are all zero, and the tree writes a bucket
    for each (window, key) pair they hold."""
    levels, digits = _levels("witness", window, W, n, monkeypatch)
    low, top = digits[: W - max(1, W // 3)], digits[W - max(1, W // 3):]
    assert not top.any()
    assert ((low == 0).sum(1) == round(0.62 * n)).all()
    assert ((low == 1).sum(1) == round(0.28 * n)).all()
    written = sum(int(m.sum()) for _, masks in levels for m in masks)
    keys = digits & ((1 << window) - 1)
    assert written == sum(int(keys[w].unique().numel()) for w in range(W))


@pytest.mark.parametrize("window,W,n", [(12, 3, 1024), (4, 1, 64)])
def test_node_size_runs_close_every_lane(window, W, n, monkeypatch):
    """Runs of exactly a node's size: the level that first merges nodes of
    two runs closes every lane twice (emit_a and emit_b), as does each
    level above it; no level below closes any."""
    levels, _ = _levels("node", window, W, n, monkeypatch)
    full = [c2 for c2, masks in levels if masks[0].all() and masks[1].all()]
    size = max(4, n // (1 << (window - 1)))
    assert full == [c2 for c2, _ in levels if c2 <= n // (4 * size)] and full
    assert all(not m.any() for c2, masks in levels if c2 not in full for m in masks[:2])


@pytest.mark.parametrize("window,W,n", [(12, 3, 256), (4, 3, 16)])
def test_root_writes_three_buckets_each_window(window, W, n, monkeypatch):
    """Three keys a window: at the root kl' != kf' in every window, so it
    writes its H', its T' and the closed middle segment (emit_a) in every
    window, and no level below writes any."""
    levels, _ = _levels("root", window, W, n, monkeypatch)
    c2, masks = levels[-1]
    assert c2 == 1 and len(masks) == 4
    emit_a, emit_b, root_h, root_t = (m[:, 0] for m in masks)
    assert emit_a.all() and not emit_b.any() and root_h.all() and root_t.all()
    assert all(not m.any() for _, lower in levels[:-1] for m in lower)


def test_lanes_split_in_source():
    """The wrapper's mirror of the entry's lanes-a-CTA split is the
    source's table, row for row, over the kernel's forms; at a 22-window
    2^17 group it gives 256 lanes at levels 1-5 and fewer below, down to 1
    at the root."""
    body = re.search(r"kSplit\[\]\[2\] = \{(.*?)\};", CSRC.read_text(), re.S).group(1)
    rows = tuple(tuple(map(int, r)) for r in re.findall(r"\{(\d+), (\d+)\}", body))
    assert rows == msm_bucket.SPLIT and rows[-1][0] == 0
    assert [L for _, L in rows] == list(msm_bucket.LANE_FORMS)
    forms = [msm_bucket.lanes_a_cta(22, 1 << 17 >> (level - 1)) for level in range(1, 18)]
    assert forms == [256] * 5 + [32] * 3 + [16] + [8] * 3 + [4] + [2] * 3 + [1]


def test_lanes_argument_on_the_cpu():
    """Every form, and 0, gives the plain version on CPU tensors; any other
    lanes count is refused."""
    pt, keys = _case("random", 4, 3, 16)
    leaves = (pt[0], pt[1], None, pt[2])
    bridge = gpu_msm._aff_add(tuple(a[..., :8] for a in pt), tuple(a[..., 8:] for a in pt))
    want_bank = msm_bucket.bucket_bank(3, 9, "cpu")
    want = msm_bucket.bucket_level(bridge, leaves, leaves, keys, keys, want_bank, 9)
    for lanes in (0,) + msm_bucket.LANE_FORMS:
        bank = msm_bucket.bucket_bank(3, 9, "cpu")
        got = msm_bucket.bucket_level_cuda(bridge, leaves, leaves, keys, keys, bank, 9, lanes)
        for a, b in zip(got[0] + got[1] + got[2:] + bank, want[0] + want[1] + want[2:] + want_bank):
            assert torch.equal(a, b)
    for lanes in (3, 512, -1):
        with pytest.raises(ValueError):
            msm_bucket.bucket_level_cuda(bridge, leaves, leaves, keys, keys, want_bank, 9, lanes)


def test_tuner_groups_on_the_cpu():
    """The groups the tuner and chip_smoke.py time (ops/tune_msm_bucket.py):
    random keys and an assignment's keys lie in [0, nb), sorted along the
    bit-reversed order; an assignment of small values leaves its top
    windows all zero; a level's inputs have the shapes the wrapper takes,
    and the kernel's plain version runs on them."""
    from falcon_r1cs_tpu_torch.ops import tune_msm_bucket as tune

    brev = torch.from_numpy(gpu_msm._brev(1 << 10))
    keys = tune.random_keys(10, "cpu")
    z = np.zeros((700, 4), dtype=np.uint64)
    z[::3, 0] = np.arange(234, dtype=np.uint64) % 5000
    wkeys = tune.witness_keys(z, "cpu")
    for k in (keys, wkeys):
        assert tuple(k.shape) == (22, 1 << 10) and k.dtype == torch.int32
        assert 0 <= int(k.min()) and int(k.max()) < tune.NB
        order = torch.empty_like(k)
        order[:, brev] = k
        assert (order[:, 1:] >= order[:, :-1]).all()
    assert not wkeys[2:].any() and wkeys[0].any()
    g = torch.Generator().manual_seed(1)
    for c in (1 << 10, 1 << 4, 2):
        bridge, H, T, kf, kl, bank, nb = tune.level_inputs(keys, c, g)
        assert (H[2] is None) == (c == 1 << 10) and tuple(kf.shape) == (22, c)
        assert tune.level_of(1 << 10, c) == 11 - c.bit_length() + 1
        H2, T2, kf2, kl2 = msm_bucket.bucket_level_cuda(bridge, H, T, kf, kl, bank, nb)
        assert tuple(H2[0].shape) == (35, 22, c // 2) and torch.equal(kf2, kf[:, :c // 2])
