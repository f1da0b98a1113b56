"""The semi-carry kernel K8 on the CPU, through a transcription of
`csrc/ntt_v3.cu`, and the limb trim it rests on.

The CUDA kernel cannot run here, so these tests transcribe it step for
step: the thread layout (n / 4 threads a row, 4 coefficients a thread,
phases of two stages), the exchanges of the live limbs through swizzled
int32 planes, the butterflies on the live limbs only, and both epilogues
(the semi state; the sequential normalisation and the multiply-high
divmod by q).  The transcription runs over all rows and threads at once
(numpy int64, every value checked to stay inside int32, where the
kernel's wrapping arithmetic is exact) and is held against the plain
versions `ntt_limb.ntt_semi`, limb for limb, and `ntt_limb.ntt_with_hints`.
The trim table, the layout constants and the divmod constants are parsed
from the CUDA sources, and the table is recomputed by the interval bound
`ntt_v3.live_limbs`.  No JAX.  Everything is integer arithmetic:
tolerance 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q
from falcon_r1cs_tpu_torch.ops import cuda_ntt, ntt_limb, ntt_v3
from falcon_r1cs_tpu_torch.ops.limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS

CSRC = Path(ntt_v3.__file__).resolve().parents[1] / "csrc"
SRC = (CSRC / "ntt_v3.cu").read_text() + (CSRC / "div_q.cuh").read_text()
I32 = (-(1 << 31), (1 << 31) - 1)
SMEM_STATIC = 48 * 1024


def _const(name):
    m = re.search(rf"constexpr (?:u32|int) {name} = (0x[0-9a-fA-F]+|\d+)u?;", SRC)
    return int(m.group(1), 0)


LIVE = [int(v) for v in re.search(
    r"constexpr int kLiveLimbs\[kMaxLogN\] = \{([^}]*)\};", SRC).group(1).split(",")]
PER, STAGES, MAX_LOG_N = _const("kPer"), _const("kPhaseStages"), _const("kMaxLogN")
SEMI, HINT = _const("kSemiLimbs"), _const("kHintLimbs")
DIV_MAGIC, DIV_SHIFT = _const("kDivMagic"), _const("kDivShift")
SWZ = (_const("kSwz5"), _const("kSwz6"))


def _i32(a):
    """a, checked to lie inside int32 (no wrap in the kernel)."""
    assert a.min() >= I32[0] and a.max() <= I32[1]
    return a


# --- the trim ---------------------------------------------------------------


def test_source_constants():
    """The sizes and constants of csrc/ntt_v3.cu and div_q.cuh."""
    assert len(LIVE) == MAX_LOG_N == 10
    assert (SEMI, HINT) == (ntt_limb.SEMI_LIMBS, NUM_LIMBS)
    assert 1 << STAGES == PER == 4
    assert _const("kQ") == Q and DIV_MAGIC == -(-(1 << 44) // Q) and DIV_SHIFT == 12


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_trim_table_is_the_interval_bound(params):
    """The interval bound recomputed on the CPU equals the table in the
    source: 81 of 120 limb-stages at n = 1024, 69 of 108 at n = 512."""
    live = ntt_v3.live_limbs(params)
    assert live == LIVE[: params.log_n]
    assert live == sorted(live) and live[-1] <= SEMI
    assert sum(live) == {9: 69, 10: 81}[params.log_n]


def _stage_states(x, params):
    """The untrimmed stage loop of ntt_semi in numpy: the (12, B, n) state
    after each stage (the last equals ntt_semi)."""
    n = params.n
    tw, _ = cuda_ntt._stage_tables(params)
    bounds = cuda_ntt._semi_tables(n, torch.device("cpu"))["bounds"].numpy().astype(np.int64)

    def semi(v):
        carry = np.concatenate([np.zeros_like(v[:1]), v[:-1] >> LIMB_BITS])
        return _i32((v & LIMB_MASK) + carry)

    out = np.zeros((SEMI,) + x.shape, np.int64)
    out[0] = x
    states = []
    for l in range(params.log_n):
        half = n >> (l + 1)
        o = out.reshape(SEMI, x.shape[0], -1, 2, half)
        u, hi = o[:, :, :, 0], o[:, :, :, 1]
        s = tw[l].reshape(-1, 2, half)[:, 0].astype(np.int64)
        v = semi(_i32(hi * s))
        c = bounds[l + 1].reshape(SEMI, 1, 1, 1)
        out = np.stack([semi(u + v), semi(u + (c - v))], axis=3).reshape(out.shape)
        states.append(out)
    return states


def _redundant(semi):
    """(B,) bool: rows with a limb outside [0, 2^16)."""
    return ((semi < 0) | (semi > LIMB_MASK)).reshape(SEMI, semi.shape[1], -1).any(2).any(0)


def _rows(params, seed):
    """Rows in the style of tests/test_torch_ntt_v3.py: random rows, two
    whose semi state is redundant (from a seeded pool of 256), one of all
    0, one of all q - 1 and a one-hot row."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, Q, size=(256, params.n)).astype(np.int32)
    picked = _redundant(ntt_limb.ntt_semi(torch.from_numpy(pool), params).numpy())
    assert picked.sum() >= 2
    one_hot = np.zeros((1, params.n), np.int32)
    one_hot[0, params.n // 2 + 1] = Q - 1
    return np.concatenate([
        rng.integers(0, Q, size=(3, params.n)).astype(np.int32),
        pool[picked][:2],
        np.zeros((1, params.n), np.int32),
        np.full((1, params.n), Q - 1, np.int32),
        one_hot,
    ])


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_dead_limbs_are_zero(params):
    """After every stage, every limb the table calls dead is zero on the
    test rows and on 64 more random ones, and every live limb stays
    inside the interval bound's [-3, 2^16 + 2]."""
    rng = np.random.default_rng(90 + params.log_n)
    x = np.concatenate([_rows(params, 91), rng.integers(0, Q, size=(64, params.n))])
    states = _stage_states(x.astype(np.int64), params)
    assert np.array_equal(states[-1], ntt_limb.ntt_semi(torch.from_numpy(x.astype(np.int32)),
                                                        params).numpy())
    for l, st in enumerate(states):
        assert not st[LIVE[l]:].any(), l
        assert st.min() >= -3 and st.max() <= (1 << 16) + 2
    assert _redundant(states[-1])[3:5].all()


# --- the thread layout ------------------------------------------------------


def _own(t, h):
    return (t // h) * (PER * h) + t % h


def _swz(j):
    return j ^ (((j >> 5) & 1) * SWZ[0]) ^ (((j >> 6) & 1) * SWZ[1])


def _phases(log_n):
    """[(stages, H)]: the split of `phases`, kPhaseStages a phase."""
    out, l0 = [], 0
    while l0 < log_n:
        l1 = min(l0 + STAGES, log_n)
        out.append((list(range(l0, l1)), (1 << log_n) >> l1))
        l0 = l1
    return out


def _pairs(d):
    return [(p // d) * 2 * d + p % d for p in range(PER // 2)]


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_layout_pairs_exchanges_and_banks(params):
    """Each stage pairs two registers of one thread as the NTT pairs j and
    j + half; each phase owns every j once; the last phase owns 4
    consecutive j a thread (the int4 stores); the 8 swizzled accesses of
    each warp in every exchange (4 writes, 4 reads) hit 32 distinct banks;
    the widest exchange fits the 48 KB of static shared memory."""
    n, log_n = params.n, params.log_n
    t = np.arange(n // PER)
    phases = _phases(log_n)
    assert [s for st, _ in phases for s in st] == list(range(log_n))
    assert phases[0][1] == n // PER and phases[-1][1] == 1
    assert np.array_equal(_own(t, 1), PER * t)
    for stages, h in phases:
        own = _own(t, h)[:, None] + h * np.arange(PER)[None, :]
        assert sorted(own.ravel().tolist()) == list(range(n))
        kh = h * np.arange(PER)[None, :]
        assert np.array_equal(_swz(own), _swz(_own(t, h))[:, None] ^ _swz(kh))
        for l in stages:
            half = n >> (l + 1)
            d = half // h
            ks = _pairs(d)
            assert not (own[:, ks] & half).any()
            assert np.array_equal(own[:, ks] + half, own[:, [k + d for k in ks]])
        banks = _swz(own) % 32
        for w in range(0, len(t), 32):
            for k in range(PER):
                assert len(set(banks[w:w + 32, k].tolist())) == 32, (h, w, k)
    assert sorted(_swz(np.arange(n)).tolist()) == list(range(n))
    planes = max(LIVE[st[-1]] for st, _ in phases[:-1])
    assert planes * n * 4 <= SMEM_STATIC
    # a barrier after each exchange's writes, and before them but the first
    assert 2 * (len(phases) - 1) - 1 == {9: 7, 10: 7}[log_n]


# --- the transcription of csrc/ntt_v3.cu ------------------------------------


def _semi_round(x, w):
    """semi<W> in place, top limb down: limb k reads limb k - 1 before it
    is rewritten."""
    for k in range(w - 1, 0, -1):
        x[k] = _i32((x[k] & LIMB_MASK) + (x[k - 1] >> LIMB_BITS))
    x[0] = x[0] & LIMB_MASK


def _butterfly(a, b, s, c, w):
    v = [_i32(b[k] * s) for k in range(w)]
    _semi_round(v, w)
    for k in range(w):
        b[k] = _i32(a[k] + _i32(c[k] - v[k]))
        a[k] = _i32(a[k] + v[k])
    _semi_round(a, w)
    _semi_round(b, w)


def _exchange(x, n, h_from, h_to, w, t):
    plane = np.full((x[0][0].shape[0], w, n), I32[0] - 1, np.int64)
    for k in range(PER):
        j = _swz(_own(t, h_from)) ^ _swz(k * h_from)
        for q in range(w):
            plane[:, q, j] = x[k][q]
    assert (plane >= I32[0]).all()  # every slot written once
    for k in range(PER):
        j = _swz(_own(t, h_to)) ^ _swz(k * h_to)
        for q in range(w):
            x[k][q] = plane[:, q, j]


def _ntt(xin, params, t):
    """The kernel up to its epilogue: x[k][limb] (B, T) int64."""
    n, log_n = params.n, params.log_n
    tab = cuda_ntt._semi_tables(n, torch.device("cpu"))
    tw = tab["tw"].numpy().astype(np.int64)
    bounds = tab["bounds"].numpy().astype(np.int64)
    x = [[np.zeros((xin.shape[0], len(t)), np.int64) for _ in range(SEMI)] for _ in range(PER)]
    for k in range(PER):  # the first phase owns j = t + k n / kPer
        x[k][0] = xin[:, t + k * (n // PER)].astype(np.int64)
    phases = _phases(log_n)
    for i, (stages, h) in enumerate(phases):
        base = _own(t, h)
        for l in stages:
            d, w = (n >> (l + 1)) // h, LIVE[l]
            for k in _pairs(d):
                _butterfly(x[k], x[k + d], tw[l, base + k * h], bounds[l + 1, :w], w)
        if i + 1 < len(phases):
            _exchange(x, n, h, phases[i + 1][1], LIVE[stages[-1]], t)
    return x


def _store(out, t, vals):
    """store_row: the thread's kPer values to columns kPer t onwards."""
    for e, v in enumerate(vals):
        out[:, PER * t + e] = v


def k8_semi_words(xin, params):
    """ntt_semi_kernel<log_n, false>: the state (12, B, n)."""
    t = np.arange(params.n // PER)
    x = _ntt(xin, params, t)
    out = np.zeros((SEMI, xin.shape[0], params.n), np.int64)
    for k in range(SEMI):
        _store(out[k], t, [x[e][k] for e in range(PER)])
    return out


def k8_hints_words(xin, params):
    """ntt_semi_kernel<log_n, true>: (t (11, B, n), b (B, n))."""
    t = np.arange(params.n // PER)
    x = _ntt(xin, params, t)
    for e in range(PER):  # normalise: a sequential carry chain
        carry = 0
        for k in range(SEMI):
            s = _i32(x[e][k] + carry)
            x[e][k] = s & LIMB_MASK
            carry = s >> LIMB_BITS
    t_out = np.zeros((HINT, xin.shape[0], params.n), np.int64)
    b_out = np.zeros((xin.shape[0], params.n), np.int64)
    r = [np.zeros_like(x[0][0]) for _ in range(PER)]
    for k in range(SEMI - 1, -1, -1):
        d = []
        for e in range(PER):
            cur = (r[e] << LIMB_BITS) | x[e][k]
            assert (cur < 1 << 30).all()
            quo = ((cur * DIV_MAGIC) >> 32) >> DIV_SHIFT  # div_q
            r[e] = cur - quo * Q
            d.append(quo)
        if k < HINT:
            _store(t_out[k], t, d)
        else:  # the normalised top limb is zero: nothing to store
            assert not any(v.any() for v in d)
    _store(b_out, t, r)
    assert all((v >= 0).all() and (v < Q).all() for v in r)
    return t_out, b_out


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_semi_epilogue_matches_ntt_semi(params):
    """The semi epilogue equals ntt_semi limb for limb, on redundant
    rows, all 0, all q - 1 and one-hot."""
    x = _rows(params, 92 + params.log_n)
    got = k8_semi_words(x, params)
    want = ntt_limb.ntt_semi(torch.from_numpy(x), params).numpy()
    assert np.array_equal(got, want)
    assert _redundant(want)[3:5].all()


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_hints_epilogue_matches_ntt_with_hints(params):
    """The hints epilogue equals ntt_with_hints (K1's plain version) and
    the CPU path of ntt_with_hints_v3, bit for bit."""
    x = _rows(params, 94 + params.log_n)
    t_w, b_w = k8_hints_words(x, params)
    t_p, b_p = ntt_limb.ntt_with_hints(torch.from_numpy(x), params)
    assert np.array_equal(t_w, t_p.numpy()) and np.array_equal(b_w, b_p.numpy())
    t_v, b_v = ntt_v3.ntt_with_hints_v3(torch.from_numpy(x), params)
    assert torch.equal(t_v, t_p) and torch.equal(b_v, b_p)
    assert b_w[5].max() == 0  # the all-0 row: every stage bound is 0 mod q


def test_entry_cpu_path_is_its_plain_version():
    """On a CPU tensor the entry is its plain version (ntt_semi, normalize,
    divmod_q in torch) and launches nothing."""
    x = torch.from_numpy(_rows(FALCON_512, 96))
    before = ntt_v3.ntt_semi_cuda.launches
    got = ntt_v3.ntt_with_hints_v3(x, FALCON_512)
    assert ntt_v3.ntt_semi_cuda.launches == before
    for g, w in zip(got, ntt_v3.ntt_with_hints_v3.plain(x, FALCON_512)):
        assert torch.equal(g, w)
