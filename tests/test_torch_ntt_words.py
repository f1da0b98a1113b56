"""The word arithmetic of the hint kernels K1 and K2, on the CPU, through a
transcription of `csrc/ntt_hints.cu`.

The CUDA kernels cannot run here, so these tests transcribe them word for
word, with 32-bit wrapping made explicit: the thread layout (n / 8 threads
a row, 8 coefficients a thread, phases of up to three stages), the
exchanges through swizzled word planes, the butterfly's carry chains on the
active words, the multiply-high divmod by q and K2's lazy Montgomery INTT.
The transcription runs over all rows and threads at once (numpy, u32
values in uint64 arrays, every carry, borrow and wrap spelled out) and is
held against the plain versions (`ntt_limb.ntt_with_hints`,
`intt_with_hints`) and the JAX package (`ntt_limb.ntt_with_hints`,
`intt_jax`).  The schedule and the constants are parsed from the CUDA
source text, so a typo there fails here before any run on a card.
Everything is integer arithmetic: tolerance 0.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.ops.ntt_limb as jntt_limb
import falcon_r1cs_tpu.ops.pallas_ntt as pn
from falcon_r1cs_tpu.falcon.ntt import intt_jax
from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q
from falcon_r1cs_tpu_torch.ops import cuda_ntt, ntt_limb
from falcon_r1cs_tpu_torch.ops.limbs import LIMB_BITS, NUM_LIMBS

M32 = 0xFFFFFFFF
CSRC = Path(cuda_ntt.__file__).resolve().parents[1] / "csrc"
# the kernels' source and the divmod they share with K8
SRC = (CSRC / "ntt_hints.cu").read_text() + (CSRC / "div_q.cuh").read_text()


def _const(name):
    m = re.search(rf"constexpr (?:u32|int) {name} = (0x[0-9a-fA-F]+|\d+)u?;", SRC)
    return int(m.group(1), 0)


ACTIVE_WORDS = [int(v) for v in re.search(
    r"constexpr int kActiveWords\[kMaxLogN\] = \{([^}]*)\};", SRC).group(1).split(",")]
PER, WORDS, LIMBS = _const("kPer"), _const("kWords"), _const("kLimbs")
XCHG_WORDS, MAX_LOG_N = _const("kXchgWords"), _const("kMaxLogN")
DIV_MAGIC, DIV_SHIFT, QINV16 = _const("kDivMagic"), _const("kDivShift"), _const("kQInv16")
SWZ = (_const("kSwz5"), _const("kSwz6"), _const("kSwz7"))


def _jax_hints(x, params):
    """The JAX package's ntt_with_hints on a numpy array, as numpy."""
    t, b = jax.jit(lambda a: jntt_limb.ntt_with_hints(a, params))(x)
    return np.asarray(t), np.asarray(b)


def test_source_constants():
    """The compile-time schedule and constants of csrc/ntt_hints.cu equal
    those derived from q and the host's active-limb schedule."""
    assert len(ACTIVE_WORDS) == MAX_LOG_N == 10
    for params in (FALCON_512, FALCON_1024):
        act = cuda_ntt._active_limbs(params)
        assert act == pn._active_limbs(params)
        assert ACTIVE_WORDS[: params.log_n] == [(a + 1) // 2 for a in act]
    assert (PER, WORDS, LIMBS) == (8, cuda_ntt.WORDS, NUM_LIMBS)
    assert 32 * WORDS >= LIMB_BITS * NUM_LIMBS
    assert XCHG_WORDS == max(ACTIVE_WORDS[l] for l in (2, 5, 8))
    assert QINV16 == (-pow(Q, -1, 1 << 16)) % (1 << 16) == pn._QINV16
    assert DIV_MAGIC == -(-(1 << (30 + 14)) // Q) and DIV_SHIFT == 44 - 32


def test_div_magic_exact_below_2_30():
    """floor(cur / q) = umulhi(cur, kDivMagic) >> kDivShift for every cur <
    2^30: the estimate never falls below the floor (kDivMagic >= 2^44 / q)
    and is monotone, so checking the top of each interval [a q, a q + q)
    covers them all."""
    assert DIV_MAGIC * Q - (1 << 44) <= 1 << 14 and DIV_MAGIC * Q >= 1 << 44
    top = np.arange(Q - 1, 1 << 30, Q, dtype=np.uint64)
    cur = np.concatenate([top, np.arange(0, 1 << 30, 7919, dtype=np.uint64),
                          np.asarray([(1 << 30) - 1], np.uint64)])
    assert np.array_equal(_div_q(cur), cur // Q)


def test_bound_words_match_limbs():
    """bound_words are the 16-bit bound limbs (K8's table, equal to the JAX
    package's) two to a word; the roots are the parameter tables."""
    for params in (FALCON_512, FALCON_1024):
        tab = cuda_ntt.tables_from_params(params, "cpu")
        words = tab["bound_words"].numpy().view(np.uint32).astype(np.int64)
        limbs = tab["bounds"].numpy().astype(np.int64)
        assert words.shape == (params.log_n + 1, WORDS)
        assert tab["bound_words"].dtype == torch.int32
        pairs = np.pad(limbs, ((0, 0), (0, 2 * WORDS - NUM_LIMBS)))
        assert np.array_equal(words, pairs[:, 0::2] | (pairs[:, 1::2] << 16))
        assert np.array_equal(limbs, pn._stage_tables(params)[2])
        assert tab["roots"].tolist() == list(params.ntt_table)
        inv = [(r << 16) % Q for r in params.inv_ntt_table]
        assert tab["inv_roots"].tolist() == inv


def test_values_fit_the_active_words():
    """The bound behind the schedule: entering stage l a value is at most
    B_l (B_0 = q - 1); v = b s <= B_l (q - 1) <= c, so (u + c) - v does
    not borrow; u + c and u + v fit aw_l words; B_{l+1} = B_l + c."""
    for params in (FALCON_512, FALCON_1024):
        bound = Q - 1
        for l in range(params.log_n):
            c = params.const_q_powers[l + 1]
            assert bound * (Q - 1) <= c
            assert bound + c < 1 << (32 * ACTIVE_WORDS[l])
            bound += c
        assert bound < 1 << (LIMB_BITS * NUM_LIMBS)


# --- the thread layout ------------------------------------------------------


def _own(t, h):
    """own<H>(t): the first of the 8 coefficients thread t owns."""
    return (t // h) * (PER * h) + t % h


def _swz(j):
    return j ^ (((j >> 5) & 1) * SWZ[0]) ^ (((j >> 6) & 1) * SWZ[1]) ^ (((j >> 7) & 1) * SWZ[2])


def _fwd_phases(log_n):
    """[(stages, H)]: fwd_phases' split, up to three stages a phase."""
    out, l0 = [], 0
    while l0 < log_n:
        l1 = min(l0 + 3, log_n)
        out.append((list(range(l0, l1)), (1 << log_n) >> l1))
        l0 = l1
    return out


def _inv_own(n, lh):
    return min(n >> (lh + 1), n // PER)


def _inv_phases(log_n):
    """[(levels, H)]: inv_phases' split, from level log_n - 1 down."""
    out, lh = [], log_n - 1
    while lh >= 0:
        ll = lh - 2 if lh > 2 else 0
        out.append((list(range(lh, ll - 1, -1)), _inv_own(1 << log_n, lh)))
        lh = ll - 1
    return out


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_layout_pairs_and_swizzle(params):
    """Every phase's stage pairs two registers of one thread exactly as the
    NTT pairs j and j + half; the ownership covers each j once; the last
    INTT phase owns the first forward phase's coefficients; the swizzle is
    a permutation of each plane, and every warp's access for each k hits 32
    distinct banks in every exchange."""
    n, log_n = params.n, params.log_n
    t = np.arange(n // PER)
    fwd, inv = _fwd_phases(log_n), _inv_phases(log_n)
    assert [s for st, _ in fwd for s in st] == list(range(log_n))
    assert [s for st, _ in inv for s in st] == list(range(log_n - 1, -1, -1))
    assert inv[-1][1] == fwd[0][1] == n // PER and fwd[-1][1] == inv[0][1] == 1
    for stages, h in fwd + inv:
        own = _own(t, h)[:, None] + h * np.arange(PER)[None, :]
        assert sorted(own.ravel().tolist()) == list(range(n))
        # own<H>(t) and k H share no bit: the kernels' swizzle and root
        # index split into a part of t and a constant
        kh = h * np.arange(PER)[None, :]
        assert not (_own(t, h)[:, None] & kh).any()
        assert np.array_equal(_swz(own), _swz(_own(t, h))[:, None] ^ _swz(kh))
        for l in stages:
            s = log_n - l
            assert np.array_equal(own >> s, (_own(t, h)[:, None] >> s) + (kh >> s))
        for l in stages:
            half = n >> (l + 1)
            d = half // h
            assert d in (1, 2, 4)
            ks = [k for k in range(PER) if not k & d]
            assert ks == sorted(_pairs(d))
            assert not (own[:, ks] & half).any()
            assert np.array_equal(own[:, ks] + half, own[:, [k + d for k in ks]])
        banks = _swz(own) % 32
        for w in range(0, len(t), 32):
            for k in range(PER):
                assert len(set(banks[w:w + 32, k].tolist())) == 32, (h, w, k)
    assert sorted(_swz(np.arange(n)).tolist()) == list(range(n))
    # K2 at n = 1024 needs 6 exchanges (2 x 5 planes of 4 KB: 40 KB)
    assert len(fwd) - 1 <= 3 and len(inv) - 1 <= 3


# --- the transcription of csrc/ntt_hints.cu ---------------------------------


def _div_q(cur):
    """div_q: umulhi(cur, kDivMagic) >> kDivShift."""
    return ((cur * DIV_MAGIC) >> 32) >> DIV_SHIFT


def _mont16(p):
    assert (p <= M32).all()
    m = (p * QINV16) & 0xFFFF
    return (p + m * Q) >> 16


def _add_words(a, b, aw):
    """add.cc / addc.cc / addc (one plain add at aw = 1): no carry out."""
    d, cf = [], 0
    for w in range(aw):
        s = a[w] + b[w] + cf
        d.append(s & M32)
        cf = s >> 32
    assert not np.any(cf)
    return d


def _sub_words(a, b, aw):
    """sub.cc / subc.cc / subc: no borrow out."""
    d, bf = [], 0
    for w in range(aw):
        s = a[w] + (1 << 32) - b[w] - bf
        d.append(s & M32)
        bf = 1 - (s >> 32)
    assert not np.any(bf)
    return d


def _mul_word(b, s, aw):
    """mul.lo of every word, then mad.hi.cc / madc.hi.cc / madc.hi adding
    each high half one word up; the top word's high half and the last
    carry are dropped and must be 0."""
    v = [(b[w] * s) & M32 for w in range(aw)]
    cf = 0
    for w in range(aw - 1):
        p = v[w + 1] + ((b[w] * s) >> 32) + cf
        v[w + 1] = p & M32
        cf = p >> 32
    assert not np.any(cf) and not np.any((b[aw - 1] * s) >> 32)
    return v


def _exchange(x, n, h_from, h_to, aw, t):
    """One exchange through a region of aw word planes, swizzled; the slot
    of coefficient k is swz(own) ^ swz(k H)."""
    plane = np.full((x[0][0].shape[0], aw, n), -1, dtype=np.int64)
    for k in range(PER):
        j = _swz(_own(t, h_from)) ^ _swz(k * h_from)
        for w in range(aw):
            plane[:, w, j] = x[k][w]
    assert (plane >= 0).all()
    for k in range(PER):
        j = _swz(_own(t, h_to)) ^ _swz(k * h_to)
        for w in range(aw):
            x[k][w] = plane[:, w, j].astype(np.uint64)


def _pairs(d):
    return [(p // d) * 2 * d + p % d for p in range(PER // 2)]


def _fwd(x, params, t):
    """fwd_phases from stage 0: (B, T) u32 words x[k][w]."""
    n, log_n = params.n, params.log_n
    tab = cuda_ntt.tables_from_params(params, "cpu")
    roots = tab["roots"].numpy().astype(np.uint64)
    bounds = tab["bound_words"].numpy().view(np.uint32).astype(np.uint64)
    phases = _fwd_phases(log_n)
    for i, (stages, h) in enumerate(phases):
        base = _own(t, h)
        for l in stages:
            d, aw = (n >> (l + 1)) // h, ACTIVE_WORDS[l]
            c = [bounds[l + 1, w] for w in range(aw)]
            for k in _pairs(d):
                s = roots[(base >> (log_n - l)) + (1 << l) + ((k * h) >> (log_n - l))]
                a, b = x[k], x[k + d]
                v = _mul_word(b, s, aw)
                e = _add_words(a, c, aw)
                x[k][:aw] = _add_words(a, v, aw)
                x[k + d][:aw] = _sub_words(e, v, aw)
        if i + 1 < len(phases):
            _exchange(x, n, h, phases[i + 1][1], ACTIVE_WORDS[stages[-1]], t)


def _divmod(x, params, t):
    """divmod_store: t (11, B, n) and b (B, n) from the 8 consecutive
    coefficients a thread owns in the last phase."""
    n = params.n
    batch = x[0][0].shape[0]
    t_out = np.zeros((LIMBS, batch, n), dtype=np.int64)
    b_out = np.zeros((batch, n), dtype=np.int64)
    col = _own(t, 1)
    r = [np.zeros_like(x[0][0]) for _ in range(PER)]
    for k in range(LIMBS - 1, -1, -1):
        for e in range(PER):
            w = x[e][k >> 1]
            if k & 1:  # __funnelshift_r(w, r, 16)
                cur = (((r[e] << 32) | w) >> 16) & M32
            else:      # __byte_perm(w, r, 0x5410)
                cur = ((r[e] & 0xFFFF) << 16) | (w & 0xFFFF)
            assert (cur < 1 << 30).all()
            d = _div_q(cur)
            r[e] = (cur - d * Q) & M32
            t_out[k][:, col + e] = d
    for e in range(PER):
        assert (r[e] < Q).all()
        b_out[:, col + e] = r[e]
    return t_out, b_out


def _coeffs(batch, t):
    return [[np.zeros((batch, len(t)), dtype=np.uint64) for _ in range(WORDS)]
            for _ in range(PER)]


def k1_words(xin, params):
    """ntt_hints_kernel on (B, n) int32: (t (11, B, n), b (B, n))."""
    n = params.n
    t = np.arange(n // PER)
    x = _coeffs(xin.shape[0], t)
    for k in range(PER):  # the first phase owns j = t + k n / 8
        x[k][0] = xin[:, t + k * (n // PER)].astype(np.uint64)
    _fwd(x, params, t)
    return _divmod(x, params, t)


def k2_words(win, params):
    """intt_ntt_hints_kernel on (B, n) int32: (t, b, v)."""
    n, log_n = params.n, params.log_n
    t = np.arange(n // PER)
    inv_roots = cuda_ntt.tables_from_params(params, "cpu")["inv_roots"].numpy().astype(np.uint64)
    x = _coeffs(win.shape[0], t)
    for k in range(PER):  # the first INTT phase owns j = 8 t + k
        x[k][0] = win[:, PER * t + k].astype(np.uint64)
    phases = _inv_phases(log_n)
    for i, (levels, h) in enumerate(phases):
        base = _own(t, h)
        for l in levels:
            d = (n >> (l + 1)) // h
            for k in _pairs(d):
                s = inv_roots[(base >> (log_n - l)) + (1 << l) + ((k * h) >> (log_n - l))]
                u, v = x[k][0], x[k + d][0]
                total = (u + v) & M32
                x[k][0] = np.where(total >= 2 * Q, total - 2 * Q, total)
                x[k + d][0] = _mont16((((u + 2 * Q - v) & M32) * s) & M32)
                assert (x[k][0] < 2 * Q).all() and (x[k + d][0] < 2 * Q).all()
        if i + 1 < len(phases):
            _exchange(x, n, h, phases[i + 1][1], 1, t)
    n_inv_mont = ((Q - (Q - 1) // n) << 16) % Q
    assert n_inv_mont == (pow(n, -1, Q) << 16) % Q
    v_out = np.zeros(win.shape, dtype=np.int64)
    for k in range(PER):  # the last INTT phase owns j = t + k n / 8
        y = _mont16(x[k][0] * n_inv_mont)
        x[k][0] = np.where(y >= Q, y - Q, y)
        v_out[:, t + k * (n // PER)] = x[k][0]
    _fwd(x, params, t)
    return (*_divmod(x, params, t), v_out)


# --- the transcription against the plain versions and the JAX package ------


def _rows(params, seed):
    """Seeded random rows, then all q - 1, all 0 and two one-hot rows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, size=(6, params.n)).astype(np.int32)
    x[2], x[3] = Q - 1, 0
    x[4], x[5] = 0, 0
    x[4, 0], x[5, params.n - 1] = 1, Q - 1
    return x


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_k1_words_match_plain_and_jax(params):
    x = _rows(params, 71 + params.log_n)
    t_w, b_w = k1_words(x, params)
    t_p, b_p = ntt_limb.ntt_with_hints(torch.from_numpy(x), params)
    assert np.array_equal(t_w, t_p.numpy()) and np.array_equal(b_w, b_p.numpy())
    t_j, b_j = _jax_hints(x, params)
    assert np.array_equal(t_w, t_j) and np.array_equal(b_w, b_j)
    assert b_w[3].max() == 0  # the all-0 row: every stage bound is 0 mod q
    assert t_w[LIMBS - 1].max() == 0  # every value < 2^164: t < 2^160


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_k2_words_match_plain_and_jax(params):
    w = _rows(params, 81 + params.log_n)
    t_w, b_w, v_w = k2_words(w, params)
    t_p, b_p, v_p = ntt_limb.intt_with_hints(torch.from_numpy(w), params)
    assert np.array_equal(v_w, v_p.numpy())
    assert np.array_equal(t_w, t_p.numpy()) and np.array_equal(b_w, b_p.numpy())
    v_j = np.asarray(jax.jit(lambda a: intt_jax(a, params.n))(w))
    t_j, b_j = _jax_hints(v_j, params)
    assert np.array_equal(v_w, v_j)
    assert np.array_equal(t_w, t_j) and np.array_equal(b_w, b_j)
