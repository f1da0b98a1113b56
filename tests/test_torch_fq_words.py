"""The word arithmetic of K4, K5 and K6, on the CPU, through a Python-int
transcription of `csrc/fq_mont.cu`, and the plain `fq_mont.canonical` and
`fq_check.value_check` that hold the kernels against their plain versions
by value.

The CUDA kernels cannot run here, so these tests transcribe their entry
(`from_limbs`: relaxed limbs of the R = 2^408 domain -> 12 words of the
R' = 2^384 domain), their CIOS Montgomery product, lazy add and
subtract, exit (`to_limbs`), the product chain of K4 and the point-add
flows of K5 and K6 word for word, with 32-bit wrapping made explicit, and
hold them against the plain torch arithmetic (`ops/fq_mont.py`,
`ops/fq.py`) by value mod q.  The word constants are parsed from the
CUDA source text, so a typo there fails here before any run on a card.
Everything is integer arithmetic: tolerance 0.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_r1cs_tpu_torch.ops import fq
from falcon_r1cs_tpu_torch.ops import fq_mont as tfq
from falcon_r1cs_tpu_torch.snark import native_backend as nb
from falcon_r1cs_tpu_torch.snark.gpu_msm import _points_std_limbs

Q = tfq.Q381
M32 = (1 << 32) - 1
SRC = (Path(tfq.__file__).resolve().parents[1] / "csrc" / "fq_mont.cu").read_text()


def _table(name):
    body = re.search(rf"__constant__ u32 {name}\[kW\] = \{{(.*?)\}};", SRC, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]


def _words(v):
    return [(v >> (32 * j)) & M32 for j in range(12)]


def _int(w):
    return sum(x << (32 * j) for j, x in enumerate(w))


QW, Q2W, EXITW = _table("c_qw"), _table("c_2qw"), _table("c_exitw")
QINV = int(re.search(r"constexpr u32 kQInv = 0x([0-9a-f]+)u;", SRC).group(1), 16)


def test_source_constants():
    """The word tables and q' in csrc/fq_mont.cu equal those derived from q."""
    assert QW == _words(Q) and Q2W == _words(2 * Q)
    assert EXITW == _words(pow(2, 408, Q))  # x 2^24 out of the R' = 2^384 domain
    assert store_limbs(EXITW) == tfq.ONE_MONT_LIMBS.tolist()  # K6's Z = one
    assert QINV == (-pow(Q, -1, 1 << 32)) % (1 << 32)
    assert (QINV & 0xFFFFFF) == (-pow(Q, -1, 1 << 24)) % (1 << 24)
    assert 4 * Q < 1 << 384 and QW[11] < 1 << 31


# --- the transcription of csrc/fq_mont.cu ----------------------------------


def _i32(x):
    return ((x + (1 << 31)) & M32) - (1 << 31)


def mont(a, b):
    """CIOS over 12 words with explicit 64-bit carries, t[12] and the carry
    word t[13]: the reference that the kernel's carry-chain form
    (`mont_chains`) is held against."""
    t = [0] * 14
    for i in range(12):
        c = 0
        for j in range(12):
            p = a[j] * b[i] + t[j] + c
            t[j], c = p & M32, p >> 32
        p = t[12] + c
        t[12], t[13] = p & M32, p >> 32
        mq = (t[0] * QINV) & M32
        p = mq * QW[0] + t[0]
        assert p & M32 == 0
        c = p >> 32
        for j in range(1, 12):
            p = mq * QW[j] + t[j] + c
            t[j - 1], c = p & M32, p >> 32
        p = t[12] + c
        t[11] = p & M32
        t[12] = (t[13] + (p >> 32)) & M32
    assert t[12] == 0
    return t[:12]


def mont_chains(a, b):
    """`mont` as the kernel computes it: per word b_i four PTX carry chains (mad.lo.cc / madc.lo.cc, addc, mad.hi.cc /
    madc.hi.cc, madc.hi), the last writing one word down (the shift)."""
    t = [0] * 13

    def chain(steps):
        cf = 0
        for dst, add in steps:
            s = add() + cf
            t[dst], cf = s & M32, s >> 32
        return cf

    for i in range(12):
        bi = b[i]
        cf = chain([(j, lambda j=j: ((a[j] * bi) & M32) + t[j]) for j in range(12)])
        t[12] += cf
        cf = chain([(j + 1, lambda j=j: ((a[j] * bi) >> 32) + t[j + 1]) for j in range(12)])
        assert cf == 0
        mq = (t[0] * QINV) & M32
        cf = chain([(j, lambda j=j: ((mq * QW[j]) & M32) + t[j]) for j in range(12)])
        assert t[0] == 0
        t[12] += cf
        assert t[12] <= M32
        cf = chain([(j, lambda j=j: ((mq * QW[j]) >> 32) + t[j + 1]) for j in range(12)])
        assert cf == 0
        t[12] = 0
    return t[:12]


def _sub_words(a, b):
    d, borrow = [], 0
    for j in range(12):
        p = (a[j] - b[j] - borrow) % (1 << 64)
        d.append(p & M32)
        borrow = (p >> 32) & 1
    return d, borrow


def addw(a, b):
    s, c = [], 0
    for j in range(12):
        p = a[j] + b[j] + c
        s.append(p & M32)
        c = p >> 32
    assert c == 0
    d, borrow = _sub_words(s, Q2W)
    return s if borrow else d


def subw(a, b):
    d, borrow = _sub_words(a, b)
    mask = M32 if borrow else 0
    out, c = [], 0
    for j in range(12):
        p = d[j] + (Q2W[j] & mask) + c
        out.append(p & M32)
        c = p >> 32
    return out


def dblw(a, times=1):
    for _ in range(times):
        a = addw(a, a)
    return a


def reduce(a):
    d, borrow = _sub_words(a, QW)
    return a if borrow else d


def eqw(a, b):
    return reduce(a) == reduce(b)


def from_limbs(limbs):
    """`from_limbs`: 35 relaxed int32 limbs -> words of value 2^-24 mod q."""
    v = [0] * 13
    carry = 0
    for l in range(34):
        t = _i32(int(limbs[l]) + carry)
        d = t & 0xFFF
        carry = t >> 12
        bit = 12 * l
        word, off = bit >> 5, bit & 31
        v[word] |= (d << off) & M32
        if off > 20:
            v[word + 1] |= d >> (32 - off)
    top = _i32(int(limbs[34]) + carry)
    v[12] |= ((top & M32) << 24) & M32
    m0 = (v[0] * QINV) & 0xFFFFFF
    c = 0
    for j in range(12):
        p = m0 * QW[j] + v[j] + c
        v[j], c = p & M32, p >> 32
    v[12] = (v[12] + c) & M32
    mask = M32 if v[12] >> 31 else 0
    for j in range(12):
        v[j] = ((v[j] >> 24) | (v[j + 1] << 8)) & M32
    out, c = [], 0
    for j in range(12):
        p = v[j] + (Q2W[j] & mask) + c
        out.append(p & M32)
        c = p >> 32
    return out


def to_limbs(a):
    """`to_limbs`: words of the R' domain -> 35 canonical limbs of a 2^24."""
    return store_limbs(reduce(mont(a, EXITW)))


def store_limbs(x):
    """`store_limbs`: words of x < 2^384 -> its 35 12-bit limbs."""
    out = []
    for l in range(35):
        bit = 12 * l
        word, off = bit >> 5, bit & 31
        d = 0
        if word < 12:
            d = x[word] >> off
            if off > 20 and word + 1 < 12:
                d |= (x[word + 1] << (32 - off)) & M32
        out.append(d & 0xFFF)
    return out


def mont_mul_words(a, b, depth=1):
    """`mont_mul_kernel` on one point: 35 limbs of a, b -> 35 limbs."""
    x, y = from_limbs(a), from_limbs(b)
    for _ in range(depth):
        x = mont(x, y)
    return to_limbs(x)


def point_double_w(X, Y):
    """`point_double_w`: Xd, Yd of dbl-2007-bl (the caller forms Zd)."""
    A, B = mont(X, X), mont(Y, Y)
    C = mont(B, B)
    t = addw(X, B)
    t = subw(subw(mont(t, t), A), C)
    D = dblw(t)
    E = addw(dblw(A), A)
    X3 = subw(mont(E, E), dblw(D))
    Y3 = subw(mont(E, subw(D, X3)), dblw(C, 3))
    return X3, Y3


def point_chord_w(U1, U2, S1, S2):
    """`point_chord_w`: X3, Y3 and H = U2 - U1 (the caller forms Z3)."""
    H = subw(U2, U1)
    t = dblw(H)
    I = mont(t, t)
    J = mont(H, I)
    rr = dblw(subw(S2, S1))
    V = mont(U1, I)
    X3 = subw(subw(mont(rr, rr), J), dblw(V))
    Y3 = subw(mont(rr, subw(V, X3)), dblw(mont(S1, J)))
    return X3, Y3, H


def point_add_words(p1, p2):
    """`point_add_kernel` on one point: p = ([35 limbs] x3, inf)."""
    (x1, y1, z1, inf1), (x2, y2, z2, inf2) = p1, p2
    if inf1 or inf2:
        src = p2 if inf1 else p1
        return [list(c) for c in src[:3]] + [inf1 and inf2]
    Z1, Z2 = from_limbs(z1), from_limbs(z2)
    Z1Z1, Z2Z2 = mont(Z1, Z1), mont(Z2, Z2)
    U1 = mont(from_limbs(x1), Z2Z2)
    U2 = mont(from_limbs(x2), Z1Z1)
    S1 = mont(mont(from_limbs(y1), Z2), Z2Z2)
    S2 = mont(mont(from_limbs(y2), Z1), Z1Z1)
    same_x, same_y = eqw(U1, U2), eqw(S1, S2)
    if same_x and same_y:  # dbl-2007-bl on (X1, Y1, Z1)
        Y = from_limbs(y1)
        X3, Y3 = point_double_w(from_limbs(x1), Y)
        Z3 = dblw(mont(Y, Z1))
    else:
        X3, Y3, H = point_chord_w(U1, U2, S1, S2)
        Z3 = dblw(mont(mont(Z1, Z2), H))
    return [to_limbs(X3), to_limbs(Y3), to_limbs(Z3), same_x and not same_y]


def point_add_aff_words(p1, p2):
    """`point_add_aff_kernel` on one point: p = ([35 limbs] x2, inf)."""
    (x1, y1, inf1), (x2, y2, inf2) = p1, p2
    if inf1 or inf2:  # the other operand as given, Z the limbs of one
        src = p2 if inf1 else p1
        return [list(src[0]), list(src[1]), store_limbs(EXITW), inf1 and inf2]
    X1, X2, Y1, Y2 = (from_limbs(c) for c in (x1, x2, y1, y2))
    same_x, same_y = eqw(X1, X2), eqw(Y1, Y2)
    if same_x and same_y:  # dbl-2007-bl with Z1 = one
        X3, Y3 = point_double_w(X1, Y1)
        Z3 = dblw(Y1)
    else:  # the chord with Z1 = Z2 = one: U = X, S = Y
        X3, Y3, H = point_chord_w(X1, X2, Y1, Y2)
        Z3 = dblw(H)
    return [to_limbs(X3), to_limbs(Y3), to_limbs(Z3), same_x and not same_y]


# --- inputs ----------------------------------------------------------------

rng = np.random.default_rng(20261021)


def _value(limbs):
    return tfq.limbs_to_int(limbs)


def _canon_limbs(v):
    return tfq.int_to_limbs([v])[0]


def _raw_limbs(v):
    """Limbs in [0, 2^12) of a nonnegative v < 2^408, not reduced mod q."""
    return np.asarray([(v >> (12 * k)) & 0xFFF for k in range(35)], dtype=np.int32)


def _wide_limbs():
    """Limbs 0..32 at +-(2^12 + 2) with random signs, limb 33 the opposite
    sign's 1 so the value stays below 2^387 (a value of its own: the
    extremes of the limb bound cannot match a given residue)."""
    limbs = rng.choice([-(2**12 + 2), 2**12 + 2], size=35).astype(np.int32)
    limbs[33] = -np.sign(limbs[32])
    limbs[34] = 0
    return limbs


def _far_reps(v):
    """Representatives far from canonical: limbs at +-(2^12 + 2) (of
    another value), then of v itself: near +2^13 q, near -2^13 q, and
    negative as sub_mod(0, .) leaves it."""
    k = (1 << 13) - 2
    return [
        _wide_limbs(),
        _raw_limbs(v + k * Q),
        -_raw_limbs(k * Q + (Q - v) % Q),
        -_canon_limbs((Q - v) % Q),
    ]


def _rand_fq(n):
    return [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(n)]


def test_canonical_matches_int_reduction():
    """canonical(t) == the limbs of value(t) mod q, on random relaxed
    representatives, negative ones and the extremes."""
    vals = _rand_fq(16) + [0, 1, Q - 1]
    reps = [r for v in vals for r in _far_reps(v)]
    reps += [_canon_limbs(v) for v in vals]
    reps.append(_raw_limbs(Q))            # q itself
    reps.append(-_raw_limbs(1))           # -1
    for v in vals[:4] + [1]:              # -v as 2^408 - v with top limb -1
        r = _raw_limbs((1 << 408) - v)
        r[34] = -1
        reps.append(r)
    a = torch.from_numpy(np.stack(_rand_fq_limbs(8)).T.copy())
    b = torch.from_numpy(np.stack(_rand_fq_limbs(8)).T.copy())
    lazy = [tfq.mont_mul(a, b), tfq.sub_mod(torch.zeros_like(a), a), tfq.add_mod(a, b)]
    t = torch.from_numpy(np.stack(reps).T.copy())
    t = torch.cat([t] + lazy, dim=1)
    got = tfq.canonical(t)
    for i in range(t.shape[1]):
        assert got[:, i].tolist() == _canon_limbs(_value(t[:, i].tolist())).tolist(), i
    assert int(got.min()) >= 0 and int(got.max()) < 4096 and not got[34].any()


def _rand_fq_limbs(n):
    return list(tfq.int_to_limbs(_rand_fq(n)))


def test_word_entry_product_exit_match_mont_mul():
    """from_words(mont384(to_words(a), to_words(b))) == fq_mont.mont_mul(a,
    b) mod q, canonical out, on canonical, lazy and far-from-canonical
    inputs; the entry lands in [0, 2q) with value v 2^-24 mod q."""
    inv24 = pow(2, -24, Q)
    vals = _rand_fq(6) + [0, Q - 1]
    reps = [r for v in vals for r in _far_reps(v)] + [_canon_limbs(v) for v in vals]
    a = np.stack(reps)
    b = np.roll(a, 5, axis=0)
    want = tfq.canonical(tfq.mont_mul(torch.from_numpy(a.T.copy()), torch.from_numpy(b.T.copy())))
    for i in range(len(a)):
        wa, wb = from_limbs(a[i]), from_limbs(b[i])
        assert _int(wa) < 2 * Q and _int(wa) % Q == _value(a[i]) * inv24 % Q
        prod = mont(wa, wb)
        assert _int(prod) < 2 * Q
        out = to_limbs(prod)
        assert out == want[:, i].tolist(), i
        assert out[34] == 0


def test_ptx_chain_product_equals_cios():
    """The carry-chain form of the product (the kernel's) equals the u64
    CIOS form word for word, on random and edge operands < 2q."""
    edge = [0, 1, Q - 1, Q, 2 * Q - 1, (1 << 382) % (2 * Q)]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [(x, y) for x, y in zip(_rand_fq(200), _rand_fq(200))]
    pairs += [(x + Q, y) for x, y in zip(_rand_fq(50), _rand_fq(50))]
    for x, y in pairs:
        assert mont_chains(_words(x), _words(y)) == mont(_words(x), _words(y))


def test_word_add_sub_stay_lazy():
    """addw, subw, dblw keep [0, 2q) and the value mod q, at the edges."""
    edge = [0, 1, Q - 1, Q, Q + 1, 2 * Q - 1]
    for x in edge + _rand_fq(4):
        for y in edge:
            a, b = _words(x), _words(y)
            for got, want in ((addw(a, b), x + y), (subw(a, b), x - y), (dblw(a, 3), 8 * x)):
                assert _int(got) < 2 * Q and (_int(got) - want) % Q == 0
            assert eqw(a, b) == ((x - y) % Q == 0)


def _mont_points(n):
    arr = nb.g1_fixed_base_batch([int(s) for s in rng.integers(1, 2**31, n)])
    xs, ys = _points_std_limbs(arr, n)
    X = tfq.to_mont(torch.from_numpy(xs.T.copy()))
    Y = tfq.to_mont(torch.from_numpy(ys.T.copy()))
    return X, Y


def _columns(p, i):
    return [c[:, i].tolist() for c in p[:-1]] + [bool(p[-1][i])]


def _check_by_value(p1, p2):
    want = fq.point_add(p1, p2)
    canon = [tfq.canonical(c) for c in want[:3]]
    for i in range(p1[0].shape[1]):
        got = point_add_words(_columns(p1, i), _columns(p2, i))
        assert got[3] == bool(want[3][i]), i
        if p1[3][i] or p2[3][i]:  # copies the other operand as given
            assert got[:3] == [c[:, i].tolist() for c in want[:3]], i
        else:
            assert got[:3] == [c[:, i].tolist() for c in canon], i
    return want


@pytest.mark.parametrize("z_one", [True, False])
def test_point_add_words_matches_plain_by_value(z_one):
    """The transcribed K5 flow == plain point_add mod q, flags exactly, on
    the chord, doubling, P + (-P) and infinity rows; with Z != one, the
    operands are the plain outputs of a first add."""
    m = 12
    X, Y = _mont_points(m)
    perm = torch.from_numpy(rng.permutation(m))
    X2, Y2 = X[:, perm].clone(), Y[:, perm].clone()
    X2[:, :5] = X[:, :5]          # 0:3 doubling, 3:5 P + (-P)
    Y2[:, :3] = Y[:, :3]
    Y2[:, 3:5] = tfq.sub_mod(torch.zeros_like(Y[:, 3:5]), Y[:, 3:5])
    inf1 = torch.zeros(m, dtype=torch.bool)
    inf2 = torch.zeros(m, dtype=torch.bool)
    inf1[5], inf2[6], inf1[7], inf2[7] = True, True, True, True
    one = tfq.consts("cpu")["one"][:, None].expand(35, m).contiguous()
    p1, p2 = (X, Y, one, inf1), (X2, Y2, one.clone(), inf2)
    if not z_one:  # P1 + P2 and 2 P1: the doubling rows meet again
        p1, p2 = fq.point_add(p1, p2), fq.point_add(p1, p1)
    _check_by_value(p1, p2)


def test_point_add_words_far_from_canonical():
    """The transcribed K5 == plain point_add mod q on operands whose limbs
    sit at +-(2^12 + 2), whose values are near +-2^13 q, or negative."""
    m = 4
    X, Y = _mont_points(m)
    one = tfq.consts("cpu")["one"][:, None].expand(35, m).contiguous()
    first = fq.point_add((X, Y, one, torch.zeros(m, dtype=torch.bool)),
                         (X.roll(1, 1), Y.roll(1, 1), one, torch.zeros(m, dtype=torch.bool)))
    for pick in range(4):
        def far(t):
            return torch.from_numpy(np.stack(
                [_far_reps(_value(t[:, i].tolist()) % Q)[pick] for i in range(m)]).T.copy())
        p1 = (far(first[0]), far(first[1]), far(first[2]), torch.zeros(m, dtype=torch.bool))
        p2 = (far(X), far(Y), far(one), torch.zeros(m, dtype=torch.bool))
        _check_by_value(p1, p2)
        # the doubling path on far operands: p + p under another representative
        _check_by_value(p1, (first[0], first[1], first[2], p1[3]))


def test_exact_reference_matches_words():
    """fq.point_add_exact (the host referee) == the transcribed K5 flow,
    on every path, with Z != one and on far operands."""
    m = 8
    X, Y = _mont_points(m)
    one = tfq.consts("cpu")["one"][:, None].expand(35, m).contiguous()
    flags = torch.zeros(m, dtype=torch.bool)
    flags[5] = True
    p1 = (X, Y, one, flags)
    p2 = (X.roll(1, 1), Y.roll(1, 1), one, torch.zeros(m, dtype=torch.bool))
    p2[0][:, :2], p2[1][:, :2] = X[:, :2], Y[:, :2]             # doubling
    p2[1][:, 2] = tfq.sub_mod(torch.zeros_like(Y[:, 2]), Y[:, 2])  # P + (-P)
    p2[0][:, 2] = X[:, 2]
    q1 = fq.point_add(p1, p2)
    far = tuple(torch.from_numpy(np.stack(
        [_far_reps(_value(c[:, i].tolist()) % Q)[2] for i in range(m)]).T.copy())
        for c in q1[:3]) + (q1[3],)
    for a, b in ((p1, p2), (q1, p1), (far, q1)):
        got = fq.point_add_exact(a, b)
        for i in range(m):
            want = point_add_words(_columns(a, i), _columns(b, i))
            assert [c[:, i].tolist() for c in got[:3]] == want[:3], i
            assert bool(got[3][i]) == want[3], i


def test_relaxed_equality_test_errs_where_words_do_not():
    """The fault the exact referee exists for (ROADMAP Queue 3): -q written
    with its top limb -1 over limbs at 2^12 - 1 (as a product near -q comes
    out) cancels in the f32 quotient estimate, and is_zero_mod_q (the JAX
    package's arithmetic) calls it nonzero.  K5's entry and word compare
    see zero; canonical() sees zero."""
    rep = _raw_limbs((1 << 408) - Q)
    rep[34] = -1
    assert _value(rep) == -Q
    t = torch.from_numpy(rep[:, None].copy())
    assert not bool(tfq.is_zero_mod_q(t)[0])
    assert eqw(from_limbs(rep), [0] * 12)
    assert not tfq.canonical(t).any()


def test_value_check_measures_against_the_referee():
    """fq_check.value_check, K5's check on the card, here on CPU tensors:
    0 for an output equal by value (canonical limbs against the plain
    version's relaxed ones); a row where the plain version is wrong goes to
    the exact referee and counts as decided, not as an error; a wrong
    coordinate or flag of K5 shows as a limb or flag difference."""
    from falcon_r1cs_tpu_torch.ops import fq_check

    m = 6
    X, Y = _mont_points(m)
    one = tfq.consts("cpu")["one"][:, None].expand(35, m).contiguous()
    flags = torch.zeros(m, dtype=torch.bool)
    p1 = (X, Y, one, flags)
    p2 = (X.roll(1, 1), Y.roll(1, 1), one, flags)
    p2[0][:, 0], p2[1][:, 0] = X[:, 0], Y[:, 0]  # a doubling row
    want = fq.point_add(p1, p2)
    got = tuple(tfq.canonical(c) for c in want[:3]) + (want[3].clone(),)
    assert fq_check.value_check(got, want, p1, p2) == (0, 0)
    bad_want = tuple(c.clone() for c in want)
    bad_want[1][:, 2] = tfq.add_mod(bad_want[1][:, 2:3], one[:, :1])[:, 0]
    bad_want[3][4] = True
    assert fq_check.value_check(got, bad_want, p1, p2) == (0, 2)
    bad_got = tuple(c.clone() for c in got)
    bad_got[0][5, 3] += 7
    assert fq_check.value_check(bad_got, want, p1, p2)[0] == 7
    bad_got = tuple(c.clone() for c in got)
    bad_got[3][1] = True
    assert fq_check.value_check(bad_got, want, p1, p2)[0] == 1


# --- K4 and K6 --------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 4])
def test_mont_mul_words_matches_chain(depth):
    """The transcribed K4 == fq_mont.mont_mul_chain mod q, canonical out,
    on canonical, lazy and far-from-canonical inputs: from_limbs' words
    stand for the limbs' field element, so the chain in R' = 2^384 and the
    exit's 2^24 give the limb chain's value."""
    vals = _rand_fq(4) + [0, 1, Q - 1]
    reps = [r for v in vals for r in _far_reps(v)] + [_canon_limbs(v) for v in vals]
    a = np.stack(reps)
    b = np.roll(a, 3, axis=0)
    ta, tb = torch.from_numpy(a.T.copy()), torch.from_numpy(b.T.copy())
    want = tfq.mont_mul_chain(ta, tb, depth)
    got = torch.tensor([mont_mul_words(a[i], b[i], depth) for i in range(len(a))]).T
    assert torch.equal(got, tfq.canonical(want))
    assert int(got.min()) >= 0 and int(got.max()) < 4096 and not got[34].any()
    v = [(_value(x) * pow(_value(y) * pow(2, -408, Q), depth, Q)) % Q for x, y in zip(a, b)]
    assert got.T.tolist() == [_canon_limbs(x).tolist() for x in v]


def _affine_points(n):
    """n random G1 points as canonical Montgomery limbs, as K4 gives them."""
    X, Y = _mont_points(n)
    return tfq.canonical(X), tfq.canonical(Y)


def _check_aff_by_value(a1, a2):
    """The transcribed K6 == plain point_add_aff by value, flags exactly;
    infinity rows limb for limb (the other operand as given, Z = one).
    Where the two differ, the exact referee on the operands lifted to Z =
    one decides.  Returns the rows it decided."""
    from falcon_r1cs_tpu_torch.ops import fq_check

    want = fq.point_add_aff(a1, a2)
    canon = [tfq.canonical(c) for c in want[:3]] + [want[3]]
    exact = fq.point_add_exact(fq_check.jacobian(a1), fq_check.jacobian(a2))
    decided = []
    for i in range(a1[0].shape[1]):
        got = point_add_aff_words(_columns(a1, i), _columns(a2, i))
        if a1[2][i] or a2[2][i]:
            assert got == _columns(want, i), i
            continue
        if got != _columns(canon, i):
            decided.append(i)
            assert got == _columns(exact, i), i
    return decided


@pytest.mark.parametrize("neg_y", [False, True])
def test_point_add_aff_words_matches_plain_by_value(neg_y):
    """The transcribed K6 == plain point_add_aff mod q, flags exactly, on
    the doubling, P + (-P), inf1, inf2, both-infinite and chord rows, on
    canonical Y and on negated canonical Y (every limb <= 0, as the MSM's
    signed digits feed it)."""
    m = 12
    X, Y = _affine_points(m)
    perm = torch.from_numpy(rng.permutation(m))
    X2, Y2 = X[:, perm].clone(), Y[:, perm].clone()
    X2[:, :5] = X[:, :5]          # 0:3 doubling, 3:5 P + (-P)
    Y2[:, :3] = Y[:, :3]
    Y2[:, 3:5] = tfq.canonical(-Y[:, 3:5])
    if neg_y:
        sign = torch.from_numpy(rng.integers(0, 2, m).astype(bool))
        Y, Y2 = torch.where(sign, -Y, Y), torch.where(sign, -Y2, Y2)
        assert int(Y[:, sign].max()) <= 0
    inf1 = torch.zeros(m, dtype=torch.bool)
    inf2 = torch.zeros(m, dtype=torch.bool)
    inf1[5], inf2[6], inf1[7], inf2[7] = True, True, True, True
    assert _check_aff_by_value((X, Y, inf1), (X2, Y2, inf2)) == []
    want = fq.point_add_aff((X, Y, inf1), (X2, Y2, inf2))
    assert want[3].tolist() == [False] * 3 + [True] * 2 + [False] * 2 + [True] + [False] * 4


def test_point_add_aff_words_far_from_canonical():
    """The transcribed K6 == plain point_add_aff mod q on X and Y far from
    canonical (limbs at +-(2^12 + 2), values near +-2^13 q, negatives),
    against the same point (the doubling path but for "wide", a value of
    its own) and against other points (the chord)."""
    m = 4
    X, Y = _affine_points(m)
    no = torch.zeros(m, dtype=torch.bool)
    for pick in range(4):
        def far(t):
            return torch.from_numpy(np.stack(
                [_far_reps(_value(t[:, i].tolist()) % Q)[pick] for i in range(m)]).T.copy())
        a1 = (far(X), far(Y), no)
        for a2 in ((X, Y, no), (X.roll(1, 1), -Y.roll(1, 1), no)):
            _check_aff_by_value(a1, a2)


def test_relaxed_equality_row_goes_to_the_referee():
    """The Queue 3 input at K6: X1 = -q written with top limb -1 over
    limbs at 2^12 - 1 (zero), X2 = 0, Y1 = Y2 = the limbs of 2 (the point
    (0, 2) of y^2 = x^3 + 4).  The JAX package's f32-steered test
    (`fq_mont.eq_mod_q`, kept bit-equal) calls X1 and X2 unequal, which
    would send the row down the chord (Z = 2 H = 0).  The words and the
    plain version's exact test (`fq.eq_exact`) see X1 == X2 and take the
    doubling path; the exact referee agrees, so fq_check.value_check
    finds nothing left for it to decide."""
    from falcon_r1cs_tpu_torch.ops import fq_check

    rep = _raw_limbs((1 << 408) - Q)
    rep[34] = -1
    two = _canon_limbs(2 * tfq.R_MONT % Q)
    X, Y = _affine_points(1)
    x1 = torch.from_numpy(np.stack([rep, X[:, 0].numpy()]).T.copy())
    y1 = torch.from_numpy(np.stack([two, Y[:, 0].numpy()]).T.copy())
    x2 = torch.from_numpy(np.stack([np.zeros(35, np.int32), X[:, 0].numpy()]).T.copy())
    no = torch.zeros(2, dtype=torch.bool)
    a1, a2 = (x1, y1, no), (x2, y1.clone(), no)
    assert not bool(tfq.eq_mod_q(x1, x2)[0]) and fq.eq_exact(x1, x2).all()
    assert _check_aff_by_value(a1, a2) == []
    want = fq.point_add_aff(a1, a2)
    four = _canon_limbs(4 * tfq.R_MONT % Q).tolist()
    assert tfq.canonical(want[2])[:, 0].tolist() == four  # the doubling's Z = 2 Y1
    got = [torch.tensor([point_add_aff_words(_columns(a1, i), _columns(a2, i))[k]
                         for i in range(2)]).T for k in range(3)]
    got.append(torch.zeros(2, dtype=torch.bool))
    assert tfq.canonical(got[2])[:, 0].tolist() == four
    assert fq_check.value_check(tuple(got), want, a1, a2) == (0, 0)


def test_value_check_affine_and_product():
    """fq_check.value_check on K6's and K4's forms: affine operands lifted
    to Z = one for the referee (a row where the plain version is wrong is
    decided, not an error; a wrong coordinate of the kernel shows as a limb
    difference), and a bare (35, m) product with no referee."""
    from falcon_r1cs_tpu_torch.ops import fq_check

    m = 6
    X, Y = _affine_points(m)
    no = torch.zeros(m, dtype=torch.bool)
    inf2 = no.clone()
    inf2[1] = True
    a1, a2 = (X, Y, no), (X.roll(1, 1), Y.roll(1, 1), inf2)
    a2[0][:, 0], a2[1][:, 0] = X[:, 0], Y[:, 0]  # a doubling row
    lifted = fq_check.jacobian(a1)
    assert torch.equal(lifted[2], tfq.consts("cpu")["one"][:, None].expand(35, m))
    assert fq_check.jacobian(lifted) is lifted
    want = fq.point_add_aff(a1, a2)
    got = tuple(tfq.canonical(c) for c in want[:3]) + (want[3].clone(),)
    assert fq_check.value_check(got, want, a1, a2) == (0, 0)
    bad_want = tuple(c.clone() for c in want)
    bad_want[0][:, 3] = tfq.add_mod(bad_want[0][:, 3:4], bad_want[2][:, 3:4])[:, 0]
    bad_want[3][5] = True
    assert fq_check.value_check(got, bad_want, a1, a2) == (0, 2)
    bad_got = tuple(c.clone() for c in got)
    bad_got[2][0, 4] += 3
    assert fq_check.value_check(bad_got, want, a1, a2)[0] == 3
    prod = tfq.mont_mul_chain(X, Y, 2)
    assert fq_check.value_check((tfq.canonical(prod),), (prod,)) == (0, 0)
    wrong = tfq.canonical(prod)
    wrong[7, 2] ^= 1
    assert fq_check.value_check((wrong,), (prod,)) == (1, 0)
