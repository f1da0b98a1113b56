"""The Fr arithmetic of the witness map's kernels, on the CPU: the plain
torch versions of `ops/fr.py` against Python ints, and a Python-int
transcription of `csrc/fr_mont.cu` (its CIOS carry chains, its add and
subtract, its entry reduction, its exit placement, its power exponents,
its transform tile's register phases, exchanges and twiddle indexing,
and its sparse product's row bins and summation order) against both.

The CUDA kernels cannot run here, so their word arithmetic and schedule
are transcribed, with 32-bit wrapping made explicit; the word constants,
n0' and the exchange swizzle are parsed from the CUDA source text, so a
typo there fails here before any run on a card.  The schedules run on
the integer values of the same Montgomery forms (each product a b
2^-256 mod r, which the word transcription is held to).  Everything is
integer arithmetic: tolerance 0.  No JAX is imported.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from falcon_r1cs_tpu_torch.ops import fr
from falcon_r1cs_tpu_torch.snark.fr import fft, root_of_unity

R = fr.R
M32 = (1 << 32) - 1
SRC = (Path(fr.__file__).resolve().parents[1] / "csrc" / "fr_mont.cu").read_text()
RINV_MONT = pow(1 << 256, -1, R)


def _table(name):
    body = re.search(rf"__constant__ u32 {name}\[kW\] = \{{(.*?)\}};", SRC, re.S).group(1)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)u", body)]


def _words(v):
    return [(v >> (32 * j)) & M32 for j in range(8)]


def _int(w):
    return sum(x << (32 * j) for j, x in enumerate(w))


RW, R2W = _table("c_rw"), _table("c_r2w")
RINV = int(re.search(r"constexpr u32 kRInv = 0x([0-9a-f]+)u;", SRC).group(1), 16)
TILE_LOG = int(re.search(r"constexpr int kTileLog = (\d+);", SRC).group(1))
PER_LOG = int(re.search(r"constexpr int kPerLog = (\d+);", SRC).group(1))
PER = 1 << PER_LOG
SPMV_THREADS = int(re.search(r"constexpr int kSpmvThreads = (\d+);", SRC).group(1))
ENTRY_THREADS = int(re.search(r"constexpr int kEntryThreads = (\d+);", SRC).group(1))
ENTRY_PER = int(re.search(r"constexpr int kEntryPer = (\d+);", SRC).group(1))
EXIT_SIDE_LOG = int(re.search(r"constexpr int kExitSideLog = (\d+);", SRC).group(1))
EXIT_PER = int(re.search(r"constexpr int kExitPer = (\d+);", SRC).group(1))
POW = {name: int(re.search(rf"constexpr int kPow{name} = (\d+);", SRC).group(1))
       for name in ("Threads", "LowLog", "HighLog", "MinCtaLog")}
# the exchange swizzle of csrc/fr_mont.cu swz(): index bit -> the bank bits it flips
SWZ = {int(b): int(f, 16) for b, f in re.findall(r"\(\(e >> (\d)\) & 1\) \* 0x([0-9a-f]+)", SRC)}
VALUES = [0, 1, 2, R - 1, R - 2, (R - 1) // 2, 1 << 254] + [
    int.from_bytes(np.random.default_rng(s).bytes(32), "little") % R for s in range(40)]


def test_source_constants():
    """r's words, R'^2 mod r, R' mod r and n0' in csrc/fr_mont.cu equal those
    derived from r; the tile, its elements a thread, the sparse product's
    CTA, the entry's and exit's layouts and the power tables' tile
    constants of the .cu are the wrapper's; 2r fits
    256 bits and 4r does not (so nothing in the kernels is lazy)."""
    assert RW == _words(R) and R2W == _words(pow(2, 512, R))
    assert RINV == (-pow(R, -1, 1 << 32)) % (1 << 32) == M32
    assert (TILE_LOG, PER, SPMV_THREADS) == (fr.TILE_LOG, fr.TILE_PER, fr.SPMV_THREADS)
    assert (ENTRY_THREADS, ENTRY_PER, EXIT_SIDE_LOG, EXIT_PER) == (
        fr.ENTRY_THREADS, fr.ENTRY_PER, fr.EXIT_SIDE_LOG, fr.EXIT_PER)
    assert (POW["Threads"], POW["LowLog"], POW["HighLog"], POW["MinCtaLog"]) == (
        fr.POW_THREADS, fr.POW_LOW_LOG, fr.POW_HIGH_LOG, fr.POW_MIN_CTA_LOG)
    assert 2 * R < 1 << 256 < 4 * R and 1 << 256 < 3 * R
    assert fr.R_MONT == (1 << 256) % R
    assert _table("c_onew") == _words(fr.R_MONT)


# --- the transcription of csrc/fr_mont.cu -----------------------------------


def _chain(t, steps):
    """One PTX carry chain over the words t: each step t[dst] = add() +
    the carry in, its carry out to the next; the last carry returned."""
    cf = 0
    for dst, add in steps:
        s = add() + cf
        t[dst], cf = s & M32, s >> 32
    return cf


def reduce_round(t):
    """`reduce_round`: m = t_0 n0', t += lo(m r) (carry into t[8]), then t =
    (t + hi(m r) one word up) / 2^32 written one word down; t[8] = 0."""
    m = (t[0] * RINV) & M32
    cf = _chain(t, [(j, lambda j=j: ((m * RW[j]) & M32) + t[j]) for j in range(8)])
    assert t[0] == 0
    t[8] += cf
    assert t[8] <= M32
    cf = _chain(t, [(j, lambda j=j: ((m * RW[j]) >> 32) + t[j + 1]) for j in range(8)])
    assert cf == 0
    t[8] = 0


def mont(a, b, rounds=range(8)):
    """`mont` as the kernel computes it: per word b_i four PTX carry chains
    (mad.lo.cc / madc.lo.cc, addc, mad.hi.cc / madc.hi.cc, madc.hi), the
    last writing one word down (the shift), over t[0..8]; then t - r
    unless that borrows.  The a b_i chains run only in `rounds` (the word
    skip: the rounds where some lane of the warp has b_i != 0); the
    reduction round always runs."""
    t = [0] * 9
    for i in range(8):
        bi = b[i]
        if i in rounds:
            cf = _chain(t, [(j, lambda j=j: ((a[j] * bi) & M32) + t[j]) for j in range(8)])
            t[8] += cf
            assert t[8] <= M32
            cf = _chain(t, [(j + 1, lambda j=j: ((a[j] * bi) >> 32) + t[j + 1])
                            for j in range(8)])
            assert cf == 0  # no carry out of t[8]
        reduce_round(t)
    return cond_sub(t[:8], RW)


def redc(v):
    """`redc`: t = v's words, 8 reduction rounds, one conditional
    subtraction of r."""
    t = list(v) + [0]
    for _ in range(8):
        reduce_round(t)
    return cond_sub(t[:8], RW)


def cond_sub(x, m):
    """x - m over 8 words unless that borrows (the sub.cc chain, then the
    borrow word 0 - 0 - borrow as the select)."""
    d, borrow = [], 0
    for j in range(8):
        p = x[j] - m[j] - borrow
        d.append(p & M32)
        borrow = int(p < 0)
    return list(x) if borrow else d


def add(a, b):
    s, c = [], 0
    for j in range(8):
        p = a[j] + b[j] + c
        s.append(p & M32)
        c = p >> 32
    assert c == 0  # a + b < 2r < 2^256
    return cond_sub(s, RW)


def sub(a, b):
    d, borrow = [], 0
    for j in range(8):
        p = a[j] - b[j] - borrow
        d.append(p & M32)
        borrow = int(p < 0)
    if not borrow:
        return d
    e, c = [], 0
    for j in range(8):
        p = d[j] + RW[j] + c
        e.append(p & M32)
        c = p >> 32
    return e


def entry(v):
    """fr_to_mont_kernel: two conditional subtractions of r, one product by R'^2."""
    x = _words(v)
    for _ in range(2):
        x = cond_sub(x, RW)
    return mont(x, R2W)


def entry_warp(values):
    """fr_to_mont_kernel on one warp's slot of 32 rows (the lanes past
    `values` hold 0, as lanes past n do): each lane's x reduced twice; if
    some lane's x has word 7 nonzero, the product x R'^2 of `entry`, every
    round; else the product R'^2 x with x the b operand, whose round i runs
    its a b_i chains only where some lane's x_i != 0 (the __any_sync
    votes).  The lanes' words and the rounds that ran."""
    xs = []
    for v in list(values) + [0] * (32 - len(values)):
        x = _words(v)
        for _ in range(2):
            x = cond_sub(x, RW)
        xs.append(x)
    if any(x[7] for x in xs):
        return [mont(x, R2W) for x in xs[:len(values)]], list(range(8))
    rounds = [i for i in range(7) if any(x[i] for x in xs)]
    return [mont(R2W, x, rounds) for x in xs[:len(values)]], rounds


def exit_row(i, log_n):
    """fr_from_mont_kernel's row of element i: i's log_n bits reversed."""
    return int(f"{i:0{log_n}b}"[::-1], 2)


def exponent(i, log_n, mode):
    """fr_powers_kernel's e(i)."""
    if mode == fr.MODE_BITREV:
        return exit_row(i, log_n)
    if not i:
        return 0
    lh = i.bit_length() - 1  # 31 - clz(i)
    return (i - (1 << lh)) << (log_n - 1 - lh)


# -- the schedules, on the integer values of Montgomery forms -----------------


def imont(a, b):
    return a * b * RINV_MONT % R


def butterfly(u, v, w, dif):
    if dif:
        return (u + v) % R, imont((u - v) % R, w)
    t = imont(v, w)
    return (u + t) % R, (u - t) % R


def swz(e):
    """csrc/fr_mont.cu swz(): the exchange slot of tile element e."""
    for bit, flips in SWZ.items():
        e ^= ((e >> bit) & 1) * flips
    return e


def elem(q, s, m):
    """The tile element of slot m of thread q on the bit set s."""
    return (q & ((1 << s) - 1)) | (m << s) | ((q >> s) << (s + PER_LOG))


def dif_phases(log_t):
    """(s, lo, hi) of the DIF phases, from the widest stage."""
    hi = log_t - 1
    while hi >= 0:
        yield max(0, hi - PER_LOG + 1), max(0, hi - PER_LOG + 1), hi
        hi -= PER_LOG


def dit_phases(log_t):
    """(s, lo, hi) of the DIT phases, from the narrowest stage."""
    top = max(0, log_t - PER_LOG)
    for lo in range(0, log_t, PER_LOG):
        yield min(lo, top), lo, min(lo + PER_LOG - 1, log_t - 1)


def tile_kernel(xs, tw, dif, scale=None, tw_dit=None, stats=None):
    """fr_ntt_tile_kernel over the vectors xs (lists of n values, in
    place): every CTA's tile, its t / PER threads in lockstep, each
    holding its slots in registers; phases as the kernel runs them, each
    exchange through the swizzled planes (a dict, every slot written
    once); twiddles from the prefix tw[0 .. t).  `stats` counts the
    exchanges of a tile."""
    n = len(xs[0])
    log_t = min(n.bit_length() - 1, TILE_LOG)
    t = 1 << log_t
    threads, slots, top = max(1, t // PER), min(PER, t), max(0, log_t - PER_LOG)
    form = "dit" if not dif else ("round trip" if tw_dit is not None else "dif")
    for x in xs:
        for base in range(0, n, t):
            r = [[x[base + elem(q, top, m)] for m in range(slots)] for q in range(threads)]
            sets = [top]

            def exchange(to):
                sx = {}
                for q in range(threads):
                    for m in range(slots):
                        e = swz(elem(q, sets[-1], m))
                        assert e not in sx and 0 <= e < t
                        sx[e] = r[q][m]
                for q in range(threads):
                    r[q] = [sx[swz(elem(q, to, m))] for m in range(slots)]
                sets.append(to)

            def phase(phase_dif, s, lo, hi, table):
                if s != sets[-1]:
                    exchange(s)
                for c in range(PER_LOG):
                    b = PER_LOG - 1 - c if phase_dif else c
                    lh = s + b
                    if not lo <= lh <= hi:
                        continue
                    for q in range(threads):
                        low = q & ((1 << s) - 1)
                        for pair in range(PER // 2):
                            m = ((pair >> b) << (b + 1)) | (pair & ((1 << b) - 1))
                            if m >= slots:
                                continue
                            w = table[(1 << lh) + (low | ((m & ((1 << b) - 1)) << s))]
                            r[q][m], r[q][m + (1 << b)] = butterfly(
                                r[q][m], r[q][m + (1 << b)], w, phase_dif)

            if form != "dit":
                for s, lo, hi in dif_phases(log_t):
                    phase(True, s, lo, hi, tw[:t])
                if form == "dif" and sets[-1] != top:
                    exchange(top)
                if scale is not None:
                    for q in range(threads):
                        r[q] = [imont(v, scale[base + elem(q, sets[-1], m)])
                                for m, v in enumerate(r[q])]
            if form != "dif":
                for s, lo, hi in dit_phases(log_t):
                    phase(False, s, lo, hi, (tw if form == "dit" else tw_dit)[:t])
            assert sets[-1] == top
            for q in range(threads):
                for m in range(slots):
                    x[base + elem(q, top, m)] = r[q][m]
            if stats is not None:
                stats[form] = len(sets) - 1
    return xs


def stage_kernel(x, tw, lh, dif):
    """fr_ntt_stage_kernel: thread b the butterfly of index map
    ((b >> lh) << (lh + 1)) | j, j = b mod h."""
    h = 1 << lh
    for b in range(len(x) // 2):
        j = b & (h - 1)
        i = ((b >> lh) << (lh + 1)) | j
        x[i], x[i + h] = butterfly(x[i], x[i + h], tw[h + j], dif)


def kernel_ntt(x, tw, dif, scale=None):
    """The transform as fr.ntt launches it, on one vector (in place)."""
    wide = range(TILE_LOG, len(x).bit_length() - 1)
    if dif:
        for lh in reversed(wide):
            stage_kernel(x, tw, lh, True)
        tile_kernel([x], tw, True, scale)
    else:
        tile_kernel([x], tw, False)
        for lh in wide:
            stage_kernel(x, tw, lh, False)
    return x


def kernel_coset_ntt(xs, tw_inv, tw, scale):
    """fr.coset_ntt as it launches: the wide DIF stages of each vector, one
    round-trip tile over all of them, the wide DIT stages."""
    wide = range(TILE_LOG, len(xs[0]).bit_length() - 1)
    for lh in reversed(wide):
        for x in xs:
            stage_kernel(x, tw_inv, lh, True)
    tile_kernel(xs, tw_inv, True, scale, tw)
    for lh in wide:
        for x in xs:
            stage_kernel(x, tw, lh, False)
    return xs


def _mont_words(v):
    return _words(v * (1 << 256) % R)


def _value(w):
    return _int(w) * RINV_MONT % R


# --- the transcription against Python ints ------------------------------------


def test_transcribed_word_arithmetic():
    """mont, add, sub and the entry of the .cu, at 0, 1, r - 1 and seeded
    values, pairwise, against Python ints; the entry also on r, 2r and
    2^256 - 1 (reduced)."""
    for a in VALUES[:12]:
        for b in VALUES[::3]:
            wa, wb = _words(a), _words(b)
            assert _int(mont(wa, wb)) == a * b * RINV_MONT % R
            assert _int(add(wa, wb)) == (a + b) % R
            assert _int(sub(wa, wb)) == (a - b) % R
    for v in VALUES + [R, 2 * R, (1 << 256) - 1]:
        assert _value(entry(v)) == v % R
        assert _int(mont(entry(v), [1] + [0] * 7)) == v % R  # the exit: canonical


@pytest.mark.parametrize("v", [0, 1, R - 1, R, 2 * R, (1 << 256) - 1] + [
    int.from_bytes(np.random.default_rng(500 + s).bytes(32), "little") for s in range(6)])
def test_transcribed_reduction(v):
    """The exit's reduction (`redc`: 8 rounds, one subtraction, no product)
    is v 2^-256 mod r, canonical, for any v < 2^256, and below r equals
    the product by 1 (`mont(x, 1)`, the exit before) word for word."""
    w = _words(v)
    assert _int(redc(w)) == v * RINV_MONT % R
    if v < R:
        assert redc(w) == mont(w, [1] + [0] * 7)


def _top_zero(t, seed):
    """A seeded value whose top t words are 0 and whose word 7 - t is not."""
    if t == 8:
        return 0
    v = int.from_bytes(np.random.default_rng(seed).bytes(32), "little") >> (32 * t)
    return v | 1 << (32 * (8 - t) - 1)


ENTRY_CASES = [("0", 0), ("1", 1), ("r - 1", R - 1), ("r", R), ("2r", 2 * R),
               ("2^256 - 1", (1 << 256) - 1)] + [
    (f"top {t} words 0", _top_zero(t, 600 + t)) for t in range(9)] + [
    (f"seeded {s}", int.from_bytes(np.random.default_rng(700 + s).bytes(32), "little"))
    for s in range(4)]


@pytest.mark.parametrize("name, v", ENTRY_CASES, ids=[c[0] for c in ENTRY_CASES])
def test_transcribed_entry_word_skip(name, v):
    """The word-skipping entry on a warp's 32 rows equals entry(v) (every
    round's a b_i run) word for word, with v alone (the other lanes past
    n), in every lane, at each lane among rows of 0 and 1, and beside a
    seeded full-width row; in a warp whose reduced rows all stay below
    word 7 the a b_i chains ran exactly for the words that some lane has
    nonzero (a warp of 0s and 1s: word 0 only), in any other every round.
    The product with x the b operand equals `entry`'s x R'^2 on every
    canonical value."""
    rng = np.random.default_rng(800)
    ones = rng.integers(0, 2, 32).tolist()
    full = int.from_bytes(rng.bytes(32), "little")
    layouts = [[v], [v] * 32, [full, v]] + [ones[:lane] + [v] + ones[lane + 1:]
                                              for lane in range(32)]
    for vals in layouts:
        got, rounds = entry_warp(vals)
        assert got == [entry(u) for u in vals]
        used = [i for i in range(8) if any(_words(u % R)[i] for u in vals)]
        assert rounds == (list(range(8)) if 7 in used else used)
    assert entry_warp(ones)[1] == [0] and entry_warp([0] * 32)[1] == []
    if v < R:
        assert mont(R2W, _words(v)) == entry(v)


def _rev(x, bits):
    """numpy: x with its low `bits` bits reversed (0 where bits is 0)."""
    out = np.zeros_like(x)
    for k in range(bits):
        out |= ((x >> k) & 1) << (bits - 1 - k)
    return out


def exit_walk(log_n, side_log):
    """fr_from_mont_kernel's index map as it walks, for s = min(side_log,
    log_n // 2) and 2^(2 side_log) / EXIT_PER threads a CTA: CTA m's
    thread q loads elements e = q + j threads < 2^(2 s) of its tile (a = e
    >> s, b = e's low s bits, i = a 2^(k-s) + m 2^s + b) and stages their
    halves at (2 (rev_s(b) 2^s + rev_s(a)) + h) ^ (b & 7); then thread q
    stores chunks c = q, q + threads, ... < 2^(2s+1) of the staging at
    chunk 2 row + (c & 1) of the output, row = rb 2^(k-s) + rev(m) 2^s +
    (c >> 1 & low), rb = c >> (s + 1), read from c ^ (rev_s(rb) & 7).
    Checks that the staging is a bijection and that the 8 lanes of each
    quarter warp's 16-byte shared accesses hit 8 distinct bank groups;
    that at full tiles a warp's loads are runs of 2^s consecutive elements
    and a warp's stores one contiguous span (s >= 4).  Returns (n,) int32:
    the row each element was written to."""
    n = 1 << log_n
    s = min(side_log, log_n // 2)
    threads = (1 << (2 * side_log)) // EXIT_PER
    count, low = 1 << (2 * s), (1 << s) - 1
    e = np.arange(threads)[:, None] + threads * np.arange(EXIT_PER)[None, :]  # (q, j)
    live = e < count
    a, b = e >> s, e & low
    slot = (_rev(b, s) << s) | _rev(a, s)
    pos = [(2 * slot + h) ^ (b & 7) for h in (0, 1)]
    for h in (0, 1):  # the staging writes: each instruction (j, h), quarter warps
        for j in range(EXIT_PER):
            for q0 in range(0, threads, 8):
                got = pos[h][q0:q0 + 8, j][live[q0:q0 + 8, j]]
                assert len(set((got % 8).tolist())) == len(got), (log_n, side_log, q0, j, h)
    staged = np.full(2 * count, -1, dtype=np.int64)
    for h in (0, 1):
        staged[pos[h][live]] = 2 * e[live] + h  # element of the tile, half
    assert (staged >= 0).all() and len(set(pos[0][live].tolist() + pos[1][live].tolist())) \
        == 2 * count
    c = np.arange(2 * count)
    rb = c >> (s + 1)
    read = c ^ (_rev(rb, s) & 7)
    for c0 in range(0, 2 * count, 8):  # the staging reads, quarter warps
        assert len(set((read[c0:c0 + 8] % 8).tolist())) == len(read[c0:c0 + 8])
    te, half = staged[read] >> 1, staged[read] & 1
    assert (half == (c & 1)).all()
    mid = np.arange(1 << (log_n - 2 * s), dtype=np.int32)[:, None]
    elem = ((te >> s) << (log_n - s)).astype(np.int32)[None, :] | (mid << s) | \
        (te & low).astype(np.int32)[None, :]
    row = (rb << (log_n - s)).astype(np.int32)[None, :] | \
        (_rev(mid, log_n - 2 * s) << s) | ((c >> 1) & low).astype(np.int32)[None, :]
    if s == side_log and s >= 4:
        chunk = 2 * row[0] + (c & 1)
        for c0 in range(0, 2 * count, 32):  # a warp's store: one span
            assert (np.diff(chunk[c0:c0 + 32]) == 1).all()
        loads = ((a << (log_n - s)) | b)[:, 0]
        for q0 in range(0, threads, 32):  # a warp's load: runs of 2^s
            runs = loads[q0:q0 + 32].reshape(-1, 1 << s)
            assert (np.diff(runs, axis=1) == 1).all()
    out = np.full(2 * n, -1, dtype=np.int32)
    out[(2 * row + (c & 1)).ravel()] = elem.ravel()
    assert (out[0::2] == out[1::2]).all()
    return out[0::2]


@pytest.mark.parametrize("side_log", [4, 5])
@pytest.mark.parametrize("log_n", range(1, 23))
def test_exit_tile_index_map(log_n, side_log):
    """The exit's tile, walked as the kernel walks it (CTA, a, b, the row
    written), writes every element once, element i at row bitrev(i)
    (`exit_row`), at every k from 1 to 22 with s = 4 and s = 5."""
    at_row = exit_walk(log_n, side_log)
    want = _rev(np.arange(1 << log_n, dtype=np.int32), log_n)
    assert (at_row[want] == np.arange(1 << log_n)).all()
    if log_n <= 8:
        assert at_row.tolist() == [exit_row(i, log_n) for i in range(1 << log_n)]


@pytest.mark.parametrize("mode", [fr.MODE_BITREV, fr.MODE_STAGE])
@pytest.mark.parametrize("log_n", [1, 6])
def test_power_exponents(mode, log_n):
    """fr_powers_kernel's e(i) (transcribed) equals the plain version's; the
    bit-reversed exponents are a permutation, and the stage exponent of
    index h + j is j n / 2h."""
    n = 1 << log_n
    want = [exponent(i, log_n, mode) for i in range(n)]
    assert fr.exponents(n, log_n, mode).tolist() == want
    if mode == fr.MODE_BITREV:
        assert sorted(want) == list(range(n))
    else:
        for h in (1, 2, 8, 32):
            if h < n:
                assert want[h:2 * h] == [j * n // (2 * h) for j in range(h)]


def powers_walk(log_n, mode, s, t, facs, one, c, mul, threads=POW["Threads"]):
    """fr_powers_kernel as it runs, over any product `mul` (on scalars and
    numpy arrays) of elements: facs[p] stands for base^(2^p), `one` for 1,
    `c` for c.  Source index x (i, or j < n / 2 in stage mode) has bit m
    for the factor pos(m) (k - 1 - m, or m).  CTA x0 >> (s + t): phase 1,
    leaf q a thread (LA from c over bits [0, sa), LB over [sa, s), Hp over
    [s, s + t), the first factor taken without a product), G in the last
    warp (lane l the factor of x0's l-th set bit from s + t, else 1; round
    `step` multiplies by lane l ^ step while step < popcount); phase 2, L(b)
    = LA LB, H(a) = G Hp(a); phase 3, thread q's elements e = q, q +
    threads, ..., value H(e >> s) L(e & low) written at x (bit-reversed
    mode) or at n/2 + x (stage mode); stage mode then writes, for z in 1
    .. s + t, the values of e = u 2^z (staged at h + (h >> 5), h = e / 2)
    at (n >> (z + 1)) + (x0 >> z) + u, and thread 0 x0's value at the
    levels z > s + t with 2^z | x0 (x0 = 0: up to k - 1, and at 0).
    Checks that each warp's elements are 32 consecutive x (contiguous
    stores) reading 32 distinct L columns and one H row (s >= 5), and that
    a warp's staged reads hit 32 banks up to z = 6.  Returns (out (n,),
    written (n,) counts)."""
    n = 1 << log_n
    stage = mode == fr.MODE_STAGE
    bits = log_n - stage
    assert 0 <= s and 0 <= t and s + t <= bits

    def pos(m):
        return m if stage else log_n - 1 - m

    sa = (s + 1) // 2
    na, nb, nh = 1 << sa, 1 << (s - sa), 1 << t
    assert na + nb + nh <= threads - 32  # the leaves' threads leave the last warp to G
    leaves = []
    for q in range(na + nb + nh):
        first, x, have = ((0, q, True) if q < na else (sa, q - na, False) if q < na + nb
                          else (s, q - na - nb, False))
        v = c if have else one
        for m in range(x.bit_length()):
            if x >> m & 1:
                f = facs[pos(first + m)]
                v = mul(v, f) if have else f
                have = True
        leaves.append(v)
    grid = 1 << (bits - s - t)
    hi = np.arange(grid)
    count = np.array([bin(h).count("1") for h in range(grid)])
    dtype = np.asarray(facs).dtype if len(facs) else object
    lanes, rest = [], hi.copy()
    for lane in range(32):
        low_bit = rest & -rest
        m = np.array([int(b).bit_length() - 1 for b in low_bit])
        lanes.append(np.array([facs[pos(s + t + mm)] if lane < cnt else one
                               for mm, cnt in zip(m, count)], dtype=dtype))
        rest = rest & (rest - 1)
    step = 1
    while step < count.max(initial=0):
        lanes = [np.where(step < count, mul(lanes[lane], lanes[lane ^ step]), lanes[lane])
                 for lane in range(32)]
        step <<= 1
    g = lanes[0]
    la, lb, hp = leaves[:na], leaves[na:na + nb], leaves[na + nb:]
    lt = np.array([mul(la[b & (na - 1)], lb[b >> sa]) for b in range(1 << s)], dtype=dtype)
    ht = np.stack([mul(g, hp[a]) for a in range(nh)], axis=1)  # (grid, nh)
    vals = mul(ht[:, :, None], lt[None, None, :]).reshape(-1)
    tile = 1 << (s + t)
    for e0 in range(0, min(tile, threads), 32):  # a warp's e, every pass of its loop
        for e in range(e0, tile, threads):
            warp = np.arange(e, min(e + 32, tile))
            assert (np.diff(warp) == 1).all()
            if s >= 5:
                assert len(set((warp >> s).tolist())) == 1
                assert len(set((warp & ((1 << s) - 1)).tolist())) == len(warp)
    x = np.arange(len(vals))
    writes = [(x, vals)]
    if stage:
        writes = [((n >> 1) + x, vals), (np.array([0]), vals[:1])]
        tiles, x0 = vals.reshape(grid, tile), np.arange(grid) * tile
        for z in range(1, s + t + 1):  # each level of strides from the staged even values
            u = np.arange(tile >> z)
            h = u << (z - 1)  # staged slot h + (h >> 5) holds e = 2 h
            if z <= 6:
                for u0 in range(0, len(u), 32):
                    banks = ((h + (h >> 5))[u0:u0 + 32] % 32).tolist()
                    assert len(set(banks)) == len(banks)
            writes.append((((n >> (z + 1)) + (x0[:, None] >> z) + u[None, :]).ravel(),
                           tiles[:, 2 * h].ravel()))
        for z in range(s + t + 1, log_n):  # thread 0: x0's value where 2^z | x0
            sel = x0 % (1 << z) == 0
            writes.append(((n >> (z + 1)) + (x0[sel] >> z), tiles[sel, 0]))
    out = np.empty(n, dtype=vals.dtype)
    written = np.zeros(n, dtype=np.int64)
    for idx, v in writes:
        out[idx] = v
        np.add.at(written, idx, 1)
    return out, written


def _disjoint_or(a, b):
    """The product of factor sets as bit masks, each factor at most once."""
    assert not np.any(np.asarray(a) & np.asarray(b))
    return a | b


def _depth(a, b):
    return np.maximum(a, b) + 1


def _power_walk_checks(log_n, mode, s, t):
    """Every element written once; the factors of each, every one at most
    once, are those of fr.exponents; c in each once.  Returns the longest
    chain of dependent products."""
    n = 1 << log_n
    facs = np.array([1 << p for p in range(log_n)], dtype=np.int64)
    got, written = powers_walk(log_n, mode, s, t, facs, 0, 0, _disjoint_or)
    assert (written == 1).all()
    assert np.array_equal(got, fr.exponents(n, log_n, mode).numpy())
    cs, _ = powers_walk(log_n, mode, s, t, np.zeros(log_n, dtype=np.int64), 0, 1, np.add)
    assert (cs == 1).all()
    depth, _ = powers_walk(log_n, mode, s, t, np.zeros(log_n, dtype=np.int64), 0, 0, _depth)
    return int(depth.max())


@pytest.mark.parametrize("mode", [fr.MODE_BITREV, fr.MODE_STAGE])
@pytest.mark.parametrize("log_n", range(1, 23))
def test_power_tile_walk(log_n, mode):
    """fr_powers_kernel walked as it runs at the tile its launcher picks
    (`fr.powers_tile`): at every k from 1 to 22 each element is written
    once, from one product of two table entries whose factors are those of
    its exponent; no chain of dependent products is longer than 5 up to
    2^18 (the witness maps' domains) and 6 up to 2^22."""
    s, t = fr.powers_tile(log_n, mode)
    bits = log_n - (mode == fr.MODE_STAGE)
    assert s == min(bits, fr.POW_LOW_LOG) and 0 <= t <= fr.POW_HIGH_LOG
    assert bits - s - t >= min(fr.POW_MIN_CTA_LOG, bits - s)  # tiles enough to fill a wave
    assert _power_walk_checks(log_n, mode, s, t) <= (5 if log_n <= 18 else 6)


@pytest.mark.parametrize("mode", [fr.MODE_BITREV, fr.MODE_STAGE])
@pytest.mark.parametrize("log_n", [9, 12])
def test_power_tile_walk_every_form(log_n, mode):
    """The same at every (s, t) with s <= 6 and t <= 5 that fits the
    source bits: the forms ops/tune_fr.py builds are all correct."""
    bits = log_n - (mode == fr.MODE_STAGE)
    for s in range(min(bits, 6) + 1):
        for t in range(min(bits - s, 5) + 1):
            _power_walk_checks(log_n, mode, s, t)


def _mont_int(v):
    return v * (1 << 256) % R


def _ival(m):
    return m * RINV_MONT % R


def _stage_table(w, log_n):
    return [_mont_int(pow(w, exponent(i, log_n, fr.MODE_STAGE), R)) for i in range(1 << log_n)]


def _randoms(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]


@pytest.mark.parametrize("base", ["random", "root of unity"])
@pytest.mark.parametrize("mode", [fr.MODE_BITREV, fr.MODE_STAGE])
@pytest.mark.parametrize("log_n", range(1, 9))
def test_power_tile_values(log_n, mode, base):
    """The walk's values in Montgomery integers (each product imont), c !=
    1 and a base that is not a root of unity (or w of order 2^k), equal
    the plain fr.powers."""
    b = VALUES[30] if base == "random" else root_of_unity(log_n)
    c = VALUES[31]
    if base == "random":
        assert pow(b, 1 << 32, R) != 1
    s, t = fr.powers_tile(log_n, mode)
    facs = np.array([_mont_int(pow(b, 1 << p, R)) for p in range(log_n)], dtype=object)
    got, written = powers_walk(log_n, mode, s, t, facs, _mont_int(1), _mont_int(c),
                               np.frompyfunc(imont, 2, 1))
    assert (written == 1).all()
    want = fr.values_of(fr.powers(fr.squares_of(b, "cpu"), _planes([c]), log_n, mode))
    assert [_ival(v) for v in got] == want
    assert want == [c * pow(b, exponent(i, log_n, mode), R) % R for i in range(1 << log_n)]


@pytest.mark.parametrize("log_n", [3, 11])
def test_transcribed_transform_is_the_dft(log_n):
    """The kernels' schedule (the tile's register phases and exchanges,
    then or after the wide stages at 2^11) over the stage twiddles: DIF
    over w^-1 with the scale n^-1, then DIT over w, gives x back; DIT of
    the bit-reversed x is the port's snark/fr.py fft of x; and the plain
    `ntt` computes the same values."""
    n = 1 << log_n
    w = root_of_unity(log_n)
    xs = _randoms(n, log_n)
    tw, tw_inv = _stage_table(w, log_n), _stage_table(pow(w, -1, R), log_n)
    x = [_mont_int(v) for v in xs]
    coeffs = kernel_ntt(list(x), tw_inv, True, [_mont_int(pow(n, -1, R))] * n)
    assert [_ival(v) for v in kernel_ntt(coeffs, tw, False)] == xs
    evals = kernel_ntt([x[exit_row(i, log_n)] for i in range(n)], tw, False)
    assert [_ival(v) for v in evals] == fft(xs, w)

    planes = fr.planes_of(xs, "cpu")
    tw_p = fr.planes_of([pow(w, exponent(i, log_n, fr.MODE_STAGE), R) for i in range(n)], "cpu")
    got = fr.ntt(planes[:, torch.from_numpy(np.array(
        [exit_row(i, log_n) for i in range(n)]))].contiguous(), tw_p, False)
    assert fr.values_of(got) == fft(xs, w)


@pytest.mark.parametrize("nvec", [1, 3])
@pytest.mark.parametrize("log_n", [3, 11])
def test_transcribed_round_trip_tile(log_n, nvec):
    """fr.coset_ntt's schedule, the round-trip tile over nvec vectors
    between the wide stages: each vector of evaluations on the domain
    comes out as the evaluations on the coset 5 w^i (DIF over w^-1, the
    scale n^-1 5^bitrev(i), DIT over w), against the port's snark/fr.py
    fft; the plain coset_ntt and the DIF form with the inverse scale (h's
    last tile) agree; a tile of 2^10 exchanges 8 times in the round trip,
    5 in a DIF or DIT form alone (2 stages a phase)."""
    n, g = 1 << log_n, 5
    w, winv, ninv = root_of_unity(log_n), pow(root_of_unity(log_n), -1, R), pow(n, -1, R)
    tw, tw_inv = _stage_table(w, log_n), _stage_table(winv, log_n)
    scale = [ninv * pow(g, exit_row(i, log_n), R) % R for i in range(n)]
    vecs = [_randoms(n, 100 + log_n + v) for v in range(nvec)]
    wants = []
    for vec in vecs:
        coeffs = [c * ninv % R for c in fft(vec, winv)]
        wants.append(fft([c * pow(g, i, R) % R for i, c in enumerate(coeffs)], w))
    stats = {}
    xs = [[_mont_int(v) for v in vec] for vec in vecs]
    tile_kernel(xs, tw_inv, True, [_mont_int(v) for v in scale], tw, stats)
    stats_dif, stats_dit = {}, {}
    tile_kernel([list(xs[0])], tw_inv, True, None, None, stats_dif)
    tile_kernel([list(xs[0])], tw, False, None, None, stats_dit)
    if log_n == TILE_LOG + 1:
        phases = -(-TILE_LOG // PER_LOG)
        assert (stats["round trip"], stats_dif["dif"], stats_dit["dit"]) == (
            2 * phases - 2, phases, phases)
    xs = [[_mont_int(v) for v in vec] for vec in vecs]
    got = kernel_coset_ntt(xs, tw_inv, tw, [_mont_int(v) for v in scale])
    assert [[_ival(v) for v in x] for x in got] == wants

    def planes(values):
        return fr.planes_of(values, "cpu")

    batch = torch.stack([planes(vec) for vec in vecs])
    tw_values = [pow(w, exponent(i, log_n, fr.MODE_STAGE), R) for i in range(n)]
    twinv_values = [pow(winv, exponent(i, log_n, fr.MODE_STAGE), R) for i in range(n)]
    out = fr.coset_ntt(batch, planes(twinv_values), planes(tw_values), planes(scale))
    assert out is batch and [fr.values_of(x) for x in batch] == wants
    # h's last inverse transform: DIF over w^-1 with n^-1 5^-bitrev(i)
    scale_inv = [ninv * pow(g, -exit_row(i, log_n), R) % R for i in range(n)]
    h = [_mont_int(v) for v in vecs[0]]
    kernel_ntt(h, tw_inv, True, [_mont_int(v) for v in scale_inv])
    got_plain = fr.ntt(planes(vecs[0]), planes(twinv_values), True, planes(scale_inv))
    coeffs = [c * ninv % R for c in fft(vecs[0], winv)]
    assert [_ival(v) for v in h] == fr.values_of(got_plain) == [
        coeffs[exit_row(i, log_n)] * pow(g, -exit_row(i, log_n), R) % R for i in range(n)]


@pytest.mark.parametrize("log_t", range(1, TILE_LOG + 1))
def test_tile_phases_and_banks(log_t):
    """The tile's phases run every stage once, in order, each on a bit set
    that holds it; the swizzle is a permutation of the tile; on every set a
    phase uses, each warp's 32 exchange words of a slot lie in 32 banks;
    and each warp's twiddle reads of a pair hit distinct banks but for
    threads that read one word (a broadcast)."""
    t = 1 << log_t
    threads, slots, top = max(1, t // PER), min(PER, t), max(0, log_t - PER_LOG)
    dif, dit = list(dif_phases(log_t)), list(dit_phases(log_t))
    assert [lh for _, lo, hi in dif for lh in range(hi, lo - 1, -1)] == list(range(log_t))[::-1]
    assert [lh for _, lo, hi in dit for lh in range(lo, hi + 1)] == list(range(log_t))
    assert dif[0][0] == dit[-1][0] == top and dif[-1][0] == dit[0][0] == 0
    for s, lo, hi in dif + dit:
        assert s <= lo <= hi < s + PER_LOG and 0 <= s <= top
    assert sorted(swz(e) for e in range(t)) == list(range(t))
    assert sorted(elem(q, s, m) for q in range(threads) for m in range(slots)) == list(range(t))
    for s in {s for s, _, _ in dif + dit}:
        for w0 in range(0, threads, 32):
            lanes = range(w0, min(threads, w0 + 32))
            for m in range(slots):
                banks = [swz(elem(q, s, m)) % 32 for q in lanes]
                assert len(set(banks)) == len(banks), (log_t, s, m)
        for lo, hi in [(lo, hi) for s2, lo, hi in dif + dit if s2 == s]:
            for lh in range(lo, hi + 1):
                b = lh - s
                for pair in range(PER // 2):
                    m = ((pair >> b) << (b + 1)) | (pair & ((1 << b) - 1))
                    for w0 in range(0, threads, 32):
                        idx = {(1 << lh) + ((q & ((1 << s) - 1)) | ((m & ((1 << b) - 1)) << s))
                               for q in range(w0, min(threads, w0 + 32))}
                        assert len({i % 32 for i in idx}) == len(idx)


def spmv_kernel(row_ptr, cols, vals, z, n_out, ncopy, order, n_long):
    """fr_spmv_kernel on integer Montgomery values: a thread each row of
    order[n_long ..], in k order; a CTA each long row order[b], b <
    n_long (thread t the products k = begin + t + i SPMV_THREADS, a warp
    shuffle tree by xor 16 .. 1, warp 0 the warps' sums by xor 4 .. 1).
    Every row of out is written once."""
    nrows = len(row_ptr) - 1
    out = [None] * n_out

    def write(row, v):
        assert out[row] is None
        out[row] = v

    for b in range(n_long):
        row = order[b]
        begin, end = row_ptr[row], row_ptr[row + 1]
        acc = [0] * SPMV_THREADS
        for tid in range(SPMV_THREADS):
            for k in range(begin + tid, end, SPMV_THREADS):
                acc[tid] = (acc[tid] + imont(vals[k], z[cols[k]])) % R
        for off in (16, 8, 4, 2, 1):
            acc = [(acc[i] + acc[i ^ off]) % R for i in range(SPMV_THREADS)]
        acc = acc[::32] + [0] * (32 - SPMV_THREADS // 32)
        for off in (4, 2, 1):
            acc = [(acc[i] + acc[i ^ off]) % R for i in range(32)]
        write(row, acc[0])
    for row in order[n_long:]:
        acc = 0
        if row < nrows:
            for k in range(row_ptr[row], row_ptr[row + 1]):
                acc = (acc + imont(vals[k], z[cols[k]])) % R
        elif row - nrows < ncopy:
            acc = z[row - nrows]
        write(row, acc)
    assert None not in out
    return out


def test_transcribed_spmv_bins_and_order():
    """A matrix with the Falcon-1024 shape of A's rows (four of 1,027
    entries, two of 1,026, one of 2,075, each a run of consecutive wires;
    short rows of 1, 2, 4 and 15 random wires; empty rows) and 64 copied
    instance rows, as a shuffled COO: gpu_qap._csr's bins take the 7 long
    rows (from 1,026 entries) in row order and every other row of out once,
    from the longest, in row order within a length; the kernel's sums in
    its order equal the plain spmv word for word and the Python-int
    sums."""
    from falcon_r1cs_tpu_torch.snark import gpu_qap

    rng = np.random.default_rng(2075)
    nrows, nz, n_out, ncopy = 700, 3000, 1024, 64
    lengths = rng.choice([0, 1, 2, 4, 15], nrows, p=[0.1, 0.3, 0.4, 0.1, 0.1])
    long_at = rng.choice(nrows, 7, replace=False)
    lengths[long_at] = [1027, 1027, 1027, 1027, 1026, 1026, 2075]
    rows, cols = [], []
    for r, length in enumerate(lengths):
        rows += [r] * int(length)
        if length > 15:
            start = int(rng.integers(0, nz - length))
            cols += range(start, start + int(length))
        else:
            cols += rng.integers(0, nz, int(length)).tolist()
    perm = rng.permutation(len(rows))
    rows, cols = np.array(rows, dtype=np.int32)[perm], np.array(cols, dtype=np.int32)[perm]
    vals = _randoms(len(rows), 1)
    val_rows = np.array([[(v >> (64 * k)) & (2**64 - 1) for k in range(4)] for v in vals],
                        dtype=np.uint64)
    (row_ptr, cols_t, vals_t), (order, n_long) = gpu_qap._csr(rows, cols, val_rows, nrows,
                                                              n_out, "cpu")
    rp, order_l = row_ptr.tolist(), order.tolist()
    length_of = [rp[r + 1] - rp[r] if r < nrows else 0 for r in range(n_out)]
    assert fr.long_row_min(np.array(length_of)) == 1026
    assert sorted(order_l) == list(range(n_out)) and n_long == 7
    assert order_l[:n_long] == sorted(long_at.tolist())
    short = [length_of[r] for r in order_l[n_long:]]
    assert short == sorted(short, reverse=True) and short[0] == 15
    for length in set(short):  # row order within a length
        same = [r for r in order_l[n_long:] if length_of[r] == length]
        assert same == sorted(same)
    z = _randoms(nz, 2)
    zm = [_mont_int(v) for v in z]
    colsl = cols_t.tolist()
    valsm = [_int(w) for w in vals_t.numpy().view(np.uint32).T.tolist()]
    got = spmv_kernel(rp, colsl, valsm, zm, n_out, ncopy, order_l, n_long)
    plain = fr.spmv_cuda(row_ptr, cols_t, vals_t, fr.planes_of(z, "cpu"), n_out, ncopy,
                         bins=(order, n_long))
    assert [_int(w) for w in plain.numpy().view(np.uint32).T.tolist()] == got
    by_row = np.argsort(rows, kind="stable")
    want = [0] * n_out
    for r, c, v in zip(rows[by_row], cols[by_row], np.array(vals, dtype=object)[by_row]):
        want[r] = (want[r] + v * z[c]) % R
    want[nrows:nrows + ncopy] = z[:ncopy]
    assert [_ival(v) for v in got] == want


# --- the plain versions against Python ints -----------------------------------


def _planes(values):
    return fr.planes_of(values, "cpu")


def test_plain_product_add_sub():
    a, b = VALUES, VALUES[::-1]
    pa, pb = _planes(a), _planes(b)
    assert fr.values_of(fr.mul_plain(pa, pb)) == [x * y % R for x, y in zip(a, b)]
    assert fr.values_of(fr.add_plain(pa, pb)) == [(x + y) % R for x, y in zip(a, b)]
    assert fr.values_of(fr.sub_plain(pa, pb)) == [(x - y) % R for x, y in zip(a, b)]
    # the words of the Montgomery product are the transcription's
    got = fr.mul_plain(pa, pb).numpy().view(np.uint32).T.tolist()
    assert got == [mont(_mont_words(x), _mont_words(y)) for x, y in zip(a, b)]


def _rows(values):
    return torch.from_numpy(np.array([[(v >> (64 * k)) & (2**64 - 1) for k in range(4)]
                                      for v in values], dtype=np.uint64).view(np.int64))


def test_plain_entry_and_exit():
    """to_mont reduces any value below 2^256 and enters the Montgomery
    domain; from_mont writes canonical rows, at bit-reversed rows too."""
    values = VALUES[:16] + [R, 2 * R + 5, (1 << 256) - 1]
    x = fr.to_mont(_rows(values))
    assert fr.values_of(x) == [v % R for v in values]
    assert x.numpy().view(np.uint32).T.tolist() == [entry(v) for v in values]
    rows = fr.from_mont(x[:, :16].contiguous()).numpy().view(np.uint64)
    for i in range(16):
        assert int.from_bytes(rows[exit_row(i, 4)].tobytes(), "little") == values[i] % R


def test_plain_powers_and_quotient():
    log_n, base, c = 5, VALUES[20], VALUES[21]
    sq = fr.squares_of(base, "cpu")
    for mode in (fr.MODE_BITREV, fr.MODE_STAGE):
        got = fr.values_of(fr.powers(sq, _planes([c]), log_n, mode))
        assert got == [c * pow(base, exponent(i, log_n, mode), R) % R for i in range(32)]
    a, b, cc = VALUES[:20], VALUES[20:40], VALUES[5:25]
    z = VALUES[44]
    pa = _planes(a)
    q = fr.quotient(pa, _planes(b), _planes(cc), _planes([z]))
    assert q is pa  # in place
    assert fr.values_of(q) == [(x * y - w) * z % R for x, y, w in zip(a, b, cc)]


def test_plain_spmv():
    """Row sums of products, an empty row, a long row (the reduction of a
    sum of many canonical values), and copied instance rows."""
    rng = np.random.default_rng(7)
    lengths = [3, 0, 1, 300, 2]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    nz = 50
    cols = rng.integers(0, nz, row_ptr[-1]).astype(np.int32)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in cols]
    vals[:300] = [R - 1] * 300
    z = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(nz)]
    out = fr.spmv(torch.from_numpy(row_ptr), torch.from_numpy(cols), _planes(vals),
                  _planes(z), 12, 4)
    want = [sum(vals[k] * z[cols[k]] for k in range(row_ptr[r], row_ptr[r + 1])) % R
            for r in range(5)] + z[:4] + [0] * 3
    assert fr.values_of(out) == want
