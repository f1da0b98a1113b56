"""Fr, the scalar field of BLS12-381 (r of 255 bits), on word planes: the
plain torch versions and the wrappers of the seven hand-written CUDA
kernels of `csrc/fr_mont.cu`, the Groth16 witness map's arithmetic
(`snark/gpu_qap.py` chains them).

They replace no Pallas kernel: the JAX package computes the witness map
on the host (`falcon_r1cs_tpu/snark/native_backend.py` `witness_map`, the
C of `native/groth16_native.c`), as the port's `native` backend still
does.  They were added to move that stage, 45 % of a Falcon-512 proof in
host C, onto the card beside the G1 MSMs.  What bounds each kernel is in
the source's note; the smoke's records (chip_smoke.py
`fr_kernels_vs_plain`) give each one's bound from its inputs.

A field vector is word planes, (8, n) int32 holding the uint32 words of
canonical Montgomery forms x 2^256 mod r (word k of element i at [k,
i]), from `to_mont_cuda` (host rows (n, 4) int64, the u64 limbs of any
value below 2^256, reduced mod r) until `from_mont_cuda` (canonical
standard rows (n, 4) int64).  Each wrapper:

- `to_mont_cuda(rows)` -> planes (`fr_to_mont_kernel`: ENTRY_PER rows a
  thread; in a warp whose 32 rows stay below word 7, a round's a b_i
  skipped where they all have word i 0);
- `from_mont_cuda(x)` -> rows, n = 2^k elements, row bitrev(i) (of k
  bits) taking element i (`fr_from_mont_kernel`: the Montgomery reduction
  alone, a CTA a tile of 2^(2 s) elements, s = min(EXIT_SIDE_LOG, k // 2),
  its rows staged in shared memory);
- `spmv_cuda(row_ptr, cols, vals, z, n_out, ncopy=0, bins=, out=None)`
  -> (8, n_out), into `out` where given (a slice of the caller's buffer):
  out[row] = sum vals z[cols] over a CSR matrix of nrows = len(row_ptr) -
  1 rows, rows nrows .. nrows + ncopy - 1 z[0 .. ncopy - 1], the rest 0;
  `bins` = (order, n_long) from `spmv_order`, once a matrix, which the
  kernel needs: the long rows one CTA each, the others one thread each,
  by length from the longest (`fr_spmv_kernel`);
- `ntt_tile_cuda(x, tw, dif, scale=None, tw_dit=None)`, in place on (8,
  n) planes or a batch (V, 8, n): the stages of span up to 2^TILE_LOG
  (DIT: the first; DIF: the last, then x *= scale; with `tw_dit`, a DIF
  tile, the scale and the DIT tile over tw_dit in one pass: the round
  trip of `coset_ntt`) (`fr_ntt_tile_kernel`);
- `ntt_stage_cuda(x, tw, lh, dif)`, in place: the stage of span 2^(lh + 1)
  (`fr_ntt_stage_kernel`);
- `quotient_cuda(a, b, c, zinv)`, in place: a = (a b - c) zinv
  (`fr_quotient_kernel`);
- `powers_cuda(squares, c, log_n, mode)` -> c base^e(i), e(i) = bitrev(i)
  or the stage twiddle exponent (`fr_powers_kernel`: a CTA a tile of
  2^(s + t) values, each H(a) L(b), one product, from two tables the CTA
  builds; stage mode computes the top segment's n / 2 values and writes
  the lower segments as its strides; `powers_tile` gives (s, t)).

`ntt(x, tw, dif, scale=None)` is the whole radix-2 transform through the
two NTT wrappers: DIF, natural order in, bit-reversed out, with the
twiddles of w^-1 an inverse transform; DIT, bit-reversed in, natural out.
`tw` is a stage table (`powers_cuda(..., MODE_STAGE)`): tw[h + j] = w^(j
n / 2h).  `coset_ntt(x, tw_inv, tw, scale)` takes each vector of a batch
(V, 8, n) through the inverse transform, the scale and the forward one,
the tile stages of all three steps and all V vectors in one launch.

Each wrapper takes its plain version for CPU tensors, launches its kernel
through `_build.launch` for CUDA tensors and raises for anything else;
there is no fallback from a CUDA tensor to the plain path.  `.launches`
counts kernel launches.  The plain versions compute on 16 limbs of 16
bits in int64 (`_mont16`: CIOS with R' = 2^256, lazy carries, one
normalisation and one subtraction of r at the end) and give the same
canonical words as the kernels: equal by value and so bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
WORDS = 8
TILE_LOG = 10       # a tile of fr_ntt_tile_kernel: 2^10 elements, 32 KB
TILE_PER = 4        # elements a thread of the tile kernel holds
SPMV_THREADS = 256  # threads a CTA of fr_spmv_kernel
ENTRY_THREADS = 128  # threads a CTA of fr_to_mont_kernel
ENTRY_PER = 1       # rows a thread of it converts
EXIT_SIDE_LOG = 4   # fr_from_mont_kernel's s: a CTA a tile of 2^(2 s) elements
EXIT_PER = 1        # elements a thread of it reduces
MAX_LOG = 32        # columns of the squares table of powers_cuda
POW_THREADS = 256   # threads a CTA of fr_powers_kernel
POW_LOW_LOG = 6     # its s at most: a tile's low bits, the table L
POW_HIGH_LOG = 5    # its t at most: a tile's runs, the table H
POW_MIN_CTA_LOG = 8  # t shrinks until the grid has 2^8 tiles
MODE_BITREV, MODE_STAGE = 0, 1
R_MONT = (1 << 256) % R

_LIMBS = 16
_M16 = 0xFFFF


# -- host words ---------------------------------------------------------------


def words(v: int) -> list[int]:
    """The 8 32-bit words of v < 2^256, least first."""
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(WORDS)]


def planes_of(values, device) -> torch.Tensor:
    """(8, m) int32 planes of the Montgomery forms of `values` (ints)."""
    w = np.array([words(int(v) % R * R_MONT % R) for v in values], dtype=np.uint32)
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)).to(device)


def values_of(x: torch.Tensor) -> list[int]:
    """The field values of (8, m) planes of Montgomery forms (host ints)."""
    w = x.cpu().numpy().view(np.uint32).astype(object)
    inv = pow(R_MONT, -1, R)
    return [sum(int(w[k, i]) << (32 * k) for k in range(WORDS)) * inv % R
            for i in range(x.shape[1])]


def squares_of(base: int, device) -> torch.Tensor:
    """(8, MAX_LOG) planes of base^(2^k), k < MAX_LOG: powers_cuda's table."""
    sq, b = [], base % R
    for _ in range(MAX_LOG):
        sq.append(b)
        b = b * b % R
    return planes_of(sq, device)


def bitrev(log_n: int) -> torch.Tensor:
    """(2^log_n,) int64: i with its log_n bits reversed."""
    i = torch.arange(1 << log_n, dtype=torch.int64)
    out = torch.zeros_like(i)
    for k in range(log_n):
        out |= ((i >> k) & 1) << (log_n - 1 - k)
    return out


# -- plain arithmetic on 16 limbs of 16 bits ------------------------------------


def _const16(v: int, limbs: int = _LIMBS) -> torch.Tensor:
    return torch.tensor([(v >> (16 * k)) & _M16 for k in range(limbs)], dtype=torch.int64)


_R16 = _const16(R)


def _to16(x: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 word planes -> (16, ...) int64 limbs."""
    w = x.long() & 0xFFFFFFFF
    return torch.stack([w & _M16, w >> 16], dim=1).reshape(_LIMBS, *x.shape[1:])


def _from16(t: torch.Tensor) -> torch.Tensor:
    """(16, ...) normalised limbs -> (8, ...) int32 word planes."""
    w = t[0::2] | (t[1::2] << 16)
    return (((w + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).int()


def _normalise(t: torch.Tensor) -> torch.Tensor:
    """Carry every limb into the next: limbs 0 .. L-2 in [0, 2^16)."""
    t = t.clone()
    for k in range(t.shape[0] - 1):
        t[k + 1] += t[k] >> 16
        t[k] &= _M16
    return t


def _cond_sub(t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """t - m where t >= m, else t; t normalised, m (L,) limbs."""
    shape = (-1,) + (1,) * (t.dim() - 1)
    d = t - m.to(t.device).reshape(shape)
    for k in range(t.shape[0] - 1):
        borrow = (d[k] < 0).long()
        d[k] += borrow << 16
        d[k + 1] -= borrow
    return torch.where(d[-1] < 0, t, d)


def _reduce(t: torch.Tensor, bits: int) -> torch.Tensor:
    """t mod r for normalised limbs t < 2^bits r (17 limbs: t < 2^272)."""
    for s in range(bits - 1, -1, -1):
        t = _cond_sub(t, _const16(R << s, t.shape[0]))
    return t


def _mont16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b 2^-256 mod r, canonical, on (16, ...) limbs of canonical values.
    CIOS over 16 limbs with r' = -r^-1 mod 2^16 = 0xffff; limbs stay
    unnormalised (each step adds below 2^33 a limb) until the end."""
    a, b = torch.broadcast_tensors(a, b)
    shape = (-1,) + (1,) * (a.dim() - 1)
    r16 = _R16.to(a.device).reshape(shape)
    t = torch.zeros_like(a)
    for i in range(_LIMBS):
        t = t + a * b[i]
        m = ((t[0] & _M16) * _M16) & _M16
        t = t + m * r16
        carry = t[0] >> 16  # t[0] is 0 mod 2^16 now
        t = torch.cat([t[1:], torch.zeros_like(t[:1])])
        t[0] += carry
    return _cond_sub(_normalise(t), _R16)


def _add16(a, b):
    return _cond_sub(_normalise(a + b), _R16)


def _sub16(a, b):
    r16 = _R16.to(a.device).reshape((-1,) + (1,) * (a.dim() - 1))
    return _cond_sub(_normalise(a - b + r16), _R16)


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Montgomery product of word planes (broadcasting), canonical."""
    return _from16(_mont16(_to16(a), _to16(b)))


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _from16(_add16(_to16(a), _to16(b)))


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _from16(_sub16(_to16(a), _to16(b)))


# -- the kernels' plain versions -------------------------------------------------


def to_mont(rows: torch.Tensor) -> torch.Tensor:
    """(n, 4) int64 u64 rows of values below 2^256 -> (8, n) Montgomery planes."""
    t = torch.stack([(rows[:, k // 4] >> (16 * (k % 4))) & _M16 for k in range(_LIMBS)])
    t = _cond_sub(_cond_sub(t, _R16), _R16)  # below 2^256 < 3r
    return _from16(_mont16(t, _const16(pow(2, 512, R))[:, None].to(rows.device)))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    """(8, 2^k) Montgomery planes -> (2^k, 4) int64 canonical standard
    rows, row bitrev(i) taking element i."""
    t = _mont16(_to16(x), _const16(1)[:, None].to(x.device))
    top = t[3::4] - ((t[3::4] >> 15) << 16)  # the top 16 bits, signed
    rows = (t[0::4] | (t[1::4] << 16) | (t[2::4] << 32) | (top << 48)).T.contiguous()
    out = torch.empty_like(rows)
    out[bitrev(x.shape[1].bit_length() - 1).to(rows.device)] = rows
    return out


def spmv(row_ptr, cols, vals, z, n_out: int, ncopy: int = 0, bins=None,
         out=None) -> torch.Tensor:
    """out[row] = sum_k vals[k] z[cols[k]] (Montgomery), over the CSR rows
    of row_ptr; rows nrows .. nrows + ncopy - 1 take z[0 .. ncopy - 1].
    The kernel's `bins` change only the order of each row's sum, which
    mod r is exact: they are not read."""
    nrows = row_ptr.shape[0] - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    row = torch.repeat_interleave(torch.arange(nrows, device=z.device), counts)
    prod = _mont16(_to16(vals), _to16(z[:, cols.long()]))
    acc = torch.zeros((_LIMBS + 1, n_out), dtype=torch.int64, device=z.device)
    acc[:_LIMBS].index_add_(1, row, prod)
    longest = int(counts.max()) if nrows else 0
    got = _from16(_reduce(_normalise(acc), max(1, longest.bit_length()))[:_LIMBS])
    got[:, nrows:nrows + ncopy] = z[:, :ncopy]
    return got if out is None else out.copy_(got)


# a row at least a warp long may take a CTA of its own (spmv_order)
LONG_ROW_MIN = 32


def long_row_min(lengths: np.ndarray) -> int:
    """The length from which a row is long: the upper end of the widest
    gap, by ratio, between two neighbouring distinct row lengths (the
    first counted from 0) that ends at LONG_ROW_MIN or above; past the
    longest row (no row long) where none does.  A's rows at 2^18 hold 1,
    2, 4, 15 or 1,026 to 2,075 entries: 1,026."""
    ls = np.unique(lengths[lengths > 0])
    best, cut = 0.0, int(ls[-1]) + 1 if len(ls) else 1
    for lo, hi in zip(np.concatenate([[0], ls[:-1]]), ls):
        ratio = hi / lo if lo else np.inf
        if hi >= LONG_ROW_MIN and ratio > best:
            best, cut = ratio, int(hi)
    return cut


def spmv_order(row_ptr: np.ndarray, n_out: int) -> tuple[np.ndarray, int]:
    """The bins of `spmv_cuda` for a CSR matrix (row_ptr on the host) into
    n_out rows: (order (n_out,) int32, n_long).  order holds the long rows
    (`long_row_min`) in row order, then every other row of out, those past
    the matrix as empty, by length from the longest and in row order
    within a length, so the kernel's warps of one thread a row each run
    rows of one length, and the longest of them start first."""
    lengths = np.zeros(n_out, dtype=np.int64)
    lengths[:len(row_ptr) - 1] = np.diff(row_ptr)
    long = lengths >= long_row_min(lengths)
    short = np.flatnonzero(~long)
    short = short[np.argsort(-lengths[short], kind="stable")]
    return np.concatenate([np.flatnonzero(long), short]).astype(np.int32), int(long.sum())


def _stage(x: torch.Tensor, tw: torch.Tensor, lh: int, dif: bool) -> None:
    """One radix-2 stage of span 2h, h = 2^lh, in place on (8, n) planes."""
    n, h = x.shape[1], 1 << lh
    blocks = x.view(WORDS, n // (2 * h), 2, h)
    u, v = _to16(blocks[:, :, 0]), _to16(blocks[:, :, 1])
    w = _to16(tw[:, h:2 * h])[:, None, :]
    if dif:
        u, v = _add16(u, v), _mont16(_sub16(u, v), w)
    else:
        t = _mont16(v, w)
        u, v = _add16(u, t), _sub16(u, t)
    blocks[:, :, 0] = _from16(u)
    blocks[:, :, 1] = _from16(v)


def ntt_tile(x, tw, dif: bool, scale=None, tw_dit=None):
    """The stages of span up to 2^min(log2 n, TILE_LOG), in place, of (8,
    n) planes or of each vector of (V, 8, n); with tw_dit, after the DIF
    stages and the scale, the DIT stages over tw_dit."""
    if x.dim() == 3:
        for v in x:
            ntt_tile(v, tw, dif, scale, tw_dit)
        return x
    log_t = min(x.shape[1].bit_length() - 1, TILE_LOG)
    for lh in (reversed(range(log_t)) if dif else range(log_t)):
        _stage(x, tw, lh, dif)
    if scale is not None:
        x.copy_(mul_plain(x, scale))
    if tw_dit is not None:
        for lh in range(log_t):
            _stage(x, tw_dit, lh, False)
    return x


def ntt_stage(x, tw, lh: int, dif: bool):
    _stage(x, tw, lh, dif)
    return x


def quotient(a, b, c, zinv):
    """a = (a b - c) zinv in place; zinv (8, 1)."""
    a.copy_(_from16(_mont16(_sub16(_mont16(_to16(a), _to16(b)), _to16(c)), _to16(zinv))))
    return a


def exponents(n: int, log_n: int, mode: int) -> torch.Tensor:
    """(n,) int64: e(i) of powers_cuda's mode."""
    if mode == MODE_BITREV:
        return bitrev(log_n)
    i = torch.arange(n, dtype=torch.int64)
    lh = torch.zeros_like(i)
    for k in range(1, log_n):
        lh += (i >> k > 0).long()
    e = (i - (1 << lh)) << (log_n - 1 - lh)
    return torch.where(i > 0, e, 0)


def powers_tile(log_n: int, mode: int) -> tuple[int, int]:
    """(s, t) of fr_powers_kernel's tiles (its launcher's pow_tile): a tile
    2^s values wide (the table L) and 2^t runs long (the table H), over the
    2^bits values the kernel computes (bits = log_n, or log_n - 1 in stage
    mode), with at least 2^POW_MIN_CTA_LOG tiles where t can shrink."""
    bits = log_n - (mode == MODE_STAGE)
    s = min(bits, POW_LOW_LOG)
    return s, max(0, min(bits - s - POW_MIN_CTA_LOG, POW_HIGH_LOG))


def powers(squares, c, log_n: int, mode: int):
    """(8, 2^log_n) planes of c base^e(i), squares[:, k] = base^(2^k)."""
    n = 1 << log_n
    e = exponents(n, log_n, mode).to(c.device)
    acc = _to16(c).expand(_LIMBS, n).clone()
    for k in range(log_n):
        bit = ((e >> k) & 1).bool()
        acc = torch.where(bit, _mont16(acc, _to16(squares[:, k:k + 1])), acc)
    return _from16(acc)


# -- the wrappers ------------------------------------------------------------------


def _planes(name, x, n=None):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != WORDS or \
            (n is not None and x.shape[1] != n):
        raise ValueError(f"{name}: want ({WORDS}, {n if n is not None else 'n'}) int32 "
                         f"planes, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: planes must be contiguous")


def _device(name, *tensors):
    """'cpu' when every tensor lies on the CPU; the CUDA device when every
    one lies on the same CUDA device; raise otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return "cpu"
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}")
    return next(iter(devs))


def _log2(name, n):
    if n < 2 or n & (n - 1):
        raise ValueError(f"{name}: size {n} is not a power of two >= 2")
    return n.bit_length() - 1


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def to_mont_cuda(rows):
    name = "to_mont_cuda"
    if rows.dtype != torch.int64 or rows.dim() != 2 or rows.shape[1] != 4 or rows.shape[0] < 1:
        raise ValueError(f"{name}: want (n, 4) int64 rows, got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")
    dev = _device(name, rows)
    if dev == "cpu":
        return to_mont_cuda.plain(rows)
    if rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    n = rows.shape[0]
    out = torch.empty((WORDS, n), dtype=torch.int32, device=dev)
    _build.launch("fr_to_mont_launch", dev, rows.data_ptr(), out.data_ptr(), n)
    to_mont_cuda.launches += 1
    return out


def from_mont_cuda(x):
    name = "from_mont_cuda"
    _planes(name, x)
    n = x.shape[1]
    log_n = _log2(name, n)
    dev = _device(name, x)
    if dev == "cpu":
        return from_mont_cuda.plain(x)
    rows = torch.empty((n, 4), dtype=torch.int64, device=dev)
    _build.launch("fr_from_mont_launch", dev, x.data_ptr(), rows.data_ptr(), n, log_n)
    from_mont_cuda.launches += 1
    return rows


def spmv_cuda(row_ptr, cols, vals, z, n_out: int, ncopy: int = 0, bins=None, out=None):
    name = "spmv_cuda"
    if row_ptr.dtype != torch.int32 or cols.dtype != torch.int32 or row_ptr.dim() != 1 or \
            cols.dim() != 1:
        raise ValueError(f"{name}: want int32 row_ptr and cols")
    _planes(name, vals, cols.shape[0])
    _planes(name, z)
    nrows, nnz, nz = row_ptr.shape[0] - 1, cols.shape[0], z.shape[1]
    if nrows < 0 or n_out < nrows or not 0 <= ncopy <= nz or nrows + ncopy > n_out:
        raise ValueError(f"{name}: {nrows} rows, {ncopy} copied of {nz}, into {n_out}")
    if bins is None:
        raise ValueError(f"{name}: the kernel takes its rows from bins (spmv_order)")
    order, n_long = bins
    if order.dtype != torch.int32 or tuple(order.shape) != (n_out,) or not 0 <= n_long <= nrows:
        raise ValueError(f"{name}: want bins of an int32 order of the {n_out} rows and "
                         f"0 <= n_long <= {nrows}, got {order.dtype} {tuple(order.shape)}, "
                         f"{n_long}")
    if out is not None:
        _planes(name, out, n_out)
    if not (row_ptr.is_contiguous() and cols.is_contiguous() and order.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    dev = _device(name, row_ptr, cols, vals, order, z, out)
    if dev == "cpu":
        return spmv_cuda.plain(row_ptr, cols, vals, z, n_out, ncopy, bins, out)
    if out is None:
        out = torch.empty((WORDS, n_out), dtype=torch.int32, device=dev)
    _build.launch("fr_spmv_launch", dev, row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                  nnz, z.data_ptr(), nz, out.data_ptr(), n_out, nrows, ncopy, order.data_ptr(),
                  n_long)
    spmv_cuda.launches += 1
    return out


def ntt_tile_cuda(x, tw, dif: bool, scale=None, tw_dit=None):
    name = "ntt_tile_cuda"
    if x.dim() == 3:
        if x.dtype != torch.int32 or x.shape[0] < 1 or x.shape[1] != WORDS:
            raise ValueError(f"{name}: want a batch (V >= 1, {WORDS}, n) of int32 planes, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: planes must be contiguous")
    else:
        _planes(name, x)
    n = x.shape[-1]
    log_n = _log2(name, n)
    for t in (tw, scale, tw_dit):
        if t is not None:
            _planes(name, t, n)
    if not dif and (scale is not None or tw_dit is not None):
        raise ValueError(f"{name}: the scale and the DIT table follow a DIF tile")
    dev = _device(name, x, tw, scale, tw_dit)
    if dev == "cpu":
        return ntt_tile_cuda.plain(x, tw, dif, scale, tw_dit)
    _build.launch("fr_ntt_tile_launch", dev, x.data_ptr(), tw.data_ptr(), _ptr(scale),
                  _ptr(tw_dit), n, min(log_n, TILE_LOG), int(dif),
                  x.shape[0] if x.dim() == 3 else 1)
    ntt_tile_cuda.launches += 1
    return x


def ntt_stage_cuda(x, tw, lh: int, dif: bool):
    name = "ntt_stage_cuda"
    _planes(name, x)
    n = x.shape[1]
    _log2(name, n)
    _planes(name, tw, n)
    if lh < TILE_LOG or 2 << lh > n:
        raise ValueError(f"{name}: a stage of span 2^{lh + 1} over {n} elements")
    dev = _device(name, x, tw)
    if dev == "cpu":
        return ntt_stage_cuda.plain(x, tw, lh, dif)
    _build.launch("fr_ntt_stage_launch", dev, x.data_ptr(), tw.data_ptr(), n, lh, int(dif))
    ntt_stage_cuda.launches += 1
    return x


def ntt(x, tw, dif: bool, scale=None):
    """The radix-2 transform of (8, n) planes in place: DIF the global
    stages from the widest, then the tile (and the scale); DIT the tile,
    then the global stages to the widest."""
    log_n = _log2("ntt", x.shape[1])
    wide = range(TILE_LOG, log_n)
    if dif:
        for lh in reversed(wide):
            ntt_stage_cuda(x, tw, lh, True)
        return ntt_tile_cuda(x, tw, True, scale)
    ntt_tile_cuda(x, tw, False)
    for lh in wide:
        ntt_stage_cuda(x, tw, lh, False)
    return x


def coset_ntt(x, tw_inv, tw, scale):
    """Each vector of x (V, 8, n) in place: the inverse transform (DIF over
    tw_inv, natural -> bit-reversed), the product by scale, the forward
    transform (DIT over tw, bit-reversed -> natural).  The wide stages run
    a launch a vector and a stage; the tile stages of both transforms and
    the scale run in one launch for all V vectors."""
    log_n = _log2("coset_ntt", x.shape[-1])
    wide = range(TILE_LOG, log_n)
    for lh in reversed(wide):
        for v in x:
            ntt_stage_cuda(v, tw_inv, lh, True)
    ntt_tile_cuda(x, tw_inv, True, scale, tw)
    for lh in wide:
        for v in x:
            ntt_stage_cuda(v, tw, lh, False)
    return x


def quotient_cuda(a, b, c, zinv):
    name = "quotient_cuda"
    _planes(name, a)
    n = a.shape[1]
    for t in (b, c):
        _planes(name, t, n)
    _planes(name, zinv, 1)
    dev = _device(name, a, b, c, zinv)
    if dev == "cpu":
        return quotient_cuda.plain(a, b, c, zinv)
    _build.launch("fr_quotient_launch", dev, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  zinv.data_ptr(), n)
    quotient_cuda.launches += 1
    return a


def powers_cuda(squares, c, log_n: int, mode: int):
    name = "powers_cuda"
    _planes(name, squares, MAX_LOG)
    _planes(name, c, 1)
    if not 1 <= log_n <= 30 or mode not in (MODE_BITREV, MODE_STAGE):
        raise ValueError(f"{name}: log_n {log_n}, mode {mode}")
    dev = _device(name, squares, c)
    if dev == "cpu":
        return powers_cuda.plain(squares, c, log_n, mode)
    out = torch.empty((WORDS, 1 << log_n), dtype=torch.int32, device=dev)
    _build.launch("fr_powers_launch", dev, out.data_ptr(), squares.data_ptr(), c.data_ptr(),
                  1 << log_n, log_n, mode)
    powers_cuda.launches += 1
    return out


for _wrapper, _plain in ((to_mont_cuda, to_mont), (from_mont_cuda, from_mont),
                         (spmv_cuda, spmv), (ntt_tile_cuda, ntt_tile),
                         (ntt_stage_cuda, ntt_stage), (quotient_cuda, quotient),
                         (powers_cuda, powers)):
    _wrapper.launches = 0
    _wrapper.plain = _plain
del _wrapper, _plain

# kernel name -> wrapper, for the launch counts of a run
KERNELS = {
    "fr_to_mont_kernel": to_mont_cuda, "fr_from_mont_kernel": from_mont_cuda,
    "fr_spmv_kernel": spmv_cuda, "fr_ntt_tile_kernel": ntt_tile_cuda,
    "fr_ntt_stage_kernel": ntt_stage_cuda, "fr_quotient_kernel": quotient_cuda,
    "fr_powers_kernel": powers_cuda,
}
