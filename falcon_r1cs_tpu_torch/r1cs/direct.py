"""Structured direct COO synthesis: the R1CS matrices without tracing.

The trace layer (system.py + wires.py) builds the matrices by executing
gadget Python per wire (~120k constraints/s).  These circuits are n-fold
repetitions of fixed per-coefficient gadget blocks, so the COO triples can
be emitted directly as numpy index arithmetic — bit-identical to the
traced matrices (tests/test_direct_synthesis.py compares entry-for-entry
against r1cs.coo.compile_circuit output for the golden circuits) at
10-40x the synthesis rate.

Every block template below is a hand-derivation of the corresponding
gadget's emission sequence (gadgets/range_proofs.py, arithmetics.py,
misc.py, wires.py); the dense NTT linear-combination rows are computed by
a vectorized limb-tensor butterfly (the value twin of gadgets/poly.py's
constraint-free butterflies, sharing their bound constants).

Conventions: entries are emitted per matrix (A, B, C) in row-major order
with within-row entries in ENCODED-variable order (instance 2i < witness
2j+1 exactly as sorted(lc.items()) orders them in coo.from_cs); columns
here are already GLOBAL (instance block then witness block).  Values are
the signed-integer view (coefficient c -> c - p when c > p/2).
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import FalconParams, Q, get_params
from .coo import CompiledR1CS

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
M_LIMBS = 12  # 192-bit headroom for < 2^165 NTT LC coefficients


# --- template machinery ---------------------------------------------------


class _Region:
    """Accumulates (rows, cols, vals) per matrix for one block-repeated
    region.  Template entries: (row_off, col_base, col_stride, val);
    col_stride multiplies the block index, row advances by row_stride."""

    def __init__(self, row0: int, row_stride: int, n_blocks: int):
        self.row0 = row0
        self.row_stride = row_stride
        self.n = n_blocks
        self.tmpl = {"a": [], "b": [], "c": []}

    def add(self, mat: str, row_off: int, col_base: int, col_stride: int,
            val: int) -> None:
        self.tmpl[mat].append((row_off, col_base, col_stride, val))

    def emit(self, mat: str):
        t = self.tmpl[mat]
        if not t:
            return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.int64),)
        ro = np.asarray([e[0] for e in t], dtype=np.int64)
        cb = np.asarray([e[1] for e in t], dtype=np.int64)
        cstr = np.asarray([e[2] for e in t], dtype=np.int64)
        vv = np.asarray([e[3] for e in t], dtype=np.int64)
        i = np.arange(self.n, dtype=np.int64)[:, None]
        rows = (self.row0 + i * self.row_stride + ro[None, :]).ravel()
        cols = (cb[None, :] + i * cstr[None, :]).ravel()
        vals = np.broadcast_to(vv[None, :], (self.n, len(t))).ravel()
        return rows.astype(np.int32), cols.astype(np.int32), vals.copy()


def _ltq_into(reg: _Region, row_off: int, a_base: int, a_stride: int,
              w_base: int, w_stride: int) -> None:
    """enforce_less_than_q emission (29 rows): a-wire decomposed into the
    27-wire block [14 bits | u1..u11 | w12 | w13] at w_base(+w_stride*i).

    Derivation: range_proofs.enforce_less_than_q — 14 booleanity rows,
    1 decompose row, 11 kary_or NOR rows, w12 = b12*(1-u11),
    w13 = b13*w12, 1 enforce-true row.
    """
    A, B, C = "a", "b", "c"
    for m in range(14):
        reg.add(A, row_off + m, 0, 0, 1)
        reg.add(A, row_off + m, w_base + m, w_stride, -1)
        reg.add(B, row_off + m, w_base + m, w_stride, 1)
    r = row_off + 14  # decompose: a = sum 2^m b_m
    reg.add(A, r, a_base, a_stride, -1)
    for m in range(14):
        reg.add(A, r, w_base + m, w_stride, 1 << m)
    reg.add(B, r, 0, 0, 1)
    r = row_off + 15  # u1 = (1-b0)(1-b1)
    reg.add(A, r, 0, 0, 1)
    reg.add(A, r, w_base + 0, w_stride, -1)
    reg.add(B, r, 0, 0, 1)
    reg.add(B, r, w_base + 1, w_stride, -1)
    reg.add(C, r, w_base + 14, w_stride, 1)
    for k in range(2, 12):  # u_k = u_{k-1} * (1 - b_k)
        r = row_off + 14 + k
        reg.add(A, r, w_base + 14 + k - 2, w_stride, 1)
        reg.add(B, r, 0, 0, 1)
        reg.add(B, r, w_base + k, w_stride, -1)
        reg.add(C, r, w_base + 14 + k - 1, w_stride, 1)
    r = row_off + 26  # w12 = b12 * (1 - u11)
    reg.add(A, r, w_base + 12, w_stride, 1)
    reg.add(B, r, 0, 0, 1)
    reg.add(B, r, w_base + 24, w_stride, -1)
    reg.add(C, r, w_base + 25, w_stride, 1)
    r = row_off + 27  # w13 = b13 * w12
    reg.add(A, r, w_base + 13, w_stride, 1)
    reg.add(B, r, w_base + 25, w_stride, 1)
    reg.add(C, r, w_base + 26, w_stride, 1)
    r = row_off + 28  # Not(w13) == TRUE
    reg.add(A, r, 0, 0, 1)
    reg.add(A, r, w_base + 26, w_stride, -1)
    reg.add(B, r, 0, 0, 1)
    reg.add(C, r, 0, 0, 1)


# --- dense NTT linear-combination matrix ----------------------------------


def _semi(x):
    low = x & LIMB_MASK
    carry = x >> LIMB_BITS
    out = np.zeros_like(x)
    out[..., 0] = low[..., 0]
    out[..., 1:] = low[..., 1:] + carry[..., :-1]
    return out


@functools.lru_cache(maxsize=None)
def ntt_lc_matrix(n: int):
    """Disk-and-memory-cached wrapper around the butterfly below: the LC
    matrix is a parameter-set constant (like the NTT tables themselves),
    shared by every circuit variant that embeds an n-point NTT."""
    from .coo import cache_dir

    path = cache_dir() / f"ntt_lc_matrix_{n}.npz"
    if path.exists():
        with np.load(path) as z:
            M_limb, O_limb = z["m"], z["o"]
        return _limbs_to_objects(M_limb), _limbs_to_objects(O_limb)
    M_limb, O_limb = _ntt_lc_matrix_limbs(n)
    # normalize to mod-2^192 uint16 limbs (compact; sign recovered at
    # conversion) and store uncompressed — compression of the 1024 matrix
    # costs more than recomputing it
    M_u16 = _to_u16(M_limb)
    O_u16 = _to_u16(O_limb)
    try:
        cache_dir().mkdir(parents=True, exist_ok=True)
        np.savez(path, m=M_u16, o=O_u16)
    except OSError:
        pass
    return _limbs_to_objects(M_u16), _limbs_to_objects(O_u16)


def _to_u16(limbs: np.ndarray) -> np.ndarray:
    """Full carry pass, all limbs masked to [0, 2^16) (value mod 2^192)."""
    arr = limbs.astype(np.int64).copy()
    L = arr.shape[-1]
    for k in range(L - 1):
        carry = arr[..., k] >> LIMB_BITS
        arr[..., k] &= LIMB_MASK
        arr[..., k + 1] += carry
    arr[..., L - 1] &= LIMB_MASK
    return arr.astype(np.uint16)


def _ntt_lc_matrix_limbs(n: int):
    """Integer LC coefficients of the in-circuit NTT outputs.

    Returns (M, O): M (n, n) object — signed coefficient of input k in
    output j's linear combination; O (n,) object — the one-wire
    coefficient (accumulated bound constants).  The butterfly follows
    gadgets/poly.ntt_circuit exactly (value twin over 16-bit limb tensors
    in a compact strided-support representation; support of out[j] after
    stage l is the stride-n/2^(l+1) progression, so the state is
    (n, 2^(l+1), L) instead of a dense n^2 matrix per stage).
    """
    params = get_params(n)
    log_n = params.log_n
    table = np.asarray(params.ntt_table, dtype=np.int64)
    L = M_LIMBS

    S = np.ones((n, 1, L), dtype=np.int64)
    S[:, :, 1:] = 0  # coeff 1 on input j itself
    O = np.zeros((n, L), dtype=np.int64)

    for l in range(log_n):
        t = n >> l
        ht = t >> 1
        j = np.arange(n)
        is_lo = (j % t) < ht
        lo = j[is_lo]
        hi = lo + ht
        s = table[(1 << l) + lo // t]  # per-pair twiddle
        c_limbs = _int_to_limbs_np(params.const_q_powers[l + 1], L)

        u = S[lo]                      # (n/2, w, L)
        v = _semi(S[hi] * s[:, None, None])
        w_old = S.shape[1]
        S_new = np.zeros((n, 2 * w_old, L), dtype=np.int64)
        S_new[lo, 0::2] = u
        S_new[lo, 1::2] = v
        S_new[hi, 0::2] = u
        S_new[hi, 1::2] = -v
        S = _semi(S_new)

        ou = O[lo]
        ov = _semi(O[hi] * s[:, None])
        O_new = np.zeros_like(O)
        O_new[lo] = ou + ov
        O_new[hi] = ou - ov + c_limbs[None, :]
        O = _semi(O_new)

    # S[j, m] is the coefficient of input m (support stride 1, base 0)
    return S, O


def _int_to_limbs_np(v: int, L: int) -> np.ndarray:
    out = np.zeros(L, dtype=np.int64)
    for k in range(L):
        out[k] = v & LIMB_MASK
        v >>= LIMB_BITS
    assert v == 0
    return out


def _limbs_to_objects(limbs: np.ndarray) -> np.ndarray:
    """(..., L) signed semi-normalized int64 limbs -> object ints.

    The butterfly's _semi drops the top limb's carry, so the limb value is
    the true value mod 2^(16L); |true value| < 2^165 << 2^(16L-1), so the
    signed representative of that residue IS the true value.
    """
    u16 = limbs if limbs.dtype == np.uint16 else _to_u16(limbs)
    L = u16.shape[-1]
    flat = u16.reshape(-1, L)
    all_bytes = flat.astype("<u2").tobytes()
    stride = 2 * L
    full = 1 << (LIMB_BITS * L)
    half = full >> 1
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        v = int.from_bytes(all_bytes[i * stride : (i + 1) * stride], "little")
        out[i] = v - full if v >= half else v
    return out.reshape(limbs.shape[:-1])


def _norm_region(row0: int, n_blocks: int, e_base: int, e_stride: int,
                 wb: int) -> _Region:
    """One half of the l2-norm region (19 rows per coefficient): the
    is_less_than_6144 + conditionally_select + square block of
    gadgets/misc.l2_norm_var.  e = the coefficient wire; norm wires at
    wb + 18*i: [14 bits | nor | and | select | square]."""
    reg = _Region(row0, 19, n_blocks)
    ws = 18
    for m in range(14):
        reg.add("a", m, 0, 0, 1)
        reg.add("a", m, wb + m, ws, -1)
        reg.add("b", m, wb + m, ws, 1)
    reg.add("a", 14, e_base, e_stride, -1)  # decompose
    for m in range(14):
        reg.add("a", 14, wb + m, ws, 1 << m)
    reg.add("b", 14, 0, 0, 1)
    reg.add("a", 15, wb + 12, ws, 1)        # nor = b12 * b11
    reg.add("b", 15, wb + 11, ws, 1)
    reg.add("c", 15, wb + 14, ws, 1)
    reg.add("a", 16, 0, 0, 1)               # and = (1-b13)(1-nor)
    reg.add("a", 16, wb + 13, ws, -1)
    reg.add("b", 16, 0, 0, 1)
    reg.add("b", 16, wb + 14, ws, -1)
    reg.add("c", 16, wb + 15, ws, 1)
    reg.add("a", 17, wb + 15, ws, 1)        # select
    reg.add("b", 17, 0, 0, -Q)
    reg.add("b", 17, e_base, e_stride, 2)
    reg.add("c", 17, 0, 0, -Q)
    reg.add("c", 17, e_base, e_stride, 1)
    reg.add("c", 17, wb + 16, ws, 1)
    reg.add("a", 18, wb + 16, ws, 1)        # square
    reg.add("b", 18, wb + 16, ws, 1)
    reg.add("c", 18, wb + 17, ws, 1)
    return reg


def _bound_region(row0: int, n: int, sq_base: int, sq_stride: int,
                  num_sq: int, bd: int) -> _Region:
    """The norm-bound bit-tree region (52/54 rows): hand-derivation of
    range_proofs._enforce_less_than_norm_bound_{512,1024} evaluation
    order.  sq wires (the norm LC terms) at sq_base + sq_stride*k."""
    nb = 26 if n == 512 else 27
    reg = _Region(row0, 0, 1)
    for m in range(nb):
        reg.add("a", m, 0, 0, 1)
        reg.add("a", m, bd + m, 0, -1)
        reg.add("b", m, bd + m, 0, 1)
    r = nb  # decompose: norm LC = sum of all sq wires
    for k in range(num_sq):
        reg.add("a", r, sq_base + sq_stride * k, 0, -1)
    for m in range(nb):
        reg.add("a", r, bd + m, 0, 1 << m)
    reg.add("b", r, 0, 0, 1)

    def nor_row(r, a_w, b_bit, out_w, a_is_not=False):
        """or chain row: A = (a) or (1, -a);  B = 1 - b_bit; C = out."""
        if a_is_not:
            reg.add("a", r, 0, 0, 1)
            reg.add("a", r, a_w, 0, -1)
        else:
            reg.add("a", r, a_w, 0, 1)
        reg.add("b", r, 0, 0, 1)
        reg.add("b", r, b_bit, 0, -1)
        reg.add("c", r, out_w, 0, 1)

    def and_row(r, a_w, b_w, out_w):
        reg.add("a", r, a_w, 0, 1)
        reg.add("b", r, b_w, 0, 1)
        reg.add("c", r, out_w, 0, 1)

    if n == 512:
        U, V1, V2, UP = 26, 31, 32, 33
        K4, VP = 36, 37
        A6, O6, A5, O5, A4, O4, A3, O3, A2, O2, A1, O1 = range(38, 50)
        r = nb + 1
        # u1..u5 = kary_or(bits 19..24)
        nor_row(r, bd + 19, bd + 20, bd + U, a_is_not=True); r += 1
        for k in range(1, 5):
            nor_row(r, bd + U + k - 1, bd + 21 + k - 1 + 0, bd + U + k)
            r += 1
        # v1, v2 = kary_and(bits 16..18)
        and_row(r, bd + 16, bd + 17, bd + V1); r += 1
        and_row(r, bd + V1, bd + 18, bd + V2); r += 1
        # u'1..u'3 = kary_or(bits 6..9)
        nor_row(r, bd + 6, bd + 7, bd + UP, a_is_not=True); r += 1
        nor_row(r, bd + UP, bd + 8, bd + UP + 1); r += 1
        nor_row(r, bd + UP + 1, bd + 9, bd + UP + 2); r += 1
        # k4 = (1-b3)(1-b4); vp = b1*b2
        nor_row(r, bd + 3, bd + 4, bd + K4, a_is_not=True); r += 1
        and_row(r, bd + 1, bd + 2, bd + VP); r += 1
        # tree collapse
        nor_row(r, bd + K4, bd + VP, bd + A6); r += 1     # a6 = k4*(1-vp)
        nor_row(r, bd + 5, bd + A6, bd + O6); r += 1      # o6 = b5*(1-a6)
        nor_row(r, bd + UP + 2, bd + O6, bd + A5); r += 1
        nor_row(r, bd + 10, bd + A5, bd + O5); r += 1
        nor_row(r, bd + 11, bd + O5, bd + A4, a_is_not=True); r += 1
        nor_row(r, bd + 12, bd + A4, bd + O4); r += 1
        nor_row(r, bd + 13, bd + O4, bd + A3, a_is_not=True); r += 1
        nor_row(r, bd + 14, bd + A3, bd + O3); r += 1
        nor_row(r, bd + 15, bd + O3, bd + A2, a_is_not=True); r += 1
        nor_row(r, bd + V2, bd + A2, bd + O2); r += 1
        nor_row(r, bd + U + 4, bd + O2, bd + A1); r += 1
        nor_row(r, bd + 25, bd + A1, bd + O1); r += 1
        last = bd + O1
    else:
        U, V1, UP = 27, 30, 31
        W1, X1, Y1, Z1, Q1 = 36, 37, 38, 39, 40
        O6, A6, O5, A5, O4, A4, O3, A3, O2, A2, O1 = range(41, 52)
        r = nb + 1
        nor_row(r, bd + 22, bd + 23, bd + U, a_is_not=True); r += 1
        nor_row(r, bd + U, bd + 24, bd + U + 1); r += 1
        nor_row(r, bd + U + 1, bd + 25, bd + U + 2); r += 1
        and_row(r, bd + 20, bd + 21, bd + V1); r += 1
        nor_row(r, bd + 14, bd + 15, bd + UP, a_is_not=True); r += 1
        for k in range(1, 5):
            nor_row(r, bd + UP + k - 1, bd + 16 + k - 1, bd + UP + k)
            r += 1
        nor_row(r, bd + 9, bd + 10, bd + W1, a_is_not=True); r += 1
        and_row(r, bd + 7, bd + 8, bd + X1); r += 1
        nor_row(r, bd + 5, bd + 6, bd + Y1, a_is_not=True); r += 1
        and_row(r, bd + 3, bd + 4, bd + Z1); r += 1
        nor_row(r, bd + 1, bd + 2, bd + Q1, a_is_not=True); r += 1
        nor_row(r, bd + Z1, bd + Q1, bd + O6); r += 1
        nor_row(r, bd + Y1, bd + O6, bd + A6); r += 1
        nor_row(r, bd + X1, bd + A6, bd + O5); r += 1
        nor_row(r, bd + W1, bd + O5, bd + A5); r += 1
        nor_row(r, bd + 11, bd + A5, bd + O4); r += 1
        nor_row(r, bd + 12, bd + O4, bd + A4, a_is_not=True); r += 1
        nor_row(r, bd + 13, bd + A4, bd + O3); r += 1
        nor_row(r, bd + UP + 4, bd + O3, bd + A3); r += 1
        nor_row(r, bd + V1, bd + A3, bd + O2); r += 1
        nor_row(r, bd + U + 2, bd + O2, bd + A2); r += 1
        nor_row(r, bd + 26, bd + A2, bd + O1); r += 1
        last = bd + O1
    reg.add("a", r, 0, 0, 1)
    reg.add("a", r, last, 0, -1)
    reg.add("b", r, 0, 0, 1)
    reg.add("c", r, 0, 0, 1)
    return reg



# --- shared region: one in-circuit NTT (n x 30-row mod_q blocks) ----------


def _emit_ntt_region(pieces, n: int, row0: int, in_base: int, blk_col: int,
                     M_obj, O_obj) -> None:
    """Emit one NTT-conversion region: per output j a dense eq row
    (one | inputs | t | b) followed by the 29-row less-than-q proof of b.
    Wire block (global col `blk_col`, stride 29 per coefficient): [t, b,
    27 ltq].  Shared verbatim by verify-NTT (2 regions) and dual-NTT
    (4 regions) — the gadget is NTTPolyVar.ntt_circuit + .mod_q either way.
    """
    dense = {"a": [], "b": [], "c": []}
    rows_l, cols_l, vals_l = [], [], []
    one_nz = np.nonzero(O_obj != 0)[0]
    rows_l.append(np.asarray(row0 + 30 * one_nz, np.int32))
    cols_l.append(np.zeros(len(one_nz), np.int32))
    vals_l.append(O_obj[one_nz])
    mk_nz = M_obj != 0
    jj, kk = np.nonzero(mk_nz)
    rows_l.append((row0 + 30 * jj).astype(np.int32))
    cols_l.append((in_base + kk).astype(np.int32))
    vals_l.append(M_obj[jj, kk])
    j = np.arange(n)
    rows_l.append((row0 + 30 * j).astype(np.int32))
    cols_l.append((blk_col + 29 * j).astype(np.int32))      # t
    vals_l.append(np.full(n, -Q, dtype=object))
    rows_l.append((row0 + 30 * j).astype(np.int32))
    cols_l.append((blk_col + 29 * j + 1).astype(np.int32))  # b
    vals_l.append(np.full(n, -1, dtype=object))
    d_rows = np.concatenate(rows_l)
    d_cols = np.concatenate(cols_l)
    d_vals = np.concatenate([np.asarray(v, object) for v in vals_l])
    # entries within a dense row must be encoded-ordered: one < inputs
    # (witness asc) < t < b; sort stably by (row, col) — all cols here
    # rise with encoded order (one=0, then witnesses ascending)
    order = np.lexsort((d_cols, d_rows))
    dense["a"] = (d_rows[order], d_cols[order], d_vals[order])
    reg = _Region(row0, 30, n)
    reg.add("b", 0, 0, 0, 1)  # eq row: B = one
    _ltq_into(reg, 1, blk_col + 1, 29, blk_col + 2, 29)
    tr = {m: reg.emit(m) for m in ("a", "b", "c")}
    # merge dense eq rows (row_off 0) with the template rows (1..29):
    # distinct row indices — stable row sort keeps within-row order
    ar, ac, av = tr["a"]
    rows = np.concatenate([dense["a"][0], ar])
    cols = np.concatenate([dense["a"][1], ac])
    vals = np.concatenate([dense["a"][2], av.astype(object)])
    order = np.argsort(rows, kind="stable")
    pieces["a"].append((rows[order], cols[order], vals[order]))
    pieces["b"].append(tr["b"][:2] + (tr["b"][2],))
    pieces["c"].append(tr["c"][:2] + (tr["c"][2],))


# --- the verify-with-NTT circuit ------------------------------------------


def direct_compile_verify_ntt(n: int) -> CompiledR1CS:
    """CompiledR1CS for FalconNTTVerificationCircuit, emitted directly.

    Region map (rows / witness blocks; NI = 2n+1 instance cols):
      LTQ_V    rows [0, 29n)        v range proofs
      SIG_NTT  rows [29n, 59n)      mod_q of the sig NTT outputs
      V_NTT    rows [59n, 89n)      mod_q of the v NTT outputs
      PW       rows [89n, 121n)     pointwise hm = v + sig*pk rows
      NORM     rows [121n, 159n)    per-coefficient norm blocks (v || sig)
      BOUND    rows [159n, ...)     the norm-bound bit tree
    """
    params = get_params(n)
    NI = 2 * n + 1
    # witness bases (engine.py layout)
    W_SIG, W_V, W_RV = 0, n, 2 * n
    W_SN = 29 * n
    W_VN = 58 * n
    W_PW = 87 * n
    W_NM = 117 * n
    W_BD = 153 * n
    bw = 50 if n == 512 else 52
    num_wit = 153 * n + bw
    nc = 159 * n + (52 if n == 512 else 54)

    g = lambda w: NI + w  # witness index -> global col
    pieces = {"a": [], "b": [], "c": []}

    def emit(reg: _Region):
        for m in ("a", "b", "c"):
            pieces[m].append(reg.emit(m))

    # ---- LTQ_V ----------------------------------------------------------
    reg = _Region(0, 29, n)
    _ltq_into(reg, 0, g(W_V), 1, g(W_RV), 27)
    emit(reg)

    # ---- SIG_NTT / V_NTT ------------------------------------------------
    M_obj, O_obj = ntt_lc_matrix(n)
    for row0, in_base, blk in ((29 * n, g(W_SIG), W_SN), (59 * n, g(W_V), W_VN)):
        _emit_ntt_region(pieces, n, row0, in_base, g(blk), M_obj, O_obj)

    # ---- PW -------------------------------------------------------------
    row0 = 89 * n
    reg = _Region(row0, 32, n)
    # r0: sig_ntt_b * pk = prod
    reg.add("a", 0, g(W_SN) + 1, 29, 1)
    reg.add("b", 0, 1, 1, 1)                    # pk_i instance col 1+i
    reg.add("c", 0, g(W_PW), 30, 1)
    # r1: vb + prod - t*q - c = 0
    reg.add("a", 1, g(W_VN) + 1, 29, 1)
    reg.add("a", 1, g(W_PW), 30, 1)
    reg.add("a", 1, g(W_PW) + 1, 30, -Q)
    reg.add("a", 1, g(W_PW) + 2, 30, -1)
    reg.add("b", 1, 0, 0, 1)
    # r2..30: ltq on c
    _ltq_into(reg, 2, g(W_PW) + 2, 30, g(W_PW) + 3, 30)
    # r31: hm_i - c = 0
    reg.add("a", 31, 1 + n, 1, 1)               # hm instance col 1+n+i
    reg.add("a", 31, g(W_PW) + 2, 30, -1)
    reg.add("b", 31, 0, 0, 1)
    emit(reg)

    # ---- NORM -----------------------------------------------------------
    emit(_norm_region(121 * n, n, g(W_V), 1, g(W_NM)))
    emit(_norm_region((121 + 19) * n, n, g(W_SIG), 1, g(W_NM) + 18 * n))

    # ---- BOUND ----------------------------------------------------------
    emit(_bound_region(159 * n, n, g(W_NM) + 17, 18, 2 * n, g(W_BD)))

    # ---- assemble --------------------------------------------------------
    return CompiledR1CS(
        num_instance=NI,
        num_witness=num_wit,
        num_constraints=nc,
        field_rows=np.asarray([], dtype=np.int32),
        a=_assemble(pieces["a"], NI),
        b=_assemble(pieces["b"], NI),
        c=_assemble(pieces["c"], NI),
    )


def _assemble(parts, NI: int):
    """Concatenate region pieces and canonicalize to from_cs order:
    row-major, within-row sorted by ENCODED variable (instance i -> 2i,
    witness j -> 2j+1).  Values stay int64 when every piece is int64
    (CompiledR1CS consumers only require int(v) to work); object dtype is
    used only when big NTT coefficients are present."""
    rows = np.concatenate([p[0] for p in parts]).astype(np.int64)
    cols = np.concatenate([p[1] for p in parts]).astype(np.int64)
    if any(p[2].dtype == object for p in parts):
        vals = np.concatenate(
            [
                p[2] if p[2].dtype == object else p[2].astype(object)
                for p in parts
            ]
        )
    else:
        vals = np.concatenate([p[2] for p in parts])
    enc = np.where(cols < NI, 2 * cols, 2 * (cols - NI) + 1)
    # fused single sort key: row * 2*num_cols + enc (fits int64 easily)
    order = np.argsort(rows * (2 * (int(cols.max()) + 2)) + enc, kind="stable")
    return (
        rows[order].astype(np.int32),
        cols[order].astype(np.int32),
        vals[order],
    )


# --- the schoolbook circuit ------------------------------------------------


def direct_compile_schoolbook(n: int) -> CompiledR1CS:
    """CompiledR1CS for FalconSchoolBookVerificationCircuit, direct.

    Region map (R = n + 38 rows per main block; NI = 2n + 1):
      V_LTQ  rows [0, 29n)             v range proofs (v wires stride 28)
      MAIN   rows [29n, 29n + nR)      per output column: n mul rows,
                                       inner-product eq row, 29 c-range
                                       rows, two is_eq pairs, or, enforce
      NORM   rows [.., +38n)           norm blocks (v then sig)
      BOUND  tail                      norm-bound bit tree
    """
    params = get_params(n)
    NI = 2 * n + 1
    W_SIG = 0
    W_V = n                      # v blocks: [v | 27 ltq wires] stride 28
    W_MAIN = 29 * n              # blocks of n + 34
    BW = n + 34
    R = n + 38
    W_NM = W_MAIN + n * BW
    W_BD = W_NM + 36 * n
    bw = 50 if n == 512 else 52
    num_wit = W_BD + bw
    main_row0 = 29 * n
    norm_row0 = main_row0 + n * R
    bound_row0 = norm_row0 + 38 * n
    nc = bound_row0 + (52 if n == 512 else 54)

    g = lambda w: NI + w
    pieces = {"a": [], "b": [], "c": []}

    def emit(reg: _Region):
        for m in ("a", "b", "c"):
            pieces[m].append(reg.emit(m))

    # ---- V_LTQ ------------------------------------------------------------
    reg = _Region(0, 29, n)
    _ltq_into(reg, 0, g(W_V), 28, g(W_V) + 1, 28)
    emit(reg)

    # ---- MAIN: mul rows (vary in both block i and term j) ------------------
    i = np.arange(n, dtype=np.int64)[:, None]
    j = np.arange(n, dtype=np.int64)[None, :]
    rows_ij = (main_row0 + i * R + j).ravel()
    # A: sig_j
    pieces["a"].append(
        (
            rows_ij.astype(np.int32),
            np.broadcast_to(g(W_SIG) + j, (n, n)).ravel().astype(np.int32),
            np.ones(n * n, dtype=np.int64),
        )
    )
    # C: the product wire w_ij (block wire offset 2 + j)
    pieces["c"].append(
        (
            rows_ij.astype(np.int32),
            (g(W_MAIN) + i * BW + 2 + j).ravel().astype(np.int32),
            np.ones(n * n, dtype=np.int64),
        )
    )
    # B: column LC — buf[n-1-i+j]:
    #   j <= i: pk_{i-j} (instance col 1 + i - j), coeff 1
    #   j >  i: q*one - pk_{n-j+i} (one coeff q; pk col 1 + n - j + i, -1)
    lo_mask = (j <= i)
    lo_r = rows_ij[lo_mask.ravel()]
    lo_c = (1 + i - j)[lo_mask].ravel()
    hi_mask = ~lo_mask
    hi_r = rows_ij[hi_mask.ravel()]
    hi_c = (1 + n - j + i)[hi_mask].ravel()
    pieces["b"].append(
        (
            np.concatenate([lo_r, hi_r, hi_r]).astype(np.int32),
            np.concatenate(
                [lo_c, np.zeros(len(hi_r), np.int64), hi_c]
            ).astype(np.int32),
            np.concatenate(
                [
                    np.ones(len(lo_r), np.int64),
                    np.full(len(hi_r), Q, np.int64),
                    np.full(len(hi_r), -1, np.int64),
                ]
            ),
        )
    )

    # ---- MAIN: per-block template rows -------------------------------------
    reg = _Region(main_row0, R, n)
    mb = g(W_MAIN)  # + i*BW
    # eq row (off n): sum_j w_ij - t*q - c = 0
    reg.add("a", n, mb + 0, BW, -Q)     # t
    reg.add("a", n, mb + 1, BW, -1)     # c
    for jj in range(n):
        reg.add("a", n, mb + 2 + jj, BW, 1)
    reg.add("b", n, 0, 0, 1)
    # c range proof (off n+1 .. n+29)
    _ltq_into(reg, n + 1, mb + 1, BW, mb + n + 2, BW)
    # is_eq pair 1: booleanity(neq1); diff*m1 = neq1; diff*(1-neq1) = 0
    neq1, m1 = mb + n + 29, mb + n + 30
    neq2, m2 = mb + n + 31, mb + n + 32
    orw = mb + n + 33
    r = n + 30
    reg.add("a", r, 0, 0, 1)
    reg.add("a", r, neq1, BW, -1)
    reg.add("b", r, neq1, BW, 1)
    for rr in (n + 31, n + 32):  # the two diff rows share the A side
        reg.add("a", rr, 0, 0, Q)
        reg.add("a", rr, 1 + n, 1, 1)          # hm_i instance col
        reg.add("a", rr, g(W_V), 28, -1)       # v_i
        reg.add("a", rr, mb + 1, BW, -1)       # c
    reg.add("b", n + 31, m1, BW, 1)
    reg.add("c", n + 31, neq1, BW, 1)
    reg.add("b", n + 32, 0, 0, 1)
    reg.add("b", n + 32, neq1, BW, -1)
    # is_eq pair 2 (diff2 = diff - q*one: the one coefficient cancels)
    r = n + 33
    reg.add("a", r, 0, 0, 1)
    reg.add("a", r, neq2, BW, -1)
    reg.add("b", r, neq2, BW, 1)
    for rr in (n + 34, n + 35):
        reg.add("a", rr, 1 + n, 1, 1)
        reg.add("a", rr, g(W_V), 28, -1)
        reg.add("a", rr, mb + 1, BW, -1)
    reg.add("b", n + 34, m2, BW, 1)
    reg.add("c", n + 34, neq2, BW, 1)
    reg.add("b", n + 35, 0, 0, 1)
    reg.add("b", n + 35, neq2, BW, -1)
    # or wire: neq1 * neq2 = or
    reg.add("a", n + 36, neq1, BW, 1)
    reg.add("b", n + 36, neq2, BW, 1)
    reg.add("c", n + 36, orw, BW, 1)
    # Not(or) == TRUE
    reg.add("a", n + 37, 0, 0, 1)
    reg.add("a", n + 37, orw, BW, -1)
    reg.add("b", n + 37, 0, 0, 1)
    reg.add("c", n + 37, 0, 0, 1)
    emit(reg)

    # ---- NORM + BOUND ------------------------------------------------------
    emit(_norm_region(norm_row0, n, g(W_V), 28, g(W_NM)))
    emit(_norm_region(norm_row0 + 19 * n, n, g(W_SIG), 1, g(W_NM) + 18 * n))
    emit(_bound_region(bound_row0, n, g(W_NM) + 17, 18, 2 * n, g(W_BD)))

    field_rows = np.sort(
        np.concatenate(
            [
                main_row0 + np.arange(n) * R + (n + 31),
                main_row0 + np.arange(n) * R + (n + 34),
            ]
        )
    ).astype(np.int32)

    return CompiledR1CS(
        num_instance=NI,
        num_witness=num_wit,
        num_constraints=nc,
        field_rows=field_rows,
        a=_assemble(pieces["a"], NI),
        b=_assemble(pieces["b"], NI),
        c=_assemble(pieces["c"], NI),
    )


# --- the dual-NTT circuit ---------------------------------------------------


def direct_compile_dual_ntt(n: int) -> CompiledR1CS:
    """CompiledR1CS for FalconDualNTTVerificationCircuit, emitted directly.

    Hand-derivation of circuits/falcon_dual_ntt.generate_constraints
    (re-derivation of `falcon_dual_ntt.rs`); bit-identical to the traced
    compile (tests/test_direct_synthesis.py).

    Witness layout (NI = 2n+1 instance cols; per-dual blocks follow
    DualPolyVar.alloc_vars order: pos | neg | n disjoint-support muls |
    is_neq boolean | inverse multiplier):
      SIG    wires [0, 3n+2)
      V      wires [3n+2, 6n+4)
      NTT    wires [6n+4, 122n+4)     4 x 29n: sig_pos, sig_neg, v_pos, v_neg
      PW     wires [122n+4, 182n+4)   per coeff (stride 60):
                                      [m1 t1 b1 ltq*27 | m2 t2 b2 ltq*27]
      SQ     wires [182n+4, 186n+4)   norm squares: v_pos v_neg sig_pos sig_neg
      BOUND  wires [186n+4, ...)

    Row map:
      SIG dual  rows [0, n+4)         n muls, booleanity, diff*m=neq (FIELD
                                      row), diff*(1-neq)=0, Not(neq)==TRUE
      V dual    rows [n+4, 2n+8)
      NTT       rows [2n+8, 122n+8)   4 x 30n
      PW        rows [122n+8, 185n+8) per coeff 63 rows: mul1, eq1, ltq1*29,
                                      mul2, eq2, ltq2*29, left==right
      SQ        rows [185n+8, 189n+8)
      BOUND     rows [189n+8, ...)
    """
    params = get_params(n)
    NI = 2 * n + 1
    # witness bases
    W_SIGP, W_SIGN, W_SIGMUL = 0, n, 2 * n
    SIG_NEQ, SIG_M = 3 * n, 3 * n + 1
    W_VP, W_VN, W_VMUL = 3 * n + 2, 4 * n + 2, 5 * n + 2
    V_NEQ, V_M = 6 * n + 2, 6 * n + 3
    W_NT = 6 * n + 4          # four 29n blocks
    W_PW = 122 * n + 4        # stride 60
    W_SQ = 182 * n + 4        # 4n squares
    W_BD = 186 * n + 4
    bw = 50 if n == 512 else 52
    num_wit = W_BD + bw
    R_NTT = 2 * n + 8
    R_PW = 122 * n + 8
    R_SQ = 185 * n + 8
    R_BD = 189 * n + 8
    nc = R_BD + (52 if n == 512 else 54)

    g = lambda w: NI + w
    pieces = {"a": [], "b": [], "c": []}

    def emit(reg: _Region):
        for m in ("a", "b", "c"):
            pieces[m].append(reg.emit(m))

    # ---- dual allocations (sig then v) ------------------------------------
    for row0, (wp, wn, wm, neq, minv) in (
        (0, (W_SIGP, W_SIGN, W_SIGMUL, SIG_NEQ, SIG_M)),
        (n + 4, (W_VP, W_VN, W_VMUL, V_NEQ, V_M)),
    ):
        # n disjoint-support mul rows: pos_i * neg_i = mul_i
        reg = _Region(row0, 1, n)
        reg.add("a", 0, g(wp), 1, 1)
        reg.add("b", 0, g(wn), 1, 1)
        reg.add("c", 0, g(wm), 1, 1)
        emit(reg)
        # acc = sum mul_i ; acc.is_zero().enforce_equal(TRUE):
        tail = _Region(row0 + n, 0, 1)
        tail.add("a", 0, 0, 0, 1)            # booleanity (1-neq)*neq = 0
        tail.add("a", 0, g(neq), 0, -1)
        tail.add("b", 0, g(neq), 0, 1)
        for k in range(n):                   # acc * m = neq  (FIELD row)
            tail.add("a", 1, g(wm) + k, 0, 1)
        tail.add("b", 1, g(minv), 0, 1)
        tail.add("c", 1, g(neq), 0, 1)
        for k in range(n):                   # acc * (1 - neq) = 0
            tail.add("a", 2, g(wm) + k, 0, 1)
        tail.add("b", 2, 0, 0, 1)
        tail.add("b", 2, g(neq), 0, -1)
        tail.add("a", 3, 0, 0, 1)            # Not(neq) == TRUE
        tail.add("a", 3, g(neq), 0, -1)
        tail.add("b", 3, 0, 0, 1)
        tail.add("c", 3, 0, 0, 1)
        emit(tail)

    # ---- four NTT regions: sig_pos, sig_neg, v_pos, v_neg ------------------
    M_obj, O_obj = ntt_lc_matrix(n)
    for k, in_w in enumerate((W_SIGP, W_SIGN, W_VP, W_VN)):
        _emit_ntt_region(
            pieces, n, R_NTT + k * 30 * n, g(in_w),
            g(W_NT + k * 29 * n), M_obj, O_obj,
        )

    # ---- pointwise two-sided congruence ------------------------------------
    # b wires of the four NTT outputs (stride 29, offset +1 past t)
    SP_B = g(W_NT) + 1                    # sig_pos
    SN_B = g(W_NT + 29 * n) + 1           # sig_neg
    VP_B = g(W_NT + 2 * 29 * n) + 1       # v_pos
    VN_B = g(W_NT + 3 * 29 * n) + 1       # v_neg
    pw = g(W_PW)
    reg = _Region(R_PW, 63, n)
    # r0: m1 = sig_neg_ntt_i * pk_i
    reg.add("a", 0, SN_B, 29, 1)
    reg.add("b", 0, 1, 1, 1)              # pk instance col 1+i
    reg.add("c", 0, pw + 0, 60, 1)
    # r1: hm_i + v_neg_ntt_i + m1 - t1*q - b1 = 0
    reg.add("a", 1, 1 + n, 1, 1)          # hm instance col 1+n+i
    reg.add("a", 1, VN_B, 29, 1)
    reg.add("a", 1, pw + 0, 60, 1)
    reg.add("a", 1, pw + 1, 60, -Q)
    reg.add("a", 1, pw + 2, 60, -1)
    reg.add("b", 1, 0, 0, 1)
    # r2..r30: b1 < q
    _ltq_into(reg, 2, pw + 2, 60, pw + 3, 60)
    # r31: m2 = sig_pos_ntt_i * pk_i
    reg.add("a", 31, SP_B, 29, 1)
    reg.add("b", 31, 1, 1, 1)
    reg.add("c", 31, pw + 30, 60, 1)
    # r32: v_pos_ntt_i + m2 - t2*q - b2 = 0
    reg.add("a", 32, VP_B, 29, 1)
    reg.add("a", 32, pw + 30, 60, 1)
    reg.add("a", 32, pw + 31, 60, -Q)
    reg.add("a", 32, pw + 32, 60, -1)
    reg.add("b", 32, 0, 0, 1)
    # r33..r61: b2 < q
    _ltq_into(reg, 33, pw + 32, 60, pw + 33, 60)
    # r62: b1 == b2
    reg.add("a", 62, pw + 2, 60, 1)
    reg.add("a", 62, pw + 32, 60, -1)
    reg.add("b", 62, 0, 0, 1)
    emit(reg)

    # ---- norm squares (l2_norm_var_without_range_check order) --------------
    for k, in_w in enumerate((W_VP, W_VN, W_SIGP, W_SIGN)):
        reg = _Region(R_SQ + k * n, 1, n)
        reg.add("a", 0, g(in_w), 1, 1)
        reg.add("b", 0, g(in_w), 1, 1)
        reg.add("c", 0, g(W_SQ) + k * n, 1, 1)
        emit(reg)

    # ---- bound --------------------------------------------------------------
    emit(_bound_region(R_BD, n, g(W_SQ), 1, 4 * n, g(W_BD)))

    field_rows = np.asarray([n + 1, 2 * n + 5], dtype=np.int32)

    return CompiledR1CS(
        num_instance=NI,
        num_witness=num_wit,
        num_constraints=nc,
        field_rows=field_rows,
        a=_assemble(pieces["a"], NI),
        b=_assemble(pieces["b"], NI),
        c=_assemble(pieces["c"], NI),
    )
