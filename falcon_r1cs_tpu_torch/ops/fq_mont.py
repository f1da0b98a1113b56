"""BLS12-381 base-field (Fq, 381-bit) lazy Montgomery arithmetic in torch.

The torch twin of `falcon_r1cs_tpu/ops/fq_mont.py`: the same relaxed
signed 12-bit limbs, the same three products, semi-normalisation rounds,
f32 carry estimate and spill fold, so every result is bit-equal to the JAX
package's.  It is the plain version of the Montgomery kernel K4
(`mont_mul_chain`) and the arithmetic under the plain versions of the
point-add kernels K5 and K6 (ops/fq.py, csrc/fq_mont.cu).  `canonical`
reduces relaxed limbs to the canonical limbs of value mod q: K4, K5 and
K6 compute on 32-bit words and are held against their plain versions by
value.

Representation ("relaxed" limbs): value = sum l_i 2^(12 i) with signed
limbs |l_i| <= 2^12 + 2 and a small top (headroom) limb; representatives
are not unique and may be negative.  Montgomery domain x * 2^408 mod q.

Layout: LIMB-MAJOR, the limb axis first, (35, ...) int32 -- the layout
the kernels read, so neighbouring points sit at neighbouring addresses.
(The JAX package keeps the limb axis last; the host helpers
`int_to_limbs` / `limbs_to_int` keep its row form.)

What differs from the JAX module, with the same integers as a result:
- the two constant-operand products (by mu and by q) are plain limb
  products; the JAX package's int8 MXU split (`_const_mul`) is a TPU
  workaround that computes the same sums;
- the CRT residue dot is a multiply-accumulate over the 37 limb rows
  (torch has no int32 matmul on CUDA);
- f32 sums may run in another order; every f32 estimate here is rounded
  to an integer far from a rounding boundary (`_carry_estimate`) or only
  steers a test whose outcome does not depend on it (`is_zero_mod_q`),
  so the results do not change.  `torch.round` rounds half to even, as
  `jnp.round` does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..snark.bls12_381 import P as Q381

LIMB = 12
MASK = (1 << LIMB) - 1
NSIG = 34            # significant limbs: 2^408 > q * 2^27
NL = NSIG + 1        # plus one headroom limb
PROD = 2 * NL + 1    # product buffer: 69 anti-diagonals + 2 spare columns
R_BITS = LIMB * NSIG  # Montgomery R = 2^408
R_MONT = 1 << R_BITS
R2 = R_MONT * R_MONT % Q381
MU = (-pow(Q381, -1, R_MONT)) % R_MONT  # -q^{-1} mod 2^408


def _to_limb_vec(v: int, n: int) -> np.ndarray:
    return np.asarray([(v >> (LIMB * k)) & MASK for k in range(n)],
                      dtype=np.int32)


Q_LIMBS = _to_limb_vec(Q381, NL)
MU_LIMBS = _to_limb_vec(MU, NSIG)  # mu < 2^408
# f32 weights recovering k = value(low 34 limbs) / 2^408 (|k| <= 2)
_CARRY_W = np.asarray(
    [float(2.0 ** (LIMB * i - R_BITS)) for i in range(NSIG)], dtype=np.float32
)
# f32 weights estimating value / q
_ALPHA_W = np.asarray(
    [float((1 << (LIMB * i)) / Q381) for i in range(NL)], dtype=np.float32
)

# 30 distinct 13-bit primes; their product (~2^389.8) exceeds q, so a
# value in (-q/2, q/2) with all residues zero is zero.
_primes = []
_c = (1 << 13) - 1
while len(_primes) < 30:
    if all(_c % d for d in range(3, 91, 2)):
        _primes.append(_c)
    _c -= 2
_CRT_PRIMES = np.asarray(_primes, dtype=np.int32)
_ZCOLS = NL + 2  # zero-test scratch width (2 spare columns for _semi)
_CRT_W = np.stack(
    [
        np.asarray([pow(1 << (LIMB * i), 1, int(p)) for i in range(_ZCOLS)],
                   dtype=np.int32)
        for p in _CRT_PRIMES
    ],
    axis=1,
)  # (_ZCOLS, 30)
_CRT_RECIP = (1.0 / _CRT_PRIMES.astype(np.float64)).astype(np.float32)


def int_to_limbs(vals) -> np.ndarray:
    """list[int] -> (B, 35) int32 canonical (nonneg, < 2^12) limbs."""
    out = np.zeros((len(vals), NL), dtype=np.int32)
    for i, v in enumerate(vals):
        v = int(v) % Q381
        for k in range(NL):
            out[i, k] = v & MASK
            v >>= LIMB
    return out


def limbs_to_int(row) -> int:
    """Exact signed evaluation (python bigint); callers reduce mod q."""
    return sum(int(c) << (LIMB * k) for k, c in enumerate(np.asarray(row)))


# canonical limbs of R^2 (to_mont) and of one in the Montgomery domain
R2_LIMBS = int_to_limbs([R2])[0]
ONE_MONT_LIMBS = int_to_limbs([R_MONT % Q381])[0]


@functools.lru_cache(maxsize=None)
def consts(device) -> dict:
    """The constant vectors as tensors on `device`."""
    host = {
        "q": Q_LIMBS, "mu": MU_LIMBS, "carry_w": _CARRY_W, "alpha_w": _ALPHA_W,
        "crt_w": _CRT_W, "crt_p": _CRT_PRIMES, "crt_r": _CRT_RECIP,
        "r2": R2_LIMBS, "one": ONE_MONT_LIMBS,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def _col(vec, ndim: int):
    """(L,) -> (L, 1, ..., 1) broadcasting against (L, ...) limb tensors."""
    return vec.reshape((vec.shape[0],) + (1,) * (ndim - 1))


def _semi_round(t):
    """One masked shift-add round over the limb axis: t_k -> (t_k & MASK)
    + (t_{k-1} >> 12) for k < top; the TOP row keeps its full value plus
    the incoming carry, so the round is value-preserving unconditionally.
    `>>` on int32 is arithmetic, as in jnp."""
    low = t & MASK
    carry = t >> LIMB
    return torch.cat([low[:1], low[1:-1] + carry[:-2], (t[-1] + carry[-2])[None]])


def _semi(t, rounds: int = 3):
    """Semi-normalize: |limbs| < 2^29 -> <= 2^12 + 2 in three rounds."""
    for _ in range(rounds):
        t = _semi_round(t)
    return t


def _big_mul(a, b, ncols: int = PROD):
    """Limb product: (na, ...) x (nb, ...) -> (ncols, ...) raw
    anti-diagonal sums T[c] = sum_{i+j=c} a_i b_j (b may be a constant
    (nb,) vector).  Exact in int32: 35 (2^12 + 2)^2 < 2^29.1."""
    if b.dim() == 1:
        b = _col(b, a.dim())
    out = torch.zeros((ncols,) + tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:])),
                      dtype=torch.int32, device=a.device)
    nb = b.shape[0]
    for i in range(a.shape[0]):
        out[i : i + nb] += a[i] * b
    return out


def _carry_estimate(s_low):
    """k = value(s_low) / 2^408 for a 34-limb slice whose value is an exact
    multiple of 2^408 (|k| <= 2): one f32 weighted sum + round."""
    w = _col(consts(s_low.device)["carry_w"], s_low.dim())
    return torch.round((s_low.to(torch.float32) * w).sum(dim=0)).to(torch.int32)


def mont_mul(a, b):
    """Batched lazy Montgomery product: (35, ...) x (35, ...) -> (35, ...).

    result = (T + m q)/R with T = a b and m = T mu mod R; T, u = m q and
    s = T + u are exact integers in a 71-row buffer, s is an exact
    multiple of R, and the divide by R is a slice plus the carry k of the
    low half.  The spill rows 69-70 fold into the headroom limb."""
    c = consts(a.device)
    t_full = _semi(_big_mul(a, b))                     # exact T, 71 rows
    m = _semi(_big_mul(t_full[:NSIG], c["mu"]))[:NSIG]
    # m's spill rows are dropped: multiples of R vanish mod R
    u = _semi(_big_mul(m, c["q"]))                     # exact m*q
    s = _semi_round(t_full + u)                        # exact, == 0 mod R
    k = _carry_estimate(s[:NSIG])
    hi = s[NSIG : NSIG + NL]                           # exact shift by R
    spill = s[NSIG + NL :]
    top = hi[-1] + spill[0] * (1 << LIMB) + spill[1] * (1 << (2 * LIMB))
    return torch.cat([(hi[0] + k)[None], hi[1:-1], top[None]])


def mont_mul_chain(a, b, depth: int = 1):
    """x = mont_mul(a, b), then depth - 1 more x <- mont_mul(x, b): the
    plain version of K4."""
    x = mont_mul(a, b)
    for _ in range(depth - 1):
        x = mont_mul(x, b)
    return x


def add_mod(a, b):
    """Lazy add: limbwise sum + one redistribution round."""
    return _semi_round(a + b)


def sub_mod(a, b):
    """Lazy subtract: limbwise difference (negative limbs are fine)."""
    return _semi_round(a - b)


def to_mont(a_std):
    r2 = consts(a_std.device)["r2"]
    return mont_mul(a_std, _col(r2, a_std.dim()).expand(a_std.shape))


def from_mont(a_mont):
    one = torch.zeros_like(a_mont)
    one[0] = 1
    return mont_mul(a_mont, one)


def is_zero_mod_q(t):
    """Exact (t == 0 mod q) for relaxed reps with |value| <= ~2^15 q.

    alpha = round(value/q) by one f32 weighted sum, z = t - alpha q, then
    z's 30 CRT residues mod 13-bit primes (int32, exact: < 37 2^12.01
    2^13 < 2^31) are all zero iff z == 0."""
    c = consts(t.device)
    nd = t.dim()
    alpha = torch.round(
        (t.to(torch.float32) * _col(c["alpha_w"], nd)).sum(dim=0)
    ).to(torch.int32)
    z = t - alpha[None] * _col(c["q"], nd)
    z = _semi(torch.cat([z, torch.zeros_like(z[: _ZCOLS - NL])]))
    r = torch.zeros((_CRT_PRIMES.shape[0],) + tuple(t.shape[1:]),
                    dtype=torch.int32, device=t.device)
    for i in range(_ZCOLS):
        r += z[i][None] * _col(c["crt_w"][i], nd)
    p = _col(c["crt_p"], nd)
    kq = torch.round(r.to(torch.float32) * _col(c["crt_r"], nd)).to(torch.int32) * p
    return (r == kq).all(dim=0)


def eq_mod_q(a, b):
    """Exact value equality mod q of two relaxed reps."""
    return is_zero_mod_q(sub_mod(a, b))


def full_carry(z):
    """Sequential carry over the limb axis: limbs 0..33 become digits in
    [0, 2^12) and the top limb takes the rest, so its sign is the value's."""
    rows = list(z.unbind(0))
    for k in range(NL - 1):
        rows[k + 1] = rows[k + 1] + (rows[k] >> LIMB)
        rows[k] = rows[k] & MASK
    return torch.stack(rows)


def _to_range(z, q):
    """Carried limbs of a value in (-2q, 3q) -> its residue in [0, q)."""
    for _ in range(2):
        z = full_carry(torch.where(z[-1:] < 0, z + q, z))
    for _ in range(2):
        d = full_carry(z - q)
        z = torch.where(d[-1:] >= 0, d, z)
    return z


def canonical(t):
    """Relaxed (35, ...) limbs -> the canonical limbs of value mod q: every
    limb in [0, 2^12), limb 34 zero.  Exact for |value| <= 2^15 q.

    The value's magnitude is carried to nonnegative digits first, so the
    f32 quotient estimate (the weights of `is_zero_mod_q`) sums terms of
    one sign (no cancellation: error < 2^-4 at 2^15 q) and leaves a
    remainder in (-q, q); corrections bring it to [0, q), and a negative
    value takes q minus its magnitude's residue.  The value comparison of
    K4, K5 and K6 with their plain versions (ops/fq_check.py)."""
    c = consts(t.device)
    nd = t.dim()
    q = _col(c["q"], nd)
    z = full_carry(t)
    neg = z[-1:] < 0
    z = full_carry(torch.where(neg, -z, z))
    alpha = torch.round(
        (z.to(torch.float32) * _col(c["alpha_w"], nd)).sum(dim=0)
    ).to(torch.int32)
    z = _to_range(full_carry(z - alpha[None] * q), q)
    return _to_range(torch.where(neg, full_carry(q - z), z), q)
