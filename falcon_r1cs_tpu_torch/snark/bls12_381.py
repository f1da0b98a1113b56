"""BLS12-381: field tower, curve groups, and pairing (pure Python core).

The reference obtains its SNARK backend from ark-bls12-381 + ark-groth16
(`falcon-r1cs/examples/pok_sig.rs:30-47`, Cargo deps); this
module is the from-scratch equivalent: the base-field tower
Fq -> Fq2 -> Fq6 -> Fq12, Jacobian group law on E(Fq): y^2 = x^3 + 4 and the
sextic twist E'(Fq2): y^2 = x^3 + 4(u+1), and a reduced Tate pairing with
final exponentiation.  Everything is validated structurally at import:
the BLS12 family relations tie p and r to the curve parameter x, and the
hardcoded generators are asserted on-curve; subgroup order and pairing
bilinearity are covered by tests/test_bls12_381.py.

Design notes (TPU-first framework context): this file is the *host-side
correctness core*.  The hot paths (multi-scalar multiplication, Fr FFT)
live in native C (native/groth16_native.c) and on the TPU (ops/ MSM
kernels); both are differentially tested against this implementation.

Representation: functional ops over plain ints / tuples (no classes in the
hot loops).  Fq2 = (a0, a1) with u^2 = -1; Fq6 = (c0, c1, c2) over Fq2 with
v^3 = xi = u + 1; Fq12 = (d0, d1) over Fq6 with w^2 = v.
"""

from __future__ import annotations

# --- parameters -----------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS_X = -0xD201000000010000  # the BLS12 curve parameter

# family relations pin (p, r) to BLS_X — a wrong constant fails at import
assert R == BLS_X**4 - BLS_X**2 + 1
assert P == ((BLS_X - 1) ** 2 * R) // 3 + BLS_X
assert P % 4 == 3  # sqrt via pow((p+1)/4)

H1 = (BLS_X - 1) ** 2 // 3                 # G1 cofactor

# |E(Fq)| = p + 1 - t with trace t = x + 1;  |E'(Fq2)| = p^2 + 1 - t2 with
# t2 = t^2 - 2p (quadratic twist of E(Fq2) picks the "+" sign for BLS12-381)
_T = BLS_X + 1
assert (P + 1 - _T) == H1 * R
H2 = (P**2 + 1 - (_T * _T - 2 * P)) // R
assert (P**2 + 1 - (_T * _T - 2 * P)) % R == 0

# --- Fq -------------------------------------------------------------------


def fq_inv(a: int) -> int:
    return pow(a, -1, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p = 3 mod 4), or None if a is a non-residue."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a % P else None


# --- Fq2 = Fq[u]/(u^2+1) --------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)
XI = (1, 1)  # the sextic non-residue u + 1


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return (-a[0] % P, -a[1] % P)


def f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # Karatsuba: (a0+a1)(b0+b1) - t0 - t1 = a0b1 + a1b0
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def f2_sqr(a):
    a0, a1 = a
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def f2_muli(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def f2_mul_xi(a):
    """Multiply by xi = 1 + u: (a0 - a1) + (a0 + a1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def f2_conj(a):
    return (a[0], -a[1] % P)


def f2_inv(a):
    a0, a1 = a
    norm_inv = pow(a0 * a0 + a1 * a1, -1, P)
    return (a0 * norm_inv % P, -a1 * norm_inv % P)


def f2_sqrt(a):
    """Square root in Fq2 (complex method), or None."""
    a0, a1 = a
    if a1 == 0:
        s = fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        # a0 is a QNR: sqrt is purely imaginary, (t u)^2 = -t^2
        t = fq_sqrt(-a0 % P)
        return None if t is None else (0, t)
    # alpha = norm(a) = a0^2 + a1^2 must be a QR in Fq
    alpha = fq_sqrt((a0 * a0 + a1 * a1) % P)
    if alpha is None:
        return None
    # delta = (a0 + alpha)/2; if not square, use (a0 - alpha)/2
    inv2 = (P + 1) // 2
    for sgn in (alpha, -alpha % P):
        delta = (a0 + sgn) * inv2 % P
        x0 = fq_sqrt(delta)
        if x0 is not None and x0 != 0:
            x1 = a1 * inv2 % P * fq_inv(x0) % P
            cand = (x0, x1)
            if f2_sqr(cand) == (a0 % P, a1 % P):
                return cand
    return None


# --- Fq6 = Fq2[v]/(v^3 - xi) ---------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def f6_add(a, b):
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a, b):
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a):
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    # Toom/Karatsuba-style interpolation
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


# --- Fq12 = Fq6[w]/(w^2 - v) ---------------------------------------------

FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (f6_add(t0, f6_mul_v(t1)), c1)


def f12_sqr(a):
    a0, a1 = a
    t = f6_mul(a0, a1)
    c0 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_v(a1))), f6_add(t, f6_mul_v(t)))
    return (c0, f6_add(t, t))


def f12_conj(a):
    """Fq12/Fq6 conjugation d0 + d1 w -> d0 - d1 w (= Frobenius^6)."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    t = f6_inv(f6_sub(f6_sqr(a0), f6_mul_v(f6_sqr(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_pow(a, e: int):
    result = FQ12_ONE
    if e < 0:
        a = f12_inv(a)
        e = -e
    while e:
        if e & 1:
            result = f12_mul(result, a)
        a = f12_sqr(a)
        e >>= 1
    return result


# --- curve groups (Jacobian) ---------------------------------------------
# E(Fq):  y^2 = x^3 + 4        — group G1 (the r-torsion inside it)
# E'(Fq2): y^2 = x^3 + 4(u+1)  — group G2 lives on the twist
#
# A Jacobian point is (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z == zero-elem
# means infinity.  The same formulas serve both curves via the field-op
# table below (b does not appear in add/double formulas).


class _Ops:
    __slots__ = ("add", "sub", "neg", "mul", "sqr", "muli", "inv", "zero", "one")

    def __init__(self, add, sub, neg, mul, sqr, muli, inv, zero, one):
        self.add, self.sub, self.neg, self.mul = add, sub, neg, mul
        self.sqr, self.muli, self.inv = sqr, muli, inv
        self.zero, self.one = zero, one


_FQ_OPS = _Ops(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    neg=lambda a: -a % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    muli=lambda a, k: a * k % P,
    inv=fq_inv,
    zero=0,
    one=1,
)

_FQ2_OPS = _Ops(
    add=f2_add, sub=f2_sub, neg=f2_neg, mul=f2_mul, sqr=f2_sqr,
    muli=f2_muli, inv=f2_inv, zero=FQ2_ZERO, one=FQ2_ONE,
)


def _dbl(ops, pt):
    if pt is None:
        return None
    X, Y, Z = pt
    A = ops.sqr(X)
    B = ops.sqr(Y)
    C = ops.sqr(B)
    D = ops.muli(ops.sub(ops.sub(ops.sqr(ops.add(X, B)), A), C), 2)
    E = ops.muli(A, 3)
    F = ops.sqr(E)
    X3 = ops.sub(F, ops.muli(D, 2))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), ops.muli(C, 8))
    Z3 = ops.muli(ops.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _add(ops, pt1, pt2):
    if pt1 is None:
        return pt2
    if pt2 is None:
        return pt1
    X1, Y1, Z1 = pt1
    X2, Y2, Z2 = pt2
    Z1Z1 = ops.sqr(Z1)
    Z2Z2 = ops.sqr(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(ops.mul(Y1, Z2), Z2Z2)
    S2 = ops.mul(ops.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 != S2:
            return None
        return _dbl(ops, pt1)
    H = ops.sub(U2, U1)
    I = ops.sqr(ops.muli(H, 2))
    J = ops.mul(H, I)
    rr = ops.muli(ops.sub(S2, S1), 2)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sqr(rr), J), ops.muli(V, 2))
    Y3 = ops.sub(ops.mul(rr, ops.sub(V, X3)), ops.muli(ops.mul(S1, J), 2))
    Z3 = ops.muli(ops.mul(ops.mul(Z1, Z2), H), 2)
    return (X3, Y3, Z3)


def _mul_scalar(ops, pt, k: int):
    if k < 0:
        pt = _negpt(ops, pt)
        k = -k
    result = None
    while k:
        if k & 1:
            result = _add(ops, result, pt)
        pt = _dbl(ops, pt)
        k >>= 1
    return result


def _negpt(ops, pt):
    if pt is None:
        return None
    X, Y, Z = pt
    return (X, ops.neg(Y), Z)


def _to_affine(ops, pt):
    if pt is None:
        return None
    X, Y, Z = pt
    zinv = ops.inv(Z)
    zinv2 = ops.sqr(zinv)
    return (ops.mul(X, zinv2), ops.mul(ops.mul(Y, zinv), zinv2))


def _from_affine(ops, aff):
    if aff is None:
        return None
    return (aff[0], aff[1], ops.one)


# G1 API ------------------------------------------------------------------

def g1_add(a, b):
    return _add(_FQ_OPS, a, b)


def g1_double(a):
    return _dbl(_FQ_OPS, a)


def g1_neg(a):
    return _negpt(_FQ_OPS, a)


def g1_mul(a, k: int):
    return _mul_scalar(_FQ_OPS, a, k)


def g1_to_affine(a):
    return _to_affine(_FQ_OPS, a)


def g1_from_affine(aff):
    return _from_affine(_FQ_OPS, aff)


def g1_is_on_curve(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    return (y * y - (x * x * x + 4)) % P == 0


# G2 API (points on the twist, coordinates in Fq2) ------------------------

def g2_add(a, b):
    return _add(_FQ2_OPS, a, b)


def g2_double(a):
    return _dbl(_FQ2_OPS, a)


def g2_neg(a):
    return _negpt(_FQ2_OPS, a)


def g2_mul(a, k: int):
    return _mul_scalar(_FQ2_OPS, a, k)


def g2_to_affine(a):
    return _to_affine(_FQ2_OPS, a)


def g2_from_affine(aff):
    return _from_affine(_FQ2_OPS, aff)


def g2_is_on_curve(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    b = f2_muli(XI, 4)
    return f2_sqr(y) == f2_add(f2_mul(f2_sqr(x), x), b)


# generators (standard, as in the IETF pairing-friendly-curves draft /
# zcash spec; asserted on-curve here, order r asserted in tests)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)
assert g1_is_on_curve(G1_GEN)
assert g2_is_on_curve(G2_GEN)


# --- pairing --------------------------------------------------------------
#
# Reduced Tate pairing e: G1 x G2 -> mu_r in Fq12.
#   e(P, Q) = f_{r,P}(psi(Q)) ^ ((q^12 - 1) / r)
# with psi the untwist E'(Fq2) -> E(Fq12):
#   psi(x', y') = (x' * w^-2, y' * w^-3),  w^6 = xi
# (verified: y^2 - x^3 = (y'^2 - x'^3)/xi = 4 on the untwisted point).
# The Miller loop runs over the bits of r with T kept affine in Fq (cheap:
# slopes are Fq scalars), line values evaluated at psi(Q).

_XI_INV = f2_inv(XI)

# final-exponent split: (q^12-1)/r = (q^6-1) * (q^6+1)/r; the first factor
# is one conjugation + inversion, the second a plain square-and-multiply.
_FINAL_EXP_HARD = (P**6 + 1) // R
assert (P**6 + 1) % R == 0


def _untwist(q_aff):
    """E'(Fq2) affine -> (x, y) in Fq12 on E: y^2 = x^3 + 4."""
    xq, yq = q_aff
    x12 = ((FQ2_ZERO, FQ2_ZERO, f2_mul(xq, _XI_INV)), FQ6_ZERO)
    y12 = (FQ6_ZERO, (FQ2_ZERO, f2_mul(yq, _XI_INV), FQ2_ZERO))
    return x12, y12


def _line_eval(xt, yt, lam, xq12, yq12):
    """Value of the line through T (slope lam, all Fq) at psi(Q) in Fq12:
    l = yQ - yt - lam * (xQ - xt)."""
    # lam * xQ: xQ has a single nonzero Fq2 coefficient -> scale it
    (x6a, _x6b) = xq12
    lx = ((FQ2_ZERO, FQ2_ZERO, f2_muli(x6a[2], lam)), FQ6_ZERO)
    const = (-yt + lam * xt) % P
    c12 = (((const, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)
    t = f12_add(yq12, c12)
    return f12_sub(t, lx)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


_R_BITS = bin(R)[2:]


def miller_loop(p_aff, q_aff):
    """f_{r,P}(psi(Q)) — unreduced pairing value in Fq12.

    Vertical lines (x - x_T evaluated at psi(Q)) lie entirely in the Fq6
    subfield — psi(Q).x = x' xi^-1 v^2 has no w component — and every
    Fq6 factor is annihilated by the (q^6 - 1) easy part of the final
    exponentiation, so verticals are dropped throughout (standard trick).
    The only special case is the last addition step of the loop, where
    T = (r-1)P = -P and the chord is itself vertical: it is skipped and
    T becomes O.
    """
    if p_aff is None or q_aff is None:
        return FQ12_ONE
    xq12, yq12 = _untwist(q_aff)
    xp, yp = p_aff
    xt, yt = xp, yp
    f = FQ12_ONE
    for bit in _R_BITS[1:]:
        # doubling step: tangent at T (skip once T = O at the loop tail)
        f = f12_sqr(f)
        if xt is None:
            continue
        lam = 3 * xt * xt * pow(2 * yt, -1, P) % P
        f = f12_mul(f, _line_eval(xt, yt, lam, xq12, yq12))
        x3 = (lam * lam - 2 * xt) % P
        yt = (lam * (xt - x3) - yt) % P
        xt = x3
        if bit == "1":
            if xt == xp and (yt + yp) % P == 0:
                # T = -P: vertical chord (killed by final exp); T <- O
                xt, yt = None, None
                continue
            lam = (yp - yt) * pow(xp - xt, -1, P) % P
            f = f12_mul(f, _line_eval(xt, yt, lam, xq12, yq12))
            x3 = (lam * lam - xt - xp) % P
            yt = (lam * (xt - x3) - yt) % P
            xt = x3
    return f


def f2_pow(a, e: int):
    r = FQ2_ONE
    for bit in bin(e)[2:]:
        r = f2_sqr(r)
        if bit == "1":
            r = f2_mul(r, a)
    return r


# Frobenius on Fq12: for the coefficient of v^i w^j (an Fq2 value c),
# frob(c v^i w^j) = conj(c) * gamma^(2i+j) * v^i w^j with
# gamma = xi^((q-1)/6)  (w^6 = v^3 = xi, and q = 1 mod 6).
_FROB_GAMMA = [FQ2_ONE] + [f2_pow(XI, (P - 1) * k // 6) for k in range(1, 6)]


def f12_frobenius(a):
    """a^q via coefficient conjugation + the precomputed gamma twists;
    verified against f12_pow(a, P) in tests/test_snark.py."""
    (c00, c01, c02), (c10, c11, c12) = a
    g = _FROB_GAMMA
    return (
        (
            f2_conj(c00),
            f2_mul(f2_conj(c01), g[2]),
            f2_mul(f2_conj(c02), g[4]),
        ),
        (
            f2_mul(f2_conj(c10), g[1]),
            f2_mul(f2_conj(c11), g[3]),
            f2_mul(f2_conj(c12), g[5]),
        ),
    )


def _fp4_sqr(a, b):
    """(a + b t)^2 in Fq4 = Fq2[t]/(t^2 - xi): returns (a^2 + xi b^2, 2ab)."""
    t0 = f2_sqr(a)
    t1 = f2_sqr(b)
    c0 = f2_add(t0, f2_mul_xi(t1))
    c1 = f2_sub(f2_sub(f2_sqr(f2_add(a, b)), t0), t1)
    return c0, c1


def f12_cyclotomic_sqr(x):
    """Granger-Scott squaring, valid for elements of the cyclotomic
    subgroup (order q^4 - q^2 + 1, i.e. anything after the easy part of
    the final exponentiation): three Fq4 squarings instead of a full
    Fq12 square.  Verified == f12_sqr on cyclotomic elements in tests."""
    (z0, z4, z3), (z2, z1, z5) = x
    t0, t1 = _fp4_sqr(z0, z1)
    z0 = f2_sub(f2_muli(t0, 3), f2_muli(z0, 2))
    z1 = f2_add(f2_muli(t1, 3), f2_muli(z1, 2))
    t0b, t1b = _fp4_sqr(z2, z3)
    t2, t3 = _fp4_sqr(z4, z5)
    z4 = f2_sub(f2_muli(t0b, 3), f2_muli(z4, 2))
    z5 = f2_add(f2_muli(t1b, 3), f2_muli(z5, 2))
    t3x = f2_mul_xi(t3)
    z2 = f2_add(f2_muli(t3x, 3), f2_muli(z2, 2))
    z3 = f2_sub(f2_muli(t2, 3), f2_muli(z3, 2))
    return ((z0, z4, z3), (z2, z1, z5))


# hard-part exponent (q^4 - q^2 + 1)/r in base-q digits: the hard part is
# computed as a 4-way simultaneous exponentiation over the Frobenius
# conjugates f^(q^i) (Shamir's trick), with cyclotomic squarings.  Digit
# bit-lengths: 381/254/381/126 -> 381 squarings + ~360 multiplies versus
# ~2031 squarings + ~1015 multiplies for the one-base naive pow.
_HARD = (P**4 - P**2 + 1) // R
assert (P**4 - P**2 + 1) % R == 0
_HARD_DIGITS = []
_d = _HARD
for _ in range(4):
    _HARD_DIGITS.append(_d % P)
    _d //= P
assert _d == 0
_HARD_BITS = max(d.bit_length() for d in _HARD_DIGITS)


def final_exponentiation(f):
    """f ^ ((q^12 - 1)/r), split (q^6-1)(q^2+1) * (q^4-q^2+1)/r:
    conjugation/Frobenius for the easy factors, then a Frobenius-base
    multi-exponentiation with Granger-Scott squarings for the hard part
    (== the naive pow — asserted in tests/test_snark.py)."""
    f = f12_mul(f12_conj(f), f12_inv(f))          # ^(q^6 - 1)
    f = f12_mul(f12_frobenius(f12_frobenius(f)), f)  # ^(q^2 + 1)
    # bases f^(q^i), i = 0..3, and the 15 non-empty subset products
    bases = [f]
    for _ in range(3):
        bases.append(f12_frobenius(bases[-1]))
    table = [FQ12_ONE] * 16
    for m in range(1, 16):
        low = m & -m
        table[m] = (
            bases[low.bit_length() - 1]
            if m == low
            else f12_mul(table[m ^ low], table[low])
        )
    acc = FQ12_ONE
    for b in range(_HARD_BITS - 1, -1, -1):
        acc = f12_cyclotomic_sqr(acc)
        m = 0
        for i in range(4):
            m |= ((_HARD_DIGITS[i] >> b) & 1) << i
        if m:
            acc = f12_mul(acc, table[m])
    return acc


def final_exponentiation_naive(f):
    """Reference path: easy part + plain square-and-multiply (kept as the
    differential oracle for the optimized final_exponentiation)."""
    f = f12_mul(f12_conj(f), f12_inv(f))  # f^(q^6 - 1)
    return f12_pow(f, _FINAL_EXP_HARD)    # ^ (q^6+1)/r


def pairing(p_aff, q_aff):
    """Reduced Tate pairing e(P, Q), P in G1 affine, Q in G2 affine."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


def multi_pairing(pairs):
    """prod e(P_i, Q_i) with a single shared final exponentiation."""
    f = FQ12_ONE
    for p_aff, q_aff in pairs:
        if p_aff is None or q_aff is None:
            continue
        f = f12_mul(f, miller_loop(p_aff, q_aff))
    return final_exponentiation(f)
