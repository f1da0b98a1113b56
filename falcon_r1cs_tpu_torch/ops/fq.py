"""G1 point arithmetic over Fq: the plain torch versions of the point-add
kernels and the wrappers of the three hand-written CUDA kernels in
`csrc/fq_mont.cu`.

The counterpart of `falcon_r1cs_tpu/ops/pallas_fq.py` (and of the XLA
`point_add` / `point_double` in `falcon_r1cs_tpu/snark/tpu_msm.py`):

- `mont_mul_cuda(a, b, depth)` launches `mont_mul_kernel` (K4, the port
  of `_build_mul_cached`'s kernel): x <- mont_mul(x, b), depth times;
  plain version `fq_mont.mont_mul_chain`.
- `point_add_cuda(p1, p2)` launches `point_add_kernel` (K5, the port of
  `_point_add_kernel`): the complete Jacobian add; plain version
  `point_add`, the port of tpu_msm's `point_add`, bit-equal to the JAX
  package except on the rows where the JAX package's relaxed equality
  test errs (the plain versions test equality exactly, `eq_exact`).
- `point_add_aff_cuda(p1, p2)` launches `point_add_aff_kernel` (K6, the
  port of `_point_add_aff_kernel`): affine + affine -> Jacobian; plain
  version `point_add_aff`, a transcription of that Pallas kernel (the JAX
  package has no XLA form of it).

The three kernels compute on 12 words of 32 bits in the R' = 2^384
domain and equal their plain versions by VALUE, not limb for limb: each
output coordinate is congruent mod q to the plain version's
(`fq_mont.canonical` of both agree) and comes out canonical (limbs in
[0, 2^12), limb 34 zero), except on the rows of K5 and K6 with an
infinite operand, which copy the other operand as given (K6 with Z the
canonical limbs of one); the flags are exactly equal
(`fq_check.value_check`).

Points are limb-major: X, Y, Z (35, m) int32 relaxed Montgomery limbs and
infinity flags (m,) bool; an affine point is (X, Y, inf).  Each wrapper
takes its plain version for CPU tensors, launches its kernel through
`_build.launch` for CUDA tensors and raises for anything else; there is
no fallback from a CUDA tensor to the plain path.  `.launches` counts
kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import fq_mont as fq


def _dbl(a, times: int = 1):
    for _ in range(times):
        a = fq.add_mod(a, a)
    return a


def point_double(pt):
    """Jacobian doubling (dbl-2007-bl); pt = (X, Y, Z, inf)."""
    X, Y, Z, inf = pt
    mul, add, sub = fq.mont_mul, fq.add_mod, fq.sub_mod
    A = mul(X, X)
    B = mul(Y, Y)
    C = mul(B, B)
    t = add(X, B)
    t = mul(t, t)
    t = sub(sub(t, A), C)
    D = _dbl(t)
    E = add(_dbl(A), A)
    F = mul(E, E)
    X3 = sub(F, _dbl(D))
    Y3 = sub(mul(E, sub(D, X3)), _dbl(C, 3))
    Z3 = _dbl(mul(Y, Z))
    return (X3, Y3, Z3, inf)


def _sel(cond, a, b):
    return torch.where(cond[None], a, b)


def eq_exact(a, b):
    """Exact value equality mod q of two relaxed reps, the point adds'
    test, exact as the kernels' word compare is.  `fq_mont.eq_mod_q` (the
    JAX package's) steers by an f32 quotient estimate that cancels when
    the difference is negative with its top limb -1 over limbs near 2^12,
    and then calls equal values unequal (ROADMAP Queue 3), which sends a
    doubling or a P + (-P) row down the chord.  Here the difference's
    magnitude is carried to nonnegative digits first (as in
    `fq_mont.canonical`), so the estimate sums terms of one sign."""
    d = fq.full_carry(fq.sub_mod(a, b))
    return fq.is_zero_mod_q(fq.full_carry(torch.where(d[-1:] < 0, -d, d)))


def point_add(p1, p2):
    """Complete Jacobian addition: the chord and the tangent (doubling)
    paths are both evaluated and the result selected, as in the JAX
    package, by exact equality tests (`eq_exact`).  The plain version of
    K5."""
    X1, Y1, Z1, inf1 = p1
    X2, Y2, Z2, inf2 = p2
    mul, sub = fq.mont_mul, fq.sub_mod
    Z1Z1 = mul(Z1, Z1)
    Z2Z2 = mul(Z2, Z2)
    U1 = mul(X1, Z2Z2)
    U2 = mul(X2, Z1Z1)
    S1 = mul(mul(Y1, Z2), Z2Z2)
    S2 = mul(mul(Y2, Z1), Z1Z1)
    H = sub(U2, U1)
    HH = _dbl(H)
    I = mul(HH, HH)
    J = mul(H, I)
    rr = _dbl(sub(S2, S1))
    V = mul(U1, I)
    X3 = sub(sub(mul(rr, rr), J), _dbl(V))
    Y3 = sub(mul(rr, sub(V, X3)), _dbl(mul(S1, J)))
    Z3 = _dbl(mul(mul(Z1, Z2), H))

    same_x = eq_exact(U1, U2)
    same_y = eq_exact(S1, S2)
    dbl = point_double(p1)
    use_dbl = same_x & same_y & ~inf1 & ~inf2
    is_inf3 = (same_x & ~same_y & ~inf1 & ~inf2) | (inf1 & inf2)
    X3 = _sel(use_dbl, dbl[0], X3)
    Y3 = _sel(use_dbl, dbl[1], Y3)
    Z3 = _sel(use_dbl, dbl[2], Z3)
    X3 = _sel(inf1, X2, _sel(inf2, X1, X3))
    Y3 = _sel(inf1, Y2, _sel(inf2, Y1, Y3))
    Z3 = _sel(inf1, Z2, _sel(inf2, Z1, Z3))
    return (X3, Y3, Z3, is_inf3)


def point_add_exact(p1, p2):
    """K5's function on the host in exact integers: the formulas of
    `point_add` over the values mod q (Montgomery domain, R = 2^408) with
    exact equality tests; (X, Y, Z) as canonical limbs (35, m) on the
    host, flags (m,).  Rows with an infinite operand take the other
    operand as given, as `point_add` does.  With affine operands lifted to
    Z = one (`fq_check.jacobian`) it is K6's function.

    The referee where the relaxed arithmetic is inexact: its equality test
    (`fq_mont.is_zero_mod_q`, the JAX package's) steers by an f32 quotient
    estimate that cancels when a difference is negative with its top limb
    -1 over limbs near 2^12 (ROADMAP Queue 3), and then calls equal points
    unequal."""
    q = fq.Q381
    rinv = pow(fq.R_MONT, -1, q)

    def ints(c):
        return [fq.limbs_to_int(col) % q for col in c.cpu().numpy().T]

    def mul(a, b):
        return a * b * rinv % q

    cols1, cols2 = [ints(c) for c in p1[:3]], [ints(c) for c in p2[:3]]
    inf1, inf2 = p1[3].cpu().numpy(), p2[3].cpu().numpy()
    m = len(inf1)
    given = [[c.cpu().numpy().T for c in p[:3]] for p in (p1, p2)]
    out = [np.zeros((m, fq.NL), np.int32) for _ in range(3)]
    flags = np.zeros(m, bool)
    for i in range(m):
        if inf1[i] or inf2[i]:
            src = given[1] if inf1[i] else given[0]
            for k in range(3):
                out[k][i] = src[k][i]
            flags[i] = inf1[i] and inf2[i]
            continue
        (X1, Y1, Z1), (X2, Y2, Z2) = [[c[i] for c in cols] for cols in (cols1, cols2)]
        Z1Z1, Z2Z2 = mul(Z1, Z1), mul(Z2, Z2)
        U1, U2 = mul(X1, Z2Z2), mul(X2, Z1Z1)
        S1, S2 = mul(mul(Y1, Z2), Z2Z2), mul(mul(Y2, Z1), Z1Z1)
        if U1 == U2 and S1 == S2:  # dbl-2007-bl
            A, B = mul(X1, X1), mul(Y1, Y1)
            C = mul(B, B)
            D = 2 * (mul(X1 + B, X1 + B) - A - C)
            E = 3 * A
            X3 = mul(E, E) - 2 * D
            Y3 = mul(E, D - X3) - 8 * C
            Z3 = 2 * mul(Y1, Z1)
        else:
            H = U2 - U1
            I = mul(2 * H, 2 * H)
            J = mul(H, I)
            rr = 2 * (S2 - S1)
            V = mul(U1, I)
            X3 = mul(rr, rr) - J - 2 * V
            Y3 = mul(rr, V - X3) - 2 * mul(S1, J)
            Z3 = 2 * mul(mul(Z1, Z2), H)
        for k, v in enumerate((X3, Y3, Z3)):
            out[k][i] = fq.int_to_limbs([v % q])[0]
        flags[i] = U1 == U2 and S1 != S2
    return tuple(torch.from_numpy(np.ascontiguousarray(o.T)) for o in out) + (
        torch.from_numpy(flags),)


def point_add_aff(p1, p2):
    """Complete addition of two AFFINE points (implicit Z1 = Z2 = one) to
    a Jacobian result in 12 mont_muls: the merge tree's level-1 add, a
    transcription of the Pallas `_point_add_aff_kernel` and the plain
    version of K6.  Equal in VALUE to `point_add` with Z = one, not in
    limbs (it skips the by-one products)."""
    X1, Y1, inf1 = p1
    X2, Y2, inf2 = p2
    mul, add, sub = fq.mont_mul, fq.add_mod, fq.sub_mod
    H = sub(X2, X1)
    HH = _dbl(H)
    I = mul(HH, HH)
    J = mul(H, I)
    rr = _dbl(sub(Y2, Y1))
    V = mul(X1, I)
    X3 = sub(sub(mul(rr, rr), J), _dbl(V))
    Y3 = sub(mul(rr, sub(V, X3)), _dbl(mul(Y1, J)))
    Z3 = _dbl(H)

    # doubling path (dbl-2007-bl, Z1 = 1)
    A = mul(X1, X1)
    B = mul(Y1, Y1)
    C = mul(B, B)
    t = add(X1, B)
    t = mul(t, t)
    t = sub(sub(t, A), C)
    D = _dbl(t)
    E = add(_dbl(A), A)
    F = mul(E, E)
    Xd = sub(F, _dbl(D))
    Yd = sub(mul(E, sub(D, Xd)), _dbl(C, 3))
    Zd = _dbl(Y1)

    same_x = eq_exact(X1, X2)
    same_y = eq_exact(Y1, Y2)
    use_dbl = same_x & same_y & ~inf1 & ~inf2
    is_inf3 = (same_x & ~same_y & ~inf1 & ~inf2) | (inf1 & inf2)
    one = fq.consts(X1.device)["one"][:, None].expand(X1.shape)
    X3 = _sel(use_dbl, Xd, X3)
    Y3 = _sel(use_dbl, Yd, Y3)
    Z3 = _sel(use_dbl, Zd, Z3)
    X3 = _sel(inf1, X2, _sel(inf2, X1, X3))
    Y3 = _sel(inf1, Y2, _sel(inf2, Y1, Y3))
    Z3 = _sel(inf1, one, _sel(inf2, one, Z3))
    return (X3, Y3, Z3, is_inf3)


# --------------------------------------------------------------------------
# wrappers of the CUDA kernels
# --------------------------------------------------------------------------


def _check(name: str, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous")


def _check_points(name: str, coords, flags, m: int, device):
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for c in coords:
        _check(name, c, (fq.NL, m), torch.int32, device)
    for f in flags:
        _check(name, f, (m,), torch.bool, device)


def _launch(name: str, *args):
    """Run one C launcher through `_build.launch` on the first tensor's
    device."""
    _build.launch(name, args[0].device, *(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                          for a in args))


def _is_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def mont_mul_cuda(a, b, depth: int = 1):
    """x = mont_mul(a, b), then depth - 1 more x <- mont_mul(x, b), on
    (35, m) int32: K4 on CUDA tensors, the plain version on CPU tensors.
    K4 takes relaxed limbs of value |v| < 2^23 q (its entry's bound) and
    returns the canonical limbs of the plain version's value mod q."""
    if depth < 1:
        raise ValueError(f"mont_mul_cuda: depth must be >= 1, got {depth}")
    if _is_cpu(a, b):
        return mont_mul_cuda.plain(a, b, depth)
    if a.dim() != 2:
        raise ValueError(f"mont_mul_cuda: want (35, m), got {tuple(a.shape)}")
    m = a.shape[1]
    _check_points("mont_mul_cuda", (a, b), (), m, a.device)
    out = torch.empty_like(a)
    if m:
        _launch("mont_mul_launch", a, b, out, m, depth)
        mont_mul_cuda.launches += 1
    return out


mont_mul_cuda.launches = 0
mont_mul_cuda.plain = fq.mont_mul_chain


def point_add_cuda(p1, p2):
    """Complete Jacobian add of p1 = (X, Y, Z, inf) and p2: K5 on CUDA
    tensors, the plain version on CPU tensors.  K5's X, Y, Z are congruent
    mod q to the plain version's, canonical where no operand is infinite
    (else the other operand as given), and its flags are equal."""
    if _is_cpu(*p1, *p2):
        return point_add_cuda.plain(p1, p2)
    if p1[0].dim() != 2:
        raise ValueError(f"point_add_cuda: want (35, m), got {tuple(p1[0].shape)}")
    m = p1[0].shape[1]
    _check_points("point_add_cuda", p1[:3] + p2[:3], (p1[3], p2[3]), m, p1[0].device)
    out = tuple(torch.empty_like(p1[0]) for _ in range(3)) + (torch.empty_like(p1[3]),)
    if m:
        _launch("point_add_launch", *p1, *p2, *out, m)
        point_add_cuda.launches += 1
    return out


point_add_cuda.launches = 0
point_add_cuda.plain = point_add


def point_add_aff_cuda(p1, p2):
    """Affine + affine -> Jacobian, p = (X, Y, inf): K6 on CUDA tensors,
    the plain version on CPU tensors.  K6's X, Y, Z are congruent mod q to
    the plain version's, canonical where no operand is infinite (else the
    other operand's X, Y as given and Z the canonical limbs of one), and
    its flags are equal."""
    if _is_cpu(*p1, *p2):
        return point_add_aff_cuda.plain(p1, p2)
    if p1[0].dim() != 2:
        raise ValueError(
            f"point_add_aff_cuda: want (35, m), got {tuple(p1[0].shape)}"
        )
    m = p1[0].shape[1]
    _check_points("point_add_aff_cuda", p1[:2] + p2[:2], (p1[2], p2[2]), m,
                  p1[0].device)
    out = tuple(torch.empty_like(p1[0]) for _ in range(3)) + (torch.empty_like(p1[2]),)
    if m:
        _launch("point_add_aff_launch", *p1, *p2, *out, m)
        point_add_aff_cuda.launches += 1
    return out


point_add_aff_cuda.launches = 0
point_add_aff_cuda.plain = point_add_aff
