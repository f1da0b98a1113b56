"""R1CS -> QAP reduction (libsnark/arkworks style).

Mirrors ark-groth16's `LibsnarkReduction` semantics, which is what the
reference's `Groth16::<Bls12_381>` uses under the hood
(`falcon-r1cs/examples/pok_sig.rs:30-37`):

- evaluation domain of size next_pow2(num_constraints + num_instance);
- wire polynomials u_i/v_i/w_i are interpolations of the A/B/C matrix
  columns over the first `num_constraints` domain points;
- *instance augmentation*: u_j picks up an extra 1 at domain point
  (num_constraints + j) for each instance wire j, which makes the public
  wire polynomials linearly independent (soundness requirement).

Inputs are our `CompiledR1CS` COO artifacts (r1cs/coo.py) whose values are
the signed-integer view — reduced mod R here.
"""

from __future__ import annotations

from .bls12_381 import R
from .fr import Domain


def qap_domain(compiled) -> Domain:
    return Domain(compiled.num_constraints + compiled.num_instance)


def matrices_at_tau(compiled, tau: int):
    """([u_i(tau)], [v_i(tau)], [w_i(tau)]) for all wires, plus Z(tau).

    Used by Groth16 setup: u_i(tau) = sum_j A[j, i] * L_j(tau).
    """
    dom = qap_domain(compiled)
    lag = dom.lagrange_coeffs_at(tau)
    nv = compiled.num_variables
    nc = compiled.num_constraints
    u = [0] * nv
    v = [0] * nv
    w = [0] * nv
    for acc, mat in ((u, compiled.a), (v, compiled.b), (w, compiled.c)):
        rows, cols, vals = mat
        for j, i, val in zip(rows, cols, vals):
            acc[i] = (acc[i] + int(val) * lag[j]) % R
    # instance augmentation rows
    for j in range(compiled.num_instance):
        u[j] = (u[j] + lag[nc + j]) % R
    z_tau = (pow(tau, dom.size, R) - 1) % R
    return u, v, w, z_tau, dom


def evaluate_on_domain(compiled, assignment):
    """(za, zb, zc): evaluations of a(X), b(X), c(X) over the full domain.

    `assignment` is the full wire vector (instance ++ witness) as ints.
    za[j] = <A_j, z> for constraint rows, and the augmentation rows carry
    the instance values (za[nc + j] = z_j, zb = zc = 0 there).
    """
    dom = qap_domain(compiled)
    nc = compiled.num_constraints
    z = [int(x) % R for x in assignment]
    out = []
    for mat in (compiled.a, compiled.b, compiled.c):
        rows, cols, vals = mat
        acc = [0] * dom.size
        for j, i, val in zip(rows, cols, vals):
            acc[j] = (acc[j] + int(val) * z[i]) % R
        out.append(acc)
    za, zb, zc = out
    for j in range(compiled.num_instance):
        za[nc + j] = z[j]
    return za, zb, zc, dom


def witness_map(compiled, assignment):
    """Coefficients of h(X) = (a b - c)/Z — the H-query scalars for prove.

    Computed on a multiplicative coset (Z is the constant g^n - 1 there, so
    the division is a single scalar inversion).
    """
    za, zb, zc, dom = evaluate_on_domain(compiled, assignment)
    g = 5  # Fr multiplicative generator; not in any 2-power subgroup
    ca = dom.coset_fft(dom.ifft(za), g)
    cb = dom.coset_fft(dom.ifft(zb), g)
    cc = dom.coset_fft(dom.ifft(zc), g)
    zinv = pow(dom.vanishing_on_coset(g), -1, R)
    h_evals = [(a * b - c) % R * zinv % R for a, b, c in zip(ca, cb, cc)]
    h = dom.coset_ifft(h_evals, g)
    # deg(h) <= n - 2: the top coefficient must vanish for a satisfied system
    return h[: dom.size - 1], h[dom.size - 1]
