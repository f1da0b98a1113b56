"""Groth16 zkSNARK over BLS12-381: setup / prove / verify.

The reference's end-to-end flow
(`falcon-r1cs/examples/pok_sig.rs:30-47`):

    let param = generate_random_parameters::<Bls12_381,_,_>(cs, &mut rng);
    let proof = create_random_proof(cs, &param, &mut rng);
    assert!(verify_proof(&pvk, &proof, &public_inputs));

This module is the from-scratch equivalent over our CompiledR1CS
artifacts.  [Groth16]:

    CRS (toxic alpha, beta, gamma, delta, tau):
      pk: [alpha]1 [beta]1 [delta]1, {[u_i(t)]1}, {[v_i(t)]1}, {[v_i(t)]2},
          {[(beta u_i + alpha v_i + w_i)/delta]1 : i witness},
          {[t^i Z(t)/delta]1 : i < n-1}, [beta]2 [delta]2
      vk: [alpha]1 [beta]2 [gamma]2 [delta]2,
          {[(beta u_i + alpha v_i + w_i)/gamma]1 : i instance}
    Prove (random r, s; wires z):
      A = [alpha + sum z_i u_i(t) + r delta]1
      B = [beta  + sum z_i v_i(t) + s delta]2   (and its G1 twin)
      C = [(sum_wit z_i (beta u_i + alpha v_i + w_i) + h(t)Z(t))/delta]1
          + s A + r B1 - r s [delta]1
    Verify:
      e(A, B) == e([alpha]1, [beta]2) * e(sum_inst z_i ic_i, [gamma]2)
                 * e(C, [delta]2)

Host path is pure Python (correctness oracle); the MSM/FFT hot loops
dispatch to native/groth16_native.c when available (set
use_native=False to force the reference path).  On a CUDA msm_device
(the default) the witness map and the four G1 MSMs of a proof run on the
card (gpu_qap.py, gpu_msm.py: g1_backend "gpu", which "auto" resolves
to there); the G2 MSM stays on the host.

The port's copy of `falcon_r1cs_tpu/snark/groth16.py`; the changes are
the prover hook, where the backend "gpu" takes the place of "tpu", and
the policy behind "auto" (backend_policy.py), which follows msm_device.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import msm, native_backend
from .bls12_381 import (
    f12_conj,
    pairing,
    R,
    G1_GEN,
    G2_GEN,
    g1_add,
    g1_from_affine,
    g1_mul,
    g1_neg,
    g1_to_affine,
    g2_add,
    g2_from_affine,
    g2_mul,
    g2_to_affine,
    multi_pairing,
    FQ12_ONE,
)
from .points import G1Array, G2Array
from .qap import matrices_at_tau, witness_map


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: G1Array  # [(beta u_i + alpha v_i + w_i)/gamma]_1 per instance wire


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: G1Array     # [u_i(t)]_1, all wires
    b_g1_query: G1Array  # [v_i(t)]_1
    b_g2_query: G2Array  # [v_i(t)]_2
    h_query: G1Array     # [t^i Z(t)/delta]_1, i < domain_size - 1
    l_query: G1Array     # [(beta u_i + alpha v_i + w_i)/delta]_1, witness


@dataclass
class Proof:
    a: tuple  # G1 affine
    b: tuple  # G2 affine
    c: tuple  # G1 affine


class SetupToxic:
    """Trapdoor sample (kept only for deterministic tests)."""

    def __init__(self, tau, alpha, beta, gamma, delta):
        self.tau, self.alpha, self.beta = tau, alpha, beta
        self.gamma, self.delta = gamma, delta

    @classmethod
    def random(cls, rng=None):
        draw = (lambda: rng.integers(1, R)) if rng is not None else (
            lambda: 1 + secrets.randbelow(R - 1)
        )
        return cls(*(int(draw()) for _ in range(5)))


def setup(compiled, toxic: SetupToxic | None = None, use_native: bool = True,
          progress=None) -> ProvingKey:
    """Circuit-specific CRS generation (the reference's
    `generate_random_parameters`, pok_sig.rs:30-32)."""
    tox = toxic or SetupToxic.random()
    tau, alpha, beta = tox.tau, tox.alpha, tox.beta
    gamma, delta = tox.gamma, tox.delta
    u, v, w, z_tau, dom = matrices_at_tau(compiled, tau)
    ni = compiled.num_instance
    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)

    ic_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R
        for i in range(ni)
    ]
    l_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R
        for i in range(ni, compiled.num_variables)
    ]
    # h basis: t^i * Z(t) / delta
    zd = z_tau * delta_inv % R
    h_scalars = [0] * (dom.size - 1)
    cur = zd
    for i in range(dom.size - 1):
        h_scalars[i] = cur
        cur = cur * tau % R

    native = _native() if use_native else None
    if native is not None:
        fb1 = native.g1_fixed_base_batch
        fb2 = native.g2_fixed_base_batch
        a_query = fb1(u)
        b_g1_query = fb1(v)
        b_g2_query = fb2(v)
        h_query = fb1(h_scalars)
        l_query = fb1(l_scalars)
        ic = fb1(ic_scalars)
    else:
        t1 = msm.g1_fixed_base(G1_GEN)
        t2 = msm.g2_fixed_base(G2_GEN)

        def fb1(scalars):
            return G1Array.from_affine_list(
                msm.g1_normalize_batch(t1.mul_batch(scalars))
            )

        def fb2(scalars):
            return G2Array.from_affine_list(
                msm.g2_normalize_batch(t2.mul_batch(scalars))
            )

        a_query = fb1(u)
        b_g1_query = fb1(v)
        b_g2_query = fb2(v)
        h_query = fb1(h_scalars)
        l_query = fb1(l_scalars)
        ic = fb1(ic_scalars)

    vk = VerifyingKey(
        alpha_g1=g1_to_affine(g1_mul(g1_from_affine(G1_GEN), alpha)),
        beta_g2=g2_to_affine(g2_mul(g2_from_affine(G2_GEN), beta)),
        gamma_g2=g2_to_affine(g2_mul(g2_from_affine(G2_GEN), gamma)),
        delta_g2=g2_to_affine(g2_mul(g2_from_affine(G2_GEN), delta)),
        ic=ic,
    )
    return ProvingKey(
        vk=vk,
        beta_g1=g1_to_affine(g1_mul(g1_from_affine(G1_GEN), beta)),
        delta_g1=g1_to_affine(g1_mul(g1_from_affine(G1_GEN), delta)),
        a_query=a_query,
        b_g1_query=b_g1_query,
        b_g2_query=b_g2_query,
        h_query=h_query,
        l_query=l_query,
    )


def prove(pk: ProvingKey, compiled, assignment, r: int | None = None,
          s: int | None = None, use_native: bool = True,
          g1_backend: str = "auto", msm_device="cuda") -> Proof:
    """Create a proof for one full wire assignment (instance ++ witness).

    Mirrors `create_random_proof` (pok_sig.rs:37).  r/s override the
    blinding randomness for deterministic tests.  g1_backend selects who
    runs the witness map and the G1 MSMs (`resolve_g1_backend`): "auto"
    follows `msm_device`, the card on a CUDA device ("gpu") and the host
    on the CPU ("native" when the C is built, else "python"); or pass
    "native"/"gpu"/"python" explicitly ("gpu" = snark/gpu_msm.py on
    `msm_device`, and on a CUDA `msm_device` the witness map there too,
    snark/gpu_qap.py; "native" and "python" never look at `msm_device`).
    A CUDA `msm_device` without a card raises DeviceUnavailableError
    wherever the backend is "gpu".  The G2 MSM follows use_native.
    """
    if r is None:
        r = secrets.randbelow(R)
    if s is None:
        s = secrets.randbelow(R)
    native = _native() if use_native else None
    g1_backend = resolve_g1_backend(g1_backend, msm_device, use_native)

    # assignment may be a (N, 4) u64 canonical limb matrix (e.g. derived
    # from the device packer via points.packed_to_limb_rows): the native
    # path then runs with ZERO Python bigint conversions.
    import numpy as _np

    z_is_limbs = isinstance(assignment, _np.ndarray) and assignment.ndim == 2
    if z_is_limbs and (native is None or g1_backend == "python"):
        from .points import limbs_to_int

        assignment = [limbs_to_int(row) for row in assignment]
        z_is_limbs = False
    if z_is_limbs:
        z = _np.ascontiguousarray(assignment, dtype=_np.uint64)
    else:
        z = [int(x) % R for x in assignment]
    assert len(z) == compiled.num_variables
    ni = compiled.num_instance
    on_card = False
    if g1_backend == "gpu":
        import torch

        on_card = torch.device(msm_device).type == "cuda"
    if on_card:
        # the witness map on the card beside the G1 MSMs: h stays there
        from .gpu_qap import witness_map_gpu

        h, h_top = witness_map_gpu(compiled, z, msm_device)
    else:
        # on a CPU msm_device the host C (or qap.witness_map) gives the h
        # that gpu_qap's plain versions would, in far less time
        h, h_top = witness_map_dispatch(compiled, z, native)
    assert h_top == 0, "assignment does not satisfy the R1CS"
    if g1_backend == "python" and isinstance(h, _np.ndarray):
        # the host C's h comes as u64 limb rows; the Python MSM takes ints
        from .points import limbs_to_int

        h = [limbs_to_int(row) for row in h]

    if native is not None:
        g1msm, g2msm = native.g1_msm, native.g2_msm
    else:
        g1msm = g2msm = None
    if g1msm is None or g1_backend == "python":
        def g1msm(points, scalars):
            pts, sc = _strip(points.to_affine_list(), scalars)
            return g1_to_affine(msm.g1_msm([g1_from_affine(p) for p in pts], sc))
    if g2msm is None:
        def g2msm(points, scalars):
            pts, sc = _strip(points.to_affine_list(), scalars)
            return g2_to_affine(msm.g2_msm([g2_from_affine(p) for p in pts], sc))
    if g1_backend == "gpu":
        from . import gpu_msm

        def g1msm(points, scalars):
            return gpu_msm.g1_msm_gpu(points, scalars, device=msm_device)

    if native is not None and g1_backend not in ("gpu", "python"):
        # one scalar->limb conversion shared by the A/B1/B2/L MSMs (the
        # native wrappers fast-path (n,4) u64 arrays; h is already limbs)
        from .points import ints_to_limbs

        z_sc = z if z_is_limbs else ints_to_limbs(z, 4)
        zl_sc = z_sc[ni:]
    else:
        z_sc, zl_sc = z, z[ni:]
    ga = g1msm(pk.a_query, z_sc)
    gb1 = g1msm(pk.b_g1_query, z_sc)
    gb2 = g2msm(pk.b_g2_query, z_sc)
    gc_l = g1msm(pk.l_query, zl_sc)
    gc_h = g1msm(pk.h_query, h)

    return _assemble(pk, native, ga, gb1, gb2, gc_l, gc_h, r, s)


def resolve_g1_backend(g1_backend: str = "auto", msm_device="cuda",
                       use_native: bool = True) -> str:
    """The G1 backend that prove and prove_batch run for these arguments:
    "auto" resolved by backend_policy.choose_g1_backend for msm_device,
    any other as given.  Where it is "gpu", a CUDA msm_device is checked
    for a card (utils.device.entry_device raises DeviceUnavailableError
    without one) before any work."""
    if g1_backend == "auto":
        from .backend_policy import choose_g1_backend

        native_built = use_native and _native() is not None
        return choose_g1_backend(native_built, msm_device)
    if g1_backend == "gpu":
        from ..utils.device import entry_device

        entry_device(msm_device)
    return g1_backend


def _assemble(pk: ProvingKey, native, ga, gb1, gb2, gc_l, gc_h, r: int,
              s: int) -> Proof:
    """Final proof assembly from the five MSM results (shared by prove
    and prove_batch)."""
    delta1 = g1_from_affine(pk.delta_g1)

    # the handful of single-point scalar muls in the final assembly are
    # ~10 ms each through the pure-Python ladder; route them through the
    # native MSM (n=1) when it is available — one cheap affine
    # conversion each, identical results
    if native is not None:
        def g1_mul_fast(jac, k):
            aff = g1_to_affine(jac)
            from .points import G1Array

            got = native.g1_msm(G1Array.from_affine_list([aff]), [k % R])
            return _jac(got)

        def g2_mul_fast(jac, k):
            aff = g2_to_affine(jac)
            from .points import G2Array

            got = native.g2_msm(G2Array.from_affine_list([aff]), [k % R])
            return _jac2(got)
    else:
        g1_mul_fast, g2_mul_fast = g1_mul, g2_mul

    # A = alpha + <z, u> + r*delta
    a_jac = g1_add(
        g1_add(g1_from_affine(pk.vk.alpha_g1), _jac(ga)),
        g1_mul_fast(delta1, r),
    )
    # B (G2) = beta + <z, v> + s*delta ; B1 is its G1 twin
    b_jac = g2_add(
        g2_add(g2_from_affine(pk.vk.beta_g2), _jac2(gb2)),
        g2_mul_fast(g2_from_affine(pk.vk.delta_g2), s),
    )
    b1_jac = g1_add(
        g1_add(g1_from_affine(pk.beta_g1), _jac(gb1)),
        g1_mul_fast(delta1, s),
    )
    # C = (l + h) + s*A + r*B1 - r*s*delta
    c_jac = g1_add(_jac(gc_l), _jac(gc_h))
    c_jac = g1_add(c_jac, g1_mul_fast(a_jac, s))
    c_jac = g1_add(c_jac, g1_mul_fast(b1_jac, r))
    c_jac = g1_add(c_jac, g1_neg(g1_mul_fast(delta1, r * s % R)))
    return Proof(
        a=g1_to_affine(a_jac), b=g2_to_affine(b_jac), c=g1_to_affine(c_jac)
    )


def prove_batch(pk: ProvingKey, compiled, assignments, rs=None, ss=None,
                use_native: bool = True, g1_backend: str = "auto",
                msm_device="cuda") -> list:
    """K proofs over ONE proving key — the falcon-aggregate-sig batch
    shape (`falcon-aggregate-sig/src/main.rs:1-3` is the
    reference's stub for exactly this intent; the witness side is
    pipeline.py, this is the proof side).

    All K proofs share the same CRS point arrays, so the five MSMs per
    proof become five BATCHED MSMs with (K, n) scalar matrices: one
    Montgomery point conversion, one digit-recode buffer, and a
    K x window x chunk OpenMP task grid amortized over the batch
    (native/groth16_native.c g1_msm_multi_pre / g2_msm_multi).

    assignments: list of K wire vectors (each an int sequence or an
    (N, 4) u64 canonical limb matrix).  rs/ss override blinding
    randomness for deterministic tests.  g1_backend is prove's, resolved
    as there (`resolve_g1_backend`): "native" with the C built (what
    "auto" gives on a CPU msm_device) runs the batched multi-MSMs; any
    other backend, or no C, proves each assignment with `prove` ("gpu",
    what "auto" gives on a CUDA msm_device: the witness map and the G1
    MSMs of each proof on the card, as the JAX package's device backend
    proves one assignment at a time).  Returns a list of K Proofs.
    """
    import numpy as _np

    K = len(assignments)
    native = _native() if use_native else None
    g1_backend = resolve_g1_backend(g1_backend, msm_device, use_native)
    if rs is None:
        rs = [secrets.randbelow(R) for _ in range(K)]
    if ss is None:
        ss = [secrets.randbelow(R) for _ in range(K)]
    if native is None or g1_backend != "native":
        return [
            prove(pk, compiled, a, r=rs[k], s=ss[k], use_native=use_native,
                  g1_backend=g1_backend, msm_device=msm_device)
            for k, a in enumerate(assignments)
        ]

    from .points import ints_to_limbs

    ni = compiled.num_instance
    z_rows = []
    for a in assignments:
        if isinstance(a, _np.ndarray) and a.ndim == 2:
            z_rows.append(_np.ascontiguousarray(a, dtype=_np.uint64))
        else:
            z_rows.append(ints_to_limbs([int(x) % R for x in a], 4))
        assert len(z_rows[-1]) == compiled.num_variables
    # witness maps (each call is OpenMP-parallel inside; h differs per k)
    hs = []
    for z in z_rows:
        h, h_top = native.witness_map(compiled, z)
        assert h_top == 0, "assignment does not satisfy the R1CS"
        hs.append(h)
    z_sc = _np.ascontiguousarray(_np.stack(z_rows))
    zl_sc = _np.ascontiguousarray(z_sc[:, ni:])
    h_sc = _np.ascontiguousarray(_np.stack(hs))

    gas = native.g1_msm_multi(pk.a_query, z_sc)
    gb1s = native.g1_msm_multi(pk.b_g1_query, z_sc)
    gb2s = native.g2_msm_multi(pk.b_g2_query, z_sc)
    gc_ls = native.g1_msm_multi(pk.l_query, zl_sc)
    gc_hs = native.g1_msm_multi(pk.h_query, h_sc)

    return [
        _assemble(pk, native, gas[k], gb1s[k], gb2s[k], gc_ls[k], gc_hs[k],
                  rs[k], ss[k])
        for k in range(K)
    ]


def verify(vk: VerifyingKey, instance, proof: Proof) -> bool:
    """Pairing check (the reference's `verify_proof`, pok_sig.rs:45-47).

    `instance` is the instance wire vector INCLUDING the leading constant
    one (matching our CompiledR1CS layout, col 0 = one wire).
    """
    inst = [int(x) % R for x in instance]
    if len(inst) != len(vk.ic) or inst[0] != 1:
        return False
    acc_aff = None
    if native_backend.available():
        acc_aff = native_backend.g1_msm(vk.ic, inst)
    if acc_aff is None:
        acc = None
        for x, pt in zip(inst, vk.ic):
            if pt is None or x == 0:
                continue
            acc = g1_add(acc, g1_mul(g1_from_affine(pt), x))
        acc_aff = g1_to_affine(acc)
    neg_a = g1_to_affine(g1_neg(g1_from_affine(proof.a)))
    # e(-A,B) e(alpha,beta) e(acc,gamma) e(C,delta) = 1, with e(alpha,beta)
    # hoisted out: pairing values are unitary (x^(q^6) = x^-1 in the
    # cyclotomic subgroup since q^6 = -1 mod q^4-q^2+1), so the cached
    # inverse is one f12_conj instead of an f12_inv.
    e_ab_inv = getattr(vk, "_e_ab_inv", None)
    if e_ab_inv is None:
        e_ab_inv = f12_conj(pairing(vk.alpha_g1, vk.beta_g2))
        object.__setattr__(vk, "_e_ab_inv", e_ab_inv)
    result = multi_pairing(
        [
            (neg_a, proof.b),
            (acc_aff, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )
    return result == e_ab_inv


# --- helpers --------------------------------------------------------------


def witness_map_dispatch(compiled, z, native):
    if native is not None:
        return native.witness_map(compiled, z)
    return witness_map(compiled, z)


def _strip(points, scalars):
    pts, sc = [], []
    for p, s in zip(points, scalars):
        if p is None or s % R == 0:
            continue
        pts.append(p)
        sc.append(s % R)
    return pts, sc


def _jac(aff):
    return None if aff is None else g1_from_affine(aff)


def _jac2(aff):
    return None if aff is None else g2_from_affine(aff)


def _native():
    """The C backend (native/groth16_native.c) or None if unavailable."""
    try:
        from . import native_backend

        return native_backend if native_backend.available() else None
    except ImportError:
        return None


# --- CRS serialization ----------------------------------------------------


def save_pk(pk: ProvingKey, path) -> None:
    """Persist a proving key (CRS) as an npz artifact (no pickle)."""
    import numpy as np

    from .points import ints_to_limbs

    def g1_one(pt):
        return ints_to_limbs([pt[0], pt[1]], 6)

    def g2_one(pt):
        (x0, x1), (y0, y1) = pt
        return ints_to_limbs([x0, x1, y0, y1], 6)

    data = {
        "alpha_g1": g1_one(pk.vk.alpha_g1),
        "beta_g2": g2_one(pk.vk.beta_g2),
        "gamma_g2": g2_one(pk.vk.gamma_g2),
        "delta_g2": g2_one(pk.vk.delta_g2),
        "beta_g1": g1_one(pk.beta_g1),
        "delta_g1": g1_one(pk.delta_g1),
    }
    for name in ("ic", "a_query", "b_g1_query", "b_g2_query", "h_query",
                 "l_query"):
        arr = pk.vk.ic if name == "ic" else getattr(pk, name)
        data[f"{name}_xs"] = arr.xs
        data[f"{name}_ys"] = arr.ys
        data[f"{name}_inf"] = arr.inf
    np.savez_compressed(path, **data)


def load_pk(path) -> ProvingKey:
    import numpy as np

    from .points import limbs_to_int

    def g1_one(a):
        return (limbs_to_int(a[0]), limbs_to_int(a[1]))

    def g2_one(a):
        return (
            (limbs_to_int(a[0]), limbs_to_int(a[1])),
            (limbs_to_int(a[2]), limbs_to_int(a[3])),
        )

    with np.load(path) as z:
        arrays = {}
        for name, cls in (
            ("ic", G1Array), ("a_query", G1Array), ("b_g1_query", G1Array),
            ("b_g2_query", G2Array), ("h_query", G1Array),
            ("l_query", G1Array),
        ):
            arrays[name] = cls(
                z[f"{name}_xs"], z[f"{name}_ys"], z[f"{name}_inf"]
            )
        vk = VerifyingKey(
            alpha_g1=g1_one(z["alpha_g1"]),
            beta_g2=g2_one(z["beta_g2"]),
            gamma_g2=g2_one(z["gamma_g2"]),
            delta_g2=g2_one(z["delta_g2"]),
            ic=arrays["ic"],
        )
        return ProvingKey(
            vk=vk,
            beta_g1=g1_one(z["beta_g1"]),
            delta_g1=g1_one(z["delta_g1"]),
            a_query=arrays["a_query"],
            b_g1_query=arrays["b_g1_query"],
            b_g2_query=arrays["b_g2_query"],
            h_query=arrays["h_query"],
            l_query=arrays["l_query"],
        )
