"""Falcon verification circuit with signed coefficients split as (pos, neg).

Re-derivation of `falcon-r1cs/src/circuits/falcon_dual_ntt.rs`:
same statement as the NTT circuit, but sig and v are allocated as
DualPolynomial (pos, neg) pairs -- avoiding per-coefficient range proofs on v
entirely (SURVEY.md Appendix A item 7 records the attendant unenforced
range assumption, reproduced as-is) -- and the pointwise congruence is
checked two-sided with two mod_q per coefficient:

    hm[i] + v_neg[i] + sig_neg[i]*pk[i]  ==  v_pos[i] + sig_pos[i]*pk[i]  (mod q)

Golden counts (ours; the reference prints these via
`falcon-r1cs/examples/constraint_counts.rs:115-138` but never
published them): n=512: 1025 / 95,286 / 96,828.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..falcon import DualPolynomial, Polynomial, VerificationInstance, hash_to_point, ntt
from ..gadgets import (
    DualNTTPolyVar,
    DualPolyVar,
    NTTPolyVar,
    enforce_less_than_norm_bound,
    l2_norm_var_without_range_check,
    mod_q,
    ntt_param_var,
)
from ..params import FalconParams
from ..r1cs import ConstraintSystem
from .falcon_ntt import const_q_power_vars


@dataclass
class FalconDualNTTVerificationCircuit:
    instance: VerificationInstance

    @classmethod
    def build_circuit(cls, instance: VerificationInstance):
        return cls(instance)

    @property
    def params(self) -> FalconParams:
        return self.instance.params

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        inst = self.instance
        params = self.params
        n = params.n

        # DualPolynomial::from(&sig): signed split (`falcon_dual_ntt.rs:27`)
        sig_dual = DualPolynomial.from_signed(inst.sig_signed)

        const_vars = const_q_power_vars(cs, params)
        param_vars = ntt_param_var(cs, params)

        # ---- clear data (`falcon_dual_ntt.rs:41-53`) ----------------------
        hm = hash_to_point(inst.msg, inst.nonce, n)
        hm_ntt = ntt(hm)
        v_dual = DualPolynomial.from_polynomial(Polynomial(inst.v_lifted))
        pk_ntt = ntt(inst.h)

        # ---- allocate (`falcon_dual_ntt.rs:55-73`) ------------------------
        sig_vars = DualPolyVar.alloc_vars(cs, sig_dual, "witness")
        pk_ntt_vars = NTTPolyVar.alloc_vars(cs, pk_ntt, "input")
        hm_ntt_vars = NTTPolyVar.alloc_vars(cs, hm_ntt, "input")
        v_vars = DualPolyVar.alloc_vars(cs, v_dual, "witness")

        # ---- two-sided pointwise congruence (`falcon_dual_ntt.rs:75-116`) -
        sig_ntt_vars = DualNTTPolyVar.ntt_circuit(
            cs, sig_vars, const_vars, param_vars, params
        )
        v_ntt_vars = DualNTTPolyVar.ntt_circuit(
            cs, v_vars, const_vars, param_vars, params
        )

        for i in range(n):
            left = mod_q(
                cs,
                hm_ntt_vars.coeff()[i]
                + v_ntt_vars.neg.coeff()[i]
                + sig_ntt_vars.neg.coeff()[i] * pk_ntt_vars.coeff()[i],
                const_vars[0],
            )
            right = mod_q(
                cs,
                v_ntt_vars.pos.coeff()[i]
                + sig_ntt_vars.pos.coeff()[i] * pk_ntt_vars.coeff()[i],
                const_vars[0],
            )
            left.enforce_equal(right)

        # ---- norm over 4N pos/neg coeffs (`falcon_dual_ntt.rs:118-131`) ---
        norm = l2_norm_var_without_range_check(
            v_vars.pos.coeff()
            + v_vars.neg.coeff()
            + sig_vars.pos.coeff()
            + sig_vars.neg.coeff()
        )
        enforce_less_than_norm_bound(cs, norm, params)
