"""Falcon verification circuit via dense negacyclic vector-matrix product.

Re-derivation of `falcon-r1cs/src/circuits/falcon_schoolbook.rs`:
no NTT; each output coefficient is an n-term inner product against a slice of
the reversed [-pk || pk] buffer (negacyclic structure, `:101-110`), compared
to v (or v + q) with a pair of is_eq's.  The signature range check is
intentionally skipped with a documented soundness argument
(`falcon_schoolbook.rs:49-56`; SURVEY.md Appendix A item 6).

Golden counts (`falcon-r1cs/README.md:45,56`):
  n=512 : 1025 / 312,882 / 315,956
  n=1024: 2049 / 1,150,004 / 1,156,150
"""

from __future__ import annotations

from dataclasses import dataclass

from ..falcon import VerificationInstance, hash_to_point
from ..gadgets import (
    enforce_less_than_norm_bound,
    enforce_less_than_q,
    inner_product_mod,
    l2_norm_var,
)
from ..params import FalconParams, Q
from ..r1cs import Boolean, ConstraintSystem, FpVar


@dataclass
class FalconSchoolBookVerificationCircuit:
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

        sig_poly = inst.sig_lifted
        pk_poly = inst.h

        const_q_var = FpVar.constant(cs, Q)

        # ---- clear data (`falcon_schoolbook.rs:32-39`) --------------------
        hm = hash_to_point(inst.msg, inst.nonce, n)
        v = inst.v_lifted

        # ---- allocation (`falcon_schoolbook.rs:41-92`) --------------------
        # signature: witnesses, range check intentionally omitted (:49-56)
        sig_vars = [FpVar.new_witness(cs, int(e)) for e in sig_poly]

        # pk: public inputs; build neg_pk = q - pk as free LCs (:60-74)
        pk_vars: list[FpVar] = []
        neg_pk_vars: list[FpVar] = []
        for e in pk_poly:
            tmp = FpVar.new_input(cs, int(e))
            neg_pk_vars.append(const_q_var - tmp)
            pk_vars.append(tmp)

        # hash of message: public inputs (:76-82)
        hm_vars = [FpVar.new_input(cs, int(e)) for e in hm]

        # v: witnesses with range proof (:84-92)
        v_pos_vars = []
        for e in v:
            tmp = FpVar.new_witness(cs, int(e))
            enforce_less_than_q(cs, tmp)
            v_pos_vars.append(tmp)

        # ---- prove v = hm - sig*pk mod q (`falcon_schoolbook.rs:94-121`) --
        # buffer = reversed([-pk[0..n] || pk[0..n]]); column i of the
        # negacyclic matrix is buffer[n-1-i .. 2n-1-i]
        buf_vars = list(reversed(neg_pk_vars + pk_vars))

        for i in range(n):
            current_col = inner_product_mod(
                cs, sig_vars, buf_vars[n - 1 - i : 2 * n - 1 - i], const_q_var
            )
            # rhs = hm + q - sig*pk[i] mod q; equals v or v + q
            rhs = hm_vars[i] + const_q_var - current_col
            (
                rhs.is_eq(v_pos_vars[i])
                .or_(rhs.is_eq(v_pos_vars[i] + const_q_var))
                .enforce_equal(Boolean.TRUE(cs))
            )

        # ---- norm bound (`falcon_schoolbook.rs:123-131`) ------------------
        norm = l2_norm_var(cs, v_pos_vars + sig_vars, const_q_var)
        enforce_less_than_norm_bound(cs, norm, params)
