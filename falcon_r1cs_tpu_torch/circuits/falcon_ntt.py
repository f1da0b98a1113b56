"""Falcon verification circuit via two in-circuit NTTs.

Re-derivation of `falcon-r1cs/src/circuits/falcon_ntt.rs`:
proves, for public (pk_ntt, hm_ntt) and private (sig, v):

    hm = v + sig * pk   (mod q, mod x^n + 1)      [checked in NTT domain]
    ||(sig | v)||_2^2 < beta^2

Golden counts (`falcon-r1cs/README.md:44,55`):
  n=512 : 1025 instance / 78,386 witness / 81,460 constraints
  n=1024: 2049 instance / 156,724 witness / 162,870 constraints
Public-input order is pk_ntt coefficients then hm_ntt coefficients
(`falcon_ntt.rs:63-67`, consumed in that order by
`falcon-r1cs/examples/pok_sig.rs:38-44`) -- part of the
contract (SURVEY.md Appendix A item 12).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..falcon import VerificationInstance, hash_to_point, ntt
from ..gadgets import (
    NTTPolyVar,
    PolyVar,
    add_mod,
    enforce_less_than_norm_bound,
    enforce_less_than_q,
    l2_norm_var,
    ntt_param_var,
)
from ..params import FalconParams
from ..r1cs import ConstraintSystem, FpVar


def const_q_power_vars(cs: ConstraintSystem, params: FalconParams) -> list[FpVar]:
    """The [q, 2*q^2, 4*q^3, ..., 2^log_n * q^(log_n+1)] constant wires
    (`falcon_ntt.rs:31-39`)."""
    return [FpVar.constant(cs, v) for v in params.const_q_powers]


@dataclass
class FalconNTTVerificationCircuit:
    """pk/msg/sig holder with `generate_constraints` (ConstraintSynthesizer
    parity, `falcon_ntt.rs:7-18`)."""

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

        sig_poly = inst.sig_lifted          # Polynomial::from(&sig), [0, q)
        pk_poly = inst.h

        const_vars = const_q_power_vars(cs, params)
        param_vars = ntt_param_var(cs, params)

        # ---- compute related data in the clear (`falcon_ntt.rs:41-51`) ----
        hm = hash_to_point(inst.msg, inst.nonce, n)
        hm_ntt = ntt(hm)
        # v = hm - sig*pk lifted to positives
        v = inst.v_lifted
        pk_ntt = ntt(pk_poly)

        # ---- allocate (`falcon_ntt.rs:53-71`) -----------------------------
        sig_vars = PolyVar.alloc_vars(cs, sig_poly, "witness")
        pk_ntt_vars = NTTPolyVar.alloc_vars(cs, pk_ntt, "input")
        hm_ntt_vars = NTTPolyVar.alloc_vars(cs, hm_ntt, "input")
        v_vars = PolyVar.alloc_vars(cs, v, "witness")

        for e in v_vars.coeff():
            enforce_less_than_q(cs, e)

        # ---- prove v = hm - sig*pk mod q via NTT (`falcon_ntt.rs:78-111`) -
        sig_ntt_vars = NTTPolyVar.ntt_circuit(
            cs, sig_vars, const_vars, param_vars, params
        )
        v_ntt_vars = NTTPolyVar.ntt_circuit(
            cs, v_vars, const_vars, param_vars, params
        )

        for i in range(n):
            # hm[i] = v[i] + sig[i] * pk[i] mod q
            hm_ntt_vars.coeff()[i].enforce_equal(
                add_mod(
                    cs,
                    v_ntt_vars.coeff()[i],
                    sig_ntt_vars.coeff()[i] * pk_ntt_vars.coeff()[i],
                    const_vars[0],
                )
            )

        # ---- prove ||(v | sig)||^2 < beta^2 (`falcon_ntt.rs:113-122`) -----
        norm = l2_norm_var(
            cs, v_vars.coeff() + sig_vars.coeff(), const_vars[0]
        )
        enforce_less_than_norm_bound(cs, norm, params)
