"""Per-circuit witness API: engine + interleaver + packer lookup.

The counterpart of `falcon_r1cs_tpu/witness/api.py`:

    from falcon_r1cs_tpu_torch.witness import circuit_witness
    cw = circuit_witness(FalconNTTVerificationCircuit, 1024, "cuda")
    seg = cw.engine(sig, pk_ntt, hm_ntt)     # batched device engine
    packed = cw.pack(seg)                     # (B, W, limbs) u32 limbs as int32
    flat = cw.interleave(seg)                 # host object-int parity view

All three circuits are ported: verify-with-NTT and dual-NTT export 5 u32
limbs per witness, schoolbook 8 (its is_eq multipliers are field values).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..circuits import (
    FalconDualNTTVerificationCircuit,
    FalconNTTVerificationCircuit,
    FalconSchoolBookVerificationCircuit,
)
from ..params import get_params
from ..utils.config import RuntimeConfig


@dataclass(frozen=True)
class CircuitWitness:
    """Bundled witness machinery for one circuit family + parameter set.

    engine inputs (all (B, n) integer tensors on the packer's device):
      verify-ntt:  (sig lifted to [0,q), pk_ntt, hm_ntt)
      dual-ntt:    (sig SIGNED, pk_ntt, hm_ntt)
      schoolbook:  (sig lifted to [0,q), pk coefficients, hm coefficients)
    """

    n: int
    engine: Callable
    interleave: Callable
    pack: Callable
    export_limbs: int


def circuit_witness(
    circuit_cls, n: int, device, config: RuntimeConfig = RuntimeConfig()
) -> CircuitWitness:
    params = get_params(n)
    if circuit_cls is FalconNTTVerificationCircuit:
        from .engine import witness_engine
        from .export_device import packer_ntt
        from .layout import interleave_witness

        return CircuitWitness(
            n=n,
            engine=witness_engine(n, config.fused_intt),
            interleave=lambda seg: interleave_witness(seg, params),
            pack=packer_ntt(n, device),
            export_limbs=5,
        )
    if circuit_cls is FalconDualNTTVerificationCircuit:
        from .engine_dual import interleave_witness_dual, witness_engine_dual
        from .export_device import packer_dual

        return CircuitWitness(
            n=n,
            engine=witness_engine_dual(n),
            interleave=lambda seg: interleave_witness_dual(seg, params),
            pack=packer_dual(n, device),
            export_limbs=5,
        )
    if circuit_cls is FalconSchoolBookVerificationCircuit:
        from .engine_schoolbook import (
            interleave_witness_schoolbook,
            witness_engine_schoolbook,
        )
        from .export_device import packer_schoolbook

        return CircuitWitness(
            n=n,
            engine=witness_engine_schoolbook(n),
            interleave=lambda seg: interleave_witness_schoolbook(seg, params),
            pack=packer_schoolbook(n, device),
            export_limbs=8,
        )
    raise TypeError(f"no witness machinery for {circuit_cls!r}")
