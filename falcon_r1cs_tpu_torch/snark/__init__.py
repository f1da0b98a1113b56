"""SNARK backend: BLS12-381 + Groth16 prove/verify over compiled R1CS.

From-scratch replacement for the reference's ark-groth16 + ark-bls12-381
stack (`falcon-r1cs/examples/pok_sig.rs:30-47`).  Pure
Python correctness core; native C (native/groth16_native.c) and the CUDA
G1 MSM (gpu_msm.py) accelerate the hot loops.
"""

from .bls12_381 import (  # noqa: F401
    P,
    R,
    G1_GEN,
    G2_GEN,
    pairing,
    multi_pairing,
)
from .groth16 import (  # noqa: F401
    Proof,
    ProvingKey,
    SetupToxic,
    VerifyingKey,
    prove,
    prove_batch,
    setup,
    verify,
)
