"""Runtime configuration of the PyTorch port.

The counterpart of `falcon_r1cs_tpu/utils/config.py`.  A frozen value that
callers create and pass (to `ProverInputPipeline`, `ResidueSystem`, the
witness engine); the port keeps no module-level configuration state.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    # default parameter set for CLIs/benches (512 or 1024)
    default_n: int = 1024
    # validate gadget inputs at trace time
    validate: bool = True
    # CRT satisfiability primes
    num_crt_primes: int = 24
    # compiled-artifact cache directory
    artifact_cache: str = os.path.expanduser("~/.cache/falcon_r1cs_tpu_torch")
    # the v chain on a CUDA device: True launches the fused INTT + hint
    # kernel (csrc/ntt_hints.cu intt_ntt_hints_kernel); False runs the
    # plain torch INTT, then the hint kernel.  The JAX package keeps the
    # same choice behind FALCON_R1CS_TPU_FUSED_INTT=1, default off.
    fused_intt: bool = False
