"""G1-MSM backend policy of the port's prover.

The port's copy of `falcon_r1cs_tpu/snark/backend_policy.py` with the CUDA
engine (snark/gpu_msm.py, backend "gpu") in the place of the TPU engine.
The policy is the JAX package's: the native C backend is chosen whenever
it is built, the device engine only on request or when the C backend is
absent and a CUDA card is present, and pure Python last.

`GPU_WINS_FROM_K` is the smallest K (batched proofs over one CRS) at which
the CUDA MSM beats the host C per MSM on the card's host; None until a
measurement on that host finds such a crossover (PERF.md holds the
measured MSM times of both).  Callers pick a backend explicitly with
`prove(..., g1_backend=...)`; there is no environment override.
"""

from __future__ import annotations

GPU_WINS_FROM_K: int | None = None


def choose_g1_backend(
    native_available: bool,
    gpu_ok: bool,
    K: int = 1,
) -> str:
    """Resolve "auto" to a concrete G1-MSM backend.

    Pure function of its inputs; callers feed in availability facts so no
    probe runs unless its answer can change the outcome.
    """
    if native_available and (GPU_WINS_FROM_K is None or K < GPU_WINS_FROM_K):
        return "native"
    if gpu_ok:
        return "gpu"
    if native_available:
        return "native"
    return "python"
