"""G1-MSM backend policy of the port's prover: the backend follows the
device.

`prove(..., g1_backend="auto", msm_device=...)` and `prove_batch` resolve
"auto" here.  A CUDA `msm_device` (the default, as a string, "cuda:0" or
a `torch.device`) gives "gpu": the witness map runs on the Fr kernels
(snark/gpu_qap.py) and the four G1 MSMs on the CUDA engine
(snark/gpu_msm.py).  On one H100 a Falcon-512 prove takes about half the
time of the native C prover's on the card's host (PERF.md §5), so the
card is the default at every batch size.  Without a card a CUDA
`msm_device` raises `DeviceUnavailableError`, naming `msm_device="cpu"`:
nothing falls back to the host on its own.  A CPU `msm_device` gives the
host: the native C backend when it is built, else pure Python.

The JAX package's policy differs: it picks the host C whenever it is
built, because on its TPU host the C matched or beat the chip's MSM at
every batch size it measured.  Callers pick a backend explicitly with
`prove(..., g1_backend=...)`; there is no environment override.
"""

from __future__ import annotations

from ..utils.device import entry_device


def choose_g1_backend(native_available: bool, msm_device="cuda") -> str:
    """Resolve "auto" to a concrete G1-MSM backend for `msm_device`.

    Pure function of its inputs but for the card check of a CUDA device
    (`utils.device.entry_device`), which raises without a card."""
    if entry_device(msm_device).type == "cuda":
        return "gpu"
    return "native" if native_available else "python"
