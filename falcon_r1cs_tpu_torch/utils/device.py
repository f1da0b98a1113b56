"""The device of an entry point: the card, unless the caller asks for the
CPU.

Every entry point of the port (`falcon.verify_batch`, `entry.entry`, the
examples and `python -m falcon_r1cs_tpu_torch`) takes `device`, default
"cuda", and resolves it here.  Nothing falls back to the CPU on its own:
without a card, a CUDA device raises, naming the argument and the flag
that ask for the CPU.
"""

from __future__ import annotations

import torch


class DeviceUnavailableError(RuntimeError):
    """A CUDA device was asked for (the default) and no card is present."""


def entry_device(device="cuda") -> torch.device:
    """torch.device(device), checked: a CUDA device needs a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"device={str(device)!r}: torch.cuda.is_available() is false; "
            "pass device='cpu' (on the command line: --device cpu) to run "
            "on the CPU"
        )
    return dev


def rank_device(device) -> torch.device:
    """This process's device of `device`'s type: its current card (a rank
    of a process group sets it from LOCAL_RANK), or the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev
