"""Harness hook of the port: `entry()`, the counterpart of the repo's
`__graft_entry__.py` `entry()`.

`entry(device)` returns a forward step on the flagship workload -- batched
Falcon-1024 verify-with-NTT witness generation (`generate_witness_ntt`,
which launches the hint kernel K1 twice on a CUDA device) -- and its
example batch as tensors on `device`.  The counterpart of
`dryrun_multichip()` comes with the port's parallel layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import FALCON_1024, Q
from .utils.device import entry_device
from .witness.engine import generate_witness_ntt


def _example_batch(n, batch, seed=0):
    """Deterministic synthetic inputs with the right ranges (uniform mod q;
    witness-generation cost is value-independent): the same numpy arrays
    as `__graft_entry__._example_batch`."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    pk_ntt = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    hm_ntt = rng.integers(0, Q, size=(batch, n), dtype=np.int32)
    return sig, pk_ntt, hm_ntt


def entry(device="cuda"):
    """(step, (sig, pk_ntt, hm_ntt)): step(sig, pk_ntt, hm_ntt) gives the
    batch's (sig_ntt_b, v_ntt_b, bound) tensors; the example batch is
    `_example_batch(1024, 8)` on `device`."""
    dev = entry_device(device)

    def step(sig, pk_ntt, hm_ntt):
        wb = generate_witness_ntt(sig, pk_ntt, hm_ntt, FALCON_1024)
        return wb.sig_ntt_b, wb.v_ntt_b, wb.bound

    args = tuple(torch.from_numpy(a).to(dev) for a in _example_batch(1024, 8))
    return step, args


if __name__ == "__main__":
    fn, args = entry()
    print(fn(*args)[0].shape)
