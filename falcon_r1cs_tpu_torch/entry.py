"""Harness hooks of the port: the counterparts of the repo's
`__graft_entry__.py` `entry()` and `dryrun_multichip()`.

`entry(device)` returns a forward step on the flagship workload -- batched
Falcon-1024 verify-with-NTT witness generation (`generate_witness_ntt`,
which launches the hint kernel K1 twice on a CUDA device) -- and its
example batch as tensors on `device`.

`dryrun_multichip(n_devices, device)` spawns `n_devices` ranks (one card
each over NCCL, or CPU processes over gloo) and runs the sharded engines
and the sharded CRT check in them, every output asserted bit-equal to the
single-device engine's.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import FALCON_1024, Q
from .utils.device import entry_device, rank_device
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


def dryrun_multichip(n_devices: int, device="cuda") -> list[str]:
    """The sharded paths on `n_devices` spawned ranks, each output checked
    bit for bit against the single-device engine on the same inputs
    (`__graft_entry__.dryrun_multichip`, step for step):

      1. the verify-with-NTT engine on a (n/2, 2) mesh (DP + the
         coefficient-sharded NTTs; (1, 1) at one device);
      2. the same engine batch-only, (n, 1);
      3. the dual-NTT engine, batch-only;
      4. the schoolbook engine, batch-only;
      5. the row-sharded CRT check of a Falcon-512 instance: its valid
         assignment True, one bumped value False.

    On "cuda" each rank takes a card, so n_devices above the host's card
    count raises; nothing moves to gloo on its own.  Returns the names of
    the checks that passed."""
    from .parallel.launch import run_group

    dev = entry_device(device)
    return run_group(_dryrun_rank, n_devices, dev.type, n_devices, dev.type)


def _dryrun_rank(n_devices: int, device) -> list[str]:
    """dryrun_multichip's body in each rank; rank 0 compares."""
    import torch.distributed as dist

    from .parallel import jobs
    from .witness import witness_engine, witness_engine_dual, witness_engine_schoolbook

    dev = rank_device(device)
    checked = []

    def check(label, kind, batch_axis, arrays, single, key, shape):
        out, _ = jobs.engine_job(kind, 1024, batch_axis, arrays, device)
        if out[key].shape != shape:
            raise AssertionError(f"{label}[{key}]: shape {out[key].shape} != {shape}")
        if dist.get_rank() == 0:
            want = single(*(torch.from_numpy(a).to(dev) for a in arrays))
            if sorted(out) != sorted(want):
                raise AssertionError(f"{label}: keys {sorted(out)} != {sorted(want)}")
            for k, v in want.items():
                v = v.cpu().numpy()
                if not np.array_equal(out[k], v):
                    raise AssertionError(
                        f"{label}[{k}]: sharded != single-device (first differences "
                        f"at {np.argwhere(out[k] != v)[:3].tolist()})")
        checked.append(label)

    batch_axis = max(1, n_devices // 2)
    check("ntt DP+SP", "ntt", batch_axis, _example_batch(1024, batch_axis * 2),
          witness_engine(1024), "sig_ntt_b", (batch_axis * 2, 1024))
    sig, pk, hm = _example_batch(1024, n_devices)
    check("ntt DP", "ntt", n_devices, (sig, pk, hm), witness_engine(1024),
          "sig_ntt_b", (n_devices, 1024))
    check("dual DP", "dual", n_devices, (sig - 6144, pk, hm), witness_engine_dual(1024),
          "sp_b", (n_devices, 1024))
    check("schoolbook DP", "schoolbook", n_devices, (sig, pk, hm),
          witness_engine_schoolbook(1024), "norm", (n_devices, 2048, 18))
    verdicts = jobs.sat_job(7, 5555, device)
    if verdicts != [True, False]:
        raise AssertionError(f"sharded CRT check: {verdicts} != [True, False]")
    checked.append("sharded CRT")
    return checked


if __name__ == "__main__":
    fn, args = entry()
    print(fn(*args)[0].shape)
