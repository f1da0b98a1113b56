"""End-to-end batched proving-input pipeline of the port.

The counterpart of `falcon_r1cs_tpu/pipeline.py`.  Wire-format
(pk, msg, sig) triples in; per-signature R1CS witness and public-input
tensors out, on one device.  Stages:

  1. decode pk/sig bytes (host, native C batch codecs)
  2. hash-to-point for the whole batch (host, native C)
  3. upload int16 planes; clear NTTs of pk and hm (device, falcon/ntt.py)
  4. batched witness generation (device, witness/engine.py)
  5. optional canonical (B, W, 5) packing (device, witness/export_device.py)

The host stages are the port's copies of the JAX package's host modules
(`falcon/`, `native/`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .falcon import hash_to_point_batch
from .falcon.ntt import ntt_torch
from .native import native_decode_pk_batch, native_decode_sig_batch
from .params import FalconParams, Q
from .utils.config import RuntimeConfig
from .witness.engine import witness_engine
from .witness.export_device import packer_ntt


@dataclass
class ProverInputs:
    """Device-resident outputs for a batch."""

    seg: dict                      # engine segment tensors
    pk_ntt: torch.Tensor           # (B, n) public inputs
    hm_ntt: torch.Tensor           # (B, n) public inputs
    packed: torch.Tensor | None    # (B, W, 5) canonical witness limbs


def _batch_axis(name: str) -> int:
    """Batch axis of an engine segment: 1 for the feature-first segments
    (NTT hint limbs, the norm blocks and the dual engine's pointwise
    values), 0 everywhere else."""
    feature_first = ("norm_bits", "norm_vals", "pointwise_vals")
    return 1 if name.endswith("_t") or name in feature_first else 0


def stitch_segments(segs: list[dict]) -> dict:
    """One segment dict from the dicts of consecutive sub-batches, each
    segment concatenated on its batch axis."""
    return {k: torch.cat([s[k] for s in segs], dim=_batch_axis(k)) for k in segs[0]}


class ProverInputPipeline:
    def __init__(
        self,
        params: FalconParams,
        device,
        pack: bool = True,
        max_chunk: int = 2048,
        config: RuntimeConfig = RuntimeConfig(),
    ):
        """max_chunk bounds device memory: a Falcon-1024 signature's packed
        witness alone is 3.1 MB, so batches run in sub-batches of at most
        `max_chunk` and are re-stitched on the device."""
        self.params = params
        self.device = torch.device(device)
        self.pack = pack
        self.max_chunk = max_chunk
        self._engine = witness_engine(params.n, config.fused_intt)
        self._packer = packer_ntt(params.n, self.device) if pack else None

    def _run_chunk(self, sig, pk_ntt, hm_ntt) -> ProverInputs:
        seg = self._engine(sig, pk_ntt, hm_ntt)
        packed = self._packer(seg) if self._packer else None
        return ProverInputs(
            seg=seg, pk_ntt=seg["pk_ntt"], hm_ntt=seg["hm_ntt"], packed=packed
        )

    def run_decoded(self, sig_signed, h, msgs, nonces) -> ProverInputs:
        """From decoded arrays: sig_signed (B, n) ints, h (B, n) in [0, q),
        msgs list[bytes], nonces list[bytes].  All device inputs are below
        q < 2^14, so they upload as int16."""
        n = self.params.n
        hm = hash_to_point_batch(msgs, nonces, n)  # host, native C

        def upload(a):
            return torch.from_numpy(np.asarray(a).astype(np.int16)).to(self.device)

        sig = upload(np.asarray(sig_signed) % Q)
        pk_ntt = ntt_torch(upload(h), n)
        hm_ntt = ntt_torch(upload(hm), n)
        B = sig.shape[0]
        if B <= self.max_chunk:
            return self._run_chunk(sig, pk_ntt, hm_ntt)
        outs = [
            self._run_chunk(
                sig[i : i + self.max_chunk],
                pk_ntt[i : i + self.max_chunk],
                hm_ntt[i : i + self.max_chunk],
            )
            for i in range(0, B, self.max_chunk)
        ]
        seg = stitch_segments([o.seg for o in outs])
        packed = torch.cat([o.packed for o in outs]) if self.pack else None
        return ProverInputs(
            seg=seg, pk_ntt=seg["pk_ntt"], hm_ntt=seg["hm_ntt"], packed=packed
        )

    def run_wire(self, pk_bytes_list, msgs, sig_bytes_list) -> ProverInputs:
        """From raw wire bytes (the full aggregate-signature path)."""
        p = self.params
        for pkb, sgb in zip(pk_bytes_list, sig_bytes_list):
            if not pkb or pkb[0] != p.header_pk or len(pkb) != p.pk_bytes:
                raise ValueError("parameter-set mismatch in batch")
            if not sgb or sgb[0] != p.header_sig or len(sgb) != p.sig_bytes:
                raise ValueError("parameter-set mismatch in batch")
        hs = native_decode_pk_batch(list(pk_bytes_list), p.n)
        sigs, nonces = native_decode_sig_batch(list(sig_bytes_list), p.n)
        return self.run_decoded(sigs, hs, list(msgs), nonces)
