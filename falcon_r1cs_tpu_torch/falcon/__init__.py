"""Clear-side Falcon layer of the port.

The host half (codecs, hash-to-point, instance generation, the numpy NTT)
contains no JAX and is the JAX package's own, re-exported here; the device
half of the NTT is ported to torch in `ntt.py`.
"""

from falcon_r1cs_tpu.falcon import (
    compress_signature,
    decode_public_key,
    decompress_signature,
    encode_public_key,
    hash_to_point_batch,
    make_instance,
)

from .ntt import intt, intt_torch, ntt, ntt_torch

__all__ = [
    "compress_signature",
    "decode_public_key",
    "decompress_signature",
    "encode_public_key",
    "hash_to_point_batch",
    "intt",
    "intt_torch",
    "make_instance",
    "ntt",
    "ntt_torch",
]
