"""Clear-side Falcon layer of the port.

The host half (codecs, hash-to-point, polynomials, instance generation and
the clear verify, the numpy NTT, NTRU keygen and signing with their spec
and NIST KAT layers) is the port's own copy of the JAX package's; the
device half of the NTT is ported to torch in `ntt.py`, and the batched
device verify (`verify_batch`) in `instances.py`.
"""

from .codec import (
    CodecError,
    compress_signature,
    decode_public_key,
    decompress_signature,
    encode_public_key,
)
from .hash_to_point import NONCE_LEN, hash_to_point, hash_to_point_batch
from .instances import (
    VerificationInstance,
    instance_from_signature,
    make_instance,
    make_instance_batch,
    verify,
    verify_batch,
)
from .keygen import NTRUSolveError, SecretKey, keygen, ntru_solve
from .ntt import intt, intt_torch, negacyclic_mul, ntt, ntt_torch
from .poly import DualPolynomial, NTTPolynomial, Polynomial
from .sign import KeyPair, Signature, Signer

__all__ = [
    "CodecError",
    "DualPolynomial",
    "NONCE_LEN",
    "NTTPolynomial",
    "Polynomial",
    "VerificationInstance",
    "compress_signature",
    "decode_public_key",
    "decompress_signature",
    "encode_public_key",
    "KeyPair",
    "NTRUSolveError",
    "SecretKey",
    "Signature",
    "Signer",
    "hash_to_point",
    "hash_to_point_batch",
    "instance_from_signature",
    "intt",
    "intt_torch",
    "make_instance",
    "make_instance_batch",
    "keygen",
    "negacyclic_mul",
    "ntru_solve",
    "ntt",
    "ntt_torch",
    "verify",
    "verify_batch",
]
