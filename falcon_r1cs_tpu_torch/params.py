"""Falcon parameter sets and NTT tables.

TPU-native re-design of the reference's compile-time parameter selection
(`falcon-r1cs/Cargo.toml:28-32` selects falcon-512/falcon-1024
via cargo features; constants arrive as `falcon_rust::{MODULUS, N, LOG_N,
NTT_TABLE, SIG_L2_BOUND}`, see `falcon-r1cs/src/gadgets/misc.rs:4`).
Here both parameter sets are co-resident runtime objects, since JAX retraces
per static shape anyway.

NTT table provenance: the reference derives its plain-form tables from the
Falcon C `vrfy.c` Montgomery-form tables by dividing by R = 2^16 mod q = 4091
(`falcon-r1cs/script/ntt_param.sage:132,263`).  We generate the same tables
from first principles: NTT_TABLE[i] = psi^bitrev(i) mod q with psi a primitive
2n-th root of unity (psi = 7 for n = 1024, psi = 49 for n = 512); equality with
the sage-script ground truth is asserted in tests/test_params.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

# The Falcon modulus q = 12289 = 3 * 2^12 + 1 = 2^13 + 2^12 + 1
# (`falcon-r1cs/src/gadgets/range_proofs.rs:74`).
Q = 12289

# Primitive 2048-th root of unity mod q used by the Falcon reference C code.
PSI_1024 = 7

# The ~255-bit SNARK field: the BLS12-381 scalar field Fr, equal to the base
# field Fq of ark-ed-on-bls12-381 (Jubjub) that the reference instantiates its
# circuits over (`falcon-r1cs/examples/pok_sig.rs:3,39-44`).
FIELD_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def bitrev(x: int, bits: int) -> int:
    """Reverse the low `bits` bits of x."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def ntt_table(n: int) -> tuple[int, ...]:
    """Forward NTT root table, plain (non-Montgomery) form, bit-reversed order.

    table[i] = psi_n^bitrev(i) mod q where psi_n is a primitive 2n-th root.
    Accessed as table[m + i] during Cooley-Tukey stage m, exactly the access
    pattern of `falcon-r1cs/src/gadgets/poly.rs:122`.
    Note table_512 == table_1024[:512].
    """
    log_n = n.bit_length() - 1
    psi = pow(PSI_1024, 1024 // n, Q)
    return tuple(pow(psi, bitrev(i, log_n), Q) for i in range(n))


@functools.lru_cache(maxsize=None)
def inv_ntt_table(n: int) -> tuple[int, ...]:
    """Inverse NTT root table: table[i] = psi_n^-bitrev(i) mod q.

    The reference's `inv_ntt_param_var` is dead code that (buggily) returns the
    forward table (`falcon-r1cs/src/gadgets/misc.rs:80-90`);
    no inverse NTT exists in the reference circuits.  This table is used only
    by our clear-side inverse NTT (falcon/ntt.py), never in a circuit.
    """
    log_n = n.bit_length() - 1
    psi_inv = pow(pow(PSI_1024, 1024 // n, Q), Q - 2, Q)
    return tuple(pow(psi_inv, bitrev(i, log_n), Q) for i in range(n))


@dataclass(frozen=True)
class FalconParams:
    """One Falcon parameter set (the runtime analog of the cargo feature)."""

    n: int
    log_n: int
    q: int
    # l2-norm bound beta^2: 34034726 (Falcon-512) / 70265242 (Falcon-1024).
    # The 1024 value is confirmed by the bit pattern encoded at
    # `falcon-r1cs/src/gadgets/range_proofs.rs:222-234`
    # (its doc comment :188-189 saying 34034726 is stale).
    sig_l2_bound: int
    # Wire-format sizes (Falcon spec): pk = 1 header byte + n*14 bits;
    # sig (compressed, falcon-rust style) = 1 header + 40-byte nonce + payload.
    pk_bytes: int
    sig_bytes: int
    header_pk: int
    header_sig: int

    @property
    def ntt_table(self) -> tuple[int, ...]:
        return ntt_table(self.n)

    @property
    def inv_ntt_table(self) -> tuple[int, ...]:
        return inv_ntt_table(self.n)

    @property
    def const_q_powers(self) -> tuple[int, ...]:
        """The [q, 2*q^2, 4*q^3, ..., 2^log_n * q^(log_n+1)] constants.

        These are the constant wires built by every NTT-based circuit
        (`falcon-r1cs/src/circuits/falcon_ntt.rs:31-39`):
        const[x-1] = 2^(x-1) * q^x for x = 1..log_n+1.
        """
        return tuple(
            (1 << (x - 1)) * self.q**x for x in range(1, self.log_n + 2)
        )


FALCON_512 = FalconParams(
    n=512,
    log_n=9,
    q=Q,
    sig_l2_bound=34034726,
    pk_bytes=897,
    sig_bytes=666,
    header_pk=0x09,
    header_sig=0x39,
)

FALCON_1024 = FalconParams(
    n=1024,
    log_n=10,
    q=Q,
    sig_l2_bound=70265242,
    pk_bytes=1793,
    sig_bytes=1280,
    header_pk=0x0A,
    header_sig=0x3A,
)

_BY_N = {512: FALCON_512, 1024: FALCON_1024}


def get_params(n: int | None = None) -> FalconParams:
    """Look up a parameter set by polynomial degree (512 or 1024).

    n=None selects the runtime default (utils/config.RuntimeConfig.default_n
    -- the analog of the reference's default cargo feature)."""
    if n is None:
        from .utils.config import RuntimeConfig

        n = RuntimeConfig().default_n
    try:
        return _BY_N[n]
    except KeyError:
        raise ValueError(f"unsupported Falcon degree n={n}; want 512 or 1024")
