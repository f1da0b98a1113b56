"""The port's batched device verify (`falcon.verify_batch`, on CPU
tensors here) against the JAX package's `verify_batch`: the same verdicts
on valid and tampered batches, including the rows where it differs from
the clear `verify` (a coefficient |s2| > q/2), and its device check at
norms of bound - 1, bound and bound + 1."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.falcon as jf
from falcon_r1cs_tpu.falcon.instances import _jitted_verify_cached
from falcon_r1cs_tpu.params import get_params as jax_get_params
from falcon_r1cs_tpu_torch import Q, get_params
from falcon_r1cs_tpu_torch.falcon import KeyPair, make_instance, verify, verify_batch
from falcon_r1cs_tpu_torch.falcon.instances import _verify_cached
from falcon_r1cs_tpu_torch.utils.device import DeviceUnavailableError


def _batch(n, count, seed):
    """count instances of Falcon-n: (h, msgs, nonces, s2) as verify_batch
    takes them."""
    rng = np.random.default_rng(seed)
    insts = [make_instance(rng, get_params(n), msg=b"vb %d" % i) for i in range(count)]
    return (np.stack([i.h for i in insts]), [i.msg for i in insts],
            [i.nonce for i in insts], np.stack([i.sig_signed for i in insts]))


def _both(h, msgs, nonces, s2, n):
    got = verify_batch(h, msgs, nonces, s2, get_params(n), device="cpu")
    # the reference's jitted check, called at n = 1024 after this file's
    # calls at n = 512 in one process, can fail in XLA ("Execution supplied
    # 3 buffers but compiled program expected 7 buffers", JAX 0.9.0 on the
    # CPU; with or without the persistent cache): a fresh trace avoids it
    jax.clear_caches()
    want = jf.verify_batch(h, msgs, nonces, s2, jax_get_params(n))
    assert got.dtype == np.bool_ and got.shape == (len(msgs),)
    assert got.tolist() == np.asarray(want).tolist()
    return got.tolist()


def test_verify_batch_matches_jax_512():
    """Falcon-512, B = 8: valid rows, a tampered message, s2 set to 4000
    (norm past the bound), a coefficient |s2| > q/2 of the same residue
    (which verify_batch re-signs after % q and the clear verify squares as
    given), and one of another residue."""
    n = 512
    h, msgs, nonces, s2 = _batch(n, 8, 9)
    msgs[1] = b"tampered"
    s2[2] = 4000
    s2[3, 0] += Q
    s2[4, 5] -= Q
    s2[5, 7] = 7000
    got = _both(h, msgs, nonces, s2, n)
    assert got == [True, False, False, True, True, False, True, True]
    clear = [verify(h[i], msgs[i], nonces[i], s2[i], get_params(n)) for i in range(8)]
    assert clear == [True, False, False, False, False, False, True, True]


def test_verify_batch_shared_key_512():
    """h given as (n,): one real key pair, three signatures, one of them on
    another message."""
    params = get_params(512)
    kp = KeyPair.generate(np.random.default_rng(3), params)
    msgs = [b"first", b"second", b"third"]
    sigs = [kp.signer.sign_with_seed(b"seed %d" % i, m) for i, m in enumerate(msgs)]
    s2 = np.stack([s.s2 for s in sigs])
    nonces = [s.nonce for s in sigs]
    msgs[2] = b"other"
    assert _both(np.asarray(kp.h), msgs, nonces, s2, 512) == [True, True, False]


def test_verify_batch_matches_jax_1024():
    n = 1024
    h, msgs, nonces, s2 = _batch(n, 2, 11)
    s2[1, 3] -= Q
    assert _both(h, msgs, nonces, s2, n) == [True, True]
    s2[0, 3] = -7000
    assert _both(h, msgs, nonces, s2, n) == [False, True]


def _squares(total, count):
    """count values in [0, 6143] whose squares sum to `total` (greedy)."""
    out = []
    while total:
        c = min(math.isqrt(total), 6143)
        out.append(c)
        total -= c * c
    assert len(out) <= count
    return out + [0] * (count - len(out))


@pytest.mark.parametrize("n", [512, 1024])
def test_device_check_at_the_bound(n):
    """The cached device check against `_jitted_verify_cached` with h = 0
    (so v = hm) and s2, hm whose norm is bound - 1, bound and bound + 1:
    where a wrong comparison or an int32 overflow would show."""
    bound = get_params(n).sig_l2_bound
    rows_s2, rows_hm = [], []
    for norm in (bound - 1, bound, bound + 1):
        vals = np.asarray(_squares(norm, 2 * n), dtype=np.int64)
        signed = np.where(np.arange(2 * n) % 3 == 1, -vals, vals)
        rows_s2.append(signed[0::2] % Q)
        rows_hm.append(signed[1::2] % Q)
    s2 = np.stack(rows_s2).astype(np.int32)
    hm = np.stack(rows_hm).astype(np.int32)
    h = np.zeros_like(s2)
    want = np.asarray(_jitted_verify_cached(n, bound)(
        jnp.asarray(s2), jnp.asarray(h), jnp.asarray(hm)))
    got = _verify_cached(n, bound)(
        torch.from_numpy(s2), torch.from_numpy(h), torch.from_numpy(hm))
    assert got.tolist() == want.tolist() == [True, False, False]


def test_verify_batch_needs_a_card_unless_cpu_is_asked():
    """Without a card, verify_batch with no `device` raises; it does not
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    h, msgs, nonces, s2 = _batch(512, 1, 5)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        verify_batch(h, msgs, nonces, s2, get_params(512))
