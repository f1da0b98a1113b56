"""The G1 MSM's signed-digit recode (ops/msm_recode.py) on the CPU: its
plain version against the JAX package's host recode and against the
port's numpy recode in the K-fold layout, the top-window overflow, the
extended window count that leaves no scalar below 2^255 a carry out, and
the MSMs that now recode on the device (g1_msm_gpu, g1_msm_gpu_multi and
the sharded MSM at 2 gloo ranks) on CPU tensors against the native C.
Exact results: every comparison is equality."""

import numpy as np
import pytest
import torch

import falcon_r1cs_tpu.snark.tpu_msm as tm
from falcon_r1cs_tpu.snark import native_backend as jax_native
from falcon_r1cs_tpu.snark.points import G1Array as JaxG1Array
from falcon_r1cs_tpu_torch.ops import msm_recode
from falcon_r1cs_tpu_torch.parallel import jobs
from falcon_r1cs_tpu_torch.parallel.launch import run_group
from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend
from falcon_r1cs_tpu_torch.snark.bls12_381 import R
from falcon_r1cs_tpu_torch.snark.points import ints_to_limbs

WINDOWS = (4, 5, 8, 12, 13, 16)
N, N_PAD = 1237, 2048   # not a power of two
MSM_N, MSM_WINDOW = 45, 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread (as in tests/test_torch_msm.py: the
    plain MSM is thousands of small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carry_run(window: int, length: int) -> int:
    """A scalar whose window-0 digit 2^(w-1) + 1 carries, then `length`
    digits of exactly 2^(w-1) that each take the carry and pass it on."""
    half = 1 << (window - 1)
    return (half + 1) + sum(half << (window * j) for j in range(1, length + 1))


def _scalars(n: int, seed: int) -> np.ndarray:
    """(n, 4) u64: random scalars below r, then 0, r - 1, 1, rows whose
    limbs 0-2 have the top bit set (and all ones), and carry runs at every
    window of WINDOWS."""
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    special = [0, R - 1, 1, (1 << 255) - 1 - (1 << 254), ((1 << 192) - 1) | (7 << 200)]
    special += [(1 << 63) | (1 << 127) | (1 << 191) | (5 << 192) | k for k in range(4)]
    for w in WINDOWS:
        special += [_carry_run(w, k) for k in (1, 3, 250 // w - 2)]
    ints[:len(special)] = special
    return ints_to_limbs(ints, 4)


def _inf(n: int) -> np.ndarray:
    inf = np.zeros(n, dtype=bool)
    inf[3::7] = True
    return inf


def _plain(sc: np.ndarray, inf: np.ndarray, window: int, n_pad: int):
    digits, overflow = msm_recode.signed_digits(
        torch.from_numpy(np.ascontiguousarray(sc).view(np.int64)), torch.from_numpy(inf),
        window, n_pad)
    return digits.numpy(), int(overflow.item())


def _jax_fits(sc: np.ndarray, window: int) -> np.ndarray:
    """The rows whose scalars fit the windows: those the JAX package's
    recode takes alone (every row where nw w >= 256, each row tried where
    the top window can take a carry out)."""
    if msm_recode.n_windows(window) * window >= 256:
        return np.ones(len(sc), dtype=bool)
    fits = np.ones(len(sc), dtype=bool)
    for i in range(len(sc)):
        try:
            tm._window_digits_signed(sc[i:i + 1], window)
        except ValueError:
            fits[i] = False
    return fits


@pytest.mark.parametrize("window", WINDOWS)
def test_plain_recode_matches_jax(window):
    """The plain recode equals the JAX package's `_window_digits_signed`
    with the infinity points' scalars zeroed and the digits padded: on
    every row whose scalar fits the windows, and its flag is set iff a
    row does not (at w = 5 r - 1 and the rows above ~2^254.1 carry out)."""
    sc, inf = _scalars(N, window), _inf(N)
    masked = np.where(inf[:, None], np.uint64(0), sc)
    fits = _jax_fits(masked, window)
    got, overflow = _plain(sc, inf, window, N_PAD)
    want = np.asarray(tm._window_digits_signed(masked[fits], window))
    assert got.shape == (msm_recode.n_windows(window), N_PAD) and got.dtype == np.int32
    assert np.array_equal(got[:, :N][:, fits], want)
    assert not got[:, N:].any() and not got[:, :N][:, inf].any()
    assert overflow == int(not fits.all())
    assert window != 5 or not fits[1]        # r - 1 carries out at w = 5
    assert _plain(sc[fits], inf[fits], window, N_PAD)[1] == 0


@pytest.mark.parametrize("window", [4, 12, 13])
def test_plain_recode_k_fold_matches_numpy_stack(window):
    """(K, n, 4) scalars recode to the w-major (nw K, n_pad) plane of the
    numpy stack that g1_msm_gpu_multi built before (row w K + k), and
    `_point_digits` gives the same from Python ints (reduced mod r) and
    from the stacked u64 rows."""
    K = 3
    rows = [_scalars(N, 100 * window + k) for k in range(K)]
    inf = _inf(N)
    masked = [np.where(inf[:, None], np.uint64(0), r) for r in rows]
    stack = np.stack([gpu_msm._window_digits_signed(r, window) for r in masked], axis=1)
    nw = stack.shape[0]
    want = np.zeros((nw, K, N_PAD), np.int32)
    want[..., :N] = stack
    want = want.reshape(nw * K, N_PAD)
    got, overflow = _plain(np.stack(rows), inf, window, N_PAD)
    assert np.array_equal(got, want) and overflow == 0
    arr = gpu_msm.G1Array(np.zeros((N, 6), np.uint64), np.zeros((N, 6), np.uint64), inf)
    digits, flag = gpu_msm._point_digits(arr, np.stack(rows), window, N_PAD, "cpu")
    assert np.array_equal(digits.numpy(), want) and flag.item() == 0
    ints = [int.from_bytes(r.astype("<u8").tobytes(), "little") + R for r in rows[0]]
    digits, _ = gpu_msm._point_digits(arr, ints, window, N_PAD, "cpu")
    assert np.array_equal(digits.numpy(), want.reshape(nw, K, N_PAD)[:, 0])


def test_top_window_carry_raises():
    """At w = 5 (51 x 5 = 255 bits) r - 1 does not fit: the plain recode
    flags it, the numpy recodes raise, and g1_msm_gpu and g1_msm_gpu_multi
    raise the same ValueError at their fold; at w = 8 they do not."""
    sc = ints_to_limbs([R - 1] * 8, 4)
    inf = np.zeros(8, dtype=bool)
    assert _plain(sc, inf, 5, 8)[1] == 1 and _plain(sc, inf, 8, 8)[1] == 0
    for recode in (tm._window_digits_signed, gpu_msm._window_digits_signed):
        with pytest.raises(ValueError, match="top-window carry overflow"):
            recode(sc, 5)
    arr = native_backend.g1_fixed_base_batch(list(range(1, 9)))
    with pytest.raises(ValueError, match="top-window carry overflow"):
        gpu_msm.g1_msm_gpu(arr, [R - 1] * 8, window=5, device="cpu")
    with pytest.raises(ValueError, match="top-window carry overflow"):
        gpu_msm.g1_msm_gpu_multi(arr, [[1] * 8, [R - 1] * 8], window=5, device="cpu")
    # every point infinite: r - 1 is zeroed first and nothing carries
    arr = native_backend.g1_fixed_base_batch(list(range(1, 9)))
    arr.inf[:] = 1
    assert gpu_msm.g1_msm_gpu(arr, [R - 1] * 8, window=5, device="cpu") is None


CARRY_WINDOWS = (3, 5, 12, 15, 17)


def _full_width_rows(K: int, n: int, seed: int) -> np.ndarray:
    """(K, n, 4) u64: rows 0, 1, r - 1 and all ones below 2^255, then
    random scalars below 2^255."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(K):
        ints = [0, 1, R - 1, (1 << 255) - 1]
        ints += [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(n - len(ints))]
        out.append(ints_to_limbs(ints, 4))
    return np.stack(out)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("window", CARRY_WINDOWS)
def test_plain_recode_carry_count_recombines(window, K):
    """At n_windows_carry(w) windows (one more than ceil(255 / w) where w
    divides 255) the plain recode of 0, 1, r - 1, all ones below 2^255
    and random full-width scalars sets no flag, and its digits recombine
    to the scalar: sum_j d_j 2^(w j) = s, each d_j = u_j + c_j - 2^w
    c_(j+1) over the JAX package's unsigned windows u_j (`_window_digits`,
    zero past its ceil(255 / w)) with carries c_j in {0, 1}, c_0 = 0 and
    no carry out.  At the default count the digits are the first
    ceil(255 / w) windows of the same recode, equal to the JAX package's
    signed recode on every row that fits them."""
    n, n_pad = 61, 64
    nw, nwc = msm_recode.n_windows(window), msm_recode.n_windows_carry(window)
    assert nwc == nw + (255 % window == 0)
    sc, inf = _full_width_rows(K, n, 300 + window), _inf(n)
    masked = np.where(inf[None, :, None], np.uint64(0), sc)
    got, overflow = msm_recode.signed_digits(
        torch.from_numpy(sc.view(np.int64)), torch.from_numpy(inf), window, n_pad, nwc)
    assert got.shape == (nwc * K, n_pad) and got.dtype == torch.int32
    assert overflow.item() == 0
    got = got.numpy().reshape(nwc, K, n_pad)
    assert not got[..., n:].any() and not got[..., :n][..., inf].any()
    mag = (got & ((1 << window) - 1)).astype(np.int64)
    d = np.where(got >> window, -mag, mag)[..., :n]
    for k in range(K):
        ints = [int.from_bytes(r.astype("<u8").tobytes(), "little") for r in masked[k]]
        assert [sum(int(d[j, k, i]) << (window * j) for j in range(nwc))
                for i in range(n)] == ints
        u = np.zeros((nwc, n), np.int64)
        u[:nw] = tm._window_digits(masked[k], window)
        carry = np.zeros(n, np.int64)
        for j in range(nwc):
            nxt, rem = np.divmod(u[j] + carry - d[j, k], 1 << window)
            assert not rem.any() and np.isin(nxt, (0, 1)).all()
            carry = nxt
        assert not carry.any()
    default, flag = msm_recode.signed_digits(
        torch.from_numpy(sc.view(np.int64)), torch.from_numpy(inf), window, n_pad)
    assert np.array_equal(default.numpy(), got[:nw].reshape(nw * K, n_pad))
    assert flag.item() == int(got[nw:].any())
    for k in range(K):
        fits = _jax_fits(masked[k], window)
        want = np.asarray(tm._window_digits_signed(masked[k][fits], window))
        assert np.array_equal(default.numpy().reshape(nw, K, n_pad)[:, k, :n][:, fits], want)


def test_recode_wrapper_window_count_on_cpu():
    """signed_digits_cuda on CPU tensors hands the count to the plain
    version and refuses any count but ceil(255 / w) and 255 // w + 1."""
    sc = torch.from_numpy(_full_width_rows(1, 8, 5)[0].view(np.int64))
    inf = torch.zeros(8, dtype=torch.bool)
    for window, nw in ((5, 52), (5, 51), (12, 22), (17, 16), (3, 86)):
        got = msm_recode.signed_digits_cuda(sc, inf, window, 8, nw)
        want = msm_recode.signed_digits(sc, inf, window, 8, nw)
        assert got[0].shape == (nw, 8) and all(torch.equal(g, w) for g, w in zip(got, want))
    for window, nw in ((5, 50), (5, 53), (12, 23), (12, 21), (17, 17), (0, None), (31, None)):
        with pytest.raises(ValueError):
            msm_recode.signed_digits_cuda(sc, inf, window, 8, nw)


def _msm_case():
    """MSM_N points (not a power of two), every 7th from the 4th infinite,
    and u64 scalars with 0, r - 1, top bits and carry runs."""
    rng = np.random.default_rng(20261026)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, MSM_N)])
    arr.inf[:] = _inf(MSM_N)
    return arr, [_scalars(MSM_N, 7 + k) for k in range(2)]


def test_msm_single_and_k_fold_cpu_match_native():
    """g1_msm_gpu and g1_msm_gpu_multi (K = 2) on CPU tensors, recoded by
    the plain version, equal the port's native C MSMs and the JAX
    package's native C MSM."""
    arr, (sc, sc2) = _msm_case()
    want = native_backend.g1_msm(arr, sc)
    assert want == jax_native.g1_msm(JaxG1Array(arr.xs, arr.ys, arr.inf), sc)
    assert want is not None
    assert gpu_msm.g1_msm_gpu(arr, sc, MSM_WINDOW, device="cpu") == want
    got = gpu_msm.g1_msm_gpu_multi(arr, [sc, sc2], MSM_WINDOW, device="cpu")
    assert got == native_backend.g1_msm_multi(arr, np.stack([sc, sc2])) == \
        [want, native_backend.g1_msm(arr, sc2)]


def test_msm_sharded_two_ranks_matches_native():
    """g1_msm_gpu_sharded over 2 gloo ranks (shards of 32 and 13 points),
    each rank recoding its own shard, equals the native C MSM."""
    arr, (sc, _) = _msm_case()
    got = run_group(jobs.msm_job, 2, "cpu", arr, sc, MSM_WINDOW, "cpu", timeout_s=240)
    assert got == native_backend.g1_msm(arr, sc) and got is not None
