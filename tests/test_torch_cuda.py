"""The port's CUDA kernels and its device path on a CUDA card, against the
port's own plain versions on the same inputs.

Every test here needs a card: it carries the `cuda` marker and skips where
torch.cuda.is_available() is false.  The file imports no JAX, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from falcon_r1cs_tpu_torch import FALCON_512, FALCON_1024, Q, ProverInputPipeline, RuntimeConfig
from falcon_r1cs_tpu_torch.falcon import compress_signature, encode_public_key, make_instance
from falcon_r1cs_tpu_torch.ops import (
    _build,
    cuda_ntt,
    fq,
    fq_check,
    fr,
    fq_mont,
    msm_bucket,
    msm_recode,
    ntt_limb,
    ntt_v3,
)
from falcon_r1cs_tpu_torch.ops.schoolbook import schoolbook_prods_cuda
from falcon_r1cs_tpu_torch.snark import gpu_msm, native_backend
from falcon_r1cs_tpu_torch.witness import (
    packer_dual,
    packer_schoolbook,
    witness_engine,
    witness_engine_dual,
    witness_engine_schoolbook,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, Q, size=shape).astype(np.int32)).to(device)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_kernels_match_plain(cuda, params):
    """K1 and K2 against their plain versions, bit for bit, on random rows,
    a row of all q - 1, one of all 0 and a one-hot row, at 64 rows and at
    1 and 3."""
    x = _rand((64, params.n), 31, cuda)
    x[0, :3] = torch.tensor([0, Q - 1, Q - 1], dtype=torch.int32)
    x[1], x[2], x[3] = Q - 1, 0, 0
    x[3, 5] = 1
    for rows in (x, x[1:2], x[1:4]):
        before = cuda_ntt.ntt_with_hints_cuda.launches
        for got, want in zip(
            cuda_ntt.ntt_with_hints_cuda(rows, params),
            cuda_ntt.ntt_with_hints_cuda.plain(rows, params),
        ):
            assert got.dtype == want.dtype and torch.equal(got, want)
        assert cuda_ntt.ntt_with_hints_cuda.launches == before + 1
        for got, want in zip(
            cuda_ntt.intt_ntt_hints_cuda(rows, params),
            cuda_ntt.intt_ntt_hints_cuda.plain(rows, params),
        ):
            assert got.dtype == want.dtype and torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_semi_kernel_matches_plain(cuda, params):
    """K8's semi state equals ntt_semi limb for limb, edge rows included,
    and the entry over it equals K1's (t, b).  At 256 random rows some
    limbs of the state lie outside [0, 2^16), where a sequential carry
    chain would differ from the parallel rounds."""
    x = _rand((256, params.n), 32, cuda)
    x[-2], x[-1] = 0, Q - 1
    before = ntt_v3.ntt_semi_cuda.launches
    got = ntt_v3.ntt_semi_cuda(x, params)
    assert ntt_v3.ntt_semi_cuda.launches == before + 1
    want = ntt_limb.ntt_semi(x, params)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert not got[-1].any() and ((want < 0) | (want > 0xFFFF)).any()
    for a, b in zip(ntt_v3.ntt_with_hints_v3(x, params),
                    cuda_ntt.ntt_with_hints_cuda(x, params)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_semi_hints_epilogue_matches_plain_and_k1(cuda, params, monkeypatch):
    """ntt_with_hints_v3 on a CUDA tensor is one K8 launch (the hints
    epilogue) and nothing else: no torch normalize or divmod_q, no K1.
    Its (t, b) equal ntt_with_hints and K1 bit for bit on random rows,
    rows whose semi state is redundant, all 0, all q - 1 and one-hot, at
    256 rows and at 1 and 3."""
    x = _rand((256, params.n), 35, cuda)
    x[-3], x[-2], x[-1] = 0, Q - 1, 0
    x[-1, 9] = Q - 1
    semi = ntt_limb.ntt_semi(x, params)
    assert ((semi < 0) | (semi > 0xFFFF)).flatten(2).any(2).any(0).any()

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the torch normalize or divmod_q")

    monkeypatch.setattr(ntt_v3, "normalize", refuse)
    monkeypatch.setattr(ntt_v3, "divmod_q", refuse)
    for rows in (x, x[-1:], x[-3:]):
        before = (ntt_v3.ntt_semi_cuda.launches, cuda_ntt.ntt_with_hints_cuda.launches)
        got = ntt_v3.ntt_with_hints_v3(rows, params)
        assert (ntt_v3.ntt_semi_cuda.launches,
                cuda_ntt.ntt_with_hints_cuda.launches) == (before[0] + 1, before[1])
        for g, w, k1 in zip(got, ntt_limb.ntt_with_hints(rows, params),
                            cuda_ntt.ntt_with_hints_cuda(rows, params)):
            assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g, k1)
    torch.cuda.synchronize()


def test_semi_wrapper_rejects_bad_inputs(cuda):
    good = _rand((2, 512), 33, cuda)
    for bad in (good.long(), good[:, :256].contiguous(),
                _rand((512, 2), 34, cuda).t()):
        with pytest.raises(ValueError):
            ntt_v3.ntt_semi_cuda(bad, FALCON_512)
    with pytest.raises(ValueError):
        ntt_v3.ntt_semi_cuda(good, FALCON_1024)


def test_add_one_and_self_test(cuda):
    _build.library()  # built, loaded and self-tested
    y = torch.arange(1000, dtype=torch.int32, device=cuda)
    assert torch.equal(_build.add_one(y), y + 1)


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((2, 512), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_with_hints_cuda(x, FALCON_512)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_with_hints_cuda(x.int(), FALCON_1024)
    with pytest.raises(ValueError):
        cuda_ntt.intt_ntt_hints_cuda(
            torch.zeros((512, 4), dtype=torch.int32, device=cuda).t(), FALCON_512
        )
    flat = torch.zeros(2 * 512 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # contiguous but not 16-byte aligned
        cuda_ntt.intt_ntt_hints_cuda(flat[1:].view(2, 512), FALCON_512)


@pytest.mark.parametrize("fused_intt", [False, True])
def test_engine_on_card_matches_cpu(cuda, fused_intt):
    """The whole engine on the card (kernels) equals the engine on the CPU
    (plain versions), segment by segment."""
    arrays = [_rand((4, 1024), s, "cpu") for s in (41, 42, 43)]
    want = witness_engine(1024)(*arrays)
    got = witness_engine(1024, fused_intt)(*[a.to(cuda) for a in arrays])
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k]), k


def test_pipeline_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(44)
    insts = [make_instance(rng, FALCON_512) for _ in range(3)]
    wire = (
        [encode_public_key(i.h, FALCON_512) for i in insts],
        [i.msg for i in insts],
        [compress_signature(i.sig_signed, i.nonce, FALCON_512) for i in insts],
    )
    want = ProverInputPipeline(FALCON_512, "cpu").run_wire(*wire)
    got = ProverInputPipeline(
        FALCON_512, cuda, max_chunk=2, config=RuntimeConfig(fused_intt=True)
    ).run_wire(*wire)
    assert torch.equal(got.packed.cpu(), want.packed)


@pytest.mark.parametrize("params", [FALCON_512, FALCON_1024])
def test_schoolbook_kernel_matches_plain(cuda, params):
    """K3 against its plain version, bit for bit, with coefficients 0 and
    q - 1 on both inputs."""
    n = params.n
    sig = _rand((16, n), 51, cuda)
    pk = _rand((16, n), 52, cuda)
    sig[0, :3] = torch.tensor([0, Q - 1, Q - 1], dtype=torch.int32)
    pk[0, :2] = torch.tensor([Q - 1, 0], dtype=torch.int32)
    pk[1, -2:] = torch.tensor([0, Q - 1], dtype=torch.int32)
    before = schoolbook_prods_cuda.launches
    got = schoolbook_prods_cuda(sig, pk, n)
    assert schoolbook_prods_cuda.launches == before + 1
    for g, w in zip(got, schoolbook_prods_cuda.plain(sig, pk, n)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    torch.cuda.synchronize()


def test_schoolbook_wrapper_rejects_bad_inputs(cuda):
    good = _rand((2, 512), 53, cuda)
    bad = (
        (good.long(), good),                                   # dtype
        (good, good.float()),
        (good, good[:, :256].contiguous()),                    # shape
        (good[:1], good),                                      # sig != pk shape
        (_rand((512, 2), 54, cuda).t(), good),                 # not contiguous
        (good, good.cpu()),                                    # mixed devices
        (good.view(-1)[1:513].view(1, 512), good[:1]),         # misaligned
    )
    for sig, pk in bad:
        with pytest.raises(ValueError):
            schoolbook_prods_cuda(sig, pk, 512)
    with pytest.raises(ValueError):
        schoolbook_prods_cuda(good, good, 1024)                # n != shape


@pytest.mark.parametrize("n", [512, 1024])
def test_dual_engine_on_card_matches_cpu(cuda, n):
    """The dual-NTT engine and packer on the card (K1) equal the same on
    the CPU (plain versions)."""
    rng = np.random.default_rng(55)
    sig = torch.from_numpy(rng.integers(-600, 601, size=(4, n)).astype(np.int32))
    pk_ntt, hm_ntt = _rand((4, n), 56, "cpu"), _rand((4, n), 57, "cpu")
    want = witness_engine_dual(n)(sig, pk_ntt, hm_ntt)
    before = cuda_ntt.ntt_with_hints_cuda.launches
    got = witness_engine_dual(n)(sig.to(cuda), pk_ntt.to(cuda), hm_ntt.to(cuda))
    assert cuda_ntt.ntt_with_hints_cuda.launches == before + 4
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(
        packer_dual(n, cuda)(got).cpu(), packer_dual(n, torch.device("cpu"))(want)
    )


@pytest.mark.parametrize("n", [512, 1024])
def test_schoolbook_engine_on_card_matches_cpu(cuda, n):
    """The schoolbook engine and packer on the card (K3) equal the same on
    the CPU (plain versions)."""
    arrays = [_rand((4, n), s, "cpu") for s in (58, 59, 60)]
    want = witness_engine_schoolbook(n)(*arrays)
    before = schoolbook_prods_cuda.launches
    got = witness_engine_schoolbook(n)(*[a.to(cuda) for a in arrays])
    assert schoolbook_prods_cuda.launches == before + 1
    assert got["valid"].tolist() == [1, 1, 1, 1]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].cpu(), want[k]), k
    assert torch.equal(
        packer_schoolbook(n, cuda)(got).cpu(),
        packer_schoolbook(n, torch.device("cpu"))(want),
    )


def _mont_points(m, seed, device):
    """m random G1 points (native fixed-base) as limb-major Montgomery X, Y
    on `device`, converted by K4 (mont_mul by R^2): canonical limbs."""
    rng = np.random.default_rng(seed)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, m)])
    xs, ys = gpu_msm._points_std_limbs(arr, m)
    r2 = fq_mont.consts(device)["r2"][:, None].expand(35, m).contiguous()
    X = fq.mont_mul_cuda(torch.from_numpy(xs.T.copy()).to(device), r2)
    Y = fq.mont_mul_cuda(torch.from_numpy(ys.T.copy()).to(device), r2)
    return X, Y


def _select_path_points(m, device):
    """Two operands hitting every select path of the point adds: rows 0:64
    doubling, 64:96 P + (-P), 96:128 inf1, 128:160 inf2, the rest chord."""
    X, Y = _mont_points(m, 61, device)
    perm = torch.from_numpy(np.random.default_rng(62).permutation(m)).to(device)
    X2, Y2 = X[:, perm].clone(), Y[:, perm].clone()
    X2[:, :96] = X[:, :96]
    Y2[:, :64] = Y[:, :64]
    Y2[:, 64:96] = fq_mont.sub_mod(torch.zeros_like(Y[:, 64:96]), Y[:, 64:96])
    inf1 = torch.zeros(m, dtype=torch.bool, device=device)
    inf1[96:128] = True
    inf2 = torch.zeros(m, dtype=torch.bool, device=device)
    inf2[128:160] = True
    return (X, Y, inf1), (X2, Y2, inf2)


def _assert_value_equal(got, want, p1=None, p2=None):
    """The Fq kernels' contract: each coordinate congruent mod q to the
    plain version's, flags exactly equal; for a point add, where the plain
    version's f32-steered equality test errs, the exact host reference
    decides."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    assert fq_check.value_check(got, want, p1, p2)[0] == 0


def test_fq_kernels_match_plain(cuda):
    """K4 (depth 1 and 4), K5 and K6 against their plain versions by
    value, on every select path; K4's outputs, and K5's and K6's where no
    operand is infinite, are canonical limbs."""
    m = 4096
    (X, Y, inf1), (X2, Y2, inf2) = _select_path_points(m, cuda)
    for depth in (1, 4):
        before = fq.mont_mul_cuda.launches
        got = fq.mont_mul_cuda(X, Y2, depth)
        assert fq.mont_mul_cuda.launches == before + 1
        _assert_value_equal((got,), (fq.mont_mul_cuda.plain(X, Y2, depth),))
        assert torch.equal(fq_mont.canonical(got), got)
    one = fq_mont.consts(cuda)["one"][:, None].expand(35, m).contiguous()
    p1, p2 = (X, Y, one, inf1), (X2, Y2, one.clone(), inf2)
    got = fq.point_add_cuda(p1, p2)
    want = fq.point_add_cuda.plain(p1, p2)
    _assert_value_equal(got, want, p1, p2)
    assert got[3][64:96].all()
    live = ~(inf1 | inf2)
    for g in got[:3]:
        assert torch.equal(fq_mont.canonical(g)[:, live], g[:, live])
    # Jacobian operands with Z != one: the outputs of the first add
    _assert_value_equal(fq.point_add_cuda(got, p1), fq.point_add_cuda.plain(got, p1), got, p1)
    a1, a2 = (X, Y, inf1), (X2, Y2, inf2)
    got = fq.point_add_aff_cuda(a1, a2)
    want = fq.point_add_aff_cuda.plain(a1, a2)
    _assert_value_equal(got, want, a1, a2)
    assert got[3][64:96].all()
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(fq_mont.canonical(g)[:, live], g[:, live])
        assert torch.equal(g[:, ~live], w[:, ~live])  # as given, Z = one
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["wide", "pos", "neg", "sub"])
def test_point_add_kernel_far_from_canonical(cuda, kind):
    """K5 == point_add by value on operands far from canonical: a K5 output
    (Z != one) under another representative plus itself (the doubling
    path) and plus the affine second operands (the chord)."""
    m = 1024
    (X, Y, inf1), (X2, Y2, inf2) = _select_path_points(m, cuda)
    one = fq_mont.consts(cuda)["one"][:, None].expand(35, m).contiguous()
    fed = fq.point_add_cuda((X, Y, one, inf1), (X2, Y2, one.clone(), inf2))
    far = tuple(fq_check.far_reps(fq_mont.canonical(c), kind, 70 + i).contiguous()
                for i, c in enumerate(fed[:3])) + (fed[3],)
    for other in (fed, (X2, Y2, one, inf2)):
        _assert_value_equal(fq.point_add_cuda(far, other), fq.point_add_cuda.plain(far, other),
                            far, other)
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["wide", "pos", "neg", "sub"])
def test_point_add_aff_kernel_far_from_canonical(cuda, kind):
    """K6 == point_add_aff by value on X and Y far from canonical, against
    the same points (the doubling path) and against the other affine
    operands (the chord, with every select path)."""
    m = 1024
    (X, Y, inf1), (X2, Y2, inf2) = _select_path_points(m, cuda)
    far = (fq_check.far_reps(X, kind, 80).contiguous(),
           fq_check.far_reps(Y, kind, 81).contiguous(), inf1)
    for other in ((X, Y, inf1), (X2, Y2, inf2)):
        _assert_value_equal(fq.point_add_aff_cuda(far, other),
                            fq.point_add_aff_cuda.plain(far, other), far, other)
    torch.cuda.synchronize()


def test_fq_wrappers_reject_bad_inputs(cuda):
    X, Y = _mont_points(256, 63, cuda)
    f = torch.zeros(256, dtype=torch.bool, device=cuda)
    for a, b in (
        (X.long(), Y),                              # dtype
        (X[:, :128].contiguous(), Y),               # shape
        (X[:34].contiguous(), Y[:34].contiguous()),  # limb count
        (Y.t().contiguous().t(), Y),                 # not contiguous
        (X, Y.cpu()),                                # mixed devices
    ):
        with pytest.raises(ValueError):
            fq.mont_mul_cuda(a, b)
    with pytest.raises(ValueError):
        fq.point_add_cuda((X, Y, X, f.int()), (X, Y, X, f))           # flag dtype
    with pytest.raises(ValueError):
        fq.point_add_aff_cuda((X, Y, f[:128]), (X, Y, f))              # flag shape
    with pytest.raises(ValueError):
        fq.point_add_aff_cuda((X.t().contiguous().t(), Y, f), (X, Y, f))


def _recode_scalars(K, n, seed):
    """(K, n, 4) u64 scalars below 2^255, limbs 0-2 over the full range
    (top bits set), with rows 0, r - 1 and all ones below 2^255."""
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R

    rng = np.random.default_rng(seed)
    sc = rng.integers(0, 2**64, size=(K, n, 4), dtype=np.uint64)
    sc[..., 3] >>= np.uint64(1)
    sc[:, 0] = 0
    sc[:, 1] = [(R - 1) >> (64 * j) & (2**64 - 1) for j in range(4)]
    sc[:, 2] = [2**64 - 1] * 3 + [2**63 - 1]
    return sc


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("log_n", [17, 21])
def test_recode_kernel_matches_plain(cuda, log_n, K):
    """The recode kernel equals its plain version bit for bit, digits and
    overflow flag, at n = 2^log_n - 3 points padded to 2^log_n, every 97th
    point infinite, window 12, one MSM or four (the K-fold layout): one
    launch a call."""
    n_pad = 1 << log_n
    n = n_pad - 3
    sc = torch.from_numpy(_recode_scalars(K, n, 80 + log_n).view(np.int64)).to(cuda)
    if K == 1:
        sc = sc[0]
    inf = torch.zeros(n, dtype=torch.bool, device=cuda)
    inf[5::97] = True
    before = msm_recode.signed_digits_cuda.launches
    digits, overflow = msm_recode.signed_digits_cuda(sc, inf, 12, n_pad)
    assert msm_recode.signed_digits_cuda.launches == before + 1
    want, want_overflow = msm_recode.signed_digits(sc, inf, 12, n_pad)
    assert digits.shape == (22 * K, n_pad) and digits.dtype == torch.int32
    assert torch.equal(digits, want) and torch.equal(overflow, want_overflow)
    assert overflow.item() == 0 and not digits[:, n:].any() and not digits[:, 5::97].any()


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("window", [3, 5, 15, 17])
def test_recode_kernel_carry_count_matches_plain(cuda, window, K):
    """At the windows that divide 255, the kernel at n_windows_carry(w)
    windows (255 / w + 1) equals its plain version bit for bit over
    n = 2^16 - 3 points padded to 2^16, r - 1 and all ones below 2^255
    among them: every word written (the digits land on a block poisoned
    with -1 and freed just before) and the flag 0."""
    n_pad = 1 << 16
    n = n_pad - 3
    nw = msm_recode.n_windows_carry(window)
    assert nw == 255 // window + 1 == msm_recode.n_windows(window) + 1
    sc = torch.from_numpy(_recode_scalars(K, n, 100 + window).view(np.int64)).to(cuda)
    if K == 1:
        sc = sc[0]
    inf = torch.zeros(n, dtype=torch.bool, device=cuda)
    inf[5::97] = True
    poison = torch.full((nw * K, n_pad), -1, dtype=torch.int32, device=cuda)
    ptr = poison.data_ptr()
    del poison
    before = msm_recode.signed_digits_cuda.launches
    digits, overflow = msm_recode.signed_digits_cuda(sc, inf, window, n_pad, nw)
    torch.cuda.synchronize()
    assert msm_recode.signed_digits_cuda.launches == before + 1
    assert digits.data_ptr() == ptr, "the digits did not reuse the poisoned block"
    want, want_overflow = msm_recode.signed_digits(sc, inf, window, n_pad, nw)
    assert digits.shape == (nw * K, n_pad) and digits.dtype == torch.int32
    assert torch.equal(digits, want) and torch.equal(overflow, want_overflow)
    assert overflow.item() == 0 and not (digits == -1).any()
    # the default count flags r - 1, and its digits are the first windows
    short, flag = msm_recode.signed_digits_cuda(sc, inf, window, n_pad)
    assert torch.equal(short, digits[:(nw - 1) * K]) and flag.item() == 1


def test_recode_kernel_overflow_flag(cuda):
    """At window 5 (51 x 5 = 255 bits) r - 1 carries out of the top window:
    the kernel sets its flag as the plain version does, at 12 it does not,
    and g1_msm_gpu at window 5 raises the host recode's ValueError."""
    n = 1000
    sc = torch.from_numpy(_recode_scalars(1, n, 90)[0].view(np.int64)).to(cuda)
    inf = torch.zeros(n, dtype=torch.bool, device=cuda)
    for window, flagged in ((5, 1), (12, 0)):
        got = msm_recode.signed_digits_cuda(sc, inf, window, 1024)
        want = msm_recode.signed_digits(sc, inf, window, 1024)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[1].item() == flagged
    rng = np.random.default_rng(91)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, 16)])
    from falcon_r1cs_tpu_torch.snark.bls12_381 import R

    with pytest.raises(ValueError, match="top-window carry overflow"):
        gpu_msm.g1_msm_gpu(arr, [R - 1] * 16, window=5, device=cuda)


def test_recode_wrapper_refuses_bad_inputs(cuda):
    """The wrapper raises on the CPU/card mix, dtypes, shapes, n_pad and
    window counts it does not take (a count but ceil(255 / w) and
    255 // w + 1), and launches nothing."""
    sc = torch.zeros((64, 4), dtype=torch.int64, device=cuda)
    inf = torch.zeros(64, dtype=torch.bool, device=cuda)
    before = msm_recode.signed_digits_cuda.launches
    for args in ((sc, inf.cpu(), 12, 64), (sc.int(), inf, 12, 64), (sc, inf.int(), 12, 64),
                 (sc[:, :3], inf, 12, 64), (sc, inf[:32], 12, 64), (sc, inf, 12, 32),
                 (sc, inf, 0, 64), (sc.t().contiguous().t(), inf, 12, 64),
                 (sc, inf, 12, 64, 23), (sc, inf, 12, 64, 21), (sc, inf, 5, 64, 53),
                 (sc, inf, 5, 64, 50), (sc, inf, 17, 64, 17)):
        with pytest.raises(ValueError):
            msm_recode.signed_digits_cuda(*args)
    assert msm_recode.signed_digits_cuda.launches == before


def _mags(kind, W, n, seed):
    """(W, n) window-12 digit magnitudes of a key pattern aimed at the
    bucket writes (tests/test_torch_msm_bucket.py `_digits` holds the
    same patterns against the JAX package): "witness" 62 % zero, 28 % one,
    the rest spread, the top third of the windows zero; "node" runs of
    exactly max(4, n / 2048) equal keys, so that the level merging
    two-run nodes, and each above it, closes every lane twice; "root"
    three keys a window over a quarter, a half and a quarter of the
    leaves, so that the root writes three buckets in every window."""
    rng = np.random.default_rng(seed)
    half = 1 << 11
    mag = rng.integers(2, half + 1, size=(W, n))
    if kind == "witness":
        zeros, ones = round(0.62 * n), round(0.28 * n)
        u = np.stack([rng.permutation(n) for _ in range(W)])
        mag = np.where(u < zeros, 0, np.where(u < zeros + ones, 1, mag))
        mag[W - max(1, W // 3):] = 0
    elif kind == "node":
        size = max(4, n // half)
        mag = np.stack([rng.permutation(np.repeat(np.arange(n // size), size))
                        for _ in range(W)])
    elif kind == "root":
        mag = np.stack([rng.permutation(np.repeat([k, k + 1, k + 2], [n // 4, n // 2, n // 4]))
                        for k in 1 + np.arange(W) % (half - 2)])
    return torch.from_numpy(mag.astype(np.int32))


def _level_inputs(W, n, c, seed, device, kind="random"):
    """One merge level of c lanes of a W-window group over n leaves: the
    keys of sorted window-12 digits (random, or a `_mags` pattern), placed
    bit-reversed (a level of c lanes has kf = keys[:, :c], kl =
    keys[:, n - c:]); H, T (no Z at c = n: the affine leaves, kf = kl =
    the keys), the bridge and a bank of random limbs and flags (the level
    only moves them)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def limbs(*shape):
        return torch.randint(-2**12, 2**12, shape, generator=g, device=device,
                             dtype=torch.int32)

    def flags(*shape):
        return torch.randint(0, 2, shape, generator=g, device=device).bool()

    mags = (torch.randint(0, (1 << 11) + 1, (W, n), generator=g, device=device,
                          dtype=torch.int32)
            if kind == "random" else _mags(kind, W, n, seed).to(device))
    _, keys, _ = gpu_msm._sorted_leaves(mags, 12)
    nb = (1 << 11) + 1
    if c == n:
        leaves = (limbs(35, W, n), limbs(35, W, n), None, flags(W, n))
        H = T = leaves
        kf = kl = keys
    else:
        H = (limbs(35, W, c), limbs(35, W, c), limbs(35, W, c), flags(W, c))
        T = (limbs(35, W, c), limbs(35, W, c), limbs(35, W, c), flags(W, c))
        kf, kl = keys[:, :c].contiguous(), keys[:, n - c:].contiguous()
    bridge = (limbs(35, W, c // 2), limbs(35, W, c // 2), limbs(35, W, c // 2),
              flags(W, c // 2))
    bank = (*limbs(3, 35, W * nb).unbind(), flags(W * nb))
    return bridge, H, T, kf, kl, bank, nb


@pytest.mark.parametrize("W,n,c", [(22, 1 << 17, 1 << 17), (22, 1 << 17, 1 << 16),
                                   (22, 1 << 17, 2), (3, 16, 4), (1, 8, 2)])
def test_bucket_kernel_matches_plain(cuda, W, n, c):
    """One merge level, the kernel against its plain version bit for bit
    (H', T', kf', kl' and the whole bank, written only where the level
    closes a segment): level 1 (affine leaves), level 2 and the root at
    the 2^17-point group shape (22 windows), and small groups; one launch."""
    bridge, H, T, kf, kl, bank, nb = _level_inputs(W, n, c, 40 + c, cuda)
    got_bank = tuple(a.clone() for a in bank)
    before = msm_bucket.bucket_level_cuda.launches
    got = msm_bucket.bucket_level_cuda(bridge, H, T, kf, kl, got_bank, nb)
    assert msm_bucket.bucket_level_cuda.launches == before + 1
    want = msm_bucket.bucket_level(bridge, H, T, kf, kl, bank, nb)
    for g, w in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    for g, w in zip(got_bank, bank):
        assert torch.equal(g, w)


@pytest.mark.parametrize("lanes", (0,) + msm_bucket.LANE_FORMS)
@pytest.mark.parametrize("kind", ["random", "witness", "node", "root"])
def test_bucket_kernel_forms_match_plain(cuda, kind, lanes):
    """Each lanes-a-CTA form, forced through the entry's argument (0: the
    entry's choice), against the plain version bit for bit, the bank
    included: every level of a small group (3 windows, 2^10 leaves) and
    levels 6, 10 and 17 (the root) of a 22-window 2^17 group, on random
    keys and on the three patterns aimed at the bucket writes."""
    for W, n, levels in ((3, 1 << 10, range(1, 11)), (22, 1 << 17, (6, 10, 17))):
        for level in levels:
            c = n >> (level - 1)
            bridge, H, T, kf, kl, bank, nb = _level_inputs(W, n, c, 60 + level, cuda, kind)
            got_bank = tuple(a.clone() for a in bank)
            before = msm_bucket.bucket_level_cuda.launches
            got = msm_bucket.bucket_level_cuda(bridge, H, T, kf, kl, got_bank, nb, lanes)
            assert msm_bucket.bucket_level_cuda.launches == before + 1
            want = msm_bucket.bucket_level(bridge, H, T, kf, kl, bank, nb)
            for g, w in zip(got[0] + got[1] + got[2:] + got_bank,
                            want[0] + want[1] + want[2:] + bank):
                assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), \
                    (W, n, level)


def test_bucket_reduction_2_18_matches_plain(cuda, monkeypatch):
    """A whole bucket reduction of a 2^18-point group (22 windows, random
    window-12 digits over tiled points: doublings and P + (-P) in the
    tree), through the kernel (18 launches, one a level) and through its
    plain version on the same card: equal bucket planes, bit for bit."""
    from falcon_r1cs_tpu_torch.tools import msm_multi

    n = 1 << 18
    _, arr = msm_multi.tiled_points(n)
    Xm, Ym = gpu_msm._points_mont(arr, n, cuda)
    g = torch.Generator(device=cuda).manual_seed(18)
    mag = torch.randint(0, (1 << 11) + 1, (22, n), generator=g, device=cuda, dtype=torch.int32)
    neg = torch.randint(0, 2, (22, n), generator=g, device=cuda, dtype=torch.int32)
    digits = mag | ((neg & (mag != 0)) << 12)
    idx, d, s = gpu_msm._sorted_leaves(digits, 12)
    pt = gpu_msm._leaves(Xm, Ym, idx, d, s)
    nb = (1 << 11) + 1
    before = msm_bucket.bucket_level_cuda.launches
    got = gpu_msm._bucket_reduce_flat(pt, d, nb)
    assert msm_bucket.bucket_level_cuda.launches == before + 18
    monkeypatch.setattr(gpu_msm, "bucket_level_cuda", msm_bucket.bucket_level)
    want = gpu_msm._bucket_reduce_flat(pt, d, nb)
    assert msm_bucket.bucket_level_cuda.launches == before + 18
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not got[3].all()


def test_bucket_wrapper_refuses_bad_inputs(cuda):
    """The wrapper raises on the CPU/card mix, dtypes (the flags must be
    torch.bool, read as bytes), shapes, strides and lane counts it does
    not take, and launches nothing."""
    bridge, H, T, kf, kl, bank, nb = _level_inputs(2, 16, 8, 7, cuda)
    leaves = (H[0], H[1], None, H[3])
    before = msm_bucket.bucket_level_cuda.launches
    bad = [
        (bridge, H, T, kf, kl.cpu(), bank, nb),                              # device
        (bridge, H, T, kf, kl.long(), bank, nb),                             # key dtype
        (bridge, H, (T[0], T[1], T[2], T[3].int()), kf, kl, bank, nb),       # flag dtype
        (bridge[:3] + (bridge[3].to(torch.uint8),), H, T, kf, kl, bank, nb),
        (bridge, H, T, kf, kl, bank[:3] + (bank[3][:-1],), nb),              # bank shape
        (bridge, H, T, kf, kl, bank, nb + 1),
        (tuple(a[..., :2] for a in bridge), H, T, kf, kl, bank, nb),         # bridge shape
        (bridge, (H[0].transpose(1, 2).contiguous().transpose(1, 2),) + H[1:], T, kf, kl,
         bank, nb),                                                          # strides
        (bridge, leaves, T, kf, kl, bank, nb),                               # affine H only
        (tuple(a[..., :3] for a in bridge), tuple(a[..., :6] for a in H),
         tuple(a[..., :6] for a in T), kf[:, :6], kl[:, :6], bank, nb),      # c = 6
        (bridge, H, T, kf, kl, bank, nb, 3),                                 # lanes
        (bridge, H, T, kf, kl, bank, nb, 512),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            msm_bucket.bucket_level_cuda(*args)
    assert msm_bucket.bucket_level_cuda.launches == before


def test_msm_on_card_matches_native(cuda):
    """g1_msm_gpu at n = 2^12 (window 12) equals the native C MSM, and the
    K-fold form too; the point set converts once (one K4 launch); each
    MSM recodes in one launch, the K-fold one too; each runs the merge-level
    kernel once a level of its one window group (12 at 2^12 points)."""
    n = 1 << 12
    rng = np.random.default_rng(64)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, n)])
    scalars = [rng.integers(0, 2**63, size=(n, 4), dtype=np.uint64) for _ in range(2)]
    for sc in scalars:
        sc[:, 3] >>= np.uint64(2)
    k4, k6 = fq.mont_mul_cuda.launches, fq.point_add_aff_cuda.launches
    recode = msm_recode.signed_digits_cuda.launches
    bucket = msm_bucket.bucket_level_cuda.launches
    got = gpu_msm.g1_msm_gpu(arr, scalars[0], device=cuda)
    assert got == native_backend.g1_msm(arr, scalars[0])
    assert msm_bucket.bucket_level_cuda.launches == bucket + 12
    assert fq.mont_mul_cuda.launches == k4 + 1
    assert fq.point_add_aff_cuda.launches == k6 + 1
    assert msm_recode.signed_digits_cuda.launches == recode + 1
    got = gpu_msm.g1_msm_gpu_multi(arr, scalars, device=cuda)
    assert got == native_backend.g1_msm_multi(arr, np.stack(scalars))
    assert fq.mont_mul_cuda.launches == k4 + 1
    assert msm_recode.signed_digits_cuda.launches == recode + 2
    assert msm_bucket.bucket_level_cuda.launches == bucket + 24


def test_msm_half_digits_2_20_on_card(cuda):
    """g1_msm_gpu over 2^20 points tiled from 8 base points, every third
    scalar engineered so that the window-12 recode emits +2048 (and the
    window-16 patterns of the native test): equal to the native C's
    g1_msm and to the group law over the base points (half_digit_check;
    its K = 1 K-fold MSM too)."""
    from falcon_r1cs_tpu_torch.tools import msm_multi

    k4 = fq.mont_mul_cuda.launches
    out = msm_multi.half_digit_check(1 << 20, K=1, device=cuda, log=lambda *_: None)
    assert out["sums"][0] is not None
    assert fq.mont_mul_cuda.launches == k4 + 1


def test_msm_multi_half_digits_2_19_on_card(cuda):
    """g1_msm_gpu_multi at K = 2 over 2^19 tiled points with the
    half-digit scalars: equal to the native C's g1_msm_multi and to the
    group law (half_digit_check)."""
    from falcon_r1cs_tpu_torch.tools import msm_multi

    out = msm_multi.half_digit_check(1 << 19, K=2, device=cuda, log=lambda *_: None)
    assert len(out["sums"]) == 2


@pytest.fixture()
def world_one(cuda):
    """A (1, 1) mesh over NCCL at world size 1 in this process; the process
    group is destroyed after the test."""
    from falcon_r1cs_tpu_torch.parallel import make_mesh

    yield make_mesh(1, 1)
    torch.distributed.destroy_process_group()


def test_parallel_engines_world_one_on_card(cuda, world_one):
    """make_mesh(1, 1) over NCCL at world size 1, in this process: the
    sharded verify-with-NTT (also with fused_intt), dual and schoolbook
    engines, gathered, equal their single-device engines on the card on
    every segment, launching K1 2 and 4 times, K2 once and K3 once;
    ntt_sharded at D = 1 equals the clear NTT."""
    from falcon_r1cs_tpu_torch.falcon import ntt
    from falcon_r1cs_tpu_torch.parallel import (
        gather_segments,
        ntt_sharded,
        place_batch,
        sharded_engine,
        sharded_engine_dual,
        sharded_engine_schoolbook,
    )

    mesh = world_one
    assert mesh.device_type == "cuda" and torch.distributed.get_backend() == "nccl"
    arrays = [_rand((8, 512), s, "cpu") for s in (71, 72, 73)]
    signed = (arrays[0] - 6144,) + tuple(arrays[1:])
    def fused(n, mesh):
        return sharded_engine(n, mesh, fused_intt=True)

    for make, single, inputs, wrapper, launches in (
        (sharded_engine, witness_engine, arrays, cuda_ntt.ntt_with_hints_cuda, 2),
        (fused, witness_engine, arrays, cuda_ntt.intt_ntt_hints_cuda, 1),
        (sharded_engine_dual, witness_engine_dual, signed, cuda_ntt.ntt_with_hints_cuda, 4),
        (sharded_engine_schoolbook, witness_engine_schoolbook, arrays, schoolbook_prods_cuda, 1),
    ):
        blocks = place_batch(mesh, *inputs)
        before = wrapper.launches
        got = gather_segments(mesh, make(512, mesh)(*blocks))
        assert wrapper.launches == before + launches
        want = single(512)(*blocks)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    x = arrays[0].numpy()
    assert np.array_equal(ntt_sharded(mesh, FALCON_512)(arrays[0].to(cuda)).cpu().numpy(), ntt(x))


@pytest.mark.parametrize("window", [5, 12, 17])
def test_parallel_msm_world_one_on_card(cuda, world_one, window):
    """g1_msm_gpu_sharded over one rank equals the native C MSM at
    n = 2^12 - 3 (padded to 2^12) on full-width scalars below 2^255 with
    0, r - 1 and all ones below 2^255 among them, at windows 5 and 17,
    which divide 255 (the recode takes one more window: one recode
    launch), and at 12, where it also equals g1_msm_gpu."""
    n = (1 << 12) - 3
    rng = np.random.default_rng(65)
    arr = native_backend.g1_fixed_base_batch([int(x) for x in rng.integers(1, 2**62, n)])
    sc = _recode_scalars(1, n, 65 + window)[0]
    recode = msm_recode.signed_digits_cuda.launches
    got = gpu_msm.g1_msm_gpu_sharded(arr, sc, window, world_one)
    assert msm_recode.signed_digits_cuda.launches == recode + 1
    assert got == native_backend.g1_msm(arr, sc) and got is not None
    if window == gpu_msm.WINDOW:
        assert got == gpu_msm.g1_msm_gpu(arr, sc, device=cuda)


def test_dryrun_multichip_one_card(cuda):
    """dryrun_multichip(1): one spawned rank over NCCL, every sharded
    output bit-equal to the single-device engine's."""
    from falcon_r1cs_tpu_torch.entry import dryrun_multichip

    assert dryrun_multichip(1) == ["ntt DP+SP", "ntt DP", "dual DP", "schoolbook DP",
                                   "sharded CRT"]


# -- the witness map's Fr kernels (csrc/fr_mont.cu) ---------------------------

FR_LOG = 17  # a Falcon-512 proof's domain


def _fr_rows(n, seed):
    """(n, 4) int64 u64 rows below 2^256, the first ones 0, 1, r - 1, r,
    2r and 2^256 - 1 (the entry reduces them mod r)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**64, size=(n, 4), dtype=np.uint64)
    for i, v in enumerate([0, 1, fr.R - 1, fr.R, 2 * fr.R, 2**256 - 1][:n]):
        rows[i] = [(v >> (64 * k)) & (2**64 - 1) for k in range(4)]
    return torch.from_numpy(rows.view(np.int64))


def _fr_planes(n, seed, device):
    return fr.to_mont_cuda.plain(_fr_rows(n, seed)).to(device)


def _fr_value(seed, device):
    """(8, 1) planes of one random value mod r (_fr_planes(1) is 0)."""
    rng = np.random.default_rng(seed)
    return fr.planes_of([int.from_bytes(rng.bytes(32), "little") % fr.R], device)


def test_fr_kernels_match_plain(cuda):
    """The entry, exit, pointwise, power-table and transform kernels at
    2^17 against their plain versions on the same tensors of the card,
    word for word (every output canonical)."""
    n = 1 << FR_LOG
    rows = _fr_rows(n, 70).to(cuda)
    x = fr.to_mont_cuda(rows)
    assert torch.equal(x, fr.to_mont_cuda.plain(rows))
    assert torch.equal(fr.from_mont_cuda(x), fr.from_mont_cuda.plain(x))
    b, c = _fr_planes(n, 71, cuda), _fr_planes(n, 72, cuda)
    zinv = _fr_value(73, cuda)
    assert torch.equal(fr.quotient_cuda(x.clone(), b, c, zinv),
                       fr.quotient_cuda.plain(x.clone(), b, c, zinv))
    one = fr.planes_of([1], cuda)
    omega = pow(5, (fr.R - 1) >> FR_LOG, fr.R)
    sq = fr.squares_of(omega, cuda)
    tables = {}
    for mode in (fr.MODE_BITREV, fr.MODE_STAGE):
        tables[mode] = fr.powers_cuda(sq, zinv, FR_LOG, mode)
        assert torch.equal(tables[mode], fr.powers_cuda.plain(sq, zinv, FR_LOG, mode)), mode
    tw = fr.powers_cuda(sq, one, FR_LOG, fr.MODE_STAGE)
    for dif, scale in ((False, None), (True, None), (True, b)):
        got = fr.ntt_tile_cuda(x.clone(), tw, dif, scale)
        assert torch.equal(got, fr.ntt_tile_cuda.plain(x.clone(), tw, dif, scale)), (dif, scale)
    for lh in (fr.TILE_LOG, FR_LOG - 1):
        for dif in (False, True):
            got = fr.ntt_stage_cuda(x.clone(), tw, lh, dif)
            assert torch.equal(got, fr.ntt_stage_cuda.plain(x.clone(), tw, lh, dif)), (lh, dif)
    # the inverse transform scaled by 1 / n (DIF over w^-1, natural ->
    # bit-reversed), then the forward one (DIT, bit-reversed -> natural): x
    tw_inv = fr.powers_cuda(fr.squares_of(pow(omega, -1, fr.R), cuda), one, FR_LOG,
                            fr.MODE_STAGE)
    ninv = fr.powers_cuda(fr.squares_of(1, cuda), fr.planes_of([pow(n, -1, fr.R)], cuda),
                          FR_LOG, fr.MODE_BITREV)
    assert torch.equal(fr.ntt(fr.ntt(x.clone(), tw_inv, True, ninv), tw, False), x)


@pytest.mark.parametrize("log_n", list(range(1, 13)) + [17, 18, 21])
def test_fr_exit_matches_plain(cuda, log_n):
    """The exit (the Montgomery reduction alone, the rows through the
    shared-memory tile) against its plain version word for word at every
    k from 1 to 12 (tiles of s = k // 2, the middle 0 or 1 bits, up to s =
    5) and at 17, 18 (the witness maps' domains) and 21 (prove_large's)."""
    x = fr.to_mont_cuda.plain(_fr_rows(1 << log_n, 400 + log_n).to(cuda))
    assert torch.equal(fr.from_mont_cuda(x), fr.from_mont_cuda.plain(x))


@pytest.mark.parametrize("base", ["w", "g = 5"])
@pytest.mark.parametrize("mode", [fr.MODE_BITREV, fr.MODE_STAGE])
@pytest.mark.parametrize("log_n", list(range(1, 14)) + [17, 18, 21])
def test_fr_powers_matches_plain(cuda, log_n, mode, base):
    """The power tables (a CTA's tables of powers, one product an element;
    stage mode's lower segments as strides of the top one) against their
    plain version word for word, c != 1, for the root of unity w of order
    2^k (the twiddles) and the coset base 5 (the scales), at every k from 1
    to 13 (tiles from one value to 2^10 values, one CTA to 16) and at 17,
    18 (the witness maps' domains) and 21 (prove_large's)."""
    b = pow(5, (fr.R - 1) >> log_n, fr.R) if base == "w" else 5
    sq = fr.squares_of(b, cuda)
    c = _fr_value(500 + log_n, cuda)
    got = fr.powers_cuda(sq, c, log_n, mode)
    assert torch.equal(got, fr.powers_cuda.plain(sq, c, log_n, mode))


FR_ENTRY_NS = [1, 31, 32, 33, 255, 1025, 158_773]


def _fr_entry_rows(kind, n, seed):
    """(n, 4) int64 rows: `edges`, _fr_rows' (0, 1, r - 1, r, 2r, 2^256 - 1,
    then seeded full-width rows); `zeros and ones`; `one full-width a
    warp`, `one 7-word row a warp`: rows of 0 and 1, and in each run of 32
    rows g one seeded row of 8 words (the warp's straight-line product) or
    of 7 (word 7 zero: the skip, every round but the last), at lane (g + g
    // 8) mod 32, so that at n = 158,773 it stands at every lane of every
    element slot of the kernel's threads."""
    if kind == "edges":
        return _fr_rows(n, seed)
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 4), dtype=np.uint64)
    rows[:, 0] = rng.integers(0, 2, n)
    if kind != "zeros and ones":
        g = np.arange(-(-n // 32))
        at = 32 * g + (g + g // 8) % 32
        at = at[at < n]
        rows[at] = rng.integers(0, 2**64, size=(len(at), 4), dtype=np.uint64)
        if kind == "one 7-word row a warp":
            rows[at, 3] &= np.uint64(0xFFFFFFFF)
    return torch.from_numpy(rows.view(np.int64))


@pytest.mark.parametrize("kind", ["edges", "zeros and ones", "one full-width a warp",
                                  "one 7-word row a warp"])
@pytest.mark.parametrize("n", FR_ENTRY_NS)
def test_fr_entry_matches_plain(cuda, n, kind):
    """The entry (in a warp whose rows stay below word 7, a round's a b_i
    skipped where its 32 rows have that word 0) against its plain version
    word for word, at n around a warp, a CTA and the Falcon-1024 map's
    158,773 rows; on edge values, rows of 0 and 1 (one round a warp), and
    rows of 0 and 1 with one full-width or 7-word row a warp, which at
    158,773 rows stands at every lane of every element slot."""
    rows = _fr_entry_rows(kind, n, 500 + n).to(cuda)
    assert torch.equal(fr.to_mont_cuda(rows), fr.to_mont_cuda.plain(rows))
    if kind != "edges" and kind != "zeros and ones" and n == FR_ENTRY_NS[-1]:
        per_cta = fr.ENTRY_THREADS * fr.ENTRY_PER
        full = np.flatnonzero(rows.cpu().numpy()[:, 1:].any(axis=1))
        within = full % per_cta
        assert {(int(w) // fr.ENTRY_THREADS, int(w) % 32) for w in within} == {
            (j, lane) for j in range(fr.ENTRY_PER) for lane in range(32)}


def test_fr_entry_matches_plain_on_cell_b(cuda):
    """The entry on cell B's z (Falcon-512, instance seed 5: 79,411 wires,
    most of them 0 or 1) and on the u64 values of its A matrix (full-width
    field elements, -1 among them: no round skipped), word for word."""
    from falcon_r1cs_tpu_torch.r1cs.coo import compile_circuit
    from falcon_r1cs_tpu_torch.tools.profile_prove import CIRCUIT, trace_assignment

    inst = make_instance(np.random.default_rng(5), FALCON_512)
    _, z = trace_assignment(inst)
    a_vals = native_backend._compiled_cache(compile_circuit(CIRCUIT, inst, cache=False))["a"][2]
    for host in (native_backend.z_rows(z), a_vals):
        rows = torch.from_numpy(np.ascontiguousarray(host).view(np.int64)).to(cuda)
        assert torch.equal(fr.to_mont_cuda(rows), fr.to_mont_cuda.plain(rows))


@pytest.mark.parametrize("mean", [8.6, 1.33, 0.43])
def test_fr_spmv_kernel_matches_plain(cuda, mean):
    """The sparse product at the mean row lengths of A, B and C of a
    Falcon-512 proof, one row of 1,050 entries and one of 2,075 (the
    longest of a Falcon-1024 proof's A), empty rows, and instance rows
    copied from z; its rows binned by `spmv_order` (the two long rows one
    CTA each where the widest gap in the lengths puts them), into a new
    tensor and into a slice of a caller's buffer."""
    rng = np.random.default_rng(int(mean * 100))
    nrows, nz, n_out = 20000, 30000, 1 << 15
    lengths = rng.poisson(mean, nrows)
    lengths[7], lengths[8], lengths[9] = 1050, 0, 2075
    row_ptr = np.zeros(nrows + 1, dtype=np.int32)
    np.cumsum(lengths, out=row_ptr[1:])
    cols = rng.integers(0, nz, row_ptr[-1]).astype(np.int32)
    order, n_long = fr.spmv_order(row_ptr, n_out)
    assert n_long >= 2 and {7, 9} <= set(order[:n_long].tolist())
    args = (torch.from_numpy(row_ptr).to(cuda), torch.from_numpy(cols).to(cuda),
            _fr_planes(len(cols), 80, cuda), _fr_planes(nz, 81, cuda), n_out, 1025)
    bins = (torch.from_numpy(order).to(cuda), n_long)
    want = fr.spmv_cuda.plain(*args)
    assert torch.equal(fr.spmv_cuda(*args, bins=bins), want)
    buf = torch.full((3, 8, n_out), -1, dtype=torch.int32, device=cuda)
    assert fr.spmv_cuda(*args, bins=bins, out=buf[1]).data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], want) and bool((buf[0] == -1).all()) and bool((buf[2] == -1).all())


@pytest.mark.parametrize("nvec", [1, 3])
@pytest.mark.parametrize("log_n", [11, FR_LOG])
def test_fr_tile_forms_match_plain(cuda, log_n, nvec):
    """The tile kernel in its three forms, DIF with and without the scale,
    DIT, and the round trip (DIF over w^-1, the scale, DIT over w), over a
    batch of nvec vectors (one: the (8, n) form too), against the plain
    versions word for word; fr.coset_ntt over the batch against each
    vector's inverse and forward transform (fr.ntt) and, with the scale
    1 / n, giving x back."""
    n = 1 << log_n
    x = torch.stack([_fr_planes(n, 300 + v, cuda) for v in range(nvec)])
    one = fr.planes_of([1], cuda)
    omega = pow(5, (fr.R - 1) >> log_n, fr.R)
    tw = fr.powers_cuda(fr.squares_of(omega, cuda), one, log_n, fr.MODE_STAGE)
    tw_inv = fr.powers_cuda(fr.squares_of(pow(omega, -1, fr.R), cuda), one, log_n,
                            fr.MODE_STAGE)
    scale = _fr_planes(n, 310, cuda)
    forms = [(tw_inv, True, None, None), (tw_inv, True, scale, None), (tw, False, None, None),
             (tw_inv, True, scale, tw)]
    for table, dif, sc, tw_dit in forms:
        got = fr.ntt_tile_cuda(x.clone(), table, dif, sc, tw_dit)
        assert torch.equal(got, fr.ntt_tile_cuda.plain(x.clone(), table, dif, sc, tw_dit)), \
            (dif, sc is not None, tw_dit is not None)
        if nvec == 1:
            got1 = fr.ntt_tile_cuda(x[0].clone(), table, dif, sc, tw_dit)
            assert torch.equal(got1, got[0])
    got = fr.coset_ntt(x.clone(), tw_inv, tw, scale)
    for v, g in zip(x, got):  # the chain before the round trip: two transforms a vector
        assert torch.equal(fr.ntt(fr.ntt(v.clone(), tw_inv, True, scale), tw, False), g)
    ninv = fr.powers_cuda(fr.squares_of(1, cuda), fr.planes_of([pow(n, -1, fr.R)], cuda),
                          log_n, fr.MODE_BITREV)
    assert torch.equal(fr.coset_ntt(x.clone(), tw_inv, tw, ninv), x)


def test_witness_map_on_card_matches_native(cuda):
    """witness_map_gpu on the Falcon-512 verify-with-NTT circuit (domain
    2^17, a satisfying assignment and one with a wire bumped) equals the
    native C limb for limb, top coefficient included; a warm call launches
    8 + 7 x 7 = 57 kernels (a, b and c through one round-trip tile); the
    prove's h goes to the recode as it is."""
    from falcon_r1cs_tpu_torch import FALCON_512
    from falcon_r1cs_tpu_torch.r1cs.coo import compile_circuit
    from falcon_r1cs_tpu_torch.snark import gpu_qap
    from falcon_r1cs_tpu_torch.tools.profile_prove import CIRCUIT, trace_assignment

    inst = make_instance(np.random.default_rng(5), FALCON_512)
    compiled = compile_circuit(CIRCUIT, inst, cache=False)
    _, z = trace_assignment(inst)
    bad = z.copy()
    bad[2000, 0] += np.uint64(1)
    for rows in (z, bad):
        h, top = gpu_qap.witness_map_gpu(compiled, rows, cuda)
        want, want_top = native_backend.witness_map(compiled, rows)
        assert h.device.type == "cuda" and h.dtype == torch.int64
        assert np.array_equal(h.cpu().numpy().view(np.uint64), want) and top == want_top
    assert top != 0
    before = {k: w.launches for k, w in fr.KERNELS.items()}
    gpu_qap.witness_map_gpu(compiled, z, cuda)
    got = {k: w.launches - before[k] for k, w in fr.KERNELS.items()}
    assert got == {"fr_to_mont_kernel": 1, "fr_spmv_kernel": 3, "fr_ntt_tile_kernel": 2,
                   "fr_ntt_stage_kernel": 49, "fr_quotient_kernel": 1,
                   "fr_from_mont_kernel": 1, "fr_powers_kernel": 0}, got
    assert sum(got.values()) == 57


def test_fr_wrappers_reject_bad_inputs(cuda):
    x = _fr_planes(1 << 11, 90, cuda)
    tw = _fr_planes(1 << 11, 91, cuda)
    before = {k: w.launches for k, w in fr.KERNELS.items()}
    bad = [
        lambda: fr.to_mont_cuda(torch.zeros((8, 4), dtype=torch.int32, device=cuda)),
        lambda: fr.from_mont_cuda(x.long()),
        lambda: fr.from_mont_cuda(x[:, :1000].contiguous()),
        lambda: fr.ntt_tile_cuda(x[:, :1000].contiguous(), tw[:, :1000].contiguous(), True),
        lambda: fr.ntt_tile_cuda(x, tw, False, tw),
        lambda: fr.ntt_stage_cuda(x, tw, 9, True),
        lambda: fr.ntt_stage_cuda(x, tw, 11, True),
        lambda: fr.ntt_stage_cuda(x, tw.cpu(), 10, True),
        lambda: fr.quotient_cuda(x, tw, x, x),
        lambda: fr.powers_cuda(x[:, :32].contiguous(), x[:, :1].contiguous(), 31, 0),
        lambda: fr.spmv_cuda(torch.zeros(3, dtype=torch.int32, device=cuda),
                             torch.zeros(0, dtype=torch.int32, device=cuda),
                             x[:, :0].contiguous(), x, 1),
    ]
    for fn in bad:
        with pytest.raises(ValueError):
            fn()
    assert {k: w.launches for k, w in fr.KERNELS.items()} == before
