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
from falcon_r1cs_tpu_torch.ops import _build, cuda_ntt
from falcon_r1cs_tpu_torch.ops.schoolbook import schoolbook_prods_cuda
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
    x = _rand((64, params.n), 31, cuda)
    x[0, :3] = torch.tensor([0, Q - 1, Q - 1], dtype=torch.int32)
    before = cuda_ntt.ntt_with_hints_cuda.launches
    for got, want in zip(
        cuda_ntt.ntt_with_hints_cuda(x, params),
        cuda_ntt.ntt_with_hints_cuda.plain(x, params),
    ):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert cuda_ntt.ntt_with_hints_cuda.launches == before + 1
    for got, want in zip(
        cuda_ntt.intt_ntt_hints_cuda(x, params),
        cuda_ntt.intt_ntt_hints_cuda.plain(x, params),
    ):
        assert got.dtype == want.dtype and torch.equal(got, want)
    torch.cuda.synchronize()


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
