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
from falcon_r1cs_tpu_torch.witness import witness_engine

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
