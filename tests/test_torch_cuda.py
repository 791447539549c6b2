"""Tests of the port's CUDA kernel K1 (`csrc/gather_fold.cu`) that need an
NVIDIA GPU. Without one they skip. They import no JAX, so on the card they
run without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from racformer_tpu_torch.ops import gather_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, dtype, S=3, R=40, Wp=36, C=64, K=4096, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = torch.randn(S, R, Wp, 2 * C, generator=g, device=dev).to(dtype)
    row = torch.randint(0, R, (S, K), generator=g, device=dev, dtype=torch.int32)
    x0p = torch.randint(0, Wp - 1, (S, K), generator=g, device=dev,
                        dtype=torch.int32)
    wx, wy = (torch.rand(S, K, generator=g, device=dev) for _ in range(2))
    wl = torch.randn(S, K, generator=g, device=dev)
    return fused, row, x0p, wx, wy, wl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fold,C", [(1, 64), (4, 64), (5, 128)])
def test_kernel_matches_plain(cuda, dtype, fold, C):
    args = _inputs(cuda, dtype, C=C, K=4000)
    before = gather_kernel.LAUNCHES
    got = gather_kernel.patch_sample_fold(*args, fold)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES == before + 1
    want = gather_kernel.patch_sample_fold_reference(*args, fold)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:  # one bf16 output rounding plus reordered f32 sums
        bound = 1e-2 * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=bound)


@pytest.mark.cuda
def test_force_reference_routes_to_plain(cuda):
    args = _inputs(cuda, torch.float32)
    before = gather_kernel.LAUNCHES
    with gather_kernel.force_reference():
        got = gather_kernel.patch_sample_fold(*args, 4)
    assert gather_kernel.LAUNCHES == before
    torch.testing.assert_close(
        got, gather_kernel.patch_sample_fold_reference(*args, 4))


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda):
    fused, row, x0p, wx, wy, wl = _inputs(cuda, torch.float32)
    with pytest.raises(TypeError):
        gather_kernel.patch_sample_fold(fused.half(), row, x0p, wx, wy, wl, 4)
    with pytest.raises(TypeError):
        gather_kernel.patch_sample_fold(fused, row.long(), x0p, wx, wy, wl, 4)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(
            fused, row, x0p, wx.t().contiguous().t(), wy, wl, 4)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(fused, row, x0p, wx.cpu(), wy, wl, 4)
