"""Tests of the port's CUDA kernels that need an NVIDIA GPU: K1
(`csrc/gather_fold.cu`) and the training samplers' K2-K4
(`csrc/patch_gather.cu`, `patch_scatter.cu`, `patch_corner_grads.cu`), each
against its plain PyTorch version in each map dtype (float32, bfloat16,
float16), plus `force_reference()` routing and the wrappers' rejection of
inputs the kernels do not take. Without a GPU they
skip. They import no JAX, so on the card they run without the repository's
conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from racformer_tpu_torch.ops import gather_kernel

# the map dtypes of K1-K4: bf16 is the main path's, float16 a config's choice
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def rounding_tol(dtype):
    """The tolerance for one output rounding to a 16-bit dtype on each side:
    1e-2 for bf16 (2^-7 steps), scaled by float16's epsilon (2^-10)."""
    return 1e-2 * torch.finfo(dtype).eps / torch.finfo(torch.bfloat16).eps


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


def _fold_layout(args, layout):
    """K1 inputs of one layout (see `test_kernel_matches_plain`)."""
    fused, row, x0p, wx, wy, wl = args
    S, R, Wp, _ = fused.shape
    idx = torch.arange(row.shape[1], device=row.device)
    i32 = torch.int32
    if layout == "last":  # the last row and the last readable column
        row = torch.where(idx % 3 == 0, R - 1, row).to(i32).contiguous()
        x0p = torch.where(idx % 2 == 0, Wp - 2, x0p).to(i32).contiguous()
    elif layout == "border":  # every corner in the zero border
        fused = fused.clone()
        fused[:, :, :2] = 0
        fused[:, :, -2:] = 0
        x0p = torch.where(idx % 2 == 0, 0, Wp - 2).to(i32).expand_as(row)
        x0p = x0p.contiguous()
    elif layout == "wl0":  # zero weight on every other point
        wl = torch.where(idx % 2 == 0, 0.0, wl).contiguous()
    elif layout == "clustered":  # 90% of the points in 5% of the rows
        g = torch.Generator(device=row.device).manual_seed(1)
        hot = torch.randint(0, R, (S, max(1, R // 20)), generator=g,
                            device=row.device)
        pick = torch.randint(0, hot.shape[1], row.shape, generator=g,
                             device=row.device)
        move = torch.rand(row.shape, generator=g, device=row.device) < 0.9
        row = torch.where(move, torch.gather(hot, 1, pick), row).to(i32)
        row = row.contiguous()
    return fused, row, x0p, wx, wy, wl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fold,C,K,layout", [
    (1, 64, 4000, "uniform"), (4, 64, 4000, "uniform"),
    (5, 128, 4000, "uniform"), (3, 64, 3999, "uniform"),
    (33, 64, 33 * 41, "uniform"), (40, 64, 4000, "uniform"),
    (4, 64, 4, "uniform"), (4, 64, 44, "uniform"), (4, 64, 4000, "last"),
    (4, 64, 4000, "border"), (4, 64, 4000, "wl0"), (4, 64, 4000, "clustered")])
def test_kernel_matches_plain(cuda, dtype, fold, C, K, layout):
    """K1 against its plain version: folds that divide the warp tile's 32
    points and folds that do not (3, 5), one output spanning two or more
    windows of 32 points (33, 40), one output per slab (K = fold), 11
    outputs per slab (a ragged tile of 8), the last row and column, every
    point on the zero border (exactly zero), zero weights and clustered
    rows."""
    args = _fold_layout(_inputs(cuda, dtype, C=C, K=K), layout)
    before = gather_kernel.LAUNCHES
    got = gather_kernel.patch_sample_fold(*args, fold)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES == before + 1
    want = gather_kernel.patch_sample_fold_reference(*args, fold)
    assert got.dtype == dtype and got.shape == want.shape
    if layout == "border":
        assert not want.any() and not got.any()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:  # one 16-bit output rounding plus reordered f32 sums
        tol = rounding_tol(dtype)
        bound = tol * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
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
        gather_kernel.patch_sample_fold(fused.double(), row, x0p, wx, wy, wl,
                                        4)
    with pytest.raises(TypeError):
        gather_kernel.patch_sample_fold(fused, row.long(), x0p, wx, wy, wl, 4)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(
            fused, row, x0p, wx.t().contiguous().t(), wy, wl, 4)
    with pytest.raises(ValueError):
        gather_kernel.patch_sample_fold(fused, row, x0p, wx.cpu(), wy, wl, 4)


def _points(dev, dtype, S=3, R=40, Wp=36, C=64, K=4096, seed=0):
    """A map and K points per slab with ~20% of them clamped into the zero
    border (and some on its edge), as the samplers produce them."""
    from racformer_tpu_torch.ops.bilinear import PAD, corner_coords

    g = torch.Generator(device=dev).manual_seed(seed)
    H, W = R + 1 - 2 * PAD, Wp - 2 * PAD
    fused = torch.randn(S, R, Wp, 2 * C, generator=g, device=dev)
    fused[:, :, :PAD] = 0.0
    fused[:, :, W + PAD:] = 0.0
    fused = fused.to(dtype)
    x = torch.rand(S, K, generator=g, device=dev) * (W + 6) - 3.0
    y = torch.rand(S, K, generator=g, device=dev) * (H + 6) - 3.0
    far = torch.rand(S, K, generator=g, device=dev) < 0.1
    x = torch.where(far, x * 50.0, x)
    x0p, y0p, wx, wy = corner_coords(x, y, H, W, dtype)
    cot = torch.randn(S, K, C, generator=g, device=dev).to(dtype)
    return fused, y0p.contiguous(), x0p.contiguous(), wx, wy, cot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,K", [(64, 4000), (128, 777), (64, 30000),
                                 (16, 3000), (32, 2000)])
def test_patch_kernels_match_plain(cuda, dtype, C, K):
    """K2, K3 and K4 against their plain versions. f32: the same f32
    arithmetic up to the order of the sums (K3 sums each column's terms in
    bucket order); bf16 and f16: one output rounding in K2 and K3, reordered f32
    sums in K3 / K4. C = 16 and 32 (embed_dims 64 and 128 at 4 groups) leave
    lanes of K3's warps without a channel pair."""
    from racformer_tpu_torch.ops import scatter_kernel

    fused, row, x0p, wx, wy, g = _points(cuda, dtype, C=C, K=K)
    counts = (gather_kernel.GATHER_LAUNCHES, scatter_kernel.LAUNCHES,
              gather_kernel.CORNER_LAUNCHES)
    out = gather_kernel.patch_gather(fused, row, x0p, wx, wy)
    dmap = scatter_kernel.patch_scatter(g, row, x0p, wx, wy, fused.shape)
    dwx, dwy = gather_kernel.patch_corner_grads(fused, g, row, x0p, wx, wy)
    torch.cuda.synchronize()
    assert (gather_kernel.GATHER_LAUNCHES, scatter_kernel.LAUNCHES,
            gather_kernel.CORNER_LAUNCHES) == tuple(c + 1 for c in counts)
    want = gather_kernel.patch_gather_reference(fused, row, x0p, wx, wy)
    want_map = scatter_kernel.patch_scatter_reference(g, row, x0p, wx, wy,
                                                      fused.shape)
    want_wx, want_wy = gather_kernel.patch_corner_grads_reference(
        fused, g, row, x0p, wx, wy)
    assert out.dtype == dtype and dmap.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5)
    else:
        tol = rounding_tol(dtype)
        bound = tol * want.float().abs().max().item()
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=bound)
    _assert_map_grad_close(dmap, want_map)
    for got, ref in ((dwx, want_wx), (dwy, want_wy)):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * ref.abs().max().item())


def _assert_map_grad_close(got, want):
    """K3 against its plain version. Both sum the same f32 terms, in another
    order (K3's register and tile sums), and round the sum to the map dtype
    once. f32: 1e-5 of max(1, max|want|). bf16 and f16: the two f32 sums
    may round to neighbouring values, one step apart, at most eps |want|
    (2^-7 bf16, 2^-10 f16), plus 1e-5 max|want| where terms cancel to near
    zero."""
    assert got.dtype == want.dtype and got.shape == want.shape
    dtype = want.dtype
    got, want = got.float(), want.float()
    top = want.abs().max().item()
    err = (got - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5 * max(1.0, top)
    else:
        eps = torch.finfo(dtype).eps
        assert bool((err <= eps * want.abs() + 1e-5 * top).all())


def _edge_points(dev, dtype, case, S=3, R=40, Wp=36, C=64, K=5000):
    """K3 inputs of one edge case (see `test_patch_scatter_edge_cases`)."""
    fused, row, x0p, wx, wy, g = _points(dev, dtype, S=S, R=R, Wp=Wp, C=C, K=K)
    if case == "one_row":
        row = torch.full_like(row, R // 3)
    elif case == "all_outside":  # every corner clamped into the zero border
        x0p = torch.where(torch.arange(K, device=dev) % 2 == 0, 0, Wp - 2)
        x0p = x0p.to(torch.int32).expand(S, K).contiguous()
    elif case == "empty_rows":  # only every fourth row holds points
        row = (row // 4 * 4).contiguous()
    elif case == "hot_column":  # a third of the points in one row and column
        hot = torch.arange(K, device=dev) % 3 == 0
        row = torch.where(hot, R // 2, row).to(torch.int32).contiguous()
        x0p = torch.where(hot, 0, x0p).to(torch.int32).contiguous()
    return fused, row, x0p, wx, wy, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,K", [("one_row", 5000), ("all_outside", 5000),
                                    ("empty_rows", 5000), ("hot_column", 5000),
                                    ("ragged", 1),
                                    ("ragged", 511), ("ragged", 4097)])
def test_patch_scatter_edge_cases(cuda, dtype, case, K):
    """K3 against its plain version: all points in one row (one bucket holds
    the slab, cut over several tiles), every point in the border, empty rows
    between full ones, a hot row whose points share one column, and point
    counts that are not multiples of the kernels' block and tile sizes."""
    from racformer_tpu_torch.ops import scatter_kernel

    fused, row, x0p, wx, wy, g = _edge_points(cuda, dtype, case, K=K)
    got = scatter_kernel.patch_scatter(g, row, x0p, wx, wy, fused.shape)
    torch.cuda.synchronize()
    want = scatter_kernel.patch_scatter_reference(g, row, x0p, wx, wy,
                                                  fused.shape)
    _assert_map_grad_close(got, want)
    offsets, records = scatter_kernel.bucket_by_row(row, x0p, wx, wy,
                                                    fused.shape[1])
    want_off, want_perm = scatter_kernel.bucket_by_row_reference(
        row, fused.shape[1])
    # the bucketing is stable: each bucket lists its points in ascending order
    assert torch.equal(offsets, want_off)
    assert torch.equal(records[:, 0], want_perm)
    p = want_perm.long()  # each record carries its point's inputs
    assert torch.equal(records[:, 1], x0p.reshape(-1)[p] + (row.reshape(-1)[p] << 16))
    assert torch.equal(records[:, 2].view(torch.float32), wx.reshape(-1)[p])
    assert torch.equal(records[:, 3].view(torch.float32), wy.reshape(-1)[p])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_patch_scatter_is_repeatable(cuda, dtype):
    """K3 adds without atomics: each accumulator element has one owner that
    adds its terms in the (stable) bucket order, and a hot row's tile pieces
    are summed in tile order, so two runs on the same inputs, hot rows
    included, are bitwise equal."""
    from racformer_tpu_torch.ops import scatter_kernel

    fused, row, x0p, wx, wy, g = _points(cuda, dtype, K=30000)
    row = torch.where(torch.arange(30000, device=cuda) % 3 == 0, 7, row)
    row = row.to(torch.int32).contiguous()
    runs = [scatter_kernel.patch_scatter(g, row, x0p, wx, wy, fused.shape)
            for _ in range(3)]
    assert all(torch.equal(r, runs[0]) for r in runs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,K,C", [(1, 1, 64), (3, 31, 64), (2, 32, 64),
                                   (3, 33, 64), (1, 1057, 128), (2, 77, 8),
                                   (2, 45, 24), (3, 70, 72), (8, 100000, 64)])
def test_gather_kernels_tiling_tails(cuda, dtype, S, K, C):
    """K1, K2 and K4 against their plain versions where the point tiling of
    `csrc/point_tiles.cuh` has edges: a last warp tile of 1, 31, 32 or 33
    points of the flattened S x K (K1: of its outputs, at the largest of
    folds 4, 3 and 1 that divides K), channel counts below one lane group's
    64 (idle lanes) and past it (a second, partial pass), and more tiles
    than the grid has warps."""
    fused, row, x0p, wx, wy, g = _points(cuda, dtype, S=S, C=C, K=K)
    fold = next(f for f in (4, 3, 1) if K % f == 0)
    wl = torch.randn(S, K, device=cuda)
    out = gather_kernel.patch_gather(fused, row, x0p, wx, wy)
    dwx, dwy = gather_kernel.patch_corner_grads(fused, g, row, x0p, wx, wy)
    folded = gather_kernel.patch_sample_fold(fused, row, x0p, wx, wy, wl, fold)
    torch.cuda.synchronize()
    want = gather_kernel.patch_gather_reference(fused, row, x0p, wx, wy)
    want_folded = gather_kernel.patch_sample_fold_reference(fused, row, x0p, wx,
                                                            wy, wl, fold)
    for got, ref in ((out, want), (folded, want_folded)):
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
        else:
            tol = rounding_tol(dtype)
            bound = tol * ref.float().abs().max().item()
            torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                       atol=bound)
    for got, ref in zip((dwx, dwy), gather_kernel.patch_corner_grads_reference(
            fused, g, row, x0p, wx, wy)):
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, ref.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_kernels_refuse_what_16_byte_loads_cannot_take(cuda, dtype):
    """K1, K2 and K4 read 16 bytes per lane: a contiguous map or cotangent
    view at a storage offset that is not 16-byte aligned, or a C that is not
    a multiple of 16 bytes' channels (8 bf16 or f16, 4 f32), raises rather than
    falling back, and launches nothing."""
    fused, row, x0p, wx, wy, g = _points(cuda, dtype, K=100)
    wl = torch.randn(row.shape, device=cuda)
    counts = (gather_kernel.LAUNCHES, gather_kernel.GATHER_LAUNCHES,
              gather_kernel.CORNER_LAUNCHES)
    shifted = torch.empty(fused.numel() + 1, dtype=dtype, device=cuda)[1:]
    shifted = shifted.view(fused.shape).copy_(fused)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_kernel.patch_sample_fold(shifted, row, x0p, wx, wy, wl, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_kernel.patch_gather(shifted, row, x0p, wx, wy)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_kernel.patch_corner_grads(shifted, g, row, x0p, wx, wy)
    g_shifted = torch.empty(g.numel() + 1, dtype=dtype, device=cuda)[1:]
    g_shifted = g_shifted.view(g.shape).copy_(g)
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_kernel.patch_corner_grads(fused, g_shifted, row, x0p, wx, wy)
    C = 62 if dtype == torch.float32 else 60  # even, not a multiple of 4 / 8
    narrow, row, x0p, wx, wy, g = _points(cuda, dtype, C=C, K=100)
    with pytest.raises(ValueError, match="multiple of"):
        gather_kernel.patch_sample_fold(narrow, row, x0p, wx, wy, wl, 4)
    with pytest.raises(ValueError, match="multiple of"):
        gather_kernel.patch_gather(narrow, row, x0p, wx, wy)
    with pytest.raises(ValueError, match="multiple of"):
        gather_kernel.patch_corner_grads(narrow, g, row, x0p, wx, wy)
    assert (gather_kernel.LAUNCHES, gather_kernel.GATHER_LAUNCHES,
            gather_kernel.CORNER_LAUNCHES) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_corner_grads_are_repeatable(cuda, dtype):
    """K4 sums each point's channels in a fixed order (per lane, then the
    lane group's butterfly) without atomics: two runs are bitwise equal."""
    fused, row, x0p, wx, wy, g = _points(cuda, dtype, K=30000)
    runs = [gather_kernel.patch_corner_grads(fused, g, row, x0p, wx, wy)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_patch_sample_grads_on_card(cuda):
    """`patch_sample_op` forward and backward on the card against the same
    function on the CPU (plain versions)."""
    from racformer_tpu_torch.ops.bilinear import patch_sample

    fused, row, x0p, wx, wy, g = _points(cuda, torch.float32, K=5000)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        f, a, b = (t.detach().to(dev).clone().requires_grad_()
                   for t in (fused, wx, wy))
        out = patch_sample(f, row.to(dev), x0p.to(dev), a, b)
        (out * g.to(dev)).sum().backward()
        grads.append([out.detach().cpu(), f.grad.cpu(), a.grad.cpu(),
                      b.grad.cpu()])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_patch_force_reference_and_bad_inputs(cuda):
    from racformer_tpu_torch.ops import scatter_kernel

    fused, row, x0p, wx, wy, g = _points(cuda, torch.float32)
    counts = (gather_kernel.GATHER_LAUNCHES, scatter_kernel.LAUNCHES,
              gather_kernel.CORNER_LAUNCHES)
    with gather_kernel.force_reference():
        gather_kernel.patch_gather(fused, row, x0p, wx, wy)
        scatter_kernel.patch_scatter(g, row, x0p, wx, wy, fused.shape)
        gather_kernel.patch_corner_grads(fused, g, row, x0p, wx, wy)
    assert (gather_kernel.GATHER_LAUNCHES, scatter_kernel.LAUNCHES,
            gather_kernel.CORNER_LAUNCHES) == counts
    with pytest.raises(TypeError):
        gather_kernel.patch_gather(fused.double(), row, x0p, wx, wy)
    with pytest.raises(TypeError):
        scatter_kernel.patch_scatter(g, row.long(), x0p, wx, wy, fused.shape)
    with pytest.raises(ValueError):
        gather_kernel.patch_corner_grads(fused, g[:, :-1], row, x0p, wx, wy)
    with pytest.raises(ValueError):
        gather_kernel.patch_gather(fused, row, x0p, wx.t().contiguous().t()
                                   [:, :], wy.cpu())
