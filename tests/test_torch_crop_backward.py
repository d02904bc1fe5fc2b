"""The gradient of the column crop (``batch_column_crop_backward_plain`` of
rcfd_tpu_torch/ops/crop_cuda.py, the plain version of the backward kernel
csrc/column_crop_backward.cu) against the JAX package: the feature map's
cotangent of ``jax.vjp`` of ``roi_pool_column`` on its XLA crop
(``use_pallas_crop=False``; the Pallas crop has no vjp), the variable-bin
branch. The port's pool runs its crop through a test-local
torch.autograd.Function of the plain crop forward and the plain backward,
the pair ColumnCrop runs on the card as two kernels."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import rcfd_tpu.ops.roi_pool  # noqa: E402,F401

from rcfd_tpu_torch.ops import crop_cuda, roi_pool  # noqa: E402

from torch_parity import nchw, nhwc  # noqa: E402

# the package's ops/__init__ re-exports a function named roi_pool
jax_roi = sys.modules['rcfd_tpu.ops.roi_pool']

FRAME_H, FRAME_W, BOX_W, SCALE = 64, 128, 50, 1 / 8.
# box edges in input coordinates: the first column twice (a start at 0,
# duplicated), windows inside, one reaching past W (x1 = 127), one
# starting at W (128) and one beyond it (200, clipped to W)
X1 = {'windows': np.array([[0, 0, 3.5, 40.5, 95, 127, 128, 200],
                           [17, 60, 60, 88, 33.3, 126, 1, 2.5]], np.float32),
      'one window': np.array([[5], [120]], np.float32)}


class _PlainCrop(torch.autograd.Function):
    """The crop as ColumnCrop takes it on the card, in plain PyTorch: the
    plain forward and ``batch_column_crop_backward_plain``. Keeps the
    windows' gradient it was given in ``seen``."""

    seen = []

    @staticmethod
    def forward(ctx, rows, starts, win):
        ctx.save_for_backward(starts)
        ctx.rows_shape, ctx.win = tuple(rows.shape), win
        return crop_cuda.batch_column_crop_plain(rows, starts, win)

    @staticmethod
    def backward(ctx, grad):
        starts, = ctx.saved_tensors
        _PlainCrop.seen.append(grad)
        return crop_cuda.batch_column_crop_backward_plain(
            grad, starts, ctx.rows_shape, ctx.win), None, None


def _pools(feat, x1, dtype, monkeypatch):
    """The JAX pool's vjp in ``dtype`` and the port's pool through
    _PlainCrop, from the same feature map and cotangent: (the JAX feature
    gradient, the port's, NHWC float64; the windows' gradient the port's
    crop backward took; the starts)."""
    size = (int(FRAME_H * SCALE), int(BOX_W * SCALE))
    assert not float(BOX_W * SCALE).is_integer()  # the variable-bin branch
    kw = dict(box_width=BOX_W, box_y1=0, box_y2=FRAME_H, spatial_scale=SCALE,
              output_size=size)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    out, vjp = jax.vjp(
        lambda f: jax_roi.roi_pool_column(f, jnp.asarray(x1),
                                          use_pallas_crop=False, **kw),
        jnp.asarray(feat, jdtype))
    cot = np.random.default_rng(7).standard_normal(out.shape).astype(
        np.float32)
    ref, = vjp(jnp.asarray(cot, jdtype))

    _PlainCrop.seen.clear()
    monkeypatch.setattr(roi_pool, 'batch_column_crop', _PlainCrop.apply)
    feat_t = nchw(feat).to(dtype).requires_grad_(True)
    pooled = roi_pool.roi_pool_column(feat_t, torch.from_numpy(x1), **kw)
    pooled.backward(nchw(cot).to(dtype))
    grad_windows, = _PlainCrop.seen
    starts = torch.clamp_max(roi_pool._round_half_away(
        torch.from_numpy(x1) * SCALE).to(torch.int32), feat.shape[2])
    return (np.asarray(ref.astype(jnp.float32), np.float64),
            nhwc(feat_t.grad.float()).astype(np.float64), grad_windows,
            starts)


def _term_bound(grad_windows, starts, w):
    """Per feature column, the sum of the magnitudes of the window terms a
    rows element adds (the plain backward of |grad_windows| in float64),
    its largest over the map, and the most windows over one column."""
    n = starts.shape[0]
    _, c, ph, win = grad_windows.shape
    mag = crop_cuda.batch_column_crop_backward_plain(
        grad_windows.double().abs(), starts, (n, c, ph, w), win)
    cols = torch.clamp(starts.long(), 0, w)[:, :, None] + torch.arange(win)
    over = torch.zeros((n, w + win))
    over.scatter_add_(1, cols.reshape(n, -1), torch.ones(cols.numel() // n
                                                         ).expand(n, -1))
    return float(mag.max()), int(over[:, :w].max())


@pytest.mark.parametrize('case', sorted(X1))
def test_crop_backward_matches_jax_vjp_float32(case, rng, monkeypatch):
    """float32 on both sides. An element of the rows' gradient is a sum of
    at most m window terms (m the most windows over a column), and the row
    pool's backward may add two rows' shares: each float32 addition errs
    by at most half an ulp of a partial sum, which the terms' magnitudes
    bound, so the port and JAX, adding in any order, lie within
    2 * m * 2^-24 of the largest sum of magnitudes (a few ulps of the
    gradient's max-abs); their max-abs must agree to that too."""
    x1 = X1[case]
    feat = rng.standard_normal((2, int(FRAME_H * SCALE), int(FRAME_W * SCALE),
                                3)).astype(np.float32)
    ref, got, grad_windows, starts = _pools(feat, x1, torch.float32,
                                            monkeypatch)
    bound, m = _term_bound(grad_windows, starts, feat.shape[2])
    tol = 2 * 2 * max(m, 1) * 2.0 ** -24 * bound
    assert got.shape == ref.shape == feat.shape
    assert np.abs(ref).max() > 0 and np.any(ref == 0)  # some columns unused
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)
    assert np.array_equal(got == 0, ref == 0)


def test_crop_backward_matches_jax_vjp_bf16(rng, monkeypatch):
    """bf16: the port's crop backward sums the bf16 window gradients in
    float32 and rounds once (equal bit for bit to the float32 sum of the
    same gradients rounded to bf16); JAX adds them in bf16, one window
    after another. The two lie within m bf16 roundings (2^-8 relative
    each) of the largest sum of magnitudes, where m is the most windows
    over a column plus the row pool's two shares."""
    x1 = X1['windows']
    feat = rng.standard_normal((2, int(FRAME_H * SCALE), int(FRAME_W * SCALE),
                                3)).astype(np.float32)
    ref, got, grad_windows, starts = _pools(feat, x1, torch.bfloat16,
                                            monkeypatch)
    w = feat.shape[2]
    n, (_, c, ph, win) = starts.shape[0], grad_windows.shape
    assert grad_windows.dtype == torch.bfloat16
    back = crop_cuda.batch_column_crop_backward_plain(
        grad_windows, starts, (n, c, ph, w), win)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, crop_cuda.batch_column_crop_backward_plain(
        grad_windows.float(), starts, (n, c, ph, w), win).to(torch.bfloat16))
    bound, m = _term_bound(grad_windows, starts, w)
    tol = (m + 2) * 2.0 ** -8 * bound
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_crop_backward_plain_adds_windows_in_order(dtype, rng):
    """The plain backward is the k-ordered sum: each element starts at 0
    and adds its windows' terms in ascending k in float32, columns past W
    dropped, one rounding to the gradient's dtype; duplicate starts, a
    start at 0, at W and beyond W, and windows reaching past W."""
    n, c, ph, w, win = 2, 3, 4, 11, 5
    starts = torch.tensor([[0, 0, 3, 8, 11, 15], [10, 2, 9, 9, 1, 4]],
                          dtype=torch.int32)
    k = starts.shape[1]
    grad = torch.from_numpy(rng.standard_normal(
        (n * k, c, ph, win), dtype=np.float32)).to(dtype)
    want = torch.zeros((n, c, ph, w), dtype=torch.float32)
    for i in range(n):
        for j in range(k):
            s = min(max(int(starts[i, j]), 0), w)
            for t in range(win):
                if s + t < w:
                    want[i, :, :, s + t] += grad[i * k + j, :, :, t].float()
    got = crop_cuda.batch_column_crop_backward_plain(grad, starts,
                                                     (n, c, ph, w), win)
    assert got.dtype == dtype
    assert torch.equal(got, want.to(dtype))


def test_column_crop_function_backward_on_cpu_is_the_plain_version(rng):
    """ColumnCrop.backward, the node the card's crop records, hands the
    windows' gradient to batch_column_crop_backward, which on CPU tensors
    (and only there) is the plain version: same gradient, no launch."""
    from types import SimpleNamespace

    n, c, ph, w, win = 2, 3, 4, 11, 5
    starts = torch.tensor([[0, 9, 11], [4, 4, 2]], dtype=torch.int32)
    grad = torch.from_numpy(rng.standard_normal(
        (6, c, ph, win), dtype=np.float32))
    ctx = SimpleNamespace(saved_tensors=(starts,), rows_shape=(n, c, ph, w),
                          win=win)
    before = crop_cuda.batch_column_crop_backward.launches
    got, none_starts, none_win = crop_cuda.ColumnCrop.backward(ctx, grad)
    assert none_starts is None and none_win is None
    assert torch.equal(got, crop_cuda.batch_column_crop_backward_plain(
        grad, starts, (n, c, ph, w), win))
    assert crop_cuda.batch_column_crop_backward.launches == before
