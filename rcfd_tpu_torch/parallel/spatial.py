"""Row sharding of FusionNet's train step over a 2-D (data x spatial) mesh:
the mechanism of rcfd_tpu_torch/parallel/gspmd.py.

A rank of a mesh of n_data x n_spatial ranks holds one block of the
global batch: the samples of its data index and, of every map the step
makes, the contiguous rows its spatial index owns (``split_rows``: as even
as possible, the first ranks a row more; a rank may own none). Each level
of the network has its own partition of its own height.

- Rows another rank owns. Before an op reads rows it does not own (a
  convolution's, a pool's or a resize's window, a flip's mirror rows, a
  loss's next row) the rank moves them in (``window``), from whichever
  ranks own them, in one all_gather in its spatial group (the ranks that
  hold the same samples) of each rank's rows that others need, padded to
  the longest. The backward sends the rows' gradients back the same way
  and adds them on their owners. Only the rows an op reads move: a halo
  where each shard owns at least the halo, more where a neighbour owns few
  rows or none. The frame's true edges keep the single-device padding
  (zeros for a convolution, -inf for a max pool, the border value for
  outlier removal's min pool, the edge row for the smoothness loss's
  replicate pad).
- Whole-batch reductions. Batch norm's per-channel sums and sums of
  squares, the loss's sums and counts, and the inputs' maxima reduce over
  the whole mesh; a contrast's image mean over the spatial group. A
  differentiable reduction is an all_reduce SUM whose backward
  all_reduces the gradient (``all_reduce_sum``), so that each rank's
  backward of loss / mesh size gives its share of the global loss's
  gradient; the shares' SUM over the mesh is that gradient.

Every rank runs the same collectives in the same order, forward and
backward: an op whose output block is empty on a rank still joins each
collective, and its empty output stays tied to the op's inputs and
weights (``_empty``), so that autograd reaches the same collectives on
every rank (it runs a graph's nodes in the reverse order of their
creation).

The single-process modules stay as they are: the functions here walk the
same modules (their parameters, buffers and options) with the sharded ops.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as TF

from ..data import transport
from ..data.transforms import _INT32_MAX, _blend, _rgb_to_grayscale
from ..models import losses
from ..nn import functional as F


def split_rows(h: int, n: int):
    """The (start, end) rows of each of ``n`` shards of ``h`` rows:
    contiguous, as even as possible, the first ``h % n`` one row more."""
    base, rem = divmod(h, n)
    out, a = [], 0
    for s in range(n):
        b = a + base + (s < rem)
        out.append((a, b))
        a = b
    return out


def _overlap(x, y):
    lo, hi = max(x[0], y[0]), min(x[1], y[1])
    return (lo, hi) if lo < hi else None


@dataclasses.dataclass(eq=False)
class Mesh2D:
    """A rank's place in a 2-D (data x spatial) mesh
    (``gspmd.get_mesh_2d`` makes it): its (data, spatial) index, the
    process group of the whole mesh, of its spatial row (the ranks that
    share its samples) and of its data column. ``exchanged`` counts, by a
    map's height, the rows this rank received from others and the rows
    each all_gather moved to it, padding included (forward only)."""
    n_data: int
    n_spatial: int
    data_index: int
    spatial_index: int
    group: object
    spatial_group: object
    data_group: object
    exchanged: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    def rows(self, h: int):
        """This rank's (start, end) rows of a map of ``h`` rows."""
        return split_rows(h, self.n_spatial)[self.spatial_index]


def _all_gather(t, group):
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _rows_of(parts, length, like):
    """``parts`` (N, C, r, W) concatenated along the rows and padded with
    zero rows to ``length``."""
    n, c, _, w = like.shape
    got = sum(p.shape[2] for p in parts)
    return torch.cat(list(parts) + [like.new_zeros(n, c, length - got, w)], 2)


class _Window(torch.autograd.Function):
    """Rows [lo, hi) of a sharded map (``window``)."""

    @staticmethod
    def forward(ctx, x, mesh, h, needs):
        n, me = mesh.n_spatial, mesh.spatial_index
        owned = split_rows(h, n)
        # segs[s][t]: the rows rank t needs from rank s
        segs = [[_overlap(needs[t], owned[s]) if s != t else None
                 for t in range(n)] for s in range(n)]
        length = [[0 if seg is None else seg[1] - seg[0] for seg in row]
                  for row in segs]
        longest = max(sum(row) for row in length)
        a = owned[me][0]
        gathered = None
        if longest:
            gathered = _all_gather(_rows_of(
                [x[:, :, lo - a:hi - a] for lo, hi in filter(None, segs[me])],
                longest, x), mesh.spatial_group)
            got = sum(length[s][me] for s in range(n))
            count = mesh.exchanged.setdefault(h, [0, 0])
            count[0] += got
            count[1] += longest * (n - 1)
        pieces = []
        for s in range(n):
            if s == me:
                own = _overlap(needs[me], owned[me])
                if own is not None:
                    pieces.append(x[:, :, own[0] - a:own[1] - a])
            elif length[s][me]:
                off = sum(length[s][:me])
                pieces.append(gathered[s][:, :, off:off + length[s][me]])
        ctx.geometry = (mesh, owned, segs, length, needs)
        ctx.x_shape = x.shape
        if not pieces:
            return x.new_empty(x.shape[0], x.shape[1], 0, x.shape[3])
        return torch.cat(pieces, 2)

    @staticmethod
    def backward(ctx, g):
        mesh, owned, segs, length, needs = ctx.geometry
        n, me = mesh.n_spatial, mesh.spatial_index
        a = owned[me][0]
        gx = g.new_zeros(ctx.x_shape)
        back, start = [], 0
        for s in range(n):
            if s == me:
                own = _overlap(needs[me], owned[me])
                if own is not None:
                    gx[:, :, own[0] - a:own[1] - a] += \
                        g[:, :, start:start + own[1] - own[0]]
                    start += own[1] - own[0]
            elif length[s][me]:
                back.append(g[:, :, start:start + length[s][me]])
                start += length[s][me]
        longest = max(sum(length[s][t] for s in range(n)) for t in range(n))
        if longest:
            gathered = _all_gather(_rows_of(back, longest, gx),
                                   mesh.spatial_group)
            for t in range(n):
                seg = segs[me][t]
                if seg is not None:
                    off = sum(length[s][t] for s in range(me))
                    gx[:, :, seg[0] - a:seg[1] - a] += \
                        gathered[t][:, :, off:off + length[me][t]]
        return gx, None, None, None


def window(mesh: Mesh2D, x, h: int, needs):
    """This rank's rows ``needs[me]`` = [lo, hi) of a map of ``h`` rows
    held row-sharded over the spatial group (``x`` (N, C, rows, W) its own
    rows), where ``needs[t]`` is rank t's [lo, hi) within [0, h) (empty:
    lo >= hi); every rank of the group calls it with the same ``needs``.
    Differentiable: the backward adds each row's gradient on its owner."""
    return _Window.apply(x, mesh, h, needs)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """The SUM of ``x`` over ``group``; its gradient is the SUM of the
    ranks' gradients."""
    return _AllReduceSum.apply(x, group)


def all_max(mesh: Mesh2D, x):
    """The largest value of ``x`` over the whole mesh (-inf where no rank
    holds a value), as a 0-d tensor; not differentiable."""
    m = x.detach().amax() if x.numel() else \
        torch.tensor(float('-inf'), dtype=x.dtype, device=x.device)
    m = m.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    return m


def _empty(shape, *inputs):
    """An empty output block of ``shape`` tied to ``inputs`` in the graph
    (each enters it times 0), so that the backward reaches the collectives
    behind them on this rank too."""
    like = inputs[0]
    tie = sum(t.sum() for t in inputs) * 0
    return like.new_zeros(shape) + tie.to(like.dtype)


# ---------------------------------------------------------------------------
# Sharded ops: each takes and returns (this rank's rows, the global height)
# ---------------------------------------------------------------------------

def _reads(mesh, h, h_out, first, last):
    """Each rank's input rows [lo, hi) (clipped to [0, h)) for its output
    rows of a map of ``h_out`` rows, where output rows [o0, o1) read input
    rows [first(o0), last(o1 - 1)); (0, 0) for an empty block."""
    return [(max(first(o0), 0), min(last(o1 - 1), h)) if o1 > o0 else (0, 0)
            for o0, o1 in split_rows(h_out, mesh.n_spatial)]


def _strided(mesh, x, h, k, stride, pad, value):
    """The rows a (k, stride, pad) window over the rows reads for this
    rank's output rows, the true edges padded with ``value``: (rows, the
    output's height, whether this rank's output block is empty)."""
    h_out = (h + 2 * pad - k) // stride + 1
    win = window(mesh, x, h, _reads(mesh, h, h_out,
                                    lambda o: o * stride - pad,
                                    lambda o: o * stride - pad + k))
    o0, o1 = split_rows(h_out, mesh.n_spatial)[mesh.spatial_index]
    if o1 == o0:
        return win, h_out, True
    top = max(pad - o0 * stride, 0)
    bottom = max((o1 - 1) * stride - pad + k - h, 0)
    if top or bottom:
        win = TF.pad(win, (0, 0, top, bottom), value=value)
    return win, h_out, False


def batch_norm(mesh: Mesh2D, bn, x, h: int):
    """Training batch norm (nn.layers.BatchNorm2d in training mode) over
    the global batch: per-channel sums and sums of squares all-reduced over
    the mesh, mean and biased variance E[x^2] - mean^2 over the global
    count (the JAX package's ``batch_norm_train_stats``), the running
    statistics moved by momentum toward the mean and the unbiased variance
    of the global count, the normalization by ``batch_norm_apply`` (in
    bf16 with bf16 scale and shift for a bf16 input, as the JAX package)."""
    c = x.shape[1]
    xs = x.to(torch.promote_types(torch.float32, x.dtype))
    sums = all_reduce_sum(torch.cat([xs.sum((0, 2, 3)),
                                     (xs * xs).sum((0, 2, 3))]), mesh.group)
    n = x.shape[0] * mesh.n_data * h * x.shape[3]
    mean = sums[:c] / n
    var = sums[c:] / n - mean * mean
    m = bn.momentum
    with torch.no_grad():
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var +
                             m * (var * (n / max(n - 1, 1))))
        bn.num_batches_tracked.add_(1)
    return F.batch_norm_apply(x, bn.weight, bn.bias, mean, var, bn.eps)


def _finish(mesh, y, h, bias, bn, activation):
    if bias is not None:
        y = y + bias.to(y.dtype)[:, None, None]
    if bn is not None:
        y = batch_norm(mesh, bn, y, h)
    if activation is not None:
        y = activation(y)
    return y


def conv(mesh: Mesh2D, m, x, h: int):
    """An nn.layers.Conv2d (convolution, batch norm, activation)."""
    w = m.conv.weight.to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    win, h_out, empty = _strided(mesh, x, h, kh, m.stride, kh // 2, 0.0)
    if empty:
        w_out = (x.shape[3] + 2 * (kw // 2) - kw) // m.stride + 1
        y = _empty((x.shape[0], w.shape[0], 0, w_out), win, w)
    else:
        y = TF.conv2d(win, w, stride=m.stride, padding=(0, kw // 2))
    return _finish(mesh, y, h_out, m.conv.bias, m.batch_norm,
                   m.activation), h_out


def max_pool(mesh: Mesh2D, x, h: int, k: int, stride: int, pad: int):
    """``F.max_pool2d`` (-inf padding)."""
    win, h_out, empty = _strided(mesh, x, h, k, stride, pad, float('-inf'))
    if empty:
        w_out = (x.shape[3] + 2 * pad - k) // stride + 1
        return _empty((x.shape[0], x.shape[1], 0, w_out), win), h_out
    return TF.max_pool2d(win, k, stride, (0, pad)), h_out


def up_conv(mesh: Mesh2D, m, x, h: int, shape):
    """An nn.layers.UpConv2d: the nearest resize to ``shape`` (``src =
    dst * in // out``, as ``F.resize_nearest``) and its Conv2d, in one
    exchange of the input rows that the conv's resized rows read."""
    c = m.conv
    w = c.conv.weight.to(x.dtype)
    k, kw = w.shape[2], w.shape[3]
    p = k // 2
    out_h, out_w = int(shape[0]), int(shape[1])

    def resized(o0, o1):
        return max(o0 - p, 0), min(o1 - 1 - p + k, out_h)

    outs = split_rows(out_h, mesh.n_spatial)
    needs = []
    for o0, o1 in outs:
        r0, r1 = resized(o0, o1)
        needs.append((r0 * h // out_h, (r1 - 1) * h // out_h + 1)
                     if o1 > o0 else (0, 0))
    win = window(mesh, x, h, needs)
    o0, o1 = outs[mesh.spatial_index]
    if o1 == o0:
        y = _empty((x.shape[0], w.shape[0], 0, out_w), win, w)
    else:
        r0, r1 = resized(o0, o1)
        rows = torch.arange(r0, r1, device=x.device) * h // out_h - \
            needs[mesh.spatial_index][0]
        y = win.index_select(2, rows)
        if out_w != x.shape[3]:
            cols = torch.arange(out_w, device=x.device) * x.shape[3] // out_w
            y = y.index_select(3, cols)
        top, bottom = max(p - o0, 0), max(o1 - 1 - p + k - out_h, 0)
        if top or bottom:
            y = TF.pad(y, (0, 0, top, bottom))
        y = TF.conv2d(y, w, padding=(0, kw // 2))
    return _finish(mesh, y, out_h, c.conv.bias, c.batch_norm,
                   c.activation), out_h


def transpose_conv(mesh: Mesh2D, m, x, h: int):
    """An nn.layers.TransposeConv2d (stride 2, padding p = k // 2, output
    padding 1: 2h rows). Output row o takes the input rows i with 2i + r -
    p = o, r in [0, k): this rank's rows [o0, o1) read input rows
    [ceil((o0 + p - k + 1) / 2), (o1 - 1 + p) // 2 + 1); the transposed
    convolution of input rows [lo, hi), unpadded along the rows, holds
    output row o at 2 lo - p + o's place."""
    w = m.deconv.weight.to(x.dtype)
    k, kw = w.shape[2], w.shape[3]
    p = k // 2
    h_out = 2 * h

    def first(o):
        return -((k - 1 - p - o) // 2)

    needs = _reads(mesh, h, h_out, first, lambda o: (o + p) // 2 + 1)
    win = window(mesh, x, h, needs)
    o0, o1 = split_rows(h_out, mesh.n_spatial)[mesh.spatial_index]
    if o1 == o0:
        y = _empty((x.shape[0], w.shape[1], 0, 2 * x.shape[3]), win, w)
    else:
        lo = needs[mesh.spatial_index][0]
        full = TF.conv_transpose2d(win, w, stride=2, padding=(0, kw // 2),
                                   output_padding=(0, 1))
        y = full[:, :, o0 - 2 * lo + p:o1 - 2 * lo + p]
    return _finish(mesh, y, h_out, m.deconv.bias, m.batch_norm,
                   m.activation), h_out


def resize_bilinear(mesh: Mesh2D, x, h: int, shape):
    """``F.resize_bilinear_align_corners`` (the same float32 coordinates,
    rows then columns); the identity at equal size."""
    out_h, out_w = int(shape[0]), int(shape[1])
    if (out_h, out_w) == (h, x.shape[3]):
        return x, h
    y0, y1, _ = F._align_corners_coords(out_h, h, 'cpu')
    y0, y1 = y0.tolist(), y1.tolist()
    needs = [(y0[o0], y1[o1 - 1] + 1) if o1 > o0 else (0, 0)
             for o0, o1 in split_rows(out_h, mesh.n_spatial)]
    win = window(mesh, x, h, needs)
    o0, o1 = split_rows(out_h, mesh.n_spatial)[mesh.spatial_index]
    if o1 == o0:
        return _empty((x.shape[0], x.shape[1], 0, out_w), win), out_h
    lo = needs[mesh.spatial_index][0]
    y0, y1, wy = (t[o0:o1] for t in F._align_corners_coords(out_h, h,
                                                             x.device))
    top, bot = win.index_select(2, y0 - lo), win.index_select(2, y1 - lo)
    rows = top + wy.to(x.dtype)[:, None] * (bot - top)
    x0, x1, wx = F._align_corners_coords(out_w, x.shape[3], x.device)
    left, right = rows.index_select(3, x0), rows.index_select(3, x1)
    return left + wx.to(x.dtype) * (right - left), out_h


def _same_height(a, b):
    if a != b:
        raise RuntimeError('Sizes of tensors must match except in dimension '
                           '1: a map of {} rows joins one of {}'.format(a, b))
    return a


# ---------------------------------------------------------------------------
# FusionNet (models/fusionnet.py, models/networks.py) over the sharded ops
# ---------------------------------------------------------------------------

def resnet_block(mesh, m, x, h):
    """An nn.layers.ResNetBlock."""
    y, h_out = conv(mesh, m.conv1, x, h)
    y, h_out = conv(mesh, m.conv2, y, h_out)
    shortcut = conv(mesh, m.projection, x, h)[0] if m.use_projection else x
    return m.activation(y + shortcut), h_out


def _blocks(mesh, blocks, x, h):
    for block in blocks:
        x, h = resnet_block(mesh, block, x, h)
    return x, h


def resnet_encoder(mesh, m, x, h):
    """A networks.ResNetEncoder: (latent, skips), each (rows, height)."""
    y, h = conv(mesh, m.conv1, x, h)
    layers = [(y, h)]
    for i, name in enumerate(m.stage_names):
        if i == 0:
            y, h = max_pool(mesh, y, h, 3, 2, 1)
        y, h = _blocks(mesh, getattr(m, name), y, h)
        layers.append((y, h))
    return layers[-1], layers[:-1]


def _fuse(mesh, m, stage, fi, fd, h):
    ft = m.fusion_type
    if ft == 'add':
        return conv(mesh, getattr(m, 'conv{}_project'.format(stage)), fd,
                    h)[0] + fi
    if ft == 'weight':
        w = conv(mesh, getattr(m, 'conv{}_weight'.format(stage)), fd, h)[0]
        return w * fd + fi
    if ft == 'weight_and_project':
        w = conv(mesh, getattr(m, 'conv{}_weight'.format(stage)), fd, h)[0]
        p = conv(mesh, getattr(m, 'conv{}_project'.format(stage)), fd,
                 h)[0]
        return w * p + fi
    if stage == 1:
        return torch.cat([fd, fi], dim=1)
    return torch.cat([fi, fd], dim=1)


def fusionnet_encoder(mesh, m, image, depth, h):
    """A networks.FusionNetEncoder: (latent, skips), each (rows, height)."""
    fi, hi = conv(mesh, m.conv1_image, image, h)
    fd, _ = conv(mesh, m.conv1_depth, depth, h)
    layers = [(_fuse(mesh, m, 1, fi, fd, hi), hi)]
    for i in range(1, m.n_stages):
        stage = i + 1
        if i == 1:
            fi, h_next = max_pool(mesh, fi, hi, 3, 2, 1)
            fd, _ = max_pool(mesh, fd, hi, 3, 2, 1)
            hi = h_next
        fi, h_next = _blocks(mesh, getattr(m, 'blocks{}_image'.format(stage)),
                             fi, hi)
        fd, _ = _blocks(mesh, getattr(m, 'blocks{}_depth'.format(stage)), fd,
                        hi)
        hi = h_next
        layers.append((_fuse(mesh, m, stage, fi, fd, hi), hi))
    return layers[-1], layers[:-1]


def decoder_block(mesh, m, x, h, skip=None, shape=None):
    """An nn.layers.DecoderBlock; ``skip`` (rows, height) or None."""
    if m.deconv_type == 'transpose':
        y, h_out = transpose_conv(mesh, m.deconv, x, h)
    else:
        if skip is not None:
            size = (skip[1], skip[0].shape[3])
        elif shape is not None:
            size = shape
        else:
            size = (2 * h, 2 * x.shape[3])
        y, h_out = up_conv(mesh, m.deconv, x, h, size)
    if m.skip_channels > 0:
        y = torch.cat([y, skip[0]], 1)
        _same_height(h_out, skip[1])
    return conv(mesh, m.conv, y, h_out)


def decoder(mesh, m, latent, skips, shape):
    """A networks.MultiScaleDecoder: its outputs, each (rows, height),
    from the coarsest to output0."""
    x, h = latent
    n = len(skips) - 1
    outputs = []
    side = None
    for name in m.block_names:
        block = getattr(m, name)
        if name == 'deconv0' and m.upsample_output:
            return outputs + [side]
        skip = skips[n] if n >= 0 else None
        if side is not None:
            skip = side if skip is None else (
                torch.cat([skip[0], side[0]], 1),
                _same_height(skip[1], side[1]))
        if skip is not None:
            x, h = decoder_block(mesh, block, x, h, skip=skip)
        else:
            x, h = decoder_block(mesh, block, x, h, shape=tuple(shape))
        n -= 1
        head = m.heads.get(name)
        if head is not None:
            out, _ = conv(mesh, getattr(m, head), x, h)
            outputs.append((out, h))
            side = resize_bilinear(mesh, out, h, (2 * h, 2 * x.shape[3]))
    return outputs + [conv(mesh, m.output0, x, h)]


def fusionnet_forward(mesh, model, image, input_depth, h):
    """FusionNetModel's forward of this rank's rows of a batch of ``h``
    rows: output0 (rows of depth in [min, max])."""
    if model.image_only:
        latent, skips = resnet_encoder(mesh, model.encoder, image, h)
    else:
        latent, skips = fusionnet_encoder(mesh, model.encoder, image,
                                          input_depth, h)
    out, _ = decoder(mesh, model.decoder, latent, skips,
                     (h, image.shape[3]))[-1]
    return model.min_predict_depth / (
        torch.sigmoid(out) +
        model.min_predict_depth / model.max_predict_depth)


# ---------------------------------------------------------------------------
# The train step's inputs and loss (fusionnet_main.TrainStep)
# ---------------------------------------------------------------------------

def augment(mesh, transforms, draws, images, range_maps, h):
    """``Transforms.apply`` of this rank's rows (images and range maps
    NHWC, the draws of its samples): the truncation test over the global
    batch, the contrast's grayscale mean over each image's rows, flips
    (the vertical one mirrors rows across shards). Returns (images,
    [maps]) in NCHW."""
    width = images.shape[2]
    truncate = all_max(mesh, images) > 1.0
    images = torch.where(truncate, torch.floor(images), images)
    bound = torch.where(truncate, _INT32_MAX, 1.0).to(images.dtype)
    for name in transforms.ranges:
        gate = draws[name + '_gate'][:, None, None, None]
        f = draws[name + '_factor'].to(images.dtype)[:, None, None, None]
        if name == 'brightness':
            other = torch.zeros_like(images)
        elif name == 'contrast':
            other = all_reduce_sum(_rgb_to_grayscale(images, truncate).sum(
                (1, 2, 3), keepdim=True), mesh.spatial_group) / (h * width)
        else:
            other = _rgb_to_grayscale(images, truncate)
        images = torch.where(gate, _blend(images, other, f, truncate, bound),
                             images)
    maps = [t.permute(0, 3, 1, 2)
            for t in [transforms._normalize(images)] + list(range_maps)]
    if 'horizontal_flip' in draws:
        gate = draws['horizontal_flip'][:, None, None, None]
        maps = [torch.where(gate, t.flip(3), t) for t in maps]
    if 'vertical_flip' in draws:
        gate = draws['vertical_flip'][:, None, None, None]
        stacked = torch.cat(maps, 1)
        mirror = window(mesh, stacked, h, [
            (h - b, h - a) for a, b in split_rows(h, mesh.n_spatial)]).flip(2)
        stacked = torch.where(gate, mirror, stacked)
        maps = list(stacked.split([t.shape[1] for t in maps], 1))
    return maps[0], maps[1:]


def outlier_removal(mesh, depth, h, kernel_size, threshold):
    """``F.outlier_removal``: the min pool's border and empty pixels are 10
    times the global batch's largest depth."""
    max_value = 10.0 * all_max(mesh, depth)
    filled = torch.where(depth > 0.0, depth, max_value)
    p = kernel_size // 2
    win, _, empty = _strided(mesh, filled, h, kernel_size, 1, p,
                             float(max_value))
    if empty:
        return depth
    min_values = -TF.max_pool2d(-TF.pad(win, (p, p), value=float(max_value)),
                                kernel_size, 1)
    return torch.where(min_values < depth - threshold,
                       torch.zeros((), dtype=depth.dtype,
                                   device=depth.device), depth)


def train_inputs(mesh, step, batch, draws, h):
    """``TrainStep.inputs`` of this rank's block (NHWC transport, its
    samples' draws): (image, input_depth, ground_truth, lidar_map,
    validity), NCHW rows."""
    image, depth, response, ground_truth, lidar_map = (
        transport.decode(t) for t in batch)
    image, (depth, response, ground_truth, lidar_map) = augment(
        mesh, step.transforms, draws, image,
        [depth, response, ground_truth, lidar_map], h)
    k = step.dilation_kernel_size
    if k > 1:
        ground_truth, _ = max_pool(mesh, ground_truth, h, k, 1, k // 2)
    if step.outlier_kernel_size > 1 and step.outlier_threshold > 0:
        ground_truth = outlier_removal(mesh, ground_truth, h,
                                       step.outlier_kernel_size,
                                       step.outlier_threshold)
    validity = torch.where(ground_truth > 0, 0.0, 1.0).to(
        ground_truth.dtype)
    image = image.contiguous()
    input_depth = torch.cat([depth, response], 1).contiguous()
    if step.compute_dtype is not None:
        image = image.to(step.compute_dtype)
        input_depth = input_depth.to(step.compute_dtype)
    return image, input_depth, ground_truth, lidar_map, validity


def _halo(mesh, x, h, p):
    """This rank's rows and ``p`` more on each side (clipped), and the
    rows missing at the frame's top and bottom edges."""
    win = window(mesh, x, h, [(max(a - p, 0), min(b + p, h)) if b > a
                              else (0, 0)
                              for a, b in split_rows(h, mesh.n_spatial)])
    a, b = mesh.rows(h)
    return win, max(p - a, 0), max(b + p - h, 0)


def _smoothness_sums(mesh, predict, image, h):
    """``losses.smoothness_loss_func``'s two sums over this rank's rows,
    and their global counts."""
    pdx = predict[..., :, :-1] - predict[..., :, 1:]
    idx = image[..., :, :-1] - image[..., :, 1:]
    wx = torch.exp(-idx.abs().mean(1, keepdim=True))
    # the row differences need the next rank's first row
    win = window(mesh, torch.cat([predict, image], 1), h, [
        (a, min(b + 1, h)) if b > a else (0, 0)
        for a, b in split_rows(h, mesh.n_spatial)])
    p, im = win[:, :predict.shape[1]], win[:, predict.shape[1]:]
    pdy = p[:, :, :-1] - p[:, :, 1:]
    idy = im[:, :, :-1] - im[:, :, 1:]
    wy = torch.exp(-idy.abs().mean(1, keepdim=True))
    n, c, w = predict.shape[0] * mesh.n_data, predict.shape[1], \
        predict.shape[3]
    return ((wx * pdx.abs()).sum(), (wy * pdy.abs()).sum(),
            n * c * h * (w - 1), n * c * (h - 1) * w)


def _sobel_sums(mesh, predict, image, weights, h, k):
    """``losses.sobel_smoothness_loss_func``'s two sums over this rank's
    rows (filter k x k) and their global count."""
    p = k // 2
    win, top, bottom = _halo(mesh, predict, h, p)
    gray = (image[:, 0] * 0.30 + image[:, 1] * 0.59 +
            image[:, 2] * 0.11)[:, None]
    gwin, gtop, gbottom = _halo(mesh, gray, h, 1)
    count = predict.shape[0] * mesh.n_data * predict.shape[1] * h * \
        predict.shape[3]
    if predict.shape[2] == 0:
        tie = win.sum() * 0 + gwin.sum() * 0
        return tie, tie, count
    padded = TF.pad(win, (p, p, top, bottom), mode='replicate')
    gx, gy = losses.sobel_filter((1, 1, k, k))
    predict_dy = losses._conv_single(padded, gy)
    predict_dx = losses._conv_single(padded, gx)
    gpadded = TF.pad(gwin, (1, 1, gtop, gbottom), mode='replicate')
    gx_i, gy_i = losses.sobel_filter((1, 1, 3, 3))
    wy = torch.exp(-losses._conv_single(gpadded, gy_i).abs().mean(
        1, keepdim=True))
    wx = torch.exp(-losses._conv_single(gpadded, gx_i).abs().mean(
        1, keepdim=True))
    return ((weights * wx * predict_dx.abs()).sum(),
            (weights * wy * predict_dy.abs()).sum(), count)


def _error(loss_func, diff):
    if loss_func == 'l1':
        return diff.abs()
    if loss_func == 'l2':
        return diff ** 2
    if loss_func == 'smoothl1':
        d = diff.abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise ValueError('No such loss: {}'.format(loss_func))


def compute_loss(mesh, step, image, output, ground_truth, lidar_map,
                 validity, h):
    """``FusionNetModel.compute_loss`` of TrainStep's one output (output0,
    the ground truth's size): every mean is a global sum over a global
    count, all reduced in one collective. Returns (loss, loss_info), the
    same on every rank."""
    if step.w_lidar_loss > 0.0:
        ground_truth = torch.where(lidar_map > 0.0,
                                   torch.zeros_like(ground_truth),
                                   ground_truth)
    valid_gt = (ground_truth > 0).to(ground_truth.dtype)
    valid_lidar = (lidar_map > 0).to(lidar_map.dtype)
    err = _error(step.loss_func, output - ground_truth)
    terms = [(err * valid_gt.to(err.dtype)).sum(), valid_gt.sum()]
    if step.w_lidar_loss > 0.0:
        err = _error(step.loss_func, output - lidar_map)
        terms += [(err * valid_lidar.to(err.dtype)).sum(), valid_lidar.sum()]
    if step.w_smoothness > 0.0:
        k = step.loss_smoothness_kernel_size
        if k <= 1:
            sx, sy, count_x, count_y = _smoothness_sums(mesh, output, image,
                                                        h)
        else:
            sx, sy, count_x = _sobel_sums(mesh, output, image, validity, h,
                                          k)
            count_y = count_x
        terms += [sx, sy]
    dtype = terms[0].dtype
    total = all_reduce_sum(torch.stack([t.to(dtype) for t in terms]),
                           mesh.group)
    loss_supervised = total[0] / torch.clamp_min(total[1], 1.0)
    loss_lidar, loss_smoothness = 0.0, 0.0
    i = 2
    if step.w_lidar_loss > 0.0:
        loss_lidar = total[2] / torch.clamp_min(total[3], 1.0)
        i = 4
    if step.w_smoothness > 0.0:
        term = (total[i] / count_x).to(output.dtype) + \
            (total[i + 1] / count_y).to(output.dtype)
        if step.loss_smoothness_kernel_size > 1:
            k = step.loss_smoothness_kernel_size
            term = term / float(k * k)
        loss_smoothness = term
    loss = loss_supervised + step.w_smoothness * loss_smoothness + \
        step.w_lidar_loss * loss_lidar
    return loss, {'loss': loss, 'loss_supervised': loss_supervised,
                  'loss_smoothness': loss_smoothness,
                  'loss_lidar': loss_lidar}


def train_loss(mesh, step, batch, draws, h):
    """TrainStep.loss of this rank's block: (global loss, loss_info)."""
    image, input_depth, ground_truth, lidar_map, validity = train_inputs(
        mesh, step, batch, draws, h)
    output = fusionnet_forward(mesh, step.model, image, input_depth, h)
    return compute_loss(mesh, step, image, output, ground_truth, lidar_map,
                        validity, h)


def sum_gradients(mesh, parameters):
    """Replace each parameter's gradient by its SUM over the mesh, in one
    flat all_reduce; a parameter keeps no gradient (None) where no rank has
    one."""
    params = list(parameters)
    like = params[0]
    flat = torch.cat([p.grad.reshape(-1) if p.grad is not None else
                      like.new_zeros(p.numel()) for p in params] +
                     [like.new_tensor([float(p.grad is not None)
                                       for p in params])])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    offset = 0
    flags = flat[-len(params):].tolist()
    for p, flag in zip(params, flags):
        p.grad = flat[offset:offset + p.numel()].view_as(p).clone() \
            if flag else None
        offset += p.numel()
