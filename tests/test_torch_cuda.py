"""The CUDA kernels of rcfd_tpu_torch on the card, against their plain
versions. These tests need a CUDA device and skip without one. They import
no JAX, so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn import PerfConfig, init_parameters  # noqa: E402
from rcfd_tpu_torch.ops import crop_cuda as cc  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip as fs  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip_variants as fv  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402

from torch_parity import (FUSIONNET_TINY, H, RADARNET_TINY,  # noqa: E402
                          RADARNET_WIDE, SCATTER_CASES, W, frame_and_points,
                          scatter_case, scattered_crops, unexplained_depth)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device, rng):
    for name in SCATTER_CASES:
        crops, x, z, valid, h, w, patch = scatter_case(name, rng)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (crops, x, z, valid)]
        before = sc.scatter_quasi_dense.launches
        d, r = sc.scatter_quasi_dense(*args, h, w, patch)
        d_p, r_p = sc.scatter_quasi_dense_plain(*args, h, w, patch)
        torch.cuda.synchronize()
        assert sc.scatter_quasi_dense.launches == before + 1
        assert torch.equal(d, d_p) and torch.equal(r, r_p), name


def _strip_inputs(rng, device, k, pw, w, offset, ph=23,
                  dtype=torch.float32):
    """Scatter inputs for the edges of the row-strip kernel: an odd number of
    rows (a ragged last strip), windows at both aprons (x at the first and
    last column and clipped beyond both), pairs of points inside one 2^-14
    step in overlapping windows (one pair across the 1,024-point list
    chunk when k > 1,024), values of exactly 0.5 and just below, invalid
    points, and integer depths equal to later indices. The crops, of
    ``dtype``, start ``offset`` elements past an allocation, so offset 1
    is not aligned to 4 of them (bf16 rounds the pairs to exact ties)."""
    crops = rng.random((k, ph, pw), dtype=np.float32)
    x = rng.integers(0, w, k).astype(np.float32)
    x[:4] = [0, w - 1, -pw - 40, w + pw + 40]
    first = list(range(4, k - 1, 5)) + ([1023] if k > 1024 else [])
    for i in first:
        x[i + 1] = x[i] + i % 3
        crops[i + 1] = np.nextafter(crops[i], np.float32(1))
    crops[4, :, : pw // 2] = 0.5
    crops[5, :, pw // 2:] = np.float32(0.5) - np.float32(1e-7)
    z = (rng.random(k, dtype=np.float32) * 79 + 1).astype(np.float32)
    z[[0, 2, 4]] = [3.0, 6.5, 8.0]
    valid = rng.random(k) > 0.1
    valid[-2:] = False
    flat = torch.empty(k * ph * pw + offset, device=device, dtype=dtype)
    crops_t = flat[offset:].view(k, ph, pw)
    crops_t.copy_(torch.from_numpy(crops))
    return (crops_t,) + tuple(torch.from_numpy(a).to(device)
                              for a in (x + pw // 2, z, valid))


def _counts():
    """The launch counts of both instances of every serving kernel."""
    return {name + suffix: getattr(wrapper, 'launches' + suffix)
            for name, wrapper in (('K1', sc.scatter_quasi_dense),
                                  ('K2', cc.batch_column_crop),
                                  ('K3', fs.fused_skip_gather_add))
            for suffix in ('', '_bf16')}


def _launched(before, **expect):
    """The counts since ``before`` (a _counts()) equal ``expect`` (e.g.
    K1_bf16=1), and every other count is unchanged."""
    return {key: n - before[key] for key, n in _counts().items()} == \
        {key: expect.get(key, 0) for key in before}


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('k, w', [(9, 640), (1100, 640), (9, 12000)])
@pytest.mark.parametrize('pw', [16, 30, 288])
def test_scatter_strip_edges_on_card(cuda_device, rng, pw, k, w, offset):
    """pw 16 and 288 take the 16-byte branch (with aligned crops), pw 30 and
    offset 1 the scalar one; w 12000 needs more than 48 KB of shared memory
    a block."""
    args = _strip_inputs(rng, cuda_device, k, pw, w, offset)
    h, patch = 27, tuple(args[0].shape[1:])
    before = sc.scatter_quasi_dense.launches
    d, r = sc.scatter_quasi_dense(*args, h, w, patch)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args, h, w, patch)
    torch.cuda.synchronize()
    assert sc.scatter_quasi_dense.launches == before + 1
    assert torch.equal(d, d_p) and torch.equal(r, r_p)
    assert bool((r > 0).any()) and bool((d > 0).any())


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_cuda_tensors(cuda_device, rng):
    crops, x, z, valid, h, w, patch = scatter_case('random', rng)
    c, xs, zs, v = [torch.from_numpy(a).to(cuda_device)
                    for a in (crops, x, z, valid)]
    with pytest.raises(ValueError, match='contiguous'):
        sc.scatter_quasi_dense(c.transpose(1, 2).contiguous().transpose(
            1, 2), xs, zs, v, h, w, patch)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            sc.scatter_quasi_dense(c.to(dtype), xs, zs, v, h, w, patch)
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c, xs.double(), zs, v, h, w, patch)
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c, xs.to(torch.bfloat16), zs, v, h, w, patch)
    with pytest.raises(ValueError):
        sc.scatter_quasi_dense(c, xs.cpu(), zs, v, h, w, patch)


def _gather_add_inputs(rng, device, n=2, k=5, co=3, ph=7, pw=6, wg=40):
    t = lambda a: torch.from_numpy(a).to(device)
    starts = rng.integers(0, wg - pw + 1, (n, k)).astype(np.int32)
    starts[0, 0], starts[-1, -1] = 0, wg - pw  # both edges
    return (t(rng.standard_normal((n * k, co, ph, pw), dtype=np.float32)),
            t(rng.standard_normal((n, co, ph, wg), dtype=np.float32)),
            t(starts),
            t(rng.standard_normal((n * k, co, ph), dtype=np.float32)),
            t(rng.standard_normal((n * k, co, ph), dtype=np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize('pw', [2, 6, 37])
def test_fused_skip_kernel_matches_plain_on_card(cuda_device, rng, pw):
    args = _gather_add_inputs(rng, cuda_device, pw=pw)
    before = fs.fused_skip_gather_add.launches
    out = fs.fused_skip_gather_add(*args)
    ref = fs.fused_skip_gather_add_plain(*args)
    torch.cuda.synchronize()
    assert fs.fused_skip_gather_add.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_fused_skip_wrapper_refuses_bad_cuda_tensors(cuda_device, rng):
    a, cg, starts, cl, cr = _gather_add_inputs(rng, cuda_device)
    with pytest.raises(ValueError, match='contiguous'):
        fs.fused_skip_gather_add(a, cg, starts, cl.transpose(1, 2)
                                 .contiguous().transpose(1, 2), cr)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            fs.fused_skip_gather_add(a.to(dtype), cg.to(dtype), starts, cl,
                                     cr)
    with pytest.raises(NotImplementedError):  # a and cg of two dtypes
        fs.fused_skip_gather_add(a.to(torch.bfloat16), cg, starts, cl, cr)
    with pytest.raises(NotImplementedError):  # bf16 corrections
        fs.fused_skip_gather_add(a.to(torch.bfloat16),
                                 cg.to(torch.bfloat16), starts,
                                 cl.to(torch.bfloat16), cr)
    with pytest.raises(NotImplementedError):
        fs.fused_skip_gather_add(a, cg, starts.long(), cl, cr)
    with pytest.raises(ValueError):
        fs.fused_skip_gather_add(a, cg.cpu(), starts, cl, cr)


def _crop_inputs(rng, device, n=2, k=6, c=3, ph=5, w=29):
    starts = rng.integers(0, w, (n, k)).astype(np.int32)
    starts[0, :3] = [-4, w, w + 9]  # clipped to 0, w and w
    return (torch.from_numpy(rng.standard_normal(
        (n, c, ph, w), dtype=np.float32)).to(device),
        torch.from_numpy(starts).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize('win', [1, 15, 43])
def test_column_crop_kernel_matches_plain_on_card(cuda_device, rng, win):
    rows, starts = _crop_inputs(rng, cuda_device)
    before = cc.batch_column_crop.launches
    out = cc.batch_column_crop(rows, starts, win)
    ref = cc.batch_column_crop_plain(rows, starts, win)
    torch.cuda.synchronize()
    assert cc.batch_column_crop.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_column_crop_wrapper_refuses_bad_cuda_tensors(cuda_device, rng):
    rows, starts = _crop_inputs(rng, cuda_device)
    with pytest.raises(ValueError, match='contiguous'):
        cc.batch_column_crop(rows.transpose(2, 3).contiguous()
                             .transpose(2, 3), starts, 7)
    with pytest.raises(NotImplementedError):
        cc.batch_column_crop(rows.double(), starts, 7)
    with pytest.raises(NotImplementedError):
        cc.batch_column_crop(rows, starts.long(), 7)
    with pytest.raises(ValueError):
        cc.batch_column_crop(rows, starts.cpu(), 7)


def _variant_inputs(rng, device, dtype, n=2, k=5, co=3, ph=7, pw=16, wg=64):
    """fused skip variant inputs with starts at both edges and at starts
    that are not multiples of a 16-byte vector (4 or 8 elements)."""
    t = lambda a, d=dtype: torch.from_numpy(a).to(device=device, dtype=d)
    starts = rng.integers(0, wg - pw + 1, (n, k)).astype(np.int32)
    starts[0, :4] = [0, wg - pw, 5, 13]
    starts[-1, -1] = wg - pw - 3
    return (t(rng.standard_normal((n * k, co, ph, pw), dtype=np.float32)),
            t(rng.standard_normal((n, co, ph, wg), dtype=np.float32)),
            t(starts, torch.int32),
            t(rng.standard_normal((n * k, co, ph), dtype=np.float32),
              torch.float32),
            t(rng.standard_normal((n * k, co, ph), dtype=np.float32),
              torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('pw', [8, 24])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('variant', fv.VARIANTS)
def test_fused_skip_variant_matches_plain_on_card(cuda_device, rng, variant,
                                                  dtype, pw):
    args = _variant_inputs(rng, cuda_device, getattr(torch, dtype), pw=pw)
    wrapper = fv.WRAPPERS[variant]
    before = wrapper.launches
    out = wrapper(*args)
    ref = fv.PLAIN[variant](*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.dtype == args[0].dtype
    assert torch.equal(out, ref)
    if variant in ('full', 'align16'):
        assert torch.equal(out, fs.fused_skip_gather_add_plain(*args))


@pytest.mark.cuda
def test_fused_skip_variant_wrappers_refuse_bad_cuda_tensors(cuda_device,
                                                             rng):
    a, cg, starts, cl, cr = _variant_inputs(rng, cuda_device, torch.float32)
    # rows of a and out of 6 float32 elements: not 16-byte aligned
    a6, cg6, starts6, cl6, cr6 = _variant_inputs(rng, cuda_device,
                                                 torch.float32, pw=6)
    with pytest.raises(ValueError, match='16-byte'):
        fv.align16(a6, cg6, starts6, cl6, cr6)
    fv.full(a6, cg6, starts6, cl6, cr6)  # the scalar full takes them
    # rows of cg of 62 elements
    with pytest.raises(ValueError, match='16-byte'):
        fv.align16(a, cg[..., :62].contiguous(), starts, cl, cr)
    # a at an address 4 bytes past a 16-byte boundary
    shifted = torch.empty(a.numel() + 1, device=cuda_device)[1:].view(
        a.shape)
    shifted.copy_(a)
    with pytest.raises(ValueError, match='16-byte'):
        fv.align16(shifted, cg, starts, cl, cr)
    with pytest.raises(ValueError, match='contiguous'):
        fv.align16(a.transpose(2, 3).contiguous().transpose(2, 3), cg,
                   starts, cl, cr)
    with pytest.raises(NotImplementedError):
        fv.align16(a.half(), cg.half(), starts, cl, cr)
    with pytest.raises(ValueError):
        fv.align16(a, cg.cpu(), starts, cl, cr)


@pytest.mark.cuda
def test_codec_encode_on_card(cuda_device, rng):
    """uint16 codes of CUDA tensors equal the CPU path's, and floor(x * 256)
    / floor(x * 2^14) of the float values."""
    dense = (rng.random((5, 7)) * 99 + 1).astype(np.float32)
    quasi = np.floor(rng.random((5, 7)) * 80).astype(np.float32)
    resp = rng.random((5, 7)).astype(np.float32)
    ts = [torch.from_numpy(x) for x in (dense, quasi, resp)]
    out = pipeline.codec_encode(*[t.to(cuda_device) for t in ts])
    ref = pipeline.codec_encode(*ts)
    for o, r, x, m in zip(out, ref, (dense, quasi, resp),
                          (256.0, 256.0, 2.0 ** 14)):
        assert o.dtype == torch.uint16 and o.is_cuda
        codes = o.cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(codes, r.numpy().astype(np.int64))
        np.testing.assert_array_equal(
            codes, np.floor(x.astype(np.float64) * m).astype(np.int64))


def _batched_scatter_inputs(rng, device, b, k, pw, offset, ph=23, w=640,
                            dtype=torch.float32):
    """Inputs of the batched scatter: B frames of K points with windows at
    and beyond both aprons, a pair of points inside one 2^-14 step in one
    window, values of exactly 0.5, integer depths that cascade through the
    legacy rewrite, random padding, and (B > 1) a last frame with no valid
    point. The crops, of ``dtype``, start ``offset`` elements past an
    allocation, so offset 1 is not aligned to 4 of them (the scalar
    branch)."""
    crops = rng.random((b, k, ph, pw), dtype=np.float32)
    x = rng.integers(-pw - 40, w + pw + 40, (b, k)).astype(np.float32)
    x[:, 0] = rng.integers(0, w, b)  # point 0 lands in the frame
    z = (rng.random((b, k), dtype=np.float32) * 79 + 1).astype(np.float32)
    if k > 1:
        x[:, 1] = x[:, 0]
        crops[:, 1] = np.nextafter(crops[:, 0], np.float32(1))
        z[:, 0] = 1.0  # point 0's depth is point 1's index
    crops[:, 0, :, :pw // 2] = 0.5
    valid = rng.random((b, k)) > 0.1
    valid[:, 0] = True
    if b > 1:
        valid[-1] = False
    flat = torch.empty(b * k * ph * pw + offset, device=device, dtype=dtype)
    crops_t = flat[offset:].view(b, k, ph, pw)
    crops_t.copy_(torch.from_numpy(crops))
    return (crops_t,) + tuple(torch.from_numpy(a).to(device)
                              for a in (x + pw // 2, z, valid))


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('pw', [288, 30])
@pytest.mark.parametrize('k', [1, 64])
@pytest.mark.parametrize('b', [1, 3, 16])
def test_batched_scatter_matches_plain_on_card(cuda_device, rng, b, k, pw,
                                               offset):
    """One launch over B frames against the batched plain version and
    against the single-frame kernel frame by frame, bit for bit."""
    args = _batched_scatter_inputs(rng, cuda_device, b, k, pw, offset)
    h, w, patch = 27, 640, tuple(args[0].shape[2:])
    before = sc.scatter_quasi_dense.launches
    d, r = sc.scatter_quasi_dense_batched(*args, h, w, patch)
    d_p, r_p = sc.scatter_quasi_dense_batched_plain(*args, h, w, patch)
    torch.cuda.synchronize()
    assert sc.scatter_quasi_dense.launches == before + 1
    assert tuple(d.shape) == (b, h, w)
    assert torch.equal(d, d_p) and torch.equal(r, r_p)
    for f in range(b):
        d_f, r_f = sc.scatter_quasi_dense(
            *[t[f].contiguous() for t in args], h, w, patch)
        assert torch.equal(d[f], d_f) and torch.equal(r[f], r_f)
    assert bool((r[0] > 0).any())
    if b > 1:
        assert not bool((r[-1] > 0).any())


@pytest.mark.cuda
def test_batched_scatter_wrapper_refuses_bad_cuda_tensors(cuda_device,
                                                          rng):
    c, xs, zs, v = _batched_scatter_inputs(rng, cuda_device, 3, 8, 16, 0)
    h, w, patch = 27, 640, tuple(c.shape[2:])
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(NotImplementedError):
            sc.scatter_quasi_dense_batched(c.to(dtype), xs, zs, v, h, w,
                                           patch)
    with pytest.raises(ValueError, match='contiguous'):
        sc.scatter_quasi_dense_batched(
            c.transpose(2, 3).contiguous().transpose(2, 3), xs, zs, v, h, w,
            patch)
    with pytest.raises(ValueError, match='contiguous'):
        sc.scatter_quasi_dense_batched(c, xs.t().contiguous().t(), zs, v,
                                       h, w, patch)
    with pytest.raises(ValueError, match='must be'):
        sc.scatter_quasi_dense_batched(c, xs[:, :7].contiguous(), zs, v,
                                       h, w, patch)
    with pytest.raises(ValueError, match='must be'):
        sc.scatter_quasi_dense_batched(c[:2], xs, zs, v, h, w, patch)
    with pytest.raises(ValueError):
        sc.scatter_quasi_dense_batched(c, xs.cpu(), zs, v, h, w, patch)


# tiny batched pipelines on the card: (RadarNet config, perf, kernel,
# launches of that kernel a chunk); pallas_scatter=True routes the scatter
# through K1 (the default is the exact max, no kernel)
BATCHED_PATHS = {
    'fused': (RADARNET_TINY, PerfConfig(fused_pool2=True, fused_pool4=True,
                                        decode_chunks=2,
                                        pallas_scatter=True),
              fs.fused_skip_gather_add, 2),
    # patch 64x40: the 1/16 and 1/32 pools are variable-bin
    'wide': (RADARNET_WIDE, PerfConfig(decode_chunks=2, pallas_scatter=True),
             cc.batch_column_crop, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize('path', sorted(BATCHED_PATHS))
def test_batched_pipeline_on_card_matches_cpu(cuda_device, path):
    """forward_batched of a tiny fused or wide pipeline in two decode
    chunks on the card: its kernels launched as the chunks need and the
    scatter once; the card's crops within 1e-4 of the CPU's, the scatter
    of the CPU's crops equal on both, and FusionNet's depth from the same
    input within 1e-3 m."""
    radarnet_kw, perf, wrapper, per_chunk = BATCHED_PATHS[path]
    gen = torch.Generator().manual_seed(5)
    rn = RadarNetModel(**radarnet_kw, device='cpu', perf=perf)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    cpu = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')
    card = pipeline.TwoStagePipeline(copy.deepcopy(rn), copy.deepcopy(fn),
                                     H, W, device=cuda_device)
    rng = np.random.default_rng(6)
    frames = [frame_and_points(rng, k=8, n_invalid=i) for i in (2, 5)]
    images = np.concatenate([f[0] for f in frames])
    points = np.stack([f[1] for f in frames])
    valid = np.stack([f[2] for f in frames])
    before = wrapper.launches, sc.scatter_quasi_dense.launches
    dense_g, quasi_g, resp_g = card.forward_batched(images, points, valid)
    torch.cuda.synchronize()
    assert (wrapper.launches - before[0],
            sc.scatter_quasi_dense.launches - before[1]) == \
        (2 * per_chunk, 1)
    assert tuple(dense_g.shape) == (2, H, W)
    assert bool(torch.isfinite(dense_g).all())
    with torch.inference_mode(), pipeline.serving_numerics():
        image_c, crops_c, xs, zs = cpu.radarnet_stage_batched(images, points,
                                                              2)
        crops_g = card.radarnet_stage_batched(images, points, 2)[1]
        assert float((crops_g.cpu() - crops_c).abs().max()) <= 1e-4
        v = torch.from_numpy(valid)
        patch = rn.input_patch_size_image
        maps_c = sc.scatter_quasi_dense_batched(crops_c, xs, zs, v, H, W,
                                                patch)
        maps_g = sc.scatter_quasi_dense_batched(
            crops_c.to(cuda_device), xs.to(cuda_device), zs.to(cuda_device),
            v.to(cuda_device), H, W, patch)
        assert all(torch.equal(g.cpu(), c) for g, c in zip(maps_g, maps_c))
        _, _, input_depth = cpu.bridge(*maps_c)
        dense_c = cpu.fusionnet(image_c, input_depth)
        dense_g = card.fusionnet(image_c.to(cuda_device),
                                 input_depth.to(cuda_device))
        assert float((dense_g.cpu() - dense_c).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# bf16 instances of the serving kernels, and bf16 serving
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('pw', [288, 300, 30])
@pytest.mark.parametrize('b', [1, 3])
def test_scatter_bf16_matches_plain_on_card(cuda_device, rng, b, pw,
                                            offset):
    """K1's bf16 instance: pw 288 and 300 with aligned crops take the 8-byte
    branch, pw 30 and offset 1 (2 bytes past an allocation) the scalar one.
    One frame through scatter_quasi_dense, B frames through the batched
    wrapper, each against its plain version bit for bit, and each frame of
    the batch against the one-frame kernel; the bf16 count rises by one a
    call, the float32 count not at all."""
    args = _batched_scatter_inputs(rng, cuda_device, b, 64, pw, offset,
                                   dtype=torch.bfloat16)
    h, w, patch = 27, 640, tuple(args[0].shape[2:])
    before = _counts()
    d, r = sc.scatter_quasi_dense_batched(*args, h, w, patch)
    torch.cuda.synchronize()
    assert _launched(before, K1_bf16=1)
    d_p, r_p = sc.scatter_quasi_dense_batched_plain(*args, h, w, patch)
    assert torch.equal(d, d_p) and torch.equal(r, r_p)
    for f in range(b):
        d_f, r_f = sc.scatter_quasi_dense(
            *[t[f].contiguous() for t in args], h, w, patch)
        assert torch.equal(d[f], d_f) and torch.equal(r[f], r_f)
    assert bool((r[0] > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('k, w', [(1100, 640), (9, 12000)])
def test_scatter_bf16_strip_edges_on_card(cuda_device, rng, k, w, offset):
    """The row-strip edges of test_scatter_strip_edges_on_card with bf16
    crops at pw 288: more points than one list chunk, and key map rows
    beyond 48 KB of shared memory."""
    args = _strip_inputs(rng, cuda_device, k, 288, w, offset,
                         dtype=torch.bfloat16)
    h, patch = 27, tuple(args[0].shape[1:])
    d, r = sc.scatter_quasi_dense(*args, h, w, patch)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args, h, w, patch)
    torch.cuda.synchronize()
    assert torch.equal(d, d_p) and torch.equal(r, r_p)
    assert bool((r > 0).any()) and bool((d > 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize('pw', [2, 6, 37])
def test_fused_skip_bf16_matches_plain_on_card(cuda_device, rng, pw):
    """K3's bf16 instance against its plain version, bit for bit; K4's bf16
    ``full`` is this instance (one more launch of it, the same output)."""
    a, cg, starts, cl, cr = _gather_add_inputs(rng, cuda_device, pw=pw)
    args = (a.to(torch.bfloat16), cg.to(torch.bfloat16), starts, cl, cr)
    before = _counts()
    out = fs.fused_skip_gather_add(*args)
    torch.cuda.synchronize()
    assert _launched(before, K3_bf16=1)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fs.fused_skip_gather_add_plain(*args))
    assert torch.equal(out, fv.full(*args))
    assert _launched(before, K3_bf16=2)


@pytest.mark.cuda
@pytest.mark.parametrize('win', [1, 15, 43])
def test_column_crop_bf16_matches_plain_on_card(cuda_device, rng, win):
    rows, starts = _crop_inputs(rng, cuda_device)
    rows = rows.to(torch.bfloat16)
    before = _counts()
    out = cc.batch_column_crop(rows, starts, win)
    torch.cuda.synchronize()
    assert _launched(before, K2_bf16=1)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, cc.batch_column_crop_plain(rows, starts, win))


def _at_offset(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` elements past an
    allocation (offset 1: not 16-byte aligned)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def _residue_starts(rng, n, k, low, high):
    """(n, k) int32 starts in [low, high], the first image's beginning with
    every residue mod 8 (0 to 7, then 8 + 3), both ends and three outside
    [low, high] that the kernels clip."""
    starts = rng.integers(low, high + 1, (n, k)).astype(np.int32)
    starts[0, :14] = [0, 1, 2, 3, 4, 5, 6, 7, 11, low, high, low - 5,
                      high + 1, high + 9]
    return starts


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 1])
@pytest.mark.parametrize('pw', [8, 72, 144])
def test_fused_skip_bf16_row_tiles_on_card(cuda_device, rng, pw, offset):
    """K3's bf16 row-tile kernel on its vector path (pw % 8 == 0, aligned
    a and out) and, at offset 1, its scalar path: two images, 21 rows (a
    last tile of 5 of the 8-row tile), starts at every residue mod 8, at
    0 and wg - pw and outside [0, wg - pw]; bit for bit against the plain
    version, one launch of the bf16 instance."""
    n, k, co, ph, wg = 2, 16, 3, 7, pw + 40
    t = lambda a, d=torch.bfloat16: torch.from_numpy(a).to(  # noqa: E731
        cuda_device, d)
    normal = lambda *shape: rng.standard_normal(  # noqa: E731
        shape, dtype=np.float32)
    args = (_at_offset(t(normal(n * k, co, ph, pw)), offset),
            _at_offset(t(normal(n, co, ph, wg)), offset),
            t(_residue_starts(rng, n, k, 0, wg - pw), torch.int32),
            t(normal(n * k, co, ph), torch.float32),
            t(normal(n * k, co, ph), torch.float32))
    before = _counts()
    out = fs.fused_skip_gather_add(*args)
    torch.cuda.synchronize()
    assert _launched(before, K3_bf16=1)
    assert torch.equal(out, fs.fused_skip_gather_add_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize('c, ph', [(3, 5), (2, 6), (4, 6)])
@pytest.mark.parametrize('win', [8, 22, 43])
def test_column_crop_bf16_row_tiles_on_card(cuda_device, rng, win, c, ph):
    """K2's bf16 row-tile kernel at 15 rows (not a multiple of 8: the
    scalar path unless win = 8), 12 (a last tile of 4; the vector path at
    win 8 and 22, with vectors across two rows) and 24 rows: two images,
    starts at every residue mod 8, at 0 and w, past w and below 0; bit for
    bit against the plain version, one launch of the bf16 instance."""
    n, k, w = 2, 16, 60
    rows = torch.from_numpy(rng.standard_normal(
        (n, c, ph, w), dtype=np.float32)).to(cuda_device, torch.bfloat16)
    starts = torch.from_numpy(_residue_starts(rng, n, k, 0, w)).to(
        cuda_device)
    before = _counts()
    out = cc.batch_column_crop(rows, starts, win)
    torch.cuda.synchronize()
    assert _launched(before, K2_bf16=1)
    assert torch.equal(out, cc.batch_column_crop_plain(rows, starts, win))


@pytest.mark.cuda
def test_bf16_row_tiles_of_wide_rows_on_card(cuda_device, rng):
    """Rows too wide for 8 a tile: K3 at wg = 20,000 stages 4 rows (160
    KB of dynamic shared memory), K2 at w + win = 30,043 stages 2 (120
    KB); both bit for bit against their plain versions."""
    n, k, co, ph, pw, wg = 2, 5, 2, 5, 144, 20_000
    assert fs.row_tile(co * ph, wg, n)[:2] == (4, 160_032)
    t = lambda a, d=torch.bfloat16: torch.from_numpy(a).to(  # noqa: E731
        cuda_device, d)
    normal = lambda *shape: rng.standard_normal(  # noqa: E731
        shape, dtype=np.float32)
    args = (t(normal(n * k, co, ph, pw)), t(normal(n, co, ph, wg)),
            t(rng.integers(0, wg - pw + 1, (n, k)).astype(np.int32),
              torch.int32),
            t(normal(n * k, co, ph), torch.float32),
            t(normal(n * k, co, ph), torch.float32))
    before = _counts()
    out = fs.fused_skip_gather_add(*args)
    torch.cuda.synchronize()
    assert _launched(before, K3_bf16=1)
    assert torch.equal(out, fs.fused_skip_gather_add_plain(*args))

    w, win = 30_000, 43
    assert fs.row_tile(co * ph, w + win, n)[:2] == (2, 120_208)
    rows = t(normal(n, co, ph, w))
    starts = t(_residue_starts(rng, n, k + 9, 0, w), torch.int32)
    before = _counts()
    out = cc.batch_column_crop(rows, starts, win)
    torch.cuda.synchronize()
    assert _launched(before, K2_bf16=1)
    assert torch.equal(out, cc.batch_column_crop_plain(rows, starts, win))


@pytest.mark.cuda
def test_bf16_row_tiles_refuse_rows_too_wide(cuda_device):
    """A row too wide for a block's shared memory raises ValueError before
    any launch; float32, which stages nothing, takes it."""
    wide = fs.SMEM_LIMIT // 2
    zeros = lambda *shape, d=torch.bfloat16: torch.zeros(  # noqa: E731
        shape, dtype=d, device=cuda_device)
    starts = zeros(1, 2, d=torch.int32)
    corr = zeros(2, 1, 1, d=torch.float32)
    before = _counts()
    with pytest.raises(ValueError, match='shared memory'):
        fs.fused_skip_gather_add(zeros(2, 1, 1, 8), zeros(1, 1, 1, wide),
                                 starts, corr, corr)
    with pytest.raises(ValueError, match='shared memory'):
        cc.batch_column_crop(zeros(1, 1, 1, wide - 8), starts, 8)
    assert _launched(before)
    out = cc.batch_column_crop(zeros(1, 1, 1, wide - 8, d=torch.float32),
                               starts, 8)
    torch.cuda.synchronize()
    assert _launched(before, K2=1) and not bool(out.any())


# tiny bf16 pipelines on the card: (RadarNet config, perf, the launches of
# one request by instance); the scatter through K1 (pallas_scatter=True)
BF16_PATHS = {
    'canonical': (RADARNET_TINY, PerfConfig(pallas_scatter=True),
                  dict(K1_bf16=1)),
    'fused': (RADARNET_TINY, PerfConfig(fused_pool2=True, fused_pool4=True,
                                        pallas_scatter=True),
              dict(K1_bf16=1, K3_bf16=2)),
    # patch 64x40: the 1/16 and 1/32 pools are variable-bin
    'wide': (RADARNET_WIDE, PerfConfig(pallas_scatter=True),
             dict(K1_bf16=1, K2_bf16=2)),
}
# bf16 on the card against bf16 on the CPU: RadarNet's crops within a few
# bf16 steps (cuDNN and the CPU round bf16 convolutions at other places),
# dense depth from the same maps within tests/test_bf16_serving.py's MAE
BF16_CROP_TOL = 2e-2
BF16_DENSE_MAE = 0.25


@pytest.mark.cuda
@pytest.mark.parametrize('path', sorted(BF16_PATHS))
def test_bf16_pipeline_on_card_matches_cpu(cuda_device, path):
    """One request of a tiny TwoStagePipeline(compute_dtype=bfloat16) on
    the card: only the bf16 instances launched, as the path needs; dense
    float32 and finite; RadarNet's crops within BF16_CROP_TOL of the
    CPU's; the scatter of the CPU's bf16 crops equal on both; FusionNet's
    depth from the same input within BF16_DENSE_MAE; then forward_batched
    over two frames in one decode chunk: the same launches as one request
    (one K1 over both frames; K2 and K3 over the chunk's patches), dense
    float32 and finite."""
    radarnet_kw, perf, expect = BF16_PATHS[path]
    gen = torch.Generator().manual_seed(5)
    rn = RadarNetModel(**radarnet_kw, device='cpu', perf=perf)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    cpu = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu',
                                    compute_dtype=torch.bfloat16)
    card = pipeline.TwoStagePipeline(rn, fn, H, W, device=cuda_device,
                                     compute_dtype=torch.bfloat16)
    image, points, valid = frame_and_points(np.random.default_rng(6))
    before = _counts()
    dense_g = card(image, points, valid)[0]
    torch.cuda.synchronize()
    assert _launched(before, **expect)
    assert dense_g.dtype == torch.float32 and dense_g.is_cuda
    assert bool(torch.isfinite(dense_g).all())
    with torch.inference_mode(), pipeline.serving_numerics():
        image_c, crops_c, xs, zs = cpu.radarnet_stage(image, points)
        crops_g = card.radarnet_stage(image, points)[1]
        assert crops_g.dtype == torch.bfloat16
        assert float((crops_g.cpu().float() - crops_c.float()).abs().max()) \
            <= BF16_CROP_TOL
        v = torch.from_numpy(valid)
        patch = rn.input_patch_size_image
        maps_c = sc.scatter_quasi_dense(crops_c, xs, zs, v, H, W, patch)
        maps_g = sc.scatter_quasi_dense(
            crops_c.to(cuda_device), xs.to(cuda_device), zs.to(cuda_device),
            v.to(cuda_device), H, W, patch)
        assert all(torch.equal(g.cpu(), c) for g, c in zip(maps_g, maps_c))
        _, _, input_depth = cpu.bridge(*maps_c)
        dense_c = cpu.fusionnet(image_c, input_depth).float()
        dense_g = card.fusionnet(image_c.to(cuda_device),
                                 input_depth.to(cuda_device)).float()
        assert float((dense_g.cpu() - dense_c).abs().mean()) < BF16_DENSE_MAE
    frames = [(image, points, valid),
              frame_and_points(np.random.default_rng(7))]
    before = _counts()
    dense_b = card.forward_batched(np.concatenate([f[0] for f in frames]),
                                   np.stack([f[1] for f in frames]),
                                   np.stack([f[2] for f in frames]))[0]
    torch.cuda.synchronize()
    assert _launched(before, **expect)
    assert dense_b.dtype == torch.float32 and tuple(dense_b.shape) == \
        (2, H, W) and bool(torch.isfinite(dense_b).all())


JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                        'torch_io')


@pytest.mark.cuda
def test_nvjpeg_decode_on_card(cuda_device, tmp_path):
    """A JPEG frame decodes with nvJPEG on the card within the JAX codec's
    tolerance of PIL's decode (tests/test_native_io.py); a corrupt one
    raises OSError and the decoder stays usable."""
    from rcfd_tpu_torch import native

    path = os.path.join(JPEG_DIR, 'frame_q95.jpg')
    want = native.read_image_u8(os.path.join(JPEG_DIR, 'frame_q95_pil.png'))
    got = native.read_image_u8(path, device=cuda_device)
    assert got.shape == want.shape == (96, 160, 3)
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.mean() < 1.0 and diff.max() <= 16.0
    with open(path, 'rb') as f:
        data = f.read()
    # garbage after the start marker; a valid header with no scan
    for name, blob in (('garbage', b'\xff\xd8\xff\xe0' + b'\x00' * 64),
                       ('no_scan', data[:data.index(b'\xff\xda')])):
        bad = str(tmp_path / (name + '.jpg'))
        with open(bad, 'wb') as f:
            f.write(blob)
        with pytest.raises(OSError):
            native.read_image_u8(bad, device=cuda_device)
    batch = native.batch_read_images([path, path], 96, 160,
                                     device=cuda_device)
    assert np.array_equal(batch[1], got.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_exact_scatter_on_card_matches_cpu(cuda_device, rng, dtype):
    """The exact scatter (the serving default, scatter_reduce_ on the card)
    on the card against the CPU for every scatter case, single-frame and
    batched: bit for bit."""
    from rcfd_tpu_torch.ops import scatter as exact

    for name in SCATTER_CASES:
        crops, x, z, valid, h, w, patch = scatter_case(name, rng)
        args = [torch.from_numpy(a) for a in (crops, x, z, valid)]
        args[0] = args[0].to(dtype)
        ref = exact.scatter_quasi_dense(*args, h, w, patch)
        out = exact.scatter_quasi_dense(*[a.to(cuda_device) for a in args],
                                        h, w, patch)
        assert all(torch.equal(o.cpu(), r) for o, r in zip(out, ref)), name
        out_b = exact.scatter_quasi_dense_batched(
            *[torch.stack([a, a]).to(cuda_device) for a in args], h, w,
            patch)
        assert all(torch.equal(o[1].cpu(), r) for o, r in zip(out_b, ref))


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda_device, rng):
    """One train step of a narrow FusionNet (chip_smoke.py's phase train
    configuration) on the card and on the CPU from the same weights and
    batch, augmentation off, float32 with TF32 off: loss within 1e-5
    relative, every gradient within 1e-3 of its max-abs (cuDNN's backward
    sums in another order), running statistics within 1e-5."""
    from rcfd_tpu_torch import fusionnet_main as fm
    from rcfd_tpu_torch.data.transforms import Transforms

    config = dict(FUSIONNET_TINY,
                  n_filters_encoder_image=[8, 16, 16, 16, 16, 16],
                  n_filters_encoder_depth=[8, 8, 16, 16, 16, 16],
                  n_filters_decoder=[16, 16, 16, 8, 8, 8])
    cpu = FusionNetModel(**config, device='cpu', trainable=True)
    init_parameters(cpu, torch.Generator().manual_seed(7))
    card = copy.deepcopy(cpu).to(cuda_device)
    batch = (rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8),
             *[(rng.random((2, 64, 96, 1)) * 60 * 256).astype(np.uint16)
               for _ in range(4)])
    out = []
    for model, device in ((cpu, 'cpu'), (card, cuda_device)):
        step = fm.TrainStep(model, Transforms(normalized_image_range=[0, 1]),
                            fm.make_optimizer(model, 1e-3, 0.0), 'l1', 0.0,
                            2.0, -1, 7, 1.5, -1)
        with fm.training_numerics():
            info = step.backward(tuple(torch.from_numpy(a).to(device)
                                       for a in batch), {})
        out.append((float(info['loss']), {
            n: p.grad.cpu() for n, p in model.named_parameters()
            if p.grad is not None}, {n: b.cpu() for n, b in
                                     model.named_buffers()}))
    (loss_c, grads_c, bufs_c), (loss_g, grads_g, bufs_g) = out
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    assert sorted(grads_g) == sorted(grads_c)
    for n, g in grads_c.items():
        err = float((grads_g[n] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()), (n, err,
                                                     float(g.abs().max()))
    for n, b in bufs_c.items():
        assert torch.allclose(bufs_g[n].double(), b.double(), rtol=1e-5,
                              atol=1e-6), n


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [8, 16, 32])
def test_column_crop_gradient_on_card(cuda_device, rng, scale):
    """K2's autograd Function on the card against autograd of the plain
    crop, float32, at the training step's shapes of the 900x300 patch (6
    frames of 4 windows at the 1/8, 1/16 and 1/32 pools, starts at 0 and at
    W among them): the windows bit for bit, one launch, and the rows'
    gradient within 1e-5 of its max-abs (index_add_ adds overlapping
    windows with atomics, in another order); the node saves the starts
    only."""
    from rcfd_tpu_torch.ops.roi_pool import variable_bin_window

    ph, pw = 900 // scale, 300 // scale
    w_f = -(-1900 // scale)  # the map of a 900x1900 padded frame
    _, win = variable_bin_window(300, 1.0 / scale, pw)
    rows = torch.from_numpy(rng.standard_normal(
        (6, 128, ph, w_f), dtype=np.float32)).to(cuda_device)
    starts = rng.integers(0, w_f + 1, (6, 4)).astype(np.int32)
    starts[0, :2] = [0, w_f]
    starts = torch.from_numpy(starts).to(cuda_device)
    rows_k = rows.clone().requires_grad_(True)
    rows_p = rows.clone().requires_grad_(True)
    before = cc.batch_column_crop.launches
    out = cc.batch_column_crop(rows_k, starts, win)
    assert cc.batch_column_crop.launches == before + 1
    assert type(out.grad_fn).__name__ == 'ColumnCropBackward'
    # the backward keeps the starts, never the rows
    assert [t is starts for t in out.grad_fn.saved_tensors] == [True]
    ref = cc.batch_column_crop_plain(rows_p, starts, win)
    assert torch.equal(out, ref)
    grad = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(
                           device=cuda_device).manual_seed(1))
    g_k, = torch.autograd.grad(out, rows_k, grad)
    g_p, = torch.autograd.grad(ref, rows_p, grad)
    torch.cuda.synchronize()
    assert cc.batch_column_crop.launches == before + 1  # none backward
    assert float((g_k - g_p).abs().max()) <= 1e-5 * float(g_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('scale', [8, 16, 32])
def test_column_crop_bf16_gradient_on_card(cuda_device, rng, scale):
    """K2's bf16 instance with its gradient (bf16 training) at the 900x300
    step's shapes: the windows equal the plain crop's bit for bit, one bf16
    launch, and the rows' bf16 gradient is the float32 sum of the windows'
    bf16 gradients rounded once (within one bf16 rounding of its max-abs:
    the float32 atomics' order moves the sum's last bits)."""
    from rcfd_tpu_torch.ops.roi_pool import variable_bin_window

    ph, pw = 900 // scale, 300 // scale
    w_f = -(-1900 // scale)
    _, win = variable_bin_window(300, 1.0 / scale, pw)
    rows = torch.from_numpy(rng.standard_normal(
        (6, 128, ph, w_f), dtype=np.float32)).to(cuda_device, torch.bfloat16)
    starts = rng.integers(0, w_f + 1, (6, 4)).astype(np.int32)
    starts[0, :2] = [0, w_f]
    starts = torch.from_numpy(starts).to(cuda_device)
    rows_k = rows.clone().requires_grad_(True)
    before = cc.batch_column_crop.launches_bf16
    out = cc.batch_column_crop(rows_k, starts, win)
    assert cc.batch_column_crop.launches_bf16 == before + 1
    assert torch.equal(out, cc.batch_column_crop_plain(rows, starts, win))
    grad = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(
                           device=cuda_device).manual_seed(1)).to(
                               torch.bfloat16)
    g_k, = torch.autograd.grad(out, rows_k, grad)
    assert g_k.dtype == torch.bfloat16
    ref = cc.batch_column_crop_backward_plain(
        grad.float(), starts, rows.shape, win).to(torch.bfloat16).float()
    assert float((g_k.float() - ref).abs().max()) <= \
        2.0 ** -8 * float(ref.abs().max())


@pytest.mark.cuda
def test_column_crop_without_a_gradient_records_no_graph(cuda_device, rng):
    """Under no_grad, or for rows that need no gradient, the crop is the
    bare launch: no autograd node."""
    rows, starts = _crop_inputs(rng, cuda_device)
    with torch.no_grad():
        out = cc.batch_column_crop(rows.requires_grad_(True), starts, 15)
    assert out.grad_fn is None and not out.requires_grad
    out = cc.batch_column_crop(rows.detach(), starts, 15)
    assert out.grad_fn is None and not out.requires_grad
    with torch.inference_mode():
        assert cc.batch_column_crop(rows, starts, 15).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize('scale, hw', [(1 / 8., (16, 45)), (1 / 16., (8, 23)),
                                       (1 / 32., (4, 12))])
def test_variable_bin_pool_on_card_equals_cpu(cuda_device, rng, scale, hw):
    """The variable-bin column pool of a 100-wide patch on the card against
    the CPU, bit for bit: its bins are a true division (14 / 12 taken as a
    multiplication by the reciprocal ends a bin one column further)."""
    from rcfd_tpu_torch.ops.roi_pool import roi_pool_column

    feat = torch.from_numpy(rng.standard_normal((2, 16) + hw,
                                                dtype=np.float32))
    x1 = torch.tensor([[11., 170., 3., 242.], [40., 0., 200., 99.]])
    size = (int(128 * scale), int(100 * scale))
    ref = roi_pool_column(feat, x1, 100, 0, 128, scale, size)
    out = roi_pool_column(feat.to(cuda_device), x1.to(cuda_device), 100, 0,
                          128, scale, size)
    assert torch.equal(out.cpu(), ref)


def _bridge_files(tmp_path, rng, n=3, n_points=6):
    """n frames of H x W made with the port's writers, their radar points
    (at most ``n_points``) and a tiny RadarNet .pth (RADARNET_TINY)."""
    from rcfd_tpu_torch import native

    frames = []
    for i in range(n):
        image = str(tmp_path / 'image_{}.png'.format(i))
        native.write_rgb(image, rng.integers(0, 256, (H, W, 3),
                                             dtype=np.uint8))
        points = np.stack([rng.integers(0, W, n_points),
                           rng.integers(0, H, n_points),
                           rng.random(n_points) * 60 + 1], 1)
        frames.append((image, points.astype(np.float32)))
    model = RadarNetModel(**RADARNET_TINY, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(5))
    checkpoint = str(tmp_path / 'radarnet.pth')
    model.save_checkpoint(checkpoint, 3)
    return frames, checkpoint


def _bridge_run(tmp_path, frames, checkpoint, name, device):
    """The bridge on the frames as a val split, the radar files under
    radar_points_<name>/ (outputs beside them); returns the (depth,
    response) codes of each frame."""
    from rcfd_tpu_torch.data import io
    from rcfd_tpu_torch.setup import setup_dataset_nuscenes_radarnet as bridge

    radar_dir = tmp_path / ('radar_points_' + name)
    radar_dir.mkdir()
    radar = []
    for i, (_, points) in enumerate(frames):
        radar.append(str(radar_dir / '{:04d}.npy'.format(i)))
        np.save(radar[-1], points)
    io.write_paths(str(tmp_path / 'image.txt'), [f[0] for f in frames])
    io.write_paths(str(tmp_path / (name + '.txt')), radar)
    widths = [str(v) for v in RADARNET_TINY['n_filters_encoder_image']]
    bridge.main([
        '--restore_path', checkpoint, '--output_dirpath',
        str(tmp_path / ('out_' + name)), '--val_image_path',
        str(tmp_path / 'image.txt'), '--val_radar_path',
        str(tmp_path / (name + '.txt')), '--patch_size',
        *[str(v) for v in RADARNET_TINY['input_patch_size_image']],
        '--n_filters_encoder_image', *widths, '--n_neurons_encoder_depth',
        *[str(v) for v in RADARNET_TINY['n_neurons_encoder_depth']],
        '--n_filters_decoder',
        *[str(v) for v in RADARNET_TINY['n_filters_decoder']]],
        device=device)
    return [[io.load_depth_u16(p.replace('radar_points', kind).replace(
        '.npy', '.png')).astype(np.int64) for kind in (
            'depth_predicted', 'response_predicted')] for p in radar]


@pytest.mark.cuda
def test_bridge_on_card_takes_k1_and_matches_cpu(cuda_device, rng, tmp_path,
                                                 monkeypatch):
    """The stage-1.5 bridge on the card: by default the scatter kernel K1,
    once for the forward of the 3 frames, and the files of the same run
    with K1's plain version in its place; under RCFD_PALLAS_SCATTER=0 the
    exact max, no launch, and the files of the CPU's run: response codes
    within one step, depth codes equal on all but 2 pixels a frame (a tie
    of two crops within float32 rounding may go either way)."""
    for gate in ('RCFD_PALLAS_SCATTER', 'RCFD_FUSED_POOL2',
                 'RCFD_FUSED_POOL4', 'RCFD_DECODE_CHUNKS'):
        monkeypatch.delenv(gate, raising=False)
    frames, checkpoint = _bridge_files(tmp_path, rng)
    before = _counts()
    k1 = _bridge_run(tmp_path, frames, checkpoint, 'k1', cuda_device)
    assert _launched(before, K1=1)
    assert all(int((d > 0).sum()) > 0 for d, _ in k1)
    from rcfd_tpu_torch.ops import scatter_cuda
    with monkeypatch.context() as m:
        m.setattr(scatter_cuda, 'scatter_quasi_dense_batched',
                  scatter_cuda.scatter_quasi_dense_batched_plain)
        before = _counts()
        plain = _bridge_run(tmp_path, frames, checkpoint, 'plain',
                            cuda_device)
        assert _launched(before)
    for (dk, rk), (dp, rp) in zip(k1, plain):
        assert np.array_equal(dk, dp) and np.array_equal(rk, rp)
    monkeypatch.setenv('RCFD_PALLAS_SCATTER', '0')
    before = _counts()
    card = _bridge_run(tmp_path, frames, checkpoint, 'card', cuda_device)
    assert _launched(before)
    cpu = _bridge_run(tmp_path, frames, checkpoint, 'cpu', 'cpu')
    for (dg, rg), (dc, rc) in zip(card, cpu):
        assert int((dg != dc).sum()) <= 2
        assert int(np.abs(rg - rc).max()) <= 1


@pytest.mark.cuda
def test_trace_window_traces_the_card(cuda_device, tmp_path, monkeypatch):
    """The train loops' trace window on a CUDA device writes one Chrome
    trace of the steps asked for, holding the card's kernels."""
    import json

    from rcfd_tpu_torch.utils.profiling import TraceWindow

    monkeypatch.setenv('RCFD_PROFILE_DIR', str(tmp_path))
    monkeypatch.setenv('RCFD_PROFILE_STEPS', '1-3')
    window = TraceWindow(cuda_device)
    x = torch.randn(2, 3, 32, 32, device=cuda_device)
    w = torch.randn(4, 3, 3, 3, device=cuda_device)
    for step in range(1, 6):
        torch.nn.functional.conv2d(x, w).relu().sum()
        window.after_step(step)
    window.close()
    assert os.listdir(tmp_path) == ['trace-steps-2-3.json']
    with open(window.path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('cat') == 'kernel' for e in events)


def _stage0_rig(rng, h, w):
    """A random 4x4 rig (a turn of a few degrees about each axis and a
    lever arm), two intrinsics and a depth map of a random cloud seen from
    the source camera, rasterized on the CPU."""
    from rcfd_tpu_torch import geometry

    def k():
        f = rng.uniform(0.8, 1.2) * w
        return np.array([[f, 0, w / 2 + rng.uniform(-5, 5)],
                         [0, f, h / 2 + rng.uniform(-5, 5)], [0, 0, 1]],
                        np.float32)
    angles = rng.uniform(-0.05, 0.05, 3)
    q = np.array([1.0, *angles / 2])
    m = geometry.pose_matrix(q, rng.uniform(-1, 1, 3)).numpy()
    k_src, k_dst = k(), k()
    pts = np.stack([rng.uniform(-20, 20, 20000), rng.uniform(-8, 8, 20000),
                    rng.uniform(3, 60, 20000)], 1).astype(np.float32)
    xy, z, mask = geometry.project_points_to_image(
        pts, np.eye(4, dtype=np.float32), k_src, h, w, device='cpu')
    src = geometry.points_to_depth_map(xy, z, mask, h, w, device='cpu')
    return src.numpy(), k_src, m, k_dst


@pytest.mark.cuda
def test_stage0_geometry_on_card_matches_cpu(cuda_device, rng):
    """Projection, rasterization and a 180x320 merge with both mover masks
    on the card against the CPU: equal, except at ties (none are expected:
    both compute the same float32 multiplies and adds), each shown by the
    point's two computations."""
    from rcfd_tpu_torch import geometry
    from rcfd_tpu_torch.geometry import reproject

    from torch_stage0 import unexplained_pixels

    h, w = 180, 320
    src, k_src, m, k_dst = _stage0_rig(rng, h, w)
    pts = (rng.standard_normal((5000, 3)) * 15).astype(np.float32)
    for dev_out in (geometry.project_points_to_image(
            pts, m, k_dst, h, w, device=cuda_device),):
        cpu_out = geometry.project_points_to_image(pts, m, k_dst, h, w,
                                                   device='cpu')
        for a, b in zip(dev_out, cpu_out):
            assert torch.equal(a.cpu(), b)
    main = np.zeros((h, w), np.float32)
    main[::7, ::5] = 30.0
    src_mask = np.zeros((h, w), bool)
    src_mask[40:90, 100:160] = True
    dst_mask = np.zeros((h, w), bool)
    dst_mask[120:170, 20:60] = True
    maps, points = [], []
    for device in (cuda_device, 'cpu'):
        maps.append(reproject.merge_neighbor_into_main(
            main, src, k_src, m, k_dst, src_mask, dst_mask,
            device=device).cpu().numpy())
        points.append(tuple(a.cpu().numpy() for a in
                            reproject.reprojected_points(
                                src, k_src, m, k_dst, h, w, src_mask,
                                device=device)))
    bad, ties, n_diff, _ = unexplained_pixels(maps[0], maps[1], *points)
    assert not bad and n_diff <= ties
    assert (maps[0] > 0).sum() > (main > 0).sum() + 1000


@pytest.mark.cuda
def test_stage0_pixels_do_not_move_under_tf32(cuda_device, rng):
    """The caller's TF32 settings reach no product of the stage-0 geometry
    (they are multiplies and adds, not matrix products): a merge and a
    projection give the same bits with TF32 on and off, and the settings
    are the caller's afterwards."""
    from rcfd_tpu_torch import geometry
    from rcfd_tpu_torch.geometry import reproject

    h, w = 180, 320
    src, k_src, m, k_dst = _stage0_rig(rng, h, w)
    pts = (rng.standard_normal((5000, 3)) * 15).astype(np.float32)
    b, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (b.allow_tf32, mm.allow_tf32)
    outs = []
    try:
        for tf32 in (True, False):
            b.allow_tf32 = mm.allow_tf32 = tf32
            outs.append((
                reproject.reproject_depth_map(src, k_src, m, k_dst, h, w,
                                              device=cuda_device).cpu(),
                geometry.project_points_to_image(pts, m, k_dst, h, w,
                                                 device=cuda_device)[0]
                .cpu()))
            assert (b.allow_tf32, mm.allow_tf32) == (tf32, tf32)
    finally:
        b.allow_tf32, mm.allow_tf32 = saved
    for a, c in zip(*outs):
        assert torch.equal(a, c)
    assert (outs[0][0] > 0).sum() > 1000


@pytest.mark.cuda
@pytest.mark.parametrize('route', ['exact', 'k1'])
def test_from_raw_radar_on_card(cuda_device, rng, route):
    """from_raw_radar on the card on both scatter routes: __call__'s
    outputs bit for bit on the points its projection gives, K1 launched
    once on the kernel's route and never on the exact max's, and K1 equal
    to its plain version on that request's crops."""
    from rcfd_tpu_torch import geometry

    gen = torch.Generator().manual_seed(11)
    perf = PerfConfig(pallas_scatter=True) if route == 'k1' else None
    rn = RadarNetModel(**RADARNET_TINY, device='cpu', perf=perf)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    pipe = pipeline.TwoStagePipeline(rn, fn, H, W, device=cuda_device)
    image = rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    k = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                 np.float32)
    m = geometry.compose(
        geometry.pose_matrix([0.5, -0.5, 0.5, -0.5], [0.2, -0.4, 1.1],
                             inverse=True),
        geometry.pose_matrix([0.9998, 0.0, 0.0, 0.02], [0.0, 0.0, 0.0]))
    pts = np.stack([rng.uniform(-5, 60, 16), rng.uniform(-15, 15, 16),
                    rng.uniform(-1, 2, 16)], 1).astype(np.float32)
    valid = np.ones(16, bool)
    valid[-2:] = False
    before = sc.scatter_quasi_dense.launches
    raw = pipe.from_raw_radar(image, pts, valid, m, k)
    torch.cuda.synchronize()
    assert sc.scatter_quasi_dense.launches - before == (route == 'k1')
    xy, z, mask = geometry.project_points_to_image(pts, m, k, H, W,
                                                   device=cuda_device)
    use = torch.from_numpy(valid).to(cuda_device) & mask
    points = torch.where(use[:, None], torch.stack(
        [torch.round(xy[:, 0]), torch.round(xy[:, 1]), z], -1),
        torch.zeros(1, device=cuda_device))
    assert 0 < int(use.sum()) < 14
    pre = pipe(image, points, use)
    for a, c in zip(raw, pre):
        assert torch.equal(a, c)
    with torch.inference_mode(), pipeline.serving_numerics():
        _, crops, xs, zs = pipe.radarnet_stage(image, points)
    args = (crops, xs, zs, use, H, W, rn.input_patch_size_image)
    for a, c in zip(sc.scatter_quasi_dense(*args),
                    sc.scatter_quasi_dense_plain(*args)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_legacy_registration_and_crops_on_card_match_cpu(cuda_device, rng):
    """The legacy v0 registration (float32 passes, chunked) and the
    point-centred crops on the card equal the CPU's bit for bit, TF32 on
    or off."""
    from rcfd_tpu_torch.models import legacy_v0
    lx = np.round(rng.uniform(0, 1600, 20000)).astype(np.float32)
    lz = rng.uniform(1, 70, 20000).astype(np.float32)
    rx = rng.uniform(0, 1600, 700).astype(np.float32)
    rz = rng.uniform(1, 70, 700).astype(np.float32)
    rx[:50], rz[:50] = lx[:50] + np.float32(0.4), lz[:50]
    cpu = legacy_v0.register_points_radius(lx, lz, rx, rz, device='cpu')
    b, m = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (b.allow_tf32, m.allow_tf32)
    try:
        for tf32 in (False, True):
            b.allow_tf32 = m.allow_tf32 = tf32
            card = legacy_v0.register_points_radius(lx, lz, rx, rz,
                                                    device=cuda_device)
            assert len(card) == len(cpu)
            for a, c in zip(card, cpu):
                np.testing.assert_array_equal(a, c)
    finally:
        b.allow_tf32, m.allow_tf32 = saved
    assert sum(len(c) > 0 for c in cpu) >= 50
    images = rng.random((4, 40, 70, 3)).astype(np.float32)
    labels = rng.random((4, 40, 70, 1)).astype(np.float32)
    points = np.array([[0, 3, 9], [69, 5, 9], [80, 1, 9], [-40, 2, 9]],
                      np.float32)
    got = [legacy_v0.crop_image_to_shape_on_point(
        torch.from_numpy(points).to(d), torch.from_numpy(images).to(d),
        torch.from_numpy(labels).to(d), 32, 18) for d in (cuda_device, 'cpu')]
    for a, c in zip(*got):
        assert torch.equal(a.cpu(), c)


@pytest.mark.cuda
def test_legacy_forward_and_roi_pool_on_card(cuda_device, rng):
    """The legacy v0 scatter inference on the card against the CPU at a
    64x96 frame: no kernel launched (the exact scatter); with d the
    crops' largest difference, the responses within d except where one
    side's lies under the 0.5 threshold and the other's within d of it,
    and the depth equal except where a response lies within 2d of the
    threshold or the two largest responses within 2d of each other; the
    general ROI pool card == CPU bit for bit."""
    from rcfd_tpu_torch import legacy_main
    from rcfd_tpu_torch.data.transforms import Transforms
    from rcfd_tpu_torch.ops import roi_pool
    model = legacy_main.build_model((64, 32), seed=3)
    image = torch.from_numpy(rng.integers(0, 256, (1, 64, 96, 3)).astype(
        np.uint8))
    points = torch.from_numpy(np.stack([
        rng.uniform(0, 96, 8), rng.uniform(0, 64, 8), rng.uniform(3, 60, 8)],
        1).astype(np.float32))
    valid = torch.arange(8) < 6
    launches = (sc.scatter_quasi_dense.launches, cc.batch_column_crop.launches,
                fs.fused_skip_gather_add.launches)
    outs = []
    for d in (cuda_device, 'cpu'):
        m = copy.deepcopy(model).to(d)
        fwd = legacy_main.make_forward_fn(
            m, Transforms(normalized_image_range=[0, 1]), 64, 96, (64, 32))
        with scattered_crops() as caught:
            outs.append([t.cpu() for t in fwd(image.to(d), points.to(d),
                                               valid.to(d))] + caught)
    torch.cuda.synchronize()
    assert launches == (sc.scatter_quasi_dense.launches,
                        cc.batch_column_crop.launches,
                        fs.fused_skip_gather_add.launches)
    (depth, response, crops), (depth_c, response_c, crops_c) = outs
    assert (response_c > 0).sum() > 100
    tol = max(float((crops - crops_c).abs().max()), 2.0 ** -24)
    assert tol < 1e-3
    both = (response > 0) & (response_c > 0)
    assert float((response - response_c)[both].abs().max()) <= tol
    assert float(torch.maximum(response, response_c)[~both].max()) <= \
        0.5 + tol
    assert not unexplained_depth(depth.numpy(), depth_c.numpy(),
                                 crops_c.numpy(), points.numpy(),
                                 valid.numpy(), (64, 32), 2 * tol)
    feat = torch.from_numpy(rng.standard_normal((1, 16, 113, 200)).astype(
        np.float32))
    boxes = torch.from_numpy(np.sort(rng.uniform(0, 1600, (1, 64, 4)), -1)
                             .astype(np.float32)[..., [0, 1, 3, 2]])
    boxes[..., 1], boxes[..., 3] = boxes[..., 1] % 900, boxes[..., 3] % 900
    got = roi_pool.roi_pool(feat.to(cuda_device), boxes.to(cuda_device),
                            1 / 8., (7, 7))
    assert torch.equal(got.cpu(), roi_pool.roi_pool(feat, boxes, 1 / 8.,
                                                    (7, 7)))


@pytest.mark.cuda
def test_forward_sharded_on_card(cuda_device, rng):
    """forward_sharded over [cuda:0, cuda:0] (one replica, two threads)
    under pallas_scatter=True: K1 launched once a shard, and each shard's
    frames equal forward_batched of that shard run on the shard's thread
    (whose cuDNN plans the sharded path uses), bit for bit."""
    from rcfd_tpu_torch import parallel

    gen = torch.Generator().manual_seed(12)
    rn = RadarNetModel(**RADARNET_TINY, device='cpu',
                       perf=PerfConfig(pallas_scatter=True))
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    pipe = pipeline.TwoStagePipeline(rn, fn, H, W, device=cuda_device)
    frames = [frame_and_points(rng) for _ in range(4)]
    batch = (np.concatenate([f[0] for f in frames]),
             np.stack([f[1] for f in frames]),
             np.stack([f[2] for f in frames]))
    devices = [torch.device('cuda', 0)] * 2
    before = sc.scatter_quasi_dense.launches
    out = pipe.forward_sharded(*batch, devices=devices)
    torch.cuda.synchronize()
    assert sc.scatter_quasi_dense.launches - before == 2
    assert all(r is pipe for r in pipe._sharded)
    # one shard at a time: forward_batched sets the global cuDNN flags for
    # its call and restores them after it
    threads = parallel.shard_threads(2)
    refs = [threads.submit(i, pipe.forward_batched, *part).result()
            for i, part in enumerate(parallel.shard_batch(batch, 2))]
    for i, ref in enumerate(refs):
        for a, r in zip(out, ref):
            assert torch.equal(a[2 * i:2 * i + 2], r)


@pytest.mark.cuda
def test_forward_sharded_replicates_a_cpu_pipeline_on_card(cuda_device,
                                                          rng):
    """A pipeline built on the CPU, sharded over [cuda:0, cuda:0]: one
    replica of its models on cuda:0 (weights equal), used by both shards
    and kept for the next request; K1 once a shard; outputs gathered on
    cuda:0, each shard equal to the replica's forward_batched of that shard
    on the shard's thread, bit for bit."""
    from rcfd_tpu_torch import parallel

    gen = torch.Generator().manual_seed(14)
    rn = RadarNetModel(**RADARNET_TINY, device='cpu',
                       perf=PerfConfig(pallas_scatter=True))
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    pipe = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')
    frames = [frame_and_points(rng) for _ in range(4)]
    batch = (np.concatenate([f[0] for f in frames]),
             np.stack([f[1] for f in frames]),
             np.stack([f[2] for f in frames]))
    devices = [torch.device('cuda', 0)] * 2
    before = sc.scatter_quasi_dense.launches
    out = pipe.forward_sharded(*batch, devices=devices)
    torch.cuda.synchronize()
    assert sc.scatter_quasi_dense.launches - before == 2
    replica = pipe._sharded[0]
    assert replica is not pipe and pipe._sharded[1] is replica
    assert replica.device == devices[0]
    for mine, theirs in ((replica.radarnet, pipe.radarnet),
                         (replica.fusionnet, pipe.fusionnet)):
        want = theirs.state_dict()
        for k, t in mine.state_dict().items():
            assert t.device == devices[0]
            assert torch.equal(t.cpu(), want[k]), k
    assert all(o.device == devices[0] for o in out)
    threads = parallel.shard_threads(2)
    refs = [threads.submit(i, replica.forward_batched, *part).result()
            for i, part in enumerate(parallel.shard_batch(batch, 2))]
    for i, ref in enumerate(refs):
        for a, r in zip(out, ref):
            assert torch.equal(a[2 * i:2 * i + 2], r)
    again = pipe.forward_sharded(*batch, devices=devices)
    assert pipe._sharded[0] is replica
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_data_parallel_step_on_card_matches_cpu(cuda_device, rng):
    """One float64 data-parallel train step of a tiny FusionNet and of a
    tiny RadarNet (a 32x32 patch: K2 has no float64 instance) on two gloo
    ranks that share the card, against the same two ranks on the CPU:
    loss_info and every averaged gradient and parameter within 1e-9 of its
    max-abs, the running statistics within 1e-9; both ranks' parameters
    equal."""
    import torch_parallel

    gen = torch.Generator().manual_seed(13)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu', trainable=True)
    rn_config = RADARNET_TINY
    rn = RadarNetModel(**rn_config, device='cpu', trainable=True)
    init_parameters(fn, gen)
    init_parameters(rn, gen)
    image = rng.integers(0, 256, (4, 64, 96, 3)).astype(np.float64)
    maps = [rng.random((4, 64, 96, 1)) * 60 for _ in range(4)]
    k, ph, pw, w = 3, 32, 32, 48
    x = rng.integers(0, w, (2, k)).astype(np.float64) + 0.25
    points = np.stack([x + pw // 2, rng.random((2, k)) * ph,
                       rng.random((2, k)) * 60 + 5], -1)
    boxes = np.stack([x, np.zeros_like(x), x + pw, np.full_like(x, ph)], -1)
    gt = points[..., 2, None, None, None] + rng.uniform(
        -0.8, 0.8, (2, k, ph, pw, 1))
    tkw = dict(normalized_image_range=[0, 1])
    cases = [
        dict(kind='fusionnet', config=FUSIONNET_TINY,
             state_dict=fn.state_dict(), transforms=tkw,
             step=dict(loss_func='l1', w_smoothness=0.0, w_lidar_loss=2.0,
                       loss_smoothness_kernel_size=-1,
                       outlier_kernel_size=7, outlier_threshold=1.5,
                       dilation_kernel_size=-1),
             batch=(image, *maps), lr=1e-3, draws={}),
        dict(kind='radarnet', config=rn_config, state_dict=rn.state_dict(),
             transforms=tkw, step=dict(patch_size=(ph, pw),
                                       max_distance_correspondence=0.4,
                                       set_invalid_to_negative_class=False,
                                       w_positive_class=2.0),
             batch=(rng.integers(0, 256, (2, ph, w + pw, 3)).astype(
                 np.float64), points, boxes, gt), lr=1e-3, draws={})]
    from rcfd_tpu_torch import parallel
    card = parallel.run_ranks(torch_parallel.step_cases, (cases,), 2,
                              cuda_device, shared_device=True)
    cpu = parallel.run_ranks(torch_parallel.step_cases, (cases,), 2, 'cpu')
    for c, (g0, g1, c0) in enumerate(zip(card[0], card[1], cpu[0])):
        for key in ('grads', 'params'):
            for n, v in c0[key].items():
                np.testing.assert_array_equal(g0[key][n], g1[key][n])
                assert np.abs(g0[key][n] - v).max() <= 1e-9 * max(
                    np.abs(v).max(), 1e-300), (c, key, n)
        for n, v in c0['buffers'].items():
            np.testing.assert_allclose(g0['buffers'][n], v, rtol=1e-9,
                                       atol=1e-12, err_msg=n)
        for n, v in c0['info'].items():
            assert abs(g0['info'][n] - v) <= 1e-9 * max(abs(v), 1e-300), n


# the JAX bridge harness test's flags (tests/test_bridgebench.py)
BRIDGEBENCH_ARGV = ['--height', '64', '--width', '96', '--patch', '64', '32',
                    '--n_frames', '6', '--n_points', '8',
                    '--eval_batch_size', '4', '--check_only']


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bridgebench_check_only_on_card(cuda_device, dtype):
    """The bridge harness's --check_only on the card: its three modes agree
    (prefetch == sync depth, codec == prefetch files, exact), and every
    forward launches the scatter kernel K1 (the dtype's instance) once: two
    warm-ups and two batches a pass in three passes."""
    from rcfd_tpu_torch.tools import bridgebench

    attr = 'launches_bf16' if dtype == 'bfloat16' else 'launches'
    other = 'launches' if dtype == 'bfloat16' else 'launches_bf16'
    sc.scatter_quasi_dense.launches = sc.scatter_quasi_dense.launches_bf16 = 0
    row = bridgebench.main(BRIDGEBENCH_ARGV + ['--dtype', dtype],
                           device=cuda_device)
    assert getattr(sc.scatter_quasi_dense, attr) == 2 + 3 * 2
    assert getattr(sc.scatter_quasi_dense, other) == 0
    assert row['backend'] == 'cuda' and row['device'] != 'cpu'
    assert all(row['results'][m]['frames_per_s'] > 0
               for m in ('prefetch', 'sync', 'codec'))


@pytest.mark.cuda
def test_parity_protocol_two_stage_card_against_cpu(cuda_device, tmp_path):
    """--synthetic --two_stage at tiny widths on the card (stage 1 through
    K1) and on the CPU (the exact max), the same drawn checkpoints and
    frames: with the CPU's metrics as the reference column, every section
    says PARITY PASS under the tool's own tolerances (10 mm / 0.05 1/km
    plus 1e-3 relative, 5e-3 relative on stage 1)."""
    from rcfd_tpu_torch.tools import parity_protocol as pp

    out = {}
    for side, device in (('card', cuda_device), ('cpu', 'cpu')):
        before = sc.scatter_quasi_dense.launches
        out[side] = pp.main(['--synthetic', '--two_stage', '--output_dirpath',
                             str(tmp_path / side), '--eval_batch_size', '2'],
                            device=device)[1]
        assert (sc.scatter_quasi_dense.launches > before) == (side == 'card')
    for section, tol_rel in (('stage1', 5e-3), ('stage2', 1e-3),
                             ('fused', 1e-3)):
        table, verdict = pp.format_table(out['cpu'][section],
                                         out['card'][section], 10.0, 0.05,
                                         tol_rel)
        assert verdict == 'PARITY PASS', (section, table)


@pytest.mark.cuda
def test_convert_checkpoint_round_trip_on_card(cuda_device, tmp_path):
    """A FusionNet .pth with an Adam state, converted on the card to .npz
    and back to .pth: the weights restore bit for bit, on the card and on
    the CPU; the step is carried; the .npz holds no optimizer state, so the
    final .pth's is empty."""
    from rcfd_tpu_torch.tools import convert_checkpoint

    model = FusionNetModel(**FUSIONNET_TINY, device='cpu', trainable=True)
    init_parameters(model, torch.Generator().manual_seed(3))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.rand(1, 3, 64, 96), torch.rand(1, 2, 64, 96))[0].mean() \
        .backward()
    optimizer.step()
    paths = [str(tmp_path / name) for name in ('a.pth', 'b.npz', 'c.pth')]
    model.save_checkpoint(paths[0], 11, optimizer.state_dict())
    flags = ['--n_filters_encoder_image', '4', '8', '8', '8', '8', '8',
             '--n_filters_encoder_depth', '4', '4', '8', '8', '8', '8',
             '--n_filters_decoder', '8', '8', '8', '8', '8', '8']
    for src, dst in zip(paths, paths[1:]):
        assert convert_checkpoint.main(
            ['--model', 'fusionnet', '--input', src, '--output', dst] + flags,
            device=cuda_device) == 11
    assert not torch.load(paths[2], weights_only=True)['optimizer_state_dict']
    for device in (cuda_device, 'cpu'):
        got = FusionNetModel(**FUSIONNET_TINY, device='cpu')
        assert got.restore_checkpoint(paths[2], device=device) == 11
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k].cpu(), v), k


@pytest.mark.cuda
def test_point_mlp_features_depend_on_the_row_count_on_card(cuda_device,
                                                            rng):
    """The open fault of ROADMAP.md §3: on the card, RadarNet's point MLP
    (FullyConnectedEncoder: one matmul a layer over the B * K rows of a
    batch) gives the same points other last bits in a batch of 512 rows
    than in one of 256, because cuBLAS chooses its kernel by the row count
    (cudnn.deterministic does not reach it). So the _test bridge (K = 128)
    and the main script (K = 64) write other files at ties. At the
    canonical widths, 240 points in 256 and in 512 rows under the serving
    numerics: on the card the features differ (the fault shows), each by
    at most 1e-5 of the largest (rounding, not a wrong result); on the CPU
    they are equal bit for bit. When the fault is repaired the card's
    features are equal too, and this test says so by failing."""
    from rcfd_tpu_torch.models.networks import FullyConnectedEncoder

    encoder = FullyConnectedEncoder(3, [32, 64, 128, 128, 128],
                                    128 * 28 * 9).eval()
    init_parameters(encoder, torch.Generator().manual_seed(0))
    points = torch.from_numpy(np.stack([
        rng.uniform(0, 1888, 240), rng.uniform(0, 900, 240),
        rng.uniform(1, 80, 240)], 1).astype(np.float32))
    features = {}
    for device in (cuda_device, torch.device('cpu')):
        encoder.to(device)
        with torch.inference_mode(), pipeline.serving_numerics():
            features[device.type] = [encoder(torch.cat([
                points, torch.zeros(rows - 240, 3)]).to(device))[:240].cpu()
                for rows in (256, 512)]
    a, b = features['cuda']
    assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert not torch.equal(a, b)
    assert torch.equal(*features['cpu'])
