"""The CUDA kernels of rcfd_tpu_torch on the card, against their plain
versions. These tests need a CUDA device and skip without one. They import
no JAX, so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.ops import crop_cuda as cc  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip as fs  # noqa: E402
from rcfd_tpu_torch.ops import fused_skip_variants as fv  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402

from torch_parity import SCATTER_CASES, scatter_case  # noqa: E402


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


def _strip_inputs(rng, device, k, pw, w, offset, ph=23):
    """Scatter inputs for the edges of the row-strip kernel: an odd number of
    rows (a ragged last strip), windows at both aprons (x at the first and
    last column and clipped beyond both), pairs of points inside one 2^-14
    step in overlapping windows (one pair across the 1,024-point list
    chunk when k > 1,024), values of exactly 0.5 and just below, invalid
    points, and integer depths equal to later indices. The crops start
    ``offset`` floats past an allocation, so offset 1 is not 16-byte
    aligned."""
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
    flat = torch.empty(k * ph * pw + offset, device=device)
    crops_t = flat[offset:].view(k, ph, pw)
    crops_t.copy_(torch.from_numpy(crops))
    return (crops_t,) + tuple(torch.from_numpy(a).to(device)
                              for a in (x + pw // 2, z, valid))


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
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c.to(torch.bfloat16), xs, zs, v, h, w, patch)
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c, xs.double(), zs, v, h, w, patch)
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
    with pytest.raises(NotImplementedError):
        fs.fused_skip_gather_add(a.to(torch.bfloat16), cg, starts, cl, cr)
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
