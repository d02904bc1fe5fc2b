"""The port's file I/O (rcfd_tpu_torch/native, data/io.py, data/transport.py,
data/datasets.py, utils/eval_utils.py) against the JAX package's and PIL on
the CPU: 16-bit PNGs exact both ways, camera PNGs of every PIL mode exact,
JPEG within the JAX codec's tolerance, corrupt files refused, and the
dataset and metrics equal."""

import os
import struct
import warnings
import zlib

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from PIL import Image  # noqa: E402

from rcfd_tpu.data import datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data import io as jax_io  # noqa: E402
from rcfd_tpu.utils import eval_utils as jax_eval  # noqa: E402

from rcfd_tpu_torch import native  # noqa: E402
from rcfd_tpu_torch.data import datasets  # noqa: E402
from rcfd_tpu_torch.data import io  # noqa: E402
from rcfd_tpu_torch.data import transport  # noqa: E402
from rcfd_tpu_torch.utils import eval_utils  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                        'torch_io')
# JPEG decoders differ by their IDCT and upsampling
# (tests/test_native_io.py::test_image_decode_jpeg)
JPEG_MEAN_ABS, JPEG_MAX_ABS = 1.0, 16.0


def _depth_with_edges(rng, h=24, w=40):
    """A depth map whose codes include 0, 1 and 65535 and a depth just
    under 256 m."""
    z = (rng.random((h, w), dtype=np.float32) * 80).astype(np.float32)
    z[z < 20] = 0.0
    z[0, :4] = [0.0, 1 / 256., 65535 / 256., 255.99]
    return z


# -- 16-bit PNG ----------------------------------------------------------------


@pytest.mark.parametrize('kind', ['depth', 'response'])
def test_port_reads_what_jax_writes(tmp_path, rng, kind):
    path = str(tmp_path / 'm.png')
    if kind == 'depth':
        data = _depth_with_edges(rng)
        jax_io.save_depth(data, path)
        np.testing.assert_array_equal(io.load_depth(path),
                                      jax_io.load_depth(path))
        np.testing.assert_array_equal(io.load_depth_raw(path),
                                      jax_io.load_depth_raw(path))
        assert io.load_depth_raw(path).dtype == np.int64
        codes = np.asarray(Image.open(path), np.int64)
        assert {0, 1, 65535} <= set(codes.ravel().tolist())
    else:
        data = rng.random((24, 40), dtype=np.float32)
        data[0, :3] = [0.0, 2.0 ** -14, 65535 * 2.0 ** -14]
        jax_io.save_response(data, path)
        np.testing.assert_array_equal(io.load_response(path),
                                      jax_io.load_response(path))
    for fmt in ('HW', 'HWC', 'CHW'):
        got = io.load_depth(path, data_format=fmt)
        want = jax_io.load_depth(path, data_format=fmt)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        got = io.load_depth_u16(path, data_format=fmt)
        want = jax_io.load_depth_u16(path, data_format=fmt)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('writer', ['save_depth', 'save_response',
                                    'save_depth_encoded',
                                    'save_response_encoded'])
def test_jax_and_pil_read_what_port_writes(tmp_path, rng, writer):
    port_path, jax_path = str(tmp_path / 'p.png'), str(tmp_path / 'j.png')
    if writer == 'save_response':
        data = rng.random((24, 40), dtype=np.float32)
        data[0, :2] = [2.0 ** -14, 65535 * 2.0 ** -14]
        reader = 'load_response'
    else:
        data = _depth_with_edges(rng)
        reader = 'load_depth'
    if writer.endswith('_encoded'):
        scale = 2.0 ** 14 if 'response' in writer else 256.0
        data = np.floor(data.astype(np.float64) * scale).astype(np.uint16)
    getattr(io, writer)(data, port_path)
    getattr(jax_io, writer)(data, jax_path)
    pil = np.asarray(Image.open(port_path), np.int64)
    np.testing.assert_array_equal(pil, np.asarray(Image.open(jax_path),
                                                  np.int64))
    assert Image.open(port_path).mode in ('I;16', 'I;16B', 'I')
    np.testing.assert_array_equal(getattr(jax_io, reader)(port_path),
                                  getattr(jax_io, reader)(jax_path))
    np.testing.assert_array_equal(getattr(io, reader)(port_path),
                                  getattr(jax_io, reader)(jax_path))


def test_save_depth_clips_as_pil_does(tmp_path):
    """uint32(z * 256) beyond 16 bits (and negative z) are saved as PIL's
    mode-'I' save clips them."""
    z = np.array([[-3.0, 0.0, 255.99, 256.0, 300.0, 1e7]], np.float32)
    port_path, jax_path = str(tmp_path / 'p.png'), str(tmp_path / 'j.png')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        io.save_depth(z, port_path)
        jax_io.save_depth(z, jax_path)
    np.testing.assert_array_equal(np.asarray(Image.open(port_path)),
                                  np.asarray(Image.open(jax_path)))


@pytest.mark.parametrize('writer', ['save_depth_encoded',
                                    'save_response_encoded'])
def test_encoded_writers_take_only_uint16(tmp_path, writer):
    with pytest.raises(TypeError):
        getattr(io, writer)(np.zeros((4, 4), np.uint32),
                            str(tmp_path / 'x.png'))


def test_native_batch_read_depth(tmp_path, rng):
    paths, ref = [], []
    for i in range(5):
        p = str(tmp_path / '{}.png'.format(i))
        jax_io.save_depth(_depth_with_edges(rng), p)
        paths.append(p)
        ref.append(jax_io.load_depth(p))
    np.testing.assert_array_equal(
        native.batch_read_depth(paths, 24, 40, n_threads=3), np.stack(ref))
    assert native.probe(paths[0]) == (24, 40)


# -- camera frames -------------------------------------------------------------


def _pil_frame(rng, mode, h=21, w=35):
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if mode == 'RGB':
        return Image.fromarray(rgb)
    if mode == 'RGBA':
        return Image.fromarray(np.concatenate(
            [rgb, rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], 2))
    if mode == 'L':
        return Image.fromarray(rgb[..., 0])
    if mode == 'LA':
        return Image.fromarray(rgb[..., :2], 'LA')
    if mode.startswith('P'):
        colors = int(mode[1:])
        return Image.fromarray(rgb).quantize(colors)
    if mode == '1':
        return Image.fromarray(rgb[..., 0] > 127)
    raise ValueError(mode)


@pytest.mark.parametrize('mode', ['RGB', 'RGBA', 'L', 'LA', 'P256', 'P16',
                                  'P4', 'P2', '1'])
def test_camera_png_equals_pil(tmp_path, rng, mode):
    """PIL writes 8-bit PNGs of each mode (palettes of 4 colors or fewer at
    1, 2 or 4 bits); the port reads them as PIL's convert('RGB')."""
    path = str(tmp_path / 'f.png')
    _pil_frame(rng, mode).save(path)
    want = np.asarray(Image.open(path).convert('RGB'))
    got = io.load_image_u8(path, device='cpu')
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.load_image(path, device='cpu'),
                                  jax_io.load_image(path))
    np.testing.assert_array_equal(
        io.load_image(path, normalize=True, data_format='CHW', device='cpu'),
        jax_io.load_image(path, normalize=True, data_format='CHW'))


def _filter(kind, cur, prev, bpp):
    """PNG filter ``kind`` of one row (numpy int arrays of bytes)."""
    a = np.concatenate([np.zeros(bpp, int), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, int), prev[:-bpp]])
    b = prev
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (cur - pred) % 256


def _chunk(ctype, body):
    return struct.pack('>I', len(body)) + ctype + body + struct.pack(
        '>I', zlib.crc32(ctype + body))


def _handmade_png(image, kinds, bit_depth=8):
    """An RGB PNG whose row y takes filter kinds[y % len(kinds)], made
    without any PNG library."""
    h, w, _ = image.shape
    if bit_depth == 16:
        rows = image.astype('>u2').view(np.uint8).reshape(h, -1)
    else:
        rows = image.reshape(h, -1)
    bpp = 3 * bit_depth // 8
    rows = rows.astype(int)
    prev = np.zeros(rows.shape[1], int)
    out = b''
    for y in range(h):
        kind = kinds[y % len(kinds)]
        out += bytes([kind]) + _filter(kind, rows[y], prev, bpp).astype(
            np.uint8).tobytes()
        prev = rows[y]
    header = struct.pack('>IIBBBBB', w, h, bit_depth, 2, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header) +
            _chunk(b'IDAT', zlib.compress(out)) + _chunk(b'IEND', b''))


@pytest.mark.parametrize('bit_depth', [8, 16])
def test_every_row_filter_equals_pil(tmp_path, rng, bit_depth):
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    image = rng.integers(0, 1 << bit_depth, (25, 33, 3), dtype=dtype)
    path = str(tmp_path / 'f.png')
    with open(path, 'wb') as f:
        f.write(_handmade_png(image, [0, 1, 2, 3, 4, 4, 3, 2, 1], bit_depth))
    want = np.asarray(Image.open(path).convert('RGB'))
    if bit_depth == 8:
        np.testing.assert_array_equal(want, image)
    np.testing.assert_array_equal(io.load_image_u8(path, device='cpu'), want)


def test_rgb_writer_round_trip_and_pil(tmp_path, rng):
    """save_image of a [0, 1] frame: PIL reads the 8-bit frame, the port
    reads it back exactly, and the writer's rows use every filter."""
    image = rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
    image[10:20] = np.linspace(0, 255, 50).astype(np.uint8)[None, :, None]
    path = str(tmp_path / 'f.png')
    io.save_image(image / 255.0, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
    np.testing.assert_array_equal(io.load_image_u8(path, device='cpu'), image)
    native.write_rgb(path, image)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
    np.testing.assert_array_equal(
        native.batch_read_images([path, path], 30, 50, n_threads=2),
        np.stack([image, image]).astype(np.float32))


def test_png_row_filters_cover_all_five(rng):
    """The writer picks among the five filters per row; a smooth frame and
    a noisy one make it pick several, and decode returns the samples."""
    h, w = 40, 64
    smooth = np.broadcast_to(
        np.linspace(0, 65535, w).astype(np.uint16)[None], (h, w)).copy()
    smooth[h // 2:] = rng.integers(0, 65536, (h - h // 2, w), dtype=np.uint16)
    data = native.encode_png(smooth, 0)
    raw = zlib.decompress(data[data.index(b'IDAT') + 4:-16])
    kinds = set(raw[::2 * w + 1])
    assert len(kinds) >= 2 and kinds <= {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(native.decode_png(data).samples[..., 0],
                                  smooth)


def test_jpeg_within_the_codec_tolerance(tmp_path, rng):
    """This host decodes JPEG with libjpeg (device='cpu'): against PIL's
    decode of the committed fixture, and of a fresh quality-95 frame."""
    path = os.path.join(FIXTURES, 'frame_q95.jpg')
    want = np.asarray(Image.open(os.path.join(FIXTURES, 'frame_q95_pil.png')))
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert('RGB')),
                                  want)
    assert want.shape == (96, 160, 3)
    got = io.load_image_u8(path, device='cpu')
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.mean() < JPEG_MEAN_ABS and diff.max() <= JPEG_MAX_ABS
    # this host's libjpeg is libjpeg-turbo, as PIL's: exact
    np.testing.assert_array_equal(got, want)
    assert native.probe(path) == (96, 160)
    # the port reads the PIL decode (a PNG) exactly
    np.testing.assert_array_equal(
        io.load_image_u8(os.path.join(FIXTURES, 'frame_q95_pil.png'),
                         device='cpu'), want)

    fresh = str(tmp_path / 'f.jpg')
    Image.fromarray(rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)).save(
        fresh, quality=95)
    diff = np.abs(io.load_image(fresh, device='cpu') -
                  jax_io.load_image(fresh))
    assert diff.mean() < JPEG_MEAN_ABS and diff.max() <= JPEG_MAX_ABS


@pytest.mark.parametrize('subsampling,size', [
    (0, (37, 53)), (1, (37, 53)), (2, (37, 53)), (2, (96, 160)),
    (2, (1, 9)), ('gray', (21, 34)), ('progressive', (40, 64))])
def test_jpeg_equals_pil_on_the_host(tmp_path, rng, subsampling, size):
    """libjpeg's planes, upsampled and converted by the port (codec.cpp),
    equal PIL's decode exactly: 4:4:4, 4:2:2, 4:2:0 at odd sizes, gray and
    progressive."""
    h, w = size
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    path = str(tmp_path / 'f.jpg')
    if subsampling == 'gray':
        Image.fromarray(image[..., 0]).save(path, quality=90)
    elif subsampling == 'progressive':
        Image.fromarray(image).save(path, quality=80, progressive=True)
    else:
        Image.fromarray(image).save(path, quality=90,
                                    subsampling=subsampling)
    np.testing.assert_array_equal(io.load_image_u8(path, device='cpu'),
                                  np.asarray(Image.open(path).convert('RGB')))


def test_jpeg_decodes_on_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        io.load_image_u8(os.path.join(FIXTURES, 'frame_q95.jpg'))


def _corrupt_pngs(tmp_path, rng):
    good = str(tmp_path / 'good.png')
    io.save_depth(_depth_with_edges(rng), good)
    data = open(good, 'rb').read()
    cases = {
        'truncated': data[:len(data) // 2],
        'crc': data[:40] + bytes([data[40] ^ 0xFF]) + data[41:],
        'not_png': b'\x89PNX' + data[4:],
        'empty': b'',
    }
    # a bad filter type under a valid CRC and a valid zlib stream
    body = zlib.compress(b'\x07' + b'\x00' * 80)
    header = struct.pack('>IIBBBBB', 40, 1, 16, 0, 0, 0, 0)
    cases['filter'] = (b'\x89PNG\r\n\x1a\n' + _chunk(b'IHDR', header) +
                       _chunk(b'IDAT', body) + _chunk(b'IEND', b''))
    paths = {}
    for name, blob in cases.items():
        paths[name] = str(tmp_path / '{}.png'.format(name))
        with open(paths[name], 'wb') as f:
            f.write(blob)
    return good, paths


def test_corrupt_png_raises_oserror_and_the_codec_stays_usable(tmp_path,
                                                                rng):
    good, paths = _corrupt_pngs(tmp_path, rng)
    for name, path in paths.items():
        with pytest.raises(OSError):
            io.load_depth(path)
        with pytest.raises(OSError):
            io.load_image_u8(path, device='cpu')
    with pytest.raises(OSError):
        native.batch_read_depth([good, paths['crc'], good], 24, 40,
                                n_threads=3)
    np.testing.assert_array_equal(io.load_depth(good),
                                  jax_io.load_depth(good))


def test_corrupt_jpeg_raises_oserror_and_the_codec_stays_usable(tmp_path):
    good = os.path.join(FIXTURES, 'frame_q95.jpg')
    data = open(good, 'rb').read()
    bad = {'garbage': b'\xff\xd8\xff\xe0' + b'\x00' * 64,
           'no_scan': data[:data.index(b'\xff\xda')]}
    for name, blob in bad.items():
        path = str(tmp_path / '{}.jpg'.format(name))
        with open(path, 'wb') as f:
            f.write(blob)
        with pytest.raises(OSError):
            io.load_image_u8(path, device='cpu')
        with pytest.raises(OSError):
            native.batch_read_images([good, path, good], 96, 160,
                                     n_threads=3, device='cpu')
    assert io.load_image_u8(good, device='cpu').shape == (96, 160, 3)


def test_png_refuses_what_it_does_not_read(tmp_path, rng):
    """An interlaced PNG and a color PNG read as depth raise OSError."""
    path = str(tmp_path / 'i.png')
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
        path)
    with pytest.raises(OSError, match='grayscale'):
        io.load_depth(path)
    data = bytearray(open(path, 'rb').read())
    data[28] = 1  # interlace method
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29])))
    with open(path, 'wb') as f:
        f.write(bytes(data))
    with pytest.raises(OSError, match='interlaced'):
        io.load_image_u8(path, device='cpu')


def test_build_failure_names_what_is_missing(monkeypatch):
    """No fallback: a codec that cannot be built raises, naming the
    compiler."""
    monkeypatch.setattr(native, '_LIBS', {})
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    monkeypatch.setattr(native.os.path, 'exists', lambda p: False)
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        native.codec_lib()


# -- manifests, points, dataset, metrics ----------------------------------------


def test_read_and_write_paths(tmp_path):
    paths = ['/a/b.png', 'c d.png', 'e.npy']
    for module in (io, jax_io):
        p = str(tmp_path / 'm.txt')
        module.write_paths(p, paths)
        assert io.read_paths(p) == jax_io.read_paths(p) == paths
    with open(str(tmp_path / 'gap.txt'), 'w') as f:
        f.write('a\nb\n\nc\n')
    assert io.read_paths(str(tmp_path / 'gap.txt')) == ['a', 'b']


@pytest.mark.parametrize('n,k', [(3, 8), (8, 8), (0, 4)])
def test_pad_points_matches_jax(rng, n, k):
    points = rng.random((n, 3)).astype(np.float32)
    for a, b in zip(datasets.pad_points(points, k),
                    jax_datasets.pad_points(points, k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pad_points_warns_on_truncation(rng):
    points = rng.random((12, 3)).astype(np.float32)
    with pytest.warns(RuntimeWarning, match='truncating 12 radar points'):
        out, valid = datasets.pad_points(points, 8)
    np.testing.assert_array_equal(out, points[:8])
    assert valid.all()


def _dataset_files(tmp_path, rng, n=3, h=20, w=30):
    image_paths, radar_paths, gt_paths = [], [], []
    for i in range(n):
        p = str(tmp_path / 'im{}.png'.format(i))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            p)
        image_paths.append(p)
        p = str(tmp_path / 'r{}.npy'.format(i))
        # one point file is 1-D, one holds 13 points
        k = (1, 13, 5)[i % 3]
        pts = np.stack([rng.integers(0, w, k), rng.integers(0, h, k),
                        rng.random(k) * 70 + 1], 1).astype(np.float64)
        np.save(p, pts[0] if k == 1 else pts)
        radar_paths.append(p)
        p = str(tmp_path / 'gt{}.png'.format(i))
        jax_io.save_depth(_depth_with_edges(rng, h, w), p)
        gt_paths.append(p)
    return image_paths, radar_paths, gt_paths


def test_max_points_in_files(tmp_path, rng):
    _, radar_paths, _ = _dataset_files(tmp_path, rng)
    assert datasets.max_points_in_files(radar_paths) == \
        jax_datasets.max_points_in_files(radar_paths) == 13


@pytest.mark.parametrize('with_gt', [True, False])
@pytest.mark.parametrize('max_points', [None, 16])
def test_inference_dataset_matches_jax(tmp_path, rng, with_gt, max_points):
    images, radars, gts = _dataset_files(tmp_path, rng)
    gts = gts if with_gt else None
    port = datasets.RadarNetInferenceDataset(images, radars, gts,
                                             max_points=max_points,
                                             device='cpu')
    ref = jax_datasets.RadarNetInferenceDataset(images, radars, gts,
                                                max_points=max_points,
                                                transport=True)
    assert len(port) == len(ref) and port.max_points == ref.max_points
    assert port.ground_truth_available == with_gt
    for i in range(len(ref)):
        got, want = port.get(i), ref.get(i)
        assert len(got) == len(want) == (4 if with_gt else 3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        # the host decode of the transport equals the JAX one
        for a, b in zip(transport.decode_np(got),
                        transport.decode_np(want)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_transport_encoders_match_jax(rng):
    from rcfd_tpu.data import transport as jax_transport
    img = rng.random((4, 5, 3)) * 255
    np.testing.assert_array_equal(transport.encode_image(img),
                                  jax_transport.encode_image(img))
    for raw in (np.array([[-3, 0, 65535]], np.int64),
                np.array([[0, 70000]], np.int64)):
        a, b = transport.encode_png_int(raw), jax_transport.encode_png_int(raw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batch = {'u8': np.arange(4, dtype=np.uint8),
             'u16': np.arange(4, dtype=np.uint16) * 300,
             'f': (np.arange(3.0), np.ones(2, bool))}
    got, want = transport.decode_np(batch), jax_transport.decode_np(batch)
    np.testing.assert_array_equal(got['u8'], want['u8'])
    np.testing.assert_array_equal(got['u16'], want['u16'])
    assert got['u16'].dtype == want['u16'].dtype == np.float32
    np.testing.assert_array_equal(got['f'][0], want['f'][0])


@pytest.mark.parametrize('bounds', [(0.0, 80.0), (5.0, 40.0)])
def test_compute_all_matches_jax(rng, bounds):
    gt = (rng.random((30, 40)) * 90).astype(np.float32)
    gt[gt < 10] = 0
    out = (gt + rng.standard_normal(gt.shape) * 2 + 1).astype(np.float32)
    got = eval_utils.compute_all(out, gt, *bounds)
    want = jax_eval.compute_all(out, gt, *bounds)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k] and np.isfinite(got[k])
