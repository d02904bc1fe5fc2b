"""The port's image codec: 8- and 16-bit PNG read and write, and JPEG read
(counterpart of rcfd_tpu/native/__init__.py and its dataloader.cpp).

The JAX package decodes through libpng and libjpeg, and gives way to PIL
when they are missing. The GPU machine has neither library nor Pillow, so
the port takes other routes, the same on every machine, and raises when one
cannot be built; nothing falls back:

  PNG   chunks parsed and checked (CRC) here, inflated and deflated with
        the standard library's zlib; the row filters, which are sequential
        along a row, in ``codec.cpp`` (no library needed). Non-interlaced
        PNGs of every color type and bit depth are read; writers make
        16-bit grayscale (depth and response maps) and 8-bit RGB.
  JPEG  the YCbCr planes decoded on a CUDA device by nvJPEG of the CUDA
        toolkit (``jpeg_nvjpeg.cpp``), on the CPU by libjpeg
        (``jpeg_host.cpp``, with the JAX codec's error handler); then
        upsampled and converted to RGB on the host with libjpeg-turbo's
        arithmetic (``codec.cpp``), so both give PIL's decode but for the
        inverse DCT. Gray, 4:4:4, 4:2:2 and 4:2:0 YCbCr are read.

Each C++ source is built with ``g++ -O3 -shared -fPIC`` at first use into
``rcfd_tpu_torch/_build/``, named after a hash of the source and its flags,
and loaded with ctypes. A corrupt or truncated file raises OSError.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib

import numpy as np
import torch

from .. import default_device
from ..ops import _build

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_TIMEOUT_S = 300
# deflate level of the PNG writers: zlib's fastest. Level 6 (the default
# of libpng and PIL) wrote a smooth 900x1600 depth map 9% smaller in 8.8
# times the time
ZLIB_LEVEL = 1

PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# channels of each PNG color type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# JPEG start-of-frame markers (those that carry the image size)
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}

_LIBS = {}
_LOCK = threading.Lock()


def _compile(source: str, compile_flags=(), link_flags=(), needs: str = ''):
    """Build ``source`` of this directory with g++ into a shared library
    (once per content and flags) and load it. Raises RuntimeError naming
    the compiler, or what the source needs, when the build fails."""
    with _LOCK:
        if source in _LIBS:
            return _LIBS[source]
        path = os.path.join(_DIR, source)
        flags = ['-O3', '-shared', '-fPIC', '-std=c++17', *compile_flags]
        digest = hashlib.sha256(' '.join(flags + list(link_flags)).encode())
        with open(path, 'rb') as f:
            digest.update(f.read())
        out = os.path.join(_build.BUILD_DIR, 'lib{}-{}.so'.format(
            os.path.splitext(source)[0], digest.hexdigest()[:16]))
        if not os.path.exists(out):
            gxx = shutil.which('g++')
            if gxx is None:
                raise RuntimeError(
                    'g++ not found on PATH: rcfd_tpu_torch/native/{} is built '
                    'with it at first use'.format(source))
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            tmp = '{}.{}.tmp'.format(out, os.getpid())
            proc = subprocess.run([gxx, *flags, path, '-o', tmp,
                                   *link_flags], capture_output=True,
                                  text=True, timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    'g++ could not build rcfd_tpu_torch/native/{}, which '
                    'needs {} (exit {}):\n{}'.format(
                        source, needs or 'only a C++17 compiler',
                        proc.returncode, proc.stderr))
            os.replace(tmp, out)
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise RuntimeError(
                'rcfd_tpu_torch/native/{} was built but does not load; it '
                'needs {}: {}'.format(source, needs or 'no library', e))
        _LIBS[source] = lib
        return lib


def codec_lib():
    """The PNG row filters and the JPEG color conversion (codec.cpp)."""
    lib = _compile('codec.cpp')
    for fn in (lib.rcfd_png_unfilter, lib.rcfd_png_filter,
               lib.rcfd_jpeg_ycc_to_rgb):
        fn.restype = ctypes.c_int64
    lib.rcfd_png_unfilter.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int]
    lib.rcfd_png_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    lib.rcfd_jpeg_ycc_to_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def jpeg_host_lib():
    """The libjpeg decoder of JPEG planes (jpeg_host.cpp)."""
    lib = _compile('jpeg_host.cpp', link_flags=('-ljpeg',),
                   needs="libjpeg: its header jpeglib.h and -ljpeg")
    lib.rcfd_jpeg_read_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.rcfd_jpeg_read_planes.restype = ctypes.c_int
    return lib


def cuda_root() -> str:
    """The CUDA toolkit's root: the directory above nvcc's."""
    return os.path.dirname(os.path.dirname(os.path.realpath(
        _build.find_nvcc())))


def nvjpeg_lib():
    """The nvJPEG decoder of JPEG planes (jpeg_nvjpeg.cpp)."""
    root = cuda_root()
    lib_dir = os.path.join(root, 'lib64')
    lib = _compile(
        'jpeg_nvjpeg.cpp',
        compile_flags=('-I' + os.path.join(root, 'include'),),
        link_flags=('-L' + lib_dir, '-Wl,-rpath,' + lib_dir, '-lnvjpeg'),
        needs='nvJPEG of the CUDA toolkit: nvjpeg.h and libnvjpeg under '
              + root)
    lib.rcfd_nvjpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_void_p]
    lib.rcfd_nvjpeg_decode_planes.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.rcfd_nvjpeg_info, lib.rcfd_nvjpeg_decode_planes):
        fn.restype = ctypes.c_int
    return lib


def _read_file(path: str) -> bytes:
    with open(path, 'rb') as f:
        return f.read()


def _is_jpeg(data: bytes) -> bool:
    return data[:2] == b'\xff\xd8'


def _jpeg_size(data: bytes, path: str):
    """(height, width) from the first start-of-frame segment."""
    i, n = 2, len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            break
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:  # no length
            i += 2
            continue
        if marker in _SOF and i + 9 <= n:
            h, w = struct.unpack_from('>HH', data, i + 5)
            return h, w
        i += 2 + struct.unpack_from('>H', data, i + 2)[0]
    raise OSError('{}: corrupt JPEG: no frame header'.format(path))


# -- PNG ---------------------------------------------------------------------


class Png:
    """A decoded PNG: ``samples`` (H, W, channels), uint8 for bit depths up
    to 8 (sub-byte samples unpacked, not scaled) and uint16 for 16;
    ``color_type`` and ``bit_depth`` of the header; ``palette`` (n, 3)
    uint8 for color type 3."""

    def __init__(self, samples, color_type, bit_depth, palette):
        self.samples = samples
        self.color_type = color_type
        self.bit_depth = bit_depth
        self.palette = palette


def _chunks(data: bytes, path: str):
    """Yield (type, body) of each chunk up to IEND, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise OSError('{}: not a PNG file'.format(path))
    view, pos = memoryview(data), 8
    while True:
        if pos + 12 > len(data):
            raise OSError('{}: truncated PNG (no IEND chunk)'.format(path))
        length, ctype = struct.unpack_from('>I4s', data, pos)
        end = pos + 8 + length
        if end + 4 > len(data):
            raise OSError('{}: truncated PNG in a {} chunk'.format(
                path, ctype.decode('latin-1')))
        body = view[pos + 8:end]
        if zlib.crc32(body, zlib.crc32(ctype)) != struct.unpack_from(
                '>I', data, end)[0]:
            raise OSError('{}: corrupt PNG: CRC error in a {} chunk'.format(
                path, ctype.decode('latin-1')))
        yield ctype, body
        if ctype == b'IEND':
            return
        pos = end + 4


def decode_png(data: bytes, path: str = '<bytes>') -> Png:
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if ctype == b'IHDR':
            if len(body) != 13:
                raise OSError('{}: corrupt PNG header'.format(path))
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b'IDAT':
            idat.append(body)
    if header is None or not idat:
        raise OSError('{}: corrupt PNG: no IHDR or no IDAT chunk'.format(
            path))
    w, h, bit_depth, color_type, compression, filtering, interlace = header
    if bit_depth not in _BIT_DEPTHS.get(color_type, ()) or compression or \
            filtering or w == 0 or h == 0:
        raise OSError('{}: corrupt PNG header (color type {}, bit depth {})'
                      .format(path, color_type, bit_depth))
    if interlace:
        raise OSError('{}: interlaced (Adam7) PNGs are not read by this '
                      'codec'.format(path))
    if color_type == 3 and palette is None:
        raise OSError('{}: corrupt PNG: palette image without PLTE'.format(
            path))
    channels = _CHANNELS[color_type]
    bits = channels * bit_depth
    rowbytes = (w * bits + 7) // 8
    size = h * (rowbytes + 1)
    try:
        raw = zlib.decompress(b''.join(idat), bufsize=size)
    except zlib.error as e:
        raise OSError('{}: corrupt PNG image data: {}'.format(path, e))
    if len(raw) < size:
        raise OSError('{}: truncated PNG image data ({} of {} bytes)'.format(
            path, len(raw), size))
    rows = np.empty((h, rowbytes), np.uint8)
    rc = codec_lib().rcfd_png_unfilter(raw, rows.ctypes.data, h, rowbytes,
                                       max(1, bits // 8))
    if rc != 0:
        raise OSError('{}: corrupt PNG: unknown filter type in row {}'.format(
            path, -rc - 1))
    if bit_depth == 16:
        samples = rows.view('>u2').astype(np.uint16)
    elif bit_depth == 8:
        samples = rows
    else:
        per_byte = 8 // bit_depth
        shifts = np.arange(8 - bit_depth, -1, -bit_depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & np.uint8(
            (1 << bit_depth) - 1)
        samples = samples.reshape(h, rowbytes * per_byte)[:, :w]
    return Png(samples.reshape(h, w, channels), color_type, bit_depth,
               palette)


def read_png(path: str) -> Png:
    return decode_png(_read_file(path), path)


def png_to_rgb(png: Png) -> np.ndarray:
    """uint8 (H, W, 3) as PIL's ``Image.open(p).convert('RGB')`` gives it:
    gray replicated (sub-byte gray scaled to 0-255, 16-bit gray clipped to
    255), palette indices looked up (transparency dropped), alpha dropped,
    16-bit color reduced to its high byte."""
    s = png.samples
    if png.color_type == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(png.palette)] = png.palette[:256]
        return palette[s[..., 0]]
    if png.color_type in (0, 4):
        gray = s[..., 0]
        if png.bit_depth == 16:
            gray = np.minimum(gray, 255).astype(np.uint8)
        elif png.bit_depth < 8:
            gray = gray * np.uint8(255 // ((1 << png.bit_depth) - 1))
        return np.repeat(gray[..., None], 3, axis=2)
    rgb = s[..., :3]
    if png.bit_depth == 16:
        rgb = (rgb >> 8).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def _png_chunk(ctype: bytes, body) -> bytes:
    crc = zlib.crc32(body, zlib.crc32(ctype))
    return struct.pack('>I', len(body)) + ctype + bytes(body) + \
        struct.pack('>I', crc)


def encode_png(samples: np.ndarray, color_type: int) -> bytes:
    """A non-interlaced PNG of ``samples``: (H, W) uint16 as 16-bit
    grayscale (color type 0), (H, W) uint8 as 8-bit grayscale (type 0, the
    legacy label maps: PIL's mode 'L'), or (H, W, 3) uint8 as 8-bit RGB
    (type 2). Each row takes the filter of least cost, as libpng's default
    does."""
    if color_type == 0 and samples.dtype == np.uint16 and samples.ndim == 2:
        rows = samples.astype('>u2').view(np.uint8)
        bit_depth, bpp = 16, 2
    elif color_type == 0 and samples.dtype == np.uint8 and \
            samples.ndim == 2:
        rows = samples
        bit_depth, bpp = 8, 1
    elif color_type == 2 and samples.dtype == np.uint8 and \
            samples.ndim == 3 and samples.shape[2] == 3:
        rows = samples
        bit_depth, bpp = 8, 3
    else:
        raise TypeError('encode_png writes (H, W) uint16 or uint8 as '
                        'grayscale or (H, W, 3) uint8 as RGB; got {} {} as '
                        'color type {}'
                        .format(samples.dtype, samples.shape, color_type))
    h, w = samples.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    rowbytes = rows.shape[1]
    filtered = np.empty((h, rowbytes + 1), np.uint8)
    scratch = np.empty(2 * rowbytes, np.uint8)
    codec_lib().rcfd_png_filter(rows.ctypes.data, filtered.ctypes.data, h,
                                rowbytes, bpp, scratch.ctypes.data)
    data = zlib.compress(filtered, ZLIB_LEVEL)
    header = struct.pack('>IIBBBBB', w, h, bit_depth, color_type, 0, 0, 0)
    # a chunk holds at most 2^31 - 1 bytes
    idat = b''.join(_png_chunk(b'IDAT', data[i:i + (1 << 30)])
                    for i in range(0, len(data), 1 << 30))
    return PNG_SIGNATURE + _png_chunk(b'IHDR', header) + idat + \
        _png_chunk(b'IEND', b'')


# -- the bindings (rcfd_tpu/native/__init__.py:96-165) ------------------------


def probe(path: str):
    """(height, width) of a PNG or JPEG, from its header."""
    with open(path, 'rb') as f:
        head = f.read(1 << 16)
    if head[:8] == PNG_SIGNATURE:
        if len(head) < 24 or head[12:16] != b'IHDR':
            raise OSError('{}: corrupt PNG header'.format(path))
        w, h = struct.unpack_from('>II', head, 16)
        return h, w
    if _is_jpeg(head):
        return _jpeg_size(_read_file(path), path)
    raise OSError('{}: neither a PNG nor a JPEG file'.format(path))


def read_depth_raw(path: str) -> np.ndarray:
    """The integers of an 8- or 16-bit grayscale PNG, (H, W) uint8 or
    uint16."""
    png = read_png(path)
    if png.color_type != 0 or png.bit_depth not in (8, 16):
        raise OSError('{}: a depth PNG is 8- or 16-bit grayscale; this is '
                      'color type {} at {} bits'.format(
                          path, png.color_type, png.bit_depth))
    return png.samples[..., 0]


def read_depth(path: str, multiplier: float = 256.0) -> np.ndarray:
    """float32 (H, W): the integers over ``multiplier``, non-positive
    values zeroed (load_depth)."""
    z = read_depth_raw(path).astype(np.float32) / multiplier
    z[z <= 0] = 0.0
    return z


def depth_codes(depth, multiplier: float = 256.0) -> np.ndarray:
    """uint16 codes of PIL's mode-'I' PNG save of uint32(z * multiplier):
    the int32 view of the uint32, clipped to [0, 65535]."""
    q = np.uint32(np.asarray(depth) * multiplier).astype(np.int32)
    return np.clip(q, 0, 65535).astype(np.uint16)


def write_depth(path: str, depth, multiplier: float = 256.0):
    """Save a float map as a 16-bit grayscale PNG of uint32(z *
    multiplier) (save_depth)."""
    write_u16(path, depth_codes(depth, multiplier))


def write_u16(path: str, codes):
    """Save (H, W) uint16 codes as a 16-bit grayscale PNG."""
    codes = np.asarray(codes)
    if codes.dtype != np.uint16 or codes.ndim != 2:
        raise TypeError('write_u16 takes (H, W) uint16, got {} {}'.format(
            codes.dtype, codes.shape))
    data = encode_png(codes, 0)
    with open(path, 'wb') as f:
        f.write(data)


def write_u8(path: str, samples):
    """Save (H, W) uint8 samples as an 8-bit grayscale PNG."""
    samples = np.asarray(samples)
    if samples.dtype != np.uint8 or samples.ndim != 2:
        raise TypeError('write_u8 takes (H, W) uint8, got {} {}'.format(
            samples.dtype, samples.shape))
    data = encode_png(samples, 0)
    with open(path, 'wb') as f:
        f.write(data)


def write_rgb(path: str, image):
    """Save (H, W, 3) uint8 as an 8-bit RGB PNG."""
    data = encode_png(np.asarray(image), 2)
    with open(path, 'wb') as f:
        f.write(data)


def _plane_shapes(h, w, n, hs, vs):
    """(rows, columns) of each plane: the luma's, then the chroma's."""
    return [(h, w)] + [(-(-h // vs), -(-w // hs))] * (n - 1)


def ycc_to_rgb(planes, hs: int, vs: int) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG's planes (``planes[0]`` the luma; no
    chroma for a gray image), upsampled and converted as libjpeg-turbo's
    default decode does (codec.cpp)."""
    planes = [np.ascontiguousarray(p, np.uint8) for p in planes]
    h, w = planes[0].shape
    out = np.empty((h, w, 3), np.uint8)
    chroma = [p.ctypes.data for p in planes[1:]] or [None, None]
    rc = codec_lib().rcfd_jpeg_ycc_to_rgb(planes[0].ctypes.data, *chroma, h,
                                          w, hs, vs, out.ctypes.data)
    if rc != 0:
        raise OSError('JPEG sampling {}x{} is not read by this codec'.format(
            hs, vs))
    return out


def _jpeg_planes_cuda(data: bytes, path: str, device):
    lib = nvjpeg_lib()
    info = (ctypes.c_int * 11)()
    rc = lib.rcfd_nvjpeg_info(data, len(data), info)
    if rc != 0:
        raise OSError('{}: nvJPEG cannot read this JPEG ({}{})'.format(
            path, rc, '; only gray, 4:4:4, 4:2:2 and 4:2:0 are read'
            if rc == -4 else ''))
    h, w, n, hs, vs = info[:5]
    shapes = _plane_shapes(h, w, n, hs, vs)
    if [(info[6 + 2 * c], info[5 + 2 * c]) for c in range(n)] != shapes:
        raise OSError('{}: nvJPEG gives planes {} where {} were '
                      'expected'.format(path, list(info[5:]), shapes))
    planes = [torch.empty(s, dtype=torch.uint8, device=device)
              for s in shapes]
    pointers = (ctypes.c_void_p * 3)(*[p.data_ptr() for p in planes])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.rcfd_nvjpeg_decode_planes(data, len(data), pointers, stream)
    if rc != 0:
        raise OSError('{}: nvJPEG could not decode this JPEG ({})'.format(
            path, rc))
    return [p.cpu().numpy() for p in planes], hs, vs


def _jpeg_planes_host(path: str):
    lib = jpeg_host_lib()
    info = (ctypes.c_int * 5)()
    rc = lib.rcfd_jpeg_read_planes(path.encode(), info, None)  # the header
    if rc == 0:
        h, w, n, hs, vs = info
        planes = [np.empty(s, np.uint8)
                  for s in _plane_shapes(h, w, n, hs, vs)]
        pointers = (ctypes.c_void_p * 3)(*[p.ctypes.data for p in planes])
        rc = lib.rcfd_jpeg_read_planes(path.encode(), info, pointers)
    if rc != 0:
        raise OSError('{}: libjpeg could not decode this JPEG ({}{})'.format(
            path, rc, '; only gray, 4:4:4, 4:2:2 and 4:2:0 YCbCr are read'
            if rc == -4 else ''))
    return planes, hs, vs


def _decode_jpeg(data: bytes, path: str, device) -> np.ndarray:
    """A JPEG's planes decoded on ``device`` (nvJPEG on a CUDA device,
    libjpeg on the CPU), then upsampled and converted on the host."""
    device = default_device(device)
    if device.type == 'cuda':
        planes, hs, vs = _jpeg_planes_cuda(data, path, device)
    elif device.type == 'cpu':
        planes, hs, vs = _jpeg_planes_host(path)
    else:
        raise ValueError('JPEG decodes on a CUDA device or the CPU, not on '
                         '{}'.format(device))
    return ycc_to_rgb(planes, hs, vs)


def read_image_u8(path: str, device=None) -> np.ndarray:
    """An RGB frame, (H, W, 3) uint8, from a PNG (on the host) or a JPEG (on
    ``device``: nvJPEG on a CUDA device, libjpeg on the CPU; ``cuda``
    unless ``device='cpu'``, as the port's entry points)."""
    data = _read_file(path)
    if _is_jpeg(data):
        return _decode_jpeg(data, path, device)
    return png_to_rgb(decode_png(data, path))


def read_image(path: str, device=None) -> np.ndarray:
    """``read_image_u8`` as float32 in [0, 255]."""
    return read_image_u8(path, device).astype(np.float32)


def _threads(n_threads: int) -> int:
    """Decode threads beyond the usable core count only thrash."""
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, 'sched_getaffinity') else os.cpu_count()
    return max(1, min(n_threads, cores))


def _batch(fn, paths, shape, n_threads):
    out = np.empty((len(paths),) + shape, np.float32)

    def one(i):
        a = fn(paths[i])
        if a.shape != shape:
            raise OSError('{}: size {} in a batch of {}'.format(
                paths[i], a.shape, shape))
        out[i] = a

    with concurrent.futures.ThreadPoolExecutor(_threads(n_threads)) as pool:
        list(pool.map(one, range(len(paths))))
    return out


def batch_read_depth(paths, height: int, width: int,
                     multiplier: float = 256.0,
                     n_threads: int = 8) -> np.ndarray:
    """Depth PNGs of one size, (N, H, W) float32, read in threads (zlib and
    the row filters run without the GIL)."""
    return _batch(lambda p: read_depth(p, multiplier), paths,
                  (height, width), n_threads)


def batch_read_images(paths, height: int, width: int, n_threads: int = 8,
                      device=None) -> np.ndarray:
    """RGB frames of one size, (N, H, W, 3) float32 in [0, 255], read in
    threads; JPEGs decode on ``device`` as in ``read_image_u8``."""
    return _batch(lambda p: read_image(p, device), paths,
                  (height, width, 3), n_threads)
