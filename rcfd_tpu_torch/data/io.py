"""Host-side data I/O: path manifests and the 8- and 16-bit PNG codecs
(counterpart of rcfd_tpu/data/io.py), through the port's own codec
(rcfd_tpu_torch/native), without Pillow; and stage 0's densification of
the ground truth (``interpolate_depth``, scipy on the host).

Byte-compatible with the reference's formats: depth maps are 16-bit
grayscale PNGs quantized by x256 (PIL's mode-'I' save: uint32(z * m),
clipped to 16 bits); response maps by x2^14; camera frames are 8-bit PNGs
or JPEGs; radar point sets are .npy float arrays of shape (N, 3) = (x, y,
z) in image-plane coordinates.

A JPEG frame decodes on ``device``: with nvJPEG on a CUDA device, with
libjpeg on the CPU (``cuda`` unless ``device='cpu'``, as the port's entry
points). PNGs decode on the host whatever the device.

With the decode-once raw cache on (data/raw_cache.py), the readers of
frames and 16-bit maps read through it: the first read of a file decodes
it with the codec above, later reads map the cached raw array (host uint8
or the PNG's integers) and convert it as the decode would.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .. import native
from .raw_cache import load_raw
from .transport import encode_png_int


def read_paths(filepath: str) -> List[str]:
    """Read a newline-delimited path manifest (stops at the first empty
    line, like the reference src/data_utils.py:128-150)."""
    path_list = []
    with open(filepath) as f:
        while True:
            path = f.readline().rstrip('\n')
            if path == '':
                break
            path_list.append(path)
    return path_list


def write_paths(filepath: str, paths: List[str]):
    with open(filepath, 'w') as o:
        for path in paths:
            o.write(path + '\n')


def _layout(image, data_format):
    if data_format == 'HWC':
        return image
    elif data_format == 'CHW':
        return np.transpose(image, (2, 0, 1))
    raise ValueError('Unsupported data format: {}'.format(data_format))


def _expand(z, data_format):
    if data_format == 'HW':
        return z
    elif data_format == 'CHW':
        return np.expand_dims(z, axis=0)
    elif data_format == 'HWC':
        return np.expand_dims(z, axis=-1)
    raise ValueError('Unsupported data format: {}'.format(data_format))


def load_image_raw(path: str, device=None):
    """uint8 (H, W, 3) RGB image, a read-only map of the cached array when
    the raw cache is on. A window of it converts as the whole frame would
    (datasets.py crops before converting)."""
    return load_raw(path, 'image', lambda: native.read_image_u8(path, device))


def load_image_u8(path: str, data_format: str = 'HWC', device=None):
    """uint8 RGB image for integer host->device transport, as PIL's
    ``convert('RGB')`` gives it."""
    return _layout(load_image_raw(path, device), data_format)


def load_image(path: str, normalize: bool = False, data_format: str = 'HWC',
               device=None):
    """Load an RGB image as float32 (src/data_utils.py:167-198)."""
    image = _layout(load_image_raw(path, device).astype(np.float32),
                    data_format)
    return image / 255.0 if normalize else image


def save_image(image, path: str):
    """Save a [0, 1] float image as 8-bit RGB."""
    native.write_rgb(path, (255.0 * np.asarray(image)).astype(np.uint8))


def load_depth_raw(path: str):
    """Raw PNG integer array (H, W): int64, or a read-only uint16 map of
    the cached array when the raw cache is on. Convert with depth_from_raw
    (per-caller multiplier: the same file may be read under x256 and
    x2^14)."""
    return load_raw(path, 'png_int',
                    lambda: native.read_depth_raw(path).astype(np.int64))


def depth_from_raw(raw, multiplier: float = 256.0, data_format: str = 'HW'):
    """Raw PNG integers -> the load_depth float semantics."""
    z = np.asarray(raw, np.float32) / np.float32(multiplier)
    z[z <= 0] = 0.0
    return _expand(z, data_format)


def load_depth(path: str, multiplier: float = 256.0, data_format: str = 'HW'):
    """Load a depth map from a 16-bit PNG (src/data_utils.py:238-269): the
    integers over ``multiplier``, non-positive values zeroed."""
    return depth_from_raw(load_depth_raw(path), multiplier, data_format)


def load_depth_with_validity_map(path: str, multiplier: float = 256.0,
                                 data_format: str = 'HW'):
    """load_depth and its validity map: 1 where the depth is positive, else
    0 (float32)."""
    z = depth_from_raw(load_depth_raw(path), multiplier)
    v = (z > 0).astype(np.float32)
    return _expand(z, data_format), _expand(v, data_format)


def load_depth_u16(path: str, data_format: str = 'HW'):
    """Raw 16-bit-PNG integers (x256 codec implied) for integer transport;
    their decode (float32 / 256) equals load_depth exactly."""
    return _expand(encode_png_int(load_depth_raw(path)), data_format)


def save_depth(z, path: str, multiplier: float = 256.0):
    """Save a depth map as a 16-bit PNG of uint32(z * multiplier)
    (src/data_utils.py:271-286)."""
    native.write_depth(path, z, multiplier)


def _save_encoded(codes, path: str, name: str):
    codes = np.asarray(codes)
    if codes.dtype != np.uint16:
        raise TypeError('{} takes uint16 codes, got {}'.format(
            name, codes.dtype))
    native.write_u16(path, codes)


def save_depth_encoded(z_u16, path: str):
    """Write a depth map already quantized to the codec grid (uint16,
    floor(z * 256), e.g. by the pipeline's codec_encode): the same file as
    save_depth of the float map."""
    _save_encoded(z_u16, path, 'save_depth_encoded')


def save_response_encoded(response_u16, path: str):
    """Codec-grid (uint16, floor(r * 2^14)) counterpart of save_response."""
    _save_encoded(response_u16, path, 'save_response_encoded')


def load_response(path: str, multiplier: float = 2 ** 14,
                  data_format: str = 'HW'):
    """Load a response (confidence) map (src/data_utils.py:288-318)."""
    response = np.asarray(load_depth_raw(path), np.float32) / \
        np.float32(multiplier)
    return _expand(response, data_format)


def save_response(response, path: str, multiplier: float = 2 ** 14):
    native.write_depth(path, response, multiplier)


def interpolate_depth(depth_map, validity_map, log_space: bool = False):
    """Densify a sparse depth map by barycentric (Delaunay) interpolation
    over (row, col) (src/data_utils.py:337-379), on the host with scipy's
    Qhull: 0 outside the hull (log(1e-3) in log space, where values below
    0.1 are then cut to 0). Returns float64, as the JAX package's."""
    from scipy.interpolate import LinearNDInterpolator

    if depth_map.ndim != 2 or validity_map.ndim != 2:
        raise ValueError('interpolate_depth takes (H, W) maps, got {} and '
                         '{}'.format(depth_map.shape, validity_map.shape))
    rows, cols = depth_map.shape
    data_row_idx, data_col_idx = np.where(validity_map)
    depth_values = depth_map[data_row_idx, data_col_idx]
    if log_space:
        depth_values = np.log(depth_values)
    interpolator = LinearNDInterpolator(
        points=np.stack([data_row_idx, data_col_idx], axis=1),
        values=depth_values,
        fill_value=0 if not log_space else np.log(1e-3))
    query_row_idx, query_col_idx = np.meshgrid(
        np.arange(rows), np.arange(cols), indexing='ij')
    query_coord = np.stack(
        [query_row_idx.ravel(), query_col_idx.ravel()], axis=1)
    z = interpolator(query_coord).reshape([rows, cols])
    if log_space:
        z = np.exp(z)
        z[z < 1e-1] = 0.0
    return z
