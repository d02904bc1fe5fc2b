"""Integer input transport (counterpart of rcfd_tpu/data/transport.py).

Camera frames travel as uint8 and depth-family streams as their raw 16-bit
PNG integers; they become float32 on the device (``decode``) or on the host
(``decode_np``), exactly: uint8 is a camera image (an exact cast to
float32); uint16 and uint32 are raw 16-bit PNG integers on the x256 codec
(float32 / 256, exact); anything else passes through. The port always
transports integers, as the JAX package does by default.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_image(image) -> np.ndarray:
    """Host-side: [0,255]-valued image -> uint8 (exact for PNG/JPEG
    decodes, whose float values are integral)."""
    a = np.asarray(image)
    if a.dtype == np.uint8:
        return a
    return a.astype(np.uint8)


def encode_png_int(raw) -> np.ndarray:
    """Host-side: raw PNG integers -> the narrowest transport dtype.
    Negative values map to 0: load_depth's ``z[z <= 0] = 0`` clamp, applied
    before transport instead of after division."""
    a = np.asarray(raw)
    if a.dtype == np.uint16:
        return a
    if np.issubdtype(a.dtype, np.signedinteger) and a.min(initial=0) < 0:
        a = np.maximum(a, 0)
    return a.astype(np.uint16 if a.max(initial=0) <= 0xFFFF else np.uint32)


def decode(x):
    """Decode a transported tensor to float32, or each tensor of a tuple
    or list of them (a training batch: RadarNet's uint8 image, float32
    points and boxes and uint16 ground-truth crops)."""
    if isinstance(x, (tuple, list)):
        return type(x)(decode(t) for t in x)
    if x.dtype == torch.uint8:
        return x.to(torch.float32)
    if x.dtype in (torch.uint16, torch.uint32):
        return x.to(torch.float32) / 256.0
    return x


def _decode_one_np(x):
    dtype = getattr(x, 'dtype', None)
    if dtype == np.uint8:
        return x.astype(np.float32)
    if dtype in (np.uint16, np.uint32):
        return x.astype(np.float32) / np.float32(256.0)
    return x


def decode_np(batch):
    """Host-side decode with ``decode``'s semantics, for numpy arrays and
    tuples, lists or dicts of them (metrics, PNG writers)."""
    if isinstance(batch, dict):
        return {k: decode_np(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(decode_np(v) for v in batch)
    return _decode_one_np(batch)
