"""Integer input transport, device side (counterpart of
rcfd_tpu/data/transport.py ``decode``).

uint8 is a camera image (an exact cast to float32); uint16 and uint32 are
raw 16-bit PNG integers on the x256 codec (float32 / 256, exact); anything
else passes through.
"""

from __future__ import annotations

import torch


def decode(x):
    """Decode one transported tensor to float32."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32)
    if x.dtype in (torch.uint16, torch.uint32):
        return x.to(torch.float32) / 256.0
    return x
