"""PyTorch/CUDA port of rcfd_tpu: radar-camera fusion depth on an NVIDIA GPU.

Mirrors the module layout of ``rcfd_tpu`` so each module's counterpart is
easy to find. Modules compute in NCHW; the public functions that are held
against the JAX package keep its NHWC layout. The port imports nothing of
``rcfd_tpu`` or JAX: whatever it shares with the JAX package is copied.

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import torch

__version__ = '0.1.0'


def default_device(device=None) -> torch.device:
    """Resolve an entry point's device: ``cuda`` by default, and the CPU
    only when asked for. Without a card and without ``device='cpu'`` this
    raises instead of running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'rcfd_tpu_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run on the CPU")
    return torch.device('cuda')
