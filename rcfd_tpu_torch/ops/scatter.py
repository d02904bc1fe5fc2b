"""Quasi-dense scatter helpers (counterpart of rcfd_tpu/ops/scatter.py).

The scatter itself is the hand-written kernel in ``scatter_cuda.py``; this
module keeps the legacy index -> depth rewrite that both the kernel's
plain version and the tests use.
"""

from __future__ import annotations

import torch


def legacy_rewrite(idx_map, response_map, z_values, valid, n_points: int):
    """The reference's index -> z rewrite loop, bit for bit
    (src/radarnet_main.py:576-583, rcfd_tpu/ops/scatter.py:45).

    Each pixel starts at ``m = winner`` (0 where the response is 0); then
    for p = 0 .. n_points - 1, ``if valid[p] and m == p: m = trunc(z[p])``.
    The rewrites cascade: a depth written as an integer equal to a later
    point's index is rewritten again by that point. Padding points are
    skipped, as the reference loops over the real points only.
    """
    z_int = z_values.to(torch.int32)  # truncation toward zero
    valid = valid.to(torch.bool)
    m = torch.where(response_map > 0, idx_map.to(torch.int32),
                    torch.zeros((), dtype=torch.int32,
                                device=idx_map.device))
    for p in range(n_points):
        m = torch.where(valid[p] & (m == p), z_int[p], m)
    return torch.where(response_map > 0, m.to(response_map.dtype),
                       torch.zeros((), dtype=response_map.dtype,
                                   device=response_map.device))
