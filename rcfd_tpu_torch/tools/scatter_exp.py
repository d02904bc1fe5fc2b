"""Where the quasi-dense scatter's time goes on the card: the K1 kernel
(ops/scatter_cuda.py) at the serving shapes, the same launch on inputs
with fewer points, and two one-call PyTorch streams of the same crops.

    python -m rcfd_tpu_torch.tools.scatter_exp [--k 64 --invalid 4
        --ph 900 --pw 288 --w 1600]

Cases, each through ``scatter_quasi_dense`` with the serving inputs (crops
uniform in [0, 1), x uniform over the frame, the last ``--invalid`` points
padding) but for what the case names:

  serving      every point valid but the padding
  half_points  only the first half of the points valid: half the reads
  no_points    no point valid: the key map's zeroing, the point list and
               the epilogue's writes alone

For each the tool prints the kernel's device time (CUDA events, median of
20 launches), the bytes it must move for those inputs (each crop element
that lands in the frame for a valid point read once, the point tables, the
two maps written once), their time at the H100 SXM data sheet's 3.35
TB/s, and its share of that bound. As yardsticks of the rate the card
reaches on bytes of this size it times ``crops.amax()`` (reads the crops
once) and ``crops.clone()`` (reads and writes them once). It prints
nvcc's ptxas report when it builds the kernel, checks every case against
the plain version, bit for bit, runs on the card only, and exits non-zero
when a case differs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import scatter_cuda as sc
from .fusepall_exp import HBM_BYTES_PER_S, device_ms

CASES = ('serving', 'half_points', 'no_points')


def bound_bytes(x_start, valid, ph, pw, w):
    """Crop elements that land in the frame for the valid points (read
    once), the three (K,) int32 tables, the two (ph, w) maps (written
    once)."""
    lo = np.maximum(x_start - pw, 0)
    hi = np.minimum(x_start, w)
    cols = np.where(valid > 0, np.maximum(hi - lo, 0), 0)
    return 4 * ph * int(cols.sum()) + 3 * 4 * len(x_start) + 2 * 4 * ph * w


def case_inputs(name, k, n_invalid, ph, pw, w, device, seed=0):
    """(crops, x, z, valid) of one case."""
    rng = np.random.default_rng(seed)
    crops = rng.random((k, ph, pw), dtype=np.float32)
    x = rng.integers(0, w, k).astype(np.float32) + pw // 2
    z = (rng.random(k, dtype=np.float32) * 79 + 1).astype(np.float32)
    valid = np.ones(k, bool)
    valid[k - n_invalid:] = False
    if name == 'half_points':
        valid[k // 2:] = False
    elif name == 'no_points':
        valid[:] = False
    t = lambda a: torch.from_numpy(a).to(device)
    return t(crops), t(x), t(z), t(valid)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--k', type=int, default=64)
    parser.add_argument('--invalid', type=int, default=4)
    parser.add_argument('--ph', type=int, default=900)
    parser.add_argument('--pw', type=int, default=288)
    parser.add_argument('--w', type=int, default=1600)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('scatter_exp: no CUDA device; this tool runs on the '
                         'card only')
    device = torch.device('cuda')
    sc._kernel()
    for line in _build.BUILD_LOGS.get(sc.SOURCE, '').splitlines():
        if 'scatter_strip' in line or 'registers' in line or 'smem' in line:
            print('ptxas: ' + line.strip())
    ph, pw, w = args.ph, args.pw, args.w
    print('{}; K={} ({} padding), crops {}x{}, w={}'.format(
        torch.cuda.get_device_name(0), args.k, args.invalid, ph, pw, w))
    failed = False
    for name in CASES:
        crops, x, z, valid = case_inputs(name, args.k, args.invalid, ph, pw,
                                         w, device)
        call = (crops, x, z, valid, ph, w, (ph, pw))
        d, r = sc.scatter_quasi_dense(*call)
        d_p, r_p = sc.scatter_quasi_dense_plain(*call)
        equal = torch.equal(d, d_p) and torch.equal(r, r_p)
        failed |= not equal
        ms = device_ms(lambda: sc.scatter_quasi_dense(*call))
        x_start, valid_i, _ = sc.point_tables(x, z, valid, pw, w)
        nbytes = bound_bytes(x_start.cpu().numpy(), valid_i.cpu().numpy(),
                             ph, pw, w)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print('{:12s} kernel {:.4f} ms, bound {:.4f} ms ({} bytes), {:.1f}% '
              'of the bound; equal to the plain version: {}'.format(
                  name, ms, bound_ms, nbytes, 100 * bound_ms / ms, equal))
    crops = case_inputs('serving', args.k, args.invalid, ph, pw, w,
                        device)[0]
    nbytes = crops.numel() * 4
    for name, fn, moved in (('crops.amax()', crops.amax, nbytes),
                            ('crops.clone()', crops.clone, 2 * nbytes)):
        ms = device_ms(fn)
        print('{} {:.4f} ms for {} bytes, {:.4g} B/s'.format(
            name, ms, moved, moved / ms * 1e3))
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
