"""Check and time the identity behind the pool2 -> deconv1 skip-conv
fusion (counterpart of tools/fusepool_experiment.py):

    conv(window(G, s)) == window(conv(G), s) + boundary corrections

for K windows of width PW of one global map G (3x3 conv, zero padding).
A window's conv sees zeros past its edges where conv(G) sees G's
neighbouring columns s - 1 and s + PW; the corrections subtract those
columns' 3-tap row convolutions with the kernel's outer columns. Part 1
prints the max abs error between the two sides (bf16 on the card, float32
on the CPU, as the JAX tool's TPU / CPU split); part 2, on the card,
times each side (``timing.slope_ms``, chains of 2 and 10 calls, G
perturbed by the carry). The last line is one JSON row (the JAX tool
prints none) with ``backend`` and ``device``.

    python -m rcfd_tpu_torch.tools.fusepool_experiment
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as TF

from .. import default_device
from ..pipeline import serving_numerics
from . import timing

H, WG, C, PW, K = 450, 944, 32, 144, 64


def make_inputs(h, wg, c, pw, k, dtype, device, rng):
    """The JAX tool's draws in its order: G (C, H, WG), w (C, C, 3, 3)
    OIHW (drawn HWIO), starts (K,) in [1, WG - PW - 2]."""
    g = rng.random((h, wg, c), np.float32)
    w = rng.random((3, 3, c, c), np.float32) * 0.05
    starts = rng.integers(1, wg - pw - 1, k).astype(np.int64)
    return (torch.from_numpy(np.ascontiguousarray(g.transpose(2, 0, 1))).to(
                device, dtype),
            torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                             ).to(device, dtype),
            torch.from_numpy(starts).to(device))


def windows(x, starts, pw: int):
    """Columns [s, s + pw) of x (C, H, W) at every start: (K, C, H, pw)."""
    cols = starts[:, None] + torch.arange(pw, device=x.device)
    return x[:, :, cols].permute(2, 0, 1, 3)


def windows_then_conv(g, w, starts, pw: int = PW):
    return TF.conv2d(windows(g, starts, pw), w, padding=1)


def _row_conv(cols, wk):
    """3-tap zero-padded conv along H of columns cols (K, C, H) with wk
    (Co, C, 3): (K, Co, H)."""
    h = cols.shape[-1]
    colsp = TF.pad(cols, (1, 1))
    return sum(torch.einsum('kch,dc->kdh', colsp[..., i:i + h], wk[..., i])
               for i in range(3))


def conv_then_windows(g, w, starts, pw: int = PW):
    cg = TF.conv2d(g[None], w, padding=1)[0]
    win = windows(cg, starts, pw).clone()
    left = g[:, :, starts - 1].permute(2, 0, 1)        # (K, C, H)
    right = g[:, :, starts + pw].permute(2, 0, 1)
    win[..., 0] -= _row_conv(left, w[..., 0]).to(win.dtype)
    win[..., pw - 1] -= _row_conv(right, w[..., 2]).to(win.dtype)
    return win


def build_parser():
    return argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.fusepool_experiment')


def main(argv=None, device=None):
    """Check (and on the card time) the identity on ``device`` (``cuda``
    unless ``device='cpu'``). Returns the JSON row printed last."""
    build_parser().parse_args(argv)
    device = default_device(device)
    dtype = torch.bfloat16 if device.type == 'cuda' else torch.float32
    g, w, starts = make_inputs(H, WG, C, PW, K, dtype, device,
                               np.random.default_rng(0))
    with serving_numerics(), torch.inference_mode():
        ref = windows_then_conv(g, w, starts)
        out = conv_then_windows(g, w, starts)
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        print('max abs err {:.3e} (scale {:.3e}) backend={}'.format(
            err, scale, device.type), flush=True)
        times = None
        if device.type == 'cuda':
            times = {}
            for name, fn in (('windows_then_conv', windows_then_conv),
                             ('conv_then_windows', conv_then_windows)):
                def step(c, fn=fn):
                    y = fn(timing.perturb(g, c), w, starts)
                    return y.float().sum() * 1e-24

                times[name] = timing.slope_ms(
                    step, timing.scalar_carry(device), 2, 10, device)[0]
            print('windows->conv: {:7.3f} ms'.format(
                times['windows_then_conv']))
            print('conv->windows: {:7.3f} ms'.format(
                times['conv_then_windows']), flush=True)
    row = {'harness': 'fusepool_experiment',
           'dtype': 'bfloat16' if dtype == torch.bfloat16 else 'float32',
           'max_abs_err': err, 'scale': scale, 'ms': times,
           'backend': device.type, 'device': timing.card_line(device)}
    print(json.dumps(row))
    return row


if __name__ == '__main__':
    main()
