"""Console and results-file logging (counterpart of
rcfd_tpu/utils/log_utils.py ``log`` and ``colorize``; reference
src/log_utils.py)."""

from __future__ import annotations

import os

import numpy as np


def log(s: str, filepath: str = None, to_console: bool = True):
    """Print and/or append a line to a results file
    (src/log_utils.py:20-42)."""
    if to_console:
        print(s)
    if filepath is not None:
        dirpath = os.path.dirname(filepath)
        if dirpath and not os.path.isdir(dirpath):
            os.makedirs(dirpath, exist_ok=True)
        with open(filepath, 'a+') as o:
            o.write(s + '\n')


def colorize(t, colormap: str = 'magma'):
    """Map an (N, H, W, 1) or (N, H, W) array in [0, 1] to RGB through a
    matplotlib colormap (src/log_utils.py:44-75): (N, H, W, 3) float32.
    Raises ImportError where matplotlib is not installed (the card's
    machine has none); the training summaries then write no panels."""
    import matplotlib

    cm = matplotlib.colormaps[colormap]
    t = np.asarray(t)
    if t.ndim == 3:
        t = t[..., None]
    return cm(np.clip(t[..., 0], 0.0, 1.0))[..., :3].astype(np.float32)
