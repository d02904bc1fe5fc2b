"""Console and results-file logging (counterpart of
rcfd_tpu/utils/log_utils.py ``log``; reference src/log_utils.py)."""

from __future__ import annotations

import os


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
