"""TensorBoard summaries, best effort (counterpart of
rcfd_tpu/utils/summary.py): the same interface, and a no-op writer, with
one logged line, where ``torch.utils.tensorboard`` cannot be imported. A
summary never fails a run."""

from __future__ import annotations

import numpy as np

_WARNED = [False]


def _warn_disabled(reason: str):
    if _WARNED[0]:
        return
    _WARNED[0] = True
    from .log_utils import log
    log('WARNING: TensorBoard summaries DISABLED ({}); scalar, histogram '
        'and image events will not be written'.format(reason))


class SummaryWriter:

    def __init__(self, log_dir: str, enabled: bool = True):
        """enabled=False makes a no-op writer without a warning."""
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
            self._writer = TBWriter(log_dir)
        except Exception as e:
            _warn_disabled('{}: {}'.format(type(e).__name__, e))

    @property
    def enabled(self) -> bool:
        """Whether events are written."""
        return self._writer is not None

    def _call(self, method, *args, **kwargs):
        if self._writer is None:
            return
        try:
            getattr(self._writer, method)(*args, **kwargs)
        except Exception as e:
            self._writer = None
            _warn_disabled('{}: {}'.format(type(e).__name__, e))

    def add_scalar(self, tag, value, global_step=None):
        self._call('add_scalar', tag, float(value), global_step=global_step)

    def add_histogram(self, tag, values, global_step=None):
        self._call('add_histogram', tag, np.asarray(values).ravel(),
                   global_step=global_step)

    def add_image(self, tag, image_hwc, global_step=None):
        self._call('add_image', tag, np.asarray(image_hwc),
                   global_step=global_step, dataformats='HWC')

    def flush(self):
        self._call('flush')

    def close(self):
        self._call('close')
