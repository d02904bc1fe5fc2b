"""Step timing and profiler traces (counterpart of
rcfd_tpu/utils/profiling.py ``StepTimer``, ``trace`` and ``TraceWindow``;
``find_latest_checkpoint`` is in utils/checkpoint.py).

The JAX package traces with ``jax.profiler`` into xplane files; the port
traces with ``torch.profiler`` (CUPTI on a CUDA device) and writes Chrome
trace JSON (``export_chrome_trace``), which chrome://tracing, Perfetto and
TensorBoard's profile plugin read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import default_device

DEFAULT_STEPS = (10, 12)


class StepTimer:
    """Rolling wall-clock step timer."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            'mean_s': float(arr.mean()),
            'p50_s': float(np.percentile(arr, 50)),
            'p95_s': float(np.percentile(arr, 95)),
            'steps_per_s': float(1.0 / arr.mean()),
        }


def _profiler(device):
    """A torch.profiler over the host's ops, and the card's kernels when
    ``device`` is a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _stop(prof, device, path: str):
    """Stop ``prof`` once the card has run what was queued in the window,
    and write its Chrome trace to ``path``."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """A torch.profiler trace of the block into ``log_dir/trace.json``; a
    no-op when ``log_dir`` is None. ``device`` (``cuda`` unless the
    caller passes ``device='cpu'``, as the port's entry points; without a
    card ``None`` raises) decides whether the card's kernels are
    traced."""
    if log_dir is None:
        yield
        return
    device = default_device(device)
    prof = _profiler(device)
    prof.start()
    try:
        yield
    finally:
        _stop(prof, device, os.path.join(log_dir, 'trace.json'))


def parse_steps(value: Optional[str]):
    """RCFD_PROFILE_STEPS 'a-b' as (a, b); (10, 12) when it is unset or
    malformed, as the JAX package reads it."""
    try:
        a, b = (value or '').split('-')
        return int(a), int(b)
    except ValueError:
        return DEFAULT_STEPS


class TraceWindow:
    """Env-driven torch.profiler window of the train loops:
    RCFD_PROFILE_DIR=/path [RCFD_PROFILE_STEPS=a-b, default 10-12] starts
    a trace after step a (and after the first step past it, in a run
    restored later) and stops it after step b, so the steps a + 1 to b
    are traced. One window a run; ``close()`` stops one still open at the
    end of the run. The trace is written to
    ``<RCFD_PROFILE_DIR>/trace-steps-<first>-<last>.json`` (``path``)
    with the first and last steps it holds. The card's kernels are traced
    when ``device`` is a CUDA device; the stop synchronizes the card,
    and no step outside the window waits for it. ``enabled=False`` (a
    data-parallel rank other than 0) traces nothing."""

    def __init__(self, device='cpu', enabled: bool = True):
        self.dir = (os.environ.get('RCFD_PROFILE_DIR') or None) if enabled \
            else None
        self.start_step, self.stop_step = parse_steps(
            os.environ.get('RCFD_PROFILE_STEPS', '10-12'))
        self.device = torch.device(device)
        self.path = None
        self._prof = None
        self._first = self._last = None

    def after_step(self, step: int):
        if self.dir is None:
            return
        if self._prof is None and step >= self.start_step:
            self._prof = _profiler(self.device)
            self._prof.start()
            self._first = step + 1
        elif self._prof is not None:
            self._last = step
            if step >= self.stop_step:
                self._finish()
                self.dir = None  # one window per run

    def _finish(self):
        self.path = os.path.join(self.dir, 'trace-steps-{}-{}.json'.format(
            self._first, self._last))
        prof, self._prof = self._prof, None
        _stop(prof, self.device, self.path)

    def close(self):
        if self._prof is not None:
            if self._last is None:  # no step ran in the window
                self._last = self._first - 1
            self._finish()
            self.dir = None
