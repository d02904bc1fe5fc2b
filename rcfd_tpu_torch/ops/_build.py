"""Build the CUDA sources of ``csrc/`` with nvcc, each into a plain C shared
library, and load them with ctypes.

No PyTorch headers and no ``torch.utils.cpp_extension``: a source with a
plain C interface compiles in seconds. The library goes into
``rcfd_tpu_torch/_build/`` at first use, named after a hash of the source
and the flags, so a changed source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
BUILD_TIMEOUT_S = 300

_LIBS = {}
# nvcc's stderr (ptxas register and shared-memory report) and the seconds
# from its start until its end was collected (builds started together are
# collected in order, so a later one may have ended sooner), per source
# built in this process
BUILD_LOGS = {}
BUILD_SECONDS = {}


def find_nvcc() -> str:
    """nvcc on PATH, else in $CUDA_HOME/bin, else in /usr/local/cuda/bin."""
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root:
            cand = os.path.join(root, 'bin', 'nvcc')
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    raise RuntimeError(
        'nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; '
        'the CUDA kernels of rcfd_tpu_torch are built with it at first use')


def _target(source: str):
    """(source path, library path) of ``csrc/<source>``, the library named
    after a hash of the source and the flags."""
    path = os.path.join(CSRC_DIR, source)
    with open(path, 'rb') as f:
        digest = hashlib.sha256(
            f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    return path, os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(stem, digest))


def load_libraries(sources) -> list:
    """Compile every source of ``sources`` that is not built yet, one nvcc
    process per source, all started together, then load each library.
    A failed or timed-out build raises, after every nvcc has ended."""
    procs = {}
    try:
        for source in sources:
            if source in _LIBS or source in procs:
                continue
            path, out = _target(source)
            if os.path.exists(out):
                _LIBS[source] = ctypes.CDLL(out)
                continue
            nvcc = find_nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = '{}.{}.tmp'.format(out, os.getpid())
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', tmp, path],
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True)
            procs[source] = (proc, tmp, out, time.perf_counter())
        for source, (proc, tmp, out, t0) in procs.items():
            _, stderr = proc.communicate(
                timeout=max(1.0, t0 + BUILD_TIMEOUT_S - time.perf_counter()))
            if proc.returncode != 0:
                raise RuntimeError('nvcc failed on {} (exit {}):\n{}'.format(
                    source, proc.returncode, stderr))
            BUILD_LOGS[source] = stderr
            BUILD_SECONDS[source] = time.perf_counter() - t0
            os.replace(tmp, out)
            _LIBS[source] = ctypes.CDLL(out)
    finally:
        for proc, _, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [_LIBS[source] for source in sources]


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content) and load it."""
    return load_libraries([source])[0]
