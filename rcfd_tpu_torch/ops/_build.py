"""Build a CUDA source of ``csrc/`` with nvcc into a plain C shared library
and load it with ctypes.

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

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, 'csrc')
BUILD_DIR = os.path.join(PACKAGE_DIR, '_build')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
BUILD_TIMEOUT_S = 300

_LIBS = {}
# nvcc's stderr (ptxas register and shared-memory report) per source
BUILD_LOGS = {}


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


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content) and load it."""
    if source in _LIBS:
        return _LIBS[source]
    path = os.path.join(CSRC_DIR, source)
    with open(path, 'rb') as f:
        digest = hashlib.sha256(
            f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, 'lib{}-{}.so'.format(stem, digest))
    if not os.path.exists(out):
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = '{}.{}.tmp'.format(out, os.getpid())
        proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, path],
                              capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError('nvcc failed on {} (exit {}):\n{}'.format(
                source, proc.returncode, proc.stderr))
        BUILD_LOGS[source] = proc.stderr
        os.replace(tmp, out)
    _LIBS[source] = ctypes.CDLL(out)
    return _LIBS[source]
