"""Decode-once raw cache of the PNG and JPEG inputs (counterpart of
rcfd_tpu/data/raw_cache.py).

A training run decodes every frame of its manifests once an epoch: five
900x1600 PNGs a FusionNet sample, inflated on the host. With the cache on,
the first read of a file decodes it and writes its raw integer array (uint8
images, the 16-bit PNG integers of the depth-like streams) as a ``.npy``
under a key of the file; every later read maps that file (``mmap_mode='r'``)
and converts only what the caller needs. The raw integers are cached, not a
scaled map, so one file read under two multipliers (the reference reads the
response PNG through the x256 depth codec) is two rescales of one decode.

Enable it with RCFD_RAW_CACHE=<dir>, read once per process, or with
``set_raw_cache(dir)``, or for a call with ``raw_cache_for(dir)`` (the
training CLIs' ``--raw_cache_dirpath``). It is off by default: it costs
about 16 MB of disk a full-frame FusionNet sample.

The key is the SHA-1 of the file's absolute path, modification time (ns),
size and the kind of decode, the JAX package's scheme, so a rewritten file
decodes again. Writes are atomic (a temporary file named by process and
thread, then ``os.replace``), safe under the threaded loader. A failed write
warns once a process and still returns the decoded array; a failed decode
raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import warnings
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_DIR: Optional[str] = None
_INIT = [False]
_WRITE_FAIL_WARNED = [False]


def set_raw_cache(dirpath: Optional[str]):
    """Set the cache directory, or turn the cache off with None."""
    global _DIR
    with _LOCK:
        _DIR = dirpath or None
        _INIT[0] = True
        if dirpath:
            os.makedirs(dirpath, exist_ok=True)


@contextlib.contextmanager
def raw_cache_for(dirpath: Optional[str]):
    """The cache in ``dirpath`` for the body, the previous setting again
    after it; None leaves the setting (RCFD_RAW_CACHE's) as it is."""
    if not dirpath:
        yield
        return
    previous = cache_dir()
    set_raw_cache(dirpath)
    try:
        yield
    finally:
        set_raw_cache(previous)


def cache_dir() -> Optional[str]:
    """The cache directory, or None when the cache is off. Until
    ``set_raw_cache`` is called, RCFD_RAW_CACHE, read on the first call."""
    global _DIR
    if not _INIT[0]:
        with _LOCK:
            if not _INIT[0]:
                env = os.environ.get('RCFD_RAW_CACHE')
                if env:
                    os.makedirs(env, exist_ok=True)
                    _DIR = env
                _INIT[0] = True
    return _DIR


def _key(path: str, kind: str) -> str:
    st = os.stat(path)
    return hashlib.sha1(
        f'{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|{kind}'
        .encode()).hexdigest()


def load_raw(path: str, kind: str, decode):
    """The raw integer array of ``path``, decoded at most once while the
    file is unchanged. ``kind``: 'image' (uint8 HWC) or 'png_int' (the
    PNG's integers, stored as uint16 when they fit, else uint32).
    ``decode``: () -> the array, called on a miss (and always when the
    cache is off)."""
    d = cache_dir()
    if d is None:
        return decode()
    cpath = os.path.join(d, _key(path, kind) + '.npy')
    if os.path.exists(cpath):
        try:
            return np.load(cpath, mmap_mode='r')
        except Exception:
            pass  # a corrupt or partial entry: decode and write it again
    raw = np.ascontiguousarray(decode())
    if kind == 'png_int' and raw.dtype != np.uint16:
        raw = raw.astype(np.uint16 if raw.max(initial=0) <= 0xFFFF
                         else np.uint32)
    tmp = cpath + f'.tmp.{os.getpid()}.{threading.get_ident()}'
    try:
        with open(tmp, 'wb') as f:
            np.save(f, raw)
        os.replace(tmp, cpath)
    except Exception as e:
        # a full or unwritable cache disk sends every epoch back to the
        # decode: keep going with the decoded array, and say so once
        if not _WRITE_FAIL_WARNED[0]:
            _WRITE_FAIL_WARNED[0] = True
            warnings.warn(
                f'raw cache write to {d} failed ({type(e).__name__}: {e}); '
                f'the loader decodes every epoch again. Check the disk '
                f'space and permissions of RCFD_RAW_CACHE.', RuntimeWarning)
        try:
            os.remove(tmp)
        except OSError:
            pass
    return raw
