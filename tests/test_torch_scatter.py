"""The quasi-dense scatter of rcfd_tpu_torch: the kernel's plain version
against the JAX package's Pallas kernel (interpret mode, as
tests/test_scatter_pallas.py runs it) and its XLA scatter; the legacy
rewrite; the build and the wrapper's refusals. The CUDA kernel itself is
held against its plain version on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import os
import stat

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.ops.scatter import _legacy_rewrite  # noqa: E402
from rcfd_tpu.ops.scatter import scatter_quasi_dense as xla_scatter  # noqa
from rcfd_tpu.ops.scatter_pallas import scatter_quasi_dense_pallas  # noqa

from rcfd_tpu_torch.ops import _build  # noqa: E402
from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402
from rcfd_tpu_torch.ops.scatter import legacy_rewrite  # noqa: E402

from torch_parity import SCATTER_CASES, scatter_case as _case  # noqa: E402

Q_STEP = 2.0 ** -14




def _port_scatter(crops, x, z, valid, h, w, patch):
    d, r = sc.scatter_quasi_dense_plain(
        torch.from_numpy(crops), torch.from_numpy(x), torch.from_numpy(z),
        torch.from_numpy(valid), h, w, patch)
    return d.numpy(), r.numpy()


@pytest.mark.parametrize('name', SCATTER_CASES)
def test_plain_matches_pallas_interpret_bit_exact(name, rng):
    """Plain version vs the TPU kernel's interpret mode: equal bits."""
    crops, x, z, valid, h, w, patch = _case(name, rng)
    d_ref, r_ref = scatter_quasi_dense_pallas(
        jnp.asarray(crops), jnp.asarray(x), jnp.asarray(z),
        jnp.asarray(valid), h, w, patch, interpret=True)
    d, r = _port_scatter(crops, x, z, valid, h, w, patch)
    np.testing.assert_array_equal(r, np.asarray(r_ref))
    np.testing.assert_array_equal(d, np.asarray(d_ref))
    assert (r > 0).sum() > 0


def _same_step_ties(crops, x, valid, h, w, patch):
    """(h, w) mask of the pixels where two or more valid points share the
    top quantized response: there the first index wins in the kernel, the
    exact float max in the XLA scatter."""
    ph, pw = patch
    k = crops.shape[0]
    q = np.where(crops < 0.5, 0, np.floor(crops * 2.0 ** 14))
    top = np.full((ph, w), -1.0)
    count = np.zeros((ph, w), int)
    for p in range(k):
        if not valid[p]:
            continue
        for j in range(pw):
            c = int(x[p]) - pw + j
            if 0 <= c < w:
                v = q[p, :, j]
                count[:, c] = np.where(v > top[:, c], 1,
                                       count[:, c] + (v == top[:, c]))
                top[:, c] = np.maximum(top[:, c], v)
    mask = np.zeros((h, w), bool)
    mask[h - ph:] = (count > 1) & (top > 0)
    return mask


@pytest.mark.parametrize('name', SCATTER_CASES)
def test_plain_matches_xla_scatter(name, rng):
    """Against the XLA scatter: the response within one 2^-14 step (it is
    the 14-bit codec value of the same max) everywhere, and the depth equal
    except where two points tie inside one step."""
    crops, x, z, valid, h, w, patch = _case(name, rng)
    d_ref, r_ref = [np.asarray(a) for a in xla_scatter(
        jnp.asarray(crops), jnp.asarray(x), jnp.asarray(z),
        jnp.asarray(valid), h, w, patch)]
    d, r = _port_scatter(crops, x, z, valid, h, w, patch)
    assert np.abs(r - r_ref).max() <= Q_STEP
    np.testing.assert_array_equal(r, np.floor(r_ref * 2.0 ** 14) / 2.0 ** 14)
    ties = _same_step_ties(crops, x, valid, h, w, patch)
    np.testing.assert_array_equal(d[~ties], d_ref[~ties])
    if name == 'ties':
        assert ties.any()


def test_legacy_rewrite_cascade_matches_jax(rng):
    k = 12
    idx = rng.integers(0, k + 1, (9, 11)).astype(np.int32)
    resp = np.where(rng.random((9, 11)) < 0.3, 0.0,
                    rng.random((9, 11))).astype(np.float32)
    # integer depths that are other points' indices make the rewrites cascade
    z = np.array([3, 5, 7.9, 1, 2, 11, 4, 0.5, 9, 6, 10, 8],
                 np.float32)
    valid = rng.random(k) < 0.8
    ref = np.asarray(_legacy_rewrite(jnp.asarray(idx), jnp.asarray(resp),
                                     jnp.asarray(z), jnp.asarray(valid), k))
    out = legacy_rewrite(torch.from_numpy(idx), torch.from_numpy(resp),
                         torch.from_numpy(z), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrapper_takes_plain_version_for_cpu_tensors(rng):
    crops, x, z, valid, h, w, patch = _case('ties', rng)
    before = sc.scatter_quasi_dense.launches
    args = [torch.from_numpy(a) for a in (crops, x, z, valid)]
    d, r = sc.scatter_quasi_dense(*args, h, w, patch)
    d_p, r_p = sc.scatter_quasi_dense_plain(*args, h, w, patch)
    assert torch.equal(d, d_p) and torch.equal(r, r_p)
    assert sc.scatter_quasi_dense.launches == before


def test_wrapper_rejects_patch_mismatch(rng):
    crops, x, z, valid, h, w, patch = _case('random', rng)
    args = [torch.from_numpy(a) for a in (crops, x, z, valid)]
    with pytest.raises(ValueError, match='patch_size'):
        sc.scatter_quasi_dense(*args, h, w, (patch[0], patch[1] + 2))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path / 'no-cuda'))
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, 'isfile',
                        lambda p: False if p.endswith('nvcc') else
                        real_isfile(p))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_LIBS', {})
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _build.load_library(sc.SOURCE)
    assert not (tmp_path / 'build').exists()


def test_build_failure_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    fake = tmp_path / 'nvcc'
    fake.write_text('#!/bin/sh\necho "error: the compiler said no" >&2\n'
                    'exit 2\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, 'find_nvcc', lambda: str(fake))
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(_build, '_LIBS', {})
    with pytest.raises(RuntimeError, match='the compiler said no'):
        _build.load_library(sc.SOURCE)
    assert not list((tmp_path / 'build').glob('*.so'))


def test_build_flags_target_sm90a():
    flags = ' '.join(_build.NVCC_FLAGS)
    assert 'arch=compute_90a,code=sm_90a' in flags
    assert '-shared' in flags and '-fPIC' in flags
