"""The port's synthetic fixtures (rcfd_tpu_torch/tools/fixtures.py, written
with the port's own PNG writers) against tests/fixtures.py (Pillow and the
JAX package's writers): for several seeds and sizes, the manifests list
the same relative paths, and every file decodes to the same array, exact
(the PNGs read by Pillow on both sides, the radar sets by numpy)."""

import os

import numpy as np
import pytest

from PIL import Image

import fixtures as jax_fixtures
from rcfd_tpu_torch.tools import fixtures as port_fixtures

CASES = [(0, 64, 96, 3), (7, 32, 48, 2), (123, 17, 29, 4)]


def _relative(manifest, root):
    with open(manifest) as f:
        return [os.path.relpath(p, root) for p in f.read().splitlines()]


def _decoded(path):
    if path.endswith('.npy'):
        return np.load(path)
    return np.asarray(Image.open(path))


def _assert_same_files(port_root, jax_root, port, ref):
    assert sorted(port) == sorted(ref)
    for stream in ref:
        assert os.path.relpath(port[stream], port_root) == \
            os.path.relpath(ref[stream], jax_root)
        rel = _relative(port[stream], port_root)
        assert rel == _relative(ref[stream], jax_root), stream
        for r in rel:
            a = _decoded(os.path.join(port_root, r))
            b = _decoded(os.path.join(jax_root, r))
            assert a.dtype == b.dtype and a.shape == b.shape, r
            assert np.array_equal(a, b), r


@pytest.mark.parametrize('seed,height,width,n', CASES)
def test_fusionnet_fixture_equals_the_jax_one(tmp_path, seed, height, width,
                                              n):
    roots = [str(tmp_path / side) for side in ('port', 'jax')]
    port = port_fixtures.make_fusionnet_fixture(
        roots[0], n_samples=n, height=height, width=width, seed=seed)
    ref = jax_fixtures.make_fusionnet_fixture(
        roots[1], n_samples=n, height=height, width=width, seed=seed)
    _assert_same_files(*roots, port, ref)


@pytest.mark.parametrize('seed,height,width,n', CASES)
@pytest.mark.parametrize('n_points', [5, 10])
def test_radarnet_fixture_equals_the_jax_one(tmp_path, seed, height, width,
                                             n, n_points):
    roots = [str(tmp_path / side) for side in ('port', 'jax')]
    port = port_fixtures.make_radarnet_fixture(
        roots[0], n_samples=n, height=height, width=width,
        n_points=n_points, seed=seed)
    ref = jax_fixtures.make_radarnet_fixture(
        roots[1], n_samples=n, height=height, width=width,
        n_points=n_points, seed=seed)
    _assert_same_files(*roots, port, ref)
