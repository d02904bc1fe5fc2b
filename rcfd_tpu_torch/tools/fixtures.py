"""Tiny synthetic nuScenes-like fixtures (counterpart of tests/fixtures.py
``make_fusionnet_fixture`` and ``make_radarnet_fixture``), written with the
port's own PNG writers (data/io.py on native/codec.cpp), without Pillow.

The same manifests, file names and layout, and the same
``np.random.default_rng(seed)`` draws in the same order, so every file
decodes to the JAX package's fixture's contents exactly. The bridge
harness and the parity tool build their synthetic data with them.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import io as data_utils


def _dirs(root, names):
    dirs = {n: os.path.join(root, n) for n in names}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def _manifests(root, names, paths):
    manifests = {}
    for n in names:
        manifests[n] = os.path.join(root, '{}.txt'.format(n))
        data_utils.write_paths(manifests[n], paths[n])
    return manifests


def _save_rgb(image, path):
    # uint8 / 255 * 255 truncates back to the same integer for 0..255
    data_utils.save_image(image / 255.0, path)


def make_fusionnet_fixture(root, n_samples=8, height=64, width=96, seed=0):
    """Frames, radar depth and response, ground truth and lidar PNGs under
    ``root``; returns {stream: manifest path}."""
    rng = np.random.default_rng(seed)
    names = ['image', 'depth', 'response', 'ground_truth', 'lidar']
    dirs = _dirs(root, names)
    paths = {n: [] for n in names}
    for i in range(n_samples):
        name = '{:04d}.png'.format(i)
        image = rng.integers(0, 255, (height, width, 3)).astype(np.uint8)
        paths['image'].append(os.path.join(dirs['image'], name))
        _save_rgb(image, paths['image'][-1])

        depth = rng.random((height, width), dtype=np.float32) * 60
        depth[depth < 30] = 0.0
        paths['depth'].append(os.path.join(dirs['depth'], name))
        data_utils.save_depth(depth, paths['depth'][-1])

        response = rng.random((height, width), dtype=np.float32)
        paths['response'].append(os.path.join(dirs['response'], name))
        data_utils.save_response(response, paths['response'][-1])

        gt = rng.random((height, width), dtype=np.float32) * 70 + 1
        gt[rng.random((height, width)) < 0.6] = 0.0
        paths['ground_truth'].append(os.path.join(dirs['ground_truth'], name))
        data_utils.save_depth(gt, paths['ground_truth'][-1])

        lidar = rng.random((height, width), dtype=np.float32) * 70 + 1
        lidar[rng.random((height, width)) < 0.9] = 0.0
        paths['lidar'].append(os.path.join(dirs['lidar'], name))
        data_utils.save_depth(lidar, paths['lidar'][-1])
    return _manifests(root, names, paths)


def make_radarnet_fixture(root, n_samples=8, height=64, width=96,
                          n_points=10, seed=0):
    """Frames, radar point sets (.npy, (n_points, 3) float32 x, y, z) and
    ground truth under ``root``; returns {stream: manifest path}."""
    rng = np.random.default_rng(seed)
    names = ['image', 'radar', 'ground_truth']
    dirs = _dirs(root, names)
    paths = {n: [] for n in names}
    for i in range(n_samples):
        image = rng.integers(0, 255, (height, width, 3)).astype(np.uint8)
        paths['image'].append(os.path.join(dirs['image'],
                                           '{:04d}.png'.format(i)))
        _save_rgb(image, paths['image'][-1])

        radar = np.stack([
            rng.integers(0, width, n_points).astype(np.float32),
            rng.integers(0, height, n_points).astype(np.float32),
            rng.random(n_points, dtype=np.float32) * 70 + 1,
        ], axis=1)
        paths['radar'].append(os.path.join(dirs['radar'],
                                           '{:04d}.npy'.format(i)))
        np.save(paths['radar'][-1], radar)

        gt = rng.random((height, width), dtype=np.float32) * 70 + 2
        gt[rng.random((height, width)) < 0.5] = 0.0
        paths['ground_truth'].append(os.path.join(dirs['ground_truth'],
                                                  '{:04d}.png'.format(i)))
        data_utils.save_depth(gt, paths['ground_truth'][-1])
    return _manifests(root, names, paths)
