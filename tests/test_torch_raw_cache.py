"""The port's decode-once raw cache (rcfd_tpu_torch/data/raw_cache.py) and
its hooks in data/io.py and data/datasets.py, on the CPU: the same samples
with and without it, no decode once it is warm, invalidation of a rewritten
file, RCFD_RAW_CACHE, a failed write, the training CLIs'
--raw_cache_dirpath, and the cached FusionNet sample against the JAX
package's with its own cache on."""

import os
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch import native, train_fusionnet, train_radarnet  # noqa
from rcfd_tpu_torch.data import io as port_io  # noqa: E402
from rcfd_tpu_torch.data import raw_cache  # noqa: E402
from rcfd_tpu_torch.data.datasets import (FusionNetTrainingDataset,  # noqa
                                          RadarNetInferenceDataset,
                                          RadarNetTrainingDataset)
from rcfd_tpu_torch.data.loader import DataLoader  # noqa: E402

from fixtures import make_fusionnet_fixture, make_radarnet_fixture  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG = os.path.join(REPO, 'tests', 'data', 'torch_io', 'frame_q95.jpg')
H, W = 40, 48
CROP = (32, 32)
CROP_TYPE = ('horizontal', 'vertical')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny training steps on one thread, as the other CLI
    tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('raw_cache')
    fn = make_fusionnet_fixture(str(root / 'fn'), n_samples=4, height=H,
                                width=W)
    rn = make_radarnet_fixture(str(root / 'rn'), n_samples=4, height=H,
                               width=W, n_points=6)
    return {'fn': {k: port_io.read_paths(v) for k, v in fn.items()},
            'rn': {k: port_io.read_paths(v) for k, v in rn.items()},
            'fn_manifests': fn, 'rn_manifests': rn}


@pytest.fixture
def cache(tmp_path):
    """The cache on in a fresh directory for the test, off after it."""
    d = str(tmp_path / 'cache')
    raw_cache.set_raw_cache(d)
    yield d
    raw_cache.set_raw_cache(None)


@pytest.fixture
def decodes(monkeypatch):
    """Count the calls of the codec's readers, by reader."""
    calls = {'image': 0, 'png_int': 0}
    for name, kind in (('read_image_u8', 'image'),
                       ('read_depth_raw', 'png_int')):
        fn = getattr(native, name)

        def counted(*a, _fn=fn, _kind=kind, **k):
            calls[_kind] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(native, name, counted)
    return calls


def _datasets(files):
    fn = files['fn']
    rn = files['rn']
    return {
        'fusionnet': FusionNetTrainingDataset(
            fn['image'], fn['depth'], fn['response'], fn['ground_truth'],
            fn['lidar'], shape=CROP, random_crop_type=CROP_TYPE,
            device='cpu'),
        'radarnet': RadarNetTrainingDataset(
            rn['image'], rn['radar'], rn['ground_truth'], patch_size=(H, 32),
            total_points_sampled=3, sample_probability_of_lidar=0.5,
            device='cpu')}


def _epochs(dataset, n=2):
    """The batches of ``n`` epochs of the training loader (2 threads)."""
    loader = DataLoader(dataset, batch_size=2, shuffle=True, num_workers=2,
                        seed=3, drop_last=True)
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append([tuple(np.array(a) for a in batch) for batch in loader])
    return out


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (list, tuple)):
            _assert_same(x, y)
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize('model', ['fusionnet', 'radarnet'])
def test_cached_samples_equal_uncached(files, tmp_path, decodes, model):
    """Two epochs of the training loader with the cache off and on (a cold
    epoch that decodes and writes, then a warm one that maps): the same
    batches byte for byte; the warm epoch calls no decoder."""
    dataset = _datasets(files)[model]
    ref = _epochs(dataset)
    assert decodes['image'] > 0 and decodes['png_int'] > 0
    raw_cache.set_raw_cache(str(tmp_path / 'cache'))
    try:
        counts = []
        got = []
        for epoch in range(2):
            before = dict(decodes)
            loader = DataLoader(dataset, batch_size=2, shuffle=True,
                                num_workers=2, seed=3, drop_last=True)
            loader.set_epoch(epoch)
            got.append([tuple(np.array(a) for a in b) for b in loader])
            counts.append({k: decodes[k] - before[k] for k in decodes})
    finally:
        raw_cache.set_raw_cache(None)
    _assert_same(got, ref)
    # every file of the manifests once in the cold epoch, none after
    n = len(dataset)
    assert counts[0] == {'image': n, 'png_int': n * (
        4 if model == 'fusionnet' else 1)}
    assert counts[1] == {'image': 0, 'png_int': 0}
    assert len(os.listdir(str(tmp_path / 'cache'))) == \
        counts[0]['image'] + counts[0]['png_int']


def test_fusionnet_crops_the_raw_window(files, cache, monkeypatch):
    """With the cache on and a random crop, FusionNet's sample converts
    only the window, not the whole frame."""
    dataset = _datasets(files)['fusionnet']
    sizes = []
    from rcfd_tpu_torch.data import datasets
    encode = datasets.encode_png_int
    monkeypatch.setattr(datasets, 'encode_png_int',
                        lambda a: sizes.append(a.shape) or encode(a))
    sample = dataset.get(0, np.random.default_rng(0))
    assert [s.shape for s in sample] == [(*CROP, 3)] + [(*CROP, 1)] * 4
    assert sizes == [(*CROP, 1)] * 4


def test_readers_equal_uncached(files, cache, decodes):
    """Every reader with the cache on, cold then warm, against the cache
    off: a PNG and a JPEG frame (uint8, float32, CHW), a depth map (raw,
    float at x256, uint16 transport), a response map under both
    multipliers (one cached decode of one file); one entry a file and
    kind."""
    image, depth, response = (files['fn'][k][0] for k in (
        'image', 'depth', 'response'))
    readers = [
        lambda: port_io.load_image_u8(image, device='cpu'),
        lambda: port_io.load_image_u8(JPEG, 'CHW', device='cpu'),
        lambda: port_io.load_image(image, normalize=True, device='cpu'),
        lambda: port_io.load_image(JPEG, device='cpu'),
        lambda: port_io.load_depth_raw(depth),
        lambda: port_io.load_depth(depth, data_format='HWC'),
        lambda: port_io.load_depth_u16(depth),
        lambda: port_io.load_depth(response),
        lambda: port_io.load_response(response),
    ]
    raw_cache.set_raw_cache(None)
    ref = [np.array(r()) for r in readers]
    raw_cache.set_raw_cache(cache)
    before = dict(decodes)
    for _ in range(2):
        for r, want in zip(readers, ref):
            got = np.asarray(r())
            if r is readers[4]:  # the cache keeps the raw integers in 16 bits
                assert got.dtype == np.uint16
                got = got.astype(want.dtype)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert decodes['image'] - before['image'] == 2
    assert decodes['png_int'] - before['png_int'] == 2
    assert len(os.listdir(cache)) == 4


def test_rewritten_file_decodes_again(tmp_path, cache, decodes):
    path = str(tmp_path / 'd.png')
    rng = np.random.default_rng(1)
    port_io.save_depth(rng.random((8, 8), dtype=np.float32) * 50, path)
    first = port_io.load_depth(path)
    np.testing.assert_array_equal(port_io.load_depth(path), first)
    assert decodes['png_int'] == 1
    new = rng.random((8, 8), dtype=np.float32) * 50
    time.sleep(0.01)  # the modification time moves
    port_io.save_depth(new, path)
    reloaded = port_io.load_depth(path)
    assert decodes['png_int'] == 2
    assert not np.array_equal(reloaded, first)
    np.testing.assert_array_equal(reloaded,
                                  np.floor(new * 256).astype(np.float32) /
                                  np.float32(256))


def test_env_var_turns_the_cache_on(files, tmp_path, monkeypatch):
    """RCFD_RAW_CACHE, read on the first cache_dir() of the process, as
    long as set_raw_cache has not been called."""
    d = str(tmp_path / 'env_cache')
    monkeypatch.setattr(raw_cache, '_INIT', [False])
    monkeypatch.setattr(raw_cache, '_DIR', None)
    monkeypatch.setenv('RCFD_RAW_CACHE', d)
    try:
        assert raw_cache.cache_dir() == d
        port_io.load_depth(files['fn']['depth'][0])
        assert len(os.listdir(d)) == 1
        monkeypatch.setenv('RCFD_RAW_CACHE', str(tmp_path / 'other'))
        assert raw_cache.cache_dir() == d  # read once
    finally:
        raw_cache.set_raw_cache(None)


def test_raw_cache_for_restores_the_setting(tmp_path):
    raw_cache.set_raw_cache(None)
    with raw_cache.raw_cache_for(str(tmp_path / 'a')):
        assert raw_cache.cache_dir() == str(tmp_path / 'a')
    assert raw_cache.cache_dir() is None
    with raw_cache.raw_cache_for(None):
        assert raw_cache.cache_dir() is None


def test_failed_write_warns_once_and_returns_the_array(files, cache,
                                                       monkeypatch):
    monkeypatch.setattr(raw_cache, '_WRITE_FAIL_WARNED', [False])

    def fail(*a, **k):
        raise OSError('no space left on device')
    monkeypatch.setattr(raw_cache.os, 'replace', fail)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        depth = [port_io.load_depth(p) for p in files['fn']['depth'][:2]]
    assert [str(w.message) for w in caught
            if w.category is RuntimeWarning and 'raw cache' in
            str(w.message)] == [
        'raw cache write to {} failed (OSError: no space left on device); '
        'the loader decodes every epoch again. Check the disk space and '
        'permissions of RCFD_RAW_CACHE.'.format(cache)]
    raw_cache.set_raw_cache(None)
    for got, path in zip(depth, files['fn']['depth'][:2]):
        np.testing.assert_array_equal(got, port_io.load_depth(path))
    assert os.listdir(cache) == []  # no temporary file is left


def test_failed_decode_raises(tmp_path, cache):
    """A corrupt file raises with the cache on, as without it; nothing is
    cached for it."""
    path = str(tmp_path / 'bad.png')
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + b'\x00' * 40)
    with pytest.raises(OSError):
        port_io.load_depth(path)
    assert os.listdir(cache) == []


def test_cached_fusionnet_sample_matches_jax(files, tmp_path):
    """The port's FusionNet sample with its cache on equals the JAX
    package's FusionNetTrainingDataset with its own cache on (integer
    transport, the same files, crop and rng), byte for byte, cold and
    warm."""
    from rcfd_tpu.data import datasets as jax_datasets
    from rcfd_tpu.data import raw_cache as jax_raw_cache

    fn = files['fn']
    streams = [fn[k] for k in ('image', 'depth', 'response', 'ground_truth',
                               'lidar')]
    jax_ds = jax_datasets.FusionNetTrainingDataset(
        *streams, shape=CROP, random_crop_type=CROP_TYPE, transport=True)
    port_ds = FusionNetTrainingDataset(*streams, shape=CROP,
                                       random_crop_type=CROP_TYPE,
                                       device='cpu')
    jax_raw_cache.set_raw_cache(str(tmp_path / 'jax'))
    raw_cache.set_raw_cache(str(tmp_path / 'port'))
    try:
        for epoch in range(2):
            for i in range(len(port_ds)):
                seed = (3, epoch, i)
                _assert_same(port_ds.get(i, np.random.default_rng(seed)),
                             jax_ds.get(i, np.random.default_rng(seed)))
    finally:
        jax_raw_cache.set_raw_cache(None)
        raw_cache.set_raw_cache(None)
    # the same key scheme: one entry per file and kind in each cache
    assert sorted(os.listdir(str(tmp_path / 'port'))) == \
        sorted(os.listdir(str(tmp_path / 'jax')))


def test_inference_dataset_reads_through_the_cache(files, cache, decodes):
    rn = files['rn']
    dataset = RadarNetInferenceDataset(rn['image'], rn['radar'],
                                       rn['ground_truth'], max_points=8,
                                       device='cpu')
    first = [dataset.get(i) for i in range(len(dataset))]
    before = dict(decodes)
    _assert_same([dataset.get(i) for i in range(len(dataset))], first)
    assert decodes == before


@pytest.mark.parametrize('cli', ['fusionnet', 'radarnet'])
def test_train_clis_take_raw_cache_dirpath(files, tmp_path, cli):
    """Both training CLIs take --raw_cache_dirpath and run a step with the
    cache in that directory, and leave the cache off after."""
    raw_cache.set_raw_cache(None)
    d = str(tmp_path / 'cache')
    net = ['--n_thread', '2', '--learning_schedule', '1', '--batch_size',
           '2', '--device', 'cpu', '--checkpoint_dirpath',
           str(tmp_path / 'ckpt'), '--raw_cache_dirpath', d]
    if cli == 'fusionnet':
        m = files['fn_manifests']
        argv = net + [
            '--n_height', '32', '--n_width', '32',
            '--augmentation_random_crop_type', 'horizontal', 'vertical',
            '--n_filters_encoder_image', '4', '8', '8', '8', '8', '8',
            '--n_filters_encoder_depth', '4', '4', '8', '8', '8', '8',
            '--n_filters_decoder', '8', '8', '8', '8', '8', '8',
            '--fusion_type', 'weight_and_project',
            '--min_predict_depth', '1']
        for split in ('train', 'val'):
            for key, name in (('image', 'image'), ('depth', 'depth'),
                              ('response', 'response'),
                              ('ground_truth', 'ground_truth'),
                              ('lidar', 'lidar_map')):
                if split == 'val' and key == 'lidar':
                    continue
                argv += ['--{}_{}_path'.format(split, name), m[key]]
        main = train_fusionnet.main
    else:
        m = files['rn_manifests']
        argv = net + [
            '--patch_size', str(H), '32', '--total_points_sampled', '3',
            '--n_filters_encoder_image', '4', '8', '8', '8', '8',
            '--n_neurons_encoder_depth', '4', '8', '8', '8', '8',
            '--n_filters_decoder', '8', '8', '8', '8', '8']
        for split in ('train', 'val'):
            for key in ('image', 'radar', 'ground_truth'):
                argv += ['--{}_{}_path'.format(split, key), m[key]]
        main = train_radarnet.main
    timings = []
    main(argv, timings=timings)
    assert [t['step'] for t in timings] == [1, 2]
    assert all(np.isfinite(t['loss']) for t in timings)
    assert raw_cache.cache_dir() is None
    cached = os.listdir(d)
    assert cached and all(f.endswith('.npy') for f in cached)
