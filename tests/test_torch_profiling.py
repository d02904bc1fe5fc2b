"""The port's profiling utilities (rcfd_tpu_torch/utils/profiling.py) and
the trace window of both training loops on the CPU: RCFD_PROFILE_STEPS
parsed as the JAX package parses it, one window a run, a Chrome trace of
the steps asked for, and the same losses and checkpoints as a run without
the window. No JAX here."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch import fusionnet_main, radarnet_main  # noqa: E402
from rcfd_tpu_torch.utils import profiling  # noqa: E402

from fixtures import make_fusionnet_fixture, make_radarnet_fixture  # noqa

FUSIONNET = dict(
    input_channels_image=3, input_channels_depth=2,
    normalized_image_range=[0, 1], encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_filters_decoder=[16, 12, 8, 8, 8], n_resolutions_decoder=1,
    min_predict_depth=1.0, max_predict_depth=100.0,
    weight_initializer='kaiming_uniform', activation_func='leaky_relu',
    batch_size=2, n_height=32, n_width=32, learning_rates=[1e-3],
    learning_schedule=[2], loss_func='l1', w_smoothness=0.0,
    w_lidar_loss=2.0, w_weight_decay=0.0, loss_smoothness_kernel_size=-1,
    outlier_removal_kernel_size=7, outlier_removal_threshold=1.5,
    ground_truth_dilation_kernel_size=-1, augmentation_probabilities=[1.0],
    augmentation_schedule=[-1],
    augmentation_random_crop_type=['horizontal', 'vertical'],
    augmentation_random_brightness=[0.8, 1.2],
    augmentation_random_contrast=[-1, -1],
    augmentation_random_saturation=[-1, -1],
    augmentation_random_flip_type=['horizontal'], min_evaluate_depth=0.0,
    max_evaluate_depth=100.0, n_step_per_checkpoint=2,
    n_step_per_summary=100, start_step_validation=10 ** 9, n_thread=2,
    seed=0)
RADARNET = dict(
    input_channels_image=3, input_channels_depth=3,
    normalized_image_range=[0, 1], encoder_type='radarnetv1-batch_norm',
    n_filters_encoder_image=[4, 8, 8, 8, 8],
    n_neurons_encoder_depth=[4, 8, 8, 8, 8],
    decoder_type='multiscale-batch_norm', n_filters_decoder=[8, 8, 8, 8, 8],
    weight_initializer='kaiming_uniform', activation_func='leaky_relu',
    batch_size=2, patch_size=[32, 36], total_points_sampled=3,
    sample_probability_of_lidar=0.5, learning_rates=[1e-3],
    learning_schedule=[2], augmentation_probabilities=[1.0],
    augmentation_schedule=[-1], augmentation_random_brightness=[0.8, 1.2],
    augmentation_random_contrast=[0.8, 1.2],
    augmentation_random_saturation=[0.8, 1.2],
    augmentation_random_noise_type='gaussian',
    augmentation_random_noise_spread=2.0,
    augmentation_random_flip_type=['horizontal'], w_weight_decay=0.0,
    w_positive_class=2.0, max_distance_correspondence=0.4,
    set_invalid_to_negative_class=True, n_step_per_checkpoint=2,
    n_step_per_summary=100, start_step_validation=10 ** 9,
    min_evaluate_depth=0.0, max_evaluate_depth=100.0, n_thread=2, seed=0)
# 4 frames at batch 2: 2 steps an epoch, 4 steps in all
N_STEPS = 4


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's tiny steps on one thread (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    fn = make_fusionnet_fixture(str(tmp_path_factory.mktemp('fn')),
                                n_samples=4, height=40, width=48)
    rn = make_radarnet_fixture(str(tmp_path_factory.mktemp('rn')),
                               n_samples=4, height=40, width=64, n_points=6)
    return {
        'fusionnet': dict(
            train_image_path=fn['image'], train_depth_path=fn['depth'],
            train_response_path=fn['response'],
            train_ground_truth_path=fn['ground_truth'],
            train_lidar_map_path=fn['lidar'], val_image_path=fn['image'],
            val_depth_path=fn['depth'], val_response_path=fn['response'],
            val_ground_truth_path=fn['ground_truth']),
        'radarnet': dict(
            train_image_path=rn['image'], train_radar_path=rn['radar'],
            train_ground_truth_path=rn['ground_truth'],
            val_image_path=rn['image'], val_radar_path=rn['radar'],
            val_ground_truth_path=rn['ground_truth'])}


def _train(model, inputs, checkpoint_dirpath):
    """A tiny CPU training run of ``model``: its timings."""
    main, net = {'fusionnet': (fusionnet_main, FUSIONNET),
                 'radarnet': (radarnet_main, RADARNET)}[model]
    timings = []
    main.train(checkpoint_dirpath=str(checkpoint_dirpath), restore_path=None,
               device='cpu', timings=timings, **inputs[model], **net)
    return timings


def _window(monkeypatch, directory=None, steps=None):
    for name, value in (('RCFD_PROFILE_DIR', directory),
                        ('RCFD_PROFILE_STEPS', steps)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))
    return profiling.TraceWindow()


@pytest.mark.parametrize('steps, window', [
    (None, (10, 12)), ('3-7', (3, 7)), ('12-14', (12, 14)),
    ('7', (10, 12)), ('a-b', (10, 12)), ('1-2-3', (10, 12)), ('', (10, 12))])
def test_trace_window_parses_the_steps_as_jax(monkeypatch, tmp_path, steps,
                                              window):
    """RCFD_PROFILE_STEPS 'a-b' sets the window; unset or malformed, it is
    10-12 (rcfd_tpu/utils/profiling.py ``TraceWindow``)."""
    tw = _window(monkeypatch, tmp_path, steps)
    assert (tw.start_step, tw.stop_step) == window
    assert tw.dir == str(tmp_path)


def test_trace_window_is_off_without_a_directory(monkeypatch):
    tw = _window(monkeypatch, None, '1-2')
    for step in range(1, 6):
        tw.after_step(step)
    tw.close()
    assert tw.dir is None and tw.path is None


def _events(path):
    with open(path) as f:
        return json.load(f)['traceEvents']


def test_one_window_a_run(monkeypatch, tmp_path):
    """The trace starts after step a and stops after step b: steps a + 1 to
    b are traced, into one file named for them; later steps open no second
    window."""
    tw = _window(monkeypatch, tmp_path, '2-4')
    x = torch.ones(8)
    for step in range(1, 9):
        x = x * 2  # a step's work
        tw.after_step(step)
    tw.close()
    assert tw.path == str(tmp_path / 'trace-steps-3-4.json')
    assert os.listdir(tmp_path) == ['trace-steps-3-4.json']
    assert any(e.get('name') == 'aten::mul' for e in _events(tw.path))


def test_close_stops_an_open_window(monkeypatch, tmp_path):
    """A run that ends inside its window writes the steps it traced when
    the loop closes the window."""
    tw = _window(monkeypatch, tmp_path, '2-10')
    for step in range(1, 5):
        tw.after_step(step)
    assert os.listdir(tmp_path) == []
    tw.close()
    assert os.listdir(tmp_path) == ['trace-steps-3-4.json']
    tw.close()  # closed: nothing more
    assert os.listdir(tmp_path) == ['trace-steps-3-4.json']


def test_step_timer_and_trace(tmp_path):
    """StepTimer's rolling window and summary; ``trace`` writes a Chrome
    trace of its block, and is a no-op without a directory."""
    timer = profiling.StepTimer(window=3)
    assert timer.summary() == {}
    for _ in range(5):
        with timer.step():
            pass
    assert len(timer.times) == 3
    summary = timer.summary()
    assert sorted(summary) == ['mean_s', 'p50_s', 'p95_s', 'steps_per_s']
    assert summary['p50_s'] <= summary['p95_s']
    assert summary['steps_per_s'] == pytest.approx(1 / summary['mean_s'])
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / 'log'), device='cpu'):
        torch.ones(4).sum()
    assert any(e.get('name') == 'aten::sum'
               for e in _events(tmp_path / 'log' / 'trace.json'))


def _checkpoints(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith('.pth'):
            out[name] = torch.load(os.path.join(directory, name),
                                   map_location='cpu', weights_only=True)
    return out


def _assert_same(a, b, where=''):
    if torch.is_tensor(a):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            _assert_same(a[k], b[k], '{}/{}'.format(where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, '{}/{}'.format(where, i))
    else:
        assert a == b, where


@pytest.mark.parametrize('model', ['fusionnet', 'radarnet'])
def test_training_writes_one_trace_and_trains_the_same(model, inputs,
                                                       tmp_path,
                                                       monkeypatch):
    """A tiny run with RCFD_PROFILE_DIR and RCFD_PROFILE_STEPS=1-3 writes
    exactly one Chrome trace, of steps 2 and 3, holding their host ops; its
    losses and checkpoints equal, exactly, those of the same run without
    the window."""
    _window(monkeypatch)
    plain = _train(model, inputs, tmp_path / 'plain')
    traces = tmp_path / 'traces'
    _window(monkeypatch, traces, '1-3')
    traced = _train(model, inputs, tmp_path / 'traced')
    assert [t['step'] for t in traced] == list(range(1, N_STEPS + 1))
    assert [t['loss'] for t in traced] == [t['loss'] for t in plain]
    assert all(np.isfinite(t['loss']) for t in traced)
    assert os.listdir(traces) == ['trace-steps-2-3.json']
    names = {e.get('name') for e in _events(traces / 'trace-steps-2-3.json')}
    assert 'aten::convolution' in names
    a, b = _checkpoints(tmp_path / 'plain'), _checkpoints(tmp_path / 'traced')
    assert sorted(a) == ['model-2.pth', 'model-4.pth']
    _assert_same(a, b)
