"""FusionNet's TensorBoard image panel and histograms in the port's
training loop (rcfd_tpu_torch/fusionnet_main.py ``log_image_summary``,
the counterpart of rcfd_tpu/fusionnet_main.py ``_log_image_summary``),
read back from the event file with tensorboard's EventAccumulator. No JAX
here: the JAX loop writes them every ``n_step_per_summary`` steps, which
is what the test holds the port to."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
event_accumulator = pytest.importorskip(
    'tensorboard.backend.event_processing.event_accumulator')

from rcfd_tpu_torch import fusionnet_main  # noqa: E402
from rcfd_tpu_torch.utils.summary import SummaryWriter  # noqa: E402

from test_torch_profiling import FUSIONNET, N_STEPS, inputs  # noqa: F401,E402

PANEL = 'train-image-depth-output-gt'
HISTOGRAMS = ['train-ground_truth_distro', 'train-output_depth_distro']


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(inputs, directory, every):  # noqa: F811
    fusionnet_main.train(
        checkpoint_dirpath=str(directory), restore_path=None, device='cpu',
        **inputs['fusionnet'], **dict(FUSIONNET, n_step_per_summary=every))
    events = event_accumulator.EventAccumulator(
        str(directory / 'events-train'),
        size_guidance={event_accumulator.IMAGES: 0,
                       event_accumulator.HISTOGRAMS: 0})
    events.Reload()
    return events


@pytest.mark.parametrize('every', [1, 2])
def test_train_writes_the_panel_and_histograms(inputs, tmp_path,  # noqa
                                               every):
    """Every ``n_step_per_summary`` steps: one panel of 4 rows (image,
    input depth, output, ground truth) by the batch's 2 samples of 32x32,
    and the output's and the ground truth's histograms over their
    2 x 32 x 32 values, the output within FusionNet's range."""
    events = _run(inputs, tmp_path, every)
    steps = list(range(every, N_STEPS + 1, every))
    assert events.Tags()['images'] == [PANEL]
    assert sorted(events.Tags()['histograms']) == HISTOGRAMS
    panels = events.Images(PANEL)
    assert [e.step for e in panels] == steps
    assert all((e.height, e.width) == (4 * 32, 2 * 32) for e in panels)
    for tag in HISTOGRAMS:
        hist = events.Histograms(tag)
        assert [e.step for e in hist] == steps
        assert all(e.histogram_value.num == 2 * 32 * 32 for e in hist)
    output = events.Histograms('train-output_depth_distro')[-1]
    assert 1.0 / 1.01 - 1e-6 <= output.histogram_value.min
    assert output.histogram_value.max <= 100.0


def test_without_matplotlib_only_the_histograms(inputs, tmp_path,  # noqa
                                                monkeypatch):
    """The card's machine has no matplotlib: the histograms are written and
    the panel is skipped."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    events = _run(inputs, tmp_path, 1)
    assert events.Tags()['images'] == []
    assert sorted(events.Tags()['histograms']) == HISTOGRAMS
    assert [e.step for e in events.Histograms(HISTOGRAMS[0])] == list(
        range(1, N_STEPS + 1))


def _batch(rng):
    shape = (3, 16, 24)
    return tuple(torch.from_numpy(a) for a in (
        rng.integers(0, 256, shape + (3,), dtype=np.uint8),
        *[(rng.random(shape + (1,)) * 60 * 256).astype(np.uint16)
          for _ in range(4)]))


def test_a_failing_forward_fails(tmp_path, rng):
    """No catch-all: an error of the panel's forward reaches the caller."""
    def forward(image, depth, response):
        raise RuntimeError('forward failed')

    writer = SummaryWriter(str(tmp_path))
    with pytest.raises(RuntimeError, match='forward failed'):
        fusionnet_main.log_image_summary(writer, 'train', 1, forward,
                                         _batch(rng), 100.0)
    writer.close()


def test_the_panel_of_a_batch(tmp_path, rng):
    """The panel's rows are the image / 255 and the depths through
    ``colorize`` over [0, max_depth]; ``n_display`` samples of the batch
    go in, and a disabled writer writes nothing and runs no forward."""
    from rcfd_tpu_torch.utils.log_utils import colorize

    written = {}

    class Writer:
        enabled = True

        def add_image(self, tag, image, global_step=None):
            written[tag] = image

        def add_histogram(self, tag, values, global_step=None):
            written[tag] = np.asarray(values)

    batch = _batch(rng)
    output = torch.rand(2, 16, 24) * 90 + 1
    seen = []

    def forward(image, depth, response):
        seen.append(image.shape[0])
        return output

    fusionnet_main.log_image_summary(Writer(), 'train', 3, forward, batch,
                                     80.0, n_display=2)
    assert seen == [2]
    panel = written[PANEL]
    assert panel.shape == (4 * 16, 2 * 24, 3)
    image = batch[0][:2].numpy() / 255.0
    depth = batch[1][:2].numpy() / 256.0
    gt = batch[3][:2].numpy() / 256.0
    np.testing.assert_allclose(panel[:16, :24], image[0], rtol=1e-6)
    np.testing.assert_allclose(panel[16:32, 24:], colorize(
        depth / 80.0, 'viridis')[1], rtol=1e-6)
    np.testing.assert_allclose(panel[32:48, :24], colorize(
        output.numpy() / 80.0, 'viridis')[0], rtol=1e-6)
    np.testing.assert_allclose(panel[48:, 24:], colorize(
        gt / 80.0, 'viridis')[1], rtol=1e-6)
    np.testing.assert_array_equal(written['train-output_depth_distro'],
                                  output.numpy())
    np.testing.assert_array_equal(written['train-ground_truth_distro'], gt)

    class Disabled(Writer):
        enabled = False

    seen.clear()
    fusionnet_main.log_image_summary(Disabled(), 'train', 3, forward, batch,
                                     80.0)
    assert seen == []
