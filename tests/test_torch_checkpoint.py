"""Checkpoint restore of rcfd_tpu_torch on the CPU: files written by the JAX
package's save_checkpoint (the reference .pth format and the native .npz
format) restore to exactly the state_dict that state_dict_from_jax makes of
the same trees; TwoStagePipeline.from_checkpoints serves what a pipeline
built in memory serves."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu.models.fusionnet import FusionNetModel as JaxFusionNet  # noqa
from rcfd_tpu.models.radarnet import RadarNetModel as JaxRadarNet  # noqa

from rcfd_tpu_torch import pipeline  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.models import fusionnet as port_fusionnet  # noqa: E402
from rcfd_tpu_torch.models import radarnet as port_radarnet  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import (load_state_dict_file,  # noqa
                                             state_dict_from_jax)

from torch_parity import (FUSIONNET_TINY, H, RADARNET_TINY, W,  # noqa: E402
                          frame_and_points, jax_variables)

MODELS = {
    'radarnet': (JaxRadarNet, RadarNetModel, RADARNET_TINY,
                 port_radarnet.PTH_KEYS),
    'fusionnet': (JaxFusionNet, FusionNetModel, FUSIONNET_TINY,
                  port_fusionnet.PTH_KEYS),
}
STEP = 1234


@pytest.fixture(scope='module')
def trees():
    rng = np.random.default_rng(40)
    return {name: jax_variables(jax_cls(**config), i, rng)
            for i, (name, (jax_cls, _, config, _)) in
            enumerate(sorted(MODELS.items()))}


def _save(tmp_path, trees, name, fmt):
    jax_cls, _, config, _ = MODELS[name]
    path = str(tmp_path / '{}-{}.{}'.format(name, STEP, fmt))
    jax_cls(**config).save_checkpoint(path, *trees[name], step=STEP)
    return path


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key].cpu(), want[key]), key


@pytest.mark.parametrize('fmt', ['pth', 'npz'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_restore_equals_state_dict_from_jax(tmp_path, trees, name, fmt):
    """restore_checkpoint of a JAX-written file gives the model exactly the
    weights state_dict_from_jax gives it from the same trees, and returns
    the train step."""
    _, cls, config, _ = MODELS[name]
    path = _save(tmp_path, trees, name, fmt)
    model = cls(**config, device='cpu')
    assert model.restore_checkpoint(path, device='cpu') == STEP
    ref = cls(**config, device='cpu')
    ref.load_state_dict(state_dict_from_jax(*trees[name]), strict=True)
    _assert_state_dicts_equal(model.state_dict(), ref.state_dict())


@pytest.mark.parametrize('name', sorted(MODELS))
def test_restore_strips_the_module_prefix(tmp_path, trees, name):
    """A .pth whose state_dicts carry DataParallel's ``module.`` prefix (as
    the reference saves them) restores to the same weights."""
    _, cls, config, pth_keys = MODELS[name]
    path = _save(tmp_path, trees, name, 'pth')
    checkpoint = torch.load(path, weights_only=True)
    for key in pth_keys.values():
        checkpoint[key] = {'module.' + k: v
                           for k, v in checkpoint[key].items()}
    prefixed = str(tmp_path / 'prefixed.pth')
    torch.save(checkpoint, prefixed)
    state_dict, step = load_state_dict_file(prefixed, pth_keys)
    assert step == STEP
    _assert_state_dicts_equal(state_dict, {
        '{}.{}'.format(part, k): v for part in ('encoder', 'decoder')
        for k, v in state_dict_from_jax(trees[name][0][part],
                                        trees[name][1][part]).items()})
    ref = cls(**config, device='cpu')
    ref.load_state_dict(state_dict_from_jax(*trees[name]), strict=True)
    model = cls(**config, device='cpu')
    model.restore_checkpoint(prefixed, device='cpu')
    _assert_state_dicts_equal(model.state_dict(), ref.state_dict())


def test_orbax_is_refused(tmp_path):
    with pytest.raises(ValueError, match=r'\.pth.*\.npz'):
        load_state_dict_file(str(tmp_path / 'model.orbax'),
                             port_radarnet.PTH_KEYS)
    with pytest.raises(ValueError, match='orbax'):
        RadarNetModel(**RADARNET_TINY, device='cpu').restore_checkpoint(
            str(tmp_path / 'model.orbax/'), device='cpu')


def test_restore_of_a_mismatched_model_raises(tmp_path, trees):
    """strict=True: a checkpoint of another width does not load."""
    path = _save(tmp_path, trees, 'radarnet', 'npz')
    wider = dict(RADARNET_TINY, n_filters_decoder=[8, 8, 8, 8, 4])
    with pytest.raises(RuntimeError):
        RadarNetModel(**wider, device='cpu').restore_checkpoint(
            path, device='cpu')


@pytest.mark.parametrize('fmt', ['pth', 'npz'])
def test_from_checkpoints_matches_pipeline_in_memory(tmp_path, trees, fmt):
    """from_checkpoints with the tiny configurations as overrides serves
    exactly what a pipeline built from the same trees in memory serves,
    one frame and a batch."""
    paths = [_save(tmp_path, trees, name, fmt)
             for name in ('radarnet', 'fusionnet')]
    radarnet_kw = dict(RADARNET_TINY)
    patch = radarnet_kw.pop('input_patch_size_image')
    restored = pipeline.TwoStagePipeline.from_checkpoints(
        *paths, image_height=H, image_width=W, patch_size=patch,
        radarnet_kwargs=radarnet_kw, fusionnet_kwargs=FUSIONNET_TINY,
        device='cpu')
    rn = RadarNetModel(**RADARNET_TINY, device='cpu')
    rn.load_state_dict(state_dict_from_jax(*trees['radarnet']), strict=True)
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    fn.load_state_dict(state_dict_from_jax(*trees['fusionnet']),
                       strict=True)
    in_memory = pipeline.TwoStagePipeline(rn, fn, H, W, device='cpu')
    assert restored.device == torch.device('cpu')
    image, points, valid = frame_and_points(np.random.default_rng(41))
    for a, b in zip(restored(image, points, valid),
                    in_memory(image, points, valid)):
        assert torch.equal(a, b)
    batch = (np.concatenate([image, image[:, ::-1]]),
             np.stack([points, points[::-1]]), np.stack([valid, valid]))
    for a, b in zip(restored.forward_batched(*batch),
                    in_memory.forward_batched(*batch)):
        assert torch.equal(a, b)


def test_from_checkpoints_passes_pipeline_options(tmp_path, trees):
    paths = [_save(tmp_path, trees, name, 'npz')
             for name in ('radarnet', 'fusionnet')]
    radarnet_kw = dict(RADARNET_TINY)
    patch = radarnet_kw.pop('input_patch_size_image')
    pipe = pipeline.TwoStagePipeline.from_checkpoints(
        *paths, image_height=H, image_width=W, patch_size=patch,
        radarnet_kwargs=radarnet_kw, fusionnet_kwargs=FUSIONNET_TINY,
        device='cpu', codec_encode=True, quantize_bridge=False)
    assert pipe.codec_encode and not pipe.quantize_bridge
    assert (pipe.image_height, pipe.image_width) == (H, W)
    assert pipe.radarnet.input_patch_size_image == tuple(patch)


def test_restore_needs_a_card_unless_asked_for_cpu(tmp_path, trees,
                                                   monkeypatch):
    paths = [_save(tmp_path, trees, name, 'npz')
             for name in ('radarnet', 'fusionnet')]
    model = RadarNetModel(**RADARNET_TINY, device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.restore_checkpoint(paths[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.TwoStagePipeline.from_checkpoints(*paths)
