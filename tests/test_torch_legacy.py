"""The legacy v0 stack of rcfd_tpu_torch (models/legacy_v0.py,
legacy_main.py, data/legacy_datasets.py, the v0 checkpoints) against the
JAX package's on the CPU, from numpy inputs drawn from a seed.

The JAX v0 network's widths are fixed (32 to 256 channels), so the tests
shrink only the spatial size: 64x32 and 64x60 crops of 64x96 frames. The
JAX trees come from the port's init through JAX's own
``torch_state_dict_to_tree`` (JAX's eager init of the network takes tens
of seconds), with every batch norm's statistics drawn from the seed."""

import os
import pickle
import sys
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import legacy_main as jax_main  # noqa: E402
from rcfd_tpu.data import legacy_datasets as jax_datasets  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import legacy_v0 as jax_v0  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import legacy_main  # noqa: E402
from rcfd_tpu_torch import save_depth_radar  # noqa: E402
from rcfd_tpu_torch.data import io, legacy_datasets, transport  # noqa
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import legacy_v0  # noqa: E402
from rcfd_tpu_torch.nn.layers import BatchNorm2d  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from test_torch_train_ops import jax_draws  # noqa: E402
from torch_parity import (nchw, nhwc, scattered_crops,  # noqa: E402
                          unexplained_depth)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import save_depth_radar as jax_save_depth_radar  # noqa: E402

FRAME = (64, 96)
PATCHES = [(64, 32), (64, 60)]
# float32 forward against JAX's, relative to the logits' max-abs
LOGIT_TOL = 1e-5
# training-mode forward: JAX's batch variance is E[x^2] - mean^2, torch's
# is two-pass, over as few as 4 values a channel at the deepest stage
LOGIT_TRAIN_TOL = 1e-4
RESPONSE_TOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize_batch_norm(model, rng):
    """Draw every batch norm's weight, bias and running statistics (2-d
    and 1-d) from ``rng``, so that none is the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm2d, legacy_v0.BatchNorm1d)):
                n = m.weight.shape[0]
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5,
                                                                 n)))
    return model


def port_and_jax(jax_module, port_module, rng, seed=0):
    """The port's module with its weights drawn from ``seed`` and its batch
    norms from ``rng``, and the JAX module's (params, state) of the same
    weights, through JAX's torch_state_dict_to_tree."""
    from rcfd_tpu_torch.nn.layers import init_parameters
    init_parameters(port_module, torch.Generator().manual_seed(seed))
    randomize_batch_norm(port_module, rng)
    params_t, state_t = jax.eval_shape(jax_module.init,
                                       jax.random.PRNGKey(0))
    p, s = jax_ckpt.torch_state_dict_to_tree(
        {k: v.numpy() for k, v in port_module.state_dict().items()})
    return (jax_ckpt.conform_to_template(params_t, p),
            jax_ckpt.conform_to_template(state_t, s, fill_missing=True))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(np.asarray(got) - ref).max() <= tol * scale


# -- modules -------------------------------------------------------------------


@pytest.mark.parametrize('training', [False, True])
def test_batch_norm_1d_matches_jax(rng, training):
    """BatchNorm1d in training mode (the batch's E[x^2] - mean^2, the
    running statistics moved with n / (n - 1)) and in eval mode (the
    running statistics): outputs within 1e-6 of their max-abs, running
    statistics rtol 1e-6, the count 1."""
    bn = legacy_v0.BatchNorm1d(12)
    params, state = port_and_jax(jax_v0.BatchNorm1d(12), bn, rng)
    x = (rng.standard_normal((5, 12)) * 3 + 1).astype(np.float32)
    y_ref, state_ref = jax_v0.BatchNorm1d(12)(params, state, jnp.asarray(x),
                                             training=training)
    bn.train(training)
    with torch.no_grad():
        y = bn(torch.from_numpy(x))
    _close(y.numpy(), y_ref, 1e-6)
    for k in ('running_mean', 'running_var'):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(state_ref[k]), rtol=1e-6,
                                   atol=1e-7)
    assert int(bn.num_batches_tracked) == int(state_ref['num_batches_tracked'])


@pytest.mark.parametrize('stride', [(2, 2), (1, 1)])
def test_resnet_block_matches_jax(rng, stride):
    """A 17x3 residual block with batch norm, strided (projection) and
    not, eval mode."""
    kw = dict(kernel_size=(17, 3), stride=stride, use_batch_norm=True,
              activation_func='leaky_relu')
    c_in = 8 if stride == (2, 2) else 16
    port = legacy_v0.LegacyResNetBlock(c_in, 16, **kw).eval()
    jax_block = jax_v0.LegacyResNetBlock(c_in, 16, **kw)
    params, state = port_and_jax(jax_block, port, rng)
    x = rng.standard_normal((2, 20, 12, c_in)).astype(np.float32)
    ref, _ = jax_block(params, state, jnp.asarray(x))
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), ref, LOGIT_TOL)


def test_radar_branch_and_decoder_match_jax(rng):
    """The MLP radar branch in training mode and the VOICED decoder in
    eval mode, on the skips of a 64x32 crop."""
    branch = legacy_v0.LegacyRadarBranch(n_outputs=2)
    jb = jax_v0.LegacyRadarBranch(n_outputs=2)
    params, state = port_and_jax(jb, branch, rng)
    x = (rng.random((4, 3)) * 40).astype(np.float32)
    ref, _ = jb(params, state, jnp.asarray(x), training=True)
    branch.train()
    with torch.no_grad():
        _close(branch(torch.from_numpy(x)).numpy(), ref, LOGIT_TRAIN_TOL)

    dec = legacy_v0.LegacyVOICEDDecoder().eval()
    jd = jax_v0.LegacyVOICEDDecoder()
    params, state = port_and_jax(jd, dec, rng)
    skips = [rng.standard_normal((2, 32 // f, 16 // f, c)).astype(np.float32)
             for f, c in ((1, 32), (2, 64), (4, 128), (8, 128))]
    latent = rng.standard_normal((2, 2, 1, 256)).astype(np.float32)
    ref, _ = jd(params, state, jnp.asarray(latent),
                [jnp.asarray(s) for s in skips])
    with torch.no_grad():
        out = dec(nchw(latent), [nchw(s) for s in skips])
    assert out.shape == (2, 1, 64, 32)
    _close(nhwc(out), ref, LOGIT_TOL)


@pytest.fixture(scope='module')
def nets():
    """The v0 FusionNet at both patches, port (float32) and JAX trees."""
    rng = np.random.default_rng(11)
    out = {}
    for patch in PATCHES:
        port = legacy_main.build_model(patch)
        out[patch] = (port, *port_and_jax(jax_main.build_model(patch), port,
                                          rng, seed=sum(patch)))
    return out


@pytest.mark.parametrize('training', [False, True])
@pytest.mark.parametrize('patch', PATCHES, ids=['64x32', '64x60'])
def test_fusionnet_matches_jax(nets, rng, patch, training):
    """The whole v0 FusionNet with the logit bias: logits within 1e-5 of
    their max-abs in eval mode, 1e-4 in training mode (batch norm by the
    batch), and the running statistics after the training forward."""
    port, params, state = nets[patch]
    port = legacy_v0.LegacyFusionNet(bias_factor=1.5,
                                     latent_hw=port.latent_hw).train(training)
    port.load_state_dict(nets[patch][0].state_dict())
    jax_net = jax_v0.LegacyFusionNet(bias_factor=1.5,
                                     latent_hw=port.latent_hw)
    image = rng.random((3,) + patch + (3,)).astype(np.float32)
    radar = (rng.random((3, 3)) * [patch[1], patch[0], 60]).astype(
        np.float32)
    ref, new_state = jax_net(params, state, jnp.asarray(image),
                             jnp.asarray(radar), training=training)
    with torch.no_grad():
        out = port(nchw(image), torch.from_numpy(radar))
    assert out.shape == (3, 1) + patch
    _close(nhwc(out), ref, LOGIT_TRAIN_TOL if training else LOGIT_TOL)
    if training:
        ref_sd = state_dict_from_jax(params, jax.device_get(new_state))
        for name, buf in port.named_buffers():
            if not name.endswith('num_batches_tracked'):
                np.testing.assert_allclose(buf.numpy(), ref_sd[name].numpy(),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=name)


def test_log_kernels_match_jax():
    for sigma, n in [(1.0, 5), (1.4, 7)]:
        np.testing.assert_array_equal(legacy_v0.log_kernel_discrete(sigma, n),
                                      jax_v0.log_kernel_discrete(sigma, n))


# -- crops, labels, registration ---------------------------------------------


@pytest.mark.parametrize('crop', [(12, 8), (20, 9), (12, 40)])
def test_crop_on_point_matches_jax(rng, crop):
    """Point-centred crops bit for bit, points at both edges, off the
    frame (the window start clamped into the padded frame, as JAX's
    dynamic_slice clamps it; left of the pad, a negative start, counted
    from the end as dynamic_slice counts it), at x.99999994 (the float32 sum x + pad
    rounds up) and inside; a crop wider than the frame."""
    b, h, w = 8, 20, 30
    images = rng.random((b, h, w, 3)).astype(np.float32)
    labels = rng.random((b, h, w, 1)).astype(np.float32)
    x = np.array([0, w - 1, w + 7, -3, 3.99999994, 12.5, 17, 0.4],
                 np.float32)
    points = np.stack([x, rng.random(b) * h, rng.random(b) * 50], 1).astype(
        np.float32)
    ref = jax_v0.crop_image_to_shape_on_point(
        jnp.asarray(points), jnp.asarray(images), jnp.asarray(labels), *crop,
        label_fill=2.0)
    got = legacy_v0.crop_image_to_shape_on_point(
        torch.from_numpy(points), torch.from_numpy(images),
        torch.from_numpy(labels), *crop, label_fill=2.0)
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_three_class_labels_match_jax(rng):
    gt = rng.uniform(8, 12, (2, 9, 11, 1)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = 0
    gt[0, 0, 0, 0] = 10.4  # |gt - z| == tau is no match
    z = np.array([10.0, 9.5], np.float32).reshape(2, 1, 1, 1)
    ref = jax_v0.three_class_labels(jnp.asarray(gt), jnp.asarray(z))
    got = legacy_v0.three_class_labels(torch.from_numpy(gt),
                                       torch.from_numpy(z))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _registration_case(rng, n_lidar=3000, n_radar=300):
    lx = np.round(rng.uniform(0, 160, n_lidar)).astype(np.float32)
    lz = rng.uniform(1, 70, n_lidar).astype(np.float32)
    rx = rng.uniform(0, 160, n_radar).astype(np.float32)
    rz = rng.uniform(1, 70, n_radar).astype(np.float32)
    # radar points on lidar points, and at distance 0.4 in x (the radius
    # decision in float32)
    rx[:40], rz[:40] = lx[:40], lz[:40]
    rx[40:60], rz[40:60] = lx[40:60] + np.float32(0.4), lz[40:60]
    rx[60:70], rz[60:70] = lx[60:70] - np.float32(0.39999998), lz[60:70]
    return lx, lz, rx, rz


def test_registration_matches_jax(rng):
    """register_points (the nearest within the radius, argmin) and
    register_points_radius (all within it) bit for bit, in chunks of radar
    rows (the chunk set below the count); then reorganize_points."""
    lx, lz, rx, rz = _registration_case(rng)
    idx, dist = legacy_v0.register_points(lx, lz, rx, rz)
    idx_ref, dist_ref = jax_v0.register_points(lx, lz, rx, rz)
    np.testing.assert_array_equal(idx, np.asarray(idx_ref))
    np.testing.assert_array_equal(dist, np.asarray(dist_ref))
    chunk = legacy_v0.REGISTRATION_CHUNK
    try:
        legacy_v0.REGISTRATION_CHUNK = 64
        got = legacy_v0.register_points_radius(lx, lz, rx, rz)
    finally:
        legacy_v0.REGISTRATION_CHUNK = chunk
    ref = jax_v0.register_points_radius(lx, lz, rx, rz)
    assert len(got) == len(ref) == len(rx)
    assert sum(len(r) > 0 for r in ref) >= 70
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a, r)
    radar = np.stack([rx, rng.uniform(0, 90, len(rx)).astype(np.float32),
                      rz])
    lidar = np.stack([lx, rng.uniform(0, 90, len(lx)).astype(np.float32)])
    for num_points in (1, 4):
        got = legacy_v0.reorganize_points(radar, lidar, got, num_points)
        ref_r = jax_v0.reorganize_points(radar, lidar, ref, num_points)
        for a, r in zip(got, ref_r):
            assert a.dtype == r.dtype
            np.testing.assert_array_equal(a, r)
        got = legacy_v0.register_points_radius(lx, lz, rx, rz)
    for n, final in ((0, 3), (2, 5), (7, 4)):
        np.testing.assert_array_equal(
            legacy_v0.check_for_length_and_copy(np.arange(n), final),
            jax_v0.check_for_length_and_copy(np.arange(n), final))


# -- checkpoints ---------------------------------------------------------------


def test_port_checkpoints_restore_in_jax(nets, tmp_path):
    """The port's v0 .pth and .npz, restored by JAX's restore_model: every
    array equal, the train step kept; the .pth has the v0 keys with an
    empty optimizer state."""
    port, params, state = nets[PATCHES[0]]
    jax_net = jax_main.build_model(PATCHES[0])
    template = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0))
    for ext in ('pth', 'npz'):
        path = str(tmp_path / 'model-7.{}'.format(ext))
        legacy_main.save_model(port, path, 7)
        p, s, step = jax_main.restore_model(jax_net, path, *template)
        assert step == 7
        for got, ref in ((p, params), (s, state)):
            flat_got = jax_ckpt.flatten_tree(got)
            flat_ref = jax_ckpt.flatten_tree(ref)
            assert sorted(flat_got) == sorted(flat_ref)
            for k in flat_ref:
                np.testing.assert_array_equal(
                    np.asarray(flat_got[k]).reshape(np.shape(flat_ref[k])),
                    np.asarray(flat_ref[k]), err_msg=k)
    raw = torch.load(str(tmp_path / 'model-7.pth'), weights_only=True)
    assert set(raw) == {'train_step', 'optimizer_state_dict',
                        'model_state_dict'}
    assert raw['optimizer_state_dict'] == {}


def test_jax_checkpoints_restore_in_port(nets, tmp_path):
    """JAX's save_model, .pth and its .npz fallback, restored by the
    port's restore_model with strict=True: the same state_dict."""
    port, params, state = nets[PATCHES[1]]
    jax_net = jax_main.build_model(PATCHES[1])
    for ext in ('pth', 'npz'):
        path = str(tmp_path / 'model-3.{}'.format(ext))
        if ext == 'pth':
            jax_main.save_model(jax_net, path, params, state, 3)
        else:
            sd = jax_ckpt.tree_to_torch_state_dict(params, state)
            np.savez(path, **{'model_state_dict/' + k: np.asarray(v)
                              for k, v in sd.items()}, train_step=3)
        model = legacy_main.build_model(PATCHES[1])
        assert legacy_main.restore_model(model, path, device='cpu') == 3
        ref = port.state_dict()
        for k, v in model.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), ref[k].numpy(),
                                          err_msg=k)


# -- the train step ------------------------------------------------------------


def _frames(rng, b, dtype=np.float32):
    """b training samples as the loader stacks them: uint8 frames, one
    point each (points at the frame's edges among them), the raw 16-bit
    ground truth near the points' depths where it has depth."""
    h, w = FRAME
    image = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    x = np.array([0.0, w - 1.0, 40.25, 7.5, 80.0, 55.5])[:b]
    point = np.stack([x, rng.random(b) * h, rng.random(b) * 40 + 10],
                     1).astype(np.float32)
    gt = point[:, 2, None, None, None] + rng.uniform(-0.8, 0.8,
                                                     (b, h, w, 1))
    gt[rng.random(gt.shape) < 0.4] = 0.0
    gt_u16 = np.floor(gt * 256).astype(np.uint16)
    return image, point, gt_u16


@pytest.mark.parametrize('invalid_to_negative', [False, True])
def test_train_step_matches_jax_float64(nets, rng, monkeypatch,
                                        invalid_to_negative):
    """One train step at the 64x60 patch in float64 on both sides (JAX's
    own _make_train_step, its Adam swapped for a function that hands back
    the gradients), with JAX's draws fed to the port (brightness and
    horizontal flips at p 0.8: the label crops flip with the images),
    points at the frame's edges, the smoothness term on at 11x3: the three
    losses rtol 1e-10, every gradient within 1e-8 of its max-abs (those of
    the radar branch's linear biases, 0 before a training batch norm, both
    below 1e-12 of the largest), the running statistics rtol 1e-9; then the port's Adam (weight decay
    1e-4) on those gradients."""
    patch = PATCHES[1]
    port32, params, state = nets[patch]
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x, np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x), t)
    params, state = cast(params), cast(state)
    dynamic_slice = jax.lax.dynamic_slice
    monkeypatch.setattr(jax.lax, 'dynamic_slice', lambda x, idx, size: (
        dynamic_slice(x, [jnp.asarray(i, jnp.int32) for i in idx], size)))
    monkeypatch.setattr(jax_main, 'adam_step',
                        lambda p, grads, opt, lr, weight_decay: (grads, opt))
    kw = dict(normalized_image_range=[0, 1], random_brightness=[0.8, 1.2],
              random_flip_type=['horizontal'])
    step_kw = dict(epsilon=0.4, set_invalid_to_negative=invalid_to_negative,
                   w_cross_entropy=1.0, w_smoothness=1e-2,
                   w_positive_class=2.0, kernel_size_smoothness=(11, 3))
    key = jax.random.PRNGKey(5)
    image, point, gt_u16 = _frames(rng, 4)
    batch = (image.astype(np.float64), point.astype(np.float64),
             transport.decode_np(gt_u16).astype(np.float64))
    jax.config.update('jax_enable_x64', True)
    try:
        step = jax.jit(jax_main._make_train_step(
            jax_main.build_model(patch), JaxTransforms(**kw), patch,
            w_weight_decay=0.0, **step_kw))
        jp, js = (jax.tree_util.tree_map(jnp.asarray, t)
                  for t in (params, state))
        grads, new_state, _, info = step(
            jp, js, None, tuple(jnp.asarray(a) for a in batch), key, 1e-3,
            0.8)
        grads = jax_ckpt.tree_to_torch_state_dict(jax.device_get(grads))
        ref_state = state_dict_from_jax(params, jax.device_get(new_state))
        info = {k: float(v) for k, v in info.items()}
        # JAX's draws under x64, as its step took them
        transforms = Transforms(**kw)
        draws = jax_draws(key, transforms, 4, 0.8)
    finally:
        jax.config.update('jax_enable_x64', False)
    assert bool(draws['horizontal_flip'].any())

    model = legacy_main.build_model(patch)
    model.load_state_dict(port32.state_dict())
    model = model.double().train()
    port = legacy_main.TrainStep(
        model, transforms, legacy_main.make_optimizer(model, 1e-3, 1e-4),
        patch, **step_kw)
    info_port = port.backward(tuple(torch.from_numpy(a) for a in batch),
                              draws)
    assert sorted(info_port) == sorted(info)
    for k in info:
        np.testing.assert_allclose(float(info_port[k]), info[k], rtol=1e-10,
                                   err_msg=k)
    assert info['loss_smoothness'] > 0
    # a bias before a training batch norm has a gradient of 0 in exact
    # arithmetic: both sides' are rounding noise below 1e-12 of the largest
    vanish = 1e-12 * max(np.abs(g).max() for g in grads.values())
    checked = []
    for name, p in model.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
        ref = grads[name]
        if np.abs(ref).max() < vanish:
            assert np.abs(g).max() < vanish, name
            continue
        assert np.abs(g - ref).max() <= 1e-8 * np.abs(ref).max(), name
        checked.append(name)
    assert len(checked) > 50
    for name, buf in model.named_buffers():
        if name.endswith('num_batches_tracked'):
            assert int(buf) == int(ref_state[name]) == 1, name
        else:
            np.testing.assert_allclose(buf.numpy(), ref_state[name].numpy(),
                                       rtol=1e-9, err_msg=name)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    port.optimizer.step()
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert set(checked) <= set(moved)


# -- inference -------------------------------------------------------------------


def _scene(rng, k=7, n_invalid=2):
    h, w = FRAME
    image = rng.integers(0, 256, (1, h, w, 3)).astype(np.uint8)
    x = np.concatenate([[0.0, w - 1.0], rng.uniform(0, w, k - 2)])
    points = np.stack([x, rng.uniform(0, h, k), rng.uniform(3, 60, k)],
                      1).astype(np.float32)
    valid = np.arange(k) < k - n_invalid
    return image, points, valid


@pytest.mark.parametrize('patch', PATCHES, ids=['64x32', '64x60'])
def test_make_forward_fn_matches_jax(nets, rng, patch):
    """Scatter inference over a 64x96 frame, 7 points (2 padding, 2 at
    the frame's edges): the response maps within 1e-5, the depth maps
    equal except at pixels where a response lies within 1e-5 of the 0.5
    threshold or two responses tie within 1e-5."""
    port, params, state = nets[patch]
    image, points, valid = _scene(rng)
    transforms = Transforms(normalized_image_range=[0, 1])
    forward = legacy_main.make_forward_fn(port, transforms, *FRAME, patch)
    with scattered_crops() as caught:
        depth, response = (t.numpy() for t in forward(
            torch.from_numpy(image), torch.from_numpy(points),
            torch.from_numpy(valid)))
    (crops,) = (c.numpy() for c in caught)
    jax_forward = jax_main.make_forward_fn(
        jax_main.build_model(patch),
        JaxTransforms(normalized_image_range=[0, 1]), *FRAME, patch)
    depth_ref, response_ref = (np.asarray(a) for a in jax_forward(
        params, state, jnp.asarray(image, jnp.float32), jnp.asarray(points),
        jnp.asarray(valid)))
    assert (response_ref > 0).sum() > 100
    np.testing.assert_allclose(response, response_ref, rtol=0,
                               atol=RESPONSE_TOL)
    assert not unexplained_depth(depth, depth_ref, crops, points, valid,
                                 patch, RESPONSE_TOL)
    assert set(np.unique(depth)) <= set(np.trunc(points[valid, 2])) | {0.0}


def _write_maps(root, rng, n=3):
    out_paths, gt_paths = [], []
    for i in range(n):
        out = np.where(rng.random(FRAME) < 0.3, rng.uniform(1, 80, FRAME),
                       0).astype(np.float32)
        gt = np.where(rng.random(FRAME) < 0.5, rng.uniform(0.5, 120, FRAME),
                      0).astype(np.float32)
        if i == n - 1:
            out[:] = 0  # a frame without output: NaN metrics, skipped
        for tag, arr, paths in (('out', out, out_paths),
                                ('gt', gt, gt_paths)):
            path = os.path.join(root, '{}_{}.png'.format(tag, i))
            io.save_depth(arr, path)
            paths.append(path)
    manifests = []
    for tag, paths in (('out', out_paths), ('gt', gt_paths)):
        manifests.append(os.path.join(root, tag + '.pkl'))
        legacy_datasets.save_pickle_paths(manifests[-1], paths)
    return manifests


def test_eval_stage_1_matches_jax(rng, tmp_path):
    """eval_stage_1 on the same PNGs and pickled manifests: equal metrics
    (a frame without output skipped by both); the files' numpy recount."""
    manifests = _write_maps(str(tmp_path), rng)
    for lo, hi in ((0.0, 100.0), (5.0, 60.0)):
        got = legacy_main.eval_stage_1(*manifests, min_evaluate_depth=lo,
                                       max_evaluate_depth=hi)
        ref = jax_main.eval_stage_1(*manifests, min_evaluate_depth=lo,
                                    max_evaluate_depth=hi)
        assert got == ref
    out = io.load_depth(str(tmp_path / 'out_0.png'))
    gt = io.load_depth(str(tmp_path / 'gt_0.png'))
    mask = (out > 0) & (gt > 0) & (gt < 100)
    mae0 = np.mean(np.abs(1000 * gt[mask] - 1000 * out[mask]))
    assert np.isfinite(got['mae']) and mae0 > 0


# -- datasets and manifests ------------------------------------------------------


def _legacy_files(root, rng, n=3, n_points=5):
    """Frames, ground truth and radar files as the v0 datasets read them:
    the images in one directory named by the ground truth's basename."""
    from rcfd_tpu_torch import native
    h, w = FRAME
    for d in ('images', 'gt', 'radar'):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    gt_paths, radar_paths = [], []
    for i in range(n):
        name = 'sample_{:03d}'.format(i)
        native.write_rgb(os.path.join(root, 'images', name + '.png'),
                         rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        gt = np.where(rng.random(FRAME) < 0.3, rng.uniform(1, 60, FRAME),
                      0).astype(np.float32)
        gt_paths.append(os.path.join(root, 'gt', name + '.png'))
        io.save_depth(gt, gt_paths[-1])
        radar = np.stack([rng.integers(0, w, n_points),
                          rng.integers(0, h, n_points),
                          rng.uniform(1, 60, n_points)], 1).astype(np.float32)
        radar_paths.append(os.path.join(root, 'radar', name + '.npy'))
        np.save(radar_paths[-1], radar)
    return gt_paths, radar_paths, os.path.join(root, 'images')


def test_datasets_match_jax(rng, tmp_path):
    """The three v0 datasets: the port's integer transport decodes to
    JAX's float32 samples exactly; the training point is the same draw of
    the same Generator; the stage-1 name is the ground truth's basename."""
    gt_paths, radar_paths, image_dir = _legacy_files(str(tmp_path), rng)
    train = legacy_datasets.BinaryClassificationDataset(
        gt_paths, radar_paths, image_dir, device='cpu')
    train_ref = jax_datasets.BinaryClassificationDataset(
        gt_paths, radar_paths, image_dir)
    for i in range(3):
        got = transport.decode_np(train.get(i, np.random.default_rng(i)))
        ref = train_ref.get(i, np.random.default_rng(i))
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    stage1 = legacy_datasets.SaveStage1OutputDataset(
        gt_paths, radar_paths, image_dir, max_points=8, device='cpu')
    stage1_ref = jax_datasets.SaveStage1OutputDataset(
        gt_paths, radar_paths, image_dir, max_points=8)
    got, ref = stage1.get(1), stage1_ref.get(1)
    assert got[4] == ref[4] == 'sample_001'
    for a, b in zip(transport.decode_np(got[:4]), ref[:4]):
        np.testing.assert_array_equal(a, b)


class DataStruct(NamedTuple):
    scene_id: int
    sample_idx: int
    image_path: str
    radar_points_path: str
    ground_truth_label_path: str
    ground_truth_depth_path: str


def _manifests(tmp_path):
    pts = [np.arange(6, dtype=np.float32).reshape(2, 3) + i
           for i in range(2)]
    return {
        'named': {i: DataStruct(0, i, 'img_{}.jpg'.format(i),
                                'radar_{}.npy'.format(i),
                                'label_{}.png'.format(i),
                                'depth_{}.png'.format(i)) for i in range(3)},
        'one_element_lists': {
            (0, i): [(0, i, 'img_{}.jpg'.format(i), 'radar_{}.npy'.format(i),
                      'label_{}.png'.format(i), 'depth_{}.png'.format(i))]
            for i in range(3)},
        'val_arrays': {
            (0, i): [(0, i, 'img_{}.jpg'.format(i), np.zeros((4, 2)), pts[i],
                      'label_{}.png'.format(i), 'depth_{}.png'.format(i))]
            for i in range(2)},
        'reference_order': [
            (0, i, 'img_{}.jpg'.format(i), np.zeros((2, 3)),
             'radar_{}.npy'.format(i), 'label_{}.png'.format(i),
             'depth_{}.png'.format(i)) for i in range(2)],
    }


@pytest.mark.parametrize('case', ['named', 'one_element_lists', 'val_arrays',
                                  'reference_order'])
def test_unpack_data_struct_manifest_matches_jax(tmp_path, case):
    """unpack_data_struct_manifest on the same pickles: the same label and
    radar path lists, the same materialized arrays (distinct prefixes in
    one directory); arrays without a directory raise in both."""
    path = str(tmp_path / 'm.pkl')
    with open(path, 'wb') as f:
        pickle.dump(_manifests(tmp_path)[case], f)
    out = {}
    for side, fn in (('port', save_depth_radar.unpack_data_struct_manifest),
                     ('jax', jax_save_depth_radar
                      .unpack_data_struct_manifest)):
        d = tmp_path / side
        d.mkdir()
        out[side] = fn(path, materialize_dirpath=str(d),
                       materialize_prefix='train_')
    gt, radar = out['port']
    assert gt == out['jax'][0]
    for a, b in zip(radar, out['jax'][1]):
        if case == 'val_arrays':
            assert os.path.basename(a) == os.path.basename(b)
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            assert a == b
    if case == 'val_arrays':
        for fn in (save_depth_radar.unpack_data_struct_manifest,
                   jax_save_depth_radar.unpack_data_struct_manifest):
            with pytest.raises(ValueError):
                fn(path)
