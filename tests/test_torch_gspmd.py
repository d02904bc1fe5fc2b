"""The port's 2-D (data x spatial) mesh (rcfd_tpu_torch.parallel.gspmd) on
gloo ranks on the CPU: FusionNet's train step, the batch over 'data' and
the rows over 'spatial', against the single-device step on the whole
batch: JAX's own (rcfd_tpu.fusionnet_main._make_train_step with
axis_name=None, the step tests/test_gspmd.py runs under GSPMD) and the
port's single-process TrainStep. The narrow FusionNet of tests/test_gspmd.py
at b = 4 and 64 x 64; every case runs in one spawn of 8 ranks
(torch_gspmd.mesh_cases), one torch thread a rank, while this process
computes the references. Each test states its tolerance."""

import concurrent.futures
import functools

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import fusionnet_main as jax_main  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.parallel.optim import init_adam  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import parallel  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel  # noqa: E402
from rcfd_tpu_torch.nn import init_parameters  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

import torch_gspmd  # noqa: E402
from torch_parity import randomize_batch_norm  # noqa: E402

# tests/test_gspmd.py's model
CONFIG = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[8, 12, 16, 16, 16],
    n_filters_encoder_depth=[4, 6, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[16, 12, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
# outlier removal 7 / 1.5, ground truth dilated by 3, lidar loss 2.0
STEP = dict(loss_func='l1', w_lidar_loss=2.0, outlier_kernel_size=7,
            outlier_threshold=1.5, dilation_kernel_size=3)
AUGMENT = dict(normalized_image_range=[0, 1], random_brightness=[0.8, 1.2],
               random_contrast=[0.8, 1.2], random_saturation=[0.8, 1.2],
               random_flip_type=['horizontal', 'vertical'])
# float64 against the single-device step: the sums run in another order
LOSS_RTOL, GRAD_TOL, STATS_RTOL = 1e-10, 1e-8, 1e-10
JAX_MESHES = ((2, 4), (1, 2), (2, 2))


def _weights(seed, config=CONFIG):
    """numpy (params, state) trees of ``config``, drawn by the port's
    init_parameters (JAX's init compiles a draw a shape) through the JAX
    package's state_dict reader, batch norm drawn from ``seed``."""
    model = FusionNetModel(**config, device='cpu', trainable=True)
    init_parameters(model, torch.Generator().manual_seed(seed))
    params, state = jax_ckpt.torch_state_dict_to_tree(model.state_dict())
    return randomize_batch_norm(params, state,
                                np.random.default_rng(seed))


def _state_dict(params, state, dtype):
    return {k: v.numpy().astype(dtype) if v.is_floating_point()
            else v.numpy() for k, v in state_dict_from_jax(
                params, state).items()}


def _batch(seed, n=4, h=64, w=64, dtype=np.float64):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (n, h, w, 3)).astype(np.float64)
    depth = rng.random((n, h, w, 1)) * 60
    depth[depth < 30] = 0.0
    response = rng.random((n, h, w, 1))
    gt = rng.random((n, h, w, 1)) * 70 + 1
    gt[rng.random((n, h, w, 1)) < 0.6] = 0.0
    lidar = rng.random((n, h, w, 1)) * 70 + 1
    lidar[rng.random((n, h, w, 1)) < 0.9] = 0.0
    return tuple(a.astype(dtype) for a in (image, depth, response, gt,
                                           lidar))


def _draws(transforms, n, seed):
    return {k: v.numpy() for k, v in Transforms(**transforms).draws(
        torch.Generator().manual_seed(seed), n, 1.0).items()}


def _case(mesh, params, state, dtype, batch, adam=False, config=CONFIG,
          transforms=None, draws=None, train_dtype='', **step):
    transforms = transforms or dict(normalized_image_range=[0, 1])
    return dict(mesh=mesh, config=config,
                state_dict=_state_dict(params, state, dtype), dtype=dtype,
                transforms=transforms, step=dict(STEP, **step),
                train_dtype=train_dtype, batch=batch, draws=draws or {},
                lr=1e-3, adam=adam)


def _jax_step(params, state, batch, adam, dtype, smoothness_kernel):
    """JAX's single-device step (its Adam, or with ``adam`` False an Adam
    that hands back the gradients) on the batch, augmentation off: (params
    or gradients, state) as port state_dicts, and loss_info."""
    tree = functools.partial(jax.tree_util.tree_map,
                             lambda x: jnp.asarray(x, dtype)
                             if np.issubdtype(np.asarray(x).dtype,
                                              np.floating)
                             else jnp.asarray(x))
    params, state = tree(params), tree(state)
    with pytest.MonkeyPatch.context() as mp:
        if not adam:
            mp.setattr(jax_main, 'adam_step',
                       lambda p, grads, opt, lr, weight_decay: (grads, opt))
        step = jax.jit(jax_main._make_train_step(
            JaxFusionNet(**CONFIG), JaxTransforms(normalized_image_range=[
                0, 1]), w_smoothness=0.1,
            loss_smoothness_kernel_size=smoothness_kernel,
            w_weight_decay=0.0, axis_name=None, **STEP))
        out, new_state, _, info = step(
            params, state, init_adam(params) if adam else None,
            tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(3),
            1e-3, 0.0)
    out, new_state, info = jax.device_get((out, new_state, info))
    return (jax_ckpt.tree_to_torch_state_dict(out),
            {k: v.numpy() for k, v in state_dict_from_jax(
                out, new_state).items() if 'running' in k or
             'num_batches' in k}, {k: float(v) for k, v in info.items()})


def _port_reference(case):
    """The port's single-process TrainStep on the case's whole batch:
    ``torch_gspmd.results``."""
    model = torch_gspmd.port_model(case)
    step = torch_gspmd.port_step(model, case)
    batch = tuple(torch.from_numpy(a) for a in case['batch'])
    draws = {k: torch.from_numpy(v) for k, v in case['draws'].items()}
    if case['adam']:
        info = step(batch, draws, case['lr'])
    else:
        info = step.backward(batch, draws)
    return torch_gspmd.results(model, info)


@pytest.fixture(scope='module')
def runs():
    """The cases on 8 gloo ranks (in a thread) and their references (here,
    meanwhile): {name: (the mesh's rank results, the reference)}, and the
    refusals' messages."""
    params, state = _weights(0)
    batch = _batch(1)
    cases, refs = {}, {}
    for mesh in JAX_MESHES:
        cases['jax {}x{}'.format(*mesh)] = _case(
            mesh, params, state, 'float64', batch, w_smoothness=0.1,
            loss_smoothness_kernel_size=7)
    # uneven rows (62 over 4: 16, 16, 15, 15), so the flips' mirror rows
    # come from other ranks than a shard's own mirror
    cases['augment'] = _case(
        (2, 4), params, state, 'float64', _batch(2, h=62),
        transforms=AUGMENT, draws=_draws(AUGMENT, 4, 5), w_smoothness=0.1,
        loss_smoothness_kernel_size=1)
    wide = dict(CONFIG, n_resolution_decoder=2, deconv_type='transpose')
    cases['transpose'] = _case(
        (1, 4), *_weights(3, wide), 'float64', _batch(4, n=2), config=wide,
        w_smoothness=0.1, loss_smoothness_kernel_size=1)
    batch32 = _batch(1, dtype=np.float32)
    cases['float32'] = _case((2, 2), params, state, 'float32', batch32,
                             adam=True, w_smoothness=0.1,
                             loss_smoothness_kernel_size=7)
    cases['bf16'] = _case((2, 2), params, state, 'float32', batch32,
                          train_dtype='bfloat16', w_smoothness=0.0,
                          loss_smoothness_kernel_size=-1)
    cases['bf16 float64'] = dict(cases['bf16'], dtype='float64',
                                 state_dict=_state_dict(params, state,
                                                        'float64'),
                                 batch=batch, train_dtype='')
    names = [k for k in cases if k != 'bf16 float64']
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.run_ranks, torch_gspmd.mesh_cases,
                            ([cases[k] for k in names],), 8, 'cpu')
        jax.config.update('jax_enable_x64', True)
        try:
            jax64 = _jax_step(params, state, batch, False, jnp.float64, 7)
        finally:
            jax.config.update('jax_enable_x64', False)
        for mesh in JAX_MESHES:
            refs['jax {}x{}'.format(*mesh)] = jax64
        refs['float32'] = _jax_step(params, state, batch32, True,
                                    jnp.float32, 7)
        for name in ('augment', 'transpose', 'bf16', 'bf16 float64'):
            refs[name] = _port_reference(cases[name])
        results = ranks.result()
    out = {}
    for i, name in enumerate(names):
        n_data, n_spatial = cases[name]['mesh']
        members = [results[r][0][i] for r in range(n_data * n_spatial)]
        assert all(results[r][0][i] is None
                   for r in range(n_data * n_spatial, 8))
        out[name] = (members, refs[name])
    out['bf16 float64'] = refs['bf16 float64']
    return out, [r[1] for r in results]


def _same_on_every_rank(members):
    """The mesh's ranks hold equal loss_info, gradients, parameters and
    buffers, bit for bit."""
    first = members[0]
    for other in members[1:]:
        assert other['info'] == first['info']
        for key in ('grads', 'params', 'buffers'):
            assert sorted(other[key]) == sorted(first[key])
            for n, v in first[key].items():
                assert np.array_equal(other[key][n], v), (key, n)


def _close_to_single_device(got, grads, buffers, info):
    """loss_info within LOSS_RTOL, every gradient within GRAD_TOL of its
    max-abs (a parameter without one on either side counts as 0), the
    running statistics within STATS_RTOL and every batch count 1."""
    for k, v in info.items():
        np.testing.assert_allclose(got['info'][k], v, rtol=LOSS_RTOL,
                                   err_msg=k)
    checked = 0
    for name, p in got['params'].items():
        g = got['grads'].get(name, np.zeros(p.shape))
        ref = np.asarray(grads.get(name, np.zeros(p.shape)))
        scale = max(np.abs(ref).max(), 1e-300)
        assert np.abs(g - ref).max() <= GRAD_TOL * scale, name
        checked += int(np.abs(ref).max() > 0)
    assert checked > 100
    for name, ref in buffers.items():
        if name.endswith('num_batches_tracked'):
            assert int(got['buffers'][name]) == int(ref) == 1, name
        else:
            np.testing.assert_allclose(got['buffers'][name], ref,
                                       rtol=STATS_RTOL, err_msg=name)


@pytest.mark.parametrize('mesh', JAX_MESHES,
                         ids=['{}x{}'.format(*m) for m in JAX_MESHES])
def test_mesh_step_matches_jax_single_device_float64(runs, mesh):
    """The mesh's step in float64 against JAX's single-device step (its
    Adam swapped for a function that hands back the gradients), outlier
    removal 7 / 1.5, dilation 3, the 7 x 7 sobel smoothness term at 0.1,
    the lidar term at 2.0: every rank holds the same gradients and
    statistics; loss_info rtol 1e-10, every gradient within 1e-8 of its
    max-abs, the running statistics rtol 1e-10. The 2 x 4 mesh's 1/32
    level has 2 rows over 4 shards: two own none."""
    members, (grads, buffers, info) = runs[0]['jax {}x{}'.format(*mesh)]
    _same_on_every_rank(members)
    _close_to_single_device(members[0], grads, buffers, info)
    if mesh == (2, 4):
        assert 2 in members[0]['exchanged']


def test_mesh_step_with_augmentation_matches_port_float64(runs):
    """2 x 4 mesh, 62 rows (shards of 16, 16, 15, 15), brightness,
    contrast, saturation, horizontal and vertical flips drawn at
    probability 1, the first-difference smoothness term: against the
    port's single-process TrainStep with the same draws, at the float64
    tolerances above."""
    members, ref = runs[0]['augment']
    _same_on_every_rank(members)
    _close_to_single_device(members[0], ref['grads'], ref['buffers'],
                            ref['info'])


def test_mesh_step_transpose_and_side_output_match_port_float64(runs):
    """1 x 4 mesh, deconv_type 'transpose' and n_resolution_decoder 2 (the
    side output's bilinear align-corners resize), b = 2: against the
    port's single-process TrainStep at the float64 tolerances above; the
    1/32 level's 2 rows leave two shards empty."""
    members, ref = runs[0]['transpose']
    _same_on_every_rank(members)
    _close_to_single_device(members[0], ref['grads'], ref['buffers'],
                            ref['info'])


def test_mesh_float32_step_matches_jax(runs):
    """2 x 2 mesh, float32, one step with Adam at 1e-3 against JAX's
    single-device step with its Adam, at tests/test_gspmd.py's tolerances:
    loss rtol 1e-5, parameters rtol 1e-3 / atol 2.5e-3, batch-norm state
    rtol 1e-4 / atol 1e-6."""
    members, (params, buffers, info) = runs[0]['float32']
    _same_on_every_rank(members)
    got = members[0]
    np.testing.assert_allclose(got['info']['loss'], info['loss'], rtol=1e-5)
    for name, v in params.items():
        np.testing.assert_allclose(got['params'][name], v, rtol=1e-3,
                                   atol=2.5e-3, err_msg=name)
    for name, v in buffers.items():
        np.testing.assert_allclose(got['buffers'][name], v, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_mesh_bf16_step(runs):
    """2 x 2 mesh under RCFD_TRAIN_DTYPE=bfloat16 (a bf16 network, the JAX
    bf16 batch-norm formula over global sums) against the port's
    single-process bf16 step on the same float32 weights and batch. bf16
    over this narrow net lies far from float64 (the gradients a median 0.37
    of their max-abs away on either side), so the mesh is held to the
    single-process bf16 step: loss_info within rtol 2^-7 of the float64
    step on both sides; every gradient within 0.15 of its max-abs of the
    single process's (0.081 measured); the running statistics (float32
    sums) within rtol 1e-4 of the single process's."""
    members, ref = runs[0]['bf16']
    exact = runs[0]['bf16 float64']
    _same_on_every_rank(members)
    got = members[0]
    for k in ('loss', 'loss_supervised', 'loss_lidar'):
        for side in (got, ref):
            np.testing.assert_allclose(side['info'][k], exact['info'][k],
                                       rtol=2 ** -7, err_msg=k)
    assert sorted(got['grads']) == sorted(ref['grads'])
    for name, g in ref['grads'].items():
        assert np.abs(got['grads'][name] - g).max() <= \
            0.15 * np.abs(g).max(), name
    for name, v in ref['buffers'].items():
        np.testing.assert_allclose(got['buffers'][name], v, rtol=1e-4,
                                   err_msg=name)


def test_mesh_refuses_a_group_of_another_size(runs):
    """get_mesh_2d(3, 2) on 8 ranks and get_mesh_2d(2, 2) over 3 ranks
    raise the JAX function's message on every rank."""
    for refused in runs[1]:
        assert refused == ['need 6 devices, have 8',
                           'need 4 devices, have 3']
