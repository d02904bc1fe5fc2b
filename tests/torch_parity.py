"""Shared helpers of the rcfd_tpu_torch parity tests: tiny model
configurations, batch-norm statistics drawn from a seed (so that batch
norm is not the identity), and the NHWC <-> NCHW hand-over between the JAX
package and the port. Inputs are made with numpy and passed to both."""

import numpy as np
import torch

# SKILL.md's tiny RadarNet, and a FusionNet of the benchmark's shape with
# narrow widths
RADARNET_TINY = dict(
    input_channels_image=3, input_channels_depth=3,
    input_patch_size_image=(32, 32), encoder_type='radarnetv1-batch_norm',
    n_filters_encoder_image=[4, 8, 8, 8, 8],
    n_neurons_encoder_depth=[4, 8, 8, 8, 8],
    decoder_type='multiscale-batch_norm', n_filters_decoder=[8, 8, 8, 8, 8])
# the JAX package's gates of the fused skip path on the CPU: the XLA gather
# (fused_pool2_pallas off) and the split-conv decoder that consumes lazy
# skips (fast_decoder on)
RADARNET_FUSED_JAX_PERF = dict(fused_pool2=True, fused_pool4=True,
                               fused_pool2_pallas=False, fast_decoder=True)
# a patch width that is not a multiple of 32, so the 1/16 and 1/32 pools take
# the variable-bin branch; the JAX package serves it by XLA off the TPU
RADARNET_WIDE = dict(RADARNET_TINY, input_patch_size_image=(64, 40))
RADARNET_WIDE_JAX_PERF = dict(pallas_crop=False)
FUSIONNET_TINY = dict(
    input_channels_image=3, input_channels_depth=2,
    encoder_type='fusionnet18_batch_norm',
    n_filters_encoder_image=[4, 8, 8, 8, 8, 8],
    n_filters_encoder_depth=[4, 4, 8, 8, 8, 8],
    fusion_type='weight_and_project', decoder_type='multiscale_batch_norm',
    n_resolution_decoder=1, n_filters_decoder=[8, 8, 8, 8, 8, 8],
    min_predict_depth=1.0, max_predict_depth=100.0)
H, W = 64, 96


def randomize_batch_norm(params, state, rng):
    """Draw every batch norm's weight, bias, running mean and variance from
    ``rng`` (numpy trees, modified copies)."""
    def walk(p, s):
        p, s = dict(p), dict(s)
        for k in p:
            if k == 'batch_norm':
                n = p[k]['weight'].shape[0]
                p[k] = {'weight': rng.uniform(0.5, 1.5, n).astype(np.float32),
                        'bias': rng.normal(0, 0.1, n).astype(np.float32)}
                s[k] = dict(s[k],
                            running_mean=rng.normal(0, 0.1, n).astype(
                                np.float32),
                            running_var=rng.uniform(0.5, 1.5, n).astype(
                                np.float32))
            elif isinstance(p[k], dict):
                p[k], s[k] = walk(p[k], s.get(k, {}))
        return p, s
    return walk(params, state)


def jax_variables(module, seed, rng):
    """``module.init(PRNGKey(seed))`` as numpy trees, batch norm drawn
    from ``rng``."""
    import jax
    params, state = jax.device_get(module.init(jax.random.PRNGKey(seed)))
    return randomize_batch_norm(params, state, rng)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def frame_and_points(rng, k=8, n_invalid=2, h=H, w=W):
    image = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    points = np.stack([rng.integers(0, w, k), rng.integers(0, h, k),
                       rng.random(k) * 60 + 1], 1).astype(np.float32)
    valid = np.ones(k, bool)
    valid[k - n_invalid:] = False
    return image, points, valid


def scatter_case(name, rng):
    """(crops, x in padded coordinates, z, valid, h, w, patch) for one
    named case of the scatter tests."""
    h, w, ph, pw = 40, 64, 24, 16
    pad = pw // 2
    k = 8
    crops = rng.random((k, ph, pw), dtype=np.float32)
    x = rng.integers(0, w, k).astype(np.float32)
    z = (rng.random(k, dtype=np.float32) * 70 + 1).astype(np.float32)
    valid = np.ones(k, bool)
    if name == 'padding':
        valid[[1, 4, 7]] = False
    elif name == 'ties':
        # same 2^-14 step in overlapping windows, values of exactly 0.5,
        # and integer depths equal to later indices (rewrite cascade)
        x[1] = x[0]
        x[2] = x[0] + 3
        crops[1] = np.nextafter(crops[0], np.float32(1))
        crops[2, :5] = 0.5
        crops[3, 5:9] = np.float32(0.5) - np.float32(1e-7)
        z[0], z[1], z[3], z[5] = 3.0, 5.5, 5.0, 2.0
    elif name == 'edges':
        # x at the first and last column, and beyond both (clipped)
        x[0], x[1], x[2], x[3] = 0, w - 1, -30, w + 100
    elif name == 'full_height':
        h = ph
    return crops, x + pad, z, valid, h, w, (ph, pw)


SCATTER_CASES = ['random', 'padding', 'ties', 'edges', 'full_height']
