"""RadarNet's point MLP (rcfd_tpu_torch.models.networks.FullyConnectedEncoder)
runs its products over fixed row tiles (MLP_TILE_ROWS), so that a point's
features do not depend on the batch's row count. On the CPU: that, the
encoder against the JAX package's, and its gradient against one product a
layer (the card's half is tests/test_torch_cuda.py::
test_point_mlp_features_do_not_depend_on_the_row_count_on_card)."""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.models.networks import \
    FullyConnectedEncoder as JaxEncoder  # noqa: E402

from rcfd_tpu_torch.models.networks import (  # noqa: E402
    MLP_TILE_ROWS, FullyConnectedEncoder)
from rcfd_tpu_torch.nn import init_parameters  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

from torch_parity import jax_variables  # noqa: E402

# tests/test_torch_nn.py's float32 layer tolerance
ATOL = RTOL = 1e-5


def _points(rng, n):
    return torch.from_numpy(np.stack([
        rng.uniform(0, 1888, n), rng.uniform(0, 900, n),
        rng.uniform(1, 80, n)], 1).astype(np.float32))


def test_features_do_not_depend_on_the_row_count(rng):
    """At the canonical widths (3 -> ... -> 128 x 28 x 9), 240 points at the
    head of 256, 512 and 1000 rows (the last padded to 1024 inside) give
    the same features bit for bit, and so do 240 points at rows 256-495
    of 1000 (a later tile); 0 rows give 0 features."""
    encoder = FullyConnectedEncoder(3, [32, 64, 128, 128, 128],
                                    128 * 28 * 9).eval()
    init_parameters(encoder, torch.Generator().manual_seed(0))
    points = _points(rng, 240)
    with torch.inference_mode():
        features = [encoder(torch.cat([points, torch.zeros(rows - 240, 3)]))
                    [:240] for rows in (256, 512, 1000)]
        shifted = torch.zeros(1000, 3)
        shifted[MLP_TILE_ROWS:MLP_TILE_ROWS + 240] = points
        features.append(encoder(shifted)[MLP_TILE_ROWS:MLP_TILE_ROWS + 240])
        assert encoder(torch.zeros(0, 3)).shape == (0, 128 * 28 * 9)
    for f in features[1:]:
        assert torch.equal(f, features[0])


@pytest.mark.parametrize('rows', [5, MLP_TILE_ROWS + 44])
def test_encoder_matches_jax(rows, rng):
    """The port's tiled encoder against the JAX package's one product a
    layer, in one tile and across two, at tests/test_torch_nn.py's float32
    tolerance."""
    jm = JaxEncoder(3, [8, 12, 16, 16, 16], 16 * 3 * 2)
    p, s = jax_variables(jm, 5, rng)
    tm = FullyConnectedEncoder(3, [8, 12, 16, 16, 16], 16 * 3 * 2)
    tm.load_state_dict(state_dict_from_jax(p, s), strict=True)
    x = rng.standard_normal((rows, 3)).astype(np.float32)
    ref, _ = jm(p, s, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_gradient_equals_one_product_a_layer(rng):
    """In float64 the tiled encoder's output and the gradients of its
    weights and inputs equal those of one product a layer over all 300
    rows (the padding rows add exact zeros), to 1e-12 of each's
    max-abs."""
    encoder = FullyConnectedEncoder(3, [8, 12, 16, 16, 16],
                                    16 * 3 * 2).double()
    init_parameters(encoder, torch.Generator().manual_seed(1))
    x = _points(rng, 300).double()
    out = []
    for forward in (encoder.forward, encoder.mlp):
        encoder.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        y = forward(xi)
        (y * torch.linspace(-1, 1, y.shape[1], dtype=y.dtype)).sum() \
            .backward()
        out.append([y.detach(), xi.grad] +
                   [p.grad for p in encoder.parameters()])
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
