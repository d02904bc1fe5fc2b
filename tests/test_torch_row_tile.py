"""The launch geometry of the row-tile kernels of rcfd_tpu_torch (the bf16
fused skip gather-add, K3, and the column crop, K2, in bf16 and float32):
``row_tile`` in rcfd_tpu_torch/ops/fused_skip.py, which mirrors
csrc/row_tiles.cuh. Pure arithmetic on shapes, so it runs on the CPU; the
kernels themselves are held to their plain versions on the card
(tests/test_torch_cuda.py)."""

import math

import pytest

pytest.importorskip('torch')

from rcfd_tpu_torch.ops import crop_cuda  # noqa: E402
from rcfd_tpu_torch.ops.fused_skip import (SMEM_LIMIT, TILE_ROWS,  # noqa: E402
                                           row_tile)
from rcfd_tpu_torch.ops.roi_pool import variable_bin_window  # noqa: E402

# the serving shapes: 900x1600 frames, 64 points a frame
H, W, K = 900, 1600, 64


def _fused_skip_case(scale, channels, n=1):
    """(rows, staged width, window width, images) of K3 at a deferred pool
    of the 900x288 patch: cg is the map of the frame padded by 144 columns
    on each side, with a right apron of pw zero columns."""
    patch = 288
    pw = int(patch * scale)
    return channels * int(H * scale), (W + patch) * scale + pw, pw, n


def _column_crop_case(scale, n=1):
    """(rows, staged width, window width, images) of K2 at a variable-bin
    pool of the 900x300 patch: rows of 128 channels, w_f columns of the
    padded frame, each staged with win zero columns past w_f."""
    patch = 300
    w_f = math.ceil((W + patch) * scale)
    _, win = variable_bin_window(patch, scale, int(patch * scale))
    return 128 * int(H * scale), w_f + win, win, n


# a 900x300 training step of RadarNet: 6 frames of 4 windows (K2 only)
STEP_N, STEP_K = 6, 4

SERVING = {
    'K3 deconv1': _fused_skip_case(1 / 2, 32),
    'K3 deconv2': _fused_skip_case(1 / 4, 64),
    'K3 deconv1, batched B = 2': _fused_skip_case(1 / 2, 32, n=2),
    'K2 1/8': _column_crop_case(1 / 8),
    'K2 1/16': _column_crop_case(1 / 16),
    'K2 1/32': _column_crop_case(1 / 32),
    'K2 1/8, batched B = 2': _column_crop_case(1 / 8, n=2),
}


@pytest.mark.parametrize('case', sorted(SERVING))
def test_serving_shapes_fit_with_aligned_chunks(case):
    """At every serving shape the tile is TILE_ROWS rows, fits in a block's
    shared memory, covers every row once, and every window's chunk of every
    tile starts on a 16-byte boundary and holds whole 16-byte vectors."""
    rows, stride, width, n = SERVING[case]
    assert stride == int(stride)
    tile, smem, blocks = row_tile(rows, int(stride), n)
    assert tile == TILE_ROWS
    assert smem <= SMEM_LIMIT and smem >= 2 * tile * stride
    assert blocks == n * math.ceil(rows / tile)
    for k in (0, 1, K - 1, n * K - 1):
        for q0 in range(0, rows, tile):
            length = min(tile, rows - q0) * width
            assert (k * rows + q0) * width * 2 % 16 == 0, (k, q0)
            assert length * 2 % 16 == 0, (k, q0)


@pytest.mark.parametrize('stride, tile', [
    (1088, 8), (14_000, 8), (14_600, 4), (20_000, 4), (30_043, 2),
    (116_208, 1)])
def test_tile_halves_as_rows_widen(stride, tile):
    """Rows too wide for TILE_ROWS of them take 4, 2 or 1 a block; the
    bytes are the tile's, padded, and never above the limit."""
    got, smem, blocks = row_tile(21, stride, 3)
    assert got == tile
    assert smem == (-(-tile * stride // 8) * 8 + 16) * 2 <= SMEM_LIMIT
    assert blocks == 3 * math.ceil(21 / tile)


@pytest.mark.parametrize('stride', [116_209, 200_000])
def test_row_too_wide_for_shared_memory_raises(stride):
    with pytest.raises(ValueError, match='shared memory'):
        row_tile(8, stride, 1)


# K2 in float32 and bf16: the serving shapes (one frame, K windows) and the
# training step's (STEP_N frames of STEP_K windows), at the three
# variable-bin pools, with the rows a tile takes (crop_tile: 8, more where a
# row moves few bytes)
CROP = {'{} 1/{} {}'.format(use, int(1 / scale), elem): (
    _column_crop_case(scale, n=n), k, elem, tiles[elem])
    for use, n, k, tiles_by_scale in (
        ('serving', 1, K, {8: {4: 8, 2: 8}, 16: {4: 8, 2: 8},
                           32: {4: 8, 2: 16}}),
        ('step', STEP_N, STEP_K, {8: {4: 16, 2: 32}, 16: {4: 32, 2: 64},
                                  32: {4: 64, 2: 64}}))
    for scale, tiles in ((1 / 8, tiles_by_scale[8]),
                         (1 / 16, tiles_by_scale[16]),
                         (1 / 32, tiles_by_scale[32]))
    for elem in (4, 2)}


@pytest.mark.parametrize('case', sorted(CROP))
def test_crop_shapes_fit_with_aligned_chunks(case):
    """K2 stages rows of 4-byte (float32) or 2-byte (bf16) elements: at the
    serving and step shapes its tile is 8 rows, or up to 64 where a row
    moves few bytes (w + K * win elements within BLOCK_BYTES for the
    tile), fits in a block's shared memory, and every window's chunk of
    every tile starts on a 16-byte boundary and holds whole 16-byte vectors
    (the conditions of its vector path)."""
    (rows, stride, width, n), k, elem, want = CROP[case]
    w = stride - width
    tile, smem, blocks = got = crop_cuda.crop_tile(
        rows, w, width, n, k, elem)
    assert got == row_tile(rows, stride, n, elem,
                                      (w + k * width) * elem,
                                      crop_cuda.BLOCK_BYTES)
    assert tile == want
    assert elem * tile * stride <= smem <= SMEM_LIMIT
    assert blocks == n * math.ceil(rows / tile)
    vec = 16 // elem
    assert width >= vec and rows * width % vec == 0
    for p in (0, 1, n * k - 1):
        for q0 in range(0, rows, tile):
            length = min(tile, rows - q0) * width
            assert (p * rows + q0) * width * elem % 16 == 0, (p, q0)
            assert length * elem % 16 == 0, (p, q0)


@pytest.mark.parametrize('stride, tile', [
    (1088, 8), (7_000, 8), (7_300, 4), (14_600, 2), (30_043, 1),
    (58_096, 1)])
def test_float32_tile_halves_as_rows_widen(stride, tile):
    """float32 rows take half the width of bf16 ones before they halve the
    tile: TILE_ROWS rows, then 4, 2 or 1 a block; the bytes are the tile's,
    padded, 4 a element, and never above the limit (58,096 elements is the
    widest row that fits)."""
    got, smem, blocks = row_tile(21, stride, 3, 4)
    assert got == tile
    assert smem == (-(-tile * stride // 8) * 8 + 16) * 4 <= SMEM_LIMIT
    assert blocks == 3 * math.ceil(21 / tile)


@pytest.mark.parametrize('stride', [58_097, 116_208])
def test_float32_row_too_wide_for_shared_memory_raises(stride):
    """A float32 row that does not fit raises, also where a bf16 row of
    the same width fits (116,208)."""
    with pytest.raises(ValueError, match='shared memory'):
        row_tile(8, stride, 1, 4)


@pytest.mark.parametrize('stride', [1088, 14_600, 30_043, 116_208])
def test_bf16_geometry_is_the_default(stride):
    """bf16 (2-byte elements) is row_tile's default, so K3 keeps calling it
    as before: the same tile, bytes and blocks either way."""
    assert row_tile(21, stride, 3) == row_tile(21, stride, 3, 2)
