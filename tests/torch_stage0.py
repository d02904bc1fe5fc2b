"""Shared helpers of the stage-0 parity tests of rcfd_tpu_torch: the rule
that explains a depth map's differing pixels as ties of two float32
computations of the same points. Imports no JAX."""

import numpy as np

# how far two computations of one coordinate may lie apart, relative to its
# magnitude (at least 1), and still be the same float32 products rounded
# otherwise: a pixel coordinate x = X / z carries the relative error of a z
# that cancels (terms of tens of metres summing to a few), so this is some
# 170 float32 steps, not one
TIE_REL = 1e-5


def _close(a, b, rel=TIE_REL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    return np.abs(a - b) <= rel * scale


def pixel_of(x, y, width):
    """Flat index of the rounded (x, y); points far off the frame (or NaN)
    get an index off it."""
    def idx(c):
        c = np.nan_to_num(np.asarray(c, np.float64), nan=-1.0)
        return np.round(np.clip(c, -2.0 ** 30, 2.0 ** 30)).astype(np.int64)
    return idx(y) * width + idx(x)


# a pixel set in both maps differs by at most this many float32 steps: the
# depth of one point computed two ways (the min of a pixel keeps it)
VALUE_ULPS = 4


def unexplained_pixels(map_a, map_b, points_a, points_b):
    """The pixels where two (H, W) maps differ and no tie explains it.

    ``points_a`` and ``points_b`` are the same points computed two ways, as
    (x, y, z, mask) arrays (e.g. the port's and the JAX package's
    reprojected_points). A point is a tie when its two computations differ
    (its rounded pixel, its mask or its depth) by no more than TIE_REL of
    each coordinate's magnitude: it sits that close to a rounding or mask
    edge, or its depth is the same product rounded otherwise. A differing
    pixel is explained when a tie lands on it in either map and, if both
    maps set it, the two depths lie within VALUE_ULPS float32 steps. Returns
    (the unexplained pixels as flat indices, the number of ties, the number
    of differing pixels, of them those set in both maps); a point whose
    computations differ by more than a tie is returned as unexplained at
    its pixel."""
    map_a = np.asarray(map_a, np.float32)
    map_b = np.asarray(map_b, np.float32)
    w = map_a.shape[1]
    xa, ya, za, ma = (np.asarray(v) for v in points_a)
    xb, yb, zb, mb = (np.asarray(v) for v in points_b)
    pa, pb = pixel_of(xa, ya, w), pixel_of(xb, yb, w)
    differs = (ma != mb) | ((ma | mb) & ((pa != pb) | (za != zb)))
    close = _close(xa, xb) & _close(ya, yb) & _close(za, zb)
    far = np.nonzero(differs & ~close)[0]
    a, b = map_a.reshape(-1), map_b.reshape(-1)
    diff = np.nonzero(a != b)[0]
    both = (a[diff] > 0) & (b[diff] > 0)
    near = np.abs(a[diff] - b[diff]) <= VALUE_ULPS * np.spacing(
        np.maximum(np.abs(a[diff]), np.abs(b[diff])))
    tie = differs & close
    covered = set(pa[tie & ma].tolist()) | set(pb[tie & mb].tolist())
    bad = [int(p) for p, ok in zip(diff, near | ~both) if p not in covered
           or not ok]
    bad += [int(pa[i]) for i in far]
    return bad, int(tie.sum()), len(diff), int(both.sum())
