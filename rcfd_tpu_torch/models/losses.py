"""Loss functions (counterpart of rcfd_tpu/models/losses.py; reference
src/fusionnet_losses.py and the masked BCE of src/radarnet_model.py:126-167).
Maps are NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(err, weight):
    """The mean of ``err``, or with ``weight`` (a 0/1 mask) the mean over
    the mask: the reference's l1_loss(src[mask], tgt[mask])."""
    if weight is None:
        return err.mean()
    weight = weight.to(err.dtype)
    return (err * weight).sum() / torch.clamp_min(weight.sum(), 1.0)


def l1_loss(src, tgt, weight=None):
    return _masked_mean((src - tgt).abs(), weight)


def l2_loss(src, tgt, weight=None):
    return _masked_mean((src - tgt) ** 2, weight)


def smooth_l1_loss(src, tgt, weight=None, beta: float = 1.0):
    diff = (src - tgt).abs()
    err = torch.where(diff < beta, 0.5 * diff * diff / beta,
                      diff - 0.5 * beta)
    return _masked_mean(err, weight)


def binary_cross_entropy_with_logits(logits, targets,
                                     pos_weight: float = 1.0):
    """Elementwise BCE with logits, the positive class weighted by
    ``pos_weight``: -(pw * t * log(sigmoid(x)) + (1 - t) * log(1 -
    sigmoid(x)))."""
    return -(pos_weight * targets * F.logsigmoid(logits) +
             (1.0 - targets) * F.logsigmoid(-logits))


def gradient_yx(t):
    """First differences along y and x of an NCHW tensor
    (src/fusionnet_losses.py:131-145)."""
    dx = t[..., :, :-1] - t[..., :, 1:]
    dy = t[..., :-1, :] - t[..., 1:, :]
    return dy, dx


def smoothness_loss_func(predict, image):
    """Edge-aware first-difference smoothness
    (src/fusionnet_losses.py:49-74)."""
    predict_dy, predict_dx = gradient_yx(predict)
    image_dy, image_dx = gradient_yx(image)
    weights_x = torch.exp(-image_dx.abs().mean(1, keepdim=True))
    weights_y = torch.exp(-image_dy.abs().mean(1, keepdim=True))
    smoothness_x = (weights_x * predict_dx.abs()).mean()
    smoothness_y = (weights_y * predict_dy.abs()).mean()
    return smoothness_x + smoothness_y


def sobel_filter(filter_size=(1, 1, 3, 3)):
    """Generalized sobel kernels (kh, kw) for x and y
    (src/fusionnet_losses.py:147-161)."""
    kh, kw = filter_size[-2], filter_size[-1]
    gx = torch.ones((kh, kw))
    gy = torch.ones((kh, kw))
    gx[:, kw // 2] = 0
    gx[kh // 2, kw // 2 - 1] = 2
    gx[kh // 2, kw // 2 + 1] = 2
    gx[:, kw // 2:] = -gx[:, kw // 2:]
    gy[kh // 2, :] = 0
    gy[kh // 2 - 1, kw // 2] = 2
    gy[kh // 2 + 1, kw // 2] = 2
    gy[kh // 2 + 1:, :] = -gy[kh // 2 + 1:, :]
    return gx, gy


def _conv_single(x, kernel):
    """Valid cross-correlation of (N, 1, H, W) x with a (kh, kw) kernel."""
    return F.conv2d(x, kernel.to(x.dtype).to(x.device)[None, None])


def sobel_smoothness_loss_func(predict, image, weights,
                               filter_size=(1, 1, 7, 7)):
    """Sobel-filtered smoothness with validity weights
    (src/fusionnet_losses.py:77-125): predict (N, 1, H, W), image
    (N, 3, H, W)."""
    kh, kw = filter_size[-2], filter_size[-1]
    predict = F.pad(predict, (kw // 2, kw // 2, kh // 2, kh // 2),
                    mode='replicate')
    gx, gy = sobel_filter(filter_size)
    predict_dy = _conv_single(predict, gy)
    predict_dx = _conv_single(predict, gx)

    gray = (image[:, 0] * 0.30 + image[:, 1] * 0.59 +
            image[:, 2] * 0.11)[:, None]
    gray = F.pad(gray, (1, 1, 1, 1), mode='replicate')
    gx_i, gy_i = sobel_filter((1, 1, 3, 3))
    image_dy = _conv_single(gray, gy_i)
    image_dx = _conv_single(gray, gx_i)

    weights_x = torch.exp(-image_dx.abs().mean(1, keepdim=True))
    weights_y = torch.exp(-image_dy.abs().mean(1, keepdim=True))
    smoothness_x = (weights * weights_x * predict_dx.abs()).mean()
    smoothness_y = (weights * weights_y * predict_dy.abs()).mean()
    return (smoothness_x + smoothness_y) / float(kh * kw)
