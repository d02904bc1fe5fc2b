"""Inference-time rewrites of a model (counterpart of
rcfd_tpu/nn/optimize.py)."""

from __future__ import annotations

import copy

import torch
from torch import nn

from .layers import Conv2d


@torch.no_grad()
def fold_batch_norm(module: nn.Module) -> nn.Module:
    """A copy of ``module`` with every Conv2d's inference batch norm folded
    into its convolution; ``module`` itself is left as it is.

    A Conv2d with batch norm computes ``act(conv(x, w) * scale + shift)``
    at inference. The fold rewrites, as the JAX package does,

        scale = gamma / sqrt(running_var + eps)
        w' = w * scale        (over the output channels, OIHW axis 0)
        b' = beta - running_mean * scale

    and drops the batch norm, so the convolution's epilogue is one bias add.
    The bias is the parameter ``conv.bias`` of the Conv2d, the key
    ``utils.checkpoint.state_dict_from_jax`` gives a tree the JAX package
    folded. The folded copy is for inference only."""
    folded = copy.deepcopy(module)
    for m in folded.modules():
        if not isinstance(m, Conv2d) or m.batch_norm is None:
            continue
        bn = m.batch_norm
        # the correctly rounded float32 root, as the JAX package takes it:
        # a float64 root rounded once (PyTorch's vectorized float32 sqrt on
        # the CPU can be one unit in the last place off)
        root = torch.sqrt((bn.running_var + bn.eps).double()).float()
        scale = bn.weight / root
        w = m.conv.weight
        m.conv.weight = nn.Parameter(w * scale[:, None, None, None],
                                     requires_grad=w.requires_grad)
        m.conv.bias = nn.Parameter(bn.bias - bn.running_mean * scale,
                                   requires_grad=w.requires_grad)
        m.batch_norm = None
    return folded
