"""Weights carried across from the JAX package (counterpart of
rcfd_tpu/utils/checkpoint.py ``tree_to_torch_state_dict``).

The JAX package keeps parameters as nested dicts in HWIO / (I, O) layout;
the reference and this port use torch layouts. Conversions:
    conv weight   HWIO -> OIHW
    deconv weight HWIO -> IOHW (keys ending ``deconv.weight``)
    linear weight (I, O) -> (O, I)
Batch-norm ``num_batches_tracked`` becomes int64.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree, prefix='') -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = '{}{}'.format(prefix, k)
        if isinstance(v, dict):
            out.update(_flatten(v, key + '.'))
        else:
            out[key] = v
    return out


def _is_deconv_key(key: str) -> bool:
    return key.endswith('deconv.weight') and \
        not key.endswith('conv.conv.weight')


def state_dict_from_jax(params, state=None) -> Dict[str, torch.Tensor]:
    """The port's state_dict from the JAX package's (params, state) trees,
    given as nested dicts of numpy arrays, keyed as the reference's torch
    state_dicts are."""
    out: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(params).items():
        arr = np.asarray(arr)
        if key.rsplit('.', 1)[-1] == 'weight':
            if arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 0, 1) if _is_deconv_key(key)
                                   else (3, 2, 0, 1))
            elif arr.ndim == 2:
                arr = arr.T
        out[key] = torch.from_numpy(np.array(arr))
    for key, arr in _flatten(state or {}).items():
        arr = np.asarray(arr)
        if key.endswith('num_batches_tracked'):
            arr = arr.astype(np.int64)
        out[key] = torch.from_numpy(np.array(arr))
    return out
