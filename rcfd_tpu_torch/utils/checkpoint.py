"""Weights carried across from the JAX package, and read from checkpoint
files (counterpart of rcfd_tpu/utils/checkpoint.py
``tree_to_torch_state_dict``, ``load_torch_checkpoint`` and
``load_native_checkpoint``).

The JAX package keeps parameters as nested dicts in HWIO / (I, O) layout;
the reference and this port use torch layouts. Conversions:
    conv weight   HWIO -> OIHW
    deconv weight HWIO -> IOHW (keys ending ``deconv.weight``)
    linear weight (I, O) -> (O, I)
Batch-norm ``num_batches_tracked`` becomes int64.

Two checkpoint formats are read: the reference's torch ``.pth`` (state
dicts in torch layout already, under per-model keys, with DataParallel's
``module.`` prefix stripped) and the JAX package's native ``.npz`` (the
flattened params and state trees in JAX layout, with a JSON manifest).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .. import default_device


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


def _from_pth(state_dict) -> Dict[str, torch.Tensor]:
    """A state_dict of a .pth: DataParallel's ``module.`` prefix stripped,
    batch-norm ``num_batches_tracked`` as torch keeps it, an int64 scalar
    (the JAX package writes an int32 of shape (1,))."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith('module.'):
            key = key[len('module.'):]
        if key.endswith('num_batches_tracked'):
            value = value.to(torch.int64).reshape(())
        out[key] = value
    return out


def load_state_dict_file(path: str, pth_keys: Mapping[str, str]
                         ) -> Tuple[Dict[str, torch.Tensor], int]:
    """A model's state_dict (on the CPU) and train step from a checkpoint
    file.

    ``.npz``: the JAX package's native format (``params/<key>`` and
    ``state/<key>`` arrays in JAX layout, and ``__manifest__``, a JSON
    document with the train step), read by numpy without pickle and
    converted by ``state_dict_from_jax``. ``.orbax`` directories need orbax
    and JAX and are refused. Any other path is a reference ``.pth``, read
    with ``torch.load(weights_only=True)``; ``pth_keys`` maps each
    submodule of the model (``'encoder'``, ``'decoder'``) to the key of the
    checkpoint that holds its state_dict.
    """
    path = str(path)
    if path.rstrip('/').endswith('.orbax'):
        raise ValueError(
            '{}: orbax checkpoints need orbax and JAX; rcfd_tpu_torch reads '
            'the reference .pth format and the JAX package\'s native .npz '
            'format'.format(path))
    if path.endswith('.npz'):
        with np.load(path, allow_pickle=False) as data:
            manifest = json.loads(bytes(data['__manifest__']).decode('utf-8'))
            trees = {name: {} for name in manifest['trees']}
            for key in data.files:
                if key != '__manifest__':
                    name, flat_key = key.split('/', 1)
                    trees[name][flat_key] = data[key]
        if 'params' not in trees:
            raise ValueError('{}: no params tree in the checkpoint'.format(
                path))
        state_dict = state_dict_from_jax(trees['params'], trees.get('state'))
        return state_dict, int(manifest.get('meta', {}).get('train_step', 0))
    checkpoint = torch.load(path, map_location='cpu', weights_only=True)
    state_dict = {}
    for module, key in pth_keys.items():
        for name, value in _from_pth(checkpoint[key]).items():
            state_dict['{}.{}'.format(module, name)] = value
    return state_dict, int(checkpoint.get('train_step', 0))


def restore_module(module, path: str, pth_keys: Mapping[str, str],
                   device=None) -> int:
    """Load ``load_state_dict_file(path, pth_keys)`` into ``module`` with
    ``load_state_dict(strict=True)`` and move it to ``device`` (``cuda``
    unless ``device='cpu'`` is given). Returns the train step."""
    device = default_device(device)
    state_dict, step = load_state_dict_file(path, pth_keys)
    module.load_state_dict(state_dict, strict=True)
    module.to(device)
    return step
