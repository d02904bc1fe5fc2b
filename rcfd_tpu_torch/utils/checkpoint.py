"""Weights carried across from the JAX package, and read from and written
to checkpoint files (counterpart of rcfd_tpu/utils/checkpoint.py
``tree_to_torch_state_dict``, ``load_torch_checkpoint``,
``save_torch_checkpoint`` and the native ``.npz`` format, and of
rcfd_tpu/utils/profiling.py ``find_latest_checkpoint``).

The JAX package keeps parameters as nested dicts in HWIO / (I, O) layout;
the reference and this port use torch layouts. Conversions:
    conv weight   HWIO -> OIHW
    deconv weight HWIO -> IOHW (keys ending ``deconv.weight``)
    linear weight (I, O) -> (O, I)
Batch-norm ``num_batches_tracked`` becomes int64.

Two checkpoint formats are read and written: the reference's torch
``.pth`` (state dicts in torch layout already, under per-model keys, with
DataParallel's ``module.`` prefix stripped on read, beside ``train_step``
and ``optimizer_state_dict``, a torch.optim.Adam state_dict) and the JAX
package's native ``.npz`` (the flattened params and state trees in JAX
layout, with a JSON manifest; no optimizer state). The legacy v0 model's
checkpoints (``load_legacy_checkpoint``, ``save_legacy_checkpoint``) keep
the reference's v0 keys: a ``.pth`` of ``train_step``,
``optimizer_state_dict`` and one ``model_state_dict``, or the JAX legacy
trainer's ``.npz`` fallback of ``model_state_dict/<key>`` arrays in torch
layout beside ``train_step``.

The Adam state of a ``.pth`` is indexed as the JAX package indexes it, so
that either package restores the other's exactly: parameter i is the i-th
of the parameter tree flattened with its keys sorted at every level (JAX's
dict order after any tree operation), with an entry for every parameter.
torch indexes by registration order and keeps no state for a parameter
that never had a gradient; ``optimizer_state_to_file`` and
``optimizer_state_from_file`` convert.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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
    state_dicts are. Every model of the port maps so, the legacy v0 one
    too: its radar branch's ``linear{i}.fully_connected`` weights are
    transposed as any linear weight, its ``bn{i}`` BatchNorm1d weights,
    biases and buffers (1-D, and the 0-d count) pass as they are."""
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
    file: ``load_checkpoint_file`` without the optimizer state."""
    return load_checkpoint_file(path, pth_keys)[:2]


def load_checkpoint_file(path: str, pth_keys: Mapping[str, str],
                         optimizer_key: str = 'optimizer_state_dict'):
    """A model's state_dict (on the CPU), train step and optimizer
    state_dict (None if the file has none or an empty one) from a
    checkpoint file.

    ``.npz``: the JAX package's native format (``params/<key>`` and
    ``state/<key>`` arrays in JAX layout, and ``__manifest__``, a JSON
    document with the train step), read by numpy without pickle and
    converted by ``state_dict_from_jax``. ``.orbax`` directories need orbax
    and JAX and are refused. Any other path is a reference ``.pth``, read
    with ``torch.load(weights_only=True)``; ``pth_keys`` maps each
    submodule of the model (``'encoder'``, ``'decoder'``) to the key of the
    checkpoint that holds its state_dict, and ``optimizer_key`` is the key
    of the optimizer's.
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
        return (state_dict,
                int(manifest.get('meta', {}).get('train_step', 0)), None)
    checkpoint = torch.load(path, map_location='cpu', weights_only=True)
    state_dict = {}
    for module, key in pth_keys.items():
        for name, value in _from_pth(checkpoint[key]).items():
            state_dict['{}.{}'.format(module, name)] = value
    return (state_dict, int(checkpoint.get('train_step', 0)),
            checkpoint.get(optimizer_key) or None)


def _file_order(module):
    """Registration indices of ``module``'s parameters in the file's order:
    their names sorted as tuples of the dotted components."""
    names = [n for n, _ in module.named_parameters()]
    return sorted(range(len(names)), key=lambda i: names[i].split('.'))


def optimizer_state_to_file(module, state_dict: dict) -> dict:
    """An Adam state_dict of ``module``'s parameters (torch's registration
    indices) in the file's order, every entry at the common step (JAX keeps
    one count), with zero moments for the parameters torch kept no state
    for and the common step for those whose state it stopped updating
    (they never had a gradient; JAX keeps zeros for them). An entry at the
    common step is kept as it is, so a state read from a file (JAX writes
    its step as a Python int) is written back unchanged; the others take a
    copy of the common step's value, of its type."""
    state = state_dict.get('state') or {}
    if not state:
        return state_dict
    params = list(module.parameters())
    common = max((s['step'] for s in state.values()), key=float)
    out = {}
    for j, i in enumerate(_file_order(module)):
        zeros = torch.zeros_like(params[i])
        entry = state.get(i) or {'exp_avg': zeros,
                                 'exp_avg_sq': zeros.clone()}
        if 'step' not in entry or float(entry['step']) != float(common):
            # a tensor of its own: Adam steps each parameter's in place
            entry = dict(entry, step=common.clone() if isinstance(
                common, torch.Tensor) else common)
        out[j] = entry
    return dict(state_dict, state=out)


def optimizer_state_from_file(module, state_dict: dict) -> dict:
    """The inverse of ``optimizer_state_to_file``: an Adam state_dict in
    the file's order back in registration indices, for
    ``torch.optim.Adam.load_state_dict``."""
    state = state_dict.get('state') or {}
    if not state:
        return state_dict
    out = {i: state[j] for j, i in enumerate(_file_order(module))}
    return dict(state_dict, state=dict(sorted(out.items())))


def restore_module(module, path: str, pth_keys: Mapping[str, str],
                   device=None, return_optimizer_state: bool = False,
                   optimizer_key: str = 'optimizer_state_dict'):
    """Load ``load_checkpoint_file(path, pth_keys, optimizer_key)`` into
    ``module`` with
    ``load_state_dict(strict=True)`` and move it to ``device`` (``cuda``
    unless ``device='cpu'`` is given). Returns the train step, or with
    ``return_optimizer_state`` (train step, optimizer state_dict or
    None)."""
    device = default_device(device)
    state_dict, step, optimizer_state = load_checkpoint_file(
        path, pth_keys, optimizer_key)
    module.load_state_dict(state_dict, strict=True)
    module.to(device)
    if not return_optimizer_state:
        return step
    if optimizer_state:
        optimizer_state = optimizer_state_from_file(module, optimizer_state)
    return step, optimizer_state


def _to_jax_layout(key: str, arr: np.ndarray) -> np.ndarray:
    """A torch-layout parameter as the JAX package keeps it: the inverse
    of ``state_dict_from_jax``'s transposes."""
    if key.rsplit('.', 1)[-1] == 'weight':
        if arr.ndim == 4:
            return np.transpose(arr, (2, 3, 0, 1) if _is_deconv_key(key)
                                else (2, 3, 1, 0))
        if arr.ndim == 2:
            return arr.T
    return arr


def save_checkpoint(module, path: str, pth_keys: Mapping[str, str],
                    step: int, optimizer_state_dict: Optional[dict] = None,
                    model_name: str = '',
                    optimizer_key: str = 'optimizer_state_dict',
                    jax_counts: bool = False):
    """Write ``module``'s weights as the JAX package's ``save_checkpoint``
    does: a path ending ``.npz`` gets the native format (``params/<key>``
    and ``state/<key>`` in JAX layout, ``__manifest__`` with the train step
    and ``model_name``; no optimizer state), any other path the reference
    ``.pth``: ``train_step``, the optimizer's state under ``optimizer_key``
    (the torch.optim.Adam state_dict of ``module.parameters()``, written in
    the file's order by ``optimizer_state_to_file``, or {}) and the
    submodules' state_dicts under ``pth_keys``. Tensors are written from
    the CPU. With ``jax_counts`` a ``.pth`` holds each batch norm's
    ``num_batches_tracked`` as the JAX package writes it, an int32 of shape
    (1,) (torch keeps an int64 scalar; both restore in either package and
    in the reference)."""
    path = str(path)
    if path.endswith('.npz'):
        buffers = dict(module.named_buffers())
        arrays = {}
        for key, value in module.state_dict().items():
            arr = value.detach().cpu().numpy()
            if key in buffers:
                if key.endswith('num_batches_tracked'):
                    arr = arr.astype(np.int32)
                arrays['state/' + key] = arr
            else:
                arrays['params/' + key] = _to_jax_layout(key, arr)
        manifest = {'trees': ['params', 'state'],
                    'meta': {'train_step': int(step), 'model': model_name}}
        arrays['__manifest__'] = np.frombuffer(
            json.dumps(manifest).encode('utf-8'), dtype=np.uint8)
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        return

    def cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.detach().cpu()
        if isinstance(obj, dict):
            return {k: cpu(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(cpu(v) for v in obj)
        return obj

    if optimizer_state_dict:
        optimizer_state_dict = optimizer_state_to_file(module,
                                                       optimizer_state_dict)
    checkpoint = {'train_step': int(step),
                  optimizer_key: cpu(optimizer_state_dict or {})}
    for part, key in pth_keys.items():
        checkpoint[key] = cpu(getattr(module, part).state_dict())
        if jax_counts:
            for name, value in checkpoint[key].items():
                if name.endswith('num_batches_tracked'):
                    checkpoint[key][name] = value.to(torch.int32).reshape(1)
    torch.save(checkpoint, path)


def load_legacy_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """The legacy v0 model's state_dict (on the CPU) and train step from a
    checkpoint file of the reference's v0 keys (rcfd_tpu/legacy_main.py
    ``restore_model``): a ``.npz`` of ``model_state_dict/<key>`` arrays in
    torch layout and ``train_step`` (read by numpy without pickle), or a
    ``.pth`` with ``model_state_dict`` and ``train_step`` (read with
    ``torch.load(weights_only=True)``)."""
    path = str(path)
    if path.endswith('.npz'):
        prefix = 'model_state_dict/'
        with np.load(path, allow_pickle=False) as data:
            state_dict = {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
                          for k in data.files if k.startswith(prefix)}
            step = int(data['train_step'])
        return _from_pth(state_dict), step
    checkpoint = torch.load(path, map_location='cpu', weights_only=True)
    return (_from_pth(checkpoint['model_state_dict']),
            int(checkpoint.get('train_step', 0)))


def save_legacy_checkpoint(module, path: str, step: int):
    """Write the legacy v0 model's weights with the reference's v0 keys
    (rcfd_tpu/legacy_main.py ``save_model``): a path ending ``.npz`` gets
    ``model_state_dict/<key>`` arrays in torch layout and ``train_step``;
    any other path a ``.pth`` of ``train_step``, an empty
    ``optimizer_state_dict`` (as the JAX package writes it) and
    ``model_state_dict``. Tensors are written from the CPU."""
    path = str(path)
    state_dict = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    if path.endswith('.npz'):
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            np.savez(f, train_step=np.int64(step),
                     **{'model_state_dict/' + k: v.numpy()
                        for k, v in state_dict.items()})
        os.replace(tmp, path)
        return
    torch.save({'train_step': int(step), 'optimizer_state_dict': {},
                'model_state_dict': state_dict}, path)


def find_latest_checkpoint(checkpoint_dirpath: str) -> Optional[str]:
    """The newest ``model-<step>.pth`` or ``.npz`` of a checkpoint
    directory (the highest step), or None: ``--restore_path latest``."""
    if not os.path.isdir(checkpoint_dirpath):
        return None
    best_step, best_path = -1, None
    for fname in os.listdir(checkpoint_dirpath):
        m = re.match(r'model-(\d+)\.(pth|npz)$', fname)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best_path = os.path.join(checkpoint_dirpath, fname)
    return best_path
