"""The legacy v0 pipeline on one card: train, validate, save_stage_1 and
eval_stage_1 (counterpart of rcfd_tpu/legacy_main.py; reference
src/main.py, src/save_stage_1_depth.py, src/eval_stage_1_depth.py).

Pickle manifests, ONE random radar point a training sample, point-centred
crops (900x288 by default), the v0 FusionNet (models/legacy_v0.py), 3-class
pseudo ground truth (0 no match, 1 match, 2 invalid), the masked
positive-weighted BCE and the sobel smoothness, and Adam with L2 weight
decay. A train step (``TrainStep``) decodes the integer transport batch on
the card, labels the full ground truth, crops the image and the labels at
each sample's point (the labels filled with 2 off the frame), augments the
crops (``Transforms.draws`` from a torch.Generator seeded by ``step_seed``,
then ``apply``: the label crops flip with the images), and steps. It
computes in float32 with TF32 off (``training_numerics``).

Inference (``make_forward_fn``) crops all K points of a frame from the one
normalized image, takes the sigmoid of the network's logits and scatters
the crops into quasi-dense depth with the exact float max and the legacy
index -> z rewrite (ops/scatter.py; the JAX package's legacy path reaches
the same XLA scatter and no Pallas kernel), at the crops' x + pw // 2 of
the uncropped points. Validation scores it by the intersection metrics;
``save_stage_1`` writes depth and response PNGs and the pickled manifests
of a split; ``eval_stage_1`` scores saved maps.

Checkpoints keep the reference's v0 keys (utils/checkpoint.py
``save_legacy_checkpoint``): ``train_step``, an empty
``optimizer_state_dict`` as the JAX package writes it, and
``model_state_dict``; a restored run starts Adam afresh. A run restored at
step s resumes at step s + 1 (rcfd_tpu_torch/training.py says how this
differs from the JAX training loop).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device, native
from .data import io as data_utils
from .data import transport
from .data.legacy_datasets import (BinaryClassificationDataset,
                                   BinaryClassificationDatasetVal,
                                   SaveStage1OutputDataset, _image_path_for,
                                   load_pickle_paths, save_pickle_paths)
from .data.loader import DataLoader, device_prefetch
from .data.transforms import Transforms
from .models.legacy_v0 import (LegacyFusionNet, crop_image_to_shape_on_point,
                               crop_windows, gather_crops,
                               three_class_labels)
from .models.losses import (binary_cross_entropy_with_logits,
                            sobel_smoothness_loss_func)
from .nn.layers import init_parameters
from .ops import scatter as exact_scatter
from .pipeline import serving_numerics
from .radarnet_main import iter_scatter_outputs
from .training import (OptimizerStep, epochs, eval_mode, make_optimizer,
                       numerics_line, step_seed, step_timing, timed,
                       training_numerics)
from .utils import eval_utils
from .utils.checkpoint import load_legacy_checkpoint, save_legacy_checkpoint
from .utils.log_utils import log
from .utils.summary import SummaryWriter

METRICS = ('mae_intersection', 'rmse_intersection', 'imae_intersection',
           'irmse_intersection')


def build_model(patch_size=(900, 288), device='cpu', seed=None):
    """The v0 FusionNet for ``patch_size`` crops (its latent grid is
    ceil(h / 32) x ceil(w / 32)), on ``device``; its weights drawn from
    ``seed`` when one is given."""
    h, w = patch_size
    latent_hw = (int(np.ceil(h / 32.0)), int(np.ceil(w / 32.0)))
    model = LegacyFusionNet(radar_input_dim=3, latent_hw=latent_hw)
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def save_model(model, path: str, step: int):
    """A checkpoint with the reference's v0 keys (src/main.py:819-842)."""
    save_legacy_checkpoint(model, path, step)


def restore_model(model, path: str, device=None) -> int:
    """Load a v0 checkpoint (``.pth`` or the JAX package's ``.npz``) into
    ``model`` with ``strict=True`` and move it to ``device``; returns its
    train step."""
    state_dict, step = load_legacy_checkpoint(path)
    model.load_state_dict(state_dict, strict=True)
    model.to(default_device(device))
    return step


class TrainStep(OptimizerStep):
    """One optimizer step of the v0 FusionNet on a batch
    (rcfd_tpu/legacy_main.py ``_make_train_step``). ``batch`` is the
    loader's (image (B, H, W, 3), point (B, 3), ground truth (B, H, W, 1))
    on the model's device, in the integer transport or float; ``draws`` is
    ``transforms.draws(generator, B, p)`` for it."""

    def __init__(self, model: LegacyFusionNet, transforms: Transforms,
                 optimizer: torch.optim.Optimizer, patch_size, epsilon: float,
                 set_invalid_to_negative: bool, w_cross_entropy: float,
                 w_smoothness: float, w_positive_class: float,
                 kernel_size_smoothness=(7, 7)):
        self.model = model
        self.transforms = transforms
        self.optimizer = optimizer
        self.patch_size = tuple(patch_size)
        self.epsilon = epsilon
        self.set_invalid_to_negative = set_invalid_to_negative
        self.w_cross_entropy = w_cross_entropy
        self.w_smoothness = w_smoothness
        self.w_positive_class = w_positive_class
        self.kernel_size_smoothness = tuple(kernel_size_smoothness)

    def inputs(self, batch, draws):
        """Label, crop and augment the batch: (image crops NCHW, points
        with x at the crops' centre (B, 3), labels and validity (B, 1, ph,
        pw))."""
        image, point, ground_truth = transport.decode(tuple(batch))
        label = three_class_labels(ground_truth,
                                   point[:, 2].reshape(-1, 1, 1, 1),
                                   self.epsilon)
        points, image_crops, label_crops = crop_image_to_shape_on_point(
            point, image, label, self.patch_size[0], self.patch_size[1],
            label_fill=2.0)
        image_t, (label_crops,), _ = self.transforms.apply(
            draws, image_crops, [label_crops])
        zero = torch.zeros((), dtype=label_crops.dtype,
                           device=label_crops.device)
        if self.set_invalid_to_negative:
            label_c = torch.where(label_crops > 1, zero, label_crops)
            validity = torch.ones_like(label_c)
        else:
            label_c = label_crops
            validity = torch.where(label_crops > 1, zero, zero + 1.0)
        # contiguous NCHW: oneDNN's CPU backward of a convolution of a
        # channels-last view corrupts memory
        nchw = [t.permute(0, 3, 1, 2).contiguous()
                for t in (image_t, label_c, validity)]
        return nchw[0], points, nchw[1], nchw[2]

    def loss(self, batch, draws):
        image, points, label, validity = self.inputs(batch, draws)
        logits = self.model(image, points)
        ce = binary_cross_entropy_with_logits(
            logits, label, pos_weight=self.w_positive_class)
        loss_ce = (validity * ce).sum() / torch.clamp_min(validity.sum(), 1.0)
        if self.w_smoothness > 0:
            sig = torch.sigmoid(logits)
            loss_sm = sobel_smoothness_loss_func(
                sig, image, torch.ones_like(sig),
                filter_size=(1, 1) + self.kernel_size_smoothness)
        else:
            loss_sm = torch.zeros((), device=logits.device)
        loss = self.w_cross_entropy * loss_ce + self.w_smoothness * loss_sm
        return loss, {'loss': loss, 'loss_cross_entropy': loss_ce,
                      'loss_smoothness': loss_sm}


def make_forward_fn(model: LegacyFusionNet, transforms: Transforms,
                    image_height: int, image_width: int,
                    patch_size=(900, 288)):
    """Scatter inference over one full frame (rcfd_tpu/legacy_main.py
    ``make_forward_fn``, reference src/main.py:565-617): image (1, H, W, 3)
    (uint8 or float in [0, 255]), points (K, 3) and valid (K,) on the
    model's device -> depth_map, response_map (H, W) float32. The model
    runs in eval mode, its mode restored after."""
    ph, pw = tuple(patch_size)

    @torch.inference_mode()
    def forward(image, points, valid):
        image = transforms.transform(transport.decode(image))
        start = crop_windows(points, pw, image.shape[2] + 2 * (pw // 2))
        crops = gather_crops(image, start, ph, pw)
        centred = points.clone()
        centred[:, 0] = pw // 2
        with eval_mode(model):
            logits = model(crops.permute(0, 3, 1, 2).contiguous(), centred)
        response = torch.sigmoid(logits)[:, 0]
        return exact_scatter.scatter_quasi_dense(
            response, points[:, 0] + pw // 2, points[:, 2], valid,
            image_height=image_height, image_width=image_width,
            patch_size=(ph, pw))

    return forward


def iter_outputs(forward_fn, dataset, device, seconds: Optional[dict] = None):
    """``radarnet_main.iter_scatter_outputs`` over a validation or stage-1
    dataset with the single-frame ``forward_fn``: yields (index, the host
    sample decoded to float32, depth (H, W), response (H, W)) in order,
    frame i + 1 read and copied while the card works on frame i;
    ``seconds`` gains 'read' and 'serve'."""
    def forward(images, points, valid):
        return (t[None] for t in forward_fn(images, points[0], valid[0]))

    return iter_scatter_outputs(forward, dataset, 1, device, seconds)


def _errors(out, gt):
    return (eval_utils.mean_abs_err(1000. * out, 1000. * gt),
            eval_utils.root_mean_sq_err(1000. * out, 1000. * gt),
            eval_utils.inv_mean_abs_err(0.001 * out, 0.001 * gt),
            eval_utils.inv_root_mean_sq_err(0.001 * out, 0.001 * gt))


def validate(forward_fn, dataset, step, best_results, min_evaluate_depth,
             max_evaluate_depth, summary_writer=None, log_path=None,
             device='cuda', seconds: Optional[dict] = None):
    """Scatter validation with the intersection metrics
    (rcfd_tpu/legacy_main.py ``validate``, reference src/main.py:507-720):
    per frame MAE, RMSE (mm), iMAE, iRMSE (1/km) over the pixels where the
    output and the ground truth both have depth within (min, max), and the
    intersection's pixel count; their means (NaN frames skipped). The best
    moves to this step when more than 3 of the 5 (the four errors no worse,
    the count no lower, each rounded to 2 decimals) say so. Returns the
    best results."""
    n = len(dataset)
    errors = np.full((n, 4), np.nan)
    n_inter = np.zeros(n)
    for i, sample, out, _ in iter_outputs(forward_fn, dataset, device,
                                          seconds):
        g = sample[3][..., 0]
        inter = (out > 0) & (g > 0)
        n_inter[i] = inter.sum()
        mask = inter & (g > min_evaluate_depth) & (g < max_evaluate_depth)
        errors[i] = _errors(out[mask], g[mask])
    results = {k: float(np.nanmean(errors[:, j]))
               for j, k in enumerate(METRICS)}
    results['n_valid_points_intersection'] = float(np.mean(n_inter))
    if summary_writer is not None:
        for k, v in results.items():
            summary_writer.add_scalar('eval-' + k, v, global_step=step)
    log('Legacy validation step {}: {}'.format(step, results), log_path)
    n_improve = sum(int(np.round(results[k], 2) <=
                        np.round(best_results[k], 2)) for k in METRICS)
    n_improve += int(np.round(results['n_valid_points_intersection'], 2) >=
                     np.round(best_results['n_valid_points_intersection'], 2))
    if n_improve > 3:
        best_results = dict(results, step=step)
    return best_results


def train(path_to_pickle_file_gt_train_paths,
          path_to_pickle_file_radar_train_numpys,
          path_to_pickle_file_gt_val_paths,
          path_to_pickle_file_radar_val_numpys,
          data_path,
          image_path,
          epsilon,
          batch_size,
          patch_size,
          normalized_image_range,
          learning_rates,
          learning_schedule,
          augmentation_probabilities,
          augmentation_schedule,
          augmentation_random_brightness,
          augmentation_random_noise_type,
          augmentation_random_noise_spread,
          augmentation_random_flip_type,
          w_cross_entropy,
          w_smoothness,
          w_weight_decay,
          kernel_size_smoothness,
          set_invalid_to_negative,
          w_positive_class,
          checkpoint_dirpath,
          num_step_per_summary,
          num_step_per_checkpoint,
          start_step_validation,
          restore_path=None,
          min_evaluate_depth=0.0,
          max_evaluate_depth=100.0,
          max_points_inference=128,
          debug=False,
          num_workers=10,
          seed=0,
          device=None,
          timings: Optional[list] = None,
          seconds: Optional[dict] = None):
    """The v0 training loop (rcfd_tpu/legacy_main.py ``train``, reference
    src/main.py:26-505) on ``device`` (``cuda`` unless ``device='cpu'``):
    per-epoch learning-rate and augmentation schedules, summaries every
    ``num_step_per_summary`` steps, a checkpoint ``model-<step>.pth`` every
    ``num_step_per_checkpoint`` with a validation from
    ``start_step_validation`` on, and a last validation and checkpoint at
    the end. ``debug`` takes the first 100 training and the 100th to 150th
    validation samples. ``timings``, a list, receives a dict per step (its
    milliseconds, the card synchronized after it, and the host's wait for
    its batch); ``seconds``, a dict, gains the validations' 'read' and
    'serve' seconds, their frame count under 'frames' and each
    validation's 'serve' seconds in the list 'validations'. Returns the
    best validation results."""
    device = default_device(device)
    os.makedirs(checkpoint_dirpath, exist_ok=True)
    checkpoint_path = os.path.join(checkpoint_dirpath, 'model-{}.pth')
    log_path = os.path.join(checkpoint_dirpath, 'results.txt')
    event_path = os.path.join(checkpoint_dirpath, 'events')

    gt_train = load_pickle_paths(path_to_pickle_file_gt_train_paths)
    radar_train = load_pickle_paths(path_to_pickle_file_radar_train_numpys)
    gt_val = load_pickle_paths(path_to_pickle_file_gt_val_paths)
    radar_val = load_pickle_paths(path_to_pickle_file_radar_val_numpys)
    if debug:
        gt_train, radar_train = gt_train[:100], radar_train[:100]
        gt_val, radar_val = gt_val[100:150], radar_val[100:150]

    train_dataset = BinaryClassificationDataset(
        gt_train, radar_train, image_dirpath=image_path,
        data_dirpath=data_path, device=device)
    val_dataset = BinaryClassificationDatasetVal(
        gt_val, radar_val, image_dirpath=image_path, data_dirpath=data_path,
        max_points=max_points_inference, device=device)
    train_loader = DataLoader(train_dataset, batch_size=batch_size,
                              shuffle=True, num_workers=num_workers,
                              seed=seed, drop_last=True)
    train_transforms = Transforms(
        normalized_image_range=list(normalized_image_range),
        random_brightness=list(augmentation_random_brightness),
        random_noise_type=augmentation_random_noise_type,
        random_noise_spread=augmentation_random_noise_spread,
        random_flip_type=list(augmentation_random_flip_type))
    val_transforms = Transforms(
        normalized_image_range=list(normalized_image_range))

    model = build_model(patch_size, device, seed)
    optimizer = make_optimizer(model, learning_rates[0], w_weight_decay)
    train_step = 0
    if restore_path:
        train_step = restore_model(model, restore_path, device)
    step_fn = TrainStep(model, train_transforms, optimizer, patch_size,
                        epsilon, set_invalid_to_negative, w_cross_entropy,
                        w_smoothness, w_positive_class,
                        kernel_size_smoothness)

    if len(val_dataset):
        image_height, image_width = native.probe(
            _image_path_for(os.path.join(data_path, gt_val[0]), image_path))
    else:
        image_height, image_width = 900, 1600
    forward_fn = make_forward_fn(model, val_transforms, image_height,
                                 image_width, tuple(patch_size))

    train_writer = SummaryWriter(event_path + '-train')
    val_writer = SummaryWriter(event_path + '-val')
    best_results = dict({k: np.inf for k in METRICS}, step=-1,
                        n_valid_points_intersection=0)
    steps_per_epoch = len(train_dataset) // batch_size
    n_train_step = int(learning_schedule[-1] *
                       np.ceil(len(train_dataset) / batch_size))
    log('Legacy v0 training: n_sample={} n_step={}'.format(
        len(train_dataset), n_train_step), log_path)

    generator = torch.Generator(device=device)
    done = train_step  # steps restored from the checkpoint
    time_start = time.time()

    def run_validation():
        nonlocal best_results
        mine = {}
        best_results = validate(
            forward_fn, val_dataset, train_step, best_results,
            min_evaluate_depth, max_evaluate_depth, val_writer, log_path,
            device, mine)
        if seconds is not None:
            for k, v in mine.items():
                seconds[k] = seconds.get(k, 0.0) + v
            seconds['frames'] = seconds.get('frames', 0) + len(val_dataset)
            seconds.setdefault('validations', []).append(mine['serve'])

    with training_numerics():
        log(numerics_line())
        for epoch, start, learning_rate, augmentation_probability in epochs(
                learning_rates, learning_schedule, augmentation_probabilities,
                augmentation_schedule, done, steps_per_epoch):
            train_loader.set_epoch(epoch, start_batch=start)
            for batch, wait_ms, t0 in timed(device_prefetch(train_loader,
                                                             device)):
                train_step += 1
                generator.manual_seed(step_seed(seed, train_step))
                draws = train_transforms.draws(generator, batch_size,
                                               augmentation_probability)
                info = step_fn(batch, draws, learning_rate)
                if timings is not None:
                    timings.append(step_timing(device, train_step, t0,
                                               wait_ms, info['loss']))
                if train_step % num_step_per_summary == 0:
                    for k, v in info.items():
                        train_writer.add_scalar('train-' + k, float(v),
                                                global_step=train_step)
                if train_step % num_step_per_checkpoint == 0:
                    log('Step={}/{} Loss={:.5f} ({:.2f} h elapsed)'.format(
                        train_step, n_train_step, float(info['loss']),
                        (time.time() - time_start) / 3600), log_path)
                    if train_step >= start_step_validation and \
                            len(val_dataset):
                        run_validation()
                    save_model(model, checkpoint_path.format(train_step),
                               train_step)
        if len(val_dataset):
            run_validation()
        save_model(model, checkpoint_path.format(train_step), train_step)
    train_writer.close()
    val_writer.close()
    return best_results


def save_stage_1(restore_path,
                 path_to_pickle_file_gt_paths,
                 path_to_pickle_file_radar_numpy_paths,
                 image_dirpath,
                 output_dirpath,
                 patch_size=(900, 288),
                 data_path='',
                 max_points_inference=128,
                 normalized_image_range=(0, 1),
                 file_to_save_radar_output_paths=None,
                 file_to_save_radar_response_paths=None,
                 verbose=False,
                 device=None,
                 seconds: Optional[dict] = None):
    """Run a trained v0 model over a split (rcfd_tpu/legacy_main.py
    ``save_stage_1``, reference src/save_stage_1_depth.py): quasi-dense
    depth and response PNGs into ``output_dirpath``/radar_output and
    radar_response, named by the frames' ground truth, and the pickled
    lists of their paths. On ``device`` (``cuda`` unless ``device='cpu'``),
    under the serving numerics (pipeline.py ``serving_numerics``: float32
    with TF32 off); ``seconds``, a dict, gains 'read', 'serve' and 'write'.
    Returns (depth paths, response paths)."""
    device = default_device(device)
    gt_paths = load_pickle_paths(path_to_pickle_file_gt_paths)
    radar_paths = load_pickle_paths(path_to_pickle_file_radar_numpy_paths)
    dataset = SaveStage1OutputDataset(
        gt_paths, radar_paths, image_dirpath=image_dirpath,
        data_dirpath=data_path, max_points=max_points_inference,
        device=device)
    model = build_model(patch_size)
    restore_model(model, restore_path, device)
    image_height, image_width = native.probe(_image_path_for(
        os.path.join(data_path, gt_paths[0]), image_dirpath))
    transforms = Transforms(
        normalized_image_range=list(normalized_image_range))
    forward_fn = make_forward_fn(model, transforms, image_height,
                                 image_width, tuple(patch_size))

    depth_dir = os.path.join(output_dirpath, 'radar_output')
    response_dir = os.path.join(output_dirpath, 'radar_response')
    os.makedirs(depth_dir, exist_ok=True)
    os.makedirs(response_dir, exist_ok=True)
    seconds = {} if seconds is None else seconds
    depth_paths, response_paths = [], []
    with torch.inference_mode(), serving_numerics():
        for i, sample, depth_map, response_map in iter_outputs(
                forward_fn, dataset, device, seconds):
            t0 = time.perf_counter()
            name = sample[4]
            dp = os.path.join(depth_dir, name + '.png')
            rp = os.path.join(response_dir, name + '.png')
            data_utils.save_depth(depth_map, dp)
            data_utils.save_response(response_map, rp)
            depth_paths.append(dp)
            response_paths.append(rp)
            seconds['write'] = seconds.get('write', 0.0) + \
                time.perf_counter() - t0
            if verbose:
                print('[save_stage_1] {}/{}'.format(i + 1, len(dataset)),
                      end='\r')
    if file_to_save_radar_output_paths:
        save_pickle_paths(file_to_save_radar_output_paths, depth_paths)
    if file_to_save_radar_response_paths:
        save_pickle_paths(file_to_save_radar_response_paths, response_paths)
    return depth_paths, response_paths


def eval_stage_1(path_to_pickle_file_output_paths,
                 path_to_pickle_file_gt_paths,
                 data_path='',
                 min_evaluate_depth=0.0,
                 max_evaluate_depth=100.0,
                 log_path=None):
    """Score saved stage-1 quasi-dense maps against ground truth
    (rcfd_tpu/legacy_main.py ``eval_stage_1``, reference
    src/eval_stage_1_depth.py): per frame MAE, RMSE, iMAE and iRMSE over
    the pixels where the output has depth and the ground truth lies within
    (min, max); their means. On the host."""
    out_paths = load_pickle_paths(path_to_pickle_file_output_paths)
    gt_paths = load_pickle_paths(path_to_pickle_file_gt_paths)
    assert len(out_paths) == len(gt_paths)
    n = len(out_paths)
    errors = np.full((n, 4), np.nan)
    for i in range(n):
        out = data_utils.load_depth(os.path.join(data_path, out_paths[i]))
        gt = data_utils.load_depth(os.path.join(data_path, gt_paths[i]))
        mask = (out > 0) & (gt > min_evaluate_depth) & \
            (gt < max_evaluate_depth)
        errors[i] = _errors(out[mask], gt[mask])
    results = {k: float(np.nanmean(errors[:, j]))
               for j, k in enumerate(('mae', 'rmse', 'imae', 'irmse'))}
    log('Stage-1 eval over {} samples: {}'.format(n, results), log_path)
    return results
