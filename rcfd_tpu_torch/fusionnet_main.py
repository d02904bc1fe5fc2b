"""FusionNet training and validation on one card (counterpart of
rcfd_tpu/fusionnet_main.py ``_make_train_step``, ``make_forward_fn``,
``iter_forward_outputs``, ``validate`` and ``train``; reference
src/fusionnet_main.py).

A train step decodes the integer transport batch on the card, augments it
(``Transforms.draws`` from a torch.Generator seeded by ``step_seed``, then
``apply``),
dilates the ground truth and removes its outliers, runs FusionNet in
training mode (batch norm by the batch's statistics), computes the masked
multi-scale loss, back-propagates through autograd (cuDNN for the
convolutions) and takes an Adam step (torch.optim.Adam: L2 decay added to
the gradient and bias correction, the JAX package's ``adam_step``). It
computes in float32 with TF32 off (``training_numerics``).

Not in the port yet, each refused with a message: data parallelism over
more than one card (``n_data_parallel`` > 1), bf16 training
(RCFD_TRAIN_DTYPE=bfloat16), ``device='tpu'``. The TensorBoard image
panels of the JAX training loop are not written; scalars are.

A run restored at step s resumes at step s + 1 (rcfd_tpu_torch/training.py
says how this differs from the JAX training loop).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device
from .data import io as data_utils
from .data import transport
from .data.datasets import FusionNetInferenceDataset, FusionNetTrainingDataset
from .data.loader import DataLoader, device_prefetch
from .data.transforms import Transforms
from .models.fusionnet import FusionNetModel
from .nn import functional as NF
from .nn.layers import init_parameters
from .training import (OptimizerStep, epochs, eval_mode, make_optimizer,
                       numerics_line, refuse_unported, step_seed,
                       step_timing, timed, training_numerics)
from .utils import eval_utils
from .utils.checkpoint import find_latest_checkpoint
from .utils.log_utils import log
from .utils.summary import SummaryWriter


def build_model(input_channels_image, input_channels_depth, encoder_type,
                n_filters_encoder_image, n_filters_encoder_depth,
                fusion_type, decoder_type, n_resolutions_decoder,
                n_filters_decoder, weight_initializer, activation_func,
                min_predict_depth, max_predict_depth, device):
    """A trainable FusionNet (rcfd_tpu/fusionnet_main.py ``_build_model``)
    with the reference's 'up' deconvolutions."""
    return FusionNetModel(
        input_channels_image=input_channels_image,
        input_channels_depth=input_channels_depth,
        encoder_type=encoder_type,
        n_filters_encoder_image=n_filters_encoder_image,
        n_filters_encoder_depth=n_filters_encoder_depth,
        fusion_type=fusion_type, decoder_type=decoder_type,
        n_resolution_decoder=n_resolutions_decoder,
        n_filters_decoder=n_filters_decoder, deconv_type='up',
        activation_func=activation_func,
        weight_initializer=weight_initializer,
        min_predict_depth=min_predict_depth,
        max_predict_depth=max_predict_depth, device=device, trainable=True)


class TrainStep(OptimizerStep):
    """One optimizer step of FusionNet on a batch (rcfd_tpu/fusionnet_main.py
    ``_make_train_step``). ``batch`` is the loader's (image, depth,
    response, ground_truth, lidar_map) on the model's device, NHWC, in the
    integer transport or float; ``draws`` is ``transforms.draws(...)`` for
    it."""

    def __init__(self, model: FusionNetModel, transforms: Transforms,
                 optimizer: torch.optim.Optimizer, loss_func: str,
                 w_smoothness: float, w_lidar_loss: float,
                 loss_smoothness_kernel_size: int, outlier_kernel_size: int,
                 outlier_threshold: float, dilation_kernel_size: int):
        self.model = model
        self.transforms = transforms
        self.optimizer = optimizer
        self.loss_func = loss_func
        self.w_smoothness = w_smoothness
        self.w_lidar_loss = w_lidar_loss
        self.loss_smoothness_kernel_size = loss_smoothness_kernel_size
        self.outlier_kernel_size = outlier_kernel_size
        self.outlier_threshold = outlier_threshold
        self.dilation_kernel_size = dilation_kernel_size

    def inputs(self, batch, draws):
        """Decode and augment the batch, then dilate the ground truth and
        remove its outliers: (image, input_depth, ground_truth, lidar_map,
        validity_map_loss_smoothness), NCHW."""
        image, depth, response, ground_truth, lidar_map = (
            transport.decode(t) for t in batch)
        image, maps, _ = self.transforms.apply(
            draws, image, [depth, response, ground_truth, lidar_map])
        image, depth, response, ground_truth, lidar_map = (
            t.permute(0, 3, 1, 2) for t in [image] + maps)
        k = self.dilation_kernel_size
        if k > 1:
            ground_truth = NF.max_pool2d(ground_truth, k, 1, k // 2)
        if self.outlier_kernel_size > 1 and self.outlier_threshold > 0:
            ground_truth = NF.outlier_removal(
                ground_truth, self.outlier_kernel_size,
                self.outlier_threshold)
        validity = torch.where(ground_truth > 0, 0.0, 1.0).to(
            ground_truth.dtype)
        # the network's inputs in NCHW memory: a permuted NHWC map is a
        # channels-last view (and so is their concatenation), and on the
        # CPU oneDNN's backward of a convolution of a channels-last input
        # corrupts memory that the process trips over at exit (torch 2.11
        # and 2.13)
        return (image.contiguous(),
                torch.cat([depth, response], 1).contiguous(), ground_truth,
                lidar_map, validity)

    def loss(self, batch, draws):
        """The forward in the model's mode and the loss: (loss,
        loss_info)."""
        image, input_depth, ground_truth, lidar_map, validity = \
            self.inputs(batch, draws)
        output = self.model(image, input_depth)
        return self.model.compute_loss(
            image=image, output_depth=output, ground_truth=ground_truth,
            lidar_map=lidar_map, loss_func=self.loss_func,
            w_smoothness=self.w_smoothness,
            loss_smoothness_kernel_size=self.loss_smoothness_kernel_size,
            validity_map_loss_smoothness=validity,
            w_lidar_loss=self.w_lidar_loss)


def make_forward_fn(model: FusionNetModel, transforms: Transforms):
    """The inference forward of full-resolution frames: (image, depth,
    response) NHWC transport tensors on the model's device -> depth
    (B, H, W) float32. Runs the model in eval mode (running statistics) and
    leaves its mode as it was."""

    @torch.inference_mode()
    def forward(image, depth, response):
        image, depth, response = (transport.decode(t)
                                  for t in (image, depth, response))
        image = transforms.transform(image).permute(0, 3, 1, 2).contiguous()
        input_depth = torch.cat([depth, response], -1).permute(
            0, 3, 1, 2).contiguous()
        with eval_mode(model):
            return model(image, input_depth)[:, 0].float()

    return forward


def iter_forward_outputs(forward_fn, dataset, eval_batch_size: int, device):
    """Drive ``forward_fn`` over an inference dataset in batches of
    ``eval_batch_size`` frames, yielding per frame (idx, the host sample
    decoded to float32, output depth (H, W) numpy) in order. The tail batch
    is padded by repeating its last sample; the padded outputs are
    dropped, so the per-frame results equal batch 1's."""
    n = len(dataset)
    bsz = max(1, min(eval_batch_size, n))
    for start in range(0, n, bsz):
        idxs = list(range(start, min(start + bsz, n)))
        samples = [dataset.get(i) for i in idxs]
        padded = samples + [samples[-1]] * (bsz - len(samples))
        streams = [torch.from_numpy(np.stack([s[j] for s in padded])).to(
            device) for j in range(3)]
        outputs = forward_fn(*streams).cpu().numpy()
        for j, idx in enumerate(idxs):
            yield idx, transport.decode_np(samples[j]), outputs[j]


def validate(forward_fn, dataset, step, best_results, min_evaluate_depth,
             max_evaluate_depth, summary_writer=None, log_path=None,
             eval_batch_size: int = 1, device='cuda'):
    """Full-resolution validation (reference src/fusionnet_main.py:476-606,
    rcfd_tpu/fusionnet_main.py ``validate``): the mean MAE, RMSE, iMAE and
    iRMSE over the frames, logged with the best so far; the best moves to
    this step when at least 3 of the 4 metrics, rounded to 2 decimals, are
    no worse. Returns the best results."""
    n_sample = len(dataset)
    metrics = {k: np.zeros(n_sample) for k in ('mae', 'rmse', 'imae',
                                                'irmse')}
    for idx, sample, output_depth in iter_forward_outputs(
            forward_fn, dataset, eval_batch_size, device):
        m = eval_utils.compute_all(output_depth, sample[3][..., 0],
                                   min_evaluate_depth, max_evaluate_depth)
        for k in metrics:
            metrics[k][idx] = m[k]
    mae, rmse, imae, irmse = (np.mean(metrics[k]) for k in
                              ('mae', 'rmse', 'imae', 'irmse'))
    if summary_writer is not None:
        for k, v in (('mae', mae), ('rmse', rmse), ('imae', imae),
                     ('irmse', irmse)):
            summary_writer.add_scalar('eval-' + k, v, global_step=step)
    log_evaluation_results('Validation results', mae, rmse, imae, irmse,
                           step, log_path)
    n_improve = sum(int(np.round(v, 2) <= np.round(best_results[k], 2))
                    for k, v in (('mae', mae), ('rmse', rmse),
                                 ('imae', imae), ('irmse', irmse)))
    if n_improve > 2:
        best_results.update({'step': step, 'mae': mae, 'rmse': rmse,
                             'imae': imae, 'irmse': irmse})
    log_evaluation_results(
        'Best results', best_results['mae'], best_results['rmse'],
        best_results['imae'], best_results['irmse'], best_results['step'],
        log_path)
    return best_results


def train(train_image_path, train_depth_path, train_response_path,
          train_ground_truth_path, train_lidar_map_path, val_image_path,
          val_depth_path, val_response_path, val_ground_truth_path,
          # Batch settings
          batch_size, n_height, n_width,
          # Input settings
          input_channels_image, input_channels_depth, normalized_image_range,
          # Network settings
          encoder_type, n_filters_encoder_image, n_filters_encoder_depth,
          fusion_type, decoder_type, n_filters_decoder, n_resolutions_decoder,
          min_predict_depth, max_predict_depth,
          # Weight settings
          weight_initializer, activation_func,
          # Training settings
          learning_rates, learning_schedule,
          # Loss settings
          loss_func, w_smoothness, w_lidar_loss, w_weight_decay,
          loss_smoothness_kernel_size, outlier_removal_kernel_size,
          outlier_removal_threshold, ground_truth_dilation_kernel_size,
          # Augmentation settings
          augmentation_probabilities, augmentation_schedule,
          augmentation_random_crop_type, augmentation_random_brightness,
          augmentation_random_contrast, augmentation_random_saturation,
          augmentation_random_flip_type,
          # Evaluation settings
          min_evaluate_depth, max_evaluate_depth,
          # Checkpoint settings
          checkpoint_dirpath, n_step_per_checkpoint, n_step_per_summary,
          start_step_validation, restore_path,
          # Hardware settings
          device=None, n_thread=8, n_data_parallel: Optional[int] = None,
          eval_batch_size: int = 1, seed: int = 0,
          timings: Optional[list] = None):
    """The training loop (reference src/fusionnet_main.py:13-474,
    rcfd_tpu/fusionnet_main.py ``train``), on ``device`` (``cuda`` unless
    ``device='cpu'``): per-epoch learning-rate and augmentation schedules,
    a checkpoint ``model-<step>.pth`` every ``n_step_per_checkpoint``
    steps, validation at those steps from ``start_step_validation`` on,
    and a last validation and checkpoint at the end. ``restore_path``
    'latest' restores the newest checkpoint of ``checkpoint_dirpath``.
    ``timings``, a list, receives a dict per step: the step's milliseconds
    (the card synchronized after it, which it then is every step) and the
    host's wait for its batch. Returns the best validation results."""
    refuse_unported(device, n_data_parallel)
    device = default_device(device)
    os.makedirs(checkpoint_dirpath, exist_ok=True)
    checkpoint_path = os.path.join(checkpoint_dirpath, 'model-{}.pth')
    log_path = os.path.join(checkpoint_dirpath, 'results.txt')
    event_path = os.path.join(checkpoint_dirpath, 'events')
    best_results = {'step': -1, 'mae': np.inf, 'rmse': np.inf,
                    'imae': np.inf, 'irmse': np.inf}

    train_paths = [data_utils.read_paths(p) for p in (
        train_image_path, train_depth_path, train_response_path,
        train_ground_truth_path, train_lidar_map_path)]
    n_train_sample = len(train_paths[0])
    assert all(len(p) == n_train_sample for p in train_paths)
    steps_per_epoch = n_train_sample // batch_size
    n_train_step = int(learning_schedule[-1] *
                       np.ceil(n_train_sample / batch_size))

    train_loader = DataLoader(
        FusionNetTrainingDataset(*train_paths, shape=(n_height, n_width),
                                 random_crop_type=augmentation_random_crop_type,
                                 device=device),
        batch_size=batch_size, shuffle=True, num_workers=n_thread, seed=seed,
        drop_last=True)
    train_transforms = Transforms(
        normalized_image_range=normalized_image_range,
        random_brightness=augmentation_random_brightness,
        random_contrast=augmentation_random_contrast,
        random_saturation=augmentation_random_saturation,
        random_flip_type=augmentation_random_flip_type)
    val_paths = [data_utils.read_paths(p) for p in (
        val_image_path, val_depth_path, val_response_path,
        val_ground_truth_path)]
    assert all(len(p) == len(val_paths[0]) for p in val_paths)
    val_dataset = FusionNetInferenceDataset(*val_paths, device=device)

    model = build_model(
        input_channels_image, input_channels_depth, encoder_type,
        n_filters_encoder_image, n_filters_encoder_depth, fusion_type,
        decoder_type, n_resolutions_decoder, n_filters_decoder,
        weight_initializer, activation_func, min_predict_depth,
        max_predict_depth, device='cpu')
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model, learning_rates[0], w_weight_decay)

    train_step = 0
    if restore_path == 'latest':
        restore_path = find_latest_checkpoint(checkpoint_dirpath)
        log('Auto-resume from: {}'.format(restore_path), log_path)
    if restore_path:
        train_step, opt_sd = model.restore_checkpoint(
            restore_path, device=device, return_optimizer_state=True)
        if opt_sd:
            try:
                optimizer.load_state_dict(opt_sd)
            except Exception as e:
                log('Could not restore optimizer state ({}); '
                    'reinitializing'.format(e), log_path)

    step_fn = TrainStep(
        model, train_transforms, optimizer, loss_func, w_smoothness,
        w_lidar_loss, loss_smoothness_kernel_size,
        outlier_removal_kernel_size, outlier_removal_threshold,
        ground_truth_dilation_kernel_size)
    forward_fn = make_forward_fn(
        model, Transforms(normalized_image_range=normalized_image_range))
    train_summary_writer = SummaryWriter(event_path + '-train')
    val_summary_writer = SummaryWriter(event_path + '-val')
    log('Tensorboard summaries: {} ({})'.format(
        'enabled' if train_summary_writer.enabled else 'DISABLED',
        event_path), log_path)
    log_training_banner(
        log_path, model=model, batch_size=batch_size,
        n_train_sample=n_train_sample, n_train_step=n_train_step,
        learning_rates=learning_rates, learning_schedule=learning_schedule,
        encoder_type=encoder_type, decoder_type=decoder_type,
        fusion_type=fusion_type, loss_func=loss_func, n_devices=1)

    generator = torch.Generator(device=device)
    done = train_step  # steps restored from the checkpoint
    time_start = time.time()

    def run_validation():
        nonlocal best_results
        best_results = validate(
            forward_fn, val_dataset, train_step, best_results,
            min_evaluate_depth, max_evaluate_depth, val_summary_writer,
            log_path, eval_batch_size, device)

    with training_numerics():
        log(numerics_line())
        log('Begin training...', log_path)
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
                loss_info = step_fn(batch, draws, learning_rate)
                if timings is not None:
                    timings.append(step_timing(device, train_step, t0,
                                               wait_ms, loss_info['loss']))
                if train_step % n_step_per_summary == 0:
                    for name, value in loss_info.items():
                        train_summary_writer.add_scalar(
                            'train-' + name, float(value),
                            global_step=train_step)
                if train_step % n_step_per_checkpoint == 0:
                    loss_value = float(loss_info['loss'])
                    elapsed = time.time() - time_start
                    steps_per_s = (train_step - done) / max(elapsed, 1e-6)
                    log('Step={:6}/{}  Loss={:.5f}  Time Elapsed={:.2f}h  '
                        'Time Remaining={:.2f}h  {:.2f} steps/s '
                        '({:.1f} samples/s)'.format(
                            train_step, n_train_step, loss_value,
                            elapsed / 3600,
                            (n_train_step - train_step) /
                            max(steps_per_s, 1e-9) / 3600,
                            steps_per_s, steps_per_s * batch_size), log_path)
                    if train_step >= start_step_validation:
                        run_validation()
                    model.save_checkpoint(
                        checkpoint_path.format(train_step), train_step,
                        optimizer.state_dict())
        run_validation()
        model.save_checkpoint(checkpoint_path.format(train_step), train_step,
                              optimizer.state_dict())
    train_summary_writer.close()
    val_summary_writer.close()
    return best_results


'''
Logging helpers
'''


def log_evaluation_results(title, mae, rmse, imae, irmse, step,
                           log_path=None):
    log('{}:'.format(title), log_path)
    log('{:>8}  {:>8}  {:>8}  {:>8}  {:>8}'.format(
        'Step', 'MAE', 'RMSE', 'iMAE', 'iRMSE'), log_path)
    log('{:8}  {:8.3f}  {:8.3f}  {:8.3f}  {:8.3f}'.format(
        step, mae, rmse, imae, irmse), log_path)


def log_training_banner(log_path, model, batch_size, n_train_sample,
                        n_train_step, learning_rates, learning_schedule,
                        encoder_type, decoder_type, fusion_type, loss_func,
                        n_devices):
    log('Network settings:', log_path)
    log('encoder_type={}  decoder_type={}  fusion_type={}'.format(
        encoder_type, decoder_type, fusion_type), log_path)
    log('n_parameters={}'.format(model.n_parameters()), log_path)
    log('', log_path)
    log('Training settings:', log_path)
    log('batch_size={}  n_train_sample={}  n_train_step={}  n_devices={}'
        .format(batch_size, n_train_sample, n_train_step, n_devices),
        log_path)
    log('learning_rates={}  learning_schedule={}  loss_func={}'.format(
        learning_rates, learning_schedule, loss_func), log_path)
    log('', log_path)
