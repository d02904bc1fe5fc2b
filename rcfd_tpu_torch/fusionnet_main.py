"""FusionNet training and validation on one card or several (counterpart of
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
computes in float32 with TF32 off (``training_numerics``), or under
RCFD_TRAIN_DTYPE=bfloat16 in mixed precision as the JAX package does: the
image and the input depth (depth, response) are cast to bf16, so the
network computes in bf16 from bf16 copies of the float32 master weights;
the ground truth, its dilation and outlier removal, the validity maps, the
losses, the gradients in the masters and Adam's state stay float32.

Every ``n_step_per_summary`` steps the loop writes the loss scalars, the
image panel and two histograms (``log_image_summary``) to TensorBoard.
RCFD_PROFILE_DIR and RCFD_PROFILE_STEPS trace a window of steps with
torch.profiler (utils/profiling.py ``TraceWindow``).

Data parallelism (``n_data_parallel``; rcfd_tpu_torch/parallel/mesh.py):
the loop starts one rank per card (gloo ranks on the CPU), each takes its
contiguous slice of the global batch and draws its augmentation for its
slice from the step's seed (every rank the same draws, as every JAX shard
draws from the replicated key), the gradients, running statistics and
loss_info are averaged before Adam, and rank 0 alone validates, writes
summaries and checkpoints while the others wait. ``device='tpu'`` is
refused with a message.

A run restored at step s resumes at step s + 1 (rcfd_tpu_torch/training.py
says how this differs from the JAX training loop).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device, parallel
from .data import io as data_utils
from .data import transport
from .data.datasets import FusionNetInferenceDataset, FusionNetTrainingDataset
from .data.loader import DataLoader, device_prefetch
from .data.transforms import Transforms
from .models.fusionnet import FusionNetModel
from .nn import functional as NF
from .nn.layers import init_parameters
from .nn.optimize import fold_batch_norm
from .pipeline import encode_depth, serving_numerics
from .training import (OptimizerStep, data_parallel_count, epochs,
                       eval_mode, launch_ranks, make_optimizer,
                       numerics_line, quiet, refuse_unported, step_seed,
                       step_timing, timed, train_dtype, training_numerics)
from .utils import eval_utils
from .utils.checkpoint import find_latest_checkpoint
from .utils.log_utils import colorize, log
from .utils.profiling import TraceWindow
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
    it. The step's dtype is ``training.train_dtype()``'s when it is
    built."""

    def __init__(self, model: FusionNetModel, transforms: Transforms,
                 optimizer: torch.optim.Optimizer, loss_func: str,
                 w_smoothness: float, w_lidar_loss: float,
                 loss_smoothness_kernel_size: int, outlier_kernel_size: int,
                 outlier_threshold: float, dilation_kernel_size: int):
        self.compute_dtype = train_dtype()
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
        validity_map_loss_smoothness), NCHW; the image and the input depth
        in the step's dtype."""
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
        image = image.contiguous()
        input_depth = torch.cat([depth, response], 1).contiguous()
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)
            input_depth = input_depth.to(self.compute_dtype)
        return image, input_depth, ground_truth, lidar_map, validity

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


def make_forward_fn(model: FusionNetModel, transforms: Transforms,
                    codec_encode: bool = False):
    """The inference forward of full-resolution frames
    (rcfd_tpu/fusionnet_main.py ``make_forward_fn``): (image, depth,
    response) NHWC transport tensors on the model's device -> depth
    (B, H, W) float32, or with ``codec_encode`` its 16-bit PNG codes
    (uint16 floor(z * 256), made on the device: half the bytes to copy to
    the host, the same files). The normalized image and the input depth are
    cast to the dtype of the model's parameters (bf16 for a model cast to
    it). Runs the model in eval mode (running statistics) and leaves its
    mode as it was."""
    dtype = next(model.parameters()).dtype

    @torch.inference_mode()
    def forward(image, depth, response):
        image, depth, response = (transport.decode(t)
                                  for t in (image, depth, response))
        image = transforms.transform(image).permute(0, 3, 1, 2).contiguous()
        input_depth = torch.cat([depth, response], -1).permute(
            0, 3, 1, 2).contiguous()
        with eval_mode(model):
            output = model(image.to(dtype), input_depth.to(dtype))[:, 0]
        return encode_depth(output) if codec_encode else output.float()

    return forward


def iter_forward_outputs(forward_fn, dataset, eval_batch_size: int, device,
                         seconds: Optional[dict] = None):
    """Drive ``forward_fn`` over an inference dataset in batches of
    ``eval_batch_size`` frames, yielding per frame (idx, the host sample
    decoded to float32, output depth (H, W) numpy) in order. The tail batch
    is padded by repeating its last sample; the padded outputs are
    dropped, so the per-frame results equal batch 1's. ``seconds``, a
    dict, gains the host's reads under 'read' and the forward up to the
    outputs on the host under 'serve'."""
    seconds = {} if seconds is None else seconds
    n = len(dataset)
    bsz = max(1, min(eval_batch_size, n))
    for start in range(0, n, bsz):
        t0 = time.perf_counter()
        idxs = list(range(start, min(start + bsz, n)))
        samples = [dataset.get(i) for i in idxs]
        padded = samples + [samples[-1]] * (bsz - len(samples))
        streams = [torch.from_numpy(np.stack([s[j] for s in padded])).to(
            device) for j in range(3)]
        t1 = time.perf_counter()
        outputs = forward_fn(*streams).cpu().numpy()
        seconds['read'] = seconds.get('read', 0.0) + t1 - t0
        seconds['serve'] = seconds.get('serve', 0.0) + \
            time.perf_counter() - t1
        for j, idx in enumerate(idxs):
            yield idx, transport.decode_np(samples[j]), outputs[j]


def log_image_summary(writer, tag: str, step: int, forward_fn, batch,
                      max_depth: float, n_display: int = 4):
    """The distributions of the output depth and of the ground truth of
    the first ``n_display`` samples of a training batch, and, where
    ``colorize`` has matplotlib, their panel: a row each of the images,
    the input depths, the output depths and the ground truths, the depths
    colorized over [0, ``max_depth``] (rcfd_tpu/fusionnet_main.py
    ``_log_image_summary``). ``forward_fn`` is ``make_forward_fn``'s, on
    the loader's (image, depth, response, ground_truth, lidar_map)
    batch."""
    if not writer.enabled:
        return
    output = forward_fn(*(t[:n_display] for t in batch[:3])).cpu().numpy()
    image, depth, _, ground_truth = transport.decode_np(
        [t[:n_display].cpu().numpy() for t in batch[:4]])
    writer.add_histogram(tag + '-output_depth_distro', output,
                         global_step=step)
    writer.add_histogram(tag + '-ground_truth_distro', ground_truth,
                         global_step=step)
    try:
        rows = [np.clip(image / 255.0, 0, 1)] + [
            colorize(t / max_depth, 'viridis')
            for t in (depth, output, ground_truth)]
    except ImportError:
        return
    panel = np.concatenate([np.concatenate(list(r), axis=1) for r in rows],
                           axis=0)
    writer.add_image(tag + '-image-depth-output-gt', panel, global_step=step)


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
    host's wait for its batch (with data parallelism, each rank's, with
    its ``rank``).

    ``n_data_parallel`` ranks (``training.data_parallel_count``: None is
    every visible card, one rank on the CPU) share the global
    ``batch_size``; above 1 the loop starts them (``launch_ranks``), or,
    called inside a process group (``parallel.run_ranks``), takes this
    rank's part. Returns the best validation results."""
    arguments = dict(locals())
    refuse_unported(device)
    device = default_device(device)
    layout = parallel.maybe_initialize_distributed()
    world = data_parallel_count(device, n_data_parallel, batch_size, layout)
    if world > parallel.world_size():
        return launch_ranks(train, arguments, world, device, layout)
    lead = parallel.is_lead()
    say = log if lead else quiet
    os.makedirs(checkpoint_dirpath, exist_ok=True)
    checkpoint_path = os.path.join(checkpoint_dirpath, 'model-{}.pth')
    # only rank 0 writes the results file
    log_path = os.path.join(checkpoint_dirpath, 'results.txt') if lead \
        else None
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
        drop_last=True, process_index=parallel.rank(), process_count=world)
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
        say('Auto-resume from: {}'.format(restore_path), log_path)
    if restore_path:
        train_step, opt_sd = model.restore_checkpoint(
            restore_path, device=device, return_optimizer_state=True)
        if opt_sd:
            try:
                optimizer.load_state_dict(opt_sd)
            except Exception as e:
                say('Could not restore optimizer state ({}); '
                    'reinitializing'.format(e), log_path)
    if world > 1:
        parallel.broadcast_module(model)  # replicas of rank 0's weights

    step_fn = TrainStep(
        model, train_transforms, optimizer, loss_func, w_smoothness,
        w_lidar_loss, loss_smoothness_kernel_size,
        outlier_removal_kernel_size, outlier_removal_threshold,
        ground_truth_dilation_kernel_size)
    if world > 1:
        step_fn = parallel.data_parallel_step(step_fn)
    forward_fn = make_forward_fn(
        model, Transforms(normalized_image_range=normalized_image_range))
    train_summary_writer = SummaryWriter(event_path + '-train', enabled=lead)
    val_summary_writer = SummaryWriter(event_path + '-val', enabled=lead)
    say('Tensorboard summaries: {} ({})'.format(
        'enabled' if train_summary_writer.enabled else 'DISABLED',
        event_path), log_path)
    if lead:
        log_training_banner(
            log_path, model=model, batch_size=batch_size,
            n_train_sample=n_train_sample, n_train_step=n_train_step,
            learning_rates=learning_rates,
            learning_schedule=learning_schedule, encoder_type=encoder_type,
            decoder_type=decoder_type, fusion_type=fusion_type,
            loss_func=loss_func, n_devices=world)

    generator = torch.Generator(device=device)
    done = train_step  # steps restored from the checkpoint
    time_start = time.time()
    trace_window = TraceWindow(device, enabled=lead)

    def run_validation():
        """Rank 0 alone validates: the parameters are replicated."""
        nonlocal best_results
        if lead:
            best_results = validate(
                forward_fn, val_dataset, train_step, best_results,
                min_evaluate_depth, max_evaluate_depth, val_summary_writer,
                log_path, eval_batch_size, device)

    def save_checkpoint():
        if lead:
            model.save_checkpoint(checkpoint_path.format(train_step),
                                  train_step, optimizer.state_dict())
        parallel.barrier()

    with training_numerics():
        say(numerics_line(step_fn.compute_dtype))
        say('Begin training...', log_path)
        for epoch, start, learning_rate, augmentation_probability in epochs(
                learning_rates, learning_schedule, augmentation_probabilities,
                augmentation_schedule, done, steps_per_epoch):
            train_loader.set_epoch(epoch, start_batch=start)
            for batch, wait_ms, t0 in timed(device_prefetch(train_loader,
                                                             device)):
                train_step += 1
                # every rank the same draws, for its own slice
                generator.manual_seed(step_seed(seed, train_step))
                draws = train_transforms.draws(
                    generator, batch_size // world, augmentation_probability)
                loss_info = step_fn(batch, draws, learning_rate)
                if timings is not None:
                    timings.append(step_timing(device, train_step, t0,
                                               wait_ms, loss_info['loss']))
                trace_window.after_step(train_step)
                if train_step % n_step_per_summary == 0:
                    for name, value in loss_info.items():
                        train_summary_writer.add_scalar(
                            'train-' + name, float(value),
                            global_step=train_step)
                    log_image_summary(train_summary_writer, 'train',
                                      train_step, forward_fn, batch,
                                      max_predict_depth)
                if train_step % n_step_per_checkpoint == 0:
                    loss_value = float(loss_info['loss'])
                    elapsed = time.time() - time_start
                    steps_per_s = (train_step - done) / max(elapsed, 1e-6)
                    say('Step={:6}/{}  Loss={:.5f}  Time Elapsed={:.2f}h  '
                        'Time Remaining={:.2f}h  {:.2f} steps/s '
                        '({:.1f} samples/s)'.format(
                            train_step, n_train_step, loss_value,
                            elapsed / 3600,
                            (n_train_step - train_step) /
                            max(steps_per_s, 1e-9) / 3600,
                            steps_per_s, steps_per_s * batch_size), log_path)
                    if train_step >= start_step_validation:
                        run_validation()
                    save_checkpoint()
        trace_window.close()
        run_validation()
        save_checkpoint()
    train_summary_writer.close()
    val_summary_writer.close()
    return parallel.broadcast_object(best_results) if world > 1 \
        else best_results


def load_model(restore_path, input_channels_image, input_channels_depth,
               encoder_type, n_filters_encoder_image, n_filters_encoder_depth,
               fusion_type, decoder_type, n_resolutions_decoder,
               n_filters_decoder, weight_initializer, activation_func,
               min_predict_depth, max_predict_depth, device,
               compute_dtype=None):
    """FusionNet for inference from a checkpoint, as the JAX package's
    ``run`` builds it (rcfd_tpu/fusionnet_main.py:706-721): the weights
    restored, every batch norm folded into its convolution, then cast to
    ``compute_dtype`` (None or torch.float32: float32). Returns (the model
    on ``device``, the checkpoint's train step)."""
    model = FusionNetModel(
        input_channels_image=input_channels_image,
        input_channels_depth=input_channels_depth, encoder_type=encoder_type,
        n_filters_encoder_image=n_filters_encoder_image,
        n_filters_encoder_depth=n_filters_encoder_depth,
        fusion_type=fusion_type, decoder_type=decoder_type,
        n_resolution_decoder=n_resolutions_decoder,
        n_filters_decoder=n_filters_decoder, deconv_type='up',
        activation_func=activation_func,
        weight_initializer=weight_initializer,
        min_predict_depth=min_predict_depth,
        max_predict_depth=max_predict_depth, device='cpu')
    step = model.restore_checkpoint(restore_path, device='cpu')
    model = fold_batch_norm(model).to(device, compute_dtype or torch.float32)
    return model, step


def run(restore_path, image_path, depth_path, response_path,
        ground_truth_path,
        # Input settings
        input_channels_image, input_channels_depth, normalized_image_range,
        # Network settings
        encoder_type, n_filters_encoder_image, n_filters_encoder_depth,
        fusion_type, decoder_type, n_filters_decoder, n_resolutions_decoder,
        min_predict_depth, max_predict_depth,
        # Weight settings
        weight_initializer, activation_func,
        # Output settings
        output_dirpath, save_outputs, keep_input_filenames, verbose=True,
        # Evaluation settings
        min_evaluate_depth=0.0, max_evaluate_depth=100.0,
        eval_batch_size: int = 8,
        # Hardware settings
        device=None, compute_dtype=None):
    """Inference and evaluation over a manifest (reference
    src/fusionnet_main.py:608-896, rcfd_tpu/fusionnet_main.py ``run``), on
    ``device`` (``cuda`` unless ``device='cpu'``), ``eval_batch_size``
    frames a forward, FusionNet folded (``load_model``) in
    ``compute_dtype``, under the serving numerics. With ground truth the
    mean MAE, RMSE, iMAE and iRMSE go to results.txt; with
    ``save_outputs`` the image, ground truth, output depth and the input
    depth and response go to PNGs, the output depth as 16-bit codes made
    on the device when there is no ground truth (the same files). Returns
    (the metrics or None, seconds) with seconds the setup, the host's
    reads, the serving (to the outputs on the host) and the rest (metrics
    and writes)."""
    t_start = time.perf_counter()
    device = default_device(device)
    os.makedirs(output_dirpath, exist_ok=True)
    log_path = os.path.join(output_dirpath, 'results.txt')

    image_paths = data_utils.read_paths(image_path)
    depth_paths = data_utils.read_paths(depth_path)
    response_paths = data_utils.read_paths(response_path)
    n_sample = len(image_paths)
    ground_truth_available = ground_truth_path is not None and \
        os.path.exists(ground_truth_path)
    ground_truth_paths = data_utils.read_paths(ground_truth_path) \
        if ground_truth_available else None
    dataset = FusionNetInferenceDataset(
        image_paths, depth_paths, response_paths, ground_truth_paths,
        device=device)
    if save_outputs:
        output_dirs = {name: os.path.join(output_dirpath, name) for name in (
            'image', 'ground_truth', 'output_depth_fusion',
            'output_depth_radar', 'output_response_radar')}
        for dirpath in output_dirs.values():
            os.makedirs(dirpath, exist_ok=True)
    model, step = load_model(
        restore_path, input_channels_image, input_channels_depth,
        encoder_type, n_filters_encoder_image, n_filters_encoder_depth,
        fusion_type, decoder_type, n_resolutions_decoder, n_filters_decoder,
        weight_initializer, activation_func, min_predict_depth,
        max_predict_depth, device, compute_dtype)
    # passes that only write PNGs (no eval) fetch the uint16 codec grid:
    # half the device-to-host bytes, the same files; eval passes keep
    # float32 so that the metrics run on unquantized maps
    codec_d2h = bool(save_outputs) and not ground_truth_available
    forward_fn = make_forward_fn(
        model, Transforms(normalized_image_range=normalized_image_range),
        codec_encode=codec_d2h)
    log('Gates: RCFD_COMPUTE_DTYPE {}'.format(
        'bfloat16' if compute_dtype == torch.bfloat16 else 'float32'))

    log('Evaluation input paths:', log_path)
    for p in [image_path, depth_path, response_path] + \
            ([ground_truth_path] if ground_truth_available else []):
        log(str(p), log_path)
    log('', log_path)

    metrics = {k: np.zeros(n_sample) for k in ('mae', 'rmse', 'imae',
                                                'irmse')}
    seconds = dict(setup=time.perf_counter() - t_start, read=0.0, serve=0.0)
    t_loop = time.perf_counter()
    with serving_numerics():
        for idx, sample, output_depth in iter_forward_outputs(
                forward_fn, dataset, eval_batch_size, device, seconds):
            image, depth, response = sample[:3]
            if verbose:
                print('Processed {}/{} samples'.format(idx + 1, n_sample),
                      end='\r')
            if ground_truth_available:
                gt = sample[3][..., 0]
                m = eval_utils.compute_all(output_depth, gt,
                                           min_evaluate_depth,
                                           max_evaluate_depth)
                for k in metrics:
                    metrics[k][idx] = m[k]
            if save_outputs:
                filename = (os.path.splitext(os.path.basename(
                    image_paths[idx]))[0] + '.png') if keep_input_filenames \
                    else '{:010d}.png'.format(idx)
                data_utils.save_image(image / 255.0, os.path.join(
                    output_dirs['image'], filename))
                fusion_path = os.path.join(
                    output_dirs['output_depth_fusion'], filename)
                if codec_d2h:
                    data_utils.save_depth_encoded(output_depth, fusion_path)
                else:
                    data_utils.save_depth(output_depth, fusion_path)
                data_utils.save_depth(depth[..., 0], os.path.join(
                    output_dirs['output_depth_radar'], filename))
                data_utils.save_response(response[..., 0], os.path.join(
                    output_dirs['output_response_radar'], filename))
                if ground_truth_available:
                    data_utils.save_depth(gt, os.path.join(
                        output_dirs['ground_truth'], filename))
    seconds['write'] = time.perf_counter() - t_loop - seconds['read'] - \
        seconds['serve']

    results = None
    if ground_truth_available:
        results = {k: float(np.mean(v)) for k, v in metrics.items()}
        log_evaluation_results('Evaluation results', results['mae'],
                               results['rmse'], results['imae'],
                               results['irmse'], step, log_path)
    return results, seconds


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
