"""RadarNet training and scatter inference on one card or several
(counterpart of rcfd_tpu/radarnet_main.py ``_make_train_step``,
``_make_summary_forward``, ``make_forward_fn``, ``make_forward_fn_batched``,
``iter_scatter_outputs``, ``train``, ``validate``, ``run`` and
``log_evaluation_results``; reference src/radarnet_main.py).

A train step decodes the integer transport batch (the edge-padded frames'
bottom rows, K radar points a frame, their boxes and ground-truth crops) on
the card, augments it (``Transforms.draws`` from a torch.Generator seeded
by ``step_seed``, then ``apply`` and ``noise_points``: the label crops flip
with the image, the boxes are fixed up, the points are not flipped), labels
each crop pixel by |gt - z| < tau where gt > 0, runs RadarNet in training
mode on the B*K points (batch norm by the batch's statistics; the column
crop kernel K2 with its gradient at a patch width that is not a multiple of
32), computes the masked positive-weighted BCE, back-propagates and takes an
Adam step. It computes in float32 with TF32 off (``training_numerics``),
or under RCFD_TRAIN_DTYPE=bfloat16 in mixed precision as the JAX package
does: the image is cast to bf16, and only the image (the points are pixel
coordinates up to about 1900, which bf16 quantizes in steps of 8), so the
image encoder and the decoder compute in bf16 from bf16 copies of the
float32 master weights, the point MLP in float32; labels, validity, the
loss, the gradients in the masters and Adam's state stay float32.

Validation is scatter inference (``make_forward_fn_batched``): the frames'
per-point response crops scattered into quasi-dense depth by the route of
``scatter_route`` (by default the scatter kernel K1 on the card, the exact
max on the CPU), scored by the intersection metrics, with the best step
chosen by a vote of 4 of 5. ``run`` is the same scatter inference over a
manifest from a checkpoint (the CLI ``python -m
rcfd_tpu_torch.run_radarnet``), with RadarNet's batch norm folded, in
float32 or bf16, writing the outputs as PNGs and the metrics to
results.txt.

RCFD_PROFILE_DIR and RCFD_PROFILE_STEPS trace a window of train steps
with torch.profiler (utils/profiling.py ``TraceWindow``).

As in the JAX package, training writes no optimizer state into its
checkpoints (an empty ``radarnet_optimizer_state_dict``), so a restored run
starts Adam afresh. Data parallelism (``n_data_parallel``) is FusionNet's
(fusionnet_main.py says how): every rank runs the step on its slice, K2 and
its gradient included at a patch width that is not a multiple of 32, and
rank 0 alone validates (K1 under ``pallas_scatter=True``).
``device='tpu'`` is refused with a message. A run restored at step s
resumes at step s + 1 (rcfd_tpu_torch/training.py says how this differs
from the JAX training loop).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device, native, parallel
from .data import io as data_utils
from .data import transport
from .data.datasets import RadarNetInferenceDataset, RadarNetTrainingDataset
from .data.loader import DataLoader, device_prefetch, iter_device_batches
from .data.transforms import Transforms
from .models.radarnet import RadarNetModel
from .nn.layers import init_parameters
from .nn.optimize import fold_batch_norm
from .nn.perf import PerfConfig
from .ops import scatter as exact_scatter
from .ops import scatter_cuda
from .pipeline import (decode_chunk_count, encode_depth, encode_response,
                       radarnet_crops, serving_numerics)
from .training import (OptimizerStep, data_parallel_count, epochs,
                       eval_mode, launch_ranks, make_optimizer,
                       numerics_line, quiet, refuse_unported, step_seed,
                       step_timing, timed, train_dtype, training_numerics)
from .utils import eval_utils
from .utils.checkpoint import find_latest_checkpoint
from .utils.log_utils import colorize, log
from .utils.profiling import TraceWindow
from .utils.summary import SummaryWriter

METRICS = ('mae_intersection', 'rmse_intersection', 'imae_intersection',
           'irmse_intersection')


def build_model(input_channels_image, input_channels_depth, patch_size,
                encoder_type, n_filters_encoder_image,
                n_neurons_encoder_depth, decoder_type, n_filters_decoder,
                weight_initializer, activation_func, device, perf=None):
    """A trainable RadarNet (rcfd_tpu/radarnet_main.py ``_build_model``);
    ``perf`` (a PerfConfig) as RadarNetModel takes it."""
    return RadarNetModel(
        input_channels_image=input_channels_image,
        input_channels_depth=input_channels_depth,
        input_patch_size_image=tuple(patch_size), encoder_type=encoder_type,
        n_filters_encoder_image=n_filters_encoder_image,
        n_neurons_encoder_depth=n_neurons_encoder_depth,
        decoder_type=decoder_type, n_filters_decoder=n_filters_decoder,
        weight_initializer=weight_initializer,
        activation_func=activation_func, device=device, perf=perf,
        trainable=True)


def correspondence_labels(ground_truth, z, max_distance_correspondence):
    """1 where the ground truth lies within ``max_distance_correspondence``
    of the point's depth z, else 0, and 0 where there is no ground truth
    (src/radarnet_main.py:354-378)."""
    label = ((ground_truth - z).abs() < max_distance_correspondence) & \
        (ground_truth > 0)
    return label.to(ground_truth.dtype)


class TrainStep(OptimizerStep):
    """One optimizer step of RadarNet on a batch (rcfd_tpu/radarnet_main.py
    ``_make_train_step``). ``batch`` is the loader's (image, points, boxes,
    ground_truth) on the model's device, in the integer transport or
    float: image (B, ph, W + 2 pad, 3), points (B, K, 3), boxes (B, K, 4),
    ground truth (B, K, ph, pw, 1). ``draws`` is ``transforms.draws(...,
    points_shape=(B, K, 3))`` for it. The step's dtype is
    ``training.train_dtype()``'s when it is built."""

    def __init__(self, model: RadarNetModel, transforms: Transforms,
                 optimizer: torch.optim.Optimizer, patch_size,
                 max_distance_correspondence: float,
                 set_invalid_to_negative_class: bool,
                 w_positive_class: float):
        self.compute_dtype = train_dtype()
        self.model = model
        self.transforms = transforms
        self.optimizer = optimizer
        self.patch_size = tuple(patch_size)
        self.max_distance_correspondence = max_distance_correspondence
        self.set_invalid_to_negative_class = set_invalid_to_negative_class
        self.w_positive_class = w_positive_class

    def inputs(self, batch, draws):
        """Decode and augment the batch and label its crops: (image NCHW in
        the step's dtype, points (B*K, 3), x1 (B, K) from the boxes after
        the flip, labels and validity (B*K, 1, ph, pw))."""
        image, points, boxes, ground_truth = transport.decode(tuple(batch))
        image, (ground_truth,), (boxes,) = self.transforms.apply(
            draws, image, [ground_truth], [boxes])
        points = self.transforms.noise_points(draws, points)
        b, k = points.shape[0], points.shape[1]
        points = points.reshape(b * k, points.shape[2])
        ground_truth = ground_truth.reshape(
            b * k, *ground_truth.shape[2:]).permute(0, 3, 1, 2)
        label = correspondence_labels(
            ground_truth, points[:, 2].reshape(b * k, 1, 1, 1),
            self.max_distance_correspondence)
        if self.set_invalid_to_negative_class:
            validity = torch.ones_like(ground_truth)
        else:
            validity = (ground_truth > 0).to(ground_truth.dtype)
        # the network's image in NCHW memory: a permuted NHWC map is a
        # channels-last view, and on the CPU oneDNN's backward of a
        # convolution of a channels-last input corrupts memory
        image = image.permute(0, 3, 1, 2).contiguous()
        if self.compute_dtype is not None:
            image = image.to(self.compute_dtype)
        return (image, points.contiguous(),
                boxes[..., 0].contiguous(), label, validity)

    def loss(self, batch, draws):
        """The forward in the model's mode and the loss: (loss, loss_info)
        with the two summary scalars of src/radarnet_main.py:451-457."""
        image, points, x1, label, validity = self.inputs(batch, draws)
        logits = self.model(image, points, x1, box_height=self.patch_size[0])
        loss, loss_info = self.model.compute_loss(
            logits, label, validity, self.w_positive_class)
        with torch.no_grad():
            predicted = (torch.sigmoid(logits) > 0.5).to(label.dtype)
            loss_info['average_ground_truth_label_per_point'] = \
                label.sum((1, 2, 3)).mean()
            loss_info['average_predicted_label_per_point'] = \
                predicted.sum((1, 2, 3)).mean()
        return loss, loss_info


def summary_tensors(model: RadarNetModel, transforms: Transforms, batch,
                    max_distance_correspondence: float, n_display: int = 4):
    """The display tensors of the training summary for a batch
    (rcfd_tpu/radarnet_main.py ``_make_summary_forward``, reference
    src/radarnet_model.py:268-477): for the first ``n_display`` points, the
    image crop under each point's box, the response (eval mode, no
    augmentation), its label at 0.5, the ground-truth label and the
    validity, NHWC numpy arrays."""
    image, points, boxes, ground_truth = transport.decode(tuple(batch))
    image = transforms.transform(image)
    b, k = points.shape[0], points.shape[1]
    n = min(n_display, b * k)
    ph, pw = model.input_patch_size_image
    gt = ground_truth.reshape(b * k, *ground_truth.shape[2:])[:n]
    label = correspondence_labels(gt, points.reshape(b * k, 3)[:n, 2].reshape(
        n, 1, 1, 1), max_distance_correspondence)
    # each point's box, its start clamped into the image as JAX's
    # dynamic_slice clamps it
    x1 = boxes[..., 0].reshape(b * k)[:n].long().clamp(
        0, image.shape[2] - pw)
    crop_top = image.shape[1] - ph
    crops = torch.stack([image[i // k, crop_top:, x:x + pw]
                         for i, x in enumerate(x1.tolist())])
    with torch.no_grad(), eval_mode(model):
        response = model(image.permute(0, 3, 1, 2).contiguous(),
                         points.reshape(b * k, 3), boxes[..., 0].contiguous(),
                         box_height=ph, return_logits=False)
    response = response[:n].permute(0, 2, 3, 1)
    out = dict(image=crops, response=response,
               output_label=(response > 0.5).to(response.dtype),
               ground_truth_label=label, validity_map=(gt > 0).to(gt.dtype))
    return {key: v.float().cpu().numpy() for key, v in out.items()}


def log_image_summary(writer, tag: str, step: int, tensors):
    """The distributions of the response, the output label and the
    ground-truth label, and, where ``colorize`` has matplotlib, the
    montage (image | response | output label | label error | ground-truth
    label | validity) of rcfd_tpu/radarnet_main.py ``_log_image_summary``."""
    if not writer.enabled:
        return
    for name, key in (('-output_response_distro', 'response'),
                      ('-output_label_distro', 'output_label'),
                      ('_ground_truth_label_distro', 'ground_truth_label')):
        writer.add_histogram(tag + name, tensors[key], global_step=step)
    out_label, gt_label = tensors['output_label'], tensors['ground_truth_label']
    label_valid = (gt_label > 0).astype(np.float32)
    error = np.where(label_valid == 1.0, (np.abs(out_label - gt_label) +
                                          1e-8) / (gt_label + 1e-8),
                     label_valid)
    try:
        rows = [np.clip(tensors['image'], 0.0, 1.0)] + [
            colorize(t, 'inferno') for t in (
                tensors['response'], out_label, error, gt_label,
                tensors['validity_map'])]
    except ImportError:
        return
    panel = np.concatenate([np.concatenate(list(r), axis=1) for r in rows],
                           axis=0)
    writer.add_image(tag + '-image-output_response-output_label-error-'
                     'ground_truth_label-validity_map', panel,
                     global_step=step)


def scatter_route(pallas_scatter, device, k: int):
    """The scatter of RadarNet's scatter inference, JAX's rule
    (rcfd_tpu/radarnet_main.py:245-252, :311-315) with the card in the
    TPU's place: ``pallas_scatter`` when it is set, else the scatter kernel
    K1 (ops/scatter_cuda) on a CUDA device and the exact max (ops/scatter)
    on the CPU; the exact max where K1 cannot take k points a frame. The
    serving pipeline's default differs (the exact max everywhere, as
    rcfd_tpu/pipeline.py:88-92)."""
    use_kernel = pallas_scatter if pallas_scatter is not None else \
        torch.device(device).type == 'cuda'
    if use_kernel and k <= scatter_cuda.MAX_POINTS:
        return scatter_cuda
    return exact_scatter


def make_forward_fn_batched(model: RadarNetModel, transforms: Transforms,
                            image_height: int, image_width: int,
                            threshold: float = 0.5,
                            codec_encode: bool = False,
                            n_chunks: Optional[int] = None):
    """Scatter inference over B frames (rcfd_tpu/radarnet_main.py
    ``make_forward_fn_batched``): images (B, H, W, 3) in [0, 255] (uint8
    under integer transport), points (B, K, 3), valid (B, K) on the model's
    device -> depth_map, response_map (B, H, W) float32, or with
    ``codec_encode`` their 16-bit PNG codes (uint16 floor(z * 256) and
    floor(r * 2^14), made on the device: half the bytes to copy to the
    host, the same files). RadarNet runs in eval mode, its mode restored
    after, and decodes the B*K patches in ``n_chunks`` chunks when it is
    given, else in ``decode_chunk_count(B, K, model.perf.decode_chunks)``;
    the normalized image is cast to the dtype of the model's parameters (bf16
    for a model cast to it), the points never; the scatter is
    ``scatter_route``'s."""
    patch_size = model.input_patch_size_image
    dtype = next(model.parameters()).dtype

    @torch.inference_mode()
    def forward(images, points, valid):
        b, k = points.shape[0], points.shape[1]
        with eval_mode(model):
            _, crops, xs, zs = radarnet_crops(
                model, transforms, images, points, image_height,
                n_chunks or decode_chunk_count(b, k,
                                               model.perf.decode_chunks),
                dtype)
        route = scatter_route(model.perf.pallas_scatter, crops.device, k)
        depth_map, response_map = route.scatter_quasi_dense_batched(
            crops, xs, zs, valid.to(torch.bool), image_height=image_height,
            image_width=image_width, patch_size=patch_size,
            threshold=threshold)
        if codec_encode:
            return encode_depth(depth_map), encode_response(response_map)
        return depth_map, response_map

    return forward


def make_forward_fn(model: RadarNetModel, transforms: Transforms,
                    image_height: int, image_width: int,
                    threshold: float = 0.5):
    """Scatter inference over one frame (rcfd_tpu/radarnet_main.py
    ``make_forward_fn``): image (1, H, W, 3), points (K, 3), valid (K,) ->
    depth_map, response_map (H, W). The K patches decode at once, as
    JAX's, whatever ``model.perf.decode_chunks`` says."""
    batched = make_forward_fn_batched(
        model, transforms, image_height, image_width, threshold, n_chunks=1)

    def forward(image, points, valid):
        depth_map, response_map = batched(image, points[None], valid[None])
        return depth_map[0], response_map[0]

    return forward


def iter_scatter_outputs(forward_fn, dataset, eval_batch_size: int, device,
                         seconds: Optional[dict] = None):
    """Drive a batched scatter forward over a RadarNetInferenceDataset,
    yielding per frame (idx, the host sample decoded to float32, depth
    (H, W), response (H, W)) in order (rcfd_tpu/radarnet_main.py
    ``iter_scatter_outputs``). The host reads and copies batch i + 1 while
    the card works on batch i (``iter_device_batches``); the tail batch is
    padded by repeating its last sample, and the padded outputs dropped, so
    the per-frame results equal batch 1's. ``seconds``, a dict, gains the
    host's wait for each batch under 'read' and its forward up to the
    outputs on the host under 'serve'."""
    seconds = {} if seconds is None else seconds
    for (idxs, samples, (images, points, valid)), wait_ms, _ in timed(
            iter_device_batches(dataset, eval_batch_size, device,
                                fields=(0, 1, 2))):
        t0 = time.perf_counter()
        depth_b, response_b = (t.cpu().numpy() for t in forward_fn(
            images, points, valid))
        seconds['read'] = seconds.get('read', 0.0) + wait_ms / 1e3
        seconds['serve'] = seconds.get('serve', 0.0) + \
            time.perf_counter() - t0
        for j, idx in enumerate(idxs):
            yield idx, transport.decode_np(samples[j]), depth_b[j], \
                response_b[j]


def intersection_metrics(output_depth, gt, min_evaluate_depth,
                         max_evaluate_depth):
    """One frame's intersection metrics (src/radarnet_main.py:650-700):
    MAE, RMSE (mm), iMAE, iRMSE (1/km) over the pixels where the output and
    the ground truth both have depth within (min, max), then the counts of
    output, ground-truth and intersection pixels."""
    v_out = (output_depth > 0).astype(np.int32)
    v_gt = (gt > 0).astype(np.int32)
    v_inter = v_out * v_gt
    min_max = np.logical_and(gt > min_evaluate_depth, gt < max_evaluate_depth)
    mask = np.where(np.logical_and(v_inter, min_max) > 0)
    out_i, gt_i = output_depth[mask], gt[mask]
    return (eval_utils.mean_abs_err(1000.0 * out_i, 1000.0 * gt_i),
            eval_utils.root_mean_sq_err(1000.0 * out_i, 1000.0 * gt_i),
            eval_utils.inv_mean_abs_err(0.001 * out_i, 0.001 * gt_i),
            eval_utils.inv_root_mean_sq_err(0.001 * out_i, 0.001 * gt_i),
            v_out.sum(), v_gt.sum(), v_inter.sum())


def validate(forward_fn, dataset, step, best_results, min_evaluate_depth,
             max_evaluate_depth, summary_writer=None, log_path=None,
             eval_batch_size: int = 1, device='cuda'):
    """Scatter-inference validation with the intersection metrics
    (reference src/radarnet_main.py:593-787, rcfd_tpu/radarnet_main.py
    ``validate``): per frame MAE, RMSE, iMAE and iRMSE over the pixels
    where both the output and the ground truth have depth within (min,
    max), and the counts of output, ground-truth and intersection pixels;
    their means logged with the best so far. The best moves to this step
    when at least 4 of the 5 (the four errors no worse, the intersection
    count no lower, each rounded to 2 decimals) say so. Returns the best
    results."""
    n_sample = len(dataset)
    errors = {k: np.zeros(n_sample) for k in METRICS}
    n_valid = {k: np.zeros(n_sample) for k in ('output', 'gt', 'inter')}
    for idx, data, output_depth, response_map in iter_scatter_outputs(
            forward_fn, dataset, eval_batch_size, device):
        image, gt = data[0], data[3][..., 0]
        if idx == 0 and summary_writer is not None and summary_writer.enabled:
            try:
                panel = np.concatenate([
                    np.clip(image / 255.0, 0.0, 1.0),
                    colorize(response_map[None], 'inferno')[0],
                    colorize(output_depth[None] / 100.0, 'viridis')[0],
                    colorize(gt[None] / 100.0, 'viridis')[0]], axis=0)
                summary_writer.add_image(
                    'val-image-output_response-output_depth-ground_truth',
                    panel, global_step=step)
            except ImportError:
                pass
        *frame, n_out, n_gt, n_inter = intersection_metrics(
            output_depth, gt, min_evaluate_depth, max_evaluate_depth)
        for k, v in zip(METRICS, frame):
            errors[k][idx] = v
        n_valid['output'][idx], n_valid['gt'][idx], n_valid['inter'][idx] = \
            n_out, n_gt, n_inter

    means = {k: np.mean(v[~np.isnan(v)]) for k, v in errors.items()}
    n_valid_output, n_valid_gt, n_valid_inter = (
        np.mean(n_valid[k]) for k in ('output', 'gt', 'inter'))
    if summary_writer is not None:
        for k, v in list(means.items()) + [
                ('n_valid_points_output', n_valid_output),
                ('n_valid_points_intersection', n_valid_inter)]:
            summary_writer.add_scalar('eval-' + k, v, global_step=step)
    log_evaluation_results(
        'Validation results', *(means[k] for k in METRICS), n_valid_output,
        n_valid_inter, n_valid_gt, step, log_path)

    n_improve = sum(int(np.round(means[k], 2) <=
                        np.round(best_results[k], 2)) for k in METRICS)
    n_improve += int(np.round(n_valid_inter, 2) >=
                     np.round(best_results['n_valid_points_intersection'], 2))
    if n_improve > 3:
        best_results.update(means, step=step,
                            n_valid_points_output=n_valid_output,
                            n_valid_points_ground_truth=n_valid_gt,
                            n_valid_points_intersection=n_valid_inter)
    log_evaluation_results(
        'Best results', *(best_results[k] for k in METRICS),
        best_results['n_valid_points_output'],
        best_results['n_valid_points_intersection'],
        best_results['n_valid_points_ground_truth'], best_results['step'],
        log_path)
    return best_results


def train(train_image_path, train_radar_path, train_ground_truth_path,
          val_image_path, val_radar_path, val_ground_truth_path,
          # Batch settings
          batch_size, patch_size, total_points_sampled,
          sample_probability_of_lidar,
          # Input settings
          input_channels_image, input_channels_depth, normalized_image_range,
          # Network settings
          encoder_type, n_filters_encoder_image, n_neurons_encoder_depth,
          decoder_type, n_filters_decoder,
          # Weight settings
          weight_initializer, activation_func,
          # Training settings
          learning_rates, learning_schedule,
          # Augmentation settings
          augmentation_probabilities, augmentation_schedule,
          augmentation_random_brightness, augmentation_random_contrast,
          augmentation_random_saturation, augmentation_random_noise_type,
          augmentation_random_noise_spread, augmentation_random_flip_type,
          # Loss settings
          w_weight_decay, w_positive_class, max_distance_correspondence,
          set_invalid_to_negative_class,
          # Checkpoint settings
          checkpoint_dirpath, n_step_per_checkpoint, n_step_per_summary,
          start_step_validation, restore_path,
          # Evaluation settings
          min_evaluate_depth, max_evaluate_depth,
          # Hardware settings
          device=None, n_thread=8, n_data_parallel: Optional[int] = None,
          max_points_inference: int = 0, eval_batch_size: int = 1,
          seed: int = 0, perf=None, timings: Optional[list] = None):
    """The training loop (reference src/radarnet_main.py:18-532,
    rcfd_tpu/radarnet_main.py ``train``), on ``device`` (``cuda`` unless
    ``device='cpu'``): per-epoch learning-rate and augmentation schedules,
    a checkpoint ``model-<step>.pth`` every ``n_step_per_checkpoint``
    steps, validation at those steps from ``start_step_validation`` on,
    and a last validation and checkpoint at the end. ``restore_path``
    'latest' restores the newest checkpoint of ``checkpoint_dirpath``.
    ``perf`` is RadarNet's PerfConfig (its scatter and deferred pools
    apply to validation). ``timings``, a list, receives a dict per step:
    the step's milliseconds (the card synchronized after it, which it then
    is every step) and the host's wait for its batch (with data
    parallelism, each rank's, with its ``rank``). ``n_data_parallel`` is
    ``fusionnet_main.train``'s. Returns the best validation results."""
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
    best_results = dict({k: np.inf for k in METRICS}, step=-1,
                        n_valid_points_output=0,
                        n_valid_points_ground_truth=0,
                        n_valid_points_intersection=0)

    train_paths = [data_utils.read_paths(p) for p in (
        train_image_path, train_radar_path, train_ground_truth_path)]
    n_train_sample = len(train_paths[0])
    assert all(len(p) == n_train_sample for p in train_paths)
    steps_per_epoch = n_train_sample // batch_size
    n_train_step = int(learning_schedule[-1] *
                       np.ceil(n_train_sample / batch_size))

    train_loader = DataLoader(
        RadarNetTrainingDataset(
            *train_paths, patch_size=patch_size,
            total_points_sampled=total_points_sampled,
            sample_probability_of_lidar=sample_probability_of_lidar,
            device=device),
        batch_size=batch_size, shuffle=True, num_workers=n_thread, seed=seed,
        drop_last=True, process_index=parallel.rank(), process_count=world)
    train_transforms = Transforms(
        normalized_image_range=normalized_image_range,
        random_brightness=augmentation_random_brightness,
        random_contrast=augmentation_random_contrast,
        random_saturation=augmentation_random_saturation,
        random_noise_type=augmentation_random_noise_type,
        random_noise_spread=augmentation_random_noise_spread,
        random_flip_type=augmentation_random_flip_type)
    val_transforms = Transforms(normalized_image_range=normalized_image_range)
    val_paths = [data_utils.read_paths(p) for p in (
        val_image_path, val_radar_path, val_ground_truth_path)]
    val_dataset = RadarNetInferenceDataset(
        *val_paths, max_points=(max_points_inference
                                if max_points_inference and
                                max_points_inference > 0 else None),
        device=device)

    model = build_model(
        input_channels_image, input_channels_depth, patch_size, encoder_type,
        n_filters_encoder_image, n_neurons_encoder_depth, decoder_type,
        n_filters_decoder, weight_initializer, activation_func, device='cpu',
        perf=perf)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = make_optimizer(model, learning_rates[0], w_weight_decay)

    train_step = 0
    if restore_path == 'latest':
        restore_path = find_latest_checkpoint(checkpoint_dirpath)
        say('Auto-resume from: {}'.format(restore_path), log_path)
    if restore_path:
        # the JAX package's training saves an empty optimizer state, and a
        # restore of one starts Adam afresh
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

    step_fn = TrainStep(model, train_transforms, optimizer, patch_size,
                        max_distance_correspondence,
                        set_invalid_to_negative_class, w_positive_class)
    if world > 1:
        step_fn = parallel.data_parallel_step(step_fn)
    # validation frames are full frames, the size of the first
    if val_paths[0]:
        image_height, image_width = data_utils.load_image_u8(
            val_paths[0][0], device=device).shape[:2]
    else:
        image_height, image_width = 900, 1600
    forward_fn = make_forward_fn_batched(model, val_transforms, image_height,
                                         image_width)
    train_summary_writer = SummaryWriter(event_path + '-train', enabled=lead)
    val_summary_writer = SummaryWriter(event_path + '-val', enabled=lead)
    say('Tensorboard summaries: {} ({})'.format(
        'enabled' if train_summary_writer.enabled else 'DISABLED',
        event_path), log_path)
    say('Network: {} / {}  n_parameters={}'.format(
        encoder_type, decoder_type, model.n_parameters()), log_path)
    say('Training: batch_size={} patch_size={} K={} n_train_step={} '
        'n_devices={}'.format(batch_size, patch_size, total_points_sampled,
                              n_train_step, world), log_path)

    generator = torch.Generator(device=device)
    # every rank draws for its own slice, the same draws
    local_batch = batch_size // world
    points_shape = (local_batch, total_points_sampled, 3)
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
                                  train_step)
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
                generator.manual_seed(step_seed(seed, train_step))
                draws = train_transforms.draws(
                    generator, local_batch, augmentation_probability,
                    points_shape)
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
                    if train_summary_writer.enabled:
                        log_image_summary(
                            train_summary_writer, 'train', train_step,
                            summary_tensors(model, val_transforms, batch,
                                            max_distance_correspondence))
                if train_step % n_step_per_checkpoint == 0:
                    elapsed = (time.time() - time_start) / 3600
                    say('Step={:6}/{} Time Elapsed={:.2f}h  Time Remaining='
                        '{:.2f}h'.format(train_step, n_train_step, elapsed,
                                         (n_train_step - train_step) *
                                         elapsed / (train_step - done)),
                        log_path)
                    say('Loss={:.5f}'.format(float(loss_info['loss'])),
                        log_path)
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


def load_model(restore_path, patch_size, input_channels_image,
               input_channels_depth, encoder_type, n_filters_encoder_image,
               n_neurons_encoder_depth, decoder_type, n_filters_decoder,
               weight_initializer, activation_func, device, perf=None,
               compute_dtype=None):
    """RadarNet for scatter inference from a checkpoint, as the JAX
    package's ``run`` builds it (rcfd_tpu/radarnet_main.py:869-884): the
    weights restored, every batch norm folded into its convolution, then
    cast to ``compute_dtype`` (None or torch.float32: float32). Returns
    (the model on ``device``, the checkpoint's train step)."""
    model = RadarNetModel(
        input_channels_image=input_channels_image,
        input_channels_depth=input_channels_depth,
        input_patch_size_image=tuple(patch_size), encoder_type=encoder_type,
        n_filters_encoder_image=n_filters_encoder_image,
        n_neurons_encoder_depth=n_neurons_encoder_depth,
        decoder_type=decoder_type, n_filters_decoder=n_filters_decoder,
        weight_initializer=weight_initializer,
        activation_func=activation_func, device='cpu', perf=perf)
    step = model.restore_checkpoint(restore_path, device='cpu')
    model = fold_batch_norm(model).to(device, compute_dtype or torch.float32)
    return model, step


def gates_line(perf, compute_dtype, scatter) -> str:
    """The RCFD_* gates a run took, in one line: the scatter's route, the
    deferred skip pools, the decode chunks and the compute dtype."""
    return ('Gates: scatter {} (RCFD_PALLAS_SCATTER {}), RCFD_FUSED_POOL2 '
            '{}, RCFD_FUSED_POOL4 {}, RCFD_DECODE_CHUNKS {}, '
            'RCFD_COMPUTE_DTYPE {}'.format(
                'the kernel K1' if scatter is scatter_cuda else
                'the exact float max',
                'unset' if perf.pallas_scatter is None else
                int(perf.pallas_scatter), int(perf.fused_pool2),
                int(perf.fused_pool4),
                'auto' if perf.decode_chunks is None else perf.decode_chunks,
                'bfloat16' if compute_dtype == torch.bfloat16 else
                'float32'))


def run(restore_path, image_path, radar_path, ground_truth_path,
        # Input settings
        patch_size, input_channels_image, input_channels_depth,
        normalized_image_range,
        # Network settings
        encoder_type, n_filters_encoder_image, n_neurons_encoder_depth,
        decoder_type, n_filters_decoder,
        # Weight settings
        weight_initializer, activation_func,
        # Output settings
        output_dirpath, save_outputs, keep_input_filenames, verbose=True,
        # Evaluation settings
        min_evaluate_depth=0.0, max_evaluate_depth=100.0,
        max_points_inference: int = 0, response_thr: float = 0.5,
        eval_batch_size: int = 8,
        # Hardware settings
        device=None, perf=None, compute_dtype=None):
    """Scatter inference over a manifest (reference
    src/radarnet_main.py:789-1101, rcfd_tpu/radarnet_main.py ``run``), on
    ``device`` (``cuda`` unless ``device='cpu'``), ``eval_batch_size``
    frames a forward: RadarNet folded (``load_model``) in
    ``compute_dtype``, ``perf`` its PerfConfig, the scatter
    ``scatter_route``'s, all under the serving numerics. With ground truth
    the intersection metrics (x1000 / x0.001 over the pixels where output
    and ground truth have depth within (min, max), frames without one
    dropped from the means) go to results.txt; with ``save_outputs`` the
    image, ground truth, quasi-dense depth and response go to PNGs, the
    outputs as 16-bit codes made on the device when there is no ground
    truth (the same files). Returns (the metrics or None, the depth paths,
    the response paths, seconds) with seconds the setup, the host's read
    wait, the serving (to the outputs on the host) and the rest (metrics
    and writes)."""
    t_start = time.perf_counter()
    device = default_device(device)
    perf = perf if perf is not None else PerfConfig()
    os.makedirs(output_dirpath, exist_ok=True)
    log_path = os.path.join(output_dirpath, 'results.txt')

    image_paths = data_utils.read_paths(image_path)
    radar_paths = data_utils.read_paths(radar_path)
    n_sample = len(image_paths)
    ground_truth_available = bool(ground_truth_path) and \
        os.path.exists(ground_truth_path)
    ground_truth_paths = data_utils.read_paths(ground_truth_path) \
        if ground_truth_available else None
    dataset = RadarNetInferenceDataset(
        image_paths, radar_paths, ground_truth_paths,
        max_points=(None if max_points_inference is None or
                    max_points_inference <= 0 else max_points_inference),
        device=device)
    model, step = load_model(
        restore_path, patch_size, input_channels_image, input_channels_depth,
        encoder_type, n_filters_encoder_image, n_neurons_encoder_depth,
        decoder_type, n_filters_decoder, weight_initializer, activation_func,
        device, perf, compute_dtype)
    image_height, image_width = native.probe(image_paths[0])
    # passes that only write PNGs (no eval) fetch the uint16 codec grid:
    # half the device-to-host bytes, the same files; eval passes keep
    # float32 so that the metrics run on unquantized maps
    codec_d2h = bool(save_outputs) and not ground_truth_available
    forward_fn = make_forward_fn_batched(
        model, Transforms(normalized_image_range=normalized_image_range),
        image_height, image_width, threshold=response_thr,
        codec_encode=codec_d2h)
    log(gates_line(perf, compute_dtype, scatter_route(
        perf.pallas_scatter, device, dataset.max_points)))

    if save_outputs:
        output_dirs = {name: os.path.join(output_dirpath, name) for name in (
            'image', 'ground_truth', 'output_depth_radar',
            'output_response_radar')}
        for dirpath in output_dirs.values():
            os.makedirs(dirpath, exist_ok=True)
    errors = {k: np.zeros(n_sample) for k in METRICS}
    output_depth_paths, output_response_paths = [], []
    seconds = dict(setup=time.perf_counter() - t_start, read=0.0, serve=0.0)
    t_loop = time.perf_counter()
    with serving_numerics():
        for idx, data, output_depth, output_response in iter_scatter_outputs(
                forward_fn, dataset, eval_batch_size, device, seconds):
            image = data[0]
            if verbose:
                print('Processed {}/{} samples'.format(idx + 1, n_sample),
                      end='\r')
            if ground_truth_available:
                gt = data[3][..., 0]
                frame = intersection_metrics(
                    output_depth, gt, min_evaluate_depth, max_evaluate_depth)
                for k, v in zip(METRICS, frame):
                    errors[k][idx] = v
            if save_outputs:
                filename = (os.path.splitext(os.path.basename(
                    image_paths[idx]))[0] + '.png') if keep_input_filenames \
                    else '{:010d}.png'.format(idx)
                data_utils.save_image(image / 255.0, os.path.join(
                    output_dirs['image'], filename))
                depth_path = os.path.join(output_dirs['output_depth_radar'],
                                          filename)
                response_path = os.path.join(
                    output_dirs['output_response_radar'], filename)
                if codec_d2h:
                    data_utils.save_depth_encoded(output_depth, depth_path)
                    data_utils.save_response_encoded(output_response,
                                                     response_path)
                else:
                    data_utils.save_depth(output_depth, depth_path)
                    data_utils.save_response(output_response, response_path)
                output_depth_paths.append(depth_path)
                output_response_paths.append(response_path)
                if ground_truth_available:
                    data_utils.save_depth(gt, os.path.join(
                        output_dirs['ground_truth'], filename))
    seconds['write'] = time.perf_counter() - t_loop - seconds['read'] - \
        seconds['serve']

    results = None
    if ground_truth_available:
        results = {k: float(np.mean(v[~np.isnan(v)]))
                   for k, v in errors.items()}
        log_evaluation_results(
            'Evaluation results', *(results[k] for k in METRICS), 0, 0, 0,
            step, log_path)
    return results, output_depth_paths, output_response_paths, seconds


def log_evaluation_results(title, mae, rmse, imae, irmse, n_valid_output,
                           n_valid_intersection, n_valid_ground_truth, step,
                           log_path=None):
    log('{}:'.format(title), log_path)
    log('{:>8}  {:>8}  {:>8}  {:>8}  {:>8}  {:>10}  {:>10}  {:>10}'.format(
        'Step', 'MAE', 'RMSE', 'iMAE', 'iRMSE', 'n_output', 'n_isect',
        'n_gt'), log_path)
    log('{:8}  {:8.3f}  {:8.3f}  {:8.3f}  {:8.3f}  {:10.1f}  {:10.1f}  {:10.1f}'
        .format(step, mae, rmse, imae, irmse, n_valid_output,
                n_valid_intersection, n_valid_ground_truth), log_path)
