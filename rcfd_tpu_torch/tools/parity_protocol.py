"""Accuracy-parity protocol of the port (counterpart of
tools/parity_protocol.py): the port's metrics on a checkpoint and its
frames, in the JAX tool's report, beside a reference column.

One invocation runs, on the card (``main(argv, device='cpu')`` on the
CPU):

  single stage  ``fusionnet_main.run`` over the image, depth, response and
                ground-truth manifests (MAE, RMSE in mm; iMAE, iRMSE in
                1/km over ground truth > 0 in (min, max));
  --two_stage   (implied by --radarnet_checkpoint) the whole chain: (1)
                ``radarnet_main.run`` writing the real 16-bit PNG bridge
                (the scatter kernel K1 on the card, the exact max on the
                CPU) with its intersection metrics, (2) ``fusionnet_main.run``
                on the bridge's manifests, (3) ``TwoStagePipeline.
                from_checkpoints(..., quantize_bridge=True).forward_batched``
                over the same frames (the exact max);

and writes the side-by-side table, its verdict and parity_report.md with
the JAX tool's headings, rows and tolerances (10 mm, 0.05 1/km, plus
1e-3 of the reference's value; 5e-3 on the stage-1 intersection metrics).

The reference column is the original PyTorch code run on the same
checkpoint and frames. That half needs the reference tree, which this
repository does not hold: the tool runs the port's side only and reports
``REFERENCE UNAVAILABLE (our metrics only)``, as the JAX tool does without
the tree. ``format_table(ref, ours, ...)`` takes any metric dict as its
reference (the tests put the JAX tool's metrics there).

    python -m rcfd_tpu_torch.tools.parity_protocol \\
        --fusionnet_checkpoint fusionnet.pth --image_path image.txt \\
        --depth_path depth.txt --response_path response.txt \\
        --ground_truth_path lidar.txt --output_dirpath parity_out
    python -m rcfd_tpu_torch.tools.parity_protocol --synthetic --two_stage \\
        --output_dirpath parity_out

``--synthetic`` makes a tiny fixture (tools/fixtures.py) and random
checkpoints drawn from a torch generator inside the output directory, so
the whole report path runs without data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import default_device, fusionnet_main, radarnet_main
from ..data import io as data_utils
from ..data.datasets import RadarNetInferenceDataset
from ..data.loader import iter_device_batches
from ..data.transport import decode_np
from ..models import FusionNetModel, RadarNetModel
from ..nn.layers import init_parameters
from ..pipeline import TwoStagePipeline
from ..utils import eval_utils

METRICS = ('mae', 'rmse', 'imae', 'irmse')
REFERENCE_UNAVAILABLE = ('reference tree / torch unavailable — running our '
                         'stack only (pass --skip_reference to silence)')
TINY_FUSIONNET = dict(image=[8, 12, 16, 16, 16], depth=[4, 6, 8, 8, 8],
                      decoder=[16, 12, 8, 8, 8])


def ours_eval(checkpoint_path, args, net, output_dirpath, device):
    """The port under the protocol: ``fusionnet_main.run`` with the JAX
    tool's arguments. Returns the mean metrics."""
    results, _ = fusionnet_main.run(
        restore_path=checkpoint_path,
        image_path=args.image_path,
        depth_path=args.depth_path,
        response_path=args.response_path,
        ground_truth_path=args.ground_truth_path,
        input_channels_image=net['input_channels_image'],
        input_channels_depth=net['input_channels_depth'],
        normalized_image_range=list(args.normalized_image_range),
        encoder_type=net['encoder_type'],
        n_filters_encoder_image=net['n_filters_encoder_image'],
        n_filters_encoder_depth=net['n_filters_encoder_depth'],
        fusion_type=net['fusion_type'],
        decoder_type=net['decoder_type'],
        n_filters_decoder=net['n_filters_decoder'],
        n_resolutions_decoder=net['n_resolutions_decoder'],
        min_predict_depth=net['min_predict_depth'],
        max_predict_depth=net['max_predict_depth'],
        weight_initializer=net['weight_initializer'],
        activation_func=net['activation_func'],
        output_dirpath=output_dirpath,
        save_outputs=False,
        keep_input_filenames=False,
        verbose=args.verbose,
        min_evaluate_depth=args.min_evaluate_depth,
        max_evaluate_depth=args.max_evaluate_depth,
        eval_batch_size=args.eval_batch_size,
        device=device)
    return results


def _metric_row(out_m, gt_m):
    return (eval_utils.mean_abs_err(1000.0 * out_m, 1000.0 * gt_m),
            eval_utils.root_mean_sq_err(1000.0 * out_m, 1000.0 * gt_m),
            eval_utils.inv_mean_abs_err(0.001 * out_m, 0.001 * gt_m),
            eval_utils.inv_root_mean_sq_err(0.001 * out_m, 0.001 * gt_m))


def ours_two_stage_eval(args, rn_net, fn_net, output_dirpath, device):
    """The port's chain under the protocol: ``radarnet_main.run`` (writes
    the real PNG bridge) -> manifests -> ``fusionnet_main.run``; and the
    fused pipeline over the same frames. Returns {'stage1', 'stage2',
    'fused'} metric dicts ('stage1' only with ground truth)."""
    bridge_dir = os.path.join(output_dirpath, 'ours_bridge')
    s1_results, depth_paths, response_paths, _ = radarnet_main.run(
        restore_path=args.radarnet_checkpoint,
        image_path=args.image_path,
        radar_path=args.radar_path,
        ground_truth_path=args.ground_truth_path,
        patch_size=rn_net['patch_size'],
        input_channels_image=rn_net['input_channels_image'],
        input_channels_depth=rn_net['input_channels_depth'],
        normalized_image_range=list(args.normalized_image_range),
        encoder_type=rn_net['encoder_type'],
        n_filters_encoder_image=rn_net['n_filters_encoder_image'],
        n_neurons_encoder_depth=rn_net['n_neurons_encoder_depth'],
        decoder_type=rn_net['decoder_type'],
        n_filters_decoder=rn_net['n_filters_decoder'],
        weight_initializer=rn_net['weight_initializer'],
        activation_func=rn_net['activation_func'],
        output_dirpath=bridge_dir,
        save_outputs=True, keep_input_filenames=False,
        verbose=args.verbose,
        min_evaluate_depth=args.radarnet_min_evaluate_depth,
        max_evaluate_depth=args.radarnet_max_evaluate_depth,
        max_points_inference=args.max_points_inference,
        eval_batch_size=args.eval_batch_size,
        device=device)

    depth_manifest = os.path.join(bridge_dir, 'depth_predicted.txt')
    response_manifest = os.path.join(bridge_dir, 'response_predicted.txt')
    data_utils.write_paths(depth_manifest, depth_paths)
    data_utils.write_paths(response_manifest, response_paths)
    stage2_args = argparse.Namespace(**dict(
        vars(args), depth_path=depth_manifest,
        response_path=response_manifest))
    s2_results = ours_eval(args.fusionnet_checkpoint, stage2_args, fn_net,
                           os.path.join(output_dirpath, 'ours_stage2'),
                           device)

    out = {'stage2': s2_results,
           'fused': _ours_fused_eval(args, rn_net, fn_net, device)}
    if s1_results is not None:
        out['stage1'] = {k.replace('_intersection', ''): v
                         for k, v in s1_results.items()}
    return out


def _ours_fused_eval(args, rn_net, fn_net, device):
    """TwoStagePipeline (quantize_bridge=True) over the same manifests, the
    serving path's counterpart of the chain: ``forward_batched`` a batch of
    ``--eval_batch_size`` frames, the metrics of each frame's dense
    depth."""
    image_paths = data_utils.read_paths(args.image_path)
    radar_paths = data_utils.read_paths(args.radar_path)
    gt_paths = data_utils.read_paths(args.ground_truth_path)
    dataset = RadarNetInferenceDataset(
        image_paths=image_paths, radar_paths=radar_paths,
        ground_truth_paths=gt_paths,
        max_points=(None if args.max_points_inference <= 0
                    else args.max_points_inference), device=device)
    height, width = data_utils.load_image_u8(image_paths[0],
                                             device=device).shape[:2]
    pipeline = TwoStagePipeline.from_checkpoints(
        args.radarnet_checkpoint, args.fusionnet_checkpoint,
        image_height=height, image_width=width,
        patch_size=rn_net['patch_size'],
        radarnet_kwargs=dict(
            encoder_type=rn_net['encoder_type'],
            n_filters_encoder_image=rn_net['n_filters_encoder_image'],
            n_neurons_encoder_depth=rn_net['n_neurons_encoder_depth'],
            decoder_type=rn_net['decoder_type'],
            n_filters_decoder=rn_net['n_filters_decoder']),
        fusionnet_kwargs=dict(
            encoder_type=fn_net['encoder_type'],
            n_filters_encoder_image=fn_net['n_filters_encoder_image'],
            n_filters_encoder_depth=fn_net['n_filters_encoder_depth'],
            fusion_type=fn_net['fusion_type'],
            decoder_type=fn_net['decoder_type'],
            n_resolution_decoder=fn_net['n_resolutions_decoder'],
            n_filters_decoder=fn_net['n_filters_decoder'],
            min_predict_depth=fn_net['min_predict_depth'],
            max_predict_depth=fn_net['max_predict_depth']),
        normalized_image_range=tuple(args.normalized_image_range),
        quantize_bridge=True, device=device)

    rows = np.zeros((len(dataset), 4))
    for idxs, samples, (images, points, valid) in iter_device_batches(
            dataset, args.eval_batch_size, device, fields=(0, 1, 2)):
        dense_b = pipeline.forward_batched(images, points, valid)[0]
        dense_b = dense_b.cpu().numpy()
        for j, idx in enumerate(idxs):
            gt = decode_np(samples[j][3])[..., 0]
            mask = np.where((gt > 0) & (gt > args.min_evaluate_depth)
                            & (gt < args.max_evaluate_depth))
            rows[idx] = _metric_row(dense_b[j][mask], gt[mask])
    return dict(zip(METRICS, np.mean(rows, axis=0).tolist()))


def format_table(ref, ours, tol_mm, tol_inv, tol_rel=1e-3):
    """Markdown table side by side and its verdict. ``ref`` may be None
    (the reference is unavailable): then only the port's numbers print.

    The per-metric tolerance is absolute plus relative, ``tol_abs +
    tol_rel * |ref|``: the relative term keeps the verdict meaningful where
    a metric's magnitude is far from a trained checkpoint's (a random
    synthetic model's iMAE is some 460 1/km, not 4)."""
    units = {'mae': 'mm', 'rmse': 'mm', 'imae': '1/km', 'irmse': '1/km'}
    tols = {'mae': tol_mm, 'rmse': tol_mm, 'imae': tol_inv, 'irmse': tol_inv}
    lines = ['| metric | reference (torch CPU) | rcfd_tpu_torch | delta | '
             'tolerance | verdict |',
             '|---|---|---|---|---|---|']
    all_pass = True
    for k in METRICS:
        if ref is None:
            lines.append('| {} ({}) | n/a | {:.3f} | — | — | — |'.format(
                k.upper(), units[k], ours[k]))
            continue
        delta = abs(ours[k] - ref[k])
        tol = tols[k] + tol_rel * abs(ref[k])
        ok = delta <= tol
        all_pass = all_pass and ok
        lines.append(
            '| {} ({}) | {:.3f} | {:.3f} | {:.3f} | {:.3f} | {} |'.format(
                k.upper(), units[k], ref[k], ours[k], delta, tol,
                'PASS' if ok else 'FAIL'))
    verdict = ('PARITY PASS' if ref is not None and all_pass else
               'PARITY FAIL' if ref is not None else
               'REFERENCE UNAVAILABLE (our metrics only)')
    return '\n'.join(lines), verdict


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.parity_protocol')
    parser.add_argument('--synthetic', action='store_true',
                        help='make a tiny synthetic fixture and random '
                             'checkpoints and run the whole report path '
                             '(tiny widths replace the release defaults)')
    parser.add_argument('--fusionnet_checkpoint', type=str, default=None,
                        help='reference-format .pth (released weights) or '
                             'native .npz')
    parser.add_argument('--image_path', type=str, default=None)
    parser.add_argument('--depth_path', type=str, default=None)
    parser.add_argument('--response_path', type=str, default=None)
    parser.add_argument('--ground_truth_path', type=str, default=None)
    # two-stage chain: RadarNet -> the real PNG bridge -> FusionNet
    parser.add_argument('--two_stage', action='store_true',
                        help='run the whole chain (RadarNet -> bridge -> '
                             'FusionNet); implied by --radarnet_checkpoint')
    parser.add_argument('--radarnet_checkpoint', type=str, default=None,
                        help='stage-1 .pth; enables the two-stage chain '
                             '(the depth/response manifests are then '
                             'made by the bridge, not inputs)')
    parser.add_argument('--radar_path', type=str, default=None,
                        help='radar .npy manifest (two-stage mode)')
    parser.add_argument('--patch_size', nargs='+', type=int,
                        default=[900, 288])
    parser.add_argument('--radarnet_encoder_type', nargs='+', type=str,
                        default=['radarnetv1', 'batch_norm'])
    parser.add_argument('--radarnet_n_filters_encoder_image', nargs='+',
                        type=int, default=[32, 64, 128, 128, 128])
    parser.add_argument('--radarnet_n_neurons_encoder_depth', nargs='+',
                        type=int, default=[32, 64, 128, 128, 128])
    parser.add_argument('--radarnet_decoder_type', nargs='+', type=str,
                        default=['multiscale', 'batch_norm'])
    parser.add_argument('--radarnet_n_filters_decoder', nargs='+', type=int,
                        default=[256, 128, 64, 32, 16])
    parser.add_argument('--max_points_inference', type=int, default=0,
                        help='static point-axis size (0 = sized from the '
                             'manifest)')
    parser.add_argument('--radarnet_min_evaluate_depth', type=float,
                        default=0.0)
    parser.add_argument('--tolerance_rel_stage1', type=float, default=5e-3,
                        help='relative tolerance of the stage-1 '
                             'intersection metrics, wider than '
                             '--tolerance_rel: a near-tie scatter winner '
                             'changes the set of intersection pixels, not '
                             'only their values')
    parser.add_argument('--radarnet_max_evaluate_depth', type=float,
                        default=100.0,
                        help='radarnet eval protocol depth cap '
                             '(bash/run_radarnet_nuscenes.sh)')
    parser.add_argument('--normalized_image_range', nargs='+', type=float,
                        default=[0, 1])
    # network settings (canonical release config)
    parser.add_argument('--input_channels_image', type=int, default=3)
    parser.add_argument('--input_channels_depth', type=int, default=2)
    parser.add_argument('--encoder_type', nargs='+', type=str,
                        default=['fusionnet18', 'batch_norm'])
    parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                        default=[32, 64, 128, 256, 256, 256])
    parser.add_argument('--n_filters_encoder_depth', nargs='+', type=int,
                        default=[16, 32, 64, 128, 128, 128])
    parser.add_argument('--fusion_type', type=str,
                        default='weight_and_project')
    parser.add_argument('--decoder_type', nargs='+', type=str,
                        default=['multiscale', 'batch_norm'])
    parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                        default=[256, 256, 128, 64, 64, 32])
    parser.add_argument('--n_resolutions_decoder', type=int, default=1)
    parser.add_argument('--min_predict_depth', type=float, default=1.0)
    parser.add_argument('--max_predict_depth', type=float, default=100.0)
    parser.add_argument('--weight_initializer', type=str,
                        default='kaiming_uniform')
    parser.add_argument('--activation_func', type=str, default='leaky_relu')
    # protocol
    parser.add_argument('--min_evaluate_depth', type=float, default=0.0)
    parser.add_argument('--max_evaluate_depth', type=float, default=80.0,
                        help='80 = val protocol, 70 = test protocol')
    parser.add_argument('--eval_batch_size', type=int, default=8)
    parser.add_argument('--tolerance_mm', type=float, default=10.0,
                        help='max |delta| for MAE/RMSE (mm)')
    parser.add_argument('--tolerance_inv', type=float, default=0.05,
                        help='max |delta| for iMAE/iRMSE (1/km)')
    parser.add_argument('--tolerance_rel', type=float, default=1e-3,
                        help='relative tolerance added per metric: the '
                             'bound is tol_abs + tol_rel*|ref|')
    parser.add_argument('--skip_reference', action='store_true',
                        help='only run our stack (the reference tree is '
                             'absent)')
    parser.add_argument('--output_dirpath', type=str, required=True)
    parser.add_argument('--verbose', action='store_true')
    return parser


def _tiny_fusionnet(seed):
    """The synthetic FusionNet: TINY_FUSIONNET's widths, weights drawn from
    a torch generator seeded with ``seed``."""
    model = FusionNetModel(
        input_channels_image=3, input_channels_depth=2,
        encoder_type='fusionnet18_batch_norm',
        n_filters_encoder_image=TINY_FUSIONNET['image'],
        n_filters_encoder_depth=TINY_FUSIONNET['depth'],
        fusion_type='weight_and_project',
        decoder_type='multiscale_batch_norm', n_resolution_decoder=1,
        n_filters_decoder=TINY_FUSIONNET['decoder'], min_predict_depth=1.0,
        max_predict_depth=100.0, device='cpu')
    return init_parameters(model, torch.Generator().manual_seed(seed))


def _use_tiny_fusionnet(args):
    args.n_filters_encoder_image = TINY_FUSIONNET['image']
    args.n_filters_encoder_depth = TINY_FUSIONNET['depth']
    args.n_filters_decoder = TINY_FUSIONNET['decoder']


def _setup_synthetic(args):
    """--synthetic: the fixture and a random tiny checkpoint inside the
    output directory; ``args`` pointed at them."""
    from .fixtures import make_fusionnet_fixture

    manifests = make_fusionnet_fixture(
        os.path.join(args.output_dirpath, 'synthetic_data'), n_samples=2,
        height=32, width=48)
    ckpt = os.path.join(args.output_dirpath, 'synthetic-model-0.pth')
    _tiny_fusionnet(0).save_checkpoint(ckpt, 0)
    args.fusionnet_checkpoint = ckpt
    args.image_path = manifests['image']
    args.depth_path = manifests['depth']
    args.response_path = manifests['response']
    args.ground_truth_path = manifests['ground_truth']
    _use_tiny_fusionnet(args)
    return args


def _setup_synthetic_two_stage(args):
    """--synthetic --two_stage: the RadarNet fixture and random tiny
    checkpoints of both stages inside the output directory. RadarNet's
    output0 weight is scaled by 50, so that the untrained responses move
    away from 0.5 and the scatter's winners from ties."""
    from .fixtures import make_radarnet_fixture

    manifests = make_radarnet_fixture(
        os.path.join(args.output_dirpath, 'synthetic_data'), n_samples=2,
        height=64, width=96, n_points=5)
    args.patch_size = [32, 32]
    args.radarnet_n_filters_encoder_image = [4, 8, 8, 8, 8]
    args.radarnet_n_neurons_encoder_depth = [4, 8, 8, 8, 8]
    args.radarnet_n_filters_decoder = [8, 8, 8, 8, 8]
    rn = RadarNetModel(
        input_channels_image=3, input_channels_depth=3,
        input_patch_size_image=tuple(args.patch_size),
        encoder_type='radarnetv1_batch_norm',
        n_filters_encoder_image=args.radarnet_n_filters_encoder_image,
        n_neurons_encoder_depth=args.radarnet_n_neurons_encoder_depth,
        decoder_type='multiscale_batch_norm',
        n_filters_decoder=args.radarnet_n_filters_decoder, device='cpu')
    init_parameters(rn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        rn.decoder.output0.conv.weight.mul_(50.0)
    args.radarnet_checkpoint = os.path.join(args.output_dirpath,
                                            'synthetic-radarnet-0.pth')
    rn.save_checkpoint(args.radarnet_checkpoint, 0)
    args.fusionnet_checkpoint = os.path.join(args.output_dirpath,
                                             'synthetic-fusionnet-0.pth')
    _tiny_fusionnet(1).save_checkpoint(args.fusionnet_checkpoint, 0)
    _use_tiny_fusionnet(args)
    args.image_path = manifests['image']
    args.radar_path = manifests['radar']
    args.ground_truth_path = manifests['ground_truth']
    return args


def _fusionnet_net(args):
    return dict(
        input_channels_image=args.input_channels_image,
        input_channels_depth=args.input_channels_depth,
        encoder_type='-'.join(args.encoder_type),
        n_filters_encoder_image=args.n_filters_encoder_image,
        n_filters_encoder_depth=args.n_filters_encoder_depth,
        fusion_type=args.fusion_type,
        decoder_type='-'.join(args.decoder_type),
        n_filters_decoder=args.n_filters_decoder,
        n_resolutions_decoder=args.n_resolutions_decoder,
        min_predict_depth=args.min_predict_depth,
        max_predict_depth=args.max_predict_depth,
        weight_initializer=args.weight_initializer,
        activation_func=args.activation_func)


def _write_report(args, report):
    print(report)
    report_path = os.path.join(args.output_dirpath, 'parity_report.md')
    with open(report_path, 'w') as f:
        f.write(report)
    print('wrote {}'.format(report_path))


def main(argv=None, device=None):
    """Run the protocol on ``device`` (``cuda`` unless ``device='cpu'``).
    Returns (the reference's metrics or None, the port's, the verdict)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = default_device(device)
    os.makedirs(args.output_dirpath, exist_ok=True)
    two_stage = args.radarnet_checkpoint is not None or args.two_stage
    if args.synthetic:
        args = (_setup_synthetic_two_stage(args) if two_stage
                else _setup_synthetic(args))
    required = (('fusionnet_checkpoint', 'radarnet_checkpoint',
                 'image_path', 'radar_path', 'ground_truth_path')
                if two_stage else
                ('fusionnet_checkpoint', 'image_path', 'depth_path',
                 'response_path', 'ground_truth_path'))
    missing = [n for n in required if getattr(args, n) is None]
    if missing:
        parser.error(
            'the following arguments are required (or pass --synthetic): '
            + ', '.join('--' + m for m in missing))
    if two_stage:
        return main_two_stage(args, device)

    net = _fusionnet_net(args)
    image_paths = data_utils.read_paths(args.image_path)
    assert len(image_paths) == len(data_utils.read_paths(args.depth_path)) \
        == len(data_utils.read_paths(args.response_path)) \
        == len(data_utils.read_paths(args.ground_truth_path))
    # the reference half needs the reference tree, absent here
    ref_results = None
    if not args.skip_reference:
        print(REFERENCE_UNAVAILABLE)

    our_results = ours_eval(args.fusionnet_checkpoint, args, net,
                            args.output_dirpath, device)
    table, verdict = format_table(ref_results, our_results,
                                  args.tolerance_mm, args.tolerance_inv,
                                  args.tolerance_rel)
    _write_report(args, (
        '# Parity protocol report\n\n'
        'checkpoint: {}\nframes: {}\nprotocol: depth in ({}, {}) m, '
        'GT > 0\n\n{}\n\n**{}**\n'.format(
            args.fusionnet_checkpoint, len(image_paths),
            args.min_evaluate_depth, args.max_evaluate_depth, table,
            verdict)))
    return ref_results, our_results, verdict


def main_two_stage(args, device):
    """The whole chain: the port's run_radarnet -> PNG bridge ->
    run_fusionnet, and the fused pipeline; one report with the stage-1
    intersection table and the two stage-2 tables."""
    fn_net = _fusionnet_net(args)
    rn_net = dict(
        input_channels_image=3, input_channels_depth=3,
        patch_size=list(args.patch_size),
        encoder_type='-'.join(args.radarnet_encoder_type),
        n_filters_encoder_image=args.radarnet_n_filters_encoder_image,
        n_neurons_encoder_depth=args.radarnet_n_neurons_encoder_depth,
        decoder_type='-'.join(args.radarnet_decoder_type),
        n_filters_decoder=args.radarnet_n_filters_decoder,
        weight_initializer=args.weight_initializer,
        activation_func=args.activation_func)

    image_paths = data_utils.read_paths(args.image_path)
    assert len(image_paths) == len(data_utils.read_paths(args.radar_path)) \
        == len(data_utils.read_paths(args.ground_truth_path))
    ref = None
    if not args.skip_reference:
        print(REFERENCE_UNAVAILABLE)

    ours = ours_two_stage_eval(args, rn_net, fn_net, args.output_dirpath,
                               device)

    sections, verdicts = [], []
    if 'stage1' in ours:
        t1, v1 = format_table(ref and ref['stage1'], ours['stage1'],
                              args.tolerance_mm, args.tolerance_inv,
                              args.tolerance_rel_stage1)
        sections.append('## Stage 1 — RadarNet intersection metrics '
                        '(depth in ({}, {}) m)\n\n{}\n\n**{}**'.format(
                            args.radarnet_min_evaluate_depth,
                            args.radarnet_max_evaluate_depth, t1, v1))
        verdicts.append(v1)
    t2, v2 = format_table(ref and ref['stage2'], ours['stage2'],
                          args.tolerance_mm, args.tolerance_inv,
                          args.tolerance_rel)
    sections.append('## Stage 2 — FusionNet on the PNG bridge '
                    '(depth in ({}, {}) m)\n\n{}\n\n**{}**'.format(
                        args.min_evaluate_depth, args.max_evaluate_depth,
                        t2, v2))
    verdicts.append(v2)
    tf, vf = format_table(ref and ref['stage2'], ours['fused'],
                          args.tolerance_mm, args.tolerance_inv,
                          args.tolerance_rel)
    sections.append('## Fused pipeline (one jitted program, '
                    'quantize_bridge) vs the reference chain\n\n{}\n\n'
                    '**{}**'.format(tf, vf))
    verdicts.append(vf)

    overall = ('PARITY PASS' if all(v == 'PARITY PASS' for v in verdicts)
               else 'PARITY FAIL' if ref is not None
               else 'REFERENCE UNAVAILABLE (our metrics only)')
    _write_report(args, (
        '# Two-stage parity protocol report\n\n'
        'radarnet checkpoint: {}\nfusionnet checkpoint: {}\n'
        'frames: {}\n\n{}\n\n**OVERALL: {}**\n'.format(
            args.radarnet_checkpoint, args.fusionnet_checkpoint,
            len(image_paths), '\n\n'.join(sections), overall)))
    return ref, ours, overall


if __name__ == '__main__':
    main()
