"""CLI: RadarNet scatter inference from files, the port's counterpart of
run_radarnet.py (reference src/run_radarnet.py).

    python -m rcfd_tpu_torch.run_radarnet --restore_path model.pth \\
        --image_path image.txt --radar_path radar.txt \\
        [--ground_truth_path gt.txt] --output_dirpath out --save_outputs

It takes the JAX CLI's flags with the same defaults and runs
``radarnet_main.run`` on the card: RadarNet restored and its batch norm
folded, the quasi-dense depth and response of every frame written as
16-bit PNGs (output_depth_radar, output_response_radar, with the image and
ground truth), and with ground truth the intersection metrics in
results.txt.

Of the JAX package's RCFD_* environment gates it reads those the port has,
once, with their JAX meanings: RCFD_PALLAS_SCATTER (the scatter: by
default the kernel K1 on the card, as the JAX CLI takes its kernel on the
TPU), RCFD_FUSED_POOL2, RCFD_FUSED_POOL4, RCFD_DECODE_CHUNKS and
RCFD_COMPUTE_DTYPE (bfloat16 serves a bf16 copy of the folded model). The
run says which it took in one line.
"""

from __future__ import annotations

import argparse
import time

from . import radarnet_main
from .data import io as data_utils
from .nn.perf import compute_dtype_from_env, perf_from_env
from .utils.log_utils import log

parser = argparse.ArgumentParser(prog='python -m rcfd_tpu_torch.run_radarnet')
parser.add_argument('--restore_path', type=str, required=True)
parser.add_argument('--image_path', type=str, required=True)
parser.add_argument('--radar_path', type=str, required=True)
parser.add_argument('--ground_truth_path', type=str, default=None)
# Input settings
parser.add_argument('--patch_size', nargs='+', type=int, default=[900, 288])
parser.add_argument('--input_channels_image', type=int, default=3)
parser.add_argument('--input_channels_depth', type=int, default=3)
parser.add_argument('--normalized_image_range', nargs='+', type=float,
                    default=[0, 1])
# Network settings
parser.add_argument('--encoder_type', nargs='+', type=str,
                    default=['radarnetv1', 'batch_norm'])
parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--n_neurons_encoder_depth', nargs='+', type=int,
                    default=[32, 64, 128, 128, 128])
parser.add_argument('--decoder_type', nargs='+', type=str,
                    default=['multiscale', 'batch_norm'])
parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                    default=[256, 128, 64, 32, 16])
# Weight settings
parser.add_argument('--weight_initializer', type=str,
                    default='kaiming_uniform')
parser.add_argument('--activation_func', type=str, default='leaky_relu')
# Output settings
parser.add_argument('--output_dirpath', type=str, required=True)
parser.add_argument('--save_outputs', action='store_true')
parser.add_argument('--keep_input_filenames', action='store_true')
parser.add_argument('--verbose', action='store_true')
# Evaluation settings
parser.add_argument('--min_evaluate_depth', type=float, default=0)
parser.add_argument('--max_evaluate_depth', type=float, default=100)
parser.add_argument('--eval_batch_size', type=int, default=8,
                    help='frames a forward (the same per-frame outputs at '
                         'any value)')
parser.add_argument('--max_points_inference', type=int, default=0,
                    help='static point-axis size; the default (<= 0) '
                         'sizes it from the radar manifest so that no '
                         'frame is truncated')


def main(argv=None, device=None):
    """Run the CLI on ``argv`` (sys.argv[1:] when None), on ``device``
    (``cuda`` unless ``device='cpu'``). Returns a summary: frames served,
    the mean metrics (None without ground truth), the output paths and the
    seconds spent in setup, reading, serving (to the outputs on the host)
    and writing."""
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    kwargs = vars(args)
    kwargs['encoder_type'] = '-'.join(args.encoder_type)
    kwargs['decoder_type'] = '-'.join(args.decoder_type)
    metrics, depth_paths, response_paths, seconds = radarnet_main.run(
        **kwargs, device=device, perf=perf_from_env(),
        compute_dtype=compute_dtype_from_env())
    n = len(data_utils.read_paths(args.image_path))
    log(
        'Served {} frames in {:.3f} s: per frame, read {:.2f} ms, serve '
        '{:.2f} ms, write {:.2f} ms; setup {:.3f} s'.format(
            n, time.perf_counter() - t0,
            *[1e3 * seconds[k] / n for k in ('read', 'serve', 'write')],
            seconds['setup']))
    return dict(frames=n, metrics=metrics, depth_paths=depth_paths,
                response_paths=response_paths, seconds=seconds)


if __name__ == '__main__':
    main()
