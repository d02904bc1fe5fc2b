"""CLI: FusionNet inference and evaluation from files, the port's
counterpart of run_fusionnet.py (reference src/run_fusionnet.py).

    python -m rcfd_tpu_torch.run_fusionnet --restore_path model.pth \\
        --image_path image.txt --depth_path depth.txt \\
        --response_path response.txt [--ground_truth_path gt.txt] \\
        --output_dirpath out --save_outputs

It takes the JAX CLI's flags with the same defaults and runs
``fusionnet_main.run`` on the card: FusionNet restored and its batch norm
folded, the dense depth of every frame written as a 16-bit PNG
(output_depth_fusion, with the image, the input depth and response and the
ground truth), and with ground truth the MAE, RMSE, iMAE and iRMSE in
results.txt. It reads RCFD_COMPUTE_DTYPE as the JAX CLI does (bfloat16
serves a bf16 copy of the folded model) and says so in one line; the
other RCFD_* gates of the port act on RadarNet only.
"""

from __future__ import annotations

import argparse
import time

from . import fusionnet_main
from .data import io as data_utils
from .nn.perf import compute_dtype_from_env
from .utils.log_utils import log

parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.run_fusionnet')
parser.add_argument('--restore_path', type=str, required=True)
parser.add_argument('--image_path', type=str, required=True)
parser.add_argument('--depth_path', type=str, required=True)
parser.add_argument('--response_path', type=str, required=True)
parser.add_argument('--ground_truth_path', type=str, default=None)
# Input settings
parser.add_argument('--input_channels_image', type=int, default=3)
parser.add_argument('--input_channels_depth', type=int, default=2)
parser.add_argument('--normalized_image_range', nargs='+', type=float,
                    default=[0, 1])
# Network settings
parser.add_argument('--encoder_type', nargs='+', type=str,
                    default=['fusionnet18', 'batch_norm'])
parser.add_argument('--n_filters_encoder_image', nargs='+', type=int,
                    default=[32, 64, 128, 256, 256, 256])
parser.add_argument('--n_filters_encoder_depth', nargs='+', type=int,
                    default=[16, 32, 64, 128, 128, 128])
parser.add_argument('--fusion_type', type=str, default='add')
parser.add_argument('--decoder_type', nargs='+', type=str,
                    default=['multiscale', 'batch_norm'])
parser.add_argument('--n_filters_decoder', nargs='+', type=int,
                    default=[256, 256, 128, 64, 64, 32])
parser.add_argument('--n_resolutions_decoder', type=int, default=0)
parser.add_argument('--min_predict_depth', type=float, default=0)
parser.add_argument('--max_predict_depth', type=float, default=100)
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
                    help='frames a forward (the same metrics at any value)')


def main(argv=None, device=None):
    """Run the CLI on ``argv`` (sys.argv[1:] when None), on ``device``
    (``cuda`` unless ``device='cpu'``). Returns a summary: frames served,
    the mean metrics (None without ground truth) and the seconds spent in
    setup, reading, serving (to the outputs on the host) and writing."""
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    kwargs = vars(args)
    kwargs['encoder_type'] = '-'.join(args.encoder_type)
    kwargs['decoder_type'] = '-'.join(args.decoder_type)
    kwargs['n_resolutions_decoder'] = max(args.n_resolutions_decoder, 1)
    metrics, seconds = fusionnet_main.run(
        **kwargs, device=device, compute_dtype=compute_dtype_from_env())
    n = len(data_utils.read_paths(args.image_path))
    log('Served {} frames in {:.3f} s: per frame, read {:.2f} ms, serve '
        '{:.2f} ms, write {:.2f} ms; setup {:.3f} s'.format(
            n, time.perf_counter() - t0,
            *[1e3 * seconds[k] / n for k in ('read', 'serve', 'write')],
            seconds['setup']))
    return dict(frames=n, metrics=metrics, seconds=seconds)


if __name__ == '__main__':
    main()
