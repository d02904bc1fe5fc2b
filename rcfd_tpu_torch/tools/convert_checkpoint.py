"""Convert checkpoints between the reference .pth format and the JAX
package's native .npz format, both directions, for either model family
(counterpart of tools/convert_checkpoint.py).

    python -m rcfd_tpu_torch.tools.convert_checkpoint --model fusionnet \\
        --input model-355000.pth --output model-355000.npz
    python -m rcfd_tpu_torch.tools.convert_checkpoint --model radarnet \\
        --input model.npz --output model.pth

The JAX tool's flags and defaults: the canonical configuration of both
families, which the network flags change. The model is built on the card
(``cuda`` unless ``main(argv, device='cpu')``), restored with
``restore_checkpoint(path, return_optimizer_state=True)`` and written with
``save_checkpoint``: the train step always, the optimizer state only into a
``.pth`` (a ``.npz`` holds none). The output holds what the JAX tool's
holds, with the JAX package's conventions: an Adam state in its sorted-key
order with its steps as they were read, and in a ``.pth`` each batch
norm's ``num_batches_tracked`` an int32 of shape (1,).
"""

from __future__ import annotations

import argparse

from .. import default_device, fusionnet_main, radarnet_main


def build_model(args, device):
    """The model of ``args.model`` at the flags' configuration, on
    ``device``."""
    if args.model == 'fusionnet':
        return fusionnet_main.build_model(
            input_channels_image=args.input_channels_image,
            input_channels_depth=args.input_channels_depth,
            encoder_type='-'.join(args.encoder_type),
            n_filters_encoder_image=args.n_filters_encoder_image,
            n_filters_encoder_depth=args.n_filters_encoder_depth,
            fusion_type=args.fusion_type,
            decoder_type='-'.join(args.decoder_type),
            n_resolutions_decoder=args.n_resolutions_decoder,
            n_filters_decoder=args.n_filters_decoder,
            weight_initializer='kaiming_uniform',
            activation_func='leaky_relu',
            min_predict_depth=args.min_predict_depth,
            max_predict_depth=args.max_predict_depth, device=device)
    return radarnet_main.build_model(
        input_channels_image=args.input_channels_image,
        input_channels_depth=3, patch_size=args.patch_size,
        encoder_type='-'.join(args.encoder_type_radarnet),
        n_filters_encoder_image=args.n_filters_encoder_image_radarnet,
        n_neurons_encoder_depth=args.n_neurons_encoder_depth,
        decoder_type='-'.join(args.decoder_type),
        n_filters_decoder=args.n_filters_decoder_radarnet,
        weight_initializer='kaiming_uniform', activation_func='leaky_relu',
        device=device)


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.convert_checkpoint')
    parser.add_argument('--model', choices=['fusionnet', 'radarnet'],
                        required=True)
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    # fusionnet config (canonical defaults)
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
    # radarnet config
    parser.add_argument('--patch_size', nargs='+', type=int,
                        default=[900, 288])
    parser.add_argument('--encoder_type_radarnet', nargs='+', type=str,
                        default=['radarnetv1', 'batch_norm'])
    parser.add_argument('--n_filters_encoder_image_radarnet', nargs='+',
                        type=int, default=[32, 64, 128, 128, 128])
    parser.add_argument('--n_neurons_encoder_depth', nargs='+', type=int,
                        default=[32, 64, 128, 128, 128])
    parser.add_argument('--n_filters_decoder_radarnet', nargs='+', type=int,
                        default=[256, 128, 64, 32, 16])
    return parser


def main(argv=None, device=None):
    """Convert ``args.input`` to ``args.output`` on ``device`` (``cuda``
    unless ``device='cpu'``). Returns the train step carried."""
    args = build_parser().parse_args(argv)
    device = default_device(device)
    model = build_model(args, device)
    step, optimizer_state = model.restore_checkpoint(
        args.input, device=device, return_optimizer_state=True)
    model.save_checkpoint(args.output, step,
                          optimizer_state_dict=optimizer_state
                          if args.output.endswith('.pth') else None,
                          jax_counts=True)
    print('converted {} -> {} (step {})'.format(args.input, args.output,
                                                step))
    return step


if __name__ == '__main__':
    main()
