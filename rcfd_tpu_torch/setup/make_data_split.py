"""Create (or import) the 700/150 train/val scene-id split pickles
(counterpart of setup/make_data_split.py).

    python -m rcfd_tpu_torch.setup.make_data_split --output_dirpath data_split

The reference ships data_split/{train,val}_ids.pkl (lists of ints over
scenes 0-849). This tool copies an existing split (--import_from, e.g. the
reference's, for its exact partition) or draws a deterministic random one
from --seed: the same pickles as the JAX package's tool for the same flags.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.setup.make_data_split')
    parser.add_argument('--output_dirpath', type=str, default='data_split')
    parser.add_argument('--import_from', type=str, default=None,
                        help='Directory containing existing '
                             'train_ids.pkl/val_ids.pkl to copy')
    parser.add_argument('--n_scenes', type=int, default=850)
    parser.add_argument('--n_train', type=int, default=700)
    parser.add_argument('--seed', type=int, default=0)
    return parser


def main(argv=None):
    """Write the split pickles for ``argv`` (sys.argv[1:] when None)."""
    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dirpath, exist_ok=True)

    if args.import_from:
        for name in ['train_ids.pkl', 'val_ids.pkl']:
            with open(os.path.join(args.import_from, name), 'rb') as f:
                ids = pickle.load(f)
            with open(os.path.join(args.output_dirpath, name), 'wb') as f:
                pickle.dump(ids, f)
        print('imported split from', args.import_from)
        return

    rng = np.random.default_rng(args.seed)
    perm = rng.permutation(args.n_scenes)
    train_ids = sorted(int(i) for i in perm[:args.n_train])
    val_ids = sorted(int(i) for i in perm[args.n_train:])
    with open(os.path.join(args.output_dirpath, 'train_ids.pkl'), 'wb') as f:
        pickle.dump(train_ids, f)
    with open(os.path.join(args.output_dirpath, 'val_ids.pkl'), 'wb') as f:
        pickle.dump(val_ids, f)
    print('wrote {} train / {} val scene ids'.format(
        len(train_ids), len(val_ids)))


if __name__ == '__main__':
    main()
