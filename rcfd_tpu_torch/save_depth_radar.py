"""CLI: legacy v0 training from single-pickle Data_Struct manifests on one
card, the port's counterpart of save_depth_radar.py (reference
src/save_depth_radar.py, bash/train_nuscenes.sh).

    python -m rcfd_tpu_torch.save_depth_radar \\
        --path_to_pickle_file_train data_dict_train.pkl \\
        --path_to_pickle_file_val data_dict_val.pkl \\
        --image_path samples/CAM_FRONT --checkpoint_dirpath out

It takes the JAX CLI's flags with the same defaults (those of
bash/train_nuscenes.sh), plus ``--device`` (``cuda`` by default). Each
manifest is one pickled dict (or list) of Data_Struct records, the format
setup/data_gen.py writes: every record's label path and radar points
(a path, or an array that is saved to a temporary .npy file) are unpacked
into the path lists of ``legacy_main.train``. As in the JAX package, the
label path of a record is the ground truth the trainer reads, and its
basename names the camera image.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile

import numpy as np

from . import legacy_main
from .train_legacy_v0 import add_training_flags


def unpack_data_struct_manifest(pickle_path, materialize_dirpath=None,
                                materialize_prefix=''):
    """A single Data_Struct pickle -> (label paths, radar paths)
    (save_depth_radar.py ``unpack_data_struct_manifest``).

    Accepts a dict of records (setup/data_gen.py's output) or a list of
    them. Each value may be a one-element list holding the record
    (reference setup/data_gen_train.py:1211-1212), which is unwrapped.
    Records are NamedTuples or plain tuples in either reference field
    order: train (6 fields: scene_id, sample_idx, image_path, input points
    (a path), label path, depth path) or val/test (7 fields: scene_id,
    sample_idx, image_path, ground-truth points (an array), input points
    (an array), label path, depth path). Radar entries that are arrays are
    saved to ``materialize_dirpath`` as ``<prefix>radar_points_<i>.npy``
    (distinct manifests sharing one directory need distinct prefixes); an
    array without a directory raises ValueError."""
    with open(pickle_path, 'rb') as f:
        manifest = pickle.load(f)
    records = (list(manifest.values()) if isinstance(manifest, dict)
               else list(manifest))
    gt_paths, radar_paths = [], []
    for i, rec in enumerate(records):
        if isinstance(rec, (list, tuple)) and len(rec) == 1:
            rec = rec[0]
        if hasattr(rec, 'ground_truth_label_path'):
            gt_paths.append(rec.ground_truth_label_path)
            radar = getattr(rec, 'radar_points_path',
                            getattr(rec, 'input_points', None))
        elif len(rec) >= 7:
            gt_paths.append(rec[5])
            radar = rec[4]
        else:
            gt_paths.append(rec[4])
            radar = rec[3]
        if isinstance(radar, np.ndarray):
            if materialize_dirpath is None:
                raise ValueError(
                    'manifest stores in-memory radar arrays but no '
                    'materialize_dirpath was given')
            radar_path = os.path.join(
                materialize_dirpath,
                '{}radar_points_{}.npy'.format(materialize_prefix, i))
            np.save(radar_path, radar)
            radar = radar_path
        radar_paths.append(radar)
    return gt_paths, radar_paths


def _as_path_pickle(paths, tmpdir, name):
    out = os.path.join(tmpdir, name)
    with open(out, 'wb') as f:
        pickle.dump(paths, f)
    return out


parser = argparse.ArgumentParser(
    prog='python -m rcfd_tpu_torch.save_depth_radar')
parser.add_argument('--path_to_pickle_file_train', type=str, required=True,
                    help='pickled dict of Data_Struct records (train)')
parser.add_argument('--path_to_pickle_file_val', type=str, required=True,
                    help='pickled dict of Data_Struct records (val)')
add_training_flags(parser, batch_size=64, patch_size=(900, 60),
                   learning_rates=(5e-5, 1e-4, 2e-4, 1e-4, 5e-5),
                   learning_schedule=(2, 5, 10, 12, 15),
                   augmentation_random_noise_spread=0.0, w_smoothness=1e-7,
                   kernel_size_smoothness=(11, 3))


def main(argv=None, **train_kwargs):
    """Parse ``argv`` (sys.argv[1:] when None), unpack both manifests into
    a temporary directory and train; keyword arguments go to
    ``legacy_main.train``. Returns the best validation results."""
    kwargs = vars(parser.parse_args(argv))
    kwargs.update(train_kwargs)
    if kwargs['restore_path'] == '':
        kwargs['restore_path'] = None
    train_pickle = kwargs.pop('path_to_pickle_file_train')
    val_pickle = kwargs.pop('path_to_pickle_file_val')
    with tempfile.TemporaryDirectory() as tmpdir:
        gt_train, radar_train = unpack_data_struct_manifest(
            train_pickle, materialize_dirpath=tmpdir,
            materialize_prefix='train_')
        gt_val, radar_val = unpack_data_struct_manifest(
            val_pickle, materialize_dirpath=tmpdir,
            materialize_prefix='val_')
        return legacy_main.train(
            path_to_pickle_file_gt_train_paths=_as_path_pickle(
                gt_train, tmpdir, 'gt_train.pkl'),
            path_to_pickle_file_radar_train_numpys=_as_path_pickle(
                radar_train, tmpdir, 'radar_train.pkl'),
            path_to_pickle_file_gt_val_paths=_as_path_pickle(
                gt_val, tmpdir, 'gt_val.pkl'),
            path_to_pickle_file_radar_val_numpys=_as_path_pickle(
                radar_val, tmpdir, 'radar_val.pkl'),
            **kwargs)


if __name__ == '__main__':
    main()
