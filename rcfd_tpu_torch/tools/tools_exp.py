"""The card measurements of the port's three tools, in one process:

    python -m rcfd_tpu_torch.tools.tools_exp [--out tools_exp.json]
        [--only bridgebench parity ties]

  bridgebench  ``python -m rcfd_tpu_torch.tools.bridgebench --mode all`` at
               its defaults (48 frames of 900x1600, 96 points, batch 8), in
               float32 and in bf16: frames/s of prefetch, sync and codec,
               the scatter kernel K1's launches (2 warm-ups and 6 batches a
               pass), peak memory; where the card runs out of memory
               (float32: 768 patches decoded in one chunk), again with
               RCFD_DECODE_CHUNKS=2
  parity       the parity tool's two-stage chain at the release widths
               (RadarNet patch 900x288, FusionNet at its canonical widths)
               on 8 full-size synthetic frames of 64 points
               (tools/fixtures.py), weights drawn from seeds as the tool's
               --synthetic draws them (RadarNet's output0 weight x 50), no
               reference: the chain's seconds and the three sections'
               metrics
  ties         the stage-1.5 bridge's route (RadarNet unfolded, float32,
               the 16-bit codes made on the card, K1) through
               bridgebench.run_bridge on 4 full-size frames of 60 points at
               the main script's K (64: the manifest's count rounded up to
               8) and at the _test script's K = 128, under the serving
               numerics (cuDNN's algorithms chosen by timing) and under
               cudnn.deterministic = True, benchmark = False: the depth and
               response pixels whose codes differ between the two K

It prints the card's name and power limit, a line a measurement and one
JSON object, which ``--out`` also writes. It runs on the card only.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..data import io as data_utils
from ..data.datasets import RadarNetInferenceDataset
from ..data.transforms import Transforms
from ..models import FusionNetModel
from ..nn.layers import init_parameters
from ..ops import scatter_cuda as sc
from .. import radarnet_main
from . import bridgebench, parity_protocol, timing
from .fixtures import make_radarnet_fixture

PARITY_FRAMES, PARITY_POINTS = 8, 64
TIE_FRAMES, TIE_POINTS = 4, 60


def measure_bridgebench(dtype):
    """bridgebench --mode all at its defaults; where the card runs out of
    memory, again with the decode in two chunks (RCFD_DECODE_CHUNKS=2)."""
    for chunks in (None, '2'):
        sc.scatter_quasi_dense.launches = 0
        sc.scatter_quasi_dense.launches_bf16 = 0
        saved = os.environ.pop('RCFD_DECODE_CHUNKS', None)
        if chunks:
            os.environ['RCFD_DECODE_CHUNKS'] = chunks
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            row = bridgebench.main(['--mode', 'all', '--dtype', dtype])
        except torch.OutOfMemoryError as err:
            oom = str(err).splitlines()[0]
            print('bridgebench {} RCFD_DECODE_CHUNKS={}: {}'.format(
                dtype, chunks, oom), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
            continue
        finally:
            os.environ.pop('RCFD_DECODE_CHUNKS', None)
            if saved is not None:
                os.environ['RCFD_DECODE_CHUNKS'] = saved
        row.update(wall_s=time.perf_counter() - t0,
                   decode_chunks=chunks,
                   k1_launches=sc.scatter_quasi_dense.launches,
                   k1_bf16_launches=sc.scatter_quasi_dense.launches_bf16,
                   peak_bytes=torch.cuda.max_memory_allocated())
        if chunks:
            row['default_oom'] = oom
        return row
    raise RuntimeError('bridgebench {} ran out of memory in two decode '
                       'chunks too'.format(dtype))


def measure_parity(tmp):
    """The two-stage chain at the release widths on PARITY_FRAMES frames."""
    manifests = make_radarnet_fixture(
        os.path.join(tmp, 'data'), n_samples=PARITY_FRAMES, height=900,
        width=1600, n_points=PARITY_POINTS)
    rn = bridgebench.build_model((900, 288), torch.float32, 'cpu', seed=0)
    with torch.no_grad():
        rn.decoder.output0.conv.weight.mul_(50.0)
    rn_path = os.path.join(tmp, 'radarnet.pth')
    rn.save_checkpoint(rn_path, 0)
    fn = FusionNetModel(
        input_channels_image=3, input_channels_depth=2,
        encoder_type='fusionnet18_batch_norm',
        n_filters_encoder_image=[32, 64, 128, 256, 256, 256],
        n_filters_encoder_depth=[16, 32, 64, 128, 128, 128],
        fusion_type='weight_and_project',
        decoder_type='multiscale_batch_norm', n_resolution_decoder=1,
        n_filters_decoder=[256, 256, 128, 64, 64, 32], device='cpu')
    init_parameters(fn, torch.Generator().manual_seed(1))
    fn_path = os.path.join(tmp, 'fusionnet.pth')
    fn.save_checkpoint(fn_path, 0)
    argv = ['--two_stage', '--skip_reference',
            '--radarnet_checkpoint', rn_path, '--fusionnet_checkpoint',
            fn_path, '--image_path', manifests['image'], '--radar_path',
            manifests['radar'], '--ground_truth_path',
            manifests['ground_truth'], '--output_dirpath',
            os.path.join(tmp, 'parity')]
    sc.scatter_quasi_dense.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ref, ours, overall = parity_protocol.main(argv)
    wall = time.perf_counter() - t0
    return dict(frames=PARITY_FRAMES, points=PARITY_POINTS, wall_s=wall,
                overall=overall, metrics=ours,
                k1_launches=sc.scatter_quasi_dense.launches)


@contextlib.contextmanager
def heuristic_numerics():
    """The serving numerics but for cuDNN's choice: deterministic
    algorithms picked by its heuristics (benchmark off), not by timing."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32)
    cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32 = False, True, False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        (cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = saved


def measure_ties(tmp):
    """The bridge's route at K = 64 and K = 128 under both numerics: the
    pixels whose 16-bit codes differ between the two K."""
    from ..pipeline import serving_numerics

    manifests = make_radarnet_fixture(
        os.path.join(tmp, 'ties'), n_samples=TIE_FRAMES, height=900,
        width=1600, n_points=TIE_POINTS, seed=1)
    images = data_utils.read_paths(manifests['image'])
    radar = data_utils.read_paths(manifests['radar'])
    model = bridgebench.build_model((900, 288), torch.float32, 'cuda')
    forward = radarnet_main.make_forward_fn_batched(
        model, Transforms(normalized_image_range=[0, 1]), 900, 1600,
        codec_encode=True)
    out = {}
    for label, numerics in (('serving', serving_numerics),
                            ('heuristic', heuristic_numerics)):
        codes = {}
        for k in (None, 128):
            dataset = RadarNetInferenceDataset(images, radar, max_points=k,
                                               device='cuda')
            out_dir = os.path.join(tmp, 'ties_{}_{}'.format(label, k))
            bridgebench.run_bridge('codec', forward, dataset, out_dir,
                                   8, 'cuda', numerics)
            _, _, paths = bridgebench.run_bridge(
                'codec', forward, dataset, out_dir, 8, 'cuda', numerics)
            codes[dataset.max_points] = [
                (data_utils.load_depth_raw(p),
                 data_utils.load_depth_raw(p.replace('depth_', 'resp_')))
                for p in paths]
        (k_main, a), (_, b) = sorted(codes.items())
        depth = [int((x[0] != y[0]).sum()) for x, y in zip(a, b)]
        resp = [int((np.abs(x[1] - y[1]) > 0).sum()) for x, y in zip(a, b)]
        out[label] = dict(k_main=k_main, depth_pixels=depth,
                          response_pixels=resp,
                          covered=[int((x[0] > 0).sum()) for x in a])
    return out


def _valid_rows(t, b, k, n):
    """Rows of the first ``n`` points of each of ``b`` frames of ``k``."""
    return t.reshape(b, k, *t.shape[1:])[:, :n].reshape(b * n, *t.shape[1:])


def measure_tie_cause(tmp, device='cuda', height=900, width=1600,
                      patch=(900, 288)):
    """Where K = 64 and K = 128 part, under cudnn.deterministic with
    benchmark off: RadarNet's stages on the same 4 frames of TIE_POINTS
    valid points, padded to each K, the valid points' rows compared bit for
    bit: the point MLP's features (one matmul a layer over B * K rows), the
    fused latent, the response crops; and the decoder alone on the K = 64
    latent and skips stacked twice (a batch of 2 B * 64), against its
    decode of them once."""
    import torch.nn.functional as tf

    from ..data import transport

    manifests = make_radarnet_fixture(
        os.path.join(tmp, 'tie_cause'), n_samples=TIE_FRAMES, height=height,
        width=width, n_points=TIE_POINTS, seed=1)
    images = data_utils.read_paths(manifests['image'])
    radar = data_utils.read_paths(manifests['radar'])
    model = bridgebench.build_model(patch, torch.float32, device)
    pad = patch[1] // 2
    transforms = Transforms(normalized_image_range=[0, 1])
    stages = {}
    with torch.inference_mode(), heuristic_numerics():
        for k in (64, 128):
            dataset = RadarNetInferenceDataset(images, radar, max_points=k,
                                               device=device)
            batch = [torch.from_numpy(np.stack([dataset.get(i)[j] for i in
                                                range(TIE_FRAMES)])).to(
                                                    device)
                     for j in range(2)]
            image_t = transforms.transform(transport.decode(
                batch[0])).permute(0, 3, 1, 2)
            image_pad = tf.pad(image_t, (pad, pad, 0, 0), mode='replicate')
            points = batch[1].float()
            xs = points[..., 0] + pad
            shifted = torch.stack([xs, points[..., 1], points[..., 2]], -1)
            encoded = model.encoder.encode_image(image_pad)
            flat = shifted.reshape(-1, 3)
            mlp = model.encoder.encoder_depth(flat)
            latent, skips = model.encoder.fuse_points(
                *encoded, flat, xs - pad, height)
            crops = model._decode(latent, skips, return_logits=False)
            stages[k] = dict(
                image_latent=encoded[0],
                mlp=_valid_rows(mlp, TIE_FRAMES, k, TIE_POINTS),
                latent=_valid_rows(latent, TIE_FRAMES, k, TIE_POINTS),
                crops=_valid_rows(crops, TIE_FRAMES, k, TIE_POINTS))
            if k == 64:
                twice = model._decode(
                    torch.cat([latent, latent]),
                    [torch.cat([s, s]) for s in skips], return_logits=False)
                stages['decoder_twice'] = dict(
                    crops=(crops, twice[:crops.shape[0]]))
    out = {}
    for name in ('image_latent', 'mlp', 'latent', 'crops'):
        a, b = stages[64][name], stages[128][name]
        out[name] = dict(elements=a.numel(),
                         differ=int((a != b).sum()),
                         max_abs=float((a - b).abs().max()))
    a, b = stages['decoder_twice']['crops']
    out['decoder_batch_twice'] = dict(elements=a.numel(),
                                      differ=int((a != b).sum()),
                                      max_abs=float((a - b).abs().max()))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.tools_exp')
    parser.add_argument('--out', default=None)
    parser.add_argument('--only', nargs='+', default=None,
                        choices=['bridgebench', 'parity', 'ties'],
                        help='run these measurements only')
    args = parser.parse_args(argv)
    runs = set(args.only or ('bridgebench', 'parity', 'ties'))
    if not torch.cuda.is_available():
        raise SystemExit('tools_exp runs on the card only')
    card = timing.card_line('cuda')
    print(card, flush=True)
    result = dict(device=card)
    with tempfile.TemporaryDirectory() as tmp:
        if 'bridgebench' in runs:
            for dtype in ('float32', 'bfloat16'):
                row = result['bridgebench_' + dtype] = \
                    measure_bridgebench(dtype)
                print('bridgebench {}: {}'.format(dtype, json.dumps(row)),
                      flush=True)
        if 'parity' in runs:
            result['parity'] = measure_parity(tmp)
            print('parity: {}'.format(json.dumps(result['parity'])),
                  flush=True)
        if 'ties' in runs:
            result['ties'] = measure_ties(tmp)
            print('ties: {}'.format(json.dumps(result['ties'])), flush=True)
            result['tie_cause'] = measure_tie_cause(tmp)
            print('tie cause: {}'.format(json.dumps(result['tie_cause'])),
                  flush=True)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
