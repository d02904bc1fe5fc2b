"""The card runs of the port's measurement tools, at the JAX tools'
defaults, in one process:

    python -m rcfd_tpu_torch.tools.bench_tools_exp [--out runs.json]
        [--only roofline trainbench stagebench ...]

  roofline     both graphs (fusionnet_b32 at b = 32; pipeline_k64 at b = 4,
               K = 64) in bf16 and in float32, 10 and 20 chained calls
  trainbench   ``--model canonical`` of both families at the JAX tool's
               usage flags (FusionNet 448x448 crops, batch 8; RadarNet
               900x1600 frames, patch 900x288, batch 6), 20 steps after 3
  stagebench, rnstagebench, fnbisect, pipebisect, microbench,
  fusedskip_bench, fusepool_experiment
               at their defaults (pipebisect at the pipeline's default
               scatter, the exact max)

Each tool's printed output goes to stdout as it runs. The card's name and
power limit come first, then a line a run with its seconds, and one JSON
object last (each run's row), which ``--out`` also writes. It runs on the
card only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

import torch

from . import timing

RUNS = (
    ('roofline', ['--graph', 'fusionnet_b32']),
    ('roofline', ['--graph', 'fusionnet_b32', '--dtype', 'float32']),
    ('roofline', ['--graph', 'pipeline_k64']),
    ('roofline', ['--graph', 'pipeline_k64', '--dtype', 'float32']),
    ('trainbench', ['--model', 'canonical', '--height', '448', '--width',
                    '448', '--batch_size', '8']),
    ('trainbench', ['--family', 'radarnet', '--model', 'canonical',
                    '--height', '900', '--width', '1600', '--batch_size',
                    '6']),
    ('stagebench', []),
    ('rnstagebench', []),
    ('fnbisect', []),
    ('pipebisect', []),
    ('microbench', []),
    ('fusedskip_bench', []),
    ('fusepool_experiment', []),
)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.bench_tools_exp')
    parser.add_argument('--out', default=None)
    parser.add_argument('--only', nargs='+', default=None,
                        choices=sorted({name for name, _ in RUNS}),
                        help='run these tools only')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('bench_tools_exp runs on the card only')
    card = timing.card_line('cuda')
    print(card, flush=True)
    result = dict(device=card, runs=[])
    with tempfile.TemporaryDirectory() as tmp:
        for name, tool_argv in RUNS:
            if args.only and name not in args.only:
                continue
            if name == 'trainbench':
                tool_argv = tool_argv + ['--data_dir', os.path.join(
                    tmp, 'trainbench_{}'.format(len(result['runs'])))]
            tool = importlib.import_module('rcfd_tpu_torch.tools.' + name)
            print('== {} {}'.format(name, ' '.join(tool_argv)), flush=True)
            t0 = time.perf_counter()
            row = tool.main(tool_argv)
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.empty_cache()
            print('== {}: {:.1f} s, peak {:.2f} GiB'.format(name, seconds,
                                                           peak), flush=True)
            result['runs'].append(dict(tool=name, argv=tool_argv,
                                       seconds=seconds, peak_gib=peak,
                                       row=row))
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
