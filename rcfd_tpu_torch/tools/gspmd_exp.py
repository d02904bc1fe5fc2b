"""Which collectives of torch.distributed's gloo backend take CUDA tensors,
on ranks that share one card (as the 2-D mesh's ranks do on a machine with
one card: NCCL refuses two ranks on one GPU).

    python -m rcfd_tpu_torch.tools.gspmd_exp [--out gspmd_exp.json]

Two gloo ranks on cuda:0 (``parallel.run_ranks(..., shared_device=True)``),
fresh for each probe, try all_gather, all_gather_into_tensor, all_reduce
(SUM, MAX), broadcast, send/recv, reduce_scatter and all_to_all_single on
float32 and bf16 CUDA tensors, each checked against the values it must
give. Prints the card's name and power limit, a line a collective and one
JSON object. Card only. (On an H100 with torch 2.11 every one works but
send/recv, which kills a rank: the 2-D mesh's row exchange is an
all_gather.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from .. import parallel
from . import timing

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _full(device, dtype, v, size=4):
    return torch.full((size,), float(v), device=device, dtype=dtype)


def probe_one(device, name, dtype):
    """One collective on this rank: whether it gave the values it must."""
    r, n = dist.get_rank(), dist.get_world_size()
    dtype = DTYPES[dtype]

    def full(v, size=4):
        return _full(device, dtype, v, size)

    if name == 'all_gather':
        got = [full(-1) for _ in range(n)]
        dist.all_gather(got, full(r + 1))
        return all(bool((g == i + 1).all()) for i, g in enumerate(got))
    if name == 'all_gather_into_tensor':
        got = full(-1, 4 * n)
        dist.all_gather_into_tensor(got, full(r + 1))
        return bool((got.view(n, 4)[:, 0].float().cpu() ==
                     torch.arange(1, n + 1)).all())
    if name in ('all_reduce SUM', 'all_reduce MAX'):
        t = full(r + 1)
        sum_ = name.endswith('SUM')
        dist.all_reduce(t, op=dist.ReduceOp.SUM if sum_ else
                        dist.ReduceOp.MAX)
        return bool((t == (n * (n + 1) / 2 if sum_ else n)).all())
    if name == 'broadcast':
        t = full(r + 1)
        dist.broadcast(t, 1)
        return bool((t == 2).all())
    if name == 'send/recv':
        if r == 0:
            dist.send(full(7), 1)
            return True
        t = full(0)
        dist.recv(t, 0)
        return bool((t == 7).all())
    if name == 'reduce_scatter':
        t = full(-1)
        dist.reduce_scatter(t, [full(r + 1 + i) for i in range(n)])
        return bool((t == sum(q + 1 + r for q in range(n))).all())
    if name == 'all_to_all_single':
        t = full(-1, 4 * n)
        dist.all_to_all_single(t, full(r + 1, 4 * n))
        return bool((t.view(n, 4)[:, 0].float().cpu() ==
                     torch.arange(1, n + 1)).all())
    raise ValueError(name)


COLLECTIVES = ('all_gather', 'all_gather_into_tensor', 'all_reduce SUM',
               'all_reduce MAX', 'broadcast', 'send/recv', 'reduce_scatter',
               'all_to_all_single')


def probe(name, dtype):
    """``probe_one`` on two fresh gloo ranks on cuda:0 (a rank that a
    collective kills takes no other probe with it): 'ok', 'wrong values'
    or the first line of what a rank raised or how it died."""
    try:
        ranks = parallel.run_ranks(probe_one, (name, dtype), 2, 'cuda:0',
                                   shared_device=True)
    except Exception as e:  # the finding: what gloo refuses, and how
        lines = [line for line in str(e).splitlines() if line.strip()]
        return '{}: {}'.format(type(e).__name__, ' | '.join(
            line.strip() for line in lines[-2:]))
    return 'ok' if all(ranks) else 'wrong values'


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m rcfd_tpu_torch.tools.gspmd_exp')
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('gspmd_exp runs on the card only')
    card = timing.card_line('cuda')
    print(card, flush=True)
    result = dict(device=card, gloo_cuda={})
    for dtype in DTYPES:
        for name in COLLECTIVES:
            key = '{} {}'.format(name, dtype)
            result['gloo_cuda'][key] = probe(name, dtype)
            print('gloo on cuda:0, {}: {}'.format(
                key, result['gloo_cuda'][key]), flush=True)
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == '__main__':
    sys.exit(0 if main() else 1)
