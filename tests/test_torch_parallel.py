"""Data parallelism of the port (rcfd_tpu_torch.parallel: the launcher
and the collectives, the data-parallel count, the loader's slices, the
data-parallel train step, TwoStagePipeline.forward_sharded and
run_pipeline --data_parallel) against the JAX package's
(rcfd_tpu/parallel/mesh.py: data_parallel_step, get_mesh; the loader's
process slices; forward_sharded) on the CPU, where the port's ranks are
gloo processes and JAX's devices the 8 virtual CPU devices of
tests/conftest.py. The trainings on two ranks are
tests/test_torch_parallel_train.py's. Each test states its tolerance."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rcfd_tpu import fusionnet_main as jax_fn_main  # noqa: E402
from rcfd_tpu import pipeline as jax_pipeline  # noqa: E402
from rcfd_tpu import radarnet_main as jax_rn_main  # noqa: E402
from rcfd_tpu.data import loader as jax_loader  # noqa: E402
from rcfd_tpu.data.transforms import Transforms as JaxTransforms  # noqa
from rcfd_tpu.models import FusionNetModel as JaxFusionNet  # noqa: E402
from rcfd_tpu.models import RadarNetModel as JaxRadarNet  # noqa: E402
from rcfd_tpu.parallel import mesh as jax_mesh  # noqa: E402
from rcfd_tpu.utils import checkpoint as jax_ckpt  # noqa: E402

from rcfd_tpu_torch import fusionnet_main, parallel  # noqa: E402
from rcfd_tpu_torch import run_pipeline as port_cli  # noqa: E402
from rcfd_tpu_torch import training  # noqa: E402
from rcfd_tpu_torch.data.loader import DataLoader  # noqa: E402
from rcfd_tpu_torch.data.transforms import Transforms  # noqa: E402
from rcfd_tpu_torch.models import FusionNetModel, RadarNetModel  # noqa: E402
from rcfd_tpu_torch.nn.perf import PerfConfig  # noqa: E402
from rcfd_tpu_torch.pipeline import TwoStagePipeline  # noqa: E402
from rcfd_tpu_torch.utils.checkpoint import state_dict_from_jax  # noqa: E402

import test_torch_batched as batched_tests  # noqa: E402
import test_torch_train as fn_tests  # noqa: E402
import test_torch_train_radarnet as rn_tests  # noqa: E402
import torch_parallel  # noqa: E402
from fixtures import make_radarnet_fixture  # noqa: E402
from torch_parity import (FUSIONNET_TINY, H, RADARNET_TINY, W,  # noqa: E402
                          frame_and_points, jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = 2.0 ** -14


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """Tiny steps on one thread (tests/test_torch_train.py); the spawned
    ranks take the caller's thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the launcher and the collectives -----------------------------------------


def test_ranks_average_and_broadcast():
    """Two gloo ranks: each result comes back in rank order, the mean of 1
    and 2 is 1.5 on both, rank 0's object reaches rank 1."""
    out = parallel.run_ranks(torch_parallel.gathered, (5,), 2, 'cpu')
    assert [r[:2] for r in out] == [(0, 2), (1, 2)]
    for _, _, mean, obj in out:
        np.testing.assert_array_equal(mean, np.full(5, 1.5, np.float32))
        assert obj == {'from': 0}


def test_a_failing_rank_fails_the_caller():
    """A rank that raises fails run_ranks with its traceback, while the
    other rank returns, and while the other rank waits for it at a barrier
    (whose broken connection may end that rank first): the raise leads
    the error either way, and nothing hangs."""
    for wait in (False, True):
        with pytest.raises(RuntimeError, match='(?s)^rank 1 raised:.*'
                                               'rank 1 fails on purpose'):
            parallel.run_ranks(torch_parallel.raises_on_rank_1, (wait,), 2,
                               'cpu')


def test_one_rank_group_step_equals_the_plain_step(rng):
    """In a process group of one rank, data_parallel_step's step (the
    all-reduce of one rank and the division by 1) equals the unwrapped
    step bit for bit: loss_info, gradients, parameters and buffers."""
    batch = tuple(torch.from_numpy(a.astype(np.float32))
                  for a in fn_tests._batch(rng, n=2))
    outs = []
    for wrap in (False, True):
        torch.manual_seed(0)
        model = FusionNetModel(**fn_tests.CONFIG, device='cpu',
                               trainable=True)
        transforms = Transforms(normalized_image_range=[0, 1])
        step = fusionnet_main.TrainStep(
            model, transforms, fusionnet_main.make_optimizer(model, 1e-3,
                                                             0.0),
            w_smoothness=0.0, loss_smoothness_kernel_size=-1,
            **{k: v for k, v in fn_tests.STEP_KW.items()
               if k != 'w_weight_decay'})
        draws = transforms.draws(torch.Generator().manual_seed(0), 2, 0.0)
        if wrap:
            address = 'tcp://127.0.0.1:{}'.format(parallel.free_port())
            with parallel.process_group('gloo', address, 1, 0):
                info = parallel.data_parallel_step(step)(batch, draws, 1e-3)
        else:
            info = step(batch, draws, 1e-3)
        outs.append((info, {n: t.detach().clone() for n, t in
                            list(model.named_parameters()) +
                            list(model.named_buffers())},
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}))
    (info_a, state_a, grad_a), (info_b, state_b, grad_b) = outs
    assert sorted(info_a) == sorted(info_b)
    assert all(torch.equal(info_a[k], info_b[k]) for k in info_a)
    assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
    assert sorted(grad_a) == sorted(grad_b)
    assert all(torch.equal(grad_a[k], grad_b[k]) for k in grad_a)


def test_shard_threads_and_launch_counts_under_contention():
    """Sixteen shard slots (more than the cores) counting kernel launches
    under a shortened switch interval: every slot's result comes back in
    slot order from the same thread on a second map, the launch count
    loses no update (its lock), and a slot's exception reaches the
    caller."""
    import threading
    from rcfd_tpu_torch.ops import _build
    from rcfd_tpu_torch.ops import scatter_cuda as sc

    threads = parallel.shard_threads(16)
    n = 20000

    def count(i):
        for _ in range(n):
            _build.count_launch(sc.scatter_quasi_dense, torch.float32)
        return i, threading.get_ident()

    before = sc.scatter_quasi_dense.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        first = threads.map(count, [(i,) for i in range(16)])
        second = threads.map(count, [(i,) for i in range(16)])
    finally:
        sys.setswitchinterval(interval)
        after = sc.scatter_quasi_dense.launches
        sc.scatter_quasi_dense.launches = before
    assert [r[0] for r in first] == list(range(16))
    assert first == second
    assert len({r[1] for r in first}) == 16
    assert after - before == 2 * 16 * n

    def fails(i):
        if i == 3:
            raise KeyError('slot 3')
        return i

    with pytest.raises(KeyError, match='slot 3'):
        threads.map(fails, [(i,) for i in range(16)])
    assert parallel.shard_threads(16) is threads


# -- the data-parallel count, the refusals and the multi-host contract --------


@pytest.mark.parametrize('device,n,cards,batch,hosts,expect', [
    ('cpu', None, 0, 4, 1, 1),
    ('cpu', 2, 0, 4, 1, 2),
    ('cpu', None, 0, 4, 2, 2),
    ('cuda', None, 2, 4, 1, 2),
    ('cuda', None, 1, 4, 1, 1),
    ('cuda', 4, 2, 8, 2, 4),
    ('cuda', 2, 1, 4, 1, 'card'),
    ('cpu', 3, 0, 4, 1, 'batch_size'),
    ('cuda', None, 4, 6, 1, 'batch_size'),
    ('cpu', 3, 0, 6, 2, 'hosts'),
])
def test_data_parallel_count(monkeypatch, device, n, cards, batch, hosts,
                             expect):
    """JAX's n_devices = n_data_parallel or jax.device_count(), with its
    assertions as ValueErrors: None is every visible card (of every host)
    on CUDA and a rank a host on the CPU; no more ranks than the hosts'
    cards; the global batch must divide by the count."""
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    layout = parallel.HostLayout('127.0.0.1:1', hosts, 0) if hosts > 1 \
        else None
    args = (torch.device(device), n, batch, layout)
    if isinstance(expect, str):
        with pytest.raises(ValueError, match=expect):
            training.data_parallel_count(*args)
    else:
        assert training.data_parallel_count(*args) == expect


def test_maybe_initialize_distributed_reads_the_contract(monkeypatch):
    """RCFD_COORDINATOR / RCFD_NUM_PROCESSES / RCFD_PROCESS_ID, the JAX
    package's contract: None without a coordinator, the layout with one,
    a process id outside the processes refused."""
    for name in ('RCFD_COORDINATOR', 'RCFD_NUM_PROCESSES',
                 'RCFD_PROCESS_ID'):
        monkeypatch.delenv(name, raising=False)
    assert parallel.maybe_initialize_distributed() is None
    monkeypatch.setenv('RCFD_COORDINATOR', 'host0:1234')
    monkeypatch.setenv('RCFD_NUM_PROCESSES', '4')
    monkeypatch.setenv('RCFD_PROCESS_ID', '3')
    assert parallel.maybe_initialize_distributed() == parallel.HostLayout(
        'host0:1234', 4, 3)
    monkeypatch.setenv('RCFD_PROCESS_ID', '4')
    with pytest.raises(ValueError, match='RCFD_PROCESS_ID'):
        parallel.maybe_initialize_distributed()


def test_devices_and_shards():
    """get_devices on the CPU (n entries; one by default) and without a
    card; shard_batch's contiguous slices and its refusal."""
    assert parallel.get_devices(3, 'cpu') == [torch.device('cpu')] * 3
    assert parallel.get_devices(device='cpu') == [torch.device('cpu')]
    a, b = np.arange(12).reshape(6, 2), torch.arange(6)
    shards = parallel.shard_batch((a, b), 3)
    assert [s[1].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5]]
    np.testing.assert_array_equal(np.concatenate([s[0] for s in shards]), a)
    with pytest.raises(ValueError, match='equal shards'):
        parallel.shard_batch((a, b), 4)


# -- the loader's slices ------------------------------------------------------


class Samples:
    """A dataset whose samples are their index and two draws of their
    Generator."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def get(self, index, rng):
        return np.array([index]), rng.random(2)


@pytest.mark.parametrize('count', [2, 3])
def test_loader_slices_match_jax(count):
    """Each process's slice of each batch against the JAX package's
    DataLoader(process_index=, process_count=) at the same seed and epoch
    (14 samples, global batch 6, shuffled: the ragged tail dropped):
    indices and the samples' draws equal; resumed at global batch 1, the
    rest of the epoch; the slices side by side are one process's
    batches."""
    kw = dict(batch_size=6, shuffle=True, num_workers=2, seed=7)
    whole = DataLoader(Samples(14), drop_last=True, **kw)
    whole.set_epoch(3)
    whole = list(whole)
    slices = []
    for index in range(count):
        port = DataLoader(Samples(14), process_index=index,
                          process_count=count, **kw)
        ref = jax_loader.DataLoader(Samples(14), process_index=index,
                                    process_count=count, **kw)
        port.set_epoch(3)
        ref.set_epoch(3)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == len(ref) == 2
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert len(x) == 6 // count
        port.set_epoch(3, start_batch=1)
        resumed = list(port)
        assert len(resumed) == 1
        for x, y in zip(resumed[0], want[1]):
            np.testing.assert_array_equal(x, y)
        slices.append(got)
    for step, batch in enumerate(whole):
        for j, x in enumerate(batch):
            np.testing.assert_array_equal(
                np.concatenate([s[step][j] for s in slices]), x)


def test_loader_refuses_a_batch_the_processes_do_not_divide():
    with pytest.raises(ValueError, match='process count'):
        DataLoader(Samples(8), batch_size=4, process_count=3)


# -- sharded serving ----------------------------------------------------------


B_SHARDED, K_SHARDED = 8, 8


@pytest.fixture(scope='module')
def serving():
    """The JAX pipeline and the port's two routes (the exact float max,
    and K1's plain version under pallas_scatter=True) on the same tiny
    weights, and a batch of 8 frames of 8 points."""
    rng = np.random.default_rng(40)
    jr, jf = JaxRadarNet(**RADARNET_TINY), JaxFusionNet(**FUSIONNET_TINY)
    rv, fv = jax_variables(jr, 0, rng), jax_variables(jf, 1, rng)
    ports = {}
    for route, pallas in (('exact', False), ('k1', True)):
        rn = RadarNetModel(**RADARNET_TINY, device='cpu',
                           perf=PerfConfig(pallas_scatter=pallas))
        rn.load_state_dict(state_dict_from_jax(*rv), strict=True)
        fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
        fn.load_state_dict(state_dict_from_jax(*fv), strict=True)
        ports[route] = TwoStagePipeline(rn, fn, H, W, device='cpu')
    frames = [frame_and_points(rng, k=K_SHARDED) for _ in range(B_SHARDED)]
    batch = (np.concatenate([f[0] for f in frames]),
             np.stack([f[1] for f in frames]),
             np.stack([f[2] for f in frames]))
    return dict(jax=jax_pipeline.TwoStagePipeline(jr, jf, rv, fv, H, W),
                crops=lambda images, points: batched_tests._jax_crops(
                    jr, rv, images, points),
                ports=ports, batch=batch)


@pytest.mark.parametrize('n', [2, 8])
@pytest.mark.parametrize('route', ['exact', 'k1'])
def test_forward_sharded_matches_forward_batched(serving, route, n):
    """forward_sharded over n cpu entries against forward_batched on the
    same pipeline (the JAX package's test uses 1e-5): quasi depth and
    response equal, dense within 1e-5 m; the batch must split evenly; the
    replicas are kept per device list, and a device that repeats reuses
    the pipeline's own models."""
    pipe = serving['ports'][route]
    batch = serving['batch']
    out = [o.numpy() for o in pipe.forward_sharded(*batch,
                                                   devices=['cpu'] * n)]
    ref = [o.numpy() for o in pipe.forward_batched(*batch)]
    assert out[0].shape == (B_SHARDED, H, W)
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-5)
    assert (ref[2] > 0).sum() > 300
    replicas = pipe._sharded
    assert len(replicas) == n and all(r is pipe for r in replicas)
    pipe.forward_sharded(*batch, devices=['cpu'] * n)
    assert pipe._sharded is replicas
    with pytest.raises(ValueError, match='equal shards'):
        pipe.forward_sharded(*batch, devices=['cpu'] * 3)


def test_forward_sharded_replicas_on_another_device():
    """The replicas of a device list holding a device other than the
    pipeline's ('meta' here, a card on a multi-card host): one copy of the
    models for that device, however often it repeats, its weights moved
    there and the pipeline's own untouched; the pipeline itself for its own
    device; the list kept until another one is asked for."""
    rn = RadarNetModel(**RADARNET_TINY, device='cpu')
    fn = FusionNetModel(**FUSIONNET_TINY, device='cpu')
    pipe = TwoStagePipeline(rn, fn, H, W, device='cpu')
    meta, cpu = torch.device('meta'), torch.device('cpu')
    replicas = pipe._replicas([meta, cpu, meta])
    replica = replicas[0]
    assert replica is not pipe and replicas[2] is replica
    assert replicas[1] is pipe
    assert replica.device == meta and pipe.device == cpu
    for mine, theirs in ((replica.radarnet, pipe.radarnet),
                         (replica.fusionnet, pipe.fusionnet)):
        assert mine is not theirs
        assert all(t.device == meta for t in mine.state_dict().values())
        assert all(t.device == cpu for t in theirs.state_dict().values())
    assert pipe._replicas([meta, cpu, meta]) is replicas
    assert pipe._replicas([cpu, cpu]) == [pipe, pipe]


@pytest.mark.parametrize('n', [2, 8])
def test_forward_sharded_matches_jax(serving, n):
    """The port's forward_sharded (exact max) against the JAX package's
    forward_sharded over get_mesh(n) on the same weights, with
    tests/test_torch_batched.py's rules: the response within one 2^-14
    step; a differing quasi pixel only at a same-step tie or within 1e-5
    of an edge; dense within 1e-3 m in each frame without one."""
    images, points, valid = serving['batch']
    ref = [np.asarray(a) for a in serving['jax'].forward_sharded(
        jnp.asarray(images), jnp.asarray(points), jnp.asarray(valid),
        mesh=jax_mesh.get_mesh(n))]
    out = [o.numpy() for o in serving['ports']['exact'].forward_sharded(
        images, points, valid, devices=['cpu'] * n)]
    assert np.abs(out[2] - ref[2]).max() <= Q
    differ = np.argwhere(out[1] != ref[1])
    crops = serving['crops'](images, points)
    assert not batched_tests._unexplained(crops, points, valid, differ)
    checked = [f for f in range(B_SHARDED) if not (differ[:, 0] == f).any()]
    assert len(checked) >= B_SHARDED // 2
    for f in checked:
        np.testing.assert_allclose(out[0][f], ref[0][f], rtol=0, atol=1e-3)


@pytest.fixture(scope='module')
def pipeline_files(tmp_path_factory):
    """Six frames and two .pth checkpoints of the port's tiny models (the
    test_torch_cli.py widths) for run_pipeline."""
    root = tmp_path_factory.mktemp('serve')
    manifests = make_radarnet_fixture(str(root / 'data'), n_samples=6,
                                      height=64, width=96)
    gen = torch.Generator().manual_seed(3)
    from rcfd_tpu_torch.nn import init_parameters
    import test_torch_cli as cli_tests
    rn = RadarNetModel(**cli_tests.RADARNET, device='cpu')
    fn = FusionNetModel(**cli_tests.FUSIONNET, device='cpu')
    init_parameters(rn, gen)
    init_parameters(fn, gen)
    paths = [str(root / 'radarnet-1.pth'), str(root / 'fusionnet-1.pth')]
    rn.save_checkpoint(paths[0], 1)
    fn.save_checkpoint(paths[1], 1)
    return dict(root=root, common=[
        '--radarnet_restore_path', paths[0],
        '--fusionnet_restore_path', paths[1],
        '--image_path', manifests['image'],
        '--radar_path', manifests['radar'], *cli_tests.NET_ARGS,
        '--save_outputs', '--batch_size', '4'])


def test_run_pipeline_data_parallel(pipeline_files, monkeypatch):
    """run_pipeline --data_parallel over two cpu entries at batch 4 on six
    frames (a sharded batch of 4, then the tail of 2 through
    forward_batched): its files equal the run without the flag, byte for
    byte, and it logs the device count."""
    for name in ('RCFD_PALLAS_SCATTER', 'RCFD_FUSED_POOL2',
                 'RCFD_FUSED_POOL4', 'RCFD_DECODE_CHUNKS'):
        monkeypatch.delenv(name, raising=False)
    calls = []
    sharded = TwoStagePipeline.forward_sharded

    def counted(self, images, *args, **kw):
        calls.append(len(images))
        return sharded(self, images, *args, **kw)

    monkeypatch.setattr(TwoStagePipeline, 'forward_sharded', counted)
    root = pipeline_files['root']
    outs = {}
    for name, flags in (('plain', []), ('sharded', ['--data_parallel'])):
        outs[name] = str(root / name)
        port_cli.main(pipeline_files['common'] + flags + [
            '--output_dirpath', outs[name]], device='cpu',
            devices=['cpu', 'cpu'] if flags else None)
    assert calls == [4]
    n_files = 0
    for stream in port_cli.STREAMS:
        names = sorted(os.listdir(os.path.join(outs['plain'], stream)))
        assert names == sorted(os.listdir(os.path.join(outs['sharded'],
                                                       stream)))
        for name in names:
            with open(os.path.join(outs['plain'], stream, name), 'rb') as f:
                plain = f.read()
            with open(os.path.join(outs['sharded'], stream, name),
                      'rb') as f:
                assert f.read() == plain, (stream, name)
            n_files += 1
    assert n_files == 18
    with open(os.path.join(outs['sharded'], 'results.txt')) as f:
        assert 'Data-parallel serving over 2 device(s)' in f.read()


def test_run_pipeline_data_parallel_needs_a_dividing_batch(pipeline_files,
                                                           tmp_path):
    """A batch size that the device count does not divide exits before
    anything is served or written, as the JAX CLI exits."""
    with pytest.raises(SystemExit, match='divisible by the device count'):
        port_cli.main(pipeline_files['common'] + [
            '--data_parallel', '--output_dirpath', str(tmp_path / 'o')],
            device='cpu', devices=['cpu'] * 3)
    assert not os.path.exists(str(tmp_path / 'o'))


# -- the data-parallel train step against JAX's -------------------------------


def _jax_dp_step(jax_main, model, transforms, params, state, batch, key,
                 p, **kw):
    """JAX's data_parallel_step over get_mesh(2) of the driver's step with
    axis_name='data', its Adam swapped for a function that hands back the
    (pmean'd) gradients: (params, grads, new_state, loss_info), numpy."""
    step = jax_mesh.data_parallel_step(
        jax_mesh.get_mesh(2), jax_main._make_train_step(
            model, transforms, axis_name='data', **kw))
    grads, new_state, _, info = step(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), None,
        tuple(jnp.asarray(a) for a in batch), key, 1e-3, p)
    return (params,) + tuple(jax.device_get((grads, new_state, info)))


@pytest.fixture(scope='module')
def dp_steps():
    """One float64 train step of each model on 2 gloo ranks and through
    JAX's data_parallel_step over 2 devices, on the same weights and
    batches: FusionNet (augmentation off) and RadarNet at the 32x36 patch
    (the variable-bin pools) with augmentation drawn (JAX's draws for the
    local batch from the replicated key, handed to both ranks); each batch
    with its second half moved, so that each half's batch statistics
    differ from the whole batch's."""
    rng = np.random.default_rng(41)
    mp = pytest.MonkeyPatch()
    cases, refs = [], []
    # the weights are drawn before x64 is on, so that the inits compiled
    # for the other tests serve these too
    fn_vars = fn_tests._jax_variables(0, rng, np.float64)
    rn_vars = rn_tests._jax_variables(rn_tests.WIDE, 0, rng, np.float64)
    jax.config.update('jax_enable_x64', True)
    try:
        for main in (jax_fn_main, jax_rn_main):
            mp.setattr(main, 'adam_step',
                       lambda p, grads, opt, lr, weight_decay: (grads, opt))
        # the JAX package's variable-bin window under x64
        # (tests/test_torch_train_radarnet.py)
        dynamic_slice = jax.lax.dynamic_slice
        mp.setattr(jax.lax, 'dynamic_slice', lambda x, idx, size: (
            dynamic_slice(x, [jnp.asarray(i, jnp.int32) for i in idx],
                          size)))
        params, state = fn_vars
        batch = list(fn_tests._batch(rng, n=4))
        batch[0][2:] = batch[0][2:] * 0.4 + 60.0
        batch[1][2:] = batch[1][2:] * 1.7
        step_kw = dict(w_smoothness=0.1, loss_smoothness_kernel_size=7,
                       **{k: v for k, v in fn_tests.STEP_KW.items()
                          if k != 'w_weight_decay'})
        refs.append(_jax_dp_step(
            jax_fn_main, JaxFusionNet(**fn_tests.CONFIG),
            JaxTransforms(normalized_image_range=[0, 1]), params, state,
            batch, jax.random.PRNGKey(3), 0.0, w_weight_decay=0.0,
            **step_kw))
        cases.append(dict(
            kind='fusionnet', config=fn_tests.CONFIG,
            state_dict=state_dict_from_jax(params, state),
            transforms=dict(normalized_image_range=[0, 1]), step=step_kw,
            batch=tuple(batch), lr=1e-3,
            draws=Transforms(normalized_image_range=[0, 1]).draws(
                torch.Generator().manual_seed(0), 2, 0.0)))
        patch = rn_tests.WIDE
        params, state = rn_vars
        batch = list(rn_tests._batch(rng, patch, b=2))
        batch[0][1:] = batch[0][1:] * 0.3 + 40.0
        tkw = dict(normalized_image_range=[0, 1],
                   random_noise_type='gaussian', random_noise_spread=1.0,
                   **rn_tests.AUGMENT)
        # a key that draws every op for the shards' one frame (under x64)
        key = jax.random.PRNGKey(3)
        step_kw = dict(patch_size=patch, set_invalid_to_negative_class=False,
                       **rn_tests.STEP_KW)
        refs.append(_jax_dp_step(
            jax_rn_main, JaxRadarNet(**rn_tests.config(patch)),
            JaxTransforms(**tkw), params, state, batch, key, 0.8,
            w_weight_decay=0.0, **step_kw))
        # every shard draws for its own frame from the replicated key
        draws = rn_tests.jax_draws(key, Transforms(**tkw), 1, 0.8,
                                   (1, rn_tests.K, 3))
        assert bool(draws['noise_gate'].any()) and \
            bool(draws['horizontal_flip'].any())
        cases.append(dict(
            kind='radarnet', config=rn_tests.config(patch),
            state_dict=state_dict_from_jax(params, state), transforms=tkw,
            step=step_kw, batch=tuple(batch), lr=1e-3, draws=draws))
    finally:
        jax.config.update('jax_enable_x64', False)
        mp.undo()
    ranks = parallel.run_ranks(torch_parallel.step_cases, (cases,), 2, 'cpu')
    return cases, refs, ranks


def _port_step(spec, batch, draws):
    """The port's unwrapped step of ``spec`` in this process: its model."""
    model_cls, main = torch_parallel.MODELS[spec['kind']]
    model = model_cls(**spec['config'], device='cpu', trainable=True)
    model.load_state_dict(spec['state_dict'], strict=True)
    model = model.to(torch.float64)
    step = main.TrainStep(model, Transforms(**spec['transforms']),
                          main.make_optimizer(model, spec['lr'], 0.0),
                          **spec['step'])
    step(tuple(torch.from_numpy(a) for a in batch), draws, spec['lr'])
    return model


@pytest.mark.parametrize('case', [0, 1], ids=['fusionnet', 'radarnet'])
def test_data_parallel_step_matches_jax_float64(dp_steps, case):
    """Each rank's step against JAX's data_parallel_step: loss_info rtol
    1e-10; every averaged gradient within 1e-8 of its max-abs (the
    single-device test's bound); the running statistics (the average of
    the two halves' own) rtol 1e-10, the batch counts 1; the parameters
    equal on both ranks, bit for bit, and within 1e-10 of each tensor's
    max-abs of torch's Adam on JAX's averaged gradients."""
    cases, refs, ranks = dp_steps
    spec = cases[case]
    params, grads, new_state, info = refs[case]
    grads = jax_ckpt.tree_to_torch_state_dict(grads)
    ref_state = state_dict_from_jax(params, new_state)
    a, b = (r[case] for r in ranks)
    assert sorted(a['info']) == sorted(info)
    for k in info:
        np.testing.assert_allclose(a['info'][k], float(info[k]),
                                   rtol=1e-10, err_msg=k)
        assert a['info'][k] == b['info'][k]
    checked = 0
    for name, g in a['grads'].items():
        ref = np.asarray(grads[name])
        assert np.abs(g - ref).max() <= 1e-8 * max(np.abs(ref).max(),
                                                   1e-300), name
        np.testing.assert_array_equal(g, b['grads'][name])
        checked += int(np.abs(ref).max() > 0)
    assert checked > 60
    for name, buf in a['buffers'].items():
        np.testing.assert_array_equal(buf, b['buffers'][name])
        if name.endswith('num_batches_tracked'):
            assert int(buf) == 1, name
        else:
            np.testing.assert_allclose(buf, ref_state[name].numpy(),
                                       rtol=1e-10, err_msg=name)
    model_cls = torch_parallel.MODELS[spec['kind']][0]
    model = model_cls(**spec['config'], device='cpu', trainable=True)
    model.load_state_dict(spec['state_dict'], strict=True)
    model = model.to(torch.float64)
    optimizer = training.make_optimizer(model, spec['lr'], 0.0)
    for name, p in model.named_parameters():
        if name in a['grads']:
            p.grad = torch.from_numpy(np.array(grads[name], np.float64))
    optimizer.step()
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(a['params'][name], b['params'][name])
        ref = p.detach().numpy()
        assert np.abs(a['params'][name] - ref).max() <= 1e-10 * max(
            np.abs(ref).max(), 1e-300), name


@pytest.mark.parametrize('case', [0, 1], ids=['fusionnet', 'radarnet'])
def test_per_shard_statistics_are_not_the_global_ones(dp_steps, case):
    """The batches discriminate: sync-BN (the whole batch's statistics)
    and DDP's buffer broadcast (rank 0's half's) each give running
    statistics more than 1e-6 (relative) away from the averaged ones the
    ranks hold, so the rtol 1e-10 check above fails under either."""
    cases, _, ranks = dp_steps
    spec = cases[case]
    held = ranks[0][case]['buffers']
    draws = spec['draws']
    both = {k: torch.cat([v, v]) for k, v in draws.items()}
    for batch, d in ((spec['batch'], both),
                     (parallel.shard_batch(spec['batch'], 2)[0], draws)):
        model = _port_step(spec, batch, d)
        gap = max(float(np.abs(b.numpy() - held[n]).max() /
                        max(np.abs(held[n]).max(), 1e-300))
                  for n, b in model.named_buffers()
                  if b.is_floating_point())
        assert gap > 1e-6
