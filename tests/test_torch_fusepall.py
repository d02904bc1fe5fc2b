"""The variants of the fused skip gather-add (rcfd_tpu_torch/ops/
fused_skip_variants.py) and the tool that times them
(rcfd_tpu_torch/tools/fusepall_exp.py) on the CPU, where every wrapper runs
its plain version. ``full`` is held against the JAX package's Pallas kernel
in interpret mode; tools/fusepall_exp.py cannot be imported (it parses argv
and runs its kernel on a TPU at import), so the other variants are held
against numpy statements of their definitions."""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from rcfd_tpu.ops import fused_skip as jax_fs  # noqa: E402

from rcfd_tpu_torch.ops import fused_skip_variants as fv  # noqa: E402
from rcfd_tpu_torch.tools import fusepall_exp  # noqa: E402

from torch_parity import nchw, nhwc  # noqa: E402

DTYPES = {'float32': (torch.float32, np.float32),
          'bfloat16': (torch.bfloat16, ml_dtypes.bfloat16)}


def _inputs(rng, dtype, n=1, k=3, ph=10, pw=8, c=4, wg=40):
    """NHWC numpy inputs (a and cg rounded to ``dtype``, float32
    corrections, starts at both edges and at starts that are not multiples
    of 4 or 8) and the port's NCHW tensors of the same values."""
    np_dtype = DTYPES[dtype][1]
    a = rng.standard_normal((n * k, ph, pw, c)).astype(np_dtype)
    cg = rng.standard_normal((n, ph, wg, c)).astype(np_dtype)
    starts = rng.integers(0, wg - pw + 1, (n, k)).astype(np.int32)
    starts[0, :3] = [0, wg - pw, 13]
    corr_l = rng.standard_normal((n, k, ph, c)).astype(np.float32)
    corr_r = rng.standard_normal((n, k, ph, c)).astype(np.float32)

    def port(x):  # NHWC numpy -> NCHW torch, the same values
        t = nchw(x.astype(np.float32))
        return t.to(DTYPES[dtype][0])

    def corr(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(x, (0, 1, 3, 2)).reshape(n * k, c, ph)))

    args = (port(a), port(cg), torch.from_numpy(starts), corr(corr_l),
            corr(corr_r))
    return (a, cg, starts, corr_l, corr_r), args


def _to_numpy(t, dtype):
    """An NCHW port output as NHWC numpy of ``dtype``."""
    return nhwc(t.float()).astype(DTYPES[dtype][1])


def _statement(variant, a, cg, starts, corr_l, corr_r):
    """The definition of a variant in numpy, NHWC: windows at s_k (full,
    align16) or at s^_k = s_k - s_k % A (noselect, dmaonly), with A the
    elements of a 16-byte vector; sums in float32 rounded once to the
    element type; the edge columns corrected in float32, then rounded."""
    dtype = a.dtype
    if variant == 'nodma':
        return (a.astype(np.float32) * 2).astype(dtype)
    n, ph, wg, c = cg.shape
    k, pw = starts.shape[1], a.shape[2]
    elems = 16 // dtype.itemsize
    s = np.clip(starts, 0, wg - pw)
    if variant in ('noselect', 'dmaonly'):
        s = s - s % elems
    win = np.stack([cg[i // k, :, s[i // k, i % k]:s[i // k, i % k] + pw]
                    for i in range(n * k)])
    if variant == 'dmaonly':
        return win
    y = (a.astype(np.float32) + win.astype(np.float32)).astype(dtype)
    cl, cr = corr_l.reshape(n * k, ph, c), corr_r.reshape(n * k, ph, c)
    y[:, :, 0] = (y[:, :, 0].astype(np.float32) - cl).astype(dtype)
    y[:, :, pw - 1] = (y[:, :, pw - 1].astype(np.float32) - cr).astype(
        dtype)
    return y


@pytest.mark.parametrize('dtype', sorted(DTYPES))
def test_full_plain_matches_the_pallas_kernel(dtype, rng):
    """K3's function, in float32 and in bf16 (the TPU tool's dtype): the
    port's ``full`` on the CPU against _fused_pallas(interpret=True) on the
    same values, bit for bit."""
    np_args, args = _inputs(rng, dtype)
    a, cg, starts, corr_l, corr_r = np_args
    lazy = jax_fs.LazyColumnWindows(jnp.asarray(cg), jnp.asarray(starts),
                                    a.shape[2])
    ref = jax_fs._fused_pallas(jnp.asarray(a), jnp.asarray(cg), lazy,
                               jnp.asarray(corr_l), jnp.asarray(corr_r),
                               interpret=True)
    assert ref.dtype == a.dtype
    before = fv.full.launches
    out = fv.full(*args)
    assert fv.full.launches == before  # the CPU runs the plain version
    assert out.dtype == args[0].dtype
    np.testing.assert_array_equal(_to_numpy(out, dtype), np.asarray(ref))


@pytest.mark.parametrize('dtype', sorted(DTYPES))
@pytest.mark.parametrize('variant', fv.VARIANTS)
def test_variant_plain_matches_its_definition(variant, dtype, rng):
    np_args, args = _inputs(rng, dtype)
    wrapper = fv.WRAPPERS[variant]
    before = wrapper.launches
    out = wrapper(*args)
    assert wrapper.launches == before
    np.testing.assert_array_equal(_to_numpy(out, dtype),
                                  _statement(variant, *np_args))


def test_aligned_starts():
    starts = torch.tensor([[-3, 0, 5, 13, 31, 40]], dtype=torch.int32)
    assert fv.aligned_starts(starts, 8, 40, 4).tolist() == \
        [[0, 0, 4, 12, 28, 32]]
    assert fv.aligned_starts(starts, 8, 40, 8).tolist() == \
        [[0, 0, 0, 8, 24, 32]]
    assert fv.vector_elems(torch.float32) == 4
    assert fv.vector_elems(torch.bfloat16) == 8


@pytest.mark.parametrize('variant', fv.VARIANTS)
def test_wrappers_refuse_shapes_and_dtypes(variant, rng):
    _, (a, cg, starts, corr_l, corr_r) = _inputs(rng, 'float32')
    wrapper = fv.WRAPPERS[variant]
    with pytest.raises(ValueError, match='do not fit'):
        wrapper(a, cg[:, :2], starts, corr_l, corr_r)
    with pytest.raises(ValueError, match='do not fit'):
        wrapper(a, cg, starts[:, :2], corr_l, corr_r)
    with pytest.raises(NotImplementedError):
        wrapper(a.double(), cg.double(), starts, corr_l, corr_r)
    with pytest.raises(NotImplementedError):
        wrapper(a, cg.to(torch.bfloat16), starts, corr_l, corr_r)
    with pytest.raises(NotImplementedError):
        wrapper(a, cg, starts, corr_l.to(torch.bfloat16), corr_r)
    with pytest.raises(NotImplementedError):
        wrapper(a, cg, starts.long(), corr_l, corr_r)


def test_variant_bytes_at_the_tool_defaults():
    """The bytes each variant must move at deconv1's shapes (the tool's
    defaults): K3's in float32 is the 1,131,725,056 its kernel phase
    counts; in bf16 the corrections stay float32."""
    def args(dtype):
        t = lambda *shape, d=dtype: torch.empty(shape, dtype=d,
                                               device='meta')
        return (t(64, 32, 450, 144), t(1, 32, 450, 1088),
                t(1, 64, d=torch.int32), t(64, 32, 450, d=torch.float32),
                t(64, 32, 450, d=torch.float32))
    expect = {torch.float32: (1131725056, 593510656, 1061683200),
              torch.bfloat16: (569549056, 296755456, 530841600)}
    for dtype, (k3, dmaonly, nodma) in expect.items():
        got = {v: fusepall_exp.variant_bytes(v, *args(dtype))
               for v in fv.VARIANTS}
        assert got == dict(full=k3, align16=k3, noselect=k3,
                           dmaonly=dmaonly, nodma=nodma)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tool_main_runs_on_the_cpu(dtype, monkeypatch, capsys):
    """The tool end to end at a tiny shape with its timer stubbed (the CPU
    has no CUDA events): inputs, every variant against its plain version,
    the yardsticks and the printed lines."""
    timed = []

    def stub(fn, n=fusepall_exp.N_TIMED, warmup=2):
        fn()
        timed.append(n)
        return 1.0

    monkeypatch.setattr(fusepall_exp, 'device_ms', stub)
    results = fusepall_exp.main(['--device', 'cpu', '--k', '3', '--ph', '5',
                                 '--pw', '16', '--c', '4', '--wf', '40',
                                 '--dtype', dtype])
    assert [r['variant'] for r in results] == list(fv.VARIANTS)
    assert all(r['equal'] for r in results)
    assert all(r['err_vs_k3'] == 0.0 for r in results[:2])
    assert [r['library'] for r in results] == \
        [None, None, None, 'torch.gather', 'torch.mul(a, 2)']
    assert all(r['library_equal'] for r in results[3:])
    assert timed == [20, 5] * 3 + [20, 5, 20] * 2
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and out[1].startswith('full      ' + dtype)


def test_tool_parses_no_argv_at_import():
    import inspect
    source = inspect.getsource(fusepall_exp)
    assert source.index('parse_args') > source.index('def main(')
