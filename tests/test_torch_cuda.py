"""The CUDA kernels of rcfd_tpu_torch on the card, against their plain
versions. These tests need a CUDA device and skip without one. They import
no JAX, so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from rcfd_tpu_torch.ops import scatter_cuda as sc  # noqa: E402

from torch_parity import SCATTER_CASES, scatter_case  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device, rng):
    for name in SCATTER_CASES:
        crops, x, z, valid, h, w, patch = scatter_case(name, rng)
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (crops, x, z, valid)]
        before = sc.scatter_quasi_dense.launches
        d, r = sc.scatter_quasi_dense(*args, h, w, patch)
        d_p, r_p = sc.scatter_quasi_dense_plain(*args, h, w, patch)
        torch.cuda.synchronize()
        assert sc.scatter_quasi_dense.launches == before + 1
        assert torch.equal(d, d_p) and torch.equal(r, r_p), name


@pytest.mark.cuda
def test_kernel_wrapper_refuses_bad_cuda_tensors(cuda_device, rng):
    crops, x, z, valid, h, w, patch = scatter_case('random', rng)
    c, xs, zs, v = [torch.from_numpy(a).to(cuda_device)
                    for a in (crops, x, z, valid)]
    with pytest.raises(ValueError, match='contiguous'):
        sc.scatter_quasi_dense(c.transpose(1, 2).contiguous().transpose(
            1, 2), xs, zs, v, h, w, patch)
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c.to(torch.bfloat16), xs, zs, v, h, w, patch)
    with pytest.raises(NotImplementedError):
        sc.scatter_quasi_dense(c, xs.double(), zs, v, h, w, patch)
    with pytest.raises(ValueError):
        sc.scatter_quasi_dense(c, xs.cpu(), zs, v, h, w, patch)
