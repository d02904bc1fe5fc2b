"""rcfd_tpu_torch/tools/crop_exp.py on the CPU: every variant is the
committed kernel source with its substitutions made, each found exactly
once; the measurement itself needs the card."""

import pytest

pytest.importorskip('torch')

from rcfd_tpu_torch.tools import crop_exp  # noqa: E402

CASES = [(kind, name) for kind, variants in crop_exp.VARIANTS.items()
         for name in variants]


@pytest.mark.parametrize('kind, name', CASES)
def test_variant_sources_change_what_they_name(kind, name):
    source, subs = crop_exp.VARIANTS[kind][name]
    committed = crop_exp.variant_source(source, ())
    text = crop_exp.variant_source(source, subs)
    assert (text == committed) == (not subs)
    for old, new in subs:
        assert old not in text and new in text
    assert crop_exp.variant_file(kind, name).endswith('.cu')


def test_a_missing_text_is_refused():
    with pytest.raises(ValueError, match='not once'):
        crop_exp.variant_source(crop_exp.VARIANTS['forward']['kernel'][0],
                                (('no such text', 'x'),))


def test_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(crop_exp.torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match='card only'):
        crop_exp.main([])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_index_add_backward_is_the_plain_gradient_on_the_cpu(dtype):
    """The parent's route (one index_add_) adds in index order on the CPU,
    so there it equals the k-ordered plain backward bit for bit."""
    import numpy as np
    import torch

    from rcfd_tpu_torch.ops import crop_cuda

    rng = np.random.default_rng(0)
    starts = torch.tensor([[0, 0, 9, 14], [3, 11, 2, 2]], dtype=torch.int32)
    grad = torch.from_numpy(rng.standard_normal(
        (8, 3, 4, 5), dtype=np.float32)).to(getattr(torch, dtype))
    got = crop_exp.index_add_backward(grad, starts, (2, 3, 4, 11), 5)
    assert got.dtype == grad.dtype
    assert torch.equal(got, crop_cuda.batch_column_crop_backward_plain(
        grad, starts, (2, 3, 4, 11), 5))


def test_parent_sources_include_the_copied_header():
    from rcfd_tpu_torch.ops import _build

    files = crop_exp.parent_sources(_build.CSRC_DIR)
    source = files[crop_exp.variant_file('forward', 'parent')]
    assert '#include "{}"'.format(crop_exp.PARENT_HEADER) in source
    assert '#include "row_tiles.cuh"' not in source
    with open('{}/row_tiles.cuh'.format(_build.CSRC_DIR)) as f:
        assert files[crop_exp.PARENT_HEADER] == f.read()
