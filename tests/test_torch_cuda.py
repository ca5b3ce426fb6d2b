"""comic_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card. These need an NVIDIA card with nvcc and skip elsewhere; run them
on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda.py`` (the suite's conftest imports JAX, which the
card's machine need not have).
chip_smoke.py holds the kernels at the main path's shapes."""

import pytest
import torch

from comic_tpu_torch.models import attention as tatt
from comic_tpu_torch.models.captioner import tree_to
from comic_tpu_torch.ops import fused_attention as k2
from comic_tpu_torch.ops import grouped_attention as k1

pytestmark = pytest.mark.cuda

# float32 arithmetic on the same stored keys in both versions
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(card, rows, beams, L, U, keys_dtype):
    g = torch.Generator().manual_seed(rows * 1000 + L + U)
    keys = torch.randn(rows, L, U, generator=g).to(card, keys_dtype)
    shape = (rows, U) if beams is None else (rows, beams, U)
    query = torch.randn(*shape, generator=g).to(card)
    vecs = [torch.randn(U, generator=g).to(card) * 0.2,
            1 + 0.3 * torch.randn(U, generator=g).to(card),
            0.3 * torch.randn(U, generator=g).to(card),
            torch.tensor(3.0, device=card)]
    k32 = keys.float()
    return query, keys, k32.mean(-1), k32.square().mean(-1), vecs


# (rows, beams, L, U, H): odd sizes (vector width 1 and 4/8, L below a
# warp, H above one head per lane group) and the main path's
SHAPES = [(2, 3, 7, 16, 4), (3, 7, 33, 96, 3), (25, 3, 196, 512, 8)]


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,beams,L,U,H", SHAPES)
def test_k1_matches_plain(card, keys_dtype, rows, beams, L, U, H):
    query, keys, mean, m2, vecs = _inputs(card, rows, beams, L, U,
                                          keys_dtype)
    before = k1.grouped_add_ln_attention.launches
    ctx, align = k1.grouped_add_ln_attention(query, keys, mean, m2, *vecs,
                                             num_heads=H)
    assert k1.grouped_add_ln_attention.launches == before + 1
    want_ctx, want_align = k1.grouped_add_ln_attention_plain(
        query, keys, mean, m2, *vecs, num_heads=H)
    torch.testing.assert_close(align, want_align, **TOL)
    torch.testing.assert_close(ctx, want_ctx, **TOL)


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,beams,L,U,H", SHAPES)
def test_k2_matches_plain(card, keys_dtype, rows, beams, L, U, H):
    query, keys, _, _, vecs = _inputs(card, rows, None, L, U, keys_dtype)
    before = k2.fused_add_ln_attention.launches
    ctx, align = k2.fused_add_ln_attention(query, keys, *vecs, num_heads=H)
    assert k2.fused_add_ln_attention.launches == before + 1
    want_ctx, want_align = k2.fused_add_ln_attention_plain(
        query, keys, *vecs, num_heads=H)
    torch.testing.assert_close(align, want_align, **TOL)
    torch.testing.assert_close(ctx, want_ctx, **TOL)


def test_wrappers_refuse_bad_inputs(card):
    query, keys, mean, m2, vecs = _inputs(card, 2, 3, 7, 16, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        k1.grouped_add_ln_attention(query.double(), keys, mean, m2, *vecs,
                                    num_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_add_ln_attention(query[:, 0], keys.transpose(1, 2)
                                  .contiguous().transpose(1, 2), *vecs,
                                  num_heads=4)
    with pytest.raises(ValueError, match="divisible"):
        k2.fused_add_ln_attention(query[:, 0], keys, *vecs, num_heads=5)


def test_attention_steps_dispatch_to_kernels(card):
    """In the kernels' domain the decode steps launch them; outside it (dot
    alignment) they do not."""
    cfg = tatt.AttentionConfig(num_units=16, num_heads=4, memory_channels=12)
    g = torch.Generator().manual_seed(0)
    p = tree_to(tatt.attention_init(g, cfg), card)
    fm = torch.randn(2, 7, 12, generator=g).to(card)
    memory = tatt.precompute(p, cfg, fm, dtype=torch.bfloat16)
    q = torch.randn(2, 3, 16, generator=g).to(card)
    n1 = k1.grouped_add_ln_attention.launches
    n2 = k2.fused_add_ln_attention.launches
    tatt.attend_grouped(p, cfg, q, memory, dtype=torch.bfloat16)
    tatt.attend(p, cfg, q[:, 0], memory, dtype=torch.bfloat16)
    assert k1.grouped_add_ln_attention.launches == n1 + 1
    assert k2.fused_add_ln_attention.launches == n2 + 1
    dot = cfg._replace(alignment="dot")
    tatt.attend_grouped(p, dot, q, tatt.precompute(p, dot, fm))
    assert k1.grouped_add_ln_attention.launches == n1 + 1
