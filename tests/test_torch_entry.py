"""comic_tpu_torch.entry against comic_tpu's __graft_entry__ (the XE
forward on the flagship), and data.captions.coco_image_id against
comic_tpu's."""

import jax
import numpy as np
import pytest
import torch

from comic_tpu.data import captions as jcap_io
from comic_tpu_torch.data import captions as cap_io
from comic_tpu_torch.entry import entry, flagship

torch.set_num_threads(1)

# float32 forward: the same operations, summed in other orders
TOL_F32 = dict(rtol=1e-5, atol=1e-5)


def test_tiny_entry_matches_graft_entry_forward():
    """entry(tiny=True) on _flagship(tiny=True)'s params: loss and logits
    within 1e-5 of comic_tpu's xe_forward on the same batch."""
    from __graft_entry__ import _flagship
    from comic_tpu.models.captioner import xe_forward

    _, jspec, jparams = _flagship(tiny=True)
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    fn, (params, images, captions) = entry("cpu", tiny=True, params=jp)
    assert images.shape == (8, 3, 64, 64) and captions.shape == (8, 22)
    assert captions.dtype == torch.int32
    caps = captions.numpy()
    assert (caps[:, 0] == jspec.decoder.start_id).all()
    assert (caps[:, -1] == jspec.decoder.end_id).all()
    assert not caps[:, 1:-1].any()
    loss, logits = fn(params, images, captions)
    want_loss, aux = xe_forward(jp, jspec, np.zeros((8, 64, 64, 3),
                                                    np.float32), caps,
                                training=False)
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL_F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(aux["logits"]),
                               **TOL_F32)


def test_entry_widths_and_seeded_weights():
    """COMIC-256's widths (radix 256, 8 heads, tied projection, LSTM 512,
    word size 256, 224x224); seeded weights repeat, another seed differs."""
    config, spec = flagship()
    assert (config.radix_base, config.attn_num_heads, config.rnn_size,
            config.rnn_word_size, config.cnn_fm_projection) == (
                256, 8, 512, 256, "tied")
    assert spec.decoder.start_id == 256 and spec.decoder.end_id == 257
    _, (a, images, captions) = entry("cpu", tiny=True, seed=3)
    _, (b, _, _) = entry("cpu", tiny=True, seed=3)
    _, (c, _, _) = entry("cpu", tiny=True, seed=4)
    w = ("decoder", "output_projection", "kernel")
    pick = (lambda t: t[w[0]][w[1]][w[2]])
    assert torch.equal(pick(a), pick(b)) and not torch.equal(pick(a), pick(c))


def test_entry_needs_the_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(tiny=True)


@pytest.mark.parametrize("path", ["val/COCO_val2014_000000123456.jpg",
                                  "COCO_train2014_000000000042.png"])
def test_coco_image_id(path):
    assert cap_io.coco_image_id(path) == jcap_io.coco_image_id(path)
    assert cap_io.coco_image_id("val/COCO_val2014_000000123456.jpg") \
        == 123456


def test_dryrun_multichip_on_the_cpu(capsys):
    """__graft_entry__.dryrun_multichip's counterpart as a real 2-process
    gloo job (one XE step, a K=2 call, an SCST rollout and step, the ranks'
    parameters equal afterwards), then serving split over 2 devices equal
    to the unsplit serve."""
    from comic_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu", timeout=120)
    out = capsys.readouterr().out
    assert "ids (4, 60) equal to the unsplit serve; OK" in out


def test_dryrun_multichip_needs_the_card_unless_cpu_is_asked():
    from comic_tpu_torch.entry import dryrun_multichip

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1)
