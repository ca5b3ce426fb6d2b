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

# float32 arithmetic on the same stored keys in both versions. The context
# is held against the context product of the kernel's own alignments:
# with bf16 keys both versions round the alignments to bf16 first, and two
# alignments that agree to 1e-9 can still round to neighbouring bf16
# values, which moves the context by up to one bf16 step of an alignment.
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


# (rows, beams, L, U, H), split over a cluster of up to 8 blocks per row:
# small and odd sizes; L below 8 (the cluster shrinks to L) and L not a
# multiple of the cluster; one head of 64 vectors (whole-warp head sums);
# head width 30 (vector width 1, head sums through shared memory, keys
# copied without TMA); U=1024 (two passes over U); batch 1; beam 7; the
# main path's (25, 3, 196, 512, 8), whose f32 keys are the largest staged
# chunk the decode loop gives the kernels; the eval-perplexity pass's 61
# rows (K2 at batch_size_eval); the SCST rollout's batch of 10 (K1 at beam
# 7, K2 at R=10 for the greedy baseline); the overfit gate's batch of 5
# (K1 at beam 3 in its sweeps and SCST rollouts, K2 at R=5 in its eval
# passes and greedy baselines); the encoder zoo's other attention sizes
# at the serving batch (L=49: the ResNets' block3 at 224; L=144:
# Inception-V3, V4 and Inception-ResNet-V2 at 224); and U=4096, whose chunk
# fits shared memory at no cluster size, so the keys are read in place
UNSTAGED = (1, 3, 196, 4096, 8)
ZOO_SHAPES = [(25, 3, 49, 512, 8), (25, 3, 144, 512, 8)]
SHAPES = [(2, 3, 7, 16, 4), (3, 7, 33, 96, 3), (4, 3, 5, 64, 2),
          (2, 3, 50, 512, 1), (3, 7, 33, 90, 3), (2, 3, 20, 1024, 8),
          (1, 3, 196, 512, 8), (25, 7, 196, 512, 8), (25, 3, 197, 512, 8),
          (25, 3, 196, 512, 8), (61, 3, 196, 512, 8), (10, 7, 196, 512, 8),
          (5, 3, 196, 512, 8), *ZOO_SHAPES, UNSTAGED]


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,beams,L,U,H", SHAPES)
def test_k1_matches_plain(card, keys_dtype, rows, beams, L, U, H):
    query, keys, mean, m2, vecs = _inputs(card, rows, beams, L, U,
                                          keys_dtype)
    before = k1.grouped_add_ln_attention.launches
    ctx, align = k1.grouped_add_ln_attention(query, keys, mean, m2, *vecs,
                                             num_heads=H)
    assert k1.grouped_add_ln_attention.launches == before + 1
    _, want_align = k1.grouped_add_ln_attention_plain(
        query, keys, mean, m2, *vecs, num_heads=H)
    torch.testing.assert_close(align, want_align, **TOL)
    torch.testing.assert_close(
        ctx, k1.grouped_context_plain(align, keys, num_heads=H), **TOL)


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,beams,L,U,H", SHAPES)
def test_k2_matches_plain(card, keys_dtype, rows, beams, L, U, H):
    query, keys, _, _, vecs = _inputs(card, rows, None, L, U, keys_dtype)
    before = k2.fused_add_ln_attention.launches
    ctx, align = k2.fused_add_ln_attention(query, keys, *vecs, num_heads=H)
    assert k2.fused_add_ln_attention.launches == before + 1
    _, want_align = k2.fused_add_ln_attention_plain(
        query, keys, *vecs, num_heads=H)
    torch.testing.assert_close(align, want_align, **TOL)
    torch.testing.assert_close(
        ctx, k2.fused_context_plain(align, keys, num_heads=H), **TOL)


@pytest.mark.parametrize("keys_dtype", [torch.float32, torch.bfloat16])
def test_large_chunks_read_keys_in_place(card, keys_dtype):
    """The UNSTAGED case of SHAPES takes the path that reads the keys from
    device memory, in both kernels."""
    rows, beams, L, U, H = UNSTAGED
    _, keys, _, _, _ = _inputs(card, rows, beams, L, U, keys_dtype)
    assert not k1.grouped_add_ln_attention_plan(
        keys, beams, num_heads=H)["keys_staged"]
    assert not k2.fused_add_ln_attention_plan(keys,
                                              num_heads=H)["keys_staged"]


@pytest.mark.parametrize("rows,beams,L,U,H", [(25, 3, 196, 512, 8),
                                              (61, 3, 196, 512, 8),
                                              (5, 3, 196, 512, 8),
                                              (3, 7, 33, 90, 3),
                                              *ZOO_SHAPES])
def test_kernels_are_deterministic(card, rows, beams, L, U, H):
    """The cluster reductions run in a fixed order: the same inputs give
    bitwise the same outputs (also at the COCO-server batch of 61, where
    the plan picks its cluster size for 183 queries, at the overfit gate's
    batch of 5, and at the zoo's attention sizes)."""
    query, keys, mean, m2, vecs = _inputs(card, rows, beams, L, U,
                                          torch.bfloat16)
    runs = [k1.grouped_add_ln_attention(query, keys, mean, m2, *vecs,
                                        num_heads=H) for _ in range(2)]
    runs += [k2.fused_add_ln_attention(query[:, 0].contiguous(), keys,
                                       *vecs, num_heads=H)
             for _ in range(2)]
    for a, b in (runs[0:2], runs[2:4]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


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


def test_attention_steps_under_autograd_take_torch_ops(card):
    """The kernels are forward-only: where an input needs a gradient the
    decode steps take the torch ops (their outputs carry a grad_fn) and
    launch nothing; under no_grad they launch the kernels again."""
    cfg = tatt.AttentionConfig(num_units=16, num_heads=4, memory_channels=12)
    g = torch.Generator().manual_seed(1)
    p = tree_to(tatt.attention_init(g, cfg), card)
    fm = torch.randn(2, 7, 12, generator=g).to(card)
    q = torch.randn(2, 3, 16, generator=g).to(card)
    for v in (p["v"], p["query_layer"]["kernel"]):
        v.requires_grad_(True)
    memory = tatt.precompute(p, cfg, fm, dtype=torch.bfloat16)
    n1 = k1.grouped_add_ln_attention.launches
    n2 = k2.fused_add_ln_attention.launches
    ctx1, _ = tatt.attend_grouped(p, cfg, q, memory, dtype=torch.bfloat16)
    ctx2, _ = tatt.attend(p, cfg, q[:, 0], memory, dtype=torch.bfloat16)
    assert ctx1.grad_fn is not None and ctx2.grad_fn is not None
    assert k1.grouped_add_ln_attention.launches == n1
    assert k2.fused_add_ln_attention.launches == n2
    with torch.no_grad():
        tatt.attend_grouped(p, cfg, q, memory, dtype=torch.bfloat16)
        tatt.attend(p, cfg, q[:, 0], memory, dtype=torch.bfloat16)
    assert k1.grouped_add_ln_attention.launches == n1 + 1
    assert k2.fused_add_ln_attention.launches == n2 + 1


def test_xe_gradients_on_card_match_cpu(card):
    """The repair of the kernels' autograd fault: at attn_keep_prob=1.0
    (no alignment dropout, so the attention is inside the kernels' domain)
    the gradients of xe_forward on the card equal the CPU's, float32 with
    TF32 off, and the forward launches no kernel. Each leaf within 1e-4 of
    its largest gradient (the same operations summed in other orders);
    the three stem convolutions within 1e-2, since their kernel gradients
    are sums over every image position that cancel to a thousandth of
    their terms, which scales float32 rounding up by as much."""
    import numpy as np

    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training import optimizer as topt

    stem = ("Conv2d_1a_7x7", "Conv2d_2b_1x1", "Conv2d_2c_3x3")
    wtoi = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
            "<EOS>": 5}
    config = Config(token_type="radix", radix_base=16, rnn_size=32,
                    rnn_word_size=16, attn_num_heads=2,
                    compute_dtype="float32", cnn_input_size=(64, 64),
                    attn_keep_prob=1.0, dropout_rnn_in=0.0,
                    dropout_rnn_out=0.0)
    spec = tcap.build_model_spec(config, Vocabulary(dict(wtoi)))
    rng = np.random.default_rng(4)
    images = torch.from_numpy(
        rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    caps = np.full((2, 7), -1, np.int32)
    caps[:, 0], caps[0, 1:6], caps[1, 1:4] = 16, [1, 5, 9, 2, 17], [3, 0, 17]
    caps = torch.from_numpy(caps)
    params = tcap.init_params(spec, generator=torch.Generator().manual_seed(2),
                              device="cpu")
    mask = topt.trainable_mask(params, "")
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        grads = {}
        for dev in ("cpu", "cuda"):
            p = tree_to(params, torch.device(dev))
            if dev == "cpu":
                p = topt._map_paths(lambda _, v: v.clone(), p)
            topt.set_trainable(p, mask)
            n1 = k1.grouped_add_ln_attention.launches
            n2 = k2.fused_add_ln_attention.launches
            loss, _ = tcap.xe_forward(p, spec, images.to(dev), caps.to(dev),
                                      training=True)
            assert k1.grouped_add_ln_attention.launches == n1
            assert k2.fused_add_ln_attention.launches == n2
            loss.backward()
            grads[dev] = (loss.item(), {
                path: v.grad.cpu() for path, v in topt.tree_items(p)
                if v.grad is not None})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow
    assert abs(grads["cuda"][0] - grads["cpu"][0]) <= 1e-5 * grads["cpu"][0]
    got, want = grads["cuda"][1], grads["cpu"][1]
    assert set(got) == set(want)
    assert len(want) > 100  # the CNN's kernels and betas, the decoder
    assert ("decoder", "attention", "softmax_temperature") in want
    for path, w in want.items():
        tol = 1e-2 if path[2:3] and path[2] in stem else 1e-4
        torch.testing.assert_close(got[path], w, rtol=0,
                                   atol=tol * w.abs().max().item(),
                                   msg="/".join(path))


def test_scst_step_on_card(card):
    """One SCST step at small widths (radix 16, LSTM 32, 2 heads, 64x64,
    beam 7, float32, TF32 off): the rollout runs under no_grad, launches
    K1 (beam search) and K2 (greedy baseline) and gives the CPU's ids; its
    encoder outputs are not inference tensors, so the train step can save
    them for its backward, and the train step launches nothing. The
    references of each image are two of its beam hypotheses on the CPU,
    so the rewards spread both ways; the train step's loss
    and updated parameters equal the CPU's within 1e-4 relative."""
    import numpy as np

    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.evaluation import CaptionScorer
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.tokenization import Vocabulary, ids_to_captions
    from comic_tpu_torch.training import optimizer as topt
    from comic_tpu_torch.training import scst
    from comic_tpu_torch.training.xe import TrainState

    wtoi = {"<PAD>": -1, "<UNK>": 0, "<GO>": 1, "<EOS>": 2}
    wtoi.update({f"w{i}": i + 3 for i in range(29)})
    vocab = Vocabulary(dict(wtoi))
    config = Config(token_type="radix", radix_base=16, rnn_size=32,
                    rnn_word_size=16, attn_num_heads=2,
                    compute_dtype="float32", cnn_input_size=(64, 64),
                    attn_keep_prob=1.0, dropout_rnn_in=0.0,
                    dropout_rnn_out=0.0, cnn_input_augment=False,
                    batch_size_train=2, scst_beam_size=7,
                    freeze_scopes="encoder/cnn")
    spec = tcap.build_model_spec(config, vocab)
    params = tcap.init_params(spec, generator=torch.Generator().manual_seed(3),
                              device="cpu")
    # spread the logits and favour the leading digits 0 and 1, so that the
    # digit pairs decode to the 29 words, and EOS
    proj = params["decoder"]["output_projection"]
    proj["kernel"] *= 3
    proj["bias"][:2] = 2.0
    proj["bias"][spec.decoder.end_id] = 0.5
    images = np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3),
                                               dtype=np.uint8)
    scorer = CaptionScorer(None, {"ciderD": 1.0, "bleu": [0, 0, 0, 2]})
    width = scst.hypo_width(config, vocab)
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs, out = None, {}
    try:
        for dev in ("cpu", "cuda"):  # the CPU's beams make the references
            p = tree_to(topt._map_paths(lambda _, v: v.clone(), params),
                        torch.device(dev))
            opt = topt.Optimizer(p, lambda n: 1e-3,
                                 freeze_scopes="encoder/cnn")
            topt.set_trainable(p, opt.mask)
            n1 = k1.grouped_add_ln_attention.launches
            n2 = k2.fused_add_ln_attention.launches
            greedy, beams, im_embed, fmaps = scst.make_rollout(
                spec, config, vocab, dev)(p, images)
            rolled = (k1.grouped_add_ln_attention.launches - n1,
                      k2.fused_add_ln_attention.launches - n2)
            for t in (im_embed, fmaps):
                assert not t.is_inference() and not t.requires_grad
            if refs is None:
                caps = ids_to_captions(beams.reshape(14, -1).numpy(),
                                       "radix", vocab, 16)
                refs = [[caps[2 + i], caps[8 + i], "w1 w2 w3"]
                        for i in range(2)]
            hypo, rewards, _ = scst.host_score_shard(
                greedy, beams, refs, scorer, config, vocab, width)
            n1 = k1.grouped_add_ln_attention.launches
            n2 = k2.fused_add_ln_attention.launches
            state, metrics = scst.make_scst_train_step(spec, config, dev)(
                TrainState(p, opt, 0), im_embed, fmaps, hypo, rewards)
            stepped = (k1.grouped_add_ln_attention.launches - n1,
                       k2.fused_add_ln_attention.launches - n2)
            out[dev] = (greedy.cpu(), beams.cpu(), rewards, rolled, stepped,
                        metrics["total_loss"].item(),
                        {path: v.detach().cpu()
                         for path, v in topt.tree_items(state.params)})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = allow
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu[3][0] > 0 and gpu[3][1] > 0 and gpu[4] == (0, 0)
    assert torch.equal(gpu[0], cpu[0]) and torch.equal(gpu[1], cpu[1])
    np.testing.assert_array_equal(gpu[2], cpu[2])
    assert np.abs(cpu[2]).max() > 0
    assert abs(gpu[5] - cpu[5]) <= 1e-4 * abs(cpu[5])
    for path, w in cpu[6].items():
        torch.testing.assert_close(gpu[6][path], w, rtol=0,
                                   atol=1e-4 * w.abs().max().item(),
                                   msg="/".join(path))


class _SeededImages:
    """An inference loader of seeded uint8 images, one per file name's
    number (the card's machine decodes no image files)."""

    def __init__(self, *args, **kwargs):
        pass

    def load(self, paths):
        import re

        import numpy as np

        return np.stack([np.random.default_rng(
            int(re.search(r"(\d+)\.jpg$", p).group(1))).integers(
                0, 256, (256, 256, 3), dtype=np.uint8) for p in paths])

    def close(self):
        pass


def test_sweep_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """sweep_checkpoints on one checkpoint at small widths (radix 16, LSTM
    32, 2 heads, 64x64, beam 3, float32, TF32 off) on the card and on the
    CPU: the caption JSON and metric_scores.txt are byte-identical, and
    the card's sweep launched K1."""
    import json
    import os

    import numpy as np

    from comic_tpu_torch import inference as tinf
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data import pipeline
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import save_compact

    wtoi = {"<PAD>": -1, "<UNK>": 0, "<GO>": 1, "<EOS>": 2}
    wtoi.update({f"w{i}": i + 3 for i in range(29)})
    itow = {str(i): w for w, i in wtoi.items()}
    data = tmp_path / "data"
    (data / "captions").mkdir(parents=True)
    names = [f"images/COCO_test_{i:012d}.jpg" for i in range(1, 5)]
    (data / "captions" / "filenames_test.txt").write_text("\n".join(names))
    rng = np.random.default_rng(6)
    anns = [{"image_id": i, "caption": " ".join(
        f"w{w}" for w in rng.integers(0, 29, 6))}
        for i in range(1, 5) for _ in range(3)]
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"annotations": anns}))
    kw = dict(token_type="radix", radix_base=16, rnn_size=32,
              rnn_word_size=16, attn_num_heads=2, compute_dtype="float32",
              cnn_input_size=(64, 64), batch_size_infer=2, infer_beam_size=3,
              infer_max_length=10, dataset_dir=str(data), wtoi=wtoi,
              itow=itow)
    spec = tcap.build_model_spec(Config(**kw), Vocabulary(dict(wtoi)))
    params = tcap.init_params(spec, generator=torch.Generator().manual_seed(7),
                              device="cpu")
    proj = params["decoder"]["output_projection"]
    proj["kernel"] *= 3
    proj["bias"][:2] = 2.0
    monkeypatch.setattr(pipeline, "_ImageLoaderPool", _SeededImages)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    out = {}
    for dev in ("cpu", "cuda"):
        log = str(tmp_path / dev)
        save_compact(log, 1, params)
        config = Config(log_path=log, **kw)
        n1 = k1.grouped_add_ln_attention.launches
        scores = tinf.sweep_checkpoints(config, str(ann), device=dev)
        launched = k1.grouped_add_ln_attention.launches - n1
        save_dir = os.path.join(log, tinf.infer_dir_name(config))
        out[dev] = (scores, launched, [
            open(os.path.join(save_dir, f), "rb").read() for f in
            ("captions___model_compact-1.json", "metric_scores.txt")])
    assert out["cuda"][1] > 0 and out["cpu"][1] == 0
    assert out["cuda"][2] == out["cpu"][2]
    assert out["cuda"][0] == out["cpu"][0]
    assert len(json.loads(out["cuda"][2][0])) == 4


def test_slim_converted_cnn_restores_on_card(card, tmp_path):
    """The overfit gate's stage-1 restore: a CNN under slim names, converted
    by convert_slim_tree and saved by save_cnn_checkpoint, restores in mode
    'cnn' on the card exactly as on the CPU."""
    from comic_tpu_torch import params as bridge
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.models.encoders import get_encoder
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training import checkpoints as tckpt
    from comic_tpu_torch.utils import tf_checkpoint as tfc

    cnn = bridge.to_jax_tree(get_encoder("inception_v1").init(
        torch.Generator().manual_seed(7)))
    slim = {f"InceptionV1/{k}": v
            for k, v in tfc._flatten_leaves(cnn).items()}
    template = bridge.to_jax_tree(get_encoder("inception_v1").init(
        torch.Generator().manual_seed(0)))
    tree = tfc.convert_slim_tree(
        tfc.slim_reader_to_tree(slim, "InceptionV1"), template)
    path = str(tmp_path / "inception_v1.ckpt.msgpack")
    tckpt.save_cnn_checkpoint(path, bridge.from_jax_tree(tree, "cpu"))
    spec = tcap.build_model_spec(
        Config(rnn_size=32, rnn_word_size=16, attn_num_heads=2),
        Vocabulary({"<PAD>": -1, "a": 0, "<UNK>": 1, "<GO>": 2, "<EOS>": 3}))
    out = {}
    for dev in (card, torch.device("cpu")):
        params = tcap.init_params(spec, device=dev)
        restored, step, mode = tckpt.restore_model(params, path)
        assert (mode, step) == ("cnn", 0)
        leaf = restored["encoder"]["cnn"]["Conv2d_1a_7x7"]["weights"]
        assert leaf.device.type == dev.type
        out[dev.type] = bridge.to_jax_tree(restored)
    for path_, a in tfc._flatten_leaves(out["cuda"]).items():
        b = tfc._flatten_leaves(out["cpu"])[path_]
        assert a.dtype == b.dtype and (a == b).all(), path_
    for k, v in tfc._flatten_leaves(out["cuda"]["encoder"]["cnn"]).items():
        assert (v == tfc._flatten_leaves(cnn)[k]).all(), k


@pytest.mark.parametrize("cnn_name", ["resnet_v1_50", "inception_v3"])
def test_zoo_encoder_on_card_matches_cpu(card, cnn_name):
    """One zoo encoder per preprocessing kind (VGG: mean subtraction; the
    inception style), seeded weights with BN statistics moved, 2 seeded
    uint8 images through preprocess_for and encode_images at 224 in
    float32 with TF32 off: the card's embedding and attention memory
    within 1e-4 of the CPU's scale."""
    from comic_tpu_torch.data.preprocessing import preprocess_for
    from comic_tpu_torch.models.encoders import encode_images, get_encoder

    g = torch.Generator().manual_seed(7)
    params = {"cnn": get_encoder(cnn_name).init(g)}

    def walk(d):
        for key, v in d.items():
            if key == "BatchNorm":
                n = v["beta"].shape[0]
                v["beta"] += 0.1 * torch.randn(n, generator=g)
                v["moving_mean"] += 0.1 * torch.randn(n, generator=g)
            elif isinstance(v, dict):
                walk(v)

    walk(params)
    images = torch.randint(0, 256, (2, 256, 256, 3), generator=g,
                           dtype=torch.uint8)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in (card, torch.device("cpu")):
            x = preprocess_for(cnn_name)(images, 224, 224, dev)
            with torch.no_grad():
                out[dev.type] = [t.cpu() for t in encode_images(
                    tree_to(params, dev), x, cnn_name)]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    L = {"resnet_v1_50": 49, "inception_v3": 144}[cnn_name]
    assert out["cuda"][1].shape == (2, L, get_encoder(cnn_name).fm_channels[
        get_encoder(cnn_name).default_fm_endpoint])
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(got).all()
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


COST_FIELDS = ("matmul_flops", "conv_flops", "vpu_elems", "bytes_lower",
               "bytes_upper", "by_primitive")


def _cost_fields(cost):
    return {f: getattr(cost, f) for f in COST_FIELDS}


@pytest.mark.parametrize("grouped", [True, False])
def test_kernel_call_counts_equal_cpu(card, grouped):
    """One K1 / K2 call counted on the card (the kernel launches, no
    dispatch mode sees it) equals the same call counted on the CPU (the
    plain version runs), field by field."""
    from comic_tpu_torch.utils.roofline import count_costs

    query, keys, mean, m2, vecs = _inputs(
        card, 25, 3 if grouped else None, 196, 512, torch.bfloat16)
    if grouped:
        fn, args = k1.grouped_add_ln_attention, (query, keys, mean, m2,
                                                 *vecs)
    else:
        fn, args = k2.fused_add_ln_attention, (query, keys, *vecs)
    before = fn.launches
    on_card = count_costs(fn, *args, num_heads=8)
    assert fn.launches == before + 1
    on_cpu = count_costs(fn, *[t.cpu() for t in args], num_heads=8)
    assert _cost_fields(on_card) == _cost_fields(on_cpu)
    assert on_card.matmul_flops > 0


@pytest.mark.parametrize("beam", [3, 1])
def test_tiny_serve_count_on_card_equals_cpu(card, beam):
    """The tiny flagship's serve (fixed 6 steps, uint8 images in) counted on
    the card, where K1 or K2 takes every step, equals its count on the
    CPU, field by field."""
    from comic_tpu_torch.entry import flagship
    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import init_params
    from comic_tpu_torch.utils.roofline import count_costs

    config, spec = flagship(tiny=True)
    config.update(infer_beam_size=beam, infer_early_exit=False)
    params = init_params(spec, torch.Generator().manual_seed(0),
                         device="cpu")
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1)
                           ).numpy()
    kernel = (k1.grouped_add_ln_attention if beam > 1
              else k2.fused_add_ln_attention)
    costs = {}
    for dev in (card, torch.device("cpu")):
        serve = make_serve_fn(spec, config, 6, collect_alignments=False,
                              device=dev)
        before = kernel.launches
        costs[dev.type] = count_costs(serve, tree_to(params, dev), images)
        launched = kernel.launches - before
        assert launched == (6 if dev.type == "cuda" else 0)
    assert _cost_fields(costs["cuda"]) == _cost_fields(costs["cpu"])
    assert costs["cuda"].by_primitive[kernel.__name__] > 0


def test_step_tracer_on_card_records_cuda_kernels(card, tmp_path):
    import glob
    import json

    from comic_tpu_torch.utils.profiling import StepTracer

    tracer = StepTracer(str(tmp_path), start=1, count=2)  # the card
    a = torch.randn(256, 256, device=card)
    for i in range(5):
        a = torch.tanh(a @ a)
        tracer.step(i)
    tracer.close()
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ProfilerStep#")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(steps) == 2 and kernels


def test_world_one_nccl_step_equals_the_plain_step(card):
    """Data parallelism on the card: a world-1 NCCL job's XE step (global
    trim and token count through all_gather, the gradients and losses
    through one all_reduce) equals the plain one-process step, float32
    with TF32 off, every updated leaf within 1e-6 of its largest
    magnitude and the loss within 1e-6 relative."""
    import numpy as np
    import torch.distributed as dist

    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.entry import free_port
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.parallel import mesh as pm
    from comic_tpu_torch.parallel.distributed import \
        maybe_initialize_distributed
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training import optimizer as topt
    from comic_tpu_torch.training.xe import TrainState, make_train_step

    wtoi = {"<PAD>": -1, "a": 0, "dog": 1, "on": 2, "<UNK>": 3, "<GO>": 4,
            "<EOS>": 5}
    config = Config(token_type="radix", radix_base=16, rnn_size=32,
                    rnn_word_size=16, attn_num_heads=2,
                    compute_dtype="float32", cnn_input_size=(64, 64),
                    freeze_scopes="", cnn_input_augment=False)
    spec = tcap.build_model_spec(config, Vocabulary(dict(wtoi)))
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    caps = np.full((2, 8), -1, np.int32)
    caps[:, 0], caps[0, 1:6], caps[1, 1:4] = 16, [1, 5, 9, 2, 17], [3, 0, 17]
    params = tcap.init_params(spec, generator=torch.Generator().manual_seed(2),
                              device="cpu")
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        for job in (False, True):
            if job:
                assert maybe_initialize_distributed(
                    f"127.0.0.1:{free_port()}", 1, 0)
                assert dist.get_backend() == "nccl"
            p = tree_to(params, card)
            opt = topt.Optimizer(p, lambda n: 1e-3, freeze_scopes="")
            topt.set_trainable(p, opt.mask)
            calls = pm.all_reduce_grads.calls
            step = make_train_step(spec, config, (64, 64), card)
            state, metrics = step(TrainState(p, opt, 0), images, caps,
                                  torch.Generator(card).manual_seed(3))
            assert pm.all_reduce_grads.calls == calls + job
            out.append((float(metrics["total_loss"]),
                        {k: v.detach().cpu()
                         for k, v in topt.tree_items(state.params)}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow[0]
        torch.backends.cudnn.allow_tf32 = allow[1]
        if dist.is_initialized():
            dist.destroy_process_group()
    (loss, plain), (job_loss, joined) = out
    assert abs(job_loss - loss) <= 1e-6 * abs(loss)
    for k, v in plain.items():
        scale = v.abs().max().clamp(min=1e-30)
        assert ((joined[k] - v).abs().max() / scale).item() <= 1e-6, k
