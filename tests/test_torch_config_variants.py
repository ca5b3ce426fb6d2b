"""The configurations besides COMIC-256's radix/LSTM/add_LN decoder, each
served whole by both packages from one compact checkpoint of comic_tpu's
init tree (float32, CPU, the tiny width of tests/test_torch_inference.py):
word and char tokens, the GRU and LN_LSTM cells, the GRU with a projected
initial state, dot alignment, sigmoid probabilities, the independent and
absent feature-map projections, the context layer and two stacked cells.
Both serve fns give the same ids at beam 3 and greedy (early exit on);
run_inference writes byte-identical caption JSON for word and char tokens,
whose text path is not radix's; the XE loss and the decoder stage's
gradients agree for word tokens, both cells, dot and sigmoid
(test_torch_xe's check)."""

import os

import jax
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.inference import make_serve_fn as jmake_serve_fn
from comic_tpu.inference import run_inference as jrun_inference
from comic_tpu.models import captioner as jcap
from comic_tpu.tokenization import Vocabulary as JVocabulary
from comic_tpu.tokenization import build_char_vocab
from comic_tpu.training.checkpoints import load_compact as jload
from comic_tpu.training.checkpoints import save_checkpoint
from comic_tpu_torch import inference as tinf
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.data.pipeline import InferencePipeline
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from comic_tpu_torch.training.checkpoints import load_compact
from test_torch_xe import _xe_gradients_match

torch.set_num_threads(1)

# the tiny float32 config of tests/test_inference.py
CONFIG = dict(
    token_type="radix", radix_base=16, dataset_file_pattern="synth_{}",
    rnn_size=32, rnn_word_size=16, attn_num_heads=2,
    compute_dtype="float32", cnn_input_size=(64, 64), batch_size_infer=2,
    infer_max_length=10, infer_set="test", infer_early_exit=True)

# each configuration: what it changes from CONFIG
VARIANTS = {
    "word": dict(token_type="word"),
    "char": dict(token_type="char"),
    "gru": dict(rnn_name="GRU"),
    "ln_lstm": dict(rnn_name="LN_LSTM"),
    "gru_project_hidden": dict(rnn_name="GRU",
                               rnn_init_method="project_hidden"),
    "dot": dict(attn_alignment_method="dot"),
    "sigmoid": dict(attn_probability_fn="sigmoid"),
    "independent": dict(cnn_fm_projection="independent"),
    "none": dict(cnn_fm_projection="none"),
    "context_layer": dict(attn_context_layer=True),
    "two_layers": dict(rnn_layers=2),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic dataset (4 test images) and the first infer batch."""
    tmp = tmp_path_factory.mktemp("variants")
    root, vocab = make_synthetic_dataset(
        str(tmp / "d"), num_train=8, num_valid=4, num_test=4,
        captions_per_image=1)
    words = dict(wtoi=vocab.wtoi,
                 itow={str(k): w for k, w in vocab.itow.items()})
    pipe = InferencePipeline(Config(dataset_dir=root, **words, **CONFIG))
    try:
        images, _ = next(iter(pipe))
    finally:
        pipe.close()
    return root, words, images, tmp


def _variant(data, name):
    """-> (config kwargs, JAX vocabulary, compact checkpoint path): one
    compact checkpoint of comic_tpu's init tree for the variant, with BN
    statistics moved off their defaults and the output projection spread
    so that no two candidates are near-tied and the captions hold words."""
    root, words, _, tmp = data
    kw = dict(CONFIG, dataset_dir=root, **VARIANTS[name])
    if kw["token_type"] == "char":
        chars = build_char_vocab()
        kw.update(wtoi=chars.wtoi,
                  itow={str(k): w for k, w in chars.itow.items()})
    else:
        kw.update(words)
    vocab = JVocabulary.from_str_itow(kw["wtoi"], kw["itow"])
    path = str(tmp / f"ckpt_{name}")
    if not os.path.isdir(path):
        spec = jcap.build_model_spec(JConfig(**kw), vocab)
        tree = jax.tree_util.tree_map(
            np.array, jcap.init_params(jax.random.PRNGKey(0), spec))
        rng = np.random.default_rng(0)

        def walk(d):
            for k, v in d.items():
                if k == "BatchNorm":
                    n = v["beta"].shape[0]
                    v["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
                    v["moving_mean"] = rng.normal(0, 0.1, n).astype(
                        np.float32)
                elif isinstance(v, dict):
                    walk(v)

        walk(tree)
        proj = tree["decoder"]["output_projection"]
        proj["kernel"] *= 4
        bias = np.zeros_like(proj["bias"])
        if kw["token_type"] == "radix":
            # the digits 0 and 1 lead every word id of this vocabulary
            bias[[0, 1]] = 2.5
        bias[jcap.start_end_ids(JConfig(**kw), vocab)[1]] = -1.5
        proj["bias"] = bias
        save_checkpoint(path, 1, tree)
    return kw, vocab, os.path.join(path, "model_compact-1.msgpack")


@pytest.mark.parametrize("beam", [3, 1])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_serve_ids_are_identical(data, name, beam):
    """Both packages' serve fns on one uint8 batch: the same ids."""
    images = data[2]
    kw, jvocab, ckpt = _variant(data, name)
    kw["infer_beam_size"] = beam
    jconfig, tconfig = JConfig(**kw), Config(**kw)
    steps = jcap.max_decode_steps(jconfig, jvocab)
    jspec = jcap.build_model_spec(jconfig, jvocab)
    jparams = jload(ckpt, jcap.init_params(jax.random.PRNGKey(0), jspec))
    want = np.asarray(jmake_serve_fn(jspec, jconfig, steps,
                                     collect_alignments=False)(
        jparams, images)[0])
    tvocab = Vocabulary.from_str_itow(kw["wtoi"], kw["itow"])
    assert tcap.max_decode_steps(tconfig, tvocab) == steps
    tspec = tcap.build_model_spec(tconfig, tvocab)
    tparams = load_compact(ckpt, tcap.init_params(tspec, device="cpu"))
    got = tinf.make_serve_fn(tspec, tconfig, steps, collect_alignments=False,
                             device="cpu")(tparams, images)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    # ids of the vocabulary, and not every caption an immediate EOS
    _, end_id = tcap.start_end_ids(tconfig, tvocab)
    assert want.shape[0] == 2 and want.max() < tspec.decoder.softmax_size
    assert (want[:, 0] != end_id).any()


@pytest.mark.parametrize("beam", [3, 1])
@pytest.mark.parametrize("name", ["word", "char"])
def test_caption_json_is_byte_identical(data, name, beam):
    """Both packages' run_inference over the test split: the same bytes,
    every caption holding words (characters for char tokens)."""
    kw, _, ckpt = _variant(data, name)
    outputs = []
    for pkg, config_cls, run in (
            ("jax", JConfig, jrun_inference),
            ("torch", Config, lambda c, p: tinf.run_inference(
                c, p, device="cpu"))):
        config = config_cls(**dict(kw, infer_beam_size=beam, log_path=str(
            data[3] / f"{pkg}_{name}_{beam}")))
        _, json_path = run(config, ckpt)
        with open(json_path, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    assert outputs[0].count(b'"caption"') == 4
    assert b'"caption": ""' not in outputs[0]


@pytest.mark.parametrize("name", ["word", "gru", "ln_lstm", "dot",
                                  "sigmoid"])
def test_xe_gradients_match_jax_grad(name):
    """d log_ppl / d param of every trainable leaf of the decoder stage
    (the CNN frozen, as the CLI's XE stage 1 trains these decoders),
    float32, at test_torch_xe's tolerances. The CNN's backward does not
    change with the decoder's configuration: test_torch_xe holds it at
    these images, where a MaxPool_3a window sits on a float32 near-tie
    (its stem tolerance). With word tokens the cotangent routed through
    that window is larger, and the stem's kernel gradient lands 2.1e-2 of
    its scale from comic_tpu's (_xe_gradients_match("float32",
    token_type="word") with the CNN trainable)."""
    _xe_gradients_match("float32", freeze_scopes="encoder/cnn",
                        **VARIANTS[name])
