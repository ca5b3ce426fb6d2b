"""The slice as a whole: from one compact checkpoint, comic_tpu's and
comic_tpu_torch's run_inference write byte-identical caption JSON on the
synthetic dataset (float32, CPU), for beam 3 and greedy, with early exit on
and off."""

import os

import jax
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.inference import run_inference as jrun_inference
from comic_tpu.models import captioner as jcap
from comic_tpu.training.checkpoints import save_checkpoint
from comic_tpu_torch import inference as tinf
from comic_tpu_torch.configuration import Config

torch.set_num_threads(1)

# the tiny float32 config of tests/test_inference.py
CONFIG = dict(
    token_type="radix", radix_base=16, dataset_file_pattern="synth_{}",
    rnn_size=32, rnn_word_size=16, attn_num_heads=2,
    compute_dtype="float32", cnn_input_size=(64, 64), batch_size_infer=2,
    infer_max_length=10, infer_set="test")


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """Synthetic dataset (4 test images) and one compact checkpoint of
    comic_tpu's init tree with BN statistics moved off their defaults and
    the output projection spread, so that no two candidates are near-tied."""
    tmp = tmp_path_factory.mktemp("slice")
    root, vocab = make_synthetic_dataset(
        str(tmp / "d"), num_train=8, num_valid=4, num_test=4,
        captions_per_image=1)
    words = dict(wtoi=vocab.wtoi,
                 itow={str(k): w for k, w in vocab.itow.items()})
    spec = jcap.build_model_spec(JConfig(**CONFIG), vocab)
    tree = jax.tree_util.tree_map(
        np.array, jcap.init_params(jax.random.PRNGKey(0), spec))
    rng = np.random.default_rng(0)

    def walk(d):
        for k, v in d.items():
            if k == "BatchNorm":
                n = v["beta"].shape[0]
                v["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
                v["moving_mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            elif isinstance(v, dict):
                walk(v)

    walk(tree)
    tree["decoder"]["output_projection"]["kernel"] *= 4
    # favour the digits 0 and 1, the leading digit of every word id of this
    # 29-word vocabulary, so that the captions hold words
    bias = np.zeros(CONFIG["radix_base"] + 2, np.float32)
    bias[[0, 1]] = 2.5
    bias[-1] = -1.5
    tree["decoder"]["output_projection"]["bias"] = bias
    _, ckpt = save_checkpoint(str(tmp / "ckpt"), 1, tree)
    return root, words, ckpt, tmp


@pytest.mark.parametrize("beam", [3, 1])
@pytest.mark.parametrize("early_exit", [True, False])
def test_caption_json_is_byte_identical(experiment, beam, early_exit):
    root, words, ckpt, tmp = experiment
    outputs = []
    for name, config_cls, run in (
            ("jax", JConfig, jrun_inference),
            ("torch", Config, lambda c, p: tinf.run_inference(
                c, p, device="cpu"))):
        log = str(tmp / f"{name}_{beam}_{early_exit}")
        config = config_cls(dataset_dir=root, log_path=log,
                            infer_beam_size=beam,
                            infer_early_exit=early_exit, **words, **CONFIG)
        save_dir, json_path = run(config, ckpt)
        assert os.path.basename(save_dir) == \
            f"infer_test_beam_{beam}_lpen_0.0"
        assert os.path.basename(json_path) == "captions___model_compact-1.json"
        with open(os.path.join(save_dir, "infer_speed.txt")) as f:
            assert f.read().startswith("model_compact-1: ")
        with open(json_path, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    assert outputs[0].count(b'"caption"') == 4
    assert b'"caption": ""' not in outputs[0]


@pytest.mark.parametrize("beam", [3, 1])
@pytest.mark.parametrize("early_exit", [True, False])
def test_serve_ids_are_identical(experiment, beam, early_exit):
    """The caption text drops invalid radix digits; the raw ids of both
    serve fns on the same uint8 batch must agree too."""
    from comic_tpu.inference import make_serve_fn as jmake_serve_fn
    from comic_tpu.tokenization import Vocabulary as JVocabulary
    from comic_tpu.training.checkpoints import load_compact as jload
    from comic_tpu_torch.data.pipeline import InferencePipeline
    from comic_tpu_torch.models import captioner as tcap
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import load_compact

    root, words, ckpt, tmp = experiment
    kw = dict(dataset_dir=root, infer_beam_size=beam,
              infer_early_exit=early_exit, **words, **CONFIG)
    pipe = InferencePipeline(Config(**kw))
    try:
        images, _ = next(iter(pipe))
    finally:
        pipe.close()
    jconfig, tconfig = JConfig(**kw), Config(**kw)
    jspec = jcap.build_model_spec(
        jconfig, JVocabulary.from_str_itow(words["wtoi"], words["itow"]))
    jparams = jload(ckpt, jcap.init_params(jax.random.PRNGKey(0), jspec))
    jserve = jmake_serve_fn(jspec, jconfig, 20, collect_alignments=False)
    want = np.asarray(jserve(jparams, images)[0])
    tspec = tcap.build_model_spec(
        tconfig, Vocabulary.from_str_itow(words["wtoi"], words["itow"]))
    tparams = load_compact(ckpt, tcap.init_params(tspec, device="cpu"))
    got = tinf.make_serve_fn(tspec, tconfig, 20, collect_alignments=False,
                             device="cpu")(tparams, images)[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_attention_pickle_layout(experiment):
    """save_attention writes comic_tpu's outputs___{ckpt}.pkl layout."""
    import pickle

    root, words, ckpt, tmp = experiment
    config = Config(dataset_dir=root, log_path=str(tmp / "pkl"),
                    infer_beam_size=3, infer_attention_max_images=3,
                    **words, **CONFIG)
    save_dir, _ = tinf.run_inference(config, ckpt, save_attention=True,
                                     device="cpu")
    with open(os.path.join(save_dir, "outputs___model_compact-1.pkl"),
              "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"captions", "attention", "image_ids"}
    assert len(raw["captions"]) == 4 and len(raw["attention"]) == 3
    maps = next(iter(raw["attention"].values()))
    assert maps.shape == (2, 20, 16)  # (heads, T, L): 4x4 Mixed_4f at 64


def test_image_id_and_dir_name_match_comic_tpu():
    from comic_tpu import inference as jinf

    for path in ("a/COCO_val2014_000000123456.jpg", "insta/user_post.jpg",
                 "im/user@post_123.jpg", "d/img_5_of_7.jpg", "plain.png"):
        assert tinf.image_id_from_path(path) == jinf.image_id_from_path(path)
    c = dict(infer_set="valid", infer_beam_size=5,
             infer_length_penalty_weight=0.6)
    assert tinf.infer_dir_name(Config(**c)) == jinf.infer_dir_name(
        JConfig(**c))
    for p in ("x/model_compact-3.msgpack", "x/model_compact-3.orbax/",
              "model_compact-3.index"):
        assert tinf._ckpt_name(p) == jinf._ckpt_name(p)
