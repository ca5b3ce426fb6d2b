"""The slice as a whole: serving with zoo encoders. From one compact
checkpoint, comic_tpu's and comic_tpu_torch's run_inference write
byte-identical caption JSON on the synthetic dataset (float32, CPU, the
tiny decoder of tests/test_torch_inference.py) for a ResNet (VGG
preprocessing: the aspect-preserving host resize, mean subtraction) and a
MobileNet (inception preprocessing, depthwise convs), at beam 3 and
greedy."""

import json

import jax
import numpy as np
import pytest
import torch

from comic_tpu.configuration import Config as JConfig
from comic_tpu.data.synthetic import make_synthetic_dataset
from comic_tpu.inference import run_inference as jrun_inference
from comic_tpu.training.checkpoints import save_checkpoint
from comic_tpu_torch import inference as tinf
from comic_tpu_torch import params as bridge
from comic_tpu_torch.configuration import Config
from comic_tpu_torch.models import captioner as tcap
from comic_tpu_torch.tokenization import Vocabulary
from test_torch_encoder import zoo_tree

torch.set_num_threads(1)

CONFIG = dict(
    token_type="radix", radix_base=16, dataset_file_pattern="synth_{}",
    rnn_size=32, rnn_word_size=16, attn_num_heads=2,
    compute_dtype="float32", cnn_input_size=(64, 64), batch_size_infer=2,
    infer_max_length=10, infer_set="test")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo_serving")
    root, vocab = make_synthetic_dataset(
        str(tmp / "d"), num_train=8, num_valid=4, num_test=4,
        captions_per_image=1, image_size=300)
    words = dict(wtoi=vocab.wtoi,
                 itow={str(k): w for k, w in vocab.itow.items()})
    return root, words, tmp


@pytest.fixture(scope="module", params=["resnet_v1_50", "mobilenet_v1"])
def experiment(request, data):
    """One compact checkpoint: the zoo tree of the encoder and the port's
    seeded decoder with the output projection spread so that no two
    candidates are near-tied and the captions hold words."""
    root, words, tmp = data
    cnn_name = request.param
    spec = tcap.build_model_spec(Config(cnn_name=cnn_name, **words, **CONFIG),
                                 Vocabulary.from_str_itow(words["wtoi"],
                                                          words["itow"]))
    tree = bridge.to_jax_tree(tcap.init_params(spec, device="cpu"))
    tree["encoder"]["cnn"] = jax.tree_util.tree_map(np.asarray,
                                                    zoo_tree(cnn_name))
    tree["decoder"]["output_projection"]["kernel"] *= 4
    bias = np.zeros(CONFIG["radix_base"] + 2, np.float32)
    bias[[0, 1]] = 2.5
    bias[-1] = -1.5
    tree["decoder"]["output_projection"]["bias"] = bias
    _, ckpt = save_checkpoint(str(tmp / f"ckpt_{cnn_name}"), 1, tree)
    return cnn_name, ckpt


@pytest.mark.parametrize("beam", [3, 1])
def test_caption_json_is_byte_identical(data, experiment, beam):
    root, words, tmp = data
    cnn_name, ckpt = experiment
    outputs = []
    for name, config_cls, run in (
            ("jax", JConfig, jrun_inference),
            ("torch", Config, lambda c, p: tinf.run_inference(
                c, p, device="cpu"))):
        config = config_cls(dataset_dir=root, cnn_name=cnn_name,
                            log_path=str(tmp / f"{name}_{cnn_name}_{beam}"),
                            infer_beam_size=beam, **words, **CONFIG)
        _, path = run(config, ckpt)
        with open(path, "rb") as f:
            outputs.append(f.read())
    assert outputs[0] == outputs[1]
    caps = json.loads(outputs[1])
    assert len(caps) == 4 and any(c["caption"] for c in caps)
