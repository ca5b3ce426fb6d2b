"""comic_tpu_torch and chip_smoke import neither JAX nor comic_tpu, and the
port's entry points refuse to run without CUDA unless asked for the CPU."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HYGIENE = r"""
import importlib, pkgutil, sys
import comic_tpu_torch
names = [m.name for m in pkgutil.walk_packages(comic_tpu_torch.__path__,
                                                "comic_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "comic_tpu"))
lazy = sorted(m for m in sys.modules
              if m.split(".")[0] in ("tensorflow", "tensorstore", "h5py",
                                     "PIL", "cv2"))
print(",".join(names), bad, lazy)
"""

# the training slices' modules (XE and SCST, with the reward scorers),
# each of which the walk above must import
TRAINING_MODULES = {
    "comic_tpu_torch.cli.train", "comic_tpu_torch.training.xe",
    "comic_tpu_torch.training.optimizer", "comic_tpu_torch.training.schedule",
    "comic_tpu_torch.training.checkpoints", "comic_tpu_torch.utils.summaries",
    "comic_tpu_torch.data.pipeline", "comic_tpu_torch.data.captions",
    "comic_tpu_torch.data.preprocessing", "comic_tpu_torch.tokenization.vocab",
    "comic_tpu_torch.models.captioner", "comic_tpu_torch.models.decoder",
    "comic_tpu_torch.training.scst", "comic_tpu_torch.tokenization.text",
    "comic_tpu_torch.evaluation.scorers", "comic_tpu_torch.evaluation.bleu",
    "comic_tpu_torch.evaluation.cider",
    "comic_tpu_torch.evaluation.cider_native",
    "comic_tpu_torch.evaluation.ngrams", "comic_tpu_torch.evaluation.ids"}

# the checkpoint-evaluation slice's modules
EVALUATION_MODULES = {
    "comic_tpu_torch.cli.infer", "comic_tpu_torch.inference",
    "comic_tpu_torch.evaluation.coco_eval", "comic_tpu_torch.evaluation.rouge",
    "comic_tpu_torch.evaluation.tokenizer",
    "comic_tpu_torch.evaluation.java_metrics"}

# the stand-alone slice's modules: checkpoint formats (TF-slim, reference
# TF1, Orbax), dataset preparation and the synthetic fixture
STANDALONE_MODULES = {
    "comic_tpu_torch.utils.natural_sort", "comic_tpu_torch.utils.io",
    "comic_tpu_torch.utils.net_params", "comic_tpu_torch.utils.optional",
    "comic_tpu_torch.utils.tf_checkpoint",
    "comic_tpu_torch.training.orbax_store", "comic_tpu_torch.data.synthetic",
    "comic_tpu_torch.prepro", "comic_tpu_torch.prepro.base",
    "comic_tpu_torch.prepro.coco", "comic_tpu_torch.prepro.insta",
    "comic_tpu_torch.prepro.ngrams"}

# the encoder zoo's modules
ZOO_MODULES = {f"comic_tpu_torch.models.{m}" for m in (
    "inception_v2", "inception_v3", "inception_v4", "inception_resnet_v2",
    "resnet", "resnet_v2", "vgg", "mobilenet_v1", "mobilenet_v2", "nasnet")}

# the data-parallel slice's modules
PARALLEL_MODULES = {"comic_tpu_torch.parallel",
                    "comic_tpu_torch.parallel.mesh",
                    "comic_tpu_torch.parallel.distributed"}

# the port's tools: the parity gate and the kernels' phase timer
TOOLS_MODULES = {"comic_tpu_torch.tools.parity_gate",
                 "comic_tpu_torch.tools.kernel_phases"}

# the bench and its tools
BENCH_MODULES = {"comic_tpu_torch.bench",
                 "comic_tpu_torch.tools.serve_check",
                 "comic_tpu_torch.tools.batch_sweep",
                 "comic_tpu_torch.tools.beam_sweep",
                 "comic_tpu_torch.tools.loader_bench"}

# libraries that only the functions needing them import
OPTIONAL_LIBRARIES = ("tensorflow", "tensorstore", "h5py", "PIL", "cv2")


def _clean_env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_no_jax_and_no_comic_tpu():
    out = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad, lazy = out.stdout.split(" ", 2)
    names = set(names.split(","))
    assert len(names) >= 72
    assert TRAINING_MODULES <= names, TRAINING_MODULES - names
    assert EVALUATION_MODULES <= names, EVALUATION_MODULES - names
    assert STANDALONE_MODULES <= names, STANDALONE_MODULES - names
    assert ZOO_MODULES <= names, ZOO_MODULES - names
    assert PARALLEL_MODULES <= names, PARALLEL_MODULES - names
    assert TOOLS_MODULES <= names, TOOLS_MODULES - names
    assert BENCH_MODULES <= names, BENCH_MODULES - names
    assert bad.strip() == "[]"
    # importing every module pulls in none of the optional libraries
    assert lazy.strip() == "[]"


def _help_without_jax(cli, package="cli"):
    """``python -m comic_tpu_torch.<package>.<cli> --help`` (``package``
    empty: ``comic_tpu_torch.<cli>``) with JAX and
    comic_tpu made unimportable, and the optional libraries too (the card's
    machine may lack any of h5py, TensorFlow, tensorstore, PIL or cv2; each
    is imported only by the functions that need it)."""
    blocked = ["jax", "flax", "optax", "comic_tpu", *OPTIONAL_LIBRARIES]
    module = ".".join(["comic_tpu_torch"] + [package] * bool(package)
                      + [cli])
    block = (f"import sys; sys.modules.update(dict.fromkeys({blocked!r})); "
             f"import runpy; sys.argv = ['{cli}', '--help']; "
             f"runpy.run_module('{module}', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", block], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_training_cli_runs_without_jax():
    out = _help_without_jax("train")
    assert "--train_mode" in out and "--cnn_ckpt_path" in out


def test_infer_cli_runs_without_jax():
    out = _help_without_jax("infer")
    assert "--infer_checkpoints_dir" in out and "--require_ptb_jar" in out


def test_parity_gate_runs_without_jax():
    out = _help_without_jax("parity_gate", package="tools")
    assert "--target_cider" in out and "--allow_ptb_fallback" in out
    assert "--device" in out


@pytest.mark.parametrize("package,cli,flags", [
    ("", "bench", ("--device",)),
    ("tools", "serve_check", ("--device", "batch")),
    ("tools", "batch_sweep", ("--device", "batches")),
    ("tools", "beam_sweep", ("--device", "beams")),
    ("tools", "loader_bench", ("--images", "--min_s", "target"))])
def test_bench_and_tools_run_without_jax(package, cli, flags):
    out = _help_without_jax(cli, package)
    assert all(f in out for f in flags)


@pytest.mark.parametrize("cli,flags", [
    ("coco", ("--karpathy_json", "--include_restval")),
    ("insta", ("--train_json", "--vocab_size")),
    ("ngrams", ("--dataset_file_pattern",))])
def test_prepro_clis_run_without_jax_or_optional_libraries(cli, flags):
    out = _help_without_jax(cli, "prepro")
    assert "--dataset_dir" in out and all(f in out for f in flags)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def _small_spec():
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.models.captioner import build_model_spec
    from comic_tpu_torch.tokenization import Vocabulary

    config = Config(token_type="radix", radix_base=16, rnn_size=32,
                    rnn_word_size=16, attn_num_heads=2,
                    compute_dtype="float32")
    vocab = Vocabulary({"<PAD>": -1, "a": 0, "<UNK>": 1, "<GO>": 2,
                        "<EOS>": 3})
    return config, build_model_spec(config, vocab)


def test_entry_points_need_cuda_unless_cpu_is_asked(no_card, tmp_path):
    from comic_tpu_torch import bench, params, resolve_device
    from comic_tpu_torch.inference import make_serve_fn, run_inference
    from comic_tpu_torch.models.captioner import init_params
    from comic_tpu_torch.tools import batch_sweep, beam_sweep, serve_check
    from comic_tpu_torch.training.checkpoints import save_compact

    config, spec = _small_spec()
    tree = init_params(spec, device="cpu")  # the CPU when asked for
    ckpt = save_compact(str(tmp_path), 1, tree)
    config.update(wtoi={"<PAD>": -1, "a": 0, "<UNK>": 1, "<GO>": 2,
                        "<EOS>": 3}, itow={})
    for call in (lambda: resolve_device(None),
                 lambda: init_params(spec),
                 lambda: params.from_jax_tree(params.to_jax_tree(tree)),
                 lambda: make_serve_fn(spec, config, 4),
                 lambda: run_inference(config, ckpt),
                 lambda: bench.main([]), lambda: serve_check.main([]),
                 lambda: batch_sweep.main([]), lambda: beam_sweep.main([]),
                 lambda: bench.flagship_model()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_card_or_repo(no_card, tmp_path):
    """No CUDA: non-zero exit and no result line; the same for a directory
    that holds chip_smoke.py alone."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# the profiling slice's modules: the step tracer, the cost model, entry()
PROFILING_MODULES = ("comic_tpu_torch.utils.profiling",
                     "comic_tpu_torch.utils.roofline",
                     "comic_tpu_torch.entry")

_PROFILING = r"""
import sys
sys.modules.update(dict.fromkeys(%r))
import pkgutil, comic_tpu_torch
names = {m.name for m in pkgutil.walk_packages(comic_tpu_torch.__path__,
                                               "comic_tpu_torch.")}
missing = set(%r) - names
assert not missing, missing
from comic_tpu_torch.data.captions import coco_image_id
from comic_tpu_torch.entry import entry
from comic_tpu_torch.utils.profiling import StepTracer
from comic_tpu_torch.utils.roofline import count_costs, utilization_fields
tracer = StepTracer(None)
tracer.step(0)
tracer.close()
fn, args = entry("cpu", tiny=True)
cost = count_costs(fn, *args)
assert cost.conv_flops > 0 and cost.matmul_flops > 0
assert utilization_fields(cost, 1.0)["gflops"] > 0
print(coco_image_id("COCO_val2014_000000000007.jpg"))
"""


def test_profiling_modules_run_without_jax():
    """The new modules, with JAX, comic_tpu and the optional libraries
    made unimportable: imported, and each driven once on the CPU."""
    blocked = ["jax", "jaxlib", "flax", "optax", "comic_tpu",
               *OPTIONAL_LIBRARIES]
    out = subprocess.run(
        [sys.executable, "-c", _PROFILING % (blocked, PROFILING_MODULES)],
        cwd=ROOT, env=_clean_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7"


_PARALLEL = r"""
import sys
sys.modules.update(dict.fromkeys(%r))
import comic_tpu_torch.parallel as parallel
from comic_tpu_torch.parallel import mesh
assert parallel.maybe_initialize_distributed() is False
print(",".join(sorted(parallel.__all__)), mesh.make_mesh_for_batch(
    8, devices=["cpu"] * 4).size)
"""


def test_parallel_modules_run_without_jax(monkeypatch):
    """comic_tpu_torch.parallel with JAX, comic_tpu and the optional
    libraries made unimportable: it imports, exports what
    comic_tpu.parallel exports, and sizes a mesh."""
    import comic_tpu.parallel as jparallel

    blocked = ["jax", "jaxlib", "flax", "optax", "comic_tpu",
               *OPTIONAL_LIBRARIES]
    env = _clean_env()
    env.pop("COMIC_COORDINATOR", None)
    out = subprocess.run([sys.executable, "-c", _PARALLEL % (blocked,)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    exports, size = out.stdout.split()
    assert exports.split(",") == sorted(jparallel.__all__)
    assert size == "4"
