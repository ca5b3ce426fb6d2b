"""comic_tpu_torch's training CLI against comic_tpu's on the CPU: the flag
surface, the legacy overrides, the experiment naming and the stage chain
(decoder, cnn_finetune; the scst stage in test_torch_scst.py) with the
configs it builds, and the error capture."""

import os

import pytest
import torch

from comic_tpu.cli import train as jcli
from comic_tpu_torch.cli import train as tcli
from comic_tpu_torch.configuration import RUN_SEEDS, Config

torch.set_num_threads(1)


def _args(cli, argv):
    return cli.create_parser().parse_args(argv)


def test_flags_and_defaults_match():
    assert vars(_args(tcli, [])) == vars(_args(jcli, []))
    argv = ["--train_mode", "cnn_finetune", "--token_type", "word",
            "--attn_num_heads", "4", "--cnn_input_augment", "",
            "--lr_start", "0.5", "--run", "2"]
    assert vars(_args(tcli, argv)) == vars(_args(jcli, argv))
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit):
            _args(cli, ["--train_mode", "xe"])


def test_legacy_overrides_match():
    a, b = _args(tcli, ["--legacy"]), _args(jcli, ["--legacy"])
    tcli.apply_legacy_overrides(a)
    jcli.apply_legacy_overrides(b)
    assert vars(a) == vars(b)
    assert a.attn_keep_prob == 1.0 and a.adam_epsilon == 1e-6


@pytest.mark.parametrize("argv", [
    [], ["--legacy"], ["--token_type", "word", "--name", "x"],
    ["--radix_base", "16", "--attn_alignment_method", "dot",
     "--cnn_fm_projection", "independent", "--attn_num_heads", "2"]])
def test_experiment_name_matches(argv):
    want = jcli.experiment_name(_args(jcli, argv))
    assert tcli.experiment_name(_args(tcli, argv)) == want
    if not argv:
        assert want == "radix_b256_add_LN_softmax_h8_tie_lstm"


def _stage(cli, argv):
    args = _args(cli, argv)
    extra = cli.resolve_stage(args)
    fn = extra.pop("stage_fn")
    return vars(args), extra, fn


@pytest.mark.parametrize("mode", ["decoder", "cnn_finetune"])
def test_resolve_stage_matches(tmp_path, mode):
    """The stage's directories, restore source and overrides; the decoder
    directory must exist before cnn_finetune."""
    argv = ["--train_mode", mode, "--log_root", str(tmp_path),
            "--dataset_dir", str(tmp_path / "data"),
            "--cnn_ckpt_path", "/ckpt/cnn.msgpack"]
    name = "radix_b256_add_LN_softmax_h8_tie_lstm"
    dec_dir = str(tmp_path / f"{name}_run_01")
    if mode == "cnn_finetune":
        for cli in (tcli, jcli):
            with pytest.raises(ValueError, match="not found"):
                cli.resolve_stage(_args(cli, argv))
        os.makedirs(dec_dir)
    t_args, t_extra, t_fn = _stage(tcli, argv)
    j_args, j_extra, _ = _stage(jcli, argv)
    assert t_args == j_args and t_extra == j_extra
    from comic_tpu_torch.training.xe import train_fn
    assert t_fn is train_fn
    if mode == "decoder":
        assert t_extra["log_path"] == dec_dir
        assert t_args["checkpoint_path"] == "/ckpt/cnn.msgpack"
        assert t_args["freeze_scopes"] == "encoder/cnn"
    else:
        assert t_extra["log_path"] == str(tmp_path / f"{name}_cnnFT_run_01")
        assert (t_args["checkpoint_path"], t_args["freeze_scopes"],
                t_args["lr_start"], t_args["max_epoch"]) == (dec_dir, "",
                                                             1e-3, 10)
    assert t_extra["resume_training"] is False  # the stage's dir is new


def test_stages_that_are_refused(tmp_path):
    argv = ["--log_root", str(tmp_path), "--dataset_dir", str(tmp_path)]
    for cli in (tcli, jcli):
        with pytest.raises(ValueError, match="CNN frozen"):
            cli.resolve_stage(_args(cli, argv + ["--freeze_scopes", ""]))
        with pytest.raises(NotImplementedError):
            cli.resolve_stage(_args(cli, argv + ["--legacy", "--train_mode",
                                                 "cnn_finetune"]))
        # scst restores the cnn_finetune run, which must exist
        with pytest.raises(ValueError, match="CNN finetune log path"):
            cli.resolve_stage(_args(cli, argv + ["--train_mode", "scst"]))
    with pytest.raises(ValueError, match="seed"):
        tcli.stage_config(argv + ["--run", "9"])


def test_stage_config_builds_the_run(tmp_path):
    """The config main trains: CLI flags plus the fixed reference settings
    and the run's seed; a stage directory with a config.pkl resumes from
    the saved record."""
    argv = ["--log_root", str(tmp_path), "--dataset_dir", str(tmp_path),
            "--run", "3", "--rnn_size", "64"]
    fn, config = tcli.stage_config(argv)
    assert isinstance(config, Config)
    assert (config.rand_seed, config.rnn_size, config.dropout_rnn_in,
            config.num_logs_per_epoch, config.resume_training) == (
        RUN_SEEDS[3], 64, 0.35, 100, False)
    assert tuple(config.cnn_input_size) == (224, 224)
    config.update(max_epoch=7, lr_end=3e-5)
    config.save(config.log_path)
    _, resumed = tcli.stage_config(argv + ["--max_epoch", "9"])
    assert (resumed.resume_training, resumed.max_epoch,
            resumed.checkpoint_path, resumed.lr_end) == (
        True, 9, config.log_path, 1e-5)


def test_main_needs_the_card_and_records_the_error(tmp_path):
    """main trains on the card: without one the run fails (no CPU
    fallback) and try_to_train writes the traceback beside the run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    argv = ["--log_root", str(tmp_path), "--dataset_dir", str(tmp_path),
            "--name", "nocard"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(argv)
    errs = [f for f in os.listdir(tmp_path) if f.startswith("error__")]
    assert errs == ["error__radix_b256_add_LN_softmax_h8_tie_nocard_run_01"
                    ".txt"]
    with open(tmp_path / errs[0]) as f:
        assert "RuntimeError" in f.read()
