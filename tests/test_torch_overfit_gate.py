"""The overfit gate of tests/test_overfit_gate.py, on the port, on the CPU:
caption quality, not just the loss's direction.

COMIC-tiny (float32) memorizes the port's own 10-image synthetic fixture
(solid colours, one caption each, the test split mirroring train) through
comic_tpu_torch's train_fn, 1000 XE steps with the JAX gate's recipe; the
port's sweep (the infer CLI's config, beam 3) must then score CIDEr > 5
and BLEU-4 > 0.5. Twenty SCST steps from that checkpoint must keep a
finite |reward| < 5 and CIDEr > 4. Thresholds and recipe are the JAX
gate's, unchanged. Marked slow, as the JAX gate is: tier-1 does not run
it. ``chip_smoke.py``'s overfit-gate phase runs the same gate at COMIC-256
width on the card.
"""

import os

import numpy as np
import pytest
import torch

from comic_tpu_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(1)

pjoin = os.path.join

XE_STEPS = 1000
SCST_STEPS = 20


@pytest.mark.slow
class TestTorchOverfitGate:
    @pytest.fixture(scope="class")
    def env(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("overfit")
        root, _ = make_synthetic_dataset(
            str(tmp / "data"), num_train=10, num_valid=4, num_test=4,
            captions_per_image=1, test_mirrors_train=True,
            distinct_images=True)
        return root, str(tmp / "exp")

    def _config(self, root, log_path, **over):
        from comic_tpu_torch.configuration import Config

        # tests/test_overfit_gate.py's recipe: COMIC-tiny in float32, Adam
        # epsilon 1e-6, dropout off, the CNN frozen (the Config default)
        kw = dict(
            token_type="word", dataset_dir=root,
            dataset_file_pattern="synth_{}", batch_size_train=5,
            batch_size_eval=4, max_epoch=10_000, rnn_size=64,
            rnn_word_size=32, attn_num_heads=2, compute_dtype="float32",
            cnn_input_size=(64, 64), lr_start=3e-3, lr_end=1e-4,
            adam_epsilon=1e-6, dropout_rnn_in=0.0, dropout_rnn_out=0.0,
            attn_keep_prob=1.0, log_path=log_path, num_logs_per_epoch=1,
            rand_seed=0, num_data_shards=1)
        kw.update(over)
        return Config(**kw)

    def _infer_scores(self, root, exp_dir, ckpt_step):
        """The infer CLI's arguments, swept on the CPU."""
        from comic_tpu_torch.cli.infer import infer_config
        from comic_tpu_torch.inference import sweep_checkpoints

        args, config = infer_config([
            "--infer_checkpoints_dir", exp_dir,
            "--infer_checkpoints", str(ckpt_step),
            "--dataset_dir", root,
            "--annotations_file",
            pjoin(root, "captions", "annotations_test.json"),
            "--infer_set", "test",
            "--batch_size_infer", "5",
            "--infer_beam_size", "3",
            "--infer_max_length", "20",
        ])
        results = sweep_checkpoints(config, args.annotations_file,
                                    checkpoints=args.infer_checkpoints,
                                    device="cpu")
        assert len(results) == 1, results
        return next(iter(results.values()))

    def test_xe_memorizes_to_high_cider(self, env):
        from comic_tpu_torch.training.xe import train_fn

        root, log_root = env
        exp = pjoin(log_root, "xe")
        metrics = train_fn(self._config(root, exp),
                           max_steps_override=XE_STEPS, device="cpu")
        assert np.isfinite(metrics["total_loss"])
        assert metrics["log_ppl"] < 0.6, metrics
        scores = self._infer_scores(root, exp, XE_STEPS)
        print(f"port overfit gate, XE {XE_STEPS} steps: log_ppl "
              f"{metrics['log_ppl']:.4f}, scores {scores}")
        assert scores["CIDEr"] > 5.0, scores
        assert scores["Bleu_4"] > 0.5, scores

    def test_scst_keeps_reward_and_quality(self, env):
        from comic_tpu_torch.training.scst import train_fn_scst

        root, log_root = env
        xe_dir = pjoin(log_root, "xe")
        assert os.path.isdir(xe_dir), "runs after the XE gate (same class)"
        scst_dir = pjoin(log_root, "scst")
        c = self._config(
            root, scst_dir, checkpoint_path=xe_dir,
            lr_start=2e-5, lr_end=2e-5, scst_beam_size=3,
            batch_size_train=5)
        metrics = train_fn_scst(c, max_steps_override=SCST_STEPS,
                                device="cpu")
        assert np.isfinite(metrics["reward"]), metrics
        assert abs(metrics["reward"]) < 5.0, metrics
        assert np.isfinite(metrics["scst_loss"]), metrics
        scores = self._infer_scores(root, scst_dir, SCST_STEPS)
        print(f"port overfit gate, SCST {SCST_STEPS} steps: reward "
              f"{metrics['reward']:.6f}, scores {scores}")
        assert scores["CIDEr"] > 4.0, scores
