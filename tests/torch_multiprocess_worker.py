"""Worker of the port's real multi-process tests (torch.distributed, gloo,
on the CPU), and ``run_job``, which launches it.

    python tests/torch_multiprocess_worker.py <mode> <workdir>

Each process joins the job from COMIC_COORDINATOR, COMIC_NUM_PROCESSES and
COMIC_PROCESS_ID, as the port's CLIs do, runs ``mode`` on the inputs the
test wrote into ``workdir`` and writes ``result_<rank>.npz`` there. It
imports torch and comic_tpu_torch only: no JAX, no comic_tpu.

Modes:
  steps      one XE step with dropout off and one with dropout, augment
             and alignment dropout on (rank blocks of a global batch of
             4), the eval perplexity split and replicated, an SCST rollout
             on the rank's image block, its host scoring and one SCST step,
             and the TrainPipeline's blocks of an epoch;
  host       a job declared as ONE host of two ranks (LOCAL_WORLD_SIZE=2):
             train_fn one XE step at batch_size_train 4 (both ranks work)
             and 3 (rank 1 idles), each from the test's compact
             checkpoint, recording the pipeline's max_step and
             steps_per_epoch, each rank's block and parameters, and its
             printed lines; then an SCST rollout, host scoring and step at
             batch 3 on the same one-host mesh (rank 1 idles);
  train_cli  comic_tpu_torch.cli.train.main on the CPU (argv in workdir);
  infer_cli  comic_tpu_torch.cli.infer.main on the CPU: records the
             refusal of the multi-process sweep.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(mode, workdir, n=2, timeout=120, env=None):
    """Run ``mode`` in an n-process gloo job -> each rank's result (a dict
    of arrays). ``env``: more environment variables of every rank. Kills
    every process when one fails or the job outlives ``timeout`` seconds,
    and raises with the failing rank's output."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env_r = dict(os.environ, COMIC_COORDINATOR=f"127.0.0.1:{port}",
                     COMIC_NUM_PROCESSES=str(n), COMIC_PROCESS_ID=str(rank),
                     PYTHONPATH=_REPO, OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(workdir)],
            env=env_r, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode} job ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{mode} rank {rank} failed:\n{out}")
    return [dict(np.load(os.path.join(workdir, f"result_{r}.npz")))
            for r in range(n)]


def _nested(flat):
    """{'a/b/c': array} -> {'a': {'b': {'c': array}}}."""
    tree = {}
    for key, value in flat.items():
        node = tree
        *scopes, leaf = key.split("/")
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = value
    return tree


def flat_params(tree, prefix=""):
    """The inverse of ``_nested``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


class IndexImages:
    """A loader whose 'image' of a record is its number (for the
    pipeline's blocks)."""

    def load(self, paths):
        return np.asarray([int(os.path.basename(p).split(".")[0])
                           for p in paths], np.int64)

    def close(self):
        pass


def _steps(workdir, rank, world):
    import torch

    from comic_tpu_torch import params as bridge
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data.pipeline import TrainPipeline
    from comic_tpu_torch.evaluation.scorers import CaptionScorer
    from comic_tpu_torch.models.captioner import build_model_spec
    from comic_tpu_torch.parallel import mesh as pm
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training import optimizer as topt
    from comic_tpu_torch.training import scst as tscst
    from comic_tpu_torch.training import xe as txe
    from comic_tpu_torch.training.schedule import cosine_schedule

    with open(os.path.join(workdir, "spec.json")) as f:
        spec_in = json.load(f)
    inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
    params = _nested(dict(np.load(os.path.join(workdir, "params.npz"))))
    vocab = Vocabulary(dict(spec_in["wtoi"]))
    out = {}
    blk = slice(rank * 2, rank * 2 + 2)

    def fresh(config):
        tp = bridge.from_jax_tree(params, "cpu")
        opt = topt.Optimizer(tp, cosine_schedule(1e-3, 1e-4, 10),
                             freeze_scopes=config.freeze_scopes,
                             adam_epsilon=config.adam_epsilon)
        mesh = pm.make_mesh_for_batch(4)
        pm.replicate(mesh, [tp, opt.moments])
        topt.set_trainable(tp, opt.mask)
        return txe.TrainState(tp, opt, 0), mesh

    def record(tag, state, metrics):
        out[f"{tag}/loss"] = np.asarray(
            [float(metrics[k]) for k in ("total_loss", "map_loss")])
        for k, v in flat_params(bridge.to_jax_tree(state.params)).items():
            out[f"{tag}/params/{k}"] = v

    for tag in ("xe_off", "xe_drop"):
        config = Config(**spec_in[tag])
        spec = build_model_spec(config, vocab)
        state, mesh = fresh(config)
        step = txe.make_train_step(spec, config, (64, 64), "cpu")
        gen = torch.Generator().manual_seed(5)
        state, metrics = step(state, inputs["images"][blk],
                              inputs["caps"][blk], gen)
        record(tag, state, metrics)

    # eval perplexity: batch 4 splits over 2 ranks, batch 3 does not
    config = Config(**spec_in["xe_off"])
    spec = build_model_spec(config, vocab)
    state, mesh = fresh(config)
    eval_step = txe.make_eval_step(spec, config, (64, 64), "cpu")
    for batch in (4, 3):
        config.batch_size_eval = batch
        pipe = TrainPipeline(config, vocab, "valid",
                             records=[tuple(r) for r in spec_in["valid"]],
                             loader=_EvalImages(inputs["images"]))
        out[f"eval_ppl_{batch}"] = np.asarray(txe.evaluate_perplexity(
            eval_step, state.params, pipe, mesh))
        pipe.close()

    # SCST: rollout on the rank's block, host scoring, one step
    config = Config(**spec_in["scst"])
    spec = build_model_spec(config, vocab)
    state, mesh = fresh(config)
    rollout = tscst.make_rollout(spec, config, vocab, "cpu")
    greedy, beams, im_embed, fmaps = rollout(
        state.params, pm.feed_global(mesh, inputs["images"]))
    scorer = CaptionScorer(os.path.join(workdir, "idf.p"), {"ciderD": 1.0})
    width = tscst.hypo_width(config, vocab)
    hypo, rewards, _ = tscst.host_score_shard(
        greedy, beams, spec_in["refs"], scorer, config, vocab, width, mesh)
    out["scst/greedy"] = pm.local_batch(greedy)
    out["scst/beams"] = pm.local_batch(beams, axis=1)
    out["scst/hypo"] = pm.local_batch(hypo)
    out["scst/rewards"] = pm.local_batch(rewards)
    step = tscst.make_scst_train_step(spec, config, "cpu")
    state, metrics = step(state, im_embed, fmaps, hypo, rewards)
    record("scst", state, metrics)

    # the TrainPipeline's blocks of one epoch (2 rows a rank)
    config = Config(**spec_in["pipeline"])
    pipe = TrainPipeline(config, vocab, "train",
                         records=[tuple(r) for r in spec_in["records"]],
                         loader=IndexImages())
    it = iter(pipe)
    batches = [next(it) for _ in range(pipe.steps_per_epoch)]
    for i, (images, caps) in enumerate(batches):
        out[f"pipe/images/{i}"], out[f"pipe/caps/{i}"] = images, caps
    out["pipe/counts"] = np.asarray([config.max_step, pipe.steps_per_epoch])
    pipe.close()
    out["all_reduce_calls"] = np.asarray(pm.all_reduce_grads.calls)
    return out


def _host(workdir):
    import contextlib
    import io

    import torch

    from comic_tpu_torch import params as bridge
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data.pipeline import TrainPipeline
    from comic_tpu_torch.evaluation.scorers import CaptionScorer
    from comic_tpu_torch.models.captioner import build_model_spec
    from comic_tpu_torch.parallel import mesh as pm
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training import optimizer as topt
    from comic_tpu_torch.training import scst as tscst
    from comic_tpu_torch.training import xe as txe
    from comic_tpu_torch.training.schedule import cosine_schedule

    with open(os.path.join(workdir, "spec.json")) as f:
        spec_in = json.load(f)
    images = np.load(os.path.join(workdir, "inputs.npz"))["images"]
    vocab = Vocabulary(dict(spec_in["wtoi"]))
    out = {"hosts": np.asarray([pm.ranks_per_host(), pm.host_count()])}

    # the train step train_fn builds, wrapped to keep this rank's block and
    # its state after the step
    seen = {}
    make_step = txe.make_train_step

    def recording_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(state, images_u8, captions, generator=None):
            seen["rows"] = len(captions)
            seen["state"], metrics = step(state, images_u8, captions,
                                          generator)
            return seen["state"], metrics
        return recorded

    txe.make_train_step = recording_make_train_step
    for batch in (4, 3):
        tag = f"xe{batch}"
        config = Config(**dict(spec_in["host"], batch_size_train=batch,
                               log_path=os.path.join(workdir, tag),
                               checkpoint_path=os.path.join(workdir,
                                                            "init")))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            train = TrainPipeline(
                config, vocab, "train",
                records=[tuple(r) for r in spec_in["records"]],
                loader=_EvalImages(images))
            out[f"{tag}/counts"] = np.asarray([config.max_step,
                                               train.steps_per_epoch])
            valid = TrainPipeline(
                config, vocab, "valid",
                records=[tuple(r) for r in spec_in["valid"]],
                loader=_EvalImages(images))
            metrics = txe.train_fn(config, max_steps_override=1,
                                   train_pipe=train, eval_pipe=valid,
                                   device="cpu")
        train.close()
        valid.close()
        out[f"{tag}/log"] = np.asarray(log.getvalue())
        out[f"{tag}/rows"] = np.asarray(seen["rows"])
        out[f"{tag}/loss"] = np.asarray([metrics["total_loss"],
                                         metrics["map_loss"]])
        for k, v in flat_params(bridge.to_jax_tree(
                seen["state"].params)).items():
            out[f"{tag}/params/{k}"] = v
    txe.make_train_step = make_step

    # SCST at batch 3 on the one-host mesh: rank 0 takes every image
    config = Config(**dict(spec_in["host"], batch_size_train=3))
    spec = build_model_spec(config, vocab)
    tp = bridge.from_jax_tree(_nested(dict(np.load(
        os.path.join(workdir, "params.npz")))), "cpu")
    opt = topt.Optimizer(tp, cosine_schedule(1e-3, 1e-4, 10),
                         freeze_scopes=config.freeze_scopes,
                         adam_epsilon=config.adam_epsilon)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        mesh = pm.make_mesh_for_batch(3)
    out["scst3/log"] = np.asarray(log.getvalue())
    pm.replicate(mesh, [tp, opt.moments])
    topt.set_trainable(tp, opt.mask)
    rollout = tscst.make_rollout(spec, config, vocab, "cpu")
    greedy, beams, im_embed, fmaps = rollout(
        tp, pm.feed_global(mesh, images[:3]))
    scorer = CaptionScorer(os.path.join(workdir, "idf.p"), {"ciderD": 1.0})
    hypo, rewards, _ = tscst.host_score_shard(
        greedy, beams, spec_in["refs"][:3], scorer, config, vocab,
        tscst.hypo_width(config, vocab), mesh)
    out["scst3/greedy"] = pm.local_batch(greedy)
    out["scst3/beams"] = pm.local_batch(beams, axis=1)
    out["scst3/hypo"] = pm.local_batch(hypo)
    out["scst3/rewards"] = pm.local_batch(rewards)
    step = tscst.make_scst_train_step(spec, config, "cpu", mesh)
    state, metrics = step(txe.TrainState(tp, opt, 0), im_embed, fmaps, hypo,
                          rewards)
    out["scst3/loss"] = np.asarray([float(metrics["total_loss"]),
                                    float(metrics["map_loss"])])
    for k, v in flat_params(bridge.to_jax_tree(state.params)).items():
        out[f"scst3/params/{k}"] = v
    return out


class _EvalImages:
    """The eval split's images: record i is image i of the test's batch."""

    def __init__(self, images):
        self.images = images

    def load(self, paths):
        return self.images[[int(os.path.basename(p).split(".")[0]) % 4
                            for p in paths]]

    def close(self):
        pass


def _train_cli(workdir):
    from comic_tpu_torch.cli import train

    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    metrics = train.main(argv, device="cpu")
    return {"total_loss": np.asarray(metrics["total_loss"])}


def _infer_cli(workdir):
    from comic_tpu_torch.cli import infer

    with open(os.path.join(workdir, "argv.json")) as f:
        argv = json.load(f)
    try:
        infer.main(argv, device="cpu")
    except NotImplementedError as e:
        return {"refused": np.asarray(str(e))}
    return {"refused": np.asarray("")}


def main(mode, workdir):
    import torch
    import torch.distributed as dist

    from comic_tpu_torch.parallel.distributed import \
        maybe_initialize_distributed

    torch.set_num_threads(1)
    if mode in ("steps", "host"):  # the CLIs join the job themselves
        assert maybe_initialize_distributed(device="cpu")
    try:
        if mode == "steps":
            out = _steps(workdir, dist.get_rank(), dist.get_world_size())
        elif mode == "host":
            out = _host(workdir)
        elif mode == "train_cli":
            out = _train_cli(workdir)
        else:
            out = _infer_cli(workdir)
        out["backend"] = np.asarray(dist.get_backend())
        out["world"] = np.asarray(dist.get_world_size())
        np.savez(os.path.join(workdir, f"result_{dist.get_rank()}.npz"),
                 **out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, _REPO)
    main(sys.argv[1], sys.argv[2])
