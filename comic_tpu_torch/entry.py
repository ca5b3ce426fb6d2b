"""Entry points: the XE forward on the flagship model, with example args,
and the data-parallel dry run; counterparts of comic_tpu's
``__graft_entry__.entry`` and ``dryrun_multichip``.

The flagship is COMIC-256: the Inception-V1 encoder and the radix-256,
8-head, tied-projection attention-LSTM decoder (LSTM 512, word size 256).
"""

from __future__ import annotations

import socket
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import DeviceLike, resolve_device
from .configuration import Config
from .models.captioner import ModelSpec, build_model_spec, init_params
from .models.captioner import xe_forward
from .params import from_jax_tree
from .tokenization import Vocabulary


def standin_vocab(num_words: int = 50) -> Vocabulary:
    """Small stand-in vocabulary with the reference id layout (PAD=-1,
    words, UNK/GO/EOS): the radix softmax size depends only on the base,
    so a stand-in serves the flagship's widths."""
    wtoi = {"<PAD>": -1}
    for i in range(num_words):
        wtoi[f"w{i}"] = i
    wtoi.update({"<UNK>": num_words, "<GO>": num_words + 1,
                 "<EOS>": num_words + 2})
    return Vocabulary(wtoi)


def flagship(tiny: bool = False) -> Tuple[Config, ModelSpec]:
    """COMIC-256's configuration (reference defaults) and model spec;
    ``tiny`` narrows it for tests as comic_tpu's ``_flagship(tiny=True)``
    does (float32, 64x64 inputs, no dropout)."""
    kw = dict(token_type="radix", radix_base=256, attn_num_heads=8,
              cnn_fm_projection="tied", rnn_size=512, rnn_word_size=256)
    if tiny:
        kw.update(rnn_size=32, rnn_word_size=16, attn_num_heads=2,
                  radix_base=16, compute_dtype="float32",
                  cnn_input_size=(64, 64), dropout_rnn_in=0.0,
                  dropout_rnn_out=0.0, attn_keep_prob=1.0)
    config = Config(**kw)
    return config, build_model_spec(config, standin_vocab())


def entry(device: DeviceLike = None, *, tiny: bool = False,
          params: Optional[Dict[str, Any]] = None, seed: int = 0,
          ) -> Tuple[Callable, Tuple]:
    """-> (fn, example_args): ``fn(params, images, captions)`` is the XE
    forward (no dropout) and returns (loss, logits); the example args are
    the weights, a batch of 8 zero images at the input size (224x224, or
    64x64 when ``tiny``; NCHW) and captions of GO, 20 zero digits and EOS.

    The weights are seeded (``seed``, through an explicit torch.Generator),
    or ``params``: a comic_tpu parameter tree (numpy, comic_tpu's layout)
    carried over by ``params.from_jax_tree``. On the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    config, spec = flagship(tiny)
    if params is None:
        weights = init_params(spec, torch.Generator().manual_seed(seed),
                              device=device)
    else:
        weights = from_jax_tree(params, device)

    def forward(params, images, captions):
        loss, aux = xe_forward(params, spec, images, captions,
                               training=False)
        return loss, aux["logits"]

    batch = 8
    h, w = config.cnn_input_size
    images = torch.zeros((batch, 3, h, w), device=device)
    dec = spec.decoder
    captions = torch.cat(
        [torch.full((batch, 1), dec.start_id, dtype=torch.int32),
         torch.zeros((batch, 20), dtype=torch.int32),
         torch.full((batch, 1), dec.end_id, dtype=torch.int32)],
        dim=1).to(device)
    return forward, (weights, images, captions)


def free_port() -> int:
    """A TCP port of localhost that is free now (for a job's rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int, device_type: str) -> None:
    """One rank of ``dryrun_multichip``: join the n-process job, then one
    XE step, a K=2 call (two more single steps, the port's
    train_steps_per_call), an SCST rollout on the rank's image block and
    one SCST step, 2 images a rank. Checks that the losses are finite and
    that every rank holds the same parameters afterwards."""
    from .parallel import distributed
    from .parallel import mesh as pm
    from .training.optimizer import Optimizer, set_trainable, tree_items
    from .training.schedule import cosine_schedule
    from .training.scst import hypo_width, make_rollout, make_scst_train_step
    from .training.xe import TrainState, make_train_step

    if device_type == "cpu":
        torch.set_num_threads(1)
    distributed.maybe_initialize_distributed(
        f"127.0.0.1:{port}", n, rank, device=device_type)
    try:
        device = pm.process_device()
        config, spec = flagship(tiny=True)
        config.batch_size_train = 2 * n  # 2 examples a rank
        b = config.batch_size_train
        mesh = pm.make_mesh_for_batch(b)
        params = init_params(spec, torch.Generator().manual_seed(0),
                             device=device)
        opt = Optimizer(params, cosine_schedule(config.lr_start,
                                                config.lr_end, 100),
                        adam_epsilon=config.adam_epsilon,
                        freeze_scopes=config.freeze_scopes)
        pm.replicate(mesh, [params, opt.moments])
        set_trainable(params, opt.mask)
        state = TrainState(params, opt, 0)
        rng = np.random.default_rng(0)  # the same global batch everywhere
        images = rng.integers(0, 256, (b, 256, 256, 3), dtype=np.uint8)
        caps = np.full((b, 12), -1, np.int32)
        caps[:, 0] = spec.decoder.start_id
        caps[:, 1:6] = rng.integers(0, 16, (b, 5))
        caps[:, 6] = spec.decoder.end_id
        gen = torch.Generator(device=device).manual_seed(0)
        step = make_train_step(spec, config, tuple(config.cnn_input_size),
                               device)
        losses = []
        for _ in range(3):
            blk = slice(rank * 2, rank * 2 + 2)
            state, metrics = step(state, images[blk], caps[blk], gen)
            losses.append(float(metrics["total_loss"]))
        if state.step != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"dryrun: XE steps {state.step}, {losses}")

        config.scst_beam_size = 2
        vocab = standin_vocab()
        rollout = make_rollout(spec, config, vocab, device)
        greedy, beams, im_embed, fmaps = rollout(
            state.params, pm.feed_global(mesh, images), gen)
        beam_ids = pm.local_batch(beams, axis=1)  # (K, 2, T)
        width = hypo_width(config, vocab)
        k = config.scst_beam_size
        hypo = np.full((2 * k, width), -1, np.int32)
        hypo[:, 0] = spec.decoder.start_id
        body = beam_ids.transpose(1, 0, 2).reshape(2 * k, -1)
        n_body = min(width - 2, body.shape[1])
        hypo[:, 1:1 + n_body] = np.maximum(body[:, :n_body], 0)
        hypo[:, -1] = spec.decoder.end_id
        rewards = rng.normal(size=b * k).astype(np.float32)
        scst_step = make_scst_train_step(spec, config, device)
        state, scst = scst_step(state, im_embed, fmaps,
                                pm.global_batch(mesh, hypo),
                                pm.feed_global(mesh, rewards), gen)
        scst_loss = float(scst["total_loss"])
        if not np.isfinite(scst_loss):
            raise AssertionError(f"dryrun: SCST loss {scst_loss}")
        mine = [v.detach().clone() for _, v in tree_items(state.params)]
        theirs = pm.replicate(mesh, [v.clone() for v in mine])
        if not all(torch.equal(a, c) for a, c in zip(mine, theirs)):
            raise AssertionError("dryrun: the ranks' parameters differ")
        if rank == 0:
            print(f"dryrun_multichip({n}) job on {pm.dist.get_backend()}: "
                  f"XE total_loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"scst_loss {scst_loss:.4f}, rollout greedy "
                  f"{tuple(pm.local_batch(greedy).shape)} a rank, "
                  f"{pm.all_reduce_grads.calls} gradient all-reduces; "
                  "parameters equal on every rank", flush=True)
    finally:
        pm.dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     timeout: float = 600.0) -> None:
    """The data-parallel dry run: an ``n_devices``-process job (one process
    a card with NCCL; with ``device="cpu"`` on the CPU with gloo) runs one
    XE step, a K=2 call, an SCST rollout and step (``_dryrun_rank``); then
    this process serves the job's global batch split over a mesh of
    ``n_devices`` devices (the cards, or the CPU n times) and checks the
    ids against the unsplit serve. Raises if a rank fails or the job
    outlives ``timeout`` seconds (its processes are then terminated)."""
    from .inference import make_serve_fn
    from .models.captioner import max_decode_steps
    from .parallel.mesh import Mesh, make_mesh

    device = resolve_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}): only "
                         f"{torch.cuda.device_count()} cards")
    ctx = torch.multiprocessing.start_processes(
        _dryrun_rank, args=(n_devices, free_port(), device.type),
        nprocs=n_devices, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun_multichip({n_devices}): the job "
                                   f"ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()

    config, spec = flagship(tiny=True)
    b = 2 * n_devices
    params = init_params(spec, torch.Generator().manual_seed(0),
                         device=device)
    images = np.random.default_rng(0).integers(0, 256, (b, 256, 256, 3),
                                               dtype=np.uint8)
    mesh = (make_mesh(n_devices) if device.type == "cuda"
            else Mesh((device,) * n_devices))
    steps = max_decode_steps(config, standin_vocab())
    ids = {}
    for name, m in (("split", mesh), ("whole", None)):
        serve = make_serve_fn(spec, config, steps, collect_alignments=False,
                              device=device, mesh=m)
        ids[name] = serve(params, images)[0].cpu()
    if ids["split"].shape[0] != b or not torch.equal(ids["split"],
                                                     ids["whole"]):
        raise AssertionError("dryrun: batch-split serving differs from the "
                             "unsplit serve")
    print(f"dryrun_multichip({n_devices}): serving split over "
          f"{mesh.size} devices, ids {tuple(ids['split'].shape)} equal "
          "to the unsplit serve; OK", flush=True)
