"""Cross-entropy training: the train and eval steps and the stage driver;
counterpart of comic_tpu/training/xe.py (reference train_fn.py:26-147 and
the model_base losses).

One train step: device augment of the uint8 batch, the CNN forward, the
teacher-forced decoder, the loss stack (XE + attention-map + masked L2),
autograd, and the optimizer's update in place. The decoder runs only to
the batch's longest caption, where the reference's dynamic_decode stops:
the pad steps of the bucket width would be masked out of both losses
(comic_tpu masks them), so the losses are the same. The attention kernels
stay off every step that needs a gradient (models/attention.py); the
eval-perplexity pass runs under no_grad, where K2 takes the attention.

Data parallelism (parallel/): in a torch.distributed job the global
batch is batch_size_train rows a host, as in comic_tpu (batch_size_train
times jax.process_count()); the ranks that take part on the job's mesh
each run the step on their equal block of it, and the step equals the
one-process step on the global batch. The ranks agree first on the global
longest caption and the global count of target tokens (one all_gather);
each scales its XE and attention-map terms to its share of the global
batch's, rank 0 alone adds the L2 term, and the gradients are summed by
one coalesced all_reduce before the optimizer's per-leaf clip. A rank
that idles on a one-host mesh (make_mesh_for_batch) runs no forward pass:
it adds zeros to the all_gather and the all_reduce and takes the same
update. The augment and dropout are drawn at the global batch's shape and
each rank takes its rows, so even with dropout on the W-rank step is the
one-process step. Outside a job the same code runs with one rank: the
share is 1 and the collectives are the identity. The CNN's
BatchNorm runs in inference mode in every stage (moving statistics
frozen, as in comic_tpu), so no statistics are synchronised.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..configuration import Config
from ..data import captions as cap_io
from ..data.pipeline import PAD_ID, TrainPipeline
from ..data.preprocessing import check_crop, draw_augment, preprocess_for
from ..models.captioner import (
    ModelSpec,
    attention_map_loss,
    build_model_spec,
    init_params,
    process_captions,
    sequence_loss,
    xe_forward,
)
from ..models.decoder import DropoutMasks, draw_dropout_masks, teacher_forced
from ..models.encoders import encode_images
from ..models.layers import count_params
from ..parallel.mesh import (Mesh, all_gather_ints, all_reduce_grads,
                             all_reduce_sum, barrier, block_count,
                             feed_global, host_count, make_mesh_for_batch,
                             process_count, process_index, replicate,
                             takes_part)
from ..params import jax_shape
from ..tokenization import Vocabulary, build_char_vocab
from ..utils.profiling import StepTracer
from ..utils.summaries import SummaryWriter
from . import checkpoints as ckpt
from .optimizer import (Optimizer, masked_l2_loss, path_string,
                        set_trainable, tree_get, tree_items)
from .schedule import cosine_schedule, legacy_halving_schedule

Params = Dict[str, Any]


class TrainState(NamedTuple):
    params: Params
    optimizer: Optimizer
    step: int


def _trim(captions: np.ndarray) -> Tuple[np.ndarray, int]:
    """(B, W) padded ids -> (the first n + 1 columns, n): n is the batch's
    longest caption in decode steps, the reference's dynamic_decode
    length (comic_tpu masks the steps beyond it, xe.py:79-84)."""
    caps = np.asarray(captions)
    n = int((caps[:, 1:] != PAD_ID).sum(axis=1).max())
    return caps[:, : n + 1], n


def _trim_global(captions: np.ndarray) -> Tuple[np.ndarray, int, float]:
    """A rank's block of (B, W) padded ids -> (its first n + 1 columns, n,
    its share of the global batch's target tokens): n is the GLOBAL
    batch's longest caption in decode steps (comic_tpu's dyn_steps is a max
    over the global batch), so every rank runs the same steps. One
    all_gather (an idle rank's empty block adds zeros); outside a job
    ``_trim`` and a share of 1."""
    caps = np.asarray(captions)
    valid = caps[:, 1:] != PAD_ID
    tokens = int(valid.sum())
    gathered = all_gather_ints([int(valid.sum(axis=1).max(initial=0)),
                                tokens])
    n = int(gathered[:, 0].max())
    return caps[:, : n + 1], n, tokens / max(int(gathered[:, 1].sum()), 1)


def _block_augment(generator: torch.Generator, images_u8, out_h: int,
                   out_w: int, parts: int):
    """draw_augment's flips and crops for this rank's block of images (one
    of ``parts`` equal blocks), drawn for the whole global batch (the
    block's rows of it), so the ranks draw what one process draws for the
    global batch."""
    b, in_h, in_w = images_u8.shape[:3]
    check_crop(in_h, in_w, out_h, out_w)
    draws = draw_augment(generator, b * parts, in_h, in_w, out_h, out_w)
    start = process_index() * b
    return tuple(d[start: start + b] for d in draws)


def _block_dropout(cfg, inputs: torch.Tensor, positions: int,
                   generator: torch.Generator, parts: int) -> DropoutMasks:
    """The train-time dropout masks of this rank's block of a decode (one
    of ``parts``), drawn for the whole global batch as ``_block_augment``
    draws."""
    b, steps = inputs.shape
    masks = draw_dropout_masks(cfg, b * parts, steps, positions, generator,
                               inputs.device)
    return masks.rows(process_index() * b, b)


def _scope_norms(tree: Params, prefix: str) -> Dict[str, torch.Tensor]:
    """Global norm of each top-level scope (the reference's per-variable
    histograms, train_fn.py:95-106, reduced to norms as comic_tpu does)."""
    return {f"{prefix}_norm/{k}": torch.sqrt(sum(
        v.float().square().sum() for _, v in tree_items(sub)))
        for k, sub in tree.items()}


def make_train_step(spec: ModelSpec, config: Config, image_size,
                    device: DeviceLike = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """The train step (state, images_u8, captions, generator) -> (state,
    metrics of 0-d tensors). ``generator`` (on ``device``) draws the
    augment and the dropout. Built inside a torch.distributed job, the
    step takes the rank's block of the global batch, split over the ranks
    that take part on ``mesh`` (None: every rank), and its metrics are the
    global batch's (module docstring)."""
    device = resolve_device(device)
    parts = block_count(mesh)
    rank, works = process_index(), takes_part(mesh)
    h, w = image_size
    augment = bool(config.cnn_input_augment)
    preprocess = preprocess_for(config.cnn_name)
    map_scale = float(config.rnn_map_loss_scale)
    l2_decay = float(config.l2_decay)
    add_vars = bool(config.add_vars_summaries)
    add_grads = bool(config.add_grad_summaries)

    def train_step(state: TrainState, images_u8, captions,
                   generator: Optional[torch.Generator] = None):
        params, opt = state.params, state.optimizer
        caps, steps, share = _trim_global(captions)
        reg = masked_l2_loss(params, opt.mask, l2_decay)
        if works:
            caps = torch.as_tensor(caps).to(device, non_blocking=True)
            draws = (_block_augment(generator, images_u8, h, w, parts)
                     if augment else None)
            images = preprocess(images_u8, h, w, device, training=augment,
                                draws=draws)
            im_embed, fmaps = encode_images(
                params["encoder"], images, spec.cnn_name, spec.fm_endpoint,
                legacy=spec.legacy, dtype=spec.compute_dtype)
            inputs, targets, mask = process_captions(caps)
            logits, alignments = teacher_forced(
                params["decoder"], spec.decoder, inputs, im_embed, fmaps,
                training=True, dtype=spec.compute_dtype,
                dropout=_block_dropout(spec.decoder, inputs, fmaps.shape[1],
                                       generator, parts))
            # this rank's shares of the global batch's losses (equal
            # blocks)
            log_ppl = sequence_loss(logits, targets, mask) * share
            map_loss = attention_map_loss(alignments, map_scale,
                                          valid_steps=steps) / parts
            # the L2 term is the same on every rank: add it once
            (log_ppl + map_loss + (reg if rank == 0 else 0.0)).backward()
            local = torch.stack([log_ppl, map_loss]).detach()
        else:  # an idle rank adds nothing to the sums
            local = torch.zeros(2, device=device)
        log_ppl, map_loss = all_reduce_grads(
            [tree_get(params, p) for p in opt.paths], local)
        total = log_ppl + map_loss + reg
        metrics = {"log_ppl": log_ppl, "map_loss": map_loss, "reg": reg,
                   "total_loss": total}
        if add_grads:
            metrics.update(_scope_norms(
                {k: {path_string(p): v.grad for p, v in tree_items(sub)
                     if v.grad is not None}
                 for k, sub in params.items()}, "grads"))
        opt.step(params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        temp = params["decoder"]["attention"].get("softmax_temperature")
        if temp is not None:
            metrics["softmax_temperature"] = temp.detach().clone()
        if add_vars:
            with torch.no_grad():
                metrics.update(_scope_norms(params, "vars"))
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def make_eval_step(spec: ModelSpec, config: Config, image_size,
                   device: DeviceLike = None) -> Callable:
    """The eval-perplexity step (params, images_u8, captions) -> mean
    log-perplexity (0-d tensor), under no_grad: on the card its attention
    steps are the kernel K2."""
    device = resolve_device(device)
    h, w = image_size
    preprocess = preprocess_for(config.cnn_name)

    @torch.no_grad()
    def eval_step(params, images_u8, captions):
        caps, _ = _trim(captions)
        caps = torch.as_tensor(caps).to(device, non_blocking=True)
        images = preprocess(images_u8, h, w, device)
        log_ppl, _ = xe_forward(params, spec, images, caps, training=False)
        return log_ppl

    return eval_step


def evaluate_perplexity(eval_step, params, pipeline,
                        mesh: Optional[Mesh] = None) -> float:
    """exp of the mean eval log-perplexity over one pass
    (train_fn.py:320-338); the losses stay on the device until the end.

    In a job the eval pipeline is not split: every rank loads the same
    batches. Where the mesh divides batch_size_eval, each rank scores its
    block (feed_global; an idle rank's block is empty and adds zeros) and
    one all_reduce at the end sums every batch's token losses and token
    counts; otherwise every rank scores the whole batch (comic_tpu's
    replicated fallback, xe.py:240-270). Either way the result is the
    global mean."""
    if (mesh is None or process_count() == 1
            or pipeline.batch_size % mesh.size):
        losses = [eval_step(params, images, caps)
                  for images, caps in pipeline.epoch()]
        if not losses:
            return float("nan")
        mean = torch.stack(losses).mean().item()
        return float(np.exp(np.float32(mean)))
    sums, counts = [], []
    device = next(t for _, t in tree_items(params)).device
    for images, caps in pipeline.epoch():
        caps = feed_global(mesh, caps).data
        count = float((caps[:, 1:] != PAD_ID).sum())
        sums.append(eval_step(params, feed_global(mesh, images).data, caps)
                    * count if len(caps) else torch.zeros((), device=device))
        counts.append(count)
    if not sums:
        return float("nan")
    totals = all_reduce_sum(torch.stack([
        torch.stack(sums), torch.tensor(counts, device=device)]))
    mean = (totals[0] / totals[1]).mean().item()
    return float(np.exp(np.float32(mean)))


def _write_model_size(log_path: str, subtree: Params, scope: str) -> None:
    """model_size.txt in the reference's format (ops.get_model_size,
    common/ops.py:62-91), byte for byte comic_tpu's: an INFO line with the
    total, then one 'name\\r\\nshape' stanza per variable, shapes in
    comic_tpu's layout (params.jax_shape: conv kernels HWIO)."""
    entries = []
    for path, leaf in tree_items(subtree):
        entries.append((path_string(path), jax_shape(path[-1], leaf.shape)))
    total = count_params(subtree)
    mssg = (f"\r\nINFO: Scope `{scope}` contains {total:,d} trainable "
            f"parameters.\r\n\r\n")
    for name, shape in sorted(entries):
        mssg += f"{scope}/{name}\r\n{shape}\r\n\r\n"
    mssg += "\r\n\r\n"
    with open(os.path.join(log_path, "model_size.txt"), "a") as f:
        f.write(mssg)


def _resolve_vocab(config: Config) -> Vocabulary:
    if config.token_type == "char":
        return build_char_vocab()
    if config.wtoi:
        return Vocabulary.from_str_itow(config.wtoi, config.itow)
    v = cap_io.load_vocab(config.dataset_dir, config.dataset_file_pattern)
    config.wtoi = v.wtoi
    config.itow = {str(k): w for k, w in v.itow.items()}
    config.vocab_size = len(v.itow)
    return v


def train_fn(config: Config, *, max_steps_override: Optional[int] = None,
             train_pipe=None, eval_pipe=None,
             device: DeviceLike = None) -> Dict[str, float]:
    """The XE stage driver (decoder training and cnn_finetune) on
    ``device`` (None: the card). ``train_pipe``/``eval_pipe`` may be
    passed in already built (by default TrainPipelines of the config's
    dataset, as comic_tpu builds them).

    Returns the last logged metrics. Artifacts in config.log_path, as
    comic_tpu writes them: config.pkl (+ txt), model_size.txt,
    events.jsonl, model-*/model_compact-* checkpoints.
    """
    device = resolve_device(device)
    vocab = _resolve_vocab(config)
    spec = build_model_spec(config, vocab)

    own = []
    if train_pipe is None:
        train_pipe = TrainPipeline(config, vocab, "train")
        own.append(train_pipe)
    if eval_pipe is None:
        eval_pipe = TrainPipeline(config, vocab, "valid")
        own.append(eval_pipe)
    try:
        return _train(config, spec, train_pipe, eval_pipe,
                      max_steps_override, device)
    finally:
        for pipe in own:
            pipe.close()


def _train(config: Config, spec: ModelSpec, train_pipe, eval_pipe,
           max_steps_override: Optional[int], device: torch.device
           ) -> Dict[str, float]:
    if max_steps_override is not None:
        config.max_step = max_steps_override
    max_step = int(config.max_step)
    steps_per_epoch = max(train_pipe.steps_per_epoch, 1)

    params = init_params(spec, torch.Generator().manual_seed(
        config.rand_seed), device=device)
    if config.legacy:
        schedule = legacy_halving_schedule(
            config.lr_start, steps_per_epoch,
            config.lr_reduce_every_n_epochs, lr_end=config.lr_end)
    else:
        schedule = cosine_schedule(config.lr_start, config.lr_end, max_step)
    optimizer = Optimizer(
        params, schedule, optimiser=config.optimiser,
        adam_epsilon=config.adam_epsilon, freeze_scopes=config.freeze_scopes,
        cnn_grad_multiplier=config.cnn_grad_multiplier,
        clip_gradient_norm=config.clip_gradient_norm)
    params, start_step, mode = ckpt.restore_model(
        params, config.checkpoint_path,
        resume=bool(config.resume_training),
        exclude_scopes=config.checkpoint_exclude_scopes, optimizer=optimizer)
    print(f"INFO: restore mode = {mode}, start step = {start_step}")

    # in a job one step takes batch_size_train rows from EACH host (split
    # over the host's ranks that divide it), and every rank starts from
    # rank 0's parameters and optimizer moments
    global_rows = config.batch_size_train * host_count()
    mesh = make_mesh_for_batch(
        global_rows, limit=int(config.get("num_data_shards") or 0),
        devices=[device])
    replicate(mesh, [params, optimizer.moments])
    set_trainable(params, optimizer.mask)

    chief = process_index() == 0  # only rank 0 writes the run's files
    if chief:
        os.makedirs(config.log_path, exist_ok=True)
        config.save(config.log_path)
        _write_model_size(config.log_path, params["decoder"], "decoder")
    print(f"INFO: decoder params {count_params(params['decoder']):,d} / "
          f"total {count_params(params):,d}")

    image_size = tuple(config.cnn_input_size)
    train_step = make_train_step(spec, config, image_size, device, mesh)
    eval_step = make_eval_step(spec, config, image_size, device)
    # train_steps_per_call K: comic_tpu runs K steps in one dispatch (a
    # scan, bit-equal to K single steps) and logs/saves after the K; the
    # port runs the K single steps and keeps that cadence
    spc = max(int(config.get("train_steps_per_call") or 1), 1)

    writer = SummaryWriter(config.log_path, enabled=chief)
    saver = ckpt.make_saver(config.get("checkpoint_backend", "msgpack"))
    tracer = StepTracer(config.get("profile_dir"), device=device)
    log_every = max(steps_per_epoch // max(config.num_logs_per_epoch, 1), 1)
    save_every = (steps_per_epoch if steps_per_epoch <= 5000
                  else steps_per_epoch // 2)
    generator = torch.Generator(device=device).manual_seed(
        config.rand_seed + 1)
    state = TrainState(params, optimizer, start_step)
    t_last, n_since = time.time(), 0
    data_iter = iter(train_pipe)
    metrics: Dict[str, torch.Tensor] = {}
    logged_image = not (config.add_image_summaries and chief)
    try:
        while state.step < max_step:
            prev_step = state.step
            for _ in range(spc if state.step + spc <= max_step else 1):
                images, caps = next(data_iter)
                if not logged_image:
                    _log_input_image(writer, config, state.step, images,
                                     device)
                    logged_image = True
                state, metrics = train_step(state, images, caps, generator)
                n_since += global_rows
            step = state.step
            if (step // log_every) != (prev_step // log_every) \
                    or step == max_step:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                m["examples_per_sec"] = n_since / max(dt, 1e-9)
                m["lr"] = schedule(step)
                writer.scalars(step, m)
                print(f"step {step}/{max_step}  loss {m['total_loss']:.4f}  "
                      f"ppl {np.exp(m['log_ppl']):.2f}  "
                      f"{m['examples_per_sec']:.1f} ex/s")
                t_last, n_since = time.time(), 0
            tracer.step(step)
            if (step // save_every) != (prev_step // save_every) \
                    or step == max_step:
                if chief:
                    saver.save(config.log_path, step, state.params,
                               optimizer.state_dict(state.params),
                               max_saves=config.max_saves)
                eval_ppl = evaluate_perplexity(eval_step, state.params,
                                               eval_pipe, mesh)
                writer.scalars(step, {"eval_perplexity": eval_ppl})
                print(f"step {step}: eval perplexity {eval_ppl:.3f}")
    finally:
        try:
            tracer.close()
        finally:
            saver.close()
            writer.close()
    barrier()  # rank 0's files are complete before any rank returns
    return {k: float(v) for k, v in metrics.items()}


def _log_input_image(writer: SummaryWriter, config: Config, step: int,
                     images: np.ndarray, device: torch.device) -> None:
    """One eval-preprocessed input per run, scaled to [0, 255] (the
    reference's tf.summary.image of the input batch, train_fn.py:75)."""
    h, w = config.cnn_input_size
    x = preprocess_for(config.cnn_name)(images[:1], h, w, device)
    arr = x[0].permute(1, 2, 0).float().cpu().numpy()
    lo, hi = float(arr.min()), float(arr.max())
    arr = (arr - lo) / max(hi - lo, 1e-6) * 255.0
    writer.image(step, "input_image", arr.astype(np.uint8))
