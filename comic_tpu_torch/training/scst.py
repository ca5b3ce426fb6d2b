"""SCST (self-critical sequence training): REINFORCE fine-tuning, the third
training stage; counterpart of comic_tpu/training/scst.py (reference
train_fn.py:150-307).

One SCST step:
  1. the rollout (under ``torch.no_grad``) encodes the image batch once and
     runs the beam search (beam 7, the "samples") and the greedy baseline
     off one shared attention memory; on the card their attention steps are
     the kernels K1 and K2. It returns the decoded ids and the encoder
     outputs, which stay on the device;
  2. the host turns the ids into captions, scores them against the
     references (CIDEr-D and BLEU; reward = score(beam hypothesis) -
     score(greedy caption), train_fn.py:243-248) and re-encodes the
     hypotheses as padded ids, reordered image-major;
  3. the train step teacher-forces the hypotheses over the beam-repeated
     encoder outputs (``repeat_interleave``: rows i*K..(i+1)*K-1 are image
     i), with mean(per-example XE x reward) + attention-map loss + masked L2
     (model_base.py:342-347), and updates the parameters in place. It takes
     the torch-ops attention under autograd, so no kernel launches there.

The rollout runs under ``no_grad``, not ``inference_mode``: its ``im_embed``
and ``fmaps`` enter the train step's autograd graph (the memory projection
runs inside ``teacher_forced``), and an inference tensor cannot be saved
for backward. It must not run with grad enabled either: the decoder's
parameters require grad, so the attention steps would take the torch ops,
launch no kernel and keep every decode step's graph.

Schedule (``scst_overlap``, default True, as comic_tpu): the rollout of
batch t+1 is issued before batch t is scored and trained on, so batch t's
hypotheses come from parameters one update older than those its gradient
is applied to (comic_tpu's one-step-stale schedule); the run trains
exactly ``max_step`` steps. ``scst_overlap=False`` is the reference's
on-policy schedule: rollout, score and train on the same batch. The
decoders run only to the batch's longest hypothesis
(``xe._trim_global``), where comic_tpu pads to ``hypo_width`` and masks:
the losses are the same.

Data parallelism (parallel/): in a torch.distributed job the global batch
is ``batch_size_train`` itself, as in comic_tpu. The SCST pipeline is not
split: every rank loads the whole batch and its references, takes its
contiguous block of images (``feed_global``) for the rollout, scores its
own block against its slice of the references (``host_score_shard``) and
runs the reward-weighted step on its hypotheses. On one host whose ranks
do not divide the batch (batch 10 on 8 ranks) the mesh keeps the ranks
that do (5) and warns, as comic_tpu's does; the others take empty blocks,
decode and score nothing, and add zeros to the step's collectives. As in
the XE step (training/xe.py) the ranks agree on the global longest
hypothesis, each adds its share of the global loss, rank 0 alone adds the
L2 term, the draws are taken at the global shape, and the gradients are
summed by one coalesced all_reduce before the optimizer's clip. The
score metrics (reward, score_sample, score_greedy) are each rank's own
block's, as comic_tpu logs each host's.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DeviceLike, resolve_device
from ..configuration import Config
from ..data.pipeline import ScstPipeline
from ..data.preprocessing import preprocess_for
from ..decoding.search import (beam_search_from_memory,
                               greedy_or_sample_from_memory)
from ..evaluation.scorers import CaptionScorer
from ..models.attention import precompute
from ..models.captioner import (ModelSpec, attention_map_loss,
                                build_model_spec, init_params,
                                process_captions, sequence_loss)
from ..models.decoder import teacher_forced
from ..models.encoders import encode_images
from ..parallel.mesh import (Mesh, ProcessBlock, all_reduce_grads, barrier,
                             block_count, feed_global, local_batch,
                             local_batch_start, make_mesh_for_batch,
                             process_count, process_index, replicate,
                             takes_part)
from ..tokenization import (RadixCodec, Vocabulary,
                            caption_strings_to_batched_ids, ids_to_captions)
from ..utils.summaries import SummaryWriter
from . import checkpoints as ckpt
from .optimizer import Optimizer, masked_l2_loss, set_trainable, tree_get
from .schedule import cosine_schedule
from .xe import (TrainState, _block_augment, _block_dropout, _resolve_vocab,
                 _trim_global)

SCST_MAX_WORDS = 20  # forced during SCST sampling (model_base.py:203-206)


def scst_decode_steps(config: Config, vocab: Vocabulary) -> int:
    steps = SCST_MAX_WORDS
    if config.token_type == "radix":
        steps *= RadixCodec(len(vocab), config.radix_base).word_len
    elif config.token_type == "char":
        steps *= 5
    return steps


def hypo_width(config: Config, vocab: Vocabulary) -> int:
    """Padded width of the hypothesis id batches: GO + body + EOS."""
    return scst_decode_steps(config, vocab) + 2


def make_rollout(spec: ModelSpec, config: Config, vocab: Vocabulary,
                 device: DeviceLike = None) -> Callable:
    """(params, images_u8, generator) -> (greedy_ids (B, T), beam_ids
    (K, B, T), im_embed, fmaps), under no_grad on ``device``. The beam ids
    are in the reference's beam-major layout, so host scoring sees
    [im0_b0..imN_b0, im0_b1, ...]. ``generator`` (on ``device``) draws the
    augment. In a job ``images_u8`` is the rank's ProcessBlock of the
    global batch (``feed_global``), the augment is drawn for the global
    batch, and the ids come back as the rank's blocks of the global ids;
    an idle rank's empty block decodes nothing (empty ids, no encoder
    outputs)."""
    device = resolve_device(device)
    h, w = config.cnn_input_size
    beam = int(config.scst_beam_size)
    steps = scst_decode_steps(config, vocab)
    augment = bool(config.cnn_input_augment)
    preprocess = preprocess_for(config.cnn_name)

    @torch.no_grad()
    def rollout(params, images_u8, generator: Optional[torch.Generator] = None):
        block = images_u8 if isinstance(images_u8, ProcessBlock) else None
        images_u8 = local_batch(images_u8)
        if block is not None and block.idle:
            return (block.like(torch.zeros((0, 0), dtype=torch.int32)),
                    block.like(torch.zeros((beam, 0, 0), dtype=torch.int32),
                               axis=1), None, None)
        parts = (block.parts if block is not None and block.parts
                 else process_count())
        draws = (_block_augment(generator, images_u8, h, w, parts)
                 if augment else None)
        images = preprocess(images_u8, h, w, device, training=augment,
                            draws=draws)
        im_embed, fmaps = encode_images(
            params["encoder"], images, spec.cnn_name, spec.fm_endpoint,
            legacy=spec.legacy, dtype=spec.compute_dtype)
        memory = precompute(params["decoder"]["attention"],
                            spec.decoder.attention, fmaps,
                            dtype=spec.compute_dtype)
        # early exit: each decode stops once every row or beam emitted EOS
        # (the same outputs as the full-length loop)
        greedy = greedy_or_sample_from_memory(
            params["decoder"], spec, im_embed, memory, max_steps=steps,
            collect_alignments=False, early_exit=True)
        _, all_beams = beam_search_from_memory(
            params["decoder"], spec, im_embed, memory, beam_size=beam,
            max_steps=steps, length_penalty=0.0, collect_alignments=False,
            early_exit=True)
        if block is None:  # one process
            return greedy.ids, all_beams["ids"], im_embed, fmaps
        return (block.like(greedy.ids),
                block.like(all_beams["ids"], axis=1), im_embed, fmaps)

    return rollout


def make_scst_train_step(spec: ModelSpec, config: Config,
                         device: DeviceLike = None,
                         mesh: Optional[Mesh] = None) -> Callable:
    """(state, im_embed, fmaps, hypo_ids, rewards, generator) -> (state,
    metrics of 0-d tensors). ``im_embed``/``fmaps`` are per image (from the
    rollout) and are repeated on the device to the hypothesis rows;
    ``hypo_ids`` (B*K, W) and ``rewards`` (B*K,) are IMAGE-major (row i*K +
    k = image i, hypothesis k). ``generator`` (on ``device``) draws the
    dropout. Built inside a torch.distributed job, the step takes the
    rank's hypotheses and rewards (arrays or ProcessBlocks), split over the
    ranks that take part on ``mesh`` (None: every rank), and its metrics
    are the global batch's (module docstring)."""
    device = resolve_device(device)
    parts = block_count(mesh)
    rank, works = process_index(), takes_part(mesh)
    beam = int(config.scst_beam_size)
    map_scale = float(config.rnn_map_loss_scale)
    l2_decay = float(config.l2_decay)

    def train_step(state: TrainState, im_embed, fmaps, hypo_ids, rewards,
                   generator: Optional[torch.Generator] = None):
        params, opt = state.params, state.optimizer
        hypo_ids, rewards = local_batch(hypo_ids), local_batch(rewards)
        caps, steps, _ = _trim_global(hypo_ids)
        reg = masked_l2_loss(params, opt.mask, l2_decay)
        if works:
            caps = torch.as_tensor(caps).to(device, non_blocking=True)
            rewards = torch.as_tensor(
                np.asarray(rewards, np.float32)).to(device)
            im_k = im_embed.repeat_interleave(beam, dim=0)
            fm_k = fmaps.repeat_interleave(beam, dim=0)
            inputs, targets, mask = process_captions(caps)
            logits, alignments = teacher_forced(
                params["decoder"], spec.decoder, inputs, im_k, fm_k,
                training=True, dtype=spec.compute_dtype,
                dropout=_block_dropout(spec.decoder, inputs, fm_k.shape[1],
                                       generator, parts))
            per_example = sequence_loss(logits, targets, mask,
                                        average_across_batch=False)
            # this rank's shares of the global batch's losses (equal
            # blocks: the global mean is the mean of the blocks' means)
            xe = (per_example * rewards).mean() / parts
            map_loss = attention_map_loss(alignments, map_scale,
                                          valid_steps=steps) / parts
            # the L2 term is the same on every rank: add it once
            (xe + map_loss + (reg if rank == 0 else 0.0)).backward()
            local = torch.stack([xe, map_loss]).detach()
        else:  # an idle rank adds nothing to the sums
            local = torch.zeros(2, device=device)
        xe, map_loss = all_reduce_grads(
            [tree_get(params, p) for p in opt.paths], local)
        total = xe + map_loss + reg
        opt.step(params)
        metrics = {"scst_loss": xe, "map_loss": map_loss, "reg": reg,
                   "total_loss": total}
        return (TrainState(params, opt, state.step + 1),
                {k: v.detach() for k, v in metrics.items()})

    return train_step


def score_and_encode(
    scorer: CaptionScorer, config: Config, vocab: Vocabulary,
    refs: List[List[str]], greedy_ids: np.ndarray, beam_ids: np.ndarray,
    width: int,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Host side of one SCST step: ids -> strings -> rewards -> padded ids
    (beam-major rows, the scorer's layout)."""
    base = config.radix_base
    greedy_caps = ids_to_captions(greedy_ids, config.token_type, vocab, base)
    beam, batch = beam_ids.shape[0], beam_ids.shape[1]
    flat = beam_ids.reshape(beam * batch, -1)
    sample_caps = ids_to_captions(flat, config.token_type, vocab, base)
    # the scorer takes lists of singleton lists
    hypos, sc_sample, sc_greedy = scorer.get_hypo_scores(
        refs, [[c] for c in sample_caps], [[c] for c in greedy_caps])
    rewards = (sc_sample - sc_greedy).astype(np.float32)
    hypo_ids = caption_strings_to_batched_ids(
        [h[0] for h in hypos], config.token_type, vocab, base)
    fixed = np.full((hypo_ids.shape[0], width), -1, np.int32)
    fixed[:, : min(width, hypo_ids.shape[1])] = hypo_ids[:, :width]
    metrics = {"score_sample": float(np.mean(sc_sample)),
               "score_greedy": float(np.mean(sc_greedy)),
               "reward": float(np.mean(rewards))}
    return fixed, rewards, metrics


def host_score_shard(greedy_ids, beam_ids, refs, scorer: CaptionScorer,
                     config: Config, vocab: Vocabulary, width: int,
                     mesh: Optional[Mesh] = None
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, float]]:
    """Host scoring half of one SCST step -> (hypo_ids, rewards, metrics).
    The scorer works beam-major (row k*B + i, model_base.py:286-288); the
    rows are reordered IMAGE-major (row i*K + k) for the train step.

    In a job each rank scores only ITS block of the rollout
    (``local_batch``) against ITS slice of the references (the pipeline is
    not split, so every rank holds the whole batch's refs and slices them
    by its block), and its rows go back as its block of the global batch
    (placed as its rollout block): no caption crosses between ranks. An
    idle rank's empty block scores nothing and gives empty hypotheses and
    no metrics. In one process the helpers are the identity."""
    block = greedy_ids if isinstance(greedy_ids, ProcessBlock) else None
    beam = int(config.scst_beam_size)
    if block is not None and block.idle:
        return (block.like(np.zeros((0, width), np.int32), scale=beam),
                block.like(np.zeros(0, np.float32), scale=beam), {})
    if process_count() > 1:
        parts = (block.parts if block is not None and block.parts
                 else process_count())
        n_local = len(refs) // parts
        lo = process_index() * n_local
        # the refs slice assumes this rank's rows ARE the global block
        # [lo, lo + n_local); check it against the rollout's placement so
        # a surprise fails loudly instead of scoring against the wrong
        # images' references
        got = local_batch_start(greedy_ids)
        if got != lo:
            raise ValueError(
                f"multi-process SCST: process {process_index()} holds rows "
                f"starting at {got}, expected {lo}; the rollout's blocks "
                "are not in rank order (feed the images through "
                "feed_global).")
        refs = refs[lo: lo + n_local]
    hypo_ids, rewards, score_metrics = score_and_encode(
        scorer, config, vocab, refs, local_batch(greedy_ids),
        local_batch(beam_ids, axis=1), width)
    batch = hypo_ids.shape[0] // beam
    hypo_ids = hypo_ids.reshape(beam, batch, -1).transpose(1, 0, 2) \
        .reshape(beam * batch, -1)
    rewards = rewards.reshape(beam, batch).T.reshape(-1)
    if mesh is not None and block is not None:
        hypo_ids = block.like(hypo_ids, scale=beam)
        rewards = block.like(rewards, scale=beam)
    return hypo_ids, rewards, score_metrics


def _finish_step(pending, state, train_step, scorer, config, vocab, width,
                 generator, step, mesh=None):
    """Score the pending rollout (host_score_shard), then run the
    reward-weighted train step -> (state, metrics, step + 1)."""
    (greedy_ids, beam_ids, im_embed, fmaps), refs = pending
    hypo_ids, rewards, score_metrics = host_score_shard(
        greedy_ids, beam_ids, refs, scorer, config, vocab, width, mesh)
    state, metrics = train_step(state, im_embed, fmaps, hypo_ids, rewards,
                                generator)
    metrics = dict(metrics)
    metrics.update(score_metrics)
    return state, metrics, step + 1


def _scst_idf_path(config: Config) -> Optional[str]:
    """The scst-words IDF cache (train_fn.py:192-201): the config's
    ``scst_idf_path``, else ``{dataset_dir}/captions/{pattern}.p`` with
    the pattern filled by 'scst-words', where it exists."""
    path = config.get("scst_idf_path")
    if path:
        return path
    cand = os.path.join(
        config.dataset_dir, "captions",
        config.dataset_file_pattern.format("scst-words") + ".p")
    return cand if os.path.exists(cand) else None


def train_fn_scst(config: Config, *,
                  max_steps_override: Optional[int] = None, pipe=None,
                  device: DeviceLike = None) -> Dict[str, float]:
    """The SCST stage driver on ``device`` (None: the card). ``pipe`` may
    be passed in already built (by default the config's ScstPipeline, as
    comic_tpu builds it). Returns the last step's metrics. Artifacts in
    config.log_path: config.pkl (+ txt), events.jsonl, model-*/
    model_compact-* checkpoints."""
    device = resolve_device(device)
    vocab = _resolve_vocab(config)
    spec = build_model_spec(config, vocab)
    own = pipe is None
    if own:
        pipe = ScstPipeline(config, vocab)
    try:
        return _train_scst(config, spec, vocab, pipe, max_steps_override,
                           device)
    finally:
        if own:
            pipe.close()


def _train_scst(config: Config, spec: ModelSpec, vocab: Vocabulary, pipe,
                max_steps_override: Optional[int], device: torch.device
                ) -> Dict[str, float]:
    if max_steps_override is not None:
        config.max_step = max_steps_override
    max_step = int(config.max_step)

    idf_path = _scst_idf_path(config)
    weights = {"ciderD": float(config.scst_weight_ciderD),
               "bleu": list(config.scst_weight_bleu)}
    scorer = CaptionScorer(idf_path, weights)
    if idf_path is None:
        print("WARNING: no scst-words IDF cache found; CIDEr-D uses "
              "per-batch corpus document frequencies.")

    params = init_params(spec, torch.Generator().manual_seed(
        config.rand_seed), device=device)
    schedule = cosine_schedule(config.lr_start, config.lr_end, max_step)
    optimizer = Optimizer(
        params, schedule, optimiser=config.optimiser,
        adam_epsilon=config.adam_epsilon, freeze_scopes=config.freeze_scopes,
        clip_gradient_norm=config.clip_gradient_norm)
    params, start_step, mode = ckpt.restore_model(
        params, config.checkpoint_path,
        resume=bool(config.resume_training),
        exclude_scopes=config.checkpoint_exclude_scopes, optimizer=optimizer)
    print(f"INFO: restore mode = {mode}, start step = {start_step}")

    # in a job the global batch is batch_size_train, split over the ranks,
    # and every rank starts from rank 0's parameters and moments
    mesh = make_mesh_for_batch(
        config.batch_size_train,
        limit=int(config.get("num_data_shards") or 0), devices=[device])
    replicate(mesh, [params, optimizer.moments])
    set_trainable(params, optimizer.mask)

    chief = process_index() == 0  # only rank 0 writes the run's files
    if chief:
        os.makedirs(config.log_path, exist_ok=True)
        config.save(config.log_path)

    rollout = make_rollout(spec, config, vocab, device)
    train_step = make_scst_train_step(spec, config, device, mesh)
    width = hypo_width(config, vocab)
    writer = SummaryWriter(config.log_path, enabled=chief)
    saver = ckpt.make_saver(config.get("checkpoint_backend", "msgpack"))
    save_every = max(config.split_sizes["train"] // config.batch_size_train,
                     1)
    generator = torch.Generator(device=device).manual_seed(
        config.rand_seed + 2)
    state = TrainState(params, optimizer, start_step)
    step = start_step
    ov = config.get("scst_overlap")
    overlap = True if ov is None else bool(ov)
    pending = None  # (rollout outputs, refs) of the batch not yet trained on
    metrics: Dict[str, torch.Tensor] = {}
    t_last, n_since = time.time(), 0
    data_iter = iter(pipe)
    try:
        while step < max_step:
            # overlapped mode finishes the PREVIOUS rollout each iteration:
            # once the pending one lands on the final step, no rollout is
            # left to issue (the run trains exactly max_step steps)
            need_rollout = (not overlap
                            or step + (1 if pending is not None else 0)
                            < max_step)
            if need_rollout:
                images, refs = next(data_iter)
                out = rollout(state.params, feed_global(mesh, images),
                              generator)
            if not overlap:
                state, metrics, step = _finish_step(
                    (out, refs), state, train_step, scorer, config, vocab,
                    width, generator, step, mesh)
                n_since += config.batch_size_train
            else:
                if pending is not None:
                    state, metrics, step = _finish_step(
                        pending, state, train_step, scorer, config, vocab,
                        width, generator, step, mesh)
                    n_since += config.batch_size_train
                pending = (out, refs) if need_rollout else None

            if step > 0 and step % 25 == 0 and metrics:
                dt = time.time() - t_last
                m = {k: float(v) for k, v in metrics.items()}
                writer.scalars(step, dict(
                    m, examples_per_sec=n_since / max(dt, 1e-9)))
                print(f"scst step {step}/{max_step} reward "
                      f"{m.get('reward', 0):.4f} "
                      f"{n_since / max(dt, 1e-9):.1f} ex/s")
                t_last, n_since = time.time(), 0
            if step > 0 and step % save_every == 0 and chief:
                saver.save(config.log_path, step, state.params,
                           optimizer.state_dict(state.params),
                           max_saves=config.max_saves)

        if pending is not None:
            state, metrics, step = _finish_step(
                pending, state, train_step, scorer, config, vocab, width,
                generator, step, mesh)
        if chief:
            saver.save(config.log_path, step, state.params,
                       optimizer.state_dict(state.params),
                       max_saves=config.max_saves)
    finally:
        if hasattr(data_iter, "close"):
            data_iter.close()
        saver.close()
        writer.close()
    barrier()  # rank 0's files are complete before any rank returns
    return {k: float(v) for k, v in metrics.items()}
