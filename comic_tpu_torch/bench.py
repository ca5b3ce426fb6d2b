"""Benchmark of the port: captions/s for beam-3 serving of COMIC-256 on
one NVIDIA card, with the training legs beside it; counterpart of the
root bench.py, function by function, printing its JSON line.

    python -m comic_tpu_torch.bench [--device cuda]

Serving is the port's serve fn (``inference.make_serve_fn``): uint8 image
batch -> eval preprocessing on the card -> Inception-V1 -> radix-256
attention-LSTM beam search, whose attention steps are the kernel K1 (K2 for
a greedy decode). The operating point is the real COMIC-256 workload: a
9,962-word vocabulary (``real_vocab``), so a word is 2 radix digits and a
30-word caption takes 60 decode steps; an unreachable EOS id (``end_id``
-1) makes every beam run all 60 (the worst case). Secondary legs:

  - the early-exit floor (an EOS-biased model ends every beam at once) and
    the realistic 40-step point, both at batch 128;
  - the cost model's fields (``utils/roofline.py``) of the batch-128 serve,
    a decode step and the encoder with the attention memory;
  - the XE train step at batch 32, alone and 8 to a call, and XE's best
    examples/s over batches 32 to 256 at 8 steps a call;
  - the SCST rollout (greedy and beam 7) and train step at batch 10, and
    examples/s of the whole SCST loop (rollout, host CIDEr-D, train step)
    with the overlap schedule on and off;
  - the host loader's images/s (``tools/loader_bench.py``, in a process of
    its own).

Not ported: root bench.py's ``bench_vpu_peak`` (the TPU vector unit's tanh
rate; on the card the kernel table's bound column takes its place) and the
``*_frac_of_peak`` fields derived from it.

Every leg takes its batches, iterations and rounds as arguments, with
root bench.py's values as defaults. The weights are random, made from
seed 0, and every leg makes its images from a seed of its own. The JSON
line adds ``device`` (the card's name and power limit
from nvidia-smi), ``tf32`` (whether float32 matmuls may use TF32: torch's
default is left as it is) and ``launches`` (the K1 and K2 launches of each
leg). ``REFERENCE_CAPTIONS_PER_SEC`` is the reference era's estimate for a
single GPU (the reference publishes no captions/s), not a measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from . import DeviceLike, resolve_device
from .configuration import Config
from .data.preprocessing import preprocess_for
from .decoding.search import _prepare_memory
from .entry import flagship, standin_vocab
from .evaluation.ngrams import build_idf_cache, save_idf_cache
from .evaluation.scorers import CaptionScorer
from .inference import make_serve_fn
from .models.captioner import (ModelSpec, build_model_spec, init_params,
                               max_decode_steps)
from .ops.fused_attention import fused_add_ln_attention
from .ops.grouped_attention import grouped_add_ln_attention
from .tokenization import Vocabulary
from .training.optimizer import Optimizer, set_trainable
from .training.schedule import cosine_schedule
from .training.scst import (host_score_shard, hypo_width, make_rollout,
                            make_scst_train_step)
from .training.xe import TrainState, make_train_step
from .utils.roofline import _COUNTED, count_costs, utilization_fields

REFERENCE_CAPTIONS_PER_SEC = 50.0  # estimate: the reference publishes none
COCO_VOCAB_WORDS = 9962            # MS-COCO v25 threshold-5 vocab size
KERNELS = (grouped_add_ln_attention, fused_add_ln_attention)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def real_vocab() -> Vocabulary:
    """A vocabulary with the real COMIC-256 word count (9,962 words), so
    the radix codec needs 2 digits a word: 60 decode steps for 30 words."""
    wtoi = {"<PAD>": -1}
    for i in range(COCO_VOCAB_WORDS):
        wtoi[f"w{i}"] = i
    wtoi.update({"<UNK>": COCO_VOCAB_WORDS,
                 "<GO>": COCO_VOCAB_WORDS + 1,
                 "<EOS>": COCO_VOCAB_WORDS + 2})
    return Vocabulary(wtoi)


def flagship_model(device: DeviceLike = None, *, tiny: bool = False):
    """-> (config, spec, params, vocab): COMIC-256 (``entry.flagship``)
    over ``real_vocab`` with random weights of seed 0 on ``device`` (None:
    the card). ``tiny`` narrows the model as ``entry.flagship(tiny=True)``
    does, over its 50-word stand-in vocabulary, which at radix 16 also
    takes 2 digits a word."""
    config, _ = flagship(tiny)
    vocab = standin_vocab() if tiny else real_vocab()
    spec = build_model_spec(config, vocab)
    params = init_params(spec, torch.Generator().manual_seed(0),
                         device=device)
    return config, spec, params, vocab


def worst_case(spec: ModelSpec) -> ModelSpec:
    """The spec with an unreachable EOS: every beam runs every step."""
    return spec._replace(decoder=spec.decoder._replace(end_id=-1))


def _with(config: Config, **kw) -> Config:
    """A copy of ``config`` with ``kw`` set."""
    return Config(**config.to_dict()).update(**kw)


def _images(rng: np.random.Generator, shape, device: torch.device):
    """Seeded uint8 images, made on the host and moved to ``device``."""
    return torch.as_tensor(
        rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


def kernel_launches() -> Dict[str, int]:
    """K1's and K2's launch counts so far."""
    return {k.__name__: k.launches for k in KERNELS}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _make_serve(config: Config, spec: ModelSpec, steps: int,
                device: DeviceLike = None, lpen: Optional[float] = None
                ) -> Callable:
    """The production serving program (make_serve_fn: preprocess -> beam
    search at the config's beam, greedy at beam 1, no attention maps,
    early exit on) -> ``serve(params, images_u8)`` returning the ids on
    the device. The single source for every serving leg, so they all
    measure the same program up to (spec, steps, length penalty). With
    the unreachable-EOS spec the loop runs all ``steps``."""
    kw = {"infer_early_exit": True}
    if lpen is not None:
        kw["infer_length_penalty_weight"] = lpen
    serve = make_serve_fn(spec, _with(config, **kw), steps,
                          collect_alignments=False, device=device)
    return lambda params, images_u8: serve(params, images_u8)[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pipelined_ms(fn: Callable, args: Sequence, iters: int,
                  device: torch.device, warmup: int = 2,
                  rounds: int = 2) -> float:
    """Best of ``rounds`` mean wall ms a call: ``warmup`` calls, then each
    round queues ``iters`` calls and synchronizes the card once at its
    end (fn is called warmup + rounds * iters times).

    The port's beam and greedy loops read a flag on the host at every
    early-exit check (decoding/search.py: ``bool(finished.all())`` every
    EXIT_CHECK_EVERY steps), so successive serve calls do not overlap and
    a serving number is the wall time of one batch."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    best = math.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) * 1e3 / iters)
    return best


def bench_serving(config: Config, spec: ModelSpec, params, steps: int,
                  device: torch.device,
                  batches: Sequence[int] = (25, 64, 128, 256),
                  iters: int = 50, warmup: int = 2, rounds: int = 2):
    """Captions/s of the serve at each batch (25 is the reference's infer
    batch) -> (best captions/s, its batch, {batch: ms}, {batch: K1/K2
    launches}). Nothing is caught: on an 80 GB card every batch fits, and
    a failure fails the run."""
    serve = _make_serve(config, spec, steps, device)
    rng = np.random.default_rng(0)
    best, best_batch = 0.0, 0
    ms_by_batch, launches = {}, {}
    for batch in batches:
        images_u8 = _images(rng, (batch, 256, 256, 3), device)
        before = kernel_launches()
        ms = _pipelined_ms(serve, (params, images_u8), iters, device,
                           warmup, rounds)
        launches[batch] = launches_since(before)
        ms_by_batch[batch] = ms
        cps = batch / (ms / 1e3)
        print(f"batch {batch}: {cps:.1f} captions/s ({ms:.2f} ms/batch, "
              f"{steps} decode steps)", file=sys.stderr)
        if cps > best:
            best, best_batch = cps, batch
    return best, best_batch, ms_by_batch, launches


def eos_biased(params, end_id: int, bias: float = 8.0):
    """The parameter tree with ``bias`` added to the output projection's
    EOS logit (a new bias tensor; every other leaf shared)."""
    dec = params["decoder"]
    proj = dict(dec["output_projection"])
    b = proj["bias"].clone()
    b[end_id] += bias
    proj["bias"] = b
    return {**params, "decoder": {**dec, "output_projection": proj}}


def bench_serving_floor(config: Config, spec: ModelSpec, params, steps: int,
                        device: torch.device, batch: int = 128,
                        iters: int = 50, warmup: int = 2,
                        rounds: int = 2) -> float:
    """The fixed serving cost (encoder, attention memory, dispatch): on an
    EOS-biased model (+8 on the EOS logit, length penalty 0) every beam
    ends at once and the early-exit loop stops at its first check. Real
    serving lands between this and the worst case, set by the longest
    caption of the batch."""
    serve = _make_serve(config, spec, steps, device, lpen=0.0)
    images_u8 = _images(np.random.default_rng(4),
                        (batch, 256, 256, 3), device)
    ms = _pipelined_ms(serve, (eos_biased(params, spec.decoder.end_id),
                               images_u8), iters, device, warmup, rounds)
    print(f"serving floor (b{batch}, early exit at the first check): "
          f"{ms:.2f} ms", file=sys.stderr)
    return ms


def bench_serving_realistic(config: Config, serve_spec: ModelSpec, params,
                            device: torch.device, steps_real: int = 40,
                            batch: int = 128, iters: int = 50,
                            warmup: int = 2, rounds: int = 2):
    """Serving at the realistic caption length: under early exit a batch
    costs its longest caption, and over 128 COCO captions (capped at 20
    words at prepro, mean ~10.5) the expected longest is ~20 words, 40
    radix steps. Measured directly: the unreachable EOS with 40 steps runs
    exactly 40 iterations. -> (captions/s, ms)."""
    serve = _make_serve(config, serve_spec, steps_real, device)
    images_u8 = _images(np.random.default_rng(9),
                        (batch, 256, 256, 3), device)
    ms = _pipelined_ms(serve, (params, images_u8), iters, device, warmup,
                       rounds)
    cps = batch / (ms / 1e3)
    print(f"realistic-length serving (b{batch}, {steps_real} steps): "
          f"{cps:.1f} captions/s ({ms:.2f} ms/batch)", file=sys.stderr)
    return cps, ms


def roofline_serving(config: Config, serve_spec: ModelSpec, params,
                     steps: int, device: torch.device,
                     serve_ms_b128: Optional[float], floor_ms: float,
                     batch: int = 128) -> Dict[str, Any]:
    """The cost model's fields of the batch-128 serve, split into the
    encoder with the attention memory and the decode steps.

    The port counts loops as they run and has no trip-count hint, so the
    serve is counted once with ``steps`` fixed steps (early exit off) and
    ``decoding.search._prepare_memory`` (with the preprocessing) alone; a
    decode step is (full - prep) / steps. Both counts run in calls of their
    own, apart from the timed ones. The count has no per-trip bytes, so a
    decode step's ``bytes_lower`` is what every step must read: the
    decoder's weights and the attention memory (keys, which are also the
    tied values, and their moments). The step time is (serve ms - floor
    ms) / steps; the floor still holds a few decode steps, so the step's
    utilization is a mild underestimate."""
    h, w = config.cnn_input_size
    preprocess = preprocess_for(config.cnn_name)
    images_u8 = _images(np.random.default_rng(0),
                        (batch, 256, 256, 3), device)
    fixed = make_serve_fn(serve_spec, _with(config, infer_early_exit=False),
                          steps, collect_alignments=False, device=device)

    @torch.inference_mode()
    def prep(params, images_u8):
        return _prepare_memory(params, serve_spec,
                               preprocess(images_u8, h, w, device))

    cost_full = count_costs(fixed, params, images_u8)
    cost_prep = count_costs(prep, params, images_u8)
    cost_step = (cost_full - cost_prep).scaled(1.0 / steps)
    _, memory = prep(params, images_u8)
    cost_step.bytes_lower = float(sum(
        t.numel() * t.element_size()
        for t in tree_leaves(params["decoder"])
        + [memory.keys, memory.key_mean, memory.key_m2]
        if t is not None))

    fields: Dict[str, Any] = {}
    if serve_ms_b128:
        fields.update(utilization_fields(cost_full, serve_ms_b128,
                                         prefix="serve_b128_"))
        step_ms = max((serve_ms_b128 - floor_ms) / steps, 1e-6)
        fields["decode_step_ms_est"] = round(step_ms, 4)
        fields.update(utilization_fields(cost_step, step_ms,
                                         prefix="decode_step_"))
    if floor_ms:
        fields.update(utilization_fields(cost_prep, floor_ms,
                                         prefix="encoder_prep_b128_"))
    fields["decode_step_matmul_gflops"] = round(cost_step.mxu_flops / 1e9, 3)
    fields["decode_step_vpu_melems"] = round(cost_step.vpu_elems / 1e6, 3)
    # elements a decode step spends per aten operation; a kernel's elements
    # are what the counted operations leave of the step's total
    kernels = {k.__name__ for k in KERNELS}
    budget = {p: v for p, v in cost_step.by_primitive.items()
              if p not in _COUNTED and p not in kernels and v > 0}
    for p in kernels & set(cost_step.by_primitive):
        budget[p] = cost_step.vpu_elems - sum(budget.values())
    top = sorted(budget.items(), key=lambda kv: -kv[1])[:10]
    fields["decode_step_budget_melems"] = {
        p: round(v / 1e6, 2) for p, v in top}
    for f in sorted(fields):
        print(f"roofline {f}: {fields[f]}", file=sys.stderr)
    return fields


def _train_state(config: Config, params) -> TrainState:
    """A private copy of the weights with root bench.py's optimizer
    (cosine 1000 steps, the config's Adam epsilon and frozen scopes)."""
    p = _clone(params)
    opt = Optimizer(p, cosine_schedule(config.lr_start, config.lr_end, 1000),
                    adam_epsilon=config.adam_epsilon,
                    freeze_scopes=config.freeze_scopes)
    set_trainable(p, opt.mask)
    return TrainState(p, opt, 0)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _captions(rng: np.random.Generator, spec: ModelSpec, radix_base: int,
              lead) -> np.ndarray:
    """A typical padded caption bucket: GO + 2 x 13 radix digits + EOS
    (width 28), rows of shape ``lead``."""
    caps = np.full(tuple(lead) + (28,), -1, np.int32)
    caps[..., 0] = spec.decoder.start_id
    caps[..., 1:27] = rng.integers(0, radix_base, tuple(lead) + (26,))
    caps[..., 27] = spec.decoder.end_id
    return caps


def bench_xe_step(config: Config, spec: ModelSpec, params,
                  device: torch.device, batch: Optional[int] = None,
                  iters: int = 20, k: int = 8, iters_k: int = 10,
                  warmup: int = 2, rounds: int = 2):
    """The XE train step (make_train_step) at the reference train batch
    (32), alone and ``k`` back-to-back steps a call (train_fn's
    ``train_steps_per_call``, which runs K single steps), with the cost
    model's fields of the single step -> (ms, ms a step at k a call,
    fields)."""
    batch = int(batch or config.batch_size_train)
    train_step = make_train_step(spec, config, tuple(config.cnn_input_size),
                                 device)
    rng = np.random.default_rng(1)
    images_u8 = _images(rng, (batch, 256, 256, 3), device)
    caps = _captions(rng, spec, config.radix_base, (batch,))
    gen = torch.Generator(device=device).manual_seed(0)
    holder = {"state": _train_state(config, params)}

    def step(images_u8, caps):
        holder["state"], metrics = train_step(holder["state"], images_u8,
                                              caps, gen)
        return metrics["total_loss"]

    ms = _pipelined_ms(step, (images_u8, caps), iters, device, warmup,
                       rounds)
    print(f"xe train step (batch {batch}): {ms:.2f} ms", file=sys.stderr)

    def step_k(images_u8, caps):
        for _ in range(k):
            loss = step(images_u8, caps)
        return loss

    ms_k = _pipelined_ms(step_k, (images_u8, caps), iters_k, device, warmup,
                         rounds) / k
    print(f"xe train step (batch {batch}, {k} a call): {ms_k:.2f} ms/step",
          file=sys.stderr)

    cost = count_costs(train_step, holder["state"], images_u8, caps, gen)
    fields = utilization_fields(cost, ms, prefix="xe_step_b32_")
    for f in sorted(fields):
        print(f"roofline {f}: {fields[f]}", file=sys.stderr)
    return ms, ms_k, fields


def bench_xe_best(config: Config, spec: ModelSpec, params,
                  device: torch.device,
                  batches: Sequence[int] = (32, 64, 128, 256), k: int = 8,
                  iters: int = 6, warmup: int = 2, rounds: int = 2):
    """The best sustained XE examples/s over ``batches`` at ``k`` steps a
    call (the CNN frozen, the reference's stage-1 regime), each batch from
    a fresh copy of the weights -> (best examples/s, its batch, {batch:
    examples/s}). A larger batch is another training recipe (the schedule's
    length follows examples/batch): a capability, not the parity recipe.
    The peak device memory of each batch is printed."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=device).manual_seed(0)
    train_step = make_train_step(spec, config, tuple(config.cnn_input_size),
                                 device)
    best_eps, best_batch, by_batch = 0.0, 0, {}
    for batch in batches:
        holder = {"state": _train_state(config, params)}
        images_k = _images(rng, (k, batch, 256, 256, 3), device)
        caps_k = _captions(rng, spec, config.radix_base, (k, batch))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        def step_k(images_k, caps_k):
            for i in range(k):
                holder["state"], metrics = train_step(
                    holder["state"], images_k[i], caps_k[i], gen)
            return metrics["total_loss"]

        ms = _pipelined_ms(step_k, (images_k, caps_k), iters, device,
                           warmup, rounds) / k
        eps = batch / (ms / 1e3)
        by_batch[batch] = round(eps, 1)
        peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
                " GiB allocated" if device.type == "cuda" else "")
        print(f"xe batch {batch} ({k} a call): {ms:.2f} ms/step, "
              f"{eps:.0f} examples/s{peak}", file=sys.stderr)
        if eps > best_eps:
            best_eps, best_batch = eps, batch
        del holder, images_k  # freed before the next batch's peak
    return best_eps, best_batch, by_batch


def _scst_hypotheses(rng, spec: ModelSpec, config: Config, rows: int,
                     width: int) -> np.ndarray:
    hypo = np.full((rows, width), -1, np.int32)
    hypo[:, 0] = spec.decoder.start_id
    hypo[:, 1:width - 1] = rng.integers(0, config.radix_base,
                                        (rows, width - 2))
    hypo[:, width - 1] = spec.decoder.end_id
    return hypo


def bench_scst(config: Config, spec: ModelSpec, params, vocab: Vocabulary,
               device: torch.device, batch: int = 10, iters: int = 20,
               warmup: int = 2, rounds: int = 2):
    """The SCST rollout (greedy and beam-7 decodes off one memory: K2 and
    K1) and the reward-weighted train step at the SCST batch (10), with
    the cost model's fields of each -> (rollout ms, train ms, fields).
    The rollout is counted as it runs (early exit, the model's own EOS)."""
    config = _with(config, batch_size_train=batch)
    rollout = make_rollout(spec, config, vocab, device)
    train_step = make_scst_train_step(spec, config, device)
    rng = np.random.default_rng(2)
    images_u8 = _images(rng, (batch, 256, 256, 3), device)
    gen = torch.Generator(device=device).manual_seed(0)

    def roll(images_u8):
        return rollout(params, images_u8, gen)[0]

    roll_ms = _pipelined_ms(roll, (images_u8,), iters, device, warmup,
                            rounds)
    beam = int(config.scst_beam_size)
    print(f"scst rollout (batch {batch}, beam {beam}): {roll_ms:.2f} ms",
          file=sys.stderr)

    _, _, im_embed, fmaps = rollout(params, images_u8, gen)
    hypo = _scst_hypotheses(rng, spec, config, beam * batch,
                            hypo_width(config, vocab))
    rewards = rng.normal(size=beam * batch).astype(np.float32)
    holder = {"state": _train_state(config, params)}

    def step(im_embed, fmaps, hypo, rewards):
        holder["state"], metrics = train_step(holder["state"], im_embed,
                                              fmaps, hypo, rewards, gen)
        return metrics["total_loss"]

    train_ms = _pipelined_ms(step, (im_embed, fmaps, hypo, rewards), iters,
                             device, warmup, rounds)
    print(f"scst train step (batch {batch}x{beam}): {train_ms:.2f} ms",
          file=sys.stderr)

    fields = utilization_fields(
        count_costs(rollout, params, images_u8, gen), roll_ms,
        prefix="scst_rollout_b10_")
    fields.update(utilization_fields(
        count_costs(train_step, holder["state"], im_embed, fmaps, hypo,
                    rewards, gen), train_ms, prefix="scst_train_b10_"))
    for f in sorted(fields):
        print(f"roofline {f}: {fields[f]}", file=sys.stderr)
    return roll_ms, train_ms, fields


def bench_scst_loop(config: Config, spec: ModelSpec, params,
                    vocab: Vocabulary, device: torch.device,
                    batch: int = 10, steps: int = 50, warmup: int = 8,
                    runs: int = 2, n_batches: int = 4):
    """Steady examples/s of the whole SCST loop (rollout -> host CIDEr-D
    and BLEU-4 rewards -> train step), with the overlap schedule (batch
    t+1's rollout queued before batch t is scored and trained) and strict
    on-policy; the best of ``runs`` runs each -> (overlap, strict). The
    native CIDEr-D with a prebuilt IDF cache, over synthetic references of
    8-12 words of the vocabulary, 5 an image."""
    config = _with(config, batch_size_train=batch)
    width = hypo_width(config, vocab)
    rollout = make_rollout(spec, config, vocab, device)
    train_step = make_scst_train_step(spec, config, device)
    rng = np.random.default_rng(3)
    words = [w for w in vocab.wtoi if not w.startswith("<")][:3000]

    def ref_sentence():
        n = int(rng.integers(8, 13))
        return " ".join(words[i] for i in rng.integers(0, len(words), n))

    train_refs = [[ref_sentence() for _ in range(5)]
                  for _ in range(max(64, batch * n_batches))]
    image_pool = [_images(rng, (batch, 256, 256, 3), device)
                  for _ in range(n_batches)]
    ref_pool = [train_refs[i * batch:(i + 1) * batch]
                for i in range(n_batches)]
    with tempfile.TemporaryDirectory() as tmp:
        idf_path = os.path.join(tmp, "scst-words.p")
        save_idf_cache(idf_path, build_idf_cache(train_refs))
        scorer = CaptionScorer(idf_path, {"ciderD": 1.0,
                                          "bleu": [0, 0, 0, 2]})

    def finish(pending, state, gen):
        (greedy_ids, beam_ids, im_embed, fmaps), refs = pending
        hypo, rewards, _ = host_score_shard(
            greedy_ids, beam_ids, refs, scorer, config, vocab, width)
        return train_step(state, im_embed, fmaps, hypo, rewards, gen)

    def run(overlap: bool) -> float:
        state = _train_state(config, params)
        gen = torch.Generator(device=device).manual_seed(0)
        pending, metrics, t0 = None, None, time.perf_counter()
        for step in range(steps + warmup):
            if step == warmup:
                if metrics is not None:
                    float(metrics["total_loss"])  # drain the queue
                t0 = time.perf_counter()
            out = rollout(state.params, image_pool[step % n_batches], gen)
            refs = ref_pool[step % n_batches]
            if not overlap:
                state, metrics = finish((out, refs), state, gen)
            else:
                if pending is not None:
                    state, metrics = finish(pending, state, gen)
                pending = (out, refs)
            if step % 25 == 24:
                float(metrics["total_loss"])  # train_fn_scst logs every 25
        float(metrics["total_loss"])
        return batch * steps / (time.perf_counter() - t0)

    eps_off = max(run(overlap=False) for _ in range(runs))
    eps_on = max(run(overlap=True) for _ in range(runs))
    print(f"scst loop (batch {batch}, beam {config.scst_beam_size}): "
          f"{eps_on:.1f} ex/s overlapped, {eps_off:.1f} ex/s strict "
          f"on-policy", file=sys.stderr)
    return eps_on, eps_off


def bench_host_loader(target_cps: float, images: int = 96,
                      min_s: float = 2.0) -> Dict[str, Any]:
    """Host input-feed rates from ``tools/loader_bench.py``, run in a
    process of its own (its decode threads stay out of this process).
    Where the host lacks a library that the leg needs (PIL to write and
    decode JPEGs, h5py for the packed source), the field holds the name of
    what is missing; any other failure raises."""
    cmd = [sys.executable, "-m", "comic_tpu_torch.tools.loader_bench",
           str(target_cps), "--images", str(images), "--min_s", str(min_s)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=_ROOT)
    if out.returncode:
        raise RuntimeError(f"loader_bench failed ({out.returncode}):\n"
                           f"{out.stderr}")
    data = json.loads(out.stdout.strip().splitlines()[-1])
    fields = {
        "host_loader_images_per_s": data["file_loader_square_w8"],
        "host_loader_images_per_s_per_core":
            data["file_loader_images_per_s_per_core"],
        "host_loader_cores_to_sustain_headline":
            data["cores_to_sustain_target"],
        "host_loader_packed_h5_images_per_s":
            data["packed_h5_images_per_s"],
        "host_cores": data["host_cores"],
    }
    for f, v in fields.items():
        print(f"host_loader {f}: {v}", file=sys.stderr)
    return fields


def device_fields(device: torch.device) -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return {"name": device.type, "power_limit": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    name, limit = (s.strip() for s in out[device.index or 0].rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def create_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None, *, tiny: bool = False,
         sizes: Optional[Dict[str, Dict[str, Any]]] = None) -> Dict:
    """Run every leg and print ONE JSON line (also returned). ``sizes``
    maps a leg's name (a ``bench_*`` function without its prefix, or
    ``roofline_serving``) to keyword arguments that replace its
    defaults; ``tiny`` narrows the model (flagship_model). Both are for
    tests and smoke runs: the command line runs root bench.py's sizes."""
    args = create_parser().parse_args(argv)
    device = resolve_device(args.device)
    sizes = sizes or {}
    config, spec, params, vocab = flagship_model(device, tiny=tiny)
    beam = int(config.infer_beam_size)  # 3
    steps = max_decode_steps(config, vocab)
    assert steps == 60, f"expected the real 60-step workload, got {steps}"
    launches = {}

    def leg(name, fn, *a):
        before = kernel_launches()
        out = fn(*a, **sizes.get(name, {}))
        launches[name] = launches_since(before)
        return out

    serve_spec = worst_case(spec)
    best, best_batch, ms_by_batch, by_batch = leg(
        "serving", bench_serving, config, serve_spec, params, steps, device)
    launches.update({f"serving_b{b}": n for b, n in by_batch.items()})
    floor_ms = leg("serving_floor", bench_serving_floor, config, spec,
                   params, steps, device)
    roof_batch = sizes.get("roofline_serving", {}).get("batch", 128)
    roofline = leg("roofline_serving", roofline_serving, config, serve_spec,
                   params, steps, device, ms_by_batch.get(roof_batch),
                   floor_ms)
    real_cps, real_ms = leg("serving_realistic", bench_serving_realistic,
                            config, serve_spec, params, device)
    xe_ms, xe_scan_ms, xe_fields = leg("xe_step", bench_xe_step, config,
                                       spec, params, device)
    roofline.update(xe_fields)
    xe_best_eps, xe_best_batch, xe_by_batch = leg(
        "xe_best", bench_xe_best, config, spec, params, device)
    roll_ms, scst_ms, scst_fields = leg("scst", bench_scst, config, spec,
                                        params, vocab, device)
    roofline.update(scst_fields)
    scst_eps_on, scst_eps_off = leg("scst_loop", bench_scst_loop, config,
                                    spec, params, vocab, device)
    loader_fields = bench_host_loader(round(best, 0),
                                      **sizes.get("host_loader", {}))

    # the reference's artifact: an infer_speed.txt line
    with open("infer_speed.txt", "a") as f:
        f.write(f"{best:.2f} captions/sec (batch {best_batch}, beam {beam}, "
                f"max_steps {steps})\n")

    line = {
        "metric": "captions_per_sec_per_chip_beam3_60steps",
        "value": round(best, 2),
        "unit": "captions/s",
        "vs_baseline": round(best / REFERENCE_CAPTIONS_PER_SEC, 2),
        "baseline_note": "estimate; reference publishes no captions/s",
        "best_batch": best_batch,
        "decode_steps": steps,
        "xe_step_ms_b32": round(xe_ms, 2),
        "xe_step_ms_b32_scan8": round(xe_scan_ms, 2),
        "scst_rollout_ms_b10": round(roll_ms, 2),
        "scst_train_ms_b10": round(scst_ms, 2),
        "scst_loop_eps_overlap": round(scst_eps_on, 1),
        "scst_loop_eps_strict": round(scst_eps_off, 1),
        "serve_floor_ms_b128_earlyexit": round(floor_ms, 2),
        "serve_captions_per_s_realistic": round(real_cps, 1),
        "serve_ms_b128_realistic40": round(real_ms, 2),
        # a capability point, not the parity recipe (bench_xe_best)
        "xe_best_examples_per_s": round(xe_best_eps, 1),
        "xe_best_batch": xe_best_batch,
        "xe_examples_per_s_by_batch": xe_by_batch,
        **loader_fields,
        # the reference's infer operating point (batch 25, beam 3)
        "serve_ms_b25_refpoint": round(ms_by_batch[25], 2)
        if 25 in ms_by_batch else None,
        # utils/roofline.py: mfu against the H100 SXM's dense BF16 peak,
        # hbm_util_lower against its HBM3 rate
        "roofline": roofline,
        "device": device_fields(device),
        "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "launches": launches,
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
