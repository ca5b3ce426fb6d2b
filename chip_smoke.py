"""Smoke run of comic_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from this checkout's sources (one nvcc each,
     all at once) and print the build time;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes, with bf16 and f32 keys, print its launch plan
     (cluster size, grid, shared memory a block), and time both;
  4. serve full-width COMIC-256 (Inception-V1 at 224, 8 add_LN heads, LSTM
     512, bf16, beam 3, 60 radix steps, early exit) at batch 25 through
     comic_tpu_torch.inference.run_inference: seeded random weights with
     perturbed BN statistics, saved with save_compact and loaded back
     through the checkpoint path, 4 batches of seeded uint8 images; the
     grouped kernel K1 must have launched;
  5. the same with beam 1 (greedy); the fused kernel K2 must have launched;
  6. at batch 2 in float32 with TF32 off, compare the card's attention
     memory and top-beam ids with the port's plain CPU path;
  7. train-decoder: the training CLI's decoder stage (COMIC-256 defaults:
     bf16, dropout, alignment dropout, augment; batch 32) through
     comic_tpu_torch.training.xe.train_fn for 20 steps on in-memory
     batches from the smoke weights' compact checkpoint, one full and one
     compact checkpoint saved and one eval-perplexity pass of 2 x 61
     rows; K1 and K2 must not launch in the train steps, K2 must launch in
     the eval pass, and the XE loss must fall;
  8. train-cnnft: 10 steps of the cnn_finetune stage (nothing frozen, lr
     1e-3) from the decoder stage's directory, checked the same way;
  9. train-agree: one float32 train step (TF32 off, batch 2, nothing
     frozen, dropout and augment off) on the card and on the CPU from the
     same parameters; loss and updated parameters must agree;
 10. trace: the decoder stage as in phase 7 for TRACE_STEPS steps with
     --profile_dir (the step tracer): one TensorBoard trace with exactly
     three ProfilerStep spans and CUDA kernels inside them; the device
     busy share of the traced window read from the trace;
 11. cost-model: comic_tpu_torch.utils.roofline.count_costs of a steady
     serve-beam3 batch (25 images, 60 fixed steps, K1 on every step) and
     of one train-decoder step at batch 32, in calls apart from the
     timed ones; gflops, mfu, hbm_gb_lower and hbm_util_lower against
     the same programs' measured ms and the H100's peaks; then phase 6's
     serve counted on the card and on the CPU, every field equal;
 12. train-scst: the training CLI's scst stage (batch 10, beam 7, lr 1e-3,
     the CNN frozen, CIDEr-D weight 1 and BLEU-4 weight 2, bf16) through
     comic_tpu_torch.training.scst.train_fn_scst for 20 steps from the
     cnn_finetune stage's directory, on in-memory batches of 10 images
     with 5 references each and an IDF cache of those references in the
     dataset directory; K1 and K2 must launch in every rollout and 0
     times in every train step, losses and rewards must be finite, the
     checkpoints saved at the last step only, the CIDEr-D scorer native;
     then the step's rollout, host scoring and train step timed apart,
     also at the caps (both decodes without early exit; the train step on
     hypotheses of the references' lengths), and profiled;
 13. scst-agree: one SCST step at batch 2, beam 7, float32, TF32 off,
     dropout and augment off, on the card and on the CPU from the same
     parameters and images: greedy and all-beam ids and the rewards
     exactly equal, the loss and updated parameters within TOL_TRAIN;
 14. dp-agree, dp-train, dp-scst: this script with --dp-job in a process of
     its own, which joins a world-1 NCCL job from COMIC_COORDINATOR (a
     free port of localhost), COMIC_NUM_PROCESSES=1, COMIC_PROCESS_ID=0
     (one card: NCCL refuses two ranks on it): train-agree's float32 step
     plain twice (the card's own repeatability, printed) and then in the
     job, cuDNN deterministic, equal within TOL_DP with one gradient
     all-reduce; train-decoder's setup in the job (checked as phase 7,
     one all-reduce a step, the same files as train-decoder's directory:
     one writer); DP_SCST_STEPS steps of train-scst's setup (K1 and K2 in
     every rollout, none in a train step, one all-reduce a step);
 15. dp-serve: serve-beam3's batches through a serve fn whose mesh is
     make_mesh_for_batch over every visible card: captions equal to
     serve-beam3's JSON, ids to the unsplit serve's; K1 must launch;
 16. dryrun: comic_tpu_torch.entry.dryrun_multichip over every visible
     card (an n-process NCCL job's XE and SCST steps, then the split
     serve; the tiny model, so its launches stay out of the kernels'
     main-path counts and are reported apart as dryrun_launches);
 17. eval-sweep: the infer CLI (comic_tpu_torch.cli.infer.main) over an
     experiment directory (config.pkl at COMIC-256 defaults, bf16; the
     smoke weights' and the decoder stage's compact checkpoints) on
     in-memory images with a COCO annotations JSON of 5 random references
     an image: the test split at beam 3 (4 batches of 25), the COCO server
     split at beam 3 (batch forced to 61, 2 batches), the test split
     greedy, then scores only from the caption JSONs. K1 must launch in
     the beam sweeps and K2 in the greedy one, one pipeline must serve a
     sweep, every image get a caption, the BLEU, ROUGE-L and CIDEr scores
     be finite, the peak device memory stay flat from the first checkpoint
     to the last, and the scores-only call repeat the first call's scores;
     decode and scoring seconds printed per checkpoint;
 18. eval-agree: sweep_checkpoints over one checkpoint at batch 2, beam 3,
     float32, TF32 off, 4 images, on the card and on the CPU: the caption
     JSON and metric_scores.txt byte-identical;
 19. overfit-gate: tests/test_overfit_gate.py at COMIC-256 width (bf16):
     the port's synthetic fixture (10 solid-colour images, the test split
     mirroring train) in memory; the decoder stage restored in mode 'cnn'
     from the smoke weights' CNN written under slim names and converted by
     convert_slim_tree; GATE_XE_STEPS XE steps of batch 5 (dropout off,
     Adam epsilon 1e-6, the CNN frozen); the infer CLI at beam 3 must score
     CIDEr > 5 and BLEU-4 > 0.5; the XE checkpoints served again in
     float32, with the share of images whose bf16 and f32 top beams agree
     printed (not a gate); 20 SCST steps at beam 3 must keep a finite
     |reward| < 5 and CIDEr > 4. K1 launches in the sweeps and the SCST
     rollouts, K2 in the eval passes and the greedy baselines, neither in
     a train step;
 20. parity-gate: comic_tpu_torch.tools.parity_gate at beam 3 on copies of
     the overfit gate's XE directory (config.pkl and compact checkpoints
     as train_fn wrote them) against the fixture's test-split references,
     with the best CIDEr overfit-gate scored there as the target and the
     Python PTB fallback allowed (the card's machine has no Java): exit 0
     with that CIDEr to 1e-9 relative; the untrained smoke weights in
     its place: exit 1 with other captions; without the fallback the gate
     must raise "PTB jar required". K1 must launch, K2 not;
 21. zoo-serve: every encoder comic_tpu registers (20 --cnn_name values)
     at 224 in bf16 with COMIC-256's decoder: seeded port weights with BN
     statistics perturbed, a compact checkpoint, and 2 batches of 25
     seeded images through run_inference at beam 3; K1 must launch once
     on every beam step (counted apart by wrapping the search's step) and
     every caption hold words; per encoder L, C, encoder ms, steady-batch
     ms, captions/s, launches and peak memory. resnet_v1_50 and
     inception_v3 (one of each preprocessing kind) also serve a batch
     greedy, with K2 on every step;
 22. zoo-agree: one encoder of each module, float32 with TF32 off, batch
     2, beam 3, card vs the port's CPU path: the attention memory within
     TOL_ZOO of its scale and the top-beam ids equal;
 23. zoo-train: 10 steps of the training CLI's cnn_finetune stage with
     resnet_v1_50 at batch 32 (the VGG train augmentation on the card and
     the backward of slim's fixed-pad strided convs): finite losses, the
     checkpoints, 0 kernel launches in every train step, K2 in the eval
     pass;
 24. bench: comic_tpu_torch.bench's legs at full width (COMIC-256, the
     real 9,962-word vocabulary, the bench's weights), each leg timed as the
     best of BENCH_ROUNDS rounds of BENCH_ITERS calls after one warm-up:
     worst-case serving at batch 25; at 128 the worst case, the realistic
     40-step point and the floor, in BENCH_TURNS rotating turns with each
     leg's best kept; the cost model's
     serve, the XE step, XE's best at batches 32 and 64, the SCST rollout
     and train step, BENCH_LOOP_STEPS steps of the SCST loop with overlap
     on and off, and tools/beam_sweep's beams 1, 2, 5 and 7 at batch 128.
     Every time and rate finite and positive, every cost-model field
     finite and not negative; K1 launches 60 times a worst-case call (the
     EOS is unreachable), 40 a realistic call, 60 in the counted serve;
     K2 60 times a beam-1 call; neither in an XE step; floor ms <
     realistic ms < worst-case ms at batch 128;
 25. tokens-serve: word tokens (10,003 outputs, 30 steps) and char tokens
     (the character vocabulary, 150 steps) at full width in bf16 from a
     compact checkpoint, VARIANT_BATCHES batches of 25 through
     run_inference at beam 3 (K1 once on every beam step, K2 never) and
     greedy (K2 once on every step, K1 never), every caption holding words
     (characters); then float32 with TF32 off at batch 2: the card's and
     the CPU's attention memory within TOL_ZOO and top-beam ids equal; for
     word tokens one float32 train step card vs CPU, as train-agree;
 26. cells-serve: the LN_LSTM and GRU decoders (radix tokens), checked as
     tokens-serve, each with its train step card vs CPU;
 27. attn-variants: one batch of 25 at beam 3 in bf16 for every attention
     configuration Config accepts outside the kernels' domain (dot
     alignment, sigmoid probability, the independent projection, none
     with and without the context layer): K1 and K2 launch 0 times; the
     context layer on add_LN/softmax/tied stays inside it, K1 once on
     every step; each card vs CPU as tokens-serve;
 28. zoo-native: Inception-V3, Inception-V4 and Inception-ResNet-V2 at 299
     (L=289) and NASNet-large and PNASNet-large at 331 (L=441), seeded
     uint8 images drawn at that size (the file pipeline resizes to 256
     and never upsamples), ZOO_BATCHES batches of 25 through make_serve_fn
     at beam 3 in bf16: K1 once on every beam step, every caption holding
     words; inception_v3 and pnasnet_large also one batch greedy (K2 on
     every step) and card vs CPU in float32 at batch 2 (memory within
     TOL_ZOO, ids equal).
Each of phases 25-28 prints its seconds.

Phase 3 holds the kernels at the serving shapes, at K2's eval-perplexity
batch, at the SCST rollout's shapes (K1 at batch 10, beam 7; K2 at 10
rows for the greedy baseline), K1 at the COCO server split's batch of
61, both at the overfit gate's batch of 5 (K1 at beam 3) and both at the
serving batch at the zoo's other attention sizes, L=49 and L=144 (the
COCO server, gate and zoo shapes also checked bitwise repeatable), and
the bench's: K1 at B=64, 128 and 256 with K=3 and at B=128 with K=2, 5
and 7 (tools/beam_sweep), K2 at R=128 (its beam 1), also checked bitwise
repeatable; and both at the serving batch at L=289 and L=441, the
attention sizes of zoo-native's nets at 299 and 331 (bitwise repeatable
too).
Phases 4 and 5 also time one steady batch
and profile one more, phases 7 and 8 profile one more train step
(torch.profiler; the per-kernel tables go to smoke_out/profile_*.txt).

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")
SEED = 20260
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# special-function units (tanh, exp): 16 per SM per clock, 132 SMs at the
# H100 SXM's 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9

# main-path shapes: infer batch 25, beam 3, Mixed_4f at 224 (L = 196),
# 512 attention units in 8 heads
B, K, L, U, H = 25, 3, 196, 512, 8
# the training phases: COMIC-256's train and eval batches (the eval batch
# is K2's rows in the eval-perplexity pass), and the steps each stage takes
TRAIN_B, EVAL_B = 32, 61
DECODER_STEPS, CNNFT_STEPS = 20, 10
# the trace phase: the decoder stage's steps with --profile_dir, enough for
# the StepTracer's window over the loop's calls [10, 13) to close
TRACE_STEPS = 14
# the SCST stage: the CLI's batch and beam, the steps the smoke takes, the
# references per image
SCST_B, SCST_K, SCST_STEPS, SCST_REFS = 10, 7, 20, 5
# checkpoint evaluation: the batch the infer CLI forces on the COCO server
# split (coco_valid), the images of the test file list (4 batches of 25)
# and of the server split (2 batches of 61), the references per image in
# the annotations, and how far the peak device memory after the sweep's
# last checkpoint may sit above that after its first
COCO_B, EVAL_TEST_N, EVAL_COCO_N, EVAL_REFS = 61, 100, 122, 5
SWEEP_MEMORY_SLACK = 8 * 2**20
# the overfit gate (tests/test_overfit_gate.py's recipe at COMIC-256 width):
# its batch, beam and decode cap; the XE steps and peak learning rate that
# reach the JAX gate's thresholds at this width (PERF.md); the SCST steps;
# and how many times the train pipeline lists the fixture's 10 records an
# epoch (train_fn saves and runs an eval pass once an epoch: every 100
# steps instead of every 2). Each image still comes equally often, but an
# epoch shuffles 500 rows, so a batch of 5 may hold an image twice
GATE_B, GATE_BEAM, GATE_MAX_LEN = 5, 3, 20
GATE_XE_STEPS, GATE_XE_LR = 300, 1e-3
GATE_SCST_STEPS, GATE_REPEAT = 20, 50
# the decoder stage's mean XE log-perplexity over its last 3 steps must sit
# this far (nats) below that of its first 3: about half the drop measured
# on an H100 80GB HBM3 at 700 W (6.09 -> 5.25, 0.84 nats)
LOSS_DROP = 0.4
# train-agree: one float32 train step, card vs CPU, the same operations
# summed in other orders (cuDNN and cuBLAS against the CPU's kernels)
TOL_TRAIN = 1e-4
# the encoder zoo: every --cnn_name comic_tpu registers serves ZOO_BATCHES
# batches of B at beam 3 (bf16, 224x224: the 299/331 nets too, since the
# pipeline crops the 256x256 host images and never upsamples); one of each
# preprocessing kind also serves a batch greedy; one encoder of each
# module is held card vs CPU in float32 (ZOO_AGREE); and ResNet-50 trains
# ZOO_TRAIN_STEPS steps of the cnn_finetune stage. ZOO_L: the attention
# sizes of the zoo's default endpoints at 224 besides Inception-V1's 196
# (block3 7x7 of the ResNets; 12x12 of Inception-V3, V4 and
# Inception-ResNet-V2), at which check_kernels holds K1 and K2
ZOO_BATCHES = 2
ZOO_GREEDY = ("resnet_v1_50", "inception_v3")
ZOO_AGREE = ("inception_v2", "inception_v3", "inception_v4",
             "inception_resnet_v2", "resnet_v1_50", "resnet_v2_50", "vgg_16",
             "mobilenet_v1", "mobilenet_v2", "nasnet_mobile",
             "pnasnet_mobile")
# ResNet-50's attention size at 224 (block3, 7x7): K2's in the eval pass
ZOO_TRAIN_NET, ZOO_TRAIN_STEPS, ZOO_TRAIN_L = "resnet_v1_50", 10, 49
ZOO_L = (49, 144)
# zoo-agree: the card's attention memory against the CPU's, float32, TF32
# off (cuDNN's and the CPU's convolutions sum in other orders)
TOL_ZOO = 1e-4
# the bench phase: comic_tpu_torch.bench's legs, each the best of
# BENCH_ROUNDS rounds of BENCH_ITERS calls after one warm-up (the host-bound
# serving loop varies by ~25% between runs; the best of 3 keeps the floor <
# realistic < worst-case order of the batch-128 legs clear of it); its
# serving batches, XE best's batches, the SCST loop's steps; and
# tools/beam_sweep's beams at batch BENCH_B. The bench's serving batches
# and beams are also phase 3's K1 and K2 shapes (BENCH_BATCHES at K=3,
# BENCH_BEAMS at BENCH_B; beam 1 is K2 at R=BENCH_B)
BENCH_ITERS, BENCH_ROUNDS, BENCH_LOOP_STEPS = 4, 3, 5
# the batch-BENCH_B serving legs (worst case, realistic, floor) run this
# many times in rotating order, each leg's best kept
BENCH_TURNS = 3
BENCH_SERVE_BATCHES, BENCH_XE_BATCHES = (25, 128), (32, 64)
BENCH_B, BENCH_BATCHES, BENCH_BEAMS = 128, (64, 128, 256), (1, 2, 5, 7)
# float32 operations per (query, position, channel) besides the tanh: K1
# cross term 2, normalize 3, affine 2, v and head sum 2, context 2; K2
# takes its statistics in two passes (6) instead of the cross term. Each
# tanh (one per element) and each softmax exp (one per score) is at least
# one special-function operation.
OPS_PER_ELEMENT = {"grouped_add_ln_attention": 11,
                   "fused_add_ln_attention": 15}
# kernel vs plain version on the same card, float32 arithmetic on the same
# stored keys in both: they differ only in summation order and in the
# device's tanh/exp/rsqrt rounding (alignments ~2e-9 apart, context ~1e-7).
# With bf16 keys both round the alignments to bf16 before the context, and
# alignments that agree to 1e-9 may still round to neighbouring bf16
# values. So the context is held twice: to TOL["ctx"] against the plain
# context product of the kernel's own alignments, and to TOL["ctx"] plus
# what those roundings explain against the plain version's context (see
# rounding_slack).
TOL = {"ctx": 1e-4, "align": 1e-7}


def median_ms(fn, iters=50, warmup=5):
    """Median CUDA-event time of one call, the host's launch time included
    (for whole serve calls, which sync on the host)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the card spins this many cycles (~50 ms) while the host queues a timed run
SLEEP_CYCLES = 100_000_000


def device_ms(fn, calls=20, reps=5):
    """-> (median device ms per call, median host ms per call).

    The card is held in a spin kernel while the host queues ``calls``
    calls between two events, so the events time the device work back to
    back and not the host's launch overhead, which is returned beside it.
    The inputs stay in L2 between calls, as the keys do between decode
    steps.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / calls)
        end.synchronize()
        dev.append(start.elapsed_time(end) / calls)
    return statistics.median(dev), statistics.median(host)


def profile_serve(serve, params, images, tag):
    """One serve call under torch.profiler -> (device busy ms, wall ms,
    top kernels); the full per-kernel table goes to smoke_out/."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(params, images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us, last = 0.0, float("-inf")  # union of the device spans
    for s, t in sorted(spans):
        if t > last:
            busy_us += t - max(s, last)
            last = t
    table = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    with open(os.path.join(OUT, f"profile_{tag}.txt"), "w") as f:
        for name, (n, us) in table:
            f.write(f"{us / 1e3:10.3f} ms {n:6d} x  {name}\n")
    return busy_us / 1e3, wall_ms, table[:5]


def kernel_inputs(keys_dtype, rows, beams, length=L):
    """Seeded main-path inputs on the card (``length`` positions a row);
    beams=None gives K2's (R, U) queries over per-row keys."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    keys = torch.randn(rows, length, U, generator=g).to("cuda", keys_dtype)
    qshape = (rows, U) if beams is None else (rows, beams, U)
    query = torch.randn(*qshape, generator=g).cuda()
    vecs = [(torch.rand(U, generator=g) - 0.5).cuda() * 0.2,
            1.0 + 0.3 * torch.randn(U, generator=g).cuda(),
            0.3 * torch.randn(U, generator=g).cuda(),
            torch.tensor(5.0).cuda()]
    k32 = keys.float()
    return query, keys, k32.mean(-1), k32.square().mean(-1), vecs


def rounding_slack(align, align_p, keys, context):
    """How far the kernel's context may sit from the plain version's
    because their alignments round to different neighbours in the keys'
    dtype: each such alignment moves every channel of its head by its
    rounding step times |key| (in float32, where rounding does nothing,
    their own difference does). Raises unless every step is at most their
    difference plus one step of the dtype (a * eps, or the smallest normal
    number where the kernel flushes a subnormal exponential to 0) -> slack
    per context output."""
    import torch

    step = (align.to(keys.dtype).float()
            - align_p.to(keys.dtype).float()).abs()
    info = torch.finfo(keys.dtype)
    one = ((align - align_p).abs() + info.tiny
           + torch.maximum(align.abs(), align_p.abs()) * info.eps)
    if not (step <= one).all():
        i = (step - one).argmax()
        raise AssertionError(
            f"kernel and plain alignments round more than one step apart: "
            f"{align.flatten()[i].item():.6e} and "
            f"{align_p.flatten()[i].item():.6e}")
    # a difference of two values of the keys' dtype that are neighbours, or
    # a float32 difference, is exact in that dtype
    return context(step, keys.abs(), num_heads=H)


def check_kernels():
    """Phase 3 -> per-kernel records (without launches)."""
    import torch

    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1

    records = {}
    # K1 and K2 at the serving batch ("main"), K2 at the eval-perplexity
    # batch of the training phases (one query per caption row), both at
    # the SCST rollout's batch (K1 for the beam-7 search, K2 for the greedy
    # baseline), and K1 at the COCO server split's forced batch of 61 (the
    # eval sweep; K2's rows there are eval_shape's 61), and both at the
    # overfit gate's batch of 5 (its sweeps and SCST rollouts at beam 3, its
    # eval passes and greedy baselines), and both at the serving batch at
    # the encoder zoo's other attention sizes (ZOO_L at 224, ZOO_NATIVE_L at
    # the 299/331 nets' own sizes)
    shapes = [("grouped_add_ln_attention", K, B, "main", L),
              ("fused_add_ln_attention", None, B, "main", L),
              ("fused_add_ln_attention", None, EVAL_B, "eval_shape", L),
              ("grouped_add_ln_attention", SCST_K, SCST_B, "scst_shape", L),
              ("fused_add_ln_attention", None, SCST_B, "scst_shape", L),
              ("grouped_add_ln_attention", K, COCO_B, "coco_shape", L),
              ("grouped_add_ln_attention", GATE_BEAM, GATE_B, "gate_shape",
               L),
              ("fused_add_ln_attention", None, GATE_B, "gate_shape", L)]
    for length in ZOO_L + ZOO_NATIVE_L:
        shapes += [("grouped_add_ln_attention", K, B, f"zoo_L{length}",
                    length),
                   ("fused_add_ln_attention", None, B, f"zoo_L{length}",
                    length)]
    # the bench's serving batches at beam 3, and beam_sweep's beams at its
    # batch: K1 with K beams, K2 for beam 1
    shapes += [("grouped_add_ln_attention", K, rows, f"bench_b{rows}", L)
               for rows in BENCH_BATCHES]
    for beams in BENCH_BEAMS:
        if beams == 1:
            shapes.append(("fused_add_ln_attention", None, BENCH_B,
                           f"bench_r{BENCH_B}", L))
        else:
            shapes.append(("grouped_add_ln_attention", beams, BENCH_B,
                           f"bench_b{BENCH_B}_k{beams}", L))
    for name, beams, rows, tag, length in shapes:
        worst = 0.0
        for keys_dtype in (torch.float32, torch.bfloat16):
            query, keys, mean, m2, vecs = kernel_inputs(keys_dtype, rows,
                                                        beams, length)
            if beams is None:
                plan = k2.fused_add_ln_attention_plan(keys, num_heads=H)

                def kern():
                    return k2.fused_add_ln_attention(query, keys, *vecs,
                                                     num_heads=H)

                def plain():
                    return k2.fused_add_ln_attention_plain(
                        query, keys, *vecs, num_heads=H)

                context = k2.fused_context_plain
            else:
                plan = k1.grouped_add_ln_attention_plan(keys, beams,
                                                        num_heads=H)

                def kern():
                    return k1.grouped_add_ln_attention(
                        query, keys, mean, m2, *vecs, num_heads=H)

                def plain():
                    return k1.grouped_add_ln_attention_plain(
                        query, keys, mean, m2, *vecs, num_heads=H)

                context = k1.grouped_context_plain
            (ctx, align), (ctx_p, align_p) = kern(), plain()
            torch.cuda.synchronize()
            slack = rounding_slack(align, align_p, keys, context)
            direct = (ctx - ctx_p).abs()
            err = {"ctx": (ctx - context(align, keys, num_heads=H))
                   .abs().max().item(),
                   "align": (align - align_p).abs().max().item()}
            beyond = (direct - slack).max().item()
            print(f"{name} R={rows} L={length} keys={str(keys_dtype)[6:]}: "
                  f"cluster of "
                  f"{plan['cluster']} blocks, grid {plan['grid']}, "
                  f"{plan['smem_bytes']} B shared memory a block, keys "
                  f"{'staged' if plan['keys_staged'] else 'not staged'}; "
                  f"max |kernel - plain| ctx {err['ctx']:.3e} (tol "
                  f"{TOL['ctx']:.0e}), align {err['align']:.3e} (tol "
                  f"{TOL['align']:.0e}); against the plain context "
                  f"{direct.max().item():.3e}, of which alignment rounding "
                  f"explains up to {slack.max().item():.3e}: "
                  f"{beyond:.3e} beyond it (tol {TOL['ctx']:.0e})")
            if not (all(err[k] <= TOL[k] for k in TOL)
                    and beyond <= TOL["ctx"]):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {err}, {beyond} beyond "
                                     f"the rounding slack")
            if not (torch.isfinite(ctx).all() and torch.isfinite(align).all()):
                raise AssertionError(f"{name} produced non-finite values")
            # the plans of new row counts and lengths
            if tag in ("coco_shape", "gate_shape") or tag.startswith(
                    ("zoo", "bench")):
                again = kern()
                if not (torch.equal(again[0], ctx)
                        and torch.equal(again[1], align)):
                    raise AssertionError(f"{name} R={rows} L={length} is "
                                         "not bitwise repeatable")
                print(f"{name} R={rows} L={length} "
                      f"keys={str(keys_dtype)[6:]}: a second launch gives "
                      "bitwise the same outputs")
            worst = max(worst, *err.values())
        # times and bound at the main path's dtype (bf16 keys)
        ms, host_ms = device_ms(kern)
        plain_ms, plain_host_ms = device_ms(plain)
        n_q = rows * (beams or 1)
        nbytes = (query.numel() * 4 + keys.numel() * keys.element_size()
                  + sum(v.numel() * 4 for v in vecs)
                  + (2 * rows * length * 4 if beams else 0)  # key moments
                  + n_q * U * 4 + n_q * H * length * 4)  # ctx, align
        ops = OPS_PER_ELEMENT[name] * n_q * length * U
        sfu = n_q * length * U + n_q * H * length  # tanh, softmax exp
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "float32 operations": ops / F32_FLOP_PER_S * 1e3,
                 "special-function operations": sfu / SFU_OPS_PER_S * 1e3}
        bound_by = max(times, key=times.get)
        record = {
            "name": name, "route": "cuda",
            "source": f"comic_tpu_torch/csrc/{name}.cu",
            "replaces": ("comic_tpu/ops/grouped_attention.py:89" if beams
                         else "comic_tpu/ops/fused_attention.py:69"),
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": times[bound_by],
            "bound_by": "bytes" if bound_by == "bytes" else "operations",
            "library_ms": None,  # no single PyTorch call is add_LN attention
        }
        if tag == "main":
            records[name] = record
        else:  # another shape of the path: kept beside the main one
            records[name][tag] = {
                "rows": rows, "beams": beams, "L": length,
                "max_abs_err": worst,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": times[bound_by],
                "bound_by": record["bound_by"], "plan": plan}
        print(f"{name} R={rows}"
              f"{f' K={beams}' if beams else ''} L={length}: {ms:.4f} ms on "
              f"the card "
              f"({ms / times[bound_by]:.1f}x its bound; plain "
              f"{plain_ms:.4f} ms, "
              f"bound {times[bound_by] * 1e3:.2f} us by {bound_by}: "
              f"{nbytes / 1e6:.2f} MB in {times['bytes'] * 1e3:.2f} us, "
              f"{ops / 1e6:.1f} MFLOP in "
              f"{times['float32 operations'] * 1e3:.2f} us, {sfu / 1e6:.2f} M"
              f" tanh/exp in "
              f"{times['special-function operations'] * 1e3:.2f} us); host "
              f"time to launch one call {host_ms:.4f} ms (plain "
              f"{plain_host_ms:.4f} ms)")
    return records


def smoke_config(beam: int, batch: int, dtype: str,
                 cnn_name: str = "inception_v1", **overrides):
    """Full-width COMIC-256 serving config with a COCO-sized vocabulary
    (10,000 words: 2 radix digits per word, 60 decode steps), with encoder
    ``cnn_name`` attending to its default endpoint, and ``overrides`` set
    (char tokens take the character vocabulary)."""
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.models.encoders import get_encoder
    from comic_tpu_torch.tokenization import build_char_vocab

    wtoi = {"<PAD>": -1}
    wtoi.update({f"w{i}": i for i in range(10000)})
    wtoi.update({"<UNK>": 10000, "<GO>": 10001, "<EOS>": 10002})
    itow = {str(i): w for w, i in wtoi.items()}
    config = Config(wtoi=wtoi, itow=itow, log_path=os.path.join(OUT, "exp"),
                    batch_size_infer=batch, infer_beam_size=beam,
                    compute_dtype=dtype, infer_early_exit=True,
                    cnn_name=cnn_name,
                    cnn_fm_attention=get_encoder(cnn_name)
                    .default_fm_endpoint, **overrides)
    if config.token_type == "char":
        chars = build_char_vocab()
        config.update(wtoi=chars.wtoi,
                      itow={str(i): c for i, c in chars.itow.items()})
    return config


def smoke_weights(spec):
    """Seeded port init with BN statistics perturbed and the output
    projection spread, on the CPU."""
    import torch

    from comic_tpu_torch.models.captioner import init_params

    g = torch.Generator().manual_seed(SEED)
    params = init_params(spec, generator=g, device="cpu")

    def walk(d):
        # BN statistics by their slim leaf names (nasnet's leaf keys keep
        # their scope: 'conv0_bn/moving_mean'); the decoder has none
        for key, v in d.items():
            leaf = key.rsplit("/", 1)[-1]
            if isinstance(v, dict):
                walk(v)
            elif leaf in ("beta", "moving_mean"):
                v += 0.1 * torch.randn(v.shape[0], generator=g)
            elif leaf == "moving_variance":
                v *= 1 + 0.2 * torch.rand(v.shape[0], generator=g)

    walk(params)
    proj = params["decoder"]["output_projection"]
    proj["kernel"] *= 4
    # favour the leading digits of the 10,000 word ids so captions hold words
    proj["bias"][:40] = 2.0
    return params


def image_batches(n_batches, batch, size=256):
    """Seeded uint8 (batch, size, size, 3) images with COCO-style names."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n_batches):
        imgs = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        names = [f"images/COCO_smoke_{i * batch + j:012d}.jpg"
                 for j in range(batch)]
        out.append((imgs, names))
    return out


def serve_phase(beam, kernel, ckpt_path, batches):
    """Phases 4/5: run_inference on the card; returns (launches, line)."""
    import torch

    from comic_tpu_torch.data.preprocessing import preprocess_batch
    from comic_tpu_torch.decoding import search
    from comic_tpu_torch.inference import make_serve_fn, run_inference
    from comic_tpu_torch.models.captioner import (
        build_model_spec,
        init_params,
        max_decode_steps,
    )
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import load_compact

    config = smoke_config(beam, B, "bfloat16")
    kernel.launches = 0
    t0 = time.perf_counter()
    _, json_path = run_inference(config, ckpt_path, pipe=batches)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    with open(json_path) as f:
        caps = json.load(f)
    n_images = sum(len(names) for _, names in batches)
    if len(caps) != n_images or not all(
            isinstance(c["caption"], str) for c in caps):
        raise AssertionError(f"caption JSON has {len(caps)} entries, "
                             f"expected {n_images}")
    if launches <= 0:
        raise AssertionError(f"{kernel.__name__} never launched in the "
                             f"beam-{beam} serving run")

    # steady-state timing of one batch: encoder alone, then the whole serve
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    params = load_compact(ckpt_path, init_params(spec, device="cuda"))
    serve = make_serve_fn(spec, config, max_decode_steps(config, vocab),
                          collect_alignments=False)
    images = batches[0][0]

    @torch.inference_mode()
    def encode():
        return search._prepare_memory(
            params, spec, preprocess_batch(images, 224, 224,
                                           torch.device("cuda")))

    enc_ms = median_ms(encode, iters=10, warmup=2)
    before = kernel.launches
    serve_ms = median_ms(lambda: serve(params, images), iters=5, warmup=1)
    # one launch per decode step, over 1 warm-up + 5 timed calls
    steps = (kernel.launches - before) / 6
    print(f"beam {beam}: {n_images} captions in {wall:.2f} s through "
          f"run_inference ({n_images / wall:.1f} captions/s, first call "
          f"included); steady batch of {B}: {serve_ms:.2f} ms "
          f"({B / serve_ms * 1e3:.1f} captions/s), encoder {enc_ms:.2f} ms,"
          f" {steps:.0f} decode steps, "
          f"{(serve_ms - enc_ms) / max(steps, 1):.3f} ms per decode step")
    busy_ms, prof_ms, top = profile_serve(serve, params, images,
                                          f"beam{beam}")
    if not top:
        print(f"beam {beam} profiled batch: the profiler recorded no "
              f"device time; device busy share not measured")
        return launches
    print(f"beam {beam} profiled batch: device busy {busy_ms:.2f} ms of "
          f"{prof_ms:.2f} ms wall ({busy_ms / prof_ms:.1%}; the profiler "
          f"adds host time); top kernels: " + "; ".join(
              f"{name[:48]} {n}x {us / 1e3:.2f} ms"
              for name, (n, us) in top))
    return launches


def card_vs_cpu(ckpt_state, cnn_name="inception_v1", size=224, **overrides):
    """float32, TF32 off, batch 2, beam 3, ``size`` x ``size`` inputs, the
    smoke config with ``overrides``: the attention memory (keys and
    values) and the top-beam ids of the card's serve and of the port's
    plain CPU path -> (the memory's max difference over its largest
    magnitude, {device: ids})."""
    import torch

    from comic_tpu_torch.data.preprocessing import preprocess_for
    from comic_tpu_torch.decoding import search
    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import (build_model_spec,
                                                  max_decode_steps, tree_to)
    from comic_tpu_torch.tokenization import Vocabulary

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = smoke_config(3, 2, "float32", cnn_name,
                          cnn_input_size=(size, size), **overrides)
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    # the host images are 256x256, or the net's own size where it is larger
    images = image_batches(1, 2, max(size, 256))[0][0]
    memory, ids = {}, {}
    for dev in ("cuda", "cpu"):
        params = tree_to(ckpt_state, torch.device(dev))
        serve = make_serve_fn(spec, config, max_decode_steps(config, vocab),
                              collect_alignments=False, device=dev)
        with torch.inference_mode():
            _, mem = search._prepare_memory(
                params, spec, preprocess_for(cnn_name)(
                    images, size, size, torch.device(dev)))
        memory[dev] = (mem.keys.cpu(), mem.values.cpu())
        ids[dev] = serve(params, images)[0].cpu()
    err = max(((got - want).abs().max() / want.abs().max()).item()
              for got, want in zip(memory["cuda"], memory["cpu"]))
    return err, ids


def agreement_phase(ckpt_state):
    """Phase 6: float32, TF32 off, batch 2: card vs plain CPU path."""
    keys_err, ids = card_vs_cpu(ckpt_state)
    same = (ids["cuda"] == ids["cpu"]).float().mean().item()
    rows = (ids["cuda"] == ids["cpu"]).all(dim=1).sum().item()
    print(f"float32 card vs CPU plain path: attention memory max rel error "
          f"{keys_err:.2e} (tol 1e-4); top-beam ids agree at {same:.1%} of "
          f"positions, {rows}/2 captions identical")
    if keys_err > 1e-4:
        raise AssertionError("card and CPU encoders disagree")


class MemoryImages:
    """The pipelines' image loader: a seeded uint8 256x256 image per record
    path, made in memory (no image files are decoded). Counts its loads."""

    def __init__(self):
        self.loads = 0

    def load(self, paths):
        import numpy as np

        self.loads += 1
        out = np.empty((len(paths), 256, 256, 3), np.uint8)
        for i, p in enumerate(paths):
            idx = int(re.search(r"(\d+)\.jpg$", p).group(1))
            out[i] = np.random.default_rng([SEED, idx]).integers(
                0, 256, (256, 256, 3), dtype=np.uint8)
        return out

    def close(self):
        pass


def caption_records(split, n, first):
    """n (path, tokens) records of 8-20 words of the smoke vocabulary, so
    at most 42 radix steps a caption."""
    import numpy as np

    rng = np.random.default_rng([SEED, first])
    return [(f"images/COCO_{split}_{first + i:012d}.jpg",
             ["<GO>"] + [f"w{w}" for w in rng.integers(
                 0, 10000, int(rng.integers(8, 21)))] + ["<EOS>"])
            for i in range(n)]


class CountedEval:
    """The eval pipeline, recording the kernels' launch counts at the start
    and end of every eval-perplexity pass (evaluate_perplexity reads only
    ``epoch()``)."""

    def __init__(self, pipe, kernels):
        self.pipe, self.kernels, self.passes = pipe, kernels, []

    def epoch(self):
        start = [k.launches for k in self.kernels]
        yield from self.pipe.epoch()
        self.passes.append([k.launches - s
                            for k, s in zip(self.kernels, start)])

    def close(self):
        self.pipe.close()


def stage_argv(stage, ckpt_path=None, cnn_name="inception_v1", name=None):
    """The training CLI's command line of the smoke's ``stage`` (the
    encoder zoo's runs are named 'zoo')."""
    name = name or ("smoke" if cnn_name == "inception_v1" else "zoo")
    argv = ["--train_mode", stage, "--name", name,
            "--cnn_name", cnn_name, "--log_root", os.path.join(OUT, "train"),
            "--dataset_dir", os.path.join(OUT, "train", "data")]
    if stage == "decoder":
        argv += ["--cnn_ckpt_path", ckpt_path]
    return argv


def train_phase(stage, steps, ckpt_path, kernels, cnn_name="inception_v1",
                tag=None, extra_argv=()):
    """Phases train-decoder / train-cnnft: the stage's config from the
    training CLI's own stage chain (comic_tpu_torch.cli.train), at
    COMIC-256 defaults (bf16, dropout, alignment dropout, augment), then
    train_fn on the card for ``steps`` steps on in-memory batches, saving
    a full and a compact checkpoint and running one eval-perplexity pass
    of 2 x 61 rows at the end. K1 and K2 must launch 0 times in the train
    steps; K2 must launch in the eval pass. A ``tag`` names the run (its
    experiment too); ``extra_argv`` adds flags to its command line. ->
    (eval launches per kernel, summary; the summary counts the gradient
    all-reduces of the run, which a torch.distributed job makes)"""
    import numpy as np
    import torch

    from comic_tpu_torch.cli.train import stage_config
    from comic_tpu_torch.data.pipeline import TrainPipeline
    from comic_tpu_torch.parallel.mesh import all_reduce_grads
    from comic_tpu_torch.tokenization import Vocabulary

    stage_fn, config = stage_config(
        stage_argv(stage, ckpt_path, cnn_name, tag) + list(extra_argv))
    tag = tag or ("zoo-train" if cnn_name != "inception_v1" else {
        "decoder": "train-decoder", "cnn_finetune": "train-cnnft"}[stage])
    vocab_cfg = smoke_config(1, B, "bfloat16")
    config.update(wtoi=vocab_cfg.wtoi, itow=vocab_cfg.itow,
                  vocab_size=len(vocab_cfg.itow))
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    n_train = TRAIN_B * DECODER_STEPS  # one epoch = the decoder phase
    train_pipe = TrainPipeline(config, vocab, "train",
                               records=caption_records("train", n_train, 0),
                               loader=MemoryImages())
    eval_pipe = CountedEval(TrainPipeline(
        config, vocab, "valid",
        records=caption_records("valid", 2 * EVAL_B, n_train),
        loader=MemoryImages()), kernels)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    reduces = all_reduce_grads.calls
    t0 = time.perf_counter()
    stage_fn(config, max_steps_override=steps, train_pipe=train_pipe,
             eval_pipe=eval_pipe)
    wall = time.perf_counter() - t0
    reduces = all_reduce_grads.calls - reduces
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    total = [k.launches for k in kernels]
    eval_launches = [sum(p[i] for p in eval_pipe.passes)
                     for i in range(len(kernels))]
    names = [k.__name__ for k in kernels]
    if len(eval_pipe.passes) != 1:
        raise AssertionError(f"{tag}: {len(eval_pipe.passes)} eval passes, "
                             "expected 1")
    train_launches = [t - e for t, e in zip(total, eval_launches)]
    if any(train_launches):
        raise AssertionError(f"{tag}: kernels launched under autograd: "
                             f"{dict(zip(names, train_launches))}")
    k2 = names.index("fused_add_ln_attention")
    if eval_launches[k2] <= 0:
        raise AssertionError(f"{tag}: K2 never launched in the eval pass")

    with open(os.path.join(config.log_path, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    logs = [e for e in events if "log_ppl" in e]
    ppl = [e["eval_perplexity"] for e in events if "eval_perplexity" in e]
    if [e["step"] for e in logs] != list(range(1, steps + 1)) or not ppl:
        raise AssertionError(f"{tag}: events.jsonl has steps "
                             f"{[e['step'] for e in logs]}, eval {ppl}")
    losses = [e["log_ppl"] for e in logs]
    if not (np.isfinite(losses).all() and np.isfinite(ppl).all()):
        raise AssertionError(f"{tag}: non-finite loss {losses} or {ppl}")
    saved = sorted(f for f in os.listdir(config.log_path)
                   if f.endswith(".msgpack"))
    if saved != [f"model-{steps}.msgpack", f"model_compact-{steps}.msgpack"]:
        raise AssertionError(f"{tag}: checkpoints {saved}")
    # the first 3 steps hold the cuDNN autotuning and allocator growth
    step_ms = [TRAIN_B / e["examples_per_sec"] * 1e3 for e in logs[3:]]
    med = statistics.median(step_ms)
    head, tail = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    print(f"{tag}: {steps} steps of batch {TRAIN_B} in {wall:.2f} s "
          f"through train_fn (restore, saves and the eval pass included); "
          f"steady steps {med:.2f} ms median ({TRAIN_B / med * 1e3:.1f} "
          f"examples/s; {min(step_ms):.2f}-{max(step_ms):.2f} ms); peak "
          f"memory {peak_gb:.2f} GiB; XE log-ppl first 3 steps {head:.4f}, "
          f"last 3 {tail:.4f}; eval perplexity {ppl[-1]:.3f} over "
          f"{2 * EVAL_B} rows; launches in the train steps "
          f"{dict(zip(names, train_launches))}, in the eval pass "
          f"{dict(zip(names, eval_launches))}")
    summary = {"head": head, "tail": tail, "losses": losses,
               "log_path": config.log_path, "step_ms": med,
               "all_reduces": reduces}
    if tag == "train-decoder":  # the program the cost model counts
        summary["train_step"] = stage_train_step(config, vocab, train_pipe)
    profile_train_step(config, vocab, train_pipe, tag)
    train_pipe.close()
    eval_pipe.close()
    return eval_launches, summary


def stage_train_step(config, vocab, train_pipe):
    """-> (step, args): ``step(*args)`` -> (state, metrics) is a train step
    of the stage on the card from its saved compact weights (learning rate
    lr_end) on one batch of ``train_pipe``; the parameters update in
    place, so each call with the same args takes one more step."""
    import torch

    from comic_tpu_torch.models.captioner import build_model_spec, init_params
    from comic_tpu_torch.training.checkpoints import load_compact
    from comic_tpu_torch.training.optimizer import Optimizer, set_trainable
    from comic_tpu_torch.training.xe import TrainState, make_train_step

    spec = build_model_spec(config, vocab)
    params = load_compact(config.log_path, init_params(spec, device="cuda"))
    opt = Optimizer(params, lambda n: float(config.lr_end),
                    adam_epsilon=config.adam_epsilon,
                    freeze_scopes=config.freeze_scopes)
    set_trainable(params, opt.mask)
    step = make_train_step(spec, config, tuple(config.cnn_input_size))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images, caps = next(iter(train_pipe))
    return ((lambda state, images, caps: step(state, images, caps, gen)),
            (TrainState(params, opt, 0), images, caps))


def profile_train_step(config, vocab, train_pipe, tag):
    """Two more train steps of the stage from its saved compact weights,
    then one under torch.profiler: device busy time against the wall and
    the top kernels (table in smoke_out/profile_<tag>.txt)."""
    step, args = stage_train_step(config, vocab, train_pipe)
    caps = args[2]

    def one(*_):
        return step(*args)[1]

    for _ in range(2):
        float(one()["total_loss"])
    busy_ms, wall_ms, top = profile_serve(one, None, None, tag)
    if not top:
        print(f"{tag} profiled step: the profiler recorded no device time")
        return
    print(f"{tag} profiled step (caption width {caps.shape[1]}): device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall ({busy_ms / wall_ms:.1%}"
          f"; the profiler adds host time); top kernels: " + "; ".join(
              f"{name[:48]} {n}x {us / 1e3:.2f} ms"
              for name, (n, us) in top))


def tree_clone(tree):
    return ({k: tree_clone(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.clone())


def worst_leaf_difference(got, want):
    """-> (largest relative difference of a leaf, against its own largest
    magnitude, and that leaf's path) over two {path: tensor} maps."""
    worst, worst_leaf = 0.0, ""
    for path, w in want.items():
        rel = ((got[path] - w).abs().max() / w.abs().max().clamp(
            min=1e-30)).item()
        if rel > worst:
            worst, worst_leaf = rel, "/".join(path)
    return worst, worst_leaf


def train_agree_phase(ckpt_state, tag="train-agree", **overrides):
    """Phase train-agree: float32, TF32 off, batch 2, full width, nothing
    frozen (the cnn_finetune stage's optimizer), dropout and augment off:
    one make_train_step step on the card and on the CPU from the same
    parameters, of the smoke config with ``overrides``. The loss and
    every updated leaf are held to TOL_TRAIN relative (a leaf against its
    own largest magnitude)."""
    import numpy as np
    import torch

    from comic_tpu_torch.data.pipeline import pad_rows
    from comic_tpu_torch.models.captioner import build_model_spec, tree_to
    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1
    from comic_tpu_torch.tokenization import Vocabulary, encode_caption_tokens
    from comic_tpu_torch.training.optimizer import (Optimizer, set_trainable,
                                                    tree_items)
    from comic_tpu_torch.training.xe import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = smoke_config(1, 2, "float32", **overrides)
    config.update(dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
                  cnn_input_augment=False, freeze_scopes="", lr_start=1e-3)
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    images = image_batches(1, 2)[0][0]
    caps = pad_rows([encode_caption_tokens(t, config.token_type, vocab,
                                           config.radix_base)
                     for _, t in caption_records("agree", 2, 0)], 42)
    kernels = (k1.grouped_add_ln_attention, k2.fused_add_ln_attention)
    out = {}
    for dev in ("cuda", "cpu"):
        # a copy: the step updates the parameters in place
        params = tree_to(tree_clone(ckpt_state), torch.device(dev))
        opt = Optimizer(params, lambda n: 1e-3, freeze_scopes="")
        set_trainable(params, opt.mask)
        step = make_train_step(spec, config, (224, 224), device=dev)
        before = [k.launches for k in kernels]
        state, metrics = step(TrainState(params, opt, 0), images, caps)
        if [k.launches for k in kernels] != before:
            raise AssertionError("a kernel launched in a train step")
        out[dev] = (metrics["total_loss"].item(),
                    {p: v.detach().cpu() for p, v in tree_items(state.params)})
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_leaf = worst_leaf_difference(out["cuda"][1], out["cpu"][1])
    print(f"{tag} (float32, TF32 off, batch 2, one step, nothing "
          f"frozen): loss card {out['cuda'][0]:.6f} vs CPU "
          f"{out['cpu'][0]:.6f}, relative difference {loss_rel:.2e} (tol "
          f"{TOL_TRAIN:.0e}); largest relative difference of the updated "
          f"parameters {worst:.2e} at {worst_leaf} (tol {TOL_TRAIN:.0e})")
    if not (loss_rel <= TOL_TRAIN and worst <= TOL_TRAIN
            and np.isfinite(out["cuda"][0])):
        raise AssertionError(f"{tag}: the card's train step disagrees "
                             "with the CPU's")


def trace_phase(ckpt_path, kernels):
    """Phase trace: the training CLI's decoder stage (batch 32, COMIC-256,
    bf16) with --profile_dir for TRACE_STEPS steps through train_fn, as
    train-decoder runs it (train_phase's checks). Its StepTracer writes one
    TensorBoard trace of the loop's calls [10, 13): exactly three
    ProfilerStep spans with CUDA kernels inside them; the device busy
    share of the traced window is read from the trace. A profiler that
    fails raises out of train_fn. -> eval launches per kernel"""
    import glob

    trace_dir = os.path.join(OUT, "trace")
    eval_launches, run = train_phase(
        "decoder", TRACE_STEPS, ckpt_path, kernels, tag="trace",
        extra_argv=["--profile_dir", trace_dir])
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} trace files in "
                             f"{trace_dir}, expected 1")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("ProfilerStep#")),
                   key=lambda e: e["ts"])
    if len(spans) != 3:
        raise AssertionError(f"trace: {len(spans)} ProfilerStep spans, "
                             "expected 3")
    t0 = spans[0]["ts"]
    t1 = max(e["ts"] + e["dur"] for e in spans)
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["cat"])
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and t0 <= e["ts"] < t1)
    n_kernels = sum(cat == "kernel" for _, _, cat in device)
    if not n_kernels:
        raise AssertionError("trace: no CUDA kernel inside the traced steps")
    busy, last = 0.0, t0  # the union of the device spans, cut at t1
    for start, end, _ in device:
        end = min(end, t1)
        if end > last:
            busy += end - max(start, last)
            last = end
    window = t1 - t0
    print(f"trace: {TRACE_STEPS} steps of the decoder stage at batch "
          f"{TRAIN_B} with --profile_dir; one trace file "
          f"({os.path.getsize(files[0]) / 2**20:.1f} MiB) holding "
          f"{len(spans)} ProfilerStep spans of "
          + ", ".join(f"{e['dur'] / 1e3:.2f}" for e in spans)
          + f" ms, {n_kernels} CUDA kernels in them; device busy "
          f"{busy / 1e3:.2f} ms of the {window / 1e3:.2f} ms window "
          f"({busy / window:.1%}); the run's steady steps "
          f"{run['step_ms']:.2f} ms median (train_fn's log, traced steps "
          "included)")
    return eval_launches


def cost_model_phase(ckpt_path, state, train_step, kernels, smi):
    """Phase cost-model: count two full-width programs (COMIC-256, bf16)
    with comic_tpu_torch.utils.roofline.count_costs, each in a call apart
    from the timed ones, and derive utilization_fields from the measured
    ms of the same program uncounted: a steady serve-beam3 batch (B
    images, beam 3, 60 fixed steps, K1 on every step) and one
    train-decoder step at batch 32 (train_step: the stage's own). Then
    agreement_phase's serve (batch 2, beam 3, float32, 60 fixed steps)
    counted on the card, where K1 runs, and on the CPU, where the torch
    ops run: every field equal. -> launches per kernel"""
    import torch

    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import (
        build_model_spec,
        init_params,
        max_decode_steps,
        tree_to,
    )
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import load_compact
    from comic_tpu_torch.utils.roofline import (
        H100_SXM_HBM_BYTES_PER_S,
        H100_SXM_PEAK_BF16_FLOPS,
        add_ln_attention_cost,
        count_costs,
        utilization_fields,
    )

    k1 = kernels[0]
    start = [k.launches for k in kernels]

    def serve_fn(batch, dtype, device):
        config = smoke_config(3, batch, dtype)
        config.update(infer_early_exit=False)
        vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
        spec = build_model_spec(config, vocab)
        steps = max_decode_steps(config, vocab)
        return spec, steps, make_serve_fn(spec, config, steps,
                                          collect_alignments=False,
                                          device=device)

    def report(tag, cost, ms, items, what):
        fields = utilization_fields(cost, ms, per_call_items=items)
        t = ms / 1e3
        print(f"cost-model {tag} ({what}): {ms:.2f} ms uncounted; "
              f"gflops {cost.mxu_flops / 1e9:.3f}, mfu "
              f"{cost.mxu_flops / t / H100_SXM_PEAK_BF16_FLOPS:.6f}, "
              f"hbm_gb_lower {cost.bytes_lower / 1e9:.4f}, hbm_util_lower "
              f"{cost.bytes_lower / t / H100_SXM_HBM_BYTES_PER_S:.6f} "
              f"against the H100 SXM's BF16 tensor-core and HBM3 peaks; "
              f"{smi}; utilization_fields {json.dumps(fields)}")
        return fields

    # serve-beam3: the steady batch of serve_phase with a fixed loop
    spec, steps, serve = serve_fn(B, "bfloat16", "cuda")
    params = load_compact(ckpt_path, init_params(spec, device="cuda"))
    images = image_batches(1, B)[0][0]
    serve(params, images)  # the first call's set-up is not a steady batch
    before = k1.launches
    cost = count_costs(serve, params, images)
    counted = k1.launches - before
    per_step = add_ln_attention_cost(
        torch.empty((B, K, U), device="meta"),
        torch.empty((B, L, U), dtype=torch.bfloat16, device="meta"), H)
    if counted != steps or cost.by_primitive.get(k1.__name__) != \
            steps * per_step.matmul_flops:
        raise AssertionError(
            f"cost-model: K1 launched {counted} times in a {steps}-step "
            f"serve, counted {cost.by_primitive.get(k1.__name__)} flops")
    ms = median_ms(lambda: serve(params, images), iters=5, warmup=1)
    serve_fields = report("serve-beam3", cost, ms, B,
                          f"batch {B}, beam 3, {steps} fixed steps, bf16; "
                          f"K1 {counted} launches in the counted call")

    # train-decoder: one step of the stage at batch 32
    step, args = train_step
    for _ in range(2):
        float(step(*args)[1]["total_loss"])
    before = [k.launches for k in kernels]
    cost = count_costs(step, *args)
    if [k.launches for k in kernels] != before:
        raise AssertionError("cost-model: a kernel launched in a train step")
    ms = median_ms(lambda: step(*args), iters=10, warmup=2)
    train_fields = report("train-decoder", cost, ms, TRAIN_B,
                          f"batch {TRAIN_B}, the decoder stage's step with "
                          "its backward and Adam update")

    # the count does not depend on the route: the card (K1) vs the CPU
    images = image_batches(1, 2)[0][0]
    counts = {}
    for dev in ("cuda", "cpu"):
        _, steps, serve = serve_fn(2, "float32", dev)
        before = k1.launches
        counts[dev] = count_costs(serve, tree_to(state, torch.device(dev)),
                                  images)
        if k1.launches - before != (steps if dev == "cuda" else 0):
            raise AssertionError(f"cost-model: K1 launched "
                                 f"{k1.launches - before} times on {dev}")
    fields = ("matmul_flops", "conv_flops", "vpu_elems", "bytes_lower",
              "bytes_upper", "by_primitive")
    differ = [f for f in fields if getattr(counts["cuda"], f)
              != getattr(counts["cpu"], f)]
    if differ:
        raise AssertionError(
            "cost-model: the card's count differs from the CPU's in "
            + "; ".join(f"{f}: {getattr(counts['cuda'], f)} against "
                        f"{getattr(counts['cpu'], f)}" for f in differ))
    c = counts["cuda"]
    print(f"cost-model card vs CPU (batch 2, beam 3, float32, {steps} fixed "
          f"steps): every field equal (matmul {c.matmul_flops:.0f}, conv "
          f"{c.conv_flops:.0f} flops, {c.vpu_elems:.0f} elements, bytes "
          f"{c.bytes_lower:.0f} to {c.bytes_upper:.0f}, "
          f"{len(c.by_primitive)} operations by name)")
    print("cost-model: " + json.dumps({"serve-beam3": serve_fields,
                                        "train-decoder": train_fields}))
    return [k.launches - s for k, s in zip(kernels, start)]


def scst_records(n_images):
    """n_images SCST records (image path, SCST_REFS reference strings of
    8-20 words of the smoke vocabulary)."""
    caps = caption_records("scst", n_images * SCST_REFS, 0)
    return [(f"images/COCO_scst_{i:012d}.jpg",
             [" ".join(toks[1:-1]) for _, toks in
              caps[i * SCST_REFS: (i + 1) * SCST_REFS]])
            for i in range(n_images)]


class ScstProbe:
    """Records what train_fn_scst's building blocks do, call by call: the
    kernels' launches in each rollout and each train step, each train
    step's metrics and end time, the rewards and scores of each scored
    batch and the scorer's CIDEr-D implementation. train_fn_scst looks the blocks up as
    attributes of comic_tpu_torch.training.scst when it runs, so the probe
    wraps those attributes for the length of a ``with`` block."""

    BLOCKS = ("make_rollout", "make_scst_train_step", "host_score_shard")

    def __init__(self, kernels):
        from comic_tpu_torch.training import scst

        self.scst, self.kernels = scst, kernels
        self.rollouts, self.steps, self.metrics, self.ends = [], [], [], []
        self.rewards, self.scores, self.impls = [], [], set()

    def _counted(self, fn, into):
        def call(*args, **kwargs):
            before = [k.launches for k in self.kernels]
            out = fn(*args, **kwargs)
            into.append([k.launches - b for k, b in zip(self.kernels, before)])
            return out
        return call

    def __enter__(self):
        self.saved = {n: getattr(self.scst, n) for n in self.BLOCKS}
        make_rollout, make_step, score = (self.saved[n] for n in self.BLOCKS)

        def probed_rollout(*args, **kwargs):
            return self._counted(make_rollout(*args, **kwargs), self.rollouts)

        def probed_step(*args, **kwargs):
            step = self._counted(make_step(*args, **kwargs), self.steps)

            def call(*a, **kw):
                state, metrics = step(*a, **kw)
                self.metrics.append({k: float(v) for k, v in metrics.items()})
                self.ends.append(time.perf_counter())
                return state, metrics
            return call

        def probed_score(greedy_ids, beam_ids, refs, scorer, *args):
            self.impls.add(scorer.ciderd_impl)
            out = score(greedy_ids, beam_ids, refs, scorer, *args)
            self.rewards.append(out[1])
            self.scores.append(out[2])
            return out

        self.scst.make_rollout = probed_rollout
        self.scst.make_scst_train_step = probed_step
        self.scst.host_score_shard = probed_score
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.scst, name, fn)


def train_scst_phase(kernels):
    """Phase train-scst: the training CLI's scst stage (its overrides:
    batch 10, beam 7, lr 1e-3, the CNN frozen, CIDEr-D 1 and BLEU-4 2) from
    the cnn_finetune stage's directory, through train_fn_scst for
    SCST_STEPS steps on in-memory batches, with an IDF cache of the
    references in the dataset directory. K1 and K2 must launch in every
    rollout and never in a train step; losses and rewards finite; the
    checkpoints at the last step only; the CIDEr-D scorer native. Then the
    step's three parts timed apart from the saved weights, also at the
    caps, and one rollout and one train step profiled. -> launches per
    kernel in the train_fn_scst run"""
    import numpy as np
    import torch

    from comic_tpu_torch.cli.train import stage_config
    from comic_tpu_torch.data.pipeline import ScstPipeline
    from comic_tpu_torch.evaluation import (CaptionScorer, build_idf_cache,
                                            save_idf_cache)
    from comic_tpu_torch.models.captioner import build_model_spec, init_params
    from comic_tpu_torch.tokenization import (Vocabulary,
                                              caption_strings_to_batched_ids)
    from comic_tpu_torch.training import scst
    from comic_tpu_torch.training.checkpoints import load_compact
    from comic_tpu_torch.training.optimizer import Optimizer, set_trainable
    from comic_tpu_torch.training.xe import TrainState

    tag = "train-scst"
    data_dir = os.path.join(OUT, "train", "data")
    stage_fn, config = stage_config([
        "--train_mode", "scst", "--name", "smoke",
        "--log_root", os.path.join(OUT, "train"), "--dataset_dir", data_dir])
    if stage_fn is not scst.train_fn_scst or (
            config.batch_size_train, config.scst_beam_size) != (SCST_B,
                                                                SCST_K):
        raise AssertionError(f"{tag}: the CLI's scst stage is {stage_fn} at "
                             f"batch {config.batch_size_train}, beam "
                             f"{config.scst_beam_size}")
    vocab_cfg = smoke_config(1, B, "bfloat16")
    config.update(wtoi=vocab_cfg.wtoi, itow=vocab_cfg.itow,
                  vocab_size=len(vocab_cfg.itow))
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    # one batch more than the steps: an epoch, the checkpoint cadence, then
    # ends after the last step, so only the closing save writes
    records = scst_records(SCST_B * (SCST_STEPS + 1))
    idf_path = os.path.join(
        data_dir, "captions",
        config.dataset_file_pattern.format("scst-words") + ".p")
    os.makedirs(os.path.dirname(idf_path), exist_ok=True)
    save_idf_cache(idf_path, build_idf_cache([r for _, r in records]))
    if scst._scst_idf_path(config) != idf_path:
        raise AssertionError(f"{tag}: train_fn_scst does not find {idf_path}")
    pipe = ScstPipeline(config, vocab, records=records, loader=MemoryImages())

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ScstProbe(kernels) as probe:
        stage_fn(config, max_steps_override=SCST_STEPS, pipe=pipe)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = [k.launches for k in kernels]
    names = [k.__name__ for k in kernels]

    if not (len(probe.rollouts) == len(probe.steps) == len(probe.rewards)
            == SCST_STEPS):
        raise AssertionError(f"{tag}: {len(probe.rollouts)} rollouts, "
                             f"{len(probe.steps)} train steps, expected "
                             f"{SCST_STEPS} each")
    if not all(all(n > 0 for n in r) for r in probe.rollouts):
        raise AssertionError(f"{tag}: a rollout did not launch both kernels: "
                             f"{probe.rollouts}")
    if any(any(s) for s in probe.steps):
        raise AssertionError(f"{tag}: kernels launched in a train step: "
                             f"{probe.steps}")
    if launches != [sum(r[i] for r in probe.rollouts)
                    for i in range(len(kernels))]:
        raise AssertionError(f"{tag}: launches outside the rollouts: "
                             f"{launches} in all, {probe.rollouts}")
    rewards = np.concatenate(probe.rewards)
    losses = [m["total_loss"] for m in probe.metrics]
    if not (np.isfinite(rewards).all() and np.isfinite(
            [v for m in probe.metrics for v in m.values()]).all()):
        raise AssertionError(f"{tag}: non-finite losses {losses} or rewards")
    if rewards.shape != (SCST_STEPS * SCST_B * SCST_K,):
        raise AssertionError(f"{tag}: rewards of shape {rewards.shape}")
    if probe.impls != {"native"}:
        raise AssertionError(f"{tag}: CIDEr-D ran as {probe.impls}, not "
                             "the native scorer")
    saved = sorted(f for f in os.listdir(config.log_path)
                   if f.endswith(".msgpack"))
    if saved != [f"model-{SCST_STEPS}.msgpack",
                 f"model_compact-{SCST_STEPS}.msgpack"]:
        raise AssertionError(f"{tag}: checkpoints {saved}")
    # a step's time: from the end of one train step to the end of the next
    # (the next rollout, the scoring and the train step); steps 4 on
    step_ms = [(b - a) * 1e3 for a, b in zip(probe.ends[2:], probe.ends[3:])]
    med = statistics.median(step_ms)
    per_rollout = {n: sorted({r[i] for r in probe.rollouts})
                   for i, n in enumerate(names)}
    scores = [m["score_sample"] for m in probe.scores]
    print(f"{tag}: {SCST_STEPS} steps of {SCST_B} images x beam {SCST_K} in "
          f"{wall:.2f} s through train_fn_scst (restore and save included); "
          f"steady steps {med:.2f} ms median ({SCST_B / med * 1e3:.1f} "
          f"images/s; {min(step_ms):.2f}-{max(step_ms):.2f} ms); peak memory "
          f"{peak_gb:.2f} GiB; mean reward {rewards.mean():.6f} "
          f"({int((rewards != 0).sum())} of {rewards.size} nonzero), mean "
          f"sample score first step {scores[0]:.6f}, last {scores[-1]:.6f}; "
          f"total loss first {losses[0]:.6f}, last {losses[-1]:.6f}; CIDEr-D "
          f"{probe.impls.pop()}; launches per rollout {per_rollout}, in the "
          f"train steps 0")

    # the three parts of a step, each closed by a synchronize, from the
    # saved weights on the run's first batch
    spec = build_model_spec(config, vocab)
    params = load_compact(config.log_path, init_params(spec, device="cuda"))
    opt = Optimizer(params, lambda n: float(config.lr_end),
                    adam_epsilon=config.adam_epsilon,
                    freeze_scopes=config.freeze_scopes)
    set_trainable(params, opt.mask)
    rollout = scst.make_rollout(spec, config, vocab, "cuda")
    train_step = scst.make_scst_train_step(spec, config, "cuda")
    scorer = CaptionScorer(idf_path, {
        "ciderD": float(config.scst_weight_ciderD),
        "bleu": list(config.scst_weight_bleu)})
    width = scst.hypo_width(config, vocab)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = MemoryImages().load([p for p, _ in records[:SCST_B]])
    refs = [r for _, r in records[:SCST_B]]
    state = [TrainState(params, opt, 0)]

    def timed(fn, reps=7):
        """-> (fn's last result, median ms of the calls after the first 2)"""
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return res, statistics.median(ms[2:])

    def one_step(hypo_ids, step_rewards):
        state[0], _ = train_step(state[0], out[2], out[3], hypo_ids,
                                 step_rewards, gen)

    out, roll_ms = timed(lambda: rollout(params, images, gen))
    (hypo, rew, _), score_ms = timed(lambda: scst.host_score_shard(
        out[0], out[1], refs, scorer, config, vocab, width))
    _, step_ms = timed(lambda: one_step(hypo, rew))
    # the same parts at the caps, as for weights whose captions run longer
    # than these: both decodes without early exit (40 radix steps each; the
    # ids are the same), and the train step on 70 hypotheses of the
    # references' lengths (8-20 words, up to 42 tokens)
    decodes = {n: getattr(scst, n) for n in ("greedy_or_sample_from_memory",
                                             "beam_search_from_memory")}
    before = [k.launches for k in kernels]
    try:
        for n, fn in decodes.items():
            setattr(scst, n, lambda *a, fn=fn, **kw: fn(
                *a, **dict(kw, early_exit=False)))
        _, cap_roll_ms = timed(lambda: rollout(params, images, gen))
    finally:
        for n, fn in decodes.items():
            setattr(scst, n, fn)
    cap_launches = [(k.launches - b) // 7 for k, b in zip(kernels, before)]
    long_hypo = caption_strings_to_batched_ids(
        [refs[i][k % SCST_REFS] for i in range(SCST_B) for k in range(SCST_K)],
        "radix", vocab, config.radix_base)
    long_rew = np.random.default_rng(SEED).normal(
        size=SCST_B * SCST_K).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    _, cap_step_ms = timed(lambda: one_step(long_hypo, long_rew))
    cap_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"{tag} split (each part alone, median of 5 calls after 2, closed "
          f"by a synchronize): rollout {roll_ms:.2f} ms, host scoring "
          f"{score_ms:.2f} ms, train step {step_ms:.2f} ms (hypotheses of up "
          f"to {int((hypo[:, 1:] != -1).sum(1).max())} tokens), sum "
          f"{roll_ms + score_ms + step_ms:.2f} ms; at the caps: rollout "
          f"{cap_roll_ms:.2f} ms ({dict(zip(names, cap_launches))} launches "
          f"a rollout), train step {cap_step_ms:.2f} ms on hypotheses of up "
          f"to {long_hypo.shape[1] - 1} tokens (peak memory "
          f"{cap_peak_gb:.2f} GiB)")

    for part, fn in (("rollout", lambda *_: rollout(params, images, gen)),
                     ("step", lambda *_: one_step(hypo, rew))):
        busy_ms, wall_ms, top = profile_serve(fn, None, None,
                                              f"{tag}-{part}")
        if not top:
            print(f"{tag} profiled {part}: the profiler recorded no device "
                  "time")
            continue
        print(f"{tag} profiled {part}: device busy {busy_ms:.2f} ms of "
              f"{wall_ms:.2f} ms wall ({busy_ms / wall_ms:.1%}; the profiler "
              f"adds host time); top kernels: " + "; ".join(
                  f"{name[:48]} {n}x {us / 1e3:.2f} ms"
                  for name, (n, us) in top))
    pipe.close()
    return launches


def scst_agree_phase(ckpt_state):
    """Phase scst-agree: one SCST step at batch 2, beam 7, full width,
    float32, TF32 off, dropout and augment off, the CNN frozen, on the card
    and on the CPU from the same parameters and images. The references of
    each image are two of its beam hypotheses on the CPU and one unrelated
    caption, so the rewards spread both ways. Greedy and all-beam ids and
    the rewards must be equal, the loss and every updated leaf within
    TOL_TRAIN relative; on the card K1 and K2 launch in the rollout and
    not in the train step."""
    import numpy as np
    import torch

    from comic_tpu_torch.evaluation import CaptionScorer
    from comic_tpu_torch.models.captioner import build_model_spec, tree_to
    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1
    from comic_tpu_torch.tokenization import Vocabulary, ids_to_captions
    from comic_tpu_torch.training import scst
    from comic_tpu_torch.training.optimizer import (Optimizer, set_trainable,
                                                    tree_items)
    from comic_tpu_torch.training.xe import TrainState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = smoke_config(1, 2, "float32")
    config.update(dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
                  cnn_input_augment=False, freeze_scopes="encoder/cnn",
                  batch_size_train=2, scst_beam_size=SCST_K)
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    width = scst.hypo_width(config, vocab)
    images = image_batches(1, 2)[0][0]
    kernels = (k1.grouped_add_ln_attention, k2.fused_add_ln_attention)
    scorer = CaptionScorer(None, {"ciderD": 1.0, "bleu": [0.0, 0.0, 0.0, 2.0]})
    refs, out = None, {}
    for dev in ("cpu", "cuda"):  # the CPU's hypotheses make the references
        params = tree_to(tree_clone(ckpt_state), torch.device(dev))
        opt = Optimizer(params, lambda n: 1e-3, freeze_scopes="encoder/cnn")
        set_trainable(params, opt.mask)
        before = [k.launches for k in kernels]
        greedy, beams, im_embed, fmaps = scst.make_rollout(
            spec, config, vocab, dev)(params, images)
        rolled = [k.launches - b for k, b in zip(kernels, before)]
        if refs is None:
            caps = ids_to_captions(beams.reshape(-1, beams.shape[-1]).numpy(),
                                   "radix", vocab, 256)
            other = scst_records(1)[0][1][0]
            refs = [[caps[1 * 2 + i], caps[4 * 2 + i], other]
                    for i in range(2)]
        hypo, rewards, _ = scst.host_score_shard(greedy, beams, refs, scorer,
                                                 config, vocab, width)
        before = [k.launches for k in kernels]
        state, metrics = scst.make_scst_train_step(spec, config, dev)(
            TrainState(params, opt, 0), im_embed, fmaps, hypo, rewards)
        stepped = [k.launches - b for k, b in zip(kernels, before)]
        if dev == "cuda" and not (all(rolled) and not any(stepped)):
            raise AssertionError(f"scst-agree: launches in the rollout "
                                 f"{rolled}, in the train step {stepped}")
        out[dev] = (greedy.cpu(), beams.cpu(), rewards,
                    metrics["total_loss"].item(),
                    {p: v.detach().cpu() for p, v in tree_items(state.params)})
    (g_gpu, b_gpu, r_gpu, l_gpu, p_gpu), (g_cpu, b_cpu, r_cpu, l_cpu, p_cpu) \
        = out["cuda"], out["cpu"]
    ids_equal = torch.equal(g_gpu, g_cpu) and torch.equal(b_gpu, b_cpu)
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    worst, worst_leaf = worst_leaf_difference(p_gpu, p_cpu)
    print(f"scst-agree (float32, TF32 off, batch 2, beam {SCST_K}, one "
          f"step): greedy and all-beam ids {'equal' if ids_equal else 'DIFFER'}"
          f" ({tuple(b_cpu.shape)}); rewards {np.array2string(r_cpu, precision=4)}"
          f" {'equal' if np.array_equal(r_gpu, r_cpu) else 'DIFFER'}; loss "
          f"card {l_gpu:.6f} vs CPU {l_cpu:.6f}, relative difference "
          f"{loss_rel:.2e} (tol {TOL_TRAIN:.0e}); largest relative "
          f"difference of the updated parameters {worst:.2e} at {worst_leaf}"
          f" (tol {TOL_TRAIN:.0e})")
    if not (ids_equal and np.array_equal(r_gpu, r_cpu)):
        raise AssertionError("scst-agree: the card's rollout or rewards "
                             "differ from the CPU's")
    if not (np.abs(r_cpu).max() > 0 and loss_rel <= TOL_TRAIN
            and worst <= TOL_TRAIN and np.isfinite(l_gpu)):
        raise AssertionError("scst-agree: the card's SCST step disagrees "
                             "with the CPU's")


class InferImages:
    """Within a ``with`` block, every InferencePipeline reads in-memory
    images (``make_loader()``, MemoryImages by default) in place of image
    files (it builds its loader from the pipeline module's
    ``_ImageLoaderPool`` when it is constructed). ``loaders`` holds each
    loader built."""

    def __init__(self, make_loader=None):
        self.make_loader = make_loader or MemoryImages

    def __enter__(self):
        from comic_tpu_torch.data import pipeline

        self.pipeline, self.saved = pipeline, pipeline._ImageLoaderPool
        self.loaders = []

        def build(*_, **__):
            self.loaders.append(self.make_loader())
            return self.loaders[-1]

        pipeline._ImageLoaderPool = build
        return self

    def __exit__(self, *exc):
        self.pipeline._ImageLoaderPool = self.saved


class SweepProbe:
    """Records what sweep_checkpoints does, checkpoint by checkpoint: the
    kernels' launches, the seconds in run_inference (the decode on the
    card, closed by the host copy of the last batch's ids) and in
    evaluate_captions (host scoring), the infer batch, and the peak device
    memory after the checkpoint. The sweep looks these functions up as
    attributes of comic_tpu_torch.inference when it runs, so the probe
    wraps those attributes for the length of a ``with`` block."""

    BLOCKS = ("run_inference", "evaluate_captions", "evaluate_model")

    def __init__(self, kernels):
        from comic_tpu_torch import inference

        self.inference, self.kernels = inference, kernels
        self.checkpoints = []

    def __enter__(self):
        import torch

        self.saved = {n: getattr(self.inference, n) for n in self.BLOCKS}
        run, score, evaluate = (self.saved[n] for n in self.BLOCKS)

        def timed(fn, key):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.current[key] += time.perf_counter() - t0
                return out
            return call

        def probed_run(config, *args, **kwargs):
            self.current["batch"] = config.batch_size_infer
            return timed(run, "decode_s")(config, *args, **kwargs)

        def probed_evaluate(config, ckpt_path, *args, **kwargs):
            self.current = {"name": os.path.basename(ckpt_path),
                            "decode_s": 0.0, "score_s": 0.0, "batch": None}
            before = [k.launches for k in self.kernels]
            out = evaluate(config, ckpt_path, *args, **kwargs)
            self.current["launches"] = [k.launches - b for k, b in
                                        zip(self.kernels, before)]
            self.current["peak_bytes"] = torch.cuda.max_memory_allocated()
            self.checkpoints.append(self.current)
            return out

        self.inference.run_inference = probed_run
        self.inference.evaluate_captions = timed(score, "score_s")
        self.inference.evaluate_model = probed_evaluate
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.inference, name, fn)


def eval_dataset(root):
    """The eval phases' dataset and annotations under ``root``: the test
    split's file list (EVAL_TEST_N names, ids 1 on), the COCO server
    split's directory (EVAL_COCO_N empty files under val2014/, ids 1001
    on; the images come from MemoryImages), and a COCO annotations JSON of
    EVAL_REFS references of 8-20 random words for every image. -> the
    annotations' path"""
    import numpy as np

    os.makedirs(os.path.join(root, "captions"), exist_ok=True)
    os.makedirs(os.path.join(root, "val2014"), exist_ok=True)
    test_ids = range(1, EVAL_TEST_N + 1)
    coco_ids = range(1001, 1001 + EVAL_COCO_N)
    with open(os.path.join(root, "captions", "filenames_test.txt"), "w") as f:
        f.write("\n".join(f"images/COCO_test_{i:012d}.jpg" for i in test_ids))
    for i in coco_ids:
        open(os.path.join(root, "val2014", f"COCO_val2014_{i:012d}.jpg"),
             "w").close()
    rng = np.random.default_rng([SEED, 5])
    anns = [{"image_id": i, "caption": " ".join(
        f"w{w}" for w in rng.integers(0, 10000, int(rng.integers(8, 21))))}
        for i in list(test_ids) + list(coco_ids) for _ in range(EVAL_REFS)]
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"annotations": anns}, f)
    return path


def read_score_rows(save_dir):
    """metric_scores.txt -> [{column: value}] of its rows, under the
    header above each."""
    rows, header = [], None
    with open(os.path.join(save_dir, "metric_scores.txt")) as f:
        for line in f:
            cells = line.rstrip("\n").split("\t")
            if cells[0] == "checkpoint":
                header = cells
            else:
                rows.append(dict(zip(header, cells)))
    return rows


def eval_sweep_phase(kernels, ckpt_paths):
    """Phase eval-sweep: the infer CLI (comic_tpu_torch.cli.infer.main) on
    one experiment directory (config.pkl at COMIC-256 defaults, bf16, the
    compact checkpoints ``ckpt_paths``) over in-memory images: (a) the test
    split at beam 3, (b) the COCO server split at beam 3 (batch forced to
    61), (c) the test split greedy, (d) (a) again scoring the existing
    caption JSONs only. Each call must launch its kernel (K1 in a and b, K2
    in c, none in d), build one pipeline, write a caption JSON of every
    image per checkpoint and finite scores, and keep its peak device
    memory flat from the first checkpoint to the last; (d)'s scores must
    equal (a)'s. -> launches per kernel per call"""
    import numpy as np
    import torch

    from comic_tpu_torch.cli import infer
    from comic_tpu_torch.inference import infer_dir_name

    root = os.path.join(OUT, "eval")
    data, exp = os.path.join(root, "data"), os.path.join(root, "exp")
    ann = eval_dataset(data)
    smoke_config(3, B, "bfloat16").save(exp)
    for i, path in enumerate(ckpt_paths, 1):
        shutil.copy(path, os.path.join(exp, f"model_compact-{i}.msgpack"))
    names = [f"model_compact-{i}" for i in range(1, len(ckpt_paths) + 1)]
    java = shutil.which("java")
    print("eval-sweep metrics: Bleu_1-4, ROUGE_L and CIDEr (CIDEr-D) on the "
          "host; METEOR and SPICE " + (
              "skipped: no jar_dir given (they need meteor-1.5.jar and "
              "spice-1.0.jar)" if java else
              "skipped: no java on PATH (they need Java and the jars in "
              "--jar_dir)") + "; PTB tokenization through the Python "
          "fallback (no CoreNLP jar)")
    base = ["--infer_checkpoints_dir", exp, "--dataset_dir", data,
            "--annotations_file", ann]
    calls = (("test_beam3", [], EVAL_TEST_N, B, 0),
             ("coco_valid_beam3", ["--infer_set", "coco_valid"], EVAL_COCO_N,
              COCO_B, 0),
             ("test_greedy", ["--infer_beam_size", "1"], EVAL_TEST_N, B, 1),
             ("test_beam3_scores_only", ["--run_inference", ""], EVAL_TEST_N,
              None, None))
    launches, results = {}, {}
    knames = [k.__name__ for k in kernels]
    for tag, extra, n_images, batch, kernel in calls:
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with InferImages() as images, SweepProbe(kernels) as probe:
            results[tag] = infer.main(base + extra)
        wall = time.perf_counter() - t0
        launches[tag] = [k.launches for k in kernels]
        cks = probe.checkpoints
        if [c["name"] for c in cks] != names or list(results[tag]) != names:
            raise AssertionError(f"eval-sweep {tag}: evaluated "
                                 f"{[c['name'] for c in cks]}, scored "
                                 f"{list(results[tag])}, expected {names}")
        decoded = kernel is not None
        if decoded:
            if len(images.loaders) != 1 or batch != cks[0]["batch"]:
                raise AssertionError(
                    f"eval-sweep {tag}: {len(images.loaders)} pipelines, "
                    f"batch {cks[0]['batch']}; expected one, batch {batch}")
            if images.loaders[0].loads != len(names) * n_images // batch:
                raise AssertionError(
                    f"eval-sweep {tag}: {images.loaders[0].loads} batches "
                    f"loaded, expected {len(names) * n_images // batch}")
            if not all(c["launches"][kernel] > 0 for c in cks):
                raise AssertionError(
                    f"eval-sweep {tag}: {knames[kernel]} did not launch for "
                    f"every checkpoint: {[c['launches'] for c in cks]}")
            grow = cks[-1]["peak_bytes"] - cks[0]["peak_bytes"]
            if grow > SWEEP_MEMORY_SLACK:
                raise AssertionError(
                    f"eval-sweep {tag}: peak device memory grew {grow} B "
                    f"from the first checkpoint to the last")
        elif any(launches[tag]) or images.loaders:
            raise AssertionError(f"eval-sweep {tag}: the scores-only call "
                                 f"decoded: {launches[tag]}, "
                                 f"{len(images.loaders)} pipelines")
        infer_set = "coco_valid" if "coco" in tag else "test"
        save_dir = os.path.join(exp, infer_dir_name(smoke_config(
            1 if kernel == 1 else 3, B, "bfloat16").update(
                infer_set=infer_set)))
        for name in names:
            with open(os.path.join(save_dir, f"captions___{name}.json")) as f:
                caps = json.load(f)
            if len(caps) != n_images or len({c["image_id"] for c in caps}) \
                    != n_images:
                raise AssertionError(f"eval-sweep {tag}: {name}'s caption "
                                     f"JSON has {len(caps)} entries")
        rows = read_score_rows(save_dir)[-len(names):]
        metrics = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L", "CIDEr"]
        if [r["checkpoint"] for r in rows] != names or not all(
                np.isfinite(float(r[m])) for r in rows for m in metrics) \
                or not all(np.isfinite(results[tag][n][m])
                           for n in names for m in metrics):
            raise AssertionError(f"eval-sweep {tag}: score rows {rows}")
        with open(os.path.join(save_dir, "metric_scores.csv")) as f:
            csv_rows = [ln for ln in f.read().splitlines()
                        if not ln.startswith("checkpoint")]
        detailed = [f for f in os.listdir(save_dir)
                    if f.startswith("metric_scores_detailed_")]
        if len(csv_rows) != len(rows) * (2 if tag.endswith("only") else 1) \
                or len(detailed) != len(csv_rows):
            raise AssertionError(f"eval-sweep {tag}: {len(csv_rows)} csv rows"
                                 f", {len(detailed)} detailed JSONs")
        per_ckpt = "; ".join(
            f"{c['name']} decode {c['decode_s']:.3f} s, scoring "
            f"{c['score_s']:.3f} s, peak memory "
            f"{c['peak_bytes'] / 2**20:.1f} MiB" for c in cks)
        print(f"eval-sweep {tag}: {len(names)} checkpoints x {n_images} "
              f"images in {wall:.2f} s through cli.infer.main "
              f"({len(names) * n_images / wall:.1f} captions/s, the first "
              f"call included){f', batch {batch}' if decoded else ''}; "
              f"launches {dict(zip(knames, launches[tag]))}; {per_ckpt}; "
              "scores " + "; ".join(
                  f"{n}: " + " ".join(f"{m}={results[tag][n][m]:.6f}"
                                      for m in metrics) for n in names))
    if results["test_beam3_scores_only"] != results["test_beam3"]:
        raise AssertionError("eval-sweep: the scores-only call's scores "
                             "differ from the first call's")
    return launches


def eval_agree_phase(ckpt_path):
    """Phase eval-agree: sweep_checkpoints over one checkpoint (the smoke
    weights) at batch 2, beam 3, float32, TF32 off, on 4 in-memory images,
    on the card and on the CPU: the caption JSON and metric_scores.txt
    must be byte-identical, and the card's sweep must launch K1."""
    import torch

    from comic_tpu_torch.inference import infer_dir_name, sweep_checkpoints
    from comic_tpu_torch.ops import grouped_attention as k1

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(OUT, "eval-agree")
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "captions"))
    with open(os.path.join(data, "captions", "filenames_test.txt"), "w") as f:
        f.write("\n".join(f"images/COCO_test_{i:012d}.jpg"
                          for i in range(1, 5)))
    ann = os.path.join(OUT, "eval", "data", "annotations.json")
    out = {}
    for dev in ("cuda", "cpu"):
        config = smoke_config(3, 2, "float32")
        config.update(log_path=os.path.join(root, dev), dataset_dir=data)
        os.makedirs(config.log_path)
        shutil.copy(ckpt_path, os.path.join(config.log_path,
                                            "model_compact-1.msgpack"))
        before = k1.grouped_add_ln_attention.launches
        t0 = time.perf_counter()
        with InferImages():
            scores = sweep_checkpoints(config, ann, device=dev)
        wall = time.perf_counter() - t0
        save_dir = os.path.join(config.log_path, infer_dir_name(config))
        files = []
        for name in ("captions___model_compact-1.json", "metric_scores.txt"):
            with open(os.path.join(save_dir, name), "rb") as f:
                files.append(f.read())
        out[dev] = (files, scores,
                    k1.grouped_add_ln_attention.launches - before, wall)
    same = out["cuda"][0] == out["cpu"][0]
    print(f"eval-agree (float32, TF32 off, batch 2, beam 3, 4 images): "
          f"caption JSON and metric_scores.txt card vs CPU "
          f"{'byte-identical' if same else 'DIFFER'}; K1 launched "
          f"{out['cuda'][2]} times on the card; {out['cuda'][3]:.2f} s on "
          f"the card, {out['cpu'][3]:.2f} s on the CPU; CIDEr "
          f"{out['cuda'][1]['model_compact-1']['CIDEr']:.6f}")
    if not (same and out["cuda"][1] == out["cpu"][1] and out["cuda"][2] > 0):
        raise AssertionError("eval-agree: the card's sweep differs from the "
                             "CPU's")


class FixtureImages:
    """The pipelines' image loader for the overfit gate: the synthetic
    fixture's own arrays, looked up by the file name of each path the
    pipeline asks for (no JPEG is written or decoded). Counts its loads."""

    def __init__(self, images):
        self.images = {os.path.basename(k): v for k, v in images.items()}
        self.loads = 0

    def load(self, paths):
        import numpy as np

        self.loads += 1
        return np.stack([self.images[os.path.basename(p)] for p in paths])

    def close(self):
        pass


def gate_cnn_checkpoint(path):
    """The decoder stage's pretrained CNN, made as a user makes it from a
    slim ImageNet checkpoint, minus the TF file reader: the smoke weights'
    Inception-V1 under slim names (with the classifier head a slim release
    carries), through slim_reader_to_tree and convert_slim_tree onto the
    port's encoder template, saved by save_cnn_checkpoint. -> the CNN tree
    in comic_tpu's layout"""
    import numpy as np
    import torch

    from comic_tpu_torch import params as bridge
    from comic_tpu_torch.models.captioner import build_model_spec
    from comic_tpu_torch.models.encoders import get_encoder
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import save_cnn_checkpoint
    from comic_tpu_torch.utils import tf_checkpoint as tfc

    config = smoke_config(3, B, "bfloat16")
    spec = build_model_spec(config, Vocabulary.from_str_itow(config.wtoi,
                                                             config.itow))
    cnn = bridge.to_jax_tree(smoke_weights(spec)["encoder"]["cnn"])
    root = tfc.ROOT_SCOPES["inception_v1"]
    slim = {f"{root}/{k}": v for k, v in tfc._flatten_leaves(cnn).items()}
    slim[f"{root}/Logits/Conv2d_0c_1x1/weights"] = np.zeros(
        (1, 1, 1024, 1001), np.float32)
    slim[f"{root}/Logits/Conv2d_0c_1x1/biases"] = np.zeros(1001, np.float32)
    template = bridge.to_jax_tree(get_encoder("inception_v1").init(
        torch.Generator().manual_seed(0)))
    tree = tfc.convert_slim_tree(tfc.slim_reader_to_tree(slim, root),
                                 template)
    save_cnn_checkpoint(path, bridge.from_jax_tree(tree, device="cpu"))
    return cnn


def overfit_gate_phase(kernels):
    """Phase overfit-gate: tests/test_overfit_gate.py at COMIC-256 width
    (bf16, radix tokens) on the card. The port's synthetic fixture (10
    solid-colour images of one caption each, the test split mirroring
    train) drawn in memory, its caption files written; the decoder stage
    restored in mode 'cnn' from a slim-converted CNN (gate_cnn_checkpoint);
    train_fn for GATE_XE_STEPS XE steps with the JAX gate's overrides
    (batch 5, dropout off, attn_keep_prob 1, Adam epsilon 1e-6, the CNN
    frozen, cosine lr GATE_XE_LR -> 1e-4); the infer CLI at beam 3,
    infer_max_length 20 over every saved checkpoint; then 20 SCST steps at beam 3 (lr 2e-5)
    and the infer CLI again. Thresholds: the JAX gate's. K1 and K2 must
    launch in the gate and never in a train step. -> (launches per kernel,
    launches per kernel by part)"""
    import numpy as np
    import torch

    from comic_tpu_torch.cli import infer
    from comic_tpu_torch.configuration import Config
    from comic_tpu_torch.data import captions as cap_io
    from comic_tpu_torch.data.pipeline import ScstPipeline, TrainPipeline
    from comic_tpu_torch.data.synthetic import (draw_synthetic_dataset,
                                                write_caption_artifacts)
    from comic_tpu_torch.training import scst
    from comic_tpu_torch.training.msgpack_codec import unpackb
    from comic_tpu_torch.training.xe import train_fn
    from comic_tpu_torch.utils.tf_checkpoint import _flatten_leaves

    tag = "overfit-gate"
    t_phase = time.perf_counter()
    root = os.path.join(OUT, "gate")
    shutil.rmtree(root, ignore_errors=True)
    data_dir = os.path.join(root, "data")
    data = draw_synthetic_dataset(
        num_train=10, num_valid=GATE_B, num_test=GATE_B,
        captions_per_image=1, test_mirrors_train=True, distinct_images=True)
    write_caption_artifacts(data_dir, data)
    ann = os.path.join(data_dir, "captions", "annotations_test.json")
    cnn_path = os.path.join(root, "inception_v1.ckpt.msgpack")
    converted = _flatten_leaves(gate_cnn_checkpoint(cnn_path))
    vocab = cap_io.load_vocab(data_dir, "synth_{}")
    names = [k.__name__ for k in kernels]
    parts = {}

    def config(log_path, **over):
        kw = dict(dataset_dir=data_dir, dataset_file_pattern="synth_{}",
                  batch_size_train=GATE_B, batch_size_eval=GATE_B,
                  max_epoch=10_000, compute_dtype="bfloat16",
                  lr_start=GATE_XE_LR, lr_end=1e-4, adam_epsilon=1e-6,
                  dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
                  freeze_scopes="encoder/cnn", log_path=log_path,
                  num_logs_per_epoch=1, rand_seed=0)
        kw.update(over)
        return Config(**kw)

    def sweep(part, exp, checkpoints):
        """The infer CLI over ``exp``'s checkpoints -> scores by name."""
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with InferImages(lambda: FixtureImages(data.images)):
            results = infer.main([
                "--infer_checkpoints_dir", exp,
                "--infer_checkpoints", checkpoints,
                "--dataset_dir", data_dir, "--annotations_file", ann,
                "--infer_set", "test", "--batch_size_infer", str(GATE_B),
                "--infer_beam_size", str(GATE_BEAM),
                "--infer_max_length", str(GATE_MAX_LEN)])
        parts[part] = [k.launches for k in kernels]
        if not parts[part][0] > 0 or parts[part][1]:
            raise AssertionError(f"{tag} {part}: launches {parts[part]}, "
                                 "expected K1 only")
        return results, time.perf_counter() - t0

    # XE: the decoder stage from the slim-converted CNN
    xe_dir = os.path.join(root, "xe")
    cfg = config(xe_dir, checkpoint_path=cnn_path)
    records = cap_io.read_caption_file(
        cap_io.caption_file_path(data_dir, "synth_{}", "train"))
    train_pipe = TrainPipeline(cfg, vocab, "train",
                               records=records * GATE_REPEAT,
                               loader=FixtureImages(data.images))
    eval_pipe = CountedEval(TrainPipeline(
        cfg, vocab, "valid", loader=FixtureImages(data.images)), kernels)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            metrics = train_fn(cfg, max_steps_override=GATE_XE_STEPS,
                               train_pipe=train_pipe, eval_pipe=eval_pipe)
    finally:
        sys.stdout.write(log.getvalue())
    xe_wall = time.perf_counter() - t0
    modes = re.findall(r"INFO: restore mode = (\w+)", log.getvalue())
    total = [k.launches for k in kernels]
    parts["xe_eval"] = [sum(p[i] for p in eval_pipe.passes)
                        for i in range(len(kernels))]
    train_launches = [t - e for t, e in zip(total, parts["xe_eval"])]
    if any(train_launches) or not parts["xe_eval"][1] > 0:
        raise AssertionError(f"{tag}: XE launches in the train steps "
                             f"{train_launches}, in the eval passes "
                             f"{parts['xe_eval']}")
    # the CNN is frozen, so the last checkpoint holds the converted CNN
    last = os.path.join(xe_dir, f"model_compact-{GATE_XE_STEPS}.msgpack")
    with open(last, "rb") as f:
        saved = _flatten_leaves(unpackb(f.read())["encoder"]["cnn"])
    if modes != ["cnn"] or saved.keys() != converted.keys() or \
            not all(np.array_equal(saved[k], v) for k, v in converted.items()):
        raise AssertionError(f"{tag}: the decoder stage restored in modes "
                             f"{modes}, expected ['cnn'], or its CNN is "
                             "not the slim-converted one")
    with open(os.path.join(xe_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    logs = [e for e in events if "examples_per_sec" in e]
    # a log every GATE_REPEAT * 10 / GATE_B steps; the first interval holds
    # the first steps' warm-up, each later one a save and an eval pass
    xe_ms = [GATE_B / e["examples_per_sec"] * 1e3
             for e in logs[1:]] or [xe_wall / GATE_XE_STEPS * 1e3]
    xe_sweep, xe_sweep_s = sweep("xe_sweep", xe_dir, "all")
    final = xe_sweep[f"model_compact-{GATE_XE_STEPS}"]
    agree = bf16_vs_f32(xe_dir, sweep)
    curve = "; ".join(f"{n.split('-')[-1]}: CIDEr {r['CIDEr']:.3f} BLEU-4 "
                      f"{r['Bleu_4']:.3f}" for n, r in xe_sweep.items())
    print(f"{tag} XE: {GATE_XE_STEPS} steps of batch {GATE_B} at lr "
          f"{GATE_XE_LR:g} in {xe_wall:.2f} s through train_fn "
          f"({xe_wall / GATE_XE_STEPS * 1e3:.2f} ms a step, restore, "
          f"{len(logs)} saves and eval passes included; "
          f"{statistics.median(xe_ms):.2f} ms median over each "
          f"{GATE_REPEAT * 10 // GATE_B}-step interval after the first, "
          f"{min(xe_ms):.2f}-{max(xe_ms):.2f}); restore mode {modes[0]}, "
          f"the last checkpoint's CNN bit for bit the slim-converted one "
          f"({len(converted)} leaves); final log-ppl "
          f"{metrics['log_ppl']:.4f} (tol < 0.6), total loss "
          f"{metrics['total_loss']:.4f}; launches in the train steps "
          f"{dict(zip(names, train_launches))}, in the eval passes "
          f"{dict(zip(names, parts['xe_eval']))}")
    print(f"{tag} XE sweep ({len(xe_sweep)} checkpoints in {xe_sweep_s:.2f} "
          f"s through cli.infer.main, beam {GATE_BEAM}; launches "
          f"{dict(zip(names, parts['xe_sweep']))}): {curve}")
    if not (np.isfinite(metrics["total_loss"]) and metrics["log_ppl"] < 0.6
            and final["CIDEr"] > 5.0 and final["Bleu_4"] > 0.5):
        raise AssertionError(f"{tag}: XE did not memorize: {metrics}, "
                             f"{final}")

    # SCST from the XE checkpoint
    scst_dir = os.path.join(root, "scst")
    scfg = config(scst_dir, checkpoint_path=xe_dir, lr_start=2e-5,
                  lr_end=2e-5, scst_beam_size=GATE_BEAM)
    pipe = ScstPipeline(scfg, vocab, loader=FixtureImages(data.images))
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with ScstProbe(kernels) as probe:
        sm = scst.train_fn_scst(scfg, max_steps_override=GATE_SCST_STEPS,
                                pipe=pipe)
    scst_wall = time.perf_counter() - t0
    parts["scst"] = [k.launches for k in kernels]
    if not (len(probe.rollouts) == len(probe.steps) == GATE_SCST_STEPS
            and all(all(n > 0 for n in r) for r in probe.rollouts)
            and not any(any(st) for st in probe.steps)):
        raise AssertionError(f"{tag}: SCST launches per rollout "
                             f"{probe.rollouts}, per train step {probe.steps}")
    scst_ms = [(b - a) * 1e3 for a, b in zip(probe.ends[2:], probe.ends[3:])]
    scst_sweep, scst_sweep_s = sweep("scst_sweep", scst_dir,
                                     str(GATE_SCST_STEPS))
    after = scst_sweep[f"model_compact-{GATE_SCST_STEPS}"]
    per_rollout = {n: sorted({r[i] for r in probe.rollouts})
                   for i, n in enumerate(names)}
    print(f"{tag} SCST: {GATE_SCST_STEPS} steps of {GATE_B} images x beam "
          f"{GATE_BEAM} in {scst_wall:.2f} s through train_fn_scst "
          f"({statistics.median(scst_ms):.2f} ms a step median, "
          f"{min(scst_ms):.2f}-{max(scst_ms):.2f}); reward {sm['reward']:.6f}"
          f" (tol |r| < 5), SCST loss {sm['scst_loss']:.6f}; launches per "
          f"rollout {per_rollout}, in the train steps 0; after: CIDEr "
          f"{after['CIDEr']:.3f} (tol > 4), BLEU-4 {after['Bleu_4']:.3f} "
          f"({scst_sweep_s:.2f} s through cli.infer.main; launches "
          f"{dict(zip(names, parts['scst_sweep']))})")
    if not (np.isfinite(sm["reward"]) and abs(sm["reward"]) < 5.0
            and np.isfinite(sm["scst_loss"]) and after["CIDEr"] > 4.0):
        raise AssertionError(f"{tag}: SCST broke the gate: {sm}, {after}")
    launches = [sum(v[i] for v in parts.values())
                for i in range(len(kernels))]
    print(f"{tag}: the phase in {time.perf_counter() - t_phase:.2f} s; "
          f"launches {dict(zip(names, launches))}: " + "; ".join(
              f"{p} {dict(zip(names, v))}" for p, v in parts.items()))
    best = max(xe_sweep, key=lambda n: xe_sweep[n]["CIDEr"])
    return launches, parts, dict(
        xe_dir=xe_dir, data_dir=data_dir, ann=ann, images=data.images,
        best=best, best_cider=float(xe_sweep[best]["CIDEr"]),
        agreement=agree)


def read_captions(exp):
    """{checkpoint name: {image id: caption}} of the caption JSONs of an
    experiment directory's one sweep directory."""
    infer = [d for d in os.listdir(exp) if d.startswith("infer_")]
    if len(infer) != 1:
        raise AssertionError(f"{exp}: sweep directories {infer}")
    out = {}
    for f in sorted(os.listdir(os.path.join(exp, infer[0]))):
        if f.startswith("captions___") and f.endswith(".json"):
            with open(os.path.join(exp, infer[0], f)) as fh:
                out[f[len("captions___"): -len(".json")]] = {
                    c["image_id"]: c["caption"] for c in json.load(fh)}
    return out


def bf16_vs_f32(xe_dir, sweep):
    """The overfit gate's trained checkpoints served again in float32 (TF32
    off, as eval-agree leaves it) through the infer CLI (``sweep``, part
    'xe_sweep_f32'), against their bf16 sweep: the share of images whose
    top beams (the caption JSONs) agree, per checkpoint and over all. A
    printed number, not a gate. -> {name: share}"""
    import torch

    from comic_tpu_torch.configuration import load_config

    f32_dir = xe_dir + "_f32"
    shutil.rmtree(f32_dir, ignore_errors=True)
    config = load_config(xe_dir)
    config.update(compute_dtype="float32", log_path=f32_dir)
    config.save(f32_dir)
    for f in os.listdir(xe_dir):
        if f.startswith("model_compact-"):
            shutil.copy(os.path.join(xe_dir, f), f32_dir)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    results, seconds = sweep("xe_sweep_f32", f32_dir, "all")
    bf16, f32 = read_captions(xe_dir), read_captions(f32_dir)
    if list(bf16) != list(f32) or any(bf16[n].keys() != f32[n].keys()
                                      for n in bf16):
        raise AssertionError(f"bf16 vs f32: the sweeps captioned other "
                             f"images: {list(bf16)}, {list(f32)}")
    same = {n: sum(bf16[n][i] == f32[n][i] for i in bf16[n]) for n in bf16}
    total = sum(len(c) for c in bf16.values())
    print(f"overfit-gate bf16 vs f32 (TF32 matmul/cuDNN {tf32}): the "
          f"trained checkpoints served in float32 too ({seconds:.2f} s "
          f"through cli.infer.main, beam {GATE_BEAM}); top beams agree on "
          f"{sum(same.values())} of {total} images "
          f"({sum(same.values()) / total:.3f}): " + "; ".join(
              f"{n.split('-')[-1]}: {same[n]}/{len(bf16[n])} (f32 CIDEr "
              f"{results[n]['CIDEr']:.3f})" for n in bf16))
    return {n: same[n] / len(bf16[n]) for n in bf16}


def parity_gate_phase(kernels, gate, state):
    """Phase parity-gate: comic_tpu_torch.tools.parity_gate (the port's
    reference-parity gate) on the card, beam 3, on copies of the overfit
    gate's trained experiment directory (its config.pkl and compact
    checkpoints, as train_fn wrote them), against the fixture's test-split
    references as a COCO annotation file, with the best CIDEr that
    overfit-gate's sweep scored there as the target: (a) PASS: exit 0,
    best_cider equal to the target to 1e-9 relative; (b) FAIL: the same
    directory with the untrained smoke weights ``state`` as its checkpoint
    must exit 1 with other captions; (c) without --allow_ptb_fallback and
    with no jar the gate must raise "PTB jar required". K1 must launch in
    (a) and (b), K2 never. -> launches per kernel"""
    from comic_tpu_torch.tools import parity_gate
    from comic_tpu_torch.training.checkpoints import save_compact

    tag = "parity-gate"
    t_phase = time.perf_counter()
    root = os.path.join(OUT, "parity")
    shutil.rmtree(root, ignore_errors=True)
    names = [k.__name__ for k in kernels]
    target = gate["best_cider"]
    print(f"{tag}: " + ("no java on PATH" if not shutil.which("java") else
                        "no CoreNLP jar given") + ": the PASS and FAIL legs "
          "score through the Python PTB fallback (--allow_ptb_fallback), a "
          "rehearsal of the gate, not parity evidence")

    def experiment(name, trained):
        exp = os.path.join(root, name)
        os.makedirs(exp)
        shutil.copy(os.path.join(gate["xe_dir"], "config.pkl"), exp)
        for f in os.listdir(gate["xe_dir"]):
            if trained and f.startswith("model_compact-"):
                shutil.copy(os.path.join(gate["xe_dir"], f), exp)
        if not trained:
            save_compact(exp, GATE_XE_STEPS, state)
        return exp

    def argv(exp):
        return ["--experiment_dir", exp, "--dataset_dir", gate["data_dir"],
                "--annotations_file", gate["ann"],
                "--target_cider", repr(target), "--infer_set", "test",
                "--batch_size_infer", str(GATE_B),
                "--infer_beam_size", str(GATE_BEAM),
                "--infer_max_length", str(GATE_MAX_LEN)]

    def run(leg, exp):
        """The gate's main on ``exp``, the Python PTB fallback allowed ->
        (exit code, verdict, launches per kernel)."""
        for k in kernels:
            k.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with InferImages(lambda: FixtureImages(gate["images"])), \
                contextlib.redirect_stdout(out):
            rc = parity_gate.main(argv(exp) + ["--allow_ptb_fallback"])
        seconds = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        launches = [k.launches for k in kernels]
        print(f"{tag} {leg}: exit {rc} in {seconds:.2f} s; launches "
              f"{dict(zip(names, launches))}; verdict {lines[-2]}; "
              f"{lines[-1]}")
        if not launches[0] > 0 or launches[1]:
            raise AssertionError(f"{tag} {leg}: launches {launches}, "
                                 "expected K1 only")
        return rc, json.loads(lines[-2]), launches

    pass_dir = experiment("pass", True)
    rc, verdict, pass_launches = run("PASS", pass_dir)
    err = abs(verdict["best_cider"] - target) / target
    if rc != 0 or verdict["passed"] is not True or err > 1e-9:
        raise AssertionError(f"{tag} PASS: exit {rc}, best CIDEr "
                             f"{verdict['best_cider']!r} against the "
                             f"overfit gate's {target!r} ({err:.3g} apart)")
    fail_dir = experiment("fail", False)
    rc, verdict, fail_launches = run("FAIL", fail_dir)
    last = f"model_compact-{GATE_XE_STEPS}"
    differ = read_captions(fail_dir)[last] != read_captions(pass_dir)[last]
    if rc != 1 or verdict["passed"] is not False or not differ:
        raise AssertionError(f"{tag} FAIL: exit {rc}, verdict {verdict}, "
                             f"captions differ from the PASS leg's: "
                             f"{differ}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            parity_gate.main(argv(pass_dir))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    if not refused or "PTB jar required" not in refused:
        raise AssertionError(f"{tag}: without --allow_ptb_fallback the "
                             f"gate did not refuse: {refused!r}")
    launches = [a + b for a, b in zip(pass_launches, fail_launches)]
    print(f"{tag}: PASS at best CIDEr {target:.6f} ({gate['best']}, "
          f"{err:.3g} relative from overfit-gate's), FAIL on the untrained "
          f"weights (other captions), refusal without the fallback "
          f"({refused.splitlines()[0][:80]}...); the phase in "
          f"{time.perf_counter() - t_phase:.2f} s; launches "
          f"{dict(zip(names, launches))}")
    return launches


class DecodeSteps:
    """Counts the decode steps of beam search (the decoder's
    step_grouped) and of greedy decoding (its step) within a ``with``
    block, by wrapping the search module's building blocks, which it looks
    up when it runs."""

    def __enter__(self):
        from comic_tpu_torch.decoding import search

        self.search, self.beam, self.greedy = search, 0, 0
        self.saved = (search.step_grouped, search.decoder_step)
        grouped, single = self.saved

        def counted_grouped(*args, **kwargs):
            self.beam += 1
            return grouped(*args, **kwargs)

        def counted_single(*args, **kwargs):
            self.greedy += 1
            return single(*args, **kwargs)

        search.step_grouped, search.decoder_step = (counted_grouped,
                                                    counted_single)
        return self

    def __exit__(self, *exc):
        self.search.step_grouped, self.search.decoder_step = self.saved


def counted_run(config, ckpt_path, pipe, kernels):
    """run_inference on the card with every kernel's count set to 0 just
    before and read just after -> (launches per kernel, the DecodeSteps of
    the run, seconds, captions)."""
    from comic_tpu_torch.inference import run_inference

    for k in kernels:
        k.launches = 0
    with DecodeSteps() as steps:
        t0 = time.perf_counter()
        _, json_path = run_inference(config, ckpt_path, pipe=pipe)
        wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    with open(json_path) as f:
        caps = [c["caption"] for c in json.load(f)]
    return launches, steps, wall, caps


def zoo_serve_phase(kernels):
    """Phase zoo-serve: every encoder comic_tpu registers, at 224 in bf16
    with COMIC-256's decoder: seeded port weights with BN statistics
    perturbed (smoke_weights), a compact checkpoint, and ZOO_BATCHES
    batches of B seeded uint8 images through run_inference at beam 3; K1
    must launch once on every beam step and every caption hold words. Then
    the encoder and one whole batch are timed apart, and ZOO_GREEDY
    encoders serve one batch greedy, where K2 must launch on every step.
    -> {"k1": {L: launches}, "k2": {L: launches}, "serve": {encoder:
    launches}, "states": {encoder: CPU weights} of ZOO_AGREE}"""
    import torch

    from comic_tpu_torch.data.preprocessing import preprocess_for
    from comic_tpu_torch.decoding import search
    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import (build_model_spec,
                                                  max_decode_steps, tree_to)
    from comic_tpu_torch.models.encoders import available_encoders
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import save_compact

    k1, k2 = kernels
    batches = image_batches(ZOO_BATCHES, B)
    n_images = ZOO_BATCHES * B
    out = {"k1": {}, "k2": {}, "serve": {}, "states": {}}

    def serve_counted(config, ckpt_path, pipe, kernel, name, beam):
        """run_inference with the counts set to 0 just before and read just
        after -> (launches, decode steps, seconds, peak GiB)."""
        torch.cuda.reset_peak_memory_stats()
        got, steps, wall, caps = counted_run(config, ckpt_path, pipe,
                                             kernels)
        launches = got[kernels.index(kernel)]
        n_steps = steps.beam if beam > 1 else steps.greedy
        n = sum(len(names) for _, names in pipe)
        if len(caps) != n or not all(caps):
            raise AssertionError(f"zoo-serve {name} beam {beam}: "
                                 f"{len(caps)} captions for {n} images, "
                                 f"{sum(not c for c in caps)} empty")
        if launches <= 0 or launches != n_steps:
            raise AssertionError(
                f"zoo-serve {name} beam {beam}: {kernel.__name__} launched "
                f"{launches} times over {n_steps} decode steps")
        return (launches, n_steps, wall,
                torch.cuda.max_memory_allocated() / 2**30)

    for name in available_encoders():
        t0 = time.perf_counter()
        config = smoke_config(3, B, "bfloat16", name)
        config.update(log_path=os.path.join(OUT, "zoo", name))
        vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
        spec = build_model_spec(config, vocab)
        state = smoke_weights(spec)
        ckpt_path = save_compact(config.log_path, 1, state)
        setup_s = time.perf_counter() - t0
        launches, n_steps, wall, peak_gb = serve_counted(
            config, ckpt_path, batches, k1, name, 3)

        params = tree_to(state, torch.device("cuda"))
        h, w = config.cnn_input_size
        images = batches[0][0]
        preprocess = preprocess_for(name)

        @torch.inference_mode()
        def encode():
            return search._prepare_memory(
                params, spec, preprocess(images, h, w, torch.device("cuda")))

        length = encode()[1].keys.shape[1]
        channels = spec.decoder.attention.memory_channels
        enc_ms = median_ms(encode, iters=5, warmup=2)
        serve = make_serve_fn(spec, config, max_decode_steps(config, vocab),
                              collect_alignments=False)
        serve_ms = median_ms(lambda: serve(params, images), iters=3,
                             warmup=1)
        out["k1"][length] = out["k1"].get(length, 0) + launches
        out["serve"][name] = launches
        print(f"zoo-serve {name}: L={length} ({spec.fm_endpoint}), C="
              f"{channels}; {n_images} captions in {wall:.2f} s through "
              f"run_inference (first call included; weights and checkpoint "
              f"{setup_s:.1f} s before), K1 {launches} launches = "
              f"{n_steps} beam steps; steady batch of {B}: {serve_ms:.2f} "
              f"ms ({B / serve_ms * 1e3:.1f} captions/s), encoder "
              f"{enc_ms:.2f} ms; peak memory {peak_gb:.2f} GiB")
        if name in ZOO_GREEDY:
            config.update(infer_beam_size=1)
            g_launches, g_steps, g_wall, _ = serve_counted(
                config, ckpt_path, batches[:1], k2, name, 1)
            out["k2"][length] = out["k2"].get(length, 0) + g_launches
            print(f"zoo-serve {name} greedy: {B} captions in {g_wall:.2f} "
                  f"s, K2 {g_launches} launches = {g_steps} decode steps "
                  f"at L={length}")
        if name in ZOO_AGREE:
            out["states"][name] = state
        del params, serve
        torch.cuda.empty_cache()
        shutil.rmtree(config.log_path)
    return out


def zoo_agree_phase(states):
    """Phase zoo-agree: for one encoder of each module, float32 with TF32
    off at batch 2 and beam 3, the card's attention memory within TOL_ZOO
    of the CPU's scale and the top-beam ids equal."""
    for name in ZOO_AGREE:
        t0 = time.perf_counter()
        keys_err, ids = card_vs_cpu(states[name], name)
        equal = bool((ids["cuda"] == ids["cpu"]).all())
        print(f"zoo-agree {name} (float32, TF32 off, batch 2, beam 3): "
              f"attention memory max rel error {keys_err:.2e} (tol "
              f"{TOL_ZOO:.0e}), top-beam ids "
              f"{'equal' if equal else 'DIFFER'} {tuple(ids['cpu'].shape)}"
              f" ({time.perf_counter() - t0:.1f} s)")
        if keys_err > TOL_ZOO or not equal:
            raise AssertionError(f"zoo-agree {name}: the card disagrees "
                                 "with the CPU")


def zoo_train_phase(state, kernels):
    """Phase zoo-train: the training CLI's cnn_finetune stage with
    ZOO_TRAIN_NET (VGG train augmentation, slim's fixed-pad strided convs
    under autograd) for ZOO_TRAIN_STEPS steps of batch TRAIN_B, from a
    decoder-stage directory holding ``state``; train_phase checks the
    losses, the checkpoints, 0 launches in the train steps and K2 in the
    eval pass. -> eval launches per kernel"""
    from comic_tpu_torch.cli.train import create_parser, experiment_name
    from comic_tpu_torch.training.checkpoints import save_compact

    args = create_parser().parse_args(
        stage_argv("decoder", "unused", ZOO_TRAIN_NET))
    save_compact(os.path.join(OUT, "train", f"{experiment_name(args)}_run_"
                              f"{args.run:02d}"), 1, state)
    eval_launches, _ = train_phase("cnn_finetune", ZOO_TRAIN_STEPS, None,
                                   kernels, ZOO_TRAIN_NET)
    return eval_launches

# data parallelism: the smoke's job is one process on one card (NCCL
# refuses two ranks on one GPU), joined from COMIC_COORDINATOR as a user's
# W-card job is; dp-scst's steps; dp-agree's bound on the job step against
# the plain step (float32, TF32 off: one code path, a loss share of
# exactly 1 and an all-reduce over one rank, so the job leaves the step
# as it was)
DP_SCST_STEPS, TOL_DP = 10, 1e-6


def dp_agree(ckpt_path):
    """Phase dp-agree, in the job's process: one XE step at batch 2, full
    width, float32 with TF32 off, nothing frozen, dropout and augment off,
    plain twice (how far the card repeats its own step), then after
    joining the world-1 NCCL job from the environment, from the same
    parameters, with cuDNN held to its deterministic algorithms (its
    default convolution backward sums in another order from call to
    call, 1e-7 of a leaf). -> the numbers to report"""
    import torch
    import torch.distributed as dist

    from comic_tpu_torch.data.pipeline import pad_rows
    from comic_tpu_torch.models.captioner import build_model_spec, init_params
    from comic_tpu_torch.parallel import mesh as pm
    from comic_tpu_torch.parallel.distributed import \
        maybe_initialize_distributed
    from comic_tpu_torch.tokenization import Vocabulary, encode_caption_tokens
    from comic_tpu_torch.training.checkpoints import load_compact
    from comic_tpu_torch.training.optimizer import (Optimizer, set_trainable,
                                                    tree_items)
    from comic_tpu_torch.training.xe import TrainState, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    config = smoke_config(1, 2, "float32")
    config.update(dropout_rnn_in=0.0, dropout_rnn_out=0.0, attn_keep_prob=1.0,
                  cnn_input_augment=False, freeze_scopes="")
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    images = image_batches(1, 2)[0][0]
    caps = pad_rows([encode_caption_tokens(t, "radix", vocab, 256)
                     for _, t in caption_records("agree", 2, 0)], 42)
    out = {}
    for tag in ("plain", "plain-again", "job"):
        if tag == "job":
            if not maybe_initialize_distributed():
                raise AssertionError("dp-agree: COMIC_COORDINATOR is not set")
        params = load_compact(ckpt_path, init_params(spec, device="cuda"))
        opt = Optimizer(params, lambda n: 1e-3, freeze_scopes="")
        set_trainable(params, opt.mask)
        step = make_train_step(spec, config, (224, 224), device="cuda")
        calls = pm.all_reduce_grads.calls
        _, metrics = step(TrainState(params, opt, 0), images, caps)
        out[tag] = (metrics["total_loss"].item(),
                    {p: v.detach().cpu() for p, v in tree_items(params)},
                    pm.all_reduce_grads.calls - calls)
    # TF32 stays off, as in the smoke's own process after agree-f32, so
    # that dp-train runs train-decoder's arithmetic
    torch.backends.cudnn.deterministic = deterministic
    worst, worst_leaf = worst_leaf_difference(out["job"][1], out["plain"][1])
    repeat, _ = worst_leaf_difference(out["plain-again"][1], out["plain"][1])
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "loss_plain": out["plain"][0], "loss_job": out["job"][0],
            "loss_rel": abs(out["job"][0] - out["plain"][0])
            / abs(out["plain"][0]), "worst": worst, "worst_leaf": worst_leaf,
            "plain_repeat": repeat,
            "plain_repeat_loss_equal": out["plain-again"][0]
            == out["plain"][0], "all_reduces": out["job"][2]}


def dp_scst(kernels):
    """Phase dp-scst, in the job's process: DP_SCST_STEPS steps of the
    training CLI's scst stage (batch 10, beam 7, bf16) through its stage
    chain (which joins the job) from the cnn_finetune stage's directory,
    into a directory of its own, on in-memory batches, with the IDF cache
    train-scst wrote. -> the numbers to report"""
    import numpy as np

    from comic_tpu_torch.cli.train import stage_config
    from comic_tpu_torch.data.pipeline import ScstPipeline
    from comic_tpu_torch.parallel import mesh as pm
    from comic_tpu_torch.tokenization import Vocabulary

    # the SCST stage reads the cnn_finetune stage's directory under its log
    # root: the smoke's own, linked into a root of the job's
    root = os.path.join(OUT, "dp")
    os.makedirs(root, exist_ok=True)
    train_root = os.path.join(OUT, "train")
    for name in os.listdir(train_root):
        if name.endswith("_smoke_cnnFT_run_01"):
            os.symlink(os.path.join(train_root, name),
                       os.path.join(root, name))
    stage_fn, config = stage_config([
        "--train_mode", "scst", "--name", "smoke", "--log_root", root,
        "--dataset_dir", os.path.join(train_root, "data")])
    vocab_cfg = smoke_config(1, B, "bfloat16")
    config.update(wtoi=vocab_cfg.wtoi, itow=vocab_cfg.itow,
                  vocab_size=len(vocab_cfg.itow))
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    records = scst_records(SCST_B * (DP_SCST_STEPS + 1))
    pipe = ScstPipeline(config, vocab, records=records, loader=MemoryImages())
    for k in kernels:
        k.launches = 0
    calls = pm.all_reduce_grads.calls
    with ScstProbe(kernels) as probe:
        stage_fn(config, max_steps_override=DP_SCST_STEPS, pipe=pipe)
    pipe.close()
    losses = [m["total_loss"] for m in probe.metrics]
    step_ms = [(b - a) * 1e3 for a, b in zip(probe.ends[2:], probe.ends[3:])]
    return {"rollouts": probe.rollouts, "steps": probe.steps,
            "losses": losses, "finite": bool(np.isfinite(losses).all()),
            "launches": [k.launches for k in kernels],
            "all_reduces": pm.all_reduce_grads.calls - calls,
            "step_ms": statistics.median(step_ms),
            "log_path": config.log_path}


def dp_job(ckpt_path, out_json):
    """The data-parallel phases' process (``chip_smoke.py --dp-job``):
    launched by dp_phases with COMIC_COORDINATOR, COMIC_NUM_PROCESSES=1 and
    COMIC_PROCESS_ID=0, it runs dp-agree (which joins the job), dp-train
    and dp-scst, and writes their numbers to ``out_json``."""
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1

    kernels = [k1.grouped_add_ln_attention, k2.fused_add_ln_attention]
    result = {"agree": dp_agree(ckpt_path)}
    eval_launches, train = train_phase("decoder", DECODER_STEPS, ckpt_path,
                                       kernels, tag="dp-train")
    result["train"] = {"eval_launches": eval_launches,
                       "all_reduces": train["all_reduces"],
                       "head": train["head"], "tail": train["tail"],
                       "step_ms": train["step_ms"],
                       "log_path": train["log_path"],
                       "backend": dist.get_backend()}
    result["scst"] = dp_scst(kernels)
    dist.destroy_process_group()
    with open(out_json, "w") as f:
        json.dump(result, f)


def dp_phases(kernels, decoder):
    """Phases dp-agree, dp-train, dp-scst: this script with --dp-job in a
    process of its own, which joins a world-1 NCCL job from
    COMIC_COORDINATOR (a free port of localhost), COMIC_NUM_PROCESSES=1
    and COMIC_PROCESS_ID=0. dp-agree within TOL_DP with one gradient
    all-reduce; dp-train (train-decoder's setup: COMIC-256, bf16, batch
    32, DECODER_STEPS steps from the smoke weights) checked as
    train-decoder is, its loss falling as much, one all-reduce a step, and
    its directory the one set of files train-decoder's is; dp-scst with K1
    and K2 in every rollout, none in a train step, one all-reduce a step.
    ``decoder``: train-decoder's summary. -> launches per kernel"""
    import numpy as np

    from comic_tpu_torch.entry import free_port

    out_json = os.path.join(OUT, "dp_job.json")
    env = dict(os.environ, COMIC_COORDINATOR=f"127.0.0.1:{free_port()}",
               COMIC_NUM_PROCESSES="1", COMIC_PROCESS_ID="0")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--dp-job",
                    decoder["ckpt_path"], out_json], env=env, check=True,
                   timeout=900)
    wall = time.perf_counter() - t0
    with open(out_json) as f:
        res = json.load(f)
    agree, train, scst = res["agree"], res["train"], res["scst"]
    print(f"dp-agree (world-{agree['world']} {agree['backend']} job vs the "
          f"plain step, float32, TF32 off, cuDNN deterministic, batch 2, "
          f"nothing frozen): loss "
          f"{agree['loss_job']:.7f} vs {agree['loss_plain']:.7f}, relative "
          f"difference {agree['loss_rel']:.2e}; largest relative difference "
          f"of the updated parameters {agree['worst']:.2e} at "
          f"{agree['worst_leaf']} (tol {TOL_DP:.0e}); the plain step "
          f"repeated: largest relative difference {agree['plain_repeat']:.2e}"
          f", loss equal {agree['plain_repeat_loss_equal']}; "
          f"all_reduce_grads calls {agree['all_reduces']}")
    if not (agree["backend"] == "nccl" and agree["world"] == 1
            and agree["all_reduces"] == 1 and agree["loss_rel"] <= TOL_DP
            and agree["worst"] <= TOL_DP):
        raise AssertionError("dp-agree: the job's step disagrees with the "
                             "plain step")

    # the files of the job's run against train-decoder's, the config
    # records (timestamped) and TensorBoard files (named by host and time,
    # where TensorBoard is installed) counted
    files = {}
    stamped = ("config___", "events.out.tfevents")
    for tag, log in (("train-decoder", decoder["log_path"]),
                     ("dp-train", train["log_path"])):
        names = sorted(os.listdir(log))
        with open(os.path.join(log, "model_size.txt"), "rb") as f:
            files[tag] = ([n for n in names if not n.startswith(stamped)],
                          [sum(n.startswith(p) for n in names)
                           for p in stamped], f.read())
    print(f"dp-train (world-1 {train['backend']} job): steady steps "
          f"{train['step_ms']:.2f} ms median against train-decoder's "
          f"{decoder['step_ms']:.2f} ms; XE log-ppl first 3 steps "
          f"{train['head']:.4f}, last 3 {train['tail']:.4f}; all_reduce_grads "
          f"calls {train['all_reduces']}; log directory {files['dp-train'][0]}"
          f" + config records and TensorBoard files {files['dp-train'][1]}")
    if not (train["backend"] == "nccl" and train["tail"] < train["head"]
            - LOSS_DROP and train["all_reduces"] == DECODER_STEPS
            and files["dp-train"] == files["train-decoder"]
            and files["dp-train"][1][0] == 1
            and files["dp-train"][1][1] <= 1):
        raise AssertionError(f"dp-train: {train}, files {files}")

    names = [k.__name__ for k in kernels]
    per_rollout = {n: sorted({r[i] for r in scst["rollouts"]})
                   for i, n in enumerate(names)}
    print(f"dp-scst (world-1 nccl job): {len(scst['steps'])} steps of "
          f"{SCST_B} images x beam {SCST_K}, steady steps "
          f"{scst['step_ms']:.2f} ms median; total loss first "
          f"{scst['losses'][0]:.6f}, last {scst['losses'][-1]:.6f}; launches "
          f"per rollout {per_rollout}, in the train steps "
          f"{sum(map(sum, scst['steps']))}; all_reduce_grads calls "
          f"{scst['all_reduces']}; the job's phases took {wall:.1f} s in "
          "their process, its start included")
    if not (len(scst["rollouts"]) == DP_SCST_STEPS and scst["finite"]
            and all(all(n > 0 for n in r) for r in scst["rollouts"])
            and not any(map(any, scst["steps"]))
            and scst["all_reduces"] == DP_SCST_STEPS):
        raise AssertionError(f"dp-scst: {scst}")
    return [e + s for e, s in zip(train["eval_launches"], scst["launches"])]


def dp_serve_phase(kernels, ckpt_path, batches):
    """Phase dp-serve: serve-beam3's batches through a serve fn whose mesh
    is make_mesh_for_batch over every visible card: its captions must equal
    serve-beam3's caption JSON, and its ids those of the same serve without
    a mesh. -> K1's launches in the mesh serve"""
    import torch

    from comic_tpu_torch.inference import infer_dir_name, make_serve_fn
    from comic_tpu_torch.models.captioner import (build_model_spec,
                                                  init_params,
                                                  max_decode_steps)
    from comic_tpu_torch.parallel.mesh import make_mesh_for_batch
    from comic_tpu_torch.tokenization import Vocabulary, ids_to_captions
    from comic_tpu_torch.training.checkpoints import load_compact

    config = smoke_config(3, B, "bfloat16")
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    params = load_compact(ckpt_path, init_params(spec, device="cuda"))
    steps = max_decode_steps(config, vocab)
    mesh = make_mesh_for_batch(B)
    serve = make_serve_fn(spec, config, steps, collect_alignments=False,
                          mesh=mesh)
    plain = make_serve_fn(spec, config, steps, collect_alignments=False)
    before = kernels[0].launches
    split = [serve(params, images)[0].cpu() for images, _ in batches]
    launches = kernels[0].launches - before
    whole = [plain(params, images)[0].cpu() for images, _ in batches]
    with open(os.path.join(config.log_path, infer_dir_name(config),
                           "captions___model_compact-1.json")) as f:
        served = [c["caption"] for c in json.load(f)]
    caps = [c for ids in split for c in ids_to_captions(
        ids.numpy(), "radix", vocab, config.radix_base)]
    same = all(torch.equal(a, b) for a, b in zip(split, whole))
    print(f"dp-serve: {len(caps)} images in {len(batches)} batches of {B} "
          f"split over a mesh of {mesh.size} card(s) "
          f"({[str(d) for d in mesh.devices]}): ids equal to the unsplit "
          f"serve: {same}; captions equal to serve-beam3's JSON: "
          f"{caps == served}; K1 launches {launches}")
    if not (same and caps == served and launches > 0):
        raise AssertionError("dp-serve: the mesh serve differs")
    return launches


def dryrun_phase(kernels):
    """Phase dryrun: comic_tpu_torch.entry.dryrun_multichip over every
    visible card (an n-process NCCL job: XE step, K=2 call, SCST rollout
    and step; then serving split over the n cards in this process). ->
    the kernels' launches in this process"""
    import torch

    from comic_tpu_torch.entry import dryrun_multichip

    before = [k.launches for k in kernels]
    t0 = time.perf_counter()
    dryrun_multichip(torch.cuda.device_count(), timeout=600)
    print(f"dryrun: dryrun_multichip({torch.cuda.device_count()}) passed in "
          f"{time.perf_counter() - t0:.1f} s")
    return [k.launches - b for k, b in zip(kernels, before)]


def bench_phase(kernels):
    """Phase bench: comic_tpu_torch.bench's legs and tools/beam_sweep at
    full width with few calls, each checked as the docstring says. ->
    (launches per kernel, K1 launches at B=BENCH_B and K=3, launches per
    beam_sweep beam)"""
    import math

    import torch

    from comic_tpu_torch import bench
    from comic_tpu_torch.models.captioner import max_decode_steps
    from comic_tpu_torch.tools import beam_sweep

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    config, spec, params, vocab = bench.flagship_model(device)
    steps = max_decode_steps(config, vocab)
    serve_spec = bench.worst_case(spec)
    small = dict(iters=BENCH_ITERS, warmup=1, rounds=BENCH_ROUNDS)
    calls = 1 + BENCH_ROUNDS * BENCH_ITERS
    k1, k2 = (k.__name__ for k in kernels)
    for k in kernels:
        k.launches = 0
    got = {}

    def leg(name, want, fn, *args, **kw):
        """Run a leg; its launches must be ``want`` ({kernel: n}, None: any
        number above 0). A leg run again adds to its launches."""
        before = bench.kernel_launches()
        out = fn(*args, **kw)
        n = bench.launches_since(before)
        for kern, w in want.items():
            if (n[kern] <= 0) if w is None else (n[kern] != w):
                raise AssertionError(f"bench {name}: {kern} launched "
                                     f"{n[kern]} times, expected "
                                     f"{'some' if w is None else w}")
        got[name] = {k: got.get(name, {}).get(k, 0) + v
                     for k, v in n.items()}
        return out

    def serving(batch):
        """-> ms of a worst-case batch; K1 on every step of every call."""
        _, _, ms_by_batch, _ = leg(
            f"serving_b{batch}", {k1: steps * calls, k2: 0},
            bench.bench_serving, config, serve_spec, params, steps, device,
            batches=(batch,), **small)
        return ms_by_batch[batch]

    def realistic():
        return leg("serving_realistic", {k1: 40 * calls, k2: 0},
                   bench.bench_serving_realistic, config, serve_spec, params,
                   device, batch=BENCH_B, **small)[1]

    def floor():
        return leg("serving_floor", {k2: 0}, bench.bench_serving_floor,
                   config, spec, params, steps, device, batch=BENCH_B,
                   **small)

    b25_ms = serving(25)
    # the three batch-BENCH_B legs in BENCH_TURNS rotating turns, each leg's
    # best kept: the host-bound loop drifts by tens of % over seconds,
    # more than a 40-step batch saves against a 60-step one
    b_legs = {"worst": lambda: serving(BENCH_B), "realistic": realistic,
              "floor": floor}
    order, b_ms = list(b_legs), {}
    for turn in range(BENCH_TURNS):
        for name in order[turn:] + order[:turn]:
            b_ms[name] = min(b_legs[name](), b_ms.get(name, math.inf))
    floor_ms, real_ms = b_ms["floor"], b_ms["realistic"]
    ms_by_batch = {25: b25_ms, BENCH_B: b_ms["worst"]}
    real_cps = BENCH_B / (real_ms / 1e3)
    best = max(b / (ms / 1e3) for b, ms in ms_by_batch.items())
    roofline = leg("roofline_serving", {k1: steps, k2: 0},
                   bench.roofline_serving, config, serve_spec, params, steps,
                   device, ms_by_batch[BENCH_B], floor_ms, batch=BENCH_B)
    xe_ms, xe_k_ms, xe_fields = leg(
        "xe_step", {k1: 0, k2: 0}, bench.bench_xe_step, config, spec, params,
        device, k=2, iters_k=1, **small)
    xe_eps, _, xe_by_batch = leg(
        "xe_best", {k1: 0, k2: 0}, bench.bench_xe_best, config, spec, params,
        device, batches=BENCH_XE_BATCHES, k=2, iters=1, warmup=1, rounds=1)
    roll_ms, scst_ms, scst_fields = leg(
        "scst", {k1: None, k2: None}, bench.bench_scst, config, spec, params,
        vocab, device, **small)
    eps_on, eps_off = leg(
        "scst_loop", {k1: None, k2: None}, bench.bench_scst_loop, config,
        spec, params, vocab, device, steps=BENCH_LOOP_STEPS, warmup=1,
        runs=1)
    beams = {}
    for beam in BENCH_BEAMS:
        (row,) = leg(f"beam{beam}", {k1: 0 if beam == 1 else steps * calls,
                                     k2: steps * calls if beam == 1 else 0},
                     lambda: list(beam_sweep.sweep(
                         config, spec, params, vocab, device, [beam],
                         batch=BENCH_B, **small)))
        beams[beam] = row["serve_ms"]

    timings = {"serve_ms": ms_by_batch, "floor_ms": floor_ms,
               "realistic_ms": real_ms, "realistic_cps": real_cps,
               "best_cps": best, "xe_ms": xe_ms, "xe_k_ms": xe_k_ms,
               "xe_best_eps": xe_eps, "xe_eps": xe_by_batch,
               "scst_rollout_ms": roll_ms, "scst_train_ms": scst_ms,
               "scst_loop_eps": [eps_on, eps_off], "beam_ms": beams}
    fields = {**roofline, **xe_fields, **scst_fields}
    budget = fields.pop("decode_step_budget_melems")

    def numbers(x):
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, list):
            return [v for item in x for v in numbers(item)]
        return [x]

    if not all(math.isfinite(v) and v > 0 for v in numbers(timings)):
        raise AssertionError(f"bench: a time or rate is not finite and "
                             f"positive: {timings}")
    if not all(math.isfinite(v) and v >= 0
               for v in numbers([fields, budget])):
        raise AssertionError(f"bench: a cost-model field is not finite or "
                             f"is negative: {fields}, {budget}")
    worst_ms = ms_by_batch[BENCH_B]
    if not floor_ms < real_ms < worst_ms:
        raise AssertionError(f"bench b{BENCH_B}: floor {floor_ms:.2f} ms, "
                             f"realistic {real_ms:.2f} ms, worst case "
                             f"{worst_ms:.2f} ms are out of order")
    print(f"bench b{BENCH_B}: floor {floor_ms:.2f} ms < realistic (40 "
          f"steps) {real_ms:.2f} ms < worst case ({steps} steps) "
          f"{worst_ms:.2f} ms; b25 {ms_by_batch[25]:.2f} ms; beam 1/2/5/7 "
          + ", ".join(f"{beams[b]:.2f}" for b in BENCH_BEAMS) + " ms; XE "
          f"step {xe_ms:.2f} ms, XE best {xe_eps:.1f} examples/s "
          f"{xe_by_batch}; SCST rollout {roll_ms:.2f} ms, train "
          f"{scst_ms:.2f} ms, loop {eps_on:.1f} / {eps_off:.1f} examples/s "
          f"(overlap on / off); best of {BENCH_ROUNDS} rounds of "
          f"{BENCH_ITERS} calls a leg, the phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    print("bench launches: " + json.dumps(got))
    print("bench cost model: " + json.dumps({**fields, "budget": budget}))
    k1_b = sum(got[name][k1] for name in (
        f"serving_b{BENCH_B}", "serving_floor", "serving_realistic",
        "roofline_serving"))
    return ([k.launches for k in kernels], k1_b,
            {b: got[f"beam{b}"] for b in BENCH_BEAMS})


# phases 25-28: the configurations besides COMIC-256's radix tokens, LSTM,
# add_LN/softmax/tied attention and 224 inputs. Each serves at full width
# (bf16, the smoke vocabulary) with the kernels' launches counted against
# the decode steps, and is then held card vs the port's CPU path (float32,
# TF32 off, batch 2: the attention memory within TOL_ZOO of its scale, the
# top-beam ids equal). VARIANT_BATCHES batches of B a configuration
# (attn-variants serves one at beam 3)
VARIANT_BATCHES = 2
# {name: (Config fields, inside the kernels' domain)}
TOKEN_VARIANTS = {"word": (dict(token_type="word"), True),
                  "char": (dict(token_type="char"), True)}
CELL_VARIANTS = {"LN_LSTM": (dict(rnn_name="LN_LSTM"), True),
                 "GRU": (dict(rnn_name="GRU"), True)}
# every attention configuration Config accepts outside the kernels' domain
# (K1 and K2 launch 0 times; none without the context layer feeds the raw
# 832 channels back), and the context layer on add_LN/softmax/tied, inside
ATTN_VARIANTS = {
    "dot": (dict(attn_alignment_method="dot"), False),
    "sigmoid": (dict(attn_probability_fn="sigmoid"), False),
    "independent": (dict(cnn_fm_projection="independent"), False),
    "none": (dict(cnn_fm_projection="none"), False),
    "none_context": (dict(cnn_fm_projection="none",
                          attn_context_layer=True), False),
    "context": (dict(attn_context_layer=True), True)}
# the zoo at its native input sizes: 17x17 memories at 299 (L=289), 21x21
# at 331 (L=441); the host images are drawn at that size, since the file
# pipeline resizes to 256 and never upsamples. One net of each size also
# serves greedy and is held card vs CPU
ZOO_NATIVE = {"inception_v3": 299, "inception_v4": 299,
              "inception_resnet_v2": 299, "nasnet_large": 331,
              "pnasnet_large": 331}
ZOO_NATIVE_AGREE = ("inception_v3", "pnasnet_large")
ZOO_NATIVE_L = (289, 441)


def expected_launches(kernels, steps, beam, inside):
    """One launch of K1 a beam step, of K2 a greedy step, inside the
    kernels' domain; none outside it."""
    want = [0] * len(kernels)
    if inside:
        want[0 if beam > 1 else 1] = steps.beam if beam > 1 else steps.greedy
    return want


def variants_phase(phase, variants, kernels, n_batches, beams, xe=()):
    """Phases tokens-serve, cells-serve, attn-variants: each configuration
    of ``variants`` ({name: (Config fields, inside the kernels' domain)})
    at full width in bf16: seeded weights (smoke_weights; <EOS> held down
    for word and char tokens, whose first 40 ids are not radix digits), a
    compact checkpoint and ``n_batches`` batches of B seeded images through
    run_inference at each of ``beams``: the launches against the decode
    steps (expected_launches) and every caption holding words (characters
    for char tokens); one steady batch at beam 3 timed apart; then card vs
    CPU in float32 (card_vs_cpu), and for the names in ``xe`` one float32
    train step card vs CPU (train_agree_phase). -> launches per kernel"""
    import torch

    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import (build_model_spec,
                                                  max_decode_steps,
                                                  start_end_ids, tree_to)
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import save_compact

    t_phase = time.perf_counter()
    batches = image_batches(n_batches, B)
    n_images = n_batches * B
    names = [k.__name__ for k in kernels]
    total = [0] * len(kernels)
    for name, (fields, inside) in variants.items():
        t0 = time.perf_counter()
        config = smoke_config(3, B, "bfloat16", **fields)
        config.update(log_path=os.path.join(OUT, phase, name))
        vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
        spec = build_model_spec(config, vocab)
        state = smoke_weights(spec)
        if config.token_type != "radix":
            state["decoder"]["output_projection"]["bias"][
                start_end_ids(config, vocab)[1]] = -2.0
        ckpt_path = save_compact(config.log_path, 1, state)
        for beam in beams:
            config.update(infer_beam_size=beam)
            got, steps, wall, caps = counted_run(config, ckpt_path, batches,
                                                 kernels)
            want = expected_launches(kernels, steps, beam, inside)
            n_steps = steps.beam if beam > 1 else steps.greedy
            print(f"{phase} {name} beam {beam}: {len(caps)} captions in "
                  f"{wall:.2f} s through run_inference (first call "
                  f"included), {n_steps} decode steps, launches "
                  f"{dict(zip(names, got))} (expected "
                  f"{dict(zip(names, want))}); first caption "
                  f"{caps[0][:60]!r}")
            if len(caps) != n_images or not all(c.strip() for c in caps):
                raise AssertionError(
                    f"{phase} {name} beam {beam}: {len(caps)} captions for "
                    f"{n_images} images, {sum(not c.strip() for c in caps)}"
                    " empty")
            if n_steps <= 0 or got != want:
                raise AssertionError(f"{phase} {name} beam {beam}: launches "
                                     f"{got} over {n_steps} decode steps, "
                                     f"expected {want}")
            total = [t + g for t, g in zip(total, got)]
        config.update(infer_beam_size=3)
        params = tree_to(state, torch.device("cuda"))
        serve = make_serve_fn(spec, config, max_decode_steps(config, vocab),
                              collect_alignments=False)
        batch_ms = median_ms(lambda: serve(params, batches[0][0]), iters=3,
                             warmup=1)
        print(f"{phase} {name}: steady batch of {B} at beam 3 "
              f"{batch_ms:.2f} ms ({B / batch_ms * 1e3:.1f} captions/s)")
        del params, serve
        err, ids = card_vs_cpu(state, **fields)
        equal = torch.equal(ids["cuda"], ids["cpu"])
        print(f"{phase} {name} (float32, TF32 off, batch 2, beam 3): "
              f"attention memory max rel error {err:.2e} (tol "
              f"{TOL_ZOO:.0e}), top-beam ids "
              f"{'equal' if equal else 'DIFFER'} {tuple(ids['cpu'].shape)}")
        if err > TOL_ZOO or not equal:
            raise AssertionError(f"{phase} {name}: the card disagrees with "
                                 "the CPU")
        if name in xe:
            train_agree_phase(state, tag=f"{phase} {name} train-agree",
                              **fields)
        shutil.rmtree(config.log_path)
        print(f"{phase} {name}: {time.perf_counter() - t0:.1f} s")
    print(f"{phase}: every configuration passed in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return total


def zoo_native_phase(kernels):
    """Phase zoo-native: the ZOO_NATIVE nets at their own input sizes in
    bf16 with COMIC-256's decoder: seeded weights (smoke_weights) and
    ZOO_BATCHES batches of B seeded uint8 images drawn at that size,
    through make_serve_fn at beam 3; K1 must launch once on every beam
    step (0 K2) at L=289 or 441, and every caption hold words; the
    encoder and one steady batch are timed apart. The ZOO_NATIVE_AGREE
    nets also serve one batch greedy (K2 on every step) and are held card
    vs CPU in float32 at batch 2 (card_vs_cpu). ->
    {"k1": {L: launches}, "k2": {L: launches}}"""
    import torch

    from comic_tpu_torch.data.preprocessing import preprocess_for
    from comic_tpu_torch.decoding import search
    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import (build_model_spec,
                                                  max_decode_steps, tree_to)
    from comic_tpu_torch.tokenization import Vocabulary, ids_to_captions

    t_phase = time.perf_counter()
    names = [k.__name__ for k in kernels]
    out = {"k1": {}, "k2": {}}
    for name, size in ZOO_NATIVE.items():
        t0 = time.perf_counter()
        config = smoke_config(3, B, "bfloat16", name,
                              cnn_input_size=(size, size))
        vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
        spec = build_model_spec(config, vocab)
        state = smoke_weights(spec)
        params = tree_to(state, torch.device("cuda"))
        batches = image_batches(ZOO_BATCHES, B, size)
        preprocess = preprocess_for(name)

        @torch.inference_mode()
        def encode():
            return search._prepare_memory(params, spec, preprocess(
                batches[0][0], size, size, torch.device("cuda")))

        length, channels = (encode()[1].keys.shape[1],
                            spec.decoder.attention.memory_channels)
        enc_ms = median_ms(encode, iters=5, warmup=2)
        if length not in ZOO_NATIVE_L:
            raise AssertionError(f"zoo-native {name} at {size}: L={length}, "
                                 f"expected one of {ZOO_NATIVE_L}")
        for beam in ((3, 1) if name in ZOO_NATIVE_AGREE else (3,)):
            config.update(infer_beam_size=beam)
            serve = make_serve_fn(spec, config,
                                  max_decode_steps(config, vocab),
                                  collect_alignments=False)
            pipe = batches if beam > 1 else batches[:1]
            for k in kernels:
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            caps = []
            with DecodeSteps() as steps:
                t1 = time.perf_counter()
                for images, _ in pipe:
                    ids = serve(params, images)[0]
                    caps += ids_to_captions(ids.cpu().numpy(),
                                            config.token_type, vocab,
                                            config.radix_base)
                wall = time.perf_counter() - t1
            got = [k.launches for k in kernels]
            want = expected_launches(kernels, steps, beam, True)
            n_steps = steps.beam if beam > 1 else steps.greedy
            print(f"zoo-native {name} at {size}x{size} beam {beam}: "
                  f"L={length} ({spec.fm_endpoint}), C={channels}; "
                  f"{len(caps)} captions in {wall:.2f} s through "
                  f"make_serve_fn (first call included), {n_steps} decode "
                  f"steps, launches {dict(zip(names, got))}; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if len(caps) != len(pipe) * B or not all(caps):
                raise AssertionError(f"zoo-native {name} beam {beam}: "
                                     f"{sum(not c for c in caps)} empty "
                                     "captions")
            if n_steps <= 0 or got != want:
                raise AssertionError(f"zoo-native {name} beam {beam}: "
                                     f"launches {got} over {n_steps} decode "
                                     f"steps, expected {want}")
            key = "k1" if beam > 1 else "k2"
            out[key][length] = out[key].get(length, 0) + sum(got)
            if beam > 1:
                batch_ms = median_ms(lambda: serve(params, pipe[0][0]),
                                     iters=3, warmup=1)
                print(f"zoo-native {name}: steady batch of {B} at beam 3 "
                      f"{batch_ms:.2f} ms ({B / batch_ms * 1e3:.1f} "
                      f"captions/s), encoder {enc_ms:.2f} ms")
            del serve
        del params
        torch.cuda.empty_cache()
        if name in ZOO_NATIVE_AGREE:
            err, ids = card_vs_cpu(state, name, size)
            equal = torch.equal(ids["cuda"], ids["cpu"])
            print(f"zoo-native {name} at {size}x{size} (float32, TF32 off, "
                  f"batch 2, beam 3): attention memory max rel error "
                  f"{err:.2e} (tol {TOL_ZOO:.0e}), top-beam ids "
                  f"{'equal' if equal else 'DIFFER'}")
            if err > TOL_ZOO or not equal:
                raise AssertionError(f"zoo-native {name}: the card disagrees "
                                     "with the CPU")
        print(f"zoo-native {name}: {time.perf_counter() - t0:.1f} s")
    print(f"zoo-native: every net passed in "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    sys.path.insert(0, ROOT)
    from comic_tpu_torch.models.captioner import build_model_spec
    from comic_tpu_torch.ops import _cuda
    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1
    from comic_tpu_torch.tokenization import Vocabulary
    from comic_tpu_torch.training.checkpoints import save_compact

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _cuda.build()
    print(f"built {len(logs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        variant = ""
        for ln in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", ln)
            if entry:  # kernel<keys type, vector width>
                vec = re.search(r"Li(\d+)E", entry.group(1))
                variant = ("<bf16" if "bfloat16" in entry.group(1)
                           else "<f32") + f", {vec.group(1) if vec else '?'}>"
            if "registers" in ln or "spill" in ln:
                print(f"  {name}{variant}: {ln.strip()}")

    kernels = [k1.grouped_add_ln_attention, k2.fused_add_ln_attention]
    records = check_kernels()

    shutil.rmtree(OUT, ignore_errors=True)
    config = smoke_config(3, B, "bfloat16")
    spec = build_model_spec(config,
                            Vocabulary.from_str_itow(config.wtoi, config.itow))
    state = smoke_weights(spec)
    ckpt_path = save_compact(os.path.join(OUT, "exp"), 1, state)
    batches = image_batches(4, B)
    records["grouped_add_ln_attention"]["launches"] = serve_phase(
        3, k1.grouped_add_ln_attention, ckpt_path, batches)
    records["fused_add_ln_attention"]["launches"] = serve_phase(
        1, k2.fused_add_ln_attention, ckpt_path, batches)
    agreement_phase(state)

    # training: the decoder stage from the smoke weights' compact
    # checkpoint, then cnn_finetune from the decoder stage's directory
    dec_eval, dec = train_phase("decoder", DECODER_STEPS, ckpt_path, kernels)
    if not dec["tail"] < dec["head"] - LOSS_DROP:
        raise AssertionError(f"train-decoder: the XE loss did not fall by "
                             f"{LOSS_DROP}: {dec['losses']}")
    ft_eval, _ = train_phase("cnn_finetune", CNNFT_STEPS, None, kernels)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += dec_eval[i] + ft_eval[i]
    train_agree_phase(state)

    # the step tracer on the decoder stage, then the cost model on the
    # serve and train programs
    traced = trace_phase(ckpt_path, kernels)
    counted = cost_model_phase(ckpt_path, state, dec.pop("train_step"),
                               kernels, smi)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += traced[i] + counted[i]
        records[k.__name__]["trace_launches"] = traced[i]
        records[k.__name__]["cost_model_launches"] = counted[i]

    # SCST from the cnn_finetune stage's directory
    scst_launches = train_scst_phase(kernels)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += scst_launches[i]
        records[k.__name__]["scst_shape"]["launches"] = scst_launches[i]
    scst_agree_phase(state)

    # data parallelism: a world-1 NCCL job (agreement, the decoder stage,
    # SCST), serving split over the cards, and the dry run
    dec["ckpt_path"] = ckpt_path
    dp = dp_phases(kernels, dec)
    dp_serve = dp_serve_phase(kernels, ckpt_path, batches)
    dry = dryrun_phase(kernels)
    dp[0] += dp_serve
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += dp[i]
        records[k.__name__]["dp_launches"] = dp[i]
        records[k.__name__]["dryrun_launches"] = dry[i]

    # checkpoint evaluation through the infer CLI: the smoke weights and
    # the decoder stage's
    sweep = eval_sweep_phase(kernels, [ckpt_path, os.path.join(
        dec["log_path"], f"model_compact-{DECODER_STEPS}.msgpack")])
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += sum(v[i] for v in sweep.values())
        records[k.__name__]["eval_sweep_launches"] = {
            tag: v[i] for tag, v in sweep.items()}
    records["grouped_add_ln_attention"]["coco_shape"]["launches"] = \
        sweep["coco_valid_beam3"][0]
    eval_agree_phase(ckpt_path)

    # the overfit gate: caption quality after training, at full width
    gate, gate_parts, gate_run = overfit_gate_phase(kernels)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += gate[i]
        records[k.__name__]["gate_shape"]["launches"] = gate[i]
        records[k.__name__]["overfit_gate_launches"] = {
            part: v[i] for part, v in gate_parts.items()}

    # the port's parity gate on the overfit gate's trained directory
    parity = parity_gate_phase(kernels, gate_run, state)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += parity[i]
        records[k.__name__]["gate_shape"]["launches"] += parity[i]
        records[k.__name__]["parity_gate_launches"] = parity[i]

    # the encoder zoo: every encoder serving, one of each module card vs
    # CPU, and ResNet-50's cnn_finetune stage
    zoo = zoo_serve_phase(kernels)
    zoo_agree_phase(zoo["states"])
    zoo_eval = zoo_train_phase(zoo["states"][ZOO_TRAIN_NET], kernels)
    zoo["k2"][ZOO_TRAIN_L] = zoo["k2"].get(ZOO_TRAIN_L, 0) + zoo_eval[1]
    for k, by_length in zip(kernels, (zoo["k1"], zoo["k2"])):
        rec = records[k.__name__]
        rec["launches"] += sum(by_length.values())
        for length in ZOO_L:
            rec[f"zoo_L{length}"]["launches"] = by_length.get(length, 0)
        rec["zoo_launches_by_L"] = by_length
    records["grouped_add_ln_attention"]["zoo_serve_launches"] = zoo["serve"]

    # the bench's legs and beam_sweep at full width: K1 at B=BENCH_B with
    # K=3 and beam_sweep's K; K2 at R=BENCH_B (beam 1). The bench's other
    # batches run in python -m comic_tpu_torch.bench, not here
    benched, k1_bench_b, by_beam = bench_phase(kernels)
    k1_rec, k2_rec = (records[k.__name__] for k in kernels)
    for i, k in enumerate(kernels):
        records[k.__name__]["launches"] += benched[i]
        records[k.__name__]["bench_launches"] = benched[i]
    for rows in BENCH_BATCHES:
        k1_rec[f"bench_b{rows}"]["launches"] = (
            k1_bench_b if rows == BENCH_B else 0)
    for beam, n in by_beam.items():
        if beam == 1:
            k2_rec[f"bench_r{BENCH_B}"]["launches"] = n[kernels[1].__name__]
        else:
            k1_rec[f"bench_b{BENCH_B}_k{beam}"]["launches"] = n[
                kernels[0].__name__]

    # the configurations besides the main one: word and char tokens, the
    # LN_LSTM and GRU cells, attention inside and outside the kernels'
    # domain, and the zoo at its native 299 and 331 inputs
    variants = {
        "tokens-serve": variants_phase("tokens-serve", TOKEN_VARIANTS,
                                       kernels, VARIANT_BATCHES, (3, 1),
                                       xe=("word",)),
        "cells-serve": variants_phase("cells-serve", CELL_VARIANTS, kernels,
                                      VARIANT_BATCHES, (3, 1),
                                      xe=tuple(CELL_VARIANTS)),
        "attn-variants": variants_phase("attn-variants", ATTN_VARIANTS,
                                        kernels, 1, (3,))}
    native = zoo_native_phase(kernels)
    for i, k in enumerate(kernels):
        rec = records[k.__name__]
        rec["launches"] += sum(v[i] for v in variants.values())
        rec["variant_launches"] = {tag: v[i] for tag, v in variants.items()}
    for k, by_length in zip(kernels, (native["k1"], native["k2"])):
        rec = records[k.__name__]
        rec["launches"] += sum(by_length.values())
        for length in ZOO_NATIVE_L:
            rec[f"zoo_L{length}"]["launches"] = by_length.get(length, 0)
        rec["zoo_native_launches_by_L"] = by_length

    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-job"]:
        dp_job(*sys.argv[2:])
    else:
        main()
