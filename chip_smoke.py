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
     memory and top-beam ids with the port's plain CPU path.

Phases 4 and 5 also time one steady batch and profile one more
(torch.profiler; the per-kernel table goes to smoke_out/profile_*.txt).

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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


def kernel_inputs(keys_dtype, rows, beams):
    """Seeded main-path inputs on the card; beams=None gives K2's (R, U)
    queries over per-row keys."""
    import torch

    g = torch.Generator().manual_seed(SEED)
    keys = torch.randn(rows, L, U, generator=g).to("cuda", keys_dtype)
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
    for name, beams in (("grouped_add_ln_attention", K),
                        ("fused_add_ln_attention", None)):
        worst = 0.0
        for keys_dtype in (torch.float32, torch.bfloat16):
            query, keys, mean, m2, vecs = kernel_inputs(keys_dtype, B, beams)
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
            print(f"{name} keys={str(keys_dtype)[6:]}: cluster of "
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
            worst = max(worst, *err.values())
        # times and bound at the main path's dtype (bf16 keys)
        ms, host_ms = device_ms(kern)
        plain_ms, plain_host_ms = device_ms(plain)
        n_q = B * (beams or 1)
        nbytes = (query.numel() * 4 + keys.numel() * keys.element_size()
                  + sum(v.numel() * 4 for v in vecs)
                  + (2 * B * L * 4 if beams else 0)  # key moments
                  + n_q * U * 4 + n_q * H * L * 4)  # ctx, align written
        ops = OPS_PER_ELEMENT[name] * n_q * L * U
        sfu = n_q * L * U + n_q * H * L  # tanh, softmax exp
        times = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "float32 operations": ops / F32_FLOP_PER_S * 1e3,
                 "special-function operations": sfu / SFU_OPS_PER_S * 1e3}
        bound_by = max(times, key=times.get)
        records[name] = {
            "name": name, "route": "cuda",
            "source": f"comic_tpu_torch/csrc/{name}.cu",
            "replaces": ("comic_tpu/ops/grouped_attention.py:89" if beams
                         else "comic_tpu/ops/fused_attention.py:69"),
            "launches": 0, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": times[bound_by],
            "bound_by": "bytes" if bound_by == "bytes" else "operations",
            "library_ms": None,  # no single PyTorch call is add_LN attention
        }
        print(f"{name}: {ms:.4f} ms on the card (plain {plain_ms:.4f} ms, "
              f"bound {times[bound_by] * 1e3:.2f} us by {bound_by}: "
              f"{nbytes / 1e6:.2f} MB in {times['bytes'] * 1e3:.2f} us, "
              f"{ops / 1e6:.1f} MFLOP in "
              f"{times['float32 operations'] * 1e3:.2f} us, {sfu / 1e6:.2f} M"
              f" tanh/exp in "
              f"{times['special-function operations'] * 1e3:.2f} us); host "
              f"time to launch one call {host_ms:.4f} ms (plain "
              f"{plain_host_ms:.4f} ms)")
    return records


def smoke_config(beam: int, batch: int, dtype: str):
    """Full-width COMIC-256 serving config with a COCO-sized vocabulary
    (10,000 words: 2 radix digits per word, 60 decode steps)."""
    from comic_tpu_torch.configuration import Config

    wtoi = {"<PAD>": -1}
    wtoi.update({f"w{i}": i for i in range(10000)})
    wtoi.update({"<UNK>": 10000, "<GO>": 10001, "<EOS>": 10002})
    itow = {str(i): w for w, i in wtoi.items()}
    return Config(wtoi=wtoi, itow=itow, log_path=os.path.join(OUT, "exp"),
                  batch_size_infer=batch, infer_beam_size=beam,
                  compute_dtype=dtype, infer_early_exit=True)


def smoke_weights(spec):
    """Seeded port init with BN statistics perturbed and the output
    projection spread, on the CPU."""
    import torch

    from comic_tpu_torch.models.captioner import init_params

    g = torch.Generator().manual_seed(SEED)
    params = init_params(spec, generator=g, device="cpu")

    def walk(d):
        for key, v in d.items():
            if key == "BatchNorm":
                n = v["beta"].shape[0]
                v["beta"] += 0.1 * torch.randn(n, generator=g)
                v["moving_mean"] += 0.1 * torch.randn(n, generator=g)
                v["moving_variance"] *= 1 + 0.2 * torch.rand(n, generator=g)
            elif isinstance(v, dict):
                walk(v)

    walk(params)
    proj = params["decoder"]["output_projection"]
    proj["kernel"] *= 4
    # favour the leading digits of the 10,000 word ids so captions hold words
    proj["bias"][:40] = 2.0
    return params


def image_batches(n_batches, batch):
    import numpy as np

    rng = np.random.default_rng(SEED)
    out = []
    for i in range(n_batches):
        imgs = rng.integers(0, 256, (batch, 256, 256, 3), dtype=np.uint8)
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


def agreement_phase(ckpt_state):
    """Phase 6: float32, TF32 off, batch 2: card vs plain CPU path."""
    import torch

    from comic_tpu_torch.data.preprocessing import preprocess_batch
    from comic_tpu_torch.decoding import search
    from comic_tpu_torch.inference import make_serve_fn
    from comic_tpu_torch.models.captioner import build_model_spec, tree_to
    from comic_tpu_torch.tokenization import Vocabulary

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    config = smoke_config(3, 2, "float32")
    vocab = Vocabulary.from_str_itow(config.wtoi, config.itow)
    spec = build_model_spec(config, vocab)
    images = image_batches(1, 2)[0][0]
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_to(ckpt_state, torch.device(dev))
        serve = make_serve_fn(spec, config, 60, collect_alignments=False,
                              device=dev)
        with torch.inference_mode():
            _, memory = search._prepare_memory(
                params, spec, preprocess_batch(images, 224, 224,
                                               torch.device(dev)))
        out[dev] = (memory.keys.cpu(), serve(params, images)[0].cpu())
    keys_err = ((out["cuda"][0] - out["cpu"][0]).abs().max()
                / out["cpu"][0].abs().max()).item()
    same = (out["cuda"][1] == out["cpu"][1]).float().mean().item()
    rows = (out["cuda"][1] == out["cpu"][1]).all(dim=1).sum().item()
    print(f"float32 card vs CPU plain path: attention keys max rel error "
          f"{keys_err:.2e} (tol 1e-4); top-beam ids agree at {same:.1%} of "
          f"positions, {rows}/2 captions identical")
    if keys_err > 1e-4:
        raise AssertionError("card and CPU encoders disagree")


def main():
    import torch

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

    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
