"""Serving batch-size sweep: which layer sets the cost per caption as the
batch grows; the port's counterpart of tools/batch_sweep.py.

    python -m comic_tpu_torch.tools.batch_sweep [b1 b2 ...] [--device cuda]

For each batch, three nested programs on the card (COMIC-256, the real
9,962-word vocabulary, beam 3, an unreachable EOS, 60 steps):

  serve_total  uint8 images -> preprocess -> encoder -> 60-step beam
               search (``bench._make_serve``: bench_serving's program)
  decode_only  ``decoding.search.beam_search_from_memory`` on the encoder
               outputs and attention memory already on the card
  attn_only    60 bare ``models.attention.attend_grouped`` steps on the
               same memory, inside the kernel's domain: 60 launches of K1

serve - decode is the encoder and preprocessing, decode - attn the beam
bookkeeping and the LSTM, attn the attention. One JSON line a batch on
stdout (with each program's K1 launches a call); a table on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Iterator, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..bench import (_images, _make_serve, _pipelined_ms, flagship_model,
                     kernel_launches, launches_since, worst_case)
from ..data.preprocessing import preprocess_for
from ..decoding.search import _prepare_memory, beam_search_from_memory
from ..models.attention import attend_grouped
from ..models.captioner import max_decode_steps

BATCHES = (64, 112, 128, 136, 144, 160, 192, 256)


@torch.inference_mode()
def attn_only(p_attn, acfg, query0: torch.Tensor, memory, steps: int,
              dtype) -> torch.Tensor:
    """``steps`` attention steps chained through tanh of the context (the
    query's own width): the decode step's attention alone."""
    q = query0
    for _ in range(steps):
        ctx, _ = attend_grouped(p_attn, acfg, q, memory, dtype=dtype)
        q = torch.tanh(ctx).to(q.dtype)
    return q


def sweep(config, spec, params, vocab, device, batches: Sequence[int],
          iters: int = 30, warmup: int = 2, rounds: int = 2
          ) -> Iterator[dict]:
    """One row a batch (printed as it is measured)."""
    beam = int(config.infer_beam_size)
    steps = max_decode_steps(config, vocab)
    serve_spec = worst_case(spec)
    dcfg = serve_spec.decoder
    dtype = serve_spec.compute_dtype
    h, w = config.cnn_input_size
    preprocess = preprocess_for(config.cnn_name)
    serve = _make_serve(config, serve_spec, steps, device)
    dec_p = params["decoder"]
    rng = np.random.default_rng(0)

    @torch.inference_mode()
    def decode_only(im_embed, memory):
        top, _ = beam_search_from_memory(
            dec_p, serve_spec, im_embed, memory, beam_size=beam,
            max_steps=steps, length_penalty=0.0, collect_alignments=False,
            early_exit=True)
        return top.ids

    calls = warmup + rounds * iters
    for batch in batches:
        images_u8 = _images(rng, (batch, 256, 256, 3), device)
        row = {"batch": batch, "rows": batch * beam, "steps": steps}
        launches = {}
        t0 = time.perf_counter()

        def timed(name, fn, *args):
            before = kernel_launches()
            ms = _pipelined_ms(fn, args, iters, device, warmup, rounds)
            launches[name] = (launches_since(before)[
                "grouped_add_ln_attention"] / calls)
            return ms

        ms = timed("serve", serve, params, images_u8)
        row["serve_ms"] = round(ms, 2)
        row["captions_per_s"] = round(batch / (ms / 1e3), 1)
        with torch.inference_mode():
            im_embed, memory = _prepare_memory(
                params, serve_spec, preprocess(images_u8, h, w, device))
        row["decode_ms"] = round(timed("decode", decode_only, im_embed,
                                       memory), 2)
        query0 = torch.as_tensor(
            rng.standard_normal((batch, beam, dcfg.rnn_size)),
            dtype=torch.float32).to(device)
        ms = timed("attn", attn_only, dec_p["attention"], dcfg.attention,
                   query0, memory, steps, dtype)
        row["attn_ms"] = round(ms, 2)
        row["attn_us_per_step"] = round(ms * 1e3 / steps, 1)
        row["k1_launches_per_call"] = launches
        row["compile_and_measure_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(row), flush=True)
        print(f"b{batch:<4} rows {batch * beam:<4} serve {row['serve_ms']:>7}"
              f" decode {row['decode_ms']:>7} attn {row['attn_ms']:>6} ms "
              f"({row['captions_per_s']} cap/s)", file=sys.stderr,
              flush=True)
        yield row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return list(sweep(*flagship_model(device), device, args.batches))


if __name__ == "__main__":
    main()
