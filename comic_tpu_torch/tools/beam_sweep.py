"""Serving beam-size sweep at batch 128; the port's counterpart of
tools/beam_sweep.py.

    python -m comic_tpu_torch.tools.beam_sweep [k1 k2 ...] [--device cuda]

Beams 3, 1, 2, 5 and 7 by default (COMIC-256, the real 9,962-word
vocabulary, an unreachable EOS, 60 steps, length penalty 0), each through
``bench._make_serve`` with the config's ``infer_beam_size`` set: beam 1
takes the greedy path (K2 on 128 rows), the others the beam search (K1 at
B=128 with K beams over each image's one copy of the keys). A batch sweep
moves the attention memory's size; a beam sweep moves only the rows of
the decode step. One JSON line a beam on stdout (with its K1 and K2
launches a call), a line on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator, Sequence

import numpy as np

from .. import resolve_device
from ..bench import (_images, _make_serve, _pipelined_ms, _with,
                     flagship_model, kernel_launches, launches_since,
                     worst_case)
from ..models.captioner import max_decode_steps

BEAMS = (3, 1, 2, 5, 7)


def sweep(config, spec, params, vocab, device, beams: Sequence[int],
          batch: int = 128, iters: int = 30, warmup: int = 2,
          rounds: int = 2) -> Iterator[dict]:
    """One row a beam size (printed as it is measured)."""
    steps = max_decode_steps(config, vocab)
    serve_spec = worst_case(spec)
    images_u8 = _images(np.random.default_rng(0), (batch, 256, 256, 3),
                        device)
    calls = warmup + rounds * iters
    for k in beams:
        serve = _make_serve(_with(config, infer_beam_size=k), serve_spec,
                            steps, device, lpen=0.0)
        before = kernel_launches()
        ms = _pipelined_ms(serve, (params, images_u8), iters, device, warmup,
                           rounds)
        launches = {n: c / calls for n, c in launches_since(before).items()}
        cps = batch / (ms / 1e3)
        row = {"beam": k, "rows": batch * k, "serve_ms": round(ms, 2),
               "captions_per_s": round(cps, 1),
               "launches_per_call": launches}
        print(json.dumps(row), flush=True)
        print(f"beam {k}: {ms:.2f} ms  {cps:.1f} captions/s "
              f"({batch * k} rows)", file=sys.stderr, flush=True)
        yield row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("beams", type=int, nargs="*", default=list(BEAMS))
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return list(sweep(*flagship_model(device), device, args.beams))


if __name__ == "__main__":
    main()
