"""Quick end-to-end serve measurement at one batch; the port's counterpart
of tools/serve_check.py.

    python -m comic_tpu_torch.tools.serve_check [batch] [--device cuda]

The worst-case serving program of ``bench.bench_serving`` (the real
9,962-word vocabulary, an unreachable EOS, 60 decode steps at beam 3)
through ``bench._make_serve`` and ``bench._pipelined_ms``, at one batch
(default 128): a check that a change to the encoder or the decode loop
shows in the whole serve.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..bench import (_images, _make_serve, _pipelined_ms, flagship_model,
                     worst_case)
from ..models.captioner import max_decode_steps


def serve_ms(config, spec, params, vocab, device, batch: int,
             iters: int = 50, warmup: int = 2, rounds: int = 2) -> float:
    """ms of one worst-case serve of ``batch`` images (best round)."""
    steps = max_decode_steps(config, vocab)
    serve = _make_serve(config, worst_case(spec), steps, device)
    images_u8 = _images(np.random.default_rng(0), (batch, 256, 256, 3),
                        device)
    ms = _pipelined_ms(serve, (params, images_u8), iters, device, warmup,
                       rounds)
    print(f"serve b{batch}, {steps} steps: {ms:.2f} ms  "
          f"({batch / (ms / 1e3):.0f} captions/s)")
    return ms


def main(argv=None) -> float:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("batch", type=int, nargs="?", default=128)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return serve_ms(*flagship_model(device), device, args.batch)


if __name__ == "__main__":
    main()
