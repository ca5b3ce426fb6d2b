"""Phase times of the add_LN attention kernels K1 and K2 on the card.

    python3 -m comic_tpu_torch.tools.kernel_phases

Times each kernel through its wrapper at the main path's shapes (B=25,
K=3 / R=25, L=196, U=512, H=8, bf16 keys), then builds a copy of both with
-DADDLN_PHASES (a block barrier and a global-timer read at each phase
boundary of csrc/add_ln_common.cuh), runs it after a warm-up and prints the
median over the blocks of each phase's time. The barriers add a little
time, so the shipped kernel's device time per launch is printed beside the
traced total.
"""

from __future__ import annotations

import ctypes
import statistics

B, K, L, U, H = 25, 3, 196, 512, 8
SEED = 20260
PHASES = ("stage", "statistics", "scores", "softmax statistics + barrier",
          "combine + normalise", "context", "context push + barrier",
          "final sum")


def device_us(fn, calls=20, reps=7):
    """Median device us per call, the card held in a spin kernel while the
    host queues the calls (as chip_smoke.py times the kernels)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls * 1e3)
    return statistics.median(out)


def main():
    import torch

    from comic_tpu_torch.ops import _cuda
    from comic_tpu_torch.ops import fused_attention as k2
    from comic_tpu_torch.ops import grouped_attention as k1

    if not torch.cuda.is_available():
        raise SystemExit("kernel_phases: no CUDA device")
    g = torch.Generator().manual_seed(SEED)
    keys = torch.randn(B, L, U, generator=g).to("cuda", torch.bfloat16)
    query = torch.randn(B, K, U, generator=g).cuda()
    q1 = query[:, 0].contiguous()
    vecs = [(torch.rand(U, generator=g) - 0.5).cuda() * 0.2,
            1.0 + 0.3 * torch.randn(U, generator=g).cuda(),
            0.3 * torch.randn(U, generator=g).cuda(),
            torch.tensor(5.0).cuda()]
    k32 = keys.float()
    mean, m2 = k32.mean(-1), k32.square().mean(-1)
    runs = {
        "grouped_add_ln_attention": (
            lambda: k1.grouped_add_ln_attention(query, keys, mean, m2, *vecs,
                                                num_heads=H),
            k1.grouped_add_ln_attention_plan(keys, K, num_heads=H)),
        "fused_add_ln_attention": (
            lambda: k2.fused_add_ln_attention(q1, keys, *vecs, num_heads=H),
            k2.fused_add_ln_attention_plan(keys, num_heads=H)),
    }
    shipped = {name: device_us(run) for name, (run, _) in runs.items()}

    _cuda.DEFINES = ("-DADDLN_PHASES",)
    _cuda.build()
    marks = len(PHASES) + 1
    for name, (run, plan) in runs.items():
        grid = plan["grid"]
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        run()
        torch.cuda.synchronize()
        table = (ctypes.c_uint64 * (grid * marks))()
        read = _cuda.kernel(name, [_cuda.P, _cuda.I, _cuda.I],
                            entry="addln_read_phases")
        if read(table, grid, marks):
            raise RuntimeError("could not read the phase table")
        rows = [table[b * marks:(b + 1) * marks] for b in range(grid)]
        per_phase = [statistics.median(r[i + 1] - r[i] for r in rows) / 1e3
                     for i in range(len(PHASES))]
        total = statistics.median(r[-1] - r[0] for r in rows) / 1e3
        print(f"{name}: cluster of {plan['cluster']}, grid {grid}; shipped "
              f"kernel {shipped[name]:.2f} us a launch; traced block, median "
              f"over {grid} blocks: " + ", ".join(
                  f"{p} {t:.2f}" for p, t in zip(PHASES, per_phase))
              + f"; total {total:.2f} us")


if __name__ == "__main__":
    main()
