"""Command-line entry points: training (python -m comic_tpu_torch.cli.train)
and checkpoint evaluation (python -m comic_tpu_torch.cli.infer)."""

import os


def refuse_distributed_launch() -> None:
    """comic_tpu's CLIs join one data-parallel job across hosts when
    ``COMIC_COORDINATOR`` is set (comic_tpu/parallel/distributed.py). The
    port runs one process on one card, so under such a launch every host
    would run the whole job alone, into the same directory: refuse before
    any config, checkpoint or file is touched."""
    if os.environ.get("COMIC_COORDINATOR"):
        raise NotImplementedError(
            "COMIC_COORDINATOR is set, but data parallelism across "
            "processes (ROADMAP.md item 16) is not yet ported to "
            "comic_tpu_torch; unset it to run in one process on one card.")
