"""Command-line entry points: training (python -m comic_tpu_torch.cli.train)
and checkpoint evaluation (python -m comic_tpu_torch.cli.infer). Both join
a data-parallel job right after parsing when ``COMIC_COORDINATOR`` is set
(parallel/distributed.py)."""
