"""Command-line entry points: training (python -m comic_tpu_torch.cli.train)."""
