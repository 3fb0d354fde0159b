"""Command-line entry points (`python -m baseboostdepth_tpu_torch.cli.train`)."""
