"""Stand-alone tools (`python -m baseboostdepth_tpu_torch.tools.pallas_probe`)."""
