"""Command-line entry points:

  python -m baseboostdepth_tpu_torch.cli.train          (reference train.py)
  python -m baseboostdepth_tpu_torch.cli.evaluate_depth (reference evaluate_depth.py)
  python -m baseboostdepth_tpu_torch.cli.evaluate_pose  (reference evaluate_pose.py)
  python -m baseboostdepth_tpu_torch.cli.infer          (reference test_simple.py)
  python -m baseboostdepth_tpu_torch.cli.visualize      (reference validation.py)
  python -m baseboostdepth_tpu_torch.cli.export_gt      (reference export_gt_depth.py)
"""
