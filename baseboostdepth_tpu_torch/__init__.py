"""BaseBoostDepth in PyTorch, for one NVIDIA H100.

The PyTorch counterpart of `baseboostdepth_tpu`, module for module: the same
names and layout (`geometry`, `losses`, `ops/sampling.py`, `models/resnet.py`,
`training/step.py`, ...), the same numbers. Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas becomes a hand-written CUDA
kernel under `ops/csrc/`, built with `nvcc` at first use.

The package imports torch, numpy and the standard library only -- never jax
and never `baseboostdepth_tpu` -- so it runs on a machine without JAX.
Entry points default to `device="cuda"` and raise when no GPU is present;
callers (the CPU tests) ask for `device="cpu"` explicitly, and then every
kernel runs as its plain PyTorch version.
"""

__version__ = "0.1.0"
