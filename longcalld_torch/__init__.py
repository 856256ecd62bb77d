"""PyTorch + CUDA port of longcalld_tpu.

The JAX package (longcalld_tpu) stays the reference.  This package owns
all it runs: the modules that pick a device, the hand-written Hopper
kernels (csrc/*.cu), and its own copies of the host modules (io, the
native C sources under native/, the host aligner, core, utils), so that
it imports nothing of longcalld_tpu and nothing of jax.
"""
