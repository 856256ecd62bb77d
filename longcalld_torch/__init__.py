"""PyTorch + CUDA port of longcalld_tpu.

The JAX package (longcalld_tpu) stays the reference.  This package owns
the modules that pick a device and the hand-written Hopper kernels
(csrc/*.cu); every host-only module (io, native C, the host aligner, most
of core) is imported from longcalld_tpu unchanged.  Nothing here imports
jax.
"""
