"""PyTorch + CUDA port of the sls_tpu anti-spoofing detector.

The JAX package ``sls_tpu`` is the reference; this package keeps its
module paths, public names and tensor layouts so that each function here
has a counterpart there.  Hand-written Hopper kernels (``kernels/``)
stand where the reference has Pallas kernels.  Entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""
