"""PyTorch/CUDA port of the Synera serving system.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``configs``, ``models``, ``core``, ``serving``, ``kernels``)
and never imports it or JAX.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
