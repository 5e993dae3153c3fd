"""PyTorch/CUDA port of ``tera_mind_tpu`` for NVIDIA Hopper (H100).

Same module layout and names as the JAX package, channels-last
``(B, Z, H, W, C)`` at every public function.  It imports torch and numpy
only, never jax, flax or ``tera_mind_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; there the kernel wrappers use
their plain PyTorch versions.
"""

__version__ = "0.1.0"
