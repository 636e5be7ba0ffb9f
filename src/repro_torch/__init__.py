"""PyTorch / CUDA port of the DISTFLASHATTN reproduction.

The package mirrors the JAX reference layout (``core/``, ``kernels/``,
``models/``, ``serve/``, ``launch/``) so each module has an obvious
counterpart.  It imports ``torch`` and never ``jax``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper runs its plain PyTorch version, on a CUDA tensor it launches its
hand-written Hopper kernel (``kernels/csrc/``) or raises.
"""
