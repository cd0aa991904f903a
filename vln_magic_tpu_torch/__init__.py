"""vln_magic_tpu_torch — the MAGIC navigator in PyTorch for NVIDIA Hopper.

A port of ``vln_magic_tpu`` (JAX on TPU), which stays in the repository as
the reference.  This package imports torch and numpy only.  The first slice
covers greedy evaluation (``agent.Navigator.evaluate``) with packed-head
attention as a hand-written CUDA kernel (``ops.attention``).

Entry points take ``device`` (default ``"cuda"``) and raise when no GPU is
present unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
