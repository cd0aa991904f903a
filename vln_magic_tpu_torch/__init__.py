"""vln_magic_tpu_torch — the MAGIC navigator in PyTorch for NVIDIA Hopper.

A port of ``vln_magic_tpu`` (JAX on TPU), which stays in the repository as
the reference.  This package imports torch and numpy only.  It covers
evaluation (``agent.navigator.Navigator.evaluate``), MAKD + ICoD DAgger
training (``agent.trainer.Trainer``), proxy-task pretraining
(``pretrain.trainer.PretrainTrainer``, ``cli.train_pretrain``) with the
``.pt`` checkpoints that carry its trunk into fine-tuning
(``utils.checkpoint``), and online serving (``agent.NavServer``,
``agent.NavFleet``), with the attention kernels hand-written in CUDA
(``ops.attention``).

Entry points take ``device`` (default ``"cuda"``) and raise when no GPU is
present unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
