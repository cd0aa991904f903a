"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the default everywhere in the port) needs a GPU and raises
    without one; the CPU runs only when the caller asks for it.  Choosing a
    CUDA device also turns TF32 off for matmuls and cuDNN: the rollout
    compares f32 values against the ``UNOBS = 2e6`` sentinel and pins f32
    parity with the reference, and TF32's 10-bit mantissa rounds both away.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
