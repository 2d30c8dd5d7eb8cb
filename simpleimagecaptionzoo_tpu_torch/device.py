"""Device set-up for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: ``"cuda"``
is the default everywhere, and it raises when no CUDA device is present
instead of falling back.  This is also the one place that states the float32
matmul policy: full float32 (no TF32), so a float32 decode on the card
computes what the float32 decode on the CPU computes.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
