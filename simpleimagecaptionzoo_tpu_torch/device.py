"""Device set-up for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: ``"cuda"``
is the default everywhere, and it raises when no CUDA device is present
instead of falling back.  This is also the one place that states the float32
matmul policy: the port's float32 products are float32-accurate, so a
float32 decode on the card computes what the float32 decode on the CPU
computes.  The library calls (cuBLAS, cuDNN) run with TF32 off, set here;
the float32 routes of kernels K1 and K2 run on the tensor cores as three
TF32 products each (3xTF32, ``ops/tf32.py``), those of K1 and K3 with an
int8 weight as two (2xTF32: the int8 weight is exact in TF32), which keeps
float32 accuracy; K4 and the CUDA-core routes that operands TMA cannot take
multiply on the CUDA cores in float32.
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
