"""Device-side image preprocessing.

Counterpart of the JAX package's ``ops/image.py``.  The host ships uint8
NHWC batches; scaling to [0, 1] and the ImageNet normalization run on the
device, in float32.  Fast ingest goes further: the host stops at a scaled
JPEG decode and ships each image top-left in a static (pad, pad, 3) uint8
box with its true (h, w); :func:`resize_normalize` finishes the resample on
the device as two batched products with per-image triangle weights
(Pillow BILINEAR's window, in float weights), fused with the normalization.

Plain PyTorch: none of this reaches a Pallas kernel in the JAX package.
"""
from __future__ import annotations

import torch

# torchvision ImageNet constants (reference Utils.py get_transform)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the fast-ingest pad box at the default 224 (JAX data/datasets.py
# INGEST_PAD): holds any DCT-scaled decode of a typical photo
INGEST_PAD = 512


def _mean_std(device):
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (or float in [0, 255]) NHWC -> normalized float32 NHWC."""
    mean, std = _mean_std(images.device)
    return (images.float() / 255.0 - mean) / std


def maybe_normalize(images: torch.Tensor) -> torch.Tensor:
    """A uint8 batch is normalized here; a float batch is taken as already
    normalized and passes unchanged."""
    if images.dtype == torch.uint8:
        return normalize(images)
    return images


def _axis_weights(in_size: torch.Tensor, out_size: int,
                  pad: int) -> torch.Tensor:
    """(B, out_size, pad) float32 triangle-resample weights for one axis of
    B sources whose true extents ``in_size`` (B,) sit in a ``pad`` box.

    Pillow BILINEAR's precompute_coeffs (Resample.c): centre (j + 0.5) *
    scale, support max(scale, 1), window [floor(centre - support + 0.5),
    floor(centre + support + 0.5)) clipped to the true extent, weights
    normalized over the window.  Every column outside the window, all
    those past ``in_size`` included, is exactly 0."""
    in_f = in_size.to(torch.float32)[:, None, None]              # (B,1,1)
    scale = in_f / out_size
    filterscale = torch.clamp(scale, min=1.0)
    dev = in_size.device
    j = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    i = torch.arange(pad, dtype=torch.float32, device=dev)[None, None, :]
    center = (j + 0.5) * scale
    lo = torch.clamp(torch.floor(center - filterscale + 0.5), min=0.0)
    hi = torch.minimum(torch.floor(center + filterscale + 0.5), in_f)
    w = torch.clamp(1.0 - torch.abs(i + 0.5 - center) / filterscale, min=0.0)
    w = torch.where((i >= lo) & (i < hi), w, torch.zeros((), device=dev))
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-12)


def resize_normalize(padded: torch.Tensor, hw: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """Fast-ingest batches: (B, pad, pad, 3) uint8 boxes, each image
    top-left, and their true extents ``hw`` (B, 2) -> normalized float32
    (B, out_size, out_size, 3).

    Two batched products with the weights of :func:`_axis_weights`, rows
    then columns.  The box past each image's extent is don't-care: it is
    zeroed before the products, so not even a NaN there (a float box) can
    reach the output through a zero weight."""
    b, ph, pw, _ = padded.shape
    dev = padded.device
    h, w = hw[:, 0], hw[:, 1]
    rows = torch.arange(ph, device=dev)[None, :, None, None] < h[:, None,
                                                                 None, None]
    cols = torch.arange(pw, device=dev)[None, None, :, None] < w[:, None,
                                                                 None, None]
    x = torch.where(rows & cols, padded.float(),
                    torch.zeros((), device=dev))
    v = _axis_weights(h, out_size, ph)                          # (B, o, p)
    u = _axis_weights(w, out_size, pw)                          # (B, o, q)
    tmp = torch.einsum("bop,bpqc->boqc", v, x)
    out = torch.einsum("bwq,boqc->bowc", u, tmp)
    mean, std = _mean_std(dev)
    return (out / 255.0 - mean) / std


def prepare_images(visual: dict, out_size: int = 224) -> torch.Tensor:
    """The image input of the from-pixels families: a plain batch
    (``img_tensors`` (B, S, S, 3)) is normalized; a fast-ingest batch (with
    ``img_hw``) is resampled to ``out_size`` and normalized."""
    if "img_hw" in visual:
        return resize_normalize(visual["img_tensors"], visual["img_hw"],
                                out_size)
    return maybe_normalize(visual["img_tensors"])
