"""Attention visualization (reference Utils.py:370-432).

* :func:`visualize_att` — per-word spatial heatmap overlay: the (T, 49)
  attention alphas from the decode scan are reshaped to the encoder grid and
  upsampled over the image (the reference uses skimage
  ``pyramid_expand(upscale=24)``; bicubic PIL resize gives the equivalent
  smooth overlay without the skimage dependency).
* :func:`visualize_att_bboxes` — per-word box-alpha painting for
  Detection-variant models: each word's strongest bottom-up boxes are drawn
  with brightness proportional to attention weight.

Both render with matplotlib (host-side, offline) and save a png when
``save_path`` is given.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def _grid(n_words: int):
    cols = 5
    rows = int(np.ceil((n_words + 1) / cols))
    return rows, cols


def visualize_att(image: np.ndarray, alphas: np.ndarray, caption: List[str],
                  grid_side: int = 7, save_path: Optional[str] = None):
    """image (H, W, 3) uint8; alphas (T, grid_side**2); caption: T words."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    words = ["<sta>"] + list(caption)
    rows, cols = _grid(len(words))
    fig = plt.figure(figsize=(cols * 3, rows * 3))
    h, w = image.shape[:2]
    for t, word in enumerate(words):
        ax = fig.add_subplot(rows, cols, t + 1)
        ax.text(0, 1, word, color="black", backgroundcolor="white",
                fontsize=12)
        ax.imshow(image)
        if t > 0 and t - 1 < alphas.shape[0]:
            a = np.asarray(alphas[t - 1], np.float32).reshape(grid_side,
                                                              grid_side)
            a_img = np.asarray(Image.fromarray(a, mode="F").resize(
                (w, h), Image.BICUBIC))
            ax.imshow(a_img, alpha=0.6, cmap="Greys_r")
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return fig


def visualize_att_bboxes(image: np.ndarray, alphas: np.ndarray,
                         bboxes: np.ndarray, caption: List[str],
                         save_path: Optional[str] = None):
    """image (H, W, 3) uint8; alphas (T, N); bboxes (N, 4) in original image
    coordinates (x1, y1, x2, y2); caption: T words."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    words = ["<sta>"] + list(caption)
    rows, cols = _grid(len(words))
    fig = plt.figure(figsize=(cols * 3, rows * 3))
    n = min(len(bboxes), alphas.shape[-1]) if alphas is not None else len(bboxes)
    for t, word in enumerate(words):
        ax = fig.add_subplot(rows, cols, t + 1)
        ax.text(0, 1, word, color="black", backgroundcolor="white",
                fontsize=12)
        ax.imshow(image)
        if alphas is not None and t > 0 and t - 1 < alphas.shape[0]:
            a = np.asarray(alphas[t - 1][:n], np.float32)
            top = np.argsort(a)[::-1][:3]
            for bi in top:
                x1, y1, x2, y2 = bboxes[bi][:4]
                rect = patches.Rectangle(
                    (x1, y1), x2 - x1, y2 - y1, linewidth=2,
                    edgecolor="r", facecolor="none",
                    alpha=float(np.clip(a[bi] / max(a.max(), 1e-9), 0.1, 1.0)))
                ax.add_patch(rect)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    plt.close(fig)
    return fig
