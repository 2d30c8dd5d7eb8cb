"""Analytic model FLOPs for the roofline numbers of a bench (the JAX
package's ``utils/flops.py``, the same counts on the port's
``ModelConfig``).

The counts are matmul-dominated (2*M*N*K per matmul; elementwise and
softmax terms are left out: they are bandwidth, not FLOPs) and can be
checked line by line against the model code.  They are independent of the
device and of the route a kernel takes: a 3xTF32 product counts once, as
the float32 product it computes.

Backward pass ~ 2x forward (dL/dW and dL/dx each cost one forward-sized
matmul set), so a train step counts 3x its forward.
"""
from __future__ import annotations

from simpleimagecaptionzoo_tpu_torch.config import ModelConfig


def _mm(m: float, n: float, k: float) -> float:
    return 2.0 * m * n * k


def _lstm(rows: float, in_dim: int, hidden: int) -> float:
    return _mm(rows, 4 * hidden, in_dim) + _mm(rows, 4 * hidden, hidden)


def encode_flops(cfg: ModelConfig, batch: int, n_feat: int) -> float:
    """Visual encode, EXCLUDING any CNN backbone (the benches feed
    precomputed features, as does the Detection path)."""
    e, d, h = cfg.enc_dim, cfg.hidden_dim, cfg.num_heads
    if cfg.model_type == "NIC":
        # img_embed + the step(-1) LSTM warmup (models/nic.py init_state)
        return (_mm(batch, cfg.embed_dim, e)
                + _lstm(batch, cfg.embed_dim, cfg.hidden_dim))
    if cfg.model_type.startswith("BUTD"):
        # hoisted att_enc keys (models/butd.py encode)
        return _mm(batch * n_feat, cfg.atten_dim, e)
    # AoA: projection + refiner + hoisted decoder K/V (models/aoa.py encode)
    del h
    proj = _mm(batch * n_feat, d, e)
    per_layer = (3 * _mm(batch * n_feat, d, d)          # q/k/v
                 + 2 * _mm(batch, n_feat * n_feat, d)   # scores + attn@V
                 + _mm(batch * n_feat, 2 * d, 2 * d))   # aoa GLU linear
    kv_hoist = 2 * _mm(batch * n_feat, d, d)
    return proj + cfg.num_refine_layers * per_layer + kv_hoist


def step_flops(cfg: ModelConfig, rows: float, n_feat: int) -> float:
    """One decode step for ``rows`` lanes (B for greedy/rollout, B*k for
    beam)."""
    e, d, a, v = cfg.embed_dim, cfg.hidden_dim, cfg.atten_dim, cfg.vocab_size
    enc = cfg.enc_dim
    if cfg.model_type == "NIC":
        return _lstm(rows, e, d) + _mm(rows, v, d)
    if cfg.model_type.startswith("BUTD"):
        return (_lstm(rows, e + enc + d, d)             # TD attention LSTM
                + _mm(rows, a, d)                       # att_dec
                + _mm(rows * n_feat, 1, a)              # affine scores
                + _mm(rows, enc, n_feat)                # attention-weighted sum
                + _lstm(rows, enc + d, d)               # language LSTM
                + _mm(rows, v, d))                      # predict
    return (_lstm(rows, e + d, d)                       # AoA decoder LSTM
            + _mm(rows, d, d)                           # q projection
            + 2 * _mm(rows, n_feat, d)                  # scores + attn@V
            + _mm(rows, 2 * d, 2 * d)                   # aoa GLU linear
            + _mm(rows, v, d))                          # predict


def decode_flops(cfg: ModelConfig, batch: int, n_feat: int, steps: int,
                 beam: int = 1) -> float:
    """Greedy (beam=1) or beam decode: encode once, step x steps."""
    return (encode_flops(cfg, batch, n_feat)
            + steps * step_flops(cfg, batch * beam, n_feat))


def xe_train_flops(cfg: ModelConfig, batch: int, n_feat: int,
                   steps: int) -> float:
    """Teacher-forced forward + backward (~3x forward)."""
    return 3.0 * decode_flops(cfg, batch, n_feat, steps)


def scst_train_flops(cfg: ModelConfig, batch: int, n_feat: int,
                     steps: int) -> float:
    """Greedy baseline (forward only) + sampled rollout with gradients
    (~3x forward).  On-device CIDEr-D is hash/gather work, not matmuls."""
    return (decode_flops(cfg, batch, n_feat, steps)
            + 3.0 * decode_flops(cfg, batch, n_feat, steps))
