"""ResNet-101 visual encoder, NHWC in and out.

Counterpart of the JAX package's ``models/resnet.py`` (the reference's
torchvision encoder, Models/NIC_Model.py:8-37, BUTD_Model.py:8-38), with
its parameter layout: HWIO conv kernels, BatchNorm leaves ``{"scale",
"bias"}``, running statistics ``{"mean", "var"}`` in a separate tree, the
bottlenecks in ``layer1``..``layer4`` lists, the stride on ``conv2`` and
the downsample.  :func:`apply` turns each kernel into the convolution's
layout (OIHW, ``channels_last``, in the activations' dtype) as it runs, so
the tree holds one copy, the one ``convert.from_jax``, ``param_labels``
and the optimizer see.

The images arrive NHWC; their NCHW view (``permute(0, 3, 1, 2)``) is
already ``channels_last``, the layout of cuDNN's tensor-core
convolutions, and every activation stays in it.  The convolutions are
``torch.nn.functional.conv2d`` (cuDNN on the card): the JAX package runs
them through ``lax.conv_general_dilated``, outside any Pallas kernel.

BatchNorm follows torch: ``train=False`` uses the running statistics, with
the scale and bias formed in float32 and cast to the activations' dtype;
``train=True`` normalizes with the batch's statistics (biased variance)
and returns the running statistics updated at ``BN_MOMENTUM`` with the
unbiased variance.  Padding is explicit and symmetric, (k - 1) // 2 a
side (torch's ``padding=1``; XLA's SAME differs for stride-2 even
inputs); the 3 x 3 stride-2 max-pool pads with -inf.

Without pretrained weights, :func:`init` draws He-normal (fan_out) kernels
with (0, 1) running statistics; :func:`load_torchvision_weights` reads a
torchvision ``resnet101`` state_dict from a local ``.pth``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from simpleimagecaptionzoo_tpu_torch import parallel

BLOCK_COUNTS = (3, 4, 23, 3)           # ResNet-101
WIDTHS = (64, 128, 256, 512)           # bottleneck mid widths; out = 4x
BN_MOMENTUM = 0.1                      # torchvision BatchNorm2d default
BN_EPS = 1e-5


def _conv_init(gen, kh, kw, cin, cout):
    """He (kaiming) normal, fan_out, as torchvision's resnet init."""
    std = math.sqrt(2.0 / (kh * kw * cout))
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       device=gen.device) * std


def _bn_init(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def _bn_stats_init(c, device):
    return {"mean": torch.zeros((c,), device=device),
            "var": torch.ones((c,), device=device)}


def init(gen: torch.Generator, block_counts: Optional[Tuple[int, ...]] = None
         ) -> Tuple[dict, dict]:
    """(params, stats) on ``gen.device``, drawn from ``gen``.

    ``block_counts`` defaults to the module's ``BLOCK_COUNTS`` read at
    call time (tests patch it to a shallower stack); the output width is
    2048 whatever the depth."""
    if block_counts is None:
        block_counts = BLOCK_COUNTS
    dev = gen.device
    params = {"conv1": _conv_init(gen, 7, 7, 3, 64), "bn1": _bn_init(64, dev)}
    stats = {"bn1": _bn_stats_init(64, dev)}
    cin = 64
    for li, (count, width) in enumerate(zip(block_counts, WIDTHS), start=1):
        blocks, blocks_stats = [], []
        cout = width * 4
        for bi in range(count):
            b = {
                "conv1": _conv_init(gen, 1, 1, cin, width),
                "bn1": _bn_init(width, dev),
                "conv2": _conv_init(gen, 3, 3, width, width),
                "bn2": _bn_init(width, dev),
                "conv3": _conv_init(gen, 1, 1, width, cout),
                "bn3": _bn_init(cout, dev),
            }
            bs = {"bn1": _bn_stats_init(width, dev),
                  "bn2": _bn_stats_init(width, dev),
                  "bn3": _bn_stats_init(cout, dev)}
            if bi == 0:
                b["downsample_conv"] = _conv_init(gen, 1, 1, cin, cout)
                b["downsample_bn"] = _bn_init(cout, dev)
                bs["downsample_bn"] = _bn_stats_init(cout, dev)
            blocks.append(b)
            blocks_stats.append(bs)
            cin = cout
        params["layer%d" % li] = blocks
        stats["layer%d" % li] = blocks_stats
    return params, stats


def _conv(x, w, stride=1, padding=None):
    """x (B, C, H, W) channels_last; w HWIO -> OIHW channels_last in x's
    dtype.  Symmetric padding (k - 1) // 2 unless given."""
    if padding is None:
        padding = ((w.shape[0] - 1) // 2, (w.shape[1] - 1) // 2)
    w = w.permute(3, 2, 0, 1).to(x.dtype).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(x, p, s, train=False):
    """(out, new_stats).  Eval: the running statistics, new_stats = s.
    Train: the batch's (biased variance normalizes, the unbiased one
    updates the running variance).  Under a process group the batch is
    the global one, as the JAX package's global array is: the per-channel
    sum and then the sum of squared deviations from the global mean are
    summed over the data axis's processes with their gradients
    (``parallel.all_reduce_sum_autograd``), so every process normalizes by
    the same statistics and keeps the same running ones."""
    if not train:
        inv = torch.rsqrt(s["var"] + BN_EPS)
        scale = (p["scale"] * inv).to(x.dtype)
        bias = (p["bias"] - s["mean"] * p["scale"] * inv).to(x.dtype)
        return torch.addcmul(bias[:, None, None], x,
                             scale[:, None, None]), s
    xf = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    count = parallel.data_count()
    if count == 1:
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))  # biased
    else:
        n *= count                  # every process holds B / count rows
        mean = parallel.all_reduce_sum_autograd(xf.sum(dim=(0, 2, 3))) / n
        var = parallel.all_reduce_sum_autograd(
            ((xf - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3))) / n
    var_unbiased = var * (n / max(n - 1, 1))
    new_s = {"mean": ((1 - BN_MOMENTUM) * s["mean"]
                      + BN_MOMENTUM * mean).detach(),
             "var": ((1 - BN_MOMENTUM) * s["var"]
                     + BN_MOMENTUM * var_unbiased).detach()}
    inv = torch.rsqrt(var + BN_EPS)
    out = ((xf - mean[:, None, None]) * inv[:, None, None]
           * p["scale"][:, None, None] + p["bias"][:, None, None])
    return out.to(x.dtype), new_s


def _max_pool(x):
    """3 x 3, stride 2, padding 1 on (B, C, H, W); the padding is -inf
    (the JAX package's ``reduce_window`` init), so a window at the border
    of a map with negative values takes the largest of its real ones."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def _bottleneck(x, p, s, stride, train=False):
    ns = {}
    out, ns["bn1"] = _bn(_conv(x, p["conv1"]), p["bn1"], s["bn1"], train)
    out = F.relu(out, inplace=True)
    out, ns["bn2"] = _bn(_conv(out, p["conv2"], stride), p["bn2"], s["bn2"],
                         train)
    out = F.relu(out, inplace=True)
    out, ns["bn3"] = _bn(_conv(out, p["conv3"]), p["bn3"], s["bn3"], train)
    if "downsample_conv" in p:
        x, ns["downsample_bn"] = _bn(_conv(x, p["downsample_conv"], stride),
                                     p["downsample_bn"], s["downsample_bn"],
                                     train)
    return F.relu(out + x, inplace=True), ns


def apply(params: dict, stats: dict, images: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16, train: bool = False):
    """images (B, H, W, 3) NHWC, normalized -> the feature map (B, H/32,
    W/32, 2048) NHWC in ``dtype`` ((B, 7, 7, 2048) at 224).

    ``train=False`` returns the feature map; ``train=True`` returns
    ``(feature_map, new_stats)``, the running statistics updated by the
    batch's (callers thread them through ``model_state["cnn_stats"]``)."""
    new_stats: dict = {}
    x = images.permute(0, 3, 1, 2).to(dtype)       # NCHW, channels_last
    x = _conv(x, params["conv1"], stride=2, padding=(3, 3))
    x, new_stats["bn1"] = _bn(x, params["bn1"], stats["bn1"], train)
    x = F.relu(x, inplace=True)
    x = _max_pool(x)
    for li in range(1, 5):
        stride = 1 if li == 1 else 2
        layer_stats = []
        for bi, (bp, bs) in enumerate(zip(params["layer%d" % li],
                                          stats["layer%d" % li])):
            x, ns = _bottleneck(x, bp, bs, stride if bi == 0 else 1, train)
            layer_stats.append(ns)
        new_stats["layer%d" % li] = layer_stats
    fmap = x.permute(0, 2, 3, 1)                   # NHWC, contiguous
    return (fmap, new_stats) if train else fmap


def _linear_resize_weights(in_size: int, out_size: int,
                           device) -> torch.Tensor:
    """(in_size, out_size) float32 weights of ``jax.image.resize``'s
    "linear" method along one axis: the triangle kernel, widened by the
    inverse scale when shrinking (its antialiasing), columns normalized,
    samples outside the input zeroed."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32) + 0.5)
                * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(
        in_size, dtype=torch.float32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones(())),
                    torch.zeros(()))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros(())).to(device)


def spatial_features(feat_map: torch.Tensor, grid: int = 7) -> torch.Tensor:
    """(B, H, W, C) -> (B, grid * grid, C) float32: adaptive average pool
    and flatten (reference BUTD_Model.py:32-37).  An integer ratio takes
    the box mean (AdaptiveAvgPool2d's bins); any other takes the JAX
    package's fallback, ``jax.image.resize(..., "linear")``, which
    antialiases when it shrinks."""
    b, h, w, c = feat_map.shape
    feat_map = feat_map.float()
    if (h, w) != (grid, grid):
        if h % grid == 0 and w % grid == 0:
            feat_map = feat_map.reshape(b, grid, h // grid, grid,
                                        w // grid, c).mean(dim=(2, 4))
        else:
            wh = _linear_resize_weights(h, grid, feat_map.device)
            ww = _linear_resize_weights(w, grid, feat_map.device)
            feat_map = torch.einsum("bhwc,hi,wj->bijc", feat_map, wh, ww)
    return feat_map.reshape(b, grid * grid, c)


def global_pool(feat_map: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C) float32 mean (reference NIC_Model.py:34)."""
    return feat_map.float().mean(dim=(1, 2))


# ---------------------------------------------------------------------------
# torchvision weight conversion
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd) -> Tuple[dict, dict]:
    """A torchvision-layout resnet101 state_dict (torch tensors or numpy
    arrays, keys like ``conv1.weight``, ``layer3.7.bn2.running_var``) ->
    (params, stats) float32 CPU trees: OIHW kernels -> HWIO, BN weight and
    bias -> scale and bias, running mean and var -> stats."""
    def t(name):
        return torch.as_tensor(sd[name]).detach().to(torch.float32).cpu()

    def conv(name):
        return t(name).permute(2, 3, 1, 0).contiguous()

    def bn(prefix):
        return ({"scale": t(prefix + ".weight"), "bias": t(prefix + ".bias")},
                {"mean": t(prefix + ".running_mean"),
                 "var": t(prefix + ".running_var")})

    params: dict = {"conv1": conv("conv1.weight")}
    stats: dict = {}
    params["bn1"], stats["bn1"] = bn("bn1")
    for li, count in enumerate(BLOCK_COUNTS, start=1):
        blocks, blocks_stats = [], []
        for bi in range(count):
            pre = "layer%d.%d" % (li, bi)
            b, bs = {}, {}
            for ci in (1, 2, 3):
                b["conv%d" % ci] = conv("%s.conv%d.weight" % (pre, ci))
                b["bn%d" % ci], bs["bn%d" % ci] = bn("%s.bn%d" % (pre, ci))
            if ("%s.downsample.0.weight" % pre) in sd:
                b["downsample_conv"] = conv("%s.downsample.0.weight" % pre)
                b["downsample_bn"], bs["downsample_bn"] = bn(
                    "%s.downsample.1" % pre)
            blocks.append(b)
            blocks_stats.append(bs)
        params["layer%d" % li] = blocks
        stats["layer%d" % li] = blocks_stats
    return params, stats


def export_torch_state_dict(params: dict, stats: dict) -> dict:
    """Inverse of :func:`convert_torch_state_dict`: (params, stats) -> a
    torchvision-layout state_dict of float32 CPU tensors (HWIO -> OIHW,
    scale and bias -> BN weight and bias, stats -> running mean and var,
    and the ``num_batches_tracked`` counters torch's strict
    ``load_state_dict`` expects)."""
    sd: dict = {}

    def f32(v):
        return v.detach().to(torch.float32).cpu()

    def conv(name, w):
        sd[name + ".weight"] = f32(w).permute(3, 2, 0, 1).contiguous()

    def bn(prefix, p, s):
        sd[prefix + ".weight"] = f32(p["scale"])
        sd[prefix + ".bias"] = f32(p["bias"])
        sd[prefix + ".running_mean"] = f32(s["mean"])
        sd[prefix + ".running_var"] = f32(s["var"])
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for li, count in enumerate(BLOCK_COUNTS, start=1):
        for bi in range(count):
            pre = "layer%d.%d" % (li, bi)
            b = params["layer%d" % li][bi]
            bs = stats["layer%d" % li][bi]
            for ci in (1, 2, 3):
                conv("%s.conv%d" % (pre, ci), b["conv%d" % ci])
                bn("%s.bn%d" % (pre, ci), b["bn%d" % ci], bs["bn%d" % ci])
            if "downsample_conv" in b:
                conv("%s.downsample.0" % pre, b["downsample_conv"])
                bn("%s.downsample.1" % pre, b["downsample_bn"],
                   bs["downsample_bn"])
    return sd


def load_torchvision_weights(path: str) -> Tuple[dict, dict]:
    """Load a torchvision resnet101 state_dict ``.pth`` and convert it
    (:func:`convert_torch_state_dict`)."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_state_dict(sd)
