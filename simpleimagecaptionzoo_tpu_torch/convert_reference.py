"""Reference (PyTorch) checkpoint <-> param tree converter (the JAX
package's ``convert_reference.py``, the port's own copy of the mapping).

The reference saves plain module state_dicts with ``torch.save``
(reference Engine.py:81-88: ``cp/Captioner_[scst_]cp.pth``).  This module
maps those state_dicts, for every captioner family, into the nested-dict
param trees both packages share, so a reference-trained model can be
evaluated (or SCST-finetuned) on the card without retraining; and back
(:func:`export_state_dict`).  :func:`convert_state_dict` returns the numpy
float32 tree the JAX package's function returns, leaf for leaf;
``convert.from_jax`` carries it to the card.

Reference module layouts converted (reference file:line):

* NIC     — Models/NIC_Model.py:214-218: ``encoder.feature_extractor``
  (torchvision resnet101 Sequential), ``encoder.img_embedding``
  (weight_norm Linear), ``encoder.bn`` (dead code, skipped — never applied
  in forward, NIC_Model.py:27-37), ``decoder.{embed,lstm,predict}``.
* BUTD    — Models/BUTD_Model.py:64-90: ``decoder.atten.{enc_att,dec_att,
  affine}`` (weight_norm Linears), ``decoder.embed.0`` (Embedding inside
  Sequential), ``decoder.TD_atten``/``decoder.language_model`` (LSTMCells),
  ``decoder.predict``; Spatial adds ``encoder.feature_extractor``.
* AoA     — Models/AoA_Model.py:505-517,657-668: ``img_feats_porjection.0``
  (the reference's typo is load-bearing), ``aoa_refine.aoa_layers.{i}``
  (AoABlock ``linear_Q/K/V`` + ``aoa_module.0`` and SublayerConnection
  ``sublayer.norm``), ``aoa_refine.norm``, ``decoder.{lstm,aoa_block,
  embed.0,h_norm,predict}``; Spatial adds ``encoder.feature_extractor``.

Layout conventions translated:

* ``nn.Linear.weight`` is (out, in) -> our ``w`` is (in, out): transpose.
* ``weight_norm(Linear)`` (dim=0) stores ``weight_v`` (out, in) and
  ``weight_g`` (out, 1) -> our ``v`` (in, out) + ``g`` (out,).  Both the
  classic hook names and the new ``parametrizations.weight.original{0,1}``
  names are accepted.
* ``nn.LSTMCell`` stores ``weight_ih``/``weight_hh`` as (4H, in)/(4H, H),
  gate order i,f,g,o -> our ``w_ih``/``w_hh`` transposed; biases direct.
* torchvision resnet convs OIHW -> HWIO; BN running stats -> the framework's
  frozen-BN ``model_state['cnn_stats']`` tree (models/resnet.py).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Set, Tuple

import numpy as np

_RESNET_SEQ_NAMES = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                     "6": "layer3", "7": "layer4"}


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        if v.dtype.is_floating_point:
            v = v.float()
    if hasattr(v, "numpy"):
        v = v.numpy()
    return np.asarray(v, dtype=np.float32)


class _SD:
    """State-dict view that records which keys were consumed."""

    def __init__(self, sd: Mapping):
        self.sd = dict(sd)
        self.used: Set[str] = set()

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise KeyError(
                f"reference checkpoint is missing '{key}' — wrong model_type "
                f"or a truncated/renamed state_dict? Available keys start "
                f"with: {sorted(self.sd)[:5]}")
        self.used.add(key)
        return _np(self.sd[key])

    def mark_prefix_used(self, prefix: str) -> None:
        self.used.update(k for k in self.sd if k.startswith(prefix))

    def unused(self) -> list:
        return sorted(set(self.sd) - self.used
                      - {k for k in self.sd if k.endswith("num_batches_tracked")})


def _linear(sd: _SD, prefix: str, bias: bool = True) -> dict:
    p = {"w": sd.take(prefix + ".weight").T}
    if bias:
        p["b"] = sd.take(prefix + ".bias")
    return p


def _linear_wn(sd: _SD, prefix: str, bias: bool = True) -> dict:
    if (prefix + ".weight_v") in sd:
        v, g = sd.take(prefix + ".weight_v"), sd.take(prefix + ".weight_g")
    else:  # torch >= 2.1 parametrize-style weight_norm export
        g = sd.take(prefix + ".parametrizations.weight.original0")
        v = sd.take(prefix + ".parametrizations.weight.original1")
    p = {"v": v.T, "g": g.reshape(-1)}
    if bias:
        p["b"] = sd.take(prefix + ".bias")
    return p


def _lstm_cell(sd: _SD, prefix: str) -> dict:
    return {"w_ih": sd.take(prefix + ".weight_ih").T,
            "w_hh": sd.take(prefix + ".weight_hh").T,
            "b_ih": sd.take(prefix + ".bias_ih"),
            "b_hh": sd.take(prefix + ".bias_hh")}


def _layer_norm(sd: _SD, prefix: str) -> dict:
    return {"gain": sd.take(prefix + ".gain"),
            "bias": sd.take(prefix + ".bias")}


def _embedding(sd: _SD, key: str) -> dict:
    return {"table": sd.take(key)}


def _aoa_block(sd: _SD, prefix: str) -> dict:
    """AoABlock (AoA_Model.py:71-92): linear_Q/K/V + aoa_module.0 (the GLU's
    Linear; GLU itself has no params)."""
    return {"q": _linear(sd, prefix + ".linear_Q"),
            "k": _linear(sd, prefix + ".linear_K"),
            "v": _linear(sd, prefix + ".linear_V"),
            "aoa": _linear(sd, prefix + ".aoa_module.0")}


def _resnet(sd: _SD, prefix: str) -> Tuple[dict, dict]:
    """encoder.feature_extractor.{0,1,4..7}.* -> torchvision key names ->
    (params, stats) via models/resnet.py, as numpy float32 trees."""
    from simpleimagecaptionzoo_tpu_torch.models import resnet

    tv_sd = {}
    plen = len(prefix) + 1
    for key in sd.sd:
        if not key.startswith(prefix + "."):
            continue
        rest = key[plen:]
        idx, _, tail = rest.partition(".")
        if idx not in _RESNET_SEQ_NAMES:
            raise KeyError(f"unexpected feature_extractor entry '{key}'")
        tv_sd[_RESNET_SEQ_NAMES[idx] + "." + tail] = sd.sd[key]
    sd.mark_prefix_used(prefix + ".")
    params, stats = resnet.convert_torch_state_dict(
        {k: _np(v) for k, v in tv_sd.items()})
    return _host(params), _host(stats)


def _num_refine_layers(sd: _SD) -> int:
    n = 0
    while f"aoa_refine.aoa_layers.{n}.aoa_block.linear_Q.weight" in sd:
        n += 1
    return n


def convert_state_dict(state_dict: Mapping, model_type: str, *,
                       strict: bool = True
                       ) -> Tuple[dict, Optional[dict]]:
    """Convert a reference captioner ``state_dict`` (torch tensors or numpy
    arrays) into ``(params, cnn_stats)``, numpy float32 trees, for the
    captioner (``models.base.get_captioner``) of the same ``model_type``;
    ``convert.from_jax`` makes them tensors.

    ``cnn_stats`` is the frozen-BN statistics tree for CNN-bearing families
    (NIC, BUTDSpatial, AoASpatial) and None for Detection families.  The
    AoA refine depth is read from the keys.  With ``strict`` (default),
    raises if any unexpected parameter key remains unconsumed (catching
    model_type mismatches early).
    """
    sd = _SD(state_dict)
    cnn_stats: Optional[dict] = None
    params: Dict[str, object]

    if model_type == "NIC":
        params = {
            "img_embed": _linear_wn(sd, "encoder.img_embedding"),
            "embed": _embedding(sd, "decoder.embed.weight"),
            "lstm": _lstm_cell(sd, "decoder.lstm"),
            "predict": _linear_wn(sd, "decoder.predict"),
        }
        # encoder.bn is defined but never applied in the reference forward
        # (NIC_Model.py:25 vs :27-37) — dead parameters, skipped.
        sd.mark_prefix_used("encoder.bn.")
        if "encoder.feature_extractor.0.weight" in sd:
            params["cnn"], cnn_stats = _resnet(sd, "encoder.feature_extractor")
    elif model_type in ("BUTDSpatial", "BUTDDetection"):
        params = {
            "embed": _embedding(sd, "decoder.embed.0.weight"),
            "att_enc": _linear_wn(sd, "decoder.atten.enc_att"),
            "att_dec": _linear_wn(sd, "decoder.atten.dec_att"),
            "att_affine": _linear_wn(sd, "decoder.atten.affine"),
            "lstm_td": _lstm_cell(sd, "decoder.TD_atten"),
            "lstm_lang": _lstm_cell(sd, "decoder.language_model"),
            "predict": _linear_wn(sd, "decoder.predict"),
        }
        if "encoder.feature_extractor.0.weight" in sd:
            params["cnn"], cnn_stats = _resnet(sd, "encoder.feature_extractor")
    elif model_type in ("AoASpatial", "AoADetection"):
        refine = []
        for i in range(_num_refine_layers(sd)):
            pre = f"aoa_refine.aoa_layers.{i}"
            refine.append({
                "aoa": _aoa_block(sd, pre + ".aoa_block"),
                "ln": _layer_norm(sd, pre + ".sublayer.norm"),
            })
        if not refine:
            raise KeyError("no aoa_refine.aoa_layers.* keys — not an AoA "
                           "checkpoint?")
        params = {
            "proj": _linear(sd, "img_feats_porjection.0"),
            "refine": refine,
            "refine_ln": _layer_norm(sd, "aoa_refine.norm"),
            "embed": _embedding(sd, "decoder.embed.0.weight"),
            "lstm": _lstm_cell(sd, "decoder.lstm"),
            "aoa_dec": _aoa_block(sd, "decoder.aoa_block"),
            "h_norm": _layer_norm(sd, "decoder.h_norm"),
            "predict": _linear_wn(sd, "decoder.predict"),
        }
        if "encoder.feature_extractor.0.weight" in sd:
            params["cnn"], cnn_stats = _resnet(sd, "encoder.feature_extractor")
    else:
        raise ValueError(f"unknown model_type '{model_type}'")

    leftovers = sd.unused()
    if leftovers and strict:
        raise ValueError(
            f"{len(leftovers)} unconsumed keys in the reference state_dict "
            f"(model_type mismatch?): {leftovers[:8]}")

    params = _tree_map_arrays(params, np.ascontiguousarray)
    if cnn_stats is not None:
        cnn_stats = _tree_map_arrays(cnn_stats, np.ascontiguousarray)
    return params, cnn_stats


def _tree_map_arrays(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map_arrays(v, fn) for v in tree]
    return fn(tree)


def _host(tree):
    """Tensors (on any device, any float dtype) or arrays -> numpy
    float32."""
    return _tree_map_arrays(tree, _np)


class _Out:
    """Builder for a reference-layout state_dict (inverse of ``_SD``)."""

    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def linear(self, prefix: str, p: dict) -> None:
        self.sd[prefix + ".weight"] = np.ascontiguousarray(p["w"].T)
        if "b" in p:
            self.sd[prefix + ".bias"] = p["b"]

    def linear_wn(self, prefix: str, p: dict) -> None:
        # classic-hook weight_norm names (the reference runs torch's
        # pre-parametrize API); weight_g is (out, 1) at dim=0
        self.sd[prefix + ".weight_v"] = np.ascontiguousarray(p["v"].T)
        self.sd[prefix + ".weight_g"] = p["g"].reshape(-1, 1)
        if "b" in p:
            self.sd[prefix + ".bias"] = p["b"]

    def lstm_cell(self, prefix: str, p: dict) -> None:
        self.sd[prefix + ".weight_ih"] = np.ascontiguousarray(p["w_ih"].T)
        self.sd[prefix + ".weight_hh"] = np.ascontiguousarray(p["w_hh"].T)
        self.sd[prefix + ".bias_ih"] = p["b_ih"]
        self.sd[prefix + ".bias_hh"] = p["b_hh"]

    def layer_norm(self, prefix: str, p: dict) -> None:
        self.sd[prefix + ".gain"] = p["gain"]
        self.sd[prefix + ".bias"] = p["bias"]

    def aoa_block(self, prefix: str, p: dict) -> None:
        self.linear(prefix + ".linear_Q", p["q"])
        self.linear(prefix + ".linear_K", p["k"])
        self.linear(prefix + ".linear_V", p["v"])
        self.linear(prefix + ".aoa_module.0", p["aoa"])

    def resnet(self, prefix: str, cnn_params: dict, cnn_stats: dict) -> None:
        import torch
        from simpleimagecaptionzoo_tpu_torch.models import resnet

        tv = resnet.export_torch_state_dict(
            _tree_map_arrays(cnn_params, torch.from_numpy),
            _tree_map_arrays(cnn_stats, torch.from_numpy))
        inv = {v: k for k, v in _RESNET_SEQ_NAMES.items()}
        for key, val in tv.items():
            head, _, tail = key.partition(".")
            self.sd[f"{prefix}.{inv[head]}.{tail}"] = val.numpy()


def export_state_dict(params: Mapping, model_state: Optional[Mapping],
                      model_type: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`convert_state_dict`: a param tree (tensors on any
    device, or numpy arrays; plus ``model_state['cnn_stats']`` for CNN
    families) -> a reference-layout torch-style state_dict of float32 numpy
    arrays.

    The round trip ``convert_state_dict(export_state_dict(p, ms, t), t)``
    is bit-exact, and the emitted key set strict-loads into the reference's
    own modules (Models/{NIC,BUTD,AoA}_Model.py) — including NIC's dead
    ``encoder.bn`` (never applied in forward, NIC_Model.py:27-37), emitted
    at identity so strict ``load_state_dict`` succeeds."""
    params = _host(params)
    cnn_stats = None
    if model_state is not None and model_state.get("cnn_stats") is not None:
        cnn_stats = _host(model_state["cnn_stats"])
    out = _Out()

    if model_type == "NIC":
        out.linear_wn("encoder.img_embedding", params["img_embed"])
        embed_dim = params["img_embed"]["g"].shape[0]
        out.sd["encoder.bn.weight"] = np.ones((embed_dim,), np.float32)
        out.sd["encoder.bn.bias"] = np.zeros((embed_dim,), np.float32)
        out.sd["encoder.bn.running_mean"] = np.zeros((embed_dim,), np.float32)
        out.sd["encoder.bn.running_var"] = np.ones((embed_dim,), np.float32)
        out.sd["encoder.bn.num_batches_tracked"] = np.asarray(0, np.int64)
        out.sd["decoder.embed.weight"] = params["embed"]["table"]
        out.lstm_cell("decoder.lstm", params["lstm"])
        out.linear_wn("decoder.predict", params["predict"])
    elif model_type in ("BUTDSpatial", "BUTDDetection"):
        out.sd["decoder.embed.0.weight"] = params["embed"]["table"]
        out.linear_wn("decoder.atten.enc_att", params["att_enc"])
        out.linear_wn("decoder.atten.dec_att", params["att_dec"])
        out.linear_wn("decoder.atten.affine", params["att_affine"])
        out.lstm_cell("decoder.TD_atten", params["lstm_td"])
        out.lstm_cell("decoder.language_model", params["lstm_lang"])
        out.linear_wn("decoder.predict", params["predict"])
    elif model_type in ("AoASpatial", "AoADetection"):
        out.linear("img_feats_porjection.0", params["proj"])
        for i, layer in enumerate(params["refine"]):
            pre = f"aoa_refine.aoa_layers.{i}"
            out.aoa_block(pre + ".aoa_block", layer["aoa"])
            out.layer_norm(pre + ".sublayer.norm", layer["ln"])
        out.layer_norm("aoa_refine.norm", params["refine_ln"])
        out.sd["decoder.embed.0.weight"] = params["embed"]["table"]
        out.lstm_cell("decoder.lstm", params["lstm"])
        out.aoa_block("decoder.aoa_block", params["aoa_dec"])
        out.layer_norm("decoder.h_norm", params["h_norm"])
        out.linear_wn("decoder.predict", params["predict"])
    else:
        raise ValueError(f"unknown model_type '{model_type}'")

    if "cnn" in params:
        if cnn_stats is None:
            raise ValueError("CNN params present but model_state carries no "
                             "cnn_stats — cannot emit BN running statistics")
        out.resnet("encoder.feature_extractor", params["cnn"], cnn_stats)
    return out.sd


def save_reference_checkpoint(pth_path: str, params: Mapping,
                              model_state: Optional[Mapping],
                              model_type: str) -> None:
    """Export params as a reference-loadable ``.pth`` (torch.save of the
    state_dict, Engine.py:81-88 format)."""
    import torch

    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_state_dict(params, model_state,
                                        model_type).items()}
    torch.save(sd, pth_path)


def load_reference_checkpoint(pth_path: str, model_type: str, *,
                              strict: bool = True) -> Tuple[dict, dict]:
    """Load a reference ``Captioner_[scst_]cp.pth`` and convert it.

    Returns ``(params, model_state)``, numpy trees, where ``model_state``
    is ``{"cnn_stats": stats-or-None}``: the tree the Engine checkpoints
    (engine/engine.py)."""
    import torch

    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    params, cnn_stats = convert_state_dict(sd, model_type, strict=strict)
    return params, {"cnn_stats": cnn_stats}
