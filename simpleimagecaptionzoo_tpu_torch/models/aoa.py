"""AoA ("Attention on Attention") captioner, Detection and Spatial
variants, in feature mode.

Counterpart of the JAX package's ``models/aoa.py`` (reference
Models/AoA_Model.py): multi-head scaled dot-product attention with a GLU
"attention on attention" gate (AoABlock, :71-120), a pre-norm residual
refiner over the projected bottom-up features (:140-162), and an LSTM
decoder whose input mixes the word embedding with ``mean + ctx``, where
``ctx`` is the previous step's AoA output (:197-293).

Parity notes, as in the JAX package: the hand-rolled unbiased-std
LayerNorm (``layers.layer_norm_std``); the embedding re-init U(-0.1,0.1)
and zeroed predict bias; 'adaptive' masking (masked projection, -1e9
masked softmax, masked mean).  The decoder K/V projections are hoisted into
encode, and so is the LSTM's concatenated weight (``extras["lstm_cat"]``,
with its TF32 split in float32): both are loop-invariant.

Attention scores and the attention-weighted values accumulate in float32
whatever the compute dtype, as the JAX package's
``preferred_element_type=float32`` einsums do.

Int8 serving (``quantize_decode_params``): the four per-step layers are
weight-only int8 (kernel K3; K1-int8 for the head), and with
``SICZ_TPU_INT8_KV`` on, encode stores the decoder K/V as int8 with per-row
scales, which every step attends over through kernel K4.

Beam search runs :meth:`_AoABase.step_lanes_core`: the k beams of a sample
ride the AoA block's query axis, so each step reads the sample's K/V once,
not once per beam, and the LSTM cell runs over B*k rows.

AoASpatial takes the 7 x 7 ResNet grid (``visual["spatial_feats"]``, 49
regions, no mask).  At its published width (hidden 512, 8 heads) a head is
64 wide, which K4's gate refuses as the JAX package's does: its encode
keeps float K/V whatever ``SICZ_TPU_INT8_KV`` says.  From pixels (its
ResNet-101) and ``tf_inputs`` wait for later slices.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.models.base import (Captioner, Encoded,
                                                         register)
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
from simpleimagecaptionzoo_tpu_torch.ops import int8_attention as IA
from simpleimagecaptionzoo_tpu_torch.ops import quant


def aoa_block_init(gen, d_model: int) -> dict:
    return {
        "q": L.dense_init(gen, d_model, d_model),
        "k": L.dense_init(gen, d_model, d_model),
        "v": L.dense_init(gen, d_model, d_model),
        "aoa": L.dense_init(gen, 2 * d_model, 2 * d_model),
    }


def aoa_block(params: dict, query: torch.Tensor, key: torch.Tensor,
              value: torch.Tensor, mask: Optional[torch.Tensor],
              num_heads: int, *, dropout_aoa: float, dropout_dot: float,
              train: bool, generator=None,
              kv_proj: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """AoABlock forward (AoA_Model.py:90-120).

    query (B,Tq,D); key/value (B,Tk,D); mask (B,Tk) or None.
    kv_proj: optional precomputed (k_proj, v_proj), each (B,Tk,D).
    Returns (x (B,Tq,D), mean-head attention (B,Tq,Tk) float32).
    """
    b, tq, d = query.shape
    dh = d // num_heads
    qp = L.dense(params["q"], query).reshape(b, tq, num_heads, dh)
    if kv_proj is None:
        kp = L.dense(params["k"], key)
        vp = L.dense(params["v"], value)
    else:
        kp, vp = kv_proj
    kp = kp.reshape(b, -1, num_heads, dh)
    vp = vp.reshape(b, -1, num_heads, dh)
    # (B, H, Tq, Tk), float32 accumulation
    scores = torch.einsum("bqhd,bkhd->bhqk", qp.float(),
                          kp.float()) / math.sqrt(dh)
    p_atten = L.masked_softmax(
        scores, None if mask is None else mask[:, None, None, :])
    p_drop = L.dropout(p_atten, dropout_dot, train, generator)
    x = torch.einsum("bhqk,bkhd->bqhd", p_drop.to(vp.dtype).float(),
                     vp.float()).reshape(b, tq, d).to(query.dtype)
    cat = torch.cat([x, query], dim=-1)
    cat = L.dropout(cat, dropout_aoa, train, generator)
    a, g = torch.chunk(L.dense(params["aoa"], cat), 2, dim=-1)  # GLU
    return a * torch.sigmoid(g), p_atten.mean(dim=1)


class _AoABase(Captioner):
    # aoa_dec k/v run once in encode (the hoisted K/V) and so does the
    # refiner: only the per-step layers are quantized
    decode_quant_paths = (("lstm",), ("aoa_dec", "q"), ("aoa_dec", "aoa"),
                          ("predict",))

    def init_params(self, gen: torch.Generator) -> dict:
        """Parameters on ``gen.device``, drawn from ``gen``."""
        cfg = self.config
        d = cfg.hidden_dim                        # d_model == hidden_dim
        refine = [{"aoa": aoa_block_init(gen, d),
                   "ln": L.layer_norm_std_init(d, gen.device)}
                  for _ in range(cfg.num_refine_layers)]
        return {
            "proj": L.dense_init(gen, cfg.enc_dim, d),
            "refine": refine,
            "refine_ln": L.layer_norm_std_init(d, gen.device),
            "embed": L.embedding_init(gen, cfg.vocab_size, cfg.embed_dim,
                                      scale=0.1),
            "lstm": L.lstm_cell_init(gen, cfg.embed_dim + d, d),
            "aoa_dec": aoa_block_init(gen, d),
            "h_norm": L.layer_norm_std_init(d, gen.device),
            "predict": L.dense_wn_init(gen, d, cfg.vocab_size,
                                       zero_bias=True),
        }

    def _raw_features(self, params, visual, model_state):
        """-> (feats, mask, model_state)."""
        raise NotImplementedError

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        cfg = self.config
        feats, mask, model_state = self._raw_features(params, visual,
                                                      model_state)
        # masked projection (pack_wrapper semantics): padded rows -> exactly 0
        x = torch.relu(L.dense(params["proj"], feats))
        x = L.dropout(x, cfg.dropout, train, generator)
        if mask is not None:
            x = x * mask[..., None]
        # pre-norm residual AoA refiner (AoA_Model.py:136-162)
        for layer in params["refine"]:
            y = L.layer_norm_std(layer["ln"], x)
            out, _ = aoa_block(layer["aoa"], y, y, y, mask, cfg.num_heads,
                               dropout_aoa=cfg.dropout_aoa,
                               dropout_dot=cfg.dropout_dot_atten,
                               train=train, generator=generator)
            out = L.dropout(out, cfg.dropout_sc, train, generator)
            x = x + out
        refined = L.layer_norm_std(params["refine_ln"], x)     # (B, N, D)
        if mask is None:
            mean = refined.mean(dim=1)
        else:
            mean = ((refined * mask[..., None]).sum(dim=1)
                    / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0))
        k_proj = L.dense(params["aoa_dec"]["k"], refined)
        v_proj = L.dense(params["aoa_dec"]["v"], refined)
        if quant.is_quantized(params["predict"]) and \
                IA.encode_should_quantize(refined.shape[0], refined.shape[1],
                                          cfg.hidden_dim, cfg.num_heads):
            # int8 serving with the switch on: int8 K/V with per-row scales,
            # dequantized only inside K4
            k_q, k_s = IA.quantize_rows(k_proj)
            v_q, v_s = IA.quantize_rows(v_proj)
            extras = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
        else:
            extras = {"k_proj": k_proj, "v_proj": v_proj}
        if not quant.is_quantized(params["lstm"]):
            extras["lstm_cat"] = fused_lstm.prepare_lstm(params["lstm"])
        return (Encoded(features=refined, mean=mean, mask=mask,
                        extras=extras),
                model_state)

    def _attend(self, params, query, encoded: Encoded, *, train: bool,
                generator):
        """Decoder AoA block over the hoisted K/V: query (B, q, D) ->
        (gated ctx (B, q, D), mean-head attention (B, q, N)).  Dispatches on
        the K/V that encode stored: float projections, or int8 with per-row
        scales (kernel K4)."""
        cfg = self.config
        ex = encoded.extras
        int8_kv = "k_q" in ex
        if int8_kv and not IA.supported(query.shape[0], query.shape[1],
                                        ex["k_q"].shape[1], cfg.hidden_dim,
                                        cfg.num_heads):
            # a query axis K4 does not take (encode checked k <= 4):
            # dequantize once to the query dtype and attend as usual
            ex = {"k_proj": (ex["k_q"].to(query.dtype)
                             * ex["k_s"][..., None].to(query.dtype)),
                  "v_proj": (ex["v_q"].to(query.dtype)
                             * ex["v_s"][..., None].to(query.dtype))}
            int8_kv = False
        if int8_kv:
            blk = params["aoa_dec"]
            qp = L.dense(blk["q"], query)
            x, alpha = IA.lanes_attention_int8(
                qp, ex["k_q"], ex["k_s"], ex["v_q"], ex["v_s"], encoded.mask,
                cfg.num_heads)
            # the GLU tail of aoa_block (its dropouts are off in eval decode,
            # the only place int8 K/V exist)
            cat = torch.cat([x.to(query.dtype), query], dim=-1)
            a, g = torch.chunk(L.dense(blk["aoa"], cat), 2, dim=-1)
            return a * torch.sigmoid(g), alpha
        return aoa_block(
            params["aoa_dec"], query, encoded.features, encoded.features,
            encoded.mask, cfg.num_heads,
            dropout_aoa=0.0,                       # AoA_Model.py:205
            dropout_dot=cfg.dropout_dot_atten,
            train=train, generator=generator,
            kv_proj=(ex["k_proj"], ex["v_proj"]))

    def init_state(self, params, encoded: Encoded):
        b = encoded.mean.shape[0]
        z = torch.zeros((b, self.config.hidden_dim), dtype=encoded.mean.dtype,
                        device=encoded.mean.device)
        return {"h": z, "m": z, "ctx": z}

    def step_core(self, params, encoded: Encoded, state,
                  tokens: torch.Tensor, *, train: bool = False,
                  generator=None):
        cfg = self.config
        ctx_in = encoded.mean + L.dropout(state["ctx"], cfg.dropout, train,
                                          generator)
        emb = torch.relu(L.embedding(params["embed"], tokens))
        emb = L.dropout(emb, cfg.dropout, train, generator)
        h, m = L.lstm_cell(params["lstm"], torch.cat([emb, ctx_in], dim=-1),
                           state["h"], state["m"],
                           prepared=(encoded.extras or {}).get("lstm_cat"))
        q = L.layer_norm_std(params["h_norm"], h)[:, None, :]    # (B,1,D)
        ctx, alpha = self._attend(params, q, encoded, train=train,
                                  generator=generator)
        ctx = ctx[:, 0, :]
        out = L.dropout(ctx, cfg.dropout, train, generator)
        return out, {"h": h, "m": m, "ctx": ctx}, alpha[:, 0, :]

    def init_lane_state(self, params, encoded: Encoded, k: int):
        b = encoded.mean.shape[0]
        z = torch.zeros((b, k, self.config.hidden_dim),
                        dtype=encoded.mean.dtype, device=encoded.mean.device)
        return {"h": z, "m": z, "ctx": z}

    def step_lanes_core(self, params, encoded: Encoded, state, tokens, *,
                        train: bool = False, generator=None):
        """Beam-lane step with shared K/V: the k lanes of a sample ride the
        AoA block's query axis (``_attend`` gets q (B, k, D); the int8
        branch is K4 with k query rows), and the LSTM cell runs over B*k
        rows with encode's prepared weights.  h, m and ctx stay contiguous
        (B, k, D) tensors, which the tensor-core routes need.  Returns the
        pre-logit ctx (B, k, D); the caller applies the head (``step_lanes``
        or the fused top-k)."""
        b, k = tokens.shape
        emb = torch.relu(L.embedding(params["embed"], tokens))   # (B,k,E)
        ctx_in = encoded.mean[:, None, :].to(state["ctx"].dtype) \
            + state["ctx"]
        x = torch.cat([emb, ctx_in], dim=-1).reshape(b * k, -1)
        h, m = L.lstm_cell(params["lstm"], x, state["h"].reshape(b * k, -1),
                           state["m"].reshape(b * k, -1),
                           prepared=(encoded.extras or {}).get("lstm_cat"))
        h = h.reshape(b, k, -1)
        m = m.reshape(b, k, -1)
        q = L.layer_norm_std(params["h_norm"], h)                # (B,k,D)
        ctx, alpha = self._attend(params, q, encoded, train=train,
                                  generator=generator)
        return ctx, {"h": h, "m": m, "ctx": ctx}, alpha


@register("AoADetection")
class AoADetectionCaptioner(_AoABase):

    def _raw_features(self, params, visual, model_state):
        return visual["bu_feats"], visual.get("bu_masks"), model_state


@register("AoASpatial")
class AoASpatialCaptioner(_AoABase):

    def _raw_features(self, params, visual, model_state):
        if "spatial_feats" not in visual:
            raise NotImplementedError(
                "AoASpatial from pixels (its ResNet-101) is not ported yet "
                "(ROADMAP Queue 1, slice 5); pass precomputed "
                "visual['spatial_feats'] (B, 49, 2048)")
        return visual["spatial_feats"], None, model_state
