"""BUTD ("Bottom-Up Top-Down") captioner, Spatial and Detection variants.

Counterpart of the JAX package's ``models/butd.py`` (reference
Models/BUTD_Model.py): 7x7x2048 ResNet features (Spatial, 49 regions, no
mask) or 36x2048 bottom-up box features (Detection, with ``bu_masks``),
concat SoftAttention (BUTD_Model.py:40-62), and a two-layer top-down
decoder: an attention LSTM fed [h2, mean, word embedding] and a language
LSTM fed [attended, h1] (BUTD_Model.py:82-83,137-145), then the weight-norm
head.

Parity notes, as in the JAX package: the embedding re-init U(-0.1, 0.1)
and the zeroed predict bias; the word embedding is ReLU'd; the attention
keys ``att_enc(features)`` are projected once in encode, not once a step;
masked attention (-1e9) is always on.  Both cells' concatenated weights
(``extras["td_cat"]``, ``extras["lang_cat"]``, with their TF32 split in
float32) are made once in encode, as AoA's ``lstm_cat``.

The td-cell hoist is not ported: the JAX package's default mode projects
the 2,048 ``mean`` rows of the attention cell's ``w_ih`` once in encode
(``td_mean_gates``) and runs that cell outside its kernel.  Here both cells
run kernel K2 over the full concat every step, the function the JAX
package's kernel computes in its ``interpret`` mode; the two agree to
float32 rounding.

Int8 serving (``quantize_decode_params``): both cells, ``att_dec`` and the
head are weight-only int8 (kernel K3 three times a step; K1-int8 for the
head); ``att_affine`` (one output column) stays float, as in the JAX
package.  BUTD has no K/V, so ``SICZ_TPU_INT8_KV`` does not apply.

Beam search runs :meth:`_BUTDBase.step_lanes_core`: each sample's keys and
features are read once a step for its k lanes; only the concat attention's
activation is per lane, (B, k, N, A), and both cells run over B*k rows.

BUTDSpatial from pixels (``visual["img_tensors"]``, with ``cnn`` in the
params): ``prepare_images``, the ResNet-101, ``spatial_features`` to the
``enc_img_size`` grid (float32, cast to ``att_enc``'s dtype,
``models/base.py``).  ``tf_inputs`` is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.models import resnet
from simpleimagecaptionzoo_tpu_torch.models.base import (Captioner, Encoded,
                                                         register)
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm, quant


class _BUTDBase(Captioner):
    # att_affine (atten_dim -> 1) is left out: padding its single output
    # column to the int8 tile would cost more memory than it saves
    decode_quant_paths = (("lstm_td",), ("lstm_lang",), ("att_dec",),
                          ("predict",))

    def init_params(self, gen: torch.Generator,
                    include_cnn: bool = False) -> dict:
        """The JAX package's tree, drawn from ``gen`` on its device; with
        ``cnn`` when ``include_cnn`` (``Captioner.init_params``)."""
        cfg = self.config
        return self._add_cnn({
            "embed": L.embedding_init(gen, cfg.vocab_size, cfg.embed_dim,
                                      scale=0.1),
            "att_enc": L.dense_wn_init(gen, cfg.enc_dim, cfg.atten_dim),
            "att_dec": L.dense_wn_init(gen, cfg.hidden_dim, cfg.atten_dim),
            "att_affine": L.dense_wn_init(gen, cfg.atten_dim, 1),
            "lstm_td": L.lstm_cell_init(
                gen, cfg.embed_dim + cfg.enc_dim + cfg.hidden_dim,
                cfg.hidden_dim),
            "lstm_lang": L.lstm_cell_init(gen, cfg.enc_dim + cfg.hidden_dim,
                                          cfg.hidden_dim),
            "predict": L.dense_wn_init(gen, cfg.hidden_dim, cfg.vocab_size,
                                       zero_bias=True),
        }, gen, include_cnn)

    def _features(self, params, visual, model_state, train=False):
        """-> (feats, mask, model_state)."""
        raise NotImplementedError

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        feats, mask, model_state = self._features(params, visual,
                                                  model_state, train)
        if mask is None:
            mean = feats.mean(dim=1)
        else:
            mean = ((feats * mask[..., None]).sum(dim=1)
                    / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0))
        extras = {"att_keys": L.dense_wn(params["att_enc"], feats)}
        for name, key in (("lstm_td", "td_cat"), ("lstm_lang", "lang_cat")):
            if not quant.is_quantized(params[name]):
                extras[key] = fused_lstm.prepare_lstm(params[name])
        return (Encoded(features=feats, mean=mean, mask=mask,
                        extras=extras), model_state)

    def init_state(self, params, encoded: Encoded):
        b = encoded.mean.shape[0]
        z = torch.zeros((b, self.config.hidden_dim), dtype=encoded.mean.dtype,
                        device=encoded.mean.device)
        return {"h1": z, "c1": z, "h2": z, "c2": z}

    def step_core(self, params, encoded: Encoded, state,
                  tokens: torch.Tensor, *, train: bool = False,
                  generator=None):
        cfg = self.config
        ex = encoded.extras
        emb = torch.relu(L.embedding(params["embed"], tokens))
        emb = L.dropout(emb, cfg.dropout, train, generator)
        h1, c1 = L.lstm_cell(
            params["lstm_td"],
            torch.cat([state["h2"], encoded.mean, emb], dim=-1),
            state["h1"], state["c1"], prepared=ex.get("td_cat"))
        # concat SoftAttention (BUTD_Model.py:49-62)
        dec_ctx = L.dense_wn(params["att_dec"], h1)               # (B, A)
        act = torch.relu(ex["att_keys"] + dec_ctx[:, None, :])
        act = L.dropout(act, cfg.dropout, train, generator)
        scores = L.dense_wn(params["att_affine"], act)[..., 0]    # (B, N)
        alpha = L.masked_softmax(scores, encoded.mask)
        attended = (encoded.features * alpha[..., None]).sum(dim=1)
        h2, c2 = L.lstm_cell(params["lstm_lang"],
                             torch.cat([attended, h1], dim=-1),
                             state["h2"], state["c2"],
                             prepared=ex.get("lang_cat"))
        out = L.dropout(h2, cfg.dropout, train, generator)
        return out, {"h1": h1, "c1": c1, "h2": h2, "c2": c2}, alpha

    def init_lane_state(self, params, encoded: Encoded, k: int):
        b = encoded.mean.shape[0]
        z = torch.zeros((b, k, self.config.hidden_dim),
                        dtype=encoded.mean.dtype, device=encoded.mean.device)
        return {"h1": z, "c1": z, "h2": z, "c2": z}

    def step_lanes_core(self, params, encoded: Encoded, state, tokens, *,
                        train: bool = False, generator=None):
        """Beam-lane step sharing each sample's keys and features: the
        attention keys (B, N, A) and features (B, N, E) are read once per
        sample a step; only the concat attention's activation (B, k, N, A)
        is per lane, and both cells run over B*k rows with encode's
        prepared weights.  The state stays contiguous (B, k, H), which the
        tensor-core routes need.  Returns the pre-logit h2 (B, k, H); the
        caller applies the head."""
        b, k = tokens.shape
        ex = encoded.extras
        flat = lambda x: x.reshape(b * k, -1)                 # noqa: E731
        emb = torch.relu(L.embedding(params["embed"], tokens))   # (B,k,E)
        mean = encoded.mean[:, None, :].to(emb.dtype).expand(b, k, -1)
        h1, c1 = L.lstm_cell(
            params["lstm_td"],
            flat(torch.cat([state["h2"], mean, emb], dim=-1)),
            flat(state["h1"]), flat(state["c1"]), prepared=ex.get("td_cat"))
        dec_ctx = L.dense_wn(params["att_dec"], h1).reshape(b, k, 1, -1)
        act = torch.relu(ex["att_keys"][:, None] + dec_ctx)   # (B,k,N,A)
        scores = L.dense_wn(params["att_affine"], act)[..., 0]   # (B,k,N)
        mask = None if encoded.mask is None else encoded.mask[:, None, :]
        alpha = L.masked_softmax(scores, mask)
        attended = torch.einsum("bne,bkn->bke", encoded.features,
                                alpha.to(encoded.features.dtype))
        h2, c2 = L.lstm_cell(
            params["lstm_lang"],
            flat(torch.cat([attended, h1.reshape(b, k, -1)], dim=-1)),
            flat(state["h2"]), flat(state["c2"]), prepared=ex.get("lang_cat"))
        rs = lambda x: x.reshape(b, k, -1)                    # noqa: E731
        return rs(h2), {"h1": rs(h1), "c1": rs(c1),
                        "h2": rs(h2), "c2": rs(c2)}, alpha


@register("BUTDSpatial")
class BUTDSpatialCaptioner(_BUTDBase):
    has_cnn = True

    def _features(self, params, visual, model_state, train=False):
        if "spatial_feats" in visual:             # precomputed (B, 49, 2048)
            return visual["spatial_feats"], None, model_state
        fmap, model_state = self._cnn_features(params, visual, model_state,
                                               train)
        feats = resnet.spatial_features(fmap, self.config.enc_img_size)
        return feats.to(params["att_enc"]["v"].dtype), None, model_state


@register("BUTDDetection")
class BUTDDetectionCaptioner(_BUTDBase):

    def _features(self, params, visual, model_state, train=False):
        return visual["bu_feats"], visual.get("bu_masks"), model_state
