"""NIC ("Show and Tell") captioner.

Counterpart of the JAX package's ``models/nic.py`` (reference
Models/NIC_Model.py): a weight-norm linear embedding of the pooled
ResNet-101 feature, fed through the LSTM cell from zeros as the step -1
input (NIC_Model.py:52-56), then one cell a step over the word embedding,
and the weight-norm head.  The reference's ``BatchNorm1d`` (NIC_Model.py:25)
is never applied in its forward, so neither package has it.

NIC has no attention: ``step_core`` returns alpha None, so greedy decode
returns no alphas and beam search's ``return_alphas`` gives zeros over its
single feature row.  Beam search runs the base class's lanes step and lane
state, as the JAX package does: the lanes are flattened into the batch,
and ``init_state``'s cell runs over the B*k identical rows of the
broadcast image embedding.  The cell's concatenated weight
(``extras["lstm_cat"]``, with its TF32 split in float32) is made once in
encode, as AoA's.

Int8 serving (``quantize_decode_params``): the cell and the head are
weight-only int8 (kernel K3 once a step and once in ``init_state``;
K1-int8 for the head).  NIC has no K/V, so ``SICZ_TPU_INT8_KV`` does not
apply.

From pixels (``visual["img_tensors"]``, with ``cnn`` in the params):
``prepare_images``, the ResNet-101, its global average pool (float32,
cast to the embedding's dtype, ``models/base.py``), then the embedding.

Teacher forcing's hoist, as in the JAX package's default mode
(``SICZ_TPU_PALLAS_LSTM`` ``auto`` or ``off``): the cell's input is the
word embedding alone, so with scheduled sampling off
:meth:`NICCaptioner.tf_inputs` projects all of it before the loop (emb @
w_ih + b_ih) and each step runs K2 at E = 0 (``w_hh`` and b_hh alone) with
that step's projection as its gate term.  Under ``interpret``, with
scheduled sampling on, and in decode the cell takes the embedding every
step.  The embedding has no dropout (NIC_Model.py:58-60), so NIC draws no
embedding masks.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.models import resnet
from simpleimagecaptionzoo_tpu_torch.models.base import (Captioner, Encoded,
                                                         register)
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm, quant


@register("NIC")
class NICCaptioner(Captioner):
    decode_quant_paths = (("lstm",), ("predict",))
    has_cnn = True

    def init_params(self, gen: torch.Generator,
                    include_cnn: bool = False) -> dict:
        """The JAX package's tree, drawn from ``gen`` on its device; with
        ``cnn`` when ``include_cnn`` (``Captioner.init_params``)."""
        cfg = self.config
        return self._add_cnn({
            "img_embed": L.dense_wn_init(gen, cfg.enc_dim, cfg.embed_dim),
            "embed": L.embedding_init(gen, cfg.vocab_size, cfg.embed_dim),
            "lstm": L.lstm_cell_init(gen, cfg.embed_dim, cfg.hidden_dim),
            "predict": L.dense_wn_init(gen, cfg.hidden_dim, cfg.vocab_size),
        }, gen, include_cnn)

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        if "features" in visual:                   # precomputed (B, 2048)
            feats = visual["features"]
        else:
            fmap, model_state = self._cnn_features(params, visual,
                                                   model_state, train)
            feats = resnet.global_pool(fmap).to(
                params["img_embed"]["v"].dtype)
        emb = L.dense_wn(params["img_embed"], feats)           # (B, E)
        extras = {}
        if not quant.is_quantized(params["lstm"]):
            extras["lstm_cat"] = fused_lstm.prepare_lstm(params["lstm"])
        return (Encoded(features=emb[:, None, :], mean=emb, mask=None,
                        extras=extras), model_state)

    def init_state(self, params, encoded: Encoded):
        """Step -1: the image embedding through the cell from zeros
        (NIC_Model.py:52-56)."""
        b = encoded.mean.shape[0]
        z = torch.zeros((b, self.config.hidden_dim), dtype=encoded.mean.dtype,
                        device=encoded.mean.device)
        h, c = L.lstm_cell(params["lstm"], encoded.mean, z, z,
                           prepared=(encoded.extras or {}).get("lstm_cat"))
        return {"h": h, "c": c}

    def emb_dropout_masks(self, n_steps, b, train, generator, device):
        """None: NIC's embedding has no dropout."""
        return None

    def tf_inputs(self, params, encoded: Encoded, tokens: torch.Tensor,
                  emb_masks):
        """Teacher forcing's hoist (the JAX package's ``tf_inputs``,
        ``models/nic.py:91``): {"term": emb @ w_ih + b_ih (T, B, 4H),
        "cell": ``w_hh`` and b_hh alone}.  None where the cell is not
        hoisted."""
        lstm = params["lstm"]
        if not L.hoist_lstm_inputs(lstm):
            return None
        emb = L.embedding(params["embed"], tokens)               # (T,B,E)
        return {"term": (emb @ lstm["w_ih"] + lstm["b_ih"]).contiguous(),
                "cell": fused_lstm.prepare_lstm(lstm, keep=())}

    def step_core(self, params, encoded: Encoded, state,
                  tokens: torch.Tensor, *, train: bool = False,
                  generator=None, tf_input=None, emb_mask=None):
        if tf_input is not None:
            # teacher forcing's hoist: the whole input in the term, E = 0
            x = state["h"].new_empty((state["h"].shape[0], 0))
            h, c = L.lstm_cell(params["lstm"], x, state["h"], state["c"],
                               prepared=tf_input["cell"],
                               term=tf_input["term"])
        else:
            emb = L.embedding(params["embed"], tokens)
            h, c = L.lstm_cell(params["lstm"], emb, state["h"], state["c"],
                               prepared=(encoded.extras or {}).get(
                                   "lstm_cat"))
        out = L.dropout(h, self.config.dropout, train, generator)
        return out, {"h": h, "c": c}, None
