"""NIC ("Show and Tell") captioner, in feature mode.

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

From pixels (the ResNet-101) and ``tf_inputs`` wait for later slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch.models import layers as L
from simpleimagecaptionzoo_tpu_torch.models.base import (Captioner, Encoded,
                                                         register)
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm, quant


@register("NIC")
class NICCaptioner(Captioner):
    decode_quant_paths = (("lstm",), ("predict",))

    def init_params(self, gen: torch.Generator) -> dict:
        """Parameters on ``gen.device``, drawn from ``gen``: the JAX
        package's tree without ``cnn``."""
        cfg = self.config
        return {
            "img_embed": L.dense_wn_init(gen, cfg.enc_dim, cfg.embed_dim),
            "embed": L.embedding_init(gen, cfg.vocab_size, cfg.embed_dim),
            "lstm": L.lstm_cell_init(gen, cfg.embed_dim, cfg.hidden_dim),
            "predict": L.dense_wn_init(gen, cfg.hidden_dim, cfg.vocab_size),
        }

    def encode(self, params, visual: Dict[str, torch.Tensor], *,
               train: bool = False, generator=None,
               model_state: Optional[dict] = None
               ) -> Tuple[Encoded, Optional[dict]]:
        if "features" not in visual:
            raise NotImplementedError(
                "NIC from pixels (its ResNet-101) is not ported yet (ROADMAP "
                "Queue 1, slice 5); pass precomputed visual['features'] "
                "(B, 2048)")
        emb = L.dense_wn(params["img_embed"], visual["features"])  # (B, E)
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

    def step_core(self, params, encoded: Encoded, state,
                  tokens: torch.Tensor, *, train: bool = False,
                  generator=None):
        emb = L.embedding(params["embed"], tokens)
        h, c = L.lstm_cell(params["lstm"], emb, state["h"], state["c"],
                           prepared=(encoded.extras or {}).get("lstm_cat"))
        out = L.dropout(h, self.config.dropout, train, generator)
        return out, {"h": h, "c": c}, None
