"""Shared bootstrap of the port's inference surfaces (the JAX package's
``inference.py``).

``tools/caption_images.py`` (a directory of photos, offline) and
``tools/caption_server.py`` (HTTP serving) load the same things in the same
order: dataset config -> vocab -> model config -> best (or SCST-best)
checkpoint -> decode-dtype policy -> one decode function.  This module is
that path, so a change to the int8 handling or to the decode caps reaches
both surfaces.

The bundle's tree lives on the decode device in the decode dtype: the
checkpoint's template is built there (``CheckpointManager.load`` lands each
tensor on its template leaf's device), and the floating leaves are cast
once, the int8 layers' ``q``/``s`` dicts keeping their types.  The decode
function's own cast (``engine/steps._cast_floats``) then finds nothing to
move or convert on a served batch; it computes the same function as a
bundle that kept float32 weights on the host.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from simpleimagecaptionzoo_tpu_torch.config import (DataConfig, ModelConfig,
                                                    load_model_config)
from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.engine import steps as S
from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import CheckpointManager
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.vocab import Vocabulary, load_vocab

GREEDY_MAX_LEN = 20       # reference decode cap (Engine.py:260,286)
BEAM_MAX_LEN = 50         # reference beam step cap (NIC_Model.py:169)


@dataclass
class InferenceBundle:
    data_cfg: DataConfig
    model_cfg: ModelConfig
    vocab: Vocabulary
    model: Any
    tree: dict                      # {"params", "model_state"} on device
    decode: Callable                # decode(params, model_state, visual)
    beam: int
    dtype_name: str
    device: torch.device


def load_inference_bundle(*, dataset: str, model_type: str,
                          dataset_config_root: str, model_config_root: str,
                          checkpoint_root: str, use_scst_model: bool,
                          beam: int, dtype: str, base_dir: str | None = None,
                          device="cuda") -> InferenceBundle:
    """Load configs, vocab and the best checkpoint, and build the decode
    function on ``device`` (the GPU unless the caller asks for the CPU;
    without a card ``"cuda"`` raises).

    ``beam``: -1 for greedy (cap :data:`GREEDY_MAX_LEN`), >= 1 for beam
    search (cap :data:`BEAM_MAX_LEN`); any other value exits.  ``dtype``:
    float32 | bfloat16 | int8 (int8 = bf16 activations over
    ``model.quantize_decode_params``: K3 and K1's int8 case on the card).
    Raises SystemExit with the JAX package's messages for the detection
    families, a missing checkpoint and a bad ``beam``."""
    dev = resolve_device(device)
    data_cfg = DataConfig.from_data_file(
        os.path.join(dataset_config_root, dataset + ".data"),
        base_dir=base_dir or os.path.abspath(os.getcwd()),
        dataset_name=dataset)
    vocab = load_vocab(data_cfg.caption_vocab_path)
    model_cfg = load_model_config(
        os.path.join(model_config_root, model_type + ".json"),
        vocab_size=len(vocab))
    if model_cfg.uses_bu:
        raise SystemExit("Detection models need precomputed bottom-up "
                         "features; use a Spatial/NIC model for raw images.")
    model = get_captioner(model_cfg)
    ck = CheckpointManager(model_cfg.model_type, data_cfg.dataset_name,
                           root=checkpoint_root)
    gen = torch.Generator(device=dev).manual_seed(0)
    template = {"params": model.init_params(gen, include_cnn=True),
                "model_state": model.init_model_state()}
    tree, _, _ = ck.load(template, scst=use_scst_model, best=True)
    del template
    if tree is None:
        raise SystemExit("no checkpoint found under " + ck.root_dir)

    tdtype = None if dtype == "float32" else torch.bfloat16
    params = tree["params"]
    if dtype == "int8":
        params = model.quantize_decode_params(params)
    tree = {"params": S._cast_floats(params, tdtype, dev),
            "model_state": S._cast_floats(tree["model_state"], None, dev)}
    if beam == -1:
        dec = S.make_greedy_decode(model, GREEDY_MAX_LEN, dtype=tdtype,
                                   device=dev)
    elif beam >= 1:
        dec = S.make_beam_decode(model, beam, BEAM_MAX_LEN, dtype=tdtype,
                                 device=dev)
    else:
        raise SystemExit(f"--beam must be -1 (greedy) or >= 1, got {beam}")
    return InferenceBundle(data_cfg=data_cfg, model_cfg=model_cfg,
                           vocab=vocab, model=model, tree=tree, decode=dec,
                           beam=beam, dtype_name=dtype, device=dev)
