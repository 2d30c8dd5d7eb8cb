"""The layout the port's inference tests serve from (not a test module):
a dataset config, a vocabulary and a model json in the reference layout,
and a best checkpoint written by the JAX package's ``CheckpointManager``,
for NIC, BUTDSpatial and AoASpatial at small widths with the ResNet at
block counts (1, 1, 1, 1) (both packages' ``BLOCK_COUNTS`` patched by
:func:`shallow_f32_trunks`, which also makes both trunks float32, so the
two packages' ids are comparable row for row).

The running statistics in the checkpoint are a calibration batch's own
(one train-mode apply at ``BN_MOMENTUM`` 1.0, as tests/test_torch_pixels.py
calibrates them), so the features are O(1) and the images choose the
words.  Used by tests/test_torch_inference.py,
tests/test_torch_caption_images.py and tests/test_torch_caption_server.py.
"""
import contextlib
import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.engine.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from simpleimagecaptionzoo_tpu.models import resnet as JR
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import image as JI
from simpleimagecaptionzoo_tpu.vocab import SPECIALS, Vocabulary
from simpleimagecaptionzoo_tpu_torch.models import resnet as TR

DATASET = "TinyDS"
WORDS = tuple("w%d" % i for i in range(46))        # vocabulary of 50
MODELS = {
    "NIC": dict(embed_dim=64, hidden_dim=128),
    "BUTDSpatial": dict(embed_dim=32, hidden_dim=64, atten_dim=32),
    "AoASpatial": dict(embed_dim=32, hidden_dim=64, num_heads=4,
                       num_refine_layers=1),
}
CAL_B = 8


@contextlib.contextmanager
def shallow_f32_trunks():
    """Both packages' ResNet at block counts (1, 1, 1, 1), ``apply``
    defaulting to a float32 trunk."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "BLOCK_COUNTS", (1, 1, 1, 1))
        mp.setattr(TR, "BLOCK_COUNTS", (1, 1, 1, 1))
        mp.setattr(JR.apply, "__defaults__", (jnp.float32, False))
        mp.setattr(TR.apply, "__defaults__", (torch.float32, False))
        yield


def photos(n, side, seed):
    """Photo-like uint8 images (n, side, side, 3): smoothed noise over a
    gradient and a checkerboard (tests/test_torch_pixels.py's recipe)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (n, side, side, 3)).astype(np.float32)
    for _ in range(3):
        img = (np.roll(img, 1, 1) + np.roll(img, -1, 1) + np.roll(img, 1, 2)
               + np.roll(img, -1, 2) + img) / 5
    yy, xx = np.mgrid[0:side, 0:side] / side
    for i in range(n):
        angle = rng.uniform(0, 2 * np.pi)
        ramp = (np.cos(angle) * xx + np.sin(angle) * yy + 1) / 2
        period = int(rng.choice([8, 16, 32, 64]))
        checker = ((np.mgrid[0:side, 0:side] // period).sum(0) % 2)
        mix = rng.uniform(0, 1, size=(3, 2))
        for c in range(3):
            img[i, ..., c] = (img[i, ..., c] * 0.3 + mix[c, 0] * ramp * 200
                              + mix[c, 1] * checker * 120)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(img: np.ndarray) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def write_layout(root, family: str, seed: int = 0) -> dict:
    """The reference layout under ``root`` (inside
    :func:`shallow_f32_trunks`): Configs/Datasets/TinyDS.data,
    Configs/Models/<family>.json, caption_vocab.pkl (the JAX package's
    Vocabulary) and CheckPoints/.../best/Captioner_cp.msgpack written by
    the JAX package.  -> the tools' flags for this layout."""
    root = str(root)
    vocab = Vocabulary()
    for w in SPECIALS + WORDS:
        vocab.add_word(w)
    with open(os.path.join(root, "caption_vocab.pkl"), "wb") as f:
        pickle.dump(vocab, f)
    ds_root = os.path.join(root, "Configs", "Datasets")
    md_root = os.path.join(root, "Configs", "Models")
    os.makedirs(ds_root, exist_ok=True)
    os.makedirs(md_root, exist_ok=True)
    with open(os.path.join(ds_root, DATASET + ".data"), "w") as f:
        f.write("image_root=/photos/\ndata_dir=/\n"
                "caption_vocab_path=/caption_vocab.pkl\n")
    dims = MODELS[family]
    with open(os.path.join(md_root, family + ".json"), "w") as f:
        json.dump(dict(dims, model_type=family), f)
    jm = jax_get(JaxModelConfig(model_type=family, vocab_size=len(vocab),
                                **dims))
    p = jax.tree_util.tree_map(np.asarray, jm.init_params(
        jax.random.PRNGKey(seed), include_cnn=True))
    if family == "NIC":
        # at random init NIC's head bias outweighs h @ W and the word
        # embedding the image's: a sharper image embedding, cell input and
        # head, no head bias, let the image choose the words
        # (tests/test_torch_pixels.py)
        p["img_embed"]["g"] = p["img_embed"]["g"] * 10
        p["lstm"]["w_ih"] = p["lstm"]["w_ih"] * 4
        p["predict"]["g"] = p["predict"]["g"] * 10
        p["predict"]["b"] = np.zeros_like(p["predict"]["b"])
    stats = jm.init_model_state()["cnn_stats"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "BN_MOMENTUM", 1.0)
        _, cal = JR.apply(jax.tree_util.tree_map(jnp.asarray, p["cnn"]),
                          stats,
                          JI.normalize(jnp.asarray(photos(CAL_B, 224, 5))),
                          dtype=jnp.float32, train=True)
    ck_root = os.path.join(root, "CheckPoints")
    JaxCheckpointManager(family, DATASET, root=ck_root).save_best(
        {"params": p, "model_state": {"cnn_stats": cal}}, 0.0)
    return dict(dataset=DATASET, model_type=family,
                dataset_config_root=ds_root + os.sep,
                model_config_root=md_root + os.sep, checkpoint_root=ck_root,
                base_dir=root)


def flags(layout: dict) -> list:
    """The tools' command-line flags for ``layout``."""
    return ["--dataset", layout["dataset"], "--model_type",
            layout["model_type"], "--dataset_config_root",
            layout["dataset_config_root"], "--model_config_root",
            layout["model_config_root"], "--checkpoint_root",
            layout["checkpoint_root"]]


def jax_bundle(layout: dict, beam: int, dtype: str):
    from simpleimagecaptionzoo_tpu.inference import load_inference_bundle
    return load_inference_bundle(use_scst_model=False, beam=beam,
                                 dtype=dtype, **layout)


def jax_captions(bundle, images: np.ndarray) -> list:
    """The JAX bundle's captions of ``images`` (one decode)."""
    ids = np.asarray(bundle.decode(bundle.tree["params"],
                                   bundle.tree["model_state"],
                                   {"img_tensors": jnp.asarray(images)}))
    return [" ".join(bundle.vocab.decode_ids(row)) for row in ids]
