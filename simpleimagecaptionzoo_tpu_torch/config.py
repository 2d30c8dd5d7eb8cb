"""Model configuration: the ``.data`` key=value parser and the static model
hyperparameters, kept field for field with the JAX package's ``config.py`` so
one model json configures both."""
from __future__ import annotations

import dataclasses
import json


def parse_data_config(path: str, base_dir: str) -> dict:
    """Parse a ``.data`` key=value dataset config (reference Utils.py:23-36).

    Values containing '/' are prefixed with ``base_dir`` (the project root),
    matching the reference's path normalization.
    """
    options: dict = {}
    with open(path, "r") as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, value = line.split("=", 1)
            value = value.strip()
            if "/" in value:
                value = base_dir + value
            options[key.strip()] = value
    return options


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (reference Configs/Models/*.json)."""

    model_type: str = "NIC"
    vocab_size: int = 0
    embed_dim: int = 512
    hidden_dim: int = 512
    atten_dim: int = 1024          # BUTD concat-attention dim
    enc_img_size: int = 7          # spatial grid side -> 49 pixels
    enc_dim: int = 2048            # ResNet-101 / bottom-up feature channels
    num_heads: int = 8             # AoA multi-head attention
    num_refine_layers: int = 6     # AoA refiner depth (AoA_Model.py:150)
    dropout: float = 0.5
    dropout_aoa: float = 0.3
    dropout_sc: float = 0.1
    dropout_dot_atten: float = 0.1
    max_bu_len: int = 36           # static box count; 100 for 'adaptive' feats
    # preset learning rates carried in the model jsons
    optimizer: str = "Adam"
    lr: float = 4e-4
    scst_lr: float = 2e-5
    cnn_ft_lr: float = 1e-4
    scst_cnn_ft_lr: float = 1e-5

    @property
    def num_pixels(self) -> int:
        return self.enc_img_size * self.enc_img_size

    @property
    def uses_cnn(self) -> bool:
        """Models with a ResNet extractor (reference Engine.py:14)."""
        return self.model_type in ("NIC", "BUTDSpatial", "AoASpatial")

    @property
    def uses_bu(self) -> bool:
        return self.model_type in ("BUTDDetection", "AoADetection")


def load_model_config(path: str, vocab_size: int, **overrides) -> ModelConfig:
    """Load a reference-format model json (Utils.py:161-203 keys) into a
    :class:`ModelConfig`."""
    with open(path, "r") as f:
        settings = json.load(f)
    kwargs = dict(model_type=settings["model_type"], vocab_size=vocab_size)
    mapping = {
        "embed_dim": "embed_dim",
        "hidden_dim": "hidden_dim",
        "atten_dim": "atten_dim",
        "enc_img_size": "enc_img_size",
        "optimizer": "optimizer",
        "lr": "lr",
        "scst_lr": "scst_lr",
        "cnn_FT_lr": "cnn_ft_lr",
        "scst_cnn_FT_lr": "scst_cnn_ft_lr",
    }
    for json_key, field in mapping.items():
        if json_key in settings:
            kwargs[field] = settings[json_key]
    # any other key naming a ModelConfig field passes through directly
    # (enc_dim, max_bu_len, num_heads, ...); unknown keys are ignored like
    # the reference
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for key, val in settings.items():
        if key in fields and key not in kwargs:
            kwargs[key] = val
    kwargs.update(overrides)
    return ModelConfig(**kwargs)
