"""Model and training configuration: the ``.data`` key=value parser, the
static model hyperparameters and the training knobs with their LR and
scheduled-sampling schedules, kept field for field with the JAX package's
``config.py`` so one model json configures both."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


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


@dataclasses.dataclass(frozen=True)
class LrOpts:
    """Staircase LR decay + staged CNN finetune schedule
    (reference Engine.py:126-138, Main.py:163-172 defaults)."""

    learning_rate: float = 4e-4
    cnn_finetune_learning_rate: float = 1e-4
    cnn_finetune_start: int = 8
    lr_dec_start_epoch: int = 0
    lr_dec_every: int = 3
    lr_dec_rate: float = 0.8

    def decay_factor(self, epoch: int) -> float:
        if epoch > self.lr_dec_start_epoch and self.lr_dec_start_epoch >= 0:
            frac = (epoch - self.lr_dec_start_epoch) // self.lr_dec_every
            return self.lr_dec_rate ** frac
        return 1.0

    def lrs_for_epoch(self, epoch: int, cnn_ft_model: bool,
                      cnn_ft_enabled: bool) -> tuple:
        """(main lr, cnn finetune lr) for this epoch (Engine.py:135)."""
        lr = self.learning_rate * self.decay_factor(epoch)
        cnn_lr = min(self.cnn_finetune_learning_rate
                     * (1.0 if cnn_ft_model else 0.0), lr)
        return lr, cnn_lr * (1.0 if cnn_ft_enabled else 0.0)


@dataclasses.dataclass(frozen=True)
class SsOpts:
    """Scheduled sampling schedule (reference Engine.py:140-144,
    Main.py:166-169 defaults)."""

    ss_start_epoch: int = 0
    ss_inc_every: int = 5
    ss_inc_prob: float = 0.05
    ss_max_prob: float = 0.5

    def prob_for_epoch(self, epoch: int) -> float:
        if epoch > self.ss_start_epoch and self.ss_start_epoch >= 0:
            frac = (epoch - self.ss_start_epoch) // self.ss_inc_every
            return min(self.ss_inc_prob * frac, self.ss_max_prob)
        return 0.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Top-level training knobs, defaults matching Main.py:140-195: the
    steps (``engine/steps``), the epoch loops of ``engine/engine.Engine``
    and the data layer read them.  ``midepoch_save_steps`` must stay 0:
    the port has no step-level checkpoints (the engine refuses it)."""

    num_epochs: int = 30
    train_batch_size: int = 128
    label_smoothing: float = 0.1
    optimizer: str = "Adam"
    grad_clip: float = 0.1              # XE hard value clip (Engine.py:187)
    lr_opts: LrOpts = dataclasses.field(default_factory=LrOpts)
    ss_opts: SsOpts = dataclasses.field(default_factory=SsOpts)
    # sequence geometry
    max_caption_len: int = 22           # <sta> + 20 words + <end>
    decode_max_len: int = 20            # Engine.py:260,286
    beam_max_steps: int = 50            # NIC_Model.py:169
    # input resolution for from-pixels models (reference --img_size)
    img_size: int = 224
    # from-pixels host ingest: "parity", "fast" or "device" (the JAX
    # package's config.py documents each)
    image_ingest: str = "parity"
    # SCST
    scst_num_epochs: int = 50
    scst_train_batch_size: int = 128
    scst_learning_rate: float = 1e-5
    scst_cnn_finetune_learning_rate: float = 1e-5
    scst_grad_clip: float = 0.25        # Engine.py:271
    # on-device reward geometry: references per image, tokens per reference
    scst_num_refs: int = 7
    scst_max_ref_len: int = 32
    # eval
    eval_batch_size: int = 64
    eval_beam_size: int = 3
    decode_dtype: str = "float32"   # "bfloat16" halves decode traffic
    train_dtype: str = "float32"    # "bfloat16" = mixed precision (f32
                                    # master params/opt, bf16 compute)
    # crash tolerance: save params+opt_state+resume-point every N steps
    # (0 = epoch-boundary only, the reference's behavior)
    midepoch_save_steps: int = 0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Resolved dataset paths (from a ``.data`` file)."""

    dataset_name: str = "COCO14"
    image_root: str = ""
    train_caption_path: str = ""
    val_caption_path: str = ""
    test_caption_path: str = ""
    data_dir: str = ""
    caption_vocab_path: str = ""

    @classmethod
    def from_data_file(cls, path: str, base_dir: Optional[str] = None,
                       dataset_name: Optional[str] = None) -> "DataConfig":
        base_dir = base_dir or os.path.abspath(os.path.dirname(path) + "/../..")
        opt = parse_data_config(path, base_dir)
        name = dataset_name or os.path.splitext(os.path.basename(path))[0]
        return cls(
            dataset_name=name,
            image_root=opt.get("image_root", ""),
            train_caption_path=opt.get("train_caption_path", ""),
            val_caption_path=opt.get("val_caption_path", ""),
            test_caption_path=opt.get("test_caption_path", ""),
            data_dir=opt.get("data_dir", ""),
            caption_vocab_path=opt.get("caption_vocab_path", ""),
        )
