"""Build the caption vocabulary from the train-split modified annotations
(the JAX package's ``preprocess/build_caption_vocab.py``; reference
PreProcess/Build_caption_vocab.py:22-45): count train tokens, keep words
with count >= threshold, specials <pad>/<sta>/<end>/<unk> first (ids
0/1/2/3), pickle to ``--vocab_path``.  Either package's ``load_vocab``
reads the pickle.

    python -m simpleimagecaptionzoo_tpu_torch.preprocess.build_caption_vocab \
        --train_caption_path .../modified_annotations/captions_train.json \
        --vocab_path Data/MSCOCO/2014/caption_vocab.pkl
"""
from __future__ import annotations

import argparse
import json
import os

from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab, save_vocab


def build_from_annotations(train_caption_path: str, vocab_path: str,
                           threshold: int = 5):
    with open(train_caption_path) as f:
        data = json.load(f)
    vocab = build_vocab((ann["tokens"] for ann in data["annotations"]),
                        threshold=threshold)
    os.makedirs(os.path.dirname(vocab_path) or ".", exist_ok=True)
    save_vocab(vocab, vocab_path)
    print(f"vocab size {len(vocab)} (threshold {threshold}) -> {vocab_path}")
    return vocab


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--train_caption_path", required=True)
    p.add_argument("--vocab_path", required=True)
    p.add_argument("--threshold", type=int, default=5)
    a = p.parse_args(argv)
    build_from_annotations(a.train_caption_path, a.vocab_path, a.threshold)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
