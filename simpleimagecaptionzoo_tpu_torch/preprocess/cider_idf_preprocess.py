"""Build the CIDEr idf document-frequency tables for a dataset's train split
(the JAX package's ``preprocess/cider_idf_preprocess.py``; reference
PreProcess/CIDEr_idf_preproccess.py:41-82).

Two outputs per dataset:
* ``<out_dir>/<ds>-train.p`` — the reference-format pickle
  ({'document_frequency': {word-tuple: df}, 'ref_len': n_images}, protocol
  2) consumed by the host-side CiderD scorer (evalcap/cider_scorer.py) —
  interchange-compatible with the reference's ``cider/data/<ds>-train.p``.
* ``<out_dir>/cider_idf_table.npz`` — the same document frequencies as
  sorted hash arrays for the on-device SCST reward (``ops/cider.py``),
  with ``hash_version``; built against the dataset's caption vocabulary
  so token-id hashing matches training time.

``--operation check`` reloads and prints entries (reference :84-95).

    python -m simpleimagecaptionzoo_tpu_torch.preprocess.cider_idf_preprocess \
        --dataset COCO14 --train_caption_path .../captions_train.json \
        --vocab_path Data/MSCOCO/2014/caption_vocab.pkl \
        --out_dir Data/MSCOCO/2014
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from collections import defaultdict

import numpy as np

from simpleimagecaptionzoo_tpu_torch.ops.cider import (HASH_VERSION,
                                                       CiderDTable,
                                                       RewardVocab)
from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab


def build_word_df(train_caption_path: str):
    """{word-tuple ngram: document frequency} over train images + n_images
    (reference compute_doc_freq/build_dict :41-70: df counts the number of
    *images* whose references contain the ngram)."""
    with open(train_caption_path) as f:
        data = json.load(f)
    df: dict = defaultdict(float)
    imgs = data["images"]
    for img in imgs:
        seen = set()
        for sent in img["sentences"]:
            toks = sent["tokens"]
            for n in range(1, 5):
                for i in range(len(toks) - n + 1):
                    seen.add(tuple(toks[i:i + n]))
        for ng in seen:
            df[ng] += 1.0
    return dict(df), len(imgs)


def build(train_caption_path: str, dataset: str, out_dir: str,
          vocab_path: str = "") -> None:
    os.makedirs(out_dir, exist_ok=True)
    df, ref_len = build_word_df(train_caption_path)
    pkl_path = os.path.join(out_dir, f"{dataset}-train.p")
    with open(pkl_path, "wb") as f:
        pickle.dump({"document_frequency": df, "ref_len": ref_len}, f,
                    protocol=2)
    print(f"dumped {len(df)} ngrams, ref_len={ref_len} -> {pkl_path}")

    if vocab_path:
        reward_vocab = RewardVocab(load_vocab(vocab_path))
        table = CiderDTable.from_reference_pickle(pkl_path, reward_vocab)
        npz_path = os.path.join(out_dir, "cider_idf_table.npz")
        np.savez(npz_path, h1=table.h1, h2=table.h2, df=table.df,
                 log_ref_len=table.log_ref_len, hash_version=HASH_VERSION)
        print(f"device idf table ({len(table.h1)} hashed ngrams) -> {npz_path}")


def check(dataset: str, out_dir: str, probe_word: str = "vehicle") -> None:
    with open(os.path.join(out_dir, f"{dataset}-train.p"), "rb") as f:
        pkl = pickle.load(f, encoding="latin1")
    print("ref_len:", pkl["ref_len"])
    dfd = pkl["document_frequency"]
    print("doc_freq_len:", len(dfd))
    shown = 0
    for key, value in dfd.items():
        if probe_word in key:
            print(key, value)
            shown += 1
            if shown >= 10:
                break


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--operation", default="build", choices=["build", "check"])
    p.add_argument("--dataset", default="COCO14")
    p.add_argument("--train_caption_path", default="")
    p.add_argument("--vocab_path", default="",
                   help="caption_vocab.pkl; enables the device-table export")
    p.add_argument("--out_dir", default="./Data/cider")
    a = p.parse_args(argv)
    if a.operation == "build":
        build(a.train_caption_path, a.dataset, a.out_dir, a.vocab_path)
    else:
        check(a.dataset, a.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
