"""Extract per-image bottom-up faster-rcnn features from Peter Anderson's
base64 TSV dumps (the JAX package's
``preprocess/generate_bottom_up_features.py``; reference
PreProcess/Generate_coco14_bottom_up_features_data.py:24-59).

    python -m simpleimagecaptionzoo_tpu_torch.preprocess.generate_bottom_up_features \
        --operation generate --bu_type fixed --tsv trainval_36/*.tsv \
        --output_dir Data/MSCOCO/2014/

* ``--operation generate``: TSV rows -> ``<out>/{fixed,adaptive}_bu_feat/
  <imgid>.npz`` ('feat', (N, 2048)) + ``..._bu_bbox/<imgid>.npy`` (N, 4) —
  the exact per-image layout the data layer and the reference consume.
* ``--operation pack``: additionally packs the per-image npz files into one
  memory-mapped shard pair (``bu_feats.dat`` float32 (n_imgs, max_len, 2048)
  + ``bu_index.json``) for sequential-read feeding at the card's ingest
  rates (SURVEY.md §2a #21: "pack into sharded arrays for HBM-friendly
  feeding").
* ``--operation check``: reload one image's arrays and report shapes
  (reference :61-103 renders bboxes; pass ``--image`` to also save a
  visualization png).
"""
from __future__ import annotations

import argparse
import base64
import csv
import json
import os
import sys

import numpy as np

csv.field_size_limit(sys.maxsize)

FIELDS = ["image_id", "image_w", "image_h", "num_boxes", "boxes", "features"]


def generate(tsv_paths, bu_type: str, output_dir: str) -> int:
    feat_dir = os.path.join(output_dir, f"{bu_type}_bu_feat")
    bbox_dir = os.path.join(output_dir, f"{bu_type}_bu_bbox")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(bbox_dir, exist_ok=True)
    n = 0
    for path in tsv_paths:
        print("reading", path)
        with open(path) as f:
            for item in csv.DictReader(f, delimiter="\t", fieldnames=FIELDS):
                nb = int(item["num_boxes"])
                boxes = np.frombuffer(base64.b64decode(item["boxes"]),
                                      dtype=np.float32).reshape(nb, -1)
                feats = np.frombuffer(base64.b64decode(item["features"]),
                                      dtype=np.float32).reshape(nb, -1)
                np.savez_compressed(
                    os.path.join(feat_dir, str(item["image_id"])), feat=feats)
                np.save(os.path.join(bbox_dir, str(item["image_id"])), boxes)
                n += 1
    print(f"saved features for {n} images")
    return n


def pack(output_dir: str, bu_type: str, max_len: int) -> None:
    feat_dir = os.path.join(output_dir, f"{bu_type}_bu_feat")
    names = sorted(f[:-4] for f in os.listdir(feat_dir) if f.endswith(".npz"))
    if not names:
        print("nothing to pack")
        return
    first = np.load(os.path.join(feat_dir, names[0] + ".npz"))["feat"]
    dim = first.shape[1]
    shard = np.lib.format.open_memmap(
        os.path.join(output_dir, f"{bu_type}_bu_feats_packed.npy"),
        mode="w+", dtype=np.float32, shape=(len(names), max_len, dim))
    lengths = {}
    n_trunc = 0
    for i, name in enumerate(names):
        feat = np.load(os.path.join(feat_dir, name + ".npz"))["feat"]
        k = min(feat.shape[0], max_len)
        n_trunc += int(feat.shape[0] > max_len)
        shard[i, :k] = feat[:k]
        lengths[name] = int(k)
    shard.flush()
    if n_trunc:
        print(f"WARNING: {n_trunc}/{len(names)} images had more than "
              f"--max_len {max_len} boxes and were TRUNCATED in the packed "
              f"shard; adaptive features go up to 100 boxes — repack with "
              f"--max_len 100 if your training config uses more than "
              f"{max_len}. (The data layer refuses a shard narrower than "
              f"its configured max_bu_len.)")
    with open(os.path.join(output_dir, f"{bu_type}_bu_index.json"), "w") as f:
        json.dump({"order": names, "lengths": lengths, "max_len": max_len,
                   "dim": dim}, f)
    print(f"packed {len(names)} images -> "
          f"{bu_type}_bu_feats_packed.npy + {bu_type}_bu_index.json")


def check(output_dir: str, bu_type: str, img_id: str,
          image_path: str = "") -> None:
    feat = np.load(os.path.join(output_dir, f"{bu_type}_bu_feat",
                                f"{img_id}.npz"))["feat"]
    bbox = np.load(os.path.join(output_dir, f"{bu_type}_bu_bbox",
                                f"{img_id}.npy"))
    print(f"image {img_id}: feat {feat.shape} bbox {bbox.shape}")
    if image_path:
        from PIL import Image
        from simpleimagecaptionzoo_tpu_torch.utils.visualize import (
            visualize_att_bboxes)
        img = np.asarray(Image.open(image_path).convert("RGB"))
        alphas = np.ones((1, bbox.shape[0]), np.float32)
        visualize_att_bboxes(img, alphas, bbox, ["boxes"],
                             save_path=f"{bu_type}_bu_bbox_visualization.png")
        print(f"saved {bu_type}_bu_bbox_visualization.png")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--operation", default="generate",
                   choices=["generate", "pack", "check"])
    p.add_argument("--tsv", nargs="*", default=[])
    p.add_argument("--bu_type", default="fixed",
                   choices=["fixed", "adaptive"])
    p.add_argument("--output_dir", default="./Data/MSCOCO/2014/")
    p.add_argument("--max_len", type=int, default=36)
    p.add_argument("--img_id", default="")
    p.add_argument("--image", default="")
    a = p.parse_args(argv)
    if a.operation == "generate":
        generate(a.tsv, a.bu_type, a.output_dir)
    elif a.operation == "pack":
        pack(a.output_dir, a.bu_type, a.max_len)
    else:
        check(a.output_dir, a.bu_type, a.img_id, a.image)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
