"""Pack decoded+resized images into one memory-mapped uint8 shard (the JAX
package's ``preprocess/pack_images.py``).

A from-pixels trainer consumes hundreds of images a second, while JPEG
decode+resize on a host core manages tens of images a second: on real
datasets the CNN-path trainer is host-bound (SURVEY.md §7 "input pipeline
throughput").  The fix is the same one the
bottom-up path uses (generate_bottom_up_features.py --operation pack): do
the decode ONCE offline into a packed ``(N, S, S, 3)`` uint8 memmap, and
feed training from mmap'd rows (a 150 KB memcpy per image instead of a
JPEG inflate + resample).

    python -m simpleimagecaptionzoo_tpu_torch.preprocess.pack_images \
        --annotations Data/.../captions_train.json [more jsons ...] \
        --image_root Data/.../images --dataset Flickr8K \
        --output_dir Data/... [--size 224]

Writes ``images_<size>_packed.npy`` + ``images_<size>_index.json`` into
``output_dir``; the data layer picks them up automatically
(``data/datasets._VisualSource``).  Disk cost: N x 3S^2 bytes (COCO14
train+val ~ 18.6 GB at S=224), the standard disk-for-host-throughput
trade.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from simpleimagecaptionzoo_tpu_torch.data.datasets import (image_path,
                                                           load_image_uint8)


def pack(annotation_paths, image_root: str, dataset: str, output_dir: str,
         size: int = 224, workers: int = 8) -> str:
    """Decode/resize every image referenced by the annotation jsons into
    one uint8 memmap shard.  Returns the shard path."""
    from concurrent.futures import ThreadPoolExecutor

    entries = []         # (file_name, split)
    seen = set()
    for ann_path in annotation_paths:
        split = ("train" if "train" in os.path.basename(ann_path)
                 else "val" if "val" in os.path.basename(ann_path)
                 else "test")
        with open(ann_path) as f:
            data = json.load(f)
        for img in data["images"]:
            name = img["file_name"]
            if name not in seen:
                seen.add(name)
                entries.append((name, split))

    os.makedirs(output_dir, exist_ok=True)
    shard_path = os.path.join(output_dir, f"images_{size}_packed.npy")
    index_path = os.path.join(output_dir, f"images_{size}_index.json")
    shard = np.lib.format.open_memmap(
        shard_path + ".tmp", mode="w+", dtype=np.uint8,
        shape=(len(entries), size, size, 3))

    def work(i_entry):
        i, (name, split) = i_entry
        shard[i] = load_image_uint8(
            image_path(image_root, name, dataset, split), size)
        return i

    with ThreadPoolExecutor(max_workers=workers) as pool:
        done = 0
        for _ in pool.map(work, enumerate(entries)):
            done += 1
            if done % 2000 == 0:
                print(f"  packed {done}/{len(entries)}", flush=True)
    shard.flush()
    del shard
    os.replace(shard_path + ".tmp", shard_path)
    with open(index_path, "w") as f:
        json.dump({"order": [name for name, _ in entries], "size": size,
                   # identity: _VisualSource refuses a shard packed from a
                   # different dataset/image_root (same-named files would
                   # silently substitute wrong pixels otherwise)
                   "dataset": dataset,
                   "image_root": os.path.abspath(image_root)},
                  f)
    print(f"packed {len(entries)} images -> {shard_path} "
          f"({os.path.getsize(shard_path) / 1e9:.2f} GB)")
    return shard_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--annotations", nargs="+", required=True,
                    help="modified_annotations/captions_*.json files")
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--dataset", required=True,
                    help="Flickr8K|Flickr30K|COCO14|COCO17 (path routing)")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    pack(args.annotations, args.image_root, args.dataset, args.output_dir,
         size=args.size, workers=args.workers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
