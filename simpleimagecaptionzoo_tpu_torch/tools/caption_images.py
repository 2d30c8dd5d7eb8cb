"""Caption every image of a directory with a trained checkpoint (the JAX
package's ``tools/caption_images.py``).

    python -m simpleimagecaptionzoo_tpu_torch.tools.caption_images \
        --image_dir ./photos --dataset COCO14 --model_type BUTDSpatial \
        [--beam 3] [--dtype bfloat16] [--gpu_id 0] [--out caps.json]

Images stream through a threaded decode+resize pool (8 workers) as uint8;
chunk i+1 loads on the host while chunk i decodes on the card (batched
beam search, bf16 by default).  The pixels go to the card pinned and
without blocking (``engine/engine.to_device``).  A corrupt image is
replaced by black pixels, reported and left out of the results; the last
chunk is padded by repeating its last image, so every decode has one
shape.  ``--gpu_id`` picks the card (``cpu`` runs the kernels' plain
versions on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from simpleimagecaptionzoo_tpu_torch.data.datasets import load_image_uint8

EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--dataset", default="COCO14")
    ap.add_argument("--model_type", default="BUTDSpatial")
    ap.add_argument("--dataset_config_root", default="./Configs/Datasets/")
    ap.add_argument("--model_config_root", default="./Configs/Models/")
    ap.add_argument("--checkpoint_root", default="./CheckPoints")
    ap.add_argument("--use_scst_model", action="store_true")
    ap.add_argument("--beam", type=int, default=3,
                    help="-1 for greedy")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--img_size", type=int, default=224)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8"],
                    help="int8 = bf16 activations + weight-only int8 decode "
                         "hot set (ops/quant.py)")
    ap.add_argument("--out", default="captions.json")
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the CUDA card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def main(argv=None) -> int:
    from simpleimagecaptionzoo_tpu_torch.engine.engine import to_device
    from simpleimagecaptionzoo_tpu_torch.inference import \
        load_inference_bundle
    from simpleimagecaptionzoo_tpu_torch.main import device_of
    args = build_argparser().parse_args(argv)
    bundle = load_inference_bundle(
        dataset=args.dataset, model_type=args.model_type,
        dataset_config_root=args.dataset_config_root,
        model_config_root=args.model_config_root,
        checkpoint_root=args.checkpoint_root,
        use_scst_model=args.use_scst_model, beam=args.beam,
        dtype=args.dtype, device=device_of(args.gpu_id))
    vocab, tree, dec = bundle.vocab, bundle.tree, bundle.decode

    names = sorted(f for f in os.listdir(args.image_dir)
                   if f.lower().endswith(EXTS))
    if not names:
        raise SystemExit("no images in " + args.image_dir)
    results = []
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=8)
    failed: list = []

    def load_one(n):
        # one corrupt file must not abort a 10k-image run: substitute black
        # pixels, record the name, and leave it out of the results
        try:
            return load_image_uint8(os.path.join(args.image_dir, n),
                                    args.img_size)
        except Exception as e:
            failed.append(n)
            print(f"WARNING: skipping unreadable image {n!r}: {e}",
                  file=sys.stderr)
            return np.zeros((args.img_size, args.img_size, 3), np.uint8)

    def load_chunk(i):
        chunk = names[i:i + args.batch]
        real = len(chunk)
        while len(chunk) < args.batch:        # one shape for every decode
            chunk.append(chunk[-1])
        imgs = list(pool.map(load_one, chunk))
        return chunk, real, np.stack(imgs)

    # double buffer: chunk i+1 loads on the host while chunk i decodes
    try:
        starts = list(range(0, len(names), args.batch))
        pending = pool.submit(load_chunk, starts[0])
        for k, _ in enumerate(starts):
            chunk, real, imgs = pending.result()
            if k + 1 < len(starts):
                pending = pool.submit(load_chunk, starts[k + 1])
            ids = dec(tree["params"], tree["model_state"],
                      {"img_tensors": to_device(imgs, bundle.device)})
            ids = ids.cpu().numpy()
            for name, row in zip(chunk[:real], ids[:real]):
                results.append({"file_name": name,
                                "caption": " ".join(vocab.decode_ids(row))})
    finally:
        pool.shutdown(wait=True)
    dt = time.perf_counter() - t0
    bad = set(failed)
    if bad:
        results = [r for r in results if r["file_name"] not in bad]
        print(f"WARNING: {len(bad)} unreadable image(s) skipped: "
              + ", ".join(sorted(bad)[:10])
              + (" ..." if len(bad) > 10 else ""), file=sys.stderr)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"captioned {len(results)} images in {dt:.1f}s "
          f"({len(results) / max(dt, 1e-9):.1f} images/sec) -> {args.out}")
    for r in results[:5]:
        print(" ", r["file_name"], "->", r["caption"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
