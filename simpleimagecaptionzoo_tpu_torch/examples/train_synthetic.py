"""Full-stack CLI training run on a generated shapes dataset through the
port — all five model families, and the synthetic-data quality gate.

The JAX package's ``examples/train_synthetic.py`` with the same flags,
defaults and files.  Generates a Flickr-style dataset of compositional
colored-shape scenes with templated captions ("a big red circle left of a
small blue square", with unmentioned distractors), plus synthetic
bottom-up features for the Detection families, runs the port's
preprocessing (Karpathy-json conversion, vocab build, CIDEr idf build,
bu-feature packing), then drives the port's CLI
(``simpleimagecaptionzoo_tpu_torch.main``) in this process for XE
training, a beam-3 test eval, greedy and beam-3 val evals of the XE best
(with ``--gate``), SCST fine-tuning and a sample.

    python -m simpleimagecaptionzoo_tpu_torch.examples.train_synthetic \
        --root /tmp/synth --epochs 6
    python -m simpleimagecaptionzoo_tpu_torch.examples.train_synthetic \
        --root /tmp/s2 --model AoADetection --n_images 1000 --epochs 4 \
        --scst_epochs 4 --gate --gate_out QUALITY.json

``--gpu_id`` (``0``, the default, is ``cuda:0``; ``cpu`` runs the CLI on
the CPU with the kernels' plain versions) is passed through to every CLI
call; without a card, ``--gpu_id 0`` fails with the CLI's own error.  The
gate's decision is :func:`gate_record`; its record has the JAX script's
keys and one more, ``device``: the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them, or ``"cpu"``.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

COLORS = {"red": (220, 40, 40), "blue": (40, 60, 220),
          "green": (40, 180, 60), "yellow": (230, 210, 50),
          "orange": (240, 140, 20), "purple": (130, 40, 160),
          "cyan": (40, 200, 210), "brown": (139, 69, 19)}
SHAPES = ["circle", "square", "triangle", "diamond", "cross"]
RELS = ["above", "below", "left of", "right of"]
SIZES = ["small", "big"]
MODELS = ["NIC", "BUTDSpatial", "BUTDDetection", "AoASpatial",
          "AoADetection"]


def _draw(draw, shape, color, cx, cy, r):
    box = (cx - r, cy - r, cx + r, cy + r)
    if shape == "circle":
        draw.ellipse(box, fill=color)
    elif shape == "square":
        draw.rectangle(box, fill=color)
    elif shape == "triangle":
        draw.polygon([(cx, cy - r), (cx - r, cy + r), (cx + r, cy + r)],
                     fill=color)
    elif shape == "diamond":
        draw.polygon([(cx, cy - r), (cx + r, cy), (cx, cy + r), (cx - r, cy)],
                     fill=color)
    else:                                  # cross
        t = max(2, r // 3)
        draw.rectangle((cx - t, cy - r, cx + t, cy + r), fill=color)
        draw.rectangle((cx - r, cy - t, cx + r, cy + t), fill=color)


_INV = {"above": "below", "below": "above",
        "left of": "right of", "right of": "left of"}


def caption_variants(z1, c1, s1, rel, z2, c2, s2):
    inv = _INV[rel]
    return [
        f"a {z1} {c1} {s1} {rel} a {z2} {c2} {s2}",
        f"the {z1} {c1} {s1} is {rel} the {z2} {c2} {s2}",
        f"a {z2} {c2} {s2} {inv} a {z1} {c1} {s1}",
        f"there is a {z1} {c1} {s1} {rel} a {z2} {c2} {s2}",
        f"one {z1} {c1} {s1} sits {rel} one {z2} {c2} {s2}",
    ]


def _zipf_p(n: int) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return p / p.sum()


REALTEXT_CORPUS = os.path.join(REPO, "tests", "fixtures",
                               "realtext_corpus.json")


def generate_dataset_realtext(root: str, corpus_path: str = REALTEXT_CORPUS,
                              seed: int = 0) -> int:
    """Natural-language gate tier: the committed hand-written caption
    corpus (80 scenes x 5 varied English sentences) becomes a Flickr-style
    dataset — each scene is one "image" whose synthetic bottom-up features
    encode the scene's content keywords (:func:`generate_bu_features`
    reads the keyword list from ``scene_meta.json``), so a Detection-family
    captioner must learn real English syntax end to end.  Splits
    interleave (i%10: 8=val, 9=test) so held-out scenes are compositional
    recombinations of trained words."""
    from PIL import Image, ImageDraw
    with open(corpus_path) as f:
        scenes_src = json.load(f)["scenes"]
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_kw = sorted({k for s in scenes_src for k in s["keywords"]})
    kw_color = {k: tuple(int(c) for c in rng.integers(30, 225, 3))
                for k in all_kw}
    images, scenes = [], {}
    sid = 0
    for i, scene in enumerate(scenes_src):
        # placeholder pixels: one colored band per keyword (the Detection
        # families read bu features, not pixels; the bands keep each image
        # file distinct for the sample op)
        im = Image.new("RGB", (224, 224), (245, 245, 240))
        d = ImageDraw.Draw(im)
        for j, k in enumerate(scene["keywords"]):
            y0 = 10 + j * 40
            d.rectangle((10, y0, 214, y0 + 30), fill=kw_color[k])
        name = f"real_{i:05d}.jpg"
        im.save(os.path.join(img_dir, name), quality=92)
        split = {8: "val", 9: "test"}.get(i % 10, "train")
        sents = [{"raw": c, "tokens": c.split()}
                 for c in scene["captions"]]
        n = len(sents)
        images.append({"filename": name, "imgid": i, "split": split,
                       "sentids": list(range(sid, sid + n)),
                       "sentences": sents})
        # keyword boxes for the bu-feature generator, in its object schema
        scenes[str(i)] = {"objects": [
            {"keyword": k, "cx": 112, "cy": 25 + j * 40, "r": 15}
            for j, k in enumerate(scene["keywords"])], "rel": None}
        sid += n
    with open(os.path.join(root, "dataset_synth.json"), "w") as f:
        json.dump({"images": images, "dataset": "synth"}, f)
    with open(os.path.join(root, "scene_meta.json"), "w") as f:
        json.dump(scenes, f)
    with open(os.path.join(root, "dataset_flags.json"), "w") as f:
        json.dump({"realtext": True, "n_images": len(images)}, f)
    print(f"generated {len(images)} realtext scenes "
          f"({len(all_kw)} keywords) -> {img_dir}")
    return len(images)


def generate_dataset(root: str, n_images: int, seed: int = 0,
                     zipf: bool = False) -> None:
    """Compositional two-object scenes: 8 colors x 5 shapes x 2 sizes per
    object, 4 spatial relations, and an unmentioned distractor object in
    half the images.  The space (>4M scene types) cannot be memorized from
    ~1k images, so XE leaves headroom on global-pooling models (NIC cannot
    resolve relations or color<->shape binding), which keeps the SCST
    strict-lift gate meaningful.  Scene geometry and attributes go to
    ``scene_meta.json`` for the synthetic bottom-up feature generator.

    ``zipf`` draws the content words (color/shape/relation) from a
    power-law over each category (p ∝ 1/rank) instead of uniform, so
    label smoothing, the CIDEr idf buckets and scheduled sampling see
    Zipfian token frequencies."""
    from PIL import Image, ImageDraw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    images = []
    scenes = {}
    sid = 0
    colors = list(COLORS)
    p_color = _zipf_p(len(colors)) if zipf else None
    p_shape = _zipf_p(len(SHAPES)) if zipf else None
    p_rel = _zipf_p(len(RELS)) if zipf else None

    def sample_obj(big: bool):
        return {"color": str(rng.choice(colors, p=p_color)),
                "shape": SHAPES[int(rng.choice(len(SHAPES), p=p_shape))],
                "size": "big" if big else "small",
                "r": int(rng.integers(27, 37) if big
                         else rng.integers(13, 20))}

    for i in range(n_images):
        o1 = sample_obj(bool(rng.integers(0, 2)))
        o2 = sample_obj(bool(rng.integers(0, 2)))
        rel = RELS[int(rng.choice(len(RELS), p=p_rel))]
        if rel in ("above", "below"):
            ys = (int(rng.integers(45, 75)), int(rng.integers(150, 180)))
            o1["cy"], o2["cy"] = ys if rel == "above" else ys[::-1]
            o1["cx"] = int(rng.integers(60, 165))
            o2["cx"] = int(rng.integers(60, 165))
        else:
            xs = (int(rng.integers(40, 80)), int(rng.integers(145, 185)))
            o1["cx"], o2["cx"] = xs if rel == "left of" else xs[::-1]
            o1["cy"] = int(rng.integers(60, 165))
            o2["cy"] = int(rng.integers(60, 165))
        objects = [o1, o2]
        if rng.integers(0, 2):             # unmentioned distractor
            od = sample_obj(False)
            od["r"] = int(rng.integers(9, 14))
            # corner least occupied by the two mentioned objects
            corners = [(28, 28), (196, 28), (28, 196), (196, 196)]
            far = max(corners, key=lambda p: min(
                (p[0] - o["cx"]) ** 2 + (p[1] - o["cy"]) ** 2
                for o in (o1, o2)))
            od["cx"], od["cy"] = far
            objects.append(od)
        im = Image.new("RGB", (224, 224), (245, 245, 240))
        d = ImageDraw.Draw(im)
        for o in objects:
            _draw(d, o["shape"], COLORS[o["color"]], o["cx"], o["cy"],
                  o["r"])
        name = f"synth_{i:05d}.jpg"
        im.save(os.path.join(img_dir, name), quality=92)
        caps = caption_variants(o1["size"], o1["color"], o1["shape"], rel,
                                o2["size"], o2["color"], o2["shape"])
        split = ("train" if i < n_images * 0.8
                 else "val" if i < n_images * 0.9 else "test")
        sents = [{"raw": c, "tokens": c.split()} for c in caps]
        images.append({"filename": name, "imgid": i, "split": split,
                       "sentids": list(range(sid, sid + 5)),
                       "sentences": sents})
        scenes[str(i)] = {"objects": objects, "rel": rel}
        sid += 5
    with open(os.path.join(root, "dataset_synth.json"), "w") as f:
        json.dump({"images": images, "dataset": "synth"}, f)
    with open(os.path.join(root, "scene_meta.json"), "w") as f:
        json.dump(scenes, f)
    with open(os.path.join(root, "dataset_flags.json"), "w") as f:
        json.dump({"zipf": bool(zipf), "n_images": int(n_images)}, f)
    print(f"generated {n_images} images ({'zipf' if zipf else 'uniform'} "
          f"word frequencies) -> {img_dir}")


def generate_bu_features(root: str, data_dir: str, n_boxes: int = 36,
                         feat_dim: int = 2048, seed: int = 0) -> None:
    """Synthetic bottom-up features for the Detection families: per-image
    ``fixed_bu_feat/<imgid>.npz`` (36, 2048) + ``fixed_bu_bbox/<imgid>.npy``
    + the packed memmap shard (the data layer's fast path), packed by the
    port's ``preprocess/generate_bottom_up_features.pack``.

    Each mentioned object gets one box at its true bbox whose feature row
    is a fixed random embedding of its (color, shape, size) plus a linear
    projection of the normalized box coordinates — the information a real
    Faster-RCNN head would expose — ReLU'd like real bottom-up features;
    the remaining boxes carry background noise."""
    from simpleimagecaptionzoo_tpu_torch.preprocess.generate_bottom_up_features \
        import pack
    with open(os.path.join(root, "scene_meta.json")) as f:
        scenes = json.load(f)
    emb_rng = np.random.default_rng(1234)   # fixed: embeddings are the
    color_emb = emb_rng.normal(0, 1, (len(COLORS), feat_dim))   # "detector"
    shape_emb = emb_rng.normal(0, 1, (len(SHAPES), feat_dim))
    size_emb = emb_rng.normal(0, 1, (len(SIZES), feat_dim))
    pos_w = emb_rng.normal(0, 0.7, (4, feat_dim))
    bg_emb = emb_rng.normal(0, 0.6, (feat_dim,))
    colors, shapes = list(COLORS), list(SHAPES)
    # realtext scenes: objects are content KEYWORDS; one fixed random
    # embedding per keyword (sorted for determinism across runs)
    all_kw = sorted({o["keyword"] for s in scenes.values()
                     for o in s["objects"] if "keyword" in o})
    kw_rng = np.random.default_rng(4321)
    kw_emb = {k: kw_rng.normal(0, 1, feat_dim) for k in all_kw}
    feat_dir = os.path.join(data_dir, "fixed_bu_feat")
    bbox_dir = os.path.join(data_dir, "fixed_bu_bbox")
    os.makedirs(feat_dir, exist_ok=True)
    os.makedirs(bbox_dir, exist_ok=True)
    for img_id, scene in scenes.items():
        rng = np.random.default_rng([seed, int(img_id)])
        feats = np.zeros((n_boxes, feat_dim), np.float32)
        bboxes = np.zeros((n_boxes, 4), np.float32)
        for k in range(n_boxes):
            if k < len(scene["objects"]):
                o = scene["objects"][k]
                box = np.array([o["cx"] - o["r"], o["cy"] - o["r"],
                                o["cx"] + o["r"], o["cy"] + o["r"]],
                               np.float32)
                if "keyword" in o:          # realtext scene
                    row = (kw_emb[o["keyword"]]
                           + (box / 224.0) @ pos_w
                           + rng.normal(0, 0.15, feat_dim))
                else:
                    row = (color_emb[colors.index(o["color"])]
                           + shape_emb[shapes.index(o["shape"])]
                           + size_emb[SIZES.index(o["size"])]
                           + (box / 224.0) @ pos_w
                           + rng.normal(0, 0.15, feat_dim))
            else:
                cx, cy = rng.integers(10, 214, 2)
                r = rng.integers(8, 40)
                box = np.array([max(cx - r, 0), max(cy - r, 0),
                                min(cx + r, 224), min(cy + r, 224)],
                               np.float32)
                row = 0.5 * bg_emb + rng.normal(0, 0.3, feat_dim)
            feats[k] = np.maximum(row, 0.0)
            bboxes[k] = box
        np.savez(os.path.join(feat_dir, f"{img_id}.npz"), feat=feats)
        np.save(os.path.join(bbox_dir, f"{img_id}.npy"), bboxes)
    pack(data_dir, "fixed", n_boxes)
    print(f"generated bottom-up features for {len(scenes)} images -> "
          f"{feat_dir} (+ packed shard)")


def reset_root_state(root: str, n_images: int, model: str,
                     skip_xe: bool, zipf: bool = False,
                     realtext: bool = False) -> bool:
    """Make a reused ``--root`` safe for a fresh gate run.

    * Returns True (caller must regenerate the dataset) when ``n_images``
      or the word distribution disagrees with what is on disk — every
      derived file (vocab ids, annotations, idf tables, bu features,
      checkpoints) is a function of the dataset, so a change wipes them
      all; a run reusing a differently-sized root would silently train on
      the wrong data while recording this n_images.
    * Unless ``skip_xe``, clears THIS model's checkpoint dir: best-model
      updates are double-gated on the persisted history best (reference
      Engine.py:157-163 semantics), so leftover state from a stronger
      earlier run makes the gate compare a stale XE best against this
      run's SCST (a false FAIL; a false PASS is the mirror risk).
      ``--skip_xe`` keeps state by design (SCST iteration).
    """
    meta_path = os.path.join(root, "scene_meta.json")
    regen = True
    if (os.path.exists(os.path.join(root, "dataset_synth.json"))
            and os.path.exists(meta_path)):
        with open(meta_path) as f:
            regen = len(json.load(f)) != n_images
        flags_path = os.path.join(root, "dataset_flags.json")
        on_disk = {"zipf": False}          # pre-flag roots were uniform
        if os.path.exists(flags_path):
            with open(flags_path) as f:
                on_disk = json.load(f)
        if (bool(on_disk.get("zipf", False)) != bool(zipf)
                or bool(on_disk.get("realtext", False)) != bool(realtext)):
            regen = True
    if regen:
        for sub in ("dataset_synth.json", "scene_meta.json", "images",
                    "modified_annotations", "caption_vocab.pkl", "Data",
                    "CheckPoints", "coco_caption"):
            p = os.path.join(root, sub)
            if os.path.isdir(p):
                shutil.rmtree(p)
            elif os.path.exists(p):
                os.remove(p)
        return True
    ck_dir = os.path.join(root, "CheckPoints",
                          f"Model_{model}_Dataset_Flickr8K")
    if not skip_xe and os.path.exists(ck_dir):
        print(f"== clearing stale checkpoint state: {ck_dir} ==")
        shutil.rmtree(ck_dir)
    return False


def preprocess_root(root: str) -> None:
    """The port's preprocessing of a generated root: the Karpathy json to
    ``modified_annotations/``, the vocabulary (threshold 1) and the CIDEr-D
    idf pickle and device table in ``Data/`` (each skipped where its
    outputs exist)."""
    from simpleimagecaptionzoo_tpu_torch.preprocess.build_caption_vocab \
        import build_from_annotations
    from simpleimagecaptionzoo_tpu_torch.preprocess.cider_idf_preprocess \
        import build as build_idf
    from simpleimagecaptionzoo_tpu_torch.preprocess.datasets_json_modification \
        import convert_karpathy

    convert_karpathy(os.path.join(root, "dataset_synth.json"), "Flickr8K",
                     tokenizer="karpathy", output_dir=root)
    ann = os.path.join(root, "modified_annotations")
    vocab_path = os.path.join(root, "caption_vocab.pkl")
    if not os.path.exists(vocab_path):
        build_from_annotations(os.path.join(ann, "captions_train.json"),
                               vocab_path, threshold=1)
    # the idf outputs get their OWN existence check: a run interrupted
    # between the vocab write and the idf write would otherwise wedge the
    # root (vocab exists -> block skipped -> SCST never finds its table)
    if not os.path.exists(os.path.join(root, "Data", "cider_idf_table.npz")):
        # the idf tables go into the CLI's data_dir, where the sample op's
        # CIDEr-D and SCST's device table look for them
        build_idf(os.path.join(ann, "captions_train.json"), "Flickr8K",
                  os.path.join(root, "Data"), vocab_path=vocab_path)


def write_configs(root: str, model: str, dims: int):
    """The CLI's config dir inside the dataset root: the dataset's
    ``.data`` file and the demo-scale model json (the format of
    ``Configs/Models/*.json``).  -> (dataset config dir, model config
    dir)."""
    cfg_dir = os.path.join(root, "Configs", "Datasets")
    os.makedirs(cfg_dir, exist_ok=True)
    with open(os.path.join(cfg_dir, "Flickr8K.data"), "w") as f:
        f.write("image_root=/images/\n"
                "train_caption_path=/modified_annotations/captions_train.json\n"
                "val_caption_path=/modified_annotations/captions_val.json\n"
                "test_caption_path=/modified_annotations/captions_test.json\n"
                "data_dir=/Data/\n"
                "caption_vocab_path=/caption_vocab.pkl\n")
    os.makedirs(os.path.join(root, "Data"), exist_ok=True)
    model_cfg_dir = os.path.join(root, "Configs", "Models")
    os.makedirs(model_cfg_dir, exist_ok=True)
    with open(os.path.join(model_cfg_dir, model + ".json"), "w") as f:
        json.dump({"model_type": model, "enc_img_size": 7,
                   "embed_dim": dims, "hidden_dim": dims,
                   "atten_dim": dims, "optimizer": "Adam"}, f)
    return cfg_dir, model_cfg_dir


def device_label(gpu_id: str) -> str:
    """``"cpu"`` for ``--gpu_id cpu``; else the card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the card's name alone, from torch, where nvidia-smi does
    not answer)."""
    if gpu_id.strip().lower() == "cpu":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(int(gpu_id))],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch
        return "%s, power limit not read" % torch.cuda.get_device_name(
            int(gpu_id))


def gate_record(args, xe_best: float, scst_best: float, greedy_val: float,
                beam_val: float, device: str = "cpu"):
    """The gate's decision -> (ok, record).  PASS needs all three: the XE
    best val CIDEr at least ``--xe_cider_threshold``; SCST beating the XE
    best (``--scst_gate lift``) or within 0.02 of it (``noregress``), or
    ``--skip_scst``; and the beam-3 val CIDEr at most ``--beam_tolerance``
    below greedy's (both measured on the XE best, before SCST).
    ``scst_best`` is NaN where no SCST best record was written (it is
    recorded as None).  ``device`` (see :func:`device_label`) is the one
    key beyond the JAX script's record."""
    # greedy_val/beam_val were measured on the XE best, pre-SCST; see
    # --beam_tolerance for the per-regime tolerance rationale
    beam_ge_greedy = beam_val >= greedy_val - args.beam_tolerance

    scst_ok = (args.skip_scst
               or (scst_best > xe_best if args.scst_gate == "lift"
                   else scst_best >= xe_best - 0.02))
    ok = (xe_best >= args.xe_cider_threshold
          and scst_ok
          and beam_ge_greedy)
    record = {"gate": "PASS" if ok else "FAIL",
              "scst_gate": args.scst_gate,
              "model": args.model, "xe_val_cider": round(xe_best, 4),
              "scst_val_cider": (None if scst_best != scst_best
                                 else round(scst_best, 4)),
              "greedy_val_cider": round(greedy_val, 4),
              "beam3_val_cider": round(beam_val, 4),
              "beam_ge_greedy": beam_ge_greedy,
              "beam_tolerance": args.beam_tolerance,
              "zipf": bool(args.zipf),
              "realtext": bool(args.realtext),
              "xe_threshold": args.xe_cider_threshold,
              "epochs": args.epochs, "scst_epochs": args.scst_epochs,
              "n_images": args.n_images,
              "device": device}
    return ok, record


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the synthetic-data quality gate through the port")
    ap.add_argument("--root", default="./SynthShapes")
    ap.add_argument("--model", default="NIC", choices=MODELS,
                    help="NIC's global pooling cannot resolve relations "
                         "(XE headroom by construction); attention models "
                         "can; Detection variants train from the generated "
                         "synthetic bottom-up features")
    ap.add_argument("--n_images", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--scst_epochs", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dims", type=int, default=256,
                    help="embed/hidden/atten width for the demo-scale model "
                         "json (the production 1024-d configs need far more "
                         "steps than a quick demo runs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cnn_lr", type=float, default=1e-4,
                    help="backbone finetune lr (the CLI's "
                         "--cnn_finetune_learning_rate)")
    ap.add_argument("--scst_lr", type=float, default=5e-5)
    ap.add_argument("--skip_scst", action="store_true")
    ap.add_argument("--skip_xe", action="store_true",
                    help="reuse the root's existing XE checkpoints (iterate "
                         "on SCST settings without retraining XE)")
    ap.add_argument("--gate", action="store_true",
                    help="quality gate: exit nonzero unless XE val CIDEr "
                         "exceeds --xe_cider_threshold AND SCST strictly "
                         "improves on the XE best AND beam-3 stays within "
                         "--beam_tolerance of greedy")
    ap.add_argument("--xe_cider_threshold", type=float, default=0.9)
    ap.add_argument("--gate_out", default="",
                    help="optional path for a one-line json gate record")
    ap.add_argument("--zipf", action="store_true",
                    help="draw the caption content words from a power-law "
                         "(Zipfian token frequencies for label smoothing / "
                         "idf / scheduled sampling)")
    ap.add_argument("--realtext", action="store_true",
                    help="train on the committed hand-written natural-"
                         "language corpus (tests/fixtures/realtext_corpus"
                         ".json) instead of generated template captions: "
                         "80 scenes x 5 varied English sentences whose "
                         "bottom-up features encode each scene's content "
                         "keywords.  Detection families only (the pixels "
                         "are placeholders).  Overrides --n_images/--zipf")
    ap.add_argument("--beam_tolerance", type=float, default=0.01,
                    help="beam-3 val CIDEr may sit at most this far below "
                         "greedy before the gate fails.  0.01 (default) "
                         "asserts the reference's beam>=greedy XE ordering "
                         "up to val-split noise (uniform-data gates); zipf "
                         "gates pass 0.05: with power-law token "
                         "frequencies beam's likelihood maximization trades "
                         "rare high-idf content words for frequent ones, so "
                         "there the check only guards against catastrophic "
                         "beam-scoring regressions")
    ap.add_argument("--scst_gate", choices=["lift", "noregress"],
                    default="lift",
                    help="gate requirement on SCST: 'lift' = strictly beat "
                         "the XE best (uniform-data gates: the space leaves "
                         "XE headroom by construction); 'noregress' = "
                         "within 0.02 of it (zipf gates, where the skew "
                         "makes XE near-ceiling)")
    ap.add_argument("--gpu_id", default="0",
                    help="passed to every CLI call: the card's index "
                         "(cuda:<gpu_id>), or 'cpu'")
    return ap


def _read_val_evals(ck_root: str):
    """The greedy (-1) and beam-3 val CIDEr the eval op recorded in
    ``metrics.jsonl`` (the last of each)."""
    evals = {}
    with open(os.path.join(ck_root, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("phase") == "eval" and rec.get("split") == "val":
                evals[int(rec["beam_size"])] = float(rec["cider"])
    return evals[-1], evals[3]


def _epoch_rates(ck_root: str):
    """Steps/s of each XE and SCST epoch (the engine's records in
    ``metrics.jsonl``: the first step of each epoch excluded)."""
    xe, scst = [], []
    path = os.path.join(ck_root, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("phase") == "xe":
                    xe.append(float(rec["steps_per_sec"]))
                elif rec.get("phase") == "scst":
                    scst.append(float(rec["scst_steps_per_sec"]))
    return xe, scst


def run(args) -> dict:
    """One run of the script with parsed ``args`` -> ``{"rc", "record"
    (None without --gate), "seconds" (each stage's, host clock),
    "xe_steps_per_sec", "scst_steps_per_sec" (each epoch's)}``.  The CLI
    runs with the dataset root as its working directory; the caller's is
    restored on return."""
    from simpleimagecaptionzoo_tpu_torch.main import build_argparser as cli_args
    from simpleimagecaptionzoo_tpu_torch.main import main as cli_main

    def cli(argv):
        rc = cli_main(cli_args().parse_args(argv))
        if rc != 0:
            raise RuntimeError("the port's CLI returned %s for %s"
                               % (rc, " ".join(argv)))

    seconds = {}
    t = [time.perf_counter()]

    def stamp(stage):
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - t[0]
        t[0] = now

    root = os.path.abspath(args.root)
    detection = args.model in ("BUTDDetection", "AoADetection")
    if args.realtext:
        if not detection:
            raise ValueError("--realtext runs Detection families only "
                             "(its images are placeholders)")
        args.zipf = False
        with open(REALTEXT_CORPUS) as f:
            args.n_images = len(json.load(f)["scenes"])

    if reset_root_state(root, args.n_images, args.model, args.skip_xe,
                        zipf=args.zipf, realtext=args.realtext):
        if args.realtext:
            generate_dataset_realtext(root)
        else:
            generate_dataset(root, args.n_images, zipf=args.zipf)
    if detection and not os.path.exists(
            os.path.join(root, "Data", "fixed_bu_index.json")):
        os.makedirs(os.path.join(root, "Data"), exist_ok=True)
        generate_bu_features(root, os.path.join(root, "Data"))
    stamp("dataset")

    preprocess_root(root)
    cfg_dir, model_cfg_dir = write_configs(root, args.model, args.dims)
    stamp("preprocessing")
    if args.gate_out:
        # resolved BEFORE the chdir below, so that a relative --gate_out
        # lands where the script was called from
        args.gate_out = os.path.abspath(args.gate_out)

    base = ["--dataset", "Flickr8K", "--model_type", args.model,
            "--dataset_config_root", cfg_dir,
            "--model_config_root", model_cfg_dir,
            "--train_batch_size", str(args.batch),
            "--eval_batch_size", str(args.batch),
            "--cnn_finetune_start", "0",
            "--learning_rate", str(args.lr),
            "--cnn_finetune_learning_rate", str(args.cnn_lr),
            "--scst_learning_rate", str(args.scst_lr),
            "--scst_train_batch_size", str(args.batch),
            "--gpu_id", args.gpu_id]
    if detection:
        base += ["--use_bu", "fixed"]
    ck_root = os.path.join(root, "CheckPoints",
                           f"Model_{args.model}_Dataset_Flickr8K")
    cwd = os.getcwd()
    os.chdir(root)  # the CLI resolves the .data paths against cwd
    try:
        if args.skip_xe:
            print("== XE phase skipped (reusing existing checkpoints) ==")
        else:
            print("== XE training via CLI ==")
            cli(base + ["--operation", "train", "--num_epochs",
                        str(args.epochs)])
            stamp("xe")
            print("== eval (beam=3) via CLI ==")
            cli(base + ["--operation", "eval", "--eval_split", "test",
                        "--eval_beam_size", "3"])
            stamp("xe_test_eval")
        greedy_val = beam_val = float("nan")
        if args.gate:
            # the decode-quality ordering check: greedy and beam-3 val
            # evals of the XE best, run here (after XE, before SCST) so that
            # they load the XE best checkpoint; SCST sharpens toward the
            # greedy policy, so the ordering is checked on the XE model.
            # The eval op records each score in metrics.jsonl (main.py).
            eval_base = base + ["--operation", "eval", "--eval_split", "val"]
            for bs in ("-1", "3"):
                cli(eval_base + ["--eval_beam_size", bs])
            greedy_val, beam_val = _read_val_evals(ck_root)
            stamp("val_evals")
        if not args.skip_scst:
            print("== SCST via CLI ==")
            cli(base + ["--operation", "scst_train",
                        "--scst_num_epochs", str(args.scst_epochs)])
            stamp("scst")
        print("== sample via CLI ==")
        sample_img = "real_00000.jpg" if args.realtext else "synth_00000.jpg"
        cli(base + ["--operation", "sample", "--eval_beam_size", "-1",
                    "--img_filename", sample_img])
        stamp("sample")
    finally:
        os.chdir(cwd)
    xe_rates, scst_rates = _epoch_rates(ck_root)
    out = {"rc": 0, "record": None, "seconds": seconds,
           "xe_steps_per_sec": xe_rates, "scst_steps_per_sec": scst_rates}
    print("STAGE_SECONDS:", json.dumps(seconds))

    if args.gate:
        best_dir = os.path.join(ck_root, "best")
        xe_rec = os.path.join(best_dir, "best_score_record.json")
        # the engine writes the XE best record only for a val CIDEr above
        # 0 (its best starts at 0), so a run without one scored 0 in every
        # epoch: it FAILs the threshold (the JAX script stops here on the
        # missing file instead)
        xe_best = 0.0
        if os.path.exists(xe_rec):
            with open(xe_rec) as f:
                xe_best = float(json.load(f)["cider"])
        else:
            print("== no XE best record: every XE epoch's val CIDEr was 0 ==")
        scst_best = float("nan")
        scst_rec = os.path.join(best_dir, "best_scst_score_record.json")
        if not args.skip_scst and os.path.exists(scst_rec):
            with open(scst_rec) as f:
                scst_best = float(json.load(f)["cider"])
        ok, record = gate_record(args, xe_best, scst_best, greedy_val,
                                 beam_val, device_label(args.gpu_id))
        print("QUALITY_GATE:", json.dumps(record))
        if args.gate_out:
            with open(args.gate_out, "w") as f:
                json.dump(record, f)
        out.update(rc=0 if ok else 1, record=record)
    return out


def main(argv=None) -> int:
    return run(build_argparser().parse_args(argv))["rc"]


if __name__ == "__main__":
    sys.exit(main())
