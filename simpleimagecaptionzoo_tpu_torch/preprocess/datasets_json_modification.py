"""Normalize raw dataset annotations into the unified *modified annotations*
format (the JAX package's ``preprocess/datasets_json_modification.py``;
reference PreProcess/Datasets_json_modification.py:72-258).

    python -m simpleimagecaptionzoo_tpu_torch.preprocess.datasets_json_modification \
        --dataset COCO14 --karpathy_json Datasets/MSCOCO/2014/dataset_coco.json

Output schema per split file ``modified_annotations/captions_<split>.json``:

    {"dataset": <name>,
     "images":      [{"id", "file_name", "sentids",
                      "sentences": [{"tokens": [...], "raw": str}, ...]}],
     "annotations": [{"image_id", "id", "caption", "tokens", "file_name"}]}

Inputs:
* Karpathy-split jsons (``dataset_coco.json`` / ``dataset_flickr8k.json`` /
  ``dataset_flickr30k.json``) for COCO14 + Flickr; ``restval`` merges into
  train (reference :97-100).  COCO uses ``cocoid`` as the image id, Flickr
  uses ``imgid``.
* Raw COCO17 ``captions_{train,val}2017.json`` annotations (no test split).

Tokenizer choices (reference rawCaption2Tokens :59-70): ``karpathy`` (use
the tokens already in the Karpathy json), ``nltk``, ``nltk_punc`` (nltk
minus punctuation), ``ptb`` (our PTBTokenizer — pure-Python, Java-free;
evalcap/tokenizer.py).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

# the single punctuation list shared with eval-time tokenization — training
# tokens and metric-stack tokens must filter identically
from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import (
    PUNCTUATIONS, ptb_tokenize_line)

_PUNCT_SET = frozenset(PUNCTUATIONS)


def tokenize_caption(raw: str, tokenizer: str,
                     karpathy_tokens: Optional[List[str]] = None) -> List[str]:
    if tokenizer == "karpathy":
        if karpathy_tokens is None:
            raise ValueError("tokenizer 'karpathy': the caption carries no "
                             "Karpathy tokens")
        return karpathy_tokens
    if tokenizer in ("nltk", "nltk_punc"):
        import nltk
        toks = nltk.word_tokenize(raw.lower())
        if tokenizer == "nltk_punc":
            toks = [t for t in toks if t not in _PUNCT_SET]
        return toks
    if tokenizer == "ptb":
        # the reference's PTB option tokenizes through coco_caption's
        # PTBTokenizer, which STRIPS the punctuation list
        # (ptbtokenizer.py:67-68) — training tokens must match what the
        # eval-side tokenizer produces or the model learns punctuation
        # tokens the metric stack never sees
        return [t for t in ptb_tokenize_line(raw) if t not in _PUNCT_SET]
    raise ValueError(f"unknown tokenizer {tokenizer!r}")


def _empty_split(dataset_name: str) -> dict:
    return {"dataset": dataset_name, "images": [], "annotations": []}


def convert_karpathy(ks_json_path: str, dataset_name: str,
                     tokenizer: str = "karpathy",
                     output_dir: Optional[str] = None,
                     overwrite: bool = False) -> Dict[str, dict]:
    """Karpathy json -> per-split modified annotation jsons.  COCO images
    are keyed by ``cocoid``, Flickr by ``imgid`` (reference :83/:163)."""
    output_dir = output_dir or os.path.dirname(os.path.abspath(ks_json_path))
    out = os.path.join(output_dir, "modified_annotations")
    os.makedirs(out, exist_ok=True)
    if not overwrite and all(
            os.path.exists(os.path.join(out, f"captions_{s}.json"))
            for s in ("train", "val", "test")):
        print("modified_annotations already exists.")
        return {}
    with open(ks_json_path) as f:
        ks = json.load(f)
    id_key = "cocoid" if dataset_name.startswith("COCO") else "imgid"
    new_json = {s: _empty_split(dataset_name) for s in ("train", "val", "test")}
    for img in ks["images"]:
        split = "train" if img["split"] in ("train", "restval") else img["split"]
        img_id = img[id_key]
        sentences = []
        for sid, sent in zip(img["sentids"], img["sentences"]):
            tokens = tokenize_caption(sent["raw"], tokenizer,
                                      sent.get("tokens"))
            new_json[split]["annotations"].append({
                "file_name": img["filename"], "image_id": img_id, "id": sid,
                "caption": sent["raw"], "tokens": tokens})
            sentences.append({"tokens": tokens, "raw": sent["raw"]})
        new_json[split]["images"].append({
            "file_name": img["filename"], "id": img_id,
            "sentids": img["sentids"], "sentences": sentences})
    for split, data in new_json.items():
        with open(os.path.join(out, f"captions_{split}.json"), "w") as f:
            json.dump(data, f)
    print(f"Finished generating modified json for Dataset:{dataset_name}")
    return new_json


def convert_coco17(original_json_root: str, tokenizer: str = "nltk",
                   output_dir: Optional[str] = None,
                   overwrite: bool = False) -> Dict[str, dict]:
    """Raw COCO17 captions_{train,val}2017.json -> modified annotations
    (reference generate_modified_json_coco17; no test split)."""
    output_dir = output_dir or original_json_root
    out = os.path.join(output_dir, "modified_annotations")
    os.makedirs(out, exist_ok=True)
    if not overwrite and all(
            os.path.exists(os.path.join(out, f"captions_{s}.json"))
            for s in ("train", "val")):
        print("modified_annotations already exists.")
        return {}
    new_json = {}
    for split in ("train", "val"):
        with open(os.path.join(original_json_root,
                               f"captions_{split}2017.json")) as f:
            raw = json.load(f)
        data = _empty_split("COCO17")
        img_entries = {}
        for img in raw["images"]:
            img_entries[img["id"]] = {
                "file_name": img["file_name"], "id": img["id"],
                "sentids": [], "sentences": []}
        for ann in raw["annotations"]:
            entry = img_entries[ann["image_id"]]
            tokens = tokenize_caption(ann["caption"], tokenizer)
            data["annotations"].append({
                "file_name": entry["file_name"], "image_id": ann["image_id"],
                "id": ann["id"], "caption": ann["caption"], "tokens": tokens})
            entry["sentids"].append(ann["id"])
            entry["sentences"].append({"tokens": tokens,
                                       "raw": ann["caption"]})
        data["images"] = list(img_entries.values())
        new_json[split] = data
        with open(os.path.join(out, f"captions_{split}.json"), "w") as f:
            json.dump(data, f)
    print("Finished generating modified json for Dataset:COCO17")
    return new_json


def show_modified_annotations(path: str, n: int = 2) -> None:
    """Schema inspection helper (reference
    show_modified_annotation_jsonfiles :34-57)."""
    with open(path) as f:
        data = json.load(f)
    print("dataset:", data.get("dataset"))
    print("num images:", len(data["images"]),
          "num annotations:", len(data["annotations"]))
    for img in data["images"][:n]:
        print("image:", {k: img[k] for k in ("id", "file_name", "sentids")})
    for ann in data["annotations"][:n]:
        print("annotation:", ann)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="COCO14",
                   choices=["COCO14", "COCO17", "Flickr8K", "Flickr30K"])
    p.add_argument("--karpathy_json", default="",
                   help="path to dataset_{coco,flickr8k,flickr30k}.json")
    p.add_argument("--coco17_root", default="",
                   help="dir containing captions_{train,val}2017.json")
    p.add_argument("--tokenizer", default="karpathy",
                   choices=["karpathy", "nltk", "nltk_punc", "ptb"])
    p.add_argument("--output_dir", default=None)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--show", default="", help="inspect a modified json")
    a = p.parse_args(argv)
    if a.show:
        show_modified_annotations(a.show)
    elif a.dataset == "COCO17":
        # raw COCO17 annotations carry no Karpathy tokens — default to nltk
        tok = "nltk" if a.tokenizer == "karpathy" else a.tokenizer
        convert_coco17(a.coco17_root, tok, a.output_dir, a.overwrite)
    else:
        convert_karpathy(a.karpathy_json, a.dataset, a.tokenizer,
                         a.output_dir, a.overwrite)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
