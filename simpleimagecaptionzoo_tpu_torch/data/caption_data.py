"""COCO-like caption annotation index.

Loads the *modified annotation* jsons produced by the preprocessing toolchain
(schema: reference PreProcess/Datasets_json_modification.py:89-93 — images:
[id, file_name, sentids, sentences], annotations: [image_id, id, caption,
tokens, file_name]) and builds the same four indices as the reference's
``CaptionData`` (ClassRepository/DatasetClass.py:8-42): ``anns``, ``imgs``,
``imgToAnns``, ``filenameToImgid``.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Optional


class CaptionData:
    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None) -> None:
        self.dataset: dict = {}
        self.anns: dict = {}
        self.imgs: dict = {}
        self.imgToAnns: dict = defaultdict(list)
        self.filenameToImgid: dict = {}
        if dataset is not None:
            self.dataset = dataset
            self.create_index()
        elif annotation_file is not None:
            with open(annotation_file, "r") as f:
                self.dataset = json.load(f)
            assert isinstance(self.dataset, dict), (
                "annotation file format %s not supported" % type(self.dataset))
            self.create_index()

    def create_index(self) -> None:
        anns, imgs = {}, {}
        img_to_anns = defaultdict(list)
        filename_to_imgid = {}
        for ann in self.dataset.get("annotations", []):
            img_to_anns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
            filename_to_imgid[img["file_name"]] = img["id"]
        self.anns = anns
        self.imgToAnns = img_to_anns
        self.imgs = imgs
        self.filenameToImgid = filename_to_imgid

    # alias kept for API familiarity with the reference
    createIndex = create_index
