"""Single-image sample surface (the JAX package's ``engine/sample.py``;
reference Engine.py:309-339 + the show_additional_rlt hook, Engine.py:341).

Mixin methods expect the Engine attributes ``ckpt`` / ``tree`` / ``cfg`` /
``data_cfg`` / ``train_cfg`` / ``vocab`` / ``device`` plus the helpers
``_visual_source`` / ``_capdata`` / ``_decoder`` / ``_decode_params`` /
``_load_into_tree`` / ``_log``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


class SampleMixin:
    def test(self, img_filename: str, use_scst_model: bool = False,
             use_best_model: bool = True, eval_beam_size: int = -1,
             split_hint: str = "val") -> str:
        """Single-image demo (reference Engine.py:309-339): decode one image,
        print the caption, score CIDEr-D against its gts when the image is in
        the eval annotations, and hand attention maps to
        :meth:`show_additional_rlt`."""
        from simpleimagecaptionzoo_tpu_torch.engine.engine import to_device
        self._load_into_tree(scst=use_scst_model, best=use_best_model)
        vs = self._visual_source()
        # locate the image's annotations: try the hinted split, then the
        # others (the reference assumes COCO val; any split is accepted).
        # Missing-split configs are skipped; corrupt jsons still raise.
        capdata = None
        img_id = None
        for split in dict.fromkeys([split_hint, "val", "test", "train"]):
            path = self._split_path(split)
            if not path or not os.path.exists(path):
                continue
            cd = self._capdata(split)
            if img_filename in cd.filenameToImgid:
                capdata, img_id = cd, cd.filenameToImgid[img_filename]
                split_hint = split
                break
        entry = (capdata.imgs[img_id] if img_id is not None
                 else {"file_name": img_filename, "id": -1})
        if img_id is not None:
            self._log("ground-truth captions:")
            for ann in capdata.imgToAnns[img_id]:
                self._log("  " + ann.get("caption", ""))
        try:
            item = vs.item(entry, split_hint, False)
        except FileNotFoundError as e:
            if vs.supp is not None:
                raise FileNotFoundError(
                    f"cannot run the sample op for {self.cfg.model_type} on "
                    f"'{img_filename}': no bottom-up features for image id "
                    f"{entry['id']}"
                    + (" (image not found in any annotation split)"
                       if img_id is None else "")
                    + f" — {e}. Detection models decode from precomputed "
                    "bu features; extract them with preprocess/"
                    "generate_bottom_up_features.py, or use a Spatial/NIC "
                    "model to caption arbitrary images from pixels."
                ) from e
            raise
        visual = {k: v[None] for k, v in item.items()}
        # the visualization payload (not fed to the model): the original
        # image and the bottom-up boxes for the Detection attention hook
        viz_item = dict(item)
        if vs.supp is not None:
            try:
                viz_item["bu_bboxes"] = vs.supp.load_bbox(entry["id"])
            except FileNotFoundError:
                pass
        if self.data_cfg.image_root:
            try:
                from PIL import Image
                from simpleimagecaptionzoo_tpu_torch.data.datasets import \
                    image_path
                with Image.open(image_path(
                        self.data_cfg.image_root, entry["file_name"],
                        self.data_cfg.dataset_name, split_hint)) as im:
                    viz_item["original_image"] = np.asarray(im.convert("RGB"))
            except (ImportError, OSError):
                pass

        # _decode_params: the eval loop's numeric path (int8 included)
        ids, alphas = self._decoder(eval_beam_size, return_alphas=True)(
            self._decode_params(), self.tree["model_state"],
            to_device(visual, self.device))
        caption = self.vocab.decode_ids(ids[0].cpu().numpy())
        sentence = " ".join(caption)
        self._log("Generated caption:\n" + sentence)

        if img_id is not None:
            # CIDEr-D against this image's gts needs a precomputed idf table
            # ('corpus' mode over one image is identically 0).  The
            # reference uses CiderD(df='<ds>-val'); the train idf built by
            # preprocess/cider_idf_preprocess.py is used when present.
            from simpleimagecaptionzoo_tpu_torch.evalcap.cider_scorer import \
                CiderD
            from simpleimagecaptionzoo_tpu_torch.evalcap.tokenizer import \
                PTBTokenizer
            df_mode = f"{self.data_cfg.dataset_name}-train"
            df_path = os.path.join(self.data_cfg.data_dir, df_mode + ".p")
            if os.path.exists(df_path):
                gts = {img_id: capdata.imgToAnns[img_id]}
                res = [{"image_id": img_id, "caption": [sentence]}]
                tok_gts = PTBTokenizer(_source="gts").tokenize(gts)
                tok_res = PTBTokenizer(_source="res").tokenize(res)
                score, _ = CiderD(df=df_mode,
                                  df_dir=self.data_cfg.data_dir
                                  ).compute_score(tok_gts, tok_res)
                self._log("CIDEr-D: %.3f" % score)
            else:
                self._log("CIDEr-D skipped: idf table %s not found (run "
                          "preprocess/cider_idf_preprocess.py)" % df_path)
        self.show_additional_rlt(
            None if alphas is None else alphas[0].float().cpu().numpy(),
            viz_item, caption)
        return sentence

    def show_additional_rlt(self, alphas, visual_item: Dict, caption: List[str]):
        """Hook: attention visualization (overridden per model family,
        model_engines.py; reference BUTD_Engine.py:9-18,49-59)."""
