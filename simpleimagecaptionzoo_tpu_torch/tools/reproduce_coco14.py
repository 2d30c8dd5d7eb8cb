"""The COCO14 reproduction through the port: preprocess -> pack -> train ->
eval, and a dry run of those stages on a generated COCO14-shaped tree (the
stages of the JAX package's ``scripts/reproduce_coco14.sh`` but its
download, which needs a network).

    python -m simpleimagecaptionzoo_tpu_torch.tools.reproduce_coco14 \
        [stage] [model] [--gpu_id 0|cpu] [--root DIR]

    stage: preprocess | pack | train | eval | dry_run (default dry_run)
    model: NIC | BUTDSpatial | BUTDDetection | AoASpatial | AoADetection
           (default BUTDDetection)

Every stage runs the port alone: its preprocessing entry points
(``simpleimagecaptionzoo_tpu_torch/preprocess``) and its CLI
(``simpleimagecaptionzoo_tpu_torch.main``), in this process, with the
shell script's arguments.  The stages read and write the reference layout
under ``--root`` (default: the current directory): ``Datasets/MSCOCO/2014``
(the images, ``dataset_coco.json``, ``trainval_36/*.tsv``), ``Data/
MSCOCO/2014`` (the vocabulary, the idf tables, the features and the packed
shards), ``Configs/`` and ``CheckPoints/``.  Each skips work whose outputs
exist.

``dry_run`` writes a miniature COCO14 tree with ``tools/make_coco14_fixture.py``
(JPEGs, the Karpathy json and, for the Detection models, a bottom-up TSV;
run as its own process) under ``--root`` (default: a new temporary
directory), runs every stage on it and asserts the files the shell
script's dry run asserts, then prints ``DRY RUN OK: <root>``.  The SCST
best record it asserts both ways: present if and only if the SCST
history holds a val CIDEr above 0 (the engine's rule for writing it).  With
``--gpu_id cpu`` it keeps the shell script's CPU configuration: the model
json with its widths set to 32, 64-px images and the tiny run's flags.  On
the card (``--gpu_id 0``, the default) the model json is the one in
``Configs/Models`` as it stands, at full width, and the images are at the
ResNet's 224 px, the packed shard's size.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import List

from simpleimagecaptionzoo_tpu_torch import main as cli
from simpleimagecaptionzoo_tpu_torch.preprocess import (
    build_caption_vocab, cider_idf_preprocess, datasets_json_modification,
    generate_bottom_up_features, pack_images)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODELS = {"NIC": False, "BUTDSpatial": False, "AoASpatial": False,
          "BUTDDetection": True, "AoADetection": True}   # needs bottom-up
STAGES = ("preprocess", "pack", "train", "eval", "dry_run")
# the dry run's tiny-run flags (the shell script's MAIN_EXTRA)
DRY_FLAGS = ["--num_epochs", "1", "--scst_num_epochs", "1",
             "--train_batch_size", "4", "--scst_train_batch_size", "4",
             "--eval_batch_size", "4", "--eval_beam_size", "2",
             "--cnn_finetune_start", "99", "--tqdm_visible", "False"]
CPU_WIDTH = 32                 # the dry run's widths on the CPU
CPU_IMG = 64                   # the dry run's image size on the CPU
REFERENCE_TABLE = """\
Reference results to compare against (README.md:43-52, CIDEr x100,
COCO14 Karpathy test):
  NIC            XE greedy 93.4 | XE beam 98.1 | SCST greedy 103.8 | SCST beam 104.3
  BUTDSpatial    XE greedy 97.3 | XE beam 103.0 | SCST greedy 110.2 | SCST beam 110.5
  BUTDDetection  XE greedy 106.1 | XE beam 111.4 | (no reference SCST row)"""


class Run:
    """One reproduction: the model, the run root and its dataset and data
    directories, the CLI's device and its extra flags."""

    def __init__(self, model: str, root: str, gpu_id: str = "0",
                 extra: List[str] = ()):
        if model not in MODELS:
            raise ValueError("unknown model %r (one of %s)"
                             % (model, ", ".join(MODELS)))
        self.model, self.needs_bu = model, MODELS[model]
        self.root = os.path.abspath(root)
        self.ds = os.path.join(self.root, "Datasets", "MSCOCO", "2014")
        self.data = os.path.join(self.root, "Data", "MSCOCO", "2014")
        self.gpu_id = gpu_id
        self.extra = list(extra)
        os.makedirs(self.ds, exist_ok=True)
        os.makedirs(self.data, exist_ok=True)

    @property
    def annotations(self) -> str:
        return os.path.join(self.ds, "modified_annotations")

    @property
    def checkpoints(self) -> str:
        return os.path.join(self.root, "CheckPoints",
                            "Model_%s_Dataset_COCO14" % self.model)

    def main(self, *argv: str) -> None:
        """The port's CLI on this run's model, from the run root (the
        dataset config's paths resolve against it), the run's flags last
        (the last of a repeated flag wins)."""
        args = ["--dataset", "COCO14", "--model_type", self.model]
        if self.needs_bu:
            args += ["--use_bu", "fixed"]
        args += list(argv) + self.extra + ["--gpu_id", self.gpu_id]
        cwd = os.getcwd()
        os.chdir(self.root)
        try:
            rc = cli.main(cli.build_argparser().parse_args(args))
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise RuntimeError("main %s returned %s" % (" ".join(args), rc))


def preprocess(run: Run) -> None:
    train_json = os.path.join(run.annotations, "captions_train.json")
    if not os.path.exists(train_json):
        datasets_json_modification.main([
            "--dataset", "COCO14", "--karpathy_json",
            os.path.join(run.ds, "dataset_coco.json")])
    vocab = os.path.join(run.data, "caption_vocab.pkl")
    if not os.path.exists(vocab):
        build_caption_vocab.main(["--train_caption_path", train_json,
                                  "--vocab_path", vocab])
    if not os.path.exists(os.path.join(run.data, "COCO14-train.p")):
        cider_idf_preprocess.main([
            "--dataset", "COCO14", "--train_caption_path", train_json,
            "--vocab_path", vocab, "--out_dir", run.data])
    if run.needs_bu and not os.path.isdir(os.path.join(run.data,
                                                       "fixed_bu_feat")):
        tsv_dir = os.path.join(run.ds, "trainval_36")
        tsvs = sorted(os.path.join(tsv_dir, f) for f in os.listdir(tsv_dir)
                      if ".tsv" in f)
        generate_bottom_up_features.main(
            ["--operation", "generate", "--bu_type", "fixed", "--tsv"]
            + tsvs + ["--output_dir", run.data + os.sep])


def pack(run: Run) -> None:
    """The packed shards: bottom-up features for the Detection models,
    decoded uint8 pixels for the others."""
    if run.needs_bu:
        generate_bottom_up_features.main(
            ["--operation", "pack", "--bu_type", "fixed", "--output_dir",
             run.data + os.sep])
    elif not os.path.exists(os.path.join(run.data, "images_224_packed.npy")):
        pack_images.main(
            ["--annotations"]
            + [os.path.join(run.annotations, "captions_%s.json" % s)
               for s in ("train", "val", "test")]
            + ["--image_root", run.ds, "--dataset", "COCO14",
               "--output_dir", run.data])


def train(run: Run) -> None:
    """XE, then SCST (the reference's defaults: 30 and 50 epochs at
    batch 128), each resuming from its checkpoint when there is one.  A
    first SCST run starts from the best XE checkpoint (``--start_from
    scratch``): the shell script passes ``--start_from checkpoint`` there
    too, under which the engine, finding no SCST checkpoint, fine-tunes
    freshly initialized weights."""
    run.main("--operation", "train", "--start_from", "checkpoint")
    resume = os.path.exists(os.path.join(run.checkpoints, "cp",
                                         "Captioner_scst_cp.msgpack"))
    run.main("--operation", "scst_train", "--start_from",
             "checkpoint" if resume else "scratch")


def evaluate(run: Run) -> None:
    print("== %s, SCST best checkpoint, test split, beam 3 ==" % run.model)
    run.main("--operation", "eval", "--eval_split", "test",
             "--eval_beam_size", "3", "--eval_scst", "1")
    print(REFERENCE_TABLE)


def _assert_file(path: str) -> None:
    if not os.path.isfile(path):
        raise FileNotFoundError("DRY RUN FAILED: missing %s" % path)


def _assert_scst_best(checkpoints: str) -> None:
    """The SCST best record exists if and only if the SCST history holds a
    val CIDEr above 0, and then holds the history's best: the engine
    writes it when an epoch's CIDEr beats the best so far, which starts at
    0.  A tiny run may learn a caption that scores 0 on every val image
    (CIDEr-D's 0), and then no record is the engine's right answer."""
    with open(os.path.join(checkpoints, "cp",
                           "scst_state_histories.json")) as f:
        best = max(json.load(f)["cider_his"], default=0.0)
    path = os.path.join(checkpoints, "best", "best_scst_score_record.json")
    if best > 0:
        _assert_file(path)
        with open(path) as f:
            recorded = json.load(f)["cider"]
        if recorded != best:
            raise AssertionError("DRY RUN FAILED: %s holds CIDEr %r, the "
                                 "SCST history's best is %r"
                                 % (path, recorded, best))
    elif os.path.exists(path):
        raise AssertionError("DRY RUN FAILED: %s exists, but no SCST epoch "
                             "scored a val CIDEr above 0" % path)
    print("SCST val CIDEr best %.4f: the best record %s" % (
        best, "written" if best > 0 else "absent, as the engine's rule "
        "(a CIDEr above the best so far, from 0) says"), flush=True)


def dry_run(model: str, gpu_id: str = "0", root: str = "") -> str:
    """Every stage on a generated COCO14-shaped tree under ``root`` (a new
    temporary directory when empty), asserting each stage's files as the
    shell script's dry run does, the SCST best record both ways
    (:func:`_assert_scst_best`).  -> the run root."""
    root = root or tempfile.mkdtemp(prefix="sicz_dryrun_")
    on_cpu = gpu_id.strip().lower() == "cpu"
    run = Run(model, root, gpu_id,
              DRY_FLAGS + (["--img_size", str(CPU_IMG)] if on_cpu else []))
    print("== dry run: %s in %s ==" % (model, run.root), flush=True)
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_coco14_fixture.py"),
                    "--dataset_root", run.ds]
                   + (["--bu"] if run.needs_bu else []), check=True)
    # the dataset config verbatim (its paths resolve against the run root,
    # as the real run's resolve against the repo's root); the model config
    # as it stands on the card, 32 wide on the CPU
    configs = os.path.join(run.root, "Configs")
    os.makedirs(os.path.join(configs, "Datasets"), exist_ok=True)
    os.makedirs(os.path.join(configs, "Models"), exist_ok=True)
    shutil.copy(os.path.join(REPO, "Configs", "Datasets", "COCO14.data"),
                os.path.join(configs, "Datasets"))
    with open(os.path.join(REPO, "Configs", "Models", model + ".json")) as f:
        cfg = json.load(f)
    if on_cpu:
        for k in ("embed_dim", "hidden_dim", "atten_dim"):
            if k in cfg:
                cfg[k] = CPU_WIDTH
    with open(os.path.join(configs, "Models", model + ".json"), "w") as f:
        json.dump(cfg, f)

    preprocess(run)
    for split in ("train", "val", "test"):
        _assert_file(os.path.join(run.annotations,
                                  "captions_%s.json" % split))
    _assert_file(os.path.join(run.data, "caption_vocab.pkl"))
    _assert_file(os.path.join(run.data, "COCO14-train.p"))
    if run.needs_bu:
        _assert_file(os.path.join(run.data, "fixed_bu_feat", "1.npz"))

    pack(run)
    _assert_file(os.path.join(run.data, "fixed_bu_feats_packed.npy"
                              if run.needs_bu else "images_224_packed.npy"))

    train(run)
    for name in ("cp/Captioner_cp.msgpack", "cp/state_histories.json",
                 "cp/Captioner_scst_cp.msgpack",
                 "cp/scst_state_histories.json"):
        _assert_file(os.path.join(run.checkpoints, name))
    _assert_scst_best(run.checkpoints)

    evaluate(run)
    print("DRY RUN OK: %s" % run.root, flush=True)
    return run.root


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="the COCO14 reproduction's stages through the port")
    ap.add_argument("stage", nargs="?", default="dry_run", choices=STAGES)
    ap.add_argument("model", nargs="?", default="BUTDDetection",
                    choices=sorted(MODELS))
    ap.add_argument("--gpu_id", default="0",
                    help="the CUDA card's index, or 'cpu'")
    ap.add_argument("--root", default="",
                    help="the run root (default: the current directory; "
                         "dry_run: a new temporary directory)")
    return ap


def main(argv=None) -> int:
    a = build_argparser().parse_args(argv)
    if a.stage == "dry_run":
        dry_run(a.model, a.gpu_id, a.root)
        return 0
    run = Run(a.model, a.root or os.getcwd(), a.gpu_id)
    {"preprocess": preprocess, "pack": pack, "train": train,
     "eval": evaluate}[a.stage](run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
