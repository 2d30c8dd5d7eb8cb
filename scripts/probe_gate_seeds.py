#!/usr/bin/env python3
"""XE epochs of the port's CLI on the quality gate's generated dataset at
several ``--seed`` values (the CLI's seed: the init's draws, dropout and
the batch order), each epoch's mean loss and greedy val CIDEr printed beside
the device.  It reads how far the gate's XE reading moves with the draws
alone, on the card (``--gpu_id 0``) or the CPU (``--gpu_id cpu``), at the
settings of a ``QUALITY_*`` record (by default
``QUALITY_r04_BUTDDetection_zipf.json``'s: 2,000 images with power-law
words, 256 wide, batch 64, lr 1e-3).

    python3 scripts/probe_gate_seeds.py [--model BUTDDetection] \
        [--seeds 0 1 2 3 4] [--epochs 2] [--gpu_id 0|cpu] [--root DIR]
"""
import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from simpleimagecaptionzoo_tpu_torch import main as cli  # noqa: E402
from simpleimagecaptionzoo_tpu_torch.examples import \
    train_synthetic as ts  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="BUTDDetection", choices=ts.MODELS)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--n_images", type=int, default=2000)
    ap.add_argument("--uniform", action="store_true",
                    help="uniform content words (default: --zipf's)")
    ap.add_argument("--gpu_id", default="0")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    gargs = ts.build_argparser().parse_args(
        ["--model", args.model, "--n_images", str(args.n_images)]
        + ([] if args.uniform else ["--zipf"]))
    root = args.root or tempfile.mkdtemp(prefix="gate_seeds_")
    device = ts.device_label(args.gpu_id)
    with contextlib.redirect_stdout(io.StringIO()):
        if ts.reset_root_state(root, gargs.n_images, args.model, False,
                               zipf=gargs.zipf):
            ts.generate_dataset(root, gargs.n_images, zipf=gargs.zipf)
        if args.model in ("BUTDDetection", "AoADetection") and \
                not os.path.exists(os.path.join(root, "Data",
                                                "fixed_bu_index.json")):
            os.makedirs(os.path.join(root, "Data"), exist_ok=True)
            ts.generate_bu_features(root, os.path.join(root, "Data"))
        ts.preprocess_root(root)
        cfg_dir, model_dir = ts.write_configs(root, args.model, gargs.dims)
    ck = os.path.join(root, "CheckPoints",
                      "Model_%s_Dataset_Flickr8K" % args.model)
    out = {}
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for seed in args.seeds:
            shutil.rmtree(ck, ignore_errors=True)
            argv_ = ["--dataset", "Flickr8K", "--model_type", args.model,
                     "--dataset_config_root", cfg_dir,
                     "--model_config_root", model_dir,
                     "--train_batch_size", str(gargs.batch),
                     "--eval_batch_size", str(gargs.batch),
                     "--cnn_finetune_start", "0",
                     "--learning_rate", str(gargs.lr),
                     "--cnn_finetune_learning_rate", str(gargs.cnn_lr),
                     "--operation", "train", "--num_epochs",
                     str(args.epochs), "--seed", str(seed),
                     "--gpu_id", args.gpu_id, "--tqdm_visible", "False"]
            if args.model in ("BUTDDetection", "AoADetection"):
                argv_ += ["--use_bu", "fixed"]
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(cli.build_argparser().parse_args(argv_))
            with open(os.path.join(ck, "metrics.jsonl")) as f:
                recs = [json.loads(ln) for ln in f]
            out[seed] = [(round(r["mean_loss"], 4), round(r["val_cider"], 4))
                         for r in recs if r.get("phase") == "xe"]
            print("seed %d (exit %d) on %s: (mean loss, val CIDEr) by epoch "
                  "%s" % (seed, rc, device, out[seed]), flush=True)
    finally:
        os.chdir(cwd)
    print(json.dumps({"model": args.model, "device": device,
                      "epochs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
