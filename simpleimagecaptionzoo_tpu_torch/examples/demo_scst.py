"""SCST smoke demo through the port's engine steps.

The JAX package's ``examples/demo_scst.py`` on the port: pre-trains a tiny
BUTDDetection captioner with XE steps on the same synthetic data (numpy
seed 0; ``engine/steps.make_xe_train_step``), then runs SCST steps
(``make_scst_train_step``: a greedy baseline, a sampled rollout and the
CIDEr-D reward on the device, ``ops/cider``) and checks that the rewards
trend up and the greedy policy keeps at least 0.8 of its CIDEr-D.

    python -m simpleimagecaptionzoo_tpu_torch.examples.demo_scst \
        [--xe_steps 100] [--scst_steps 60] [--gpu_id 0|cpu]

It prints ``DEMO_RESULT: OK`` or ``WEAK``.
"""
import argparse
import sys
import time

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.engine import steps as S
from simpleimagecaptionzoo_tpu_torch.engine.optim import make_grad_transform
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode
from simpleimagecaptionzoo_tpu_torch.ops.cider import (CiderDTable,
                                                       RewardVocab,
                                                       cider_d_device,
                                                       seq_length_greedy)
from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab

PHRASES = [["a", "man", "rides", "a", "horse"],
           ["a", "dog", "runs", "on", "the", "beach"],
           ["two", "birds", "fly", "over", "water"],
           ["a", "red", "car", "parked", "outside"]]


def demo_data():
    """The demo's dataset (16 boxes of 64 features an image, the caption
    set by the first box's signature) with each image's reference in the
    reward's ids.  -> dict."""
    vocab = build_vocab(PHRASES * 5, threshold=1)
    reward_vocab = RewardVocab(vocab)
    rng = np.random.default_rng(0)
    n_img, n_box, feat_dim, t_max = 32, 16, 64, 10
    feats = rng.normal(size=(n_img, n_box, feat_dim)).astype(np.float32)
    cls = rng.integers(0, len(PHRASES), size=(n_img,))
    feats[:, 0, :4] = np.eye(4, dtype=np.float32)[cls] * 5.0
    caps = np.zeros((n_img, t_max), np.int32)
    lens = np.zeros((n_img,), np.int32)
    ref_ids = np.zeros((n_img, 5, 12), np.int32)
    ref_lens = np.zeros((n_img, 5), np.int32)
    for i in range(n_img):
        ids = vocab.encode_tokens(PHRASES[cls[i]])
        caps[i, :len(ids)] = ids
        lens[i] = len(ids)
        enc = reward_vocab.encode(PHRASES[cls[i]])
        ref_ids[i, 0, :len(enc)] = enc
        ref_lens[i, 0] = len(enc)
    table = CiderDTable.from_ref_corpus(
        [[reward_vocab.encode(p)] for p in PHRASES])
    cfg = ModelConfig(model_type="BUTDDetection", vocab_size=len(vocab),
                      embed_dim=64, hidden_dim=64, atten_dim=64,
                      enc_dim=feat_dim)
    return dict(vocab=vocab, feats=feats, caps=caps, lens=lens,
                ref_ids=ref_ids, ref_lens=ref_lens, table=table, cfg=cfg,
                n_img=n_img, n_box=n_box)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--xe_steps", type=int, default=100)
    ap.add_argument("--scst_steps", type=int, default=60)
    ap.add_argument("--scst_lr", type=float, default=1e-4)
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def run(args) -> dict:
    """The demo with parsed ``args`` -> ``{"ok", "rewards" (each SCST
    step's mean), "cider_before", "cider_after" (the greedy policy's mean
    CIDEr-D before and after SCST)}``; it prints as it goes."""
    dev = resolve_device("cpu" if args.gpu_id.strip().lower() == "cpu"
                         else "cuda:%d" % int(args.gpu_id))
    print("device:", dev, torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "")

    data = demo_data()
    table = data["table"]
    table_dev = table.device_arrays(dev)
    model = get_captioner(data["cfg"])
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    labels = model.param_labels(params)
    visual = {"bu_feats": torch.as_tensor(data["feats"], device=dev),
              "bu_masks": torch.ones(data["feats"].shape[:2], device=dev)}
    ref_ids = torch.as_tensor(data["ref_ids"], device=dev)
    ref_lens = torch.as_tensor(data["ref_lens"], device=dev)
    batch = {"visual": visual,
             "captions": torch.as_tensor(data["caps"], device=dev),
             "lengths": torch.as_tensor(data["lens"], device=dev)}

    # ---- XE pre-train -------------------------------------------------------
    tx = make_grad_transform("Adam", 0.1)
    state = TrainState.create(params, tx)
    xe = S.make_xe_train_step(model, tx, labels, device=dev)
    generator = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    m = None                         # --xe_steps 0 = SCST from random init
    for step in range(args.xe_steps):
        state, m = xe(state, batch, generator, 0.0, 4e-3, 0.0)
        if step == 0:
            print("xe step 0 loss %.4f (first step %.1fs)"
                  % (float(m["loss"]), time.time() - t0))
    if m is not None:
        print("xe final loss %.4f" % float(m["loss"]))

    def greedy_cider(params):
        with torch.inference_mode():
            enc, _ = model.encode(params, visual, train=False)
            ids, _ = decode.greedy(model, params, enc, max_len=9)
            scores = cider_d_device(table_dev, table.probe, ids,
                                    seq_length_greedy(ids), ref_ids,
                                    ref_lens)
        return float(scores.mean())

    cider_before = greedy_cider(state.params)

    # ---- SCST ---------------------------------------------------------------
    tx2 = make_grad_transform("Adam", 0.25)
    state = TrainState.create(state.params, tx2)
    scst = S.make_scst_train_step(model, tx2, labels, table_dev, table.probe,
                                  max_len=9, device=dev)
    scst_batch = {"visual": visual, "ref_ids": ref_ids, "ref_lens": ref_lens}
    t0 = time.time()
    rewards = []
    for step in range(args.scst_steps):
        state, m = scst(state, scst_batch, generator, args.scst_lr, 0.0)
        rewards.append(float(m["reward"]))
        if step == 0:
            print("scst step 0 reward %.4f (first step %.1fs)"
                  % (rewards[0], time.time() - t0))
        elif step % 10 == 0 or step == args.scst_steps - 1:
            print("scst step %d reward %.4f" % (step, rewards[-1]))
    steps_per_sec = args.scst_steps / (time.time() - t0)
    cider_after = greedy_cider(state.params)

    print("greedy CIDEr-D before SCST %.3f -> after %.3f | "
          "%.2f SCST steps/sec (batch %d, reward on the device)"
          % (cider_before, cider_after, steps_per_sec, data["n_img"]))
    # success: rewards trend up (the sample closes the gap to greedy) and
    # the greedy policy does not collapse
    trend_up = np.mean(rewards[-10:]) > np.mean(rewards[:10])
    ok = (trend_up and cider_after >= 0.8 * cider_before
          and np.isfinite(rewards).all())
    print("mean reward of the first 10 steps %.4f, of the last 10 %.4f"
          % (np.mean(rewards[:10]), np.mean(rewards[-10:])))
    print("DEMO_RESULT:", "OK" if ok else "WEAK")
    return dict(ok=bool(ok), rewards=rewards, cider_before=cider_before,
                cider_after=cider_after)


def main(argv=None) -> int:
    return 0 if run(build_argparser().parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
