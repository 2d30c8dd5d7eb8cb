"""End-to-end smoke demo through the port's public surface.

The JAX package's ``examples/demo_e2e.py`` on the port: builds the same
tiny synthetic captioning dataset (numpy seed 0), trains a captioner of the
same ``ModelConfig`` for a few XE steps with label smoothing (the value
clamp at 0.1, then Adam at 4e-3: optax's ``chain(clip(0.1), adam(4e-3))``,
computed by the port's ``engine/optim``), decodes greedy and beam 3, and
scores the output with the port's CIDEr-D and BLEU.  Run:

    python -m simpleimagecaptionzoo_tpu_torch.examples.demo_e2e \
        [--steps 40] [--model BUTDDetection] [--gpu_id 0|cpu]

It prints ``DEMO_RESULT: OK`` when the loss fell below 0.7 of its first
value and at least half the greedy captions are exact, else ``WEAK``.
"""
import argparse
import sys
import time

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.engine.optim import (
    apply_updates_partitioned, make_grad_transform, tree_leaves,
    tree_unflatten)
from simpleimagecaptionzoo_tpu_torch.evalcap.bleu import Bleu
from simpleimagecaptionzoo_tpu_torch.evalcap.cider_scorer import CiderD
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode
from simpleimagecaptionzoo_tpu_torch.ops.losses import (label_smoothing_loss,
                                                        xe_mask_from_lengths)
from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab

PHRASES = [["a", "man", "rides", "a", "horse"],
           ["a", "dog", "runs", "on", "the", "beach"],
           ["two", "birds", "fly", "over", "water"],
           ["a", "red", "car", "parked", "outside"]]
GRAD_CLIP, LR = 0.1, 4e-3


def demo_data(model_name: str):
    """The demo's dataset: each "image" is a random 36 x 64 feature set
    whose caption follows from its feature signature (the first box's
    first four features).  -> dict of the vocab, the features, the classes,
    the captions (ids) and lengths - 1, and the ``ModelConfig``."""
    vocab = build_vocab(PHRASES * 5, threshold=1)
    rng = np.random.default_rng(0)
    n_img, n_box, feat_dim, t_max = 32, 36, 64, 10
    feats = rng.normal(size=(n_img, n_box, feat_dim)).astype(np.float32)
    cls = rng.integers(0, len(PHRASES), size=(n_img,))
    feats[:, 0, :4] = np.eye(4, dtype=np.float32)[cls] * 5.0  # signature
    caps = np.zeros((n_img, t_max), np.int64)
    lens = np.zeros((n_img,), np.int64)
    for i in range(n_img):
        ids = vocab.encode_tokens(PHRASES[cls[i]])
        caps[i, :len(ids)] = ids
        lens[i] = len(ids) - 1
    cfg = ModelConfig(model_type=model_name, vocab_size=len(vocab),
                      embed_dim=64, hidden_dim=64, atten_dim=64,
                      enc_dim=feat_dim, num_heads=4, num_refine_layers=2,
                      enc_img_size=6)
    return dict(vocab=vocab, feats=feats, cls=cls, caps=caps, lens=lens,
                cfg=cfg, n_img=n_img, n_box=n_box, t_max=t_max)


def demo_visual(model_name: str, feats: np.ndarray, dev) -> dict:
    """The model's visual input: NIC the first box's features, the Spatial
    families the boxes as a grid, the Detection families the boxes with
    every mask 1."""
    if model_name == "NIC":
        return {"features": torch.as_tensor(feats[:, 0, :], device=dev)}
    if model_name.endswith("Spatial"):
        return {"spatial_feats": torch.as_tensor(feats, device=dev)}
    return {"bu_feats": torch.as_tensor(feats, device=dev),
            "bu_masks": torch.ones(feats.shape[:2], device=dev)}


def make_optimizer(model, params):
    """optax's ``chain(clip(GRAD_CLIP), adam(LR))`` as the port computes
    it: ``engine/optim``'s clamp-then-Adam directions, applied at LR.
    -> (opt_state, update(params, grads, opt_state) -> (params,
    opt_state))."""
    tx = make_grad_transform("Adam", GRAD_CLIP)
    labels = model.param_labels(params)

    def update(params, grads, opt_state):
        with torch.no_grad():
            directions, opt_state = tx.update(grads, opt_state, params)
            params = apply_updates_partitioned(params, directions, labels,
                                               LR, 0.0)
        return params, opt_state

    return tx.init(params), update


def score(vocab, phrases, cls, greedy_ids, beam_ids):
    """CIDEr-D (corpus df) of the greedy and the beam captions, BLEU of the
    beam's, and the greedy exact matches, each image's one reference its
    phrase.  -> (cider_g, cider_b, bleu, n_correct)."""
    gts, res_g, res_b = {}, [], []
    n_correct = 0
    for i in range(len(cls)):
        truth = " ".join(phrases[cls[i]])
        g = " ".join(vocab.decode_ids(greedy_ids[i].tolist()))
        b = " ".join(vocab.decode_ids(beam_ids[i].tolist()))
        gts[i] = [truth]
        res_g.append({"image_id": i, "caption": [g]})
        res_b.append({"image_id": i, "caption": [b]})
        n_correct += int(g == truth)
        if i < 4:
            print("img %d gt=%r greedy=%r beam=%r" % (i, truth, g, b))
    cider_g, _ = CiderD(df="corpus").compute_score(gts, res_g)
    cider_b, _ = CiderD(df="corpus").compute_score(gts, res_b)
    bleu, _ = Bleu(4).compute_score(gts, {e["image_id"]: e["caption"]
                                          for e in res_b})
    return cider_g, cider_b, bleu, n_correct


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--model", type=str, default="BUTDDetection")
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def run(args) -> dict:
    """The demo with parsed ``args`` -> ``{"ok", "first_loss",
    "final_loss", "n_correct", "n_img", "cider_greedy", "cider_beam",
    "bleu"}``; it prints as it goes."""
    dev = resolve_device("cpu" if args.gpu_id.strip().lower() == "cpu"
                         else "cuda:%d" % int(args.gpu_id))
    print("device:", dev, torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "")

    data = demo_data(args.model)
    vocab, cfg, t_max = data["vocab"], data["cfg"], data["t_max"]
    print("vocab size:", len(vocab))
    model = get_captioner(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    visual = demo_visual(args.model, data["feats"], dev)
    caps = torch.as_tensor(data["caps"], device=dev)
    mask = xe_mask_from_lengths(torch.as_tensor(data["lens"], device=dev),
                                t_max - 1)
    opt_state, update = make_optimizer(model, params)

    def train_step(params, opt_state, generator):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        enc, _ = model.encode(p, visual, train=True, generator=generator)
        # scheduled sampling at probability 0, as the JAX demo's
        logits = decode.teacher_forced_logits(model, p, enc, caps, 0.0,
                                              generator, train=True,
                                              ss_active=False)
        loss = label_smoothing_loss(logits, caps[:, 1:], mask, 0.1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = tree_unflatten(params, [
            torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)])
        params, opt_state = update(params, grads, opt_state)
        return params, opt_state, loss.detach()

    generator = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    first_loss = None
    loss = None                      # --steps 0 = decode-only run
    for step in range(args.steps):
        params, opt_state, loss = train_step(params, opt_state, generator)
        if step == 0:
            first_loss = float(loss)
            print("step 0 loss %.4f (first step %.1fs)"
                  % (first_loss, time.time() - t0))
        elif step % 10 == 0 or step == args.steps - 1:
            print("step %d loss %.4f" % (step, float(loss)))
    final_loss = float(loss) if loss is not None else float("nan")

    with torch.inference_mode():
        enc, _ = model.encode(params, visual, train=False)
        greedy_ids, _ = decode.greedy(model, params, enc, max_len=9)
        beam_ids = decode.beam_search(model, params, enc, beam_size=3,
                                      max_steps=12)
    cider_g, cider_b, bleu, n_correct = score(
        vocab, PHRASES, data["cls"], greedy_ids.cpu(), beam_ids.cpu())
    n_img = data["n_img"]
    print("loss %.4f -> %.4f | greedy exact-match %d/%d | "
          "CIDEr-D greedy %.2f beam %.2f | BLEU-4 %.3f"
          % (first_loss if first_loss is not None else float("nan"),
             final_loss, n_correct, n_img, cider_g, cider_b, bleu[3]))
    ok = (first_loss is not None and final_loss < first_loss * 0.7
          and n_correct >= n_img // 2)
    print("DEMO_RESULT:", "OK" if ok else "WEAK")
    return dict(ok=bool(ok), first_loss=first_loss, final_loss=final_loss,
                n_correct=n_correct, n_img=n_img, cider_greedy=cider_g,
                cider_beam=cider_b, bleu=bleu)


def main(argv=None) -> int:
    return 0 if run(build_argparser().parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
