"""Export the port's checkpoint as a reference-loadable PyTorch ``.pth``
(the JAX package's ``tools/export_reference_checkpoint.py``).

The inverse of ``convert_reference_checkpoint``: reads the flax msgpack
checkpoint both packages write (reference directory layout, reference
Engine.py:81-88) onto the card given by ``--gpu_id`` and writes a torch
state_dict with the reference modules' key names (Models/{NIC,BUTD,AoA}_
Model.py), so a model trained here loads into the reference with strict
``load_state_dict``, and a converter round trip (export -> convert) can be
checked end to end:

    python -m simpleimagecaptionzoo_tpu_torch.tools.export_reference_checkpoint \
        --model_config Configs/Models/BUTDDetection.json --vocab_size 10102 \
        --dataset Flickr8K [--checkpoint_root ./CheckPoints] [--scst] \
        [--best] [--gpu_id 0] --out /path/to/Captioner_cp.pth
"""
from __future__ import annotations

import argparse


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_config", required=True,
                    help="Configs/Models/<model>.json the checkpoint was "
                         "trained with (sets the template tree's shapes)")
    ap.add_argument("--vocab_size", type=int, required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--scst", action="store_true",
                    help="read the SCST checkpoint slot")
    ap.add_argument("--best", action="store_true",
                    help="read best/ instead of cp/")
    ap.add_argument("--checkpoint_root", default="./CheckPoints")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the CUDA card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def main(argv=None) -> int:
    import torch

    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.convert_reference import \
        save_reference_checkpoint
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    from simpleimagecaptionzoo_tpu_torch.main import device_of
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device_of(args.gpu_id))
    cfg = load_model_config(args.model_config, args.vocab_size)
    model = get_captioner(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    template = {"params": model.init_params(gen, include_cnn=cfg.uses_cnn),
                "model_state": model.init_model_state()}
    mgr = CheckpointManager(cfg.model_type, args.dataset,
                            root=args.checkpoint_root)
    tree, _, _ = mgr.load(template, scst=args.scst, best=args.best)
    if tree is None:
        raise SystemExit(f"no checkpoint found under {args.checkpoint_root} "
                         f"(scst={args.scst}, best={args.best})")
    save_reference_checkpoint(args.out, tree["params"], tree["model_state"],
                              cfg.model_type)
    n = sum(int(t.numel()) for t in tree_leaves(tree["params"]))
    print(f"exported {cfg.model_type} ({n:,} parameters) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
