"""Convert a reference PyTorch checkpoint into the port's checkpoint (the
JAX package's ``tools/convert_reference_checkpoint.py``).

Point it at a reference ``Captioner_[scst_]cp.pth`` (a torch state_dict,
reference Engine.py:81-88) and it writes the flax msgpack checkpoint both
packages read, in the reference directory layout, ready for ``python -m
simpleimagecaptionzoo_tpu_torch.main --operation eval``:

    python -m simpleimagecaptionzoo_tpu_torch.tools.convert_reference_checkpoint \
        --pth /path/to/Captioner_cp.pth --model_type BUTDSpatial \
        --dataset COCO14 [--scst] [--best] [--checkpoint_root ./CheckPoints] \
        [--gpu_id 0]

By default it writes the "latest" slot (``cp/``); ``--best`` writes the
``best/`` slot instead (without touching score records or histories, so an
existing training run's bookkeeping is kept).  The converted tree is carried
to the card given by ``--gpu_id`` (``cpu``: the host) and written from
there.
"""
from __future__ import annotations

import argparse

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pth", required=True,
                    help="reference Captioner_[scst_]cp.pth (torch state_dict)")
    ap.add_argument("--model_type", required=True,
                    choices=["NIC", "BUTDSpatial", "BUTDDetection",
                             "AoASpatial", "AoADetection"])
    ap.add_argument("--dataset", required=True,
                    help="dataset name for the checkpoint directory tag "
                         "(e.g. COCO14)")
    ap.add_argument("--scst", action="store_true",
                    help="write the SCST checkpoint slot")
    ap.add_argument("--best", action="store_true",
                    help="write best/ instead of cp/")
    ap.add_argument("--checkpoint_root", default="./CheckPoints")
    ap.add_argument("--no_strict", action="store_true",
                    help="tolerate unconsumed state_dict keys")
    ap.add_argument("--gpu_id", type=str, default="0",
                    help="the CUDA card's index (cuda:<gpu_id>), or 'cpu'")
    return ap


def main(argv=None) -> int:
    from simpleimagecaptionzoo_tpu_torch.convert import from_jax
    from simpleimagecaptionzoo_tpu_torch.convert_reference import \
        load_reference_checkpoint
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    from simpleimagecaptionzoo_tpu_torch.main import device_of
    args = build_argparser().parse_args(argv)
    dev = resolve_device(device_of(args.gpu_id))
    params, model_state = load_reference_checkpoint(
        args.pth, args.model_type, strict=not args.no_strict)
    n_params = sum(int(np.prod(np.shape(x))) for x in _leaves(params))
    print(f"converted {args.model_type}: {n_params:,} parameters"
          + ("" if model_state["cnn_stats"] is None
             else " (+ frozen CNN BN stats)"))
    tree = from_jax({"params": params, "model_state": model_state}, dev)
    mgr = CheckpointManager(args.model_type, args.dataset,
                            root=args.checkpoint_root)
    out = mgr._weights(mgr.best_dir if args.best else mgr.cp_dir, args.scst)
    mgr._atomic_write(out, tree, binary=True)
    print(f"wrote {out}")
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    raise SystemExit(main())
