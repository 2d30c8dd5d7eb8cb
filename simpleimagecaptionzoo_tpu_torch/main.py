"""CLI driver of the port (the JAX package's ``main.py``; reference
Main.py:16-196 surface).

    python -m simpleimagecaptionzoo_tpu_torch.main --operation train ...

Same operations (``train`` / ``scst_train`` / ``eval`` / ``sample``), same
flag names, defaults and choices, same config files
(``Configs/Datasets/<ds>.data``, ``Configs/Models/<model>.json``) and the
same on-disk layout (``CheckPoints/``, ``coco_caption/results/``), so the
two CLIs read each other's checkpoints.  ``--gpu_id`` picks the card as the
reference does (``0`` is ``cuda:0``); ``--gpu_id cpu`` runs on the CPU with
the kernels' plain versions.

Data parallel over processes (``parallel``): under torchrun
(``WORLD_SIZE`` > 1 in the environment) the process group starts before the
engine is built, each process on ``cuda:$LOCAL_RANK`` under NCCL, or with
``--gpu_id cpu`` every process on the CPU under gloo:

    torchrun --nproc_per_node N -m simpleimagecaptionzoo_tpu_torch.main ...
"""
from __future__ import annotations

import argparse
import os
import sys

from simpleimagecaptionzoo_tpu_torch.config import (DataConfig, LrOpts, SsOpts,
                                                    TrainConfig,
                                                    load_model_config)
from simpleimagecaptionzoo_tpu_torch.vocab import load_vocab


def _str2bool(v) -> bool:
    """Real boolean parsing for flag compatibility: the reference uses
    ``type=bool`` (Main.py:148,181-182), under which ``--flag False`` is
    truthy — an argparse footgun not reproduced here."""
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes", "y"):
        return True
    if str(v).lower() in ("false", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def device_of(gpu_id: str) -> str:
    """``--gpu_id`` -> a torch device string: ``"cpu"`` stays the CPU, an
    index ``i`` is ``cuda:<i>`` (reference Main.py:24-25)."""
    if gpu_id.strip().lower() == "cpu":
        return "cpu"
    try:
        index = int(gpu_id)
    except ValueError:
        raise ValueError("--gpu_id must be a card index or 'cpu', got %r"
                         % gpu_id) from None
    if index < 0:
        raise ValueError("--gpu_id must be >= 0, got %d" % index)
    return "cuda:%d" % index


def start_process_group(gpu_id: str):
    """-> (device, started): torchrun's ``WORLD_SIZE`` > 1 starts the
    default process group (``env://``: ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), each process on ``cuda:$LOCAL_RANK`` under NCCL
    (``--gpu_id`` left at its default), or on the CPU under gloo with
    ``--gpu_id cpu``; any other ``--gpu_id`` is refused.  Without it, the
    one process's device from ``--gpu_id`` and no group."""
    import torch.distributed as dist
    from simpleimagecaptionzoo_tpu_torch import parallel
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return device_of(gpu_id), False
    rank = int(os.environ["RANK"])
    if gpu_id.strip().lower() == "cpu":
        parallel.init_process_group("gloo", world, rank)
        return "cpu", True
    if gpu_id.strip() != "0":
        raise ValueError(
            "--gpu_id %s under WORLD_SIZE=%d: a data-parallel run takes "
            "cuda:$LOCAL_RANK in each process (leave --gpu_id at its "
            "default) or the CPU (--gpu_id cpu)" % (gpu_id, world))
    import torch
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = "cuda:%d" % local
    torch.cuda.set_device(torch.device(device))
    parallel.init_process_group("nccl", world, rank)
    return device, True


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="image captioning zoo, PyTorch port (CUDA)")
    # global
    p.add_argument("--dataset", type=str, default="COCO14")
    p.add_argument("--model_type", type=str, default="NIC")
    p.add_argument("--dataset_config_root", type=str,
                   default="./Configs/Datasets/")
    p.add_argument("--model_config_root", type=str,
                   default="./Configs/Models/")
    p.add_argument("--gpu_id", type=str, default="0",
                   help="the CUDA card's index (cuda:<gpu_id>), or 'cpu'")
    p.add_argument("--tqdm_visible", type=_str2bool, default=True)
    p.add_argument("--profile_dir", type=str, default="",
                   help="write one torch.profiler trace (Chrome trace "
                        "format, trace.json) of train steps 3-7 into this "
                        "directory (train/scst_train operations)")
    p.add_argument("--operation", type=str, default="train",
                   choices=["train", "scst_train", "eval", "sample"])
    # train
    p.add_argument("--start_from", type=str, default="stratch",
                   help='"stratch" (sic, reference spelling) or "checkpoint"')
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--image_ingest", type=str, default="parity",
                   choices=["parity", "fast", "device"],
                   help="from-pixels host ingest: parity = reference-exact "
                        "full-res decode+resample; fast = DCT-scaled decode "
                        "+ host resample; device = scaled decode only, "
                        "resize+normalize on the device")
    p.add_argument("--optimizer", type=str, default="Adam")
    p.add_argument("--use_bu", type=str, default="unused",
                   choices=["fixed", "adaptive", "unused"])
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--train_batch_size", type=int, default=128)
    p.add_argument("--label_smoothing", type=float, default=0.1)
    p.add_argument("--learning_rate", type=float, default=4e-4)
    p.add_argument("--cnn_finetune_learning_rate", type=float, default=1e-4)
    p.add_argument("--cnn_finetune_start", type=int, default=8)
    p.add_argument("--scheduled_sampling_start", type=int, default=0)
    p.add_argument("--scheduled_sampling_increase_every", type=int, default=5)
    p.add_argument("--scheduled_sampling_increase_prob", type=float,
                   default=0.05)
    p.add_argument("--scheduled_sampling_max_prob", type=float, default=0.5)
    p.add_argument("--learning_rate_decay_start", type=int, default=0)
    p.add_argument("--learning_rate_decay_every", type=int, default=3)
    p.add_argument("--learning_rate_decay_rate", type=float, default=0.8)
    # scst
    p.add_argument("--scst_num_epochs", type=int, default=50)
    p.add_argument("--scst_train_batch_size", type=int, default=128)
    p.add_argument("--scst_learning_rate", type=float, default=1e-5)
    p.add_argument("--scst_cnn_finetune_learning_rate", type=float,
                   default=1e-5)
    # eval
    p.add_argument("--eval_scst", type=_str2bool, default=False)
    p.add_argument("--eval_best", type=_str2bool, default=True)
    p.add_argument("--eval_split", type=str, default="test")
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--eval_beam_size", type=int, default=3)
    p.add_argument("--output_statics", type=_str2bool, default=False)
    p.add_argument("--train_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision training (f32 master "
                        "params + optimizer, bf16 forward/backward)")
    p.add_argument("--decode_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="eval/sample decode precision; bfloat16 halves the "
                        "weight traffic of decoding, int8 additionally "
                        "stores the decode-step hot weights as weight-only "
                        "int8 (approximate; see ops/quant.py)")
    p.add_argument("--midepoch_save_steps", type=int, default=0,
                   help="N > 0: save a step-level resume point every N "
                        "training steps (params, optimizer state and the "
                        "exact stream position); --start_from checkpoint "
                        "then resumes an interrupted epoch bit-identically. "
                        "0 (default): epoch-boundary checkpoints only, like "
                        "the reference")
    # sample
    p.add_argument("--img_filename", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(args) -> int:
    device, started = start_process_group(args.gpu_id)
    try:
        return _main(args, device)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, device: str) -> int:
    from simpleimagecaptionzoo_tpu_torch.engine.model_engines import \
        get_engine
    base_dir = os.path.abspath(os.getcwd())
    data_cfg = DataConfig.from_data_file(
        os.path.join(args.dataset_config_root, args.dataset + ".data"),
        base_dir=base_dir, dataset_name=args.dataset)
    os.makedirs(data_cfg.data_dir, exist_ok=True)
    if not os.path.exists(data_cfg.caption_vocab_path):
        print("Caption Vocab not generated. "
              "Run preprocess/build_caption_vocab.py first.")
        return 1
    vocab = load_vocab(data_cfg.caption_vocab_path)
    print(f"Caption Vocab for dataset:{args.dataset} loaded "
          f"({len(vocab)} words).")

    model_cfg = load_model_config(
        os.path.join(args.model_config_root, args.model_type + ".json"),
        vocab_size=len(vocab),
        max_bu_len=(100 if args.use_bu == "adaptive" else 36))

    train_cfg = TrainConfig(
        num_epochs=args.num_epochs,
        train_batch_size=args.train_batch_size,
        label_smoothing=args.label_smoothing,
        optimizer=args.optimizer,
        lr_opts=LrOpts(
            learning_rate=args.learning_rate,
            cnn_finetune_learning_rate=args.cnn_finetune_learning_rate,
            cnn_finetune_start=args.cnn_finetune_start,
            lr_dec_start_epoch=args.learning_rate_decay_start,
            lr_dec_every=args.learning_rate_decay_every,
            lr_dec_rate=args.learning_rate_decay_rate),
        ss_opts=SsOpts(
            ss_start_epoch=args.scheduled_sampling_start,
            ss_inc_every=args.scheduled_sampling_increase_every,
            ss_inc_prob=args.scheduled_sampling_increase_prob,
            ss_max_prob=args.scheduled_sampling_max_prob),
        scst_num_epochs=args.scst_num_epochs,
        scst_train_batch_size=args.scst_train_batch_size,
        scst_learning_rate=args.scst_learning_rate,
        scst_cnn_finetune_learning_rate=args.scst_cnn_finetune_learning_rate,
        eval_batch_size=args.eval_batch_size,
        decode_dtype=args.decode_dtype,
        train_dtype=args.train_dtype,
        midepoch_save_steps=args.midepoch_save_steps,
        img_size=args.img_size,
        image_ingest=args.image_ingest,
        seed=args.seed,
    )

    use_bu = None if args.use_bu == "unused" else args.use_bu
    engine = get_engine(model_cfg, data_cfg, vocab, train_config=train_cfg,
                        use_bu=use_bu, tqdm_visible=bool(args.tqdm_visible),
                        profile_dir=args.profile_dir or None, device=device)
    print("engine construction complete.")

    start = "checkpoint" if args.start_from == "checkpoint" else "scratch"
    if args.operation == "train":
        engine.training(start_from=start, num_epochs=args.num_epochs)
    elif args.operation == "scst_train":
        engine.scst_training(
            start_from=start, num_epochs=args.scst_num_epochs,
            idf_cache=os.path.join(data_cfg.data_dir, "cider_idf_table.npz"))
    elif args.operation == "eval":
        score = engine.eval(split=args.eval_split, eval_scst=args.eval_scst,
                            eval_best=args.eval_best,
                            eval_beam_size=args.eval_beam_size,
                            output_statics=args.output_statics)
        # machine-readable record next to the training epochs' records;
        # --output_statics returns per-image statistics, not one CIDEr
        if not args.output_statics:
            engine._log_metrics({"phase": "eval", "split": args.eval_split,
                                 "beam_size": int(args.eval_beam_size),
                                 "scst": bool(args.eval_scst),
                                 "decode_dtype": args.decode_dtype,
                                 "cider": float(score)})
    elif args.operation == "sample":
        if not args.img_filename:
            print("--img_filename required for operation=sample")
            return 1
        engine.test(args.img_filename, use_scst_model=args.eval_scst,
                    use_best_model=args.eval_best,
                    eval_beam_size=args.eval_beam_size)
    return 0


if __name__ == "__main__":
    sys.exit(main(build_argparser().parse_args()))
