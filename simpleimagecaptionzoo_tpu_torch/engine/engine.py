"""Training / eval / sample orchestration (the JAX package's
``engine/engine.py``; reference Engine.py:16-341), on one device.

* ``training``      — XE epochs with staircase LR decay, staged CNN
  finetune, scheduled-sampling schedule, a fresh optimizer each epoch,
  per-epoch val decode -> coco_eval -> CIDEr -> double-gated
  best-checkpoint save (Engine.py:91-167).
* ``scst_training`` — loads the best XE checkpoint, fixed-LR REINFORCE with
  the CIDEr-D self-critical reward on the device (``engine/steps``), same
  per-epoch eval and best gating (Engine.py:191-249).
* ``eval`` / ``test`` — checkpoint selection + caption json generation +
  coco_eval[_specific]; single-image sample (``engine/sample.py``).

The steps and decodes are ``engine/steps``' (K1-K4 on the card).  The host
loop schedules, feeds prefetched batches (pinned, copied without blocking),
detokenizes and checkpoints.  Support machinery lives in mixins:
``observe.py`` (logging, metrics, the profiler window), ``multihost.py``
(the single writer and the checkpoint agreement of a data-parallel run),
``midepoch.py`` (step-level resume points) and ``sample.py``.

Data parallel (``parallel``): under a process group each process takes its
rows of every global batch (the batchers' ``_ProcessShard``), the steps
make the global batch's step of them, eval decodes its rows and all-gathers
the ids so that every process scores the same result set, and process 0
alone writes checkpoints and ``metrics.jsonl``, a barrier after each write.
"""
from __future__ import annotations

import functools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.config import (DataConfig, ModelConfig,
                                                    TrainConfig)
from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData
from simpleimagecaptionzoo_tpu_torch.data.datasets import (
    CaptionEvalBatches, CaptionTrainBatches, CaptionTrainSCSTBatches,
    SuppFeatureLoader, _VisualSource)
from simpleimagecaptionzoo_tpu_torch.data.loader import Prefetcher
from simpleimagecaptionzoo_tpu_torch.device import resolve_device
from simpleimagecaptionzoo_tpu_torch.engine import steps as S
from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import CheckpointManager
from simpleimagecaptionzoo_tpu_torch.engine.midepoch import MidEpochMixin
from simpleimagecaptionzoo_tpu_torch.engine.multihost import MultiHostMixin
from simpleimagecaptionzoo_tpu_torch.engine.observe import (
    ObservabilityMixin, sync)
from simpleimagecaptionzoo_tpu_torch.engine.optim import make_grad_transform
from simpleimagecaptionzoo_tpu_torch.engine.sample import SampleMixin
from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
from simpleimagecaptionzoo_tpu_torch.evalcap.coco_eval import (
    coco_eval, coco_eval_specific)
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import cider as ops_cider
from simpleimagecaptionzoo_tpu_torch.ops.cider import CiderDTable, RewardVocab
from simpleimagecaptionzoo_tpu_torch.parallel import (barrier, get_mesh,
                                                      host_read,
                                                      place_params,
                                                      process_count,
                                                      process_index,
                                                      replicate_tree,
                                                      shard_batch, to_device)
from simpleimagecaptionzoo_tpu_torch.vocab import Vocabulary

__all__ = ["Engine", "to_device"]


class Engine(ObservabilityMixin, MultiHostMixin, MidEpochMixin, SampleMixin):
    """One engine per (model config, dataset) on one device (``"cuda"`` by
    default; ``"cuda:<i>"`` picks a card, ``"cpu"`` runs the plain
    versions of the kernels), and one per process of a data-parallel run
    (``parallel.get_mesh``: the process group started before it).
    Subclasses override
    :meth:`show_additional_rlt` for attention visualization — the
    reference's extension hook (Engine.py:341).

    What the last run measured stays readable: ``last_epoch`` (steps,
    seconds, steps/sec without the first step), ``epoch_losses`` /
    ``epoch_rewards`` (per step), ``last_eval`` (captions, seconds of the
    decode loop), ``last_coco_eval_s``, ``last_save_s`` (the epoch's
    checkpoint writes), ``last_load_s``, ``midepoch_saves`` (each
    resume point's ms on the loop and in the background, and its bytes)
    and ``last_state`` (the TrainState at the last epoch's end: params,
    the optimizer's moments, the step count)."""

    def __init__(self, model_config: ModelConfig, data_config: DataConfig,
                 vocab: Vocabulary,
                 train_config: Optional[TrainConfig] = None,
                 use_bu: Optional[str] = None,
                 checkpoint_root: str = "./CheckPoints",
                 device="cuda", verbose: bool = True,
                 tqdm_visible: bool = True,
                 profile_dir: Optional[str] = None) -> None:
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            # the kernels launch on the current card's stream
            torch.cuda.set_device(self.device)
        self.mesh = get_mesh(self.device)
        self.cfg = model_config
        self.data_cfg = data_config
        self.train_cfg = train_config or TrainConfig()
        self.vocab = vocab
        self.use_bu = use_bu  # 'fixed' | 'adaptive' | None
        self.verbose = verbose
        self.tqdm_visible = tqdm_visible and verbose
        self.model = get_captioner(model_config)
        self.model.ingest_out_size = self.train_cfg.img_size
        self.ckpt = CheckpointManager(model_config.model_type,
                                      data_config.dataset_name,
                                      root=checkpoint_root)
        # one generator for the run: init's draws, then every step's
        # dropout; each step's sampling draws come from it and the step
        # count (steps.draw_generator_for).  Every process seeds it alike,
        # and each draw takes the global batch's shape, so the processes'
        # generators stay in step
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.train_cfg.seed)
        params = self.model.init_params(self._gen,
                                        include_cnn=self.cfg.uses_cnn)
        self.tree = {"params": params,
                     "model_state": self.model.init_model_state()}
        self._place()
        self._decoders: dict = {}
        self._capdata_cache: dict = {}
        self.profile_dir = profile_dir or None
        self.midepoch_saves: List[dict] = []

    # ------------------------------------------------------------------ utils
    def _place(self):
        """The tree on the engine's device, process 0's values on every
        process."""
        self.tree = {"params": place_params(self.mesh, self.tree["params"]),
                     "model_state": replicate_tree(self.mesh,
                                                   self.tree["model_state"])}

    def _visual_source(self, needs_images: Optional[bool] = None
                       ) -> _VisualSource:
        supp = None
        if self.cfg.uses_bu:
            supp = SuppFeatureLoader(self.data_cfg.data_dir, self.use_bu or
                                     "fixed", self.cfg.max_bu_len)
        if needs_images is None:
            needs_images = not self.cfg.uses_bu
        return _VisualSource(self.data_cfg.dataset_name,
                             self.data_cfg.image_root, needs_images, supp,
                             img_size=self.train_cfg.img_size,
                             packed_dir=self.data_cfg.data_dir,
                             ingest=self.train_cfg.image_ingest)

    def _split_path(self, split: str) -> str:
        return {"train": self.data_cfg.train_caption_path,
                "val": self.data_cfg.val_caption_path,
                "test": self.data_cfg.test_caption_path}.get(split, "")

    def _capdata(self, split: str) -> CaptionData:
        path = self._split_path(split)
        if not path:
            raise ValueError(
                f"dataset {self.data_cfg.dataset_name} has no {split!r} "
                "split (COCO17 has train/val only)")
        # cached per split: the training loops re-enter the val split every
        # epoch, and the annotation file never changes mid-run
        hit = self._capdata_cache.get(split)
        if hit is None:
            hit = CaptionData(annotation_file=path)
            self._capdata_cache[split] = hit
        return hit

    # --------------------------------------------------------------- decoding
    def _decoder(self, beam_size: int, return_alphas: bool = False):
        """Cached decode function: greedy when beam_size == -1 (reference
        eval_beam_size convention), else batched beam."""
        key = (beam_size, return_alphas)
        if key not in self._decoders:
            dtype = self._decode_dtype()
            if beam_size == -1:
                self._decoders[key] = S.make_greedy_decode(
                    self.model, self.train_cfg.decode_max_len,
                    return_alphas=return_alphas, dtype=dtype,
                    device=self.device)
            else:
                self._decoders[key] = S.make_beam_decode(
                    self.model, beam_size, self.train_cfg.beam_max_steps,
                    return_alphas=return_alphas, dtype=dtype,
                    device=self.device)
        return self._decoders[key]

    def _train_dtype(self):
        choice = self.train_cfg.train_dtype
        if choice not in ("float32", "bfloat16"):
            raise ValueError(f"train_dtype must be 'float32' or 'bfloat16', "
                             f"got {choice!r}")
        return torch.bfloat16 if choice == "bfloat16" else None

    def _decode_dtype(self):
        choice = self.train_cfg.decode_dtype
        if choice not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"decode_dtype must be 'float32', 'bfloat16' or "
                             f"'int8', got {choice!r}")
        # int8 = bf16 activations + weight-only int8 hot set (ops/quant.py)
        return None if choice == "float32" else torch.bfloat16

    def _decode_params(self):
        """Params handed to the eval decodes.  Under ``decode_dtype='int8'``
        the decode-step hot weights are replaced by their weight-only int8
        form (cached until the params change)."""
        params = self.tree["params"]
        if self.train_cfg.decode_dtype != "int8":
            return params
        if getattr(self, "_qparams_src", None) is not params:
            self._qparams = self.model.quantize_decode_params(params)
            self._qparams_src = params
        return self._qparams

    def eval_captions_json_generation(self, split: str = "val",
                                      eval_beam_size: int = -1,
                                      batch_size: Optional[int] = None,
                                      full_precision: bool = False
                                      ) -> List[dict]:
        """Decode a split into [{'image_id', 'caption'}, ...] (reference
        Engine.py:274-300).  Beam search stays batched (the reference forces
        batch 1 under beam, Utils.py:72-74).  The last batch is padded to
        the full batch; only its real rows are kept.

        ``full_precision=True`` bypasses the weight-only int8 decode params:
        the training loops pass it so per-epoch validation CIDEr, which
        drives best-checkpoint selection, ranks models on the full-precision
        weights even under ``--decode_dtype int8`` (the decode still runs
        in the configured dtype's activations)."""
        capdata = self._capdata(split)
        batches = CaptionEvalBatches(
            capdata, self._visual_source(),
            batch_size or self.train_cfg.eval_batch_size, split,
            process_index=process_index(), process_count=process_count())
        decode = self._decoder(eval_beam_size)
        results: List[dict] = []
        n_captions = 0
        t0 = time.perf_counter()
        # depth-2 pipeline: batch i+1's decode is queued before batch i's
        # ids are copied to the host
        pending: List[tuple] = []

        def drain(entry):
            nonlocal n_captions
            ids, g_ids, g_real = entry
            # the global batch's ids on every process (this process's rows
            # all-gathered), the image ids and the real-row count from the
            # batcher's global_* fields, which every process derives alike;
            # global row j is real iff j < global n_real
            ids = host_read(ids)                     # sync point
            for j in range(int(g_real)):
                words = self.vocab.decode_ids(ids[j])
                results.append({"image_id": int(g_ids[j]),
                                "caption": " ".join(words)})
            n_captions += int(g_real)

        decode_params = (self.tree["params"] if full_precision
                         else self._decode_params())
        for batch in Prefetcher(batches.epoch).epoch():
            visual = shard_batch(self.mesh, batch["visual"])
            ids_dev = decode(decode_params, self.tree["model_state"], visual)
            pending.append((ids_dev, batch["global_img_ids"],
                            batch["global_n_real"]))
            if len(pending) > 2:
                drain(pending.pop(0))
        for entry in pending:
            drain(entry)
        dt = time.perf_counter() - t0
        self.last_eval = {"captions": n_captions, "seconds": dt}
        self._log(f"decoded {n_captions} captions in {dt:.1f}s "
                  f"({n_captions / max(dt, 1e-9):.1f} captions/sec)")
        return results

    def _score_val(self, eval_beam_size: int) -> float:
        results = self.eval_captions_json_generation(
            "val", eval_beam_size, full_precision=True)
        t0 = time.perf_counter()
        cider = coco_eval(results, self.data_cfg.val_caption_path)
        self.last_coco_eval_s = time.perf_counter() - t0
        return cider

    def _save_epoch(self, cider: float, best_cider: float,
                    history_best: float, cider_scores: List[float],
                    scst: bool, mid_on: bool) -> bool:
        """The per-epoch checkpoint, by process 0: best (when ``cider``
        beats this run's best and every run's), then latest; then the
        epoch's resume point goes (after the save in flight, if any), and a
        barrier makes the writes durable before any process reads them.
        True when ``cider`` is this run's new best."""
        t0 = time.perf_counter()
        better = cider > best_cider
        if self._is_writer:
            host = self._host_tree()
            if better and cider > history_best:
                self.ckpt.save_best(host, cider, scst=scst)
            self.ckpt.save(host, cider_scores, scst=scst)
        if mid_on:
            self._midepoch_join()       # never clear under a save in flight
            if self._is_writer:
                self.ckpt.clear_midepoch(scst=scst)
        barrier("%s_epoch_ckpt" % ("scst" if scst else "xe"))
        self.last_save_s = time.perf_counter() - t0
        return better

    def _load_into_tree(self, scst: bool, best: bool, tag: str = "load"):
        """Load a checkpoint into ``self.tree``; with several processes,
        check that every process loaded the same one."""
        t0 = time.perf_counter()
        tree, cider_his, start_epoch = self.ckpt.load(self.tree, scst=scst,
                                                      best=best)
        self._check_multihost_ckpt(
            tree, () if best else (start_epoch, len(cider_his)), tag)
        if tree is not None:
            self.tree = tree
            self._place()
        self.last_load_s = time.perf_counter() - t0
        return cider_his, start_epoch

    # --------------------------------------------------------------- training
    def training(self, start_from: str = "scratch",
                 num_epochs: Optional[int] = None,
                 eval_beam_size: int = -1) -> List[float]:
        """XE training (reference Engine.py:91-167).  Every way out joins
        the mid-epoch save in flight, so even an interrupt leaves the
        newest completed resume point on disk."""
        try:
            out = self._training_impl(start_from, num_epochs,
                                      eval_beam_size)
        except BaseException:
            self._midepoch_join(raise_error=False)
            raise
        self._midepoch_join()
        return out

    def _training_impl(self, start_from: str, num_epochs: Optional[int],
                       eval_beam_size: int) -> List[float]:
        tc = self.train_cfg
        num_epochs = num_epochs or tc.num_epochs
        history_best = self.ckpt.history_best(scst=False)
        self._log("history best cider on val split w/o beam search: %.3f"
                  % history_best)
        cider_scores: List[float] = []
        start_epoch = 1
        if start_from == "checkpoint":
            cider_scores, start_epoch = self._load_into_tree(
                scst=False, best=False, tag="XE resume")
        else:
            self._log("training from scratch")
        best_cider = max(cider_scores) if cider_scores else 0.0
        best_epoch = (cider_scores.index(best_cider) + 1) if cider_scores else 0

        tx = make_grad_transform(tc.optimizer, tc.grad_clip)
        labels = self.model.param_labels(self.tree["params"])
        # one step function per (frozen-cnn, ss-active) combination: frozen
        # detaches layer4 too; ss_active=False leaves scheduled sampling's
        # head calls and draws out in the epochs before its schedule starts
        step_fns: Dict = {}

        def get_step(frozen: bool, ss_on: bool):
            key = (frozen, ss_on)
            if key not in step_fns:
                step_fns[key] = S.make_xe_train_step(
                    self.model, tx, labels, tc.label_smoothing,
                    freeze_cnn=frozen, compute_dtype=self._train_dtype(),
                    ss_active=ss_on, device=self.device)
            return step_fns[key]
        capdata = self._capdata("train")
        batches = CaptionTrainBatches(capdata, self.vocab,
                                      self._visual_source(),
                                      tc.train_batch_size,
                                      tc.max_caption_len, seed=tc.seed,
                                      process_index=process_index(),
                                      process_count=process_count())
        mid_on = self._midepoch_enabled()
        resume_opt, resume_skip, resume_step = self._midepoch_start(
            start_from, tx, start_epoch, False, len(batches))
        state = TrainState.create(self.tree["params"], tx,
                                  model_state=self.tree["model_state"])
        # the step count seeds each step's sampling draws: a resumed run
        # goes on from where the finished epochs (or the resume point)
        # left it
        state = state.replace(step=(start_epoch - 1) * len(batches)
                              if resume_step is None else resume_step)

        cnn_ft_enabled = False
        for epoch in range(start_epoch, num_epochs + 1):
            if (epoch > tc.lr_opts.cnn_finetune_start
                    and self.cfg.uses_cnn):
                cnn_ft_enabled = True
            lr, cnn_lr = tc.lr_opts.lrs_for_epoch(
                epoch, self.cfg.uses_cnn, cnn_ft_enabled)
            ss_prob = tc.ss_opts.prob_for_epoch(epoch)
            step_fn = get_step(self.cfg.uses_cnn and not cnn_ft_enabled,
                               ss_prob > 0.0)
            self._log(f"— epoch {epoch}: lr={lr:.6f} cnn_ft_lr={cnn_lr:.6f} "
                      f"ss_prob={ss_prob:.2f}")
            if resume_opt is not None and epoch == start_epoch:
                # resumed mid-epoch: the saved moments replace the epoch's
                # fresh optimizer
                state = state.replace(opt_state=resume_opt)
                resume_opt = None
            else:
                # fresh optimizer each epoch (reference Engine.py:135-138)
                state = state.reset_optimizer(tx)
            skip = resume_skip if epoch == start_epoch else 0
            t0 = time.perf_counter()
            t_work = None             # stamped after step 1 (kernel builds)
            n_steps = skip            # the position within the epoch
            n_exec = 0
            self.epoch_losses = []
            monitor = self._monitor(
                Prefetcher(functools.partial(batches.epoch,
                                             epoch_index=epoch,
                                             skip_batches=skip)).epoch(),
                len(batches) - skip, f"XE epoch {epoch}")
            # loss readback lags 2 steps, so the host does not wait for the
            # device every step
            pending: List = []
            for batch in monitor:
                batch = shard_batch(self.mesh, batch)
                state, metrics = step_fn(state, batch, self._gen,
                                         ss_prob, lr, cnn_lr)
                if t_work is None:
                    sync(self.device)
                    t_work = time.perf_counter()
                n_steps += 1
                n_exec += 1
                self._profile_window(n_exec)
                if (mid_on and n_steps % tc.midepoch_save_steps == 0
                        and n_steps < len(batches)):
                    self._save_midepoch(state, epoch, n_steps, scst=False,
                                        n_batches=len(batches))
                pending.append(metrics["loss"])
                if len(pending) > 2:
                    loss = float(pending.pop(0))
                    self.epoch_losses.append(loss)
                    if hasattr(monitor, "set_postfix"):
                        monitor.set_postfix(Loss=round(loss, 4))
            self.epoch_losses += [float(x) for x in pending]
            loss_sum = sum(self.epoch_losses)
            self._profile_close()
            sync(self.device)
            dt = time.perf_counter() - t0
            rate = self._epoch_rate(n_exec, t0, t_work)
            self.last_epoch = {"steps": n_exec, "seconds": dt,
                               "steps_per_sec": rate}
            self._log(f"  {n_exec} steps in {dt:.1f}s "
                      f"({rate:.2f} steps/sec, first step excluded), "
                      f"mean loss {loss_sum / max(n_exec, 1):.4f}")
            self.last_state = state
            self.tree = {"params": state.params,
                         "model_state": state.model_state}
            cider = self._score_val(eval_beam_size)
            cider_scores.append(cider)
            self._log_metrics({"phase": "xe", "epoch": epoch,
                               "mean_loss": loss_sum / max(n_exec, 1),
                               "steps_per_sec": rate,
                               "lr": lr, "cnn_lr": cnn_lr,
                               "ss_prob": ss_prob, "val_cider": cider})
            if self._save_epoch(cider, best_cider, history_best,
                                cider_scores, scst=False, mid_on=mid_on):
                best_cider, best_epoch = cider, epoch
        self._log("Model of best epoch #:%d with CIDEr score %.3f"
                  % (best_epoch, best_cider))
        return cider_scores

    def scst_training(self, start_from: str = "scratch",
                      num_epochs: Optional[int] = None,
                      eval_beam_size: int = -1,
                      idf_cache: Optional[str] = None) -> List[float]:
        """SCST self-critical fine-tune (reference Engine.py:191-249).
        Every way out joins the mid-epoch save in flight, as
        :meth:`training`'s."""
        try:
            out = self._scst_training_impl(start_from, num_epochs,
                                           eval_beam_size, idf_cache)
        except BaseException:
            self._midepoch_join(raise_error=False)
            raise
        self._midepoch_join()
        return out

    def _scst_training_impl(self, start_from: str,
                            num_epochs: Optional[int], eval_beam_size: int,
                            idf_cache: Optional[str]) -> List[float]:
        tc = self.train_cfg
        num_epochs = num_epochs or tc.scst_num_epochs
        history_best = self.ckpt.history_best(scst=True)
        self._log("history best scst_cider on val: %.3f" % history_best)
        cider_scores: List[float] = []
        start_epoch = 1
        if start_from == "checkpoint":
            cider_scores, start_epoch = self._load_into_tree(
                scst=True, best=False, tag="SCST resume")
        else:
            self._log("loading best XE checkpoint before SCST...")
            self._load_into_tree(scst=False, best=True,
                                 tag="best-XE load before SCST")
        best_cider = max(cider_scores) if cider_scores else 0.0
        best_epoch = (cider_scores.index(best_cider) + 1) if cider_scores else 0

        capdata = self._capdata("train")
        reward_vocab = RewardVocab(self.vocab)
        table = self._cider_table(capdata, reward_vocab, idf_cache)
        table_dev = table.device_arrays(self.device)

        batches = CaptionTrainSCSTBatches(capdata, reward_vocab,
                                          self._visual_source(),
                                          tc.scst_train_batch_size,
                                          num_refs=tc.scst_num_refs,
                                          max_ref_len=tc.scst_max_ref_len,
                                          seed=tc.seed,
                                          process_index=process_index(),
                                          process_count=process_count())
        # the references' tf-idf norms are fixed per image: one device pass
        # here removes every reference idf lookup from the per-step reward
        # (ops/cider.py:ref_norms_device)
        t_norm = time.perf_counter()

        def norms(ids, lens):
            with torch.no_grad():
                return ops_cider.ref_norms_device(
                    table_dev, table.probe,
                    to_device(ids, self.device),
                    to_device(lens, self.device)).cpu().numpy()
        batches.precompute_ref_norms(norms)
        self._log("precomputed SCST ref norms for %d images in %.1fs"
                  % (len(batches.img_ids), time.perf_counter() - t_norm))
        tx = make_grad_transform(tc.optimizer, tc.scst_grad_clip)
        labels = self.model.param_labels(self.tree["params"])
        step_fn = S.make_scst_train_step(self.model, tx, labels, table_dev,
                                         table.probe, tc.decode_max_len,
                                         compute_dtype=self._train_dtype(),
                                         device=self.device)
        mid_on = self._midepoch_enabled()
        resume_opt, resume_skip, resume_step = self._midepoch_start(
            start_from, tx, start_epoch, True, len(batches))
        # SCST keeps ONE optimizer across epochs (Engine.py:211-217), so
        # the moments of a resume point simply replace the fresh ones
        state = TrainState.create(self.tree["params"], tx,
                                  model_state=self.tree["model_state"])
        state = state.replace(step=(start_epoch - 1) * len(batches)
                              if resume_step is None else resume_step)
        if resume_opt is not None:
            state = state.replace(opt_state=resume_opt)
        lr = tc.scst_learning_rate
        # SCST always finetunes the CNN (reference intent, Engine.py:208-209)
        cnn_lr = (tc.scst_cnn_finetune_learning_rate
                  if self.cfg.uses_cnn else 0.0)

        for epoch in range(start_epoch, num_epochs + 1):
            self._log(f"— SCST epoch {epoch}: lr={lr:.6f} "
                      f"cnn_ft_lr={cnn_lr:.6f}")
            skip = resume_skip if epoch == start_epoch else 0
            t0 = time.perf_counter()
            t_work = None
            n_steps = skip
            n_exec = 0
            self.epoch_rewards = []
            monitor = self._monitor(
                Prefetcher(functools.partial(batches.epoch,
                                             epoch_index=epoch,
                                             skip_batches=skip)).epoch(),
                len(batches) - skip, f"SCST epoch {epoch}")
            pending: List = []        # lagged readback (see the XE loop)
            for batch in monitor:
                batch = shard_batch(self.mesh, batch)
                state, metrics = step_fn(state, batch, self._gen, lr, cnn_lr)
                if t_work is None:
                    sync(self.device)
                    t_work = time.perf_counter()
                n_steps += 1
                n_exec += 1
                self._profile_window(n_exec)
                if (mid_on and n_steps % tc.midepoch_save_steps == 0
                        and n_steps < len(batches)):
                    self._save_midepoch(state, epoch, n_steps, scst=True,
                                        n_batches=len(batches))
                pending.append(metrics["reward"])
                if len(pending) > 2:
                    reward = float(pending.pop(0))
                    self.epoch_rewards.append(reward)
                    if hasattr(monitor, "set_postfix"):
                        monitor.set_postfix(Reward=round(reward, 4))
            self.epoch_rewards += [float(x) for x in pending]
            reward_sum = sum(self.epoch_rewards)
            self._profile_close()
            sync(self.device)
            dt = time.perf_counter() - t0
            rate = self._epoch_rate(n_exec, t0, t_work)
            self.last_epoch = {"steps": n_exec, "seconds": dt,
                               "steps_per_sec": rate}
            self._log(f"  {n_exec} SCST steps in {dt:.1f}s "
                      f"({rate:.2f} steps/sec, first step excluded), "
                      f"mean reward {reward_sum / max(n_exec, 1):.4f}")
            self.last_state = state
            self.tree = {"params": state.params,
                         "model_state": state.model_state}
            cider = self._score_val(eval_beam_size)
            cider_scores.append(cider)
            self._log_metrics({"phase": "scst", "epoch": epoch,
                               "mean_reward": reward_sum / max(n_exec, 1),
                               "scst_steps_per_sec": rate,
                               "val_cider": cider})
            if self._save_epoch(cider, best_cider, history_best,
                                cider_scores, scst=True, mid_on=mid_on):
                best_cider, best_epoch = cider, epoch
        self._log("Best SCST epoch #:%d CIDEr %.3f" % (best_epoch, best_cider))
        return cider_scores

    def _midepoch_start(self, start_from: str, tx, start_epoch: int,
                        scst: bool, n_batches: int):
        """-> (opt_state or None, skip_batches, step or None): a resumed
        run's resume point (:meth:`_try_resume_midepoch`); a run from
        scratch clears a stale one first."""
        if not self._midepoch_enabled():
            return None, 0, None
        if start_from == "checkpoint":
            return self._try_resume_midepoch(tx, start_epoch, scst=scst,
                                             n_batches=n_batches)
        if self._is_writer:
            self.ckpt.clear_midepoch(scst=scst)
        barrier("%s_clear_midepoch" % ("scst" if scst else "xe"))
        return None, 0, None

    def _cider_table(self, capdata: CaptionData, reward_vocab: RewardVocab,
                     cache: Optional[str]) -> CiderDTable:
        """Train-split idf table for the on-device reward.  Built once from
        the modified annotations (same document frequencies as the
        reference's PreProcess/CIDEr_idf_preproccess.py pickle) and cached
        in an npz that the JAX package reads too (and writes: the keys and
        ``hash_version`` are its)."""
        if cache and os.path.exists(cache):
            try:
                z = np.load(cache)
                if ("hash_version" in z
                        and int(z["hash_version"]) == ops_cider.HASH_VERSION):
                    return CiderDTable(z["h1"], z["h2"], z["df"],
                                       float(z["log_ref_len"]))
                self._log("idf table cache %s uses hash version %s != %d; "
                          "rebuilding" % (cache,
                                          int(z["hash_version"])
                                          if "hash_version" in z else "<pre-2>",
                                          ops_cider.HASH_VERSION))
            except (OSError, ValueError, KeyError) as e:
                # a truncated or corrupt npz: rebuild it
                self._log("idf table cache %s unreadable (%s: %s); "
                          "rebuilding" % (cache, type(e).__name__, e))
        corpus = ([reward_vocab.encode(s["tokens"]) for s in img["sentences"]]
                  for img in capdata.imgs.values())
        table = CiderDTable.from_ref_corpus(corpus)
        if cache:
            os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
            # atomic publish: np.savez truncates, then writes, and every
            # process of a data-parallel run writes (pids are unique per
            # host only: the process index too)
            tmp = cache + ".tmp.%d.%d" % (process_index(), os.getpid())
            with open(tmp, "wb") as f:
                np.savez(f, h1=table.h1, h2=table.h2, df=table.df,
                         log_ref_len=table.log_ref_len,
                         hash_version=ops_cider.HASH_VERSION)
            os.replace(tmp, cache)
        return table

    # ------------------------------------------------------------------- eval
    def eval(self, split: str = "test", eval_scst: bool = False,
             eval_best: bool = True, eval_beam_size: int = -1,
             output_statics: bool = False) -> float:
        """(reference Engine.py:302-307)"""
        self._load_into_tree(scst=eval_scst, best=eval_best,
                             tag="eval checkpoint load")
        path = self._split_path(split)
        if not path:                      # validate BEFORE decoding the split
            raise ValueError(f"unknown or unconfigured eval split {split!r}")
        self._log(f"— evaluating on {self.data_cfg.dataset_name} {split}")
        results = self.eval_captions_json_generation(split, eval_beam_size)
        t0 = time.perf_counter()
        if output_statics:
            score = coco_eval_specific(results, path)
        else:
            score = coco_eval(results, path)
        self.last_coco_eval_s = time.perf_counter() - t0
        return score
