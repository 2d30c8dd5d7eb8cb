"""Mid-epoch crash tolerance (the JAX package's ``engine/midepoch.py``).

The reference loses the epoch in flight on a crash.  With
``--midepoch_save_steps N > 0`` the training loops save a step-level resume
point every N steps, and ``training(start_from='checkpoint')`` (or
``scst_training``) continues from it bit-identically to an uninterrupted
run: the params, model_state and the optimizer's moments, the step count
that seeds each step's draws (``steps.draw_generator_for``), the state of
the engine's generator (the dropout stream), and the batches already taken
(skipped on resume, ``skip_batches`` of the batchers).  Mixin methods expect
the Engine attributes ``train_cfg`` / ``data_cfg`` / ``ckpt`` / ``tree`` /
``_gen`` / ``device`` / ``midepoch_saves`` (a list) plus ``_place`` /
``_log`` / ``_is_writer``.
"""
from __future__ import annotations

import threading
import time
import zlib

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch.data import datasets as datasets_mod
from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_map
from simpleimagecaptionzoo_tpu_torch.parallel import (barrier, process_count,
                                                      processes_agree)

# the writer of a resume point: a point of the JAX package (whose random
# streams differ) is discarded as a configuration mismatch is
PACKAGE = "simpleimagecaptionzoo_tpu_torch"


def _clone(t):
    return t.detach().clone() if isinstance(t, torch.Tensor) else t


def _host(t):
    return t.cpu() if isinstance(t, torch.Tensor) else t


class MidEpochMixin:
    _midepoch_thread = None
    _midepoch_error = None

    def _midepoch_enabled(self) -> bool:
        return self.train_cfg.midepoch_save_steps > 0

    def _midepoch_env(self, scst: bool, n_batches: int) -> dict:
        """The run's fingerprint, recorded with every resume point and
        checked at resume: the saved generator state and the skipped
        batches reproduce the interrupted epoch only under the same
        package, batch size, seed, epoch length and image decoder, so a
        mismatch discards the point instead of continuing on the wrong
        batches."""
        from simpleimagecaptionzoo_tpu_torch.data import _native_image
        tc = self.train_cfg
        return {"package": PACKAGE,
                "batch_size": int(tc.scst_train_batch_size if scst
                                  else tc.train_batch_size),
                "seed": int(tc.seed), "n_batches": int(n_batches),
                "img_size": int(tc.img_size),
                "image_ingest": str(tc.image_ingest),
                "native_loader": bool(_native_image.available()),
                "packed_images": datasets_mod.packed_images_available(
                    self.data_cfg.data_dir, self.data_cfg.dataset_name,
                    self.data_cfg.image_root, img_size=tc.img_size)}

    def _save_midepoch(self, state, epoch: int, steps_done: int,
                       scst: bool, n_batches: int = -1) -> None:
        """Asynchronous with one process: the state is copied on the device
        (the loop goes on replacing its tensors), then a background thread
        copies the copy to the host and writes it atomically while the
        training goes on.  At most one save is in flight; epoch ends and
        exceptions join it (:meth:`_midepoch_join`), so an interrupt leaves
        the newest completed resume point on disk, and a failed save is
        raised at the next join.

        With several processes the save is synchronous: process 0 writes,
        and the barrier after the meta's rename is the collective commit
        point (every process resumes from this point or none does).

        Appends ``{"epoch", "steps_done", "loop_ms", "background_ms",
        "bytes"}`` to ``self.midepoch_saves`` (the background fields once
        the write has finished)."""
        self._midepoch_join()
        t0 = time.perf_counter()
        snap = tree_map(_clone, {"params": state.params,
                                 "model_state": state.model_state,
                                 "opt_state": state.opt_state})
        meta = {"epoch": int(epoch), "steps_done": int(steps_done),
                "step": int(state.step),
                "rng": self._gen.get_state().tolist(),
                **self._midepoch_env(scst, n_batches)}
        record = {"epoch": int(epoch), "steps_done": int(steps_done)}
        self.midepoch_saves.append(record)

        if process_count() > 1:
            if self._is_writer:
                record["bytes"] = self.ckpt.save_midepoch(
                    tree_map(_host, snap), meta, scst=scst)
            barrier("midepoch_save_commit")
            record["loop_ms"] = (time.perf_counter() - t0) * 1e3
            record["background_ms"] = 0.0
            return

        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()

        def write():
            t1 = time.perf_counter()
            try:
                if ready is not None:
                    ready.synchronize()         # the copy is complete
                    # the pull on a stream of its own, so that it does not
                    # queue behind the steps launched since
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(torch.cuda.Stream()):
                        host = tree_map(_host, snap)
                else:
                    host = snap
                record["bytes"] = self.ckpt.save_midepoch(host, meta,
                                                          scst=scst)
                record["background_ms"] = (time.perf_counter() - t1) * 1e3
            except BaseException as e:          # raised by _midepoch_join
                self._midepoch_error = e

        self._midepoch_thread = threading.Thread(target=write, daemon=False)
        self._midepoch_thread.start()
        record["loop_ms"] = (time.perf_counter() - t0) * 1e3

    def _midepoch_join(self, raise_error: bool = True) -> None:
        """Wait for the save in flight.  A failed one is raised (or, when
        another exception is already on its way, ``raise_error=False``,
        logged) so that crash tolerance never degrades into a silent
        no-op."""
        t = self._midepoch_thread
        if t is not None and t.is_alive():
            t.join()
        self._midepoch_thread = None
        err, self._midepoch_error = self._midepoch_error, None
        if err is None:
            return
        msg = ("the asynchronous mid-epoch checkpoint save failed; a crash "
               "before the next successful save loses this epoch's "
               "progress: %r" % (err,))
        if raise_error:
            raise RuntimeError(msg) from err
        print("ERROR: " + msg, flush=True)

    def _discard_reason(self, meta: dict, scst: bool, n_batches: int):
        if meta.get("package") != PACKAGE:
            return ("it was written by %s, whose random streams differ"
                    % (meta.get("package") or "the JAX package"))
        for key, expect in self._midepoch_env(scst, n_batches).items():
            got = meta.get(key, expect)
            if got != expect:
                return ("saved %s=%r but this run has %s=%r"
                        % (key, got, key, expect))
        return None

    def _try_resume_midepoch(self, tx, start_epoch: int, scst: bool,
                             n_batches: int = -1):
        """-> (opt_state or None, skip_batches, step count or None).  On a
        hit, ``self.tree`` and the engine's generator are restored to the
        resume point."""
        meta = self.ckpt.midepoch_meta(scst=scst)
        tree = None
        found = (meta is not None
                 and int(meta.get("epoch", -1)) == start_epoch)
        if found:
            why = self._discard_reason(meta, scst, n_batches)
            if why is not None:
                self._log("mid-epoch resume point discarded: %s; resuming "
                          "from the epoch boundary instead" % why)
                found = False
        if found:
            template = {"params": self.tree["params"],
                        "model_state": self.tree["model_state"],
                        "opt_state": tx.init(self.tree["params"])}
            tree, meta = self.ckpt.load_midepoch(template, scst=scst)
            found = tree is not None
        # collective agreement (every process reaches it): all processes
        # restore the same resume point or none does
        if process_count() > 1:
            if found:
                fp = np.asarray([1, int(meta["epoch"]),
                                 int(meta["steps_done"]), int(meta["step"]),
                                 zlib.crc32(bytes(meta["rng"]))], np.int64)
            else:
                fp = np.zeros((5,), np.int64)
            if not processes_agree(fp):
                if found:
                    self._log("mid-epoch resume point discarded: processes "
                              "disagree on its existence or content (is the "
                              "checkpoint directory on a shared "
                              "filesystem?); resuming from the epoch "
                              "boundary instead")
                found = False
        if not found:
            return None, 0, None
        self.tree = {"params": tree["params"],
                     "model_state": tree["model_state"]}
        self._place()
        self._gen.set_state(torch.tensor(meta["rng"], dtype=torch.uint8))
        skip = int(meta["steps_done"])
        self._log(f"mid-epoch resume: epoch {start_epoch}, "
                  f"skipping {skip} completed steps")
        return tree["opt_state"], skip, int(meta["step"])
