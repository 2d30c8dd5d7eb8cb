"""Host data layer: fixed-shape batch assembly for XE / SCST / eval.

A copy of the JAX package's ``data/datasets.py``: the same seeds, shuffles,
padding and process partition, so both packages draw the same batches,
array for array.  Reference equivalents: Datasets.py (three map-style
datasets + collates) and the dataloader factories in Utils.py:38-104.
Differences from the reference:

* **Static shapes everywhere.** The reference sorts each batch by caption
  length and packs (Datasets.py:153-162); here captions pad to
  ``max_caption_len`` and the loss masks (identical math, ops/losses.py),
  so every step of an epoch has one shape.  Adaptive bottom-up features pad to a static ``max_bu_len``
  with an always-materialized 0/1 mask (the reference pads to the *batch*
  max and drops the mask when full — BUTD_Engine.py:23-47).
* **Fixed batch count.** The final partial batch is padded up to the batch
  size with repeated items carrying ``sample_weight`` 0.
* **uint8 images.** Host does decode+resize (the native JPEG loader, else
  PIL) and the train-time random horizontal flip; scale/normalize run on
  the device (ops/image.py).
* **SCST references as token ids.** The reference ships gt caption *strings*
  to the scorer per batch (Datasets.py:80-109, Utils.py:336-357); here gts
  are pre-encoded once to RewardVocab ids (ops/cider.py) so the CIDEr-D
  reward is computed on device.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData
from simpleimagecaptionzoo_tpu_torch.vocab import Vocabulary


def image_path(image_root: str, file_name: str, dataset_name: str,
               split: Optional[str] = None) -> str:
    """Per-dataset image directory routing (reference Datasets.py:11-22)."""
    if dataset_name in ("Flickr8K", "Flickr30K"):
        return os.path.join(image_root, file_name)
    if dataset_name == "COCO14":
        sub = "train2014" if "train" in file_name.lower() else "val2014"
        return os.path.join(image_root, sub, file_name)
    if dataset_name == "COCO17":
        return os.path.join(image_root, (split or "train") + "2017", file_name)
    raise ValueError(f"unknown dataset {dataset_name!r}")


def load_image_uint8(path: str, size: int = 224) -> np.ndarray:
    """Decode + resize to (size, size, 3) uint8 (reference transform:
    Resize((224,224)); normalization happens on device).

    JPEGs take the native C++ path when built (libjpeg decode + Pillow-
    parity fixed-point bilinear resample, native/image_loader.cpp — the C
    call releases the GIL so the decode thread pool scales); anything else,
    or when the library is absent, goes through PIL.  With neither, this
    raises ImportError: nothing stands in for the decode."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from simpleimagecaptionzoo_tpu_torch.data import _native_image
        arr = _native_image.decode_jpeg_resize(path, size)
        if arr is not None:
            return arr
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "cannot decode %r: Pillow is not installed and the native JPEG "
            "loader (native/build/libsicz_image.so, `make -C native`) is "
            "absent or refused the file; install Pillow, build the loader, "
            "or pack the images with preprocess/pack_images.py" % path) from e
    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


# static pad box for device-resize ingest: holds any DCT-scaled decode of
# a typical photo (min-dim lands in [size, 2*size); 512 covers aspect
# ratios to ~2.3:1 at size=224 — wider images fall back to host resize)
INGEST_PAD = 512


def ingest_pad(size: int) -> int:
    """Pad-box edge for device-resize ingest at a given ``img_size``.

    INGEST_PAD (512) covers the default 224; a larger ``img_size`` scales
    the box to 2*size rounded up to the 128-lane multiple so the C
    decoder's ``pad >= min_size`` contract always holds and the scaled
    decode (min-dim in [size, 2*size) where possible) always fits."""
    return max(INGEST_PAD, -(-2 * size // 128) * 128)


def load_image_scaled(path: str, size: int, pad: int = 0):
    """FASTEST ingest: DCT-domain scaled JPEG decode, NO host resample —
    returns (padded (pad, pad, 3) uint8, (h, w)); the device finishes with
    the triangle-resample matmul kernel (ops/image.resize_normalize).
    Non-JPEG / unsupported / doesn't-fit images take the host parity path
    and are placed in the pad box as an already-final (size, size) image
    (the device kernel's size==out_size weights are the identity).
    ``pad=0`` (default) selects ``ingest_pad(size)``."""
    from simpleimagecaptionzoo_tpu_torch.data import _native_image
    if pad <= 0:
        pad = ingest_pad(size)
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            data = None
        if data is not None:
            got = _native_image.decode_jpeg_scaled(data, size, pad)
            if got is not None:
                arr, h, w = got
                return arr, (h, w)
    small = load_image_uint8(path, size)
    out = np.empty((pad, pad, 3), np.uint8)
    out[:size, :size] = small
    return out, (size, size)


def load_image_fast(path: str, size: int) -> np.ndarray:
    """FAST ingest: DCT-scaled decode + host Pillow-semantics resample from
    the much smaller scaled image (~2x the parity path's rate); falls back
    to the parity path for non-JPEGs or when the native library is absent."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from simpleimagecaptionzoo_tpu_torch.data import _native_image
        arr = _native_image.decode_jpeg_resize_fast(path, size)
        if arr is not None:
            return arr
    return load_image_uint8(path, size)


_PACKED_CACHE: Dict[tuple, tuple] = {}


def load_packed_shard(shard: str, index: str):
    """Shared packed-shard loader for the bottom-up-feature and image fast
    paths (and the mid-epoch resume fingerprint, engine.py): returns
    ``(memmap, name->row dict, lengths-or-None, meta dict)`` when both the
    ``.npy`` shard and its index json exist, else ``None``.  ``meta`` is the
    index json's identity fields (``image_root``/``dataset``/``size``, when
    recorded by the packer) — callers verify the shard was packed from the
    data they are configured to read.

    Cached per (paths, mtimes): a real dataset's index json is ~120k
    entries, and ``Engine._visual_source`` is reconstructed for every
    train/eval invocation — the parse must not repeat every epoch."""
    if not (os.path.exists(shard) and os.path.exists(index)):
        return None
    key = (os.path.getmtime(shard), os.path.getsize(shard),
           os.path.getmtime(index))
    hit = _PACKED_CACHE.get((shard, index))
    if hit is not None and hit[0] == key:
        return hit[1]
    import json
    with open(index) as f:
        idx = json.load(f)
    val = (np.load(shard, mmap_mode="r"),
           {name: i for i, name in enumerate(idx["order"])},
           idx.get("lengths"),
           {k: v for k, v in idx.items() if k not in ("order", "lengths")})
    _PACKED_CACHE[(shard, index)] = (key, val)
    return val


def packed_image_paths(packed_dir: str, img_size: int = 224):
    return (os.path.join(packed_dir, f"images_{img_size}_packed.npy"),
            os.path.join(packed_dir, f"images_{img_size}_index.json"))


def packed_images_for(packed_dir: str, dataset_name: str, image_root: str,
                      img_size: int = 224):
    """(memmap, name->row dict) when the packed-image fast path will engage
    for this dataset/image_root — shard + index exist AND the index's
    recorded identity matches — else ``None``.  The single predicate shared
    by ``_VisualSource`` and the mid-epoch resume fingerprint
    (engine._midepoch_env) so they can never disagree.

    Identity check: the index records what the shard was packed FROM
    (pack_images.py); a shard packed from a different dataset or image_root
    whose file names overlap would otherwise silently substitute wrong
    pixels."""
    loaded = load_packed_shard(*packed_image_paths(packed_dir, img_size))
    if loaded is None:
        return None
    shard_arr, rows, _, meta = loaded
    mismatch = [f"{k}: shard={meta[k]!r} configured={want!r}"
                for k, want in (("dataset", dataset_name),
                                ("image_root", os.path.abspath(image_root)))
                if k in meta and meta[k] != want]
    if mismatch:
        import warnings
        warnings.warn(
            "packed image shard in %r was packed from different data (%s); "
            "IGNORING the fast path and decoding JPEGs — repack with "
            "preprocess/pack_images.py" % (packed_dir, "; ".join(mismatch)))
        return None
    return shard_arr, rows


def packed_images_available(packed_dir: str, dataset_name: str,
                            image_root: str, img_size: int = 224) -> bool:
    """True iff the packed-image fast path will actually engage — the
    predicate `_VisualSource` uses (shard AND index AND identity), so the resume
    fingerprint can't diverge from the loader's real behavior."""
    return packed_images_for(packed_dir, dataset_name, image_root,
                             img_size) is not None


class SuppFeatureLoader:
    """Per-image bottom-up feature loader ('fixed' 36-box or 'adaptive'
    10..100-box .npz/.npy files; reference Datasets.py:55-62).

    Fast path: when ``preprocess/generate_bottom_up_features.py --operation
    pack`` has produced ``<mode>_bu_feats_packed.npy`` +
    ``<mode>_bu_index.json``, features are read from one memory-mapped shard
    (no per-image npz decompression — the zlib inflate of npz files is the
    host-side bottleneck at accelerator ingest rates, SURVEY.md §2a #21)."""

    def __init__(self, supp_dir: str, mode: str, max_bu_len: int) -> None:
        assert mode in ("fixed", "adaptive")
        self.supp_dir = supp_dir
        self.mode = mode
        self.max_bu_len = max_bu_len
        self._packed = None
        loaded = load_packed_shard(
            os.path.join(supp_dir, f"{mode}_bu_feats_packed.npy"),
            os.path.join(supp_dir, f"{mode}_bu_index.json"))
        if loaded is not None:
            shard_arr = loaded[0]
            if shard_arr.shape[1] < max_bu_len:
                # pack() clips every image to the shard width and records
                # the CLIPPED length, so a 36-wide shard cannot serve an
                # adaptive (up to 100-box) run — rows would silently lose
                # boxes vs the per-image npz path
                import warnings
                warnings.warn(
                    "packed bu shard in %r holds %d boxes/image but this "
                    "run is configured for max_bu_len=%d; IGNORING the "
                    "fast path and reading per-image npz files — repack "
                    "with preprocess/generate_bottom_up_features.py "
                    "--operation pack --max_len %d"
                    % (supp_dir, shard_arr.shape[1], max_bu_len, max_bu_len))
            else:
                self._packed, self._row, self._len, _ = loaded

    def load(self, img_id) -> Dict[str, np.ndarray]:
        key = str(img_id)
        if self._packed is not None and key in self._row:
            row = self._packed[self._row[key]]
            n = min(int(self._len[key]), self.max_bu_len)
            out = np.zeros((self.max_bu_len, row.shape[1]), np.float32)
            out[:n] = row[:n]
        else:
            feat = np.load(os.path.join(
                self.supp_dir, f"{self.mode}_bu_feat/{img_id}.npz"))["feat"]
            n = min(feat.shape[0], self.max_bu_len)
            out = np.zeros((self.max_bu_len, feat.shape[1]), np.float32)
            out[:n] = feat[:n]
        mask = np.zeros((self.max_bu_len,), np.float32)
        mask[:n] = 1.0
        return {"bu_feats": out, "bu_masks": mask}

    def load_bbox(self, img_id) -> np.ndarray:
        return np.load(os.path.join(
            self.supp_dir, f"{self.mode}_bu_bbox/{img_id}.npy"))


class _VisualSource:
    """Assembles the per-item visual dict: images and/or bu features.

    Fast path for pixels: when ``preprocess/pack_images.py`` has produced
    ``images_<size>_packed.npy`` + ``images_<size>_index.json`` in
    ``packed_dir``, images come from one uint8 memmap row (a ~150 KB
    memcpy) instead of a JPEG decode + resample: a host core decodes tens
    of images a second, far fewer than the from-pixels trainer consumes,
    so on real datasets this cache is what keeps the CNN path fed."""

    def __init__(self, dataset_name: str, image_root: str,
                 needs_images: bool, supp: Optional[SuppFeatureLoader],
                 img_size: int = 224,
                 packed_dir: Optional[str] = None,
                 ingest: str = "parity") -> None:
        if ingest not in ("parity", "fast", "device"):
            raise ValueError(f"unknown image ingest mode {ingest!r}")
        self.dataset_name = dataset_name
        self.image_root = image_root
        self.needs_images = needs_images
        self.supp = supp
        self.img_size = img_size
        self.ingest = ingest
        self._packed_imgs = None
        if needs_images and packed_dir:
            loaded = packed_images_for(packed_dir, dataset_name, image_root,
                                       img_size)
            if loaded is not None:
                self._packed_imgs, self._img_row = loaded

    _pool = None

    def item(self, img_entry: dict, split: str, flip: bool) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if self.needs_images:
            name = img_entry["file_name"]
            if (self._packed_imgs is not None and name in self._img_row):
                img = np.asarray(self._packed_imgs[self._img_row[name]])
                if flip:
                    img = img[:, ::-1, :]
                if self.ingest == "device":
                    # device ingest emits (pad, pad, 3)+img_hw items; a
                    # packed row must ship in the same format or a shard
                    # that covers only part of the split would mix shapes
                    # inside one batch and crash _stack_visuals.  The
                    # packed row is already final (size, size): top-left
                    # placement + identity device weights reproduce it
                    # bit-exactly.
                    s = img.shape[0]
                    box = np.zeros((ingest_pad(self.img_size),) * 2 + (3,),
                                   np.uint8)
                    box[:s, :s] = img
                    img = box
                    out["img_hw"] = np.asarray((s, s), np.int32)
            elif self.ingest == "device":
                path = image_path(self.image_root, name,
                                  self.dataset_name, split)
                img, (h, w) = load_image_scaled(path, self.img_size)
                if flip:
                    # flip only the valid region: content stays top-left
                    # in the pad box (the device weights mask the rest)
                    img[:h, :w] = img[:h, w - 1::-1].copy()
                out["img_hw"] = np.asarray((h, w), np.int32)
            else:
                loader = (load_image_fast if self.ingest == "fast"
                          else load_image_uint8)
                img = loader(image_path(self.image_root, name,
                                        self.dataset_name, split),
                             self.img_size)
                if flip:
                    img = img[:, ::-1, :]
            out["img_tensors"] = img
        if self.supp is not None:
            out.update(self.supp.load(img_entry["id"]))
        return out

    def items(self, entries: List[dict], split: str,
              flips: List[bool]) -> List[Dict[str, np.ndarray]]:
        """Batch assembly over a shared thread pool (replaces the
        reference's 4 DataLoader worker *processes* — threads suffice since
        PIL decode releases the GIL)."""
        if _VisualSource._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _VisualSource._pool = ThreadPoolExecutor(max_workers=8)
        return list(_VisualSource._pool.map(
            lambda ef: self.item(ef[0], split, ef[1]), zip(entries, flips)))


def _stack_visuals(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = items[0].keys()
    return {k: np.stack([it[k] for it in items]) for k in keys}


def _pad_cycle(indices, target: int):
    """Pad an index list to ``target`` by cycling (weight-0 filler rows for
    the static final batch; safe even when the split is tiny)."""
    out = list(indices)
    i = 0
    while len(out) < target:
        out.append(out[i % len(out)])
        i += 1
    return out


class _ProcessShard:
    """Per-process slice of every global batch (multi-host/DCN feeding,
    SURVEY.md §2c).

    Every process walks the SAME epoch order (identical seeds) and
    materializes only rows ``[index*B/P, (index+1)*B/P)`` of each global
    batch: the engine of a data-parallel run passes its process's index
    and the process count (``parallel``), one process the plain path; its
    batches equal the JAX package's per process."""

    def __init__(self, batch_size: int, index: int = 0, count: int = 1):
        if count < 1 or not (0 <= index < count):
            raise ValueError(f"bad process shard {index}/{count}")
        if batch_size % count:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"process_count {count}")
        per = batch_size // count
        self.lo, self.hi = index * per, (index + 1) * per

    def take(self, rows):
        return rows[self.lo:self.hi]


class CaptionTrainBatches:
    """Per-annotation XE training batches (reference CaptionTrainDataset,
    Datasets.py:26-68 + COCOCaptionTrain_collate_fn :153-162).

    Yields dicts: visual, captions (B, max_caption_len) int32 with <sta>/
    <end>, lengths (B,), sample_weight (B,).  Epoch order is shuffled by
    ``rng``; captions longer than the static budget are tail-truncated
    (the <end> token is kept)."""

    def __init__(self, capdata: CaptionData, vocab: Vocabulary,
                 visual_source: _VisualSource, batch_size: int,
                 max_caption_len: int = 22, flip: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.capdata = capdata
        self.vocab = vocab
        self.vs = visual_source
        self.batch_size = batch_size
        self.max_caption_len = max_caption_len
        self.flip = flip
        self.shard = _ProcessShard(batch_size, process_index, process_count)
        self.ann_ids = list(capdata.anns.keys())
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # truncation audit: the static caption budget silently clips long
        # captions (docs/PARITY.md #4) — make the divergence measurable.
        self.n_truncated = sum(
            1 for a in capdata.anns.values()
            if len(a["tokens"]) + 2 > max_caption_len)   # +<sta>/+<end>
        if self.ann_ids:
            frac = self.n_truncated / len(self.ann_ids)
            if self.n_truncated:
                print(f"CaptionTrainBatches: {self.n_truncated}/"
                      f"{len(self.ann_ids)} train captions "
                      f"({frac:.2%}) exceed max_caption_len="
                      f"{max_caption_len} and will be tail-truncated",
                      flush=True)

    def __len__(self) -> int:
        return (len(self.ann_ids) + self.batch_size - 1) // self.batch_size

    def _encode(self, tokens: Sequence[str]) -> np.ndarray:
        ids = self.vocab.encode_tokens(tokens)
        if len(ids) > self.max_caption_len:
            ids = ids[:self.max_caption_len - 1] + [ids[-1]]
        out = np.zeros((self.max_caption_len,), np.int32)
        out[:len(ids)] = ids
        return out, len(ids)

    def _assemble(self, ann_ids: List, weights: np.ndarray,
                  flips: List[bool]) -> dict:
        anns = [self.capdata.anns[a] for a in ann_ids]
        entries = [self.capdata.imgs[a["image_id"]] for a in anns]
        visuals = self.vs.items(entries, "train", flips)
        caps, lens = [], []
        for ann in anns:
            c, l = self._encode(ann["tokens"])
            caps.append(c)
            lens.append(l)
        return {"visual": _stack_visuals(visuals),
                "captions": np.stack(caps),
                "lengths": np.asarray(lens, np.int32),
                "sample_weight": weights}

    def epoch(self, epoch_index: Optional[int] = None,
              skip_batches: int = 0):
        # identical rng stream on every process (same seed) -> identical
        # global order + flips; each process materializes only its slice.
        # With epoch_index the stream derives from (seed, epoch_index) so
        # epoch k's order is reproducible in isolation — the contract the
        # mid-epoch resume path relies on (skip_batches skips assembly, the
        # expensive part, but still draws the skipped batches' flips so the
        # remaining stream is identical to an uninterrupted epoch).
        rng = (np.random.default_rng([self.seed, epoch_index])
               if epoch_index is not None else self.rng)
        order = rng.permutation(len(self.ann_ids))
        bs = self.batch_size
        for bi, i in enumerate(range(0, len(order), bs)):
            idx = list(order[i:i + bs])
            n_real = len(idx)
            if n_real < bs:   # pad final batch (weight 0) for static shapes
                idx = _pad_cycle(idx, bs)
            flips = [self.flip and bool(rng.integers(2)) for _ in idx]
            if bi < skip_batches:
                continue
            w = np.zeros((bs,), np.float32)
            w[:n_real] = 1.0
            yield self._assemble(
                self.shard.take([self.ann_ids[j] for j in idx]),
                self.shard.take(w), self.shard.take(flips))


class CaptionTrainSCSTBatches:
    """Per-image SCST batches (reference CaptionTrainSCSTDataset,
    Datasets.py:70-113): visual inputs + ground-truth references encoded to
    RewardVocab token ids, padded (R, max_ref_len)."""

    def __init__(self, capdata: CaptionData, reward_vocab,
                 visual_source: _VisualSource, batch_size: int,
                 num_refs: int = 5, max_ref_len: int = 32, flip: bool = True,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.capdata = capdata
        self.vs = visual_source
        self.batch_size = batch_size
        self.num_refs = num_refs
        self.max_ref_len = max_ref_len
        self.flip = flip
        self.shard = _ProcessShard(batch_size, process_index, process_count)
        self.img_ids = list(capdata.imgs.keys())
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        # pre-encode every image's references ONCE (host, at construction)
        self._refs: dict = {}
        for img_id in self.img_ids:
            sents = capdata.imgs[img_id]["sentences"][:num_refs]
            ids = np.zeros((num_refs, max_ref_len), np.int32)
            lens = np.zeros((num_refs,), np.int32)
            for r, sent in enumerate(sents):
                enc = reward_vocab.encode(sent["tokens"])[:max_ref_len]
                ids[r, :len(enc)] = enc
                lens[r] = len(enc)
            self._refs[img_id] = (ids, lens)
        self._ref_norms: Optional[dict] = None

    def precompute_ref_norms(self, norms_fn, chunk: int = 512) -> None:
        """Precompute per-reference CIDEr-D vector norms for every image.

        ``norms_fn(ids (N,R,Lr) int32, lens (N,R) int32) -> (N,R,4) f32`` —
        typically an ops.cider.ref_norms_device closure.  Called in
        fixed-size chunks (last one padded), so every call has one shape.
        Afterwards every batch carries ``ref_norms`` and the SCST step skips
        all ref-side idf table gathers (ops/cider.py:ref_norms_device)."""
        ids = np.stack([self._refs[g][0] for g in self.img_ids])
        lens = np.stack([self._refs[g][1] for g in self.img_ids])
        n = len(self.img_ids)
        out = np.zeros((n, self.num_refs, 4), np.float32)
        for i in range(0, n, chunk):
            j = min(i + chunk, n)
            cid = np.zeros((chunk,) + ids.shape[1:], np.int32)
            cln = np.zeros((chunk,) + lens.shape[1:], np.int32)
            cid[:j - i] = ids[i:j]
            cln[:j - i] = lens[i:j]
            out[i:j] = np.asarray(norms_fn(cid, cln))[:j - i]
        self._ref_norms = {g: out[k] for k, g in enumerate(self.img_ids)}

    def __len__(self) -> int:
        return (len(self.img_ids) + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch_index: Optional[int] = None,
              skip_batches: int = 0):
        # see CaptionTrainBatches.epoch for the (seed, epoch_index) /
        # skip_batches resume contract
        rng = (np.random.default_rng([self.seed, epoch_index])
               if epoch_index is not None else self.rng)
        order = rng.permutation(len(self.img_ids))
        bs = self.batch_size
        for bi, i in enumerate(range(0, len(order), bs)):
            idx = list(order[i:i + bs])
            n_real = len(idx)
            if n_real < bs:
                idx = _pad_cycle(idx, bs)
            flips = [self.flip and bool(rng.integers(2)) for _ in idx]
            if bi < skip_batches:
                continue
            w = np.zeros((bs,), np.float32)
            w[:n_real] = 1.0
            img_ids = self.shard.take([self.img_ids[j] for j in idx])
            visuals = self.vs.items(
                [self.capdata.imgs[g] for g in img_ids], "train",
                self.shard.take(flips))
            rids = [self._refs[g][0] for g in img_ids]
            rlens = [self._refs[g][1] for g in img_ids]
            batch = {"visual": _stack_visuals(visuals),
                     "ref_ids": np.stack(rids),
                     "ref_lens": np.stack(rlens),
                     "sample_weight": self.shard.take(w)}
            if self._ref_norms is not None:
                batch["ref_norms"] = np.stack(
                    [self._ref_norms[g] for g in img_ids])
            yield batch


class CaptionEvalBatches:
    """Per-image eval batches (reference CaptionEvalDataset,
    Datasets.py:115-151): visual inputs + image ids; deterministic order.
    Unlike the reference, beam search does NOT force batch size 1
    (Utils.py:72-74) — the decode engine is batched."""

    def __init__(self, capdata: CaptionData, visual_source: _VisualSource,
                 batch_size: int, split: str, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.capdata = capdata
        self.vs = visual_source
        self.batch_size = batch_size
        self.split = split
        self.shard = _ProcessShard(batch_size, process_index, process_count)
        self.img_ids = list(capdata.imgs.keys())

    def __len__(self) -> int:
        return (len(self.img_ids) + self.batch_size - 1) // self.batch_size

    def epoch(self):
        bs = self.batch_size
        for i in range(0, len(self.img_ids), bs):
            ids = self.img_ids[i:i + bs]
            n_real = len(ids)
            if n_real < bs:
                ids = _pad_cycle(ids, bs)
            global_ids = list(ids)
            ids = self.shard.take(global_ids)
            visuals = self.vs.items([self.capdata.imgs[g] for g in ids],
                                    self.split, [False] * len(ids))
            # n_real counts this process's real rows (global row j is real
            # iff j < global n_real)
            local_real = int(np.clip(n_real - self.shard.lo, 0,
                                     self.shard.hi - self.shard.lo))
            # global_* fields are identical on every process (derived from
            # the shared capdata order) — the eval drain uses them instead
            # of all-gathering the local fields per batch (engine.py)
            yield {"visual": _stack_visuals(visuals),
                   "img_ids": ids,
                   "n_real": local_real,
                   "global_img_ids": global_ids,
                   "global_n_real": n_real}
