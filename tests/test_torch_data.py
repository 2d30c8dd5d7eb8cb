"""The port's data layer (``simpleimagecaptionzoo_tpu_torch.data``) against
the JAX package's: the XE, SCST and eval batchers epoch by epoch (with
``epoch_index``, ``skip_batches`` and a 2-way process partition),
SuppFeatureLoader (fixed and adaptive, per-image npz and packed shard),
packed image shards (parity and device ingest, flips), image_path and the
Prefetcher — every array identical.  Without Pillow and the native loader
the JPEG path raises ImportError."""
import json
import sys

import numpy as np
import pytest

from preprocess.generate_bottom_up_features import pack as pack_bu
from simpleimagecaptionzoo_tpu.data import datasets as jds
from simpleimagecaptionzoo_tpu.data.caption_data import CaptionData as JCD
from simpleimagecaptionzoo_tpu.data.loader import Prefetcher as JPrefetcher
from simpleimagecaptionzoo_tpu.ops.cider import RewardVocab as JRewardVocab
from simpleimagecaptionzoo_tpu.vocab import build_vocab as jbuild_vocab
from simpleimagecaptionzoo_tpu_torch.data import _native_image
from simpleimagecaptionzoo_tpu_torch.data import datasets as tds
from simpleimagecaptionzoo_tpu_torch.data.caption_data import CaptionData as TCD
from simpleimagecaptionzoo_tpu_torch.data.loader import Prefetcher
from simpleimagecaptionzoo_tpu_torch.ops.cider import RewardVocab
from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab

WORDS = ["a", "dog", "man", "runs", "on", "beach", "red", "ball", "with"]
N_IMG = 11


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """11 images x 5 captions of 3-12 words (some past a 9-token budget),
    per-image fixed (3-7 boxes) and adaptive (5-14 boxes) npz features of
    width 8, and a packed shard of the fixed ones."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(N_IMG):
        sents = []
        for s in range(5):
            toks = [WORDS[int(j)] for j in rng.integers(
                0, len(WORDS), rng.integers(3, 13))]
            anns.append({"image_id": 100 + i, "id": i * 5 + s,
                         "caption": " ".join(toks), "tokens": toks,
                         "file_name": "img_%d.jpg" % i})
            sents.append({"tokens": toks, "raw": " ".join(toks)})
        images.append({"id": 100 + i, "file_name": "img_%d.jpg" % i,
                       "sentids": list(range(i * 5, i * 5 + 5)),
                       "sentences": sents})
    for mode, lo, hi in (("fixed", 3, 8), ("adaptive", 5, 15)):
        (root / (mode + "_bu_feat")).mkdir()
        for i in range(N_IMG):
            np.savez(root / (mode + "_bu_feat") / ("%d.npz" % (100 + i)),
                     feat=rng.normal(size=(rng.integers(lo, hi), 8)
                                     ).astype(np.float32))
    packed = root / "packed"
    packed.mkdir()
    (packed / "fixed_bu_feat").symlink_to(root / "fixed_bu_feat")
    pack_bu(str(packed), "fixed", max_len=8)
    path = root / "ann.json"
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return root, str(path)


def _sources(root, mode="fixed", max_bu=8, supp_dir=None):
    d = str(supp_dir or root)
    return (jds._VisualSource("Flickr8K", str(root), False,
                              jds.SuppFeatureLoader(d, mode, max_bu)),
            tds._VisualSource("Flickr8K", str(root), False,
                              tds.SuppFeatureLoader(d, mode, max_bu)))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("image_root,name,ds,split", [
    ("/r", "x.jpg", "Flickr8K", None), ("/r", "x.jpg", "Flickr30K", None),
    ("/r", "COCO_train2014_1.jpg", "COCO14", None),
    ("/r", "COCO_val2014_1.jpg", "COCO14", None),
    ("/r", "1.jpg", "COCO17", "val"), ("/r", "1.jpg", "COCO17", None)])
def test_image_path(image_root, name, ds, split):
    assert tds.image_path(image_root, name, ds, split) == \
        jds.image_path(image_root, name, ds, split)


def test_image_path_unknown_dataset_raises():
    with pytest.raises(ValueError):
        tds.image_path("/r", "x.jpg", "Unknown")


@pytest.mark.parametrize("count,index", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("skip", [0, 1])
def test_train_batches_identical(data, count, index, skip):
    root, path = data
    vocab = build_vocab([WORDS], threshold=1)
    jv = jbuild_vocab([WORDS], threshold=1)
    jvs, tvs = _sources(root)
    kw = dict(batch_size=8, max_caption_len=9, seed=3, process_index=index,
              process_count=count)
    jb = jds.CaptionTrainBatches(JCD(path), jv, jvs, **kw)
    tb = tds.CaptionTrainBatches(TCD(path), vocab, tvs, **kw)
    assert len(tb) == len(jb) == 7 and tb.n_truncated == jb.n_truncated > 0
    for epoch in (1, 2):
        got = list(tb.epoch(epoch_index=epoch, skip_batches=skip))
        want = list(jb.epoch(epoch_index=epoch, skip_batches=skip))
        assert len(got) == len(want) == 7 - skip
        for g, w in zip(got, want):
            _same(g, w)
    # the batcher's own stream (no epoch_index) advances alike
    for _ in range(2):
        for g, w in zip(tb.epoch(), jb.epoch()):
            _same(g, w)


@pytest.mark.parametrize("count,index", [(1, 0), (2, 1)])
def test_scst_batches_identical(data, count, index):
    root, path = data
    jvs, tvs = _sources(root)
    kw = dict(batch_size=4, num_refs=5, max_ref_len=8, seed=5,
              process_index=index, process_count=count)
    jb = jds.CaptionTrainSCSTBatches(
        JCD(path), JRewardVocab(jbuild_vocab([WORDS], threshold=1)), jvs, **kw)
    tb = tds.CaptionTrainSCSTBatches(
        TCD(path), RewardVocab(build_vocab([WORDS], threshold=1)), tvs, **kw)

    def norms(ids, lens):        # any deterministic function of the refs
        return np.stack([ids.sum(-1), lens, ids.max(-1), ids[..., 0]],
                        -1).astype(np.float32) / 7.0

    jb.precompute_ref_norms(norms, chunk=4)
    tb.precompute_ref_norms(norms, chunk=4)
    for skip in (0, 2):
        got = list(tb.epoch(epoch_index=1, skip_batches=skip))
        want = list(jb.epoch(epoch_index=1, skip_batches=skip))
        assert len(got) == len(want) == 3 - skip
        for g, w in zip(got, want):
            assert "ref_norms" in g
            _same(g, w)


@pytest.mark.parametrize("count,index", [(1, 0), (2, 0), (2, 1)])
def test_eval_batches_identical(data, count, index):
    root, path = data
    jvs, tvs = _sources(root)
    got = list(tds.CaptionEvalBatches(TCD(path), tvs, 4, "val", index,
                                      count).epoch())
    want = list(jds.CaptionEvalBatches(JCD(path), jvs, 4, "val", index,
                                       count).epoch())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)
    # the last batch is padded to the full batch by cycling; n_real counts
    # its real rows
    assert got[-1]["global_n_real"] == N_IMG - 8
    assert len(got[-1]["global_img_ids"]) == 4


@pytest.mark.parametrize("mode,max_bu", [("fixed", 8), ("fixed", 4),
                                         ("adaptive", 16), ("adaptive", 10)])
def test_supp_feature_loader_identical(data, mode, max_bu):
    root, _ = data
    j = jds.SuppFeatureLoader(str(root), mode, max_bu)
    t = tds.SuppFeatureLoader(str(root), mode, max_bu)
    for i in range(N_IMG):
        _same(t.load(100 + i), j.load(100 + i))
        assert t.load(100 + i)["bu_feats"].shape == (max_bu, 8)


def test_packed_feature_shard_identical(data):
    root, path = data
    packed = root / "packed"
    t = tds.SuppFeatureLoader(str(packed), "fixed", 8)
    j = jds.SuppFeatureLoader(str(packed), "fixed", 8)
    assert t._packed is not None and j._packed is not None
    plain = tds.SuppFeatureLoader(str(root), "fixed", 8)
    for i in range(N_IMG):
        _same(t.load(100 + i), j.load(100 + i))
        _same(t.load(100 + i), plain.load(100 + i))
    # a shard narrower than max_bu_len is refused (falls back to the npz)
    with pytest.warns(UserWarning, match="max_bu_len"):
        assert tds.SuppFeatureLoader(str(packed), "fixed", 12)._packed is None


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Six 96 x 128 JPEGs and their packed shard at 64."""
    from PIL import Image

    from preprocess.pack_images import pack
    root = tmp_path_factory.mktemp("images")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(3)
    entries = []
    for i in range(6):
        name = "p_%d.jpg" % i
        Image.fromarray(rng.integers(0, 255, (96, 128, 3), np.uint8)).save(
            img_dir / name, quality=92)
        entries.append({"file_name": name, "id": i})
    with open(root / "ann.json", "w") as f:
        json.dump({"images": entries}, f)
    pack([str(root / "ann.json")], str(img_dir), "Flickr8K",
         str(root / "Data"), size=64, workers=2)
    return img_dir, root / "Data", entries


@pytest.mark.parametrize("ingest", ["parity", "device"])
def test_packed_image_shard_identical(images, ingest):
    img_dir, data_dir, entries = images
    kw = dict(img_size=64, packed_dir=str(data_dir), ingest=ingest)
    t = tds._VisualSource("Flickr8K", str(img_dir), True, None, **kw)
    j = jds._VisualSource("Flickr8K", str(img_dir), True, None, **kw)
    assert t._packed_imgs is not None
    flips = [False, True] * 3
    _same(tds._stack_visuals(t.items(entries, "train", flips)),
          jds._stack_visuals(j.items(entries, "train", flips)))
    # the packed rows are the JPEG path's pixels (parity ingest)
    if ingest == "parity":
        plain = tds._VisualSource("Flickr8K", str(img_dir), True, None,
                                  img_size=64)
        assert plain._packed_imgs is None
        for e, flip in zip(entries, flips):
            np.testing.assert_array_equal(
                plain.item(e, "train", flip)["img_tensors"],
                t.item(e, "train", flip)["img_tensors"])


def test_jpeg_decode_equals_jax(images):
    img_dir, _, entries = images
    for e in entries[:2]:
        p = str(img_dir / e["file_name"])
        np.testing.assert_array_equal(tds.load_image_uint8(p, 48),
                                      jds.load_image_uint8(p, 48))


def test_jpeg_path_without_pillow_or_native_raises(images, monkeypatch):
    img_dir, _, entries = images
    monkeypatch.setattr(_native_image, "_lib", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    vs = tds._VisualSource("Flickr8K", str(img_dir), True, None, img_size=64)
    with pytest.raises(ImportError, match="Pillow is not installed"):
        vs.item(entries[0], "train", False)
    assert _native_image.decode_jpeg_resize(
        str(img_dir / entries[0]["file_name"]), 64) is None


def test_prefetcher_yields_the_epoch_and_reraises():
    items = [np.full((2,), i) for i in range(7)]
    got = list(Prefetcher(lambda: iter(items), depth=2).epoch())
    want = list(JPrefetcher(lambda: iter(items), depth=2).epoch())
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(Prefetcher(broken).epoch())


def test_prefetcher_abandoned_consumer_releases_producer():
    import threading
    before = threading.active_count()
    gen = Prefetcher(lambda: iter(range(1000)), depth=2).epoch()
    assert next(gen) == 0
    gen.close()
    assert threading.active_count() <= before + 1
