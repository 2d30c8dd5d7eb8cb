"""The port's preprocessing entry points
(``simpleimagecaptionzoo_tpu_torch/preprocess/``) against the JAX
package's scripts (``preprocess/``), and the port's COCO14 dry run
(``simpleimagecaptionzoo_tpu_torch/tools/reproduce_coco14.py``).

Holds, on tools/make_coco14_fixture.py's tree (16 JPEGs of 64 px, a
Karpathy json, with ``--bu`` a bottom-up TSV of 36 x 2048 float32 rows):
each port script writes the same files as the JAX one, compared exactly
(no tolerance: the same arithmetic on the same inputs): the modified
annotation jsons equal as parsed json, under the karpathy and ptb
tokenizers and from raw COCO17 annotations; the vocabulary pickle loaded
by both packages with the same word -> index and index -> word maps; the
idf pickle equal as a dict, the device table's arrays equal (hash_version
included); the per-image npz and npy arrays equal; the packed feature shard
and the packed image shard, and their index jsons, byte-equal; each
script's inspection output (``--show``, ``--operation check``) the same
text, and the bottom-up check's png drawn by both.  The flags of each port
script are those of the JAX one.  The dry run at 32 wide, on the CPU,
reaches "DRY RUN OK" with the port alone (no jax in ``sys.modules``), for
the bottom-up branch (AoADetection) and the pixel branch (NIC)."""
import contextlib
import filecmp
import importlib.util
import io
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

import preprocess.build_caption_vocab as J_vocab
import preprocess.cider_idf_preprocess as J_cider
import preprocess.datasets_json_modification as J_json
import preprocess.generate_bottom_up_features as J_bu
import preprocess.pack_images as J_pack
from simpleimagecaptionzoo_tpu import vocab as J_vocab_mod
from simpleimagecaptionzoo_tpu_torch import vocab as T_vocab_mod
from simpleimagecaptionzoo_tpu_torch.preprocess import (
    build_caption_vocab as T_vocab, cider_idf_preprocess as T_cider,
    datasets_json_modification as T_json,
    generate_bottom_up_features as T_bu, pack_images as T_pack)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("datasets_json_modification", "build_caption_vocab",
           "cider_idf_preprocess", "generate_bottom_up_features",
           "pack_images")


def _fixture_tree(root, bu):
    spec = importlib.util.spec_from_file_location(
        "make_coco14_fixture", os.path.join(ROOT, "tools",
                                            "make_coco14_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with contextlib.redirect_stdout(io.StringIO()):
        mod.main(["--dataset_root", str(root)] + (["--bu"] if bu else []))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _fixture_tree(tmp_path_factory.mktemp("coco14"), bu=False)


@pytest.fixture(scope="module")
def bu_tree(tmp_path_factory):
    return _fixture_tree(tmp_path_factory.mktemp("coco14_bu"), bu=True)


def _quiet(fn, *a, **kw):
    """fn's result and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a, **kw)
    return res, out.getvalue()


def _annotations(tree, out, mod, tokenizer="karpathy"):
    _quiet(mod.convert_karpathy, os.path.join(tree, "dataset_coco.json"),
           "COCO14", tokenizer, str(out))
    return os.path.join(str(out), "modified_annotations")


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("tokenizer", ["karpathy", "ptb"])
def test_modified_annotations_equal_the_jax_scripts(tree, tmp_path,
                                                    tokenizer):
    j = _annotations(tree, tmp_path / "jax", J_json, tokenizer)
    t = _annotations(tree, tmp_path / "port", T_json, tokenizer)
    for split in ("train", "val", "test"):
        name = "captions_%s.json" % split
        want = _read_json(os.path.join(j, name))
        assert _read_json(os.path.join(t, name)) == want, name
        assert len(want["images"]) == {"train": 8, "val": 4, "test": 4}[split]
    # --show prints the same inspection
    path = os.path.join(j, "captions_train.json")
    assert _quiet(T_json.show_modified_annotations, path)[1] == \
        _quiet(J_json.show_modified_annotations, path)[1]
    # an existing tree is left alone by both
    assert _quiet(T_json.convert_karpathy, os.path.join(
        tree, "dataset_coco.json"), "COCO14", tokenizer,
        str(tmp_path / "port"))[0] == {}


def test_coco17_annotations_equal_the_jax_scripts(tree, tmp_path):
    """Raw COCO17 captions_{train,val}2017.json (made from the fixture's
    Karpathy json) through both packages' convert_coco17."""
    ks = _read_json(os.path.join(tree, "dataset_coco.json"))
    raw = tmp_path / "raw"
    raw.mkdir()
    for split in ("train", "val"):
        imgs = [i for i in ks["images"] if (i["split"] == "train")
                == (split == "train")]
        with open(raw / ("captions_%s2017.json" % split), "w") as f:
            json.dump({"images": [{"id": i["cocoid"],
                                   "file_name": i["filename"]}
                                  for i in imgs],
                       "annotations": [
                           {"image_id": i["cocoid"], "id": sid,
                            "caption": s["raw"]}
                           for i in imgs for sid, s in zip(i["sentids"],
                                                           i["sentences"])]},
                      f)
    for mod, name in ((J_json, "jax"), (T_json, "port")):
        _quiet(mod.convert_coco17, str(raw), "ptb", str(tmp_path / name))
    for split in ("train", "val"):
        rel = os.path.join("modified_annotations", "captions_%s.json" % split)
        assert _read_json(str(tmp_path / "port" / rel)) == \
            _read_json(str(tmp_path / "jax" / rel))


def test_vocab_loads_in_both_packages_with_the_same_maps(tree, tmp_path):
    ann = _annotations(tree, tmp_path / "ann", T_json)
    train = os.path.join(ann, "captions_train.json")
    jp, tp = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    _quiet(J_vocab.build_from_annotations, train, jp)
    _quiet(T_vocab.main, ["--train_caption_path", train, "--vocab_path", tp])
    want = J_vocab_mod.load_vocab(jp)
    assert len(want) == 20             # 16 fixture words and the specials
    for load in (J_vocab_mod.load_vocab, T_vocab_mod.load_vocab):
        got = load(tp)
        assert got.word2ix == want.word2ix and got.ix2word == want.ix2word
        assert got.idx == want.idx
    assert T_vocab_mod.load_vocab(jp).word2ix == want.word2ix


def test_cider_tables_equal_the_jax_scripts(tree, tmp_path):
    ann = _annotations(tree, tmp_path / "ann", T_json)
    train = os.path.join(ann, "captions_train.json")
    vocab = str(tmp_path / "vocab.pkl")
    _quiet(T_vocab.build_from_annotations, train, vocab)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _quiet(J_cider.build, train, "COCO14", jd, vocab)
    _quiet(T_cider.main, ["--dataset", "COCO14", "--train_caption_path",
                          train, "--vocab_path", vocab, "--out_dir", td])
    with open(os.path.join(jd, "COCO14-train.p"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(td, "COCO14-train.p"), "rb") as f:
        got = pickle.load(f)
    assert got == want and want["ref_len"] == 8
    a = np.load(os.path.join(jd, "cider_idf_table.npz"))
    b = np.load(os.path.join(td, "cider_idf_table.npz"))
    assert sorted(a.files) == sorted(b.files) == sorted(
        ["h1", "h2", "df", "log_ref_len", "hash_version"])
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert int(b["hash_version"]) == 2
    # --operation check prints the same entries
    assert _quiet(T_cider.check, "COCO14", td, "dog")[1] == \
        _quiet(J_cider.check, "COCO14", jd, "dog")[1]


def test_bottom_up_features_equal_the_jax_scripts(bu_tree, tmp_path):
    tsv = [os.path.join(bu_tree, "trainval_36", "fixture.tsv")]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _quiet(J_bu.generate, tsv, "fixed", jd)[0] == 16
    assert _quiet(T_bu.main, ["--operation", "generate", "--bu_type",
                              "fixed", "--tsv"] + tsv
                  + ["--output_dir", td])[0] == 0
    for sub, ext in (("fixed_bu_feat", ".npz"), ("fixed_bu_bbox", ".npy")):
        names = sorted(os.listdir(os.path.join(jd, sub)))
        assert sorted(os.listdir(os.path.join(td, sub))) == names
        assert len(names) == 16 and all(n.endswith(ext) for n in names)
        for n in names:
            a, b = (np.load(os.path.join(d, sub, n)) for d in (jd, td))
            if ext == ".npz":
                assert sorted(a.files) == sorted(b.files) == ["feat"]
                a, b = a["feat"], b["feat"]
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(b, a, err_msg=n)
    # the packed shard and its index, byte for byte
    _quiet(J_bu.pack, jd, "fixed", 36)
    _quiet(T_bu.main, ["--operation", "pack", "--bu_type", "fixed",
                       "--output_dir", td])
    for name in ("fixed_bu_feats_packed.npy", "fixed_bu_index.json"):
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name),
                           shallow=False), name
    assert np.load(os.path.join(td, "fixed_bu_feats_packed.npy")).shape == \
        (16, 36, 2048)


def test_bottom_up_check_prints_and_draws_as_the_jax_script(bu_tree,
                                                           tmp_path,
                                                           monkeypatch):
    pytest.importorskip("matplotlib")
    tsv = [os.path.join(bu_tree, "trainval_36", "fixture.tsv")]
    d = str(tmp_path / "feats")
    _quiet(T_bu.generate, tsv, "fixed", d)
    image = os.path.join(bu_tree, "train2014", "COCO_train2014_%012d.jpg" % 1)
    outs = {}
    for mod, name in ((J_bu, "jax"), (T_bu, "port")):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        outs[name] = _quiet(mod.check, d, "fixed", "1", image)[1]
        assert (cwd / "fixed_bu_bbox_visualization.png").stat().st_size > 0
    assert outs["port"] == outs["jax"]
    assert "feat (36, 2048) bbox (36, 4)" in outs["port"]


def test_packed_image_shard_equals_the_jax_scripts(tree, tmp_path):
    ann = _annotations(tree, tmp_path / "ann", T_json)
    jsons = [os.path.join(ann, "captions_%s.json" % s)
             for s in ("train", "val", "test")]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    _quiet(J_pack.pack, jsons, tree, "COCO14", jd, size=64, workers=2)
    _quiet(T_pack.main, ["--annotations"] + jsons
           + ["--image_root", tree, "--dataset", "COCO14", "--output_dir",
              td, "--size", "64", "--workers", "2"])
    for name in ("images_64_packed.npy", "images_64_index.json"):
        assert filecmp.cmp(os.path.join(jd, name), os.path.join(td, name),
                           shallow=False), name
    shard = np.load(os.path.join(td, "images_64_packed.npy"))
    assert shard.shape == (16, 64, 64, 3) and shard.dtype == np.uint8
    assert shard.any()


def _flags(argv):
    help_text = subprocess.run(argv + ["--help"], capture_output=True,
                               text=True, timeout=120, cwd=ROOT,
                               env=dict(os.environ, PYTHONPATH=ROOT)).stdout
    return set(re.findall(r"(--[a-z_]+)", help_text))


def test_each_port_script_takes_the_jax_scripts_flags():
    for name in SCRIPTS:
        want = _flags([sys.executable, os.path.join(ROOT, "preprocess",
                                                    name + ".py")])
        got = _flags([sys.executable, "-m",
                      "simpleimagecaptionzoo_tpu_torch.preprocess." + name])
        assert got == want and "--help" in got, (name, got ^ want)


_DRY_CODE = (
    "import sys\n"
    "from simpleimagecaptionzoo_tpu_torch.tools import "
    "reproduce_coco14 as r\n"
    "if sys.argv[1] == 'zero_cider':\n"
    "    from simpleimagecaptionzoo_tpu_torch.engine.engine import Engine\n"
    "    score = Engine._score_val\n"
    "    Engine._score_val = lambda self, beam: (score(self, beam), 0.0)[1]\n"
    "rc = r.main(sys.argv[2:])\n"
    "print('JAX_LOADED', sorted(m for m in sys.modules\n"
    "      if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
    "                             'simpleimagecaptionzoo_tpu')))\n"
    "sys.exit(rc)\n")


def _dry_run(tmp_path, model, how="as_is"):
    """The tool's dry run of ``model`` at --gpu_id cpu in a process of its
    own (``how`` "zero_cider": every val CIDEr the engine scores read as
    0, the decode still run) -> (its output, its checkpoint directory)."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _DRY_CODE, how, "dry_run", model, "--gpu_id",
         "cpu", "--root", str(tmp_path / "run")], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "DRY RUN OK: %s" % (tmp_path / "run") in out.stdout
    assert "JAX_LOADED []" in out.stdout
    return out.stdout, tmp_path / "run" / "CheckPoints" / (
        "Model_%s_Dataset_COCO14" % model)


@pytest.mark.parametrize("model", ["AoADetection", "NIC", "BUTDDetection",
                                   "BUTDSpatial", "AoASpatial"])
def test_dry_run_reaches_ok_with_the_port_alone(tmp_path, model):
    """The dry run's every stage at 32 wide on the CPU at the CLI's seed
    0, in a process that imports the port only; the files the shell
    script asserts exist (the tool raises otherwise), the SCST best
    record exactly where the SCST history holds a val CIDEr above 0, and
    the eval prints its metric table."""
    stdout, cp = _dry_run(tmp_path, model)
    for metric in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"):
        assert metric in stdout
    cfg = _read_json(str(tmp_path / "run" / "Configs" / "Models"
                         / (model + ".json")))
    assert cfg["embed_dim"] == cfg["hidden_dim"] == 32
    assert (cp / "cp" / "Captioner_scst_cp.msgpack").exists()
    his = _read_json(str(cp / "cp" / "scst_state_histories.json"))
    record = cp / "best" / "best_scst_score_record.json"
    assert record.exists() == (max(his["cider_his"]) > 0)


def test_dry_run_passes_without_an_scst_best_when_val_cider_is_0(tmp_path):
    """Where no epoch scores a val CIDEr above 0 the engine writes no best
    record, and the dry run still reaches DRY RUN OK."""
    stdout, cp = _dry_run(tmp_path, "NIC", "zero_cider")
    for scst in ("", "scst_"):
        his = _read_json(str(cp / "cp" / ("%sstate_histories.json" % scst)))
        assert his["cider_his"] == [0.0]
    assert not (cp / "best" / "best_scst_score_record.json").exists()
    assert not (cp / "best" / "best_score_record.json").exists()
    assert (cp / "cp" / "Captioner_scst_cp.msgpack").exists()
    assert "the best record absent" in stdout


@pytest.mark.parametrize("history,record,ok", [
    ([0.0], None, True), ([0.0, 0.25], 0.25, True),
    ([0.0], 0.0, False), ([0.25], None, False), ([0.25, 0.1], 0.1, False)])
def test_the_scst_best_record_is_checked_both_ways(tmp_path, history,
                                                  record, ok):
    """reproduce_coco14._assert_scst_best: the record present if and only
    if the history holds a val CIDEr above 0, holding the history's best."""
    from simpleimagecaptionzoo_tpu_torch.tools import reproduce_coco14 as r
    for d in ("cp", "best"):
        (tmp_path / d).mkdir()
    with open(tmp_path / "cp" / "scst_state_histories.json", "w") as f:
        json.dump({"cider_his": history}, f)
    if record is not None:
        with open(tmp_path / "best" / "best_scst_score_record.json",
                  "w") as f:
            json.dump({"cider": record}, f)
    if ok:
        r._assert_scst_best(str(tmp_path))
    else:
        with pytest.raises((AssertionError, FileNotFoundError),
                           match="DRY RUN FAILED"):
            r._assert_scst_best(str(tmp_path))
