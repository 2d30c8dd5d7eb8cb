"""The port's quality gate (``simpleimagecaptionzoo_tpu_torch/examples/
train_synthetic.py``) against the JAX package's (``examples/
train_synthetic.py``).

Holds: ``generate_dataset`` (uniform and zipf, 30 images),
``generate_dataset_realtext`` and ``generate_bu_features`` write the same
files byte for byte (the JPEGs, the dataset json, ``scene_meta.json``,
``dataset_flags.json``, the per-image ``.npz`` / ``.npy`` features, the
packed shard and its index); ``reset_root_state`` returns the same and
leaves the same files on constructed roots (a size change, a reused root,
``--skip_xe``, a flipped word distribution, a root from before the flags
file); the modified annotations, the vocabulary and the idf pickle and
device table of a generated root equal the JAX toolchain's; the whole
script, driven by both packages through one stand-in CLI that writes the
records a run would, writes the same gate record and exit code in every
branch of ``examples/train_synthetic.py:552-579`` (the port's record has
one key more, ``device``); and a tiny run of the port's gate on the CPU
(AoADetection, 40 images, 32 wide, one XE and one SCST epoch) reaches its
``QUALITY_GATE:`` line in a process that imports no JAX."""
import contextlib
import filecmp
import io
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import examples.train_synthetic as J
import preprocess.build_caption_vocab as J_vocab
import preprocess.cider_idf_preprocess as J_cider
import preprocess.datasets_json_modification as J_json
import simpleimagecaptionzoo_tpu.main as J_main
from simpleimagecaptionzoo_tpu import vocab as J_vocab_mod
import simpleimagecaptionzoo_tpu_torch.main as T_main
from simpleimagecaptionzoo_tpu_torch import vocab as T_vocab_mod
from simpleimagecaptionzoo_tpu_torch.examples import train_synthetic as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX script's record (examples/train_synthetic.py:563-576), in order
JAX_KEYS = ["gate", "scst_gate", "model", "xe_val_cider", "scst_val_cider",
            "greedy_val_cider", "beam3_val_cider", "beam_ge_greedy",
            "beam_tolerance", "zipf", "realtext", "xe_threshold", "epochs",
            "scst_epochs", "n_images"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "simpleimagecaptionzoo_tpu",
             "examples", "preprocess")


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _files(root):
    """Every file under ``root``, by its path relative to it."""
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def _same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert fa == fb
    differ = [f for f in fa if not filecmp.cmp(os.path.join(a, f),
                                               os.path.join(b, f),
                                               shallow=False)]
    assert not differ, differ[:5]
    return fa


@pytest.mark.parametrize("zipf", [False, True])
def test_generated_dataset_and_features_are_byte_identical(tmp_path, zipf):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    _quiet(J.generate_dataset, j, 30, zipf=zipf)
    _quiet(T.generate_dataset, t, 30, zipf=zipf)
    for root, mod in ((j, J), (t, T)):
        os.makedirs(os.path.join(root, "Data"))
        _quiet(mod.generate_bu_features, root, os.path.join(root, "Data"))
    files = _same_tree(j, t)
    assert sum(f.endswith(".jpg") for f in files) == 30
    for f in ("dataset_synth.json", "scene_meta.json", "dataset_flags.json",
              "Data/fixed_bu_feats_packed.npy", "Data/fixed_bu_index.json",
              "Data/fixed_bu_feat/29.npz", "Data/fixed_bu_bbox/29.npy"):
        assert f in files, f
    with open(os.path.join(t, "dataset_flags.json")) as f:
        assert json.load(f) == {"zipf": zipf, "n_images": 30}
    packed = np.load(os.path.join(t, "Data", "fixed_bu_feats_packed.npy"))
    assert packed.shape == (30, 36, 2048) and packed.max() > 0


def test_realtext_dataset_and_features_are_byte_identical(tmp_path):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert os.path.samefile(T.REALTEXT_CORPUS, J.REALTEXT_CORPUS)
    n = _quiet(J.generate_dataset_realtext, j)
    assert _quiet(T.generate_dataset_realtext, t) == n == 80
    for root, mod in ((j, J), (t, T)):
        os.makedirs(os.path.join(root, "Data"))
        _quiet(mod.generate_bu_features, root, os.path.join(root, "Data"))
    files = _same_tree(j, t)
    assert "images/real_00079.jpg" in files


def _constructed_root(root, n, flags, model_dirs=("NIC", "AoADetection")):
    """A root as a gate run leaves it, without images or arrays: the
    dataset json, ``n`` scenes, the flags file (``None``: none, as roots
    from before it), the derived files and a checkpoint dir a model."""
    os.makedirs(root)
    with open(os.path.join(root, "dataset_synth.json"), "w") as f:
        json.dump({"images": [], "dataset": "synth"}, f)
    with open(os.path.join(root, "scene_meta.json"), "w") as f:
        json.dump({str(i): {"objects": [], "rel": "above"}
                   for i in range(n)}, f)
    if flags is not None:
        with open(os.path.join(root, "dataset_flags.json"), "w") as f:
            json.dump(flags, f)
    for sub in ("images", "modified_annotations", "Data", "coco_caption"):
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "x"), "w") as f:
            f.write(sub)
    with open(os.path.join(root, "caption_vocab.pkl"), "wb") as f:
        f.write(b"vocab")
    for m in model_dirs:
        d = os.path.join(root, "CheckPoints", "Model_%s_Dataset_Flickr8K" % m,
                         "best")
        os.makedirs(d)
        with open(os.path.join(d, "best_score_record.json"), "w") as f:
            json.dump({"cider": 1.0}, f)


@pytest.mark.parametrize("case,n,kw,flags,regen", [
    ("size_change", 12, {}, {"zipf": False, "n_images": 10}, True),
    ("reused", 10, {}, {"zipf": False, "n_images": 10}, False),
    ("skip_xe", 10, {"skip_xe": True}, {"zipf": False, "n_images": 10},
     False),
    ("zipf_flipped", 10, {"zipf": True}, {"zipf": False, "n_images": 10},
     True),
    ("realtext_flipped", 10, {}, {"realtext": True, "n_images": 10}, True),
    ("before_the_flags", 10, {}, None, False),
    ("before_the_flags_zipf", 10, {"zipf": True}, None, True),
    ("no_dataset", 10, {}, "none", True)])
def test_reset_root_state_decides_and_leaves_alike(tmp_path, case, n, kw,
                                                   flags, regen):
    roots = {}
    for name, mod in (("jax", J), ("port", T)):
        root = str(tmp_path / name)
        if flags == "none":
            os.makedirs(os.path.join(root, "CheckPoints"))
        else:
            _constructed_root(root, 10, flags)
        kw_all = dict(kw)
        skip_xe = kw_all.pop("skip_xe", False)
        roots[name] = _quiet(mod.reset_root_state, root, n, "NIC", skip_xe,
                             **kw_all)
    assert roots["jax"] is roots["port"] is regen
    files = _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))
    nic = "CheckPoints/Model_NIC_Dataset_Flickr8K/best/best_score_record.json"
    if case == "reused":
        assert nic not in files and "images/x" in files
        assert ("CheckPoints/Model_AoADetection_Dataset_Flickr8K/best/"
                "best_score_record.json") in files
    if case == "skip_xe":
        assert nic in files
    if regen:
        assert not any(f.startswith(("images", "Data", "CheckPoints"))
                       for f in files)


def test_preprocessing_equals_the_jax_toolchain(tmp_path):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    _quiet(T.generate_dataset, t, 30, zipf=True)
    shutil.copytree(t, j)
    # the JAX script's preprocessing (examples/train_synthetic.py:435-454)
    ann = os.path.join(j, "modified_annotations")
    _quiet(J_json.convert_karpathy, os.path.join(j, "dataset_synth.json"),
           "Flickr8K", tokenizer="karpathy", output_dir=j)
    _quiet(J_vocab.build_from_annotations,
           os.path.join(ann, "captions_train.json"),
           os.path.join(j, "caption_vocab.pkl"), threshold=1)
    _quiet(J_cider.build, os.path.join(ann, "captions_train.json"),
           "Flickr8K", os.path.join(j, "Data"),
           vocab_path=os.path.join(j, "caption_vocab.pkl"))
    _quiet(T.preprocess_root, t)
    for split in ("train", "val", "test"):
        rel = os.path.join("modified_annotations", "captions_%s.json" % split)
        with open(os.path.join(j, rel)) as a, open(os.path.join(t, rel)) as b:
            assert json.load(b) == json.load(a), split
    want = J_vocab_mod.load_vocab(os.path.join(j, "caption_vocab.pkl"))
    got = T_vocab_mod.load_vocab(os.path.join(t, "caption_vocab.pkl"))
    assert got.word2ix == want.word2ix and got.ix2word == want.ix2word
    assert len(want) > 20
    with open(os.path.join(j, "Data", "Flickr8K-train.p"), "rb") as f:
        want_df = pickle.load(f)
    with open(os.path.join(t, "Data", "Flickr8K-train.p"), "rb") as f:
        assert pickle.load(f) == want_df
    a = np.load(os.path.join(j, "Data", "cider_idf_table.npz"))
    b = np.load(os.path.join(t, "Data", "cider_idf_table.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # a second run skips what exists, and changes nothing
    before = {f: os.path.getmtime(os.path.join(t, f)) for f in _files(t)}
    _quiet(T.preprocess_root, t)
    assert {f: os.path.getmtime(os.path.join(t, f))
            for f in _files(t)} == before


def _stand_in_cli(scores):
    """A CLI that writes what a run would, from ``scores``: the XE best
    record after ``train`` (``xe`` None: none), a val eval's record in
    ``metrics.jsonl``, the SCST best record after ``scst_train`` (``scst``
    None: none); every call is logged in ``scores["calls"]``."""

    def cli(args):
        ck = os.path.join(os.getcwd(), "CheckPoints",
                          "Model_%s_Dataset_%s" % (args.model_type,
                                                   args.dataset))
        best = os.path.join(ck, "best")
        os.makedirs(best, exist_ok=True)
        scores["calls"].append((args.operation, args.eval_split,
                                int(args.eval_beam_size)))

        def log(rec):
            with open(os.path.join(ck, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")

        if args.operation == "train" and scores["xe"] is not None:
            with open(os.path.join(best, "best_score_record.json"), "w") as f:
                json.dump({"cider": scores["xe"]}, f)
            log({"phase": "xe", "epoch": 0, "steps_per_sec": 5.0})
        elif args.operation == "eval" and args.eval_split == "val":
            cider = scores["greedy" if args.eval_beam_size == -1 else "beam"]
            log({"phase": "eval", "split": "val",
                 "beam_size": int(args.eval_beam_size), "cider": cider})
        elif args.operation == "scst_train" and scores["scst"] is not None:
            with open(os.path.join(best, "best_scst_score_record.json"),
                      "w") as f:
                json.dump({"cider": scores["scst"]}, f)
            log({"phase": "scst", "epoch": 0, "scst_steps_per_sec": 2.0})
        return 0

    return cli


XE = 1.25
# (case, flags, scores): every branch of examples/train_synthetic.py:552-579
GATE_CASES = [
    ("lift_pass", [], dict(xe=XE, scst=XE + 0.01, greedy=XE, beam=XE)),
    ("lift_equal_fails", [], dict(xe=XE, scst=XE, greedy=XE, beam=XE)),
    ("xe_below_threshold", [], dict(xe=0.8999, scst=1.0, greedy=0.8999,
                                    beam=0.9)),
    ("xe_at_threshold", [], dict(xe=0.9, scst=0.95, greedy=0.9, beam=0.9)),
    ("noregress_at_the_edge", ["--scst_gate", "noregress"],
     dict(xe=XE, scst=XE - 0.02, greedy=XE, beam=XE)),
    ("noregress_below", ["--scst_gate", "noregress"],
     dict(xe=XE, scst=XE - 0.02 - 1e-9, greedy=XE, beam=XE)),
    ("noregress_above", ["--scst_gate", "noregress"],
     dict(xe=XE, scst=XE - 0.02 + 1e-9, greedy=XE, beam=XE)),
    ("skip_scst", ["--skip_scst"], dict(xe=XE, scst=None, greedy=XE,
                                        beam=XE)),
    ("scst_record_missing", [], dict(xe=XE, scst=None, greedy=XE, beam=XE)),
    ("beam_at_the_tolerance", [], dict(xe=XE, scst=1.5, greedy=1.3,
                                       beam=1.3 - 0.01)),
    ("beam_below_the_tolerance", [], dict(xe=XE, scst=1.5, greedy=1.3,
                                          beam=1.3 - 0.01 - 1e-9)),
    ("zipf_record_settings", ["--zipf", "--beam_tolerance", "0.05",
                              "--epochs", "5", "--scst_epochs", "4"],
     dict(xe=XE, scst=XE + 0.003, greedy=XE, beam=XE - 0.0314)),
]


@pytest.fixture(scope="module")
def gate_roots(tmp_path_factory):
    """One generated root a package (NIC, 10 images), reused by every
    case: reset_root_state keeps the dataset and clears the checkpoints."""
    base = tmp_path_factory.mktemp("gate")
    out = {}
    for name, zipf in (("plain", False), ("zipf", True)):
        root = str(base / ("jax_" + name))
        _quiet(T.generate_dataset, root, 10, zipf=zipf)
        shutil.copytree(root, str(base / ("port_" + name)))
        out[name] = {"jax": root, "port": str(base / ("port_" + name))}
    return out


@pytest.mark.parametrize("case,flags,scores", GATE_CASES,
                         ids=[c[0] for c in GATE_CASES])
def test_gate_record_and_exit_code_are_the_jax_scripts(
        gate_roots, tmp_path, monkeypatch, case, flags, scores):
    roots = gate_roots["zipf" if "--zipf" in flags else "plain"]
    monkeypatch.chdir(tmp_path)      # the JAX script leaves cwd in its root
    got = {}
    for name in ("jax", "port"):
        calls = dict(scores, calls=[])
        argv = ["--root", roots[name], "--model", "NIC", "--n_images", "10",
                "--gate", "--gate_out", str(tmp_path / (name + ".json"))]
        argv += flags
        if name == "jax":
            monkeypatch.setattr(J_main, "main", _stand_in_cli(calls))
            monkeypatch.setattr(sys, "argv", ["train_synthetic.py"] + argv)
            rc = _quiet(J.main)
        else:
            monkeypatch.setattr(T_main, "main", _stand_in_cli(calls))
            rc = _quiet(T.main, argv + ["--gpu_id", "cpu"])
        os.chdir(str(tmp_path))
        with open(str(tmp_path / (name + ".json"))) as f:
            got[name] = (rc, json.load(f), calls["calls"])
    (j_rc, j_rec, j_calls), (t_rc, t_rec, t_calls) = got["jax"], got["port"]
    assert list(j_rec) == JAX_KEYS
    assert list(t_rec) == JAX_KEYS + ["device"] and t_rec["device"] == "cpu"
    assert {k: t_rec[k] for k in JAX_KEYS} == j_rec
    assert t_rc == j_rc == (0 if j_rec["gate"] == "PASS" else 1)
    assert t_calls == j_calls            # the same CLI operations in order
    # the port's gate_record alone gives the same on the same readings
    args = T.build_argparser().parse_args(argv + ["--gpu_id", "cpu"])
    scst = float("nan") if scores["scst"] is None or "--skip_scst" in flags \
        else scores["scst"]
    ok, rec = T.gate_record(args, scores["xe"], scst, scores["greedy"],
                            scores["beam"], "cpu")
    assert rec == t_rec and ok == (t_rc == 0)
    expect = {"lift_pass": "PASS", "xe_at_threshold": "PASS",
              "noregress_at_the_edge": "PASS", "noregress_above": "PASS",
              "skip_scst": "PASS", "beam_at_the_tolerance": "PASS",
              "zipf_record_settings": "PASS"}.get(case, "FAIL")
    assert j_rec["gate"] == expect


def test_tiny_gate_runs_through_the_port_alone(tmp_path):
    """AoADetection, 40 images, 32 wide, one XE and one SCST epoch on the
    CPU, in a process that imports the port only; PASS is not asserted at
    this size."""
    code = (
        "import sys, json\n"
        "from simpleimagecaptionzoo_tpu_torch.examples import "
        "train_synthetic as t\n"
        "rc = t.main(sys.argv[1:])\n"
        "print('RC', rc)\n"
        "print('BAD', sorted(n for n in sys.modules "
        "if n.split('.')[0] in %r))\n" % (FORBIDDEN,))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code, "--root", str(tmp_path / "root"),
         "--model", "AoADetection", "--n_images", "40", "--dims", "32",
         "--epochs", "1", "--scst_epochs", "1", "--gate", "--gpu_id", "cpu",
         "--gate_out", str(tmp_path / "gate.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout[-2000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("QUALITY_GATE: ")]
    assert len(lines) == 1
    rec = json.loads(lines[0][len("QUALITY_GATE: "):])
    assert list(rec) == JAX_KEYS + ["device"] and rec["device"] == "cpu"
    assert rec["model"] == "AoADetection" and rec["n_images"] == 40
    assert "RC %d" % (0 if rec["gate"] == "PASS" else 1) in out.stdout
    with open(str(tmp_path / "gate.json")) as f:
        assert json.load(f) == rec
    stages = json.loads([ln for ln in out.stdout.splitlines()
                         if ln.startswith("STAGE_SECONDS: ")][0][15:])
    assert list(stages) == ["dataset", "preprocessing", "xe", "xe_test_eval",
                            "val_evals", "scst", "sample"]
    ck = tmp_path / "root" / "CheckPoints" / \
        "Model_AoADetection_Dataset_Flickr8K"
    assert (ck / "cp" / "Captioner_scst_cp.msgpack").exists()


def test_realtext_gate_runs_the_same_operations(tmp_path, monkeypatch):
    """``--realtext`` (BUTDDetection): the corpus's 80 scenes override
    --n_images and --zipf in both scripts, both sample real_00000.jpg, and
    both write the same record."""
    monkeypatch.chdir(tmp_path)
    got = {}
    for name, mod, main_mod in (("jax", J, J_main), ("port", T, T_main)):
        calls = dict(xe=1.0, scst=1.1, greedy=1.0, beam=1.0, calls=[])
        argv = ["--root", str(tmp_path / name), "--model", "BUTDDetection",
                "--realtext", "--zipf", "--n_images", "7", "--gate",
                "--gate_out", str(tmp_path / (name + ".json"))]
        monkeypatch.setattr(main_mod, "main", _stand_in_cli(calls))
        seen = []
        real_cli_args = (J_main if name == "jax" else T_main).build_argparser

        def spy(real=real_cli_args):
            p = real()
            parse = p.parse_args
            p.parse_args = lambda a: seen.append(a) or parse(a)
            return p
        monkeypatch.setattr(main_mod, "build_argparser", spy)
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["train_synthetic.py"] + argv)
            rc = _quiet(J.main)
        else:
            rc = _quiet(T.main, argv + ["--gpu_id", "cpu"])
        os.chdir(str(tmp_path))
        with open(str(tmp_path / (name + ".json"))) as f:
            got[name] = (rc, json.load(f), calls["calls"],
                         [a[a.index("--img_filename") + 1] for a in seen
                          if "--img_filename" in a])
    j, t = got["jax"], got["port"]
    assert {k: t[1][k] for k in JAX_KEYS} == j[1]
    assert j[1]["n_images"] == 80 and j[1]["realtext"] and not j[1]["zipf"]
    assert t[0] == j[0] == 0 and t[2] == j[2]
    assert t[3] == j[3] == ["real_00000.jpg"]
    _same_tree(str(tmp_path / "jax" / "Data"), str(tmp_path / "port" / "Data"))


def test_a_run_without_an_xe_best_record_fails_the_gate(tmp_path,
                                                         monkeypatch):
    """Where no XE epoch scored a val CIDEr above 0 the engine writes no
    XE best record: the port's gate records 0.0 and FAILs, where the JAX
    script stops on the missing file."""
    monkeypatch.chdir(tmp_path)
    argv = ["--root", str(tmp_path / "root"), "--model", "NIC",
            "--n_images", "10", "--gate"]
    calls = dict(xe=None, scst=None, greedy=0.0, beam=0.0, calls=[])
    monkeypatch.setattr(J_main, "main", _stand_in_cli(calls))
    monkeypatch.setattr(sys, "argv", ["train_synthetic.py"] + argv)
    with pytest.raises(FileNotFoundError):
        _quiet(J.main)
    os.chdir(str(tmp_path))
    calls["calls"] = []
    monkeypatch.setattr(T_main, "main", _stand_in_cli(calls))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert T.main(argv + ["--gpu_id", "cpu"]) == 1
    rec = json.loads([ln for ln in out.getvalue().splitlines()
                      if ln.startswith("QUALITY_GATE: ")][0][14:])
    assert rec["gate"] == "FAIL" and rec["xe_val_cider"] == 0.0
    assert rec["scst_val_cider"] is None
