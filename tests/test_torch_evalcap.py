"""The port's COCO-caption scorers (``simpleimagecaptionzoo_tpu_torch.evalcap``)
against the JAX package's on the hand-written caption corpus
(tests/fixtures/realtext_corpus.json): BLEU-1..4, METEOR(lite), ROUGE-L,
CIDEr, CIDEr-D, SPICE(lite), the PTB tokenizer, CocoEvalCap, coco_eval and
coco_eval_specific.  Every score must equal JAX's within 1e-12."""
import json
import os

import numpy as np
import pytest

from simpleimagecaptionzoo_tpu.evalcap import (bleu as jbleu,
                                               cider_scorer as jcider,
                                               coco_eval as jcoco,
                                               meteor as jmeteor,
                                               rouge as jrouge,
                                               spice_lite as jspice,
                                               tokenizer as jtok)
from simpleimagecaptionzoo_tpu_torch.evalcap import (bleu as tbleu,
                                                     cider_scorer as tcider,
                                                     coco_eval as tcoco,
                                                     meteor as tmeteor,
                                                     rouge as trouge,
                                                     spice_lite as tspice,
                                                     tokenizer as ttok)

TOL = 1e-12
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "realtext_corpus.json")


def _corpus():
    """gts: scene i's five captions; res: one caption per scene, taken
    from scene i (a held-out one), from scene i+1 or reworded, so the
    scores spread between 0 and 1."""
    with open(FIXTURE) as f:
        scenes = json.load(f)["scenes"]
    gts, res = {}, {}
    for i, sc in enumerate(scenes):
        caps = sc["captions"]
        gts[i] = [{"image_id": i, "caption": c} for c in caps[1:]]
        if i % 3 == 0:
            hyp = caps[0]
        elif i % 3 == 1:
            hyp = scenes[(i + 1) % len(scenes)]["captions"][0]
        else:
            hyp = " ".join(reversed(caps[0].split()[:6])) + "."
        res[i] = [{"image_id": i, "caption": hyp}]
    return gts, res


def _tokenized(tok_mod):
    gts, res = _corpus()
    return (tok_mod.PTBTokenizer(_source="gts").tokenize(gts),
            tok_mod.PTBTokenizer(_source="res").tokenize(res))


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
        return
    if isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
        return
    assert abs(float(a) - float(b)) <= TOL, (a, b)


def test_ptb_tokenizer_identical():
    assert _tokenized(ttok) == _tokenized(jtok)
    # the line tokenizer on punctuation, case and contractions
    for text in ("A man's dog, running!", "Two  people -- on a (red) bus.",
                 "It's 3:15 p.m.; they're late?"):
        assert ttok.tokenize_caption(text) == jtok.tokenize_caption(text)


@pytest.mark.parametrize("name", ["bleu", "meteor", "rouge", "cider",
                                  "spice_lite"])
def test_scorer_equals_jax(name):
    gts, res = _tokenized(jtok)
    make = {"bleu": (lambda m: m.Bleu(4), jbleu, tbleu),
            "meteor": (lambda m: m.Meteor(), jmeteor, tmeteor),
            "rouge": (lambda m: m.Rouge(), jrouge, trouge),
            "cider": (lambda m: m.Cider(), jcider, tcider),
            "spice_lite": (lambda m: m.SpiceLite(), jspice, tspice)}[name]
    build, jmod, tmod = make
    jscore, jscores = build(jmod).compute_score(gts, res)
    tscore, tscores = build(tmod).compute_score(gts, res)
    _close(tscore, jscore)
    _close(tscores, jscores)
    if name == "meteor":
        assert tmod.Meteor().method() == jmod.Meteor().method()
    # the scores spread: not all equal (the corpus exercises the scorer)
    flat = np.asarray(tscores if name != "bleu" else tscores[0], float) \
        if name != "spice_lite" else None
    if flat is not None:
        assert flat.max() > flat.min()


def test_cider_d_with_corpus_df_equals_jax():
    gts, res = _tokenized(jtok)
    res_list = [{"image_id": k, "caption": v} for k, v in res.items()]
    js, jv = jcider.CiderD(df="corpus").compute_score(gts, res_list)
    ts, tv = tcider.CiderD(df="corpus").compute_score(gts, res_list)
    _close(ts, js)
    _close(tv, jv)


def _write_ann(path):
    """The corpus as a modified-annotation json (the data layer's schema)."""
    gts, _ = _corpus()
    images, anns = [], []
    for i, caps in gts.items():
        images.append({"id": i, "file_name": "img_%d.jpg" % i,
                       "sentids": [], "sentences": []})
        for j, c in enumerate(caps):
            anns.append({"image_id": i, "id": i * 10 + j,
                         "caption": c["caption"],
                         "tokens": c["caption"].lower().split(),
                         "file_name": "img_%d.jpg" % i})
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def test_coco_eval_cap_equals_jax():
    gts, res = _corpus()
    j = jcoco.CocoEvalCap(gts, res)
    j.evaluate()
    t = tcoco.CocoEvalCap(gts, res)
    t.evaluate()
    assert set(t.eval) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4",
                           "METEOR(lite)", "ROUGE_L", "CIDEr",
                           "SPICE(lite)"} == set(j.eval)
    _close(t.eval, j.eval)
    assert len(t.evalImgs) == len(j.evalImgs) == len(gts)
    for a, b in zip(t.evalImgs, j.evalImgs):
        _close(a, b)


def test_coco_eval_and_specific_equal_jax(tmp_path):
    ann = tmp_path / "ann.json"
    _write_ann(ann)
    _, res = _corpus()
    results = [{"image_id": k, "caption": v[0]["caption"]}
               for k, v in res.items()]
    jc = jcoco.coco_eval(results, str(ann),
                         results_dir=str(tmp_path / "j_results"))
    tc = tcoco.coco_eval(results, str(ann),
                         results_dir=str(tmp_path / "t_results"))
    assert abs(tc - jc) <= TOL and tc > 0
    # the same results file, at the reference's name
    with open(tmp_path / "t_results" / "captions-generate.json") as f:
        assert json.load(f) == results
    js = jcoco.coco_eval_specific(results, str(ann),
                                  statics_dir=str(tmp_path / "j_stat"))
    ts = tcoco.coco_eval_specific(results, str(ann),
                                  statics_dir=str(tmp_path / "t_stat"))
    assert abs(ts - js) <= TOL
    with open(tmp_path / "t_stat" / "CIDEr_Result.txt") as f, \
            open(tmp_path / "j_stat" / "CIDEr_Result.txt") as g:
        assert f.read() == g.read()


def test_jar_lookup_searches_the_ports_directory(monkeypatch, tmp_path):
    """find_jar: the environment variable first, then a jar in the port's
    own evalcap directory, else "" (the Python scorers)."""
    monkeypatch.delenv("SICZ_TPU_METEOR_JAR", raising=False)
    assert ttok.find_jar("SICZ_TPU_METEOR_JAR", "no-such.jar") == ""
    jar = tmp_path / "x.jar"
    jar.write_bytes(b"")
    monkeypatch.setenv("SICZ_TPU_METEOR_JAR", str(jar))
    assert ttok.find_jar("SICZ_TPU_METEOR_JAR", "no-such.jar") == str(jar)
    here = os.path.dirname(os.path.abspath(ttok.__file__))
    assert here.endswith(os.path.join("simpleimagecaptionzoo_tpu_torch",
                                      "evalcap"))
