"""SPICE(lite) — a jar-less approximation of the SPICE metric.

Official SPICE (Anderson et al. 2016; vendored in the reference as
``coco_caption/pycocoevalcap/spice/spice.py`` around ``spice-1.0.jar``)
parses captions into scene graphs with the Stanford dependency parser and
F-scores the candidate's tuple set against the union of the references'.
The parser does not exist in Python, so — exactly like ``METEOR(lite)``
(meteor.py) — this module substitutes the unportable stage with a
clearly-labeled approximation and keeps the metric's *protocol* intact:

* **scene graphs** come from a rule-based chunker tuned to the caption
  register (short present-tense declaratives): determiner-delimited noun
  phrases, a closed-class preposition/copula table, and positional
  gerund/participle detection stand in for the dependency parse.
* **tuples** are the same three kinds the jar emits — objects ``(o,)``,
  attributes ``(o, attr)``, relations ``(subj, rel, obj)`` — plus the
  jar's Color/Count/Size attribute subcategories via small lexicons.
* **matching** is Porter-stem equality (the jar additionally matches
  WordNet synonyms; stems only, like the lite METEOR's exact+stem stages).
* **scoring** is identical: per-image P/R/F over tuple sets, corpus score
  = mean F, per-image breakdowns shaped like the jar's ``scores`` dict.

Known approximations (why scores are labeled ``SPICE(lite)`` and never
mixed with official SPICE): prepositional phrases attach to the NEAREST
LEFT noun (the parser resolves true attachment), no synonym matching, no
plural normalization beyond stemming, and copula complements are
attributes only when no determiner follows.  Candidate and references go
through the SAME pipeline, so systematic parse quirks largely cancel.

Reference protocol being approximated: spice.py:40-101 (batch json in,
per-image ``{"All"/"Object"/...: {p,r,f}}`` out).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from simpleimagecaptionzoo_tpu_torch.evalcap.meteor import _stem

Tuple_ = Tuple[str, ...]

DETS = frozenset("a an the this that these those some any each every its his "
                 "her their my your our no another other".split())
COPULAS = frozenset("is are was were be been being 's seems seem looks look "
                    "appears appear".split())
CONJS = frozenset(("and", "or"))
SKIP = frozenset("there here it they he she i we you also very really quite "
                 "just so too while as".split())
PREPS = frozenset("in on at with of by near under over above below behind "
                  "beside between against across around along inside outside "
                  "onto into atop beneath upon through toward towards from "
                  "off past beyond underneath amid among down up".split())
# longest-match multiword relations (checked before single-token handling)
MULTI_PREPS = (("next", "to"), ("close", "to"), ("in", "front", "of"),
               ("on", "top", "of"), ("in", "the", "middle", "of"),
               ("to", "the", "left", "of"), ("to", "the", "right", "of"),
               ("left", "of"), ("right", "of"), ("out", "of"))
NUM_WORDS = {"one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
             "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
             "eleven": "11", "twelve": "12"}
COLORS = frozenset("red orange yellow green blue purple pink brown black "
                   "white gray grey tan beige gold golden silver cyan "
                   "magenta maroon navy teal violet".split())
SIZES = frozenset("big small large little tiny huge giant tall short long "
                  "wide narrow thick thin".split())
# common caption nouns/adjectives ending in -ing that must NOT be read as
# verbs even in post-nominal position
NOUN_ING = frozenset("building painting ceiling clothing lightning railing "
                     "awning icing frosting dressing crossing landing "
                     "living dining wedding evening morning king ring "
                     "spring string swing thing wing duckling sibling".split())


NOUN_ED = frozenset(("shed", "sled", "reed", "seed", "feed", "weed",
                     "speed", "steed", "bled"))


def _is_verbish(tok: str, np_words: List[str], after_copula: bool) -> bool:
    """Positional gerund/participle detection: ``riding`` after a noun is a
    verb (``a man riding``) and so is a gerund right after a copula
    (``are playing``); after a determiner it is an NP modifier (``a dining
    table``).  Post-nominal ``-ed`` participles (``a car parked on …``)
    are verbs too.  ``np_words`` is the NP accumulated so far — non-empty
    means we are post-nominal."""
    if tok in NOUN_ING or tok in NOUN_ED:
        return False
    if tok.endswith("ing") and len(tok) >= 5:
        return bool(np_words) or after_copula
    if tok.endswith("ed") and len(tok) >= 5 and not tok.endswith("eed"):
        return bool(np_words)
    return False


def _is_sverb(tok: str, np_words: List[str], nxt: str) -> bool:
    """Third-person -s verbs are lexically identical to plural nouns; the
    caption-register disambiguator is positional: post-nominal AND directly
    followed by a new determiner/number starts the object NP of a
    transitive verb (``a man rideS A horse``), while a plural noun is
    followed by a preposition or sentence end (``two dogs ON a bench``)."""
    return (len(tok) >= 4 and tok.endswith("s") and not tok.endswith("ss")
            and bool(np_words)
            and (nxt in DETS or nxt in NUM_WORDS or nxt.isdigit()))


def _match_multiword(tokens: Sequence[str], i: int):
    for mp in MULTI_PREPS:
        if tuple(tokens[i:i + len(mp)]) == mp:
            return mp
    return None


def parse_scene_graph(caption: str) -> Set[Tuple_]:
    """Caption -> set of stemmed scene-graph tuples.

    ``(obj,)`` / ``(obj, attr)`` / ``(subj, rel, obj)``; all terms are
    Porter stems so morphological variants match across captions."""
    stem = _stem()
    tokens = [t for t in caption.lower().split() if any(c.isalnum()
                                                        for c in t)]
    tuples: Set[Tuple_] = set()
    np_words: List[str] = []   # content words of the NP being accumulated
    counts: List[str] = []     # numeric attributes seen in this NP
    rel: List[str] = []        # pending relation marker words
    rel_from_copula = False    # pending relation is a bare copula
    obj_has_det = False        # current NP was opened by a determiner
    last_head: str = ""        # nearest-left object (relation subject)

    def close_np():
        nonlocal np_words, counts, rel, rel_from_copula, obj_has_det, \
            last_head
        if not np_words:
            counts, rel = [], rel  # keep pending rel (e.g. "is on")
            return
        if rel_from_copula and not obj_has_det and last_head:
            # copula complement without a determiner: attributes of the
            # subject ("the car is red [and fast]")
            for w in np_words:
                tuples.add((last_head, stem(w)))
        else:
            head = stem(np_words[-1])
            tuples.add((head,))
            for w in np_words[:-1]:
                tuples.add((head, stem(w)))
            for c in counts:
                tuples.add((head, c))
            if rel and last_head:
                verb_part = [stem(w) for w in rel if w not in COPULAS]
                if verb_part:  # bare-copula noun predication emits no rel
                    tuples.add((last_head, " ".join(verb_part), head))
            last_head = head
        np_words, counts, rel = [], [], []
        rel_from_copula = False
        obj_has_det = False

    i = 0
    while i < len(tokens):
        tok = tokens[i]
        mp = _match_multiword(tokens, i)
        if mp is not None:
            close_np()
            rel = [w for w in mp if w not in DETS]
            rel_from_copula = False
            i += len(mp)
            continue
        if tok in DETS:
            if np_words:        # new det = new NP ("a cat a dog" is rare
                close_np()      # but conj handling below routes here too)
            obj_has_det = True
        elif tok in NUM_WORDS or tok.isdigit():
            if np_words:
                close_np()
            counts.append(NUM_WORDS.get(tok, tok))
        elif tok in COPULAS:
            close_np()
            rel = [tok]
            rel_from_copula = True
        elif tok in PREPS:
            close_np()
            # verb + prep merges ("sitting on"); copula + prep drops the
            # copula ("is on" -> "on")
            rel = [w for w in rel if w not in COPULAS] + [tok]
            rel_from_copula = False
        elif tok in CONJS:
            # "black and white cat" (next token is content) continues the
            # NP; "a cat and a dog" (next token is a det/number) closes it
            nxt = tokens[i + 1] if i + 1 < len(tokens) else ""
            if nxt in DETS or nxt in NUM_WORDS or nxt.isdigit():
                close_np()
        elif tok in SKIP:
            pass
        elif (_is_verbish(tok, np_words, rel_from_copula and not np_words)
              or _is_sverb(tok, np_words,
                           tokens[i + 1] if i + 1 < len(tokens) else "")):
            saved_rel = rel if rel_from_copula else []
            close_np()
            # "are playing" keeps building one relation; "a man riding"
            # starts a fresh one
            rel = [w for w in saved_rel if w not in COPULAS] + [tok]
            rel_from_copula = False
        else:
            np_words.append(tok)
        i += 1
    close_np()
    # trailing intransitive verb: "a dog is running" / "two dogs playing"
    # ends with a pending relation and no object NP — SPICE emits the verb
    # as an attribute of the subject there
    verb_tail = [stem(w) for w in rel if w not in COPULAS]
    if verb_tail and last_head:
        tuples.add((last_head, " ".join(verb_tail)))
    return tuples


def _caption_set(captions: Iterable[str]) -> Set[Tuple_]:
    out: Set[Tuple_] = set()
    for c in captions:
        out |= parse_scene_graph(c)
    return out


def _prf(cand: Set[Tuple_], ref: Set[Tuple_]) -> Dict[str, float]:
    m = len(cand & ref)
    p = m / len(cand) if cand else 0.0
    r = m / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return {"p": p, "r": r, "f": f}


def _category(tuples: Set[Tuple_], kind: str) -> Set[Tuple_]:
    if kind == "Object":
        return {t for t in tuples if len(t) == 1}
    if kind == "Relation":
        return {t for t in tuples if len(t) == 3}
    attrs = {t for t in tuples if len(t) == 2}
    if kind == "Attribute":
        return attrs
    if kind == "Color":
        return {t for t in attrs if t[1] in _COLOR_STEMS}
    if kind == "Size":
        return {t for t in attrs if t[1] in _SIZE_STEMS}
    if kind == "Count":
        return {t for t in attrs if t[1].isdigit()}
    raise ValueError(kind)


# category lexicons are matched post-stemming
_COLOR_STEMS = frozenset()
_SIZE_STEMS = frozenset()


def _init_stem_lexicons() -> None:
    global _COLOR_STEMS, _SIZE_STEMS
    stem = _stem()
    _COLOR_STEMS = frozenset(stem(w) for w in COLORS)
    _SIZE_STEMS = frozenset(stem(w) for w in SIZES)


_CATEGORIES = ("All", "Object", "Attribute", "Relation",
               "Color", "Count", "Size")


class SpiceLite:
    """Drop-in for :class:`evalcap.spice.Spice` when no jar is available.

    Same ``compute_score(gts, res) -> (mean_f, [per-image score dicts])``
    shape as the jar wrapper (spice.py:62-65), including the per-category
    breakdowns; ``method()`` says ``SPICE(lite)`` so approximate numbers
    are never mistaken for official SPICE.  Multiple candidate captions
    per image (the AllSPICE surface, eval_spice.py) contribute the UNION
    of their scene graphs, matching the jar's merged-graph semantics."""

    def __init__(self) -> None:
        _init_stem_lexicons()

    @property
    def available(self) -> bool:
        return True

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        img_ids = list(gts.keys())
        scores: List[Dict] = []
        fs: List[float] = []
        for i in img_ids:
            cand = _caption_set(res[i])
            ref = _caption_set(gts[i])
            per = {}
            for cat in _CATEGORIES:
                c = cand if cat == "All" else _category(cand, cat)
                r = ref if cat == "All" else _category(ref, cat)
                per[cat] = _prf(c, r)
            scores.append(per)
            fs.append(per["All"]["f"])
        return float(np.mean(fs)) if fs else 0.0, scores

    def method(self) -> str:
        return "SPICE(lite)"
