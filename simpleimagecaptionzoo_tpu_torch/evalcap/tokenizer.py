"""PTB-compatible caption tokenizer.

The reference tokenizes captions by shelling out to the Stanford CoreNLP
PTBTokenizer jar (coco_caption/pycocoevalcap/tokenizer/ptbtokenizer.py:31-33,
``-preserveLines -lowerCase``) and then removing a fixed punctuation list
(ptbtokenizer.py:24-25).  This module provides:

* :class:`PTBTokenizer` — drop-in replacement with the same interface.  If the
  Stanford jar is present (``SICZ_TPU_CORENLP_JAR`` env var or a jar sitting
  next to this file) it is used for bit-exact official numbers; otherwise a
  pure-Python Treebank tokenizer reproduces its behavior on caption-style
  text (lowercasing, punctuation splitting, contraction splitting, bracket
  normalization) with no subprocess per call.

The pure-Python rules follow the public-domain Penn Treebank ``tokenizer.sed``
conventions (the same source NLTK's TreebankWordTokenizer is derived from);
they are written here from the spec, not copied from any implementation.
"""
from __future__ import annotations

import os
import re
import subprocess
import tempfile
from typing import Dict, List

# Punctuation stripped from tokenized captions — identical list to
# coco_caption/pycocoevalcap/tokenizer/ptbtokenizer.py:24-25.
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]
_PUNCT_SET = frozenset(PUNCTUATIONS)

# ---------------------------------------------------------------------------
# Pure-Python Treebank tokenization
# ---------------------------------------------------------------------------

_RULES_PRE = [
    # starting quotes
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r'([ (\[{<])"'), r"\1 `` "),
    # punctuation
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final period plus optional closing punctuation
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    # brackets -> PTB escapes
    (re.compile(r"\("), r" -LRB- "),
    (re.compile(r"\)"), r" -RRB- "),
    (re.compile(r"\["), r" -LSB- "),
    (re.compile(r"\]"), r" -RSB- "),
    (re.compile(r"\{"), r" -LCB- "),
    (re.compile(r"\}"), r" -RCB- "),
    (re.compile(r"--"), r" -- "),
    # ending quotes
    (re.compile(r'"'), r" '' "),
    (re.compile(r"(\S)('')"), r"\1 \2 "),
    # possessives / contractions with a bare apostrophe
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS2 = [
    re.compile(r"\b(can)(not)\b", re.IGNORECASE),
    re.compile(r"\b(d)('ye)\b", re.IGNORECASE),
    re.compile(r"\b(gim)(me)\b", re.IGNORECASE),
    re.compile(r"\b(gon)(na)\b", re.IGNORECASE),
    re.compile(r"\b(got)(ta)\b", re.IGNORECASE),
    re.compile(r"\b(lem)(me)\b", re.IGNORECASE),
    re.compile(r"\b(more)('n)\b", re.IGNORECASE),
    re.compile(r"\b(wan)(na)(?=\s)", re.IGNORECASE),
]


def ptb_tokenize_line(text: str, lowercase: bool = True) -> List[str]:
    """Tokenize one sentence with Treebank conventions."""
    text = " " + text.strip() + " "
    for pattern, repl in _RULES_PRE:
        text = pattern.sub(repl, text)
    for pattern in _CONTRACTIONS2:
        text = pattern.sub(r" \1 \2 ", text)
    tokens = text.split()
    if lowercase:
        tokens = [t.lower() for t in tokens]
    return tokens


def tokenize_caption(text: str) -> str:
    """Tokenize + strip the coco_caption punctuation list; returns the
    space-joined caption string the metric stack consumes."""
    return " ".join(t for t in ptb_tokenize_line(text) if t not in _PUNCT_SET)


# ---------------------------------------------------------------------------
# Jar passthrough (official numbers when available)
# ---------------------------------------------------------------------------

def find_jar(env_var: str, jar_name: str) -> str:
    """Locate an eval jar: the env var wins, else a jar sitting in this
    package directory (where scripts/get_eval_jars.sh places them), else ""
    (callers fall back to the pure-Python path).  Shared by the PTB/METEOR/
    SPICE wrappers so the lookup rules can't drift apart."""
    jar = os.environ.get(env_var, "")
    if jar and os.path.exists(jar):
        return jar
    local = os.path.join(os.path.dirname(os.path.abspath(__file__)), jar_name)
    return local if os.path.exists(local) else ""


def _find_jar() -> str:
    return find_jar("SICZ_TPU_CORENLP_JAR", "stanford-corenlp-3.4.1.jar")


def java_cmd() -> List[str]:
    """JVM argv prefix for every jar client (PTB/METEOR/SPICE).

    ``SICZ_TPU_JAVA`` overrides (shlex-split, so ``"python fake_jvm.py"``
    works) — used to pin a specific JVM in production and to replay golden
    protocol transcripts in tests without a JVM
    (tests/test_eval_jars.py)."""
    import shlex
    override = os.environ.get("SICZ_TPU_JAVA", "")
    return shlex.split(override) if override else ["java"]


def _jar_tokenize_lines(lines: List[str], jar: str) -> List[str]:
    cmd = java_cmd() + ["-cp", jar, "edu.stanford.nlp.process.PTBTokenizer",
                        "-preserveLines", "-lowerCase"]
    with tempfile.NamedTemporaryFile(delete=False, mode="w", suffix=".txt") as f:
        f.write("\n".join(lines))
        tmp = f.name
    try:
        cmd.append(tmp)
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
        # splitlines, NOT split("\n"): java println-terminates the last
        # line, and the extra empty element would defeat the line-count
        # guard below — silently disabling the jar path forever
        return out.decode("utf-8").splitlines()
    finally:
        os.remove(tmp)


class PTBTokenizer:
    """Interface-compatible with both vendored tokenizers in the reference:

    * coco_caption style: ``tokenize({img_id: [{'caption': str}, ...]})``
      -> ``{img_id: [tokenized_str, ...]}``
    * cider style (``_source='gts'|'res'``): gts dicts may map to plain
      strings or annotation dicts; res is a list of
      ``{'image_id':..., 'caption': [str]}`` entries
      (cider/pyciderevalcap/tokenizer/ptbtokenizer.py:31-92).
    """

    def __init__(self, _source: str = "gts", use_jar: str = "auto") -> None:
        self.source = _source
        self._jar = _find_jar() if use_jar in ("auto", "always") else ""
        if use_jar == "always" and not self._jar:
            raise FileNotFoundError("Stanford CoreNLP jar not found")

    def _tokenize_lines(self, lines: List[str]) -> List[str]:
        lines = [line.replace("\n", " ").replace("\r", " ")
                 for line in lines]
        if self._jar:
            try:
                raw = _jar_tokenize_lines(lines, self._jar)
                out = [" ".join(w for w in line.rstrip().split(" ")
                                if w not in _PUNCT_SET) for line in raw]
                # guard against any jar line-count drift (would silently
                # shift captions onto the wrong images via zip)
                if len(out) == len(lines):
                    return out
            except Exception:
                pass  # fall back to native/pure python below
        # native C++ tokenizer (same rules, multithreaded; native/ dir)
        from simpleimagecaptionzoo_tpu_torch.evalcap import _native
        native_out = _native.ptb_tokenize_lines(lines)
        if native_out is not None and len(native_out) == len(lines):
            return native_out
        return [tokenize_caption(line) for line in lines]

    def tokenize(self, captions_for_image) -> Dict:
        if self.source == "res" and isinstance(captions_for_image, list):
            # cider 'res' source: list of {'image_id', 'caption': [str]}
            ids = [entry["image_id"] for entry in captions_for_image]
            lines = []
            for entry in captions_for_image:
                cap = entry["caption"]
                lines.append(cap[0] if isinstance(cap, list) else cap)
            toks = self._tokenize_lines(lines)
            return [{"image_id": i, "caption": [t]} for i, t in zip(ids, toks)]
        # dict source: {img_id: [caption-entries]}
        image_ids, lines = [], []
        for img_id, entries in captions_for_image.items():
            for entry in entries:
                image_ids.append(img_id)
                if isinstance(entry, dict):
                    lines.append(entry.get("caption", ""))
                else:
                    lines.append(entry)
        toks = self._tokenize_lines(lines)
        out: Dict = {}
        for img_id, tok in zip(image_ids, toks):
            out.setdefault(img_id, []).append(tok)
        return out
