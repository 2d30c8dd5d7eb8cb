"""Caption vocabulary, kept in step with the JAX package's ``vocab.py``.

Mirrors the reference's ``Caption_Vocabulary``
(ClassRepository/CaptionVocabClass.py:1-19): specials ``<pad>, <sta>, <end>,
<unk>`` first, so their ids are 0/1/2/3.  Vocab pickles written by the
reference, by the JAX package or by this package all load through
:func:`load_vocab`.
"""
from __future__ import annotations

import pickle
from collections import Counter
from typing import Iterable, List

SPECIALS = ("<pad>", "<sta>", "<end>", "<unk>")


class Vocabulary:
    """word <-> index mapping; calling with an OOV word returns ``<unk>``'s id."""

    def __init__(self) -> None:
        self.word2ix: dict = {}
        self.ix2word: dict = {}
        self.idx: int = 0

    def add_word(self, word: str) -> None:
        if word not in self.word2ix:
            self.word2ix[word] = self.idx
            self.ix2word[self.idx] = word
            self.idx += 1

    def __len__(self) -> int:
        return len(self.word2ix)

    def __call__(self, word: str) -> int:
        return self.word2ix.get(word, self.word2ix["<unk>"])

    def encode_tokens(self, tokens: Iterable[str]) -> List[int]:
        """``[<sta>] + tokens + [<end>]`` as ids (reference: Datasets.py:48-52)."""
        ids = [self.word2ix["<sta>"]]
        ids.extend(self(tok) for tok in tokens)
        ids.append(self.word2ix["<end>"])
        return ids

    def decode_ids(self, ids: Iterable[int]) -> List[str]:
        """ids -> words, stopping at ``<end>`` and skipping ``<sta>``
        (reference: Engine.py:288-297)."""
        words = []
        for i in ids:
            word = self.ix2word[int(i)]
            if word in ("<end>", "<pad>"):
                break
            if word != "<sta>":
                words.append(word)
        return words


def build_vocab(token_lists: Iterable[Iterable[str]],
                threshold: int = 5) -> Vocabulary:
    """Build a vocabulary from an iterable of token lists.

    Matches PreProcess/Build_caption_vocab.py:22-45: count train tokens, keep
    words with count >= threshold (in first-seen order), specials first.
    """
    counter: Counter = Counter()
    for tokens in token_lists:
        counter.update(tokens)
    vocab = Vocabulary()
    for sp in SPECIALS:
        vocab.add_word(sp)
    for word, cnt in counter.items():
        if cnt >= threshold:
            vocab.add_word(word)
    return vocab


def save_vocab(vocab: Vocabulary, path: str) -> None:
    """Pickle ``vocab``.  Either package's :func:`load_vocab` reads the
    file: both unpicklers take a ``Vocabulary`` from any module."""
    with open(path, "wb") as f:
        pickle.dump(vocab, f)


class _VocabUnpickler(pickle.Unpickler):
    """Accept pickles whose class lives in the reference repo
    (``ClassRepository.CaptionVocabClass.Caption_Vocabulary``) or in either
    package of this repo."""

    def find_class(self, module, name):  # noqa: D102
        if name in ("Caption_Vocabulary", "Vocabulary"):
            return Vocabulary
        return super().find_class(module, name)


def load_vocab(path: str) -> Vocabulary:
    with open(path, "rb") as f:
        return _VocabUnpickler(f).load()
