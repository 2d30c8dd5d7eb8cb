"""On-device CIDEr-D reward for SCST.

Counterpart of the JAX package's ``ops/cider.py``.  The reference scores
each SCST batch on the host (decode ids -> strings -> n-gram dicts ->
CiderD -> back to the card, Utils.py:319-367); here the whole reward is a
function of int64 token ids on the card:

* n-grams are identified by a pair of independent 32-bit polynomial hashes,
  h1 finished by murmur3's fmix32 (bijective on 32 bits), both the same
  bits as the JAX package's (``HASH_VERSION``), so a table built by either
  package serves the other;
* the idf table is the sorted keys (h1, h2) and their document frequencies
  on the card, with a bucket index over h1's top bits: a lookup is one
  gather for the bucket start and ``probe`` independent gathers comparing
  both hashes.  An n-gram absent from the table gets df 0, idf
  ``log_ref_len`` (ciderD_scorer.py:152);
* a sentence's term frequencies and the clipped cosine against each
  reference come from position-wise hash-equality tests, (B, R, 4, L, Lr)
  booleans, small at SCST's shapes (L 20, Lr 32).

The semantics are ciderD_scorer.py:127-206's: clipping ``min(tf_h, tf_r) *
tf_r`` on idf-weighted vectors, per-n L2 norms, a gaussian length penalty
(sigma 6) on the bigram-count length, the mean over n = 1..4 and over the
references, times 10.

PyTorch has few operations on uint32, so the hashes are int64 holding
values below 2^32: each product is split so that no intermediate passes
2^63, and the result is masked to 32 bits; ``>>`` is then logical.  The
table keeps h1 and h2 as int64 on the card for the same reason: as int32
the keys of 2^31 and above would sort, and ``searchsorted`` would find
them, in the wrong order.

The host half (:class:`RewardVocab`, :class:`CiderDTable`) is numpy, a copy
of the JAX package's.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from simpleimagecaptionzoo_tpu_torch import END_ID
from simpleimagecaptionzoo_tpu_torch.device import resolve_device

NGRAM_N = 4
_MULT1 = 1000003
_SEED1 = 2166136261
_MULT2 = 16777619
_SEED2 = 0x9E3779B9
_FMIX_M1 = 0x85EBCA6B
_FMIX_M2 = 0xC2B2AE35
_MASK32 = 0xFFFFFFFF

# Version of the (h1, h2) key derivation, the JAX package's: v2 finishes
# h1 with the fmix32 avalanche, so that consecutive ids do not pile into a
# few buckets of the top-bits index.
HASH_VERSION = 2


def _fmix32_host(h: int) -> int:
    h ^= h >> 16
    h = (h * _FMIX_M1) & _MASK32
    h ^= h >> 13
    h = (h * _FMIX_M2) & _MASK32
    return h ^ (h >> 16)


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 ``h`` in [0, 2^32) and a constant ``m``
    below 2^32, with no intermediate above 2^49: h = hi 2^16 + lo, and only
    the low 16 bits of hi * m survive the shift."""
    hi, lo = h >> 16, h & 0xFFFF
    return ((((hi * m) & 0xFFFF) << 16) + lo * m) & _MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on int64 tensors holding uint32 values (the
    device twin of :func:`_fmix32_host`)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX_M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX_M2)
    return h ^ (h >> 16)


# ---------------------------------------------------------------------------
# host: the reward vocabulary (OOV-safe) and the idf table
# ---------------------------------------------------------------------------

class RewardVocab:
    """Words -> reward ids: a caption-vocabulary word keeps its id; an
    out-of-vocabulary reference word gets an id at or above the vocabulary's
    size from an md5 of the word (not from the order words are met), so two
    instances in two processes agree, and no generated token (always below
    the vocabulary's size) can match it.  Ids stay below 2^30, so (id + 1)
    fits 32 bits.  Two OOV words that share an id are recorded in
    ``oov_collisions``; their n-grams merge in the table (their dfs add)."""

    def __init__(self, vocab) -> None:
        self._word2ix = dict(vocab.word2ix)
        self._base = len(self._word2ix)
        self._span = (1 << 30) - self._base
        self._oov_id2word: dict = {}
        self.oov_collisions: set = set()

    def encode(self, words: Sequence[str]) -> List[int]:
        import hashlib
        out = []
        for w in words:
            ix = self._word2ix.get(w)
            if ix is None:
                h = int.from_bytes(
                    hashlib.md5(w.encode("utf-8")).digest()[:8], "little")
                ix = self._base + (h % self._span)
                prev = self._oov_id2word.setdefault(ix, w)
                if prev != w:
                    self.oov_collisions.add((prev, w))
            out.append(ix)
        return out


def _hash_ngram_tuple(ng: tuple) -> np.uint64:
    """(h1 << 32) | h2 of one n-gram of token ids, in Python integers: the
    host twin of :func:`ngram_hashes`."""
    h1, h2 = _SEED1, _SEED2
    for t in ng:
        h1 = (h1 * _MULT1 + int(t) + 1) & _MASK32
        h2 = (h2 * _MULT2 + int(t) + 1) & _MASK32
    return np.uint64((_fmix32_host(h1) << 32) | h2)


class CiderDTable:
    """The idf table on the host; :meth:`device_arrays` puts it on the card
    once."""

    def __init__(self, h1: np.ndarray, h2: np.ndarray, df: np.ndarray,
                 log_ref_len: float) -> None:
        # duplicate (h1, h2) keys (two OOV words on one RewardVocab id) are
        # merged by summing their df, capped at ref_len so that no idf
        # goes negative; unmerged, a lookup would return either row
        key = (np.asarray(h1, np.uint64) << np.uint64(32)) | np.asarray(
            h2, np.uint64)
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) < len(key):
            df = np.bincount(inv, weights=np.asarray(df, np.float64))
            df = np.minimum(df, np.exp(float(log_ref_len)))
            h1 = (uniq >> np.uint64(32)).astype(np.uint32)
            h2 = (uniq & np.uint64(_MASK32)).astype(np.uint32)
        order = np.lexsort((h2, h1))
        self.h1 = np.asarray(h1, np.uint32)[order]
        self.h2 = np.asarray(h2, np.uint32)[order]
        self.df = np.asarray(df, np.float32)[order]
        self.log_ref_len = float(log_ref_len)
        # the bucket index: h1's space in about 2n power-of-two buckets by
        # its top bits; bucket_start[b] is the first sorted position in
        # bucket b, and probe the fullest bucket's count
        n = len(self.h1)
        bits = max(1, min(23, int(np.ceil(np.log2(max(2 * n, 2))))))
        self.bucket_bits = bits
        bounds = np.arange((1 << bits) + 1, dtype=np.int64) << (32 - bits)
        self.bucket_start = np.searchsorted(
            self.h1.astype(np.int64), bounds).astype(np.int32)
        self.probe = int(np.diff(self.bucket_start).max()) if n else 1

    @classmethod
    def from_ref_corpus(cls, images_token_ids: Iterable[List[List[int]]]
                        ) -> "CiderDTable":
        """Per image, a list of reference sentences, each a list of
        (RewardVocab) token ids.  An n-gram's document frequency is the
        number of images whose references hold it (ciderD_scorer.py:
        113-118)."""
        df: Dict[np.uint64, float] = {}
        rep: Dict[np.uint64, tuple] = {}   # hash -> one n-gram with it
        n_images = 0
        for refs in images_token_ids:
            n_images += 1
            seen = {}
            for ref in refs:
                arr = np.asarray(ref, dtype=np.int64)
                for n in range(1, NGRAM_N + 1):
                    for i in range(len(arr) - n + 1):
                        ng = tuple(int(t) for t in arr[i:i + n])
                        seen[_hash_ngram_tuple(ng)] = ng
            for h, ng in seen.items():
                prev = rep.setdefault(h, ng)
                if prev != ng:
                    raise ValueError(
                        f"64-bit ngram hash collision: {prev} vs {ng} — "
                        "idf table would merge distinct ngrams")
                df[h] = df.get(h, 0.0) + 1.0
        keys = np.array(sorted(df.keys()), dtype=np.uint64)
        h1 = (keys >> np.uint64(32)).astype(np.uint32)
        h2 = (keys & np.uint64(_MASK32)).astype(np.uint32)
        vals = np.array([df[k] for k in keys], dtype=np.float32)
        return cls(h1, h2, vals, float(np.log(max(float(n_images), 1.0))))

    @classmethod
    def from_reference_pickle(cls, path: str, reward_vocab: RewardVocab
                              ) -> "CiderDTable":
        """A reference-format idf pickle ({'ref_len': float,
        'document_frequency': {word-tuple: df}},
        PreProcess/CIDEr_idf_preproccess.py:41-82)."""
        import pickle
        with open(path, "rb") as f:
            pkl = pickle.load(f, encoding="latin1")
        h1s, h2s, vals = [], [], []
        rep: Dict[np.uint64, tuple] = {}
        for ngram, dfv in pkl["document_frequency"].items():
            ids = tuple(reward_vocab.encode(list(ngram)))
            h = _hash_ngram_tuple(ids)
            prev = rep.setdefault(h, ids)
            if prev != ids:
                raise ValueError(f"64-bit ngram hash collision: {prev} vs "
                                 f"{ids} for word ngram {ngram!r}")
            h1s.append(int(h >> np.uint64(32)))
            h2s.append(int(h & np.uint64(_MASK32)))
            vals.append(dfv)
        return cls(np.array(h1s, np.uint32), np.array(h2s, np.uint32),
                   np.array(vals, np.float32),
                   float(np.log(float(pkl["ref_len"]))))

    def device_arrays(self, device="cuda") -> dict:
        """The table as tensors on ``device`` (the GPU unless the caller
        asks for the CPU): h1 and h2 int64 (uint32 values), df float32,
        bucket_start int32, log_ref_len a float32 scalar."""
        dev = resolve_device(device)
        return {
            "h1": torch.from_numpy(self.h1.astype(np.int64)).to(dev),
            "h2": torch.from_numpy(self.h2.astype(np.int64)).to(dev),
            "df": torch.from_numpy(self.df).to(dev),
            "bucket_start": torch.from_numpy(self.bucket_start).to(dev),
            "log_ref_len": torch.tensor(self.log_ref_len,
                                        dtype=torch.float32, device=dev),
        }


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------

def ngram_hashes(ids: torch.Tensor):
    """ids (..., L) integer -> (h1, h2), each (..., NGRAM_N, L) int64
    holding uint32 values: the hashes of the n-gram *starting* at each
    position.  An n-gram that runs off the end wraps round (``roll``), as
    the JAX package's does; callers mask those positions by length."""
    x = (ids.long() + 1) & _MASK32
    h1 = torch.full_like(x, _SEED1)
    h2 = torch.full_like(x, _SEED2)
    h1s, h2s = [], []
    for n in range(NGRAM_N):
        shifted = torch.roll(x, -n, dims=-1) if n else x
        # products below 2^52 and 2^56: exact in int64
        h1 = (h1 * _MULT1 + shifted) & _MASK32
        h2 = (h2 * _MULT2 + shifted) & _MASK32
        # the rolling state stays raw; each finished n-gram is mixed once
        h1s.append(_fmix32(h1))
        h2s.append(h2)
    return torch.stack(h1s, dim=-2), torch.stack(h2s, dim=-2)


def idf_lookup(table: dict, h1: torch.Tensor, h2: torch.Tensor,
               probe: int) -> torch.Tensor:
    """idf = log_ref_len - log(max(1, df)) of each queried hash pair.

    With ``bucket_start`` (the :class:`CiderDTable` layout) a query starts
    at its bucket, h1's top ``bits`` bits, and ``probe`` gathers follow,
    each independent of the others, their positions clamped to the table's
    last.  Equal hashes share a bucket, so no bucket-end test is needed.
    A dict without ``bucket_start`` starts each query at
    ``searchsorted(h1)`` instead; the results are the same."""
    t1, t2, df = table["h1"], table["h2"], table["df"]
    m = t1.shape[0]
    if "bucket_start" in table:
        bstart = table["bucket_start"]
        bits = (bstart.shape[0] - 1).bit_length() - 1
        pos = bstart[h1 >> (32 - bits)].long()
    else:
        pos = torch.searchsorted(t1, h1.contiguous(), side="left")
    found = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    for j in range(probe):
        idx = torch.clamp(pos + j, max=m - 1)
        hit = (t1[idx] == h1) & (t2[idx] == h2)
        found = torch.where(hit, df[idx], found)
    return table["log_ref_len"] - torch.log(torch.clamp(found, min=1.0))


def _valid(lengths: torch.Tensor, l: int) -> torch.Tensor:
    """(B,) lengths -> (B, NGRAM_N, L): the n-gram starting at a position
    lies inside the sentence."""
    pos = torch.arange(l, device=lengths.device)
    ncount = torch.arange(1, NGRAM_N + 1, device=lengths.device)
    return (pos[None, None, :] + ncount[None, :, None]) <= lengths[:, None,
                                                                   None]


def _sentence_stats(ids: torch.Tensor, length: torch.Tensor, table: dict,
                    probe: int):
    """ids (B, L), length (B,) -> per position: valid, tf, w = tf * idf,
    idf (each (B, 4, L)), the norms (B, 4), h1, h2."""
    h1, h2 = ngram_hashes(ids)
    valid = _valid(length, ids.shape[-1])
    # tf by pairwise hash equality within the sentence
    same = ((h1[..., :, None] == h1[..., None, :])
            & (h2[..., :, None] == h2[..., None, :]))          # (B,4,L,L)
    same = same & valid[..., None, :] & valid[..., :, None]
    tf = same.sum(dim=-1).float()                              # (B,4,L)
    idf = idf_lookup(table, h1, h2, probe)
    w = tf * idf
    # norm^2 = the sum over distinct n-grams of w^2 = over positions w^2/tf
    contrib = torch.where(valid & (tf > 0),
                          (w * w) / torch.clamp(tf, min=1.0), 0.0)
    norms = torch.sqrt(contrib.sum(dim=-1))                    # (B,4)
    return valid, tf, w, idf, norms, h1, h2


def ref_norms_device(table: dict, probe: int, ref_ids: torch.Tensor,
                     ref_lens: torch.Tensor) -> torch.Tensor:
    """The references' tf-idf norms (B, R, 4).  They are all that the
    references' idf lookups feed (a match takes the hypothesis' idf), and
    the references are fixed per image, so a trainer computes them once
    and ships them in the batch: the step then never looks a reference up
    in the table."""
    b, r, lr = ref_ids.shape
    norms = _sentence_stats(ref_ids.reshape(b * r, lr),
                            ref_lens.reshape(b * r), table, probe)[4]
    return norms.reshape(b, r, NGRAM_N)


def ref_stats_device(table: dict, probe: int, ref_ids: torch.Tensor,
                     ref_lens: torch.Tensor,
                     ref_norms: torch.Tensor = None):
    """(valid, norms, h1, h2) of (B, R, Lr) reference ids, made once and
    shared by both :func:`cider_d_device` calls of the SCST reward.  With
    ``ref_norms`` (B, R, 4) given the table is not read."""
    b, r, lr = ref_ids.shape
    flat_ids, flat_len = ref_ids.reshape(b * r, lr), ref_lens.reshape(b * r)
    if ref_norms is None:
        rv, _, _, _, rnorm, rh1, rh2 = _sentence_stats(flat_ids, flat_len,
                                                       table, probe)
        rnorm = rnorm.reshape(b, r, NGRAM_N)
    else:
        rh1, rh2 = ngram_hashes(flat_ids)
        rv = _valid(flat_len, lr)
        rnorm = ref_norms
    shape = (b, r, NGRAM_N, lr)
    return rv.reshape(shape), rnorm, rh1.reshape(shape), rh2.reshape(shape)


def cider_d_device(table: dict, probe: int, hyp_ids: torch.Tensor,
                   hyp_len: torch.Tensor, ref_ids: torch.Tensor,
                   ref_lens: torch.Tensor, sigma: float = 6.0,
                   ref_stats=None) -> torch.Tensor:
    """CIDEr-D scores (B,) float32.  hyp_ids (B, L), hyp_len (B,); ref_ids
    (B, R, Lr) padded, an unused reference of length 0; ref_lens (B, R).
    ``ref_stats``: :func:`ref_stats_device`'s output, when the caller
    shares one between calls."""
    hv, htf, hw, hidf, hnorm, hh1, hh2 = _sentence_stats(hyp_ids, hyp_len,
                                                         table, probe)
    if ref_stats is None:
        ref_stats = ref_stats_device(table, probe, ref_ids, ref_lens)
    rv, rnorm, rh1, rh2 = ref_stats
    # hypothesis positions against reference positions: (B, R, 4, L, Lr)
    eq = ((hh1[:, None, :, :, None] == rh1[:, :, :, None, :])
          & (hh2[:, None, :, :, None] == rh2[:, :, :, None, :]))
    eq = eq & hv[:, None, :, :, None] & rv[:, :, :, None, :]
    # the hypothesis n-gram's tf in the reference (0 where absent), and its
    # weight there: idf is the n-gram's, so the hypothesis' own
    ref_w_of_hyp = eq.sum(dim=-1).float() * hidf[:, None]      # (B,R,4,L)
    # the clipped product over distinct hypothesis n-grams: over positions
    # min(hw, rw) * rw / htf
    clipped = torch.minimum(hw[:, None], ref_w_of_hyp) * ref_w_of_hyp
    num = (torch.where(htf[:, None] > 0,
                       clipped / torch.clamp(htf[:, None], min=1.0), 0.0)
           * hv.float()[:, None]).sum(dim=-1)                  # (B,R,4)
    denom = hnorm[:, None] * rnorm
    val = torch.where(denom > 0, num / torch.clamp(denom, min=1e-12), 0.0)
    # the gaussian length penalty on bigram-count lengths
    len_h = torch.clamp(hyp_len - 1, min=0).float()
    len_r = torch.clamp(ref_lens - 1, min=0).float()
    delta = len_h[:, None] - len_r                             # (B,R)
    val = val * torch.exp(-(delta ** 2) / (2 * sigma ** 2))[:, :, None]
    # a reference of length 0 is padding: it adds 0 and is not counted
    ref_real = (ref_lens > 0).float()
    val = val * ref_real[:, :, None]
    n_refs = torch.clamp(ref_real.sum(dim=-1), min=1.0)
    return val.sum(dim=1).mean(dim=-1) / n_refs * 10.0


# ---------------------------------------------------------------------------
# the SCST reward
# ---------------------------------------------------------------------------

def seq_length_sampled(seq: torch.Tensor) -> torch.Tensor:
    """The sampled rollout's length: its ids are zeroed from the ``<end>``
    step on, and the reference keeps everything up to the last nonzero id
    (Utils.py:336-341); an all-zero row keeps 1 (its ``<pad>``).
    (B, L) -> (B,) int64."""
    nonzero = seq > 0
    last = torch.argmax(torch.flip(nonzero, dims=[-1]).int(), dim=-1)
    return torch.where(nonzero.any(dim=-1), seq.shape[-1] - last, 1)


def seq_length_greedy(seq: torch.Tensor) -> torch.Tensor:
    """Greedy decode keeps the words before the first ``<end>``
    (Utils.py:349-356).  (B, L) -> (B,) int64."""
    is_end = seq == END_ID
    return torch.where(is_end.any(dim=-1),
                       torch.argmax(is_end.int(), dim=-1), seq.shape[-1])


def self_critical_reward(table: dict, probe: int, sample_seq: torch.Tensor,
                         greedy_seq: torch.Tensor, ref_ids: torch.Tensor,
                         ref_lens: torch.Tensor, cider_weight: float = 1.0,
                         ref_norms: torch.Tensor = None) -> torch.Tensor:
    """reward (B,) = CIDEr-D(sample) - CIDEr-D(greedy) (Utils.py:359-364).
    ``ref_norms`` (B, R, 4), precomputed by :func:`ref_norms_device`, keeps
    the references out of the table."""
    rstats = ref_stats_device(table, probe, ref_ids, ref_lens, ref_norms)
    s_scores = cider_d_device(table, probe, sample_seq,
                              seq_length_sampled(sample_seq), ref_ids,
                              ref_lens, ref_stats=rstats)
    g_scores = cider_d_device(table, probe, greedy_seq,
                              seq_length_greedy(greedy_seq), ref_ids,
                              ref_lens, ref_stats=rstats)
    return cider_weight * (s_scores - g_scores)
