"""The on-device CIDEr-D reward of simpleimagecaptionzoo_tpu_torch
(ops/cider.py) and SCST's loss (ops/losses.reward_criterion) against the
JAX package and the host scorer.

Tolerances: the hashes, the tables and the lengths are integers, held
exactly; CIDEr-D scores, the SCST reward and the loss within 1e-6 (rtol
and atol) of the JAX package's (both are float32 sums of the same terms in
other orders); CIDEr-D within 1e-5 of the host ``evalcap/cider_scorer.
CiderD`` (float64 over strings), the bound of
tests/test_cider_device_parity.py, on its corpus construction."""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu import vocab as jax_vocab
from simpleimagecaptionzoo_tpu.evalcap.cider_scorer import CiderD
from simpleimagecaptionzoo_tpu.ops import cider as JC
from simpleimagecaptionzoo_tpu.ops import losses as JL
from simpleimagecaptionzoo_tpu_torch import vocab as port_vocab
from simpleimagecaptionzoo_tpu_torch.ops import cider as TC
from simpleimagecaptionzoo_tpu_torch.ops import losses as TL

TOL = dict(rtol=1e-6, atol=1e-6)
N_IMGS, MAX_REF, LR, LH = 6, 3, 14, 10
V_LO, V_HI = 4, 25


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _words(ids):
    return " ".join(f"w{t}" for t in ids)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_cider_device_parity.py's construction: random references,
    a host df pickle and the tables over the same document frequencies."""
    rng = np.random.default_rng(7)
    refs_ids = []
    for _ in range(N_IMGS):
        n_refs = int(rng.integers(2, MAX_REF + 1))
        refs_ids.append([list(rng.integers(V_LO, V_HI,
                                           int(rng.integers(3, 12))))
                         for _ in range(n_refs)])
    df = {}
    for refs in refs_ids:
        seen = set()
        for ref in refs:
            words = [f"w{t}" for t in ref]
            for n in range(1, 5):
                for i in range(len(words) - n + 1):
                    seen.add(tuple(words[i:i + n]))
        for ng in seen:
            df[ng] = df.get(ng, 0.0) + 1.0
    df_dir = tmp_path_factory.mktemp("cider_df")
    with open(df_dir / "synth-train.p", "wb") as f:
        pickle.dump({"document_frequency": df, "ref_len": N_IMGS}, f,
                    protocol=2)
    ref_arr = np.zeros((N_IMGS, MAX_REF, LR), np.int32)
    ref_lens = np.zeros((N_IMGS, MAX_REF), np.int32)
    for i, refs in enumerate(refs_ids):
        for r, ref in enumerate(refs):
            ref_arr[i, r, :len(ref)] = ref
            ref_lens[i, r] = len(ref)
    hyps = np.zeros((N_IMGS, LH), np.int32)
    hyp_len = np.zeros((N_IMGS,), np.int32)
    for i, refs in enumerate(refs_ids):
        if i % 3 == 0:
            h = list(refs[0])[:LH]
        elif i % 3 == 1:
            h = list(refs[-1])[:LH]
            h[0] = int(rng.integers(V_LO, V_HI))
        else:
            h = list(rng.integers(V_LO, V_HI, int(rng.integers(2, LH))))
        hyps[i, :len(h)] = h
        hyp_len[i] = len(h)
    return dict(refs_ids=refs_ids, df_dir=str(df_dir), ref_arr=ref_arr,
                ref_lens=ref_lens, hyps=hyps, hyp_len=hyp_len)


def _big_tables(refs_ids, n_random=5000):
    """The corpus' n-grams plus ``n_random`` random keys (h1 over all of
    uint32, 0 and 2^32 - 1 among them), so that lookups probe crowded
    buckets and miss as well as hit: (JAX table, port table)."""
    jt = JC.CiderDTable.from_ref_corpus(refs_ids)
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2 ** 32, size=(2, n_random), dtype=np.uint64)
    h[0, :2] = (0, 2 ** 32 - 1)
    h1 = np.concatenate([jt.h1, h[0].astype(np.uint32)])
    h2 = np.concatenate([jt.h2, h[1].astype(np.uint32)])
    df = np.concatenate([jt.df, rng.integers(1, 5, n_random).astype(
        np.float32)])
    return (JC.CiderDTable(h1, h2, df, jt.log_ref_len),
            TC.CiderDTable(h1, h2, df, jt.log_ref_len))


def test_ngram_hashes_bit_exact_against_jax_and_the_host_hash():
    """Ids up to 2^30 - 1 (RewardVocab's OOV range) and 0: h1 and h2 equal
    JAX's at every position, and at every n-gram inside the row equal both
    packages' _hash_ngram_tuple."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 2 ** 30, size=(6, 11)).astype(np.int32)
    ids[0, :4] = (2 ** 30 - 1, 2 ** 30 - 2, 0, 1)
    ids[1] = rng.integers(0, 60, size=11)
    j1, j2 = JC.ngram_hashes(jnp.asarray(ids))
    t1, t2 = TC.ngram_hashes(_t(ids))
    assert t1.dtype == torch.int64 and t1.shape == (6, TC.NGRAM_N, 11)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2).astype(np.int64))
    assert int(t1.min()) >= 0 and int(t1.max()) < 2 ** 32
    for row in range(ids.shape[0]):
        for n in range(1, TC.NGRAM_N + 1):
            for i in range(ids.shape[1] - n + 1):
                ng = tuple(int(x) for x in ids[row, i:i + n])
                want = TC._hash_ngram_tuple(ng)
                assert want == JC._hash_ngram_tuple(ng)
                got = (int(t1[row, n - 1, i]) << 32) | int(t2[row, n - 1, i])
                assert got == int(want), (row, n, i)


def test_fmix32_matches_the_host_finalizer():
    rng = np.random.default_rng(1)
    vals = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                           rng.integers(0, 2 ** 32, 2000)]).astype(np.int64)
    got = TC._fmix32(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(
        got, [TC._fmix32_host(int(v)) for v in vals])
    np.testing.assert_array_equal(
        got, [JC._fmix32_host(int(v)) for v in vals])


def _same_table(jt, tt):
    for name in ("h1", "h2", "df", "bucket_start"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
        assert getattr(tt, name).dtype == getattr(jt, name).dtype, name
    assert (tt.probe, tt.bucket_bits, tt.log_ref_len) == \
        (jt.probe, jt.bucket_bits, jt.log_ref_len)


def test_table_from_corpus_equals_jax(corpus):
    _same_table(JC.CiderDTable.from_ref_corpus(corpus["refs_ids"]),
                TC.CiderDTable.from_ref_corpus(corpus["refs_ids"]))
    jt, tt = _big_tables(corpus["refs_ids"])
    _same_table(jt, tt)
    assert tt.probe > 1


def test_table_merges_duplicate_keys_as_jax_does():
    """Duplicate (h1, h2) keys (two OOV words on one reward id) merge by
    summing df, capped at ref_len."""
    rng = np.random.default_rng(4)
    h1 = rng.integers(0, 2 ** 32, 300, dtype=np.uint64).astype(np.uint32)
    h2 = rng.integers(0, 2 ** 32, 300, dtype=np.uint64).astype(np.uint32)
    h1[10:20], h2[10:20] = h1[0], h2[0]          # ten copies of one key
    h1[50], h2[50] = h1[1], h2[1]
    df = rng.integers(1, 4, 300).astype(np.float32)
    jt = JC.CiderDTable(h1, h2, df, float(np.log(20.0)))
    tt = TC.CiderDTable(h1, h2, df, float(np.log(20.0)))
    _same_table(jt, tt)
    assert len(tt.h1) == 300 - 11
    assert float(tt.df.max()) <= 20.0 + 1e-4


def test_reward_vocab_and_reference_pickle_equal_jax(tmp_path):
    """RewardVocab's ids (OOV words by md5, at or above the vocabulary's
    size, below 2^30) and a table from a reference-format pickle equal the
    JAX package's."""
    words = ["a", "man", "riding", "horse", "on", "beach"]
    vocabs = []
    for mod in (jax_vocab, port_vocab):
        v = mod.Vocabulary()
        for w in ("<pad>", "<sta>", "<end>", "<unk>") + tuple(words[:4]):
            v.add_word(w)
        vocabs.append(v)
    jrv, trv = JC.RewardVocab(vocabs[0]), TC.RewardVocab(vocabs[1])
    sent = words + ["zebra", "xylophone", "a", "zebra"]
    ids = trv.encode(sent)
    assert ids == jrv.encode(sent)
    assert ids[:4] == [4, 5, 6, 7]
    assert all(8 <= i < 2 ** 30 for i in ids[4:8])
    assert ids[6] == ids[9] and ids[8] == 4 and not trv.oov_collisions
    df = {("a",): 3.0, ("a", "man"): 2.0, ("zebra",): 1.0,
          ("on", "beach", "zebra", "a"): 1.0}
    path = tmp_path / "idf.p"
    with open(path, "wb") as f:
        pickle.dump({"document_frequency": df, "ref_len": 5.0}, f,
                    protocol=2)
    _same_table(JC.CiderDTable.from_reference_pickle(str(path), jrv),
                TC.CiderDTable.from_reference_pickle(str(path), trv))


@pytest.mark.parametrize("bucket", [True, False])
def test_idf_lookup_equals_jax_on_both_paths(corpus, bucket):
    """Hits (the table's own keys, h1 = 0 and 2^32 - 1 among them) and
    misses, through the bucket index and through searchsorted (a dict
    without bucket_start): the same idf as the JAX package's, and the two
    paths the same."""
    jt, tt = _big_tables(corpus["refs_ids"])
    rng = np.random.default_rng(9)
    pick = rng.integers(0, len(tt.h1), 400)
    q1 = np.concatenate([tt.h1[pick], tt.h1[:2], rng.integers(
        0, 2 ** 32, 100, dtype=np.uint64).astype(np.uint32)])
    q2 = np.concatenate([tt.h2[pick], tt.h2[:2], tt.h2[:100]])
    jd, td = jt.device_arrays(), tt.device_arrays("cpu")
    if not bucket:
        del jd["bucket_start"], td["bucket_start"]
    want = np.asarray(JC.idf_lookup(jd, jnp.asarray(q1), jnp.asarray(q2),
                                    jt.probe))
    got = TC.idf_lookup(td, _t(q1), _t(q2), tt.probe)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # hits give their df's idf, misses log_ref_len
    assert np.allclose(got.numpy()[:400], tt.log_ref_len - np.log(
        np.maximum(1.0, tt.df[pick])), atol=1e-6)
    if bucket:
        del td["bucket_start"]
        np.testing.assert_array_equal(
            got.numpy(), TC.idf_lookup(td, _t(q1), _t(q2), tt.probe).numpy())


@pytest.mark.parametrize("ref_norms", [False, True])
@pytest.mark.parametrize("bucket", [True, False])
def test_cider_d_device_matches_jax(corpus, bucket, ref_norms):
    """Scores within 1e-6 of the JAX package's on both lookup paths, with
    the references' norms computed in the call or precomputed."""
    jt, tt = _big_tables(corpus["refs_ids"])
    jd, td = jt.device_arrays(), tt.device_arrays("cpu")
    if not bucket:
        del jd["bucket_start"], td["bucket_start"]
    args = [corpus[k] for k in ("hyps", "hyp_len", "ref_arr", "ref_lens")]
    jstats = tstats = None
    if ref_norms:
        jstats = JC.ref_stats_device(
            jd, jt.probe, jnp.asarray(args[2]), jnp.asarray(args[3]),
            JC.ref_norms_device(jd, jt.probe, jnp.asarray(args[2]),
                                jnp.asarray(args[3])))
        norms = TC.ref_norms_device(td, tt.probe, _t(args[2]), _t(args[3]))
        np.testing.assert_allclose(
            norms.numpy(), np.asarray(jstats[1]), **TOL)
        tstats = TC.ref_stats_device(td, tt.probe, _t(args[2]), _t(args[3]),
                                     norms)
    want = np.asarray(JC.cider_d_device(jd, jt.probe,
                                        *map(jnp.asarray, args),
                                        ref_stats=jstats))
    got = TC.cider_d_device(td, tt.probe, *map(_t, args), ref_stats=tstats)
    assert got.dtype == torch.float32 and got.shape == (N_IMGS,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got.max()) > 1.0          # the copies of a reference


def test_cider_d_device_matches_the_host_scorer(corpus):
    """Within 1e-5 of evalcap/cider_scorer.CiderD on the same corpus, the
    table built from the same references."""
    gts = {i: [_words(r) for r in refs]
           for i, refs in enumerate(corpus["refs_ids"])}
    res = [{"image_id": i, "caption": [_words(h[:n])]}
           for i, (h, n) in enumerate(zip(corpus["hyps"],
                                          corpus["hyp_len"]))]
    _, host = CiderD(df="synth-train",
                     df_dir=corpus["df_dir"]).compute_score(gts, res)
    tt = TC.CiderDTable.from_ref_corpus(corpus["refs_ids"])
    got = TC.cider_d_device(tt.device_arrays("cpu"), tt.probe,
                            *(_t(corpus[k]) for k in ("hyps", "hyp_len",
                                                      "ref_arr",
                                                      "ref_lens")))
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-5, atol=1e-5)


def _rows():
    """Sampled-convention rows (zeros from <end> on: all zero, full, one
    PAD draw inside) and greedy-convention rows (<end> then <pad>, none)."""
    sampled = np.array([[5, 6, 7, 0, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0, 0, 0],
                        [5, 5, 5, 5, 5, 5, 5, 5],
                        [9, 0, 8, 0, 0, 0, 0, 0],
                        [7, 0, 0, 0, 0, 0, 0, 0],
                        [4, 12, 13, 14, 15, 0, 0, 0]], np.int64)
    greedy = np.array([[5, 6, 2, 0, 0, 0, 0, 0],
                       [2, 0, 0, 0, 0, 0, 0, 0],
                       [5, 5, 5, 5, 5, 5, 5, 5],
                       [9, 8, 7, 6, 5, 4, 3, 2],
                       [7, 2, 0, 0, 0, 0, 0, 0],
                       [4, 12, 13, 2, 0, 0, 0, 0]], np.int64)
    return sampled, greedy


def test_seq_lengths_equal_jax():
    sampled, greedy = _rows()
    for fn_t, fn_j, rows in ((TC.seq_length_sampled, JC.seq_length_sampled,
                              sampled),
                             (TC.seq_length_greedy, JC.seq_length_greedy,
                              greedy)):
        got = fn_t(torch.from_numpy(rows))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(fn_j(jnp.asarray(rows, jnp.int32))))
    assert TC.seq_length_sampled(torch.from_numpy(sampled)).tolist() == \
        [3, 1, 8, 3, 1, 5]
    assert TC.seq_length_greedy(torch.from_numpy(greedy)).tolist() == \
        [2, 0, 8, 7, 1, 3]


@pytest.mark.parametrize("ref_norms", [False, True])
def test_self_critical_reward_matches_jax(corpus, ref_norms):
    """CIDEr-D(sample) - CIDEr-D(greedy), weighted, within 1e-6; a copy of
    a reference beats its greedy row."""
    jt, tt = _big_tables(corpus["refs_ids"])
    jd, td = jt.device_arrays(), tt.device_arrays("cpu")
    sampled, greedy = _rows()
    sampled[0, :5] = corpus["refs_ids"][0][0][:5]
    sampled[0, 5:] = 0
    ref_arr, ref_lens = corpus["ref_arr"], corpus["ref_lens"]
    jn = tn = None
    if ref_norms:
        jn = JC.ref_norms_device(jd, jt.probe, jnp.asarray(ref_arr),
                                 jnp.asarray(ref_lens))
        tn = TC.ref_norms_device(td, tt.probe, _t(ref_arr), _t(ref_lens))
    want = np.asarray(JC.self_critical_reward(
        jd, jt.probe, jnp.asarray(sampled), jnp.asarray(greedy),
        jnp.asarray(ref_arr), jnp.asarray(ref_lens), cider_weight=0.5,
        ref_norms=jn))
    got = TC.self_critical_reward(td, tt.probe, _t(sampled), _t(greedy),
                                  _t(ref_arr), _t(ref_lens),
                                  cider_weight=0.5, ref_norms=tn)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(got[0]) > 0 and np.any(want != 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("per_step", [False, True])
def test_reward_criterion_matches_jax(weighted, per_step):
    """The shifted ``seq > 0`` mask (the <end> step kept, the rest of the
    row dropped), a (B,) or (B, L) reward, and a sample_weight's filler
    rows out of both the sum and the count: within 1e-6 of JAX's."""
    rng = np.random.default_rng(2)
    sampled, _ = _rows()
    logp = -rng.random(sampled.shape).astype(np.float32) * 5
    reward = rng.normal(size=(sampled.shape[0],) + (
        (sampled.shape[1],) if per_step else ())).astype(np.float32)
    weight = np.array([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    want = float(JL.reward_criterion(
        jnp.asarray(logp), jnp.asarray(sampled, jnp.int32),
        jnp.asarray(reward),
        None if weight is None else jnp.asarray(weight)))
    got = TL.reward_criterion(
        torch.from_numpy(logp), torch.from_numpy(sampled),
        torch.from_numpy(reward),
        None if weight is None else torch.from_numpy(weight))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 + 1e-6 * abs(want)


def test_device_arrays_default_to_the_gpu(corpus):
    """device_arrays() puts the table on the card and raises without one;
    on the CPU the keys are int64 (a key of 2^31 or above stays
    positive and in order)."""
    tt = _big_tables(corpus["refs_ids"])[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.device_arrays()
    td = tt.device_arrays("cpu")
    assert td["h1"].dtype == torch.int64 and td["h2"].dtype == torch.int64
    assert td["bucket_start"].dtype == torch.int32
    assert int(td["h1"][-1]) == 2 ** 32 - 1
    assert bool((td["h1"][1:] >= td["h1"][:-1]).all())
