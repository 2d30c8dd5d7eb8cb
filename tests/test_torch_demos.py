"""The port's two demos (``simpleimagecaptionzoo_tpu_torch/examples/
demo_e2e.py``, ``demo_scst.py``) against the JAX package's
(``examples/demo_e2e.py``, ``examples/demo_scst.py``).

Holds: on ``demo_e2e``'s data and ``ModelConfig`` (BUTDDetection, its
default, and AoADetection, the card's recipe), with the params of 20 of
the JAX demo's own XE steps carried across (``convert.from_jax``), the
port's greedy (max_len 9) and beam-3 (12 steps) ids are identical to the
JAX package's decode, and the port's CIDEr-D and BLEU of those captions
are identical to the JAX scorers'; three updates of the port's
clamp-then-Adam (``demo_e2e.make_optimizer``) match optax's
``chain(clip(0.1), adam(4e-3))`` within 1e-6 on the same gradients; each
demo's data is the JAX demo's (numpy seed 0); each demo reaches its
``DEMO_RESULT:`` line on the CPU at a few steps."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simpleimagecaptionzoo_tpu.config import ModelConfig as JaxModelConfig
from simpleimagecaptionzoo_tpu.evalcap.bleu import Bleu as JBleu
from simpleimagecaptionzoo_tpu.evalcap.cider_scorer import CiderD as JCiderD
from simpleimagecaptionzoo_tpu.models.base import get_captioner as jax_get
from simpleimagecaptionzoo_tpu.ops import decode as jdecode
from simpleimagecaptionzoo_tpu.ops.cider import RewardVocab as JRewardVocab
from simpleimagecaptionzoo_tpu.ops.losses import (
    label_smoothing_loss as j_label_smoothing_loss,
    xe_mask_from_lengths as j_xe_mask_from_lengths)
from simpleimagecaptionzoo_tpu.vocab import build_vocab as j_build_vocab
from simpleimagecaptionzoo_tpu_torch.convert import from_jax
from simpleimagecaptionzoo_tpu_torch.examples import demo_e2e, demo_scst
from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
from simpleimagecaptionzoo_tpu_torch.ops import decode

CFG_KEYS = ("model_type", "vocab_size", "embed_dim", "hidden_dim",
            "atten_dim", "enc_dim", "num_heads", "num_refine_layers",
            "enc_img_size")
JAX_STEPS = 20


def _jax_cfg(cfg):
    return JaxModelConfig(**{k: getattr(cfg, k) for k in CFG_KEYS})


def _jax_trained(model_name):
    """The JAX demo's model after JAX_STEPS of its own XE loop (examples/
    demo_e2e.py:57-99), its visual input and the demo's data."""
    data = demo_e2e.demo_data(model_name)
    model = jax_get(_jax_cfg(data["cfg"]))
    params = model.init_params(jax.random.PRNGKey(0), include_cnn=False)
    feats, caps, lens = data["feats"], data["caps"], data["lens"]
    visual = {"bu_feats": jnp.asarray(feats),
              "bu_masks": jnp.ones(feats.shape[:2], jnp.float32)}
    tx = optax.chain(optax.clip(0.1), optax.adam(4e-3))
    opt_state = tx.init(params)

    @jax.jit
    def train_step(params, opt_state, rng):
        def loss_fn(p):
            enc, _ = model.encode(p, visual, train=True, rng=rng)
            logits = jdecode.teacher_forced_logits(
                model, p, enc, jnp.asarray(caps, jnp.int32), 0.0, rng)
            mask = j_xe_mask_from_lengths(jnp.asarray(lens),
                                          data["t_max"] - 1)
            return j_label_smoothing_loss(logits, jnp.asarray(caps[:, 1:]),
                                          mask, 0.1)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    key = jax.random.PRNGKey(1)
    for _ in range(JAX_STEPS):
        key, sub = jax.random.split(key)
        params, opt_state, _ = train_step(params, opt_state, sub)
    return model, params, visual, data


def _jax_scores(vocab, cls, greedy_ids, beam_ids):
    """The JAX demo's scoring (examples/demo_e2e.py:106-121)."""
    phrases = demo_e2e.PHRASES
    gts, res_g, res_b = {}, [], []
    n_correct = 0
    for i in range(len(cls)):
        truth = " ".join(phrases[cls[i]])
        g = " ".join(vocab.decode_ids(np.asarray(greedy_ids[i])))
        b = " ".join(vocab.decode_ids(np.asarray(beam_ids[i])))
        gts[i] = [truth]
        res_g.append({"image_id": i, "caption": [g]})
        res_b.append({"image_id": i, "caption": [b]})
        n_correct += int(g == truth)
    cider_g, _ = JCiderD(df="corpus").compute_score(gts, res_g)
    cider_b, _ = JCiderD(df="corpus").compute_score(gts, res_b)
    bleu, _ = JBleu(4).compute_score(gts, {e["image_id"]: e["caption"]
                                           for e in res_b})
    return cider_g, cider_b, bleu, n_correct


def test_demo_data_is_the_jax_demos():
    """examples/demo_e2e.py:38-57 and examples/demo_scst.py:170-195 with
    numpy seed 0: the same vocabulary, features, captions and references."""
    jvocab = j_build_vocab(demo_e2e.PHRASES * 5, threshold=1)
    for mod in (demo_e2e, demo_scst):
        assert mod.PHRASES == [["a", "man", "rides", "a", "horse"],
                               ["a", "dog", "runs", "on", "the", "beach"],
                               ["two", "birds", "fly", "over", "water"],
                               ["a", "red", "car", "parked", "outside"]]
    d = demo_e2e.demo_data("BUTDDetection")
    assert d["vocab"].word2ix == jvocab.word2ix
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(32, 36, 64)).astype(np.float32)
    cls = rng.integers(0, 4, size=(32,))
    feats[:, 0, :4] = np.eye(4, dtype=np.float32)[cls] * 5.0
    np.testing.assert_array_equal(d["feats"], feats)
    np.testing.assert_array_equal(d["cls"], cls)
    for i in range(32):
        ids = jvocab.encode_tokens(demo_e2e.PHRASES[cls[i]])
        assert d["caps"][i, :len(ids)].tolist() == ids
        assert d["lens"][i] == len(ids) - 1
    s = demo_scst.demo_data()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(32, 16, 64)).astype(np.float32)
    cls = rng.integers(0, 4, size=(32,))
    feats[:, 0, :4] = np.eye(4, dtype=np.float32)[cls] * 5.0
    np.testing.assert_array_equal(s["feats"], feats)
    jreward = JRewardVocab(jvocab)
    for i in range(32):
        ids = jvocab.encode_tokens(demo_e2e.PHRASES[cls[i]])
        assert s["caps"][i, :len(ids)].tolist() == ids
        assert s["lens"][i] == len(ids)
        ref = jreward.encode(demo_e2e.PHRASES[cls[i]])
        assert s["ref_ids"][i, 0, :len(ref)].tolist() == ref
        assert s["ref_lens"][i].tolist() == [len(ref), 0, 0, 0, 0]
    assert s["cfg"].model_type == "BUTDDetection" and s["cfg"].enc_dim == 64


@pytest.mark.parametrize("model_name", ["BUTDDetection", "AoADetection"])
def test_decodes_and_scores_are_the_jax_packages(model_name):
    jm, jparams, jvisual, data = _jax_trained(model_name)
    enc, _ = jm.encode(jparams, jvisual, train=False)
    j_greedy, _ = jdecode.greedy(jm, jparams, enc, max_len=9)
    j_beam = jdecode.beam_search(jm, jparams, enc, beam_size=3, max_steps=12)
    j_greedy, j_beam = np.asarray(j_greedy), np.asarray(j_beam)

    tm = get_captioner(data["cfg"])
    tparams = from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    visual = demo_e2e.demo_visual(model_name, data["feats"], "cpu")
    with torch.inference_mode():
        tenc, _ = tm.encode(tparams, visual, train=False)
        t_greedy, _ = decode.greedy(tm, tparams, tenc, max_len=9)
        t_beam = decode.beam_search(tm, tparams, tenc, beam_size=3,
                                    max_steps=12)
    np.testing.assert_array_equal(t_greedy.numpy(), j_greedy)
    np.testing.assert_array_equal(t_beam.numpy(), j_beam)
    # the trained model's captions are neither all right nor all empty
    caps = {" ".join(data["vocab"].decode_ids(r)) for r in j_greedy.tolist()}
    assert len(caps) > 1

    jvocab = j_build_vocab(demo_e2e.PHRASES * 5, threshold=1)
    want = _jax_scores(jvocab, data["cls"], j_greedy, j_beam)
    with contextlib.redirect_stdout(io.StringIO()):
        got = demo_e2e.score(data["vocab"], demo_e2e.PHRASES, data["cls"],
                             t_greedy, t_beam)
    assert got[0] == want[0] and got[1] == want[1]      # CIDEr-D
    assert got[2] == want[2]                            # BLEU-1..4
    assert got[3] == want[3]                            # exact matches
    assert 0 < want[0] < 10


def test_clamp_then_adam_matches_optax():
    data = demo_e2e.demo_data("BUTDDetection")
    jm = jax_get(_jax_cfg(data["cfg"]))
    jparams = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), include_cnn=False))
    tx = optax.chain(optax.clip(0.1), optax.adam(4e-3))
    j_state = tx.init(jparams)
    tm = get_captioner(data["cfg"])
    tparams = from_jax(jparams)
    t_state, update = demo_e2e.make_optimizer(tm, tparams)
    rng = np.random.default_rng(5)
    for _ in range(3):
        # gradients on both sides of the clamp
        grads = jax.tree_util.tree_map(
            lambda p: (0.3 * rng.normal(size=p.shape)).astype(np.float32),
            jparams)
        upd, j_state = tx.update(grads, j_state)
        jparams = optax.apply_updates(jparams, upd)
        tparams, t_state = update(tparams, from_jax(grads), t_state)
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tparams))
    assert len(flat_j) == len(flat_t) > 10
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mod,argv", [
    (demo_e2e, ["--steps", "3"]),
    (demo_e2e, ["--steps", "3", "--model", "AoADetection"]),
    (demo_scst, ["--xe_steps", "3", "--scst_steps", "2"])])
def test_demo_reaches_its_result_line_on_the_cpu(mod, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main(argv + ["--gpu_id", "cpu"])
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("DEMO_RESULT: ")]
    assert len(lines) == 1 and lines[0].split()[1] in ("OK", "WEAK")
    assert rc == (0 if lines[0].endswith("OK") else 1)
