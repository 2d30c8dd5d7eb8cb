"""Decode loops derived from a captioner's step.

Counterpart of the JAX package's ``ops/decode.py``:

* :func:`greedy` — argmax decode, stopping once every lane has ended;
* :func:`beam_search` — batched fixed-k beam search.  The reference runs
  beam search per sentence with dynamic beam shrinking (NIC_Model.py:
  153-212).  As in the JAX package, the shrinking-k semantics are kept with
  fixed shapes: candidates ranked at or beyond the beams still open are
  killed, and finished beams are parked in a per-sample pool.  The pick is
  the best finished beam by raw cumulative log-probability (no length
  normalization), else the best live beam, as in the reference.

* :func:`teacher_forced_logits` — the XE training forward: one step per
  caption position with the ground truth (or, with scheduled sampling, a
  draw from the model's own previous prediction) as input, the prediction
  head hoisted out of the loop; :func:`_categorical` is its sampler.
* :func:`sample_rl` — SCST's multinomial rollout, its head hoisted the
  same way, and :func:`replay_logprobs`, the same rollout's log-probs
  recomputed from its ids by teacher forcing.

The decode loops are eager Python: each step ends in one host sync, the
test of whether any lane is still open.  Teacher forcing and the rollout
run a fixed number of steps and never sync.

On the mesh's model axis (``parallel/vocab_shard.py``) the params hold this
process's vocab shard of the head: the fused head's top-k is K1 on the
shard merged across the model group (``vocab_shard.topk_merge``), the
rescoring's log-softmax reads the gathered logits, and ``model.predict``
gathers them itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
from simpleimagecaptionzoo_tpu_torch.models.base import (Captioner, Encoded,
                                                         _tree_map)
from simpleimagecaptionzoo_tpu_torch.ops import fused_head
from simpleimagecaptionzoo_tpu_torch.parallel import global_rand, vocab_shard

_NEG = -1e18


def greedy(model: Captioner, params, encoded: Encoded, max_len: int = 20
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (ids (B, max_len) int64, alphas (B, max_len, N) float32 or
    None).

    Each step ends in the fused head top-k with k=1 (kernel K1 on the
    card), so the (B, V) logits are never materialized.  The loop stops as
    soon as every lane has emitted ``<end>``; a lane is padded with
    ``<pad>`` after its ``<end>``, and a finished lane's alphas are zero, so
    the output does not depend on how long other lanes keep the loop
    alive."""
    mean = encoded.mean
    b, dev = mean.shape[0], mean.device
    head = _prepare_head(model, params, mean.dtype)
    state = model.init_state(params, encoded)
    tok = torch.full((b,), STA_ID, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    ids = torch.full((b, max_len), PAD_ID, dtype=torch.long, device=dev)
    alphas = None
    for t in range(max_len):
        hidden, state, alpha = model.step_core(params, encoded, state, tok)
        nxt = vocab_shard.topk_merge(head, hidden, 1)[1][:, 0].long()
        nxt = torch.where(finished, PAD_ID, nxt)
        ids[:, t] = nxt
        if alpha is not None:
            if alphas is None:
                alphas = torch.zeros((b, max_len) + tuple(alpha.shape[1:]),
                                     dtype=torch.float32, device=dev)
            alphas[:, t] = torch.where(finished[:, None], 0.0, alpha.float())
        finished = finished | (nxt == END_ID)
        tok = nxt
        if bool(finished.all()):
            break
    return ids, alphas


def _prepare_head(model: Captioner, params, dtype) -> fused_head.Head:
    """The fused head of ``params`` (this process's vocab shard on a model
    axis), prepared once a decode."""
    vocab_shard.check_shard(params["predict"], model.config.vocab_size)
    return fused_head.prepare_head(params["predict"], dtype)


def sequence_logprob(model: Captioner, params, encoded: Encoded,
                     ids: torch.Tensor) -> torch.Tensor:
    """Rescore id rows: ids (B, T+1) with column 0 = ``<sta>`` -> (B,)
    float32 sums of log p(ids[:, t+1] | ids[:, :t+1]) under the flat step
    and the head's float32 logits, up to and including each row's first
    ``<end>``.  The measure beam search maximizes, used to compare two
    decodes' winners."""
    head = _prepare_head(model, params, encoded.mean.dtype)
    state = model.init_state(params, encoded)
    total = torch.zeros((ids.shape[0],), dtype=torch.float32,
                        device=ids.device)
    live = torch.ones((ids.shape[0],), dtype=torch.bool, device=ids.device)
    for t in range(ids.shape[1] - 1):
        hidden, state, _ = model.step_core(params, encoded, state, ids[:, t])
        logp = torch.log_softmax(vocab_shard.gather_logits(
            fused_head.logits_plain(head, hidden)[:, :head.v]), dim=-1)
        total += torch.where(live, logp.gather(1, ids[:, t + 1:t + 2])[:, 0],
                             0.0)
        live = live & (ids[:, t + 1] != END_ID)
    return total


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with equal values in index order
    (``lax.top_k``'s tie order, which ``torch.topk`` does not promise).
    Ties are real here: every candidate of a dead lane is ``_NEG`` plus a
    log-probability, which float32 rounds to ``_NEG`` itself."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(model: Captioner, params, encoded: Encoded,
                beam_size: int = 3, max_steps: int = 50,
                return_alphas: bool = False):
    """Batched beam search.  Returns ids (B, max_steps+1) int64 — column 0
    is ``<sta>``, the winning sequence ends with ``<end>`` (the rest
    ``<pad>``) — and, if asked for, alphas (B, max_steps, N) float32.

    Each step runs :meth:`Captioner.step_lanes_core` over (B, k) lanes.
    Where :func:`fused_head.enabled` holds for k, the head is the fused
    top-k (kernel K1 at k over B*k rows): the union of each lane's top k
    holds the global top k, so the merge is over (B, k*k) candidates and
    the (B, k, V) logits are never materialized.  Otherwise the full
    logits go through a float32 log-softmax and the merge is over (B, k*V).
    Scores, candidate sums and the log-softmax are float32 whatever the
    compute dtype."""
    k = beam_size
    mean = encoded.mean
    b, dev = mean.shape[0], mean.device
    num_feat = encoded.features.shape[1]
    rows = torch.arange(b, device=dev)[:, None]                 # (B, 1)
    use_fused = fused_head.enabled(k)
    head = _prepare_head(model, params, mean.dtype) if use_fused else None
    lanes = torch.arange(k, device=dev)[None, :]                # (1, k)

    def lane_gather(a, prev):
        """a (B, k, ...) indexed by prev (B, k) along the lanes axis."""
        return a[rows, prev]

    state = model.init_lane_state(params, encoded, k)
    tokens = torch.full((b, k, max_steps + 1), PAD_ID, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = STA_ID
    scores = torch.full((b, k), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0                                          # lane 0 live
    # the finished pool has one spare slot, k: a write that the JAX
    # package drops (mode="drop") lands there, and the slot is cut off
    fin_tokens = torch.zeros((b, k + 1, max_steps + 1), dtype=torch.long,
                             device=dev)
    fin_scores = torch.full((b, k + 1), _NEG, dtype=torch.float32,
                            device=dev)
    fin_count = torch.zeros((b,), dtype=torch.long, device=dev)
    k_rem = torch.full((b,), k, dtype=torch.long, device=dev)
    if return_alphas:
        # carried only when asked for: the eval path needs ids alone
        alphas = torch.zeros((b, k, max_steps, num_feat), dtype=torch.float32,
                             device=dev)
        fin_alphas = torch.zeros((b, k + 1, max_steps, num_feat),
                                 dtype=torch.float32, device=dev)

    t = 0
    while t < max_steps and bool((k_rem > 0).any()):
        cur = tokens[:, :, t]
        if use_fused:
            pre, new_state, alpha = model.step_lanes_core(params, encoded,
                                                          state, cur)
            vals, idx, lse = vocab_shard.topk_merge(
                head, pre.reshape((b * k,) + pre.shape[2:]), k)
            logp_top = (vals - lse[:, None]).reshape(b, k * k)
            cand = scores.repeat_interleave(k, dim=1) + logp_top
            top_scores, flat_idx = _top_k(cand, k)        # over k*k
            prev = flat_idx // k
            tok = idx.reshape(b, k * k).long().gather(1, flat_idx)
        else:
            logits, new_state, alpha = model.step_lanes(params, encoded,
                                                        state, cur)
            logp = torch.log_softmax(logits.float(), dim=-1)
            v = logp.shape[-1]
            cand = (scores[..., None] + logp).reshape(b, k * v)
            top_scores, flat_idx = _top_k(cand, k)        # over k*V
            prev = flat_idx // v
            tok = flat_idx % v
        valid = lanes < k_rem[:, None]                    # shrinking k
        is_end = (tok == END_ID) & valid

        tokens = lane_gather(tokens, prev)
        tokens[:, :, t + 1] = tok
        state = _tree_map(lambda s: lane_gather(s, prev), new_state)

        # park the newly finished candidates in the pool: at most k_rem end
        # in a step, so a real slot never passes k - 1
        slot = torch.where(is_end,
                           fin_count[:, None] + is_end.cumsum(dim=1) - 1, k)
        fin_tokens[rows, slot] = tokens
        fin_scores[rows, slot] = top_scores
        n_end = is_end.sum(dim=1)
        scores = torch.where(valid & ~is_end, top_scores,
                             torch.full_like(top_scores, _NEG))
        fin_count = fin_count + n_end
        k_rem = k_rem - n_end
        if return_alphas:
            if alpha is None:
                alpha = torch.zeros((b, k, num_feat), dtype=torch.float32,
                                    device=dev)
            alphas = lane_gather(alphas, prev)
            alphas[:, :, t] = lane_gather(alpha, prev).float()
            fin_alphas[rows, slot] = alphas
        t += 1

    # pick: the best finished beam, else the best live beam
    # (NIC_Model.py:204-211)
    any_fin = fin_count > 0
    fin_best = fin_scores[:, :k].argmax(dim=1)
    live_best = scores.argmax(dim=1)
    b_idx = rows[:, 0]

    def pick(pool, live):
        return torch.where(
            any_fin.reshape((b,) + (1,) * (pool.dim() - 2)),
            pool[b_idx, fin_best], live[b_idx, live_best])

    ids = pick(fin_tokens, tokens)
    if not return_alphas:
        return ids
    return ids, pick(fin_alphas, alphas)


# ---------------------------------------------------------------------------
# teacher forcing (XE training forward)
# ---------------------------------------------------------------------------

def _uniform_open(shape, generator: Optional[torch.Generator],
                  device) -> torch.Tensor:
    """float32 uniforms strictly inside (0, 1) from ``generator``.
    ``torch.rand`` gives k 2^-24 for k in [0, 2^24); k = 0 is raised to
    2^-24, so both logs of the Gumbel transform stay finite.  (The JAX
    package adds 2^-25 to its 24-bit uniform instead, which rounds the
    largest to 1.0, whose Gumbel is +inf.)  Under a process group the
    draw is the global batch's and this process keeps its rows (axis 0 is
    the batch; ``parallel.global_rand``)."""
    u = global_rand(shape, generator, device)
    return u.clamp_(min=2.0 ** -24)


def _categorical(generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
    """One id per row of ``logits`` (..., V), drawn from softmax(logits)
    by Gumbel-max on uniforms from ``generator`` (int64).  The Gumbel
    noise is bounded (within [-2.8, 16.7]), so an id whose logit is -inf,
    probability 0, is never drawn."""
    u = _uniform_open(logits.shape, generator, logits.device)
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + g, dim=-1)


def teacher_forced_logits(model: Captioner, params, encoded: Encoded,
                          captions: torch.Tensor, ss_prob,
                          generator: Optional[torch.Generator],
                          train: bool = True,
                          ss_active: Optional[bool] = None,
                          ss_generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """captions (B, T) -> logits (B, T-1, V).

    Step t consumes captions[:, t] (or, from t >= 2 with probability
    ``ss_prob`` per sample, a draw from the previous step's predictions:
    scheduled sampling, reference NIC_Model.py:79-90) and predicts token
    t+1.  As in the JAX package the prediction head is hoisted out of the
    loop: the loop keeps each step's pre-logit hidden and one
    ``model.predict`` over (B, T-1, H) gives the logits.  The draws need
    the previous step's logits; they run under ``torch.no_grad`` (sampling
    has no gradient), and with ``ss_active=False`` they are left out
    entirely.  ``ss_active=None`` samples when a generator is given.

    ``generator`` draws the dropout masks of ``model.step_core`` (train
    mode), ``ss_generator`` (default: ``generator``) the sampling's
    uniforms and Gumbel noise.  With two generators the dropout masks do
    not depend on whether sampling is active.  The word embedding's masks
    of every step are drawn first, before the loop
    (``Captioner.emb_dropout_masks``), then each step's other masks in
    step order, whatever the mode.

    With sampling off, every step's input token is known before the loop,
    and the input hoist of the JAX package's default mode applies
    (``Captioner.tf_inputs``; on under ``SICZ_TPU_PALLAS_LSTM`` ``auto``
    and ``off``): the embedding rows of the cell's ``w_ih`` project all
    steps at once, and step t runs kernel K2 over the rest of the input
    with its slice of that projection as the gate term.  Under
    ``interpret`` each step takes its whole input, as the JAX package's
    ``interpret`` mode does; both modes draw the same masks."""
    b, t_total = captions.shape
    n_steps = t_total - 1
    use_ss = (generator is not None) if ss_active is None \
        else bool(ss_active)
    ss_gen = ss_generator if ss_generator is not None else generator
    state = model.init_state(params, encoded)
    masks = model.emb_dropout_masks(n_steps, b, train, generator,
                                    captions.device)
    tf_steps = None
    if not use_ss:
        tf = model.tf_inputs(params, encoded, captions[:, :-1].t(), masks)
        if tf is not None:
            # one slice a step (unbind: its backward stacks the slices'
            # gradients once)
            tf_steps = [{"cell": tf["cell"], "term": term}
                        for term in tf["term"].unbind(0)]
    hidden, hiddens = None, []
    for t in range(n_steps):
        tok = captions[:, t]
        if use_ss and t >= 2:
            with torch.no_grad():
                use_model = _uniform_open((b,), ss_gen,
                                          captions.device) < ss_prob
                drawn = _categorical(ss_gen, model.predict(params, hidden))
            tok = torch.where(use_model, drawn, tok.long())
        hidden, state, _ = model.step_core(
            params, encoded, state, tok, train=train, generator=generator,
            tf_input=None if tf_steps is None else tf_steps[t],
            emb_mask=None if masks is None else masks[t])
        hiddens.append(hidden)
    return model.predict(params, torch.stack(hiddens, dim=1))


# ---------------------------------------------------------------------------
# multinomial rollout (SCST)
# ---------------------------------------------------------------------------

def _token_logprobs(logits: torch.Tensor, drawn: torch.Tensor
                    ) -> torch.Tensor:
    """logits (B, T, V), drawn (B, T) -> (B, T) float32: each step's
    log-probability of its drawn id, by a float32 log-softmax (REINFORCE
    differentiates these; a bf16 log-softmax would lose the gradient's
    precision)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, drawn[..., None])[..., 0]


def sample_rl(model: Captioner, params, encoded: Encoded, max_len: int,
              generator: Optional[torch.Generator] = None,
              draw_generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SCST's rollout, in train mode: -> (seq (B, max_len), logprobs
    (B, max_len) float32, drawn (B, max_len)), ids int64.

    Each step draws an id from softmax of its logits (:func:`_categorical`).
    ``seq`` holds the draws with everything from the ``<end>`` step on
    zeroed, the ``<end>`` itself included, and a step feeds the next its
    ``seq`` id; ``logprobs`` holds the drawn id's log-probability at every
    step, and ``drawn`` the raw draws (the JAX package returns seq and
    logprobs; the draws let :func:`replay_logprobs` recompute the
    logprobs).  The reference's semantics (NIC_Model.py:134-150).

    As in :func:`teacher_forced_logits` the head is hoisted: the draws come
    from per-step logits under ``torch.no_grad`` (a draw has no gradient),
    the logprobs from one head application over the stacked (B, T, H)
    hiddens.  ``generator`` draws the dropout masks of ``model.step_core``
    (the embedding's of every step first, as teacher forcing draws them,
    so :func:`replay_logprobs` sees the same masks), ``draw_generator``
    (default: ``generator``) the ids; with two generators the dropout
    masks do not depend on the draws."""
    b, dev = encoded.mean.shape[0], encoded.mean.device
    draw_gen = draw_generator if draw_generator is not None else generator
    state = model.init_state(params, encoded)
    masks = model.emb_dropout_masks(max_len, b, True, generator, dev)
    tok = torch.full((b,), STA_ID, dtype=torch.long, device=dev)
    unfinished = torch.ones((b,), dtype=torch.bool, device=dev)
    seq, drawn, hiddens = [], [], []
    for t in range(max_len):
        hidden, state, _ = model.step_core(
            params, encoded, state, tok, train=True, generator=generator,
            emb_mask=None if masks is None else masks[t])
        with torch.no_grad():
            d = _categorical(draw_gen, model.predict(params, hidden))
        unfinished = unfinished & (d != END_ID)
        tok = d * unfinished
        seq.append(tok)
        drawn.append(d)
        hiddens.append(hidden)
    drawn = torch.stack(drawn, dim=1)
    logits = model.predict(params, torch.stack(hiddens, dim=1))
    return torch.stack(seq, dim=1), _token_logprobs(logits, drawn), drawn


def replay_logprobs(model: Captioner, params, encoded: Encoded,
                    seq: torch.Tensor, drawn: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The logprobs of :func:`sample_rl` from its ``seq`` and ``drawn``,
    by teacher forcing: step t consumes ``<sta>`` then ``seq[:, t-1]``, as
    the rollout fed itself.  With ``generator`` in the state the rollout's
    started from, the dropout masks, the hiddens and the logprobs are the
    rollout's exactly."""
    sta = torch.full_like(seq[:, :1], STA_ID)
    logits = teacher_forced_logits(model, params, encoded,
                                   torch.cat([sta, seq], dim=1), 0.0,
                                   generator, train=True, ss_active=False)
    return _token_logprobs(logits, drawn)
