"""K2's backward in simpleimagecaptionzoo_tpu_torch against the JAX
package's custom VJP of the Pallas cell (ops/pallas_lstm.py:445-491, the
kernel in interpret mode) and against autograd through the plain cell.
On CPU tensors the autograd Function takes the plain forward and the plain
backward (lstm_cell_bwd_plain) and no launch is counted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleimagecaptionzoo_tpu.ops import pallas_lstm
from simpleimagecaptionzoo_tpu_torch.models import layers as TL
from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm

NAMES = ("w_ih", "w_hh", "b_ih", "b_hh", "x", "h", "c")


def _inputs(b, e, h, seed):
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(h)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa
    params = {"w_ih": u(e, 4 * h), "w_hh": u(h, 4 * h), "b_ih": u(4 * h),
              "b_hh": u(4 * h)}
    x, hh, c = (rng.normal(size=(b, n)).astype(np.float32) for n in (e, h, h))
    return params, x, hh, c


def _jax_grads(params, x, h, c, dtype):
    cast = lambda a: jnp.asarray(a).astype(dtype)  # noqa: E731

    def loss(p, x, h, c):
        hn, cn = pallas_lstm.lstm_cell_fused(p, x, h, c, interpret=True)
        return jnp.sum(hn.astype(jnp.float32) * 1.3
                       + cn.astype(jnp.float32) * 0.7)

    gp, gx, gh, gc = jax.grad(loss, argnums=(0, 1, 2, 3))(
        {k: cast(v) for k, v in params.items()}, cast(x), cast(h), cast(c))
    return [gp[k] for k in NAMES[:4]] + [gx, gh, gc]


def _torch_leaves(params, x, h, c, dtype):
    return [torch.from_numpy(a).to(dtype).requires_grad_()
            for a in [params[k] for k in NAMES[:4]] + [x, h, c]]


def _port_grads(leaves, through):
    w_ih, w_hh, b_ih, b_hh, x, h, c = leaves
    if through == "function":
        w = fused_lstm.prepare_lstm(dict(zip(NAMES[:4], leaves[:4])))
        hn, cn = fused_lstm.lstm_cell_train(w, x, h, c)
    else:
        hn, cn = fused_lstm.lstm_cell_plain(torch.cat([w_ih, w_hh]),
                                            b_ih + b_hh, x, h, c)
    loss = (hn.float() * 1.3 + cn.float() * 0.7).sum()
    return torch.autograd.grad(loss, leaves)


def _counts():
    return (fused_lstm.COUNT.n, fused_lstm.COUNT_BWD.n,
            fused_lstm.COUNT_BWD_WGMMA.n, fused_lstm.COUNT_BWD_TF32X3.n)


@pytest.mark.parametrize("b,e", [(8, 100), (16, 256), (3, 40)])
def test_function_grads_match_jax_vjp_and_plain_autograd(b, e):
    """float32: every gradient (w_ih, w_hh, b_ih, b_hh, x, h, c) within
    1e-5 of JAX's custom VJP and of autograd through the plain cell; the
    CPU run launches nothing."""
    h = 128
    params, x, hh, c = _inputs(b, e, h, b + e)
    jg = _jax_grads(params, x, hh, c, jnp.float32)
    leaves = _torch_leaves(params, x, hh, c, torch.float32)
    before = _counts()
    got = _port_grads(leaves, "function")
    assert _counts() == before
    want = _port_grads(leaves, "plain")
    for name, g, w, j in zip(NAMES, got, want, jg):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_function_grads_bf16_match_jax_within_a_bf16_ulp_of_the_gates():
    """bf16: every cotangent in its primal's dtype (bf16); each gradient
    within 2e-2 of the largest |gradient| of its leaf, against JAX's VJP
    (which recomputes the gates in bf16, where the port recomputes the
    forward's float32 epilogue: about one bf16 ulp, 2^-8, of the gates
    apart, summed over B or 4H terms) and against autograd through the
    plain cell in bf16."""
    b, e, h = 16, 256, 128
    params, x, hh, c = _inputs(b, e, h, 9)
    jg = _jax_grads(params, x, hh, c, jnp.bfloat16)
    leaves = _torch_leaves(params, x, hh, c, torch.bfloat16)
    got = _port_grads(leaves, "function")
    want = _port_grads(leaves, "plain")
    for name, g, w, j in zip(NAMES, got, want, jg):
        assert g.dtype == torch.bfloat16, name
        assert j.dtype == jnp.bfloat16, name
        scale = float(np.abs(np.asarray(j.astype(jnp.float32))).max())
        for other in (np.asarray(j.astype(jnp.float32)), w.float().numpy()):
            err = float(np.abs(g.float().numpy() - other).max())
            assert err <= 2e-2 * scale, (name, err, scale)


def test_bwd_plain_is_autograds_gate_gradient():
    """lstm_cell_bwd_plain's d_gates equals autograd's gradient of the loss
    through the plain cell with respect to its gates, and its dc the
    gradient with respect to c."""
    b, e, h = 5, 12, 8
    params, x, hh, c = _inputs(b, e, h, 2)
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    w_cat = torch.cat([t["w_ih"], t["w_hh"]])
    b_sum = t["b_ih"] + t["b_hh"]
    xt, ht = torch.from_numpy(x), torch.from_numpy(hh)
    ct = torch.from_numpy(c).requires_grad_()
    gates = (torch.cat([xt, ht], -1) @ w_cat + b_sum).requires_grad_()
    hn, cn = fused_lstm.gate_math(gates, ct)
    rng = np.random.default_rng(4)
    dh, dc = (torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
              for _ in range(2))
    want_g, want_c = torch.autograd.grad((hn * dh + cn * dc).sum(),
                                         [gates, ct])
    dg, dcp = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, xt, ht,
                                             ct.detach(), dh, dc)
    torch.testing.assert_close(dg, want_g, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dcp, want_c, rtol=1e-6, atol=1e-6)


def test_layers_lstm_cell_takes_the_function_only_for_a_gradient():
    """layers.lstm_cell goes through LstmCell when grad mode is on and an
    input requires a gradient; under no_grad (decode) it calls the kernel
    wrapper directly.  prepare_lstm makes the TF32 split from a detached
    w_cat."""
    params, x, hh, c = _inputs(4, 16, 8, 5)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    w = fused_lstm.prepare_lstm(tp)
    assert w.w_cat.requires_grad and w.b_sum.requires_grad
    assert not w.split.hi.requires_grad and not w.split.lo.requires_grad
    xt, ht, ct = (torch.from_numpy(a) for a in (x, hh, c))
    hn, cn = TL.lstm_cell(tp, xt, ht, ct, prepared=w)
    assert type(hn.grad_fn).__name__ == "LstmCellBackward"
    with torch.no_grad():
        hn2, cn2 = TL.lstm_cell(tp, xt, ht, ct, prepared=w)
    assert hn2.grad_fn is None
    torch.testing.assert_close(hn2, hn.detach(), rtol=0, atol=0)
    torch.testing.assert_close(cn2, cn.detach(), rtol=0, atol=0)
