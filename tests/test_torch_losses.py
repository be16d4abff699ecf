"""The port's renderer losses against the JAX package's `ops/composite.py`
on the same inputs: the O(T) distortion loss and the interlevel proposal
loss (banded-mask form), values and gradients.

Bar: rel 1e-5 on values and max abs 1e-5 relative to the largest grad:
both sides compute the same fp32 expressions in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.ops import composite as jc
from sanerf_hq_tpu_torch.ops import composite as tc

N = 64


def _bins(rng, T):
    return np.sort(rng.uniform(0.0, 1.0, (N, T + 1)), axis=1).astype(
        np.float32)


def _weights(rng, T):
    w = rng.uniform(0.0, 1.0, (N, T)) ** 3
    return (w / w.sum(-1, keepdims=True)).astype(np.float32)


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-12)


def test_distort_loss_value_and_grad():
    rng = np.random.default_rng(0)
    bins, w = _bins(rng, 32), _weights(rng, 32)
    want, want_g = jax.value_and_grad(jc.distort_loss, argnums=1)(
        jnp.asarray(bins), jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tc.distort_loss(torch.from_numpy(bins), tw)
    got.backward()
    _close(got.item(), float(want))
    _close(tw.grad, want_g)


def test_searchsorted_right():
    rng = np.random.default_rng(1)
    rows, q = _bins(rng, 16), _bins(rng, 8)
    got = tc._searchsorted_right(torch.from_numpy(rows), torch.from_numpy(q))
    want = jc._searchsorted_right(jnp.asarray(rows), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t0,t1", [(32, 64), (32, 128), (8, 8)])
def test_loss_interlevel_value_and_grad(t0, t1):
    rng = np.random.default_rng(2)
    b0, w0, b1, w1 = _bins(rng, t0), _weights(rng, t0), _bins(rng, t1), \
        _weights(rng, t1)

    def jloss(w1_):
        return jnp.mean(jc.loss_interlevel(jnp.asarray(b0), jnp.asarray(w0),
                                           jnp.asarray(b1), w1_))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(w1))
    tw = torch.from_numpy(w1).requires_grad_(True)
    got = tc.loss_interlevel(torch.from_numpy(b0), torch.from_numpy(w0),
                             torch.from_numpy(b1), tw).mean()
    got.backward()
    _close(got.item(), float(want))
    _close(tw.grad, want_g)


def test_proposal_loss_detaches_the_final_level():
    rng = np.random.default_rng(3)
    steps = (32, 16, 8)
    bins = [_bins(rng, t) for t in steps]
    ws = [_weights(rng, t) for t in steps]

    def jloss(ws_):
        return jc.proposal_loss([jnp.asarray(b) for b in bins], list(ws_))

    want, want_g = jax.value_and_grad(jloss)([jnp.asarray(w) for w in ws])
    tws = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    got = tc.proposal_loss([torch.from_numpy(b) for b in bins], tws)
    got.backward()
    _close(got.item(), float(want))
    for t, g in zip(tws[:-1], want_g[:-1]):
        _close(t.grad, g)
    assert tws[-1].grad is None  # the reference level gets no grad
    assert float(jnp.abs(want_g[-1]).max()) == 0.0
