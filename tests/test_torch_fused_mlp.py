"""K8's entry point `fused_freq_mlp` (sanerf_hq_tpu_torch/ops/fused_mlp.py)
against the JAX `fused_freq_mlp` on shared inputs, on the CPU, where the
port's autograd Function runs the plain version and the JAX function its
jnp reference (`use_pallas=False`, as the JAX package runs it off the TPU).
The CUDA kernel is held to the same plain version on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.

Shapes: a proposal-like MLP (3 layers, no skip, one output) and a
trunk-like one (4 layers, skip at 2, 16 outputs), narrow.  Tolerances:
rel-max 2e-2 on the forward (tests/test_torch_ops.py's bf16 trunk bar) and
on the grads of x and of every weight against `jax.vjp` of
`_reference_forward`, which is what the JAX `_fused_bwd` computes: both
sides round activations and their cotangents to bf16 at the same points,
but sum the products in other orders and precisions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.ops import fused_mlp as j_fm
from sanerf_hq_tpu_torch.ops import fused_mlp

SHAPES = {  # name: (freq degree, hidden, layers, skip, output width)
    "proposal": (6, 32, 3, -1, 1),
    "trunk": (4, 32, 4, 2, 16),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _inputs(name, seed=0):
    """x [8, 16, 3] in [-1, 1], the [in, out] weights (JAX layout) and the
    cotangent [8, 16, out], from a numpy seed."""
    deg, hidden, layers, skip, out = SHAPES[name]
    rng = np.random.default_rng(seed)
    nin = 3 * (1 + 2 * deg)
    ws, fin = [], nin
    for l in range(layers):
        fin += nin if l == skip else 0
        fout = out if l == layers - 1 else hidden
        ws.append((rng.normal(size=(fin, fout)) / np.sqrt(fin))
                  .astype(np.float32))
        fin = fout
    x = rng.uniform(-1, 1, (8, 16, 3)).astype(np.float32)
    g = rng.normal(size=(8, 16, out)).astype(np.float32)
    return x, ws, g, deg, skip


def _port_ws(ws, grad=False):
    return [torch.from_numpy(w.T.copy()).requires_grad_(grad) for w in ws]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_freq_mlp_matches_jax(name):
    x, ws, _, deg, skip = _inputs(name)
    want = j_fm.fused_freq_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                               deg, skip, use_pallas=False)
    got = fused_mlp.fused_freq_mlp(torch.from_numpy(x), _port_ws(ws), deg,
                                   skip)
    assert got.shape == want.shape == (8, 16, ws[-1].shape[1])
    assert _rel(got, want) < 2e-2, _rel(got, want)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_freq_mlp_grads_match_jax_vjp(name):
    x, ws, g, deg, skip = _inputs(name, seed=1)
    x2 = jnp.asarray(x.reshape(-1, 3))
    _, vjp = jax.vjp(lambda x_, *w_: j_fm._reference_forward(
        x_, w_, deg, skip), x2, *(jnp.asarray(w) for w in ws))
    want = vjp(jnp.asarray(g.reshape(-1, g.shape[-1])))
    xt = torch.from_numpy(x).requires_grad_(True)
    tws = _port_ws(ws, grad=True)
    y = fused_mlp.fused_freq_mlp(xt, tws, deg, skip)
    got = torch.autograd.grad(y, [xt] + tws, torch.from_numpy(g))
    assert got[0].shape == x.shape
    assert _rel(got[0].reshape(-1, 3), want[0]) < 2e-2, "dx"
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        assert a.shape == b.T.shape, i
        assert _rel(a, np.asarray(b).T) < 2e-2, (f"dW{i}", _rel(a, b.T))


def test_fused_freq_mlp_runs_the_twin_on_cpu_only():
    """On a CPU tensor the autograd Function is the plain version: the same
    output and, through its backward, the same grads as autograd through
    the plain version, bit for bit; no kernel is counted.  Another device
    raises instead of falling back."""
    x, ws, g, deg, skip = _inputs("trunk", seed=2)
    before = fused_mlp.fused_freq_mlp.launches
    grads = []
    for fn in (fused_mlp.fused_freq_mlp, fused_mlp._reference_forward):
        xt = torch.from_numpy(x).requires_grad_(True)
        tws = _port_ws(ws, grad=True)
        y = fn(xt, tws, deg, skip)
        grads.append((y.detach(), torch.autograd.grad(
            y, [xt] + tws, torch.from_numpy(g))))
    (ya, ga), (yb, gb) = grads
    assert torch.equal(ya, yb)
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    # only the weights need grads: x gets none
    tws = _port_ws(ws, grad=True)
    fused_mlp.fused_freq_mlp(torch.from_numpy(x), tws, deg, skip).sum()\
        .backward()
    assert all(w.grad is not None for w in tws)
    assert fused_mlp.fused_freq_mlp.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.fused_freq_mlp(torch.zeros(4, 3, device="meta"),
                                 [w.to("meta") for w in _port_ws(ws)], deg,
                                 skip)
