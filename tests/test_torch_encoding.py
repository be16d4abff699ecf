"""The port's last ops against the JAX package on the CPU, on inputs made
from numpy seeds:
  - `freq_encode` (channel-major) and `freq_output_dim`: max abs 1e-6;
  - `get_encoder` for every name (None, frequency, frequency_torch, sh,
    hashgrid, tiledgrid): the output dim and the encoding (the grid
    encoders on one numpy table) max abs 1e-6, and the grid encoders'
    initialiser giving a table of the spec's shape in U(-1e-4, 1e-4);
  - `uncontract` against JAX's (max abs 1e-5), and uncontract(contract(x))
    == x inside the domain (rel 1e-5);
  - the traced `update_proposal` (a 0-d bool tensor) on both routes of
    the MLP field: the forward equal to the bool form's, the proposal
    grads zero under False and equal to the bool form's under True, the
    other grads equal; and on the composable route against JAX's traced
    form (JAX's FreqMLP through its plain reference), per-leaf grad
    rel-L2 <= 5% (tests/test_torch_train.py's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.fused_mlp as jfm
from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu.ops.contraction import contract as j_contract
from sanerf_hq_tpu.ops.contraction import uncontract as j_uncontract
from sanerf_hq_tpu.ops.encoding import get_encoder as j_get_encoder
from sanerf_hq_tpu.ops.freq import freq_encode as j_freq
from sanerf_hq_tpu.ops.freq import freq_output_dim as j_freq_dim
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu_torch.models import MLPField, params_from_jax
from sanerf_hq_tpu_torch.ops import (contract, freq_encode, freq_output_dim,
                                     get_encoder, uncontract)
from sanerf_hq_tpu_torch.render import renderer as tr

N = 64
KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
          prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
          cp_res=16)
STEPS = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05)
GRID_KW = dict(num_levels=4, level_dim=2, base_resolution=8,
               log2_hashmap_size=10, desired_resolution=64)


def _x(shape, scale=1.0, seed=0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("degree", [1, 4, 6])
def test_freq_encode_matches_jax(degree):
    x = _x((7, 5, 3), 2.0)
    got = freq_encode(torch.from_numpy(x), degree).numpy()
    want = np.asarray(j_freq(jnp.asarray(x), degree))
    assert got.shape == want.shape == (7, 5, freq_output_dim(3, degree))
    assert freq_output_dim(3, degree) == j_freq_dim(3, degree)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", [None, "frequency", "frequency_torch",
                                  "sh", "hashgrid", "tiledgrid"])
def test_get_encoder_matches_jax(name):
    kw = dict(GRID_KW, multires=5, degree=4)
    fn, dim, init = get_encoder(name, **kw)
    jfn, jdim, jinit = j_get_encoder(name, **kw)
    assert dim == jdim
    assert (init is None) == (jinit is None)
    if init is None:
        x = _x((33, 3))
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jfn(jnp.asarray(x)))
    else:
        assert fn.spec.total_params == jfn.spec.total_params
        table = init(torch.Generator().manual_seed(0))
        assert tuple(table.shape) == (fn.spec.total_params, 2)
        assert float(table.abs().max()) <= 1e-4
        t = _x(tuple(table.shape), 0.3, seed=1)
        x = np.random.default_rng(2).uniform(-1.9, 1.9, (33, 3)).astype(
            np.float32)
        got = fn(torch.from_numpy(t), torch.from_numpy(x), bound=2.0).numpy()
        want = np.asarray(jfn(jnp.asarray(t), jnp.asarray(x), bound=2.0))
    assert got.shape == want.shape and got.shape[-1] == dim
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_uncontract_matches_jax_and_inverts_contract():
    x = _x((4096, 3), 3.0)
    z = contract(torch.from_numpy(x))
    got = uncontract(z).numpy()
    want = np.asarray(j_uncontract(j_contract(jnp.asarray(x))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # inside the domain (inf-norm well below 2, where 1 / (2 - |z|) is
    # well conditioned) the inverse is exact to fp32
    inside = np.abs(x).max(-1) < 20
    np.testing.assert_allclose(got[inside], x[inside], rtol=1e-5, atol=1e-6)
    zz = _x((100, 3), 0.3)  # |z| < 1: the identity both ways
    assert torch.equal(uncontract(torch.from_numpy(zz)), torch.from_numpy(zz))


@pytest.fixture(scope="module")
def field():
    jm = JaxMLPField(**KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                              jnp.ones((4, 3)))
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    rng = np.random.default_rng(0)
    ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return jm, params, tm, ro, rd, gt


def _port_grads(tm, ro, rd, gt, kernels, upd):
    tm.zero_grad(set_to_none=True)
    s = tr.RenderSettings(**STEPS, training=True, compute_losses=True,
                          level_kernels=kernels)
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd), s,
                         update_proposal=upd)
    loss = (torch.mean((out["image"] - torch.from_numpy(gt)) ** 2)
            + out["proposal_loss"] + 0.02 * out["distort_loss"])
    loss.backward()
    grads = {n: None if p.grad is None else p.grad.clone()
             for n, p in tm.named_parameters()}
    return {k: out[k].detach() for k in ("image", "depth", "weights_sum",
                                         "proposal_loss")}, grads


@pytest.mark.parametrize("kernels", [True, False],
                         ids=["level_kernels", "composable"])
@pytest.mark.parametrize("flag", [False, True])
def test_traced_update_proposal_matches_bool_form(field, kernels, flag):
    _, _, tm, ro, rd, gt = field
    out_b, g_b = _port_grads(tm, ro, rd, gt, kernels, flag)
    out_t, g_t = _port_grads(tm, ro, rd, gt, kernels, torch.tensor(flag))
    for k in out_b:
        assert torch.equal(out_b[k], out_t[k]), k
    for name, g in g_t.items():
        if name.startswith("prop_mlp") and not flag:
            assert g_b[name] is None, name
            assert g is not None and float(g.abs().max()) == 0.0, name
        else:
            torch.testing.assert_close(g, g_b[name], rtol=1e-6, atol=1e-9,
                                       msg=name)
    if not flag:
        assert out_t["proposal_loss"].item() == 0.0


@pytest.fixture(scope="module")
def jax_traced_grads(field):
    """JAX's loss and grads with update_proposal a traced argument: one
    compiled program for both values (JAX's FreqMLP through its plain
    reference)."""
    jm, params, _, ro, rd, gt = field
    js = jr.RenderSettings(**STEPS, training=True, compute_losses=True)

    def loss(p, upd):
        out = jm.apply(p, jnp.asarray(ro), jnp.asarray(rd), js,
                       method=lambda m, o, d, s: jr.render_rays(
                           m, o, d, s, update_proposal=upd))
        return (jnp.mean((out["image"] - gt) ** 2) + out["proposal_loss"]
                + 0.02 * out["distort_loss"]), out

    pallas = jfm.PALLAS_ENABLED
    jfm.PALLAS_ENABLED = False
    try:
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        return {flag: jax.device_get(fn(params, jnp.asarray(flag)))
                for flag in (False, True)}
    finally:
        jfm.PALLAS_ENABLED = pallas


@pytest.mark.parametrize("flag", [False, True])
def test_traced_update_proposal_matches_jax(field, jax_traced_grads, flag):
    _, _, tm, ro, rd, gt = field
    (_, jout), jg = jax_traced_grads[flag]
    out, grads = _port_grads(tm, ro, rd, gt, False, torch.tensor(flag))
    assert float(out["proposal_loss"]) == pytest.approx(
        float(jout["proposal_loss"]), rel=2e-2, abs=1e-7)
    for k in ("image", "depth"):
        assert np.abs(out[k].numpy() - np.asarray(jout[k])).max() < 2e-2, k
    want = params_from_jax(jax.device_get(jg))
    for name, g in grads.items():
        w = want[name].numpy().astype(np.float64)
        if name.startswith("prop_mlp") and not flag:
            assert float(g.abs().max()) == 0.0 and np.abs(w).max() == 0.0
            continue
        rel = (np.linalg.norm(g.numpy() - w)
               / max(np.linalg.norm(w), 1e-30))
        assert rel <= 5e-2, f"{name}: grad rel-L2 {rel:.3e}"
