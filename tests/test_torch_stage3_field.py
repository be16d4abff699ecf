"""The port's SkipConnMLP and the MLP field's stage-3 mask branch, with
weights carried across from the JAX modules (params_from_jax), held to the
JAX modules on shared inputs.

Bar: 1e-5 relative.  Both sides compute in fp32 with the same operations
(no bf16 rounding in the mask branch), so only the summation order
differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.models.mlp import SkipConnMLP as JaxSkipConnMLP
from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu_torch.models import MLPField, make_field, params_from_jax
from sanerf_hq_tpu_torch.models.mlp import SkipConnMLP

KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
          prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
          cp_res=16, with_mask=True, n_inst=3, feat_rank=8, feat_res=16)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("layers,skips,bias", [(3, (), False),
                                               (5, (2,), True)])
def test_skip_conn_mlp_matches_jax(layers, skips, bias):
    dim_in, dim_out, hidden = 20, 3, 32
    jm = JaxSkipConnMLP(dim_out, hidden, layers, skip_layers=skips,
                        use_bias=bias)
    x = np.random.default_rng(0).normal(size=(16, dim_in)).astype(np.float32)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = SkipConnMLP(dim_in, dim_out, hidden, layers, skip_layers=skips,
                     use_bias=bias)
    with torch.no_grad():
        for i, lin in enumerate(tm.layers):
            p = params["params"][f"Dense_{i}"]
            assert lin.weight.shape == p["kernel"].T.shape, i
            lin.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
            if bias:
                lin.bias.copy_(torch.tensor(np.asarray(p["bias"])))
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))
    # the torch-default initialisation: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for lin in SkipConnMLP(dim_in, dim_out, hidden, layers, skips,
                           use_bias=bias).layers:
        b = 1.0 / lin.in_features ** 0.5
        assert lin.weight.abs().max() <= b
        assert lin.bias is None or lin.bias.abs().max() <= b


@pytest.fixture(scope="module", params=["default", "lightweight_mask"])
def fields(request):
    kw = dict(KW, mask_mlp_type=request.param)
    jm = JaxMLPField(**kw)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    tm = MLPField(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(params))  # strict: every leaf carried
    return jm, params, tm, request.param


def test_mask_features_match_jax(fields):
    jm, params, tm, kind = fields
    x = np.random.default_rng(1).uniform(-2.2, 2.2, (8, 16, 3)).astype(
        np.float32)
    want = jm.apply(params, jnp.asarray(x), method=JaxMLPField.mask_features)
    got = tm.mask_features(torch.from_numpy(x))
    assert got.shape == want.shape == (8, 16, 128 if kind == "default"
                                       else 32)
    _close(got, want)


def test_mask_mlp_matches_jax(fields):
    jm, params, tm, kind = fields
    width = 128 + 15 if kind == "default" else 32 + 31
    m = np.random.default_rng(2).normal(size=(64, width)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(m), method=JaxMLPField.apply_mask_mlp)
    got = tm.apply_mask_mlp(torch.from_numpy(m))
    assert got.shape == want.shape == (64, KW["n_inst"])
    _close(got, want)


def test_mask_branch_params_and_init():
    """The mask branch is drawn after the backbone, so a seed gives the
    same backbone with or without it; the CP volume is N(0, 0.3), the
    projection N(0, 0.1)."""
    kw = dict(KW, feat_rank=64, feat_res=128)
    with_mask = MLPField(**kw, device="cpu", seed=5)
    plain = MLPField(**dict(kw, with_mask=False), device="cpu", seed=5)
    for name, p in plain.state_dict().items():
        assert torch.equal(p, with_mask.state_dict()[name]), name
    assert with_mask.cp_m_x.shape == (128, 64)
    assert with_mask.cp_m_proj.shape == (64, 128)
    assert abs(with_mask.cp_m_y.std().item() - 0.3) < 0.02
    assert abs(with_mask.cp_m_proj.std().item() - 0.1) < 0.01
    assert [lin.weight.shape for lin in with_mask.mask_mlp.layers] == [
        (256, 143), (256, 256), (3, 256)]
    assert all(lin.bias is None for lin in with_mask.mask_mlp.layers)


@pytest.mark.parametrize("kw,item", [(dict(with_sam=True), "M8"),
                                     (dict(field_type="hashgrid",
                                           with_sam=True), "M8")])
def test_unported_field_options_raise(kw, item):
    """Stage 2 (with_sam) is not ported in either field."""
    kw = dict(KW, **kw)
    with pytest.raises(NotImplementedError, match=item):
        make_field(kw.pop("field_type", "mlp"), device="cpu", **kw)
