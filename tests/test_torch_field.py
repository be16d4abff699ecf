"""The port's MLPField with weights carried across from a JAX MLPField
(params_from_jax), held to the JAX field's methods on shared inputs.

rel-max 2e-2: both trunks round their operands to bf16 and sum in fp32 in
different orders, so a hidden unit can land on the other side of a bf16
rounding step (the JAX package's own kernel bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu_torch.models import MLPField, make_field, params_from_jax
from sanerf_hq_tpu_torch.models.convert import save_npz

KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
          prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
          cp_res=16, density_bias=-1.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture(scope="module")
def fields():
    jm = JaxMLPField(**KW)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


@pytest.fixture()
def points():
    rng = np.random.default_rng(0)
    x = rng.uniform(-2.0, 2.0, (8, 16, 3)).astype(np.float32)
    d = rng.normal(size=(8, 16, 3)).astype(np.float32)
    return x, d


@pytest.mark.parametrize("proposal", [-1, 0, 1])
def test_density(fields, points, proposal):
    jm, params, tm = fields
    x, _ = points
    want = jm.apply(params, jnp.asarray(x), proposal=proposal,
                    method=JaxMLPField.density)
    got = tm.density(torch.from_numpy(x), proposal=proposal)
    assert got.shape == want.shape
    assert _rel(got.detach(), want) < 2e-2


def test_forward_color(fields, points):
    jm, params, tm = fields
    x, d = points
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(d),
                    method=JaxMLPField.forward_color)
    got = tm.forward_color(torch.from_numpy(x), torch.from_numpy(d))
    for name, a, b in zip(("sigma", "feat", "color", "raw"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a.detach(), b) < 2e-2, name


def test_apply_view_mlp(fields):
    jm, params, tm = fields
    f = np.random.default_rng(1).normal(size=(32, 31)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(f), method=JaxMLPField.apply_view_mlp)
    got = tm.apply_view_mlp(torch.from_numpy(f))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_cp_features(fields, points):
    jm, params, tm = fields
    x, _ = points
    xn = x / KW["grid_bound"]
    want = jm.apply(params, jnp.asarray(xn), method=JaxMLPField.cp_features)
    got = tm.cp_features(torch.from_numpy(xn))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_params_from_npz_matches_nested(fields, tmp_path):
    """The flat `/`-keyed .npz form converts to the same state_dict, and it
    covers every parameter of the port's field (strict load)."""
    _, params, tm = fields
    path = tmp_path / "params.npz"
    save_npz(str(path), params)
    with np.load(path) as npz:
        flat = params_from_jax(dict(npz))
    nested = params_from_jax(params)
    assert flat.keys() == nested.keys() == tm.state_dict().keys()
    for k in flat:
        assert torch.equal(flat[k], nested[k]), k
    fresh = MLPField(**KW, device="cpu", seed=1)
    fresh.load_state_dict(flat)  # strict
    # flax kernels are [in, out]; the port keeps [out, in]
    assert flat["trunk.w0"].shape == (KW["hidden"], 3 * 9 + KW["cp_rank"])
    assert flat["view_mlp.layers.0.weight"].shape == (32, 31)


def test_seeded_init_is_deterministic():
    a = MLPField(**KW, device="cpu", seed=3).state_dict()
    b = MLPField(**KW, device="cpu", seed=3).state_dict()
    c = MLPField(**KW, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.w0"], c["trunk.w0"])


@pytest.mark.parametrize("field_type", ["hashgrid", "hashgrid_packed"])
def test_hashgrid_fields_not_ported(field_type):
    """Both hash-grid field types build through make_field (dropping the
    MLP field's keywords, as the CLI passes them) and render one training
    batch with its losses and grads.  With with_mask (stage 3) the object
    field's table m_grid is built at feature_grid_spec() (16 levels x 8),
    corner-packed when the field is: the plain table at its published size,
    the packed one (8x that, 1.35 GB) by its spec and, built, at a small
    feat_spec."""
    import dataclasses

    from sanerf_hq_tpu_torch.models import SANeRFField
    from sanerf_hq_tpu_torch.models.fields import (feature_grid_spec,
                                                   mask_grid_spec,
                                                   prop_grid_spec)
    from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
    from sanerf_hq_tpu_torch.render import renderer as tr

    small = dict(main_spec=HashGridSpec(num_levels=3, base_resolution=8,
                                        log2_hashmap_size=10,
                                        desired_resolution=32),
                 prop_spec_0=prop_grid_spec(32), prop_spec_1=prop_grid_spec(64))
    f = make_field(field_type, device="cpu", cp_rank=8, hidden=16, **small)
    assert isinstance(f, SANeRFField)
    assert f.packed == (field_type == "hashgrid_packed")
    assert f.grid.shape == (f.grid_spec.total_params,
                            16 if f.packed else 2)
    g = torch.Generator().manual_seed(0)
    ro, rd = torch.randn(32, 3, generator=g) * 0.3, torch.randn(32, 3,
                                                                  generator=g)
    settings = tr.RenderSettings(num_steps=(16, 8, 8), training=True,
                                 compute_losses=True, perturb=True)
    out = tr.render_rays(f, ro, rd, settings, generator=g)
    (out["image"].mean() + out["proposal_loss"]).backward()
    assert out["image"].shape == (32, 3) and out["weights"].shape == (32, 8)
    assert torch.isfinite(out["image"]).all()
    assert f.grid.grad.abs().sum() > 0 and f.prop_grid_1.grad.abs().sum() > 0
    packed = field_type == "hashgrid_packed"
    want = dataclasses.replace(feature_grid_spec(), packed=packed)
    assert mask_grid_spec("default", None, packed) == want
    if packed:
        feat = HashGridSpec(num_levels=3, level_dim=8, base_resolution=8,
                            log2_hashmap_size=10, desired_resolution=32)
        m = make_field(field_type, device="cpu", with_mask=True,
                       feat_spec=feat, **small)
        assert m.m_spec == dataclasses.replace(feat, packed=True)
        assert m.m_grid.shape == (feat.total_params, 64)
    else:
        m = make_field(field_type, device="cpu", with_mask=True, **small)
        assert m.m_spec == want
        assert m.m_grid.shape == (want.total_params, 8) == (5_258_512, 8)
    assert m.mask_mlp.layers[0].weight.shape == (256, m.m_spec.output_dim
                                                  + 15)
