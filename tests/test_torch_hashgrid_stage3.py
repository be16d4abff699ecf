"""The hash-grid field's object field (stage 3: `m_grid` and the mask MLP)
and the MLP field's `feat_rep="hashgrid"` mask table in the port, with
weights carried across from the JAX fields (params_from_jax), held to the
JAX package on the CPU with shared inputs:
  - the converted trees load strictly, for both mask MLP types, plain and
    packed;
  - `mask_features` and `apply_mask_mlp`;
  - `render_rays` with `return_mask` on the composable route (the
    hash-grid field has no level kernels), in training over the frozen
    backbone and at inference, JAX's sample_pdf running its Pallas lookup
    (K10) in interpret mode;
  - three mask steps with --lambda_tv and --lambda_wd against JAX's own
    `make_mask_train_step` (its loss with `_grid_regularizers(..., "mask")`)
    and create_train_state over the frozen backbone, the TV points shared;
  - the MLP field's m_grid: `mask_features` and its frozen-route render
    (K5, K6; plain twins here) against JAX's frozen route in interpret
    mode.
Small specs keep the tables small; the published ones are checked in
tests/test_torch_field.py.

Bars (tests/test_torch_hashgrid_field.py's): field methods rel-max <=
1e-5 (fp32 both); the render's logits, image and depth max abs <= 1e-4,
the mask branch's grads per-leaf rel-L2 <= 1e-3; the steps' loss rel 1e-3
and m_grid / mask_mlp rel-L2 <= 2e-3 after three updates, the backbone
bitwise unchanged; the MLP field's frozen route at the bars of
tests/test_torch_stage3_render.py (3e-2 max abs on the logits).
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sanerf_hq_tpu.ops.fused_mlp as jfm
import sanerf_hq_tpu.ops.render_level_pallas as rlp
import sanerf_hq_tpu.ops.sample_pdf_pallas as jsp
import sanerf_hq_tpu.train.steps as jsteps
from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.models.fields import SANeRFField as JaxField
from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu.ops.hashgrid import HashGridSpec as JaxSpec
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu.train.state import (create_train_state,
                                       freeze_mask_from_loaded)
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.models import MLPField, SANeRFField, params_from_jax
from sanerf_hq_tpu_torch.models.fields import (active_reg_grid,
                                               lightweight_mask_grid_spec)
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.render import renderer as tr
from sanerf_hq_tpu_torch.train.state import TrainState
from sanerf_hq_tpu_torch.train.steps import make_mask_train_step

N, C = 64, 3  # rays, instances
MAIN = dict(num_levels=4, level_dim=2, base_resolution=8,
            log2_hashmap_size=12, desired_resolution=64)
PROP = dict(num_levels=3, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
FEAT = dict(num_levels=4, level_dim=8, base_resolution=8,
            log2_hashmap_size=11, desired_resolution=64)
STEPS = dict(num_steps=(16, 8, 8), bound=4.0, min_near=0.05)
MASK = ("m_grid", "mask_mlp")
KINDS = [("default", False), ("default", True), ("lightweight_mask", False),
         ("lightweight_mask", True)]
IDS = ["default-plain", "default-packed", "lightweight-plain",
       "lightweight-packed"]


def _specs(cls, packed):
    return dict(main_spec=cls(**MAIN, packed=packed), feat_spec=cls(**FEAT),
                prop_spec_0=cls(**PROP, packed=packed),
                prop_spec_1=cls(**dict(PROP, desired_resolution=48),
                                packed=packed))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _is_mask(name):
    return name.split(".")[0] in MASK


@functools.lru_cache(maxsize=None)
def _fields(mask_mlp_type: str, packed: bool):
    """(JAX field, its parameters, the port's field with them).  Every
    table of order 0.3 instead of 1e-4, so that the outputs depend on
    them."""
    jm = JaxField(with_mask=True, mask_mlp_type=mask_mlp_type, n_inst=C,
                  packed=packed, **_specs(JaxSpec, False))
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    rng = np.random.default_rng(0)
    p = dict(params["params"])
    for name in ("grid", "prop_grid_0", "prop_grid_1", "m_grid"):
        p[name] = rng.normal(size=p[name].shape).astype(np.float32) * 0.3
    params = {"params": p}
    tm = SANeRFField(with_mask=True, mask_mlp_type=mask_mlp_type, n_inst=C,
                     packed=packed, **_specs(HashGridSpec, False),
                     device="cpu")
    tm.load_state_dict(params_from_jax(params))  # strict
    return jm, params, tm


@pytest.fixture(params=KINDS, ids=IDS)
def fields(request):
    return _fields(*request.param)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1)
    ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd, rng.integers(0, C, N)


@pytest.fixture()
def k10_interpret(monkeypatch):
    """JAX's sample_pdf through its Pallas lookup, in interpret mode."""
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    monkeypatch.setattr(jsp, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))


def test_params_from_jax_loads_strictly(fields):
    jm, params, tm = fields
    state = params_from_jax(params)
    assert state.keys() == tm.state_dict().keys()
    assert {k for k in state if _is_mask(k)} == {
        "m_grid", "mask_mlp.layers.0.weight", "mask_mlp.layers.1.weight",
        "mask_mlp.layers.2.weight"}
    assert state["m_grid"].shape == tuple(params["params"]["m_grid"].shape)
    if jm.mask_mlp_type == "default":
        # feat_spec, corner-packed with the field
        assert tm.m_spec.packed == tm.packed
        assert tm.m_grid.shape[1] == (64 if tm.packed else 8)
        assert state["mask_mlp.layers.0.weight"].shape == (256, 32 + 15)
    else:  # the lightweight table is never packed
        assert not tm.m_spec.packed and tm.m_grid.shape[1] == 2
        assert tm.m_spec.total_params == 16 * 1024
        assert state["mask_mlp.layers.0.weight"].shape == (64, 32 + 31)
    assert active_reg_grid(tm, "mask") == ("m_grid", tm.m_spec)
    assert active_reg_grid(tm, "rgb") == ("grid", tm.grid_spec)


def test_mask_features_and_mask_mlp(fields):
    jm, params, tm = fields
    rng = np.random.default_rng(2)
    x = rng.uniform(-2.2, 2.2, (8, 16, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), method=JaxField.mask_features)
    got = tm.mask_features(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.detach(), want) <= 1e-5
    m = rng.normal(size=(64, want.shape[-1] + (
        15 if jm.mask_mlp_type == "default" else 31))).astype(np.float32)
    want = jm.apply(params, jnp.asarray(m), method=JaxField.apply_mask_mlp)
    got = tm.apply_mask_mlp(torch.from_numpy(m))
    assert got.shape == want.shape == (64, C)
    assert _rel(got.detach(), want) <= 1e-5


def test_seeded_backbone_does_not_depend_on_the_mask_branch():
    """m_grid and the mask MLP are drawn after the backbone."""
    specs = _specs(HashGridSpec, False)
    a = SANeRFField(**specs, device="cpu", seed=4).state_dict()
    b = SANeRFField(with_mask=True, **specs, device="cpu", seed=4)
    for name, v in a.items():
        assert torch.equal(v, b.state_dict()[name]), name
    assert float(b.m_grid.detach().abs().max()) <= 1e-4


def _mask_ce(logits, gt):
    return torch.nn.functional.cross_entropy(logits, torch.from_numpy(gt))


@pytest.mark.parametrize("training", [True, False],
                         ids=["train-frozen", "inference"])
def test_mask_render_matches_jax(fields, rays, k10_interpret, training):
    jm, params, tm = fields
    ro, rd, gt = rays
    kw = dict(STEPS, return_mask=True, training=training,
              frozen_backbone=training)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(ro), jnp.asarray(rd),
                       jr.RenderSettings(**kw),
                       method=lambda m, o, d, s: jr.render_rays(m, o, d, s))
        logp = jax.nn.log_softmax(out["instance_mask_logits"], axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(gt)[:, None], axis=-1)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**kw))
    for k in ("instance_mask_logits", "image", "depth", "weights_sum"):
        a, b = out[k].detach().numpy(), np.asarray(jout[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-4, k
    ce = _mask_ce(out["instance_mask_logits"], gt)
    assert ce.item() == pytest.approx(float(jl), rel=1e-4)
    named = dict(tm.named_parameters())
    names = [n for n in named if _is_mask(n)]
    grads = torch.autograd.grad(ce, [named[n] for n in names])
    want = params_from_jax(jax.device_get(jg))
    for name, g in zip(names, grads):
        assert np.linalg.norm(want[name].numpy()) > 0, name
        assert _rel_l2(g, want[name]) <= 1e-3, name


NG, P, PS, S = 48, 2, 4, 8  # global rays, patches, patch size, map size
LAMBDA_TV, LAMBDA_WD = 0.05, 0.5


def _mask_batch(seed):
    rng = np.random.default_rng(seed)
    n = NG + P * PS * PS
    ro = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gt = rng.integers(0, C, n)
    gt[rng.choice(NG, 5, replace=False)] = -1
    cells = rng.choice(2 * S * S, NG, replace=False)
    return {"rays_o": ro, "rays_d": rd, "gt_masks": gt,
            "img_inds": cells // (S * S), "inds_coarse": cells % (S * S),
            "local_error": rng.uniform(0, 0.4, P * PS * PS).astype(
                np.float32)}


@pytest.mark.parametrize("kind", KINDS[:3], ids=IDS[:3])
def test_three_mask_steps_with_tv_and_wd_match_jax(kind, k10_interpret):
    """make_mask_train_step over the frozen backbone with --lambda_tv and
    --lambda_wd, against JAX's jitted mask step (render, CE, label
    regularisation, ray-pair loss with every patch ray an anchor, so that
    its mean does not depend on the draw, and `_grid_regularizers(...,
    "mask")`) and create_train_state freezing what a stage-1 checkpoint
    holds.  The TV points are JAX's draw from the step's key (fold_in 2),
    handed to the port's loss as tv_points."""
    jm, params, _ = _fields(*kind)
    common = dict(STEPS, iters=10, lr=1e-2, num_rays=NG, n_inst=C,
                  num_local_sample=P, local_sample_patch_size=PS,
                  error_map_size=S, ray_pair_rgb_loss_weight=1.0,
                  ray_pair_rgb_num_sample=PS * PS, ray_pair_rgb_iter=1,
                  label_regularization_weight=0.5, lambda_tv=LAMBDA_TV,
                  lambda_wd=LAMBDA_WD, contract=True)
    jcfg, cfg = JaxConfig(**common), Config(**common)
    stage1 = {"params": {k: v for k, v in params["params"].items()
                         if k not in MASK}}
    jstate = create_train_state(
        params, cfg.lr, cfg.iters,
        freeze_mask=freeze_mask_from_loaded(params, stage1))
    jstep = jsteps.make_mask_train_step(jm, jcfg, frozen_backbone=True)
    assert jsteps._grid_regularizers(jm, jcfg, "mask") is not None

    tm = SANeRFField(with_mask=True, mask_mlp_type=kind[0], n_inst=C,
                     packed=kind[1], **_specs(HashGridSpec, False),
                     device="cpu")
    p0 = params_from_jax(params)
    tm.load_state_dict(p0)
    state = TrainState(tm, cfg.lr, cfg.iters,
                       frozen=[n for n in p0 if not _is_mask(n)])
    step_fn = make_mask_train_step(tm, cfg, frozen_backbone=True)
    em = np.random.default_rng(9).uniform(0.1, 1.0, (2, S * S)).astype(
        np.float32)
    jmap, tmap = jnp.asarray(em), torch.from_numpy(em)
    for step in range(3):
        b = _mask_batch(10 + step)
        key = jax.random.PRNGKey(step)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jstate, jmetrics, jmap = jstep(jstate, dict(jb, step=step), key,
                                       jmap)
        tv_points = np.array(jax.random.uniform(
            jax.random.fold_in(key, 2), (8192, 3), dtype=jnp.float32))
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        loss, metrics, tmap = step_fn.loss_fn(
            tb, step, tmap, torch.Generator().manual_seed(step),
            tv_points=torch.from_numpy(tv_points))
        loss.backward()
        state.apply_gradients()
        assert loss.item() == pytest.approx(float(jmetrics["loss"]),
                                            rel=1e-3), step
        assert metrics["ce"].item() == pytest.approx(
            float(jmetrics["ce"]), rel=1e-3), step
        np.testing.assert_allclose(tmap.numpy(), np.asarray(jmap),
                                   rtol=1e-4, atol=1e-6)
    # the TV / WD term is in the loss: without it the loss is lower
    no_reg = make_mask_train_step(tm, cfg.replace(lambda_tv=0, lambda_wd=0),
                                  frozen_backbone=True)
    plain, _, _ = no_reg.loss_fn(tb, 3, tmap)
    with_reg, _, _ = step_fn.loss_fn(tb, 3, tmap,
                                     tv_points=torch.from_numpy(tv_points))
    assert with_reg.item() > plain.item()
    assert state.step == int(jstate.step) == 3
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        if _is_mask(name):
            assert float((p.detach() - p0[name]).abs().max()) > 0, name
            assert _rel_l2(p.detach(), want[name]) <= 2e-3, name
        else:
            assert torch.equal(p.detach(), p0[name]), name


MLP_KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
              prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
              cp_res=16, with_mask=True, n_inst=C, feat_rep="hashgrid")


@functools.lru_cache(maxsize=None)
def _mlp_fields(mask_mlp_type):
    kw = dict(MLP_KW, mask_mlp_type=mask_mlp_type)
    jm = JaxMLPField(**kw, feat_spec=JaxSpec(**FEAT))
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    p = dict(params["params"])
    p["m_grid"] = np.random.default_rng(5).normal(
        size=p["m_grid"].shape).astype(np.float32) * 0.3
    params = {"params": p}
    tm = MLPField(**kw, feat_spec=HashGridSpec(**FEAT), device="cpu")
    tm.load_state_dict(params_from_jax(params))  # strict
    return jm, params, tm


@pytest.mark.parametrize("mask_mlp_type", ["default", "lightweight_mask"])
def test_mlp_field_hashgrid_mask_features(mask_mlp_type):
    jm, params, tm = _mlp_fields(mask_mlp_type)
    assert not hasattr(tm, "cp_m_proj")
    spec = tm.m_spec
    assert spec == (HashGridSpec(**FEAT) if mask_mlp_type == "default"
                    else lightweight_mask_grid_spec())
    assert tm.m_grid.shape == (spec.total_params, spec.level_dim)
    x = np.random.default_rng(6).uniform(-2.2, 2.2, (8, 16, 3)).astype(
        np.float32)
    want = jm.apply(params, jnp.asarray(x), method=JaxMLPField.mask_features)
    got = tm.mask_features(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got.detach(), want) <= 1e-5


def test_mlp_field_hashgrid_frozen_route_matches_jax(monkeypatch):
    """Over a frozen backbone the MLP field keeps its level kernels (K5,
    K6; plain twins on the CPU) and reads only its mask features from
    m_grid; JAX's frozen route runs in Pallas interpret mode."""
    jm, params, tm = _mlp_fields("default")
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    monkeypatch.setattr(rlp, "INTERPRET", True)
    monkeypatch.setattr(rlp, "R_TILE", N)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)
    rng = np.random.default_rng(7)
    ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    kw = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05,
              return_mask=True, training=True, frozen_backbone=True)
    want = jm.apply(params, jnp.asarray(ro), jnp.asarray(rd),
                    jr.RenderSettings(**kw),
                    method=lambda m, o, d, s: jr.render_rays(m, o, d, s))
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**kw))
    a = out["instance_mask_logits"].detach().numpy()
    b = np.asarray(want["instance_mask_logits"])
    assert a.shape == b.shape == (N, C)
    assert np.abs(a - b).max() < 3e-2
    out["instance_mask_logits"].sum().backward()
    for name, p in tm.named_parameters():
        assert (p.grad is not None) == _is_mask(name), name
        p.grad = None
