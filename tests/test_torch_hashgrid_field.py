"""The port's hash-grid field (`models/fields.py` SANeRFField, plain and
packed) with weights carried across from the JAX field (params_from_jax),
held to the JAX package on the CPU with shared inputs:
  - the field's methods;
  - render_rays on the composable route, inference and training with its
    losses and grads, JAX's sample_pdf running its Pallas lookup (K10) in
    interpret mode;
  - five `make_rgb_train_step` steps with --lambda_wd against a reference
    built from JAX's training render, the same loss and JAX's
    `_grid_regularizers` and create_train_state (no lr scales: only the
    MLP field has them);
  - the trainer's handling of the field (lr scales, backbone names), and
    the CLI with its default --field_type: train, checkpoint, resume.
Small specs (4 and 3 levels) keep the tables small; the published ones are
held in tests/test_torch_hashgrid.py.

Bars: field methods rel-max <= 1e-5 (fp32 both); renders max abs <= 1e-4
on image, depth, weights_sum and weights, losses rel 1e-4, grads per-leaf
rel-L2 <= 1e-3 (the resampled bins of both sides differ by about 1e-7,
and the features at them follow); the train steps' bars are stated in
their test.
"""
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sanerf_hq_tpu.ops.fused_mlp as jfm
import sanerf_hq_tpu.ops.sample_pdf_pallas as jsp
from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.models.fields import SANeRFField as JaxField
from sanerf_hq_tpu.ops.hashgrid import HashGridSpec as JaxSpec
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu.train.state import create_train_state
from sanerf_hq_tpu.train.steps import _grid_regularizers as jax_regs
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.synthetic import write_llff_scene
from sanerf_hq_tpu_torch.models import MLPField, SANeRFField, params_from_jax
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.render import renderer as tr
from sanerf_hq_tpu_torch.train.state import TrainState
from sanerf_hq_tpu_torch.train.steps import make_rgb_train_step
from sanerf_hq_tpu_torch.train.trainer import Trainer, backbone_all_frozen

N = 64
MAIN = dict(num_levels=4, level_dim=2, base_resolution=8,
            log2_hashmap_size=12, desired_resolution=64)
PROP = dict(num_levels=3, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
STEPS = dict(num_steps=(16, 8, 8), bound=4.0, min_near=0.05)
LAMBDA_DISTORT = 0.02


def _specs(cls, packed):
    return dict(main_spec=cls(**MAIN, packed=packed),
                prop_spec_0=cls(**PROP, packed=packed),
                prop_spec_1=cls(**dict(PROP, desired_resolution=48),
                                packed=packed))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@functools.lru_cache(maxsize=None)
def _fields(packed: bool):
    """(JAX field, its parameters, the port's field with them)."""
    jm = JaxField(packed=packed, **_specs(JaxSpec, False))
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    # tables of order 0.3 instead of 1e-4, so that the density and the
    # colour depend on the grids
    rng = np.random.default_rng(0)
    p = dict(params["params"])
    for name in ("grid", "prop_grid_0", "prop_grid_1"):
        p[name] = rng.normal(size=p[name].shape).astype(np.float32) * 0.3
    params = {"params": p}
    tm = SANeRFField(packed=packed, **_specs(HashGridSpec, False),
                     device="cpu")
    tm.load_state_dict(params_from_jax(params))  # strict
    return jm, params, tm


@pytest.fixture(params=[False, True], ids=["plain", "packed"])
def fields(request):
    return _fields(request.param)


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(5):
        ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
        rd = rng.normal(size=(N, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        batches.append((ro, rd, rng.uniform(0, 1, (N, 3)).astype(np.float32)))
    return batches


@pytest.fixture()
def k10_interpret(monkeypatch):
    """JAX's sample_pdf through its Pallas lookup, in interpret mode."""
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    monkeypatch.setattr(jsp, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))


def test_params_from_jax_covers_the_field(fields):
    _, params, tm = fields
    state = params_from_jax(params)
    assert state.keys() == tm.state_dict().keys()
    assert state["grid"].shape == tuple(params["params"]["grid"].shape)
    assert state["grid_mlp.layers.0.weight"].shape == (64, 8)
    assert state["prop_mlp_1.layers.1.weight"].shape == (1, 16)
    assert tm.grid.shape[1] == (16 if tm.packed else 2)


@pytest.mark.parametrize("proposal", [-1, 0, 1])
def test_density(fields, proposal):
    jm, params, tm = fields
    x = np.random.default_rng(2).uniform(-2, 2, (8, 16, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), proposal=proposal,
                    method=JaxField.density)
    got = tm.density(torch.from_numpy(x), proposal=proposal)
    assert got.shape == want.shape
    assert _rel(got.detach(), want) <= 1e-5


def test_forward_color_and_view_mlp(fields):
    jm, params, tm = fields
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 2, (8, 16, 3)).astype(np.float32)
    d = rng.normal(size=(8, 16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(d),
                    method=JaxField.forward_color)
    got = tm.forward_color(torch.from_numpy(x), torch.from_numpy(d))
    for name, a, b in zip(("sigma", "feat", "color", "grid_output"), got,
                          want):
        assert a.shape == b.shape, name
        assert _rel(a.detach(), b) <= 1e-5, name
    f = rng.normal(size=(32, 31)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(f), method=JaxField.apply_view_mlp)
    got = tm.apply_view_mlp(torch.from_numpy(f))
    assert _rel(got.detach(), want) <= 1e-5


def _jax_loss(jm, settings, ro, rd, gt, lam, reg=None):
    def loss(p):
        out = jm.apply(p, jnp.asarray(ro), jnp.asarray(rd), settings,
                       method=lambda m, o, d, s: jr.render_rays(m, o, d, s))
        total = (jnp.mean((out["image"] - gt) ** 2) + out["proposal_loss"]
                 + lam * out["distort_loss"])
        if reg is not None:
            total = total + reg(p, None)
        return total, out
    return loss


def test_inference_render_matches_jax(fields, rays, k10_interpret):
    jm, params, tm = fields
    ro, rd, _ = rays[0]
    want = jm.apply(params, jnp.asarray(ro), jnp.asarray(rd),
                    jr.RenderSettings(**STEPS),
                    method=lambda m, o, d, s: jr.render_rays(m, o, d, s))
    with torch.inference_mode():
        got = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                             tr.RenderSettings(**STEPS))
    for k in ("image", "depth", "weights_sum"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-4, k


def test_training_render_matches_jax(fields, rays, k10_interpret):
    jm, params, tm = fields
    ro, rd, gt = rays[0]
    js = jr.RenderSettings(**STEPS, training=True, compute_losses=True)
    (jl, jout), jg = jax.value_and_grad(
        _jax_loss(jm, js, ro, rd, gt, LAMBDA_DISTORT), has_aux=True)(params)

    tm.zero_grad(set_to_none=True)
    ts = tr.RenderSettings(**STEPS, training=True, compute_losses=True)
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd), ts)
    tl = (torch.mean((out["image"] - torch.from_numpy(gt)) ** 2)
          + out["proposal_loss"] + LAMBDA_DISTORT * out["distort_loss"])
    tl.backward()
    for k in ("image", "depth", "weights_sum", "weights"):
        a, b = out[k].detach().numpy(), np.asarray(jout[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-4, k
    for k in ("proposal_loss", "distort_loss"):
        assert float(out[k].detach()) == pytest.approx(
            float(jout[k]), rel=1e-4, abs=1e-8), k
    assert tl.item() == pytest.approx(float(jl), rel=1e-4)
    want = params_from_jax(jax.device_get(jg))
    for name, p in tm.named_parameters():
        assert np.linalg.norm(want[name].numpy()) > 0, name
        assert _rel_l2(p.grad, want[name]) <= 1e-3, name
    tm.zero_grad(set_to_none=True)


def test_five_train_steps_match_jax(rays, k10_interpret):
    """make_rgb_train_step without jitter, with weight decay on the main
    table, against JAX's training render, the same loss, JAX's own
    `_grid_regularizers` term and create_train_state, step by step on the
    same batches.  The plain field: the packed encoding jumps at every cell
    face (a cell's corners are its own), so once training has moved the
    bins a 1e-7 shift of a sample can cross one and the two sides part;
    the packed field is held to JAX on one step above.

    Bars (the MLP field's, tests/test_torch_train.py): the loss of every
    step within rel 1e-3; each parameter leaf within rel-L2 2e-3 of JAX's
    after five updates (Adam moves each entry by about lr a step, far more
    than the bar).  Both sides are fp32 here and agree to about 1e-6."""
    jm, params, _ = _fields(False)
    lam_wd, warm = 0.5, 1
    cfg = Config(**STEPS, iters=10, lr=1e-2, lambda_distort=LAMBDA_DISTORT,
                 lambda_distort_warmup=warm, lambda_wd=lam_wd)
    tm = SANeRFField(**_specs(HashGridSpec, False), device="cpu")
    tm.load_state_dict(params_from_jax(params))
    state = TrainState(tm, cfg.lr, cfg.iters)
    step_fn = make_rgb_train_step(tm, cfg, perturb=False)
    reg = jax_regs(jm, JaxConfig(lambda_wd=lam_wd), "rgb")
    assert reg is not None
    jstate = create_train_state(params, base_lr=cfg.lr, total_iters=cfg.iters)
    js = jr.RenderSettings(**STEPS, training=True, compute_losses=True)
    for step, (ro, rd, gt) in enumerate(rays):
        lam = LAMBDA_DISTORT * min(max((step - warm) / warm, 0.0), 1.0)
        (jl, _), jg = jax.value_and_grad(
            _jax_loss(jm, js, ro, rd, gt, lam, reg), has_aux=True)(
            jstate.params)
        jstate = jstate.apply_gradients(jg)
        m = step_fn(state, {"rays_o": torch.from_numpy(ro),
                            "rays_d": torch.from_numpy(rd),
                            "gt_rgb": torch.from_numpy(gt)})
        assert float(m["loss"]) == pytest.approx(float(jl), rel=1e-3), step
    assert state.step == int(jstate.step) == 5
    p0 = params_from_jax(params)
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        assert float((p.detach() - p0[name]).abs().max()) > 0, name
        assert _rel_l2(p.detach(), want[name]) <= 2e-3, name


def test_trainer_lr_scales_and_backbone_names(tmp_path):
    """Only the MLP field's dense weights train at 0.05x: every leaf of the
    hash-grid field takes the base lr.  Freezing every stage-1 parameter
    of either field freezes its whole backbone."""
    cfg = Config(lr=1e-2, iters=10)
    hg = SANeRFField(**_specs(HashGridSpec, False), device="cpu")
    t = Trainer("ngp", cfg, hg, str(tmp_path / "a"), resume=False)
    assert [g["scale"] for g in t.state.optimizer.param_groups] == [1.0]
    names = {n for n, _ in hg.named_parameters()}
    assert backbone_all_frozen(hg, names)
    assert not backbone_all_frozen(hg, names - {"grid"})
    mlp = MLPField(hidden=32, num_layers=2, freq_degree=2, prop_hidden=16,
                   prop_layers=2, prop_freq_degree=2, cp_rank=4, cp_res=8,
                   device="cpu")
    t = Trainer("ngp", cfg, mlp, str(tmp_path / "b"), resume=False)
    assert sorted(g["scale"] for g in t.state.optimizer.param_groups) == [
        0.05, 1.0]


def test_cli_default_field_trains_checkpoints_and_resumes(tmp_path, capsys):
    """`python -m sanerf_hq_tpu_torch <scene>` with no --field_type trains
    the published hash-grid field; the checkpoint holds its 6.3M-row table
    and Adam's moments for it; --test resumes and renders the same
    image."""
    scene = str(tmp_path / "scene")
    write_llff_scene(scene, n_views=17, H=24, W=24)
    ws = str(tmp_path / "ws")
    small = ["--data_type", "llff", "--workspace", ws, "--device", "cpu",
             "--num_steps", "16", "8", "8"]
    trainer = cli.main([scene, *small, "--num_points", "512", "--iters", "3",
                        "--eval_cnt", "1", "--save_cnt", "1",
                        "--lambda_tv", "1e-3", "--lambda_wd", "1e-3"])
    out = capsys.readouterr().out
    assert isinstance(trainer.model, SANeRFField) and not trainer.model.packed
    assert trainer.state.step == 3 and trainer.cfg.num_rays == 64
    assert trainer.model.grid.shape == (6_299_960, 2)
    assert "[EVAL] SSIM" in out
    assert np.isfinite(trainer.stats["loss"]).all()
    ckpt = torch.load(os.path.join(ws, "checkpoints", "step_00000003.pt"),
                      weights_only=True)
    assert torch.equal(ckpt["model"]["grid"], trainer.model.grid.detach())
    opt = trainer.state.optimizer.state_dict()["state"]
    for i, s in ckpt["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s[k], opt[i][k]), (i, k)
    assert any(s["exp_avg"].shape == (6_299_960, 2)
               for s in ckpt["optimizer"]["state"].values())

    tested = cli.main([scene, *small, "--test"])
    assert "[INFO] resumed at step 3" in capsys.readouterr().out
    from sanerf_hq_tpu_torch.data.provider import load_scene
    s = load_scene(scene, "llff")
    got = tested.render_view(s.poses[0], s.intrinsics[0], 24, 24)
    want = trainer.render_view(s.poses[0], s.intrinsics[0], 24, 24)
    np.testing.assert_array_equal(got["image"], want["image"])
    assert os.path.exists(os.path.join(ws, "results", "v16_rgb.png"))
