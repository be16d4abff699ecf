"""The port's stage-1 training path against the JAX package on the CPU,
with the same (converted) weights and the same ray batches:
  - the training render, both routes: the composable route (autograd
    through the plain field) against JAX's composable route, and the
    level-kernel route (K1/K2 and K3/K4 twins behind the autograd
    Functions) against JAX's fused route run in Pallas interpret mode;
    outputs, losses and grads, with the proposal update on and off;
  - five train steps of `make_rgb_train_step` without jitter against a
    reference built from JAX's render_rays(training=True, perturb=False,
    compute_losses=True), the same loss formula and create_train_state
    (the JAX step always jitters with JAX keys);
  - the batch sampler's semantics.
Bars: max abs < 2e-2 on image, depth, weights_sum and weights and rel 2e-2
on the losses (the JAX package's bar between its fused and composable
routes); per-leaf grad rel-L2 <= 5% (bench.py and GRAD_PARITY.json); the
train steps' bars are stated in their test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.fused_mlp as jfm
import sanerf_hq_tpu.ops.render_level_pallas as rlp
from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu.train.state import create_train_state
from sanerf_hq_tpu.train.state import mlp_field_lr_scales as jax_scales
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.rays import rays_from_pixels
from sanerf_hq_tpu_torch.data.sampler import sample_rgb_batch
from sanerf_hq_tpu_torch.models import MLPField, params_from_jax
from sanerf_hq_tpu_torch.render import renderer as tr
from sanerf_hq_tpu_torch.train.state import TrainState, mlp_field_lr_scales
from sanerf_hq_tpu_torch.train.steps import make_rgb_train_step

N = 64
KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
          prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
          cp_res=16)
STEPS = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05)
LAMBDA_DISTORT = 0.02


@pytest.fixture(scope="module")
def setup():
    jm = JaxMLPField(**KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                              jnp.ones((4, 3)))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(5):
        ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
        rd = rng.normal(size=(N, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        gt = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        batches.append((ro, rd, gt))
    return jm, params, batches


def _port_field(params):
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return tm


@pytest.fixture()
def fused(request, monkeypatch):
    """Route the JAX renderer: composable, or fused in interpret mode."""
    kernels = request.param == "kernels"
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", kernels)
    if kernels:
        monkeypatch.setattr(rlp, "INTERPRET", True)
        for name in ("R_TILE", "R_TILE_BWD", "R_TILE_BWD_FINAL"):
            monkeypatch.setattr(rlp, name, N)
        monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it
    return kernels


def _jax_loss(jm, settings, ro, rd, gt, upd, lam):
    def loss(p):
        out = jm.apply(p, jnp.asarray(ro), jnp.asarray(rd), settings,
                       method=lambda m, o, d, s: jr.render_rays(
                           m, o, d, s, update_proposal=upd))
        total = (jnp.mean((out["image"] - gt) ** 2) + out["proposal_loss"]
                 + lam * out["distort_loss"])
        return total, out
    return loss


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("fused", ["composable", "kernels"], indirect=True)
@pytest.mark.parametrize("upd", [True, False])
def test_training_render_matches_jax(setup, fused, upd):
    jm, params, batches = setup
    ro, rd, gt = batches[0]
    js = jr.RenderSettings(**STEPS, training=True, compute_losses=True)
    loss = _jax_loss(jm, js, ro, rd, gt, upd, LAMBDA_DISTORT)
    (jl, jout), jg = jax.value_and_grad(loss, has_aux=True)(params)

    tm = _port_field(params)
    ts = tr.RenderSettings(**STEPS, training=True, compute_losses=True,
                           level_kernels=fused)
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd), ts,
                         update_proposal=upd)
    tl = (torch.mean((out["image"] - torch.from_numpy(gt)) ** 2)
          + out["proposal_loss"] + LAMBDA_DISTORT * out["distort_loss"])
    tl.backward()

    assert out["num_points"] == N * STEPS["num_steps"][-1]
    for k in ("image", "depth", "weights_sum", "weights"):
        a, b = out[k].detach().numpy(), np.asarray(jout[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() < 2e-2, k
    for k in ("proposal_loss", "distort_loss"):
        assert float(out[k].detach()) == pytest.approx(
            float(jout[k]), rel=2e-2, abs=1e-7), k
    assert tl.item() == pytest.approx(float(jl), rel=2e-2)
    want = params_from_jax(jax.device_get(jg))
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        if "prop_mlp" in name and not upd:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
            assert np.abs(w).max() == 0.0, name
            continue
        assert np.linalg.norm(w) > 0, name
        assert _rel_l2(p.grad, w) <= 0.05, (name, _rel_l2(p.grad, w))


@pytest.mark.parametrize("fused", ["composable", "kernels"], indirect=True)
def test_five_train_steps_match_jax(setup, fused):
    """make_rgb_train_step without jitter against JAX's training render, the
    same loss formula and create_train_state, step by step on the same
    batches (the distortion ramp starts at step 1 here).

    Bars: the loss of every step within rel 1e-3 (same weights, same fp32
    loss; only the bf16 rounding points differ).  Each parameter leaf
    within 2e-3 of its norm after five updates: Adam's first steps move a
    weight by about lr x 0.05 whatever the size of its grad, so weights
    with near-zero grads (the first proposal MLP's) take steps of either
    sign when JAX's bf16-rounded cotangents and the port's fp32 ones differ
    in the last bits; five steps move each leaf by about 2.5% of its norm,
    so the bar catches a wrong lr, scale or moment at a tenth of that."""
    jm, params, batches = setup
    warm = 1
    cfg = Config(**STEPS, iters=10, lr=1e-2, lambda_distort=LAMBDA_DISTORT,
                 lambda_distort_warmup=warm)
    tm = _port_field(params)
    state = TrainState(tm, cfg.lr, cfg.iters,
                       lr_scales=mlp_field_lr_scales(tm))
    step_fn = make_rgb_train_step(tm, cfg, perturb=False,
                                  level_kernels=fused)
    jstate = create_train_state(params, base_lr=cfg.lr, total_iters=cfg.iters,
                                lr_scales=jax_scales(params))
    js = jr.RenderSettings(**STEPS, training=True, compute_losses=True)
    for step, (ro, rd, gt) in enumerate(batches):
        lam = LAMBDA_DISTORT * min(max((step - warm) / warm, 0.0), 1.0)
        loss = _jax_loss(jm, js, ro, rd, gt, True, lam)
        (jl, _), jg = jax.value_and_grad(loss, has_aux=True)(jstate.params)
        jstate = jstate.apply_gradients(jg)
        m = step_fn(state, {"rays_o": torch.from_numpy(ro),
                            "rays_d": torch.from_numpy(rd),
                            "gt_rgb": torch.from_numpy(gt)})
        assert float(m["loss"]) == pytest.approx(float(jl), rel=1e-3), step
    assert state.step == int(jstate.step) == 5
    p0 = params_from_jax(jax.device_get(params))
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        assert float((p.detach() - p0[name]).abs().max()) > 0, name
        assert _rel_l2(p.detach(), want[name]) <= 2e-3, name


def test_sample_rgb_batch_semantics():
    g = torch.Generator().manual_seed(0)
    V, H, W = 3, 6, 5
    images = torch.rand(V, H, W, 3, generator=g)
    poses = torch.eye(4).repeat(V, 1, 1)
    poses[:, :3, 3] = torch.rand(V, 3, generator=g)
    intr = torch.tensor([[4.0, 4.0, 2.5, 3.0], [5.0, 5.0, 2.5, 3.0],
                         [6.0, 6.0, 2.0, 2.0]])
    cnf = torch.rand(V, 2, generator=g)
    b = sample_rgb_batch(torch.Generator().manual_seed(1), images, poses,
                         intr, 64, random_image_batch=True, cam_near_far=cnf)
    rows, cols = b["pix_inds"] // W, b["pix_inds"] % W
    assert torch.equal(b["gt_rgb"], images[b["img_inds"], rows, cols])
    ro, rd = rays_from_pixels(poses[b["img_inds"]], intr[b["img_inds"]],
                              cols.float() + 0.5, rows.float() + 0.5)
    assert torch.equal(b["rays_o"], ro) and torch.equal(b["rays_d"], rd)
    assert torch.equal(b["cam_near_far"], cnf[b["img_inds"]])
    assert len(set(b["img_inds"].tolist())) > 1
    one = sample_rgb_batch(g, images, poses, intr[0], 32,
                           random_image_batch=False)
    assert len(set(one["img_inds"].tolist())) == 1
    assert "cam_near_far" not in one
    again = sample_rgb_batch(torch.Generator().manual_seed(1), images, poses,
                             intr, 64, cam_near_far=cnf)
    assert torch.equal(again["pix_inds"], b["pix_inds"])
