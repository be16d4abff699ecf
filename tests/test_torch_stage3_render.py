"""The stage-3 render (`return_mask`) of the port against the JAX renderer,
with the same (converted) weights, on the CPU: the port's frozen route (K5
and K6, plain twins here) and its composable route against the JAX frozen
route run in Pallas interpret mode (as tests/test_frozen_side_path.py runs
it), for both mask MLPs, in training and at inference; and the training
render with a trainable backbone (`frozen_backbone=False`, the route of
stage 3 without an init checkpoint: K8 and K10, plain here) against the
JAX renderer's composable route with the same settings, through the JAX
FreqMLP's plain reference (as the JAX package runs it off the TPU), at CP
ranks 64 and 0.

Bars are the JAX package's own between its frozen and composable routes
(tests/test_frozen_side_path.py:92, 121-124): logits, image and depth
within 3e-2 max abs, the CE loss within 2e-2, and the trainable leaves'
grads (cp_m_*, mask_mlp) within rel-max 6e-2.
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
from sanerf_hq_tpu_torch.models import MLPField, params_from_jax
from sanerf_hq_tpu_torch.ops import render_level as rl
from sanerf_hq_tpu_torch.render import renderer as tr

N = 64
KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
          prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
          cp_res=16, with_mask=True, n_inst=3, feat_rep="cp", feat_rank=8,
          feat_res=16)
STEPS = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05)
TRAINABLE = ("cp_m_", "mask_mlp")


_BUILT = {}


def _build(mask_mlp_type, cp_rank=KW["cp_rank"]):
    key = (mask_mlp_type, cp_rank)
    if key not in _BUILT:
        _BUILT[key] = _make(dict(KW, mask_mlp_type=mask_mlp_type,
                                 cp_rank=cp_rank))
    return _BUILT[key]


@pytest.fixture(scope="module", params=["default", "lightweight_mask"])
def setup(request):
    return _build(request.param)


def _make(kw):
    jm = JaxMLPField(**kw)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    tm = MLPField(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(0)
    ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    gt = rng.integers(0, 3, N)
    return jm, params, tm, ro, rd, gt


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    monkeypatch.setattr(rlp, "INTERPRET", True)
    monkeypatch.setattr(rlp, "R_TILE", N)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it to N


def _jax_ce(jm, params, ro, rd, gt, settings):
    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(ro), jnp.asarray(rd), settings,
                       method=lambda m, o, d, s: jr.render_rays(m, o, d, s))
        logp = jax.nn.log_softmax(out["instance_mask_logits"], axis=-1)
        ce = -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(gt)[:, None],
                                           axis=-1))
        return ce, out

    (loss, out), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
    grads = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(g):
        keys = [str(getattr(k, "key", k)) for k in path[1:]]
        name = "/".join(keys)
        if any(t in name for t in TRAINABLE):
            grads[name] = np.asarray(leaf)
    return float(loss), out, grads


def _port_ce(tm, ro, rd, gt, settings):
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         settings)
    ce = torch.nn.functional.cross_entropy(out["instance_mask_logits"],
                                           torch.from_numpy(gt))
    names = [n for n, _ in tm.named_parameters()
             if any(t in n for t in TRAINABLE)]
    params = dict(tm.named_parameters())
    gs = torch.autograd.grad(ce, [params[n] for n in names])
    return ce.item(), out, dict(zip(names, gs))


def _jax_name(port_name):
    """cp_m_x -> cp_m_x; mask_mlp.layers.0.weight -> mask_mlp/Dense_0/kernel
    (transposed)."""
    if port_name.startswith("mask_mlp"):
        i = port_name.split(".")[2]
        return f"mask_mlp/Dense_{i}/kernel", True
    return port_name, False


@pytest.mark.parametrize("level_kernels,frozen,cp_rank", [
    pytest.param(True, True, KW["cp_rank"], id="True"),
    pytest.param(False, True, KW["cp_rank"], id="False"),
    # the trainable backbone: the JAX composable route through its plain
    # FreqMLP (PALLAS_ENABLED off), the port's composable route
    pytest.param(True, False, 64, id="trainable-cp64"),
    pytest.param(True, False, 0, id="trainable-cp0"),
])
def test_mask_training_render_matches_jax_frozen_route(
        setup, interpret, monkeypatch, level_kernels, frozen, cp_rank):
    jm, params, tm, ro, rd, gt = setup
    if not frozen:
        jm, params, tm, ro, rd, gt = _build(jm.mask_mlp_type, cp_rank)
        monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)
    j_loss, j_out, j_grads = _jax_ce(
        jm, params, ro, rd, gt,
        jr.RenderSettings(**STEPS, training=True, return_mask=True,
                          frozen_backbone=frozen))
    before = rl.fused_final_level_frozen.launches
    t_loss, t_out, t_grads = _port_ce(
        tm, ro, rd, gt,
        tr.RenderSettings(**STEPS, training=True, return_mask=True,
                          frozen_backbone=frozen, level_kernels=level_kernels))
    assert rl.fused_final_level_frozen.launches == before  # twins on CPU
    assert abs(t_loss - j_loss) < 2e-2, (t_loss, j_loss)
    for k in ("instance_mask_logits", "image", "depth", "weights"):
        a, b = t_out[k].detach().numpy(), np.asarray(j_out[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() < 3e-2, k
    assert len(t_grads) == len(j_grads) > 0
    for name, g in t_grads.items():
        jname, transpose = _jax_name(name)
        want = j_grads[jname].T if transpose else j_grads[jname]
        rel = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-6)
        assert rel < 6e-2, (name, rel)


def test_mask_eval_render_matches_jax(setup, interpret):
    """Inference with return_mask (the error-map and evaluation renders)
    also takes the frozen route: K5 twice and K6 once a chunk."""
    jm, params, tm, ro, rd, _ = setup
    settings = dict(STEPS, return_mask=True, max_ray_batch=24)
    want = jm.apply(params, jnp.asarray(ro), jnp.asarray(rd),
                    jr.RenderSettings(**settings),
                    method=lambda m, o, d, s: jr.render_staged(m, o, d, s))
    with torch.inference_mode():
        got = tr.render_staged(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                               tr.RenderSettings(**settings))
    for k in ("instance_mask_logits", "image", "depth", "weights_sum"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() < 3e-2, k


def test_frozen_route_runs_no_backbone_grad(setup):
    """The frozen route detaches the backbone: the logits' backward reaches
    only the mask branch, even with every backbone parameter requiring
    grad (the view MLP stays live on both routes, as in JAX, but the mask
    loss reads the image detached)."""
    _, _, tm, ro, rd, _ = setup
    out = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**STEPS, training=True,
                                           return_mask=True,
                                           frozen_backbone=True))
    out["instance_mask_logits"].sum().backward()
    for name, p in tm.named_parameters():
        trainable = any(t in name for t in TRAINABLE)
        assert (p.grad is not None) == trainable, name
        p.grad = None
