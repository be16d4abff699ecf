"""Stage 2's distill container of the port against the JAX package, on the
CPU, with the same (converted) weights and inputs made from numpy seeds:

  (a) `sam_features` and `apply_samvit_mlp` of both fields (the MLP
      field's CP volume and its `feat_rep="hashgrid"` table, the hash-grid
      field's s_grid plain and packed), with and without the view
      direction: rel-max <= 1e-4;
  (b) the `return_feats` render against JAX's `render_rays`: the MLP
      field's frozen route (the port's plain K5 / K6 twins, JAX's Pallas
      kernels in interpret mode) and composable route (JAX's FreqMLP
      through its plain reference), the hash-grid field's composable
      route: samvit, image and depth max abs <= 1e-3;
  (c) one `make_sam_distill_step` on a fixed batch against JAX's step (its
      gradients caught where it applies them), with the feature map
      resized to a smaller encoder grid and not, and with TV / WD on
      s_grid: loss rel <= 1e-4, per-leaf grads rel-max <= 1e-3;
  (d) the frozen distill step against the composable one, at the JAX
      package's own bars (tests/test_frozen_side_path.py: loss 2e-2,
      outputs 3e-2, grads rel-max 6e-2);
  (e) `lowres_feature_camera`, `sam_aug_intrinsics` (the same fovy gives
      the same intrinsics) and the `Cache` ring's fill and replace order;
  (f) the distill batch's ground truth: `make_render_and_encode` (the
      on-device path: rounding, the float resize) and the host path
      (truncation to uint8, OpenCV's uint8 resize) against JAX's on the
      same frame: features rel-max <= 1e-3;
  (g) `evaluate_sam_features`' MSE against JAX's on the same parameters
      (rel 1e-3), and the decode from rendered features against JAX's:
      the same valid_dict.json, obj_mask files within 1% of the pixels,
      depth within 1e-3 (tests/test_torch_decode.py's bars).
The tiny SAM is tests/test_torch_sam.py's (64^2 input, a 4 x 4 grid).
"""
import functools
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.fused_mlp as jfm
import sanerf_hq_tpu.ops.render_level_pallas as rlp
import sanerf_hq_tpu.train.steps as jsteps
from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.data.provider import load_scene as jax_load_scene
from sanerf_hq_tpu.data.rays import full_frame_rays as j_rays
from sanerf_hq_tpu.data.sampler import sam_aug_intrinsics as j_aug
from sanerf_hq_tpu.models.fields import SANeRFField as JaxField
from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu.ops.hashgrid import HashGridSpec as JaxSpec
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu.sam.predictor import SamPredictor as JaxPredictor
from sanerf_hq_tpu.train import stages as jax_stages
from sanerf_hq_tpu.train.trainer import Trainer as JaxTrainer
from sanerf_hq_tpu.utils import points as jax_points
from sanerf_hq_tpu.utils.cache import Cache as JaxCache
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.provider import load_scene
from sanerf_hq_tpu_torch.data.sampler import (fovy_intrinsics,
                                              sam_aug_intrinsics)
from sanerf_hq_tpu_torch.data.synthetic import look_at_pose, write_llff_scene
from sanerf_hq_tpu_torch.models import MLPField, SANeRFField, params_from_jax
from sanerf_hq_tpu_torch.models.fields import active_reg_grid
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.render import renderer as tr
from sanerf_hq_tpu_torch.sam import SamPredictor
from sanerf_hq_tpu_torch.train import stages
from sanerf_hq_tpu_torch.train.steps import make_sam_distill_step
from sanerf_hq_tpu_torch.train.trainer import Trainer
from sanerf_hq_tpu_torch.utils import points
from sanerf_hq_tpu_torch.utils.cache import Cache
from test_torch_sam import IMG, _build_pair

N = 64  # rays of the render checks: an 8 x 8 feature map
FEAT_HW = 8
MLP_KW = dict(grid_bound=2.0, hidden=64, num_layers=4, freq_degree=4,
              prop_hidden=32, prop_layers=3, prop_freq_degree=3, cp_rank=4,
              cp_res=16, with_sam=True, feat_rank=8, feat_res=16)
MAIN = dict(num_levels=4, level_dim=2, base_resolution=8,
            log2_hashmap_size=12, desired_resolution=64)
PROP = dict(num_levels=3, level_dim=2, base_resolution=8,
            log2_hashmap_size=10, desired_resolution=32)
FEAT = dict(num_levels=4, level_dim=8, base_resolution=8,
            log2_hashmap_size=11, desired_resolution=64)
STEPS = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05)
KINDS = ("mlp-cp", "mlp-hashgrid", "hashgrid", "hashgrid-packed")
SAM_BRANCH = ("cp_s_", "s_grid", "samvit_")


def _rel(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _is_sam(name):
    return name.startswith(SAM_BRANCH)


def _hash_specs(cls, packed):
    return dict(main_spec=cls(**MAIN, packed=packed), feat_spec=cls(**FEAT),
                prop_spec_0=cls(**PROP, packed=packed),
                prop_spec_1=cls(**dict(PROP, desired_resolution=48),
                                packed=packed))


@functools.lru_cache(maxsize=None)
def _fields(kind: str, view_dir: bool):
    """(JAX field, its parameters, the port's field loaded strictly with
    them).  Tables of order 0.3 instead of 1e-4, so that the outputs
    depend on them."""
    if kind.startswith("mlp"):
        rep = kind.split("-")[1]
        extra = dict(feat_rep=rep)
        jm = JaxMLPField(**MLP_KW, **extra, sam_use_view_direction=view_dir,
                         feat_spec=JaxSpec(**FEAT) if rep == "hashgrid"
                         else None)
        tm_kw = dict(MLP_KW, **extra, feat_spec=HashGridSpec(**FEAT)
                     if rep == "hashgrid" else None)
        cls = MLPField
    else:
        packed = kind.endswith("packed")
        jm = JaxField(with_sam=True, packed=packed,
                      sam_use_view_direction=view_dir,
                      **_hash_specs(JaxSpec, False))
        tm_kw = dict(with_sam=True, packed=packed,
                     **_hash_specs(HashGridSpec, False))
        cls = SANeRFField
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    p = flax.core.unfreeze(params)["params"]
    rng = np.random.default_rng(0)
    for name in ("grid", "prop_grid_0", "prop_grid_1", "s_grid"):
        if name in p:
            p[name] = rng.normal(size=p[name].shape).astype(np.float32) * 0.3
    params = {"params": p}
    tm = cls(**tm_kw, sam_use_view_direction=view_dir, device="cpu")
    state = params_from_jax(params)
    assert state.keys() == tm.state_dict().keys()
    tm.load_state_dict(state)
    return jm, params, tm


@functools.lru_cache(maxsize=None)
def _rays():
    """A feat_hw x feat_hw camera looking at the origin from 2 units."""
    pose = look_at_pose([1.5, -0.7, 1.0]).astype(np.float32)
    f = 0.5 * FEAT_HW / np.tan(np.deg2rad(25.0))
    intr = np.array([f, f, FEAT_HW / 2, FEAT_HW / 2], np.float32)
    ro, rd = j_rays(jnp.asarray(pose), jnp.asarray(intr), FEAT_HW, FEAT_HW)
    return np.asarray(ro), np.asarray(rd)


@pytest.fixture()
def plain_jax(monkeypatch):
    """JAX's composable route through its plain references."""
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)


# (a) ------------------------------------------------------------------------

@pytest.mark.parametrize("kind,view_dir", [
    ("mlp-cp", False), ("mlp-cp", True), ("mlp-hashgrid", False),
    ("hashgrid", False), ("hashgrid", True), ("hashgrid-packed", True)],
    ids=["mlp-cp-geo", "mlp-cp-viewdir", "mlp-hashgrid-geo", "hashgrid-geo",
         "hashgrid-viewdir", "hashgrid-packed-viewdir"])
def test_sam_features_and_samvit_mlp_match_jax(kind, view_dir):
    jm, params, tm = _fields(kind, view_dir)
    rng = np.random.default_rng(2)
    x = rng.uniform(-2.2, 2.2, (8, 16, 3)).astype(np.float32)
    method = (JaxMLPField if kind.startswith("mlp") else JaxField)
    want = jm.apply(params, jnp.asarray(x), method=method.sam_features)
    got = tm.sam_features(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-4
    width = want.shape[-1] + 15 + (16 if view_dir else 0) + 4
    assert tm.samvit_mlp.layers[0].in_features == width
    f = rng.normal(size=(64, width)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(f), method=method.apply_samvit_mlp)
    got = tm.apply_samvit_mlp(torch.from_numpy(f))
    assert got.shape == want.shape == (64, 256)
    assert _rel(got, want) <= 1e-4
    reg = active_reg_grid(tm, "sam")
    assert reg == (("s_grid", tm.s_spec) if kind.startswith("hashgrid")
                   else None)


# (b) ------------------------------------------------------------------------

def _jax_render(jm, params, settings, ro, rd):
    return jm.apply(params, jnp.asarray(ro), jnp.asarray(rd), settings,
                    method=lambda m, o, d, s: jr.render_rays(m, o, d, s))


@pytest.mark.parametrize("view_dir", [False, True], ids=["geo", "viewdir"])
@pytest.mark.parametrize("kind,frozen", [("mlp-cp", True),
                                         ("mlp-cp", False),
                                         ("hashgrid", False)],
                         ids=["mlp-frozen", "mlp-composable",
                              "hashgrid-composable"])
def test_return_feats_render_matches_jax(kind, frozen, view_dir,
                                         monkeypatch):
    jm, params, tm = _fields(kind, view_dir)
    if frozen:
        monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
        monkeypatch.setattr(rlp, "INTERPRET", True)
        monkeypatch.setattr(rlp, "R_TILE", N)
    else:
        monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)
    ro, rd = _rays()
    kw = dict(STEPS, training=True, return_feats=True,
              sam_use_view_direction=view_dir, frozen_backbone=frozen)
    want = _jax_render(jm, params, jr.RenderSettings(**kw), ro, rd)
    got = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**kw, level_kernels=frozen))
    for k in ("samvit", "image", "depth"):
        a, b = got[k].detach().numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-3, (k, np.abs(a - b).max())


# (c) ------------------------------------------------------------------------

@flax.struct.dataclass
class _CatchGrads:
    """A stand-in train state whose update returns the gradients."""
    params: dict

    def apply_gradients(self, grads):
        return self.replace(params=grads)


def _batch(grid, seed=3):
    ro, rd = _rays()
    gt = np.random.default_rng(seed).normal(size=(grid, grid, 256)).astype(
        np.float32)
    return {"rays_o_lr": ro, "rays_d_lr": rd, "gt_samvit": gt}


def _step_grads(kind, view_dir, grid, tv_wd):
    """The loss and the SAM branch's grads of one distill step, JAX's
    (caught where its step applies them) and the port's."""
    jm, params, tm = _fields(kind, view_dir)
    common = dict(STEPS, contract=True, sam_use_view_direction=view_dir,
                  lambda_tv=0.05 if tv_wd else 0.0,
                  lambda_wd=0.5 if tv_wd else 0.0)
    b = _batch(grid)
    key = jax.random.PRNGKey(7)
    jstep = jsteps.make_sam_distill_step(jm, JaxConfig(**common),
                                         feat_hw=FEAT_HW)
    caught, jmetrics = jstep(_CatchGrads(params),
                             {k: jnp.asarray(v) for k, v in b.items()}, key)
    want = params_from_jax(jax.device_get(caught.params))
    tv_points = np.array(jax.random.uniform(
        jax.random.fold_in(key, 2), (8192, 3), dtype=jnp.float32))
    step = make_sam_distill_step(tm, Config(**common), feat_hw=FEAT_HW)
    loss, metrics, out = step.loss_fn(
        {k: torch.from_numpy(v) for k, v in b.items()},
        tv_points=torch.from_numpy(tv_points))
    named = {n: p for n, p in tm.named_parameters() if _is_sam(n)}
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return (float(jmetrics["loss"]), float(jmetrics["mse"]), want), \
        (loss.item(), metrics["mse"].item(), grads, out)


def _kink_margin(tm, f):
    """The least |pre-activation| of the SAM MLP's leaky-ReLU layers on
    its input rows f."""
    mlp, x, margin = tm.samvit_mlp, f, np.inf
    for l, lin in enumerate(mlp.layers[:-1]):
        if l in mlp.skip_layers:
            x = torch.cat([x, f], dim=-1)
        h = lin(x)
        margin = min(margin, h.abs().min().item())
        x = torch.nn.functional.leaky_relu(h, 0.01)
    return margin


@pytest.mark.parametrize("kind,view_dir,grid,tv_wd", [
    ("mlp-cp", True, IMG // 16, False),
    ("mlp-cp", False, FEAT_HW, False),
    ("hashgrid", True, IMG // 16, True),
    ("hashgrid", False, FEAT_HW, False)],
    ids=["mlp-viewdir-resized", "mlp-geo", "hashgrid-viewdir-resized-tv-wd",
         "hashgrid-geo"])
def test_distill_step_matches_jax(kind, view_dir, grid, tv_wd, plain_jax,
                                  monkeypatch):
    """Both packages' steps on the composable route, JAX's jitted: its
    CPU backend compiles no bf16 x bf16 -> f32 product, which the MLP
    field's frozen route holds; (b) holds that route's render to JAX's and
    (d) its step to the composable one's.  The MLP field's trunk and
    proposal MLPs compute in bf16 on both sides, and where the two
    accumulations round one activation to neighbouring bf16 values a
    leaky-ReLU unit of the SAM MLP near 0 takes the other slope; so the
    port's field hands its density and colour queries to the JAX field
    (fp32 from there on, both sides), and the step's own arithmetic is
    what is compared (tests/test_torch_render.py holds the trunk)."""
    if kind.startswith("mlp"):
        jm, params, tm = _fields(kind, view_dir)

        def jax_query(method, *xs, **kw):
            out = jm.apply(params, *(jnp.asarray(x.detach().numpy())
                                     for x in xs), **kw, method=method)
            return (tuple(torch.from_numpy(np.array(o)) for o in out)
                    if isinstance(out, tuple) else
                    torch.from_numpy(np.array(out)))

        monkeypatch.setattr(tm, "density", lambda x, proposal=-1: jax_query(
            JaxMLPField.density, x, proposal=proposal), raising=False)
        monkeypatch.setattr(tm, "forward_color", lambda x, d: jax_query(
            JaxMLPField.forward_color, x, d), raising=False)
    _, _, tm = _fields(kind, view_dir)
    rows = []
    head = tm.apply_samvit_mlp
    monkeypatch.setattr(tm, "apply_samvit_mlp", lambda f: (
        rows.append(f.detach()), head(f))[1], raising=False)
    (jl, jmse, want), (tl, tmse, grads, _) = _step_grads(
        kind, view_dir, grid, tv_wd)
    # a unit within an fp32 rounding of the kink takes either slope on
    # either side (a 0.99 change of its grad): the batch's camera keeps
    # every pre-activation at least 1e-6 from it, ten times the two
    # sides' difference there
    assert _kink_margin(tm, rows[0]) > 1e-6
    assert tl == pytest.approx(jl, rel=1e-4)
    assert tmse == pytest.approx(jmse, rel=1e-4)
    if tv_wd:
        assert tl > tmse  # the TV / WD term is in the loss
    else:
        assert tl == tmse
    assert len(grads) > 0
    for name, g in grads.items():
        assert np.abs(want[name].numpy()).max() > 0, name
        assert _rel(g, want[name]) <= 1e-3, (name, _rel(g, want[name]))


# (d) ------------------------------------------------------------------------

@pytest.mark.parametrize("view_dir", [False, True], ids=["geo", "viewdir"])
def test_frozen_distill_step_matches_composable(view_dir):
    """The MLP field's distill step over a frozen backbone (K5, K6; plain
    twins here) against the same step on the composable route, at the
    JAX package's bars for its two routes."""
    _, _, tm = _fields("mlp-cp", view_dir)
    b = {k: torch.from_numpy(v) for k, v in _batch(IMG // 16).items()}
    cfg = Config(**STEPS, sam_use_view_direction=view_dir)
    named = {n: p for n, p in tm.named_parameters() if _is_sam(n)}
    res = {}
    for frozen in (True, False):
        loss, _, out = make_sam_distill_step(
            tm, cfg, feat_hw=FEAT_HW, frozen_backbone=frozen).loss_fn(b)
        res[frozen] = (loss.item(), out["samvit"].detach(),
                       torch.autograd.grad(loss, list(named.values())))
    assert abs(res[True][0] - res[False][0]) < 2e-2
    assert (res[True][1] - res[False][1]).abs().max() < 3e-2
    for name, a, b_ in zip(named, res[True][2], res[False][2]):
        assert _rel(a, b_.numpy()) < 6e-2, name


def test_frozen_distill_step_trains_only_the_sam_branch():
    """Over a frozen backbone the step's backward reaches only the SAM
    branch and the view MLP (the SAM MLP reads the image, as in JAX, where
    the optimizer's mask freezes it), even with every backbone parameter
    requiring grad; an Adam step over the frozen backbone moves each SAM
    leaf and nothing else."""
    from sanerf_hq_tpu_torch.train.state import TrainState

    _, _, tm = _fields("mlp-cp", True)
    b = {k: torch.from_numpy(v) for k, v in _batch(FEAT_HW).items()}
    step = make_sam_distill_step(tm, Config(**STEPS,
                                            sam_use_view_direction=True),
                                 feat_hw=FEAT_HW, frozen_backbone=True)
    loss, _, _ = step.loss_fn(b)
    loss.backward()
    for name, p in tm.named_parameters():
        live = _is_sam(name) or name.startswith("view_mlp")
        assert (p.grad is not None) == live, name
        p.grad = None
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state = TrainState(tm, 1e-2, 10, frozen=[n for n in before
                                            if not _is_sam(n)])
    try:
        metrics = step(state, b)
        assert set(metrics) == {"loss", "mse"} and state.step == 1
        for name, p in tm.named_parameters():
            assert torch.equal(p, before[name]) != _is_sam(name), name
    finally:
        with torch.no_grad():
            for name, p in tm.named_parameters():
                p.copy_(before[name])
                p.requires_grad_(True)


# (e) ------------------------------------------------------------------------

@pytest.mark.parametrize("H,W,grid", [(32, 32, 64), (48, 64, 64),
                                      (2048, 1365, 64), (30, 40, 4)])
def test_lowres_feature_camera_matches_jax(H, W, grid):
    intr = np.array([40.0, 41.5, W / 2 - 0.3, H / 2 + 0.2], np.float32)
    got = stages.lowres_feature_camera(intr, H, W, grid)
    want = jax_stages.lowres_feature_camera(intr, H, W, grid)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


def test_sam_aug_intrinsics_matches_jax_on_the_same_fovy():
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        fovy = 50.0 + 20.0 * jax.random.uniform(key, ())
        want = np.asarray(j_aug(key, 512))
        got = fovy_intrinsics(torch.tensor(np.asarray(fovy)), 512).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    a = [sam_aug_intrinsics(torch.Generator().manual_seed(5), 512)
         for _ in range(2)]
    assert torch.equal(a[0], a[1])  # seeded
    draws = torch.stack([sam_aug_intrinsics(g, 64) for g in
                         [torch.Generator().manual_seed(1)] * 200])
    fov = 2 * torch.rad2deg(torch.atan(32.0 / draws[:, 0]))
    assert fov.min() >= 50.0 - 1e-3 and fov.max() < 70.0
    assert fov.max() - fov.min() > 15.0
    assert (draws[:, 2:] == 32.0).all()


def test_cache_ring_fills_and_replaces_like_jax():
    got, want = Cache(3, torch.Generator().manual_seed(0)), JaxCache(3)
    for i in range(8):
        got.insert(i)
        want.insert(i)
        assert got.data == want.data and got.ptr == want.ptr
        assert got.full() == want.full() and len(got) == len(want)
    assert got.data == [6, 7, 5]  # the oldest entry goes first
    picks = [got.get() for _ in range(60)]
    assert set(picks) == {5, 6, 7}
    again = Cache(3, torch.Generator().manual_seed(0))
    for i in range(8):
        again.insert(i)
    assert [again.get() for _ in range(60)] == picks  # seeded


# (f) and (g): the trainers ---------------------------------------------------

HW = 16


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A JAX trainer and a port trainer over the same hash-grid field with
    its SAM branch (small specs, tables of order 0.3), the tiny SAM with
    shared weights, a 16x16 llff scene and two of its views."""
    root = tmp_path_factory.mktemp("distill")
    scene_dir = str(root / "scene")
    write_llff_scene(scene_dir, n_views=17, H=HW, W=HW)
    jm, params, _ = _fields("hashgrid", True)
    common = dict(path=scene_dir, data_type="llff", num_steps=(8, 8, 8),
                  online_resolution=HW, sam_use_view_direction=True,
                  max_ray_batch=4096)
    jcfg = JaxConfig(**common, workspace=str(root / "jax"))
    jt = JaxTrainer("ngp", jcfg, jm, jcfg.workspace, use_checkpoint="none")
    jt.state = jt.state.replace(params=params, ema_params=params)
    tm = SANeRFField(with_sam=True, sam_use_view_direction=True,
                     **_hash_specs(HashGridSpec, False), device="cpu")
    cfg = Config(**common, workspace=str(root / "port"), device="cpu")
    pt = Trainer("ngp", cfg, tm, cfg.workspace, resume=False)
    pt.state.load_weights(params_from_jax(params))
    port_sam, jax_sam, _ = _build_pair(False)
    js, ps = jax_load_scene(scene_dir, "llff"), load_scene(scene_dir, "llff")
    for s in (js, ps):
        s.poses, s.img_names = s.poses[[0, 5]], s.img_names[[0, 5]]
        s.intrinsics, s.images = s.intrinsics[[0, 5]], None
    return dict(root=root, jt=jt, pt=pt, js=js, ps=ps, jm=jm,
                params=params, port_sam=port_sam, jax_sam=jax_sam,
                jpred=JaxPredictor(jax_sam, img_size=IMG),
                ppred=SamPredictor(port_sam, img_size=IMG))


def test_distill_ground_truth_matches_jax_on_both_paths(shared,
                                                        monkeypatch):
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)
    jt, pt, ps = shared["jt"], shared["pt"], shared["ps"]
    R = HW
    pose = ps.poses[1]
    key = jax.random.PRNGKey(3)
    intr = np.asarray(j_aug(key, R))
    ro, rd = j_rays(jnp.asarray(pose), jnp.asarray(intr), R, R)
    # the on-device path
    want, want_interm = jax_stages.make_render_and_encode(
        jt, shared["jax_sam"], R, IMG)(jt.state.params,
                                       shared["jax_sam"].params, ro, rd)
    render_and_encode = stages.make_render_and_encode(
        pt, shared["port_sam"], R, IMG)
    batch = stages.distill_batch(pt, pose, intr, shared["ppred"],
                                 render_and_encode)
    assert batch["gt_samvit"].shape == want.shape == (IMG // 16, IMG // 16,
                                                      256)
    assert _rel(batch["gt_samvit"], want) <= 1e-3
    _, interm = render_and_encode(torch.from_numpy(np.asarray(ro)),
                                  torch.from_numpy(np.asarray(rd)))
    assert _rel(interm, want_interm) <= 1e-3
    # the low-res feature rays: the intrinsics over R / 64
    lo, ld = j_rays(jnp.asarray(pose), jnp.asarray(intr) / (R / 64.0), 64, 64)
    np.testing.assert_allclose(batch["rays_o_lr"].numpy(), np.asarray(lo),
                               atol=1e-6)
    np.testing.assert_allclose(batch["rays_d_lr"].numpy(), np.asarray(ld),
                               rtol=1e-6, atol=1e-6)
    # the host path: the render truncated to uint8, then set_image
    out = jt.eval_render(jt.state.params, ro, rd)
    rgb = (np.clip(np.asarray(out["image"]).reshape(R, R, 3), 0, 1)
           * 255).astype(np.uint8)
    want_host = np.asarray(shared["jpred"].set_image(rgb)[0])
    host = stages.distill_batch(pt, pose, intr, shared["ppred"])
    assert _rel(host["gt_samvit"], want_host) <= 1e-3
    # rounding and truncation differ: the two paths are not the same
    assert not torch.equal(host["gt_samvit"], batch["gt_samvit"])


def test_evaluate_sam_features_matches_jax(shared, monkeypatch):
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)
    jt, pt = shared["jt"], shared["pt"]
    want = jax_stages.evaluate_sam_features(
        jt, shared["js"], shared["jpred"],
        save_dir=str(shared["root"] / "jax_eval"))
    got = stages.evaluate_sam_features(
        pt, shared["ps"], shared["ppred"],
        save_dir=str(shared["root"] / "port_eval"))
    assert got == pytest.approx(want, rel=1e-3)
    for stem in ("v00", "v05"):
        a = np.load(shared["root"] / "port_eval" / f"{stem}_samvit.npy")
        b = np.load(shared["root"] / "jax_eval" / f"{stem}_samvit.npy")
        assert a.shape == b.shape == (IMG // 16, IMG // 16, 256)
        assert np.abs(a - b).max() <= 1e-3
    # --use_default_focal_length: the view's own focal length
    jt.cfg = jt.cfg.replace(use_default_focal_length=True)
    pt.cfg = pt.cfg.replace(use_default_focal_length=True)
    try:
        want = jax_stages.evaluate_sam_features(jt, shared["js"],
                                                shared["jpred"])
        got = stages.evaluate_sam_features(pt, shared["ps"],
                                           shared["ppred"])
    finally:
        jt.cfg = jt.cfg.replace(use_default_focal_length=False)
        pt.cfg = pt.cfg.replace(use_default_focal_length=False)
    assert got == pytest.approx(want, rel=1e-3)


def test_decode_from_rendered_features_matches_jax(shared, monkeypatch):
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", False)
    jt, pt, js, ps = (shared[k] for k in ("jt", "pt", "js", "ps"))
    feats = {}
    render = jsteps.make_eval_render(jt.model, jt.cfg, return_feats=True)
    for i in range(2):  # the same rendered features on both sides
        f_intr, fh, fw = jax_stages.lowres_feature_camera(
            js.intrinsics[i], HW, HW)
        ro, rd = j_rays(jnp.asarray(js.poses[i]), jnp.asarray(f_intr), fh,
                        fw)
        want = np.asarray(render(jt.state.params, ro, rd)["samvit"])
        got = stages.render_features(pt, ps.poses[i], ps.intrinsics[i], HW,
                                     HW)
        assert got.shape == (64, 64, 256)
        feats[i] = np.abs(got.numpy() - want.reshape(fh, fw, -1)).max()
    assert max(feats.values()) <= 1e-3, feats
    depth = np.asarray(jt.render_view(js.poses[0], js.intrinsics[0], HW,
                                      HW)["depth"]).reshape(HW, HW)
    fx, fy, cx, cy = js.intrinsics[0]
    pts = []
    for px, py in ((8, 8), (6, 10)):
        z = -float(depth[py, px])
        X, Y = (HW - cx - (px + 0.5)) * z / fx, ((py + 0.5) - cy) * z / fy
        pts.append((js.poses[0] @ np.array([X, Y, z, 1.0]))[:3].tolist())
    path = str(shared["root"] / "points.json")
    with open(path, "w") as f:
        json.dump({"points": pts, "crucial_point_index": [0],
                   "valid_threshold": 1}, f)
    jout = jax_stages.decode(jt, js, shared["jpred"],
                             jax_points.load_point_file(path),
                             feature_container="distill")
    pout = stages.decode(pt, ps, shared["ppred"],
                         points.load_point_file(path),
                         feature_container="distill")
    with open(os.path.join(jout, "valid_dict.json")) as f:
        want_valid = json.load(f)
    with open(os.path.join(pout, "valid_dict.json")) as f:
        got_valid = json.load(f)
    assert got_valid == want_valid and got_valid["v00"] == 1
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    for stem in want_valid:
        want = np.load(os.path.join(jout, f"{stem}_obj_mask.npy"))
        got = np.load(os.path.join(pout, f"{stem}_obj_mask.npy"))
        assert got.shape == want.shape == (1, HW, HW)
        assert got.dtype == np.uint8
        assert np.mean(got != want) <= 1e-2, stem
        d_want = np.load(os.path.join(jout, f"{stem}_depth.npy"))
        d_got = np.load(os.path.join(pout, f"{stem}_depth.npy"))
        assert np.abs(d_got - d_want).max() <= 1e-3, stem
