"""The port's data parallelism (sanerf_hq_tpu_torch/parallel/, the `shard`
of train/steps.py) on the CPU over gloo:

  - `shard_rays` places divisible, indivisible and scalar leaves as JAX's
    `shard_rays` does on the 8-device mesh (tests/test_parallel.py);
  - world size 2 against world size 1: two processes (torch.multiprocessing
    spawn, a file:// rendezvous under tmp_path, a 120 s limit of their own)
    run three steps each of stage 1 (a tiny hash-grid field, random
    background, jitter, distortion on), the stage-2 distill step (TV on
    s_grid) and the stage-3 mask step with the ray-pair loss and the label
    regularisation on; the parameters after each stage are held to the
    unsharded run at the bounds JAX holds its 1-vs-8-device test to (max
    abs < 2e-2, mean < 1e-4, share above 1e-3 < 1%), and the two ranks'
    parameters are bitwise equal, as are the stage-3 batches each rank
    draws from its error map, and those maps;
  - the error map's update (`write_cells`) against a sequential write
    where cells repeat, and the cell draw (`draw_cells`) against its
    inverse CDF in numpy;
  - `make_sharded_render` at world size 2 on 99 rays (padded) against
    `render_staged` (max abs 1e-5) and against JAX's `make_sharded_render`
    on the 8-device mesh with the same weights (params_from_jax; max abs
    1e-3, the port's render bar);
  - `make_sharded_eval_step`'s MSE and PSNR at world size 2 against JAX's
    (rel 1e-4) and against the unsharded render (rel 1e-5);
  - the CLI under `python -m torch.distributed.run --standalone
    --nproc_per_node N ... --device cpu` (gloo; 120 s limit a run) against
    the same CLI run in-process without a process group: at N = 1 the
    checkpoint bitwise equal (the plain twins are deterministic), at N = 2
    within the bounds above; rank 0 alone writes the log.
JAX is imported inside the tests only, so the spawned ranks import torch
and the port alone.
"""
import datetime
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.sampler import (draw_cells, sample_mask_batch,
                                              sample_rgb_batch)
from sanerf_hq_tpu_torch.data.synthetic import (make_synthetic_dataset,
                                                write_llff_scene)
from sanerf_hq_tpu_torch.models import SANeRFField, params_from_jax
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.parallel import (data_sharding, make_mesh,
                                          make_sharded_eval_step,
                                          make_sharded_render, shard_rays)
from sanerf_hq_tpu_torch.parallel.mesh import Mesh
from sanerf_hq_tpu_torch.render.renderer import (RenderSettings, render_rays,
                                                 render_staged)
from sanerf_hq_tpu_torch.train.state import TrainState
from sanerf_hq_tpu_torch.train.steps import (make_mask_train_step,
                                             make_rgb_train_step,
                                             make_sam_distill_step,
                                             write_cells)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME_LIMIT = 120  # seconds for the spawned ranks, rendezvous included
CLI_THREADS = 2  # intra-op threads of each CLI rank and of the reference
STEPS = 3
MAIN = dict(num_levels=4, level_dim=2, base_resolution=16,
            log2_hashmap_size=12, desired_resolution=64)
PROP = dict(num_levels=3, level_dim=2, base_resolution=16,
            log2_hashmap_size=11, desired_resolution=32)
FEAT = dict(num_levels=4, level_dim=8, base_resolution=8,
            log2_hashmap_size=12, desired_resolution=64)
CFG = Config(num_steps=(16, 8, 4), num_rays=64, iters=100, bound=4.0,
             min_near=0.05, background="random", lambda_distort=0.02,
             lambda_distort_warmup=0, n_inst=2, num_local_sample=2,
             local_sample_patch_size=4, ray_pair_rgb_loss_weight=1.0,
             ray_pair_rgb_iter=0, ray_pair_rgb_num_sample=2,
             error_map_size=8, label_regularization_weight=0.1,
             lambda_tv=1e-3, device="cpu")
SETTINGS = RenderSettings(num_steps=(16, 8, 4), min_near=0.05, bound=4.0,
                          max_ray_batch=32)
RENDER_HW = (9, 11)  # 99 rays: padded to 100 at world size 2
EVAL_HW = (8, 8)


def _specs():
    return dict(main_spec=HashGridSpec(**MAIN), feat_spec=HashGridSpec(**FEAT),
                prop_spec_0=HashGridSpec(**PROP),
                prop_spec_1=HashGridSpec(**PROP))


def _field():
    """The stage fields' start: the seeded field, its tables N(0, 0.3^2)
    so that the outputs depend on them."""
    model = SANeRFField(grid_bound=CFG.grid_bound, with_sam=True,
                        with_mask=True, device="cpu", **_specs())
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name in ("grid", "prop_grid_0", "prop_grid_1", "s_grid",
                     "m_grid"):
            p = getattr(model, name)
            p.copy_(torch.as_tensor(
                rng.normal(size=p.shape).astype(np.float32) * 0.3))
    return model


def _scene():
    s = make_synthetic_dataset(n_views=3, H=16, W=16)
    t = {k: torch.as_tensor(np.asarray(s[k], np.float32))
         for k in ("images", "poses", "intrinsics")}
    yy, xx = np.mgrid[:16, :16]
    masks = ((xx - 8) ** 2 + (yy - 8) ** 2 < 20).astype(np.int64)
    masks = np.repeat(masks[None], 3, 0)
    masks[:, :2] = -1  # unlabelled rows
    t["masks"] = torch.as_tensor(masks)
    return t


def _run_steps(shard):
    """STEPS steps of each stage from the same start; {stage: state_dict}
    after each, and the metrics of the last step."""
    scene = _scene()
    model = _field()
    out = {}
    gen = torch.Generator().manual_seed(7)
    state = TrainState(model, 1e-2, CFG.iters)
    step = make_rgb_train_step(model, CFG, shard=shard)
    for _ in range(STEPS):
        batch = sample_rgb_batch(gen, scene["images"], scene["poses"],
                                 scene["intrinsics"], CFG.num_rays)
        m = step(state, batch, gen)
    out["rgb"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["rgb_metrics"] = {k: float(v) for k, v in m.items()}

    state = TrainState(model, 1e-2, CFG.iters)
    step = make_sam_distill_step(model, CFG, feat_hw=8, shard=shard)
    ro, rd = full_frame_rays(scene["poses"][0], scene["intrinsics"] / 2, 8, 8)
    gt = torch.as_tensor(np.random.default_rng(1).normal(
        size=(8, 8, 256)).astype(np.float32))
    for _ in range(STEPS):
        m = step(state, {"rays_o_lr": ro, "rays_d_lr": rd, "gt_samvit": gt},
                 gen)
    out["distill"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["distill_metrics"] = {k: float(v) for k, v in m.items()}

    state = TrainState(model, 1e-2, CFG.iters)
    step = make_mask_train_step(model, CFG, shard=shard)
    S = CFG.error_map_size
    error_map = torch.ones((3, S * S))
    out["mask_draws"] = []
    for _ in range(STEPS):
        batch = sample_mask_batch(
            gen, scene["masks"], scene["poses"], scene["intrinsics"],
            error_map, CFG.num_rays, CFG.num_local_sample,
            CFG.local_sample_patch_size, 16, 16, S)
        m, error_map = step(state, batch, gen, error_map)
        out["mask_draws"].append({k: batch[k] for k in (
            "img_inds", "inds_coarse", "rays_o", "gt_masks")}
            | {"error_map": error_map})
    out["mask"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["mask_metrics"] = {k: float(v) for k, v in m.items()}
    out["error_map"] = error_map
    return out


def _render_rays(hw, pose_i=0):
    s = _scene()
    H, W = hw
    intr = torch.tensor([14.0, 14.0, W / 2, H / 2])
    return full_frame_rays(s["poses"][pose_i], intr, H, W)


def _worker(rank, world, init_file, out_dir, render_state):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        mesh = make_mesh()
        res = _run_steps(data_sharding(mesh))
        model = SANeRFField(grid_bound=CFG.grid_bound, device="cpu",
                            **{k: v for k, v in _specs().items()
                               if k != "feat_spec"})
        model.load_state_dict(torch.load(render_state))
        ro, rd = _render_rays(RENDER_HW)
        res["render"] = make_sharded_render(model, SETTINGS, mesh)(
            ro, rd, cam_near_far=torch.tensor([[0.5, 8.0]]))
        ro, rd = _render_rays(EVAL_HW, 1)
        gt = torch.as_tensor(np.random.default_rng(2).random(
            (ro.shape[0], 3)).astype(np.float32))
        res["eval"] = make_sharded_eval_step(model, SETTINGS, mesh)(ro, rd, gt)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _jax_render_field():
    """The JAX hash-grid field of the render checks, its params (tables
    N(0, 0.3^2)), and the port's state_dict of them."""
    import flax
    import jax
    import jax.numpy as jnp
    from sanerf_hq_tpu.models import SANeRFField as JaxField
    from sanerf_hq_tpu.ops import HashGridSpec as JaxSpec

    jm = JaxField(grid_bound=CFG.grid_bound, main_spec=JaxSpec(**MAIN),
                  prop_spec_0=JaxSpec(**PROP), prop_spec_1=JaxSpec(**PROP))
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                                    jnp.ones((4, 3))))
    p = flax.core.unfreeze(params)["params"]
    rng = np.random.default_rng(3)
    for name in ("grid", "prop_grid_0", "prop_grid_1"):
        p[name] = rng.normal(size=p[name].shape).astype(np.float32) * 0.3
    params = {"params": p}
    return jm, params, params_from_jax(params)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The spawned world-size-2 run: (rank 0's results, rank 1's, the JAX
    render field)."""
    tmp = tmp_path_factory.mktemp("dp")
    jm, params, state = _jax_render_field()
    torch.save(state, tmp / "render_state.pt")
    ctx = mp.spawn(_worker, args=(2, str(tmp / "rdzv"), str(tmp),
                                  str(tmp / "render_state.pt")),
                   nprocs=2, join=False)
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=TIME_LIMIT)
    while not ctx.join(timeout=1):
        if datetime.datetime.now() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-size-2 run took over {TIME_LIMIT} s")
    r0, r1 = (torch.load(tmp / f"rank{r}.pt") for r in (0, 1))
    return r0, r1, (jm, params, state)


@pytest.fixture(scope="module")
def world1():
    return _run_steps(None)


def _close(a, b, name):
    diff = (a.double() - b.double()).abs()
    assert diff.max() < 2e-2, f"{name}: max abs {diff.max():.2e}"
    assert diff.mean() < 1e-4, f"{name}: mean abs {diff.mean():.2e}"
    frac = (diff > 1e-3).double().mean()
    assert frac < 0.01, f"{name}: {frac:.1%} of elements differ > 1e-3"


def test_shard_rays_places_leaves_as_jax():
    import jax.numpy as jnp
    from sanerf_hq_tpu.parallel import make_mesh as j_mesh
    from sanerf_hq_tpu.parallel import shard_rays as j_shard_rays

    rng = np.random.default_rng(0)
    batch = {"rays_o": rng.random((64, 3), np.float32),
             "img_inds": np.arange(64, dtype=np.int32),
             "odd": rng.random((12, 2), np.float32),  # 12 % 8 != 0
             "cam_near_far": rng.random((1, 2), np.float32),
             "step": np.asarray(3, np.int32)}
    jmesh = j_mesh((8,), ("data",))
    placed = j_shard_rays(jmesh, {k: jnp.asarray(v) for k, v in batch.items()})
    for r in (0, 3, 7):
        mesh = Mesh({"data": 8}, {"data": r})
        ours = shard_rays(mesh, {k: torch.as_tensor(v)
                                 for k, v in batch.items()})
        for k, x in placed.items():
            shard = next(s for s in x.addressable_shards
                         if s.device == jmesh.devices[r])
            np.testing.assert_array_equal(ours[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)
    # one process: every leaf whole
    assert make_mesh().shape == {"data": 1}
    whole = shard_rays(make_mesh(), {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
    assert all(whole[k].shape == np.shape(v) for k, v in batch.items())


@pytest.mark.parametrize("stage", ["rgb", "distill", "mask"])
def test_world2_steps_match_world1(stage, world2, world1):
    r0, r1, _ = world2
    for name, ref in world1[stage].items():
        # every rank holds the same parameters
        assert torch.equal(r0[stage][name], r1[stage][name]), name
        _close(r0[stage][name], ref, f"{stage}/{name}")
    for k, v in world1[f"{stage}_metrics"].items():
        np.testing.assert_allclose(r0[f"{stage}_metrics"][k], v, rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    if stage == "mask":
        torch.testing.assert_close(r0["error_map"], world1["error_map"],
                                   rtol=0, atol=1e-3)


def test_world2_ranks_draw_the_same_mask_batches(world2, world1):
    """Each rank draws the next stage-3 batch from the error map the last
    step left: every rank's batches and maps are bitwise the same, and the
    batches are the unsharded run's."""
    r0, r1, _ = world2
    for i, (a, b, ref) in enumerate(zip(r0["mask_draws"], r1["mask_draws"],
                                        world1["mask_draws"])):
        for k, v in a.items():
            assert torch.equal(v, b[k]), (i, k)
            if k != "error_map":
                assert torch.equal(v, ref[k]), (i, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_write_cells_keeps_a_repeated_cells_last_value(seed):
    """The error map's update: a cell drawn more than once takes its last
    draw's value, as a sequential write gives it; other cells keep theirs
    and the input is not written."""
    g = torch.Generator().manual_seed(seed)
    em = torch.rand((3, 16), generator=g)
    before = em.clone()
    views = torch.randint(0, 3, (200,), generator=g)
    cells = torch.randint(0, 16, (200,), generator=g)
    values = torch.rand(200, generator=g)
    want = em.clone()
    for v, c, x in zip(views.tolist(), cells.tolist(), values.tolist()):
        want[v, c] = x
    assert len(set(zip(views.tolist(), cells.tolist()))) < 200  # repeats
    assert torch.equal(write_cells(em, views, cells, values), want)
    assert torch.equal(em, before)


def test_draw_cells_is_the_inverse_cdf_of_its_uniforms():
    """The stage-3 cell draw: each draw is the cell whose int64
    fixed-point CDF interval holds its float64 uniform; the rows are
    normalised, so a view is drawn uniformly; the cells follow the map."""
    g = torch.Generator().manual_seed(0)
    weights = torch.rand((3, 16), generator=g) + 0.05
    weights[1, 4] = 40.0  # view 1's mass mostly on cell 4
    n = 20000
    got = draw_cells(torch.Generator().manual_seed(1), weights, n)
    u = torch.rand(n, generator=torch.Generator().manual_seed(1),
                   dtype=torch.float64).numpy()
    w = weights.double().numpy()
    fixed = np.round(w / w.sum(-1, keepdims=True) * 2.0 ** 40).astype(
        np.int64).reshape(-1)
    cdf = np.cumsum(fixed)
    want = np.searchsorted(cdf, (u * float(cdf[-1])).astype(np.int64),
                           side="right")
    np.testing.assert_array_equal(got.numpy(), want)
    views = got // 16
    assert all(abs(float((views == v).double().mean()) - 1 / 3) < 0.02
               for v in range(3))
    share = float((got[views == 1] % 16 == 4).double().mean())
    p4 = float(weights[1, 4] / weights[1].sum())
    assert abs(share - p4) < 0.02, (share, p4)


def test_sharded_render_matches_staged_and_jax(world2):
    import jax.numpy as jnp
    from sanerf_hq_tpu.parallel import make_mesh as j_mesh
    from sanerf_hq_tpu.parallel import make_sharded_render as j_render
    from sanerf_hq_tpu.render.renderer import RenderSettings as JSettings

    r0, r1, (jm, params, state) = world2
    ours = r0["render"]
    ro, rd = _render_rays(RENDER_HW)
    cnf = torch.tensor([[0.5, 8.0]])
    model = SANeRFField(grid_bound=CFG.grid_bound, device="cpu",
                        **{k: v for k, v in _specs().items()
                           if k != "feat_spec"})
    model.load_state_dict(state)
    with torch.inference_mode():
        ref = render_staged(model, ro, rd, SETTINGS, cam_near_far=cnf)
    js = JSettings(num_steps=(16, 8, 4), min_near=0.05, bound=4.0,
                   max_ray_batch=32)
    jout = j_render(jm, js, j_mesh((8,), ("data",)))(
        params, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
        cam_near_far=jnp.asarray(cnf.numpy()))
    for k in ("image", "depth", "weights_sum"):
        assert ours[k].shape[0] == 99, (k, ours[k].shape)
        assert torch.equal(ours[k], r1["render"][k]), k
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-3, err_msg=k)


def test_sharded_eval_step_matches_jax(world2):
    import jax.numpy as jnp
    from sanerf_hq_tpu.parallel import make_mesh as j_mesh
    from sanerf_hq_tpu.parallel import make_sharded_eval_step as j_eval
    from sanerf_hq_tpu.render.renderer import RenderSettings as JSettings

    r0, r1, (jm, params, state) = world2
    ours = r0["eval"]
    ro, rd = _render_rays(EVAL_HW, 1)
    gt = np.random.default_rng(2).random((ro.shape[0], 3)).astype(np.float32)
    js = JSettings(num_steps=(16, 8, 4), min_near=0.05, bound=4.0,
                   perturb=False, training=False)
    jout = j_eval(jm, js, j_mesh((8,), ("data",)))(
        params, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
        jnp.asarray(gt))
    np.testing.assert_allclose(float(ours["mse"]), float(jout["mse"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(ours["psnr"]), float(jout["psnr"]),
                               rtol=1e-4)
    model = SANeRFField(grid_bound=CFG.grid_bound, device="cpu",
                        **{k: v for k, v in _specs().items()
                           if k != "feat_spec"})
    model.load_state_dict(state)
    with torch.inference_mode():
        img = render_rays(model, ro, rd, SETTINGS)["image"]
    np.testing.assert_allclose(float(ours["mse"]),
                               float(((img - torch.as_tensor(gt)) ** 2)
                                     .mean()), rtol=1e-5)
    np.testing.assert_allclose(ours["image"].numpy(), img.numpy(), rtol=0,
                               atol=1e-5)
    assert torch.equal(ours["image"], r1["eval"]["image"])


def _cli_argv(scene, ws):
    return [scene, "--data_type", "llff", "--field_type", "mlp", "--device",
            "cpu", "--num_steps", "16", "8", "8", "--cp_rank", "8",
            "--cp_res", "32", "--num_points", "2048", "--iters", "8",
            "--eval_cnt", "1", "--save_cnt", "1", "--min_near", "0.05",
            "--workspace", ws]


@pytest.fixture(scope="module")
def cli_ref(tmp_path_factory):
    """A 32 x 32 scene and the CLI's 8 stage-1 steps on it in this process,
    without a process group: (scene, the step-8 checkpoint)."""
    tmp = tmp_path_factory.mktemp("cli")
    scene = str(tmp / "scene")
    write_llff_scene(scene, n_views=17, H=32, W=32)
    ws = str(tmp / "ws0")
    threads = torch.get_num_threads()
    torch.set_num_threads(CLI_THREADS)  # the ranks' count: the same sums
    try:
        cli.main(_cli_argv(scene, ws))
    finally:
        torch.set_num_threads(threads)
    return scene, torch.load(os.path.join(ws, "checkpoints",
                                          "step_00000008.pt"),
                             weights_only=True)


@pytest.mark.parametrize("nproc", [1, 2])
def test_cli_under_torchrun_matches_the_plain_cli(cli_ref, tmp_path, nproc):
    scene, ref = cli_ref
    ws = str(tmp_path / f"ws{nproc}")
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(CLI_THREADS))
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc_per_node", str(nproc), "-m",
                        "sanerf_hq_tpu_torch", *_cli_argv(scene, ws)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=TIME_LIMIT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"sharding rays over mesh {{'data': {nproc}}}" in r.stdout
    assert r.stdout.count("[EVAL] LPIPS[torch-random-proxy] = ") == 1
    with open(os.path.join(ws, "log_ngp.txt")) as f:
        assert f.read().count("[EVAL] SSIM = ") == 1  # rank 0 alone
    got = torch.load(os.path.join(ws, "checkpoints", "step_00000008.pt"),
                     weights_only=True)
    assert got["step"] == ref["step"] == 8
    for part in ("model", "ema"):
        for name, want in ref[part].items():
            if nproc == 1:
                assert torch.equal(got[part][name], want), (part, name)
            else:
                _close(got[part][name], want, f"{part}/{name}")
