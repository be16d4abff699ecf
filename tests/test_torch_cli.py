"""The port's entry points on the CPU: `python -m sanerf_hq_tpu_torch
<scene> --test` against the JAX Trainer.render_view with the same weights
(carried across as an .npz), the device rule, and the rule that nothing of
the port imports JAX or the JAX package.

Bar: max abs < 2e-2 on image, depth and weights_sum.  The JAX trainer
renders through the composable route on the CPU and the port through its
level-kernel route (plain twins here), so this is also the route bar.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.config import Config as JaxConfig
from sanerf_hq_tpu.data.provider import load_scene as jax_load_scene
from sanerf_hq_tpu.models import make_field as jax_make_field
from sanerf_hq_tpu.train.trainer import Trainer as JaxTrainer
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.png import read_png
from sanerf_hq_tpu_torch.data.synthetic import write_llff_scene
from sanerf_hq_tpu_torch.device import resolve_device
from sanerf_hq_tpu_torch.models import make_field
from sanerf_hq_tpu_torch.models.convert import save_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 32
SMALL = ["--num_steps", "16", "8", "8", "--cp_rank", "8", "--cp_res", "32"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    write_llff_scene(root, n_views=17, H=HW, W=HW)  # val views: v00, v16
    return root


def _argv(scene, ws, *extra):
    return [scene, "--test", "--field_type", "mlp", "--data_type", "llff",
            "--workspace", ws, *SMALL, *extra]


def test_cli_test_matches_jax_render_view(scene, tmp_path, capsys):
    cfg = JaxConfig(path=scene, data_type="llff", field_type="mlp",
                    num_steps=(16, 8, 8), cp_rank=8, cp_res=32,
                    workspace=str(tmp_path / "jax"))
    model = jax_make_field("mlp", grid_bound=cfg.grid_bound, cp_rank=8,
                           cp_res=32)
    jt = JaxTrainer("ngp", cfg, model, cfg.workspace, use_checkpoint="none")
    npz = str(tmp_path / "params.npz")
    save_npz(npz, jax.device_get(jt.state.ema_params))
    js = jax_load_scene(scene, "llff")
    want = jt.render_view(js.poses[0], js.intrinsics[0], HW, HW)

    ws = str(tmp_path / "port")
    trainer = cli.main(_argv(scene, ws, "--ckpt", npz, "--device", "cpu"))
    assert "[EVAL] PSNR" in capsys.readouterr().out
    got = trainer.render_view(js.poses[0], js.intrinsics[0], HW, HW)
    for k in ("image", "depth", "weights_sum"):
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err < 2e-2, f"{k}: max abs {err}"

    res = os.path.join(ws, "results")
    for stem in ("v00", "v16"):
        assert os.path.exists(os.path.join(res, f"{stem}_rgb.png"))
        assert os.path.exists(os.path.join(res, f"{stem}_depth.npy"))
    img = (np.clip(got["image"], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(os.path.join(res, "v00_rgb.png")),
                                  img.reshape(HW, HW, 3))
    np.testing.assert_array_equal(np.load(os.path.join(res, "v00_depth.npy")),
                                  got["depth"].reshape(HW, HW))


def test_cli_seeded_init_without_ckpt(scene, tmp_path, capsys):
    cli.main(_argv(scene, str(tmp_path), "--device", "cpu"))
    assert "initialised from --seed 0" in capsys.readouterr().out


def test_trainer_evaluate_and_perturbed_render(scene, tmp_path, capsys):
    from sanerf_hq_tpu_torch.data.provider import load_scene

    trainer = cli.main(_argv(scene, str(tmp_path / "ws"), "--device", "cpu"))
    s = load_scene(scene, "llff")
    s.images, s.poses, s.img_names = s.images[:2], s.poses[:2], s.img_names[:2]
    psnr = trainer.evaluate(s, save_dir=str(tmp_path / "val"))
    assert np.isfinite(psnr) and "[EVAL] PSNR" in capsys.readouterr().out
    for name in ("v00_rgb.png", "v00_gt.png", "v00_error.png",
                 "v01_depth.npy"):
        assert os.path.exists(os.path.join(tmp_path / "val", name)), name
    det = trainer.render_view(s.poses[0], s.intrinsics[0], HW, HW)
    jittered = [trainer.render_view(s.poses[0], s.intrinsics[0], HW, HW,
                               generator=torch.Generator().manual_seed(7))
           for _ in range(2)]
    np.testing.assert_array_equal(jittered[0]["depth"], jittered[1]["depth"])
    assert not np.array_equal(jittered[0]["depth"], det["depth"])


def test_cli_only_test_mode_is_ported(scene, tmp_path, capsys):
    """The CLI's fail-fast checks, before any model is built, as the JAX
    CLI's: --decode without --with_sam, --decode --use_point without
    --point_file, stage-3 training without --mask_root."""
    cases = ((["--decode"], "--decode requires --with_sam"),
             (["--with_sam", "--decode", "--use_point"],
              "requires --point_file"))
    for flags, msg in cases:
        with pytest.raises(SystemExit, match=msg):
            cli.main(_argv(scene, str(tmp_path), "--device", "cpu", *flags))
    argv = _argv(scene, str(tmp_path), "--device", "cpu", "--with_mask")
    argv.remove("--test")
    with pytest.raises(SystemExit, match="--with_mask training requires "
                                         "--mask_root"):
        cli.main(argv)
    assert not os.path.exists(os.path.join(tmp_path, "results"))
    assert not os.path.exists(os.path.join(tmp_path, "checkpoints"))


def test_cli_train_then_test_resumes(scene, tmp_path, capsys):
    """Without --test the CLI trains, checkpoints and evaluates PSNR and
    SSIM into validation/; a later --test resumes the checkpoint and
    renders the EMA weights."""
    ws = str(tmp_path / "ws")
    argv = _argv(scene, ws, "--device", "cpu", "--num_points", "1024",
                 "--iters", "20", "--eval_cnt", "1", "--save_cnt", "1")
    argv.remove("--test")
    trainer = cli.main(argv)
    out = capsys.readouterr().out
    assert trainer.state.step == 20 and trainer.cfg.num_rays == 128
    assert "[epoch 2/2] step 20" in out and "steps/s)" in out
    assert "[EVAL] SSIM" in out
    assert sorted(os.listdir(os.path.join(ws, "checkpoints"))) == [
        "best.pt", "step_00000020.pt"]
    assert os.path.exists(os.path.join(ws, "validation", "v16_rgb.png"))

    tested = cli.main(_argv(scene, ws, "--device", "cpu"))
    assert "[INFO] resumed at step 20" in capsys.readouterr().out
    from sanerf_hq_tpu_torch.data.provider import load_scene
    s = load_scene(scene, "llff")
    got = tested.render_view(s.poses[0], s.intrinsics[0], HW, HW)
    want = trainer.render_view(s.poses[0], s.intrinsics[0], HW, HW)
    np.testing.assert_array_equal(got["image"], want["image"])
    ema = dict(trainer.state.ema_model.named_parameters())
    for name, p in tested.state.ema_model.named_parameters():
        assert torch.equal(p, ema[name]), name
    assert any(not torch.equal(p, ema[name])
               for name, p in trainer.model.named_parameters())


def test_cli_stage3_trains_evaluates_and_resumes(scene, tmp_path, capsys):
    """Stage 1, then stage 3 over it (--init_ckpt <stage-1 workspace>,
    sphere masks in the decode format): the backbone stays bit for bit the
    stage-1 checkpoint's, the error map is rebuilt, mean IoU is printed and
    a stage-3 checkpoint written; a later --test --with_mask resumes the
    field (weights only: its optimizer covers every parameter) and writes
    the mask results."""
    from sanerf_hq_tpu_torch.data.synthetic import write_sphere_masks

    ws1, ws3 = str(tmp_path / "ws1"), str(tmp_path / "ws3")
    masks = str(tmp_path / "masks")
    write_sphere_masks(masks, n_views=17, H=HW, W=HW)
    argv = _argv(scene, ws1, "--device", "cpu", "--num_points", "1024",
                 "--iters", "10", "--eval_cnt", "1", "--save_cnt", "1")
    argv.remove("--test")
    cli.main(argv)
    stage1 = torch.load(os.path.join(ws1, "checkpoints", "step_00000010.pt"),
                        weights_only=True)["model"]

    s3 = ["--with_mask", "--mask_root", masks, "--feat_rank", "8",
          "--feat_res", "16", "--online_resolution", str(HW),
          "--error_map_size", "8"]
    argv = _argv(scene, ws3, "--device", "cpu", "--init_ckpt", ws1,
                 "--iters", "6", "--num_rays", "64", "--error_map",
                 "--ray_pair_rgb_loss_weight", "1", "--ray_pair_rgb_iter", "3",
                 "--ray_pair_rgb_num_sample", "4", "--ray_pair_rgb_threshold",
                 "0.1", "--local_sample_patch_size", "4", "--num_local_sample",
                 "2", *s3)
    argv.remove("--test")
    trainer = cli.main(argv)
    out = capsys.readouterr().out
    assert "[INFO] loaded 16 param tensors from init checkpoint" in out
    assert trainer.backbone_frozen and trainer.state.step == 6
    assert "error map rebuilt at step 3" in out
    assert "error map rebuilt at step 6" in out
    assert "[mask 6/6] loss=" in out and "[EVAL] MeanIoU = " in out
    assert np.isfinite([v["loss"] for _, v in trainer.stats["mask"]]).all()
    state = trainer.model.state_dict()
    for name, p in stage1.items():
        assert torch.equal(state[name], p), name
    # the mask branch trained (the EMA, never updated in stage 3, still
    # holds its initial weights)
    assert not torch.equal(state["cp_m_x"], trainer.state.ema_model.cp_m_x)
    assert os.path.exists(os.path.join(ws3, "checkpoints",
                                       "step_00000006.pt"))

    tested = cli.main(_argv(scene, ws3, "--device", "cpu", *s3))
    out = capsys.readouterr().out
    assert "loaded model weights only (resumed at step 6)" in out
    assert "[EVAL] MeanIoU = " in out
    for name, p in tested.model.state_dict().items():
        assert torch.equal(p, state[name]), name
    res = os.path.join(ws3, "results")
    assert sorted(os.listdir(res)) == ["v00_mask.npy", "v00_mask_vis.png",
                                       "v16_mask.npy", "v16_mask_vis.png"]
    probs = np.load(os.path.join(res, "v00_mask.npy"))
    assert probs.shape == (HW, HW, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert read_png(os.path.join(res, "v16_mask_vis.png")).shape == (HW, HW,
                                                                     3)


@pytest.mark.parametrize("cp_rank,per_step", [("8", 2), ("0", 3)])
def test_cli_stage3_trains_a_trainable_backbone(scene, tmp_path, capsys,
                                                monkeypatch, cp_rank,
                                                per_step):
    """Stage 3 without --init_ckpt: the backbone is initialised from --seed
    and stays trainable, so the mask step renders through the composable
    route, where K8's entry point runs both proposal MLPs (and, without CP
    features, the trunk) once a step; the error-map and evaluation renders
    take the frozen inference route and never call it.  A spy counts the
    calls: the launch counters count only the card."""
    from sanerf_hq_tpu_torch.data.synthetic import write_sphere_masks
    from sanerf_hq_tpu_torch.models import mlp_field

    masks = str(tmp_path / "masks")
    write_sphere_masks(masks, n_views=17, H=HW, W=HW)
    calls = []

    def spy(x, *a, **k):
        calls.append(tuple(x.shape))
        return fused_freq_mlp(x, *a, **k)

    fused_freq_mlp = mlp_field.fused_freq_mlp
    monkeypatch.setattr(mlp_field, "fused_freq_mlp", spy)
    argv = _argv(scene, str(tmp_path / "ws3"), "--device", "cpu",
                 "--with_mask", "--mask_root", masks, "--feat_rank", "8",
                 "--feat_res", "16", "--online_resolution", str(HW),
                 "--error_map_size", "8", "--iters", "4", "--num_rays", "64",
                 "--error_map", "--ray_pair_rgb_loss_weight", "1",
                 "--ray_pair_rgb_iter", "2", "--local_sample_patch_size",
                 "4", "--num_local_sample", "2", "--cp_rank", cp_rank)
    argv.remove("--test")
    trainer = cli.main(argv)
    out = capsys.readouterr().out
    assert not trainer.backbone_frozen and trainer.state.step == 4
    assert "init checkpoint" not in out and "initialised from --seed" in out
    assert "error map rebuilt at step 4" in out
    assert "[mask 4/4] loss=" in out and "[EVAL] MeanIoU = " in out
    ce = [v["ce"] for _, v in trainer.stats["mask"]]
    assert len(ce) == 2 and np.isfinite(ce).all()
    assert len(calls) == per_step * 4, calls
    n_rays = 64 + 2 * 4 * 4
    assert calls[:2] == [(n_rays, 16, 3), (n_rays, 8, 3)]
    # as in JAX, the mask loss reads the backbone's weights, features and
    # image detached: the trainable backbone gets no grad and keeps its
    # seeded weights (the EMA, never updated in stage 3, holds them)
    ema = dict(trainer.state.ema_model.named_parameters())
    for name, p in trainer.model.named_parameters():
        moved = not torch.equal(p, ema[name])
        assert moved == name.startswith(("cp_m_", "mask_mlp")), name


def test_entry_points_need_a_device_or_cpu(scene, tmp_path, monkeypatch):
    """Without a GPU and without device='cpu' the entry points raise; they
    never quietly run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_field("mlp", cp_rank=4, cp_res=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(scene, str(tmp_path)))
    assert resolve_device("cpu").type == "cpu"


_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu", "cv2",
           "transformers", "imageio", "matplotlib"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import sanerf_hq_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(sanerf_hq_tpu_torch.__path__,
                                              "sanerf_hq_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
NEW = {"sanerf_hq_tpu_torch.parallel.mesh",
       "sanerf_hq_tpu_torch.parallel.evaluate", "sanerf_hq_tpu_torch.train.lpips",
       "sanerf_hq_tpu_torch.ops.freq", "sanerf_hq_tpu_torch.ops.encoding",
       "sanerf_hq_tpu_torch.data.colmap_native",
       "sanerf_hq_tpu_torch.tools.make_synth_scene",
       "sanerf_hq_tpu_torch.tools.colmap2nerf"}
assert NEW <= set(mods), sorted(NEW - set(mods))
import chip_smoke
print(len(mods))
"""


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port (the SAM, viewer and trajectory modules,
    the data-parallel, LPIPS, encoder and native COLMAP reader modules,
    and the scene writer and colmap2nerf of tools/ too) and chip_smoke.py
    import with JAX, the JAX package, OpenCV, transformers, imageio and
    matplotlib blocked."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 65  # every module was imported


_SCRIPTS = r"""
import importlib.abc, json, os, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu", "cv2"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
from chip_smoke import script_argv
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.synthetic import (write_colmap_scene,
                                                write_sphere_masks)

root = os.getcwd()
env = {"SANERFHQ_DATA_PATH": os.path.join(root, "scene"),
       "SANERFHQ_WORKSPACE_ROOT": os.path.join(root, "ws"),
       "SANERFHQ_SCENE": "sphere",
       "SANERFHQ_MASK_PATH": os.path.join(root, "masks"),
       "SANERFHQ_INIT_CKPT": os.path.join(root, "ws", "rgb_nerf", "sphere")}
# 17 views (val: v00, v16), images_4/ at 16x16 and images/ at 64x64
write_colmap_scene(env["SANERFHQ_DATA_PATH"], n_views=17, H=16, W=16,
                   downscale=4, n_points=400)
write_sphere_masks(env["SANERFHQ_MASK_PATH"], n_views=17, H=64, W=64)
with open("example_test_views.json", "w") as f:
    json.dump(["v00", "v16"], f)
small = ["--device", "cpu", "--num_steps", "16", "8", "8"]
cuts = {"train_rgb_nerf.sh": ["--iters", "3", "--num_points", "512"],
        "train_obj_nerf.sh": ["--iters", "4", "--num_rays", "64",
                              "--online_resolution", "32",
                              "--error_map_size", "8",
                              "--ray_pair_rgb_iter", "2"],
        "test_obj_nerf.sh": []}
out = {}
for name, cut in cuts.items():
    argv = script_argv(name, env)
    cli.build_parser().parse_args(argv)  # the script's own flag set parses
    trainer = cli.main(argv + small + cut)
    out[name] = {"argv": argv, "step": trainer.state.step,
                 "field": type(trainer.model).__name__,
                 "with_mask": trainer.model.with_mask,
                 "frozen": trainer.backbone_frozen,
                 "workspace": trainer.workspace}
print("RESULT " + json.dumps(out))
"""


def test_scripts_flag_sets_run_without_jax_or_opencv(tmp_path):
    """The flag sets of scripts/train_rgb_nerf.sh, train_obj_nerf.sh and
    test_obj_nerf.sh, read out of the scripts, parse and run in a row
    through the CLI on a COLMAP scene (--data_type mip, --downscale 4),
    with --device cpu and small sizes appended, in a process where JAX,
    the JAX package and OpenCV cannot be imported: stage 1 of the
    hash-grid field, stage 3 of its object field over the frozen backbone,
    and the stage-3 --test."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SCRIPTS], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    import json

    res = json.loads(r.stdout.split("RESULT ")[-1])
    rgb, obj, test = (res[n] for n in ("train_rgb_nerf.sh",
                                       "train_obj_nerf.sh",
                                       "test_obj_nerf.sh"))
    for flag in ("--enable_cam_center", "--downscale", "--contract",
                 "--random_image_batch"):
        assert flag in rgb["argv"]
    assert "--return_extra" in test["argv"] and "--test" in test["argv"]
    assert rgb["field"] == obj["field"] == test["field"] == "SANeRFField"
    assert (rgb["step"], obj["step"], test["step"]) == (3, 4, 4)
    assert obj["with_mask"] and obj["frozen"] and not rgb["with_mask"]
    out = r.stdout
    assert "[INFO] error map rebuilt at step 2" in out
    assert out.count("[EVAL] MeanIoU = ") == 2, out[-3000:]
    # the stage-3 run left the stage-1 backbone bitwise as it was
    ws = os.path.join(str(tmp_path), "ws")
    stage1 = torch.load(os.path.join(ws, "rgb_nerf", "sphere", "checkpoints",
                                     "step_00000003.pt"),
                        weights_only=True)["model"]
    stage3 = torch.load(os.path.join(ws, "obj_nerf", "sphere", "checkpoints",
                                     "step_00000004.pt"),
                        weights_only=True)["model"]
    assert set(stage3) - set(stage1) == {
        "m_grid", "mask_mlp.layers.0.weight", "mask_mlp.layers.1.weight",
        "mask_mlp.layers.2.weight"}
    assert stage3["m_grid"].shape == (5_258_512, 8)
    for name, v in stage1.items():
        assert torch.equal(stage3[name], v), name
    results = os.path.join(ws, "obj_nerf", "sphere", "results")
    for stem in ("v00", "v16"):
        probs = np.load(os.path.join(results, f"{stem}_mask.npy"))
        assert probs.shape == (64, 64, 2) and np.isfinite(probs).all()
        assert read_png(os.path.join(results, f"{stem}_mask_vis.png")
                        ).shape == (64, 64, 3)


def test_cli_with_sam_without_checkpoint_warns_and_uses_seeded_weights(
        scene, tmp_path, capsys, monkeypatch):
    """Without the --sam_ckpt file the CLI warns and builds SAM with random
    weights from --seed (here the tiny ViT under vit_h's name); --with_sam
    --test without --decode renders the held-out views as stage 1's --test
    does."""
    import sanerf_hq_tpu_torch.sam.build as B

    monkeypatch.setitem(B._CONFIGS, "vit_h", lambda: dict(
        embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
        window_size=3))
    ws = str(tmp_path / "ws")
    trainer = cli.main(_argv(scene, ws, "--device", "cpu", "--with_sam",
                             "--seed", "3", "--sam_ckpt",
                             str(tmp_path / "none.pth")))
    out = capsys.readouterr().out
    assert (f"[WARN] SAM checkpoint {tmp_path / 'none.pth'} not found; "
            "using random weights from --seed 3") in out
    # the cache's val_all: every view rendered
    assert len(os.listdir(os.path.join(ws, "results"))) == 2 * 17
    assert trainer.state.optimizer is not None  # nothing was frozen


def test_cli_distill_container_trains_evaluates_and_decodes(
        scene, tmp_path, capsys, monkeypatch):
    """Stage 2's distill container through the CLI on the CPU (the tiny
    ViT under vit_h's name, random weights): --with_sam
    --feature_container distill --init_ckpt <stage 1> trains the CP
    volume and the SAM MLP for 6 steps (a ring of 2 batches, the encoder
    every 2nd step once it is full: 4 encodes), leaves the backbone bit for
    bit the stage-1 checkpoint's and prints the rendered features' MSE;
    then --test --decode --use_point --feature_container distill decodes
    every view from the rendered features, and --test --return_extra
    --with_sam writes each held-out view's rendered features."""
    import json

    import sanerf_hq_tpu_torch.sam.build as B
    from sanerf_hq_tpu_torch.train import stages

    monkeypatch.setitem(B._CONFIGS, "vit_h", lambda: dict(
        embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
        window_size=3))
    encodes = []
    batch = stages.distill_batch
    monkeypatch.setattr(stages, "distill_batch", lambda *a, **k: (
        encodes.append(1), batch(*a, **k))[1])
    ws1, ws2 = str(tmp_path / "ws1"), str(tmp_path / "ws2")
    argv = _argv(scene, ws1, "--device", "cpu", "--num_points", "1024",
                 "--iters", "4", "--eval_cnt", "1", "--save_cnt", "1")
    argv.remove("--test")
    cli.main(argv)
    stage1 = torch.load(os.path.join(ws1, "checkpoints", "step_00000004.pt"),
                        weights_only=True)["model"]
    sam = ["--with_sam", "--feat_rank", "8", "--feat_res", "16",
           "--sam_use_view_direction", "--sam_ckpt",
           str(tmp_path / "none.pth")]
    argv = _argv(scene, ws2, "--device", "cpu", "--init_ckpt", ws1,
                 "--feature_container", "distill", "--iters", "6",
                 "--cache_size", "2", "--cache_interval", "2",
                 "--online_resolution", "16", "--save_cnt", "2", *sam)
    argv.remove("--test")
    trainer = cli.main(argv)
    out = capsys.readouterr().out
    assert trainer.state.step == 6 and trainer.backbone_frozen
    assert len(encodes) == 4
    assert "[SAM-distill 6/6] loss=" in out and "[EVAL stage-2] MSE" in out
    assert np.isfinite([v["loss"] for _, v in trainer.stats["distill"]]).all()
    state = trainer.model.state_dict()
    for name, p in stage1.items():
        assert torch.equal(state[name], p), name
    moved = sorted(n for n, p in trainer.model.named_parameters()
                   if not torch.equal(p, trainer.state.ema_model.state_dict()[n]))
    assert moved and all(n.startswith(("cp_s_", "samvit_")) for n in moved)
    assert sorted(os.listdir(os.path.join(ws2, "checkpoints"))) == [
        "step_00000003.pt", "step_00000006.pt"]

    points = str(tmp_path / "points.json")
    with open(points, "w") as f:
        json.dump({"points": [[0.0, 0.0, 0.0]], "valid_threshold": 1}, f)
    cli.main(_argv(scene, ws2, "--device", "cpu", "--init_ckpt", ws1,
                   "--decode", "--use_point", "--point_file", points,
                   "--feature_container", "distill", *sam))
    assert "[decode] v16 valid=" in capsys.readouterr().out
    dec = os.path.join(ws2, "object_masks")
    with open(os.path.join(dec, "valid_dict.json")) as f:
        assert sorted(json.load(f)) == ["v00", "v16"]
    for stem in ("v00", "v16"):
        m = np.load(os.path.join(dec, f"{stem}_obj_mask.npy"))
        assert m.shape == (1, HW, HW) and m.dtype == np.uint8
        assert os.path.exists(os.path.join(dec, f"{stem}_rgb.png"))

    tested = cli.main(_argv(scene, ws2, "--device", "cpu", "--return_extra",
                            *sam))
    # without --init_ckpt nothing is frozen, so Adam's state does not fit
    assert "loaded model weights only (resumed at step 6)" in (
        capsys.readouterr().out)
    assert tested.state.step == 6
    for stem in ("v00", "v16"):
        f = np.load(os.path.join(ws2, "results", f"{stem}_sam.npy"))
        assert f.shape == (64, 64, 256) and np.isfinite(f).all()
        assert os.path.exists(os.path.join(ws2, "results",
                                           f"{stem}_rgb.png"))


_SAM_CHAIN = r"""
import importlib.abc, json, os, sys
import numpy as np
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu", "cv2",
           "transformers"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
from chip_smoke import script_argv
from sanerf_hq_tpu_torch import cli
from sanerf_hq_tpu_torch.data.synthetic import write_llff_scene
import sanerf_hq_tpu_torch.sam.build as B

# the tiny ViT of tests/test_torch_sam.py under the default --sam_model_type
B._CONFIGS["vit_h"] = lambda: dict(embed_dim=32, depth=2, num_heads=2,
                                   global_attn_indexes=(1,), window_size=3)
root = os.getcwd()
scene = os.path.join(root, "scene")
write_llff_scene(scene, n_views=17, H=32, W=32)
# a checkpoint in the released layout: the keys and shapes of the model,
# random values at the scales of trained weights, from numpy's seed 0
import torch
rng = np.random.default_rng(0)
sd = {}
for k, v in B.build_sam("vit_h", device="meta").state_dict().items():
    if v.ndim == 1:
        a = (1.0 if k.endswith("weight") else 0.0) + 0.1 * rng.normal(
            size=v.shape)
    elif k.endswith(("token.weight", "tokens.weight", "embed.weight",
                     "matrix")) or ".point_embeddings." in k:
        a = rng.normal(size=v.shape)
    else:
        a = rng.normal(size=v.shape) / np.sqrt(v[0].numel())
    sd[k] = torch.as_tensor(a, dtype=torch.float32)
sam_ckpt = os.path.join(root, "sam_tiny.pth")
torch.save({"model": sd}, sam_ckpt)
env = {"SANERFHQ_DATA_PATH": scene, "SANERFHQ_WORKSPACE_ROOT": root,
       "SANERFHQ_SCENE": "s", "SANERFHQ_INIT_CKPT": "ws1"}
for name in ("train_sam_nerf.sh", "decode.sh"):  # the scripts' flags parse
    cli.build_parser().parse_args(script_argv(name, env))
small = [scene, "--data_type", "llff", "--field_type", "mlp", "--device",
         "cpu", "--num_steps", "16", "8", "8", "--cp_rank", "8", "--cp_res",
         "32"]
ws1, ws2, ws3 = (os.path.join(root, w) for w in ("ws1", "ws2", "ws3"))
cli.main(small + ["--workspace", ws1, "--iters", "10", "--num_points",
                  "1024", "--eval_cnt", "1", "--save_cnt", "1"])
t2 = cli.main(small + ["--workspace", ws2, "--with_sam",
                       "--feature_container", "cache", "--iters", "0",
                       "--init_ckpt", ws1, "--sam_ckpt", sam_ckpt])
# prompts where stage 2's field puts three pixels of v05, a training view
# (through the projection's flip), so they pass v05's depth gate
from sanerf_hq_tpu_torch.data.provider import load_scene
sc = load_scene(scene, "llff")
pose, (fx, fy, cx, cy) = sc.poses[5], sc.intrinsics[5]
depth = t2.render_view(pose, sc.intrinsics[5], 32, 32)["depth"].reshape(32, 32)
pts = []
for px, py in ((16, 16), (12, 20), (20, 11)):
    z = -float(depth[py, px])
    X, Y = (32 - cx - (px + 0.5)) * z / fx, ((py + 0.5) - cy) * z / fy
    pts.append((pose @ np.array([X, Y, z, 1.0]))[:3].tolist())
point_file = os.path.join(root, "points.json")
with open(point_file, "w") as f:
    json.dump({"points": pts, "crucial_point_index": [0],
               "valid_threshold": 1}, f)
t_dec = cli.main(small + ["--workspace", ws2, "--test", "--decode",
                          "--use_point", "--point_file", point_file,
                          "--with_sam", "--init_ckpt", ws1, "--sam_ckpt",
                          sam_ckpt, "--test_split", "val", "--val_type",
                          "val_all"])
t3 = cli.main(small + ["--workspace", ws3, "--with_mask", "--mask_root",
                       os.path.join(ws2, "object_masks"), "--init_ckpt", ws1,
                       "--feat_rank", "8", "--feat_res", "16",
                       "--online_resolution", "32", "--iters", "4",
                       "--num_rays", "64", "--local_sample_patch_size", "4",
                       "--num_local_sample", "2"])
print("RESULT " + json.dumps({
    "stage2_frozen": t2.backbone_frozen, "decode_frozen": t_dec.backbone_frozen,
    "stage3_step": t3.state.step}))
"""


def test_cli_sam_chain_runs_without_jax_or_opencv(tmp_path):
    """The chain users run, through the port's CLI on the CPU with JAX,
    the JAX package, OpenCV and transformers blocked and the tiny SAM in
    the registry: stage 1, stage 2 (--with_sam --feature_container cache
    --iters 0 --init_ckpt <stage 1>: every view rendered and encoded into
    sam_cache/), the decode (--test --decode --use_point --point_file:
    object_masks/ with a mask and a validity for every view), and stage 3
    trained on that decode output (--mask_root).  The flag sets of
    scripts/train_sam_nerf.sh and decode.sh parse."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SAM_CHAIN], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    import json

    out = r.stdout
    res = json.loads(out.split("RESULT ")[-1])
    assert res["stage2_frozen"] and res["decode_frozen"]
    assert res["stage3_step"] == 4
    assert "SAM checkpoint" not in out  # --sam_ckpt was read
    assert out.count("[SAM-cache] ") == 17 and "[EVAL] MeanIoU = " in out
    cache = os.path.join(str(tmp_path), "ws2", "sam_cache")
    stems = [f"v{i:02d}" for i in range(17)]
    assert sorted(os.listdir(cache)) == [f"{s}.npy" for s in stems]
    feats = np.load(os.path.join(cache, "v05.npy"))
    assert feats.shape == (64, 64, 256) and feats.dtype == np.float32
    assert np.isfinite(feats).all()
    dec = os.path.join(str(tmp_path), "ws2", "object_masks")
    with open(os.path.join(dec, "valid_dict.json")) as f:
        valid = json.load(f)
    assert sorted(valid) == stems and valid["v05"] == 1
    for s in stems:
        m = np.load(os.path.join(dec, f"{s}_obj_mask.npy"))
        assert m.shape == (1, HW, HW) and m.dtype == np.uint8
        assert os.path.exists(os.path.join(dec, f"{s}_rgb.png"))
        assert np.load(os.path.join(dec, f"{s}_depth.npy")).shape == (HW, HW)
    assert os.path.exists(os.path.join(str(tmp_path), "ws3", "checkpoints",
                                       "step_00000004.pt"))


def _options(parser):
    return {o: a.default for a in parser._actions for o in a.option_strings}


def test_parser_takes_every_jax_flag_and_adds_only_device():
    """The port's parser takes every option string of the JAX CLI's, with
    the same default; its only extra is --device."""
    from sanerf_hq_tpu.cli import build_parser as jax_parser

    want, got = _options(jax_parser()), _options(cli.build_parser())
    assert set(want) - set(got) == set()
    assert set(got) - set(want) == {"--device"}
    for flag, default in want.items():
        assert got[flag] == default, flag
    for flag in ("--T_thresh", "--sum_after_mlp", "--density_thresh",
                 "--ray_jittering", "--use_gt_focal_length"):  # parsed only
        a = next(a for a in cli.build_parser()._actions
                 if flag in a.option_strings)
        assert "surface parity only" in a.help, flag


def test_render_mesh_exits_as_jax_does(scene, tmp_path):
    from sanerf_hq_tpu.cli import main as jax_main

    argv = _argv(scene, str(tmp_path), "--render_mesh")
    with pytest.raises(SystemExit) as want:
        jax_main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "--render_mesh is not supported" in str(got.value)
    assert not os.listdir(tmp_path)


def _auto_seg_masks(root, names, H, W):
    """Decode-format masks: view 1 has no file, view 3 three foreground
    pixels, view 4 a low score; the rest are valid."""
    rng = np.random.default_rng(8)
    os.makedirs(root, exist_ok=True)
    valid = {}
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        if i == 1:
            continue
        m = (rng.uniform(size=(1, H, W)) > 0.5).astype(np.uint8)
        if i == 3:
            m[:] = 0
            m[0, 0, :3] = 1
        np.save(os.path.join(root, f"{stem}_obj_mask.npy"), m)
        valid[stem] = 0.2 if i == 4 else 0.9
    with open(os.path.join(root, "valid_dict.json"), "w") as f:
        json.dump(valid, f)


@pytest.mark.parametrize("n_views", [17, 40])
def test_auto_seg_masks_and_splits_match_jax(scene, tmp_path, monkeypatch,
                                             n_views):
    """--auto_seg: every view with a mask file is valid, none subsampled
    or drawn; train on every view, validate on the first 100; the masks,
    the valid views and both splits as JAX's; the CLI hands the flag to
    the loader and both splits."""
    from sanerf_hq_tpu.data import provider as jprov
    from sanerf_hq_tpu_torch.data import provider as tprov
    from sanerf_hq_tpu_torch.train import stages

    names = [f"v{i:02d}.png" for i in range(n_views)]
    root = str(tmp_path / "masks")
    _auto_seg_masks(root, names, HW, HW)
    jm, jv = jprov.load_object_masks(root, names, HW, HW, auto_seg=True)
    tm, tv = tprov.load_object_masks(root, names, HW, HW, auto_seg=True)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tv, jv)
    assert list(tv) == [i for i in range(n_views) if i != 1]
    for split in ("train", "val"):
        np.testing.assert_array_equal(
            tprov.split_indices(n_views, split, auto_seg=True),
            jprov.split_indices(n_views, split, auto_seg=True))
    if n_views != 17:
        return
    seen = {}
    real = tprov.load_object_masks

    def load(*a, **kw):
        seen["auto_seg"] = kw["auto_seg"]
        return real(*a, **kw)

    monkeypatch.setattr(tprov, "load_object_masks", load)
    monkeypatch.setattr(stages, "evaluate_masks",
                        lambda t, s, **kw: seen.update(val=list(s.img_names)))
    cli.main(_argv(scene, str(tmp_path / "ws"), "--device", "cpu",
                   "--with_mask", "--mask_root", root, "--auto_seg"))
    assert seen["auto_seg"] is True
    assert seen["val"] == names  # the first 100 views: all 17
