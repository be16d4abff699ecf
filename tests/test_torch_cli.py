"""The port's entry points on the CPU: `python -m sanerf_hq_tpu_torch
<scene> --test` against the JAX Trainer.render_view with the same weights
(carried across as an .npz), the device rule, and the rule that nothing of
the port imports JAX or the JAX package.

Bar: max abs < 2e-2 on image, depth and weights_sum.  The JAX trainer
renders through the composable route on the CPU and the port through its
level-kernel route (plain twins here), so this is also the route bar.
"""
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
    """Stages 1 and 3 are ported (the stage-3 test below trains, evaluates
    and resumes); stage 2 and decode are not, and the CLI refuses their
    flags.  Stage-3 training without --mask_root fails fast, before any
    model is built, as the JAX CLI does."""
    for flag in ("--with_sam", "--decode"):
        with pytest.raises(SystemExit):
            cli.main(_argv(scene, str(tmp_path), "--device", "cpu", flag))
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
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "sanerf_hq_tpu"}
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
import chip_smoke
print(len(mods))
"""


def test_port_and_chip_smoke_import_no_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 37  # every module was imported
