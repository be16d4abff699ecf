"""Stage-1 training smoke tests of the port on the CPU, mirroring the JAX
package's tests/test_train_smoke.py (same configurations, same bars): the
MLP field must learn (PSNR climbs by more than 4 dB in 200 steps), and a
held-out view must track the training views when the distortion loss is
ramped in.  The level-kernel route runs here through the K1/K2 and K3/K4
twins behind the autograd Functions.
"""
import numpy as np
import pytest
import torch

from sanerf_hq_tpu_torch.config import Config
from sanerf_hq_tpu_torch.data.rays import full_frame_rays
from sanerf_hq_tpu_torch.data.sampler import sample_rgb_batch
from sanerf_hq_tpu_torch.data.synthetic import make_synthetic_dataset
from sanerf_hq_tpu_torch.models import make_field
from sanerf_hq_tpu_torch.train.state import TrainState, mlp_field_lr_scales
from sanerf_hq_tpu_torch.train.steps import make_eval_render, make_rgb_train_step


@pytest.fixture(scope="module")
def scene():
    s = make_synthetic_dataset(n_views=8, H=48, W=48)
    return {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in s.items()}


def _train(cfg, model, images, poses, intr, seed=0):
    torch.manual_seed(seed)
    state = TrainState(model, cfg.lr, cfg.iters,
                       lr_scales=mlp_field_lr_scales(model))
    step_fn = make_rgb_train_step(model, cfg)
    gen = torch.Generator().manual_seed(seed)
    psnrs = []
    for _ in range(cfg.iters):
        batch = sample_rgb_batch(gen, images, poses, intr, cfg.num_rays)
        psnrs.append(float(step_fn(state, batch, gen)["psnr"]))
    return state, psnrs


def test_mlp_field_overfit_smoke(scene):
    """The flagship MLP field must learn (the per-leaf lr scales keep the
    sigmoid colour head out of its all-background collapse)."""
    cfg = Config(num_steps=(32, 16, 8), num_rays=512, iters=200,
                 lambda_distort=0.0, bound=4.0, min_near=0.05)
    model = make_field("mlp", device="cpu", grid_bound=cfg.grid_bound,
                       hidden=128, num_layers=3, freq_degree=6,
                       prop_hidden=32, prop_layers=2, prop_freq_degree=4)
    _, psnrs = _train(cfg, model, scene["images"], scene["poses"],
                      scene["intrinsics"])
    first, last = np.mean(psnrs[:10]), np.mean(psnrs[-10:])
    assert np.isfinite(last)
    assert last > first + 4.0, f"MLP field did not learn: {first:.2f} -> " \
                               f"{last:.2f}"


def test_heldout_psnr_tracks_train(scene):
    """Train on 7 of 8 views with the reference loss weights and the
    distortion ramp: the held-out view's PSNR must track the training
    PSNR (the loss applied from step 0 walls the near plane instead)."""
    cfg = Config(num_steps=(32, 16, 8), num_rays=512, iters=400,
                 lambda_distort=0.02, lambda_distort_warmup=100, bound=4.0,
                 min_near=0.05)
    model = make_field("mlp", device="cpu", grid_bound=cfg.grid_bound,
                       hidden=128, num_layers=3, freq_degree=6,
                       prop_hidden=32, prop_layers=2, prop_freq_degree=4,
                       cp_rank=16, cp_res=64)
    state, psnrs = _train(cfg, model, scene["images"][:7],
                          scene["poses"][:7], scene["intrinsics"])
    train_psnr = float(np.mean(psnrs[-20:]))
    H, W = scene["H"], scene["W"]
    ro, rd = full_frame_rays(scene["poses"][7], scene["intrinsics"], H, W)
    pred = make_eval_render(model, cfg)(ro, rd)["image"].numpy()
    gt = scene["images"][7].reshape(-1, 3).numpy()
    val_psnr = -10.0 * np.log10(np.mean((pred - gt) ** 2))
    assert train_psnr > 15.0, f"train did not converge: {train_psnr:.2f}"
    assert val_psnr > train_psnr - 6.0, (
        f"held-out collapse: train {train_psnr:.2f} vs val {val_psnr:.2f}")
