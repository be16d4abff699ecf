"""convert_jax_ckpt.py: a JAX workspace's orbax checkpoint to the port.

A tiny JAX hash-grid field trains 3 steps (the grads of its render's MSE
on a ray batch applied by the JAX package's TrainState, the EMA updated
after each) and is saved with the JAX package's CheckpointManager, as its
trainer saves it; the converter
writes `params` (and with --ema `ema_params`) as a flat .npz; the port's
`load_init_params` (the CLI's --init_ckpt) reads it into the port's field,
whose render equals JAX's render of the same weights (max abs 1e-3, the
port's render bar), and --ema gives the EMA weights' render.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_ckpt
from sanerf_hq_tpu.data import make_synthetic_dataset, sample_rgb_batch
from sanerf_hq_tpu.models import SANeRFField as JaxField
from sanerf_hq_tpu.ops import HashGridSpec as JaxSpec
from sanerf_hq_tpu.render import renderer as jr
from sanerf_hq_tpu.train.checkpoints import CheckpointManager
from sanerf_hq_tpu.train.state import create_train_state
from sanerf_hq_tpu_torch.cli import load_init_params
from sanerf_hq_tpu_torch.models import SANeRFField
from sanerf_hq_tpu_torch.ops.hashgrid import HashGridSpec
from sanerf_hq_tpu_torch.render import renderer as tr

MAIN = dict(num_levels=4, level_dim=2, base_resolution=16,
            log2_hashmap_size=12, desired_resolution=64)
PROP = dict(num_levels=3, level_dim=2, base_resolution=16,
            log2_hashmap_size=11, desired_resolution=32)
STEPS = dict(num_steps=(16, 8, 4), bound=4.0, min_near=0.05)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = str(tmp_path_factory.mktemp("jax_ws"))
    jm = JaxField(grid_bound=2.0, main_spec=JaxSpec(**MAIN),
                  prop_spec_0=JaxSpec(**PROP), prop_spec_1=JaxSpec(**PROP))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                              jnp.ones((4, 3)))
    state = create_train_state(params, base_lr=1e-2, total_iters=100)
    scene = make_synthetic_dataset(n_views=2, H=16, W=16)
    settings = jr.RenderSettings(**STEPS, training=True)

    @jax.jit
    def grads(p, batch):
        def loss(p_):
            out = jm.apply(p_, batch["rays_o"], batch["rays_d"], settings,
                           method=lambda m, o, d, s: jr.render_rays(m, o, d,
                                                                    s))
            return jnp.mean((out["image"] - batch["gt_rgb"]) ** 2)
        return jax.grad(loss)(p)

    update = jax.jit(lambda st, g: st.apply_gradients(g).update_ema())
    key = jax.random.PRNGKey(3)
    for _ in range(3):
        key, kb = jax.random.split(key)
        b = sample_rgb_batch(kb, jnp.asarray(scene["images"]),
                             jnp.asarray(scene["poses"]),
                             jnp.asarray(scene["intrinsics"]), 64)
        state = update(state, grads(state.params, b))
    CheckpointManager(ws).save(3, {
        "step": state.step, "params": state.params,
        "opt_state": state.opt_state, "ema_params": state.ema_params,
        "ema_updates": state.ema_updates})
    return ws, jm, jax.device_get(state.params), \
        jax.device_get(state.ema_params)


def _rays():
    rng = np.random.default_rng(0)
    ro = (rng.normal(size=(96, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(96, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema_params"])
def test_converted_checkpoint_renders_as_jax(workspace, tmp_path, ema):
    ws, jm, params, ema_params = workspace
    out = str(tmp_path / "field.npz")
    argv = [ws, out] + (["--ema"] if ema else [])
    assert convert_jax_ckpt.main(argv) == 0
    state = load_init_params(out)
    tm = SANeRFField(grid_bound=2.0, device="cpu",
                     main_spec=HashGridSpec(**MAIN),
                     prop_spec_0=HashGridSpec(**PROP),
                     prop_spec_1=HashGridSpec(**PROP))
    tm.load_state_dict(state)  # strict: every tensor of the field
    want_params = ema_params if ema else params
    grid = np.asarray(want_params["params"]["grid"])
    np.testing.assert_array_equal(state["grid"].numpy(), grid)
    other = np.asarray((params if ema else ema_params)["params"]["grid"])
    assert not np.array_equal(grid, other)  # 3 steps moved the EMA apart
    ro, rd = _rays()
    want = jax.jit(lambda p: jm.apply(
        p, jnp.asarray(ro), jnp.asarray(rd), jr.RenderSettings(**STEPS),
        method=lambda m, o, d, s: jr.render_rays(m, o, d, s)))(want_params)
    with torch.inference_mode():
        got = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                             tr.RenderSettings(**STEPS))
    for k in ("image", "depth", "weights_sum"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-3, err_msg=k)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        convert_jax_ckpt.main([str(tmp_path), str(tmp_path / "x.npz")])
    assert not os.path.exists(tmp_path / "x.npz")
