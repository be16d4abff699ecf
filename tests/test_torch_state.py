"""The port's training state against the JAX package's `train/state.py`:
Adam (eps 1e-15) with the 0.1^(t/iters) decay and the MLP field's per-leaf
lr scales, over several updates from the same (converted) weights and the
same grads; the EMA with its num_updates ramp; checkpoint round trips.

Bar: max abs 2e-6 on the parameters after 6 updates (one Adam update moves
a dense leaf by at most 5e-4 here; the two sides round its fp32 terms in
another order) and rel 1e-6 on the EMA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
from sanerf_hq_tpu.train.state import create_train_state
from sanerf_hq_tpu.train.state import mlp_field_lr_scales as jax_scales
from sanerf_hq_tpu_torch.models import MLPField, params_from_jax
from sanerf_hq_tpu_torch.train.checkpoints import CheckpointManager
from sanerf_hq_tpu_torch.train.state import (TrainState, exp_decay_lr,
                                             mlp_field_lr_scales)

KW = dict(grid_bound=2.0, hidden=32, num_layers=4, freq_degree=3,
          prop_hidden=16, prop_layers=3, prop_freq_degree=2, cp_rank=4,
          cp_res=8)
ITERS = 10


@pytest.fixture(scope="module")
def fields():
    jm = JaxMLPField(**KW)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                     jnp.ones((4, 3)))
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return params, tm


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.1, jnp.float32),
        params)


def test_lr_scales_match_jax(fields):
    params, tm = fields
    want = params_from_jax({k: np.full((1, 1), v) for k, v in _flat(
        jax_scales(params)).items()})
    got = mlp_field_lr_scales(tm)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v == pytest.approx(float(want[k].reshape(-1)[0])), k
    assert got["cp_x"] == 1.0 and got["trunk.w0"] == 0.05


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_adam_schedule_and_scales_match_jax(fields):
    params, tm = fields
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    jstate = create_train_state(params, base_lr=1e-2, total_iters=ITERS,
                                lr_scales=jax_scales(params))
    state = TrainState(tm, 1e-2, ITERS, lr_scales=mlp_field_lr_scales(tm))
    for step in range(6):
        g = _grads(params, step)
        jstate = jstate.apply_gradients(g)
        tg = params_from_jax(jax.device_get(g))
        for name, p in tm.named_parameters():
            p.grad = tg[name].clone()
        assert state.lr() == pytest.approx(exp_decay_lr(1e-2, ITERS, step))
        state.apply_gradients()
    assert state.step == int(jstate.step) == 6
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-6, err_msg=name)
        moved = (p.detach() - params_from_jax(
            jax.device_get(params))[name]).abs().max()
        assert moved > 0, name


def test_ema_ramp_matches_jax(fields):
    params, tm = fields
    jstate = create_train_state(params, 1e-2, ITERS)
    state = TrainState(tm, 1e-2, ITERS)
    for k in range(1, 13):
        g = _grads(params, 100 + k)
        jstate = jstate.replace(params=jax.tree.map(
            lambda p, d: p + d, jstate.params, g))
        jstate = jstate.update_ema()
        with torch.no_grad():
            for name, p in tm.named_parameters():
                p.copy_(params_from_jax(jax.device_get(jstate.params))[name])
        state.update_ema()
    assert state.ema_updates == int(jstate.ema_updates) == 12
    want = params_from_jax(jax.device_get(jstate.ema_params))
    for name, p in state.ema_model.named_parameters():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_checkpoint_round_trip_and_rolling_window(fields, tmp_path):
    params, _ = fields
    tm = MLPField(**KW, device="cpu")
    state = TrainState(tm, 1e-2, ITERS, lr_scales=mlp_field_lr_scales(tm))
    ckpt = CheckpointManager(str(tmp_path), max_keep=2)
    assert ckpt.restore() is None
    for step in (1, 2, 3):
        for p in tm.parameters():
            p.grad = torch.ones_like(p)
        state.apply_gradients()
        state.update_ema()
        ckpt.save(step, state.state_dict())
    ckpt.save(3, state.state_dict(), best=True)
    files = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert files == ["best.pt", "step_00000002.pt", "step_00000003.pt"]

    other = TrainState(MLPField(**KW, device="cpu", seed=5), 1e-2, ITERS,
                       lr_scales=mlp_field_lr_scales(tm))
    other.load_state_dict(ckpt.restore())
    assert (other.step, other.ema_updates) == (3, 3)
    for a, b in zip(other.model.state_dict().values(),
                    tm.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(other.ema_model.state_dict().values(),
                    state.ema_model.state_dict().values()):
        assert torch.equal(a, b)
    # the restored optimizer takes the same next update
    for st in (state, other):
        for p in st.model.parameters():
            p.grad = torch.full_like(p, 0.5)
        st.apply_gradients()
    for a, b in zip(other.model.parameters(), tm.parameters()):
        assert torch.equal(a, b)
