"""The port's renderer against the JAX renderer with the same (converted)
field weights, on the CPU: the composable route, the level-kernel route
(plain twins here) against the JAX fused route run in Pallas interpret mode
(as tests/test_renderer_fused.py runs it), and chunked render_staged.

Bar: max abs < 2e-2 on image, depth and weights_sum, the JAX package's own
bar between its fused and composable routes.
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
from sanerf_hq_tpu_torch.render import renderer as tr

N = 128
KW = dict(grid_bound=2.0, hidden=64, num_layers=2, freq_degree=4,
          prop_hidden=32, prop_layers=2, prop_freq_degree=3, cp_rank=4,
          cp_res=16)
STEPS = dict(num_steps=(8, 8, 8), bound=4.0, min_near=0.05)
KEYS = ("image", "depth", "weights_sum")


@pytest.fixture(scope="module")
def setup():
    jm = JaxMLPField(**KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((4, 3)),
                              jnp.ones((4, 3)))
    tm = MLPField(**KW, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    rng = np.random.default_rng(0)
    ro = (rng.normal(size=(N, 3)) * 0.5).astype(np.float32)
    rd = rng.normal(size=(N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return jm, params, tm, ro, rd


def _jax_render(jm, params, ro, rd, settings, staged=False, jit=True):
    """jit compiles the composable route in one go; the interpret-mode
    Pallas kernels run eagerly (XLA:CPU has no jitted bf16 x bf16 dot)."""
    fn = jr.render_staged if staged else jr.render_rays

    def run(p, o, d):
        return jm.apply(p, o, d, settings,
                        method=lambda m, o_, d_, s: fn(m, o_, d_, s))

    return (jax.jit(run) if jit else run)(params, jnp.asarray(ro),
                                          jnp.asarray(rd))


def _compare(got, want):
    for k in KEYS:
        a, b = got[k].detach().numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        assert np.isfinite(a).all(), k
        err = np.abs(a - b).max()
        assert err < 2e-2, f"{k}: max abs {err}"


def test_composable_route_matches_jax(setup):
    jm, params, tm, ro, rd = setup
    want = _jax_render(jm, params, ro, rd, jr.RenderSettings(**STEPS))
    got = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**STEPS, level_kernels=False))
    _compare(got, want)


def test_level_kernel_route_matches_jax_fused(setup, monkeypatch):
    jm, params, tm, ro, rd = setup
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    monkeypatch.setattr(rlp, "INTERPRET", True)
    monkeypatch.setattr(rlp, "R_TILE", N)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it to N
    want = _jax_render(jm, params, ro, rd, jr.RenderSettings(**STEPS),
                       jit=False)
    got = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                         tr.RenderSettings(**STEPS))
    _compare(got, want)


def test_level_kernel_route_matches_composable(setup):
    """What chip_smoke.py checks on the card, here with the plain twins."""
    _, _, tm, ro, rd = setup
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    a = tr.render_rays(tm, o, d, tr.RenderSettings(**STEPS))
    b = tr.render_rays(tm, o, d, tr.RenderSettings(**STEPS,
                                                   level_kernels=False))
    for k in KEYS:
        assert (a[k] - b[k]).abs().max() < 2e-2, k


def test_render_staged_matches_jax(setup):
    """Ragged chunks (128 rays in chunks of 48) against the JAX staged
    render on the composable route."""
    jm, params, tm, ro, rd = setup
    want = _jax_render(jm, params, ro, rd,
                       jr.RenderSettings(**STEPS, max_ray_batch=48),
                       staged=True)
    got = tr.render_staged(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                           tr.RenderSettings(**STEPS, max_ray_batch=48,
                                             level_kernels=False))
    _compare(got, want)
    whole = tr.render_rays(tm, torch.from_numpy(ro), torch.from_numpy(rd),
                           tr.RenderSettings(**STEPS, level_kernels=False))
    for k in KEYS:
        assert torch.allclose(got[k], whole[k], atol=1e-6), k


def test_perturbed_render_is_seeded(setup):
    _, _, tm, ro, rd = setup
    s = tr.RenderSettings(**STEPS, perturb=True)
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    a = tr.render_rays(tm, o, d, s, generator=torch.Generator().manual_seed(1))
    b = tr.render_rays(tm, o, d, s, generator=torch.Generator().manual_seed(1))
    c = tr.render_rays(tm, o, d, s)  # no generator: deterministic samples
    det = tr.render_rays(tm, o, d, tr.RenderSettings(**STEPS))
    assert torch.equal(a["depth"], b["depth"])
    assert not torch.equal(a["depth"], det["depth"])
    assert torch.equal(c["depth"], det["depth"])


def test_training_render_not_ported(setup):
    """The training render is ported (tests/test_torch_train.py holds it to
    JAX): it returns the final weights, the point count and both losses,
    and the proposal loss is 0 without the proposal update.  The JAX
    renderer's traced update_proposal, once the one part not ported, is
    taken too: a 0-d bool tensor gives the bool form's proposal loss
    (tests/test_torch_encoding.py holds its grads)."""
    _, _, tm, ro, rd = setup
    o, d = torch.from_numpy(ro), torch.from_numpy(rd)
    s = tr.RenderSettings(**STEPS, training=True, compute_losses=True)
    out = tr.render_rays(tm, o, d, s)
    assert out["weights"].shape == (N, STEPS["num_steps"][-1])
    assert out["num_points"] == N * STEPS["num_steps"][-1]
    assert out["proposal_loss"].item() > 0 and out["distort_loss"].item() > 0
    off = tr.render_rays(tm, o, d, s, update_proposal=False)
    assert off["proposal_loss"].item() == 0.0
    on = tr.render_rays(tm, o, d, s, update_proposal=torch.tensor(True))
    assert torch.equal(on["proposal_loss"], out["proposal_loss"])
    traced_off = tr.render_rays(tm, o, d, s,
                                update_proposal=torch.tensor(False))
    assert traced_off["proposal_loss"].item() == 0.0
