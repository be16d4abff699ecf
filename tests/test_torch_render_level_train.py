"""Training twins of the port's render-level kernels against the JAX Pallas
training kernels and their custom VJPs, run in interpret mode on the CPU
(as tests/test_render_level_kernels.py runs them): K1
`prop_level_train_sample`, K2 its backward, K7 `fused_prop_level` and
`prop_level_train` (forward K7, backward K2) with the field methods that
reach them, K4 the backward of `final_level_train` with and without CP
features; the port's autograd Functions against the twins; and autograd
through the forward twins as a second oracle.  The CUDA kernels are held
to these twins on the card by chip_smoke.py and
tests/test_torch_kernels_gpu.py.

Tolerances: rel-max 2e-2 on weight and CP grads, the JAX package's own bar
for its kernels against their references
(tests/test_render_level_kernels.py:114,128); 5e-3 abs on the resampled
s-bins (:198); K1's and K7's weights rel-max 1e-5 against the JAX proposal
level's weights without resampling (:219).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.ops.render_level_pallas as rlp
from sanerf_hq_tpu_torch.ops import render_level as rl

N, T, Q = 128, 8, 9
GRID_BOUND, DB = 2.0, -1.5
DEG_P, DEG_F = 6, 4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(rlp, "INTERPRET", True)
    for name in ("R_TILE", "R_TILE_BWD", "R_TILE_BWD_FINAL"):
        monkeypatch.setattr(rlp, name, N)
    monkeypatch.setattr(rlp, "R_TILE_TRAIN", 2 * N)  # CP halves it to N


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture()
def rays():
    rng = np.random.default_rng(0)
    ro = rng.normal(size=(N, 3)) * 2
    rd = rng.normal(size=(N, 3))
    bins = np.sort(rng.uniform(0.2, 4.0, (N, T + 1)), axis=1)
    s_bins = np.sort(rng.uniform(0.0, 1.0, (N, T + 1)), axis=1)
    u = np.linspace(0.5 / Q, 1.0 - 0.5 / Q, Q)[None] + rng.uniform(
        -0.4 / Q, 0.4 / Q, (N, Q))
    sh = rng.normal(size=(N, 16))
    return [np.asarray(a, np.float32) for a in (ro, rd, bins, s_bins, u, sh)]


def _prop_ws(seed, hidden=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * 0.3
            for s in [(3 + 6 * DEG_P, hidden), (hidden, hidden), (hidden, 1)]]


def _final_params(seed, rank, res=16, hidden=32):
    rng = np.random.default_rng(seed)
    nin = 3 + 6 * DEG_F + rank
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in [(nin, hidden), (hidden, hidden), (hidden + nin, hidden),
                    (hidden, 16)]]
    cps = [rng.normal(size=(res, rank)).astype(np.float32) * 0.3
           for _ in range(3)] if rank else []
    return ws, cps


def _final_cotangents(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in [(N, 31), (N,), (N,), (N, T)]]


def test_prop_train_sample_twin_matches_pallas(rays):
    ro, rd, bins, s_bins, u, _ = rays
    ws = _prop_ws(1)
    static = (DEG_P, GRID_BOUND, True, DB)
    w_j, nb_j = rlp.prop_level_train_sample(
        static, *(jnp.asarray(a) for a in (ro, rd, bins, s_bins, u)),
        *(jnp.asarray(w) for w in ws))
    args = [_t(a) for a in (ro, rd, bins, s_bins, u)]
    tws = [_t(w).T.contiguous() for w in ws]
    w, nb = rl.fused_prop_level_sample_train(*args, tws, DEG_P, GRID_BOUND,
                                             True, DB)
    assert w.shape == (N, T) and nb.shape == (N, Q)
    assert _rel(w, w_j) < 1e-5
    assert np.abs(nb.numpy() - np.asarray(nb_j)).max() < 5e-3
    # K1 is K5 with its weights stored: the same bins, and raw weights
    # equal to the proposal level's weights without the 0.01 floor
    assert torch.equal(nb, rl.fused_prop_level_sample(
        *args, tws, DEG_P, GRID_BOUND, True, DB))
    w_k7 = rlp.fused_prop_level(*(jnp.asarray(a) for a in (ro, rd, bins)),
                                [jnp.asarray(x) for x in ws], DEG_P,
                                GRID_BOUND, opaque_last=True, density_bias=DB)
    assert _rel(w, w_k7) < 1e-5
    assert float(w.min()) >= 0.0 and float(w.sum(-1).max()) <= 1.0 + 1e-5


def test_prop_weights_twin_matches_pallas(rays):
    """K7's twin against the JAX fused_prop_level, and equal to K1's twin's
    weights bit for bit (one loop, shared)."""
    ro, rd, bins, s_bins, u, _ = rays
    ws = _prop_ws(14)
    w_j = rlp.fused_prop_level(*(jnp.asarray(a) for a in (ro, rd, bins)),
                               [jnp.asarray(x) for x in ws], DEG_P,
                               GRID_BOUND, opaque_last=True, density_bias=DB)
    args = [_t(a) for a in (ro, rd, bins)]
    tws = [_t(w).T.contiguous() for w in ws]
    before = rl.fused_prop_level.launches
    w = rl.fused_prop_level(*args, tws, DEG_P, GRID_BOUND, True, DB)
    assert rl.fused_prop_level.launches == before  # the twin on the CPU
    assert w.shape == (N, T)
    assert _rel(w, w_j) < 1e-5
    w1, _ = rl.prop_level_train_sample_ref(*args, _t(s_bins), _t(u), tws,
                                           DEG_P, GRID_BOUND, True, DB)
    assert torch.equal(w, w1)


@pytest.mark.parametrize("opaque_last", [True, False])
def test_prop_level_train_matches_pallas_vjp(rays, opaque_last):
    """prop_level_train (forward K7, backward K2) against the JAX
    prop_level_train and its custom VJP; its grads are the K2 twin's bit for
    bit, and none reaches the rays."""
    ro, rd, bins, _, _, _ = rays
    ws = _prop_ws(15)
    g_w = np.random.default_rng(16).normal(size=(N, T)).astype(np.float32)
    static = (DEG_P, GRID_BOUND, opaque_last, DB)
    jin = [jnp.asarray(a) for a in (ro, rd, bins)]
    w_j, vjp = jax.vjp(lambda *p: rlp.prop_level_train(static, *jin, *p),
                       *(jnp.asarray(w) for w in ws))
    want = vjp(jnp.asarray(g_w))
    ro_t = _t(ro).requires_grad_(True)
    tws = [_t(w).T.contiguous().requires_grad_(True) for w in ws]
    w = rl.prop_level_train(ro_t, _t(rd), _t(bins), tws, *static)
    assert _rel(w.detach(), w_j) < 1e-5
    (w * _t(g_w)).sum().backward()
    assert ro_t.grad is None
    twin = rl.prop_level_bwd_ref(_t(ro), _t(rd), _t(bins), tws, _t(g_w),
                                 *static)
    for i, (p, b, d) in enumerate(zip(tws, want, twin)):
        assert p.grad.shape == b.T.shape, i
        assert _rel(p.grad, np.asarray(b).T) < 2e-2, f"dW{i}"
        assert torch.equal(p.grad, d), i


@pytest.mark.parametrize("proposal", [0, 1])
def test_field_prop_weight_methods_match_jax(rays, proposal):
    """MLPField.fused_prop_weights (K7) and fused_prop_weights_train (K7,
    backward K2) against the JAX field's methods, converted weights."""
    from sanerf_hq_tpu.models.mlp_field import MLPField as JaxMLPField
    from sanerf_hq_tpu_torch.models import MLPField, params_from_jax

    kw = dict(grid_bound=GRID_BOUND, hidden=32, num_layers=4,
              freq_degree=DEG_F, prop_hidden=32, prop_layers=3,
              prop_freq_degree=DEG_P, cp_rank=4, cp_res=16, density_bias=DB)
    jm = JaxMLPField(**kw)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((4, 3)), jnp.ones((4, 3))))
    tm = MLPField(**kw, device="cpu")
    tm.load_state_dict(params_from_jax(params))
    ro, rd, bins = rays[:3]
    jin = [jnp.asarray(a) for a in (ro, rd, bins)]
    tin = [_t(a) for a in (ro, rd, bins)]
    g_w = np.random.default_rng(17).normal(size=(N, T)).astype(np.float32)
    want = jm.apply(params, *jin, proposal,
                    method=JaxMLPField.fused_prop_weights)
    got = tm.fused_prop_weights(*tin, proposal)
    assert _rel(got.detach(), want) < 1e-5

    name = f"prop_mlp_{proposal}"
    j_grads = jax.grad(lambda p: jnp.sum(jm.apply(
        p, *jin, proposal, method=JaxMLPField.fused_prop_weights_train)
        * g_w))(params)["params"][name]
    w = tm.fused_prop_weights_train(*tin, proposal)
    assert _rel(w.detach(), want) < 1e-5
    mlp = getattr(tm, name)
    grads = torch.autograd.grad((w * _t(g_w)).sum(), mlp.weights)
    for l, g in enumerate(grads):
        assert _rel(g, np.asarray(j_grads[f"w{l}"]).T) < 2e-2, f"w{l}"


@pytest.mark.parametrize("hidden", [32, 64])
def test_prop_bwd_twin_matches_pallas_vjp(rays, hidden):
    ro, rd, bins, s_bins, u, _ = rays
    ws = _prop_ws(2, hidden)
    g_w = np.random.default_rng(3).normal(size=(N, T)).astype(np.float32)
    static = (DEG_P, GRID_BOUND, True, DB)
    jin = [jnp.asarray(a) for a in (ro, rd, bins, s_bins, u)]
    (w_j, nb_j), vjp = jax.vjp(
        lambda *p: rlp.prop_level_train_sample(static, *jin, *p),
        *(jnp.asarray(w) for w in ws))
    want = vjp((jnp.asarray(g_w), jnp.zeros_like(nb_j)))
    got = rl.prop_level_bwd_ref(_t(ro), _t(rd), _t(bins),
                                [_t(w).T.contiguous() for w in ws], _t(g_w),
                                DEG_P, GRID_BOUND, True, DB)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.T.shape, i
        assert _rel(a, np.asarray(b).T) < 2e-2, f"dW{i}"


@pytest.mark.parametrize("rank", [0, 4])
def test_final_bwd_twin_matches_pallas_vjp(rays, rank):
    ro, rd, bins, _, _, sh = rays
    res = 16
    ws, cps = _final_params(4, rank, res)
    cots = _final_cotangents(5)
    static = (DEG_F, 2, GRID_BOUND, True, DB, rank, res)
    jin = [jnp.asarray(a) for a in (ro, rd, bins, sh)]
    _, vjp = jax.vjp(lambda *p: rlp.final_level_train(static, *jin, *p),
                     *(jnp.asarray(x) for x in ws + cps))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    dws, dcps = rl.final_level_bwd_ref(
        _t(ro), _t(rd), _t(bins), _t(sh), [_t(w).T.contiguous() for w in ws],
        *(_t(c) for c in cots), DEG_F, 2, GRID_BOUND, True, DB,
        [_t(c) for c in cps], res)
    assert len(dcps) == len(cps)
    for i, (a, b) in enumerate(zip(dws, want[:4])):
        assert a.shape == b.T.shape, i
        assert _rel(a, np.asarray(b).T) < 2e-2, f"dW{i}"
    for a, (g, b) in enumerate(zip(dcps, want[4:])):
        assert g.shape == b.shape
        assert _rel(g, b) < 2e-2, f"dcp{a}"


def test_autograd_functions_run_the_twins_on_cpu(rays):
    """prop_level_train_sample and final_level_train: forward and backward
    are exactly the twins on CPU tensors; rays, bins, u and sh get no grad."""
    ro, rd, bins, s_bins, u, sh = (_t(a) for a in rays)
    ro.requires_grad_(True)
    pws = [_t(w).T.contiguous().requires_grad_(True) for w in _prop_ws(6)]
    g = torch.from_numpy(np.random.default_rng(7).normal(
        size=(N, T)).astype(np.float32))
    w, nb = rl.prop_level_train_sample(ro, rd, bins, s_bins, u, pws, DEG_P,
                                       GRID_BOUND, True, DB)
    assert not nb.requires_grad
    (w * g).sum().backward()
    want = rl.prop_level_bwd_ref(ro.detach(), rd, bins, pws, g, DEG_P,
                                 GRID_BOUND, True, DB)
    for p, d in zip(pws, want):
        assert torch.equal(p.grad, d)
    assert ro.grad is None

    ws, cps = _final_params(8, 4)
    tws = [_t(x).T.contiguous().requires_grad_(True) for x in ws]
    tcps = [_t(c).requires_grad_(True) for c in cps]
    outs = rl.final_level_train(ro, rd, bins, sh, tws, DEG_F, 2, GRID_BOUND,
                                True, DB, tcps, 16)
    ref = rl.final_level_ref(ro.detach(), rd, bins, sh, tws, DEG_F, 2,
                             GRID_BOUND, True, DB, tcps, 16)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b.detach())
    cots = [_t(c) for c in _final_cotangents(9)]
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    dws, dcps = rl.final_level_bwd_ref(ro.detach(), rd, bins, sh, tws, *cots,
                                       DEG_F, 2, GRID_BOUND, True, DB, tcps,
                                       16)
    for p, d in zip(tws + tcps, dws + dcps):
        assert torch.equal(p.grad, d)
    assert ro.grad is None


def test_bwd_twins_match_autograd_of_forward_twins(rays):
    """Second oracle: autograd through the forward twins (fp32 cotangents,
    clamp-gated density grad) against the closed-form backward twins."""
    ro, rd, bins, s_bins, u, sh = (_t(a) for a in rays)
    pws = [_t(w).T.contiguous().requires_grad_(True) for w in _prop_ws(10)]
    g = _t(np.random.default_rng(11).normal(size=(N, T)))
    w, _ = rl.prop_level_train_sample_ref(ro, rd, bins, s_bins, u, pws,
                                          DEG_P, GRID_BOUND, True, DB)
    auto = torch.autograd.grad((w * g).sum(), pws)
    got = rl.prop_level_bwd_ref(ro, rd, bins, pws, g, DEG_P, GRID_BOUND,
                                True, DB)
    for i, (a, b) in enumerate(zip(got, auto)):
        assert _rel(a.detach(), b) < 2e-2, f"prop dW{i}"

    ws, cps = _final_params(12, 4)
    tws = [_t(x).T.contiguous().requires_grad_(True) for x in ws]
    tcps = [_t(c).requires_grad_(True) for c in cps]
    cots = [_t(c) for c in _final_cotangents(13)]
    outs = rl.final_level_ref(ro, rd, bins, sh, tws, DEG_F, 2, GRID_BOUND,
                              True, DB, tcps, 16)
    auto = torch.autograd.grad(sum((o * c).sum() for o, c in
                                   zip(outs, cots)), tws + tcps)
    dws, dcps = rl.final_level_bwd_ref(ro, rd, bins, sh, tws, *cots, DEG_F,
                                       2, GRID_BOUND, True, DB, tcps, 16)
    for i, (a, b) in enumerate(zip(dws + dcps, auto)):
        assert _rel(a.detach(), b) < 2e-2, f"final grad {i}"


def test_bwd_twins_on_rays_that_miss_the_box():
    """near = far = 1e9 for a miss: every interval is zero and all weight
    sits on the opaque last sample; the grads stay finite."""
    from sanerf_hq_tpu_torch.ops.ray import spacing_fn, spacing_fn_inv

    n = 4
    ro = torch.full((n, 3), 500.0)
    rd = torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1)
    s = spacing_fn(torch.full((n, 1), 1e9))
    s_bins = torch.linspace(0, 1, T + 1).expand(n, T + 1).contiguous()
    real = spacing_fn_inv(s * (1 - s_bins) + s * s_bins)
    g = torch.Generator().manual_seed(0)
    pws = [torch.randn(64, 39, generator=g), torch.randn(64, 64, generator=g),
           torch.randn(1, 64, generator=g)]
    for d in rl.fused_prop_level_bwd(ro, rd, real, pws,
                                     torch.randn(n, T, generator=g), 6, 2.0):
        assert torch.isfinite(d).all()
    tws = [torch.randn(32, 67, generator=g), torch.randn(32, 32, generator=g),
           torch.randn(32, 99, generator=g), torch.randn(16, 32, generator=g)]
    cps = [torch.randn(8, 4, generator=g) for _ in range(3)]
    dws, dcps = rl.fused_final_level_bwd(
        ro, rd, real, torch.randn(n, 16, generator=g), tws,
        torch.randn(n, 31, generator=g), torch.randn(n, generator=g),
        torch.randn(n, generator=g), torch.randn(n, T, generator=g), 10, 2,
        2.0, cps=cps, cp_res=8)
    for d in dws + dcps:
        assert torch.isfinite(d).all()


def test_bwd_wrappers_dispatch_only_cpu_tensors_to_twins():
    n = 4
    ro, rd = torch.zeros(n, 3), torch.ones(n, 3)
    bins = torch.linspace(0.2, 2.0, T + 1).expand(n, T + 1).contiguous()
    pws = [torch.zeros(64, 39), torch.zeros(64, 64), torch.zeros(1, 64)]
    before = (rl.fused_prop_level_bwd.launches,
              rl.fused_final_level_bwd.launches,
              rl.fused_prop_level_sample_train.launches)
    rl.fused_prop_level_bwd(ro, rd, bins, pws, torch.ones(n, T), 6, 2.0)
    rl.fused_prop_level_sample_train(ro, rd, bins, bins,
                                     torch.full((n, Q), 0.5), pws, 6, 2.0)
    tws = [torch.zeros(32, 63), torch.zeros(32, 32), torch.zeros(32, 95),
           torch.zeros(16, 32)]
    rl.fused_final_level_bwd(ro, rd, bins, torch.zeros(n, 16), tws,
                             torch.ones(n, 31), torch.ones(n), torch.ones(n),
                             torch.ones(n, T), 10, 2, 2.0)
    assert (rl.fused_prop_level_bwd.launches,
            rl.fused_final_level_bwd.launches,
            rl.fused_prop_level_sample_train.launches) == before
    meta = [x.to("meta") for x in (ro, rd, bins)]
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_prop_level_bwd(*meta, pws, torch.ones(n, T, device="meta"),
                                6, 2.0)
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_prop_level_sample_train(*meta, meta[2],
                                         torch.ones(n, Q, device="meta"),
                                         pws, 6, 2.0)
    with pytest.raises(ValueError, match="unsupported device"):
        rl.fused_final_level_bwd(*meta, torch.zeros(n, 16, device="meta"),
                                 tws, *(torch.ones(s, device="meta") for s in
                                        [(n, 31), (n,), (n,), (n, T)]),
                                 10, 2, 2.0)


def _trunk_bwd_unsplit(dh, ws, inputs, skip_layer, extra_rows):
    """The trunk backward as one function, as the twins computed it before
    they were split at the weight products: dW_l = d^T x_l formed in the
    loop."""
    d = rl.bf16_round(dh)
    dws, d_extra, n_in0 = [None] * len(ws), None, inputs[0].shape[1]
    for l in range(len(ws) - 1, -1, -1):
        dws[l] = d.t() @ inputs[l]
        if l == 0:
            if extra_rows:
                de = d @ rl.bf16_round(ws[0])[:, -extra_rows:]
                d_extra = de if d_extra is None else d_extra + de
            break
        da, act = d @ rl.bf16_round(ws[l]), inputs[l]
        if l == skip_layer:
            rows = act.shape[1] - n_in0
            if extra_rows:
                de = da[:, rows + n_in0 - extra_rows:]
                d_extra = de if d_extra is None else d_extra + de
            da, act = da[:, :rows], act[:, :rows]
        d = rl.bf16_round(torch.where(act > 0, da, 0.0))
    return dws, d_extra


@pytest.mark.parametrize("skip_layer,extra_rows", [(-1, 0), (2, 4)])
def test_split_trunk_bwd_reproduces_the_unsplit_one(skip_layer, extra_rows):
    """The operands half of the trunk backward, then d^T x, gives the
    unsplit trunk backward's weight grads and extra-row grad bit for bit."""
    rng = np.random.default_rng(20)
    M, nin, hidden = 96, 27 + extra_rows, 32
    if skip_layer < 0:
        shapes = [(hidden, nin), (hidden, hidden), (1, hidden)]
    else:
        shapes = [(hidden, nin), (hidden, hidden), (hidden, hidden + nin),
                  (16, hidden)]
    ws = [_t(rng.normal(size=s) * 0.3) for s in shapes]
    h_in = rl.bf16_round(_t(rng.normal(size=(M, nin))))
    _, inputs = rl.trunk_with_inputs(h_in, ws, skip_layer)
    dh = _t(rng.normal(size=(M, shapes[-1][0])))
    pairs, d_extra = rl._trunk_bwd_operands(dh, ws, inputs, skip_layer,
                                            extra_rows)
    want, want_extra = _trunk_bwd_unsplit(dh, ws, inputs, skip_layer,
                                          extra_rows)
    for got, w in zip(rl.weight_grads_ref(pairs), want):
        assert torch.equal(got, w)
    if extra_rows:
        assert torch.equal(d_extra, want_extra)
    for d, x in pairs:  # both operands hold bf16 values
        assert torch.equal(d, rl.bf16_round(d))
        assert torch.equal(x, rl.bf16_round(x))


@pytest.mark.parametrize("hidden", [32, 64])
def test_prop_bwd_operands_match_pallas_vjp(rays, hidden):
    """K2's plain first part: one (d, x) pair a layer over the N*T points;
    their products are the twin's grads bit for bit and match the Pallas
    VJP."""
    ro, rd, bins, s_bins, u, _ = rays
    ws = _prop_ws(21, hidden)
    g_w = np.random.default_rng(22).normal(size=(N, T)).astype(np.float32)
    static = (DEG_P, GRID_BOUND, True, DB)
    jin = [jnp.asarray(a) for a in (ro, rd, bins, s_bins, u)]
    (_, nb_j), vjp = jax.vjp(
        lambda *p: rlp.prop_level_train_sample(static, *jin, *p),
        *(jnp.asarray(w) for w in ws))
    want = vjp((jnp.asarray(g_w), jnp.zeros_like(nb_j)))
    args = (_t(ro), _t(rd), _t(bins), [_t(w).T.contiguous() for w in ws],
            _t(g_w), *static)
    pairs = rl.prop_level_bwd_operands(*args)
    assert [(d.shape, x.shape) for d, x in pairs] == [
        ((N * T, hidden), (N * T, 3 + 6 * DEG_P)),
        ((N * T, hidden), (N * T, hidden)), ((N * T, 1), (N * T, hidden))]
    dws = rl.weight_grads_ref(pairs)
    for i, (a, b, c) in enumerate(zip(dws, rl.prop_level_bwd_ref(*args),
                                      want)):
        assert torch.equal(a, b), i
        assert _rel(a, np.asarray(c).T) < 2e-2, f"dW{i}"


@pytest.mark.parametrize("rank", [0, 4])
def test_final_bwd_operands_match_pallas_vjp(rays, rank):
    """K4's plain first part: the (d, x) pairs and the CP grads; the
    products are the twin's grads bit for bit and match the Pallas VJP;
    x2 is [A2 | h_in] and x0 is h_in, the same rows."""
    ro, rd, bins, _, _, sh = rays
    res = 16
    ws, cps = _final_params(23, rank, res)
    cots = _final_cotangents(24)
    static = (DEG_F, 2, GRID_BOUND, True, DB, rank, res)
    jin = [jnp.asarray(a) for a in (ro, rd, bins, sh)]
    _, vjp = jax.vjp(lambda *p: rlp.final_level_train(static, *jin, *p),
                     *(jnp.asarray(x) for x in ws + cps))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    args = (_t(ro), _t(rd), _t(bins), _t(sh),
            [_t(w).T.contiguous() for w in ws], *(_t(c) for c in cots),
            DEG_F, 2, GRID_BOUND, True, DB, [_t(c) for c in cps], res)
    pairs, dcps = rl.final_level_bwd_operands(*args)
    nin, hidden = 3 + 6 * DEG_F + rank, 32
    assert [(d.shape[1], x.shape[1]) for d, x in pairs] == [
        (hidden, nin), (hidden, hidden), (hidden, hidden + nin), (16, hidden)]
    assert torch.equal(pairs[2][1][:, hidden:], pairs[0][1])
    ref_w, ref_c = rl.final_level_bwd_ref(*args)
    for i, (a, b, c) in enumerate(zip(rl.weight_grads_ref(pairs), ref_w,
                                      want[:4])):
        assert torch.equal(a, b), i
        assert _rel(a, np.asarray(c).T) < 2e-2, f"dW{i}"
    for a, (g, b, c) in enumerate(zip(dcps, ref_c, want[4:])):
        assert torch.equal(g, b)
        assert _rel(g, c) < 2e-2, f"dcp{a}"


def test_bwd_part_wrappers_run_the_plain_parts_on_cpu(rays):
    """On CPU tensors each part of K2 and K4 is its plain version, and no
    kernel launch is counted."""
    ro, rd, bins, _, _, sh = (_t(a) for a in rays)
    counters = (rl.prop_level_bwd_partials, rl.reduce_partials,
                rl.final_level_bwd_stash, rl.weight_grads)
    before = [f.launches for f in counters]
    pws = [_t(w).T.contiguous() for w in _prop_ws(25)]
    g = _t(np.random.default_rng(26).normal(size=(N, T)))
    args = (ro, rd, bins, pws, g, DEG_P, GRID_BOUND, True, DB)
    part = rl.prop_level_bwd_partials(*args)
    want = rl.prop_level_bwd_ref(*args)
    kin = 48
    assert part.shape == (1, 64 * kin + 64 * 64 + 16 * 64)
    d0, d1, d2 = rl.reduce_partials(part).split([64 * kin, 64 * 64, 16 * 64])
    assert torch.equal(d0.view(64, kin)[:, :39], want[0])
    assert not d0.view(64, kin)[:, 39:].any()
    assert torch.equal(d1.view(64, 64), want[1])
    assert torch.equal(d2.view(16, 64)[:1], want[2])
    assert not d2.view(16, 64)[1:].any()

    ws, cps = _final_params(27, 4)
    fargs = (ro, rd, bins, sh, [_t(x).T.contiguous() for x in ws],
             *(_t(c) for c in _final_cotangents(28)), DEG_F, 2, GRID_BOUND,
             True, DB, [_t(c) for c in cps], 16)
    pairs, dcps = rl.final_level_bwd_stash(*fargs)
    w_pairs, w_dcps = rl.final_level_bwd_operands(*fargs)
    for (d, x), (wd, wx) in zip(pairs, w_pairs):
        assert torch.equal(d, wd) and torch.equal(x, wx)
    dws = rl.weight_grads(pairs)
    ref_w, ref_c = rl.fused_final_level_bwd(*fargs)
    for a, b in zip(dws + dcps, ref_w + ref_c):
        assert torch.equal(a, b)
    assert [f.launches for f in counters] == before
