"""CUDA kernels K5, K3, K6, K1, K2, K4 and K10 against their plain twins on
the card, at shapes the flagship smoke (chip_smoke.py) does not reach: ragged
ray counts, sample counts that do not divide a pass or span several passes,
other widths, no CP features; plus the wrappers' input checks, the
backward kernels' run-to-run determinism, and K6's agreement with K3.

Needs a CUDA device (the kernels have no CPU mode); skips without one.  On
the card, where JAX (which tests/conftest.py imports) is not installed:
`python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py`.
Tolerances as chip_smoke.py: 1e-3 abs on the s-bins of K5 and K1, rel-max
2e-2 on K3's outputs, K1's weights and the weight and CP grads of K2 and K4,
1e-6 abs on K10's resampled edges (rows with ties included).
"""
import pytest
import torch

from sanerf_hq_tpu_torch.ops import render_level as rl
from sanerf_hq_tpu_torch.ops.ray import stratified_queries

pytestmark = pytest.mark.gpu


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 twins stay fp32
    return torch.device("cuda")


def _rays(dev, N, T, seed=0):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(N, 3, generator=g) * 0.5
    rd = torch.randn(N, 3, generator=g)
    real = torch.sort(torch.rand(N, T + 1, generator=g) * 6 + 0.2).values
    s = torch.sort(torch.rand(N, T + 1, generator=g)).values
    return [x.to(dev).contiguous() for x in (ro, rd, real, s)]


def _w(dev, g, *shape):
    return (torch.randn(*shape, generator=g) / shape[1] ** 0.5).to(dev)


@pytest.mark.parametrize("N,T,Q,hidden", [
    (1000, 48, 33, 64),   # 2 rays a CTA, 32 idle points
    (333, 200, 17, 64),   # one ray over two passes
    (5, 8, 9, 32),        # fewer rays than a CTA holds
    (4099, 128, 65, 64),  # flagship shape, ragged last CTA
])
def test_prop_kernel_matches_twin(dev, N, T, Q, hidden):
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(1)
    ws = [_w(dev, g, hidden, 39), _w(dev, g, hidden, hidden),
          _w(dev, g, 1, hidden)]
    u = stratified_queries(N, Q, dev, torch.Generator(dev).manual_seed(2))
    u = u.contiguous()
    args = (ro, rd, real, s, u, ws, 6, 2.0, True, -0.5)
    got = rl.fused_prop_level_sample(*args)
    want = rl.prop_level_sample_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("N,T,hidden,rank", [
    (1000, 24, 64, 0),     # 5 rays a CTA, no CP features
    (333, 160, 256, 64),   # one ray over two passes, flagship widths
    (777, 32, 128, 16),
])
def test_final_kernel_matches_twin(dev, N, T, hidden, rank):
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(3)
    nin = 63 + rank
    ws = [_w(dev, g, hidden, nin), _w(dev, g, hidden, hidden),
          _w(dev, g, hidden, hidden + nin), _w(dev, g, 16, hidden)]
    cps = [(torch.randn(64, rank, generator=g) * 0.3).to(dev)
           for _ in range(3)] if rank else []
    sh = torch.randn(N, 16, generator=g).to(dev)
    args = (ro, rd, real, sh, ws, 10, 2, 2.0, True, -0.5, cps, 64)
    got = rl.fused_final_level(*args)
    want = rl.final_level_ref(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("f_image", "depth", "wsum", "weights"), got, want):
        assert torch.isfinite(a).all(), name
        rel = ((a - b).abs().max() / b.abs().max()).item()
        assert rel < 2e-2, (name, rel)


@pytest.mark.parametrize("N,T,hidden,rank,need_geo", [
    (1000, 24, 64, 0, True),     # 5 rays a CTA, no CP, ragged last CTA
    (333, 160, 256, 64, True),   # one ray over two passes, flagship widths
    (777, 48, 128, 16, False),   # T does not divide the pass
    (5, 8, 32, 4, True),         # fewer rays than a CTA holds
    (6256, 32, 256, 64, True),   # the stage-3 batch at flagship widths
])
def test_frozen_final_kernel_matches_twin_and_k3(dev, N, T, hidden, rank,
                                                 need_geo):
    """K6 against its twin (rel-max 2e-2, geo included), and its four K3
    outputs equal to K3's bit for bit."""
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(8)
    nin = 63 + rank
    ws = [_w(dev, g, hidden, nin), _w(dev, g, hidden, hidden),
          _w(dev, g, hidden, hidden + nin), _w(dev, g, 16, hidden)]
    cps = [(torch.randn(64, rank, generator=g) * 0.3).to(dev)
           for _ in range(3)] if rank else []
    sh = torch.randn(N, 16, generator=g).to(dev)
    args = (ro, rd, real, sh, ws, 10, 2, 2.0, True, -0.5, cps, 64)
    before = rl.fused_final_level_frozen.launches
    got = rl.fused_final_level_frozen(*args, need_geo=need_geo)
    want = rl.final_level_frozen_ref(*args, need_geo=need_geo)
    k3 = rl.fused_final_level(*args)
    torch.cuda.synchronize()
    assert rl.fused_final_level_frozen.launches == before + 1
    for name, a, b, c in zip(("f_image", "depth", "wsum", "weights"), got,
                             want, k3):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) < 2e-2, (name, _rel(a, b))
        assert torch.equal(a, c), name
    if need_geo:
        assert got[4].shape == (N, T, 15)
        assert torch.isfinite(got[4]).all()
        assert _rel(got[4], want[4]) < 2e-2, _rel(got[4], want[4])
    else:
        assert got[4] is None


def test_wrappers_check_inputs_and_count_launches(dev):
    N, T, Q = 64, 8, 9
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(4)
    ws = [_w(dev, g, 64, 39), _w(dev, g, 64, 64), _w(dev, g, 1, 64)]
    u = stratified_queries(N, Q, dev).contiguous()
    before = rl.fused_prop_level_sample.launches
    rl.fused_prop_level_sample(ro, rd, real, s, u, ws, 6, 2.0)
    assert rl.fused_prop_level_sample.launches == before + 1
    with pytest.raises(TypeError, match="float32"):
        rl.fused_prop_level_sample(ro.double(), rd, real, s, u, ws, 6, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        rl.fused_prop_level_sample(ro, rd, real, s, u.t().contiguous().t(),
                                   ws, 6, 2.0)
    with pytest.raises(ValueError, match="shape"):
        rl.fused_prop_level_sample(ro, rd, real, s[:, :-1].contiguous(), u,
                                   ws, 6, 2.0)
    with pytest.raises(ValueError, match="is on cpu"):
        rl.fused_prop_level_sample(ro, rd, real, s.cpu(), u, ws, 6, 2.0)
    assert rl.fused_prop_level_sample.launches == before + 1


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


@pytest.mark.parametrize("N,T,Q,hidden", [
    (1000, 48, 33, 64),   # T does not divide the pass
    (333, 200, 17, 64),   # one ray over two passes
    (5, 8, 9, 32),        # fewer rays than a CTA holds
    (4099, 128, 65, 64),  # flagship shape, ragged last CTA
    (300, 32, 17, 256),
])
def test_prop_train_kernels_match_twins(dev, N, T, Q, hidden):
    """K1 (weights + bins; the bins are K5's bit for bit) and K2."""
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(5)
    ws = [_w(dev, g, hidden, 39), _w(dev, g, hidden, hidden),
          _w(dev, g, 1, hidden)]
    u = stratified_queries(N, Q, dev, torch.Generator(dev).manual_seed(2))
    u = u.contiguous()
    args = (ro, rd, real, s, u, ws, 6, 2.0, True, -0.5)
    w, nb = rl.fused_prop_level_sample_train(*args)
    w_ref, nb_ref = rl.prop_level_train_sample_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(w).all() and torch.isfinite(nb).all()
    assert _rel(w, w_ref) < 2e-2
    assert (nb - nb_ref).abs().max().item() <= 1e-3
    assert torch.equal(nb, rl.fused_prop_level_sample(*args))

    g_w = torch.randn(N, T, generator=g).to(dev)
    bargs = (ro, rd, real, ws, g_w, 6, 2.0, True, -0.5)
    got = rl.fused_prop_level_bwd(*bargs)
    again = rl.fused_prop_level_bwd(*bargs)
    want = rl.prop_level_bwd_ref(*bargs)
    torch.cuda.synchronize()
    for i, (a, b, c) in enumerate(zip(got, want, again)):
        assert a.shape == b.shape, i
        assert torch.isfinite(a).all(), i
        assert _rel(a, b) < 2e-2, (i, _rel(a, b))
        assert torch.equal(a, c), i  # fixed-order reduction


@pytest.mark.parametrize("N,T,hidden,rank", [
    (1000, 24, 64, 0),     # no CP features, T does not divide the pass
    (333, 160, 256, 64),   # one ray over three passes, flagship widths
    (777, 32, 128, 16),
    (2049, 32, 256, 64),   # flagship shape, ragged last group
])
def test_final_bwd_kernel_matches_twin(dev, N, T, hidden, rank):
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(6)
    nin = 63 + rank
    ws = [_w(dev, g, hidden, nin), _w(dev, g, hidden, hidden),
          _w(dev, g, hidden, hidden + nin), _w(dev, g, 16, hidden)]
    cps = [(torch.randn(64, rank, generator=g) * 0.3).to(dev)
           for _ in range(3)] if rank else []
    sh = torch.randn(N, 16, generator=g).to(dev)
    cots = [torch.randn(*shape, generator=g).to(dev)
            for shape in [(N, 31), (N,), (N,), (N, T)]]
    args = (ro, rd, real, sh, ws, *cots, 10, 2, 2.0, True, -0.5, cps, 64)
    dws, dcps = rl.fused_final_level_bwd(*args)
    dws2, dcps2 = rl.fused_final_level_bwd(*args)
    want_w, want_c = rl.final_level_bwd_ref(*args)
    torch.cuda.synchronize()
    assert len(dcps) == len(cps)
    for i, (a, b, c) in enumerate(zip(dws, want_w, dws2)):
        assert a.shape == b.shape, i
        assert torch.isfinite(a).all(), i
        assert _rel(a, b) < 2e-2, (i, _rel(a, b))
        assert torch.equal(a, c), i  # fixed-order reduction
    for a, (x, y, z) in enumerate(zip(dcps, want_c, dcps2)):
        assert torch.isfinite(x).all(), a
        assert _rel(x, y) < 2e-2, ("dcp", a, _rel(x, y))
        assert _rel(z, x) < 1e-4, ("dcp atomics", a)


def test_training_functions_launch_their_kernels(dev):
    """One forward and backward of each autograd Function launches K1 and
    K2, and K3 and K4, once each."""
    N, T, Q = 256, 32, 17
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(7)
    pws = [_w(dev, g, 64, 39).requires_grad_(), _w(dev, g, 64, 64)
           .requires_grad_(), _w(dev, g, 1, 64).requires_grad_()]
    u = stratified_queries(N, Q, dev).contiguous()
    counts = [f.launches for f in (rl.fused_prop_level_sample_train,
                                   rl.fused_prop_level_bwd,
                                   rl.fused_final_level,
                                   rl.fused_final_level_bwd)]
    w, _ = rl.prop_level_train_sample(ro, rd, real, s, u, pws, 6, 2.0)
    w.square().sum().backward()
    tws = [_w(dev, g, 64, 67), _w(dev, g, 64, 64), _w(dev, g, 64, 131),
           _w(dev, g, 16, 64)]
    tws = [x.requires_grad_() for x in tws]
    cps = [(torch.randn(16, 4, generator=g) * 0.3).to(dev).requires_grad_()
           for _ in range(3)]
    sh = torch.randn(N, 16, generator=g).to(dev)
    out = rl.final_level_train(ro, rd, real, sh, tws, 10, 2, 2.0, cps=cps,
                               cp_res=16)
    sum(o.square().sum() for o in out).backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (rl.fused_prop_level_sample_train,
                                 rl.fused_prop_level_bwd,
                                 rl.fused_final_level,
                                 rl.fused_final_level_bwd)] == [
        c + 1 for c in counts]
    for p in pws + tws + cps:
        assert p.grad is not None and torch.isfinite(p.grad).all()


def _pdf_rows(dev, N, K, Q, seed=0):
    """cdf, bins [N, K] non-decreasing with ties (flat cdf runs, tails
    clamped to 1, zero-width bins) and jittered stratified u [N, Q]."""
    g = torch.Generator().manual_seed(seed)
    w = torch.rand(N, K - 1, generator=g)
    w[torch.rand(N, K - 1, generator=g) < 0.3] = 0.0
    cdf = torch.cumsum(w, -1)
    cdf = cdf / cdf[:, -1:].clamp_min(1e-12)
    cdf[: N // 2] *= 1.05  # overshoots, clamped to 1
    cdf = torch.cat([torch.zeros(N, 1), cdf.clamp_max(1.0)], -1)
    widths = torch.rand(N, K - 1, generator=g)
    widths[torch.rand(N, K - 1, generator=g) < 0.2] = 0.0
    bins = torch.cat([torch.zeros(N, 1), torch.cumsum(widths, -1)], -1)
    bins = bins / bins[:, -1:].clamp_min(1e-12)
    u = (torch.arange(Q) + 0.5) / Q + (torch.rand(N, Q, generator=g) - 0.5) / Q
    return [x.to(dev).contiguous() for x in (cdf, bins, u)]


@pytest.mark.parametrize("N,K,Q", [
    (16384, 129, 65),  # render chunk, first resampling
    (8192, 65, 33),    # training batch, second resampling
    (1001, 17, 9),     # ragged last block
    (3, 2, 5),         # one-interval rows
])
def test_sample_pdf_kernel_matches_plain(dev, N, K, Q):
    from sanerf_hq_tpu_torch.ops.sample_pdf import (sample_pdf_lookup,
                                                    sample_pdf_lookup_ref)

    cdf, bins, u = _pdf_rows(dev, N, K, Q)
    before = sample_pdf_lookup.launches
    got = sample_pdf_lookup(cdf, bins, u)
    want = sample_pdf_lookup_ref(cdf, bins, u)
    torch.cuda.synchronize()
    assert sample_pdf_lookup.launches == before + 1
    assert got.shape == (N, Q) and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-6


def test_sample_pdf_wrapper_checks_inputs(dev):
    from sanerf_hq_tpu_torch.ops.sample_pdf import sample_pdf_lookup

    cdf, bins, u = _pdf_rows(dev, 64, 9, 5)
    with pytest.raises(ValueError, match="contiguous"):
        sample_pdf_lookup(cdf, bins, u.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        sample_pdf_lookup(cdf, bins.double(), u)
    with pytest.raises(ValueError, match="shape"):
        sample_pdf_lookup(cdf, bins[:, :-1].contiguous(), u)
    assert sample_pdf_lookup(cdf[:0], bins[:0], u[:0]).shape == (0, 5)
