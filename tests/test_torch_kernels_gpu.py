"""CUDA kernels K5, K3, K6, K1, K2, K4, K7, K8 and K10 against their plain
twins on the card, and the parts of K2 (partial slabs, their reduction)
and K4 (the stash of the weight products' operands, the weight-grad GEMM)
against their plain parts, at shapes the flagship smoke (chip_smoke.py) does not
reach: ragged ray and point counts, sample counts that do not divide a pass
or span several passes, other widths and layer counts, no CP features;
plus the wrappers' input checks and launch counts, the backward kernels'
run-to-run determinism, K6's agreement with K3 and K7's with K1, and K8's
two designs on both sides of the rule that picks one (bitwise equal over
two launches; no CUDA tensor through the plain forward; a refused launch
raises).

Needs a CUDA device (the kernels have no CPU mode); skips without one.  On
the card, where JAX (which tests/conftest.py imports) is not installed:
`python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py`.
Tolerances as chip_smoke.py: 1e-3 abs on the s-bins of K5 and K1, rel-max
2e-2 on K3's outputs, K1's and K7's weights, K8's outputs and grads and the
weight and CP grads of K2 and K4, rel-max 1e-4 on the weight-grad GEMM
against the fp32 product of the same operands, rel-L2 1e-2 on the
operands K4's first kernel stashes, 1e-6 abs on K10's resampled edges
(rows with ties included).
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
        assert torch.equal(z, x), ("dcp", a)  # chunks summed in order


def test_training_functions_launch_their_kernels(dev):
    """One forward and backward of each autograd Function launches K1 and
    K2, and K3 and K4, once each, and each part of K2 and K4 once."""
    N, T, Q = 256, 32, 17
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(7)
    pws = [_w(dev, g, 64, 39).requires_grad_(), _w(dev, g, 64, 64)
           .requires_grad_(), _w(dev, g, 1, 64).requires_grad_()]
    u = stratified_queries(N, Q, dev).contiguous()
    counted = (rl.fused_prop_level_sample_train, rl.fused_prop_level_bwd,
               rl.fused_final_level, rl.fused_final_level_bwd,
               rl.prop_level_bwd_partials, rl.reduce_partials,
               rl.final_level_bwd_stash, rl.weight_grads)
    counts = [f.launches for f in counted]
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
    assert [f.launches for f in counted] == [c + 1 for c in counts]
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


def _mlp_ws(dev, g, nin, hidden, n_layers, skip, out):
    ws, fin = [], nin
    for l in range(n_layers):
        if l == skip:
            fin += nin
        fout = out if l == n_layers - 1 else hidden
        ws.append(_w(dev, g, fout, fin))
        fin = fout
    return ws


@pytest.mark.parametrize("B,deg,hidden,n_layers,skip,out,design", [
    (1077, 6, 64, 3, -1, 1, "narrow"),   # proposal MLP, ragged last tile
    (4099, 10, 256, 4, 2, 16, "wide"),   # the trunk at cp_rank 0, ragged
    (300, 4, 32, 5, 1, 7, "narrow"),     # five layers, skip at 1, odd output
    (200, 3, 32, 2, 1, 4, "narrow"),     # skip at the last layer
    (129, 2, 16, 1, -1, 3, "narrow"),    # one layer
    (5, 6, 64, 3, -1, 1, "narrow"),      # fewer points than a warp tile
    (33, 6, 64, 3, -1, 1, "narrow"),     # one point past a warp tile
    (1000, 1, 16, 2, -1, 1, "narrow"),   # the narrowest: 9 inputs, 16 wide
    (777, 23, 64, 3, -1, 1, "narrow"),   # the widest input at 64 x 3
    (777, 24, 64, 3, -1, 1, "wide"),     # the next: past two CTAs an SM
    (640, 6, 64, 8, 4, 40, "narrow"),    # eight layers, output over 16
    (555, 6, 80, 3, -1, 1, "wide"),      # past the registers' 64
    (100, 10, 256, 4, 2, 16, "wide"),    # fewer points than a GEMM tile
    (129, 10, 256, 4, 2, 16, "wide"),    # one point past a GEMM tile
    (300, 4, 128, 3, 2, 20, "wide"),     # wide, skip at the last layer
    (260, 5, 96, 5, 1, 7, "wide"),       # wide, both scratch buffers
    (257, 6, 16, 1, -1, 256, "narrow"),  # one layer, 256 outputs
])
def test_freq_mlp_kernel_matches_twin(dev, B, deg, hidden, n_layers, skip,
                                      out, design):
    """K8 against its plain version on both sides of the design rule, and
    two launches on the same inputs bitwise equal."""
    from sanerf_hq_tpu_torch.ops.fused_mlp import (_reference_forward,
                                                   fused_freq_mlp,
                                                   mlp_design)

    g = torch.Generator().manual_seed(9)
    x = (torch.rand(B, 3, generator=g) * 2 - 1).to(dev)
    nin = 3 * (1 + 2 * deg)
    ws = _mlp_ws(dev, g, nin, hidden, n_layers, skip, out)
    assert mlp_design(n_layers, hidden, nin, rl._round16(nin), out,
                      skip) == design
    before = fused_freq_mlp.launches
    got = fused_freq_mlp(x, ws, deg, skip)
    again = fused_freq_mlp(x, ws, deg, skip)
    want = _reference_forward(x, ws, deg, skip)
    torch.cuda.synchronize()
    assert fused_freq_mlp.launches == before + 2
    assert got.shape == (B, out) and torch.isfinite(got).all()
    assert _rel(got, want) < 2e-2, _rel(got, want)
    assert torch.equal(got, again)


def test_freq_mlp_narrow_smem_matches_the_rule(dev):
    """The shared memory the narrow kernel asks for is the sum the
    wrapper's design rule reads."""
    import ctypes

    from sanerf_hq_tpu_torch.ops import cuda_lib
    from sanerf_hq_tpu_torch.ops.fused_mlp import narrow_smem_bytes

    fn = cuda_lib.load("fused_mlp").sanerf_fused_freq_mlp_narrow_smem
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    for L, deg, H, out, skip in ((3, 6, 64, 1, -1), (5, 4, 32, 7, 1),
                                 (1, 6, 16, 256, -1), (8, 23, 64, 16, 4)):
        nin = 3 * (1 + 2 * deg)
        kin = rl._round16(nin)
        assert fn(L, 3, deg, H, kin, out, skip) == narrow_smem_bytes(
            L, H, nin, kin, out, skip)


@pytest.mark.parametrize("deg,hidden,n_layers,skip,out", [
    (6, 64, 3, -1, 1), (10, 256, 4, 2, 16), (4, 32, 5, 1, 7)])
def test_freq_mlp_wide_parts_match_plain(dev, deg, hidden, n_layers, skip,
                                         out):
    """The wide design's first two launches alone: the weight pack bitwise
    equal to its plain version, the freq rows within a bf16 ulp of 1 of
    theirs with zero padding."""
    from sanerf_hq_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator().manual_seed(12)
    nin = 3 * (1 + 2 * deg)
    ws = _mlp_ws(dev, g, nin, hidden, n_layers, skip, out)
    got = fm.pack_weights(ws, deg, skip)
    torch.cuda.synchronize()
    assert torch.equal(got, fm.pack_weights_ref(ws, nin, rl._round16(nin),
                                                skip))
    x = (torch.rand(1031, 3, generator=g) * 2 - 1).to(dev)
    h = fm.freq_input(x, deg, c0=hidden if skip > 0 else 0)
    want = fm.trunk_input(x, deg)
    torch.cuda.synchronize()
    assert h.shape == (1031, rl._round16(nin))
    assert (h[:, :nin].float() - want).abs().max().item() <= 2.0 ** -8
    assert torch.equal(h[:, nin:], torch.zeros_like(h[:, nin:]))


@pytest.mark.parametrize("deg,hidden,n_layers,skip,out", [
    (6, 64, 3, -1, 1), (10, 256, 4, 2, 16)])
def test_freq_mlp_forward_never_runs_the_plain_version(dev, monkeypatch, deg,
                                                       hidden, n_layers, skip,
                                                       out):
    """During the forward no CUDA tensor reaches `_reference_forward`: the
    kernel alone computes it; only the backward runs the plain version."""
    from sanerf_hq_tpu_torch.ops import fused_mlp as fm

    seen = []
    plain = fm._reference_forward

    def spy(x, *a, **k):
        seen.append(x.device.type)
        return plain(x, *a, **k)

    monkeypatch.setattr(fm, "_reference_forward", spy)
    g = torch.Generator().manual_seed(13)
    x = (torch.rand(517, 3, generator=g) * 2 - 1).to(dev)
    ws = [w.requires_grad_() for w in _mlp_ws(dev, g, 3 * (1 + 2 * deg),
                                              hidden, n_layers, skip, out)]
    y = fm.fused_freq_mlp(x, ws, deg, skip)
    torch.cuda.synchronize()
    assert seen == []
    y.sum().backward()
    assert seen == ["cuda"]


def test_freq_mlp_launch_failure_raises(dev, monkeypatch):
    """A launch the library refuses raises and counts nothing: the narrow
    entry refuses a hidden width past 64, and an error code from either
    design's entry reaches the caller as a RuntimeError."""
    import ctypes

    from sanerf_hq_tpu_torch.ops import cuda_lib
    from sanerf_hq_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator().manual_seed(14)
    x = (torch.rand(64, 3, generator=g) * 2 - 1).to(dev)
    out = torch.empty(64, 1, device=dev)
    ws = _mlp_ws(dev, g, 39, 80, 3, -1, 1)
    lib = cuda_lib.load("fused_mlp")
    fn = lib.sanerf_fused_freq_mlp_narrow
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * 3)(*(w.data_ptr() for w in ws))
    rc = fn(x.data_ptr(), out.data_ptr(), ptrs, 3, 64, 3, 6, 80, 48, 1, -1,
            None)
    assert rc != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_lib.check(lib, rc, "fused_freq_mlp")
    real = fm._c_fn
    for hidden in (64, 256):
        ws = _mlp_ws(dev, g, 39, hidden, 3, -1, 1)
        monkeypatch.setattr(fm, "_c_fn", lambda name, argtypes: (
            real(name, argtypes)[0], lambda *a: 1))
        before = fm.fused_freq_mlp.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            fm.fused_freq_mlp(x, ws, 6)
        assert fm.fused_freq_mlp.launches == before
        monkeypatch.setattr(fm, "_c_fn", real)


@pytest.mark.parametrize("deg,hidden,n_layers,skip,out", [
    (6, 64, 3, -1, 1), (10, 256, 4, 2, 16), (4, 32, 5, 1, 20)])
def test_freq_mlp_grads_match_twin_autograd(dev, deg, hidden, n_layers, skip,
                                            out):
    """K8's autograd Function: grads of x and of every weight against
    autograd through the twin, on a [N, T, 3] input as the field gives."""
    from sanerf_hq_tpu_torch.ops.fused_mlp import (_reference_forward,
                                                   fused_freq_mlp)

    g = torch.Generator().manual_seed(10)
    x = (torch.rand(61, 33, 3, generator=g) * 2 - 1).to(dev)
    ws = _mlp_ws(dev, g, 3 * (1 + 2 * deg), hidden, n_layers, skip, out)
    cot = torch.randn(61, 33, out, generator=g).to(dev)
    grads = []
    for fn in (fused_freq_mlp, _reference_forward):
        leaves = [t.clone().requires_grad_() for t in [x] + ws]
        y = fn(leaves[0], leaves[1:], deg, skip)
        assert y.shape == (61, 33, out)
        grads.append(torch.autograd.grad((y * cot).sum(), leaves))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*grads)):
        assert torch.isfinite(a).all(), i
        assert _rel(a, b) < 2e-2, (i, _rel(a, b))


def test_freq_mlp_wrapper_checks_inputs(dev):
    from sanerf_hq_tpu_torch.ops.fused_mlp import fused_freq_mlp

    g = torch.Generator().manual_seed(11)
    x = torch.rand(64, 3, generator=g).to(dev)
    ws = _mlp_ws(dev, g, 39, 64, 3, -1, 1)
    before = fused_freq_mlp.launches
    with pytest.raises(TypeError, match="float32"):
        fused_freq_mlp(x.double(), ws, 6)
    with pytest.raises(ValueError, match="shape"):
        fused_freq_mlp(x, ws, 5)  # the weights are for degree 6
    with pytest.raises(ValueError, match="hidden"):
        fused_freq_mlp(x, _mlp_ws(dev, g, 39, 40, 3, -1, 1), 6)
    with pytest.raises(ValueError, match="layers"):
        fused_freq_mlp(x, _mlp_ws(dev, g, 39, 16, 9, -1, 1), 6)
    with pytest.raises(ValueError, match="skip layer 0"):
        fused_freq_mlp(x, _mlp_ws(dev, g, 39, 64, 3, 0, 1), 6, 0)
    with pytest.raises(ValueError, match="is on cpu"):
        fused_freq_mlp(x, [ws[0].cpu()] + ws[1:], 6)
    assert fused_freq_mlp.launches == before
    assert fused_freq_mlp(x[:0], ws, 6).shape == (0, 1)


@pytest.mark.parametrize("N,T,hidden", [
    (8192, 128, 64),    # the smoke's first proposal level
    (1000, 48, 64),     # T does not divide the pass
    (333, 200, 32),     # one ray over two passes
    (5, 8, 64),         # fewer rays than a CTA holds
])
def test_prop_weights_kernel_matches_twin_and_k1(dev, N, T, hidden):
    """K7 against its twin, its weights bitwise equal to K1's, and
    prop_level_train's grads (forward K7, backward K2) bitwise equal to
    prop_level_train_sample's under the same cotangent."""
    ro, rd, real, s = _rays(dev, N, T)
    g = torch.Generator().manual_seed(12)
    ws = [_w(dev, g, hidden, 39), _w(dev, g, hidden, hidden),
          _w(dev, g, 1, hidden)]
    u = stratified_queries(N, 17, dev).contiguous()
    args = (6, 2.0, True, -0.5)
    before = rl.fused_prop_level.launches
    got = rl.fused_prop_level(ro, rd, real, ws, *args)
    want = rl.prop_level_ref(ro, rd, real, ws, *args)
    k1, _ = rl.fused_prop_level_sample_train(ro, rd, real, s, u, ws, *args)
    torch.cuda.synchronize()
    assert rl.fused_prop_level.launches == before + 1
    assert got.shape == (N, T) and torch.isfinite(got).all()
    assert _rel(got, want) < 2e-2, _rel(got, want)
    assert torch.equal(got, k1)

    cot = torch.randn(N, T, generator=g).to(dev)
    grads = []
    for fn in (lambda p: rl.prop_level_train(ro, rd, real, p, *args),
               lambda p: rl.prop_level_train_sample(ro, rd, real, s, u, p,
                                                    *args)[0]):
        p = [w.clone().requires_grad_() for w in ws]
        grads.append(torch.autograd.grad((fn(p) * cot).sum(), p))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_prop_weights_wrapper_checks_inputs(dev):
    N, T = 64, 8
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(13)
    ws = [_w(dev, g, 64, 39), _w(dev, g, 64, 64), _w(dev, g, 1, 64)]
    before = rl.fused_prop_level.launches
    with pytest.raises(TypeError, match="float32"):
        rl.fused_prop_level(ro, rd.double(), real, ws, 6, 2.0)
    with pytest.raises(ValueError, match="shape"):
        rl.fused_prop_level(ro, rd, real[:, :1].contiguous(), ws, 6, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        rl.fused_prop_level(ro, rd, real.t().contiguous().t(), ws, 6, 2.0)
    with pytest.raises(ValueError, match="3-layer"):
        rl.fused_prop_level(ro, rd, real, ws[:2], 6, 2.0)
    assert rl.fused_prop_level.launches == before


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def _final_case(dev, N, T, hidden, rank, seed):
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(seed)
    nin = 63 + rank
    ws = [_w(dev, g, hidden, nin), _w(dev, g, hidden, hidden),
          _w(dev, g, hidden, hidden + nin), _w(dev, g, 16, hidden)]
    cps = [(torch.randn(64, rank, generator=g) * 0.3).to(dev)
           for _ in range(3)] if rank else []
    sh = torch.randn(N, 16, generator=g).to(dev)
    cots = [torch.randn(*shape, generator=g).to(dev)
            for shape in [(N, 31), (N,), (N,), (N, T)]]
    return (ro, rd, real, sh, ws, *cots, 10, 2, 2.0, True, -0.5, cps, 64)


@pytest.mark.parametrize("N,T,hidden,rank", [
    (333, 8, 256, 64),    # 8 rays a group, N not a multiple of it
    (101, 48, 64, 16),    # one ray a group, 16 idle points
    (65, 128, 256, 64),   # one ray over two passes
    (37, 200, 128, 0),    # one ray over four passes, no CP features
])
def test_final_bwd_stash_matches_plain_part(dev, N, T, hidden, rank):
    """K4's first kernel: the stash's operands against the plain
    final_level_bwd_operands (sliced to the real widths; the padding
    columns zero) and the CP grads against the plain ones.  The operands
    are held by rel-L2 < 1e-2: an activation within a bf16 rounding of 0
    can fall on either side of the relu mask, and then a grad element
    differs by its whole value; their products d^T x are held at rel-max
    2e-2, as the kernels' weight grads."""
    args = _final_case(dev, N, T, hidden, rank, 14)
    pairs, dcps = rl.final_level_bwd_stash(*args)
    want, want_c = rl.final_level_bwd_operands(*args)
    torch.cuda.synchronize()
    nin = 63 + rank
    assert not pairs[0][1][:, nin:].float().abs().any()
    for l, ((d, x), (wd, wx)) in enumerate(zip(pairs, want)):
        d, x = d[:, :wd.shape[1]].float(), x[:, :wx.shape[1]].float()
        assert d.shape == wd.shape and x.shape == wx.shape, l
        assert torch.isfinite(d).all() and torch.isfinite(x).all(), l
        assert _rel_l2(d, wd) < 1e-2, ("d", l, _rel_l2(d, wd))
        assert _rel_l2(x, wx) < 1e-2, ("x", l, _rel_l2(x, wx))
    for a, (x, y) in enumerate(zip(dcps, want_c)):
        assert _rel(x, y) < 2e-2, ("dcp", a, _rel(x, y))


@pytest.mark.parametrize("P,widths", [
    (1000, [(64, 48), (64, 64), (16, 64)]),          # the proposal MLP
    (4133, [(256, 128), (256, 256), (256, 384), (16, 256)]),  # the trunk
    (77, [(32, 16)]),                                  # fewer points than a K tile
    (40961, [(128, 80)]),                              # many splits
])
def test_weight_grads_kernel_matches_plain(dev, P, widths):
    """K4's second kernel against d^T x in fp32 on the same bf16 operands,
    at point counts that are not a multiple of its K tile, with an operand
    that is a column slice of another's rows: rel-max < 1e-4, since both
    sum exact bf16 products in fp32 and differ only in the sums' order (a
    bf16 rounding of dW, or sums in bf16 or tf32, would fail it); bitwise
    equal over two launches."""
    g = torch.Generator().manual_seed(15)
    pairs = []
    for m, n in widths:
        d = torch.randn(P, m, generator=g).to(dev, torch.bfloat16)
        x = torch.randn(P, n + 16, generator=g).to(dev, torch.bfloat16)
        pairs.append((d, x[:, 16:]))
    got = rl.weight_grads(pairs)
    again = rl.weight_grads(pairs)
    want = rl.weight_grads_ref(pairs)
    torch.cuda.synchronize()
    for i, (a, b, c) in enumerate(zip(got, want, again)):
        assert a.shape == b.shape, i
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))
        assert torch.equal(a, c), i
    with pytest.raises(ValueError, match="bf16"):
        rl.weight_grads([(pairs[0][0].float(), pairs[0][1])])


@pytest.mark.parametrize("N,T,hidden", [
    (333, 8, 64),     # 16 rays a group, N not a multiple of it
    (1001, 48, 64),   # two rays a group, 32 idle points
    (4099, 128, 64),  # flagship shape, ragged
    (97, 200, 64),    # one ray over two passes
    (300, 128, 256),  # dW too wide for registers: the slab path
])
def test_prop_bwd_parts_match_plain(dev, N, T, hidden):
    """K2's two kernels: the partial slabs' sum against the twin, and the
    reduction in CTA order against part.sum(0)."""
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(16)
    ws = [_w(dev, g, hidden, 39), _w(dev, g, hidden, hidden),
          _w(dev, g, 1, hidden)]
    g_w = torch.randn(N, T, generator=g).to(dev)
    args = (ro, rd, real, ws, g_w, 6, 2.0, True, -0.5)
    part = rl.prop_level_bwd_partials(*args)
    want = rl.prop_level_bwd_ref(*args)
    red = rl.reduce_partials(part)
    torch.cuda.synchronize()
    H, kin = hidden, 48
    assert part.shape[0] >= 1 and part.shape[1] == H * kin + H * H + 16 * H
    d0, d1, d2 = part.sum(0).split([H * kin, H * H, 16 * H])
    for i, (a, b) in enumerate(zip(
            (d0.view(H, kin)[:, :39], d1.view(H, H), d2.view(16, H)[:1]),
            want)):
        assert _rel(a, b) < 2e-2, (i, _rel(a, b))
    assert _rel(red, part.sum(0)) < 1e-5
    assert torch.equal(red, rl.reduce_partials(part))


def _final_weights_bf16(ws, kin):
    """The trunk's weights as K3's products take them: bf16 [out, in],
    w0 and w2's h_in block padded to KIN columns."""
    nin = ws[0].shape[1]
    H = ws[1].shape[0]
    w0 = torch.zeros(H, kin, device=ws[0].device)
    w0[:, :nin] = ws[0]
    w2 = torch.zeros(H, H + kin, device=ws[0].device)
    w2[:, :H + nin] = ws[2]
    return [w.to(torch.bfloat16).contiguous() for w in (w0, ws[1], w2, ws[3])]


@pytest.mark.parametrize("N,T,hidden,rank", [
    (1000, 24, 64, 0),     # no CP features, T not a multiple of 32
    (333, 160, 256, 64),   # flagship widths, five compositing rounds
    (777, 32, 128, 16),
    (5, 8, 32, 4),         # fewer points than a product's tile
    (6256, 32, 256, 64),   # the stage-3 batch at flagship widths
])
def test_final_level_parts_match_plain(dev, N, T, hidden, rank):
    """K3's three kernels, each against its plain part on the same inputs:
    the trunk's input (h_in rel-max 2e-2 with its padding columns zero, xn
    1e-5 abs), the four layer products on the plain part's bf16 operands
    (relu layers rel-max 2e-2, a bf16 rounding; the fp32 last layer 1e-4,
    the sums' order), and the compositing on the plain trunk's output
    (rel-max 2e-2; geo its copy, bit for bit)."""
    ro, rd, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(17)
    nin = 63 + rank
    kin = (nin + 15) // 16 * 16
    ws = [_w(dev, g, hidden, nin), _w(dev, g, hidden, hidden),
          _w(dev, g, hidden, hidden + nin), _w(dev, g, 16, hidden)]
    cps = [(torch.randn(64, rank, generator=g) * 0.3).to(dev)
           for _ in range(3)] if rank else []
    sh = torch.randn(N, 16, generator=g).to(dev)
    counters = (rl.final_level_inputs, rl.layer_product, rl.final_composite)
    before = [c.launches for c in counters]

    h_in, xn = rl.final_level_inputs(ro, rd, real, 10, 2.0, cps, 64,
                                     hidden=hidden)
    want_h, want_xn = rl.final_level_inputs_ref(ro, rd, real, 10, 2.0, cps,
                                                64)
    torch.cuda.synchronize()
    assert h_in.shape == (N * T, kin) and h_in.dtype == torch.bfloat16
    assert not h_in[:, nin:].float().abs().any()
    assert _rel(h_in[:, :nin].float(), want_h) < 2e-2
    assert (xn - want_xn).abs().max().item() <= 1e-5

    # the products on the plain part's operands, h_in as a column slice of
    # the [A2 | h_in] rows, as K3 reads it
    w0, w1, w2, w3 = _final_weights_bf16(ws, kin)
    xb = torch.zeros(N * T, hidden + kin, device=dev, dtype=torch.bfloat16)
    xb[:, hidden:hidden + nin] = want_h.to(torch.bfloat16)
    a1 = rl.layer_product(xb[:, hidden:], w0)
    xb[:, :hidden] = rl.layer_product_ref(a1, w1).to(torch.bfloat16)
    layers = [(xb[:, hidden:], w0, True), (a1, w1, True), (xb, w2, True),
              (rl.layer_product_ref(xb, w2).to(torch.bfloat16), w3, False)]
    for l, (x, w, relu) in enumerate(layers):
        got = rl.layer_product(x, w, relu)
        want = rl.layer_product_ref(x, w, relu)
        torch.cuda.synchronize()
        assert got.dtype == (torch.bfloat16 if relu else torch.float32), l
        assert torch.isfinite(got.float()).all(), l
        assert _rel(got.float(), want) < (2e-2 if relu else 1e-4), (
            l, _rel(got.float(), want))

    f = rl.layer_product_ref(layers[3][0], w3, relu=False)
    out = rl.final_composite(f, real, sh, True, -0.5, need_geo=True)
    ref = rl.final_composite_ref(f, real, sh, True, -0.5, need_geo=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("f_image", "depth", "wsum", "weights"), out, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) < 2e-2, (name, _rel(a, b))
    assert torch.equal(out[4], ref[4])
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 5,
                                              before[2] + 1]


@pytest.mark.parametrize("N,T", [(13, 1), (13, 31), (300, 33), (61, 77),
                                 (9, 200)])
def test_final_composite_matches_plain_at_any_t(dev, N, T):
    """K3's compositing at sample counts that are not a multiple of 32 (a
    warp a ray, rounds of 32 carried in order; N not a multiple of a CTA's
    8 warps) with densities across the clip at (-30, 15): rel-max 2e-2
    against the plain part; with geo, the other four outputs bitwise equal
    to those without it (K6 against K3)."""
    _, _, real, _ = _rays(dev, N, T)
    g = torch.Generator().manual_seed(18)
    f = (torch.randn(N * T, 16, generator=g) * 4).to(dev)
    f[::7, 0] = 40.0  # clipped above
    f[::5, 0] = -50.0  # clipped below
    sh = torch.randn(N, 16, generator=g).to(dev)
    for opaque_last in (True, False):
        k3 = rl.final_composite(f, real, sh, opaque_last, 0.3)
        k6 = rl.final_composite(f, real, sh, opaque_last, 0.3, need_geo=True)
        ref = rl.final_composite_ref(f, real, sh, opaque_last, 0.3)
        torch.cuda.synchronize()
        assert k3[4] is None and k6[4].shape == (N, T, 15)
        assert torch.equal(k6[4], f.view(N, T, 16)[..., 1:])
        for name, a, b, c in zip(("f_image", "depth", "wsum", "weights"),
                                 k3, ref, k6):
            assert torch.isfinite(a).all(), name
            assert _rel(a, b) < 2e-2, (name, opaque_last, _rel(a, b))
            assert torch.equal(a, c), name


@pytest.mark.parametrize("N,T,Q,hidden", [
    (8192, 128, 65, 64),   # the training batch's first proposal level
    (8192, 64, 33, 256),   # wide layers: weights through L1/L2
])
def test_prop_kernel_walks_several_groups(dev, N, T, Q, hidden):
    """K1 and K5 on a grid of fewer CTAs than ray groups, so that a CTA
    walks several groups (with the weights in shared memory at hidden 64,
    through L1/L2 at 256): K1 against its twin (weights rel-max 2e-2,
    bins 1e-3 abs), its bins K5's bit for bit."""
    grid, groups = rl._prop_launch_shape(N, T, Q, hidden, 48)
    assert groups > grid >= 1, (grid, groups)
    ro, rd, real, s = _rays(dev, N, T, seed=3)
    g = torch.Generator().manual_seed(19)
    ws = [_w(dev, g, hidden, 39), _w(dev, g, hidden, hidden),
          _w(dev, g, 1, hidden)]
    u = stratified_queries(N, Q, dev, torch.Generator(dev).manual_seed(2))
    args = (ro, rd, real, s, u.contiguous(), ws, 6, 2.0, True, -0.5)
    w, nb = rl.fused_prop_level_sample_train(*args)
    w_ref, nb_ref = rl.prop_level_train_sample_ref(*args)
    nb5 = rl.fused_prop_level_sample(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(w).all() and torch.isfinite(nb).all()
    assert _rel(w, w_ref) < 2e-2
    assert (nb - nb_ref).abs().max().item() <= 1e-3
    assert torch.equal(nb, nb5)


def test_final_level_part_wrappers_check_inputs(dev):
    """The part wrappers raise, and launch nothing, on operands of the
    wrong type or layout."""
    g = torch.Generator().manual_seed(20)
    x = torch.randn(300, 64, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(32, 64, generator=g).to(dev, torch.bfloat16)
    f = torch.randn(40 * 8, 16, generator=g).to(dev)
    _, _, real, _ = _rays(dev, 40, 8)
    sh = torch.randn(40, 16, generator=g).to(dev)
    counters = (rl.layer_product, rl.final_composite)
    before = [c.launches for c in counters]
    with pytest.raises(TypeError, match="bfloat16"):
        rl.layer_product(x.float(), w)
    with pytest.raises(TypeError, match="bfloat16"):
        rl.layer_product(x, w.float())
    with pytest.raises(ValueError, match="contiguous"):
        rl.layer_product(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="row stride"):
        rl.layer_product(torch.zeros(300, 68, device=dev,
                                     dtype=torch.bfloat16)[:, 4:], w)
    with pytest.raises(ValueError, match="shape"):
        rl.layer_product(x[:, :40], w[:, :40])  # k not a multiple of 16
    with pytest.raises(TypeError, match="float32"):
        rl.final_composite(f.double(), real, sh)
    with pytest.raises(ValueError, match="contiguous"):
        rl.final_composite(f.t().contiguous().t(), real, sh)
    with pytest.raises(ValueError, match="shape"):
        rl.final_composite(f[:-1], real, sh)
    assert [c.launches for c in counters] == before
