"""K8's two designs (sanerf_hq_tpu_torch/ops/fused_mlp.py) on the CPU: the
rule that picks "narrow" or "wide" from the shape, the wide design's
weight pack and layer plan, and its input kernel's plain version against
the JAX package's block freq encoding.  The kernels themselves are held to
the plain forward on the card by tests/test_torch_kernels_gpu.py and
chip_smoke.py.

The pack must equal `render_level._bf16_padded` of each layer, the layout
the first port's wrapper made per call: bitwise, since both round the same
fp32 values to bf16 once.  The freq rows: within one bf16 ulp of 1 (2^-8)
of JAX's `_freq` in bf16, as the two sides take sin and cos from other
libraries before rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.ops import fused_mlp as j_fm
from sanerf_hq_tpu_torch.ops import fused_mlp as fm
from sanerf_hq_tpu_torch.ops import render_level as rl

# (layers, hidden, nin, kin, output, skip) at the repo's MLP field widths
PROPOSAL = (3, 64, 39, 48, 1, -1)  # 64 x 3, freq degree 6
TRUNK = (4, 256, 63, 64, 16, 2)    # 256 x 4, skip at 2, freq degree 10


def test_design_at_proposal_and_trunk_widths():
    assert fm.narrow_smem_bytes(*PROPOSAL) == 47360
    assert fm.mlp_design(*PROPOSAL) == "narrow"
    assert fm.mlp_design(*TRUNK) == "wide"


@pytest.mark.parametrize("shape,design", [
    ((3, 64, 141, 144, 1, -1), "narrow"),  # the widest input at 64 x 3
    ((3, 64, 147, 160, 1, -1), "wide"),    # the next one
    ((8, 64, 39, 48, 16, 4), "narrow"),    # eight layers at hidden 64
    ((3, 80, 39, 48, 1, -1), "wide"),      # past the registers' 64
    ((2, 16, 3, 16, 1, -1), "narrow"),     # the narrowest two-layer MLP
    ((1, 16, 243, 256, 256, -1), "wide"),  # one layer, 256 wide in and out
    ((1, 16, 39, 48, 256, -1), "narrow"),  # one layer, 256 outputs
])
def test_design_boundary(shape, design):
    """The rule at both sides of its boundary: the narrow kernel's shared
    memory against two CTAs an SM, and the hidden width against 64."""
    smem = fm.narrow_smem_bytes(*shape)
    fits = smem <= fm.NARROW_SMEM_MAX
    assert fm.mlp_design(*shape) == design
    if shape[0] > 1 and shape[1] > fm.NARROW_MAX_HIDDEN:
        assert design == "wide"
    else:
        assert fits == (design == "narrow"), smem


def test_narrow_smem_counts_weights_and_input_rows():
    """The bytes the narrow kernel asks for: each layer [rows rounded up to
    16, cols + 8] bf16 and 8 warps' rows [32, KIN + 8]."""
    L, H, nin, kin, out, skip = 5, 32, 27, 32, 7, 1
    weights = (32 * (32 + 8) + 32 * (32 + 32 + 8) + 2 * 32 * (32 + 8)
               + 16 * (32 + 8))
    assert fm.narrow_smem_bytes(L, H, nin, kin, out, skip) == 2 * (
        weights + 8 * 32 * (kin + 8))


def _ws(shape, seed=0):
    L, H, nin, _, out, skip = shape
    g = torch.Generator().manual_seed(seed)
    ws, fin = [], nin
    for l in range(L):
        fin += nin if l == skip else 0
        fout = out if l == L - 1 else H
        ws.append(torch.randn(fout, fin, generator=g))
        fin = fout
    return ws


@pytest.mark.parametrize("shape", [PROPOSAL, TRUNK, (5, 32, 27, 32, 7, 1),
                                   (2, 48, 15, 16, 20, 1),
                                   (1, 16, 39, 48, 3, -1)])
def test_pack_weights_matches_bf16_padded(shape):
    """The wide design's pack, layer by layer, is the per-layer
    `_bf16_padded` layout: [rows, cols] with the padding columns zero at
    the end of each row; every layer starts 32-byte aligned."""
    L, H, nin, kin, out, skip = shape
    ws = _ws(shape)
    deg = (nin // 3 - 1) // 2
    buf = fm.pack_weights(ws, deg, skip)
    offs = fm.packed_offsets(*shape)
    assert buf.dtype == torch.bfloat16 and buf.shape == (offs[-1],)
    for l, (w, (rows, cin, cols)) in enumerate(
            zip(ws, fm.layer_shapes(*shape))):
        assert offs[l] % 16 == 0 and cols % 16 == 0
        assert w.shape == (rows, cin)
        want = rl._bf16_padded(w, rows, cols)
        assert torch.equal(buf[offs[l]:offs[l + 1]].view(rows, cols), want), l


@pytest.mark.parametrize("L,skip,plan", [
    (4, 2, ["a", "xb", "a"]),            # the trunk: no second buffer
    (5, 1, ["xb", "a", "b", "a"]),
    (3, -1, ["a", "b"]),
    (2, 1, ["xb"]),
    (1, -1, []),
    (8, 7, ["a", "b", "a", "b", "a", "b", "xb"]),
])
def test_wide_plan_never_overwrites_its_input(L, skip, plan):
    """Each hidden layer writes a buffer it does not read: layer 0 reads
    xb's h_in columns and the skip layer all of xb; the layer before the
    skip layer writes xb's first H columns."""
    got = fm.wide_plan(L, skip)
    assert got == plan
    for l, dst in enumerate(got):
        reads = "xb" if l in (0, skip) else got[l - 1]
        assert dst != reads or (l == 0 and dst == "xb"), l
        assert (dst == "xb") == (l + 1 == skip), l


@pytest.mark.parametrize("deg", [1, 6, 10])
def test_freq_input_matches_jax_freq(deg):
    """The plain version of the wide input kernel: [freq(x) | 0] in bf16,
    KIN columns, against JAX's block freq encoding on the same points."""
    x = np.random.default_rng(deg).uniform(-1, 1, (257, 3)).astype(
        np.float32)
    got = fm.freq_input(torch.from_numpy(x), deg)
    nin = 3 * (1 + 2 * deg)
    assert got.dtype == torch.bfloat16
    assert got.shape == (257, rl._round16(nin))
    assert torch.equal(got[:, nin:], torch.zeros_like(got[:, nin:]))
    want = np.asarray(j_fm._freq(jnp.asarray(x), deg, jnp.bfloat16)
                      .astype(jnp.float32))
    assert np.abs(got[:, :nin].float().numpy() - want).max() <= 2.0 ** -8
    assert fm.freq_input.launches == 0


def test_pack_weights_checks_shapes_on_the_cpu():
    """The pack's wrapper refuses what the kernels refuse on every device,
    and launches nothing on the CPU."""
    ws = _ws(PROPOSAL)
    with pytest.raises(ValueError, match="hidden"):
        fm.pack_weights([torch.zeros(40, 39)] + ws[1:], 6)
    with pytest.raises(ValueError, match="skip layer 0"):
        fm.pack_weights(ws, 6, 0)
    assert fm.pack_weights.launches == 0
