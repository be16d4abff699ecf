"""The port's SAM (sanerf_hq_tpu_torch.sam) against the JAX package's on
shared inputs and weights.  One random state_dict in the released
checkpoints' layout goes through the JAX package's convert_state_dict
into the flax modules and straight into the port's load_state_dict.

Configuration: the tiny one of tests/test_sam_parity.py (embed 32, depth
2, heads 2, img 64, window 3 over the 4x4 grid, so the windowed block pads
to 6x6, global block 1), the 256-wide prompt encoder and decoders.

Tolerances, fp32 on both sides: max abs <= 1e-4 on the encoder's features
and interm, the prompt embeddings, the two-way transformer and the
decoders' logits and IoU (flax LayerNorm's one-pass variance against
torch's two-pass and a different summation order are the only
differences); the predictor's upscaled logits the same, and its masks
(logits > 0) differ in at most 0.5% of the pixels; the resizes behind
set_image and set_features are held bitwise or at 1e-5 in
test_torch_sam_resize.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sanerf_hq_tpu.sam.build as jax_build
import sanerf_hq_tpu_torch.sam.build as port_build
from sanerf_hq_tpu.sam.image_encoder import window_partition as jax_partition
from sanerf_hq_tpu.sam.predictor import SamPredictor as JaxPredictor
from sanerf_hq_tpu.sam.transformer import TwoWayTransformer as JaxTwoWay
from sanerf_hq_tpu.sam.weights import convert_state_dict
from sanerf_hq_tpu_torch.sam import SamPredictor, build_sam
from sanerf_hq_tpu_torch.sam.image_encoder import (window_partition,
                                                   window_unpartition)
from sanerf_hq_tpu_torch.sam.weights import (load_sam_checkpoint,
                                             sam_params_from_jax)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,),
            window_size=3)
IMG = 64
ATOL = 1e-4
MASK_MISMATCH = 5e-3


def random_state_dict(model, seed=0):
    """Random weights at realistic scales for every key of the model's
    state_dict (the released checkpoints' keys and shapes), as numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("bias") or k.endswith(("rel_pos_h", "rel_pos_w")):
            a = 0.1 * rng.normal(size=shape)
        elif len(shape) == 1:
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif k.endswith("pos_embed"):
            a = 0.1 * rng.normal(size=shape)
        elif "output_upscaling" in k or "compress_vit_feat" in k or \
                "embedding_encoder" in k:
            a = rng.normal(size=shape) / np.sqrt(shape[0] * shape[2] *
                                                 shape[3])
        elif len(shape) >= 2 and not k.endswith(("_token.weight",
                                                 "tokens.weight",
                                                 "embed.weight",
                                                 "gaussian_matrix")) \
                and "point_embeddings" not in k:
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        else:
            a = rng.normal(size=shape)
        sd[k] = a.astype(np.float32)
    return sd


def _build_pair(hq):
    port_build._CONFIGS["vit_tiny"] = lambda: dict(TINY)
    jax_build._CONFIGS["vit_tiny"] = lambda: dict(TINY)
    try:
        port = build_sam("vit_tiny", hq=hq, img_size=IMG, device="cpu")
        jsam = jax_build.build_sam("vit_tiny", hq=hq, img_size=IMG,
                                   init_params=False)
    finally:
        del port_build._CONFIGS["vit_tiny"], jax_build._CONFIGS["vit_tiny"]
    sd = random_state_dict(port, seed=1 + hq)
    port.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                         strict=True)
    jsam.params = convert_state_dict(sd, jsam.encoder, hq=hq)
    return port, jsam, sd


@pytest.fixture(scope="module", params=[False, True], ids=["sam", "sam_hq"])
def pair(request):
    return _build_pair(request.param)


@pytest.fixture(scope="module")
def plain_pair():
    return _build_pair(False)


@pytest.fixture(scope="module")
def hq_pair():
    return _build_pair(True)


def _close(got, want, atol=ATOL, what=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= atol, f"{what}: max abs {err}"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_jax_params_round_trip_exactly(pair):
    port, jsam, sd = pair
    back = sam_params_from_jax(jsam.params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_checkpoint_file_loads_strict(pair, tmp_path):
    port, _, sd = pair
    path = str(tmp_path / "sam.pth")
    torch.save({"model": {k: torch.as_tensor(v) for k, v in sd.items()}},
               path)
    loaded = load_sam_checkpoint(path)
    assert sorted(loaded) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(loaded[k], v), k


@pytest.mark.parametrize("model_type", ["vit_b", "vit_l", "vit_h"])
@pytest.mark.parametrize("hq", [False, True], ids=["sam", "sam_hq"])
def test_state_dict_keys_equal_released_manifests(model_type, hq):
    """The port's state_dict keys are exactly the released checkpoint's
    (tests/fixtures/sam_keys_*.txt); built on the meta device, so ViT-H
    costs no memory."""
    name = f"sam_keys_{'hq_' if hq else ''}{model_type}.txt"
    with open(os.path.join(FIXTURES, name)) as f:
        manifest = [l.strip() for l in f if l.strip()]
    model = build_sam(model_type, hq=hq, device="meta")
    keys = list(model.state_dict())
    assert len(keys) == len(manifest) == len(set(keys))
    assert sorted(keys) == sorted(manifest)


def test_window_partition_pads_like_jax():
    x = np.random.default_rng(0).normal(size=(2, 4, 5, 3)).astype(np.float32)
    got, pad_hw = window_partition(_t(x), 3)
    want, want_hw = jax_partition(jnp.asarray(x), 3)
    assert pad_hw == want_hw == (6, 6)
    _close(got, want, 0.0, "windows")
    back = window_unpartition(got, 3, pad_hw, (4, 5))
    np.testing.assert_array_equal(back.numpy(), x)


def test_image_encoder_with_interm(pair):
    port, jsam, _ = pair
    x = np.random.default_rng(3).normal(size=(1, IMG, IMG, 3)).astype(
        np.float32)
    want, want_interm = jsam.encoder.apply(
        {"params": jsam.params["encoder"]}, jnp.asarray(x),
        return_interm=True)
    got, interm = port.image_encoder(_t(x), return_interm=True)
    _close(got, want, what="features")
    assert got.shape == (1, IMG // 16, IMG // 16, 256)
    assert len(interm) == len(want_interm) == 1
    _close(interm[0], want_interm[0], what="interm")


@pytest.mark.parametrize("case", ["points", "points_boxes", "masks",
                                  "dense_pe"])
def test_prompt_encoder(plain_pair, case):
    port, jsam, _ = plain_pair
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, IMG, (2, 3, 2)).astype(np.float32)
    lbl = np.array([[1, 0, 1], [0, 1, -1]], np.int32)
    boxes = np.array([[3, 5, 40, 50], [10, 2, 60, 33]], np.float32)
    masks = rng.normal(size=(2, 4 * 4 * 4, 4 * 4 * 4, 1)).astype(np.float32)
    params = {"params": jsam.params["prompt_encoder"]}
    pe = port.prompt_encoder
    if case == "dense_pe":
        want = jsam.prompt_encoder.apply(
            params, method=jsam.prompt_encoder.get_dense_pe)
        _close(pe.get_dense_pe(), want, what="dense pe")
        return
    kw = {"points": pts, "labels": lbl}
    if case == "points_boxes":
        kw["boxes"] = boxes
    if case == "masks":
        kw = {"masks": masks}
    want_s, want_d = jsam.prompt_encoder.apply(
        params, **{k: jnp.asarray(v) for k, v in kw.items()})
    got_s, got_d = pe(**{k: torch.as_tensor(v) for k, v in kw.items()})
    _close(got_s, want_s, what="sparse")
    _close(got_d, want_d, what="dense")


def test_two_way_transformer(plain_pair):
    port, jsam, _ = plain_pair
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 4, 4, 256)).astype(np.float32)
    pe = rng.normal(size=(1, 4, 4, 256)).astype(np.float32)
    tok = rng.normal(size=(2, 7, 256)).astype(np.float32)
    want_q, want_k = JaxTwoWay().apply(
        {"params": jsam.params["decoder"]["transformer"]}, jnp.asarray(img),
        jnp.asarray(pe), jnp.asarray(tok))
    got_q, got_k = port.mask_decoder.transformer(_t(img), _t(pe), _t(tok))
    _close(got_q, want_q, what="queries")
    _close(got_k, want_k, what="keys")


def _decoder_inputs(seed, vit_dim):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, 4, 4, 256)).astype(np.float32),
            rng.normal(size=(1, 4, 4, 256)).astype(np.float32),
            rng.normal(size=(1, 3, 256)).astype(np.float32),
            rng.normal(size=(1, 4, 4, 256)).astype(np.float32),
            rng.normal(size=(1, 4, 4, vit_dim)).astype(np.float32))


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder(plain_pair, multimask):
    port, jsam, _ = plain_pair
    feats, pe, sparse, dense, _ = _decoder_inputs(6, 32)
    want_m, want_i = jsam.decoder.apply(
        {"params": jsam.params["decoder"]}, *map(jnp.asarray, (
            feats, pe, sparse, dense)), multimask)
    got_m, got_i = port.mask_decoder(_t(feats), _t(pe), _t(sparse),
                                     _t(dense), multimask)
    assert got_m.shape == (1, 3 if multimask else 1, 16, 16)
    _close(got_m, want_m, what="masks")
    _close(got_i, want_i, what="iou")


@pytest.mark.parametrize("multimask", [True, False])
def test_mask_decoder_hq(hq_pair, multimask):
    port, jsam, _ = hq_pair
    feats, pe, sparse, dense, interm = _decoder_inputs(7, 32)
    want_m, want_i = jsam.decoder.apply(
        {"params": jsam.params["decoder"]}, *map(jnp.asarray, (
            feats, pe, sparse, dense)), multimask, jnp.asarray(interm))
    got_m, got_i = port.mask_decoder(_t(feats), _t(pe), _t(sparse),
                                     _t(dense), multimask, _t(interm))
    assert got_m.shape == (1, 4 if multimask else 2, 16, 16)
    _close(got_m, want_m, what="masks")
    _close(got_i, want_i, what="iou")


def _mask_mismatch(got, want):
    return float(np.mean(np.asarray(got) != np.asarray(want)))


@pytest.mark.parametrize("shape", [(48, 60), (64, 40)])
def test_predictor_set_image_and_predict(pair, shape):
    """set_image (OpenCV's uint8 resize in JAX, its replica in the port)
    then predict with two points; the HQ head reads set_image's interm."""
    port, jsam, _ = pair
    img = np.random.default_rng(8).integers(0, 256, (*shape, 3),
                                            dtype=np.uint8)
    jp, pp = JaxPredictor(jsam, img_size=IMG), SamPredictor(port,
                                                            img_size=IMG)
    want_f = jp.set_image(img)
    got_f = pp.set_image(img)
    _close(got_f, want_f, what="features")
    assert pp.input_size == jp.input_size and \
        pp.original_size == jp.original_size
    _close(pp.interm_features[0], jp.interm_features[0], what="interm")
    coords = np.array([[20, 17], [41, 30]])
    labels = np.array([1, 0])
    for logits in (True, False):
        wm, wi, wl = jp.predict(point_coords=coords, point_labels=labels,
                                multimask_output=True, return_logits=logits)
        gm, gi, gl = pp.predict(point_coords=coords, point_labels=labels,
                                multimask_output=True, return_logits=logits)
        assert gm.shape == wm.shape == (4 if port.is_hq else 3, *shape)
        _close(gi, wi, what="iou")
        _close(gl, wl, what="low-res logits")
        if logits:
            _close(gm, wm, what="upscaled logits")
        else:
            assert gm.dtype == bool
            assert _mask_mismatch(gm, wm) <= MASK_MISMATCH


def test_predictor_set_features_pads_and_predicts(plain_pair):
    """A non-square feature map: resized so its long side is the grid
    (shrinking, so antialiased), zero-padded bottom and right; then the
    point decode and the upscale to a non-square original size."""
    port, jsam, _ = plain_pair
    f = np.random.default_rng(9).normal(size=(6, 5, 256)).astype(np.float32)
    jp, pp = JaxPredictor(jsam, img_size=IMG), SamPredictor(port,
                                                            img_size=IMG)
    jp.set_features(f, original_size=(48, 36))
    pp.set_features(f, original_size=(48, 36))
    assert pp.features.shape == (1, 4, 4, 256)
    _close(pp.features, jp.features, 1e-5, "padded features")
    assert (pp.features[0, :, 3] == 0).all()
    assert pp.input_size == jp.input_size == (64, 48)
    raw = np.array([[10.7, 20.2], [30.9, 5.5]])
    np.testing.assert_array_equal(pp.transform_coords(raw),
                                  jp.transform_coords(raw))
    coords = pp.transform_coords(raw)
    assert coords.dtype == np.int32 and coords.tolist() == [[14, 26],
                                                             [41, 7]]
    wm, wi, wl = jp.predict(point_coords=coords, point_labels=[1, 1],
                            return_logits=True)
    gm, gi, gl = pp.predict(point_coords=coords, point_labels=[1, 1],
                            return_logits=True)
    _close(gi, wi, what="iou")
    _close(gl, wl, what="low-res logits")
    _close(gm, wm, what="upscaled logits")
    # a low-res mask prompt ([1, 4g, 4g]) beside the points
    prev = np.random.default_rng(11).normal(size=(1, 16, 16)).astype(
        np.float32)
    wm, wi, wl = jp.predict(point_coords=coords, point_labels=[1, 0],
                            mask_input=prev, multimask_output=False,
                            return_logits=True)
    gm, gi, gl = pp.predict(point_coords=coords, point_labels=[1, 0],
                            mask_input=prev, multimask_output=False,
                            return_logits=True)
    assert gm.shape == (1, 48, 36)
    _close(gi, wi, what="iou, mask prompt")
    _close(gl, wl, what="low-res logits, mask prompt")
    _close(gm, wm, what="upscaled logits, mask prompt")


@pytest.mark.parametrize("size", [(48, 36), (20, 64), (64, 64)])
def test_predictor_upscale(plain_pair, size):
    port, jsam, _ = plain_pair
    low = np.random.default_rng(10).normal(size=(3, 16, 16)).astype(
        np.float32)
    jp, pp = JaxPredictor(jsam, img_size=IMG), SamPredictor(port,
                                                            img_size=IMG)
    f = np.zeros((4, 4, 256), np.float32)
    jp.set_features(f, original_size=size)
    pp.set_features(f, original_size=size)
    want = np.asarray(jp._upscale(jnp.asarray(low)))
    got = pp._upscale(_t(low)).numpy()
    _close(got, want, 1e-5, "upscaled")
    assert _mask_mismatch(got > 0, want > 0) <= MASK_MISMATCH


def test_sam_hq_decode_from_injected_features_raises_on_both_sides(hq_pair):
    """A fact of the reference kept: set_features leaves no interm
    features, and the HQ decoder cannot run without them (the JAX package
    raises TypeError from MaskDecoderHQ.__call__); the port raises the
    same type with a message that says why."""
    port, jsam, _ = hq_pair
    f = np.zeros((4, 4, 256), np.float32)
    jp, pp = JaxPredictor(jsam, img_size=IMG), SamPredictor(port,
                                                            img_size=IMG)
    jp.set_features(f, original_size=(64, 64))
    pp.set_features(f, original_size=(64, 64))
    with pytest.raises(TypeError, match="interm_embeddings"):
        jp.predict(point_coords=[[5, 5]], point_labels=[1])
    with pytest.raises(TypeError, match="interm_embeddings.*set_features"):
        pp.predict(point_coords=[[5, 5]], point_labels=[1])


def test_random_weights_from_seed_are_reproducible():
    port_build._CONFIGS["vit_tiny"] = lambda: dict(TINY)
    try:
        a, b, c = (build_sam("vit_tiny", hq=True, img_size=IMG, seed=s,
                             device="cpu") for s in (3, 3, 4))
    finally:
        del port_build._CONFIGS["vit_tiny"]
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["mask_decoder.hf_token.weight"],
                           sc["mask_decoder.hf_token.weight"])
    assert not any(p.requires_grad for p in a.parameters())
    feats = SamPredictor(a, img_size=IMG).set_image(
        np.full((64, 64, 3), 128, np.uint8))
    assert torch.isfinite(feats).all() and feats.abs().max() > 0
