"""Port ops (sanerf_hq_tpu_torch.ops) against the JAX ops on shared inputs.

Inputs come from a numpy seed and go through both functions in float32.
Tolerance: atol 1e-5, plus rtol 1e-6 where values grow large (exp, the
1e9 miss sentinel, the inverse warp near s = 1), where 1e-5 is below one
float32 ulp.  The bf16 trunk forward is held to rel-max 2e-2, the bar the
JAX package holds its own bf16 kernels to.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sanerf_hq_tpu.ops import composite as j_comp
from sanerf_hq_tpu.ops import contraction as j_con
from sanerf_hq_tpu.ops import fused_mlp as j_fm
from sanerf_hq_tpu.ops import ray as j_ray
from sanerf_hq_tpu.ops import sh as j_sh
from sanerf_hq_tpu_torch.ops import composite, contraction, fused_mlp, ray, sh

# the packages re-export the functions under the module names
j_te = importlib.import_module("sanerf_hq_tpu.ops.trunc_exp")
trunc_exp = importlib.import_module("sanerf_hq_tpu_torch.ops.trunc_exp")
ATOL, RTOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=rtol)


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def test_contract(rng):
    x = (rng.normal(size=(512, 3)) * rng.choice([0.3, 3.0], (512, 1)))
    x = x.astype(np.float32)
    _close(contraction.contract(_t(x)), j_con.contract(jnp.asarray(x)))


def test_near_far_from_aabb(rng):
    ro = rng.normal(size=(256, 3)).astype(np.float32) * 3
    rd = rng.normal(size=(256, 3)).astype(np.float32)
    aabb = np.array([-2, -2, -2, 2, 2, 2], np.float32)
    near, far = ray.near_far_from_aabb(_t(ro), _t(rd), _t(aabb), 0.2)
    jn, jf = j_ray.near_far_from_aabb(jnp.asarray(ro), jnp.asarray(rd),
                                      jnp.asarray(aabb), 0.2)
    assert (np.asarray(near) == 1e9).any()  # some rays miss the box
    _close(near, jn)
    _close(far, jf)


def test_spacing_fns(rng):
    x = rng.uniform(0.01, 50.0, 1000).astype(np.float32)
    s = rng.uniform(0.0, 0.999, 1000).astype(np.float32)
    _close(ray.spacing_fn(_t(x)), j_ray.spacing_fn(jnp.asarray(x)))
    _close(ray.spacing_fn_inv(_t(s)), j_ray.spacing_fn_inv(jnp.asarray(s)))


def test_sample_pdf(rng):
    N, T0, T = 64, 16, 9
    bins = np.sort(rng.uniform(0, 1, (N, T0 + 1)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (N, T0)).astype(np.float32)
    w[:4] = 0.0  # all-zero rows exercise the +0.01 floor alone
    got = ray.sample_pdf(_t(bins), _t(w), T)
    want = j_ray.sample_pdf(jnp.asarray(bins), jnp.asarray(w), T)
    _close(got, want)


def test_sample_pdf_jitter_stays_in_range(rng):
    N, T0, T = 32, 16, 9
    bins = np.sort(rng.uniform(0, 1, (N, T0 + 1)), axis=1).astype(np.float32)
    w = rng.uniform(0, 1, (N, T0)).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    got = ray.sample_pdf(_t(bins), _t(w), T, generator=g)
    assert got.shape == (N, T)
    assert (got >= _t(bins[:, :1]) - 1e-6).all()
    assert (got <= _t(bins[:, -1:]) + 1e-6).all()
    assert (got.diff(dim=-1) >= -1e-6).all()


@pytest.mark.parametrize("opaque_last", [True, False])
def test_compute_weights(rng, opaque_last):
    deltas = rng.uniform(0, 0.1, (64, 16)).astype(np.float32)
    sigmas = rng.uniform(0, 20, (64, 16)).astype(np.float32)
    w, tr = composite.compute_weights(_t(deltas), _t(sigmas), opaque_last)
    jw, jtr = j_comp.compute_weights(jnp.asarray(deltas), jnp.asarray(sigmas),
                                     opaque_last)
    _close(w, jw)
    _close(tr, jtr)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(rng, degree):
    d = rng.normal(size=(256, 3)).astype(np.float32)
    _close(sh.sh_encode(_t(d), degree), j_sh.sh_encode(jnp.asarray(d), degree))


@pytest.mark.parametrize("name", ["trunc_exp", "safe_trunc_exp"])
def test_trunc_exp_forward_and_grad(rng, name):
    x = rng.uniform(-40, 20, 512).astype(np.float32)
    jfn, tfn = getattr(j_te, name), getattr(trunc_exp, name)
    xt = _t(x).requires_grad_(True)
    y = tfn(xt)
    y.sum().backward()
    _close(y.detach(), jfn(jnp.asarray(x)))
    _close(xt.grad, jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x)))


def test_freq_layout(rng):
    x = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    got = fused_mlp._freq(_t(x), 6)
    want = j_fm._freq(jnp.asarray(x), 6, jnp.float32)
    _close(got, want)


@pytest.mark.parametrize("extra_dim", [0, 5])
def test_reference_forward_bf16(rng, extra_dim):
    deg, skip = 4, 2
    in_dim = 3 * (1 + 2 * deg) + extra_dim
    shapes = [(in_dim, 32), (32, 32), (32 + in_dim, 32), (32, 16)]
    ws = [rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
          for s in shapes]
    x = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    tws = [_t(w).T for w in ws]
    jws = [jnp.asarray(w) for w in ws]
    if extra_dim:
        e = rng.normal(size=(256, extra_dim)).astype(np.float32)
        got = fused_mlp._reference_forward_with_extra(_t(x), _t(e), tws, deg,
                                                      skip)
        want = j_fm._reference_forward_with_extra(
            jnp.asarray(x), jnp.asarray(e), jws, deg, skip)
    else:
        got = fused_mlp._reference_forward(_t(x), tws, deg, skip)
        want = j_fm._reference_forward(jnp.asarray(x), jws, deg, skip)
    assert _relmax(got, want) < 2e-2
