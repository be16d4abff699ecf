"""K10's plain version (`ops/sample_pdf.py` `sample_pdf_lookup_ref`, what
`sample_pdf_lookup` runs on CPU tensors) against the JAX package's Pallas
kernel `sample_pdf_lookup_pallas` run in Pallas interpret mode, on rows
with ties: tails clamped to 1 and zero-width bins; and the port's
`sample_pdf` against JAX's with the Pallas lookup switched on.

Bars: max abs <= 1e-6 on the lookup's resampled edges (in [0, 1]; the two
compute the same interpolation, one reduction order apart); 1e-5 through
`sample_pdf`, whose pdf normalisation and cumsum round in another order
on each side, an error a steep bin (wide in s, narrow in the cdf)
magnifies.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sanerf_hq_tpu.ops.fused_mlp as jfm
import sanerf_hq_tpu.ops.sample_pdf_pallas as jsp
from sanerf_hq_tpu.ops import ray as jray
from sanerf_hq_tpu_torch.ops import ray as tray
from sanerf_hq_tpu_torch.ops.sample_pdf import (sample_pdf_lookup,
                                                sample_pdf_lookup_ref)

ATOL, ATOL_SAMPLE_PDF = 1e-6, 1e-5


@pytest.fixture()
def interpret(monkeypatch):
    """Run the module's pallas_call in interpret mode on the CPU."""
    ns = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    monkeypatch.setattr(jsp, "pl", ns)


def _rows(rng, N, K, Q):
    """cdf / bins [N, K] non-decreasing with ties, u [N, Q] in [0, 1)."""
    w = rng.uniform(0, 1, (N, K - 1)).astype(np.float32)
    w[rng.uniform(size=(N, K - 1)) < 0.3] = 0.0  # flat runs of the cdf
    w[: N // 4, K // 2:] = 0.0  # rows that reach 1 half way: clamped tails
    cdf = np.cumsum(w, axis=-1)
    cdf = cdf / np.maximum(cdf[:, -1:], 1e-12)
    cdf[N // 4: N // 2] *= 1.05  # cumsums that overshoot, clamped to 1
    cdf = np.concatenate([np.zeros((N, 1)), np.minimum(cdf, 1.0)], -1)
    widths = rng.uniform(0, 1, (N, K - 1))
    widths[rng.uniform(size=(N, K - 1)) < 0.2] = 0.0  # zero-width bins
    bins = np.concatenate([np.zeros((N, 1)), np.cumsum(widths, -1)], -1)
    bins = bins / bins[:, -1:]
    base = (np.arange(Q) + 0.5) / Q
    u = base + (rng.uniform(size=(N, Q)) - 0.5) / Q
    return [a.astype(np.float32) for a in (cdf, bins, u)]


@pytest.mark.parametrize("N,K,Q", [(300, 17, 9), (2100, 65, 33),
                                   (64, 129, 65)])
def test_lookup_matches_pallas_interpret(interpret, N, K, Q):
    rng = np.random.default_rng(K)
    cdf, bins, u = _rows(rng, N, K, Q)
    assert (np.diff(cdf, axis=-1) == 0).any() and (cdf == 1.0).sum() > N
    assert (np.diff(bins, axis=-1) == 0).any()
    want = np.asarray(jsp.sample_pdf_lookup_pallas(
        jnp.asarray(cdf), jnp.asarray(bins), jnp.asarray(u)))
    t = [torch.from_numpy(a) for a in (cdf, bins, u)]
    got = sample_pdf_lookup_ref(*t)
    assert got.shape == want.shape == (N, Q)
    assert np.abs(got.numpy() - want).max() <= ATOL
    # the CPU wrapper is the plain version, and launches nothing
    launches = sample_pdf_lookup.launches
    assert torch.equal(sample_pdf_lookup(*t), got)
    assert sample_pdf_lookup.launches == launches


def test_lookup_on_exact_cdf_entries(interpret):
    """Queries equal to cdf entries (the `<=` side of the search) and rows
    whose every entry past the first is 1."""
    cdf = np.array([[0.0, 0.25, 0.25, 0.5, 1.0, 1.0],
                    [0.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    bins = np.array([[0.0, 0.1, 0.2, 0.2, 0.7, 1.0],
                     [0.0, 0.5, 0.6, 0.7, 0.8, 1.0]], np.float32)
    u = np.array([[0.0, 0.25, 0.5, 0.75, 1.0],
                  [0.0, 0.3, 0.999, 1.0, 0.5]], np.float32)
    want = np.asarray(jsp.sample_pdf_lookup_pallas(
        jnp.asarray(cdf), jnp.asarray(bins), jnp.asarray(u)))
    got = sample_pdf_lookup_ref(*(torch.from_numpy(a) for a in (cdf, bins, u)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T0,T", [(16, 9), (128, 65), (64, 33)])
def test_sample_pdf_matches_jax_pallas(interpret, monkeypatch, T0, T):
    monkeypatch.setattr(jfm, "PALLAS_ENABLED", True)
    rng = np.random.default_rng(T0)
    N = 50
    bins = np.sort(rng.uniform(0, 1, (N, T0 + 1)), axis=-1).astype(np.float32)
    bins[:, 0], bins[:, -1] = 0.0, 1.0
    w = rng.uniform(0, 1, (N, T0)).astype(np.float32) ** 4
    w[:10] = 0.0  # all-floor rows: a uniform pdf
    w[10:20, T0 // 3:] = 0.0
    want = np.asarray(jray.sample_pdf(jnp.asarray(bins), jnp.asarray(w), T))
    got = tray.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), T)
    assert got.shape == (N, T)
    assert np.abs(got.numpy() - want).max() <= ATOL_SAMPLE_PDF
