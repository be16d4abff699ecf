"""K10, the inverse-CDF lookup of `sample_pdf`: a hand-written CUDA kernel
(csrc/sample_pdf.cu) with its plain PyTorch version beside it.

`sample_pdf_lookup(cdf, bins, u)` keeps the JAX name of the lookup
(`sample_pdf_lookup_pallas`).  A CPU tensor goes to the plain version, and
only a CPU tensor; a CUDA tensor launches the kernel or raises.  The
wrapper counts its kernel launches in its `launches` attribute.  Forward
only: the renderer detaches the resampled bins.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .render_level import _check, _ptr, _stream


def sample_pdf_lookup_ref(cdf, bins, u):
    """Plain version: cdf, bins [N, K] (rows non-decreasing), u [N, Q] ->
    resampled bin edges [N, Q].  The masked prefix / suffix reduction:
      below: max over {k : cdf_k <= u};  above: min over {k : cdf_k > u},
      an empty suffix giving the last element;
    then the linear interpolation between them."""
    le = cdf[:, None, :] <= u[:, :, None]  # [N, Q, K]
    neg = torch.tensor(-1e38, dtype=cdf.dtype, device=cdf.device)
    pos = torch.tensor(1e38, dtype=cdf.dtype, device=cdf.device)
    cdf_g0 = torch.where(le, cdf[:, None, :], neg).amax(dim=-1)
    bins_g0 = torch.where(le, bins[:, None, :], neg).amax(dim=-1)
    cdf_g1 = torch.minimum(
        torch.where(le, pos, cdf[:, None, :]).amin(dim=-1), cdf[:, -1:])
    bins_g1 = torch.minimum(
        torch.where(le, pos, bins[:, None, :]).amin(dim=-1), bins[:, -1:])

    denom = cdf_g1 - cdf_g0
    t = torch.where(denom > 0,
                    (u - cdf_g0) / torch.where(denom > 0, denom, 1.0), 0.0)
    t = torch.nan_to_num(t).clamp(0.0, 1.0)
    return bins_g0 + t * (bins_g1 - bins_g0)


def sample_pdf_lookup(cdf, bins, u):
    """Inverse-CDF lookup (K10): cdf, bins [N, K] fp32 with non-decreasing
    rows, u [N, Q] fp32 queries, all contiguous -> [N, Q] bin edges."""
    if cdf.device.type == "cpu":
        return sample_pdf_lookup_ref(cdf, bins, u)
    if cdf.device.type != "cuda":
        raise ValueError(f"unsupported device {cdf.device}")
    N, K = cdf.shape
    Q = u.shape[1]
    if K < 1:
        raise ValueError("sample_pdf_lookup needs at least one cdf entry")
    for name, x, shape in (("cdf", cdf, (N, K)), ("bins", bins, (N, K)),
                           ("u", u, (N, Q))):
        _check(name, x, shape, cdf.device)
    out = torch.empty((N, Q), dtype=torch.float32, device=cdf.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load("sample_pdf")
    fn = lib.sanerf_sample_pdf_lookup
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(_ptr(cdf), _ptr(bins), _ptr(u), _ptr(out), N, K, Q,
            _stream(cdf.device))
    cuda_lib.check(lib, rc, "sample_pdf_lookup")
    sample_pdf_lookup.launches += 1
    return out


sample_pdf_lookup.launches = 0
