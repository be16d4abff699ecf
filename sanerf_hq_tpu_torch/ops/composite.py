"""Volume compositing (opaque-last-sample alpha compositing in cumsum form)
and the renderer's loss terms: the O(T) distortion loss and the interlevel
proposal loss in its banded-mask form.  Plain PyTorch, no kernels.
"""
import torch


def compute_weights(deltas, sigmas, opaque_last: bool = True):
    """deltas, sigmas: [N, T] -> (weights [N, T], transmittance [N, T]).

    weights_i = alpha_i * T_i with T_i = exp(-sum_{j<i} delta_j sigma_j) and
    alpha_i = 1 - exp(-delta_i sigma_i).  When opaque_last, the last
    delta*sigma is replaced by +inf (background == 'last_sample').
    """
    ds = deltas * sigmas
    if opaque_last:
        ds = torch.cat([ds[..., :-1], torch.full_like(ds[..., -1:], torch.inf)],
                       dim=-1)
    alphas = 1.0 - torch.exp(-ds)
    accum = torch.cumsum(ds[..., :-1], dim=-1)
    accum = torch.cat([torch.zeros_like(accum[..., :1]), accum], dim=-1)
    trans = torch.exp(-accum)
    weights = torch.nan_to_num(alphas * trans, nan=0.0)
    return weights, trans


def eff_distloss(weights, midpoints, intervals):
    """O(T) mip-NeRF 360 distortion loss, mean over rays:
    sum_ij w_i w_j |m_i - m_j| + (1/3) sum_i w_i^2 itv_i, with prefix sums
    (midpoints ascending along each ray)."""
    loss_uni = (1.0 / 3.0) * (intervals * weights ** 2).sum(dim=-1)
    wm = weights * midpoints
    w_cum = torch.cumsum(weights, dim=-1)
    wm_cum = torch.cumsum(wm, dim=-1)
    loss_bi = 2.0 * (wm[..., 1:] * w_cum[..., :-1]
                     - weights[..., 1:] * wm_cum[..., :-1]).sum(dim=-1)
    return (loss_uni + loss_bi).mean()


def distort_loss(bins, weights):
    """bins [N, T+1] (s-space edges), weights [N, T]."""
    intervals = bins[..., 1:] - bins[..., :-1]
    midpoints = bins[..., :-1] + intervals / 2.0
    return eff_distloss(weights, midpoints, intervals)


def _searchsorted_right(sorted_rows, query_rows):
    """Per row, the count of sorted entries <= each query."""
    return (sorted_rows[:, None, :] <= query_rows[:, :, None]).sum(dim=-1)


def loss_interlevel(t0, w0, t1, w1):
    """Interlevel loss of one proposal level (t1 [N, T1+1], w1 [N, T1])
    against the final level (t0, w0, detached by the caller): for each
    final interval, the proposal mass it overlaps through the banded mask
    inds_lo[j] <= k <= inds_hi[j]; returns the per-element shortfall
    [N, T0]."""
    T1 = w1.shape[-1]
    iota = torch.arange(T1, device=w1.device)
    inds_lo = (_searchsorted_right(t1[..., :-1], t0[..., :-1]) - 1).clamp(
        0, T1 - 1)
    inds_hi = _searchsorted_right(t1[..., 1:], t0[..., 1:]).clamp(0, T1 - 1)
    band = (inds_lo[..., None] <= iota) & (iota <= inds_hi[..., None])
    w = torch.where(band, w1[:, None, :], 0.0).sum(dim=-1)
    return torch.clamp_min(w0 - w, 0.0) ** 2 / (w0 + 1e-8)


def proposal_loss(all_bins, all_weights):
    """Lists ordered coarse to fine; the final level is the (detached)
    reference distribution."""
    bins_ref = all_bins[-1].detach()
    weights_ref = all_weights[-1].detach()
    loss = 0.0
    for bins, weights in zip(all_bins[:-1], all_weights[:-1]):
        loss = loss + loss_interlevel(bins_ref, weights_ref, bins,
                                      weights).mean()
    return loss
