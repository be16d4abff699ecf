"""Volume compositing (opaque-last-sample alpha compositing in cumsum form).

The renderer losses (distortion, interlevel proposal) belong to training
and are not ported yet.
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
