"""The reference's training steps and batches.

  - stage 1: a batch of rays drawn uniformly over the training views and
    their pixels; the loss MSE + lambda_proposal * interlevel +
    lambda_distort * distortion (ramped in over [w, 2w] steps); the
    proposal MLPs learn on steps <= 3000 and every fifth after;
  - stage 3: global rays drawn by the error map (a cell with probability
    proportional to its error, a pixel inside it), then local patches
    centred on cells drawn the same way; the loss the cross-entropy of the
    composited object logits on the labelled global rays, + the ray-pair
    RGB loss on the patches once step > ray_pair_rgb_iter; the error map's
    cells of the global rays move to 0.1 old + 0.9 error; the map's
    rebuild renders every view's object field at the map's size and takes
    exp(-w cos - eps) of its probabilities against the labels, resized
    bilinearly (as OpenCV's INTER_LINEAR) and rounded;
  - Adam over the trainable parameters (common.Adam).
Random numbers come from `Draws`, in the program's order."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .common import Adam, Draws, full_frame_rays, rays_from_pixels
from .fields import HashField, MLPField, render_hash, render_mlp


def make_field(cfg: dict, params: Dict[str, torch.Tensor],
               modes: Dict[str, str]):
    kind = cfg["field"]["type"]
    if kind == "mlp":
        return MLPField(cfg, params, modes)
    if kind == "hashgrid":
        return HashField(cfg, params, modes)
    raise ValueError(f"unknown field type {kind!r}")


def render(field, rays_o, rays_d, cfg, draws=None, **kw):
    fn = render_mlp if isinstance(field, MLPField) else render_hash
    return fn(field, rays_o, rays_d, cfg, draws, **kw)


@torch.no_grad()
def render_view(field, pose, intrinsics, H: int, W: int, cfg: dict,
                chunk: int):
    """A full view in chunks of rays: (image [H*W, 3], depth [H*W])."""
    ro, rd = full_frame_rays(pose, intrinsics, H, W)
    img, dep = [], []
    for i in range(0, ro.shape[0], chunk):
        out = render(field, ro[i:i + chunk], rd[i:i + chunk], cfg)
        img.append(out["image"])
        dep.append(out["depth"])
    return torch.cat(img), torch.cat(dep)


# -- stage 1 ------------------------------------------------------------------

def rgb_batch(draws: Draws, images, poses, intrinsics, n: int):
    """n rays, each from a uniformly drawn view and pixel centre."""
    V, H, W = images.shape[:3]
    views = draws.randint(V, (n,))
    pix = draws.randint(H * W, (n,))
    rows, cols = torch.div(pix, W, rounding_mode="floor"), pix % W
    intr = intrinsics[views] if intrinsics.dim() == 2 else intrinsics
    ro, rd = rays_from_pixels(poses[views], intr, cols.float() + 0.5,
                              rows.float() + 0.5)
    return ro, rd, images[views, rows, cols]


def rgb_step(field, opt: Adam, draws: Draws, data: dict, cfg: dict,
             step: int) -> float:
    """One stage-1 step; returns its loss."""
    loss_cfg = cfg["loss"]
    ro, rd, gt = rgb_batch(draws, data["images"], data["poses"],
                           data["intrinsics"], cfg["rays"])
    upd = step <= 3000 or step % 5 == 0
    out = render(field, ro, rd, cfg, draws, losses=True, update_proposal=upd)
    loss = torch.mean((out["image"] - gt[..., :3]) ** 2)
    loss = loss + loss_cfg["lambda_proposal"] * out["proposal_loss"]
    w = loss_cfg["lambda_distort_warmup"]
    lam = loss_cfg["lambda_distort"]
    if w > 0:
        lam = lam * min(max((step - w) / w, 0.0), 1.0)
    loss = loss + lam * out["distort_loss"]
    loss.backward()
    opt.step()
    return float(loss.detach())


# -- stage 3 ------------------------------------------------------------------

def fovy_intrinsics(resolution: int, fovy_deg: float = 60.0):
    focal = resolution / (2.0 * np.tan(0.5 * np.deg2rad(fovy_deg)))
    return np.array([focal, focal, resolution / 2, resolution / 2],
                    np.float32)


def resize_nearest(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Source index floor(i * src / dst) on each axis."""
    h, w = img.shape[:2]
    rows = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(
        np.int64), h - 1)
    cols = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(
        np.int64), w - 1)
    return img[rows][:, cols]


def _linear_taps(dst: int, src: int):
    """INTER_LINEAR's taps along one axis: half-pixel centres clamped at
    both edges, positions in float64; (lower index, its weight, the upper
    one's)."""
    f = (np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    f[i0 < 0] = 0.0
    i0[i0 < 0] = 0
    top = i0 >= src - 1
    f[top] = 0.0
    i0[top] = src - 1
    return i0, (1.0 - f).astype(np.float32), f.astype(np.float32)


def resize_linear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear float32 resize: along the rows, then down the columns."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    c0, a0, a1 = _linear_taps(W, w)
    r0, b0, b1 = _linear_taps(H, h)
    c1, r1 = np.minimum(c0 + 1, w - 1), np.minimum(r0 + 1, h - 1)
    rows = img[:, c0] * a0 + img[:, c1] * a1
    return rows[r0] * b0[:, None] + rows[r1] * b1[:, None]


@torch.no_grad()
def rebuild_error_map(field, labels, poses, intr, cfg: dict):
    """The error map [V, S*S] from every view rendered at S x S: labels
    [V] numpy label images at the scene's size, poses [V, 4, 4], intr the
    online view's [fx, fy, cx, cy] at H x W (numpy)."""
    S, H, W = cfg["error_map_size"], cfg["H"], cfg["W"]
    n_inst, eps = cfg["field"]["n_inst"], cfg["epsilon"]
    small = torch.as_tensor(np.asarray(intr, np.float32) * np.array(
        [S / W, S / H, S / W, S / H], np.float32), device=poses.device)
    rows = []
    for i in range(poses.shape[0]):
        ro, rd = full_frame_rays(poses[i], small, S, S)
        logits = torch.cat([
            render(field, ro[c:c + cfg["chunk"]], rd[c:c + cfg["chunk"]],
                   cfg, update_proposal=False,
                   mask=True)["instance_mask_logits"]
            for c in range(0, ro.shape[0], cfg["chunk"])])
        probs = torch.softmax(logits, -1)
        gt = resize_linear(np.asarray(labels[i], np.float32), S, S)
        gt = np.rint(np.clip(gt, 0, n_inst - 1)).astype(np.int64)
        onehot = F.one_hot(torch.as_tensor(gt.reshape(-1),
                                           device=probs.device),
                           n_inst).float()
        rows.append(torch.exp(-cfg["exp_weight"] * _cos(probs, onehot)
                              - eps))
    return torch.stack(rows)


def draw_cells(draws: Draws, weights, n: int):
    """n draws of a flat cell index of weights [V, C], each view's row
    scaled to sum 1, over an int64 fixed-point CDF (2^40 a unit)."""
    w = weights.double()
    w = (w / w.sum(-1, keepdim=True) * 2.0 ** 40).round().long()
    cdf = w.reshape(-1).cumsum(0)
    u = draws.rand((n,), torch.float64)
    target = (u * cdf[-1].double()).long()
    return torch.searchsorted(cdf, target, right=True).clamp_max(
        cdf.numel() - 1)


def mask_batch(draws: Draws, masks, poses, intr, error_map, cfg: dict):
    """Global rays by the error map, then local patches on drawn cells;
    the patches' rays after the global ones."""
    n, P, ps = cfg["rays"], cfg["num_local"], cfg["patch"]
    H, W, S = cfg["H"], cfg["W"], cfg["error_map_size"]
    V = poses.shape[0]
    sx, sy = H / S, W / S
    idx = draw_cells(draws, error_map.clamp_min(1e-12), n)
    views = torch.div(idx, S * S, rounding_mode="floor")
    coarse = idx % (S * S)
    rows = ((torch.div(coarse, S, rounding_mode="floor") * sx
             + draws.rand((n,)) * sx).long()).clamp(0, H - 1)
    cols = (((coarse % S) * sy + draws.rand((n,)) * sy).long()).clamp(0, W - 1)
    ro, rd = rays_from_pixels(poses[views], intr, cols.float() + 0.5,
                              rows.float() + 0.5)
    lv = draws.randint(V, (P,))
    centers = draws.multinomial(error_map[lv].clamp_min(1e-12), 1)[:, 0]
    x0 = (torch.div(centers, S, rounding_mode="floor") * sx
          - ps // 2).long().clamp(0, H - ps - 1)
    y0 = ((centers % S) * sy - ps // 2).long().clamp(0, W - ps - 1)
    off = torch.arange(ps, device=poses.device)
    lrows = (x0[:, None, None] + off[None, :, None]).expand(-1, -1, ps)
    lcols = (y0[:, None, None] + off[None, None, :]).expand(-1, ps, -1)
    lrows, lcols = lrows.reshape(-1), lcols.reshape(-1)
    lviews = lv.repeat_interleave(ps * ps)
    lro, lrd = rays_from_pixels(poses[lviews], intr, lcols.float() + 0.5,
                                lrows.float() + 0.5)
    l_coarse = ((lrows.float() * (S / H)).long() * S
                + (lcols.float() * (S / W)).long())
    return {"rays_o": torch.cat([ro, lro]), "rays_d": torch.cat([rd, lrd]),
            "gt": torch.cat([masks[views, rows, cols],
                             masks[lviews, lrows, lcols]]),
            "views": views, "coarse": coarse,
            "local_error": error_map[lviews, l_coarse]}


def _cos(a, b, eps=1e-8):
    return (a * b).sum(-1) / torch.clamp(torch.linalg.norm(a, dim=-1)
                                         * torch.linalg.norm(b, dim=-1),
                                         min=eps)


def ray_pair_loss(draws: Draws, rgb, probs, incoherent, cfg: dict):
    """Per patch, num_sample anchors drawn without replacement among its
    coherent rays (Gumbel top-k); rays whose colour lies within the
    threshold of an anchor are pushed toward its argmax one-hot."""
    P, S, _ = rgb.shape
    weights = (1.0 - incoherent > 0.8).float()
    weights = torch.where(weights.sum(-1, keepdim=True) == 0, 1.0, weights)
    e = draws.exponential((P, S))
    idx = torch.topk(torch.log(weights.clamp_min(1e-12)) - torch.log(e),
                     cfg["ray_pair_num_sample"], dim=-1).indices

    def take(a):
        return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))

    rgb_s = take(rgb)[:, :, None, :]
    arg = take(probs).detach().argmax(-1, keepdim=True)[:, :, None, :]
    onehot = (torch.arange(probs.shape[-1], device=arg.device)
              == arg).float()
    similar = (torch.linalg.norm(rgb[:, None] - rgb_s, dim=-1)
               < cfg["ray_pair_threshold"]).float()
    sim = torch.exp(-cfg["exp_weight"] * _cos(probs[:, None], onehot)
                    - cfg["epsilon"])
    return ((similar * sim).sum(-1) / similar.sum(-1).clamp_min(1.0)).mean()


def mask_step(field, opt: Adam, draws: Draws, data: dict, error_map,
              cfg: dict, step: int):
    """One stage-3 step; returns (loss, the updated error map)."""
    b = mask_batch(draws, data["masks"], data["poses"], data["intr"],
                   error_map, cfg)
    out = render(field, b["rays_o"], b["rays_d"], cfg,
                 update_proposal=False, mask=True)
    n, eps = cfg["rays"], cfg["epsilon"]
    probs = torch.softmax(out["instance_mask_logits"], -1).clamp(eps, 1 - eps)
    gt = b["gt"][:n]
    labeled = (gt != -1).float()
    safe = gt.clamp_min(0)
    picked = probs[:n].gather(1, safe[:, None])[:, 0]
    loss = (-torch.log(picked) * labeled).sum() / labeled.sum().clamp_min(1.0)
    onehot = F.one_hot(safe, probs.shape[-1]).float()
    err = torch.exp(-cfg["exp_weight"] * _cos(probs[:n].detach(), onehot)
                    - eps)
    new_map = error_map.clone()
    flat = b["views"] * error_map.shape[1] + b["coarse"]
    vals = 0.1 * error_map.view(-1)[flat] + 0.9 * err
    # a cell drawn twice keeps its last draw's value
    pos = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((error_map.numel(),), -1, dtype=pos.dtype,
                      device=flat.device).scatter_reduce_(0, flat, pos, "amax")
    new_map.view(-1)[flat] = vals[last[flat]]
    P, S = cfg["num_local"], cfg["patch"] ** 2
    rp = ray_pair_loss(draws, out["image"][n:].detach().reshape(P, S, -1),
                       probs[n:].reshape(P, S, -1),
                       b["local_error"].reshape(P, S), cfg)
    loss = loss + cfg["ray_pair_weight"] * float(
        step > cfg["ray_pair_iter"]) * rp
    loss.backward()
    opt.step()
    return float(loss.detach()), new_map
