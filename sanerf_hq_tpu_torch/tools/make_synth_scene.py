"""Write the rich (or clutter) synthetic scene to disk in a real dataset
layout, so the whole CLI chain (stages 1 to 3) runs from files as it would
on a capture:

  python -m sanerf_hq_tpu_torch.tools.make_synth_scene <root> --format llff
  python -m sanerf_hq_tpu_torch.tools.make_synth_scene <root> --format colmap

Both write `images/v{i:03d}.png`, the ground-truth object-id maps
`gt_masks/{stem}.npy`, the decode-layout masks `masks/{stem}_obj_mask.npy`
(one object, [1, H, W] float32) with `masks/valid_dict.json`, the 3-D point
prompts `example_points.json` and, for the clutter scene, the held-out
stems `test_views.json` (`--val_type val_split --test_view_path`).  llff
writes `transforms.json`; colmap writes `sparse/0/{cameras,images,
points3D}.bin` with sparse points drawn on the true surfaces.  The files
are those of the JAX package's `scripts/make_synth_scene.py`, byte for
byte but for the PNGs' compression (their pixels are equal).
"""
from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np

from ..data.colmap import rotmat2qvec
from ..data.png import write_png
from ..data.synthetic import (_CL_SPHERES, _PLANE_Y, _SPHERES,
                              make_clutter_dataset, make_rich_dataset)


def write_images(root, d):
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    names = []
    for i in range(d["images"].shape[0]):
        name = f"v{i:03d}.png"
        # truncated to uint8, not rounded, as the JAX writer does
        write_png(os.path.join(root, "images", name),
                  (d["images"][i] * 255).astype(np.uint8))
        names.append(name)
    return names


def write_masks(root, d, names, object_id: int = 2):
    """The full object-id maps under gt_masks/, and the decode layout
    under masks/: {stem}_obj_mask.npy (1 on `object_id`) and
    valid_dict.json (every view valid)."""
    gt_dir = os.path.join(root, "gt_masks")
    dec_dir = os.path.join(root, "masks")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(dec_dir, exist_ok=True)
    valid = {}
    for i, name in enumerate(names):
        stem = os.path.splitext(name)[0]
        np.save(os.path.join(gt_dir, stem + ".npy"), d["obj_ids"][i])
        binary = (d["obj_ids"][i] == object_id).astype(np.float32)
        np.save(os.path.join(dec_dir, f"{stem}_obj_mask.npy"), binary[None])
        valid[stem] = 1.0
    with open(os.path.join(dec_dir, "valid_dict.json"), "w") as f:
        json.dump(valid, f)


def export_llff(root, d, names):
    fx, fy, cx, cy = d["intrinsics"]
    frames = [{"file_path": f"images/{n}",
               "transform_matrix": d["poses"][i].tolist()}
              for i, n in enumerate(names)]
    meta = {"w": d["W"], "h": d["H"], "fl_x": float(fx), "fl_y": float(fy),
            "cx": float(cx), "cy": float(cy), "frames": frames}
    with open(os.path.join(root, "transforms.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _surface_points(rng, n=400, scene="rich"):
    """n sparse points on the true surfaces: an equal share on each
    sphere, the rest on the ground plane (float64)."""
    spheres = _CL_SPHERES if scene == "clutter" else _SPHERES
    per = n // (len(spheres) + 1)
    pts = []
    for center, radius, _, _ in spheres:
        v = rng.normal(size=(per, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        pts.append(center + radius * v)
    g = rng.uniform(-2.5, 2.5, size=(n - len(spheres) * per, 3))
    g[:, 1] = _PLANE_Y
    pts.append(g)
    return np.concatenate(pts).astype(np.float64)


def export_colmap(root, d, names, scene="rich"):
    """A binary COLMAP model in sparse/0: one PINHOLE camera, each view's
    world-to-camera pose in OpenCV's axes with the surface points it sees
    inside the frame, and the points (no tracks)."""
    rng = np.random.default_rng(0)
    pts = _surface_points(rng, scene=scene)
    sp = os.path.join(root, "sparse", "0")
    os.makedirs(sp, exist_ok=True)
    fx, fy, cx, cy = [float(x) for x in d["intrinsics"]]
    V = len(names)

    with open(os.path.join(sp, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, d["W"], d["H"]))  # PINHOLE
        f.write(struct.pack("<4d", fx, fy, cx, cy))

    # each view's observations: the points in front of it inside the frame
    per_view_obs = []
    for i in range(V):
        c2w = d["poses"][i].copy()
        c2w[:3, 1] *= -1
        c2w[:3, 2] *= -1  # OpenGL -> OpenCV axes
        w2c = np.linalg.inv(c2w)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.where(z > 1e-6, z, 1e-6) + cx
        v = fy * pc[:, 1] / np.where(z > 1e-6, z, 1e-6) + cy
        vis = (z > 0.05) & (u >= 0) & (u < d["W"]) & (v >= 0) & (v < d["H"])
        ids = np.nonzero(vis)[0]
        per_view_obs.append((w2c, ids, u[ids], v[ids]))

    with open(os.path.join(sp, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", V))
        for i, name in enumerate(names):
            w2c, ids, us, vs = per_view_obs[i]
            q = rotmat2qvec(w2c[:3, :3])
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *w2c[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(ids)))
            for j in range(len(ids)):
                f.write(struct.pack("<ddq", us[j], vs[j], int(ids[j]) + 1))

    with open(os.path.join(sp, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, p in enumerate(pts):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", 128, 128, 128))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))


def point_prompts(scene: str) -> np.ndarray:
    """The decode's 3-D point prompts on object 2 (the central sphere) in
    the loaded scene's frame, [3, 3] float32: the first (crucial) point
    sits 0.02 inside the sphere below its north pole, so that its
    floor-cast pixel lands on the object from the low camera ring and
    passes the 0.05 depth gate; the others on its sides.  The points go
    through the pose loader's axis swap and llff scale of 0.33, as the
    viewer's picks would."""
    if scene == "clutter":
        # sphere (0, -0.05, 0), r 0.45
        side = (0.45 - 0.02) / np.sqrt(2.0)
        raw = np.array([[0.0, 0.38, 0.0], [side, -0.05, side],
                        [-side, -0.05, -side]], np.float32)
    else:  # sphere (0, -0.1, 0), r 0.5
        raw = np.array([[0.0, 0.38, 0.0], [0.35, -0.1, 0.35],
                        [-0.35, -0.1, -0.35]], np.float32)
    ngp_scale = 0.33
    return raw[:, [1, 2, 0]] * ngp_scale


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sanerf_hq_tpu_torch.tools.make_synth_scene",
        description="Write the rich or clutter synthetic scene to disk.")
    ap.add_argument("root")
    ap.add_argument("--format", choices=["llff", "colmap"], default="llff")
    ap.add_argument("--scene", choices=["rich", "clutter"], default="rich",
                    help="rich: 4-object benchmark; clutter: the harder "
                         "7-object high-frequency scene with extrapolated "
                         "val views (writes test_views.json for "
                         "--val_type val_split)")
    ap.add_argument("--n_views", type=int, default=24)
    ap.add_argument("--H", type=int, default=240)
    ap.add_argument("--W", type=int, default=320)
    ap.add_argument("--object_id", type=int, default=2,
                    help="object for the decode-style binary masks")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.scene == "clutter":
        d = make_clutter_dataset(n_views=args.n_views, H=args.H, W=args.W)
    else:
        d = make_rich_dataset(n_views=args.n_views, H=args.H, W=args.W)
    os.makedirs(args.root, exist_ok=True)
    names = write_images(args.root, d)
    write_masks(args.root, d, names, object_id=args.object_id)
    if "val_names" in d:
        with open(os.path.join(args.root, "test_views.json"), "w") as f:
            json.dump({"test_view_list": d["val_names"]}, f)
    with open(os.path.join(args.root, "example_points.json"), "w") as f:
        json.dump({"points": point_prompts(args.scene).tolist(),
                   "crucial_point_index": [0],
                   "valid_threshold": 1}, f)
    if args.format == "llff":
        export_llff(args.root, d, names)
    else:
        export_colmap(args.root, d, names, scene=args.scene)
    print(f"wrote {len(names)} views to {args.root} ({args.format})")
    return names


if __name__ == "__main__":
    main()
