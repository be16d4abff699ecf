"""COLMAP sparse model (or a video / a folder of images) -> transforms.json.

  python -m sanerf_hq_tpu_torch.tools.colmap2nerf --colmap_dir sparse/0 \
      --images images --out transforms.json

The port's counterpart of the JAX package's `scripts/colmap2nerf.py`, with
the same flags: `--video` extracts frames with ffmpeg and `--run_colmap`
runs COLMAP's feature extraction, matching and mapping, where those
programs are installed; then the sparse model (`--colmap_dir`, else the
first of colmap_sparse/0, sparse/0 and colmap that exists) becomes
transforms.json: the first camera's intrinsics and each image's
cam2world in NeRF's axes, centred on the cameras' mean and scaled so that
the 90th percentile of their distances to it is 4 (instant-ngp's rule).
"""
import argparse
import json
import math
import os
import subprocess

import numpy as np

from ..data.colmap import load_sparse_model, qvec2rotmat


def run_ffmpeg(video, out_dir, fps):
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run([
        "ffmpeg", "-i", video, "-qscale:v", "1", "-qmin", "1",
        "-vf", f"fps={fps}", os.path.join(out_dir, "%04d.jpg"),
    ], check=True)


def run_colmap(images, workspace):
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.run(["colmap", "feature_extractor", "--database_path", db,
                    "--image_path", images], check=True)
    subprocess.run(["colmap", "exhaustive_matcher", "--database_path", db],
                   check=True)
    subprocess.run(["colmap", "mapper", "--database_path", db,
                    "--image_path", images, "--output_path", sparse],
                   check=True)
    return os.path.join(sparse, "0")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m sanerf_hq_tpu_torch.tools.colmap2nerf",
        description="COLMAP sparse model -> transforms.json")
    ap.add_argument("--video", default=None)
    ap.add_argument("--images", default="images")
    ap.add_argument("--fps", type=int, default=2)
    ap.add_argument("--colmap_dir", default=None,
                    help="existing sparse model dir (skips running colmap)")
    ap.add_argument("--out", default="transforms.json")
    ap.add_argument("--aabb_scale", type=int, default=16)
    ap.add_argument("--run_colmap", action="store_true")
    return ap


def transforms_from_model(colmap_dir: str, images: str = "images",
                          aabb_scale: int = 16) -> dict:
    """The transforms.json dict of the sparse model in colmap_dir, frames
    in image-id order with file paths under `images`."""
    cams, imgs, _ = load_sparse_model(colmap_dir)
    cam = cams[sorted(cams.keys())[0]]
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
        fl_x = fl_y = cam.params[0]
        cx, cy = cam.params[1], cam.params[2]
    else:
        fl_x, fl_y = cam.params[0], cam.params[1]
        cx, cy = cam.params[2], cam.params[3]

    frames = []
    for k in sorted(imgs.keys()):
        im = imgs[k]
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        # OpenCV -> NeRF axes (y and z flipped)
        c2w[0:3, 1] *= -1
        c2w[0:3, 2] *= -1
        frames.append({"file_path": os.path.join(images, im.name),
                       "c2w": c2w})

    # recentre and rescale as instant-ngp does
    centers = np.stack([f["c2w"][:3, 3] for f in frames])
    center = centers.mean(0)
    scale = 4.0 / np.percentile(np.linalg.norm(centers - center, axis=-1), 90)
    out_frames = []
    for f in frames:
        m = f["c2w"].copy()
        m[:3, 3] = (m[:3, 3] - center) * scale
        out_frames.append({"file_path": f["file_path"],
                           "transform_matrix": m.tolist()})
    return {
        "w": int(cam.width), "h": int(cam.height),
        "fl_x": float(fl_x), "fl_y": float(fl_y),
        "cx": float(cx), "cy": float(cy),
        "camera_angle_x": float(2 * math.atan(cam.width / (2 * fl_x))),
        "aabb_scale": aabb_scale,
        "frames": out_frames,
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.video:
        run_ffmpeg(args.video, args.images, args.fps)
    colmap_dir = args.colmap_dir
    if colmap_dir is None:
        if args.run_colmap:
            colmap_dir = run_colmap(args.images, ".")
        else:
            for cand in ("colmap_sparse/0", "sparse/0", "colmap"):
                if os.path.exists(cand):
                    colmap_dir = cand
                    break
    if colmap_dir is None:
        raise SystemExit("no sparse model found; pass --colmap_dir or "
                         "--run_colmap")
    out = transforms_from_model(colmap_dir, args.images, args.aabb_scale)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {len(out['frames'])} frames to {args.out}")


if __name__ == "__main__":
    main()
