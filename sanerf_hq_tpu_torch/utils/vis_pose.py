"""Camera-pose visualisation (`--vis_pose`): per camera 8 frustum line
segments and a long look-direction segment, the [-bound, bound] box (and
the unit box when bound > 1) and the sparse point cloud, written as an
ASCII PLY with vertex and edge elements (MeshLab, trimesh, Open3D read
it).  Where matplotlib is installed a PNG 3-D plot is written beside it;
without matplotlib the PLY alone is written.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _camera_segments(pose: np.ndarray, size: float = 0.05) -> np.ndarray:
    """One camera's 9 line segments: 4 frustum edges from the origin, the
    4 far-plane edges, and a 3-unit look-direction ray.  Returns
    [9, 2, 3]."""
    pos = pose[:3, 3]
    a = pos + size * pose[:3, 0] + size * pose[:3, 1] - size * pose[:3, 2]
    b = pos - size * pose[:3, 0] + size * pose[:3, 1] - size * pose[:3, 2]
    c = pos - size * pose[:3, 0] - size * pose[:3, 1] - size * pose[:3, 2]
    d = pos + size * pose[:3, 0] - size * pose[:3, 1] - size * pose[:3, 2]
    direction = (a + b + c + d) / 4 - pos
    direction = direction / (np.linalg.norm(direction) + 1e-8)
    o = pos + direction * 3
    return np.array([[pos, a], [pos, b], [pos, c], [pos, d],
                     [a, b], [b, c], [c, d], [d, a], [pos, o]])


def _box_segments(half: float) -> np.ndarray:
    """The 12 edges of the cube [-half, half]^3.  Returns [12, 2, 3]."""
    corners = np.array([[sx * half, sy * half, sz * half]
                        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    edges = []
    for i in range(8):
        for j in range(i + 1, 8):
            if np.sum(corners[i] != corners[j]) == 1:  # axis-aligned edge
                edges.append([corners[i], corners[j]])
    return np.array(edges)


def visualize_poses(poses: np.ndarray, bound: float = 1.0,
                    points: Optional[np.ndarray] = None,
                    out_path: str = "poses.ply", size: float = 0.05) -> str:
    """Write the PLY to `out_path` and, with matplotlib, `<out_path>.png`.
    Returns the PLY's path."""
    segs = [_box_segments(bound)]
    if bound > 1:
        segs.append(_box_segments(1.0))
    for pose in np.asarray(poses):
        segs.append(_camera_segments(np.asarray(pose, np.float64), size))
    segs = np.concatenate(segs, axis=0)  # [E, 2, 3]

    verts = segs.reshape(-1, 3)
    edges = np.arange(len(verts)).reshape(-1, 2)
    pts = (np.asarray(points).reshape(-1, 3) if points is not None
           else np.zeros((0, 3)))

    with open(out_path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts) + len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} 255 64 64\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 64 64 255\n")
        for e in edges:
            f.write(f"{e[0]} {e[1]}\n")

    try:
        import matplotlib
    except ImportError:
        return out_path  # the PLY is the artifact of record
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for s in segs:
        ax.plot(s[:, 0], s[:, 1], s[:, 2], "r-", lw=0.5)
    if len(pts):
        sub = pts[:: max(1, len(pts) // 5000)]
        ax.scatter(sub[:, 0], sub[:, 1], sub[:, 2], s=0.5, alpha=0.3)
    ax.set_title(f"{len(poses)} camera poses, bound={bound}")
    fig.savefig(out_path + ".png", dpi=120)
    plt.close(fig)
    return out_path
