"""Visualization: BEV + camera renders of predictions, and result videos.

Capability match for the reference's `tools/render.py`, `tools/visual.py` and
`create_video.py`: side-by-side camera + BEV views of predicted/GT boxes from
a results file, and an animation over a scene. ffmpeg is not assumed — videos
are written as GIF via PIL (drop-in mp4 when ffmpeg exists).

Usage:
  python -m racformer_tpu_torch.tools.visualize bev --results results.pkl --out out/
  python -m racformer_tpu_torch.tools.visualize video --results results.pkl --out scene.gif

A copy of `racformer_tpu/tools/visualize.py` (the port imports nothing of
the JAX package); matplotlib and Pillow are imported only inside the
functions that draw or write. `tests/test_torch_tools.py` holds it equal
to its original.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

CLASS_COLORS = {
    0: "#d62728", 1: "#ff7f0e", 2: "#8c564b", 3: "#e377c2", 4: "#7f7f7f",
    5: "#2ca02c", 6: "#17becf", 7: "#1f77b4", 8: "#bcbd22", 9: "#9467bd",
}


def box_corners_bev(box: np.ndarray) -> np.ndarray:
    """box: [>=7] (x, y, z, w, l, h, yaw) -> [4, 2] BEV corners."""
    x, y, w, l, yaw = box[0], box[1], box[3], box[4], box[6]
    dx = np.array([l, l, -l, -l]) / 2
    dy = np.array([w, -w, -w, w]) / 2
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([x + dx * c - dy * s, y + dx * s + dy * c], 1)


def render_bev(
    pred_boxes: np.ndarray,
    pred_labels: np.ndarray,
    pred_scores: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,
    radar_points: Optional[np.ndarray] = None,
    pc_range: float = 51.2,
    ax=None,
):
    """Draw one sample's BEV view. Returns the matplotlib axis."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(-pc_range, pc_range)
    ax.set_ylim(-pc_range, pc_range)
    ax.set_aspect("equal")
    ax.set_facecolor("#111111")
    if radar_points is not None and len(radar_points):
        ax.scatter(radar_points[:, 0], radar_points[:, 1], s=1.5,
                   c="#00e0ff", alpha=0.6, linewidths=0)
    if gt_boxes is not None:
        for b in gt_boxes:
            cor = box_corners_bev(b)
            ax.add_patch(__import__("matplotlib.patches", fromlist=["Polygon"])
                         .Polygon(cor, fill=False, edgecolor="#ffffff",
                                  linewidth=0.8, linestyle="--"))
    for i, b in enumerate(pred_boxes):
        cor = box_corners_bev(b)
        color = CLASS_COLORS.get(int(pred_labels[i]), "#d62728")
        alpha = float(pred_scores[i]) if pred_scores is not None else 1.0
        ax.add_patch(__import__("matplotlib.patches", fromlist=["Polygon"])
                     .Polygon(cor, fill=False, edgecolor=color,
                              linewidth=1.2, alpha=min(1.0, 0.3 + alpha)))
    ax.plot(0, 0, marker="^", color="#ffd700", markersize=8)
    return ax


def project_boxes_to_image(boxes: np.ndarray, lidar2img: np.ndarray,
                           hw) -> List[np.ndarray]:
    """3D boxes -> list of [8, 2] image-space corner arrays (or None)."""
    H, W = hw
    out = []
    for b in boxes:
        x, y, z, w, l, h, yaw = b[:7]
        dx = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
        dy = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
        dz = np.array([0, 0, 0, 0, h, h, h, h])
        c, s = np.cos(yaw), np.sin(yaw)
        pts = np.stack([x + dx * c - dy * s, y + dx * s + dy * c, z + dz], 1)
        hom = np.concatenate([pts, np.ones((8, 1))], 1) @ lidar2img.T
        depth = hom[:, 2]
        if (depth < 0.5).all():
            out.append(None)
            continue
        uv = hom[:, :2] / np.maximum(depth[:, None], 0.5)
        out.append(uv)
    return out


def render_sample(sample: Dict, pred: Dict, out_path: str, score_thr=0.3):
    """Side-by-side cameras + BEV figure for one sample."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keep = np.asarray(pred.get("valid", np.ones(len(pred["scores"]), bool)))
    keep &= np.asarray(pred["scores"]) > score_thr
    boxes = np.asarray(pred["bboxes"])[keep]
    labels = np.asarray(pred["labels"])[keep]
    scores = np.asarray(pred["scores"])[keep]

    # sample tensors use per-frame layout: imgs [N, H, W, 3] (BGR),
    # lidar2img [N, 4, 4], radar_points [P, 7]
    imgs = sample.get("imgs")
    N = imgs.shape[0] if imgs is not None else 0
    cols = max(N, 1)
    fig = plt.figure(figsize=(4 * cols, 8))
    for n in range(N):
        ax = fig.add_subplot(2, cols, n + 1)
        img = imgs[n][..., ::-1].astype(np.uint8)  # BGR->RGB
        ax.imshow(img)
        ax.axis("off")
        l2i = np.asarray(sample["lidar2img"])[n]
        for uv, lab in zip(project_boxes_to_image(boxes, l2i, img.shape[:2]), labels):
            if uv is None:
                continue
            color = CLASS_COLORS.get(int(lab), "#d62728")
            for a, b in [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                         (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]:
                ax.plot(uv[[a, b], 0], uv[[a, b], 1], color=color, linewidth=0.7)
        ax.set_xlim(0, img.shape[1])
        ax.set_ylim(img.shape[0], 0)
    ax = fig.add_subplot(2, 1, 2)
    render_bev(boxes, labels, scores,
               gt_boxes=sample.get("gt_bboxes"),
               radar_points=sample.get("radar_points"), ax=ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def create_video(frame_paths: List[str], out_path: str, fps: int = 4):
    """Assemble rendered frames into a GIF (mp4 when ffmpeg is present)."""
    from PIL import Image

    if out_path.endswith(".mp4"):
        import shutil
        import subprocess

        if shutil.which("ffmpeg"):
            list_file = out_path + ".txt"
            with open(list_file, "w") as f:
                for p in frame_paths:
                    f.write(f"file '{os.path.abspath(p)}'\n")
            subprocess.run(
                ["ffmpeg", "-y", "-r", str(fps), "-f", "concat", "-safe", "0",
                 "-i", list_file, "-pix_fmt", "yuv420p", out_path], check=True)
            os.remove(list_file)
            return
        out_path = out_path[:-4] + ".gif"
    frames = [Image.open(p) for p in frame_paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["bev", "video"])
    ap.add_argument("--results", required=True,
                    help="pickle: list of (sample, pred) dicts")
    ap.add_argument("--out", required=True)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--fps", type=int, default=4)
    args = ap.parse_args()

    with open(args.results, "rb") as f:
        results = pickle.load(f)

    if args.mode == "bev":
        os.makedirs(args.out, exist_ok=True)
        for i, (sample, pred) in enumerate(results):
            render_sample(sample, pred, os.path.join(args.out, f"{i:05d}.png"),
                          args.score_thr)
    else:
        tmp = args.out + "_frames"
        os.makedirs(tmp, exist_ok=True)
        paths = []
        for i, (sample, pred) in enumerate(results):
            p = os.path.join(tmp, f"{i:05d}.png")
            render_sample(sample, pred, p, args.score_thr)
            paths.append(p)
        create_video(paths, args.out, args.fps)


if __name__ == "__main__":
    main()
