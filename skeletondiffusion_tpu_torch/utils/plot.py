"""3D skeleton visualization: static pose plots and motion animations
(matplotlib); a copy of ``skeletondiffusion_tpu/utils/plot.py`` (reference
`src/utils/{plot,plot_parallel,image}.py`).  It takes numpy arrays (a
tensor's ``.cpu().numpy()``) and imports matplotlib and PIL only inside the
functions that draw: the package imports this module without them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_pose(ax, pose: np.ndarray, limbseq, left_right: Optional[Sequence[bool]] = None,
              color_left="#3498db", color_right="#e74c3c", alpha=1.0):
    """Draw one [J,3] pose as limb segments on a 3D axis."""
    pose = np.asarray(pose)
    for li, (a, b) in enumerate(np.asarray(limbseq)):
        color = color_right
        if left_right is not None and not left_right[b]:
            color = color_left
        ax.plot(
            [pose[a, 0], pose[b, 0]], [pose[a, 1], pose[b, 1]], [pose[a, 2], pose[b, 2]],
            color=color, alpha=alpha, linewidth=2,
        )


def _left_right_for(skeleton, mode: str = "node"):
    """left/right flags aligned with the limbseq space actually drawn:
    node-space poses need the NODE-reindexed flags (the per-joint list is
    indexed by ORIGINAL joint ids incl. the dropped root — using it with
    node indices shifts every color by one)."""
    if skeleton is None:
        return None
    if mode == "node" and not getattr(skeleton, "if_consider_hip", True):
        return getattr(skeleton, "left_right_limb_nodes", None)
    return getattr(skeleton, "left_right_limb", None)


def animate_motion(
    motions: Sequence[np.ndarray],
    skeleton,
    titles: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    fps: int = 25,
    mode: str = "node",
):
    """Side-by-side animation of [T,J,3] motions; saves gif/mp4 when
    ``out_path`` given, else returns the FuncAnimation.  Mirrors the
    reference's notebook visualization flow (`src/utils/plot.py`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    limbseq = skeleton.get_limbseq() if mode == "node" else skeleton.limbseq
    n = len(motions)
    fig = plt.figure(figsize=(4 * n, 4))
    axes = [fig.add_subplot(1, n, i + 1, projection="3d") for i in range(n)]
    T = max(len(m) for m in motions)

    all_pts = np.concatenate([np.asarray(m).reshape(-1, 3) for m in motions], axis=0)
    lo, hi = all_pts.min(0), all_pts.max(0)

    def draw(t):
        for i, (ax, motion) in enumerate(zip(axes, motions)):
            ax.clear()
            ax.set_xlim(lo[0], hi[0])
            ax.set_ylim(lo[1], hi[1])
            ax.set_zlim(lo[2], hi[2])
            ax.set_axis_off()
            if titles:
                ax.set_title(titles[i])
            plot_pose(ax, np.asarray(motion)[min(t, len(motion) - 1)], limbseq,
                      _left_right_for(skeleton, mode))
        return axes

    anim = FuncAnimation(fig, draw, frames=T, interval=1000 / fps)
    if out_path is not None:
        writer = "pillow" if out_path.endswith(".gif") else "ffmpeg"
        anim.save(out_path, writer=writer, fps=fps)
        plt.close(fig)
        return out_path
    return anim


def render_motion_frames(
    motion: np.ndarray,
    limbseq,
    left_right_limb: Optional[Sequence[bool]] = None,
    overlay: Optional[np.ndarray] = None,
    title: Optional[str] = None,
    figsize: float = 4.0,
) -> np.ndarray:
    """Render a [T,J,3] motion (optionally with a second overlaid motion,
    e.g. prediction over GT) to a stack of RGB frames [T,H,W,3] uint8 —
    the notebook-facing equivalent of reference
    `plot.py::get_np_frames_3d_projection` (`plot.py:103-199`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    motion = np.asarray(motion)
    fig = plt.figure(figsize=(figsize, figsize))
    ax = fig.add_subplot(projection="3d")
    pts = motion.reshape(-1, 3)
    if overlay is not None:
        pts = np.concatenate([pts, np.asarray(overlay).reshape(-1, 3)], axis=0)
    lo, hi = pts.min(0), pts.max(0)
    frames = []
    for t in range(len(motion)):
        ax.clear()
        ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
        ax.set_axis_off()
        if title:
            ax.set_title(f"{title}\nframe {t + 1}/{len(motion)}")
        plot_pose(ax, motion[t], limbseq, left_right_limb)
        if overlay is not None:
            plot_pose(ax, np.asarray(overlay)[min(t, len(overlay) - 1)], limbseq,
                      None, color_left="#2ecc71", color_right="#2ecc71", alpha=0.6)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
    plt.close(fig)
    return np.stack(frames)


def animate_prediction_grid(
    obs: np.ndarray,
    target: np.ndarray,
    preds: Sequence[np.ndarray],
    skeleton,
    titles: Optional[Sequence[str]] = None,
    out_path: Optional[str] = None,
    fps: int = 25,
    ncols: int = 3,
):
    """Reference `plot_parallel.py:44-121` flow: a grid of 3D axes, every
    cell first plays the OBSERVATION, then cell 0 shows GT with the closest
    prediction overlaid and the remaining cells play one prediction each
    (the diverse samples from ``metrics.ranking``).

    ``obs`` [To,J,3], ``target`` [Tp,J,3], ``preds`` list of [Tp,J,3].
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    limbseq = skeleton.get_limbseq()
    lr = _left_right_for(skeleton)
    n_cells = len(preds)
    nrows = (n_cells + ncols - 1) // ncols
    fig = plt.figure(figsize=(4 * ncols, 4 * nrows))
    axes = [fig.add_subplot(nrows, ncols, i + 1, projection="3d") for i in range(n_cells)]
    obs, target = np.asarray(obs), np.asarray(target)
    all_pts = np.concatenate(
        [obs.reshape(-1, 3), target.reshape(-1, 3)]
        + [np.asarray(p).reshape(-1, 3) for p in preds], axis=0)
    lo, hi = all_pts.min(0), all_pts.max(0)
    To, T = len(obs), len(obs) + len(target)

    def draw(t):
        for i, ax in enumerate(axes):
            ax.clear()
            ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1]); ax.set_zlim(lo[2], hi[2])
            ax.set_axis_off()
            base = titles[i] if titles else f"pred {i}"
            ax.set_title(f"{base}\nframe {t + 1}/{T}")
            if t < To:
                plot_pose(ax, obs[t], limbseq, lr)
            else:
                k = t - To
                if i == 0:  # GT + closest pred overlay (reference plot_gt_and_pred)
                    plot_pose(ax, target[k], limbseq, lr, alpha=0.5)
                plot_pose(ax, np.asarray(preds[i])[k], limbseq, lr)
        return axes

    anim = FuncAnimation(fig, draw, frames=T, interval=1000 / fps)
    if out_path is not None:
        writer = "pillow" if out_path.endswith(".gif") else "ffmpeg"
        anim.save(out_path, writer=writer, fps=fps)
        plt.close(fig)
        return out_path
    return anim


def save_img(img: np.ndarray, path: str) -> str:
    """Reference `image.py:7-12`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, np.asarray(img))
    return path


def save_gif(frames: np.ndarray, fps: int = 30, name: str = "out.gif") -> str:
    """[T,H,W,3] uint8 frames → gif; reference `image.py:14-23`."""
    from PIL import Image

    imgs = [Image.fromarray(np.asarray(f)) for f in frames]
    imgs[0].save(name, save_all=True, append_images=imgs[1:],
                 duration=max(int(1000 / fps), 1), loop=0)
    return name


def load_image(img_path: str) -> np.ndarray:
    """Reference `image.py:32-34`."""
    import matplotlib.pyplot as plt

    return np.asarray(plt.imread(img_path))


def _render_one(job) -> str:
    obs, target, preds, skeleton, titles, out_path, fps, ncols = job
    return animate_prediction_grid(
        obs, target, preds, skeleton, titles=titles, out_path=out_path,
        fps=fps, ncols=ncols,
    )


def render_prediction_grids_parallel(
    jobs: Sequence[dict],
    skeleton,
    n_workers: int = 4,
    fps: int = 25,
    ncols: int = 3,
) -> Sequence[str]:
    """Render MANY prediction-grid animations across processes — the
    reference fans its matplotlib rendering out with multiprocessing
    (`src/utils/plot_parallel.py`); a single grid takes seconds of pure
    host-side drawing, so visualizing a batch serially is minutes.

    ``jobs``: dicts with keys ``obs`` [To,J,3], ``target`` [Tp,J,3],
    ``preds`` (list of [Tp,J,3]), ``out_path`` and optional ``titles``.
    Returns the written paths in job order.
    """
    from multiprocessing import get_context

    packed = [
        (np.asarray(j["obs"]), np.asarray(j["target"]),
         [np.asarray(p) for p in j["preds"]], skeleton,
         j.get("titles"), j["out_path"], fps, ncols)
        for j in jobs
    ]
    if n_workers <= 1 or len(packed) <= 1:
        return [_render_one(job) for job in packed]
    # spawn: matplotlib Agg state must not be forked mid-figure
    with get_context("spawn").Pool(min(n_workers, len(packed))) as pool:
        return pool.map(_render_one, packed)
