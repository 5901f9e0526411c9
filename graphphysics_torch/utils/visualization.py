"""Prediction plots with matplotlib (counterpart of
``graphphysics_tpu/utils/visualization.py``): one scalar field of a
prediction on the mesh as a PNG (a shaded boundary surface for a 3-D mesh),
a short rollout as an animated GIF, and ``PredictionPlotCallback``, the
``Trainer``'s ``plot_callback``, which renders both after each validation
and hands them to a W&B logger where one is given.

matplotlib is imported inside the functions that draw, so importing this
module needs none (the machine with the card has none).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def _tri(cells: np.ndarray):
    c = np.asarray(cells)
    if c.shape[1] == 4:  # tetra -> surface triangles for plotting
        from graphphysics_torch.topology import tetra_to_faces

        c = tetra_to_faces(c)
    return c


def _is_3d(pts: np.ndarray) -> bool:
    return pts.shape[1] >= 3 and np.ptp(pts[:, 2]) > 1e-9


def _surface_tris(cells: np.ndarray) -> np.ndarray:
    """Triangles to render for a 3D mesh: the tetra BOUNDARY surface (what
    PyVista's camera sees, reference ``pyvista_mesh.py:6-49``), or the
    triangles themselves for a 3D shell mesh."""
    c = np.asarray(cells)
    if c.shape[1] == 4:
        from graphphysics_torch.topology import tetra_boundary_faces

        return tetra_boundary_faces(c)
    return c


def _render_3d_surface(ax, pts, tris, values, vmin=None, vmax=None):
    """Depth-sorted shaded boundary surface colored by the per-face mean of
    ``values`` (matplotlib Poly3DCollection does painter's-algorithm z-sort
    per draw — the off-screen-camera role of the reference's PyVista
    screenshots, ``callback.py:38-84``)."""
    surf = ax.plot_trisurf(
        pts[:, 0], pts[:, 1], pts[:, 2], triangles=tris,
        cmap="viridis", linewidth=0.0, antialiased=False,
    )
    face_vals = np.asarray(values)[tris].mean(axis=1)
    surf.set_array(face_vals)
    if vmin is not None:
        surf.set_clim(vmin, vmax)
    # equal aspect so geometry is recognizable
    ranges = np.ptp(pts, axis=0)
    ax.set_box_aspect(tuple(np.maximum(ranges, 1e-9)))
    return surf


def render_field_image(
    points: np.ndarray,
    cells: np.ndarray,
    values: np.ndarray,
    path: str,
    title: str = "",
) -> str:
    """Render one scalar field on the mesh to a PNG; returns the path.
    3D meshes render as a depth-sorted boundary surface in a 3D projection
    (reference renders these with PyVista off-screen cameras,
    ``callback.py:38-84``); 2D meshes as a gouraud ``tripcolor``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    fig = plt.figure(figsize=(6, 4), dpi=100)
    if _is_3d(pts):
        ax = fig.add_subplot(projection="3d")
        sc = _render_3d_surface(ax, pts, _surface_tris(cells), values)
    else:
        ax = fig.add_subplot()
        sc = ax.tripcolor(pts[:, 0], pts[:, 1], _tri(cells), values,
                          shading="gouraud")
        ax.set_aspect("equal")
    fig.colorbar(sc, ax=ax, shrink=0.7)
    ax.set_title(title)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def render_rollout_gif(
    points: np.ndarray,
    cells: np.ndarray,
    frames: np.ndarray,  # [T, N] scalar per frame
    path: str,
    fps: int = 4,
    title: str = "",
) -> str:
    """Short rollout animation (the reference's wandb.Video role,
    ``callback.py:90-150``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    pts = np.asarray(points)
    vmin, vmax = float(np.min(frames)), float(np.max(frames))
    fig = plt.figure(figsize=(6, 4), dpi=80)
    if _is_3d(pts):
        tris3d = _surface_tris(cells)
        ax = fig.add_subplot(projection="3d")

        def draw(k):
            ax.clear()
            ax.set_title(f"{title} t={k}")
            return [
                _render_3d_surface(
                    ax, pts, tris3d, frames[k], vmin=vmin, vmax=vmax
                )
            ]
    else:
        tri = _tri(cells)
        ax = fig.add_subplot()
        ax.set_aspect("equal")

        def draw(k):
            ax.clear()
            ax.set_title(f"{title} t={k}")
            return [
                ax.tripcolor(
                    pts[:, 0], pts[:, 1], tri, frames[k],
                    shading="gouraud", vmin=vmin, vmax=vmax,
                )
            ]

    ax.set_title(title)

    anim = animation.FuncAnimation(fig, draw, frames=len(frames))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


class PredictionPlotCallback:
    """Epoch-end hook: plot 1-step predictions for a few validation samples
    and a short rollout video (reference ``LogPyVistaPredictionsCallback``)."""

    def __init__(
        self,
        out_dir: str = "plots",
        indices: Optional[List[int]] = None,
        field: int = 0,
        rollout_steps: int = 20,
        wandb_logger=None,
    ):
        self.out_dir = out_dir
        self.indices = indices or [0]
        self.field = field
        self.rollout_steps = rollout_steps
        self.wandb_logger = wandb_logger

    def __call__(self, trainer, val_dataset, epoch: int, predictions: np.ndarray):
        """``predictions``: [T, N, d] rollout of trajectory 0."""
        try:
            raw = val_dataset._load(val_dataset.trajectory_indices(0)[0])
            cells = raw.tetra if raw.tetra is not None else raw.faces
            n = raw.num_nodes
            paths = []
            for t in self.indices:
                t = min(t, predictions.shape[0] - 1)
                p = render_field_image(
                    raw.pos, cells, predictions[t, :n, self.field],
                    os.path.join(self.out_dir, f"epoch{epoch}_step{t}.png"),
                    title=f"prediction[{self.field}] step {t}",
                )
                paths.append(p)
            gif = render_rollout_gif(
                raw.pos, cells,
                predictions[: self.rollout_steps, :n, self.field],
                os.path.join(self.out_dir, f"epoch{epoch}_rollout.gif"),
                title=f"rollout[{self.field}]",
            )
            paths.append(gif)
            if self.wandb_logger is not None and self.wandb_logger.run is not None:
                import wandb

                self.wandb_logger.log(
                    {
                        "predictions": [wandb.Image(p) for p in paths[:-1]],
                        "rollout": wandb.Video(gif),
                    }
                )
            return paths
        except Exception as e:  # plotting must never kill training
            print(f"[viz] prediction plot failed: {e}")
            return []
