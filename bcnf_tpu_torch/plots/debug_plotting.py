"""Visual debugging of the simulator and camera (port of
`bcnf_tpu/plots/debug_plotting.py`; reference
`src/bcnf/debug/debug_plotting.py:7-56`): a trajectory comparison, one
camera frame, and a video as a GIF. matplotlib is imported only when a
figure is drawn.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import matplotlib.pyplot as plt


def debug_plotting(
    trajectory: np.ndarray,
    second_trajectory: np.ndarray | None = None,
    labels: tuple[str, str] = ("trajectory", "comparison"),
) -> "plt.Figure":
    """3D + per-axis 2D comparison of one or two `(T, 3)` trajectories."""
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 8))
    ax3d = fig.add_subplot(2, 2, 1, projection="3d")
    ax3d.plot(*np.asarray(trajectory).T, label=labels[0])
    if second_trajectory is not None:
        ax3d.plot(*np.asarray(second_trajectory).T, label=labels[1])
    ax3d.set_xlabel("x")
    ax3d.set_ylabel("y")
    ax3d.set_zlabel("z")
    ax3d.legend()

    for i, axis_name in enumerate("xyz"):
        ax = fig.add_subplot(2, 2, 2 + i)
        ax.plot(np.asarray(trajectory)[:, i], label=labels[0])
        if second_trajectory is not None:
            ax.plot(np.asarray(second_trajectory)[:, i], label=labels[1])
        ax.set_xlabel("step")
        ax.set_ylabel(axis_name)
    fig.tight_layout()
    return fig


def show_camera_image(image: np.ndarray, ax: "plt.Axes | None" = None) -> "plt.Figure":
    """Render a single `(H, W)` camera frame (reference `debug_plotting.py:45-56`)."""
    import matplotlib.pyplot as plt

    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4.5))
    else:
        fig = ax.figure
    ax.imshow(np.asarray(image), cmap="hot")
    ax.set_xlabel("horizontal angle")
    ax.set_ylabel("vertical angle")
    return fig


def make_gif(video: np.ndarray, path: str, interval_ms: int = 33) -> None:
    """Save a `(T, H, W)` video as a GIF (reference `record_trajectory`'s
    make_gif branch, `src/bcnf/simulation/camera.py:60-70`), with the pillow
    writer."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4.5))
    frames = [[ax.imshow(f, cmap="hot", animated=True)] for f in np.asarray(video)]
    ani = animation.ArtistAnimation(fig, frames, interval=interval_ms, blit=True, repeat_delay=3000)
    ani.save(path, writer="pillow")
    plt.close(fig)
