"""Trajectory / scenario visualization (matplotlib, host-side, offline); a
copy of ``ba_path_planning_tpu.viz.plots``.

Replicates the plots of the reference (``scp.py:619-840`` and
``position_generator.py:78-231``): quadrant-colored trajectories over the
20x20 layout (boundary box, corner circles, central diamond), time-snapshot
filmstrips, and the scenario start/goal plot.  Matplotlib is imported lazily
so the solver stack never depends on it.
"""

from __future__ import annotations

import numpy as np

# Same palette as the reference (position_generator.py:212-217)
QUADRANT_PALETTE = [
    (0.17, 0.28, 0.46),   # Q0 top-right
    (0.54, 0.31, 0.56),   # Q1 top-left
    (1.00, 0.39, 0.38),   # Q2 bottom-left
    (1.00, 0.65, 0.00),   # Q3 bottom-right
]


def quadrant_colors(initial_positions, center=(10.0, 10.0)):
    """Color per vehicle from the quadrant of its initial position
    (scp.py:619-641)."""
    cx, cy = center
    colors = []
    for x, y in np.asarray(initial_positions):
        if x >= cx and y >= cy:
            q = 0
        elif x < cx and y >= cy:
            q = 1
        elif x < cx and y < cy:
            q = 2
        else:
            q = 3
        colors.append(QUADRANT_PALETTE[q])
    return colors


def _draw_layout(ax, space_dims):
    """Boundary box, corner circles, central diamond (scp.py:670-713)."""
    from matplotlib.patches import Circle, Rectangle
    xmin, ymin, xmax, ymax = space_dims
    ax.add_patch(Rectangle((xmin, ymin), xmax - xmin, ymax - ymin,
                           linewidth=2, edgecolor="black", facecolor="none",
                           linestyle="--", alpha=0.7))
    centers = [(xmin + 3.5, ymin + 3.5), (xmax - 3.5, ymin + 3.5),
               (xmin + 3.5, ymax - 3.5), (xmax - 3.5, ymax - 3.5)]
    for c in centers:
        ax.add_patch(Circle(c, 2.5, linewidth=1.5, edgecolor="grey",
                            facecolor="none", alpha=0.7))
    cx, cy = (xmin + xmax) / 2.0, (ymin + ymax) / 2.0
    s = 6.0 / np.sqrt(2.0)
    vx = [cx, cx + s, cx, cx - s, cx]
    vy = [cy + s, cy, cy - s, cy, cy + s]
    ax.plot(vx, vy, linewidth=1.5, color="grey", alpha=0.7)


def plot_trajectories(positions, space_dims, min_distance,
                      save_path="trajectories.pdf", show=False):
    """(N, K, 2) trajectory plot with start/stop markers and safety radii
    (scp.py:644-775)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.lines as mlines
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    positions = np.asarray(positions)
    N = positions.shape[0]
    colors = quadrant_colors(positions[:, 0])

    fig, ax = plt.subplots(figsize=(10, 10))
    ax.set_aspect("equal")
    xmin, ymin, xmax, ymax = space_dims
    ax.set_xlim(xmin - 1, xmax + 1)
    ax.set_ylim(ymin - 1, ymax + 1)
    _draw_layout(ax, space_dims)

    for i in range(N):
        ax.scatter(*positions[i, 0], marker="o", s=100, color=colors[i])
        ax.add_patch(Circle(positions[i, 0], min_distance, color=colors[i],
                            alpha=0.1, fill=True))
        ax.scatter(*positions[i, -1], marker="s", s=100, color=colors[i])
        ax.add_patch(Circle(positions[i, -1], min_distance, color=colors[i],
                            alpha=0.1, fill=True))
        ax.plot(positions[i, :, 0], positions[i, :, 1], color=colors[i],
                linewidth=1.5, alpha=0.8)

    handles = [
        mlines.Line2D([], [], color="black", marker="o", linestyle="None",
                      markersize=8, label="Start"),
        mlines.Line2D([], [], color="black", marker="s", linestyle="None",
                      markersize=8, label="Stop"),
    ]
    ax.legend(handles=handles, loc="lower right")
    ax.set_xlabel(r"$x$ [m]")
    ax.set_ylabel(r"$y$ [m]")
    ax.set_title("2D Collision-Free Trajectories")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=400, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax


def plot_time_snapshots(positions, space_dims, min_distance, time_step,
                        num_snapshots=5, save_path=None, show=False):
    """Filmstrip of evenly spaced time frames (scp.py:777-840)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    positions = np.asarray(positions)
    N, K, _ = positions.shape
    colors = quadrant_colors(positions[:, 0])
    frames = np.linspace(0, K - 1, num_snapshots, dtype=int)

    fig, axes = plt.subplots(1, num_snapshots, figsize=(15, 3))
    if num_snapshots == 1:
        axes = [axes]
    xmin, ymin, xmax, ymax = space_dims
    for f, frame in enumerate(frames):
        ax = axes[f]
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_xlim([xmin - 0.5, xmax + 0.5])
        ax.set_ylim([ymin - 0.5, ymax + 0.5])
        ax.set_title(f"t = {frame * time_step:.1f}s")
        for i in range(N):
            pos = positions[i, frame]
            ax.add_patch(Circle(pos, 0.20, color=colors[i], alpha=0.7))
            ax.add_patch(Circle(pos, min_distance, color=colors[i], alpha=0.1,
                                fill=True))
            if frame > 0:
                ax.plot(positions[i, :frame + 1, 0],
                        positions[i, :frame + 1, 1], "-", color=colors[i],
                        alpha=0.7, linewidth=1)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, axes


def plot_scenario(initial_positions, final_positions, min_distance=0.4,
                  save_path=None, show=False):
    """Start/goal layout plot (position_generator.py:78-170)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.lines as mlines
    import matplotlib.pyplot as plt
    from matplotlib.patches import Circle

    init = np.asarray(initial_positions)
    final = np.asarray(final_positions)
    colors = quadrant_colors(init)

    fig, ax = plt.subplots(figsize=(10, 10))
    _draw_layout(ax, (0.0, 0.0, 20.0, 20.0))
    for i in range(len(init)):
        ax.scatter(*init[i], marker="o", s=150, color=colors[i])
        ax.add_patch(Circle(init[i], min_distance / 2, edgecolor=colors[i],
                            facecolor="none", alpha=0.3))
        ax.scatter(*final[i], marker="s", s=150, color=colors[i])
        ax.add_patch(Circle(final[i], min_distance / 2, edgecolor=colors[i],
                            facecolor="none", alpha=0.3))
        ax.plot([init[i, 0], final[i, 0]], [init[i, 1], final[i, 1]],
                color=colors[i], alpha=0.3, linewidth=1.5)
    ax.legend(handles=[
        mlines.Line2D([], [], color="black", marker="o", ls="None",
                      label="Start"),
        mlines.Line2D([], [], color="black", marker="s", ls="None",
                      label="Stop"),
    ], loc="lower right")
    ax.set_xlim(-1, 21)
    ax.set_ylim(-1, 21)
    ax.set_aspect("equal")
    ax.set_xlabel(r"$x$ [m]")
    ax.set_ylabel(r"$y$ [m]")
    ax.set_title("Initial and Final Craft Positions")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=400)
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig, ax
