"""Runtime distribution plot from benchmark CSVs (a copy of
``ba_path_planning_tpu.viz.boxplot``, which imports only numpy and, inside
its functions, matplotlib).

Consumes the flat benchmark CSV schema (columns
``N, trial_index, status, time_sec, K, T, h, error``) shared by the reference
harness and ours — the compatibility surface called out in SURVEY.md §6 — and
renders the same *presentation contract* (per-N runtime boxes, log-scaled y
axis, successful trials only, orange median / dashed green mean; see
the reference's ``viz/plot_runtime_boxplot.py`` for the
behaviour being matched).

The implementation is organised differently from the reference: instead of
handing raw sample lists to matplotlib, we reduce each N-group to a five-number
summary plus fliers up front (``summarize_group``) and draw from those stats
with ``Axes.bxp``.  That keeps the statistics available to callers (the batch
CLI prints them, tests assert on them) without re-deriving them from the
figure, and makes the plot cost independent of trial count.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: Whisker reach in IQR multiples (Tukey's convention).
WHISKER_IQR = 1.5
MEDIAN_COLOR = "#E67E22"
MEAN_COLOR = "#2ECC71"


@dataclass(frozen=True)
class GroupSummary:
    """Five-number summary (+ mean and fliers) for one vehicle count."""

    n_vehicles: int
    count: int
    q1: float
    median: float
    q3: float
    whisker_lo: float
    whisker_hi: float
    mean: float
    fliers: np.ndarray

    def as_bxp_dict(self) -> dict:
        return {
            "label": str(self.n_vehicles),
            "med": self.median,
            "q1": self.q1,
            "q3": self.q3,
            "whislo": self.whisker_lo,
            "whishi": self.whisker_hi,
            "mean": self.mean,
            "fliers": self.fliers,
        }


def summarize_group(n_vehicles: int, times: np.ndarray) -> GroupSummary:
    """Reduce one group's runtimes to the stats a box glyph needs."""
    t = np.asarray(times, dtype=float)
    q1, med, q3 = np.quantile(t, [0.25, 0.5, 0.75])
    reach = WHISKER_IQR * (q3 - q1)
    inside = t[(t >= q1 - reach) & (t <= q3 + reach)]
    lo = float(inside.min()) if inside.size else float(q1)
    hi = float(inside.max()) if inside.size else float(q3)
    return GroupSummary(
        n_vehicles=n_vehicles,
        count=int(t.size),
        q1=float(q1),
        median=float(med),
        q3=float(q3),
        whisker_lo=lo,
        whisker_hi=hi,
        mean=float(t.mean()),
        fliers=t[(t < lo) | (t > hi)],
    )


def _iter_csv_rows(data_dir: str):
    """Yield dict rows from every scp_benchmark_*.csv under ``data_dir``."""
    root = Path(data_dir)
    if not root.exists():
        raise FileNotFoundError(f"Directory does not exist: {data_dir}")
    files = sorted(root.glob("scp_benchmark_*.csv"))
    if not files:
        raise FileNotFoundError(f"No 'scp_benchmark_*.csv' files in {data_dir}")
    for path in files:
        with path.open(encoding="utf-8", newline="") as fh:
            yield from csv.DictReader(fh)


def load_rows_from_dir(data_dir: str) -> list[dict]:
    """All benchmark rows under ``data_dir`` (compatibility helper)."""
    rows = list(_iter_csv_rows(data_dir))
    if not rows:
        raise RuntimeError("No rows loaded.")
    return rows


def _parse_success(row: dict) -> tuple[int, float] | None:
    """(N, time_sec) for a well-formed successful row, else None."""
    if str(row.get("status", "")).strip().lower() != "success":
        return None
    try:
        n, t = int(row["N"]), float(row["time_sec"])
    except (KeyError, TypeError, ValueError):
        return None
    return (n, t) if math.isfinite(t) else None


def group_times_by_N(rows: list[dict]) -> dict[int, list[float]]:
    """{N: sorted successful runtimes}; malformed rows are dropped."""
    parsed = filter(None, map(_parse_success, rows))
    groups: dict[int, list[float]] = {}
    for n, t in parsed:
        groups.setdefault(n, []).append(t)
    if not groups:
        raise RuntimeError("No successful runs found.")
    return {n: sorted(groups[n]) for n in sorted(groups)}


def render_runtime_boxes(summaries: list[GroupSummary], out_path: str) -> str:
    """Draw the per-N runtime distribution figure and save it."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.lines import Line2D

    fig, ax = plt.subplots(figsize=(12, 7))
    artists = ax.bxp(
        [s.as_bxp_dict() for s in summaries],
        showmeans=True,
        meanline=True,
        shownotches=False,
        patch_artist=True,
        widths=0.6,
    )
    for box in artists["boxes"]:
        box.set(facecolor="white", edgecolor="black", linewidth=1.2)
    for med in artists["medians"]:
        med.set(color=MEDIAN_COLOR, linewidth=1.5)
    for mean in artists["means"]:
        mean.set(color=MEAN_COLOR, linewidth=1.5, linestyle="--")
    for part in ("whiskers", "caps"):
        for line in artists[part]:
            line.set(color="black", linewidth=1.0)
    for flier in artists["fliers"]:
        flier.set(marker="o", markerfacecolor="none",
                  markeredgecolor="black", alpha=0.35, markersize=5)

    ax.set_yscale("log")
    ax.set_xlabel("Number of robots N")
    ax.set_ylabel("Computation time per run [s] (log scale)")
    ax.set_title("SCP Computation Time vs Number of Robots")
    ax.grid(True, which="both", linestyle="--", alpha=0.4)
    ax.set_axisbelow(True)
    ax.legend(
        handles=[
            Line2D([], [], color=MEDIAN_COLOR, lw=1.5, label="Median"),
            Line2D([], [], color=MEAN_COLOR, lw=1.5, ls="--", label="Mean"),
        ],
        loc="upper left",
    )

    target = Path(out_path)
    target.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(target, dpi=400)
    plt.close(fig)
    return str(target)


def make_boxplot(data_dir: str, out_path: str) -> str:
    """One-call utility matching the reference ``make_boxplot`` surface."""
    groups = group_times_by_N(load_rows_from_dir(data_dir))
    summaries = [summarize_group(n, np.asarray(ts)) for n, ts in groups.items()]
    return render_runtime_boxes(summaries, out_path)
