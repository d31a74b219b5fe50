"""Runtime boxplot CLI of the PyTorch port: the reference's ``scp-boxplot``
console script (counterpart of ``ba_path_planning_tpu.cli.boxplot``, the
same flags).  It reads the schema-1.0 CSVs of either package's batch CLI.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", type=str, default="results/trial_2",
                   help="folder with scp_benchmark_*.csv")
    p.add_argument("--out-path", type=str, default="plots/scp_boxplot.pdf")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..viz.boxplot import make_boxplot
    try:
        saved = make_boxplot(args.data_dir, args.out_path)
    except (FileNotFoundError, RuntimeError) as e:
        print(f"Error: {e}")
        return 1
    print(f"Saved plot: {saved}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
