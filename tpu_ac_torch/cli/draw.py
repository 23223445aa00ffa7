"""Result-plot CLI (port of ``tpu_ac.cli.draw``; Anomaly-Clustering/
utils/draw.py as a command).

Reads a tau-sweep result CSV (ours, or the reference's GBK-encoded ones)
and writes metric-vs-tau curves per category.
"""

from __future__ import annotations

import argparse

from tpu_ac_torch.viz import draw_metrics, read_results_csv


def main(argv=None) -> None:
    p = argparse.ArgumentParser("tau-sweep result plots")
    p.add_argument("csv", help="tau_result.csv path")
    p.add_argument("--metric", default="NMI", choices=["NMI", "ARI", "F1"])
    p.add_argument("--categories", nargs="+", default=None,
                   help="subset (default: every category in the CSV)")
    p.add_argument("--out", default="tau_sweep.png")
    p.add_argument("--gbk", action="store_true",
                   help="read a reference GBK-encoded CSV")
    args = p.parse_args(argv)

    results = read_results_csv(args.csv, encoding="gbk" if args.gbk
                               else "utf-8")
    cats = args.categories
    if cats is None:
        cats = sorted({c for rows in results.values() for c in rows
                       if not c.startswith("MVTec(")})
    draw_metrics(results, cats, args.metric, save_path=args.out)
    print(f"wrote {args.out} ({args.metric}, {len(cats)} categories, "
          f"{len(results)} tau values)")


if __name__ == "__main__":
    main()
