"""Eval diagnostics: PR curves, TP-error curves, and the per-class results
table.

Capability match for the reference's plotting ring
(the reference's `tools/render.py:208-441`: class_pr_curve, class_tp_curve,
dist_pr_curve, summary_plot, detailed_results_table_tex), consuming the curve
dicts `eval/metrics.py::nuscenes_metrics(..., return_curves=True)` produces
(the devkit's DetectionMetricDataList equivalent).

Conventions: one axis per panel, fixed categorical color order (Okabe-Ito,
colorblind-safe), a legend on every multi-series panel, recessive grid.

CLI:
  python -m racformer_tpu_torch.tools.eval_plots dump.pkl outdir/
where dump.pkl is the `(preds, gts)` pickle `val.py --dump-eval` writes.

A copy of `racformer_tpu/tools/eval_plots.py` (the port imports nothing of
the JAX package); matplotlib is imported only inside the functions that
draw. `tests/test_torch_tools.py` holds it equal to its original.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from ..eval.metrics import (CLASS_NAMES, DIST_THRESHOLDS, MIN_PRECISION,
                            MIN_RECALL, TP_THRESHOLD)

# Okabe-Ito, fixed assignment order (never cycled)
_COLORS = ("#0072B2", "#E69F00", "#009E73", "#CC79A7", "#D55E00",
           "#56B4E9", "#F0E442", "#000000")
_TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
_TP_LABELS = dict(trans_err="ATE (m)", scale_err="ASE (1-IoU)",
                  orient_err="AOE (rad)", vel_err="AVE (m/s)",
                  attr_err="AAE (1-acc)")

REC = np.linspace(0, 1, 101)


def _ax_style(ax):
    ax.grid(True, alpha=0.25, linewidth=0.5)
    ax.spines[["top", "right"]].set_visible(False)


def class_pr_curve(curves: Dict, per_class: Dict, class_name: str,
                   savepath: str | None = None, ax=None):
    """Precision/recall of one class at every distance threshold
    (render.py:208-241)."""
    import matplotlib.pyplot as plt

    own = ax is None
    if own:
        _, ax = plt.subplots(figsize=(5, 4))
    for i, th in enumerate(DIST_THRESHOLDS):
        md = curves.get((class_name, th))
        if md is None:
            continue
        ap = per_class.get(class_name, {}).get(f"AP@{th}", float("nan"))
        ax.plot(REC, md["precision"], color=_COLORS[i], linewidth=2,
                label=f"{th:.1f} m  (AP {ap:.3f})")
    ax.axhline(MIN_PRECISION, color="0.6", linestyle="--", linewidth=1)
    ax.axvline(MIN_RECALL, color="0.6", linestyle="--", linewidth=1)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title(class_name)
    ax.legend(frameon=False, fontsize=8)
    _ax_style(ax)
    if own and savepath:
        plt.savefig(savepath, bbox_inches="tight", dpi=150)
        plt.close()


def class_tp_curve(curves: Dict, per_class: Dict, class_name: str,
                   savepath: str | None = None, ax=None):
    """TP-error curves vs recall at the 2 m threshold (render.py:245-300);
    the dashed vertical line marks the class's max achieved recall."""
    import matplotlib.pyplot as plt

    own = ax is None
    if own:
        _, ax = plt.subplots(figsize=(5, 4))
    md = curves.get((class_name, TP_THRESHOLD))
    if md is None:
        return
    nz = np.nonzero(md["confidence"])[0]
    last = int(nz[-1]) if len(nz) else 0
    first = int(MIN_RECALL * 100) + 1
    ymax = 1.0
    for i, key in enumerate(_TP_METRICS):
        val = per_class.get(class_name, {}).get(key)
        if val is None:  # excluded for this class (cone/barrier rules)
            continue
        sl = slice(first, last + 1)
        if last >= first:
            ax.plot(REC[sl], md[key][sl], color=_COLORS[i], linewidth=2,
                    label=f"{_TP_LABELS[key]}: {val:.3f}")
            ymax = max(ymax, float(np.max(md[key][sl])) * 1.1)
    ax.axvline(last / 100.0, color="0.6", linestyle="--", linewidth=1)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, ymax)
    ax.set_xlabel("recall")
    ax.set_ylabel("error")
    ax.set_title(f"{class_name} @ {TP_THRESHOLD:.1f} m")
    ax.legend(frameon=False, fontsize=8)
    _ax_style(ax)
    if own and savepath:
        plt.savefig(savepath, bbox_inches="tight", dpi=150)
        plt.close()


def dist_pr_curve(curves: Dict, per_class: Dict, dist_th: float,
                  savepath: str | None = None,
                  class_names: Sequence[str] = CLASS_NAMES):
    """All classes' PR curves at one threshold (render.py:304-337)."""
    import matplotlib.pyplot as plt

    _, ax = plt.subplots(figsize=(6.5, 5))
    for i, name in enumerate(class_names):
        md = curves.get((name, dist_th))
        if md is None:
            continue
        ap = per_class.get(name, {}).get(f"AP@{dist_th}", float("nan"))
        ax.plot(REC, md["precision"], color=_COLORS[i % len(_COLORS)],
                linewidth=2,
                linestyle="-" if i < len(_COLORS) else "--",
                label=f"{name} (AP {ap:.3f})")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title(f"PR @ {dist_th:.1f} m")
    ax.legend(frameon=False, fontsize=8)
    _ax_style(ax)
    if savepath:
        plt.savefig(savepath, bbox_inches="tight", dpi=150)
        plt.close()


def summary_plot(curves: Dict, per_class: Dict, savepath: str | None = None,
                 class_names: Sequence[str] = CLASS_NAMES):
    """Per-class (PR, TP) panel grid (render.py:341-376)."""
    import matplotlib.pyplot as plt

    names = [n for n in class_names if any(k[0] == n for k in curves)]
    if not names:
        return
    fig, axes = plt.subplots(len(names), 2,
                             figsize=(10, 3.6 * len(names)), squeeze=False)
    for r, name in enumerate(names):
        class_pr_curve(curves, per_class, name, ax=axes[r][0])
        class_tp_curve(curves, per_class, name, ax=axes[r][1])
    fig.tight_layout()
    if savepath:
        fig.savefig(savepath, bbox_inches="tight", dpi=150)
        plt.close(fig)


def detailed_results_table_tex(per_class: Dict, metrics: Dict,
                               output_path: str,
                               class_names: Sequence[str] = CLASS_NAMES):
    """Per-class AP/ATE/ASE/AOE/AVE/AAE LaTeX table (render.py:380-441)."""
    rows = []
    for name in class_names:
        pc = per_class.get(name)
        if pc is None:
            continue
        cells = [name.replace("_", " "), f"{pc.get('AP', float('nan')):.3f}"]
        for key in _TP_METRICS:
            v = pc.get(key)
            cells.append("N/A" if v is None else f"{v:.3f}")
        rows.append(" & ".join(cells) + r" \\")
    lines = [
        r"\begin{table}[]", r"\small",
        r"\begin{tabular}{lcccccc}", r"\toprule",
        r"Class & AP & ATE & ASE & AOE & AVE & AAE \\",
        r"\midrule",
        *rows,
        r"\midrule",
        (f"\\textbf{{Mean}} & {metrics.get('mAP', 0):.3f} & "
         f"{metrics.get('mATE', 1):.3f} & {metrics.get('mASE', 1):.3f} & "
         f"{metrics.get('mAOE', 1):.3f} & {metrics.get('mAVE', 1):.3f} & "
         f"{metrics.get('mAAE', 1):.3f} \\\\"),
        r"\bottomrule", r"\end{tabular}",
        (f"\\caption{{mAP {metrics.get('mAP', 0):.4f}, "
         f"NDS {metrics.get('NDS', 0):.4f}}}"),
        r"\end{table}", "",
    ]
    with open(output_path, "w") as f:
        f.write("\n".join(lines))


def render_all(metrics_with_curves: Dict, outdir: str,
               class_names: Sequence[str] = CLASS_NAMES):
    """Write the full devkit plot set into `outdir`."""
    import matplotlib
    matplotlib.use("Agg")

    curves = metrics_with_curves["curves"]
    per_class = metrics_with_curves["per_class"]
    os.makedirs(outdir, exist_ok=True)
    for name in class_names:
        if not any(k[0] == name for k in curves):
            continue
        class_pr_curve(curves, per_class, name,
                       os.path.join(outdir, f"{name}_pr.png"))
        class_tp_curve(curves, per_class, name,
                       os.path.join(outdir, f"{name}_tp.png"))
    for th in DIST_THRESHOLDS:
        dist_pr_curve(curves, per_class, th,
                      os.path.join(outdir, f"dist_pr_{th}.png"),
                      class_names=class_names)
    summary_plot(curves, per_class, os.path.join(outdir, "summary.png"),
                 class_names=class_names)
    detailed_results_table_tex(per_class, metrics_with_curves,
                               os.path.join(outdir, "metrics_table.tex"),
                               class_names=class_names)


def main():
    import argparse
    import pickle

    from ..eval.metrics import nuscenes_metrics

    ap = argparse.ArgumentParser()
    ap.add_argument("dump", help="val.py --dump-eval pickle of (preds, gts)")
    ap.add_argument("outdir")
    ap.add_argument("--front-only", action="store_true")
    args = ap.parse_args()
    with open(args.dump, "rb") as f:
        preds, gts = pickle.load(f)
    m = nuscenes_metrics(preds, gts, front_only=args.front_only,
                         return_curves=True)
    render_all(m, args.outdir)
    print({k: round(v, 4) for k, v in m.items()
           if isinstance(v, float)})


if __name__ == "__main__":
    main()
