"""Detection curve plots: PR / F1 / Precision / Recall PNGs
(``prpe_tpu/eval/plots.py``).

Host-side matplotlib rendering of the :class:`~prpe_tpu_torch.eval.map.DetectionCurves`
data, the same four files as the reference's standalone test entry point
(reference: training/yolopt/util.py:180-222 ``plot_pr_curve``/``plot_curve``,
called from ``compute_ap(plot=True)`` at util.py:285-291):

  PR_curve.png   precision against recall at IoU 0.5, per class and the mean
  F1_curve.png   F1 against confidence, the smoothed mean with its maximum
  P_curve.png    precision against confidence
  R_curve.png    recall against confidence

matplotlib (Agg) is imported when a plot is drawn, not with this module: a
host without it imports the package, and ``save_detection_curves`` raises
an ``ImportError`` naming the package and the files it would have written.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Optional, Sequence

import numpy as np

from prpe_tpu_torch.eval.map import DetectionCurves, smooth

# a legend stays readable only for few classes (reference: util.py:184)
_MAX_LEGEND_CLASSES = 20
CURVE_FILES = {"PR_curve": "PR_curve.png", "F1_curve": "F1_curve.png",
               "P_curve": "P_curve.png", "R_curve": "R_curve.png"}


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot

    return pyplot


def _class_names(curves: DetectionCurves, names: Optional[Sequence[str]]):
    if not names:
        return [str(int(c)) for c in curves.classes]
    return [names[int(c)] if int(c) < len(names) else str(int(c)) for c in curves.classes]


def plot_pr_curve(curves: DetectionCurves, names, path) -> None:
    """Precision-recall plot at IoU 0.5 with the per-class AP in the legend."""
    pyplot = _pyplot()
    fig, ax = pyplot.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    labels = _class_names(curves, names)
    if 0 < len(labels) <= _MAX_LEGEND_CLASSES:
        for i, label in enumerate(labels):
            ax.plot(curves.recall_grid, curves.pr_precision[i], linewidth=1,
                    label=f"{label} {curves.ap[i, 0]:.3f}")
    else:
        ax.plot(curves.recall_grid, curves.pr_precision.T, linewidth=1, color="grey")
    ax.plot(curves.recall_grid, curves.pr_precision.mean(0), linewidth=3, color="blue",
            label=f"all classes {curves.ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    ax.set_title("Precision-Recall Curve")
    fig.savefig(path, dpi=250)
    pyplot.close(fig)


def plot_metric_curve(curves: DetectionCurves, metric: np.ndarray, names, path,
                      y_label: str) -> None:
    """Metric-against-confidence plot with the smoothed mean over classes and
    the confidence that maximises it in the legend (reference:
    util.py:200-222)."""
    pyplot = _pyplot()
    fig, ax = pyplot.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    labels = _class_names(curves, names)
    if 0 < len(labels) <= _MAX_LEGEND_CLASSES:
        for i, label in enumerate(labels):
            ax.plot(curves.conf_grid, metric[i], linewidth=1, label=label)
    else:
        ax.plot(curves.conf_grid, metric.T, linewidth=1, color="grey")
    y = smooth(metric.mean(0), f=0.05)
    ax.plot(curves.conf_grid, y, linewidth=3, color="blue",
            label=f"all classes {y.max():.3f} at {curves.conf_grid[y.argmax()]:.3f}")
    ax.set_xlabel("Confidence")
    ax.set_ylabel(y_label)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    ax.set_title(f"{y_label}-Confidence Curve")
    fig.savefig(path, dpi=250)
    pyplot.close(fig)


def save_detection_curves(curves: Optional[DetectionCurves], out_dir,
                          names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Write the four curve PNGs into ``out_dir``: {plot name: path}; empty
    when ``curves`` is None (no data). Raises ``ImportError`` where
    matplotlib is missing, before writing anything."""
    if curves is None:
        return {}
    out = pathlib.Path(out_dir)
    paths = {k: out / f for k, f in CURVE_FILES.items()}
    try:
        _pyplot()
    except ImportError as e:
        raise ImportError(
            "save_detection_curves needs matplotlib, which is not installed; it would "
            f"have written {', '.join(str(p) for p in paths.values())}") from e
    out.mkdir(parents=True, exist_ok=True)
    plot_pr_curve(curves, names, paths["PR_curve"])
    plot_metric_curve(curves, curves.f1, names, paths["F1_curve"], "F1")
    plot_metric_curve(curves, curves.precision, names, paths["P_curve"], "Precision")
    plot_metric_curve(curves, curves.recall, names, paths["R_curve"], "Recall")
    return {k: str(v) for k, v in paths.items()}
