"""Publication figures for the eval suite (matplotlib, headless).

A copy of ``backpacks_flash_attn_tpu/eval/plots.py``: numpy arrays in,
files out, on the host only.

The reference ships one-off scripts with hardcoded data arrays
(training/plot_topic.py, training/plot_gender.py, training/src/make_pca.py
`pca_plot`, training/src/visualize_sim.py heatmaps) plus LaTeX tables pasted
by hand. Here each figure is a function of the arrays the eval modules
already return, so the same code renders the paper figures from fresh runs:

    eval/control.py   -> plot_control_frontier
    eval/genderbias.py-> plot_next_token_distributions
    eval/visualize.py -> plot_sense_pca / plot_similarity_heatmap /
                         plot_localization
    eval/similarity.py-> latex_table

Everything takes/returns plain numpy + paths; nothing runs on a device.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

# palette from the reference's figures (plot_topic.py:54,70-71)
_COLORS = ("#593C8F", "#DB5461", "#171738", "#8EF9F3", "#041B15")


def _plt():
    import matplotlib
    matplotlib.use("Agg")  # headless: never require a display
    import matplotlib.pyplot as plt
    small, medium, bigger = 13, 14, 15
    plt.rc("font", size=small, family="serif")
    plt.rc("axes", titlesize=small, labelsize=medium)
    plt.rc("xtick", labelsize=small)
    plt.rc("ytick", labelsize=small)
    plt.rc("legend", fontsize=small)
    plt.rc("figure", titlesize=bigger)
    return plt


def _save(fig, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=300 if path.endswith(".png") else None)
    import matplotlib.pyplot as plt
    plt.close(fig)
    return path


def plot_control_frontier(curves: Mapping[str, Dict[str, Sequence[float]]],
                          path: str, *,
                          xlabel: str = "Average Control Success",
                          ylabel: str = "MAUVE",
                          title: str = "Topic Control in Generation",
                          annotate_start: bool = True) -> str:
    """Control-success vs text-quality frontier, one line per method
    (reference: training/plot_topic.py:68-72). `curves` maps a label to
    {'success': [...], 'quality': [...]} over increasing control strength —
    e.g. eval/control.py strengths 0-3 with eval/mauve.py scores."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 4))
    markers = "soD^v"
    for i, (label, c) in enumerate(curves.items()):
        x = np.asarray(c["success"], np.float64)
        y = np.asarray(c["quality"], np.float64)
        ax.plot(x, y, label=label, marker=markers[i % len(markers)],
                linewidth=2, color=_COLORS[i % len(_COLORS)])
        if annotate_start and len(x):
            ax.annotate("unmodified", (x[0], y[0]), textcoords="offset points",
                        xytext=(6, -12), fontsize=10,
                        color=_COLORS[i % len(_COLORS)])
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    ax.spines[["top", "right"]].set_visible(False)
    return _save(fig, path)


def plot_next_token_distributions(dists: Sequence[Mapping[str, float]],
                                  path: str, *,
                                  panel_titles: Optional[Sequence[str]] = None,
                                  top_k: int = 9,
                                  ylabel: str = "Probability") -> str:
    """Side-by-side next-token bar panels across intervention strengths
    (reference: training/plot_gender.py:70-87 — p(he)/p(she) under sense-10
    scaling). Each entry of `dists` maps token string -> probability; panels
    share the y axis."""
    plt = _plt()
    n = len(dists)
    fig, axs = plt.subplots(1, n, figsize=(5 * n, 3), sharey=True,
                            squeeze=False)
    for i, dist in enumerate(dists):
        items = sorted(dist.items(), key=lambda kv: -kv[1])[:top_k]
        toks = [k for k, _ in items]
        ax = axs[0][i]
        ax.bar(toks, [v for _, v in items],
               color=_COLORS[i % len(_COLORS)])
        ax.set_xticklabels(toks, rotation=45, ha="right")
        if panel_titles is not None:
            ax.set_title(panel_titles[i])
        ax.spines[["top", "right"]].set_visible(False)
    axs[0][0].set_ylabel(ylabel)
    return _save(fig, path)


def plot_sense_pca(pca: Mapping[str, np.ndarray], path: str, *,
                   labels: Optional[Sequence[str]] = None,
                   color_by: Optional[Sequence[int]] = None,
                   title: str = "Sense-vector PCA") -> str:
    """Scatter of eval/visualize.sense_pca output (reference:
    make_pca.py pca_plot). `labels` annotates points (word strings);
    `color_by` groups points (e.g. sense index) into palette colors."""
    plt = _plt()
    proj = np.asarray(pca["projected"], np.float64)
    fig, ax = plt.subplots(figsize=(6, 5))
    groups = (np.zeros(len(proj), np.int64) if color_by is None
              else np.asarray(list(color_by)))
    for g in np.unique(groups):
        m = groups == g
        ax.scatter(proj[m, 0], proj[m, 1], s=18,
                   color=_COLORS[int(g) % len(_COLORS)],
                   label=None if color_by is None else f"sense {g}")
    if labels is not None:
        for (x, y), lab in zip(proj[:, :2], labels):
            ax.annotate(lab, (x, y), textcoords="offset points",
                        xytext=(4, 4), fontsize=9)
    ev = np.asarray(pca.get("explained", ()), np.float64)
    if ev.size >= 2:
        ax.set_xlabel(f"PC1 ({ev[0]:.0%} var)")
        ax.set_ylabel(f"PC2 ({ev[1]:.0%} var)")
    if color_by is not None:
        ax.legend()
    ax.set_title(title)
    ax.spines[["top", "right"]].set_visible(False)
    return _save(fig, path)


def plot_similarity_heatmap(matrix: np.ndarray, path: str, *,
                            labels: Optional[Sequence[str]] = None,
                            title: str = "Sense cosine similarity") -> str:
    """Heatmap of eval/visualize.sense_similarity_matrix /
    cross_sense_similarity (reference: visualize_sim.py)."""
    plt = _plt()
    m = np.asarray(matrix, np.float64)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(m, cmap="magma", vmin=min(0.0, m.min()), vmax=1.0)
    fig.colorbar(im, ax=ax, shrink=0.85)
    if labels is not None:
        ax.set_xticks(range(len(labels)), labels, rotation=60, ha="right",
                      fontsize=9)
        ax.set_yticks(range(len(labels)), labels, fontsize=9)
    ax.set_title(title)
    return _save(fig, path)


def plot_localization(contrib: np.ndarray, path: str, *,
                      tokens: Optional[Sequence[str]] = None,
                      target: str = "", title: str = "") -> str:
    """(nv, s) per-(sense, position) logit contributions from
    eval/visualize.localize_prediction (reference: localize_pred.py)."""
    plt = _plt()
    c = np.asarray(contrib, np.float64)
    fig, ax = plt.subplots(figsize=(1.2 + 0.5 * c.shape[1], 4))
    lim = np.abs(c).max() or 1.0
    im = ax.imshow(c, cmap="RdBu_r", vmin=-lim, vmax=lim, aspect="auto")
    fig.colorbar(im, ax=ax, shrink=0.85,
                 label=f"contribution to logit({target})" if target else
                 "logit contribution")
    if tokens is not None:
        ax.set_xticks(range(len(tokens)), tokens, rotation=60, ha="right",
                      fontsize=9)
    ax.set_ylabel("sense")
    ax.set_title(title or "Per-sense prediction localization")
    return _save(fig, path)


def latex_table(rows: Sequence[Sequence[object]],
                headers: Sequence[str], *,
                caption: str = "", label: str = "",
                float_fmt: str = "{:.3f}") -> str:
    """LaTeX tabular for results (e.g. eval/similarity.py Spearman per
    dataset — the reference pastes these by hand into the paper). Floats are
    formatted with `float_fmt`; the best (max) float per column is bolded."""
    def fmt(v, best):
        if isinstance(v, float):
            s = float_fmt.format(v)
            return rf"\textbf{{{s}}}" if best else s
        return str(v)

    ncol = len(headers)
    col_is_float = [all(isinstance(r[j], float) for r in rows) and rows
                    for j in range(ncol)]
    best_val = [max(r[j] for r in rows) if col_is_float[j] else None
                for j in range(ncol)]
    lines = [r"\begin{table}[t]", r"\centering",
             r"\begin{tabular}{" + "l" * ncol + "}", r"\toprule",
             " & ".join(headers) + r" \\", r"\midrule"]
    for r in rows:
        lines.append(" & ".join(
            fmt(v, col_is_float[j] and v == best_val[j])
            for j, v in enumerate(r)) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    if caption:
        lines.append(rf"\caption{{{caption}}}")
    if label:
        lines.append(rf"\label{{{label}}}")
    lines.append(r"\end{table}")
    return "\n".join(lines)
