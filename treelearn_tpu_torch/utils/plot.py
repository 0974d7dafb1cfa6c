"""Plotting: partition-metric line plots and 3D cloud juxtaposition (port
of treelearn_tpu/utils/plot.py, a host copy).

Parity: reference tree_learn/util/plot.py (matplotlib partition plots at
plot.py:6-28; plotly juxtapose at plot.py:32-74).  plotly is optional here;
juxtapose falls back to matplotlib 3D scatter when it is absent.
"""

from __future__ import annotations

import numpy as np


def plot_evaluation_results_segments(ax, values, fontsize=12, measure="IoU",
                                     y_range=(0.6, 1.0), y_step=10,
                                     color=None, x_label="segment"):
    """Line plot of one partition metric over its 10 radial/vertical segments
    (the figure style of the reference's evaluation notebook)."""
    values = np.asarray(values, float)
    segments = 1 + np.arange(len(values))
    style = {"color": color} if color else {}
    ax.plot(segments, values, marker="o", markersize=3, **style)
    ax.set(xlabel=x_label, ylabel=measure, ylim=y_range, xticks=segments)
    ax.xaxis.label.set_fontsize(fontsize)
    ax.yaxis.label.set_fontsize(fontsize)
    ax.tick_params(labelsize=fontsize)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    ax.grid(True, axis="y", alpha=0.25, linewidth=0.5)
    return ax


def plot_partition_metrics(results: dict, fontsize=12, y_range=(0.6, 1.0)):
    """Grid figure of every partition metric in a results mapping
    {name: sequence of per-segment values}; returns the matplotlib figure."""
    import matplotlib.pyplot as plt

    n = len(results)
    ncols = min(n, 3)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3 * nrows),
                             squeeze=False)
    for ax, (name, vals) in zip(axes.ravel(), results.items()):
        plot_evaluation_results_segments(ax, vals, fontsize, name, y_range)
    for ax in axes.ravel()[n:]:
        ax.set_visible(False)
    fig.tight_layout()
    return fig


def juxtapose(cloud1, cloud2, label1, label2, color1="blue", color2="red",
              subset=10, renderer="notebook", size=1, opacity=1):
    """Overlay two point clouds for visual error analysis (e.g. an
    undersegmenting prediction against the missed ground-truth tree)."""
    cloud1 = np.asarray(cloud1)[::subset]
    cloud2 = np.asarray(cloud2)[::subset]
    try:
        import plotly.express as px
        import pandas as pd

        points = np.vstack([cloud1, cloud2])
        names = [label1] * len(cloud1) + [label2] * len(cloud2)
        df = pd.DataFrame(points, columns=["x", "y", "z"])
        df["cloud"] = names
        fig = px.scatter_3d(df, x="x", y="y", z="z", color="cloud",
                            color_discrete_sequence=[color1, color2])
        fig.update_traces(marker=dict(size=size, opacity=opacity))
        if renderer:
            fig.show(renderer=renderer)
        return fig
    except ImportError:
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        ax.scatter(*cloud1.T, s=size, c=color1, label=label1, alpha=opacity)
        ax.scatter(*cloud2.T, s=size, c=color2, label=label2, alpha=opacity)
        ax.legend()
        return fig
