"""Visualisation: order graphs and instance-mask overlays (counterpart of
instaorder_tpu/utils/visualize.py, copied whole).

Parity with reference utils/visualize_utils.py: networkx circular-layout
digraph of an order matrix (green edges for overlapping pairs), and
contour/ID overlays of instance masks on the RGB image.

matplotlib, networkx and cv2 are imported at call time (`require`
raises an ImportError that names the missing package), so the port
imports without them; the debug PNGs of eval/tester.py and eval/disp.py
need them.
"""

from __future__ import annotations

import numpy as np

COLORS = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
    (152, 223, 138), (255, 152, 150), (197, 176, 213), (196, 156, 148),
], dtype=np.uint8)


def require(*names):
    """Import each named package, or raise an ImportError that names it and
    says what needs it."""
    import importlib
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise ImportError(
                f'the debug PNGs (save_pngs / save_dir) need the {name} '
                f'package, which is not installed here') from e


def pyplot():
    """matplotlib.pyplot on the Agg backend (files only, no display)."""
    require('matplotlib')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def draw_graph(order_matrix, overlap_matrix=None, ax=None, node_size=600):
    """Draw an order matrix as a circular digraph. Edge i->j for
    order[i, j] == 1; '=' (value 2) rendered as a dashed undirected edge;
    overlapping pairs (overlap_matrix == 1) in green."""
    require('matplotlib', 'networkx')
    import matplotlib.pyplot as plt
    import networkx as nx

    n = order_matrix.shape[0]
    g = nx.DiGraph()
    g.add_nodes_from(range(n))
    plain, eq, green = [], [], []
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if order_matrix[i, j] == 1:
                if overlap_matrix is not None and overlap_matrix[i, j] == 1:
                    green.append((i, j))
                else:
                    plain.append((i, j))
            elif order_matrix[i, j] == 2 and i < j:
                eq.append((i, j))
    pos = nx.circular_layout(g)
    ax = ax or plt.gca()
    nx.draw_networkx_nodes(g, pos, node_size=node_size, ax=ax,
                           node_color='#dddddd', edgecolors='black')
    nx.draw_networkx_labels(g, pos, ax=ax)
    nx.draw_networkx_edges(g, pos, edgelist=plain, ax=ax,
                           edge_color='black', arrows=True)
    nx.draw_networkx_edges(g, pos, edgelist=green, ax=ax,
                           edge_color='green', arrows=True)
    nx.draw_networkx_edges(g, pos, edgelist=eq, ax=ax, style='dashed',
                           edge_color='gray', arrows=False)
    ax.set_axis_off()
    return ax


def get_mid_top_from_masks(masks):
    """Label anchor per instance: (mean x, min y) of the mask."""
    anchors = []
    for m in masks:
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            anchors.append((0, 0))
        else:
            anchors.append((int(xs.mean()), int(ys.min())))
    return anchors


def put_instance_mask_and_ID(image, masks, mid_tops=None, colors=None,
                             categories=None, alpha=0.5):
    """Blend instance masks over the image and draw boundary contours.
    Returns a uint8 HxWx3 overlay."""
    require('cv2')
    import cv2
    colors = COLORS if colors is None else colors
    out = image.copy().astype(np.float32)
    for k, m in enumerate(masks):
        color = colors[k % len(colors)].astype(np.float32)
        sel = m.astype(bool)
        out[sel] = (1 - alpha) * out[sel] + alpha * color
        contours, _ = cv2.findContours(m.astype(np.uint8),
                                       cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(out, contours, -1, color.tolist(), 2)
    out = out.clip(0, 255).astype(np.uint8)
    if mid_tops is not None:
        for k, (x, y) in enumerate(mid_tops):
            label = str(k if categories is None else categories[k])
            cv2.putText(out, label, (x, max(y, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 2)
            cv2.putText(out, label, (x, max(y, 12)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
    return out
