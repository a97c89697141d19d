"""SVG picture of the image match graph.

Port of dagsfm_tpu/graph/svg.py (Theia's ImageGraph::OutputSVG): the
pairwise-score adjacency matrix as a symmetric heatmap with a colour
scale, assembled as text. The files are the JAX package's byte for byte.
"""

from __future__ import annotations


def _heat_color(t: float) -> str:
    """Blue (0) -> green (0.5) -> red (1) as #rrggbb."""
    t = min(max(t, 0.0), 1.0)
    if t < 0.5:
        u = t * 2.0
        r, g, b = 0.0, u, 1.0 - u
    else:
        u = (t - 0.5) * 2.0
        r, g, b = u, 1.0 - u, 0.0
    return "#{:02x}{:02x}{:02x}".format(
        int(r * 255), int(g * 255), int(b * 255))


def write_adjacency_svg(image_ids: list, edges: dict, path: str,
                        cell: int = 5) -> None:
    """The pairwise-score adjacency matrix as an SVG heatmap.

    image_ids: the nodes in plot order; edges: {(i, j): score} in either
    orientation (plotted both ways)."""
    n = len(image_ids)
    index = {im: k for k, im in enumerate(image_ids)}
    smax = max(edges.values(), default=1.0) or 1.0

    size = (n + 4) * cell
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{size}" height="{size}" '
           f'viewBox="0 0 {size} {size}">',
           f'<rect width="{size}" height="{size}" fill="white"/>']
    for (a, b), score in edges.items():
        if a not in index or b not in index:
            continue
        i, j = index[a], index[b]
        color = _heat_color(float(score) / smax)
        for (y, x) in ((i, j), (j, i)):
            out.append(
                f'<rect x="{(x + 1) * cell}" y="{(y + 1) * cell}" '
                f'width="{cell}" height="{cell}" fill="{color}"/>')
    # colour scale along the right edge, with its extent labels
    legend_x = (n + 2) * cell
    for k in range(n):
        out.append(
            f'<rect x="{legend_x}" y="{(k + 1) * cell}" width="{cell}" '
            f'height="{cell}" '
            f'fill="{_heat_color(1.0 - k / max(n - 1, 1))}"/>')
    fs = max(cell, 8)
    out.append(f'<text x="{legend_x + cell}" y="{(n + 1) * cell}" '
               f'font-size="{fs}">0</text>')
    out.append(f'<text x="{legend_x + cell}" y="{cell + fs}" '
               f'font-size="{fs}">{smax:g}</text>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out))


def write_view_graph_svg(view_graph, path: str, cell: int = 5) -> None:
    """A ViewGraph's verified pairs by inlier count."""
    edges = {pair: float(e.num_inliers)
             for pair, e in view_graph.edges.items()}
    write_adjacency_svg(sorted(view_graph.nodes), edges, path, cell=cell)
