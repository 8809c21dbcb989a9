"""Distribution charts from session logs -> standalone HTML (counterpart of
``mmla_audio_tpu.analyze.charts``, copied: the JAX module is pure Python, but
importing it imports JAX through its package).

Replicates the reference visualizers (`overlap_degree_distribution.py:14-128`,
`speaker_time_distribution.py:14-156`): for every log under
``experiment/logs``, a Bar timeline (one lane per label, a mark per segment)
and a Pie of seconds-per-label (label share x total session seconds, derived
from the first/last timestamps), written to ``experiment/charts/<log>.html``.
Same 24-color palette; rendered as dependency-free inline SVG instead of
pyecharts.  The HTML equals the JAX package's for the same log.
"""

from __future__ import annotations

import html
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from mmla_audio_torch.analyze.logs import parse_log

__all__ = ["PALETTE", "compute_distribution", "render_chart_html",
           "visualize_log", "visualize_all"]

PALETTE = ['#c23531', '#2f4554', '#61a0a8', '#d48265', '#749f83', '#ca8622',
           '#bda29a', '#6e7074', '#546570', '#c4ccd3', '#f05b72', '#ef5b9c',
           '#f47920', '#905a3d', '#fab27b', '#2a5caa', '#444693', '#726930',
           '#b2d235', '#6d8346', '#ac6767', '#1d953f', '#6950a1', '#918597']


def _parse_ts(ts: str) -> datetime:
    # reference truncates micros: str(datetime)[:-7]
    return datetime.strptime(ts[:19], "%Y-%m-%d %H:%M:%S")


_EDGE_STRIDE_S = 2.56   # edge logs carry no timestamps; one row per window


def compute_distribution(rows: Sequence[Tuple[int, str, str]],
                         labels: Sequence[str] | None = None,
                         edge_stride_s: float = _EDGE_STRIDE_S):
    """-> (labels, counts, seconds, per-segment label indices, offsets_sec).

    Label share of time = count share x (last_ts - first_ts), exactly the
    reference's computation (`overlap_degree_distribution.py:42-65`).
    Handles empty logs (header only — short recordings) and the edge
    sessions' timestamp-free rows (synthetic offsets of ``edge_stride_s``
    seconds per row — pass ``cfg.audio.window_seconds`` when the pipeline
    runs a non-default window)."""
    if labels is None:
        labels = []
        for _, lab, _ in rows:
            if lab not in labels:
                labels.append(lab)
    labels = list(labels)
    counts: Dict[str, int] = {lab: 0 for lab in labels}
    if not rows:
        return labels, [0 for _ in labels], [0 for _ in labels], [], []
    if rows[0][2]:
        start = _parse_ts(rows[0][2])
        end = _parse_ts(rows[-1][2])
        total_seconds = (end - start).total_seconds()
    else:
        # timestamp-free edge log (SI record_on_pi.py:226-251 schema)
        start = None
        total_seconds = edge_stride_s * max(len(rows) - 1, 0)
    seg_idx: List[int] = []
    offsets: List[float] = []
    for i, (_, lab, ts) in enumerate(rows):
        if lab not in counts:
            labels.append(lab)
            counts[lab] = 0
        counts[lab] += 1
        seg_idx.append(labels.index(lab))
        offsets.append((_parse_ts(ts) - start).total_seconds()
                       if start is not None else i * edge_stride_s)
    n = sum(counts.values())
    seconds = [int(round(counts[lab] / n, 4) * total_seconds) for lab in labels]
    return labels, [counts[lab] for lab in labels], seconds, seg_idx, offsets


def _pie_svg(labels, seconds, cx=240, cy=200, r=150) -> str:
    import math
    total = max(sum(seconds), 1)
    parts = []
    angle = -90.0
    for i, (lab, sec) in enumerate(zip(labels, seconds)):
        frac = sec / total
        a0 = math.radians(angle)
        angle += frac * 360.0
        a1 = math.radians(angle)
        if frac <= 0:
            continue
        x0, y0 = cx + r * math.cos(a0), cy + r * math.sin(a0)
        x1, y1 = cx + r * math.cos(a1), cy + r * math.sin(a1)
        large = 1 if frac > 0.5 else 0
        color = PALETTE[i % len(PALETTE)]
        if frac >= 0.99999:
            parts.append(f'<circle cx="{cx}" cy="{cy}" r="{r}" fill="{color}"/>')
        else:
            parts.append(
                f'<path d="M{cx},{cy} L{x0:.2f},{y0:.2f} '
                f'A{r},{r} 0 {large} 1 {x1:.2f},{y1:.2f} Z" fill="{color}"/>')
    legend = []
    for i, (lab, sec) in enumerate(zip(labels, seconds)):
        color = PALETTE[i % len(PALETTE)]
        y = 30 + i * 22
        legend.append(
            f'<rect x="500" y="{y}" width="14" height="14" fill="{color}"/>'
            f'<text x="520" y="{y + 12}" font-size="13">'
            f'{html.escape(str(lab))}: {sec}s</text>')
    return (f'<svg width="760" height="420" xmlns="http://www.w3.org/2000/svg">'
            f'{"".join(parts)}{"".join(legend)}</svg>')


def _bar_svg(labels, seg_idx, offsets, width=1600, lane_h=26) -> str:
    n_lab = len(labels)
    h = 40 + n_lab * lane_h
    if not offsets:
        return f'<svg width="{width}" height="{h}"/>'
    span = max(max(offsets), 1e-9)
    marks = []
    x_scale = (width - 120) / span
    for idx, off in zip(seg_idx, offsets):
        x = 100 + off * x_scale
        y = 20 + idx * lane_h
        marks.append(f'<rect x="{x:.1f}" y="{y}" width="3" height="{lane_h - 8}" '
                     f'fill="{PALETTE[idx % len(PALETTE)]}"/>')
    lanes = []
    for i, lab in enumerate(labels):
        y = 20 + i * lane_h
        lanes.append(f'<text x="4" y="{y + 14}" font-size="12">'
                     f'{html.escape(str(lab))}</text>'
                     f'<line x1="100" y1="{y + lane_h - 6}" x2="{width - 10}" '
                     f'y2="{y + lane_h - 6}" stroke="#eee"/>')
    axis = (f'<text x="100" y="{h - 6}" font-size="11">0s</text>'
            f'<text x="{width - 70}" y="{h - 6}" font-size="11">{span:.0f}s</text>')
    return (f'<svg width="{width}" height="{h}" '
            f'xmlns="http://www.w3.org/2000/svg">{"".join(lanes)}'
            f'{"".join(marks)}{axis}</svg>')


def render_chart_html(rows, title: str, labels=None,
                      edge_stride_s: float = _EDGE_STRIDE_S) -> str:
    labels, counts, seconds, seg_idx, offsets = compute_distribution(
        rows, labels, edge_stride_s=edge_stride_s)
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title></head>
<body>
<h2 style="text-align:center">{html.escape(title)}</h2>
<h3>Timeline</h3>
{_bar_svg(labels, seg_idx, offsets)}
<h3>Share of time</h3>
{_pie_svg(labels, seconds)}
</body></html>
"""


def visualize_log(log_path, charts_dir, kind: str = "overlap",
                  labels=None,
                  edge_stride_s: float = _EDGE_STRIDE_S) -> Path:
    """One log -> experiment/charts/<log>.html.  ``edge_stride_s``: seconds
    per row for timestamp-free edge logs (pass cfg.audio.window_seconds for
    non-default windows)."""
    rows = parse_log(log_path)
    title = "Overlap Degree" if kind == "overlap" else "Speaker Distribution"
    out = Path(charts_dir) / (Path(log_path).stem + ".html")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(render_chart_html(rows, title, labels,
                                     edge_stride_s=edge_stride_s))
    return out


def visualize_all(logs_dir, charts_dir, kind: str = "overlap", labels=None):
    outs = []
    for p in sorted(Path(logs_dir).glob("*.txt")):
        outs.append(visualize_log(p, charts_dir, kind, labels))
    return outs
