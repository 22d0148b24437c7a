"""Self-contained HTML gain chart (the port's copy of
`shifu_tpu/eval/gainchart.py`; core/eval/GainChart.java:35 +
GainChartTemplate.java parity: one file, no external assets, operation-point
table + curves). Rendered as inline SVG so it opens anywhere."""

from __future__ import annotations

from typing import Dict, List

from shifu_tpu_torch.eval.metrics import PerformanceResult


def _polyline(points, width, height, color) -> str:
    if not points:
        return ""
    pts = " ".join(
        f"{x * width:.1f},{height - y * height:.1f}" for x, y in points
    )
    return (
        f'<polyline fill="none" stroke="{color}" stroke-width="2" '
        f'points="{pts}"/>'
    )


def _chart(title: str, series: Dict[str, List], x_key: str, y_key: str) -> str:
    width, height = 420, 300
    colors = ["#4878CF", "#D65F5F", "#6ACC65", "#956CB4"]
    lines, legends = [], []
    for i, (name, rows) in enumerate(series.items()):
        pts = [(r[x_key], r[y_key]) for r in rows]
        lines.append(_polyline(pts, width, height, colors[i % len(colors)]))
        legends.append(
            f'<tspan x="10" dy="14" fill="{colors[i % len(colors)]}">{name}</tspan>'
        )
    axis = (
        f'<rect x="0" y="0" width="{width}" height="{height}" fill="none" '
        f'stroke="#999"/>'
    )
    grid = "".join(
        f'<line x1="{width*k/10:.0f}" y1="0" x2="{width*k/10:.0f}" '
        f'y2="{height}" stroke="#eee"/>' for k in range(1, 10)
    )
    return f"""
<div class="chart">
  <h3>{title}</h3>
  <svg width="{width + 140}" height="{height + 20}">
    <g transform="translate(4,10)">{axis}{grid}{''.join(lines)}</g>
    <text x="{width + 14}" y="20" font-size="12">{''.join(legends)}</text>
  </svg>
</div>"""


def _table(rows: List[Dict]) -> str:
    cols = [
        ("actionRate", "Action rate"),
        ("binLowestScore", "Score"),
        ("recall", "Recall"),
        ("precision", "Precision"),
        ("fpr", "FPR"),
        ("liftUnit", "Lift"),
    ]
    head = "".join(f"<th>{label}</th>" for _, label in cols)
    body = "".join(
        "<tr>" + "".join(f"<td>{r[k]:.4f}</td>" for k, _ in cols) + "</tr>"
        for r in rows
    )
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


def render_gain_chart(
    eval_name: str, model_name: str, perf: PerformanceResult
) -> str:
    roc = _chart(
        "ROC", {"unweighted": perf.roc, "weighted": perf.weighted_roc},
        "fpr", "recall",
    )
    gains = _chart(
        "Gains (recall vs action rate)",
        {"unweighted": perf.gains, "weighted": perf.weighted_gains},
        "actionRate", "recall",
    )
    pr = _chart(
        "Precision-Recall",
        {"unweighted": perf.pr, "weighted": perf.weighted_pr},
        "recall", "precision",
    )
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{eval_name} gain chart</title>
<style>
 body {{ font-family: sans-serif; margin: 24px; color: #222; }}
 .chart {{ display: inline-block; margin-right: 24px; vertical-align: top; }}
 table {{ border-collapse: collapse; margin-top: 16px; }}
 th, td {{ border: 1px solid #ccc; padding: 4px 10px; font-size: 13px; }}
 th {{ background: #f4f4f4; }}
</style></head>
<body>
<h2>Eval “{eval_name}” — {model_name}</h2>
<p>AUC = {perf.area_under_roc:.6f} (weighted {perf.weighted_area_under_roc:.6f})</p>
{roc}{gains}{pr}
<h3>Operating points</h3>
{_table(perf.gains)}
</body></html>
"""
