"""EvaluationTools: HTML exports for ROC and calibration (counterpart of
deeplearning4j_tpu/eval/tools.py; the same pages for the port's ROC and
EvaluationCalibration).

Parity: deeplearning4j-core evaluation/EvaluationTools.java:107
(exportRocChartsToHtmlFile, exportevaluationCalibrationToHtmlFile) —
self-contained dependency-free HTML with inline SVG, same approach as
stats/dashboard.py."""

from __future__ import annotations

import json
from typing import Optional


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 24px; color: #222; }}
 .row {{ display: flex; flex-wrap: wrap; gap: 24px; }}
 .chart {{ border: 1px solid #ddd; border-radius: 6px; padding: 8px; }}
 .lbl {{ font-size: 12px; fill: #555; text-anchor: middle; }}
</style></head><body>
<h1>{title}</h1>{meta}
<div id="charts" class="row"></div>
<script>
const DATA = {data};
function line(pts, w, h, color, diag) {{
  const sx = v => 30 + (w - 40) * v, sy = v => (h - 25) - (h - 40) * v;
  let out = '';
  if (diag) out += `<path d="M${{sx(0)}} ${{sy(0)}} L${{sx(1)}} ${{sy(1)}}"
     stroke="#bbb" stroke-dasharray="4" fill="none"/>`;
  if (pts.length)
    out += '<path d="' + pts.map((p, i) =>
      (i ? 'L' : 'M') + sx(p[0]).toFixed(1) + ' ' + sy(p[1]).toFixed(1))
      .join(' ') + `" fill="none" stroke="${{color}}" stroke-width="1.5"/>`;
  return out;
}}
function chart(title, pts, color, diag) {{
  const w = 360, h = 300;
  return `<div class="chart"><svg width="${{w}}" height="${{h}}">` +
    line(pts, w, h, color, diag) +
    `<text class="lbl" x="${{w / 2}}" y="${{h - 6}}">${{title}}</text>` +
    `</svg></div>`;
}}
let html = '';
for (const c of DATA.charts) html += chart(c.title, c.points, c.color,
                                           c.diagonal);
document.getElementById('charts').innerHTML = html;
</script></body></html>
"""


def _render(title, meta, charts, path):
    page = _PAGE.format(title=title, meta=meta,
                        data=json.dumps({"charts": charts}))
    if path:
        with open(path, "w") as f:
            f.write(page)
    return page


def export_roc_charts_to_html(roc, path: Optional[str] = None) -> str:
    """ROC + precision/recall curves (ref exportRocChartsToHtmlFile)."""
    fpr, tpr = roc.get_roc_curve()
    prec, rec = roc.precision_recall_curve()
    charts = [
        {"title": f"ROC (AUC={roc.auc():.4f})", "color": "#c0392b",
         "diagonal": True,
         "points": [[float(a), float(b)] for a, b in zip(fpr, tpr)]},
        {"title": "Precision vs Recall", "color": "#2c6fad",
         "diagonal": False,
         "points": [[float(a), float(b)] for a, b in zip(rec, prec)]},
    ]
    meta = f"<p>AUC: {roc.auc():.4f}</p>"
    return _render("ROC", meta, charts, path)


def export_evaluation_calibration_to_html(
        calibration, path: Optional[str] = None) -> str:
    """Reliability diagrams per class + residual histogram line
    (ref EvaluationTools calibration export)."""
    charts = []
    for ci in range(calibration.num_classes):
        mean_p, freq, cnt = calibration.reliability_info(ci)
        pts = [[float(p), float(f)] for p, f, n in
               zip(mean_p, freq, cnt) if n > 0]
        charts.append({
            "title": f"reliability class {ci} "
                     f"(ECE={calibration.expected_calibration_error(ci):.3f})",
            "color": "#27ae60", "diagonal": True, "points": pts})
    edges, res = calibration.residual_plot()
    total = max(int(res.sum()), 1)
    charts.append({
        "title": "residual |label-p| histogram", "color": "#8e44ad",
        "diagonal": False,
        "points": [[float(edges[i]), float(res[i]) / total]
                   for i in range(len(res))]})
    meta = (f"<p>macro ECE: "
            f"{calibration.expected_calibration_error():.4f}</p>")
    return _render("Calibration", meta, charts, path)
