"""Training dashboard: static HTML export + minimal HTTP server
(counterpart of deeplearning4j_tpu/stats/dashboard.py: the same page,
embedded data and status lines).

Parity: the reference's Play UI train module (ui/play/PlayUIServer.java,
ui/module/train/TrainModule.java — score chart, mean-magnitude
timelines, histograms, system tab; conv-activation grids via the
activations view, and the t-SNE tab ui/module/tsne/), as a
dependency-free self-contained HTML file (inline SVG charts, data
embedded as JSON); the UIServer re-renders on each GET.
`collect_conv_activations` and `collect_network_flow` build the extra
tabs' data from a live net; pass them to render_html. `embedding_scatter`
builds the t-SNE tab's data with clustering.Tsne.
"""

from __future__ import annotations

import html
import json
import threading
from typing import Optional

from deeplearning4j_tpu_torch.stats.storage import StatsStorage

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j_tpu — training</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 24px; color: #222; }}
 h1 {{ font-size: 20px; }} h2 {{ font-size: 16px; margin-top: 28px; }}
 .meta {{ color: #666; font-size: 13px; }}
 .row {{ display: flex; flex-wrap: wrap; gap: 24px; }}
 .chart {{ border: 1px solid #ddd; border-radius: 6px; padding: 8px; }}
 .lbl {{ font-size: 12px; color: #555; text-anchor: middle; }}
</style></head>
<body>
<h1>Training session <code>{session}</code></h1>
<p class="meta">{n} reports · final score {final_score} ·
 {sps} samples/sec · ETL {etl} ms · device mem {dev_mem} MB</p>
<div id="telemetry"></div>
<div id="charts" class="row"></div>
<h2>Parameter mean magnitudes (log10)</h2>
<div id="pmm" class="row"></div>
<h2>Update mean magnitudes (log10)</h2>
<div id="umm" class="row"></div>
<h2>Latest parameter histograms</h2>
<div id="hists" class="row"></div>
<h2>Network graph</h2>
<div id="flow" class="row"></div>
<h2>Convolutional activations</h2>
<div id="acts" class="row"></div>
<h2>Embedding t-SNE</h2>
<div id="tsne" class="row"></div>
<script>
const DATA = {data};
if (DATA.telemetry_lines && DATA.telemetry_lines.length) {{
  // one substrate: the self-healing / cluster / serving lines are
  // derived (in Python, telemetry_lines) from a MetricsRegistry
  // snapshot instead of per-component stats dicts; the raw snapshot
  // rides along as DATA.telemetry for programmatic consumers
  document.getElementById('telemetry').innerHTML = DATA.telemetry_lines
    .map(l => '<p class="meta">' + l + '</p>').join('');
}}
function svgLine(pts, w, h, color) {{
  if (pts.length === 0) return '';
  const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = v => 40 + (w - 50) * (x1 === x0 ? 0 : (v - x0) / (x1 - x0));
  const sy = v => (h - 20) - (h - 35) * (y1 === y0 ? 0.5 : (v - y0) / (y1 - y0));
  const d = pts.map((p, i) => (i ? 'L' : 'M') + sx(p[0]).toFixed(1) + ' ' + sy(p[1]).toFixed(1)).join(' ');
  return `<path d="${{d}}" fill="none" stroke="${{color}}" stroke-width="1.5"/>` +
    `<text class="lbl" x="8" y="18" text-anchor="start">${{y1.toPrecision(4)}}</text>` +
    `<text class="lbl" x="8" y="${{h - 22}}" text-anchor="start">${{y0.toPrecision(4)}}</text>`;
}}
function chart(title, pts, color) {{
  const w = 420, h = 180;
  return `<div class="chart"><svg width="${{w}}" height="${{h}}">` +
    svgLine(pts, w, h, color) +
    `<text class="lbl" x="${{w / 2}}" y="${{h - 4}}">${{title}}</text></svg></div>`;
}}
function bars(title, hist) {{
  const w = 320, h = 140, n = hist.counts.length;
  const m = Math.max(...hist.counts, 1);
  let rects = '';
  for (let i = 0; i < n; i++) {{
    const bh = (h - 30) * hist.counts[i] / m;
    rects += `<rect x="${{5 + i * (w - 10) / n}}" y="${{h - 22 - bh}}"` +
      ` width="${{(w - 10) / n - 1}}" height="${{bh}}" fill="#4a7fb5"/>`;
  }}
  return `<div class="chart"><svg width="${{w}}" height="${{h}}">` + rects +
    `<text class="lbl" x="${{w / 2}}" y="${{h - 8}}">${{title}}` +
    ` [${{hist.min.toPrecision(3)}}, ${{hist.max.toPrecision(3)}}]</text></svg></div>`;
}}
const reps = DATA.reports;
const iters = reps.map(r => r.iteration);
const sc = reps.filter(r => r.score != null).map(r => [r.iteration, r.score]);
document.getElementById('charts').innerHTML =
  chart('score vs iteration', sc, '#c0392b') +
  chart('samples/sec', reps.filter(r => r.samples_per_sec != null)
        .map(r => [r.iteration, r.samples_per_sec]), '#27ae60') +
  chart('ETL ms', reps.filter(r => r.etl_ms != null)
        .map(r => [r.iteration, r.etl_ms]), '#8e44ad');
function mmCharts(el, key) {{
  const names = new Set();
  reps.forEach(r => Object.keys(r[key] || {{}}).forEach(k => names.add(k)));
  let htmlStr = '';
  for (const name of Array.from(names).slice(0, 24)) {{
    const pts = reps.filter(r => (r[key] || {{}})[name] > 0)
      .map(r => [r.iteration, Math.log10(r[key][name])]);
    htmlStr += chart(name, pts, '#2c6fad');
  }}
  document.getElementById(el).innerHTML = htmlStr || '<p class="meta">none collected</p>';
}}
mmCharts('pmm', 'param_mean_magnitudes');
mmCharts('umm', 'update_mean_magnitudes');
const last = reps[reps.length - 1] || {{}};
let hh = '';
for (const [name, hist] of Object.entries(last.param_histograms || {{}}).slice(0, 24))
  hh += bars(name, hist);
document.getElementById('hists').innerHTML = hh || '<p class="meta">none collected</p>';
const flow = DATA.flow;
if (flow && flow.nodes.length) {{
  const byDepth = {{}};
  flow.nodes.forEach(n => (byDepth[n.depth] = byDepth[n.depth] || []).push(n));
  const depths = Object.keys(byDepth).map(Number).sort((a, b) => a - b);
  const colW = 180, rowH = 46;
  const maxRows = Math.max(...depths.map(d => byDepth[d].length));
  const w = depths.length * colW + 20, h = maxRows * rowH + 30;
  const pos = {{}};
  depths.forEach((d, di) => byDepth[d].forEach((n, ri) => {{
    pos[n.name] = [20 + di * colW, 20 + ri * rowH];
  }}));
  let svg = '';
  flow.edges.forEach(e => {{
    const a = pos[e[0]], b = pos[e[1]];
    if (a && b) svg += `<line x1="${{a[0] + 120}}" y1="${{a[1] + 14}}"` +
      ` x2="${{b[0]}}" y2="${{b[1] + 14}}" stroke="#aaa"/>`;
  }});
  flow.nodes.forEach(n => {{
    const [x, y] = pos[n.name];
    svg += `<rect x="${{x}}" y="${{y}}" width="120" height="28" rx="5"` +
      ` fill="${{n.params ? '#eaf1f8' : '#f4f4f4'}}" stroke="#7a9cc0"/>` +
      `<text class="lbl" x="${{x + 60}}" y="${{y + 12}}">${{n.name.slice(0, 18)}}</text>` +
      `<text class="lbl" x="${{x + 60}}" y="${{y + 24}}">${{n.type.slice(0, 16)}}` +
      `${{n.params ? ' · ' + n.params.toLocaleString() : ''}}</text>`;
  }});
  document.getElementById('flow').innerHTML =
    `<div class="chart" style="overflow-x:auto"><svg width="${{w}}" height="${{h}}">${{svg}}</svg></div>`;
}} else {{
  document.getElementById('flow').innerHTML = '<p class="meta">none collected</p>';
}}
function actGrid(name, ch) {{
  // one channel: rows x cols intensity grid (TrainModule activations view)
  const g = ch.grid, rows = g.length, cols = g[0].length, cell = 6;
  const w = cols * cell + 2, h = rows * cell + 16;
  let mn = Infinity, mx = -Infinity;
  g.forEach(r => r.forEach(v => {{ mn = Math.min(mn, v); mx = Math.max(mx, v); }}));
  let rects = '';
  for (let r = 0; r < rows; r++) for (let c = 0; c < cols; c++) {{
    const t = mx === mn ? 0 : (g[r][c] - mn) / (mx - mn);
    const lum = Math.round(255 * t);
    rects += `<rect x="${{c * cell}}" y="${{r * cell}}" width="${{cell}}"` +
      ` height="${{cell}}" fill="rgb(${{lum}},${{lum}},${{lum}})"/>`;
  }}
  return `<svg width="${{w}}" height="${{h}}">${{rects}}` +
    `<text class="lbl" x="${{w / 2}}" y="${{h - 3}}">${{name}}</text></svg>`;
}}
let ah = '';
for (const layer of (DATA.activations || [])) {{
  ah += `<div class="chart"><div class="meta">${{layer.name}} ` +
    `${{JSON.stringify(layer.shape)}}</div>`;
  layer.channels.forEach((ch, i) => {{ ah += actGrid('ch' + ch.index, ch); }});
  ah += '</div>';
}}
document.getElementById('acts').innerHTML = ah || '<p class="meta">none collected</p>';
const emb = DATA.embedding;
if (emb && emb.points.length) {{
  const w = 480, h = 420;
  const xs = emb.points.map(p => p[0]), ys = emb.points.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const palette = ['#c0392b','#27ae60','#2c6fad','#8e44ad','#f39c12',
                   '#16a085','#d35400','#7f8c8d','#2c3e50','#e84393'];
  let dots = '';
  emb.points.forEach((pt, i) => {{
    const sx = 10 + (w - 20) * (x1 === x0 ? 0.5 : (pt[0] - x0) / (x1 - x0));
    const sy = 10 + (h - 40) * (y1 === y0 ? 0.5 : (pt[1] - y0) / (y1 - y0));
    const lab = (emb.labels || [])[i];
    const col = lab == null ? '#2c6fad' : palette[Math.abs(lab) % palette.length];
    dots += `<circle cx="${{sx.toFixed(1)}}" cy="${{sy.toFixed(1)}}" r="2.5"` +
      ` fill="${{col}}" fill-opacity="0.7"/>`;
  }});
  document.getElementById('tsne').innerHTML =
    `<div class="chart"><svg width="${{w}}" height="${{h}}">${{dots}}` +
    `<text class="lbl" x="${{w / 2}}" y="${{h - 6}}">` +
    `${{emb.points.length}} points (kl=${{emb.kl}})</text></svg></div>`;
}} else {{
  document.getElementById('tsne').innerHTML = '<p class="meta">none collected</p>';
}}
</script>
</body></html>
"""


def collect_conv_activations(net, x, max_layers: int = 6,
                             max_channels: int = 8, max_hw: int = 14):
    """Per-conv-layer activation grids for a sample batch (the
    TrainModule activations view's data): runs net.feed_forward on
    x[:1] and average-pools each 4-D activation down to <= max_hw per
    side, keeping the first max_channels channels. Returns the
    `activations` structure render_html embeds."""
    import numpy as np

    acts = net.feed_forward(x[:1])
    layer_names = [type(l).__name__ for l in net.conf.layers]
    out = []
    for i, a in enumerate(acts[1:]):
        a = a.detach().cpu().numpy()
        if a.ndim != 4:       # NHWC conv outputs only
            continue
        _, h, w, c = a.shape
        sh = max(1, -(-h // max_hw))
        sw = max(1, -(-w // max_hw))
        hp, wp = -(-h // sh) * sh, -(-w // sw) * sw
        padded = np.zeros((hp, wp, c), np.float64)
        padded[:h, :w] = a[0]
        valid = np.zeros((hp, wp, 1), np.float64)
        valid[:h, :w] = 1.0
        sums = padded.reshape(hp // sh, sh, wp // sw, sw, c).sum((1, 3))
        counts = valid.reshape(hp // sh, sh, wp // sw, sw, 1).sum((1, 3))
        pooled = sums / np.maximum(counts, 1.0)
        channels = [{"index": int(ci),
                     "grid": np.round(pooled[:, :, ci], 4).tolist()}
                    for ci in range(min(c, max_channels))]
        out.append({"name": f"{i}:{layer_names[i]}",
                    "shape": [int(h), int(w), int(c)],
                    "channels": channels})
        if len(out) >= max_layers:
            break
    return out


def collect_network_flow(net):
    """Topology data for the flow/network renderer tab (the reference
    TrainModule's model-graph view): nodes (name, type, depth, param
    count) + directed edges. Works for MultiLayerNetwork (a chain) and
    ComputationGraph (the conf DAG). The params are read through the
    net's views of its train carry (the flat carry stays live)."""
    from deeplearning4j_tpu_torch.util.tree import leaves

    def n_params(tree):
        return sum(int(a.numel()) for a in leaves(tree))

    nodes, edges = [], []
    conf = net.conf
    params = net._params_view()
    if hasattr(conf, "network_inputs"):      # ComputationGraph
        depth_of = {}
        for name in conf.network_inputs:
            depth_of[name] = 0
            nodes.append({"name": name, "type": "Input", "depth": 0,
                          "params": 0})
        for gn in conf.topological_order():
            depth = max((depth_of.get(i, 0) for i in gn.inputs),
                        default=0) + 1
            depth_of[gn.name] = depth
            kind = type(gn.obj).__name__
            p = (n_params(params[gn.name])
                 if params and gn.name in params else 0)
            nodes.append({"name": gn.name, "type": str(kind),
                          "depth": depth, "params": p})
            for src in gn.inputs:
                edges.append([src, gn.name])
    else:                                    # MultiLayerNetwork chain
        prev = "input"
        nodes.append({"name": "input", "type": "Input", "depth": 0,
                      "params": 0})
        for i, layer in enumerate(conf.layers):
            name = f"{i}:{type(layer).__name__}"
            p = n_params(params[i]) if params else 0
            nodes.append({"name": name, "type": type(layer).__name__,
                          "depth": i + 1, "params": p})
            edges.append([prev, name])
            prev = name
    return {"nodes": nodes, "edges": edges}


def embedding_scatter(vectors, labels=None, perplexity: float = 20.0,
                      max_points: int = 2000, max_iter: int = 300,
                      seed: int = 0, device=None):
    """2-D t-SNE of an embedding matrix for the dashboard's t-SNE tab
    (ref ui/module/tsne/): subsamples to max_points, runs
    clustering.Tsne (auto tier) on `device` (None: the card), returns
    the `embedding` structure render_html embeds."""
    import numpy as np

    from deeplearning4j_tpu_torch.clustering.tsne import Tsne

    vectors = np.asarray(vectors, np.float32)
    n = vectors.shape[0]
    if n < 8:        # too few points for any valid perplexity
        return {"points": [], "labels": None, "kl": None}
    if n > max_points:
        sel = np.random.default_rng(seed).choice(n, max_points,
                                                 replace=False)
        vectors = vectors[sel]
        labels = None if labels is None else np.asarray(labels)[sel]
    # keep within Tsne's n-1 >= 3*perplexity guard
    perplexity = min(perplexity, (vectors.shape[0] - 1) / 3.0)
    t = Tsne(perplexity=perplexity, max_iter=max_iter, seed=seed,
             device=device)
    pts = t.fit_transform(vectors)
    if labels is None:
        lab_idx = None
    else:
        # palette indices for ANY label type (ints, strings, ...)
        uniq = {v: i for i, v in enumerate(dict.fromkeys(labels))}
        lab_idx = [uniq[v] for v in labels]
    return {"points": np.round(pts, 3).tolist(),
            "labels": lab_idx,
            "kl": round(t.kl_, 4) if t.kl_ is not None else None}


def telemetry_lines(snapshot) -> list:
    """Human-readable status lines derived from a
    `MetricsRegistry.snapshot()` (or a registry itself) — the
    single-substrate replacement for the per-component stats dicts the
    dashboard used to reach into. Returns [] when the snapshot carries
    none of the relevant metrics; the self-healing, cluster, and
    serving lines are pinned by test."""
    if snapshot is None:
        return []
    if hasattr(snapshot, "snapshot"):   # a MetricsRegistry
        snapshot = snapshot.snapshot()
    c = {name: int(sum(series.values()))
         for name, series in snapshot.get("counters", {}).items()}
    hists = snapshot.get("histograms", {})

    def gauge(name):
        series = snapshot.get("gauges", {}).get(name)
        if not series:
            return None
        return list(series.values())[-1]

    lines = []
    heal = []
    if any(k.startswith("dl4j_train_guard_") for k in c):
        heal.append(
            f"guard: {c.get('dl4j_train_guard_checks_total', 0)} "
            f"checks, {c.get('dl4j_train_guard_nonfinite_total', 0)} "
            f"non-finite, {c.get('dl4j_train_guard_spikes_total', 0)} "
            f"spikes, "
            f"{c.get('dl4j_train_guard_skipped_steps_total', 0)} "
            f"skipped, "
            f"{c.get('dl4j_train_guard_rollbacks_total', 0)} rollbacks")
    if "dl4j_train_watchdog_hangs_total" in c:
        heal.append(f"watchdog: {c['dl4j_train_watchdog_hangs_total']} "
                    "hangs detected")
    if "dl4j_train_preemptions_total" in c:
        heal.append(
            f"preemptions: {c['dl4j_train_preemptions_total']}")
    if "dl4j_train_supervisor_restarts_total" in c:
        heal.append(f"supervisor restarts: "
                    f"{c['dl4j_train_supervisor_restarts_total']}")
    if "dl4j_train_data_skipped_steps_total" in c:
        heal.append(f"data-skipped steps: "
                    f"{c['dl4j_train_data_skipped_steps_total']}")
    if heal:
        lines.append("self-healing — " + " · ".join(heal))
    if ("dl4j_cluster_gang_restarts_total" in c
            or "dl4j_cluster_quarantined_workers_total" in c):
        lines.append(
            "cluster — "
            f"{c.get('dl4j_cluster_gang_restarts_total', 0)} gang "
            "restarts · "
            f"{c.get('dl4j_cluster_quarantined_workers_total', 0)} "
            "quarantined workers")
    # device-mesh sharding (engine/mesh.py): live world, reshard count,
    # checkpoint all-gather cost — the ZeRO-1 scale-out status line
    mesh_world = gauge("dl4j_mesh_world_size")
    if mesh_world is not None or "dl4j_mesh_reshard_total" in c:
        mesh = []
        if mesh_world is not None:
            mesh.append(f"world {int(mesh_world)}")
        mesh.append(f"{c.get('dl4j_mesh_reshard_total', 0)} reshards")
        ag = hists.get("dl4j_mesh_allgather_seconds")
        if ag and ag.get("count"):
            mesh.append(
                f"allgather {ag['sum'] / ag['count'] * 1e3:.1f}ms avg")
        lines.append("mesh — " + " · ".join(mesh))
    # fleet rollout controller (serving/controller.py): pool size,
    # rollout state-machine position, rollback count
    fleet_n = gauge("dl4j_fleet_replicas")
    rollout_state = gauge("dl4j_rollout_state")
    if fleet_n is not None or rollout_state is not None \
            or "dl4j_rollout_rollbacks_total" in c:
        # mirror of serving.controller.ROLLOUT_STATES (equality pinned
        # by test) — importing the serving package here would drag the
        # whole data plane into every dashboard render
        ROLLOUT_STATES = ("idle", "canary", "ramping", "rolling_back",
                          "held", "completed")
        fleet = []
        if fleet_n is not None:
            fleet.append(f"{int(fleet_n)} replicas")
        state_i = int(rollout_state) if rollout_state is not None else 0
        if 0 <= state_i < len(ROLLOUT_STATES):
            fleet.append(f"rollout {ROLLOUT_STATES[state_i]}")
        fleet.append(
            f"{c.get('dl4j_rollout_rollbacks_total', 0)} rollbacks")
        lines.append("fleet — " + " · ".join(fleet))
    if "dl4j_serving_requests_total" in c:
        serv = [f"{c['dl4j_serving_requests_total']} requests "
                f"({c.get('dl4j_serving_errors_total', 0)} errors)"]
        qd = gauge("dl4j_serving_queue_depth")
        if qd is not None:
            serv.append(f"queue depth {int(qd)}")
        if "dl4j_serving_batches_total" in c:
            serv.append(f"{c['dl4j_serving_batches_total']} batches")
        occ = hists.get("dl4j_serving_batch_occupancy")
        if occ and occ.get("p50") is not None:
            serv.append(f"occupancy p50 {occ['p50']:g}")
        lines.append("serving — " + " · ".join(serv))
    # continuous-batching decode engine (serving/continuous.py):
    # resident generation streams, token throughput, chaos evictions
    decode_slots = gauge("dl4j_decode_active_slots")
    if decode_slots is not None or "dl4j_decode_tokens_total" in c:
        dec = [f"{int(decode_slots or 0)} slots"]
        rate = gauge("dl4j_decode_tokens_per_s")
        if rate is not None:
            dec.append(f"{rate:.1f} tok/s")
        dec.append(f"{c.get('dl4j_decode_tokens_total', 0)} tokens")
        if "dl4j_decode_slot_evictions_total" in c:
            dec.append(f"{c['dl4j_decode_slot_evictions_total']} "
                       "evictions")
        # paged KV virtual memory: prefix-hit rate (pages served from
        # the trie vs pages computed by chunk prefill) + pool headroom
        hits = c.get("dl4j_decode_prefix_hits_total", 0)
        chunks = c.get("dl4j_decode_prefill_chunks_total", 0)
        if hits + chunks:
            rate = 100.0 * hits / (hits + chunks)
            dec.append(f"prefix hit {rate:.0f}%")
        pages_free = gauge("dl4j_decode_pages_free")
        if pages_free is not None:
            dec.append(f"{int(pages_free)} pages free")
        lines.append("decode — " + " · ".join(dec))

    # per-request latency attribution (TTFT / inter-token / queue-wait
    # histograms, labeled by tenant): the worst label set is shown —
    # an SLO eye wants the slowest tenant, not the average
    def hquant(name, q):
        worst = None
        for key, h in hists.items():
            if key != name and not key.startswith(name + "{"):
                continue
            v = h.get(q)
            if v is not None and (worst is None or v > worst):
                worst = v
        return worst

    ttft99 = hquant("dl4j_decode_ttft_seconds", "p99")
    itl99 = hquant("dl4j_decode_itl_seconds", "p99")
    if ttft99 is not None or itl99 is not None:
        lat = []
        if ttft99 is not None:
            ttft50 = hquant("dl4j_decode_ttft_seconds", "p50")
            lat.append(f"ttft p50 {(ttft50 or 0) * 1e3:.1f}ms "
                       f"p99 {ttft99 * 1e3:.1f}ms")
        if itl99 is not None:
            itl50 = hquant("dl4j_decode_itl_seconds", "p50")
            lat.append(f"itl p50 {(itl50 or 0) * 1e3:.1f}ms "
                       f"p99 {itl99 * 1e3:.1f}ms")
        qw99 = hquant("dl4j_decode_queue_wait_seconds", "p99")
        if qw99 is not None:
            lat.append(f"queue wait p99 {qw99 * 1e3:.1f}ms")
        lines.append("decode latency — " + " · ".join(lat))
    # decode durability (quarantine / migration / watchdog restart /
    # deadline sweep) — shown once any of its counters has moved
    if any(k in c for k in ("dl4j_decode_slot_quarantines_total",
                            "dl4j_decode_migrations_total",
                            "dl4j_decode_engine_restarts_total",
                            "dl4j_decode_deadline_expired_total")):
        lines.append(
            "decode resilience — "
            f"{c.get('dl4j_decode_slot_quarantines_total', 0)} "
            "quarantines · "
            f"{c.get('dl4j_decode_migrations_total', 0)} migrations · "
            f"{c.get('dl4j_decode_engine_restarts_total', 0)} "
            "engine restarts · "
            f"{c.get('dl4j_decode_deadline_expired_total', 0)} "
            "deadline expiries")
    # durable serving journal (serving/journal.py): live WAL occupancy,
    # cold-restart recoveries, torn tails truncated
    journal_live = gauge("dl4j_journal_live")
    if journal_live is not None or any(k in c for k in (
            "dl4j_journal_records_total",
            "dl4j_journal_recovered_requests_total",
            "dl4j_journal_torn_tails_total")):
        lines.append(
            "journal — "
            f"{int(journal_live or 0)} live · "
            f"{c.get('dl4j_journal_recovered_requests_total', 0)} "
            "recovered · "
            f"{c.get('dl4j_journal_torn_tails_total', 0)} torn tails")
    # performance introspection (observability/perf.py): cost-model
    # MFU gauge, top phases by attributed share, recompile count
    perf = []
    mfu = gauge("dl4j_perf_mfu")
    if mfu is not None:
        perf.append(f"MFU {mfu:.3f}")
    phase_prefix = "dl4j_train_phase_seconds{phase="
    shares = {}
    for key, h in hists.items():
        if key.startswith(phase_prefix):
            phase = key[len(phase_prefix):].strip('"}')
            shares[phase] = shares.get(phase, 0.0) + float(h["sum"])
    total = sum(shares.values())
    if total > 0:
        top = sorted(shares.items(), key=lambda kv: -kv[1])[:2]
        perf.append("phases " + ", ".join(
            f"{p} {s / total:.0%}" for p, s in top))
    if "dl4j_jit_compiles_total" in c:
        perf.append(f"{c['dl4j_jit_compiles_total']} recompiles")
    if perf:
        lines.append("perf — " + " · ".join(perf))
    return lines


def render_html(storage: StatsStorage, session_id: Optional[str] = None,
                path: Optional[str] = None, activations=None,
                embedding=None, flow=None, telemetry=None) -> str:
    """Render a self-contained HTML report; write to `path` if given.
    Defaults to the storage's only (or first) session. `activations`
    (collect_conv_activations), `embedding` (embedding_scatter) and
    `flow` (collect_network_flow) fill the conv-activation, t-SNE and
    network-graph tabs; `telemetry` (a MetricsRegistry — typically
    `observability.get_registry()` — or its `.snapshot()`) renders the
    self-healing / cluster / serving status lines from the ONE metrics
    substrate instead of per-component stats dicts, and embeds the raw
    snapshot as DATA.telemetry."""
    sessions = storage.session_ids()
    if not sessions:
        raise ValueError("storage has no sessions")
    if session_id is None:
        session_id = sessions[0]
    if telemetry is not None and hasattr(telemetry, "snapshot"):
        telemetry = telemetry.snapshot()
    reports = storage.reports(session_id)
    latest = reports[-1] if reports else None
    fmt = lambda v, nd=1: "–" if v is None else f"{v:.{nd}f}"
    page = _PAGE.format(
        session=html.escape(session_id),
        n=len(reports),
        final_score="–" if latest is None or latest.score is None
        else f"{latest.score:.4f}",
        sps=fmt(latest.samples_per_sec if latest else None),
        etl=fmt(latest.etl_ms if latest else None, 2),
        dev_mem=fmt((latest.mem or {}).get("device_in_use_mb")
                    if latest else None),
        data=json.dumps({"reports": [r.to_dict() for r in reports],
                         "activations": activations,
                         "embedding": embedding,
                         "flow": flow,
                         "telemetry": telemetry,
                         "telemetry_lines": telemetry_lines(telemetry)}),
    )
    if path:
        with open(path, "w") as f:
            f.write(page)
    return page


class UIServer:
    """Minimal HTTP dashboard (ref: UIServer.getInstance().attach(storage),
    ui/api/UIServer.java:24,42). Serves the rendered report at / and
    per-session at /session/<id>; re-renders per request."""

    def __init__(self, port: int = 9000, host: str = "127.0.0.1"):
        self.host = host
        self.port = port
        self._storage: Optional[StatsStorage] = None
        self._httpd = None
        self._thread = None

    def attach(self, storage: StatsStorage) -> "UIServer":
        self._storage = storage
        return self

    def start(self) -> "UIServer":
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                # remote stats receiver (ref RemoteReceiverModule):
                # RemoteStatsStorageRouter POSTs StatsReport JSON here
                from deeplearning4j_tpu_torch.stats.report import (
                    StatsReport,
                )

                try:
                    if self.path.rstrip("/") != "/remote" \
                            or server._storage is None:
                        raise ValueError(f"no receiver at {self.path}")
                    n = int(self.headers.get("Content-Length", 0))
                    report = StatsReport.from_json(
                        self.rfile.read(n).decode())
                    server._storage.put_report(report)
                    body = b"{}"
                    self.send_response(200)
                except Exception as e:
                    body = str(e).encode()
                    self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if server._storage is None:
                        raise ValueError("no storage attached")
                    sid = None
                    if self.path.startswith("/session/"):
                        sid = self.path.split("/session/", 1)[1] or None
                    # live dashboard auto-attaches the process-global
                    # registry: self-healing / cluster / serving lines
                    # render from whatever this process has emitted
                    from deeplearning4j_tpu_torch.observability import (
                        get_registry,
                    )

                    body = render_html(server._storage, sid,
                                       telemetry=get_registry()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                except Exception as e:  # pragma: no cover - error path
                    body = f"<html><body>{html.escape(str(e))}" \
                           f"</body></html>".encode()
                    self.send_response(503)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        import socketserver

        class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="UIServer-http")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
