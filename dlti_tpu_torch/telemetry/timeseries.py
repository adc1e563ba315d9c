"""Bounded in-process time-series ring: the black-box tape behind
``GET /debug/vars`` and the ``/dashboard`` page (the port of
``dlti_tpu/telemetry/timeseries.py``, standard library only).

MegaScale's core observability claim is that goodput recovery comes from
*in-framework* instrumentation — the framework itself keeps enough recent
history to localize a straggler or a collapse without an external metrics
stack having been set up in advance. The PR 1 registry gives point-in-time
values; this module gives them a (bounded) past:

* :class:`TimeSeriesSampler` snapshots every numeric value its sources
  produce — typically a :class:`~dlti_tpu_torch.telemetry.registry.MetricsRegistry`
  ``stats_dict()`` plus ad-hoc callbacks — into a ring of
  ``{"ts": monotonic, "wall": epoch, "values": {name: float}}`` samples,
  either on a daemon thread (``start()``) or on demand (``sample_now()``).
* Derived **rates** (``rate(name)``) turn cumulative counters into
  per-second series between ring samples — what the watchdog's
  collapse/buildup rules consume.
* ``snapshot()`` is the ``GET /debug/vars`` JSON payload; ``tail(n)`` is
  what a flight record embeds; :func:`render_dashboard_html` is a fully
  self-contained HTML page that polls ``/debug/vars`` — watching a live
  run needs a browser, not a Prometheus deployment.

Memory is strictly bounded: ``capacity`` samples, oldest evicted.
Sampling never raises out of a source — a broken callback loses its keys
for that sample (and is counted in ``source_errors``), never the run.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple


def flatten_numeric(d: dict, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves of a (possibly nested) dict, dotted keys for nests
    (histogram summaries flatten to ``name.count`` / ``name.mean`` / ...).
    Bools and non-numerics are skipped; lists are opaque (skipped)."""
    out: Dict[str, float] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[key] = float(v)
        elif isinstance(v, dict):
            out.update(flatten_numeric(v, prefix=key + "."))
    return out


class TimeSeriesSampler:
    """Periodic snapshots of every source into a bounded ring."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 600,
                 registry=None):
        self.interval_s = max(0.05, float(interval_s))
        self.capacity = max(2, int(capacity))
        self._sources: List[Callable[[], dict]] = []
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.source_errors = 0
        if registry is not None:
            self.add_source(registry.stats_dict)

    # -- sources --------------------------------------------------------
    def add_source(self, fn: Callable[[], dict]) -> None:
        """Register a callback producing ``{name: number-or-nested-dict}``;
        its numeric leaves join every subsequent sample."""
        self._sources.append(fn)

    # -- sampling -------------------------------------------------------
    def sample_now(self) -> dict:
        values: Dict[str, float] = {}
        for fn in self._sources:
            try:
                values.update(flatten_numeric(fn()))
            except Exception:
                # A broken source loses its keys for this sample; the ring
                # (and the run) survives. Counted so it cannot rot silently.
                self.source_errors += 1
        sample = {"ts": time.monotonic(), "wall": time.time(),
                  "values": values}
        with self._lock:
            self._ring.append(sample)
        return sample

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dlti-ts-sampler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.interval_s + 1)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_now()

    # -- reads ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def tail(self, n: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-n:]

    def latest(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def series(self, name: str) -> List[Tuple[float, float]]:
        """[(monotonic_ts, value)] for one metric across the ring."""
        return [(s["ts"], s["values"][name]) for s in self.tail()
                if name in s["values"]]

    def rate(self, name: str, window_s: Optional[float] = None,
             ) -> Optional[float]:
        """Per-second delta of ``name`` over the ring tail (counter →
        rate). ``None`` with < 2 observations; clamped at 0 so a process
        restart (counter reset) reads as quiet, not negative."""
        pts = self.series(name)
        if window_s is not None and pts:
            t_end = pts[-1][0]
            pts = [p for p in pts if t_end - p[0] <= window_s]
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return max(0.0, (pts[-1][1] - pts[0][1]) / dt)

    def peak(self, name: str) -> Optional[float]:
        pts = self.series(name)
        return max(v for _, v in pts) if pts else None

    def snapshot(self, tail: Optional[int] = None) -> dict:
        """The ``GET /debug/vars`` payload."""
        samples = self.tail(tail)
        return {
            "now": time.time(),
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "num_samples": len(samples),
            "source_errors": self.source_errors,
            "latest": samples[-1]["values"] if samples else {},
            "samples": samples,
        }


# ----------------------------------------------------------------------
# /dashboard — one self-contained HTML page, zero external assets.
# ----------------------------------------------------------------------

# Series the dashboard promotes to sparkline rows when present (everything
# else lives in the collapsible all-values table). One series per
# sparkline (its row label names it — no legend needed); rate-suffixed
# entries are derived client-side from the counter samples.
_DASH_PREFERRED = (
    "generated_tokens", "requests", "active_seqs", "waiting", "free_blocks",
    "gateway_queue_depth", "gateway_queued_tokens", "gateway_inflight",
    "train_step", "train_loss", "train_tokens_per_s", "train_step_time_s",
    "goodput_fraction", "train_mfu_percent",
    # "where the memory lives" panel (telemetry.memledger scalars).
    "hbm_bytes_in_use", "hbm_headroom_bytes",
    "hbm_tracked_bytes", "hbm_untracked_bytes",
    # SLO panel (telemetry.slo scalars): objectives breaching, the worst
    # burn rate across every (objective, class, window), the tightest
    # remaining error budget.
    "slo_breaching", "slo_worst_burn_rate", "slo_min_budget_remaining",
)

_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>dlti live dashboard</title>
<style>
  :root {
    color-scheme: light;
    --surface-1: #fcfcfb; --surface-2: #f2f1ee;
    --text-primary: #0b0b0b; --text-secondary: #52514e;
    --series-1: #2a78d6; --status-bad: #e34948; --grid: #dddcd7;
  }
  @media (prefers-color-scheme: dark) {
    :root {
      color-scheme: dark;
      --surface-1: #1a1a19; --surface-2: #242423;
      --text-primary: #ffffff; --text-secondary: #c3c2b7;
      --series-1: #3987e5; --status-bad: #e66767; --grid: #3a3a38;
    }
  }
  body { margin: 0; padding: 16px 20px; background: var(--surface-1);
         color: var(--text-primary);
         font: 13px/1.45 ui-monospace, SFMono-Regular, Menlo, monospace; }
  h1 { font-size: 15px; margin: 0 0 2px; }
  .sub { color: var(--text-secondary); margin-bottom: 14px; }
  .alerts { border-left: 3px solid var(--status-bad); background:
            var(--surface-2); padding: 6px 10px; margin: 0 0 14px;
            display: none; }
  .alerts.on { display: block; }
  .grid { display: grid; gap: 10px 18px;
          grid-template-columns: repeat(auto-fill, minmax(340px, 1fr)); }
  .card { background: var(--surface-2); border-radius: 6px;
          padding: 8px 12px 6px; }
  .card .name { color: var(--text-secondary); font-size: 12px;
                overflow: hidden; text-overflow: ellipsis;
                white-space: nowrap; }
  .card .val { font-size: 17px; font-weight: 600; }
  .card svg { display: block; width: 100%; height: 36px; margin-top: 2px; }
  .spark { fill: none; stroke: var(--series-1); stroke-width: 2;
           stroke-linejoin: round; stroke-linecap: round; }
  .axis { stroke: var(--grid); stroke-width: 1; }
  details { margin-top: 18px; }
  summary { cursor: pointer; color: var(--text-secondary); }
  table { border-collapse: collapse; margin-top: 8px; }
  td { padding: 1px 14px 1px 0; color: var(--text-secondary); }
  td.v { color: var(--text-primary); text-align: right; }
  .err { color: var(--status-bad); }
</style></head><body>
<h1>dlti live dashboard</h1>
<div class="sub">polling <code>/debug/vars</code> every <span id="iv">2</span>s
  &middot; <span id="stamp">connecting&hellip;</span></div>
<div class="alerts" id="alerts"></div>
<div class="grid" id="cards"></div>
<details open><summary>all values</summary>
  <table id="all"></table></details>
<script>
const PREFERRED = __PREFERRED__;
const POLL_MS = 2000;
document.getElementById('iv').textContent = POLL_MS / 1000;
function fmt(v) {
  if (!isFinite(v)) return String(v);
  if (Math.abs(v) >= 1000) return Math.round(v).toLocaleString();
  return Math.abs(v - Math.round(v)) < 1e-9 ? String(Math.round(v))
       : v.toPrecision(4);
}
function sparkline(pts) {
  const W = 320, H = 36, P = 2;
  if (pts.length < 2) return '<svg viewBox="0 0 ' + W + ' ' + H + '"></svg>';
  const lo = Math.min(...pts), hi = Math.max(...pts), span = (hi - lo) || 1;
  const step = (W - 2 * P) / (pts.length - 1);
  const d = pts.map((v, i) =>
    (i ? 'L' : 'M') + (P + i * step).toFixed(1) + ',' +
    (H - P - (v - lo) / span * (H - 2 * P)).toFixed(1)).join('');
  return '<svg viewBox="0 0 ' + W + ' ' + H + '" preserveAspectRatio="none">' +
    '<line class="axis" x1="0" y1="' + (H - 1) + '" x2="' + W +
    '" y2="' + (H - 1) + '"/><path class="spark" d="' + d + '"/></svg>';
}
function seriesOf(samples, key) {
  const out = [];
  for (const s of samples) if (key in s.values) out.push(s.values[key]);
  return out;
}
async function tick() {
  let d;
  try {
    d = await (await fetch('/debug/vars')).json();
  } catch (e) {
    document.getElementById('stamp').innerHTML =
      '<span class="err">fetch failed: ' + e + '</span>';
    return;
  }
  const latest = d.latest || {}, samples = d.samples || [];
  document.getElementById('stamp').textContent =
    new Date(d.now * 1000).toLocaleTimeString() + ' \\u00b7 ' +
    d.num_samples + ' samples \\u00b7 ' + Object.keys(latest).length +
    ' series';
  // Watchdog alerts get the status treatment: icon + counts, never
  // color alone.
  const alertKeys = Object.keys(latest)
    .filter(k => k.startsWith('dlti_watchdog_alerts_total') && latest[k] > 0);
  const alertBox = document.getElementById('alerts');
  if (alertKeys.length) {
    alertBox.className = 'alerts on';
    alertBox.innerHTML = '&#9888; watchdog alerts: ' + alertKeys.map(k =>
      k.replace('dlti_watchdog_alerts_total', '') + ' = ' +
      fmt(latest[k])).join(' \\u00b7 ');
  } else { alertBox.className = 'alerts'; }
  const keys = PREFERRED.filter(k => k in latest);
  for (const k of Object.keys(latest).sort()) {
    if (!keys.includes(k) && keys.length < 18 &&
        /(_seconds\\.mean|_queue_depth|tokens_per_s)$/.test(k)) keys.push(k);
  }
  document.getElementById('cards').innerHTML = keys.map(k => {
    return '<div class="card"><div class="name">' + k + '</div>' +
      '<div class="val">' + fmt(latest[k]) + '</div>' +
      sparkline(seriesOf(samples, k)) + '</div>';
  }).join('');
  document.getElementById('all').innerHTML = Object.keys(latest).sort()
    .map(k => '<tr><td>' + k + '</td><td class="v">' + fmt(latest[k]) +
              '</td></tr>').join('');
}
tick();
setInterval(tick, POLL_MS);
</script></body></html>
"""


def render_dashboard_html() -> str:
    """The ``GET /dashboard`` body: a self-contained page (inline CSS/JS,
    no external assets) that polls ``/debug/vars`` and renders the
    preferred series as single-series sparklines plus a full value table
    — light/dark via ``prefers-color-scheme``."""
    import json as _json

    return _DASHBOARD_HTML.replace("__PREFERRED__",
                                   _json.dumps(list(_DASH_PREFERRED)))
