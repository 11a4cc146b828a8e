"""Live training console — HTTP server over scalars, renders, and the
distributed tracker.

Port of ``deeplearning4j_tpu/runtime/console.py``, which imports no JAX;
the port keeps its own copy.  It serves the JSONL files the port's
``runtime.metrics.ScalarsLogger`` writes and any tracker object with the
reference's ``StateTracker`` surface (``workers``, ``heartbeats``,
``count``, ``has_pending``, ``is_done``; the tracker itself is ROADMAP
A7).

Reference parity: the Dropwizard surfaces — the render webapp serving
embedding/filter visualizations (``plot/dropwizard/RenderApplication
.java`` + ``RenderResource``/``ApiResource`` + ``render.ftl``) and the
state-tracker ops console embedded in the Hazelcast tracker
(``statetracker/hazelcast/StateTrackerDropWizardResource.java``).
Rebuilt on stdlib ``http.server``: no framework dependency, same
capabilities —

- ``/``             : HTML dashboard, auto-refreshing scalar charts
- ``/api/scalars``  : JSON rows from a ScalarsLogger file
- ``/api/state``    : JSON StateTracker snapshot (workers, heartbeats,
                      counters, pending jobs) when a tracker is attached
- ``/renders/<f>``  : static HTML/PNG renders from a directory (the
                      RenderResource role)

Start with ``ConsoleServer(scalars_path=..., tracker=...,
render_dir=...).start()``; port 0 picks a free port.
"""

from __future__ import annotations

import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

_DASHBOARD = """<!doctype html><html><head><meta charset="utf-8">
<title>deeplearning4j_tpu_torch console</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem; }}
 .chart {{ margin-bottom: 1.5rem; }}
 svg {{ background: #fafafa; border: 1px solid #ddd; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #ccc; padding: 2px 8px; font-size: 13px; }}
</style></head><body>
<h2>deeplearning4j_tpu_torch training console</h2>
<div id="charts"></div>
<h3>cluster state</h3>
<div id="state">no tracker attached</div>
<script>
const W = 600, H = 160, PAD = 30;
function sparkline(rows, key) {{
  const pts = rows.filter(r => key in r).map(r => [r.step, r[key]]);
  if (!pts.length) return "";
  const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs, x0 + 1);
  const y0 = Math.min(...ys), y1 = Math.max(...ys, y0 + 1e-9);
  const sx = s => PAD + (s - x0) / (x1 - x0) * (W - 2 * PAD);
  const sy = v => H - PAD - (v - y0) / (y1 - y0) * (H - 2 * PAD);
  const d = pts.map((p, i) => (i ? "L" : "M") + sx(p[0]).toFixed(1)
                              + "," + sy(p[1]).toFixed(1)).join(" ");
  return `<div class="chart"><b>${{key}}</b>
    (last: ${{ys[ys.length - 1].toPrecision(5)}})<br>
    <svg width="${{W}}" height="${{H}}"><path d="${{d}}"
      fill="none" stroke="#2266cc" stroke-width="1.5"/></svg></div>`;
}}
async function refresh() {{
  try {{
    const rows = await (await fetch("/api/scalars")).json();
    const keys = new Set();
    rows.forEach(r => Object.keys(r).forEach(k => k !== "step" &&
                                                  keys.add(k)));
    document.getElementById("charts").innerHTML =
      [...keys].map(k => sparkline(rows, k)).join("");
    const st = await (await fetch("/api/state")).json();
    if (st && st.attached) {{
      document.getElementById("state").innerHTML =
        "<table><tr><th>workers</th><td>" + st.workers.join(", ")
        + "</td></tr><tr><th>counters</th><td>"
        + JSON.stringify(st.counters) + "</td></tr><tr><th>pending</th>"
        + "<td>" + st.has_pending + "</td></tr></table>";
    }}
  }} catch (e) {{ console.log(e); }}
}}
refresh(); setInterval(refresh, {refresh_ms});
</script></body></html>"""


class ConsoleServer:
    """Serve scalars/state/renders on a background thread."""

    def __init__(self, scalars_path: Optional[str] = None,
                 tracker: Optional[Any] = None,
                 render_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 refresh_ms: int = 2000):
        self.scalars_path = scalars_path
        self.tracker = tracker
        self.render_dir = render_dir
        self.refresh_ms = refresh_ms
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):      # quiet server
                pass

            def _send(self, body: bytes, ctype: str,
                      status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):                  # noqa: N802 (http.server API)
                try:
                    if self.path in ("/", "/index.html"):
                        page = _DASHBOARD.format(
                            refresh_ms=outer.refresh_ms)
                        self._send(page.encode(), "text/html")
                    elif self.path == "/api/scalars":
                        self._send(json.dumps(
                            outer.scalar_rows()).encode(),
                            "application/json")
                    elif self.path == "/api/state":
                        self._send(json.dumps(
                            outer.state_snapshot()).encode(),
                            "application/json")
                    elif self.path.startswith("/renders/"):
                        self._render_file(self.path[len("/renders/"):])
                    else:
                        self._send(b"not found", "text/plain", 404)
                except (BrokenPipeError, ConnectionError):
                    pass
                except Exception as exc:  # noqa: BLE001 — 500, not a reset
                    try:
                        self._send(f"internal error: {exc!r}".encode(),
                                   "text/plain", 500)
                    except (BrokenPipeError, ConnectionError, OSError):
                        pass

            def _render_file(self, name: str) -> None:
                if outer.render_dir is None or "/" in name or ".." in name:
                    self._send(b"not found", "text/plain", 404)
                    return
                full = os.path.join(outer.render_dir, name)
                if not os.path.isfile(full):
                    self._send(b"not found", "text/plain", 404)
                    return
                ctype = ("image/png" if name.endswith(".png")
                         else "text/html" if name.endswith(".html")
                         else "application/octet-stream")
                with open(full, "rb") as f:
                    self._send(f.read(), ctype)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        # incremental scalars-read state (see scalar_rows)
        self._scalars_lock = threading.Lock()
        self._scalars_offset = 0
        self._scalars_rows: list = []
        self._scalars_tail = b""
        self._scalars_head = b""          # head fingerprint of the file
        self._HEAD_LEN = 256

    # -- data sources --------------------------------------------------------
    def scalar_rows(self) -> list:
        """Rows from the scalars JSONL, read INCREMENTALLY: the polling
        dashboard hits this every ~2 s for the whole training run, so the
        parsed history is cached and only bytes appended since the last
        call are read/parsed (O(new rows) per poll, not O(file)).  A torn
        final line (a concurrent logger mid-append) stays buffered until
        its remainder arrives instead of raising."""
        if not self.scalars_path or not os.path.exists(self.scalars_path):
            return []
        with self._scalars_lock:
            size = os.path.getsize(self.scalars_path)
            # replacement detection: size shrink alone misses a rewritten
            # file that regrew past the cached offset between polls, so
            # fingerprint the head bytes too
            head = b""
            if self._scalars_head:
                with open(self.scalars_path, "rb") as f:
                    head = f.read(len(self._scalars_head))
            if size < self._scalars_offset or (self._scalars_head
                                               and head
                                               != self._scalars_head):
                self._scalars_offset = 0
                self._scalars_rows = []
                self._scalars_tail = b""
                self._scalars_head = b""
            if size > self._scalars_offset:
                with open(self.scalars_path, "rb") as f:
                    if len(self._scalars_head) < self._HEAD_LEN:
                        # (re)capture/extend the fingerprint while the
                        # file is still short; a replacement sharing the
                        # full first _HEAD_LEN bytes is undetectable by
                        # content (documented limitation)
                        self._scalars_head = f.read(self._HEAD_LEN)
                    f.seek(self._scalars_offset)
                    chunk = self._scalars_tail + f.read()
                    self._scalars_offset = f.tell()
                lines = chunk.split(b"\n")
                self._scalars_tail = lines.pop()  # b"" unless torn
                for line in lines:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._scalars_rows.append(json.loads(line))
                    except ValueError:
                        continue                  # malformed line: skip
            return list(self._scalars_rows)

    def state_snapshot(self) -> Dict[str, Any]:
        """StateTrackerDropWizardResource role: live tracker introspection."""
        t = self.tracker
        if t is None:
            return {"attached": False}
        return {
            "attached": True,
            "workers": t.workers(),
            "heartbeats": t.heartbeats(),
            "counters": {k: t.count(k) for k in
                         ("jobs_done", "jobs_failed", "jobs_dropped",
                          "workers_reaped", "iterations")},
            "has_pending": t.has_pending(),
            "done": t.is_done(),
        }

    # -- lifecycle -----------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ConsoleServer":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.1}, daemon=True,
            name="console-server")
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ConsoleServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
