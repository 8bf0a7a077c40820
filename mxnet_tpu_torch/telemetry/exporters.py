"""Exporters: Prometheus text exposition (file + stdlib HTTP endpoint)
and JSONL snapshot logs.

A copy of ``mxnet_tpu/telemetry/exporters.py``: for the same sequence
of updates the text is the reference's, byte for byte.  Every route
renders host state only (see ``statusz.py``), so the endpoint may be
scraped while the serving thread captures CUDA graphs.

The text format is the Prometheus 0.0.4 exposition format, so the file
written by :func:`write_prometheus` can be scraped by a node-exporter
textfile collector, and :func:`serve_http` is a real ``/metrics``
endpoint (stdlib ``http.server`` only — no new dependencies).
:func:`append_jsonl` appends one timestamped registry snapshot per
call; ``tools/metrics_report.py`` renders either artifact as a
terminal table.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["to_prometheus_text", "write_prometheus", "append_jsonl",
           "serve_http"]


def _escape_label(value):
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_value(v):
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(ub):
    return "+Inf" if ub == float("inf") else _fmt_value(ub)


def _labels_text(label_names, values, extra=()):
    pairs = [f'{n}="{_escape_label(v)}"'
             for n, v in list(zip(label_names, values)) + list(extra)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def to_prometheus_text(registry):
    """Serialize a Registry in Prometheus text exposition format."""
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in fam.children():
            if fam.kind == "histogram":
                for ub, c in child.cumulative():
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labels_text(fam.label_names, key, [('le', _fmt_le(ub))])}"
                        f" {c}")
                base = _labels_text(fam.label_names, key)
                lines.append(f"{fam.name}_sum{base} {_fmt_value(child.sum)}")
                lines.append(f"{fam.name}_count{base} {child.count}")
            else:
                lines.append(
                    f"{fam.name}{_labels_text(fam.label_names, key)} "
                    f"{_fmt_value(child.value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(registry, path):
    """Atomic write of the text exposition to ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(to_prometheus_text(registry))
    os.replace(tmp, path)
    return path


def append_jsonl(registry, path, extra=None):
    """Append one ``{"ts": ..., "metrics": {...}}`` snapshot line."""
    # mxtpu-lint: disable=wall-clock (JSONL record timestamp)
    rec = {"ts": round(time.time(), 3), "metrics": registry.snapshot()}
    if extra:
        rec.update(extra)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return path


def serve_http(registry, port, host="127.0.0.1"):
    """Start a daemon-thread HTTP endpoint; returns the server
    (``server.server_address[1]`` is the bound port — pass ``port=0``
    for an ephemeral one; ``server.shutdown()`` stops it).

    Routes: ``/metrics`` (Prometheus text), ``/metrics.json`` (registry
    snapshot), ``/statusz`` (live introspection HTML),
    ``/statusz.json`` (same as JSON — statusz.py providers) and
    ``/healthz`` (cheap liveness/readiness JSON from the statusz
    health providers — no registry render, no statusz assembly, so
    supervisors/routers can probe at high frequency)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path in ("/", "/metrics"):
                body = to_prometheus_text(registry).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif self.path == "/healthz":
                from . import statusz

                body = json.dumps(statusz.health()).encode()
                ctype = "application/json"
            elif self.path == "/metrics.json":
                body = json.dumps(registry.snapshot()).encode()
                ctype = "application/json"
            elif self.path in ("/statusz", "/statusz.json"):
                from . import statusz

                snap = statusz.snapshot()
                if self.path.endswith(".json"):
                    body = json.dumps(snap, default=str).encode()
                    ctype = "application/json"
                else:
                    body = statusz.render_html(snap).encode()
                    ctype = "text/html; charset=utf-8"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):      # no stderr chatter per scrape
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="mxtpu-telemetry-http")
    thread.start()
    return server
