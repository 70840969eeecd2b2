"""Prometheus text exposition + live introspection endpoint (stdlib-only).

:func:`render_prometheus` converts one :func:`repro_torch.obs.metrics.snapshot`
into text exposition format 0.0.4 — the same snapshot dict the JSON
consumers get, taken once, so `/metrics` is *snapshot-consistent*: every
line in one scrape comes from the same instant, never a counter from
before a containment event next to a histogram from after it.

Rendering rules:

* counters/gauges emit one ``name{labels} value`` line per series with
  ``# TYPE``/``# HELP`` headers;
* histograms emit the cumulative ``_bucket{le=...}`` ladder (our
  snapshot stores per-bucket counts; the renderer accumulates) plus
  ``_sum``/``_count`` and a terminal ``le="+Inf"`` bucket;
* label values are escaped per the spec (backslash, double-quote,
  newline); metric/label names in this codebase are already
  ``[a-z_][a-z0-9_]*`` and are emitted as-is;
* the snapshot's ``_meta`` block becomes ``repro_process_*`` gauges so a
  scrape is self-describing without parsing JSON;
* per-series ``rid`` exemplars stay in the JSON snapshot only — classic
  text format has no exemplar syntax, and emitting them would break the
  format validation the CI lane runs.

:class:`IntrospectionServer` wraps the renderer in a stdlib
``ThreadingHTTPServer`` on a daemon thread: ``/metrics`` (exposition),
``/healthz``, ``/slo`` (:func:`repro_torch.obs.slo.report`), plus any JSON
provider the launcher registers (``/plans``, ``/tenants``).  Handlers
only *read* snapshots; nothing a scrape does can perturb planning.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional

from . import metrics, slo

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def escape_label_value(v: str) -> str:
    return (v.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


def escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: Any) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: Mapping[str, str],
                extra: Optional[Mapping[str, str]] = None) -> str:
    items = list(labels.items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(str(v))}"'
                     for k, v in items)
    return "{" + inner + "}"


def _sanitize_name(name: str) -> str:
    if _NAME_RE.match(name):
        return name
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name) or "_"


def render_prometheus(snap: Optional[Mapping[str, Any]] = None) -> str:
    """Render one metrics snapshot as text exposition format 0.0.4."""
    if snap is None:
        snap = metrics.snapshot()
    out: List[str] = []
    meta = snap.get("_meta")
    if isinstance(meta, dict):
        for key, mname in (("start_time", "repro_process_start_time_seconds"),
                           ("uptime_s", "repro_process_uptime_seconds"),
                           ("pid", "repro_process_pid"),
                           ("plancache_schema",
                            "repro_plancache_schema_version")):
            if key in meta and meta[key] is not None:
                out.append(f"# TYPE {mname} gauge")
                out.append(f"{mname} {_fmt_value(meta[key])}")
    for name in sorted(snap):
        m = snap[name]
        if not isinstance(m, dict) or "type" not in m:
            continue                     # _meta and future non-metric blocks
        mtype = m["type"]
        pname = _sanitize_name(name)
        if m.get("help"):
            out.append(f"# HELP {pname} {escape_help(m['help'])}")
        out.append(f"# TYPE {pname} {mtype}")
        for s in m.get("series", []):
            labels = s.get("labels", {})
            if mtype == "histogram":
                bounds = s["buckets"]["le"]
                counts = s["buckets"]["counts"]
                cum = 0
                for bound, n in zip(bounds, counts):
                    cum += n
                    le = "+Inf" if bound == "inf" else _fmt_value(bound)
                    out.append(f"{pname}_bucket"
                               f"{_labels_str(labels, {'le': le})} {cum}")
                out.append(f"{pname}_sum{_labels_str(labels)} "
                           f"{_fmt_value(s['sum'])}")
                out.append(f"{pname}_count{_labels_str(labels)} "
                           f"{s['count']}")
            else:
                out.append(f"{pname}{_labels_str(labels)} "
                           f"{_fmt_value(s['value'])}")
    return "\n".join(out) + "\n"


def validate_exposition(text: str) -> List[str]:
    """Syntax-check text exposition format; returns a list of problems
    (empty = valid).  This is the checker the CI smoke lane and the unit
    tests run against a live ``/metrics`` scrape."""
    problems: List[str] = []
    typed: Dict[str, str] = {}
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
        r"(\{(.*)\})?"                           # optional label block
        r" (NaN|[+-]?Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"
        r"( [0-9]+)?$")                          # optional timestamp
    label_re = re.compile(
        r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(f"line {i}: malformed TYPE line: {line!r}")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP ") or line.startswith("#"):
            continue
        mm = sample_re.match(line)
        if not mm:
            problems.append(f"line {i}: malformed sample: {line!r}")
            continue
        name, _block, inner, _value, _ts = mm.groups()
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            problems.append(f"line {i}: sample {name!r} has no TYPE line")
        if inner:
            consumed = label_re.sub("", inner).replace(",", "").strip()
            if consumed:
                problems.append(
                    f"line {i}: malformed labels {inner!r}")
            for lname, _lval in label_re.findall(inner):
                if not _LABEL_RE.match(lname):
                    problems.append(
                        f"line {i}: bad label name {lname!r}")
    return problems


# --------------------------------------------------- introspection server
class _Handler(BaseHTTPRequestHandler):
    def log_message(self, fmt: str, *args: Any) -> None:  # silence stderr
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj: Any, code: int = 200) -> None:
        body = json.dumps(obj, indent=1, sort_keys=True,
                          default=str).encode()
        self._send(code, body, "application/json")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, render_prometheus().encode(), CONTENT_TYPE)
            elif path == "/healthz":
                self._send_json({"ok": True,
                                 "uptime_s": time.time() - self.server.t0})
            elif path == "/slo":
                self._send_json(slo.report())
            elif path == "/":
                self._send_json({"endpoints": sorted(
                    ["/metrics", "/healthz", "/slo"]
                    + list(self.server.providers))})
            elif path in self.server.providers:
                self._send_json(self.server.providers[path]())
            else:
                self._send_json({"error": f"no such endpoint {path}"},
                                code=404)
        except BrokenPipeError:
            pass
        except Exception as e:  # a broken provider must not kill the thread
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"},
                                code=500)
            except OSError:
                pass


class IntrospectionServer:
    """Read-only HTTP introspection on a daemon thread.

    ``port=0`` binds an ephemeral port (tests, CI); :attr:`port` after
    :meth:`start` is the bound one.  :meth:`add_provider` registers extra
    JSON endpoints (``/plans``, ``/tenants``) as zero-arg callables
    evaluated per request — always the live view, never a startup copy.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1") -> None:
        self.host = host
        self.port = port
        self.t0 = time.time()
        self.providers: Dict[str, Callable[[], Any]] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def add_provider(self, path: str, fn: Callable[[], Any]) -> None:
        if not path.startswith("/"):
            path = "/" + path
        self.providers[path.rstrip("/")] = fn

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "IntrospectionServer":
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.t0 = self.t0                       # type: ignore[attr-defined]
        httpd.providers = self.providers         # type: ignore[attr-defined]
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="repro-introspect", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
