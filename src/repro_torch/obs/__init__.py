"""Planner observability: structured tracing, unified metrics, plan explain.

Three deliberately-decoupled layers (DESIGN_OBS.md):

* :mod:`repro_torch.obs.trace` — a low-overhead span tracer (context-manager +
  decorator API) threaded through the whole planning stack and exported as
  Chrome trace-event JSON (``REPRO_TRACE=<path>`` or
  ``benchmarks/run.py --trace``), with per-worker span buffers merged
  across process boundaries by ``repro_torch.parallel.search_exec``;
* :mod:`repro_torch.obs.metrics` — a process-wide counter/gauge/histogram
  registry with labeled series and a JSON snapshot; the planner's phase
  timings, plancache hit/miss/bypass counters, ``lower_jax`` planner
  fallbacks and worker shard timings all land here;
* :mod:`repro_torch.obs.explain` — plan introspection: per-plan simulated
  resource timelines, an ASCII mesh-utilization heatmap, and
  winner-vs-runner-up per-resource cost diffs
  (``python -m repro_torch.obs explain <suite/cell>``).

The serving stack (PR 10) adds four more stdlib-only layers:

* :mod:`repro_torch.obs.context` — contextvar request/incident correlation IDs
  stamped onto every span, metric exemplar and flight-recorder event;
* :mod:`repro_torch.obs.flightrec` — a bounded ring buffer of structured
  serving events (rung decisions, breaker transitions, faults,
  containment, QoS shed, violations) dumped atomically and rendered by
  ``python -m repro_torch.obs incident <dump>``;
* :mod:`repro_torch.obs.slo` — sliding-window deadline-attainment / rung
  distribution / blast-radius tracking with multi-window burn-rate
  alerts that fire flight-recorder events;
* :mod:`repro_torch.obs.expo` — Prometheus text exposition of the metrics
  registry plus the ``launch/serve.py --introspect-port`` HTTP endpoint
  (``/metrics``, ``/healthz``, ``/slo``, ``/plans``, ``/tenants``).

``trace``, ``metrics``, ``context``, ``flightrec``, ``slo`` and ``expo``
are stdlib-only and import nothing from ``repro_torch.core`` (the core planner
imports *them*); ``explain`` sits above the planner and may import
everything.

The hard invariant of the whole package: **observation never perturbs
planning** — best plans, costs, and cache keys are bit-identical with
tracing on or off, at any worker count (``tests/test_obs.py`` pins this).
"""
from . import context, expo, flightrec, metrics, slo, trace

__all__ = ["context", "expo", "flightrec", "metrics", "slo", "trace"]
