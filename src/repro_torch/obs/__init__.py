"""Planner observability for the port: the four stdlib-only layers the
planning stack itself imports.

* :mod:`repro_torch.obs.context`   — request / incident correlation IDs;
* :mod:`repro_torch.obs.metrics`   — counter / gauge / histogram registry;
* :mod:`repro_torch.obs.trace`     — span tracer (``REPRO_TRACE=<path>``);
* :mod:`repro_torch.obs.flightrec` — bounded ring buffer of serving events.

``slo``, ``expo``, ``explain`` and the ``python -m`` entry point of the
reference are not ported yet (ROADMAP.md, Queue 1).
"""
from . import context, flightrec, metrics, trace

__all__ = ["context", "flightrec", "metrics", "trace"]
