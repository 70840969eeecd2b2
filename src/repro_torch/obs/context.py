"""Request-correlation IDs for the serving stack (stdlib-only).

One :mod:`contextvars` variable holds the *current* request/incident ID.
Everything downstream that observes — spans (:mod:`repro_torch.obs.trace`),
metric exemplars (:mod:`repro_torch.obs.metrics`), flight-recorder events
(:mod:`repro_torch.obs.flightrec`) — reads it with :func:`current` and stamps
whatever it records, so one serving decision can be reconstructed across
the plan service, the re-plan ladder, the tenancy runtime and the pool
workers after the fact (``python -m repro_torch.obs incident``).

Propagation rules (DESIGN_OBS.md):

* :func:`correlate` *reuses* an already-set ID — a plan-service resolve
  nested inside a tenancy containment incident inherits the incident ID
  instead of minting its own, which is exactly what makes the incident
  timeline reconstructable;
* worker processes receive the parent's ID explicitly with each job
  (``repro_torch.parallel.search_exec`` ships it alongside the trace flag) and
  :func:`attach` it before running, so worker spans land on the same ID;
* IDs are never read back to make a decision — correlation is
  observation, and the bit-identity invariant of the whole obs layer
  applies unchanged.

IDs are ``<prefix>-<pid hex>-<counter hex>``: unique within a process
tree without importing :mod:`uuid` or reading a clock (both banned from
hot paths), and stable enough to grep across a dump, a trace, and a
metrics snapshot.
"""
from __future__ import annotations

import contextvars
import itertools
import os
from contextlib import contextmanager
from typing import Iterator, Optional

_VAR: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_request_id", default=None)
_COUNTER = itertools.count(1)


def current() -> Optional[str]:
    """The active request/incident ID, or None outside any correlation."""
    return _VAR.get()


def new_id(prefix: str = "req") -> str:
    """Mint a fresh ID (does not set it; see :func:`correlate`)."""
    return f"{prefix}-{os.getpid():x}-{next(_COUNTER):04x}"


def attach(rid: Optional[str]) -> contextvars.Token:
    """Set the current ID directly (worker-process entry; pair with
    :func:`detach`)."""
    return _VAR.set(rid)


def detach(token: contextvars.Token) -> None:
    _VAR.reset(token)


@contextmanager
def correlate(prefix: str = "req",
              rid: Optional[str] = None) -> Iterator[str]:
    """Scope a correlation ID.

    With ``rid=None`` (the normal case) an already-active ID is *reused*
    — nested work stays on the enclosing request/incident — and a fresh
    one is minted only at the outermost entry point.  Passing ``rid``
    explicitly forces that ID for the scope (dump replay, tests).
    """
    if rid is None:
        cur = _VAR.get()
        if cur is not None:
            yield cur
            return
        rid = new_id(prefix)
    token = _VAR.set(rid)
    try:
        yield rid
    finally:
        _VAR.reset(token)
