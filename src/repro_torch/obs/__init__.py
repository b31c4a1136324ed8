"""Decision-provenance tracing + unified metrics registry (the port's copy
of ``repro.obs``: the same code, the same events and JSONL records, so
``scripts/trace_report.py`` reads a trace of either package).

The paper's artifact is a *case discussion*: every kernel launch is the
result of a branch taken through the comprehensive tree at concrete
(machine, program) parameter values.  This package makes that decision —
and the serving stack's operational decisions around it — observable as
one joinable event stream plus one snapshot API:

* :mod:`repro_torch.obs.events` — the event taxonomy (``TickSpan``,
  ``DispatchDecision``, ``FaultFired``, ``PrefixHit``,
  ``AdmissionDecision``; the monitor's ``SwapEvent`` and the cache's
  ``DegradeEvent`` join the stream as-is), the JSONL schema + validator,
  and the shared transition renderer both ``describe()``s delegate to.
* :mod:`repro_torch.obs.recorder` — the flight recorder: a bounded ring of
  events with monotonic sequence ids and byte-deterministic JSONL
  export, installed process-wide as a module global (one module-global
  load when tracing is off).
* :mod:`repro_torch.obs.registry` — :class:`ObsRegistry`: the stats
  dataclasses scattered across pool/scheduler/dispatch/monitor/watchdog
  unified behind ``snapshot()`` / ``render_text()`` / ``summary_line()``.

Everything here is stdlib-only so the light modules
(``artifacts.dispatch``, ``runtime.kv_pool``, ``runtime.scheduler``) can
import it at module scope without pulling torch or the engine in.
"""
from .events import (EVENT_SCHEMA, AdmissionDecision, DispatchDecision,
                     FaultFired, PrefixHit, TickSpan, describe_transition,
                     event_record, validate_record)
from .recorder import (FlightRecorder, emit, get_recorder, install, set_tick,
                       tracing)
from .registry import ObsRegistry

__all__ = [
    "EVENT_SCHEMA", "AdmissionDecision", "DispatchDecision", "FaultFired",
    "PrefixHit", "TickSpan", "describe_transition", "event_record",
    "validate_record", "FlightRecorder", "emit", "get_recorder", "install",
    "set_tick", "tracing", "ObsRegistry",
]
