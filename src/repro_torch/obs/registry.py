"""The unified metrics registry over the serving stack's stats surfaces.

``PoolStats``, ``SchedStats``, ``DispatchStats``, ``MonitorStats``,
``WatchdogStats``, and the flight recorder each count their own corner;
:class:`ObsRegistry` joins them behind one snapshot API:

* :meth:`ObsRegistry.snapshot` — nested plain dict (JSON-ready);
* :meth:`ObsRegistry.render_text` — Prometheus-style text exposition
  (``repro_<group>_<name> <value>`` lines, sorted);
* :meth:`ObsRegistry.summary_line` — the one-line operator summary that
  replaces the scattered prints in ``launch/serve.py``;
* :meth:`ObsRegistry.kernel_report` — per-kernel provenance lines read
  from the *current* frozen plan (post-swap/post-demote picks with their
  live source and demotion marks, not the warm-up snapshot).

Construction is by parts or :meth:`from_engine`; either way the parts
are re-read at snapshot time, so a monitor attached or a plan republished
after construction is reported, not the stale reference.
"""
from __future__ import annotations

from dataclasses import asdict, is_dataclass
from typing import Any, Dict, List, Optional


def _stats_dict(obj: Any) -> Dict[str, Any]:
    if obj is None:
        return {}
    if is_dataclass(obj) and not isinstance(obj, type):
        return dict(asdict(obj))
    if hasattr(obj, "as_dict"):
        return dict(obj.as_dict())
    return {}


class ObsRegistry:
    """One snapshot surface over pool/scheduler/dispatch/monitor/watchdog
    stats plus the flight recorder."""

    def __init__(self, *, engine: Any = None, pool: Any = None,
                 sched: Any = None, cache: Any = None, monitor: Any = None,
                 watchdog: Any = None, recorder: Any = None):
        self._engine = engine
        self._pool = pool
        self._sched = sched
        self._cache = cache
        self._monitor = monitor
        self._watchdog = watchdog
        self._recorder = recorder

    @classmethod
    def from_engine(cls, engine: Any,
                    recorder: Any = None) -> "ObsRegistry":
        """Bind to a :class:`repro_torch.runtime.serving.ServeEngine`;
        parts are resolved per snapshot, so late-attached pieces are picked
        up."""
        return cls(engine=engine, recorder=recorder)

    # -- part resolution (engine-bound parts win) -----------------------------
    def _part(self, name: str, attr: str) -> Any:
        if self._engine is not None:
            return getattr(self._engine, attr, None)
        return getattr(self, name)

    @property
    def pool(self) -> Any:
        return self._part("_pool", "pool")

    @property
    def sched(self) -> Any:
        return self._part("_sched", "sched")

    @property
    def cache(self) -> Any:
        return self._part("_cache", "_cache")

    @property
    def monitor(self) -> Any:
        return self._part("_monitor", "monitor")

    @property
    def watchdog(self) -> Any:
        return self._part("_watchdog", "watchdog")

    @property
    def recorder(self) -> Any:
        if self._recorder is not None:
            return self._recorder
        from . import recorder as _rec
        return _rec.get_recorder()

    # -- snapshot -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Nested dict of every attached surface's counters plus derived
        gauges.  Sections for absent parts are empty dicts, so consumers
        can iterate without presence checks."""
        out: Dict[str, Dict[str, Any]] = {}
        pool = self.pool
        out["pool"] = _stats_dict(getattr(pool, "stats", None))
        if pool is not None:
            out["pool"].update(capacity=pool.capacity,
                               num_free=pool.num_free,
                               num_live=pool.num_live,
                               page_size=pool.page_size)
        sched = self.sched
        out["sched"] = _stats_dict(getattr(sched, "stats", None))
        if sched is not None:
            out["sched"].update(ticks=sched.ticks,
                                queue_depth=len(sched.queue),
                                running=len(sched.running()))
        cache = self.cache
        out["dispatch"] = _stats_dict(getattr(cache, "stats", None))
        if cache is not None:
            plan = cache.frozen_plan
            out["dispatch"].update(
                frozen_entries=len(plan) if plan is not None else 0,
                degrade_events=len(cache.degrade_events))
        mon = self.monitor
        out["monitor"] = _stats_dict(getattr(mon, "stats", None))
        if mon is not None:
            out["monitor"]["swap_events"] = len(mon.events)
        out["watchdog"] = _stats_dict(
            getattr(self.watchdog, "stats", None))
        rec = self.recorder
        out["recorder"] = ({} if rec is None else {
            "emitted": rec.emitted, "buffered": len(rec),
            "dropped": rec.dropped, "capacity": rec.capacity,
            "sample_frozen_every": rec.sample_frozen_every})
        return out

    # -- renderings -----------------------------------------------------------
    def render_text(self) -> str:
        """Prometheus-style exposition: one ``repro_<group>_<name> <value>``
        line per numeric counter/gauge, sorted for stable diffs."""
        lines: List[str] = []
        for group, section in sorted(self.snapshot().items()):
            for name, value in sorted(section.items()):
                if isinstance(value, bool) or not isinstance(value,
                                                             (int, float)):
                    continue
                v = f"{value:.6g}" if isinstance(value, float) else str(value)
                lines.append(f"repro_{group}_{name} {v}")
        return "\n".join(lines) + ("\n" if lines else "")

    def summary_line(self) -> str:
        """The operator one-liner: each attached surface's headline
        counters, ``|``-separated (the unified replacement for the
        scattered prints ``launch/serve.py`` used to build by hand)."""
        s = self.snapshot()
        parts: List[str] = []
        if s["sched"]:
            d = s["sched"]
            parts.append(
                f"ticks={d.get('ticks', 0)} adm={d.get('admissions', 0)} "
                f"wait={d.get('admission_waits', 0)} "
                f"preempt={d.get('preemptions', 0)} shed={d.get('shed', 0)} "
                f"cancel={d.get('cancelled', 0)} "
                f"poison={d.get('poisoned', 0)}")
        if s["pool"]:
            d = s["pool"]
            parts.append(
                f"pool live={d.get('num_live', 0)}/{d.get('capacity', 0)} "
                f"peak={d.get('peak_live', 0)} "
                f"prefix_hits={d.get('prefix_hits', 0)} "
                f"saved={d.get('prefix_tokens_saved', 0)} "
                f"cow={d.get('cow_copies', 0)} "
                f"evict={d.get('cache_evictions', 0)}")
        if s["dispatch"]:
            d = s["dispatch"]
            parts.append(
                f"dispatch frozen={d.get('frozen_entries', 0)} "
                f"mem={d.get('memory_hits', 0)} disk={d.get('disk_hits', 0)} "
                f"cold={d.get('cold_builds', 0)} "
                f"demote={d.get('demotions', 0)}")
        if s["monitor"]:
            d = s["monitor"]
            blocked = (d.get("swap_blocked_infeasible", 0)
                       + d.get("swap_blocked_gen", 0))
            parts.append(
                f"monitor probes={d.get('probes', 0)} "
                f"swaps={d.get('swaps', 0)} blocked={blocked}")
        if s["watchdog"]:
            d = s["watchdog"]
            parts.append(f"watchdog slow={d.get('slow_ticks', 0)} "
                         f"worst={d.get('worst_ratio', 0.0):.1f}x")
        if s["recorder"]:
            d = s["recorder"]
            parts.append(f"trace n={d.get('emitted', 0)} "
                         f"dropped={d.get('dropped', 0)}")
        return "obs " + " | ".join(parts) if parts else "obs (no surfaces)"

    def kernel_report(self) -> List[str]:
        """Per-kernel provenance lines from the *current* frozen plan:
        label, live candidate, the source that decided it (``measured``
        after a monitor swap, even if warm-up said ``symbolic``), and any
        demotion marks in effect.  Empty without a frozen plan."""
        cache = self.cache
        plan = getattr(cache, "frozen_plan", None)
        if plan is None:
            return []
        from ..plans.trace import op_label
        lines = []
        for family, machine, data in plan.triples:
            ent = plan.get(family.name, machine.name, data)
            if ent is None:
                continue
            label = op_label(family.name, dict(data))
            marks = cache.demoted_keys(family.name, machine.name, data)
            tail = f" demoted_marks={len(marks)}" if marks else ""
            lines.append(f"kernel {label} [{ent.source}]: "
                         f"{ent.candidate.describe()}{tail}")
        return sorted(lines)
