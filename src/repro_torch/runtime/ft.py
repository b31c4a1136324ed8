"""Fault tolerance: restart loop, straggler detection, elastic re-mesh.

At thousand-node scale the failure model is: hosts vanish (preemption,
hardware), hosts slow down (thermal, network), and the job must make
progress anyway.  Three mechanisms:

* :class:`TrainController` — the restartable outer loop.  Checkpoint every
  ``ckpt_every`` steps (async).  Any step that raises is retried from the
  latest valid checkpoint; the data pipeline is stateless (`batch_at(step)`)
  so the replay is exact.  An injectable ``fault_hook`` lets tests (and
  chaos drills) kill arbitrary steps.
* :class:`StragglerMonitor` — EWMA + percentile step-time tracker.  A host
  whose step time exceeds ``factor``× the rolling median is flagged;
  the controller logs it and (in a real deployment) the scheduler would
  swap the host.  Detection logic is pure and unit-tested.
* :func:`elastic_mesh_shape` — re-derive the (data, model) mesh from a
  surviving device count.  Model-parallel degree is kept if possible
  (weights reshard cheaply along data), else reduced to the largest
  divisor; training resumes from the checkpoint with the new mesh — the
  checkpoint format is sharding-agnostic (host-gathered numpy leaves).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger("repro.ft")

PyTree = Any


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------

@dataclass
class StragglerMonitor:
    factor: float = 2.0          # flag hosts slower than factor x median
    window: int = 64             # rolling window of step times per host
    min_samples: int = 8
    _times: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, host: int, seconds: float) -> None:
        buf = self._times.setdefault(host, [])
        buf.append(seconds)
        if len(buf) > self.window:
            del buf[0]

    def medians(self) -> Dict[int, float]:
        return {h: float(np.median(v)) for h, v in self._times.items() if v}

    def stragglers(self) -> List[int]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        counts = {h: len(self._times[h]) for h in meds}
        global_med = float(np.median(list(meds.values())))
        return [h for h, m in meds.items()
                if counts[h] >= self.min_samples and
                m > self.factor * global_med]


# ---------------------------------------------------------------------------
# Elastic mesh policy
# ---------------------------------------------------------------------------

def elastic_mesh_shape(n_devices: int, *, prefer_model: int = 16,
                       ) -> Tuple[int, int]:
    """(data, model) for a surviving device count.

    Keeps model-parallel degree at ``prefer_model`` when divisible (weights
    need no resharding along the model axis), else the largest divisor —
    training always restarts with *some* valid mesh as long as one device
    survives.
    """
    if n_devices <= 0:
        raise ValueError("no surviving devices")
    model = prefer_model
    while model > 1 and n_devices % model != 0:
        model //= 2
    return n_devices // model, model


# ---------------------------------------------------------------------------
# Restartable training controller
# ---------------------------------------------------------------------------

@dataclass
class TrainController:
    """Checkpoint/restart training loop with fault injection hooks.

    ``run_step(state, step) -> (state, metrics)`` is the jitted train step
    already closed over the mesh; ``state`` is any pytree (params +
    opt_state).  ``next_batch(step)`` is the stateless data address.
    """

    run_step: Callable[[PyTree, int], Tuple[PyTree, Dict[str, float]]]
    ckpt: Any                                 # CheckpointManager
    ckpt_every: int = 50
    max_retries: int = 3
    fault_hook: Optional[Callable[[int], None]] = None   # raises to inject
    monitor: StragglerMonitor = field(default_factory=StragglerMonitor)
    host_index: int = 0

    def run(self, state: PyTree, *, start_step: int, num_steps: int
            ) -> Tuple[PyTree, List[Dict[str, float]]]:
        history: List[Dict[str, float]] = []
        initial = state            # pre-first-checkpoint restarts replay this
        step = start_step
        retries = 0
        while step < start_step + num_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                t0 = time.perf_counter()
                state, metrics = self.run_step(state, step)
                dt = time.perf_counter() - t0
                self.monitor.record(self.host_index, dt)
                metrics = dict(metrics)
                metrics["step"] = step
                metrics["step_time_s"] = dt
                history.append(metrics)
                step += 1
                retries = 0
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state)
                slow = self.monitor.stragglers()
                if slow:
                    log.warning("stragglers detected: hosts %s", slow)
            except KeyboardInterrupt:
                raise
            except Exception as e:           # noqa: BLE001 — restart path
                retries += 1
                if retries > self.max_retries:
                    raise
                log.warning("step %d failed (%s); restoring latest "
                            "checkpoint (retry %d/%d)", step, e, retries,
                            self.max_retries)
                restored_step, restored = self.ckpt.restore_latest(state)
                if restored is None:
                    # no checkpoint yet: restart from the initial state —
                    # rewinding the step counter alone would re-apply
                    # updates already folded into the live state
                    step = start_step
                    state = initial
                else:
                    state = restored
                    step = restored_step
        self.ckpt.save(step, state)
        return state, history
