"""Runtime of the port: the train and eval steps, the KV pool, scheduler,
engine, sampling, fault injection and the restartable training loop, the
tick watchdog and the kernel monitor.

Exports resolve lazily (PEP 562), as the JAX package's do:
:mod:`repro_torch.artifacts.store` imports :mod:`repro_torch.runtime.faults`
at module scope, and an eager ``from .serving import ...`` here would pull
the engine (and the dispatch cache being imported) into every artifact
read.  ``from repro_torch.runtime import ServeEngine`` still works.
"""
from typing import Dict

_EXPORTS: Dict[str, str] = {
    # steps
    "build_eval_step": "steps", "build_serve_steps": "steps",
    "build_train_step": "steps", "cross_entropy": "steps",
    "greedy_sample": "steps", "loss_fn": "steps",
    "warm_steps_dispatch": "steps", "warm_train_dispatch": "steps",
    # ft
    "StragglerMonitor": "ft", "TrainController": "ft",
    "elastic_mesh_shape": "ft",
    # faults
    "ANY_TICK": "faults", "FaultError": "faults", "FaultInjector": "faults",
    "FaultSchedule": "faults", "FaultSpec": "faults", "FatalFault": "faults",
    "InjectedFault": "faults", "InjectedIOFault": "faults",
    "TickWatchdog": "faults", "inject": "faults",
    # kv_pool
    "GARBAGE_BLOCK": "kv_pool", "PREFIX_ROOT": "kv_pool",
    "PagedKVPool": "kv_pool", "PoolStats": "kv_pool",
    # monitor
    "KernelMonitor": "monitor", "MonitorStats": "monitor",
    "SwapEvent": "monitor", "cand_key": "monitor",
    # scheduler
    "Request": "scheduler", "RequestError": "scheduler",
    "Scheduler": "scheduler", "SeqState": "scheduler",
    "TickPlan": "scheduler",
    # serving
    "ServeEngine": "serving", "warm_kernel_dispatch": "serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
