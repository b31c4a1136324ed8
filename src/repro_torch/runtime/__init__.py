"""Serving runtime of the port: KV pool, scheduler, engine, sampling."""
from .kv_pool import GARBAGE_BLOCK, PagedKVPool
from .scheduler import Request, RequestError, Scheduler
from .serving import ServeEngine, warm_kernel_dispatch
from .steps import greedy_sample

__all__ = ["GARBAGE_BLOCK", "PagedKVPool", "Request", "RequestError",
           "Scheduler", "ServeEngine", "greedy_sample",
           "warm_kernel_dispatch"]
