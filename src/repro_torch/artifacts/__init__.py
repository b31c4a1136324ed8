"""Runtime dispatch of the port (memory LRU + frozen lane + cold tier)."""
from .dispatch import DispatchCache, get_default_cache, set_default_cache

__all__ = ["DispatchCache", "get_default_cache", "set_default_cache"]
