"""Serving engine: continuous batching over a paged approximate-memory KV
pool with page-granular reactive repair."""
from .config import ServingConfig  # noqa: F401
from .engine import Engine, engine_space  # noqa: F401
from .pool import PagedKVPool  # noqa: F401
from .repair import PageRepairManager  # noqa: F401
from .scheduler import Request, RequestState, Scheduler  # noqa: F401
from .workload import Arrival, WorkloadConfig, generate_arrivals  # noqa: F401

__all__ = [
    "Arrival", "Engine", "PagedKVPool", "PageRepairManager", "Request",
    "RequestState", "Scheduler", "ServingConfig", "WorkloadConfig",
    "engine_space", "generate_arrivals",
]
