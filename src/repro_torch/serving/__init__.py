"""Serving engine: continuous batching over a paged approximate-memory KV
pool with page-granular reactive repair, a repair-aware prefix cache
(``PrefixCache``) and a host-memory exact page tier (``HostPageStore``,
``TierManager``)."""
from .config import ServingConfig  # noqa: F401
from .engine import Engine, engine_space  # noqa: F401
from .pool import PagedKVPool  # noqa: F401
from .prefix_cache import CacheHit, PrefixCache  # noqa: F401
from .repair import PageRepairManager  # noqa: F401
from .scheduler import Request, RequestState, Scheduler  # noqa: F401
from .tiers import HostPageStore, SwapHandle, TierManager  # noqa: F401
from .workload import Arrival, WorkloadConfig, generate_arrivals  # noqa: F401

__all__ = [
    "Arrival", "CacheHit", "Engine", "HostPageStore", "PagedKVPool",
    "PageRepairManager", "PrefixCache", "Request", "RequestState",
    "Scheduler", "ServingConfig", "SwapHandle", "TierManager",
    "WorkloadConfig", "engine_space", "generate_arrivals",
]
