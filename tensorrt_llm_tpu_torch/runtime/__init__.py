from .request import FinishReason, LlmRequest, LlmRequestState  # noqa: F401
from .kv_cache_manager import KVCacheManager, NoFreeBlocksError  # noqa: F401
from .scheduler import (CapacityScheduler, CapacitySchedulerPolicy,  # noqa: F401
                        MicroBatchScheduler, RequestScheduler,
                        ScheduledRequests)
