from .llm import LLM, RequestOutput  # noqa: F401
from .llm_args import KvCacheConfig, LlmArgs  # noqa: F401
