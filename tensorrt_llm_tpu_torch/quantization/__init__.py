from .mode import KvCacheQuantAlgo, QuantAlgo  # noqa: F401
