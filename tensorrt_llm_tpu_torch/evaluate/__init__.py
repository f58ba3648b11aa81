"""Teacher-forced scoring (the JAX package's ``evaluate`` subpackage:
``perplexity.py``)."""
