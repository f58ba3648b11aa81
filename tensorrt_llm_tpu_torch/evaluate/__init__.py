"""Accuracy evaluation (the JAX package's ``evaluate`` subpackage):
teacher-forced scoring (``perplexity.py``), the statistical gate
(``accuracy_core.py``), the task evaluators (``tasks.py``) and the
lm-eval-harness bridge (``lm_eval_bridge.py``). The JAX package's
``__init__`` also exports the ``perplexity`` function, which hides the
``perplexity`` module behind the package's attribute of that name; here
the module stays reachable as ``evaluate.perplexity``."""
from .accuracy_core import (compute_threshold,  # noqa: F401
                            hypothesis_test_pass)
from .perplexity import score_token_logprobs  # noqa: F401
