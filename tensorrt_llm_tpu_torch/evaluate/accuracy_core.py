"""Statistical accuracy gating.

A copy of ``tensorrt_llm_tpu/evaluate/accuracy_core.py`` (pure Python;
the port imports nothing of the JAX package). Replicates the *method* of
the reference accuracy harness (reference:
tests/integration/defs/accuracy/accuracy_core.py:44-121 — two-sided
hypothesis testing with α=0.05, β=0.2): instead of exact-match accuracy
thresholds, the pass bar is derived from the reference accuracy, the
evaluation sample count and the per-sample σ, so small true regressions
are caught while sampling noise is tolerated.

H0: new accuracy == reference accuracy. We reject (fail the gate) when
the measured accuracy falls below a threshold chosen so that
P(false alarm) ≤ α and P(missing a true regression of θ) ≤ β.
"""
from __future__ import annotations

import math
from typing import Optional


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation —
    avoids a scipy dependency in the hot path)."""
    if not 0 < p < 1:
        raise ValueError("p must be in (0,1)")
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow = 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > 1 - plow:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)


def compute_theta(num_samples: int, sigma: float,
                  alpha: float = 0.05, beta: float = 0.2) -> float:
    """Minimum detectable accuracy drop θ at the given error rates
    (reference: accuracy_core.py:44)."""
    z_alpha = -_norm_ppf(alpha / 2)   # two-sided
    z_beta = -_norm_ppf(beta)
    return (z_alpha + z_beta) * sigma / math.sqrt(num_samples)


def compute_threshold(num_samples: int, reference_accuracy: float,
                      sigma: float, alpha: float = 0.05,
                      higher_is_better: bool = True) -> float:
    """Pass threshold under H0 (reference: accuracy_core.py:56-69)."""
    z_alpha = -_norm_ppf(alpha / 2)
    margin = z_alpha * sigma / math.sqrt(num_samples)
    if higher_is_better:
        return reference_accuracy - margin
    return reference_accuracy + margin


def hypothesis_test_pass(measured: float, reference: float,
                         num_samples: int, sigma: float,
                         alpha: float = 0.05,
                         higher_is_better: bool = True) -> bool:
    thr = compute_threshold(num_samples, reference, sigma, alpha,
                            higher_is_better)
    return measured >= thr if higher_is_better else measured <= thr
