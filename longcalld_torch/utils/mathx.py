"""Statistics helpers: Fisher exact test and Phred genotype-quality math.

Mirrors reference/src/math_utils.c (log-space hypergeometric with
mode-outward two-tailed summation) and the QUAL/GQ integer truncation of
cal_var_QUAL1 / cal_sample_GQ (reference/src/collect_var.c:1435-1457) —
the C-style int casts matter for byte-identical VCF output.
"""

from __future__ import annotations

import math
from functools import lru_cache

_DBL_EPSILON = 2.220446049250313e-16


@lru_cache(maxsize=None)
def _lg(x: int) -> float:
    return math.lgamma(x) if x > 0 else math.inf if x == 0 else math.lgamma(x)


def log_hypergeometric(a: int, b: int, c: int, d: int) -> float:
    n1, n2, m1, m2 = a + b, c + d, a + c, b + d
    if n1 > n2:
        return log_hypergeometric(c, d, a, b)
    if m1 > m2:
        return log_hypergeometric(b, a, d, c)
    N = n1 + n2
    return (_lg(n1 + 1) + _lg(n2 + 1) + _lg(m1 + 1) + _lg(m2 + 1)
            - (_lg(a + 1) + _lg(b + 1) + _lg(c + 1) + _lg(d + 1) + _lg(N + 1)))


def fisher_exact_two_tailed(a: int, b: int, c: int, d: int) -> float:
    """Two-tailed Fisher exact p; mode-outward summation of tables with
    p <= p_observed (math_utils.c:119-170)."""
    if a + b + c + d == 0:
        # empty table: the reference's mode division is undefined here
        # (0/0 in C); every caller gates on nonzero depth first
        return 1.0
    p_obs = math.exp(log_hypergeometric(a, b, c, d))
    # the reference's ternary (math_utils.c:128) compares against
    # (a+c) - N, so min_a is 0 unless b+d == 0 — a tighter bound here
    # (e.g. max(0, (a+c)-(b+d))) would skip valid below-mode tables and
    # return 0 for degenerate margins like (12,1,3,0)
    min_a = 0 if (a + c) - (a + b + c + d) < 0 else (a + c) - (b + d)
    max_a = min(a + b, a + c)
    mode_a = int((a + b) * (a + c) / (a + b + c + d))
    total = 0.0
    for delta in range(0, max_a - min_a + 1):
        ca = mode_a + delta
        if ca <= max_a:
            cb, cc = (a + b) - ca, (a + c) - ca
            cd = (b + d) - cb
            if cb >= 0 and cc >= 0 and cd >= 0:
                p = math.exp(log_hypergeometric(ca, cb, cc, cd))
                if p <= p_obs + _DBL_EPSILON:
                    total += p
        if delta > 0:
            ca = mode_a - delta
            if ca >= min_a:
                cb, cc = (a + b) - ca, (a + c) - ca
                cd = (b + d) - cb
                if cb >= 0 and cc >= 0 and cd >= 0:
                    p = math.exp(log_hypergeometric(ca, cb, cc, cd))
                    if p <= p_obs + _DBL_EPSILON:
                        total += p
    return total


def log_beta(alpha: int, beta: int) -> float:
    """log B(a, b) (math_utils.c:56-62; the C static-cache branch there is
    dead — last_alpha/last_beta/last_result are never updated — so the live
    behavior is exactly this expression)."""
    return _lg(alpha) + _lg(beta) - _lg(alpha + beta)


def log_binom_pmf(k: int, n: int, theta: float) -> float:
    """log P(k | n, theta) (math_utils.c:66-81)."""
    if k < 0 or k > n:
        return -math.inf
    if theta == 0.0:
        return 0.0 if k == 0 else -math.inf
    if theta == 1.0:
        return 0.0 if k == n else -math.inf
    log_comb = _lg(n + 1) - _lg(k + 1) - _lg(n - k + 1)
    return log_comb + k * math.log(theta) + (n - k) * math.log1p(-theta)


def log_betabinom_pmf(k: int, n: int, alpha: int, beta: int) -> float:
    """log P(k | n, a, b) beta-binomial (math_utils.c:84-88).  Latent in the
    reference main path (the somatic caller uses hard filters instead); kept
    for component parity and future model-based filtering."""
    return (_lg(n + 1) - _lg(k + 1) - _lg(n - k + 1)
            + log_beta(k + alpha, n - k + beta) - log_beta(alpha, beta))


def log_bayes_factor(k: int, n: int, alpha: int, beta: int,
                     error_rate: float) -> float:
    """log BF = log P_H1(k | n, a, b) - log P_H0(k | n, theta)
    (math_utils.c:91-103, minus its printf debugging)."""
    return log_betabinom_pmf(k, n, alpha, beta) \
        - log_binom_pmf(k, n, error_rate)


def cal_var_qual(ref_depth: int, alt_depth: int, log_p: float, log_1p: float,
                 max_qual: int) -> int:
    """cal_var_QUAL1: QUAL = min(max, int(-10*(ref*log10(1-p)+alt*log10 p)))."""
    return min(max_qual, int(-10 * (ref_depth * log_1p + alt_depth * log_p)))


def cal_sample_gq(ref_depth: int, alt_depth: int, log_p: float, log_1p: float,
                  log_2: float, max_gq: int) -> int:
    """cal_sample_GQ: GQ = second-smallest PL minus smallest PL, capped."""
    pl0 = int(-10 * (ref_depth * log_1p + alt_depth * log_p))
    pl1 = int(10 * (ref_depth + alt_depth) * log_2)
    pl2 = int(-10 * (ref_depth * log_p + alt_depth * log_1p))
    pls = [pl0, pl1, pl2]
    mn = min(pls)
    pls.remove(mn)
    sec = min(pls)
    return min(max_gq, sec - mn)
