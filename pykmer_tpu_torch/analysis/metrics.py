"""Binary similarity/distance metric library (Cnidaria V1 heritage).

Vectorised re-implementation of the reference's legacy metric registry
(calculate_distances_cnidaria.py:40-580): ~70 measures over a 2×2 contingency
(a=shared, b=exclusive to X, c=exclusive to Y, d). Reference quirks kept for
parity, documented:

- the reference's contingency builder sets ``d = a + b + c`` (sic — not the
  true "absent in both" count, calculate_distances_cnidaria.py:501); use
  :func:`contingency_from_counts` for that behaviour and
  :func:`contingency_true` for the textbook ``d = data_size - a - b - c``;
- most S_* "similarities" return ``1 - value`` (they are used as distances);
- math errors (division by zero, sqrt/log of invalid values) yield 1.0
  (calculate_distances_cnidaria.py:537-548). Here any non-finite result maps
  to 1.0.

All functions broadcast over numpy arrays, so a full N×N metric matrix is one
call per metric instead of the reference's per-pair Python loop.

Copy of ``pykmer_tpu/analysis/metrics.py``, held against it
by ``tests/test_torch_copies.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


def _metric(fn: Callable) -> Callable:
    def wrapped(a, b, c, d):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        c = np.asarray(c, dtype=np.float64)
        d = np.asarray(d, dtype=np.float64)
        with np.errstate(all="ignore"):
            r = fn(a, b, c, d)
        r = np.asarray(r, dtype=np.float64)
        return np.where(np.isfinite(r), r, 1.0)

    wrapped.__name__ = fn.__name__
    _REGISTRY[fn.__name__] = wrapped
    return wrapped


def available_metrics() -> Sequence[str]:
    return sorted(_REGISTRY)


def compute(name: str, a, b, c, d):
    return _REGISTRY[name](a, b, c, d)


def contingency_from_counts(
    count_x, count_y, shared
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reference-quirk contingency: d = a + b + c (calculate_distances_cnidaria.py:493-501)."""
    a = np.asarray(shared, dtype=np.float64)
    b = np.asarray(count_x, dtype=np.float64) - a
    c = np.asarray(count_y, dtype=np.float64) - a
    d = a + b + c
    return a, b, c, d


def contingency_true(
    count_x, count_y, shared, data_size
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Textbook contingency: d = cells absent in both samples."""
    a = np.asarray(shared, dtype=np.float64)
    b = np.asarray(count_x, dtype=np.float64) - a
    c = np.asarray(count_y, dtype=np.float64) - a
    d = float(data_size) - a - b - c
    return a, b, c, d


def metric_matrix(name: str, kma_matrix: np.ndarray) -> np.ndarray:
    """Apply one metric over a whole (N,N,3) `.kma` matrix at once."""
    count_x = kma_matrix[:, :, 0]
    count_y = kma_matrix[:, :, 1]
    shared = kma_matrix[:, :, 2]
    a, b, c, d = contingency_from_counts(count_x, count_y, shared)
    out = compute(name, a, b, c, d)
    np.fill_diagonal(out, 0.0)
    return out


# --- the registry (numbering follows the reference comments) ---------------

@_metric
def S_jaccard(a, b, c, d):
    return a / (a + b + c)

@_metric
def D_jaccard(a, b, c, d):  # 1
    return 1.0 - a / (a + b + c)

@_metric
def D_jaccard_sqrt(a, b, c, d):
    return np.sqrt(1.0 - a / (a + b + c))

@_metric
def S_dice(a, b, c, d):  # 2
    return 1.0 - (2.0 * a) / (2.0 * a + b + c)

@_metric
def S_jaccard3w(a, b, c, d):  # 4
    return 1.0 - (3.0 * a) / (3.0 * a + b + c)

@_metric
def S_nei_li(a, b, c, d):  # 5
    return 1.0 - (2.0 * a) / ((a + b) + (a + c))

@_metric
def S_sokal_sneath_I(a, b, c, d):  # 6
    return 1.0 - a / (a + 2.0 * b + 2.0 * c)

@_metric
def S_sokal_michener(a, b, c, d):  # 7
    return 1.0 - (a + d) / (a + b + c + d)

@_metric
def S_sokal_sneath_II(a, b, c, d):  # 8
    return 1.0 - (2.0 * (a + d)) / (2.0 * a + b + c + 2.0 * d)

@_metric
def S_roger_tanimoto(a, b, c, d):  # 9
    return 1.0 - (a + d) / (a + 2.0 * (b + c) + d)

@_metric
def S_faith(a, b, c, d):  # 10
    return 1.0 - (a + 0.5 * d) / (a + b + c + d)

@_metric
def S_gower_legendre(a, b, c, d):  # 11
    return 1.0 - (a + d) / (a + 0.5 * (b + c) + d)

@_metric
def S_intersection(a, b, c, d):  # 12
    return a

@_metric
def S_innerproduct(a, b, c, d):  # 13
    return a + d

@_metric
def S_russell_rao(a, b, c, d):  # 14
    return 1.0 - a / (a + b + c + d)

@_metric
def D_hamming(a, b, c, d):  # 15
    return b + c

@_metric
def D_euclid(a, b, c, d):  # 16
    return np.sqrt(b + c)

@_metric
def D_squared_euclid(a, b, c, d):  # 17
    return np.sqrt((b + c) ** 2)

@_metric
def D_mean_manhattan(a, b, c, d):  # 20
    return (b + c) / (a + b + c + d)

@_metric
def D_vari(a, b, c, d):  # 23
    return (b + c) / (4.0 * (a + b + c + d))

@_metric
def D_sized_difference(a, b, c, d):  # 24
    return (b + c) ** 2 / (a + b + c + d) ** 2

@_metric
def D_shaped_difference(a, b, c, d):  # 25
    n = a + b + c + d
    return (n * (b + c) - (b - c) ** 2) / n**2

@_metric
def D_pattern_difference(a, b, c, d):  # 26
    return 4.0 * b * c / (a + b + c + d) ** 2

@_metric
def D_lance_williams(a, b, c, d):  # 27
    return (b + c) / (2.0 * a + b + c)

@_metric
def D_bray_curtis(a, b, c, d):  # 28
    return (b + c) / (2.0 * a + b + c)

@_metric
def D_hellinger(a, b, c, d):  # 29
    return 2.0 * np.sqrt(1.0 - a / np.sqrt((a + b) * (a + c)))

@_metric
def D_chord(a, b, c, d):  # 30
    return np.sqrt(2.0 * (1.0 - a / np.sqrt((a + b) * (a + c))))

@_metric
def S_cosine(a, b, c, d):  # 31
    return 1.0 - a / (np.sqrt((a + b) * (a + c)) ** 2.0)

@_metric
def S_gilbert_wells(a, b, c, d):  # 32
    n = a + b + c + d
    return 1.0 - (np.log(a) - np.log(n) - np.log((a + b) / n) - np.log((a + c) / n))

@_metric
def S_ochiai_I(a, b, c, d):  # 33
    return 1.0 - a / np.sqrt((a + b) * (a + c))

@_metric
def S_forbes_I(a, b, c, d):  # 34
    return 1.0 - ((a + b + c + d) * a) / ((a + b) * (a + c))

@_metric
def S_fossum(a, b, c, d):  # 35
    n = a + b + c + d
    return 1.0 - (n * (a - 0.5) ** 2) / ((a + b) * (a + c))

@_metric
def S_sorgenfrei(a, b, c, d):  # 36
    return 1.0 - a**2 / ((a + b) * (a + c))

@_metric
def S_mountford(a, b, c, d):  # 37
    return 1.0 - a / (0.5 * (a * b + a * c) + b * c)

@_metric
def S_otsuka(a, b, c, d):  # 38
    return 1.0 - a / ((a + b) * (a + c)) ** 0.5

@_metric
def S_mcconnaughey(a, b, c, d):  # 39
    return 1.0 - (a**2 - b * c) / ((a + b) * (a + c))

@_metric
def S_tarwid(a, b, c, d):  # 40
    n = a + b + c + d
    prod = (a + b) * (a + c)
    return 1.0 - (n * a - prod) / (n * a + prod)

@_metric
def S_kulczynski_II(a, b, c, d):  # 41
    return 1.0 - ((a / 2.0) * (2.0 * a + b + c)) / ((a + b) * (a + c))

@_metric
def S_driver_kroeber(a, b, c, d):  # 42
    return 1.0 - (a / 2.0) * (1.0 / (a + b) + 1.0 / (a + c))

@_metric
def S_johson(a, b, c, d):  # 43
    return 1.0 - (a / (a + b) + a / (a + c))

@_metric
def S_dennis(a, b, c, d):  # 44
    n = a + b + c + d
    return 1.0 - (a * d - b * c) / np.sqrt(n * (a + b) * (a + c))

@_metric
def S_simpson(a, b, c, d):  # 45
    return 1.0 - a / np.minimum(a + b, a + c)

@_metric
def S_braun_banquet(a, b, c, d):  # 46
    return 1.0 - a / np.maximum(a + b, a + c)

@_metric
def S_fager_mcgowan(a, b, c, d):  # 47
    return 1.0 - (a / np.sqrt((a + b) * (a + c)) - np.maximum(a + b, a + c) / 2.0)

@_metric
def S_forbes_II(a, b, c, d):  # 48
    n = a + b + c + d
    prod = (a + b) * (a + c)
    return 1.0 - (n * a - prod) / (n * np.minimum(a + b, a + c) - prod)

@_metric
def S_sokal_sneath_IV(a, b, c, d):  # 49
    return 1.0 - (a / (a + b) + a / (a + c) + a / (b + c) + a / (b + d)) / 4.0

@_metric
def S_sokal_sneath_IV2(a, b, c, d):  # 49.2 (reference repeats the b+d term)
    return 1.0 - (a / (a + b) + a / (a + c) + a / (b + d) + a / (b + d)) / 4.0

@_metric
def S_gower(a, b, c, d):  # 50
    return 1.0 - (a + d) / np.sqrt((a + b) * (a + c) * (b + d) * (c + d))

def _pearson_chi_squared(a, b, c, d):
    n = a + b + c + d
    return n * (a * d - b * c) ** 2 / ((a + b) * (a + c) * (c + d) * (b + d))

def _pearson_phi(a, b, c, d):
    return (a * d - b * c) / np.sqrt((a + b) * (a + c) * (b + d) * (c + d))

@_metric
def S_pearson_I(a, b, c, d):  # 51
    return 1.0 - _pearson_chi_squared(a, b, c, d)

@_metric
def S_pearson_II(a, b, c, d):  # 52
    n = a + b + c + d
    q2 = _pearson_chi_squared(a, b, c, d)
    return 1.0 - (q2 / (n + q2)) ** 0.5

@_metric
def S_pearson_III(a, b, c, d):  # 53
    n = a + b + c + d
    p = _pearson_phi(a, b, c, d)
    return 1.0 - (p / (n + p)) ** 0.5

@_metric
def S_pearson_heron_I(a, b, c, d):  # 54
    return 1.0 - _pearson_phi(a, b, c, d)

@_metric
def S_pearson_heron_II(a, b, c, d):  # 55
    return 1.0 - np.cos(
        np.pi * np.sqrt(b * c) / (np.sqrt(a * d) + np.sqrt(b * c))
    )

@_metric
def S_sokal_sneath_III(a, b, c, d):  # 56
    return 1.0 - (a + d) / (b + c)

@_metric
def S_sokal_sneath_V(a, b, c, d):  # 57
    return 1.0 - (a * d) / ((a + b) * (a + c) * (b + d) * (c + d) ** 0.5)

@_metric
def S_cole(a, b, c, d):  # 58
    num = np.sqrt(2.0) * (a * d - b * c)
    den = np.sqrt((a * d - b * c) ** 2 - (a + b) * (a + c) * (b + d) * (c + d))
    return 1.0 - num / den

@_metric
def S_ochiai_II(a, b, c, d):  # 60
    return 1.0 - (a * d) / np.sqrt((a + b) * (a + c) * (b + d) * (c + d))

@_metric
def S_yuleq(a, b, c, d):  # 61
    return 1.0 - (a * d - b * c) / (a * d + b * c)

@_metric
def D_yuleq(a, b, c, d):  # 62
    return 1.0 - (2.0 * b * c) / (a * d + b * c)

@_metric
def S_yulew(a, b, c, d):  # 63
    return 1.0 - (np.sqrt(a * d) - np.sqrt(b * c)) / (np.sqrt(a * d) + np.sqrt(b * c))

@_metric
def S_kulczynski_I(a, b, c, d):  # 64
    return 1.0 - a / (b + c)

@_metric
def S_tanimoto(a, b, c, d):  # 65
    return 1.0 - a / ((a + b) + (a + c) - a)

@_metric
def S_dispersion(a, b, c, d):  # 66
    return 1.0 - (a * d - b * c) / (a + b + c + d) ** 2

@_metric
def S_hamann(a, b, c, d):  # 67
    return 1.0 - ((a + d) - (b + c)) / (a + b + c + d)

@_metric
def S_michael(a, b, c, d):  # 68
    return 1.0 - 4.0 * (a * d - b * c) / ((a + b) ** 2 + (b + c) ** 2)

def _sigma(a, b, c, d):
    return (np.maximum(a, b) + np.maximum(c, d)
            + np.maximum(a, c) + np.maximum(b, d))

def _sigma_prime(a, b, c, d):
    return np.maximum(a + c, b + d) + np.maximum(a + b, c + d)

@_metric
def S_goodman_kruskal(a, b, c, d):  # 69
    n = a + b + c + d
    sig, sip = _sigma(a, b, c, d), _sigma_prime(a, b, c, d)
    return 1.0 - (sig - sip) / (2.0 * n - sip)

@_metric
def S_anderberg(a, b, c, d):  # 70
    n = a + b + c + d
    sig, sip = _sigma(a, b, c, d), _sigma_prime(a, b, c, d)
    return 1.0 - (sig - sip) / (2.0 * n)

@_metric
def S_baroni_urbani_buser_I(a, b, c, d):  # 71
    s = np.sqrt(a * b)
    return 1.0 - (s + a) / (s + a + b + c)

@_metric
def S_baroni_urbani_buser_II(a, b, c, d):  # 72
    s = np.sqrt(a * b)
    return 1.0 - (s + a - (b + c)) / (s + a + b + c)

@_metric
def S_pierce(a, b, c, d):  # 73
    return 1.0 - (a * b + b * c) / (a * b + 2.0 * b * c + c * d)

@_metric
def S_eyraud(a, b, c, d):  # 74
    n = a + b + c + d
    return 1.0 - (n**2 * (n * a - (a + b) * (a + c))) / (
        (a + b) * (a + c) * (b + d) * (c + d)
    )
