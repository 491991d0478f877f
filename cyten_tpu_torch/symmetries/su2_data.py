"""Exact SU(2) recoupling data: Clebsch-Gordan, 6j / Racah W, F symbols, Z isomorphisms.

A copy of ``cyten_tpu/symmetries/su2_data.py`` (numpy and ``fractions`` only).
Role-equivalent to reference ``cyten/symmetries/_su2data.py:28-93``, but computed with
exact integer / Fraction arithmetic instead of sympy (orders of magnitude faster to
evaluate, same values: every coefficient is ``rational * sqrt(rational)``, which we
evaluate exactly and convert to float once).

All arguments are *doubled* spin quantum numbers: ``jj == 2 * j`` and ``mm == 2 * m``,
so that everything is integer.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from math import factorial, sqrt

import numpy as np

__all__ = ['clebsch_gordan', 'six_j', 'racah_w', 'racah_W', 'f_symbol',
           'fusion_tensor', 'Z_iso']

CACHE = 20_000


@lru_cache(maxsize=None)
def _fact(n: int) -> int:
    if n < 0:
        raise ValueError('negative factorial')
    return factorial(n)


def _triangle_ok(jj1: int, jj2: int, jj3: int) -> bool:
    return (abs(jj1 - jj2) <= jj3 <= jj1 + jj2) and (jj1 + jj2 + jj3) % 2 == 0


def _delta_sq(jj1: int, jj2: int, jj3: int) -> Fraction:
    """Squared triangle coefficient Δ²(j1, j2, j3), exact."""
    return Fraction(
        _fact((jj1 + jj2 - jj3) // 2)
        * _fact((jj1 - jj2 + jj3) // 2)
        * _fact((-jj1 + jj2 + jj3) // 2),
        _fact((jj1 + jj2 + jj3) // 2 + 1),
    )


@lru_cache(maxsize=CACHE)
def clebsch_gordan(jj1: int, mm1: int, jj2: int, mm2: int, jj3: int, mm3: int) -> float:
    """Exact Clebsch-Gordan coefficient ⟨j1 m1; j2 m2 | j3 m3⟩ (Condon-Shortley phase)."""
    if mm1 + mm2 != mm3:
        return 0.0
    if not _triangle_ok(jj1, jj2, jj3):
        return 0.0
    if abs(mm1) > jj1 or abs(mm2) > jj2 or abs(mm3) > jj3:
        return 0.0
    if (jj1 + mm1) % 2 or (jj2 + mm2) % 2 or (jj3 + mm3) % 2:
        return 0.0

    # radicand: (2 j3 + 1) Δ² (j3+m3)!(j3-m3)!(j1-m1)!(j1+m1)!(j2-m2)!(j2+m2)!
    rad = (jj3 + 1) * _delta_sq(jj1, jj2, jj3)
    rad *= (_fact((jj3 + mm3) // 2) * _fact((jj3 - mm3) // 2)
            * _fact((jj1 - mm1) // 2) * _fact((jj1 + mm1) // 2)
            * _fact((jj2 - mm2) // 2) * _fact((jj2 + mm2) // 2))

    # alternating sum over k
    k_min = max(0, (jj2 - jj3 - mm1) // 2, (jj1 - jj3 + mm2) // 2)
    k_max = min((jj1 + jj2 - jj3) // 2, (jj1 - mm1) // 2, (jj2 + mm2) // 2)
    total = Fraction(0)
    for k in range(k_min, k_max + 1):
        denom = (_fact(k)
                 * _fact((jj1 + jj2 - jj3) // 2 - k)
                 * _fact((jj1 - mm1) // 2 - k)
                 * _fact((jj2 + mm2) // 2 - k)
                 * _fact((jj3 - jj2 + mm1) // 2 + k)
                 * _fact((jj3 - jj1 - mm2) // 2 + k))
        total += Fraction(-1 if k % 2 else 1, denom)
    if total == 0:
        return 0.0
    return float(total) * sqrt(float(rad))


@lru_cache(maxsize=CACHE)
def six_j(jj1: int, jj2: int, jj3: int, jj4: int, jj5: int, jj6: int) -> float:
    """Exact Wigner 6j symbol {j1 j2 j3; j4 j5 j6} via the Racah sum formula."""
    for tri in ((jj1, jj2, jj3), (jj1, jj5, jj6), (jj4, jj2, jj6), (jj4, jj5, jj3)):
        if not _triangle_ok(*tri):
            return 0.0
    rad = (_delta_sq(jj1, jj2, jj3) * _delta_sq(jj1, jj5, jj6)
           * _delta_sq(jj4, jj2, jj6) * _delta_sq(jj4, jj5, jj3))
    t_min = max(jj1 + jj2 + jj3, jj1 + jj5 + jj6, jj4 + jj2 + jj6, jj4 + jj5 + jj3) // 2
    t_max = min(jj1 + jj2 + jj4 + jj5, jj2 + jj3 + jj5 + jj6, jj3 + jj1 + jj6 + jj4) // 2
    total = Fraction(0)
    for t in range(t_min, t_max + 1):
        denom = (_fact(t - (jj1 + jj2 + jj3) // 2)
                 * _fact(t - (jj1 + jj5 + jj6) // 2)
                 * _fact(t - (jj4 + jj2 + jj6) // 2)
                 * _fact(t - (jj4 + jj5 + jj3) // 2)
                 * _fact((jj1 + jj2 + jj4 + jj5) // 2 - t)
                 * _fact((jj2 + jj3 + jj5 + jj6) // 2 - t)
                 * _fact((jj3 + jj1 + jj6 + jj4) // 2 - t))
        total += Fraction((-1 if t % 2 else 1) * _fact(t + 1), denom)
    if total == 0:
        return 0.0
    return float(total) * sqrt(float(rad))


def racah_w(jj1: int, jj2: int, JJ: int, jj3: int, JJ12: int, JJ23: int) -> float:
    """Racah W coefficient W(j1 j2 J j3; J12 J23) = (-1)^(j1+j2+j3+J) {j1 j2 J12; j3 J J23}."""
    phase = -1 if ((jj1 + jj2 + jj3 + JJ) // 2) % 2 else 1
    return phase * six_j(jj1, jj2, JJ12, jj3, JJ, JJ23)


#: reference-cased alias (reference _su2data.py:94)
racah_W = racah_w


@lru_cache(maxsize=CACHE)
def f_symbol(a: int, b: int, c: int, d: int, e: int, f: int) -> np.ndarray:
    """SU(2) F symbol [F^{abc}_d]^e_f as a (1,1,1,1) array (multiplicity-free).

    Defined as ⟨((j_a j_b) j_f, j_c) j_d | (j_a, (j_b j_c) j_e) j_d⟩, i.e. the Racah W
    coefficient scaled by sqrt(dim_e * dim_f).
    """
    val = sqrt((e + 1) * (f + 1)) * racah_w(a, b, d, c, f, e)
    res = val * np.ones((1, 1, 1, 1))
    res.setflags(write=False)
    return res


@lru_cache(maxsize=CACHE)
def fusion_tensor(a: int, b: int, c: int) -> np.ndarray:
    """Dense CG tensor with axes [μ=1, m_a, m_b, m_c]; basis index k = m + j."""
    X = np.zeros((1, a + 1, b + 1, c + 1), dtype=np.float64)
    for ka in range(a + 1):
        mm_a = 2 * ka - a
        for kb in range(b + 1):
            mm_b = 2 * kb - b
            mm_c = mm_a + mm_b
            kc = (mm_c + c) // 2
            if 0 <= kc <= c:
                X[0, ka, kb, kc] = clebsch_gordan(a, mm_a, b, mm_b, c, mm_c)
    X.setflags(write=False)
    return X


@lru_cache(maxsize=CACHE)
def Z_iso(a: int) -> np.ndarray:
    """Matrix of the Z isomorphism for SU(2): alternating anti-diagonal ±1."""
    d = a + 1
    Z = np.zeros((d, d), dtype=np.float64)
    i = np.arange(d)
    Z[i, d - 1 - i] = 1 - 2 * (i % 2)
    Z.setflags(write=False)
    return Z
