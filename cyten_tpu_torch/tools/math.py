"""Math helpers: sparse eigensolver wrappers.

The counterpart of ``cyten_tpu/tools/math.py``, over ``scipy.sparse.linalg``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['speigs', 'speigsh']


def _dense_fallback(A, k, hermitian):
    A = np.asarray(A.todense() if hasattr(A, 'todense') else A)
    if hermitian:
        w, v = np.linalg.eigh(A)
    else:
        w, v = np.linalg.eig(A)
    return w, v


def speigs(A, k: int, which: str = 'LM', *args, **kwargs):
    """scipy.sparse.linalg.eigs wrapper that handles small matrices gracefully
    (falls back to dense diagonalization when k is too close to the dimension)."""
    import scipy.sparse.linalg

    d = A.shape[0]
    if k < d - 1:
        return scipy.sparse.linalg.eigs(A, k=k, which=which, *args, **kwargs)
    w, v = _dense_fallback(A, k, hermitian=False)
    order = np.argsort(-np.abs(w) if which == 'LM' else np.real(w))
    keep = order[:k]
    return w[keep], v[:, keep]


def speigsh(A, k: int, which: str = 'SA', *args, **kwargs):
    """scipy.sparse.linalg.eigsh wrapper with dense fallback (hermitian)."""
    import scipy.sparse.linalg

    d = A.shape[0]
    if k < d - 1:
        return scipy.sparse.linalg.eigsh(A, k=k, which=which, *args, **kwargs)
    w, v = _dense_fallback(A, k, hermitian=True)
    if which in ('SA', 'SM'):
        order = np.argsort(w)
    else:
        order = np.argsort(-w)
    keep = order[:k]
    return w[keep], v[:, keep]
