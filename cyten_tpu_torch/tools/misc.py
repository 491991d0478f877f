"""Integer / sorting utilities used by the block-sparse machinery.

Role-equivalent to the reference's ``cyten/tools/misc.py`` (reference: cyten/tools/misc.py:
172-520). These run host-side (numpy) at trace time: they compute *static* block-structure
metadata, never touching device data. Where the reference uses Python generators we provide
vectorized numpy implementations returning index arrays, which matter because plan
construction happens on the host critical path.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np

__all__ = [
    'duplicate_entries', 'to_iterable', 'as_immutable_array', 'inverse_permutation',
    'is_permutation', 'rank_data', 'make_stride', 'make_grid', 'find_row_differences',
    'common_rows_sorted', 'iter_common_sorted_arrays', 'combine_permutations',
    'find_subclass', 'UNSPECIFIED',
]

_MAX_INT = np.iinfo(np.int64).max

UNSPECIFIED = object()  # sentinel for "argument not given" where None is meaningful


def duplicate_entries(seq: Sequence, ignore: Sequence = ()) -> set:
    """The set of entries that appear more than once in `seq` (excluding `ignore`)."""
    seen = set()
    dup = set()
    for x in seq:
        if x in ignore:
            continue
        if x in seen:
            dup.add(x)
        seen.add(x)
    return dup


def to_iterable(obj):
    """Wrap a non-list/tuple object into a list; pass lists/tuples through."""
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]


def as_immutable_array(a, dtype=None) -> np.ndarray:
    """Convert to a read-only numpy array (safe to cache / share)."""
    res = np.asarray(a, dtype=dtype)
    if res.flags.writeable:
        res = res.copy() if res.base is not None else res
        res.setflags(write=False)
    return res


def is_permutation(perm) -> bool:
    """Whether `perm` is a permutation of ``range(len(perm))``."""
    perm = np.asarray(perm, dtype=np.intp)
    if perm.ndim != 1:
        return False
    seen = np.zeros(perm.shape[0], dtype=bool)
    if np.any(perm < 0) or np.any(perm >= perm.shape[0]):
        return False
    seen[perm] = True
    return bool(np.all(seen))


def inverse_permutation(perm) -> np.ndarray:
    """Invert a permutation: ``inv[perm[j]] == j``. O(N), unlike argsort."""
    perm = np.asarray(perm, dtype=np.intp)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.intp)
    return inv


def rank_data(a, stable: bool = True) -> np.ndarray:
    """Ranks of the entries of 1D data `a`; stable ties break by position."""
    order = np.argsort(a, stable=stable) if stable else np.argsort(a)
    return inverse_permutation(order)


def make_stride(shape, cstyle: bool = True) -> np.ndarray:
    """Strides (in elements) of a C-style (or F-style) contiguous array of given shape.

    ``np.sum(inds * make_stride(maxima, cstyle=False), axis=1)`` preserves the
    ``np.lexsort(inds.T)`` order of non-negative integer rows `inds` — the key trick that
    lets us merge multiple index columns into a single sortable integer.
    """
    shape = np.asarray(shape, dtype=np.intp)
    res = np.empty(len(shape), np.intp)
    if cstyle:
        res[-1] = 1
        if len(shape) > 1:
            res[:-1] = np.cumprod(shape[::-1])[:-1][::-1]
    else:
        res[0] = 1
        if len(shape) > 1:
            res[1:] = np.cumprod(shape[:-1])
    total = res[0] * shape[0] if cstyle else res[-1] * shape[-1]
    assert total < _MAX_INT, 'integer overflow in stride computation'
    return res


def make_grid(shape, cstyle: bool = True) -> np.ndarray:
    """All index combinations into `shape` as rows of a ``(prod(shape), len(shape))`` array.

    C-style varies the last column fastest; F-style the first. The F-style grid is
    ``np.lexsort``-ordered.
    """
    if len(shape) == 0:
        return np.zeros((1, 0), dtype=np.intp)
    if cstyle:
        return np.indices(shape, np.intp).reshape(len(shape), -1).T
    return np.indices(shape, np.intp).T.reshape(-1, len(shape))


def find_row_differences(sectors: np.ndarray, include_len: bool = False) -> np.ndarray:
    """Indices where consecutive rows of a 2D array differ (always includes 0)."""
    n = len(sectors)
    diff = np.ones(n + int(include_len), dtype=bool)
    if n > 1:
        diff[1:n] = np.any(sectors[1:] != sectors[:-1], axis=1)
    return np.nonzero(diff)[0]


def _merge_columns(a: np.ndarray, b: np.ndarray):
    """Merge the columns of two 2D int arrays into single sortable integers (shared strides).

    Entries may be negative (e.g. U(1) charges): columns are shifted to be
    non-negative before the stride merge.
    """
    if a.shape[1] == 0:
        return np.zeros(len(a), np.intp), np.zeros(len(b), np.intp)
    both = np.concatenate([a, b], axis=0)
    lo = np.min(both, axis=0, initial=0)
    ranges = np.max(both, axis=0, initial=0) - lo + 1
    strides = make_stride(ranges, cstyle=False)
    return (a - lo) @ strides, (b - lo) @ strides


def common_rows_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized: pairs ``(i, j)`` with ``a[i] == b[j]`` for lexsorted, duplicate-free rows.

    Returns an ``(n, 2)`` array of index pairs. Vectorized equivalent of the reference's
    generator ``iter_common_sorted_arrays`` (reference: cyten/tools/misc.py:435-468).
    """
    ka, kb = _merge_columns(a, b)
    common, ia, ib = np.intersect1d(ka, kb, assume_unique=True, return_indices=True)
    return np.stack([ia, ib], axis=1)


def iter_common_sorted_arrays(a, b, a_strict: bool = True, b_strict: bool = True):
    """Yield ``(i, j)`` with ``all(a[i] == b[j])`` for lexsorted 2D arrays.

    At most one of the two arrays may contain duplicate rows (its ``*_strict=False``).
    """
    if not (a_strict or b_strict):
        raise ValueError('at least one array must be strictly sorted')
    if a_strict and b_strict:
        for i, j in common_rows_sorted(np.asarray(a), np.asarray(b)):
            yield int(i), int(j)
        return
    la, lb = len(a), len(b)
    d = a.shape[1]
    i = j = 0
    while i < la and j < lb:
        for k in reversed(range(d)):
            if a[i, k] < b[j, k]:
                i += 1
                break
            elif b[j, k] < a[i, k]:
                j += 1
                break
        else:
            yield (i, j)
            if b_strict:
                i += 1
            if a_strict:
                j += 1


def combine_permutations(perms: Sequence[Sequence[int]], cstyle: bool = True) -> np.ndarray:
    """Permutation on a combined (product) axis from permutations of the factors.

    Such that ``a[np.ix_(*perms)].reshape(-1) == a.reshape(-1)[result]``.
    """
    assert all(is_permutation(p) for p in perms)
    strides = make_stride([len(p) for p in perms], cstyle=cstyle)
    grids = np.ix_(*[np.asarray(p, dtype=np.intp) for p in perms])
    total = sum(g * s for g, s in zip(grids, strides))
    return total.reshape(-1, order='C' if cstyle else 'F')


def find_subclass(base_class: type, subclass_name):
    """Find the unique subclass of `base_class` with the given name (for deserialization)."""
    if not isinstance(subclass_name, str):
        if not isinstance(subclass_name, type):
            raise TypeError(f'expected str or class, got {subclass_name!r}')
        if not issubclass(subclass_name, base_class):
            warnings.warn(f'{subclass_name!r} is not a subclass of {base_class!r}')
        return subclass_name
    found = set()
    stack = [base_class]
    seen = set()
    while stack:
        cls = stack.pop()
        if cls in seen:
            continue
        seen.add(cls)
        if cls.__name__ == subclass_name:
            found.add(cls)
        stack.extend(cls.__subclasses__())
    if len(found) == 1:
        return found.pop()
    if not found:
        raise ValueError(f'no subclass of {base_class.__name__} named {subclass_name!r}')
    raise ValueError(f'multiple subclasses of {base_class.__name__} named '
                     f'{subclass_name!r}: {found}')
