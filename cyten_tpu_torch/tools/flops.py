"""FLOP accounting for block-sparse contractions, from metadata only.

The counterpart of ``cyten_tpu/tools/flops.py``: exact GEMM FLOP counts computed from
block indices and leg multiplicities without touching device data. The port's bench
counts the FLOPs of a DMRG step with it, as ``bench.py:759-775`` does.
"""

from __future__ import annotations

import numpy as np

__all__ = ['tdot_flops', 'compose_flops']


def _block_dims(tensor):
    """Per-leg multiplicity lookup arrays in legs order."""
    return [np.asarray(tensor.get_leg_co_domain(i).multiplicities)
            for i in range(tensor.num_legs)]


def tdot_flops(t1, t2, legs1, legs2) -> int:
    """Exact GEMM FLOPs (2*M*K*N summed over block pairs) of ``tdot(t1, t2, ...)``."""
    from ..backends.data import BlockSparseData, DenseData

    legs1 = t1.get_leg_idcs(legs1)
    legs2 = t2.get_leg_idcs(legs2)
    open1 = [n for n in range(t1.num_legs) if n not in legs1]
    open2 = [n for n in range(t2.num_legs) if n not in legs2]
    if isinstance(t1.data, DenseData):
        M = int(np.prod([t1.shape[i] for i in open1], dtype=np.int64))
        K = int(np.prod([t1.shape[i] for i in legs1], dtype=np.int64))
        N = int(np.prod([t2.shape[i] for i in open2], dtype=np.int64))
        return 2 * M * K * N
    if not isinstance(t1.data, BlockSparseData):
        raise TypeError(f'tdot_flops: no count for {type(t1.data).__name__}')
    dims1 = _block_dims(t1)
    dims2 = _block_dims(t2)
    groups1: dict[tuple, list[int]] = {}
    for n, row in enumerate(t1.data.block_inds):
        groups1.setdefault(tuple(row[legs1]), []).append(n)
    flops = 0
    for n2, row2 in enumerate(t2.data.block_inds):
        key = tuple(row2[legs2])
        for n1 in groups1.get(key, ()):
            row1 = t1.data.block_inds[n1]
            M = int(np.prod([dims1[i][row1[i]] for i in open1], dtype=np.int64)) \
                if open1 else 1
            K = int(np.prod([dims1[i][row1[i]] for i in legs1], dtype=np.int64)) \
                if legs1 else 1
            N = int(np.prod([dims2[i][row2[i]] for i in open2], dtype=np.int64)) \
                if open2 else 1
            flops += 2 * M * K * N
    return flops


def compose_flops(t1, t2) -> int:
    """FLOPs of ``compose(t1, t2)``."""
    n1 = t1.num_legs
    m = t1.num_domain_legs
    legs1 = list(range(n1 - 1, n1 - 1 - m, -1))
    legs2 = list(range(m))
    return tdot_flops(t1, t2, legs1, legs2)
