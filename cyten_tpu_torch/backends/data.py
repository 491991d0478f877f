"""Backend data containers: dense blocks plus host-side block indices.

The counterpart of ``cyten_tpu/backends/data.py`` without the pytree registration.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Dtype

__all__ = ['DenseData', 'BlockSparseData', 'DiagonalBlockData', 'MaskBlockData']


class DenseData:
    """Data of a tensor without symmetry: a single dense block in ``legs`` order.

    Also used (with a 1D block) for diagonal tensors and (1D bool) masks.
    """

    __slots__ = ['block', 'dtype']

    def __init__(self, block, dtype: Dtype):
        self.block = block
        self.dtype = dtype


    def __repr__(self):
        return f'DenseData(shape={getattr(self.block, "shape", "?")}, dtype={self.dtype})'


class BlockSparseData:
    """Data of an abelian-symmetric tensor: blocks + static block indices.

    ``block_inds[n, m]`` indexes ``leg.sector_decomposition`` where ``leg`` is the m-th
    space in conventional leg order (``[*codomain, *reversed(domain)]``); rows are
    ``np.lexsort(block_inds.T)``-sorted. Blocks have axes in ``legs`` order with shape
    given by the per-leg multiplicities. Missing blocks are implicit zeros.
    (Semantics per reference abelian.py:88-149; blocks are torch tensors.)
    """

    __slots__ = ['blocks', 'block_inds', 'dtype']

    def __init__(self, blocks: list, block_inds: np.ndarray, dtype: Dtype,
                 is_sorted: bool = False):
        block_inds = np.asarray(block_inds, dtype=np.intp)
        if block_inds.ndim != 2:
            block_inds = block_inds.reshape((len(blocks), -1))
        if not is_sorted and len(blocks) > 1:
            perm = np.lexsort(block_inds.T)
            block_inds = block_inds[perm]
            blocks = [blocks[i] for i in perm]
        self.blocks = list(blocks)
        self.block_inds = block_inds
        self.dtype = dtype


    def __repr__(self):
        return (f'BlockSparseData(n_blocks={len(self.blocks)}, dtype={self.dtype})')


class DiagonalBlockData:
    """Abelian diagonal-tensor data: 1D blocks per sector of the leg.

    ``block_inds[n]`` indexes ``leg.sector_decomposition``; ascending.
    """

    __slots__ = ['blocks', 'block_inds', 'dtype']

    def __init__(self, blocks: list, block_inds: np.ndarray, dtype: Dtype,
                 is_sorted: bool = False):
        block_inds = np.asarray(block_inds, dtype=np.intp).reshape(-1)
        if not is_sorted and len(blocks) > 1:
            perm = np.argsort(block_inds)
            block_inds = block_inds[perm]
            blocks = [blocks[i] for i in perm]
        self.blocks = list(blocks)
        self.block_inds = block_inds
        self.dtype = dtype


class MaskBlockData:
    """Abelian mask data: 1D bool blocks.

    ``block_inds[n] = (i_codomain, i_domain)`` indexes the sector decompositions of
    the codomain and domain legs. For a projection that is ``(i_small, i_large)``;
    for an inclusion (created by ``mask_dagger``) the columns are swapped. Block n
    has length ``large_leg.multiplicities[i_large]`` and sum
    ``small_leg.multiplicities[i_small]``. Backend consumers other than
    ``mask_dagger``/``test_mask_sanity`` require projections (``_mask_as_projection``
    converts inclusions first).
    """

    __slots__ = ['blocks', 'block_inds', 'dtype']

    def __init__(self, blocks: list, block_inds: np.ndarray,
                 is_sorted: bool = False):
        block_inds = np.asarray(block_inds, dtype=np.intp).reshape((len(blocks), 2))
        if not is_sorted and len(blocks) > 1:
            perm = np.lexsort(block_inds.T)
            block_inds = block_inds[perm]
            blocks = [blocks[i] for i in perm]
        self.blocks = list(blocks)
        self.block_inds = block_inds
        self.dtype = Dtype.bool
