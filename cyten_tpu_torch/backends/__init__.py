"""Symmetry (tensor) backends: block-sparse storage and operations.

The counterpart of ``cyten_tpu/backends/`` for the no-symmetry, abelian and fusion-tree
backends.
"""

from ._backend import TensorBackend, conventional_leg_order, truncation_mask_from_S
from .no_symmetry import NoSymmetryBackend
from .abelian import AbelianBackend
from .fusion_tree import FusionTreeBackend
from .factory import get_backend
from .data import BlockSparseData, DenseData, DiagonalBlockData, MaskBlockData

__all__ = ['TensorBackend', 'NoSymmetryBackend', 'AbelianBackend', 'FusionTreeBackend',
           'get_backend',
           'conventional_leg_order', 'truncation_mask_from_S', 'BlockSparseData',
           'DenseData', 'DiagonalBlockData', 'MaskBlockData']
