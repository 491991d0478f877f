"""Symmetry (tensor) backends: block-sparse storage and operations.

The counterpart of ``cyten_tpu/backends/`` for the no-symmetry and abelian backends.
"""

from ._backend import TensorBackend, conventional_leg_order, truncation_mask_from_S
from .no_symmetry import NoSymmetryBackend
from .abelian import AbelianBackend
from .factory import get_backend
from .data import BlockSparseData, DenseData, DiagonalBlockData, MaskBlockData

__all__ = ['TensorBackend', 'NoSymmetryBackend', 'AbelianBackend', 'get_backend',
           'conventional_leg_order', 'truncation_mask_from_S', 'BlockSparseData',
           'DenseData', 'DiagonalBlockData', 'MaskBlockData']
