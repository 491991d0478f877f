"""Linear operators acting on tensors (matrix-free).

The counterpart of ``cyten_tpu/tensors/sparse.py``'s :class:`LinearOperator` (the base
of the DMRG effective Hamiltonian). The other operators of that module come with a
later slice.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod

from ..dtypes import Dtype
from ._tensors import Tensor

__all__ = ['LinearOperator']


class LinearOperator(metaclass=ABCMeta):
    """A linear map on tensors, defined by its action (matvec)."""

    def __init__(self, vector_shape=None, dtype: Dtype = None):
        self.vector_shape = vector_shape
        self.dtype = dtype

    @abstractmethod
    def matvec(self, vec: Tensor) -> Tensor: ...
