"""Tensors: the user-facing symmetric tensor API.

The counterpart of ``cyten_tpu/tensors/`` for the abelian and no-symmetry backends:
the tensor classes, the free functions, the linear operators of ``sparse`` and the
Krylov solvers (Lanczos, its evolution, Arnoldi).
"""

from ._tensors import (
    ChargedTensor, DiagonalTensor, Identity, LabelledLegs, Mask, SymmetricTensor,
    Tensor, check_same_legs, get_same_device, is_valid_leg_label,
)
from ._functions import *  # noqa: F401,F403
from ._functions import __all__ as _functions_all
from . import krylov_based, sparse
from .sparse import (
    HermitianNumpyArrayLinearOperator, LinearOperator, LinearOperatorWrapper,
    NumpyArrayLinearOperator, ProjectedLinearOperator, ShiftedLinearOperator,
    SumLinearOperator, TensorLinearOperator, gram_schmidt,
)
from .krylov_based import (
    Arnoldi, KrylovBased, LanczosEvolution, LanczosGroundState, lanczos, lanczos_arpack,
)

__all__ = ['LabelledLegs', 'Tensor', 'SymmetricTensor', 'DiagonalTensor', 'Identity',
           'Mask', 'ChargedTensor', 'is_valid_leg_label', 'check_same_legs',
           'get_same_device', *_functions_all,
           'LinearOperator', 'LinearOperatorWrapper',
           'TensorLinearOperator', 'SumLinearOperator',
           'ShiftedLinearOperator', 'ProjectedLinearOperator',
           'NumpyArrayLinearOperator', 'HermitianNumpyArrayLinearOperator',
           'gram_schmidt', 'Arnoldi', 'KrylovBased', 'LanczosGroundState',
           'LanczosEvolution', 'lanczos', 'lanczos_arpack', 'krylov_based', 'sparse']
