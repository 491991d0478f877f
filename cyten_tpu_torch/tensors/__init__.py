"""Tensors: the user-facing symmetric tensor API.

The counterpart of ``cyten_tpu/tensors/`` for the abelian and no-symmetry backends:
the tensor classes, the free functions, the linear operators of ``sparse`` and the
host-driven Lanczos solver.
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
from .krylov_based import KrylovBased, LanczosGroundState, lanczos

__all__ = ['LabelledLegs', 'Tensor', 'SymmetricTensor', 'DiagonalTensor', 'Identity',
           'Mask', 'ChargedTensor', 'is_valid_leg_label', 'check_same_legs',
           'get_same_device', *_functions_all,
           'LinearOperator', 'LinearOperatorWrapper',
           'TensorLinearOperator', 'SumLinearOperator',
           'ShiftedLinearOperator', 'ProjectedLinearOperator',
           'NumpyArrayLinearOperator', 'HermitianNumpyArrayLinearOperator',
           'gram_schmidt', 'KrylovBased',
           'LanczosGroundState', 'lanczos', 'krylov_based', 'sparse']
