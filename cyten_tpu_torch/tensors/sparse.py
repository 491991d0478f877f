"""Linear operators acting on tensors (matrix-free).

The counterpart of ``cyten_tpu/tensors/sparse.py``: :class:`LinearOperator` (the base of
the DMRG effective Hamiltonian), the operators given by a tensor, wrapping, summing,
shifting or projecting another, the bridge to ``scipy.sparse.linalg`` over flat numpy
vectors, and :func:`gram_schmidt`.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import Sequence

import numpy as np

from ..dtypes import Dtype, is_complex_scalar
from ._functions import inner, norm, scalar_multiply
from ._tensors import Tensor

__all__ = ['LinearOperator', 'LinearOperatorWrapper', 'TensorLinearOperator',
           'SumLinearOperator', 'ShiftedLinearOperator', 'ProjectedLinearOperator',
           'NumpyArrayLinearOperator', 'HermitianNumpyArrayLinearOperator',
           'gram_schmidt']


class LinearOperator(metaclass=ABCMeta):
    """A linear map on tensors, defined by its action (matvec)."""

    def __init__(self, vector_shape=None, dtype: Dtype = None):
        self.vector_shape = vector_shape
        self.dtype = dtype

    @abstractmethod
    def matvec(self, vec: Tensor) -> Tensor: ...

    def some_vector(self) -> Tensor:
        """A (random) vector in the domain, e.g. to start iterative solvers."""
        raise NotImplementedError

    def adjoint(self) -> LinearOperator:
        raise NotImplementedError(f'adjoint not implemented for {type(self).__name__}')

    def to_tensor(self) -> Tensor:
        raise NotImplementedError

    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumLinearOperator(self, other)
        return NotImplemented


class TensorLinearOperator(LinearOperator):
    """A linear operator given by an explicit square tensor, applied via compose.

    The tensor must have one leg each in domain and codomain (combine first if needed).
    """

    def __init__(self, tensor: Tensor, which_legs=None):
        assert tensor.num_codomain_legs == tensor.num_domain_legs
        self.tensor = tensor
        LinearOperator.__init__(self, dtype=tensor.dtype)

    def matvec(self, vec: Tensor) -> Tensor:
        from ._functions import compose

        return compose(self.tensor, vec)

    def some_vector(self) -> Tensor:
        from ._tensors import SymmetricTensor

        dtype = self.dtype if self.dtype is not None and not self.dtype.is_bool \
            else None
        kw = {} if dtype is None else {'dtype': dtype}
        return SymmetricTensor.from_random_normal(
            self.tensor.domain, backend=self.tensor.backend, **kw)

    def adjoint(self) -> TensorLinearOperator:
        from ._functions import dagger

        return TensorLinearOperator(dagger(self.tensor))

    def to_tensor(self) -> Tensor:
        return self.tensor


class LinearOperatorWrapper(LinearOperator):
    """Base class for operators wrapping another :class:`LinearOperator`.

    Attributes not set on the wrapper fall through to ``original_operator``, so
    wrapping a subclass that defines extra attributes keeps them visible. When
    stacking wrappers, order can matter: :class:`ProjectedLinearOperator` must be
    outermost to stay correct.
    """

    def __init__(self, original_operator: LinearOperator):
        self.original_operator = original_operator

    def __getattr__(self, name):
        # only reached when normal attribute lookup fails
        if name == 'original_operator':  # guard against recursion half-built
            raise AttributeError(name)
        return getattr(self.original_operator, name)

    def unwrapped(self) -> LinearOperator:
        """Undo all layers of wrapping, return the innermost operator."""
        op = self.original_operator
        while isinstance(op, LinearOperatorWrapper):
            op = op.original_operator
        return op


class SumLinearOperator(LinearOperatorWrapper):
    """Sum of several linear operators."""

    def __init__(self, *operators: LinearOperator):
        assert len(operators) > 0
        self.operators = operators
        LinearOperatorWrapper.__init__(self, operators[0])

    def matvec(self, vec: Tensor) -> Tensor:
        res = self.operators[0].matvec(vec)
        for op in self.operators[1:]:
            res = res + op.matvec(vec)
        return res

    def some_vector(self) -> Tensor:
        return self.operators[0].some_vector()


class ShiftedLinearOperator(LinearOperatorWrapper):
    """``H + shift * identity``, e.g. to move eigenvalues away from zero."""

    def __init__(self, operator: LinearOperator, shift):
        LinearOperatorWrapper.__init__(self, operator)
        self.operator = operator
        self.shift = shift
        dtype = operator.dtype
        if dtype is not None and is_complex_scalar(shift):
            self.dtype = dtype.to_complex  # else: delegate to the wrapped op

    def matvec(self, vec: Tensor) -> Tensor:
        return self.operator.matvec(vec) + scalar_multiply(self.shift, vec)

    def some_vector(self) -> Tensor:
        return self.operator.some_vector()


class ProjectedLinearOperator(LinearOperator):
    """``P H P`` with ``P = 1 - sum_o |o><o|``: orthogonalize against given vectors.

    With ``penalty``, adds ``penalty * sum_o |o><o|`` to ``H`` instead of projecting.
    Each ``inner`` with an ``o`` reads one scalar on the host.
    """

    def __init__(self, operator: LinearOperator, ortho_vecs: Sequence[Tensor],
                 penalty=None):
        LinearOperatorWrapper.__init__(self, operator)
        self.operator = operator
        self.ortho_vecs = gram_schmidt(list(ortho_vecs))
        self.penalty = penalty

    def project(self, vec: Tensor) -> Tensor:
        for o in self.ortho_vecs:
            vec = vec - scalar_multiply(inner(o, vec), o)
        return vec

    def matvec(self, vec: Tensor) -> Tensor:
        if self.penalty is None:
            res = self.operator.matvec(self.project(vec))
            return self.project(res)
        res = self.operator.matvec(vec)
        for o in self.ortho_vecs:
            res = res + scalar_multiply(self.penalty * inner(o, vec), o)
        return res

    def some_vector(self) -> Tensor:
        return self.project(self.operator.some_vector())


class NumpyArrayLinearOperator(LinearOperator):
    """Bridge tensors-as-vectors to ``scipy.sparse.linalg``.

    Flattens tensors to 1D numpy arrays (public basis, copied to the host) so that
    scipy's iterative solvers can be used; a flat vector goes back onto the tensor's
    device and symmetric subspace through ``from_dense_block``.
    """

    def __init__(self, operator: LinearOperator, example_vec: Tensor):
        self.operator = operator
        self.example_vec = example_vec
        self._shape_template = example_vec
        LinearOperator.__init__(self, dtype=operator.dtype or example_vec.dtype)

    def tensor_to_flat(self, vec: Tensor) -> np.ndarray:
        flat = vec.to_numpy().reshape(-1)
        if not flat.flags.writeable:
            # scipy's iterative solvers (gmres et al.) write into matvec outputs
            flat = flat.copy()
        return flat

    def flat_to_tensor(self, flat: np.ndarray) -> Tensor:
        from ._tensors import SymmetricTensor

        t = self.example_vec
        block = flat.reshape(t.shape)
        return SymmetricTensor.from_dense_block(block, t.codomain, t.domain,
                                                t.backend, t.labels, tol=None)

    def as_scipy_operator(self, complement_shift: float = None):
        """The operator on the FLAT (dense) vector space.

        The flat space embeds the symmetric subspace: flat_to_tensor projects, so the
        scipy operator is ``H . P`` and the non-symmetric complement is a spurious null
        space. Krylov methods started inside the subspace stay there in exact
        arithmetic, but roundoff can surface the spurious zeros after many iterations.
        Pass ``complement_shift`` (a value far above the spectrum of interest) to map
        the complement to that eigenvalue instead: ``A x = H P x + shift (x - P x)``;
        the physical spectrum is unchanged.
        """
        import scipy.sparse.linalg

        t = self.example_vec
        dim = int(np.prod(t.shape))

        def mv(flat):
            vec = self.flat_to_tensor(flat)
            out = self.tensor_to_flat(self.operator.matvec(vec))
            if complement_shift is not None:
                out = out + complement_shift * (flat - self.tensor_to_flat(vec))
            return out

        dtype = np.complex128 if (self.dtype is not None and self.dtype.is_complex) \
            else np.float64
        return scipy.sparse.linalg.LinearOperator((dim, dim), matvec=mv, dtype=dtype)

    def matvec(self, vec: Tensor) -> Tensor:
        return self.operator.matvec(vec)

    def some_vector(self) -> Tensor:
        return self.example_vec

    def eigenvectors(self, num_ev: int = 1, which: str = 'SA', v0: Tensor = None,
                     hermitian: bool = False, **kwargs):
        """Extremal eigenpairs via ``scipy.sparse.linalg.eigsh``/``eigs``.

        Returns ``(vals, vecs)`` with ``vecs`` a list of tensors.
        """
        import scipy.sparse.linalg as ssl

        op = self.as_scipy_operator()
        if v0 is not None:
            kwargs['v0'] = self.tensor_to_flat(v0)
        if hermitian:
            vals, vecs = ssl.eigsh(op, k=num_ev, which=which, **kwargs)
        else:
            which_map = {'SA': 'SR', 'LA': 'LR'}
            vals, vecs = ssl.eigs(op, k=num_ev, which=which_map.get(which, which),
                                  **kwargs)
        return vals, [self.flat_to_tensor(np.ascontiguousarray(vecs[:, i]))
                      for i in range(vecs.shape[1])]


class HermitianNumpyArrayLinearOperator(NumpyArrayLinearOperator):
    """Hermitian variant of :class:`NumpyArrayLinearOperator`.

    Hermiticity of ``matvec`` is not checked.
    """

    def _adjoint(self):
        return self

    def eigenvectors(self, *args, **kwargs):
        kwargs['hermitian'] = True
        return NumpyArrayLinearOperator.eigenvectors(self, *args, **kwargs)


def gram_schmidt(vecs: list[Tensor], rcond: float = 1e-14) -> list[Tensor]:
    """Orthonormalize a list of tensors (dropping near-null vectors)."""
    res = []
    for v in vecs:
        for o in res:
            v = v - scalar_multiply(inner(o, v), o)
        n = norm(v)
        if n > rcond:
            res.append(scalar_multiply(1. / n, v))
    return res
