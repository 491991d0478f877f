"""Dense block operations: the contract between the symmetric-tensor machinery and
the dense arrays.

The counterpart of ``cyten_tpu/blocks/backend.py``: the :class:`BlockBackend`
contract, written generically over a numpy-like namespace ``self.xp``. The one
implementation in this package is :class:`~.torch_backend.TorchBlockBackend`;
``combine_legs``/``split_legs`` support C- and F-style flattening by
transpose-then-reshape (F-style flattening of an axis group equals C-style
flattening of the reversed group). Random blocks are drawn host-side with a numpy
Generator and copied to the device once; they serve initialisation and tests.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, TypeVar

import numpy as np

from ..dtypes import Dtype

__all__ = ['Block', 'BlockBackend', 'default_device', 'get_block_backend']

Block = TypeVar('Block')  # torch.Tensor


class BlockBackend:
    """Dense-array contract. Instances are stateless except for an RNG for test data."""

    svd_algorithms: list[str] = ['default']
    name = 'abstract'

    def __init__(self, xp):
        self.xp = xp
        self._rng = np.random.default_rng()

    def __repr__(self):
        return f'{type(self).__name__}()'

    def __reduce__(self):
        # backends hold module references (self.xp); restore via the factory
        return (get_block_backend, (self.name,))

    def test_block_sanity(self, block, expect_shape=None, expect_dtype=None):
        assert self.is_block(block), 'not a block'
        if expect_shape is not None:
            assert tuple(block.shape) == tuple(expect_shape), \
                f'wrong shape: {block.shape} != {expect_shape}'
        if expect_dtype is not None:
            assert self.get_dtype(block) == expect_dtype

    # --- dtype mapping -----------------------------------------------------------

    def to_internal_dtype(self, dtype: Dtype):
        return dtype.to_numpy

    def get_dtype(self, block) -> Dtype:
        return Dtype.from_numpy(block.dtype)

    def to_dtype(self, block, dtype: Dtype):
        if self.get_dtype(block).is_complex and not dtype.is_complex:
            # take the real part explicitly: a complex->real cast warns
            block = block.real
        return block.astype(self.to_internal_dtype(dtype))

    # --- creation / conversion ----------------------------------------------------

    def is_block(self, obj) -> bool:
        raise NotImplementedError

    def as_block(self, obj, dtype: Dtype = None, return_dtype: bool = False):
        block = self.xp.asarray(obj)
        if block.dtype in (np.int32, np.int64) or str(block.dtype).startswith('int'):
            block = block.astype(self.to_internal_dtype(Dtype.float64)
                                 if dtype is None else self.to_internal_dtype(dtype))
        elif dtype is not None:
            block = block.astype(self.to_internal_dtype(dtype))
        if return_dtype:
            return block, self.get_dtype(block)
        return block

    def copy_block(self, block):
        return self.xp.array(block, copy=True)

    def to_numpy(self, block, numpy_dtype=None) -> np.ndarray:
        res = np.asarray(block)
        if numpy_dtype is not None:
            res = res.astype(numpy_dtype)
        return res

    def zeros(self, shape, dtype: Dtype = Dtype.float64):
        return self.xp.zeros(tuple(shape), self.to_internal_dtype(dtype))

    def ones(self, shape, dtype: Dtype = Dtype.float64):
        return self.xp.ones(tuple(shape), self.to_internal_dtype(dtype))

    def eye_matrix(self, dim: int, dtype: Dtype = Dtype.float64):
        return self.xp.eye(dim, dtype=self.to_internal_dtype(dtype))

    def eye_block(self, legs: Sequence[int], dtype: Dtype = Dtype.float64):
        """Identity map from legs [J, J', ...] to itself; axes [J, J', ..., J*, J'*, ...]."""
        d = math.prod(legs)
        eye = self.xp.eye(d, dtype=self.to_internal_dtype(dtype))
        return self.xp.reshape(eye, tuple(legs) + tuple(legs))

    def block_random_uniform(self, shape, dtype: Dtype, rng: np.random.Generator = None):
        rng = rng if rng is not None else self._rng
        res = rng.uniform(-1, 1, size=tuple(shape))
        if dtype.is_complex:
            res = res + 1j * rng.uniform(-1, 1, size=tuple(shape))
        return self.as_block(res, dtype)

    def block_random_normal(self, shape, dtype: Dtype, sigma: float = 1.,
                            rng: np.random.Generator = None):
        rng = rng if rng is not None else self._rng
        res = rng.normal(scale=sigma, size=tuple(shape))
        if dtype.is_complex:
            res = res + 1j * rng.normal(scale=sigma, size=tuple(shape))
        return self.as_block(res, dtype)

    # --- shape / structure ----------------------------------------------------------

    def get_shape(self, block) -> tuple[int, ...]:
        return tuple(block.shape)

    def reshape(self, block, shape):
        return self.xp.reshape(block, tuple(shape))

    def permute_axes(self, block, permutation: Sequence[int]):
        return self.xp.transpose(block, tuple(permutation))

    def moveaxis(self, block, source, destination):
        return self.xp.moveaxis(block, source, destination)

    def add_axis(self, block, pos: int):
        return self.xp.expand_dims(block, pos)

    def squeeze_axes(self, block, idcs: Sequence[int]):
        if len(idcs) == 0:
            return block
        return self.xp.squeeze(block, tuple(idcs))

    def combine_legs(self, block, leg_idcs_combine: Sequence[Sequence[int]],
                     cstyles: Sequence[bool] = None):
        """Flatten each contiguous group of axes into one axis, C- or F-style per group.

        F-style flattening == C-style flattening of the reversed axes, implemented via a
        single transpose + reshape (cf. reference _block_backend.py:183-213; redesigned
        without ``order='F'``).
        """
        old_shape = block.shape
        if cstyles is None:
            cstyles = [True] * len(leg_idcs_combine)
        perm = []
        new_shape = []
        last = 0
        for group, cstyle in zip(leg_idcs_combine, cstyles):
            first_g = group[0]
            perm.extend(range(last, first_g))
            new_shape.extend(old_shape[last:first_g])
            perm.extend(group if cstyle else group[::-1])
            new_shape.append(math.prod(old_shape[i] for i in group))
            last = group[-1] + 1
        perm.extend(range(last, len(old_shape)))
        new_shape.extend(old_shape[last:])
        if perm != list(range(len(old_shape))):
            block = self.xp.transpose(block, tuple(perm))
        return self.xp.reshape(block, tuple(new_shape))

    def split_legs(self, block, idcs: Sequence[int], dims: Sequence[Sequence[int]],
                   cstyles: Sequence[bool] = None):
        """Inverse of :meth:`combine_legs`: expand each axis ``idcs[i]`` into ``dims[i]``."""
        if cstyles is None:
            cstyles = [True] * len(idcs)
        new_shape = []
        # per new axis position, whether it is part of a reversed (F-style) group
        groups = []  # (start, stop) ranges in new_shape to reverse afterwards
        last = 0
        for i, dim_group, cstyle in zip(idcs, dims, cstyles):
            new_shape.extend(block.shape[last:i])
            start = len(new_shape)
            new_shape.extend(dim_group if cstyle else list(dim_group)[::-1])
            if not cstyle and len(dim_group) > 1:
                groups.append((start, len(new_shape)))
            last = i + 1
        new_shape.extend(block.shape[last:])
        block = self.xp.reshape(block, tuple(new_shape))
        if groups:
            perm = list(range(len(new_shape)))
            for start, stop in groups:
                perm[start:stop] = perm[start:stop][::-1]
            block = self.xp.transpose(block, tuple(perm))
        return block

    def permute_combined(self, block, axis: int, dims: Sequence[int],
                         perm: Sequence[int], cstyle: bool = True):
        """Permute the constituent factors inside a combined (flattened) axis.

        ``axis`` was combined from factors of sizes ``dims`` (in the given style); the
        result is as if the factors had been permuted by ``perm`` before combining (the
        factor at old position perm[i] moves to position i).
        Capability-equivalent to reference ``permute_combined_matrix``
        (_block_backend.py:426-506), generalized to any single axis.
        """
        n_before = axis
        shape = block.shape
        factor_dims = list(dims) if cstyle else list(dims)[::-1]
        new_shape = shape[:axis] + tuple(factor_dims) + shape[axis + 1:]
        block = self.xp.reshape(block, new_shape)
        if cstyle:
            inner = [n_before + p for p in perm]
        else:
            k = len(dims)
            inner = [n_before + (k - 1 - p) for p in reversed(perm)]
        axes = (tuple(range(n_before)) + tuple(inner)
                + tuple(range(n_before + len(dims), len(new_shape))))
        block = self.xp.transpose(block, axes)
        return self.xp.reshape(block, shape[:axis] + (math.prod(dims),) + shape[axis + 1:])

    def enlarge_block(self, block, new_shape, slices: Sequence[slice]):
        """Embed `block` into a zero block of `new_shape` at position `slices`."""
        res = self.xp.zeros(tuple(new_shape), block.dtype)
        return self._setitem(res, tuple(slices), block)

    def _setitem(self, block, idx, value):
        block = np.asarray(block).copy()
        block[idx] = np.asarray(value)
        return self.xp.asarray(block)

    # --- scatter-accumulate (in place) ------------------------------------------------

    def accumulator(self, shape, dtype: Dtype):
        """A zero block that :meth:`accum_add` may mutate in place."""
        return np.zeros(tuple(shape), dtype.to_numpy)

    def accum_add(self, acc, idx, value):
        """``acc[idx] += value`` on an accumulator from :meth:`accumulator`."""
        acc[idx] += np.asarray(value)
        return acc

    def finalize_accumulator(self, acc):
        return self.xp.asarray(acc)

    def get_block_element(self, block, idx):
        res = block[tuple(idx)]
        return self.block_item(res)

    def block_item(self, block):
        arr = np.asarray(block)
        assert arr.size == 1, 'not a scalar block'
        return arr.reshape(()).item()

    def stack(self, blocks, axis: int = 0):
        return self.xp.stack(blocks, axis=axis)

    def concatenate(self, blocks, axis: int = 0):
        return self.xp.concatenate(blocks, axis=axis)

    # --- elementwise ----------------------------------------------------------------

    def conj(self, block):
        return self.xp.conj(block)

    def real(self, block):
        return self.xp.real(block)

    def imag(self, block):
        return self.xp.imag(block)

    def angle(self, block):
        return self.xp.angle(block)

    def abs(self, block):
        return self.xp.abs(block)

    def sqrt(self, block):
        return self.xp.sqrt(block)

    def exp(self, block):
        return self.xp.exp(block)

    def log(self, block):
        return self.xp.log(block)

    def stable_log(self, block, cutoff: float):
        return self.xp.where(block > cutoff, self.xp.log(
            self.xp.where(block > cutoff, block, 1.)), 0.)

    def cutoff_inverse(self, block, cutoff: float):
        safe = self.xp.where(self.xp.abs(block) > cutoff, block, 1.)
        return self.xp.where(self.xp.abs(block) > cutoff, 1. / safe, 0.)

    def real_if_close(self, block, tol: float):
        if self.get_dtype(block).is_complex:
            eps = self.get_dtype(block).eps
            if self.to_numpy(self.max_abs(self.xp.imag(block))) <= tol * eps:
                return self.xp.real(block)
        return block

    def apply_elementwise(self, func: Callable, *blocks, **func_kwargs):
        return func(*blocks, **func_kwargs)

    @staticmethod
    def _sticky_scalar(a):
        """The scalar ``a`` as it multiplies a block: numpy scalars (and 0-d arrays)
        become Python numbers.

        bf16 storage is sticky under scalar broadcasting (``cyten_tpu``'s rule,
        ``blocks/backend.py::_sticky_scalar``): a real scalar that is not bf16 (a
        Python float, a numpy scalar or a 0-d tensor, e.g. the f32 norm that
        reductions return) broadcast onto a bf16 block gives bf16; a complex scalar,
        and a block of a wider dtype, promote as usual. PyTorch already treats
        Python numbers and 0-d tensors as weak scalars, which give exactly that.
        Numpy scalars need the conversion: ``np.complex64 * tensor`` drops the
        imaginary part, and a 0-d ``np.ndarray`` does not multiply a tensor at all.
        """
        return a.item() if isinstance(a, (np.generic, np.ndarray)) else a

    def mul(self, a, block):
        return self._sticky_scalar(a) * block

    def add(self, block1, block2):
        return block1 + block2

    def linear_combination(self, a, block1, b, block2):
        return self._sticky_scalar(a) * block1 + self._sticky_scalar(b) * block2

    # --- boolean / comparison ---------------------------------------------------------

    def allclose(self, a, b, rtol: float = 1e-5, atol: float = 1e-8) -> bool:
        return bool(np.allclose(self.to_numpy(a), self.to_numpy(b), rtol=rtol, atol=atol))

    def block_all(self, block) -> bool:
        return bool(self.xp.all(block))

    def block_any(self, block) -> bool:
        return bool(self.xp.any(block))

    def sum_mask(self, mask) -> int:
        return int(self.xp.sum(mask))

    def apply_mask(self, block, mask, ax: int):
        """Index `block` along axis `ax` with a boolean mask (host-side shape change)."""
        mask_np = self.to_numpy(mask).astype(bool)
        idx = np.nonzero(mask_np)[0]
        return self.xp.take(block, self.xp.asarray(idx), axis=ax)

    # --- reductions -------------------------------------------------------------------

    def norm(self, block, order=2) -> float:
        block, _ = self._linalg_upcast(block)  # accumulate reductions in f32
        flat = self.xp.reshape(block, (-1,))
        if order == 2:
            return float(self.xp.sqrt(self.xp.sum(self.xp.abs(flat) ** 2)))
        if order == np.inf:
            return float(self.xp.max(self.xp.abs(flat))) if flat.shape[0] else 0.
        return float(self.xp.sum(self.xp.abs(flat) ** order) ** (1. / order))

    def norm_sq(self, block):
        """Squared Frobenius norm as a backend scalar (a 0-d tensor on the device):
        per-tensor norms sum these and pay one host sync for the result, not one per
        block."""
        block, _ = self._linalg_upcast(block)  # accumulate reductions in f32
        flat = self.xp.reshape(block, (-1,))
        return self.xp.sum(self.xp.abs(flat) ** 2)

    def max_abs(self, block):
        return self.xp.max(self.xp.abs(block))

    def block_max(self, block):
        return self.xp.max(block)

    def block_min(self, block):
        return self.xp.min(block)

    def block_sum_all(self, block):
        return self.xp.sum(block)

    def block_sum(self, block, ax: int):
        return self.xp.sum(block, axis=ax)

    def argmax(self, block) -> tuple[int, ...]:
        flat_idx = int(np.argmax(self.to_numpy(self.abs(block))))
        return tuple(int(i) for i in np.unravel_index(flat_idx, block.shape))

    # --- diagonal / trace -----------------------------------------------------------

    def get_diagonal(self, block, check_offdiagonal: bool = False):
        d = min(block.shape)
        diag = self.xp.diagonal(self.xp.reshape(block, (block.shape[0], -1))) \
            if block.ndim == 2 else self.xp.diagonal(block)
        if check_offdiagonal:
            full = self.block_from_diagonal(diag, shape=block.shape)
            if not self.allclose(block, full, rtol=1e-10, atol=1e-12):
                raise ValueError('Block is not diagonal')
        return diag

    def block_from_diagonal(self, diag, shape=None):
        d = diag.shape[0]
        res = self.xp.zeros((d, d) if shape is None else tuple(shape), diag.dtype)
        return self._set_diagonal(res, diag)

    def _set_diagonal(self, block, diag):
        res = np.asarray(block).copy()
        np.fill_diagonal(res, np.asarray(diag))
        return self.xp.asarray(res)

    def block_from_mask(self, mask, dtype: Dtype):
        """Rectangular projection matrix [sum(mask), len(mask)] from a bool mask."""
        mask_np = self.to_numpy(mask).astype(bool)
        res = np.zeros((int(np.sum(mask_np)), len(mask_np)), dtype.to_numpy)
        res[np.arange(int(np.sum(mask_np))), np.nonzero(mask_np)[0]] = 1.
        return self.as_block(res, dtype)

    def trace_full(self, block):
        """Full trace pairing axis i with axis ndim/2 + i."""
        n = block.ndim // 2
        d = math.prod(block.shape[:n])
        mat = self.xp.reshape(block, (d, d))
        return self.xp.trace(mat)

    def trace_partial(self, block, idcs1: Sequence[int], idcs2: Sequence[int],
                      remaining: Sequence[int]):
        block = self.xp.transpose(block, tuple(remaining) + tuple(idcs1) + tuple(idcs2))
        nrem = len(remaining)
        drem = block.shape[:nrem]
        d = math.prod(block.shape[nrem:nrem + len(idcs1)])
        block = self.xp.reshape(block, drem + (d, d))
        return self.xp.trace(block, axis1=-2, axis2=-1)

    # --- linear algebra --------------------------------------------------------------

    # bfloat16 policy: bf16 is a storage dtype. Products accumulate in f32;
    # reductions and factorizations run in f32. Outputs are cast back to bf16, so
    # the result dtype is the promoted input dtype at every call site.

    def _linalg_upcast(self, a):
        """(a_f32, was_bf16): factorizations/reductions do not support bfloat16."""
        if self.get_dtype(a) is Dtype.bfloat16:
            return self.to_dtype(a, Dtype.float32), True
        return a, False

    def matrix_dot(self, a, b):
        return self.xp.matmul(a, b)

    def tensordot(self, a, a_axes, b, b_axes):
        return self.xp.tensordot(a, b, (tuple(a_axes), tuple(b_axes)))

    def outer(self, a, b):
        return self.xp.tensordot(a, b, 0)

    def inner(self, a, b, do_dagger: bool):
        """Frobenius inner product of same-shape blocks (f32 accumulation for bf16)."""
        a, _ = self._linalg_upcast(a)
        b, _ = self._linalg_upcast(b)
        if do_dagger:
            return self.xp.sum(self.xp.conj(a) * b)
        return self.xp.sum(a * b)

    def scale_axis(self, block, factors, ax: int):
        shape = [1] * block.ndim
        shape[ax] = -1
        return block * self.xp.reshape(factors, tuple(shape))

    def matrix_svd(self, a, algorithm: str = None):
        """SVD of a matrix: U, S (1D real), Vh."""
        a, half = self._linalg_upcast(a)
        u, s, vh = self.xp.linalg.svd(a, full_matrices=False)
        if half:
            bf = self.to_internal_dtype(Dtype.bfloat16)
            return u.astype(bf), s.astype(bf), vh.astype(bf)
        return u, s, vh

    def matrix_qr(self, a, full: bool = False):
        a, half = self._linalg_upcast(a)
        q, r = self.xp.linalg.qr(a, mode='complete' if full else 'reduced')
        if half:
            bf = self.to_internal_dtype(Dtype.bfloat16)
            return q.astype(bf), r.astype(bf)
        return q, r

    def matrix_lq(self, a, full: bool = False):
        q, r = self.matrix_qr(self.xp.transpose(a), full=full)
        return self.xp.transpose(r), self.xp.transpose(q)

    def matrix_eigh(self, a, sort: str = None):
        a, half = self._linalg_upcast(a)
        w, v = self.xp.linalg.eigh(a)
        if half:
            bf = self.to_internal_dtype(Dtype.bfloat16)
            return w.astype(bf), v.astype(bf)
        return w, v  # ascending by default

    def matrix_eig(self, a):
        # intentional exception to the bf16 round-trip policy: general eig of a
        # real matrix has complex eigenpairs and there is no complex-bf16, so
        # results stay in the upcast (f32-grade complex) dtype
        a, _ = self._linalg_upcast(a)
        w, v = np.linalg.eig(self.to_numpy(a))
        return self.xp.asarray(w), self.xp.asarray(v)

    def matrix_exp(self, a):
        raise NotImplementedError

    def matrix_log(self, a):
        import scipy.linalg

        res = scipy.linalg.logm(self.to_numpy(a))
        return self.xp.asarray(res)

    # --- device handling ----------------------------------------------------------

    def as_device(self, block, device: str = None):
        if device is not None and device.split(':')[0] != 'cpu':
            raise ValueError(
                f'Unsupported device for {type(self).__name__}: {device!r}')
        return block

    def get_device(self, block) -> str:
        return 'cpu'

    def synchronize(self):
        pass


_BACKENDS: dict[tuple[str, str], BlockBackend] = {}


def default_device() -> str:
    """The device entry points use when the caller names none: the CUDA card.

    Raises when CUDA is absent: the port never carries on quietly on the CPU.
    Pass ``device='cpu'`` to run there.
    """
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return 'cuda'


def get_block_backend(name: str = None, device: str = None) -> BlockBackend:
    """Get (and cache) a block backend by name and device.

    Only ``'torch'`` exists. ``device`` defaults to ``'cuda'`` (see
    :func:`default_device`); without CUDA, ``'cuda'`` raises whether named or not.
    """
    if name is None:
        from ..config import config

        name = config.default_block_backend
    if name != 'torch':
        raise ValueError(f'unknown block backend: {name!r} (cyten_tpu_torch has only '
                         "'torch')")
    if device is None or str(device).startswith('cuda'):
        device = device or default_device()  # a card named but absent raises alike
        default_device()
    key = (name, str(device))
    res = _BACKENDS.get(key)
    if res is None:
        from .torch_backend import TorchBlockBackend

        res = _BACKENDS[key] = TorchBlockBackend(device=device)
    return res
