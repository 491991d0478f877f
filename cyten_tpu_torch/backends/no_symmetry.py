"""Tensor backend for tensors without symmetry: a single dense block.

Role-equivalent to reference ``cyten/backends/no_symmetry.py`` (:22-561). Data is one
dense block in ``legs`` order; every op maps 1:1 onto a block-backend call (one
dense torch operation).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..dtypes import Dtype, is_complex_scalar
from ..symmetries import ElementarySpace, Leg, Symmetry, TensorProduct
from ._backend import TensorBackend
from .data import DenseData

__all__ = ['NoSymmetryBackend']


class NoSymmetryBackend(TensorBackend):
    """Backend without symmetries; data is a single dense block in legs order."""

    DataCls = DenseData
    can_decompose_tensors = True

    def supports_symmetry(self, symmetry: Symmetry) -> bool:
        return symmetry.num_factors == 0 or all(
            type(f).__name__ == 'NoSymmetry' for f in symmetry.factors)

    def test_tensor_sanity(self, a, is_diagonal: bool = False):
        super().test_tensor_sanity(a, is_diagonal=is_diagonal)
        if is_diagonal:
            self.block_backend.test_block_sanity(
                a.data.block, expect_shape=(a.legs[0].dim,), expect_dtype=a.data.dtype)
        else:
            self.block_backend.test_block_sanity(
                a.data.block, expect_shape=a.shape, expect_dtype=a.data.dtype)

    def test_mask_sanity(self, a):
        self.block_backend.test_block_sanity(
            a.data.block, expect_shape=(a.large_leg.dim,), expect_dtype=Dtype.bool)
        assert self.block_backend.sum_mask(a.data.block) == a.small_leg.dim

    # --- creation ----------------------------------------------------------------------

    def zero_data(self, codomain, domain, dtype):
        shape = [sp.dim for sp in codomain.factors] \
            + [sp.dim for sp in reversed(domain.factors)]
        return DenseData(self.block_backend.zeros(shape, dtype), dtype)

    def eye_data(self, codomain, domain, dtype):
        dims = [sp.dim for sp in codomain.factors]
        block = self.block_backend.eye_block(dims, dtype)
        # eye_block pairs axis K+m with codomain m; legs order pairs axis K+k with
        # domain factor K-1-k == codomain factor K-1-k -> reverse the last K axes
        K = len(dims)
        perm = list(range(K)) + list(range(2 * K - 1, K - 1, -1))
        return DenseData(self.block_backend.permute_axes(block, perm), dtype)

    def from_dense_block(self, block, codomain, domain, tol):
        block, dtype = self.block_backend.as_block(block, return_dtype=True)
        return DenseData(block, dtype)

    def to_dense_block(self, a):
        return a.data.block

    def from_sector_block_func(self, func, codomain, domain):
        shape = [sp.dim for sp in codomain.factors] \
            + [sp.dim for sp in reversed(domain.factors)]
        block = func(tuple(shape), codomain.symmetry.trivial_sector)
        return DenseData(block, self.block_backend.get_dtype(block))

    def sector_projection_data(self, co_domain, sector, dtype):
        """Only the trivial sector exists: projector = identity (or zero)."""
        if np.all(sector == co_domain.symmetry.trivial_sector):
            return self.eye_data(co_domain, co_domain, dtype)
        return self.zero_data(co_domain, co_domain, dtype)

    def copy_data(self, a):
        return DenseData(self.block_backend.copy_block(a.data.block), a.data.dtype)

    # --- dtype --------------------------------------------------------------------------

    def get_dtype_from_data(self, a):
        return a.dtype

    def to_dtype(self, a, dtype):
        return DenseData(self.block_backend.to_dtype(a.data.block, dtype), dtype)

    # --- elementary ops -------------------------------------------------------------------

    def compose(self, a, b):
        K_a = a.num_codomain_legs
        n_a = a.num_legs
        K_b = b.num_codomain_legs
        # a's domain axes in factor order are the reversed tail of its legs
        a_axes = list(range(n_a - 1, K_a - 1, -1))
        b_axes = list(range(K_b))
        block = self.block_backend.tensordot(a.data.block, a_axes, b.data.block, b_axes)
        return DenseData(block, Dtype.common(a.data.dtype, b.data.dtype))

    def permute_legs(self, a, codomain_idcs, domain_idcs, levels, new_codomain,
                     new_domain, bend_right=None):
        perm = list(codomain_idcs) + list(domain_idcs)[::-1]
        block = self.block_backend.permute_axes(a.data.block, perm)
        return DenseData(block, a.data.dtype)

    def combine_legs(self, a, leg_idcs_combine, pipes, new_codomain, new_domain):
        K = a.num_codomain_legs
        cstyles = [self.effective_cstyle_in_legs_order(p, g[0] < K)
                   for g, p in zip(leg_idcs_combine, pipes)]
        block = self.block_backend.combine_legs(a.data.block, leg_idcs_combine,
                                                cstyles=cstyles)
        return DenseData(block, a.data.dtype)

    def split_legs(self, a, leg_idcs, codomain_split, domain_split, new_codomain,
                   new_domain):
        K = a.num_codomain_legs
        dims = []
        cstyles = []
        for i in leg_idcs:
            pipe = a.get_leg_co_domain(i)
            in_codomain = i < K
            if in_codomain:
                dims.append([int(l.dim) for l in pipe.legs])
            else:
                dims.append([int(l.dim) for l in reversed(pipe.legs)])
            cstyles.append(self.effective_cstyle_in_legs_order(pipe, in_codomain))
        block = self.block_backend.split_legs(a.data.block, leg_idcs, dims,
                                              cstyles=cstyles)
        return DenseData(block, a.data.dtype)

    def outer(self, a, b, new_codomain, new_domain):
        block = self.block_backend.outer(a.data.block, b.data.block)
        # axes: [a.cod, rev a.dom, b.cod, rev b.dom]
        # want: [a.cod, b.cod, rev b.dom, rev a.dom]
        Ka, Ma = a.num_codomain_legs, a.num_domain_legs
        Kb, Mb = b.num_codomain_legs, b.num_domain_legs
        perm = (list(range(Ka)) + list(range(Ka + Ma, Ka + Ma + Kb))
                + list(range(Ka + Ma + Kb, Ka + Ma + Kb + Mb))
                + list(range(Ka, Ka + Ma)))
        block = self.block_backend.permute_axes(block, perm)
        return DenseData(block, Dtype.common(a.data.dtype, b.data.dtype))

    def inner(self, a, b, do_dagger):
        if do_dagger:
            res = self.block_backend.inner(a.data.block, b.data.block, do_dagger=True)
        else:
            n = a.num_legs
            res = self.block_backend.tensordot(
                a.data.block, list(range(n)), b.data.block, list(range(n - 1, -1, -1)))
        return self.block_backend.block_item(res)

    def partial_trace(self, a, pairs, levels, new_codomain, new_domain):
        idcs1 = [p[0] for p in pairs]
        idcs2 = [p[1] for p in pairs]
        traced = set(idcs1) | set(idcs2)
        remaining = [i for i in range(a.num_legs) if i not in traced]
        block = self.block_backend.trace_partial(a.data.block, idcs1, idcs2, remaining)
        if not remaining:
            return self.block_backend.block_item(block), True
        return DenseData(block, a.data.dtype), False

    def dagger(self, a):
        block = self.block_backend.conj(a.data.block)
        block = self.block_backend.permute_axes(
            block, list(range(a.num_legs - 1, -1, -1)))
        return DenseData(block, a.data.dtype)

    def mul(self, a, b):
        dtype = b.data.dtype
        if is_complex_scalar(a):
            dtype = dtype.to_complex
        return DenseData(self.block_backend.mul(a, self.block_backend.to_dtype(
            b.data.block, dtype)), dtype)

    def linear_combination(self, a, v, b, w):
        dtype = Dtype.common(v.data.dtype, w.data.dtype)
        if is_complex_scalar(a) or is_complex_scalar(b):
            dtype = dtype.to_complex
        block = self.block_backend.linear_combination(
            a, self.block_backend.to_dtype(v.data.block, dtype),
            b, self.block_backend.to_dtype(w.data.block, dtype))
        return DenseData(block, dtype)

    def norm(self, a):
        return self.block_backend.norm(a.data.block)

    def item(self, a):
        return self.block_backend.block_item(a.data.block)

    def trace_full(self, a):
        K = a.num_codomain_legs
        n = a.num_legs
        perm = list(range(K)) + list(range(n - 1, K - 1, -1))
        block = self.block_backend.permute_axes(a.data.block, perm)
        return self.block_backend.block_item(self.block_backend.trace_full(block))

    def add_trivial_leg(self, a, legs_pos, add_to_domain, co_domain_pos, new_codomain,
                        new_domain):
        block = self.block_backend.add_axis(a.data.block, legs_pos)
        return DenseData(block, a.data.dtype)

    def squeeze_legs(self, a, idcs, new_codomain, new_domain):
        return DenseData(self.block_backend.squeeze_axes(a.data.block, idcs),
                         a.data.dtype)

    def get_element(self, a, idcs):
        internal = [int(leg.inverse_basis_perm[i]) if leg.symmetry.can_be_dropped
                    else int(i)
                    for leg, i in zip(a.legs, idcs)]
        return self.block_backend.get_block_element(a.data.block, internal)

    def act_block_diagonal_square_matrix(self, a, block_method, dtype_map):
        K = a.num_codomain_legs
        n = a.num_legs
        shape = self.block_backend.get_shape(a.data.block)
        perm = list(range(K)) + list(range(n - 1, K - 1, -1))
        block = self.block_backend.permute_axes(a.data.block, perm)
        d = int(np.prod(shape[:K]))
        mat = self.block_backend.reshape(block, (d, d))
        mat = block_method(mat)
        block = self.block_backend.reshape(mat, [shape[i] for i in perm])
        block = self.block_backend.permute_axes(block, np.argsort(perm))
        return DenseData(block, self.block_backend.get_dtype(block))

    # --- decompositions ---------------------------------------------------------------------

    def _to_matrix(self, a):
        """Flatten [cod..., rev dom...] block to a (prod cod, prod rev-dom) matrix."""
        bb = self.block_backend
        shape = bb.get_shape(a.data.block)
        K = a.num_codomain_legs
        M = int(np.prod(shape[:K], dtype=np.int64)) if K else 1
        N = int(np.prod(shape[K:], dtype=np.int64)) if len(shape) > K else 1
        return bb.reshape(a.data.block, (M, N)), shape, K

    def svd(self, a, new_leg, algorithm):
        bb = self.block_backend
        mat, shape, K = self._to_matrix(a)
        u, s, vh = bb.matrix_svd(mat, algorithm)
        k = bb.get_shape(u)[1]
        u = bb.reshape(u, shape[:K] + (k,))
        vh = bb.reshape(vh, (k,) + shape[K:])
        dtype = a.data.dtype
        return (DenseData(u, dtype), DenseData(s, dtype.to_real), DenseData(vh, dtype))

    def qr(self, a, new_leg):
        bb = self.block_backend
        mat, shape, K = self._to_matrix(a)
        q, r = bb.matrix_qr(mat)
        k = bb.get_shape(q)[1]
        q = bb.reshape(q, shape[:K] + (k,))
        r = bb.reshape(r, (k,) + shape[K:])
        return DenseData(q, a.data.dtype), DenseData(r, a.data.dtype)

    def lq(self, a, new_leg):
        bb = self.block_backend
        mat, shape, K = self._to_matrix(a)
        l, q = bb.matrix_lq(mat)
        k = bb.get_shape(q)[0]
        l = bb.reshape(l, shape[:K] + (k,))
        q = bb.reshape(q, (k,) + shape[K:])
        return DenseData(l, a.data.dtype), DenseData(q, a.data.dtype)

    def eigh(self, a, new_leg, sort):
        bb = self.block_backend
        K = a.num_codomain_legs
        n = a.num_legs
        shape = bb.get_shape(a.data.block)
        # hermiticity pairs codomain k with domain k -> factor-order flatten
        perm = list(range(K)) + list(range(n - 1, K - 1, -1))
        block = bb.permute_axes(a.data.block, perm)
        D = int(np.prod(shape[:K], dtype=np.int64))
        w, v = bb.matrix_eigh(bb.reshape(block, (D, D)))
        w, v = _sort_eigh(bb, w, v, sort)
        v = bb.reshape(v, shape[:K] + (D,))
        return DenseData(w, a.data.dtype.to_real), DenseData(v, a.data.dtype)

    # --- diagonal tensors ----------------------------------------------------------------------

    def diagonal_from_block(self, block, leg, tol):
        block, dtype = self.block_backend.as_block(block, return_dtype=True)
        return DenseData(block, dtype)

    def diagonal_to_block(self, a):
        return a.data.block

    def diagonal_from_sector_block_func(self, func, leg):
        block = func((leg.dim,), leg.symmetry.trivial_sector)
        return DenseData(block, self.block_backend.get_dtype(block))

    def diagonal_data_from_full_tensor(self, a, check_offdiagonal):
        diag = self.block_backend.get_diagonal(a.data.block,
                                               check_offdiagonal=check_offdiagonal)
        return DenseData(diag, a.data.dtype)

    def full_data_from_diagonal_tensor(self, a):
        block = self.block_backend.block_from_diagonal(a.data.block)
        return DenseData(block, a.data.dtype)

    def diagonal_elementwise_unary(self, a, func, func_kwargs, maps_zero_to_zero):
        block = func(a.data.block, **func_kwargs)
        return DenseData(block, self.block_backend.get_dtype(block))

    def diagonal_elementwise_binary(self, a, b, func, func_kwargs, partial_zero_is_zero):
        block = func(a.data.block, b.data.block, **func_kwargs)
        return DenseData(block, self.block_backend.get_dtype(block))

    def diagonal_all(self, a):
        return self.block_backend.block_all(a.data.block)

    def diagonal_any(self, a):
        return self.block_backend.block_any(a.data.block)

    def diagonal_sum_all(self, a):
        return self.block_backend.block_item(
            self.block_backend.block_sum_all(a.data.block))

    def diagonal_to_mask(self, a):
        block = a.data.block
        small_leg = a.leg.take_slice(self.block_backend.to_numpy(block).astype(bool))
        return DenseData(block, Dtype.bool), small_leg

    def diagonal_transpose(self, a):
        return a.leg.dual, a.data

    def scale_axis(self, a, diag, leg_idx):
        block = self.block_backend.scale_axis(a.data.block, diag.data.block, leg_idx)
        return DenseData(block, Dtype.common(a.data.dtype, diag.data.dtype))

    # --- masks --------------------------------------------------------------------------------

    def mask_from_block(self, block, large_leg):
        block = self.block_backend.as_block(block, Dtype.bool)
        mask_np = self.block_backend.to_numpy(block).astype(bool)
        small_leg = large_leg.take_slice(mask_np) if hasattr(large_leg, 'take_slice') \
            else ElementarySpace.from_trivial_sector(int(mask_np.sum()),
                                                     symmetry=large_leg.symmetry,
                                                     is_dual=large_leg.is_dual)
        return DenseData(block, Dtype.bool), small_leg

    def mask_to_block(self, a):
        return a.data.block

    def mask_to_diagonal(self, a, leg):
        return DenseData(a.data.block, Dtype.bool)

    def mask_dagger(self, a):
        return a.data

    def mask_binary_operand(self, a, b, func):
        block = func(a.data.block, b.data.block)
        mask_np = self.block_backend.to_numpy(block).astype(bool)
        small_leg = a.large_leg.take_slice(mask_np)
        return DenseData(block, Dtype.bool), small_leg

    def mask_unary_operand(self, a, func):
        block = func(a.data.block)
        mask_np = self.block_backend.to_numpy(block).astype(bool)
        small_leg = a.large_leg.take_slice(mask_np)
        return DenseData(block, Dtype.bool), small_leg

    def full_data_from_mask(self, a, dtype):
        block = self.block_backend.block_from_mask(a.data.block, dtype)
        return DenseData(block, dtype)

    def apply_mask_to_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        block = self.block_backend.apply_mask(a.data.block, mask.data.block, leg_idx)
        return DenseData(block, a.data.dtype)

    def apply_mask_to_DiagonalTensor(self, a, mask):
        block = self.block_backend.apply_mask(a.data.block, mask.data.block, 0)
        return DenseData(block, a.data.dtype)

    def enlarge_leg_of_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        mask_np = self.block_backend.to_numpy(mask.data.block).astype(bool)
        shape = list(self.block_backend.get_shape(a.data.block))
        shape[leg_idx] = len(mask_np)
        slices = [slice(None)] * len(shape)
        slices[leg_idx] = np.nonzero(mask_np)[0]
        return DenseData(
            self.block_backend.enlarge_block(a.data.block, shape, tuple(slices)),
            a.data.dtype)


def _sort_eigh(block_backend, w, v, sort: str | None):
    """Sort eigenvalues/-vectors: None/'<' ascending, '>' descending, 'm<'/'m>' by |w|."""
    if sort is None or sort == '<':
        return w, v
    w_np = block_backend.to_numpy(w)
    if sort == '>':
        perm = np.argsort(-w_np, stable=True)
    elif sort == 'm<':
        perm = np.argsort(np.abs(w_np), stable=True)
    elif sort == 'm>':
        perm = np.argsort(-np.abs(w_np), stable=True)
    else:
        raise ValueError(f'invalid sort: {sort!r}')
    w = block_backend.xp.take(w, block_backend.xp.asarray(perm), axis=0)
    v = block_backend.xp.take(v, block_backend.xp.asarray(perm), axis=1)
    return w, v
