"""Tensor backend for abelian symmetries: charge-indexed block-sparse storage.

Role-equivalent to reference ``cyten/backends/abelian.py`` (AbelianBackendData :88-149,
_compose_worker :467-661, combine_legs :367-458, split_legs :1831, per-sector
decompositions :1928-2011). The counterpart of ``cyten_tpu/backends/abelian.py``. Storage semantics
(block_inds conventions, lexsort order, implicit-zero missing blocks, charge-0 rule)
follow the reference exactly (SURVEY.md Appendix A.3/A.4/A.6):

- All index bookkeeping is host-side numpy, derived from the legs only.
- The block-pair products of ``tdot`` and ``compose`` go to the device as ONE
  grouped-GEMM launch per call (:func:`~cyten_tpu_torch.blocks.grouped_gemm.grouped_matmul`),
  which also sums the pairs that feed one output block. The pair plans depend only
  on the block structure and are memoized.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np

from ..blocks.grouped_gemm import grouped_matmul
from ..dtypes import Dtype, is_complex_scalar
from ..symmetries import (
    AbelianLegPipe, ElementarySpace, Leg, LegPipe, Symmetry, TensorProduct,
)
from ..tools.misc import find_row_differences, make_grid, make_stride
from ._backend import TensorBackend, conventional_leg_order
from .data import BlockSparseData, DiagonalBlockData, MaskBlockData
from .no_symmetry import _sort_eigh

__all__ = ['AbelianBackend']


@functools.lru_cache(maxsize=2048)
def _valid_block_inds(codomain: TensorProduct, domain: TensorProduct) -> np.ndarray:
    """All lexsorted block-index rows with total charge zero.

    Row m indexes the sector decompositions of the conventional-leg-order spaces.
    """
    symmetry = codomain.symmetry
    spaces = list(conventional_leg_order(codomain, domain))
    if len(spaces) == 0:
        return np.zeros((1, 0), dtype=np.intp)
    grid = make_grid([s.num_sectors for s in spaces], cstyle=False)
    if grid.shape[0] == 0:
        return np.zeros((0, len(spaces)), dtype=np.intp)
    K = codomain.num_factors
    codomain_coupled = symmetry.multiple_fusion_broadcast(
        *(sp.sector_decomposition[g] for sp, g in zip(codomain.factors, grid.T[:K]))) \
        if K > 0 else np.tile(symmetry.trivial_sector, (grid.shape[0], 1))
    domain_coupled = symmetry.multiple_fusion_broadcast(
        *(sp.sector_decomposition[g]
          for sp, g in zip(domain.factors, grid.T[K:][::-1]))) \
        if domain.num_factors > 0 else np.tile(symmetry.trivial_sector,
                                               (grid.shape[0], 1))
    valid = np.all(codomain_coupled == domain_coupled, axis=1)
    block_inds = grid[valid]
    perm = np.lexsort(block_inds.T)
    return block_inds[perm]


def _row_lookup(block_inds: np.ndarray) -> dict[tuple, int]:
    return {tuple(row): n for n, row in enumerate(block_inds)}


@functools.lru_cache(maxsize=4096)
def _cached_compose_plan(a_bytes, a_shape, a_contr_cols, a_keep_cols,
                         b_bytes, b_shape, b_contr_cols, b_keep_cols):
    """Memoized GEMM-pair plan: merged int keys -> ``(ia, ib, out_id, n_out, ua, pa,
    ub, pb)``: per pair the a- and b-block index and the output id, then the distinct
    a-blocks read and the position of each pair's a-block among them (and so for b).

    Pure python here (:func:`cyten_tpu_torch._native.compose_plan`); the C++ plan
    builder comes with a later slice.
    """
    from .._native import compose_plan

    a_bi = np.frombuffer(a_bytes, dtype=np.intp).reshape(a_shape)
    b_bi = np.frombuffer(b_bytes, dtype=np.intp).reshape(b_shape)

    def strides_for(maxima):
        strides = np.ones(len(maxima), np.int64)
        for k in range(len(maxima) - 2, -1, -1):
            strides[k] = strides[k + 1] * maxima[k + 1]
        return strides

    def merged(sub, strides):
        if sub.shape[1] == 0:
            return np.zeros(len(sub), np.int64)
        return sub @ strides

    a_sub_c = a_bi[:, list(a_contr_cols)].astype(np.int64)
    b_sub_c = b_bi[:, list(b_contr_cols)].astype(np.int64)
    # contracted keys are matched across tensors -> shared strides
    if a_sub_c.shape[1]:
        maxima_c = np.maximum(np.max(a_sub_c, axis=0, initial=0),
                              np.max(b_sub_c, axis=0, initial=0)) + 1
        s_c = strides_for(maxima_c)
    else:
        s_c = np.ones(0, np.int64)
    a_sub_k = a_bi[:, list(a_keep_cols)].astype(np.int64)
    b_sub_k = b_bi[:, list(b_keep_cols)].astype(np.int64)
    s_ka = strides_for(np.max(a_sub_k, axis=0, initial=0) + 1) \
        if a_sub_k.shape[1] else np.ones(0, np.int64)
    s_kb = strides_for(np.max(b_sub_k, axis=0, initial=0) + 1) \
        if b_sub_k.shape[1] else np.ones(0, np.int64)
    ia, ib, out_id, n_out = compose_plan(merged(a_sub_c, s_c), merged(a_sub_k, s_ka),
                                         merged(b_sub_c, s_c), merged(b_sub_k, s_kb))
    return (ia, ib, out_id, n_out, *np.unique(ia, return_inverse=True),
            *np.unique(ib, return_inverse=True))


class AbelianBackend(TensorBackend):
    """Backend for abelian symmetries with symmetric trivial braiding."""

    DataCls = BlockSparseData
    can_decompose_tensors = False

    def supports_symmetry(self, symmetry: Symmetry) -> bool:
        return symmetry.is_abelian and symmetry.has_trivial_braid

    def make_pipe(self, legs, is_dual: bool, pipe=None):
        if pipe is not None:
            assert isinstance(pipe, AbelianLegPipe)
            assert pipe.combine_cstyle == (not is_dual)
            assert pipe.is_dual == is_dual
            assert list(pipe.legs) == list(legs)
            return pipe
        return AbelianLegPipe(legs, is_dual=is_dual, combine_cstyle=not is_dual)

    def test_tensor_sanity(self, a, is_diagonal: bool = False):
        data = a.data
        if is_diagonal:
            assert isinstance(data, DiagonalBlockData)
            leg = a.leg
            assert np.all(np.diff(data.block_inds) > 0)
            for block, i in zip(data.blocks, data.block_inds):
                self.block_backend.test_block_sanity(
                    block, expect_shape=(leg.multiplicities[i],))
            return
        assert isinstance(data, BlockSparseData)
        spaces = list(conventional_leg_order(a.codomain, a.domain))
        assert data.block_inds.shape == (len(data.blocks), len(spaces))
        if len(data.block_inds) > 1:
            perm = np.lexsort(data.block_inds.T)
            assert np.all(perm == np.arange(len(perm))), 'block_inds not sorted'
        assert len(np.unique(data.block_inds, axis=0)) == len(data.block_inds)
        valid = _valid_block_inds(a.codomain, a.domain)
        valid_set = set(map(tuple, valid))
        for block, row in zip(data.blocks, data.block_inds):
            assert tuple(row) in valid_set, 'block violates charge rule'
            self.block_backend.test_block_sanity(
                block,
                expect_shape=tuple(int(sp.multiplicities[i])
                                   for sp, i in zip(spaces, row)))

    def test_mask_sanity(self, a):
        data = a.data
        assert isinstance(data, MaskBlockData)
        for block, row in zip(data.blocks, data.block_inds):
            # rows are (i_codomain, i_domain): (small, large) for projections,
            # (large, small) for inclusions (created by dagger)
            i_small, i_large = row if a.is_projection else row[::-1]
            assert np.all(a.small_leg.sector_decomposition[i_small]
                          == a.large_leg.sector_decomposition[i_large])
            n_kept = self.block_backend.sum_mask(block)
            assert n_kept == a.small_leg.multiplicities[i_small]

    # --- creation ------------------------------------------------------------------------

    def zero_data(self, codomain, domain, dtype):
        n_legs = codomain.num_factors + domain.num_factors
        return BlockSparseData([], np.zeros((0, n_legs), np.intp), dtype,
                               is_sorted=True)

    def from_grid(self, grid, new_codomain, new_domain, row_pos: int,
                  col_pos: int, row_slices: dict, col_slices: dict, dtype):
        """Blockwise direct-sum assembly of a 2D grid of tensors.

        Scatters each operand block into the enlarged block addressed by the
        same sector combination, at the multiplicity offsets of its grid
        row/column — no dense detour (reference abelian.py:969-1014, adapted to
        arbitrary stacking positions ``row_pos``/``col_pos`` in legs order).

        ``row_slices[sector_tuple]`` are the cumulative multiplicity offsets of
        the grid rows within that sector of the new row leg (len ``rows + 1``);
        ``col_slices`` likewise for columns.
        """
        bb = self.block_backend
        legs_order = list(new_codomain.factors) + \
            list(reversed(new_domain.factors))
        new_row_leg = legs_order[row_pos]
        new_col_leg = legs_order[col_pos]
        # accumulate with the block backend on the device (no host round trip
        # per block)
        accumulators: dict[tuple, object] = {}
        for i, row in enumerate(grid):
            for j, op in enumerate(row):
                if op is None:
                    continue
                op_legs = list(op.codomain.factors) + \
                    list(reversed(op.domain.factors))
                for bi, block in zip(op.data.block_inds, op.data.blocks):
                    row_sec = tuple(int(x) for x in
                                    op_legs[row_pos].sector_decomposition[bi[row_pos]])
                    col_sec = tuple(int(x) for x in
                                    op_legs[col_pos].sector_decomposition[bi[col_pos]])
                    new_bi = list(int(x) for x in bi)
                    new_bi[row_pos] = new_row_leg.sector_decomposition_where(
                        np.asarray(row_sec))
                    new_bi[col_pos] = new_col_leg.sector_decomposition_where(
                        np.asarray(col_sec))
                    key = tuple(new_bi)
                    acc = accumulators.get(key)
                    if acc is None:
                        shape = [int(leg.multiplicities[n])
                                 for leg, n in zip(legs_order, new_bi)]
                        acc = bb.accumulator(shape, dtype)
                    sl = [slice(None)] * len(legs_order)
                    ro = row_slices[row_sec]
                    co = col_slices[col_sec]
                    sl[row_pos] = slice(int(ro[i]), int(ro[i + 1]))
                    sl[col_pos] = slice(int(co[j]), int(co[j + 1]))
                    accumulators[key] = bb.accum_add(
                        acc, tuple(sl), bb.to_dtype(block, dtype))
        keys = list(accumulators)
        block_inds = np.array(keys, dtype=np.intp).reshape(len(keys),
                                                           len(legs_order))
        blocks = [bb.finalize_accumulator(accumulators[k]) for k in keys]
        return BlockSparseData(blocks, block_inds, dtype, is_sorted=False)

    def eye_data(self, codomain, domain, dtype):
        K = codomain.num_factors
        grid = make_grid([s.num_sectors for s in codomain.factors], cstyle=False)
        blocks = []
        block_inds = np.empty((grid.shape[0], 2 * K), dtype=np.intp)
        block_inds[:, :K] = grid
        block_inds[:, K:] = grid[:, ::-1]
        for row in grid:
            mults = [int(sp.multiplicities[i])
                     for sp, i in zip(codomain.factors, row)]
            block = self.block_backend.eye_block(mults, dtype)
            # eye_block axes [cod..., cod...]; legs order needs last K axes reversed
            perm = list(range(K)) + list(range(2 * K - 1, K - 1, -1))
            blocks.append(self.block_backend.permute_axes(block, perm))
        return BlockSparseData(blocks, block_inds, dtype)

    def sector_projection_data(self, co_domain, sector, dtype):
        """Projector onto the given coupled sector: the identity blocks whose fused
        codomain charge equals `sector`. Reference: _tensors.py:1270."""
        eye = self.eye_data(co_domain, co_domain, dtype)
        K = co_domain.num_factors
        sym = co_domain.symmetry
        keep = []
        for n, row in enumerate(eye.block_inds):
            coupled = sym.multiple_fusion(
                *(sp.sector_decomposition[i]
                  for sp, i in zip(co_domain.factors, row[:K])))
            if np.all(coupled == sector):
                keep.append(n)
        return BlockSparseData([eye.blocks[n] for n in keep],
                               eye.block_inds[keep] if keep
                               else np.zeros((0, 2 * K), np.intp),
                               dtype, is_sorted=True)

    def from_dense_block(self, block, codomain, domain, tol):
        block, dtype = self.block_backend.as_block(block, return_dtype=True)
        spaces = list(conventional_leg_order(codomain, domain))
        # public -> internal basis order per axis
        for ax, sp in enumerate(spaces):
            if sp._basis_perm is not None:
                block = self.block_backend.xp.take(
                    block, self.block_backend.xp.asarray(sp.basis_perm), axis=ax)
        block_inds = _valid_block_inds(codomain, domain)
        blocks = []
        total_sq = self.block_backend.norm_sq(block)
        kept_sq = 0.
        for row in block_inds:
            slices = tuple(slice(int(sp.slices[i, 0]), int(sp.slices[i, 1]))
                           for sp, i in zip(spaces, row))
            b = block[slices]
            blocks.append(b)
            kept_sq = kept_sq + self.block_backend.norm_sq(b)
        # device scalars until here; the comparison below is the single sync.
        if tol is not None:
            total_sq = float(total_sq)
            kept_sq = float(kept_sq)
            if total_sq > 0:
                # allowance for float accumulation noise (dtype-aware)
                eps = dtype.eps if not dtype.is_bool else 1e-15
                if (total_sq - kept_sq) > (tol ** 2 + 64 * eps) * total_sq:
                    raise ValueError('Block is not symmetric up to tolerance.')
        return BlockSparseData(blocks, block_inds, dtype, is_sorted=True)

    def to_dense_block(self, a):
        spaces = list(conventional_leg_order(a.codomain, a.domain))
        shape = tuple(int(sp.dim) for sp in spaces)
        res = self.block_backend.accumulator(shape, a.data.dtype)
        for block, row in zip(a.data.blocks, a.data.block_inds):
            slices = tuple(slice(int(sp.slices[i, 0]), int(sp.slices[i, 1]))
                           for sp, i in zip(spaces, row))
            res = self.block_backend.accum_add(res, slices, block)  # disjoint slices
        for ax, sp in enumerate(spaces):
            if sp._basis_perm is not None:
                res = self.block_backend.xp.take(
                    res, self.block_backend.xp.asarray(sp.inverse_basis_perm), axis=ax)
        return res

    def from_sector_block_func(self, func, codomain, domain):
        block_inds = _valid_block_inds(codomain, domain)
        spaces = list(conventional_leg_order(codomain, domain))
        K = codomain.num_factors
        sym = codomain.symmetry
        blocks = []
        for row in block_inds:
            shape = tuple(int(sp.multiplicities[i]) for sp, i in zip(spaces, row))
            if K > 0:
                coupled = sym.multiple_fusion(
                    *(sp.sector_decomposition[i]
                      for sp, i in zip(codomain.factors, row[:K])))
            else:
                coupled = sym.trivial_sector
            blocks.append(func(shape, coupled))
        if len(blocks) == 0:
            return BlockSparseData([], block_inds, Dtype.float64, is_sorted=True)
        dtype = self.block_backend.get_dtype(blocks[0])
        return BlockSparseData(blocks, block_inds, dtype, is_sorted=True)

    def copy_data(self, a):
        return BlockSparseData([self.block_backend.copy_block(b)
                                for b in a.data.blocks],
                               a.data.block_inds.copy(), a.data.dtype, is_sorted=True)

    # --- dtype -----------------------------------------------------------------------------

    def get_dtype_from_data(self, a):
        return a.dtype

    def to_dtype(self, a, dtype):
        cls = type(a.data)
        if cls is DiagonalBlockData:
            return DiagonalBlockData(
                [self.block_backend.to_dtype(b, dtype) for b in a.data.blocks],
                a.data.block_inds, dtype, is_sorted=True)
        return BlockSparseData(
            [self.block_backend.to_dtype(b, dtype) for b in a.data.blocks],
            a.data.block_inds, dtype, is_sorted=True)

    # --- elementary ops ----------------------------------------------------------------------

    def compose(self, a, b):
        """Contract ``a.domain`` with ``b.codomain``: :meth:`tdot_data` over those
        legs, so one grouped-GEMM launch."""
        Ka = a.num_codomain_legs
        Ma = a.num_legs - Ka
        # a's domain factor k sits at legs position Ka + (Ma - 1 - k) and meets
        # b's codomain factor k
        return self.tdot_data(a, b, [Ka + Ma - 1 - k for k in range(Ma)],
                              list(range(b.num_codomain_legs)))

    def tdot_operands(self, a, b, legs1, legs2):
        """The grouped-GEMM operands of :meth:`tdot_data`.

        Each operand block is permuted to ``[kept, contracted]`` (resp.
        ``[contracted, kept]``) and made a matrix, once per block: a copy unless the
        permutation is trivial. Returns ``(As, Bs, pairs, out_id, n_out, out_rows,
        out_shapes)``: the matrices of the blocks that some pair reads, each once, the
        pair list ``pairs = (a_index, b_index)`` into them (the ``pairs`` of
        :func:`~cyten_tpu_torch.blocks.grouped_gemm.grouped_matmul`) and, per output
        block, its block-index row and its shape in ``[open legs of a ..., open legs of
        b ...]`` order.
        """
        a_bi = a.data.block_inds
        b_bi = b.data.block_inds
        a_keep = [n for n in range(a.num_legs) if n not in legs1]
        b_keep = [n for n in range(b.num_legs) if n not in legs2]
        ia, ib, out_id, n_out, ua, pa, ub, pb = _cached_compose_plan(
            a_bi.tobytes(), a_bi.shape, tuple(legs1), tuple(a_keep),
            b_bi.tobytes(), b_bi.shape, tuple(legs2), tuple(b_keep))
        bb = self.block_backend

        def as_matrix(block, rows, cols):
            shape = bb.get_shape(block)
            M = int(np.prod([shape[i] for i in rows], dtype=np.int64))
            K = int(np.prod([shape[i] for i in cols], dtype=np.int64))
            return bb.reshape(bb.permute_axes(block, list(rows) + list(cols)), (M, K))

        a_mats = [as_matrix(a.data.blocks[n], a_keep, legs1) for n in ua.tolist()]
        b_mats = [as_matrix(b.data.blocks[n], legs2, b_keep) for n in ub.tolist()]
        out_rows: list = [None] * n_out
        out_shapes: list = [None] * n_out
        for n1, n2, oid in zip(ia.tolist(), ib.tolist(), out_id.tolist()):
            if out_rows[oid] is None:
                out_rows[oid] = tuple(a_bi[n1][a_keep]) + tuple(b_bi[n2][b_keep])
                sa = bb.get_shape(a.data.blocks[n1])
                sb = bb.get_shape(b.data.blocks[n2])
                out_shapes[oid] = tuple(sa[i] for i in a_keep) + tuple(sb[i] for i in b_keep)
        return a_mats, b_mats, (pa, pb), out_id, n_out, out_rows, out_shapes

    def tdot_data(self, a, b, legs1, legs2):
        """Block-pair contraction over arbitrary legs, as one grouped GEMM.

        ``tdot(a, b, legs1, legs2)`` data with output legs order
        ``[open legs of a ..., open legs of b ...]``: one grouped-GEMM launch runs
        every matching pair of :meth:`tdot_operands` and sums the pairs that feed
        one output block.
        """
        dtype = Dtype.common(a.data.dtype, b.data.dtype)
        As, Bs, pairs, out_id, n_out, out_rows, out_shapes = self.tdot_operands(
            a, b, legs1, legs2)
        bb = self.block_backend
        blocks = []
        for mat, shape in zip(grouped_matmul(As, Bs, out_id, n_out, pairs), out_shapes):
            blk = bb.reshape(mat, shape)
            blocks.append(blk if bb.get_dtype(blk) == dtype else bb.to_dtype(blk, dtype))
        block_inds = np.array(out_rows, dtype=np.intp).reshape(
            n_out, a.num_legs - len(legs1) + b.num_legs - len(legs2))
        return BlockSparseData(blocks, block_inds, dtype)

    def permute_legs(self, a, codomain_idcs, domain_idcs, levels, new_codomain,
                     new_domain, bend_right=None):
        # trivial braid: pure transpose + column permutation (cf. abelian.py:1699-1714)
        perm = list(codomain_idcs) + list(domain_idcs)[::-1]
        blocks = [self.block_backend.permute_axes(b, perm) for b in a.data.blocks]
        block_inds = a.data.block_inds[:, perm]
        return BlockSparseData(blocks, block_inds, a.data.dtype)

    def combine_legs(self, a, leg_idcs_combine, pipes, new_codomain, new_domain):
        bb = self.block_backend
        K = a.num_codomain_legs
        n = a.num_legs
        # per group: lookup (constituent idcs tuple in legs order) -> (J, start, stop)
        group_maps = []
        for group, pipe in zip(leg_idcs_combine, pipes):
            assert isinstance(pipe, AbelianLegPipe)
            in_codomain = group[0] < K
            lookup = {}
            for b_start, b_end, *idcs, J in pipe.block_ind_map:
                key = tuple(idcs) if in_codomain else tuple(idcs[::-1])
                lookup[key] = (int(J), int(b_start), int(b_end))
            group_maps.append(lookup)

        # new column layout
        old2new = {}
        new_col = 0
        combined_cols = {g[0]: gi for gi, g in enumerate(leg_idcs_combine)}
        in_group = {i for g in leg_idcs_combine for i in g}
        col_of_group = {}
        for i in range(n):
            if i in combined_cols:
                col_of_group[combined_cols[i]] = new_col
                new_col += 1
            elif i in in_group:
                continue
            else:
                old2new[i] = new_col
                new_col += 1
        n_new = new_col
        new_spaces = list(conventional_leg_order(new_codomain, new_domain))

        out_blocks: dict[tuple, object] = {}
        for block, row in zip(a.data.blocks, a.data.block_inds):
            new_row = [0] * n_new
            placements = []  # (new_col, start, stop)
            for gi, (group, lookup) in enumerate(zip(leg_idcs_combine, group_maps)):
                J, start, stop = lookup[tuple(row[group])]
                c = col_of_group[gi]
                new_row[c] = J
                placements.append((c, start, stop))
            for i, c in old2new.items():
                new_row[c] = int(row[i])
            new_row = tuple(new_row)
            cstyles = [self.effective_cstyle_in_legs_order(p, g[0] < K)
                       for g, p in zip(leg_idcs_combine, pipes)]
            flat = bb.combine_legs(block, leg_idcs_combine, cstyles=cstyles)
            target = out_blocks.get(new_row)
            if target is None:
                shape = tuple(int(sp.multiplicities[j])
                              for sp, j in zip(new_spaces, new_row))
                target = bb.accumulator(shape, a.data.dtype)
            slices = [slice(None)] * n_new
            for c, start, stop in placements:
                slices[c] = slice(start, stop)
            # the placements of one target never overlap: add == set
            out_blocks[new_row] = bb.accum_add(target, tuple(slices), flat)
        rows = list(out_blocks.keys())
        blocks = [out_blocks[r] for r in rows]
        block_inds = np.array(rows, dtype=np.intp).reshape((len(rows), n_new))
        return BlockSparseData(blocks, block_inds, a.data.dtype)

    def split_legs(self, a, leg_idcs, codomain_split, domain_split, new_codomain,
                   new_domain):
        bb = self.block_backend
        K = a.num_codomain_legs
        n = a.num_legs
        pipes = [a.get_leg_co_domain(i) for i in leg_idcs]
        # rows of block_ind_map per J, per pipe
        pipe_rows = []
        for i, pipe in zip(leg_idcs, pipes):
            assert isinstance(pipe, AbelianLegPipe)
            per_J = {}
            s = pipe.block_ind_map_slices
            for J in range(pipe.num_sectors):
                rows = pipe.block_ind_map[s[J]:s[J + 1]]
                per_J[J] = rows
            pipe_rows.append((i, pipe, per_J, i < K))

        out_blocks = []
        out_rows = []
        for block, row in zip(a.data.blocks, a.data.block_inds):
            # cartesian product over the split legs' block_ind_map rows
            candidates = [(tuple(), [slice(None)] * n, {})]  # (extra, slices, col_map)
            for (i, pipe, per_J, in_codomain) in pipe_rows:
                J = int(row[i])
                new_cands = []
                for b_start, b_end, *idcs, _J in per_J[J]:
                    mults = [int(l.multiplicities[k])
                             for l, k in zip(pipe.legs, idcs)]
                    if in_codomain:
                        cols = list(idcs)
                        dims = mults
                    else:
                        # pipe legs are in domain order; legs order is reversed
                        cols = list(idcs[::-1])
                        dims = mults[::-1]
                    for extra, slices, col_map in candidates:
                        s2 = list(slices)
                        s2[i] = slice(int(b_start), int(b_end))
                        cm = dict(col_map)
                        cm[i] = (cols, dims)
                        new_cands.append((extra, s2, cm))
                candidates = new_cands
            for extra, slices, col_map in candidates:
                sub = block[tuple(slices)]
                split_dims = [col_map[i][1] for i in leg_idcs]
                cstyles = [self.effective_cstyle_in_legs_order(p, i < K)
                           for (i, p, _, _2) in pipe_rows]
                sub = bb.split_legs(sub, leg_idcs, split_dims, cstyles=cstyles)
                new_row = []
                for i in range(n):
                    if i in col_map:
                        new_row.extend(col_map[i][0])
                    else:
                        new_row.append(int(row[i]))
                out_blocks.append(sub)
                out_rows.append(tuple(new_row))
        n_new = new_codomain.num_factors + new_domain.num_factors
        block_inds = np.array(out_rows, dtype=np.intp).reshape((len(out_rows), n_new))
        return BlockSparseData(out_blocks, block_inds, a.data.dtype)

    def outer(self, a, b, new_codomain, new_domain):
        bb = self.block_backend
        Ka, Ma = a.num_codomain_legs, a.num_domain_legs
        Kb, Mb = b.num_codomain_legs, b.num_domain_legs
        perm = (list(range(Ka)) + list(range(Ka + Ma, Ka + Ma + Kb))
                + list(range(Ka + Ma + Kb, Ka + Ma + Kb + Mb))
                + list(range(Ka, Ka + Ma)))
        blocks = []
        rows = []
        for block1, row1 in zip(a.data.blocks, a.data.block_inds):
            for block2, row2 in zip(b.data.blocks, b.data.block_inds):
                block = bb.outer(block1, block2)
                blocks.append(bb.permute_axes(block, perm))
                rows.append(np.concatenate([row1, row2])[perm])
        n_new = a.num_legs + b.num_legs
        block_inds = (np.array(rows, dtype=np.intp).reshape((len(rows), n_new))
                      if rows else np.zeros((0, n_new), np.intp))
        return BlockSparseData(blocks, block_inds,
                               Dtype.common(a.data.dtype, b.data.dtype))

    def inner(self, a, b, do_dagger):
        bb = self.block_backend
        res = None
        if do_dagger:
            lookup = _row_lookup(b.data.block_inds)
            for block, row in zip(a.data.blocks, a.data.block_inds):
                n2 = lookup.get(tuple(row))
                if n2 is None:
                    continue
                term = bb.inner(block, b.data.blocks[n2], do_dagger=True)
                res = term if res is None else bb.add(res, term)
        else:
            n = a.num_legs
            axes_b = list(range(n - 1, -1, -1))
            lookup = _row_lookup(b.data.block_inds[:, ::-1])
            for block, row in zip(a.data.blocks, a.data.block_inds):
                n2 = lookup.get(tuple(row))
                if n2 is None:
                    continue
                term = bb.tensordot(block, list(range(n)), b.data.blocks[n2], axes_b)
                res = term if res is None else bb.add(res, term)
        if res is None:
            return Dtype.common(a.data.dtype, b.data.dtype).zero_scalar
        return bb.block_item(res)

    def partial_trace(self, a, pairs, levels, new_codomain, new_domain):
        bb = self.block_backend
        n = a.num_legs
        spaces = list(conventional_leg_order(a.codomain, a.domain))
        idcs1 = [p[0] for p in pairs]
        idcs2 = [p[1] for p in pairs]
        # traceable pairs are the same space or mutual duals, which share the
        # defining-sector order -> pairing is direct index equality
        traced = set(idcs1) | set(idcs2)
        remaining = [i for i in range(n) if i not in traced]
        out: dict[tuple, object] = {}
        for block, row in zip(a.data.blocks, a.data.block_inds):
            if not all(row[i] == row[j] for i, j in zip(idcs1, idcs2)):
                continue
            tr = bb.trace_partial(block, idcs1, idcs2, remaining)
            key = tuple(int(row[i]) for i in remaining)
            out[key] = tr if key not in out else bb.add(out[key], tr)
        if not remaining:
            if not out:
                return a.data.dtype.zero_scalar, True
            return bb.block_item(next(iter(out.values()))), True
        rows = list(out.keys())
        blocks = [out[r] for r in rows]
        block_inds = (np.array(rows, dtype=np.intp).reshape((len(rows), len(remaining)))
                      if rows else np.zeros((0, len(remaining)), np.intp))
        return BlockSparseData(blocks, block_inds, a.data.dtype), False

    def dagger(self, a):
        bb = self.block_backend
        n = a.num_legs
        perm = list(range(n - 1, -1, -1))
        blocks = [bb.permute_axes(bb.conj(b), perm) for b in a.data.blocks]
        block_inds = a.data.block_inds[:, ::-1]
        return BlockSparseData(blocks, block_inds, a.data.dtype)

    def mul(self, a, b):
        dtype = b.data.dtype
        if is_complex_scalar(a):
            dtype = dtype.to_complex
        bb = self.block_backend
        blocks = [bb.mul(a, bb.to_dtype(blk, dtype)) for blk in b.data.blocks]
        if isinstance(b.data, DiagonalBlockData):
            return DiagonalBlockData(blocks, b.data.block_inds, dtype, is_sorted=True)
        return BlockSparseData(blocks, b.data.block_inds, dtype, is_sorted=True)

    def linear_combination(self, a, v, b, w):
        dtype = Dtype.common(v.data.dtype, w.data.dtype)
        if is_complex_scalar(a) or is_complex_scalar(b):
            dtype = dtype.to_complex
        bb = self.block_backend
        is_diag = isinstance(v.data, DiagonalBlockData)
        if is_diag:
            v_bi = v.data.block_inds[:, None]
            w_bi = w.data.block_inds[:, None]
        else:
            v_bi = v.data.block_inds
            w_bi = w.data.block_inds
        v_lookup = {tuple(r): i for i, r in enumerate(v_bi)}
        w_lookup = {tuple(r): i for i, r in enumerate(w_bi)}
        all_rows = sorted(set(v_lookup) | set(w_lookup))
        blocks = []
        rows = []
        for row in all_rows:
            iv = v_lookup.get(row)
            iw = w_lookup.get(row)
            if iv is not None and iw is not None:
                blk = bb.linear_combination(a, bb.to_dtype(v.data.blocks[iv], dtype),
                                            b, bb.to_dtype(w.data.blocks[iw], dtype))
            elif iv is not None:
                blk = bb.mul(a, bb.to_dtype(v.data.blocks[iv], dtype))
            else:
                blk = bb.mul(b, bb.to_dtype(w.data.blocks[iw], dtype))
            blocks.append(blk)
            rows.append(row)
        if is_diag:
            bi = np.array([r[0] for r in rows], dtype=np.intp)
            return DiagonalBlockData(blocks, bi, dtype)
        n_cols = v.data.block_inds.shape[1]
        bi = (np.array(rows, dtype=np.intp).reshape((len(rows), n_cols))
              if rows else np.zeros((0, n_cols), np.intp))
        return BlockSparseData(blocks, bi, dtype)

    def norm(self, a):
        if not a.data.blocks:
            return 0.
        bb = self.block_backend
        # aggregate ON DEVICE: one host fetch for the tensor, not one per block
        total = bb.norm_sq(a.data.blocks[0])
        for b in a.data.blocks[1:]:
            total = total + bb.norm_sq(b)
        return float(total ** 0.5)

    def item(self, a):
        if len(a.data.blocks) == 0:
            return a.data.dtype.zero_scalar
        assert len(a.data.blocks) == 1
        return self.block_backend.block_item(a.data.blocks[0])

    def trace_full(self, a):
        bb = self.block_backend
        n = a.num_legs
        K = a.num_codomain_legs
        pairs = [(k, n - 1 - k) for k in range(K)]
        res = None
        for block, row in zip(a.data.blocks, a.data.block_inds):
            if not all(row[i] == row[j] for i, j in pairs):
                continue
            perm = list(range(K)) + list(range(n - 1, K - 1, -1))
            tr = bb.trace_full(bb.permute_axes(block, perm))
            res = tr if res is None else bb.add(res, tr)
        if res is None:
            return a.data.dtype.zero_scalar
        return bb.block_item(res)

    def add_trivial_leg(self, a, legs_pos, add_to_domain, co_domain_pos, new_codomain,
                        new_domain):
        bb = self.block_backend
        blocks = [bb.add_axis(b, legs_pos) for b in a.data.blocks]
        bi = a.data.block_inds
        block_inds = np.insert(bi, legs_pos, 0, axis=1)
        return BlockSparseData(blocks, block_inds, a.data.dtype)

    def squeeze_legs(self, a, idcs, new_codomain, new_domain):
        bb = self.block_backend
        blocks = [bb.squeeze_axes(b, idcs) for b in a.data.blocks]
        keep = [i for i in range(a.num_legs) if i not in idcs]
        block_inds = a.data.block_inds[:, keep]
        return BlockSparseData(blocks, block_inds, a.data.dtype)

    def get_element(self, a, idcs):
        spaces = list(conventional_leg_order(a.codomain, a.domain))
        row = []
        offsets = []
        for sp, i in zip(spaces, idcs):
            sector_idx, offset = sp.parse_index(int(i))
            row.append(sector_idx)
            offsets.append(offset)
        lookup = _row_lookup(a.data.block_inds)
        n = lookup.get(tuple(row))
        if n is None:
            return a.data.dtype.zero_scalar
        return self.block_backend.get_block_element(a.data.blocks[n], offsets)

    def act_block_diagonal_square_matrix(self, a, block_method, dtype_map):
        bb = self.block_backend
        leg = a.domain.factors[0]
        lookup = {int(r[0]): n for n, r in enumerate(a.data.block_inds)}
        blocks = []
        for i in range(leg.num_sectors):
            n = lookup.get(i)
            if n is None:
                m = int(leg.multiplicities[i])
                block = bb.zeros((m, m), a.data.dtype)
            else:
                block = a.data.blocks[n]
            blocks.append(block_method(block))
        dtype = a.data.dtype if dtype_map is None else dtype_map(a.data.dtype)
        blocks = [bb.to_dtype(b, dtype) for b in blocks]
        block_inds = np.repeat(np.arange(leg.num_sectors, dtype=np.intp)[:, None],
                               2, axis=1)
        return BlockSparseData(blocks, block_inds, dtype, is_sorted=True)

    # --- decompositions -----------------------------------------------------------------------

    def _matched_sector_triples(self, a, new_leg):
        """Yield (k_new, i_cod, j_dom, block or None) for a 2-leg tensor `a`."""
        cod_leg = a.codomain.factors[0]
        dom_leg = a.domain.factors[0]
        lookup = _row_lookup(a.data.block_inds)
        for k in range(new_leg.num_sectors):
            sector = new_leg.sector_decomposition[k]
            i = cod_leg.sector_decomposition_where(sector)
            j = dom_leg.sector_decomposition_where(sector)
            assert i is not None and j is not None, 'new_leg sector not in both legs'
            n = lookup.get((i, j))
            block = None if n is None else a.data.blocks[n]
            yield k, i, j, block

    def svd(self, a, new_leg, algorithm):
        bb = self.block_backend
        cod_leg = a.codomain.factors[0]
        dom_leg = a.domain.factors[0]
        u_blocks, u_rows = [], []
        s_blocks, s_rows = [], []
        vh_blocks, vh_rows = [], []
        for k, i, j, block in self._matched_sector_triples(a, new_leg):
            m = int(cod_leg.multiplicities[i])
            n_ = int(dom_leg.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                u = bb.eye_matrix(m, a.data.dtype)[:, :kdim]
                s = bb.zeros((kdim,), a.data.dtype.to_real)
                vh = bb.eye_matrix(n_, a.data.dtype)[:kdim, :]
            else:
                u, s, vh = bb.matrix_svd(block, algorithm)
            u_blocks.append(u)
            u_rows.append((i, k))
            s_blocks.append(s)
            s_rows.append(k)
            vh_blocks.append(vh)
            vh_rows.append((k, j))
        dtype = a.data.dtype
        u_data = BlockSparseData(u_blocks, np.array(u_rows, np.intp).reshape(-1, 2),
                                 dtype)
        s_data = DiagonalBlockData(s_blocks, np.array(s_rows, np.intp),
                                   dtype.to_real)
        vh_data = BlockSparseData(vh_blocks, np.array(vh_rows, np.intp).reshape(-1, 2),
                                  dtype)
        return u_data, s_data, vh_data

    def qr(self, a, new_leg):
        bb = self.block_backend
        cod_leg = a.codomain.factors[0]
        dom_leg = a.domain.factors[0]
        q_blocks, q_rows, r_blocks, r_rows = [], [], [], []
        for k, i, j, block in self._matched_sector_triples(a, new_leg):
            m = int(cod_leg.multiplicities[i])
            n_ = int(dom_leg.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                q = bb.eye_matrix(m, a.data.dtype)[:, :kdim]
                r = bb.zeros((kdim, n_), a.data.dtype)
            else:
                q, r = bb.matrix_qr(block)
            q_blocks.append(q)
            q_rows.append((i, k))
            r_blocks.append(r)
            r_rows.append((k, j))
        q_data = BlockSparseData(q_blocks, np.array(q_rows, np.intp).reshape(-1, 2),
                                 a.data.dtype)
        r_data = BlockSparseData(r_blocks, np.array(r_rows, np.intp).reshape(-1, 2),
                                 a.data.dtype)
        return q_data, r_data

    def lq(self, a, new_leg):
        bb = self.block_backend
        cod_leg = a.codomain.factors[0]
        dom_leg = a.domain.factors[0]
        l_blocks, l_rows, q_blocks, q_rows = [], [], [], []
        for k, i, j, block in self._matched_sector_triples(a, new_leg):
            m = int(cod_leg.multiplicities[i])
            n_ = int(dom_leg.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                l = bb.zeros((m, kdim), a.data.dtype)
                q = bb.eye_matrix(n_, a.data.dtype)[:kdim, :]
            else:
                l, q = bb.matrix_lq(block)
            l_blocks.append(l)
            l_rows.append((i, k))
            q_blocks.append(q)
            q_rows.append((k, j))
        l_data = BlockSparseData(l_blocks, np.array(l_rows, np.intp).reshape(-1, 2),
                                 a.data.dtype)
        q_data = BlockSparseData(q_blocks, np.array(q_rows, np.intp).reshape(-1, 2),
                                 a.data.dtype)
        return l_data, q_data

    def eigh(self, a, new_leg, sort):
        bb = self.block_backend
        leg = a.domain.factors[0]
        lookup = {int(r[0]): n for n, r in enumerate(a.data.block_inds)}
        w_blocks, w_rows, v_blocks, v_rows = [], [], [], []
        for i in range(leg.num_sectors):
            m = int(leg.multiplicities[i])
            n = lookup.get(i)
            if n is None:
                w = bb.zeros((m,), a.data.dtype.to_real)
                v = bb.eye_matrix(m, a.data.dtype)
            else:
                w, v = bb.matrix_eigh(a.data.blocks[n])
                w, v = _sort_eigh(bb, w, v, sort)
            w_blocks.append(w)
            w_rows.append(i)
            v_blocks.append(v)
            v_rows.append((i, i))
        w_data = DiagonalBlockData(w_blocks, np.array(w_rows, np.intp),
                                   a.data.dtype.to_real, is_sorted=True)
        v_data = BlockSparseData(v_blocks, np.array(v_rows, np.intp).reshape(-1, 2),
                                 a.data.dtype, is_sorted=True)
        return w_data, v_data

    # --- diagonal tensors ------------------------------------------------------------------------

    def diagonal_from_block(self, block, leg, tol):
        block, dtype = self.block_backend.as_block(block, return_dtype=True)
        if leg._basis_perm is not None:
            block = self.block_backend.xp.take(
                block, self.block_backend.xp.asarray(leg.basis_perm), axis=0)
        blocks = []
        block_inds = np.arange(leg.num_sectors, dtype=np.intp)
        for i in range(leg.num_sectors):
            blocks.append(block[int(leg.slices[i, 0]):int(leg.slices[i, 1])])
        return DiagonalBlockData(blocks, block_inds, dtype, is_sorted=True)

    def diagonal_to_block(self, a):
        bb = self.block_backend
        leg = a.leg
        res = bb.accumulator((leg.dim,), a.data.dtype)
        for block, i in zip(a.data.blocks, a.data.block_inds):
            res = bb.accum_add(res, slice(int(leg.slices[i, 0]),
                                          int(leg.slices[i, 1])), block)
        if leg._basis_perm is not None:
            res = bb.xp.take(res, bb.xp.asarray(leg.inverse_basis_perm), axis=0)
        return res

    def diagonal_from_sector_block_func(self, func, leg):
        blocks = [func((int(leg.multiplicities[i]),), leg.sector_decomposition[i])
                  for i in range(leg.num_sectors)]
        block_inds = np.arange(leg.num_sectors, dtype=np.intp)
        dtype = (self.block_backend.get_dtype(blocks[0]) if blocks
                 else Dtype.float64)
        return DiagonalBlockData(blocks, block_inds, dtype, is_sorted=True)

    def diagonal_data_from_full_tensor(self, a, check_offdiagonal):
        bb = self.block_backend
        blocks = [bb.get_diagonal(b, check_offdiagonal) for b in a.data.blocks]
        block_inds = a.data.block_inds[:, 0]
        return DiagonalBlockData(blocks, block_inds, a.data.dtype, is_sorted=True)

    def full_data_from_diagonal_tensor(self, a):
        bb = self.block_backend
        blocks = [bb.block_from_diagonal(b) for b in a.data.blocks]
        block_inds = np.repeat(a.data.block_inds[:, None], 2, axis=1)
        return BlockSparseData(blocks, block_inds, a.data.dtype, is_sorted=True)

    def diagonal_elementwise_unary(self, a, func, func_kwargs, maps_zero_to_zero):
        bb = self.block_backend
        leg = a.leg
        if maps_zero_to_zero:
            blocks = [func(b, **func_kwargs) for b in a.data.blocks]
            block_inds = a.data.block_inds
        else:
            lookup = {int(i): n for n, i in enumerate(a.data.block_inds)}
            blocks = []
            for i in range(leg.num_sectors):
                n = lookup.get(i)
                blk = (a.data.blocks[n] if n is not None
                       else bb.zeros((int(leg.multiplicities[i]),), a.data.dtype))
                blocks.append(func(blk, **func_kwargs))
            block_inds = np.arange(leg.num_sectors, dtype=np.intp)
        dtype = bb.get_dtype(blocks[0]) if blocks else a.data.dtype
        return DiagonalBlockData(blocks, block_inds, dtype, is_sorted=True)

    def diagonal_elementwise_binary(self, a, b, func, func_kwargs,
                                    partial_zero_is_zero):
        bb = self.block_backend
        leg = a.leg
        a_lookup = {int(i): n for n, i in enumerate(a.data.block_inds)}
        b_lookup = {int(i): n for n, i in enumerate(b.data.block_inds)}
        if partial_zero_is_zero:
            idcs = sorted(set(a_lookup) & set(b_lookup))
        else:
            idcs = list(range(leg.num_sectors))
        blocks = []
        for i in idcs:
            m = int(leg.multiplicities[i])
            na = a_lookup.get(i)
            nb = b_lookup.get(i)
            blk_a = a.data.blocks[na] if na is not None else bb.zeros((m,), a.data.dtype)
            blk_b = b.data.blocks[nb] if nb is not None else bb.zeros((m,), b.data.dtype)
            blocks.append(func(blk_a, blk_b, **func_kwargs))
        dtype = bb.get_dtype(blocks[0]) if blocks else a.data.dtype
        return DiagonalBlockData(blocks, np.array(idcs, np.intp), dtype,
                                 is_sorted=True)

    def diagonal_all(self, a):
        leg = a.leg
        if len(a.data.blocks) < leg.num_sectors:
            return False  # missing blocks are zero -> False
        return all(self.block_backend.block_all(b) for b in a.data.blocks)

    def diagonal_any(self, a):
        return any(self.block_backend.block_any(b) for b in a.data.blocks)

    def diagonal_sum_all(self, a):
        bb = self.block_backend
        if not a.data.blocks:
            return a.data.dtype.zero_scalar
        res = None
        for b in a.data.blocks:
            t = bb.block_sum_all(b)
            res = t if res is None else bb.add(res, t)
        return bb.block_item(res)

    def diagonal_to_mask(self, a):
        leg = a.leg
        public = np.zeros(int(leg.dim), dtype=bool)
        for block, i in zip(a.data.blocks, a.data.block_inds):
            public[int(leg.slices[i, 0]):int(leg.slices[i, 1])] = \
                self.block_backend.to_numpy(block).astype(bool)
        if leg._basis_perm is not None:
            public = public[leg.inverse_basis_perm]
        return self.mask_from_block(self.block_backend.as_block(public, Dtype.bool),
                                    leg)

    def diagonal_transpose(self, a):
        # sector index k refers to defining_sectors[k] in both leg and leg.dual
        return a.leg.dual, a.data

    def scale_axis(self, a, diag, leg_idx):
        bb = self.block_backend
        dtype = Dtype.common(a.data.dtype, diag.data.dtype)
        d_lookup = {int(i): n for n, i in enumerate(diag.data.block_inds)}
        blocks, rows = [], []
        for block, row in zip(a.data.blocks, a.data.block_inds):
            n = d_lookup.get(int(row[leg_idx]))
            if n is None:
                continue
            blocks.append(bb.scale_axis(bb.to_dtype(block, dtype),
                                        bb.to_dtype(diag.data.blocks[n], dtype),
                                        leg_idx))
            rows.append(row)
        bi = (np.array(rows, np.intp).reshape((len(rows), a.num_legs))
              if rows else np.zeros((0, a.num_legs), np.intp))
        return BlockSparseData(blocks, bi, dtype, is_sorted=True)

    # --- masks ---------------------------------------------------------------------------------

    def mask_from_block(self, block, large_leg):
        bb = self.block_backend
        mask_np = bb.to_numpy(block).astype(bool)
        assert mask_np.shape == (int(large_leg.dim),)
        small_leg = large_leg.take_slice(mask_np)
        internal = mask_np[large_leg.basis_perm] \
            if large_leg._basis_perm is not None else mask_np
        blocks, rows = [], []
        for i_large in range(large_leg.num_sectors):
            seg = internal[int(large_leg.slices[i_large, 0]):
                           int(large_leg.slices[i_large, 1])]
            if not np.any(seg):
                continue
            sector = large_leg.sector_decomposition[i_large]
            i_small = small_leg.sector_decomposition_where(sector)
            blocks.append(bb.as_block(seg, Dtype.bool))
            rows.append((i_small, i_large))
        data = MaskBlockData(blocks, np.array(rows, np.intp).reshape((len(rows), 2)))
        return data, small_leg

    def mask_to_block(self, a):
        bb = self.block_backend
        large_leg = a.large_leg
        res = np.zeros(int(large_leg.dim), dtype=bool)
        for block, (i_small, i_large) in zip(a.data.blocks, a.data.block_inds):
            res[int(large_leg.slices[i_large, 0]):int(large_leg.slices[i_large, 1])] = \
                bb.to_numpy(block).astype(bool)
        if large_leg._basis_perm is not None:
            res = res[large_leg.inverse_basis_perm]
        return bb.as_block(res, Dtype.bool)

    def mask_to_diagonal(self, a, leg):
        lookup = {int(i_large): n
                  for n, (i_small, i_large) in enumerate(a.data.block_inds)}
        bb = self.block_backend
        blocks, idcs = [], []
        for i in range(leg.num_sectors):
            n = lookup.get(i)
            if n is None:
                continue
            blocks.append(a.data.blocks[n])
            idcs.append(i)
        return DiagonalBlockData(blocks, np.array(idcs, np.intp), Dtype.bool,
                                 is_sorted=True)

    def mask_dagger(self, a):
        return MaskBlockData(list(a.data.blocks), a.data.block_inds[:, ::-1])

    def mask_binary_operand(self, a, b, func):
        bb = self.block_backend
        block = func(self.mask_to_block(a), self.mask_to_block(b))
        return self.mask_from_block(block, a.large_leg)

    def mask_unary_operand(self, a, func):
        block = func(self.mask_to_block(a))
        return self.mask_from_block(block, a.large_leg)

    def full_data_from_mask(self, a, dtype):
        bb = self.block_backend
        blocks = [bb.block_from_mask(b, dtype) for b in a.data.blocks]
        return BlockSparseData(blocks, a.data.block_inds.copy(), dtype)

    def apply_mask_to_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        bb = self.block_backend
        lookup = {int(i_large): (int(i_small), n)
                  for n, (i_small, i_large) in enumerate(mask.data.block_inds)}
        blocks, rows = [], []
        for block, row in zip(a.data.blocks, a.data.block_inds):
            hit = lookup.get(int(row[leg_idx]))
            if hit is None:
                continue
            i_small, n = hit
            blocks.append(bb.apply_mask(block, mask.data.blocks[n], leg_idx))
            new_row = row.copy()
            new_row[leg_idx] = i_small
            rows.append(new_row)
        bi = (np.array(rows, np.intp).reshape((len(rows), a.num_legs))
              if rows else np.zeros((0, a.num_legs), np.intp))
        return BlockSparseData(blocks, bi, a.data.dtype)

    def apply_mask_to_DiagonalTensor(self, a, mask):
        bb = self.block_backend
        lookup = {int(i_large): (int(i_small), n)
                  for n, (i_small, i_large) in enumerate(mask.data.block_inds)}
        blocks, idcs = [], []
        for block, i in zip(a.data.blocks, a.data.block_inds):
            hit = lookup.get(int(i))
            if hit is None:
                continue
            i_small, n = hit
            blocks.append(bb.apply_mask(block, mask.data.blocks[n], 0))
            idcs.append(i_small)
        return DiagonalBlockData(blocks, np.array(idcs, np.intp), a.data.dtype)

    def enlarge_leg_of_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        bb = self.block_backend
        # mask maps large -> small; we embed small into large
        lookup = {int(i_small): (int(i_large), n)
                  for n, (i_small, i_large) in enumerate(mask.data.block_inds)}
        large_leg = mask.large_leg
        blocks, rows = [], []
        for block, row in zip(a.data.blocks, a.data.block_inds):
            hit = lookup.get(int(row[leg_idx]))
            if hit is None:
                continue
            i_large, n = hit
            mask_np = bb.to_numpy(mask.data.blocks[n]).astype(bool)
            shape = list(bb.get_shape(block))
            shape[leg_idx] = int(large_leg.multiplicities[i_large])
            slices = [slice(None)] * len(shape)
            slices[leg_idx] = np.nonzero(mask_np)[0]
            blocks.append(bb.enlarge_block(block, shape, tuple(slices)))
            new_row = row.copy()
            new_row[leg_idx] = i_large
            rows.append(new_row)
        bi = (np.array(rows, np.intp).reshape((len(rows), a.num_legs))
              if rows else np.zeros((0, a.num_legs), np.intp))
        return BlockSparseData(blocks, bi, a.data.dtype)
