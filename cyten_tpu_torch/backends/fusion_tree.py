"""Tensor backend for fusion categories: SU(2), fermions and anyons.

The counterpart of ``cyten_tpu/backends/fusion_tree.py``, role-equivalent to reference
``cyten/backends/fusion_tree_backend.py`` (storage layout :1-78, compose :445, permute
engine :2698-3034, tree mappings :3181-3630, dense conversion :2393-2565). It takes
every symmetry the port has: SU(2), the graded fermionic ones (``FermionParity``,
``FermionNumber``, and their products with U(1) and Z_N) and the anyonic categories.

Storage: per coupled sector ``c`` one matrix block ``[codomain tree basis x domain
tree basis]`` (reusing :class:`BlockSparseData` with 2-column block_inds into the
(co)domain sector decompositions). A tensor is

    T = sum_c sum_{Y, X} block_c[Y-slice, X-slice] . hconj(Y) ∘ X

where Y runs over fusion trees of the codomain uncoupled sectors into c (the
*splitting* trees, stored as fusion trees), X over fusion trees of the domain.
Row layout per coupled block: uncoupled sector combinations (C-style over flat legs),
then tree index, then multiplicity indices (C-style) — provided by
``TensorProduct.iter_tree_blocks`` / ``tree_block_slice``.

All recoupling (F/R/B/C symbols, tree moves) happens on the host: ``permute_legs``
compiles the move sequence into a per-coupled-sector scatter/gather plan of static
slices and coefficients (``tree_moves.py``), applied on the device as batched gathers,
one coefficient product and batched scatter-adds per class of equal-shaped entries.
Plans are memoized on the (codomain, domain, permutation, levels) key, and the
device copies of their coefficients and indices on the block backend
(``TorchBlockBackend.constant``), so that a CUDA graph captured after an eager call
of the same structure copies nothing from the host. An abelian graded symmetry (every
sector one-dimensional, the fermionic ones and their products with U(1) and Z_N) moves
each tree pair to one tree pair with a sign: its plan (``tree_moves.AbelianPlan``) is
made from the sector tables at once, and applied as one signed gather of the
concatenated blocks.

``compose`` is one grouped-GEMM launch (:func:`~cyten_tpu_torch.blocks.grouped_gemm.
grouped_matmul`) over the list of per-coupled-sector block pairs, each pair with its
own output: the hand-written kernel on CUDA, its plain version on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np

from ..blocks.grouped_gemm import grouped_matmul
from ..dtypes import Dtype, is_complex_scalar
from ..symmetries import ElementarySpace, Symmetry, SymmetryError, TensorProduct
from ..symmetries.trees import FusionTree, fusion_trees
from ..tools.misc import iter_common_sorted_arrays
from ._backend import TensorBackend, conventional_leg_order
from .data import BlockSparseData, DiagonalBlockData, MaskBlockData
from .no_symmetry import _sort_eigh

__all__ = ['FusionTreeBackend']

EPS = 5e-14  # zero-block pruning (reference fusion_tree_backend.py:249)


def _coupled_sectors(codomain: TensorProduct, domain: TensorProduct):
    """(sectors, i_cod, j_dom): coupled sectors present in both decompositions."""
    pairs = list(iter_common_sorted_arrays(codomain.sector_decomposition,
                                           domain.sector_decomposition))
    sectors = np.array([codomain.sector_decomposition[i] for i, _ in pairs],
                       dtype=int).reshape(len(pairs), codomain.symmetry.sector_ind_len)
    i_cod = np.array([i for i, _ in pairs], dtype=np.intp)
    j_dom = np.array([j for _, j in pairs], dtype=np.intp)
    return sectors, i_cod, j_dom


class FusionTreeBackend(TensorBackend):
    """Backend for arbitrary fusion categories. See module docstring."""

    DataCls = BlockSparseData
    can_decompose_tensors = False
    #: mask application resolves kept indices on the host (tree-block row masks)
    mask_apply_traceable = False

    def supports_symmetry(self, symmetry: Symmetry) -> bool:
        return True

    def test_tensor_sanity(self, a, is_diagonal: bool = False):
        data = a.data
        if is_diagonal:
            assert isinstance(data, DiagonalBlockData)
            for block, i in zip(data.blocks, data.block_inds):
                self.block_backend.test_block_sanity(
                    block, expect_shape=(int(a.leg.multiplicities[i]),))
            return
        assert isinstance(data, BlockSparseData)
        assert data.block_inds.shape[1] == 2
        for block, (i, j) in zip(data.blocks, data.block_inds):
            assert np.all(a.codomain.sector_decomposition[i]
                          == a.domain.sector_decomposition[j])
            self.block_backend.test_block_sanity(
                block, expect_shape=(int(a.codomain.multiplicities[i]),
                                     int(a.domain.multiplicities[j])))

    def test_mask_sanity(self, a):
        data = a.data
        assert isinstance(data, MaskBlockData)
        for block, row in zip(data.blocks, data.block_inds):
            # rows are (i_codomain, i_domain): (small, large) for projections,
            # (large, small) for inclusions (created by dagger)
            i_small, i_large = row if a.is_projection else row[::-1]
            assert np.all(a.small_leg.sector_decomposition[i_small]
                          == a.large_leg.sector_decomposition[i_large])
            assert self.block_backend.sum_mask(block) \
                == a.small_leg.multiplicities[i_small]

    # --- creation ------------------------------------------------------------------------

    def zero_data(self, codomain, domain, dtype):
        return BlockSparseData([], np.zeros((0, 2), np.intp), dtype, is_sorted=True)

    def eye_data(self, codomain, domain, dtype):
        blocks = []
        rows = []
        sectors, i_cod, j_dom = _coupled_sectors(codomain, domain)
        for c, i, j in zip(sectors, i_cod, j_dom):
            m = int(codomain.multiplicities[i])
            blocks.append(self.block_backend.eye_matrix(m, dtype))
            rows.append((i, j))
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    def from_sector_block_func(self, func, codomain, domain):
        blocks = []
        rows = []
        sectors, i_cod, j_dom = _coupled_sectors(codomain, domain)
        for c, i, j in zip(sectors, i_cod, j_dom):
            shape = (int(codomain.multiplicities[i]), int(domain.multiplicities[j]))
            blocks.append(func(shape, c))
            rows.append((i, j))
        dtype = self.block_backend.get_dtype(blocks[0]) if blocks else Dtype.float64
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    def sector_projection_data(self, co_domain, sector, dtype):
        """Projector onto the given coupled sector: eye on that sector's block.

        Reference: cyten/tensors/_tensors.py:1270 (from_sector_projection).
        """
        bb = self.block_backend

        def func(shape, coupled):
            if np.all(coupled == sector):
                return bb.eye_matrix(shape[0], dtype)
            return bb.zeros(shape, dtype)

        return self.from_sector_block_func(func, co_domain, co_domain)

    def copy_data(self, a):
        return BlockSparseData([self.block_backend.copy_block(b)
                                for b in a.data.blocks],
                               a.data.block_inds.copy(), a.data.dtype, is_sorted=True)

    # --- dense conversion -------------------------------------------------------------------

    def to_dense_block(self, a):
        """Sum of coeff * (dense splitting tree) ⊗ conj(dense fusion tree)."""
        sym = a.symmetry
        if not sym.can_be_dropped:
            raise SymmetryError(f'to_dense_block is meaningless for {sym}')
        bb = self.block_backend
        spaces = list(conventional_leg_order(a.codomain, a.domain))
        # dense axes: [cod flat legs ..., rev dom flat legs ...]
        cod_legs = a.codomain.flat_legs
        dom_legs = a.domain.flat_legs
        shape = tuple(int(l.dim) for l in cod_legs) \
            + tuple(int(l.dim) for l in reversed(dom_legs))
        res = np.zeros(shape, dtype=complex)
        lookup = {(int(i), int(j)): n for n, (i, j) in enumerate(a.data.block_inds)}
        sectors, i_cod, j_dom = _coupled_sectors(a.codomain, a.domain)
        for c, i, j in zip(sectors, i_cod, j_dom):
            n = lookup.get((int(i), int(j)))
            if n is None:
                continue
            block = bb.to_numpy(a.data.blocks[n])
            for Y, row_slc, row_mults, _ in a.codomain.iter_tree_blocks([c]):
                Y_dense = Y.as_block()  # [m_a1.., m_c]
                for X, col_slc, col_mults, _ in a.domain.iter_tree_blocks([c]):
                    coeffs = block[row_slc, col_slc]
                    if np.linalg.norm(coeffs) < EPS:
                        continue
                    X_dense = np.conj(X.as_block())  # [m_b1.., m_c]
                    # coeffs[rows, cols] with rows = C-flat cod mults, cols likewise
                    C = coeffs.reshape(tuple(row_mults) + tuple(col_mults))
                    # contribution[a1..aJ, b1..bM] = sum_mc Y[a.., mc] X*[b.., mc]
                    trees = np.tensordot(Y_dense, X_dense,
                                         (Y_dense.ndim - 1, X_dense.ndim - 1))
                    # trees axes: [d_a1.., d_b1..]; C axes: [m_a1.., m_b1..]
                    contrib = _mult_kron(C, trees, len(row_mults), len(col_mults))
                    # contrib axes: [(m,d)_a1.., (m,d)_b1..] merged per leg, in
                    # cod flat order then dom flat (factor) order
                    _scatter_tree_contribution(res, contrib, cod_legs, dom_legs,
                                               Y, X)
        # sector basis -> public basis (per flat leg)
        for ax, leg in enumerate(cod_legs + list(reversed(dom_legs))):
            if leg._basis_perm is not None:
                res = np.take(res, leg.inverse_basis_perm, axis=ax)
        # combine pipe axes: public combined basis = C-flatten in legs order
        out_shape = tuple(int(sp.dim) for sp in a.codomain.factors) \
            + tuple(int(sp.dim) for sp in reversed(a.domain.factors))
        res = res.reshape(out_shape)
        scale = max(1., float(np.abs(res).max() if res.size else 0.))
        if np.allclose(res.imag, 0, atol=1e-14 * scale):
            res = res.real.copy()
        return bb.as_block(res)

    def from_dense_block(self, block, codomain, domain, tol):
        sym = codomain.symmetry
        if not sym.can_be_dropped:
            raise SymmetryError(f'from_dense_block is meaningless for {sym}')
        bb = self.block_backend
        arr = np.asarray(bb.to_numpy(block))
        dtype = Dtype.from_numpy(arr.dtype) if arr.dtype != bool else Dtype.float64
        cod_legs = codomain.flat_legs
        dom_legs = domain.flat_legs
        # split pipe axes (public combined basis = C-flatten in legs order)
        flat_shape = tuple(int(l.dim) for l in cod_legs) \
            + tuple(int(l.dim) for l in reversed(dom_legs))
        arr = arr.reshape(flat_shape)
        # public -> sector basis
        for ax, leg in enumerate(cod_legs + list(reversed(dom_legs))):
            if leg._basis_perm is not None:
                arr = np.take(arr, leg.basis_perm, axis=ax)
        sectors, i_cod, j_dom = _coupled_sectors(codomain, domain)
        blocks = []
        rows = []
        total_sq = np.linalg.norm(arr.reshape(-1)) ** 2
        kept_sq = 0.
        for c, i, j in zip(sectors, i_cod, j_dom):
            d_c = sym.sector_dim(c)
            qd_c = sym.qdim(c)
            M = int(codomain.multiplicities[i])
            N = int(domain.multiplicities[j])
            coeffs = np.zeros((M, N), dtype=complex)
            for Y, row_slc, row_mults, _ in codomain.iter_tree_blocks([c]):
                Y_dense = Y.as_block()
                for X, col_slc, col_mults, _ in domain.iter_tree_blocks([c]):
                    X_dense = np.conj(X.as_block())
                    trees = np.tensordot(Y_dense, X_dense,
                                         (Y_dense.ndim - 1, X_dense.ndim - 1))
                    sub = _gather_tree_contribution(arr, cod_legs, dom_legs, Y, X)
                    # sub axes: [(m,d)_a.., (m,d)_b..]; project onto trees / d_c
                    C = _mult_unkron(sub, trees, row_mults, col_mults) / d_c
                    coeffs[row_slc, col_slc] = C.reshape(
                        int(np.prod(row_mults)) if len(row_mults) else 1,
                        int(np.prod(col_mults)) if len(col_mults) else 1)
            kept_sq += qd_c * np.linalg.norm(coeffs) ** 2
            if np.linalg.norm(coeffs) > EPS:
                if np.allclose(coeffs.imag, 0):
                    coeffs = coeffs.real.copy()
                else:
                    dtype = dtype.to_complex
                blocks.append(coeffs)
                rows.append((int(i), int(j)))
        if tol is not None and total_sq > 0:
            eps = dtype.eps if not dtype.is_bool else 1e-15
            if abs(total_sq - kept_sq) > (tol ** 2 + 256 * eps) * total_sq:
                raise ValueError('Block is not symmetric up to tolerance: '
                                 f'{abs(total_sq - kept_sq) / total_sq}')
        blocks = [bb.as_block(b, dtype) for b in blocks]
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    # --- elementary ops -----------------------------------------------------------------------

    def compose(self, a, b):
        """Per-coupled-sector GEMM, matched by a.domain == b.codomain decomposition:
        the list of block pairs, one per coupled sector that both tensors hold, as
        one grouped-GEMM call, each pair with its own output."""
        bb = self.block_backend
        dtype = Dtype.common(a.data.dtype, b.data.dtype)
        # a.domain == b.codomain, but decomposition *orders* may differ if objects
        # differ; they are equal TensorProducts, so indices align directly.
        ia, ib, rows = _compose_pairs(a.data.block_inds.tobytes(), len(a.data.block_inds),
                                      b.data.block_inds.tobytes(), len(b.data.block_inds))
        if not rows:
            return BlockSparseData([], np.zeros((0, 2), np.intp), dtype)
        blocks = grouped_matmul(a.data.blocks, b.data.blocks, pairs=(ia, ib))
        blocks = [blk if bb.get_dtype(blk) == dtype else bb.to_dtype(blk, dtype)
                  for blk in blocks]
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    def dagger(self, a):
        bb = self.block_backend
        blocks = [bb.permute_axes(bb.conj(blk), [1, 0]) for blk in a.data.blocks]
        return BlockSparseData(blocks, a.data.block_inds[:, ::-1], a.data.dtype)

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
        # identical structure to the abelian case: align blocks by block_inds rows
        from .abelian import AbelianBackend

        return AbelianBackend.linear_combination(self, a, v, b, w)

    def to_dtype(self, a, dtype):
        from .abelian import AbelianBackend

        return AbelianBackend.to_dtype(self, a, dtype)

    def get_dtype_from_data(self, a):
        return a.dtype

    def block_weights(self, a):
        """The quantum dimension of each block's coupled sector."""
        inds = a.data.block_inds
        if isinstance(a.data, DiagonalBlockData):
            qdims = np.asarray(a.leg.sector_qdims)[inds]
        else:
            qdims = a.symmetry.batch_qdim(a.codomain.sector_decomposition[inds[:, 0]])
        return tuple(float(q) for q in qdims)

    def leg_sector_map(self, leg):
        tp = TensorProduct([leg])
        return np.array([_sector_index(tp, c) for c in leg.sector_decomposition],
                        np.intp)

    def norm(self, a):
        bb = self.block_backend
        # qdim-weighted squared norms, aggregated ON DEVICE: one host fetch
        # per tensor, not one per block (see BlockBackend.norm_sq)
        terms = [q * bb.norm_sq(b) for q, b in zip(self.block_weights(a), a.data.blocks)]
        if not terms:
            return 0.
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return float(total ** 0.5)

    def inner(self, a, b, do_dagger):
        bb = self.block_backend
        lookup = {tuple(r): n for n, r in enumerate(b.data.block_inds)}
        weights = self.block_weights(a)
        res = None
        for n, row in enumerate(a.data.block_inds):
            if do_dagger:
                m = lookup.get(tuple(row))
            else:
                m = lookup.get(tuple(row[::-1]))
            if m is None:
                continue
            qd = weights[n]
            if do_dagger:
                term = bb.inner(a.data.blocks[n], b.data.blocks[m], do_dagger=True)
            else:
                term = bb.block_sum_all(
                    bb.mul(1., a.data.blocks[n])
                    * bb.permute_axes(b.data.blocks[m], [1, 0]))
            term = qd * term
            res = term if res is None else bb.add(res, term)
        if res is None:
            return Dtype.common(a.data.dtype, b.data.dtype).zero_scalar
        return bb.block_item(res)

    def item(self, a):
        if len(a.data.blocks) == 0:
            return a.data.dtype.zero_scalar
        assert len(a.data.blocks) == 1
        return self.block_backend.block_item(a.data.blocks[0])

    def trace_full(self, a):
        bb = self.block_backend
        res = None
        for qd, block in zip(self.block_weights(a), a.data.blocks):
            term = qd * bb.trace_full(block)
            res = term if res is None else bb.add(res, term)
        if res is None:
            return a.data.dtype.zero_scalar
        return bb.block_item(res)

    def get_element(self, a, idcs):
        blk = self.to_dense_block(a)
        return self.block_backend.get_block_element(blk, [int(i) for i in idcs])

    def act_block_diagonal_square_matrix(self, a, block_method, dtype_map):
        bb = self.block_backend
        sectors, i_cod, j_dom = _coupled_sectors(a.codomain, a.domain)
        lookup = {tuple(r): n for n, r in enumerate(a.data.block_inds)}
        blocks, rows = [], []
        for c, i, j in zip(sectors, i_cod, j_dom):
            n = lookup.get((int(i), int(j)))
            if n is None:
                m = int(a.codomain.multiplicities[i])
                block = bb.zeros((m, m), a.data.dtype)
            else:
                block = a.data.blocks[n]
            blocks.append(block_method(block))
            rows.append((int(i), int(j)))
        dtype = a.data.dtype if dtype_map is None else dtype_map(a.data.dtype)
        blocks = [bb.to_dtype(b, dtype) for b in blocks]
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    # --- structure ops -------------------------------------------------------------------------

    def combine_legs(self, a, leg_idcs_combine, pipes, new_codomain, new_domain):
        # pipes only regroup metadata; tree-basis enumeration uses flat legs
        # (reference fusion_tree_backend.py:435-443)
        return BlockSparseData(list(a.data.blocks), a.data.block_inds.copy(),
                               a.data.dtype, is_sorted=True)

    def split_legs(self, a, leg_idcs, codomain_split, domain_split, new_codomain,
                   new_domain):
        return BlockSparseData(list(a.data.blocks), a.data.block_inds.copy(),
                               a.data.dtype, is_sorted=True)

    def add_trivial_leg(self, a, legs_pos, add_to_domain, co_domain_pos, new_codomain,
                        new_domain):
        # the tree bases with an extra trivial sector are in 1:1 correspondence;
        # row/column layouts are unchanged because the trivial sector fuses trivially
        # and multiplicity 1 does not reorder strides.
        rows = []
        for i, j in a.data.block_inds:
            c = a.codomain.sector_decomposition[i]
            i_new = _sector_index(new_codomain, c)
            j_new = _sector_index(new_domain, c)
            rows.append((i_new, j_new))
        return BlockSparseData(list(a.data.blocks),
                               np.array(rows, np.intp).reshape(-1, 2),
                               a.data.dtype)

    def squeeze_legs(self, a, idcs, new_codomain, new_domain):
        rows = []
        for i, j in a.data.block_inds:
            c = a.codomain.sector_decomposition[i]
            i_new = _sector_index(new_codomain, c)
            j_new = _sector_index(new_domain, c)
            rows.append((i_new, j_new))
        return BlockSparseData(list(a.data.blocks),
                               np.array(rows, np.intp).reshape(-1, 2),
                               a.data.dtype)

    def outer(self, a, b, new_codomain, new_domain):
        """Tensor product: decompose (Y_A ⊗ Y_B) and (X_A ⊗ X_B) into canonical
        trees via FusionTree.outer_embeddings; the splitting side contributes
        conjugated coefficients. The embedding label (coupled sector, fusion
        multiplicity m) is CONTRACTED between the two sides — it indexes the
        resolution of id_{cA⊗cB}, so only equal (c, m) keys pair up. (The
        reference sums both sides over m independently,
        fusion_tree_backend.py:1604-1631, which is wrong for fusion
        multiplicity N > 1; pinned by the SU(3) dense oracle,
        tests/test_ops_coverage.py.) Row layout = A-major kron of the factors."""
        bb = self.block_backend
        dtype = Dtype.common(a.data.dtype, b.data.dtype)
        new_blocks: dict[tuple, object] = {}
        decomp_cache: dict[tuple, dict] = {}

        def embeddings(t1, t2):
            key = (t1, t2)
            res = decomp_cache.get(key)
            if res is None:
                res = decomp_cache[key] = t1.outer_embeddings(t2)
            return res

        def tree_items(tensor, side, c):
            tp = tensor.codomain if side == 'cod' else tensor.domain
            return list(tp.iter_tree_blocks([np.asarray(c)]))

        for na, (ia_, ja_) in enumerate(a.data.block_inds):
            cA = a.codomain.sector_decomposition[ia_]
            blockA = a.data.blocks[na]
            rowsA = tree_items(a, 'cod', cA)
            colsA = tree_items(a, 'dom', cA)
            for nb, (ib_, jb_) in enumerate(b.data.block_inds):
                cB = b.codomain.sector_decomposition[ib_]
                blockB = b.data.blocks[nb]
                rowsB = tree_items(b, 'cod', cB)
                colsB = tree_items(b, 'dom', cB)
                for YA, slA, mA, _ in rowsA:
                    for YB, slB, mB, _ in rowsB:
                        decompY = embeddings(YA, YB)
                        for XA, tlA, nA_, _ in colsA:
                            for XB, tlB, nB_, _ in colsB:
                                decompX = embeddings(XA, XB)
                                subA = blockA[slA, tlA]
                                subB = blockB[slB, tlB]
                                # kron with A-major rows and cols
                                sub = _kron2(bb, subA, subB)
                                for emb, dY in decompY.items():
                                    dX = decompX.get(emb)
                                    if dX is None:
                                        continue
                                    for Yp, cy in dY.items():
                                        for Xp, cx in dX.items():
                                            coeff = np.conj(cy) * cx
                                            if abs(coeff) < EPS:
                                                continue
                                            self._outer_scatter(
                                                bb, new_blocks, new_codomain,
                                                new_domain, Yp, Xp, coeff, sub,
                                                dtype)
        rows = list(new_blocks.keys())
        blocks = [new_blocks[r] for r in rows]
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(len(rows), 2),
                               dtype)

    @staticmethod
    def _outer_scatter(bb, new_blocks, new_codomain, new_domain, Yp, Xp, coeff,
                       sub, dtype):
        c = Yp.coupled
        i = _sector_index(new_codomain, c)
        j = _sector_index(new_domain, c)
        if i is None or j is None:
            return
        key = (int(i), int(j))
        target = new_blocks.get(key)
        if target is None:
            target = bb.zeros((int(new_codomain.multiplicities[i]),
                               int(new_domain.multiplicities[j])), dtype)
        r_slc = new_codomain.tree_block_slice(Yp)
        c_slc = new_domain.tree_block_slice(Xp)
        cur = target[r_slc, c_slc]
        target = bb._setitem(target, (r_slc, c_slc),
                             bb.add(cur, bb.mul(complex(coeff) if
                                                abs(complex(coeff).imag) > 0
                                                else float(np.real(coeff)),
                                                bb.to_dtype(sub, dtype))))
        new_blocks[key] = target

    def partial_trace(self, a, pairs, levels, new_codomain, new_domain):
        """Native categorical partial trace on fusion-tree data.

        Strategy (behavioral parity with reference fusion_tree_backend.py:1755,
        built on this backend's own plan machinery): permute so each traced pair
        sits adjacent (second member bent up when a pair spans codomain/domain),
        then per (codomain tree, domain tree) keep only trees where each pair
        fuses back to its left inner sector ("on the diagonal"); the loop weight
        is a product of B symbols (and Frobenius-Schur signs for dual legs),
        realizing the quantum trace with qdim weights.

        When braids are required but ``levels`` were not given, canonical
        levels are synthesized as long as no two traced pairs interleave: the
        trace loop around a pair slides freely over every strand it crosses
        (Reidemeister II removes the same-chirality crossing pair), so any
        assignment placing both members of a pair adjacent in level order --
        above all other legs -- yields the isotopy-invariant answer. This is
        exactly the consistency condition the reference enforces on
        user-supplied levels (fusion_tree_backend.py:1791-1806); interleaved
        pairs form *linked* loops whose value genuinely depends on chirality,
        so those still require explicit levels (NotImplementedError -> planar
        cap fallback / SymmetryError in the tensors layer).
        """
        bb = self.block_backend
        sym = a.symmetry
        K = a.num_codomain_legs
        n = a.num_legs
        pairs = sorted(tuple(sorted(p)) for p in pairs)
        idcs1 = [p[0] for p in pairs]
        idcs2 = [p[1] for p in pairs]
        traced = set(idcs1) | set(idcs2)
        remaining = [i for i in range(n) if i not in traced]
        # new leg order: remaining legs keep their order, each pair inserted
        # adjacently where its first member used to sit
        idcs = list(remaining)
        num_codom = K
        for k, (i1, i2) in enumerate(pairs):
            pos = int(np.searchsorted(remaining, i1)) + 2 * k
            idcs[pos:pos] = [i1, i2]
            if i1 < K <= i2:
                num_codom += 1  # second member is bent up into the codomain
        num_dom = n - num_codom
        codomain_idcs = idcs[:num_codom]
        domain_idcs = idcs[num_codom:][::-1]
        from ..symmetries import TensorProduct
        codom = TensorProduct([a._as_codomain_leg(i) for i in codomain_idcs],
                              symmetry=sym)
        dom = TensorProduct([a._as_domain_leg(i) for i in domain_idcs],
                            symmetry=sym)
        # NOTE unlike the reference (fusion_tree_backend.py:1791-1806) we do
        # NOT forbid user levels that place a foreign leg between a pair's two
        # levels: all crossings are resolved with definite chirality in the
        # permute step below, so the closure is local and ANY level assignment
        # is well-defined (this is what makes linked closures -- Hopf links --
        # computable here, see tests/test_fusion_tree_backend.py).
        perm_data = self.permute_legs(a, codomain_idcs, domain_idcs, levels,
                                      codom, dom)
        if perm_data is None and levels is None:
            # canonical auto-levels (see docstring): only linked (interleaved)
            # loops are chirality-dependent; `pairs` is sorted by first member
            interleaved = any(p[0] < q[0] < p[1] < q[1]
                              for pi, p in enumerate(pairs)
                              for q in pairs[pi + 1:])
            if not interleaved:
                auto = [0] * n
                for pos, r in enumerate(remaining):
                    auto[r] = pos
                for k, (i1, i2) in enumerate(pairs):
                    auto[i1] = n + 2 * k
                    auto[i2] = n + 2 * k + 1
                perm_data = self.permute_legs(a, codomain_idcs, domain_idcs,
                                              auto, codom, dom)
        if perm_data is None:
            raise NotImplementedError('partial_trace: braids require levels')

        # positions within the permuted codomain / domain (factor order)
        codom_unc_idcs = [p for p, idx in enumerate(codomain_idcs)
                          if idx in remaining]
        codom_inner_idcs = [p - 2 for p in codom_unc_idcs[2:]]
        codom_multi_idcs = [p - 1 for p in codom_unc_idcs[1:]]
        codom_tree_idcs = [p for p, idx in enumerate(codomain_idcs)
                           if idx in idcs1]
        dom_factor_legs = idcs[num_codom:][::-1]  # == domain_idcs
        dom_unc_idcs = [p for p, idx in enumerate(dom_factor_legs)
                        if idx in remaining]
        dom_inner_idcs = [p - 2 for p in dom_unc_idcs[2:]]
        dom_multi_idcs = [p - 1 for p in dom_unc_idcs[1:]]
        dom_tree_idcs = [p for p, idx in enumerate(dom_factor_legs)
                         if idx in idcs2]
        # axes of the (codom mults..., dom mults...) tree-block for the trace
        tr_legs = codomain_idcs + dom_factor_legs
        axis_of = {idx: p for p, idx in enumerate(tr_legs)}
        tr_idcs1 = [axis_of[i1] for i1, i2 in pairs]
        tr_idcs2 = [axis_of[i2] for i1, i2 in pairs]
        remain_axes = [p for p, idx in enumerate(tr_legs) if idx in remaining]

        dtype = a.data.dtype
        lookup = {tuple(r): n_ for n_, r in enumerate(perm_data.block_inds)}
        new_blocks: dict[tuple, object] = {}
        for (i_cod, j_dom), n_ in lookup.items():
            c = codom.sector_decomposition[i_cod]
            new_i = _sector_index(new_codomain, c) if new_codomain.num_factors \
                else (0 if np.all(c == sym.trivial_sector) else None)
            new_j = _sector_index(new_domain, c) if new_domain.num_factors \
                else (0 if np.all(c == sym.trivial_sector) else None)
            if new_i is None or new_j is None:
                continue
            block = perm_data.blocks[n_]
            for codom_tree, codom_slc, codom_mults, _ in codom.iter_tree_blocks([c]):
                ok, f_cod = _trace_tree_factor(codom_tree, codom_tree_idcs)
                if not ok:
                    continue
                new_codom_tree = FusionTree(
                    sym, codom_tree.uncoupled[codom_unc_idcs],
                    codom_tree.coupled, codom_tree.are_dual[codom_unc_idcs],
                    codom_tree.inner_sectors[codom_inner_idcs],
                    codom_tree.multiplicities[codom_multi_idcs])
                new_r_slc = new_codomain.tree_block_slice(new_codom_tree) \
                    if new_codomain.num_factors else slice(0, 1)
                for dom_tree, dom_slc, dom_mults, _ in dom.iter_tree_blocks([c]):
                    ok, f_dom = _trace_tree_factor(dom_tree, dom_tree_idcs)
                    if not ok:
                        continue
                    new_dom_tree = FusionTree(
                        sym, dom_tree.uncoupled[dom_unc_idcs],
                        dom_tree.coupled, dom_tree.are_dual[dom_unc_idcs],
                        dom_tree.inner_sectors[dom_inner_idcs],
                        dom_tree.multiplicities[dom_multi_idcs])
                    new_c_slc = new_domain.tree_block_slice(new_dom_tree) \
                        if new_domain.num_factors else slice(0, 1)
                    sub = block[codom_slc, dom_slc]
                    sub = bb.reshape(sub, tuple(int(m) for m in codom_mults)
                                     + tuple(int(m) for m in dom_mults))
                    contrib = bb.trace_partial(sub, tr_idcs1, tr_idcs2,
                                               remain_axes)
                    contrib = bb.reshape(
                        contrib, (new_r_slc.stop - new_r_slc.start,
                                  new_c_slc.stop - new_c_slc.start))
                    coeff = f_cod * np.conj(f_dom)
                    key = (int(new_i), int(new_j))
                    target = new_blocks.get(key)
                    if target is None:
                        shape = (
                            int(new_codomain.multiplicities[new_i])
                            if new_codomain.num_factors else 1,
                            int(new_domain.multiplicities[new_j])
                            if new_domain.num_factors else 1)
                        target = bb.accumulator(shape, dtype)
                    new_blocks[key] = bb.accum_add(
                        target, (new_r_slc, new_c_slc),
                        bb.mul(complex(coeff) if abs(complex(coeff).imag) > 0
                               else float(np.real(coeff)),
                               bb.to_dtype(contrib, dtype)))
        if len(remaining) == 0:
            if not new_blocks:
                return dtype.zero_scalar, True
            val = bb.finalize_accumulator(next(iter(new_blocks.values())))
            return bb.block_item(val), True
        rows = list(new_blocks.keys())
        blocks = [bb.finalize_accumulator(new_blocks[r]) for r in rows]
        data = BlockSparseData(blocks, np.array(rows, np.intp).reshape(
            len(rows), 2), dtype)
        return data, False

    # --- permute_legs (braids & bends) ----------------------------------------------------------

    def permute_legs(self, a, codomain_idcs, domain_idcs, levels, new_codomain,
                     new_domain, bend_right=None):
        from .tree_moves import AbelianPlan, permute_legs_plan

        key_levels = None if levels is None else tuple(levels)
        plan = permute_legs_plan(a.codomain, a.domain, tuple(codomain_idcs),
                                 tuple(domain_idcs), key_levels,
                                 bend_right=bend_right)
        if plan is None:
            return None  # levels required
        if isinstance(plan, AbelianPlan):
            return self._apply_abelian_plan(a, plan)
        return self._apply_plan_grouped(a, plan, new_codomain, new_domain)

    def _apply_abelian_plan(self, a, plan):
        """A plan of an abelian graded symmetry as one gather: the old blocks and a
        zero concatenated, their elements taken in the new blocks' order by one
        index (and multiplied by the signs, if any is -1), the new blocks views of
        the result. The index and signs are device constants of the block backend,
        made once per plan and set of present blocks."""
        from .tree_moves import abelian_program

        bb = self.block_backend
        lookup = {tuple(r): n for n, r in enumerate(a.data.block_inds)}
        present = tuple(sorted(lookup))
        prog = abelian_program(plan, present)
        dtype = a.data.dtype
        if not prog.new_keys:
            return BlockSparseData([], np.zeros((0, 2), np.intp), dtype)
        flat = bb.concatenate([bb.reshape(a.data.blocks[lookup[k]], (-1,)) for k in present]
                              + [bb.zeros((1,), dtype)])
        out = bb.take_flat(flat, ('abelian_index', plan.token, present), prog.index)
        if prog.signs is not None:
            out = out * bb.cached(('abelian_signs', plan.token, present, dtype),
                                  lambda: bb.as_block(prog.signs, dtype))
        blocks = []
        pos = 0
        for h, w in prog.new_shapes:
            blocks.append(bb.reshape(out[pos:pos + h * w], (h, w)))
            pos += h * w
        return BlockSparseData(blocks, np.array(prog.new_keys, np.intp).reshape(-1, 2),
                               dtype)

    def _apply_plan_grouped(self, a, plan, new_codomain, new_domain):
        """Index-batched plan application: per shape class, ONE batched gather per
        source block, ONE transform (a dense coefficient product for small
        sub-blocks, a per-entry coefficient multiply above
        :data:`~.tree_moves.GROUPED_MAX_BLOCK` elements), and ONE batched scatter-add per
        destination block. The launch count is O(blocks touched), not O(plan
        entries). The coefficients and indices are device constants of the block
        backend (:meth:`~cyten_tpu_torch.blocks.backend.BlockBackend.constant`), so
        nothing is copied from the host once a plan has run. The coefficient product
        is a small dense ``torch.matmul`` (cyten_tpu computes it outside its Pallas
        kernel too)."""
        from .tree_moves import batched_program

        bb = self.block_backend
        dtype = a.data.dtype
        if plan.complex_coeffs:
            dtype = dtype.to_complex
        lookup = {tuple(r): n for n, r in enumerate(a.data.block_inds)}
        present = tuple(sorted(lookup))
        prog = batched_program(plan, present)
        new_blocks: dict[tuple, object] = {}

        def get_target(nbk):
            target = new_blocks.get(nbk)
            if target is None:
                i_new, j_new = nbk
                shape = (int(new_codomain.multiplicities[i_new]),
                         int(new_domain.multiplicities[j_new]))
                target = bb.accumulator(shape, dtype)
            return target

        for g in prog.groups:
            parts = [bb.batched_slice(a.data.blocks[lookup[obk]], starts,
                                      g.old_shape_2d)
                     for obk, starts in g.gathers]
            x = parts[0] if len(parts) == 1 else bb.concatenate(parts, axis=0)
            x = bb.to_dtype(x, dtype)
            n = len(x)
            x = bb.reshape(x, (n,) + g.mult_shape)
            x = bb.permute_axes(x, (0,) + tuple(p + 1 for p in g.axis_perm))
            if g.mode == 'gemm':
                x = bb.reshape(x, (n, g.new_shape_2d[0] * g.new_shape_2d[1]))
                y = bb.matrix_dot(bb.constant(g.coeff, dtype), x)
                y = bb.reshape(y, (len(g.coeff),) + g.new_shape_2d)
            else:  # 'sparse': per-entry coefficients, FLOPs ~ nnz
                y = bb.reshape(x, (n,) + g.new_shape_2d)
                y = y * bb.reshape(bb.constant(g.coeff, dtype), (n, 1, 1))
            for nbk, rows_idx, starts in g.scatters:
                upd = y if rows_idx is None else bb.take_rows(y, rows_idx)
                new_blocks[nbk] = bb.batched_accum_add(get_target(nbk),
                                                       starts, upd)
        rows = list(new_blocks.keys())
        blocks = [bb.finalize_accumulator(new_blocks[r]) for r in rows]
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(len(rows), 2),
                               dtype)

    # --- decompositions ---------------------------------------------------------------------------

    def _matched(self, a, new_leg):
        """Yield ``(k, k_tp, i, j, block)`` per new-leg sector.

        ``k`` indexes ``new_leg.sector_decomposition`` (DiagonalBlockData rows),
        ``k_tp`` the same sector in ``TensorProduct([new_leg])`` — the index
        space of the result tensors' BlockSparseData rows. The two orders
        differ when ``new_leg`` is dual (dual_sorted vs sorted).
        """
        cod = a.codomain
        dom = a.domain
        tp_new = TensorProduct([new_leg])
        lookup = {tuple(r): n for n, r in enumerate(a.data.block_inds)}
        for k in range(new_leg.num_sectors):
            c = new_leg.sector_decomposition[k]
            k_tp = _sector_index(tp_new, c)
            i = _sector_index(cod, c)
            j = _sector_index(dom, c)
            n = lookup.get((i, j))
            yield k, k_tp, i, j, (None if n is None else a.data.blocks[n])

    def svd(self, a, new_leg, algorithm):
        bb = self.block_backend
        u_blocks, u_rows, s_blocks, s_rows, vh_blocks, vh_rows = [], [], [], [], [], []
        for k, k_tp, i, j, block in self._matched(a, new_leg):
            m = int(a.codomain.multiplicities[i])
            n_ = int(a.domain.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                u = bb.eye_matrix(m, a.data.dtype)[:, :kdim]
                s = bb.zeros((kdim,), a.data.dtype.to_real)
                vh = bb.eye_matrix(n_, a.data.dtype)[:kdim, :]
            else:
                u, s, vh = bb.matrix_svd(block, algorithm)
            u_blocks.append(u)
            u_rows.append((i, k_tp))
            s_blocks.append(s)
            s_rows.append(k)
            vh_blocks.append(vh)
            vh_rows.append((k_tp, j))
        dtype = a.data.dtype
        return (BlockSparseData(u_blocks, np.array(u_rows, np.intp).reshape(-1, 2),
                                dtype),
                DiagonalBlockData(s_blocks, np.array(s_rows, np.intp), dtype.to_real),
                BlockSparseData(vh_blocks, np.array(vh_rows, np.intp).reshape(-1, 2),
                                dtype))

    def qr(self, a, new_leg):
        bb = self.block_backend
        q_blocks, q_rows, r_blocks, r_rows = [], [], [], []
        for k, k_tp, i, j, block in self._matched(a, new_leg):
            m = int(a.codomain.multiplicities[i])
            n_ = int(a.domain.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                q = bb.eye_matrix(m, a.data.dtype)[:, :kdim]
                r = bb.zeros((kdim, n_), a.data.dtype)
            else:
                q, r = bb.matrix_qr(block)
            q_blocks.append(q)
            q_rows.append((i, k_tp))
            r_blocks.append(r)
            r_rows.append((k_tp, j))
        return (BlockSparseData(q_blocks, np.array(q_rows, np.intp).reshape(-1, 2),
                                a.data.dtype),
                BlockSparseData(r_blocks, np.array(r_rows, np.intp).reshape(-1, 2),
                                a.data.dtype))

    def lq(self, a, new_leg):
        bb = self.block_backend
        l_blocks, l_rows, q_blocks, q_rows = [], [], [], []
        for k, k_tp, i, j, block in self._matched(a, new_leg):
            m = int(a.codomain.multiplicities[i])
            n_ = int(a.domain.multiplicities[j])
            kdim = int(new_leg.multiplicities[k])
            if block is None:
                l = bb.zeros((m, kdim), a.data.dtype)
                q = bb.eye_matrix(n_, a.data.dtype)[:kdim, :]
            else:
                l, q = bb.matrix_lq(block)
            l_blocks.append(l)
            l_rows.append((i, k_tp))
            q_blocks.append(q)
            q_rows.append((k_tp, j))
        return (BlockSparseData(l_blocks, np.array(l_rows, np.intp).reshape(-1, 2),
                                a.data.dtype),
                BlockSparseData(q_blocks, np.array(q_rows, np.intp).reshape(-1, 2),
                                a.data.dtype))

    def eigh(self, a, new_leg, sort):
        bb = self.block_backend
        w_blocks, w_rows, v_blocks, v_rows = [], [], [], []
        for k, k_tp, i, j, block in self._matched(a, new_leg):
            m = int(a.codomain.multiplicities[i])
            if block is None:
                w = bb.zeros((m,), a.data.dtype.to_real)
                v = bb.eye_matrix(m, a.data.dtype)
            else:
                w, v = bb.matrix_eigh(block)
                w, v = _sort_eigh(bb, w, v, sort)
            w_blocks.append(w)
            w_rows.append(k)
            v_blocks.append(v)
            v_rows.append((i, k_tp))
        return (DiagonalBlockData(w_blocks, np.array(w_rows, np.intp),
                                  a.data.dtype.to_real),
                BlockSparseData(v_blocks, np.array(v_rows, np.intp).reshape(-1, 2),
                                a.data.dtype))

    # --- diagonal / mask -------------------------------------------------------------------------

    def diagonal_from_sector_block_func(self, func, leg):
        blocks = [func((int(leg.multiplicities[i]),), leg.sector_decomposition[i])
                  for i in range(leg.num_sectors)]
        dtype = self.block_backend.get_dtype(blocks[0]) if blocks else Dtype.float64
        return DiagonalBlockData(blocks, np.arange(leg.num_sectors, dtype=np.intp),
                                 dtype, is_sorted=True)

    def diagonal_from_block(self, block, leg, tol):
        """Reference: cyten/backends/fusion_tree_backend.py:579 (diagonal_from_block).

        Per sector of dim d, mult m the internal dense segment is state-major: index
        ``s * m + mu`` holds ``vals[mu]``; symmetry requires all d states equal.
        """
        if not leg.symmetry.can_be_dropped:
            raise SymmetryError('diagonal_from_block requires can_be_dropped; use '
                                'from_sector_block_func')
        bb = self.block_backend
        vec = np.asarray(bb.to_numpy(bb.as_block(block)))
        dtype = Dtype.from_numpy(vec.dtype)
        if leg._basis_perm is not None:
            vec = vec[leg.basis_perm]
        blocks = []
        for i in range(leg.num_sectors):
            d = leg.symmetry.sector_dim(leg.sector_decomposition[i])
            seg = vec[int(leg.slices[i, 0]):int(leg.slices[i, 1])]
            per_state = seg.reshape(d, -1)  # state-major layout
            if np.max(np.abs(per_state - per_state[:1, :])) > tol * max(
                    1., float(np.max(np.abs(vec)))):
                raise ValueError('Block is not symmetric up to tolerance.')
            blocks.append(bb.as_block(per_state[0], dtype))
        return DiagonalBlockData(blocks, np.arange(leg.num_sectors, dtype=np.intp),
                                 dtype, is_sorted=True)

    def diagonal_to_block(self, a):
        """Reference: cyten/backends/fusion_tree_backend.py:626 (diagonal_tensor_to_block)."""
        leg = a.leg
        if not leg.symmetry.can_be_dropped:
            raise SymmetryError('diagonal_to_block requires can_be_dropped')
        bb = self.block_backend
        res = np.zeros((leg.dim,), a.data.dtype.to_numpy)
        for block, i in zip(a.data.blocks, a.data.block_inds):
            d = leg.symmetry.sector_dim(leg.sector_decomposition[i])
            vals = np.asarray(bb.to_numpy(block))
            # state-major: repeat the mult-vector once per sector state
            res[int(leg.slices[i, 0]):int(leg.slices[i, 1])] = np.tile(vals, d)
        if leg._basis_perm is not None:
            res = res[leg.inverse_basis_perm]
        return bb.as_block(res, a.data.dtype)

    def diagonal_data_from_full_tensor(self, a, check_offdiagonal):
        bb = self.block_backend
        # full-tensor rows index TensorProduct([leg]); DiagonalBlockData rows
        # index the LEG's own order — remap (differs for dual legs)
        leg = a.codomain.factors[0]
        blocks, idcs = [], []
        for b, (i, _) in zip(a.data.blocks, a.data.block_inds):
            c = a.codomain.sector_decomposition[int(i)]
            blocks.append(bb.get_diagonal(b, check_offdiagonal))
            idcs.append(_sector_index(leg, c))
        return DiagonalBlockData(blocks, np.array(idcs, np.intp), a.data.dtype)

    def full_data_from_diagonal_tensor(self, a):
        bb = self.block_backend
        # diagonal data rows index the LEG's sector order; BlockSparseData rows
        # index TensorProduct([leg]) — these differ for dual legs
        tp = TensorProduct([a.leg])
        blocks, rows = [], []
        for b, k in zip(a.data.blocks, a.data.block_inds):
            k_tp = _sector_index(tp, a.leg.sector_decomposition[int(k)])
            blocks.append(bb.block_from_diagonal(b))
            rows.append((k_tp, k_tp))
        bi = np.array(rows, np.intp).reshape((len(blocks), 2))
        return BlockSparseData(blocks, bi, a.data.dtype)

    def diagonal_elementwise_unary(self, a, func, func_kwargs, maps_zero_to_zero):
        from .abelian import AbelianBackend

        return AbelianBackend.diagonal_elementwise_unary(
            self, a, func, func_kwargs, maps_zero_to_zero)

    def diagonal_elementwise_binary(self, a, b, func, func_kwargs,
                                    partial_zero_is_zero):
        from .abelian import AbelianBackend

        return AbelianBackend.diagonal_elementwise_binary(
            self, a, b, func, func_kwargs, partial_zero_is_zero)

    def diagonal_all(self, a):
        from .abelian import AbelianBackend

        return AbelianBackend.diagonal_all(self, a)

    def diagonal_any(self, a):
        from .abelian import AbelianBackend

        return AbelianBackend.diagonal_any(self, a)

    def diagonal_sum_all(self, a):
        # trace weighting: sum over sector values times qdim
        bb = self.block_backend
        leg = a.leg
        res = None
        for b, i in zip(a.data.blocks, a.data.block_inds):
            term = float(leg.sector_qdims[int(i)]) * bb.block_sum_all(b)
            res = term if res is None else bb.add(res, term)
        if res is None:
            return a.data.dtype.zero_scalar
        return bb.block_item(res)

    def diagonal_to_mask(self, a):
        bb = self.block_backend
        leg = a.leg
        blocks, rows, sectors, mults = [], [], [], []
        for b, i in zip(a.data.blocks, a.data.block_inds):
            mask_np = bb.to_numpy(b).astype(bool)
            if not mask_np.any():
                continue
            sectors.append(leg.sector_decomposition[int(i)])
            mults.append(int(mask_np.sum()))
            blocks.append(bb.as_block(mask_np, Dtype.bool))
            rows.append(int(i))
        if sectors and leg.symmetry.can_be_dropped and leg._basis_perm is not None:
            # the small leg must keep the relative *public* basis order of the
            # large leg (reference spaces.py:1371 take_slice contract); assemble
            # the public blockmask (state-major tiling) and slice
            public = np.zeros(int(leg.dim), dtype=bool)
            for b, i in zip(blocks, rows):
                d = leg.symmetry.sector_dim(leg.sector_decomposition[int(i)])
                vals = np.asarray(bb.to_numpy(b)).astype(bool)
                public[int(leg.slices[i, 0]):int(leg.slices[i, 1])] = \
                    np.tile(vals, int(d))
            small_leg = leg.take_slice(public[leg.inverse_basis_perm])
        elif sectors:
            small_leg = ElementarySpace.from_sector_decomposition(
                leg.symmetry, np.array(sectors, int), np.array(mults, int),
                is_dual=leg.is_dual, unique_sectors=True)
            small_leg._basis_perm = None
            small_leg._inverse_basis_perm = None
        else:
            small_leg = ElementarySpace.from_null_space(leg.symmetry, leg.is_dual)
            small_leg._basis_perm = None
            small_leg._inverse_basis_perm = None
        mask_rows = []
        for i, sector in zip(rows, sectors):
            i_small = small_leg.sector_decomposition_where(np.asarray(sector))
            mask_rows.append((i_small, i))
        data = MaskBlockData(blocks,
                             np.array(mask_rows, np.intp).reshape(len(blocks), 2))
        return data, small_leg

    def diagonal_transpose(self, a):
        return a.leg.dual, a.data

    def scale_axis(self, a, diag, leg_idx):
        """Multiply a diagonal acting on one (co)domain factor into the blocks."""
        bb = self.block_backend
        dtype = Dtype.common(a.data.dtype, diag.data.dtype)
        K = a.num_codomain_legs
        in_codomain = leg_idx < K
        side = a.codomain if in_codomain else a.domain
        flat_pos = leg_idx if in_codomain else a.num_legs - 1 - leg_idx
        d_lookup = {int(i): n for n, i in enumerate(diag.data.block_inds)}
        blocks, rows = [], []
        for n, (i, j) in enumerate(a.data.block_inds):
            c = a.codomain.sector_decomposition[i]
            factors = _row_scale_factors(side, c, flat_pos, diag, d_lookup, bb)
            if factors is None:
                continue
            block = bb.to_dtype(a.data.blocks[n], dtype)
            if in_codomain:
                block = block * bb.reshape(factors, (-1, 1))
            else:
                block = block * bb.reshape(factors, (1, -1))
            blocks.append(block)
            rows.append((int(i), int(j)))
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2), dtype)

    def mask_from_block(self, block, large_leg):
        sym = large_leg.symmetry
        if not sym.can_be_dropped:
            raise SymmetryError('mask_from_block requires can_be_dropped; use '
                                'Mask.from_DiagonalTensor')
        bb = self.block_backend
        mask_np = bb.to_numpy(block).astype(bool)
        if large_leg._basis_perm is not None:
            mask_np = mask_np[large_leg.basis_perm]
        blocks = []
        for i in range(large_leg.num_sectors):
            seg = mask_np[int(large_leg.slices[i, 0]):int(large_leg.slices[i, 1])]
            d = int(large_leg.sector_dims[i])
            per_state = seg.reshape(d, -1)  # state-major layout
            assert np.all(per_state == per_state[:1, :]), \
                'mask must keep or drop whole multiplets'
            blocks.append(bb.as_block(per_state[0], Dtype.bool))
        diag = DiagonalBlockData(blocks,
                                 np.arange(large_leg.num_sectors, dtype=np.intp),
                                 Dtype.bool, is_sorted=True)

        class _Shim:
            pass

        shim = _Shim()
        shim.data = diag
        shim.leg = large_leg
        return self.diagonal_to_mask(shim)

    def mask_to_block(self, a):
        """Dense bool mask over the large leg's public basis (state-major tiling).

        Reference: cyten/backends/fusion_tree_backend.py (mask_to_block); requires
        ``can_be_dropped``.
        """
        large_leg = a.large_leg
        if not large_leg.symmetry.can_be_dropped:
            raise SymmetryError('mask_to_block requires can_be_dropped')
        bb = self.block_backend
        res = np.zeros(int(large_leg.dim), dtype=bool)
        for block, (i_small, i_large) in zip(a.data.blocks, a.data.block_inds):
            d = large_leg.symmetry.sector_dim(
                large_leg.sector_decomposition[int(i_large)])
            vals = np.asarray(bb.to_numpy(block)).astype(bool)
            res[int(large_leg.slices[i_large, 0]):int(large_leg.slices[i_large, 1])] \
                = np.tile(vals, d)  # state-major: mult vector repeats per state
        if large_leg._basis_perm is not None:
            res = res[large_leg.inverse_basis_perm]
        return bb.as_block(res, Dtype.bool)

    def mask_to_diagonal(self, a, leg):
        from .abelian import AbelianBackend

        return AbelianBackend.mask_to_diagonal(self, a, leg)

    def mask_dagger(self, a):
        return MaskBlockData(list(a.data.blocks), a.data.block_inds[:, ::-1])

    def mask_binary_operand(self, a, b, func):
        # align per large-leg sector
        bb = self.block_backend
        a_lookup = {int(il): n for n, (i_s, il) in enumerate(a.data.block_inds)}
        b_lookup = {int(il): n for n, (i_s, il) in enumerate(b.data.block_inds)}
        large = a.large_leg
        vals = []
        for i in range(large.num_sectors):
            m = int(large.multiplicities[i])
            # func works on blocks (the tensors layer passes torch.logical_and etc.)
            blk_a = (a.data.blocks[a_lookup[i]] if i in a_lookup
                     else bb.zeros((m,), Dtype.bool))
            blk_b = (b.data.blocks[b_lookup[i]] if i in b_lookup
                     else bb.zeros((m,), Dtype.bool))
            vals.append(bb.to_dtype(func(blk_a, blk_b), Dtype.bool))
        diag = DiagonalBlockData(
            vals,
            np.arange(large.num_sectors, dtype=np.intp), Dtype.bool, is_sorted=True)

        class _Shim:
            data = diag
            leg = large

        return self.diagonal_to_mask(_Shim())

    def mask_unary_operand(self, a, func):
        bb = self.block_backend

        def binary(x, y):
            return func(x)

        return self.mask_binary_operand(a, a, binary)

    def full_data_from_mask(self, a, dtype):
        bb = self.block_backend
        # mask block_inds index the LEGS' sector decompositions; BlockSparseData
        # rows index the codomain/domain TensorProduct decompositions, whose sort
        # order differs for dual legs — remap via the sectors
        cod_leg = a.codomain.factors[0]
        dom_leg = a.domain.factors[0]
        cod_sd = a.codomain.sector_decomposition
        dom_sd = a.domain.sector_decomposition
        blocks, rows = [], []
        for b, (i_c, i_d) in zip(a.data.blocks, a.data.block_inds):
            s_c = cod_leg.sector_decomposition[int(i_c)]
            s_d = dom_leg.sector_decomposition[int(i_d)]
            j_c = int(np.where(np.all(cod_sd == s_c, axis=1))[0][0])
            j_d = int(np.where(np.all(dom_sd == s_d, axis=1))[0][0])
            blocks.append(bb.block_from_mask(b, dtype))
            rows.append((j_c, j_d))
        bi = np.array(rows, np.intp).reshape((len(blocks), 2))
        return BlockSparseData(blocks, bi, dtype)

    def apply_mask_to_DiagonalTensor(self, a, mask):
        from .abelian import AbelianBackend

        return AbelianBackend.apply_mask_to_DiagonalTensor(self, a, mask)

    def apply_mask_to_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        """Only for masks on a lone (co)domain leg of a <=1-per-side tensor, or on
        any flat leg via row/col index masks."""
        bb = self.block_backend
        K = a.num_codomain_legs
        in_codomain = leg_idx < K
        side = a.codomain if in_codomain else a.domain
        new_side = new_codomain if in_codomain else new_domain
        flat_pos = leg_idx if in_codomain else a.num_legs - 1 - leg_idx
        m_lookup = {int(il): n for n, (i_s, il) in enumerate(mask.data.block_inds)}
        blocks, rows = [], []
        for n, (i, j) in enumerate(a.data.block_inds):
            c = a.codomain.sector_decomposition[i]
            row_mask = _row_mask(side, c, flat_pos, mask, m_lookup, bb)
            if row_mask is None or not row_mask.any():
                continue
            block = a.data.blocks[n]
            if in_codomain:
                block = bb.apply_mask(block, bb.as_block(row_mask, Dtype.bool), 0)
                i_new = _sector_index(new_codomain, c)
                j_new = int(j) if new_domain is a.domain else \
                    _sector_index(new_domain, c)
            else:
                block = bb.apply_mask(block, bb.as_block(row_mask, Dtype.bool), 1)
                i_new = int(i) if new_codomain is a.codomain else \
                    _sector_index(new_codomain, c)
                j_new = _sector_index(new_domain, c)
            if i_new is None or j_new is None:
                continue
            blocks.append(block)
            rows.append((i_new, j_new))
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2),
                               a.data.dtype)

    def enlarge_leg_of_Tensor(self, a, mask, leg_idx, new_codomain, new_domain):
        bb = self.block_backend
        K = a.num_codomain_legs
        in_codomain = leg_idx < K
        new_side = new_codomain if in_codomain else new_domain
        flat_pos = leg_idx if in_codomain else a.num_legs - 1 - leg_idx
        m_lookup = {int(il): n for n, (i_s, il) in enumerate(mask.data.block_inds)}
        blocks, rows = [], []
        for n, (i, j) in enumerate(a.data.block_inds):
            c = a.codomain.sector_decomposition[i]
            i_new = _sector_index(new_codomain, c)
            j_new = _sector_index(new_domain, c)
            if i_new is None or j_new is None:
                continue
            # build the row mask of the *new* (enlarged) side; scatter old into it
            row_mask = _row_mask(new_side, c, flat_pos, mask, m_lookup, bb)
            if row_mask is None:
                continue
            block = a.data.blocks[n]
            if in_codomain:
                shape = (len(row_mask), bb.get_shape(block)[1])
                slices = (np.nonzero(row_mask)[0], slice(None))
            else:
                shape = (bb.get_shape(block)[0], len(row_mask))
                slices = (slice(None), np.nonzero(row_mask)[0])
            blocks.append(bb.enlarge_block(block, shape, slices))
            rows.append((i_new, j_new))
        return BlockSparseData(blocks, np.array(rows, np.intp).reshape(-1, 2),
                               a.data.dtype)


@functools.lru_cache(maxsize=4096)
def _compose_pairs(a_inds: bytes, n_a: int, b_inds: bytes, n_b: int):
    """The pair list of :meth:`FusionTreeBackend.compose` from the block indices of
    both operands (``[n, 2]`` intp, as bytes): ``(ia, ib, rows)``, the block of a and
    of b of each pair and the block-index row of its output."""
    a_rows = np.frombuffer(a_inds, np.intp).reshape(n_a, 2)
    b_rows = np.frombuffer(b_inds, np.intp).reshape(n_b, 2)
    a_by_j = {int(j): n for n, (i, j) in enumerate(a_rows)}
    ia, ib, rows = [], [], []
    for m, (k, l) in enumerate(b_rows):
        n = a_by_j.get(int(k))
        if n is None:
            continue
        ia.append(n)
        ib.append(m)
        rows.append((int(a_rows[n, 0]), int(l)))
    return np.array(ia, np.int64), np.array(ib, np.int64), tuple(rows)


def _sector_index(space, sector) -> int | None:
    return space.sector_decomposition_where(np.asarray(sector))


def _trace_tree_factor(tree: FusionTree, idcs: list[int]):
    """(contributes, weight) of a fusion tree under tracing adjacent leg pairs.

    ``idcs[k]`` is the position of the k-th pair's first leg; its partner sits
    at ``idcs[k] + 1`` and must carry the dual sector. In the caterpillar
    canonical form the pair contributes only if it fuses back to the sector
    left of it (left inner edge == right inner edge); the loop closure weight
    is a B symbol, times a Frobenius-Schur sign when the first leg is a dual
    (ket/bra orientation). Behavioral parity with reference
    fusion_tree_backend.py:3612.
    """
    sym = tree.symmetry
    weight = 1.0
    for idx in idcs:
        if not np.all(tree.uncoupled[idx]
                      == sym.dual_sector(tree.uncoupled[idx + 1])):
            return False, 0.0
        if idx == 0:
            left = sym.trivial_sector
        elif idx == 1:
            left = tree.uncoupled[0]
        else:
            left = tree.inner_sectors[idx - 2]
        right = tree.inner_sectors[idx] if idx < tree.num_inner_edges \
            else tree.coupled
        if not np.all(left == right):
            return False, 0.0
        center = tree.uncoupled[0] if idx == 0 else tree.inner_sectors[idx - 1]
        if idx == 0 and not np.all(tree.multiplicities[:2] == 0):
            # fusing back to the trivial sector is multiplicity-free
            return False, 0.0
        mu = 0 if idx == 0 else tree.multiplicities[idx - 1]
        nu = tree.multiplicities[idx]
        weight *= np.conj(sym.b_symbol(left, tree.uncoupled[idx], center)[mu, nu])
        if tree.are_dual[idx]:
            weight *= sym.frobenius_schur(tree.uncoupled[idx])
    return True, weight


def _kron2(bb, subA, subB):
    """kron of two matrices with A-major rows and columns."""
    ra, ca = bb.get_shape(subA)
    rb, cb = bb.get_shape(subB)
    x = bb.tensordot(subA, [], subB, [])  # outer product: [ra, ca, rb, cb]
    x = bb.permute_axes(x, [0, 2, 1, 3])
    return bb.reshape(x, (ra * rb, ca * cb))


def _row_scale_factors(side: TensorProduct, c, flat_pos: int, diag, d_lookup, bb):
    """Per-row factors for multiplying a diagonal into the tree-block layout.

    `flat_pos` indexes the flat legs of `side` (in factor order); the diagonal's
    values for each sector of that leg are broadcast over the row layout.

    The LAYOUT (segment widths, repeat/tile counts) is static metadata, computed on
    the host once per (side, coupled sector, leg) (:func:`_row_scale_layout`); the
    diagonal's VALUES stay on the device throughout, so nothing is read on the host
    (the static-mode DMRG step routes its singular values through here).
    """
    segments = []  # Block | ('z', width) placeholders, in row order
    any_nonzero = False
    for sec_idx, width, inner, reps in _row_scale_layout(
            side, tuple(int(x) for x in np.asarray(c)), flat_pos):
        n = d_lookup.get(sec_idx) if sec_idx is not None else None
        if n is None:
            segments.append(('z', width))
            continue
        seg = diag.data.blocks[n]  # length = multiplicity of that sector
        # rows within a tree block are C-style over mults; the whole pattern
        # repeats once per tree: row = tile(repeat(dvals, inner), outer * n_trees)
        if inner > 1:
            seg = bb.reshape(bb.stack([seg] * inner, axis=1), (-1,))
        if reps > 1:
            seg = bb.reshape(bb.stack([seg] * reps, axis=0), (-1,))
        segments.append(seg)
        any_nonzero = True
    if not any_nonzero:
        return None
    dtype = diag.data.dtype
    parts = [bb.zeros((s[1],), dtype) if isinstance(s, tuple) else s
             for s in segments]
    return bb.concatenate(parts) if len(parts) > 1 else parts[0]


@functools.lru_cache(maxsize=4096)
def _row_scale_layout(side: TensorProduct, c: tuple, flat_pos: int) -> tuple:
    """The segments of :func:`_row_scale_factors`' row layout: ``(sector index of the
    leg at flat_pos or None, width, inner, reps)`` per uncoupled combination that
    fuses to ``c``."""
    flat_legs = side.flat_legs
    sym = side.symmetry
    c = np.asarray(c)
    res = []
    for uncoupled, mults in side.iter_uncoupled():
        n_trees = len(fusion_trees(sym, uncoupled, c, [l.is_dual for l in flat_legs]))
        if n_trees == 0:
            continue
        tree_block = int(np.prod(mults)) if len(mults) else 1
        sec_idx = flat_legs[flat_pos].sector_decomposition_where(uncoupled[flat_pos])
        m = int(mults[flat_pos])
        inner = int(np.prod(mults[flat_pos + 1:])) if flat_pos + 1 <= len(mults) \
            else 1
        outer = tree_block // (m * inner)
        res.append((None if sec_idx is None else int(sec_idx), n_trees * tree_block,
                    inner, outer * n_trees))
    return tuple(res)


def _row_mask(side: TensorProduct, c, flat_pos: int, mask, m_lookup, bb):
    """Boolean row mask selecting kept multiplicity indices of one flat leg."""
    flat_legs = side.flat_legs
    sym = side.symmetry
    total = side.block_size(np.asarray(c))
    res = np.zeros(total, dtype=bool)
    start = 0
    for uncoupled, mults in side.iter_uncoupled():
        n_trees = len(fusion_trees(sym, uncoupled, np.asarray(c),
                                   [l.is_dual for l in flat_legs]))
        if n_trees == 0:
            continue
        tree_block = int(np.prod(mults)) if len(mults) else 1
        width = n_trees * tree_block
        sec_idx = flat_legs[flat_pos].sector_decomposition_where(
            uncoupled[flat_pos])
        n = m_lookup.get(int(sec_idx)) if sec_idx is not None else None
        if n is not None:
            mvals = bb.to_numpy(mask.data.blocks[n]).astype(bool)
            inner = int(np.prod(mults[flat_pos + 1:])) if flat_pos + 1 <= len(mults) \
                else 1
            outer = tree_block // (len(mvals) * inner)
            pattern = np.tile(np.repeat(mvals, inner), outer)
            res[start:start + width] = np.tile(pattern, n_trees)
        start += width
    return res


# --- dense-conversion helpers ---------------------------------------------------------------


def _mult_kron(C, trees, n_row_legs, n_col_legs):
    """Interleave multiplicity axes (C) with sector-dimension axes (trees).

    C axes: [m_1..m_J, n_1..n_M]; trees axes: [d_1..d_J, e_1..e_M].
    Result axes: [(d_1 m_1).., (e_1 n_1)..] — each leg's internal basis is
    *state-major* (sector-state index major, multiplicity minor), matching the
    reference convention and ``ElementarySpace.slices`` layout.
    """
    J, M = n_row_legs, n_col_legs
    res = np.multiply.outer(C, trees)
    # axes: [m1..mJ, n1..nM, d1..dJ, e1..eM] -> [d1,m1, .., e1,n1, ..]
    perm = []
    for k in range(J):
        perm.extend([J + M + k, k])
    for k in range(M):
        perm.extend([J + M + J + k, J + k])
    res = np.transpose(res, perm)
    shape = []
    for k in range(J):
        shape.append(res.shape[2 * k] * res.shape[2 * k + 1])
    for k in range(M):
        shape.append(res.shape[2 * J + 2 * k] * res.shape[2 * J + 2 * k + 1])
    return res.reshape(shape)


def _mult_unkron(sub, trees, row_mults, col_mults):
    """Inverse pairing of :func:`_mult_kron`: project `sub` onto `trees`.

    sub axes: [(d m)_1.., (e n)_1..] (state-major); trees axes: [d.., e..].
    Returns C with axes [m.., n..] = sum over d/e of sub * conj(trees).
    """
    J = len(row_mults)
    M = len(col_mults)
    d_dims = trees.shape[:J]
    e_dims = trees.shape[J:]
    shape = []
    for m, d in zip(row_mults, d_dims):
        shape.extend([int(d), int(m)])
    for n, e in zip(col_mults, e_dims):
        shape.extend([int(e), int(n)])
    x = sub.reshape(shape)
    # move d/e axes (even positions) to the back, mult axes (odd) to the front
    perm = [2 * k + 1 for k in range(J + M)] + [2 * k for k in range(J + M)]
    x = np.transpose(x, perm)
    return np.tensordot(x, np.conj(trees), (tuple(range(J + M, 2 * (J + M))),
                                            tuple(range(J + M))))


def _leg_slices(legs, uncoupled):
    return [slice(int(l.slices[l.sector_decomposition_where(a), 0]),
                  int(l.slices[l.sector_decomposition_where(a), 1]))
            for l, a in zip(legs, uncoupled)]


def _scatter_tree_contribution(res, contrib, cod_legs, dom_legs, Y, X):
    """Add contrib (axes [cod flat.., dom flat (factor order)..]) into the dense
    array (axes [cod flat.., reversed dom flat..])."""
    J = len(cod_legs)
    M = len(dom_legs)
    # reorder domain axes to reversed order
    perm = list(range(J)) + [J + M - 1 - k for k in range(M)]
    contrib = np.transpose(contrib, perm)
    slices = _leg_slices(cod_legs, Y.uncoupled) \
        + list(reversed(_leg_slices(dom_legs, X.uncoupled)))
    res[tuple(slices)] += contrib


def _gather_tree_contribution(arr, cod_legs, dom_legs, Y, X):
    J = len(cod_legs)
    M = len(dom_legs)
    slices = _leg_slices(cod_legs, Y.uncoupled) \
        + list(reversed(_leg_slices(dom_legs, X.uncoupled)))
    sub = arr[tuple(slices)]
    # reorder domain axes from reversed to factor order
    perm = list(range(J)) + [J + M - 1 - k for k in range(M)]
    return np.transpose(sub, perm)
