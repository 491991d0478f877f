"""Abstract tensor backend: the contract between the tensor API and block-sparse storage.

Role-equivalent to reference ``cyten/backends/_backend.py`` (TensorBackend ABC :32-950,
truncation policy :791-909). The backend operates on opaque ``Data`` objects; all
structural decisions (new legs, new (co)domains, leg-index resolution) happen in the
tensors layer and are passed in, so backend methods are pure data transformations.

Notes:

- Backend data objects hold the dense blocks (torch tensors on the backend's device)
  and host-side numpy block indices.
- The truncation policy (:func:`truncation_mask_from_S`) is the one inherently global,
  host-side decision: it reproduces the reference's constraint solver
  (chi_max/chi_min/degeneracy_tol/trunc_cut/svd_min, qdim-weighted errors,
  reference _backend.py:817-909) on numpy singular values gathered from the device.
"""

from __future__ import annotations

from abc import ABCMeta, abstractmethod
from typing import TYPE_CHECKING, Callable, Iterator

import numpy as np

from ..blocks import Block, BlockBackend
from ..dtypes import Dtype
from ..symmetries import ElementarySpace, Leg, Symmetry, TensorProduct

if TYPE_CHECKING:
    from ..tensors import DiagonalTensor, Mask, SymmetricTensor

__all__ = ['Data', 'DiagonalData', 'MaskData', 'TensorBackend', 'conventional_leg_order',
           'truncation_mask_from_S']

Data = object
DiagonalData = object
MaskData = object


def conventional_leg_order(codomain: TensorProduct, domain: TensorProduct
                           ) -> Iterator[Leg]:
    """Factor spaces in ``legs`` order: ``[*codomain, *reversed(domain)]``.

    Note: yields the (co)domain factors themselves, *not* duals — block indices refer to
    these spaces' sector decompositions (reference abelian.py:115-130).
    """
    yield from codomain.factors
    yield from reversed(domain.factors)


class TensorBackend(metaclass=ABCMeta):
    """Abstract backend for symmetric tensors over a given :class:`BlockBackend`."""

    DataCls = object
    can_decompose_tensors = False  #: whether svd/qr/eigh accept multi-leg (co)domains

    def __init__(self, block_backend: BlockBackend):
        self.block_backend = block_backend

    def __repr__(self):
        return f'{type(self).__name__}({self.block_backend.name})'

    def __reduce__(self):
        from .factory import get_backend

        names = {'NoSymmetryBackend': 'no_symmetry', 'AbelianBackend': 'abelian',
                 'FusionTreeBackend': 'fusion_tree'}
        return (get_backend, (None, self.block_backend.name,
                              names[type(self).__name__],
                              str(self.block_backend.device)))

    def test_tensor_sanity(self, a: SymmetricTensor, is_diagonal: bool = False):
        assert isinstance(a.data, self.DataCls)

    def test_mask_sanity(self, a: Mask):
        pass

    @abstractmethod
    def supports_symmetry(self, symmetry: Symmetry) -> bool: ...

    def make_pipe(self, legs: list[Leg], is_dual: bool, pipe: Leg = None) -> Leg:
        """Make a pipe of the appropriate type for :func:`combine_legs`.

        Convention (cf. reference _backend.py:81-91): ``combine_cstyle == not is_dual``.
        """
        from ..symmetries import LegPipe

        if pipe is not None:
            assert pipe.combine_cstyle == (not is_dual)
            assert pipe.is_dual == is_dual
            assert list(pipe.legs) == list(legs)
            return pipe
        return LegPipe(legs, is_dual=is_dual, combine_cstyle=not is_dual)

    @staticmethod
    def effective_cstyle_in_legs_order(pipe, in_codomain: bool) -> bool:
        """Flattening style of a pipe's constituents *in legs order*.

        Codomain pipes list their legs in legs order; domain pipes list them reversed,
        which flips C- vs F-style.
        """
        return pipe.combine_cstyle if in_codomain else not pipe.combine_cstyle

    # --- creation -------------------------------------------------------------------

    @abstractmethod
    def zero_data(self, codomain: TensorProduct, domain: TensorProduct, dtype: Dtype
                  ) -> Data: ...

    @abstractmethod
    def eye_data(self, codomain: TensorProduct, domain: TensorProduct, dtype: Dtype
                 ) -> Data:
        """Identity map from domain to codomain (must be mutually dual)."""
        ...

    @abstractmethod
    def from_dense_block(self, block: Block, codomain: TensorProduct,
                         domain: TensorProduct, tol: float | None) -> Data:
        """Convert a dense block (legs order, public basis) to backend data."""
        ...

    @abstractmethod
    def to_dense_block(self, a: SymmetricTensor) -> Block: ...

    @abstractmethod
    def from_sector_block_func(self, func: Callable, codomain: TensorProduct,
                               domain: TensorProduct) -> Data:
        """Data from ``func(shape, coupled_sector) -> block`` for every allowed block."""
        ...

    def from_random_uniform(self, codomain, domain, dtype: Dtype,
                            rng: np.random.Generator = None) -> Data:
        def func(shape, coupled):
            return self.block_backend.block_random_uniform(shape, dtype, rng=rng)

        return self.from_sector_block_func(func, codomain, domain)

    def from_random_normal(self, codomain, domain, dtype: Dtype, sigma: float = 1.,
                           rng: np.random.Generator = None) -> Data:
        def func(shape, coupled):
            return self.block_backend.block_random_normal(shape, dtype, sigma=sigma,
                                                          rng=rng)

        return self.from_sector_block_func(func, codomain, domain)

    @abstractmethod
    def copy_data(self, a: SymmetricTensor) -> Data: ...

    # --- dtype ------------------------------------------------------------------------

    @abstractmethod
    def get_dtype_from_data(self, a: Data) -> Dtype: ...

    @abstractmethod
    def to_dtype(self, a: SymmetricTensor, dtype: Dtype) -> Data: ...

    # --- elementary tensor ops -------------------------------------------------------

    @abstractmethod
    def compose(self, a: SymmetricTensor, b: SymmetricTensor) -> Data:
        """Contraction ``a ∘ b``, i.e. contract ``a.domain`` with ``b.codomain``."""
        ...

    @abstractmethod
    def permute_legs(self, a: SymmetricTensor, codomain_idcs: list[int],
                     domain_idcs: list[int], levels: list[int] | None,
                     new_codomain: TensorProduct, new_domain: TensorProduct,
                     bend_right: bool | None = None) -> Data | None:
        """Braid/bend legs. idcs refer to ``a.legs`` positions; domain_idcs in new
        domain order (i.e. ``new_domain[k] ~ a.legs[domain_idcs[k]]``).
        `bend_right` picks the side legs bend around (True/False = strictly
        right/left, reference _tensors.py:5524-5536; None = the backend's planar
        default: the shorter rotation). Only matters for non-symmetric braiding.
        Returns None if levels are required but not given."""
        ...

    @abstractmethod
    def combine_legs(self, a: SymmetricTensor, leg_idcs_combine: list[list[int]],
                     pipes: list[Leg], new_codomain: TensorProduct,
                     new_domain: TensorProduct) -> Data:
        """Combine contiguous groups of legs into the given pipes (no leg moves)."""
        ...

    @abstractmethod
    def split_legs(self, a: SymmetricTensor, leg_idcs: list[int],
                   codomain_split: list[int], domain_split: list[int],
                   new_codomain: TensorProduct, new_domain: TensorProduct) -> Data: ...

    @abstractmethod
    def outer(self, a: SymmetricTensor, b: SymmetricTensor,
              new_codomain: TensorProduct, new_domain: TensorProduct) -> Data: ...

    @abstractmethod
    def inner(self, a: SymmetricTensor, b: SymmetricTensor, do_dagger: bool): ...

    @abstractmethod
    def partial_trace(self, a: SymmetricTensor, pairs: list[tuple[int, int]],
                      levels: list[int] | None, new_codomain: TensorProduct,
                      new_domain: TensorProduct) -> tuple[Data, bool]:
        """Trace out the given pairs of legs. Returns (data, is_scalar)."""
        ...

    @abstractmethod
    def dagger(self, a: SymmetricTensor) -> Data: ...

    @abstractmethod
    def mul(self, a, b: SymmetricTensor) -> Data: ...

    @abstractmethod
    def linear_combination(self, a, v: SymmetricTensor, b, w: SymmetricTensor) -> Data: ...

    @abstractmethod
    def norm(self, a: SymmetricTensor) -> float: ...

    def block_weights(self, a: SymmetricTensor | DiagonalTensor) -> tuple | None:
        """The weight of each block of ``a`` in :meth:`norm` and :meth:`inner`; None
        where every block weighs 1."""
        return None

    def leg_sector_map(self, leg: ElementarySpace) -> np.ndarray | None:
        """``map[i]``: the index by which the blocks of a tensor with ``leg`` alone on
        one side (as U and Vh of an SVD hold its new leg) refer to the sector ``i`` of
        ``leg``; None where that index is ``i`` itself."""
        return None

    @abstractmethod
    def item(self, a: SymmetricTensor): ...

    @abstractmethod
    def trace_full(self, a: SymmetricTensor): ...

    @abstractmethod
    def add_trivial_leg(self, a: SymmetricTensor, legs_pos: int, add_to_domain: bool,
                        co_domain_pos: int, new_codomain: TensorProduct,
                        new_domain: TensorProduct) -> Data: ...

    @abstractmethod
    def squeeze_legs(self, a: SymmetricTensor, idcs: list[int],
                     new_codomain: TensorProduct, new_domain: TensorProduct) -> Data: ...

    @abstractmethod
    def get_element(self, a: SymmetricTensor, idcs: list[int]): ...

    @abstractmethod
    def act_block_diagonal_square_matrix(self, a: SymmetricTensor,
                                         block_method: Callable,
                                         dtype_map: Callable | None) -> Data:
        """Apply a matrix function (e.g. expm) per coupled sector of a square tensor."""
        ...

    # --- decompositions ----------------------------------------------------------------

    @abstractmethod
    def svd(self, a: SymmetricTensor, new_leg: ElementarySpace, algorithm: str | None
            ) -> tuple[Data, DiagonalData, Data]:
        """SVD of a 2-leg tensor (1 codomain, 1 domain leg). Returns (U, S, Vh) data."""
        ...

    @abstractmethod
    def qr(self, a: SymmetricTensor, new_leg: ElementarySpace) -> tuple[Data, Data]: ...

    @abstractmethod
    def lq(self, a: SymmetricTensor, new_leg: ElementarySpace) -> tuple[Data, Data]: ...

    @abstractmethod
    def eigh(self, a: SymmetricTensor, new_leg: ElementarySpace, sort: str | None
             ) -> tuple[DiagonalData, Data]:
        """Hermitian eigendecomposition of a square 1-leg-each-side tensor."""
        ...

    # --- diagonal tensors ---------------------------------------------------------------

    @abstractmethod
    def diagonal_from_block(self, block: Block, leg: ElementarySpace, tol: float
                            ) -> DiagonalData:
        """From a 1D dense block in the public basis of `leg`."""
        ...

    @abstractmethod
    def diagonal_to_block(self, a: DiagonalTensor) -> Block: ...

    @abstractmethod
    def diagonal_from_sector_block_func(self, func: Callable, leg: ElementarySpace
                                        ) -> DiagonalData: ...

    @abstractmethod
    def diagonal_data_from_full_tensor(self, a: SymmetricTensor, check_offdiagonal: bool
                                       ) -> DiagonalData: ...

    @abstractmethod
    def full_data_from_diagonal_tensor(self, a: DiagonalTensor) -> Data: ...

    @abstractmethod
    def diagonal_elementwise_unary(self, a: DiagonalTensor, func: Callable,
                                   func_kwargs: dict, maps_zero_to_zero: bool
                                   ) -> DiagonalData: ...

    @abstractmethod
    def diagonal_elementwise_binary(self, a: DiagonalTensor, b: DiagonalTensor,
                                    func: Callable, func_kwargs: dict,
                                    partial_zero_is_zero: bool) -> DiagonalData: ...

    @abstractmethod
    def diagonal_all(self, a: DiagonalTensor) -> bool: ...

    @abstractmethod
    def diagonal_any(self, a: DiagonalTensor) -> bool: ...

    @abstractmethod
    def diagonal_sum_all(self, a: DiagonalTensor): ...

    @abstractmethod
    def diagonal_to_mask(self, a: DiagonalTensor) -> tuple[MaskData, ElementarySpace]:
        """Bool diagonal -> projection Mask data and its small leg."""
        ...

    @abstractmethod
    def diagonal_transpose(self, a: DiagonalTensor) -> tuple[ElementarySpace, DiagonalData]:
        """Returns (new_leg, data) for the transpose (leg -> leg.dual)."""
        ...

    @abstractmethod
    def scale_axis(self, a: SymmetricTensor, diag: DiagonalTensor, leg_idx: int) -> Data:
        """Multiply with a diagonal tensor on the given leg of `a`."""
        ...

    # --- masks --------------------------------------------------------------------------

    @abstractmethod
    def mask_from_block(self, block: Block, large_leg: Leg
                        ) -> tuple[MaskData, ElementarySpace]:
        """From a 1D bool block (public basis of large_leg); returns (data, small_leg)."""
        ...

    @abstractmethod
    def mask_to_block(self, a: Mask) -> Block: ...

    @abstractmethod
    def mask_to_diagonal(self, a: Mask, leg: ElementarySpace) -> DiagonalData: ...

    @abstractmethod
    def mask_dagger(self, a: Mask) -> MaskData: ...

    @abstractmethod
    def mask_binary_operand(self, a: Mask, b: Mask, func: Callable
                            ) -> tuple[MaskData, ElementarySpace]: ...

    @abstractmethod
    def mask_unary_operand(self, a: Mask, func: Callable
                           ) -> tuple[MaskData, ElementarySpace]: ...

    @abstractmethod
    def full_data_from_mask(self, a: Mask, dtype: Dtype) -> Data: ...

    @abstractmethod
    def apply_mask_to_Tensor(self, a: SymmetricTensor, mask: Mask, leg_idx: int,
                             new_codomain: TensorProduct, new_domain: TensorProduct
                             ) -> Data:
        """Apply a projection mask (or its dagger, as appropriate) to one leg of `a`."""
        ...

    @abstractmethod
    def apply_mask_to_DiagonalTensor(self, a: DiagonalTensor, mask: Mask
                                     ) -> DiagonalData: ...

    @abstractmethod
    def enlarge_leg_of_Tensor(self, a: SymmetricTensor, mask: Mask, leg_idx: int,
                              new_codomain: TensorProduct, new_domain: TensorProduct
                              ) -> Data:
        """Embed a leg into a larger leg (inverse of apply_mask; zero-fill)."""
        ...

    # --- device handling ----------------------------------------------------------------

    def move_to_device(self, a: SymmetricTensor, device: str) -> Data:
        """Move all blocks of the data to `device` (reference backends' _data
        device plumbing; see reference tests/python_tests/test_devices.py)."""
        bb = self.block_backend
        data = a.data
        if hasattr(data, 'blocks'):
            data.blocks = [bb.as_device(b, device) for b in data.blocks]
        elif hasattr(data, 'block'):
            data.block = bb.as_device(data.block, device)
        return data

    def get_device_from_data(self, a: Data) -> str:
        bb = self.block_backend
        if hasattr(a, 'blocks'):
            if len(a.blocks) > 0:
                return bb.get_device(a.blocks[0])
        elif hasattr(a, 'block'):
            return bb.get_device(a.block)
        # no blocks to inspect: report the backend's default placement
        return bb.get_device(bb.zeros((1,), a.dtype))


def truncation_mask_from_S(S_sectors: list[np.ndarray], qdims: np.ndarray,
                           chi_max: int | None = None, chi_min: int | None = None,
                           degeneracy_tol: float | None = None,
                           trunc_cut: float | None = None,
                           svd_min: float | None = None,
                           minimize_error: bool = True,
                           pad_to_multiple: int | None = None,
                           ) -> tuple[list[np.ndarray], float, float]:
    """Global truncation decision across sectors, weighted by quantum dimension.

    Reproduces the reference's constraint solver semantics (_backend.py:817-909):
    keep at most `chi_max` and at least `chi_min` multiplets, never split degenerate
    groups (relative gap < `degeneracy_tol`), discard marginal error qdim*S^2 up to
    `trunc_cut` (total), discard S below `svd_min`. Among valid options, keep the most
    (maximal chi) that satisfies all constraints when `minimize_error`.

    Parameters
    ----------
    S_sectors : list of 1D arrays
        Singular values per sector (unsorted OK, non-negative).
    qdims : array
        Quantum dimension of each sector.

    Returns
    -------
    masks : list of bool arrays
        Keep-masks per sector.
    err : float
        Truncation error ``sqrt(sum of discarded qdim * S^2) / norm``.
    new_norm : float
        Norm of the kept singular values (qdim-weighted).
    """
    # flatten: (value, sector_idx, idx_in_sector), sort descending by value
    all_S = np.concatenate([np.asarray(s, dtype=float) for s in S_sectors]) \
        if S_sectors else np.zeros(0)
    sector_idx = np.concatenate([np.full(len(s), i, dtype=int)
                                 for i, s in enumerate(S_sectors)]) \
        if S_sectors else np.zeros(0, int)
    inner_idx = np.concatenate([np.arange(len(s)) for s in S_sectors]) \
        if S_sectors else np.zeros(0, int)
    qd = np.asarray(qdims, dtype=float)[sector_idx] if len(sector_idx) else np.zeros(0)

    # keep-priority: sort by *marginal truncation error* qdim * S^2 (descending).
    # For non-abelian symmetries a multiplet's error contribution is qdim-weighted,
    # so a smaller S in a large sector can outrank a bigger S in a small one —
    # matching the reference's selection (reference _backend.py:849-860).
    marginal = qd * all_S ** 2
    order = np.argsort(-marginal, stable=True)
    S_sorted = all_S[order]
    qd_sorted = qd[order]
    n = len(S_sorted)

    norm_sq = float(np.sum(marginal))
    if norm_sq == 0:
        norm_sq = 1.

    # candidate cuts: keep the first k (in keep-priority order), k in 0..n
    ok = np.ones(n + 1, dtype=bool)  # ok[k]: cutting after k kept values is allowed
    if degeneracy_tol:
        # forbid cuts between nearly degenerate S (gaps in keep-priority order,
        # as in the reference)
        with np.errstate(divide='ignore', invalid='ignore'):
            logS = np.log(np.maximum(S_sorted, 1e-100))
        ok[1:n] &= np.abs(logS[:-1] - logS[1:]) >= degeneracy_tol
    # cumulative discarded weight if keeping k values: sum_{i>=k} qd*S^2
    disc = np.concatenate([np.cumsum((qd_sorted * S_sorted ** 2)[::-1])[::-1], [0.]])

    k_max = n
    if chi_max is not None:
        k_max = min(k_max, int(chi_max))
    if svd_min is not None:
        # the smallest kept value (position k-1 in keep order) must be >= svd_min;
        # since keep-priority is by qdim*S^2, scan for the first violation
        viol = np.nonzero(S_sorted < svd_min)[0]
        if len(viol):
            k_max = min(k_max, int(viol[0]))
    if trunc_cut is not None:
        # smallest k with discarded error <= trunc_cut^2 * norm_sq
        allowed = disc <= trunc_cut ** 2 * norm_sq
        k_needed = int(np.argmax(allowed))  # first True
        k_max_cut = n  # trunc_cut gives a *lower* bound on what must be kept
    else:
        k_needed = 0
    k_min = k_needed
    if chi_min is not None:
        k_min = max(k_min, min(int(chi_min), n))

    # choose k: largest valid k <= k_max if minimize_error, else smallest >= k_min
    candidates = [k for k in range(n + 1) if ok[k]]
    valid = [k for k in candidates if k <= k_max]
    if minimize_error:
        # keep as much as allowed (minimizes error), but respect k_max
        k = max(valid) if valid else 0
        if k < k_min:
            # constraints conflict; prefer keeping k_min if an ok cut exists there
            above = [c for c in candidates if k_min <= c <= n]
            k = min(above) if above else k
    else:
        above = [c for c in candidates if c >= k_min and c <= k_max]
        k = min(above) if above else (max(valid) if valid else 0)

    keep = np.zeros(n, dtype=bool)
    keep[order[:k]] = True
    masks = []
    for i, s in enumerate(S_sectors):
        m = np.zeros(len(s), dtype=bool)
        sel = (sector_idx == i)
        m[inner_idx[sel]] = keep[sel]
        if pad_to_multiple and m.any():
            # chi bucketing: round the kept count per sector UP to a multiple, so
            # that block shapes repeat across truncations (static-mode runs and their
            # CUDA graphs). Extra kept values are the largest of the discarded ones.
            # err and new_norm stay those of the unpadded cut, as in cyten_tpu.
            want = min(-(-int(m.sum()) // pad_to_multiple) * pad_to_multiple, len(s))
            extra = np.argsort(-np.where(m, -np.inf, np.asarray(s, float)))
            m[extra[:want - int(m.sum())]] = True
        masks.append(m)
    err_sq = float(disc[k]) / norm_sq
    new_norm = float(np.sqrt(max(norm_sq - disc[k], 0.)))
    return masks, float(np.sqrt(max(err_sq, 0.))), new_norm
