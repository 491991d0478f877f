"""Two-site DMRG on finite MPS.

The counterpart of ``cyten_tpu/algorithms/dmrg.py``: the environment updates,
``_apply_bond_mixing``, the effective-Hamiltonian matvec, :class:`HEffective`, the
static bond update ``_get_static_bond_fn`` and :class:`DMRGEngine` with ``sweep``,
``update_bond``, static mode, excited states (``orthogonal_to``) and ``run`` with
checkpoints, resume and rollback, on the abelian and the fusion-tree (SU(2)) backends.
Every ``tdot`` and ``compose`` on the abelian backend, and every ``compose`` on the
fusion-tree backend, runs its block products as one grouped-GEMM kernel launch.

Precision is set per operator: ``HEffective(matmul_precision=...)`` (and the engine's
``matmul_precision``) runs the matvec's f32 products at that precision
(:func:`_with_precision`), and ``DMRGEngine(env_dtype=...)`` stores the environments
LP/RP in a narrower dtype (bf16), which the grouped-GEMM kernel reads as they lie.

A bond update runs in one of two modes. The dynamic mode drives a converging Lanczos
solve from the host and truncates with an exact per-sector SVD. Static mode, for a
state whose bond structures have stopped changing, runs a fixed-length fused Lanczos
and an SVD truncated to the frozen per-sector chi allocation (exact, or the
warm-started steady SVD), and reads nothing on the host inside the solve.

Environment conventions:

- ``LPs[i]``: everything left of site i, labels ``['vR', 'wR', 'vR*']``
  (ket bond, MPO bond, bra bond).
- ``RPs[i]``: everything right of site i, labels ``['vL', 'wL', 'vL*']``.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..backends.data import BlockSparseData, DenseData
from ..symmetries import TensorProduct
from ..tensors import (
    DiagonalTensor, Mask, SymmetricTensor, compose, dagger, norm, permute_legs, pinv,
    scalar_multiply, scale_axis, svd, tdot,
)
from ..blocks._kernels import Graph
from ..tensors._functions import _PrefixMask
from ..tensors.krylov_based import (
    _close_structure, _device_norm, _with_blocks, fused_lanczos_impl, lanczos,
)
from ..tensors.steady import steady_truncated_svd
from ..tensors.sparse import LinearOperator, ProjectedLinearOperator
from .mps import SimpleMPS, split_truncate_theta

__all__ = ['HEffective', 'DMRGEngine', 'FaultError', 'PlanarHEffective',
           'PlanarDMRGEngine']


class FaultError(RuntimeError):
    """A sweep produced a non-finite result, and there was no checkpoint to roll
    back to or the result stayed non-finite through ``max_faults`` rollbacks."""


def _with_precision(fn, precision):
    """``fn`` with its f32 block products at ``precision``: ``config.matmul_precision``
    is set around the call and restored after it (None: ``fn`` itself).

    The grouped-GEMM kernel reads the setting when a call is planned: 'float32'
    computes f32 products exactly, 'tensorfloat32' on TF32 tensor cores (operands
    rounded to 10 bits of mantissa, about 1e-3 relative per element), 'default' as
    one bf16 pass (8 bits, about 4e-3), each with f32 sums. It also sets PyTorch's
    own f32 matmul precision for the plain products of the port. DMRG is
    variational, so the energy error is second order in the matvec's error. f64
    and bf16 products ignore the setting.
    """
    if precision is None:
        return fn

    def wrapped(*args, **kwargs):
        from ..config import config

        old = config.matmul_precision
        config.matmul_precision = precision
        try:
            return fn(*args, **kwargs)
        finally:
            config.matmul_precision = old
    return wrapped


def _update_LP_impl(LP, W, A):
    """LP' from LP and the left-isometric site tensor A (planar rearrangements)."""
    t = tdot(A, LP, 'vL', 'vR')               # [p, vR, vR*, wR]
    t = tdot(t, W, ['p', 'wR'], ['p*', 'wL'])  # [vR, vR*, p, wR]
    tp = permute_legs(t, codomain=['vR*', 'p'], domain=['vR', 'wR'])
    return compose(dagger(A), tp)              # [vR*, wR, vR]


def _update_RP_impl(RP, W, B):
    """RP' from RP and the right-isometric site tensor B (planar rearrangements)."""
    t = tdot(B, RP, 'vR', 'vL')                # [vL, p, wL, vL*]
    tp = permute_legs(t, codomain=['p', 'wL'], domain=['vL', 'vL*'])
    t = compose(W, tp)                          # [wL, p, vL*, vL]
    zp = permute_legs(t, codomain=['vL', 'wL'], domain=['vL*', 'p'])
    dB = permute_legs(dagger(B), codomain=['vR*', 'p*'], domain=['vL*'])
    return compose(zp, dB)                      # [vL, wL, vL*]


def _apply_bond_mixing(x1, W1, W2):
    """Apply BOTH MPO tensors to ``x1 = LP . theta`` in a single pass.

    The classic chain runs two sparse GEMM stages (``. W1`` then ``. W2``)
    whose chi^2-sized intermediates each make a full round trip through device
    memory. Here, per (vR*, vR) sector group, all x1 blocks are concatenated
    along one (w, p0, p1) channel axis and hit a single small mixing matrix
    assembled from W1·W2 on the host side of the call: every x1 element is read
    once, every output element written once. The product is a plain
    ``torch.tensordot`` (a large, dense GEMM with a small inner dimension).

    ``x1`` legs ``[vR*, wR, p0, p1, vR]`` (any conventional order — axes are
    resolved by label); returns the tensor the chained
    ``tdot(W2, tdot(W1, x1, ...), ...)`` computes, with legs
    ``[p1, wR, p0, vR*, vR]``. Abelian backends only (index-equality pairing).
    """
    backend = x1.backend
    bb = backend.block_backend
    xp = bb.xp
    ax_i, ax_w, ax_p0, ax_p1, ax_b = x1.get_leg_idcs(
        ['vR*', 'wR', 'p0', 'p1', 'vR'])
    w1_wL, w1_p0, w1_wR, w1_p0c = W1.get_leg_idcs(['wL', 'p0', 'wR', 'p0*'])
    w2_wL, w2_p1, w2_wR, w2_p1c = W2.get_leg_idcs(['wL', 'p1', 'wR', 'p1*'])

    # index W blocks by their contracted legs (index equality — contracted
    # legs are mutually dual spaces with the same defining-sector order)
    W1_by = {}
    for n, r in enumerate(W1.data.block_inds):
        W1_by.setdefault((int(r[w1_p0c]), int(r[w1_wL])), []).append(n)
    W2_by = {}
    for n, r in enumerate(W2.data.block_inds):
        W2_by.setdefault((int(r[w2_p1c]), int(r[w2_wL])), []).append(n)

    def squeeze_w1(n):
        blk = W1.data.blocks[n]
        t = xp.transpose(blk, (w1_wL, w1_p0, w1_wR, w1_p0c))
        return xp.reshape(t, (t.shape[0], t.shape[2]))  # [m_w0, m_w1]

    def squeeze_w2(n):
        blk = W2.data.blocks[n]
        t = xp.transpose(blk, (w2_wL, w2_p1, w2_wR, w2_p1c))
        return xp.reshape(t, (t.shape[0], t.shape[2]))  # [m_w1, m_w2]

    # in-channel (w, p0, p1) -> [(out-channel (w2, p0o, p1o), piece, m_w2)]
    piece_cache: dict = {}

    def pieces_for(in_key):
        if in_key in piece_cache:
            return piece_cache[in_key]
        w, p0, p1 = in_key
        out: dict = {}
        for n1 in W1_by.get((p0, w), ()):
            r1 = W1.data.block_inds[n1]
            p0o, w1 = int(r1[w1_p0]), int(r1[w1_wR])
            A = squeeze_w1(n1)
            for n2 in W2_by.get((p1, w1), ()):
                r2 = W2.data.block_inds[n2]
                p1o, w2 = int(r2[w2_p1]), int(r2[w2_wR])
                piece = bb.tensordot(A, [1], squeeze_w2(n2), [0])  # [m0, m2]
                key = (w2, p0o, p1o)
                out[key] = piece if key not in out else out[key] + piece
        res = sorted(out.items())
        piece_cache[in_key] = res
        return res

    # group x1 blocks by (vR* sector, vR sector)
    groups: dict = {}
    for n, row in enumerate(x1.data.block_inds):
        key = (int(row[ax_i]), int(row[ax_b]))
        groups.setdefault(key, []).append(
            (n, (int(row[ax_w]), int(row[ax_p0]), int(row[ax_p1]))))

    out_blocks = []
    out_rows = []
    res_dtype = x1.data.dtype
    for (i_idx, b_idx), members in sorted(groups.items()):
        members = [(n, k) for n, k in members if pieces_for(k)]
        if not members:
            continue
        # channel layouts
        out_keys = sorted({ok for _, k in members
                           for ok, _ in pieces_for(k)})
        out_sizes = {}
        for _, k in members:
            for ok, piece in pieces_for(k):
                out_sizes[ok] = piece.shape[1]
        C_out = sum(out_sizes[ok] for ok in out_keys)
        col_off = {}
        off = 0
        for ok in out_keys:
            col_off[ok] = off
            off += out_sizes[ok]
        # concatenated input [mi, C_in, mb] and mixing matrix [C_in, C_out]
        Xs = []
        M_rows = []
        for n, k in members:
            blk = x1.data.blocks[n]
            t = xp.transpose(blk, (ax_i, ax_w, ax_p0, ax_p1, ax_b))
            Xs.append(xp.reshape(t, (t.shape[0], t.shape[1], t.shape[4])))
            m_w = Xs[-1].shape[1]
            row_parts = {ok: None for ok in out_keys}
            for ok, piece in pieces_for(k):
                row_parts[ok] = piece
            M_rows.append(xp.concatenate(
                [row_parts[ok] if row_parts[ok] is not None
                 else xp.zeros((m_w, out_sizes[ok]), Xs[-1].dtype)
                 for ok in out_keys], axis=1))
        Xg = Xs[0] if len(Xs) == 1 else xp.concatenate(Xs, axis=1)
        Mg = M_rows[0] if len(M_rows) == 1 else xp.concatenate(M_rows, axis=0)
        Yg = bb.tensordot(Xg, [1], Mg, [0])  # [mi, mb, C_out]
        for ok in out_keys:
            w2, p0o, p1o = ok
            o = col_off[ok]
            sub = Yg[:, :, o:o + out_sizes[ok]]          # [mi, mb, m_w2]
            blk = xp.reshape(xp.transpose(sub, (2, 0, 1)),
                             (1, sub.shape[2], 1, sub.shape[0], sub.shape[1]))
            out_blocks.append(blk)
            out_rows.append([p1o, w2, p0o, i_idx, b_idx])

    codomain = TensorProduct(
        [W2._as_codomain_leg('p1'), W2._as_codomain_leg('wR'),
         W1._as_codomain_leg('p0'), x1._as_codomain_leg('vR*')],
        symmetry=x1.symmetry)
    domain = TensorProduct([x1._as_domain_leg('vR')], symmetry=x1.symmetry)
    data = BlockSparseData(
        out_blocks, np.array(out_rows, dtype=np.intp).reshape((-1, 5)),
        res_dtype, is_sorted=False)
    return SymmetricTensor(data, codomain, domain, backend,
                           ['p1', 'wR', 'p0', 'vR*', 'vR'])


def _heff_matvec_impl(LP, RP, W1, W2, theta):
    """``theta`` under the two-site effective Hamiltonian, in one of three orders, as
    ``cyten_tpu``'s (``algorithms/dmrg.py:237-269``): abelian with bond-channel
    fusion (:func:`_apply_bond_mixing`); abelian or no symmetry in the lhs-small order
    (the small LP/W on the left of each product); otherwise, as on the fusion-tree
    backend, the planar order, whose every step is a cyclic rotation or a bend. The
    lhs-small order moves legs past each other, which is exact only where braiding
    is symmetric."""
    from ..backends.abelian import AbelianBackend
    from ..backends.no_symmetry import NoSymmetryBackend
    from ..config import config

    if isinstance(theta.backend, AbelianBackend) \
            and config.bond_channel_fusion \
            and W1.dtype == W2.dtype == theta.dtype:
        x = tdot(LP, theta, 'vR', 'vL')                  # [vR*, wR, p0, p1, vR]
        x = _apply_bond_mixing(x, W1, W2)                # [p1, wR, p0, vR*, vR]
        x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])      # [p1, p0, vR*, vL*]
        x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
        return permute_legs(x, codomain=['vL', 'p0', 'p1'], domain=['vR'])
    if isinstance(theta.backend, (AbelianBackend, NoSymmetryBackend)):
        x = tdot(LP, theta, 'vR', 'vL')                  # [vR*, wR, p0, p1, vR]
        x = tdot(W1, x, ['p0*', 'wL'], ['p0', 'wR'])     # [p0, wR, vR*, p1, vR]
        x = tdot(W2, x, ['p1*', 'wL'], ['p1', 'wR'])     # [p1, wR, p0, vR*, vR]
        x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])      # [p1, p0, vR*, vL*]
        x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
        return permute_legs(x, codomain=['vL', 'p0', 'p1'], domain=['vR'])
    x = tdot(theta, LP, 'vL', 'vR')                      # [p0, p1, vR, vR*, wR]
    x = tdot(x, W1, ['p0', 'wR'], ['p0*', 'wL'])         # [p1, vR, vR*, p0, wR]
    x = tdot(x, W2, ['p1', 'wR'], ['p1*', 'wL'])         # [vR, vR*, p0, p1, wR]
    x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])          # [vR*, p0, p1, vL*]
    x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
    return permute_legs(x, codomain=['vL', 'p0', 'p1'], domain=['vR'])


class HEffective(LinearOperator):
    """Effective two-site Hamiltonian ``LP -- W1 -- W2 -- RP``.

    ``matmul_precision`` (None | 'float32' | 'tensorfloat32' | 'default') sets the
    precision of the matvec's f32 products (:func:`_with_precision`); None keeps
    ``config.matmul_precision``. ``use_jit`` is accepted for ``cyten_tpu``'s
    signature and has no effect: PyTorch runs eagerly, and static mode captures
    whole bond updates as CUDA graphs instead.
    """

    def __init__(self, LP, RP, W1, W2, use_jit: bool = None, matmul_precision: str = None):
        self.LP = LP
        self.RP = RP
        self.W1 = W1.relabelled({'p': 'p0', 'p*': 'p0*'})
        self.W2 = W2.relabelled({'p': 'p1', 'p*': 'p1*'})
        self.use_jit = use_jit
        self.matmul_precision = matmul_precision
        self._matvec = _with_precision(_heff_matvec_impl, matmul_precision)
        LinearOperator.__init__(self, dtype=W1.dtype)

    def matvec(self, theta):
        return self._matvec(self.LP, self.RP, self.W1, self.W2, theta)


def _freeze_bond(H, theta, kept_leg):
    """The constants of a static bond update: ``(theta_tmpl, mask)``.

    ``theta_tmpl`` is the zero tensor on the block structure of ``theta`` closed under
    ``H.matvec``; ``mask`` is the :class:`Mask` on the SVD's new leg that keeps the
    first ``kept_leg.multiplicities`` values of each sector (none of a sector that
    ``kept_leg`` lacks).
    """
    from ..dtypes import Dtype
    from ..symmetries import ElementarySpace

    closed = _close_structure(H, theta)
    theta_tmpl = scalar_multiply(0., closed)
    thp = permute_legs(closed, codomain=['vL', 'p0'], domain=['vR', 'p1'])
    full = ElementarySpace.from_largest_common_subspace(thp.codomain, thp.domain,
                                                        is_dual=False)
    kept_map = {tuple(int(x) for x in s): int(m) for s, m in
                zip(kept_leg.sector_decomposition, kept_leg.multiplicities)}
    bb = theta.backend.block_backend

    def func(shape, coupled):
        k = kept_map.get(tuple(int(x) for x in np.asarray(coupled)), 0)
        keep = np.zeros(shape[0], dtype=bool)
        keep[:min(k, shape[0])] = True
        return bb.as_block(keep, Dtype.bool)

    diag = DiagonalTensor.from_sector_block_func(func, full, backend=theta.backend)
    return theta_tmpl, Mask.from_DiagonalTensor(diag)


def _get_static_bond_fn(N: int, svd_mode: str = 'exact', steady_opts: dict = None):
    """The whole static-mode bond update as one function.

    ``impl(H, S_i, B_i, B_ip1, theta_tmpl, mask)`` assembles theta, runs ``N``
    iterations of the fused Lanczos, splits theta with an SVD truncated to the frozen
    per-sector chi allocation, restores the B form of site i and updates both
    environments. It returns ``(E, new_B_i, S, B, LP_new, RP_new)`` with E a 0-d
    tensor on the device. With ``svd_mode='steady'`` it reads nothing on the host, so
    on CUDA it can be captured as a graph (:class:`_GraphedStep`); the exact SVD
    (``torch.linalg.svd``) syncs to check its result.

    ``svd_mode='exact'`` takes the per-sector SVD of theta (``torch.linalg.svd``)
    and truncates it with ``mask``, a :class:`_PrefixMask`. ``'steady'`` takes the
    warm-started GEMM/QR steady SVD (``tensors/steady.py``) seeded by the current
    right isometry B_{i+1}, whose leg fixes the allocation; it ignores ``mask``.
    ``steady_opts`` overrides its iteration counts (n_power, n_jacobi, ns_polish).
    """
    if svd_mode not in ('exact', 'steady'):
        raise ValueError(f'unknown svd_mode {svd_mode!r}')
    steady_opts = dict(steady_opts or {})

    def impl(H, S_i, B_i, B_ip1, theta_tmpl, mask):
        # theta0 = S_i B_i B_{i+1}, embedded into the closed block structure
        th = scale_axis(B_i, S_i, 'vL').relabelled({'p': 'p0'})
        th = tdot(th, B_ip1.relabelled({'p': 'p1'}), 'vR', 'vL')
        th = permute_legs(th, codomain=['vL', 'p0', 'p1'], domain=['vR'])
        th = th + theta_tmpl                   # union with the closed structure
        E, theta = fused_lanczos_impl(H, th, N)
        thp = permute_legs(theta, codomain=['vL', 'p0'], domain=['vR', 'p1'])
        if svd_mode == 'steady':
            Vh_prev = permute_legs(B_ip1.relabelled({'p': 'p1'}),
                                   codomain=['vL'], domain=['vR', 'p1'])
            U, S, Vh, _ = steady_truncated_svd(thp, Vh_prev, new_labels=('vR', 'vL'),
                                               **steady_opts)
        else:
            U, S, Vh = svd(thp, new_labels=['vR', 'vL'])
            U, S, Vh = mask.apply(U, S, Vh)
        S = scalar_multiply(1. / _device_norm(S), S)
        A = U.relabelled({'p0': 'p'})
        B = permute_legs(Vh, codomain=['vL', 'p1'], domain=['vR']).relabelled({'p1': 'p'})
        Sinv = pinv(S_i, cutoff=1e-14)
        new_B_i = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        LP_new = _update_LP_impl(H.LP, H.W1.relabelled({'p0': 'p', 'p0*': 'p*'}), A)
        RP_new = _update_RP_impl(H.RP, H.W2.relabelled({'p1': 'p', 'p1*': 'p*'}), B)
        return E, new_B_i, S, B, LP_new, RP_new

    return impl


def _structure(t):
    """Hashable key of everything about ``t`` but its values: type, legs, labels,
    block indices, dtype and block shapes (the pytree structure ``cyten_tpu`` keys
    on, with the shapes its leaves carry). None for None: an environment not built yet."""
    if t is None:
        return None
    legs = (t.leg,) if isinstance(t, DiagonalTensor) else (t.codomain, t.domain)
    inds = None if isinstance(t.data, DenseData) else t.data.block_inds.tobytes()
    return (type(t), *legs, tuple(t.labels), inds, t.data.dtype,
            tuple(tuple(b.shape) for b in _blocks(t)))


def _blocks(t) -> list:
    """The blocks of ``t``: its one block on dense (no-symmetry) data."""
    return [t.data.block] if isinstance(t.data, DenseData) else t.data.blocks


def _slots_like(tensors):
    """Tensors of the structure of ``tensors`` with contiguous blocks of their own."""
    return [_with_blocks(t, [torch.empty_like(b, memory_format=torch.contiguous_format)
                             for b in _blocks(t)]) for t in tensors]


class _GraphedStep:
    """``fn(*inputs)`` captured once as a CUDA graph and replayed.

    ``fn`` takes tensors (block-sparse, fusion-tree or dense) and returns a tuple of
    tensors and 0-d torch tensors. The graph reads its inputs from slots of its own,
    which :meth:`run` fills with one ``_foreach_copy_`` from the tensors it is given
    (of the structures captured; it raises for others). Its outputs are gathered inside the graph into one buffer per
    dtype, and :meth:`run` returns copies of them: an output of the graph lives in its
    pool and is overwritten by its next replay, or by another graph of the pool.
    Capture runs nothing, reads nothing on the host, and raises where ``fn`` would
    sync (``capture_error_mode='global'``).
    """

    def __init__(self, fn, inputs, pool=None):
        t0 = time.perf_counter()
        self.keys = [_structure(t) for t in inputs]
        slots = _slots_like(inputs)
        self.slot_blocks = [b for t in slots for b in _blocks(t)]
        self.graph = Graph(pool)
        with self.graph.capture():
            outs = fn(*slots)
            pieces: dict = {}  # dtype -> flat views of the outputs of that dtype
            for o in outs:
                for b in ([o] if isinstance(o, torch.Tensor) else _blocks(o)):
                    pieces.setdefault(b.dtype, []).append(b.reshape(-1))
            self.flats = {dt: torch.cat(ps) for dt, ps in pieces.items()}
        # what run() rebuilds the outputs from: per output, its shell (a tensor with
        # no blocks) or None for a 0-d torch tensor, and the shapes of its blocks
        self.outputs = [(None, [(o.dtype, o.shape)]) if isinstance(o, torch.Tensor)
                        else (_with_blocks(o, []),
                              [(b.dtype, b.shape) for b in _blocks(o)])
                        for o in outs]
        self.capture_seconds = time.perf_counter() - t0

    def run(self, inputs) -> tuple:
        if [_structure(t) for t in inputs] != self.keys:
            raise ValueError('the inputs differ in structure from those captured')
        torch._foreach_copy_(self.slot_blocks, [b for t in inputs for b in _blocks(t)])
        self.graph.replay()
        flats = {dt: f.clone() for dt, f in self.flats.items()}
        offset = dict.fromkeys(flats, 0)
        res = []
        for shell, blocks in self.outputs:
            views = []
            for dt, shape in blocks:
                n = shape.numel()
                views.append(flats[dt][offset[dt]:offset[dt] + n].view(shape))
                offset[dt] += n
            res.append(views[0] if shell is None else _with_blocks(shell, views))
        return tuple(res)


class DMRGEngine:
    """Two-site DMRG sweeps with a Lanczos ground-state search per bond.

    A bond update is dynamic (host-driven Lanczos, exact SVD truncated by ``chi_max``
    and ``eps``) until static mode is on: :meth:`enable_static_mode` freezes the
    bond structures, or ``auto_static`` turns it on in :meth:`run` once they stop
    changing between two sweeps (``True`` for the steady SVD, ``'exact'`` for the
    exact one).

    ``pad_chi_multiple`` rounds the kept multiplicity of each sector up to a multiple
    of it (chi bucketing), so that the bond structures repeat along the chain
    (:meth:`_static_runs`) and, on the card, bonds of one structure replay one graph.

    The parameters are ``cyten_tpu``'s, in its order:

    - ``jit_env_updates`` is accepted and stored; it has no job under PyTorch, which
      runs the environment updates eagerly (static mode captures them in its graphs).
    - ``matmul_precision`` (None | 'float32' | 'tensorfloat32' | 'default'): the
      precision of the f32 products of the Lanczos matvec, dynamic and static
      (:class:`HEffective`); None keeps ``config.matmul_precision``.
    - ``orthogonal_to``: a list of :class:`SimpleMPS` to orthogonalize against
      (excited states). Each bond problem is solved in the subspace orthogonal to
      these states, projected onto psi's bond bases through the overlap environments
      ``OLs``/``ORs`` (:meth:`_ortho_theta`), by a :class:`ProjectedLinearOperator`
      around the effective Hamiltonian. Dynamic mode only: static mode refuses it.
    - ``env_dtype`` (e.g. ``Dtype.bfloat16``): the storage dtype of the environments
      LP/RP, cast after every update, dynamic and static. theta and the Lanczos
      vectors stay in the working dtype; the grouped-GEMM kernel reads the bf16
      environments as they lie.
    - ``dynamic_svd``: the SVD of a dynamic bond update, 'exact' (per-sector
      ``torch.linalg.svd``), 'adaptive' (warm-started from the bond's current B,
      ``tensors/adaptive.py``) or 'randomized' (``tensors/randomized.py``); see
      :func:`~cyten_tpu_torch.algorithms.mps.split_truncate_theta`.

    :meth:`run` takes checkpoints (``tools/checkpoint.py``), resumes from them and
    rolls a non-finite sweep back to the last one.

    ``mesh`` (and with it ``shard_axis_name``) is not ported yet and raises
    ``NotImplementedError``; so does a model or MPS with ``bc='infinite'``, which
    :class:`~cyten_tpu_torch.algorithms.idmrg.iDMRGEngine` takes (``cyten_tpu``'s
    finite engine runs such a model from the boundary environments of its bulk
    tensors and returns an energy of no meaning). A window of an infinite chain
    between given environments is made by :meth:`_window` alone.
    """

    _sweeps_done = 0  # completed sweeps across run() calls (the checkpoint steps)

    def __init__(self, psi: SimpleMPS, model, chi_max: int = 32, eps: float = 1e-12,
                 lanczos_options: dict = None, pad_chi_multiple: int = None,
                 jit_env_updates: bool = None, mesh=None, shard_axis_name: str = 'mult',
                 matmul_precision: str = None, orthogonal_to=None,
                 auto_static: bool | str = False, env_dtype=None,
                 dynamic_svd: str = 'exact'):
        if mesh is not None:
            raise NotImplementedError('DMRGEngine(mesh=...) is not ported yet')
        if dynamic_svd not in ('exact', 'adaptive', 'randomized'):
            raise ValueError(f'unknown dynamic_svd {dynamic_svd!r}')
        if 'infinite' in (getattr(model, 'bc', 'finite'), psi.bc):
            raise NotImplementedError('DMRGEngine of an infinite chain (bc="infinite"): '
                                      'use iDMRGEngine or MultiCellIDMRGEngine')
        self._set_options(psi, model, chi_max, eps, lanczos_options, pad_chi_multiple,
                          jit_env_updates, shard_axis_name, matmul_precision,
                          orthogonal_to, auto_static, env_dtype, dynamic_svd)
        self._init_environments()
        self._init_overlap_environments()

    @classmethod
    def _window(cls, psi: SimpleMPS, H_mpo, LP, RP, chi_max: int, eps: float,
                lanczos_options: dict, pad_chi_multiple: int = None,
                matmul_precision: str = None):
        """An engine on the finite window ``psi`` between the boundary environments
        ``LP`` (left of site 0) and ``RP`` (right of site L-1), with the MPO tensors
        ``H_mpo``: the inner engine of
        :class:`~cyten_tpu_torch.algorithms.idmrg.MultiCellIDMRGEngine`, whose window
        is a piece of an infinite chain. It has every option of a new engine at its
        default (no static mode, no excited states) and is the only engine whose
        tensors may come from an infinite chain."""
        eng = cls.__new__(cls)
        eng._set_options(psi, SimpleNamespace(H_mpo=list(H_mpo)), chi_max, eps,
                         lanczos_options, pad_chi_multiple, None, 'mult', matmul_precision,
                         None, False, None, 'exact')
        L = psi.L
        eng.LPs[0] = LP
        eng.RPs[L - 1] = RP
        for i in range(L - 1, 0, -1):
            eng.update_RP(i)
        return eng

    @classmethod
    def _environments(cls, psi: SimpleMPS, model):
        """An engine that holds the environments ``LPs``/``RPs`` of the finite ``psi``
        under ``model.H_mpo`` and updates them (``update_LP``/``update_RP``): the
        environment machinery of the TDVP engines, which sweep with it but take no
        DMRG step. Every option at its default, set through :meth:`_set_options`; the
        right environments are built (:meth:`_init_environments`)."""
        eng = cls.__new__(cls)
        eng._set_options(psi, model, 32, 1e-12, None, None, False, 'mult', None, None,
                         False, None, 'exact')
        eng._init_environments()
        return eng

    def _set_options(self, psi, model, chi_max, eps, lanczos_options, pad_chi_multiple,
                     jit_env_updates, shard_axis_name, matmul_precision, orthogonal_to,
                     auto_static, env_dtype, dynamic_svd):
        """Every attribute of a new engine but its environments, which are empty."""
        self.psi = psi
        self.model = model
        self.chi_max = chi_max
        self.eps = eps
        self.pad_chi_multiple = pad_chi_multiple
        self.jit_env_updates = jit_env_updates
        self.shard_axis_name = shard_axis_name
        self.matmul_precision = matmul_precision
        self.orthogonal_to = list(orthogonal_to or [])
        self.env_dtype = env_dtype
        self.dynamic_svd = dynamic_svd
        self.lanczos_options = lanczos_options or {'N_max': 20, 'P_tol': 1e-14}
        #: switch to static mode in run() once the bond structures stop changing
        self.auto_static = auto_static
        self.static_mode = False
        self.backend = psi.backend
        L = psi.L
        self.LPs = [None] * L
        self.RPs = [None] * L
        self.OLs = [[None] * L for _ in self.orthogonal_to]
        self.ORs = [[None] * L for _ in self.orthogonal_to]
        self.E = None
        self.trunc_err = 0.

    def _init_environments(self):
        psi, model = self.psi, self.model
        L = psi.L
        backend = self.backend

        def ones_func(shape, coupled):
            return backend.block_backend.ones(shape, psi.Bs[0].dtype)

        # initial LP: codomain [V0] ('vR*'), domain [V0, w0] -> legs [vR*, wR, vR]
        V0 = psi.Bs[0].get_leg_co_domain('vL')
        w0 = model.H_mpo[0].get_leg_co_domain('wL')
        LP = SymmetricTensor.from_sector_block_func(
            ones_func, [V0], [V0, w0], backend=backend,
            labels=[['vR*'], ['vR', 'wR']])
        self.LPs[0] = LP
        # initial RP: codomain [VR, w] (['vL', 'wL']), domain [VR] ('vL*')
        VR = psi.Bs[-1].domain.factors[0]
        wR = model.H_mpo[-1].get_leg_co_domain('wR')
        RP = SymmetricTensor.from_sector_block_func(
            ones_func, [VR, wR], [VR], backend=backend,
            labels=[['vL', 'wL'], ['vL*']])
        self.RPs[L - 1] = RP
        for i in range(L - 1, 0, -1):
            self.update_RP(i)

    # --- overlap environments for excited-state orthogonalization ------------------

    def _init_overlap_environments(self):
        if not self.orthogonal_to:
            return
        psi = self.psi
        L = psi.L
        bb = self.backend.block_backend
        dtype = psi.Bs[0].dtype

        def ones_func(shape, coupled):
            return bb.ones(shape, dtype)

        for k, phi in enumerate(self.orthogonal_to):
            V_psi = psi.Bs[0].get_leg_co_domain('vL')
            V_phi = phi.Bs[0].get_leg_co_domain('vL')
            self.OLs[k][0] = SymmetricTensor.from_sector_block_func(
                ones_func, [V_psi], [V_phi], backend=self.backend,
                labels=[['vR*'], ['vR']])
            Vr_psi = psi.Bs[-1].domain.factors[0]
            Vr_phi = phi.Bs[-1].domain.factors[0]
            self.ORs[k][L - 1] = SymmetricTensor.from_sector_block_func(
                ones_func, [Vr_phi], [Vr_psi], backend=self.backend,
                labels=[['vL'], ['vL*']])
            for i in range(L - 1, 0, -1):
                self.update_OR(k, i)

    def _phi_tensor(self, k: int, i: int):
        """phi's site tensor in the theta-product gauge (theta1 at site 0)."""
        phi = self.orthogonal_to[k]
        return phi.get_theta1(0) if i == 0 else phi.Bs[i]

    def update_OL(self, k: int, i: int, A):
        """OLs[k][i+1] from OLs[k][i], psi's new left isometry A, phi's tensor."""
        t = tdot(self.OLs[k][i], self._phi_tensor(k, i), 'vR', 'vL')
        self.OLs[k][i + 1] = tdot(dagger(A), t, ['vL*', 'p*'], ['vR*', 'p'])

    def update_OR(self, k: int, i: int, B=None):
        """ORs[k][i-1] from ORs[k][i], psi's B at site i, phi's tensor."""
        if B is None:
            B = self.psi.Bs[i]
        t = tdot(self._phi_tensor(k, i), self.ORs[k][i], 'vR', 'vL')
        self.ORs[k][i - 1] = tdot(t, dagger(B), ['p', 'vL*'], ['p*', 'vR*'])

    def _ortho_theta(self, k: int, i: int):
        """phi's two-site wavefunction at bond (i, i+1), expressed in psi's
        current left/right bond bases: OL . phi_i . phi_{i+1} . OR."""
        phi = self.orthogonal_to[k]
        c = tdot(self.OLs[k][i], self._phi_tensor(k, i).relabelled({'p': 'p0'}),
                 'vR', 'vL')
        c = tdot(c, phi.Bs[i + 1].relabelled({'p': 'p1'}), 'vR', 'vL')
        c = tdot(c, self.ORs[k][i + 1], 'vR', 'vL')
        c = c.relabelled({'vR*': 'vL', 'vL*': 'vR'})
        return permute_legs(c, codomain=['vL', 'p0', 'p1'], domain=['vR'])

    def _env(self, t):
        """An environment in the storage dtype ``env_dtype`` (where one is set)."""
        return t if self.env_dtype is None else t.to_dtype(self.env_dtype)

    def update_LP(self, i: int, A):
        """LPs[i+1] from LPs[i] and the left-isometric tensor A at site i."""
        self.LPs[i + 1] = self._env(_update_LP_impl(self.LPs[i], self.model.H_mpo[i], A))

    def update_RP(self, i: int, B=None):
        """RPs[i-1] from RPs[i] and the right-isometric tensor B at site i."""
        if B is None:
            B = self.psi.Bs[i]
        self.RPs[i - 1] = self._env(_update_RP_impl(self.RPs[i], self.model.H_mpo[i], B))

    def sweep(self) -> float:
        """One sweep, bonds 0..L-2 then back; returns the energy. In static mode the
        bonds go through :meth:`_static_step` and E is read on the host once, at the
        end of the sweep."""
        L = self.psi.L
        bonds = [*range(L - 1), *range(L - 2, -1, -1)]
        if not self.static_mode:
            for i in bonds:
                self.update_bond(i)
            return self.E
        for i in bonds:
            E = self._static_step(i)
        self.E = float(E)
        return self.E

    def sweep_static_batched(self) -> float:
        """A static sweep (:meth:`sweep`), under the name of ``cyten_tpu``'s
        batched sweep, which scans runs of repeating bond structures
        (:meth:`_static_runs`). Here every bond is already one graph replay, keyed by
        its structure, so a run needs nothing of its own. Requires static mode."""
        if not self.static_mode:
            raise RuntimeError('sweep_static_batched needs static mode')
        return self.sweep()

    # --- static mode ---------------------------------------------------------------------

    def enable_static_mode(self, n_lanczos: int = 20, svd_mode: str = 'exact',
                           max_period: int = 2, steady_svd_options: dict = None, *,
                           cuda_graphs: bool = True):
        """Freeze the current bond structures: from now on every bond update runs
        ``n_lanczos`` iterations of the fused Lanczos and truncates to the per-sector
        chi allocation each bond has now, with no host sync inside the update.

        Call it once the state has structurally converged. ``svd_mode='steady'``
        swaps the per-sector exact SVD for the warm-started GEMM/QR steady SVD
        (``tensors/steady.py``); ``steady_svd_options`` sets its iteration counts
        (n_power, n_jacobi, ns_polish). ``max_period`` is the longest period of
        repeating bond structures that :meth:`_static_runs` looks for.

        On CUDA with ``svd_mode='steady'`` a bond update is a CUDA graph, captured
        once per bond structure (:meth:`_bond_structure`), ``matmul_precision`` and
        ``env_dtype`` at the second static update of a bond of that structure (the
        first runs eagerly and warms up the layouts and libraries) and replayed from
        then on, whatever bond has that structure: a change of either setting
        captures anew. ``svd_mode='exact'`` stays eager: ``torch.linalg.svd`` syncs.
        ``cuda_graphs=False`` runs every update eagerly, to compare the two.

        An engine with ``orthogonal_to`` has no static mode.
        """
        assert not self.orthogonal_to, 'static mode: no excited-state search'
        if svd_mode not in ('exact', 'steady'):
            raise ValueError(f'unknown svd_mode {svd_mode!r}')
        self.static_mode = True
        self._static_n_lanczos = n_lanczos
        self._static_svd_mode = svd_mode
        self._static_max_period = max_period
        self._static_steady_opts = steady_svd_options
        self._static_cache = {}
        on_card = torch.device(self.backend.block_backend.device).type == 'cuda'
        #: the graphs' shared memory pool (None: bond updates run eagerly)
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if on_card and svd_mode == 'steady' and cuda_graphs else None)

    def _static_consts(self, i: int):
        """``(theta_tmpl, mask)`` of bond i (:func:`_freeze_bond`), made at its first
        static update and kept: the mask, a :class:`_PrefixMask`, keeps the
        multiplicities ``Ss[i+1]`` has then."""
        entry = self._static_cache.get(('consts', i))
        if entry is not None:
            return entry
        Heff = HEffective(self.LPs[i], self.RPs[i + 1], self.model.H_mpo[i],
                          self.model.H_mpo[i + 1])
        theta_tmpl, mask = _freeze_bond(Heff, self.psi.get_theta2(i),
                                        self.psi.Ss[i + 1].leg)
        entry = self._static_cache[('consts', i)] = (theta_tmpl, _PrefixMask(mask))
        return entry

    def _settings(self) -> tuple:
        """What a static update computes at besides its inputs: ``(matmul_precision,
        env_dtype)``, a part of the keys of its cached functions and graphs."""
        return self.matmul_precision, self.env_dtype

    def _static_entry(self, i: int):
        """The static update of bond i, ``fn(LP, RP, S_i, B_i, B_ip1, W_i, W_ip1)``,
        at the current :meth:`_settings` (cached by both): the matvec at
        ``matmul_precision``, the new LP and RP cast to ``env_dtype``."""
        key = (i, *self._settings())
        entry = self._static_cache.get(key)
        if entry is not None:
            return entry
        theta_tmpl, mask = self._static_consts(i)
        impl = _get_static_bond_fn(self._static_n_lanczos, self._static_svd_mode,
                                   self._static_steady_opts)
        precision, env_dtype = self._settings()

        def fn(LP, RP, S_i, B_i, B_ip1, W_i, W_ip1):
            H = HEffective(LP, RP, W_i, W_ip1, matmul_precision=precision)
            E, new_B, S, B, LP_new, RP_new = impl(H, S_i, B_i, B_ip1, theta_tmpl, mask)
            if env_dtype is not None:
                LP_new, RP_new = LP_new.to_dtype(env_dtype), RP_new.to_dtype(env_dtype)
            return E, new_B, S, B, LP_new, RP_new

        entry = self._static_cache[key] = fn
        return entry

    def _bond_args(self, i: int) -> tuple:
        """The inputs of bond i's static update."""
        psi = self.psi
        return (self.LPs[i], self.RPs[i + 1], psi.Ss[i], psi.Bs[i], psi.Bs[i + 1],
                self.model.H_mpo[i], self.model.H_mpo[i + 1])

    def _bond_structure(self, i: int):
        """Hashable structure key of bond i's static update inputs."""
        return tuple(_structure(t) for t in self._bond_args(i))

    def _static_step(self, i: int):
        """Bond i's static update, written back into the state; returns E as a 0-d
        tensor on the device (nothing is read on the host).

        With graphs on (:meth:`enable_static_mode`), the update of a structure seen
        before replays that structure's graph, capturing it first where it has none;
        the first update of a structure runs eagerly. A failed capture raises."""
        args = self._bond_args(i)
        graph = None
        if self._graph_pool is not None:
            key = (self._bond_structure(i), *self._settings())
            graph = self._static_cache.get(('graph', key))
            if graph is None and ('warm', key) in self._static_cache:
                graph = self._static_cache[('graph', key)] = _GraphedStep(
                    self._static_entry(i), args, self._graph_pool)
            self._static_cache[('warm', key)] = True
        outs = self._static_entry(i)(*args) if graph is None else graph.run(args)
        E, new_B, S, B, LP_new, RP_new = outs
        psi = self.psi
        psi.Bs[i] = new_B
        psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
        psi.Bs[i + 1] = B
        self.LPs[i + 1] = LP_new
        self.RPs[i] = RP_new
        return E

    def _update_bond_static(self, i: int):
        self.E = float(self._static_step(i))

    def _drop_static(self):
        """Static mode off, its functions, frozen constants and CUDA graphs dropped,
        and the graphs' memory given back to the card: a later static mode captures
        anew on the structures it finds then, in a pool of its own."""
        self.static_mode = False
        self._static_cache = {}
        if getattr(self, '_graph_pool', None) is not None:
            self._graph_pool = None
            gc.collect()
            torch.cuda.empty_cache()

    def static_graphs(self) -> list:
        """The CUDA graphs static mode has captured (:class:`_GraphedStep`)."""
        return [v for k, v in getattr(self, '_static_cache', {}).items()
                if isinstance(k, tuple) and k[0] == 'graph']

    def _static_runs(self, max_period: int = None):
        """Maximal runs of consecutive bonds whose structures repeat with period
        ``p <= max_period``; returns ``[(b0, b1, p)]`` with ``b1 - b0`` a multiple of
        p. The algorithm of ``cyten_tpu``'s ``DMRGEngine._static_runs``, which scans
        each run as one compiled program: p=1 is the uniform case, p=2 the
        alternating charge classes of U(1)-Sz or SU(2) chains; ties prefer the
        smaller period. ``max_period`` defaults to that of
        :meth:`enable_static_mode` (2 before it is called). Here it only reports how
        far the structures repeat: the graphs are keyed by structure, bond by bond."""
        if max_period is None:
            max_period = getattr(self, '_static_max_period', 2)
        L = self.psi.L
        structs = [self._bond_structure(i) for i in range(L - 1)]
        runs = []
        i = 0
        while i < L - 1:
            best_j, best_p = i + 1, 1
            for p in range(1, max_period + 1):
                if i + p > L - 1:
                    break
                j = i + p  # first full period
                while j < L - 1 and structs[j] == structs[j - p]:
                    j += 1
                j = i + ((j - i) // p) * p  # whole periods only
                if j > best_j:
                    best_j, best_p = j, p
            runs.append((i, best_j, best_p))  # bonds [i, best_j)
            i = best_j
        return runs

    def update_bond(self, i: int):
        if self.static_mode:
            return self._update_bond_static(i)
        psi = self.psi
        Heff = HEffective(self.LPs[i], self.RPs[i + 1], self.model.H_mpo[i],
                          self.model.H_mpo[i + 1], matmul_precision=self.matmul_precision)
        theta0 = psi.get_theta2(i)
        if self.orthogonal_to:
            vecs = [self._ortho_theta(k, i) for k in range(len(self.orthogonal_to))]
            vecs = [v for v in vecs if norm(v) > 1e-12]
            if vecs:
                Heff = ProjectedLinearOperator(Heff, vecs)
                theta0 = Heff.project(theta0)
        E, theta, n_iter = lanczos(Heff, theta0, self.lanczos_options)
        self.E = E
        adaptive = self.dynamic_svd == 'adaptive'
        A, S, B, err = split_truncate_theta(theta, self.chi_max, self.eps,
                                            pad_to_multiple=self.pad_chi_multiple,
                                            method=self.dynamic_svd,
                                            Vh_prev=psi.Bs[i + 1] if adaptive else None)
        self.trunc_err = max(self.trunc_err, err)
        # restore B form on site i: B_i = S_i^{-1} A S_new
        Sinv = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
        psi.Bs[i + 1] = B
        self.update_LP(i, A)
        self.update_RP(i + 1, B)
        for k in range(len(self.orthogonal_to)):
            self.update_OL(k, i, A)
            self.update_OR(k, i + 1, B)

    def _bond_signature(self):
        """Hashable snapshot of every bond structure (for auto_static)."""
        return tuple(
            (tuple(map(tuple, B.get_leg_co_domain('vL').sector_decomposition.tolist())),
             tuple(int(m) for m in B.get_leg_co_domain('vL').multiplicities))
            for B in self.psi.Bs)

    def _checkpoint_manager(self, checkpoint):
        """Normalize run()'s ``checkpoint`` argument to a CheckpointManager."""
        if checkpoint is None:
            return None
        if isinstance(checkpoint, str):
            from ..tools.checkpoint import CheckpointManager
            return CheckpointManager(checkpoint)
        return checkpoint

    def _restore_from(self, mgr, step, verbose=False, rollback=False):
        """Restore psi (and the counters) from a checkpoint onto the engine's device
        and rebuild the derived state (environments, overlap environments). Static
        mode is dropped with its graphs (:meth:`_drop_static`), so that no graph
        captured on the tensors of before replays, and ``auto_static`` turns it on
        again on the restored structures."""
        payload = mgr.restore(step, device=self.backend.block_backend.device)
        self._drop_static()
        self.psi = payload['psi']
        self.E = payload.get('E')
        self.trunc_err = payload.get('trunc_err', 0.)
        self._sweeps_done = int(payload.get('sweep', step))
        L = self.psi.L
        self.LPs = [None] * L
        self.RPs = [None] * L
        self._init_environments()
        self.OLs = [[None] * L for _ in self.orthogonal_to]
        self.ORs = [[None] * L for _ in self.orthogonal_to]
        self._init_overlap_environments()
        if verbose:
            print(('rollback to' if rollback else 'resumed from')
                  + f' checkpoint step {step} (E = {self.E})')

    def run(self, n_sweeps: int = 10, tol: float = 1e-10, verbose: bool = False,
            checkpoint=None, checkpoint_every: int = 1, resume: bool = True,
            max_faults: int = 2) -> float:
        """Sweep until the energy changes by less than ``tol`` (at most ``n_sweeps``),
        optionally with fault tolerance.

        With ``checkpoint`` (a :class:`~cyten_tpu_torch.tools.checkpoint.
        CheckpointManager` or a directory path) the engine is restartable and heals
        itself, as ``cyten_tpu``'s:

        - every ``checkpoint_every`` completed sweeps, ``{psi, E, sweep, trunc_err}``
          is saved (rolling, ``max_to_keep`` per the manager); environments are
          derived state and are rebuilt on restore, not stored;
        - on entry with ``resume=True``, a fresh engine restores the latest
          checkpoint in the directory (crash recovery across processes);
        - a sweep whose energy is not finite, or that fails in a factorization (a
          NaN block makes eigh or the SVD raise before an energy returns), rolls
          back to the last checkpoint. The first rollback also drops ``env_dtype``,
          before the environments are rebuilt, so that they and every later update
          are in the working dtype. Faults are counted over the whole run; after
          ``max_faults`` rollbacks, or with no checkpoint to roll back to,
          :class:`FaultError` is raised.

        With ``auto_static`` (and no ``orthogonal_to``), static mode is turned on
        after the first sweep that leaves every bond structure as the sweep before it
        did. In static mode a sweep reads E on the host once (:meth:`sweep`), so a
        poisoned sweep through graphs is caught at its end.
        """
        mgr = self._checkpoint_manager(checkpoint)
        if mgr is not None and resume and self._sweeps_done == 0:
            step = mgr.latest_step()
            if step is not None:
                self._restore_from(mgr, step, verbose)
        faults = 0
        E_old = np.inf
        sig_old = None
        for sweep in range(n_sweeps):
            fault_exc = None
            try:
                E = self.sweep()
            except (np.linalg.LinAlgError, torch.linalg.LinAlgError,
                    FloatingPointError) as exc:
                # a hard numerical failure (NaN blocks crash eigh/svd before a
                # non-finite energy ever returns) counts as a non-finite sweep
                fault_exc = exc
                E = np.nan
            if not np.isfinite(E):
                faults += 1
                latest = None if mgr is None else mgr.latest_step()
                if latest is None or faults > max_faults:
                    raise FaultError(
                        f'non-finite result after sweep ({fault_exc or E}); '
                        'no checkpoint to roll back to' if latest is None else
                        f'non-finite result persisted through {max_faults} '
                        'rollbacks') from fault_exc
                if self.env_dtype is not None:
                    if verbose:
                        print('rollback: escalating precision (env_dtype -> None)')
                    self.env_dtype = None
                self._restore_from(mgr, latest, verbose, rollback=True)
                E_old = np.inf
                sig_old = None
                continue
            self._sweeps_done += 1
            if mgr is not None and self._sweeps_done % checkpoint_every == 0:
                mgr.save(self._sweeps_done,
                         {'psi': self.psi, 'E': float(E), 'sweep': self._sweeps_done,
                          'trunc_err': float(self.trunc_err)})
            if verbose:
                print(f'sweep {sweep + 1}: E = {E:.12f}, '
                      f'max chi = {self.psi.max_chi()}')
            if self.auto_static and not self.static_mode and not self.orthogonal_to:
                sig = self._bond_signature()
                if sig == sig_old:
                    mode = self.auto_static if isinstance(self.auto_static, str) \
                        else 'steady'
                    self.enable_static_mode(
                        n_lanczos=self.lanczos_options.get('N_max', 20), svd_mode=mode)
                    if verbose:
                        print(f'sweep {sweep + 1}: structures saturated -> '
                              f'static mode (svd_mode={mode})')
                sig_old = sig
            if abs(E - E_old) < tol:
                break
            E_old = E
        return self.E


# The engine uses planar rearrangements only (rotations and bends), so it doubles as
# cyten_tpu's PlanarDMRGEngine; the aliases exist for drop-in parity.
PlanarHEffective = HEffective
PlanarDMRGEngine = DMRGEngine
