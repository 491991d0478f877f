"""Two-site DMRG on finite MPS.

The counterpart of ``cyten_tpu/algorithms/dmrg.py``: the environment updates,
``_apply_bond_mixing``, the effective-Hamiltonian matvec, :class:`HEffective` and
:class:`DMRGEngine` with ``sweep``, ``update_bond`` and ``run``. Every ``tdot`` and
``compose`` on the abelian backend runs its block products as one grouped-GEMM kernel
launch; the Lanczos solver is driven from the host.

Environment conventions:

- ``LPs[i]``: everything left of site i, labels ``['vR', 'wR', 'vR*']``
  (ket bond, MPO bond, bra bond).
- ``RPs[i]``: everything right of site i, labels ``['vL', 'wL', 'vL*']``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensors import (
    SymmetricTensor, compose, dagger, permute_legs, pinv, scale_axis, tdot,
)
from ..tensors.krylov_based import lanczos
from ..tensors.sparse import LinearOperator
from .mps import SimpleMPS, split_truncate_theta

__all__ = ['HEffective', 'DMRGEngine', 'FaultError']


class FaultError(RuntimeError):
    """A sweep produced a non-finite result and there was no checkpoint to roll
    back to."""


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

    from ..backends.data import BlockSparseData
    from ..symmetries import TensorProduct
    from ..tensors import SymmetricTensor

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
    from ..backends.abelian import AbelianBackend
    from ..config import config

    if isinstance(theta.backend, AbelianBackend) \
            and config.bond_channel_fusion \
            and W1.dtype == W2.dtype == theta.dtype:
        x = tdot(LP, theta, 'vR', 'vL')                  # [vR*, wR, p0, p1, vR]
        x = _apply_bond_mixing(x, W1, W2)                # [p1, wR, p0, vR*, vR]
        x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])      # [p1, p0, vR*, vL*]
        x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
        return permute_legs(x, codomain=['vL', 'p0', 'p1'], domain=['vR'])
    # the port's backends (abelian, no symmetry) braid symmetrically, so the
    # lhs-small operand order of cyten_tpu (the small LP/W on the left) is exact
    x = tdot(LP, theta, 'vR', 'vL')                      # [vR*, wR, p0, p1, vR]
    x = tdot(W1, x, ['p0*', 'wL'], ['p0', 'wR'])         # [p0, wR, vR*, p1, vR]
    x = tdot(W2, x, ['p1*', 'wL'], ['p1', 'wR'])         # [p1, wR, p0, vR*, vR]
    x = tdot(x, RP, ['vR', 'wR'], ['vL', 'wL'])          # [p1, p0, vR*, vL*]
    x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
    return permute_legs(x, codomain=['vL', 'p0', 'p1'], domain=['vR'])


class HEffective(LinearOperator):
    """Effective two-site Hamiltonian ``LP -- W1 -- W2 -- RP``."""

    def __init__(self, LP, RP, W1, W2):
        self.LP = LP
        self.RP = RP
        self.W1 = W1.relabelled({'p': 'p0', 'p*': 'p0*'})
        self.W2 = W2.relabelled({'p': 'p1', 'p*': 'p1*'})
        LinearOperator.__init__(self, dtype=W1.dtype)

    def matvec(self, theta):
        return _heff_matvec_impl(self.LP, self.RP, self.W1, self.W2, theta)


class DMRGEngine:
    """Two-site DMRG sweeps with a host-driven Lanczos ground-state search per bond.

    Options of ``cyten_tpu``'s engine that are not ported yet raise
    ``NotImplementedError``: ``mesh``, ``orthogonal_to``, ``auto_static``, static
    mode, ``dynamic_svd`` other than 'exact', and ``run(checkpoint=...)``.
    """

    def __init__(self, psi: SimpleMPS, model, chi_max: int = 32, eps: float = 1e-12,
                 lanczos_options: dict = None, mesh=None, orthogonal_to=None,
                 auto_static: bool | str = False, dynamic_svd: str = 'exact'):
        if mesh is not None:
            raise NotImplementedError('DMRGEngine(mesh=...) is not ported yet')
        if orthogonal_to:
            raise NotImplementedError('DMRGEngine(orthogonal_to=...) is not ported yet')
        if auto_static:
            raise NotImplementedError('static mode (auto_static) is not ported yet')
        if dynamic_svd != 'exact':
            raise NotImplementedError(f'dynamic_svd={dynamic_svd!r} is not ported yet')
        self.psi = psi
        self.model = model
        self.chi_max = chi_max
        self.eps = eps
        self.lanczos_options = lanczos_options or {'N_max': 20, 'P_tol': 1e-14}
        self.backend = psi.backend
        L = psi.L
        self.LPs = [None] * L
        self.RPs = [None] * L
        self._init_environments()
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

    def update_LP(self, i: int, A):
        """LPs[i+1] from LPs[i] and the left-isometric tensor A at site i."""
        self.LPs[i + 1] = _update_LP_impl(self.LPs[i], self.model.H_mpo[i], A)  # [vR*, wR, vR]

    def update_RP(self, i: int, B=None):
        """RPs[i-1] from RPs[i] and the right-isometric tensor B at site i."""
        if B is None:
            B = self.psi.Bs[i]
        self.RPs[i - 1] = _update_RP_impl(self.RPs[i], self.model.H_mpo[i], B)  # [vL, wL, vL*]

    def sweep(self) -> float:
        L = self.psi.L
        for i in range(L - 1):
            self.update_bond(i)
        for i in range(L - 2, -1, -1):
            self.update_bond(i)
        return self.E

    def update_bond(self, i: int):
        psi = self.psi
        Heff = HEffective(self.LPs[i], self.RPs[i + 1], self.model.H_mpo[i],
                          self.model.H_mpo[i + 1])
        E, theta, n_iter = lanczos(Heff, psi.get_theta2(i), self.lanczos_options)
        self.E = E
        A, S, B, err = split_truncate_theta(theta, self.chi_max, self.eps)
        self.trunc_err = max(self.trunc_err, err)
        # restore B form on site i: B_i = S_i^{-1} A S_new
        Sinv = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
        psi.Bs[i + 1] = B
        self.update_LP(i, A)
        self.update_RP(i + 1, B)

    def run(self, n_sweeps: int = 10, tol: float = 1e-10, verbose: bool = False,
            checkpoint=None) -> float:
        """Sweep until the energy changes by less than ``tol`` (at most ``n_sweeps``).

        A sweep whose energy is not finite, or that fails in a factorization,
        raises :class:`FaultError`: there is no checkpoint to roll back to
        (``checkpoint=`` is not ported yet and raises ``NotImplementedError``).
        """
        if checkpoint is not None:
            raise NotImplementedError('DMRGEngine.run(checkpoint=...) is not ported yet')
        E_old = np.inf
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
                raise FaultError(f'non-finite result after sweep ({fault_exc or E}); '
                                 'no checkpoint to roll back to') from fault_exc
            if verbose:
                print(f'sweep {sweep + 1}: E = {E:.12f}, '
                      f'max chi = {self.psi.max_chi()}')
            if abs(E - E_old) < tol:
                break
            E_old = E
        return self.E
