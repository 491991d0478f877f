"""TDVP: time-dependent variational principle for finite MPS.

The counterpart of ``cyten_tpu/algorithms/tdvp.py``. Single-site TDVP with the
projector-splitting integrator of Haegeman, Lubich, Oseledets, Vandereycken &
Verstraete, PRB 94, 165116 (2016): a left-to-right half sweep (each site evolved
forward by dt/2 under its effective Hamiltonian, each bond center evolved backward
under the zero-site K operator) followed by the mirrored right-to-left half sweep. For
time-independent Hamiltonians the integrator is symplectic: it conserves energy and
norm exactly (up to Lanczos tolerance) at fixed bond dimension, and it evolves under
arbitrary MPOs. :class:`TDVP2Engine` evolves two-site wavefunctions and can grow chi;
:class:`TDVPQREngine` splits with QR/LQ instead of SVDs.

The environments are those of a finite DMRG engine
(:meth:`~cyten_tpu_torch.algorithms.dmrg.DMRGEngine._environments`). Every ``tdot``
and ``compose`` on the abelian backend runs its block products as one grouped-GEMM
launch; in real time the state and the environments are complex128 and the MPO stays
real, so its lists are real x complex.

``TDVPQREngine(fused=True)`` runs each site step (the fused Krylov evolution under
``HEffective1``, the QR or LQ split, the environment update, the fused backward
evolution under ``KEffective``) as one CUDA graph per site structure and direction on
the card (``cyten_tpu``'s jitted ``_site_step_right``/``_site_step_left``), its Krylov
problems solved by ``blocks/tridiag.py::tridiagonal_evolve`` where they lie; on the
CPU the same steps run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensors import lq, norm, permute_legs, pinv, qr, scalar_multiply, scale_axis, svd, tdot
from ..tensors.krylov_based import (
    LanczosEvolution, _close_structure, _device_norm, fused_lanczos_evolution_impl,
)
from ..tensors.sparse import LinearOperator
from .dmrg import DMRGEngine, HEffective, _GraphedStep, _structure, _update_LP_impl, \
    _update_RP_impl
from .dmrg1 import HEffective1
from .mps import SimpleMPS, split_truncate_theta

__all__ = ['KEffective', 'TDVPEngine', 'TDVP2Engine', 'TDVPQREngine']


class KEffective(LinearOperator):
    """Zero-site effective Hamiltonian ``LP -- RP`` acting on a bond center."""

    def __init__(self, LP, RP):
        self.LP = LP
        self.RP = RP
        LinearOperator.__init__(self, dtype=LP.dtype)

    def matvec(self, C):
        x = tdot(C, self.LP, 'vL', 'vR')                 # [vR, vR*, wR]
        x = tdot(x, self.RP, ['vR', 'wR'], ['vL', 'wL'])  # [vR*, vL*]
        x = x.relabelled({'vR*': 'vL', 'vL*': 'vR'})
        return permute_legs(x, codomain=['vL'], domain=['vR'])


class TDVPEngine:
    """Single-site TDVP sweeps on a finite MPS (second-order splitting).

    Parameters mirror :class:`~cyten_tpu_torch.algorithms.tebd.TEBDEngine`: ``dt`` is
    the time step, ``imaginary=True`` evolves with exp(-dt H) (ground-state projection
    with per-step normalization), else exp(-i dt H). The bond dimension is FIXED by the
    initial state (single-site TDVP cannot grow chi: start from a state with the
    target bond dimension, e.g. a DMRG state, or grow with TEBD/DMRG first). Each
    evolution is a host-driven :class:`~cyten_tpu_torch.tensors.krylov_based.
    LanczosEvolution`.
    """

    def __init__(self, psi: SimpleMPS, model, dt: float, imaginary: bool = False,
                 lanczos_options: dict = None):
        assert psi.bc == 'finite'
        self.psi = psi
        self.model = model
        self.dt = dt
        self.imaginary = imaginary
        self.lanczos_options = lanczos_options or {
            'N_max': 30, 'N_min': 3, 'P_tol': 1e-12, 'reortho': True}
        self.backend = psi.backend
        # the DMRG environment machinery
        self._env = DMRGEngine._environments(psi, model)
        self.LPs = self._env.LPs
        self.RPs = self._env.RPs

    def _evolve(self, H, vec, delta):
        options = dict(self.lanczos_options)
        ev = LanczosEvolution(H, vec, options)
        res, n_iter = ev.run(delta)
        if self.imaginary:
            res = (1. / norm(res)) * res
        return res

    def _deltas(self, half_dt):
        """(site delta, bond delta): exp(site_delta * H1), exp(bond_delta * K)."""
        if self.imaginary:
            return -half_dt, +half_dt
        return -1j * half_dt, +1j * half_dt

    def sweep(self):
        """One second-order step: dt/2 left-to-right, then dt/2 right-to-left."""
        psi = self.psi
        L = psi.L
        d_site, d_bond = self._deltas(self.dt / 2.)

        # ---- left-to-right half sweep: sites 0..L-1 forward dt/2, bond centers
        # backward dt/2 after every split ----
        th = psi.get_theta1(0)
        for i in range(L):
            H1 = HEffective1(self.LPs[i], self.RPs[i], self.model.H_mpo[i])
            th = self._evolve(H1, th, d_site)
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
            if i == L - 1:
                break
            U, S, Vh = svd(th, new_labels=['vR', 'vL'])
            nrm = norm(S)
            S = (1. / nrm) * S
            Sinv = pinv(psi.Ss[i], cutoff=1e-14)
            psi.Bs[i] = scale_axis(scale_axis(U, Sinv, 'vL'), S, 'vR')
            psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
            self._env.update_LP(i, U)
            C = scale_axis(Vh, S, 'vL')                  # C = S . Vh, [vL; vR]
            if not self.imaginary:
                C = float(nrm) * C
            # zero-site K on bond (i, i+1): left env covers sites <= i (fresh, from
            # the new U), right env covers sites >= i+1 (that is RPs[i])
            K = KEffective(self.LPs[i + 1], self.RPs[i])
            C = self._evolve(K, C, d_bond)
            th = tdot(C, psi.Bs[i + 1], 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])

        # ---- right-to-left half sweep (site L-1 gets its second dt/2) ----
        for i in range(L - 1, -1, -1):
            H1 = HEffective1(self.LPs[i], self.RPs[i], self.model.H_mpo[i])
            th = self._evolve(H1, th, d_site)
            if i == 0:
                th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
                break
            th = permute_legs(th, codomain=['vL'], domain=['vR', 'p'])
            # gauge bookkeeping: Bs[i-1] stores S_{i-1}^-1 U_{i-1} S_i^old, so the old
            # bond singulars must be stripped before absorbing the evolved center
            # (the pattern of DMRG1SEngine's left moves)
            S_old_inv = pinv(psi.Ss[i], cutoff=1e-14)
            U, S, Vh = svd(th, new_labels=['vR', 'vL'])
            nrm = norm(S)
            S = (1. / nrm) * S
            psi.Bs[i] = permute_legs(Vh, codomain=['vL', 'p'], domain=['vR'])
            psi.Ss[i] = S.relabelled(['vL', 'vL*'])
            self._env.update_RP(i, psi.Bs[i])
            C = scale_axis(U, S, 'vR')
            if not self.imaginary:
                C = float(nrm) * C
            K = KEffective(self.LPs[i], self.RPs[i - 1])
            C = self._evolve(K, C, d_bond)
            th = tdot(scale_axis(psi.get_theta1(i - 1), S_old_inv, 'vR'),
                      C, 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
        # park the center back into B form at site 0
        psi.Bs[0] = scale_axis(th, pinv(psi.Ss[0], cutoff=1e-14), 'vL')

    def run(self, n_steps: int, verbose: bool = False):
        for n in range(n_steps):
            self.sweep()
            if verbose and (n + 1) % 10 == 0:
                E = self.energy()
                print(f'step {n + 1}: E = {E:.10f}')
        return self

    def energy(self) -> float:
        return float(np.real(self.psi.expectation_value_mpo(self.model.H_mpo)))


class TDVP2Engine(TDVPEngine):
    """Two-site TDVP: like :class:`TDVPEngine` but the forward step evolves two-site
    wavefunctions, so the bond dimension can GROW (up to ``chi_max``, truncated at
    ``eps``). The backward dt/2 step acts on the single-site center (Haegeman et al.
    PRB 94, 165116, Sec. V). Not exactly energy-conserving (truncation breaks
    symplecticity), but it can start from low-entanglement initial states; switch to
    1-site TDVP once chi saturates.
    """

    def __init__(self, psi: SimpleMPS, model, dt: float, imaginary: bool = False,
                 chi_max: int = 64, eps: float = 1e-12,
                 lanczos_options: dict = None):
        TDVPEngine.__init__(self, psi, model, dt, imaginary=imaginary,
                            lanczos_options=lanczos_options)
        self.chi_max = chi_max
        self.eps = eps
        self.trunc_err = 0.

    def sweep(self):
        psi = self.psi
        L = psi.L
        d_site, d_bond = self._deltas(self.dt / 2.)

        # ---- left-to-right half sweep: two-site forward, one-site backward ----
        th = psi.get_theta2(0)  # [vL, p0, p1; vR]
        for i in range(L - 1):
            H2 = HEffective(self.LPs[i], self.RPs[i + 1], self.model.H_mpo[i],
                            self.model.H_mpo[i + 1])
            th = self._evolve(H2, th, d_site)
            A, S, B, err = split_truncate_theta(th, self.chi_max, self.eps)
            self.trunc_err = max(self.trunc_err, err)
            Sinv = pinv(psi.Ss[i], cutoff=1e-14)
            psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
            psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
            psi.Bs[i + 1] = B
            self._env.update_LP(i, A)
            if i == L - 2:
                break
            # backward evolve the one-site center at i+1
            th1 = scale_axis(B, S.relabelled(['vL', 'vL*']), 'vL')
            H1 = HEffective1(self.LPs[i + 1], self.RPs[i + 1], self.model.H_mpo[i + 1])
            th1 = self._evolve(H1, th1, -d_site)
            th1 = permute_legs(th1, codomain=['vL', 'p'], domain=['vR'])
            th = tdot(th1.relabelled({'p': 'p0'}),
                      psi.Bs[i + 2].relabelled({'p': 'p1'}), 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p0', 'p1'], domain=['vR'])

        # ---- right-to-left half sweep ----
        th = psi.get_theta2(L - 2)
        for i in range(L - 2, -1, -1):
            H2 = HEffective(self.LPs[i], self.RPs[i + 1], self.model.H_mpo[i],
                            self.model.H_mpo[i + 1])
            th = self._evolve(H2, th, d_site)
            S_old_inv = pinv(psi.Ss[i], cutoff=1e-14)
            A, S, B, err = split_truncate_theta(th, self.chi_max, self.eps)
            self.trunc_err = max(self.trunc_err, err)
            Sinv = pinv(psi.Ss[i], cutoff=1e-14)
            psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
            psi.Ss[i + 1] = S.relabelled(['vL', 'vL*'])
            psi.Bs[i + 1] = B
            self._env.update_RP(i + 1, B)
            if i == 0:
                break
            # backward evolve the one-site center at i
            th1 = scale_axis(A, S, 'vR')  # [vL, p; c] with left envs of site i
            H1 = HEffective1(self.LPs[i], self.RPs[i], self.model.H_mpo[i])
            th1 = self._evolve(H1, th1, -d_site)
            th1 = permute_legs(th1, codomain=['vL', 'p'], domain=['vR'])
            # absorb into the previous site: theta2(i-1, i)
            prev = scale_axis(psi.get_theta1(i - 1), S_old_inv, 'vR')
            th = tdot(prev.relabelled({'p': 'p0'}),
                      th1.relabelled({'p': 'p1'}), 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p0', 'p1'], domain=['vR'])


def _site_step(kind: str, d_site, d_bond, N: int, templates: dict):
    """One fused QR-TDVP site step ``fn(LP, RP, W, th)``, ``cyten_tpu``'s jitted
    ``_site_step_right`` ('R': returns ``(A, C, LP_new)``) or ``_site_step_left`` ('L':
    ``(B, C, C_raw, RP_new)``), or a site's evolution alone ('E', the turning point and
    the last site: ``(th,)``), in ``N`` fixed Krylov iterations each
    (:func:`~cyten_tpu_torch.tensors.krylov_based.fused_lanczos_evolution_impl`).

    ``templates`` holds the zero tensors of the block structures closed under the two
    effective Hamiltonians, which the fused evolutions need (:func:`_close_structure`):
    the first call fills it (eagerly, with the extra matvecs of the closure), later
    calls add them to their inputs and read nothing on the host, so they can be
    captured in a CUDA graph.
    """

    def closed(key, H, t):
        if key not in templates:
            templates[key] = scalar_multiply(0., _close_structure(H, t))
        return t + templates[key]

    def fn(LP, RP, W, th):
        H1 = HEffective1(LP, RP, W)
        th = fused_lanczos_evolution_impl(H1, closed('th', H1, th), d_site, N)
        if kind == 'E':
            return (permute_legs(th, codomain=['vL', 'p'], domain=['vR']),)
        if kind == 'R':
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
            A, C = qr(th, new_labels=['vR', 'vL'])
            LPn = _update_LP_impl(LP, W, A)
            K = KEffective(LPn, RP)
            C = fused_lanczos_evolution_impl(K, closed('C', K, C), d_bond, N)
            return A, C, LPn
        th = permute_legs(th, codomain=['vL'], domain=['vR', 'p'])
        C_raw, B = lq(th, new_labels=['vR', 'vL'])
        B = permute_legs(B, codomain=['vL', 'p'], domain=['vR'])
        RPn = _update_RP_impl(RP, W, B)
        K = KEffective(LP, RPn)
        C = fused_lanczos_evolution_impl(K, closed('C', K, C_raw), d_bond, N)
        return B, C, C_raw, RPn

    return fn


class TDVPQREngine(TDVPEngine):
    """Single-site TDVP using QR/LQ splits instead of SVDs (cf. Unfried, Hauschild &
    Pollmann, PRB 107, 045102 (2023)).

    The projector-splitting integrator only needs *orthogonal* gauge splits: the
    Schmidt values are never used by the evolution itself. The left-to-right pass
    stores the left isometries ``A_i`` temporarily; the right-to-left pass restores B
    form via LQ. ``psi.Ss`` are refreshed from the bond centers (:meth:`refresh_Ss`,
    exact SVD values on the host; needed for entropies, not for the evolution).

    ``fused=True`` runs each site step as one function of fixed Krylov length
    ``lanczos_options['N_max']`` (default 30): the evolution, the split, the
    environment update and the backward bond evolution (:func:`_site_step`), and the
    turning point and the last site likewise, so that a sweep reads nothing on the
    host until :meth:`refresh_Ss`. On the card each step is a CUDA graph per site
    structure and kind: the first step of a structure runs eagerly (closing the block
    structures), the next captures the graph (:class:`~cyten_tpu_torch.algorithms.dmrg.
    _GraphedStep`), and later ones replay it. On the CPU the steps run eagerly.
    """

    def __init__(self, psi: SimpleMPS, model, dt: float, imaginary: bool = False,
                 lanczos_options: dict = None, fused: bool = False):
        TDVPEngine.__init__(self, psi, model, dt, imaginary=imaginary,
                            lanczos_options=lanczos_options)
        self.fused = fused
        self._fused_cache = {}
        self._Cs = [None] * psi.L  # bond centers of the last R->L pass
        on_card = torch.device(self.backend.block_backend.device).type == 'cuda'
        #: the graphs' shared memory pool (None: the fused steps run eagerly)
        self._graph_pool = torch.cuda.graph_pool_handle() if fused and on_card else None

    # -- fused per-site programs ------------------------------------------------

    def _fused_step(self, kind: str, i: int, th):
        """The fused step ``kind`` of :func:`_site_step` at site i: eager at the first
        call of its structure, then captured and replayed on the card."""
        args = (self.LPs[i], self.RPs[i], self.model.H_mpo[i], th)
        key = (kind, *(_structure(t) for t in args))
        entry = self._fused_cache.get(key)
        if entry is None:
            d_site, d_bond = self._deltas(self.dt / 2.)
            fn = _site_step(kind, d_site, d_bond, self.lanczos_options.get('N_max', 30), {})
            entry = self._fused_cache[key] = {'fn': fn, 'graph': None}
            return fn(*args)
        if self._graph_pool is None:
            return entry['fn'](*args)
        if entry['graph'] is None:
            entry['graph'] = _GraphedStep(entry['fn'], args, self._graph_pool)
        return entry['graph'].run(args)

    def graphs(self) -> list:
        """The CUDA graphs of the fused steps (:class:`_GraphedStep`)."""
        return [e['graph'] for e in self._fused_cache.values() if e['graph'] is not None]

    def sweep(self):
        psi = self.psi
        L = psi.L
        d_site, d_bond = self._deltas(self.dt / 2.)

        As = [None] * L
        # ---- left-to-right: evolve site, QR split, backward-evolve center ----
        # (the turning-point site L-1 is evolved at the START of the R->L pass,
        # mirroring TDVPEngine.sweep: every site gets two d_site evolutions)
        th = psi.get_theta1(0)
        for i in range(L - 1):
            if self.fused:
                A, C, LPn = self._fused_step('R', i, th)
                self.LPs[i + 1] = LPn
            else:
                H1 = HEffective1(self.LPs[i], self.RPs[i], self.model.H_mpo[i])
                th = self._evolve(H1, th, d_site)
                th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
                A, C = qr(th, new_labels=['vR', 'vL'])
                self._env.update_LP(i, A)
                K = KEffective(self.LPs[i + 1], self.RPs[i])
                C = self._evolve(K, C, d_bond)
            As[i] = A
            th = tdot(C, psi.Bs[i + 1], 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
        # turning point: site L-1's first d_site evolution (no split)
        if self.fused:
            th, = self._fused_step('E', L - 1, th)
        else:
            H1 = HEffective1(self.LPs[L - 1], self.RPs[L - 1], self.model.H_mpo[L - 1])
            th = self._evolve(H1, th, d_site)
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])

        # ---- right-to-left: evolve site, LQ split, backward-evolve center ----
        for i in range(L - 1, 0, -1):
            if self.fused:
                B, C, C_raw, RPn = self._fused_step('L', i, th)
                self.RPs[i - 1] = RPn
            else:
                H1 = HEffective1(self.LPs[i], self.RPs[i], self.model.H_mpo[i])
                th = self._evolve(H1, th, d_site)
                th = permute_legs(th, codomain=['vL'], domain=['vR', 'p'])
                C_raw, B = lq(th, new_labels=['vR', 'vL'])
                B = permute_legs(B, codomain=['vL', 'p'], domain=['vR'])
                self._env.update_RP(i, B)
                K = KEffective(self.LPs[i], self.RPs[i - 1])
                C = self._evolve(K, C_raw, d_bond)
            psi.Bs[i] = B
            # Schmidt values come from the split BEFORE the backward bond evolution
            # (the timing of TDVPEngine's psi.Ss bookkeeping)
            self._Cs[i] = C_raw
            th = tdot(As[i - 1], C, 'vR', 'vL')
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
        # final site: forward-evolve; with the trivial left bond (Ss[0] = 1), B form
        # simply stores theta1(0) at site 0
        if self.fused:
            th, = self._fused_step('E', 0, th)
        else:
            H1 = HEffective1(self.LPs[0], self.RPs[0], self.model.H_mpo[0])
            th = self._evolve(H1, th, d_site)
            th = permute_legs(th, codomain=['vL', 'p'], domain=['vR'])
        if self.imaginary:  # fused: the norm stays on the device
            th = (scalar_multiply(1. / _device_norm(th), th) if self.fused
                  else (1. / norm(th)) * th)
        psi.Bs[0] = th
        self.refresh_Ss()

    def refresh_Ss(self):
        """Recompute psi.Ss from the stored bond centers: the exact singular values of
        each center's blocks, taken on the host (numpy) and normalized. The blocks of
        every center cross to the host in one copy, the sweep's one host sync; the
        values go back in one asynchronous copy from pinned memory."""
        from ..backends.data import DiagonalBlockData
        from ..dtypes import Dtype
        from ..tensors import DiagonalTensor

        psi = self.psi
        bonds = [i for i in range(1, psi.L) if self._Cs[i] is not None]
        blocks = [b for i in bonds for b in self._Cs[i].data.blocks]
        if not blocks:
            return
        flat = torch.cat([b.reshape(-1) for b in blocks]).cpu().numpy()
        offset, values = 0, []
        for i in bonds:
            s_blocks = []
            for blk in self._Cs[i].data.blocks:
                n = blk.numel()
                host = flat[offset:offset + n].reshape(tuple(blk.shape))
                offset += n
                s_blocks.append(np.linalg.svd(host, compute_uv=False))
            total = np.sqrt(sum(float(np.sum(s ** 2)) for s in s_blocks))
            values.append([s / max(total, 1e-300) for s in s_blocks])
        host = torch.from_numpy(np.concatenate([s for v in values for s in v]))
        device = blocks[0].device
        on_device = (host.pin_memory().to(device, non_blocking=True) if device.type == 'cuda'
                     else host.to(device))
        parts = iter(on_device.split([len(s) for v in values for s in v]))
        for i, v in zip(bonds, values):
            C = self._Cs[i]
            inds = np.array([int(r[0]) for r in C.data.block_inds], dtype=np.intp)
            data = DiagonalBlockData([next(parts) for _ in v], inds, Dtype.float64,
                                     is_sorted=True)
            psi.Ss[i] = DiagonalTensor(data, C.codomain.factors[0], C.backend,
                                       ['vL', 'vL*'])
