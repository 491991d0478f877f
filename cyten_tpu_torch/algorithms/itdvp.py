"""iTDVP: time evolution of infinite (uniform) MPS with fixed-point environments.

The counterpart of ``cyten_tpu/algorithms/itdvp.py``. Single-site TDVP for a
translation-invariant MPS with an L-site unit cell, in the mixed canonical gauge
(AL, C, AR) of the tangent-space formulation (Vanderstraeten, Haegeman & Verstraete,
SciPost Phys. Lect. Notes 7 (2019), Sec. 5.2; Haegeman et al., PRB 94, 165116 (2016),
Sec. VI):

- The left/right MPO environments are the *fixed points* of the unit-cell transfer
  operators, computed by power iteration with the McCulloch energy subtraction (the
  linearly growing component along the identity in the Hamiltonian channel is
  projected out each cell absorption, so the effective Hamiltonians stay O(1);
  convergence rate is the transfer-matrix gap). In real time they are complex
  (``_env_dtype``).
- One time step evolves every center-site wavefunction ``AC_i = C_i AR_i`` forward
  under ``H_AC`` and every bond center ``C_i`` forward under the zero-site ``K``; the
  new isometries are recovered from QR factors, ``AL_i = Q(AC_i) Q(C_{i+1})^dagger``
  and ``AR_i = Qbar(C_i)^dagger Qbar(AC_i)``: the ``C``-factor inversion supplies the
  backward bond step of the finite-chain splitting integrator automatically.

Unlike iTEBD this evolves under arbitrary MPOs (long-range terms) at fixed bond
dimension and never truncates. Grow chi first (iTEBD / iDMRG), then hand the state
over. The environments and the boundary tensors live on the tensors' device; the
power iteration and the Lanczos evolutions are host-driven.
"""

from __future__ import annotations

import numpy as np

from ..tensors import dagger, inner, norm, permute_legs, svd, tdot
from ..tensors import lq as lq_
from ..tensors import qr as qr_
from ..tensors.krylov_based import LanczosEvolution
from .dmrg import _update_LP_impl, _update_RP_impl
from .dmrg1 import HEffective1
from .idmrg import _eye_block, _fix_qr_phases
from .mps import SimpleMPS, _fix_lq_phases
from .tdvp import KEffective

__all__ = ['iTDVPEngine']


class iTDVPEngine:
    """Single-site TDVP on an infinite MPS (L-site unit cell).

    Parameters
    ----------
    psi : SimpleMPS with ``bc='infinite'``
        Initial unit cell in canonical B form (e.g. from iDMRG, iTEBD after
        ``canonicalize_infinite``, or an exact product state). The bond
        dimension stays FIXED.
    model
        Built with ``bc='infinite'``: uniform ``H_mpo`` with one tensor per
        unit-cell site.
    dt : float
        Time step; ``imaginary=True`` evolves with exp(-dt H) per step
        (normalized), else exp(-i dt H).
    env_tol, env_max_iter
        Fixed-point power iteration control. Environments are warm-started
        between steps, so after the first step only a few cell absorptions per
        step are typically needed.
    """

    def __init__(self, psi: SimpleMPS, model, dt: float, imaginary: bool = False,
                 lanczos_options: dict = None, env_tol: float = 1e-12,
                 env_max_iter: int = 500, canonical_tol: float = 1e-6):
        assert psi.bc == 'infinite', "iTDVP needs SimpleMPS(bc='infinite')"
        assert getattr(model, 'bc', 'finite') == 'infinite', \
            "iTDVP needs a model built with bc='infinite'"
        assert len(model.H_mpo) == psi.L
        self.model = model
        self.L = psi.L
        self.dt = dt
        self.imaginary = imaginary
        self.lanczos_options = lanczos_options or {
            'N_max': 30, 'N_min': 3, 'P_tol': 1e-12, 'reortho': True}
        self.backend = psi.backend
        self.env_tol = env_tol
        self.env_max_iter = env_max_iter
        #: max tolerated wrap-around gauge mismatch of the input cell. TDVP
        #: needs a truly canonical start (the projector assumes it); VUMPS
        #: passes a loose value since its iteration is gauge self-correcting.
        self.canonical_tol = canonical_tol
        # mixed canonical gauge: Cs[i] on the LEFT bond of site i, ARs[i] the
        # right isometry, ALs[i] the left isometry (AL_i C_{i+1} = C_i AR_i)
        self.ARs = [B.copy(deep=False) for B in psi.Bs]
        self.Cs = [S.as_SymmetricTensor().relabelled(['vL', 'vR'])
                   for S in psi.Ss]
        self.ALs = self._left_isometries_from_state()
        self.LW = None
        self.RW = None
        self.env_energy_cell = None   # subtracted LW growth rate per cell
        self.env_iters = 0    # cell absorptions in the last fixed-point solve
        self.n_steps = 0

    # -- gauge ----------------------------------------------------------------

    def _left_isometries_from_state(self):
        """AL_i by a QR sweep through the cell: QR(C_i AR_i) = AL_i C_{i+1}.

        For an exactly canonical input the (phase-fixed) R factor reproduces
        ``C_{i+1}`` identically; a large wrap-around mismatch means the input
        was not canonical (run ``psi.canonicalize_infinite()`` first).
        """
        L = self.L
        ALs = []
        C = self.Cs[0]
        for i in range(L):
            M = tdot(C, self.ARs[i], 'vR', 'vL')
            M = permute_legs(M, codomain=['vL', 'p'], domain=['vR'])
            A, C = qr_(M, new_labels=['vR', 'vL'])
            A, C = _fix_qr_phases(A, C)
            ALs.append(A)
            if i < L - 1:
                self.Cs[i + 1] = C
        mismatch = float(norm(C + (-1.) * self.Cs[0])) / max(
            float(norm(C)), 1e-300)
        if mismatch > self.canonical_tol:
            raise ValueError(
                f'iTDVP: input unit cell is not canonical (wrap mismatch '
                f'{mismatch:.2e}); run psi.canonicalize_infinite() first')
        return ALs

    # -- environment fixed points --------------------------------------------

    @property
    def _env_dtype(self):
        dt = self.ALs[0].dtype
        return dt if self.imaginary else dt.to_complex

    def _boundary_LW(self):
        """eye(bond) in the MPO's starting channel (wL index 0)."""
        V = self.ALs[0].get_leg_co_domain('vL')
        w = self.model.H_mpo[0].get_leg_co_domain('wL')
        return _eye_block(V, w, 0, self.backend, self._env_dtype, [V], [V, w],
                          [['vR*'], ['vR', 'wR']])

    def _boundary_RW(self):
        V = self.ARs[-1].domain.factors[0]
        w = self.model.H_mpo[-1].get_leg_co_domain('wR')
        return _eye_block(V, w, int(w.dim) - 1, self.backend, self._env_dtype, [V, w],
                          [V], [['vL', 'wL'], ['vL*']])

    def _eye_H_left(self, LW):
        """eye(bond) times the unit vector in LW's Hamiltonian channel (last wR index):
        the direction that grows linearly under cell absorption."""
        V = LW.get_leg_co_domain('vR')
        w = LW.get_leg_co_domain('wR')
        return _eye_block(V, w, int(w.dim) - 1, self.backend, LW.dtype, [V], [V, w],
                          [['vR*'], ['vR', 'wR']])

    def _eye_H_right(self, RW):
        V = RW.get_leg_co_domain('vL')
        w = RW.get_leg_co_domain('wL')
        return _eye_block(V, w, 0, self.backend, RW.dtype, [V, w], [V],
                          [['vL', 'wL'], ['vL*']])

    def _solve_environments(self):
        """Power-iterate LW/RW to their (energy-subtracted) fixed points."""
        L = self.L
        LW = self.LW if self.LW is not None else self._boundary_LW()
        RW = self.RW if self.RW is not None else self._boundary_RW()
        eyeL = self._eye_H_left(LW)
        eyeR = self._eye_H_right(RW)
        nrmL = float(np.real(inner(eyeL, eyeL, do_dagger=True)))
        nrmR = float(np.real(inner(eyeR, eyeR, do_dagger=True)))
        iters = 0
        for _ in range(self.env_max_iter):
            LWn = LW
            for i in range(L):
                LWn = _update_LP_impl(LWn, self.model.H_mpo[i], self.ALs[i])
            # Hermitian effective Hamiltonians: the growth rate is real
            e = float(np.real(inner(eyeL, LWn, do_dagger=True))) / nrmL
            LWn = LWn - e * eyeL
            dL = float(norm(LWn + (-1.) * LW))
            LW = LWn
            # at convergence, the subtracted growth rate IS the energy added
            # per absorbed unit cell — valid for ANY upper-triangular MPO,
            # including in-flight (range > 1) channels
            self.env_energy_cell = e
            RWn = RW
            for i in range(L - 1, -1, -1):
                RWn = _update_RP_impl(RWn, self.model.H_mpo[i], self.ARs[i])
            e = float(np.real(inner(eyeR, RWn, do_dagger=True))) / nrmR
            RWn = RWn - e * eyeR
            dR = float(norm(RWn + (-1.) * RW))
            RW = RWn
            iters += 1
            scale = max(float(norm(LW)), float(norm(RW)), 1.)
            if max(dL, dR) < self.env_tol * scale:
                break
        self.LW, self.RW = LW, RW
        self.env_iters = iters

    # -- one time step --------------------------------------------------------

    def _evolve(self, H, vec, delta):
        ev = LanczosEvolution(H, vec, dict(self.lanczos_options))
        res, n_iter = ev.run(delta)
        return res

    def step(self):
        """Advance the unit cell by one time step ``dt``."""
        L = self.L
        self._solve_environments()
        delta = -self.dt if self.imaginary else -1j * self.dt
        # per-site environments within the cell (same pre-step envs for all
        # sites: the uniform 'parallel' integrator)
        LWs = [self.LW]
        for i in range(L):
            LWs.append(_update_LP_impl(LWs[-1], self.model.H_mpo[i],
                                       self.ALs[i]))
        RWs = [None] * (L + 1)   # RWs[i+1] covers sites > i; RWs[0] covers >= 0
        RWs[L] = self.RW
        for i in range(L - 1, -1, -1):
            RWs[i] = _update_RP_impl(RWs[i + 1], self.model.H_mpo[i],
                                     self.ARs[i])
        # evolve all AC_i and C_i forward
        ACs = []
        for i in range(L):
            AC = tdot(self.Cs[i], self.ARs[i], 'vR', 'vL')
            AC = permute_legs(AC, codomain=['vL', 'p'], domain=['vR'])
            H1 = HEffective1(LWs[i], RWs[i + 1], self.model.H_mpo[i])
            ACs.append(self._evolve(H1, AC, delta))
        new_Cs = []
        for i in range(L):
            K = KEffective(LWs[i], RWs[i])
            C = self._evolve(K, self.Cs[i], delta)
            new_Cs.append((1. / float(norm(C))) * C)
        self._regauge(ACs, new_Cs)
        self.n_steps += 1
        return self

    def _regauge(self, ACs, new_Cs):
        """Recover AL/AR from phase-fixed QR/LQ factors of the new AC and C:
        ``AL_i = Q(AC_i) Q(C_{i+1})^dagger``, ``AR_i = Qbar(C_i)^dagger
        Qbar(AC_i)`` (also the re-gauge step of :class:`VUMPSEngine`)."""
        L = self.L
        new_ALs, new_ARs = [], []
        for i in range(L):
            AC = permute_legs(ACs[i], codomain=['vL', 'p'], domain=['vR'])
            Q_AC, R_AC = qr_(AC, new_labels=['vR', 'vL'])
            Q_AC, _ = _fix_qr_phases(Q_AC, R_AC)
            Q_C, R_C = qr_(new_Cs[(i + 1) % L], new_labels=['vR', 'vL'])
            Q_C, _ = _fix_qr_phases(Q_C, R_C)
            new_ALs.append(compose_iso(Q_AC, dagger(Q_C)))
            ACl = permute_legs(ACs[i], codomain=['vL'], domain=['vR', 'p'])
            L_AC, Qb_AC = lq_(ACl, new_labels=['vR', 'vL'])
            L_AC, Qb_AC = _fix_lq_phases(L_AC, Qb_AC)
            L_C, Qb_C = lq_(new_Cs[i], new_labels=['vR', 'vL'])
            L_C, Qb_C = _fix_lq_phases(L_C, Qb_C)
            AR = tdot(dagger(Qb_C), Qb_AC, 'vL*', 'vL')
            AR = AR.relabelled({'vR*': 'vL'})
            new_ARs.append(permute_legs(AR, codomain=['vL', 'p'],
                                        domain=['vR']))
        self.ALs, self.ARs, self.Cs = new_ALs, new_ARs, new_Cs

    def run(self, n_steps: int, verbose: bool = False):
        for n in range(n_steps):
            self.step()
            if verbose and (n + 1) % 10 == 0:
                print(f'step {n + 1}: e/site = {self.energy_density():.10f}, '
                      f'env iters = {self.env_iters}')
        return self

    # -- read-out -------------------------------------------------------------

    @property
    def psi(self) -> SimpleMPS:
        """The current unit cell as a canonical B-form infinite MPS.

        Gauge-fixes each bond to the Schmidt basis via ``C_i = U_i S_i V_i^d``:
        the Schmidt values are ``S_i`` and ``B_i = V_i^d AR_i V_{i+1}``.
        """
        L = self.L
        Ss, Vhs = [], []
        for C in self.Cs:
            U, S, Vh = svd(C, new_labels=['vR', 'vL'])
            Ss.append((1. / float(norm(S))) * S)
            Vhs.append(Vh)             # [vL (Schmidt basis); vR (old bond)]
        Bs = []
        for i in range(L):
            B = tdot(Vhs[i], self.ARs[i], 'vR', 'vL')   # [vL(new), p, vR(old)]
            B = tdot(B, dagger(Vhs[(i + 1) % L]), 'vR', 'vR*')
            B = B.relabelled({'vL*': 'vR'})
            Bs.append(permute_legs(B, codomain=['vL', 'p'], domain=['vR']))
        Ss = [S.relabelled(['vL', 'vL*']) for S in Ss]
        return SimpleMPS(Bs, Ss, bc='infinite')

    def energy_density(self) -> float:
        """Energy per site.

        Uses ``model.energy(psi)`` (bond expectation values) when the model
        provides it; otherwise falls back to the MPO environments' per-cell
        growth rate — which is exact for ANY uniform MPO, including the
        in-flight channels of range > 1 couplings from
        :func:`~cyten_tpu_torch.algorithms.models.mpo_from_terms`. (The
        ``lam_AC - lam_C`` VUMPS estimate is NOT reliable for such MPOs —
        measured on the Majumdar-Ghosh point it returns 0 while this growth
        rate gives the exact -0.375 per site.)
        """
        if hasattr(self.model, 'energy'):
            return float(self.model.energy(self.psi))
        self._solve_environments()   # warm-started; cheap at convergence
        return float(self.env_energy_cell) / self.L


def compose_iso(Q, Qd):
    """``Q @ Q_C^dagger`` on the new bond: Q [vL, p; vR], Qd [vR*; vL*]."""
    res = tdot(Q, Qd, 'vR', 'vR*')
    res = res.relabelled({'vL*': 'vR'})
    return permute_legs(res, codomain=['vL', 'p'], domain=['vR'])

