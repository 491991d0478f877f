"""VUMPS: variational uniform-MPS ground-state optimization.

The counterpart of ``cyten_tpu/algorithms/vumps.py``. Zauner-Stauber, Vanderstraeten,
Fishman, Verstraete & Haegeman, PRB 97, 045145 (2018): in the mixed canonical gauge
(AL, C, AR) each iteration solves the *eigenvalue* problems of the effective
Hamiltonians built from the fixed-point environments,

    H_AC |AC_i> = lam_AC |AC_i>,    H_C |C_i> = lam_C |C_i>,

and recovers the new isometries from phase-fixed QR factors (the gauge step of
:class:`~cyten_tpu_torch.algorithms.itdvp.iTDVPEngine`, whose machinery this engine
shares). Convergence is tracked by the tangent-space gradient norm
``err_i = |AC_i - AL_i C_{i+1}|``, which vanishes exactly at a variational optimum.
Compared to iDMRG, VUMPS converges the *uniform fixed point* directly (no
growing-window transient) and is the method of choice near criticality.

The bond dimension stays fixed; grow chi first (iDMRG / iTEBD) and hand the state
over, exactly like iTDVP (:meth:`VUMPSEngine.from_warm_start` does it with the port's
iDMRG).
"""

from __future__ import annotations

import numpy as np

from ..tensors import norm, permute_legs, tdot
from ..tensors.krylov_based import lanczos
from .dmrg import _update_LP_impl, _update_RP_impl
from .dmrg1 import HEffective1
from .itdvp import iTDVPEngine
from .tdvp import KEffective

__all__ = ['VUMPSEngine']


class VUMPSEngine(iTDVPEngine):
    """Variational uniform MPS ground-state search (L-site unit cell).

    Parameters as :class:`iTDVPEngine` minus the time step; plus Lanczos
    options for the eigensolves. ``run(max_iter, tol)`` iterates until the
    tangent-space gradient norm drops below ``tol``.
    """

    def __init__(self, psi, model, lanczos_options: dict = None,
                 env_tol: float = 1e-12, env_max_iter: int = 500,
                 canonical_tol: float = 1e-2):
        lanczos_options = lanczos_options or {
            'N_max': 60, 'N_min': 4, 'P_tol': 1e-14, 'reortho': True}
        # loose canonical_tol: the VUMPS iteration is gauge self-correcting,
        # so a warm start from a not-quite-converged window canonicalization
        # (common near criticality) is fine
        iTDVPEngine.__init__(self, psi, model, dt=0., imaginary=True,
                             lanczos_options=lanczos_options, env_tol=env_tol,
                             env_max_iter=env_max_iter,
                             canonical_tol=canonical_tol)
        self.grad_norm = np.inf
        self.energy_estimate = None   # lam_AC - lam_C (energy density per site)

    @classmethod
    def from_warm_start(cls, model, initial_state=None, psi=None,
                        chi_max: int = 32, eps: float = 1e-12,
                        n_steps: int = 20, tol: float = 1e-7,
                        n_cells: int = 16, **kwargs):
        """Engine seeded by a short iDMRG run (the recommended start).

        VUMPS iterates within the gauge orbit of its starting state; from a
        random or product start on a multi-site unit cell (period-2 order,
        dimerized couplings) it can converge to a LOCAL minimum — the
        eigensolves are per-site and nothing reshuffles weight between the
        cell's inequivalent bonds. A loose iDMRG warm start (default 20
        steps at ``tol=1e-7``) lands in the right basin, after which VUMPS
        converges the uniform fixed point rapidly.

        Pass either ``initial_state`` (per-site basis indices for
        ``SimpleMPS.from_product_state``) or an infinite ``psi`` to start
        from. Remaining ``kwargs`` go to ``VUMPSEngine.__init__``.
        """
        from .idmrg import iDMRGEngine
        from .mps import SimpleMPS

        if psi is None:
            if initial_state is None:
                raise ValueError('pass initial_state (per-site basis indices)'
                                 ' or an infinite psi to warm-start from')
            psi = SimpleMPS.from_product_state(model.site_legs, initial_state,
                                               backend=model.backend,
                                               bc='infinite')
        eng = iDMRGEngine(psi, model, chi_max=chi_max, eps=eps)
        eng.run(n_steps=n_steps, tol=tol)
        psi = eng.psi
        psi.canonicalize_infinite(n_cells=n_cells)
        return cls(psi, model, **kwargs)

    def step(self):
        """One VUMPS iteration: eigensolve every AC_i and C_i, re-gauge."""
        L = self.L
        self._solve_environments()
        LWs = [self.LW]
        for i in range(L):
            LWs.append(_update_LP_impl(LWs[-1], self.model.H_mpo[i],
                                       self.ALs[i]))
        RWs = [None] * (L + 1)
        RWs[L] = self.RW
        for i in range(L - 1, -1, -1):
            RWs[i] = _update_RP_impl(RWs[i + 1], self.model.H_mpo[i],
                                     self.ARs[i])
        ACs, lam_ACs, lam_Cs = [], [], []
        for i in range(L):
            AC0 = tdot(self.Cs[i], self.ARs[i], 'vR', 'vL')
            AC0 = permute_legs(AC0, codomain=['vL', 'p'], domain=['vR'])
            H1 = HEffective1(LWs[i], RWs[i + 1], self.model.H_mpo[i])
            lam, AC, _ = lanczos(H1, AC0, dict(self.lanczos_options))
            lam_ACs.append(float(lam))
            ACs.append((1. / float(norm(AC))) * AC)
        new_Cs = []
        for i in range(L):
            K = KEffective(LWs[i], RWs[i])
            lam, C, _ = lanczos(K, self.Cs[i], dict(self.lanczos_options))
            lam_Cs.append(float(lam))
            new_Cs.append((1. / float(norm(C))) * C)
        self._regauge(ACs, new_Cs)
        # with energy-subtracted environments the eigenvalue difference is the
        # energy density left un-subtracted in this iteration -> ~0 at the
        # fixed point; it doubles as a convergence diagnostic
        self.energy_estimate = (sum(lam_ACs) - sum(lam_Cs)) / L
        err = 0.
        for i in range(L):
            AL_C = tdot(self.ALs[i], self.Cs[(i + 1) % L], 'vR', 'vL')
            AL_C = permute_legs(AL_C, codomain=['vL', 'p'], domain=['vR'])
            err = max(err, float(norm(ACs[i] + (-1.) * AL_C)))
        self.grad_norm = err
        self.n_steps += 1
        return err

    def run(self, max_iter: int = 200, tol: float = 1e-10,
            verbose: bool = False) -> float:
        """Iterate until the gradient norm < tol; returns the energy density."""
        for n in range(max_iter):
            err = self.step()
            if verbose:
                print(f'iter {self.n_steps}: grad = {err:.3e}, '
                      f'e = {self.energy_density():.12f}')
            if err < tol:
                break
        return self.energy_density()
