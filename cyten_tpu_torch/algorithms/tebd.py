"""TEBD: time-evolving block decimation on finite or infinite MPS.

The counterpart of ``cyten_tpu/algorithms/tebd.py``. Real- or imaginary-time evolution
by second-order Trotterized two-site gates ``exp(factor * h)`` (the port's ``exp``,
``torch.linalg.matrix_exp`` per sector block; a complex factor in real time). For
``psi.bc == 'infinite'`` this is iTEBD (Vidal): the unit-cell bonds are updated with
wrap-around and imaginary-time runs re-canonicalize with the window method. Each bond
update applies its gate by one ``compose`` and splits with the exact per-sector SVD;
on the abelian backend the ``compose`` runs its block products as one grouped-GEMM
launch.
"""

from __future__ import annotations

import numpy as np

from ..tensors import compose, exp, permute_legs, pinv, scale_axis
from .mps import SimpleMPS, split_truncate_theta

__all__ = ['TEBDEngine']


class TEBDEngine:
    """Second-order Trotter TEBD sweeps on a finite chain.

    Parameters
    ----------
    psi : SimpleMPS
        The state, updated in place.
    model
        Provides ``H_bonds`` (two-site gates, legs [p0, p1, p1*, p0*]).
    dt : float
        Time step. ``imaginary=True`` evolves with exp(-dt h) (ground-state
        projection); else exp(-i dt h) (real time, complex dtype).
    """

    def __init__(self, psi: SimpleMPS, model, dt: float, chi_max: int = 64,
                 eps: float = 1e-12, imaginary: bool = True,
                 pad_chi_multiple: int = None, canonicalize_every: int = None):
        self.psi = psi
        self.model = model
        self.dt = dt
        self.chi_max = chi_max
        self.eps = eps
        self.imaginary = imaginary
        self.pad_chi_multiple = pad_chi_multiple
        #: re-canonicalize the state every this-many sweeps. Imaginary-time gates are
        #: non-unitary and degrade canonical form, which biases truncations and naive
        #: expectation values by O(dt); default: every sweep for imaginary time, never
        #: for real time (gates are unitary).
        if canonicalize_every is None:
            canonicalize_every = 1 if imaginary else 0
        self.canonicalize_every = canonicalize_every
        self.trunc_err = 0.
        self.U_half = [self._make_u(h, dt / 2.) for h in model.H_bonds]
        self.U_full = [self._make_u(h, dt) for h in model.H_bonds]

    def _make_u(self, h_bond, dt):
        factor = -dt if self.imaginary else -1j * dt
        h = h_bond.relabelled(['p0', 'p1', 'p1*', 'p0*'])
        return exp(factor * h)

    def update_bond(self, i: int, U):
        """Apply the gate on bond (i, i+1) and truncate (planar rearrangements)."""
        psi = self.psi
        j = (i + 1) % psi.L if psi.bc == 'infinite' else i + 1
        theta = psi.get_theta2(i)  # codomain [vL, p0, p1], domain [vR]
        thp = permute_legs(theta, codomain=['p0', 'p1'], domain=['vL', 'vR'])
        u_th = compose(U, thp)
        theta = permute_legs(u_th, codomain=['vL', 'p0', 'p1'], domain=['vR'])
        A, S, B, err = split_truncate_theta(theta, self.chi_max, self.eps,
                                            pad_to_multiple=self.pad_chi_multiple)
        self.trunc_err = max(self.trunc_err, err)
        Sinv = pinv(psi.Ss[i], cutoff=1e-14)
        psi.Bs[i] = scale_axis(scale_axis(A, Sinv, 'vL'), S, 'vR')
        psi.Ss[j] = S.relabelled(['vL', 'vL*'])
        psi.Bs[j] = B

    def sweep(self):
        """One second-order Trotter step: half even, full odd, half even."""
        L = self.psi.L
        last = L if self.psi.bc == 'infinite' else L - 1  # wrap-around bond of iTEBD
        for i in range(0, last, 2):
            self.update_bond(i, self.U_half[i])
        for i in range(1, last, 2):
            self.update_bond(i, self.U_full[i])
        for i in range(0, last, 2):
            self.update_bond(i, self.U_half[i])

    def run(self, n_steps: int, verbose: bool = False):
        for n in range(n_steps):
            self.sweep()
            if self.canonicalize_every and (n + 1) % self.canonicalize_every == 0:
                if self.psi.bc == 'infinite':
                    self.psi.canonicalize_infinite()
                else:
                    self.psi.canonicalize()
            if verbose and (n + 1) % 10 == 0:
                E = sum(np.real(self.psi.bond_expectation_value(h, i))
                        for i, h in enumerate(self.model.H_bonds))
                print(f'step {n + 1}: E = {E:.10f}, chi = {self.psi.max_chi()}')
        return self

    def energy(self) -> float:
        """Total energy (finite) or energy per site (infinite)."""
        e = float(sum(np.real(self.psi.bond_expectation_value(h, i))
                      for i, h in enumerate(self.model.H_bonds)))
        return e / self.psi.L if self.psi.bc == 'infinite' else e
