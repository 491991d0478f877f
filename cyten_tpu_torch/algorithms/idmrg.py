"""Infinite DMRG (iDMRG): a two-site unit cell, and an L-site one.

The counterpart of ``cyten_tpu/algorithms/idmrg.py``. McCulloch's infinite-size DMRG
(arXiv:0804.2509; Schollwoeck Ann. Phys. 326, 96 (2011), Sec. 10): each step inserts
two fresh sites at the centre of an ever-growing chain, optimizes their wavefunction
theta with Lanczos, grows the left/right environments by the new isometries, and
predicts the next centre wavefunction with the singular-value "rotation trick"

    theta_guess = S_new . B . pinv(S_old) . A . S_new .

The energy per site is the eigenvalue of the step over 2: after each step the eigenvalue
is subtracted from the left environment's Hamiltonian channel. At the fixed point the
centre wavefunction ``A S B`` is exactly canonical, so bond expectation values on it are
exact as well. :class:`MultiCellIDMRGEngine` optimizes an L-site window with two-site
sweeps between the accumulated environments instead (period-L Hamiltonians).

The environments live on the tensors' device, the boundary ones built there too; every
``tdot`` and ``compose`` on the abelian backend runs its block products as one
grouped-GEMM kernel launch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tensors import (
    SymmetricTensor, complex_conj, compose, inner, permute_legs, pinv, qr, scale_axis,
    tdot,
)
from ..tensors.krylov_based import lanczos
from .dmrg import DMRGEngine, HEffective, _update_LP_impl, _update_RP_impl
from .mps import SimpleMPS, split_truncate_theta

__all__ = ['iDMRGEngine', 'MultiCellIDMRGEngine']

#: iDMRG needs a well-converged local eigenstate each step: the finite engine's loose
#: defaults (N_max=20, no reortho) destabilize the fixed point once chi saturates
#: (``cyten_tpu`` measured the energy oscillating at the 1e-1 level; with these
#: settings it converges to 1e-14)
LANCZOS_OPTIONS = {'N_max': 100, 'N_min': 5, 'P_tol': 1e-14, 'reortho': True}


def _eye_block(V, w, channel: int, backend, dtype, codomain, domain, labels):
    """The tensor whose dense block is ``eye(V)`` in the public index ``channel`` of
    ``w`` (the axes ``[V, w, V]``), built on the backend's device."""
    D, nw = int(V.dim), int(w.dim)
    bb = backend.block_backend
    block = bb.zeros((D, nw, D), dtype)
    block[:, channel, :] = torch.eye(D, dtype=block.dtype, device=block.device)
    return SymmetricTensor.from_dense_block(block, codomain, domain, backend=backend,
                                            labels=labels, dtype=dtype)


def _boundary_environments(psi: SimpleMPS, H_mpo, backend):
    """eye(bond) times the unit vector in the MPO boundary channel: the first channel
    on the left, the last on the right. (The finite engine may use all-ones because its
    edge MPO tensors are boundary-selected to a single channel; a bulk MPO is not.)"""
    dtype = psi.Bs[0].dtype
    V0 = psi.Bs[0].get_leg_co_domain('vL')
    w0 = H_mpo[0].get_leg_co_domain('wL')
    LP = _eye_block(V0, w0, 0, backend, dtype, [V0], [V0, w0], [['vR*'], ['vR', 'wR']])
    VL = psi.Bs[-1].domain.factors[0]
    wL = H_mpo[-1].get_leg_co_domain('wR')
    RP = _eye_block(VL, wL, int(wL.dim) - 1, backend, dtype, [VL, wL], [VL],
                    [['vL', 'wL'], ['vL*']])
    return LP, RP


class _EyeAtChannel:
    """eye(bond) times the unit vector in the H channel (the last public index) of an
    LP's wR leg, kept for the last legs asked for."""

    def __init__(self, backend):
        self.backend = backend
        self.key = None
        self.value = None

    def __call__(self, LP) -> SymmetricTensor:
        V = LP.get_leg_co_domain('vR')
        w = LP.get_leg_co_domain('wR')
        key = (V, w, LP.dtype)
        if key != self.key:
            self.value = _eye_block(V, w, int(w.dim) - 1, self.backend, LP.dtype, [V],
                                    [V, w], [['vR*'], ['vR', 'wR']])
            self.key = key
        return self.value


def _check_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError('iDMRG with mesh=... is not ported yet')


class iDMRGEngine:
    """Infinite two-site DMRG.

    Parameters
    ----------
    psi : SimpleMPS with ``bc='infinite'`` and L == 2
        Initial unit cell (e.g. a product state); used as the first guess.
    model
        Built with ``bc='infinite'``: uniform bulk ``H_mpo`` (2 tensors) and one
        ``H_bonds`` entry per unit-cell bond. An MPO with couplings beyond nearest
        neighbours (``max_range > 1``) raises ``ValueError``.
    chi_max, eps, lanczos_options, pad_chi_multiple, matmul_precision
        As in :class:`~cyten_tpu_torch.algorithms.dmrg.DMRGEngine`; the Lanczos options
        default to :data:`LANCZOS_OPTIONS`. ``mesh`` is not ported yet and raises.

    After :meth:`run`, :attr:`psi` holds the converged unit cell in B form and
    ``energy_per_site`` the ground-state energy density.
    """

    def __init__(self, psi: SimpleMPS, model, chi_max: int = 32, eps: float = 1e-12,
                 lanczos_options: dict = None, pad_chi_multiple: int = None,
                 mesh=None, shard_axis_name: str = 'mult',
                 matmul_precision: str = None):
        _check_mesh(mesh)
        assert psi.bc == 'infinite', "iDMRG needs SimpleMPS(bc='infinite')"
        assert psi.L == 2, 'two-site unit cell for now'
        assert getattr(model, 'bc', 'finite') == 'infinite', \
            "iDMRG needs a model built with bc='infinite'"
        if getattr(model.H_mpo, 'max_range', 1) > 1:
            # cyten_tpu measured the McCulloch fixed point oscillating at the 1e-1
            # level when the MPO carries in-flight passthrough channels (range > 1
            # terms from mpo_from_terms): the 2-site insertion window never contains a
            # full term and the energy telescoping destabilizes
            raise ValueError(
                'iDMRGEngine does not support MPOs with couplings beyond nearest '
                'neighbors (in-flight channels); use finite DMRG with mpo_from_terms.')
        self.model = model
        self.chi_max = chi_max
        self.eps = eps
        self.pad_chi_multiple = pad_chi_multiple
        self.lanczos_options = lanczos_options or dict(LANCZOS_OPTIONS)
        self.backend = psi.backend
        self.shard_axis_name = shard_axis_name
        self.matmul_precision = matmul_precision
        # centre-site state: A (left-iso), B (right-iso), S (centre bond), S_prev
        # (outer bond = previous centre)
        self.A = None
        self.B = None
        self.S = psi.Ss[0]
        self.S_prev = psi.Ss[0]
        self._theta_guess = permute_legs(psi.get_theta2(0), codomain=['vL', 'p0', 'p1'],
                                         domain=['vR'])
        self._eye_at_channel = _EyeAtChannel(self.backend)
        self.LP, self.RP = self._init_environments(psi)
        self.E_window = None      # extensive energy of the growing window
        self.energy_per_site = None
        self.trunc_err = 0.
        self.n_steps = 0

    def _init_environments(self, psi):
        """The boundary environments of ``psi`` (:func:`_boundary_environments`)."""
        return _boundary_environments(psi, self.model.H_mpo, self.backend)

    def step(self) -> float:
        """Insert two sites, optimize, grow environments. Returns e/site (None at the
        first step).

        After each optimization the found eigenvalue is subtracted from the left
        environment's Hamiltonian channel, so the effective Hamiltonian stays O(1)
        instead of growing extensively (without it Lanczos conditioning degrades and the
        fixed point destabilizes once chi saturates)."""
        W0, W1 = self.model.H_mpo[0], self.model.H_mpo[1]
        Heff = HEffective(self.LP, self.RP, W0, W1, matmul_precision=self.matmul_precision)
        E, theta, n_iter = lanczos(Heff, self._theta_guess, self.lanczos_options)
        A, S_new, B, err = split_truncate_theta(theta, self.chi_max, self.eps,
                                                pad_to_multiple=self.pad_chi_multiple)
        self.trunc_err = max(self.trunc_err, err)
        LP = _update_LP_impl(self.LP, W0, A)
        # energy subtraction: LP_H <- LP_H - E * eye (H channel = last public wR index,
        # the MPO's "all terms completed" state)
        self.LP = LP - E * self._eye_at_channel(LP)
        self.RP = _update_RP_impl(self.RP, W1, B)
        # rotation trick: theta_guess = S_new . B . pinv(S_old) . A . S_new
        t = scale_axis(scale_axis(B, S_new, 'vL'), pinv(self.S, cutoff=1e-12), 'vR')
        t2 = scale_axis(A, S_new, 'vR')
        guess = tdot(t.relabelled({'p': 'p0'}), t2.relabelled({'p': 'p1'}), 'vR', 'vL')
        self._theta_guess = permute_legs(guess, codomain=['vL', 'p0', 'p1'],
                                         domain=['vR'])
        self.S_prev = self.S
        self.S = S_new
        self.A, self.B = A, B
        # with the subtraction, the eigenvalue IS the energy added by the two new sites
        # (relative to all previously subtracted energy)
        e_site = E / 2. if self.n_steps > 0 else None
        if e_site is not None:
            self.energy_per_site = e_site
        self.E_window = (self.E_window or 0.) + E
        self.n_steps += 1
        return e_site

    def run(self, n_steps: int = 300, tol: float = 1e-10, verbose: bool = False
            ) -> float:
        """Iterate until the energy per site converges; returns it."""
        e_old = np.inf
        for n in range(n_steps):
            e = self.step()
            if verbose and e is not None:
                print(f'step {self.n_steps}: e/site = {e:.12f}, '
                      f'chi = {int(self.S.leg.dim)}')
            if e is not None and abs(e - e_old) < tol:
                break
            e_old = e if e is not None else np.inf
        return self.energy_per_site

    def bond_energy(self) -> float:
        """<theta| h_bond |theta> on the (exactly canonical) centre bond."""
        theta = self.theta_center()
        op = self.model.H_bonds[0].relabelled(['p0', 'p1', 'p1*', 'p0*'])
        thp = permute_legs(theta, codomain=['p0', 'p1'], domain=['vL', 'vR'])
        op_th = permute_legs(compose(op, thp), codomain=['vL', 'p0', 'p1'],
                             domain=['vR'])
        return float(np.real(inner(theta, op_th, do_dagger=True)))

    def theta_center(self) -> SymmetricTensor:
        """The centre two-site wavefunction ``A . S . B`` (normalized)."""
        t = scale_axis(self.A, self.S, 'vR').relabelled({'p': 'p0'})
        th = tdot(t, self.B.relabelled({'p': 'p1'}), 'vR', 'vL')
        return permute_legs(th, codomain=['vL', 'p0', 'p1'], domain=['vR'])

    @property
    def psi(self) -> SimpleMPS:
        """The current unit cell as an infinite MPS in B form.

        ``Bs = [pinv(S_prev) A S, B]``, ``Ss = [S_prev, S]``: exactly canonical at the
        iDMRG fixed point (where S_prev == S up to the half-cell shift).
        """
        # relative-tail cutoff: directions with S_prev < 1e-8 carry negligible state
        # weight but their inverses would destroy B0's isometry (cyten_tpu measured an
        # isometry error of 1e3 at cutoff 1e-12, a clean transfer spectrum at 1e-8)
        B0 = scale_axis(scale_axis(self.A, pinv(self.S_prev, cutoff=1e-8), 'vL'),
                        self.S, 'vR')
        return SimpleMPS([B0, self.B], [self.S_prev.relabelled(['vL', 'vL*']),
                                        self.S.relabelled(['vL', 'vL*'])], bc='infinite')


def _diag_phases(T, labels):
    """The phases of the diagonal of a square tensor, as a DiagonalTensor (zero
    diagonal entries map to phase 1). Goes through ``T.diagonal()`` and the elementwise
    machinery, so it works on dense (no-symmetry), abelian and fusion-tree storage
    alike; a complex block stays complex."""
    def func(blk):
        mag = torch.abs(blk)
        live = mag > 1e-300
        return torch.where(live, blk / torch.where(live, mag, 1.), torch.ones_like(blk))

    d = T.diagonal()._elementwise_unary(func)
    d.labels = labels
    return d


def _fix_qr_phases(Q, R):
    """Make R's diagonal real-positive (absorbing phases into Q).

    For an exactly B-canonical input, the sign-fixed QR of ``S_i B_i`` reproduces the
    canonical ``A_i`` and ``R == S_{i+1}`` exactly, so environments absorbed from Q
    match the window's own gauge."""
    D = _diag_phases(R, [R.labels[0], f'{R.labels[0]}*'])
    Dc = complex_conj(D) if R.dtype.is_complex else D
    return scale_axis(Q, D, -1), scale_axis(R, Dc, 0)


class MultiCellIDMRGEngine:
    """Infinite DMRG with an L-site unit cell (L even; period-L Hamiltonians).

    Each step optimizes an L-site window with finite-DMRG two-site sweeps between the
    accumulated environments (a :class:`~cyten_tpu_torch.algorithms.dmrg.DMRGEngine`
    made by its ``_window`` constructor), absorbs the left/right half cells, subtracts
    the window energy from the left environment's Hamiltonian channel, and predicts the
    next window with the McCulloch rotation trick (the chain grows by L sites per step;
    the cell register advances by L/2, handled by cycling the MPO assignment). Reduces
    to :class:`iDMRGEngine`'s physics for L == 2. ``mesh`` is not ported yet and raises.
    """

    def __init__(self, psi: SimpleMPS, model, chi_max: int = 32,
                 eps: float = 1e-12, lanczos_options: dict = None,
                 n_inner_sweeps: int = 2, pad_chi_multiple: int = None,
                 mesh=None, shard_axis_name: str = 'mult',
                 matmul_precision: str = None):
        _check_mesh(mesh)
        assert psi.bc == 'infinite'
        L = psi.L
        assert L % 2 == 0 and L >= 2
        assert len(model.H_mpo) == L
        self.L = L
        self.model = model
        self.chi_max = chi_max
        self.eps = eps
        self.pad_chi_multiple = pad_chi_multiple
        self.n_inner_sweeps = n_inner_sweeps
        self.shard_axis_name = shard_axis_name
        self.matmul_precision = matmul_precision
        self.lanczos_options = lanczos_options or dict(LANCZOS_OPTIONS)
        self.backend = psi.backend
        self.offset = 0        # cell register: window site k has type (offset+k)%L
        self.win_Bs = list(psi.Bs)
        self.win_Ss = list(psi.Ss)
        self._eye_at_channel = _EyeAtChannel(self.backend)
        self.LP, self.RP = _boundary_environments(psi, model.H_mpo, self.backend)
        self.E_prev = None
        self.energy_per_site = None
        self.trunc_err = 0.
        self.n_steps = 0

    def _window_engine(self) -> DMRGEngine:
        H_mpo = [self.model.H_mpo[(self.offset + k) % self.L] for k in range(self.L)]
        psi = SimpleMPS(list(self.win_Bs), list(self.win_Ss), bc='finite')
        return DMRGEngine._window(psi, H_mpo, self.LP, self.RP, self.chi_max, self.eps,
                                  self.lanczos_options, self.pad_chi_multiple,
                                  self.matmul_precision)

    def step(self) -> float:
        L = self.L
        eng = self._window_engine()
        for _ in range(self.n_inner_sweeps):
            E = eng.sweep()
        self.trunc_err = max(self.trunc_err, eng.trunc_err)
        psi_w = eng.psi
        # left-isometric tensors of the window by an exact QR left-canonicalization
        # sweep, not pinv gauge-stripping, whose 1/S noise amplification destabilizes
        # the fixed point once chi saturates
        As = []
        C = psi_w.Ss[0].as_SymmetricTensor().relabelled(['vL', 'vR'])
        for i in range(L // 2):
            M = tdot(C, psi_w.Bs[i], 'vR', 'vL')
            M = permute_legs(M, codomain=['vL', 'p'], domain=['vR'])
            A_i, C = qr(M, new_labels=['vR', 'vL'])
            A_i, C = _fix_qr_phases(A_i, C)  # gauge-match the window's B form
            As.append(A_i)
        LP = self.LP
        for k in range(L // 2):
            LP = _update_LP_impl(LP, self.model.H_mpo[(self.offset + k) % L], As[k])
        # energy subtraction keeps Heff O(1) (see iDMRGEngine.step)
        self.LP = LP - E * self._eye_at_channel(LP)
        RP = self.RP
        for k in range(L - 1, L // 2 - 1, -1):
            RP = _update_RP_impl(RP, self.model.H_mpo[(self.offset + k) % L],
                                 psi_w.Bs[k])
        self.RP = RP
        # rotation trick: next window = [right half (B form)] + [left half, re-gauged
        # through the translated Schmidt values]
        Ss_w = [psi_w.Ss[i] for i in range(L)]
        new_Ss = [Ss_w[(L // 2 + k) % L] for k in range(L)]
        new_Bs = list(psi_w.Bs[L // 2:])
        for k in range(L // 2):
            S_left = new_Ss[L // 2 + k]
            S_right = new_Ss[(L // 2 + k + 1) % L] if k < L // 2 - 1 else Ss_w[L // 2]
            new_Bs.append(scale_axis(scale_axis(As[k], pinv(S_left, cutoff=1e-10), 'vL'),
                                     S_right, 'vR'))
        self.win_Bs = new_Bs
        self.win_Ss = new_Ss
        self.offset = (self.offset + L // 2) % L
        e_site = None
        if self.n_steps > 0:
            e_site = float(E) / L
            self.energy_per_site = e_site
        self.E_prev = E
        self.n_steps += 1
        return e_site

    def run(self, n_steps: int = 200, tol: float = 1e-10,
            verbose: bool = False) -> float:
        e_old = np.inf
        for n in range(n_steps):
            e = self.step()
            if verbose and e is not None:
                print(f'step {self.n_steps}: e/site = {e:.12f}, '
                      f'chi = {int(self.win_Ss[0].leg.dim)}')
            if e is not None and abs(e - e_old) < tol:
                break
            e_old = e if e is not None else np.inf
        return self.energy_per_site

    @property
    def psi(self) -> SimpleMPS:
        """The converged unit cell (site types 0..L-1) as an infinite MPS."""
        L = self.L
        r = (-self.offset) % L  # roll the window so site 0 has type 0
        Bs = [self.win_Bs[(r + k) % L] for k in range(L)]
        Ss = [self.win_Ss[(r + k) % L] for k in range(L)]
        return SimpleMPS(Bs, [s.relabelled(['vL', 'vL*']) for s in Ss], bc='infinite')
