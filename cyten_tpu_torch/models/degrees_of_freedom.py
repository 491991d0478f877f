"""Sites (local Hilbert spaces with named operators) and degree-of-freedom builders.

The counterpart of ``cyten_tpu/models/degrees_of_freedom.py``: ``Site`` (:25),
``SpinDOF`` (:124), ``OccupationDOF`` (:144), ``BosonicDOF`` (:159), ``FermionicDOF``
(:163), ``ClockDOF`` (:195) and ``AnyonDOF`` (:206).

A :class:`Site` couples a leg (the local Hilbert space with its conserved symmetry)
to the dictionary of *symmetric* onsite operators. Which operators exist depends on
the conserved symmetry: ``Sx`` only exists without conservation, ``Sp`` becomes a
:class:`ChargedTensor` under U(1). The operators live on ``device`` (default: the
CUDA card) unless a ``backend`` is given.
"""

from __future__ import annotations

import numpy as np

from ..dtypes import Dtype
from ..symmetries import ElementarySpace
from ..tensors import ChargedTensor, SymmetricTensor

__all__ = ['Site', 'SpinDOF', 'OccupationDOF', 'BosonicDOF', 'FermionicDOF', 'ClockDOF',
           'AnyonDOF']


class Site:
    """A local Hilbert space: a leg, named onsite operators, and state labels.

    Operators are stored as :class:`SymmetricTensor` (codomain ``[p]``, domain
    ``[p]``) or, for charge-raising/-lowering operators, as :class:`ChargedTensor`.
    """

    def __init__(self, leg: ElementarySpace, backend=None, state_labels=None,
                 device: str = None, **ops):
        from ..backends import get_backend

        self.leg = leg
        self.symmetry = leg.symmetry
        self.backend = backend if backend is not None else \
            get_backend(leg.symmetry, device=device)
        self.dim = int(leg.dim) if leg.symmetry.can_be_dropped else leg.dim
        self.state_labels = dict(state_labels or {})
        self.ops: dict = {}
        self.add_operator('Id', np.eye(int(leg.dim))
                          if leg.symmetry.can_be_dropped else 'eye')
        for name, op in ops.items():
            if op is None:
                continue
            self.add_operator(name, op)

    def add_operator(self, name: str, op, allow_charged: bool = True):
        """Add an onsite operator (dense array, SymmetricTensor, or ChargedTensor).

        Dense arrays are projected; if not symmetric, a charged version is built
        when the dense operator maps between sectors with a unique charge shift.
        """
        if isinstance(op, (SymmetricTensor, ChargedTensor)):
            self.ops[name] = op
            return op
        if isinstance(op, str) and op == 'eye':
            from ..tensors import DiagonalTensor

            t = DiagonalTensor.from_eye(self.leg, backend=self.backend,
                                        labels=['p', 'p*']).as_SymmetricTensor()
            self.ops[name] = t
            return t
        op = np.asarray(op)
        try:
            t = SymmetricTensor.from_dense_block(
                op, [self.leg], [self.leg], backend=self.backend,
                labels=['p', 'p*'], tol=1e-8)
            self.ops[name] = t
            return t
        except ValueError:
            if not allow_charged:
                raise
        charge = self._infer_charge(op)
        if charge is None:
            raise ValueError(f'operator {name!r} is neither symmetric nor '
                             f'single-charge')
        t = ChargedTensor.from_dense_block(op, [self.leg], [self.leg],
                                           charge=charge, backend=self.backend,
                                           labels=['p', 'p*'], tol=1e-8)
        self.ops[name] = t
        return t

    def _infer_charge(self, op: np.ndarray):
        """The unique sector q with <i| op |j> != 0 => sector(i) = sector(j) + q."""
        sym = self.symmetry
        if not sym.can_be_dropped or not sym.is_abelian:
            return None
        sectors = self.leg.sectors_of_basis
        charge = None
        for i, j in zip(*np.nonzero(np.abs(op) > 1e-14)):
            q = sym.multiple_fusion(sectors[i], sym.dual_sector(sectors[j]))
            if charge is None:
                charge = q
            elif not np.all(charge == q):
                return None
        return charge

    def get_op(self, name: str):
        return self.ops[name]

    def has_op(self, name: str) -> bool:
        return name in self.ops

    def state_index(self, label) -> int:
        if isinstance(label, str):
            return self.state_labels[label]
        return int(label)

    def get_op_numpy(self, name: str) -> np.ndarray:
        return self.ops[name].to_numpy()

    def __repr__(self):
        return (f'<{type(self).__name__}: dim={self.dim}, '
                f'symmetry={self.symmetry!s}, ops={sorted(self.ops)}>')


# --- degree-of-freedom operator builders (plain numpy; conserve-independent) ----------


class SpinDOF:
    """Spin-S operator algebra."""

    @staticmethod
    def spin_ops(S: float) -> dict:
        d = int(round(2 * S + 1))
        if abs(2 * S + 1 - d) > 1e-12:
            raise ValueError(f'S must be (half-)integer, got {S}')
        m = S - np.arange(d)  # basis ordered m = +S ... -S
        Sz = np.diag(m)
        # Sp |m> = sqrt(S(S+1) - m(m+1)) |m+1>
        off = np.sqrt(S * (S + 1) - m[1:] * (m[1:] + 1))
        Sp = np.zeros((d, d))
        Sp[np.arange(d - 1), np.arange(1, d)] = off
        Sm = Sp.T.copy()
        Sx = 0.5 * (Sp + Sm)
        Sy = -0.5j * (Sp - Sm)
        return {'Sz': Sz, 'Sp': Sp, 'Sm': Sm, 'Sx': Sx, 'Sy': Sy,
                'Sz2': Sz @ Sz}


class OccupationDOF:
    """Number-operator algebra of one species with occupations 0..n_max."""

    @staticmethod
    def occupation_ops(n_max: int) -> dict:
        d = n_max + 1
        n = np.arange(d)
        N = np.diag(n.astype(float))
        B = np.zeros((d, d))  # annihilator
        B[np.arange(d - 1), np.arange(1, d)] = np.sqrt(n[1:])
        Bd = B.T.copy()
        return {'N': N, 'B': B, 'Bd': Bd, 'NN': N @ N,
                'dN': N - 0.5 * np.eye(d)}


class BosonicDOF(OccupationDOF):
    """Bosonic creation/annihilation with capped occupation."""


class FermionicDOF:
    """Fermionic operators. The statistics between sites come from the braids of a
    graded symmetry; within a site, Jordan-Wigner strings order the species."""

    @staticmethod
    def fermion_ops() -> dict:
        C = np.array([[0., 1.], [0., 0.]])  # |0>, |1> basis
        return {'C': C, 'Cd': C.T.copy(), 'N': np.diag([0., 1.]),
                'JW': np.diag([1., -1.])}

    @staticmethod
    def get_annihilator_numpy(ops: dict, species: int, n_species: int,
                              include_JW: bool = True) -> np.ndarray:
        """Annihilator of one species in a site of ``n_species`` (a kron over the
        species, in order), with the Jordan-Wigner string over the earlier species
        unless ``include_JW`` is False. ``ops`` is not read."""
        single = FermionicDOF.fermion_ops()
        res = np.eye(1)
        for s in range(n_species):
            if s < species:
                m = single['JW'] if include_JW else np.eye(2)
            else:
                m = single['C'] if s == species else np.eye(2)
            res = np.kron(res, m)
        return res


class ClockDOF:
    """q-state clock operators."""

    @staticmethod
    def clock_ops(q: int) -> dict:
        w = np.exp(2j * np.pi / q)
        Z = np.diag(w ** np.arange(q))
        X = np.roll(np.eye(q), 1, axis=0)  # X|k> = |k+1 mod q>
        return {'Z': Z, 'Zhc': Z.conj().T, 'X': X, 'Xhc': X.T.copy()}


class AnyonDOF:
    """Anyonic sites: operators are sector projectors built sector-wise."""

    @staticmethod
    def sector_projector(site_leg_pair, target_sector, backend, coeff=1.):
        """Two-site projector onto a given fusion channel, as a SymmetricTensor."""
        p0, p1 = site_leg_pair
        bb = backend.block_backend

        def func(shape, coupled):
            if np.all(np.asarray(coupled) == np.asarray(target_sector)):
                return coeff * bb.eye_matrix(shape[0], Dtype.float64)
            return bb.zeros(shape, Dtype.float64)

        return SymmetricTensor.from_sector_block_func(
            func, [p0, p1], [p0, p1], backend=backend,
            labels=['p0', 'p1', 'p1*', 'p0*'])
