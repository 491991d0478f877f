"""Tensor-network algorithms: finite and infinite MPS, the Heisenberg, transverse-field
Ising and spin-S chains, the Fermi-Hubbard and Kitaev chains, the Fibonacci golden chain,
the MPO builders, two-site DMRG (host-driven or static), one-site DMRG with subspace
expansion, infinite DMRG (two-site and multi-site unit cells), and time evolution: TEBD
(finite and infinite), TDVP (one-site, two-site, QR-split, fused), iTDVP, and VUMPS for
uniform ground states.

The counterpart of ``cyten_tpu/algorithms/`` for the main path
``HeisenbergModel -> SimpleMPS -> DMRGEngine.run`` (with excited states, checkpoints,
resume and rollback, and the finite MPS's measurements) and its anyonic form
``GoldenChainModel -> SimpleMPS.from_fusion_pairs -> DMRGEngine``.
"""

from .mps import SimpleMPS, split_truncate_theta
from .models import (
    FermiHubbardModel, GoldenChainModel, HeisenbergModel, KitaevChainModel, MpoTensors,
    SpinChainModel, TFIModel,
    heisenberg_exact_finite_gs_energy, mpo_from_bond_op, mpo_from_bond_ops,
    mpo_from_terms, spin_half_site, tfi_exact_finite_gs_energy,
    tfi_exact_infinite_gs_energy,
)
from .dmrg import (
    DMRGEngine, FaultError, HEffective, PlanarDMRGEngine, PlanarHEffective,
)
from .dmrg1 import DMRG1SEngine, HEffective1
from .idmrg import MultiCellIDMRGEngine, iDMRGEngine
from .itdvp import iTDVPEngine
from .tebd import TEBDEngine
from .tdvp import TDVP2Engine, TDVPEngine, TDVPQREngine
from .vumps import VUMPSEngine

__all__ = ['SimpleMPS', 'split_truncate_theta', 'FermiHubbardModel', 'GoldenChainModel',
           'HeisenbergModel', 'KitaevChainModel', 'MpoTensors', 'SpinChainModel', 'TFIModel',
           'mpo_from_bond_ops', 'mpo_from_terms',
           'heisenberg_exact_finite_gs_energy', 'tfi_exact_finite_gs_energy',
           'tfi_exact_infinite_gs_energy',
           'mpo_from_bond_op', 'spin_half_site', 'DMRGEngine', 'FaultError', 'HEffective',
           'PlanarDMRGEngine', 'PlanarHEffective', 'DMRG1SEngine', 'HEffective1',
           'iDMRGEngine', 'MultiCellIDMRGEngine', 'iTDVPEngine', 'TEBDEngine',
           'TDVPEngine', 'TDVP2Engine', 'TDVPQREngine', 'VUMPSEngine']
