"""Tensor-network algorithms: finite MPS, the Heisenberg chain and two-site DMRG.

The counterpart of ``cyten_tpu/algorithms/`` for the main path
``HeisenbergModel -> SimpleMPS -> DMRGEngine.run``.
"""

from .mps import SimpleMPS, split_truncate_theta
from .models import (
    HeisenbergModel, heisenberg_exact_finite_gs_energy, mpo_from_bond_op, spin_half_site,
)
from .dmrg import DMRGEngine, FaultError, HEffective

__all__ = ['SimpleMPS', 'split_truncate_theta', 'HeisenbergModel',
           'heisenberg_exact_finite_gs_energy', 'mpo_from_bond_op', 'spin_half_site',
           'DMRGEngine', 'FaultError', 'HEffective']
