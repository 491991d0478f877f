"""Physics model building blocks: sites, degrees of freedom, couplings.

The counterpart of ``cyten_tpu/models/`` without fermions (``FermionicDOF``, the two
fermion sites and ``hopping``, ``pairing``, ``onsite_pairing`` come with the port's
fermionic symmetries), under ``cyten_tpu.models``' names.
"""

from .degrees_of_freedom import (
    AnyonDOF, BosonicDOF, ClockDOF, OccupationDOF, Site, SpinDOF,
)
from . import sites
from . import couplings
from .sites import (
    AnyonSite, ClockSite, FibonacciAnyonSite, GoldenSite, IsingAnyonSite, SpinHalfSite,
    SpinlessBosonSite, SpinSite, SU2kSpin1Site,
)
from .couplings import (
    Coupling, aklt_coupling, chemical_potential, chiral_3spin_coupling,
    clock_clock_coupling, clock_coupling, clock_field, clock_field_coupling,
    density_density_interaction, gold_coupling, heisenberg_coupling,
    onsite_interaction, sector_projection_coupling, spin_field_coupling,
    spin_spin_coupling,
)
from .tenpy_models import CouplingModel, GoldenChain, GoldenModel, TFIModel

__all__ = [
    'Site', 'SpinDOF', 'OccupationDOF', 'BosonicDOF', 'ClockDOF', 'AnyonDOF',
    'sites', 'couplings', 'Coupling',
    'aklt_coupling', 'chemical_potential', 'chiral_3spin_coupling',
    'clock_clock_coupling', 'clock_coupling', 'clock_field', 'clock_field_coupling',
    'density_density_interaction', 'gold_coupling', 'heisenberg_coupling',
    'onsite_interaction', 'sector_projection_coupling', 'spin_field_coupling',
    'spin_spin_coupling',
    'SpinSite', 'SpinHalfSite', 'SpinlessBosonSite', 'ClockSite', 'AnyonSite',
    'FibonacciAnyonSite', 'IsingAnyonSite', 'GoldenSite', 'SU2kSpin1Site',
    'CouplingModel', 'TFIModel', 'GoldenModel', 'GoldenChain',
]
