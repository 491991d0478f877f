"""Physics model building blocks: sites, degrees of freedom, couplings.

The counterpart of ``cyten_tpu/models/``, under ``cyten_tpu.models``' names.
"""

from .degrees_of_freedom import (
    AnyonDOF, BosonicDOF, ClockDOF, FermionicDOF, OccupationDOF, Site, SpinDOF,
)
from . import sites
from . import couplings
from .sites import (
    AnyonSite, ClockSite, FibonacciAnyonSite, GoldenSite, IsingAnyonSite,
    SpinHalfFermionSite, SpinHalfSite, SpinlessBosonSite, SpinlessFermionSite, SpinSite,
    SU2kSpin1Site,
)
from .couplings import (
    Coupling, aklt_coupling, chemical_potential, chiral_3spin_coupling,
    clock_clock_coupling, clock_coupling, clock_field, clock_field_coupling,
    density_density_interaction, gold_coupling, heisenberg_coupling, hopping,
    onsite_interaction, onsite_pairing, pairing, sector_projection_coupling,
    spin_field_coupling, spin_spin_coupling,
)
from .tenpy_models import CouplingModel, GoldenChain, GoldenModel, TFIModel

__all__ = [
    'Site', 'SpinDOF', 'OccupationDOF', 'BosonicDOF', 'FermionicDOF', 'ClockDOF',
    'AnyonDOF',
    'sites', 'couplings', 'Coupling',
    'aklt_coupling', 'chemical_potential', 'chiral_3spin_coupling',
    'clock_clock_coupling', 'clock_coupling', 'clock_field', 'clock_field_coupling',
    'density_density_interaction', 'gold_coupling', 'heisenberg_coupling', 'hopping',
    'onsite_interaction', 'onsite_pairing', 'pairing', 'sector_projection_coupling',
    'spin_field_coupling', 'spin_spin_coupling',
    'SpinSite', 'SpinHalfSite', 'SpinlessBosonSite', 'SpinlessFermionSite',
    'SpinHalfFermionSite', 'ClockSite', 'AnyonSite',
    'FibonacciAnyonSite', 'IsingAnyonSite', 'GoldenSite', 'SU2kSpin1Site',
    'CouplingModel', 'TFIModel', 'GoldenModel', 'GoldenChain',
]
