"""cyten_tpu_torch: the PyTorch/CUDA port of cyten_tpu, for one NVIDIA H100.

Block-sparse symmetric tensors (no symmetry, abelian, and SU(2), fermions and anyons
on fusion trees) and two-site DMRG, written in PyTorch. The block-pair products of every abelian
``tdot``/``compose``, and of every fusion-tree ``compose``, run as one launch of a
hand-written CUDA grouped-GEMM kernel (``csrc/grouped_gemm.cu``). Entry
points put their tensors on the CUDA card unless the caller passes ``device='cpu'``;
without CUDA and without a device they raise.

The JAX package ``cyten_tpu`` is the reference this port is tested against; nothing
here imports it or JAX.
"""

from .config import config
from .dtypes import Dtype
from . import symmetries
from . import tools
from . import blocks
from . import backends
from . import tensors
from . import models
from . import algorithms
from .blocks import BlockBackend, get_block_backend
from .backends import TensorBackend, get_backend
from .symmetries import (
    SU2, U1, ZN, AbelianLegPipe, ElementarySpace, FermionNumber, FermionParity,
    FibonacciAnyonCategory, Leg, LegPipe, NoSymmetry, Sector, SectorArray, Space,
    Symmetry, SymmetryError, TensorProduct, fermion_number, fermion_parity,
    fibonacci_anyon_category, no_symmetry, su2_symmetry, u1_symmetry, z2_symmetry,
    z3_symmetry, z4_symmetry,
)
from .tensors import *  # noqa: F401,F403
from .models import Coupling, Site, couplings, sites

# the per-class HDF5 hooks (save_hdf5/from_hdf5) on every persistable class
from .tools.hdf5_io import _install_hdf5_hooks as _ih
_ih()
del _ih
