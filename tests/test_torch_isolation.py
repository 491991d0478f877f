"""The PyTorch port stands alone: it imports neither JAX nor cyten_tpu (every module,
the bench, static mode, checkpoints, excited states, the models layer, one-site DMRG,
the infinite chain and time evolution included), nor
h5py or orbax for its checkpoints, and without CUDA its default device raises instead of
running on the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = """
import sys
import cyten_tpu_torch
import cyten_tpu_torch.bench
import cyten_tpu_torch.blocks.probe
import cyten_tpu_torch.tensors.steady
import cyten_tpu_torch.tools.flops
from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS, TFIModel
from cyten_tpu_torch.bench import (
    build_dense_workload, build_hubbard_workload, build_padded_workload, main,
    matvec_run, matvec_traffic_bytes, measured_hbm_gbps, measured_peak_tflops,
    step_roofline, svd_growth_timing,
)
assert TFIModel(L=2, conserve='None', bc='infinite', device='cpu').exact_infinite_gs_energy() < 0
assert matvec_run(8, (1, 2), 1, builder=build_dense_workload, device='cpu') > 0
model = HeisenbergModel(L=4, conserve='Sz', device='cpu')
psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
eng = DMRGEngine(psi, model, chi_max=8)
E = eng.run(n_sweeps=2)
assert abs(E - (-1.6160254037844384)) < 1e-9, E
eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
E = eng.sweep()
assert abs(E - (-1.6160254037844384)) < 1e-9, E
# checkpoints (torch.save alone) and excited states
import tempfile
import cyten_tpu_torch.tensors.sparse
import cyten_tpu_torch.tools.checkpoint
import cyten_tpu_torch.tools.hdf5_io
import cyten_tpu_torch.tools.math
from cyten_tpu_torch.algorithms import PlanarDMRGEngine
from cyten_tpu_torch.tools.checkpoint import CheckpointManager
with tempfile.TemporaryDirectory() as d:
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
    E0 = PlanarDMRGEngine(psi, model, chi_max=8).run(n_sweeps=2, checkpoint=d)
    assert CheckpointManager(d).latest_step() == 2
    assert abs(CheckpointManager(d).restore(device='cpu')['E'] - E0) == 0
psi1 = SimpleMPS.from_product_state(model.site_legs, [1, 0, 1, 0], backend=model.backend)
E1 = DMRGEngine(psi1, model, chi_max=8, orthogonal_to=[psi]).run(n_sweeps=4)
assert E1 > E0 + 0.1 and abs(psi1.overlap(psi)) < 1e-8, (E0, E1)
# the models layer: sites, couplings, CouplingModel and mpo_from_terms into DMRG, and
# the interop functions that carry an MPO and a coupling over
import cyten_tpu_torch.models.tenpy_models
from cyten_tpu_torch.algorithms import SpinChainModel, mpo_from_terms
from cyten_tpu_torch.models import CouplingModel, SpinHalfSite, heisenberg_coupling
from cyten_tpu_torch.tools.interop import coupling_from_arrays, mpo_from_arrays
sites = [SpinHalfSite('Sz', device='cpu')] * 4
cm = CouplingModel(sites)
for i in range(3):
    cm.add_coupling(i, heisenberg_coupling(sites[i:i + 2]))
psi = SimpleMPS.from_product_state([s.leg for s in sites], [0, 1, 0, 1],
                                   backend=sites[0].backend)
class M:
    H_mpo = cm.build_H_mpo()
E = DMRGEngine(psi, M(), chi_max=8).run(n_sweeps=2)
assert abs(E - (-1.6160254037844384)) < 1e-9, E
assert len(SpinChainModel(L=4, S=1., device='cpu').H_mpo) == 4
h = cm.bond_terms[0][1].to_tensor()
assert mpo_from_terms([s.leg for s in sites], couplings=[(0, 2, h)]).max_range == 2
assert mpo_from_arrays and coupling_from_arrays
# one-site DMRG, and the infinite chain: iDMRG, the multi-cell engine, the canonical
# forms and the correlation length (scipy's ARPACK, no JAX)
import cyten_tpu_torch.algorithms.dmrg1
import cyten_tpu_torch.algorithms.idmrg
from cyten_tpu_torch.algorithms import DMRG1SEngine, MultiCellIDMRGEngine, iDMRGEngine
psi = SimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1], backend=model.backend)
E = DMRG1SEngine(psi, model, chi_max=8, alpha=1e-2, mixer='density_matrix').run(n_sweeps=3)
assert abs(E - (-1.6160254037844384)) < 1e-9, E
tfi = TFIModel(L=2, g=1.5, conserve='parity', bc='infinite', device='cpu')
psi = SimpleMPS.from_product_state(tfi.site_legs, [0, 0], backend=tfi.backend, bc='infinite')
eng = iDMRGEngine(psi, tfi, chi_max=8)
eng.run(n_steps=20)
psi = eng.psi.canonicalize_infinite()
assert psi.correlation_length() > 1. and psi.enlarge_unit_cell(2).L == 4
heis = HeisenbergModel(L=2, conserve='Sz', bc='infinite', device='cpu')
psi = SimpleMPS.from_product_state(heis.site_legs, [0, 1], backend=heis.backend,
                                   bc='infinite')
assert MultiCellIDMRGEngine(psi, heis, chi_max=4).run(n_steps=2) < 0
# time evolution: the Krylov propagators, TEBD, TDVP (fused too), iTDVP, VUMPS
import cyten_tpu_torch.algorithms.itdvp
import cyten_tpu_torch.algorithms.tdvp
import cyten_tpu_torch.algorithms.tebd
import cyten_tpu_torch.algorithms.vumps
from cyten_tpu_torch.algorithms import (
    TDVP2Engine, TDVPEngine, TDVPQREngine, TEBDEngine, VUMPSEngine, iTDVPEngine,
)
from cyten_tpu_torch.tensors import Arnoldi, LanczosEvolution, lanczos_arpack
chain = TFIModel(L=4, g=1.5, conserve='parity', device='cpu')
psi = SimpleMPS.from_product_state(chain.site_legs, [0] * 4, backend=chain.backend)
opts = {'lanczos_options': {'N_max': 6}}
TEBDEngine(psi, chain, dt=0.1, chi_max=4, imaginary=False).run(1)
TDVP2Engine(psi, chain, dt=0.05, chi_max=4, **opts).run(1)
TDVPEngine(psi, chain, dt=0.05, **opts).run(1)
E = TDVPQREngine(psi, chain, dt=0.05, fused=True, **opts).run(1).energy()
assert abs(psi.norm_squared() - 1.) < 1e-10 and E < 0
cell = eng.psi
itdvp = iTDVPEngine(cell, tfi, dt=0.05, imaginary=True, canonical_tol=1e-2,
                    env_max_iter=10, **opts).run(1)
assert itdvp.energy_density() < 0
assert VUMPSEngine(cell, tfi, env_max_iter=10, **opts).step() < 1.
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'cyten_tpu', 'h5py', 'orbax'))
print('LEAKED', leaked)
"""


def test_port_runs_without_jax_or_cyten_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LEAKED []' in res.stdout, res.stdout


def test_no_source_file_imports_jax_or_cyten_tpu():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|cyten_tpu|orbax)(\.|\s|$)', re.M)
    files = list((REPO / 'cyten_tpu_torch').rglob('*.py')) + [REPO / 'chip_smoke.py']
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from cyten_tpu_torch import get_backend, get_block_backend, u1_symmetry
    from cyten_tpu_torch.algorithms import HeisenbergModel

    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_block_backend('torch')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_backend(u1_symmetry)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        HeisenbergModel(L=4, conserve='Sz')
    # an explicit CPU request is honoured
    assert str(get_backend(u1_symmetry, device='cpu').block_backend.device) == 'cpu'


def test_models_default_device_raises_without_cuda():
    """The models layer's entry points (a site, a model, mpo_from_terms) put their
    tensors on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    import numpy as np

    from cyten_tpu_torch.algorithms import SpinChainModel, mpo_from_terms, spin_half_site
    from cyten_tpu_torch.models import (
        ClockSite, GoldenChain, GoldenSite, SpinlessBosonSite, SpinSite, TFIModel,
    )

    for entry in (lambda: SpinSite(1, 'Sz'), lambda: SpinSite(0.5, 'SU(2)'),
                  lambda: ClockSite(3, 'Z'), lambda: SpinlessBosonSite(2, 'N'),
                  GoldenSite, lambda: SpinChainModel(L=4, S=1.), lambda: TFIModel(4),
                  lambda: GoldenChain(3),
                  lambda: mpo_from_terms([spin_half_site('Sz')] * 3,
                                         couplings=[(0, 2, np.eye(4))])):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            entry()
    site = SpinSite(1, 'Sz', device='cpu')
    assert str(site.get_op('Sp').backend.block_backend.device) == 'cpu'
    mpo = mpo_from_terms([spin_half_site('Sz')] * 3, couplings=[(0, 2, np.eye(4))],
                         device='cpu')
    assert str(mpo[0].backend.block_backend.device) == 'cpu'
    assert str(SpinChainModel(L=3, device='cpu').backend.block_backend.device) == 'cpu'


_SU2_SCRIPT = """
import sys
import cyten_tpu_torch.backends.fusion_tree
import cyten_tpu_torch.backends.tree_moves
import cyten_tpu_torch.symmetries.su2_data
import cyten_tpu_torch.symmetries.trees
from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS
from cyten_tpu_torch.bench import build_su2_workload, su2_run
model = HeisenbergModel(L=4, conserve='SU(2)', device='cpu')
psi = SimpleMPS.from_singlet_pairs(model.site_leg, 4, backend=model.backend)
eng = DMRGEngine(psi, model, chi_max=8)
E = eng.run(n_sweeps=2)
assert abs(E - (-1.6160254037844384)) < 1e-9, E
eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
E = eng.sweep()
assert abs(E - (-1.6160254037844384)) < 1e-9, E
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'cyten_tpu'))
print('LEAKED', leaked)
"""


def test_su2_path_runs_without_jax_or_cyten_tpu():
    """The fusion-tree modules and the SU(2) DMRG path, dynamic and static."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', _SU2_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LEAKED []' in res.stdout, res.stdout


def test_fusion_tree_backend_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from cyten_tpu_torch import get_backend, su2_symmetry
    from cyten_tpu_torch.algorithms import HeisenbergModel
    from cyten_tpu_torch.backends import FusionTreeBackend

    with pytest.raises(RuntimeError, match='no CUDA device'):
        get_backend(su2_symmetry)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        HeisenbergModel(L=4, conserve='SU(2)')
    backend = get_backend(su2_symmetry, device='cpu')
    assert isinstance(backend, FusionTreeBackend)
    assert str(backend.block_backend.device) == 'cpu'


_FERMION_SCRIPT = """
import sys
import cyten_tpu_torch.symmetries.fermions
from cyten_tpu_torch import FermionNumber, FermionParity, fermion_number, fermion_parity
from cyten_tpu_torch.algorithms import (
    DMRGEngine, FermiHubbardModel, KitaevChainModel, SimpleMPS,
)
from cyten_tpu_torch.models import (
    FermionicDOF, SpinHalfFermionSite, SpinlessFermionSite, hopping, onsite_pairing,
    pairing,
)
model = FermiHubbardModel(L=4, device='cpu')
psi = SimpleMPS.from_product_state(model.site_legs, [1, 2, 1, 2], backend=model.backend)
E = DMRGEngine(psi, model, chi_max=16, eps=1e-14).run(n_sweeps=1)
assert E < 0, E
assert len(KitaevChainModel(L=4, device='cpu').H_mpo) == 4
leaked = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'cyten_tpu'))
print('LEAKED', leaked)
"""


def test_fermionic_path_runs_without_jax_or_cyten_tpu():
    """The fermionic symmetries, sites, couplings and models, and one Hubbard DMRG
    sweep on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', _FERMION_SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'LEAKED []' in res.stdout, res.stdout


def test_fermion_models_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    from cyten_tpu_torch.algorithms import FermiHubbardModel, KitaevChainModel
    from cyten_tpu_torch.models import SpinHalfFermionSite, SpinlessFermionSite

    for entry in (lambda: FermiHubbardModel(2), lambda: KitaevChainModel(2),
                  lambda: SpinlessFermionSite('N'), lambda: SpinHalfFermionSite()):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            entry()
    model = FermiHubbardModel(2, device='cpu')
    assert str(model.backend.block_backend.device) == 'cpu'
