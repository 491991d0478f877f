"""Fermionic models and DMRG in the PyTorch port against cyten_tpu and exact answers.

``FermiHubbardModel`` and ``KitaevChainModel`` (``cyten_tpu_torch/algorithms/models.py``)
are held to cyten_tpu's: their bond operators dense and their MPOs by the operator
they represent, to 1e-12. One Hubbard bond update at L=6, on a state, MPO and environments the
port made and carried over to cyten_tpu by the persistence schema (numpy blocks), is
held to cyten_tpu's: the environment updates and the matvec to 1e-12 of their largest entry,
the static bond function's energy to 1e-10 and its tensors to 1e-9 of their largest
entry (as ``tests/test_torch_bench.py`` holds the Hubbard step). Whole DMRG runs of the
port are held to exact answers at 1e-9: Hubbard at L=4 in both fillings of
``tests/test_models.py:152-182`` (sector-resolved ED), Kitaev at L=8 (parity-resolved
ED and the BdG pair), spinless fermions with next-nearest hopping at L=6 from
``mpo_from_terms`` (the single-particle spectrum; hard-core bosons give another energy,
``tests/test_mpo_builder.py:87-120``), ``correlation_function`` of the free chain at
L=6 (the exact correlation matrix, ``tests/test_dmrg.py:222-258``) and the Ising-anyon
chain at L=8 (the ED built inside the framework, ``tests/test_anyonic_ed.py:17-80``).
"""

import functools

import jax
import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms.dmrg import HEffective as RefHEffective
from cyten_tpu.algorithms.dmrg import _get_static_bond_fn as ref_static_bond_fn
from cyten_tpu.algorithms.dmrg import _heff_matvec_impl as ref_matvec
from cyten_tpu.algorithms.dmrg import _update_LP_impl as ref_update_LP
from cyten_tpu.algorithms.dmrg import _update_RP_impl as ref_update_RP
from cyten_tpu.algorithms.models import FermiHubbardModel as RefFermiHubbardModel
from cyten_tpu.algorithms.models import KitaevChainModel as RefKitaevChainModel
from cyten_tpu.tools import hdf5_io as ref_io

from cyten_tpu_torch.algorithms import (
    DMRGEngine, FermiHubbardModel, KitaevChainModel, SimpleMPS, mpo_from_bond_op,
    mpo_from_terms,
)
from cyten_tpu_torch.algorithms.dmrg import (
    HEffective, _freeze_bond, _get_static_bond_fn, _heff_matvec_impl, _update_LP_impl,
    _update_RP_impl,
)
from cyten_tpu_torch.algorithms.models import bond_sum_ground_energy
from cyten_tpu_torch.models.couplings import hopping, sector_projection_coupling
from cyten_tpu_torch.models.sites import IsingAnyonSite, SpinlessFermionSite
from cyten_tpu_torch.tensors import SymmetricTensor, eigh, outer, permute_legs
from cyten_tpu_torch.tools import hdf5_io as io
from test_torch_excited import _retag, to_ref
from test_torch_interop import to_port

def _close(got, want, tol=1e-12):
    g, w = got.to_numpy(), np.asarray(want.to_numpy())
    assert got.labels == want.labels
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))


def dense_mpo(mpo):
    """The operator of an MPO (legs [wL, p, wR, p*], trivial outer legs) as a d^L x d^L
    matrix, site 0 slowest, contracted along the chain as dense arrays."""
    x = mpo[0].to_numpy()[0].transpose(0, 2, 1)  # [p, p*, wR]
    for W in mpo[1:]:
        w = W.to_numpy()
        R, C, _ = x.shape
        x = np.einsum('rcw,wpvq->rpcqv', x, w).reshape(R * w.shape[1], C * w.shape[3],
                                                       w.shape[2])
    return x[:, :, 0]


# --- the models against cyten_tpu ---------------------------------------------------------


@pytest.mark.parametrize('make', [
    lambda m, **kw: m(3, t=1., U=4., **kw),
    lambda m, **kw: m(2, t=0.8, U=2.5, conserve_N='parity', conserve_S='None', **kw),
], ids=['hubbard N Sz', 'hubbard parity'])
def test_hubbard_model_against_cyten_tpu(make):
    ref = make(RefFermiHubbardModel, block_backend='numpy')
    model = make(FermiHubbardModel, device='cpu')
    assert [(type(f).__name__, f.descriptive_name) for f in model.site_leg.symmetry.factors] \
        == [(type(f).__name__, f.descriptive_name) for f in ref.site_leg.symmetry.factors]
    for h, rh in zip(model.H_bonds, ref.H_bonds, strict=True):
        _close(h, rh)
    np.testing.assert_allclose(dense_mpo(model.H_mpo), dense_mpo(ref.H_mpo), atol=1e-12)
    assert abs(model.exact_finite_gs_energy() - ref.exact_finite_gs_energy()) < 1e-10


@pytest.mark.parametrize('conserve', ['parity', 'None'])
def test_kitaev_model_against_cyten_tpu(conserve):
    kw = dict(t=1., delta=0.6, mu=0.4, conserve=conserve)
    ref = RefKitaevChainModel(4, block_backend='numpy', **kw)
    model = KitaevChainModel(4, device='cpu', **kw)
    for h, rh in zip(model.H_bonds, ref.H_bonds, strict=True):
        _close(h, rh)
    np.testing.assert_allclose(dense_mpo(model.H_mpo), dense_mpo(ref.H_mpo), atol=1e-12)
    assert model.exact_finite_gs_energy() == ref.exact_finite_gs_energy()
    assert model.exact_finite_gs_energy('both') == ref.exact_finite_gs_energy('both')
    with pytest.raises(ValueError):
        model.exact_finite_gs_energy('even')
    with pytest.raises(ValueError):
        KitaevChainModel(4, conserve='N', device='cpu')


# --- one Hubbard bond update against cyten_tpu ---------------------------------------------


@pytest.fixture(scope='module')
def hubbard_states():
    """A Hubbard L=6 state after one sweep of the port (chi_max=4) with the port's
    MPO and environments, carried over to cyten_tpu by the persistence schema: the
    inputs of the comparisons below, in cyten_tpu (numpy blocks)."""
    old = ct.config.default_block_backend
    ct.config.default_block_backend = 'numpy'
    model = FermiHubbardModel(6, device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [1, 2] * 3, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=4, eps=1e-14)
    eng.sweep()
    eng.update_LP(0, psi.get_theta1(0))

    def ref(t):
        return ref_io.from_tree(_retag(io.to_tree(t)))

    yield ([ref(W) for W in model.H_mpo], to_ref(psi), {i: ref(eng.LPs[i]) for i in (0, 1)},
           {i: ref(eng.RPs[i]) for i in (2, 3, 4)})
    ct.config.default_block_backend = old


def port(t):
    return to_port(t, with_names=True)


def test_hubbard_environment_updates(hubbard_states):
    """With theta1 as A (a tensor of A's legs: the comparison needs no isometry)."""
    H_mpo, ref_psi, LPs, RPs = hubbard_states
    for i in (0, 1):
        W, A = H_mpo[i], ref_psi.get_theta1(i)
        _close(_update_LP_impl(port(LPs[i]), port(W), port(A)), ref_update_LP(LPs[i], W, A))
    for i in (3, 4):
        W, B = H_mpo[i], ref_psi.Bs[i]
        _close(_update_RP_impl(port(RPs[i]), port(W), port(B)), ref_update_RP(RPs[i], W, B))


def test_hubbard_matvec(hubbard_states):
    H_mpo, ref_psi, LPs, RPs = hubbard_states
    args = (LPs[1], RPs[2], H_mpo[1].relabelled({'p': 'p0', 'p*': 'p0*'}),
            H_mpo[2].relabelled({'p': 'p1', 'p*': 'p1*'}), ref_psi.get_theta2(1))
    _close(_heff_matvec_impl(*(port(t) for t in args)), ref_matvec(*args))


def test_hubbard_static_bond_fn(hubbard_states):
    """One steady static bond update (10 Lanczos iterations) at bond 1: cyten_tpu's runs
    unjitted on its numpy blocks (``jax.disable_jit``)."""
    H_mpo, ref_psi, LPs, RPs = hubbard_states
    i = 1
    parts = (LPs[i], RPs[i + 1], H_mpo[i], H_mpo[i + 1])
    H = HEffective(*(port(t) for t in parts))
    S, B1, B2 = ref_psi.Ss[i], ref_psi.Bs[i], ref_psi.Bs[i + 1]
    tmpl, _ = _freeze_bond(H, port(ref_psi.get_theta2(i)), port(B2).get_leg('vL'))
    got = _get_static_bond_fn(10, 'steady')(H, port(S), port(B1), port(B2), tmpl,
                                                    None)
    ref_tmpl = ref_io.from_tree(_retag(io.to_tree(tmpl)))
    with jax.disable_jit():
        want = ref_static_bond_fn(10, 'steady')(RefHEffective(*parts), S, B1, B2,
                                                        ref_tmpl, None)
    assert abs(float(got[0]) - float(want[0])) < 1e-10
    # new_B_i = S_i^-1 U S carries the sign of the Lanczos ground vector, which the
    # tridiagonal eigenvector leaves free (B, from Vh, is fixed by the warm start)
    sign = np.sign(np.vdot(got[1].to_numpy(), np.asarray(want[1].to_numpy())))
    _close(sign * got[1], want[1], tol=1e-9)
    for k in range(2, 6):  # S, B, LP, RP
        _close(got[k], want[k], tol=1e-9)


# --- whole runs against exact answers ----------------------------------------------------


@functools.lru_cache
def hubbard4(conserve_N='N', conserve_S='Sz'):
    return FermiHubbardModel(L=4, t=1., U=4., conserve_N=conserve_N, conserve_S=conserve_S,
                             device='cpu')


@pytest.mark.parametrize('state,sector', [([1, 2, 1, 2], [4, 0]), ([1, 2, 0, 0], [2, 0])],
                         ids=['half filling', 'quarter filling'])
def test_hubbard_dmrg_against_sector_ed(state, sector):
    model = hubbard4()
    psi = SimpleMPS.from_product_state(model.site_legs, state, backend=model.backend)
    E = DMRGEngine(psi, model, chi_max=64, eps=1e-14).run(n_sweeps=2)
    assert abs(E - model.exact_finite_gs_energy(sector)) < 1e-9


def test_kitaev_dmrg_against_parity_ed_and_bdg():
    """From the vacuum (even parity): the even sector's ED energy, one of the BdG
    pair."""
    L = 8
    model = KitaevChainModel(L, t=1., delta=0.6, mu=0.4, device='cpu')
    E_even = bond_sum_ground_energy(model.H_bonds, model.site_leg, L, [0])
    E_odd = bond_sum_ground_energy(model.H_bonds, model.site_leg, L, [1])
    pair = model.exact_finite_gs_energy('both')
    assert min(abs(np.array(pair) - E_even)) < 1e-10
    assert min(abs(np.array(pair) - E_odd)) < 1e-10
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    E = DMRGEngine(psi, model, chi_max=16, eps=1e-14).run(n_sweeps=2)
    assert abs(E - E_even) < 1e-9


def test_next_nearest_hopping_against_single_particle_spectrum():
    """The odd passthrough sector of mpo_from_terms carries the Jordan-Wigner string of
    the t2 hopping: DMRG gives the free-fermion energy."""
    L, t1, t2 = 6, 1.0, 0.6
    site = SpinlessFermionSite('N', device='cpu')
    h1 = hopping([site, site], t=t1).to_tensor()
    h2 = hopping([site, site], t=t2).to_tensor()
    mpo = mpo_from_terms([site.leg] * L, couplings=[(i, i + 1, h1) for i in range(L - 1)]
                         + [(i, i + 2, h2) for i in range(L - 2)], backend=site.backend)
    h_sp = np.diag(-t1 * np.ones(L - 1), 1) + np.diag(-t2 * np.ones(L - 2), 2)
    eps = np.linalg.eigvalsh(h_sp + h_sp.T)
    n0 = int((eps < 0).sum())

    class Model:
        H_mpo = mpo

    psi = SimpleMPS.from_product_state([site.leg] * L, [1] * n0 + [0] * (L - n0),
                                       backend=site.backend)
    E = DMRGEngine(psi, Model(), chi_max=32, eps=1e-13).run(n_sweeps=2)
    assert abs(E - eps[eps < 0].sum()) < 1e-9


def test_correlation_function_of_the_free_chain():
    """<Cd_i C_j> against the exact correlation matrix: the strings come from braiding
    the operators' odd charge leg past the sites between them."""
    L = 6
    site = SpinlessFermionSite('N', device='cpu')
    h_bond = hopping([site, site], t=1.).to_tensor()

    class Chain:
        H_bonds = [h_bond] * (L - 1)
        H_mpo = mpo_from_bond_op(h_bond, L)

    psi = SimpleMPS.from_product_state([site.leg] * L, [1, 0] * (L // 2),
                                       backend=site.backend)
    DMRGEngine(psi, Chain(), chi_max=24, eps=1e-13).run(n_sweeps=2)
    k = np.arange(1, L + 1)
    eps = -2 * np.cos(np.pi * k / (L + 1))
    phi = np.sqrt(2.0 / (L + 1)) * np.sin(np.pi * np.outer(np.arange(1, L + 1), k) / (L + 1))
    exact = phi[:, eps < 0] @ phi[:, eps < 0].T
    Cd, C = site.get_op('Cd'), site.get_op('C')
    for i, j in [(0, 5), (2, 3), (1, 4)]:
        assert abs(psi.correlation_function(Cd, i, C, j) - exact[i, j]) < 1e-9, (i, j)


def full_chain_hamiltonian(h_bonds, site_leg, backend):
    """H = sum_i 1 x .. x h_i x .. x 1 as one tensor [p0..pL-1 | p0*..pL-1*], built
    inside the framework (an anyonic chain has no dense form): site by site, H' = H x 1
    + 1 x h, from outer products and permutations (tests/test_anyonic_ed.py:17-40
    builds each term apart)."""
    def ordered(t, n):
        return permute_legs(t, codomain=[f'p{j}' for j in range(n)],
                            domain=[f'p{j}*' for j in range(n)])

    H = ordered(h_bonds[0].relabelled(['p0', 'p1', 'p1*', 'p0*']), 2)
    for m, h in enumerate(h_bonds[1:], 2):
        h = h.relabelled([f'p{m - 1}', f'p{m}', f'p{m}*', f'p{m - 1}*'])
        eye = SymmetricTensor.from_eye([site_leg], backend=backend, labels=[f'p{m}'],
                                       dtype=h.dtype)
        rest = SymmetricTensor.from_eye([site_leg] * (m - 1), backend=backend,
                                        labels=[f'p{j}' for j in range(m - 1)], dtype=h.dtype)
        H = ordered(outer(H, eye), m + 1) + ordered(outer(rest, h), m + 1)
    return H


def lowest_eigenvalue(H) -> float:
    W, _ = eigh(H)
    return min(float(np.min(np.real(W.backend.block_backend.to_numpy(b))))
               for b in W.data.blocks)


def test_ising_anyon_chain_against_internal_ed():
    L = 8
    site = IsingAnyonSite(device='cpu')
    sym = site.leg.symmetry
    h_bond = sector_projection_coupling([site, site], J=-1.,
                                        sector=sym.trivial_sector).to_tensor()

    class Chain:
        H_bonds = [h_bond] * (L - 1)
        H_mpo = mpo_from_bond_op(h_bond, L)

    E0 = lowest_eigenvalue(full_chain_hamiltonian(Chain.H_bonds, site.leg, site.backend))
    psi = SimpleMPS.from_fusion_pairs(site.leg, L, backend=site.backend)
    E = DMRGEngine(psi, Chain(), chi_max=16, eps=1e-13).run(n_sweeps=2)
    assert abs(E - E0) < 1e-9


@pytest.mark.parametrize('state', [[1, 2, 1, 2], [1, 1, 2, 0], [3, 0, 1, 2], [1, 0, 0, 0]],
                         ids=['even', 'odd', 'even doubly occupied', 'one fermion'])
def test_mpo_expectation_and_variance_of_graded_states(state):
    """<H> and the variance of a Hubbard product state through the graded MPO (N x Sz,
    parity) equal those without symmetry, whose dense blocks need no signs. With the
    ket contracted first (cyten_tpu/algorithms/mps.py:381) a state of odd parity gave
    -<H>, and the variance of two layers came out negative."""
    got = []
    for conserve in (('N', 'Sz'), ('parity', 'None'), ('None', 'None')):
        model = hubbard4(*conserve)
        psi = SimpleMPS.from_product_state(model.site_legs, state, backend=model.backend)
        got.append((psi.expectation_value_mpo(model.H_mpo), psi.mpo_variance(model.H_mpo)))
    np.testing.assert_allclose(got[0], got[2], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[1], got[2], rtol=0, atol=1e-12)
    assert got[2][1] > 0.5  # a product state is far from an eigenstate
