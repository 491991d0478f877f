"""The finite MPS's measurements in the PyTorch port (cyten_tpu_torch/algorithms/mps.py)
against cyten_tpu's, on one state.

An L=8 U(1) Heisenberg ground state, converged by the port, goes over to cyten_tpu
(numpy block backend) by the persistence schema, exactly; the operators Sz, Sp and Sm
(the last two charged) are each package's own spin-1/2 site's. Every measurement is
held to cyten_tpu's to 1e-12 (cyten_tpu/testing/asserting.py:14); canonicalize's outputs, whose
SVD gauge may differ between the packages, through the Schmidt values and the state
vector.
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import HeisenbergModel as RefHeisenbergModel
from cyten_tpu.models.sites import SpinSite as RefSpinSite
from cyten_tpu.tools import hdf5_io as ref_io

import cyten_tpu_torch as ctt
from cyten_tpu_torch.algorithms import DMRGEngine, HeisenbergModel, SimpleMPS
from cyten_tpu_torch.models import SpinSite
from cyten_tpu_torch.tools import hdf5_io as io
from test_torch_excited import _retag, heisenberg_dense

L = 8
TOL = 1e-12


def to_ref(obj):
    return ref_io.from_tree(_retag(io.to_tree(obj)))


@pytest.fixture(scope='module')
def state():
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 4, backend=model.backend)
    DMRGEngine(psi, model, chi_max=16, eps=1e-13).run(n_sweeps=10)
    # an Sz=1 state (a charged right boundary), one sweep from its product state
    charged = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 3 + [0, 0],
                                           backend=model.backend)
    DMRGEngine(charged, model, chi_max=8, eps=1e-13).sweep()
    ref_model = RefHeisenbergModel(L=L, conserve='Sz', block_backend='numpy')
    # each package's own spin-1/2 site: Sz symmetric, Sp and Sm charged
    ref_site = RefSpinSite(0.5, conserve='Sz', backend=ref_model.backend)
    site = SpinSite(0.5, conserve='Sz', backend=model.backend)
    assert site.leg == model.site_legs[0]
    ops = {name: (ref_site.get_op(name), site.get_op(name)) for name in ('Sz', 'Sp', 'Sm')}
    return {'psi': (to_ref(psi), psi), 'charged': (to_ref(charged), charged),
            'H': (ref_model.H_mpo, model.H_mpo), 'ops': ops}


def _same(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1., np.abs(want).max()))


def state_vector(psi):
    """The state's amplitudes in the public basis (gauge invariant)."""
    v = psi.get_theta1(0).to_numpy()
    for B in psi.Bs[1:]:
        v = np.einsum('...a,apb->...pb', v, B.to_numpy())
    return v.reshape(-1)


def test_site_and_bond_expectation_values(state):
    (rpsi, ppsi), (rSz, pSz) = state['psi'], state['ops']['Sz']
    for i in range(L):
        _same(ppsi.site_expectation_value(pSz, i), rpsi.site_expectation_value(rSz, i))
    op2 = ctt.tensors.outer(pSz, pSz)
    rop2 = ct.tensors.outer(rSz, rSz)
    for i in range(L - 1):
        _same(ppsi.bond_expectation_value(op2.relabelled(['p0', 'p1', 'p1*', 'p0*']), i),
              rpsi.bond_expectation_value(rop2.relabelled(['p0', 'p1', 'p1*', 'p0*']), i))


def test_entanglement_entropy_and_norm(state):
    rpsi, ppsi = state['psi']
    _same(ppsi.entanglement_entropy(), rpsi.entanglement_entropy())
    _same(ppsi.norm_squared(), rpsi.norm_squared())
    assert abs(ppsi.norm_squared() - 1.) < 1e-12


@pytest.mark.parametrize('ops', [('Sz', 'Sz'), ('Sp', 'Sm'), ('Sm', 'Sp')])
def test_correlation_function(state, ops):
    """Sz Sz, and the charged pairs: their hidden charge legs run through the transfer
    contraction and pair up at site j."""
    rpsi, ppsi = state['psi']
    (ri, pi), (rj, pj) = state['ops'][ops[0]], state['ops'][ops[1]]
    for i, j in ((0, 1), (2, 5), (1, 7)):
        got = ppsi.correlation_function(pi, i, pj, j)
        _same(got, rpsi.correlation_function(ri, i, rj, j))
    if ops[0] != 'Sz':  # <S+_2 S-_5> + <S-_2 S+_5> = 2 <Sx Sx + Sy Sy> = 4 <Sz Sz> (SU(2))
        pSz = state['ops']['Sz'][1]
        xy = (ppsi.correlation_function(state['ops']['Sp'][1], 2, state['ops']['Sm'][1], 5)
              + ppsi.correlation_function(state['ops']['Sm'][1], 2, state['ops']['Sp'][1], 5))
        _same(xy, 4. * ppsi.correlation_function(pSz, 2, pSz, 5), 1e-10)


def test_mpo_expectation_and_variance(state):
    (rpsi, ppsi), (rH, pH) = state['psi'], state['H']
    E = ppsi.expectation_value_mpo(pH)
    _same(E, rpsi.expectation_value_mpo(rH))
    from cyten_tpu_torch.algorithms import heisenberg_exact_finite_gs_energy

    assert abs(E - heisenberg_exact_finite_gs_energy(L, 1.)) < 1e-10
    var = ppsi.mpo_variance(pH)
    _same(var, rpsi.mpo_variance(rH))
    assert var < 1e-10
    # a product state: a variance far from 0, the same in both
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    prod = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 4, backend=model.backend)
    _same(prod.mpo_variance(pH), to_ref(prod).mpo_variance(rH))
    assert prod.mpo_variance(pH) > 0.1


def test_mpo_expectation_of_a_charged_state(state):
    """The Sz=1 state: cyten_tpu's _mpo_expectation fails on its charged last bond
    (cyten_tpu/algorithms/mps.py:387, item() wants trivial legs); the port's is held
    to the dense Hamiltonian on the state vector."""
    (rc, pc), (rH, pH) = state['charged'], state['H']
    with pytest.raises(AssertionError, match='legs are not trivial'):
        rc.expectation_value_mpo(rH)
    H, _ = heisenberg_dense(L)
    v = state_vector(pc)
    _same(pc.expectation_value_mpo(pH), v @ H @ v)
    _same(pc.mpo_variance(pH), v @ H @ H @ v - (v @ H @ v) ** 2)
    assert pc.mpo_variance(pH) > 1e-6


def test_overlap_with_a_charged_boundary(state):
    (rpsi, ppsi), (rc, pc) = state['psi'], state['charged']
    _same(ppsi.overlap(ppsi), rpsi.overlap(rpsi))
    _same(pc.overlap(pc), rc.overlap(rc))
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    prod = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 3 + [0, 0],
                                        backend=model.backend)
    got = prod.overlap(pc)
    _same(got, to_ref(prod).overlap(rc))
    _same(got, state_vector(prod) @ state_vector(pc))
    assert abs(got) > 1e-3


@pytest.mark.parametrize('canonicalize', [False, True])
def test_apply_local_op_and_canonicalize(state, canonicalize):
    (rpsi, ppsi), (rSz, pSz) = state['psi'], state['ops']['Sz']
    got = ppsi.apply_local_op(pSz, 3, canonicalize=canonicalize)
    want = rpsi.apply_local_op(rSz, 3, canonicalize=canonicalize)
    _same(state_vector(got), state_vector(want))
    v = state_vector(ppsi).reshape([2] * L)
    sz_v = np.moveaxis(np.tensordot(np.diag([.5, -.5]), v, (1, 3)), 0, 3)
    _same(state_vector(got), sz_v.reshape(-1))
    if not canonicalize:
        for a, b in zip(got.Bs, want.Bs):
            _same(a.to_numpy(), b.to_numpy())
        return
    # canonical again: the Schmidt values are the reference's, the norm is kept
    for a, b in zip(got.Ss, want.Ss):
        _same(np.sort(a.diag_numpy), np.sort(b.diag_numpy))
    _same(got.norm_squared(), want.norm_squared())
    for B in got.Bs[1:]:  # right-isometric
        m = B.to_numpy()
        _same(np.einsum('apb,cpb->ac', m, m.conj()), np.eye(m.shape[0]))


def test_canonicalize_restores_a_product_of_gauges(state):
    """canonicalize of a state whose bonds were rescaled: the same state vector and
    Schmidt values as cyten_tpu's canonicalize of it."""
    (rpsi, ppsi) = state['psi']
    scaled = ppsi.copy()
    scaled.Bs[2] = 2. * scaled.Bs[2]
    ref_scaled = to_ref(scaled)
    scaled.canonicalize()
    ref_scaled.canonicalize()
    _same(state_vector(scaled), state_vector(ref_scaled))
    _same(state_vector(scaled), state_vector(ppsi))
    for a, b in zip(scaled.Ss, ref_scaled.Ss):
        _same(np.sort(a.diag_numpy), np.sort(b.diag_numpy))
