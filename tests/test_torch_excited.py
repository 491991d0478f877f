"""Excited states in the PyTorch port (DMRGEngine(orthogonal_to=...)) against
cyten_tpu's engine and exact diagonalization.

The states are made by the port and carried over to cyten_tpu (numpy block backend)
exactly, by the persistence schema; the overlap environments and the
orthogonal two-site vectors are held to cyten_tpu's to 1e-12 of their largest entry, a
projected bond update's energy to 1e-10, and the excited energies to exact
diagonalization at 1e-10 (cyten_tpu's tests/test_dmrg.py:275-309; for Heisenberg, the
Sz=1 sector's ground state).
"""

import functools

import numpy as np
import pytest

from cyten_tpu.algorithms import DMRGEngine as RefDMRGEngine
from cyten_tpu.algorithms import HeisenbergModel as RefHeisenbergModel
from cyten_tpu.tools import hdf5_io as ref_io

from cyten_tpu_torch.algorithms import (
    DMRGEngine, HeisenbergModel, SimpleMPS, TFIModel, heisenberg_exact_finite_gs_energy,
)
from cyten_tpu_torch.tools import hdf5_io as io

L = 8


def _close(got, want, tol=1e-12):
    g, w = got.to_numpy(), want.to_numpy()
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))


def _retag(tree):
    """A port tree with cyten_tpu's numpy block backend named in place of 'torch'."""
    if isinstance(tree, dict):
        return {k: ('numpy' if k == 'backend' else _retag(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_retag(v) for v in tree]
    return tree


def to_ref(psi):
    """A port MPS carried over to cyten_tpu by the schema (numpy blocks)."""
    return ref_io.from_tree(_retag(io.to_tree(psi)))


def heisenberg_dense(L):
    """The open Heisenberg chain (J=1) as a dense matrix on the public basis (up, down
    per site, site 0 slowest), and the total Sz of each basis state."""
    s = [np.array([[0., 1.], [0., 0.]]), np.array([[0., 0.], [1., 0.]]),
         np.diag([0.5, -0.5])]  # S+, S-, Sz

    def op(o, i):
        return functools.reduce(np.kron, [o if k == i else np.eye(2) for k in range(L)])

    H = sum(0.5 * (op(s[0], i) @ op(s[1], i + 1) + op(s[1], i) @ op(s[0], i + 1))
            + op(s[2], i) @ op(s[2], i + 1) for i in range(L - 1))
    return H, sum(np.diag(op(s[2], i)) for i in range(L))


def heisenberg_sector_energies(L, Sz):
    """The spectrum of the open Heisenberg chain in the sector of total Sz, by exact
    diagonalization."""
    H, sz = heisenberg_dense(L)
    keep = np.abs(sz - Sz) < 1e-9
    return np.linalg.eigvalsh(H[np.ix_(keep, keep)])


@pytest.fixture(scope='module')
def heis():
    """U(1) Heisenberg at L=8 on the port: the ground state and the first excited
    state of Sz=0 orthogonal to it, with that state after its first sweep (``half``:
    not converged yet)."""
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    res = {'model': model}
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 4, backend=model.backend)
    res['E_gs'] = DMRGEngine(psi, model, chi_max=16, eps=1e-13).run(n_sweeps=10)
    res['gs'] = psi
    psi1 = SimpleMPS.from_product_state(model.site_legs, [1, 0] * 4, backend=model.backend)
    eng = DMRGEngine(psi1, model, chi_max=16, eps=1e-13, orthogonal_to=[res['gs']])
    eng.run(n_sweeps=1)
    res['half'] = eng.psi.copy()
    res['E1'] = eng.run(n_sweeps=10)
    res['eng'], res['psi1'] = eng, eng.psi
    return res


def _engines(heis):
    """Each package's engine on the half-converged excited state, orthogonal to the
    ground state, on the same numbers (chi_max=16 keeps every value at L=8)."""
    ref_model = RefHeisenbergModel(L=L, conserve='Sz', block_backend='numpy')
    ref = RefDMRGEngine(to_ref(heis['half']), ref_model, chi_max=16, eps=1e-13,
                        orthogonal_to=[to_ref(heis['gs'])])
    port = DMRGEngine(heis['half'].copy(), heis['model'], chi_max=16, eps=1e-13,
                      orthogonal_to=[heis['gs']])
    return ref, port


def test_overlap_environments_and_ortho_theta_match(heis):
    ref, port = _engines(heis)
    for i in range(L):
        _close(port.ORs[0][i], ref.ORs[0][i])
    _close(port.OLs[0][0], ref.OLs[0][0])
    # OL at every bond, from each site's tensor of psi standing in for the isometry
    # A of a bond update, and phi's two-site vector in psi's bases at every bond
    for i in range(L - 1):
        _close(port._ortho_theta(0, i), ref._ortho_theta(0, i))
        ref.update_OL(0, i, ref.psi.Bs[i])
        port.update_OL(0, i, port.psi.Bs[i])
        _close(port.OLs[0][i + 1], ref.OLs[0][i + 1])


def test_projected_bond_update_matches(heis):
    """Half the right pass of a sweep, bond by bond: each projected Lanczos energy to
    1e-10 (the SVDs' gauges may differ between the packages; E does not)."""
    ref, port = _engines(heis)
    for i in range(L // 2):
        ref.update_bond(i)
        port.update_bond(i)
        assert abs(port.E - ref.E) < 1e-10, i
    assert abs(port.E - heis['E1']) > 1e-6  # not converged yet: the bonds did work


def test_dmrg_excited_states_tfi():
    """cyten_tpu's test_dmrg_excited_states on the port: TFI, L=10, parity."""
    Lt, g = 10, 1.2
    model = TFIModel(L=Lt, J=1., g=g, conserve='parity', device='cpu')
    sx = np.array([[0., 1.], [1., 0.]])
    sz = np.diag([1., -1.])

    def op(o, i):
        mats = [np.eye(2)] * Lt
        mats[i] = o
        return functools.reduce(np.kron, mats)

    H = sum(-op(sx, i) @ op(sx, i + 1) for i in range(Lt - 1)) \
        + sum(-g * op(sz, i) for i in range(Lt))
    Pz = functools.reduce(np.kron, [sz] * Lt)
    w, v = np.linalg.eigh(H)
    parity = np.einsum('ij,ji->i', v.T @ Pz, v)
    even = w[parity > 0.5]

    psi0 = SimpleMPS.from_product_state(model.site_legs, [0] * Lt, backend=model.backend)
    E0 = DMRGEngine(psi0, model, chi_max=32, eps=1e-13).run(n_sweeps=8)
    psi1 = SimpleMPS.from_product_state(model.site_legs, [0] * Lt, backend=model.backend)
    E1 = DMRGEngine(psi1, model, chi_max=32, eps=1e-13,
                    orthogonal_to=[psi0]).run(n_sweeps=10)
    assert abs(E0 - even[0]) < 1e-10
    assert abs(E1 - even[1]) < 1e-10
    assert abs(psi1.overlap(psi0)) < 1e-8


def test_dmrg_excited_state_heisenberg_is_the_triplet(heis):
    """U(1) Heisenberg at L=8: the first excited state of Sz=0 is the m=0 member of
    the lowest triplet, so its energy is the Sz=1 ground state's (SU(2)), here by
    exact diagonalization of the Sz=1 sector."""
    sz0, sz1 = heisenberg_sector_energies(L, 0.), heisenberg_sector_energies(L, 1.)
    assert abs(sz0[1] - sz1[0]) < 1e-12  # the triplet
    assert abs(heis['E_gs'] - heisenberg_exact_finite_gs_energy(L, 1.)) < 1e-10
    assert abs(heis['E_gs'] - sz0[0]) < 1e-10
    assert abs(heis['E1'] - sz1[0]) < 1e-10
    assert abs(heis['psi1'].overlap(heis['gs'])) < 1e-8
    with pytest.raises(AssertionError, match='no excited-state search'):
        heis['eng'].enable_static_mode()
