"""The models layer of the PyTorch port as a whole: DMRG on chains it builds.

One two-site bond update on the same state in both packages, with cyten_tpu's J1-J2
MPO carried over by ``tools/interop.py::mpo_from_arrays`` and the state by the
persistence schema: the environments and the H_eff matvec to 1e-12, the energies to
1e-10. Then the port's DMRG against exact diagonalisation (cyten_tpu's DMRG on these
chains takes minutes here, tests/test_models.py:248): the spin-1/2 XXZ chain at
Delta=0.5, L=8 (1e-9), the spin-1 chain at L=6 (1e-8), both ``SpinChainModel``, and
the J1-J2 chain at the Majumdar-Ghosh point, L=10, from ``mpo_from_terms``, with 'Sz'
and 'None' (E = -(3/4) L/2 exactly, 1e-8).
"""

import functools

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as RefDMRGEngine
from cyten_tpu.algorithms.dmrg import HEffective as RefHEffective
from cyten_tpu.algorithms.models import mpo_from_terms as ref_mpo_from_terms
from cyten_tpu.algorithms.models import spin_half_site as ref_spin_half_site

from cyten_tpu_torch.algorithms import (
    DMRGEngine, SimpleMPS, SpinChainModel, mpo_from_terms, spin_half_site,
)
from cyten_tpu_torch.algorithms.dmrg import HEffective
from cyten_tpu_torch.backends import get_backend
from cyten_tpu_torch.models import SpinSite
from cyten_tpu_torch.tools.interop import mpo_from_arrays
from test_torch_excited import to_ref
from test_torch_interop import export_tensor

_sz = np.array([[1., 0.], [0., -1.]])
_Sp = np.array([[0., 1.], [0., 0.]])
_SS = 0.5 * (np.kron(_Sp, _Sp.T) + np.kron(_Sp.T, _Sp)) + 0.25 * np.kron(_sz, _sz)


class MpoModel:
    def __init__(self, H_mpo):
        self.H_mpo = H_mpo


def j1j2_terms(L, J2=0.5):
    return [(i, i + 1, _SS, 1.) for i in range(L - 1)] + \
        [(i, i + 2, _SS, J2) for i in range(L - 2)]


def xxz_dense(L, S, Delta):
    """The open spin-S XXZ chain (J=1) as a dense matrix, site 0 slowest."""
    site = SpinSite(S, 'None', device='cpu')
    sp, sz = site.get_op_numpy('Sp'), site.get_op_numpy('Sz')
    d = sp.shape[0]

    def op(o, i):
        return functools.reduce(np.kron, [o if k == i else np.eye(d) for k in range(L)])

    return sum(0.5 * (op(sp, i) @ op(sp.T, i + 1) + op(sp.T, i) @ op(sp, i + 1))
               + Delta * op(sz, i) @ op(sz, i + 1) for i in range(L - 1))


def ground_state(model_or_mpo, legs, backend, state, chi_max, n_sweeps=2):
    """DMRG from a product state; two sweeps converge these chains to 1e-10 (the
    second changes E by less than that, the third by nothing)."""
    model = model_or_mpo if hasattr(model_or_mpo, 'H_mpo') else MpoModel(model_or_mpo)
    psi = SimpleMPS.from_product_state(legs, state, backend=backend)
    return DMRGEngine(psi, model, chi_max=chi_max, eps=1e-13).run(n_sweeps=n_sweeps), psi


@pytest.fixture(scope='module')
def carried():
    """cyten_tpu's J1-J2 MPO at L=8 (numpy blocks) and the port's copy of it; a state
    one sweep from a product state, made by the port and carried over."""
    L = 8
    ref_leg = ref_spin_half_site('Sz')
    ref_mpo = ref_mpo_from_terms([ref_leg] * L, couplings=j1j2_terms(L),
                                 backend=ct.get_backend(ref_leg.symmetry, 'numpy'))
    leg = spin_half_site('Sz')
    backend = get_backend(leg.symmetry, device='cpu')
    mpo = mpo_from_arrays({'tensors': [export_tensor(W) for W in ref_mpo],
                           'max_range': ref_mpo.max_range}, backend)
    psi = SimpleMPS.from_product_state([leg] * L, [i % 2 for i in range(L)],
                                       backend=backend)
    DMRGEngine(psi, MpoModel(mpo), chi_max=4, eps=1e-13).sweep()
    return {'L': L, 'ref_mpo': ref_mpo, 'mpo': mpo, 'psi': psi}


def test_mpo_from_arrays(carried):
    mpo, ref_mpo = carried['mpo'], carried['ref_mpo']
    assert mpo.max_range == ref_mpo.max_range == 2
    for W, R in zip(mpo, ref_mpo, strict=True):
        W.test_sanity()
        assert W.labels == R.labels
        np.testing.assert_array_equal(W.to_numpy(), R.to_numpy())


def test_bond_update_against_cyten_tpu(carried):
    """The right environments, the H_eff matvec and half a sweep of bond updates on
    the carried MPO and state."""
    L = carried['L']
    ref = RefDMRGEngine(to_ref(carried['psi']), MpoModel(carried['ref_mpo']), chi_max=16,
                        eps=1e-13)
    port = DMRGEngine(carried['psi'].copy(), MpoModel(carried['mpo']), chi_max=16,
                      eps=1e-13)

    def close(got, want, tol=1e-12):
        g, w = got.to_numpy(), want.to_numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))

    for i in range(L):
        close(port.RPs[i], ref.RPs[i])
    for i in range(L // 2):
        theta, ref_theta = port.psi.get_theta2(i), ref.psi.get_theta2(i)
        Htheta = HEffective(port.LPs[i], port.RPs[i + 1], port.model.H_mpo[i],
                            port.model.H_mpo[i + 1]).matvec(theta)
        ref_Htheta = RefHEffective(ref.LPs[i], ref.RPs[i + 1], ref.model.H_mpo[i],
                                   ref.model.H_mpo[i + 1], use_jit=False).matvec(ref_theta)
        if i == 0:  # the states agree tensor by tensor until the first SVD
            close(Htheta, ref_Htheta)
        # after it, up to the SVD's gauge: <theta|H|theta> is gauge invariant
        e, ref_e = (np.vdot(a.to_numpy(), b.to_numpy())
                    for a, b in ((theta, Htheta), (ref_theta, ref_Htheta)))
        assert abs(e - ref_e) < 1e-12 * max(1., abs(ref_e)), i
        ref.update_bond(i)
        port.update_bond(i)
        assert abs(port.E - ref.E) < 1e-10, i
    assert abs(port.E - (-0.75 * (L // 2))) > 1e-6  # not converged: the bonds did work


def test_spin_half_xxz_against_ed():
    L, Delta = 8, 0.5
    model = SpinChainModel(L=L, S=0.5, Delta=Delta, conserve='Sz', device='cpu')
    E, _ = ground_state(model, model.site_legs, model.backend, [0, 1] * (L // 2), 16)
    assert abs(E - np.linalg.eigvalsh(xxz_dense(L, 0.5, Delta))[0]) < 1e-9


def test_spin1_against_ed():
    L = 6
    model = SpinChainModel(L=L, S=1.0, conserve='Sz', device='cpu')
    E, psi = ground_state(model, model.site_legs, model.backend, [0, 2] * (L // 2), 27)
    assert abs(E - np.linalg.eigvalsh(xxz_dense(L, 1., 1.))[0]) < 1e-8
    assert abs(model.energy(psi) - E) < 1e-8


@pytest.mark.parametrize('conserve', ['Sz', 'None'])
def test_majumdar_ghosh(conserve):
    """J1-J2 at J2 = J1/2, open chain, even L: the dimer product is the exact ground
    state, E = -(3/4) L/2."""
    L = 10
    leg = spin_half_site(conserve)
    mpo = mpo_from_terms([leg] * L, couplings=j1j2_terms(L), device='cpu')
    assert mpo.max_range == 2
    E, _ = ground_state(mpo, [leg] * L, mpo[0].backend, [i % 2 for i in range(L)], 8)
    assert abs(E - (-0.75 * (L // 2))) < 1e-8


def test_steady_svd_keeps_the_isometry(monkeypatch):
    """A warm start that mixes the kept columns, on a spectrum whose tail falls to 1e-6:
    the Jacobi step leaves the tail mixed (against the largest value it counts as
    degenerate), and Newton-Schulz leaves U far from an isometry (the fault that blew
    up the spin-1 chain's static sweeps at chi 1024); the QR of
    ``steady._orthonormal_columns`` restores it, on the span of theta's kept values."""
    from cyten_tpu_torch import ElementarySpace, SymmetricTensor, u1_symmetry
    from cyten_tpu_torch.tensors import compose, dagger, steady

    backend = get_backend(u1_symmetry, device='cpu')
    rng = np.random.default_rng(0)
    n, k = 24, 16
    leg = ElementarySpace(u1_symmetry, [[0]], [n])
    kept = ElementarySpace(u1_symmetry, [[0]], [k])
    A, B = (np.linalg.qr(rng.normal(size=(n, n)))[0] for _ in range(2))
    s = np.concatenate([[1., .8, .6, .5], np.logspace(-3.5, -6, n - 4)])
    thp = SymmetricTensor.from_dense_block(A @ np.diag(s) @ B.T, [leg], [leg],
                                           backend=backend, labels=['a', 'b'])
    mix = np.linalg.qr(rng.normal(size=(k, k)))[0]
    Vh_prev = SymmetricTensor.from_dense_block(mix @ B.T[:k], [kept], [leg],
                                               backend=backend, labels=['k', 'b'])

    def isometry_error(U):
        G = compose(dagger(U), U).to_numpy()
        return np.abs(G - np.eye(k)).max()

    U, S, Vh, _ = steady.steady_truncated_svd(thp, Vh_prev)
    assert isometry_error(U) < 1e-12
    # U spans theta's kept left subspace: what it leaves of theta is the discarded part
    u, theta = U.to_numpy(), thp.to_numpy()
    assert np.abs(theta - u @ (u.T @ theta)).max() < 10 * s[k]
    monkeypatch.setattr(steady, '_orthonormal_columns', lambda U, S: U)
    assert isometry_error(steady.steady_truncated_svd(thp, Vh_prev)[0]) > 0.1
