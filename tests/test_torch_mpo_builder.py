"""The MPO builders and coupling models of the PyTorch port against cyten_tpu's.

``mpo_from_terms`` (cyten_tpu_torch/algorithms/models.py) on the same terms as
cyten_tpu's: the virtual legs' sectors and dimensions and ``max_range`` equal, and the
operator the MPO represents (its tensors contracted along the chain, as
``Coupling.to_tensor`` does) to 1e-12. Its SVD gauge may differ from jnp's, so the
tensors are not compared one by one. Finite and infinite chains (a finite chain of
three unit cells cut from the infinite tensors), ``select_boundary=False``, ranges 1 to
3, grouped pair terms with strengths (tests/test_mpo_builder.py:163), invalid pairs
(:185), the SU(2) J1-J2 chain on the fusion-tree backend (:68) and the snake-mapped
3x3 TFI patch (:120). Then ``CouplingModel`` (``all_bond_ops``, ``build_H_mpo``), the
coupling models ``TFIModel`` and ``GoldenModel`` and ``SpinChainModel``.
"""

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.algorithms.models as ref_m
import cyten_tpu.models as ref_models

import cyten_tpu_torch as ctt
import cyten_tpu_torch.algorithms.models as port_m
import cyten_tpu_torch.models as port_models
from test_torch_couplings import same_operator

TOL = 1e-12
_sx = np.array([[0., 1.], [1., 0.]])
_sz = np.array([[1., 0.], [0., -1.]])
_Sp = np.array([[0., 1.], [0., 0.]])
_SS = 0.5 * (np.kron(_Sp, _Sp.T) + np.kron(_Sp.T, _Sp)) + 0.25 * np.kron(_sz, _sz)


@pytest.fixture(autouse=True)
def _numpy_blocks():
    old = ct.config.default_block_backend
    ct.config.default_block_backend = 'numpy'
    yield
    ct.config.default_block_backend = old


def spin_half(conserve):
    """The spin-1/2 site leg and backend in both packages."""
    ref, port = ref_m.spin_half_site(conserve), port_m.spin_half_site(conserve)
    return ((ref, ct.get_backend(ref.symmetry, 'numpy')),
            (port, ctt.get_backend(port.symmetry, device='cpu')))


def represented(mpo, coupling_cls):
    """The operator an MPO with trivial end legs represents, as a matrix in the
    ``kron`` convention: its tensors contracted along the chain (dense, or for anyons
    as ``Coupling.to_tensor`` does it, by planar moves)."""
    if not mpo[0].symmetry.can_be_dropped:
        return coupling_cls(list(mpo), [None] * len(mpo)).to_tensor()
    X = mpo[0].to_numpy()[0].transpose(0, 2, 1)  # [p, p*, wR]
    for W in mpo[1:]:
        W = W.to_numpy()  # [wL, p, wR, p*]
        X = np.einsum('abw,wcvd->acbdv', X, W)
        X = X.reshape(X.shape[0] * X.shape[1], X.shape[2] * X.shape[3], X.shape[4])
    return X[..., 0]


def same_legs(mpo, ref):
    assert len(mpo) == len(ref)
    assert getattr(mpo, 'max_range', 1) == getattr(ref, 'max_range', 1)
    for W, R in zip(mpo, ref):
        assert W.labels == R.labels == ['wL', 'p', 'wR', 'p*']
        assert W.dtype.name == R.dtype.name
        for label in ('wL', 'wR'):
            leg, ref_leg = W.get_leg_co_domain(label), R.get_leg_co_domain(label)
            np.testing.assert_array_equal(leg.defining_sectors, ref_leg.defining_sectors)
            np.testing.assert_array_equal(leg.multiplicities, ref_leg.multiplicities)
            assert leg.dim == ref_leg.dim


def same_mpo(mpo, ref):
    same_legs(mpo, ref)
    same_operator(represented(mpo, port_models.Coupling),
                  represented(ref, ref_models.Coupling))


def finite_from_infinite(W, n_cells, selector):
    """A finite chain of ``n_cells`` unit cells of infinite MPO tensors, its ends
    boundary-selected."""
    L = len(W)
    fin = [W[i % L] for i in range(n_cells * L)]
    fin[0] = selector(fin[0], left=True)
    fin[-1] = selector(fin[-1], left=False)
    return fin


def both(conserve, L, **kw):
    """mpo_from_terms in both packages on spin-1/2 legs, dense terms from ``kw``."""
    (rleg, rb), (pleg, pb) = spin_half(conserve)
    return (port_m.mpo_from_terms([pleg] * L, backend=pb, **kw),
            ref_m.mpo_from_terms([rleg] * L, backend=rb, **kw))


def snake_pairs(Lx, Ly):
    def idx(x, y):
        return x * Ly + (y if x % 2 == 0 else Ly - 1 - y)

    pairs = []
    for x in range(Lx):
        for y in range(Ly):
            if y + 1 < Ly:
                pairs.append(tuple(sorted((idx(x, y), idx(x, y + 1)))))
            if x + 1 < Lx:
                pairs.append(tuple(sorted((idx(x, y), idx(x + 1, y)))))
    return pairs


FINITE = {
    # TFI from onsite + nearest-neighbour terms (tests/test_mpo_builder.py:36)
    'tfi_nn': ('parity', 6, dict(onsite=[(i, _sz, -0.7) for i in range(6)],
                                 couplings=[(i, i + 1, np.kron(_sx, _sx), -1.)
                                            for i in range(5)])),
    # J1-J2 at the Majumdar-Ghosh point, ranges 1 and 2 (:51)
    'j1j2_Sz': ('Sz', 8, dict(couplings=[(i, i + 1, _SS, 1.) for i in range(7)]
                              + [(i, i + 2, _SS, 0.5) for i in range(6)])),
    'j1j2_None': ('None', 8, dict(couplings=[(i, i + 1, _SS, 1.) for i in range(7)]
                                  + [(i, i + 2, _SS, 0.5) for i in range(6)])),
    # ranges 1 to 3 with a field
    'j1j2j3': ('Sz', 7, dict(onsite=[(i, 0.5 * _sz, 0.1 * i) for i in range(7)],
                             couplings=[(i, i + 1, _SS) for i in range(6)]
                             + [(i, i + 2, _SS, 0.4) for i in range(5)]
                             + [(i, i + 3, _SS, -0.3) for i in range(4)])),
    # terms on one pair summed before the factorization, strengths (:163)
    'grouped': ('None', 4, dict(couplings=[(0, 1, np.kron(_sx, _sx), -0.5),
                                           (0, 1, np.kron(_sx, _sx), -0.5),
                                           (0, 1, np.kron(_sz, _sz), 0.25),
                                           (1, 2, np.kron(_sx, _sx), -1.),
                                           (2, 3, np.kron(_sx, _sx), -1.)],
                                onsite=[(i, -0.3 * _sz) for i in range(4)]
                                + [(1, _sx, 0.2), (1, _sz, 0.1)])),
    # the 3x3 TFI patch, snake-mapped to a chain: couplings of range 1 to 5 (:120)
    'tfi_cylinder': ('parity', 9, dict(onsite=[(i, _sz, -1.2) for i in range(9)],
                                       couplings=[(i, j, np.kron(_sx, _sx), -1.)
                                                  for i, j in snake_pairs(3, 3)])),
}


@pytest.mark.parametrize('case', list(FINITE))
def test_finite_terms_against_cyten_tpu(case):
    conserve, L, kw = FINITE[case]
    mpo, ref = both(conserve, L, **kw)
    assert isinstance(mpo, port_m.MpoTensors)
    same_mpo(mpo, ref)


def test_select_boundary_false():
    """The full grid tensors at the ends: the same legs, and boundary-selected by hand
    the same operator."""
    conserve, L, kw = FINITE['j1j2j3']
    mpo, ref = both(conserve, L, select_boundary=False, **kw)
    same_legs(mpo, ref)
    assert mpo[0].get_leg_co_domain('wL').dim > 1
    same_mpo(finite_from_infinite(mpo, 1, port_m._boundary_selector),
             finite_from_infinite(ref, 1, ref_m._boundary_selector))


@pytest.mark.parametrize('case', ['tfi_nn', 'j1j2', 'range3'])
def test_infinite_terms_against_cyten_tpu(case):
    """Infinite bc: wrap legs that match, and three unit cells cut to a finite chain
    represent the same operator."""
    if case == 'tfi_nn':
        conserve, kw = 'parity', dict(onsite=[(0, _sz, -1.5), (1, _sz, -1.5)],
                                      couplings=[(0, 1, np.kron(_sx, _sx), -1.),
                                                 (1, 2, np.kron(_sx, _sx), -1.)])
    elif case == 'j1j2':
        conserve, kw = 'Sz', dict(couplings=[(0, 1, _SS, 1.), (1, 2, _SS, 1.),
                                             (0, 2, _SS, 0.5), (1, 3, _SS, 0.5)])
    else:
        conserve, kw = 'None', dict(couplings=[(0, 1, _SS), (1, 2, _SS), (0, 3, _SS, 0.2),
                                               (1, 4, _SS, 0.2)])
    mpo, ref = both(conserve, 2, bc='infinite', **kw)
    same_legs(mpo, ref)
    assert mpo[0].get_leg_co_domain('wL') == mpo[1].get_leg_co_domain('wR')
    same_mpo(finite_from_infinite(mpo, 3, port_m._boundary_selector),
             finite_from_infinite(ref, 3, ref_m._boundary_selector))


@pytest.mark.parametrize('couplings,bc', [([(1, 1, np.kron(_sx, _sx))], 'finite'),
                                          ([(2, 1, np.kron(_sx, _sx))], 'finite'),
                                          ([(1, 3, np.kron(_sx, _sx))], 'finite'),
                                          ([(3, 4, np.kron(_sx, _sx))], 'infinite'),
                                          ([(0, 1, np.kron(_sx, _sx))], 'periodic')])
def test_invalid_terms_raise(couplings, bc):
    (rleg, rb), (pleg, pb) = spin_half('None')
    with pytest.raises(ValueError):
        ref_m.mpo_from_terms([rleg] * 3, couplings=couplings, backend=rb, bc=bc)
    with pytest.raises(ValueError):
        port_m.mpo_from_terms([pleg] * 3, couplings=couplings, backend=pb, bc=bc)


def heisenberg_terms(pkg_models, site, L, J2):
    h = pkg_models.heisenberg_coupling([site, site], J=1.).to_tensor()
    return ([(i, i + 1, h, 1.) for i in range(L - 1)]
            + [(i, i + 2, h, J2) for i in range(L - 2)])


def test_su2_j1j2_against_cyten_tpu():
    """SymmetricTensor terms on the fusion-tree backend: SU(2) J1-J2 (:68)."""
    L = 6
    ref_site = ref_models.SpinSite(0.5, conserve='SU(2)')
    site = port_models.SpinSite(0.5, conserve='SU(2)', device='cpu')
    ref = ref_m.mpo_from_terms([ref_site.leg] * L,
                               couplings=heisenberg_terms(ref_models, ref_site, L, 0.5),
                               backend=ref_site.backend)
    # the backend comes from the terms
    mpo = port_m.mpo_from_terms([site.leg] * L,
                                couplings=heisenberg_terms(port_models, site, L, 0.5))
    assert mpo[0].backend is site.backend
    same_mpo(mpo, ref)


def coupling_model(pkg, device_kw, L=6, long_range=True):
    sites = [pkg.SpinSite(1, 'Sz', **device_kw) for _ in range(L)]
    m = pkg.CouplingModel(sites)
    for i in range(L - 1):
        m.add_coupling(i, pkg.heisenberg_coupling([sites[i], sites[i + 1]], J=1.))
    for i in range(L):
        m.add_onsite(i, pkg.spin_field_coupling([sites[i]], hz=0.1 * (i + 1)))
    if long_range:
        for i in range(L - 2):
            m.add_coupling(i, pkg.heisenberg_coupling([sites[i], sites[i + 2]], J=0.3),
                           j=i + 2)
    return m


def test_coupling_model_against_cyten_tpu():
    """all_bond_ops (onsite terms split half-half) and build_H_mpo (any range)."""
    ref = coupling_model(ref_models, {}, long_range=False)
    m = coupling_model(port_models, {'device': 'cpu'}, long_range=False)
    for h, rh in zip(m.all_bond_ops(), ref.all_bond_ops(), strict=True):
        same_operator(h, rh)
    same_mpo(m.build_H_mpo(), ref.build_H_mpo())
    ref = coupling_model(ref_models, {})
    m = coupling_model(port_models, {'device': 'cpu'})
    with pytest.raises(ValueError, match='build_H_mpo'):
        m.all_bond_ops()
    H = m.build_H_mpo()
    same_mpo(H, ref.build_H_mpo())
    assert H.max_range == 2
    with pytest.raises(ValueError):
        m.add_coupling(3, port_models.heisenberg_coupling(m.sites[:2]), j=2)


def test_tenpy_models_against_cyten_tpu():
    """The coupling models: TFIModel (its sites, no terms) and the golden chain's
    bonds and MPO (anyonic: by blocks)."""
    ref, m = ref_models.TFIModel(4, conserve='parity'), \
        port_models.TFIModel(4, conserve='parity', device='cpu')
    assert (m.J, m.g, m.L) == (ref.J, ref.g, ref.L)
    assert m.all_bond_ops() == ref.all_bond_ops() == [None] * 3
    same_mpo(m.build_H_mpo(), ref.build_H_mpo())
    ref, m = ref_models.GoldenChain(3, J=0.8), port_models.GoldenChain(3, J=0.8,
                                                                        device='cpu')
    for h, rh in zip(m.all_bond_ops(), ref.all_bond_ops(), strict=True):
        same_operator(h, rh)
    same_mpo(m.build_H_mpo(), ref.build_H_mpo())


@pytest.mark.parametrize('S', [0.5, 1, 1.5])
@pytest.mark.parametrize('conserve', ['Sz', 'None'])
@pytest.mark.parametrize('bc', ['finite', 'infinite'])
def test_spin_chain_model_against_cyten_tpu(S, conserve, bc):
    """SpinChainModel's bonds and hand-built MPO: dense, tensor by tensor (no SVD)."""
    kw = dict(L=4, S=S, J=0.9, Delta=0.7, hz=0.3, conserve=conserve, bc=bc)
    ref = ref_m.SpinChainModel(block_backend='numpy', **kw)
    m = port_m.SpinChainModel(device='cpu', **kw)
    assert len(m.H_bonds) == len(ref.H_bonds) == (3 if bc == 'finite' else 4)
    for h, rh in zip(m.H_bonds, ref.H_bonds):
        same_operator(h, rh)
    same_legs(m.H_mpo, ref.H_mpo)
    for W, R in zip(m.H_mpo, ref.H_mpo):
        same_operator(W, R)
    if bc == 'finite':
        same_mpo(m.H_mpo, ref.H_mpo)


def test_mpo_from_bond_ops_against_cyten_tpu():
    """Per-bond operators of a non-uniform chain (tests/test_models.py:213)."""
    ref_t = ref_m.TFIModel(L=4, J=1., g=0.7, conserve='None', block_backend='numpy')
    t = port_m.TFIModel(L=4, J=1., g=0.7, conserve='None', device='cpu')
    same_mpo(port_m.mpo_from_bond_ops([float(i + 1) * h for i, h in enumerate(t.H_bonds)]),
             ref_m.mpo_from_bond_ops([float(i + 1) * h for i, h in enumerate(ref_t.H_bonds)]))
