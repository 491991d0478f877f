"""The couplings of the PyTorch port (cyten_tpu_torch/models/couplings.py) against
cyten_tpu's.

Each ported factory on the same sites in both packages: ``to_tensor()`` dense to 1e-12
(anyonic couplings by their blocks), the factorization's horizontal legs equal (its
SVD gauge may differ, its rank and sectors may not). The cases cover
tests/test_couplings_extra.py's and tests/test_models.py's non-fermionic ones; the
error paths raise as cyten_tpu's do. A coupling carried over from cyten_tpu by
``tools/interop.py::coupling_from_arrays`` contracts to the same operator.
"""

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.models.couplings as ref_c
import cyten_tpu.models.sites as ref_s

import cyten_tpu_torch.models.couplings as port_c
import cyten_tpu_torch.models.sites as port_s
from cyten_tpu_torch.tools.interop import coupling_from_arrays
from test_torch_interop import export_tensor

TOL = 1e-12

# (factory, its keywords, the sites: (class name, args) each)
CASES = [
    ('spin_spin_coupling', {'Jx': 1.1, 'Jy': 1.1, 'Jz': 0.4}, [('SpinSite', (0.5, 'Sz'))] * 2),
    ('spin_spin_coupling', {'Jx': 1.1, 'Jy': 0.7, 'Jz': 0.3}, [('SpinSite', (0.5, 'parity'))] * 2),
    ('spin_spin_coupling', {'Jx': 1.1, 'Jy': 0.7, 'Jz': 0.3}, [('SpinSite', (0.5, 'None'))] * 2),
    ('spin_spin_coupling', {'Jx': 0.8, 'Jy': 0.8, 'Jz': 1.3}, [('SpinSite', (1, 'Sz'))] * 2),
    ('heisenberg_coupling', {'J': 1.}, [('SpinHalfSite', ('Sz',))] * 2),
    ('heisenberg_coupling', {'J': 1.}, [('SpinHalfSite', ('SU(2)',))] * 2),
    ('heisenberg_coupling', {'J': 0.5}, [('SpinSite', (1, 'SU(2)'))] * 2),
    ('heisenberg_coupling', {'J': 0.7}, [('SpinSite', (1.5, 'Sz')), ('SpinSite', (0.5, 'Sz'))]),
    ('aklt_coupling', {'J': 1.}, [('SpinSite', (1, 'Sz'))] * 2),
    ('aklt_coupling', {'J': 1.}, [('SpinSite', (1, 'SU(2)'))] * 2),
    ('chiral_3spin_coupling', {'J': 1.}, [('SpinSite', (0.5, 'Sz'))] * 3),
    ('chiral_3spin_coupling', {'J': 0.6}, [('SpinSite', (1, 'None'))] * 3),
    ('chemical_potential', {'mu': 0.7}, [('SpinlessBosonSite', (3, 'N'))]),
    ('chemical_potential', {'mu': 0.7}, [('SpinlessBosonSite', (2, 'parity'))]),
    ('onsite_interaction', {'U': 2.}, [('SpinlessBosonSite', (3, 'N'))]),
    ('onsite_interaction', {'U': 2.}, [('SpinlessBosonSite', (3, 'None'))]),
    ('density_density_interaction', {'V': 2.1}, [('SpinlessBosonSite', (2, 'N'))] * 2),
    ('density_density_interaction', {'V': 2.1}, [('SpinlessBosonSite', (2, 'parity'))] * 2),
    ('spin_field_coupling', {'hz': 1.3}, [('SpinSite', (0.5, 'Sz'))]),
    ('spin_field_coupling', {'hz': 1.3}, [('SpinSite', (0.5, 'parity'))]),
    ('spin_field_coupling', {'hx': 0.6, 'hy': 0.4, 'hz': 1.3}, [('SpinSite', (0.5, 'None'))]),
    ('spin_field_coupling', {'hx': 0.6, 'hz': 1.3}, [('SpinSite', (1, 'None'))]),
    *(('clock_coupling', {'J': 1.2}, [('ClockSite', (q, c))] * 2)
      for q in (3, 4) for c in ('Z', 'None')),
    *(('clock_clock_coupling', {'Jz': 1.}, [('ClockSite', (q, 'Z'))] * 2) for q in (3, 4)),
    *(('clock_clock_coupling', {'Jx': 0.7, 'Jz': 0.3}, [('ClockSite', (q, 'None'))] * 2)
      for q in (3, 4)),
    *(('clock_field_coupling', {'hx': 0.9, 'hz': 0.4}, [('ClockSite', (q, 'None'))])
      for q in (3, 4)),
    ('clock_field_coupling', {'hz': 0.4}, [('ClockSite', (3, 'Z'))]),
    ('clock_field', {'g': 0.9}, [('ClockSite', (3, 'None'))]),
    *(('sector_projection_coupling', {'J': 1.7, 'sector': [s]}, [('SpinSite', (1, 'SU(2)'))] * 2)
      for s in (0, 2, 4)),
    ('sector_projection_coupling', {'J': 0.4, 'sector': [2]}, [('SpinSite', (0.5, 'SU(2)'))] * 2),
    ('gold_coupling', {'J': 1.}, [('GoldenSite', ())] * 2),
    ('gold_coupling', {'J': 0.5}, [('FibonacciAnyonSite', ())] * 2),
    ('sector_projection_coupling', {'J': 1., 'sector': [1]}, [('FibonacciAnyonSite', ())] * 2),
    ('sector_projection_coupling', {'J': 1., 'sector': [0]}, [('IsingAnyonSite', ())] * 2),
    ('sector_projection_coupling', {'J': 1., 'sector': [2]}, [('SU2kSpin1Site', (3,))] * 2),
]


@pytest.fixture(autouse=True)
def _numpy_blocks():
    old = ct.config.default_block_backend
    ct.config.default_block_backend = 'numpy'
    yield
    ct.config.default_block_backend = old


def make_sites(spec):
    """The same sites in both packages (a repeated site is one object, as in the
    reference's tests)."""
    ref, port = {}, {}
    for key in spec:
        if key not in ref:
            cls, args = key
            ref[key] = getattr(ref_s, cls)(*args)
            port[key] = getattr(port_s, cls)(*args, device='cpu')
    return [ref[k] for k in spec], [port[k] for k in spec]


def blocks(t):
    data = t.data
    bb = t.backend.block_backend
    return [np.asarray(bb.to_numpy(b)) for b in
            ([data.block] if hasattr(data, 'block') else data.blocks)]


def same_operator(got, want, tol=TOL):
    """Two multi-site operators (port, reference) agree: dense, or block by block where
    the symmetry has no dense form (or two dense arrays)."""
    if isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        return
    assert got.labels == want.labels
    if want.symmetry.can_be_dropped:
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=0, atol=tol)
    else:
        np.testing.assert_array_equal(got.data.block_inds, want.data.block_inds)
        for g, w in zip(blocks(got), blocks(want), strict=True):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def same_w_legs(coupling, ref):
    for f, rf in zip(coupling.factorization, ref.factorization, strict=True):
        assert f.labels == rf.labels == ['wL', 'p', 'wR', 'p*']
        for label in ('wL', 'wR'):
            leg, ref_leg = f.get_leg_co_domain(label), rf.get_leg_co_domain(label)
            np.testing.assert_array_equal(leg.defining_sectors, ref_leg.defining_sectors)
            np.testing.assert_array_equal(leg.multiplicities, ref_leg.multiplicities)


@pytest.mark.parametrize('factory,kw,site_spec', CASES,
                         ids=[f'{f}-{s[0][0]}{s[0][1]}-{i}' for i, (f, _, s) in enumerate(CASES)])
def test_factory_against_cyten_tpu(factory, kw, site_spec):
    ref_sites, sites = make_sites(site_spec)
    ref = getattr(ref_c, factory)(ref_sites, **kw)
    c = getattr(port_c, factory)(sites, **kw)
    assert (c.num_sites, c.name) == (ref.num_sites, ref.name)
    same_w_legs(c, ref)
    t, rt = c.to_tensor(), ref.to_tensor()
    t.test_sanity()
    same_operator(t, rt)
    # the reference's coupling carried over contracts to the same operator
    spec = {'factorization': [export_tensor(f) for f in ref.factorization],
            'name': ref.name}
    same_operator(coupling_from_arrays(spec, sites).to_tensor(), rt)
    # a scaled coupling
    same_operator((2.5 * c).to_tensor(), 2.5 * rt)


@pytest.mark.parametrize('factory,kw,site_spec', [
    ('spin_field_coupling', {'hx': 1.}, [('SpinSite', (0.5, 'Sz'))]),
    ('clock_field', {'g': 1.}, [('ClockSite', (3, 'Z'))]),
    ('spin_spin_coupling', {'Jx': 1., 'Jy': 0.5}, [('SpinSite', (0.5, 'Sz'))] * 2),
    ('density_density_interaction', {'V': 1.}, [('SpinlessBosonSite', (2, 'N'))] * 3),
    ('heisenberg_coupling', {}, [('SpinHalfSite', ('Sz',))]),
])
def test_errors_as_cyten_tpu(factory, kw, site_spec):
    """A term that breaks the conserved symmetry, or a coupling on the wrong number of
    sites, raises; the port's error is cyten_tpu's where that is a ValueError."""
    ref_sites, sites = make_sites(site_spec)
    with pytest.raises(Exception) as ref_err:
        getattr(ref_c, factory)(ref_sites, **kw)
    with pytest.raises(ValueError):
        getattr(port_c, factory)(sites, **kw)
    assert isinstance(ref_err.value, (ValueError, AssertionError))


def test_from_tensor_round_trip_three_sites():
    """A random three-site U(1) operator: its planar factorization contracts back to
    it, in both packages alike."""
    rng = np.random.default_rng(5)
    ref_sites, sites = make_sites([('SpinSite', (1, 'Sz'))] * 3)
    Sz = np.diag([1., 0., -1.])
    h = rng.normal() * np.kron(np.kron(Sz, Sz), Sz)
    Sp = ref_sites[0].get_op_numpy('Sp')
    h = h + np.kron(np.kron(Sp, Sp.T), np.eye(3)) + np.kron(np.kron(Sp.T, np.eye(3)), Sp)
    h = h + h.T
    block = h.reshape([3] * 6).transpose(0, 1, 2, 5, 4, 3)
    ref = ref_c.Coupling.from_dense_block(block, ref_sites)
    c = port_c.Coupling.from_dense_block(block, sites)
    same_w_legs(c, ref)
    np.testing.assert_allclose(c.to_tensor().to_numpy(), block, rtol=0, atol=TOL)
    same_operator(c.to_tensor(), ref.to_tensor())
