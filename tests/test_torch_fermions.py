"""Fermions in the PyTorch port against cyten_tpu: the graded symmetries
(``cyten_tpu_torch/symmetries/fermions.py``), the fusion-tree backend on fermionic
tensors, the fermion sites and the fermionic couplings.

The symmetry data is compared one parametrised test per property, one case per
symmetry (the factors, named factors, the Hubbard site's ``FermionNumber('N') x
U1('2*Sz')``, a product with Z_3, the module-level instances), over a set of sectors
(FermionNumber has infinitely many), to 1e-12 (``cyten_tpu/testing/asserting.py:14``).
Random fermionic tensors are drawn in cyten_tpu (its numpy block backend) from a numpy
seed and carried over exactly (``tools/interop.py``); ``permute_legs`` is held to
cyten_tpu's at 1e-12 through each way the port applies a plan: as one signed gather
(``tree_moves.AbelianPlan``, the default for these symmetries) and through the
tree-pair composition with both coefficient modes of ``_apply_plan_grouped`` (the one
every other symmetry takes). Sites and couplings are held to cyten_tpu's as the
non-fermionic ones are (``tests/test_torch_sites.py``, ``tests/test_torch_couplings.py``).
"""

import functools
import itertools

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.models.sites as ref_sites
import cyten_tpu.symmetries as ref
import cyten_tpu.tensors as jt
from cyten_tpu.tools import hdf5_io as ref_io

import cyten_tpu_torch.symmetries as port
import cyten_tpu_torch.tensors as pt
from cyten_tpu_torch.backends import FusionTreeBackend, tree_moves
from cyten_tpu_torch.models import FermionicDOF
from cyten_tpu_torch.tools import hdf5_io as io
from test_torch_couplings import test_factory_against_cyten_tpu as factory_against_cyten_tpu
from test_torch_hdf5_io import _same_blocks, assert_same_tree
from test_torch_interop import export_tensor, to_port
from test_torch_sites import test_site_against_cyten_tpu as site_against_cyten_tpu

TOL = 1e-12
TOLS = dict(rtol=TOL, atol=TOL)

# name -> (the symmetry built from a symmetries module, sectors to probe)
_NU = [[n, s] for n in range(-1, 3) for s in (-1, 0, 1) if (n - s) % 2 == 0]
SYMMETRIES = {
    'FermionParity': (lambda m: m.FermionParity().as_Symmetry(), [[0], [1]]),
    'FermionParity(parity)': (lambda m: m.FermionParity('parity').as_Symmetry(), [[0], [1]]),
    'FermionNumber': (lambda m: m.FermionNumber().as_Symmetry(), [[n] for n in range(-2, 4)]),
    'FermionNumber(N) x U1(2*Sz)': (lambda m: m.FermionNumber('N') * m.U1('2*Sz'), _NU),
    'FermionParity x Z3': (lambda m: m.FermionParity() * m.ZN(3),
                           [[p, z] for p in (0, 1) for z in range(3)]),
    'fermion_number': (lambda m: m.fermion_number, [[n] for n in range(-2, 3)]),
    'fermion_parity': (lambda m: m.fermion_parity, [[0], [1]]),
}


@pytest.fixture(autouse=True)
def _numpy_blocks():
    old = ct.config.default_block_backend
    ct.config.default_block_backend = 'numpy'
    yield
    ct.config.default_block_backend = old


def pair(name):
    """The symmetry ``name`` in cyten_tpu and in the port, and its probe sectors."""
    make, sectors = SYMMETRIES[name]
    return make(ref), make(port), [np.array(s) for s in sectors]


def outcomes(sym, a, b):
    return [np.asarray(c) for c in sym.fusion_outcomes(a, b)]


def f_tuples(sym, secs):
    for a, b, c in itertools.product(secs, repeat=3):
        for e in outcomes(sym, b, c):
            for d in outcomes(sym, a, e):
                for f in outcomes(sym, a, b):
                    if any(np.array_equal(d, x) for x in outcomes(sym, f, c)):
                        yield a, b, c, d, e, f


def c_tuples(sym, secs):
    for a, b, c in itertools.product(secs, repeat=3):
        for e in outcomes(sym, a, b):
            for d in outcomes(sym, e, c):
                for f in outcomes(sym, a, c):
                    if any(np.array_equal(d, x) for x in outcomes(sym, f, b)):
                        yield a, b, c, d, e, f


def r_tuples(sym, secs):
    for a, b in itertools.product(secs, repeat=2):
        for c in outcomes(sym, a, b):
            yield a, b, c


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOLS)


# --- the symmetry data ------------------------------------------------------------------


@pytest.mark.parametrize('name', SYMMETRIES)
def test_sectors_fusion_and_duals(name):
    r, p, secs = pair(name)
    assert repr(p) == repr(r) and str(p) == str(r)
    assert p.braiding_style == r.braiding_style == port.BraidingStyle.fermionic
    assert p.fusion_style == r.fusion_style
    assert (p.can_be_dropped, p.is_abelian, p.has_symmetric_braid) == \
        (r.can_be_dropped, r.is_abelian, r.has_symmetric_braid)
    np.testing.assert_array_equal(p.trivial_sector, r.trivial_sector)
    for a, b in itertools.product(secs, repeat=2):
        np.testing.assert_array_equal(p.fusion_outcomes(a, b), r.fusion_outcomes(a, b))
    for a in secs:
        np.testing.assert_array_equal(p.dual_sector(a), r.dual_sector(a))
        assert p.is_valid_sector(a) == r.is_valid_sector(a)
    np.testing.assert_array_equal(p.dual_sectors(np.array(secs)),
                                  r.dual_sectors(np.array(secs)))


@pytest.mark.parametrize('name', SYMMETRIES)
def test_n_symbols_qdims_and_indicators(name):
    r, p, secs = pair(name)
    for a, b, c in r_tuples(r, secs):
        assert p.n_symbol(a, b, c) == r.n_symbol(a, b, c)
    close(p.batch_qdim(np.array(secs)), r.batch_qdim(np.array(secs)))
    for a in secs:
        close(p.qdim(a), r.qdim(a))
        assert p.frobenius_schur(a) == r.frobenius_schur(a)


@pytest.mark.parametrize('name', SYMMETRIES)
def test_topological_twists(name):
    r, p, secs = pair(name)
    close([p.topological_twist(a) for a in secs], [r.topological_twist(a) for a in secs])
    assert {complex(p.topological_twist(a)) for a in secs} == {1, -1}


@pytest.mark.parametrize('name', SYMMETRIES)
def test_f_symbols(name):
    r, p, secs = pair(name)
    n = 0
    for args in f_tuples(r, secs):
        close(p.f_symbol(*args), r.f_symbol(*args))
        n += 1
    assert n > 0


@pytest.mark.parametrize('name', SYMMETRIES)
def test_r_and_b_symbols(name):
    r, p, secs = pair(name)
    signs = set()
    for args in r_tuples(r, secs):
        close(p.r_symbol(*args), r.r_symbol(*args))
        close(p.b_symbol(*args), r.b_symbol(*args))
        signs.update(np.ravel(p.r_symbol(*args)).tolist())
    assert signs == {1, -1}  # two odd sectors braid with a sign


@pytest.mark.parametrize('name', SYMMETRIES)
def test_c_symbols(name):
    r, p, secs = pair(name)
    n = 0
    for args in c_tuples(r, secs):
        close(p.c_symbol(*args), r.c_symbol(*args))
        n += 1
    assert n > 0


@pytest.mark.parametrize('name', SYMMETRIES)
def test_swap_gates(name):
    r, p, secs = pair(name)
    for a, b in itertools.product(secs, repeat=2):
        close(p.swap_gate(a, b), r.swap_gate(a, b))


@pytest.mark.parametrize('name', SYMMETRIES)
def test_config_round_trip(name):
    """to_config as cyten_tpu's; the port's from_config of cyten_tpu's config (found by
    class name, descriptive names kept) equals the port's symmetry."""
    r, p, _ = pair(name)
    assert p.to_config() == r.to_config()
    assert port.Symmetry.from_config(r.to_config()) == p
    for f in p.factors:
        assert port.SymmetryFactor.from_config(f.to_config()) == f


def test_exports_and_instances():
    import cyten_tpu_torch as ctt

    for name in ('FermionParity', 'FermionNumber', 'fermion_parity', 'fermion_number'):
        assert getattr(ctt, name) is getattr(port, name)
        assert name in port.__all__
    assert port.fermion_number == port.FermionNumber().as_Symmetry()
    assert port.FermionNumber('N') != port.FermionNumber()  # names tell factors apart
    with pytest.warns(UserWarning, match='Multiple fermionic factors'):
        port.Symmetry([port.FermionParity(), port.FermionNumber()])


# --- the fusion-tree backend on fermionic tensors ----------------------------------------


@pytest.fixture(params=['abelian', 'grouped', 'grouped_sparse'])
def plans(request, monkeypatch):
    """Plans as one signed gather (the default for abelian graded symmetries), or
    through the tree-pair composition with each class's coefficients as one dense
    product or (the limit set to 0) entry by entry."""
    monkeypatch.setattr(tree_moves, 'ABELIAN_PLANS', request.param == 'abelian')
    if request.param == 'grouped_sparse':
        monkeypatch.setattr(tree_moves, 'GROUPED_MAX_BLOCK', 0)
    tree_moves._cached_plan.cache_clear()
    tree_moves.batched_program.cache_clear()
    yield request.param
    tree_moves._cached_plan.cache_clear()
    tree_moves.batched_program.cache_clear()


TENSOR_SYMMETRIES = {
    'FermionNumber x U1': (ct.FermionNumber() * ct.U1(),
                           np.array([[-1, 1], [0, 0], [1, -1], [1, 1], [2, 0]])),
    'FermionParity': (ct.fermion_parity, np.array([[0], [1]])),
}


def random_tensor(sym_name, seed, codomain_duals, domain_duals, labels, n_sectors=None):
    sym, sectors = TENSOR_SYMMETRIES[sym_name]
    sectors = sectors[:n_sectors]
    rng = np.random.default_rng(seed)
    legs = [ct.ElementarySpace.from_defining_sectors(
        sym, sectors, rng.integers(1, 3, size=len(sectors)), is_dual=d,
        unique_sectors=True) for d in (*codomain_duals, *domain_duals)]
    return ct.SymmetricTensor.from_random_normal(
        legs[:len(codomain_duals)], legs[len(codomain_duals):],
        backend=ct.get_backend(sym, 'numpy'), labels=labels, rng=rng)


def _four_leg(sym_name, seed=0):
    return random_tensor(sym_name, seed, (False, True), (False, True), ['a', 'b', 'c', 'd'],
                         n_sectors=4)


def same(p, j):
    assert p.labels == j.labels
    np.testing.assert_array_equal(np.asarray(p.data.block_inds),
                                  np.asarray(j.data.block_inds))
    for got, want in zip(p.data.blocks, j.data.blocks, strict=True):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOLS)
    np.testing.assert_allclose(p.to_numpy(), j.to_numpy(), **TOLS)


@pytest.mark.parametrize('sym_name', TENSOR_SYMMETRIES)
def test_round_trip_and_dense_forms(sym_name):
    """Carried over exactly, on the fusion-tree backend; the dense form and the tensor
    made from it are cyten_tpu's."""
    t = _four_leg(sym_name)
    p = to_port(t)
    assert isinstance(p.backend, FusionTreeBackend)
    p.test_sanity()
    assert export_tensor(t)['symmetry'][0].startswith('Fermion')
    np.testing.assert_array_equal(p.to_numpy(), t.to_numpy())  # no arithmetic
    dense = t.to_numpy()
    back = pt.SymmetricTensor.from_dense_block(dense, p.codomain.factors, p.domain.factors,
                                               backend=p.backend, labels=p.labels)
    ref_back = ct.SymmetricTensor.from_dense_block(dense, t.codomain.factors,
                                                   t.domain.factors, backend=t.backend,
                                                   labels=t.labels)
    same(back, ref_back)


PERMUTATIONS = [
    (['a'], ['c', 'd', 'b']),       # bend b down
    (['a', 'b', 'c'], ['d']),       # bend c up
    (['b', 'a'], ['c', 'd']),       # braid in the codomain
    (['a', 'b'], ['d', 'c']),       # braid in the domain
    (['d', 'a'], ['c', 'b']),       # bends and braids
    (['a', 'c'], ['b', 'd']),       # across the tensor
    ([], ['a', 'b', 'c', 'd'][::-1]),  # everything down
    (['c', 'd', 'a', 'b'], []),     # everything up, cyclically
]


@pytest.mark.parametrize('sym_name', TENSOR_SYMMETRIES)
@pytest.mark.parametrize('codomain, domain', PERMUTATIONS)
def test_permute_legs(plans, sym_name, codomain, domain):
    t = _four_leg(sym_name, 1)
    got = pt.permute_legs(to_port(t), codomain, domain)
    got.test_sanity()
    same(got, ref_permuted(sym_name, tuple(codomain), tuple(domain)))


@functools.lru_cache
def ref_permuted(sym_name, codomain, domain):
    """cyten_tpu's permute_legs of the tensor test_permute_legs draws (one for the
    three ways the port applies the plan)."""
    return jt.permute_legs(_four_leg(sym_name, 1), list(codomain), list(domain))


@pytest.mark.parametrize('levels', [[0, 1, 2, 3], [3, 2, 1, 0]])
def test_braids_with_levels_take_the_fermionic_sign(plans, levels):
    """A symmetric braid ignores the levels; two odd legs exchanged take a -1, which
    the abelian plans carry as signs."""
    t = _four_leg('FermionNumber x U1', 2)
    p = pt.permute_legs(to_port(t), ['b', 'a'], ['c', 'd'], levels=levels)
    same(p, jt.permute_legs(t, ['b', 'a'], ['c', 'd'], levels=levels))
    if plans == 'abelian':
        plan = tree_moves.permute_legs_plan(to_port(t).codomain, to_port(t).domain,
                                            (1, 0), (3, 2), tuple(levels))
        assert isinstance(plan, tree_moves.AbelianPlan)
        assert set(plan.signs.tolist()) == {1., -1.}


def test_abelian_plans_equal_the_tree_pair_composition(monkeypatch):
    """The signed gather and the tree-pair composition give the same tensor, bit for
    bit, on a five-leg tensor of the Hubbard site's symmetry for splits of its legs
    in order and in reverse."""
    t = to_port(random_tensor('FermionNumber x U1', 3, (False, True, False), (True, False),
                              ['a', 'b', 'c', 'd', 'e'], n_sectors=4))
    labels = t.labels
    for k, order in ((0, labels), (2, labels), (3, labels[::-1])):
        out = []
        for flag in (True, False):
            monkeypatch.setattr(tree_moves, 'ABELIAN_PLANS', flag)
            tree_moves._cached_plan.cache_clear()
            out.append(pt.permute_legs(t, order[:k], order[k:][::-1]))
        np.testing.assert_array_equal(out[0].data.block_inds, out[1].data.block_inds)
        for x, y in zip(out[0].data.blocks, out[1].data.blocks, strict=True):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    tree_moves._cached_plan.cache_clear()


def test_compose_is_one_grouped_gemm(plans, monkeypatch):
    """``compose`` of fermionic tensors sends its per-coupled-sector pairs as one
    grouped-GEMM call."""
    import cyten_tpu_torch.backends.fusion_tree as ft

    A = random_tensor('FermionNumber x U1', 4, (False, True), (False,), ['a', 'b', 'x'])
    B = random_tensor('FermionNumber x U1', 5, (False,), (True,), ['x*', 'c'])
    B = ct.SymmetricTensor.from_random_normal(A.domain.factors, B.domain.factors,
                                              backend=A.backend, labels=['x*', 'c'],
                                              rng=np.random.default_rng(6))
    calls = []
    ft_grouped = ft.grouped_matmul

    def counting(As, Bs, out_ids=None, n_out=None, pairs=None):
        calls.append(len(pairs[0]))
        return ft_grouped(As, Bs, out_ids, n_out, pairs)

    monkeypatch.setattr(ft, 'grouped_matmul', counting)
    got = pt.compose(to_port(A), to_port(B))
    assert calls == [len(got.data.blocks)] and calls[0] > 1
    same(got, jt.compose(A, B))


@pytest.mark.parametrize('sym_name', TENSOR_SYMMETRIES)
def test_tdot_over_odd_legs(plans, sym_name):
    """tdot over two legs, one of them bent and braided past the others."""
    A = _four_leg(sym_name, 7)
    rng = np.random.default_rng(8)
    leg_b, leg_c = A.get_leg('b'), A.get_leg('c')
    B = ct.SymmetricTensor.from_random_normal(
        [leg_c.dual], [leg_b], backend=A.backend, labels=['c*', 'b*'], rng=rng)
    got = pt.tdot(to_port(A), to_port(B), ['b', 'c'], ['b*', 'c*'])
    same(got, jt.tdot(A, B, ['b', 'c'], ['b*', 'c*']))


def test_hdf5_tree_of_fermionic_objects():
    """The typed schema finds the fermionic factors by class name: cyten_tpu's trees of
    a fermionic tensor and of a charged fermion operator load in the port, blocks
    exact, and the port's trees of them are cyten_tpu's node for node."""
    site = ref_sites.SpinHalfFermionSite('N', 'Sz')
    for obj in (_four_leg('FermionNumber x U1'), site.get_op('Cdu')):
        want = ref_io.to_tree(obj)
        loaded = io.from_tree(want, device='cpu')
        assert type(loaded).__name__ == type(obj).__name__
        _same_blocks(loaded, obj)
        assert_same_tree(io.to_tree(loaded), want)
    assert [f.descriptive_name for f in loaded.symmetry.factors] == ['N', '2*Sz']


# --- sites and couplings ------------------------------------------------------------------

SITE_CASES = [*(('SpinlessFermionSite', (c,)) for c in ('N', 'parity', 'None')),
              *(('SpinHalfFermionSite', (n, s)) for n in ('N', 'parity', 'None')
                for s in ('Sz', 'None'))]


@pytest.mark.parametrize('cls,args', SITE_CASES, ids=[f'{c}{a}' for c, a in SITE_CASES])
def test_site_against_cyten_tpu(cls, args):
    """The leg (symmetry with its descriptive names, sectors, basis order), every
    operator dense to 1e-14 with the charge of the charged ones (C, Cd: an odd
    charge leg), and the annihilators with and without the Jordan-Wigner string."""
    site_against_cyten_tpu(cls, args)
    import cyten_tpu_torch.models.sites as port_sites

    site = getattr(port_sites, cls)(*args, device='cpu')
    refs = getattr(ref_sites, cls)(*args)
    species = [()] if cls == 'SpinlessFermionSite' else [(0,), (1,)]
    for sp, jw in itertools.product(species, (True, False)):
        np.testing.assert_array_equal(site.get_annihilator_numpy(*sp, include_JW=jw),
                                      refs.get_annihilator_numpy(*sp, include_JW=jw))
    if site.leg.symmetry.braiding_style == port.BraidingStyle.fermionic:
        name = 'C' if cls == 'SpinlessFermionSite' else 'Cu'
        charge = site.get_op(name).charge_leg.sector_decomposition
        assert site.leg.symmetry.factors[0]._parity(charge[:, :1]).tolist() == [[1]]


def test_fermionic_dof_anticommutes():
    for n_species in (1, 2, 3):
        Cs = [FermionicDOF.get_annihilator_numpy({}, s, n_species)
              for s in range(n_species)]
        eye = np.eye(2 ** n_species)
        for a, b in itertools.product(range(n_species), repeat=2):
            np.testing.assert_array_equal(Cs[a] @ Cs[b].T + Cs[b].T @ Cs[a],
                                          eye if a == b else 0 * eye)
            np.testing.assert_array_equal(Cs[a] @ Cs[b] + Cs[b] @ Cs[a], 0 * eye)


COUPLING_CASES = [
    *(('hopping', {'t': 1.3}, [('SpinlessFermionSite', (c,))] * 2)
      for c in ('N', 'parity', 'None')),
    *(('hopping', {'t': 0.7, 'species': s}, [('SpinHalfFermionSite', ('N', 'Sz'))] * 2)
      for s in ('u', 'dn')),
    ('hopping', {'t': 0.9, 'species': 'dn'}, [('SpinHalfFermionSite', ('parity', 'None'))] * 2),
    *(('pairing', {'D': 0.8}, [('SpinlessFermionSite', (c,))] * 2) for c in ('parity', 'None')),
    ('onsite_pairing', {'D': 0.6}, [('SpinHalfFermionSite', ('parity', 'Sz'))]),
    ('onsite_pairing', {'D': 0.6}, [('SpinHalfFermionSite', ('None', 'None'))]),
    ('chemical_potential', {'mu': 0.4}, [('SpinlessFermionSite', ('parity',))]),
    ('onsite_interaction', {'U': 4.}, [('SpinHalfFermionSite', ('N', 'Sz'))]),
    ('density_density_interaction', {'V': 1.1}, [('SpinHalfFermionSite', ('N', 'Sz'))] * 2),
]


@pytest.mark.parametrize('factory,kw,site_spec', COUPLING_CASES,
                         ids=[f'{f}-{s[0][0]}{s[0][1]}-{i}'
                              for i, (f, _, s) in enumerate(COUPLING_CASES)])
def test_coupling_against_cyten_tpu(factory, kw, site_spec):
    """The dense blocks with the Jordan-Wigner strings placed as cyten_tpu places them
    (to 1e-12), the factorization's horizontal legs, the coupling carried over."""
    factory_against_cyten_tpu(factory, kw, site_spec)


def test_pairing_refuses_number_conservation():
    import cyten_tpu_torch.models.couplings as port_c
    import cyten_tpu_torch.models.sites as port_sites

    site = port_sites.SpinlessFermionSite('N', device='cpu')
    with pytest.raises(ValueError):
        port_c.pairing([site, site], D=1.)
    with pytest.raises(ValueError):
        port_c.hopping([site], t=1.)
