"""The sites of the PyTorch port (cyten_tpu_torch/models/sites.py) against cyten_tpu's.

Every ported site in every ``conserve`` mode (tests/test_sites_extra.py's and
tests/test_models.py's parameters, less the fermion sites): the leg (its symmetry,
sectors, multiplicities and basis order) equal, the same operators under the same
names and classes, the dense operators to 1e-14 and the charges of the charged ones
equal. Anyonic sites have no dense form: their identity's blocks are compared.
"""

import numpy as np
import pytest

import cyten_tpu as ct
import cyten_tpu.models.sites as ref_sites

import cyten_tpu_torch.models.sites as port_sites
from cyten_tpu_torch.models import SpinDOF
from test_torch_couplings import blocks

TOL = 1e-14

CASES = [
    *((('SpinSite', (S, conserve)) for S in (0.5, 1, 1.5)
       for conserve in ('SU(2)', 'Sz', 'parity', 'None'))),
    *(('SpinHalfSite', (conserve,)) for conserve in ('SU(2)', 'Sz', 'parity', 'None')),
    *(('SpinlessBosonSite', (n_max, conserve)) for n_max in (3, 4)
      for conserve in ('N', 'parity', 'None')),
    *(('ClockSite', (q, conserve)) for q in (2, 3, 4, 5) for conserve in ('Z', 'None')),
    ('FibonacciAnyonSite', ()), ('GoldenSite', ()), ('IsingAnyonSite', ()),
    ('SU2kSpin1Site', (2,)), ('SU2kSpin1Site', (3,)),
]


@pytest.fixture(autouse=True)
def _numpy_blocks():
    old = ct.config.default_block_backend
    ct.config.default_block_backend = 'numpy'
    yield
    ct.config.default_block_backend = old


def factor_names(symmetry):
    return [(type(f).__name__, f.descriptive_name) for f in symmetry.factors]


def same_leg(leg, ref):
    assert factor_names(leg.symmetry) == factor_names(ref.symmetry)
    np.testing.assert_array_equal(leg.defining_sectors, ref.defining_sectors)
    np.testing.assert_array_equal(leg.multiplicities, ref.multiplicities)
    assert leg.is_dual == ref.is_dual
    if ref.symmetry.can_be_dropped:
        np.testing.assert_array_equal(leg.basis_perm, ref.basis_perm)


@pytest.mark.parametrize('cls,args', CASES, ids=[f'{c}{a}' for c, a in CASES])
def test_site_against_cyten_tpu(cls, args):
    ref = getattr(ref_sites, cls)(*args)
    site = getattr(port_sites, cls)(*args, device='cpu')
    assert str(site.backend.block_backend.device) == 'cpu'
    assert type(site.backend).__name__ == type(ref.backend).__name__
    same_leg(site.leg, ref.leg)
    assert site.dim == ref.dim
    assert site.state_labels == ref.state_labels
    assert sorted(site.ops) == sorted(ref.ops)
    for name, op in site.ops.items():
        ref_op = ref.get_op(name)
        assert type(op).__name__ == type(ref_op).__name__, name
        assert op.labels == ref_op.labels
        if type(op).__name__ == 'ChargedTensor':
            same_leg(op.charge_leg, ref_op.charge_leg)
        if site.symmetry.can_be_dropped:
            np.testing.assert_allclose(site.get_op_numpy(name), ref.get_op_numpy(name),
                                       rtol=0, atol=TOL, err_msg=name)
        else:
            for got, want in zip(blocks(op), blocks(ref_op), strict=True):
                np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        for attr in ('S', 'n_max', 'q', 'conserve', 'sector'):
            if hasattr(ref, attr):
                np.testing.assert_array_equal(getattr(site, attr), getattr(ref, attr))


@pytest.mark.parametrize('S', [0.5, 1, 1.5, 2])
def test_spin_algebra(S):
    """Sz changes by 1 under Sp (charge 2 in units of 2 Sz), the Casimir is S(S+1)."""
    ops = SpinDOF.spin_ops(S)
    d = int(2 * S + 1)
    Sp, Sm, Sz = ops['Sp'], ops['Sm'], ops['Sz']
    np.testing.assert_allclose(Sp @ Sm - Sm @ Sp, 2 * Sz, atol=1e-12)
    np.testing.assert_allclose(Sz @ Sz + 0.5 * (Sp @ Sm + Sm @ Sp),
                               S * (S + 1) * np.eye(d), atol=1e-12)
    site = port_sites.SpinSite(S, 'Sz', device='cpu')
    for name, charge in (('Sp', 2), ('Sm', -2)):
        np.testing.assert_array_equal(site.get_op(name).charge_leg.defining_sectors,
                                      [[charge]])


def test_clock_charge_and_round_trip():
    """X shifts the clock charge by 1 mod q; every operator round-trips through its
    symmetric encoding."""
    for q in (3, 4):
        site = port_sites.ClockSite(q, 'Z', device='cpu')
        np.testing.assert_array_equal(site.get_op('X').charge_leg.defining_sectors, [[1]])
        np.testing.assert_array_equal(site.get_op('Xhc').charge_leg.defining_sectors,
                                      [[q - 1]])
    for site in (port_sites.SpinSite(1, 'Sz', device='cpu'),
                 port_sites.ClockSite(3, 'Z', device='cpu'),
                 port_sites.SpinlessBosonSite(3, 'parity', device='cpu')):
        for name in list(site.ops):
            arr = site.get_op_numpy(name)
            again = site.add_operator(f'_again_{name}', arr)
            np.testing.assert_allclose(again.to_numpy(), arr, atol=1e-12)


def test_errors():
    """An unknown conserve or spin, and an operator that is neither symmetric nor of
    one charge, raise."""
    with pytest.raises(ValueError):
        port_sites.SpinSite(0.5, 'N', device='cpu')
    with pytest.raises(ValueError):
        SpinDOF.spin_ops(0.7)
    site = port_sites.SpinHalfSite('Sz', device='cpu')
    with pytest.raises(ValueError, match='neither symmetric nor single-charge'):
        site.add_operator('Sx', SpinDOF.spin_ops(0.5)['Sx'])
    with pytest.raises(ValueError):
        site.add_operator('Sp2', SpinDOF.spin_ops(0.5)['Sp'], allow_charged=False)
