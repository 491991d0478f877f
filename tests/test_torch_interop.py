"""State crossing from cyten_tpu to the PyTorch port, and the exporter the port's
parity tests share.

``export_tensor`` / ``export_mps`` turn a cyten_tpu tensor or SimpleMPS into the plain
numpy/dict spec of ``cyten_tpu_torch.tools.interop``; the round trip is exact.
"""

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import HeisenbergModel, SimpleMPS
from cyten_tpu.tensors import DiagonalTensor

import cyten_tpu_torch as ctt
from cyten_tpu_torch.tools.interop import mps_from_arrays, tensor_from_arrays


def _factor_name(f, with_names: bool = False) -> str:
    """The factor's name in ``tools/interop.py``'s spec, with its descriptive name
    after a colon if ``with_names`` (else symmetries are carried without them)."""
    name = type(f).__name__
    if name == 'ZN':
        name = f'Z{f.N}'
    elif name in ct.symmetries.anyons.__all__:
        args = ','.join(f'{k}={v}' for k, v in f._init_args().items())
        name = f'{name}({args})' if args else name
    elif name not in ('U1', 'NoSymmetry', 'SU2', 'FermionParity', 'FermionNumber'):
        raise ValueError(f'no port of symmetry factor {f}')
    if with_names and f.descriptive_name is not None:
        name = f'{name}:{f.descriptive_name}'
    return name


def _leg_spec(leg) -> dict:
    return {'defining_sectors': np.asarray(leg.defining_sectors),
            'multiplicities': np.asarray(leg.multiplicities),
            'is_dual': bool(leg.is_dual),
            'basis_perm': None if leg._basis_perm is None else np.asarray(leg._basis_perm)}


def export_tensor(t, with_names: bool = False) -> dict:
    """Spec of a cyten_tpu SymmetricTensor / DiagonalTensor (blocks as numpy); with
    the factors' descriptive names if ``with_names``."""
    bb = t.backend.block_backend
    data = t.data
    blocks = [data.block] if hasattr(data, 'block') else list(data.blocks)
    return {'symmetry': [_factor_name(f, with_names) for f in t.symmetry.factors],
            'codomain': [_leg_spec(l) for l in t.codomain.factors],
            'domain': [_leg_spec(l) for l in t.domain.factors],
            'labels': list(t.labels),
            'block_inds': np.asarray(getattr(data, 'block_inds', np.zeros((0, 0), int))),
            'blocks': [np.array(bb.to_numpy(b)) for b in blocks],
            'dtype': t.dtype.name,
            'kind': 'diagonal' if isinstance(t, DiagonalTensor) else 'symmetric'}


def export_mps(psi, with_names: bool = False) -> dict:
    return {'Bs': [export_tensor(B, with_names) for B in psi.Bs],
            'Ss': [export_tensor(S, with_names) for S in psi.Ss], 'bc': psi.bc}


def port_backend(symmetry_names):
    """The port's (CPU) tensor backend for the given factor names."""
    sym = ctt.tools.interop.symmetry_from_names(symmetry_names) \
        if symmetry_names else None
    return ctt.get_backend(sym, device='cpu')


def to_port(t, with_names: bool = False):
    spec = export_tensor(t, with_names)
    return tensor_from_arrays(spec, port_backend(spec['symmetry']))


def random_u1_tensor(rng, sym=None, backend='jax', labels=('a', 'b', 'c', 'd')):
    """A random cyten_tpu tensor [a, b | d, c] with a few sectors per leg."""
    sym = ct.u1_symmetry if sym is None else sym
    if sym.num_factors == 1:
        sectors = np.array([[-1], [0], [1], [2]])
    else:  # U(1) x Z2
        sectors = np.array([[-1, 1], [0, 0], [1, 1], [2, 0], [0, 1]])
    legs = []
    for is_dual in (False, True, False, True):
        mults = rng.integers(1, 4, size=len(sectors))
        legs.append(ct.ElementarySpace.from_defining_sectors(
            sym, sectors, mults, is_dual=is_dual, unique_sectors=True))
    be = ct.get_backend(sym, backend)
    return ct.SymmetricTensor.from_random_normal(
        legs[:2], legs[2:], backend=be, labels=list(labels), rng=rng)


@pytest.mark.parametrize('sym_name', ['U1', 'U1xZ2'])
def test_tensor_round_trip_exact(sym_name):
    rng = np.random.default_rng(3)
    sym = ct.u1_symmetry if sym_name == 'U1' else ct.u1_symmetry * ct.z2_symmetry
    t = random_u1_tensor(rng, sym)
    p = to_port(t)
    p.test_sanity()
    assert p.labels == t.labels
    assert p.shape == t.shape
    np.testing.assert_array_equal(p.data.block_inds, t.data.block_inds)
    np.testing.assert_array_equal(p.to_numpy(), t.to_numpy())  # exact: no arithmetic


def test_mps_round_trip_exact():
    model = HeisenbergModel(L=6, conserve='Sz', block_backend='numpy')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * 3, backend=model.backend)
    p = mps_from_arrays(export_mps(psi), port_backend(['U1']))
    assert p.L == psi.L and p.bc == psi.bc
    for Bj, Bp in zip(psi.Bs, p.Bs):
        Bp.test_sanity()
        assert Bp.labels == Bj.labels
        np.testing.assert_array_equal(Bp.to_numpy(), Bj.to_numpy())
    for Sj, Sp in zip(psi.Ss, p.Ss):
        assert isinstance(Sp, ctt.DiagonalTensor)
        np.testing.assert_array_equal(Sp.to_numpy(), Sj.to_numpy())


def test_leg_with_basis_perm_round_trip():
    # from_basis legs carry a basis permutation (the spin-1/2 site leg)
    model = HeisenbergModel(L=2, conserve='Sz', block_backend='numpy')
    W = model.H_mpo[0]
    assert W.codomain.factors[1]._basis_perm is not None
    p = to_port(W)
    np.testing.assert_array_equal(p.codomain.factors[1].basis_perm,
                                  W.codomain.factors[1].basis_perm)
    np.testing.assert_array_equal(p.to_numpy(), W.to_numpy())


def test_unknown_symmetry_factor_raises():
    with pytest.raises(ValueError, match='unknown symmetry factor'):
        ctt.tools.interop.symmetry_from_names(['SU3'])
