"""The typed persistence schema of the PyTorch port (cyten_tpu_torch/tools/hdf5_io.py)
against cyten_tpu's (cyten_tpu/tools/hdf5_io.py).

Objects are made in cyten_tpu (numpy block backend) from a numpy seed and carried over
by the schema itself: the port loads cyten_tpu's tree, and its own tree of what it
loaded must equal cyten_tpu's node for node (arrays equal, the block backend's name
compared as 'torch'). Files go both ways, blocks exact.
"""

import numpy as np
import pytest
import torch

import cyten_tpu as ct
from cyten_tpu.algorithms import HeisenbergModel as RefHeisenbergModel
from cyten_tpu.algorithms import SimpleMPS as RefSimpleMPS
from cyten_tpu.models.sites import SpinSite
from cyten_tpu.tools import hdf5_io as ref_io

import cyten_tpu_torch as ctt
from cyten_tpu_torch.algorithms import SimpleMPS
from cyten_tpu_torch.tools import hdf5_io as io
from test_torch_interop import random_u1_tensor

BACKEND_NAMES = ('numpy', 'jax', 'torch')


def _objects():
    """name -> a cyten_tpu object of that kind (numpy blocks)."""
    rng = np.random.default_rng(5)
    t = random_u1_tensor(rng, backend='numpy')
    be = t.backend
    leg = t.codomain.factors[0]
    diag = ct.DiagonalTensor.from_random_normal(leg, backend=be, labels=['x', 'x*'],
                                                rng=rng)
    mask = ct.Mask.from_indices([0, 2, 3, 5], leg, backend=be, labels=['m', 'm*'])
    site = SpinSite(0.5, conserve='Sz', backend=ct.get_backend(ct.u1_symmetry, 'numpy'))
    model = RefHeisenbergModel(L=6, conserve='Sz', block_backend='numpy')
    psi = RefSimpleMPS.from_product_state(model.site_legs, [0, 1, 0, 1, 1, 0],
                                          backend=model.backend)
    return {'SymmetricTensor': t, 'DiagonalTensor': diag, 'Mask': mask,
            'ChargedTensor': site.get_op('Sp'), 'SimpleMPS': psi}


OBJECTS = _objects()


def assert_same_tree(got, want, path='tree'):
    """Node for node: the same keys, items, scalars and arrays (the block backend's
    name compared as 'torch')."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            if k == 'backend':
                assert got[k] == 'torch' and want[k] in BACKEND_NAMES, path
            else:
                assert_same_tree(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for n, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f'{path}[{n}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _blocks(obj):
    """Every block of a tensor, a ChargedTensor's invariant part or an MPS, as numpy."""
    if isinstance(obj, (SimpleMPS, RefSimpleMPS)):
        return [b for t in obj.Bs + obj.Ss for b in _blocks(t)]
    if hasattr(obj, 'invariant_part'):
        return _blocks(obj.invariant_part)
    bb = obj.backend.block_backend
    return [np.asarray(bb.to_numpy(b)) for b in obj.data.blocks]


def _same_blocks(got, want):
    g, w = _blocks(got), _blocks(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('name', list(OBJECTS))
def test_tree_matches_cyten_tpu(name):
    obj = OBJECTS[name]
    want = ref_io.to_tree(obj)
    loaded = io.from_tree(want, device='cpu')
    assert type(loaded).__name__ == type(obj).__name__
    _same_blocks(loaded, obj)
    assert_same_tree(io.to_tree(loaded), want)


def test_sharing_keeps_identity_and_a_cycle_round_trips():
    t = io.from_tree(ref_io.to_tree(OBJECTS['SymmetricTensor']), device='cpu')
    tree = io.to_tree([t, t, {'again': t}])
    assert tree['__type__'] == 'Graph'
    a, b, c = io.from_tree(tree, device='cpu')
    assert a is b is c['again']
    # the sites of an MPS share their legs: loaded, they share them again
    psi = io.from_tree(ref_io.to_tree(OBJECTS['SimpleMPS']), device='cpu')
    assert psi.Bs[1].codomain.factors[1] is psi.Bs[2].codomain.factors[1]
    # a list that holds itself, and a dict holding it and a tensor
    cyc = [1, 'x']
    cyc.append(cyc)
    d = {'self': None, 'list': cyc, 't': t}
    d['self'] = d
    back = io.from_tree(io.to_tree(d), device='cpu')
    assert back['self'] is back and back['list'][2] is back['list']
    assert back['list'][:2] == [1, 'x']
    np.testing.assert_array_equal(back['t'].to_numpy(), t.to_numpy())
    # the same graph from cyten_tpu's own to_tree
    assert_same_tree(io.to_tree([t, t]), ref_io.to_tree([OBJECTS['SymmetricTensor']] * 2))


def test_files_cross_both_ways(tmp_path):
    psi = OBJECTS['SimpleMPS']
    ref_file = str(tmp_path / 'ref.h5')
    ref_io.save_hdf5({'psi': psi, 'Sp': OBJECTS['ChargedTensor'], 'E': -2.5}, ref_file)
    got = io.load_hdf5(ref_file, device='cpu')
    assert got['E'] == -2.5
    _same_blocks(got['psi'], psi)
    _same_blocks(got['Sp'], OBJECTS['ChargedTensor'])
    np.testing.assert_array_equal(got['Sp'].charged_state.numpy(),
                                  np.asarray(OBJECTS['ChargedTensor'].charged_state))
    # the port's file in cyten_tpu (which loads 'torch' on its own torch block backend)
    port_file = str(tmp_path / 'port.h5')
    io.save_hdf5({'psi': got['psi'], 'mask': io.from_tree(
        ref_io.to_tree(OBJECTS['Mask']), device='cpu')}, port_file)
    back = ref_io.load_hdf5(port_file)
    _same_blocks(back['psi'], psi)
    _same_blocks(back['mask'], OBJECTS['Mask'])


def test_bf16_blocks_round_trip_exactly(tmp_path):
    t = io.from_tree(ref_io.to_tree(OBJECTS['SymmetricTensor']), device='cpu')
    t16 = t.to_dtype(ctt.Dtype.bfloat16)
    f = str(tmp_path / 'bf16.h5')
    io.save_hdf5(t16, f)
    back = io.load_hdf5(f, device='cpu')
    assert back.dtype == ctt.Dtype.bfloat16
    for a, b in zip(back.data.blocks, t16.data.blocks):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_the_original_type_schema_raises(tmp_path):
    import h5py

    f = str(tmp_path / 'original.h5')
    with h5py.File(f, 'w') as h:
        h.attrs['type'] = 'instance'
        h.attrs['class'] = 'SymmetricTensor'
    with h5py.File(f, 'r') as h:
        with pytest.raises(io.Hdf5ImportError, match='reference_import'):
            io.load_from_hdf5(h, device='cpu')


@pytest.mark.parametrize('ext', ['.pkl', '.pklz', '.h5'])
def test_save_and_load_round_trip(tmp_path, ext):
    psi = io.from_tree(ref_io.to_tree(OBJECTS['SimpleMPS']), device='cpu')
    f = str(tmp_path / f'psi{ext}')
    io.save(psi, f)
    back = io.load(f, device='cpu')
    assert isinstance(back, SimpleMPS) and back.L == psi.L
    _same_blocks(back, psi)
    assert_same_tree(io.to_tree(back), io.to_tree(psi))


def test_hooks_on_every_persistable_class(tmp_path):
    import h5py

    t = io.from_tree(ref_io.to_tree(OBJECTS['SymmetricTensor']), device='cpu')
    f = str(tmp_path / 'hook.h5')
    with h5py.File(f, 'w') as h:
        t.save_hdf5(io.Hdf5Saver(h), h, 'obj')
    with h5py.File(f, 'r') as h, io._on_device('cpu'):
        back = ctt.SymmetricTensor.from_hdf5(io.Hdf5Loader(h), h, 'obj')
    np.testing.assert_array_equal(back.to_numpy(), t.to_numpy())
    for cls in (ctt.Symmetry, ctt.ElementarySpace, ctt.LegPipe, ctt.TensorProduct,
                ctt.Tensor):
        assert callable(cls.save_hdf5) and callable(cls.from_hdf5)
