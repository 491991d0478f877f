"""Checkpoints of the PyTorch port (cyten_tpu_torch/tools/checkpoint.py) and the
engine's resume and rollback (DMRGEngine.run(checkpoint=...)), on the CPU.

A checkpoint is written with torch.save and read with torch.load(weights_only=True)
alone: no h5py, no orbax. cyten_tpu's test_checkpoint_resume_and_rollback
(tests/test_dmrg.py:717-767) runs here on the port alone at L=8, chi 16; energies are
held to exact diagonalization (1e-9, BASELINE.md:17).
"""

import inspect
import os
import pickle

import numpy as np
import pytest
import torch

from cyten_tpu.algorithms import DMRGEngine as RefDMRGEngine
from cyten_tpu.tools import checkpoint as ref_ckpt
from cyten_tpu.tools import hdf5_io as ref_io

from cyten_tpu_torch import Dtype
from cyten_tpu_torch.algorithms import (
    DMRGEngine, FaultError, HeisenbergModel, SimpleMPS, heisenberg_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import _blocks
from cyten_tpu_torch.tensors.krylov_based import _with_blocks
from cyten_tpu_torch.tools import checkpoint as ckpt
from cyten_tpu_torch.tools import hdf5_io as io

L = 8
E_EXACT = heisenberg_exact_finite_gs_energy(L, 1.)


def fresh(L=L, dtype=Dtype.float64):
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    if dtype != Dtype.float64:
        model.H_mpo = [W.to_dtype(dtype) for W in model.H_mpo]
        psi = SimpleMPS([B.to_dtype(dtype) for B in psi.Bs],
                        [S.to_dtype(dtype) for S in psi.Ss])
    return model, psi


def poison(eng, i=3):
    """A NaN site tensor, with the environments rebuilt from it (as cyten_tpu's test)."""
    eng.psi.Bs[i] = eng.psi.Bs[i] * float('nan')
    eng.LPs = [None] * eng.psi.L
    eng.RPs = [None] * eng.psi.L
    eng._init_environments()


def _state(psi):
    return [b.clone() for t in psi.Bs + psi.Ss for b in _blocks(t)]


def _same_state(psi, blocks):
    got = [b for t in psi.Bs + psi.Ss for b in _blocks(t)]
    assert len(got) == len(blocks)
    assert all(torch.equal(a, b) for a, b in zip(got, blocks))


@pytest.fixture(scope='module')
def converged():
    model, psi = fresh(L=4)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-13)
    eng.run(n_sweeps=10)
    return eng


def test_manager_keeps_max_to_keep_steps(tmp_path, converged):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    assert mgr.latest_step() is None
    for step in (1, 2, 4, 5, 7):
        mgr.save(step, {'psi': converged.psi, 'sweep': step})
    assert sorted(os.listdir(tmp_path)) == ['step_00000004', 'step_00000005',
                                            'step_00000007']
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path / 'step_00000007')) == ['arrays.pt', 'structure.pt']
    # a second manager (another process) finds them, and keeps counting from them
    mgr2 = ckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    assert mgr2.latest_step() == 7
    mgr2.save(8, {'sweep': 8})
    assert mgr2.latest_step() == 8 and 'step_00000004' not in os.listdir(tmp_path)
    payload = mgr.restore(7, device='cpu')
    assert payload['sweep'] == 7
    _same_state(payload['psi'], _state(converged.psi))


def test_async_save_snapshots_and_writes_whole_steps(tmp_path, converged):
    psi = SimpleMPS([_with_blocks(t, [b.clone() for b in _blocks(t)])
                     for t in converged.psi.Bs], converged.psi.Ss)
    before = _state(psi)
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2, async_save=True)
    mgr.save(1, {'psi': psi, 'E': complex(1., -2.)})
    # the engine goes on changing its tensors: the checkpoint holds their values at save
    for B in psi.Bs:
        for b in B.data.blocks:
            b.mul_(-3.)
    mgr.save(2, {'psi': psi})
    mgr.save(3, {'psi': psi})
    # a step still under its temporary name is not a step
    os.makedirs(tmp_path / 'step_00000009.tmp-1')
    assert mgr.latest_step() == 3
    ckpt.wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ['step_00000002', 'step_00000003',
                                            'step_00000009.tmp-1']
    assert ckpt.CheckpointManager(str(tmp_path)).latest_step() == 3
    old = ckpt.load_checkpoint(str(tmp_path / 'step_00000002'), device='cpu')['psi']
    _same_state(old, [*(-3. * b for t in converged.psi.Bs for b in _blocks(t)),
                      *(b for t in converged.psi.Ss for b in _blocks(t))])
    ckpt.save_checkpoint(str(tmp_path / 'one'), {'psi': converged.psi, 'E': 1j},
                         async_save=True)
    ckpt.wait_for_saves()
    back = ckpt.load_checkpoint(str(tmp_path / 'one'), device='cpu')
    assert back['E'] == 1j
    _same_state(back['psi'], before)


def test_loading_a_pickled_global_raises(tmp_path, converged):
    path = str(tmp_path / 'ckpt')
    ckpt.save_checkpoint(path, {'psi': converged.psi})
    # the same tree with its arrays left as numpy: unpickling it would call numpy's
    # reconstructors, which weights_only refuses
    blocks = []
    io._BLOCK_LEAF_HOOK = lambda b: (blocks.append(b), {'__type__': 'ArrayRef',
                                                        'index': len(blocks) - 1})[1]
    try:
        tree = io.to_tree({'psi': converged.psi})
    finally:
        io._BLOCK_LEAF_HOOK = None
    torch.save(tree, os.path.join(path, 'structure.pt'))
    with pytest.raises(pickle.UnpicklingError):
        ckpt.load_checkpoint(path, device='cpu')


def test_static_state_checkpoint_holds_its_blocks_alone(tmp_path):
    """After a static sweep, with each B as the replayed graphs return it (a view into
    one flat buffer per dtype, shared with that bond's LP and RP), the checkpoint holds
    the blocks' bytes and the tree, not the buffers."""
    model, psi = fresh(L=4)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-13)
    eng.run(n_sweeps=3)
    eng.enable_static_mode(n_lanczos=10, svd_mode='steady')
    eng.sweep()
    # as _GraphedStep.run: every output of a bond update a view into one buffer
    tensors = eng.psi.Bs + eng.psi.Ss + eng.LPs[1:] + eng.RPs[:-1]
    flat = torch.cat([b.reshape(-1) for t in tensors for b in _blocks(t)])
    offset, viewed = 0, []
    for t in tensors:
        views = []
        for b in _blocks(t):
            views.append(flat[offset:offset + b.numel()].view(b.shape))
            offset += b.numel()
        viewed.append(_with_blocks(t, views))
    n = len(eng.psi.Bs)
    state = SimpleMPS(viewed[:n], viewed[n:2 * n])
    block_bytes = sum(b.numel() * b.element_size() for t in state.Bs + state.Ss
                      for b in _blocks(t))
    assert block_bytes * 2 < flat.numel() * flat.element_size()
    path = str(tmp_path / 'static')
    ckpt.save_checkpoint(path, {'psi': state})
    n_blocks = sum(len(_blocks(t)) for t in state.Bs + state.Ss)
    arrays = os.path.getsize(os.path.join(path, 'arrays.pt'))
    # torch.save's zip records: a header of a few hundred bytes a block at most
    assert arrays <= block_bytes + 512 * (n_blocks + 2), (arrays, block_bytes)
    naive = str(tmp_path / 'naive.pt')
    torch.save([b for t in state.Bs + state.Ss for b in _blocks(t)], naive)
    assert os.path.getsize(naive) > 2 * block_bytes
    _same_state(ckpt.load_checkpoint(path, device='cpu')['psi'], _state(state))


def test_checkpoint_resume_and_rollback(tmp_path):
    """cyten_tpu's tests/test_dmrg.py:717-767 on the port: (a) resume in a fresh
    engine, (b) a NaN B detected and rolled back, (c) FaultError with no checkpoint."""
    d = str(tmp_path / 'run_a')
    model, psi = fresh()
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13)
    eng.run(n_sweeps=3, checkpoint=d)
    assert ckpt.CheckpointManager(d).latest_step() == 3
    model2, psi2 = fresh()  # the process died; psi2 is the cold start
    eng2 = DMRGEngine(psi2, model2, chi_max=16, eps=1e-13)
    E = eng2.run(n_sweeps=9, checkpoint=d)
    assert eng2._sweeps_done > 3
    assert abs(E - E_EXACT) < 1e-9
    poison(eng2)
    E = eng2.run(n_sweeps=4, checkpoint=d)
    assert np.isfinite(E) and abs(E - E_EXACT) < 1e-9
    model3, psi3 = fresh()
    eng3 = DMRGEngine(psi3, model3, chi_max=16, eps=1e-13)
    poison(eng3)
    with pytest.raises(FaultError, match='no checkpoint'):
        eng3.run(n_sweeps=2)


def test_nan_at_the_bond_being_updated_rolls_back(tmp_path):
    """A NaN site tensor met by the bond update itself (its environments built before
    the NaN): the Lanczos start vector is not finite, a fault that rolls back.
    cyten_tpu's lanczos asserts a positive norm there (cyten_tpu/tensors/
    krylov_based.py:103), and the AssertionError escapes its run()."""
    d = str(tmp_path / 'nan')
    model, psi = fresh(L=4)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-13)
    eng.run(n_sweeps=2, checkpoint=d)
    eng.psi.Bs[1] = eng.psi.Bs[1] * float('nan')
    E = eng.run(n_sweeps=2, checkpoint=d)
    assert abs(E - heisenberg_exact_finite_gs_energy(4, 1.)) < 1e-9
    eng.psi.Bs[1] = eng.psi.Bs[1] * float('nan')
    with pytest.raises(FaultError, match='non-finite initial vector'):
        eng.run(n_sweeps=1)


def test_rollback_drops_env_dtype_then_faults_persist(tmp_path, capsys):
    """f32 state and MPO with bf16 environments (as chip_smoke.py's phase 7b makes
    them): a NaN B rolls back, the first rollback drops env_dtype before the
    environments are rebuilt; a fault that outlives max_faults rollbacks raises."""
    d = str(tmp_path / 'bf16')
    model, psi = fresh(L=4, dtype=Dtype.float32)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-13, env_dtype=Dtype.bfloat16)
    eng.run(n_sweeps=2, checkpoint=d)
    assert {t.dtype for t in eng.LPs[1:] + eng.RPs[:-1]} == {Dtype.bfloat16}
    poison(eng)
    E = eng.run(n_sweeps=3, checkpoint=d, verbose=True)
    out = capsys.readouterr().out
    assert 'rollback to checkpoint step 2' in out and 'env_dtype -> None' in out
    assert eng.env_dtype is None
    assert {t.dtype for t in eng.LPs + eng.RPs} == {Dtype.float32}
    E4 = heisenberg_exact_finite_gs_energy(4, 1.)
    assert abs(E - E4) < 1e-3 * abs(E4)  # f32 environments
    # a poisoned MPO survives every rollback
    model.H_mpo[1] = model.H_mpo[1] * float('nan')
    with pytest.raises(FaultError, match='persisted through 1 rollbacks'):
        eng.run(n_sweeps=5, checkpoint=d, max_faults=1)


def test_restore_drops_static_mode_and_auto_static_recaptures(tmp_path, capsys):
    """A poisoned sweep in static mode rolls back: static mode goes with its cached
    functions, and auto_static turns it on again on the restored structures."""
    d = str(tmp_path / 'static')
    model, psi = fresh(L=4)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-13, auto_static=True)
    eng.run(n_sweeps=3, checkpoint=d, tol=0.)
    assert eng.static_mode and eng._static_cache
    cache = eng._static_cache
    poison(eng)
    E = eng.run(n_sweeps=3, checkpoint=d, tol=0., verbose=True)
    out = capsys.readouterr().out
    assert out.index('rollback to checkpoint') < out.index('static mode')
    assert eng.static_mode and eng._static_cache is not cache
    assert abs(E - heisenberg_exact_finite_gs_energy(4, 1.)) < 1e-9
    mgr = ckpt.CheckpointManager(d)
    eng._restore_from(mgr, mgr.latest_step())
    assert not eng.static_mode and eng._static_cache == {}


# port callable -> its cyten_tpu counterpart
SIGNATURES = {
    'DMRGEngine.run': (DMRGEngine.run, RefDMRGEngine.run),
    'CheckpointManager': (ckpt.CheckpointManager, ref_ckpt.CheckpointManager),
    'CheckpointManager.restore': (ckpt.CheckpointManager.restore,
                                  ref_ckpt.CheckpointManager.restore),
    'save_checkpoint': (ckpt.save_checkpoint, ref_ckpt.save_checkpoint),
    'load_checkpoint': (ckpt.load_checkpoint, ref_ckpt.load_checkpoint),
    'to_tree': (io.to_tree, ref_io.to_tree),
    'from_tree': (io.from_tree, ref_io.from_tree),
    'load_hdf5': (io.load_hdf5, ref_io.load_hdf5),
    'load_from_hdf5': (io.load_from_hdf5, ref_io.load_from_hdf5),
}


@pytest.mark.parametrize('name', list(SIGNATURES))
def test_signature_starts_with_the_references(name):
    """The reference's parameters, in its order and with its defaults, come first;
    the port's own (device=) follow as keywords."""
    port, ref = SIGNATURES[name]
    got = list(inspect.signature(port).parameters.values())
    want = list(inspect.signature(ref).parameters.values())
    assert [(p.name, p.default) for p in got[:len(want)]] == \
        [(p.name, p.default) for p in want]
    assert all(p.kind == p.KEYWORD_ONLY for p in got[len(want):])
