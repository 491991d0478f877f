"""The rest of the port's bench (``cyten_tpu_torch/bench.py``) against ``bench.py``, on
the CPU.

The workloads (padded U(1), U(1) x U(1) Hubbard, dense TFI) drawn from the same seeds,
the matvec on each, the Hubbard static step, ``TFIModel(bc='infinite')`` and the
infinite chains' exact energies, the traffic model and the roofline, the growth SVD's
rank, the command line, and the signatures of the bench's functions. Sizes are small
and float64; the tolerance is 1e-12 (``cyten_tpu/testing/asserting.py:14``) unless a
test states another. The reference side runs on ``cyten_tpu``'s numpy block backend
(its jax one only where ``bench.py`` hard-codes it).
"""

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as jax_bench
import cyten_tpu as ct
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.dmrg import _get_static_bond_fn as jax_static_bond_fn
from cyten_tpu.algorithms.dmrg import _heff_matvec_impl as jax_heff_matvec
from cyten_tpu.algorithms.models import HeisenbergModel as JaxHeisenbergModel
from cyten_tpu.algorithms.models import TFIModel as JaxTFIModel
from cyten_tpu.algorithms.models import (
    tfi_exact_infinite_gs_energy as jax_tfi_exact_infinite,
)
from cyten_tpu.backends.data import BlockSparseData as JaxBlockSparseData

from cyten_tpu_torch import bench, get_backend
from cyten_tpu_torch.algorithms import (
    DMRGEngine, HeisenbergModel, SimpleMPS, TFIModel, tfi_exact_infinite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import (
    HEffective, _get_static_bond_fn, _heff_matvec_impl, _slots_like, _structure,
)
from cyten_tpu_torch.dtypes import Dtype
from cyten_tpu_torch.tensors.krylov_based import _with_blocks

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12

STEADY_BAR = {'n_jacobi': 1, 'ns_polish': 1}

# (port builder, its reference, chi, further positional arguments)
WORKLOADS = {'padded': (bench.build_padded_workload, jax_bench.build_padded_workload, 48,
                        (0, 8)),
             'hubbard': (bench.build_hubbard_workload, jax_bench.build_hubbard_workload,
                         48, ()),
             'dense': (bench.build_dense_workload, jax_bench.build_dense_workload, 16, ())}


def sector_blocks(t, to_numpy) -> dict:
    """The blocks of ``t`` by the sectors of their legs (``{(): block}`` without
    symmetry): the same key in both packages, whatever the order of a leg's
    sectors."""
    if hasattr(t.data, 'block'):
        return {(): to_numpy(t.data.block)}
    legs = [t.get_leg_co_domain(i).sector_decomposition for i in range(t.num_legs)]
    rows = np.asarray(t.data.block_inds)
    if rows.ndim == 1:  # a diagonal tensor: one index, of its leg's sector
        rows = rows[:, None]
    return {tuple(tuple(int(x) for x in leg[r]) for leg, r in zip(legs, row)):
            to_numpy(b) for row, b in zip(rows, t.data.blocks)}


def assert_same_tensor(got, ref, tol=TOL):
    """The port's ``got`` and ``cyten_tpu``'s ``ref``: the same labels and the same
    blocks by sectors, to ``tol`` relative to the largest entry."""
    assert got.labels == ref.labels
    g = sector_blocks(got, lambda b: b.numpy())
    r = sector_blocks(ref, np.asarray)
    assert sorted(g) == sorted(r)
    scale = max([float(np.abs(b).max()) for b in r.values() if b.size] + [1.])
    for key, block in r.items():
        np.testing.assert_allclose(g[key], block, rtol=0, atol=tol * scale, err_msg=key)


def _ref_sorted(t):
    """``cyten_tpu``'s tensor ``t`` on legs whose sectors are sorted, as the port's
    ``bench._with_sorted_sectors`` rebuilds the Hubbard workload."""
    def sort(leg):
        _, order = ct.ElementarySpace.from_defining_sectors(
            leg.symmetry, leg.defining_sectors, leg.multiplicities, unique_sectors=True,
            return_sorting_perm=True)
        return (ct.ElementarySpace(leg.symmetry, leg.defining_sectors[order],
                                   leg.multiplicities[order], is_dual=leg.is_dual),
                np.argsort(order))

    codomain = [sort(leg) for leg in t.codomain.factors]
    domain = [sort(leg) for leg in t.domain.factors]
    new_index = [idx for _, idx in codomain + domain[::-1]]
    inds = np.stack([idx[col] for idx, col in zip(new_index,
                                                   np.asarray(t.data.block_inds).T)], 1)
    order = np.lexsort(inds.T)
    data = JaxBlockSparseData([t.data.blocks[i] for i in order], inds[order],
                              t.data.dtype, is_sorted=True)
    return ct.SymmetricTensor(data, [leg for leg, _ in codomain],
                              [leg for leg, _ in domain], t.backend, t.labels)


def _ref_sorted_hubbard(backend, chi, seed=0):
    return tuple(map(_ref_sorted, jax_bench.build_hubbard_workload(backend, chi=chi,
                                                                    seed=seed)))


def hubbard_step_state(block_backend='numpy', chi=24):
    """``cyten_tpu``'s step state (bench.py:598-646) of its Hubbard workload on sorted
    legs."""
    backend = ct.get_backend(jax_bench._builder_symmetry(jax_bench.build_hubbard_workload),
                             block_backend)
    return jax_bench.build_step_state(backend, chi, builder=_ref_sorted_hubbard)


@pytest.fixture(scope='module', params=list(WORKLOADS))
def workloads(request):
    """``(name, port's LP, RP, W1, W2, theta, cyten_tpu's)`` of one workload, f64."""
    port_builder, ref_builder, chi, more = WORKLOADS[request.param]
    port = port_builder(get_backend(bench._builder_symmetry(port_builder), device='cpu'),
                        chi, *more)
    sym = jax_bench._builder_symmetry(ref_builder)
    ref = ref_builder(ct.get_backend(sym, 'numpy'), chi, *more)
    return request.param, port, ref


def test_workloads_draw_the_same_tensors(workloads):
    name, port, ref = workloads
    for got, want in zip(port, ref):
        assert_same_tensor(got, want)
    if name == 'hubbard':  # 41 sectors on the sorted virtual leg
        v_leg = port[4].get_leg_co_domain('vL')
        assert v_leg.num_sectors == 41
        v_leg.test_sanity()


def test_matvec_matches_cyten_tpu(workloads):
    _, port, ref = workloads
    assert_same_tensor(_heff_matvec_impl(*port), jax_heff_matvec(*ref))


def test_hubbard_step_state_and_static_step():
    """The Hubbard step state at chi=24 draws cyten_tpu's (on sorted legs: bench.py's
    own build_step_state fails its check on the unsorted legs of its Hubbard workload),
    and one steady static bond update on it (10 Lanczos iterations, n_jacobi=1,
    ns_polish=1) gives cyten_tpu's: the energy to 1e-10, new_B_i, S, B, LP and RP by
    sectors to 1e-9 of their largest entry, as test_torch_static.py holds the U(1)
    step. The reference runs unjitted on its numpy block backend (``jax.disable_jit``:
    its fused Lanczos's ``lax.scan`` loops in Python); jitted, its matvec of hundreds
    of sector pairs compiles for many minutes on a CPU."""
    backend = get_backend(bench._builder_symmetry(bench.build_hubbard_workload),
                          device='cpu')
    state = bench.build_step_state(backend, 24, builder=bench.build_hubbard_workload)
    LP, RP, W1, W2, S, B1, B2, tmpl, mask = state
    ref_state = hubbard_step_state()
    for got, want in zip(state[:8], ref_state[:8]):
        assert_same_tensor(got, want)
    got = _get_static_bond_fn(10, 'steady', STEADY_BAR)(HEffective(LP, RP, W1, W2), S, B1,
                                                         B2, tmpl, None)
    rLP, rRP, rW1, rW2, rS, rB1, rB2, rtmpl, rmask = ref_state
    with jax.disable_jit():
        ref = jax_static_bond_fn(10, 'steady', STEADY_BAR)(
            JaxHEffective(rLP, rRP, rW1, rW2), rS, rB1, rB2, rtmpl, rmask)
    assert abs(float(got[0]) - float(ref[0])) < 1e-10
    for k, name in enumerate(['new_B_i', 'S', 'B', 'LP', 'RP'], 1):
        assert_same_tensor(got[k], ref[k], tol=1e-9)


def test_dense_tensors_take_graph_slots():
    """_GraphedStep's structure key, slots and shells on dense (no-symmetry) tensors,
    which the dense scenario's graph matvec captures."""
    backend = get_backend(bench._builder_symmetry(bench.build_dense_workload), device='cpu')
    theta = bench.build_dense_workload(backend, 8)[4]
    slot, = _slots_like([theta])
    assert _structure(slot) == _structure(theta) and slot.data.block is not theta.data.block
    shell = _with_blocks(theta, [])
    assert shell.data.block is None and shell.labels == theta.labels
    assert torch.equal(_with_blocks(shell, [theta.data.block]).to_dense_block(),
                       theta.to_dense_block())


def test_dense_step_state_is_not_ported():
    with pytest.raises(NotImplementedError):
        bench.build_step_state(get_backend(bench._builder_symmetry(
            bench.build_dense_workload), device='cpu'), 8, builder=bench.build_dense_workload)


@pytest.mark.parametrize('L, conserve, g', [(2, 'None', 1.), (3, 'parity', 1.3)])
def test_infinite_tfi_matches_cyten_tpu(L, conserve, g):
    model = TFIModel(L=L, g=g, conserve=conserve, bc='infinite', device='cpu')
    ref = JaxTFIModel(L=L, g=g, conserve=conserve, bc='infinite', block_backend='numpy')
    assert len(model.H_bonds) == len(ref.H_bonds) == L
    assert len(model.H_mpo) == len(ref.H_mpo) == L
    for got, want in zip(model.H_mpo + model.H_bonds, ref.H_mpo + ref.H_bonds):
        assert got.labels == want.labels
        np.testing.assert_allclose(got.to_numpy(), np.asarray(want.to_numpy()), rtol=0,
                                   atol=TOL)
    assert model.exact_infinite_gs_energy() == ref.exact_infinite_gs_energy()
    # no public finite engine on an infinite chain (iDMRGEngine takes it)
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    with pytest.raises(NotImplementedError):
        DMRGEngine(psi, model)


@pytest.mark.parametrize('J, g', [(1., 1.), (1., 0.), (0., 1.), (1., 0.5), (0.7, 1.9)])
def test_infinite_exact_energies_match_cyten_tpu(J, g):
    assert tfi_exact_infinite_gs_energy(J, g) == jax_tfi_exact_infinite(J, g)
    heis = HeisenbergModel(L=2, J=J, conserve='Sz', bc='infinite', device='cpu')
    ref = JaxHeisenbergModel(L=2, J=J, conserve='Sz', bc='infinite', block_backend='numpy')
    assert heis.exact_infinite_gs_energy() == ref.exact_infinite_gs_energy()


def test_tdot_meta_matches_cyten_tpu():
    rng = np.random.default_rng(5)
    dims1 = [rng.integers(1, 9, 4), rng.integers(1, 4, 3), rng.integers(1, 9, 4)]
    dims2 = [rng.integers(1, 9, 4), rng.integers(1, 4, 3)]
    bi1 = [tuple(int(x) for x in rng.integers(0, [4, 3, 4])) for _ in range(20)]
    bi2 = [tuple(int(x) for x in rng.integers(0, [4, 3])) for _ in range(8)]
    got = bench._tdot_meta(bi1, dims1, bi2, dims2, [2], [0])
    want = jax_bench._tdot_meta(bi1, dims1, bi2, dims2, [2], [0])
    assert got[0] == want[0] and got[2:] == want[2:]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('args', [(1024, 4, 4, 'unique'), (1024, 2, 2, 'stream'),
                                  (4096, 2, 4, 'stream')])
def test_matvec_traffic_bytes_matches_cyten_tpu(args):
    got = bench.matvec_traffic_bytes(*args)
    assert isinstance(got, int) and got == jax_bench.matvec_traffic_bytes(*args)


# the cases of tests/test_bench_emission.py:122-131
@pytest.mark.parametrize('args', [(1e12, 0, 100, 800), (0, 8e9, 100, 800),
                                  (1e12, 0, 100, 800, 6)])
def test_roofline_ms_matches_cyten_tpu(args):
    assert bench._roofline_ms(*args) == jax_bench._roofline_ms(*args)


@pytest.mark.parametrize('setting, want', [
    ({}, ('float32', 1)), ({'env_dtype': 'bfloat16'}, ('bfloat16', 3)),
    ({'precision': 'tensorfloat32', 'env_dtype': 'bfloat16'}, ('tensorfloat32', 1)),
    ({'precision': 'default'}, ('bfloat16', 1)), ({'work_dtype': 'bfloat16'}, ('bfloat16', 1)),
    ({'dtype': Dtype.float64}, ('float64', 1))])
def test_step_ceiling_names_the_kinds_arithmetic(setting, want):
    """The kind each setting's step lists run (the grouped GEMM's _kind) and its passes:
    the port's table in place of bench.py's _PASSES."""
    assert bench.step_ceiling(**setting) == want


def test_svd_growth_rank_matches_cyten_tpu():
    _, _, kept = bench.svd_growth_timing(64, repeats=1, dtype=Dtype.float64, device='cpu')
    assert kept == jax_bench.svd_growth_timing(64, repeats=1)[2]


@pytest.mark.parametrize('repeats', [1, 3])
def test_svd_timing_spread_needs_two_samples(repeats):
    """A timing's spread is (max - min) / min of its samples, None of a single one."""
    bench.svd_timing(8, repeats=repeats, dtype=Dtype.float64, device='cpu')
    spread = bench.svd_timing.spread
    assert spread is None if repeats == 1 else spread >= 0


# the keys of bench.py's hubbard scenario (:1544-1551) but vs_baseline (numpy_run's)
HUBBARD_KEYS = {'metric', 'value', 'unit', 'unrolled_ms', 'grouped_ms'}


def test_command_line_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, '-m', 'cyten_tpu_torch.bench', '--device', 'cpu',
                          '--scenario', 'hubbard', '--chi', '48'], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == HUBBARD_KEYS | {'device'}
    assert res['metric'] == 'hubbard_dmrg_matvec_chi48_tflops' and res['device'] == 'cpu'
    assert all(res[k] > 0 for k in ('value', 'unrolled_ms', 'grouped_ms'))


# the port's bench functions with a counterpart in bench.py: port name -> reference name
COUNTERPARTS = {name: name for name in (
    'build_workload', 'build_padded_workload', 'build_hubbard_workload',
    'build_dense_workload', 'build_golden_workload', 'build_su2_workload',
    '_builder_symmetry', 'build_step_state', 'step_run', 'su2_run', 'svd_timing',
    'svd_dynamic_timing', 'svd_growth_timing', 'svd_exact_e2e_timing',
    'measured_bf16_peak', 'measured_hbm_gbps', '_tdot_meta', 'matvec_traffic_bytes',
    '_roofline_ms', 'accuracy_bf16work', 'main')}
COUNTERPARTS.update(matvec_run='jax_run', su2_step='su2_step_with_compile')


@pytest.mark.parametrize('name', sorted(COUNTERPARTS))
def test_signature_starts_with_the_references(name):
    """The reference's parameters, in its order and with its defaults, come first."""
    got = list(inspect.signature(getattr(bench, name)).parameters.values())
    want = list(inspect.signature(getattr(jax_bench, COUNTERPARTS[name])).parameters.values())
    assert len(got) >= len(want)
    for g, w in zip(got, want):
        assert g.name == w.name
        assert g.default == w.default
    # the port's own parameters follow as keywords or with defaults
    assert all(p.kind == p.KEYWORD_ONLY or p.default is not p.empty
               for p in got[len(want):])


# the bench's entry points, each with the least arguments, on the default device
ENTRY_POINTS = {
    'step_run': lambda: bench.step_run(8), 'matvec_run': lambda: bench.matvec_run(8),
    'svd_timing': lambda: bench.svd_timing(8),
    'svd_dynamic_timing': lambda: bench.svd_dynamic_timing(8),
    'svd_growth_timing': lambda: bench.svd_growth_timing(8),
    'svd_exact_e2e_timing': lambda: bench.svd_exact_e2e_timing(8),
    'measured_peak_tflops': lambda: bench.measured_peak_tflops('float32', 8),
    'measured_bf16_peak': lambda: bench.measured_bf16_peak(8),
    'measured_hbm_gbps': lambda: bench.measured_hbm_gbps(1),
    'main': lambda: bench.main(['--scenario', 'dense', '--chi', '8'])}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is valid')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ENTRY_POINTS[name]()
