"""The precision ladder of the PyTorch port against cyten_tpu.

bf16 scalars on bf16 blocks, bf16 environments in dynamic and static DMRG, the full
bf16 static step, the rounding of each kind of the grouped GEMM's plain version, the
per-operator matmul precision of the matvec, the accuracy protocol of bench.py, and
the engine's signature against cyten_tpu's. Inputs are made from a numpy seed (in
cyten_tpu, carried over exactly by test_torch_interop.to_port).

JAX on the CPU computes f32 products in full whatever ``matmul_precision`` says, while
the port's CPU path rounds the operands as its kernel does. So at 'tensorfloat32' and
'default' the port is held to cyten_tpu at that mode's tolerance, stated per test.
"""

import jax
import numpy as np
import pytest
import torch

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.dmrg import _get_static_bond_fn as jax_static_bond_fn
from cyten_tpu.algorithms.models import TFIModel as JaxTFIModel
from cyten_tpu.dtypes import Dtype as JaxDtype

from cyten_tpu_torch import Dtype, get_backend, u1_symmetry
from cyten_tpu_torch.algorithms import (
    DMRGEngine, HeisenbergModel, SimpleMPS, TFIModel, heisenberg_exact_finite_gs_energy,
    tfi_exact_finite_gs_energy,
)
from cyten_tpu_torch.algorithms.dmrg import HEffective, _get_static_bond_fn
from cyten_tpu_torch.blocks import grouped_gemm
from cyten_tpu_torch.blocks.grouped_gemm import grouped_matmul, grouped_matmul_plain
from cyten_tpu_torch.config import config
from cyten_tpu_torch.symmetries import ElementarySpace
from cyten_tpu_torch.tensors import (
    SymmetricTensor, inner, linear_combination, scalar_multiply, tdot,
)
from test_torch_interop import to_port

PRECISIONS = ['float32', 'tensorfloat32', 'default']


@pytest.fixture
def precision_restored():
    old = config.matmul_precision
    yield
    config.matmul_precision = old


# --- the sticky-scalar rule (tests/test_bf16.py:196-231) ------------------------------


def test_bf16_sticky_scalar():
    """A real scalar that is not bf16 (a 0-d f32 norm, a numpy scalar, a Python
    float) broadcast onto bf16 blocks keeps them bf16; a complex scalar and wider
    blocks promote as usual. The values agree with cyten_tpu's rule."""
    from cyten_tpu.tensors import linear_combination as jax_linear_combination
    from cyten_tpu.tensors import scalar_multiply as jax_scalar_multiply

    jax_backend = ct.get_backend(ct.u1_symmetry, 'jax')
    leg = ct.ElementarySpace(ct.u1_symmetry, [[0], [1]], [4, 3])
    rng = np.random.default_rng(7)
    x_ref = ct.SymmetricTensor.from_random_normal([leg], [leg], backend=jax_backend,
                                                  rng=rng).to_dtype(JaxDtype.bfloat16)
    x = to_port(x_ref.to_dtype(JaxDtype.float32)).to_dtype(Dtype.bfloat16)
    n = torch.linalg.vector_norm(torch.stack([b.float().norm() for b in x.data.blocks]))
    assert n.dtype == torch.float32 and n.ndim == 0
    t = scalar_multiply(1. / n, x)
    y = linear_combination(n, t, np.float32(0.5), t)
    assert y.dtype == Dtype.bfloat16
    assert all(b.dtype == torch.bfloat16 for b in y.data.blocks)
    # cyten_tpu's rule on the same input, eagerly (the test of test_bf16.py is jitted)
    n_ref = ct.norm(x_ref)
    t_ref = jax_scalar_multiply(1. / n_ref, x_ref)
    y_ref = jax_linear_combination(n_ref, t_ref, np.float32(0.5), t_ref)
    assert y_ref.dtype == JaxDtype.bfloat16
    # two bf16 roundings (about 4e-3 each) of values of order 1
    np.testing.assert_allclose(y.to_numpy(), np.asarray(y_ref.to_numpy(), np.float32),
                               atol=0.05)
    xf = x.to_numpy()
    np.testing.assert_allclose(y.to_numpy(), xf * (1. + 0.5 / np.linalg.norm(xf)),
                               atol=0.05)
    for a in (np.float32(2.), np.float64(2.), 2., torch.tensor(2.), np.array(2.)):
        assert scalar_multiply(a, x).dtype == Dtype.bfloat16, type(a)
    # full precision where the storage is wider
    assert scalar_multiply(np.float32(2.), x.to_dtype(Dtype.float32)).dtype == Dtype.float32
    # a complex scalar promotes, and keeps its imaginary part (np.complex64 times a
    # tensor alone would drop it)
    z = scalar_multiply(np.complex64(1j), x)
    assert z.dtype == Dtype.complex64
    np.testing.assert_allclose(z.to_numpy(), 1j * xf, atol=1e-6)


# --- bf16 environments (tests/test_bf16.py:123-193) -----------------------------------


def _energy_f64(psi, model):
    """<psi|H|psi> / <psi|psi> of a state in B form, with f64 environments: the
    expectation of the effective Hamiltonian of bond 0, whose right environment is
    built from the right-isometric B_1 .. B_{L-1} and whose left one is trivial."""
    psi64 = SimpleMPS([B.to_dtype(Dtype.float64) for B in psi.Bs],
                      [S.to_dtype(Dtype.float64) for S in psi.Ss])
    eng = DMRGEngine(psi64, model)
    theta = psi64.get_theta2(0)
    H = HEffective(eng.LPs[0], eng.RPs[1], model.H_mpo[0], model.H_mpo[1])
    return float(inner(theta, H.matvec(theta)).real) / float(inner(theta, theta).real)


def test_dmrg_bf16_environments():
    """TFI L=8, chi_max=16, LP/RP stored bf16, the state f64. The Lanczos energy
    carries the environments' first-order error (0.02 relative); the f64 energy of
    the state is variational: second order (2e-4 relative) and above the exact
    value. cyten_tpu's run is held to the same bounds."""
    L, J, g = 8, 1., 1.5
    E_exact = tfi_exact_finite_gs_energy(L, J, g)
    model = TFIModel(L=L, J=J, g=g, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13, env_dtype=Dtype.bfloat16)
    E = eng.run(n_sweeps=8)
    assert eng.LPs[L // 2].dtype == Dtype.bfloat16
    assert eng.RPs[L // 2].dtype == Dtype.bfloat16
    assert abs(E - E_exact) / abs(E_exact) < 0.02
    E_true = _energy_f64(psi, model)
    assert E_true > E_exact - 1e-10
    assert abs(E_true - E_exact) / abs(E_exact) < 2e-4

    # cyten_tpu on its numpy blocks: the same arithmetic as on its jax blocks here,
    # without compiling a program per block structure
    jmodel = JaxTFIModel(L=L, J=J, g=g, conserve='parity', block_backend='numpy')
    jpsi = JaxSimpleMPS.from_product_state(jmodel.site_legs, [0] * L,
                                           backend=jmodel.backend)
    jeng = JaxDMRGEngine(jpsi, jmodel, chi_max=16, eps=1e-13,
                         env_dtype=JaxDtype.bfloat16)
    E_ref = jeng.run(n_sweeps=8)
    assert abs(E_ref - E_exact) / abs(E_exact) < 0.02
    E_true_ref = jmodel.energy(jpsi)
    assert E_true_ref > E_exact - 1e-10
    assert abs(E_true_ref - E_exact) / abs(E_exact) < 2e-4


def test_static_mode_keeps_env_dtype():
    """env_dtype=bfloat16 persists through static bond updates (L=6, as
    tests/test_bf16.py:174-193)."""
    L = 6
    model = TFIModel(L=L, J=1., g=1.5, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-12, env_dtype=Dtype.bfloat16)
    for _ in range(3):
        eng.sweep()
    eng.enable_static_mode(n_lanczos=10)
    eng.sweep()
    for LP in eng.LPs[1:-1]:
        assert LP.dtype == Dtype.bfloat16, LP
    for RP in eng.RPs[1:-1]:
        assert RP.dtype == Dtype.bfloat16, RP


def test_static_cache_keyed_by_settings():
    """A static update made at one matmul_precision and env_dtype is not reused at
    another: the polish step of the accuracy protocol changes both mid-run."""
    L = 6
    model = TFIModel(L=L, J=1., g=1.5, conserve='parity', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0] * L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=8, eps=1e-12, env_dtype=Dtype.bfloat16,
                     matmul_precision='default')
    for _ in range(2):
        eng.sweep()
    eng.enable_static_mode(n_lanczos=10)
    eng.sweep()
    first = eng._static_entry(2)
    assert eng._static_entry(2) is first
    eng.env_dtype, eng.matmul_precision = None, 'float32'
    assert eng._static_entry(2) is not first
    eng.LPs = [t.to_dtype(Dtype.float64) for t in eng.LPs]
    eng.RPs = [t.to_dtype(Dtype.float64) for t in eng.RPs]
    E = eng.sweep()
    assert all(t.dtype == Dtype.float64 for t in eng.LPs[1:-1] + eng.RPs[1:-1])
    assert abs(E - tfi_exact_finite_gs_energy(L, 1., 1.5)) < 1e-8


def test_full_bf16_static_step():
    """The whole static bond update with bf16 storage (state, MPO, environments,
    intermediates) at chi=48: every output stays bf16, and E is within 0.05 relative
    of cyten_tpu's own f32 result (tests/test_bf16.py:234-256)."""
    import bench as jax_bench

    backend = ct.get_backend(ct.u1_symmetry, 'jax')
    args = jax_bench.build_step_state(backend, chi=48)
    LP, RP, W1, W2, S, B1, B2, tmpl, mask = args
    impl_ref = jax_static_bond_fn(5, 'steady')
    casted = [t.to_dtype(JaxDtype.float32) for t in (LP, RP, W1, W2, S, B1, B2, tmpl)]
    E32_ref = jax.jit(lambda LP, RP, W1, W2, S, B1, B2, tmpl: impl_ref(
        JaxHEffective(LP, RP, W1, W2), S, B1, B2, tmpl, mask)[0])(*casted)
    LPb, RPb, W1b, W2b, Sb, B1b, B2b, tmplb = (
        to_port(t).to_dtype(Dtype.bfloat16) for t in (LP, RP, W1, W2, S, B1, B2, tmpl))
    E16, *outs = _get_static_bond_fn(5, 'steady')(HEffective(LPb, RPb, W1b, W2b), Sb,
                                                 B1b, B2b, tmplb, None)
    for t in outs:
        assert t.dtype == Dtype.bfloat16, t
        assert all(b.dtype == torch.bfloat16 for b in t.data.blocks)
    E32_ref = float(E32_ref)
    assert abs(float(E16) - E32_ref) < 0.05 * max(1., abs(E32_ref))


# --- the kinds of the grouped GEMM's plain version ------------------------------------


def _tf32_numpy(x):
    """An f32 array rounded to 10 stored mantissa bits, nearest with ties away from
    zero, by its mantissa and exponent (frexp), independently of the bit trick."""
    m, e = np.frexp(x.astype(np.float64))
    scaled = m * 2. ** 11
    rounded = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.ldexp(rounded, e - 11).astype(np.float32)


def _bf16_numpy(x):
    """An f32 array rounded to 7 stored mantissa bits, nearest with ties to even."""
    m, e = np.frexp(x.astype(np.float64))
    return np.ldexp(np.round(m * 2. ** 8), e - 8).astype(np.float32)  # np.round: to even


def _with_ties(rng, shape):
    """Normal values, a third of them moved onto a tie of TF32 and another third onto
    a tie of bf16 (the dropped bits exactly half a unit of the last kept bit),
    with both signs."""
    x = rng.normal(size=shape).astype(np.float32)
    bits = x.view(np.int32)
    pick = rng.integers(0, 3, size=shape)
    bits = np.where(pick == 1, (bits & ~0x1FFF) | 0x1000, bits)    # a TF32 tie
    bits = np.where(pick == 2, (bits & ~0xFFFF) | 0x8000, bits)    # a bf16 tie
    return bits.view(np.float32)


def test_rounding_of_each_kind_against_numpy():
    rng = np.random.default_rng(11)
    x = _with_ties(rng, (64, 48))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(grouped_gemm.round_tf32(t).numpy(), _tf32_numpy(x))
    np.testing.assert_array_equal(grouped_gemm._rounded(t, 'tensorfloat32').numpy(),
                                  _tf32_numpy(x))
    np.testing.assert_array_equal(grouped_gemm._rounded(t, 'default').numpy(),
                                  _bf16_numpy(x))
    np.testing.assert_array_equal(grouped_gemm._rounded(t, 'float32').numpy(), x)
    # a bf16 operand is widened exactly: no kind rounds it again
    b16 = t.to(torch.bfloat16)
    for precision in PRECISIONS:
        np.testing.assert_array_equal(grouped_gemm._rounded(b16, precision).numpy(),
                                      b16.float().numpy())


@pytest.mark.parametrize('k', [40, 295])
def test_tf32_truncation_misses_the_kernels_bound(k):
    """On operands whose dropped TF32 bits are 0x1001, just above the midpoint, the
    TF32 kind's plain version (rounding to nearest) and products of truncated
    operands (what wgmma .tf32 makes of raw f32 bits) differ by far more than the
    K 2^-23 |A||B| the kernel is held to on the card: that check finds a kernel
    that skips its rounding pass."""
    rng = np.random.default_rng(17)
    bits = np.abs(rng.normal(size=(2, 30, k))).astype(np.float32).view(np.int32)
    A, Bt = ((bits & ~0x1FFF) | 0x1001).view(np.float32)
    A, B = torch.from_numpy(A), torch.from_numpy(np.ascontiguousarray(Bt.T))
    (ref,) = grouped_matmul_plain([A], [B], precision='tensorfloat32')
    truncated = [(t.view(torch.int32) & ~0x1FFF).view(torch.float32) for t in (A, B)]
    (trunc,) = grouped_matmul_plain(truncated[:1], truncated[1:])
    mag = grouped_gemm.round_tf32(A).double() @ grouped_gemm.round_tf32(B).double()
    gap = (trunc.double() - ref.double()).abs() / (k * 2. ** -23 * mag)
    assert float(gap.min()) > 10


@pytest.mark.parametrize('precision', PRECISIONS + [None])
@pytest.mark.parametrize('mixed', [False, True])
def test_plain_kinds_against_numpy(precision, mixed):
    """Each kind of the plain version equals the products of its numpy-rounded
    operands (f64 sums of exact f32 products, to f32 summation accuracy); at
    'float32' (and None) it is bit-equal to the f32 matmul loop it was before."""
    rng = np.random.default_rng(12)
    shapes, out_ids = [(37, 131, 65), (37, 6, 65), (5, 40, 9)], [0, 0, 1]
    As = [torch.from_numpy(_with_ties(rng, (m, k))) for m, k, n in shapes]
    Bs = [torch.from_numpy(_with_ties(rng, (k, n))) for m, k, n in shapes]
    if mixed:
        As = [A.to(torch.bfloat16) for A in As]
    got = grouped_matmul_plain(As, Bs, out_ids, precision=precision)
    assert all(c.dtype == torch.float32 for c in got)
    rnd = {'tensorfloat32': _tf32_numpy, 'default': _bf16_numpy}.get(precision,
                                                                      lambda a: a)
    ref = [np.zeros((37, 65)), np.zeros((5, 9))]
    mag = [np.zeros((37, 65)), np.zeros((5, 9))]
    for A, B, o in zip(As, Bs, out_ids):
        a, b = rnd(A.float().numpy()).astype(np.float64), rnd(B.numpy()).astype(np.float64)
        ref[o] += a @ b
        mag[o] += np.abs(a) @ np.abs(b)
    for c, r, m in zip(got, ref, mag):  # K = 137 summed terms at most
        assert np.all(np.abs(c.numpy() - r) <= 137 * 2. ** -24 * m)
    if precision in ('float32', None):
        old = [A.float() @ B for A, B in zip(As, Bs)]
        np.testing.assert_array_equal(got[0].numpy(), (old[0] + old[1]).numpy())
        np.testing.assert_array_equal(got[1].numpy(), old[2].numpy())


@pytest.mark.parametrize('precision', PRECISIONS)
def test_cpu_wrapper_reads_the_precision(precision, precision_restored):
    """On the CPU the wrapper takes the plain version at config.matmul_precision."""
    rng = np.random.default_rng(13)
    As = [torch.from_numpy(rng.normal(size=(9, 20)).astype(np.float32))]
    Bs = [torch.from_numpy(rng.normal(size=(20, 7)).astype(np.float32))]
    config.matmul_precision = precision
    got = grouped_matmul(As, Bs)
    ref = grouped_matmul_plain(As, Bs, precision=precision)
    np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())


def test_layouts_are_kept_by_kind():
    """A pair list's layout is kept per kind of the kernel, as per dtype."""
    a = np.array([(0, 17, 1, 30, 17), (64, 5, 1, 30, 5)])
    b = np.array([(8, 40, 1, 17, 40), (72, 40, 1, 5, 40)])
    ia = ib = np.arange(2)
    tile = (128, 128)
    kinds = [grouped_gemm._layouts(a, ia, b, ib, [0, 0], None, torch.float32, tile, kind)
             for kind in ('float32', 'float32_mixed', 'tensorfloat32', 'default')]
    assert len({id(k) for k in kinds}) == 4
    assert grouped_gemm._layouts(a, ia, b, ib, [0, 0], None, torch.float32, tile) is kinds[0]


def test_kind_counts_are_counted_like_the_wrapper():
    """Each kind's count goes through _kernels.count as the wrapper's does: inside a
    graph's capture the graph records it, keyed by the counter (the branch that runs
    without a card; outside a capture the card tests count launches)."""
    from cyten_tpu_torch.blocks import _kernels

    counter = grouped_matmul.kinds['default']
    before = counter.launches
    recorder = type('Recorder', (), {'launches': {}, 'keep': []})()
    old, _kernels._capture = _kernels._capture, recorder
    try:
        _kernels.count(counter)
        _kernels.count(grouped_matmul, keep='table')
    finally:
        _kernels._capture = old
    assert recorder.launches == {counter: 1, grouped_matmul: 1}
    assert counter.launches == before


def test_conversions_are_tallied_like_launches():
    """grouped_matmul.converted goes through _kernels.tally: outside a capture it adds
    one, inside a graph's capture the graph records it for its replays to add."""
    from cyten_tpu_torch.blocks import _kernels

    before = grouped_matmul.converted
    _kernels.tally(grouped_matmul, 'converted')
    assert grouped_matmul.converted == before + 1
    recorder = type('Recorder', (), {'tallies': {}})()
    old, _kernels._capture = _kernels._capture, recorder
    try:
        _kernels.tally(grouped_matmul, 'converted')
        _kernels.tally(grouped_matmul, 'converted')
    finally:
        _kernels._capture = old
    assert recorder.tallies == {(grouped_matmul, 'converted'): 2}
    assert grouped_matmul.converted == before + 1


def test_mixed_tdot_on_the_cpu_widens_the_bf16_operand():
    """A bf16 block against an f32 block: on the CPU the product is that of the
    widened bf16 operand (TorchBlockBackend._dot_dtypes' promotion), in f32."""
    rng = np.random.default_rng(14)
    backend = get_backend(u1_symmetry, device='cpu')
    v = ElementarySpace(u1_symmetry, [[-1], [0], [1]], [5, 7, 4])
    p = ElementarySpace(u1_symmetry, [[-1], [1]], [1, 1])
    LP = SymmetricTensor.from_random_normal([v], [v, p], backend=backend, rng=rng,
                                            labels=[['a'], ['b', 'c']],
                                            dtype=Dtype.float32)
    th = SymmetricTensor.from_random_normal([v, p], [v], backend=backend, rng=rng,
                                            labels=[['d', 'e'], ['f']], dtype=Dtype.float32)
    LP16 = LP.to_dtype(Dtype.bfloat16)
    got = tdot(LP16, th, 'b', 'd')
    assert got.dtype == Dtype.float32
    ref = tdot(LP16.to_dtype(Dtype.float32), th, 'b', 'd')
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())


# --- per-operator precision of the matvec ---------------------------------------------

# the matvec against cyten_tpu's full f32 result: f32 rounding (1e-5 relative) at
# 'float32'; one operand rounding per product (2^-11 for TF32, 2^-8 for bf16) over
# the chain of three products at the other two
MATVEC_RTOL = {'float32': 1e-5, 'tensorfloat32': 3e-3, 'default': 2e-2}


@pytest.mark.parametrize('precision', PRECISIONS)
def test_heff_matmul_precision_matches_cyten_tpu(precision, precision_restored):
    from test_torch_dmrg import build_workload

    args = build_workload(ct.get_backend(ct.u1_symmetry, 'jax'), chi=24)
    LP, RP, W1, W2, theta = [t.to_dtype(JaxDtype.float32) for t in args]
    W1 = W1.relabelled({'p0': 'p', 'p0*': 'p*'})
    W2 = W2.relabelled({'p1': 'p', 'p1*': 'p*'})
    ref = JaxHEffective(LP, RP, W1, W2, matmul_precision=precision).matvec(theta)
    LP, RP, W1, W2, theta = (to_port(t) for t in (LP, RP, W1, W2, theta))
    H = HEffective(LP, RP, W1, W2, use_jit=True, matmul_precision=precision)
    assert H.matmul_precision == precision and H.use_jit
    config.matmul_precision = 'float32'
    got = H.matvec(theta)
    assert config.matmul_precision == 'float32'  # restored after the call
    r = np.asarray(ref.to_numpy())
    err = np.linalg.norm(got.to_numpy() - r) / np.linalg.norm(r)
    assert err < MATVEC_RTOL[precision]
    if precision != 'float32':  # the port does round: the mode is not a no-op
        exact = HEffective(LP, RP, W1, W2).matvec(theta)
        assert np.linalg.norm(got.to_numpy() - exact.to_numpy()) > 0


# --- the accuracy protocol, the signatures --------------------------------------------


def test_accuracy_bf16work_small():
    """bench.py's accuracy protocol (bf16 sweeps with the adaptive SVD at 'default',
    then one f32 polish sweep) at L=8, chi=16 against exact diagonalization: the
    polished energy within the reference's CPU result at L=24, chi=1024
    (.bench_accuracy.json: 1.04e-5)."""
    from cyten_tpu_torch.bench import accuracy_bf16work

    E, E_bf16, dE = accuracy_bf16work(chi=16, L=8, n_bf16_sweeps=4, device='cpu',
                                      e_ref=heisenberg_exact_finite_gs_energy(8, 1.))
    assert dE < 1.04e-5
    assert np.isfinite(E_bf16)


def test_reference_positional_calls():
    """cyten_tpu's positional calls work in both packages: DMRGEngine's 7th
    parameter is jit_env_updates, enable_static_mode's 3rd is max_period, which
    _static_runs reads. Both find the same runs on the product state; the port's
    runs after chi bucketing have the period asked for."""
    from cyten_tpu.algorithms import HeisenbergModel as JaxHeisenbergModel

    L = 6
    runs = []
    for Model, MPS, Engine, kw in ((HeisenbergModel, SimpleMPS, DMRGEngine,
                                    {'device': 'cpu'}),
                                   (JaxHeisenbergModel, JaxSimpleMPS, JaxDMRGEngine,
                                    {'block_backend': 'jax'})):
        model = Model(L=L, conserve='Sz', **kw)
        psi = MPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                     backend=model.backend)
        eng = Engine(psi, model, 32, 1e-12, None, 4, False)
        assert eng.jit_env_updates is False and eng.pad_chi_multiple == 4
        eng.enable_static_mode(10, 'steady', 1)
        assert eng._static_max_period == 1 and eng._static_svd_mode == 'steady'
        found = [eng._static_runs()]
        eng.enable_static_mode(10, 'steady', 2)
        found.append(eng._static_runs())
        runs.append(found)
    assert runs[0] == runs[1]
    assert {p for _, _, p in runs[0][0]} == {1} and 2 in {p for _, _, p in runs[0][1]}
    # the port after chi bucketing, static sweeps with the reference's arguments
    model = HeisenbergModel(L=L, conserve='Sz', device='cpu')
    psi = SimpleMPS.from_product_state(model.site_legs, [0, 1] * (L // 2),
                                       backend=model.backend)
    eng = DMRGEngine(psi, model, 32, 1e-12, None, 4, False)
    eng.run(n_sweeps=4)
    eng.enable_static_mode(10, 'steady', 2)
    E = eng.sweep()
    assert abs(E - heisenberg_exact_finite_gs_energy(L, 1.)) < 1e-9
    assert all(p <= 2 for _, _, p in eng._static_runs())
