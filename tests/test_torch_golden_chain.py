"""The Fibonacci golden chain in the PyTorch port against cyten_tpu, on the CPU.

Inputs are drawn once in cyten_tpu from a numpy seed and carried over exactly
(test_torch_interop.export_tensor, with the anyon factor names of
``cyten_tpu_torch.tools.interop``). The reference side uses cyten_tpu's numpy block
backend, and its jax one only for the fused Lanczos (a ``lax.scan``). Tolerances:
1e-12 for tensors and the Lanczos solve (``cyten_tpu/testing/asserting.py:14``),
1e-9 on ground-state energies (``BASELINE.md``: MPSKit.jl's golden-chain energies).

    PYTHONPATH=. python tests/test_torch_golden_chain.py --golden28-ref

re-takes ``cyten_tpu_torch.bench.GOLDEN28_E_REF`` with cyten_tpu (a few minutes).
"""

import sys

import numpy as np
import pytest

import cyten_tpu as ct
from cyten_tpu.algorithms import DMRGEngine as JaxDMRGEngine
from cyten_tpu.algorithms import SimpleMPS as JaxSimpleMPS
from cyten_tpu.algorithms.dmrg import HEffective as JaxHEffective
from cyten_tpu.algorithms.dmrg import _heff_matvec_impl as jax_heff_matvec
from cyten_tpu.algorithms.models import GoldenChainModel as JaxGoldenChainModel
from cyten_tpu.backends.fusion_tree import FusionTreeBackend
from cyten_tpu.tensors.krylov_based import _close_structure
from cyten_tpu.tensors.krylov_based import fused_lanczos_impl as jax_fused_lanczos
from cyten_tpu.tensors.steady import steady_truncated_svd as jax_steady_svd

from cyten_tpu_torch.algorithms import DMRGEngine, GoldenChainModel, HEffective, SimpleMPS
from cyten_tpu_torch.algorithms.dmrg import _heff_matvec_impl
from cyten_tpu_torch.bench import build_golden_workload
from cyten_tpu_torch.dtypes import Dtype
from cyten_tpu_torch.tensors.krylov_based import fused_lanczos_impl
from cyten_tpu_torch.tensors.steady import steady_truncated_svd
from cyten_tpu_torch.tools.interop import mps_from_arrays
from test_torch_interop import export_mps, port_backend, to_port

TOL = 1e-12


def numpy_backend():
    return FusionTreeBackend(ct.get_block_backend('numpy'))


def assert_same_blocks(got, ref, tol=TOL):
    """Same block structure and blocks to ``tol`` (relative to the largest entry):
    anyonic tensors have no dense form to compare."""
    assert got.labels == ref.labels
    assert got.dtype.name == ref.dtype.name
    np.testing.assert_array_equal(got.data.block_inds, ref.data.block_inds)
    scale = max([float(np.abs(np.asarray(b)).max()) for b in ref.data.blocks if b.size]
                + [1.])
    for g, r in zip(got.data.blocks, ref.data.blocks):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=tol * scale)


def golden_workload(chi_mult=8, seed=0):
    """The golden-chain bond environment of bench.py:334-380 (build_golden_workload)
    in cyten_tpu, on its numpy backend: ``LP, RP, W1, W2, theta``, the bulk MPO
    tensor made real, the virtual leg split 1 : phi between the two sectors. (Written
    out here: importing bench.py starts its run budget in the test process.)"""
    from cyten_tpu.algorithms.models import mpo_from_bond_op

    backend = numpy_backend()
    rng = np.random.default_rng(seed)
    W = mpo_from_bond_op(JaxGoldenChainModel(L=2, backend=backend).H_bonds[0], 2,
                         bc='infinite')[0]
    W = W.to_dtype(W.dtype.to_real)
    phi = (1 + 5 ** 0.5) / 2
    m_tau = max(1, int(round(chi_mult * phi / (1 + phi))))
    v_leg = ct.ElementarySpace(W.symmetry, [[0], [1]], [chi_mult - m_tau, m_tau])
    p_leg = W.get_leg_co_domain('p')
    w_leg = W.get_leg_co_domain('wL')
    kw = dict(backend=backend, rng=rng, dtype=W.dtype)
    LP = ct.SymmetricTensor.from_random_normal([v_leg], [v_leg, w_leg],
                                               labels=[['vR*'], ['vR', 'wR']], **kw)
    RP = ct.SymmetricTensor.from_random_normal([v_leg, w_leg], [v_leg],
                                               labels=[['vL', 'wL'], ['vL*']], **kw)
    theta = ct.SymmetricTensor.from_random_normal([v_leg, p_leg, p_leg], [v_leg],
                                                  labels=['vL', 'p0', 'p1', 'vR'], **kw)
    return (LP, RP, W.relabelled({'p': 'p0', 'p*': 'p0*'}),
            W.relabelled({'p': 'p1', 'p*': 'p1*'}), theta)


def complex_theta(theta, seed=1):
    """A random complex128 theta on the legs of ``theta`` (cyten_tpu)."""
    return ct.SymmetricTensor.from_random_normal(
        theta.codomain.factors, theta.domain.factors, backend=theta.backend,
        labels=theta.labels, rng=np.random.default_rng(seed), dtype=ct.Dtype.complex128)


def test_mpo_is_cyten_tpus_complex_mpo():
    """The port's GoldenChainModel builds cyten_tpu's MPO: complex128, from the
    complex SVD of the bond projector, the same blocks as the MPO carried across
    by tools/interop.py."""
    L = 4
    ref = JaxGoldenChainModel(L=L, block_backend='numpy')
    got = GoldenChainModel(L, device='cpu')
    assert got.H_bonds[0].dtype == Dtype.float64
    assert_same_blocks(got.H_bonds[0], ref.H_bonds[0])
    for W, W_ref in zip(got.H_mpo, ref.H_mpo):
        assert W.dtype == Dtype.complex128
        assert_same_blocks(W, W_ref)
        assert_same_blocks(to_port(W_ref), W_ref, tol=0.)


def test_fusion_pair_state_and_bond_expectation_value():
    """``from_fusion_pairs`` gives cyten_tpu's f64 state; after two sweeps of
    cyten_tpu's DMRG (a complex state) every bond energy agrees to 1e-12."""
    L = 6
    ref = JaxGoldenChainModel(L=L, block_backend='numpy')
    model = GoldenChainModel(L, device='cpu')
    psi_ref = JaxSimpleMPS.from_fusion_pairs(ref.site_leg, L, backend=ref.backend)
    psi = SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend)
    for B, B_ref in zip(psi.Bs, psi_ref.Bs):
        assert B.dtype == Dtype.float64
        assert_same_blocks(B, B_ref)
    assert abs(model.energy(psi) - ref.energy(psi_ref)) < TOL
    JaxDMRGEngine(psi_ref, ref, chi_max=8, eps=1e-13).run(n_sweeps=2)
    spec = export_mps(psi_ref)
    psi = mps_from_arrays(spec, port_backend(spec['Bs'][0]['symmetry']))
    assert psi.Bs[1].dtype == Dtype.complex128
    for i, h in enumerate(model.H_bonds):
        got = complex(psi.bond_expectation_value(h, i))
        want = complex(psi_ref.bond_expectation_value(ref.H_bonds[i], i))
        assert abs(got - want) < TOL
    assert abs(model.energy(psi) - ref.energy(psi_ref)) < TOL


def test_port_bench_workload_is_the_reference_one():
    """``cyten_tpu_torch.bench.build_golden_workload`` draws the same tensors, its
    MPO made real as bench.py makes it."""
    ref = golden_workload()
    got = build_golden_workload(to_port(ref[0]).backend, chi_mult=8)
    for g, r in zip(got, ref):
        assert_same_blocks(g, r)


def test_heff_matvec_matches_cyten_tpu():
    """The matvec on the golden workload: its output is complex128 (the anyonic tree
    plans carry complex coefficients) and agrees to 1e-12, also on a complex theta."""
    args = golden_workload()
    for theta in (args[4], complex_theta(args[4])):
        ref = jax_heff_matvec(*args[:4], theta)
        got = _heff_matvec_impl(*(to_port(t) for t in args[:4]), to_port(theta))
        assert got.dtype == Dtype.complex128
        assert_same_blocks(got, ref)


def _on_jax(t):
    """``t`` (numpy block backend) with its blocks as jax arrays, on the jax block
    backend, which cyten_tpu's fused Lanczos (a ``lax.scan``) needs."""
    import jax.numpy as jnp
    from cyten_tpu.backends.data import BlockSparseData

    data = BlockSparseData([jnp.asarray(b) for b in t.data.blocks], t.data.block_inds,
                           t.data.dtype, is_sorted=True)
    return ct.SymmetricTensor(data, t.codomain, t.domain,
                              ct.get_backend(t.symmetry, 'jax'), t.labels)


def test_fused_lanczos_matches_cyten_tpu():
    """``fused_lanczos_impl`` on a complex Fibonacci theta: real Lanczos scalars of a
    complex Krylov space in the qdim metric (phi-weighted blocks), so E and the Ritz
    vector (up to its phase) agree with cyten_tpu's to 1e-12."""
    LP, RP, W1, W2, theta = golden_workload()
    W1 = W1.relabelled({'p0': 'p', 'p0*': 'p*'})
    W2 = W2.relabelled({'p1': 'p', 'p1*': 'p*'})
    theta = _close_structure(JaxHEffective(LP, RP, W1, W2, use_jit=False),
                             complex_theta(theta))
    H = JaxHEffective(*map(_on_jax, (LP, RP, W1, W2)), use_jit=False)
    E_ref, th_ref = jax_fused_lanczos(H, _on_jax(theta), 8)
    E, th = fused_lanczos_impl(HEffective(*map(to_port, (LP, RP, W1, W2))),
                               to_port(theta), 8)
    assert abs(float(E) - float(E_ref)) < TOL * abs(float(E_ref))
    got = np.concatenate([b.numpy().ravel() for b in th.data.blocks])
    ref = np.concatenate([np.asarray(b).ravel() for b in th_ref.data.blocks])
    phase = np.vdot(got, ref)
    np.testing.assert_allclose(got * phase / abs(phase), ref, rtol=0, atol=TOL)


def test_steady_svd_matches_cyten_tpu():
    """The steady SVD of a complex Fibonacci theta, warm-started from the exact right
    isometry: U, S and Vh agree with cyten_tpu's to 1e-12 (conjugate transposes
    throughout), and U S Vh gives theta back."""
    from cyten_tpu_torch.tensors import compose, norm

    theta = complex_theta(golden_workload()[4])
    thp = ct.tensors.permute_legs(theta, ['vL', 'p0'], ['vR', 'p1'])
    Vh_prev = ct.tensors.svd(thp, new_labels=['vR', 'vL'])[2]
    U_ref, S_ref, Vh_ref, err_ref = jax_steady_svd(thp, Vh_prev)
    U, S, Vh, err = steady_truncated_svd(to_port(thp), to_port(Vh_prev))
    for g, r in ((U, U_ref), (Vh, Vh_ref)):
        assert_same_blocks(g, r)
    for g, r in zip(S.data.blocks, S_ref.data.blocks):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)
    assert abs(float(err) - float(err_ref)) < 1e-7  # sqrt(1 - x) of x = 1 - O(eps)
    back = compose(compose(U, S), Vh)
    assert float(norm(back - to_port(thp))) < 1e-10 * float(norm(to_port(thp)))


@pytest.mark.parametrize('L', [6, 8, 10])
def test_dmrg_matches_mpskit_and_cyten_tpu(L):
    """The BASELINE.md anchor: DMRG of the golden chain within 1e-9 of MPSKit.jl's
    energy, and of cyten_tpu's DMRG on the same state."""
    model = GoldenChainModel(L, device='cpu')
    psi = SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend)
    E = DMRGEngine(psi, model, chi_max=16, eps=1e-13).run(n_sweeps=6)
    assert psi.Bs[1].dtype == Dtype.complex128
    assert abs(E - model.exact_finite_gs_energy()) < 1e-9
    assert abs(model.energy(psi) - E) < 1e-9
    ref = JaxGoldenChainModel(L=L, block_backend='numpy')
    psi_ref = JaxSimpleMPS.from_fusion_pairs(ref.site_leg, L, backend=ref.backend)
    E_ref = JaxDMRGEngine(psi_ref, ref, chi_max=16, eps=1e-13).run(n_sweeps=6)
    assert abs(E - E_ref) < 1e-9


def test_static_mode():
    """The counterpart of tests/test_dmrg.py::test_static_mode_golden_chain (L=6):
    five dynamic sweeps, then static steady sweeps, eager and batched, within 1e-9
    of MPSKit.jl's energy."""
    L = 6
    model = GoldenChainModel(L, device='cpu')
    psi = SimpleMPS.from_fusion_pairs(model.site_leg, L, backend=model.backend)
    eng = DMRGEngine(psi, model, chi_max=16, eps=1e-13)
    for _ in range(5):
        eng.sweep()
    eng.enable_static_mode(n_lanczos=16, svd_mode='steady')
    E_exact = model.exact_finite_gs_energy()
    for _ in range(2):
        assert abs(eng.sweep() - E_exact) < 1e-9
    assert abs(eng.sweep_static_batched() - E_exact) < 1e-9


def golden28_reference(n_sweeps: int = 10):
    """``GOLDEN28_E_REF``: cyten_tpu's DMRG of the L=28 golden chain at chi_max=512
    multiplets, eps=0, N_max=10, from fusion pairs, on its numpy block backend; the
    energy and the centre bond's multiplets after each sweep."""
    model = JaxGoldenChainModel(L=28, block_backend='numpy')
    psi = JaxSimpleMPS.from_fusion_pairs(model.site_leg, 28, backend=model.backend)
    eng = JaxDMRGEngine(psi, model, chi_max=512, eps=0., lanczos_options={'N_max': 10})
    for sweep in range(n_sweeps):
        E = float(eng.sweep())
        print(sweep + 1, repr(E), int(np.sum(psi.Ss[14].leg.multiplicities)), flush=True)
    return E


if __name__ == '__main__':
    if '--golden28-ref' in sys.argv[1:]:
        golden28_reference()
