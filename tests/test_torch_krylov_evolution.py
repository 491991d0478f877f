"""The Krylov propagators of the PyTorch port (``tensors/krylov_based.py``:
``LanczosEvolution``, ``Arnoldi``, ``lanczos_arpack``, ``fused_lanczos_evolution_impl``)
and the plain version of its ``tridiagonal_evolve`` kernel (``blocks/tridiag.py``),
against cyten_tpu and scipy.

The operator is cyten_tpu's tests/test_krylov.py fixture: a random hermitian U(1)
tensor on the leg [-1, 0, 1] with multiplicities [2, 3, 2], and a random start vector
(its charge-0 sector, three entries), made by cyten_tpu (numpy block backend) and
carried over by ``tools/interop.py``. The host-driven solvers are held to cyten_tpu's
to 1e-12, for real and imaginary ``delta`` and for real and complex states; the fused
evolution (cyten_tpu's runs under ``jax.disable_jit()``, its ``lax.scan`` then looping
in Python) to 1e-12, including the promotion of a real state under an imaginary
``delta`` and a Krylov space that closes before its N-th vector. The plain version of
``tridiagonal_evolve`` is held to ``scipy.linalg.expm(delta T) e_0`` on the Lanczos
families of tests/test_torch_tridiag.py to 1e-12 of the largest coefficient.
"""

import jax
import numpy as np
import pytest
import scipy.linalg
import torch

import cyten_tpu as ct
from cyten_tpu.tensors import LanczosEvolution as RefLanczosEvolution
from cyten_tpu.tensors import TensorLinearOperator as RefTensorLinearOperator
from cyten_tpu.tensors.krylov_based import Arnoldi as RefArnoldi
from cyten_tpu.tensors.krylov_based import (
    fused_lanczos_evolution_impl as ref_fused_evolution,
)
from cyten_tpu.tensors.krylov_based import lanczos_arpack as ref_lanczos_arpack

from cyten_tpu_torch.blocks.tridiag import tridiagonal_evolve, tridiagonal_evolve_plain
from cyten_tpu_torch.tensors import (
    Arnoldi, LanczosEvolution, TensorLinearOperator, lanczos, lanczos_arpack,
)
from cyten_tpu_torch.tensors.krylov_based import fused_lanczos_evolution_impl
from test_torch_interop import to_port
from test_torch_tridiag import FAMILIES, valid_block


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One thread for torch and for the BLAS under numpy, for the module's length (the
    time-evolution tests import it too). Their tensors are tiny: with the suite's
    workers side by side, more threads only contend, and these files then take about
    twice as long."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope='module')
def op():
    """(H, vec0, vec1) in cyten_tpu and in the port: hermitian H, two start vectors."""
    rng = np.random.default_rng(12345)
    leg = ct.ElementarySpace(ct.u1_symmetry, [[-1], [0], [1]], [2, 3, 2])
    be = ct.get_backend(ct.u1_symmetry, 'numpy')
    A = ct.SymmetricTensor.from_random_normal([leg], [leg], backend=be, rng=rng)
    H = 0.5 * (A + ct.dagger(A))
    vecs = [ct.SymmetricTensor.from_random_normal([leg], [], backend=be, rng=rng)
            for _ in range(2)]
    return (H, *vecs), tuple(to_port(t) for t in (H, *vecs))


def _state(pair, kind):
    """The start vector in both packages, real or complex."""
    (_, v0, v1), (_, p0, p1) = pair
    if kind == 'real':
        return v0, p0
    return v0 + 1j * v1, p0 + 1j * p1


def _close(got, want, tol=1e-12):
    g, w = np.asarray(got.to_numpy()), np.asarray(want.to_numpy())
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=tol * max(1., np.abs(w).max()))


@pytest.mark.parametrize('delta', [-0.3, 0.4, -0.3j, 0.25 - 0.5j])
@pytest.mark.parametrize('kind', ['real', 'complex'])
def test_lanczos_evolution_matches_cyten_tpu(op, delta, kind):
    ref_v, port_v = _state(op, kind)
    opts = {'N_max': 25, 'P_tol': 1e-16}
    want, n_ref = RefLanczosEvolution(RefTensorLinearOperator(op[0][0]), ref_v, opts).run(delta)
    got, n = LanczosEvolution(TensorLinearOperator(op[1][0]), port_v, opts).run(delta)
    assert n == n_ref
    _close(got, want)
    # and against the exact exponential
    expect = scipy.linalg.expm(delta * op[0][0].to_numpy()) @ ref_v.to_numpy()
    np.testing.assert_allclose(got.to_numpy(), expect, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize('which', ['LM', 'SR', 'LR'])
def test_arnoldi_matches_cyten_tpu(op, which):
    opts = {'N_max': 30, 'which': which, 'P_tol': 1e-14}
    E_ref, psi_ref, n_ref = RefArnoldi(RefTensorLinearOperator(op[0][0]), op[0][1], opts).run()
    E, psi, n = Arnoldi(TensorLinearOperator(op[1][0]), op[1][1], opts).run()
    assert n == n_ref
    assert abs(E - E_ref) < 1e-12
    got, want = np.asarray(psi.to_numpy()), np.asarray(psi_ref.to_numpy())
    phase = np.vdot(got, want) / abs(np.vdot(got, want))  # eig fixes vectors up to it
    np.testing.assert_allclose(got * phase, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match='invalid which'):
        Arnoldi(TensorLinearOperator(op[1][0]), op[1][1], {'which': 'XX'}).run()


def test_lanczos_arpack(op):
    E_ref, psi_ref, _ = ref_lanczos_arpack(RefTensorLinearOperator(op[0][0]), op[0][1])
    E, psi, n = lanczos_arpack(TensorLinearOperator(op[1][0]), op[1][1])
    assert n == -1 and abs(E - E_ref) < 1e-10
    assert abs(E - lanczos(TensorLinearOperator(op[1][0]), op[1][1],
                           {'N_max': 30, 'P_tol': 1e-14})[0]) < 1e-9
    got, want = np.asarray(psi.to_numpy()), np.asarray(psi_ref.to_numpy())
    assert abs(abs(np.vdot(got, want)) - 1.) < 1e-9


@pytest.mark.parametrize('N, delta, kind', [(2, -0.3, 'real'), (6, -0.3j, 'real'),
                                             (6, 0.2 - 0.3j, 'complex')])
def test_fused_evolution_matches_cyten_tpu(op, N, delta, kind):
    """N=6 runs past the three-dimensional Krylov space (its beta_2 vanishes: the valid
    mask); a real state under an imaginary delta is promoted before the loop. (The two
    N=6 cases share their shapes, so cyten_tpu's unjitted loop compiles its operations
    once for both.)"""
    ref_v, port_v = _state(op, kind)
    with jax.disable_jit():
        want = ref_fused_evolution(RefTensorLinearOperator(op[0][0]), ref_v, delta, N)
    got = fused_lanczos_evolution_impl(TensorLinearOperator(op[1][0]), port_v, delta, N)
    assert got.dtype.is_complex == (kind == 'complex' or isinstance(delta, complex))
    _close(got, want)
    if N >= 3:  # the whole space: exact
        expect = scipy.linalg.expm(delta * op[0][0].to_numpy()) @ ref_v.to_numpy()
        np.testing.assert_allclose(got.to_numpy(), expect, rtol=0, atol=1e-12)


@pytest.mark.parametrize('label, ab', FAMILIES, ids=[f[0] for f in FAMILIES])
@pytest.mark.parametrize('delta', [-0.05, 0.05, -0.05j, 0.02 + 0.05j])
def test_tridiagonal_evolve_plain_matches_expm(label, ab, delta):
    """nrm0 exp(delta T) e_0 on the valid leading block, zeros after it; from f64 and
    f32 buffers (the f32 one rounded first)."""
    for dtype in (torch.float64, torch.float32):
        t = torch.from_numpy(ab).to(dtype)
        nrm0 = torch.tensor(1.7, dtype=dtype)
        got = tridiagonal_evolve_plain(t, delta, nrm0)
        assert got.dtype == (torch.complex128 if isinstance(delta, complex)
                             else torch.float64)
        T, m = valid_block(t.double().numpy())
        want = np.zeros(ab.shape[1], complex)
        want[:m] = scipy.linalg.expm(delta * T)[:, 0] * float(nrm0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * max(1., np.abs(want).max()))
        assert torch.equal(tridiagonal_evolve(t, delta, nrm0), got)  # the CPU route


def test_tridiagonal_evolve_refuses_a_device_without_kernel():
    with pytest.raises(NotImplementedError):
        tridiagonal_evolve(torch.zeros(2, 10, device='meta'), -0.1j,
                           torch.zeros((), device='meta'))
