"""The Ritz problem of the port's fused Lanczos (``blocks/tridiag.py``) on the
Lanczos matrices its kernel must handle, against numpy's ``eigh``.

The families (:func:`lanczos_families`) are shared with the kernel's card tests
(``tests/test_torch_cuda.py``) and with ``chip_smoke.py``. Here the plain version,
which the wrapper takes on the CPU, is held against ``numpy.linalg.eigh`` of the valid
leading block: that the answer is the lowest eigenpair of that block, with zeros
after it, is what the kernel's design rests on.
"""

import numpy as np
import pytest
import torch

from cyten_tpu_torch.blocks.tridiag import (
    tridiagonal_ground_state, tridiagonal_ground_state_plain,
)

E_CONVERGED = -10.45378576040958  # an L=24 Heisenberg energy, as a converged alpha_0


def _lanczos_of_spectrum(spectrum, rng):
    """``(alphas, betas)`` of len(spectrum) Lanczos steps with full
    reorthogonalisation on diag(spectrum) from a random start: a tridiagonal matrix
    with that spectrum, to rounding."""
    n = len(spectrum)
    Q = np.zeros((n, n))
    q = rng.normal(size=n)
    Q[0] = q / np.linalg.norm(q)
    a, b = np.zeros(n), np.zeros(n)
    for k in range(n):
        w = spectrum * Q[k]
        a[k] = Q[k] @ w
        w -= Q[:k + 1].T @ (Q[:k + 1] @ w)
        w -= Q[:k + 1].T @ (Q[:k + 1] @ w)
        b[k] = np.linalg.norm(w)
        if k + 1 < n:
            Q[k + 1] = w / b[k]
    return a, b


def lanczos_families(rng):
    """``(label, ab)``: ``[2, N]`` f64 arrays of alphas and betas, the Lanczos matrices
    of a fixed-length solve that the Ritz kernel must handle:
    - N=1;
    - N=10 closing at every k from 0 to N-2 (beta_k = 1e-14; later alphas garbage);
    - graded, like a converged state's: alpha_0 = E, beta_0 from 1e-6 to 1e-11, the
      rest O(1) and above E, at N=10 and 20;
    - a lowest pair split by 1e-10 |T|, as a Lanczos ghost gives, at N=10 and 20;
    - random at N=10, 20, 37 and 64."""
    cases = [('N=1', np.array([[0.7], [0.3]]))]
    n = 10
    for k in range(n - 1):
        a, b = rng.normal(size=n), 0.1 + np.abs(rng.normal(size=n))
        b[k] = 1e-14
        a[k + 1:] = 1e3 * rng.normal(size=n - k - 1)
        cases.append((f'closes at {k} N={n}', np.stack([a, b])))
    for n in (10, 20):
        for beta0 in (1e-6, 1e-7, 1e-8, 1e-9, 1e-10, 1e-11):
            # the rest of the spectrum lies above E: E - O(beta_0^2) is the lowest
            a = E_CONVERGED + 4. + np.abs(rng.normal(size=n))
            b = 0.25 + 0.25 * np.abs(rng.normal(size=n))
            a[0], b[0] = E_CONVERGED, beta0
            cases.append((f'graded beta_0={beta0:.0e} N={n}', np.stack([a, b])))
    for n in (10, 20):
        spectrum = np.sort(rng.uniform(-1., 3., size=n))
        spectrum[0] = -2.
        spectrum[1] = -2. + 1e-10 * 3.
        cases.append((f'near-degenerate N={n}', np.stack(_lanczos_of_spectrum(spectrum, rng))))
    for n in (10, 20, 37, 64):
        cases.append((f'random N={n}', np.stack([rng.normal(size=n),
                                                 0.1 + np.abs(rng.normal(size=n))])))
    return cases


FAMILIES = lanczos_families(np.random.default_rng(11))


def valid_block(ab):
    """The valid leading block of the Lanczos matrix ``ab``, as numpy arrays
    ``(T, m)``: the Krylov space closes after the first beta_k <= 1e-12, k < N-1."""
    a, b = np.asarray(ab, np.float64)
    m = len(a)
    for k in range(len(a) - 1):
        if not b[k] > 1e-12:
            m = k + 1
            break
    return np.diag(a[:m]) + np.diag(b[:m - 1], 1) + np.diag(b[:m - 1], -1), m


def check_ground_state(E, v, ab, ref=None, label=''):
    """``(E, v)`` against ``ref``, an ``(E, v)`` pair (by default numpy's eigh of the
    valid block, its vector's largest entry made positive and padded with zeros): E to
    1e-12 relative; v to 1e-10 where the gap to the second eigenvalue is at least
    1e-8 |T|, else by its residual |T v - E v| <= 1e-13 |T|; v a unit vector whose
    largest entry is positive, zero after the valid block."""
    T, m = valid_block(ab)
    E, v = float(E), np.asarray(v, np.float64)
    evals, evecs = np.linalg.eigh(T)
    if ref is None:
        v0 = np.zeros(len(v))
        v0[:m] = evecs[:, 0] * np.sign(evecs[np.abs(evecs[:, 0]).argmax(), 0])
        ref = evals[0], v0
    E_ref, v_ref = float(ref[0]), np.asarray(ref[1], np.float64)
    norm_T = np.abs(evals).max()
    assert abs(E - E_ref) <= 1e-12 * abs(E_ref), (label, E, E_ref)
    assert abs(np.linalg.norm(v) - 1.) <= 1e-12, label
    assert v[np.abs(v).argmax()] > 0, label
    np.testing.assert_array_equal(v[m:], 0., err_msg=label)
    if m > 1 and evals[1] - evals[0] < 1e-8 * norm_T:
        assert np.linalg.norm(T @ v[:m] - E * v[:m]) <= 1e-13 * norm_T, label
    else:
        np.testing.assert_allclose(v, v_ref, rtol=0, atol=1e-10, err_msg=label)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('label, ab', FAMILIES, ids=[label for label, _ in FAMILIES])
def test_plain_matches_numpy_eigh(label, ab, dtype):
    """The plain version, as the wrapper takes it on the CPU, on each family, from an
    f64 and an f32 buffer (the fused Lanczos's accumulator types; the f32 values are
    the matrix then)."""
    t = torch.from_numpy(ab).to(dtype)
    E, v = tridiagonal_ground_state(t)
    assert E.dtype == v.dtype == torch.float64 and v.shape == (ab.shape[1],)
    E_plain, v_plain = tridiagonal_ground_state_plain(t)
    assert float(E) == float(E_plain) and torch.equal(v, v_plain)
    check_ground_state(E, v.numpy(), t.double().numpy(), label=label)


def test_families_span_the_gap_cases():
    """The near-degenerate family is checked by its residual, the others by their
    vectors: each branch of check_ground_state is taken."""
    small = []
    for label, ab in FAMILIES:
        T, m = valid_block(ab)
        if m > 1:
            evals = np.linalg.eigvalsh(T)
            small.append(evals[1] - evals[0] < 1e-8 * np.abs(evals).max())
    assert any(small) and not all(small)


def test_wrapper_refuses_a_device_without_kernel():
    with pytest.raises(NotImplementedError):
        tridiagonal_ground_state(torch.zeros(2, 10, device='meta'))
