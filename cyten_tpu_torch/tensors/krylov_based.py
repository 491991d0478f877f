"""Krylov-subspace eigensolvers and propagators on tensors: host-driven, or fused with
no host sync.

The counterpart of ``cyten_tpu/tensors/krylov_based.py``: ``LanczosGroundState``,
``LanczosEvolution`` (:162-202), ``Arnoldi`` (:205-259), ``lanczos`` (:262),
``lanczos_arpack`` (:469-482), and the fused solvers of static mode and of the fused
TDVP site steps (``lanczos_fused``, ``fused_lanczos_impl``,
``fused_lanczos_evolution_impl``, ``_close_structure``; :270-466). The matvec runs on
the tensors' device. The host-driven solvers read every Krylov scalar on the host,
solve the small Krylov problem with numpy or scipy and stop when converged; the fused
solvers run a fixed number of iterations whose scalars stay on the device, where
their Krylov problem is solved too (``blocks/tridiag.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backends.data import DenseData
from ..blocks.tridiag import tridiagonal_evolve, tridiagonal_ground_state
from ._functions import inner, norm, scalar_multiply
from ._tensors import Tensor
from .sparse import LinearOperator

__all__ = ['KrylovBased', 'Arnoldi', 'LanczosGroundState', 'LanczosEvolution',
           'lanczos', 'lanczos_arpack', 'lanczos_fused', 'fused_lanczos_impl',
           'fused_lanczos_evolution_impl']


class KrylovBased:
    """Shared machinery for Krylov-subspace algorithms.

    Options (passed as dict, like the reference's): N_min, N_max, P_tol, E_tol,
    min_gap, cutoff, reortho.
    """

    def __init__(self, H: LinearOperator, psi0: Tensor, options: dict = None):
        self.H = H
        self.psi0 = psi0
        options = options or {}
        self.N_min = options.get('N_min', 3)
        self.N_max = options.get('N_max', 20)
        # None disables the energy-difference criterion (default: the
        # previous np.inf default made |E - E_old| < E_tol ALWAYS true, so
        # every solve silently stopped at N_min iterations)
        self.E_tol = options.get('E_tol', None)
        self.P_tol = options.get('P_tol', 1e-14)
        self.min_gap = options.get('min_gap', 1e-12)
        self.cutoff = options.get('cutoff', 1e-12)
        self.reortho = options.get('reortho', False)


class LanczosGroundState(KrylovBased):
    """Lanczos ground-state search for hermitian operators."""

    def run(self) -> tuple[float, Tensor, int]:
        """Returns ``(E0, psi0, N_iterations)``."""
        H, psi = self.H, self.psi0
        psi_norm = norm(psi)
        if not np.isfinite(psi_norm):
            # a NaN site tensor at the bond being updated: a numerical fault, which
            # DMRGEngine.run rolls back like a non-finite energy
            raise FloatingPointError(f'non-finite initial vector (norm {psi_norm})')
        assert psi_norm > 0, 'zero initial vector'
        q = scalar_multiply(1. / psi_norm, psi)
        basis = [q]
        alphas: list[float] = []
        betas: list[float] = []
        E_old = None
        theta = None
        for k in range(self.N_max):
            w = H.matvec(basis[-1])
            alpha = float(np.real(inner(basis[-1], w)))
            alphas.append(alpha)
            w = w - scalar_multiply(alpha, basis[-1])
            if len(basis) > 1:
                w = w - scalar_multiply(betas[-1], basis[-2])
            if self.reortho:
                for b in basis[:-1]:
                    w = w - scalar_multiply(inner(b, w), b)
            beta = norm(w)
            # solve the small tridiagonal problem
            T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
            evals, evecs = np.linalg.eigh(T)
            E = evals[0]
            v0 = evecs[:, 0]
            converged = False
            if beta < self.cutoff:
                converged = True
            if k + 1 >= self.N_min:
                if self.E_tol is not None and E_old is not None \
                        and abs(E - E_old) < self.E_tol:
                    converged = True
                # Ritz residual estimate: |beta * v0[-1]|
                if abs(beta * v0[-1]) ** 2 < self.P_tol:
                    converged = True
            E_old = E
            if converged or k == self.N_max - 1:
                theta = scalar_multiply(complex(v0[0]) if np.iscomplexobj(v0)
                                        else float(v0[0]), basis[0])
                for coeff, b in zip(v0[1:], basis[1:]):
                    theta = theta + scalar_multiply(
                        complex(coeff) if np.iscomplexobj(v0) else float(coeff), b)
                theta_norm = norm(theta)
                if theta_norm > 0:
                    theta = scalar_multiply(1. / theta_norm, theta)
                return float(E), theta, k + 1
            betas.append(float(beta))
            basis.append(scalar_multiply(1. / beta, w))
        raise RuntimeError('unreachable')


class LanczosEvolution(KrylovBased):
    """Compute ``exp(delta * H) |psi0>`` in the Krylov subspace (host-driven: the small
    ``exp(delta T)`` by ``scipy.linalg.expm`` on the host, as ``cyten_tpu``'s)."""

    def processing(self, delta) -> tuple[Tensor, int]:
        import scipy.linalg

        H, psi = self.H, self.psi0
        psi_norm = norm(psi)
        q = scalar_multiply(1. / psi_norm, psi)
        basis = [q]
        alphas: list[float] = []
        betas: list[float] = []
        result_coeffs = None
        for k in range(self.N_max):
            w = H.matvec(basis[-1])
            alpha = float(np.real(inner(basis[-1], w)))
            alphas.append(alpha)
            w = w - scalar_multiply(alpha, basis[-1])
            if len(basis) > 1:
                w = w - scalar_multiply(betas[-1], basis[-2])
            if self.reortho:
                for b in basis[:-1]:
                    w = w - scalar_multiply(inner(b, w), b)
            beta = norm(w)
            T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
            expT = scipy.linalg.expm(delta * T)
            coeffs = expT[:, 0]
            converged = beta < self.cutoff or (
                k + 1 >= self.N_min and abs(coeffs[-1]) < self.P_tol)
            if converged or k == self.N_max - 1:
                result_coeffs = coeffs
                break
            betas.append(float(beta))
            basis.append(scalar_multiply(1. / beta, w))
        theta = scalar_multiply(complex(result_coeffs[0]) * psi_norm, basis[0])
        for c, b in zip(result_coeffs[1:], basis[1:]):
            theta = theta + scalar_multiply(complex(c) * psi_norm, b)
        return theta, len(alphas)

    def run(self, delta) -> tuple[Tensor, int]:
        return self.processing(delta)


class Arnoldi(KrylovBased):
    """Arnoldi iteration for (possibly non-hermitian) operators.

    Finds the eigenvalue of largest magnitude (``which='LM'``) or smallest real part
    (``'SR'``), etc., with the corresponding Ritz vector.
    """

    def __init__(self, H, psi0, options: dict = None):
        KrylovBased.__init__(self, H, psi0, options)
        options = options or {}
        self.which = options.get('which', 'LM')

    def _select(self, evals):
        if self.which == 'LM':
            return int(np.argmax(np.abs(evals)))
        if self.which == 'SR':
            return int(np.argmin(np.real(evals)))
        if self.which == 'LR':
            return int(np.argmax(np.real(evals)))
        raise ValueError(f'invalid which: {self.which}')

    def run(self) -> tuple[complex, Tensor, int]:
        H, psi = self.H, self.psi0
        q = scalar_multiply(1. / norm(psi), psi)
        basis = [q]
        h = np.zeros((self.N_max + 1, self.N_max), dtype=complex)
        E_old = None
        for k in range(self.N_max):
            w = H.matvec(basis[-1])
            for i, b in enumerate(basis):
                h[i, k] = inner(b, w)
                w = w - scalar_multiply(h[i, k], b)
            beta = norm(w)
            h[k + 1, k] = beta
            Hk = h[:k + 1, :k + 1]
            evals, evecs = np.linalg.eig(Hk)
            sel = self._select(evals)
            E = evals[sel]
            v0 = evecs[:, sel]
            converged = beta < self.cutoff
            if k + 1 >= self.N_min and E_old is not None:
                if (self.E_tol is not None and abs(E - E_old) < self.E_tol) \
                        or abs(beta * v0[-1]) ** 2 < self.P_tol:
                    converged = True
            E_old = E
            if converged or k == self.N_max - 1:
                theta = scalar_multiply(complex(v0[0]), basis[0])
                for c, b in zip(v0[1:], basis[1:]):
                    theta = theta + scalar_multiply(complex(c), b)
                n = norm(theta)
                if n > 0:
                    theta = scalar_multiply(1. / n, theta)
                return complex(E), theta, k + 1
            basis.append(scalar_multiply(1. / beta, w))
        raise RuntimeError('unreachable')


def lanczos(H: LinearOperator, psi0: Tensor, options: dict = None
            ) -> tuple[float, Tensor, int]:
    """Ground state of a hermitian operator via Lanczos. Returns (E0, psi0, N).

    ``options={'fused': True, 'N_max': N}`` runs :func:`lanczos_fused`."""
    if (options or {}).get('fused'):
        return lanczos_fused(H, psi0, options)
    return LanczosGroundState(H, psi0, options).run()


# --- fused (static-mode) Lanczos ---------------------------------------------------------


def _sqrt_weights(t, dtype: torch.dtype, flat: bool = False):
    """The square roots of the block weights of ``t`` in ``norm`` and ``inner``
    (``TensorBackend.block_weights``: on the fusion-tree backend the quantum dimension
    of each block's coupled sector) as a vector on ``t``'s device, one per block, or
    (``flat``) one per element of the layout of :func:`_flatten`; None where every
    block weighs 1. Made once per structure (``TorchBlockBackend.cached``), so that
    nothing is copied from the host on later calls, in a CUDA graph in particular."""
    qdims = t.backend.block_weights(t)
    if qdims is None:
        return None
    bb = t.backend.block_backend
    sizes = tuple(b.numel() for b in t.data.blocks) if flat else None

    def build():
        w = np.sqrt(np.asarray(qdims))
        if flat:
            w = np.repeat(w, sizes)
        return torch.as_tensor(w, dtype=dtype).to(bb.device)

    return bb.cached(('sqrt_weights', qdims, sizes, dtype), build)


def _device_norm(t):
    """Norm of a block-sparse or diagonal tensor as a 0-d tensor on its device, with no
    host sync: one ``_foreach_norm`` over the blocks and one norm of the results (bf16
    blocks accumulate in f32). Each block has its weight in ``norm``
    (:func:`_sqrt_weights`); an abelian tensor's blocks weigh 1 and take no
    multiply. A tensor without symmetry is its one dense block."""
    bb = t.backend.block_backend
    if isinstance(t.data, DenseData):
        block = t.data.block
        acc = torch.float32 if block.dtype == torch.bfloat16 else None
        return torch.linalg.vector_norm(block, dtype=acc)
    blocks = t.data.blocks
    if not blocks:
        return torch.zeros((), dtype=torch.float64, device=bb.device)
    acc = torch.float32 if blocks[0].dtype == torch.bfloat16 else None
    norms = torch.stack(torch._foreach_norm(blocks, 2, dtype=acc))
    weights = _sqrt_weights(t, norms.dtype)
    if weights is not None:
        norms = norms * weights
    return torch.linalg.vector_norm(norms)


def _flatten(t) -> torch.Tensor:
    """The blocks of ``t`` one after the other in one new vector."""
    return torch.cat([b.reshape(-1) for b in t.data.blocks])


def _with_blocks(template, blocks):
    """A tensor with the legs, labels and block indices of ``template`` and the
    blocks ``blocks`` (one per block of ``template``, in its order; for dense data its
    one block, or none for a shell)."""
    res = template.copy(deep=False)
    if isinstance(template.data, DenseData):
        res.data = DenseData(blocks[0] if blocks else None, template.data.dtype)
    else:
        res.data = type(template.data)(blocks, template.data.block_inds,
                                       template.data.dtype, is_sorted=True)
    return res


def _unflatten(template, flat: torch.Tensor):
    """A tensor with the legs, labels and block structure of ``template`` whose blocks
    are views of the vector ``flat`` (the layout of :func:`_flatten`)."""
    blocks = template.data.blocks
    parts = flat.split([b.numel() for b in blocks])
    return _with_blocks(template, [p.view(b.shape) for p, b in zip(parts, blocks)])


def _union_embed(t, other):
    """Embed `t` into the union of its and `other`'s block structure (zero-filled).

    Both must be SymmetricTensors on the same legs with BlockSparseData-style
    data (rows of block indices + a block list).
    """
    from ..backends.data import BlockSparseData

    a, b = t.data, other.data
    rows = {tuple(r): ('a', n) for n, r in enumerate(a.block_inds)}
    for n, r in enumerate(b.block_inds):
        rows.setdefault(tuple(r), ('b', n))
    bb = t.backend.block_backend
    blocks, inds = [], []
    for r, (src, n) in rows.items():
        if src == 'a':
            blocks.append(a.blocks[n])
        else:
            blocks.append(bb.zeros(bb.get_shape(b.blocks[n]), a.dtype))
        inds.append(r)
    data = BlockSparseData(blocks, np.array(inds, np.intp).reshape(len(inds), -1), a.dtype)
    res = t.copy(deep=False)
    res.data = data
    return res


def _structure_key(t):
    return t.data.block_inds.tobytes()


def _close_structure(H, psi0, max_rounds: int = 4):
    """Grow psi0's block structure until it is a fixed point of H.matvec, so that
    every Krylov vector of the fused solver has the same blocks."""
    psi = psi0
    for _ in range(max_rounds):
        w = H.matvec(psi)
        if _structure_key(w) == _structure_key(psi):
            return psi
        psi = _union_embed(psi, w)
    raise ValueError('matvec block structure did not close; cannot fuse')


def lanczos_fused(H, psi0: Tensor, options: dict = None) -> tuple[float, Tensor, int]:
    """Fixed-length Lanczos ground-state search with no host sync in its loop.

    Grows ``psi0``'s block structure to a fixed point of ``H.matvec`` (one extra
    matvec per round), then runs :func:`fused_lanczos_impl` for ``options['N_max']``
    (default 20) iterations. Returns ``(E0, psi0, N)``.
    """
    N = int((options or {}).get('N_max', 20))
    psi0 = _close_structure(H, psi0)
    E, theta = fused_lanczos_impl(H, psi0, N)
    return float(E), theta, N  # the solve's one host sync


def _krylov_basis(H, psi0, N: int):
    """``N`` Lanczos iterations of ``H`` from ``psi0``, queued on the device with no host
    sync: ``(V, ab, nrm0, sw)``, the Krylov vectors as the rows of one ``[N, size]``
    buffer (the layout of :func:`_flatten`), the alphas (row 0) and betas (row 1) in
    one ``[2, N]`` buffer in the accumulator's real dtype, the 0-d norm of ``psi0``
    and the square roots of the block weights (None where every block weighs 1).

    The vector arithmetic of an iteration is a few launches whatever the number of
    blocks; only the matvec sees the block structure. On the fusion-tree backend the
    inner product weighs each block by the quantum dimension of its coupled sector
    (:func:`_sqrt_weights`): the Krylov vectors are kept scaled by the square roots of
    those weights, element by element, so that their plain products and norms are the
    weighted ones; a matvec unscales its input and scales its output. After Krylov
    closure (beta ~ 0) the next vector is zero, not w/tiny: amplified roundoff would
    otherwise leak into the reconstruction. Complex vectors take ``Re <v, w>`` as
    their alpha, as ``cyten_tpu``'s loop does.
    """
    if not psi0.data.blocks:
        raise ValueError('fused Lanczos of a tensor with no blocks')
    x = _flatten(psi0)
    acc = torch.float32 if x.dtype == torch.bfloat16 else x.dtype  # for reductions
    sw = _sqrt_weights(psi0, x.real.dtype, flat=True)
    if sw is not None:
        x = x * sw

    def dot(a, b, out):
        """Re <a, b> into the 0-d ``out``: a [1, n] by [n] product writes its result
        in place, where torch.vdot(out=...) would copy it (one more kernel)."""
        a, b = a.to(acc), b.to(acc)
        if a.is_complex():  # Re <a, b> is the real product of the (re, im) pairs
            a, b = torch.view_as_real(a).view(-1), torch.view_as_real(b).view(-1)
        torch.mv(a.view(1, -1), b, out=out.view(1))

    V = x.new_empty((N, x.numel()))
    nrm0 = torch.linalg.vector_norm(x, dtype=acc)
    torch.mul(x, 1. / nrm0, out=V[0])
    # the alphas (row 0) and betas (row 1), written where the Krylov kernels read them
    ab = x.new_empty((2, N), dtype=acc.to_real())
    for k in range(N):
        if sw is None:
            w = _flatten(H.matvec(_unflatten(psi0, V[k])))
        else:
            w = _flatten(H.matvec(_unflatten(psi0, V[k] / sw))).mul_(sw)
        alpha, beta = ab[0, k], ab[1, k]
        dot(V[k], w, alpha)
        w.addcmul_(V[k], alpha, value=-1)
        if k > 0:
            w.addcmul_(V[k - 1], ab[1, k - 1], value=-1)
        torch.linalg.vector_norm(w, dtype=acc, out=beta)
        if k + 1 < N:
            torch.mul(w, torch.where(beta > 1e-12, 1. / beta.clamp_min(1e-30), 0.),
                      out=V[k + 1])
    return V, ab, nrm0, sw


def fused_lanczos_impl(H, psi0, N: int):
    """``N`` Lanczos iterations and the Ritz vector, queued on the device with no host
    sync.

    The counterpart of ``cyten_tpu``'s ``fused_lanczos_impl``, a ``lax.scan`` there.
    Here it is a Python loop over one flat vector per Krylov vector (:func:`_krylov_basis`).
    The tridiagonal ground state is solved from the ``[2, N]`` buffer of alphas and
    betas where it lies
    (:func:`~cyten_tpu_torch.blocks.tridiag.tridiagonal_ground_state`) and the Ritz
    vector rebuilt from the basis with its coefficients. So the whole solve can be
    captured in a CUDA graph.

    ``psi0``'s block structure must be a fixed point of ``H.matvec`` (see
    :func:`_close_structure`). Returns ``(E, theta)``: E a 0-d f64 tensor on the
    device, theta normalised.
    """
    V, ab, _, sw = _krylov_basis(H, psi0, N)
    acc = ab.dtype if not V.is_complex() else V.dtype
    E, coeffs = tridiagonal_ground_state(ab)
    theta = coeffs.to(V.dtype) @ V
    theta = theta / torch.linalg.vector_norm(theta, dtype=acc).clamp_min(1e-30)
    if sw is not None:
        theta = theta / sw
    return E, _unflatten(psi0, theta)


def fused_lanczos_evolution_impl(H, psi0, delta, N: int):
    """``exp(delta * H) |psi0>`` with a fixed-N Krylov space, queued on the device with
    no host sync.

    The counterpart of ``cyten_tpu``'s ``fused_lanczos_evolution_impl``, the traced
    body of its fused TDVP site steps: the basis of :func:`_krylov_basis`, then the
    coefficients ``nrm0 exp(delta T) e_0`` from the ``[2, N]`` buffer where it lies
    (:func:`~cyten_tpu_torch.blocks.tridiag.tridiagonal_evolve`; the Krylov space's
    ``valid`` mask is applied there), and their combination of the basis. So a whole
    TDVP site step can be captured in a CUDA graph. ``delta`` is a number, real or
    complex. A real ``psi0`` under an imaginary ``delta`` (real-time evolution) is
    made complex before the loop, as in ``cyten_tpu``: combining complex coefficients
    under real metadata would drop the imaginary part.

    ``psi0``'s block structure must be a fixed point of ``H.matvec`` (see
    :func:`_close_structure`). Returns the evolved tensor, not normalised.
    """
    if complex(delta).imag != 0 and not psi0.dtype.is_complex:
        psi0 = psi0.to_dtype(psi0.dtype.to_complex)
    V, ab, nrm0, sw = _krylov_basis(H, psi0, N)
    coeffs = tridiagonal_evolve(ab, delta, nrm0)
    theta = coeffs.to(V.dtype) @ V
    if sw is not None:
        theta = theta / sw
    return _unflatten(psi0, theta)


def lanczos_arpack(H: LinearOperator, psi0: Tensor, options: dict = None):
    """Ground state via scipy ARPACK, flattening tensors to dense vectors (on the host,
    through :class:`~cyten_tpu_torch.tensors.sparse.NumpyArrayLinearOperator`).

    Slower than :func:`lanczos`; useful as a cross-check.
    """
    import scipy.sparse.linalg

    from .sparse import NumpyArrayLinearOperator

    wrapper = NumpyArrayLinearOperator(H, psi0)
    op = wrapper.as_scipy_operator()
    vals, vecs = scipy.sparse.linalg.eigsh(op, k=1, which='SA',
                                           v0=wrapper.tensor_to_flat(psi0))
    return float(vals[0]), wrapper.flat_to_tensor(vecs[:, 0]), -1
