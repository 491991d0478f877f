// Lowest eigenpair of the fused Lanczos's N x N tridiagonal matrix, on the card.
//
// It has no Pallas counterpart: it takes the place of jnp.linalg.eigh inside
// cyten_tpu's jitted fused Lanczos (cyten_tpu/tensors/krylov_based.py:386-397),
// which XLA runs on the device. torch.linalg.eigh cannot stand in for it on CUDA:
// it reads its LAPACK info on the host, a sync, and a sync is illegal while a CUDA
// graph is captured. So the Ritz problem of a static bond update is solved here, and
// the whole update can be one graph (cyten_tpu_torch/algorithms/dmrg.py).
//
// What it computes, exactly as the plain version (blocks/tridiag.py) does:
// - valid[0] = 1, valid[k] = valid[k-1] && beta[k-1] > 1e-12: a vanishing beta
//   means the Krylov space closed, and the later alphas are garbage;
// - the invalid diagonal entries are shifted above the valid spectrum by the
//   Gershgorin bound max|alpha_valid| + 2 max(beta) + 1, their couplings dropped;
// - the lowest eigenvalue E and its unit eigenvector, whose largest-magnitude
//   entry is made positive (the plain version does the same, so the two agree
//   entry by entry, not only up to sign).
// Output: out[0] = E, out[1..N] = the eigenvector, all f64. If the iteration does
// not converge (non-finite input), every output is NaN: the caller's energy check
// sees it, and nothing is read on the host.
//
// Algorithm: the implicit QL iteration with Wilkinson-type shifts on the
// tridiagonal matrix (tqli), accumulating the rotations into Z = I. One CTA of 64
// threads, everything in shared memory (N <= 64; static mode uses 10-20). Thread 0
// alone reads and writes d, e: it finds each QL step's split point and publishes it
// in shared memory, so every thread takes the same branches, then computes the
// step's chain of Givens rotations; thread k then applies the whole chain to row k
// of Z, so a step costs three barriers, not one per rotation.
//
// What bounds it: the function needs the eigenvalues (about 10 N^2 f64 operations
// by QL) and one eigenvector (O(N) by inverse iteration); it reads and writes under
// 1 KB. This kernel does more, O(N^3), to keep every thread's share simple, but at
// N = 10-20 neither count matters: the launch and the serial chain (one thread,
// dependent divisions and square roots) set its time. It is launched once per
// Lanczos solve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 64;
constexpr int MAX_ITER = 60;  // QL steps per eigenvalue before giving up

__global__ void __launch_bounds__(MAX_N)
tridiag_kernel(const double* __restrict__ ab, int n, double* __restrict__ out) {
  __shared__ double d[MAX_N], e[MAX_N], cs[MAX_N], sn[MAX_N];
  __shared__ double z[MAX_N][MAX_N + 1];
  __shared__ int m_s, ilo_s, failed_s;
  const int t = threadIdx.x;
  const double* alpha = ab;
  const double* beta = ab + n;

  if (t == 0) {
    failed_s = 0;
    double amax = 0.0, bmax = beta[0];
    bool valid = true;
    for (int k = 0; k < n; ++k) {
      if (k > 0) valid = valid && beta[k - 1] > 1e-12;
      if (valid) amax = fmax(amax, fabs(alpha[k]));
      bmax = fmax(bmax, beta[k]);
    }
    const double bound = amax + 2.0 * bmax + 1.0;
    valid = true;
    for (int k = 0; k < n; ++k) {
      if (k > 0) valid = valid && beta[k - 1] > 1e-12;
      d[k] = valid ? alpha[k] : bound;
      // e[k] couples k and k + 1; it is kept where k + 1 is valid
      e[k] = (k + 1 < n && valid && beta[k] > 1e-12) ? beta[k] : 0.0;
    }
  }
  if (t < n) {
    for (int j = 0; j < n; ++j) z[t][j] = (t == j) ? 1.0 : 0.0;
  }

  for (int l = 0; l < n; ++l) {
    for (int iter = 0;; ++iter) {
      __syncthreads();  // d, e of the last step are written; its rotations applied
      if (t == 0) {
        // thread 0 alone reads d, e here and publishes the split point: no thread
        // may scan them while thread 0 rewrites them below
        int m = l;
        for (; m < n - 1; ++m) {
          const double dd = fabs(d[m]) + fabs(d[m + 1]);
          if (fabs(e[m]) <= 2.220446049250313e-16 * dd) break;
        }
        if (m != l && (iter == MAX_ITER || failed_s)) {
          failed_s = 1;  // give up: every later eigenvalue counts as converged
          m = l;
        }
        m_s = m;
      }
      __syncthreads();
      const int m = m_s;
      if (m == l) break;  // d[l] has converged (or the iteration failed)
      if (t == 0) {
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = hypot(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + copysign(r, g));
        double s = 1.0, c = 1.0, p = 0.0;
        int i = m - 1;
        for (; i >= l; --i) {
          const double f = s * e[i];
          const double b = c * e[i];
          r = hypot(f, g);
          e[i + 1] = r;
          if (r == 0.0) {  // the matrix split: recover and start again
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          cs[i] = c;
          sn[i] = s;
        }
        ilo_s = i + 1;  // rotations i = m - 1 down to ilo_s were made
        if (!(r == 0.0 && i >= l)) {
          d[l] -= p;
          e[l] = g;
          e[m] = 0.0;
        }
      }
      __syncthreads();
      if (t < n) {
        for (int i = m - 1; i >= ilo_s; --i) {
          const double f = z[t][i + 1];
          z[t][i + 1] = sn[i] * z[t][i] + cs[i] * f;
          z[t][i] = cs[i] * z[t][i] - sn[i] * f;
        }
      }
    }
  }
  __syncthreads();

  if (t == 0) {
    if (failed_s) {
      for (int k = 0; k <= n; ++k) out[k] = nan("");
      return;
    }
    int j = 0;
    for (int k = 1; k < n; ++k)
      if (d[k] < d[j]) j = k;
    int big = 0;
    for (int k = 1; k < n; ++k)
      if (fabs(z[k][j]) > fabs(z[big][j])) big = k;
    const double sign = z[big][j] < 0.0 ? -1.0 : 1.0;
    out[0] = d[j];
    for (int k = 0; k < n; ++k) out[1 + k] = sign * z[k][j];
  }
}

}  // namespace

// The lowest eigenpair of the Lanczos matrix given by ab = [alpha_0..alpha_{n-1},
// beta_0..beta_{n-1}] (f64, on the card), written to out[0..n], on `stream` of CUDA
// device `device`. Returns the cudaError_t of the launch (0 on success).
extern "C" int cyten_tridiag_ground_state(const double* ab, int n, double* out, int device,
                                          void* stream) {
  if (n < 1 || n > MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  int err = static_cast<int>(cudaGetDevice(&current));
  if (err) return err;
  if (current != device && (err = static_cast<int>(cudaSetDevice(device)))) return err;
  tridiag_kernel<<<1, MAX_N, 0, static_cast<cudaStream_t>(stream)>>>(ab, n, out);
  err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}
