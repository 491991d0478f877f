// The Krylov problems of the fused Lanczos solvers, on the card: the lowest eigenpair
// of the N x N tridiagonal matrix (cyten_tridiag_ground_state), and the coefficients
// of exp(delta T) e_0 (cyten_tridiag_evolve, at the end of this file).
//
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
// - the invalid diagonal entries are shifted to the Gershgorin bound
//   max|alpha_valid| + 2 max(beta) + 1, their couplings dropped;
// - the lowest eigenvalue E and its unit eigenvector, whose largest-magnitude
//   entry (the first on a tie, as argmax picks) is made positive.
// The betas are norms, so the bound lies above the valid block's spectrum, and the
// invalid block is diagonal: the answer is the lowest eigenpair of the valid leading
// block, with exact zeros after it. The kernel works on that block alone.
// Input: ab = [alpha_0..alpha_{n-1}, beta_0..beta_{n-1}] where the fused Lanczos
// wrote them, f64 or f32 (read as such, computed in f64). Output: out[0] = E,
// out[1..n] = the eigenvector, f64. A non-finite entry that reaches the matrix makes
// every output NaN: the caller's energy check sees it, and nothing is read on the
// host.
//
// Design: one warp, in registers, shared memory and warp shuffles; no __syncthreads.
// 1. Set-up: lane j holds entries j and j + 32. The first closing beta comes from a
//    ballot; Gershgorin's bracket [lo, hi] of the lowest eigenvalue, the pivot floor
//    and the finiteness check from warp reductions. d and e^2 go to shared memory
//    once; later reads are broadcasts.
// 2. E by Sturm-count multisection: each round, lane j runs CHAINS independent LDL^T
//    pivot recurrences q_k = (d_k - s) - e_{k-1}^2 / q_{k-1} (pivots below pivmin
//    in magnitude taken as -pivmin, as LAPACK's dlaebz does) at 64 points spread
//    over [lo, hi]; a ballot of "some pivot <= 0" (an eigenvalue at or below s)
//    gives the next bracket, 65 times narrower. Sturm counts are backward stable,
//    so E lies within a few N eps |T| of the true eigenvalue; the loop stops at a
//    width of 2 eps |E| (or eps |T|): about 9 rounds from Gershgorin's bracket,
//    fewer where it is tight, as beta_0 makes it for a converged state.
// 3. The vector by a twisted factorisation at lambda = lo, where the count is 0
//    (Dhillon-Parlett; LAPACK's dlar1v): lane 0 runs the forward LDL^T while lane 1
//    runs the backward UDU^T, in one loop; the twist index r = argmin |gamma_r| comes
//    from a warp reduction, and z_r = 1 is extended outwards by the two factors,
//    again on two lanes at once. Scaled by its largest entry (which fixes the sign),
//    normalised by a warp sum.
//
// What bounds it: the function reads 2N and writes N + 1 numbers, under 1 KB, and
// does some ten f64 operations per pivot step; at N = 10-20 neither count matters.
// Its time is the launch and the dependent chain of the pivot recurrence (about 9
// rounds of N steps, then N steps for the factors), which the design keeps short:
// one round serves 64 points; the reciprocal is inline (a division is a call, which
// would serialise a lane's recurrences); and the vector costs two chains, not N
// rotations per eigenvalue. Of one to four recurrences a lane, two were fastest:
// more points a round cost more per round than the rounds they save. It is launched
// once per Lanczos solve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 64;     // two entries per lane of one warp
constexpr int WARP = 32;
constexpr int CHAINS = 2;     // pivot recurrences per lane and round
constexpr int POINTS = WARP * CHAINS;
constexpr int MAX_ROUNDS = 20;  // the stopping width is reached in about 9
constexpr unsigned FULL = 0xffffffffu;
constexpr double CLOSED = 1e-12;  // a beta at or below this closes the Krylov space
constexpr double EPS = 2.220446049250313e-16;
constexpr double SAFMIN = 2.2250738585072014e-308;  // smallest normal double

// x[i] = the warp's largest x[i], for all i at once: the shuffles of the K
// reductions interleave
template <int K>
__device__ __forceinline__ void warp_max(double (&x)[K]) {
  for (int o = WARP / 2; o; o >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) x[i] = fmax(x[i], __shfl_xor_sync(FULL, x[i], o));
  }
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = WARP / 2; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// (value, index) of the warp's smallest value (largest if `largest`), the smallest
// index on a tie
__device__ __forceinline__ void warp_arg(double& v, int& i, bool largest) {
  for (int o = WARP / 2; o; o >>= 1) {
    const double v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    const bool take = (largest ? v2 > v : v2 < v) || (v2 == v && i2 < i);
    v = take ? v2 : v;
    i = take ? i2 : i;
  }
}

// 1/x to an ulp: the special-function unit's approximation of the high word (about
// 2^-20), refined by one cubic step. Inline, unlike a division (a call to a
// subroutine), so the independent recurrences of a lane interleave.
__device__ __forceinline__ double rcp(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double e = fma(-x, r, 1.0);
  return fma(r, fma(e, e, e), r);
}

// One step of the LDL^T pivot recurrence of T - s I: the pivot (d - s) - e2 / q, given
// t = 1 / q, where a pivot below pivmin in magnitude counts as -pivmin (LAPACK's
// guard against a zero pivot)
__device__ __forceinline__ double pivot(double d, double s, double e2, double t,
                                        double pivmin) {
  const double p = fma(-e2, t, d - s);
  return fabs(p) < pivmin ? -pivmin : p;
}

// The i-th multisection point of a round: the same expression wherever it is used,
// so a bracket end is bitwise the point that was tested
__device__ __forceinline__ double point(double lo, double h, int i) {
  return fma(static_cast<double>(i), h, lo);
}

template <typename T>
__global__ void __launch_bounds__(WARP)
tridiag_kernel(const T* __restrict__ ab, int n, double* __restrict__ out) {
  __shared__ double sd[MAX_N];       // diagonal of the valid block
  __shared__ double se[MAX_N];       // se[k] couples k and k + 1; 0 from m - 1 on
  __shared__ double se2[MAX_N + 1];  // se2[k] = se[k - 1]^2, se2[0] = 0
  __shared__ double piv[2][MAX_N], mul[2][MAX_N];  // step 3's factors, forward, backward
  __shared__ double sz[MAX_N];
  const int lane = threadIdx.x;

  // --- 1. set-up ------------------------------------------------------------------
  double a[2], b[2];
  bool in[2], closes[2];
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    in[j] = k < n;
    a[j] = in[j] ? static_cast<double>(ab[k]) : 0.0;
    b[j] = in[j] ? static_cast<double>(ab[n + k]) : 0.0;
    closes[j] = k < n - 1 && !(b[j] > CLOSED);
  }
  // the valid block is 0..m-1: m = 1 + the first k < n - 1 whose beta closes, else n
  const unsigned c0 = __ballot_sync(FULL, closes[0]), c1 = __ballot_sync(FULL, closes[1]);
  const int m = c0 ? __ffs(c0) : c1 ? WARP + __ffs(c1) : n;

  // e_k couples k and k + 1 inside the valid block; lane j - 1 holds e_{k-1}
  double e[2];
  for (int j = 0; j < 2; ++j) e[j] = lane + WARP * j < m - 1 ? b[j] : 0.0;
  const double up0 = __shfl_up_sync(FULL, e[0], 1), up1 = __shfl_up_sync(FULL, e[1], 1);
  const double e31 = __shfl_sync(FULL, e[0], WARP - 1);
  const double e_prev[2] = {lane ? up0 : 0.0, lane ? up1 : e31};
  // max |alpha_valid|, max beta, -min d, max e^2, and Gershgorin's interval
  // [-red[4], red[5]] of the valid block, reduced together
  double red[6] = {0.0, -INFINITY, -INFINITY, 0.0, -INFINITY, -INFINITY};
  bool bad = false;
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    const bool valid = k < m;
    bad |= (valid && !isfinite(a[j])) || (k < m - 1 && !isfinite(b[j]))
           || (m < n && in[j] && !isfinite(b[j]));
    if (valid) {
      const double radius = fabs(e[j]) + fabs(e_prev[j]);
      red[0] = fmax(red[0], fabs(a[j]));
      red[2] = fmax(red[2], -a[j]);
      red[4] = fmax(red[4], radius - a[j]);
      red[5] = fmax(red[5], a[j] + radius);
      sd[k] = a[j];
    }
    if (in[j]) red[1] = fmax(red[1], b[j]);
    red[3] = fmax(red[3], e[j] * e[j]);
    se[k] = e[j];
    se2[k + 1] = e[j] * e[j];
  }
  if (lane == 0) se2[0] = 0.0;
  warp_max(red);
  const double dmin = -red[2], e2max = red[3], gl = -red[4], gu = red[5];
  // the shifted entries enter the matrix only when the space closed
  if (__any_sync(FULL, bad) || (m < n && !isfinite(red[0] + 2.0 * red[1] + 1.0))) {
    for (int k = lane; k <= n; k += WARP) out[k] = nan("");
    return;
  }
  __syncwarp();
  const double tnorm = fmax(fabs(gl), fabs(gu));
  const double pivmin = SAFMIN * fmax(1.0, e2max);
  const double atol = fmax(EPS * tnorm, pivmin);

  // --- 2. E by Sturm-count multisection -------------------------------------------
  // count(lo) = 0: below Gershgorin's bound, widened as LAPACK's dstebz does;
  // count(hi) >= 1: no eigenvalue of T lies above its smallest diagonal entry's
  double lo = gl - 2.1 * (EPS * tnorm * m + 2.0 * pivmin), hi = dmin;
  for (int round = 0; round < MAX_ROUNDS; ++round) {
    if (hi - lo <= fmax(2.0 * EPS * fmax(fabs(lo), fabs(hi)), atol)) break;
    const double h = (hi - lo) * (1.0 / (POINTS + 1));
    double s[CHAINS], t[CHAINS];
    bool below[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      s[c] = point(lo, h, WARP * c + lane + 1);
      t[c] = 1.0;
      below[c] = false;
    }
    for (int k = 0; k < m; ++k) {
      const double d = sd[k], e2 = se2[k];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        const double q = pivot(d, s[c], e2, t[c], pivmin);
        below[c] |= __double2hiint(q) < 0;  // q <= 0: the guard leaves no zero
        t[c] = rcp(q);
      }
    }
    // the first point with an eigenvalue at or below it closes the new bracket
    int p = POINTS;
#pragma unroll
    for (int c = CHAINS - 1; c >= 0; --c) {
      const unsigned mask = __ballot_sync(FULL, below[c]);
      if (mask) p = WARP * c + __ffs(mask) - 1;
    }
    const double new_lo = p > 0 ? point(lo, h, p) : lo;
    hi = p < POINTS ? point(lo, h, p + 1) : hi;
    lo = new_lo;
  }
  const double E = 0.5 * (lo + hi);

  // --- 3. the vector by a twisted factorisation at lambda = lo ----------------------
  // Lane 0 factors T - lam I = L D L^T from the top, lane 1 = U R U^T from the bottom,
  // in one loop (branches of a warp would run one after the other): piv[0][k] = D_k,
  // mul[0][k] = L_k = e_k / D_k; piv[1][k] = R_k, mul[1][k - 1] = U_{k-1} = e_{k-1} / R_k
  const double lam = lo;
  if (lane < 2) {
    double t = 1.0;
    for (int i = 0; i < m; ++i) {
      const int k = lane ? m - 1 - i : i, kc = lane ? k - 1 : k;  // kc: the coupling
      const double q = pivot(sd[k], lam, se2[lane ? k + 1 : k], t, pivmin);
      t = rcp(q);
      piv[lane][k] = q;
      if (kc >= 0) mul[lane][kc] = se[kc] * t;
    }
  }
  __syncwarp();
  // gamma_k = D_k + R_k - (d_k - lam): the twist with the smallest is the eigenvector's
  // largest entry, near enough
  double g = INFINITY;
  int r = lane < m ? lane : MAX_N;
  for (int k = lane; k < m; k += WARP) {
    const double gk = fabs(piv[0][k] + piv[1][k] - (sd[k] - lam));
    if (gk < g) {
      g = gk;
      r = k;
    }
  }
  warp_arg(g, r, false);
  // z_r = 1, extended upwards by lane 0 (z_k = -L_k z_{k+1}) and downwards by lane 1
  // (z_k = -U_{k-1} z_{k-1}), again in one loop
  if (lane == 0) sz[r] = 1.0;
  if (lane < 2) {
    double z = 1.0;
    for (int i = 1, steps = lane ? m - 1 - r : r; i <= steps; ++i) {
      const int k = lane ? r + i : r - i;
      sz[k] = z = -mul[lane][lane ? k - 1 : k] * z;
    }
  }
  __syncwarp();
  double z[2];
  double zmax = -1.0;
  int big = lane < m ? lane : MAX_N;
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    z[j] = k < m ? sz[k] : 0.0;
    if (k < m && fabs(z[j]) > zmax) {
      zmax = fabs(z[j]);
      big = k;
    }
  }
  warp_arg(zmax, big, true);
  const double scale = rcp(sz[big]);  // the largest entry becomes +1
  double ss = 0.0;
  for (int j = 0; j < 2; ++j) {
    z[j] *= scale;
    ss += z[j] * z[j];
  }
  const double inv_norm = rsqrt(warp_sum(ss));
  if (lane == 0) out[0] = E;
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    if (k < n) out[1 + k] = z[j] * inv_norm;
  }
}

}  // namespace

// The lowest eigenpair of the Lanczos matrix given by ab = [alpha_0..alpha_{n-1},
// beta_0..beta_{n-1}] (on the card; f64 for dtype 0, f32 for dtype 1), written to
// out[0..n] in f64, on `stream` of CUDA device `device`. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int cyten_tridiag_ground_state(const void* ab, int dtype, int n, double* out,
                                          int device, void* stream) {
  if (n < 1 || n > MAX_N || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  int err = static_cast<int>(cudaGetDevice(&current));
  if (err) return err;
  if (current != device && (err = static_cast<int>(cudaSetDevice(device)))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    tridiag_kernel<double><<<1, WARP, 0, s>>>(static_cast<const double*>(ab), n, out);
  else
    tridiag_kernel<float><<<1, WARP, 0, s>>>(static_cast<const float*>(ab), n, out);
  err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

// --- tridiagonal_evolve ---------------------------------------------------------------
//
// The coefficients of exp(delta T) e_0 in the Krylov basis of the fused Lanczos
// evolution, times the start vector's norm: c = nrm0 V (exp(delta lambda) * V[0, :]^*)
// with T = V diag(lambda) V^T. It has no Pallas counterpart either: it takes the place
// of jnp.linalg.eigh and the phase product of cyten_tpu's fused_lanczos_evolution_impl
// (cyten_tpu/tensors/krylov_based.py:458-460), which XLA runs on the device inside the
// jitted TDVP site steps. torch.linalg.eigh on CUDA reads its LAPACK info on the host,
// which a CUDA graph cannot hold, so a fused QR-TDVP site step ends its two
// evolutions here and is captured whole (cyten_tpu_torch/algorithms/tdvp.py).
//
// What it computes, as the plain version (blocks/tridiag.py) does: the valid block as
// for the ground state (a beta at or below 1e-12 closes the Krylov space). The
// reference masks T (the invalid diagonal entries shifted to a Gershgorin bound,
// their couplings dropped), so the invalid block is diagonal and decoupled, and
// V[0, k] = 0 on it: its coefficients are exact zeros. The kernel takes the valid
// block alone. delta = dr + i di; the output is complex (interleaved re, im) when the
// caller asks for it (di != 0), else real. A non-finite entry that reaches the masked
// matrix, a non-finite norm, or a QL iteration that does not converge makes every
// output NaN.
//
// Design: one warp, as the ground-state kernel; the simple and sure method, since the
// whole spectrum is needed: EISPACK's tql2 (implicit-shift QL with eigenvectors, as
// JAMA writes it) on the valid block in f64 shared memory. Lane 0 runs the scalar
// recurrence of one QL sweep and records its Givens rotations; then every lane applies
// them to its rows of V (rows lane and lane + 32), the eigenvector accumulation that
// is the O(N^3) part; a __syncwarp separates the two. Then lane j forms
// w_j = exp(delta lambda_j) V[0, j] and lane k the sums c_k = nrm0 sum_j V[k, j] w_j.
//
// What bounds it: it reads 2N + 1 numbers and writes N (or 2N), under 1.5 KB, and
// does about 6 N^3 operations (two QL sweeps an eigenvalue, each rotation 6 operations
// a row) and 8 N^2 for the product: at N = 10-30 neither count matters. Its time is the
// launch and the serial chain of lane 0's sweeps (square roots and divisions), about
// 2N sweeps of up to N steps. Making it fast (the rotations' recurrence split across
// lanes, a divide-and-conquer or a Sturm-count method as the ground-state kernel's) is
// later work; it is launched twice a site step, against some 2N matvecs.

namespace {

constexpr int QL_MAX_ITER = 60;  // QL sweeps per eigenvalue before giving up (tql2: 30)

template <typename T>
__global__ void __launch_bounds__(WARP)
tridiag_evolve_kernel(const T* __restrict__ ab, const T* __restrict__ nrm, int n,
                      double dr, double di, int complex_out, double* __restrict__ out) {
  __shared__ double V[MAX_N][MAX_N + 1];  // eigenvectors of the valid block, by column
  __shared__ double d[MAX_N], e[MAX_N];   // tql2's diagonal and couplings
  __shared__ double rc[MAX_N], rs[MAX_N];  // the rotations of one QL sweep
  __shared__ double wr[MAX_N], wi[MAX_N];
  __shared__ int s_hi, s_fail;
  const int lane = threadIdx.x;

  // --- set-up: the valid block 0..m-1, and the checks of the ground-state kernel -------
  double a[2], b[2];
  bool in[2], closes[2];
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    in[j] = k < n;
    a[j] = in[j] ? static_cast<double>(ab[k]) : 0.0;
    b[j] = in[j] ? static_cast<double>(ab[n + k]) : 0.0;
    closes[j] = k < n - 1 && !(b[j] > CLOSED);
  }
  const unsigned c0 = __ballot_sync(FULL, closes[0]), c1 = __ballot_sync(FULL, closes[1]);
  const int m = c0 ? __ffs(c0) : c1 ? WARP + __ffs(c1) : n;
  double red[2] = {0.0, -INFINITY};  // max |alpha_valid|, max beta
  bool bad = false;
  for (int j = 0; j < 2; ++j) {
    const int k = lane + WARP * j;
    bad |= (k < m && !isfinite(a[j])) || (k < m - 1 && !isfinite(b[j]))
           || (m < n && in[j] && !isfinite(b[j]));
    if (k < m) {
      red[0] = fmax(red[0], fabs(a[j]));
      d[k] = a[j];
      e[k] = k < m - 1 ? b[j] : 0.0;
    }
    if (in[j]) red[1] = fmax(red[1], b[j]);
    for (int col = 0; col < m; ++col)
      if (k < m) V[k][col] = col == k ? 1.0 : 0.0;
  }
  warp_max(red);
  const double scale = static_cast<double>(*nrm);
  bad |= !isfinite(scale) || (m < n && !isfinite(red[0] + 2.0 * red[1] + 1.0));
  if (__any_sync(FULL, bad)) {
    for (int k = lane; k < (complex_out ? 2 * n : n); k += WARP) out[k] = nan("");
    return;
  }
  if (lane == 0) s_fail = 0;
  __syncwarp();

  // --- tql2 on the valid block ------------------------------------------------------------
  double f = 0.0, tst1 = 0.0;  // lane 0's: the accumulated shift, the size of T so far
  int split = 0;
  for (int l = 0; l < m; ++l) {
    if (lane == 0) {
      tst1 = fmax(tst1, fabs(d[l]) + fabs(e[l]));
      split = l;  // the first coupling below eps |T| from l on (e[m-1] = 0)
      while (split < m - 1 && fabs(e[split]) > EPS * tst1) ++split;
    }
    for (int iter = 0;; ++iter) {
      if (lane == 0) {
        int hi = -1;
        if (split > l && (iter == 0 || fabs(e[l]) > EPS * tst1)) {
          if (iter == QL_MAX_ITER) {
            s_fail = 1;
          } else {
            // the implicit shift
            double g = d[l];
            double p = (d[l + 1] - g) / (2.0 * e[l]);
            double r = hypot(p, 1.0);
            if (p < 0) r = -r;
            d[l] = e[l] / (p + r);
            d[l + 1] = e[l] * (p + r);
            const double dl1 = d[l + 1];
            double h = g - d[l];
            for (int i = l + 2; i < m; ++i) d[i] -= h;
            f += h;
            // one implicit QL sweep, its rotations recorded
            p = d[split];
            double c = 1.0, c2 = 1.0, c3 = 1.0, s = 0.0, s2 = 0.0;
            const double el1 = e[l + 1];
            for (int i = split - 1; i >= l; --i) {
              c3 = c2;
              c2 = c;
              s2 = s;
              g = c * e[i];
              h = c * p;
              r = hypot(p, e[i]);
              e[i + 1] = s * r;
              s = e[i] / r;
              c = p / r;
              p = c * d[i] - s * g;
              d[i + 1] = h + s * (c * g + s * d[i]);
              rc[i] = c;
              rs[i] = s;
            }
            p = -s * s2 * c3 * el1 * e[l] / dl1;
            e[l] = s * p;
            d[l] = c * p;
            hi = split - 1;
          }
        }
        s_hi = hi;
      }
      __syncwarp();
      const int hi = s_hi;
      if (hi < 0) break;
      // the sweep's rotations on this lane's rows of V, in the order they were made
      for (int j = 0; j < 2; ++j) {
        const int k = lane + WARP * j;
        if (k >= m) continue;
        for (int i = hi; i >= l; --i) {
          const double c = rc[i], s = rs[i], h = V[k][i + 1];
          V[k][i + 1] = s * V[k][i] + c * h;
          V[k][i] = c * V[k][i] - s * h;
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      d[l] += f;
      e[l] = 0.0;
    }
    __syncwarp();
  }
  if (s_fail) {
    for (int k = lane; k < (complex_out ? 2 * n : n); k += WARP) out[k] = nan("");
    return;
  }

  // --- the coefficients ---------------------------------------------------------------
  for (int j = lane; j < m; j += WARP) {
    const double amp = exp(dr * d[j]) * V[0][j];
    double sn = 0.0, cs = 1.0;
    if (complex_out) sincos(di * d[j], &sn, &cs);
    wr[j] = amp * cs;
    wi[j] = amp * sn;
  }
  __syncwarp();
  for (int k = lane; k < n; k += WARP) {
    double cr = 0.0, ci = 0.0;
    if (k < m) {
      for (int j = 0; j < m; ++j) {
        cr = fma(V[k][j], wr[j], cr);
        ci = fma(V[k][j], wi[j], ci);
      }
    }
    if (complex_out) {
      out[2 * k] = scale * cr;
      out[2 * k + 1] = scale * ci;
    } else {
      out[k] = scale * cr;
    }
  }
}

}  // namespace

// The coefficients nrm0 exp((dr + i di) T) e_0 of the Lanczos matrix given by
// ab = [alpha_0..alpha_{n-1}, beta_0..beta_{n-1}] and the 0-d norm nrm (both on the
// card, f64 for dtype 0, f32 for dtype 1), written to out in f64: n complex numbers
// (re, im) if complex_out, else n reals; on `stream` of CUDA device `device`. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int cyten_tridiag_evolve(const void* ab, const void* nrm, int dtype, int n,
                                    double dr, double di, int complex_out, double* out,
                                    int device, void* stream) {
  if (n < 1 || n > MAX_N || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int current = 0;
  int err = static_cast<int>(cudaGetDevice(&current));
  if (err) return err;
  if (current != device && (err = static_cast<int>(cudaSetDevice(device)))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    tridiag_evolve_kernel<double><<<1, WARP, 0, s>>>(
        static_cast<const double*>(ab), static_cast<const double*>(nrm), n, dr, di,
        complex_out, out);
  else
    tridiag_evolve_kernel<float><<<1, WARP, 0, s>>>(
        static_cast<const float*>(ab), static_cast<const float*>(nrm), n, dr, di,
        complex_out, out);
  err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}
