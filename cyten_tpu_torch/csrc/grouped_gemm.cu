// Grouped (ragged) GEMM for Hopper: C_o = sum_{p -> o} A_p @ B_p in one launch.
//
// Replaces the Pallas TPU kernel cyten_tpu/blocks/pallas_grouped.py::grouped_matmul
// (kernel body :123-136, pallas_call :151). That kernel padded every operand to
// 128 x 128 tiles and walked a sequential grid of (output tile, k tile) items,
// carrying an f32 accumulator in VMEM from one k item to the next. Here blocks
// run in parallel and in no order, so the k loop and the sum over the pairs that
// feed one output live inside the block: one CTA owns one 64 x 64 output tile,
// loops over its pairs and their k tiles, and writes the tile once. No padding
// copy is made; ragged edges are masked on load and store.
//
// What bounds it. On the DMRG path the pair lists of tdot/compose are a few
// dozen to a few hundred products with M, N, K of several hundred to a few
// thousand (chi = 1024..4096). At K ~ 1000 one product does ~2K/(3 * itemsize)
// operations per byte of operands -- far above the ~20 (f32) or ~10 (f64)
// operations per byte at which the card's FMA pipes, not its memory, become the
// limit. So the kernel is bound by operations. This first version runs on the
// FMA pipes only: a 64 x 64 tile per CTA, 16 x 16 threads with a 4 x 4 register
// patch each, operands staged through shared memory in k slices of 16. The
// tensor-core path (wgmma for bf16/TF32, DMMA for f64) with TMA loads is the
// next step.
//
// Types: f64 accumulates in f64, f32 in f32, bf16 is read and written as bf16
// and accumulates in f32.
//
// Tables (int64, on the device, built by cyten_tpu_torch/blocks/grouped_gemm.py):
//   work  [n_work, 8]  = c_ptr, M, N, row0, col0, pair_begin, pair_end, 0
//   pairs [n_pairs, 4] = a_ptr, b_ptr, K, 0
// A_p is row-major [M, K], B_p row-major [K, N], C_o row-major [M, N], all
// contiguous; every pair in [pair_begin, pair_end) has the M and N of its work row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TY = 16;                 // thread rows; each thread owns rows ty + TY * i
constexpr int TX = 16;                 // thread cols; each thread owns cols tx + TX * j
constexpr int THREADS = TY * TX;
constexpr int RM = BM / TY;            // 4 rows per thread
constexpr int RN = BN / TX;            // 4 cols per thread
constexpr int WORK_COLS = 8;
constexpr int PAIR_COLS = 4;

template <typename T> struct AccOf { using type = T; };
template <> struct AccOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const int64_t* __restrict__ work, const int64_t* __restrict__ pairs) {
  using Acc = typename AccOf<T>::type;
  // A is stored k-major so the compute loop reads a column of A as a broadcast;
  // the +1 pad spreads the transposing stores over the banks.
  __shared__ Acc sA[BK][BM + 1];
  __shared__ Acc sB[BK][BN];

  const int64_t* w = work + WORK_COLS * static_cast<int64_t>(blockIdx.x);
  T* C = reinterpret_cast<T*>(w[0]);
  const int64_t M = w[1], N = w[2], row0 = w[3], col0 = w[4];
  const int64_t p_begin = w[5], p_end = w[6];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  Acc acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = Acc(0);

  for (int64_t p = p_begin; p < p_end; ++p) {
    const T* A = reinterpret_cast<const T*>(pairs[PAIR_COLS * p]);
    const T* B = reinterpret_cast<const T*>(pairs[PAIR_COLS * p + 1]);
    const int64_t K = pairs[PAIR_COLS * p + 2];
    for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < BM * BK / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / BK, k = e % BK;   // neighbouring threads walk along k
        const int64_t gr = row0 + r, gk = k0 + k;
        sA[k][r] = (gr < M && gk < K) ? to_acc(A[gr * K + gk]) : Acc(0);
      }
#pragma unroll
      for (int i = 0; i < BK * BN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int k = e / BN, c = e % BN;   // neighbouring threads walk along n
        const int64_t gk = k0 + k, gc = col0 + c;
        sB[k][c] = (gk < K && gc < N) ? to_acc(B[gk * N + gc]) : Acc(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        Acc a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = sA[kk][ty + TY * i];
#pragma unroll
        for (int j = 0; j < RN; ++j) b[j] = sB[kk][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] += a[i] * b[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = row0 + ty + TY * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int64_t c = col0 + tx + TX * j;
      if (c < N) store(C + r * N + c, acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float64, 1 = float32, 2 = bfloat16. Returns the cudaError_t of the
// launch (0 on success); the caller raises on anything else.
extern "C" int cyten_grouped_gemm(int dtype, const int64_t* work, const int64_t* pairs,
                                  int64_t n_work, void* stream) {
  if (n_work <= 0) return 0;
  if (n_work > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_work));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: grouped_gemm_kernel<double><<<grid, THREADS, 0, s>>>(work, pairs); break;
    case 1: grouped_gemm_kernel<float><<<grid, THREADS, 0, s>>>(work, pairs); break;
    case 2: grouped_gemm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(work, pairs); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
