// Toolchain probe for Hopper: o = 2 * x over a contiguous f32 array.
//
// Replaces the anonymous Pallas kernel k of scripts/exp_r5_step_decomp.py:55-60
// (pallas_call :59). That kernel doubled a [256, 256] f32 array in one VMEM block
// to show that a hand-written kernel lowers and runs on the device before the step
// decomposition is measured. Here it shows the same for the toolchain that every
// kernel of this package goes through: nvcc for sm_90a, a plain C interface,
// ctypes (cyten_tpu_torch/blocks/_kernels.py).
//
// What bounds it: one read and one write of 4 bytes per element and one multiply,
// so the card's memory rate. One thread per element, neighbouring threads on
// neighbouring addresses, so each warp's loads and stores coalesce into 128-byte
// transactions. At the probe's 256 x 256 shape (512 KiB moved) the launch costs
// more than the bytes; the kernel is a gate, not a hot path.
//
// x * 2.0f is exact in f32 (a change of exponent), so the kernel equals its plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
scale2_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); the caller raises on
// anything else.
extern "C" int cyten_scale2(const float* x, float* o, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  scale2_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return static_cast<int>(cudaGetLastError());
}
