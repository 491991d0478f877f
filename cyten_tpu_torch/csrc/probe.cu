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
// so the card's memory rate. Each thread moves one float4 (16 bytes, the widest
// load a thread issues) where both arrays are 16-byte aligned, and the last
// n % 4 elements, or all of them where an array is not aligned, one by one. At the
// probe's 256 x 256 shape (512 KiB moved, 0.16 us at 3.35 TB/s) the launch and the
// host's call cost far more than the bytes: its time measures the launch path that
// the grouped GEMM shares (blocks/_kernels.py::call), which is why that path
// resolves its ctypes function once, keeps the interpreter lock through the call
// (ctypes.PyDLL) and leaves the device check to this entry point.
// TMA would not help a kernel this small.
//
// x * 2.0f is exact in f32 (a change of exponent), so the kernel equals its plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// items [0, n4) are float4s, items [n4, n4 + tail) the single floats after them
__global__ void __launch_bounds__(THREADS)
scale2_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n4, int64_t tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n4) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    reinterpret_cast<float4*>(o)[i] = v;
  } else if (i < n4 + tail) {
    const int64_t j = 4 * n4 + (i - n4);
    o[j] = x[j] * 2.0f;
  }
}

// Launches with CUDA device `device` current and gives the caller's thread its device
// back: where it is current already that costs one cudaGetDevice.
int launch(int device, unsigned blocks, cudaStream_t stream, const float* x, float* o,
           int64_t n4, int64_t tail) {
  int current = 0;
  int err = static_cast<int>(cudaGetDevice(&current));
  if (err) return err;
  if (current != device && (err = static_cast<int>(cudaSetDevice(device)))) return err;
  scale2_kernel<<<blocks, THREADS, 0, stream>>>(x, o, n4, tail);
  err = static_cast<int>(cudaGetLastError());
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // namespace

// o = 2 * x over n floats, on `stream` of CUDA device `device`. Returns the
// cudaError_t of the launch (0 on success); the caller raises on anything else.
extern "C" int cyten_scale2(const float* x, float* o, int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  const int64_t tail = n - 4 * n4;
  const int64_t blocks = (n4 + tail + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch(device, static_cast<unsigned>(blocks), static_cast<cudaStream_t>(stream), x,
                o, n4, tail);
}
