// Grouped (ragged) GEMM for Hopper: C_o = sum_{p -> o} A_p @ B_p in one launch.
//
// Replaces the Pallas TPU kernel cyten_tpu/blocks/pallas_grouped.py::grouped_matmul
// (kernel body :123-136, pallas_call :151). That kernel padded every operand to
// 128 x 128 tiles and walked a sequential grid of (output tile, k tile) items,
// carrying an f32 accumulator in VMEM from one k item to the next. Here the k loop
// and the sum over the pairs that feed one output live inside a CTA: a CTA owns one
// output tile at a time, streams the k slices of all its pairs through shared
// memory, and writes the tile once. No padding copy is made; ragged edges are
// zero-filled on load and masked on store.
//
// What bounds it. On the DMRG path a list holds tens to hundreds of products with
// M, N, K of a few to a few thousand (chi = 1024..4096). At K ~ 1000 a product does
// hundreds of operations per byte of its operands, so the card's arithmetic is the
// limit, and which pipe does the arithmetic decides the rate:
//   f64   DMMA, the f64 tensor cores: mma.sync.m16n8k4.f64 (67 TFLOP/s; wgmma has
//         no f64 form). 128 x 64 tile, 4 warps of 64 x 32, f64 accumulators.
//   bf16  wgmma.m64n128k16 from shared memory, f32 accumulators, one rounding to
//         bf16 at the store. 128 x 128 tile, two warpgroups. A is read K-major, B
//         (row-major [K, N]) MN-major through the transpose flag, both from the
//         128-byte swizzled layout.
//   f32   exact, on the FMA pipes (67 TFLOP/s), for config.matmul_precision
//         'float32'. 128 x 128 tile, 256 threads with an 8 x 8 register patch and
//         float4 shared-memory reads.
// Three more kinds write f32 from f32 operands, either of which may be bf16 (a bf16
// environment against an f32 state): the operand is read from device memory in its
// own type, so a bf16 block is read once at half width and never copied. They round
// as config.matmul_precision says (the Hopper forms of the TPU's f32 passes that
// cyten_tpu/algorithms/dmrg.py::_with_precision describes):
//   f32w  'float32' with a bf16 operand: the f32 operand split exactly into three bf16
//         pieces (hi, mid, lo), three passes of wgmma.m64n128k16 bf16 (the TPU's own
//         'float32' arithmetic; three of the six passes it runs for f32 x f32, as a
//         bf16 operand is one piece), each k slice's from zero and then added into a
//         register sum, rounded to nearest. See F32WPass.
//   tf32  'tensorfloat32': each value rounded to TF32 (nearest, ties away from zero,
//         as cvt.rna.tf32.f32 and round_tf32 round), wgmma.m64nNk8.tf32 with f32
//         accumulators (495 TFLOP/s).
//   bf16p 'default': each value rounded to bf16 (nearest even), then
//         wgmma.m64nNk16 bf16, one pass, f32 written.
//   tf32 and bf16p on 128 x 256 tiles (N = 256), or 128 x 128 (N = 128) for the lists
//   whose outputs are narrow or too few to fill the card: the host picks the width of
//   each list from its shapes (see cyten_grouped_gemm_info). f32w on 128 x 128 only:
//   its register sum doubles the accumulators.
// Every product of rounded values (or of bf16 pieces) is exact in f32, so each kind
// differs from its plain version (grouped_matmul_plain(precision=)) only by the order
// of the sum.
//
// The three are warp-specialised (grouped_gemm_staged). cp.async cannot
// convert, and wgmma .tf32 would truncate raw f32 bits (dropping the low 13 bits,
// up to one TF32 unit from round_tf32, far past the K 2^-23 |A||B| bound), so the
// conversion is a pass of its own between two rings in shared memory:
//   - a producer warpgroup copies each k slice raw, in the operand's own dtype, by
//     16-byte cp.async from the 16-byte-aligned span that holds each row (one
//     chunk wider; the row's first element sits at byte address & 15 of its span,
//     so odd bf16 pitches and unaligned f32 rows need no narrow copies), a warp
//     instruction asking for whole rows, into a ring of raw stages; a stage's full
//     mbarrier gets one arrival a producer warp once cp.async.wait_group shows the
//     warp's copies landed, RAW_STAGES - 2 steps after they started;
//   - two consumer warpgroups read a raw stage into registers (and release it on
//     its empty mbarrier), widen and round (or split) each value as the plain
//     version does, write it into the 128-byte-swizzled layout the wgmma
//     descriptors read (tf32: A and B K-major, B transposed by the pass, since wgmma
//     takes no transpose flag for 32-bit types; bf16p and f32w's pieces: A K-major,
//     B MN-major; f32w's bf16 A into registers, wgmma's RS form), fence the async proxy
//     and start the products. Two rounded buffers alternate: the reads and the
//     rounding of one k slice run while the products of the slice before are in
//     flight. setmaxnreg moves registers from the producer (56) to them (224).
// What bounds them is not the tensor cores, which they keep busy about a fifth (tf32)
// and an eighth (bf16p) of the time on the chi = 4096 list (PERF.md §6). Development
// builds that took one part out at a time pointed at the copies: their L2 reads of the
// raw slices, and the shared-memory pipe that the copies, the pass and wgmma's operand
// reads all use, which lets the copies overlap the pass little. The 128 x 256 tile
// reads A from L2 half as often per product as a 128 x 128 one and halves the steps
// and their waits.
// The rounded buffers leave room for two raw stages (tf32) or three (bf16p) at
// 128 x 256, four (tf32, f32w) and five (bf16p) at 128 x 128.
// One more kind computes complex128 lists (the Fibonacci golden chain's compose
// lists, whose MPO is complex), at full precision whatever config.matmul_precision
// says, as cyten_tpu computes complex products:
//   c128  DMMA on split parts, four real DMMAs a complex multiply-add, warp-
//         specialised (grouped_gemm_complex: a producer warpgroup, eight consumer
//         warps, an mbarrier ring), on 128 x 64 or 64 x 64 tiles picked per list.
// And every kind has a thin form (grouped_gemm_thin) for lists of small depth whose
// outputs are narrow or short (the environment updates' contractions with an MPO
// tensor): a streaming pass on the CUDA cores, bound by memory.
// The other kinds' operands reach shared memory through a ring of stages filled by
// cp.async, so the loads of later k slices overlap the products of this one (tf32,
// bf16p, f32w and c128: above). Every ring runs over the concatenated (pair, k slice)
// stream of a tile: the loads of the next pair overlap the last products of this one.
//
// Alignment. Sector sizes are arbitrary (1462, 980, 295, 40, 2 at chi = 4096), so a
// row of A or B starts on a 16-byte boundary only by chance. The f64, f32 and bf16
// kinds pick one copy width per operand of a pair (copy_bytes), the widest of
// 16, 8 and 4 bytes that divides both the base address and the row pitch; a bf16
// operand with an odd pitch is copied one element at a time through registers. A
// complex128 element is 16 bytes: the wrapper hands the kernel 16-byte-aligned bases.
//
// Each thread issues its copies of a stage in a loop unrolled LOAD_UNROLL times:
// fully unrolled, the 16-32 narrow bf16 copies of a stage held their addresses in
// registers and pushed the wgmma accumulators out to local memory.
//
// Why not TMA. A tensor map needs row pitches that are multiples of 16 bytes, which
// these operands rarely have, and it needs one descriptor per operand per call:
// host work of the kind this design removes. cp.async serves every pitch: the
// cp.async kinds by copy width, the staged kinds by aligned spans. Operand strides
// read by the kernel (so that the abelian backend stops copying permuted blocks)
// are a later step.
//
// Schedule. The grid is persistent, a few CTAs per SM (one for the staged kinds, whose
// rings take most of its shared memory). CTA b takes the tile ids b, b + gridDim.x,
// ... and finds the output of a tile by a binary search over the outputs' first tile
// ids. The host orders the outputs by work (the sum of K over
// their pairs, largest first), so the heaviest tiles are taken first.
//
// Tables (int64, built by cyten_tpu_torch/blocks/grouped_gemm.py). Up to
// INLINE_WORDS of them travel inside the launch's parameter block (32 KB since CUDA
// 12.1): no allocation, no copy of their own on the host, and the kernel reads its
// per-step pair rows through the constant cache. On the H100 that made the bf16 path
// at the chi = 4096 list 1.4x faster than the same kernel reading its tables from
// device memory, and f64 a few per cent. Larger lists come in device memory.
//   outs  [n_out, 8]   = c_ptr, M, N, first_tile, tiles_n, pair_begin, pair_end, unit
// (unit: the rows or columns of a thin form's unit, 0 for the tiled kinds)
//   pairs [n_pairs, 8] = a_ptr, lda, b_ptr, ldb, K, a_bf16, b_bf16, 0
// (a_bf16, b_bf16: the operand is bf16; read by the converting kinds only)
// A_p is [M, K] with row pitch lda, B_p [K, N] with row pitch ldb (unit stride
// along a row), C_o contiguous [M, N]; pitches count elements (complex ones for
// c128). The tiles of output o are first_tile .. first_tile + ceil(M / BM) *
// tiles_n - 1, tiles_n = ceil(N / BN), row-major.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int OUT_COLS = 8;
constexpr int PAIR_COLS = 8;
constexpr int PAIR_K = 4;  // the column of K in a pair row
constexpr int PAIR_A_BF16 = 5, PAIR_B_BF16 = 6;  // the operand is bf16 (converting kinds)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies the ROWS x COLS box at (r0, c0) of a row-major matrix (pitch ld, R x C
// valid) into one stage of shared memory, element (r, c) at byte off(r, c) of
// `stage`, in copies of VB bytes; what lies outside the matrix reads as zero.
// Neighbouring threads take neighbouring chunks of a row; each thread keeps one
// column and steps down the rows, so it carries one pointer, not one per copy.
template <typename T, int ROWS, int COLS, int THREADS, int UNROLL, int VB, class Off>
__device__ __forceinline__ void load_box_v(unsigned char* stage, const T* base, int64_t ld,
                                           int64_t r0, int64_t c0, int64_t R, int64_t C,
                                           Off off) {
  constexpr int V = VB / static_cast<int>(sizeof(T));
  constexpr int PER_ROW = COLS / V;
  static_assert(THREADS % PER_ROW == 0, "a row's chunks must not straddle the threads");
  constexpr int ROW_STEP = THREADS / PER_ROW;
  static_assert(ROWS % ROW_STEP == 0, "box does not split evenly over the threads");
  const int r = static_cast<int>(threadIdx.x) / PER_ROW;
  const int c = (static_cast<int>(threadIdx.x) % PER_ROW) * V;
  int64_t cols = C - (c0 + c);  // valid elements of this thread's chunk
  cols = cols < 0 ? 0 : (cols > V ? V : cols);
  const int bytes = static_cast<int>(cols) * static_cast<int>(sizeof(T));
  int64_t rows = R - (r0 + r);  // valid rows from this thread's first one
  const int n_rows = static_cast<int>(rows < 0 ? 0 : (rows > ROWS ? ROWS : rows));
  const T* src = base + (r0 + r) * ld + c0 + c;
  const int64_t step = ROW_STEP * ld;
#pragma unroll UNROLL
  for (int i = 0; i < ROWS / ROW_STEP; ++i) {
    const int n = i * ROW_STEP < n_rows ? bytes : 0;
    if constexpr (VB >= 4) {
      // with a source size of 0 nothing is read: src may point past the matrix
      cp_async<VB>(smem_u32(stage + off(r + i * ROW_STEP, c)), src, n);
    } else {  // one element through registers: a pitch no cp.async width divides
      *reinterpret_cast<T*>(stage + off(r + i * ROW_STEP, c)) = n > 0 ? *src : T(0);
    }
    src += step;
  }
}

// The widest cp.async copy (16, 8 or 4 bytes) that divides both the base address and
// the row pitch of a matrix of T; sizeof(T) where none does.
template <typename T>
__device__ __forceinline__ int copy_bytes(const T* base, int64_t ld) {
  const uint64_t both = reinterpret_cast<uint64_t>(base) | static_cast<uint64_t>(ld * sizeof(T));
  const uint64_t low = both & (~both + 1);  // its lowest set bit
  return low == 0 || low >= 16 ? 16 : (low < sizeof(T) ? static_cast<int>(sizeof(T))
                                                       : static_cast<int>(low));
}

template <typename T, int ROWS, int COLS, int THREADS, int UNROLL, class Off>
__device__ __forceinline__ void load_box(unsigned char* stage, const T* base, int64_t ld,
                                         int64_t r0, int64_t c0, int64_t R, int64_t C,
                                         Off off) {
  const int width = copy_bytes(base, ld);
  // the widths a T cannot take are never asked for; they instantiate the 16-byte copy
  constexpr int W8 = sizeof(T) <= 8 ? 8 : 16;
  constexpr int W4 = sizeof(T) <= 4 ? 4 : 16;
  constexpr int W1 = sizeof(T) < 4 ? static_cast<int>(sizeof(T)) : 16;
  if (width == 16) {
    load_box_v<T, ROWS, COLS, THREADS, UNROLL, 16>(stage, base, ld, r0, c0, R, C, off);
  } else if (width == 8) {
    load_box_v<T, ROWS, COLS, THREADS, UNROLL, W8>(stage, base, ld, r0, c0, R, C, off);
  } else if (width == 4) {
    load_box_v<T, ROWS, COLS, THREADS, UNROLL, W4>(stage, base, ld, r0, c0, R, C, off);
  } else {
    load_box_v<T, ROWS, COLS, THREADS, UNROLL, W1>(stage, base, ld, r0, c0, R, C, off);
  }
}

// ---- f64: DMMA (mma.sync m16n8k4 .f64) ------------------------------------------------

struct F64 {
  using T = double;
  static constexpr int THREADS = 128, BM = 128, BN = 64, BK = 16, STAGES = 3, MIN_CTAS = 2,
                       LOAD_UNROLL = 16;
  static constexpr int LDA = BK + 4;   // padded rows: fragment loads hit 16 distinct banks
  static constexpr int LDB = BN + 4;
  static constexpr int A_BYTES = BM * LDA * 8;
  static constexpr int STAGE_BYTES = A_BYTES + BK * LDB * 8;
  static constexpr bool SWIZZLED = false, ASYNC_MMA = false;
  struct Acc { double v[4][4][4]; };  // [m16 tile][n8 tile][fragment]

  __device__ __forceinline__ static uint32_t a_off(int r, int c) {
    return (r * LDA + c) * 8;
  }
  __device__ __forceinline__ static uint32_t b_off(int r, int c) {
    return A_BYTES + (r * LDB + c) * 8;
  }

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc.v[i][j][f] = 0.;
  }

  __device__ __forceinline__ static void drain(Acc&) {}

  // warp w owns rows (w / 2) * 64 .. + 63 and cols (w % 2) * 32 .. + 31 of the tile
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* stage) {
    const double* sA = reinterpret_cast<const double*>(stage);
    const double* sB = reinterpret_cast<const double*>(stage + A_BYTES);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const double* a_base = sA + ((warp / 2) * 64 + g) * LDA + t;
    const double* b_base = sB + t * LDB + (warp % 2) * 32 + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      // A fragments: rows g and g + 8, col t; B fragment: row t, col g
      double a[4][2], b[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i][0] = a_base[(i * 16) * LDA + kk];
        a[i][1] = a_base[(i * 16 + 8) * LDA + kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j][0] = b_base[kk * LDB + j * 8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma(acc.v[i][j], a[i], b[j]);
    }
  }

  __device__ __forceinline__ static void dmma(double (&c)[4], const double (&a)[2],
                                              const double (&b)[1]) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  }

  // fragment f of an m16n8 tile: row g + 8 * (f / 2), col 2 * t + f % 2
  __device__ __forceinline__ static void store(const Acc& acc, double* C, int64_t M, int64_t N,
                                               int64_t row0, int64_t col0) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int64_t r = row0 + (warp / 2) * 64 + i * 16 + g + 8 * (f / 2);
          const int64_t c = col0 + (warp % 2) * 32 + j * 8 + 2 * t + f % 2;
          if (r < M && c < N) C[r * N + c] = acc.v[i][j][f];
        }
  }
};

// ---- f32: FMA pipes, 8 x 8 register patch ---------------------------------------------

struct F32 {
  using T = float;
  static constexpr int THREADS = 256, BM = 128, BN = 128, BK = 16, STAGES = 4, MIN_CTAS = 2,
                       LOAD_UNROLL = 8;
  static constexpr int LDA = BK + 4;
  static constexpr int LDB = BN + 4;
  static constexpr int A_BYTES = BM * LDA * 4;
  static constexpr int STAGE_BYTES = A_BYTES + BK * LDB * 4;
  static constexpr bool SWIZZLED = false, ASYNC_MMA = false;
  struct Acc { float v[8][8]; };

  __device__ __forceinline__ static uint32_t a_off(int r, int c) { return (r * LDA + c) * 4; }
  __device__ __forceinline__ static uint32_t b_off(int r, int c) {
    return A_BYTES + (r * LDB + c) * 4;
  }

  // thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + i and 64 + ty*4 + i, cols
  // tx*4 + j and 64 + tx*4 + j (i, j < 4)
  __device__ __forceinline__ static int row(int i) {
    return (i / 4) * 64 + (threadIdx.x / 16) * 4 + i % 4;
  }
  __device__ __forceinline__ static int col(int j) {
    return (j / 4) * 64 + (threadIdx.x % 16) * 4 + j % 4;
  }

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc.v[i][j] = 0.f;
  }

  __device__ __forceinline__ static void drain(Acc&) {}

  __device__ __forceinline__ static float lane_of(const float4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }

  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* stage) {
    const float* sA = reinterpret_cast<const float*>(stage);
    const float* sB = reinterpret_cast<const float*>(stage + A_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(sA + row(i) * LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(sB + (kk + q) * LDB + col(0));
        const float4 b1 = *reinterpret_cast<const float4*>(sB + (kk + q) * LDB + col(4));
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(av, b[j], acc.v[i][j]);
        }
      }
    }
  }

  __device__ __forceinline__ static void store(const Acc& acc, float* C, int64_t M, int64_t N,
                                               int64_t row0, int64_t col0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = row0 + row(i);
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t c = col0 + col(j);
        if (c < N) C[r * N + c] = acc.v[i][j];
      }
    }
  }
};

// ---- bf16: wgmma m64n128k16, f32 accumulators -----------------------------------------

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  // start address, leading and stride byte offsets in 16-byte units; layout 1 = 128B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
       | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
       | (1ull << 62);
}

// D[64 x 128] = A[64 x 16] (K-major) * B[16 x 128] (MN-major: trans-b = 1), plus D
// unless scale_d is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

struct BF16 {
  using T = uint16_t;  // bf16 bits: the loads copy, they do not convert
  static constexpr int THREADS = 256, BM = 128, BN = 128, BK = 64, STAGES = 3, MIN_CTAS = 2,
                       LOAD_UNROLL = 8;
  static constexpr int A_BYTES = BM * BK * 2;  // 16 KiB
  static constexpr int STAGE_BYTES = A_BYTES + BK * BN * 2;
  static constexpr bool SWIZZLED = true, ASYNC_MMA = true;
  struct Acc { float v[64]; };

  // 128-byte swizzle (the layout of TMA's SWIZZLE_128B): in each 1024-byte block of
  // eight 128-byte rows, the 16-byte chunk c of row r sits at chunk c ^ r.
  // A [BM x 64] K-major: row m is 128 bytes of k; 8-row blocks 1024 bytes apart.
  __device__ __forceinline__ static uint32_t a_off(int r, int c) {
    return (r / 8) * 1024 + (r % 8) * 128 + (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
  }
  // B [64 x BN] MN-major: two 64-column halves 8 KiB apart; in each, row k is 128
  // bytes of n, 8-row blocks 1024 bytes apart.
  __device__ __forceinline__ static uint32_t b_off(int r, int c) {
    return A_BYTES + (c / 64) * 8192 + (r / 8) * 1024 + (r % 8) * 128
         + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
  }

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc.v[i] = 0.f;
  }

  __device__ __forceinline__ static void fence_acc(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc.v[i]) :: "memory");
  }

  // warpgroup w issues its 64 rows, the four k16 steps of the stage in one group, and
  // waits for the group of the step before: one group stays in flight while the
  // threads refill the ring
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* stage) {
    const uint32_t a = smem_u32(stage) + (threadIdx.x / 128) * 8192;
    const uint32_t b = smem_u32(stage + A_BYTES);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(acc.v, wgmma_desc(a + kk * 32, 16, 1024),
                       wgmma_desc(b + kk * 2048, 8192, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }

  __device__ __forceinline__ static void drain(Acc& acc) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }

  // accumulator i of thread (warp w4 of warpgroup wg, lane l): n8 block i / 4,
  // row wg*64 + w4*16 + l/4 + 8 * ((i / 2) % 2), col 8 * (i / 4) + 2 * (l % 4) + i % 2
  __device__ __forceinline__ static void store(const Acc& acc, __nv_bfloat16* C, int64_t M,
                                               int64_t N, int64_t row0, int64_t col0) {
    const int wg = threadIdx.x / 128, w4 = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int64_t r = row0 + wg * 64 + w4 * 16 + l / 4 + 8 * ((i / 2) % 2);
      const int64_t c = col0 + 8 * (i / 4) + 2 * (l % 4) + i % 2;
      if (r < M && c < N) C[r * N + c] = __float2bfloat16(acc.v[i]);
    }
  }
};

template <class P> struct Out { using type = typename P::T; };
template <> struct Out<BF16> { using type = __nv_bfloat16; };

// ---- tf32 and bf16p: raw staging, a rounding pass, wgmma ------------------------------

// One output tile of the persistent walk: its output's row of the table, read.
struct Tile {
  int64_t c, M, N, row0, col0, p_begin, p_end;
};

// One pair's row of the table, read: operand addresses and pitches, K, the bf16 flags.
struct Pair {
  uint64_t a, b;
  int64_t lda, ldb, K, a_bf16, b_bf16;
};

// The (pair, k slice) steps of one tile, as Cursor walks them (pairs with K = 0
// skipped), with the current pair's row read once into registers, not at every step.
struct Stream {
  const int64_t* rows;
  int64_t p, end, k0;
  Pair pr;

  __device__ __forceinline__ void enter() {  // the first pair from p on with K > 0
    for (; p < end; ++p) {
      const int64_t* r = rows + PAIR_COLS * p;
      pr.K = r[PAIR_K];
      if (pr.K > 0) {
        pr = {static_cast<uint64_t>(r[0]), static_cast<uint64_t>(r[2]), r[1], r[3], pr.K,
              r[PAIR_A_BF16], r[PAIR_B_BF16]};
        return;
      }
    }
  }
  __device__ __forceinline__ bool more() const { return p < end; }
  __device__ __forceinline__ void next(int bk) {
    k0 += bk;
    if (k0 >= pr.K) {
      ++p;
      k0 = 0;
      enter();
    }
  }
};

__device__ __forceinline__ Stream stream_of(const int64_t* pairs, const Tile& w) {
  Stream s{pairs, w.p_begin, w.p_end, 0, {}};
  s.enter();
  return s;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Waits until the phase of parity `parity` of the mbarrier at `bar` has completed. A
// wait of 2^30 tries (seconds) is a fault of the protocol: the kernel traps, and the
// launch fails, rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 30)) __trap();
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// The f32 bits of value e of a raw row whose first value lies at `row`: f32, or bf16
// widened exactly.
template <int E>
__device__ __forceinline__ uint32_t raw_bits(const unsigned char* row, int e) {
  if constexpr (E == 4) return *reinterpret_cast<const uint32_t*>(row + 4 * e);
  else return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(row + 2 * e)) << 16;
}

// f32 bits rounded to TF32 as round_tf32 computes it (to nearest, ties away from
// zero: the bits of cvt.rna.tf32.f32 for finite values), in two integer operations.
__device__ __forceinline__ uint32_t tf32_bits(uint32_t x) { return (x + 0x1000u) & ~0x1FFFu; }

// A warpgroup's m64nN accumulators: N / 2 floats a thread (wgmma's fragment layout).
template <int N>
struct WgAcc {
  float v[N / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) v[i] = 0.f;
  }
  // keeps the compiler from moving reads or writes of the accumulators across a wgmma
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(v[i]) :: "memory");
  }
  __device__ __forceinline__ void drain() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence();
  }
};

// The layout the staged kinds share. Threads 0-255 are the two consumer warpgroups
// (warpgroup w owns rows 64 w .. 64 w + 63 of the tile), threads 256-383 the
// producer warpgroup. Shared memory, from a 1 KiB boundary: two rounded buffers
// (ROUND_BYTES each, laid out for wgmma), RAW_STAGES raw stages, then the full and
// empty mbarriers of the raw stages. A raw stage holds the BM x BK box of A and the
// BK x BN box of B, one row of each per pitch, as the aligned spans stage_box copies.
template <int RAW_STAGES_, int ROUND_BYTES_, int BN_>
struct Staged {
  using T = float;  // the type of C
  using Acc = WgAcc<BN_>;
  static constexpr int THREADS = 384, CONSUMERS = 256, PRODUCERS = 128, MIN_CTAS = 1;
  static constexpr int BM = 128, BN = BN_, BK = 32;
  static constexpr int RAW_STAGES = RAW_STAGES_, ROUND_BYTES = ROUND_BYTES_;
  // a row's span: its BK (BN) values in f32, the widest dtype read, and one chunk
  static constexpr int A_PITCH = BK * 4 + 16, B_PITCH = BN * 4 + 16;
  static constexpr int A_RAW = BM * A_PITCH;
  static constexpr int RAW_BYTES = A_RAW + BK * B_PITCH;
  static constexpr int SMEM_BYTES = 1024 + 2 * ROUND_BYTES + RAW_STAGES * (RAW_BYTES + 16);
  static_assert(SMEM_BYTES <= 232448, "more shared memory than an H100 block can have");
  static_assert(ROUND_BYTES % 1024 == 0, "the swizzle is a function of the address");

  // the byte of its aligned span at which a row starts: (address of the row's first
  // value) mod 16, from the low 32 bits of base + row * pitch + col
  __device__ __forceinline__ static uint32_t shift(uint32_t base, uint32_t pitch, uint32_t row,
                                                   uint32_t col) {
    return (base + row * pitch + col) & 15;
  }

  __device__ __forceinline__ static void finish(Acc&) {}  // the accumulators before the store

  // accumulators i, i + 1 (i even) are neighbours in a row: written as one float2
  // where the row's pitch and the output's base allow, so that a warp writes whole
  // 32-byte sectors (the staged kinds' epilogue does not overlap another CTA's loop)
  template <class A>
  __device__ __forceinline__ static void store(const A& acc, float* C, int64_t M, int64_t N,
                                               int64_t row0, int64_t col0) {
    const int wg = threadIdx.x / 128, w4 = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    const bool pairs = ((reinterpret_cast<uintptr_t>(C) | (N * 4)) & 7) == 0;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int64_t r = row0 + wg * 64 + w4 * 16 + l / 4 + 8 * ((i / 2) % 2);
      const int64_t c = col0 + 8 * (i / 4) + 2 * (l % 4);
      if (r >= M) continue;
      if (pairs && c + 1 < N) {
        *reinterpret_cast<float2*>(C + r * N + c) = make_float2(acc.v[i], acc.v[i + 1]);
      } else {
        if (c < N) C[r * N + c] = acc.v[i];
        if (c + 1 < N) C[r * N + c + 1] = acc.v[i + 1];
      }
    }
  }
};

// Copies the ROWS x COLS box at (r0, c0) of a row-major matrix of E-byte values
// (address `base`, pitch ld values, R rows, `cols` >= 1 values from c0 on) into a raw
// stage: row r of the box goes to byte r * PITCH of `dst` as the 16-byte-aligned span
// that holds it, so the row's first value lands at byte (its address & 15). Each copy
// is 16 bytes; bytes past the row's values, and every byte of a row past R, read as
// zero (a copy of source size 0 reads nothing); an aligned row takes one chunk less.
// T neighbouring threads copy a row, chunk c by thread c mod T, so one warp
// instruction asks for whole rows (each sector of a span once); a thread steps its
// row's address from turn to turn.
template <int E, int ROWS, int COLS, int PITCH, int THREADS, int T>
__device__ __forceinline__ void stage_box(unsigned char* dst, uint64_t base, int64_t ld,
                                          int64_t r0, int64_t c0, int64_t R, int64_t cols,
                                          int t) {
  constexpr int CHUNKS = COLS * E / 16 + 1, STEP = THREADS / T;  // rows a turn
  static_assert(CHUNKS * 16 <= PITCH, "a span does not fit its row");
  static_assert(THREADS % T == 0 && ROWS % STEP == 0, "rows do not split evenly");
  const int64_t row = r0 + t / T;
  uint64_t first = base + static_cast<uint64_t>((row * ld + c0) * E);
  const uint64_t step = static_cast<uint64_t>(STEP * ld * E);
  const int64_t rows = R - row;  // rows of the matrix from this thread's first one
  const int values = static_cast<int>(cols) * E;
  uint32_t to = smem_u32(dst + (t / T) * PITCH) + 16 * (t % T);
#pragma unroll
  for (int turn = 0; turn < ROWS / STEP; ++turn) {
    const int head = static_cast<int>(first & 15);
    const int left = rows > turn * STEP ? head + values : 0;  // bytes from the span's start
    const int n_chunks = head ? CHUNKS : CHUNKS - 1;
#pragma unroll
    for (int i = 0; i < (CHUNKS + T - 1) / T; ++i) {
      const int ch = t % T + i * T;
      if (ch < n_chunks) {
        const int bytes = left - 16 * ch;
        cp_async<16>(to + 16 * T * i, reinterpret_cast<const void*>(first - head + 16 * ch),
                     bytes <= 0 ? 0 : (bytes >= 16 ? 16 : bytes));
      }
    }
    first += step;
    to += STEP * PITCH;
  }
}

// The producer warpgroup's copies of one (pair, k slice) step into raw stage `stage`,
// in one cp.async group: the A box eight threads a row, the B box a warp a row.
template <class P, int EA, int EB>
__device__ __forceinline__ void stage_step(unsigned char* stage, const Pair& pr, int64_t k0,
                                           const Tile& w) {
  const int t = threadIdx.x - P::CONSUMERS;
  const int64_t ka = pr.K - k0 < P::BK ? pr.K - k0 : P::BK;
  const int64_t nb = w.N - w.col0 < P::BN ? w.N - w.col0 : P::BN;
  stage_box<EA, P::BM, P::BK, P::A_PITCH, P::PRODUCERS, 8>(stage, pr.a, pr.lda, w.row0, k0,
                                                           w.M, ka, t);
  stage_box<EB, P::BK, P::BN, P::B_PITCH, P::PRODUCERS, 32>(stage + P::A_RAW, pr.b, pr.ldb, k0,
                                                            w.col0, pr.K, nb, t);
  cp_async_commit();
}

// D[64 x 128] += A[64 x 8] (K-major) * B[8 x 128] (K-major: .tf32 takes no transpose)
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major: trans-b = 1)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 8] (K-major) * B[8 x 256] (K-major: .tf32 takes no transpose)
__device__ __forceinline__ void wgmma_m64n256k8_tf32(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// 'tensorfloat32', on a 128 x 256 tile (as the bf16 pass: it halves the steps and the
// reads of A from L2 per product; its two rounded buffers leave room for two raw
// stages). Rounded buffer: A [128 rows x 32 k] then B [256 n x 32 k], both K-major,
// 128-byte rows (32 values) with the 128-byte swizzle: in each 1024-byte block of
// eight rows, the 16-byte chunk c of row r sits at chunk c ^ r.
template <int BN_>
struct TF32Pass : Staged<BN_ == 256 ? 2 : 4, 16384 + BN_ * 128, BN_> {
  using Base = Staged<BN_ == 256 ? 2 : 4, 16384 + BN_ * 128, BN_>;
  using typename Base::Acc;
  using Base::BN, Base::BK, Base::A_PITCH, Base::B_PITCH, Base::A_RAW, Base::shift;
  static constexpr int B_OFF = 16384;
  struct Slice { uint32_t a[16], b[4 * BN / 32]; };  // a thread's values, f32 bits

  __device__ __forceinline__ static uint32_t sw(int r, int c) {  // K-major: row r, k c
    return (r / 8) * 1024 + (r % 8) * 128 + (((c / 4) ^ (r % 8)) * 16) + (c % 4) * 4;
  }

  // load reads a thread's values of a raw slice into registers, write rounds them into
  // the buffer. A: warp q of warpgroup w takes rows 64 w + 16 q .. + 15, lane l k = l
  // (one row a warp instruction: reads of 32 neighbouring values, writes of one
  // 128-byte row). B, transposed: thread t takes n row t % BN, its 16-byte chunks of
  // four k number t / BN + (256 / BN) i: reads of 32 neighbouring n, conflict-free
  // writes.
  static constexpr int B_CHUNKS = BN / 32;  // chunks of four k a thread writes
  __device__ __forceinline__ static int b_chunk(int i) {
    return static_cast<int>(threadIdx.x) / BN + (256 / BN) * i;
  }
  template <int EA, int EB>
  __device__ __forceinline__ static void load(Slice& v, unsigned char*, const unsigned char* raw,
                                              const Pair& pr, int64_t k0, const Tile& w) {
    const int wg = threadIdx.x / 128, q = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    const uint32_t a = static_cast<uint32_t>(pr.a), lda = static_cast<uint32_t>(pr.lda) * EA;
    const uint32_t b = static_cast<uint32_t>(pr.b), ldb = static_cast<uint32_t>(pr.ldb) * EB;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = wg * 64 + q * 16 + i;
      const uint32_t s = shift(a, lda, static_cast<uint32_t>(w.row0 + r),
                               static_cast<uint32_t>(k0) * EA);
      v.a[i] = raw_bits<EA>(raw + r * A_PITCH + s, l);
    }
    const int n = threadIdx.x % BN;
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * b_chunk(i) + j;
        const uint32_t s = shift(b, ldb, static_cast<uint32_t>(k0 + k),
                                 static_cast<uint32_t>(w.col0) * EB);
        v.b[4 * i + j] = raw_bits<EB>(raw + A_RAW + k * B_PITCH + s, n);
      }
  }

  __device__ __forceinline__ static void write(unsigned char* dst, const Slice& v, const Pair&) {
    const int wg = threadIdx.x / 128, q = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<uint32_t*>(dst + sw(wg * 64 + q * 16 + i, l)) = tf32_bits(v.a[i]);
    const int n = threadIdx.x % BN;
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i)
      *reinterpret_cast<uint4*>(dst + B_OFF + sw(n, 4 * b_chunk(i))) =
          make_uint4(tf32_bits(v.b[4 * i]), tf32_bits(v.b[4 * i + 1]),
                     tf32_bits(v.b[4 * i + 2]), tf32_bits(v.b[4 * i + 3]));
  }

  // warpgroup w runs its 64 rows, the four k8 steps of the slice, in one group
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* buf, const Slice&,
                                             const Pair&) {
    const uint32_t a = smem_u32(buf) + (threadIdx.x / 128) * 8192;
    const uint32_t b = smem_u32(buf) + B_OFF;
    acc.fence();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
      const uint64_t db = wgmma_desc(b + kk * 32, 16, 1024);
      if constexpr (BN == 256) wgmma_m64n256k8_tf32(acc.v, da, db);
      else wgmma_m64n128k8_tf32(acc.v, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
};

// 'default', on a 128 x 256 tile as TF32. Rounded buffer: A [128 rows x 32 k]
// K-major in the bf16 kind's layout (BF16::a_off: 128-byte rows, of which the 64 bytes
// of k < 32 are written and read), then B [32 k x 256 n] MN-major, its four 64-column
// atoms 4 KiB apart.
template <int BN_>
struct BF16Pass : Staged<BN_ == 256 ? 3 : 5, 16384 + BN_ * 64, BN_> {
  using Base = Staged<BN_ == 256 ? 3 : 5, 16384 + BN_ * 64, BN_>;
  using typename Base::Acc;
  using Base::BN, Base::BK, Base::A_PITCH, Base::B_PITCH, Base::A_RAW, Base::shift;
  static constexpr int B_OFF = 16384;
  struct Slice { uint32_t a[16], b[BN / 8]; };  // a thread's values, f32 bits

  __device__ __forceinline__ static uint32_t b_off(int r, int c) {  // MN-major: k r, n c
    return B_OFF + (c / 64) * 4096 + (r / 8) * 1024 + (r % 8) * 128
         + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
  }
  // load and write as TF32P's. A: warp q of warpgroup w takes rows 64 w + 16 q .. + 15,
  // two rows r and r + 4 a warp instruction (their swizzled chunks fall in disjoint
  // banks), lane l the pair of k = 2 (l % 16), + 1. B: thread t takes the n pair
  // 2 (t % (BN / 2)), + 1 of k rows b_row(i) = t / (BN / 2) + (512 / BN) i: a warp
  // writes 64 neighbouring n, one 128-byte row.
  __device__ __forceinline__ static int b_row(int i) {
    return static_cast<int>(threadIdx.x) / (BN / 2) + (512 / BN) * i;
  }
  __device__ __forceinline__ static int a_row(int i) {
    const int q = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    return (threadIdx.x / 128) * 64 + q * 16 + (i / 4) * 8 + (l / 16) * 4 + i % 4;
  }

  template <int EA, int EB>
  __device__ __forceinline__ static void load(Slice& v, unsigned char*, const unsigned char* raw,
                                              const Pair& pr, int64_t k0, const Tile& w) {
    const uint32_t a = static_cast<uint32_t>(pr.a), lda = static_cast<uint32_t>(pr.lda) * EA;
    const uint32_t b = static_cast<uint32_t>(pr.b), ldb = static_cast<uint32_t>(pr.ldb) * EB;
    const int c = 2 * (threadIdx.x % 16), n = 2 * (threadIdx.x % (BN / 2));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = a_row(i);
      const uint32_t s = shift(a, lda, static_cast<uint32_t>(w.row0 + r),
                               static_cast<uint32_t>(k0) * EA);
      v.a[2 * i] = raw_bits<EA>(raw + r * A_PITCH + s, c);
      v.a[2 * i + 1] = raw_bits<EA>(raw + r * A_PITCH + s, c + 1);
    }
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
      const int k = b_row(i);
      const uint32_t s = shift(b, ldb, static_cast<uint32_t>(k0 + k),
                               static_cast<uint32_t>(w.col0) * EB);
      v.b[2 * i] = raw_bits<EB>(raw + A_RAW + k * B_PITCH + s, n);
      v.b[2 * i + 1] = raw_bits<EB>(raw + A_RAW + k * B_PITCH + s, n + 1);
    }
  }

  __device__ __forceinline__ static __nv_bfloat162 bf16x2(uint32_t lo, uint32_t hi) {
    return __floats2bfloat162_rn(__uint_as_float(lo), __uint_as_float(hi));  // lo first
  }

  __device__ __forceinline__ static void write(unsigned char* dst, const Slice& v, const Pair&) {
    const int c = 2 * (threadIdx.x % 16), n = 2 * (threadIdx.x % (BN / 2));
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + BF16::a_off(a_row(i), c)) =
          bf16x2(v.a[2 * i], v.a[2 * i + 1]);
#pragma unroll
    for (int i = 0; i < BN / 16; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + b_off(b_row(i), n)) =
          bf16x2(v.b[2 * i], v.b[2 * i + 1]);
  }

  // warpgroup w runs its 64 rows, the two k16 steps of the slice, in one group
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* buf, const Slice&,
                                             const Pair&) {
    const uint32_t a = smem_u32(buf) + (threadIdx.x / 128) * 8192;
    const uint32_t b = smem_u32(buf) + B_OFF;
    acc.fence();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = wgmma_desc(a + kk * 32, 16, 1024);
      const uint64_t db = wgmma_desc(b + kk * 2048, 4096, 1024);
      if constexpr (BN == 256) wgmma_m64n256k16(acc.v, da, db);
      else wgmma_m64n128k16(acc.v, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
};

// D[64 x 128] = A[64 x 16] (registers, wgmma's fragment layout) * B[16 x 128] (MN-major:
// trans-b = 1), plus D unless scale_d is 0
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x0, x1 each as N bf16 pieces (N = 3: an f32 value; N = 1: a bf16 one) whose sum is
// the value exactly (bf16 to nearest even, as split_bf16x3 in blocks/grouped_gemm.py):
// hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid); both differences are
// exact in f32. Each piece packed as a bf16x2 (x0 in the low half).
template <int N>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t (&p)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    p[j] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// 'float32' with a bf16 operand (float32_mixed): three exact bf16 passes on wgmma, the
// passes that cyten_tpu/algorithms/dmrg.py::_with_precision names for the TPU's f32
// dots. The f32 operand is split into hi + mid + lo (split_bf16), the bf16 one is one
// piece as it lies, and a pair runs pieces(A) x pieces(B) passes of
// wgmma.m64n128k16.bf16: 3 for bf16 x f32 or f32 x bf16, 1 for bf16 x bf16. Each
// product of two bf16 is exact in f32, so the kind differs from its plain version (the
// bf16 operand widened, an f32 product) only by the order of its f32 sums. A list
// with a pair of two f32 operands never reaches the kind: grouped_matmul_plan gives
// it to the f32 kind.
// Range. The split is exact only where lo keeps its bits: below about 2^-110 they fall
// under bf16's smallest subnormal (2^-133). A converged DMRG state holds such values
// (the L = 24 centre list missed the K 2^-23 |A||B| bound on them by 4.8e-42 when the
// values themselves were split), so the pieces are taken of the value times 2^24,
// exact for every f32 below 2^104, whose products of pieces are then normal wherever
// the plain version's products are, and the sums are scaled by 2^-24 before the
// store. One operand of a pair carries the scale: B, unless A is f32 and B bf16 (then
// A). So operands and results must stay below 2^104 (2e31) in magnitude: above, they
// come out inf (grouped_matmul_plan's docstring).
// Accumulation. wgmma's f32 accumulation aligns the products to the accumulator and
// truncates, so a sum that runs through one accumulator over the whole depth leans
// toward zero by about 2^-26 of its size at each of its 3 K / 16 additions (3 K 2^-30
// in all: -1.3e-5 of the sums at K = 4386 on the card, PERF.md §6). So each slice's
// passes start from zero (scale-d 0) in the accumulators `t`, and once they are done
// `t` is added, rounded to nearest, into the register sum `v`: the lean is then that
// of the six additions of one slice, whatever K (-7.7e-8 on the card).
// Registers and shared memory decide the tile: 128 x 128 only. The sum doubles the
// accumulators, 64 + 64 a consumer thread (at 128 x 256 it would be 256). A rounded
// buffer holds B's pieces, each [32 k x 128 n] MN-major as BF16Pass's B (8 KB), then
// an f32 A's, K-major in BF16::a_off's layout (pieces 0 and 1 in the k 0-31 and 32-63
// halves of one 16 KB block, piece 2 in a second): 8 + 32 KB, so 40 KB a buffer, and
// four raw stages fit beside the two buffers. A bf16 A goes to the products from
// registers (wgmma's RS form), which spares the shared-memory pipe, the kernel's
// limit, its writes and three reads of A a slice: each consumer thread reads its
// values from the raw stage in wgmma's register layout for A (a warp's 16 rows; rows
// g and g + 8, k 2t, 2t + 1, 2t + 8, 2t + 9 of each k16 step, for lane 4 g + t), as
// f32 bits (Slice), and packs them two a register by a PRMT just before this slice's
// products are issued. The products read their A registers until they are done, after
// the next slice's loads into the Slice have begun: registers made by the PRMT are
// their own, where a copy of the loaded ones (a build that packed the values as it
// loaded them) shares the registers the next loads write, and gave wrong results.
// The consumers split each f32 value as they read it from the raw stage and write its
// pieces into the buffer the products of the slice before last read. ptxas fits the
// consumers in their 224 registers but for 24 bytes of spills (88 with the tables in
// device memory); a development build with A from shared memory had none, and was
// slower at the chi = 4096 list (its times are not kept).
struct F32WPass : Staged<4, 40960, 128> {
  static constexpr int PIECE = BN * 64;   // the bytes of one piece of B: 8 KB
  static constexpr float SCALE = 16777216.f;  // 2^24, and its inverse at the store
  struct Slice { uint32_t a[16]; };  // a thread's values of a bf16 A, f32 bits
  // t: a slice's products (wgmma's accumulators); v: their sum
  struct Acc {
    float v[BN / 2], t[BN / 2];
    __device__ __forceinline__ void zero() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) v[i] = t[i] = 0.f;
    }
    // keeps the compiler from moving reads or writes of t across a wgmma
    __device__ __forceinline__ void fence() {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(t[i]) :: "memory");
    }
    __device__ __forceinline__ void drain() {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence();
    }
    __device__ __forceinline__ void add() {  // the slice's products into the sum
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) v[i] += t[i];
    }
  };

  // piece j of B, MN-major: k r, n c
  __device__ __forceinline__ static uint32_t b_off(int j, int r, int c) {
    return j * PIECE + (c / 64) * 4096 + (r / 8) * 1024 + (r % 8) * 128
         + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
  }
  // piece j of an f32 A, K-major: row r, k c; past B's one piece
  __device__ __forceinline__ static uint32_t a_off(int j, int r, int c) {
    return PIECE + (j / 2) * 16384 + BF16::a_off(r, c + 32 * (j % 2));
  }
  // a bf16 A's value i of a thread: k16 step i / 8, register (i / 2) % 4 of wgmma's
  // fragment (rows + 8 in registers 1 and 3, k + 8 in 2 and 3), element i % 2
  __device__ __forceinline__ static int frag_row(int i) {
    const int q = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
    return (threadIdx.x / 128) * 64 + q * 16 + l / 4 + 8 * ((i / 2) % 2);
  }
  __device__ __forceinline__ static int frag_col(int i) {
    return 16 * (i / 8) + 8 * ((i / 4) % 2) + 2 * (threadIdx.x % 4) + i % 2;
  }
  // A and B are read as BF16Pass reads them
  __device__ __forceinline__ static int a_row(int i) { return BF16Pass<BN>::a_row(i); }
  __device__ __forceinline__ static int b_row(int i) { return BF16Pass<BN>::b_row(i); }

  // A slice from its raw stage: a bf16 A's values into v, the other pieces, split,
  // into the rounded buffer `dst`
  template <int EA, int EB>
  __device__ __forceinline__ static void load(Slice& v, unsigned char* dst,
                                              const unsigned char* raw, const Pair& pr,
                                              int64_t k0, const Tile& w) {
    const uint32_t a = static_cast<uint32_t>(pr.a), lda = static_cast<uint32_t>(pr.lda) * EA;
    const uint32_t b = static_cast<uint32_t>(pr.b), ldb = static_cast<uint32_t>(pr.ldb) * EB;
    constexpr int NA = EA == 4 ? 3 : 1, NB = EB == 4 ? 3 : 1;
    // the operand that carries the scale: A if it is f32 and B bf16, else B (the
    // products by __fmul_rn, which is never contracted into the rest's subtraction)
    constexpr float SA = EA == 4 && EB == 2 ? SCALE : 1.f, SB = SA == 1.f ? SCALE : 1.f;
    if constexpr (EA == 2) {
      const unsigned char* rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = frag_row(2 * h);
        rows[h] = raw + r * A_PITCH + shift(a, lda, static_cast<uint32_t>(w.row0 + r),
                                            static_cast<uint32_t>(k0) * EA);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) v.a[i] = raw_bits<EA>(rows[(i / 2) % 2], frag_col(i));
    } else {
      const int c = 2 * (threadIdx.x % 16);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = a_row(i);
        const unsigned char* row = raw + r * A_PITCH + shift(
            a, lda, static_cast<uint32_t>(w.row0 + r), static_cast<uint32_t>(k0) * EA);
        uint32_t p[NA];
        split_bf16<NA>(__fmul_rn(SA, __uint_as_float(raw_bits<EA>(row, c))),
                       __fmul_rn(SA, __uint_as_float(raw_bits<EA>(row, c + 1))), p);
#pragma unroll
        for (int j = 0; j < NA; ++j) *reinterpret_cast<uint32_t*>(dst + a_off(j, r, c)) = p[j];
      }
    }
    const int n = 2 * (threadIdx.x % (BN / 2));
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
      const int k = b_row(i);
      const unsigned char* row = raw + A_RAW + k * B_PITCH + shift(
          b, ldb, static_cast<uint32_t>(k0 + k), static_cast<uint32_t>(w.col0) * EB);
      uint32_t p[NB];
      split_bf16<NB>(__fmul_rn(SB, __uint_as_float(raw_bits<EB>(row, n))),
                     __fmul_rn(SB, __uint_as_float(raw_bits<EB>(row, n + 1))), p);
#pragma unroll
      for (int j = 0; j < NB; ++j) *reinterpret_cast<uint32_t*>(dst + b_off(j, k, n)) = p[j];
    }
  }
  __device__ __forceinline__ static void write(unsigned char*, const Slice&, const Pair&) {}
  __device__ __forceinline__ static void finish(Acc& acc) {
    acc.add();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc.v[i] *= 1.f / SCALE;
  }

  // warpgroup w runs its 64 rows: the two k16 steps of the slice, NA x NB passes each
  // (the smaller pieces first), the first from zero, one group; a bf16 A (NA = 1) from
  // registers, an f32 one (NA = 3) from the buffer. Called once the products of the
  // slice before are done, which it adds into the sum first
  template <int NA, int NB>
  __device__ __forceinline__ static void passes(Acc& acc, const unsigned char* buf,
                                                const Slice& v) {
    const uint32_t b = smem_u32(buf);
    const uint32_t a = b + PIECE + (threadIdx.x / 128) * 8192;
    uint32_t frag[2][4];
    if constexpr (NA == 1) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // the high halves of two f32 bits: one bf16x2
          frag[kk][r] = __byte_perm(v.a[8 * kk + 2 * r], v.a[8 * kk + 2 * r + 1], 0x7632);
          // written before the fence below, which orders them before the products
          asm volatile("" : "+r"(frag[kk][r]) :: "memory");
        }
    }
    acc.fence();
    acc.add();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = NA - 1; i >= 0; --i)
#pragma unroll
        for (int j = NB - 1; j >= 0; --j) {
          const uint64_t db = wgmma_desc(b + j * PIECE + kk * 2048, 4096, 1024);
          const int scale_d = kk + (NA - 1 - i) + (NB - 1 - j) != 0;
          if constexpr (NA == 1) {
            wgmma_m64n128k16_rs(acc.t, frag[kk], db, scale_d);
          } else {
            const uint64_t da =
                wgmma_desc(a + (i / 2) * 16384 + (i % 2) * 64 + kk * 32, 16, 1024);
            wgmma_m64n128k16(acc.t, da, db, scale_d);
          }
        }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* buf, const Slice& v,
                                             const Pair& pr) {
    if (!pr.a_bf16) passes<3, 1>(acc, buf, v);
    else if (pr.b_bf16) passes<1, 1>(acc, buf, v);
    else passes<1, 3>(acc, buf, v);
  }
};

using TF32P = TF32Pass<256>;
using BF16P = BF16Pass<256>;
using TF32PN = TF32Pass<128>;  // narrow: see cyten_grouped_gemm_info
using BF16PN = BF16Pass<128>;

// A consumer's load of the slice in raw stage `stage` for pair `pr` at k0: the values
// in registers (f32w: its pieces written into `dst`, the rounded buffer of the slice),
// then the stage released to the producer.
template <class P>
__device__ __forceinline__ void load_slice(typename P::Slice& v, unsigned char* dst,
                                           const unsigned char* stage, uint32_t empty_bar,
                                           const Pair& pr, int64_t k0, const Tile& w) {
  if (pr.a_bf16) {
    if (pr.b_bf16) P::template load<2, 2>(v, dst, stage, pr, k0, w);
    else P::template load<2, 4>(v, dst, stage, pr, k0, w);
  } else {
    if (pr.b_bf16) P::template load<4, 2>(v, dst, stage, pr, k0, w);
    else P::template load<4, 4>(v, dst, stage, pr, k0, w);
  }
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(empty_bar);  // its reads are done (release)
}

template <class P, class = void> struct is_staged : std::false_type {};
template <class P>
struct is_staged<P, std::void_t<decltype(P::RAW_STAGES)>> : std::true_type {};


// The (pair, k0) cursor over a tile's concatenated k-slice stream; pairs with K = 0
// are skipped.
struct Cursor {
  int64_t p, k0;
  __device__ void skip_empty(const int64_t* pairs, int64_t end) {
    while (p < end && pairs[PAIR_COLS * p + PAIR_K] == 0) ++p;
  }
  __device__ void advance(const int64_t* pairs, int64_t end, int bk) {
    k0 += bk;
    if (k0 >= pairs[PAIR_COLS * p + PAIR_K]) {
      ++p;
      k0 = 0;
      skip_empty(pairs, end);
    }
  }
};

template <class P>
__device__ __forceinline__ void load_step(unsigned char* stage, const int64_t* pr,
                                          int64_t k0, int64_t M, int64_t N,
                                          int64_t row0, int64_t col0) {
  using T = typename P::T;
  const int64_t K = pr[PAIR_K];
  const auto a_off = [](int r, int c) { return P::a_off(r, c); };
  const auto b_off = [](int r, int c) { return P::b_off(r, c); };
  const T* A = reinterpret_cast<const T*>(pr[0]);
  const T* B = reinterpret_cast<const T*>(pr[2]);
  load_box<T, P::BM, P::BK, P::THREADS, P::LOAD_UNROLL>(stage, A, pr[1], row0, k0, M, K, a_off);
  load_box<T, P::BK, P::BN, P::THREADS, P::LOAD_UNROLL>(stage, B, pr[3], k0, col0, K, N, b_off);
}

// The tables of a launch: in device memory, or, for lists small enough, inside the
// kernel's parameter block (up to 32 KB since CUDA 12.1), which costs the host no
// allocation and no copy of its own and is read through the constant cache.
struct DeviceTables {
  const int64_t* outs;
  const int64_t* pairs;
  __device__ __forceinline__ const int64_t* out_rows() const { return outs; }
  __device__ __forceinline__ const int64_t* pair_rows(int) const { return pairs; }
};

constexpr int INLINE_WORDS = 4000;  // int64 words: 32000 bytes of parameters

struct InlineTables {
  int64_t w[INLINE_WORDS];  // outs rows, then pairs rows
  __device__ __forceinline__ const int64_t* out_rows() const { return w; }
  __device__ __forceinline__ const int64_t* pair_rows(int n_out) const {
    return w + OUT_COLS * n_out;
  }
};

// The tile `tile` of P's tiling: in the last output whose first tile is <= tile
// (outputs with no tiles are skipped), by a binary search over first_tile.
template <class P>
__device__ __forceinline__ Tile find_tile(const int64_t* outs, int n_out, int tile,
                                          int* hint = nullptr) {
  int lo = 0, hi = n_out - 1;
  if (hint) {  // a CTA's tiles only grow: its output is the one before's, or later
    lo = *hint;
    if (lo < hi && outs[OUT_COLS * (lo + 1) + 3] > tile) hi = lo;
  }
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (outs[OUT_COLS * mid + 3] <= tile) lo = mid; else hi = mid - 1;
  }
  if (hint) *hint = lo;
  const int64_t* o = outs + OUT_COLS * lo;
  const int64_t local = tile - o[3], tiles_n = o[4];
  return {o[0], o[1], o[2], (local / tiles_n) * P::BM, (local % tiles_n) * P::BN, o[5], o[6]};
}

template <class P, class Tables>
__global__ void __launch_bounds__(P::THREADS, P::MIN_CTAS)
grouped_gemm_kernel(const __grid_constant__ Tables tables, int n_out, int n_tiles) {
  const int64_t* __restrict__ outs = tables.out_rows();
  const int64_t* __restrict__ pairs = tables.pair_rows(n_out);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  if (P::SWIZZLED)  // the swizzle is a function of the address: stages start on 1 KiB
    smem += (1024 - (smem_u32(smem_raw) & 1023)) & 1023;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const Tile w = find_tile<P>(outs, n_out, tile);
    auto* C = reinterpret_cast<typename Out<P>::type*>(w.c);
    const int64_t M = w.M, N = w.N, p_begin = w.p_begin, p_end = w.p_end;
    const int64_t row0 = w.row0, col0 = w.col0;

    int64_t steps = 0;
    for (int64_t p = p_begin; p < p_end; ++p)
      steps += (pairs[PAIR_COLS * p + PAIR_K] + P::BK - 1) / P::BK;

    typename P::Acc acc;
    P::zero(acc);
    Cursor load{p_begin, 0};
    load.skip_empty(pairs, p_end);
    int64_t loaded = 0;
    int write = 0, read = 0;  // ring slots of the next load and the next product
#pragma unroll 1
    for (int s = 0; s < P::STAGES - 1; ++s) {
      if (loaded < steps) {
        load_step<P>(smem + write * P::STAGE_BYTES, pairs + PAIR_COLS * load.p, load.k0, M,
                     N, row0, col0);
        load.advance(pairs, p_end, P::BK);
        ++loaded;
        write = write + 1 == P::STAGES ? 0 : write + 1;
      }
      cp_async_commit();
    }
#pragma unroll 1
    for (int64_t s = 0; s < steps; ++s) {
      cp_async_wait<P::STAGES - 2>();
      if (P::SWIZZLED)  // make the generic-proxy writes visible to wgmma's async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      unsigned char* stage = smem + read * P::STAGE_BYTES;
      read = read + 1 == P::STAGES ? 0 : read + 1;
      if constexpr (P::ASYNC_MMA) {
        P::mma(acc, stage);  // issued; this warpgroup's product of step s - 1 is done
        __syncthreads();     // and every warpgroup's
      }
      // into the slot of step s - 1, which every thread has finished with
      if (loaded < steps) {
        load_step<P>(smem + write * P::STAGE_BYTES, pairs + PAIR_COLS * load.p, load.k0, M,
                     N, row0, col0);
        load.advance(pairs, p_end, P::BK);
        ++loaded;
        write = write + 1 == P::STAGES ? 0 : write + 1;
      }
      cp_async_commit();
      if constexpr (!P::ASYNC_MMA) P::mma(acc, stage);
    }
    P::drain(acc);
    P::store(acc, C, M, N, row0, col0);
    cp_async_wait<0>();
    __syncthreads();  // the next tile's first loads reuse the stages
  }
}

// The staged kinds (tf32, bf16p, f32w; see the header): the producer warpgroup fills the
// raw ring, the consumer warpgroups round each slice into a wgmma buffer and multiply. Both
// walk the same tiles and (pair, k slice) steps; step g of a CTA uses raw stage g mod
// RAW_STAGES, in its round g / RAW_STAGES, and rounded buffer g mod 2.
template <class P, class Tables>
__global__ void __launch_bounds__(P::THREADS, P::MIN_CTAS)
grouped_gemm_staged(const __grid_constant__ Tables tables, int n_out, int n_tiles) {
  const int64_t* __restrict__ outs = tables.out_rows();
  const int64_t* __restrict__ pairs = tables.pair_rows(n_out);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* rounded = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* raw = rounded + 2 * P::ROUND_BYTES;
  const uint32_t full = smem_u32(raw + P::RAW_STAGES * P::RAW_BYTES);  // 8 bytes each
  const uint32_t empty = full + 8 * P::RAW_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::RAW_STAGES; ++i) {
      mbar_init(full + 8 * i, P::PRODUCERS / 32);   // one arrival a producer warp
      mbar_init(empty + 8 * i, P::CONSUMERS / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= P::CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    // A step's stage is announced LAG steps after its copies started, once this
    // warp's copies of it have landed (cp.async.wait_group): one arrival a warp, not a
    // thread, on the full mbarrier.
    constexpr int LAG = P::RAW_STAGES - 2;
    int slot = 0, ready = 0, pending = 0, out = 0;  // ready: the slot announced next
    uint32_t round = 0;
    const auto announce = [&] {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(full + 8 * ready);
      ready = ready + 1 == P::RAW_STAGES ? 0 : ready + 1;
      --pending;
    };
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile w = find_tile<P>(outs, n_out, tile, &out);
#pragma unroll 1
      for (Stream st = stream_of(pairs, w); st.more(); st.next(P::BK)) {
        mbar_wait(empty + 8 * slot, (round & 1) ^ 1);  // the first round finds it empty
        unsigned char* stage = raw + slot * P::RAW_BYTES;
        if (st.pr.a_bf16) {
          if (st.pr.b_bf16) stage_step<P, 2, 2>(stage, st.pr, st.k0, w);
          else stage_step<P, 2, 4>(stage, st.pr, st.k0, w);
        } else {
          if (st.pr.b_bf16) stage_step<P, 4, 2>(stage, st.pr, st.k0, w);
          else stage_step<P, 4, 4>(stage, st.pr, st.k0, w);
        }
        if (++pending > LAG) {
          cp_async_wait<LAG>();
          announce();
        }
        if (++slot == P::RAW_STAGES) {
          slot = 0;
          ++round;
        }
      }
    }
    cp_async_wait<0>();
    while (pending > 0) announce();
  } else {  // the two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    int slot = 0, buf = 0, out = 0;
    uint32_t round = 0;
    const auto next_slot = [&] {
      if (++slot == P::RAW_STAGES) {
        slot = 0;
        ++round;
      }
    };
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile w = find_tile<P>(outs, n_out, tile, &out);
      typename P::Acc acc;
      acc.zero();
      typename P::Slice v;
      Stream st = stream_of(pairs, w);
      if (st.more()) {
        mbar_wait(full + 8 * slot, round & 1);
        load_slice<P>(v, rounded + buf * P::ROUND_BYTES, raw + slot * P::RAW_BYTES,
                      empty + 8 * slot, st.pr, st.k0, w);
        next_slot();
      }
#pragma unroll 1
      while (st.more()) {
        unsigned char* dst = rounded + buf * P::ROUND_BYTES;
        P::write(dst, v, st.pr);
        // the rounded values, written by the generic proxy, become visible to wgmma's
        // async proxy; this warpgroup's products of the step before are done, and past
        // the barrier every consumer's are: the buffer they read is the next store's
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" :: "n"(P::CONSUMERS) : "memory");
        P::mma(acc, dst, v, st.pr);
        buf ^= 1;
        // the next slice's reads, while the products run
        st.next(P::BK);
        if (st.more()) {  // into the buffer the products of the slice before read
          mbar_wait(full + 8 * slot, round & 1);
          load_slice<P>(v, rounded + buf * P::ROUND_BYTES, raw + slot * P::RAW_BYTES,
                        empty + 8 * slot, st.pr, st.k0, w);
          next_slot();
        }
      }
      acc.drain();
      P::finish(acc);
      P::store(acc, reinterpret_cast<float*>(w.c), w.M, w.N, w.row0, w.col0);
    }
  }
}

// ---- c128: DMMA on split (re, im) parts, warp-specialised ------------------------------
//
// complex128 lists (the Fibonacci golden chain's compose lists, whose MPO is complex),
// at full precision whatever config.matmul_precision says. Each complex multiply-add
// is four real DMMAs, Cr += Ar Br + (-Ai) Bi, Ci += Ar Bi + Ai Br (8 real operations,
// 67 TFLOP/s on the f64 tensor cores), so the bound is the f64 tensor cores' and,
// for a tile of BM x BN complex outputs, the L2 reads of its operands: a 64 x 64 tile
// reads a byte per 16 operations, which near the card's rate asks the L2 for about
// 4 TB/s. Hence a 128 x 64 tile (22 operations a byte) for lists that fill the card
// and a 64 x 64 one, with twice the tiles, for lists that do not; the host picks one
// per list (blocks/grouped_gemm.py::_staged_tile). Both run one CTA an SM:
//   - a producer warpgroup copies each k slice of BK = 16 complex values as it lies
//     (an element is 16 bytes, so every copy is one 16-byte cp.async, zero-filled
//     past the matrix) into a ring of stages of padded rows; each thread's copies of a
//     stage arrive on the stage's full mbarrier when they land
//     (cp.async.mbarrier.arrive.noinc), so no thread waits for its own copies;
//   - eight consumer warps, 32 x 32 complex (128 x 64) or 32 x 16 (64 x 64) outputs
//     each, wait for a stage, read their double2 fragments from it (the padding puts a
//     quarter warp's 16-byte reads in 8 distinct bank groups), release it on its empty
//     mbarrier, one arrival a warp, and run the DMMAs. No barrier spans the CTA: a
//     warp waits only for the stage it reads next.
// setmaxnreg gives the consumers 224 registers (the 32 x 32 tile's accumulators take
// 128) and leaves the producer 56.
template <int BM_>
struct ComplexTile {
  static constexpr int THREADS = 384, CONSUMERS = 256, PRODUCERS = 128, MIN_CTAS = 1;
  static constexpr int BM = BM_, BN = 64, BK = 16;
  static constexpr int WARPS_M = BM / 32, WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N, NJ = WN / 8;  // a warp's columns, its n8 tiles
  // padded rows, in complex elements: a double2 fragment read of a quarter warp (lanes
  // g = 0, 1 and t = 0..3) hits 8 distinct 16-byte bank groups: A (row g, col t) at
  // 20 g + t, 4 g + t mod 8; B (row t, col g) at 66 t + g, 2 t + g mod 8
  static constexpr int LDA = BK + 4, LDB = BN + 2;
  static constexpr int A_BYTES = BM * LDA * 16;
  static constexpr int STAGE_BYTES = A_BYTES + BK * LDB * 16;
  static constexpr int STAGES = (232448 - 1024) / STAGE_BYTES;  // 4 at 128 x 64, 6 at 64 x 64
  static constexpr int SMEM_BYTES = STAGES * (STAGE_BYTES + 16);
  static_assert(SMEM_BYTES <= 232448, "more shared memory than an H100 block can have");
  static_assert(WARPS_M * WARPS_N == 8 && NJ >= 1, "eight consumer warps");
  struct Acc { double re[2][NJ][4], im[2][NJ][4]; };  // [m16 tile][n8 tile][fragment]

  __device__ __forceinline__ static void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc.re[i][j][f] = acc.im[i][j][f] = 0.;
  }

  // the products of one stage: warp w owns rows (w / WARPS_N) * 32 .. + 31 and cols
  // (w % WARPS_N) * WN .. + WN - 1 of the tile
  __device__ __forceinline__ static void mma(Acc& acc, const unsigned char* stage) {
    const double2* sA = reinterpret_cast<const double2*>(stage);
    const double2* sB = reinterpret_cast<const double2*>(stage + A_BYTES);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const double2* a_base = sA + ((warp / WARPS_N) * 32 + g) * LDA + t;
    const double2* b_base = sB + t * LDB + (warp % WARPS_N) * WN + g;
#pragma unroll 1
    for (int kk = 0; kk < BK; kk += 4) {
      // A fragments: rows g and g + 8, col t; B fragment: row t, col g
      double ar[2][2], ai[2][2], an[2][2], br[NJ][1], bi[NJ][1];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double2 v = a_base[(i * 16 + h * 8) * LDA + kk];
          ar[i][h] = v.x;
          ai[i][h] = v.y;
          an[i][h] = -v.y;
        }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const double2 v = b_base[kk * LDB + j * 8];
        br[j][0] = v.x;
        bi[j][0] = v.y;
      }
      // the two products into one accumulator 4 NJ DMMAs apart: each waits for the
      // one before it (the asm statements keep their order)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          F64::dmma(acc.re[i][j], ar[i], br[j]);
          F64::dmma(acc.im[i][j], ar[i], bi[j]);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          F64::dmma(acc.re[i][j], an[i], bi[j]);
          F64::dmma(acc.im[i][j], ai[i], br[j]);
        }
    }
  }

  // fragment f of an m16n8 tile: row g + 8 * (f / 2), col 2 * t + f % 2; C is
  // interleaved complex128, written as one double2 an element
  __device__ __forceinline__ static void store(const Acc& acc, double2* C, int64_t M, int64_t N,
                                               int64_t row0, int64_t col0) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int64_t r = row0 + (warp / WARPS_N) * 32 + i * 16 + g + 8 * (f / 2);
          const int64_t c = col0 + (warp % WARPS_N) * WN + j * 8 + 2 * t + f % 2;
          if (r < M && c < N) C[r * N + c] = make_double2(acc.re[i][j][f], acc.im[i][j][f]);
        }
  }

  // The producer's copies of one (pair, k slice) step into `stage`: the BM x BK box of
  // A and the BK x BN box of B, one complex element a copy, 16 neighbouring threads a
  // row of A and 64 a row of B; what lies outside a matrix is zero.
  __device__ __forceinline__ static void copy_step(unsigned char* stage, const Pair& pr,
                                                   int64_t k0, const Tile& w) {
    const int t = threadIdx.x - CONSUMERS;
    {
      const int r = t / BK, c = t % BK;
      const bool col_in = k0 + c < pr.K;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(pr.a) + ((w.row0 + r) * pr.lda + k0 + c) * 16;
      const int64_t step = (PRODUCERS / BK) * pr.lda * 16;
      uint32_t dst = smem_u32(stage) + (r * LDA + c) * 16;
#pragma unroll 4
      for (int i = 0; i < BM * BK / PRODUCERS; ++i) {
        const bool in = col_in && w.row0 + r + i * (PRODUCERS / BK) < w.M;
        cp_async<16>(dst, src, in ? 16 : 0);
        src += step;
        dst += (PRODUCERS / BK) * LDA * 16;
      }
    }
    {
      const int r = t / BN, c = t % BN;
      const bool col_in = w.col0 + c < w.N;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(pr.b) + ((k0 + r) * pr.ldb + w.col0 + c) * 16;
      const int64_t step = (PRODUCERS / BN) * pr.ldb * 16;
      uint32_t dst = smem_u32(stage) + A_BYTES + (r * LDB + c) * 16;
#pragma unroll 4
      for (int i = 0; i < BK * BN / PRODUCERS; ++i) {
        const bool in = col_in && k0 + r + i * (PRODUCERS / BN) < pr.K;
        cp_async<16>(dst, src, in ? 16 : 0);
        src += step;
        dst += (PRODUCERS / BN) * LDB * 16;
      }
    }
  }
};

using C128 = ComplexTile<128>;
using C128N = ComplexTile<64>;  // narrow: see cyten_grouped_gemm_info

template <class P, class = void> struct is_complex_tile : std::false_type {};
template <class P>
struct is_complex_tile<P, std::void_t<decltype(P::LDB), decltype(P::WARPS_N)>>
    : std::true_type {};

// The complex kind's walk: producer and consumers take the same tiles and (pair, k
// slice) steps; step g of a CTA uses stage g mod STAGES, in its round g / STAGES.
template <class P, class Tables>
__global__ void __launch_bounds__(P::THREADS, P::MIN_CTAS)
grouped_gemm_complex(const __grid_constant__ Tables tables, int n_out, int n_tiles) {
  const int64_t* __restrict__ outs = tables.out_rows();
  const int64_t* __restrict__ pairs = tables.pair_rows(n_out);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t full = smem_u32(smem_raw + P::STAGES * P::STAGE_BYTES);  // 8 bytes each
  const uint32_t empty = full + 8 * P::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      mbar_init(full + 8 * i, P::PRODUCERS);        // one arrival a producer thread
      mbar_init(empty + 8 * i, P::CONSUMERS / 32);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int slot = 0, out = 0;
  uint32_t round = 0;
  const auto next_slot = [&] {
    if (++slot == P::STAGES) {
      slot = 0;
      ++round;
    }
  };
  if (threadIdx.x >= P::CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile w = find_tile<P>(outs, n_out, tile, &out);
#pragma unroll 1
      for (Stream st = stream_of(pairs, w); st.more(); st.next(P::BK)) {
        mbar_wait(empty + 8 * slot, (round & 1) ^ 1);  // the first round finds it empty
        P::copy_step(smem_raw + slot * P::STAGE_BYTES, st.pr, st.k0, w);
        // arrives on the full mbarrier once this thread's copies so far have landed
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                     :: "r"(full + 8 * slot) : "memory");
        next_slot();
      }
    }
    cp_async_wait<0>();
  } else {  // the consumer warps
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile w = find_tile<P>(outs, n_out, tile, &out);
      typename P::Acc acc;
      P::zero(acc);
#pragma unroll 1
      for (Stream st = stream_of(pairs, w); st.more(); st.next(P::BK)) {
        mbar_wait(full + 8 * slot, round & 1);
        P::mma(acc, smem_raw + slot * P::STAGE_BYTES);
        __syncwarp();
        if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * slot);  // its reads are done
        next_slot();
      }
      P::store(acc, reinterpret_cast<double2*>(w.c), w.M, w.N, w.row0, w.col0);
    }
  }
}

__device__ __forceinline__ float widen(uint16_t bits) {  // bf16 -> f32, exact
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// ---- thin lists: a streaming pass -------------------------------------------------------
//
// A list is thin when no pair is deeper than THIN_K and every output is at most THIN_S
// columns wide ('tall': the environment updates' tdot(t, W), M up to 1.4 M rows at
// chi = 4096, K and N at most 3) or at most THIN_S rows tall ('wide': their
// compose(W, tp), M and K at most 3, N up to 1.4 M). Such a list moves a few bytes per
// operation (0.2 GFLOP against 233 MB at chi = 4096), so the bound is the card's
// memory, and a tile of 128 x 128 would spend its steps on empty boxes. The thin form
// of a kind is a pass over the large operand on the CUDA cores:
//   - a work unit is `unit` rows of one output (tall) or `unit` columns (wide), the
//     host's choice per list, stored in column 7 of the output rows: at most 256 PER
//     outputs (PER a thread: 32 for f32 sums, 16 for f64, 8 for complex128) and
//     THIN_STAGE bytes of the large operand for the deepest pair;
//   - a step is one (unit, pair) of the CTA's units, taken in turn. Its operands are
//     copied raw, as they lie, by 16-byte cp.async from the 16-byte-aligned spans that
//     hold them (the span's first value at byte address & 15; bytes past its end read
//     as zero): the tall form's rows of A, one flat span where lda == K (the usual
//     contiguous block; a K = 3 f32 row is 12 bytes, so rows are not aligned one by
//     one), the wide form's K rows of B from col0 on, and the small operand's rows
//     (B in the tall form, A in the wide one). A ring of THIN_STAGES steps keeps the
//     copies of the next steps, across units, in flight while this one computes;
//   - each thread computes the unit's outputs t, t + 256, ..., flat and row-major, so
//     that a warp writes consecutive addresses, converting each value as it reads it
//     from shared memory; the pairs that share an output are summed in registers, and
//     each output is written once.
// The numerics are the kind's: each operand rounded as the kind rounds it (TF32, bf16),
// bf16 operands read in place, f32 (bf16 kind: f32, written as bf16), f64 or complex
// (four real FMAs a multiply-add) sums. Offsets are 64-bit.
constexpr int THIN_K = 16, THIN_S = 16, THIN_THREADS = 256;
constexpr int THIN_STAGE = 32768;  // bytes of a step's large operand, at most
constexpr int THIN_STAGES = 3;
// a stage: the large operand (a span, or K row spans of up to 31 bytes more each),
// then THIN_S rows of the small operand
constexpr int THIN_LARGE_BYTES = THIN_STAGE + THIN_K * 32;
constexpr int THIN_SMALL_PITCH = THIN_S * 16 + 32;
constexpr int THIN_STAGE_BYTES = THIN_LARGE_BYTES + THIN_S * THIN_SMALL_PITCH;
enum { THIN_TALL = 0, THIN_WIDE = 1 };
// the kind codes of the thin forms: these plus the kind's own (0-6)
constexpr int THIN_TALL_CODE = 16, THIN_WIDE_CODE = 32;

__device__ __forceinline__ void mad(float& c, float a, float b) { c = fmaf(a, b, c); }
__device__ __forceinline__ void mad(double& c, double a, double b) { c = fma(a, b, c); }
__device__ __forceinline__ void mad(double2& c, double2 a, double2 b) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
}
__device__ __forceinline__ void zero_of(float& x) { x = 0.f; }
__device__ __forceinline__ void zero_of(double& x) { x = 0.; }
__device__ __forceinline__ void zero_of(double2& x) { x = make_double2(0., 0.); }

// A thin kind: V the type of its sums, O that of C, E the bytes of an operand value
// (0: f32 or bf16, as the pair's flags say), ROUND what each operand value becomes
// (0 as it is, 1 TF32, 2 bf16).
template <typename V_, typename O_, int E_, int ROUND_>
struct Thin {
  using V = V_;
  using O = O_;
  static constexpr int E = E_, ROUND = ROUND_;
  // a thread's outputs of a unit, at most, and the CTAs an SM whose registers the
  // kernel is compiled to fit: of the forms development builds timed on the H100 at
  // the chi = 4096 W lists (16 or 32 outputs, 16 or 32 KB steps, 1 to 3 CTAs), the
  // fastest for each (PERF.md §6)
  static constexpr int PER = sizeof(V) == 16 ? 8 : (sizeof(V) == 8 ? 16 : 32);
  static constexpr int MIN_CTAS = sizeof(V) == 8 ? 3 : 2;

  // the value of E bytes at `p` (shared memory), as the kind computes with it
  template <int EV>
  __device__ __forceinline__ static V value(const unsigned char* p) {
    if constexpr (EV == 2) {
      return fix(widen(*reinterpret_cast<const uint16_t*>(p)));
    } else if constexpr (EV == 4) {
      return fix(*reinterpret_cast<const float*>(p));
    } else if constexpr (EV == 8) {
      return *reinterpret_cast<const double*>(p);
    } else {
      return *reinterpret_cast<const double2*>(p);
    }
  }
  __device__ __forceinline__ static float fix(float x) {
    if constexpr (ROUND == 1) return __uint_as_float(tf32_bits(__float_as_uint(x)));
    else if constexpr (ROUND == 2) return __bfloat162float(__float2bfloat16_rn(x));
    else return x;
  }
  __device__ __forceinline__ static O out(V x) {
    if constexpr (std::is_same<O, __nv_bfloat16>::value) return __float2bfloat16(x);
    else return x;
  }
};

using ThinF64 = Thin<double, double, 8, 0>;
using ThinF32 = Thin<float, float, 4, 0>;
using ThinBF16 = Thin<float, __nv_bfloat16, 2, 0>;
using ThinF32W = Thin<float, float, 0, 0>;
using ThinTF32 = Thin<float, float, 0, 1>;
using ThinBF16P = Thin<float, float, 0, 2>;
using ThinC128 = Thin<double2, double2, 16, 0>;

// The kernel's view of a thin kind in one form.
template <class P_, int FORM_>
struct ThinForm {
  using P = P_;
  static constexpr int FORM = FORM_, THREADS = THIN_THREADS, MIN_CTAS = P::MIN_CTAS;
  static constexpr int SMEM_BYTES = THIN_STAGES * THIN_STAGE_BYTES;
  static constexpr int THIN = 1;
  static_assert(SMEM_BYTES <= 232448, "more shared memory than an H100 block can have");
};

// One unit: its output, rows row0 .. (tall) or columns col0 .. (wide), and its size.
struct ThinUnit {
  Tile w;
  int64_t unit;
};

// The unit `tile` of the walk (outputs with no units are skipped; `hint` as in
// find_tile): tall units are (unit, THIN_S) tiles, wide ones (THIN_S, unit).
template <int FORM>
__device__ __forceinline__ ThinUnit find_unit(const int64_t* outs, int n_out, int tile,
                                              int* hint) {
  int lo = *hint, hi = n_out - 1;
  if (lo < hi && outs[OUT_COLS * (lo + 1) + 3] > tile) hi = lo;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (outs[OUT_COLS * mid + 3] <= tile) lo = mid; else hi = mid - 1;
  }
  *hint = lo;
  const int64_t* o = outs + OUT_COLS * lo;
  const int64_t local = tile - o[3], tiles_n = o[4], unit = o[7];
  const int64_t bm = FORM == THIN_TALL ? unit : THIN_S, bn = FORM == THIN_TALL ? THIN_S : unit;
  return {{o[0], o[1], o[2], (local / tiles_n) * bm, (local % tiles_n) * bn, o[5], o[6]}, unit};
}

__device__ __forceinline__ Pair pair_at(const int64_t* pairs, int64_t p) {
  const int64_t* r = pairs + PAIR_COLS * p;
  return {static_cast<uint64_t>(r[0]), static_cast<uint64_t>(r[2]), r[1], r[3], r[PAIR_K],
          r[PAIR_A_BF16], r[PAIR_B_BF16]};
}

// The first pair from p on with K > 0 (`end` if none).
__device__ __forceinline__ int64_t nonempty(const int64_t* pairs, int64_t p, int64_t end) {
  while (p < end && pairs[PAIR_COLS * p + PAIR_K] == 0) ++p;
  return p;
}

// Copies the `bytes` bytes from global address `src` into shared memory at `dst` as
// the 16-byte-aligned span that holds them: the first lands at dst + (src & 15); the
// bytes past the last read as zero. One 16-byte cp.async a thread a chunk.
__device__ __forceinline__ void thin_span(unsigned char* dst, uint64_t src, int64_t bytes) {
  const uint64_t first = src & ~uint64_t(15), end = src + bytes;
  const int chunks = static_cast<int>((end - first + 15) / 16);
  const uint32_t to = smem_u32(dst);
  for (int c = threadIdx.x; c < chunks; c += THIN_THREADS) {
    const uint64_t at = first + 16 * static_cast<uint64_t>(c);
    const int64_t left = static_cast<int64_t>(end - at);
    cp_async<16>(to + 16 * c, reinterpret_cast<const void*>(at),
                 left >= 16 ? 16 : static_cast<int>(left));
  }
}

// One value of E bytes from global `src` to shared `dst`, through registers.
__device__ __forceinline__ void thin_copy(unsigned char* dst, uint64_t src, int E) {
  if (E == 2) *reinterpret_cast<uint16_t*>(dst) = __ldg(reinterpret_cast<const unsigned short*>(src));
  else if (E == 4) *reinterpret_cast<uint32_t*>(dst) = __ldg(reinterpret_cast<const unsigned int*>(src));
  else if (E == 8) *reinterpret_cast<uint64_t*>(dst) = __ldg(reinterpret_cast<const unsigned long long*>(src));
  else *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

// The value bytes of each operand of a pair.
template <class P>
__device__ __forceinline__ int bytes_a(const Pair& pr) {
  return P::E ? P::E : (pr.a_bf16 ? 2 : 4);
}
template <class P>
__device__ __forceinline__ int bytes_b(const Pair& pr) {
  return P::E ? P::E : (pr.b_bf16 ? 2 : 4);
}

// The copies of one step (unit u, pair pr) into `stage`, in the calling thread's
// cp.async group. Tall: A's rows at byte (A's first address & 15), B's row k at
// THIN_LARGE_BYTES + k THIN_SMALL_PITCH + (its address & 15); rows of A that are not
// one contiguous span (lda != K) are copied a value at a time through registers, from
// byte 0. Wide: B's row k from col0 on at k pitch + (its address & 15), pitch the
// unit's row bytes rounded up; A's row m as B's row k of the tall form.
template <class P, int FORM>
__device__ __forceinline__ void thin_issue(unsigned char* stage, const ThinUnit& u,
                                          const Pair& pr) {
  const int EA = bytes_a<P>(pr), EB = bytes_b<P>(pr);
  const int64_t K = pr.K;
  if constexpr (FORM == THIN_TALL) {
    const int64_t rows_left = u.w.M - u.w.row0;
    const int64_t rows = rows_left < u.unit ? rows_left : u.unit;
    if (pr.lda == K) {
      thin_span(stage, pr.a + u.w.row0 * K * EA, rows * K * EA);
    } else {
      for (int64_t r = threadIdx.x; r < rows; r += THIN_THREADS)
        for (int64_t k = 0; k < K; ++k)
          thin_copy(stage + (r * K + k) * EA, pr.a + ((u.w.row0 + r) * pr.lda + k) * EA, EA);
    }
    for (int64_t k = 0; k < K; ++k)
      thin_span(stage + THIN_LARGE_BYTES + k * THIN_SMALL_PITCH, pr.b + k * pr.ldb * EB,
                u.w.N * EB);
  } else {
    const int64_t cols_left = u.w.N - u.w.col0;
    const int64_t cols = cols_left < u.unit ? cols_left : u.unit;
    const int64_t pitch = (cols * EB + 31) & ~int64_t(15);
    for (int64_t k = 0; k < K; ++k)
      thin_span(stage + k * pitch, pr.b + (k * pr.ldb + u.w.col0) * EB, cols * EB);
    for (int64_t m = 0; m < u.w.M; ++m)
      thin_span(stage + THIN_LARGE_BYTES + m * THIN_SMALL_PITCH, pr.a + m * pr.lda * EA,
                K * EA);
  }
}

// The products of one step into the thread's outputs e = t + i THREADS of the unit,
// (row, col) = rc[i] >> 14, rc[i] & 16383 of its flat row-major [rows, n_cols] part
// (i < n_active). The k loop runs outside the loop over the outputs, whose offsets
// into the stage are found once a step: per k and output two shared-memory reads
// and a multiply-add.
template <class P, int FORM, int EA, int EB>
__device__ __forceinline__ void thin_compute(typename P::V (&acc)[P::PER],
                                             const int (&rc)[P::PER], int n_active,
                                             const unsigned char* stage, const ThinUnit& u,
                                             const Pair& pr, int n_cols) {
  const int K = static_cast<int>(pr.K);
  const unsigned char* small = stage + THIN_LARGE_BYTES;
  int ao[P::PER], bo[P::PER];  // the byte of each output's A row and B column
  const unsigned char* a;      // tall: A's rows; wide: A's rows are in `small`
  const unsigned char* b;      // tall: B's rows are in `small`; wide: B's row 0
  int a_k = EA, b_k;           // bytes from k to k + 1 along A's row and B's column
  uint32_t b_head = 0, b_ld = 0;  // tall: the shift of B's row k is (b_head + k b_ld) & 15
  if constexpr (FORM == THIN_TALL) {
    a = stage + (pr.lda == K ? ((pr.a + u.w.row0 * K * EA) & 15) : 0);
    b = small;
    b_k = THIN_SMALL_PITCH;
    b_head = static_cast<uint32_t>(pr.b);
    b_ld = static_cast<uint32_t>(pr.ldb) * EB;
#pragma unroll
    for (int i = 0; i < P::PER; ++i) {
      ao[i] = (rc[i] >> 14) * K * EA;
      bo[i] = (rc[i] & 16383) * EB;
    }
  } else {
    const int pitch = (n_cols * EB + 31) & ~15;
    const uint32_t a0 = static_cast<uint32_t>(pr.a), lda = static_cast<uint32_t>(pr.lda) * EA;
    const uint32_t shift = static_cast<uint32_t>(pr.b + u.w.col0 * EB) & 15;
    a = small;
    b = stage + shift;
    b_k = pitch;
    b_ld = static_cast<uint32_t>(pr.ldb) * EB;
    b_head = static_cast<uint32_t>(pr.b + u.w.col0 * EB);
#pragma unroll
    for (int i = 0; i < P::PER; ++i) {
      const int m = rc[i] >> 14;
      ao[i] = m * THIN_SMALL_PITCH + static_cast<int>((a0 + m * lda) & 15);
      bo[i] = (rc[i] & 16383) * EB;
    }
  }
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    // B's row k: tall, row k of `small` at its own shift; wide, k pitches on, at the
    // shift of row k less that of row 0
    const unsigned char* bk;
    if constexpr (FORM == THIN_TALL) bk = b + k * b_k + ((b_head + k * b_ld) & 15);
    else bk = b + k * b_k + (((b_head + k * b_ld) & 15) - (b_head & 15));
#pragma unroll
    for (int i = 0; i < P::PER; ++i) {
      if (i >= n_active) break;
      mad(acc[i], P::template value<EA>(a + ao[i] + k * a_k),
          P::template value<EB>(bk + bo[i]));
    }
  }
}

template <class P, int FORM>
__device__ __forceinline__ void thin_step(typename P::V (&acc)[P::PER],
                                          const int (&rc)[P::PER], int n_active,
                                          const unsigned char* stage, const ThinUnit& u,
                                          const Pair& pr, int n_cols) {
  if constexpr (P::E != 0) {
    thin_compute<P, FORM, P::E, P::E>(acc, rc, n_active, stage, u, pr, n_cols);
  } else if (pr.a_bf16) {
    if (pr.b_bf16) thin_compute<P, FORM, 2, 2>(acc, rc, n_active, stage, u, pr, n_cols);
    else thin_compute<P, FORM, 2, 4>(acc, rc, n_active, stage, u, pr, n_cols);
  } else {
    if (pr.b_bf16) thin_compute<P, FORM, 4, 2>(acc, rc, n_active, stage, u, pr, n_cols);
    else thin_compute<P, FORM, 4, 4>(acc, rc, n_active, stage, u, pr, n_cols);
  }
}

// The CTA's units b, b + gridDim.x, ...; its steps (unit, pair with K > 0) in that
// order, step g in stage g mod THIN_STAGES, copied THIN_STAGES - 1 steps ahead.
template <class F, class Tables>
__global__ void __launch_bounds__(THIN_THREADS, F::MIN_CTAS)
grouped_gemm_thin(const __grid_constant__ Tables tables, int n_out, int n_tiles) {
  using P = typename F::P;
  constexpr int FORM = F::FORM;
  const int64_t* __restrict__ outs = tables.out_rows();
  const int64_t* __restrict__ pairs = tables.pair_rows(n_out);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the copying cursor: its unit, pair and the stage of its next step
  int l_tile = blockIdx.x, l_hint = 0, l_slot = 0;
  ThinUnit lu{};
  int64_t lp = 0;
  const auto l_find = [&] {  // the first step from unit l_tile on
    for (; l_tile < n_tiles; l_tile += gridDim.x) {
      lu = find_unit<FORM>(outs, n_out, l_tile, &l_hint);
      lp = nonempty(pairs, lu.w.p_begin, lu.w.p_end);
      if (lp < lu.w.p_end) return;
    }
  };
  const auto issue = [&] {  // the copies of the next step, one cp.async group
    if (l_tile < n_tiles) {
      thin_issue<P, FORM>(smem_raw + l_slot * THIN_STAGE_BYTES, lu, pair_at(pairs, lp));
      l_slot = l_slot + 1 == THIN_STAGES ? 0 : l_slot + 1;
      lp = nonempty(pairs, lp + 1, lu.w.p_end);
      if (lp >= lu.w.p_end) {
        l_tile += gridDim.x;
        l_find();
      }
    }
    cp_async_commit();
  };
  l_find();
#pragma unroll 1
  for (int s = 0; s < THIN_STAGES - 1; ++s) issue();

  int hint = 0, slot = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const ThinUnit u = find_unit<FORM>(outs, n_out, tile, &hint);
    const int64_t left = FORM == THIN_TALL ? u.w.M - u.w.row0 : u.w.N - u.w.col0;
    const int size = static_cast<int>(left < u.unit ? left : u.unit);
    // tall: [size rows, N]; wide: [M, size columns]
    const int n_cols = FORM == THIN_TALL ? static_cast<int>(u.w.N) : size;
    const int n_el = (FORM == THIN_TALL ? size : static_cast<int>(u.w.M)) * n_cols;
    // the thread's outputs e = t + i THREADS < n_el, their (row, col) packed as
    // row << 14 | col (a unit has at most 8192 rows or columns), stepped from one
    // division; the last ones past n_el take
    // (0, 0), whose products are never written
    const int t = threadIdx.x;
    const int n_active = n_el <= t ? 0 : (n_el - t + THIN_THREADS - 1) / THIN_THREADS;
    int rc[P::PER];
    {
      int r = t / n_cols, n = t - r * n_cols;
      const int dr = THIN_THREADS / n_cols, dn = THIN_THREADS - dr * n_cols;
#pragma unroll
      for (int i = 0; i < P::PER; ++i) {
        rc[i] = i < n_active ? (r << 14 | n) : 0;
        r += dr;
        n += dn;
        if (n >= n_cols) {
          n -= n_cols;
          ++r;
        }
      }
    }
    typename P::V acc[P::PER];
#pragma unroll
    for (int i = 0; i < P::PER; ++i) zero_of(acc[i]);
#pragma unroll 1
    for (int64_t p = nonempty(pairs, u.w.p_begin, u.w.p_end); p < u.w.p_end;
         p = nonempty(pairs, p + 1, u.w.p_end)) {
      cp_async_wait<THIN_STAGES - 2>();
      __syncthreads();  // this step's copies have landed; every thread is past the last
      issue();          // into the stage of the step before
      thin_step<P, FORM>(acc, rc, n_active, smem_raw + slot * THIN_STAGE_BYTES, u,
                         pair_at(pairs, p), n_cols);
      slot = slot + 1 == THIN_STAGES ? 0 : slot + 1;
    }
    auto* C = reinterpret_cast<typename P::O*>(u.w.c);
#pragma unroll
    for (int i = 0; i < P::PER; ++i) {
      if (i >= n_active) break;
      if constexpr (FORM == THIN_TALL)
        C[u.w.row0 * u.w.N + i * THIN_THREADS + t] = P::out(acc[i]);
      else
        C[(rc[i] >> 14) * u.w.N + u.w.col0 + (rc[i] & 16383)] = P::out(acc[i]);
    }
  }
  cp_async_wait<0>();
}

template <class P, class = void> struct is_thin : std::false_type {};
template <class P>
struct is_thin<P, std::void_t<decltype(P::THIN)>> : std::true_type {};


constexpr int MAX_DEVICES = 64;

template <class P>
constexpr int smem_bytes() {
  if constexpr (is_staged<P>::value || is_complex_tile<P>::value || is_thin<P>::value)
    return P::SMEM_BYTES;
  else return P::STAGES * P::STAGE_BYTES + (P::SWIZZLED ? 1024 : 0);
}

template <class P, class Tables>
auto kernel_of() {
  if constexpr (is_staged<P>::value) return grouped_gemm_staged<P, Tables>;
  else if constexpr (is_complex_tile<P>::value) return grouped_gemm_complex<P, Tables>;
  else if constexpr (is_thin<P>::value) return grouped_gemm_thin<P, Tables>;
  else return grouped_gemm_kernel<P, Tables>;
}

// Sets the kernel's shared-memory limit and returns its grid cap (resident CTAs per
// SM times SMs) on the current device, once per device.
template <class P, class Tables>
int grid_cap(int& err) {
  static int cap[MAX_DEVICES] = {};
  int dev = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return 0;
  if (dev < MAX_DEVICES && cap[dev] > 0) return cap[dev];
  const auto kernel = kernel_of<P, Tables>();
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<P>()));
  if (err) return 0;
  int sms = 0, per_sm = 0;
  err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return 0;
  err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, P::THREADS, smem_bytes<P>()));
  if (err) return 0;
  if (per_sm <= 0) {
    err = static_cast<int>(cudaErrorInvalidConfiguration);
    return 0;
  }
  if (dev < MAX_DEVICES) cap[dev] = sms * per_sm;
  return sms * per_sm;
}

template <class P, class Tables>
int launch(const Tables& tables, int64_t n_out, int64_t n_tiles, cudaStream_t stream) {
  int err = 0;
  const int cap = grid_cap<P, Tables>(err);
  if (err) return err;
  const int grid = static_cast<int>(n_tiles < cap ? n_tiles : cap);
  const auto kernel = kernel_of<P, Tables>();
  kernel<<<grid, P::THREADS, smem_bytes<P>(), stream>>>(tables, static_cast<int>(n_out),
                                                        static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// Calls f(P()) with the policy P that runs kind `dtype` (see cyten_grouped_gemm) and
// returns what it returns; cudaErrorInvalidValue for a code the kernel has not.
template <class F>
int with_kind(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(F64());
    case 1: return f(F32());
    case 2: return f(BF16());
    case 3: return f(F32WPass());
    case 4: return f(TF32P());
    case 5: return f(BF16P());
    case 6: return f(C128());
    case 7: return f(TF32PN());
    case 8: return f(BF16PN());
    case 9: return f(C128N());
    default: break;
  }
  const bool wide = dtype >= THIN_WIDE_CODE;
  switch (dtype - (wide ? THIN_WIDE_CODE : THIN_TALL_CODE)) {
#define THIN_CASE(code, P) \
    case code: return wide ? f(ThinForm<P, THIN_WIDE>()) : f(ThinForm<P, THIN_TALL>());
    THIN_CASE(0, ThinF64)
    THIN_CASE(1, ThinF32)
    THIN_CASE(2, ThinBF16)
    THIN_CASE(3, ThinF32W)
    THIN_CASE(4, ThinTF32)
    THIN_CASE(5, ThinBF16P)
    THIN_CASE(6, ThinC128)
#undef THIN_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Tables>
int launch_dtype(int dtype, const Tables& tables, int64_t n_out, int64_t n_tiles,
                 cudaStream_t s) {
  return with_kind(dtype, [&](auto policy) {
    return launch<decltype(policy)>(tables, n_out, n_tiles, s);
  });
}

// Runs launch() with CUDA device `device` current and gives the caller's thread its
// device back: where it is current already, as on every call of the DMRG path, that
// costs one cudaGetDevice.
template <class F>
int with_device(int device, F&& launch) {
  int current = 0;
  int err = static_cast<int>(cudaGetDevice(&current));
  if (err || current == device) return err ? err : launch();
  if ((err = static_cast<int>(cudaSetDevice(device)))) return err;
  err = launch();
  cudaSetDevice(current);
  return err;
}

}  // namespace

// dtype (the kind): 0 = float64, 1 = float32, 2 = bfloat16; f32 results of f32 or
// bf16 operands: 3 = f32w ('float32', 128 x 128 tiles), 4 = tf32, 5 = bf16p
// ('default'), on 128 x 256 tiles, 7 = tf32 and 8 = bf16p on 128 x 128 tiles (the host
// picks the width of a list from its shapes); 6 = complex128 on 128 x 64 tiles, 9 on
// 64 x 64; the thin forms of kinds 0-6: THIN_TALL_CODE + kind (tall), THIN_WIDE_CODE +
// kind (wide).
// `tables` holds the outs rows and then the
// pairs rows, n_words int64 in all: in host memory if tables_on_device is 0 (then
// n_words <= INLINE_WORDS; they are copied into the launch's parameters and may be
// freed on return), else in device memory. Launches on `stream` of CUDA device
// `device`. Returns the cudaError_t of the launch (0 on success); the caller raises
// on anything else.
extern "C" int cyten_grouped_gemm(int dtype, const int64_t* tables, int64_t n_words,
                                  int tables_on_device, int64_t n_out, int64_t n_tiles,
                                  int device, void* stream) {
  if (n_tiles <= 0 || n_out <= 0) return 0;
  if (n_tiles > 0x7fffffffLL || n_out > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tables_on_device)
    return with_device(device, [&] {
      return launch_dtype(dtype, DeviceTables{tables, tables + OUT_COLS * n_out}, n_out,
                          n_tiles, s);
    });
  if (n_words > INLINE_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  static thread_local InlineTables inline_tables;  // 32 KB: kept off the stack
  memcpy(inline_tables.w, tables, static_cast<size_t>(n_words) * sizeof(int64_t));
  return with_device(device, [&] { return launch_dtype(dtype, inline_tables, n_out, n_tiles, s); });
}

// The output tile (BM, BN) of each kind and the capacity of the inline tables in
// int64 words: the host lays out its tables by both. For the kinds of two widths
// it picks the tile of each list (blocks/grouped_gemm.py::_staged_tile): a wide step
// does twice the products of a narrow one for less than twice the time, but on lists
// whose N is at most 128 both widths run the same tiles. For a thin form, in place of
// a tile, the two bounds on its units, 256 PER outputs and THIN_STAGE: the host picks the
// unit of each list (blocks/grouped_gemm.py::_thin_unit), numbers the units as tiles
// of (unit, THIN_S) (tall) or (THIN_S, unit) (wide) and writes the unit into column 7
// of the output rows.
extern "C" int cyten_grouped_gemm_info(int dtype, int64_t* bm_bn_words) {
  bm_bn_words[2] = INLINE_WORDS;
  return with_kind(dtype, [&](auto policy) {
    using P = decltype(policy);
    if constexpr (is_thin<P>::value) {  // the outputs of a unit, its large operand's bytes
      bm_bn_words[0] = THIN_THREADS * P::P::PER;
      bm_bn_words[1] = THIN_STAGE;
    } else {
      bm_bn_words[0] = P::BM;
      bm_bn_words[1] = P::BN;
    }
    return 0;
  });
}
