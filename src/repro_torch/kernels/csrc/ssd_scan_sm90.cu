// Mamba2 SSD chunk scan for Hopper (sm_90a), bf16 x: wgmma for every product.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_kernel,
// launched by ssd_scan's pallas_call) on the "sm90" route: x bf16 at P=64,
// N=128 and a chunk Q that is a multiple of 64 (kernels/ssd_scan.py::route
// decides; every other call goes to ssd_scan.cu, the "simt" route).  It
// computes the same function: per (batch b, head h), with a = a[h] < 0,
//     y_j    = sum_{i <= j} (C_j . B_i) exp(csum_j - csum_i) dt_i x_i
//            + exp(csum_j) C_j . state
//     state <- exp(csum_end) state
//              + sum_i exp(csum_end - csum_i) dt_i x_i B_i^T
// over the sequence, with the [P,N] state carried in f32 from the start
// (zero) to the end, which it writes ([B,H,P,N] f32); y is bf16.
//
// What bounds it.  At the serving prefill's shape (B=8, S=512, H=80, P=64,
// N=128, Q=256) the function moves 110,362,944 bytes (x and y in bf16; dt,
// a, B, C and the final state in f32: 32.9 us at 3.35 TB/s) and needs 13.58
// GFLOP (13.7 us at the 989 TFLOP/s bf16 tensor-core peak), so the bytes set
// the bound, 0.0329 ms (chip_smoke.py::ssd_work).  The simt kernel takes
// 63x that: it recomputes C B^T for every head and runs every product as
// f32 FMAs fed from shared memory.
//
// Design.
// - Steps of 64 rows.  The chunk Q only fixes how the reference blocks the
//   work; the recurrence gives the same y and state for any blocking.  This
//   kernel walks the sequence in steps of T = 64 rows (Q is a multiple of
//   64), the blocking of least work: the intra-chunk term costs 2 T P (and
//   2 T N for C B^T) a row, quadratic in the block, while the inter-chunk
//   term and the state update cost 2 N P a row whatever the block.  Every
//   [T,T] tile is one wgmma M tile, so no tile above a diagonal is formed;
//   the diagonal tile is masked before the exponential (above it csum_j -
//   csum_i > 0 and exp can overflow).  The first step's state is zero and
//   its inter term is skipped.
// - C B^T once per (b, step) for a group of heads.  A block owns one batch
//   row and G = 2 heads (G = 1 where H is odd): one warpgroup of 128 threads
//   a head, each carrying its head's state.  Each warpgroup computes half of
//   the step's C B^T tile (m64n32, K = N; one warpgroup alone computes both
//   halves), scales it by each head's decay exp(csum_j - csum_i) and dt_i,
//   and writes that half of both heads' bf16 scores to shared memory; after
//   a block barrier each warpgroup reads its own head's.  (The other way, a
//   first pass writing C B^T [B, S/T, T, T] for per-head blocks, costs a
//   second launch and H reads of each tile from L2.)
// - Everything runs transposed, with the head dim P = 64 as the M of every
//   wgmma, so the state [P,N] is one m64n128 f32 accumulator that stays in
//   registers from the first step to the last:
//     inter  y^T[p,j]  = exp(csum_j) sum_n state[p,n] C[j,n]: the state,
//            rounded to bf16 in registers, is the A operand (the f32
//            accumulator layout of m64n128 is the A-fragment layout of its
//            k steps), C the K-major B operand;
//     intra  y^T[p,j] += sum_i x[i,p] S[j,i], S[j,i] = C_j . B_i exp(csum_j
//            - csum_i) dt_i: x (bf16 already) is the MN-major A operand,
//            the scores the K-major B operand;
//     state  state = exp(csum_end) state + sum_i wx[i,p] B[i,n], wx = exp(
//            csum_end - csum_i) dt_i x_i: f32 grade from three bf16 products
//            of hi/lo splits (hi.hi + hi.lo + lo.hi; the final state is held
//            to 2e-4, which one bf16 product misses by 8x in the emulation of
//            tests/test_torch_ssd_route.py), wx the MN-major A operand, B
//            the MN-major B operand over two 64-column panels.
//   The y path rounds C, B, the scores and the state to bf16 (y is held to
//   5e-2); on the model's path B and C are bf16 values already.  The state
//   update is issued before the scores are written, so it may run under
//   them; that overlap is not measured.  ptxas adds a warpgroup.arrive at
//   two places in each instantiation (C7519, a register fence that waits
//   on no wgmma) and reports no serialised wgmma.
//   Exponentials are ex2.approx of csum kept in log2 units.
// - Operands are 64-row x 64-column bf16 panels with the 128-byte swizzle.
//   cp.async brings each step's inputs while the step before runs its
//   products: x straight into its swizzled panel (two per head, this
//   step's and the next), B and C (f32, which TMA cannot convert) and dt
//   raw; threads then write the bf16 panels of C, B hi and B lo and of wx
//   hi and lo.  y goes out through shared memory in 16-byte rows of the
//   model layout [B,S,H,P] (no transpose copy on either side).  csum is a
//   warp scan in f32.
// - Occupancy.  At the serving shape the grid is B x H/2 = 320 blocks of
//   256 threads; each takes 193 KB of shared memory (48 KB of C and B
//   panels, 24 KB a head for wx and scores, 16 KB a head for x, 64 KB of
//   raw B and C) and its threads ~230 registers (ptxas), so one block fits
//   an SM: 2.4 waves on 132 SMs.  The phases of a step (staging, products,
//   scores, y) follow one another behind block barriers with 8 warps an
//   SM to hide their latency; a producer warp and warpgroups that do not
//   wait on each other are the next step of this design.
//
// Layout: x/y [B,S,H,P] bf16, dt [B,S,H], a [H], B/C [B,S,N], state
// [B,H,P,N], all contiguous, everything but x and y f32; S a multiple of 64
// (the Python adapter pads with dt = 0).  The entry point returns 0 or an
// error code after launching on the caller's stream; it never synchronises
// and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int T = 64;                         // rows a step
constexpr int P = 64;                         // head dim
constexpr int N = 128;                        // state dim
constexpr int PANEL_BYTES = 64 * 64 * 2;      // 64 rows x 64 bf16: 8 KB
constexpr int HEAD_BYTES = 3 * PANEL_BYTES;   // wx hi, wx lo, scores
constexpr int Y_STRIDE = 144;                 // bytes a y row in staging
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_ARGS = 10003;               // shapes or alignment refused

constexpr int RAW_BC_BYTES = T * N * 4;       // a step of B or C, f32

size_t smem_bytes(int g) {
  // C, B hi, B lo (two panels each), the heads' panels, two x panels a
  // head (this step's and the next), the raw B and C of the next step,
  // 1024 to align
  return (size_t)6 * PANEL_BYTES + (size_t)g * HEAD_BYTES +
         (size_t)2 * g * PANEL_BYTES + 2 * RAW_BC_BYTES + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte-swizzled operand in shared memory: start
// address, leading byte offset (the stride between 64-column panels of an
// MN-major operand wider than 64; unused otherwise), stride byte offset
// 1024 (eight 128-byte rows), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of the 16-byte chunk `ch` (8 bf16 columns) of row r in a
// swizzled panel.
__device__ __forceinline__ uint32_t swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma window.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define ACC16 ACC8(0), ACC8(8)
#define REGS16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define REGS64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d[64x64] += A[64x16] B[16x64], both from shared memory, A MN-major and
// B K-major.
__device__ __forceinline__ void wgmma_ss64_tn(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, 1, 1, 1, 1, 0;\n"
      "}\n"
      : ACC32
      : "l"(da), "l"(db));
}

// d[64x32] (+)= A[64x16] B[16x32], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC16
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64x128] += A[64x16] B[16x128], both MN-major in shared memory; B spans
// two 64-column panels, the descriptor's leading byte offset apart.
__device__ __forceinline__ void wgmma_ss128_tt(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, 1, 1, 1, 1, 1;\n"
      "}\n"
      : ACC64
      : "l"(da), "l"(db));
}

// d[64x64] += A[64x16] B[16x64]: A in registers (bf16 pairs), B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      "}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef ACC8
#undef ACC16
#undef REGS16
#undef ACC32
#undef ACC64
#undef REGS32
#undef REGS64

// 2^x, to 2 ulp; 2^-inf = 0 (a masked score).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits v into bf16 hi = bf16(v) and lo = bf16(v - hi), packed in pairs.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Asynchronous copies from device memory into shared memory (no
// registers held while they fly); committed as one group a step.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  if (wg == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
}

// Issues half `half` of the step's C B^T [j][i], the columns i in [32 half,
// 32 half + 32): m64n32, K = N over the two panels of C and of B (hi), both
// K-major; B's half starts 32 rows (4 KB, whole swizzle atoms) in.
__device__ __forceinline__ void issue_cb(float (&cb)[16], uint32_t c_s,
                                         uint32_t b_s, int half) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
    wgmma_ss32(cb, sw128_desc(c_s + off),
               sw128_desc(b_s + half * 32 * 128 + off), kk > 0);
  }
}

// Scores of half `half` of the step for every head g of the group into its
// [j][i] bf16 panel: S[j][i] = (C_j . B_i) exp(csum_j - csum_i) dt_i for
// i <= j, else 0, masked before the exponential (2^-inf = 0).  cb is the
// m64n32 fragment (rows j, columns i - 32 half); the csum and dt values a
// thread needs are read into registers before any store.
template <int G>
__device__ __forceinline__ void write_scores(const float (&cb)[16],
                                             const float (&csum)[G][T],
                                             const float (&dts)[G][T],
                                             uint32_t heads_s, int half,
                                             int r0, int c0) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint32_t sg = heads_s + g * HEAD_BYTES + 2 * PANEL_BYTES;
    float cj[2], ci[4][2], di[4][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) cj[r] = csum[g][r0 + 8 * r];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        ci[jj][c] = csum[g][32 * half + 8 * jj + c0 + c];
        di[jj][c] = dts[g][32 * half + 8 * jj + c0 + c];
      }
    }
    uint32_t packed[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r0 + 8 * r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = 32 * half + 8 * jj + c0;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          v[c] = cb[4 * jj + 2 * r + c] * di[jj][c] *
                 ex2(i + c <= j ? cj[r] - ci[jj][c] : -INFINITY);
        }
        packed[r][jj] = pack_bf16(v[0], v[1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = r0 + 8 * r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         sg + j * 128 + (((4 * half + jj) ^ (j & 7)) << 4) +
                         c0 * 2),
                     "r"(packed[r][jj])
                     : "memory");
      }
    }
  }
}

// The accumulator fragment of m64nK (f32): thread t of the warpgroup holds
// rows r0 = 16 (t/32) + (t%32)/4 and r0 + 8; element 4j + 2i + c sits at
// row r0 + 8i, column 8j + 2 (t%4) + c.  Here rows are p (the head dim) and
// columns j (y) or n (state).
template <int G>
__global__ void __launch_bounds__(G * 128, 1)
ssd_scan_sm90_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     __nv_bfloat16* __restrict__ y,
                     float* __restrict__ state_out, int S, int H) {
  constexpr int NT = G * 128;
  extern __shared__ uint8_t smem_raw[];
  // inclusive scan of dt a within the step, in log2 units: every decay
  // exp(x) below is ex2(x log2 e)
  __shared__ float csum[G][T];
  __shared__ float dts[2][G][T];   // dt of this step and the next

  // swizzled panels must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t c_s = base;                          // C [j][n], 2 panels
  const uint32_t bhi_s = c_s + 2 * PANEL_BYTES;       // B [i][n] hi
  const uint32_t blo_s = bhi_s + 2 * PANEL_BYTES;     // B [i][n] lo
  // a head's wx hi, wx lo ([i][p]) and scores ([j][i])
  const uint32_t heads_s = blo_s + 2 * PANEL_BYTES;
  // x [i][p] of each head, for this step and the next (u = 0, 1)
  const uint32_t x_s = heads_s + G * HEAD_BYTES;
  // the raw f32 C and B [row][n] of the next step
  const uint32_t rawc_s = x_s + 2 * G * PANEL_BYTES;
  const uint32_t rawb_s = rawc_s + RAW_BC_BYTES;
  const float* const rawc = reinterpret_cast<const float*>(
      gbase + (rawc_s - base));
  const float* const rawb = rawc + T * N;

  const int groups = H / G;
  const int b = blockIdx.x / groups;
  const int h0 = (blockIdx.x - b * groups) * G;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = h0 + wg;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  // this warpgroup's head: wx hi, wx lo, scores
  const uint32_t whi_s = heads_s + wg * HEAD_BYTES;
  const uint32_t wlo_s = whi_s + PANEL_BYTES;
  const uint32_t sc_s = wlo_s + PANEL_BYTES;
  uint8_t* const ybuf = gbase + (whi_s - base);   // y staging, after products

  float st[64];   // the state [p][n], m64n128 fragment, f32
#pragma unroll
  for (int e = 0; e < 64; ++e) st[e] = 0.f;
  float acc[32];  // y^T [p][j] of the step, m64n64 fragment
  float cb[16];   // this warpgroup's half of the step's C B^T [j][i]
#pragma unroll
  for (int e = 0; e < 16; ++e) cb[e] = 0.f;

  // the raw C and B, x (straight into the swizzled panels of buffer u) and
  // dt of the rows [r, r + T) of batch row b, by cp.async
  auto fetch = [&](size_t r, int u) {
    for (int k = tid; k < T * N / 4; k += NT) {
      cp_async16(rawc_s + k * 16, cm + r * N + k * 4);
      cp_async16(rawb_s + k * 16, bm + r * N + k * 4);
    }
    for (int k = tid; k < G * T * (P / 8); k += NT) {
      const int g = k / (T * (P / 8));
      const int rem = k - g * (T * (P / 8));
      const int i = rem / (P / 8);
      const int ch = rem - i * (P / 8);
      cp_async16(x_s + (2 * g + u) * PANEL_BYTES + swz(i, ch),
                 x + ((r + i) * H + h0 + g) * P + ch * 8);
    }
    for (int k = tid; k < G * T; k += NT) {
      const int g = k / T;
      const int i = k - g * T;
      cp_async4(smem_u32(&dts[u][g][i]), dt + (r + i) * H + h0 + g);
    }
    cp_async_commit();
  };

  fetch((size_t)b * S, 0);
  for (int s0 = 0, u = 0; s0 < S; s0 += T, u ^= 1) {
    const size_t row0 = (size_t)b * S + s0;   // first (b, s) row of the step
    cp_async_wait<0>();
    __syncthreads();   // this step's inputs have landed, for every thread
    const uint32_t xs = x_s + u * PANEL_BYTES;   // head g's: + 2 g panels

    // 1. csum of each head of the group: warp g scans head h0 + g, two rows
    //    a lane
    if (warp < G) {
      const float ah = a[h0 + warp] * LOG2E;
      const float d0 = dts[u][warp][2 * lane];
      const float d1 = dts[u][warp][2 * lane + 1];
      const float v0 = d0 * ah;
      const float pair = v0 + d1 * ah;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += t;
      }
      csum[warp][2 * lane] = incl - pair + v0;
      csum[warp][2 * lane + 1] = incl;
    }

    // 2. C (bf16) and B (bf16 hi and lo) into [row][n] panels; a task is 8
    //    columns of a row
    for (int k = tid; k < T * (N / 8); k += NT) {
      const int r = k / (N / 8);
      const int ch = k - r * (N / 8);
      const uint32_t off = (ch / 8) * PANEL_BYTES + swz(r, ch % 8);
      const float4* cp =
          reinterpret_cast<const float4*>(rawc + r * N + ch * 8);
      const float4 u0 = cp[0], u1 = cp[1];
      st_shared_v4(c_s + off, pack_bf16(u0.x, u0.y), pack_bf16(u0.z, u0.w),
                   pack_bf16(u1.x, u1.y), pack_bf16(u1.z, u1.w));
      const float4* bp =
          reinterpret_cast<const float4*>(rawb + r * N + ch * 8);
      const float4 w0 = bp[0], w1 = bp[1];
      uint32_t hi[4], lo[4];
      split_bf16(w0.x, w0.y, hi[0], lo[0]);
      split_bf16(w0.z, w0.w, hi[1], lo[1]);
      split_bf16(w1.x, w1.y, hi[2], lo[2]);
      split_bf16(w1.z, w1.w, hi[3], lo[3]);
      st_shared_v4(bhi_s + off, hi[0], hi[1], hi[2], hi[3]);
      st_shared_v4(blo_s + off, lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();   // csum of the step is in

    // 3. wx = exp(csum_end - csum_i) dt_i x_i of each head, split into bf16
    //    hi and lo panels for the state update; a task is 8 columns of a row
    for (int k = tid; k < G * T * (P / 8); k += NT) {
      const int g = k / (T * (P / 8));
      const int rem = k - g * (T * (P / 8));
      const int r = rem / (P / 8);
      const int ch = rem - r * (P / 8);
      const float w = ex2(csum[g][T - 1] - csum[g][r]) * dts[u][g][r];
      const uint4 xv = *reinterpret_cast<const uint4*>(
          gbase + (xs - base) + 2 * g * PANEL_BYTES + swz(r, ch));
      const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xw[q]));
        split_bf16(w * xf.x, w * xf.y, hi[q], lo[q]);
      }
      const uint32_t hs = heads_s + g * HEAD_BYTES + swz(r, ch);
      st_shared_v4(hs, hi[0], hi[1], hi[2], hi[3]);
      st_shared_v4(hs + PANEL_BYTES, lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_smem();   // the panels are read by wgmma (async proxy)
    __syncthreads();
    // the raw buffers and the other x buffer are free: the next step's
    // inputs fly while this step's products run
    if (s0 + T < S) fetch(row0 + T, u ^ 1);

    // 4. Products, in two commit groups: first the inter term from the
    //    state as of the step's start (none at the first step) and this
    //    warpgroup's half of the step's C B^T (columns i in [32 wg, 32 wg +
    //    32); one warpgroup alone takes both halves), then the state
    //    update, which runs on while the scores are written.
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const bool first = s0 == 0;
    uint32_t sa[8][4];   // the state as bf16 A fragments, k steps over n
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
      }
    }
    const float decay = ex2(csum[wg][T - 1]);
#pragma unroll
    for (int e = 0; e < 64; ++e) st[e] *= decay;
    wgmma_fence();
    if (!first) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_rs64(acc, sa[kk],
                   sw128_desc(c_s + (kk / 4) * PANEL_BYTES + (kk % 4) * 32));
      }
    }
    issue_cb(cb, c_s, bhi_s, wg);
    fence_regs(acc);
    fence_regs(cb);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dhi = sw128_desc(whi_s + kk * 2048);
      const uint64_t dlo = sw128_desc(wlo_s + kk * 2048);
      const uint64_t bhi = sw128_desc(bhi_s + kk * 2048, PANEL_BYTES);
      const uint64_t blo = sw128_desc(blo_s + kk * 2048, PANEL_BYTES);
      wgmma_ss128_tt(st, dhi, bhi);
      wgmma_ss128_tt(st, dhi, blo);
      wgmma_ss128_tt(st, dlo, bhi);
    }
    fence_regs(st);
    wgmma_commit();
    wgmma_wait<1>();   // the inter term and C B^T are in
    fence_regs(acc);
    fence_regs(cb);
    if (!first) {
      // column j of y^T times exp(csum_j)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(csum[wg][8 * j + c0 + c]);
          acc[4 * j + c] *= e;
          acc[4 * j + 2 + c] *= e;
        }
      }
    }
    write_scores<G>(cb, csum, dts[u], heads_s, wg, r0, c0);
    if (G == 1) {
      wgmma_fence();
      issue_cb(cb, c_s, bhi_s, 1);
      fence_regs(cb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(cb);
      write_scores<G>(cb, csum, dts[u], heads_s, 1, r0, c0);
    }
    fence_async_smem();   // the scores are read by wgmma (async proxy)
    __syncthreads();      // the scores of every head are in

    // 5. intra term into y^T: x (MN-major A) times the scores (K-major B)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_ss64_tn(acc, sw128_desc(xs + 2 * wg * PANEL_BYTES + kk * 2048),
                    sw128_desc(sc_s + kk * 32));
    }
    fence_regs(acc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(st);

    // 6. y of the step: the fragment (rows p, columns j) into [j][p] bf16
    //    rows of Y_STRIDE bytes over this head's wx panels (read by now),
    //    then 16-byte stores into y [B,S,H,P]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + c0 + c;
          *reinterpret_cast<__nv_bfloat16*>(ybuf + col * Y_STRIDE +
                                            (r0 + 8 * r) * 2) =
              __float2bfloat16_rn(acc[4 * j + 2 * r + c]);
        }
      }
    }
    wg_barrier(wg);
    for (int k = tid % 128; k < T * (P / 8); k += 128) {
      const int r = k / (P / 8);
      const int ch = k - r * (P / 8);
      *reinterpret_cast<uint4*>(y + ((row0 + r) * H + h) * P + ch * 8) =
          *reinterpret_cast<const uint4*>(ybuf + r * Y_STRIDE + ch * 16);
    }
    __syncthreads();   // every buffer read before the next step writes
  }

  // the final state [b][h][p][n]
  float* so = state_out + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float2*>(so + (r0 + 8 * r) * N + 8 * j + c0) =
          make_float2(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
    }
  }
}

template <int G>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(G);
  // Set on every call: the attribute belongs to the current device.
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_sm90_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_sm90_kernel<G><<<B * (H / G), G * 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(state), S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of ssd_scan_fwd (ssd_scan.cu), so one binding serves both.
// x: [B,S,H,P] bf16, dt: [B,S,H], a: [H], bm/cm: [B,S,N] f32; y: [B,S,H,P]
// bf16 and state: [B,H,P,N] f32 out.  All contiguous and 16-byte aligned,
// P = 64, N = 128, is_bf16 = 1, the chunk Q a multiple of 64 and S a
// multiple of Q; the kernel steps 64 rows whatever Q is.  Returns 0 on
// success, else a cudaError_t code or ERR_ARGS.
int ssd_scan_sm90_fwd(const void* x, const void* dt, const void* a,
                      const void* bm, const void* cm, void* y, void* state,
                      int B, int S, int H, int P_, int N_, int Q,
                      int is_bf16, void* stream) {
  bool ok = B > 0 && S > 0 && H > 0 && Q > 0 && Q % T == 0 && S % Q == 0 &&
            P_ == P && N_ == N && is_bf16 == 1 &&
            (long long)B * H <= 2147483647LL;
  const void* ptrs[7] = {x, dt, a, bm, cm, y, state};
  for (const void* p : ptrs) {
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  if (!ok) return ERR_ARGS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 2 == 0) return launch<2>(x, dt, a, bm, cm, y, state, B, S, H, s);
  return launch<1>(x, dt, a, bm, cm, y, state, B, S, H, s);
}

const char* ssd_scan_sm90_error_string(int code) {
  if (code == ERR_ARGS) {
    return "shapes or alignment the kernel does not take";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
