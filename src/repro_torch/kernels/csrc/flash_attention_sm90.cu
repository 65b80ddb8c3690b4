// Flash attention forward for Hopper (sm_90a), bf16: wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention's pallas_call) on the bf16
// route at head dims 64, 112, 128 and 256; every other (dtype, head dim)
// goes to flash_attention.cu (kernels/flash_attention.py::route decides).  It
// computes the same function: softmax(q k^T / sqrt(D) + mask) v with the
// mask k <= q (causal) and q - k < window, keys at positions >= kv_len
// hidden, the KV head h / (H/KH), and an online softmax whose running max
// m, sum l and output accumulator are f32; the output is bf16.
//
// What bounds it.  At the serving path's prefill shape (B=8, S=512, H=16,
// KH=8, D=128, causal) the function moves 50,331,648 bytes (q, k, v read
// once, o written once: 15.0 us at 3.35 TB/s) and does 8.61 GFLOP on the
// causal pairs (8.7 us at the 989 TFLOP/s bf16 tensor-core peak), so the
// bytes set the bound, and both products must run on the tensor cores to
// come near it.  The CUDA-core kernel (flash_attention.cu) is 56x that.
// At gemma-2b's (B=8, S=512, H=8, KH=1, D=256: MQA) the bytes are
// 37,748,736 (11.3 us) and the FLOPs the same 8.61 G (8.7 us).
//
// Design.
// - Blocks of two consumer warpgroups (128 threads each, one 64-row wgmma
//   M tile each).  Where H/KH is even, a block owns (batch row, KV head,
//   two query heads of its group, 64-row q tile): both warpgroups see the
//   same positions, so each K/V tile is loaded once for two heads and
//   causality leaves them equal work (MQA, gemma-2b's KH=1 with H=8: each
//   K/V tile serves two of the eight heads).  Where H/KH is odd, a block
//   owns two consecutive q tiles of one head.  Q tiles are issued heaviest
//   first (blockIdx.y reversed, y the slowest grid dimension).  127
//   registers a thread and 97 KB of shared memory at D=128 let two blocks
//   share an SM.
// - D=256 (gemma-2b) runs one block an SM: its f32 output accumulator is
//   128 registers a thread by itself (m64n256), so the block gets the
//   whole register file (at most 255 a thread; __launch_bounds__ with one
//   block), and its tiles take (2 Q + 2 stages x (K + V)) x 4 panels x 8
//   KB + 1 KB = 197,632 bytes of the 227 KB a block may have.  P V runs as
//   two m64n128 products a k step, one per 128-column half of the output
//   (panels 0-1 and 2-3 of V), so the accumulator is two 64-float chunks.
// - Operands reach shared memory by TMA (cp.async.bulk.tensor, 4-d maps
//   over [B, heads, S, D] views with any strides that are multiples of 16
//   bytes), in 128-byte-swizzled panels of 64 rows x 64 bf16 columns: a
//   D=128 tile is two panels, a D=256 tile four.  D=112 (zamba2) runs on
//   the D=128 code with tensor maps of inner extent 112: TMA fills columns
//   112-127 of the second panel with zeros on every load (the box still
//   credits its full bytes to the barrier) and clips them on the output
//   store.  Zero columns add nothing to Q K^T and give output columns that
//   are never stored; the scale is 1/sqrt of the true D.  K/V tiles go
//   through a ring of two stages,
//   K and V of a stage each with an mbarrier (expect-tx bytes, then a wait
//   on its phase), so Q K^T starts before V has landed; the loads of the
//   next tile fly while this one's products run.  Each
//   warpgroup counts itself out of a stage when done with it, and the last
//   one of the block issues the refill, so the two warpgroups drift apart
//   by up to a tile and one's softmax overlaps the other's products.
// - S = Q K^T: wgmma m64n64k16, bf16 in, f32 accumulate, both operands
//   K-major from shared memory (descriptors: 128-byte swizzle, 1024-byte
//   stride between 8-row groups, 32 bytes per k step inside a panel).
// - The online softmax runs on the accumulator fragment in registers (the
//   four lanes that hold a row combine the max by quad shuffles), in the
//   log2 domain with one prescale.  The mask is evaluated only in tiles
//   that cut it (the diagonal, the window's edge, the tile holding kv_len);
//   tiles above the diagonal or outside the window are never loaded.  A row
//   that sees no key keeps m = -inf, l = 0 and outputs 0.
// - O += P V: P is rounded to bf16 in registers, where the f32 accumulator
//   layout of the first product is the A-fragment layout of the second, so
//   P never touches shared memory; V is the MN-major B operand ([keys, D]
//   row-major, transpose bit set), one m64nDk16 per 16 keys over its panels
//   (two m64n128k16 at D=256).
// - The output goes through the warpgroup's Q tile in shared memory (free
//   by then, same swizzle) and out by TMA into a [B, Sq, H, D] buffer, the
//   model's layout, so the caller needs no transpose copy.
//
// Next steps (not here): a producer warp with setmaxnreg that keeps the
// TMA ring full and gives the consumers the registers to overlap one
// tile's softmax with the next tile's Q K^T (warp specialisation; under
// 128 registers that overlap spills and runs slower), and persistent
// blocks.
//
// The tensor maps are encoded on the host per call (the pointers change)
// with cuTensorMapEncodeTiled, taken from the driver library that the CUDA
// runtime has already loaded (dlsym), so the library links no -lcuda.  The
// entry point launches on the caller's stream, never synchronises and
// allocates nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>


namespace {

constexpr int BM = 64;                        // query rows per warpgroup
constexpr int BN = 64;                        // keys per KV tile
constexpr int PANEL = 64;                     // bf16 columns per panel
constexpr int PANEL_BYTES = 64 * PANEL * 2;   // one 64-row panel: 8 KB
constexpr int STAGES = 2;                     // K/V ring depth
constexpr int WGS = 2;                        // warpgroups a block
constexpr unsigned FULL_MASK = 0xffffffffu;

// error codes of the entry point besides cudaError_t's
constexpr int ERR_NO_ENCODER = 10001;     // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;         // a tensor map was refused
constexpr int ERR_ARGS = 10003;           // shapes or strides not taken

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the barrier's phase `parity` to complete.  A load that never
// lands (a refused box, wrong expect-tx bytes) would hang the card, so a
// wait longer than ~10 s of SM clock traps instead: the launch then fails
// with an error the caller sees.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      asm volatile("trap;");
    }
  }
}

// One TMA box of a 4-d map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address; leading byte offset, the stride between 64-column swizzle atoms
// of an MN-major operand wider than one (V at D=128: one panel, 8 KB), and
// unused by the K-major Q and K, which span one atom per k step; stride
// byte offset 1024, from one group of eight 128-byte rows to the next;
// layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x64] (+)= A[64x16] B[16x64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 2n] += A[64x16] B[16 x 2n] for an accumulator of n floats a
// thread: A in registers (bf16 pairs), B MN-major in shared memory
// (transpose bit set); at 2n = 128 B spans two swizzle atoms, LBO apart.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Issues and commits S = Q K^T for one KV tile: D/16 steps of 16 (32
// bytes inside a 128-byte panel), both operands K-major.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(q_tile + off), sw128_desc(k_tile + off), kk > 0);
  }
  fence_regs(s);
  wgmma_commit();
}

// Named barrier of one warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_barrier(int wg) {
  if (wg == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
}

// K and V tile t into ring stage `stage` (NP panels each); K completes on
// `bar`, V on the barrier STAGES slots after it.
template <int NP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t bar,
                                        uint32_t k_s, uint32_t v_s, int stage,
                                        int t, int kvh, int b) {
  const uint32_t bar_v = bar + 8 * STAGES;
  mbar_expect_tx(bar, NP * PANEL_BYTES);
  mbar_expect_tx(bar_v, NP * PANEL_BYTES);
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    tma_load(k_s + (stage * NP + p) * PANEL_BYTES, tm_k, bar, p * PANEL,
             t * BN, kvh, b);
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    tma_load(v_s + (stage * NP + p) * PANEL_BYTES, tm_v, bar_v, p * PANEL,
             t * BN, kvh, b);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block of two warpgroups: NWG query heads of one KV head (2 or 1)
// times QT = 2 / NWG consecutive 64-row q tiles; warpgroup w takes head
// w % NWG and tile w / NWG.  The bound below holds a thread to 128
// registers up to D=128, so two blocks fit on an SM; at D=256 one block
// has the SM.
//
// The accumulator fragment of m64nN (f32): thread t of the warpgroup holds
// rows r0 = 16 (t/32) + (t%32)/4 and r0 + 8; element 4j + 2i + c sits at
// row r0 + 8i, column 8j + 2 (t%4) + c.
template <int D, int NWG>
__global__ void __launch_bounds__(WGS * 128, D > 128 ? 1 : 2)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, int H, int KH,
                      int Sq, int kv_len, int causal, int window,
                      float scale_log2) {
  constexpr int QT = WGS / NWG;                 // q tiles a block
  constexpr int NP = D / PANEL;                 // panels per [64, D] tile
  constexpr int TILE_BYTES = NP * PANEL_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * STAGES + 1];  // K stages, V stages, Q
  __shared__ int released[STAGES];       // warpgroups done with a stage

  // swizzled panels must start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                           // WGS tiles
  const uint32_t k_s = q_s + WGS * TILE_BYTES;         // STAGES tiles
  const uint32_t v_s = k_s + STAGES * TILE_BYTES;      // STAGES tiles

  const int G = H / KH;
  const int ng = G / NWG;
  const int hg = blockIdx.x % ng;
  const int kvh = (blockIdx.x / ng) % KH;
  const int b = blockIdx.x / (ng * KH);
  // heaviest q tiles first: y is the slowest grid dimension
  const int qb = (gridDim.y - 1 - blockIdx.y) * QT * BM;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int h = kvh * G + hg * NWG + wg % NWG;
  const int q0 = qb + (wg / NWG) * BM;
  const bool active = q0 < Sq;       // the last block's upper tile may not

  // The KV tiles a q tile at q_start can see: [first, last).
  auto tiles = [&](int q_start, int& first, int& last) {
    int hi = kv_len;
    if (causal && q_start + BM < hi) hi = q_start + BM;
    int lo = 0;
    if (window > 0 && q_start - window + 1 > 0) lo = q_start - window + 1;
    first = lo / BN;
    last = (hi + BN - 1) / BN;
    if (last < first) last = first;
  };
  int t_lo, t_hi, own_lo, own_hi;
  tiles(qb, t_lo, own_hi);                       // the block's lowest tile
  tiles(min(qb + (QT - 1) * BM, Sq - BM), own_lo, t_hi);  // and highest
  tiles(q0, own_lo, own_hi);                     // this warpgroup's
  if (!active) own_hi = own_lo;
  const int n_tiles = t_hi > t_lo ? t_hi - t_lo : 0;

  const uint32_t bar_q = smem_u32(&bars[2 * STAGES]);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s <= 2 * STAGES; ++s) mbar_init(smem_u32(&bars[s]), 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) released[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 alone issues every TMA load
  if (tid == 0) {
    int q_tiles = 0;
    for (int t = 0; t < QT && qb + t * BM < Sq; ++t) q_tiles += NWG;
    mbar_expect_tx(bar_q, q_tiles * TILE_BYTES);
    for (int w = 0; w < q_tiles; ++w) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(q_s + (w * NP + p) * PANEL_BYTES, &tm_q, bar_q, p * PANEL,
                 qb + (w / NWG) * BM, kvh * G + hg * NWG + w % NWG, b);
      }
    }
    for (int i = 0; i < STAGES && i < n_tiles; ++i) {
      load_kv<NP>(&tm_k, &tm_v, smem_u32(&bars[i]), k_s, v_s, i, t_lo + i,
                  kvh, b);
    }
  }

  const int lane = tid % 32;
  const int r0 = ((tid % 128) / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * TILE_BYTES;

  // O: element 32 p + 4 j + 2 i + c of panel p sits at column 64 p + 8 j
  // + 2 (t%4) + c, in the m64nD fragment order, held as NCH chunks of AN
  // floats, one per P V product (m64n256 as two m64n128 at D=256)
  constexpr int AN = D > 128 ? 64 : D / 2;
  constexpr int NCH = D / 2 / AN;
  float acc[NCH][AN];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
    for (int e = 0; e < AN; ++e) acc[ch][e] = 0.f;
  }
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of l

  mbar_wait(bar_q, 0);
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % STAGES;
    const int t = t_lo + i;
    // Every warpgroup waits for every tile of the block, so that none
    // passes a stage twice before the others are done with it.
    mbar_wait(smem_u32(&bars[stage]), (i / STAGES) & 1);
    if (t < own_lo || t >= own_hi) {
      // outside this q tile's range (warpgroup-uniform): skipped, its V
      // waited for all the same
      mbar_wait(smem_u32(&bars[STAGES + stage]), (i / STAGES) & 1);
    } else {
      wgmma_fence();
      issue_qk<D>(s, q_wg, k_s + stage * TILE_BYTES);
      wgmma_wait<0>();
      fence_regs(s);

      const int k0 = t * BN;
      const bool cut = (causal && k0 + BN - 1 > q0) ||
                       (window > 0 && q0 + BM - 1 - k0 >= window) ||
                       (k0 + BN > kv_len);
      if (cut) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kpos = k0 + 8 * j + c0 + c;
              const int qpos = q0 + r0 + 8 * r;
              bool ok = kpos < kv_len;
              if (causal) ok = ok && kpos <= qpos;
              if (window > 0) ok = ok && qpos - kpos < window;
              if (!ok) s[4 * j + 2 * r + c] = -INFINITY;
            }
          }
        }
      }

      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
        const float m_new = fmaxf(m_run[r], mx * scale_log2);
        // a row with no visible key yet keeps m = -inf and gets p = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m_run[r] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * r + c;
            s[e] = ex2(fmaf(s[e], scale_log2, -m_use));
            sum += s[e];
          }
        }
        l_run[r] = l_run[r] * alpha[r] + sum;
        m_run[r] = m_new;
      }

#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
        for (int e = 0; e < AN; ++e) acc[ch][e] *= alpha[(e / 2) % 2];
      }
      // P as the A operand: k step kk holds the accumulator's columns
      // 16 kk .. 16 kk + 15, elements 8 kk .. 8 kk + 7 in order
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        }
      }

      // O += P V: four k steps of 16 keys (2 KB of each V panel), each one
      // wgmma a chunk of the output, over its 2 AN columns (chunk ch reads
      // V from panel 2 ch on)
      const uint32_t v_t = v_s + stage * TILE_BYTES;
      mbar_wait(smem_u32(&bars[STAGES + stage]), (i / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          wgmma_rs(acc[ch], pa[kk],
                   sw128_desc(v_t + ch * 2 * PANEL_BYTES + kk * 2048,
                              PANEL_BYTES));
        }
      }
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) fence_regs(acc[ch]);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) fence_regs(acc[ch]);
    }

    // This warpgroup is done reading the stage; the last of the block's
    // warpgroups to be done refills it (counts only grow: WGS a pass).
    wg_barrier(wg);
    if (tid % 128 == 0) {
      const int before = atomicAdd(&released[stage], 1);
      if ((before + 1) % WGS == 0 && i + STAGES < n_tiles) {
        load_kv<NP>(&tm_k, &tm_v, smem_u32(&bars[stage]), k_s, v_s, stage,
                    t + STAGES, kvh, b);
      }
    }
  }
  if (!active) return;

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(FULL_MASK, l, 1);
    l += __shfl_xor_sync(FULL_MASK, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  // O / l into this warpgroup's Q tile, free now, in the 128-byte-swizzled
  // panel layout of the output's tensor map; then one TMA store a panel.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 32 * p + 4 * j + 2 * r;    // chunk e / AN
        const uint32_t dst = q_wg + p * PANEL_BYTES + row * 128 +
                             ((j ^ (row & 7)) << 4) + c0 * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                     "r"(pack_bf16(acc[e / AN][e % AN] * inv[r],
                                   acc[e / AN][e % AN + 1] * inv[r]))
                     : "memory");
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_barrier(wg);
  if (tid % 128 == 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&tm_o)),
          "r"(q_wg + p * PANEL_BYTES), "r"(p * PANEL), "r"(q0), "r"(h),
          "r"(b)
          : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) {
      fn = reinterpret_cast<EncodeTiledFn>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
    }
  }
  return fn;
}

// A 4-d map over a [B, heads, S, D] bf16 view (element strides sb, sh, ss;
// D contiguous) whose box is one 64 x 64 panel, 128-byte swizzled.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B,
            int heads, int S, int D, long long sb, long long sh,
            long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {PANEL, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// D is the code's width (64, 128 or 256); d the tensors' head dim, at most
// D, which sets the softmax scale.
template <int D, int NWG>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const CUtensorMap& mo, int B, int H,
           int KH, int Sq, int d, int kv_len, int causal, int window,
           cudaStream_t stream) {
  constexpr int NP = D / PANEL;
  constexpr size_t smem = (size_t)(WGS + 2 * STAGES) * NP * PANEL_BYTES + 1024;
  // Set on every call: the attribute belongs to the current device.
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int QT = WGS / NWG;
  const dim3 grid(B * KH * ((H / KH) / NWG), (Sq / BM + QT - 1) / QT);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  flash_fwd_sm90_kernel<D, NWG><<<grid, WGS * 128, smem, stream>>>(
      mq, mk, mv, mo, H, KH, Sq, kv_len, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

// Two heads of a GQA group a block where H/KH is even, else one head over
// two q tiles.
template <int D>
int dispatch(const CUtensorMap& mq, const CUtensorMap& mk,
             const CUtensorMap& mv, const CUtensorMap& mo, int B, int H,
             int KH, int Sq, int d, int kv_len, int causal, int window,
             cudaStream_t stream) {
  if ((H / KH) % 2 == 0) {
    return launch<D, 2>(mq, mk, mv, mo, B, H, KH, Sq, d, kv_len, causal,
                        window, stream);
  }
  return launch<D, 1>(mq, mk, mv, mo, B, H, KH, Sq, d, kv_len, causal,
                      window, stream);
}

bool aligned16(long long stride_elems) { return stride_elems % 8 == 0; }

}  // namespace

extern "C" {

// q: [B,H,Sq,D] and k/v: [B,KH,Sk,D] bf16 views given by their element
// strides (batch, head, position; D contiguous; every stride and base
// address a multiple of 16 bytes); o: a contiguous [B,Sq,H,D] bf16 buffer.
// Sq and Sk are multiples of 64, D is 64, 112, 128 or 256.  Returns 0 on
// success, else a cudaError_t code or one of the ERR_ codes above.
// window <= 0 means none.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int KH, int Sq, int Sk,
                             int D, long long qsb, long long qsh,
                             long long qss, long long ksb, long long ksh,
                             long long kss, long long vsb, long long vsh,
                             long long vss, int kv_len, int causal,
                             int window, void* stream) {
  const long long strides[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  bool ok = B > 0 && H > 0 && KH > 0 && H % KH == 0 && Sq > 0 && Sk > 0 &&
            Sq % BM == 0 && Sk % BN == 0 && Sq / BM <= 65535 && kv_len >= 0 &&
            kv_len <= Sk && (D == 64 || D == 112 || D == 128 || D == 256);
  for (long long s : strides) ok = ok && aligned16(s);
  const void* ptrs[4] = {q, k, v, o};
  for (const void* p : ptrs) {
    ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  }
  if (!ok) return ERR_ARGS;
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  CUtensorMap mq, mk, mv, mo;
  const long long osh = D, oss = (long long)H * D, osb = oss * Sq;
  if (!encode(fn, &mq, q, B, H, Sq, D, qsb, qsh, qss) ||
      !encode(fn, &mk, k, B, KH, Sk, D, ksb, ksh, kss) ||
      !encode(fn, &mv, v, B, KH, Sk, D, vsb, vsh, vss) ||
      !encode(fn, &mo, o, B, H, Sq, D, osb, osh, oss)) {
    return ERR_ENCODE;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return dispatch<64>(mq, mk, mv, mo, B, H, KH, Sq, D, kv_len, causal,
                        window, s);
  }
  if (D == 256) {
    return dispatch<256>(mq, mk, mv, mo, B, H, KH, Sq, D, kv_len, causal,
                         window, s);
  }
  // D = 112 runs on the 128-column code, its second panel zero-filled
  return dispatch<128>(mq, mk, mv, mo, B, H, KH, Sq, D, kv_len, causal,
                       window, s);
}

const char* flash_attention_sm90_error_string(int code) {
  switch (code) {
    case ERR_NO_ENCODER:
      return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case ERR_ARGS:
      return "shapes, strides or alignment the kernel does not take";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
