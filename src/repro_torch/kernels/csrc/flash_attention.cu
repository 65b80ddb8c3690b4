// Flash attention forward for Hopper (sm_90a), CUDA-core f32 products: the
// "simt" route (causal, sliding-window, GQA).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention's pallas_call) on the "simt"
// route: f32 at every head dim, and bf16 at D=32 (kernels/flash_attention.py
// ::route decides; bf16 at D 64/112/128/256 goes to flash_attention_sm90.cu).
// It computes the same function: softmax(q k^T / sqrt(D) + mask) v with the
// mask k <= q (causal) and q - k < window, an online softmax that keeps the
// running max m, sum l and accumulator in f32, and the KV head h / (H/KH).
// It also hides keys at positions >= kv_len, so zero padding added by the
// caller is never attended (the TPU kernel relies on causality for that).
//
// What bounds it.  f32 parity at 2e-5 (the reference's limit) leaves no room
// for bf16 or TF32 products, so both products are f32 FMAs on the CUDA
// cores, and the least time is the operations at 67 TFLOP/s: at zamba2's
// prefill (B=8, S=512, H=KH=32, D=112, causal) 15.1 GFLOP, 0.2248 ms, where
// the bytes (f32 q, k, v, o) take 0.0351 ms.  A CUDA-core product reaches
// the FMA rate only when each shared-memory load feeds several FMAs from
// registers, as in an SGEMM.  What holds this design back is shared-memory
// traffic and latency: the f32 tiles allow two blocks (8 or 16 warps) an
// SM, and the 8-row tile takes ~254 registers a thread.
//
// Design.
// - Register micro-tiles.  A block owns 64 query rows and walks 64-key
//   tiles.  Thread (ty, tx) of a 16-lane-wide grid owns TM rows (8; 4 at
//   D=112 and D=256) and the keys tx + 16j (j < 4) of S = Q K^T, and the
//   same rows x the column groups 4(tx + 16g) of O: a step of 4 along D
//   reads TM Q rows and 4 K rows as float4 (16 TM FMAs for TM + 4 loads), a
//   key of P V TM/4 float4s of P and D/64 float4s of V.  Q rows swap their
//   16-byte chunks in pairs on every other row group; f32 K rows of a
//   multiple of 8 chunks are XOR-swizzled by row % 8, other K rows padded
//   by one chunk; the probability tile is kept transposed (P^T [key][row])
//   and padded; so the vector reads and writes are free of bank conflicts,
//   and each swizzle is one per-thread constant.  D=112 runs the P V
//   product on 128 columns, the last 16 zero in shared memory.
// - Overlapped staging.  Q, K and V move by 16-byte cp.async.  K of tile
//   t+1 is issued as soon as S of tile t is formed and lands under the
//   softmax and P V; V of tile t+1 is issued after P V and lands under the
//   next Q K^T (issuing later, with two barriers a tile instead of four,
//   measured slower).  So one K and one V buffer overlap loads with
//   compute, where a double buffer of each would add 64 x (KLD + DP)
//   floats: 73 KB at D=32 (three blocks still), 97 KB at D=64 (two, not
//   three), 167 / 177 KB at D=112 / 128 (one, not two), 337 KB at D=256
//   (over the 227 KB a block may take).  bf16 inputs stay bf16 in shared
//   memory and are converted at use.
// - GQA packing.  A block's 64 rows are the (position, head) pairs of one
//   KV head's group in position-major order (row R: position R / G, head
//   kvh G + R % G), so each K/V tile is staged once for the whole group
//   (gemma-2b's MQA: 8 positions x 8 heads a block) and any group size packs
//   without padding.
// - The online softmax in f32, the scale folded into the scores in log2
//   units (exp2 of s log2(e)/sqrt(D) - m).  Each row's max is reduced over
//   its 16 lanes by shuffles every tile; each lane keeps its own partial sum
//   l, reduced once at the end.  A row whose keys are all hidden keeps
//   m = -inf, l = 0 and acc = 0 and writes 0.  The masks (causal, window,
//   k_pos >= kv_len) are evaluated only on tiles that cut them.  Tiles above
//   the diagonal or outside the window are never visited, the q tiles are
//   issued heaviest (last) first, and within a tile each warp forms scores
//   and P V only for the keys its own rows can see (the diagonal and the
//   ragged end; under GQA packing most of a block's last tile).
// - Shared memory (f32; bf16 halves Q, K, V): Q 64 x D, K 64 x D, V 64 x
//   max(64, D rounded to 64), P^T 64 x 68.  D=32: 49 KB, D=64: 65 KB,
//   D=112: 106 KB, D=128: 113 KB, D=256: 209 KB.  Up to D=128 two blocks
//   share an SM (three at D <= 64); D=256 runs one block an SM.
//
// Layout: q [B,H,Sq,D], k/v [B,KH,Sk,D], o [B,H,Sq,D], all contiguous and
// 16-byte aligned, Sq and Sk multiples of 64 (the Python adapter pads), D in
// {32,64,112,128,256}, f32 or bf16.  The entry point returns
// cudaGetLastError() after launching on the caller's stream; it never
// synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // packed query rows a block
constexpr int BN = 64;             // keys a KV tile
constexpr int TX = 16;             // lanes along keys / O column groups
constexpr int TN = BN / TX;        // keys a thread: 4
constexpr int PLD = BM + 4;        // floats a key's row of P^T (padded)
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block's shape and the shared-memory layout of its tiles, for elements
// of T and head dim D.  Offsets are in elements; g4 indexes groups of 4
// elements (the unit of every vector read), ch the 16-byte chunks cp.async
// writes.
template <typename T, int D>
struct Tiles {
  // rows a thread: 8 (128 threads), or 4 (256 threads) at D=112, where the
  // wider block measured faster, and at D=256, whose 8-row tile would not
  // fit the registers
  static constexpr int TM = D == 112 || D > 128 ? 4 : 8;
  static constexpr int TY = BM / TM;             // lanes along rows
  static constexpr int THREADS = TX * TY;        // 128, or 256 at D=256
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : D <= 128 ? 2 : 1;
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int GPC = EPC / 4;              // groups a chunk
  static constexpr int CHUNKS = D / EPC;           // chunks a row
  // P V runs on D rounded up to 64 columns, at least 64 (16 lanes x 4); V's
  // columns from D on are zero in shared memory.
  static constexpr int DP = D <= 64 ? 64 : (D + 63) / 64 * 64;
  static constexpr int NG = DP / (4 * TX);       // O column groups a thread
  // Q rows are unpadded; a thread's TM rows and the next thread's (the other
  // half of its warp) would share banks, so the chunks of every other group
  // of TM rows are swapped in pairs (XOR 1).  K rows of f32 with a multiple
  // of 8 chunks are XOR-swizzled by row % 8, so the 8 rows a quarter-warp
  // reads at one column fall on 8 bank groups; other K rows are padded by
  // one chunk (an odd number of chunks for f32 D=112).
  static constexpr bool K_SWIZZLE = sizeof(T) == 4 && CHUNKS % 8 == 0;
  static constexpr int KLD = K_SWIZZLE ? D : D + EPC;
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t)(BM * D + BN * KLD + BN * DP) +
           sizeof(float) * (size_t)(BN * PLD);
  }
  // in-row offset of group g4 of a Q row whose tile-row group has parity qx
  __device__ static int q_off(int g4, int qx) {
    return ((g4 / GPC) ^ qx) * EPC + (g4 % GPC) * 4;
  }
  __device__ static int q_chunk(int r, int ch) {
    return r * D + (ch ^ ((r / TM) & 1)) * EPC;
  }
  // in-row offset of group g4 of a K row with r % 8 == kx
  __device__ static int k_off(int g4, int kx) {
    return K_SWIZZLE ? (g4 ^ kx) << 2 : g4 << 2;
  }
  __device__ static int k_chunk(int r, int ch) {
    return K_SWIZZLE ? r * D + ((ch ^ (r & 7)) << 2) : r * KLD + ch * EPC;
  }
};

// S = Q K^T for a thread's TM rows and its first JN keys (tx + 16 j).
template <typename T, int D, int JN>
__device__ __forceinline__ void score_tile(
    float (&s)[Tiles<T, D>::TM][TN], const T* qs, const T* ks, int qx,
    int kx) {
  using L = Tiles<T, D>;
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int g4 = 0; g4 < D / 4; ++g4) {
    float4 kv[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) kv[j] = load4(ks + TX * j * L::KLD + L::k_off(g4, kx));
    const int qo = L::q_off(g4, qx);
#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      const float4 qv = load4(qs + i * D + qo);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
        s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
        s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
        s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tiles<T, D>::THREADS,
                                  Tiles<T, D>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Sq, int Sk, int kv_len, int causal, int window,
                 float scale_log2) {
  using L = Tiles<T, D>;
  constexpr int TM = L::TM;
  constexpr int THREADS = L::THREADS;
  constexpr int DP = L::DP;
  constexpr int NG = L::NG;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BM * D;
  T* Vs = Ks + BN * L::KLD;
  float* Pt = reinterpret_cast<float*>(Vs + BN * DP);

  const int G = H / KH;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bk = blockIdx.y;                  // b * KH + kv head
  const int b = bk / KH;
  const int kvh = bk - b * KH;
  const int r0 = qt * BM;                     // first packed row
  const int pos_lo = r0 / G;
  const int pos_hi = (r0 + BM - 1) / G;
  const T* kp = k + (size_t)bk * Sk * D;
  const T* vp = v + (size_t)bk * Sk * D;

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;
  const int warp = tid >> 5;                  // rows 2 warp TM .. + 2 TM

  // The KV tiles this block's rows can see (block-uniform bounds), and the
  // keys this warp's rows can see (warp-uniform).
  int kv_hi = kv_len < Sk ? kv_len : Sk;
  int warp_hi = kv_hi;
  if (causal) {
    const int wpos = (r0 + 2 * (warp + 1) * TM - 1) / G;
    if (pos_hi + 1 < kv_hi) kv_hi = pos_hi + 1;
    if (wpos + 1 < warp_hi) warp_hi = wpos + 1;
  }
  int kv_lo = 0;
  if (window > 0 && pos_lo - window + 1 > 0) kv_lo = pos_lo - window + 1;
  const int t_lo = kv_lo / BN;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + BN - 1) / BN : t_lo;

  for (int i = tid; i < BM * L::CHUNKS; i += THREADS) {
    const int r = i / L::CHUNKS;
    const int ch = i - r * L::CHUNKS;
    const int row = r0 + r;
    const int pos = row / G;
    const int h = kvh * G + (row - pos * G);
    cp_async16(Qs + L::q_chunk(r, ch),
               q + (((size_t)b * H + h) * Sq + pos) * D + ch * L::EPC);
  }
  auto stage_k = [&](int t) {
    const T* src = kp + (size_t)t * BN * D;
    for (int i = tid; i < BN * L::CHUNKS; i += THREADS) {
      const int r = i / L::CHUNKS;
      const int ch = i - r * L::CHUNKS;
      cp_async16(Ks + L::k_chunk(r, ch), src + r * D + ch * L::EPC);
    }
  };
  auto stage_v = [&](int t) {
    const T* src = vp + (size_t)t * BN * D;
    for (int i = tid; i < BN * L::CHUNKS; i += THREADS) {
      const int r = i / L::CHUNKS;
      const int ch = i - r * L::CHUNKS;
      cp_async16(Vs + r * DP + ch * L::EPC, src + r * D + ch * L::EPC);
    }
  };
  if (t_lo < t_hi) stage_k(t_lo);
  cp_async_commit();                          // group: Q and K of t_lo
  if (t_lo < t_hi) stage_v(t_lo);
  cp_async_commit();                          // group: V of t_lo
  if constexpr (DP > D) {                     // V's zero columns
    for (int i = tid; i < BN * (DP - D); i += THREADS) {
      const int r = i / (DP - D);
      Vs[r * DP + D + (i - r * (DP - D))] = T(0.f);
    }
  }

  const T* qs = Qs + ty * TM * D;
  const T* ks = Ks + tx * L::KLD;
  const int qx = ty & 1;
  const int kx = tx & 7;
  int qpos[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) qpos[i] = (r0 + ty * TM + i) / G;

  float acc[TM][4 * NG];
  float m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BN;
    // keys k0 .. k0 + kw - 1 are all this warp's rows can see in the tile
    const int kw = min(BN, warp_hi - k0);
    cp_async_wait<1>();                       // Q and K of tile t are in
    __syncthreads();

    float s[TM][TN];
    switch (kw <= 0 ? 0 : (kw + TX - 1) / TX) {
      case 4: score_tile<T, D, 4>(s, qs, ks, qx, kx); break;
      case 3: score_tile<T, D, 3>(s, qs, ks, qx, kx); break;
      case 2: score_tile<T, D, 2>(s, qs, ks, qx, kx); break;
      case 1: score_tile<T, D, 1>(s, qs, ks, qx, kx); break;
      default:                                // no key of the tile
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    }
    __syncthreads();                          // every read of K is done
    if (t + 1 < t_hi) stage_k(t + 1);         // lands under softmax, P V
    cp_async_commit();

    // A tile no mask cuts skips the per-score tests; keys from kw on are
    // hidden from every row of the warp, so their unformed scores are masked.
    const bool whole = k0 + BN <= kv_len &&
                       (!causal || k0 + BN - 1 <= pos_lo) &&
                       (window <= 0 || pos_hi - k0 < window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = s[i][j] * scale_log2;
        if (!whole) {
          const int kpos = k0 + tx + TX * j;
          bool ok = kpos < kv_len;
          if (causal) ok = ok && kpos <= qpos[i];
          if (window > 0) ok = ok && qpos[i] - kpos < window;
          x = ok ? x : -INFINITY;
        }
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, off));
      const float m_new = fmaxf(m[i], mt);
      // A row that has seen no visible key keeps m = -inf, l = 0, acc = 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        ls += s[i][j];
      }
      l[i] = l[i] * alpha + ls;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float* pt = Pt + (tx + TX * j) * PLD + ty * TM;
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        store4(pt + i, make_float4(s[i][j], s[i + 1][j], s[i + 2][j],
                                   s[i + 3][j]));
      }
    }
    cp_async_wait<1>();                       // V of tile t is in
    __syncthreads();                          // and every P^T write

    const float* pt = Pt + ty * TM;
    const T* vs = Vs + 4 * tx;
#pragma unroll 4
    for (int c = 0; c < kw; ++c) {
      float pr[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 p4 = load4(pt + c * PLD + i);
        pr[i] = p4.x;
        pr[i + 1] = p4.y;
        pr[i + 2] = p4.z;
        pr[i + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv = load4(vs + c * DP + 4 * TX * g);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][4 * g + 0] = fmaf(pr[i], vv.x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(pr[i], vv.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(pr[i], vv.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(pr[i], vv.w, acc[i][4 * g + 3]);
        }
      }
    }
    __syncthreads();                          // every read of V and P^T
    if (t + 1 < t_hi) stage_v(t + 1);         // lands under the next S
    cp_async_commit();
  }
  cp_async_wait<0>();                         // Q when no tile was visited

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < TX; off <<= 1)
      lt += __shfl_xor_sync(FULL_MASK, lt, off);
    const float denom = fmaxf(lt, 1e-30f);
    const int row = r0 + ty * TM + i;
    const int h = kvh * G + (row - qpos[i] * G);
    T* orow = o + (((size_t)b * H + h) * Sq + qpos[i]) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = 4 * (tx + TX * g);
      if (col < D) {
        store4(orow + col, make_float4(acc[i][4 * g] / denom,
                                       acc[i][4 * g + 1] / denom,
                                       acc[i][4 * g + 2] / denom,
                                       acc[i][4 * g + 3] / denom));
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int kv_len, int causal, int window,
           cudaStream_t stream) {
  using L = Tiles<T, D>;
  constexpr size_t smem = L::smem_bytes();
  // MIN_BLOCKS blocks an SM: 228 KB, 1 KB of it reserved a block
  static_assert(L::MIN_BLOCKS * (smem + 1024) <= 233472,
                "the tiles no longer fit MIN_BLOCKS blocks an SM");
  // Set on every call: the attributes belong to the current device.  The
  // whole carveout goes to shared memory, so two blocks of up to 113 KB fit.
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((H / KH) * (Sq / BM), B * KH);
  const float scale_log2 = LOG2E / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<grid, L::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, kv_len,
      causal, window, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KH, int Sq, int Sk, int D, int kv_len, int causal,
             int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, causal,
                           window, stream);
    case 112:
      return launch<T, 112>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, causal,
                            window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KH, Sq, Sk, kv_len, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  window <= 0 means none.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KH, int Sq, int Sk, int D,
                        int kv_len, int causal, int window, int is_bf16,
                        void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq % BM != 0 ||
      Sk % BN != 0 || Sq <= 0 || Sk <= 0 || kv_len < 0 || kv_len > Sk ||
      (long long)B * KH > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) &
      15) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D, kv_len,
                                   causal, window, s);
  }
  return dispatch<float>(q, k, v, o, B, H, KH, Sq, Sk, D, kv_len, causal,
                         window, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
