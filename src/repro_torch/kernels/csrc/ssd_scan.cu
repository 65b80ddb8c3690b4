// Mamba2 SSD chunk scan for Hopper (sm_90a): the "simt" route, CUDA-core
// f32 products.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_kernel,
// launched by ssd_scan's pallas_call) on the "simt" route: f32 x, and bf16
// x at a P, N or chunk that ssd_scan_sm90.cu (the "sm90" route, bf16 wgmma)
// does not take; kernels/ssd_scan.py::route decides.  It computes the same
// function: per (batch b, head h), over chunks of Q rows in order, with a =
// a[h] < 0,
//     csum_j  = sum_{k <= j} dt_k a              (within the chunk)
//     y_j     = sum_{i <= j} (C_j . B_i) exp(csum_j - csum_i) dt_i x_i
//             + exp(csum_j) C_j . state
//     state  <- exp(csum_Q) state + sum_i exp(csum_Q - csum_i) dt_i x_i B_i^T
// with the [P,N] state carried in f32 from chunk to chunk, starting at 0.
// It also writes the final state of each (b, h), which the TPU kernel keeps
// in VMEM scratch and drops; the model's cache-filling prefill needs it.
//
// What bounds it.  At the serving prefill's shape (B=8, S=512, H=80, P=64,
// N=128, Q=256, x bf16) the function moves 110,362,944 bytes (x and y in
// bf16; dt, a, B, C and the final state in f32: 32.9 us at 3.35 TB/s) and
// needs 13.58 GFLOP (pairs i <= j, one C B^T per batch row and chunk, no
// C . state in the zero-state first chunk: 13.7 us at the bf16 tensor-core
// peak), so the least time is set by the bytes, 0.0329 ms
// (chip_smoke.py::ssd_work).  This design takes every product with f32 FMAs
// on the CUDA cores, as f32 parity at 2e-4 needs, each FMA fed by
// shared-memory loads, recomputes C B^T for every head (~31 GFLOP in all),
// and runs one block of 8 warps per SM (the tiles below take ~133 KB of
// shared memory): it is bound by the f32 FMA rate and shared-memory load
// issue, some 60x the bytes bound.  The bf16 route's kernel shares C B^T
// between heads and runs its products on the tensor cores.
//
// Design.  The TPU walks chunks as a sequential grid axis with the state in
// VMEM scratch; Hopper runs blocks in no order, so here one block of 256
// threads owns one (b, h) and loops over the chunks itself, with the state
// [P][N+1] in shared memory.  A chunk of Q <= 1024 rows is cut into
// sub-tiles of 64 rows: a [Q,Q] f32 score tile (256 KB at Q=256) does not
// fit a block's 227 KB.  For each query sub-tile j, the block stages C_j,
// takes the inter-chunk term from the state as of the chunk's start, then
// walks the source sub-tiles i <= j, staging B_i and dt_i x_i, scoring
// C_j B_i^T (16 x 16 threads, 4 x 4 scores each), masking i > j BEFORE the
// exponential (there csum_j - csum_i > 0 and can overflow to inf), and
// accumulating the scores times dt x into registers.  Sub-tiles above the
// diagonal are skipped.  After the last query sub-tile the state is decayed
// and each source sub-tile's contribution added in place; each thread owns
// the same state entries throughout, so no update races another.  The
// chunk's csum is a block-wide scan in f32 (warp shuffles, then the warp
// totals).  x, dt, B and C are read in the model layout ([B,S,H,P],
// [B,S,H], [B,S,N]); no transpose is needed.
//
// Layout: x/y [B,S,H,P] contiguous in f32 or bf16 (y in x's dtype), dt
// [B,S,H], a [H], B/C [B,S,N], state [B,H,P,N], all f32 and contiguous; S a
// multiple of Q (the Python adapter pads with dt = 0), P in {16,32,64,128},
// 1 <= N <= 128.  The entry point returns cudaGetLastError() after launching
// on the caller's stream; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;            // rows of a chunk sub-tile
constexpr int TS = 16;              // the block is TS x TS threads
constexpr int THREADS = TS * TS;    // 256
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TILE / TS;      // sub-tile rows (and columns) per thread
constexpr int LS = TILE + 1;        // padded row of the score tile
constexpr int MAX_N = 128;
constexpr int MAX_CHUNK = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int P, int N, int Q) {
  // St [P][N+1], Cs and Bs [TILE][N+1], Xs [TILE][P], Ss [TILE][LS],
  // csum [Q], the scan's warp totals [WARPS]
  const size_t ln = (size_t)N + 1;
  return sizeof(float) * ((size_t)P * ln + 2 * TILE * ln +
                          (size_t)TILE * P + (size_t)TILE * LS + Q + WARPS);
}

// Stage rows [s0, s0 + rows) of B or C ([B,S,N]) into a [TILE][N+1] tile.
__device__ __forceinline__ void stage_bc(float* dst, const float* src,
                                         int rows, int N) {
  const int ln = N + 1;
  for (int i = threadIdx.x; i < rows * N; i += THREADS) {
    const int r = i / N;
    dst[r * ln + (i - r * N)] = src[i];
  }
}

// Stage w_r * dt_r * x_r for rows [s0, s0 + rows) of head h into [TILE][P];
// w_r = exp(total - csum[i0 + r]) when decay_to_end, else 1.
template <typename T, int P>
__device__ __forceinline__ void stage_dx(float* dst, const T* x,
                                         const float* dt, const float* csum,
                                         size_t s0, int rows, int H, int h,
                                         int i0, float total,
                                         bool decay_to_end) {
  for (int i = threadIdx.x; i < rows * P; i += THREADS) {
    const int r = i / P;
    const int p = i - r * P;
    const size_t s = s0 + r;
    float w = dt[s * H + h];
    if (decay_to_end) w *= expf(total - csum[i0 + r]);
    dst[i] = w * to_f32(x[(s * H + h) * P + p]);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int N, int Q) {
  constexpr int CPT = P / TS;       // y columns / state rows per thread
  extern __shared__ float smem[];
  const int ln = N + 1;             // odd row length: column reads spread
  float* St = smem;                 // [P][ln] running state
  float* Cs = St + P * ln;          // [TILE][ln] C of the query sub-tile
  float* Bs = Cs + TILE * ln;       // [TILE][ln] B of a source sub-tile
  float* Xs = Bs + TILE * ln;       // [TILE][P]  dt x (times decay)
  float* Ss = Xs + TILE * P;        // [TILE][LS] masked, decayed scores
  float* csum = Ss + TILE * LS;     // [Q]
  float* wsum = csum + Q;           // [WARPS]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const int tr = tid / TS;
  const int tc = tid - tr * TS;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float ah = a[h];

  for (int i = tid; i < P * ln; i += THREADS) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t row0 = (size_t)b * S + c0;   // first (b, s) row of the chunk

    // csum over the chunk: a block-wide inclusive scan of dt * a
    float carry = 0.f;
    for (int base = 0; base < Q; base += THREADS) {
      const int k = base + tid;
      float v = k < Q ? dt[(row0 + k) * H + h] * ah : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v += t;
      }
      __syncthreads();              // earlier readers of wsum and csum done
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      float pre = carry;
      for (int w = 0; w < warp; ++w) pre += wsum[w];
      if (k < Q) csum[k] = pre + v;
      for (int w = 0; w < WARPS; ++w) carry += wsum[w];
    }
    __syncthreads();
    const float total = csum[Q - 1];

    for (int j0 = 0; j0 < Q; j0 += TILE) {
      const int nj = min(TILE, Q - j0);
      __syncthreads();              // earlier readers of Cs done
      stage_bc(Cs, cm + (row0 + j0) * N, nj, N);
      __syncthreads();

      // inter-chunk term: exp(csum_j) * (C_j . state)
      float acc[RPT][CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) cv[r] = Cs[(tr + TS * r) * ln + n];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float sv = St[(tc + TS * c) * ln + n];
#pragma unroll
          for (int r = 0; r < RPT; ++r) acc[r][c] = fmaf(cv[r], sv, acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = tr + TS * r;
        const float e = row < nj ? expf(csum[j0 + row]) : 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] *= e;
      }

      // intra-chunk term over the source sub-tiles i0 <= j0
      for (int i0 = 0; i0 <= j0; i0 += TILE) {
        const int ni = min(TILE, Q - i0);
        __syncthreads();            // earlier readers of Bs, Xs, Ss done
        stage_bc(Bs, bm + (row0 + i0) * N, ni, N);
        stage_dx<T, P>(Xs, x, dt, csum, row0 + i0, ni, H, h, i0, total,
                       false);
        __syncthreads();

        float sc[RPT][RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int c = 0; c < RPT; ++c) sc[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RPT], bv[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) cv[r] = Cs[(tr + TS * r) * ln + n];
#pragma unroll
          for (int c = 0; c < RPT; ++c) bv[c] = Bs[(tc + TS * c) * ln + n];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < RPT; ++c)
              sc[r][c] = fmaf(cv[r], bv[c], sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
#pragma unroll
          for (int c = 0; c < RPT; ++c) {
            const int row = tr + TS * r;
            const int col = tc + TS * c;
            float s = 0.f;
            if (row < nj && col < ni && i0 + col <= j0 + row) {
              s = sc[r][c] * expf(csum[j0 + row] - csum[i0 + col]);
            }
            Ss[row * LS + col] = s;
          }
        }
        __syncthreads();

        for (int k = 0; k < ni; ++k) {
          float xv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) xv[c] = Xs[k * P + tc + TS * c];
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float s = Ss[(tr + TS * r) * LS + k];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(s, xv[c], acc[r][c]);
          }
        }
      }

#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = tr + TS * r;
        if (row < nj) {
          T* yp = y + ((row0 + j0 + row) * H + h) * P;
#pragma unroll
          for (int c = 0; c < CPT; ++c) yp[tc + TS * c] = from_f32<T>(acc[r][c]);
        }
      }
    }

    // state <- exp(total) state + sum_i exp(total - csum_i) dt_i x_i B_i^T.
    // Thread (tr, tc) owns the entries p = tr + TS*q, n = tc + TS*c (+64 g).
    __syncthreads();                // every read of the old state done
    const float decay = expf(total);
    for (int g = 0; g < N; g += TILE) {
#pragma unroll
      for (int q = 0; q < CPT; ++q)
#pragma unroll
        for (int c = 0; c < RPT; ++c) {
          const int n = g + tc + TS * c;
          if (n < N) St[(tr + TS * q) * ln + n] *= decay;
        }
    }
    for (int i0 = 0; i0 < Q; i0 += TILE) {
      const int ni = min(TILE, Q - i0);
      __syncthreads();              // earlier readers of Bs and Xs done
      stage_bc(Bs, bm + (row0 + i0) * N, ni, N);
      stage_dx<T, P>(Xs, x, dt, csum, row0 + i0, ni, H, h, i0, total, true);
      __syncthreads();
      for (int g = 0; g < N; g += TILE) {
        float su[CPT][RPT];
#pragma unroll
        for (int q = 0; q < CPT; ++q)
#pragma unroll
          for (int c = 0; c < RPT; ++c) su[q][c] = 0.f;
        for (int k = 0; k < ni; ++k) {
          float xv[CPT], bv[RPT];
#pragma unroll
          for (int q = 0; q < CPT; ++q) xv[q] = Xs[k * P + tr + TS * q];
#pragma unroll
          for (int c = 0; c < RPT; ++c) {
            const int n = g + tc + TS * c;
            bv[c] = n < N ? Bs[k * ln + n] : 0.f;
          }
#pragma unroll
          for (int q = 0; q < CPT; ++q)
#pragma unroll
            for (int c = 0; c < RPT; ++c)
              su[q][c] = fmaf(xv[q], bv[c], su[q][c]);
        }
#pragma unroll
        for (int q = 0; q < CPT; ++q)
#pragma unroll
          for (int c = 0; c < RPT; ++c) {
            const int n = g + tc + TS * c;
            if (n < N) St[(tr + TS * q) * ln + n] += su[q][c];
          }
      }
    }
  }

  __syncthreads();
  float* so = state_out + (size_t)bh * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N;
    so[i] = St[p * ln + (i - p * N)];
  }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H, int N,
           int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, Q);
  // Set on every call: the attribute belongs to the current device.
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<T, P><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, void* y, void* state, int B, int S, int H,
             int P, int N, int Q, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 16>(x, dt, a, bm, cm, y, state, B, S, H, N, Q, stream);
    case 32:
      return launch<T, 32>(x, dt, a, bm, cm, y, state, B, S, H, N, Q, stream);
    case 64:
      return launch<T, 64>(x, dt, a, bm, cm, y, state, B, S, H, N, Q, stream);
    case 128:
      return launch<T, 128>(x, dt, a, bm, cm, y, state, B, S, H, N, Q,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* state, int B, int S, int H,
                 int P, int N, int Q, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N < 1 || N > MAX_N || Q < 1 ||
      Q > MAX_CHUNK || S % Q != 0 || (long long)B * H > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, B, S, H, P, N,
                                   Q, s);
  }
  return dispatch<float>(x, dt, a, bm, cm, y, state, B, S, H, P, N, Q, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
