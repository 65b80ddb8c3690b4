// Mamba2's one-token selective state update for Hopper (sm_90a), in place.
//
// Replaces no TPU kernel: the reference's decode step
// (src/repro/models/ssm.py::ssm_decode_step) is plain jnp, left to XLA.
// Added because the port's plain decode step made about nine passes over
// the [B,H,P,N] f32 state (the outer product, the decay's multiply, the
// add, the y contraction, the copy back into the cache) and ran at about
// six times its bytes bound.  Per batch row b and head h, with
// dt1 = softplus(dt[b,h] + dt_bias[h]) and a = -exp(A_log[h]):
//     decay        = exp(dt1 a)
//     state[p,n]  <- state[p,n] decay + (dt1 x[p]) B[n]      (in place)
//     y[p]         = sum_n state[p,n] C[n] + D[h] x[p]
// all in f32 whatever the inputs' dtype.  The state update multiplies and
// adds unfused (__fmul_rn, __fadd_rn), in the plain version's order; only
// y's sum over N is taken in another order than the plain version's GEMV.
//
// What bounds it.  About 0.6 FLOP a byte against the card's ~295 in bf16:
// the bytes.  The least is one read and one write of the state (and the
// small inputs once): at decode_chat's step (B=64, H=80, P=64, N=128) 335.6
// MB a layer, 0.100 ms at 3.35 TB/s.
//
// Design.
// - One block per (batch row, head, tile of P rows), 256 threads.  A
//   state row is N/4 threads, one float4 each (16-byte loads and stores,
//   neighbouring threads on neighbouring addresses); a sweep of the block
//   covers 1024/N consecutive rows (4 KB) and each thread takes ITEMS
//   sweeps, so the tile is ITEMS * 1024 / N rows (32 at N=128, 64 at 64,
//   256 at 16) and the last tile of a head is masked.
// - Each thread issues its ITEMS state loads before any arithmetic, so
//   ITEMS x 16 bytes a thread are in flight.  The state streams through
//   once a step (10.7 GB at B=64, far beyond the 50 MB L2): loads and
//   stores carry the evict-first hint (ld/st.global.cs).
// - B and C of the thread's four columns, x of its rows, and the (b,h)
//   scalars (dt1, decay, D) are read once into registers; the scalars are
//   computed by every thread, which costs three exponentials.
// - y's sum over N: four FMAs a thread, then a butterfly of warp shuffles
//   over the row's N/4 lanes (5, 4 or 2 steps); no atomics, so the result
//   is the same every run.
//
// Layout: state [B,H,P,N] f32, contiguous and 16-byte aligned, updated in
// place; x [B,H,P] with rows of the batch x_stride elements apart and heads
// P apart; dt [B,H] with rows dt_stride apart; dt_bias, A_log and D [H];
// B and C [B,N] with rows b_stride and c_stride apart; x, dt, dt_bias,
// A_log, D, B and C in one dtype (f32 or bf16); y [B,H,P] f32, contiguous.
// N in {16, 64, 128} (a template parameter).  The entry point returns
// cudaGetLastError() after launching on the caller's stream; it never
// synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;            // state rows a thread
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float SOFTPLUS_THRESHOLD = 20.f;   // torch.nn.functional.softplus

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 mul_add(float4 s, float decay, float u,
                                          const float* bv) {
  s.x = __fadd_rn(__fmul_rn(s.x, decay), __fmul_rn(u, bv[0]));
  s.y = __fadd_rn(__fmul_rn(s.y, decay), __fmul_rn(u, bv[1]));
  s.z = __fadd_rn(__fmul_rn(s.z, decay), __fmul_rn(u, bv[2]));
  s.w = __fadd_rn(__fmul_rn(s.w, decay), __fmul_rn(u, bv[3]));
  return s;
}

template <typename TX, int N>
__global__ void __launch_bounds__(THREADS)
ssm_state_update_kernel(float* __restrict__ state, const TX* __restrict__ x,
                        const TX* __restrict__ dt,
                        const TX* __restrict__ dt_bias,
                        const TX* __restrict__ a_log,
                        const TX* __restrict__ d, const TX* __restrict__ bm,
                        const TX* __restrict__ cm, float* __restrict__ y,
                        int H, int P, int tiles, int x_stride, int dt_stride,
                        int b_stride, int c_stride) {
  constexpr int LANES = N / 4;              // threads a state row
  constexpr int ROWS = THREADS / LANES;     // rows a sweep
  constexpr int TILE = ROWS * ITEMS;        // rows a block
  static_assert(N % 4 == 0 && 32 % LANES == 0, "a row within a warp");

  const int bh = blockIdx.x / tiles;
  const int tile = blockIdx.x - bh * tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int col = 4 * (threadIdx.x % LANES);
  const int row0 = tile * TILE + threadIdx.x / LANES;

  const float v = to_f32(dt[(size_t)b * dt_stride + h]) + to_f32(dt_bias[h]);
  const float dt1 = v > SOFTPLUS_THRESHOLD ? v : log1pf(expf(v));
  const float a = -expf(to_f32(a_log[h]));
  const float decay = expf(__fmul_rn(dt1, a));
  const float dd = to_f32(d[h]);

  float bv[4], cv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    bv[e] = to_f32(bm[(size_t)b * b_stride + col + e]);
    cv[e] = to_f32(cm[(size_t)b * c_stride + col + e]);
  }

  float* sbase = state + (size_t)bh * P * N + col;
  const TX* xrow = x + (size_t)b * x_stride + (size_t)h * P;
  float4 s[ITEMS];
  float xs[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = row0 + k * ROWS;
    if (p < P) {
      s[k] = __ldcs(reinterpret_cast<const float4*>(sbase + (size_t)p * N));
      xs[k] = to_f32(xrow[p]);
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = row0 + k * ROWS;
    float part = 0.f;
    if (p < P) {
      s[k] = mul_add(s[k], decay, __fmul_rn(dt1, xs[k]), bv);
      __stcs(reinterpret_cast<float4*>(sbase + (size_t)p * N), s[k]);
      part = fmaf(s[k].w, cv[3], fmaf(s[k].z, cv[2],
                  fmaf(s[k].y, cv[1], s[k].x * cv[0])));
    }
    // a row's lanes are all in range or all out of it, but every lane of
    // the warp takes part in the shuffles
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(FULL_MASK, part, off);
    if (p < P && col == 0)
      y[(size_t)bh * P + p] = part + __fmul_rn(dd, xs[k]);
  }
}

template <typename TX, int N>
int launch(void* state, const void* x, const void* dt, const void* dt_bias,
           const void* a_log, const void* d, const void* bm, const void* cm,
           void* y, int B, int H, int P, int x_stride, int dt_stride,
           int b_stride, int c_stride, cudaStream_t stream) {
  constexpr int TILE = THREADS / (N / 4) * ITEMS;
  const int tiles = (P + TILE - 1) / TILE;
  const long long blocks = (long long)B * H * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssm_state_update_kernel<TX, N><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<float*>(state), static_cast<const TX*>(x),
      static_cast<const TX*>(dt), static_cast<const TX*>(dt_bias),
      static_cast<const TX*>(a_log), static_cast<const TX*>(d),
      static_cast<const TX*>(bm), static_cast<const TX*>(cm),
      static_cast<float*>(y), H, P, tiles, x_stride, dt_stride, b_stride,
      c_stride);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch(void* state, const void* x, const void* dt, const void* dt_bias,
             const void* a_log, const void* d, const void* bm,
             const void* cm, void* y, int B, int H, int P, int N,
             int x_stride, int dt_stride, int b_stride, int c_stride,
             cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<TX, 16>(state, x, dt, dt_bias, a_log, d, bm, cm, y, B,
                            H, P, x_stride, dt_stride, b_stride, c_stride, s);
    case 64:
      return launch<TX, 64>(state, x, dt, dt_bias, a_log, d, bm, cm, y, B,
                            H, P, x_stride, dt_stride, b_stride, c_stride, s);
    case 128:
      return launch<TX, 128>(state, x, dt, dt_bias, a_log, d, bm, cm, y, B,
                             H, P, x_stride, dt_stride, b_stride, c_stride,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.
int ssm_state_update_fwd(void* state, const void* x, const void* dt,
                         const void* dt_bias, const void* a_log,
                         const void* d, const void* bm, const void* cm,
                         void* y, int B, int H, int P, int N, int x_stride,
                         int dt_stride, int b_stride, int c_stride,
                         int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || x_stride < 0 || dt_stride < 0 ||
      b_stride < 0 || c_stride < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(state) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(state, x, dt, dt_bias, a_log, d, bm, cm,
                                   y, B, H, P, N, x_stride, dt_stride,
                                   b_stride, c_stride, s);
  }
  return dispatch<float>(state, x, dt, dt_bias, a_log, d, bm, cm, y, B, H, P,
                         N, x_stride, dt_stride, b_stride, c_stride, s);
}

const char* ssm_state_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
