// Flash attention forward for Hopper (sm_90a): causal, sliding-window, GQA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention's pallas_call).  It computes
// the same function: softmax(q k^T / sqrt(D) + mask) v with the mask
// k <= q (causal) and q - k < window, an online softmax that keeps the
// running max m, sum l and accumulator in f32, and the KV head h / (H/KH).
// It also hides keys at positions >= kv_len, so zero padding added by the
// caller is never attended (the TPU kernel relies on causality for that).
//
// What bounds it.  At the serving path's prefill shape (B=8, S=512, H=16,
// KH=8, D=128, bf16, causal) the function moves ~50 MB and does ~8.6 GFLOP,
// so on an H100 the least time is set by the bytes (~15 us at 3.35 TB/s);
// the products alone would take ~9 us on the bf16 tensor cores.  This first
// design does not reach that: it upcasts every tile to f32 in shared memory
// and takes both products with f32 FMAs on the CUDA cores (as the TPU
// kernel does in f32), each FMA fed by about one shared-memory load.  So it
// is bound by shared-memory load issue and the f32 FMA rate, not by device
// memory.  The next step is bf16 wgmma with TMA-fed, double-buffered K/V.
//
// Design.  The TPU kernel walks KV blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch; Hopper runs blocks in no order, so here the
// KV walk is a loop inside the block.  One block per (q tile of 64 rows,
// b*h); 256 threads, four per query row.  Each KV tile of 64 keys is staged
// in shared memory; each thread scores 16 keys of its row, the four threads
// of a row (adjacent lanes) combine max and sum with shuffles, and each
// thread accumulates D/4 output columns in registers.  Only the KV tiles a
// q tile can see are visited: tiles above the diagonal and tiles wholly
// outside the window are skipped.  Q tiles are issued last-first so the
// heaviest causal tiles start first.
//
// Layout: q [B,H,Sq,D], k/v [B,KH,Sk,D], o [B,H,Sq,D], all contiguous,
// Sq and Sk multiples of 64 (the Python adapter pads), D in
// {32,64,112,128,256} (each thread owns D/4 output columns),
// f32 or bf16.  The entry point returns cudaGetLastError() after launching
// on the caller's stream; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // keys per KV tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr int COLS = BK / TPR;     // scores per thread per tile
constexpr int LP = BK + 1;         // padded row of the probability tile
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

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], all f32
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * LP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                 int Sq, int Sk, int kv_len, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;        // padded: column reads are conflict-free
  constexpr int DPT = D / TPR;     // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KH);
  const int q0 = qt * BQ;

  const T* qp = q + ((size_t)bh * Sq + q0) * D;
  const T* kp = k + (size_t)(b * KH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KH + kvh) * Sk * D;
  T* op = o + ((size_t)bh * Sq + q0) * D;

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid - row * TPR;
  const int qpos = q0 + row;

  for (int i = tid; i < BQ * D; i += THREADS) {
    Qs[(i / D) * LD + (i % D)] = to_f32(qp[i]);
  }

  // The KV tiles this q tile can see (block-uniform bounds).
  int kv_hi = kv_len < Sk ? kv_len : Sk;
  if (causal && q0 + BQ < kv_hi) kv_hi = q0 + BQ;
  int kv_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_lo = q0 - window + 1;
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_hi + BK - 1) / BK;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    const T* kt = kp + (size_t)k0 * D;
    const T* vt = vp + (size_t)k0 * D;
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D;
      const int c = i - r * D;
      Ks[r * LD + c] = to_f32(kt[i]);
      Vs[r * D + c] = to_f32(vt[i]);
    }
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) s[j] = 0.f;
    const float* qrow = Qs + row * LD;
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[j] = fmaf(qd, Ks[(sub + TPR * j) * LD + d], s[j]);
      }
    }

    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int kpos = k0 + sub + TPR * j;
      bool ok = kpos < kv_len;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && (qpos - kpos) < window;
      s[j] = ok ? s[j] * scale : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(FULL_MASK, mt, 2));
    const float m_new = fmaxf(m, mt);
    // A row that has seen no visible key keeps m = -inf, l = 0, acc = 0.
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      Ps[row * LP + sub + TPR * j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(FULL_MASK, ls, 1);
    ls += __shfl_xor_sync(FULL_MASK, ls, 2);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // a row's four threads share one warp

#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[j] *= alpha;
    const float* prow = Ps + row * LP;
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vr = Vs + c * D + sub;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] = fmaf(p, vr[TPR * j], acc[j]);
    }
  }

  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    op[(size_t)row * D + sub + TPR * j] = from_f32<T>(acc[j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int kv_len, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Set on every call: the attribute belongs to the current device.
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Sq / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)D);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk, kv_len,
      causal, window, scale);
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
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq % BQ != 0 ||
      Sk % BK != 0 || Sq <= 0 || Sk <= 0 || kv_len < 0 || kv_len > Sk ||
      B * H > 65535) {
    return (int)cudaErrorInvalidValue;
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
