// Mamba2 SSD chunk scan for Hopper (sm_90a): the "simt" route, CUDA-core
// f32 products.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (_ssd_kernel,
// launched by ssd_scan's pallas_call) on the "simt" route: f32 x, and bf16
// x at a P, N or chunk that ssd_scan_sm90.cu (the "sm90" route, bf16 wgmma)
// does not take; kernels/ssd_scan.py::route decides.  It computes the same
// function: per (batch b, head h), over the sequence in order, with a =
// a[h] < 0,
//     csum_j  = sum_{k <= j} dt_k a              (within a block of rows)
//     y_j     = sum_{i <= j} (C_j . B_i) exp(csum_j - csum_i) dt_i x_i
//             + exp(csum_j) C_j . state
//     state  <- exp(csum_end) state + sum_i exp(csum_end - csum_i) dt_i x_i B_i^T
// with the [P,N] state carried in f32 from the first row to the last,
// starting at 0, and written at the end ([B,H,P,N] f32; the TPU kernel keeps
// it in VMEM scratch and drops it, the model's cache-filling prefill needs
// it).
//
// What bounds it.  f32 parity at 2e-4 (y and the state) leaves no room for
// bf16 or TF32 products, so every product is an f32 FMA on the CUDA cores
// and the least time is the operations at 67 TFLOP/s.  The result does not
// depend on the blocking, so the bound counts the least work over every
// blocking of the sequence (chip_smoke.py::ssd_least_flops), which is the
// plain recurrence's, a blocking of one row: at mamba2's prefill (B=8,
// S=512, H=80, P=64, N=128) 10,769,924,096 FLOP, 0.1607 ms, where its bytes
// take 0.0580 ms with f32 x (0.0329 with bf16 x); zamba2's (H=112, N=64)
// 7,568,097,280 FLOP, 0.1130 ms (bytes 0.0757).  The reference's blocking
// (chunk 256) counts 13,577,486,336 / 13,250,068,480 FLOP, this kernel's
// 32-row steps 11,111,235,584 / 8,258,846,720.
// What holds this design back: at N=128 the state and the step's operands
// exceed the 128 registers a thread that two blocks an SM allow, so ptxas
// spills, and mamba2's 320 blocks take 1.21 waves of the 264 that fit.
//
// Design.
// - Steps of 32 rows.  The chunk only fixes how the reference blocks the
//   work; the recurrence gives the same y and state for any blocking, so
//   the block walks the sequence in order in steps of T = 32 rows, whatever
//   the chunk, with the state at each step's start (zero at the first step,
//   whose C . state term is skipped).  The intra-step term costs ~T P a row
//   and C B^T ~T N a row; C . state and the state update 2 N P a row each,
//   whatever the step.  A partial last step is zero-filled (dt = 0 decays by
//   1 and injects nothing) and its rows are not written.
// - C B^T once for a group of heads.  A block owns one batch row and two
//   heads (or one head of P=128, split in two halves of 64 rows of the
//   state): 256 threads, one unit of 128 threads a head (or half).  The
//   block forms the step's [32,32] C B^T tile once (2 x 2 outputs a thread,
//   float4 reads), applies each head's decay exp(csum_j - csum_i) and dt_i,
//   masking i > j BEFORE the exponential (there csum_j - csum_i > 0 and can
//   overflow), and writes each head's scores to shared memory.
// - The state in registers.  A unit's [64, N] slice of the state (P < 64
//   zero-padded to 64 rows, N padded to 64 or 128 columns) is 64 or 32
//   registers a thread: thread (pg, ng) owns rows 4pg..4pg+3 and columns
//   32c + 4ng + e.  The update adds sum_i (w_i x_i) B_i^T from float4 reads
//   of x and B (16 FMAs a load); C . state is reduced over the 8 lanes of a
//   row group by shuffles, two rows j at a time (7 shuffles for 256 FMAs at
//   N=128), leaving lane (pg, ng) with y at row 2m + (ng & 1) and state row
//   4pg + 2((ng >> 2) & 1) + ((ng >> 1) & 1); the intra-step term adds the
//   scores times x from float4 reads of the scores.
// - Prefetch.  C, B, x and dt of step k+1 move by cp.async (16 bytes; 4
//   for dt) into the second of two buffers while step k computes.  bf16 x stays bf16 in shared memory and
//   is converted at use.  csum is a warp scan in f32, in log2 units, run by
//   every warp for both heads; exponentials are exp2.
// - Shared memory: two buffers of C and B (32 x (N+4) f32 each), x (2 x 32
//   x 64) and dt, and the scores (2 x 32 x 36 f32): 107.5 KB at N=128 with
//   f32 x, 75.5 KB at N=64, so two blocks share an SM
//   (__launch_bounds__(256, 2)).
//
// Layout: x/y [B,S,H,P] contiguous in f32 or bf16 (y in x's dtype), dt
// [B,S,H], a [H], B/C [B,S,N], state [B,H,P,N], all f32 and contiguous; x,
// B and C 16-byte aligned; S a multiple of the chunk Q (the Python adapter
// pads with dt = 0; the kernel does not depend on Q), P in {16,32,64,128},
// N a multiple of 4 up to 128 (the wrapper pads B and C with zero columns
// and cuts the state back).  The entry point returns cudaGetLastError() after launching
// on the caller's stream; it never synchronises and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int T = 32;               // rows a step
constexpr int UNITS = 2;            // units a block: two heads, or two halves
constexpr int UT = 128;             // threads a unit
constexpr int THREADS = UNITS * UT; // 256
constexpr int PS = 64;              // state rows a unit
constexpr int SC_LD = 36;           // floats a row i of the scores: 2 x 16 + 4
constexpr int MAX_N = 128;
constexpr int MAX_CHUNK = 1024;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T_>
__device__ __forceinline__ T_ from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// cp.async of 16 (or 4, for dt) bytes, the rest of the destination
// zero-filled: src_bytes = 0 reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One buffer of a step's inputs: C and B [T][NP+4] f32, x [UNITS][T][PS] in
// x's type, dt [2][T] f32.
template <typename TX, int NP>
struct StepBuffer {
  static constexpr int LD = NP + 4;   // an odd number of 16-byte chunks
  static constexpr size_t C_BYTES = sizeof(float) * T * LD;
  static constexpr size_t X_BYTES = sizeof(TX) * UNITS * T * PS;
  static constexpr size_t BYTES = 2 * C_BYTES + X_BYTES + sizeof(float) * 2 * T;
  unsigned char* base;
  __device__ float* c() const { return reinterpret_cast<float*>(base); }
  __device__ float* b() const {
    return reinterpret_cast<float*>(base + C_BYTES);
  }
  __device__ TX* x() const {
    return reinterpret_cast<TX*>(base + 2 * C_BYTES);
  }
  __device__ float* dt() const {
    return reinterpret_cast<float*>(base + 2 * C_BYTES + X_BYTES);
  }
};

template <typename TX, int NP>
constexpr size_t smem_bytes() {
  return 2 * StepBuffer<TX, NP>::BYTES + sizeof(float) * 2 * T * SC_LD;
}

template <typename TX, int NP>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, TX* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N) {
  constexpr int NC = NP / 32;         // 32-column panels of a thread's state
  constexpr int LD = StepBuffer<TX, NP>::LD;
  constexpr int XE = 16 / (int)sizeof(TX);   // x elements a 16-byte chunk
  constexpr int XCH = PS / XE;               // chunks of a unit's x row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto buffer = [&](int step) {     // step k's inputs: buffer k % 2
    return StepBuffer<TX, NP>{smem_raw +
                              (step & 1) * StepBuffer<TX, NP>::BYTES};
  };
  float* sc_all = reinterpret_cast<float*>(smem_raw +
                                           2 * StepBuffer<TX, NP>::BYTES);

  const int heads = P > PS ? 1 : 2;   // heads a block
  const int h0 = blockIdx.x * heads;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int u = tid / UT;
  const int ut = tid - u * UT;
  const int pg = ut >> 3;             // state rows 4pg .. 4pg+3 of the unit
  const int ng = ut & 7;              // state columns 32c + 4ng + e
  const int slot = heads == 2 ? u : 0;        // the unit's head slot
  const int h_u = h0 + slot;
  const int p0 = heads == 1 ? PS * u : 0;     // the unit's first row of P
  const int prow = P < PS ? P : PS;           // state rows a unit holds
  const bool unit_ok = h_u < H;

  float a2[2];                        // a of each head slot, in log2 units
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
    a2[hs] = hs < heads && h0 + hs < H ? a[h0 + hs] * LOG2E : 0.f;
  }

  auto stage = [&](int step) {
    const StepBuffer<TX, NP> buf = buffer(step);
    const int s0 = step * T;
    const size_t row0 = (size_t)b * S + s0;
    constexpr int CPR = NP / 4;       // 16-byte chunks a row of B or C
    for (int i = tid; i < 2 * T * CPR; i += THREADS) {
      const int which = i / (T * CPR);
      const int rem = i - which * T * CPR;
      const int r = rem / CPR;
      const int n = 4 * (rem - r * CPR);
      const bool ok = s0 + r < S && n < N;
      const float* src = which ? bm : cm;
      cp_async16((which ? buf.b() : buf.c()) + r * LD + n,
                 ok ? src + (row0 + r) * N + n : src, ok ? 16 : 0);
    }
    for (int i = tid; i < UNITS * T * XCH; i += THREADS) {
      const int uu = i / (T * XCH);
      const int rem = i - uu * T * XCH;
      const int r = rem / XCH;
      const int p = XE * (rem - r * XCH);
      const int hh = h0 + (heads == 2 ? uu : 0);
      const int pp = (heads == 1 ? PS * uu : 0) + p;
      const bool ok = s0 + r < S && hh < H && p < prow;
      cp_async16(buf.x() + (uu * T + r) * PS + p,
                 ok ? x + ((row0 + r) * H + hh) * P + pp : x, ok ? 16 : 0);
    }
    for (int i = tid; i < 2 * T; i += THREADS) {
      const int hs = i / T;
      const int r = i - hs * T;
      const bool ok = s0 + r < S && hs < heads && h0 + hs < H;
      cp_async4(buf.dt() + i, ok ? dt + (row0 + r) * H + h0 + hs : dt,
                ok ? 4 : 0);
    }
  };

  float st[4][NC][4];                 // the unit's state, f32, from zero
#pragma unroll
  for (int pi = 0; pi < 4; ++pi)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[pi][c][e] = 0.f;

  const int b0 = ng & 1;
  const int b1 = (ng >> 1) & 1;
  const int b2 = (ng >> 2) & 1;
  const int pl = 4 * pg + 2 * b2 + b1;   // the state row of this lane's y
  const int jt = tid >> 4;               // C B^T rows jt, jt + 16
  const int it = tid & 15;               // C B^T columns it, it + 16
  const int n4 = (N + 3) >> 2;
  float* sc_u = sc_all + slot * T * SC_LD;

  const int nsteps = (S + T - 1) / T;
  stage(0);
  cp_async_commit();
  for (int step = 0; step < nsteps; ++step) {
    const StepBuffer<TX, NP> buf = buffer(step);
    const int s0 = step * T;
    cp_async_wait_all();              // this step's inputs are in
    __syncthreads();                  // and every read of the last step done
    if (step + 1 < nsteps) stage(step + 1);
    cp_async_commit();
    const float* cmat = buf.c();
    const float* bmat = buf.b();
    const TX* xs = buf.x() + u * T * PS;

    // csum of both head slots over the step (lane r: row r), log2 units
    float cs[2], dtl[2];
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      dtl[hs] = buf.dt()[hs * T + lane];
      float v = dtl[hs] * a2[hs];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL_MASK, v, off);
        if (lane >= off) v += t;
      }
      cs[hs] = v;
    }
    const float cs_u = slot ? cs[1] : cs[0];
    const float tot = __shfl_sync(FULL_MASK, cs_u, T - 1);
    const float e_lane = exp2f(cs_u);                          // row j = lane
    const float w_lane = exp2f(tot - cs_u) * (slot ? dtl[1] : dtl[0]);

    // C B^T of the step, once for both head slots
    float cb[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int g4 = 0; g4 < n4; ++g4) {
      const float4 c0 = load4(cmat + jt * LD + 4 * g4);
      const float4 c1 = load4(cmat + (jt + 16) * LD + 4 * g4);
      const float4 q0 = load4(bmat + it * LD + 4 * g4);
      const float4 q1 = load4(bmat + (it + 16) * LD + 4 * g4);
      cb[0][0] += c0.x * q0.x + c0.y * q0.y + c0.z * q0.z + c0.w * q0.w;
      cb[0][1] += c0.x * q1.x + c0.y * q1.y + c0.z * q1.z + c0.w * q1.w;
      cb[1][0] += c1.x * q0.x + c1.y * q0.y + c1.z * q0.z + c1.w * q0.w;
      cb[1][1] += c1.x * q1.x + c1.y * q1.y + c1.z * q1.z + c1.w * q1.w;
    }
    // each head's scores (C_j . B_i) exp(csum_j - csum_i) dt_i, i <= j,
    // masked before the exponential; stored [i][j & 1][j >> 1]
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
#pragma unroll
      for (int aa = 0; aa < 2; ++aa)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const int j = jt + 16 * aa;
          const int i = it + 16 * bb;
          const float csj = __shfl_sync(FULL_MASK, cs[hs], j);
          const float csi = __shfl_sync(FULL_MASK, cs[hs], i);
          const float dti = __shfl_sync(FULL_MASK, dtl[hs], i);
          const float arg = i <= j ? csj - csi : -INFINITY;
          if (hs < heads) {
            sc_all[(hs * T + i) * SC_LD + 16 * (j & 1) + (j >> 1)] =
                i <= j ? cb[aa][bb] * exp2f(arg) * dti : 0.f;
          }
        }
    }
    __syncthreads();                  // the scores are in

    // y of the step in two halves of 16 rows (8 values a lane live at once)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // C . state from the state at the step's start, two rows j a time,
      // reduced over the row group's 8 lanes
      float yv[T / 4];
      if (s0 > 0) {
#pragma unroll
        for (int mm = 0; mm < T / 4; ++mm) {
          const int j = 16 * hh + 2 * mm;
          float part[4][2];
#pragma unroll
          for (int pi = 0; pi < 4; ++pi) part[pi][0] = part[pi][1] = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 c0 = load4(cmat + j * LD + 32 * c + 4 * ng);
            const float4 c1 = load4(cmat + (j + 1) * LD + 32 * c + 4 * ng);
#pragma unroll
            for (int pi = 0; pi < 4; ++pi) {
              part[pi][0] = fmaf(c0.x, st[pi][c][0], part[pi][0]);
              part[pi][0] = fmaf(c0.y, st[pi][c][1], part[pi][0]);
              part[pi][0] = fmaf(c0.z, st[pi][c][2], part[pi][0]);
              part[pi][0] = fmaf(c0.w, st[pi][c][3], part[pi][0]);
              part[pi][1] = fmaf(c1.x, st[pi][c][0], part[pi][1]);
              part[pi][1] = fmaf(c1.y, st[pi][c][1], part[pi][1]);
              part[pi][1] = fmaf(c1.z, st[pi][c][2], part[pi][1]);
              part[pi][1] = fmaf(c1.w, st[pi][c][3], part[pi][1]);
            }
          }
          // lanes ng ^ 4 split the rows pi, ng ^ 2 the pair left, ng ^ 1 j
          float k4[2][2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const float keep = b2 ? part[2 + r][jj] : part[r][jj];
              const float send = b2 ? part[r][jj] : part[2 + r][jj];
              k4[r][jj] = keep + __shfl_xor_sync(FULL_MASK, send, 4);
            }
          float k2[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float keep = b1 ? k4[1][jj] : k4[0][jj];
            const float send = b1 ? k4[0][jj] : k4[1][jj];
            k2[jj] = keep + __shfl_xor_sync(FULL_MASK, send, 2);
          }
          const float keep = b0 ? k2[1] : k2[0];
          const float send = b0 ? k2[0] : k2[1];
          yv[mm] = (keep + __shfl_xor_sync(FULL_MASK, send, 1)) *
                   __shfl_sync(FULL_MASK, e_lane, j + b0);
        }
      } else {
#pragma unroll
        for (int mm = 0; mm < T / 4; ++mm) yv[mm] = 0.f;   // zero state
      }

      // the intra-step term: source rows i of a block of 8 reach rows
      // j >= 8 ib, the float4s qq >= ib of a score row
#pragma unroll
      for (int ib = 0; ib < 2 * hh + 2; ++ib) {
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int i = 8 * ib + ii;
          const float xi = to_f32(xs[i * PS + pl]);
          const float* srow = sc_u + i * SC_LD + 16 * b0;
#pragma unroll
          for (int qq = (ib > 2 * hh ? ib : 2 * hh); qq < 2 * hh + 2; ++qq) {
            const float4 sv = load4(srow + 4 * qq);
            float* yq = yv + 4 * (qq - 2 * hh);
            yq[0] = fmaf(sv.x, xi, yq[0]);
            yq[1] = fmaf(sv.y, xi, yq[1]);
            yq[2] = fmaf(sv.z, xi, yq[2]);
            yq[3] = fmaf(sv.w, xi, yq[3]);
          }
        }
      }
      if (unit_ok && pl < prow) {
        TX* yp = y + ((size_t)b * S * H + h_u) * P + p0 + pl;
#pragma unroll
        for (int mm = 0; mm < T / 4; ++mm) {
          const int s = s0 + 16 * hh + 2 * mm + b0;
          if (s < S) yp[(size_t)s * H * P] = from_f32<TX>(yv[mm]);
        }
      }
    }

    // state <- exp(csum_end) state + sum_i (exp(csum_end - csum_i) dt_i x_i)
    // B_i^T
    const float decay = exp2f(tot);
#pragma unroll
    for (int pi = 0; pi < 4; ++pi)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[pi][c][e] *= decay;
#pragma unroll 4
    for (int i = 0; i < T; ++i) {
      const float wi = __shfl_sync(FULL_MASK, w_lane, i);
      const float4 xv = load4(xs + i * PS + 4 * pg);
      const float wx[4] = {wi * xv.x, wi * xv.y, wi * xv.z, wi * xv.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 bv = load4(bmat + i * LD + 32 * c + 4 * ng);
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          st[pi][c][0] = fmaf(wx[pi], bv.x, st[pi][c][0]);
          st[pi][c][1] = fmaf(wx[pi], bv.y, st[pi][c][1]);
          st[pi][c][2] = fmaf(wx[pi], bv.z, st[pi][c][2]);
          st[pi][c][3] = fmaf(wx[pi], bv.w, st[pi][c][3]);
        }
      }
    }
  }
  cp_async_wait_all();

  if (unit_ok) {
    float* so = state_out + (((size_t)b * H + h_u) * P + p0) * N;
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      const int p = 4 * pg + pi;
      if (p >= prow) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 32 * c + 4 * ng + e;
          if (n < N) so[(size_t)p * N + n] = st[pi][c][e];
        }
    }
  }
}

template <typename TX, int NP>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int B, int S, int H, int P,
           int N, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TX, NP>();
  // two blocks an SM: 228 KB, 1 KB of it reserved a block
  static_assert(2 * (smem + 1024) <= 233472,
                "the buffers no longer fit two blocks an SM");
  // Set on every call: the attribute belongs to the current device.
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<TX, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int heads = P > PS ? 1 : 2;
  const dim3 grid((H + heads - 1) / heads, B);
  ssd_scan_kernel<TX, NP><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<TX*>(y),
      static_cast<float*>(state), S, H, P, N);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, void* y, void* state, int B, int S, int H,
             int P, int N, cudaStream_t stream) {
  if (N <= 64) {
    return launch<TX, 64>(x, dt, a, bm, cm, y, state, B, S, H, P, N, stream);
  }
  return launch<TX, 128>(x, dt, a, bm, cm, y, state, B, S, H, P, N, stream);
}

}  // namespace

extern "C" {

// Returns 0 on success, else a cudaError_t code.  The chunk Q is checked
// (S a multiple of it, 1 <= Q <= 1024) but does not change the result.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* state, int B, int S, int H,
                 int P, int N, int Q, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || N < 1 || N > MAX_N || Q < 1 ||
      Q > MAX_CHUNK || S % Q != 0 || B > 65535 || N % 4 != 0 ||
      (P != 16 && P != 32 && P != 64 && P != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
       reinterpret_cast<uintptr_t>(cm)) & 15) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, B, S, H, P, N,
                                   s);
  }
  return dispatch<float>(x, dt, a, bm, cm, y, state, B, S, H, P, N, s);
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
