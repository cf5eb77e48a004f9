// One fused MRF round of the iSTFTNet generator, for Hopper (sm_90a), on the
// tensor cores with wgmma in 3xTF32 (f32-accurate).
//
// Replaces styletts2_tpu/ops/pallas/mrf_round_kernel.py::fused_mrf_round
// (body _round_kernel).  For every (b, c_out, t):
//
//   u   = (1 + gamma) * ((x - mean) * rstd) + beta          AdaIN, given stats
//   a   = u + sin(alpha*u)^2 / alpha                         Snake, 0 outside [0, T)
//   y   = bias + sum_{ci,k} w[co,ci,k] * a[ci, t + k*d - pad]  (+ residual)
//
// and per 64-frame tile partials (S1, M2 around the tile mean, n) of y over
// the frames t < min(lengths[b], T), which the wrapper combines with Chan's
// rule into the next round's (mean, rstd).  Values in [lengths, T) are
// computed, not zeroed: only the statistics are masked, as on the TPU.
//
// What bounds it.  The conv is 2*C^2*K FLOP per output frame and moves
// ~12 bytes per frame and channel (x, residual, y), ~230 FLOP per byte at
// C=128, K=11: bound by operations.  On the f32 CUDA cores (67 TFLOP/s) the
// batched serving call's 48 rounds (7.65 TFLOP) need 114 ms.  TF32 tensor
// cores run at 495 TFLOP/s, but TF32 keeps 11 significant bits: a 1408-term
// sum would be ~3e-4 of |y| off, above the 1e-4 gate.  So each operand is
// split, a = hi + lo with hi = tf32(a) and lo = tf32(a - hi) (by truncation,
// within 2^-20 |a|: tf32_wgmma.cuh), and the three products lo*hi, hi*lo and
// hi*hi are accumulated in f32: near-f32 results at a third of the TF32
// rate, a 46 ms floor for that call.
//
// The design.  An implicit GEMM per block of two warpgroups (one for narrow
// stages, below): M = 64 output channels per warpgroup, N = NT frames (64,
// 128 or 256),
// reduced over the input channels in chunks of 8 (one k8 step) and over the
// K taps, all into the same accumulators.
// - Form: wgmma.mma_async m64nNTk8 TF32, A = the weights from registers,
//   B = the activation from shared memory.  TF32 wgmma needs both operands
//   K-major (C_in contiguous).  The activation is kept as [4-channel half]
//   [frame][4 channels], 16 bytes per frame, so that in the no-swizzle
//   layout core matrix j (frames 8j..8j+7) starts 128*j bytes in: tap k, a
//   shift of k*d frames, is the descriptor's start address plus 16*k*d
//   bytes, at any shift.  The weights need no shift; each lane loads its
//   four A values per tap from [k][co][8 ci] in shared memory (the two
//   16-byte halves swapped on bit 2 of co, so the loads hit 32 banks).
// - The split: A is split in registers as it is loaded; B is split once, when
//   the activation is made, into a hi and a lo plane (wgmma reads B only
//   from shared memory).  The planes add 12 KB a stage at NT = 128; the
//   weights, 45 KB a stage at K = 11, stay f32 once.
// - One activation per element: a block covers 128 output channels, all of
//   them at stage 1 (C=128) and half at stage 0 (C=256), so the AdaIN + Snake
//   prologue with its full-precision sinf runs once (stage 1) or twice
//   (stage 0) per (b, ci, t), against 2-4x in the SIMT kernel before it.
// - Overlap: per chunk, every thread loads and splits its A fragments for
//   all K taps and the warpgroup issues its 3K wgmmas at once; while the
//   tensor cores run them, the block activates the next chunk (its raw x and
//   weights already landed by cp.async) into the other plane buffer and
//   issues the cp.async copies of the chunk after.  Two stages of planes and
//   weights, one of raw x.
// - Epilogue: the accumulators go through shared memory ([co][t], float2
//   stores at a stride = 8 (mod 32) words), the residual tile is added with
//   all its loads in flight at once, and each warp walks whole rows along t:
//   bias, coalesced stores of y, and each 64-frame tile's S1 and centred M2
//   by warp shuffles.
// - Grid: (T / NT, C_out / CO_TILE, B).  NT is the widest of 256, 128 and
//   64 that still gives at least one block per SM: 256 halves the weight
//   traffic from L2 (every block streams all C_in x K weights of its
//   channels), 64 doubles the blocks of the small batch-1 rounds (stage 0 at
//   frame capacity 200: 126 blocks on 132 SMs).
// - Narrow stages (the HiFi-GAN's 64 and 32 channels).  A block is WG
//   warpgroups, CO_TILE = 64 * WG output channels: WG = 2 where C_out is a
//   multiple of 128, else WG = 1, one warpgroup of 128 threads per 64
//   channels.  Where C_out is not a multiple of 64 (32), the last block's
//   missing weight rows are zeros (cp.async zero-fill) and the epilogue
//   skips their rows: wgmma's M is 64 at the least, so C_out 32 runs twice
//   the products it needs.  That stage is bound by bytes at
//   (4, 32, 960000) (10.6 ms of bytes against 9.2 of 3xTF32 products), so
//   the padding costs at most about the products' time again; swapping the
//   operands (frames on M, 32 channels on N) would avoid it at the price of
//   a second operand layout, which this simple form leaves for later.  At
//   C_in = C_out <= 64 the activation still runs once per element.
//
// The bf16 form (mrf_round_bf16, the TPU kernel run on bf16 x_pad, w and
// residual: mrf_round_kernel.py:95-160).  x, w, residual and y are bf16; the
// statistics, the AdaIN/Snake plane and bias stay f32, as pack_plane makes
// them.  AdaIN -> Snake runs in f32 with the full-precision sinf and is
// rounded to bf16 (RNE) as it is stored for the tensor cores; wgmma
// m64nNk16 bf16 multiplies it by the bf16 weights with f32 accumulators, one
// product per pair (no split); bias and residual are added in f32, y is
// rounded to bf16, and the partials are taken from the rounded y, as the TPU
// kernel takes them from the stored value.  It keeps the f32 form's grid,
// tiling, two-stage pipeline and epilogue.  A chunk is 16 input channels
// (one k16 step), kept as [8-channel half][frame][8 channels], 16 bytes a
// frame as in the TF32 planes, so a tap is still a descriptor offset of
// 16*k*d bytes; the weights are staged [k][co][16 ci] with the same half
// swap.  It moves half the f32 form's bytes and runs its products at the
// card's bf16 rate (989 TFLOP/s dense against 495/3 for 3xTF32): the
// batched serving rounds become bound by bytes at C <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace {

constexpr int CI_CHUNK = 8;    // input channels per stage: one k8 step
constexpr int MAX_PAD = 32;    // (K*d - d)/2 <= 25 for K <= 11, d <= 5
constexpr int STAT_TILE = 64;  // frames per tile of the partials

template <int NT, int K, int WG>
struct Tile {
  static constexpr int THREADS = 128 * WG;          // WG warpgroups
  static constexpr int CO_TILE = 64 * WG;           // output channels, 64 per warpgroup
  static constexpr int ROW = NT + 2 * MAX_PAD;      // frames of x staged per channel
  static constexpr int RAW_STRIDE = ROW + 4;        // = 4 (mod 32) words
  static constexpr int RAW = CI_CHUNK * RAW_STRIDE;
  static constexpr int HALF = 4 * ROW + 16;         // one 4-channel half; = 16 (mod 32)
  static constexpr int PLANES = 4 * HALF;           // hi (two halves), then lo
  static constexpr int STAGE = PLANES + K * CO_TILE * CI_CHUNK;
  static constexpr int Y_STRIDE = NT + 8;           // = 8 (mod 32) words
  static constexpr int MAIN = RAW + 2 * STAGE;
  static constexpr int EPILOGUE = CO_TILE * Y_STRIDE;
  static constexpr int BYTES = 4 * (MAIN > EPILOGUE ? MAIN : EPILOGUE);
  static constexpr int ACC = NT / 2;                // accumulators per thread
  static_assert(RAW_STRIDE % 32 == 4 && HALF % 32 == 16 && Y_STRIDE % 32 == 8,
                "bank-conflict strides");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NT, int K, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
mrf_round_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ alpha,
                 const float* __restrict__ wt, const float* __restrict__ bias,
                 const int* __restrict__ lengths, const float* __restrict__ residual,
                 float* __restrict__ y, float* __restrict__ parts, int c_in, int c_out, int t,
                 int d, int vec_x) {
  using L = Tile<NT, K, WG>;
  constexpr int THREADS = L::THREADS;
  constexpr int CO_TILE = L::CO_TILE;
  extern __shared__ __align__(128) float smem[];
  float* raw = smem;                  // raw x of the next chunk
  float* stages = smem + L::RAW;      // 2 x (hi/lo planes, weights)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * NT;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (K * d - d) / 2;
  const int n_chunks = c_in / CI_CHUNK;

  // Raw x of channels [ci0, ci0 + 8) over frames [t0 - MAX_PAD, t0 + NT + MAX_PAD)
  // into `raw`, and the weights (k, co0 + co, ci0 .. ci0 + 7) into `ws`.
  auto load = [&](int chunk, float* ws) {
    const int ci0 = chunk * CI_CHUNK;
    const float* xb = x + ((size_t)b * c_in + ci0) * t;
    const int p0 = t0 - MAX_PAD;
    if (vec_x) {  // t % 4 == 0 and p0 % 4 == 0: each 4-frame vector is all in or all out
      constexpr int V = L::ROW / 4;
      for (int i = tid; i < CI_CHUNK * V; i += THREADS) {
        const int r = i / V;
        const int v = i - r * V;
        const int p = p0 + 4 * v;
        const bool ok = p >= 0 && p < t;
        tf32::cp_async16(raw + r * L::RAW_STRIDE + 4 * v, ok ? xb + (size_t)r * t + p : x, ok);
      }
    } else {
      for (int i = tid; i < CI_CHUNK * L::ROW; i += THREADS) {
        const int r = i / L::ROW;
        const int s = i - r * L::ROW;
        const int p = p0 + s;
        const bool ok = p >= 0 && p < t;
        tf32::cp_async4(raw + r * L::RAW_STRIDE + s, ok ? xb + (size_t)r * t + p : x, ok);
      }
    }
    for (int i = tid; i < K * CO_TILE * 2; i += THREADS) {
      const int h = i & 1;
      const int row = i >> 1;  // k * CO_TILE + co
      const int co = row % CO_TILE;
      const int kk = row / CO_TILE;
      const bool ok = co0 + co < c_out;  // rows past C_out (C_out 32) are zeros
      const float* src = ok ? wt + ((size_t)kk * c_out + co0 + co) * c_in + ci0 + 4 * h : wt;
      tf32::cp_async16(ws + row * CI_CHUNK + 4 * (h ^ ((co >> 2) & 1)), src, ok);
    }
    tf32::cp_async_commit();
  };

  // AdaIN + Snake of `raw` into the hi and lo planes over the frames the taps
  // read; 0 outside [0, T).  Plane row s holds 4 channels in 16 bytes.
  auto activate = [&](int chunk, float* planes) {
    const int r = tid & 7;  // one channel per thread
    const int ci = chunk * CI_CHUNK + r;
    const int bc = b * c_in + ci;
    const float g1 = 1.f + gamma[bc], mu = mean[bc], rs = rstd[bc], be = beta[bc];
    const float al = alpha[ci];
    const float* rw = raw + r * L::RAW_STRIDE;
    float* hi = planes + (r >> 2) * L::HALF + (r & 3);
    const int s0 = MAX_PAD - pad;
    for (int j = tid >> 3; j < NT + 2 * pad; j += THREADS / 8) {
      const int s = s0 + j;
      const int p = t0 - MAX_PAD + s;
      float a = 0.f;
      if (p >= 0 && p < t) {
        const float u = g1 * ((rw[s] - mu) * rs) + be;
        const float sn = sinf(al * u);  // full-precision sine: |alpha*u| is unbounded
        a = u + sn * sn / al;
      }
      uint32_t h, l;
      tf32::split(a, h, l);
      hi[4 * s] = __uint_as_float(h);
      hi[4 * s + 2 * L::HALF] = __uint_as_float(l);
    }
    tf32::fence_proxy_async();  // the planes are read by wgmma
  };

  float acc[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) acc[i] = 0.f;

  load(0, stages + L::PLANES);
  tf32::cp_async_wait<0>();
  __syncthreads();
  activate(0, stages);
  __syncthreads();
  if (n_chunks > 1) load(1, stages + L::STAGE + L::PLANES);

  // this lane's rows of A: output channels g and g + 8 of its warp's 16
  const int g = lane >> 2;
  const int q = lane & 3;
  const int sw = 4 * ((g >> 2) & 1);  // where channel q lies after the half swap
  const int a_row = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  for (int c = 0; c < n_chunks; ++c) {
    const float* planes = stages + (c & 1) * L::STAGE;
    const float* wrow = planes + L::PLANES + a_row * CI_CHUNK;
    const uint32_t hi_addr = static_cast<uint32_t>(__cvta_generic_to_shared(planes));
    const uint32_t lo_addr = hi_addr + 4 * 2 * L::HALF;
    uint32_t a_hi[K][4], a_lo[K][4];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float* wk = wrow + kk * CO_TILE * CI_CHUNK;
      tf32::split(wk[sw + q], a_hi[kk][0], a_lo[kk][0]);
      tf32::split(wk[8 * CI_CHUNK + sw + q], a_hi[kk][1], a_lo[kk][1]);
      tf32::split(wk[(4 - sw) + q], a_hi[kk][2], a_lo[kk][2]);
      tf32::split(wk[8 * CI_CHUNK + (4 - sw) + q], a_hi[kk][3], a_lo[kk][3]);
    }
    tf32::fence_operands(acc);
    tf32::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      // B rows start at frame t0 + kk*d - pad: plane row MAX_PAD - pad + kk*d
      const uint32_t shift = 16u * static_cast<uint32_t>(MAX_PAD - pad + kk * d);
      const uint64_t b_hi = tf32::desc(hi_addr + shift, 4 * L::HALF, 128);
      const uint64_t b_lo = tf32::desc(lo_addr + shift, 4 * L::HALF, 128);
      tf32::mma<NT>(acc, a_lo[kk], b_hi);  // smallest products first
      tf32::mma<NT>(acc, a_hi[kk], b_lo);
      tf32::mma<NT>(acc, a_hi[kk], b_hi);
    }
    tf32::wgmma_commit();
    // while the tensor cores run chunk c: activate chunk c + 1, load c + 2
    if (c + 1 < n_chunks) {
      tf32::cp_async_wait<0>();
      __syncthreads();
      activate(c + 1, stages + ((c + 1) & 1) * L::STAGE);
      __syncthreads();  // raw is free; the weights of chunk c are in registers
      if (c + 2 < n_chunks) load(c + 2, stages + (c & 1) * L::STAGE + L::PLANES);
    }
    tf32::wgmma_wait<0>();
    tf32::fence_operands(acc);
  }

  // accumulators -> ys[co][t] (the stages are free once every warp is here)
  __syncthreads();
  float* ys = smem;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    *reinterpret_cast<float2*>(ys + a_row * L::Y_STRIDE + 8 * i + 2 * q) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(ys + (a_row + 8) * L::Y_STRIDE + 8 * i + 2 * q) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  if (residual != nullptr) {  // the residual tile, with every load in flight at once
    constexpr int PER = CO_TILE * NT / THREADS;
    float rv[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int n = i / NT;
      const int tt = t0 + (i - n * NT);
      rv[j] = tt < t && co0 + n < c_out
                  ? __ldg(residual + ((size_t)b * c_out + co0 + n) * t + tt) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int n = i / NT;
      ys[n * L::Y_STRIDE + (i - n * NT)] += rv[j];
    }
    __syncthreads();
  }

  // bias, coalesced store; partials over the valid frames of each 64-frame tile
  const int len = min(lengths[b], t);
  const int n_stat = (t + STAT_TILE - 1) / STAT_TILE;
  for (int n = warp; n < CO_TILE && co0 + n < c_out; n += THREADS / 32) {
    const int co = co0 + n;
    const float bv = bias[co];
    const size_t row = ((size_t)b * c_out + co) * t;
#pragma unroll
    for (int sub = 0; sub < NT / STAT_TILE; ++sub) {
      const int tile = blockIdx.x * (NT / STAT_TILE) + sub;
      if (tile >= n_stat) break;
      float v[2];
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tl = sub * STAT_TILE + lane + 32 * j;
        const int tt = t0 + tl;
        v[j] = ys[n * L::Y_STRIDE + tl] + bv;
        if (tt < t) y[row + tt] = v[j];
        if (tt < len) s1 += v[j];
      }
      s1 = warp_sum(s1);
      const int n_valid = max(0, min(len - tile * STAT_TILE, STAT_TILE));
      const float mu = s1 / fmaxf((float)n_valid, 1.f);
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dv = v[j] - mu;
        if (t0 + sub * STAT_TILE + lane + 32 * j < len) m2 += dv * dv;
      }
      m2 = warp_sum(m2);
      if (lane == 0) {
        float* pp = parts + ((size_t)b * n_stat + tile) * 3 * c_out + co;
        pp[0] = s1;
        pp[c_out] = m2;
        pp[2 * c_out] = (float)n_valid;
      }
    }
  }
}

constexpr int CI_CHUNK_BF16 = 16;  // input channels per stage of the bf16 form: one k16 step

template <int NT, int K, int WG>
struct TileBf16 {
  static constexpr int THREADS = 128 * WG;
  static constexpr int CO_TILE = 64 * WG;
  static constexpr int ROW = NT + 2 * MAX_PAD;           // frames of x staged per channel
  static constexpr int RAW_STRIDE = ROW + 8;             // bf16; rows of whole 16 bytes
  static constexpr int RAW_BYTES = CI_CHUNK_BF16 * RAW_STRIDE * 2;
  static constexpr int HALF_BYTES = 16 * ROW + 64;       // one 8-channel half, 16 bytes a frame
  static constexpr int PLANE_BYTES = 2 * HALF_BYTES;
  static constexpr int STAGE_BYTES = PLANE_BYTES + K * CO_TILE * 32;  // + weights [k][co][16 ci]
  static constexpr int Y_STRIDE = NT + 8;                // = 8 (mod 32) words
  static constexpr int MAIN = RAW_BYTES + 2 * STAGE_BYTES;
  static constexpr int EPILOGUE = 4 * CO_TILE * Y_STRIDE;
  static constexpr int BYTES = MAIN > EPILOGUE ? MAIN : EPILOGUE;
  static constexpr int ACC = NT / 2;                     // accumulators per thread
  static_assert(RAW_BYTES % 128 == 0 && HALF_BYTES % 16 == 0, "16-byte aligned stages");
};

template <int NT, int K, int WG>
__global__ void __launch_bounds__(128 * WG, 1)
mrf_round_bf16_kernel(const uint16_t* __restrict__ x, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const float* __restrict__ alpha,
                      const uint16_t* __restrict__ wt, const float* __restrict__ bias,
                      const int* __restrict__ lengths, const uint16_t* __restrict__ residual,
                      uint16_t* __restrict__ y, float* __restrict__ parts, int c_in, int c_out,
                      int t, int d, int vec_x) {
  using L = TileBf16<NT, K, WG>;
  constexpr int THREADS = L::THREADS;
  constexpr int CO_TILE = L::CO_TILE;
  extern __shared__ __align__(128) unsigned char smem_b[];
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem_b);  // raw x of the next chunk
  unsigned char* stages = smem_b + L::RAW_BYTES;         // 2 x (planes, weights)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * NT;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (K * d - d) / 2;
  const int n_chunks = c_in / CI_CHUNK_BF16;

  // Raw x of channels [ci0, ci0 + 16) over frames [t0 - MAX_PAD, t0 + NT + MAX_PAD)
  // into `raw`, and the weights (k, co0 + co, ci0 .. ci0 + 15) into `ws`.
  auto load = [&](int chunk, unsigned char* ws) {
    const int ci0 = chunk * CI_CHUNK_BF16;
    const uint16_t* xb = x + ((size_t)b * c_in + ci0) * t;
    const int p0 = t0 - MAX_PAD;
    if (vec_x) {  // t % 8 == 0 and p0 % 8 == 0: each 8-frame vector is all in or all out
      constexpr int V = L::ROW / 8;
      for (int i = tid; i < CI_CHUNK_BF16 * V; i += THREADS) {
        const int r = i / V;
        const int v = i - r * V;
        const int p = p0 + 8 * v;
        const bool ok = p >= 0 && p < t;
        tf32::cp_async16(raw + r * L::RAW_STRIDE + 8 * v, ok ? xb + (size_t)r * t + p : x, ok);
      }
    } else {  // 2-byte elements: plain loads, visible after the next __syncthreads
      for (int i = tid; i < CI_CHUNK_BF16 * L::ROW; i += THREADS) {
        const int r = i / L::ROW;
        const int s = i - r * L::ROW;
        const int p = p0 + s;
        raw[r * L::RAW_STRIDE + s] = p >= 0 && p < t ? xb[(size_t)r * t + p] : (uint16_t)0;
      }
    }
    for (int i = tid; i < K * CO_TILE * 2; i += THREADS) {
      const int h = i & 1;
      const int row = i >> 1;  // k * CO_TILE + co
      const int co = row % CO_TILE;
      const int kk = row / CO_TILE;
      const bool ok = co0 + co < c_out;  // rows past C_out (C_out 32) are zeros
      const uint16_t* src =
          ok ? wt + ((size_t)kk * c_out + co0 + co) * c_in + ci0 + 8 * h : wt;
      tf32::cp_async16(ws + row * 32 + 16 * (h ^ ((co >> 2) & 1)), src, ok);
    }
    tf32::cp_async_commit();
  };

  // AdaIN + Snake of `raw` in f32, rounded to bf16, into the plane over the
  // frames the taps read; 0 outside [0, T).  Plane row s holds 8 channels in
  // 16 bytes.
  auto activate = [&](int chunk, unsigned char* plane) {
    const int r = tid & 15;  // one channel per thread
    const int ci = chunk * CI_CHUNK_BF16 + r;
    const int bc = b * c_in + ci;
    const float g1 = 1.f + gamma[bc], mu = mean[bc], rs = rstd[bc], be = beta[bc];
    const float al = alpha[ci];
    const uint16_t* rw = raw + r * L::RAW_STRIDE;
    unsigned char* dst = plane + (r >> 3) * L::HALF_BYTES + 2 * (r & 7);
    const int s0 = MAX_PAD - pad;
    for (int j = tid >> 4; j < NT + 2 * pad; j += THREADS / 16) {
      const int s = s0 + j;
      const int p = t0 - MAX_PAD + s;
      float a = 0.f;
      if (p >= 0 && p < t) {
        const float u = g1 * ((bf16w::to_float(rw[s]) - mu) * rs) + be;
        const float sn = sinf(al * u);  // full-precision sine: |alpha*u| is unbounded
        a = u + sn * sn / al;
      }
      *reinterpret_cast<uint16_t*>(dst + 16 * s) = bf16w::bits(a);
    }
    tf32::fence_proxy_async();  // the plane is read by wgmma
  };

  float acc[L::ACC];
#pragma unroll
  for (int i = 0; i < L::ACC; ++i) acc[i] = 0.f;

  load(0, stages + L::PLANE_BYTES);
  tf32::cp_async_wait<0>();
  __syncthreads();
  activate(0, stages);
  __syncthreads();
  if (n_chunks > 1) load(1, stages + L::STAGE_BYTES + L::PLANE_BYTES);

  // this lane's rows of A: output channels g and g + 8 of its warp's 16; a
  // weight row is 8 words, two 4-word halves swapped on bit 2 of the channel
  const int g = lane >> 2;
  const int q = lane & 3;
  const int sw = 4 * ((g >> 2) & 1);
  const int a_row = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  for (int c = 0; c < n_chunks; ++c) {
    const unsigned char* plane = stages + (c & 1) * L::STAGE_BYTES;
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(plane + L::PLANE_BYTES) + a_row * 8;
    const uint32_t b_addr = static_cast<uint32_t>(__cvta_generic_to_shared(plane));
    uint32_t a[K][4];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const uint32_t* wk = wrow + kk * CO_TILE * 8;
      a[kk][0] = wk[sw + q];                   // row g,     ci 2q, 2q + 1
      a[kk][1] = wk[8 * 8 + sw + q];           // row g + 8
      a[kk][2] = wk[(4 - sw) + q];             // row g,     ci 2q + 8, 2q + 9
      a[kk][3] = wk[8 * 8 + (4 - sw) + q];     // row g + 8
    }
    tf32::fence_operands(acc);
    tf32::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      // B rows start at frame t0 + kk*d - pad: plane row MAX_PAD - pad + kk*d
      const uint32_t shift = 16u * static_cast<uint32_t>(MAX_PAD - pad + kk * d);
      bf16w::mma<NT>(acc, a[kk], tf32::desc(b_addr + shift, L::HALF_BYTES, 128));
    }
    tf32::wgmma_commit();
    // while the tensor cores run chunk c: activate chunk c + 1, load c + 2
    if (c + 1 < n_chunks) {
      tf32::cp_async_wait<0>();
      __syncthreads();
      activate(c + 1, stages + ((c + 1) & 1) * L::STAGE_BYTES);
      __syncthreads();  // raw is free; the weights of chunk c are in registers
      if (c + 2 < n_chunks) load(c + 2, stages + (c & 1) * L::STAGE_BYTES + L::PLANE_BYTES);
    }
    tf32::wgmma_wait<0>();
    tf32::fence_operands(acc);
  }

  // accumulators -> ys[co][t] (the stages are free once every warp is here)
  __syncthreads();
  float* ys = reinterpret_cast<float*>(smem_b);
#pragma unroll
  for (int i = 0; i < NT / 8; ++i) {
    *reinterpret_cast<float2*>(ys + a_row * L::Y_STRIDE + 8 * i + 2 * q) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(ys + (a_row + 8) * L::Y_STRIDE + 8 * i + 2 * q) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  if (residual != nullptr) {  // the residual tile in f32, with every load in flight at once
    constexpr int PER = CO_TILE * NT / THREADS;
    float rv[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int n = i / NT;
      const int tt = t0 + (i - n * NT);
      rv[j] = tt < t && co0 + n < c_out
                  ? bf16w::to_float(residual[((size_t)b * c_out + co0 + n) * t + tt]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * THREADS;
      const int n = i / NT;
      ys[n * L::Y_STRIDE + (i - n * NT)] += rv[j];
    }
    __syncthreads();
  }

  // bias, y rounded to bf16 and stored; partials of the rounded y over the
  // valid frames of each 64-frame tile
  const int len = min(lengths[b], t);
  const int n_stat = (t + STAT_TILE - 1) / STAT_TILE;
  for (int n = warp; n < CO_TILE && co0 + n < c_out; n += THREADS / 32) {
    const int co = co0 + n;
    const float bv = bias[co];
    const size_t row = ((size_t)b * c_out + co) * t;
#pragma unroll
    for (int sub = 0; sub < NT / STAT_TILE; ++sub) {
      const int tile = blockIdx.x * (NT / STAT_TILE) + sub;
      if (tile >= n_stat) break;
      float v[2];
      float s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tl = sub * STAT_TILE + lane + 32 * j;
        const int tt = t0 + tl;
        const uint16_t h = bf16w::bits(ys[n * L::Y_STRIDE + tl] + bv);
        v[j] = bf16w::to_float(h);
        if (tt < t) y[row + tt] = h;
        if (tt < len) s1 += v[j];
      }
      s1 = warp_sum(s1);
      const int n_valid = max(0, min(len - tile * STAT_TILE, STAT_TILE));
      const float mu = s1 / fmaxf((float)n_valid, 1.f);
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float dv = v[j] - mu;
        if (t0 + sub * STAT_TILE + lane + 32 * j < len) m2 += dv * dv;
      }
      m2 = warp_sum(m2);
      if (lane == 0) {
        float* pp = parts + ((size_t)b * n_stat + tile) * 3 * c_out + co;
        pp[0] = s1;
        pp[c_out] = m2;
        pp[2 * c_out] = (float)n_valid;
      }
    }
  }
}

struct Args {
  const void* x;  // float or bf16, as are wt, residual and y
  const float *mean, *rstd, *gamma, *beta, *alpha;
  const void* wt;
  const float* bias;
  const int* lengths;
  const void* residual;
  void* y;
  float* parts;
  int batch, c_in, c_out, t, k, d;
  cudaStream_t stream;
};

// Above 48 KB of dynamic shared memory a kernel has to ask for it.  Asking
// also loads the kernel, so the first request that runs it does not.
template <int NT, int K, int WG, bool BF16>
cudaError_t allow_smem() {
  if constexpr (BF16)
    return cudaFuncSetAttribute(mrf_round_bf16_kernel<NT, K, WG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                TileBf16<NT, K, WG>::BYTES);
  else
    return cudaFuncSetAttribute(mrf_round_kernel<NT, K, WG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Tile<NT, K, WG>::BYTES);
}

template <int WG, bool BF16>
cudaError_t allow_smem_wg() {
  const cudaError_t errs[] = {
      allow_smem<64, 3, WG, BF16>(),  allow_smem<64, 7, WG, BF16>(),
      allow_smem<64, 11, WG, BF16>(), allow_smem<128, 3, WG, BF16>(),
      allow_smem<128, 7, WG, BF16>(), allow_smem<128, 11, WG, BF16>(),
      allow_smem<256, 3, WG, BF16>(), allow_smem<256, 7, WG, BF16>(),
      allow_smem<256, 11, WG, BF16>()};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return e;
  return cudaSuccess;
}

template <bool BF16>
cudaError_t allow_smem_all() {
  const cudaError_t e = allow_smem_wg<1, BF16>();
  return e != cudaSuccess ? e : allow_smem_wg<2, BF16>();
}

template <int NT, int K, int WG, bool BF16>
int launch(const Args& a) {
  if constexpr (BF16) {
    using L = TileBf16<NT, K, WG>;
    const int vec_x = (a.t % 8 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
    const dim3 grid((a.t + NT - 1) / NT, (a.c_out + L::CO_TILE - 1) / L::CO_TILE, a.batch);
    mrf_round_bf16_kernel<NT, K, WG><<<grid, L::THREADS, L::BYTES, a.stream>>>(
        static_cast<const uint16_t*>(a.x), a.mean, a.rstd, a.gamma, a.beta, a.alpha,
        static_cast<const uint16_t*>(a.wt), a.bias, a.lengths,
        static_cast<const uint16_t*>(a.residual), static_cast<uint16_t*>(a.y), a.parts,
        a.c_in, a.c_out, a.t, a.d, vec_x);
  } else {
    using L = Tile<NT, K, WG>;
    const int vec_x = (a.t % 4 == 0) && (reinterpret_cast<uintptr_t>(a.x) % 16 == 0);
    const dim3 grid((a.t + NT - 1) / NT, (a.c_out + L::CO_TILE - 1) / L::CO_TILE, a.batch);
    mrf_round_kernel<NT, K, WG><<<grid, L::THREADS, L::BYTES, a.stream>>>(
        static_cast<const float*>(a.x), a.mean, a.rstd, a.gamma, a.beta, a.alpha,
        static_cast<const float*>(a.wt), a.bias, a.lengths,
        static_cast<const float*>(a.residual), static_cast<float*>(a.y), a.parts, a.c_in,
        a.c_out, a.t, a.d, vec_x);
  }
  return (int)cudaGetLastError();
}

template <int NT, int WG, bool BF16>
int launch_k(const Args& a) {
  switch (a.k) {
    case 3:
      return launch<NT, 3, WG, BF16>(a);
    case 7:
      return launch<NT, 7, WG, BF16>(a);
    default:
      return launch<NT, 11, WG, BF16>(a);
  }
}

// NT: the widest frame tile that still gives every SM a block.
template <int WG, bool BF16>
int launch_nt(const Args& a, int sms) {
  const long long tiles =  // blocks per T-tile column
      (long long)((a.c_out + 64 * WG - 1) / (64 * WG)) * a.batch;
  if ((a.t + 255) / 256 * tiles >= sms) return launch_k<256, WG, BF16>(a);
  if ((a.t + 127) / 128 * tiles >= sms) return launch_k<128, WG, BF16>(a);
  return launch_k<64, WG, BF16>(a);
}

template <bool BF16>
int run(const Args& a, int device) {
  const int ci_chunk = BF16 ? CI_CHUNK_BF16 : CI_CHUNK;
  if ((a.k != 3 && a.k != 7 && a.k != 11) || a.d < 1 || (a.k * a.d - a.d) / 2 > MAX_PAD ||
      a.batch < 1 || a.batch > 65535 || a.t < 1 || a.c_in < ci_chunk ||
      a.c_in % ci_chunk != 0 || a.c_out < 32 || a.c_out % 32 != 0 ||
      reinterpret_cast<uintptr_t>(a.wt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static bool ready[64] = {};  // per device: every instantiation allowed its shared memory
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = allow_smem_all<BF16>();
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return a.c_out % 128 == 0 ? launch_nt<2, BF16>(a, sms) : launch_nt<1, BF16>(a, sms);
}

}  // namespace

extern "C" {

// Frames per tile of the partials: the wrapper sizes them (B, n_tiles, 3, C_out).
int mrf_round_t_tile() { return STAT_TILE; }

// Launches one round on `stream` and returns a cudaError_t (0 = launched).
// wt is the effective kernel re-laid as (K, C_out, C_in); `residual` may be
// null.  All tensors are contiguous f32 except lengths (i32); wt is 16-byte
// aligned; C_in % 8 == 0 and C_out % 32 == 0 (blocks of 128 output channels
// where C_out % 128 == 0, else of 64).
int mrf_round_f32(const float* x, const float* mean, const float* rstd,
                  const float* gamma, const float* beta, const float* alpha,
                  const float* wt, const float* bias, const int* lengths,
                  const float* residual, float* y, float* parts, int batch, int c_in,
                  int c_out, int t, int k, int d, int device, void* stream) {
  const Args a{x, mean, rstd, gamma, beta, alpha, wt, bias, lengths, residual, y, parts,
               batch, c_in, c_out, t, k, d, static_cast<cudaStream_t>(stream)};
  return run<false>(a, device);
}

// The bf16 form: x, wt, residual and y are bf16 (raw 16-bit words), the
// rest as for mrf_round_f32; C_in % 16 == 0.
int mrf_round_bf16(const void* x, const float* mean, const float* rstd,
                   const float* gamma, const float* beta, const float* alpha,
                   const void* wt, const float* bias, const int* lengths,
                   const void* residual, void* y, float* parts, int batch, int c_in,
                   int c_out, int t, int k, int d, int device, void* stream) {
  const Args a{x, mean, rstd, gamma, beta, alpha, wt, bias, lengths, residual, y, parts,
               batch, c_in, c_out, t, k, d, static_cast<cudaStream_t>(stream)};
  return run<true>(a, device);
}

}  // extern "C"
