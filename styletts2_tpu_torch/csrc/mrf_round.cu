// One fused MRF round of the iSTFTNet generator, for Hopper (sm_90a), f32.
//
// Replaces styletts2_tpu/ops/pallas/mrf_round_kernel.py::fused_mrf_round
// (body _round_kernel).  For every (b, c_out, t):
//
//   u   = (1 + gamma) * ((x - mean) * rstd) + beta          AdaIN, given stats
//   a   = u + sin(alpha*u)^2 / alpha                         Snake, 0 outside [0, T)
//   y   = bias + sum_{ci,k} w[co,ci,k] * a[ci, t + k*d - pad]  (+ residual)
//
// and per T-tile partials (S1, M2 around the tile mean, n) of y over the
// frames t < min(lengths[b], T), which the wrapper combines with Chan's rule
// into the next round's (mean, rstd).  Values in [lengths, T) are computed,
// not zeroed: only the statistics are masked, as on the TPU.
//
// What bounds it.  At LJSpeech frame capacity 200 (batch 1) the 48 rounds of
// one request do about 239 GFLOP: stage 0 is 6*2*256^2*4000*(7+21) FLOP and
// stage 1 is 6*2*128^2*24000*(11+21) FLOP.  A stage-1 round moves about
// 37 MB (x, residual and y at 128 x 24000 f32, ~12 MB each).  That is ~230
// FLOP per byte, above the f32 ridge of the card (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte): the round is bound by operations.
//
// What this design does about it.  The activation never touches device
// memory: each block applies the affine and snake while it loads its input
// halo into shared memory, so a round reads x once (plus the halo overlap,
// 2*pad/128 extra) and writes y once, and the next round's statistics come
// out of the epilogue instead of a separate reduction pass.  The conv is an
// implicit GEMM on the CUDA cores: a 64 (c_out) x 128 (t) output tile per
// block of 256 threads, 4 x 8 f32 accumulators per thread, the weights and
// activations of an 8-channel input chunk staged in shared memory (~29 KB
// static at K=11).  Tensor cores (TF32/bf16 wgmma) and TMA staging are the
// next step; this first form is plain and exact in f32.

#include <cuda_runtime.h>

namespace {

constexpr int T_TILE = 128;    // output frames per block
constexpr int CO_TILE = 64;    // output channels per block
constexpr int CI_CHUNK = 8;    // input channels staged per step
constexpr int MAX_PAD = 32;    // (K*d - d)/2 <= 25 for K <= 11, d <= 5
constexpr int HALO = T_TILE + 2 * MAX_PAD;
constexpr int THREADS = 256;
constexpr int TX = 16;         // threads along t   (lanes of a half-warp)
constexpr int TY = THREADS / TX;
constexpr int T_PER = T_TILE / TX;    // 8 frames per thread, stride TX
constexpr int CO_PER = CO_TILE / TY;  // 4 channels per thread, stride TY

template <int K>
__global__ void __launch_bounds__(THREADS)
mrf_round_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ alpha,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 const int* __restrict__ lengths, const float* __restrict__ residual,
                 float* __restrict__ y, float* __restrict__ parts,
                 int c_in, int c_out, int t, int d) {
  __shared__ float act[CI_CHUNK][HALO];
  __shared__ float ws[CI_CHUNK * K][CO_TILE + 1];  // +1: conflict-free transpose

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * T_TILE;
  const int co0 = blockIdx.y * CO_TILE;
  const int b = blockIdx.z;
  const int pad = (K * d - d) / 2;
  const int halo = T_TILE + 2 * pad;

  float acc[CO_PER][T_PER];
#pragma unroll
  for (int i = 0; i < CO_PER; ++i)
#pragma unroll
    for (int j = 0; j < T_PER; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < c_in; ci0 += CI_CHUNK) {
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < CI_CHUNK * halo; i += THREADS) {
      const int cl = i / halo;
      const int s = i - cl * halo;
      const int ci = ci0 + cl;
      const int p = t0 - pad + s;
      float a = 0.f;  // zero conv padding of the ACTIVATION outside [0, T)
      if (ci < c_in && p >= 0 && p < t) {
        const int bc = b * c_in + ci;
        const float u = (1.f + gamma[bc]) * ((x[(size_t)bc * t + p] - mean[bc]) * rstd[bc])
                        + beta[bc];
        const float al = alpha[ci];
        const float sn = sinf(al * u);  // full-precision sine: |alpha*u| is unbounded
        a = u + sn * sn / al;
      }
      act[cl][s] = a;
    }
    // w[co][ci][k] is contiguous in (ci, k) for a fixed co
    for (int i = tid; i < CO_TILE * CI_CHUNK * K; i += THREADS) {
      const int col = i / (CI_CHUNK * K);
      const int r = i - col * (CI_CHUNK * K);
      const int co = co0 + col;
      float v = 0.f;
      if (co < c_out && ci0 + r / K < c_in) v = w[((size_t)co * c_in + ci0) * K + r];
      ws[r][col] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int cl = 0; cl < CI_CHUNK; ++cl) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float wv[CO_PER];
#pragma unroll
        for (int i = 0; i < CO_PER; ++i) wv[i] = ws[cl * K + k][ty + TY * i];
        const float* arow = &act[cl][tx + k * d];
#pragma unroll
        for (int j = 0; j < T_PER; ++j) {
          const float av = arow[TX * j];
#pragma unroll
          for (int i = 0; i < CO_PER; ++i) acc[i][j] = fmaf(wv[i], av, acc[i][j]);
        }
      }
    }
  }

  // epilogue: bias, residual, store; partials over the valid frames of the tile
  const int len = min(lengths[b], t);
  const int n_valid = max(0, min(len - t0, T_TILE));
  const float inv_n = 1.f / fmaxf((float)n_valid, 1.f);
#pragma unroll
  for (int i = 0; i < CO_PER; ++i) {
    const int co = co0 + ty + TY * i;
    const bool co_ok = co < c_out;
    const float bv = co_ok ? bias[co] : 0.f;
    const size_t row = ((size_t)b * c_out + co) * t;
    float yv[T_PER];
    float s1 = 0.f;
#pragma unroll
    for (int j = 0; j < T_PER; ++j) {
      const int tt = t0 + tx + TX * j;
      float v = acc[i][j] + bv;
      if (co_ok && tt < t) {
        if (residual != nullptr) v += residual[row + tt];
        y[row + tt] = v;
      }
      yv[j] = v;
      if (tt < len) s1 += v;
    }
    // the TX lanes of one half-warp share ty, hence co
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    const float mu = s1 * inv_n;
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < T_PER; ++j) {
      const float dv = yv[j] - mu;
      if (t0 + tx + TX * j < len) m2 += dv * dv;
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    if (tx == 0 && co_ok) {
      float* pp = parts + ((size_t)b * gridDim.x + blockIdx.x) * 3 * c_out + co;
      pp[0] = s1;
      pp[c_out] = m2;
      pp[2 * c_out] = (float)n_valid;
    }
  }
}

template <int K>
void launch(dim3 grid, cudaStream_t stream, const float* x, const float* mean,
            const float* rstd, const float* gamma, const float* beta, const float* alpha,
            const float* w, const float* bias, const int* lengths, const float* residual,
            float* y, float* parts, int c_in, int c_out, int t, int d) {
  mrf_round_kernel<K><<<grid, THREADS, 0, stream>>>(
      x, mean, rstd, gamma, beta, alpha, w, bias, lengths, residual, y, parts,
      c_in, c_out, t, d);
}

}  // namespace

extern "C" {

// Frames per T-tile: the wrapper sizes the partials (B, n_tiles, 3, C_out) with it.
int mrf_round_t_tile() { return T_TILE; }

// Launches one round on `stream` and returns cudaGetLastError() (0 = launched).
// `residual` may be null.  All tensors are contiguous f32 except lengths (i32).
int mrf_round_f32(const float* x, const float* mean, const float* rstd,
                  const float* gamma, const float* beta, const float* alpha,
                  const float* w, const float* bias, const int* lengths,
                  const float* residual, float* y, float* parts, int batch, int c_in,
                  int c_out, int t, int k, int d, int device, void* stream) {
  if ((k * d - d) / 2 > MAX_PAD || d < 1 || batch < 1 || t < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + T_TILE - 1) / T_TILE, (c_out + CO_TILE - 1) / CO_TILE, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3:
      launch<3>(grid, s, x, mean, rstd, gamma, beta, alpha, w, bias, lengths, residual, y,
                parts, c_in, c_out, t, d);
      break;
    case 7:
      launch<7>(grid, s, x, mean, rstd, gamma, beta, alpha, w, bias, lengths, residual, y,
                parts, c_in, c_out, t, d);
      break;
    case 11:
      launch<11>(grid, s, x, mean, rstd, gamma, beta, alpha, w, bias, lengths, residual, y,
                 parts, c_in, c_out, t, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
