// AdaIN -> Snake on (B, C, T) f32, forward and backward, for Hopper (sm_90a).
//
// Replaces styletts2_tpu/ops/pallas/adain_snake_kernel.py: the forward
// _fwd_kernel (_fwd_call) and the custom-VJP backward _bwd_kernel (_bwd_call).
// For each row (b, c), with n = max(min(lengths[b], T), 1) valid frames:
//
//   mean = sum_{t<n} x / n,   var = sum_{t<n} (x - mean)^2 / n   (centred, two passes)
//   rstd = rsqrt(var + 1e-5),  xh = (x - mean) * rstd
//   u    = (1 + gamma) * xh + beta,  y = u + sin(alpha*u)^2 / alpha    at every t
//
// Backward, given dy (every frame carries a gradient; only the statistics
// are masked):
//
//   du  = dy * (1 + sin(2 alpha u)),   dxh = (1 + gamma) * du
//   dbeta = sum_t du,  dgamma = sum_t du * xh,
//   dalpha[b] = sum_t dy * (u sin(2 alpha u) / alpha - sin(alpha u)^2 / alpha^2)
//   dx  = rstd * (dxh - [t < n] * (sum_t dxh + xh * sum_t dxh * xh) / n)
//
// with every sum over all T frames; the wrapper sums dalpha over b.
//
// What bounds it.  Each row is a few elementwise operations and two sines
// per frame around three (forward) or two (backward) reductions over the
// row: about 4 * 2 * B*C*T bytes move in the forward (x in, y out) and
// 4 * 3 * B*C*T in the backward (x, dy in, dx out), against some 30-60
// operations per frame.  At the stage-1 shapes (16 x 256 x 1920 and
// 16 x 128 x 11521) that is far below the f32 ridge of the card (~20
// FLOP/byte): both kernels are bound by bytes.
//
// What this design does about it.  One block per row; the row stays in
// shared memory between passes (rows up to about 57k frames fit the 227 KB
// a block may opt into), so the forward reads x once from
// device memory and the backward reads x and dy once for its reduction pass
// and keeps dxh for the second.  Rows longer than that re-read device memory
// (through L2).  The sines are the full-precision sinf: __sinf's error grows
// with |alpha u|.  Vectorised 16-byte loads and several rows per block for
// short rows are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-5f;

// Sums NV values over the block; every thread gets the totals.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[WARPS]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = lane < WARPS ? red[i][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    v[i] = s;
  }
}

__device__ __forceinline__ int valid_frames(const int* lengths, int b, int t) {
  if (lengths == nullptr) return t;
  const int n = lengths[b];
  return n < 0 ? 0 : (n > t ? t : n);
}

// grid: one block per (b, c) row.  `cache` (dynamic shared memory, T floats
// when `cached`) holds x between the passes.
__global__ void __launch_bounds__(THREADS)
adain_snake_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ alpha,
                       const int* __restrict__ lengths, float* __restrict__ y,
                       float* __restrict__ mean_out, float* __restrict__ rstd_out,
                       int c, int t, int cached) {
  extern __shared__ float cache[];
  __shared__ float red[1][WARPS];
  const int row = blockIdx.x;
  const int b = row / c, ch = row % c;
  const float* xr = x + (size_t)row * t;
  float* yr = y + (size_t)row * t;
  const int nv = valid_frames(lengths, b, t);
  const float n = (float)(nv > 0 ? nv : 1);

  float s[1] = {0.f};
  if (cached) {
    for (int i = threadIdx.x; i < t; i += THREADS) {
      const float v = xr[i];
      cache[i] = v;
      if (i < nv) s[0] += v;
    }
  } else {
    for (int i = threadIdx.x; i < nv; i += THREADS) s[0] += xr[i];
  }
  block_sum<1>(s, red);
  const float mean = s[0] / n;

  float q[1] = {0.f};
  for (int i = threadIdx.x; i < nv; i += THREADS) {
    const float dv = (cached ? cache[i] : xr[i]) - mean;
    q[0] += dv * dv;
  }
  block_sum<1>(q, red);
  const float rstd = rsqrtf(q[0] / n + EPS);

  const float g1 = 1.f + gamma[row], be = beta[row], a = alpha[ch];
  const float inv_a = 1.f / a;
  for (int i = threadIdx.x; i < t; i += THREADS) {
    const float xh = ((cached ? cache[i] : xr[i]) - mean) * rstd;
    const float u = g1 * xh + be;
    const float sn = sinf(a * u);
    yr[i] = u + sn * sn * inv_a;
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// grid: one block per (b, c) row.  `cache` holds dxh between the passes.
__global__ void __launch_bounds__(THREADS)
adain_snake_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ alpha,
                       const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                       const int* __restrict__ lengths, const float* __restrict__ dy,
                       float* __restrict__ dx, float* __restrict__ dgamma,
                       float* __restrict__ dbeta, float* __restrict__ dalpha,
                       int c, int t, int cached) {
  extern __shared__ float cache[];
  __shared__ float red[5][WARPS];
  const int row = blockIdx.x;
  const int b = row / c, ch = row % c;
  const float* xr = x + (size_t)row * t;
  const float* dyr = dy + (size_t)row * t;
  float* dxr = dx + (size_t)row * t;
  const int nv = valid_frames(lengths, b, t);
  const float n = (float)(nv > 0 ? nv : 1);
  const float mean = mean_in[row], rstd = rstd_in[row];
  const float g1 = 1.f + gamma[row], be = beta[row], a = alpha[ch];
  const float inv_a = 1.f / a;

  // acc: dalpha, dbeta, dgamma, sum dxh, sum dxh * xh
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < t; i += THREADS) {
    const float xh = (xr[i] - mean) * rstd;
    const float u = g1 * xh + be;
    const float sn = sinf(a * u);
    const float s2 = sinf(2.f * a * u);
    const float g = dyr[i];
    const float du = g * (1.f + s2);
    const float dxh = du * g1;
    acc[0] += g * (u * s2 * inv_a - sn * sn * (inv_a * inv_a));
    acc[1] += du;
    acc[2] += du * xh;
    acc[3] += dxh;
    acc[4] += dxh * xh;
    if (cached) cache[i] = dxh;
  }
  block_sum<5>(acc, red);
  const float s1 = acc[3] / n, s2 = acc[4] / n;

  for (int i = threadIdx.x; i < t; i += THREADS) {
    const float xh = (xr[i] - mean) * rstd;
    float dxh;
    if (cached) {
      dxh = cache[i];
    } else {
      const float u = g1 * xh + be;
      dxh = dyr[i] * (1.f + sinf(2.f * a * u)) * g1;
    }
    dxr[i] = rstd * (i < nv ? dxh - (s1 + xh * s2) : dxh);
  }
  if (threadIdx.x == 0) {
    dalpha[row] = acc[0];
    dbeta[row] = acc[1];
    dgamma[row] = acc[2];
  }
}

int prepare(int t, int* cached, size_t* smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t want = (size_t)t * sizeof(float);
  // leave room for the static reduction buffers
  *cached = want + 1024 <= (size_t)limit;
  *smem = *cached ? want : 0;
  if (*cached) {
    err = cudaFuncSetAttribute(adain_snake_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)want);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(adain_snake_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)want);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Forward on `stream`; returns cudaGetLastError() (0 = launched).  `lengths`
// may be null (all T frames valid).  y (B, C, T); mean, rstd (B, C).
int adain_snake_fwd_f32(const float* x, const float* gamma, const float* beta,
                        const float* alpha, const int* lengths, float* y, float* mean,
                        float* rstd, int batch, int c, int t, int device, void* stream) {
  if (batch < 1 || c < 1 || t < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int cached = 0;
  size_t smem = 0;
  int rc = prepare(t, &cached, &smem);
  if (rc != 0) return rc;
  adain_snake_fwd_kernel<<<batch * c, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gamma, beta, alpha, lengths, y, mean, rstd, c, t, cached);
  return (int)cudaGetLastError();
}

// Backward on `stream`; returns cudaGetLastError().  dx (B, C, T); dgamma,
// dbeta and the per-row dalpha (B, C).
int adain_snake_bwd_f32(const float* x, const float* gamma, const float* beta,
                        const float* alpha, const float* mean, const float* rstd,
                        const int* lengths, const float* dy, float* dx, float* dgamma,
                        float* dbeta, float* dalpha, int batch, int c, int t, int device,
                        void* stream) {
  if (batch < 1 || c < 1 || t < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int cached = 0;
  size_t smem = 0;
  int rc = prepare(t, &cached, &smem);
  if (rc != 0) return rc;
  adain_snake_bwd_kernel<<<batch * c, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gamma, beta, alpha, mean, rstd, lengths, dy, dx, dgamma, dbeta, dalpha, c, t,
      cached);
  return (int)cudaGetLastError();
}

}  // extern "C"
