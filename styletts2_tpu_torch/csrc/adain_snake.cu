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
// What bounds it.  A few elementwise operations and one sine (forward) or
// one sincos (backward) per frame around two reductions (forward) or one
// (backward) over the row: 8 bytes move per frame in the forward (x in, y
// out) and 12 in the backward (x, dy in, dx out).  At the stage-1 shapes
// (16 x 256 x 1920 and 16 x 128 x 11521) that is far below the f32 ridge of
// the card (~20 FLOP/byte): both kernels are bound by bytes, and a row
// reduction reaches the byte rate only with enough bytes in flight (about
// 15 KB per SM at 3.35 TB/s and ~600 ns of latency) across its barriers.
//
// Two paths, chosen by T alone:
//
// - Rows (every training shape).  G threads own one row and hold it in
//   registers: each thread loads V 16-byte vectors of the row's aligned body
//   (vector k*G + tid, so a warp's load is 512 contiguous bytes), plus at
//   most one frame of the unaligned head (the first (4 - row*T mod 4) mod 4
//   frames) and one of the tail.  Every load is issued before the first
//   use, the reductions are warp shuffles and one shared-memory exchange
//   each, and the output is written from the registers: x (and dy) are read
//   from device memory once, and no shared-memory row cache limits how many
//   rows an SM holds.  The forward keeps x and writes y after its two
//   reductions (sum, then the centred sum of squares); the backward keeps
//   xh and dxh, reduces its five sums in one exchange and writes dx.
//   (G, V) is the first of FWD_PLANS / BWD_PLANS whose G * V vectors hold
//   the row (up to 4 G V + 3 frames): forward 128x4 to 2051 frames, 256x4
//   to 4099, 384x8 to 12291, 1024x6 to 24579; backward 128x4, 256x4, 768x4
//   and 1024x4 to 16387.  ptxas: 40-56 registers forward, 64-75 backward,
//   no spills; an SM holds 12 forward or 8 backward rows of 1920 frames, 3
//   forward or 1 backward row of 11521.  These plans were the fastest, or
//   within noise of it, of every (G, V) timed by scripts/torch_k1_tune.py.
// - Long rows (beyond the largest plan: the serving decoder's unfused rows,
//   and backward rows past 16387 frames).  One 256-thread block per row; the
//   row (x in the forward, dxh in the backward) is cached in dynamic shared
//   memory up to the opt-in limit (about 57k frames), beyond which the second
//   pass re-reads device memory (through L2).
//
// The backward takes one sincosf per frame, sin(2au) = 2 sin(au) cos(au).
// The sines are the full-precision sinf / sincosf: __sinf's error grows with
// |alpha u|.
//
// Measured (H100 SXM at 700 W, PERF.md; chip_smoke.py's device_ms): K1b
// 0.122 ms at 16 x 128 x 11521 and 0.041 ms at 16 x 256 x 1920, 0.69 of the
// byte bound at both; K1f 0.080 and 0.031 ms, 0.70 and 0.62 of it.  Over a
// profiled stage-1 step (48 launches each) K1b takes 3.6 ms of device time
// and K1f 2.4 ms.  At 11521 frames every backward plan that holds the row
// lands at 0.12-0.13 ms: a row's x and dxh fill an SM's registers, so no
// second row hides its barrier and its stores.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr float EPS = 1e-5f;
constexpr int LONG_THREADS = 256;

struct Plan {
  int threads, vecs;
};
// (threads per row, 16-byte vectors per thread), smallest first.
constexpr Plan FWD_PLANS[] = {{128, 4}, {256, 4}, {384, 8}, {1024, 6}};
constexpr Plan BWD_PLANS[] = {{128, 4}, {256, 4}, {768, 4}, {1024, 4}};
constexpr int N_PLANS = 4;

struct FwdArgs {
  const float *x, *gamma, *beta, *alpha;
  const int* lengths;
  float *y, *mean, *rstd;
  int rows, c, t;
};

struct BwdArgs {
  const float *x, *gamma, *beta, *alpha, *mean, *rstd;
  const int* lengths;
  const float* dy;
  float *dx, *dgamma, *dbeta, *dalpha;
  int rows, c, t;
};

// Sums NV values over the block of G threads; every thread gets the totals.
// Each call needs its own `red`: one barrier, none to protect a reuse.
template <int G, int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[G / 32]) {
  constexpr int W = G / 32;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) red[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = lane < W ? red[i][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    v[i] = s;
  }
}

// u = g1 * xh + be rounded twice, as the plain version rounds it, not fused
// into one FMA: a row of 0 or 1 valid frames has rstd = 1/sqrt(eps) = 316,
// |alpha u| in the hundreds, and one rounding of u there moves sin(alpha u)
// by ~1e-4.
__device__ __forceinline__ float affine(float g1, float xh, float be) {
  return __fadd_rn(__fmul_rn(g1, xh), be);
}

__device__ __forceinline__ int valid_frames(const int* lengths, int b, int t) {
  if (lengths == nullptr) return t;
  const int n = lengths[b];
  return n < 0 ? 0 : (n > t ? t : n);
}

// ---------------------------------------------------------------------------
// The rows path.

// A row of a tensor whose base is 16-byte aligned (the wrapper's check)
// starts (row * t mod 4) floats past a 16-byte boundary: `head` scalar frames
// up to the next one, `nvec` aligned float4 vectors, `tail` scalar frames.
struct Row {
  int head, nvec, tail;
};

__device__ __forceinline__ Row split_row(int row, int t) {
  const int off = (int)(((long long)row * t) & 3);
  const int head = min((4 - off) & 3, t);
  return {head, (t - head) >> 2, (t - head) & 3};
}

// A thread's 4V + 2 slots: slot s < 4V is element s % 4 of body vector
// (s / 4) * G + tid; slot 4V is head frame tid, slot 4V + 1 tail frame tid.
template <int G, int V>
__device__ __forceinline__ bool held(const Row& r, int s) {
  if (s < 4 * V) return (s >> 2) * G + (int)threadIdx.x < r.nvec;
  return (int)threadIdx.x < (s == 4 * V ? r.head : r.tail);
}

template <int G, int V>
__device__ __forceinline__ int frame(const Row& r, int s) {
  const int tid = threadIdx.x;
  if (s < 4 * V) return r.head + 4 * ((s >> 2) * G + tid) + (s & 3);
  return s == 4 * V ? tid : r.head + 4 * r.nvec + tid;
}

// Issues every load of the thread's slots (0 where a slot holds no frame).
template <int G, int V>
__device__ __forceinline__ void load_row(const float* __restrict__ p, const Row& r,
                                         float (&a)[4 * V + 2]) {
  const float4* body = reinterpret_cast<const float4*>(p + r.head);
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = k * G + tid;
    const float4 q = i < r.nvec ? __ldg(body + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    a[4 * k] = q.x;
    a[4 * k + 1] = q.y;
    a[4 * k + 2] = q.z;
    a[4 * k + 3] = q.w;
  }
  a[4 * V] = tid < r.head ? __ldg(p + tid) : 0.f;
  a[4 * V + 1] = tid < r.tail ? __ldg(p + r.head + 4 * r.nvec + tid) : 0.f;
}

template <int G, int V>
__device__ __forceinline__ void store_row(float* __restrict__ p, const Row& r,
                                          const float (&a)[4 * V + 2]) {
  float4* body = reinterpret_cast<float4*>(p + r.head);
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = k * G + tid;
    if (i < r.nvec) body[i] = make_float4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3]);
  }
  if (tid < r.head) p[tid] = a[4 * V];
  if (tid < r.tail) p[r.head + 4 * r.nvec + tid] = a[4 * V + 1];
}

// grid: one block of G threads per (b, c) row of at most 4 * G * V + 3 frames.
template <int G, int V>
__global__ void __launch_bounds__(G)
adain_snake_fwd_rows(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ alpha,
                     const int* __restrict__ lengths, float* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, int c, int t) {
  constexpr int N = 4 * V + 2;
  __shared__ float red[2][1][G / 32];
  const int row = blockIdx.x;
  const int b = row / c, ch = row % c;
  const Row r = split_row(row, t);
  float a[N];
  load_row<G, V>(x + (size_t)row * t, r, a);
  const int nv = valid_frames(lengths, b, t);
  const float n = (float)(nv > 0 ? nv : 1);
  const float g1 = 1.f + gamma[row], be = beta[row], al = alpha[ch];

  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (held<G, V>(r, i) && frame<G, V>(r, i) < nv) s[0] += a[i];
  block_sum<G, 1>(s, red[0]);
  const float mean = s[0] / n;

  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (held<G, V>(r, i) && frame<G, V>(r, i) < nv) {
      const float dv = a[i] - mean;
      q[0] += dv * dv;
    }
  }
  block_sum<G, 1>(q, red[1]);
  const float rstd = rsqrtf(q[0] / n + EPS);

  const float inv_a = 1.f / al;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (held<G, V>(r, i)) {
      const float u = affine(g1, (a[i] - mean) * rstd, be);
      const float sn = sinf(al * u);
      a[i] = u + sn * sn * inv_a;
    }
  }
  store_row<G, V>(y + (size_t)row * t, r, a);
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// grid: one block of G threads per (b, c) row of at most 4 * G * V + 3 frames.
template <int G, int V>
__global__ void __launch_bounds__(G)
adain_snake_bwd_rows(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ alpha,
                     const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                     const int* __restrict__ lengths, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, float* __restrict__ dalpha, int c, int t) {
  constexpr int N = 4 * V + 2;
  __shared__ float red[5][G / 32];
  const int row = blockIdx.x;
  const int b = row / c, ch = row % c;
  const Row r = split_row(row, t);
  float xs[N], gs[N];  // x, then xh; dy, then dxh, then dx
  load_row<G, V>(x + (size_t)row * t, r, xs);
  load_row<G, V>(dy + (size_t)row * t, r, gs);
  const int nv = valid_frames(lengths, b, t);
  const float n = (float)(nv > 0 ? nv : 1);
  const float mean = mean_in[row], rstd = rstd_in[row];
  const float g1 = 1.f + gamma[row], be = beta[row], al = alpha[ch];
  const float inv_a = 1.f / al;

  // acc: dalpha, dbeta, dgamma, sum dxh, sum dxh * xh
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (held<G, V>(r, i)) {
      const float xh = (xs[i] - mean) * rstd;
      const float u = affine(g1, xh, be);
      float sn, cs;
      sincosf(al * u, &sn, &cs);
      const float s2 = 2.f * sn * cs;
      const float g = gs[i];
      const float du = g * (1.f + s2);
      const float dxh = du * g1;
      acc[0] += g * (u * s2 * inv_a - sn * sn * (inv_a * inv_a));
      acc[1] += du;
      acc[2] += du * xh;
      acc[3] += dxh;
      acc[4] += dxh * xh;
      xs[i] = xh;
      gs[i] = dxh;
    }
  }
  block_sum<G, 5>(acc, red);
  const float s1 = acc[3] / n, s2 = acc[4] / n;

#pragma unroll
  for (int i = 0; i < N; ++i)
    if (held<G, V>(r, i))
      gs[i] = rstd * (frame<G, V>(r, i) < nv ? gs[i] - (s1 + xs[i] * s2) : gs[i]);
  store_row<G, V>(dx + (size_t)row * t, r, gs);
  if (threadIdx.x == 0) {
    dalpha[row] = acc[0];
    dbeta[row] = acc[1];
    dgamma[row] = acc[2];
  }
}

template <int G, int V>
cudaError_t launch_fwd_rows(const FwdArgs& a, cudaStream_t stream) {
  adain_snake_fwd_rows<G, V><<<a.rows, G, 0, stream>>>(a.x, a.gamma, a.beta, a.alpha,
                                                       a.lengths, a.y, a.mean, a.rstd, a.c, a.t);
  return cudaGetLastError();
}

template <int G, int V>
cudaError_t launch_bwd_rows(const BwdArgs& a, cudaStream_t stream) {
  adain_snake_bwd_rows<G, V><<<a.rows, G, 0, stream>>>(
      a.x, a.gamma, a.beta, a.alpha, a.mean, a.rstd, a.lengths, a.dy, a.dx, a.dgamma, a.dbeta,
      a.dalpha, a.c, a.t);
  return cudaGetLastError();
}

// The index of the first plan that holds a row of t frames, or -1.
int plan_index(const Plan* plans, int t) {
  for (int i = 0; i < N_PLANS; ++i)
    if ((t >> 2) <= plans[i].threads * plans[i].vecs) return i;
  return -1;
}

// ---------------------------------------------------------------------------
// The long-row path.

// grid: one block per (b, c) row.  `cache` (dynamic shared memory, T floats
// when `cached`) holds x between the passes.
__global__ void __launch_bounds__(LONG_THREADS)
adain_snake_fwd_long(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ alpha,
                     const int* __restrict__ lengths, float* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, int c, int t,
                     int cached) {
  extern __shared__ float cache[];
  __shared__ float red[2][1][LONG_THREADS / 32];
  const int row = blockIdx.x;
  const int b = row / c, ch = row % c;
  const float* xr = x + (size_t)row * t;
  float* yr = y + (size_t)row * t;
  const int nv = valid_frames(lengths, b, t);
  const float n = (float)(nv > 0 ? nv : 1);

  float s[1] = {0.f};
  if (cached) {
    for (int i = threadIdx.x; i < t; i += LONG_THREADS) {
      const float v = xr[i];
      cache[i] = v;
      if (i < nv) s[0] += v;
    }
  } else {
    for (int i = threadIdx.x; i < nv; i += LONG_THREADS) s[0] += xr[i];
  }
  block_sum<LONG_THREADS, 1>(s, red[0]);
  const float mean = s[0] / n;

  float q[1] = {0.f};
  for (int i = threadIdx.x; i < nv; i += LONG_THREADS) {
    const float dv = (cached ? cache[i] : xr[i]) - mean;
    q[0] += dv * dv;
  }
  block_sum<LONG_THREADS, 1>(q, red[1]);
  const float rstd = rsqrtf(q[0] / n + EPS);

  const float g1 = 1.f + gamma[row], be = beta[row], a = alpha[ch];
  const float inv_a = 1.f / a;
  for (int i = threadIdx.x; i < t; i += LONG_THREADS) {
    const float xh = ((cached ? cache[i] : xr[i]) - mean) * rstd;
    const float u = affine(g1, xh, be);
    const float sn = sinf(a * u);
    yr[i] = u + sn * sn * inv_a;
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// grid: one block per (b, c) row.  `cache` holds dxh between the passes.
__global__ void __launch_bounds__(LONG_THREADS)
adain_snake_bwd_long(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ alpha,
                     const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                     const int* __restrict__ lengths, const float* __restrict__ dy,
                     float* __restrict__ dx, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, float* __restrict__ dalpha, int c, int t,
                     int cached) {
  extern __shared__ float cache[];
  __shared__ float red[5][LONG_THREADS / 32];
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
  for (int i = threadIdx.x; i < t; i += LONG_THREADS) {
    const float xh = (xr[i] - mean) * rstd;
    const float u = affine(g1, xh, be);
    float sn, cs;
    sincosf(a * u, &sn, &cs);
    const float s2 = 2.f * sn * cs;
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
  block_sum<LONG_THREADS, 5>(acc, red);
  const float s1 = acc[3] / n, s2 = acc[4] / n;

  for (int i = threadIdx.x; i < t; i += LONG_THREADS) {
    const float xh = (xr[i] - mean) * rstd;
    float dxh;
    if (cached) {
      dxh = cache[i];
    } else {
      float sn, cs;
      sincosf(a * affine(g1, xh, be), &sn, &cs);
      dxh = dyr[i] * (1.f + 2.f * sn * cs) * g1;
    }
    dxr[i] = rstd * (i < nv ? dxh - (s1 + xh * s2) : dxh);
  }
  if (threadIdx.x == 0) {
    dalpha[row] = acc[0];
    dbeta[row] = acc[1];
    dgamma[row] = acc[2];
  }
}

// Per device: the shared-memory opt-in limit, read at the first long row,
// and the dynamic shared memory each long kernel has been allowed so far.
constexpr int MAX_DEVICES = 64;
struct DeviceState {
  int limit = -1;
  size_t fwd_allowed = 0, bwd_allowed = 0;
};
std::mutex state_mutex;
DeviceState device_state[MAX_DEVICES];

// Whether a long row of t frames is cached in shared memory on `device`,
// and how much that takes: a decision only, from the opt-in limit (read
// once per device).
cudaError_t long_cache(int device, int t, int* cached, size_t* smem) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(state_mutex);
  DeviceState& d = device_state[device];
  if (d.limit < 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&d.limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) {
      d.limit = -1;
      return err;
    }
  }
  const size_t want = (size_t)t * sizeof(float);
  // leave room for the static reduction buffers
  *cached = want + 1024 <= (size_t)d.limit;
  *smem = *cached ? want : 0;
  return cudaSuccess;
}

// Raises a long kernel's dynamic shared-memory allowance on `device`, which
// must be the current device, only when `smem` is beyond what it was allowed.
cudaError_t allow_long(int device, bool backward, size_t smem) {
  std::lock_guard<std::mutex> lock(state_mutex);
  DeviceState& d = device_state[device];
  size_t& allowed = backward ? d.bwd_allowed : d.fwd_allowed;
  if (smem <= allowed) return cudaSuccess;
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = backward ? cudaFuncSetAttribute(adain_snake_bwd_long, attr, (int)smem)
                             : cudaFuncSetAttribute(adain_snake_fwd_long, attr, (int)smem);
  if (err != cudaSuccess) return err;
  allowed = smem;
  return cudaSuccess;
}

cudaError_t launch_fwd(const FwdArgs& a, int device, cudaStream_t stream) {
  switch (plan_index(FWD_PLANS, a.t)) {
    case 0: return launch_fwd_rows<FWD_PLANS[0].threads, FWD_PLANS[0].vecs>(a, stream);
    case 1: return launch_fwd_rows<FWD_PLANS[1].threads, FWD_PLANS[1].vecs>(a, stream);
    case 2: return launch_fwd_rows<FWD_PLANS[2].threads, FWD_PLANS[2].vecs>(a, stream);
    case 3: return launch_fwd_rows<FWD_PLANS[3].threads, FWD_PLANS[3].vecs>(a, stream);
    default: break;
  }
  int cached = 0;
  size_t smem = 0;
  cudaError_t err = long_cache(device, a.t, &cached, &smem);
  if (err == cudaSuccess) err = allow_long(device, false, smem);
  if (err != cudaSuccess) return err;
  adain_snake_fwd_long<<<a.rows, LONG_THREADS, smem, stream>>>(
      a.x, a.gamma, a.beta, a.alpha, a.lengths, a.y, a.mean, a.rstd, a.c, a.t, cached);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const BwdArgs& a, int device, cudaStream_t stream) {
  switch (plan_index(BWD_PLANS, a.t)) {
    case 0: return launch_bwd_rows<BWD_PLANS[0].threads, BWD_PLANS[0].vecs>(a, stream);
    case 1: return launch_bwd_rows<BWD_PLANS[1].threads, BWD_PLANS[1].vecs>(a, stream);
    case 2: return launch_bwd_rows<BWD_PLANS[2].threads, BWD_PLANS[2].vecs>(a, stream);
    case 3: return launch_bwd_rows<BWD_PLANS[3].threads, BWD_PLANS[3].vecs>(a, stream);
    default: break;
  }
  int cached = 0;
  size_t smem = 0;
  cudaError_t err = long_cache(device, a.t, &cached, &smem);
  if (err == cudaSuccess) err = allow_long(device, true, smem);
  if (err != cudaSuccess) return err;
  adain_snake_bwd_long<<<a.rows, LONG_THREADS, smem, stream>>>(
      a.x, a.gamma, a.beta, a.alpha, a.mean, a.rstd, a.lengths, a.dy, a.dx, a.dgamma, a.dbeta,
      a.dalpha, a.c, a.t, cached);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward on `stream`; returns a cudaError_t (0 = launched).  x and y are
// 16-byte aligned; `lengths` may be null (all T frames valid).  y (B, C, T);
// mean, rstd (B, C).
int adain_snake_fwd_f32(const float* x, const float* gamma, const float* beta,
                        const float* alpha, const int* lengths, float* y, float* mean,
                        float* rstd, int batch, int c, int t, int device, void* stream) {
  if (batch < 1 || c < 1 || t < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const FwdArgs a{x, gamma, beta, alpha, lengths, y, mean, rstd, batch * c, c, t};
  return (int)launch_fwd(a, device, static_cast<cudaStream_t>(stream));
}

// Backward on `stream`; returns a cudaError_t.  x, dy and dx are 16-byte
// aligned.  dx (B, C, T); dgamma, dbeta and the per-row dalpha (B, C).
int adain_snake_bwd_f32(const float* x, const float* gamma, const float* beta,
                        const float* alpha, const float* mean, const float* rstd,
                        const int* lengths, const float* dy, float* dx, float* dgamma,
                        float* dbeta, float* dalpha, int batch, int c, int t, int device,
                        void* stream) {
  if (batch < 1 || c < 1 || t < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const BwdArgs a{x,  gamma,  beta,  alpha,  mean,      rstd, lengths, dy,
                  dx, dgamma, dbeta, dalpha, batch * c, c,    t};
  return (int)launch_bwd(a, device, static_cast<cudaStream_t>(stream));
}

// The path a row of t frames takes: *path 0 = rows (with *threads and
// *vecs), 1 = long with the shared-memory cache, 2 = long re-reading device
// memory.  Returns a cudaError_t.
int adain_snake_plan(int t, int backward, int device, int* path, int* threads, int* vecs) {
  if (t < 1) return (int)cudaErrorInvalidValue;
  const int i = plan_index(backward ? BWD_PLANS : FWD_PLANS, t);
  if (i >= 0) {
    const Plan& p = (backward ? BWD_PLANS : FWD_PLANS)[i];
    *path = 0;
    *threads = p.threads;
    *vecs = p.vecs;
    return 0;
  }
  int cached = 0;
  size_t smem = 0;
  cudaError_t err = long_cache(device, t, &cached, &smem);
  if (err != cudaSuccess) return (int)err;
  *path = cached ? 1 : 2;
  *threads = LONG_THREADS;
  *vecs = 0;
  return 0;
}

}  // extern "C"
