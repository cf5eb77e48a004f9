// Monotonic maximum path (the Viterbi alignment of stage-1 training) for
// Hopper (sm_90a), f32.
//
// Replaces styletts2_tpu/ops/pallas/monotonic_kernel.py::maximum_path_pallas
// (body _kernel) and is bit-exact with styletts2_tpu/ops/monotonic.py::
// maximum_path.  For one batch element with text length L and mel length M,
// over values v (T_text, T_mel), NEG = -1e9:
//
//   forward, frame y = 0 .. T_mel-1, token x:
//     stay  = (x == y) ? NEG : row[y-1][x]          (row[-1] = NEG everywhere)
//     adv   = (x == 0) ? NEG : row[y-1][x-1]
//     best  = max(stay, adv);  best = 0 at (0, 0);  best = NEG where x > y
//     row[y][x] = (x < L) ? best + v[x][y] : NEG
//   backtrack, y = T_mel-1 .. 0, from idx = 0:
//     idx = L-1 at y == M-1;  path[idx][y] = 1 where y < M;
//     idx -= 1 if y < M, idx != 0 and (idx == y or row[y-1][idx] < row[y-1][idx-1])
//
// The additions are the same f32 `best + v` as the reference, and the tie
// rule is the reference's strict `<`, so the path equals it bit for bit.
//
// What bounds it.  The work is tiny (B * T_text * T_mel cells, 16 x 128 x
// 104 at the stage-1 width) and moves 4 * 2 * B*T_text*T_mel bytes; what
// bounds it is latency: T_mel dependent frame steps, each a barrier, and a
// backtrack of T_mel dependent scalar steps.
//
// What this design does about it.  One block per batch element, the text
// axis across threads, frames in sequence with one barrier per frame; the
// previous frame's row stays in shared memory and every row goes to a global
// scratch (B, T_mel, T_text) for the backtrack, which one thread walks.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e9f;
constexpr int MAX_THREADS = 1024;

// grid: one block per batch element; dynamic shared memory 2 * T_text floats.
__global__ void maximum_path_kernel(const float* __restrict__ values,
                                    const int* __restrict__ text_lengths,
                                    const int* __restrict__ mel_lengths,
                                    float* __restrict__ rows, float* __restrict__ path,
                                    int t_text, int t_mel) {
  extern __shared__ float buf[];
  float* prev = buf;
  float* cur = buf + t_text;
  const int b = blockIdx.x;
  const int text_len = text_lengths[b], mel_len = mel_lengths[b];
  const float* vb = values + (size_t)b * t_text * t_mel;
  float* rb = rows + (size_t)b * t_mel * t_text;
  float* pb = path + (size_t)b * t_text * t_mel;

  for (int x = threadIdx.x; x < t_text; x += blockDim.x) prev[x] = NEG_INF;
  __syncthreads();
  for (int y = 0; y < t_mel; ++y) {
    for (int x = threadIdx.x; x < t_text; x += blockDim.x) {
      const float stay = (x == y) ? NEG_INF : prev[x];
      const float adv = (x == 0) ? NEG_INF : prev[x - 1];
      float best = fmaxf(stay, adv);
      if (y == 0 && x == 0) best = 0.f;
      if (x > y) best = NEG_INF;
      const float r = (x < text_len) ? best + vb[(size_t)x * t_mel + y] : NEG_INF;
      cur[x] = r;
      rb[(size_t)y * t_text + x] = r;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  for (size_t i = threadIdx.x; i < (size_t)t_text * t_mel; i += blockDim.x) pb[i] = 0.f;
  __syncthreads();  // the rows and the zeroed path are visible to thread 0

  if (threadIdx.x == 0) {
    int idx = 0;
    for (int y = t_mel - 1; y >= 0; --y) {
      if (y == mel_len - 1) idx = text_len - 1;
      const bool active = y < mel_len;
      if (active && idx >= 0 && idx < t_text) pb[(size_t)idx * t_mel + y] = 1.f;
      float v_at = NEG_INF, v_left = NEG_INF;
      if (y > 0 && idx >= 0 && idx < t_text) {
        const float* rp = rb + (size_t)(y - 1) * t_text;
        v_at = rp[idx];
        v_left = rp[idx > 0 ? idx - 1 : 0];
      }
      if (active && idx != 0 && (idx == y || v_at < v_left)) idx -= 1;
    }
  }
}

}  // namespace

extern "C" {

// Launches the DP and backtrack on `stream`; returns cudaGetLastError().
// values (B, T_text, T_mel) f32; lengths (B,) i32; rows (B, T_mel, T_text)
// f32 scratch; path (B, T_text, T_mel) f32 out.
int maximum_path_f32(const float* values, const int* text_lengths, const int* mel_lengths,
                     float* rows, float* path, int batch, int t_text, int t_mel, int device,
                     void* stream) {
  if (batch < 1 || t_text < 1 || t_mel < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)t_text * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int threads = ((t_text + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  maximum_path_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      values, text_lengths, mel_lengths, rows, path, t_text, t_mel);
  return (int)cudaGetLastError();
}

}  // extern "C"
