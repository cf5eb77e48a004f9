#!/usr/bin/env python3
"""Whether the one-block-per-row AdaIN -> Snake backward that K1b had
before its rows path (one 256-thread block per row, dxh cached in shared
memory, two sinf per frame, a second pass that re-reads x) re-read x from
device memory or from L2, on one NVIDIA GPU.

    python3 scripts/torch_k1_l2_probe.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``.
That kernel is built here with its second pass reading x from a second
pointer and timed at (16, 128, 11521) after an L2 flush before each call:
once with that pointer on x itself (the kernel as it was) and once on a
copy of x that the flush left out of L2, in turns.  A copy no slower says
the re-read came from device memory; a full re-read from device memory
costs 0.028 ms at the byte rate.  Each call is first held against the
plain closed form (1e-4 of each leaf's largest gradient).  Prints one line
per timing and writes chiprun_out/k1_l2_probe.json.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# The backward as it stood before the rows path, but for the pointer `x2`
# that its second pass reads x from.
PARENT_BWD = r"""
#include <cuda_runtime.h>
namespace {
constexpr int THREADS = 256, WARPS = THREADS / 32;
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*red)[WARPS]) {
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
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
__global__ void __launch_bounds__(THREADS)
parent_bwd(const float* __restrict__ x, const float* __restrict__ x2,
           const float* __restrict__ gamma, const float* __restrict__ beta,
           const float* __restrict__ alpha, const float* __restrict__ mean_in,
           const float* __restrict__ rstd_in, const float* __restrict__ dy,
           float* __restrict__ dx, float* __restrict__ dgamma, float* __restrict__ dbeta,
           float* __restrict__ dalpha, int c, int t) {
  extern __shared__ float cache[];
  __shared__ float red[5][WARPS];
  const int row = blockIdx.x, ch = row % c;
  const float* xr = x + (size_t)row * t;
  const float* x2r = x2 + (size_t)row * t;
  const float* dyr = dy + (size_t)row * t;
  float* dxr = dx + (size_t)row * t;
  const float n = (float)t;
  const float mean = mean_in[row], rstd = rstd_in[row];
  const float g1 = 1.f + gamma[row], be = beta[row], a = alpha[ch];
  const float inv_a = 1.f / a;
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
    cache[i] = dxh;
  }
  block_sum<5>(acc, red);
  const float s1 = acc[3] / n, s2 = acc[4] / n;
  for (int i = threadIdx.x; i < t; i += THREADS) {
    const float xh = (x2r[i] - mean) * rstd;
    dxr[i] = rstd * (cache[i] - (s1 + xh * s2));
  }
  if (threadIdx.x == 0) {
    dalpha[row] = acc[0];
    dbeta[row] = acc[1];
    dgamma[row] = acc[2];
  }
}
}  // namespace
extern "C" int parent_bwd_x2(const float* x, const float* x2, const float* gamma,
                             const float* beta, const float* alpha, const float* mean,
                             const float* rstd, const float* dy, float* dx, float* dgamma,
                             float* dbeta, float* dalpha, int rows, int c, int t, void* stream) {
  const int smem = t * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(parent_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  parent_bwd<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, x2, gamma, beta, alpha, mean, rstd, dy, dx, dgamma, dbeta, dalpha, c, t);
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    import torch

    from chip_smoke import SLEEP_CYCLES
    from styletts2_tpu_torch.kernels import adain_snake as KA
    from styletts2_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_l2_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out_dir = build.BUILD_DIR / "k1_l2_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "parent_bwd.cu", out_dir / "libparent_bwd.so"
    cu.write_text(PARENT_BWD)
    log = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{log.stdout}{log.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.parent_bwd_x2.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.parent_bwd_x2.restype = ctypes.c_int

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(dev).manual_seed(0)
    b, c, t = 16, 128, 11521
    x = torch.randn((b, c, t), generator=g, device=dev)
    xcopy = x.clone()
    gamma = 0.3 * torch.randn((b, c), generator=g, device=dev)
    beta = 0.3 * torch.randn((b, c), generator=g, device=dev)
    alpha = 1.0 + 0.3 * torch.rand((c,), generator=g, device=dev)
    dy = torch.randn((b, c, t), generator=g, device=dev)
    mean, rstd = KA.mean_rstd_plain(x, None)
    outs = [torch.empty_like(x)] + [torch.empty_like(gamma) for _ in range(3)]
    ref = KA.adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd, None, dy)
    flush = torch.empty(64 << 20, device=dev)     # 256 MB, five times the L2
    result = {}
    for name, x2 in (("re-read x", x), ("read a copy", xcopy), ("read a copy, again", xcopy),
                     ("re-read x, again", x)):
        times = []
        for _ in range(15):
            flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.parent_bwd_x2(*(a.data_ptr() for a in (x, x2, gamma, beta, alpha, mean,
                                                            rstd, dy, *outs)),
                                   b * c, c, t, stream)
            stop.record()
            stop.synchronize()
            if rc != 0:
                raise SystemExit(f"parent_bwd_x2 failed: cudaError_t {rc}")
            times.append(start.elapsed_time(stop))
        err = max(float((o - r).abs().max()) / float(r.abs().max()) for o, r in zip(outs, ref))
        if err > 1e-4:
            raise SystemExit(f"parent_bwd_x2 ({name}) disagrees with the closed form: {err}")
        result[name] = {"ms": statistics.median(times), "rel_err": err}
        print(f"backward before the rows path, L2 flushed, second pass {name}: "
              f"{result[name]['ms']:.4f} ms (rel err {err:.2e})", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k1_l2_probe.json").write_text(json.dumps(
        {"card": smi, "shape": [b, c, t], "timings": result}, indent=1))


if __name__ == "__main__":
    main()
