#!/usr/bin/env python3
"""Peak TF32 rates of the tensor-core instructions behind csrc/mrf_round.cu.

    python3 scripts/torch_mma_peak.py

On a machine with an NVIDIA GPU and nvcc, from the root of a checkout: builds
two kernels that issue tensor-core products with no loads, each into
independent accumulators, and prints their rate in TFLOP/s for a few grid
shapes, after the card's name and power limit:

- ``mma.sync.m16n8k8`` TF32, the warp MMA (eight accumulators per warp);
- ``wgmma.mma_async m64n128k8`` TF32 with A in registers and B in shared
  memory at the MRF round's descriptor strides, 33 products (3 per tap, 11
  taps) per commit, as csrc/tf32_wgmma.cuh issues them.

A third of either rate is the ceiling of the port's 3xTF32 MRF round, in
f32-accurate products, against the data sheet's 495 TFLOP/s.  The build
goes to styletts2_tpu_torch/_build/.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32_wgmma.cuh"

__global__ void mma_sync_peak(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4], b[2];
  for (int j = 0; j < 4; ++j) a[j] = __float_as_uint(threadIdx.x * 1e-3f + j);
  b[0] = a[1];
  b[1] = a[2];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void wgmma_peak(float* out, int iters) {
  extern __shared__ __align__(128) float sm[];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) sm[i] = 1e-3f * (i & 7);
  __syncthreads();
  float acc[64];
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t a[4];
  for (int j = 0; j < 4; ++j) a[j] = __float_as_uint(1e-3f * (threadIdx.x + j));
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(sm));
  for (int it = 0; it < iters; ++it) {
    tf32::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 11; ++k) {
      const uint64_t b = tf32::desc(base + 16 * 5 * k, 3136, 128);
      tf32::mma<128>(acc, a, b);
      tf32::mma<128>(acc, a, b);
      tf32::mma<128>(acc, a, b);
    }
    tf32::wgmma_commit();
    tf32::wgmma_wait<0>();
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int peak(int which, float* out, int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (which == 0) {
    mma_sync_peak<<<blocks, threads, 0, s>>>(out, iters);
  } else {
    cudaFuncSetAttribute(wgmma_peak, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
    wgmma_peak<<<blocks, threads, 65536, s>>>(out, iters);
  }
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    import torch
    from styletts2_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = build.BUILD_DIR / "tc_peak.cu", build.BUILD_DIR / "libtc_peak.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(lib_path), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.peak.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    runs = [(0, "mma.sync m16n8k8", b, th, 4096, 8 * 16 * 8 * 8 // 1)
            for b, th in ((2 * sms, 256), (4 * sms, 256))]
    runs += [(1, "wgmma m64n128k8", b, th, 200, 33 * 64 * 128 * 8 // 4)
             for b, th in ((sms, 256), (2 * sms, 256), (sms, 384))]
    for which, name, blocks, threads, iters, fma_per_warp_iter in runs:
        out = torch.empty(blocks * threads, device="cuda")
        for _ in range(2):                      # the first launch warms up
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            rc = lib.peak(which, out.data_ptr(), blocks, threads, iters, stream)
            stop.record()
            stop.synchronize()
        if rc != 0:
            sys.exit(f"{name}: launch failed, cudaError_t {rc}")
        flop = 2 * blocks * (threads // 32) * iters * fma_per_warp_iter
        print(f"{name} TF32, {blocks} blocks x {threads} threads: "
              f"{flop / start.elapsed_time(stop) / 1e9:.1f} TFLOP/s")


if __name__ == "__main__":
    main()
