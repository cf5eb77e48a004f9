#!/usr/bin/env python3
"""The latency floor of kernel K3 (csrc/maximum_path.cu) on one card.

    python3 scripts/torch_k3_latency.py

On a machine with an NVIDIA GPU and nvcc, from the root of a checkout.  K3
is a chain of dependent steps, one chain per batch element, the chains in
parallel on their own SMs: T_mel forward frames, each a shared-memory read
of the previous row beside a read of the frame's values, two f32
operations, a shared-memory write and a block barrier; then T_mel
backtrack steps in one thread, each two reads of the row the block stored
at an index the previous step decided.  The script builds one kernel that
runs K3's body for one batch element, as written there, 128 times in a row
on one SM, each pass over planes of its own that lie in L2 and not in L1
when it starts (as K3 finds the values another kernel wrote), once with
the backtrack and once without.  CUDA events over the two give the time of
one forward frame (the path's zero fill included) and of one backtrack
step; the script prints both, the floor ``T_mel * (frame + backtrack)`` at
chip_smoke's K3 shape (16, 128, 104), and K3's own device time there
(``chip_smoke.cuda_ms``), after the card's name, power limit and SM clock.
The build goes to styletts2_tpu_torch/_build/.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>

constexpr float NEG_INF = -1e9f;

// K3's body for one batch element (full lengths), as written there, once
// over each of `reps` planes of its own: values (t_text, t_mel) in L2 and
// not in L1 when the pass starts, as K3 finds the values another kernel
// wrote; rows (t_mel, t_text) and path (t_text, t_mel) written in the pass.
// With `backtrack` 0 the pass stops before the backtrack.
__global__ void k3_passes(const float* __restrict__ values, float* __restrict__ rows,
                          float* __restrict__ path, int t_text, int t_mel, int reps,
                          int backtrack) {
  extern __shared__ float buf[];
  for (int rep = 0; rep < reps; ++rep) {
    float* prev = buf;
    float* cur = buf + t_text;
    const float* vb = values + (size_t)rep * t_text * t_mel;
    float* rb = rows + (size_t)rep * t_mel * t_text;
    float* pb = path + (size_t)rep * t_text * t_mel;
    for (int x = threadIdx.x; x < t_text; x += blockDim.x) prev[x] = NEG_INF;
    __syncthreads();
    for (int y = 0; y < t_mel; ++y) {
      for (int x = threadIdx.x; x < t_text; x += blockDim.x) {
        const float stay = (x == y) ? NEG_INF : prev[x];
        const float adv = (x == 0) ? NEG_INF : prev[x - 1];
        float best = fmaxf(stay, adv);
        if (y == 0 && x == 0) best = 0.f;
        if (x > y) best = NEG_INF;
        const float r = best + vb[(size_t)x * t_mel + y];
        cur[x] = r;
        rb[(size_t)y * t_text + x] = r;
      }
      __syncthreads();
      float* tmp = prev;
      prev = cur;
      cur = tmp;
    }
    for (size_t i = threadIdx.x; i < (size_t)t_text * t_mel; i += blockDim.x) pb[i] = 0.f;
    __syncthreads();
    if (backtrack && threadIdx.x == 0) {
      int idx = 0;
      for (int y = t_mel - 1; y >= 0; --y) {
        if (y == t_mel - 1) idx = t_text - 1;
        if (idx >= 0 && idx < t_text) pb[(size_t)idx * t_mel + y] = 1.f;
        float v_at = NEG_INF, v_left = NEG_INF;
        if (y > 0 && idx >= 0 && idx < t_text) {
          const float* rp = rb + (size_t)(y - 1) * t_text;
          v_at = rp[idx];
          v_left = rp[idx > 0 ? idx - 1 : 0];
        }
        if (idx != 0 && (idx == y || v_at < v_left)) idx -= 1;
      }
    }
    __syncthreads();
  }
}

extern "C" int run(int backtrack, const float* values, float* rows, float* path,
                   int t_text, int t_mel, int reps, void* stream) {
  k3_passes<<<1, ((t_text + 31) / 32) * 32, 2 * t_text * sizeof(float),
              (cudaStream_t)stream>>>(values, rows, path, t_text, t_mel, reps, backtrack);
  return (int)cudaGetLastError();
}
"""

B, T_TEXT, T_MEL = 16, 128, 104          # chip_smoke's K3 shape
REPS = 128               # passes, each over planes of its own: 6.8 MB a buffer, in L2


def main() -> None:
    import torch
    from chip_smoke import cuda_ms
    from styletts2_tpu_torch.kernels import build
    from styletts2_tpu_torch.kernels import maximum_path as KM

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib_path = build.BUILD_DIR / "k3_latency.cu", build.BUILD_DIR / "libk3_latency.so"
    src.write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0], flush=True)

    g = torch.Generator("cuda").manual_seed(0)
    v = torch.rand((REPS, T_TEXT, T_MEL), generator=g, device="cuda")
    rows = torch.rand((REPS, T_MEL, T_TEXT), generator=g, device="cuda")
    path = torch.zeros((REPS, T_TEXT, T_MEL), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    pass_ns = []
    for backtrack in (0, 1):
        for _ in range(2):                      # the first launch warms up
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            rc = lib.run(backtrack, v.data_ptr(), rows.data_ptr(), path.data_ptr(), T_TEXT,
                         T_MEL, REPS, stream)
            stop.record()
            stop.synchronize()
            if rc != 0:
                sys.exit(f"launch failed, cudaError_t {rc}")
        pass_ns.append(1e6 * start.elapsed_time(stop) / REPS)
    step_ns = {"forward frame": pass_ns[0] / T_MEL,
               "backtrack step": (pass_ns[1] - pass_ns[0]) / T_MEL}
    for name, ns in step_ns.items():
        print(f"{name}: {ns:.2f} ns ({REPS} passes of {T_MEL})", flush=True)
    floor_ms = T_MEL * sum(step_ns.values()) / 1e6
    values = torch.rand((B, T_TEXT, T_MEL), generator=g, device="cuda")
    ml = torch.randint(40, T_MEL + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    tl = torch.minimum(torch.randint(20, T_TEXT + 1, (B,), generator=g, device="cuda",
                                     dtype=torch.int32), ml)
    k3_ms = cuda_ms(lambda: KM.maximum_path(values, tl, ml), device_only=True)
    print(f"K3 latency floor at (B, T_text, T_mel) = ({B}, {T_TEXT}, {T_MEL}): "
          f"{T_MEL} x ({step_ns['forward frame']:.2f} + {step_ns['backtrack step']:.2f}) ns "
          f"= {floor_ms:.4f} ms; K3 device time {k3_ms:.4f} ms "
          f"({floor_ms / k3_ms:.2f} of it is the floor)", flush=True)


if __name__ == "__main__":
    main()
