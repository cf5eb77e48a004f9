#!/usr/bin/env python3
"""Times every instantiation of the AdaIN -> Snake rows kernels (K1f, K1b)
on one NVIDIA GPU: each (threads per row G, 16-byte vectors per thread V)
that holds the row, at each training row length.

    python3 scripts/torch_k1_tune.py [--quick]

From the root of a checkout, on a machine with a CUDA card and ``nvcc``.
Harness sources that include ``styletts2_tpu_torch/csrc/adain_snake.cu``
launch its rows kernels at any (G, V), so the shipped source keeps no
switch.  Every time is the device's (``chip_smoke.cuda_ms`` with
``device_only``: median of 25 CUDA-event timings, each queued behind a
device sleep), and every timed call is first held against the plain version
(K1f within 1e-5 of max |y|, K1b within 1e-4 of each leaf's largest
gradient).

Prints one line per timing and writes chiprun_out/k1_tune.json.
``--quick`` keeps the two stage-1 training shapes only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FWD = [(32, 16), (64, 8), (128, 4), (256, 2), (128, 8), (256, 4), (512, 2), (256, 12),
       (384, 8), (512, 6), (768, 4), (1024, 3), (512, 12), (768, 8), (1024, 6)]
BWD = [(32, 16), (64, 8), (128, 4), (256, 2), (128, 8), (256, 4), (512, 2), (256, 12),
       (384, 8), (512, 6), (768, 4), (1024, 3), (1024, 4)]
SHAPES = [(16, 256, 1920), (16, 128, 11521), (16, 256, 4000), (16, 128, 24001)]

HEADER = '#include "{src}"\n'

FWD_ENTRY = """
extern "C" int k1_fwd_cfg(int g, int v, const float* x, const float* gamma, const float* beta,
                          const float* alpha, const int* lengths, float* y, float* mean,
                          float* rstd, int rows, int c, int t, void* stream) {{
  const FwdArgs a{{x, gamma, beta, alpha, lengths, y, mean, rstd, rows, c, t}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g * 100 + v) {{
{cases}
    default: return -1;
  }}
}}
"""

BWD_ENTRY = """
extern "C" int k1_bwd_cfg(int g, int v, const float* x, const float* gamma, const float* beta,
                          const float* alpha, const float* mean, const float* rstd,
                          const int* lengths, const float* dy, float* dx, float* dgamma,
                          float* dbeta, float* dalpha, int rows, int c, int t, void* stream) {{
  const BwdArgs a{{x, gamma, beta, alpha, mean, rstd, lengths, dy, dx, dgamma, dbeta, dalpha,
                  rows, c, t}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (g * 100 + v) {{
{cases}
    default: return -1;
  }}
}}
"""


def harness_sources(src: Path) -> dict:
    def cases(cfgs, fn):
        return "\n".join(f"    case {g * 100 + v}: return (int){fn}<{g}, {v}>(a, s);"
                         for g, v in cfgs)
    return {
        "k1_tune_fwd": HEADER.format(src=src) + FWD_ENTRY.format(
            cases=cases(FWD, "launch_fwd_rows")),
        "k1_tune_bwd": HEADER.format(src=src) + BWD_ENTRY.format(
            cases=cases(BWD, "launch_bwd_rows")),
    }


def build_harness():
    """({name: library}, {name: nvcc log}) of the harness sources."""
    from styletts2_tpu_torch.kernels import build

    out_dir = build.BUILD_DIR / "k1_tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in harness_sources(build.CSRC / "adain_snake.cu").items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}.so"
        procs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{logs[name]}")
        libs[name] = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["k1_tune_fwd"].k1_fwd_cfg.argtypes = [i, i] + [p] * 8 + [i] * 3 + [p]
    libs["k1_tune_bwd"].k1_bwd_cfg.argtypes = [i, i] + [p] * 12 + [i] * 3 + [p]
    for lib, fn in ((libs["k1_tune_fwd"], "k1_fwd_cfg"), (libs["k1_tune_bwd"], "k1_bwd_cfg")):
        getattr(lib, fn).restype = i
    return libs, logs


def ptr(t):
    return None if t is None else t.data_ptr()


def main() -> None:
    import torch

    from chip_smoke import bound_ms, cuda_ms
    from styletts2_tpu_torch.kernels import adain_snake as KA

    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_tune: needs a CUDA device")
    argv = sys.argv[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs, logs = build_harness()
    print(f"harness built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log.strip()}", flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(dev).manual_seed(0)
    shapes = SHAPES[:2] if "--quick" in argv else SHAPES
    rows = []
    for b, c, t in shapes:
        x = torch.randn((b, c, t), generator=g, device=dev)
        gamma = 0.3 * torch.randn((b, c), generator=g, device=dev)
        beta = 0.3 * torch.randn((b, c), generator=g, device=dev)
        alpha = 1.0 + 0.3 * torch.rand((c,), generator=g, device=dev)
        dy = torch.randn((b, c, t), generator=g, device=dev)
        lengths = torch.randint(t // 2, t + 1, (b,), generator=g, device=dev, dtype=torch.int32)
        n = b * c * t
        bound = {"fwd": bound_ms(4.0 * (2 * n + 4 * b * c), 14.0 * n)[0],
                 "bwd": bound_ms(4.0 * (3 * n + 6 * b * c), 32.0 * n)[0]}
        y_ref = KA.adain_snake_plain(x, gamma, beta, alpha, lengths)
        mean, rstd = KA.mean_rstd_plain(x, lengths)
        ref = KA.adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd, lengths, dy)
        y, m_, r_ = torch.empty_like(x), torch.empty_like(gamma), torch.empty_like(gamma)
        outs = [torch.empty_like(x)] + [torch.empty_like(gamma) for _ in range(3)]
        plans = {"fwd": KA.plan(t), "bwd": KA.plan(t, backward=True)}
        for direction, cfgs in (("bwd", BWD), ("fwd", FWD)):
            for gg, vv in cfgs:
                if t >> 2 > gg * vv:
                    continue
                if direction == "fwd":
                    def call(lens, gg=gg, vv=vv):
                        return libs["k1_tune_fwd"].k1_fwd_cfg(
                            gg, vv, ptr(x), ptr(gamma), ptr(beta), ptr(alpha), ptr(lens),
                            ptr(y), ptr(m_), ptr(r_), b * c, c, t, stream)
                else:
                    def call(lens, gg=gg, vv=vv):
                        return libs["k1_tune_bwd"].k1_bwd_cfg(
                            gg, vv, ptr(x), ptr(gamma), ptr(beta), ptr(alpha), ptr(mean),
                            ptr(rstd), ptr(lens), ptr(dy), *(ptr(o) for o in outs), b * c, c,
                            t, stream)
                rc = call(lengths)                # masked, against the plain version
                torch.cuda.synchronize()
                if direction == "fwd":
                    err = float((y - y_ref).abs().max()) / float(y_ref.abs().max())
                    ok = rc == 0 and err <= 1e-5
                else:
                    err = max(float((o - r).abs().max()) / float(r.abs().max())
                              for o, r in zip(outs, ref))
                    ok = rc == 0 and err <= 1e-4
                ms = cuda_ms(lambda: call(None), device_only=True) if ok else float("nan")
                shipped = plans[direction] == f"rows {gg}x{vv}"
                rows.append({"shape": [b, c, t], "dir": direction, "threads": gg, "vecs": vv,
                             "shipped": shipped, "ok": ok, "rel_err": err, "ms": ms,
                             "bound_ms": bound[direction],
                             "bound_share": bound[direction] / ms if ok else None})
                print(f"{direction} B={b} C={c} T={t} rows {gg}x{vv}"
                      f"{' (shipped)' if shipped else ''}: {ms:.4f} ms (bound "
                      f"{bound[direction]:.4f}, share {bound[direction] / ms:.3f}), rel err "
                      f"{err:.2e}{'' if ok else ' FAILED'}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k1_tune.json").write_text(json.dumps(
        {"card": smi, "rows": rows, "nvcc_logs": logs}, indent=1))
    if not all(r["ok"] for r in rows):
        raise SystemExit("torch_k1_tune: a plan disagrees with the plain version")


if __name__ == "__main__":
    main()
