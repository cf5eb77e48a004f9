#!/usr/bin/env python3
"""Where the time of the MRF round kernel (csrc/mrf_round.cu) goes.

    python3 scripts/torch_mrf_ablate.py

On a machine with an NVIDIA GPU and nvcc, from the root of a checkout: builds
the kernel as it is and in variants that each leave out one part, times every
build at the generator's round shapes (batch 1 at frame capacity 200, batch
4 at 1600, k=11 d=5, and k=3 d=1), and prints each time beside the 3xTF32
bound with the variant's max |y - plain| / max |y|.  Only the unchanged
kernel computes the round; a variant's time says how much the part it leaves
out costs where it does not overlap with the rest:

- ``no_activation``: AdaIN + Snake (the sine) skipped, the planes written 0;
- ``no_epilogue``: no residual, no stores of y, no statistics;
- ``no_mma``: no wgmma (each tap touches the accumulators once);
- ``one_product``: hi*hi only (1xTF32) instead of the three products;
- ``no_weight_loads``: the weights of chunks 0 and 1 only.

Builds go to styletts2_tpu_torch/_build/ablate/.
"""

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MMA3 = """      tf32::mma<NT>(acc, a_lo[kk], b_hi);  // smallest products first
      tf32::mma<NT>(acc, a_hi[kk], b_lo);
      tf32::mma<NT>(acc, a_hi[kk], b_hi);"""
VARIANTS = {
    "kernel": [],
    "no_activation": [("      if (p >= 0 && p < t) {\n        const float u",
                       "      if (p >= 0 && p < t && p < 0) {\n        const float u")],
    "no_epilogue": [("  for (int n = warp; n < CO_TILE; n += THREADS / 32) {",
                     "  for (int n = warp; n < CO_TILE * 0; n += THREADS / 32) {"),
                    ("  if (residual != nullptr) {  // the residual tile",
                     "  if (residual != nullptr && t < 0) {  // the residual tile")],
    "no_mma": [(MMA3, "      acc[kk] += __uint_as_float(a_lo[kk][0] ^ a_hi[kk][1] ^ "
                      "(uint32_t)b_hi ^ (uint32_t)b_lo);")],
    "one_product": [(MMA3, "      tf32::mma<NT>(acc, a_hi[kk], b_hi);")],
    "no_weight_loads": [("    for (int i = tid; i < K * CO_TILE * 2; i += THREADS) {",
                         "    if (chunk < 2) for (int i = tid; i < K * CO_TILE * 2; "
                         "i += THREADS) {")],
}
SHAPES = ((1, 256, 4000, 11, 5), (1, 128, 24000, 11, 5), (4, 256, 32000, 11, 5),
          (4, 128, 192000, 11, 5), (4, 128, 192000, 3, 1))


def main() -> None:
    import torch
    from chip_smoke import cuda_ms
    from styletts2_tpu_torch.kernels import build
    from styletts2_tpu_torch.kernels import mrf_round as K

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / "mrf_round.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                sys.exit(f"{name}: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.mrf_round_f32.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.mrf_round_f32.restype = ctypes.c_int
        libs[name] = lib
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip().splitlines()[0])

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    for b, c, t, k, d in SHAPES:
        x = torch.randn((b, c, t), generator=g, device=dev)
        lengths = torch.tensor([t * 4 // 5, t, t // 2, t * 3 // 4][:b], dtype=torch.int32,
                               device=dev)
        gamma = 0.1 * torch.randn((b, c), generator=g, device=dev)
        beta = 0.1 * torch.randn((b, c), generator=g, device=dev)
        alpha = torch.rand((c,), generator=g, device=dev) + 0.5
        w = torch.randn((c, c, k), generator=g, device=dev) / math.sqrt(c * k)
        bias = 0.1 * torch.randn((c,), generator=g, device=dev)
        res = torch.randn((b, c, t), generator=g, device=dev)
        mean, rstd = K.masked_stats(x, lengths)
        args = (x, mean, rstd, gamma, beta, alpha, w, bias, lengths)
        y_ref, _ = K.mrf_round_plain(*args, k=k, d=d, residual=res)
        scale = float(y_ref.abs().max())
        bound = 1e3 * 3 * 2.0 * b * c * c * k * t / 495e12
        line = [f"B={b} C={c} T={t} k={k} d={d}: 3xTF32 bound {bound:.4f} ms"]
        for name, lib in libs.items():
            K._LIB = lib
            y, _ = K.mrf_round(*args, k=k, d=d, residual=res)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max()) / scale
            ms = cuda_ms(lambda: K.mrf_round(*args, k=k, d=d, residual=res))
            line.append(f"{name} {ms:.4f} ms ({err:.1e})")
        print(" | ".join(line), flush=True)
    K._LIB = None


if __name__ == "__main__":
    main()
