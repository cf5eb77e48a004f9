#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports nothing of JAX or of ``styletts2_tpu``.
Phases, each of which exits non-zero when it fails:

1. build: compile every CUDA source of ``styletts2_tpu_torch/csrc`` for
   sm_90a (one nvcc per source, all started together);
2. kernels: hold each kernel against its plain PyTorch version at the
   shapes the serving path gives it, and time both;
3. serve: build the full-width LJSpeech port with seeded random weights,
   answer a batched, a single and a classifier-free-guided request through
   ``InferenceEngine.synthesize``, count the kernels' launches in each, and
   hold the fused decoder against the plain one on the same inputs;
4. print the kernels line, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.  ``--profile`` adds a
torch.profiler breakdown of a batched and a single request to the serve phase.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores
SEED = 0
STEPS = 5
PHONEMES = [                     # LJSpeech-style IPA, four lengths
    "ðɪ ɛkstɹə pɹɛʃɚ wʌz sʌdn̩.",
    "ɪn ðə jɪɹ eɪtiːn θɜːɾi tuː, ðə pɹɛs wʌz moʊst ɪmpɔːɹtənt.",
    "hiː sɛd ðæt ðə ɹɪpɔːɹt wʌz ɹɛdi.",
    "ðə kʌmɪʃən ɹɪvjuːd ðə ɛvɪdəns ɪn dɪteɪl, ænd faʊnd ðæt ðə wɪtnəsᵻz əɡɹiːd.",
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` launches of CUDA-event time, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_kernels(torch, K):
    """mrf_round against mrf_round_plain at the generator's two stage shapes
    (frame capacity 200, batch 1, the widest round: k=11, d=5)."""
    import torch.nn.functional as F
    from styletts2_tpu_torch.nn.activations import snake

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for stage, c, t in (("stage0", 256, 4000), ("stage1", 128, 24000)):
        k, d, b = 11, 5, 1
        x = torch.randn((b, c, t), generator=g, device=dev)
        lengths = torch.tensor([t * 4 // 5], dtype=torch.int32, device=dev)
        gamma = 0.1 * torch.randn((b, c), generator=g, device=dev)
        beta = 0.1 * torch.randn((b, c), generator=g, device=dev)
        alpha = torch.rand((c,), generator=g, device=dev) + 0.5
        w = torch.randn((c, c, k), generator=g, device=dev) / math.sqrt(c * k)
        bias = 0.1 * torch.randn((c,), generator=g, device=dev)
        res = torch.randn((b, c, t), generator=g, device=dev)
        mean, rstd = K.masked_stats(x, lengths)
        args = (x, mean, rstd, gamma, beta, alpha, w, bias, lengths)
        for residual in (None, res):
            y, parts = K.mrf_round(*args, k=k, d=d, residual=residual)
            torch.cuda.synchronize()
            y_ref, parts_ref = K.mrf_round_plain(*args, k=k, d=d, residual=residual)
            err = float((y - y_ref).abs().max())
            scale = float(y_ref.abs().max())
            check(err <= 1e-4 * scale, f"mrf_round {stage}: max|err| {err} > 1e-4 * {scale}")
            for got, want in zip(K.stats_from_partials(parts, lengths, t),
                                 K.stats_from_partials(parts_ref, lengths, t)):
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            rows.append({"stage": stage, "residual": residual is not None,
                         "max_abs_err": err, "max_abs_y": scale})
        act = snake((1 + gamma[:, :, None]) * ((x - mean[:, :, None]) * rstd[:, :, None])
                    + beta[:, :, None], alpha[None, :, None])
        pad = (k * d - d) // 2
        ms = cuda_ms(lambda: K.mrf_round(*args, k=k, d=d, residual=res))
        plain_ms = cuda_ms(lambda: K.mrf_round_plain(*args, k=k, d=d, residual=res))
        library_ms = cuda_ms(lambda: F.conv1d(act, w, bias, padding=pad, dilation=d))
        flops = 2.0 * b * c * c * k * t
        nbytes = 4.0 * (3 * b * c * t + c * c * k + 4 * b * c + 2 * c + b
                        + b * K.n_tiles(t) * 3 * c)
        bound_ms = 1e3 * max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
        rows.append({"stage": stage, "shape": f"B={b} C={c} T={t} k={k} d={d} +residual",
                     "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": "operations"
                     if flops / F32_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes",
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"mrf_round {stage} (B={b} C={c} T={t} k={k} d={d}): {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, F.conv1d {library_ms:.4f} ms, bound {bound_ms:.4f} ms",
              flush=True)
    return rows


def log_mel(torch, wav):
    """The JAX package's dataset log-mel (n_fft 2048, win 1200, hop 300, 80
    HTK mels at the 16 kHz filterbank rate)."""
    import numpy as np

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    freqs = np.linspace(0.0, 8000.0, 1025)
    f_pts = 700.0 * (10.0 ** (np.linspace(hz_to_mel(0.0), hz_to_mel(8000.0), 82) / 2595.0) - 1.0)
    slopes = f_pts[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / np.diff(f_pts)[:-1],
                                    slopes[:, 2:] / np.diff(f_pts)[1:])).astype(np.float32)
    spec = torch.stft(wav, 2048, 300, 1200, window=torch.hann_window(1200, device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    mel = torch.matmul(spec.abs().pow(2).transpose(-1, -2), torch.from_numpy(fb).to(wav.device))
    return (torch.log(1e-5 + mel) + 4.0) / 4.0


def parity_envelope(torch, a, b):
    """PARITY.md's waveform envelope between two runs of one waveform."""
    err = (a - b).abs()
    head, body = err[:700], err[700:]
    out = {"head_max": float(head.max()), "body_max": float(body.max()) if len(body) else 0.0,
           "body_over_5e-3": int((body > 5e-3).sum()),
           "body_mean": float(body.mean()) if len(body) else 0.0,
           "log_mel_l1": float((log_mel(torch, a) - log_mel(torch, b)).abs().mean())}
    ok = (out["head_max"] < 0.35 and out["body_max"] < 8e-3 and out["body_over_5e-3"] <= 10
          and out["body_mean"] < 2e-3 and out["log_mel_l1"] < 1e-2)
    return ok, out


def profile_request(torch, call):
    """Device time by kernel over one call (torch.profiler), and the share of
    the call's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and ev.device_type.name == "CUDA":
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    mrf_ms = sum(ms for name, ms in kernels.items() if "mrf_round_kernel" in name)
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
           "mrf_round_ms": mrf_ms, "mrf_round_share": mrf_ms / max(device_ms, 1e-9),
           "top": [[name[:80], ms] for name, ms in top]}
    print(f"profile: {out}", flush=True)
    return out


def phase_serve(torch, K, profile=False):
    import numpy as np
    from styletts2_tpu_torch.config import ModelParams
    from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
    from styletts2_tpu_torch.models.decoder.istftnet import decoder_apply
    from styletts2_tpu_torch.models.plbert import PLBertConfig
    from styletts2_tpu_torch.models.zoo import build_nets, init_random_

    mp, pl = ModelParams(), PLBertConfig()
    nets = init_random_(build_nets(mp, pl, decoder_width=1024, decoder_asr_res_ch=64), SEED)
    # Random weights drive the log-magnitude head far above what trained
    # checkpoints give, and exp() of it swamps any absolute comparison; scale
    # the head's projection toward unit magnitudes (tests/test_e2e_parity.py
    # nudges its random weights the same way).
    with torch.no_grad():
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    n_params = sum(p.numel() for p in nets.parameters())
    eng = InferenceEngine(nets, mp, pl)                       # device: the GPU
    check(eng.device.type == "cuda", f"engine on {eng.device}")

    def request(texts, **kw):
        K.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.synthesize(texts, diffusion_steps=STEPS, return_durations=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launches
        wavs, durs = out
        if isinstance(wavs, np.ndarray):
            wavs, durs = [wavs], [durs]
        for w, dur in zip(wavs, durs):
            check(bool(np.isfinite(w).all()), "non-finite waveform")
            check(len(w) == int(np.sum(dur)) * SAMPLES_PER_FRAME,
                  f"waveform length {len(w)} != sum(pred_dur) * 600")
        check(launches == 48, f"mrf_round launched {launches} times, not 48, in one call")
        audio_s = sum(len(w) for w in wavs) / 24000.0
        return {"batch": len(wavs), "launches": launches, "wall_s": wall,
                "audio_s": audio_s, "frames": [int(np.sum(dur)) for dur in durs],
                "max_abs_wav": max(float(np.abs(w).max()) for w in wavs)}

    request(PHONEMES)                                          # warm call
    runs = {"batched": request(PHONEMES), "single": request(PHONEMES[2]),
            "cfg_scale_2": request(PHONEMES[1], embedding_scale=2.0)}
    if profile:
        runs["profile_batched"] = profile_request(
            torch, lambda: eng.synthesize(PHONEMES, diffusion_steps=STEPS))
        runs["profile_single"] = profile_request(
            torch, lambda: eng.synthesize(PHONEMES[2], diffusion_steps=STEPS))
    b = runs["batched"]
    b["audio_s_per_s"] = b["audio_s"] / b["wall_s"]
    for name, r in runs.items():
        print(f"serve {name}: {r}", flush=True)
    print(f"serve: {b['audio_s_per_s']:.2f} audio-s/s (batch {b['batch']}, "
          f"{b['audio_s']:.3f} s of audio in {b['wall_s']:.6f} s)", flush=True)

    # the fused decoder (kernel) against the plain one on the same inputs
    with torch.inference_mode():
        tokens, lengths_np = eng.tokenize(PHONEMES)
        lengths = torch.from_numpy(lengths_np).to(eng.device)
        gen = torch.Generator(eng.device).manual_seed(SEED)
        shape = (len(PHONEMES), 1, 2 * mp.style_dim)
        noise = torch.randn(shape, generator=gen, device=eng.device)
        step_noise = torch.randn((STEPS - 1, *shape), generator=gen, device=eng.device)
        t_en, d, s, ref, _, pred_dur = eng._frontend(tokens, lengths, noise, step_noise,
                                                     STEPS, 1.0, None, 0.0)
        frames = pred_dur.sum(1).cpu().numpy()
        t_mel = eng.frame_capacity(int(lengths_np.max()), int(frames.max()))
        asr, f0, n, fr = eng._decoder_inputs(t_en, d, s, pred_dur, lengths, t_mel)
        dec = nets["decoder"]
        K.launches = 0
        fused = decoder_apply(dec, asr, f0, n, ref, lengths=fr, fused=True)[:, 0]
        check(K.launches == 48, f"fused decoder launched mrf_round {K.launches} times")
        plain = decoder_apply(dec, asr, f0, n, ref, lengths=fr, fused=False)[:, 0]
    parity = []
    for i in range(len(PHONEMES)):
        m = int(frames[i]) * SAMPLES_PER_FRAME
        ok, env = parity_envelope(torch, fused[i, :m].float(), plain[i, :m].float())
        env["max_abs_wav"] = float(plain[i, :m].abs().max())
        parity.append(env)
        check(ok, f"fused vs plain decoder outside the PARITY envelope: {env}")
    print(f"serve kernel-vs-plain decoder: {parity}", flush=True)
    return {"params": n_params, "runs": runs, "decoder_parity": parity, "t_mel": t_mel}


def main() -> None:
    if not (ROOT / "styletts2_tpu_torch" / "__init__.py").is_file():
        fail(f"styletts2_tpu_torch/ not found beside {Path(__file__).name}: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    # the LJSpeech dictionary has no space symbol: one warning per space
    logging.getLogger("styletts2_tpu_torch.text.cleaner").setLevel(logging.ERROR)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]

    from styletts2_tpu_torch.kernels import build
    from styletts2_tpu_torch.kernels import mrf_round as K

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(logs)} in {build_s:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}", flush=True)

    kernel_rows = phase_kernels(torch, K)
    serve = phase_serve(torch, K, profile="--profile" in sys.argv[1:])

    timed = {r["stage"]: r for r in kernel_rows if "ms" in r}
    s1 = timed["stage1"]
    kernels = [{
        "name": "mrf_round", "route": "cuda", "source": "styletts2_tpu_torch/csrc/mrf_round.cu",
        "replaces": "styletts2_tpu/ops/pallas/mrf_round_kernel.py:183",
        "launches": serve["runs"]["batched"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows if "max_abs_err" in r),
        "ms": s1["ms"], "plain_ms": s1["plain_ms"], "bound_ms": s1["bound_ms"],
        "bound_by": s1["bound_by"], "library_ms": s1["library_ms"], "shape": s1["shape"],
    }]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "kernel_checks": kernel_rows, "serve": serve,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
