#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports nothing of JAX or of ``styletts2_tpu``.
Phases, each of which exits non-zero when it fails:

1. build: compile every CUDA source of ``styletts2_tpu_torch/csrc`` for
   sm_90a (one nvcc per source, all started together);
2. kernels: hold each kernel against its plain PyTorch version at the
   shapes its path gives it, and time both: mrf_round (K2) at the serving
   shapes of batch 1 and of the batched call, the iSTFTNet's 256 and 128
   channels and the HiFi-GAN's 64 and 32, beside cuDNN's conv alone in
   f32 and in TF32, after counting the TF32 tensor-core instructions in its
   library (``cuobjdump -sass``); adain_snake forward and backward (K1f,
   K1b) at the stage-1 training shapes, those of max_len 400 and a short
   odd row, each with its share of the byte bound and the path its row
   length takes, and maximum_path (K3) at the aligner's shape.  Each
   kernel's ``ms`` holds the host's time per call where it outlasts the
   device's (``cuda_ms``); ``device_ms`` beside it is the device's alone;
3. serve: build the full-width LJSpeech port with seeded random weights,
   answer a batched, a single and a classifier-free-guided request through
   ``InferenceEngine.synthesize``, count the kernels' launches in each, and
   hold the fused decoder (K2) against the unfused one (whose AdaIN -> Snake
   pairs run K1f) on the same inputs;
3b. serve libritts: the same for the full-width LibriTTS multispeaker port
   (the style-conditioned denoiser, the HiFi-GAN decoder, whose rounds run
   K2 at 256, 128, 64 and 32 channels): ``compute_style`` of a seeded
   reference clip, ``style_transfer`` requests with 96 launches each, the
   fused decoder against the unfused one, and ``python -m
   styletts2_tpu_torch.demo`` in this process writing a wave file;
3c. serve bf16: K2's bf16 form against its bf16 plain version at the
   batch-1 and batched rounds of both decoders, timed beside cuDNN's bf16
   conv; then both full-width models with their nets cast to bf16 and the
   engine's ``compute_dtype`` bf16: a batched and a single request, 48 and
   96 launches of the bf16 form a call, and the bf16 synthesis (F0/N
   predictor and decoder) at the f32 engine's durations against the f32
   one by log-mel L1 (``BF16_MEL_L1_BOUND``);
3d. serve many: ``serve.BatchSynthesizer`` (``max_batch`` 16) over 24
   seeded LJSpeech-style requests of 8 to 250 tokens across its six
   buckets, after timing ``InferenceEngine.warmup`` and the first request
   after it: waves in input order of ``sum(pred_dur) * 600`` samples less
   ``trim_tail``, 48 launches a chunk;
4. train: build the full-width LJSpeech stage-1 nets with seeded random
   weights and take 1 + 5 pre-TMA steps through ``train.loop.run_stage1``
   (batch 16, clip 96 aligner frames, f32, TF32 off), counting the kernels'
   launches in each step;
5. train TMA: the same with the TMA phase from the first step (MPD, MSD
   and a Whisper-base encoder added, the discriminator step, the GAN and SLM
   losses, the aligner and pitch extractor trained): finite losses
   including ``d_loss``, K1f/K1b/K3 48/48/1 launches a step, the seven
   trained nets moved and the Whisper encoder not, the step median and the
   peak memory of the phase;
6. train2: stage 2 through ``train.loop.run_stage2`` at full width (the
   14 ``STAGE2_NETS``, seeded weights, the same batch with 128 reference
   tokens): 2 steps before diffusion, 2 with diffusion and the MPD/MSD,
   9 joint steps (6 generator-SLM, 3 WD); finite losses, ``sigma_data``
   moved, per sub-phase the nets that move and those that stay bitwise
   equal, K1f/K1b/K3 launches a step (``train2_launches``), the median
   step of each sub-phase and the peak memory;
7. train files: the trainers as users run them
   (``python -m styletts2_tpu_torch.train_stage1`` then ``train_stage2``,
   called in this process, ``phase_train_files``) on a seeded
   LJSpeech-shaped corpus of WAVs at 22050 Hz written to a temporary
   directory, with a seeded out-of-distribution text list, at full width:
   stage 1 with one epoch before TMA and one with it, then stage 2 from the
   ``first_stage.npz`` it wrote with an epoch with diffusion and a joint
   one (generator-SLM, then WD), validation and a sample dump after each
   epoch, a checkpoint each, and each stage resumed from its first epoch's
   checkpoint for one step; finite train and validation losses, the nets
   that move and the frozen ones, K1f/K1b/K3 launches a step (48/48/1 a
   stage-1 step, ``train2_launches`` in stage 2, 144/0/2 a validation with
   its dump), the files and metrics lines written, a checkpoint's nets and
   AdamW states loaded exactly, each resumed step's losses those of the
   uninterrupted run; the loader's wait per batch, the checkpoints' bytes,
   a save and a load, and the validation time per batch.  A dump that fails
   only warns in the trainers, so any such warning fails the phase;
8. train libritts: the same phase for the multispeaker HiFi-GAN model of
   ``configs/libritts.yml`` at full width, on a seeded 4-speaker corpus at
   24 kHz, followed by the fine-tune recipe (``train_stage2 --finetune``
   on ``configs/ljspeech_ft.yml``) from the stage-2 checkpoint, resumed
   likewise (96/96/1 a stage-1 step, 288/0/2 a validation with its dump);
9. print the kernels line, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``.  ``--profile`` adds a
torch.profiler breakdown of a batched and a single request to the serve
phase and of one training step to each train phase.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM, dense TF32 on the tensor cores
SLEEP_CYCLES = 2_000_000         # ~1 ms of device clock ahead of a device-only timing
BF16_FLOP_PER_S = 989e12         # H100 SXM, dense bf16 on the tensor cores
SEED = 0
STEPS = 5
BF16_MEL_L1_BOUND = 1.0          # bf16 vs f32 synthesis at equal durations (PERF.md)
RANDOM_ENCODERS = "STYLETTS2_ALLOW_RANDOM_ENCODERS"
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


def cuda_ms(fn, reps: int = 25, warmup: int = 3, device_only: bool = False) -> float:
    """Median over ``reps`` launches of CUDA-event time, in ms.  The start
    event is recorded before ``fn`` runs on the host, so the time holds the
    host's own time per call (a wrapper's checks and launch) where it
    outlasts the queue.  With ``device_only`` each call waits behind a ~1 ms
    device sleep, so that the start event runs after the host has queued
    ``fn``'s kernels: the device's time alone (``device_ms`` in the records)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float = 0.0, flop_per_s: float = F32_FLOP_PER_S):
    """(least ms for the work on the card, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# mrf_round's timed shapes, the widest round (k=11, d=5): the iSTFTNet
# generator's two stages at batch 1 (frame capacity 200) and at the batched
# serving call's batch 4 (capacity 1600); the HiFi-GAN's 64- and 32-channel
# stages at batch 1 (a short capacity of 40 and 80 generator input frames)
# and at batch 4 (capacity 1600)
MRF_SHAPES = (("stage0", 1, 256, 4000), ("stage1", 1, 128, 24000),
              ("stage0_b4", 4, 256, 32000), ("stage1_b4", 4, 128, 192000),
              ("hifigan64", 1, 64, 12000), ("hifigan32", 1, 32, 24000),
              ("hifigan64_b4", 4, 64, 480000), ("hifigan32_b4", 4, 32, 960000))


def phase_kernels(torch, K):
    """mrf_round against mrf_round_plain at ``MRF_SHAPES``."""
    import torch.nn.functional as F
    from styletts2_tpu_torch.nn.activations import snake

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for stage, b, c, t in MRF_SHAPES:
        k, d = 11, 5
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
        device_ms = cuda_ms(lambda: K.mrf_round(*args, k=k, d=d, residual=res),
                            device_only=True)
        plain_ms = cuda_ms(lambda: K.mrf_round_plain(*args, k=k, d=d, residual=res))
        library_ms = cuda_ms(lambda: F.conv1d(act, w, bias, padding=pad, dilation=d))
        allow_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True        # only for this yardstick
        try:
            library_tf32_ms = cuda_ms(lambda: F.conv1d(act, w, bias, padding=pad, dilation=d))
        finally:
            torch.backends.cudnn.allow_tf32 = allow_tf32
        flops = 2.0 * b * c * c * k * t
        nbytes = 4.0 * (3 * b * c * t + c * c * k + 4 * b * c + 2 * c + b
                        + b * K.n_tiles(t) * 3 * c)
        # the kernel's three TF32 products per multiply-add on the tensor cores
        least_ms, bound_by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
        f32_ms, f32_by = bound_ms(nbytes, flops)
        rows.append({"stage": stage, "shape": f"B={b} C={c} T={t} k={k} d={d} +residual",
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library_tf32_ms": library_tf32_ms, "bound_ms": least_ms,
                     "bound_by": bound_by, "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"mrf_round {stage} (B={b} C={c} T={t} k={k} d={d}): {ms:.4f} ms (device "
              f"{device_ms:.4f}), plain "
              f"{plain_ms:.4f} ms, F.conv1d {library_ms:.4f} ms (TF32 {library_tf32_ms:.4f}), "
              f"bound {least_ms:.4f} ms 3xTF32 / {f32_ms:.4f} ms f32", flush=True)
    return rows


def sass_mma_counts(path) -> dict:
    """Tensor-core MMA instructions in a built library, by opcode
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True)
    check(out.returncode == 0, f"cuobjdump -sass {path} failed: {out.stderr.strip()}")
    counts = {}
    for op in re.findall(r"\b(HG?MMA\.[\w.]+)", out.stdout):
        counts[op] = counts.get(op, 0) + 1
    return counts


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


def profile_request(torch, call, mark="mrf_round_kernel"):
    """Device time by kernel over one call (torch.profiler), and the share of
    the call's wall time the device was busy; ``mark`` (a substring or a
    tuple of them) names the kernels whose share is reported."""
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
    marks = (mark,) if isinstance(mark, str) else mark
    out = {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
           "top": [[name[:80], ms] for name, ms in top]}
    for m in marks:
        ms_m = sum(ms for name, ms in kernels.items() if m in name)
        out[f"{m}_ms"] = ms_m
        out[f"{m}_share"] = ms_m / max(device_ms, 1e-9)
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
    # the unfused decoder's AdaIN -> Snake pairs run adain_snake (K1f) on the
    # card: this holds K2's rounds against K1f and cuDNN's convolutions
    print(f"serve fused (mrf_round) vs unfused (adain_snake fwd + cuDNN conv) decoder: "
          f"{parity}", flush=True)
    return {"params": n_params, "runs": runs, "decoder_parity": parity, "t_mel": t_mel}


def reference_clip(seconds: float = 3.0, sr: int = 24000):
    """A seeded reference clip: a gliding two-harmonic tone under noise."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    t = np.arange(int(sr * seconds)) / sr
    f = 120.0 + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f) / sr
    clip = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.02 * rng.standard_normal(t.size)
    return clip.astype(np.float32)


def phase_serve_libritts(torch, K, KA, profile=False, card="", dev="cuda", mp=None,
                         demo_config=None):
    """LibriTTS multispeaker serving at full width (``libritts_config()``:
    12-layer PL-BERT, the style-conditioned denoiser, the HiFi-GAN decoder
    of 1024 / 64 channels over stages of 256, 128, 64 and 32, both style
    encoders), seeded random weights: ``compute_style`` of a seeded 3-second
    clip, then ``style_transfer`` of the four sentences batched, of one, and
    of one at ``embedding_scale`` 2, each with 96 mrf_round launches and
    waveforms of ``sum(pred_dur) * 600`` samples; the fused decoder against
    the unfused one (K1f + cuDNN) inside PARITY.md's envelope; then
    ``python -m styletts2_tpu_torch.demo`` in this process on
    ``configs/libritts.yml`` with the clip written as a wave file.  ``dev``,
    ``mp`` and ``demo_config`` (a YAML path) size a rehearsal on the CPU,
    where the wrappers run their plain versions and launch nothing."""
    import tempfile
    import wave

    import numpy as np
    from scipy.io import wavfile
    from styletts2_tpu_torch import demo
    from styletts2_tpu_torch.config import libritts_config
    from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
    from styletts2_tpu_torch.models.decoder.hifigan import decoder_apply
    from styletts2_tpu_torch.models.plbert import PLBertConfig
    from styletts2_tpu_torch.models.zoo import STYLE_INFERENCE_NETS, build_nets, init_random_

    on_card = torch.device(dev).type == "cuda"
    mp, pl = mp or libritts_config().model_params, PLBertConfig()
    # a stage: noise_res and 3 MRF resblocks, 6 rounds each
    launches_per_call = 4 * (6 + 3 * 6) if on_card else 0
    nets = init_random_(build_nets(mp, pl), SEED)      # decoder 2 x 512 wide, asr_res 64

    def sync():
        if on_card:
            torch.cuda.synchronize()
    check(tuple(nets) == STYLE_INFERENCE_NETS, f"LibriTTS nets {tuple(nets)}")
    # Random weights drive the output conv far past tanh's linear range, where
    # the waveform sits at +-1 and hides any difference between two decoders:
    # scale it down, as the serve phase does for the iSTFTNet head
    with torch.no_grad():
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    n_params = sum(p.numel() for p in nets.parameters())
    print(f"serve libritts: {n_params} parameters ({n_params / 1e6:.1f} M), seeded random "
          f"weights", flush=True)
    eng = InferenceEngine(nets, mp, pl, device=None if on_card else dev)  # None: the GPU
    check(eng.device.type == torch.device(dev).type, f"engine on {eng.device}")
    clip = reference_clip()
    sync()
    t0 = time.perf_counter()
    ref_s = eng.compute_style(clip)
    sync()
    style_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(ref_s.shape) == (1, 2 * mp.style_dim) and bool(torch.isfinite(ref_s).all()),
          f"compute_style gave {tuple(ref_s.shape)}")

    def request(texts, **kw):
        K.launches = 0
        sync()
        t0 = time.perf_counter()
        wavs, durs = eng.style_transfer(texts, ref_s, diffusion_steps=STEPS,
                                        return_durations=True, **kw)
        sync()
        wall = time.perf_counter() - t0
        launches = K.launches
        if isinstance(wavs, np.ndarray):
            wavs, durs = [wavs], [durs]
        for w, dur in zip(wavs, durs):
            check(bool(np.isfinite(w).all()), "non-finite LibriTTS waveform")
            check(len(w) == int(np.sum(dur)) * SAMPLES_PER_FRAME,
                  f"LibriTTS waveform length {len(w)} != sum(pred_dur) * 600")
        check(launches == launches_per_call,
              f"mrf_round launched {launches} times, not {launches_per_call}, in one call")
        audio_s = sum(len(w) for w in wavs) / 24000.0
        return {"batch": len(wavs), "launches": launches, "wall_s": wall,
                "audio_s": audio_s, "frames": [int(np.sum(dur)) for dur in durs],
                "max_abs_wav": max(float(np.abs(w).max()) for w in wavs),
                "share_abs_wav_over_0.99": float(np.mean(np.abs(np.concatenate(wavs)) > 0.99))}

    request(PHONEMES)                                          # warm call
    runs = {"batched": request(PHONEMES), "single": request(PHONEMES[2]),
            "cfg_scale_2": request(PHONEMES[1], embedding_scale=2.0)}
    if profile:
        runs["profile_batched"] = profile_request(
            torch, lambda: eng.style_transfer(PHONEMES, ref_s, diffusion_steps=STEPS))
    b = runs["batched"]
    b["audio_s_per_s"] = b["audio_s"] / b["wall_s"]
    for name, r in runs.items():
        print(f"serve libritts {name}: {r}", flush=True)
    print(f"serve libritts: {b['audio_s_per_s']:.2f} audio-s/s (batch {b['batch']}, "
          f"{b['audio_s']:.3f} s of audio in {b['wall_s']:.6f} s); compute_style "
          f"{style_ms:.3f} ms; {card}", flush=True)

    # the fused decoder (kernel) against the plain one on the same inputs
    with torch.inference_mode():
        tokens, lengths_np = eng.tokenize(PHONEMES)
        lengths = torch.from_numpy(lengths_np).to(eng.device)
        gen = torch.Generator(eng.device).manual_seed(SEED)
        shape = (len(PHONEMES), 1, 2 * mp.style_dim)
        noise = torch.randn(shape, generator=gen, device=eng.device)
        step_noise = torch.randn((STEPS - 1, *shape), generator=gen, device=eng.device)
        t_en, d, s, ref, _, pred_dur = eng._frontend(
            tokens, lengths, noise, step_noise, STEPS, 1.0, None, 0.0,
            ref_s.expand(len(PHONEMES), -1), 0.3, 0.7)
        frames = pred_dur.sum(1).cpu().numpy()
        t_mel = eng.frame_capacity(int(lengths_np.max()), int(frames.max()))
        asr, f0, n, fr = eng._decoder_inputs(t_en, d, s, pred_dur, lengths, t_mel)
        dec = nets["decoder"]
        K.launches = KA.fwd_launches = 0
        fused = decoder_apply(dec, asr, f0, n, ref, lengths=fr, fused=True)[:, 0]
        check(K.launches == launches_per_call,
              f"fused HiFi-GAN decoder launched mrf_round {K.launches} times")
        plain = decoder_apply(dec, asr, f0, n, ref, lengths=fr, fused=False)[:, 0]
        check(KA.fwd_launches > 0 or not on_card,
              "the unfused HiFi-GAN decoder launched no adain_snake")
    parity = []
    for i in range(len(PHONEMES)):
        m = int(frames[i]) * SAMPLES_PER_FRAME
        ok, env = parity_envelope(torch, fused[i, :m].float(), plain[i, :m].float())
        env["max_abs_wav"] = float(plain[i, :m].abs().max())
        parity.append(env)
        check(ok, f"fused vs plain HiFi-GAN decoder outside the PARITY envelope: {env}")
    print(f"serve libritts fused (mrf_round) vs unfused (adain_snake fwd + cuDNN conv) "
          f"decoder: {parity}", flush=True)
    del eng, nets, fused, plain
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the demo entry point, as users run it, in this process
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_demo_"))
    try:
        ref_wav, out_wav = tmp / "speaker.wav", tmp / "out.wav"
        wavfile.write(ref_wav, 24000, (clip * 32767).astype(np.int16))
        K.launches = 0
        t0 = time.perf_counter()
        wav = demo.main(["--config", demo_config or str(ROOT / "configs" / "libritts.yml"),
                         "--phonemes", PHONEMES[3], "--ref_audio", str(ref_wav),
                         "--alpha", "0.3", "--beta", "0.7", "--out", str(out_wav)]
                        + ([] if on_card else ["--device", dev]))
        demo_s = time.perf_counter() - t0
        check(K.launches == launches_per_call, f"the demo launched mrf_round {K.launches} times")
        with wave.open(str(out_wav), "rb") as f:
            params = (f.getnchannels(), f.getsampwidth(), f.getframerate(), f.getnframes())
        check(params == (1, 2, 24000, len(wav)) and len(wav) > 0
              and len(wav) % SAMPLES_PER_FRAME == 0,
              f"the demo's wave file: channels, width, rate, frames {params}, {len(wav)} samples")
        demo_out = {"wall_s": demo_s, "samples": len(wav), "launches": K.launches,
                    "wav": params}
        print(f"serve libritts demo: {demo_out}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"params": n_params, "compute_style_ms": style_ms, "runs": runs,
            "decoder_parity": parity, "t_mel": t_mel, "demo": demo_out}


# K2's bf16 form at the serving rounds (k=11, d=5): the iSTFTNet's stage 1 at
# batch 1 and batched, the HiFi-GAN's 64 and 32 channels batched
MRF_BF16_SHAPES = (("stage1", 1, 128, 24000), ("stage1_b4", 4, 128, 192000),
                   ("hifigan64_b4", 4, 64, 480000), ("hifigan32_b4", 4, 32, 960000))


def bf16_ulp(a: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude ``a``."""
    return 2.0 ** (math.floor(math.log2(a)) - 7)


def phase_kernels_bf16(torch, K):
    """mrf_round's bf16 form against its bf16 plain version at
    ``MRF_BF16_SHAPES``: y within 2 bf16 ulps of max|y| (the two sum in
    other orders in f32), the chained statistics at 1e-3; times beside
    cuDNN's bf16 conv of the same bf16 activation."""
    import torch.nn.functional as F
    from styletts2_tpu_torch.nn.activations import snake

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for stage, b, c, t in MRF_BF16_SHAPES:
        k, d = 11, 5
        x = torch.randn((b, c, t), generator=g, device=dev).to(bf)
        lengths = torch.tensor([t * 4 // 5, t, t // 2, t * 3 // 4][:b], dtype=torch.int32,
                               device=dev)
        gamma = 0.1 * torch.randn((b, c), generator=g, device=dev)
        beta = 0.1 * torch.randn((b, c), generator=g, device=dev)
        alpha = torch.rand((c,), generator=g, device=dev) + 0.5
        w = (torch.randn((c, c, k), generator=g, device=dev) / math.sqrt(c * k)).to(bf)
        bias = 0.1 * torch.randn((c,), generator=g, device=dev)
        res = torch.randn((b, c, t), generator=g, device=dev).to(bf)
        mean, rstd = K.masked_stats(x, lengths)
        args = (x, mean, rstd, gamma, beta, alpha, w, bias, lengths)
        for residual in (None, res):
            y, parts = K.mrf_round(*args, k=k, d=d, residual=residual)
            torch.cuda.synchronize()
            y_ref, parts_ref = K.mrf_round_plain(*args, k=k, d=d, residual=residual)
            check(y.dtype == bf, f"mrf_round bf16 {stage}: y is {y.dtype}")
            err = float((y.float() - y_ref.float()).abs().max())
            scale = float(y_ref.float().abs().max())
            check(err <= 2 * bf16_ulp(scale),
                  f"mrf_round bf16 {stage}: max|err| {err} > 2 bf16 ulps of {scale}")
            for got, want in zip(K.stats_from_partials(parts, lengths, t),
                                 K.stats_from_partials(parts_ref, lengths, t)):
                torch.testing.assert_close(got, want, atol=1e-3 * scale, rtol=1e-3)
            rows.append({"stage": stage, "residual": residual is not None,
                         "max_abs_err": err, "max_abs_y": scale})
        act = snake((1 + gamma[:, :, None]) * ((x.float() - mean[:, :, None])
                                               * rstd[:, :, None]) + beta[:, :, None],
                    alpha[None, :, None]).to(bf)
        pad, bias_bf = (k * d - d) // 2, bias.to(bf)
        ms = cuda_ms(lambda: K.mrf_round(*args, k=k, d=d, residual=res))
        device_ms = cuda_ms(lambda: K.mrf_round(*args, k=k, d=d, residual=res),
                            device_only=True)
        plain_ms = cuda_ms(lambda: K.mrf_round_plain(*args, k=k, d=d, residual=res))
        library_ms = cuda_ms(lambda: F.conv1d(act, w, bias_bf, padding=pad, dilation=d))
        flops = 2.0 * b * c * c * k * t
        # bf16 x, residual, y and weights; f32 statistics, plane, bias and partials
        nbytes = (2.0 * (3 * b * c * t + c * c * k)
                  + 4.0 * (4 * b * c + 2 * c + b + b * K.n_tiles(t) * 3 * c))
        least_ms, bound_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        rows.append({"stage": stage, "shape": f"B={b} C={c} T={t} k={k} d={d} +residual bf16",
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": least_ms, "bound_by": bound_by,
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6})
        print(f"mrf_round bf16 {stage} (B={b} C={c} T={t} k={k} d={d}): {ms:.4f} ms (device "
              f"{device_ms:.4f}), plain {plain_ms:.4f} ms, F.conv1d bf16 {library_ms:.4f} ms, "
              f"bound {least_ms:.4f} ms ({bound_by})", flush=True)
    return rows


def phase_serve_bf16(torch, K, card="", dev="cuda", models=None):
    """Both full-width serving models with their nets cast to bf16 and the
    engine's ``compute_dtype`` bf16 (seeded random weights, the output conv
    scaled as in the f32 phases): after a warm call of each, the four
    sentences batched and one alone, each with ``launches`` bf16 rounds of
    mrf_round; then the
    bf16 synthesis (F0/N predictor and decoder) at the f32 engine's
    durations against the f32 synthesis, by log-mel L1 per request.
    ``models`` ((name, ModelParams, build kwargs) triples) and ``dev`` size
    a rehearsal on the CPU, where the wrappers launch nothing."""
    import copy

    import numpy as np
    from styletts2_tpu_torch.config import ModelParams, libritts_config
    from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
    from styletts2_tpu_torch.models.plbert import PLBertConfig
    from styletts2_tpu_torch.models.zoo import build_nets, init_random_

    on_card = torch.device(dev).type == "cuda"
    pl = PLBertConfig()
    models = models or (
        ("ljspeech", ModelParams(), dict(decoder_width=1024, decoder_asr_res_ch=64)),
        ("libritts", libritts_config().model_params, {}))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    out = {}
    for name, mp, build_kw in models:
        launches_per_call = (4 * (6 + 3 * 6) if mp.decoder.type == "hifigan" else 48) \
            if on_card else 0
        nets = init_random_(build_nets(mp, pl, **build_kw), SEED)
        with torch.no_grad():
            nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
        device = None if on_card else dev                       # None: the GPU
        eng32 = InferenceEngine(nets, mp, pl, device=device)
        eng16 = InferenceEngine(copy.deepcopy(nets).to(torch.bfloat16), mp, pl,
                                device=device, compute_dtype=torch.bfloat16)
        ref_s = eng16.compute_style(reference_clip()) if mp.multispeaker else None
        check(ref_s is None or ref_s.dtype == torch.bfloat16, "compute_style not in bf16")

        def request(texts):
            K.launches = K.bf16_launches = 0
            sync()
            t0 = time.perf_counter()
            wavs, durs = eng16.synthesize(texts, diffusion_steps=STEPS, ref_s=ref_s,
                                          return_durations=True)
            sync()
            wall = time.perf_counter() - t0
            if isinstance(wavs, np.ndarray):
                wavs, durs = [wavs], [durs]
            for w, dur in zip(wavs, durs):
                check(w.dtype == np.float32 and bool(np.isfinite(w).all()),
                      f"bf16 {name}: a {w.dtype} or non-finite waveform")
                check(len(w) == int(np.sum(dur)) * SAMPLES_PER_FRAME,
                      f"bf16 {name}: waveform length {len(w)} != sum(pred_dur) * 600")
            check(K.launches == K.bf16_launches == launches_per_call,
                  f"bf16 {name}: mrf_round launched {K.launches} times ({K.bf16_launches} "
                  f"bf16), not {launches_per_call}, in one call")
            audio_s = sum(len(w) for w in wavs) / 24000.0
            return {"batch": len(wavs), "launches": K.launches,
                    "bf16_launches": K.bf16_launches, "wall_s": wall, "audio_s": audio_s,
                    "audio_s_per_s": audio_s / wall,
                    "max_abs_wav": max(float(np.abs(w).max()) for w in wavs)}

        request(PHONEMES)                                      # warm calls
        request(PHONEMES[2])
        runs = {"batched": request(PHONEMES), "single": request(PHONEMES[2])}

        # the bf16 synthesis at the f32 engine's durations against the f32 one
        with torch.inference_mode():
            tokens, lengths_np = eng32.tokenize(PHONEMES)
            lengths = torch.from_numpy(lengths_np).to(eng32.device)
            gen = torch.Generator(eng32.device).manual_seed(SEED)
            shape = (len(PHONEMES), 1, 2 * mp.style_dim)
            noise = torch.randn(shape, generator=gen, device=eng32.device)
            step_noise = torch.randn((STEPS - 1, *shape), generator=gen, device=eng32.device)
            ref32 = None if ref_s is None else eng32.compute_style(reference_clip()).expand(
                len(PHONEMES), -1)
            t_en, d, s, ref, _, pred_dur = eng32._frontend(tokens, lengths, noise, step_noise,
                                                           STEPS, 1.0, None, 0.0, ref32)
            frames = pred_dur.sum(1).cpu().numpy()
            t_mel = eng32.frame_capacity(int(lengths_np.max()), int(frames.max()))
            w32 = eng32._synthesis(t_en, d, s, ref, pred_dur, lengths, t_mel).float()
            K.bf16_launches = 0
            w16 = eng16._synthesis(t_en, d, s, ref, pred_dur, lengths, t_mel).float()
            check(K.bf16_launches == launches_per_call,
                  f"bf16 {name} synthesis launched {K.bf16_launches} bf16 rounds")
        mel_l1 = []
        for i in range(len(PHONEMES)):
            m = int(frames[i]) * SAMPLES_PER_FRAME
            mel_l1.append(float((log_mel(torch, w16[i, :m]) - log_mel(torch, w32[i, :m]))
                                .abs().mean()))
        max_abs = [float((w16[i] - w32[i]).abs().max()) for i in range(len(PHONEMES))]
        check(max(mel_l1) < BF16_MEL_L1_BOUND,
              f"bf16 {name}: log-mel L1 against f32 {mel_l1} over {BF16_MEL_L1_BOUND}")
        out[name] = {"runs": runs, "mel_l1_vs_f32": mel_l1, "max_abs_vs_f32": max_abs,
                     "max_abs_wav_f32": float(w32.abs().max()), "t_mel": t_mel}
        b = runs["batched"]
        print(f"serve bf16 {name}: {b['audio_s_per_s']:.2f} audio-s/s (batch {b['batch']}, "
              f"{b['audio_s']:.3f} s of audio in {b['wall_s']:.6f} s), batch 1 "
              f"{runs['single']['wall_s']:.6f} s; log-mel L1 vs f32 {mel_l1}, max|diff| "
              f"{max_abs}; {card}", flush=True)
        del eng32, eng16, nets, w32, w16
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def serve_many_requests(rng, n_per_bucket: int = 4, buckets=(32, 64, 96, 128, 192, 256)):
    """Seeded LJSpeech-style phoneme strings, ``n_per_bucket`` in each token
    bucket from 8 to 250 tokens (the leading pad included): prefixes of the
    smoke's sentences repeated."""
    text = " ".join(PHONEMES * 8)
    out, lo = [], 8
    for hi in buckets:
        for n in rng.integers(lo, min(hi, 250) + 1, n_per_bucket):
            symbols, cut = 0, 0
            while symbols < n - 1:                # the cleaner drops spaces
                symbols += text[cut] != " "
                cut += 1
            out.append(text[:cut])
        lo = hi + 1
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def phase_serve_many(torch, K, card="", dev="cuda", mp=None, build_kw=None,
                     trim_tail: int = 50):
    """``BatchSynthesizer`` (max_batch 16, the six default buckets) over 24
    seeded LJSpeech-style requests of 8 to 250 tokens at full width, after
    ``InferenceEngine.warmup`` and one request: waves in input order of
    ``sum(pred_dur) * 600 - trim_tail`` samples, each chunk with 48
    mrf_round launches.  ``mp``/``build_kw``/``dev`` size a CPU rehearsal."""
    import numpy as np
    from styletts2_tpu_torch.config import ModelParams
    from styletts2_tpu_torch.infer import SAMPLES_PER_FRAME, InferenceEngine
    from styletts2_tpu_torch.models.plbert import PLBertConfig
    from styletts2_tpu_torch.models.zoo import build_nets, init_random_
    from styletts2_tpu_torch.serve import BatchSynthesizer

    on_card = torch.device(dev).type == "cuda"
    mp, pl = mp or ModelParams(), PLBertConfig()
    nets = init_random_(build_nets(mp, pl, **(build_kw or dict(
        decoder_width=1024, decoder_asr_res_ch=64))), SEED)
    with torch.no_grad():
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    eng = InferenceEngine(nets, mp, pl, device=None if on_card else dev)
    launches_per_call = 48 if on_card else 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    eng.warmup()
    sync()
    warmup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.synthesize(PHONEMES[2], diffusion_steps=STEPS)
    sync()
    first_s = time.perf_counter() - t0

    requests = serve_many_requests(np.random.default_rng(SEED))
    n_tokens = [len(eng.tokens_from_phonemes(p)) for p in requests]
    bs = BatchSynthesizer(eng, max_batch=16)
    chunks = bs.chunks(requests)
    buckets = sorted({bs._bucket_of(n) for n in n_tokens})
    check(len(requests) == 24 and min(n_tokens) >= 8 and max(n_tokens) <= 250
          and buckets == bs.length_buckets, f"requests of {n_tokens} tokens in {buckets}")
    calls = []
    synthesize = eng.synthesize

    def recorded(texts, **kw):                 # each chunk's durations and launches
        K.launches = 0
        wavs, durs = synthesize(texts, return_durations=True, **kw)
        calls.append({"texts": list(texts), "durs": durs, "launches": K.launches,
                      "wavs": wavs})
        return wavs

    eng.synthesize = recorded
    try:
        sync()
        t0 = time.perf_counter()
        waves = bs.synthesize_many(requests, diffusion_steps=STEPS, trim_tail=trim_tail)
        sync()
        wall = time.perf_counter() - t0
    finally:
        del eng.synthesize
    check(len(calls) == len(chunks), f"{len(calls)} engine calls for {len(chunks)} chunks")
    for chunk, call in zip(chunks, calls):
        check(call["texts"] == [requests[i] for i in chunk], "chunks out of order")
        check(call["launches"] == launches_per_call,
              f"a chunk launched mrf_round {call['launches']} times")
        for i, dur, w in zip(chunk, call["durs"], call["wavs"]):
            check(waves[i] is w, f"request {i}'s wave is not its own")
            check(len(w) == int(np.sum(dur)) * SAMPLES_PER_FRAME - trim_tail
                  and bool(np.isfinite(w).all()),
                  f"request {i}: {len(w)} samples for {int(np.sum(dur))} frames")
    audio_s = sum(len(w) for w in waves) / 24000.0
    out = {"warmup_s": warmup_s, "first_request_s": first_s, "wall_s": wall,
           "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
           "chunks": [len(c) for c in chunks], "tokens": n_tokens,
           "launches_per_chunk": [c["launches"] for c in calls]}
    print(f"serve many: {out}", flush=True)
    print(f"serve many: {audio_s / wall:.2f} audio-s/s over {len(requests)} requests in "
          f"{len(chunks)} chunks; warmup {warmup_s:.3f} s, first request after it "
          f"{first_s:.3f} s; {card}", flush=True)
    del eng, nets
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def phase_train_kernels(torch, KA, KM):
    """adain_snake forward (K1f) and backward (K1b) against their plain
    versions, masked and not, at the stage-1 decoder's two row lengths in
    the step below (stage 0, stage 1), at the two of configs/ljspeech.yml's
    max_len 400 (4000, 24001 frames), at a short odd row, and at the
    HiFi-GAN's rows of the LibriTTS train phase (stage 0 as the iSTFTNet's;
    9600, 28800 and 57600 frames at 128, 64 and 32 channels), the edges of
    the long rows' shared-memory cache on this card (57856, 57857 frames)
    and the last stage at configs/libritts.yml's max_len 300 (90000), each
    with the path its T takes.
    maximum_path (K3) at the aligner's width: mixed lengths, a row with
    text_len == mel_len, and ties."""
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(SEED)
    rows = []
    for c, t in ((256, 1920), (128, 11521), (256, 4000), (128, 24001), (256, 37),
                 (128, 9600), (64, 28800), (32, 57600), (32, 57856), (32, 57857),
                 (32, 90000)):
        b = 16
        x = torch.randn((b, c, t), generator=g, device=dev)
        gamma = 0.3 * torch.randn((b, c), generator=g, device=dev)
        beta = 0.3 * torch.randn((b, c), generator=g, device=dev)
        alpha = 1.0 + 0.3 * torch.rand((c,), generator=g, device=dev)
        dy = torch.randn((b, c, t), generator=g, device=dev)
        for masked in (False, True):
            lengths = (torch.randint(t // 2, t + 1, (b,), generator=g, device=dev,
                                     dtype=torch.int32) if masked else None)
            args = (x, gamma, beta, alpha, lengths)
            y, mean, rstd = KA.adain_snake_fwd(*args)
            torch.cuda.synchronize()
            y_ref = KA.adain_snake_plain(*args)
            fwd_err, y_max = float((y - y_ref).abs().max()), float(y_ref.abs().max())
            check(fwd_err <= 1e-5 * y_max, f"adain_snake fwd {c}x{t}: {fwd_err} > 1e-5 * {y_max}")
            got = KA.adain_snake_bwd(x, gamma, beta, alpha, mean, rstd, lengths, dy)
            torch.cuda.synchronize()
            got = [*got[:3], got[3].sum(0)]
            closed = KA.adain_snake_bwd_plain(x, gamma, beta, alpha, mean, rstd, lengths, dy)
            closed = [*closed[:3], closed[3].sum(0)]
            leaves = [a.clone().requires_grad_() for a in (x, gamma, beta, alpha)]
            (KA.adain_snake_plain(*leaves, lengths) * dy).sum().backward()
            bwd_err = 0.0
            for name, mine, ref, auto in zip(("dx", "dgamma", "dbeta", "dalpha"), got, closed,
                                             [p.grad for p in leaves]):
                for want in (ref, auto):
                    err, scale = float((mine - want).abs().max()), float(want.abs().max())
                    check(err <= 1e-4 * scale,
                          f"adain_snake bwd {name} {c}x{t}: {err} > 1e-4 * {scale}")
                    bwd_err = max(bwd_err, err)
            row = {"shape": f"B={b} C={c} T={t}", "masked": masked, "fwd_max_abs_err": fwd_err,
                   "max_abs_y": y_max, "bwd_max_abs_err": bwd_err,
                   "fwd_path": KA.plan(t), "bwd_path": KA.plan(t, backward=True)}
            if not masked:        # the training decoder's form (lengths None)
                bwd_args = (x, gamma, beta, alpha, mean, rstd, None, dy)
                row["fwd_ms"] = cuda_ms(lambda: KA.adain_snake_fwd(*args))
                row["fwd_device_ms"] = cuda_ms(lambda: KA.adain_snake_fwd(*args),
                                               device_only=True)
                row["fwd_plain_ms"] = cuda_ms(lambda: KA.adain_snake_plain(*args))
                row["bwd_ms"] = cuda_ms(lambda: KA.adain_snake_bwd(*bwd_args))
                row["bwd_device_ms"] = cuda_ms(lambda: KA.adain_snake_bwd(*bwd_args),
                                               device_only=True)
                row["bwd_plain_ms"] = cuda_ms(lambda: KA.adain_snake_bwd_plain(*bwd_args))
                n = b * c * t          # operations per frame as written, each sine one
                row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(
                    4.0 * (2 * n + 4 * b * c), 14.0 * n)
                row["bwd_bound_ms"], row["bwd_bound_by"] = bound_ms(
                    4.0 * (3 * n + 6 * b * c), 32.0 * n)
                for d in ("fwd", "bwd"):
                    row[f"{d}_bound_share"] = row[f"{d}_bound_ms"] / row[f"{d}_ms"]
                    row[f"{d}_device_bound_share"] = (row[f"{d}_bound_ms"]
                                                      / row[f"{d}_device_ms"])
                print(f"adain_snake B={b} C={c} T={t}: " + "; ".join(
                    f"{d} {row[f'{d}_ms']:.4f} ms, {row[f'{d}_bound_share']:.3f} of the bound "
                    f"(device {row[f'{d}_device_ms']:.4f}, "
                    f"{row[f'{d}_device_bound_share']:.3f}; plain {row[f'{d}_plain_ms']:.4f}, "
                    f"bound {row[f'{d}_bound_ms']:.4f}; {row[f'{d}_path']})"
                    for d in ("fwd", "bwd")), flush=True)
            rows.append(row)

    b, t_text, t_mel = 16, 128, 104
    for case in ("mixed", "text_len == mel_len", "ties"):
        values = torch.rand((b, t_text, t_mel), generator=g, device=dev)
        if case == "ties":
            values = torch.round(values * 4) / 4
        ml = torch.randint(40, t_mel + 1, (b,), generator=g, device=dev, dtype=torch.int32)
        tl = torch.minimum(torch.randint(20, t_text + 1, (b,), generator=g, device=dev,
                                         dtype=torch.int32), ml)
        if case == "text_len == mel_len":
            tl = ml.clone()
        path = KM.maximum_path(values, tl, ml)
        torch.cuda.synchronize()
        ref = KM.maximum_path_plain(values, tl, ml)
        check(torch.equal(path, ref), f"maximum_path ({case}) differs from its plain version")
        check(bool((path.sum(1)[0, : int(ml[0])] == 1).all()), "maximum_path: not one-hot")
        row = {"shape": f"B={b} T_text={t_text} T_mel={t_mel}", "case": case,
               "max_abs_err": float((path - ref).abs().max())}
        if case == "mixed":
            row["ms"] = cuda_ms(lambda: KM.maximum_path(values, tl, ml))
            row["device_ms"] = cuda_ms(lambda: KM.maximum_path(values, tl, ml),
                                       device_only=True)
            row["plain_ms"] = cuda_ms(lambda: KM.maximum_path_plain(values, tl, ml), reps=5)
            row["bound_ms"], row["bound_by"] = bound_ms(4.0 * 2 * b * t_text * t_mel,
                                                        6.0 * b * t_text * t_mel)
            print(f"maximum_path B={b} T_text={t_text} T_mel={t_mel}: {row['ms']:.4f} ms "
                  f"(device {row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.6f}; T_mel={t_mel} "
                  "dependent frame steps, each a block barrier, and as many backtrack steps)",
                  flush=True)
        rows.append(row)
    return rows


def phase_train(torch, KA, KM, K2, profile=False, dev="cuda", mp=None, asr_cfg=None,
                widths=(1024, 64), b=16, t_text=128, tma=False, whisper_cfg=None,
                mpd_channels=None, msd_width=32, card=""):
    """1 warm + 5 timed stage-1 steps at the full LJSpeech width through
    run_stage1, with the kernels' launches counted per step: before TMA,
    or with ``tma`` from the first step (``TMA_epoch`` 0: the discriminator
    step and the generator step with the GAN and SLM losses, over the
    STAGE1_TMA_NETS with a Whisper-base encoder).  The keyword arguments
    size a rehearsal on the CPU (``dev="cpu"``, a small ``mp``); the
    defaults are the LJSpeech configuration."""
    import numpy as np
    from styletts2_tpu_torch.config import Config, ModelParams
    from styletts2_tpu_torch.models.asr import ASRConfig
    from styletts2_tpu_torch.models.discriminators import MPD_CHANNELS
    from styletts2_tpu_torch.models.whisper import WhisperConfig
    from styletts2_tpu_torch.models.zoo import (STAGE1_NETS, STAGE1_TMA_NETS, build_nets,
                                                init_random_)
    from styletts2_tpu_torch.train.loop import run_stage1, to_device
    from styletts2_tpu_torch.train.stage1 import DISCRIMINATORS, TMA_TRAINED, TRAINED

    dev = torch.device(dev)
    cfg, mp = Config(), mp or ModelParams()
    if tma:
        cfg = dataclasses.replace(cfg, loss_params=dataclasses.replace(cfg.loss_params,
                                                                       TMA_epoch=0))
    asr_cfg = asr_cfg or ASRConfig(n_token=mp.n_token)
    configs = {"model": mp, "whisper": whisper_cfg or WhisperConfig()}
    nets = init_random_(build_nets(mp, decoder_width=widths[0], decoder_asr_res_ch=widths[1],
                                   nets=STAGE1_TMA_NETS if tma else STAGE1_NETS,
                                   asr_cfg=asr_cfg, whisper_cfg=configs["whisper"],
                                   mpd_channels=mpd_channels or MPD_CHANNELS,
                                   msd_width=msd_width), SEED)
    with torch.no_grad():                          # as in the serve phase
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    nets.to(dev)
    trained = TMA_TRAINED + DISCRIMINATORS if tma else TRAINED
    n_params = {k: sum(p.numel() for p in v.parameters()) for k, v in nets.items()}
    before = {k: [t.clone() for t in v.state_dict().values()] for k, v in nets.items()}

    # the TPU bench's batch (bench_train1.py): 16 waves of 208 mel frames at
    # 0.1 N(0, 1), 128 tokens; 198 valid frames give run_stage1's clip of 96
    frames, steps = 208, 6
    rng = np.random.default_rng(SEED)
    batches = [{"waves": (0.1 * rng.standard_normal((b, frames * 300))).astype(np.float32),
                "texts": rng.integers(4, 170, (b, t_text)),
                "input_lengths": np.full((b,), t_text),
                "mel_input_length": np.full((b,), 198)} for _ in range(steps)]
    marks, per_step = [], []
    names = ("adain_snake_fwd", "adain_snake_bwd", "maximum_path", "mrf_round")

    def counts():
        return dict(zip(names, (KA.fwd_launches, KA.bwd_launches, KM.launches, K2.launches)))

    def log_cb(it, metrics):                       # metrics are floats: the step has synced
        marks.append(time.perf_counter())
        per_step.append({"iter": it, "metrics": metrics, "launches": counts()})

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    KA.fwd_launches = KA.bwd_launches = KM.launches = K2.launches = 0
    t0 = time.perf_counter()
    state = run_stage1(dataclasses.replace(cfg, log_interval=1), configs,
                       nets, lambda epoch: iter(batches), max_steps=steps, log_cb=log_cb,
                       device=dev, seed=SEED)
    launches = counts()
    check(state.iters == steps and len(marks) == steps, f"run_stage1 took {state.iters} steps")
    want_metrics = {"mel_loss", "g_loss"} | ({"gen_loss", "mono_loss", "s2s_loss", "slm_loss",
                                              "d_loss"} if tma else set())
    prev = {k: 0 for k in names}
    for rec in per_step:
        check(set(rec["metrics"]) == want_metrics
              and all(np.isfinite(v) for v in rec["metrics"].values()),
              f"losses at step {rec['iter']}: {rec['metrics']}")
        got = {k: rec["launches"][k] - prev[k] for k in names}
        want = {"adain_snake_fwd": 48, "adain_snake_bwd": 48, "maximum_path": 1, "mrf_round": 0}
        check(got == (want if on_card else {k: 0 for k in want}),
              f"launches in step {rec['iter']}: {got}")
        prev = rec["launches"]
    step_ms = [1e3 * (b_ - a_) for a_, b_ in zip(marks, marks[1:])]
    warm_ms = 1e3 * (marks[0] - t0)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for name, net in nets.items():
        moved = any(not torch.equal(a, w) for a, w in zip(before[name], net.state_dict().values()))
        check(moved == (name in trained), f"{name} {'moved' if moved else 'did not move'}")
    median_ms = statistics.median(step_ms)
    audio_s = b * frames * 300 / 24000.0
    label = "train_tma" if tma else "train"
    out = {"params": n_params, "batch": b, "frames": frames, "t_text": t_text, "mel_len": 96,
           "warm_step_ms": warm_ms, "step_ms": step_ms, "median_step_ms": median_ms,
           "audio_s_per_step": audio_s, "train_audio_s_per_s": audio_s / (median_ms / 1e3),
           "peak_mem_bytes": peak, "losses": [r["metrics"] for r in per_step],
           "launches": launches, "moved": sorted(trained)}
    print(f"{label}: {steps} steps, losses {out['losses']}; step {median_ms:.3f} ms median "
          f"of {['%.3f' % v for v in step_ms]} (warm {warm_ms:.1f} ms); "
          f"{out['train_audio_s_per_s']:.2f} training audio-s/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches per step: adain_snake fwd 48, bwd 48, "
          f"maximum_path 1; moved: {out['moved']}; {card}", flush=True)
    if profile:
        from styletts2_tpu_torch.train.stage1 import Stage1Trainer

        trainer = Stage1Trainer(cfg, configs, nets, state.optimizer)
        tb = to_device(batches[0], dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        out["profile"] = profile_request(
            torch, lambda: float(trainer.step(tb, 96, 96, generator=gen, tma=tma)["g_loss"]),
            mark=("adain_snake_fwd", "adain_snake_bwd", "maximum_path_kernel"))
    return out


def train2_launches(nets, sub_phase: str, use_ind: bool = False) -> dict:
    """K1f / K1b / K3 launches of a stage-2 step.  The decoder runs twice
    before ``joint_epoch`` (``y_rec_gt_pred`` with no graph, ``y_rec``) and
    three times from it (and the SLM pass's ``y_pred``), each pass through
    all its AdaIN -> Snake pairs.  A backward launches K1b only for a pair
    with an input that takes a gradient: while the decoder and the style
    are constants (before ``joint_epoch``, and in the SLM pass with the
    ground-truth style, ``use_ind``), the harmonic source's pairs
    (``noise_res``, fed the detached source) have none.  The generator step
    backs through the decoder once, a generator-SLM step twice."""
    gen = nets["decoder"].generator
    pairs = sum(len(r.adain1) + len(r.adain2) for r in (*gen.resblocks, *gen.noise_res))
    source = sum(len(r.adain1) + len(r.adain2) for r in gen.noise_res)
    fwd = 2 * pairs if sub_phase in ("pre_diffusion", "diffusion") else 3 * pairs
    bwd = {"pre_diffusion": pairs - source, "diffusion": pairs - source, "wd": pairs,
           "generator_slm": 2 * pairs - (source if use_ind else 0)}[sub_phase]
    return {"adain_snake_fwd": fwd, "adain_snake_bwd": bwd, "maximum_path": 1}


KERNELS = ("adain_snake_fwd", "adain_snake_bwd", "maximum_path", "mrf_round")


def _sub_phase(metrics) -> str:
    if "d_loss_slm" in metrics:
        return "wd"
    if "gen_loss_slm" in metrics:
        return "generator_slm"
    return "diffusion" if metrics["diff_loss"] != 0.0 else "pre_diffusion"


def phase_train2(torch, KA, KM, K2, profile=False, dev="cuda", mp=None, asr_cfg=None,
                 plbert_cfg=None, widths=(1024, 64), b=16, t_text=128, whisper_cfg=None,
                 mpd_channels=None, msd_width=32, card=""):
    """Stage 2 through ``train.loop.run_stage2`` at the full LJSpeech width
    (the 14 ``STAGE2_NETS``, seeded weights, f32, TF32 off) on the train
    phases' batch with 128 reference tokens: ``epochs_2nd`` 3,
    ``diff_epoch`` 1, ``joint_epoch`` 2, ``slmadv_params.iter`` 3, so epoch 0
    takes 2 steps before diffusion, epoch 1 2 with diffusion and the
    MPD/MSD, epoch 2 9 joint steps (WD steps at i = 2, 5, 8).  Checks every
    loss finite (``d_loss`` from epoch 1, the SLM losses and a valid
    fraction > 0 in epoch 2), ``sigma_data`` finite and moved, per sub-phase
    the nets that move and those that stay bitwise equal, and K1f/K1b/K3
    launches per step (``train2_launches``); times each sub-phase's steps
    (host clock between synced log callbacks, the first step of each
    epoch warm), and the phase's peak memory.  The keyword arguments size a
    rehearsal on the CPU."""
    import numpy as np
    from styletts2_tpu_torch.config import Config, ModelParams, SlmAdvParams
    from styletts2_tpu_torch.models.asr import ASRConfig
    from styletts2_tpu_torch.models.discriminators import MPD_CHANNELS
    from styletts2_tpu_torch.models.plbert import PLBertConfig
    from styletts2_tpu_torch.models.whisper import WhisperConfig
    from styletts2_tpu_torch.models.zoo import STAGE2_NETS, build_nets, init_random_
    from styletts2_tpu_torch.train.loop import host_draws, run_stage2, to_device
    from styletts2_tpu_torch.train.stage2 import (PROSODY, Stage2Phase, Stage2Trainer,
                                                  generator_nets)

    dev = torch.device(dev)
    mp = mp or ModelParams()
    cfg = Config(epochs_2nd=3, log_interval=1, log_dir="", model_params=mp,
                 loss_params=dataclasses.replace(Config().loss_params, diff_epoch=1,
                                                 joint_epoch=2),
                 slmadv_params=dataclasses.replace(SlmAdvParams(), iter=3))
    configs = {"model": mp, "whisper": whisper_cfg or WhisperConfig()}
    nets = init_random_(build_nets(mp, plbert_cfg or PLBertConfig(), decoder_width=widths[0],
                                   decoder_asr_res_ch=widths[1], nets=STAGE2_NETS,
                                   asr_cfg=asr_cfg or ASRConfig(n_token=mp.n_token),
                                   whisper_cfg=configs["whisper"],
                                   mpd_channels=mpd_channels or MPD_CHANNELS,
                                   msd_width=msd_width), SEED)
    with torch.no_grad():                          # as in the serve phase
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    nets.to(dev)
    n_params = {k: sum(p.numel() for p in v.parameters()) for k, v in nets.items()}
    moves = {"pre_diffusion": set(PROSODY),
             "diffusion": set(generator_nets(True, False)) | {"mpd", "msd"},
             "generator_slm": set(generator_nets(True, True)) | {"mpd", "msd"},
             "wd": set(generator_nets(True, True)) | {"mpd", "msd", "wd"}}

    # the train phases' batch (bench_train.py's, with 198 valid of 208 mel
    # frames for a clip of 96) and 128 reference tokens, for every step
    frames = 208
    rng = np.random.default_rng(SEED)
    batch = {"waves": (0.1 * rng.standard_normal((b, frames * 300))).astype(np.float32),
             "texts": rng.integers(4, 170, (b, t_text)), "input_lengths": np.full((b,), t_text),
             "ref_texts": rng.integers(4, 170, (b, t_text)), "ref_lengths": np.full((b,), t_text),
             "mel_input_length": np.full((b,), 198)}
    per_epoch = (2, 2, 9)
    recs = []
    snapshot = {}
    on_card = dev.type == "cuda"

    def counts():
        return dict(zip(KERNELS, (KA.fwd_launches, KA.bwd_launches, KM.launches, K2.launches)))

    def reset():
        KA.fwd_launches = KA.bwd_launches = KM.launches = K2.launches = 0

    def log_cb(it, metrics):                       # metrics are floats: the step has synced
        t = time.perf_counter()
        sub = _sub_phase(metrics)
        rec = {"iter": it, "sub_phase": sub, "metrics": metrics, "launches": counts(), "t": t}
        if snapshot:                               # this step's moved nets
            rec["moved"] = sorted(n for n, ts in snapshot.items()
                                  if any(not torch.equal(a, w) for a, w in
                                         zip(ts, nets[n].state_dict().values())))
            snapshot.clear()
        if it in (1, 3, 5, 6):                     # before a step of each sub-phase
            snapshot.update({n: [x.clone() for x in net.state_dict().values()]
                             for n, net in nets.items()})
        reset()
        if on_card:
            torch.cuda.synchronize()
        rec["t_end"] = time.perf_counter()
        recs.append(rec)

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    state = run_stage2(cfg, configs, nets, lambda epoch: iter([batch] * per_epoch[epoch]),
                       log_cb=log_cb, device=dev, seed=SEED)
    check(state.iters == sum(per_epoch) and len(recs) == state.iters,
          f"run_stage2 took {state.iters} steps")
    check(math.isfinite(state.sigma_data) and state.sigma_data != mp.diffusion.dist.sigma_data,
          f"sigma_data {state.sigma_data}")
    want_subs = ["pre_diffusion"] * 2 + ["diffusion"] * 2 + [
        "wd" if (i + 1) % 3 == 0 else "generator_slm" for i in range(9)]
    check([r["sub_phase"] for r in recs] == want_subs,
          f"sub-phases {[r['sub_phase'] for r in recs]}")
    zero = dict.fromkeys(KERNELS, 0)
    for r in recs:
        m = r["metrics"]
        check(all(math.isfinite(v) for v in m.values()), f"losses at step {r['iter']}: {m}")
        if r["sub_phase"] != "pre_diffusion":
            check(m["d_loss"] > 0 and m["diff_loss"] > 0, f"step {r['iter']}: {m}")
        if r["sub_phase"] in ("generator_slm", "wd"):
            check(m["slm_valid_fraction"] > 0, f"step {r['iter']}: no valid SLM sample")
        use_ind = host_draws(SEED, r["iter"] - 1, r["iter"] - 1 - sum(per_epoch[:2]), True,
                             cfg.slmadv_params.iter)[2]
        r["use_ind"] = use_ind and r["sub_phase"] == "generator_slm"
        want = ({**zero, **train2_launches(nets, r["sub_phase"], r["use_ind"])} if on_card
                else zero)
        check(r["launches"] == want, f"launches in step {r['iter']} ({r['sub_phase']}, "
              f"use_ind {r['use_ind']}): {r['launches']} against {want}")
        if "moved" in r:
            check(set(r["moved"]) == moves[r["sub_phase"]],
                  f"{r['sub_phase']} step {r['iter']} moved {r['moved']}")
    check(sorted(r["sub_phase"] for r in recs if "moved" in r)
          == ["diffusion", "generator_slm", "pre_diffusion", "wd"], "moved nets not checked")
    # a step's time: from the previous callback's end to its own start; an
    # epoch's first step is warm (new shapes and paths)
    firsts = {0, per_epoch[0], per_epoch[0] + per_epoch[1]}
    step_ms = {}
    for i, r in enumerate(recs):
        if i not in firsts:
            step_ms.setdefault(r["sub_phase"], []).append(1e3 * (r["t"] - recs[i - 1]["t_end"]))
    warm_ms = [1e3 * (recs[i]["t"] - (recs[i - 1]["t_end"] if i else t0)) for i in sorted(firsts)]
    medians = {k: statistics.median(v) for k, v in step_ms.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    audio_s = b * frames * 300 / 24000.0
    out = {"params": n_params, "batch": b, "frames": frames, "t_text": t_text, "mel_len": 96,
           "step_ms": step_ms, "median_step_ms": medians, "warm_step_ms": warm_ms,
           "audio_s_per_step": audio_s,
           "train_audio_s_per_s": {k: audio_s / (v / 1e3) for k, v in medians.items()},
           "peak_mem_bytes": peak, "sigma_data": state.sigma_data,
           "log": [{k: r[k] for k in ("iter", "sub_phase", "use_ind", "metrics", "launches")}
                   for r in recs],
           "moved": {r["sub_phase"]: r["moved"] for r in recs if "moved" in r},
           "launches": {k: sum(r["launches"][k] for r in recs) for k in KERNELS}}
    print(f"train2: losses {[r['metrics'] for r in recs]}", flush=True)
    print(f"train2: {len(recs)} steps; median step ms " + ", ".join(
        f"{k} {medians[k]:.3f} (of {['%.3f' % v for v in step_ms[k]]}; "
        f"{out['train_audio_s_per_s'][k]:.2f} training audio-s/s)" for k in medians)
        + f"; warm {['%.1f' % v for v in warm_ms]} ms; peak memory {peak / 2**30:.2f} GiB; "
        f"sigma_data {state.sigma_data:.6f}; launches per step (K1f, K1b, K3) "
        f"{[(r['sub_phase'], r['use_ind'], tuple(r['launches'].values())[:3]) for r in recs]}; "
        f"moved {out['moved']}; {card}", flush=True)
    if profile:
        trainer = Stage2Trainer(cfg, configs, nets, state.optimizer)
        tb = to_device(batch, dev)
        gen = torch.Generator(dev).manual_seed(SEED)
        phase = Stage2Phase(True, True, True, 96, 4, slm_frame_capacity=500)
        out["profile"] = profile_request(
            torch, lambda: float(trainer.step(tb, phase, state.sigma_data, generator=gen)[0][
                "g_loss"]),
            mark=("adain_snake_fwd", "adain_snake_bwd", "maximum_path_kernel"))
    return out


class _DumpFailures(logging.Handler):
    """Collects the trainers' "sample generation failed" warnings: a dump
    that raises only warns there, which must not hide a kernel failure."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        if "sample generation failed" in record.getMessage():
            self.messages.append(record.getMessage())


def _check_dumps(logs: Path, what: str, epochs=(0, 1)) -> None:
    """The sample dump of each epoch: three wave files and the alignment for
    each of two samples."""
    for epoch in epochs:
        dump = logs / "samples" / f"epoch_{epoch:05d}"
        names = sorted(os.listdir(dump)) if dump.is_dir() else []
        check(all(f"{i}_{k}" in names for i in (0, 1) for k in ("gt.wav", "rec.wav",
                                                                "pred.wav"))
              and all(f"{i}_attn.npy" in names or f"{i}_attn.png" in names for i in (0, 1)),
              f"{what}: samples of epoch {epoch}: {names}")


def _write_corpus(root: Path, n: int, prefix: str, rng, n_short: int, sr: int = 22050,
                  speakers: int = 1):
    """``n`` seeded 16-bit PCM WAVs at ``sr`` Hz under ``root``, half of them
    ``n_short`` samples long and the rest up to 40% longer, and their list
    of LJSpeech-style phoneme strings (``wav|phonemes|speaker``), the clips
    dealt round ``speakers`` speakers."""
    import numpy as np
    import scipy.io.wavfile as sw

    lines = []
    for i in range(n):
        length = n_short if i % 2 == 0 else n_short + int(rng.integers(1, int(0.4 * n_short)))
        pcm = (0.1 * rng.standard_normal(length) * 32767).astype(np.int16)
        sw.write(root / f"{prefix}{i:03d}.wav", sr, pcm)
        lines.append(f"{prefix}{i:03d}.wav|{PHONEMES[i % len(PHONEMES)]}|{i % speakers}\n")
    path = root / f"{prefix}_list.txt"
    path.write_text("".join(lines))
    return str(path)


def _arrays_equal_file(torch, npz, nets, optimizer) -> int:
    """Every tensor of ``nets`` and every AdamW state of ``optimizer``
    against the arrays of checkpoint ``npz`` (exact); returns the count."""
    import numpy as np

    compared = 0
    with np.load(npz) as data:
        names = set(data.files)
        for name, net in nets.items():
            for k, v in net.state_dict().items():
                check(np.array_equal(v.detach().cpu().numpy(), data[f"net.{name}.{k}"]),
                      f"resumed {name}.{k} differs from {npz}")
                compared += 1
            opt = optimizer.opts[name]
            for pname, p in net.named_parameters():
                state = opt.state.get(p, {})
                keys = sorted(k for k in names if k.startswith(f"adamw.{name}.{pname}."))
                check(len(keys) == len(state), f"AdamW state of {name}.{pname}: "
                      f"{sorted(state)} against {keys}")
                for key, value in state.items():
                    check(np.array_equal(value.detach().cpu().numpy(),
                                         data[f"adamw.{name}.{pname}.{key}"]),
                          f"resumed AdamW {key} of {name}.{pname} differs from {npz}")
                    compared += 1
    return compared


def _ood_list(path: Path, rng, n: int = 16) -> str:
    """``n`` seeded out-of-distribution texts, two of ``PHONEMES`` each (every
    one longer than ``data_params.min_length``'s 50 characters)."""
    path.write_text("".join(f"{PHONEMES[int(rng.integers(4))]} {PHONEMES[int(rng.integers(4))]}"
                            f"|0\n" for _ in range(n)))
    return str(path)


def phase_train_files(torch, KA, KM, K2, card="", dev=None, overrides=None,
                      config="ljspeech.yml", sr=22050, speakers=1, clips=(32, 16),
                      n_short=45400, finetune=False):
    """The trainers as users run them, from files on disk: the entry points
    ``train_stage1.main`` and ``train_stage2.main``, called in this process,
    at the full width of ``configs/<config>`` (``init_reference_`` seed 0,
    random frozen encoders: their files are not in the repository; f32, TF32
    off), on a seeded corpus of noise WAVs at ``sr`` Hz dealt round
    ``speakers`` speakers: ``clips`` train and validation clips, half of
    them ``n_short`` samples (198 mel frames with the loader's padding, so
    every batch's clip is 96 aligner frames), ``wav|phonemes|speaker``
    lists and an out-of-distribution text list.  Batch 16, the other train
    phases', so ``clips[0] // 16`` steps an epoch, and
    ``slmadv_params.iter`` as many, so a joint epoch ends on a WD step.  In
    order:
    1. ``train_stage1.main``: 2 epochs, ``TMA_epoch`` 1;
    2. ``train_stage2.main`` from the ``first_stage.npz`` it wrote:
       ``diff_epoch`` 0, ``joint_epoch`` 1 (an epoch with diffusion, then
       generator-SLM steps and a WD step);
    3. with ``finetune``, ``train_stage2.main --finetune`` on
       ``configs/ljspeech_ft.yml`` with ``pretrained_model`` the
       ``2nd_stage.npz`` just written: 2 joint epochs;
    each run then resumed from its first epoch's checkpoint for one step
    (``--max_steps 1``).  Validation and a sample dump after every epoch.
    Checks per step finite losses (``mono_loss`` and ``s2s_loss`` in
    fine-tuning), the nets that move and that the others stay bitwise equal,
    every decoder parameter moved when the decoder trains (the iSTFTNet's
    constant source merge aside),
    K1f/K1b/K3 launches equal to the derived counts (``train2_launches``; a
    stage-1 step runs each of the decoder's pairs once each way, a
    validation with its dump three times forward), the files and metrics
    lines written, ``sigma_data`` moved, sample dumps without a "sample
    generation failed" warning, each resumed run's first step with the
    straight run's losses, and that a load of the first stage-1 checkpoint
    gives its nets and AdamW states exactly; records the median step per
    sub-phase, the loader's wait per batch, the peak memory of each run,
    the checkpoints' bytes, the last run's save and load, and the stage-1
    validation step per batch.  ``dev`` and ``overrides`` (merged into
    every YAML, ``batch_size`` included) size a rehearsal on the CPU."""
    import tempfile

    import numpy as np
    import yaml
    from styletts2_tpu_torch import train_stage1, train_stage2
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data import build_dataloader
    from styletts2_tpu_torch.models.decoder import hifigan
    from styletts2_tpu_torch.models.zoo import STAGE1_SAMPLE_NETS, STAGE1_TMA_NETS, build_nets
    from styletts2_tpu_torch.train import loop as train_loop
    from styletts2_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from styletts2_tpu_torch.train.loop import (VAL_STREAM, _bucket, _clip_lengths, host_draws,
                                                make_lr_map, seeded_generator, to_device)
    from styletts2_tpu_torch.train.optimizers import MultiOptimizer
    from styletts2_tpu_torch.train.stage1 import DISCRIMINATORS, TMA_TRAINED, TRAINED
    from styletts2_tpu_torch.train.stage2 import generator_nets
    from styletts2_tpu_torch.train.validate import make_stage1_val_step

    on_card = dev is None or torch.device(dev).type == "cuda"
    zero = dict.fromkeys(KERNELS, 0)
    disc = set(DISCRIMINATORS)
    moves = {"pre_tma": set(TRAINED), "tma": set(TMA_TRAINED) | disc,
             "diffusion": set(generator_nets(True, False)) | disc,
             "generator_slm": set(generator_nets(True, True)) | disc,
             "wd": set(generator_nets(True, True)) | disc | {"wd"},
             "ft_generator_slm": set(generator_nets(True, True, True)) | disc,
             "ft_wd": set(generator_nets(True, True, True)) | disc | {"wd"}}
    held = {}
    originals = (train_loop.run_stage1, train_loop.run_stage2)

    def holding(run):
        """``run`` that first keeps its nets here, and a host copy of them
        unless it resumes (its first step starts from the loaded state)."""
        def wrapped(cfg, configs, nets, *args, **kw):
            held["nets"] = nets
            if not kw.get("resume_from"):
                held["before"] = _host_copy(nets)
            return run(cfg, configs, nets, *args, **kw)
        return wrapped

    def counts():
        return dict(zip(KERNELS, (KA.fwd_launches, KA.bwd_launches, KM.launches, K2.launches)))

    def reset():
        KA.fwd_launches = KA.bwd_launches = KM.launches = K2.launches = 0

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def release():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    label = f"train {Path(config).stem}"
    batch = (overrides or {}).get("batch_size", 16)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_files_"))
    per_epoch = clips[0] // batch
    out = {"config": config, "clips": list(clips), "n_short": n_short, "sr": sr,
           "speakers": speakers, "batch": batch}
    dumps_failed = _DumpFailures()
    loop_log = logging.getLogger("styletts2_tpu_torch.train.loop")
    loop_log.addHandler(dumps_failed)
    train_loop.run_stage1, train_loop.run_stage2 = map(holding, originals)
    try:
        rng = np.random.default_rng(SEED)
        data = {"train_data": _write_corpus(tmp, clips[0], "train", rng, n_short, sr, speakers),
                "val_data": _write_corpus(tmp, clips[1], "val", rng, n_short, sr, speakers),
                "root_path": str(tmp), "OOD_data": _ood_list(tmp / "ood_texts.txt", rng)}

        def spec_of(name, **top):
            spec = yaml.safe_load((ROOT / "configs" / name).read_text())
            spec.update({"save_freq": 1, "log_interval": 1, "batch_size": 16, **top})
            spec["data_params"].update(data)
            spec["slmadv_params"]["iter"] = per_epoch
            for key, value in (overrides or {}).items():
                spec[key] = {**spec[key], **value} if isinstance(value, dict) else value
            return spec

        logs = tmp / "logs"
        s12 = spec_of(config, log_dir=str(logs), first_stage_path="first_stage.npz",
                      epochs_1st=2, epochs_2nd=2)
        s12["loss_params"].update({"TMA_epoch": 1, "diff_epoch": 0, "joint_epoch": 1})
        min_len = s12["data_params"].get("min_length", 50)
        check(all(len(ln.split("|")[0]) >= min_len
                  for ln in Path(data["OOD_data"]).read_text().splitlines()),
              f"{label}: an OOD text is shorter than min_length")
        train_list = Path(data["train_data"]).read_text().splitlines()
        loader = build_dataloader(train_list, str(tmp), batch_size=batch)
        out["mel_len"] = [_bucket(_clip_lengths(b["mel_input_length"], s12["max_len"]))
                          for epoch in (0, 1) for b in loader(epoch)]
        if overrides is None:
            check(out["mel_len"] == [96] * 2 * per_epoch,
                  f"the corpus's clips are {out['mel_len']}")
        os.environ[RANDOM_ENCODERS] = "1"
        print(f"{label}: the frozen encoders (ASR, JDC, PL-BERT, Whisper) keep random weights "
              f"({RANDOM_ENCODERS}=1): their files are not in the repository", flush=True)

        def run(main, spec, extra, log_dir, stage):
            """One entry-point call into ``log_dir`` and the records of its
            steps and validations, each step's moved nets and launches checked."""
            spec = {**spec, "log_dir": str(log_dir)}
            yml = tmp / f"{stage}.yml"
            yml.write_text(yaml.safe_dump(spec, allow_unicode=True))
            metrics_file = log_dir / "metrics.jsonl"
            lines0 = len(metrics_file.read_text().splitlines()) if metrics_file.exists() else 0
            recs = []

            def log_cb(it, metrics):
                t = time.perf_counter()
                val = "val_mel_loss" in metrics
                kind = ("val" if val else ("tma" if "d_loss" in metrics else "pre_tma")
                        if stage == "stage1" else _sub_phase(metrics))
                kind = f"ft_{kind}" if stage == "finetune" and not val else kind
                rec = {"iter": it, "kind": kind, "metrics": metrics, "launches": counts(),
                       "t": t}
                reset()
                if not val:
                    now = _host_copy(held["nets"])
                    if "before" in held:
                        rec["moved"] = sorted(n for n in now if any(
                            not torch.equal(a, b) for a, b in zip(held["before"][n], now[n])))
                        if "decoder" in rec["moved"]:
                            # every decoder parameter is in the step's graph
                            # (but the iSTFTNet's source merge: its source is
                            # a constant), so none may stay equal
                            dec = held["nets"]["decoder"]
                            fixed = () if isinstance(dec, hifigan.Decoder) else (
                                "generator.m_source.",)
                            params = {k for k, _ in dec.named_parameters()
                                      if not k.startswith(fixed)}
                            rec["decoder_still"] = [
                                k for k, a, b in zip(dec.state_dict(), held["before"]["decoder"],
                                                     now["decoder"])
                                if k in params and torch.equal(a, b)]
                    held["before"] = now
                rec["t_end"] = time.perf_counter()
                recs.append(rec)

            if on_card:
                sync()
                torch.cuda.reset_peak_memory_stats()
            reset()
            t0 = time.perf_counter()
            argv = ["--config_path", str(yml)] + (["--device", dev] if dev else []) + extra
            state = main(argv, log_cb=log_cb)
            wall = time.perf_counter() - t0
            check(not dumps_failed.messages, f"{label} {stage}: {dumps_failed.messages}")
            check(len(metrics_file.read_text().splitlines()) == lines0 + len(recs),
                  f"{label} {stage}: {metrics_file} does not hold {len(recs)} new lines")
            pairs = train2_launches(state.nets, "wd")["adain_snake_bwd"]
            for i, rec in enumerate(recs):
                m, kind = rec["metrics"], rec["kind"]
                check(all(np.isfinite(v) for v in m.values()),
                      f"{label} {stage} losses at iter {rec['iter']}: {m}")
                if kind == "val":       # a validation batch and the sample dump's two passes
                    want = {"adain_snake_fwd": 3 * pairs, "adain_snake_bwd": 0,
                            "maximum_path": 2}
                elif stage == "stage1":
                    want = {"adain_snake_fwd": pairs, "adain_snake_bwd": pairs,
                            "maximum_path": 1}
                else:
                    sub = kind.removeprefix("ft_")
                    steps_before = sum(r["kind"] != "val" for r in recs[:i])
                    use_ind = sub == "generator_slm" and host_draws(
                        SEED, rec["iter"] - 1, steps_before % per_epoch, True,
                        spec["slmadv_params"]["iter"])[2]
                    rec["use_ind"] = use_ind
                    want = train2_launches(state.nets, sub, use_ind)
                check(rec["launches"] == ({**zero, **want} if on_card else zero),
                      f"{label} {stage} launches at iter {rec['iter']} ({kind}): "
                      f"{rec['launches']} against {want}")
                if "moved" in rec:
                    check(set(rec["moved"]) == moves[kind], f"{label} {stage} step "
                          f"{rec['iter']} ({kind}) moved {rec['moved']}")
                    check(not rec.get("decoder_still"), f"{label} {stage} step {rec['iter']} "
                          f"({kind}): decoder parameters unchanged {rec.get('decoder_still')}")
                if stage == "finetune" and kind != "val":
                    check({"mono_loss", "s2s_loss"} <= set(m), f"fine-tune step metrics {m}")
            step_ms = {}
            for a, b in zip(recs, recs[1:]):
                if not (a["kind"] == "val" or b["kind"] == "val"):
                    step_ms.setdefault(b["kind"], []).append(1e3 * (b["t"] - a["t_end"]))
            held.clear()
            return state, {"wall_s": wall, "step_ms": step_ms,
                           "log": [{k: r[k] for k in ("iter", "kind", "metrics", "launches")
                                    if k in r} for r in recs],
                           "moved": {r["kind"]: r["moved"] for r in recs if "moved" in r},
                           "data_wait_ms": [1e3 * w for w in state.data_wait_s],
                           "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else 0}

        def epoch_of(*kinds):
            return list(kinds[:1]) * (per_epoch - 1) + list(kinds[1:]) + ["val"]

        s1_keys = ("mel_loss", "mono_loss", "s2s_loss", "slm_loss", "d_loss")
        s2_keys = ("mel_loss", "dur_loss", "ce_loss", "norm_loss", "F0_loss", "lm_loss",
                   "sty_loss", "diff_loss", "d_loss")
        stages = [("stage1", train_stage1.main, s12, [], logs, "1st", "first_stage.npz",
                   epoch_of("pre_tma", "pre_tma") + epoch_of("tma", "tma"), s1_keys),
                  ("stage2", train_stage2.main, s12, [], logs, "2nd", "2nd_stage.npz",
                   epoch_of("diffusion", "diffusion") + epoch_of("generator_slm", "wd"),
                   s2_keys)]
        if finetune:
            ft = spec_of("ljspeech_ft.yml", epochs=2,
                         pretrained_model=str(logs / "2nd_stage.npz"))
            stages.append(("finetune", train_stage2.main, ft, ["--finetune"], tmp / "logs_ft",
                           "ft", "ft_stage.npz", epoch_of("ft_generator_slm", "ft_wd") * 2,
                           s2_keys + ("mono_loss", "s2s_loss")))
        out["ckpt_bytes"] = {}
        for stage, entry, spec, flags, log_dir, tag, final, want, keys in stages:
            state, first = run(entry, spec, flags, log_dir, stage)
            check((state.epoch, state.iters) == (2, 2 * per_epoch)
                  and [r["kind"] for r in first["log"]] == want,
                  f"{label} {stage}: epoch {state.epoch}, iters {state.iters}, "
                  f"{[r['kind'] for r in first['log']]}")
            for name in (f"epoch_{tag}_00000.npz", f"epoch_{tag}_00001.npz", final):
                check((log_dir / name).is_file(), f"{label} {stage}: {name} not written")
            if stage != "stage1":
                check(math.isfinite(state.sigma_data) and state.sigma_data != 0.2,
                      f"{label} {stage}: sigma_data {state.sigma_data}")
                meta = json.loads((log_dir / (final + ".meta.json")).read_text())
                check(math.isfinite(meta["extra"].get("sigma_data", math.nan)),
                      f"{label} {stage}: {final} holds no sigma_data: {meta}")
                vals = [r["metrics"] for r in first["log"] if r["kind"] == "val"]
                check(all(set(v) == {"val_mel_loss", "val_dur_loss", "val_F0_loss"}
                          for v in vals), f"{label} {stage} validation: {vals}")
                first["sigma_data"] = state.sigma_data
            _check_dumps(log_dir, f"{label} {stage}")
            out["ckpt_bytes"][f"epoch_{tag}_00000"] = (
                log_dir / f"epoch_{tag}_00000.npz").stat().st_size
            out["ckpt_bytes"][final] = (log_dir / final).stat().st_size

            if stage == "stage1":
                # the validation step on the trained nets, per batch
                cfg = train_stage1.grow_n_token(load_config(str(tmp / "stage1.yml")))
                val_list = Path(data["val_data"]).read_text().splitlines()
                val_loader = build_dataloader(val_list, str(tmp), validation=True,
                                              batch_size=batch)
                device = next(state.nets.parameters()).device
                gen = seeded_generator(SEED, 0, device, VAL_STREAM)
                out["val_ms"], out["val_loss"] = [], []
                pairs = train2_launches(state.nets, "wd")["adain_snake_bwd"]
                want_val = {**zero, "adain_snake_fwd": pairs, "maximum_path": 1}
                for b in [b for _ in range(3) for b in val_loader(0)]:
                    tb = to_device(b, device)
                    step = make_stage1_val_step(cfg, {}, _bucket(_clip_lengths(
                        b["mel_input_length"], s12["max_len"])))
                    u = torch.rand((tb["texts"].shape[0],), generator=gen, device=device)
                    sync()
                    reset()
                    t0 = time.perf_counter()
                    out["val_loss"].append(float(step(state.nets, tb, u)["mel_loss"]))
                    out["val_ms"].append(1e3 * (time.perf_counter() - t0))
                    check(counts() == (want_val if on_card else zero),
                          f"{label} validation launches: {counts()}")
                del step
            if stage == stages[-1][0]:
                # a checkpoint's save and load, timed on the last run's state
                timed = tmp / "timed.npz"
                sync()
                t0 = time.perf_counter()
                save_checkpoint(str(timed), state.nets, state.optimizer, state.epoch,
                                state.iters, extra={"sigma_data": state.sigma_data})
                out["save_s"] = time.perf_counter() - t0
                out["save_bytes"] = timed.stat().st_size
                t0 = time.perf_counter()
                load_checkpoint(str(timed), state.nets, state.optimizer)
                sync()
                out["load_s"] = time.perf_counter() - t0
                timed.unlink()
            del state
            release()

            if stage == "stage1":
                # a load of the epoch-0 checkpoint gives its nets and AdamW states exactly
                nets = build_nets(cfg.model_params,
                                  nets=STAGE1_TMA_NETS + STAGE1_SAMPLE_NETS).to(device)
                opt = MultiOptimizer(nets, make_lr_map(cfg), default_lr=cfg.optimizer_params.lr)
                _, epoch0, iters0, _ = load_checkpoint(str(logs / "epoch_1st_00000.npz"),
                                                       nets, opt)
                check((epoch0, iters0) == (1, per_epoch),
                      f"epoch_1st_00000 holds epoch {epoch0}, iters {iters0}")
                out["resume_tensors_equal"] = _arrays_equal_file(
                    torch, logs / "epoch_1st_00000.npz", nets, opt)
                del nets, opt
                release()

            # the resumed run's first step sees the nets, states, sigma_data
            # and noise of the straight run's first step of epoch 1: its
            # losses before any update agree
            state, resumed = run(entry, spec, flags + ["--max_steps", "1", "--resume",
                                                      str(log_dir / f"epoch_{tag}_00000.npz")],
                                 tmp / f"resumed_{stage}", stage)
            check((state.epoch, state.iters) == (1, per_epoch + 1)
                  and [r["kind"] for r in resumed["log"]] == want[per_epoch + 1:per_epoch + 2],
                  f"{label} {stage} resumed: {resumed['log']}")
            straight = [r for r in first["log"] if r["kind"] != "val"][per_epoch]["metrics"]
            for key in keys:
                a, b = straight[key], resumed["log"][0]["metrics"][key]
                check(abs(a - b) <= 1e-6 * abs(a), f"{label} {stage}: the resumed run's "
                      f"first step {key} {b} against {a}")
            del state
            release()
            out[stage] = {"first": first, "resumed": resumed}
            for f in log_dir.glob(f"epoch_{tag}_*"):
                f.unlink()
    finally:
        train_loop.run_stage1, train_loop.run_stage2 = originals
        loop_log.removeHandler(dumps_failed)
        os.environ.pop(RANDOM_ENCODERS, None)
        shutil.rmtree(tmp, ignore_errors=True)
        release()
    names = [s[0] for s in stages]
    runs = {f"{s}/{r}": out[s][r] for s in names for r in ("first", "resumed")}
    medians = {}
    for rec in runs.values():
        for kind, times in rec["step_ms"].items():
            medians.setdefault(kind, []).extend(times)
    out["median_step_ms"] = {k: statistics.median(v) for k, v in medians.items()}
    out["peak_mem_bytes"] = {k: r["peak_mem_bytes"] for k, r in runs.items()}
    waits = [w for r in runs.values() for w in r["data_wait_ms"]]
    out["data_wait_median_ms"] = statistics.median(waits)
    out["launches"] = {name: sum(rec["launches"][name] for s in names
                                 for rec in out[s]["first"]["log"]) for name in KERNELS}
    for s in names:
        print(f"{label} {s}: losses {[r['metrics'] for r in out[s]['first']['log']]}, resumed "
              f"{[r['metrics'] for r in out[s]['resumed']['log']]}", flush=True)
    print(f"{label}: median step ms {out['median_step_ms']} (of "
          f"{ {k: ['%.1f' % t for t in v] for k, v in medians.items()} }); loader wait per "
          f"batch median {out['data_wait_median_ms']:.3f} ms (of {len(waits)}); validation "
          f"{['%.3f' % v for v in out['val_ms']]} ms per batch of {batch}; peak memory GiB "
          f"{ {k: round(v / 2**30, 2) for k, v in out['peak_mem_bytes'].items()} }; checkpoint "
          f"bytes {out['ckpt_bytes']}, save {out['save_s']:.3f} s and load {out['load_s']:.3f} s "
          f"of {out['save_bytes']} bytes; the first stage-1 checkpoint's nets and AdamW states "
          f"loaded exactly ({out['resume_tensors_equal']} tensors); sigma_data "
          f"{ {s: out[s]['first']['sigma_data'] for s in names[1:]} }; launches (K1f, K1b, K3) "
          f"{[(r['kind'], tuple(r['launches'].values())[:3]) for s in names for r in out[s]['first']['log']]}; "
          f"moved {[out[s]['first']['moved'] for s in names]}; each resume's first step equals "
          f"the straight run's; {card}", flush=True)
    return out


def _host_copy(nets) -> dict:
    """A host copy of every tensor of ``nets``, per net."""
    return {n: [t.detach().to("cpu", copy=True) for t in net.state_dict().values()]
            for n, net in nets.items()}


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

    from styletts2_tpu_torch.kernels import adain_snake as KA
    from styletts2_tpu_torch.kernels import build
    from styletts2_tpu_torch.kernels import maximum_path as KM
    from styletts2_tpu_torch.kernels import mrf_round as K

    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(logs)} in {build_s:.2f} s", flush=True)
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}", flush=True)
    sass = sass_mma_counts(build.library_path("mrf_round"))
    print(f"mrf_round SASS tensor-core instructions: {sass}", flush=True)
    check(sum(n for op, n in sass.items() if "TF32" in op) > 0,
          f"libmrf_round has no TF32 tensor-core instruction: {sass}")
    check(sum(n for op, n in sass.items() if "BF16" in op) > 0,
          f"libmrf_round has no bf16 tensor-core instruction: {sass}")

    profile = "--profile" in sys.argv[1:]
    kernel_rows = phase_kernels(torch, K)
    train_kernel_rows = phase_train_kernels(torch, KA, KM)
    serve = phase_serve(torch, K, profile=profile)
    gc.collect()                          # the LJSpeech nets go before LibriTTS's
    torch.cuda.empty_cache()
    serve_libritts = phase_serve_libritts(torch, K, KA, profile=profile, card=card)
    bf16_kernel_rows = phase_kernels_bf16(torch, K)
    serve_bf16 = phase_serve_bf16(torch, K, card=card)
    serve_many = phase_serve_many(torch, K, card=card)
    train = phase_train(torch, KA, KM, K, profile=profile, card=card)
    gc.collect()                          # the pre-TMA nets and optimizer go first
    torch.cuda.empty_cache()
    train_tma = phase_train(torch, KA, KM, K, profile=profile, tma=True, card=card)
    gc.collect()                          # the TMA nets go before stage 2
    torch.cuda.empty_cache()
    train2 = phase_train2(torch, KA, KM, K, profile=profile, card=card)
    gc.collect()                          # the stage-2 nets go before the trainer from files
    torch.cuda.empty_cache()
    train_files = phase_train_files(torch, KA, KM, K, card=card)
    gc.collect()                          # the LJSpeech trainer goes before LibriTTS's
    torch.cuda.empty_cache()
    train_libritts = phase_train_files(torch, KA, KM, K, card=card, config="libritts.yml",
                                       sr=24000, speakers=4, clips=(48, 16), n_short=49415,
                                       finetune=True)
    files_launches = train_files["launches"]

    timed = {r["stage"]: r for r in kernel_rows if "ms" in r}
    s1 = timed["stage1"]
    kernels = [{
        "name": "mrf_round", "route": "cuda", "source": "styletts2_tpu_torch/csrc/mrf_round.cu",
        "replaces": "styletts2_tpu/ops/pallas/mrf_round_kernel.py:183",
        "launches": serve["runs"]["batched"]["launches"],
        "launches_libritts": serve_libritts["runs"]["batched"]["launches"],
        "launches_train_files": files_launches["mrf_round"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows if "max_abs_err" in r),
        "ms": s1["ms"], "device_ms": s1["device_ms"], "plain_ms": s1["plain_ms"], "bound_ms": s1["bound_ms"],
        "bound_by": s1["bound_by"], "library_ms": s1["library_ms"], "shape": s1["shape"],
        "bound_f32_ms": s1["bound_f32_ms"], "library_tf32_ms": s1["library_tf32_ms"],
    }]
    b1 = {r["stage"]: r for r in bf16_kernel_rows if "ms" in r}["stage1_b4"]
    kernels.append({
        "name": "mrf_round_bf16", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/mrf_round.cu",
        "replaces": "styletts2_tpu/ops/pallas/mrf_round_kernel.py:183",
        "launches": serve_bf16["ljspeech"]["runs"]["batched"]["bf16_launches"],
        "launches_libritts": serve_bf16["libritts"]["runs"]["batched"]["bf16_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16_kernel_rows if "max_abs_err" in r),
        "ms": b1["ms"], "device_ms": b1["device_ms"], "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
        "library_ms": b1["library_ms"], "shape": b1["shape"]})
    k1 = next(r for r in train_kernel_rows if r.get("shape") == "B=16 C=128 T=11521"
              and "fwd_ms" in r)
    k1_err = [r for r in train_kernel_rows if "fwd_max_abs_err" in r]
    k3 = next(r for r in train_kernel_rows if "ms" in r and "case" in r)
    for name, direction, replaces in (
            ("adain_snake_fwd", "fwd", "styletts2_tpu/ops/pallas/adain_snake_kernel.py:134"),
            ("adain_snake_bwd", "bwd", "styletts2_tpu/ops/pallas/adain_snake_kernel.py:157")):
        kernels.append({
            "name": name, "route": "cuda", "source": "styletts2_tpu_torch/csrc/adain_snake.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "launches_tma": train_tma["launches"][name],
            "launches_train2": train2["launches"][name],
            "launches_train_files": files_launches[name],
            "launches_train_libritts": train_libritts["launches"][name],
            "max_abs_err": max(r[f"{direction}_max_abs_err"] for r in k1_err),
            "ms": k1[f"{direction}_ms"], "device_ms": k1[f"{direction}_device_ms"],
            "plain_ms": k1[f"{direction}_plain_ms"],
            "bound_ms": k1[f"{direction}_bound_ms"], "bound_by": k1[f"{direction}_bound_by"],
            "library_ms": None, "shape": k1["shape"], "path": k1[f"{direction}_path"]})
    kernels.append({
        "name": "maximum_path", "route": "cuda",
        "source": "styletts2_tpu_torch/csrc/maximum_path.cu",
        "replaces": "styletts2_tpu/ops/pallas/monotonic_kernel.py:80",
        "launches": train["launches"]["maximum_path"],
        "launches_tma": train_tma["launches"]["maximum_path"],
        "launches_train2": train2["launches"]["maximum_path"],
        "launches_train_files": files_launches["maximum_path"],
        "launches_train_libritts": train_libritts["launches"]["maximum_path"],
        "max_abs_err": max(r["max_abs_err"] for r in train_kernel_rows if "case" in r),
        "ms": k3["ms"], "device_ms": k3["device_ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": None, "shape": k3["shape"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "build_s": build_s, "nvcc_logs": logs, "mrf_round_sass_mma": sass,
         "kernel_checks": kernel_rows,
         "train_kernel_checks": train_kernel_rows, "serve": serve,
         "serve_libritts": serve_libritts, "bf16_kernel_checks": bf16_kernel_rows,
         "serve_bf16": serve_bf16, "serve_many": serve_many, "train": train,
         "train_tma": train_tma, "train2": train2, "train_files": train_files,
         "train_libritts": train_libritts,
         "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
