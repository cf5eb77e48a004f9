#!/usr/bin/env python3
"""Times the parts of one stage-1 TMA step of the PyTorch port on one NVIDIA
GPU in three settings: f32 with cuDNN's heuristics (the port's default),
f32 with cuDNN's algorithm search (``cudnn.benchmark``), and TF32
convolutions and matmuls on the tensor cores with the search (a yardstick
only: the port trains in f32 for its parity with the JAX package).

    python3 scripts/torch_tma_parts.py [--reps N]

From the root of a checkout, on a machine with a CUDA card and ``nvcc``.
It builds chip_smoke's TMA configuration (the full-width LJSpeech
``STAGE1_TMA_NETS`` with seeded random weights, a Whisper-base encoder,
batch 16 of 208 mel frames, 128 tokens, clip 96 aligner frames, f32, TF32
off) and times, each as one forward and backward on the same batch with no
update (median of ``--reps`` CUDA-event timings after a warm call, with the
peak memory of the part):
- the forward to the waveform and its STFT loss, before TMA and with the
  aligner and pitch extractor in the graph (the mono and s2s losses added);
- the aligner alone (its forward, the monotonic path, the mono and s2s
  losses) and the pitch extractor alone on the clip, with a torch.profiler
  reading of the aligner's device busy share;
- the discriminator step's loss, whole and for MPD and MSD alone (one 2B
  pass each);
- the generator side's MPD/MSD loss with its recomputation, and without;
- the Whisper feature loss;
- a whole TMA step through ``Stage1Trainer.step`` (updates included).

Prints one line per part and writes chiprun_out/tma_parts.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args().reps
    import numpy as np
    import torch

    from chip_smoke import SEED, check, cuda_ms, profile_request
    from styletts2_tpu_torch.audio.mel import DATASET_MEL, log_mel_spectrogram
    from styletts2_tpu_torch.config import Config, ModelParams
    from styletts2_tpu_torch.losses.gan import discriminator_loss, tprls_loss
    from styletts2_tpu_torch.losses.slm import slm_feature_loss
    from styletts2_tpu_torch.models.discriminators import mpd_apply, msd_apply
    from styletts2_tpu_torch.models.jdc import jdc_apply
    from styletts2_tpu_torch.models.zoo import STAGE1_TMA_NETS, build_nets, init_random_
    from styletts2_tpu_torch.train.loop import make_lr_map
    from styletts2_tpu_torch.train.optimizers import MultiOptimizer
    from styletts2_tpu_torch.train.stage1 import (Stage1Noise, Stage1Trainer,
                                                  compute_alignment,
                                                  discriminator_step_loss, frozen,
                                                  generator_adversarial_loss, mono_loss,
                                                  s2s_loss, stage1_loss)

    check(torch.cuda.is_available(), "no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    mp, cfg = ModelParams(), Config()
    nets = init_random_(build_nets(mp, nets=STAGE1_TMA_NETS), SEED)
    with torch.no_grad():                          # as in chip_smoke
        nets["decoder"].generator.conv_post.weight_g.mul_(0.05)
    nets.to(dev)
    trainer = Stage1Trainer(cfg, {"model": mp}, nets,
                            MultiOptimizer(nets, make_lr_map(cfg), cfg.optimizer_params.lr))
    rng = np.random.default_rng(SEED)
    b, frames, t_text, mel_len = 16, 208, 128, 96
    tb = {"waves": torch.from_numpy((0.1 * rng.standard_normal((b, frames * 300))
                                     ).astype(np.float32)).to(dev),
          "texts": torch.from_numpy(rng.integers(4, 170, (b, t_text))).to(dev),
          "input_lengths": torch.full((b,), t_text, device=dev),
          "mel_input_length": torch.full((b,), 198, device=dev)}
    gen = torch.Generator(dev).manual_seed(SEED)
    noise = Stage1Noise.draw(gen, nets, tb, mel_len)

    def forward(tma):
        def run():
            loss, aux = stage1_loss(nets, mp, tb, noise, mel_len, mel_len, tma=tma)
            if tma:
                loss = (loss + mono_loss(aux["s2s_attn"], aux["s2s_attn_mono"])
                        + s2s_loss(aux["s2s_pred"], aux["texts"], aux["text_lengths"]))
            loss.backward()
        return run

    with torch.no_grad():
        _, aux = stage1_loss(nets, mp, tb, noise, mel_len, mel_len, tma=True)
    wav, y_rec = aux["wav"], aux["y_rec"]
    y = wav[:, None, :]
    del aux

    mels = log_mel_spectrogram(tb["waves"], DATASET_MEL)
    mels = mels[..., : (mels.shape[-1] // 2) * 2]

    def aligner():
        _, s2s_pred, s2s_attn, mono = compute_alignment(
            nets["text_aligner"], mels, tb["mel_input_length"], tb["texts"],
            tb["input_lengths"], noise.asr)
        (mono_loss(s2s_attn, mono) + s2s_loss(s2s_pred, tb["texts"], tb["input_lengths"])
         ).backward()

    def pitch_extractor():
        jdc_apply(nets["pitch_extractor"], mels[:, None, :, : 2 * mel_len])[0].sum().backward()

    def d_family(apply, m):
        def run():
            real, fake, _, _ = apply(m, y, y_rec)
            (discriminator_loss(real, fake) + tprls_loss(real, fake)).backward()
        return run

    def generator_side(fn):
        def run():
            leaf = y_rec.clone().requires_grad_()
            with frozen(nets[n] for n in ("mpd", "msd", "slm_encoder")):
                fn(leaf).backward()
        return run

    parts = {
        "forward_backward_pre_tma": forward(False),
        "forward_backward_tma": forward(True),
        "aligner": aligner,
        "pitch_extractor": pitch_extractor,
        "discriminator_step": lambda: discriminator_step_loss(
            nets["mpd"], nets["msd"], wav, y_rec).backward(),
        "discriminator_step_mpd": d_family(mpd_apply, nets["mpd"]),
        "discriminator_step_msd": d_family(msd_apply, nets["msd"]),
        "generator_mpd_msd": generator_side(lambda yr: generator_adversarial_loss(
            nets["mpd"], nets["msd"], wav, yr)),
        "generator_mpd_msd_no_remat": generator_side(lambda yr: generator_adversarial_loss(
            nets["mpd"], nets["msd"], wav, yr, remat=False)),
        "slm_whisper": generator_side(lambda yr: slm_feature_loss(
            nets["slm_encoder"], wav, yr[:, 0, :], mp.slm.hop_length)),
        "tma_step": lambda: trainer.step(tb, mel_len, mel_len, noise=noise, tma=True),
    }
    out = {"card": card, "reps": reps, "batch": b, "frames": frames, "mel_len": mel_len}
    for key, bench, tf32 in (("cudnn_heuristics", False, False),
                             ("cudnn_benchmark", True, False), ("tf32", True, True)):
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
        out[key] = {}
        for name, fn in parts.items():
            nets.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ms = cuda_ms(fn, reps=reps, warmup=1)
            out[key][name] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                              "wall_s": time.perf_counter() - t0}
            print(f"{key} {name}: {ms:.3f} ms, peak {out[key][name]['peak_gib']:.2f} GiB; "
                  f"{card}", flush=True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out["aligner_profile"] = profile_request(torch, aligner, mark=("gemv", "elementwise"))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tma_parts.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
