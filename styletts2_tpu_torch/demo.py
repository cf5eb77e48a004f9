"""Demo CLI — the notebook inference flows as a script, on the GPU (the
port of the root ``demo.py``; ref: Demo/Inference_LJSpeech.ipynb,
Demo/Inference_LibriTTS.ipynb).

Examples:
  # LJSpeech, pre-phonemized input
  python -m styletts2_tpu_torch.demo --ckpt second_stage.npz \\
      --phonemes "ðɪs ɪz ə tɛst ." --out out.wav

  # multispeaker zero-shot with a reference clip
  python -m styletts2_tpu_torch.demo --config configs/libritts.yml --ckpt ms.npz \\
      --phonemes "..." --ref_audio speaker.wav --alpha 0.3 --beta 0.7

  # on the CPU
  python -m styletts2_tpu_torch.demo --phonemes "..." --device cpu

  # bf16 serving: the nets cast to bf16 and the engine's compute_dtype set
  python -m styletts2_tpu_torch.demo --phonemes "..." --bf16

``--ckpt`` takes the port's or the JAX package's ``.npz`` checkpoints and
reference ``.pth`` ones; without it the nets take the reference's
initialisation, seeded 0.  ``--text`` needs ``phonemizer`` with espeak-ng.
"""

from __future__ import annotations

import argparse
import time
import wave as wave_mod
from typing import Optional, Sequence

import numpy as np

INIT_SEED = 0


def write_wav(path: str, wav: np.ndarray, sr: int = 24000):
    """Mono PCM16, clipped to [-1, 1] (the root ``demo.py``'s writer)."""
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/ljspeech.yml")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--text", default=None, help="raw text (needs phonemizer)")
    ap.add_argument("--phonemes", default=None, help="pre-phonemized input")
    ap.add_argument("--out", default="out.wav")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--embedding_scale", type=float, default=1.0)
    ap.add_argument("--ref_audio", default=None)
    ap.add_argument("--alpha", type=float, default=0.3)
    ap.add_argument("--beta", type=float, default=0.7)
    ap.add_argument("--long_form", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    if not (args.text or args.phonemes):
        ap.error("provide --text or --phonemes")

    import torch

    from .config import load_config
    from .infer import InferenceEngine, resolve_device
    from .models.plbert import PLBertConfig
    from .models.zoo import (INFERENCE_NETS, STYLE_INFERENCE_NETS, build_nets,
                             export_params, init_reference_, load_jax_params)
    from .train.checkpoint import convert_reference_checkpoint, load_checkpoint
    from .utils import rtf

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    mp = cfg.model_params
    if args.phonemes:
        phonemes = args.phonemes
    else:
        from .text.phonemize import phonemize

        phonemes = phonemize(args.text)

    names = STYLE_INFERENCE_NETS if (mp.multispeaker or args.ref_audio) else INFERENCE_NETS
    nets = init_reference_(build_nets(mp, PLBertConfig(), nets=names),
                           torch.Generator().manual_seed(INIT_SEED))
    if args.ckpt:
        if args.ckpt.endswith(".pth"):
            converted = convert_reference_checkpoint(args.ckpt, export_params(nets))
            load_jax_params({n: nets[n] for n in converted if n in nets}, converted)
        else:
            load_checkpoint(args.ckpt, nets)
    compute_dtype = None
    if args.bf16:
        compute_dtype = torch.bfloat16
        nets = nets.to(compute_dtype)
    engine = InferenceEngine(nets, mp, PLBertConfig(),
                             sigma_data=mp.diffusion.dist.sigma_data, device=device,
                             compute_dtype=compute_dtype)

    ref_s = None
    if args.ref_audio:
        from .data.dataset import _read_wav, _resample_np

        wav_ref, sr = _read_wav(args.ref_audio)
        ref_s = engine.compute_style(_resample_np(wav_ref, sr, 24000))

    generator = torch.Generator(device).manual_seed(args.seed)
    t0 = time.perf_counter()
    if args.long_form:
        sentences = [s.strip() for s in phonemes.split(".") if s.strip()]
        wav = engine.long_form([s + " ." for s in sentences], generator=generator,
                               diffusion_steps=args.steps,
                               embedding_scale=args.embedding_scale,
                               ref_s=ref_s, alpha=args.alpha, beta=args.beta)
    else:
        wav = engine.synthesize(phonemes, generator=generator, diffusion_steps=args.steps,
                                embedding_scale=args.embedding_scale,
                                ref_s=ref_s, alpha=args.alpha, beta=args.beta)
    dt = time.perf_counter() - t0
    write_wav(args.out, wav)
    print(f"wrote {args.out}: {len(wav)/24000:.2f}s audio in {dt:.2f}s "
          f"(RTF {rtf(dt, len(wav)):.4f})")
    return wav


if __name__ == "__main__":
    main()
