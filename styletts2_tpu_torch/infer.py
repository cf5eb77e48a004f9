"""Inference engine — the demo-notebook API (Demo/Inference_LJSpeech.ipynb
cells 17 and 29, Demo/Inference_LibriTTS.ipynb cells 5, 16 and 45) on the
GPU.

Two stages, as in the JAX package's engine:

1. frontend: tokens -> text/PL-BERT encodings, ADPM2 style sampling (for a
   multispeaker model conditioned on a reference style ``ref_s`` and mixed
   with it by alpha/beta), duration prediction, at a token capacity rounded
   up to ``token_bucket``;
2. synthesis: hard alignment -> F0/N -> the iSTFTNet or HiFi-GAN decoder,
   whose MRF resblocks run through the fused round kernel, at a frame
   capacity chosen by the JAX engine's rule.

PyTorch runs eagerly, so the engine reads ``pred_dur`` before it picks the
frame capacity and runs the decoder once; the JAX engine launches a
speculative decoder pass and reruns it when the speculation was short.
The frame capacity is kept all the same: the generator's convolutions see
the padded region near each sample's tail, so it changes the waveform.

``serve.BatchSynthesizer`` is the batched front door over this engine.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .audio.mel import DATASET_MEL, log_mel_spectrogram
from .config import ModelParams
from .models.decoder import decoder_apply
from .models.diffusion import sampler as S
from .models.diffusion.denoiser import denoiser_cfg_apply
from .models.plbert import PLBertConfig, grown_position_table, plbert_apply
from .models.predictor import duration_encoder_apply, predict_durations, prosody_f0n_apply
from .models.style_encoder import style_encoder_apply
from .models.text_encoder import text_encoder_apply
from .nn.linear import linear
from .ops.alignment import hard_alignment
from .text import TextCleaner

SAMPLES_PER_FRAME = 600   # durations are at half mel rate: 2x to mel, 300x to audio


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that raises rather than falling
    back to the CPU.  Pass ``"cpu"`` explicitly to run there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class InferenceEngine:
    """Phoneme strings -> 24 kHz waveforms with the port's nets
    (``models.zoo.build_nets``), moved to ``device`` (default: the GPU).
    A multispeaker model needs a reference style ``ref_s`` per request
    (``compute_style``), and ``compute_style`` needs the nets'
    ``style_encoder`` and ``predictor_encoder``.

    bf16 serving, as the JAX engine's ``compute_dtype``: the caller casts
    the nets (``nets.to(torch.bfloat16)`` casts the floating parameters and
    buffers, as ``utils.cast_pytree`` casts the zoo) and passes
    ``compute_dtype=torch.bfloat16``.  The dtypes then follow JAX's
    promotion (``jax.make_jaxpr`` of ``_frontend_fn`` and ``_synth_fn`` on
    a bf16 zoo):
    - frontend: the text encoder, PL-BERT, ``bert_encoder`` and the
      denoiser (its f32 noise and sigma cast in) run in bf16; the sampler
      mixes in f32; the duration encoder and head take f32 (the bf16
      encoding joined to the f32 style), so their bf16 weights promote to
      f32, as do the style mix and ``pred_dur``;
    - synthesis: t_en, d, s, ref and the alignment go to bf16; the F0/N
      predictor and the decoder run in bf16 with f32 norm statistics
      (``nn/norm.py``) and an f32 AdaIN -> Snake (K2's bf16 form), the
      harmonic source and its STFT in f32 and the iSTFT head in f32;
    - ``compute_style`` runs its encoders in bf16 and gives a bf16 style.
    The returned waves are float32."""

    def __init__(self, nets: torch.nn.ModuleDict, model_params: ModelParams,
                 plbert_cfg: PLBertConfig = PLBertConfig(), sigma_data: float = 0.2,
                 token_bucket: int = 32, frame_bucket: int = 100,
                 last_token_pad: int = 5, duration_headroom: int = 10,
                 max_frames: int = 1200, device=None,
                 compute_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.nets = nets.to(self.device).eval()
        self.compute_dtype = compute_dtype
        self.model_params = model_params
        self.plbert_cfg = plbert_cfg
        self.sigma_data = sigma_data
        self.token_bucket = token_bucket
        self.frame_bucket = frame_bucket
        self.last_token_pad = last_token_pad
        self.duration_headroom = duration_headroom
        self.max_frames = max_frames
        self.cleaner = TextCleaner()
        # PL-BERT position capacity >= 1024 (PLBERT_MAX_POSITION overrides),
        # grown by repeating the last learned row (ref: Utils/PLBERT/util.py:8-65)
        # in the engine's own copy of the table: the caller's nets keep theirs
        target = max(int(os.environ.get("PLBERT_MAX_POSITION", 0) or 0), 1024)
        self.bert_positions = grown_position_table(self.nets["bert"], target)

    def tokens_from_phonemes(self, phonemes: str) -> np.ndarray:
        toks = self.cleaner(phonemes)
        toks.insert(0, 0)
        return np.asarray(toks, dtype=np.int32)

    def tokenize(self, texts: Sequence[str]):
        """Phoneme strings -> (tokens (B, cap) int64 on the device, lengths
        (B,) numpy), zero-padded to a multiple of ``token_bucket``."""
        toks = [self.tokens_from_phonemes(p) for p in texts]
        lengths = np.array([len(t) for t in toks], dtype=np.int64)
        tokens = np.zeros((len(toks), _round_up(int(lengths.max()), self.token_bucket)),
                          dtype=np.int64)
        for i, t in enumerate(toks):
            tokens[i, : len(t)] = t
        return torch.from_numpy(tokens).to(self.device), lengths

    def frame_capacity(self, max_tokens: int, max_frames: int) -> int:
        """The JAX engine's capacity: the speculative
        ``round_up(min(tokens * headroom + bucket, max_frames), bucket)``,
        or the exact bucket of ``max_frames`` when that is short."""
        spec = _round_up(min(max_tokens * self.duration_headroom + self.frame_bucket,
                             self.max_frames), self.frame_bucket)
        return spec if max_frames <= spec else _round_up(max_frames, self.frame_bucket)

    def _frontend(self, tokens, lengths, noise, step_noise, num_steps,
                  embedding_scale, s_prev, prev_blend, ref_s=None, alpha=0.3, beta=0.7):
        """``ref_s`` (B, 2*style_dim): the reference style; a multispeaker
        denoiser takes it as its features, and the sampled style is mixed
        with it, ``alpha`` for the acoustic half and ``beta`` for the
        prosodic one (Demo/Inference_LibriTTS.ipynb cell 16)."""
        nets, mp = self.nets, self.model_params
        mask = torch.arange(tokens.shape[1], device=self.device)[None, :] < lengths[:, None]
        t_en = text_encoder_apply(nets["text_encoder"], tokens, lengths)
        bert_dur = plbert_apply(nets["bert"], tokens, mask.to(torch.int32),
                                positions=self.bert_positions)
        be = nets["bert_encoder"]
        d_en = linear(bert_dur, be.weight, be.bias).transpose(1, 2)

        transformer = nets["diffusion"]["transformer"]

        features = ref_s if mp.multispeaker else None

        def net(x, c_noise):
            return denoiser_cfg_apply(transformer, x, c_noise, bert_dur,
                                      embedding_scale=embedding_scale, mask=mask,
                                      features=features)

        sigmas = S.karras_schedule(num_steps, device=self.device)
        # the reference samples styles unclamped (demo cell 14)
        s_pred = S.adpm2_sample(noise, S.k_denoise_fn(net, self.sigma_data), sigmas,
                                num_steps, step_noise, clamp=False)[:, 0, :]
        if s_prev is not None and prev_blend > 0:
            s_pred = prev_blend * s_prev + (1 - prev_blend) * s_pred
        s, ref = s_pred[:, mp.style_dim:], s_pred[:, : mp.style_dim]
        if ref_s is not None:
            ref = alpha * ref + (1 - alpha) * ref_s[:, : mp.style_dim]
            s = beta * s + (1 - beta) * ref_s[:, mp.style_dim:]
        d = duration_encoder_apply(nets["predictor"].text_encoder, d_en, s, lengths)
        pred_dur = predict_durations(nets["predictor"], d, lengths, self.last_token_pad)
        return t_en, d, s, ref, torch.cat([ref, s], dim=-1), pred_dur

    def _decoder_inputs(self, t_en, d, s, pred_dur, lengths, t_mel):
        """Hard alignment and F0/N: (asr, f0, n, frames) at ``t_mel`` frames."""
        token_mask = (torch.arange(t_en.shape[-1], device=self.device)[None, :]
                      < lengths[:, None]).float()
        aln = hard_alignment(pred_dur, t_mel, token_mask).to(d.dtype)
        en = torch.matmul(d.transpose(1, 2), aln)
        asr = torch.matmul(t_en, aln)
        if self.model_params.decoder.type == "hifigan":
            # one-frame right shift (Demo/Inference_LibriTTS.ipynb cell 16)
            en = torch.cat([en[..., :1], en[..., :-1]], dim=-1)
            asr = torch.cat([asr[..., :1], asr[..., :-1]], dim=-1)
        frames = pred_dur.sum(dim=1)
        f0, n = prosody_f0n_apply(self.nets["predictor"], en, s, lengths=frames)
        return asr, f0, n, frames

    def _synthesis(self, t_en, d, s, ref, pred_dur, lengths, t_mel, source_noise=None):
        if self.compute_dtype is not None:
            # the vocoder runs in the compute dtype; the source and STFT re-pin f32
            t_en, d, s, ref = (v.to(self.compute_dtype) for v in (t_en, d, s, ref))
        asr, f0, n, frames = self._decoder_inputs(t_en, d, s, pred_dur, lengths, t_mel)
        if source_noise is not None:
            need = t_mel * SAMPLES_PER_FRAME
            if source_noise.shape[0] != t_en.shape[0] or source_noise.shape[-1] < need:
                raise ValueError(f"source_noise {tuple(source_noise.shape)} needs batch "
                                 f"{t_en.shape[0]} and at least {need} samples")
            source_noise = source_noise[..., :need].to(self.device)
        wav = decoder_apply(self.nets["decoder"], asr, f0, n, ref, lengths=frames,
                                  fused=True, source_noise=source_noise)
        return wav[:, 0, :]

    @torch.inference_mode()
    def synthesize(self, phonemes: Union[str, Sequence[str]],
                   noise: Optional[torch.Tensor] = None,
                   step_noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   diffusion_steps: int = 5, embedding_scale: float = 1.0,
                   s_prev: Optional[torch.Tensor] = None, prev_blend: float = 0.0,
                   return_styles: bool = False,
                   return_durations: bool = False,
                   source_noise: Optional[torch.Tensor] = None,
                   ref_s: Optional[torch.Tensor] = None, alpha: float = 0.3,
                   beta: float = 0.7, trim_tail: int = 0):
        """Phoneme string(s) -> waveform(s) (24 kHz float32 numpy, trimmed to
        each sample's ``sum(pred_dur) * 600`` samples, less ``trim_tail``
        samples from each end: the reference trims 50-100 clicking samples,
        Demo/Inference_LibriTTS.ipynb cell 16).

        ``ref_s`` (B or 1, 2*style_dim), e.g. from ``compute_style``: the
        reference style, mixed in by ``alpha`` (acoustic) and ``beta``
        (prosodic); a batch of one serves every request.  A multispeaker
        model needs it.

        ``noise`` (B, 1, 2*style_dim) is the diffusion's initial noise and
        ``step_noise`` (steps-1, B, 1, 2*style_dim) each ADPM2 step's; either
        one left out is drawn from ``generator`` (seeded 0 on the engine's
        device when None).  ``source_noise`` (B, 9, >= 600 * frame capacity)
        standard normals is the harmonic source's dither; the default, like
        the JAX engine's, is none.
        """
        single = isinstance(phonemes, str)
        tokens, lengths_np = self.tokenize([phonemes] if single else list(phonemes))
        b = len(lengths_np)
        lengths = torch.from_numpy(lengths_np).to(self.device)

        shape = (b, 1, self.model_params.style_dim * 2)
        if generator is None and (noise is None or step_noise is None):
            generator = torch.Generator(self.device).manual_seed(0)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=self.device)
        if step_noise is None:
            step_noise = torch.randn((diffusion_steps - 1, *shape), generator=generator,
                                     device=self.device)
        noise = noise.to(self.device, torch.float32)
        step_noise = step_noise.to(self.device, torch.float32)
        if s_prev is not None:
            s_prev = s_prev.to(self.device, torch.float32)
        if ref_s is not None:
            ref_s = torch.as_tensor(ref_s, dtype=torch.float32, device=self.device)
            ref_s = ref_s.reshape(-1, shape[-1]).expand(b, -1)
        elif self.model_params.multispeaker:
            raise ValueError("a multispeaker model synthesizes from a reference style: pass "
                             "ref_s (compute_style of a reference clip)")

        t_en, d, s, ref, s_out, pred_dur = self._frontend(
            tokens, lengths, noise, step_noise, diffusion_steps, embedding_scale,
            s_prev, prev_blend, ref_s, alpha, beta)
        pred_dur_np = pred_dur.cpu().numpy()
        frames = pred_dur_np.sum(axis=1)
        t_mel = self.frame_capacity(int(lengths_np.max()), int(frames.max()))
        wav = self._synthesis(t_en, d, s, ref, pred_dur, lengths, t_mel,
                              source_noise).float().cpu().numpy()

        outs = [wav[i, : int(frames[i]) * SAMPLES_PER_FRAME] for i in range(b)]
        if trim_tail:
            outs = [w[:-trim_tail] for w in outs]
        result = outs[0] if single else outs
        extras = []
        if return_styles:
            styles = s_out.cpu()
            extras.append(styles[0:1] if single else styles)
        if return_durations:
            extras.append(pred_dur_np[0, : lengths_np[0]] if single else pred_dur_np)
        return (result, *extras) if extras else result

    @torch.inference_mode()
    def compute_style(self, wave_24k) -> torch.Tensor:
        """A 24 kHz reference clip (T,) -> its style (1, 2*style_dim) on the
        device: ``concat(style_encoder(mel), predictor_encoder(mel))`` of the
        dataset log-mel (Demo/Inference_LibriTTS.ipynb cell 5)."""
        missing = [n for n in ("style_encoder", "predictor_encoder") if n not in self.nets]
        if missing:
            raise ValueError(f"compute_style needs the nets {missing}: build them "
                             "(models.zoo.STYLE_INFERENCE_NETS)")
        wave = torch.as_tensor(np.asarray(wave_24k, np.float32), device=self.device)
        mel = log_mel_spectrogram(wave.reshape(1, -1), DATASET_MEL)[:, None]
        return torch.cat([style_encoder_apply(self.nets["style_encoder"], mel),
                          style_encoder_apply(self.nets["predictor_encoder"], mel)], dim=-1)

    def style_transfer(self, phonemes, ref_s, alpha: float = 0.3, beta: float = 0.7, **kw):
        """Synthesize the text with the reference speaker's style mixed in
        (Demo/Inference_LibriTTS.ipynb cell 45)."""
        return self.synthesize(phonemes, ref_s=ref_s, alpha=alpha, beta=beta, **kw)

    @torch.inference_mode()
    def warmup(self, token_caps: Sequence[int] = (32, 64),
               frame_caps: Sequence[int] = (200, 400),
               diffusion_steps: Sequence[int] = (5,), batch: int = 1) -> None:
        """Run the shapes a server will meet once, as the JAX engine's warmup
        compiles them: per (token cap, steps) the frontend on ``batch``
        requests of that many tokens, then the synthesis at each frame
        capacity of ``frame_caps`` (or at the frames the durations need,
        where that is more).  On the card the first call builds the
        kernels (``kernels/build.py``) and cuDNN's and the allocator's caches
        fill at those shapes, so the first request pays for none of it.  A
        multispeaker model is warmed with a zero reference style."""
        mp = self.model_params
        shape = (batch, 1, 2 * mp.style_dim)
        ref_s = torch.zeros((batch, 2 * mp.style_dim), device=self.device) \
            if mp.multispeaker else None
        for steps in diffusion_steps:
            for cap in token_caps:
                tokens, lengths_np = self.tokenize(["a" * (cap - 2)] * batch)
                lengths = torch.from_numpy(lengths_np).to(self.device)
                noise = torch.zeros(shape, device=self.device)
                step_noise = torch.zeros((steps - 1, *shape), device=self.device)
                t_en, d, s, ref, _, pred_dur = self._frontend(
                    tokens, lengths, noise, step_noise, steps, 1.0, None, 0.0, ref_s)
                frames = int(pred_dur.sum(1).max())     # a capacity holds them all
                for t_mel in frame_caps:
                    self._synthesis(t_en, d, s, ref, pred_dur, lengths, max(t_mel, frames))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def long_form(self, sentences: Sequence[str], t: float = 0.7,
                  generator: Optional[torch.Generator] = None, **kw) -> np.ndarray:
        """Per-sentence synthesis with style carry-over
        ``s <- t * s_prev + (1 - t) * s`` (Demo/Inference_LJSpeech.ipynb cell 29)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        s_prev = None
        pieces = []
        for sent in sentences:
            wav, s_prev = self.synthesize(sent, generator=generator, s_prev=s_prev,
                                          prev_blend=t if s_prev is not None else 0.0,
                                          return_styles=True, **kw)
            pieces.append(wav)
        return np.concatenate(pieces)
