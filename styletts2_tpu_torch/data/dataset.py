"""Host-side data pipeline (ref: meldataset.py), the port's copy of
``styletts2_tpu/data/dataset.py``: it yields the same numpy batches.

Differences from the reference:

- The dataset yields raw waveforms + token ids; log-mels are computed on
  the device inside the train step (one batched STFT instead of per-item
  torchaudio calls on the host).  Mel frame counts are derived from sample
  counts, so collation/bucketing never needs the spectrogram.
- Batches are padded to shape buckets (token and frame capacities rounded
  up), so a run meets a handful of shapes instead of one per batch.

Behavioural parity is kept for: the ``wav|text|speaker`` list format, 24 kHz
resampling, the 5000-sample zero padding on both ends (ref: meldataset.py:173),
pad-token insertion around token streams, same-speaker reference sampling with
unreadable-file skip loops, OOD text sampling for SLM adversarial training,
and descending-length batch sorting.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import wave as wave_mod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..text import TextCleaner
from ..text.dictionary import DEFAULT_DICTIONARY_PATH

logger = logging.getLogger(__name__)

SR = 24000
HOP = 300


class UnreadableAudioError(RuntimeError):
    """Raised when an audio file cannot be read (ref: meldataset.py:14-17)."""


def _read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Format-dispatching audio reader (ref: meldataset.py:149-170 reads via
    soundfile; here WAV is decoded with scipy and FLAC with the in-tree
    native decoder).  Dispatch is by magic bytes, not extension."""
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
    except OSError as exc:
        raise UnreadableAudioError(f"Failed to open '{path}': {exc}") from exc
    if magic == b"fLaC":
        from ..native import read_flac as _dec
    elif magic == b"OggS":
        from ..native import read_ogg as _dec
    elif magic[:3] == b"ID3" or (len(magic) >= 2 and magic[0] == 0xFF
                                 and (magic[1] & 0xE0) == 0xE0):
        from ..native import read_mp3 as _dec
    else:
        return _read_wav(path)
    try:
        return _dec(path)
    except RuntimeError as exc:
        raise UnreadableAudioError(str(exc)) from exc


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Minimal-dependency WAV reader (PCM16/24/32/float32)."""
    try:
        import scipy.io.wavfile as sw

        sr, data = sw.read(path)
    except Exception as exc:
        raise UnreadableAudioError(f"Failed to read '{path}': {exc}") from exc
    if data.ndim == 2:
        data = data[:, 0]
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def _resample_np(wave: np.ndarray, orig: int, new: int) -> np.ndarray:
    if orig == new:
        return wave
    # native C++ polyphase kernel when built, numpy fallback otherwise
    from ..native import resample_host

    return resample_host(wave, orig, new)


@dataclasses.dataclass
class Sample:
    speaker_id: int
    wave: np.ndarray          # padded 24 kHz waveform
    tokens: np.ndarray        # int32, pad-wrapped
    ref_tokens: np.ndarray    # OOD text token ids, pad-wrapped
    ref_wave: np.ndarray      # same-speaker reference waveform (for ref mel)
    path: str


class FilePathDataset:
    def __init__(
        self,
        data_list: Sequence[str],
        root_path: str,
        sr: int = SR,
        validation: bool = False,
        OOD_data: Optional[str] = None,
        min_length: int = 50,
        dict_path=DEFAULT_DICTIONARY_PATH,
        dictionary_config=None,
        max_ref_mel_length: int = 192,
        seed: int = 1,
    ):
        rows = [line.strip().split("|") for line in data_list if line.strip()]
        self.data_list = [r if len(r) == 3 else [*r, "0"] for r in rows]
        self.text_cleaner = TextCleaner(dict_path, dictionary_config)
        self.pad_index = self.text_cleaner.pad_index
        self.sr = sr
        self.root_path = root_path
        self.validation = validation
        self.max_ref_mel_length = max_ref_mel_length
        self.rng = np.random.default_rng(seed)

        self._by_speaker: Dict[str, List[int]] = {}
        for i, row in enumerate(self.data_list):
            self._by_speaker.setdefault(str(row[2]), []).append(i)

        self.ptexts: List[str] = []
        self.min_length = min_length
        if OOD_data and os.path.exists(OOD_data):
            with open(OOD_data, "r", encoding="utf-8") as f:
                lines = f.readlines()
            if lines:
                idx = 1 if ".wav" in lines[0].split("|")[0] else 0
                self.ptexts = [ln.split("|")[idx] for ln in lines]

    def __len__(self) -> int:
        return len(self.data_list)

    def _tokens(self, text: str) -> np.ndarray:
        ids = self.text_cleaner(text)
        ids.insert(0, self.pad_index)
        ids.append(self.pad_index)
        return np.asarray(ids, dtype=np.int32)

    def _load_wave(self, rel_path: str) -> np.ndarray:
        wave, sr = _read_audio(os.path.join(self.root_path, rel_path))
        if sr != self.sr:
            wave = _resample_np(wave, sr, self.sr)
        return np.concatenate([np.zeros(5000, np.float32), wave,
                               np.zeros(5000, np.float32)])

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Sample:
        """Fetch + decode one sample.

        ``rng`` overrides the dataset-level generator for the
        reference/OOD draws; worker threads pass a per-sample generator so
        parallel decode is deterministic and lock-free.
        """
        rng = self.rng if rng is None else rng
        attempts = 0
        current = idx
        while attempts < len(self.data_list):
            row = self.data_list[current]
            try:
                wave = self._load_wave(row[0])
                break
            except UnreadableAudioError as exc:
                logger.error("Skipping unreadable audio %s: %s", row[0], exc)
                attempts += 1
                current = (current + 1) % len(self.data_list)
        else:
            raise RuntimeError(f"No readable audio starting from index {idx}")

        row = self.data_list[current]
        tokens = self._tokens(row[1])
        speaker = str(row[2])

        # same-speaker reference (ref: meldataset.py:109-131)
        ref_candidates = self._by_speaker.get(speaker, [current])
        ref_wave = None
        for _ in range(len(ref_candidates)):
            cand = self.data_list[int(rng.choice(ref_candidates))]
            try:
                ref_wave = self._load_wave(cand[0])
                break
            except UnreadableAudioError:
                continue
        if ref_wave is None:
            ref_wave = wave
        # random reference crop to <= max_ref_mel_length frames, drawn from
        # the per-sample rng so threaded decode stays deterministic
        # (ref: meldataset.py:188-192 crops in the collater)
        cap = self.max_ref_mel_length * HOP
        if len(ref_wave) > cap:
            start = int(rng.integers(0, len(ref_wave) - cap))
            ref_wave = ref_wave[start: start + cap]

        # OOD text for SLM adversarial (ref: meldataset.py:133-146)
        ps = ""
        if self.ptexts:
            while len(ps) < self.min_length:
                ps = self.ptexts[int(rng.integers(0, len(self.ptexts) - 1))]
        ref_tokens = self._tokens(ps) if ps else tokens

        return Sample(int(row[2]) if row[2].isdigit() else 0, wave, tokens,
                      ref_tokens, ref_wave, row[0])


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class Collater:
    """Pad a list of Samples into static-shaped numpy batch arrays."""

    def __init__(self, text_pad_index: int = 0, frame_bucket: int = 50,
                 token_bucket: int = 16, max_ref_frames: int = 192):
        self.text_pad_index = text_pad_index
        self.frame_bucket = frame_bucket
        self.token_bucket = token_bucket
        self.max_ref_frames = max_ref_frames

    def __call__(self, batch: Sequence[Sample]) -> Dict[str, np.ndarray]:
        # sort by length desc (ref: meldataset.py:213-216)
        batch = sorted(batch, key=lambda s: len(s.wave), reverse=True)
        b = len(batch)
        frame_counts = np.array(
            [(len(s.wave) // HOP) // 2 * 2 for s in batch], np.int32)
        max_frames = _round_up(int(frame_counts.max()), self.frame_bucket)
        max_tokens = _round_up(max(len(s.tokens) for s in batch), self.token_bucket)
        max_rtokens = _round_up(max(len(s.ref_tokens) for s in batch), self.token_bucket)
        ref_frames = self.max_ref_frames

        waves = np.zeros((b, max_frames * HOP), np.float32)
        texts = np.full((b, max_tokens), self.text_pad_index, np.int32)
        ref_texts = np.full((b, max_rtokens), self.text_pad_index, np.int32)
        ref_waves = np.zeros((b, ref_frames * HOP), np.float32)
        input_lengths = np.zeros(b, np.int32)
        ref_lengths = np.zeros(b, np.int32)
        ref_frame_lengths = np.zeros(b, np.int32)

        for i, s in enumerate(batch):
            n = min(len(s.wave), waves.shape[1])
            waves[i, :n] = s.wave[:n]
            texts[i, : len(s.tokens)] = s.tokens
            ref_texts[i, : len(s.ref_tokens)] = s.ref_tokens
            input_lengths[i] = len(s.tokens)
            ref_lengths[i] = len(s.ref_tokens)
            # reference already randomly cropped per-sample in __getitem__;
            # deterministic head-crop here is only a safety net for samples
            # built outside FilePathDataset
            rn = len(s.ref_wave)
            cap = ref_frames * HOP
            if rn > cap:
                ref_waves[i] = s.ref_wave[:cap]
                ref_frame_lengths[i] = ref_frames
            else:
                ref_waves[i, :rn] = s.ref_wave
                ref_frame_lengths[i] = rn // HOP

        return {
            "waves": waves,
            "texts": texts,
            "input_lengths": input_lengths,
            "ref_texts": ref_texts,
            "ref_lengths": ref_lengths,
            "mel_input_length": frame_counts,
            "ref_waves": ref_waves,
            "ref_frame_lengths": ref_frame_lengths,
        }


def build_dataloader(
    path_list: Sequence[str],
    root_path: str,
    validation: bool = False,
    OOD_data: Optional[str] = None,
    min_length: int = 50,
    batch_size: int = 4,
    drop_last: Optional[bool] = None,
    seed: int = 1,
    collate_config: Optional[Dict] = None,
    dataset_config: Optional[Dict] = None,
    num_shards: Optional[int] = None,
    shard_index: Optional[int] = None,
    num_workers: int = 0,
    prefetch_batches: int = 2,
):
    """Shuffling batch iterator factory (ref: meldataset.py:258-295).

    Multi-host: ``batch_size`` is the *global* batch; each host yields its
    ``batch_size // num_shards`` shard, taken from a shuffle driven by the
    shared seed so every host sees a disjoint, equally-sized slice of the
    same global order (the ``split_batches=True`` semantics of
    ref train_first.py:127-135).  ``num_shards``/``shard_index`` default to
    the ``torch.distributed`` world size and rank when a process group is
    initialised, else 1 and 0.

    Throughput: ``num_workers > 0`` decodes samples on a thread pool and
    collates batches on a background producer feeding a bounded queue of
    ``prefetch_batches`` ready batches (the DataLoader worker/prefetch
    equivalent, ref: meldataset.py:277-293) — the host keeps the card
    fed instead of stalling on audio decode.  Per-sample RNG streams keep
    reference/OOD draws deterministic regardless of thread scheduling.
    """
    if num_shards is None:
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        num_shards = dist.get_world_size() if grouped else 1
        if shard_index is None:
            shard_index = dist.get_rank() if grouped else 0
    shard_index = shard_index or 0
    if batch_size % num_shards:
        raise ValueError(f"global batch_size {batch_size} must divide evenly "
                         f"across {num_shards} hosts")
    local_bs = batch_size // num_shards

    ds_cfg = dict(dataset_config or {})
    dataset = FilePathDataset(path_list, root_path, validation=validation,
                              OOD_data=OOD_data, min_length=min_length, **ds_cfg)
    collater = Collater(text_pad_index=dataset.pad_index, **(collate_config or {}))
    if drop_last is None:
        drop_last = not validation

    def _epoch_batches(epoch: int):
        order = np.arange(len(dataset))
        if not validation:
            np.random.default_rng(seed + epoch).shuffle(order)
        if num_shards > 1:
            # equal per-host slice counts: truncate to a multiple of the
            # global batch, then each global batch contributes a contiguous
            # local_bs block per host
            usable = (len(order) // batch_size) * batch_size
            order = order[:usable]
            order = order.reshape(-1, num_shards, local_bs)[:, shard_index, :].reshape(-1)
        out = []
        for start in range(0, len(order), local_bs):
            idxs = order[start: start + local_bs]
            if len(idxs) < local_bs and drop_last:
                break
            out.append(idxs)
        return out

    def loader(epoch: int = 0):
        batches = _epoch_batches(epoch)
        if num_workers <= 0:
            for idxs in batches:
                yield collater([dataset[int(i)] for i in idxs])
            return
        yield from _prefetched_epoch(dataset, collater, batches, epoch, seed,
                                     num_workers, prefetch_batches)

    loader.dataset = dataset
    loader.collater = collater
    loader.batch_size = batch_size
    loader.local_batch_size = local_bs
    return loader


def _prefetched_epoch(dataset, collater, batches, epoch, seed,
                      num_workers, prefetch_batches):
    """Background-producer epoch: a thread pool decodes samples, a producer
    thread collates and fills a bounded queue ahead of the consumer."""
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch_batches))
    stop = threading.Event()
    _DONE = object()

    def _fetch(i):
        # per-sample stream: deterministic under any thread interleaving
        rng = np.random.default_rng([seed, epoch, int(i)])
        return dataset.__getitem__(int(i), rng=rng)

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            with ThreadPoolExecutor(max_workers=num_workers) as ex:
                window: list = []
                for idxs in batches:
                    window.append([ex.submit(_fetch, i) for i in idxs])
                    if len(window) > prefetch_batches:
                        futs = window.pop(0)
                        if not _put(collater([f.result() for f in futs])):
                            return
                for futs in window:
                    if not _put(collater([f.result() for f in futs])):
                        return
            _put(_DONE)
        except BaseException as exc:  # surfaced on the consumer side
            _put(exc)

    thread = threading.Thread(target=_produce, daemon=True,
                              name="styletts2-data-producer")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
