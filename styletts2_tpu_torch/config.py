"""Configuration system: YAML -> typed frozen dataclasses (the port's copy of
``styletts2_tpu/config.py``; ``yaml`` is imported only by ``load_config``).

Mirrors the reference's flat YAML schema (ref: Configs/config.yml:1-119,
loaded via recursive_munch at utils.py:60-66) but with typed, hashable
dataclasses so configs can be closed over by jitted functions as static
arguments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def _build(cls, data: Mapping[str, Any]):
    """Construct dataclass ``cls`` from a mapping, ignoring unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for name, f in fields.items():
        if name not in data:
            continue
        value = data[name]
        sub = _SUBCONFIG.get((cls, name))
        if sub is not None and isinstance(value, Mapping):
            kwargs[name] = _build(sub, value)
        else:
            kwargs[name] = _tuplify(value)
    return cls(**kwargs)


@dataclass(frozen=True)
class SpectParams:
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300


@dataclass(frozen=True)
class PreprocessParams:
    sr: int = 24000
    spect_params: SpectParams = field(default_factory=SpectParams)


@dataclass(frozen=True)
class DataParams:
    train_data: str = "Data/train_list.txt"
    val_data: str = "Data/val_list.txt"
    root_path: str = ""
    OOD_data: str = "Data/OOD_texts.txt"
    min_length: int = 50
    phoneme_dict_path: Optional[str] = None
    phoneme_dictionary_config: Optional[Mapping] = None
    # host data-pipeline throughput (DataLoader workers/prefetch equivalent)
    num_workers: int = 8
    prefetch_batches: int = 2


@dataclass(frozen=True)
class DecoderConfig:
    type: str = "istftnet"  # "istftnet" | "hifigan"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    upsample_rates: Tuple[int, ...] = (10, 6)
    upsample_initial_channel: int = 512
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_kernel_sizes: Tuple[int, ...] = (20, 12)
    gen_istft_n_fft: int = 20
    gen_istft_hop_size: int = 5


@dataclass(frozen=True)
class SlmConfig:
    model: str = "openai/whisper-base"
    sr: int = 16000
    hidden: int = 512
    nlayers: int = 7
    initial_channel: int = 64
    hop_length: int = 300


@dataclass(frozen=True)
class DiffusionTransformerConfig:
    num_layers: int = 3
    num_heads: int = 8
    head_features: int = 64
    multiplier: int = 2


@dataclass(frozen=True)
class DiffusionDistConfig:
    sigma_data: float = 0.2
    estimate_sigma_data: bool = True
    mean: float = -3.0
    std: float = 1.0


@dataclass(frozen=True)
class DiffusionConfig:
    embedding_mask_proba: float = 0.1
    transformer: DiffusionTransformerConfig = field(default_factory=DiffusionTransformerConfig)
    dist: DiffusionDistConfig = field(default_factory=DiffusionDistConfig)


@dataclass(frozen=True)
class ModelParams:
    multispeaker: bool = False
    dim_in: int = 64
    hidden_dim: int = 512
    max_conv_dim: int = 512
    n_layer: int = 3
    n_mels: int = 80
    n_token: int = 178
    max_dur: int = 50
    style_dim: int = 128
    dropout: float = 0.2
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    slm: SlmConfig = field(default_factory=SlmConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)


@dataclass(frozen=True)
class LossParams:
    lambda_mel: float = 5.0
    lambda_gen: float = 1.0
    lambda_slm: float = 1.0
    lambda_mono: float = 1.0
    lambda_s2s: float = 1.0
    TMA_epoch: int = 50
    lambda_F0: float = 1.0
    lambda_norm: float = 1.0
    lambda_dur: float = 1.0
    lambda_ce: float = 20.0
    lambda_sty: float = 1.0
    lambda_diff: float = 1.0
    diff_epoch: int = 20
    joint_epoch: int = 50


@dataclass(frozen=True)
class OptimizerParams:
    lr: float = 1e-4
    bert_lr: float = 1e-5
    ft_lr: float = 1e-5


@dataclass(frozen=True)
class SlmAdvParams:
    min_len: int = 400
    max_len: int = 500
    batch_percentage: float = 0.5
    iter: int = 10
    thresh: int = 5
    scale: float = 0.01
    sig: float = 1.5


@dataclass(frozen=True)
class Config:
    """Top-level experiment configuration."""

    log_dir: str = "logs/run"
    first_stage_path: str = "first_stage.ckpt"
    save_freq: int = 2
    log_interval: int = 10
    device: str = "tpu"
    mixed_precision: str = "auto"  # "auto" | "bf16" | "no"
    epochs_1st: int = 200
    epochs_2nd: int = 100
    epochs: int = 50  # finetune recipe
    batch_size: int = 16
    max_len: int = 400
    pretrained_model: str = ""
    second_stage_load_pretrained: bool = True
    load_only_params: bool = False

    F0_path: str = ""
    ASR_config: str = ""
    ASR_path: str = ""
    PLBERT_dir: str = ""

    data_params: DataParams = field(default_factory=DataParams)
    preprocess_params: PreprocessParams = field(default_factory=PreprocessParams)
    model_params: ModelParams = field(default_factory=ModelParams)
    loss_params: LossParams = field(default_factory=LossParams)
    optimizer_params: OptimizerParams = field(default_factory=OptimizerParams)
    slmadv_params: SlmAdvParams = field(default_factory=SlmAdvParams)


_SUBCONFIG = {
    (PreprocessParams, "spect_params"): SpectParams,
    (Config, "data_params"): DataParams,
    (Config, "preprocess_params"): PreprocessParams,
    (Config, "model_params"): ModelParams,
    (Config, "loss_params"): LossParams,
    (Config, "optimizer_params"): OptimizerParams,
    (Config, "slmadv_params"): SlmAdvParams,
    (ModelParams, "decoder"): DecoderConfig,
    (ModelParams, "slm"): SlmConfig,
    (ModelParams, "diffusion"): DiffusionConfig,
    (DiffusionConfig, "transformer"): DiffusionTransformerConfig,
    (DiffusionConfig, "dist"): DiffusionDistConfig,
}


def load_config(path: str) -> Config:
    import yaml

    with open(path, "r", encoding="utf-8") as handle:
        data = yaml.safe_load(handle) or {}
    return config_from_dict(data)


def config_from_dict(data: Mapping[str, Any]) -> Config:
    return _build(Config, data)


def replace(cfg, **kwargs):
    return dataclasses.replace(cfg, **kwargs)


# Built-in presets matching the reference's shipped configs.
def ljspeech_config() -> Config:
    return Config()


def libritts_config() -> Config:
    return config_from_dict({
        "max_len": 300,
        "epochs_1st": 50,
        "epochs_2nd": 30,
        "model_params": {
            "multispeaker": True,
            "decoder": {
                "type": "hifigan",
                "upsample_rates": [10, 5, 3, 2],
                "upsample_kernel_sizes": [20, 10, 6, 4],
            },
        },
        "loss_params": {"TMA_epoch": 5, "diff_epoch": 10, "joint_epoch": 15},
        "slmadv_params": {"iter": 20},
    })
