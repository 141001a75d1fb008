"""Configuration: the reference JSON schema as typed frozen dataclasses.

The same ``train`` / ``data`` / ``model`` sections and defaults as the JAX
package's ``vispeech_tpu/config.py``, so one ``config.json`` drives both
packages.  Unknown top-level keys are kept in ``extra``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Any, Mapping, Optional, Tuple


def _freeze(value):
    """Lists → tuples and dicts → sorted (key, value) tuples, recursively."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    return value


@dataclass(frozen=True)
class TrainConfig:
    """Training section; serving reads only ``segment_size``."""

    log_interval: int = 100
    eval_interval: int = 1000
    seed: int = 1234
    epochs: int = 10000
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 12
    fp16_run: bool = False
    bf16_scope: str = "tail_f32"
    bf16_allow_divergent: bool = False
    bf16_only: Tuple[str, ...] = ()
    bf16_disc: bool = False
    lr_decay: float = 0.999875
    segment_size: int = 16384
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0
    save_dir: str = "./logdir/vispeech"
    fused_wn: bool = True
    fused_attn: bool = True
    folded_mrf: bool = True
    device_dsp: bool = True


@dataclass(frozen=True)
class DataConfig:
    training_files: str = "filelists/train.list"
    validation_files: str = "filelists/val.list"
    max_wav_value: float = 32768.0
    sampling_rate: int = 44100
    filter_length: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    add_blank: bool = True
    n_speakers: int = 200
    cleaned_text: bool = True
    spk2id: Tuple[Tuple[str, int], ...] = ()

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 4
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (8, 8, 4, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    n_layers_q: int = 3
    use_spectral_norm: bool = False
    gin_channels: int = 256
    f0_mean: float = 171.21
    f0_std: float = 128.9
    freeze_textencoder: bool = False
    freeze_decoder: bool = False
    use_sdp: bool = False


@dataclass(frozen=True)
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    extra: Tuple[Tuple[str, Any], ...] = ()


def _build_section(cls, raw: Mapping[str, Any]):
    known = {f.name for f in fields(cls)}
    return cls(**{k: _freeze(v) for k, v in raw.items() if k in known})


def config_from_dict(raw: Mapping[str, Any]) -> Config:
    extra = tuple(sorted((k, _freeze(v)) for k, v in raw.items()
                         if k not in ("train", "data", "model")))
    return Config(
        train=_build_section(TrainConfig, raw.get("train", {})),
        data=_build_section(DataConfig, raw.get("data", {})),
        model=_build_section(ModelConfig, raw.get("model", {})),
        extra=extra,
    )


def load_config(path: str) -> Config:
    """Load a reference-format JSON config file."""
    with open(path, "r", encoding="utf-8") as f:
        return config_from_dict(json.load(f))
