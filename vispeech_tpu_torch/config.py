"""Configuration: the reference JSON schema as typed frozen dataclasses.

The same ``train`` / ``data`` / ``model`` sections and defaults as the JAX
package's ``vispeech_tpu/config.py``, so one ``config.json`` drives both
packages.  Unknown top-level keys are kept in ``extra``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Mapping, Optional, Tuple


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

    def effective_bf16_stages(self) -> Tuple[str, ...]:
        """The generator stages that compute in bf16 (``Synthesizer.
        bf16_stages`` and the step's parameter casts); empty for f32 and for
        the whole-graph scopes ``stable`` and ``full``.  An unknown scope
        raises, and so does a whole-graph scope without
        ``bf16_allow_divergent``: both scopes collapse GAN training."""
        if not self.fp16_run:
            return ()
        if self.bf16_only:
            return tuple(self.bf16_only)
        if self.bf16_scope == "tail_f32":
            return ("enc_p", "heads", "fpn", "project", "enc_q", "flow",
                    "dec_body")
        if self.bf16_scope not in ("stable", "full"):
            raise ValueError(
                f"unknown bf16_scope {self.bf16_scope!r} "
                "(expected 'tail_f32', 'stable', or 'full')")
        if not self.bf16_allow_divergent:
            raise ValueError(
                f"bf16_scope={self.bf16_scope!r} is a legacy whole-graph "
                "cast KNOWN to collapse GAN training (round-4 stage "
                "localization, benchmarks/artifacts/bf16_diag/ANALYSIS.md; "
                "collapse onset @120-770 steps). Use the converging default "
                "bf16_scope='tail_f32', or set bf16_allow_divergent=true to "
                "run it anyway for diagnostics/A-B reproduction.")
        return ()

    lr_decay: float = 0.999875
    segment_size: int = 16384
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0
    save_dir: str = "./logdir/vispeech"
    # kernel E / F in training; false runs its plain version, on CPU tensors
    # only: on the card E and F are the only training routes and false raises
    fused_wn: bool = True
    fused_attn: bool = True
    # read for a note only: the port's training decoder never folds its C <= 64
    # stages (ops/folded_mrf.py), as on the H100 the folded forward + backward at
    # batch 12 and a 16 384-sample segment took 1.89x (C = 64) and 1.32x (C = 32)
    # the plain ResBlock1 stage in bf16, 2.34x and 1.80x in f32 (chip_smoke.py
    # --fold, H100 80GB HBM3, 700 W)
    folded_mrf: bool = False
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

    def to_dict(self) -> Dict[str, Any]:
        """The JSON form ``load_config`` reads back into an equal Config."""
        def unfreeze(v):
            if isinstance(v, tuple):
                if v and all(isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], str)
                             for e in v):
                    return {k: unfreeze(x) for k, x in v}
                return [unfreeze(e) for e in v]
            return v

        out = {}
        for section in ("train", "data", "model"):
            cfg = getattr(self, section)
            out[section] = {f.name: unfreeze(getattr(cfg, f.name)) for f in fields(cfg)}
        for k, v in self.extra:
            out[k] = unfreeze(v)
        return out


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


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg.to_dict(), f, ensure_ascii=False, indent=2)
