"""Config system: dataclasses mirroring the reference constructor surface
1:1 (defaults equal reference defaults, octa.py:16-29) + YAML/CLI front-end.

The port's own copy of `octave_tpu/utils/config.py` (:14-188): the same
fields, defaults, JSON/YAML loading and dotted overrides, so one config file
drives either package. `train.trainer.Trainer` takes every field as the
JAX trainer does; `train.compute_dtype` names one of None (float32),
'float32', 'bfloat16' and 'float16', and any other raises ValueError.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    """OctaScribbleNet constructor surface (reference octa.py:16-29)."""

    # segmentor family: 'unet' (ResnestUNet, the OctaScribbleNet default) |
    # 'parallel_head' (ResnestUnetParallelHead, dual thick/thin decoders) |
    # 'parallel_head_gate' (ResnestUnetParallelHeadAttentionGate)
    architecture: str = "unet"
    num_classes: int = 2
    num_filters: int = 64
    instance_noise: bool = True
    label_noise: bool = True
    segmentor_gating_level: int = 4
    discriminator_depth: int = 4
    encoder_gating: bool = False
    weakly_supervise: bool = True
    pretrain: bool = False
    weight_path: str = "resnest50-528c19ca.pth"


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"  # synthetic | rose | octa500
    root: str = "./data"
    subset: str = "ROSE-1/SVC"  # rose subset or octa500 fov (3M/6M)
    image_size: Tuple[int, int] = (304, 304)
    batch_size: int = 8
    in_channels: int = 3
    synthetic_n: int = 64
    # train-time augmentation (data/augment.py): D4 per sample, plus a
    # brightness/contrast jitter of +-augment_intensity
    augment: bool = False
    augment_intensity: float = 0.0


@dataclasses.dataclass
class OptimConfig:
    seg_lr: float = 1e-4
    disc_lr: float = 1e-4
    end_lr: float = 1e-6
    power: float = 0.9
    decay_steps: int = 10_000
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None
    # None | 'float32' | 'bfloat16': the Adam first moment's stored dtype
    moment_dtype: Optional[str] = None


@dataclasses.dataclass
class LossConfig:
    lambda_ild: float = 1.0
    lambda_adv: float = 1.0
    ild_divergence: str = "KLD"
    ild_stop_gradient: bool = False
    ild_weights: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass
class TrainConfig:
    steps: int = 1000
    eval_every: int = 200
    log_every: int = 50
    # train steps per call of the step function (k batches per call)
    steps_per_call: int = 1
    # calls the host may run ahead of the device before it waits for the
    # oldest (trainer.fit); 0 waits for every call
    dispatch_ahead: int = 2
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    seed: int = 0
    data_parallel: bool = False
    n_devices: Optional[int] = None
    profile_dir: Optional[str] = None
    log_dir: Optional[str] = None
    compute_dtype: Optional[str] = None  # None (float32) | 'float32' | 'bfloat16' | 'float16'
    # False | True | 'conv' | 'block' | 'block-enc' | 'block:<depths>[e<layers>]'
    # [+conv]: recomputed regions (train/steps.py StepConfig.remat)
    remat: Any = False
    # None | 'all' | 'decoder' | 'decoder:<digits>' | 'enc' | '+'-combos:
    # grouped convs lowered dense / as shifted matmuls (models/resnest.py)
    dense_groups: Optional[str] = None
    einsum_groups: Optional[str] = None
    debug_nans: bool = False


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(dc_cls, sub):
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for k, v in (sub or {}).items():
                if k.startswith("_"):
                    continue  # comment keys
                if k not in fields:
                    raise KeyError(f"unknown config key: {dc_cls.__name__}.{k}")
                if isinstance(v, list):
                    v = tuple(v)
                kwargs[k] = v
            return dc_cls(**kwargs)

        unknown = {k for k in d if not k.startswith("_")} - {
            "model", "data", "optim", "loss", "train"
        }
        if unknown:
            raise KeyError(f"unknown config sections: {sorted(unknown)}")
        return cls(
            model=build(ModelConfig, d.get("model")),
            data=build(DataConfig, d.get("data")),
            optim=build(OptimConfig, d.get("optim")),
            loss=build(LossConfig, d.get("loss")),
            train=build(TrainConfig, d.get("train")),
        )

    @classmethod
    def load(cls, path: str) -> "Config":
        """Load a YAML or JSON config file."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml

                return cls.from_dict(yaml.safe_load(text) or {})
            except ImportError:
                raise RuntimeError("pyyaml not installed; use a .json config")
        return cls.from_dict(json.loads(text))

    def apply_overrides(self, overrides: Dict[str, Any]) -> "Config":
        """Dotted-key overrides, e.g. {'data.batch_size': 16}."""
        d = self.to_dict()
        for key, val in overrides.items():
            parts = key.split(".")
            cur = d
            for p in parts[:-1]:
                cur = cur[p]
            leaf = parts[-1]
            if leaf not in cur:
                raise KeyError(f"unknown config key: {key}")
            old = cur[leaf]
            if isinstance(old, (list, tuple)) and isinstance(val, str):
                # CLI list syntax: [a,b] or a,b
                val = [json.loads(v) for v in val.strip("[]() ").split(",") if v]
            elif old is not None and not isinstance(old, (list, tuple, dict)) and not isinstance(val, type(old)):
                # coerce CLI strings to the field's type
                if isinstance(old, bool):
                    sval = str(val).lower()
                    if sval in ("1", "true", "yes", "0", "false", "no"):
                        val = sval in ("1", "true", "yes")
                    # else: bool-or-mode fields keep the string
                    # (e.g. train.remat='conv' selective remat)
                elif isinstance(old, int):
                    val = int(val)
                elif isinstance(old, float):
                    val = float(val)
            cur[leaf] = val
        return Config.from_dict(d)
