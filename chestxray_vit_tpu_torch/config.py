"""Typed configuration of the port, a copy of the dataclasses of
``chestxray_vit_tpu/config.py`` that the port reads.

``DataConfig``, ``ModelConfig``, ``TrainConfig``, ``MeshConfig`` and
``Config`` keep the JAX package's names, fields, defaults and
construction-time checks, so a configuration written for one package means
the same to the other (``tests/test_torch_config.py`` holds them equal),
fields the port does not act on yet (mesh) included. The JSON round trip
(``Config.to_json`` / ``from_json``, which ``save_model`` and
``Predictor.from_model_dir`` use), the presets (``version_b_config``,
``version_a_config``, ``fast_finetune_config``, ``_PRESETS``) and
``_set_by_path`` are the JAX package's too, and so are the ViT family
(``VIT_VARIANTS``, ``vit_variant_config``, ``vit_large_config``) and the
command line (``parse_cli``, which ``cli.py`` reads).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple

# The reference normalizes through HF ViTImageProcessor (google/vit values
# 0.5 / 0.5); its ImageNet constants are defined but unused.
PROCESSOR_MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
PROCESSOR_STD: Tuple[float, float, float] = (0.5, 0.5, 0.5)

# The NIH ChestX-ray14 vocabulary of the reference's label engine: 14
# pathologies and 'No Finding', sorted.
NIH_CLASSES: Tuple[str, ...] = (
    "Atelectasis", "Cardiomegaly", "Consolidation", "Edema", "Effusion",
    "Emphysema", "Fibrosis", "Hernia", "Infiltration", "Mass", "No Finding",
    "Nodule", "Pleural_Thickening", "Pneumonia", "Pneumothorax",
)


@dataclass
class DataConfig:
    """Input-pipeline and dataset-layout knobs."""

    backend: str = "local"          # 'gcs' | 'local' | 'memory' | 'hf_dataset'
    hf_dataset_name: str = "kerem/nih-chest-xray-14"
    gcp_project_id: str = ""
    gcs_bucket_name: str = ""
    gcs_image_base_prefix: str = ""
    local_root: str = ""
    bbox_csv: str = "BBox_List_2017.csv"
    data_entry_csv: str = "Data_Entry_2017.csv"
    train_val_list: str = "train_val_list.txt"
    test_list: str = "test_list.txt"
    num_image_folders: int = 12
    image_folder_template: str = "images_{:03d}/images/"
    use_subset_data: Optional[int] = None
    split_scheme: str = "official_lists"    # or 'random_80_10_10'
    val_fraction: float = 0.15
    split_seed: int = 42
    use_bbox_roi: bool = True
    image_mean: Tuple[float, float, float] = PROCESSOR_MEAN
    image_std: Tuple[float, float, float] = PROCESSOR_STD
    augment: bool = False
    # per-sample mixup inside the train step: λ_i ~ Beta(α, α), partner =
    # the (micro-)batch rolled by one; images and soft labels mixed. 0 = off
    mixup_alpha: float = 0.0
    preprocess_placement: str = "host"      # 'host' | 'device'
    num_workers: int = 8
    prefetch_depth: int = 4
    decode_canvas: int = 1024
    shuffle_buffer_seed: int = 42


@dataclass
class ModelConfig:
    """ViT architecture knobs; defaults = google/vit-base-patch16-384."""

    model_name: str = "google/vit-base-patch16-384"
    img_size: int = 384
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 15
    layernorm_eps: float = 1e-12
    gelu_approximate: bool = False
    # dropout after the attention output and after the MLP (hidden) and on
    # the softmax probabilities (attention), training only
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    dtype: str = "bfloat16"         # activations; master params stay f32
    param_dtype: str = "float32"
    remat: bool = False
    remat_policy: str = "full"
    attention_impl: str = "auto"    # 'auto' | 'pallas' | 'xla'
    fused_qkv: bool = False
    tome_r: int = 0
    tome_schedule: str = "constant"

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self):
        if self.img_size % self.patch_size:
            raise ValueError(
                f"img_size {self.img_size} is not a multiple of patch_size "
                f"{self.patch_size} — patchify cannot tile the image (e.g. "
                f"patch 14 needs img_size 224/392/448; set model.img_size)")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} is not divisible by "
                f"num_heads {self.num_heads}")
        if self.tome_schedule not in ("constant", "decreasing"):
            raise ValueError(
                f"model.tome_schedule must be 'constant' or 'decreasing', "
                f"got {self.tome_schedule!r}")


# The standard ViT family (An Image is Worth 16x16 Words, Table 1, plus the
# Ti/S additions of the DeiT/AugReg line): name → (hidden, layers, heads,
# mlp, patch, HF checkpoint when an official @384 one exists). The
# reference uses only B/16.
VIT_VARIANTS = {
    "vit_ti16": (192, 12, 3, 768, 16, None),
    "vit_s16": (384, 12, 6, 1536, 16, None),
    "vit_b16": (768, 12, 12, 3072, 16, "google/vit-base-patch16-384"),
    "vit_b32": (768, 12, 12, 3072, 32, "google/vit-base-patch32-384"),
    "vit_l16": (1024, 24, 16, 4096, 16, "google/vit-large-patch16-384"),
    "vit_h14": (1280, 32, 16, 5120, 14, "google/vit-huge-patch14-224-in21k"),
}


def vit_variant_config(variant: str, img_size: int = 384,
                       num_classes: int = 15) -> ModelConfig:
    """ModelConfig for a named ViT variant (``VIT_VARIANTS`` keys); L/H
    default to remat (gradient checkpointing)."""
    if variant not in VIT_VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; "
                       f"one of {sorted(VIT_VARIANTS)}")
    hidden, layers, heads, mlp, patch, hf_name = VIT_VARIANTS[variant]
    return ModelConfig(
        model_name=hf_name or f"scratch/{variant}",
        img_size=img_size,
        patch_size=patch,
        hidden_size=hidden,
        num_layers=layers,
        num_heads=heads,
        mlp_dim=mlp,
        num_classes=num_classes,
        remat=hidden >= 1024,
    )


def vit_large_config(img_size: int = 384, num_classes: int = 15
                     ) -> ModelConfig:
    """ViT-L/16."""
    return vit_variant_config("vit_l16", img_size, num_classes)


@dataclass
class TrainConfig:
    """Optimization and orchestration knobs."""

    batch_size_per_core: int = 8
    eval_batch_size_per_core: Optional[int] = None
    gradient_accumulation_steps: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    num_epochs: float = 4
    max_steps: Optional[int] = None
    lr_schedule: str = "linear"
    warmup_steps: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    eval_strategy: str = "steps"
    eval_steps: int = 500
    save_strategy: str = "steps"
    save_steps: int = 500
    logging_steps: int = 50
    save_total_limit: int = 2
    load_best_model_at_end: bool = True
    metric_for_best_model: str = "avg_auroc"
    greater_is_better: bool = True
    bf16: bool = True
    compilation_cache_dir: Optional[str] = None
    save_on_preemption: bool = True
    nan_guard: str = "raise"
    calibrate_thresholds: bool = False
    eval_quantize: Optional[str] = None
    eval_tome_r: int = 0
    tome_warmup: float = 0
    seed: int = 42
    output_dir: str = "./outputs"
    report_to: str = "tensorboard"
    resume_from_checkpoint: Optional[str] = None
    profile_steps: Optional[Tuple[int, int]] = None

    @property
    def eval_batch_size(self) -> int:
        return self.eval_batch_size_per_core or self.batch_size_per_core


@dataclass
class MeshConfig:
    """Device-mesh layout (-1 = every device on the data axis)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    axis_names: Tuple[str, ...] = ("data", "fsdp", "tensor")
    dcn_data: int = 1


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            data=DataConfig(**raw.get("data", {})),
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in raw.get("mesh", {}).items()}),
        )


def version_b_config() -> Config:
    """The production (GCS streaming) pipeline of the reference."""
    return Config(
        data=DataConfig(
            backend="gcs",
            gcs_bucket_name="chest-xray-samir",
            split_scheme="official_lists",
            use_bbox_roi=True,
            augment=False,
        ),
        model=ModelConfig(num_classes=15),
        train=TrainConfig(
            batch_size_per_core=8,
            learning_rate=1e-4,
            weight_decay=0.01,
            num_epochs=4,
            eval_strategy="steps",
            eval_steps=500,
            save_steps=500,
            logging_steps=50,
            metric_for_best_model="avg_auroc",
            report_to="tensorboard",
            output_dir=os.path.expanduser("~/vit_finetune_results"),
        ),
    )


def version_a_config() -> Config:
    """The reference's HF-datasets variant: batch 32 train / 64 eval, lr
    2e-5, 5 epochs, per-epoch eval and save, best by f1_micro."""
    return Config(
        data=DataConfig(
            backend="local",
            split_scheme="random_80_10_10",
            use_bbox_roi=False,
            augment=True,
        ),
        model=ModelConfig(num_classes=15),
        train=TrainConfig(
            batch_size_per_core=32,
            eval_batch_size_per_core=64,
            learning_rate=2e-5,
            weight_decay=0.0,
            num_epochs=5,
            eval_strategy="epoch",
            save_strategy="epoch",
            logging_steps=100,
            metric_for_best_model="f1_micro",
            report_to="none",
            output_dir="./nih-xray-vit-programmatic-finetuned",
        ),
    )


def fast_finetune_config() -> Config:
    """The JAX package's fast training recipe: version_b with batch 36 per
    device, full remat, token merging at tome_r 16 under the decreasing
    schedule, and a dense warmup over the first 37.5 % of the steps
    (``train.tome_warmup``)."""
    cfg = version_b_config()
    cfg.model.remat = True
    cfg.model.tome_r = 16
    cfg.model.tome_schedule = "decreasing"
    cfg.train.batch_size_per_core = 36
    cfg.train.tome_warmup = 0.375
    return cfg


_PRESETS = {
    "version_a": version_a_config,
    "version_b": version_b_config,
    "fast_finetune": fast_finetune_config,
    "default": Config,
}


def _set_by_path(cfg: Config, dotted: str, value: str) -> None:
    """Set cfg.<section>.<field> from a command-line string, coerced to the
    field's type."""
    parts = dotted.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config key: {dotted}")
    current = getattr(obj, name)
    fields = {f.name: f for f in dataclasses.fields(obj)}
    ftype = fields[name].type if name in fields else type(current)
    text = str(ftype)
    if value.lower() in ("none", "null"):
        coerced: Any = None
    elif "Tuple" in text or "tuple" in text:
        # before the int/float checks: 'Tuple[int, int]' contains 'int'
        coerced = tuple(json.loads(value))
    elif "bool" in text:
        coerced = value.lower() in ("1", "true", "yes", "on")
    elif "int" in text:
        coerced = int(value)
    elif "float" in text:
        coerced = float(value)
    else:
        coerced = value
    setattr(obj, name, coerced)


def parse_cli(argv: Optional[Sequence[str]] = None) -> Config:
    """CLI: ``--preset version_b --set train.learning_rate=3e-4 ...``"""
    ap = argparse.ArgumentParser(prog="chestxray_vit_tpu_torch")
    ap.add_argument("--preset", default="default", choices=sorted(_PRESETS))
    ap.add_argument("--model", default=None, choices=sorted(VIT_VARIANTS),
                    help="swap the model family variant (keeps img_size "
                         "and num_classes from the preset)")
    ap.add_argument("--config", default=None, help="path to a JSON config")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override, e.g. --set train.learning_rate=1e-4")
    ns = ap.parse_args(argv)
    if ns.config:
        with open(ns.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = _PRESETS[ns.preset]()
    overrides = []
    for kv in ns.set:
        key, _, value = kv.partition("=")
        overrides.append((key.strip(), value.strip()))
    if ns.model:
        # the variant is built at the overridden geometry: vit_h14 (patch
        # 14) cannot be built at a preset's img_size 384
        pre = dict(overrides)
        img_size = int(pre.get("model.img_size", cfg.model.img_size))
        num_classes = int(pre.get("model.num_classes",
                                  cfg.model.num_classes))
        cfg.model = vit_variant_config(ns.model, img_size, num_classes)
    for key, value in overrides:
        _set_by_path(cfg, key, value)
    return cfg
