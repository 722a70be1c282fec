"""The port's copy of the configuration against the JAX package's: the same
dataclasses with the same field names, defaults and checks, so that one
configuration means the same to both packages."""

import dataclasses

import pytest

from chestxray_vit_tpu import config as jconfig
from chestxray_vit_tpu_torch import config as tconfig

CLASSES = ["DataConfig", "ModelConfig", "TrainConfig", "MeshConfig",
           "Config"]


def _defaults(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else f.default_factory()) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(tcls)] == \
        [f.name for f in dataclasses.fields(jcls)]
    # nested defaults compared by their fields (the classes differ)
    got = [(n, dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
           for n, v in _defaults(tcls)]
    want = [(n, dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for n, v in _defaults(jcls)]
    assert got == want


def test_model_properties_and_processor_constants_match_jax():
    for kw in ({}, {"img_size": 224, "patch_size": 32},
               {"hidden_size": 128, "num_heads": 2}):
        j, t = jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)
        assert (t.num_patches, t.seq_len, t.head_dim) == \
            (j.num_patches, j.seq_len, j.head_dim)
    assert tconfig.PROCESSOR_MEAN == jconfig.PROCESSOR_MEAN
    assert tconfig.PROCESSOR_STD == jconfig.PROCESSOR_STD
    assert tconfig.TrainConfig(batch_size_per_core=4).eval_batch_size == \
        jconfig.TrainConfig(batch_size_per_core=4).eval_batch_size


@pytest.mark.parametrize("kw", [
    {"img_size": 100, "patch_size": 16}, {"hidden_size": 100,
                                          "num_heads": 12},
    {"tome_schedule": "linear"}], ids=["patch", "heads", "tome_schedule"])
def test_model_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError) as jerr:
        jconfig.ModelConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tconfig.ModelConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_a_jax_config_converts_field_for_field():
    """Each section of a JAX Config builds the port's section from its
    fields, as the parity tests build the port's config."""
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(attention_dropout=0.1, hidden_dropout=0.1,
                                  remat=True),
        data=jconfig.DataConfig(mixup_alpha=0.2),
        train=jconfig.TrainConfig(gradient_accumulation_steps=2))
    port = tconfig.Config(**{
        f.name: getattr(tconfig, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.model.attention_dropout == 0.1
    assert port.data.mixup_alpha == 0.2
    assert port.train.gradient_accumulation_steps == 2


@pytest.mark.parametrize("preset", sorted(jconfig._PRESETS))
def test_presets_match_jax(preset):
    assert sorted(tconfig._PRESETS) == sorted(jconfig._PRESETS)
    assert dataclasses.asdict(tconfig._PRESETS[preset]()) == \
        dataclasses.asdict(jconfig._PRESETS[preset]())


@pytest.mark.parametrize("preset", ["default", "fast_finetune"])
def test_json_round_trip_matches_jax(preset):
    """The same text both ways: a config the JAX package saved loads in the
    port and the port writes what the JAX package would."""
    jcfg, tcfg = jconfig._PRESETS[preset](), tconfig._PRESETS[preset]()
    tcfg.train.profile_steps = jcfg.train.profile_steps = (3, 5)
    assert tcfg.to_json() == jcfg.to_json()
    back = tconfig.Config.from_json(jcfg.to_json())
    assert dataclasses.asdict(back) == dataclasses.asdict(
        jconfig.Config.from_json(jcfg.to_json()))
    assert back.to_json() == tcfg.to_json()


@pytest.mark.parametrize("key,value", [
    ("train.learning_rate", "3e-4"), ("train.max_steps", "none"),
    ("train.profile_steps", "[2, 4]"), ("model.remat", "true"),
    ("model.tome_r", "16"), ("data.backend", "memory")])
def test_set_by_path_matches_jax(key, value):
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    jconfig._set_by_path(jcfg, key, value)
    tconfig._set_by_path(tcfg, key, value)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    with pytest.raises(KeyError):
        tconfig._set_by_path(tcfg, "train.no_such_key", "1")


def test_nih_classes_match_jax():
    assert tconfig.NIH_CLASSES == jconfig.NIH_CLASSES


def test_vit_variants_match_jax():
    assert tconfig.VIT_VARIANTS == jconfig.VIT_VARIANTS
    for name in sorted(jconfig.VIT_VARIANTS):
        img = 224 if name == "vit_h14" else 384
        assert dataclasses.asdict(tconfig.vit_variant_config(name, img, 3)) \
            == dataclasses.asdict(jconfig.vit_variant_config(name, img, 3))
    assert dataclasses.asdict(tconfig.vit_large_config()) == \
        dataclasses.asdict(jconfig.vit_large_config())
    with pytest.raises(KeyError, match="unknown variant"):
        tconfig.vit_variant_config("vit_x")


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "version_b"],
    ["--preset", "version_a", "--set", "train.learning_rate=3e-4",
     "--set", "data.augment=yes", "--set", "train.max_steps=none"],
    ["--preset", "fast_finetune", "--set", "train.profile_steps=[3, 5]",
     "--set", "model.tome_r=8"],
    ["--model", "vit_h14", "--set", "model.img_size=224",
     "--set", "model.num_classes=4"],
    ["--preset", "version_b", "--model", "vit_s16"],
    ["--config", "CONFIG", "--set", "train.seed=7"],
], ids=["default", "preset", "sets", "tuple", "variant_geometry",
        "variant", "json"])
def test_parse_cli_matches_jax(argv, tmp_path):
    """The same argv lists give the same configuration in both packages."""
    path = tmp_path / "cfg.json"
    path.write_text(jconfig.version_a_config().to_json())
    argv = [str(path) if a == "CONFIG" else a for a in argv]
    assert tconfig.parse_cli(argv).to_json() == \
        jconfig.parse_cli(argv).to_json()


def test_parse_cli_rejects_what_jax_rejects():
    with pytest.raises(KeyError) as jerr:
        jconfig.parse_cli(["--set", "train.nope=1"])
    with pytest.raises(KeyError) as terr:
        tconfig.parse_cli(["--set", "train.nope=1"])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(SystemExit):
        tconfig.parse_cli(["--preset", "nope"])
