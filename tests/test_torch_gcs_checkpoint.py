"""The port's ``gs://`` checkpoints (``train/checkpoint.py`` over
``data/storage.GCSStore``) against the in-process GCS emulator
(``tests/gcs_emulator.py``, through ``STORAGE_EMULATOR_HOST``), mirroring
tests/test_gcs_checkpoint.py: a save/restore round trip bit for bit,
retention that keeps the steps the port's local manager keeps for the same
saves and metrics, a step without its commit object (``meta.json``)
neither listed nor kept, and a non-primary rank that writes nothing."""

import os

import pytest
import torch

pytest.importorskip("google.cloud.storage")

from chestxray_vit_tpu_torch.config import ModelConfig  # noqa: E402
from chestxray_vit_tpu_torch.models import vit  # noqa: E402
from chestxray_vit_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from chestxray_vit_tpu_torch.train.steps import TrainState  # noqa: E402
from tests.gcs_emulator import start_emulator  # noqa: E402

BUCKET = "port-ckpt-bucket"


@pytest.fixture(scope="module")
def gcs():
    em = start_emulator({BUCKET: {}})
    old = os.environ.get("STORAGE_EMULATOR_HOST")
    os.environ["STORAGE_EMULATOR_HOST"] = em.url
    yield em
    if old is None:
        os.environ.pop("STORAGE_EMULATOR_HOST", None)
    else:
        os.environ["STORAGE_EMULATOR_HOST"] = old
    em.stop()


def _state(seed=0, step=0):
    cfg = ModelConfig(img_size=32, patch_size=16, hidden_size=16,
                      num_layers=2, num_heads=2, mlp_dim=32, num_classes=3)
    params = vit.init_params(torch.Generator().manual_seed(seed), cfg)
    state = TrainState.create(params, seed)
    gen = torch.Generator().manual_seed(seed)
    for key in ("mu", "nu"):
        for t in state.opt_state[key].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    state.generator.manual_seed(seed + 100)
    return TrainState(step=step, params=params, opt_state=state.opt_state,
                      generator=state.generator)


def _names(em, prefix):
    return sorted(n for n in em.bucket(BUCKET) if n.startswith(prefix))


def test_gcs_save_restore_round_trip(gcs):
    mgr = ckpt.CheckpointManager(f"gs://{BUCKET}/run1/checkpoints",
                                 save_total_limit=2, metric_for_best=None)
    state = _state(step=5)
    mgr.save(5, state, cursor=ckpt.DataCursor(epoch=1, batch_in_epoch=3),
             metrics={"avg_auroc": 0.75}, extra={"note": "x"})
    mgr.wait()
    assert _names(gcs, "run1/") == ["run1/checkpoints/5/meta.json",
                                    "run1/checkpoints/5/state.pt"]
    assert mgr.last_save["step"] == 5 and mgr.last_save["bytes"] == len(
        gcs.bucket(BUCKET)["run1/checkpoints/5/state.pt"])

    template = _state(seed=99)
    restored, cursor, extra = mgr.restore(5, template)
    assert restored.step == 5 and extra == {"note": "x"}
    assert (cursor.epoch, cursor.batch_in_epoch) == (1, 3)
    for (n, a), b in zip(restored.params.named_parameters(),
                         state.params.parameters()):
        assert torch.equal(a, b), n
    for key in ("mu", "nu"):
        for n, t in state.opt_state[key].items():
            assert torch.equal(restored.opt_state[key][n], t), (key, n)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())
    mgr.close()
    # a second manager indexes the bucket's saves, metrics included
    again = ckpt.CheckpointManager(f"gs://{BUCKET}/run1/checkpoints")
    assert again.all_steps() == [5] and again.best_step() == 5


@pytest.mark.parametrize("metric", [None, "avg_auroc"])
def test_gcs_retention_keeps_what_the_local_manager_keeps(gcs, tmp_path,
                                                           metric):
    saves = [(1, None), (2, {"avg_auroc": 0.7}), (3, {"avg_auroc": 0.6}),
             (4, {"avg_auroc": 0.9}), (5, None), (6, {"avg_auroc": 0.65})]
    prefix = f"run2_{metric}/checkpoints"
    kw = dict(save_total_limit=2, metric_for_best=metric)
    remote = ckpt.CheckpointManager(f"gs://{BUCKET}/{prefix}", **kw)
    local = ckpt.CheckpointManager(str(tmp_path / "local"), **kw)
    state = _state()
    for step, metrics in saves:
        for mgr in (remote, local):
            mgr.save(step, state, cursor=ckpt.DataCursor(0, step),
                     metrics=metrics)
            mgr.wait()
        assert remote.all_steps() == local.all_steps()
    kept = remote.all_steps()
    assert kept == ([5, 6] if metric is None else [2, 4, 6])
    assert remote.best_step() == local.best_step()
    assert sorted(os.listdir(tmp_path / "local")) == [str(s) for s in kept]
    assert _names(gcs, prefix) == sorted(
        f"{prefix}/{s}/{leaf}" for s in kept
        for leaf in ("meta.json", "state.pt"))


def test_gcs_step_without_commit_is_not_listed(gcs):
    prefix = "run3/checkpoints"
    mgr = ckpt.CheckpointManager(f"gs://{BUCKET}/{prefix}",
                                 metric_for_best=None)
    mgr.save(1, _state(), cursor=ckpt.DataCursor(0, 1))
    mgr.wait()
    # a writer that died after its state object, before the commit
    gcs.bucket(BUCKET)[f"{prefix}/2/state.pt"] = b"partial"
    other = ckpt.CheckpointManager(f"gs://{BUCKET}/{prefix}",
                                   metric_for_best=None, primary=False)
    assert other.all_steps() == [1]
    assert f"{prefix}/2/state.pt" in gcs.bucket(BUCKET)   # only the primary
    reopened = ckpt.CheckpointManager(f"gs://{BUCKET}/{prefix}",
                                      metric_for_best=None)
    assert reopened.all_steps() == [1] and reopened.latest_step() == 1
    assert _names(gcs, prefix) == [f"{prefix}/1/meta.json",
                                   f"{prefix}/1/state.pt"]
    with pytest.raises(FileNotFoundError, match="step 2"):
        reopened.restore(2, _state())


def test_gcs_non_primary_writes_nothing(gcs):
    prefix = "run4/checkpoints"
    mgr = ckpt.CheckpointManager(f"gs://{BUCKET}/{prefix}",
                                 save_total_limit=1, metric_for_best=None,
                                 primary=False)
    for step in (1, 2):
        mgr.save(step, _state(), cursor=ckpt.DataCursor(0, step))
        mgr.wait()
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2
    assert _names(gcs, "run4/") == []


def test_gcs_directory_needs_a_bucket():
    with pytest.raises(ValueError, match="no bucket"):
        ckpt.CheckpointManager("gs:///checkpoints")
