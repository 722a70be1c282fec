"""The port's multi-rank dry run (``python -m chestxray_vit_tpu_torch.dryrun
N``, the counterpart of the JAX package's ``dryrun_multichip``) on the CPU:
four gloo ranks over data × fsdp 2 × 2 and dcn 2 × 1 × 2, each mesh's train
step, merged step and static int8 eval against one process."""

import json
import os
import subprocess
import sys

import pytest

from chestxray_vit_tpu_torch import dryrun as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_four_ranks_on_the_cpu():
    summary = D.dryrun(4, device="cpu")
    assert summary["ok"] and summary["ranks"] == 4
    assert [m["mesh"] for m in summary["meshes"]] == ["1x2x2x1", "2x1x2x1"]
    for m in summary["meshes"]:
        assert m["dense_loss_delta"] < D.LOSS_TOL
        assert m["tome_loss_delta"] < D.LOSS_TOL
        assert m["int8_logit_delta"] < D.LOGIT_TOL


@pytest.mark.parametrize("n,want", [
    (1, [(1, 1, 1, 1)]), (2, [(1, 2, 1, 1)]),
    (4, [(1, 2, 2, 1), (2, 1, 2, 1)]), (8, [(1, 2, 2, 2), (2, 1, 2, 2)])])
def test_dryrun_picks_the_jax_dry_runs_axes(n, want):
    assert D.meshes(n) == want


def test_dryrun_command_line_without_a_card_refuses(monkeypatch):
    """The default device is the card: without one the run stops, it does
    not carry on on the CPU."""
    monkeypatch.setattr(D.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        D.main(["2"])


def test_dryrun_module_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "chestxray_vit_tpu_torch.dryrun", "2",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ok"] and summary["meshes"][0]["mesh"] == "1x2x1x1"
