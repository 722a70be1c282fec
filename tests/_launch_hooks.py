"""What ``tests/test_torch_launch.py`` runs on the ranks it starts, kept
apart from the test file so that a rank imports torch and the port only
(the test file imports the JAX package)."""

import os
import time

from chestxray_vit_tpu_torch.parallel import distributed as dist


def hold_until_stop(tr, step: int) -> None:
    """On a rank: the step that reaches ``step`` returns only once a stop
    was requested (within 60 s), so the caller's request lands there."""
    inner = tr._train_step

    def held(state, batch):
        out = inner(state, batch)
        deadline = time.monotonic() + 60
        while (out[0].step == step and not tr._stop_requested
               and time.monotonic() < deadline):
            time.sleep(0.01)
        return out
    tr._train_step = held


def raise_on_rank_1(device) -> None:
    """Rank 1 raises; rank 0 waits in a collective for it."""
    if dist.rank() == 1:
        raise KeyError("rank 1 alone")
    dist.barrier("never reached by rank 1")


def exit_on_rank_1(device) -> None:
    """Rank 1 ends without a word; rank 0 waits in a collective for it."""
    if dist.rank() == 1:
        os._exit(3)
    dist.barrier("never reached by rank 1")
