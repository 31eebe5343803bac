"""The port's ``CheckpointManager``: a port of
``tests/test_checkpoint_and_fault.py``'s checkpoint checks (round trip,
the ``LATEST`` pointer and retention, an async save that blocks, a
crashed save that is never visible), beside what the port adds: a bf16
leaf restored bit for bit from its 16-bit pattern, the reference's
on-disk layout (a manifest and one ``.npy`` shard a leaf, in sorted-key
order), host copies taken at ``save()`` time, a failed async write raised
on ``wait()``, and a restore that refuses another tree."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from test_torch_layers import _one_thread  # noqa: F401 (module fixture)


def _state(v):
    return {"w": torch.full((4, 4), float(v)),
            "step": torch.tensor(v, dtype=torch.int32)}


def test_save_restore_roundtrip(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(5, _state(5))
    step, got = m.restore_latest(like=_state(0))
    assert step == 5
    assert torch.equal(got["w"], torch.full((4, 4), 5.0))
    assert got["step"].shape == () and int(got["step"]) == 5


def test_latest_pointer_and_retention(tmp_path):
    m = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        m.save(s, _state(s))
    assert m.latest_step() == 4
    assert m.all_steps() == [3, 4]   # pruned to keep=2
    assert (tmp_path / "LATEST").read_text() == "4"


def test_async_save_blocks_correctly(tmp_path):
    m = CheckpointManager(tmp_path, async_save=True)
    m.save(7, _state(7))
    m.wait()
    assert m.latest_step() == 7


def test_crashed_save_never_visible(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, _state(1))
    # a crash mid-save: a stray temporary directory with partial contents
    d = tmp_path / ".tmp_save_dead"
    d.mkdir()
    (d / "shard_00000.npy").write_bytes(b"garbage")
    assert m.latest_step() == 1
    step, got = m.restore_latest(like=_state(0))
    assert step == 1


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    """bf16 is stored as its int16 pattern (numpy has no bf16 on the card
    machine) and comes back with the same bits, NaN and -0.0 included."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    x[0, 0], x[0, 1] = float("nan"), -0.0
    state = {"p": {"a": x, "b": torch.randn(7)}, "n": torch.tensor(3)}
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(2, state)
    got = m.restore(2, like=state)
    assert got["p"]["a"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["a"].view(torch.int16),
                       x.view(torch.int16))
    assert torch.equal(got["p"]["b"], state["p"]["b"])
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json")
                          .read_text())
    assert [(leaf["path"], leaf["dtype"]) for leaf in manifest["leaves"]] \
        == [("n", "int64"), ("p/a", "bfloat16"), ("p/b", "float32")]
    shard = np.load(tmp_path / "step_00000002" / "shard_00001.npy")
    assert shard.dtype == np.int16 and shard.shape == (3, 5)


def test_save_copies_the_leaves_at_save_time(tmp_path):
    """An async save holds host copies: a leaf updated in place after
    ``save()`` returns does not reach the file."""
    state = {"w": torch.zeros(1000)}
    m = CheckpointManager(tmp_path, async_save=True)
    m.save(1, state)
    state["w"].add_(1.0)
    m.wait()
    assert torch.equal(m.restore(1, like=state)["w"], torch.zeros(1000))


def test_failed_async_save_raises_on_wait(tmp_path):
    m = CheckpointManager(tmp_path, async_save=True)
    m.dir = tmp_path / "missing" / "dir"       # the write cannot land
    m.save(1, _state(1))
    with pytest.raises(FileNotFoundError):
        m.wait()
    m.wait()                                   # raised once, then cleared


def test_restore_refuses_another_tree_and_casts_to_like(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(3, _state(3))
    with pytest.raises(ValueError, match="leaves"):
        m.restore(3, like={"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match=r"\[4, 4\]"):
        m.restore(3, like={"w": torch.zeros(2, 8), "step": torch.tensor(0)})
    with pytest.raises(ValueError):
        m.restore(3, like=None)
    like = {"w": torch.zeros((4, 4), dtype=torch.float64),
            "step": torch.tensor(0, dtype=torch.int32)}
    got = m.restore(3, like=like, device="cpu")
    assert got["w"].dtype == torch.float64 and float(got["w"][0, 0]) == 3.0
