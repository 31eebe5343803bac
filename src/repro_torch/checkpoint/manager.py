"""Atomic, async checkpointing of trees of tensors, a port of
``repro.checkpoint.manager`` with its on-disk layout:

  <dir>/step_<N>/
    manifest.json        the leaves' paths, torch dtypes and shapes
    shard_<i>.npy        one file per leaf, in the fixed order of
                         ``train.tree`` (dict keys sorted, list items by
                         index)
  <dir>/LATEST           atomic pointer (rename) to the last COMPLETE
                         step: a crashed save is never picked up

Contract used by ``repro_torch.train.loop``:
  * saves are atomic (a temporary directory, then a rename) and pruned to
    the newest ``keep``;
  * ``restore_latest`` returns (step, state) or None, so a fresh start and
    a restart share one code path;
  * with ``async_save`` a background thread writes the files, so the step
    loop does not block on disk; the leaves are copied to the host at
    ``save()`` time (a copy even for CPU tensors, which the next step
    updates in place), and a failed write raises on the next ``wait()``.

numpy has no bf16 on every machine, so a bf16 leaf is stored as its
16-bit pattern (``int16``) and the manifest's dtype restores it bit for
bit.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.tree import leaves, paths, unflatten


def _paths(tree) -> List[str]:
    """Each leaf's path ("layers/0/attn/wq") in the fixed order."""
    return ["/".join(map(str, p)) for p in paths(tree)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False):
        self.wait()  # one in-flight save at a time
        host = [torch.as_tensor(x).detach().to("cpu", copy=True)
                for x in leaves(state)]
        paths = _paths(state)
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, paths), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, paths)

    def _write(self, step, host, paths):
        try:
            final = self.dir / f"step_{step:08d}"
            tmp = Path(tempfile.mkdtemp(prefix=".tmp_save_", dir=self.dir))
            manifest = {"step": step, "n_leaves": len(host),
                        "leaves": [{"path": p,
                                    "dtype": str(x.dtype).split(".")[-1],
                                    "shape": list(x.shape)}
                                   for p, x in zip(paths, host)]}
            for i, x in enumerate(host):
                np.save(tmp / f"shard_{i:05d}.npy", _to_numpy(x))
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._update_latest(step)
            self._prune()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _update_latest(self, step):
        tmp = self.dir / ".LATEST.tmp"
        tmp.write_text(str(step))
        os.replace(tmp, self.dir / "LATEST")

    def _prune(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if not f.exists():
            steps = self.all_steps()
            return steps[-1] if steps else None
        try:
            step = int(f.read_text().strip())
        except ValueError:
            return None
        return step if (self.dir / f"step_{step:08d}").exists() else None

    def restore(self, step: int, like: Any, device=None) -> Any:
        """The tree saved at ``step``, shaped as ``like``, each leaf in
        ``like``'s dtype on ``device`` (default: the device of ``like``'s
        leaf).  Raises when the saved leaves are not ``like``'s."""
        if like is None:
            raise ValueError("pass `like` (a tree prototype) to restore")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        meta = manifest["leaves"]
        if [m["path"] for m in meta] != _paths(like):
            raise ValueError(f"checkpoint at step {step} does not hold the "
                             "leaves of `like`")
        out = []
        for i, (m, ref) in enumerate(zip(meta, leaves(like))):
            t = _from_numpy(np.load(d / f"shard_{i:05d}.npy"), m["dtype"])
            ref = torch.as_tensor(ref)
            if list(t.shape) != m["shape"] or t.shape != ref.shape:
                raise ValueError(f"checkpoint leaf {m['path']} is "
                                 f"{list(t.shape)}, `like`'s "
                                 f"{list(ref.shape)}")
            out.append(t.to(device=device or ref.device, dtype=ref.dtype))
        return unflatten(like, out)

    def restore_latest(self, like: Any,
                       device=None) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like, device)
