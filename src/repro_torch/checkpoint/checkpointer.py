"""Crash-safe checkpointing: npz + JSON index, atomic commit, async save
thread, latest-checkpoint discovery for restart.

The counterpart of ``repro/checkpoint/checkpointer.py``, with its commit
protocol.  Layout: ``<dir>/step_<N>.tmp/`` gets ``arrays_<proc>.npz`` and
then ``meta.json``, each written as a sibling ``.part`` file, fsynced and
renamed; the directory is renamed to ``<dir>/step_<N>/`` (the commit
point) and the parent directory fsynced.  A kill at any instant leaves the
previous checkpoint set or the new one, never a torn file a restore could
load.

A state is a nested dict (and list) of tensors and plain values, stored
under "/"-joined keys.  numpy has no bfloat16, so a bf16 tensor is stored
as its int16 bit view and its dtype recorded in ``meta.json``; a restore
gives it back bit for bit, on the device and in the dtype of the
template's leaf.

Unlike the reference, garbage collection first renames an old
``step_<N>`` to ``step_<N>.gc.tmp`` and only then deletes it, so a kill in
the middle of a delete leaves no ``step_<N>`` without its ``meta.json``
(the reference deletes in place).  Names ending in ``.tmp`` are never
read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_flatten_with_keys, tree_map

__all__ = ["Checkpointer"]

#: torch dtypes numpy cannot hold, stored as the bit view of this dtype
_BIT_VIEWS = {torch.bfloat16: torch.int16}
_DTYPE_NAMES = {torch.bfloat16: "bfloat16"}
_BY_NAME = {v: k for k, v in _DTYPE_NAMES.items()}


def _atomic_write(path: Path, write_fn) -> None:
    """Write ``path`` via a sibling ``.part`` file, fsync, rename: a reader
    never sees a partial file under the final name."""
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_host(leaf: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A copy of ``leaf`` on the host (the caller may update the tensor in
    place while a save runs), and the dtype name numpy cannot hold."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _BIT_VIEWS:
            return t.view(_BIT_VIEWS[t.dtype]).numpy(), _DTYPE_NAMES[t.dtype]
        return t.numpy(), None
    return np.array(leaf), None


def _from_host(arr: np.ndarray, dtype_name: Optional[str], template: Any) -> Any:
    if isinstance(template, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype_name is not None:
            t = t.view(_BY_NAME[dtype_name])
        return t.reshape(template.shape).to(device=template.device, dtype=template.dtype)
    ref = np.asarray(template)  # template leaves may be python scalars
    return np.asarray(arr, dtype=ref.dtype).reshape(ref.shape)


class Checkpointer:
    """``on_commit(step, path)``, when given, is called after each save's
    commit rename (from the save thread for a non-blocking save)."""

    def __init__(self, directory: str, *, keep: int = 3, process_id: int = 0,
                 on_commit: Optional[Callable[[int, Path], None]] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.process_id = process_id
        self.on_commit = on_commit
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], *, blocking: bool = True) -> None:
        """state: a nested dict of tensors and plain values, e.g.
        {params, opt_state, data_state}.  It is copied to the host before
        this returns, so the caller may go on updating it in place."""
        self.wait()
        host = {k: _to_host(v) for k, v in tree_flatten_with_keys(state).items()}
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, Optional[str]]]) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {k: a for k, (a, _) in host.items()}
        _atomic_write(tmp / f"arrays_{self.process_id}.npz", lambda f: np.savez(f, **arrays))
        meta = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host),
            "dtypes": {k: name for k, (_, name) in sorted(host.items()) if name is not None},
            "process_count": 1,
        }
        # meta.json LAST: _steps() treats its presence as "files complete"
        _atomic_write(tmp / "meta.json", lambda f: f.write(json.dumps(meta).encode()))
        if final.exists():  # same-step re-save: move the old one out of sight first
            self._discard(final)
        os.replace(tmp, final)  # commit point
        _fsync_dir(self.dir)  # make the commit rename itself durable
        if self.on_commit is not None:
            self.on_commit(step, final)
        self._gc()

    def _discard(self, path: Path) -> None:
        """Rename ``path`` to a ``.gc.tmp`` name (atomic, and invisible to
        ``_steps``), then delete it."""
        doomed = path.with_name(path.name + ".gc.tmp")
        if doomed.exists():
            shutil.rmtree(doomed)
        os.replace(path, doomed)
        shutil.rmtree(doomed, ignore_errors=True)

    def _gc(self) -> None:
        for left in self.dir.glob("step_*.gc.tmp"):  # an earlier delete that was cut
            shutil.rmtree(left, ignore_errors=True)
        done = sorted(self._steps())
        for s in done[: -self.keep]:
            self._discard(self.dir / f"step_{s:08d}")

    # --------------------------------------------------------------- restore
    def _steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "meta.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, template: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """(step, state): the checkpoint of ``step`` (default the latest) in
        ``template``'s structure, each tensor on its template leaf's device
        and in its dtype; other leaves as numpy arrays."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        dtypes = meta.get("dtypes", {})
        flat: Dict[str, np.ndarray] = {}
        for npz in sorted(path.glob("arrays_*.npz")):
            with np.load(npz) as z:
                flat.update({k: z[k] for k in z.files})
        # tree_map visits the leaves in tree_flatten_with_keys' order
        restored = iter([_from_host(flat[k], dtypes.get(k), t)
                         for k, t in tree_flatten_with_keys(template).items()])
        return step, tree_map(lambda _: next(restored), template)
