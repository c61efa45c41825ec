"""Checkpoint manager: atomic, optionally async, keep-last-K, restart.

The PyTorch counterpart of ``repro/checkpointing/manager.py``, in the
reference's file format, so a checkpoint written by either package
restores in the other: one ``step_<n>.npz`` per checkpoint holding
every leaf under its slash-joined path (``{"enc.0.w": t}``, a
``PeronaModel`` ``state_dict``, is stored as ``enc/0/w``, as is the
reference tree's ``{"enc": [{"w": ...}]}``; a field of a dataclass,
the LM training state's ``OptState``, as ``.m`` after its parent, as
JAX names a registered dataclass's field: ``opt/.m/embed/table``), plus
``meta_<n>.json``; a
``LATEST`` file is swapped in atomically after a successful write, so a
crash mid-save never corrupts the restore point.

:meth:`CheckpointManager.save` copies every leaf to host memory on the
calling thread before anything is queued: a tensor the caller goes on
updating in place (the trainer writes its selected parameters into the
model's live tensors) cannot change what a queued write persists, and
the background writer never touches a CUDA tensor.
:meth:`CheckpointManager.restore` puts each leaf on its template
tensor's device and dtype (what the reference's ``jnp.asarray`` plus
``shardings`` do on a mesh).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch



def _leaves(tree, path: str = ""):
    """(slash-joined path, leaf) of every leaf, in the reference's file
    names: a dict key's dots become slashes, a list item is its index, a
    dataclass field is ``.<name>``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree))
    elif isinstance(tree, dict):
        items = ((k.replace(".", "/"), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield path, torch.as_tensor(tree)
        return
    for k, v in items:
        yield from _leaves(v, f"{path}/{k}" if path else k)


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, leaves) for v in template]
    return next(leaves)


def _host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its memory. numpy has no
    bfloat16: a bf16 leaf is stored widened to float32, which holds it
    exactly and restores to the same bits at the template's dtype."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory, keep_last: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        #: steps exempt from keep-last GC (e.g. the model plane pins
        #: the incumbent + previous versions however old they are)
        self.pinned: set = set()
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _raise_pending(self):
        """Surface a failed background write on the *next* call (a
        silently-lost checkpoint is a corrupted restore point waiting
        to happen)."""
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot to host memory synchronously; write async if
        enabled. Raises any error a previous async write hit."""
        self._raise_pending()
        # a copy: a CPU tensor's numpy() would share its memory; a CUDA
        # tensor's copy has finished when .to returns
        host = {name: _host_copy(leaf) for name, leaf in _leaves(tree)}
        payload = (step, host, dict(extra or {}))
        if self.async_save:
            self._ensure_worker()
            self._queue.put(payload)
        else:
            self._write(*payload)

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            try:
                self._write(*item)
            except BaseException as e:  # noqa: BLE001
                # raised on the next call (_raise_pending)
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, host: Dict[str, np.ndarray], extra: Dict):
        tmp = self.dir / f".tmp_step_{step}.npz"
        final = self.dir / f"step_{step}.npz"
        np.savez(tmp, **host)
        os.replace(tmp, final)
        meta = {"step": step, "extra": extra}
        mtmp = self.dir / f".tmp_meta_{step}.json"
        mtmp.write_text(json.dumps(meta))
        os.replace(mtmp, self.dir / f"meta_{step}.json")
        ltmp = self.dir / ".tmp_LATEST"
        ltmp.write_text(str(step))
        os.replace(ltmp, self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(s for s in self.all_steps()
                       if s not in self.pinned)
        for s in steps[: -self.keep_last]:
            for f in (self.dir / f"step_{s}.npz",
                      self.dir / f"meta_{s}.json"):
                try:
                    f.unlink()
                except FileNotFoundError:
                    pass

    def wait(self):
        """Block until pending async saves are on disk (barrier before a
        risky operation, and test determinism)."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()
        self._raise_pending()

    def close(self):
        """Stop the async writer (drains queued saves first) and raise
        any pending write error. Safe to call repeatedly."""
        if self._worker is not None and self._worker.is_alive():
            self._queue.join()
            self._queue.put(None)
            self._worker.join(timeout=30.0)
        self._worker = None
        self._raise_pending()

    # --------------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.stem.split("_")[1])
                for p in self.dir.glob("step_*.npz")]

    def latest_step(self) -> Optional[int]:
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        step = int(latest.read_text().strip())
        return step if (self.dir / f"step_{step}.npz").exists() else None

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore the leaves of ``template`` (a tree of tensors: dicts,
        lists and dataclasses), each on its template tensor's device and
        dtype, in the template's structure (a ``state_dict`` comes back
        with its keys). Returns ``(tree, meta)``, or ``(None, None)``
        when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        with np.load(self.dir / f"step_{step}.npz",
                     allow_pickle=False) as data:
            leaves = [torch.from_numpy(data[name]).to(device=leaf.device,
                                                      dtype=leaf.dtype)
                      for name, leaf in _leaves(template)]
        tree = _rebuild(template, iter(leaves))
        meta_path = self.dir / f"meta_{step}.json"
        extra = (json.loads(meta_path.read_text())["extra"]
                 if meta_path.exists() else {})
        return tree, {"step": step, **extra}
