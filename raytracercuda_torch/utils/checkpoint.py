"""Checkpoint and resume for inverse-rendering runs and progressive frames
(counterpart of `raytracercuda_tpu/utils/checkpoint.py`, with orbax
replaced by `torch.save` and `torch.load`).

Two long-running workloads keep state worth saving: an inverse-rendering
run (`parallel/shard.make_train_step`: params, the optimizer's
``state_dict()`` and the step) and a progressive accumulation
(`trace/progressive.py`: the running sum and the sample index).  Their
steps are deterministic, so a resumed run equals the uninterrupted one bit
for bit.

A checkpoint is one file a step, ``step_<n>.pt`` in the store's directory,
holding the state with every tensor moved to the CPU.  A save writes a
temporary file and renames it into place (`os.replace`), so a reader never
sees half a checkpoint; the newest ``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _map(x, fn):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and named
    tuples; other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(v, fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(v, fn) for v in x)
    return x


def _place(loaded, like):
    """``loaded`` with each tensor on the device and dtype of its
    counterpart in ``like``; a tensor without one stays on the CPU.  The
    structure is ``loaded``'s (an optimizer's state before its first step
    has no per-parameter entries)."""
    if isinstance(loaded, torch.Tensor):
        if isinstance(like, torch.Tensor):
            return loaded.to(device=like.device, dtype=like.dtype)
        return loaded
    if isinstance(loaded, dict):
        like = like if isinstance(like, dict) else {}
        return {k: _place(v, like.get(k)) for k, v in loaded.items()}
    if isinstance(loaded, (list, tuple)):
        like = like if isinstance(like, (list, tuple)) \
            and len(like) == len(loaded) else [None] * len(loaded)
        items = [_place(v, w) for v, w in zip(loaded, like)]
        if hasattr(loaded, "_fields"):
            return type(loaded)(*items)
        return type(loaded)(items)
    return loaded


class CheckpointStore:
    """A directory of checkpoints: ``save(step, state)`` and
    ``restore(state_like)``, where ``state`` is a tree (dicts, lists,
    tuples, named tuples) of tensors and scalars.  ``restore`` places each
    tensor like its counterpart in ``state_like``: pass the freshly
    initialized state a run would otherwise start from."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first."""
        steps = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in steps if m)

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` as step ``step`` (atomically), then drop all but
        the newest ``max_to_keep`` steps.  Returns True."""
        path = self._path(int(step))
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(_map(state, lambda t: t.detach().cpu()), tmp)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: int | None = None) -> Any:
        """Step ``step`` (the latest when None), its tensors placed like
        ``state_like``'s.  None when the directory holds no step."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        # The file is one this store wrote (`save`): unpickling it is safe.
        loaded = torch.load(self._path(int(step)), map_location="cpu",
                            weights_only=False)
        return _place(loaded, state_like)

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_train_state(directory: str, step: int, params, opt_state,
                     **extra) -> bool:
    """One-call save of an inverse-rendering run's state."""
    with CheckpointStore(directory) as store:
        return store.save(step, {"params": params, "opt_state": opt_state,
                                 **extra})


def restore_train_state(directory: str, params, opt_state, **extra):
    """One-call resume: ``(step, state_dict)``, or ``(None, None)`` when no
    checkpoint exists.  ``params`` and ``opt_state`` are the freshly
    initialized trees that place the restored tensors."""
    with CheckpointStore(directory) as store:
        step = store.latest_step()
        if step is None:
            return None, None
        state = store.restore({"params": params, "opt_state": opt_state,
                               **extra}, step=step)
        return step, state
