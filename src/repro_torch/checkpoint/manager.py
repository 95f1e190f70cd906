"""Checkpointing (reference ``checkpoint/manager.py``): an npz of arrays and
a JSON manifest, scrub-on-save, async save, restore with reference repair,
and a preemption hook.

Trees are the port's flat states (``{path: leaf}``, ``launch.train``) or
nested dicts of them.  Leaves are tensors, host integers (the train state's
``stats``) and numpy arrays (its ``rule_counts``).

  * **scrub-on-save**: the state is NaN/Inf-repaired before it is written,
    so a checkpoint is always a clean source for the ``last_checkpoint``
    policy (``core.checkpoint_repair``).  The scrub repairs a copy: the
    live state keeps its bits, fatal lanes included, for the next boundary
    scrub to count; only the written bytes are guaranteed clean.
  * **the reference's files**: ``step_XXXXXXXX/arrays.npz`` keyed by tree
    path and ``manifest.json`` (``step``, ``leaves`` {shape, dtype},
    ``extra``, ``format`` 1), the leaves in the reference's order.  Host
    integers and int64 arrays are written as int32, the reference's dtype
    for them.  numpy has no bfloat16, so a bfloat16 leaf is written
    as its raw 2-byte words (``|V2``), the manifest naming its dtype, as
    the reference writes one; on restore a 2-byte leaf is rebuilt from its
    bits by the manifest's dtype.  Either package reads the other's files.
  * **atomic**: written to ``step_XXXXXXXX.tmp`` (the manifest last), then
    renamed, so a torn save is invisible to ``latest_step``.
  * **async save**: ``save`` returns once it holds a scrubbed host copy of
    the state, taken one leaf at a time (the train step updates its
    tensors in place, so this copy is the one sync point); only the file
    write runs on a worker thread.  ``wait()`` joins it.
  * **preemption hook**: ``install_preemption_hook`` runs one synchronous
    save on SIGTERM, then the previous handler.
  * **stateless data**: batches are pure functions of (seed, step)
    (``data.pipeline``), so nothing of the stream is stored.

Restores go onto ``like``'s devices and dtypes.  Resharding onto a mesh
(``shardings``) is not ported: ROADMAP slice 6 (multi-GPU).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.regions import flatten
from ..runtime import ApproxSpace, ScrubSchedule

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_WORDS16 = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _save_space(repair_cfg: Optional[Any], space: Optional[ApproxSpace]):
    """The runtime used for scrub-on-save: memory-forced (a checkpoint must
    be clean whatever the run's repair mode), zero fill by default.  A
    ``repair_cfg`` carrying its own ``RuleSet`` keeps it: save scrubs and
    restore repairs run as forced passes, every non-exact rule with its own
    detector and fill, exact-island leaves untouched."""
    if space is not None:
        return space
    if repair_cfg is None:
        return ApproxSpace(mode="memory", policy="zero")
    return ApproxSpace(repair_cfg, mode="memory", max_magnitude=None,
                       scrub=ScrubSchedule())


def _flat(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """``{path: leaf}`` in the reference's leaf order: nested dicts
    flattened with their keys sorted, the top-level entries stable-sorted
    by their first path component.  A flat train state keeps ``opt/step``
    before the moments, as the reference's ``OptState`` holds them."""
    flat: Dict[str, Any] = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            flat.update(flatten(leaf, key))
        else:
            flat[key] = leaf
    return dict(sorted(flat.items(), key=lambda kv: kv[0].split("/", 1)[0]))


def _tensors(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The tensor leaves of ``tree`` under their paths (the same objects,
    so a pass over them updates ``tree``)."""
    return {p: v for p, v in _flat(tree).items() if isinstance(v, torch.Tensor)}


def _host_copy(tree: Mapping[str, Any],
               space: Optional[ApproxSpace]) -> Dict[str, Any]:
    """A host copy of every leaf, in ``_flat`` order; with ``space`` the
    tensors are scrubbed on their device first, each on a clone
    (``ApproxSpace.scrub_copies``), so ``tree`` keeps its bits."""
    flat = _flat(tree)
    host = dict.fromkeys(flat)

    def sink(path, leaf):
        host[path] = leaf.detach().to("cpu", copy=True)

    tensors = {p: v for p, v in flat.items() if isinstance(v, torch.Tensor)}
    if space is not None:
        space.scrub_copies(tensors, sink)
    else:
        for path, leaf in tensors.items():
            sink(path, leaf)
    for path, leaf in flat.items():
        if path not in tensors:
            host[path] = np.array(leaf)
    return host


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2"), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return arr, str(arr.dtype)


def save_checkpoint(
    directory: str,
    step: int,
    tree: Mapping[str, Any],
    *,
    scrub: bool = True,
    repair_cfg: Optional[Any] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
    space: Optional[ApproxSpace] = None,
) -> str:
    """Synchronous checkpoint write of a scrubbed copy of ``tree``.
    Returns the checkpoint's path."""
    save = _save_space(repair_cfg, space) if scrub else None
    return _write(directory, step, _host_copy(tree, save), extra_meta)


def _write(directory: str, step: int, host: Dict[str, Any],
           extra_meta: Optional[Dict[str, Any]]) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays, meta_leaves = {}, {}
    for path, leaf in host.items():
        arr, dtype = _to_numpy(leaf)
        arrays[path] = arr
        meta_leaves[path] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(os.path.join(tmp, _ARRAYS), **arrays)

    manifest = {
        "step": int(step),
        "leaves": meta_leaves,
        "extra": extra_meta or {},
        "format": 1,
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _read_arrays(directory: str, step: Optional[int]) -> Tuple[Dict, Dict]:
    """One disk read: (manifest, {tree path: host ndarray})."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, _ARRAYS)) as npz:
        data = {k: npz[k] for k in npz.files}
    return manifest, data


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A host array as a tensor over its memory (a 2-byte void leaf rebuilt
    from its bits as the manifest's 16-bit dtype)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(_WORDS16[dtype_name])
    return torch.from_numpy(arr)


def _materialize(data: Dict[str, np.ndarray], manifest: Dict[str, Any],
                 like: Mapping[str, Any], shardings: Any = None):
    """Host arrays -> a new tree shaped like ``like``: each tensor on its
    prototype's device in its dtype, integers as host ints, numpy arrays
    in their dtype."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings is not ported: ROADMAP slice 6 "
            "(multi-GPU)"
        )
    leaves = manifest["leaves"]

    def build(node, prefix):
        if isinstance(node, Mapping):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        arr = data[prefix]
        if isinstance(node, torch.Tensor):
            # a copy: the tree owns its tensors (``restore`` builds two)
            return _tensor(arr, leaves[prefix]["dtype"]).to(
                device=node.device, dtype=node.dtype, copy=True)
        if isinstance(node, (np.ndarray, np.generic)):
            return arr.astype(node.dtype)
        if isinstance(node, (bool, int, float)):
            return type(node)(arr)
        return arr

    return build(like, "")


def load_checkpoint(
    directory: str,
    step: Optional[int] = None,
    *,
    like: Optional[Mapping[str, Any]] = None,
    shardings: Any = None,
) -> Tuple[Any, int]:
    """Restore ``(tree, step)`` (the latest step by default).  ``like``
    gives the tree's structure, devices and dtypes; without it the result
    is the flat ``{path: ndarray}`` of the file."""
    manifest, data = _read_arrays(directory, step)
    if like is None:
        return data, manifest["step"]
    return _materialize(data, manifest, like, shardings), manifest["step"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for n in os.listdir(directory):
        m = re.fullmatch(r"step_(\d{8})", n)
        if m and os.path.exists(os.path.join(directory, n, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


class CheckpointManager:
    """Async, retention-managed checkpointing with a preemption hook."""

    def __init__(
        self,
        directory: str,
        *,
        keep: int = 3,
        scrub: bool = True,
        repair_cfg: Optional[Any] = None,
        space: Optional[ApproxSpace] = None,
    ):
        self.directory = directory
        self.keep = keep
        self.scrub = scrub
        self.repair_cfg = repair_cfg
        # one runtime for every save and restore of this manager: the
        # save scrub's and the reference repairs' events land in its stream
        self.space = _save_space(repair_cfg, space)
        self._thread: Optional[threading.Thread] = None

    # -------------------------------------------------------------- saving
    def save(self, step: int, tree: Mapping[str, Any], *,
             blocking: bool = False) -> None:
        """Take the scrubbed host copy now (clone, scrub and move to the
        host one leaf at a time; ``tree`` keeps its bits); write it on a
        worker thread, or before returning with ``blocking``."""
        self.wait()
        host = _host_copy(tree, self.space if self.scrub else None)

        def work():
            _write(self.directory, step, host, None)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = sorted(
            int(m.group(1))
            for n in os.listdir(self.directory)
            if (m := re.fullmatch(r"step_(\d{8})", n))
        )
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def restore(
        self,
        like: Optional[Mapping[str, Any]] = None,
        shardings: Any = None,
        *,
        repair: bool = False,
        step: Optional[int] = None,
    ):
        """Restore ``(tree, step)``.  ``repair=True`` then runs the
        reference repair of the restored tree against the same checkpoint,
        materialised a second time from the one disk read, so a lane that
        went bad between the read and the placement never survives."""
        if repair and like is None:
            raise ValueError(
                "repair=True needs `like` (a tree to repair against)"
            )
        manifest, data = _read_arrays(self.directory, step)
        if like is None:
            return data, manifest["step"]
        tree = _materialize(data, manifest, like, shardings)
        if repair:
            ref = _materialize(data, manifest, like, shardings)
            self.space.scrub_with_reference(_tensors(tree), _tensors(ref))
        return tree, manifest["step"]

    def reference_repair(self, tree: Mapping[str, Any], *,
                         step: Optional[int] = None):
        """Repair ``tree`` in place against the checkpoint at ``step``
        (latest by default), restored onto ``tree``'s own devices: each
        fatal lane takes the checkpoint's bits.  Events land in the
        manager's space.  Returns ``tree``."""
        ref, _ = load_checkpoint(self.directory, step, like=tree)
        self.space.scrub_with_reference(_tensors(tree), _tensors(ref))
        return tree

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    # ---------------------------------------------------------- preemption
    def install_preemption_hook(
            self, get_state: Callable[[], Tuple[int, Mapping[str, Any]]]):
        """SIGTERM -> one synchronous save of ``get_state()``, then the
        previous handler."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            step, tree = get_state()
            self.wait()
            save_checkpoint(self.directory, step, tree, scrub=self.scrub,
                            space=self.space)
            if callable(prev):
                prev(signum, frame)

        signal.signal(signal.SIGTERM, handler)
        return handler
