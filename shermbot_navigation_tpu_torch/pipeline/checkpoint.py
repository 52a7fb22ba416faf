"""Checkpoint / resume for deterministic replay (port of
``shermbot_navigation_tpu.pipeline.checkpoint``).

A state -- a NamedTuple of tensors (or numpy arrays), possibly nested --
round-trips through one ``.npz`` file together with a JSON descriptor of
its leaf names, so a run can stop at step k and resume bit-identically
(config 5's refinement: ``tests/test_torch_megamap.py``). The leaf names
are the JAX package's (``.poses``, ``.graph/.poses``), so a state written
by either package loads into the other's template.

A template whose structure, leaf shapes or leaf dtypes differ from the
file's fails loudly. :func:`load` puts every leaf on its template leaf's
device. With map shards over several processes (``parallel/mesh.py``),
:func:`save_sharded` has every process write its own shards to
``<path>.proc<k>.npz`` and :func:`load_sharded` read them back on the
same layout, the JAX package's failure-recovery contract.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load", "save_sharded", "load_sharded"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """(name path, leaf) pairs in the JAX package's leaf order."""
    if not _is_namedtuple(tree):
        return [(prefix, tree)]
    return [leaf for k, v in zip(tree._fields, tree)
            for leaf in _flatten(v, prefix + (f".{k}",))]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_flatten`'s order, by
    the iterator ``leaves``."""
    if not _is_namedtuple(tree):
        return next(leaves)
    return type(tree)(*(_rebuild(v, leaves) for v in tree))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _write(path: str, tree: Any, step: int | None, **extra) -> None:
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, (_, x) in enumerate(flat)}
    meta = {"names": ["/".join(p) for p, _ in flat], "num_leaves": len(flat),
            **extra}
    if step is not None:
        meta["step"] = int(step)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def _read(path: str, like: Any, check=None):
    """The tree in ``path`` in the structure of ``like``, and the file's
    metadata (``check(meta)`` raises on a file this reader must refuse)."""
    flat = _flatten(like)
    names = ["/".join(p) for p, _ in flat]
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if check is not None:
            check(meta)
        if meta["num_leaves"] != len(flat):
            raise ValueError(
                f"checkpoint has {meta['num_leaves']} leaves, template has "
                f"{len(flat)}")
        if names != meta["names"]:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved: {meta['names']}\n "
                f"template: {names}")
        leaves = []
        for i, (name, (_, tmpl)) in enumerate(zip(names, flat)):
            arr = torch.from_numpy(data[f"leaf_{i}"])
            tmpl = torch.as_tensor(tmpl)
            if arr.shape != tmpl.shape:
                raise ValueError(
                    f"leaf {name}: saved shape {tuple(arr.shape)} != "
                    f"template {tuple(tmpl.shape)}")
            if arr.dtype != tmpl.dtype:
                raise ValueError(
                    f"leaf {name}: saved dtype {arr.dtype} != template "
                    f"{tmpl.dtype}")
            leaves.append(arr.to(tmpl.device))
    return _rebuild(like, iter(leaves)), meta


def save(path: str, tree: Any, step: int | None = None) -> None:
    """Write a checkpoint. ``step`` is stored alongside if given."""
    _write(path, tree, step)


def load(path: str, like: Any):
    """Load a checkpoint into the structure of ``like`` (a template with
    the same structure, leaf shapes and dtypes). Returns ``(tree, step)``,
    step None where none was recorded."""
    tree, meta = _read(path, like)
    return tree, meta.get("step")


# ---------------------------------------------------------------------------
# Map shards across processes: each process writes and reads its own file
# ---------------------------------------------------------------------------

def _proc_file(path: str, process_index: int) -> str:
    return f"{path}.proc{process_index}.npz"


def _layout(tree: Any, mesh) -> dict:
    """The shard layout a sharded tree is saved with (the JAX
    ``save_sharded``'s metadata): each leaf's global shard indices, and
    the process's place."""
    n = len(_flatten(tree))
    return {"shard_indices": [mesh.shard_ids().tolist()] * n,
            "shards": mesh.shards, "local_shards": mesh.local_shards,
            "process_index": mesh.process_index,
            "process_count": mesh.process_count}


def save_sharded(path: str, tree: Any, mesh, step: int | None = None
                 ) -> None:
    """Write this process's map shards of ``tree`` (every leaf leading with
    ``mesh``'s local-shard axis, as ``blocked_ekf.shard_state`` gives) to
    ``<path>.proc<k>.npz``, k its process index, with the global indices of
    its shards and the process count. Every process calls it."""
    for name, x in _flatten(tree):
        if tuple(x.shape[:1]) != (mesh.local_shards,):
            raise ValueError(f"leaf {'/'.join(name)} of shape "
                             f"{tuple(x.shape)} does not lead with the "
                             f"{mesh.local_shards} local shards")
    _write(_proc_file(path, mesh.process_index), tree, step,
           **_layout(tree, mesh))


def load_sharded(path: str, like: Any, mesh):
    """Restore :func:`save_sharded`'s file of this process into the
    structure of ``like`` (the process's sharded template). Each process
    reads only its own file; a changed process count or shard layout
    raises. Returns ``(tree, step)``."""
    want = _layout(like, mesh)

    def check(meta):
        if meta.get("process_count") != want["process_count"]:
            raise ValueError(
                f"checkpoint written by {meta.get('process_count')} "
                f"processes, restoring with {want['process_count']}: the "
                f"layout must match")
        for k in ("shards", "local_shards", "shard_indices"):
            if meta.get(k) != want[k]:
                raise ValueError(
                    f"map shard layout changed since the save: {k} "
                    f"{meta.get(k)} in the file, {want[k]} here")

    tree, meta = _read(_proc_file(path, mesh.process_index), like, check)
    return tree, meta.get("step")
