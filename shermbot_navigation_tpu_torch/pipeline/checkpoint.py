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
same layout, the JAX package's failure-recovery contract, in its file
layout (one array a shard, indexed by its global position), so a sharded
file of either package loads into the other on the same layout.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from ..parallel.blocked_ekf import STATE_SHARDING

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
# in the JAX package's layout
# ---------------------------------------------------------------------------

def _proc_file(path: str, process_index: int) -> str:
    return f"{path}.proc{process_index}.npz"


def _shard_indices(flat, mesh) -> list:
    """For each leaf of a sharded ``BlockedState``, the JAX global index
    ``[[start, stop], ...]`` of each of this process's local shards (the
    leaf's leading axis): along ``'map'`` the shard's rows, along
    ``'data'`` the map group's worlds, elsewhere the whole dim."""
    spec_flat = [s for _, s in _flatten(STATE_SHARDING)]
    if len(spec_flat) != len(flat):
        raise ValueError(f"a sharded checkpoint holds a BlockedState's "
                         f"{len(spec_flat)} leaves, not {len(flat)}")
    group = mesh.process_index // mesh.procs
    shard_ids = [mesh.rank * mesh.local_shards + l
                 for l in range(mesh.local_shards)]
    out = []
    for (name, x), spec in zip(flat, spec_flat):
        shape = tuple(x.shape[1:])
        if x.shape[:1] != (mesh.local_shards,) or len(spec) != len(shape):
            raise ValueError(
                f"leaf {'/'.join(name)} of shape {tuple(x.shape)} does not "
                f"lead with the {mesh.local_shards} local shards of a "
                f"{len(spec)}-dim field")
        block = [{None: 0, "data": group, "map": s} for s in shard_ids]
        out.append([[[k[a] * n, (k[a] + 1) * n] for a, n in zip(spec, shape)]
                    for k in block])
    return out


def save_sharded(path: str, tree: Any, mesh, step: int | None = None
                 ) -> None:
    """Write this process's map shards of ``tree`` (every leaf leading with
    ``mesh``'s local-shard axis, as ``blocked_ekf.shard_state`` gives) to
    ``<path>.proc<k>.npz``, k its process index, as the JAX
    ``save_sharded`` writes its addressable shards: local shard j of leaf
    i is ``leaf_{i}_shard_{j}``, and ``shard_indices[i][j]`` its JAX
    global index, from the mesh axis of each global dim
    (``blocked_ekf.STATE_SHARDING``, the JAX ``state_sharding``). Every
    process calls it."""
    flat = _flatten(tree)
    indices = _shard_indices(flat, mesh)
    arrays = {f"leaf_{i}_shard_{j}": _numpy(x[j])
              for i, (_, x) in enumerate(flat) for j in range(x.shape[0])}
    # shards and local_shards: the port's own keys, which the JAX reader
    # ignores; they let a changed layout be refused on every process
    meta = {"names": ["/".join(p) for p, _ in flat], "num_leaves": len(flat),
            "shard_indices": indices, "process_index": mesh.process_index,
            "process_count": mesh.process_count, "shards": mesh.shards,
            "local_shards": mesh.local_shards}
    if step is not None:
        meta["step"] = int(step)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez(_proc_file(path, mesh.process_index), **arrays)


def load_sharded(path: str, like: Any, mesh):
    """Restore this process's shards, written by :func:`save_sharded` of
    either package, into the structure of ``like`` (the process's sharded
    template). Each local shard is found by its JAX global index, as the
    JAX ``load_sharded`` finds it; a changed process count or shard layout
    raises. Returns ``(tree, step)``."""
    flat = _flatten(like)
    names = ["/".join(p) for p, _ in flat]
    indices = _shard_indices(flat, mesh)
    with np.load(_proc_file(path, mesh.process_index)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if names != meta["names"]:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved: {meta['names']}\n "
                f"template: {names}")
        if meta["process_count"] != mesh.process_count:
            raise ValueError(
                f"checkpoint written by {meta['process_count']} processes, "
                f"restoring with {mesh.process_count} — mesh must match")
        for k in ("shards", "local_shards"):
            if k in meta and meta[k] != getattr(mesh, k):
                raise ValueError(
                    f"map shard layout changed since the save: {k} "
                    f"{meta[k]} in the file, {getattr(mesh, k)} here")
        leaves = []
        for i, (name, (_, tmpl)) in enumerate(zip(names, flat)):
            lookup = {tuple(map(tuple, idx)): f"leaf_{i}_shard_{j}"
                      for j, idx in enumerate(meta["shard_indices"][i])}
            parts = []
            for idx in indices[i]:
                key = tuple(map(tuple, idx))
                if key not in lookup:
                    raise ValueError(
                        f"leaf {name}: shard {key} not in this process's "
                        f"checkpoint file — mesh layout changed since save")
                parts.append(torch.from_numpy(data[lookup[key]]))
            arr = torch.stack(parts)
            if arr.shape != tmpl.shape or arr.dtype != tmpl.dtype:
                raise ValueError(
                    f"leaf {name}: saved {arr.dtype} {tuple(arr.shape)} != "
                    f"template {tmpl.dtype} {tuple(tmpl.shape)}")
            leaves.append(arr.to(tmpl.device))
    return _rebuild(like, iter(leaves)), meta.get("step")
