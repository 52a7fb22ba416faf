"""Checkpoint / resume for deterministic replay (port of the single-process
part of ``shermbot_navigation_tpu.pipeline.checkpoint``).

A state -- a NamedTuple of tensors (or numpy arrays), possibly nested --
round-trips through one ``.npz`` file together with a JSON descriptor of
its leaf names, so a run can stop at step k and resume bit-identically
(config 5's refinement: ``tests/test_torch_megamap.py``). The leaf names
are the JAX package's (``.poses``, ``.graph/.poses``), so a state written
by either package loads into the other's template.

A template whose structure, leaf shapes or leaf dtypes differ from the
file's fails loudly. :func:`load` puts every leaf on its template leaf's
device.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

__all__ = ["save", "load"]


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


def save(path: str, tree: Any, step: int | None = None) -> None:
    """Write a checkpoint. ``step`` is stored alongside if given."""
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, (_, x) in enumerate(flat)}
    meta = {"names": ["/".join(p) for p, _ in flat], "num_leaves": len(flat)}
    if step is not None:
        meta["step"] = int(step)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load(path: str, like: Any):
    """Load a checkpoint into the structure of ``like`` (a template with
    the same structure, leaf shapes and dtypes). Returns ``(tree, step)``,
    step None where none was recorded."""
    flat = _flatten(like)
    names = ["/".join(p) for p, _ in flat]
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
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
    return _rebuild(like, iter(leaves)), meta.get("step")
