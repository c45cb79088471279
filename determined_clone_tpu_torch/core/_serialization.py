"""Pytree checkpoint serialization — the port's copy of
``determined_clone_tpu/core/_serialization.py``, in the same format, so a
checkpoint moves both ways between the JAX package and the port.

Format 2: ``shard-{host}.npz`` holds one array per leaf under its flat
key, and ``manifest-{host}.json`` lists every leaf by its tree path with
its shape, dtype and blocks. A tree path joins the keys from the root
with "/" as JAX prints them: a dict's key, a sequence's index, and for a
named tuple "." plus the field name (JAX's ``GetAttrKey``), so optax's
``ScaleByAdamState.mu`` inside the second entry of a chain is
``1/0/.mu``. The flat key replaces "/" with ".", which may give a double
dot (``1.0..mu.w``); leaves are therefore loaded by their path, never by
their position, and dicts are listed in sorted key order, as JAX
flattens them.

The port's trees are nested dicts, tuples and named tuples of tensors,
numpy arrays and Python numbers; an object with ``tree_flatten()`` and
a ``tree_unflatten(children)`` class method (the port's ``TrainState``)
is a node whose children are indexed by position, as the JAX
``TrainState`` registers them. Python ints are saved as int32 and floats
as float32, the dtypes JAX gives those leaves.

Sharded saves: a DTensor leaf is written as the JAX package writes an
array that is not fully addressable — each rank its own block, keyed
``{flat key}#{rank}``, with the block's global ``index`` in the
manifest; a block held by several ranks (replicated over some mesh axes)
is written once, by the rank at coordinate 0 of those axes. Each rank
writes ``shard-{rank}.npz`` and ``manifest-{rank}.json``; the readers of
both packages merge the manifests and assemble the global arrays. A
load whose ``like`` holds DTensors places each rank's block of the
assembled array on the same mesh and placements.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_RE = re.compile(r"manifest-(\d+)\.json$")


def _flat_key(path: str) -> str:
    return path.replace("/", ".")


def _children(node: Any) -> List[Tuple[str, Any]]:
    """(key, child) pairs of a tree node in its own order; ``[]`` for an
    empty node; raises TypeError for a leaf."""
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    if node is None:
        return []
    if hasattr(node, "tree_flatten"):
        return [(str(i), v) for i, v in enumerate(node.tree_flatten())]
    raise TypeError(f"{type(node).__name__} is a leaf")


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, np.ndarray, np.generic, int,
                             float, bool))


def tree_paths_and_leaves(tree: Any, prefix: str = "", *,
                          is_leaf: Optional[Callable[[Any], bool]] = None
                          ) -> List[Tuple[str, Any]]:
    """Every leaf of ``tree`` with its JAX tree path; dict keys sorted.
    ``is_leaf`` marks further nodes as leaves."""
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return [(prefix, tree)]
    kids = _children(tree)
    if isinstance(tree, dict):
        kids = sorted(kids)
    out: List[Tuple[str, Any]] = []
    for key, child in kids:
        out += tree_paths_and_leaves(child, f"{prefix}/{key}" if prefix
                                     else key, is_leaf=is_leaf)
    return out


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "", *,
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> Any:
    """``tree`` rebuilt with every leaf replaced by ``fn(path, leaf)``."""
    if _is_leaf(tree) or (is_leaf is not None and is_leaf(tree)):
        return fn(prefix, tree)
    new = [tree_map_with_path(fn, child, f"{prefix}/{key}" if prefix
                              else key, is_leaf=is_leaf)
           for key, child in _children(tree)]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    if isinstance(tree, (tuple, list)):
        return type(tree)(new)
    if tree is None:
        return None
    return type(tree).tree_unflatten(new)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; keep "
                            "checkpointed state in float32")
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    return np.asarray(leaf)


def _is_dtensor(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and hasattr(leaf, "placements")


def _dtensor_entry(key: str, path: str, leaf: Any, host_id: int,
                   arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    from torch.distributed.tensor import Shard

    from determined_clone_tpu_torch.parallel.sharding import shard_index

    mesh, pl = leaf.device_mesh, leaf.placements
    coord = mesh.get_coordinate()
    local = _to_numpy(leaf.to_local())
    entry: Dict[str, Any] = {"path": path, "global_shape": list(leaf.shape),
                             "dtype": str(local.dtype), "blocks": []}
    # a replicated block is written by its first holder only
    if all(c == 0 for md, c in enumerate(coord)
           if not isinstance(pl[md], Shard)):
        bkey = f"{key}#{host_id}"
        arrays[bkey] = local
        entry["blocks"].append({"key": bkey, "index": shard_index(
            leaf.shape, mesh, pl)})
    return entry


def save_pytree(ckpt_dir: str, tree: Any, *, host_id: int = 0) -> None:
    """Save ``tree`` under ckpt_dir as this host's (rank's) shard."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"leaves": {}, "format": 2, "host": host_id}
    for path, leaf in tree_paths_and_leaves(tree):
        key = _flat_key(path)
        if _is_dtensor(leaf):
            manifest["leaves"][key] = _dtensor_entry(key, path, leaf,
                                                     host_id, arrays)
            continue
        arr = _to_numpy(leaf)
        arrays[key] = arr
        manifest["leaves"][key] = {
            "path": path,
            "global_shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "blocks": [{"key": key, "index": [[0, d] for d in arr.shape]}],
        }
    np.savez(os.path.join(ckpt_dir, f"shard-{host_id}.npz"), **arrays)
    with open(os.path.join(ckpt_dir, f"manifest-{host_id}.json"), "w") as f:
        json.dump(manifest, f)


def _from_numpy(arr: np.ndarray, ref: Any) -> Any:
    """A loaded array in the kind of leaf ``ref`` is: a tensor on ref's
    device (the checkpoint's dtype, as JAX loads it), a Python number, or
    the array itself. A DTensor ``ref`` gets a DTensor of this rank's
    block, on ref's mesh and placements."""
    if _is_dtensor(ref):
        from torch.distributed.tensor import DTensor

        from determined_clone_tpu_torch.parallel.sharding import local_block

        block = local_block(torch.from_numpy(arr), ref.device_mesh,
                            ref.placements)
        return DTensor.from_local(
            block.to(ref.to_local().device, copy=True,
                     memory_format=torch.contiguous_format), ref.device_mesh,
            ref.placements, run_check=False, shape=ref.shape,
            stride=ref.stride())
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(ref.device)
    if isinstance(ref, bool):
        return bool(arr)
    if isinstance(ref, int):
        return int(arr)
    if isinstance(ref, float):
        return float(arr)
    return arr


def load_pytree(ckpt_dir: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like``: each leaf by its
    tree path, with the checkpoint's dtype, on the device of ``like``'s
    leaf. Blocks from several hosts' shards are assembled as the JAX
    reader assembles them."""
    manifests = []
    data: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(ckpt_dir)):
        if MANIFEST_RE.search(fname):
            with open(os.path.join(ckpt_dir, fname)) as f:
                manifests.append(json.load(f))
        elif fname.startswith("shard-") and fname.endswith(".npz"):
            with np.load(os.path.join(ckpt_dir, fname)) as z:
                for k in z.files:
                    data[k] = z[k]
    if not manifests:
        raise FileNotFoundError(f"no checkpoint manifests in {ckpt_dir}")

    leaves_meta: Dict[str, Dict[str, Any]] = {}
    for m in manifests:
        for key, entry in m["leaves"].items():
            if key in leaves_meta:
                leaves_meta[key]["blocks"].extend(entry["blocks"])
            else:
                leaves_meta[key] = {**entry, "blocks": list(entry["blocks"])}

    def load(path: str, ref: Any) -> Any:
        entry = leaves_meta.get(_flat_key(path))
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        shape = tuple(entry["global_shape"])
        ref_shape = tuple(ref.shape if isinstance(ref, torch.Tensor)
                          else np.shape(ref))
        if shape != ref_shape:
            raise ValueError(f"checkpoint leaf {path!r} has shape {shape}, "
                             f"expected {ref_shape}")
        arr = np.empty(shape, dtype=np.dtype(entry["dtype"]))
        filled = np.zeros(shape, dtype=bool)
        for block in entry["blocks"]:
            if block["key"] not in data:
                raise KeyError(f"checkpoint leaf {path!r}: missing block "
                               f"{block['key']!r} (incomplete shard set?)")
            idx = tuple(slice(a, b) for a, b in block["index"])
            arr[idx] = data[block["key"]]
            filled[idx] = True
        if not bool(filled.all()):
            raise ValueError(f"checkpoint leaf {path!r} is missing data "
                             f"blocks (saved from fewer hosts than the "
                             f"array spanned?)")
        return _from_numpy(arr, ref)

    return tree_map_with_path(load, like)
