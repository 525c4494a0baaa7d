"""Serving bundles, read and written with numpy and json only (port of the
serving-bundle half of :mod:`repro.checkpoint.store`).

Layout, shared with the JAX package::

    <ckpt_dir>/serving/step_<N:012d>/
        shard_0.npz      # one array per leaf, named by its JAX key path,
                         # e.g. "['default']['mu']['layers'][0]['w']"
        MANIFEST.json    # written last: the commit marker

The manifest's ``meta`` carries the ``repro-serving/v2`` handshake: a list
of ``{model_id, workload, config}`` entries.  A bundle written here reads
in the JAX package and the other way round.  (The reference also upgrades
older v1 bundles; the port reads v2 only.)
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SERVING_SCHEMA = "repro-serving/v2"
DEFAULT_MODEL_ID = "default"
_SERVING_SUBDIR = "serving"
_KEY_TOKEN = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]|\.(\w+)")


class UnknownServingSchemaError(ValueError):
    """A serving bundle carries a schema this code version cannot read."""


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    valid = sorted(d for d in ckpt_dir.glob("step_*") if (d / "MANIFEST.json").exists())
    return int(valid[-1].name.split("_")[1]) if valid else None


def _step_dir(sdir: Path, step: int) -> Path:
    return sdir / f"step_{step:012d}"


# -----------------------------------------------------------------------------
# leaf names <-> nested trees (JAX's jax.tree_util.keystr format)
# -----------------------------------------------------------------------------


def _parse_keystr(name: str) -> list:
    path = []
    pos = 0
    for m in _KEY_TOKEN.finditer(name):
        if m.start() != pos:
            raise ValueError(f"unreadable leaf name {name!r}")
        if m.group(2) is not None:
            path.append(int(m.group(2)))
        else:
            path.append(m.group(1) if m.group(1) is not None else m.group(3))
        pos = m.end()
    if pos != len(name) or not path:
        raise ValueError(f"unreadable leaf name {name!r}")
    return path


def _tree_from_leaves(leaves: dict):
    """``{keystr: array}`` -> nested dicts (string keys) and lists (indices)."""
    root: dict = {}
    for name, arr in leaves.items():
        path = _parse_keystr(name)
        node = root
        for tok in path[:-1]:
            node = node.setdefault(tok, {})
        node[path[-1]] = arr
    return _lists_from_int_keys(root)


def _lists_from_int_keys(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence leaves with gaps: {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out


def _rebuild(tree, fn, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(name, leaf)``;
    ``name`` is the leaf's ``jax.tree_util.keystr`` (a NamedTuple's fields
    as ``.name``)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_numpy(leaf) -> np.ndarray:
    """A tensor, a host integer (the optimizer step: int32, as JAX's) or an
    array -> numpy; bfloat16 as its 16-bit words (``V2``)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _leaves_from_tree(tree) -> dict:
    out = {}
    _rebuild(tree, lambda name, leaf: out.__setitem__(name, _to_numpy(leaf)))
    return out


# -----------------------------------------------------------------------------
# reading
# -----------------------------------------------------------------------------


def load_serving_manifest(ckpt_dir) -> Tuple[dict, int]:
    """The newest bundle's ``repro-serving/v2`` handshake -> ``(meta, step)``."""
    sdir = Path(ckpt_dir) / _SERVING_SUBDIR
    step = latest_step(sdir)
    if step is None:
        raise FileNotFoundError(
            f"no serving bundle under {ckpt_dir} (expected "
            f"<ckpt-dir>/{_SERVING_SUBDIR}/step_*/MANIFEST.json, written by "
            f"repro.launch.train or repro_torch.checkpoint.save_serving_bundle)")
    manifest = json.loads((_step_dir(sdir, step) / "MANIFEST.json").read_text())
    meta = manifest.get("meta") or {}
    schema = meta.get("schema")
    if schema != SERVING_SCHEMA:
        raise UnknownServingSchemaError(
            f"serving bundle under {ckpt_dir} has schema {schema!r}; the port reads "
            f"{SERVING_SCHEMA!r} (re-save older bundles with the JAX package)")
    if not meta.get("models"):
        raise ValueError(f"serving bundle under {ckpt_dir} carries no model entries")
    return meta, step


def load_serving_bundle(ckpt_dir, model_id: Optional[str] = None):
    """Read one model of the newest bundle -> ``(tree, entry, step)``.

    ``tree`` is the model's parameter pytree as nested dicts/lists of numpy
    arrays (feed it to :func:`params_from_jax`); ``entry`` is its manifest
    entry (``model_id``, ``workload``, ``config``).  ``model_id=None``
    takes the sole entry of a single-model bundle."""
    meta, step = load_serving_manifest(ckpt_dir)
    ids = [m["model_id"] for m in meta["models"]]
    if model_id is None:
        if len(ids) != 1:
            raise ValueError(f"serving bundle under {ckpt_dir} carries {len(ids)} "
                             f"models {ids}; name one with model_id=")
        model_id = ids[0]
    if model_id not in ids:
        raise ValueError(f"serving bundle under {ckpt_dir} has no model "
                         f"{model_id!r} (entries: {ids})")
    entry = meta["models"][ids.index(model_id)]
    shard = _step_dir(Path(ckpt_dir) / _SERVING_SUBDIR, step) / "shard_0.npz"
    with np.load(shard) as data:
        tree = _tree_from_leaves({n: data[n] for n in data.files})
    return tree[model_id], entry, step


# -----------------------------------------------------------------------------
# writing
# -----------------------------------------------------------------------------


def config_to_meta(cfg) -> dict:
    """Dataclass config -> JSON-safe dict; a torch dtype becomes its name."""
    out = {}
    for k, v in dataclasses.asdict(cfg).items():
        out[k] = str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else v
    return out


def save_serving_bundle(ckpt_dir, step: int, params, workload: str, cfg,
                        model_id: str = DEFAULT_MODEL_ID) -> Path:
    """Write a single-model ``repro-serving/v2`` bundle (atomically: the
    manifest is written into a temporary directory that is renamed last)."""
    sdir = Path(ckpt_dir) / _SERVING_SUBDIR
    final = _step_dir(sdir, step)
    tmp = sdir / f".tmp_step_{step:012d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = _leaves_from_tree({model_id: params})
    np.savez(tmp / "shard_0.npz", **arrays)
    meta = {"schema": SERVING_SCHEMA,
            "models": [{"model_id": model_id, "workload": workload,
                        "config": config_to_meta(cfg)}]}
    manifest = {"step": step, "num_hosts": 1,
                "leaves": {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
                           for n, a in arrays.items()},
                "meta": meta}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


# -----------------------------------------------------------------------------
# training checkpoints
# -----------------------------------------------------------------------------


def save_checkpoint(ckpt_dir, step: int, tree, host_id: int = 0, keep: int = 3,
                    meta: Optional[dict] = None) -> Path:
    """Atomically persist ``tree`` at ``step``; prune to the ``keep`` newest.
    ``meta``: an optional JSON-safe dict stored in the manifest."""
    ckpt_dir = Path(ckpt_dir)
    step_dir = _step_dir(ckpt_dir, step)
    tmp_dir = ckpt_dir / f".tmp_step_{step:012d}"
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    arrays = _leaves_from_tree(tree)
    np.savez(tmp_dir / f"shard_{host_id}.npz", **arrays)
    manifest = {"step": step, "num_hosts": 1,
                "leaves": {n: {"shape": list(a.shape), "dtype": str(a.dtype)}
                           for n, a in arrays.items()}}
    if meta is not None:
        manifest["meta"] = meta
    (tmp_dir / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
    if step_dir.exists():
        shutil.rmtree(step_dir)
    tmp_dir.rename(step_dir)
    valid = sorted(d for d in ckpt_dir.glob("step_*") if (d / "MANIFEST.json").exists())
    for d in valid[:-keep]:
        shutil.rmtree(d)
    for d in ckpt_dir.glob(".tmp_step_*"):
        shutil.rmtree(d)
    return step_dir


def _restore_leaf(arr: np.ndarray, like, name: str):
    """One stored array in the dtype, device and kind of ``like``."""
    if isinstance(like, int):
        return int(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {name}: shape {arr.shape} != {tuple(like.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 words
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=like.device, dtype=like.dtype)


def restore_checkpoint(ckpt_dir, like_tree, step: Optional[int] = None, host_id: int = 0):
    """Restore into the structure, dtypes and devices of ``like_tree`` ->
    ``(tree, step)``.  Raises FileNotFoundError when nothing valid exists."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")
    step_dir = _step_dir(ckpt_dir, step)
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    with np.load(step_dir / f"shard_{host_id}.npz") as data:
        restored = _rebuild(like_tree, lambda n, like: _restore_leaf(data[n], like, n))
    return restored, manifest["step"]
