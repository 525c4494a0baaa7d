"""Serving bundles, read and written with numpy and json only (port of the
serving-bundle half of :mod:`repro.checkpoint.store`).

Layout, shared with the JAX package::

    <ckpt_dir>/serving/step_<N:012d>/
        shard_0.npz      # one array per leaf, named by its JAX key path,
                         # e.g. "['default']['mu']['layers'][0]['w']"
        MANIFEST.json    # written last: the commit marker

The manifest's ``meta`` carries the ``repro-serving/v2`` handshake: a list
of ``{model_id, workload, config}`` entries (and an optional per-model
``serving`` hints dict), one params tree per model id.  A bundle written
here reads in the JAX package and the other way round.  An older
``repro-serving/v1`` bundle (one flat params tree, ``workload`` and
``config`` at the top of ``meta``) is read as a v2 registry with the single
entry ``"default"``, as the reference upgrades it.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SERVING_SCHEMA = SERVING_SCHEMA_V2 = "repro-serving/v2"
SERVING_SCHEMA_V1 = "repro-serving/v1"
DEFAULT_MODEL_ID = "default"
_SERVING_SUBDIR = "serving"


class UnknownServingSchemaError(ValueError):
    """A serving bundle carries a schema this code version cannot read."""


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    valid = sorted(d for d in ckpt_dir.glob("step_*") if (d / "MANIFEST.json").exists())
    return int(valid[-1].name.split("_")[1]) if valid else None


def _step_dir(sdir: Path, step: int) -> Path:
    return sdir / f"step_{step:012d}"


# -----------------------------------------------------------------------------
# leaf names (JAX's jax.tree_util.keystr format)
# -----------------------------------------------------------------------------


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


def _raw_serving_manifest(ckpt_dir) -> Tuple[dict, int]:
    sdir = Path(ckpt_dir) / _SERVING_SUBDIR
    step = latest_step(sdir)
    if step is None:
        raise FileNotFoundError(
            f"no serving bundle under {ckpt_dir} (expected "
            f"<ckpt-dir>/{_SERVING_SUBDIR}/step_*/MANIFEST.json, written by "
            f"repro.launch.train or repro_torch.checkpoint.save_serving_bundle)")
    manifest = json.loads((_step_dir(sdir, step) / "MANIFEST.json").read_text())
    return manifest.get("meta") or {}, step


def load_serving_manifest(ckpt_dir) -> Tuple[dict, int]:
    """The newest bundle's handshake as v2 -> ``(meta, step)``.

    ``meta["models"]`` is a list of ``{model_id, workload, config}``
    entries; a v1 bundle comes back as one ``"default"`` entry with
    ``meta["upgraded_from"]`` set (its leaves are flat, which
    :func:`restore_serving_model` reads)."""
    meta, step = _raw_serving_manifest(ckpt_dir)
    schema = meta.get("schema")
    if schema == SERVING_SCHEMA_V1:
        meta = {"schema": SERVING_SCHEMA, "upgraded_from": SERVING_SCHEMA_V1,
                "models": [{"model_id": DEFAULT_MODEL_ID, "workload": meta.get("workload"),
                            "config": meta.get("config", {})}]}
    elif schema != SERVING_SCHEMA:
        raise UnknownServingSchemaError(
            f"serving bundle under {ckpt_dir} has schema {schema!r}; the port reads "
            f"{SERVING_SCHEMA!r} (and upgrades {SERVING_SCHEMA_V1!r})")
    if not meta.get("models"):
        raise ValueError(f"serving bundle under {ckpt_dir} carries no model entries")
    return meta, step


def load_serving_meta(ckpt_dir) -> Tuple[dict, int]:
    """The single-model view of the handshake -> ``(meta, step)``, ``meta``
    with flat ``model_id``, ``workload`` and ``config`` keys; a bundle of
    several models is refused by name."""
    meta, step = load_serving_manifest(ckpt_dir)
    models = meta["models"]
    if len(models) != 1:
        raise ValueError(
            f"serving bundle under {ckpt_dir} carries {len(models)} model entries "
            f"({[m['model_id'] for m in models]}); the single-model reader cannot "
            f"pick one — use load_serving_manifest / repro_torch.serving.ModelRegistry.load")
    entry = models[0]
    return {"schema": meta["schema"], "model_id": entry["model_id"],
            "workload": entry["workload"], "config": entry["config"]}, step


def _entry(meta: dict, ckpt_dir, model_id: Optional[str]) -> dict:
    ids = [m["model_id"] for m in meta["models"]]
    if model_id is None:
        if len(ids) != 1:
            raise ValueError(f"serving bundle under {ckpt_dir} carries {len(ids)} "
                             f"models {ids}; name one with model_id=")
        model_id = ids[0]
    if model_id not in ids:
        raise ValueError(f"serving bundle under {ckpt_dir} has no model "
                         f"{model_id!r} (entries: {ids})")
    return meta["models"][ids.index(model_id)]


def restore_serving_model(ckpt_dir, like_tree, model_id: str, step: Optional[int] = None):
    """Restore one named model into the structure, dtypes and devices of
    ``like_tree`` -> ``(tree, step)``: a v2 bundle's leaves under the
    model id, an upgraded v1 bundle's flat leaves."""
    meta, _ = load_serving_manifest(ckpt_dir)
    _entry(meta, ckpt_dir, model_id)
    sdir = Path(ckpt_dir) / _SERVING_SUBDIR
    if meta.get("upgraded_from") == SERVING_SCHEMA_V1:
        return restore_checkpoint(sdir, like_tree, step=step)
    tree, got = restore_checkpoint(sdir, {model_id: like_tree}, step=step)
    return tree[model_id], got


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
    return save_serving_registry(ckpt_dir, step, {model_id: (params, workload, cfg)})


def save_serving_registry(ckpt_dir, step: int, models: dict,
                          serving_hints: Optional[dict] = None) -> Path:
    """Write N named models as one v2 bundle: ``models`` is ``{model_id:
    (params, workload, cfg)}``; ``serving_hints`` an optional ``{model_id:
    dict}`` of JSON-safe hints stored as each entry's ``"serving"`` key (the
    scheduler reads ``quota`` from it)."""
    if not models:
        raise ValueError("a serving bundle needs at least one model entry")
    hints = serving_hints or {}
    unknown = sorted(set(hints) - set(models))
    if unknown:
        raise ValueError(f"serving_hints name model ids {unknown} that are not in "
                         f"the bundle ({sorted(models)})")
    meta = {"schema": SERVING_SCHEMA,
            "models": [{"model_id": mid, "workload": workload, "config": config_to_meta(cfg),
                        **({"serving": hints[mid]} if mid in hints else {})}
                       for mid, (_, workload, cfg) in models.items()]}
    tree = {mid: params for mid, (params, _, _) in models.items()}
    return save_checkpoint(Path(ckpt_dir) / _SERVING_SUBDIR, step, tree, meta=meta)


def save_serving_bundle_v1(ckpt_dir, step: int, params, workload: str, cfg) -> Path:
    """Write an older single-workload v1 bundle (one flat params tree): the
    fixture the v1 → v2 upgrade is tested on."""
    meta = {"schema": SERVING_SCHEMA_V1, "workload": workload, "config": config_to_meta(cfg)}
    return save_checkpoint(Path(ckpt_dir) / _SERVING_SUBDIR, step, params, meta=meta)


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
