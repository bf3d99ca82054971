"""Atomic, durable checkpoints of flat dicts of arrays.

The reference's ``checkpoint/ckpt.py`` on the same on-disk layout, so a
directory written by either package is read by the other's
:func:`restore_auto` (one step per directory):

    <dir>/step_000042.tmp/...      (written first)
    <dir>/step_000042/             (atomic rename on completion)
        manifest.json              (leaf paths, shapes, dtypes, step)
        arr_00000.npy ...          (one file per leaf, in sorted key order)

* A checkpoint is a flat ``dict[str, ndarray | Tensor]``. Leaf paths are
  the ``['name']`` strings the reference's pytree paths give a flat dict,
  and leaves are written in sorted key order, as the reference flattens
  one.
* Atomicity: a crash mid-save leaves only a ``.tmp`` directory, which
  restore ignores and the next save overwrites — a restart can never see a
  torn checkpoint.
* Durability: leaf files and manifests are fsynced before the rename and
  the parent directory after it, so a published step (or pointer flip)
  survives power loss, not just SIGKILL — see ``fsync_dir``.
* Placement: restored leaves come back as tensors on the host, or on the
  device a ``device_tree`` names for them (``.to(device)``, where the
  reference re-places with ``jax.device_put``).
* Corruption is loud: a step directory whose manifest exists but cannot be
  parsed, or whose manifest names a leaf file that is missing or
  unreadable, raises an actionable ``ValueError`` naming the offending
  path — never a silent fresh start. Only stray ``.tmp`` directories —
  the expected residue of a killed save — are skipped.
* Pointer flips: ``write_json`` / ``read_json`` are the small atomic
  documents higher layers publish through, flipped with the same
  ``os.replace`` so a reader never observes a half-written document.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil

import numpy as np
import torch

__all__ = ["save", "restore", "restore_auto", "latest_step", "write_json",
           "read_json", "prune", "fsync_dir"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flat(tree: dict):
    """(path string, leaf) pairs of a flat string-keyed dict, in sorted key
    order."""
    if not isinstance(tree, dict) or not all(isinstance(k, str) for k in tree):
        raise TypeError("a checkpoint is a flat dict of arrays keyed by str")
    return [(f"['{k}']", tree[k]) for k in sorted(tree)]


def fsync_dir(path) -> None:
    """fsync a directory so its entries (renames, creations) are durable.

    ``os.replace`` gives *atomicity* (a reader sees old or new, never a
    tear) but not *durability*: after a power loss the rename itself can
    be rolled back unless the parent directory's metadata was synced.
    Platforms whose directory handles reject fsync are skipped — the
    write stays atomic there, just not power-loss-durable.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(directory, step: int, tree: dict) -> str:
    """Atomically AND durably write ``tree`` as checkpoint ``step``.

    Every leaf file and the manifest are fsynced before the directory
    rename, and the parent directory is fsynced after it — without the
    first, the rename can land while the data blocks are still only in
    the page cache; without the second, the rename itself can be undone.
    Returns the final path.
    """
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    final = d / f"step_{step:08d}"
    tmp = d / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flat(tree)):
        arr = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        with open(tmp / fname, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({
            "path": path,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
        })
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    fsync_dir(d)
    return str(final)


def _read_manifest(step_dir: pathlib.Path) -> dict:
    """Parse a step directory's manifest, failing actionably on damage."""
    mpath = step_dir / "manifest.json"
    if not mpath.exists():
        raise ValueError(
            f"checkpoint step directory {step_dir} has no manifest.json — "
            "it is not a checkpoint this layer wrote (the atomic rename "
            "publishes the manifest with the step); remove the directory "
            "if it is debris")
    try:
        with open(mpath) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"checkpoint manifest {mpath} is corrupt (truncated or "
            f"overwritten: {e}); the atomic save protocol cannot produce "
            "this state, so the directory was damaged after the fact — "
            f"delete {step_dir} to discard the step (an older step, if "
            "any, will be restored instead)") from e


def _load_leaf(step_dir: pathlib.Path, meta: dict) -> np.ndarray:
    """Load one manifest-named leaf array, failing actionably on damage."""
    fpath = step_dir / meta["file"]
    if not fpath.exists():
        raise ValueError(
            f"checkpoint {step_dir} is missing leaf file {meta['file']} "
            f"(tree path {meta['path']}, shape {meta['shape']}): the "
            f"manifest exists but the step is incomplete — delete "
            f"{step_dir} to discard it")
    try:
        return np.load(fpath)
    except Exception as e:
        raise ValueError(
            f"checkpoint leaf {fpath} (tree path {meta['path']}) is "
            f"unreadable: {e} — delete {step_dir} to discard the "
            "corrupt step") from e


def latest_step(directory):
    """Newest complete step in ``directory``; None when there is none.

    A step counts as soon as its ``manifest.json`` EXISTS — parseability
    is restore's concern, and a damaged-but-present manifest must surface
    as restore's actionable error, not be silently skipped here (a resume
    loop that fell back to "no checkpoint" would quietly discard the run).
    ``.tmp`` directories (killed saves) and directories without a
    manifest are not steps and are ignored.
    """
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [
        int(m.group(1))
        for p in d.iterdir()
        if (m := re.fullmatch(r"step_(\d+)", p.name)) and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _place(arr, device):
    t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def restore(directory, step: int, like: dict, device_tree=None) -> dict:
    """Restore into the keys and shapes of ``like`` (a flat dict of arrays
    or tensors). ``device_tree``: optional dict of leaf name -> device;
    the other leaves stay on the host."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = _read_manifest(d)
    flat_like = _flat(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d} has {len(manifest['leaves'])} "
                         f"leaves, expected {len(flat_like)}")
    out = {}
    for (path, leaf), meta in zip(flat_like, manifest["leaves"]):
        if path != meta["path"]:
            raise ValueError(f"tree mismatch: {path} vs {meta['path']}")
        arr = _load_leaf(d, meta)
        if list(arr.shape) != list(_host(leaf).shape):
            raise ValueError(f"{path}: shape {arr.shape} on disk, "
                             f"expected {tuple(_host(leaf).shape)}")
        name = path[2:-2]
        out[name] = _place(arr, (device_tree or {}).get(name))
    return out


_KEY_RE = re.compile(r"\['([^']*)'\]")


def restore_auto(directory, step: int, device_tree=None) -> dict:
    """Restore a flat-dict checkpoint from its manifest alone (no ``like``).

    The entry point of a *resuming* process whose saved structure is part
    of what it must recover — the streaming resume state
    (core/prefetch.py) stores the virtual-slot count as the leading axis
    of its accumulator arrays. Only leaf paths of the form ``['name']``
    are supported. ``device_tree``: optional dict of leaf name -> device;
    the other leaves come back as host tensors.
    """
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = _read_manifest(d)
    out = {}
    for meta in manifest["leaves"]:
        keys = _KEY_RE.findall(meta["path"])
        if len(keys) != 1 or f"['{keys[0]}']" != meta["path"]:
            raise ValueError(
                "restore_auto supports flat dict checkpoints only, "
                f"got leaf path {meta['path']!r}")
        out[keys[0]] = _place(_load_leaf(d, meta),
                              (device_tree or {}).get(keys[0]))
    return out


def write_json(directory, name: str, payload: dict) -> str:
    """Atomically publish a small JSON document at ``<directory>/<name>``.

    The document is written to ``<name>.tmp`` and renamed into place with
    ``os.replace``, so a concurrent or subsequent :func:`read_json` sees
    either the previous complete document or the new complete document —
    never a torn write. Returns the final path.
    """
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f"{name}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    final = d / name
    os.replace(tmp, final)
    fsync_dir(d)
    return str(final)


def read_json(directory, name: str):
    """Read a :func:`write_json` document; None when it was never written.

    A *present but unparseable* document raises an actionable
    ``ValueError`` (the atomic flip cannot produce one, so it means
    external damage) — the same no-silent-fresh-start contract as
    :func:`latest_step` / :func:`restore_auto`.
    """
    path = pathlib.Path(directory) / name
    if not path.exists():
        return None
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise ValueError(
            f"pointer document {path} is corrupt ({e}); write_json flips "
            "it atomically, so this state means external damage — delete "
            "the file to discard the pointer") from e


def prune(directory, keep: int = 3):
    """Drop all but the newest ``keep`` checkpoints (and stray .tmp dirs)."""
    d = pathlib.Path(directory)
    if not d.exists():
        return
    for p in d.glob("*.tmp"):
        shutil.rmtree(p)
    steps = sorted(
        int(m.group(1))
        for p in d.iterdir()
        if (m := re.fullmatch(r"step_(\d+)", p.name))
    )
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(d / f"step_{s:08d}")
