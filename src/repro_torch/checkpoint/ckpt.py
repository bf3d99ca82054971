"""Atomic, durable checkpoints of trees of arrays.

The reference's ``checkpoint/ckpt.py`` on the same on-disk layout, so a
directory written by either package is read by the other's ``restore``
(and, for flat dicts, ``restore_auto``; one step per directory):

    <dir>/step_000042.tmp/...      (written first)
    <dir>/step_000042/             (atomic rename on completion)
        manifest.json              (leaf paths, shapes, dtypes, step)
        arr_00000.npy ...          (one file per leaf, in tree order)

* A checkpoint is a tree of dicts, lists, tuples and ``NamedTuple``s whose
  leaves are tensors or arrays, in the order of ``jax.tree.leaves`` (dict
  keys sorted; a ``None`` holds no leaf). Leaf paths are the reference's
  ``jax.tree_util.keystr``: ``['params']['slots'][0]['mixer']['wq']``,
  ``['opt'].step``, ``['opt'].mu['embed']['e']``; a flat dict's are
  ``['name']``.
* bfloat16 leaves are written as the reference writes them: ``np.save``
  of an ``ml_dtypes`` bfloat16 array, the descriptor ``<V2`` over the raw
  bits and the manifest dtype ``"bfloat16"``; they restore as
  ``torch.bfloat16`` (NumPy has no bfloat16 of its own).
* Atomicity: a crash mid-save leaves only a ``.tmp`` directory, which
  restore ignores and the next save overwrites — a restart can never see a
  torn checkpoint.
* Durability: leaf files and manifests are fsynced before the rename and
  the parent directory after it, so a published step (or pointer flip)
  survives power loss, not just SIGKILL — see ``fsync_dir``.
* Placement: each restored leaf goes to the device ``device_tree`` names
  (one device for every leaf, or a dict of flat leaf name -> device), else
  to the device of its ``like`` leaf where that is a tensor, else to the
  host (``.to(device)``, where the reference re-places with
  ``jax.device_put``).
* Worlds of ranks (elastic): over a world each rank passes ``save`` its
  own tree and, per leaf, the block it holds (``blocks``: the experts of
  an MoE, and under tensor parallelism the heads, FFN columns and vocab
  rows, ``models.model.param_blocks``); the directory is the one a
  single process writes of the whole tree, byte for byte. ``restore``
  reads a rank's blocks from the mapped files (the reference's
  ``sharding_tree``), at any world size that divides the blocked axis.
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

import io
import json
import os
import pathlib
import re
import shutil

import numpy as np
import torch

from ..core.mesh import check_mesh

__all__ = ["save", "restore", "restore_auto", "latest_step", "write_json",
           "read_json", "prune", "fsync_dir"]

_BF16 = "bfloat16"
_KEY_RE = re.compile(r"\['([^']*)'\]")


def _host(leaf):
    """(array to write, manifest dtype) of a leaf. A bfloat16 tensor gives
    its raw bits as uint16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _shape(leaf):
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves_with_paths(tree, path=""):
    """(keystr path, leaf) pairs in the order of ``jax.tree.leaves``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _leaves_with_paths(tree[k], f"{path}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pl for f in tree._fields
                for pl in _leaves_with_paths(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in _leaves_with_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _write_leaf(f, arr, dtype):
    if dtype == _BF16:
        # np.save of an ml_dtypes bfloat16 array, header and bytes
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())
    else:
        np.save(f, arr)


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


def _manifest_dtype(leaf) -> str:
    """The manifest dtype of a leaf, without copying it to the host."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _header(f, shape, dtype: str) -> int:
    """Write the header ``np.save`` writes for an array of ``shape`` and
    manifest dtype ``dtype``; returns its length (the data's offset)."""
    descr = "<V2" if dtype == _BF16 else np.lib.format.dtype_to_descr(np.dtype(dtype))
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})
    return f.tell()


def _whole_shape(leaf, block):
    shape = list(_shape(leaf))
    if block is not None:
        shape[block[0]] *= block[2]
    return shape


def _write_block(fpath, leaf, block):
    """Write ``leaf``, block ``(axis, rank, size)`` of a whole leaf, into the
    ``.npy`` file rank 0 sized for the whole leaf, and fsync it."""
    arr, dtype = _host(leaf)
    shape = _whole_shape(leaf, block)
    axis, r, _ = block
    n = arr.shape[axis]
    mm = np.memmap(fpath, dtype=arr.dtype, mode="r+", shape=tuple(shape),
                   offset=_header(io.BytesIO(), shape, dtype))
    mm[(slice(None),) * axis + (slice(r * n, (r + 1) * n),)] = arr
    mm.flush()
    del mm
    with open(fpath, "rb") as f:
        os.fsync(f.fileno())


def save(directory, step: int, tree, mesh=None, blocks=None) -> str:
    """Atomically AND durably write ``tree`` as checkpoint ``step``.

    Every leaf file and the manifest are fsynced before the directory
    rename, and the parent directory is fsynced after it — without the
    first, the rename can land while the data blocks are still only in
    the page cache; without the second, the rename itself can be undone.
    Returns the final path.

    Over a world of ranks (``mesh``, a ``core.mesh.Mesh``), every rank calls
    ``save`` with its own tree: ``blocks`` gives, for each leaf in tree
    order, None where the rank holds the leaf whole (the same on every
    rank) or ``(axis, rank, size)`` where it holds the ``rank``-th of
    ``size`` equal blocks along ``axis`` (``models.model.param_blocks``).
    The directory is the one a single process writes of the whole tree,
    byte for byte: rank 0 writes the whole leaves and each cut leaf's
    header, its file sized for the whole leaf; after a barrier every rank
    writes its blocks into those files and fsyncs them; after another,
    rank 0 writes the manifest and renames, and a last barrier returns
    every rank. A rank that dies before the rename leaves only ``.tmp``.
    """
    mesh = check_mesh(mesh)
    d = pathlib.Path(directory)
    final = d / f"step_{step:08d}"
    tmp = d / f"step_{step:08d}.tmp"
    leaves = _leaves_with_paths(tree)
    blocks = [None] * len(leaves) if blocks is None else list(blocks)
    if len(blocks) != len(leaves):
        raise ValueError(f"{len(blocks)} blocks for {len(leaves)} leaves")
    lead = mesh is None or mesh.rank == 0
    files = [tmp / f"arr_{i:05d}.npy" for i in range(len(leaves))]
    manifest = {"step": step, "leaves": []}
    if lead:
        d.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        for (path, leaf), block, fpath in zip(leaves, blocks, files):
            shape, dtype = _whole_shape(leaf, block), _manifest_dtype(leaf)
            with open(fpath, "wb") as f:
                if block is None:
                    _write_leaf(f, *_host(leaf))
                else:
                    f.truncate(_header(f, shape, dtype)
                               + leaf.element_size() * leaf.numel() * block[2])
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({"path": path, "file": fpath.name,
                                       "shape": shape, "dtype": dtype})
    if mesh is not None:
        mesh.barrier()                        # every file and header written
    for (_, leaf), block, fpath in zip(leaves, blocks, files):
        if block is not None:
            _write_block(fpath, leaf, block)
    if mesh is not None:
        mesh.barrier()                        # every block written and fsynced
        if not lead:
            mesh.barrier()                    # rank 0 published the step
            return str(final)
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(tmp)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    fsync_dir(d)
    if mesh is not None:
        mesh.barrier()
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


def _load_leaf(step_dir: pathlib.Path, meta: dict, mmap: bool = False) -> np.ndarray:
    """Load one manifest-named leaf array (mapped, not read, with
    ``mmap``), failing actionably on damage."""
    fpath = step_dir / meta["file"]
    if not fpath.exists():
        raise ValueError(
            f"checkpoint {step_dir} is missing leaf file {meta['file']} "
            f"(tree path {meta['path']}, shape {meta['shape']}): the "
            f"manifest exists but the step is incomplete — delete "
            f"{step_dir} to discard it")
    try:
        return np.load(fpath, mmap_mode="r" if mmap else None)
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


def _place(arr, meta, device):
    if meta["dtype"] == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def _device_of(path, leaf, device_tree):
    if isinstance(device_tree, (str, torch.device)):
        return device_tree
    if device_tree is not None:
        keys = _KEY_RE.findall(path)
        return device_tree.get(keys[0]) if len(keys) == 1 else None
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return None


def restore(directory, step: int, like, device_tree=None, blocks=None):
    """Restore into the structure and shapes of ``like`` (a tree of arrays
    or tensors, on any device, ``meta`` included). ``device_tree``: one
    device for every leaf, or a dict of flat leaf name -> device; else a
    leaf goes to its ``like`` leaf's device, or to the host.

    ``blocks`` (the counterpart of the reference's ``sharding_tree``): for
    each leaf in tree order, None for the whole leaf, or ``(axis, rank,
    size)`` for the ``rank``-th of ``size`` equal blocks along ``axis``, the
    shape of its ``like`` leaf (``models.model.param_blocks``). A block
    is read from the mapped file, so a rank never holds the whole leaf; a
    state saved over a world of D ranks (or by one process) restores at any
    size that divides the axis. Restore makes no collective."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = _read_manifest(d)
    flat_like = _leaves_with_paths(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint {d} has {len(manifest['leaves'])} "
                         f"leaves, expected {len(flat_like)}")
    blocks = [None] * len(flat_like) if blocks is None else list(blocks)
    if len(blocks) != len(flat_like):
        raise ValueError(f"{len(blocks)} blocks for {len(flat_like)} leaves")
    out = []
    for (path, leaf), meta, block in zip(flat_like, manifest["leaves"], blocks):
        if path != meta["path"]:
            raise ValueError(f"tree mismatch: {path} vs {meta['path']}")
        arr = _load_leaf(d, meta, mmap=block is not None)
        if block is not None:
            axis, r, size = block
            if arr.shape[axis] % size:
                raise ValueError(f"{path}: its {arr.shape[axis]} entries along axis "
                                 f"{axis} do not split into {size} equal blocks")
        want = tuple(_whole_shape(leaf, block))
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: shape {arr.shape} on disk, expected {want}")
        if block is not None:
            n = arr.shape[axis] // size
            arr = np.array(arr[(slice(None),) * axis + (slice(r * n, (r + 1) * n),)])
        out.append(_place(arr, meta, _device_of(path, leaf, device_tree)))
    return _unflatten(like, iter(out))


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
        out[keys[0]] = _place(_load_leaf(d, meta), meta,
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
