"""Checkpointing: atomic, verifiable TrainState snapshots (.npz + manifest);
port of ``repro/train/checkpoint.py``.

The files are the reference's, name for name and byte for byte in layout:
``ckpt_{step:08d}.npz`` holds one array per leaf under ``a{i:06d}``, and
``ckpt_{step:08d}.json`` is the manifest.  A checkpoint written by either
package validates and restores in the other (``tests/test_torch_faults.py``
holds both directions).

Crash-safety contract (the fault-tolerant runtime, ``train/trainer.py``,
leans on it):

* **Atomic writes.**  The ``.npz`` payload and then the ``.json`` manifest
  are each written to a temp file in the same directory, fsync'd and
  renamed over the final name (rename is atomic on POSIX).  The manifest's
  presence is the commit marker: a crash at any byte leaves the previous
  checkpoint set intact or a stray ``*.tmp`` that the next save sweeps up,
  never a half-written file under a final name.
* **Verifiable payloads.**  The manifest records per leaf ``names``,
  ``shapes``, ``dtypes`` and ``checksums`` (crc32 of the array's bytes),
  plus the step, a caller-supplied ``extra`` dict (data-loader cursor,
  seed, loss-scale scalars, config fingerprint) and ``format: 2``.
  ``validate_checkpoint`` re-derives all of it from the ``.npz``.
* **Fallback restore.**  ``latest_step`` returns the newest *valid* step;
  ``restore_checkpoint`` walks checkpoints newest to oldest, warning about
  and skipping any that fail validation, and raises ``FileNotFoundError``
  only when no valid checkpoint exists, so "nothing to resume" (start
  fresh) and "latest is torn" (fall back) stay apart.  It validates each
  checkpoint when it reaches it, as ``latest_step`` does, where the
  reference validates every one up front: the same checkpoint is restored,
  and at full width one validation reads 4 GB.

Manifest schema (``ckpt_{step:08d}.json``)::

    {"format": 2, "step": int, "names": [leaf path per leaf],
     "shapes": [[dims] per leaf], "dtypes": [str per leaf],
     "checksums": [crc32 of leaf bytes], "extra": {...}}

Format-1 manifests (just ``{"step", "names"}``) still restore; they
validate by loadability alone.

Trees.  The port has no pytree library.  A tree is an object with
``checkpoint_leaves()`` -- ``(name, numpy array)`` pairs in the
reference's leaf order, as ``TrainState`` gives them -- or nested dicts
(walked in sorted key order), lists, tuples and named tuples whose leaves
are numpy arrays, tensors or scalars, named as ``jax.tree_util`` names
them (``"opt/master/blocks/attn/wq"``; ``None`` holds no leaf).
``restore_checkpoint`` loads into an object with
``load_checkpoint_leaves`` in place (a ``TrainState``'s tensors stay on
its device; the data goes through host numpy) and returns a new tree of
``like``'s structure otherwise.  Each save and restore logs its bytes and
seconds.
"""
from __future__ import annotations

import json
import logging
import os
import re
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("repro_torch.train")


def _fsync_replace(tmp: Path, final: Path) -> None:
    """fsync ``tmp`` then atomically rename it over ``final``."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, final)


def _fsync_dir(d: Path) -> None:
    """Best-effort directory fsync so the renames themselves are durable."""
    try:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # not supported on every platform/filesystem
        pass


def _npz_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"ckpt_{step:08d}.npz"


def _manifest_path(ckpt_dir, step: int) -> Path:
    return Path(ckpt_dir) / f"ckpt_{step:08d}.json"


def _crc32(a: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (``tobytes()``'s, uncopied)."""
    return zlib.crc32(np.ascontiguousarray(a))


def _walk(tree, prefix: Tuple[str, ...]):
    """(name, leaf) pairs of a tree in ``jax.tree_util``'s order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _walk(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _named_arrays(tree) -> List[Tuple[str, np.ndarray]]:
    if hasattr(tree, "checkpoint_leaves"):
        return list(tree.checkpoint_leaves())
    return [(name, _to_numpy(leaf)) for name, leaf in _walk(tree, ())]


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    keep: int = 3, extra: Optional[Dict] = None) -> Path:
    """Atomically write ``tree`` as checkpoint ``step``; returns the npz
    path.  ``extra``: any JSON-serializable dict, stored in the manifest
    and returned by ``load_manifest`` (the trainer's exact resume reads the
    data cursor from it)."""
    t0 = time.perf_counter()
    out = Path(ckpt_dir)
    out.mkdir(parents=True, exist_ok=True)
    named = _named_arrays(tree)
    arrays = {f"a{i:06d}": a for i, (_, a) in enumerate(named)}
    manifest = {
        "format": 2,
        "step": int(step),
        "names": [name for name, _ in named],
        "shapes": [list(a.shape) for _, a in named],
        "dtypes": [str(a.dtype) for _, a in named],
        "checksums": [_crc32(a) for _, a in named],
        "extra": extra or {},
    }
    npz, man = _npz_path(out, step), _manifest_path(out, step)
    tmp_npz = npz.with_suffix(".npz.tmp")
    tmp_man = man.with_suffix(".json.tmp")
    with open(tmp_npz, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_npz, npz)
    # manifest second: its presence commits the checkpoint
    with open(tmp_man, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_man, man)
    _fsync_dir(out)
    _retain(out, keep)
    logger.info("checkpoint step %d saved in %s: %d bytes in %.3f s", step,
                ckpt_dir, npz.stat().st_size, time.perf_counter() - t0)
    return npz


def _retain(out: Path, keep: int) -> None:
    """Keep the newest ``keep`` committed checkpoints; sweep stray tmps."""
    for stray in out.glob("*.tmp"):
        stray.unlink(missing_ok=True)
    steps = sorted(_all_steps(out))
    for s in steps[:-keep] if keep > 0 else []:
        _npz_path(out, s).unlink(missing_ok=True)
        _manifest_path(out, s).unlink(missing_ok=True)


def _all_steps(ckpt_dir) -> List[int]:
    steps = set()
    for p in Path(ckpt_dir).glob("ckpt_*.npz"):
        m = re.match(r"ckpt_(\d+)\.npz$", p.name)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)


def load_manifest(ckpt_dir: str, step: int) -> Optional[Dict]:
    """Parse the manifest for ``step`` (None if missing/unparseable)."""
    man = _manifest_path(ckpt_dir, step)
    try:
        return json.loads(man.read_text())
    except (OSError, json.JSONDecodeError):
        return None


def validate_checkpoint(ckpt_dir: str, step: int) -> bool:
    """True iff checkpoint ``step`` is complete and uncorrupted.

    Format 2: the manifest parses, the npz holds every named array, and
    each array's shape, dtype and crc32 match the manifest.  Format 1 (no
    checksums): the npz merely has to hold the manifest's leaf count.
    """
    manifest = load_manifest(ckpt_dir, step)
    if manifest is None or "names" not in manifest:
        return False
    npz = _npz_path(ckpt_dir, step)
    try:
        with np.load(npz) as z:
            n = len(manifest["names"])
            if manifest.get("format", 1) < 2:
                return all(f"a{i:06d}" in z.files for i in range(n))
            for i in range(n):
                a = z[f"a{i:06d}"]
                if list(a.shape) != manifest["shapes"][i]:
                    return False
                if str(a.dtype) != manifest["dtypes"][i]:
                    return False
                if _crc32(a) != manifest["checksums"][i]:
                    return False
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile, zlib.error):
        return False
    return True


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose checkpoint validates (torn/truncated ones are
    skipped with a warning -- the fallback the trainer's resume relies on)."""
    for step in reversed(_all_steps(ckpt_dir)):
        if validate_checkpoint(ckpt_dir, step):
            return step
        logger.warning(
            "checkpoint step %d in %s failed validation (torn/truncated "
            "write?): falling back to the previous checkpoint", step,
            ckpt_dir)
    return None


def _as_like(a: np.ndarray, like):
    """``a`` in the kind and dtype of the leaf ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(a, dtype=like.dtype)
    return type(like)(a)


def _rebuild(tree, leaves):
    """A tree of ``tree``'s structure whose leaves come from ``leaves`` (an
    iterator in ``_walk`` order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _load_into(like, names: List[str], arrays: List[np.ndarray]):
    """``like`` restored from the checkpoint's leaves: in place through
    ``load_checkpoint_leaves``, or a new tree of its structure (leaf count
    and shapes checked, as the reference checks them)."""
    if hasattr(like, "load_checkpoint_leaves"):
        like.load_checkpoint_leaves(list(zip(names, arrays)))
        return like
    flat = [leaf for _, leaf in _walk(like, ())]
    if len(names) != len(flat):
        raise ValueError(f"checkpoint has {len(names)} leaves, expected "
                         f"{len(flat)} (structure mismatch)")
    for name, got, want in zip(names, arrays, flat):
        if got.shape != tuple(np.shape(want)):
            raise ValueError(f"leaf {name}: shape {got.shape} != expected "
                             f"{tuple(np.shape(want))}")
    return _rebuild(like, iter(_as_like(a, w) for a, w in zip(arrays, flat)))


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (names, shapes and, for a
    ``TrainState``, dtypes checked before anything is written).

    With ``step=None`` walks checkpoints newest to oldest, skipping invalid
    ones loudly; raises ``FileNotFoundError`` when no valid checkpoint
    exists (callers treat that as "start fresh").  An explicit ``step``
    must validate or a ``ValueError`` is raised.  Returns (tree, step); a
    tree with ``load_checkpoint_leaves`` is ``like`` itself, updated.
    """
    if step is not None:
        if not validate_checkpoint(ckpt_dir, step):
            raise ValueError(
                f"checkpoint step {step} in {ckpt_dir} is missing or "
                "corrupt")
        candidates = [step]
    else:
        candidates = list(reversed(_all_steps(ckpt_dir)))
    last_err: Optional[Exception] = None
    for s in candidates:
        t0 = time.perf_counter()
        if step is None and not validate_checkpoint(ckpt_dir, s):
            logger.warning(
                "skipping corrupt checkpoint step %d in %s", s, ckpt_dir)
            continue
        try:
            names = (load_manifest(ckpt_dir, s) or {})["names"]
            with np.load(_npz_path(ckpt_dir, s)) as z:
                arrays = [z[f"a{i:06d}"] for i in range(len(names))]
            tree = _load_into(like, names, arrays)
            logger.info("checkpoint step %d restored from %s: %d bytes in "
                        "%.3f s (validation included)", s, ckpt_dir,
                        _npz_path(ckpt_dir, s).stat().st_size,
                        time.perf_counter() - t0)
            return tree, s
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            last_err = e
            logger.warning("failed to restore checkpoint step %d in %s "
                           "(%s): trying the previous one", s, ckpt_dir, e)
    if last_err is not None:
        raise FileNotFoundError(
            f"no restorable checkpoint in {ckpt_dir} "
            f"(last error: {last_err})")
    raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
