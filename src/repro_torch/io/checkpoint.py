"""Tree checkpointing to an ``.npz`` + JSON manifest with CRC32 footers
(port of the reference ``io/checkpoint.py``; its on-disk format, so either
package reads a checkpoint the other wrote).

Layout of a checkpoint directory:

  * ``weights.npz``   — one array per leaf, keyed by the leaf's tree path
                        joined with ``/`` (dict keys sorted, list and tuple
                        indices as integers: ``jax.tree_util.
                        tree_flatten_with_path``'s strings for the same
                        nesting); bfloat16 leaves are stored as their
                        uint16 bits;
  * ``manifest.json`` — ``step``, ``tensors`` (shape and dtype name of each
                        key), ``integrity`` (CRC32 and byte length of
                        ``weights.npz``) and ``manifest_crc32``, the CRC32
                        of the manifest's ``indent=1, sort_keys=True``
                        serialisation without that field.

``restore`` / ``latest_step`` verify the footers first: a bit-flipped,
truncated or missing member surfaces as :class:`CheckpointCorrupt` naming
the damaged file, never as a failure deep in numpy.  Leaves are torch
tensors (numpy arrays and Python scalars are accepted on save); they are
restored as CPU tensors, or onto the device of the matching leaf of
``like_tree``.

A model trained under FSDP (``parallel/fsdp.py``) checkpoints the whole
tree: ``models.transformer.to_reference_params(params, fsdp=...)``
gathers the shards (every rank calls it) and rank 0 writes, so the file
is byte for byte a one-process run's of the same parameters; it restores
into shards through ``load_reference_params(..., fsdp=...)``.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

# torch dtype -> the reference's dtype name (``str(jax_array.dtype)``)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
          torch.uint8: "uint8", torch.int16: "int16", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed integrity verification.

    ``path`` is the checkpoint directory, ``file`` the damaged member,
    ``reason`` what failed (``missing`` / ``truncated`` / ``checksum`` /
    ``no_integrity``).
    """

    def __init__(self, path: str, file: str, reason: str, detail: str = ""):
        self.path = path
        self.file = file
        self.reason = reason
        super().__init__(
            f"corrupt checkpoint {path!r}: {file} — {reason}"
            + (f" ({detail})" if detail else ""))


def _crc(path: str) -> tuple:
    """(crc32, n_bytes) of a file, streamed."""
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return crc & 0xFFFFFFFF, n


def _walk(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _walk(x, prefix + (str(i),), out)
    else:
        out["/".join(prefix)] = tree


def flatten(tree) -> dict:
    """``{path: leaf}`` in the reference's key order and spelling."""
    out: dict = {}
    _walk(tree, (), out)
    return out


def _fill(tree, prefix, by_key):
    if isinstance(tree, dict):
        return {k: _fill(tree[k], prefix + (str(k),), by_key)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(x, prefix + (str(i),), by_key)
                          for i, x in enumerate(tree))
    return by_key["/".join(prefix)]


def _to_numpy(leaf):
    """(array as stored, dtype name) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    t = leaf.detach().cpu().contiguous()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:            # npz has no bf16: store bits
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def save(path: str, tree, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    arrays, dtypes = {}, {}
    for k, leaf in flatten(tree).items():
        arrays[k], dtypes[k] = _to_numpy(leaf)
    np.savez(os.path.join(path, "weights.npz"), **arrays)
    crc, n = _crc(os.path.join(path, "weights.npz"))
    manifest = {
        "step": step,
        "tensors": {k: {"shape": list(arrays[k].shape), "dtype": dtypes[k]}
                    for k in arrays},
        "integrity": {"weights.npz": {"crc32": crc, "bytes": n}},
    }
    # the manifest checks itself: its payload checksum is computed over the
    # serialization WITHOUT the manifest_crc32 field, then appended
    body = json.dumps(manifest, indent=1, sort_keys=True)
    manifest["manifest_crc32"] = zlib.crc32(body.encode()) & 0xFFFFFFFF
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def verify(path: str) -> dict:
    """Integrity-check a checkpoint directory and return its (trusted)
    manifest; raises :class:`CheckpointCorrupt` naming the damaged file.
    Checkpoints without footers fail closed with reason
    ``no_integrity``."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorrupt(path, "manifest.json", "missing")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise CheckpointCorrupt(path, "manifest.json", "truncated",
                                str(e)) from e
    stored = manifest.pop("manifest_crc32", None)
    if stored is None or "integrity" not in manifest:
        raise CheckpointCorrupt(path, "manifest.json", "no_integrity",
                                "checkpoint predates integrity footers")
    body = json.dumps(manifest, indent=1, sort_keys=True)
    got = zlib.crc32(body.encode()) & 0xFFFFFFFF
    if got != stored:
        raise CheckpointCorrupt(path, "manifest.json", "checksum",
                                f"stored {stored:#010x} != {got:#010x}")
    for fname, foot in manifest["integrity"].items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath):
            raise CheckpointCorrupt(path, fname, "missing")
        crc, n = _crc(fpath)
        if n != foot["bytes"]:
            raise CheckpointCorrupt(
                path, fname, "truncated",
                f"{n} bytes on disk, footer says {foot['bytes']}")
        if crc != foot["crc32"]:
            raise CheckpointCorrupt(
                path, fname, "checksum",
                f"stored {foot['crc32']:#010x} != {crc:#010x}")
    return manifest


def restore(path: str, like_tree):
    """Restore into the structure of ``like_tree``, each leaf on the device
    of the matching leaf there (CPU for non-tensor leaves).  Verifies the
    integrity footers first — raises :class:`CheckpointCorrupt` instead of
    feeding damaged bytes to the deserializer."""
    manifest = verify(path)
    by_key = {}
    with np.load(os.path.join(path, "weights.npz")) as data:
        for key, like in flatten(like_tree).items():
            arr = data[key]
            dt = _DTYPES[manifest["tensors"][key]["dtype"]]
            if dt == torch.bfloat16:
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            dev = like.device if isinstance(like, torch.Tensor) else "cpu"
            by_key[key] = t.to(dev)
    return _fill(like_tree, (), by_key)


def latest_step(path: str) -> int:
    return verify(path)["step"]
