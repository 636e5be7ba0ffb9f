"""The port's checkpoints (``repro_torch.io.checkpoint``) against the
reference's format and integrity checks.

The six integrity cases are the reference's (``tests/
test_checkpoint_integrity.py``): an intact checkpoint round-trips exactly,
and a bit flip, a truncation, a missing member, a tampered manifest or a
footerless manifest is refused with a structured ``CheckpointCorrupt``.
Across packages: for the same tree both packages write byte-identical
files, each restores what the other saved (bfloat16 included), and the
trainer's parameters go through ``to_reference_params`` into the
reference's layout.  The training CLI runs as a 2-rank ``gloo`` world on
the CPU with ``--ckpt-dir --ckpt-every 2``; rank 0 writes.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.io import checkpoint as ckpt
from repro_torch.io.checkpoint import CheckpointCorrupt


def _tree():
    return {"params": {"w": torch.arange(64, dtype=torch.float32).reshape(
        8, 8), "b": torch.ones((8,), dtype=torch.bfloat16)},
        "scale": torch.tensor(3.0)}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "scale": torch.zeros_like(tree["scale"])}


def _saved(tmp_path):
    path = os.path.join(str(tmp_path), "ckpt")
    tree = _tree()
    ckpt.save(path, tree, step=7)
    return path, tree


def _leaves(tree):
    return list(ckpt.flatten(tree).values())


def test_intact_checkpoint_round_trips(tmp_path):
    path, tree = _saved(tmp_path)
    assert ckpt.latest_step(path) == 7
    out = ckpt.restore(path, _zeros_like(tree))
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 1000, -1])
def test_bit_flip_is_detected(tmp_path, offset):
    path, tree = _saved(tmp_path)
    wpath = os.path.join(path, "weights.npz")
    blob = bytearray(open(wpath, "rb").read())
    blob[offset % len(blob)] ^= 0x01
    open(wpath, "wb").write(bytes(blob))
    with pytest.raises(CheckpointCorrupt) as ei:
        ckpt.restore(path, _zeros_like(tree))
    assert ei.value.file == "weights.npz"
    assert ei.value.reason == "checksum"


def test_truncation_is_detected(tmp_path):
    path, tree = _saved(tmp_path)
    wpath = os.path.join(path, "weights.npz")
    blob = open(wpath, "rb").read()
    open(wpath, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(CheckpointCorrupt) as ei:
        ckpt.restore(path, _zeros_like(tree))
    assert ei.value.reason == "truncated"


def test_missing_member_is_detected(tmp_path):
    path, tree = _saved(tmp_path)
    os.remove(os.path.join(path, "weights.npz"))
    with pytest.raises(CheckpointCorrupt) as ei:
        ckpt.restore(path, _zeros_like(tree))
    assert ei.value.reason == "missing" and ei.value.file == "weights.npz"


def test_tampered_manifest_is_detected(tmp_path):
    path, tree = _saved(tmp_path)
    mpath = os.path.join(path, "manifest.json")
    m = json.load(open(mpath))
    m["step"] = 9999
    json.dump(m, open(mpath, "w"), indent=1, sort_keys=True)
    with pytest.raises(CheckpointCorrupt) as ei:
        ckpt.latest_step(path)
    assert ei.value.file == "manifest.json"
    assert ei.value.reason == "checksum"


def test_footerless_checkpoint_fails_closed(tmp_path):
    path, tree = _saved(tmp_path)
    mpath = os.path.join(path, "manifest.json")
    m = json.load(open(mpath))
    del m["integrity"], m["manifest_crc32"]
    json.dump(m, open(mpath, "w"))
    with pytest.raises(CheckpointCorrupt) as ei:
        ckpt.restore(path, _zeros_like(tree))
    assert ei.value.reason == "no_integrity"


# ------------------------------------------------------------ cross-package

def _nested_numpy():
    """A tree with dict, list and tuple nesting and four dtypes, as numpy
    arrays (bfloat16 as float32 values exactly representable in it)."""
    rng = np.random.default_rng(0)
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    bf = torch.from_numpy(bf).bfloat16().float().numpy()
    return {"z": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                  "layers": [np.arange(6, dtype=np.int32).reshape(2, 3),
                             (bf, np.float32(2.5))]},
            "a": np.arange(5, dtype=np.int32)}, ("z/layers/1/0",)


def _as_torch(tree, bf16):
    flat = {k: torch.from_numpy(np.asarray(v)) for k, v in
            ckpt.flatten(tree).items()}
    for k in bf16:
        flat[k] = flat[k].bfloat16()
    return ckpt._fill(tree, (), flat)


def _as_jax(tree, bf16):
    import jax
    import jax.numpy as jnp
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, x in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        leaves.append(jnp.asarray(x, jnp.bfloat16 if key in bf16
                                  else None))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_both_packages_write_the_same_bytes_and_read_each_other(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.io import checkpoint as rck
    tree, bf16 = _nested_numpy()
    tt, jt = _as_torch(tree, bf16), _as_jax(tree, bf16)
    assert list(ckpt.flatten(tt)) == list(rck._flatten(jt)[0])
    pp, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(pp, tt, step=5)
    rck.save(rp, jt, step=5)
    for name in ("weights.npz", "manifest.json"):
        assert open(os.path.join(pp, name), "rb").read() == \
            open(os.path.join(rp, name), "rb").read(), name
    # the reference's checkpoint restored by the port, and the port's by
    # the reference (its verify first), leaf for leaf and dtype for dtype
    got = ckpt.restore(rp, tt)
    for (k, a), b in zip(ckpt.flatten(got).items(), _leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert rck.verify(pp)["step"] == 5 and rck.latest_step(pp) == 5
    back = rck.restore(pp, jax.tree.map(jnp.zeros_like, jt))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float64),
                                      np.asarray(b, np.float64))


def test_trainer_tree_is_the_reference_layout(tmp_path):
    """``to_reference_params`` inverts ``load_reference_params``: the
    reference's initial weights (bfloat16, llama-gqa's smoke shapes) go
    into the port's layout and back, and the port's checkpoint of them
    restores in the reference equal to the tree it started from."""
    import jax
    import jax.numpy as jnp
    from repro.core.config import ShapeSpec
    from repro.core.config import get_config as rget
    from repro.core.config import smoke_config as rsmoke
    from repro.io import checkpoint as rck
    from repro.models.transformer import Runtime, build_model
    from repro.parallel.sharding import make_parallel_config
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.models.transformer import (load_reference_params,
                                                to_reference_params)
    rcfg = rsmoke(rget("llama-gqa")).replace(dtype="bfloat16")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    par = make_parallel_config(mesh, ShapeSpec("c", 16, 1, "train"))
    ref = build_model(rcfg, Runtime(mesh=mesh, par=par, impl="ref")).init(
        jax.random.PRNGKey(0))
    cfg = smoke_config(get_config("llama-gqa")).replace(dtype="bfloat16")
    host = jax.tree.map(lambda x: np.asarray(x, np.float32), ref)
    params = load_reference_params(cfg, host, device="cpu")
    path = str(tmp_path / "params")
    ckpt.save(path, {"params": to_reference_params(params)}, step=3)
    back = rck.restore(path, {"params": jax.tree.map(jnp.zeros_like, ref)})
    flat_b = rck._flatten(back)[0]
    flat_r = rck._flatten({"params": ref})[0]
    assert list(flat_b) == list(flat_r)
    for k in flat_r:
        assert flat_b[k].dtype == flat_r[k].dtype, k
        np.testing.assert_array_equal(np.asarray(flat_b[k], np.float32),
                                      np.asarray(flat_r[k], np.float32))


def test_train_cli_writes_checkpoints_on_rank_zero(tmp_path):
    """Two ranks train 3 steps of the smoke config with --ckpt-every 2:
    the checkpoint is written (rank 0) at step 2 and after the last step,
    and holds the reference's tree layout."""
    from repro_torch.core.config import get_config, smoke_config
    from repro_torch.launch import train
    path = str(tmp_path / "run")
    rc = train.main(["--arch", "llama-gqa", "--smoke", "--device", "cpu",
                     "--steps", "3", "--seq", "32", "--batch", "2",
                     "--nproc", "2", "--seq-shards", "2",
                     "--ckpt-dir", path, "--ckpt-every", "2"])
    assert rc == 0
    assert ckpt.latest_step(path) == 3
    m = ckpt.verify(path)
    cfg = smoke_config(get_config("llama-gqa"))
    a = cfg.attn
    assert m["tensors"]["params/layers/attn/wq"] == {
        "shape": [cfg.n_layers, cfg.d_model, a.n_heads * a.head_dim],
        "dtype": "float32"}
    assert sorted(k.split("/")[1] for k in m["tensors"]) == sorted(
        ["embed", "head", "ln_f"] + ["layers"] * 9)
