"""Cases shared by the two sides of ``tests/test_torch_fsdp.py``: the
reference's FSDP layout (``param_spec`` / ``param_shardings``) and its
FSDP train step (``init_sharded`` + ``jit_train_step``) against the
port's (``parallel/fsdp.py``).

The reference side is one JAX process on 512 forced host devices with
Auto-axis meshes: the initial weights of each of :data:`TRAIN`
(``init_sharded`` on its first devices; ``init.done`` marks them
written), the shard shape of every parameter of every ``ARCH_IDS`` entry
at full size (``jax.eval_shape``, no jit) on each of :data:`SPEC_MESHES`,
``make_parallel_config``'s fields for every shape, then 3 FSDP train
steps of each of :data:`TRAIN`.  The
port's side is one 4-rank ``gloo`` world.  Plain numpy and the port only:
the world's ranks import this module and must not import jax.
"""
import dataclasses
import os

from _torch_dist_cases import load_tree

T = 64
# (name, mesh axes, mesh shape) of the spec-parity meshes
SPEC_MESHES = (("data2_model2", ("data", "model"), (2, 2)),
               ("data16_model16", ("data", "model"), (16, 16)),
               ("pod2_data16_model16", ("pod", "data", "model"),
                (2, 16, 16)),
               ("data2_seq2_head2", ("data", "seq", "head"), (2, 2, 2)))
# the reference's FSDP training cases: (name, arch, mesh axes, shape, B)
TRAIN = (("gqa_2x2", "llama-gqa", ("data", "model"), (2, 2), 4),
         ("gqa_4x1", "llama-gqa", ("data", "model"), (4, 1), 4),
         ("gqa_2x2x1", "llama-gqa", ("data", "seq", "head"), (2, 2, 1), 4),
         ("ds_2x2", "deepseek-v2-lite-16b", ("data", "model"), (2, 2), 4))
STEPS = 3
TC = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
# the port's own families against one process, 2 steps each on (2, 2);
# "owned" is mamba2 cut so that its per-layer A_log / D / dt_bias (6
# heads) split over 4 data ranks by whole layers (4 of them)
OTHERS = (("mamba2-2.7b", (2, 2)), ("zamba2-2.7b", (2, 2)),
          ("whisper-tiny", (2, 2)), ("deepseek-v3-671b", (2, 2)),
          ("owned", (4, 1)))
OTHER_STEPS, OTHER_B = 2, 4


def mesh_of(names, shape, device="cpu"):
    """The port's process-group mesh of ``names`` / ``shape``."""
    from repro_torch.launch.mesh import make_local_mesh, make_seq2d_mesh
    if names == ("data", "model"):
        return make_local_mesh(seq=shape[1], data=shape[0], device=device)
    d, r, u = shape
    return make_seq2d_mesh(r, u, data=d, device=device)


def config(arch):
    from repro_torch.core.config import get_config, smoke_config
    if arch == "owned":
        cfg = smoke_config(get_config("mamba2-2.7b"))
        return cfg.replace(d_model=48, n_layers=4, ssm=dataclasses.replace(
            cfg.ssm, head_dim=16))
    return smoke_config(get_config(arch))


def _nbytes(tree):
    from repro_torch.core.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _flat_ref(tree):
    """A reference-layout tree of tensors as {"/"-joined key: float32
    array}."""
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{pre}/{k}" if pre else k)
        else:
            out[pre] = t.detach().float().cpu().numpy()
    walk(tree, "")
    return out


def _train(model, params, steps, B, seed=0, *, moments=False,
           frozen=False):
    """``steps`` train steps of ``model`` from ``params`` (trainable):
    losses and gradient norms, and the parameters after them;
    ``moments``: each step's first moment too (the reference's layout);
    ``frozen``: this rank puts its parameters back after every step (the
    planted fault: a rank that skips its shards' update)."""
    import torch
    from repro_torch.core.config import ShapeSpec, TrainConfig
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import to_reference_params
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    shape = ShapeSpec("tt", T, B, "train")
    opt = adamw.init(params)
    step = make_train_step(model, TrainConfig(**TC))
    ds = SyntheticTokens(model.cfg, shape, device="cpu", seed=seed,
                         mesh=model.mesh, par=model.par)
    out = {"loss": [], "gnorm": [], "m": []}
    for i in range(steps):
        before = [p.detach().clone() for p in leaves(params)] \
            if frozen else None
        m = step(params, opt, ds.batch(i))
        assert m["skipped_nonfinite"] == 0
        out["loss"].append(m["loss"])
        out["gnorm"].append(m["gnorm"])
        if moments:
            out["m"].append(_flat_ref(to_reference_params(opt.m)))
        if frozen:
            with torch.no_grad():
                for p, b in zip(leaves(params), before):
                    p.copy_(b)
    return out, opt


def single_run(arch, B, steps, tree=None, seed=0):
    """The port on one process: losses, norms and final parameters (the
    reference's layout) of ``steps`` steps from ``tree`` (the reference's
    weights) or from ``init(seed)``."""
    from repro_torch.core.config import ParallelConfig
    from repro_torch.models.transformer import (build_model,
                                                load_reference_params,
                                                to_reference_params,
                                                trainable)
    cfg = config(arch)
    model = build_model(cfg, "cpu", par=ParallelConfig())
    params = trainable(model.init(seed) if tree is None else
                       load_reference_params(cfg, tree, "cpu"))
    out, _ = _train(model, params, steps, B, seed, moments=True)
    out["params"] = _flat_ref(to_reference_params(params))
    out["bytes"] = _nbytes(params)
    return out


def _fsdp_model(arch, names, shape, B, ref_dir=None, name=None, seed=0):
    """The FSDP model of ``arch`` on a mesh and its shards, from the
    reference's initial weights (``ref_dir``) or ``init(seed)``; and
    whether they equal, bit for bit, ``shard_tree`` of the whole tree one
    process makes the same way (its experts cut to this rank's rows)."""
    import torch
    from repro_torch.core.config import ParallelConfig, ShapeSpec
    from repro_torch.core.tree import leaves
    from repro_torch.models.transformer import (build_model, expert_mask,
                                                expert_rows,
                                                load_reference_params,
                                                trainable)
    from repro_torch.parallel.fsdp import shard_tree
    from repro_torch.parallel.sharding import make_parallel_config
    cfg = config(arch)
    mesh = mesh_of(names, shape)
    par = make_parallel_config(mesh, ShapeSpec("tt", T, B, "train"))
    model = build_model(cfg, "cpu", par=par, mesh=mesh, fsdp=True)
    if ref_dir is None:
        params = model.init(seed)
        whole = build_model(cfg, "cpu", par=ParallelConfig()).init(seed)
    else:
        tree = load_tree(os.path.join(ref_dir, f"{name}_init.npz"))
        params = load_reference_params(cfg, tree, "cpu",
                                       experts=model.expert_group,
                                       fsdp=model.fsdp)
        whole = load_reference_params(cfg, tree, "cpu")
    if model.expert_group is not None:
        from repro_torch.core.tree import flatten
        xs, rebuild = flatten(whole)
        whole = rebuild([expert_rows(cfg, x, model.expert_group) if e
                         else x for x, e in zip(xs, expert_mask(whole))])
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(params), leaves(shard_tree(whole, model.fsdp.layout, mesh))))
    return model, trainable(params), same


def _export(model, params):
    from repro_torch.models.transformer import to_reference_params
    return _flat_ref(to_reference_params(params, experts=model.expert_group,
                                         fsdp=model.fsdp))


def _grads(model, params, batch):
    """Every leaf's gradient of the global loss, summed over the ranks as
    the train step sums them and gathered whole (the port's tree order),
    and the loss."""
    import torch
    from repro_torch.core.tree import flatten
    from repro_torch.train.step import sum_grads
    ps, rebuild = flatten(params)
    loss, _ = model.loss(params, batch)
    gs, _ = sum_grads(model, params, torch.autograd.grad(loss, ps))
    whole = gs if model.fsdp is None else flatten(model.fsdp.full(
        rebuild(gs)))[0]
    return float(loss.detach()), [g.detach().numpy().copy() for g in whole]


def replica_grads(model, params):
    """The data-replica case's first batch (B 1): loss and gradients."""
    from repro_torch.core.config import ShapeSpec
    from repro_torch.data.pipeline import SyntheticTokens
    ds = SyntheticTokens(model.cfg, ShapeSpec("tt", T, 1, "train"),
                         device="cpu", mesh=model.mesh, par=model.par)
    return _grads(model, params, ds.batch(0))


def world(rank, ref_dir, ckpt_dir):
    """One rank of the 4-rank world: every case of :data:`TRAIN` from the
    reference's initial weights (losses, norms, the gathered parameters
    after the last step, the bytes this rank holds against its shards'),
    the data-replica case (sound, and with the replica scale planted
    out), the checkpoint written from shards and restored into them, and
    :data:`OTHERS` from the port's own init."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.io import checkpoint as ckpt_io
    from repro_torch.models.transformer import (load_reference_params,
                                                to_reference_params)
    out = {"gather": gather_checks(rank)}
    for name, arch, names, shape, B in TRAIN:
        model, params, same = _fsdp_model(arch, names, shape, B, ref_dir,
                                          name)
        held = _nbytes(params)
        res, opt = _train(model, params, STEPS, B)
        res["bytes"] = (held, _nbytes(opt.m) + _nbytes(opt.v))
        res["sliced"] = same
        res["params"] = _export(model, params)
        res["fsdp_rank"] = model.fsdp.rank
        out[name] = res
    # the planted fault: data rank 1 (world ranks 2 and 3 on (2, 2))
    # skips its shards' update
    model, params, _ = _fsdp_model("llama-gqa", ("data", "model"), (2, 2),
                                   4, ref_dir, "gqa_2x2")
    _train(model, params, STEPS, 4, frozen=model.fsdp.rank == 1)
    out["skipped"] = _export(model, params)
    # data replicas: batch 1 does not shard over data, whose two ranks
    # then hold the same tokens
    model, params, _ = _fsdp_model("llama-gqa", ("data", "model"), (2, 2),
                                   1, ref_dir, "gqa_2x2")
    out["replica"] = {"batch_axes": model.par.batch_axes,
                      "scale": model.fsdp.scale,
                      "sound": replica_grads(model, params)}
    model.fsdp.scale = 1.0                     # the planted double sum
    out["replica"]["double"] = replica_grads(model, params)
    # checkpoints: written by rank 0 from the gathered shards, restored
    # into shards
    model, params, _ = _fsdp_model("llama-gqa", ("data", "model"), (2, 2),
                                   4, ref_dir, "gqa_2x2")
    tree = {"params": to_reference_params(params, experts=model.expert_group,
                                          fsdp=model.fsdp)}
    if rank == 0:
        ckpt_io.save(ckpt_dir, tree, step=0)
    torch.distributed.barrier()
    back = ckpt_io.restore(ckpt_dir, tree)["params"]
    again = load_reference_params(model.cfg, back, "cpu",
                                  experts=model.expert_group,
                                  fsdp=model.fsdp)
    out["restored_equal"] = all(
        torch.equal(a, b.detach()) for a, b in zip(leaves(again),
                                                   leaves(params)))
    for arch, shape in OTHERS:
        model, params, same = _fsdp_model(arch, ("data", "model"), shape,
                                          OTHER_B)
        res, opt = _train(model, params, OTHER_STEPS, OTHER_B)
        res["sliced"] = same
        res["params"] = _export(model, params)
        res["bytes"] = (_nbytes(params), _nbytes(opt.m) + _nbytes(opt.v))
        res["fsdp_rank"] = model.fsdp.rank
        res["owned"] = [int(lp["ssm"]["A_log"].numel() > 0)
                        for lp in params["layers"]] \
            if arch == "owned" else None
        out[arch] = res
    return out


def gather_checks(rank):
    """``comm.gather_param`` on the world's (data 4) group against its
    plain version: the forward, and the backward against the cotangents'
    blocks summed by hand (float64); ``Comm.reduce_scatter`` of bfloat16
    against the float64 sum rounded once."""
    import torch
    from repro_torch.parallel.comm import gather_param, gather_param_ref
    comm = mesh_of(("data", "model"), (4, 1)).comm("data")
    g = torch.Generator().manual_seed(7)
    whole = torch.randn(8, 12, generator=g)
    cot = [torch.randn(8, 12, generator=g) for _ in range(4)]
    out = {}
    for dim in (0, 1):
        n = whole.shape[dim] // 4
        shard = whole.narrow(dim, rank * n, n).clone().requires_grad_(True)
        got = gather_param(comm, shard, dim, scale=0.5)
        plain = gather_param_ref([whole.narrow(dim, r * n, n)
                                  for r in range(4)], dim)
        got.backward(cot[rank])
        want = sum(c.double().narrow(dim, rank * n, n) for c in cot) * 0.5
        out[dim] = (torch.equal(got.detach(), plain),
                    float((shard.grad.double() - want).abs().max()))
    x = [torch.randn(8, 6, generator=g).bfloat16() for _ in range(4)]
    rs = comm.reduce_scatter(x[rank], 0)
    want = sum(t.double() for t in x)[rank * 2:(rank + 1) * 2]
    out["bf16"] = (rs.dtype == torch.bfloat16,
                   torch.equal(rs, want.float().bfloat16()))
    return out


# ------------------------------------------------------- reference side

REFERENCE = """
import json, os, time
import numpy as np
import jax
from jax.sharding import AxisType, Mesh, NamedSharding
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.config import (ARCH_IDS, SHAPES, ShapeSpec, TrainConfig,
                               get_config, smoke_config)
from repro.data.pipeline import SyntheticTokens, input_specs
from repro.models.transformer import Runtime, build_model
from repro.parallel.sharding import make_parallel_config, param_shardings
from repro.train.step import init_sharded, jit_train_step

OUT = {out!r}
devs = np.array(jax.devices())


def mesh_of(names, shape):
    n = int(np.prod(shape))
    return Mesh(devs[:n].reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(names))


def flat(tree):
    return {{"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(x, np.float32) for path, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}}


# the training cases' initial weights first: the port's world starts
# from them while this process goes on
inits = {{}}
for name, arch, names, shape, B in {train!r}:
    mesh = mesh_of(tuple(names), tuple(shape))
    cfg = smoke_config(get_config(arch))
    sh = ShapeSpec("tt", {T}, B, "train")
    par = make_parallel_config(mesh, sh)
    model = build_model(cfg, Runtime(mesh=mesh, par=par, impl="ref"))
    tc = TrainConfig(**{tc!r})
    inits[name] = (mesh, cfg, sh, par, model, tc,
                   init_sharded(model, tc, jax.random.PRNGKey(0)))
    np.savez(OUT + "/" + name + "_init.npz", **flat(inits[name][-1][0]))
open(OUT + "/init.done", "w").close()

spec = {{"par": {{}}, "shards": {{}}}}
shapes_of = {{}}            # a model's parameter shapes: the mesh's none
for mname, names, shape in {spec_meshes!r}:
    mesh = mesh_of(tuple(names), tuple(shape))
    for sname, sh in SHAPES.items():
        par = make_parallel_config(mesh, sh)
        spec["par"][mname + "/" + sname] = {{
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in vars(par).items()}}
    par = make_parallel_config(mesh, SHAPES["train_4k"])
    for arch in ARCH_IDS + (("llama-7b",) if mname == "data16_model16"
                            else ()):
        if arch not in shapes_of:
            model = build_model(get_config(arch), Runtime(
                mesh=mesh, par=par, impl="ref"))
            shapes_of[arch] = jax.eval_shape(
                lambda: model.init(jax.random.PRNGKey(0)))
        shapes = shapes_of[arch]
        shs = param_shardings(shapes, mesh, par)
        got = {{}}
        for (path, leaf), s in zip(
                jax.tree_util.tree_flatten_with_path(shapes)[0],
                jax.tree_util.tree_leaves(shs)):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            got[key] = [list(s.shard_shape(leaf.shape)), list(leaf.shape)]
        spec["shards"][mname + "/" + arch] = got
with open(OUT + "/spec.tmp", "w") as f:     # whole once it has its name
    json.dump(spec, f)
os.replace(OUT + "/spec.tmp", OUT + "/spec.json")
print("SPEC done", flush=True)

runs = {{}}
for name, arch, names, shape, B in {train!r}:
    t0 = time.time()
    mesh, cfg, sh, par, model, tc, (params, opt, p_sh) = inits.pop(name)
    shards = {{k: list(v.sharding.shard_shape(v.shape)) for k, v in zip(
        flat(params), jax.tree_util.tree_leaves(params))}}
    _, bspec = input_specs(cfg, sh, par, mesh)
    bsh = compat.tree_map(lambda s: NamedSharding(mesh, s), bspec,
                          is_leaf=lambda x: isinstance(x, P))
    step = jit_train_step(model, tc, p_sh, bsh)
    ds = SyntheticTokens(cfg, sh, par, mesh)
    losses, gnorms = [], []
    for i in range({steps}):
        params, opt, m = step(params, opt, ds.batch(i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    np.savez(OUT + "/" + name + "_final.npz", **flat(params))
    runs[name] = dict(loss=losses, gnorm=gnorms, shards=shards)
    print("RUN", name, losses, round(time.time() - t0, 1), flush=True)
with open(OUT + "/runs.json", "w") as f:
    json.dump(runs, f)
"""


def reference_script(out):
    return REFERENCE.format(out=out, spec_meshes=SPEC_MESHES, train=TRAIN,
                            T=T, tc=TC, steps=STEPS)
