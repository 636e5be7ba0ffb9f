"""Cases shared by ``tests/test_torch_dist.py``'s two sides: the reference
(one JAX process on 8 forced host devices, Auto-axis meshes) and the port
(one 8-rank ``gloo`` world).  Plain numpy and the port only: this module is
imported by the world's ranks, which must not import jax.

Each case is (name, schedule, mask, P, heads, grads); the inputs are
global arrays from a seeded numpy generator, permuted with ``zigzag_perm``
for zigzag cases, sharded over P contiguous ranks.
"""
import numpy as np

B, N, HKV, D = 2, 256, 2, 32
N5 = 5 * 32                 # the odd-P cases: 5 ranks of 32 tokens
WINDOW = 40                 # > one shard: a band over two ring steps
N_DOCS = 5

CASES = []
for _s in ("balanced", "ring", "zigzag"):
    CASES.append((f"{_s}-causal", _s, ("causal",), 8, 4, True))
    CASES.append((f"{_s}-window{WINDOW}", _s, ("window", WINDOW), 8, 4,
                  True))
    CASES.append((f"{_s}-document", _s, ("document",), 8, 4, True))
CASES += [
    ("balanced-boundaries", "balanced", ("boundaries",), 8, 4, True),
    ("balanced-causal-P5", "balanced", ("causal",), 5, 4, True),
    ("zigzag-causal-P5", "zigzag", ("causal",), 5, 4, True),
    ("ring-full", "ring", ("full",), 8, 4, False),
    ("ulysses-causal", "ulysses", ("causal",), 8, 8, True),
    ("rsa-causal", "rsa", ("causal",), 8, 4, False),
    ("rsa-document", "rsa", ("document",), 8, 4, False),
]
NAMES = [c[0] for c in CASES]


def seq_len(P):
    return N if P == 8 else N5


def inputs(P, H):
    """Global q, k, v (B, T, ·, D) float32 and (B, T) segment ids."""
    T = seq_len(P)
    rng = np.random.default_rng(1000 * P + H)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, HKV if H == 4 else H, D)).astype(
        np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    return q, k, v, segments(T)


def boundaries(T):
    total = N_DOCS * (N_DOCS + 1) // 2
    starts = [0]
    for i in range(N_DOCS - 1):
        starts.append(starts[-1] + (i + 1) * T // total)
    return tuple(starts)


def segments(T):
    seg = np.zeros((T,), np.int32)
    for b in boundaries(T)[1:]:
        seg[b:] += 1
    return np.tile(seg, (B, 1))


def make_mask(mk, spec, T):
    """The case's global MaskSpec, from either package's ``core.mask``."""
    kind = spec[0]
    if kind == "causal":
        return mk.causal()
    if kind == "window":
        return mk.sliding_window(spec[1])
    if kind == "document":
        return mk.document()
    if kind == "boundaries":
        return mk.document(boundaries=boundaries(T))
    return mk.full()


def uses_segments(spec):
    return spec[0] == "document"


def zigzag_perm(T, P):
    c = T // (2 * P)
    order = []
    for p in range(P):
        order.append(np.arange(p * c, (p + 1) * c))
        order.append(np.arange((2 * P - 1 - p) * c, (2 * P - p) * c))
    return np.concatenate(order)


def laid_out(case):
    """The case's global arrays in the layout the ranks shard."""
    _, sched, spec, P, H, _ = case
    q, k, v, seg = inputs(P, H)
    if sched == "zigzag":
        perm = zigzag_perm(seq_len(P), P)
        q, k, v, seg = q[:, perm], k[:, perm], v[:, perm], seg[:, perm]
    return q, k, v, seg


# ------------------------------------------------------------ port side

def port_world(rank, names):
    """One rank of the 8-rank world: every case's (o, lse, dq, dk, dv)
    shard of this rank (None on ranks outside a 5-rank case)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dist_attention as da
    from repro_torch.core import mask as tmk
    from repro_torch.parallel.comm import Comm, transport_of

    transport = transport_of("cpu")
    world = list(range(8))
    comms = {8: Comm(world, transport, "cpu", dist.new_group(world),
                     dist.new_group(world))}
    g5, p5 = dist.new_group(world[:5]), dist.new_group(world[:5])
    comms[5] = Comm(world[:5], transport, "cpu", g5, p5) if rank < 5 \
        else None
    out = {}
    for case in CASES:
        name, sched, spec, P, H, grads = case
        if name not in names:
            continue
        comm = comms[P]
        if comm is None:
            out[name] = None
            continue
        T = seq_len(P)
        Tl = T // P
        q, k, v, seg = (torch.from_numpy(np.ascontiguousarray(
            a[:, rank * Tl:(rank + 1) * Tl])) for a in laid_out(case))
        dspec = da.DistAttnSpec(axis="model", axis_size=P, schedule=sched,
                                mask=make_mask(tmk, spec, T))
        segs = seg if uses_segments(spec) else None
        q, k, v = (t.requires_grad_(grads) for t in (q, k, v))
        o, lse = da.dist_flash_attn(q, k, v, dspec, comm, segs)
        res = {"o": o.detach().numpy(), "lse": lse.numpy()}
        if grads:
            dq, dk, dv = torch.autograd.grad((o ** 2).sum(), (q, k, v))
            res.update(dq=dq.numpy(), dk=dk.numpy(), dv=dv.numpy())
        out[name] = res
    # the head-divisibility refusal of ulysses (3 heads over 8 ranks)
    q3 = torch.zeros(B, N // 8, 3, D)
    spec_u = da.DistAttnSpec(axis="model", axis_size=8, schedule="ulysses")
    try:
        da.dist_attn_fwd(q3, q3, q3, spec=spec_u, group=comms[8])
        out["ulysses-3-heads"] = "no error"
    except ValueError as e:
        out["ulysses-3-heads"] = f"ValueError: {e}"
    spec_a = da.DistAttnSpec(axis="model", axis_size=8, schedule="auto")
    try:
        da.dist_attn_fwd(q3, q3, q3, spec=spec_a, group=comms[8])
        out["auto"] = "no error"
    except NotImplementedError as e:
        out["auto"] = f"NotImplementedError: {e}"
    return out


def order_world(rank, sched):
    """One rank of a 4-rank world: the order of the ring's container
    shifts (issue, wait) and of the kernel launches in one forward and one
    backward of ``sched``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import dist_attention as da
    from repro_torch.core import schedule as sp
    from repro_torch.parallel import comm as cm

    events = []
    orig_shift = sp._shift

    class Logged:
        def __init__(self, handle, i):
            self.handle, self.i = handle, i

        def wait(self):
            out = self.handle.wait()
            events.append(("wait", self.i))
            return out

    def shift(comm, data, hops):
        n = sum(e[0] == "issue" for e in events) + 1
        events.append(("issue", n))
        return Logged(orig_shift(comm, data, hops), n)

    def logged(fn, kind):
        def run(*a, **kw):
            events.append((kind, None))
            return fn(*a, **kw)
        return run

    sp._shift = shift
    sp.chunk_attn = logged(sp.chunk_attn, "fwd")
    sp.chunk_attn_bwd = logged(sp.chunk_attn_bwd, "bwd")
    ranks = list(range(4))
    comm = cm.Comm(ranks, cm.transport_of("cpu"), "cpu",
                   dist.new_group(ranks), dist.new_group(ranks))
    rng = np.random.default_rng(3 + rank)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 16, 2, 32)).astype(np.float32)).requires_grad_()
        for _ in range(3))
    spec = da.DistAttnSpec(axis="model", axis_size=4, schedule=sched)
    o, _ = da.dist_flash_attn(q, k, v, spec, comm)
    n_fwd = len(events)
    torch.autograd.grad(o.sum(), (q, k, v))
    return events[:n_fwd], events[n_fwd:]


# --------------------------------------------------- training (port side)

TRAIN_T, TRAIN_B = 64, 4
TRAIN_TC = dict(lr=3e-3, warmup_steps=2, total_steps=4)
TRAIN_STEPS = 3
TRAIN_MESHES = ((1, 8), (2, 4))
REMATS = ("remat_aware", "hf", "none")


def load_tree(path):
    """The reference's parameter pytree from an npz of "/"-joined keys."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[key]
    return tree


def heads33(cfg):
    """The smoke config keeping llama-33h's irregular head count: 33 heads
    of 32 over a 128-wide residual stream."""
    import dataclasses
    return cfg.replace(attn=dataclasses.replace(
        cfg.attn, n_heads=33, n_kv_heads=33, head_dim=32))


def train_losses(cfg, tree, par, mesh, steps):
    """Losses of ``steps`` train steps from the reference's weights."""
    from repro_torch.core.config import ShapeSpec, TrainConfig
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params,
                                                trainable)
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    shape = ShapeSpec("tt", TRAIN_T, TRAIN_B, "train")
    model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
    params = trainable(load_reference_params(cfg, tree, device="cpu"))
    opt = adamw.init(params)
    step = make_train_step(model, TrainConfig(**TRAIN_TC))
    ds = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh, par=par)
    out = []
    for i in range(steps):
        m = step(params, opt, ds.batch(i))
        assert m["skipped_nonfinite"] == 0
        out.append(m["loss"])
    return out


def train_world(rank, params_path):
    """One rank of the 8-rank world: first-batch losses on each mesh and
    schedule, 3-step trajectories, and llama-33h at P = 8."""
    import torch
    from repro_torch.core.config import (ShapeSpec, get_config,
                                         smoke_config)
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.transformer import (DecoderLM,
                                                load_reference_params)
    from repro_torch.parallel.sharding import make_parallel_config

    shape = ShapeSpec("tt", TRAIN_T, TRAIN_B, "train")
    cfg = smoke_config(get_config("llama-gqa"))
    tree = load_tree(params_path)
    out = {}

    def first_loss(cfg, tree, mesh, sched, init_seed=None):
        par = make_parallel_config(mesh, shape, schedule=sched)
        model = DecoderLM(cfg, "cpu", par=par, mesh=mesh)
        params = model.init(init_seed) if tree is None else \
            load_reference_params(cfg, tree, device="cpu")
        batch = SyntheticTokens(cfg, shape, device="cpu", mesh=mesh,
                                par=par).batch(0)
        with torch.no_grad():
            return float(model.loss(params, batch)[0])

    meshes = {ds: make_local_mesh(seq=ds[1], data=ds[0], device="cpu")
              for ds in TRAIN_MESHES}
    for (d, s), mesh in meshes.items():
        for sched in ("balanced", "ring", "zigzag"):
            out[f"loss/{d}x{s}/{sched}"] = first_loss(cfg, tree, mesh,
                                                      sched)
    mesh8 = meshes[(1, 8)]
    for sched in ("balanced", "ring"):
        for remat in REMATS:
            par = make_parallel_config(mesh8, shape, schedule=sched,
                                       remat=remat)
            out[f"train/{sched}/{remat}"] = train_losses(
                cfg, tree, par, mesh8, TRAIN_STEPS)
    cfg33 = heads33(smoke_config(get_config("llama-33h")))
    out["33h/balanced"] = first_loss(cfg33, None, mesh8, "balanced", 0)
    try:
        first_loss(cfg33, None, mesh8, "ulysses", 0)
        out["33h/ulysses"] = "no error"
    except ValueError as e:
        out["33h/ulysses"] = f"ValueError: {e}"
    return out
