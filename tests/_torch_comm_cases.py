"""The ``cuda-ipc`` transport's card checks (``tests/test_torch_cuda.py``):
one rank of a 4-rank world sharing the card runs every collective under
``cuda-ipc`` and under ``gloo-staged`` on the same seeded inputs, small
ones and ones past the mailbox's slot.  Plain torch and the port only:
the ranks import this module."""
RANKS = 4


def inputs(rank, dev):
    """This rank's seeded tensors: several dtypes and shapes, and ones past
    one mailbox slot (``MAILBOX_CAP`` bytes)."""
    import torch
    from repro_torch.parallel.comm import MAILBOX_CAP
    gen = torch.Generator(device=dev).manual_seed(500 + rank)

    def r(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    return dict(small=[r((3, 999, 5), torch.bfloat16), r((7,), torch.float32)],
                big=r((MAILBOX_CAP // 2 + 513,), torch.bfloat16),
                a2a=r((RANKS * 5, 17, 3), torch.float32),
                a2a_big=r((RANKS, MAILBOX_CAP // 4 // RANKS * 3 + 17),
                          torch.float32),
                red=[r((333, 7), torch.float32), r((40, 41), torch.bfloat16)],
                red_big=r((MAILBOX_CAP // 4 + 77,), torch.float32))


def run(comm, x):
    """Every collective of ``comm`` on ``x``: results on the host."""
    out = {}
    for h in (1, 3):
        out[f"shift{h}"] = [t.cpu() for t in comm.shift(x["small"], h).wait()]
    out["shift_big"] = comm.shift([x["big"]], 1).wait()[0].cpu()
    out["a2a"] = comm.all_to_all(x["a2a"], 0, 2).cpu()
    out["a2a_big"] = comm.all_to_all(x["a2a_big"], 0, 1).cpu()
    out["gather"] = comm.all_gather(x["small"][0], 1).cpu()
    out["gather_big"] = comm.all_gather(x["big"], 0).cpu()
    out["bcast"] = [t.cpu() for t in comm.broadcast_(
        [t.clone() for t in x["small"]], 1)]
    out["sum"] = [t.cpu() for t in comm.all_reduce_(
        [t.clone() for t in x["red"]])]
    out["sum_big"] = comm.all_reduce_([x["red_big"].clone()])[0].cpu()
    return out


def transport_world(rank):
    """This rank's results under both transports, its inputs, and the
    transports the meshes took."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    ipc = make_local_mesh(seq=RANKS, device=dev).comms["model"]
    stg = make_local_mesh(seq=RANKS, device=dev,
                          transport="gloo-staged").comms["model"]
    x = inputs(rank, dev)
    out = {"rank": rank, "transports": (ipc.transport, stg.transport),
           "ipc": run(ipc, x), "staged": run(stg, x),
           "red": [t.cpu() for t in x["red"]],
           "red_big": x["red_big"].cpu()}
    torch.cuda.synchronize()
    return out
