"""What a step does, counted op by op as PyTorch dispatches it: the port's
counterpart of XLA's ``cost_analysis`` and ``memory_analysis`` on the
reference's compiled dry-run (``launch/dryrun.py``).

One ``TorchDispatchMode``, :class:`OpCounter` (entered by
:func:`counting`), keeps two counts:

  * **FLOPs** — the formulas of ``torch.utils.flop_counter``'s
    ``FlopCounterMode`` (its ``flop_registry``): matrix products (``mm``,
    ``bmm``, ``addmm``, ``baddbmm``) and convolutions, their backward's
    too; every other op counts none (XLA's count of ``dot_general`` /
    ``conv_general_dilated``).  The formulas are called from this mode
    rather than by stacking ``FlopCounterMode``, whose dispatch costs four
    times a meta op's (a full-size step: 20 s against 5 s);
    ``tests/test_torch_dryrun.py`` holds the two to the same count.
  * **Memory**:
    ``bytes_accessed``, every op's input and output bytes — the unfused
    counterpart of XLA's "bytes accessed" (views, allocations and
    ``detach`` move nothing and count none); and ``peak_bytes``, the most
    bytes of storage alive at once — the counterpart of ``memory_analysis``'s
    peak.  Each storage counts once, however many tensors view it, from
    the op that made it until its last tensor dies (a finalizer on the
    storage's Python object, which PyTorch keeps for as long as the storage
    lives, autograd's saved tensors included).  Tensors made before the
    count (the parameters, the optimizer's moments, the batch) are entered
    with :meth:`OpCounter.track`; copies of host tensors onto the device
    (positions made with numpy) count as made on the host, as they are on
    a CPU run, where they alias the host array.

Both count shapes, not values, so they give the same numbers on ``meta``
tensors as on real ones (``tests/test_torch_dryrun.py`` holds them to a CPU
run).  Collectives are counted where they are issued, by the mesh's
``parallel.comm.MetaComm``s.
"""
from __future__ import annotations

import contextlib
import gc
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that allocate or alias without moving a byte
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten.detach, aten.alias,
             aten.lift_fresh}


def _tensors(tree, out=None):
    """The tensors in nested lists, tuples and dicts (an op's arguments,
    or a step's inputs)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """FLOPs, the bytes every op reads and writes, and the live storage's
    peak (module docstring).  ``live_bytes`` is what is alive now;
    ``tracked_bytes`` what :meth:`track` entered."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.live_bytes = self.peak_bytes = self.tracked_bytes = 0
        self.bytes_accessed = 0
        self.flops_by_op = {}

    @property
    def flops(self) -> int:
        return sum(self.flops_by_op.values())

    def _free(self, key):
        self.live_bytes -= self.live.pop(key)

    def _see(self, t) -> int:
        """Enter ``t``'s storage if it is new; returns the bytes entered."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):  # no storage
            return 0
        key = st._cdata
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def track(self, tree) -> int:
        """Enter the storages of the tensors of ``tree`` made before the
        count; returns their bytes."""
        n = sum(self._see(t) for t in _tensors(tree))
        self.tracked_bytes += n
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            name = str(func.overloadpacket)
            self.flops_by_op[name] = (self.flops_by_op.get(name, 0)
                                      + int(formula(*args, **kwargs,
                                                    out_val=out)))
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if outs and ins and all(t.device.type == "cpu" for t in ins) and \
                outs[0].device.type != "cpu":
            return out      # a host array moved in: made on the host
        if not (func.is_view or func.overloadpacket in _NO_BYTES):
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._see(t)
        return out


@contextlib.contextmanager
def counting(*live):
    """Count the FLOPs, bytes and peak of the ops run inside the block;
    ``live`` are trees of tensors already alive (entered with
    :meth:`OpCounter.track`).  Yields the :class:`OpCounter`, complete
    once the block ends (a garbage collection first frees what only a
    reference cycle held)."""
    c = OpCounter()
    for tree in live:
        c.track(tree)
    with c:
        yield c
    gc.collect()


def as_dict(c: OpCounter) -> dict:
    """A count's figures: ``flops`` (and ``flops_by_op``),
    ``bytes_accessed``, ``peak_bytes`` (storage alive at once, the tracked
    inputs included), ``tracked_bytes`` (those inputs) and ``end_bytes``
    (alive when the block ended)."""
    return {"flops": c.flops, "flops_by_op": dict(c.flops_by_op),
            "bytes_accessed": c.bytes_accessed, "peak_bytes": c.peak_bytes,
            "tracked_bytes": c.tracked_bytes, "end_bytes": c.live_bytes}
