"""Exact tensor transport between the ranks of one mesh axis
(``parallel.mesh.MeshAxis``): the mesh entry points move their tensors as
raw bytes (one flat ``uint8`` buffer a message), so what arrives equals
what was sent bit for bit, whatever its dtype (bool and float16 included,
which ``gloo`` does not reduce), on ``gloo`` and NCCL alike."""

from __future__ import annotations

import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import MeshAxis

Spec = Tuple[Tuple[int, ...], torch.dtype]


def spec_of(tensors: Sequence[torch.Tensor]) -> List[Spec]:
    return [(tuple(t.shape), t.dtype) for t in tensors]


def _nbytes(spec: Spec) -> int:
    shape, dtype = spec
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def pack(tensors: Sequence[torch.Tensor], device: torch.device
         ) -> torch.Tensor:
    """The tensors' bytes, one after the other, as a flat uint8 tensor on
    ``device``."""
    parts = [t.detach().contiguous().reshape(-1).view(torch.uint8)
             .to(device) for t in tensors]
    if not parts:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    return torch.cat(parts)


def unpack(buf: torch.Tensor, specs: Sequence[Spec]) -> List[torch.Tensor]:
    """The inverse of :func:`pack` for tensors of ``specs``."""
    out, off = [], 0
    for spec in specs:
        n = _nbytes(spec)
        out.append(buf[off:off + n].clone().view(spec[1]).reshape(spec[0]))
        off += n
    return out


def all_gather_tensors(ax: MeshAxis, tensors: Sequence[torch.Tensor]
                       ) -> List[List[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes and dtypes on every rank
    of the axis), in axis order, on this rank's device."""
    specs = spec_of(tensors)
    buf = pack(tensors, ax.device)
    bufs = [torch.empty_like(buf) for _ in ax.ranks]
    dist.all_gather(bufs, buf, group=ax.group)
    return [unpack(b, specs) for b in bufs]


def send_tensors(ax: MeshAxis, tensors: Sequence[torch.Tensor],
                 dst: int) -> None:
    """Send ``tensors`` to axis rank ``dst`` (blocking)."""
    dist.send(pack(tensors, ax.device), ax.ranks[dst], group=ax.group)


def recv_tensors(ax: MeshAxis, specs: Sequence[Spec], src: int
                 ) -> List[torch.Tensor]:
    """Receive tensors of ``specs`` from axis rank ``src`` (blocking)."""
    buf = torch.empty(sum(_nbytes(s) for s in specs), dtype=torch.uint8,
                      device=ax.device)
    dist.recv(buf, ax.ranks[src], group=ax.group)
    return unpack(buf, specs)


def all_ints(ax: MeshAxis, values: Sequence[int]) -> List[List[int]]:
    """Every rank's ``values`` (the same count on every rank)."""
    t = torch.tensor(list(values), dtype=torch.int64, device=ax.device)
    out = [torch.empty_like(t) for _ in ax.ranks]
    dist.all_gather(out, t, group=ax.group)
    return [o.tolist() for o in out]


def broadcast_object(ax: MeshAxis, obj=None, src: int = 0):
    """``obj`` of axis rank ``src`` on every rank, by pickle (exact for
    numpy arrays)."""
    if ax.index == src:
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8).to(ax.device)
        n = torch.tensor([data.numel()], dtype=torch.int64,
                         device=ax.device)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=ax.device)
    dist.broadcast(n, ax.ranks[src], group=ax.group)
    if ax.index != src:
        data = torch.empty(int(n.item()), dtype=torch.uint8,
                           device=ax.device)
    dist.broadcast(data, ax.ranks[src], group=ax.group)
    if ax.index == src:
        return obj
    return pickle.loads(data.cpu().numpy().tobytes())


def barrier(ax: MeshAxis) -> None:
    """Return once every rank of the axis has reached it."""
    dist.all_reduce(torch.zeros(1, device=ax.device), group=ax.group)


def duplicate(ax: MeshAxis) -> MeshAxis:
    """The same axis on a process group of its own (made by the axis's
    ranks alone), for collectives that run beside the axis's own on
    another thread."""
    group = dist.new_group(ax.ranks, use_local_synchronization=True)
    return ax._replace(group=group)


def halo_exchange(ax: MeshAxis, x: torch.Tensor, halo: int, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(from_left, from_right)``: the ``halo`` planes along ``dim`` of
    the axis neighbours' shards (``x`` the local one), by isend/irecv;
    zeros at the axis's two ends (JAX ``parallel/spatial.py:77-99``'s
    ppermute pair with its edge masks)."""
    edge = list(x.shape)
    edge[dim] = halo
    # moved as bytes (gloo has no bfloat16 send): a plane's bytes, flat
    nbytes = x.narrow(dim, 0, halo).numel() * x.element_size()
    bufs = [torch.zeros(nbytes, dtype=torch.uint8, device=x.device)
            for _ in range(2)]
    i, n = ax.index, ax.size

    def plane(start):
        return x.narrow(dim, start, halo).contiguous().reshape(-1).view(
            torch.uint8)

    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, plane(0), ax.ranks[i - 1], ax.group),
                dist.P2POp(dist.irecv, bufs[0], ax.ranks[i - 1], ax.group)]
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, plane(x.shape[dim] - halo),
                           ax.ranks[i + 1], ax.group),
                dist.P2POp(dist.irecv, bufs[1], ax.ranks[i + 1], ax.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    from_left, from_right = (b.view(x.dtype).reshape(edge) for b in bufs)
    return from_left, from_right


def _picklable(e: BaseException) -> BaseException:
    try:
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(repr(e))


def lead_result(ax: MeshAxis, fn: Callable[[], object]):
    """Run ``fn`` on axis rank 0 and send its result (or its exception,
    which is raised here too) to the other ranks, which wait in
    :func:`follow`."""
    try:
        result = fn()
    except BaseException as e:
        broadcast_object(ax, ("error", _picklable(e)))
        raise
    broadcast_object(ax, ("result", result))
    return result


def follow(ax: MeshAxis, on_message: Optional[Callable] = None):
    """A rank other than the axis's rank 0: take rank 0's messages until
    its result (returned) or its exception (raised); any other message
    ``(kind, payload)`` goes to ``on_message(kind, payload)``."""
    while True:
        kind, payload = broadcast_object(ax)
        if kind == "result":
            return payload
        if kind == "error":
            raise payload
        on_message(kind, payload)


def tree_to(tree, device):
    """Tensors of a nested dict / list / tuple moved to ``device`` as they
    are (other leaves kept)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
