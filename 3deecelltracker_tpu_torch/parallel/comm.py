"""Exact tensor transport between the ranks of one mesh axis
(``parallel.mesh.MeshAxis``): the mesh entry points move their tensors as
raw bytes (one flat ``uint8`` buffer a message), so what arrives equals
what was sent bit for bit, whatever its dtype (bool and float16 included,
which ``gloo`` does not reduce), on ``gloo`` and NCCL alike.

For training, the halo exchange has a gradient (:class:`HaloExchange`,
:func:`halo_extend`), and sums go through ``all_reduce`` in float32: the
batch statistics with their gradient (:func:`all_reduce_sum`) and the
gradients as one flat bucket (:func:`all_reduce_grads`)."""

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


def exchange_edges(ax: MeshAxis, to_left: torch.Tensor,
                   to_right: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(from_left, from_right)``: what the left axis neighbour sent to its
    right and what the right one sent to its left, by isend/irecv (the
    same shape and dtype on every rank); zeros at the axis's two ends.
    ``to_left`` goes to the left neighbour, ``to_right`` to the right
    one."""
    shape, dtype = to_left.shape, to_left.dtype
    # moved as bytes (gloo has no bfloat16 send)
    nbytes = to_left.numel() * to_left.element_size()
    bufs = [torch.zeros(nbytes, dtype=torch.uint8, device=to_left.device)
            for _ in range(2)]
    i, n = ax.index, ax.size

    def flat(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    ops = []
    if i > 0:
        ops += [dist.P2POp(dist.isend, flat(to_left), ax.ranks[i - 1],
                           ax.group),
                dist.P2POp(dist.irecv, bufs[0], ax.ranks[i - 1], ax.group)]
    if i < n - 1:
        ops += [dist.P2POp(dist.isend, flat(to_right), ax.ranks[i + 1],
                           ax.group),
                dist.P2POp(dist.irecv, bufs[1], ax.ranks[i + 1], ax.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    from_left, from_right = (b.view(dtype).reshape(shape) for b in bufs)
    return from_left, from_right


def halo_exchange(ax: MeshAxis, x: torch.Tensor, halo: int, dim: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(from_left, from_right)``: the ``halo`` planes along ``dim`` of
    the axis neighbours' shards (``x`` the local one), by isend/irecv;
    zeros at the axis's two ends (JAX ``parallel/spatial.py:77-99``'s
    ppermute pair with its edge masks)."""
    return exchange_edges(ax, x.narrow(dim, 0, halo),
                          x.narrow(dim, x.shape[dim] - halo, halo))


class HaloExchange(torch.autograd.Function):
    """:func:`halo_exchange` with a gradient.  Backward: the gradient of
    each received halo goes back to the rank it came from, which adds it
    onto the edge planes it sent (the exchange's adjoint)."""

    @staticmethod
    def forward(ctx, x, ax: MeshAxis, halo: int, dim: int):
        ctx.ax, ctx.halo, ctx.dim, ctx.shape = ax, halo, dim, x.shape
        return halo_exchange(ax, x, halo, dim)

    @staticmethod
    def backward(ctx, g_left, g_right):
        back_left, back_right = exchange_edges(ctx.ax, g_left, g_right)
        gx = back_left.new_zeros(ctx.shape)
        n = ctx.shape[ctx.dim]
        gx.narrow(ctx.dim, 0, ctx.halo).add_(back_left)
        gx.narrow(ctx.dim, n - ctx.halo, ctx.halo).add_(back_right)
        return gx, None, None, None


def halo_extend(ax: MeshAxis, x: torch.Tensor, halo: int, dim: int = 1
                ) -> torch.Tensor:
    """``x`` with its neighbours' ``halo`` planes along ``dim`` on both
    sides (zeros at the axis's ends), differentiable through
    :class:`HaloExchange`."""
    from_left, from_right = HaloExchange.apply(x, ax, halo, dim)
    return torch.cat([from_left, x, from_right], dim=dim)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of a group whose gradient is the sum of the
    ranks' gradients (each rank's loss is its own term of a sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(ax: MeshAxis, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of ``ax``, on every rank, with a
    gradient (the batch statistics of a sharded BatchNorm)."""
    return _AllReduceSum.apply(x, ax.group)


def _group(ax_or_group):
    return ax_or_group.group if isinstance(ax_or_group, MeshAxis) \
        else ax_or_group


def all_reduce_grads(ax_or_group, grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """``grads`` summed over the ranks of a ``MeshAxis`` (or a process
    group) as one flat float32 bucket, one ``all_reduce``, then cut back
    into their shapes.  The sum is reduced once and sent to every rank, so
    every rank gets the same bits."""
    flat = torch.cat([g.detach().reshape(-1).to(torch.float32)
                      for g in grads])
    dist.all_reduce(flat, group=_group(ax_or_group))
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return out


def broadcast_tensors_(ax: MeshAxis, tensors: Sequence[torch.Tensor],
                       src: int = 0) -> None:
    """Overwrite ``tensors`` in place with axis rank ``src``'s, bit for
    bit: one flat buffer of their bytes, one broadcast."""
    if not tensors:
        return
    buf = pack(tensors, ax.device)
    dist.broadcast(buf, ax.ranks[src], group=ax.group)
    with torch.no_grad():
        for t, v in zip(tensors, unpack(buf, spec_of(tensors))):
            t.copy_(v)


def lead_value(ax: MeshAxis, value: float) -> float:
    """Axis rank 0's ``value`` (a Python float) on every rank."""
    t = torch.tensor([value], dtype=torch.float64, device=ax.device)
    dist.broadcast(t, ax.ranks[0], group=ax.group)
    return float(t.item())


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
