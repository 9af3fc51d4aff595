"""The collectives of the parallel layer, on torch.distributed.

Counterparts of the JAX collectives that parallel/ring.py and
parallel/sharded.py use inside `shard_map`:

  Rotation      -- `jax.lax.ppermute` around a ring (batch_isend_irecv),
                   posted before the step's compute and collected after it;
                   differentiable: the gradient rotates back (ppermute's
                   transpose)
  all_to_all    -- `jax.lax.all_to_all(..., tiled=True)` (all_to_all_single)
  all_gather    -- `jax.lax.all_gather(..., tiled=True)` (all_gather);
                   both differentiable
  all_reduce    -- `jax.lax.psum` over one mesh axis (all_reduce): the
                   row-parallel sums of the sharded paths (megatron's g,
                   after wo and after w_down); differentiable: its
                   gradient is the identity (psum's transpose under
                   shard_map: the cotangent of a replicated sum is itself
                   replicated)
  enter_model   -- megatron's f, at the input of each column-cut product:
                   the identity forward, an all-reduce of the gradient
                   over the model axis backward (what GSPMD inserts for
                   JAX's sharded train step)
  take_shard / gather_shards -- a shard_map's in_specs and out_specs on
                   one mesh axis: this rank's block of a global tensor, and
                   the global tensor from every rank's block; each is the
                   other's gradient

gloo moves host memory only. On gloo a CUDA tensor is copied to the host,
sent, and the received bytes copied back to the card, by one code path that
adds every byte it copies, both ways, to `host_staged_bytes`. On NCCL
nothing is staged.

A group of one rank makes no collective (GSPMD inserts none on an axis of
size 1 either): all_reduce copies, enter_model passes its gradient on.
Every backward that makes a collective runs on every rank of its group in
the same order, since every rank runs the same graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# bytes copied between the card and host memory for gloo (both directions)
host_staged_bytes = 0


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    global host_staged_bytes
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host_staged_bytes += t.nbytes
        return t.cpu()
    return t


def _from_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    global host_staged_bytes
    if t.device != device:
        host_staged_bytes += t.nbytes
        return t.to(device)
    return t


class Rotation:
    """One step of a ring: every rank sends `tensors` to the rank `shift`
    places on in `group` and receives as many tensors of the same shapes
    from the rank `shift` places back. The transfers are posted when the
    object is made; `wait()` returns the received tensors."""

    def __init__(self, tensors, group, shift: int = 1):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        dst = dist.get_global_rank(group, (me + shift) % n)
        src = dist.get_global_rank(group, (me - shift) % n)
        self.sent = tuple(tensors)
        self.group, self.shift = group, shift
        self._wire = [_to_wire(t, group) for t in self.sent]
        self._recv = [torch.empty_like(w) for w in self._wire]
        self._works = dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, w, dst, group) for w in self._wire]
            + [dist.P2POp(dist.irecv, r, src, group) for r in self._recv])

    def wait(self) -> tuple:
        """The received tensors, on the devices of the sent ones; through
        autograd, their gradients rotate back to the senders."""
        return _Rotate.apply(self, *self.sent)

    def _received(self) -> tuple:
        for w in self._works:
            w.wait()
        return tuple(_from_wire(r, t.device)
                     for r, t in zip(self._recv, self.sent))


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rotation, *tensors):
        ctx.group, ctx.shift = rotation.group, rotation.shift
        return rotation._received()

    @staticmethod
    def backward(ctx, *grads):
        back = Rotation(grads, ctx.group, -ctx.shift)._received()
        return (None, *back)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of {tuple(x.shape)} does not "
                         f"split into {n} blocks")
    send = _to_wire(torch.stack(x.chunk(n, split_axis)), group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return _from_wire(recv, x.device)


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    send = _to_wire(x, group)
    recv = [torch.empty_like(send)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(recv, send, group=group)
    return torch.cat([_from_wire(r, x.device) for r in recv], axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return torch.cat(_all_to_all(x, group, split_axis, concat_axis)
                         .unbind(0), concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (torch.cat(_all_to_all(g, group, concat_axis, split_axis)
                          .unbind(0), split_axis), None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        # the transpose is a reduce-scatter: every rank's gradient of this
        # rank's block, summed
        return _all_to_all(g, ctx.group, ctx.axis, ctx.axis).sum(0), None, \
            None


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True): x
    cut into n blocks along split_axis, block j sent to rank j; the blocks
    received from ranks 0..n-1 concatenated along concat_axis. Its gradient
    is the all-to-all back."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """jax.lax.all_gather(x, axis_name, axis=axis, tiled=True): every rank's
    x concatenated along `axis` in rank order. Its gradient is the sum over
    the ranks of their gradients of this rank's block."""
    return _AllGather.apply(x, group, axis)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    wire = _to_wire(x, group)
    if wire.data_ptr() == x.data_ptr():
        wire = wire.clone()
    dist.all_reduce(wire, group=group)
    return _from_wire(wire, x.device)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.float(), ctx.group).to(g.dtype), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """jax.lax.psum(x, axis_name) over the ranks of `group`: the sum of
    every rank's x, a new tensor (x is left as it is), the same bits on
    every rank (tests/test_torch_serve_sharded.py holds gloo to that).
    Its gradient is the identity: each rank's x gets the gradient of the
    sum, which is the same on every rank of a replicated computation."""
    if dist.get_world_size(group) == 1:
        return x.clone()
    return _AllReduce.apply(x, group)


def enter_model(x: torch.Tensor, group) -> torch.Tensor:
    """x itself, as the input of the column-cut products (wq, wk, wv,
    w_gate, w_up) of the model axis `group`. Each rank's product reads only
    its columns, so the gradient of x it makes is partial: the backward
    sums it over the group in f32 and rounds once to its dtype, so every
    rank gets the whole gradient of x, the same bits on each."""
    if dist.get_world_size(group) == 1:
        return x
    return _EnterModel.apply(x, group)


def _block(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    n, me = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    size = x.shape[axis] // n
    # a copy, not a view: an autograd Function's output is a new tensor
    return x.narrow(axis, me * size, size).clone(
        memory_format=torch.contiguous_format)


class _TakeShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _block(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.axis), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group, ctx.axis), None, None


def take_shard(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """This rank's block of x along `axis` (x the same on every rank of the
    group): an in_spec of a shard_map. Its gradient gathers every rank's."""
    return _TakeShard.apply(x, group, axis)


def gather_shards(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """The global tensor from every rank's block along `axis`: an out_spec
    of a shard_map, the same on every rank. Its gradient is this rank's
    block of the global gradient."""
    return _GatherShards.apply(x, group, axis)
