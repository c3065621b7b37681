"""The collectives of a mesh of ranks, and how a minibatch splits over them.

Every sum here is ``torch.distributed.all_reduce``. A gather of equal
blocks (``gather_blocks``) is ``all_gather_into_tensor`` under NCCL; under
gloo, which on CUDA tensors offers only ``all_reduce``, ``broadcast`` and
``barrier`` (two ranks on one card run over gloo: NCCL refuses a card
twice), it is an ``all_reduce`` into a buffer of zeros in which each rank
has written its own block (``place_and_sum``). A cycle's data generated in
parts is joined by ``gather_part``, bitwise under either backend.

A minibatch of ``B`` rows splits over the ``n`` ranks of a group in
contiguous blocks of ``ceil(B / n)`` rows (``BatchSplit.bounds``), as XLA
pads an uneven sharded axis: at batch 1 on two ranks the second holds no
row. A training step that splits its minibatch sets ``sharded_rows`` around
its forward; the modules whose training forward couples rows read it
(``current_rows``):

- ``models.embeddings.BatchNorm`` all-reduces (Σx, Σx², count) per channel
  before it normalises (its variance is ``mean(x²) − mean(x)²``, so the
  merge is exact up to the order of the sums);
- ``models.embeddings.DeepResNetEmbedding`` gathers the minibatch's rows
  and runs K2/K3 on all of them, then keeps its own rows' embedding, so
  every statistic inside the kernels is the global one. Its backward takes
  the gradient of its own rows only (zeros elsewhere): K3 is linear in that
  gradient, so the sum of the ranks' parameter gradients, which the step's
  all-reduce forms, is the gradient of the whole minibatch.

The differentiable collectives (``all_reduce_sum``, ``gather_rows``) have a
``torch.vmap`` rule that moves the vmapped axis to the front and calls the
collective once on the stacked tensor, so a model grid's step
(``train.grid``) makes one collective for all its members.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def place_and_sum(block: torch.Tensor, shape: Sequence[int], starts: Sequence[int], group) -> torch.Tensor:
    """A tensor of ``shape`` holding every rank's ``block`` at its
    ``starts`` (one start per leading axis of ``block``; the blocks do not
    overlap): zeros, this rank's block written, summed over ``group``."""
    buf = block.new_zeros(tuple(shape))
    view = buf
    for axis, (start, size) in enumerate(zip(starts, block.shape)):
        view = view.narrow(axis, start, size)
    view.copy_(block)
    return all_reduce_(buf, group)


def gather_blocks(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``block`` (one shape on every rank of ``group``),
    concatenated along axis 0 in the group's rank order, on every rank:
    ``all_gather_into_tensor`` under NCCL, ``place_and_sum`` otherwise
    (the same values: the sum adds zeros)."""
    block = block.contiguous()
    size, index = dist.get_world_size(group), dist.get_rank(group)
    shape = (size * block.shape[0],) + tuple(block.shape[1:])
    if dist.get_backend(group) == "nccl":
        out = block.new_empty(shape)
        dist.all_gather_into_tensor(out, block, group=group)
        return out
    return place_and_sum(block, shape, (index * block.shape[0],), group)


def gather_part(data, group, device, dim: int = 0):
    """The whole of a cycle whose ranks each generated a part
    (``parallel.mesh.GenerationPart``): ``data`` is this rank's part, a dict
    (or a tuple) of tensors whose blocks concatenate along ``dim`` (``None``
    where every rank has ``None``), or ``None`` on a rank with no unit.
    Returns on ``device`` of every rank of ``group`` each tensor's blocks
    concatenated in the group's rank order, bitwise the ranks' values. One
    gather of each rank's row count; only where a rank has no unit (more
    ranks than units), the first rank with one broadcasts its tensors'
    shapes and dtypes; then each tensor's bytes, every block padded to the
    largest (``gather_blocks``: under gloo a sum of bytes with zeros, exact
    whatever the values)."""
    as_tuple = isinstance(data, (tuple, list))
    items = dict(enumerate(data)) if as_tuple else data
    layout = None if items is None else {k: None if v is None else (tuple(v.shape), v.dtype) for k, v in items.items()}
    own = 0 if items is None else next(v.shape[dim] for v in items.values() if v is not None)
    rows = gather_blocks(torch.tensor([own], device=device), group).tolist()
    if 0 in rows:
        box = [layout]
        dist.broadcast_object_list(box, src=dist.get_global_rank(group, rows.index(max(rows))), group=group,
                                   device=device)
        layout = box[0]
    top = max(rows)
    out = {}
    for key, spec in layout.items():
        if spec is None:
            out[key] = None
            continue
        shape, dtype = spec
        block = torch.zeros((top,) + shape[:dim] + shape[dim + 1:], dtype=dtype, device=device)
        if own:
            block[:own] = items[key].movedim(dim, 0)
        whole = gather_blocks(block.view(torch.uint8), group).view(dtype).movedim(0, dim)
        out[key] = torch.cat([whole.narrow(dim, r * top, n) for r, n in enumerate(rows) if n], dim)
    return tuple(out.values()) if as_tuple else out


class _AllReduceSum(torch.autograd.Function):
    """``x`` summed over ``group``; the gradient of every rank's ``x`` is the
    sum of the ranks' output gradients."""

    @staticmethod
    def forward(x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        x = x.movedim(in_dims[0], 0) if in_dims[0] is not None else x
        return _AllReduceSum.apply(x, group), 0 if in_dims[0] is not None else None


class _GatherRows(torch.autograd.Function):
    """The rows of every rank along ``dim``: ``x`` (this rank's ``n`` rows)
    written at ``lo`` of ``total`` in zeros, whose bytes are summed over
    ``group`` (exact in any dtype and on any backend: each byte is one
    rank's, the others add 0; a bf16 minibatch too). Backward: the output
    gradient summed over the group, this rank's rows of it."""

    @staticmethod
    def forward(x, lo, total, group, dim):
        shape = list(x.shape)
        shape[dim] = total
        buf = x.new_zeros(shape)
        buf.narrow(dim, lo, x.shape[dim]).copy_(x)
        all_reduce_(buf.view(torch.uint8), group)
        return buf

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.lo, _, ctx.group, ctx.dim = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, lo, total, group, dim):
        if in_dims[0] is None:
            return _GatherRows.apply(x, lo, total, group, dim), None
        return _GatherRows.apply(x.movedim(in_dims[0], 0), lo, total, group, dim + 1), 0


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (a ``torch.vmap`` rule
    makes one collective for every vmapped member)."""
    return _AllReduceSum.apply(x, group)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[lo, hi)`` of a minibatch of ``total`` rows split
    over ``group``."""

    group: Any
    lo: int
    hi: int
    total: int


def gather_rows(x: torch.Tensor, rows: RowShard, dim: int = 0) -> torch.Tensor:
    """Differentiable gather of a split minibatch: every rank's rows of
    ``x`` along ``dim`` (``rows.total`` of them), this rank's at
    ``rows.lo``."""
    return _GatherRows.apply(x, rows.lo, rows.total, rows.group, dim)


_ROWS: contextvars.ContextVar[Optional[RowShard]] = contextvars.ContextVar("mivit_sharded_rows", default=None)


@contextlib.contextmanager
def sharded_rows(rows: Optional[RowShard]):
    """Within the block, the training forward of a module that couples rows
    sees ``rows`` (``current_rows``): this rank holds ``rows.lo:rows.hi`` of
    the minibatch. ``None``: the rank holds the whole minibatch."""
    token = _ROWS.set(rows)
    try:
        yield
    finally:
        _ROWS.reset(token)


def current_rows() -> Optional[RowShard]:
    """The split set by the innermost ``sharded_rows``, or ``None``."""
    return _ROWS.get()


@dataclasses.dataclass(frozen=True)
class BatchSplit:
    """A minibatch split over the ``size`` ranks of ``group``, this rank at
    position ``index`` (``parallel.steps.grid_batch_constraint``,
    ``dp_batch_constraint``): what ``train.loop`` and ``train.grid`` take as
    ``constrain_batch``. The step keeps this rank's rows (``bounds``),
    back-propagates its share of the minibatch mean and sums the gradients
    and the loss over the group (``reduce``), so every rank applies the same
    AdamW update."""

    group: Any
    index: int
    size: int

    def bounds(self, total: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of ``total``: blocks of
        ``ceil(total / size)``, the last ones short or empty."""
        chunk = -(-total // self.size)
        lo = min(self.index * chunk, total)
        return lo, min(lo + chunk, total)

    def rows(self, total: int) -> Optional[RowShard]:
        """The ``sharded_rows`` of a minibatch of ``total`` rows; ``None`` on
        a group of one rank, whose modules then run as unsplit."""
        if self.size == 1:
            return None
        return RowShard(self.group, *self.bounds(total), total)

    def reduce(self, params: Iterable[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """Sum every defined gradient of ``params`` (in place) and ``loss``
        over the group in one all-reduce; returns the summed loss. Every
        rank's graph is the same, so the same gradients are defined on
        each."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(-1).to(grads[0].dtype)])
        all_reduce_(flat, self.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset:].view_as(loss).to(loss.dtype)


def loss_share(full_loss, pred: torch.Tensor, rows: int, total: int) -> torch.Tensor:
    """This rank's share of a minibatch mean loss: ``full_loss(pred)`` (the
    mean over its ``rows`` rows) × ``rows / total``, so the ranks' shares
    sum to the mean over all ``total``. The whole minibatch: the mean
    itself. No row: zero, still a function of ``pred`` (the rank joins the
    backward's collectives like the others)."""
    if rows == total:
        return full_loss(pred)
    if rows == 0:
        return pred.sum() * 0.0
    return full_loss(pred) * (rows / total)
