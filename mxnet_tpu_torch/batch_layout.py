"""Where the batch sits in the arrays of a graph bound over several
contexts (ROADMAP.md Queue A item 10a).

Each replica of an executor group computes every array of the graph
over its own slice of the batch; the JAX package's arrays are global.
To join the replicas' outputs in the global order (and to cut a global
head gradient into the replicas' parts), each array's *layout* says how
its rows follow the batch. A layout is a tuple over the array's axes;
each axis is a tuple of factors ``(size, is_batch)``, outermost first,
whose product is the axis's global length. At most one factor in the
whole array is the batch (its size the global batch's rows there); an
array with none does not follow the batch (a parameter, or a value the
cross-card form of an op made global, such as a ``sum`` over the batch).
A ``(T, N, C)`` output in layout TNC is ``((T, 0), (N, 1), (C, 0))``; the
same output reshaped to ``(T * N, C)`` is ``(((T, 0), (N, 1)), ((C,
0),))``: its rows are time-major, ``t * N + n``.

:func:`derive` propagates the layouts from the data and label inputs
through the graph at bind time: ``Reshape``, ``Flatten`` and
``expand_dims`` regroup the factors, ``transpose`` and ``SwapAxis``
permute the axes, ``Concat`` along an axis that holds the batch puts a
factor before it, ``SliceChannel`` divides an axis's outer factor; any
other op's output takes, along each axis whose length follows the batch,
the factors of an input's axis of that length that holds the batch, or
is the batch itself when no input's axis matches. An array whose layout
cannot be derived gets None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .base import MXNetError

Factor = Tuple[int, bool]
Layout = Tuple[Tuple[Factor, ...], ...]

__all__ = ["batch_axis", "derive", "follows_batch", "join", "part"]


def follows_batch(layout: Layout) -> bool:
    """True where one of the layout's factors is the batch."""
    return any(b for axis in layout for _, b in axis)


def batch_axis(layout, op_name: str) -> Optional[int]:
    """The axis of ``layout`` that holds the batch, alone or flattened
    with other factors; None where the array does not follow the batch.
    An int ``layout`` is that axis itself (a walk with no layouts passes
    0). A layout the graph does not determine (None) raises, naming
    ``op_name``."""
    if isinstance(layout, int):
        return layout
    if layout is None:
        raise MXNetError("%s over several contexts: how its input's rows "
                         "follow the batch cannot be derived from the "
                         "graph; bind it on one context" % op_name)
    for a, axis in enumerate(layout):
        if any(b for _, b in axis):
            return a
    return None


def _plain(shape, batch_axis=None) -> Layout:
    return tuple(((int(s), i == batch_axis),) for i, s in enumerate(shape))


def _regroup(layout: Layout, shape) -> Optional[Layout]:
    """``layout``'s factors, in order, grouped into the axes of ``shape``
    (a reshape): a factor that is not the batch may be cut where an axis
    ends inside it; None where the batch would be cut or the sizes do not
    fit."""
    queue = [f for axis in layout for f in axis if f[0] != 1 or f[1]]
    out = []
    for s in shape:
        axis, prod = [], 1
        while prod < s:
            if not queue or s % prod:
                return None
            size, b = queue.pop(0)
            if s % (prod * size) == 0:
                axis.append((size, b))
                prod *= size
                continue
            need = s // prod
            if b or size % need:
                return None
            axis.append((need, False))
            prod *= need
            queue.insert(0, (size // need, False))
        if prod != s:
            return None
        out.append(tuple(axis) or ((1, False),))
    return None if queue else tuple(out)


def _concat(layouts, dim, out_len) -> Optional[Layout]:
    first = layouts[0]
    if any(lay is None or len(lay) != len(first) for lay in layouts):
        return None
    if any(b for _, b in first[dim]):
        # joined along an axis that holds the batch: every part alike,
        # the parts become a factor outside it (time steps, time-major)
        if any(lay != first for lay in layouts):
            return None
        return first[:dim] + (((len(layouts), False),) + first[dim],) \
            + first[dim + 1:]
    rest = [lay[:dim] + lay[dim + 1:] for lay in layouts]
    if any(r != rest[0] for r in rest) or any(
            b for lay in layouts for _, b in lay[dim]):
        return None
    return first[:dim] + (((out_len, False),),) + first[dim + 1:]


def _slice_channel(layout, op, n_out) -> List[Optional[Layout]]:
    axis = op.axis % len(layout)
    (size, b), rest = layout[axis][0], layout[axis][1:]
    if b or size % n_out:
        return [None] * n_out
    head = ((size // n_out, False),) if size // n_out != 1 or not rest \
        else ()
    new = head + rest
    if op.squeeze_axis and _length(new) == 1:
        out = layout[:axis] + layout[axis + 1:]
    else:
        out = layout[:axis] + (new,) + layout[axis + 1:]
    return [out] * n_out


def _follow(ins, local, whole, n) -> Optional[Layout]:
    """Any other op's output of ``local`` / ``whole`` shape: the axes
    whose length follows the batch take an input axis's factors."""
    if len(local) != len(whole):
        return None
    out, batched = [], 0
    for a, (mine, glob) in enumerate(zip(local, whole)):
        if mine == glob:
            out.append(((int(glob), False),))
            continue
        found = None
        for lay in ins:
            if lay is None:
                continue
            cands = [ax for ax in lay if any(b for _, b in ax)
                     and _length(ax) == glob]
            if cands:
                found = cands[0]
                break
        if found is None:
            if glob != n * mine:
                return None
            found = ((int(glob), True),)
        out.append(found)
        batched += 1
    return tuple(out) if batched <= 1 else None


def _length(axis) -> int:
    p = 1
    for size, _ in axis:
        p *= size
    return p


def derive(symbol, local: Dict[str, tuple], whole: Dict[str, tuple],
           axes: Dict[str, int], n: int):
    """``{(node uid, output): layout or None}`` for every array of
    ``symbol``, from the inputs' shapes over a replica's slice
    (``local``) and over the global batch (``whole``) and each input's
    batch axis (``axes``); ``n`` replicas."""
    internals = symbol.get_internals()
    keys = [(node.uid, i) for node, i in internals._outputs]
    try:
        _, loc, _ = internals.infer_shape(**local)
        _, glob, _ = internals.infer_shape(**whole)
    except MXNetError:
        return {k: None for k in keys}
    shape_of = {k: (tuple(a), tuple(b)) for k, a, b in zip(keys, loc, glob)}
    out = {}
    for node in symbol._topo():
        if node.is_variable:
            mine, glob_s = shape_of[(node.uid, 0)]
            out[(node.uid, 0)] = _plain(glob_s, axes.get(node.name))
            continue
        ins = [out.get((src.uid, i)) for src, i in node.inputs]
        shapes = [shape_of[(node.uid, j)] for j in range(node.num_outputs())]
        name = node.op.op_name
        if name in ("Reshape", "Flatten", "expand_dims"):
            lays = [None if ins[0] is None else _regroup(ins[0], shapes[0][1])]
        elif name in ("transpose", "SwapAxis"):
            lay = ins[0]
            if lay is not None:
                perm = list(range(len(lay)))
                if name == "transpose":
                    perm = list(node.op.axes or reversed(perm))
                else:
                    perm[node.op.dim1], perm[node.op.dim2] = \
                        perm[node.op.dim2], perm[node.op.dim1]
                lay = tuple(lay[p] for p in perm)
            lays = [lay]
        elif name == "Concat":
            dim = node.op.dim % len(shapes[0][1])
            lays = [_concat(ins, dim, shapes[0][1][dim])]
        elif name == "SliceChannel":
            lays = ([None] * node.num_outputs() if ins[0] is None else
                    _slice_channel(ins[0], node.op, node.num_outputs()))
        else:
            lays = [_follow(ins, m, g, n) for m, g in shapes]
        for j, (lay, (_, glob_s)) in enumerate(zip(lays, shapes)):
            if lay is not None and tuple(_length(ax) for ax in lay) \
                    != tuple(glob_s):
                lay = None
            out[(node.uid, j)] = lay
    return out


def _factored(layout):
    """The factors' sizes as one shape, the batch's as -1, and its
    position (None where the layout does not follow the batch)."""
    sizes, pos = [], None
    for axis in layout:
        for size, b in axis:
            if b:
                pos = len(sizes)
            sizes.append(-1 if b else size)
    return sizes, pos


def _grouped(t, layout):
    """A factored tensor back to the layout's axes."""
    shape, i = [], 0
    for axis in layout:
        p = 1
        for _ in axis:
            p *= t.shape[i]
            i += 1
        shape.append(p)
    return t.reshape(shape)


def join(tensors, layout: Layout, device=None) -> torch.Tensor:
    """The replicas' parts of one array (one a replica, in order) joined
    in the global order on ``device`` (the first part's by default); an
    array that does not follow the batch is the first part."""
    device = device if device is not None else tensors[0].device
    sizes, pos = _factored(layout)
    if pos is None:
        return tensors[0].to(device)
    return _grouped(torch.cat([t.to(device).reshape(sizes)
                               for t in tensors], dim=pos), layout)


def part(t, layout: Layout, k: int, n: int) -> torch.Tensor:
    """Replica ``k``'s part (of ``n``) of a global array ``t``."""
    sizes, pos = _factored(layout)
    f = t.reshape(sizes)
    rows = f.shape[pos] // n
    return _grouped(f.narrow(pos, k * rows, rows), layout)
