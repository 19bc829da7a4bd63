"""Logical-axis partitioning, as the reference names it, as DTensor
placements.

The counterpart of the reference's `repro/sharding/partitioning.py`
(`partitioning.py:24-77`). Every parameter and activation of the reference
is annotated with a tuple of *logical* axis names, and a rule table maps
each logical name to mesh axes; `sharding.policy.resolve` builds such a
table per cell. Mesh axes: ``pod`` (the slowest, pure data parallel),
``data`` (data parallel, FSDP shards) and ``model`` (tensor and expert
parallel).

`logical_spec` returns the tuple of mesh axes that the reference's
`PartitionSpec` holds. `logical_placements` turns it into one DTensor
`Placement` for each dimension of a `torch.distributed` DeviceMesh
(`launch/mesh.py::make_mesh`), which is what the reference's
`NamedSharding` is to JAX; `logical_sharding` pairs it with its mesh, and
`shard_params_spec` maps a tree of logical axes to a tree of specs.

`constrain` is the counterpart of `with_sharding_constraint`: under
``with mesh_context(mesh):`` (the reference's ``with mesh:``) it
redistributes a DTensor to the placements of its logical axes, and it is
the identity on a plain tensor or outside a mesh, so every one-card path
is unchanged.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Mapping, NamedTuple, Optional, Sequence

# Default rules: tensor parallel on "model", ZeRO-3-style parameter sharding
# of the non-TP dimension over "data", batch over ("pod", "data").
LOGICAL_RULES: dict[str, Optional[str | tuple]] = {
    "batch": ("pod", "data"),
    "attn_batch": ("pod", "data"),  # batch axis *during attention* (the
                                    # policy may extend it over "model")
    "seq": None,
    "kv_seq": None,              # K/V time axis inside attention
    "cache_seq": None,           # KV-cache time axis (flash-decoding)
    "seq_shard": "data",         # sequence parallelism, long-context decode
    "embed": None,
    "embed_fsdp": "data",        # ZeRO-3: shard hidden dim of big matrices
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "expert_cap": None,
    "layers": None,
    "rnn": "model",
    "conv": None,
}

# Pure tensor-parallel rules (no ZeRO): small models / serving.
TP_ONLY_RULES = dict(LOGICAL_RULES, embed_fsdp=None)

_MESHES: list = []          # the meshes of the open `mesh_context`s


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def logical_spec(axes: Sequence[Optional[str]],
                 rules: Mapping[str, Optional[str | tuple]] = LOGICAL_RULES
                 ) -> tuple:
    """Tuple of logical axis names -> tuple of mesh axes (None: not
    sharded), the entries of the reference's PartitionSpec."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def logical_placements(mesh, axes: Sequence[Optional[str]],
                       rules: Mapping[str, Optional[str | tuple]]
                       = LOGICAL_RULES) -> tuple:
    """One DTensor placement for each dimension of `mesh`: ``Shard(d)``
    where the rule of tensor dim d names that mesh axis (each axis of a
    tuple, which must follow the mesh's order), else ``Replicate()``.
    Raises ValueError for a mesh axis that the mesh lacks or that two
    tensor dims name, as `NamedSharding` refuses them."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(logical_spec(axes, rules)):
        group = (entry,) if isinstance(entry, str) else (entry or ())
        where = []
        for name in group:
            if name not in names:
                raise ValueError(f"logical axes {tuple(axes)}: mesh axis "
                                 f"{name!r} is not in the mesh {names}")
            i = names.index(name)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"logical axes {tuple(axes)}: mesh axis "
                                 f"{name!r} shards two tensor dims")
            out[i] = Shard(dim)
            where.append(i)
        if where != sorted(where):
            raise ValueError(f"logical axes {tuple(axes)}: mesh axes "
                             f"{group} of one dim are not in mesh order")
    return tuple(out)


class Sharding(NamedTuple):
    """A mesh and the placements of one tensor on it: the port's
    `NamedSharding` (``distribute_tensor(x, *sharding)``)."""
    mesh: object
    placements: tuple


def logical_sharding(mesh, axes: Sequence[Optional[str]],
                     rules=LOGICAL_RULES) -> Sharding:
    return Sharding(mesh, logical_placements(mesh, axes, rules))


def map_axes(fn, tree):
    """`fn` on every logical-axes tuple of a tree of dicts and lists."""
    if _is_axes(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_axes(fn, v) for v in tree]
    raise TypeError(f"not a tree of logical axes: {tree!r}")


def shard_params_spec(axes_tree, rules=LOGICAL_RULES):
    """A tree of logical-axis tuples -> the tree of their specs."""
    return map_axes(lambda ax: logical_spec(ax, rules), axes_tree)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make `mesh` the one `constrain` lays DTensors out on, and treat
    plain tensors met beside DTensors (positions, masks, frequencies, made
    alike on every rank) as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    return _MESHES[-1] if _MESHES else None


def constrain(x, *axes, rules=LOGICAL_RULES):
    """Redistribute the DTensor `x` to the placements of its logical
    `axes` on the current mesh (a reduction, gather or slice as the
    placements require); the identity on a plain tensor or outside a
    mesh. Inside `timed_redistributions` each one is timed."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return redistribute(x, mesh, logical_placements(mesh, axes, rules))


def redistribute(x, mesh, want):
    """The DTensor `x` redistributed to placements `want` on `mesh` (`x`
    itself where it has them). Inside `timed_redistributions` each one is
    timed."""
    want = tuple(want)
    if tuple(x.placements) == want:
        return x
    if not _TIMED:
        return x.redistribute(mesh, want)
    start = _event()
    y = x.redistribute(mesh, want)
    local = y._local_tensor
    if hasattr(local, "trigger_wait"):      # the collective, still running
        local.trigger_wait()
    _TIMED[-1].append((transition(x.placements, want), start, _event()))
    return y


def whole_over(x, axes):
    """The DTensor `x` with each of its shards on the mesh axes `axes` (a
    name, a tuple of names or None) gathered, its other placements kept:
    ZeRO-3's gather of a weight at its point of use, where `axes` is what
    ``embed_fsdp`` maps to. The identity on a plain tensor, outside a
    mesh, or where `x` is not sharded on `axes`. Its gradient goes back
    through the gather's transpose: a partial sum reduce-scattered onto
    the shards.

    A dim sharded over several of those axes (``dp_zero3``'s
    ``embed_fsdp`` = ("data", "model"): ``(Shard(d), Shard(d))``) is
    gathered by ONE all-gather over the axes taken together
    (`flat_group`), and its gradient reduce-scattered back by one
    (`_whole_over_flat`): DTensor (2.11, 2.13) redistributes such a nested
    shard one mesh dim at a time, two collectives each way, unless a
    flattened DeviceMesh of those dims exists, which would change its
    other redistributions too (see `flat_group`)."""
    from torch.distributed.tensor import Replicate

    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or not axes:
        return x
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    want = [Replicate() if name in names and p.is_shard() else p
            for name, p in zip(mesh.mesh_dim_names, x.placements)]
    dims = nested_dims(x.placements, want)
    if dims is not None:
        return _whole_over_flat().apply(x, dims)
    return redistribute(x, mesh, want)


def nested_dims(have, want):
    """The mesh dims (in mesh order) of a transition from placements
    `have` to `want` that is one tensor dim's nested shard over two or
    more mesh dims, all of them made whole (``want`` Replicate) or all
    made that shard from a partial sum (``have`` Partial("sum")), the other
    mesh dims untouched and not sharding that tensor dim; else None."""
    moved = [i for i, (a, b) in enumerate(zip(have, want)) if a != b]
    if len(moved) < 2 or any(have[i] != want[i] for i in range(len(have))
                             if i not in moved):
        return None
    if all(have[i].is_shard() and want[i].is_replicate() for i in moved):
        shard = [have[i] for i in moved]
    elif all(have[i].is_partial() and getattr(have[i], "reduce_op", None)
             == "sum" and want[i].is_shard() for i in moved):
        shard = [want[i] for i in moved]
    else:
        return None
    dim = shard[0].dim
    if any(type(s) is not type(shard[0]) or s.dim != dim for s in shard):
        return None
    if any(p.is_shard() and getattr(p, "dim", None) == dim
           for i, p in enumerate(have) if i not in moved):
        return None
    return tuple(moved)


def flat_group(mesh, dims):
    """The process group of `mesh`'s dims `dims` (mesh order) taken
    together, its ranks in the row-major order of their coordinates there,
    which is the order of a nested shard's chunks: one group for a
    collective over several mesh axes. Made once for each mesh (every rank
    makes every such group, as `torch.distributed.new_group` wants) and
    kept on it. Not a flattened DeviceMesh: DTensor would then merge its
    own redistributions over those dims, and issue other collectives than
    the same step on a mesh where no such group was made yet."""
    import torch.distributed as dist

    dims = tuple(dims)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    cache = mesh.__dict__.setdefault("_repro_flat_groups", {})
    if dims not in cache:
        rows = mesh.mesh.movedim(dims, tuple(range(-len(dims), 0)))
        rows = rows.reshape(-1, math.prod(mesh.size(i) for i in dims))
        me = dist.get_rank()
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                cache[dims] = group
    return cache[dims]


def _equal_chunks(shape, dim, n):
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(shape)} does not split into "
                         f"{n} equal shards")


def _gather_flat(local, dim: int, group):
    """The all-gather of each rank's `local` along tensor dim `dim` over
    `group`, in group-rank order: one `_c10d_functional` collective."""
    import torch

    ops = torch.ops._c10d_functional
    n = group.size()
    out = ops.wait_tensor(ops.all_gather_into_tensor(
        local.movedim(dim, 0).contiguous(), n, group.group_name))
    return out.movedim(0, dim).contiguous() if dim else out


def _reduce_scatter_flat(local, dim: int, group):
    """The sum of every rank's `local` over `group`, this rank's shard of
    it along tensor dim `dim` (group-rank order): one reduce-scatter."""
    import torch

    ops = torch.ops._c10d_functional
    n = group.size()
    _equal_chunks(local.shape, dim, n)
    out = ops.wait_tensor(ops.reduce_scatter_tensor(
        local.movedim(dim, 0).contiguous(), "sum", n, group.group_name))
    return out.movedim(0, dim).contiguous() if dim else out


def sum_over(t, mesh, dims):
    """The plain tensor `t` summed over `mesh`'s dims `dims` by one
    all-reduce over them together (`flat_group`); `t` where `dims` is
    empty."""
    import torch

    if not dims:
        return t
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(
        t.contiguous(), "sum", flat_group(mesh, dims).group_name))


def place(x, mesh, want):
    """`redistribute`, except that a partial sum made one tensor dim's
    nested shard over several mesh dims (a ZeRO-3 gradient under
    ``dp_zero3``, `nested_dims`) is one reduce-scatter over those dims
    together (`flat_group`), where DTensor would issue one for each."""
    from torch.distributed.tensor import DTensor

    want = tuple(want)
    dims = nested_dims(tuple(x.placements), want)
    if dims is None:
        return redistribute(x, mesh, want)
    local = _reduce_scatter_flat(x._local_tensor, want[dims[0]].dim,
                                flat_group(mesh, dims))
    return DTensor.from_local(local, mesh, want, run_check=False,
                              shape=x.shape, stride=x.stride())


@functools.cache
def _whole_over_flat():
    """`whole_over`'s autograd Function for a nested shard (made at first
    use): forward one all-gather over the shard's mesh dims together,
    backward its transpose, one reduce-scatter of the partial gradient
    (`place`). Timed inside `timed_redistributions` as `redistribute`
    times its own."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    class WholeOverFlat(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dims):
            mesh, places = x.device_mesh, tuple(x.placements)
            ctx.spec = (mesh, places)
            dim = places[dims[0]].dim
            n = math.prod(mesh.size(i) for i in dims)
            _equal_chunks(x.shape, dim, n)
            want = tuple(Replicate() if i in dims else p
                         for i, p in enumerate(places))
            start = _event() if _TIMED else None
            whole = _gather_flat(x._local_tensor, dim, flat_group(mesh, dims))
            if start is not None:
                _TIMED[-1].append((transition(places, want), start,
                                   _event()))
            return DTensor.from_local(whole, mesh, want, run_check=False,
                                      shape=x.shape, stride=x.stride())

        @staticmethod
        def backward(ctx, g):
            mesh, places = ctx.spec
            return place(g, mesh, places), None

    return WholeOverFlat


def grad_placed(x):
    """The DTensor `x` itself, its gradient redistributed in the backward
    to `x`'s own placements (the identity on anything else). DTensor's
    backward may leave a gradient a partial sum over "model" (each rank's
    share from its heads or vocabulary slice), which the transpose of a
    redistribution that made `x` whole cannot take: the embedding's, from
    DTensor's masked partial lookup (it raises), or a `layers.Summed`
    output's (it would take each rank's share for the whole). Placed
    after such a redistribution, this makes the gradient whole first."""
    if not is_dtensor(x):
        return x
    return _grad_placed().apply(x)


@functools.cache
def _grad_placed():
    """`grad_placed`'s autograd Function (made at first use: this module
    imports torch only where it needs it)."""
    import torch

    class GradPlaced(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.spec = (x.device_mesh, tuple(x.placements))
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            mesh, places = ctx.spec
            return redistribute(g, mesh, places)

    return GradPlaced


_TIMED: list = []           # the open `timed_redistributions` records


def transition(have, want) -> str:
    """The collective a redistribution from placements `have` to `want`
    issues: "all-reduce" (a partial sum made whole), "reduce-scatter" (a
    partial sum made a shard), "all-gather" (a shard made whole),
    "all-to-all" (a shard moved to another dim), joined by "+" where mesh
    dims differ, or "slice" (none: each rank keeps part of what it
    has)."""
    kinds = set()
    for a, b in zip(have, want):
        if a == b:
            continue
        if a.is_partial():
            kinds.add("reduce-scatter" if b.is_shard() else "all-reduce")
        elif a.is_shard():
            kinds.add("all-to-all" if b.is_shard() else "all-gather")
    return "+".join(sorted(kinds)) or "slice"


def _event():
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


@contextlib.contextmanager
def timed_redistributions():
    """CUDA events around every redistribution `constrain` makes in the
    block, each waited for before its end event (so that its time is the
    collective's on the card, not its launch). Yields the list of (kind,
    start, end) that `redistribution_ms` sums. The card only."""
    _TIMED.append([])
    try:
        yield _TIMED[-1]
    finally:
        _TIMED.pop()


def redistribution_ms(record) -> dict:
    """{kind: [count, milliseconds]} of a `timed_redistributions` record
    (the card synchronized first)."""
    import torch
    torch.cuda.synchronize()
    out: dict = {}
    for kind, start, end in record:
        n, ms = out.get(kind, (0, 0.0))
        out[kind] = (n + 1, ms + start.elapsed_time(end))
    return {k: list(v) for k, v in out.items()}


@contextlib.contextmanager
def local_ops_unrecorded():
    """The dispatch modes on top of the stack that watch only collectives
    (``skip_local_ops``: `launch/collective_stats.py::CollectiveRecorder`)
    set aside for the block: the plain local operations of a
    `layers.on_shards` function (a time loop's millions) issue none."""
    from torch.utils._python_dispatch import (_get_current_dispatch_mode,
                                              _pop_mode_temporarily)

    with contextlib.ExitStack() as stack:
        while getattr(_get_current_dispatch_mode(), "skip_local_ops", False):
            stack.enter_context(_pop_mode_temporarily())
        yield


def is_dtensor(x) -> bool:
    """Whether `x` is a DTensor (without importing DTensor for a plain
    tensor)."""
    if not hasattr(x, "placements"):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
