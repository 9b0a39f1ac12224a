"""Data parallelism, FSDP, tensor parallelism and the device mesh over processes on `torch.distributed`
(counterpart of `trafficbotsv15_tpu/parallel/mesh.py`).

The JAX package shards the scenario axis of one global batch over a (data,
model) device mesh, places the parameters by strategy and lets GSPMD insert
the collectives. The port runs one process per device, as the reference's DDP
did:

    torchrun --nproc_per_node=N -m trafficbotsv15_tpu_torch.run action=fit ...

(or RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set by hand).
Each rank loads its own shard of the data and runs the step on its own
device; the functions here are the collectives that make N ranks compute
what one process computes on the union batch. Without a process group each
is the one-process identity. Backends: NCCL on the card, gloo on the CPU,
and gloo with CUDA tensors where the caller names it (ranks that share one
card, which NCCL refuses; the collectives stage such tensors on the host).

The mesh (`make_mesh`, for the body of a `with` block) is a `DeviceMesh` of
shape (n_data, n_model), ranks ordered host-major (`order_devices_for_slices`),
so that the model dimension stays inside a host as JAX keeps its model axis on
ICI. The ranks of one model group load the same rows and compute the same
step; the data dimension splits the batch. The strategies place parameters as
JAX's do (`fsdp_shard_params`, `tp_shard_params`, in the port's layout) and
`ShardedParams` keeps them so: each sharded parameter's local shard is what
the optimizer, the accumulator, the EMA and the SWA average own; a step
gathers the full values into the module's parameters before the forward
(`gather`), and reduces the gradients onto the shards after the backward
(`scatter_grads`). The module's parameters and gradients stay full on every
rank, so what fsdp and tp save is the optimizer state; tp gathers whole
weights at use, as GSPMD does around JAX's Pallas kernels, and does not split
the compute by heads.

Every collective here must be called by every rank, in the same order:
callers keep them out of branches that differ between ranks. A mesh that
leaves ranks out (uneven hosts) makes its own ranks the group of every
collective here inside its `with` block; the ranks it leaves out take no part.
"""

from __future__ import annotations

import collections
import contextlib
import os
import socket
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # the flat buckets of the gradient sum: DDP's default bucket size
DATA_AXIS, MODEL_AXIS = "data", "model"
STRATEGIES = ("dp", "fsdp", "tp")

# the group every collective of this module runs over: None for the whole world, else, inside its block, the ranks of a
# mesh that left ranks out (`make_mesh`)
_GROUP = None


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank among the ranks the collectives run over (0 without a process group)."""
    return dist.get_rank(_GROUP) if is_distributed() else 0


def process_count() -> int:
    """The number of ranks the collectives run over (1 without a process group)."""
    return dist.get_world_size(_GROUP) if is_distributed() else 1


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """Join the process group torchrun's environment describes (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    -> whether a group is up. Without RANK and WORLD_SIZE in the environment it does nothing (JAX's `:28-46`), and
    it leaves a group that is already up as it is. backend: None for NCCL where CUDA is available, else gloo."""
    if is_distributed():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"), init_method="env://")
    return True


def local_device() -> torch.device:
    """This rank's card, cuda:LOCAL_RANK (cuda:0 without torchrun). Raises where LOCAL_RANK is past the cards: ranks
    that share a card name it themselves."""
    rank, n = int(os.environ.get("LOCAL_RANK", "0")), torch.cuda.device_count()
    if not 0 <= rank < n:
        raise RuntimeError(f"LOCAL_RANK={rank} but {n} CUDA device(s): one rank per card, or name the device")
    return torch.device("cuda", rank)


def _comm_device() -> torch.device:
    """Where values travel for a collective: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _buckets(tensors: List[torch.Tensor]):
    """Runs of consecutive tensors of one dtype and device, each up to BUCKET_BYTES (a larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def _flat_collective(tensors: List[torch.Tensor], collective: Callable[[torch.Tensor], Any]) -> None:
    """collective(flat) in place on each bucket of tensors flattened into one on `_comm_device`, the result copied
    back."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket]).to(_comm_device())
        collective(flat)
        flat = flat.to(bucket[0].device)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in bucket]), bucket)])


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Sum every parameter's `.grad` over the ranks (of `group`, default all) in place, in flat buckets. A None
    gradient becomes zeros first, so every rank's buckets have the same shapes."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if process_count() > 1:
        _flat_collective([p.grad for p in params],
                         lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group or _GROUP))


@torch.no_grad()
def broadcast_params(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, in place."""
    if process_count() > 1:
        _flat_collective([*module.parameters(), *module.buffers()],
                         lambda flat: dist.broadcast(flat, src=0, group=_GROUP))


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over the ranks (of `group`, default all): a new tensor on x's device; x itself on one process."""
    if process_count() == 1:
        return x
    out = x.detach().to(_comm_device(), copy=True)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group or _GROUP)
    return out.to(x.device)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict, keys sorted: the same order on every rank."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def _gathered(flat: np.ndarray) -> np.ndarray:
    """[ranks, n]: every rank's float64 vector, in rank order, on every rank."""
    dev = _comm_device()
    mine = torch.from_numpy(flat).to(dev)
    out = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(out, mine, group=_GROUP)
    return torch.stack(out).cpu().numpy()


def cross_process_sum(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A nested dict of numbers, arrays and tensors summed over the ranks (JAX `eval/runner.py::_cross_host_sum`):
    every rank gets the same float64 numpy leaves, each the sum in rank order of the ranks' leaves. The ranks'
    trees must have the same keys and shapes (it raises otherwise). The tree itself on one process."""
    if process_count() == 1:
        return tree
    leaves = [(path, _host(x)) for path, x in _leaves(tree)]
    signature = [(path, v.shape) for path, v in leaves]
    signatures = [None] * process_count()
    dist.all_gather_object(signatures, signature, group=_GROUP)
    if any(s != signature for s in signatures):
        raise ValueError(f"cross_process_sum: the ranks' trees differ: {signatures}")
    flat = np.concatenate([v.reshape(-1) for _, v in leaves]) if leaves else np.zeros(0)
    total = _gathered(flat).sum(0)
    sizes = np.cumsum([0] + [v.size for _, v in leaves])
    summed = iter([total[a:b].reshape(v.shape) for (_, v), a, b in zip(leaves, sizes[:-1], sizes[1:])])

    def rebuild(node):  # the tree's own shape, its empty dicts included
        return {k: rebuild(node[k]) for k in sorted(node)} if isinstance(node, dict) else next(summed)

    return rebuild(tree)


def cross_process_max(x: float) -> float:
    """The largest of the ranks' x, the same float on every rank."""
    if process_count() == 1:
        return float(x)
    return float(_gathered(np.asarray([x], np.float64)).max())


def allgather_rows(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each key's row blocks concatenated over the ranks in rank order (JAX `eval/runner.py::_allgather_host_rows`):
    every rank gets every rank's rows. The blocks may differ in length. The dict itself on one process."""
    if process_count() == 1:
        return arrays
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, {k: np.asarray(v) for k, v in arrays.items()}, group=_GROUP)
    return {k: np.concatenate([g[k] for g in gathered]) for k in arrays}


def broadcast_object(obj):
    """Rank 0's picklable obj on every rank (obj itself on one process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_GROUP)
    return box[0]


def barrier() -> None:
    """Every rank waits here for the others (JAX `train/checkpoint.py::_barrier`)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(group=_GROUP, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=_GROUP)


def pad_batch_to_devices(batch: Dict[str, np.ndarray], n_devices: int):
    """Pad the scenario axis with zeros to a multiple of n_devices (padded scenarios have no valid agent and add
    nothing to any sum); -> (padded batch, the real scenario count)."""
    n_sc = next(iter(batch.values())).shape[0]
    rem = n_sc % n_devices
    if rem == 0:
        return batch, n_sc
    pad = n_devices - rem
    return {k: np.pad(np.asarray(v), [(0, pad)] + [(0, 0)] * (np.ndim(v) - 1)) for k, v in batch.items()}, n_sc


# -- the mesh (JAX `:49-162`) --------------------------------------------------------------------------------------
def order_devices_for_slices(devices: Sequence, slice_ids: Sequence[int], n_model: int):
    """Order devices slice-major for a mesh over several slices (in the port, ranks over hosts): the model dimension
    and the fast share of the data dimension inside a slice, the slices the outer blocks of the data dimension
    (JAX's own rule, word for word). -> (the devices in that order, truncated so that every slice gives the same
    count, a multiple of n_model; the data dimension's size). A slice smaller than n_model raises a ValueError; uneven
    slices warn."""
    groups = {}
    for d, s in zip(devices, slice_ids):
        groups.setdefault(s, []).append(d)
    per = min(len(g) for g in groups.values())
    per -= per % max(n_model, 1)
    if per == 0:
        raise ValueError(
            f"no usable devices: smallest slice has {min(len(g) for g in groups.values())} "
            f"device(s), fewer than n_model={n_model} — shrink the model axis or "
            f"exclude the undersized slice ({ {s: len(g) for s, g in groups.items()} })"
        )
    dropped = len(devices) - per * len(groups)
    if dropped:
        warnings.warn(
            f"uneven slices: truncating every slice to {per} devices, dropping "
            f"{dropped} of {len(devices)} ({ {s: len(g) for s, g in groups.items()} }) "
            "— the job will train on less hardware than provisioned",
            stacklevel=2,
        )
    order = [d for s in sorted(groups) for d in groups[s][:per]]
    return order, len(groups) * (per // max(n_model, 1))


def _slice_ids() -> List[int]:
    """Every rank's slice, in rank order: its host (torchrun's GROUP_RANK, else the host name), numbered in order of
    first appearance, so that rank 0's host is slice 0. A collective over the whole world."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, os.environ.get("GROUP_RANK") or socket.gethostname())
    ids = {}
    return [ids.setdefault(h, len(ids)) for h in hosts]


@contextlib.contextmanager
def make_mesh(n_model: int = 1):
    """with make_mesh(n_model) as mesh: the (data, model) mesh over the ranks for the body of the block, a `DeviceMesh`
    with dims ("data", "model"); None without a process group, and on a rank the mesh leaves out. Entering and leaving
    are collectives over the whole world.

    The ranks come host-major (`order_devices_for_slices` over `_slice_ids`), so that a model group stays inside a
    host; the data dim takes what that leaves. On one host, n_model must divide the ranks (a ValueError otherwise).
    Where hosts are uneven the mesh leaves ranks out, with JAX's warning: inside the block the mesh's ranks are the
    group of this module's collectives, and a rank left out takes no part. On leaving, the groups the mesh made are
    destroyed and the collectives run over the whole world again."""
    global _GROUP
    if n_model < 1:
        raise ValueError(f"parallel.model_axis must be at least 1, not {n_model}")
    if not is_distributed():
        if n_model != 1:
            raise ValueError(f"parallel.model_axis={n_model} does not divide the 1 rank: run under torchrun")
        yield None
        return
    world = dist.get_world_size()
    ranks, ids = list(range(world)), _slice_ids()
    if len(set(ids)) > 1:
        ranks, n_data = order_devices_for_slices(ranks, ids, n_model)
    elif world % n_model:
        raise ValueError(f"parallel.model_axis={n_model} does not divide the {world} ranks")
    else:
        n_data = world // n_model
    grid = np.asarray(ranks[:n_data * n_model]).reshape(n_data, n_model)
    # every rank makes every group, in the same order (new_group is a collective over the world); a data dim that
    # is the whole world in rank order keeps the world's group, as data parallel without a mesh does
    whole_world = grid.shape == (world, 1) and grid[:, 0].tolist() == list(range(world))
    data_groups = ([dist.group.WORLD] if whole_world else
                   [dist.new_group(grid[:, j].tolist()) for j in range(n_model)])
    model_groups = [dist.new_group(grid[i, :].tolist()) for i in range(n_data)]
    kept = dist.new_group(sorted(grid.ravel().tolist())) if grid.size < world else None
    me = dist.get_rank()
    if me not in grid:
        yield None
        return
    i, j = map(int, np.argwhere(grid == me)[0])
    made = [g for g in (None if whole_world else data_groups[j], model_groups[i], kept) if g is not None]
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group([data_groups[j], model_groups[i]], "cuda" if dist.get_backend() == "nccl" else "cpu",
                                 mesh=torch.as_tensor(grid), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    outer, _GROUP = _GROUP, kept
    try:
        yield mesh
    finally:
        _GROUP = outer
        for group in reversed(made):  # this rank's groups, in the same order on every rank
            dist.destroy_process_group(group)


def _dim_ranks(mesh, dim: str) -> List[int]:
    """The global ranks along `dim` through this rank, in mesh order."""
    i, j = mesh.get_coordinate()
    grid = mesh.mesh.tolist()
    return [row[j] for row in grid] if dim == DATA_AXIS else grid[i]


def dim_index(mesh, dim: str) -> int:
    """This rank's index along `dim` (for the data dim without a mesh, its rank among all)."""
    if mesh is None:
        return process_index() if dim == DATA_AXIS else 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(dim)]


def dim_count(mesh, dim: str) -> int:
    """The size of `dim` (for the data dim without a mesh, all ranks)."""
    if mesh is None:
        return process_count() if dim == DATA_AXIS else 1
    return mesh.size(mesh.mesh_dim_names.index(dim))


def dim_group(mesh, dim: str):
    """The process group of `dim` through this rank (without a mesh, the ranks of every collective here)."""
    return _GROUP if mesh is None else mesh.get_group(dim)


def data_index(mesh=None) -> int:
    return dim_index(mesh, DATA_AXIS)


def data_count(mesh=None) -> int:
    return dim_count(mesh, DATA_AXIS)


def model_index(mesh=None) -> int:
    return dim_index(mesh, MODEL_AXIS)


def model_count(mesh=None) -> int:
    return dim_count(mesh, MODEL_AXIS)


def batch_sharding(mesh=None) -> Dict[str, int]:
    """The loader's shard of this rank (JAX's batch_sharding: the scenario axis over the data dim): shard_index and
    num_shards of the data dim. The ranks of one model group load the same rows."""
    return dict(shard_index=data_index(mesh), num_shards=data_count(mesh))


def put_global(x, device) -> torch.Tensor:
    """One array of this rank's rows of the global batch as a tensor on `device` (each rank loads its own shard,
    so no rank sends another its rows)."""
    return x.to(device) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)).to(device)


SKIPPED_KEYS = ("scenario_bytes",)  # what a batch carries for the host alone (JAX's device_prefetch skips it too)


def _device_values(batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k not in SKIPPED_KEYS and not isinstance(v, list)}


def shard_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """put_global of every array of a batch, leaving out SKIPPED_KEYS and list values."""
    return {k: put_global(v, device) for k, v in _device_values(batch).items()}


def _order(group, ranks: List[int]) -> List[int]:
    """The group ranks of `ranks` (global, in mesh order): where a collective's per-rank results put each."""
    members = dist.get_process_group_ranks(group)
    return [members.index(r) for r in ranks]


@torch.no_grad()
def put_replicated(shards: Dict[str, torch.Tensor], axes: Dict[str, Tuple[int, str]], mesh) -> Dict[str, torch.Tensor]:
    """The full tensor of each shard on every rank (JAX's gather of sharded parameters before eval): shard `name`
    split the full tensor's axis axes[name][0] over mesh dim axes[name][1], this rank holding its index's part. A
    collective over each dim's group: every rank passes the same names, in the same order."""
    out = {}
    for dim in (DATA_AXIS, MODEL_AXIS):
        names = [n for n in shards if axes[n][1] == dim]
        if not names:
            continue
        group, n_ranks = dim_group(mesh, dim), dim_count(mesh, dim)
        order = _order(group, _dim_ranks(mesh, dim))
        tensors = [shards[n] for n in names]
        pieces = []
        for bucket in _buckets(tensors):
            flat = torch.cat([t.reshape(-1) for t in bucket]).to(_comm_device())
            parts = [torch.empty_like(flat) for _ in range(n_ranks)]
            dist.all_gather(parts, flat, group=group)
            per_rank = [parts[g].to(bucket[0].device).split([t.numel() for t in bucket]) for g in order]
            pieces += [[part[k].view_as(t) for part in per_rank] for k, t in enumerate(bucket)]
        for n, parts in zip(names, pieces):
            out[n] = torch.cat(parts, dim=axes[n][0])
    return out


@torch.no_grad()
def _reduce_scatter(fulls: Dict[str, torch.Tensor], axes: Dict[str, Tuple[int, str]], mesh, dim: str
                    ) -> Dict[str, torch.Tensor]:
    """Each full tensor summed over `dim`'s group, this rank keeping its index's part along its axis."""
    group, n_ranks, me = dim_group(mesh, dim), dim_count(mesh, dim), dim_index(mesh, dim)
    order = _order(group, _dim_ranks(mesh, dim))
    at = {g: k for k, g in enumerate(order)}  # group rank -> mesh index
    names = list(fulls)
    out = {}
    for bucket in _buckets([fulls[n] for n in names]):
        bnames, names = names[:len(bucket)], names[len(bucket):]
        chunks = [t.chunk(n_ranks, axes[n][0]) for n, t in zip(bnames, bucket)]
        flat = torch.cat([c[at[g]].reshape(-1) for g in range(n_ranks) for c in chunks]).to(_comm_device())
        mine = flat.new_empty(flat.numel() // n_ranks)
        dist.reduce_scatter_tensor(mine, flat, op=dist.ReduceOp.SUM, group=group)
        mine = mine.to(bucket[0].device).split([c[me].numel() for c in chunks])
        out.update({n: v.view(c[me].shape) for n, v, c in zip(bnames, mine, chunks)})
    return out


# -- the strategies' placements (JAX `:164-222`) --------------------------------------------------------------------
def _jax_view(name: str, shape) -> Tuple[List[str], Tuple[int, ...], Callable[[int], int]]:
    """(the flax path's keys, the flax leaf's shape, flax axis -> the port's axis) of the port parameter `name`
    (`utils/jax_import.py`'s map)."""
    from trafficbotsv15_tpu_torch.utils.jax_import import jax_leaf

    path, transposed = jax_leaf(name, len(shape))
    if transposed:
        return path.split("."), tuple(shape)[::-1], lambda a: len(shape) - 1 - a
    return path.split("."), tuple(shape), lambda a: a


Placement = Tuple[Optional[str], ...]  # per axis of the port's tensor: the mesh dim that splits it, or None


def _placement(ndim: int, axis: Optional[int], dim: str) -> Placement:
    return tuple(dim if a == axis else None for a in range(ndim))


def fsdp_shard_params(named_params: Iterable[Tuple[str, torch.Tensor]], n_data: int, min_size: int = 2 ** 14
                      ) -> Dict[str, Placement]:
    """Each parameter's placement under FSDP, JAX's decision: a parameter of at least min_size elements splits its
    largest flax axis (the first of equals) that n_data divides over the data dim; the rest stay replicated. The
    port's Dense weight is the flax kernel transposed, so its flax axis 0 is the port's axis 1."""
    out = {}
    for name, p in named_params:
        _, shape, to_port = _jax_view(name, p.shape)
        axis = None
        if p.numel() >= min_size:
            axis = next((to_port(a) for a in sorted(range(len(shape)), key=lambda a: -shape[a])
                         if shape[a] % n_data == 0), None)
        out[name] = _placement(p.ndim, axis, DATA_AXIS)
    return out


TP_COLUMN = ("q_proj", "kv_w", "kv_b", "rpe_proj_w", "rpe_proj_b", "ffn1")  # split the flax output (last) axis
TP_ROW = ("out_proj", "ffn2")  # split flax axis 0 (the input) of a kernel; their biases stay replicated


def tp_shard_params(named_params: Iterable[Tuple[str, torch.Tensor]], n_model: int) -> Dict[str, Placement]:
    """Each parameter's placement under tensor parallelism, JAX's decision: a parameter whose flax path has a
    column-parallel name in any key (by substring, as JAX matches) splits its last flax axis over the model dim, a
    row-parallel kernel its flax axis 0, where n_model divides it; the rest stay replicated. The fused kv_w [D, 2D]
    splits its 2D axis in contiguous halves: at n_model=2 the k half from the v half, not by heads (JAX's note)."""
    out = {}
    for name, p in named_params:
        keys, shape, to_port = _jax_view(name, p.shape)
        axis = None
        if p.ndim >= 1 and any(c in k for k in keys for c in TP_COLUMN):
            axis = to_port(p.ndim - 1) if shape[-1] % n_model == 0 else None
        elif p.ndim >= 2 and any(r in k for k in keys for r in TP_ROW):
            axis = to_port(0) if shape[0] % n_model == 0 else None
        out[name] = _placement(p.ndim, axis, MODEL_AXIS)
    return out


def strategy_placements(parallel_cfg, model: torch.nn.Module, mesh) -> Dict[str, Placement]:
    """The placement of every parameter of model under `parallel_cfg.strategy` on mesh."""
    if parallel_cfg.strategy not in STRATEGIES:
        raise ValueError(f"unknown parallel.strategy {parallel_cfg.strategy!r}: expected one of {STRATEGIES}")
    named = list(model.named_parameters())
    if parallel_cfg.strategy == "fsdp":
        return fsdp_shard_params(named, data_count(mesh), parallel_cfg.fsdp_min_size)
    if parallel_cfg.strategy == "tp":
        return tp_shard_params(named, model_count(mesh))
    return {n: (None,) * p.ndim for n, p in named}


class ShardedParams:
    """A module's parameters placed on the mesh. A sharded parameter's local shard (a Parameter of its own) is what
    the optimizer, the gradient accumulator, the EMA and the SWA average own; a replicated one is the module's own
    parameter. The module's parameters hold full values, written by `gather` before a forward.

    placements: name -> Placement (`strategy_placements`; a name it lacks is replicated); a parameter splits at most
    one axis, over one dim, whose size divides it. Without a mesh every parameter must be replicated (data parallel
    over all ranks, or one process)."""

    def __init__(self, model: torch.nn.Module, placements: Dict[str, Placement], mesh=None):
        self.mesh = mesh
        self.params = dict(model.named_parameters())
        self.axes: Dict[str, Tuple[int, str]] = {}
        for name, spec in placements.items():
            split = [(a, d) for a, d in enumerate(spec) if d is not None]
            if len(split) > 1:
                raise ValueError(f"{name}: placement {spec} splits more than one axis")
            if split:
                if mesh is None:
                    raise ValueError(f"{name}: a sharded placement {spec} needs a mesh")
                self.axes[name] = split[0]
        self.local: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in self.params.items():
                self.local[name] = torch.nn.Parameter(self.shard(name, p)) if name in self.axes else p

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a full tensor shaped like parameter `name` (a contiguous copy; `full` itself where
        the parameter is replicated)."""
        if name not in self.axes:
            return full
        axis, dim = self.axes[name]
        n, i = dim_count(self.mesh, dim), dim_index(self.mesh, dim)
        size = full.shape[axis] // n
        return full.detach().narrow(axis, i * size, size).clone(memory_format=torch.contiguous_format)

    def named_parameters(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, the tensor the optimizer owns), in the module's order."""
        return list(self.local.items())

    def parameters(self) -> List[torch.Tensor]:
        return list(self.local.values())

    @property
    def sharded(self) -> bool:
        return bool(self.axes)

    def dim(self, name: str) -> Optional[str]:
        """The mesh dim that splits parameter `name`, None where it is replicated."""
        return self.axes[name][1] if name in self.axes else None

    def full(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors shaped like the local parameters, by name, as full tensors on every rank (a collective)."""
        full = put_replicated({n: t for n, t in tensors.items() if n in self.axes}, self.axes, self.mesh)
        return {n: full.get(n, t) for n, t in tensors.items()}

    def local_of(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full tensors by name as this rank's parts (what `full` undoes)."""
        return {n: self.shard(n, t) for n, t in tensors.items()}

    @torch.no_grad()
    def gather(self) -> None:
        """Every sharded parameter's full value into the module's parameter (a collective)."""
        for name, t in self.full({n: self.local[n] for n in self.axes}).items():
            self.params[name].copy_(t)

    @torch.no_grad()
    def scatter_grads(self) -> None:
        """The module's gradients (one rank's share of the global batch's, after the backward) onto what the
        optimizer owns, each the global batch's: a gradient the data dim splits is reduce-scattered over it (a sum);
        one the model dim splits is this rank's part; every other and the model-split parts are summed over the data
        dim. The ranks of a model group computed the same rows: model index 0's gradients of all that the model dim
        does not split are taken on every rank of the group first, so that their replicas stay equal where the
        card's sums are not deterministic. None gradients count as zeros."""
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        mesh = self.mesh
        if model_count(mesh) > 1:
            src, group = _dim_ranks(mesh, MODEL_AXIS)[0], dim_group(mesh, MODEL_AXIS)
            _flat_collective([p.grad for n, p in self.params.items() if self.dim(n) != MODEL_AXIS],
                             lambda flat: dist.broadcast(flat, src=src, group=group))
        data_split = {n: self.params[n].grad for n in self.params if self.dim(n) == DATA_AXIS}
        if data_split:
            for n, g in _reduce_scatter(data_split, self.axes, mesh, DATA_AXIS).items():
                self.local[n].grad = g
        for n in self.params:
            if self.dim(n) == MODEL_AXIS:
                self.local[n].grad = self.shard(n, self.params[n].grad)
        if data_count(mesh) > 1:
            all_reduce_grads([self.local[n] for n in self.params if self.dim(n) != DATA_AXIS],
                             group=dim_group(mesh, DATA_AXIS))

    @torch.no_grad()
    def group_squares(self, param_groups) -> torch.Tensor:
        """[n_groups]: each optimizer group's squared gradient norm over the whole parameters: a shard's squares summed
        over the dim that splits it (a collective over that dim), a replicated gradient counted once."""
        dim_of = {id(t): self.dim(n) for n, t in self.local.items()}
        sums = {None: [], DATA_AXIS: [], MODEL_AXIS: []}
        for group in param_groups:
            squares = torch.stack(torch._foreach_norm([p.grad for p in group["params"]])).float().square()
            dims = [dim_of[id(p)] for p in group["params"]]
            for dim, out in sums.items():
                mask = torch.tensor([d == dim for d in dims], device=squares.device)
                out.append(torch.where(mask, squares, 0.0).sum())
        total = torch.stack(sums[None])
        for dim in sorted({d for _, d in self.axes.values()}):
            total = total + all_reduce_sum(torch.stack(sums[dim]), group=dim_group(self.mesh, dim))
        return total

    def optimizer_state(self, optimizer: torch.optim.Optimizer) -> dict:
        """optimizer.state_dict() with every moment of a sharded parameter as its full tensor (a collective): the
        placement-free state a checkpoint holds."""
        sd = optimizer.state_dict()
        names = self._names_by_index(optimizer)
        moments = {(i, k): v for i, s in sd["state"].items() for k, v in s.items()
                   if names[i] in self.axes and isinstance(v, torch.Tensor) and v.ndim}
        full = put_replicated(moments, {key: self.axes[names[key[0]]] for key in moments}, self.mesh)
        return {**sd, "state": {i: {k: full.get((i, k), v) for k, v in s.items()} for i, s in sd["state"].items()}}

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer, sd: dict) -> None:
        """optimizer.load_state_dict of a placement-free state (`optimizer_state`), each moment cut to this rank's
        part."""
        names = self._names_by_index(optimizer)
        state = {int(i): {k: self.shard(names[int(i)], v) if isinstance(v, torch.Tensor) and v.ndim else v
                          for k, v in s.items()} for i, s in sd["state"].items()}
        optimizer.load_state_dict({**sd, "state": state})

    def _names_by_index(self, optimizer: torch.optim.Optimizer) -> List[str]:
        name_of = {id(t): n for n, t in self.local.items()}
        return [name_of[id(p)] for group in optimizer.param_groups for p in group["params"]]


# -- device prefetch (JAX `:225-252`) ------------------------------------------------------------------------------
PREFETCH_DEPTH = 2  # batches in flight (JAX's device_prefetch size)


def device_prefetch(iterator, device):
    """The loader's batches as tensors on `device`, in its order, PREFETCH_DEPTH of them in flight (the pin_memory
    and prefetch of the reference's DataLoader): on the card each batch is copied from pinned host memory on a side
    stream, and the consumer's stream waits on that copy's event when the batch is handed out. On the CPU a plain
    placement, one batch at a time. SKIPPED_KEYS and list values are left out, as JAX's does."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield shard_batch(batch, device)
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        host = {k: put_global(v, "cpu").pin_memory() for k, v in _device_values(batch).items()}
        with torch.cuda.stream(stream):
            out = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            copied = torch.cuda.Event()
            copied.record(stream)
        return out, copied, host

    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == PREFETCH_DEPTH:
            break
    while queue:
        out, copied, _ = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for t in out.values():
            t.record_stream(consumer)  # allocated on the side stream, freed after the consumer's use
        yield out
