"""Data parallelism over processes on `torch.distributed` (counterpart of `trafficbotsv15_tpu/parallel/mesh.py`,
its `dp` strategy).

The JAX package shards the scenario axis of one global batch over a device
mesh, replicates the parameters and lets GSPMD insert the gradient sum. The
port runs one process per device, as the reference's DDP did:

    torchrun --nproc_per_node=N -m trafficbotsv15_tpu_torch.run action=fit ...

(or RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT set by hand).
Each rank loads its own shard of the data and runs the step on its own
device; the functions here are the collectives that make N ranks compute
what one process computes on the union batch. Without a process group each
is the one-process identity. Backends: NCCL on the card, gloo on the CPU,
and gloo with CUDA tensors where the caller names it (ranks that share one
card, which NCCL refuses).

Every collective here must be called by every rank, in the same order:
callers keep them out of branches that differ between ranks.

`make_mesh`, `batch_sharding`, `put_global`, `fsdp_shard_params`,
`tp_shard_params` and `order_devices_for_slices` (FSDP, tensor parallelism
and the hybrid device order) are ROADMAP A10b.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # the flat buckets of the gradient sum: DDP's default bucket size


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


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
    """Where host values travel for a collective: the current card under NCCL, else the CPU."""
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
    """collective(flat) in place on each bucket of tensors flattened into one, the result copied back."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in bucket]), bucket)])


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's `.grad` over the ranks in place, in flat buckets. A None gradient becomes zeros first,
    so every rank's buckets have the same shapes."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if process_count() > 1:
        _flat_collective([p.grad for p in params], lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM))


@torch.no_grad()
def broadcast_params(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank, in place."""
    if process_count() > 1:
        _flat_collective([*module.parameters(), *module.buffers()], lambda flat: dist.broadcast(flat, src=0))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (a new tensor on x's device; x itself on one process)."""
    if process_count() == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


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
    dist.all_gather(out, mine)
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
    dist.all_gather_object(signatures, signature)
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
    dist.all_gather_object(gathered, {k: np.asarray(v) for k, v in arrays.items()})
    return {k: np.concatenate([g[k] for g in gathered]) for k in arrays}


def broadcast_object(obj):
    """Rank 0's picklable obj on every rank (obj itself on one process)."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Every rank waits here for the others (JAX `train/checkpoint.py::_barrier`)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def pad_batch_to_devices(batch: Dict[str, np.ndarray], n_devices: int):
    """Pad the scenario axis with zeros to a multiple of n_devices (padded scenarios have no valid agent and add
    nothing to any sum); -> (padded batch, the real scenario count)."""
    n_sc = next(iter(batch.values())).shape[0]
    rem = n_sc % n_devices
    if rem == 0:
        return batch, n_sc
    pad = n_devices - rem
    return {k: np.pad(np.asarray(v), [(0, pad)] + [(0, 0)] * (np.ndim(v) - 1)) for k, v in batch.items()}, n_sc
