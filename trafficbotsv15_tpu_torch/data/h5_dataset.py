"""WOMD h5 dataset reading and a host-side prefetching loader (counterpart of
`trafficbotsv15_tpu/data/h5_dataset.py`, numpy only).

Reads the reference's packed h5 files (same group/key schema, same fixed tensor
sizes). The loader yields collated numpy batches in the JAX loader's order: one
permutation per epoch from `np.random.default_rng(seed + epoch)`, the same
stride shards, the same `set_epoch` / `iter_from` resume. `h5py` is imported
when a file is opened, not when this module is imported; without it, opening
an h5 file raises and names the package.
"""

from __future__ import annotations

import concurrent.futures as cf
import pickle
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from trafficbotsv15_tpu_torch.config import DataCfg


def import_h5py():
    """The h5py module, or an ImportError that says what needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the h5 data pipeline (data=h5, tbcache conversion) needs the h5py package, "
                          "which this Python does not have; convert the split to a tbcache file on a machine "
                          "that has it and use data=tbcache") from e
    return h5py


def tensor_size_train(c: DataCfg) -> Dict[str, Tuple[int, ...]]:
    """The train data contract (data_h5_womd.py:102-134)."""
    return {
        "agent/valid": (c.n_ag, c.n_step),
        "agent/pos": (c.n_ag, c.n_step, 3),
        "agent/vel": (c.n_ag, c.n_step, 2),
        "agent/spd": (c.n_ag, c.n_step, 1),
        "agent/acc": (c.n_ag, c.n_step, 1),
        "agent/yaw_bbox": (c.n_ag, c.n_step, 1),
        "agent/yaw_rate": (c.n_ag, c.n_step, 1),
        "agent/type": (c.n_ag, c.n_ag_type),
        "agent/cmd": (c.n_ag, c.n_ag_cmd),
        "agent/role": (c.n_ag, c.n_ag_role),
        "agent/size": (c.n_ag, 3),
        "agent/goal": (c.n_ag, 4),
        "agent/dest": (c.n_ag,),
        "map/valid": (c.n_mp, c.n_mp_pl_node),
        "map/type": (c.n_mp, c.n_mp_type),
        "map/pos": (c.n_mp, c.n_mp_pl_node, 3),
        "map/dir": (c.n_mp, c.n_mp_pl_node, 3),
        "map/boundary": (4,),
        "tl_lane/valid": (c.n_tl_lane, c.n_step),
        "tl_lane/state": (c.n_tl_lane, c.n_step, c.n_tl_state),
        "tl_lane/idx": (c.n_tl_lane,),
        "tl_stop/valid": (c.n_tl_stop, c.n_step),
        "tl_stop/state": (c.n_tl_stop, c.n_step, c.n_tl_state),
        "tl_stop/pos": (c.n_tl_stop, 3),
        "tl_stop/dir": (c.n_tl_stop, 3),
    }


def tensor_size_test(c: DataCfg) -> Dict[str, Tuple[int, ...]]:
    """The test data contract (data_h5_womd.py:136-173)."""
    h = c.n_step_history
    out = {
        "history/agent/object_id": (c.n_ag,),
        "history/agent_no_sim/object_id": (c.n_ag_no_sim,),
        "history/agent/valid": (c.n_ag, h),
        "history/agent/pos": (c.n_ag, h, 3),
        "history/agent/vel": (c.n_ag, h, 2),
        "history/agent/spd": (c.n_ag, h, 1),
        "history/agent/acc": (c.n_ag, h, 1),
        "history/agent/yaw_bbox": (c.n_ag, h, 1),
        "history/agent/yaw_rate": (c.n_ag, h, 1),
        "history/agent/type": (c.n_ag, c.n_ag_type),
        "history/agent/role": (c.n_ag, c.n_ag_role),
        "history/agent/size": (c.n_ag, 3),
        "history/agent_no_sim/valid": (c.n_ag_no_sim, h),
        "history/agent_no_sim/pos": (c.n_ag_no_sim, h, 3),
        "history/agent_no_sim/vel": (c.n_ag_no_sim, h, 2),
        "history/agent_no_sim/spd": (c.n_ag_no_sim, h, 1),
        "history/agent_no_sim/yaw_bbox": (c.n_ag_no_sim, h, 1),
        "history/agent_no_sim/type": (c.n_ag_no_sim, c.n_ag_type),
        "history/agent_no_sim/size": (c.n_ag_no_sim, 3),
        "map/valid": (c.n_mp, c.n_mp_pl_node),
        "map/type": (c.n_mp, c.n_mp_type),
        "map/pos": (c.n_mp, c.n_mp_pl_node, 3),
        "map/dir": (c.n_mp, c.n_mp_pl_node, 3),
        "map/boundary": (4,),
        "history/tl_lane/valid": (c.n_tl_lane, h),
        "history/tl_lane/state": (c.n_tl_lane, h, c.n_tl_state),
        "history/tl_lane/idx": (c.n_tl_lane,),
        "history/tl_stop/valid": (c.n_tl_stop, h),
        "history/tl_stop/state": (c.n_tl_stop, h, c.n_tl_state),
        "history/tl_stop/pos": (c.n_tl_stop, 3),
        "history/tl_stop/dir": (c.n_tl_stop, 3),
    }
    return out


def tensor_size_val(c: DataCfg) -> Dict[str, Tuple[int, ...]]:
    return {**tensor_size_train(c), **tensor_size_test(c)}


class H5Dataset:
    """One packed WOMD split. Thread-safe (per-read file handle, SWMR). With `scenario_dir`, item idx also
    carries `scenario_bytes`, the serialized scenario proto the official WOSAC metrics read, as uint8: the
    bytes pickled in `<scenario_dir>/<idx>.pickle` by the split's packing (trusted input: unpickling runs
    code)."""

    def __init__(self, h5_path: str, tensor_size: Dict[str, Tuple[int, ...]], scenario_dir: Optional[str] = None,
                 with_attrs: bool = False):
        h5py = import_h5py()
        self.h5_path = str(h5_path)
        self.tensor_size = tensor_size
        self.with_attrs = with_attrs
        with h5py.File(self.h5_path, "r", libver="latest", swmr=True) as hf:
            self.n = int(hf.attrs["data_len"])
        self.scenario_dir = Path(scenario_dir) if scenario_dir else None
        self._local = threading.local()

    def _file(self):
        if not hasattr(self._local, "hf"):
            self._local.hf = import_h5py().File(self.h5_path, "r", libver="latest", swmr=True)
        return self._local.hf

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        hf = self._file()
        g = hf[str(idx)]
        out: Dict[str, np.ndarray] = {"episode_idx": np.asarray(idx)}
        for k, size in self.tensor_size.items():
            arr = np.ascontiguousarray(g[k])
            if arr.shape != tuple(size):  # scalability test: fabricate dummy agents
                if "agent" not in k:
                    raise ValueError(f"{self.h5_path}[{idx}]/{k} is {arr.shape}, the schema says {tuple(size)}")
                arr = np.ones(size, dtype=arr.dtype)
            out[k] = arr
        if self.with_attrs:
            out["scenario_id"] = np.frombuffer(
                g.attrs["scenario_id"].encode()[:16].ljust(16, b"\0"), dtype=np.uint8
            ).copy() if isinstance(g.attrs["scenario_id"], str) else np.asarray(g.attrs["scenario_id"])
            out["scenario_center"] = np.asarray(g.attrs["scenario_center"], np.float32)
            out["scenario_yaw"] = np.asarray(g.attrs["scenario_yaw"], np.float32)
            out["with_map"] = np.asarray(g.attrs["with_map"])
        if self.scenario_dir is not None:
            with open(self.scenario_dir / f"{idx}.pickle", "rb") as f:
                out["scenario_bytes"] = np.frombuffer(pickle.load(f), dtype=np.uint8)
        return out


def _collate(items):
    """Stack each key's items; `scenario_bytes` are ragged and stay a list."""
    return {k: [it[k] for it in items] if k == "scenario_bytes" else np.stack([it[k] for it in items])
            for k in items[0]}


def shard_indices(idx: np.ndarray, shard_index: int, num_shards: int) -> np.ndarray:
    """Disjoint stride slice of an epoch permutation for one host (torch
    DistributedSampler semantics): wrap-pad by cycling the permutation so
    every shard has exactly ceil(n / num_shards) entries — unequal shards
    would desync the hosts' collectives. Shared by DataLoader and
    tbcache.TBCacheLoader."""
    if num_shards <= 1:
        return idx
    per = -(-len(idx) // num_shards)
    if per * num_shards != len(idx):
        idx = np.resize(idx, per * num_shards)  # cycles, even when pad > len
    return idx[shard_index::num_shards]


class DataLoader:
    """Thread-pool prefetching loader producing collated numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 4, shard_index: int = 0, num_shards: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        # multi-host sharding (torch DistributedSampler semantics): every host
        # draws the SAME epoch permutation (seed+epoch), takes a disjoint
        # stride slice of it, and pads by wrapping so all hosts run the same
        # number of batches (hosts must stay in lockstep for the collectives)
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.shard_index, self.num_shards = shard_index, num_shards

    def _shard_len(self) -> int:
        return -(-len(self.ds) // self.num_shards)

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to an absolute epoch number (torch
        DistributedSampler idiom) so a resumed run replays the same
        permutation the interrupted run used for that epoch."""
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate the epoch from batch `start_batch`: skipped batches are
        dropped from the index list without reading any data (mid-epoch
        resume would otherwise decode every skipped batch)."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        idx = shard_indices(idx, self.shard_index, self.num_shards)
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        batches = batches[start_batch:]

        if self.num_workers <= 0:
            for b in batches:
                yield _collate([self.ds[int(i)] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with cf.ThreadPoolExecutor(self.num_workers) as ex:
                futures = [ex.submit(lambda bb=b: _collate([self.ds[int(i)] for i in bb])) for b in batches]
                for f in futures:
                    if stop.is_set():
                        return
                    q.put(f.result())
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
