"""TBCache: a flat binary episode cache, its writer and its reader (counterpart of
`trafficbotsv15_tpu/data/tbcache.py`, numpy only).

The file holds fixed-size records, one per episode, behind a header that names
each field's dtype, shape and offset (`csrc/tbcache.cc` documents the layout).
The reader is the C++ engine of `csrc/tbcache.cc`: it maps the file and fills a
batch with a thread pool. The engine is built with g++ on first use into
`build/libtbcache-<hash>.so` (`utils/build.py::load_host`); a failed build or
load raises, and there is no Python reader to fall back to. The format is the
JAX package's, so a file either package writes reads in the other byte for byte.

    python -m trafficbotsv15_tpu_torch.data.tbcache convert <in.h5> <out.tbcache> [train|val|test]

converts a packed WOMD h5 split (needs h5py).
"""

from __future__ import annotations

import ctypes
import struct
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from trafficbotsv15_tpu_torch.data.h5_dataset import import_h5py, shard_indices
from trafficbotsv15_tpu_torch.utils import build

_MAGIC = 0x54424341434845
_VERSION = 1
_DTYPES = [np.float32, np.float16, np.int64, np.bool_, np.int32, np.float64]
_DTYPE_CODE = {np.dtype(d): i for i, d in enumerate(_DTYPES)}
_MAX_DIMS = 16

_lib_lock = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Build csrc/tbcache.cc if needed, load it once per process and declare its C interface."""
    with _lib_lock:
        lib = build.load_host("tbcache", "tbcache.cc")
        lib.tbc_open.restype = ctypes.c_void_p
        lib.tbc_open.argtypes = [ctypes.c_char_p]
        lib.tbc_n_episodes.restype = ctypes.c_int64
        lib.tbc_n_episodes.argtypes = [ctypes.c_void_p]
        lib.tbc_n_fields.restype = ctypes.c_int64
        lib.tbc_n_fields.argtypes = [ctypes.c_void_p]
        lib.tbc_field_info.restype = ctypes.c_int
        lib.tbc_field_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.tbc_fill_batch_multi.restype = ctypes.c_int
        lib.tbc_fill_batch_multi.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ]
        lib.tbc_close.restype = None
        lib.tbc_close.argtypes = [ctypes.c_void_p]
        return lib


# ------------------------------------------------------------------- writer
def write_cache(path: str, episodes, fields: Optional[List[str]] = None) -> int:
    """Write an iterable of episode dicts (uniform shapes and dtypes) to a cache file; -> episodes written.
    Fields default to the first episode's keys, sorted."""
    it = iter(episodes)
    first = next(it)
    fields = sorted(first) if fields is None else list(fields)
    meta: List[Tuple[str, np.dtype, Tuple[int, ...], int, int]] = []
    offset = 0
    for name in fields:
        arr = np.ascontiguousarray(first[name])
        if arr.dtype not in _DTYPE_CODE or arr.ndim > _MAX_DIMS:
            raise ValueError(f"field {name}: {arr.dtype} of {arr.ndim} dims has no tbcache code")
        meta.append((name, arr.dtype, arr.shape, offset, arr.nbytes))
        offset += arr.nbytes

    header = struct.pack("<QII", _MAGIC, _VERSION, len(fields))
    header += struct.pack("<QQ", 0, offset)  # n_episodes, patched below; record bytes
    for name, dtype, shape, off, nbytes in meta:
        nb = name.encode()
        header += struct.pack("<I", len(nb)) + nb
        header += struct.pack("<II", _DTYPE_CODE[dtype], len(shape))
        header += struct.pack(f"<{len(shape)}Q", *shape) if shape else b""
        header += struct.pack("<QQ", off, nbytes)

    n = 0
    with open(path, "wb") as f:
        f.write(header + b"\0" * ((-len(header)) % 64))
        for ep in [first, *it]:
            for name, dtype, shape, _, _ in meta:
                arr = np.ascontiguousarray(ep[name], dtype=dtype)
                if arr.shape != shape:
                    raise ValueError(f"episode {n}: field {name} is {arr.shape}, the first episode's {shape}")
                f.write(arr.tobytes())
            n += 1
        f.seek(16)
        f.write(struct.pack("<Q", n))
    return n


def convert_h5(h5_path: str, out_path: str, tensor_size: Dict[str, tuple]) -> int:
    """Convert a packed WOMD h5 split to a tbcache file; -> episodes written."""
    with import_h5py().File(h5_path, "r", libver="latest", swmr=True) as hf:
        n = int(hf.attrs["data_len"])
        episodes = ({k: np.ascontiguousarray(hf[str(i)][k]) for k in tensor_size} for i in range(n))
        return write_cache(out_path, episodes, fields=sorted(tensor_size))


# ------------------------------------------------------------------- reader
class TBCacheDataset:
    """Batch reader over one cache file, backed by the C++ engine. `close()` unmaps the file."""

    def __init__(self, path: str, n_threads: int = 8):
        self._lib = load_library()
        self._h = self._lib.tbc_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open tbcache file {path}")
        self.n = int(self._lib.tbc_n_episodes(self._h))
        self.n_threads = n_threads
        self.fields: Dict[str, Tuple[int, np.dtype, Tuple[int, ...]]] = {}
        name_buf = ctypes.create_string_buffer(256)
        dtype_c, ndim_c = ctypes.c_int(), ctypes.c_int()
        dims = (ctypes.c_int64 * _MAX_DIMS)()
        for i in range(int(self._lib.tbc_n_fields(self._h))):
            self._lib.tbc_field_info(self._h, i, name_buf, 256, ctypes.byref(dtype_c), ctypes.byref(ndim_c), dims)
            shape = tuple(int(dims[d]) for d in range(ndim_c.value))
            self.fields[name_buf.value.decode()] = (i, np.dtype(_DTYPES[dtype_c.value]), shape)

    def __len__(self) -> int:
        return self.n

    def get_batch(self, indices: Sequence[int], keys: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
        """The episodes at `indices`, stacked: {field: [len(indices), *shape]}."""
        if not self._h:
            raise ValueError("tbcache file is closed")
        keys = list(self.fields) if keys is None else keys
        n = len(indices)
        if any(not 0 <= int(i) < self.n for i in indices):
            raise IndexError(f"episode index out of [0, {self.n})")
        idx = (ctypes.c_int64 * n)(*[int(i) for i in indices])
        f_idx = (ctypes.c_int32 * len(keys))(*[self.fields[k][0] for k in keys])
        outs, ptrs = {}, (ctypes.c_void_p * len(keys))()
        for j, k in enumerate(keys):
            _, dtype, shape = self.fields[k]
            outs[k] = np.empty((n,) + shape, dtype=dtype)
            ptrs[j] = outs[k].ctypes.data_as(ctypes.c_void_p)
        rc = self._lib.tbc_fill_batch_multi(self._h, idx, n, f_idx, len(keys), ptrs, self.n_threads)
        if rc != 0:
            raise RuntimeError(f"tbc_fill_batch_multi failed: {rc}")
        return outs

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[0] for k, v in self.get_batch([i]).items()}

    def close(self) -> None:
        if self._h:
            self._lib.tbc_close(self._h)
            self._h = None


class TBCacheLoader:
    """Batches of a TBCacheDataset in the order of `data/h5_dataset.py::DataLoader`: the permutation of
    `np.random.default_rng(seed + epoch)` when shuffling, stride shards, `set_epoch` and `iter_from`."""

    def __init__(self, dataset: TBCacheDataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, shard_index: int = 0, num_shards: int = 1):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.shard_index, self.num_shards = shard_index, num_shards

    def __len__(self) -> int:
        n = -(-len(self.ds) // self.num_shards)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to an absolute epoch, so a resumed run replays the interrupted epoch's order."""
        self.epoch = epoch

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0):
        """Iterate the epoch from batch `start_batch`, skipping by index: skipped records are not read."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        idx = shard_indices(idx, self.shard_index, self.num_shards)
        for i in range(start_batch * self.batch_size, len(idx), self.batch_size):
            b = idx[i: i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                break
            yield self.ds.get_batch(b)


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "convert":
        from trafficbotsv15_tpu_torch.config import DataCfg
        from trafficbotsv15_tpu_torch.data import h5_dataset

        split = sys.argv[4] if len(sys.argv) > 4 else "train"
        schema = {"train": h5_dataset.tensor_size_train, "val": h5_dataset.tensor_size_val,
                  "test": h5_dataset.tensor_size_test}[split](DataCfg())
        print(f"converted {convert_h5(sys.argv[2], sys.argv[3], schema)} episodes -> {sys.argv[3]}")
    else:
        print(__doc__)
