"""PyTorch port: the h5 and tbcache loaders against the JAX package's.

A mini packed h5 split and tbcache files of the same synthetic scenarios
(`make_batch`, a numpy seed) go through both packages: the same batches in the
same order, array for array and exactly, with shuffling, stride shards,
`set_epoch` and `iter_from`; a cache either package writes is the same bytes
and reads in the other; the schemas (`tensor_size_*`) are equal. The port
builds its own tbcache engine from `csrc/tbcache.cc` and never loads the JAX
package's library.
"""

import shutil

import numpy as np
import pytest

from trafficbotsv15_tpu.config import DataCfg as JaxDataCfg
from trafficbotsv15_tpu.data import h5_dataset as jax_h5
from trafficbotsv15_tpu.data import tbcache as jax_tbcache
from trafficbotsv15_tpu.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.config import DataCfg
from trafficbotsv15_tpu_torch.data import h5_dataset, tbcache
from trafficbotsv15_tpu_torch.utils import build

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
N_SC = 7
SIZES = dict(n_ag=8, n_mp=16, n_step=21, n_tl_lane=8, n_tl_stop=8)


@pytest.fixture(scope="module")
def scenes():
    return make_batch(JaxDataCfg(**SIZES), n_sc=N_SC, seed=1)


@pytest.fixture(scope="module")
def h5_path(scenes, tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    path = tmp_path_factory.mktemp("h5") / "training.h5"
    with h5py.File(path, "w") as hf:
        for i in range(N_SC):
            g = hf.create_group(str(i))
            g.attrs["scenario_id"] = f"scn{i:04d}"
            g.attrs["scenario_center"] = np.asarray([i, -i], np.float32)
            g.attrs["scenario_yaw"] = np.float32(0.1 * i)
            g.attrs["with_map"] = True
            for k, v in scenes.items():
                g.create_dataset(k, data=v[i], compression="gzip", compression_opts=1)
        hf.attrs["data_len"] = N_SC
    return path


def _episodes(scenes):
    return [{k: v[i] for k, v in scenes.items()} for i in range(N_SC)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert g[k].dtype == w[k].dtype, k


@pytest.mark.parametrize("name", ["tensor_size_train", "tensor_size_test", "tensor_size_val"])
def test_tensor_sizes_match_jax(name):
    for sizes in ({}, SIZES):
        assert getattr(h5_dataset, name)(DataCfg(**sizes)) == getattr(jax_h5, name)(JaxDataCfg(**sizes))


@pytest.mark.parametrize("n,num_shards", [(7, 1), (7, 2), (7, 3), (2, 5), (8, 4)])
def test_shard_indices_match_jax(n, num_shards):
    idx = np.random.default_rng(n).permutation(n)
    for shard in range(num_shards):
        np.testing.assert_array_equal(h5_dataset.shard_indices(idx, shard, num_shards),
                                      jax_h5.shard_indices(idx, shard, num_shards))


@pytest.mark.parametrize("with_attrs", [False, True])
def test_h5_dataset_items_match_jax(h5_path, with_attrs):
    schema = h5_dataset.tensor_size_train(DataCfg(**SIZES))
    ours = h5_dataset.H5Dataset(h5_path, schema, with_attrs=with_attrs)
    ref = jax_h5.H5Dataset(h5_path, schema, with_attrs=with_attrs)
    assert len(ours) == len(ref) == N_SC
    _assert_same_batches([ours[i] for i in range(N_SC)], [ref[i] for i in range(N_SC)])


@pytest.mark.parametrize("shuffle,shards,drop_last,workers",
                         [(True, 1, False, 2), (True, 2, False, 0), (False, 3, True, 2), (True, 3, True, 0)])
def test_h5_loader_matches_jax(h5_path, shuffle, shards, drop_last, workers):
    """Every shard's batches, two epochs in a row, then set_epoch(5) and iter_from(1), as the JAX loader."""
    schema = h5_dataset.tensor_size_train(DataCfg(**SIZES))
    ours_ds, ref_ds = h5_dataset.H5Dataset(h5_path, schema), jax_h5.H5Dataset(h5_path, schema)
    for shard in range(shards):
        kw = dict(batch_size=2, shuffle=shuffle, seed=3, drop_last=drop_last, shard_index=shard, num_shards=shards)
        ours = h5_dataset.DataLoader(ours_ds, num_workers=workers, **kw)
        ref = jax_h5.DataLoader(ref_ds, num_workers=workers, **kw)
        assert len(ours) == len(ref)
        for _ in range(2):
            _assert_same_batches(list(ours), list(ref))
        ours.set_epoch(5)
        ref.set_epoch(5)
        _assert_same_batches(list(ours.iter_from(1)), list(ref.iter_from(1)))


def test_h5_needs_h5py_only_to_open_a_file(monkeypatch, h5_path):
    """Without h5py the module imports and the loader runs over other datasets; opening an h5 file raises and names
    the package."""
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        h5_dataset.H5Dataset(h5_path, h5_dataset.tensor_size_train(DataCfg(**SIZES)))
    items = [{"x": np.full(2, i)} for i in range(3)]
    assert [b["x"].tolist() for b in h5_dataset.DataLoader(items, batch_size=2, num_workers=0)] == [[[0, 0], [1, 1]],
                                                                                                  [[2, 2]]]


def test_cache_written_by_either_package_is_the_same_bytes(scenes, tmp_path):
    ours, ref = tmp_path / "ours.tbcache", tmp_path / "ref.tbcache"
    assert tbcache.write_cache(ours, _episodes(scenes)) == N_SC
    jax_tbcache.write_cache(ref, _episodes(scenes))
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_reads_in_both_packages(scenes, tmp_path, writer):
    path = tmp_path / "train.tbcache"
    (tbcache if writer == "port" else jax_tbcache).write_cache(path, _episodes(scenes))
    ours, ref = tbcache.TBCacheDataset(path, n_threads=3), jax_tbcache.TBCacheDataset(path, n_threads=3)
    try:
        assert len(ours) == len(ref) == N_SC and ours.fields == ref.fields
        idx = [6, 0, 3, 3]
        _assert_same_batches([ours.get_batch(idx)], [ref.get_batch(idx)])
        _assert_same_batches([ours.get_batch(idx)], [{k: v[idx] for k, v in scenes.items()}])
        _assert_same_batches([ours[4]], [{k: v[4] for k, v in scenes.items()}])
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("shuffle,shards,drop_last", [(True, 1, False), (True, 2, True), (False, 3, False)])
def test_tbcache_loader_matches_jax(scenes, tmp_path, shuffle, shards, drop_last):
    path = tmp_path / "train.tbcache"
    tbcache.write_cache(path, _episodes(scenes))
    ours_ds, ref_ds = tbcache.TBCacheDataset(path), jax_tbcache.TBCacheDataset(path)
    try:
        for shard in range(shards):
            kw = dict(batch_size=2, shuffle=shuffle, seed=3, drop_last=drop_last, shard_index=shard, num_shards=shards)
            ours, ref = tbcache.TBCacheLoader(ours_ds, **kw), jax_tbcache.TBCacheLoader(ref_ds, **kw)
            assert len(ours) == len(ref)
            for _ in range(2):
                _assert_same_batches(list(ours), list(ref))
            ours.set_epoch(4)
            ref.set_epoch(4)
            _assert_same_batches(list(ours.iter_from(2)), list(ref.iter_from(2)))
    finally:
        ours_ds.close()
        ref_ds.close()


def test_tbcache_and_h5_loaders_give_the_same_batches(scenes, h5_path, tmp_path):
    """The same split through the port's h5 DataLoader and through a cache converted from it (`convert_h5`): the
    schema's arrays (the h5 reader adds each item's `episode_idx`)."""
    schema = h5_dataset.tensor_size_train(DataCfg(**SIZES))
    path = tmp_path / "train.tbcache"
    assert tbcache.convert_h5(h5_path, path, schema) == N_SC
    ds = tbcache.TBCacheDataset(path)
    try:
        kw = dict(batch_size=3, shuffle=True, seed=7)
        h5_loader = h5_dataset.DataLoader(h5_dataset.H5Dataset(h5_path, schema), num_workers=0, **kw)
        from_h5 = [{k: v for k, v in b.items() if k != "episode_idx"} for b in h5_loader]
        _assert_same_batches(list(tbcache.TBCacheLoader(ds, **kw)), from_h5)
    finally:
        ds.close()


def test_engine_is_built_from_the_ports_source(tmp_path, monkeypatch):
    """The port's engine is build/libtbcache-<hash>.so from csrc/tbcache.cc (the hash over the source and the g++
    flags), never the JAX package's library; a failed build raises."""
    lib_path = build.host_library_path("tbcache", "tbcache.cc")
    tbcache.load_library()
    assert lib_path.exists() and lib_path.parent == build.BUILD_DIR and lib_path.name.startswith("libtbcache-")
    assert (build.CSRC_DIR / "tbcache.cc").read_text() != ""
    assert build._LOADED["tbcache"]._name == str(lib_path)

    (tmp_path / "tbcache.cc").write_text("this is not C++")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for tbcache.cc"):
        tbcache.load_library()
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tbcache.load_library()


def test_reader_validates_indices_and_open(scenes, tmp_path):
    path = tmp_path / "train.tbcache"
    tbcache.write_cache(path, _episodes(scenes))
    with pytest.raises(IOError):
        tbcache.TBCacheDataset(tmp_path / "missing.tbcache")
    ds = tbcache.TBCacheDataset(path)
    with pytest.raises(IndexError):
        ds.get_batch([N_SC])
    ds.close()
    with pytest.raises(ValueError, match="closed"):
        ds.get_batch([0])
