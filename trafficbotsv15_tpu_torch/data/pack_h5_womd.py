"""Pack WOMD TFRecord scenarios into the fixed-shape h5 dataset (counterpart of `scripts/pack_h5_womd.py`).

    python -m trafficbotsv15_tpu_torch.data.pack_h5_womd --data-dir <womd_scenario_dir> --dataset training \
        --out-dir <out> [--rand-pos 50] [--rand-yaw 3.14] [--workers 12] [--limit N]

The reference packer's schema, constants and WOMD-proto collation rules; a
pool of worker processes packs scenarios (`pack_scenario`, through the port's
`data/pack_episode.py`) while the main process writes the h5 file
(`write_h5`), one group per scenario, gzip level 4 with the shuffle filter.
The file is what `data/h5_dataset.py::H5Dataset` reads (`data=h5`).

Reading the TFRecords needs `tensorflow` and `waymo_open_dataset`, writing
the file `h5py`; each is imported where it is used, and a missing one raises
an ImportError that names it. Everything else runs without them.
"""

from argparse import ArgumentParser
from multiprocessing import Pool
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np

from trafficbotsv15_tpu_torch.data import pack_episode as pk


def _missing(package: str, what: str, err: ImportError) -> ImportError:
    """The ImportError for a package that does not import, naming it and what needs it."""
    return ImportError(f"{what} needs the {package} package, which does not import here: {err}")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise _missing("h5py", "writing the packed h5 dataset", e) from e
    return h5py


def _scenario_pb2():
    try:
        from waymo_open_dataset.protos import scenario_pb2
    except ImportError as e:
        raise _missing("waymo_open_dataset", "reading WOMD scenario protos", e) from e
    return scenario_pb2


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise _missing("tensorflow", "reading WOMD TFRecords", e) from e
    return tf


# schema constants (scripts/pack_h5_womd.py:17-49 in the reference)
N_MP_TYPE, N_MP_PL_NODE = 11, 20
DIM_VEH_LANES, DIM_CYC_LANES, DIM_PED_LANES = [0, 1, 2], [3], [4]
N_TL_STATE = 5
N_AG_TYPE = 3
N_MP_DATA, N_TL_DATA, N_AG_DATA = 3000, 50, 1300
N_MP_H5, N_TL_LANE_H5, N_AG_H5_SIM, N_AG_H5_NO_SIM = 1024, 128, 64, 256
DIST_THRESH_MP, DIST_THRESH_AG = 500, 120
N_STEP, STEP_CURRENT = 91, 10

DATASET_SIZE = {
    "training": 486995,
    "validation": 44097,
    "training_20s": 70541,
    "validation_interactive": 43479,
    "testing": 44920,
    "testing_interactive": 44154,
}

# WOMD traffic-light state mapping -> 5 classes (unknown/stop/caution/go/flashing)
_TL_STATE_MAP = {0: 0, 1: 1, 4: 1, 2: 2, 5: 2, 3: 3, 6: 3, 7: 4, 8: 4}


def collate_map_features(map_features):
    """WOMD map protos -> typed polylines (11 types)."""
    mp_id, mp_xyz, mp_type, mp_edge = [], [], [], []
    for mf in map_features:
        kind = mf.WhichOneof("feature_data")
        if kind is None:
            continue
        feature = getattr(mf, kind)
        if kind == "lane":
            # lane.type: UNDEFINED=0 -> surface street; FREEWAY=1 -> 0;
            # SURFACE_STREET=2 -> 1; BIKE_LANE=3 -> 3
            t = {0: 1, 1: 0, 2: 1, 3: 3}[feature.type]
            mp_type.append(t)
            mp_id.append(mf.id)
            mp_xyz.append([[p.x, p.y, p.z] for p in feature.polyline][::2])
            if len(feature.exit_lanes) > 0:
                for ex in feature.exit_lanes:
                    mp_edge.append([mf.id, ex])
            else:
                mp_edge.append([mf.id, -1])
        elif kind == "stop_sign":
            for l_id in feature.lane:
                if l_id in mp_id:
                    i = mp_id.index(l_id)
                    if mp_type[i] < 2:  # only override FREEWAY/SURFACE_STREET
                        mp_type[i] = 2
        elif kind == "road_edge":
            mp_id.append(mf.id)
            mp_type.append(feature.type + 3)  # BOUNDARY/MEDIAN [1,2] -> [4,5]
            mp_xyz.append([[p.x, p.y, p.z] for p in feature.polyline][::2])
        elif kind == "road_line":
            # broken {1,4,5} -> 6, solid single {2,6} -> 7, double {3,7,8} -> 8
            if feature.type in (1, 4, 5):
                t = 6
            elif feature.type in (2, 6):
                t = 7
            else:
                t = 8
            mp_id.append(mf.id)
            mp_type.append(t)
            mp_xyz.append([[p.x, p.y, p.z] for p in feature.polyline][::2])
        elif kind in ("speed_bump", "driveway", "crosswalk"):
            xyz = np.array([[p.x, p.y, p.z] for p in feature.polygon])
            idx = np.linspace(0, xyz.shape[0], 4, endpoint=False, dtype=int)
            pls = pk.get_polylines_from_polygon(xyz[idx])
            mp_xyz.extend(pls)
            mp_id.extend([mf.id] * len(pls))
            mp_type.extend([9 if kind in ("speed_bump", "driveway") else 10] * len(pls))
        else:
            raise ValueError(kind)
    return mp_id, mp_xyz, mp_type, mp_edge


def collate_traffic_light_features(tl_features):
    tl_state, tl_id, tl_stop = [], [], []
    for step in tl_features:
        ss, si, sp = [], [], []
        for tl in step.lane_states:
            ss.append(_TL_STATE_MAP[tl.state])
            si.append(tl.lane)
            sp.append([tl.stop_point.x, tl.stop_point.y, tl.stop_point.z])
        tl_state.append(ss)
        tl_id.append(si)
        tl_stop.append(sp)
    return tl_state, tl_id, tl_stop


def collate_agent_features(tracks, sdc_track_index, track_index_predict, object_id_interest):
    ag_id, ag_type, ag_state, ag_role = [], [], [], []
    for i, tr in enumerate(tracks):
        ag_id.append(tr.id)
        ag_type.append(tr.object_type - 1)  # 1/2/3 -> 0/1/2
        ag_state.append(
            [
                [s.center_x, s.center_y, s.center_z, s.length, s.width, s.height,
                 s.heading, s.velocity_x, s.velocity_y, s.valid]
                for s in tr.states
            ]
        )
        ag_role.append([i == sdc_track_index, tr.id in object_id_interest, i in track_index_predict])
    return ag_id, ag_type, ag_state, ag_role


def pack_scenario(args_tuple):
    """Worker: scenario bytes -> (scenario_id, center, yaw, with_map, episode_reduced)."""
    raw_bytes, dataset, rand_pos, rand_yaw, dest_no_pred, seed = args_tuple
    scenario_pb2 = _scenario_pb2()

    rng = np.random.default_rng(seed)
    scenario = scenario_pb2.Scenario.FromString(raw_bytes)

    pack_all = "training" in dataset or "validation" in dataset
    pack_history = "validation" in dataset or "testing" in dataset

    mp_id, mp_xyz, mp_type, mp_edge = collate_map_features(scenario.map_features)
    tl_state, tl_id, tl_stop = collate_traffic_light_features(scenario.dynamic_map_states)
    ag_id, ag_type, ag_state, ag_role = collate_agent_features(
        scenario.tracks,
        sdc_track_index=scenario.sdc_track_index,
        track_index_predict=[t.track_index for t in scenario.tracks_to_predict],
        object_id_interest=list(scenario.objects_of_interest),
    )

    episode = {}
    pk.pack_episode_map(episode, mp_id, mp_xyz, mp_type, mp_edge, N_MP_DATA, N_MP_PL_NODE)
    pk.pack_episode_traffic_lights(episode, STEP_CURRENT, tl_state, tl_id, tl_stop, pack_all, pack_history, N_TL_DATA)
    pk.pack_episode_agents(episode, STEP_CURRENT, ag_id, ag_type, ag_state, ag_role, pack_all, pack_history, N_AG_DATA)
    center, yaw = pk.center_at_sdc(episode, STEP_CURRENT, rand_pos, rand_yaw, rng)

    reduced = {}
    pk.filter_episode_map(episode, STEP_CURRENT, N_MP_H5, DIST_THRESH_MP, thresh_z=6)
    with_map = bool(episode["map/valid"].any(1).sum() > 0)
    pk.repack_episode_map(episode, reduced, N_MP_H5, N_MP_TYPE)
    pk.filter_episode_traffic_lights(episode)
    pk.repack_episode_traffic_lights(episode, reduced, N_TL_LANE_H5, N_TL_STATE)

    if "training" in dataset:
        mask_sim, mask_no_sim = pk.filter_episode_agents(episode, reduced, STEP_CURRENT, N_AG_H5_SIM, DIST_THRESH_AG)
        pk.repack_episode_agents(episode, reduced, mask_sim, N_AG_H5_SIM,
                                 DIM_VEH_LANES, DIM_CYC_LANES, DIM_PED_LANES, dest_no_pred, rng=rng)
    elif "validation" in dataset:
        mask_sim, mask_no_sim = pk.filter_episode_agents(
            episode, reduced, STEP_CURRENT, N_AG_H5_SIM, DIST_THRESH_AG, prefix="history/")
        pk.repack_episode_agents(episode, reduced, mask_sim, N_AG_H5_SIM,
                                 DIM_VEH_LANES, DIM_CYC_LANES, DIM_PED_LANES, dest_no_pred, rng=rng)
        pk.repack_episode_agents(episode, reduced, mask_sim, N_AG_H5_SIM, prefix="history/")
        pk.repack_episode_agents_no_sim(episode, reduced, mask_no_sim, N_AG_H5_NO_SIM, "")
        pk.repack_episode_agents_no_sim(episode, reduced, mask_no_sim, N_AG_H5_NO_SIM, "history/")
    else:  # testing
        if with_map:
            mask_sim, mask_no_sim = pk.filter_episode_agents(
                episode, reduced, STEP_CURRENT, N_AG_H5_SIM, DIST_THRESH_AG, prefix="history/")
        else:
            mask_valid = episode["history/agent/valid"].any(1)
            mask_sim = episode["history/agent/role"].any(-1).copy()
            for vi in np.where(mask_valid)[0]:
                mask_sim[vi] = True
                if mask_sim.sum() >= N_AG_H5_SIM:
                    break
            mask_no_sim = mask_valid & ~mask_sim
        pk.repack_episode_agents(episode, reduced, mask_sim, N_AG_H5_SIM, prefix="history/")
        pk.repack_episode_agents_no_sim(episode, reduced, mask_no_sim, N_AG_H5_NO_SIM, "history/")

    if with_map:
        reduced["map/boundary"] = pk.get_map_boundary(reduced["map/valid"], reduced["map/pos"])
    else:
        reduced["map/boundary"] = pk.get_map_boundary(
            episode["history/agent/valid"], episode["history/agent/pos"])
    return scenario.scenario_id, center, yaw, with_map, reduced


def write_h5(path, records: Iterable[Tuple[str, np.ndarray, float, bool, dict]], log_every: int = 1000) -> int:
    """Write packed scenarios `(scenario_id, center, yaw, with_map, reduced)` (`pack_scenario`'s results) as one h5
    file: group i holds scenario i's arrays and its id, center, yaw and with_map as attributes; the file's
    `data_len` attribute counts them. -> the number written."""
    h5py = _h5py()
    data_len = 0
    with h5py.File(str(path), "w") as hf:
        for i, (sid, center, yaw, with_map, reduced) in enumerate(records):
            g = hf.create_group(str(i))
            g.attrs["scenario_id"] = sid
            g.attrs["scenario_center"] = center
            g.attrs["scenario_yaw"] = yaw
            g.attrs["with_map"] = with_map
            for k, v in reduced.items():
                g.create_dataset(k, data=v, compression="gzip", compression_opts=4, shuffle=True)
            data_len += 1
            if log_every and data_len % log_every == 0:
                print(f"packed {data_len}", flush=True)
        hf.attrs["data_len"] = data_len
    return data_len


def main(argv=None):
    parser = ArgumentParser(description="Pack WOMD TFRecord scenarios into the fixed-shape h5 dataset.")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--dataset", default="training")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--rand-pos", default=50.0, type=float)
    parser.add_argument("--rand-yaw", default=3.14, type=float)
    parser.add_argument("--dest-no-pred", action="store_true")
    parser.add_argument("--workers", default=12, type=int)
    parser.add_argument("--limit", default=-1, type=int)
    args = parser.parse_args(argv)

    _h5py()
    _scenario_pb2()
    tf = _tensorflow()
    tf.config.set_visible_devices([], "GPU")

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files = sorted(str(p) for p in (Path(args.data_dir) / args.dataset).glob("*"))
    ds = tf.data.TFRecordDataset(files, compression_type="")

    def job_gen():
        for i, rec in enumerate(ds):
            if args.limit > 0 and i >= args.limit:
                break
            yield (bytes(rec.numpy()), args.dataset, args.rand_pos, args.rand_yaw, args.dest_no_pred, i)

    with Pool(args.workers) as pool:
        data_len = write_h5(out / f"{args.dataset}.h5", pool.imap(pack_scenario, job_gen(), chunksize=4))
    print(f"data_len: {data_len}")


if __name__ == "__main__":
    main()
