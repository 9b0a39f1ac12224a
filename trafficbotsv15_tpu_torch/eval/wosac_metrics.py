"""Official WOSAC realism metrics (counterpart of `trafficbotsv15_tpu/eval/wosac_metrics.py`).

A host-side process pool over scenarios calls Waymo's official
`compute_scenario_metrics_for_bundle` with the 2024 challenge config; the
per-scenario metrics are summed, and `compute` aggregates their means into
the realism meta-metric buckets. Everything Waymo is imported inside the
functions, so this module imports without the `waymo_open_dataset` package;
`WOSACMetrics(...)` raises ImportError without it. The pool's children
import this module, so its top level imports nothing heavy and touches no
CUDA state. Without the package, `eval/wosac_likelihood.py` reports the same
likelihood fields natively.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
from typing import Dict, List

FIELD_NAMES = [
    "metametric",
    "average_displacement_error",
    "linear_speed_likelihood",
    "linear_acceleration_likelihood",
    "angular_speed_likelihood",
    "angular_acceleration_likelihood",
    "distance_to_nearest_object_likelihood",
    "collision_indication_likelihood",
    "time_to_collision_likelihood",
    "distance_to_road_edge_likelihood",
    "offroad_indication_likelihood",
    "min_average_displacement_error",
]


def load_official_config():
    """The challenge's 2024 SimAgentMetricsConfig, shipped beside the official metrics module."""
    from pathlib import Path

    import waymo_open_dataset.wdl_limited.sim_agents_metrics.metrics as wosac_metrics
    from google.protobuf import text_format
    from waymo_open_dataset.protos import sim_agents_metrics_pb2

    config_path = Path(wosac_metrics.__file__).parent / "challenge_2024_config.textproto"
    config = sim_agents_metrics_pb2.SimAgentMetricsConfig()
    text_format.Parse(config_path.read_text(), config)
    return config


def _compute_one(config, scenario_hex: str, rollout):
    """One scenario's official metrics (runs in a pool child)."""
    import waymo_open_dataset.wdl_limited.sim_agents_metrics.metrics as wosac_metrics
    from waymo_open_dataset.protos import scenario_pb2

    return wosac_metrics.compute_scenario_metrics_for_bundle(
        config, scenario_pb2.Scenario.FromString(bytes.fromhex(scenario_hex)), rollout)


class WOSACMetrics:
    """Official per-scenario metrics over a forkserver pool, summed across `update` calls."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self.config = load_official_config()
        self.sums = {k: 0.0 for k in FIELD_NAMES}
        self.counter = 0

    def update(self, scenario_rollouts: List, scenario_bytes: List[str]):
        """scenario_rollouts: ScenarioRollouts protos; scenario_bytes: each scenario proto as a hex string."""
        n_pool = min(len(scenario_rollouts), int(os.getenv("SLURM_CPUS_PER_TASK", os.cpu_count() or 1)))
        ctx = mp.get_context("forkserver")
        with ctx.Pool(processes=n_pool) as pool:
            results = pool.starmap(_compute_one, zip(itertools.repeat(self.config), scenario_bytes,
                                                     scenario_rollouts))
        for m in results:
            self.counter += 1
            for k in FIELD_NAMES:
                self.sums[k] += getattr(m, k)

    def compute(self) -> Dict[str, float]:
        """The means of the fields under `<prefix>/wosac_likelihood/`, their buckets under `<prefix>/wosac/`."""
        import waymo_open_dataset.wdl_limited.sim_agents_metrics.metrics as wosac_metrics
        from waymo_open_dataset.protos import sim_agents_metrics_pb2

        mean = {k: v / max(self.counter, 1) for k, v in self.sums.items()}
        buckets = wosac_metrics.aggregate_metrics_to_buckets(
            self.config, sim_agents_metrics_pb2.SimAgentMetrics(scenario_id="", **mean))
        out = {
            f"{self.prefix}/wosac/realism_meta_metric": buckets.realism_meta_metric,
            f"{self.prefix}/wosac/kinematic_metrics": buckets.kinematic_metrics,
            f"{self.prefix}/wosac/interactive_metrics": buckets.interactive_metrics,
            f"{self.prefix}/wosac/map_based_metrics": buckets.map_based_metrics,
            f"{self.prefix}/wosac/min_ade": buckets.min_ade,
        }
        for k in FIELD_NAMES:
            out[f"{self.prefix}/wosac_likelihood/{k}"] = mean[k]
        return out
