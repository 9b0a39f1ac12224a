"""Submission writers for WOMD motion prediction and WOSAC sim agents (counterpart of
`trafficbotsv15_tpu/eval/submission.py`; numpy and protobuf only, the port keeps its own copy).

Protobuf serialization runs on the host and imports waymo_open_dataset only
when a writer is made active; metadata fields, scenario dedup, 300-scenario
shards and the tar.gz packaging are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import tarfile
from pathlib import Path
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SubmissionMeta:
    method_name: str = "trafficbots_tpu"
    authors: tuple = ("ANON",)
    affiliation: str = "AFFILIATION"
    description: str = "TrafficBots V1.5 TPU"
    method_link: str = "METHOD_LINK"
    account_name: str = "ACCOUNT"
    num_model_parameters: str = "10M"


class SubWOMD:
    """WOMD MotionChallengeSubmission writer (submission.py:15-125)."""

    def __init__(self, meta: SubmissionMeta, is_active: bool = True):
        self.is_active = is_active
        self.meta = meta
        self.seen_ids: List[str] = []
        if is_active:
            from waymo_open_dataset.protos import motion_submission_pb2 as pb

            self._pb = pb
            sub = pb.MotionChallengeSubmission()
            sub.account_name = meta.account_name
            sub.unique_method_name = meta.method_name
            sub.authors.extend(list(meta.authors))
            sub.affiliation = meta.affiliation
            sub.description = meta.description
            sub.method_link = meta.method_link
            sub.submission_type = 1  # single (marginal) prediction
            sub.uses_lidar_data = False
            sub.uses_camera_data = False
            sub.uses_public_model_pretraining = False
            sub.num_model_parameters = meta.num_model_parameters
            self.submission = sub

    def add(
        self,
        scenario_ids: List[str],
        trajs_global: np.ndarray,  # [n_sc, n_ag, K, n_step_2hz, 2] in WOMD global frame
        scores: np.ndarray,  # [n_sc, n_ag, K]
        object_id: np.ndarray,  # [n_sc, n_ag]
        mask_pred: np.ndarray,  # [n_sc, n_ag]
    ):
        if not self.is_active:
            return
        pb = self._pb
        n_k = scores.shape[-1]
        for i, sid in enumerate(scenario_ids):
            if sid in self.seen_ids:
                continue
            self.seen_ids.append(sid)
            sp = pb.ChallengeScenarioPredictions()
            sp.scenario_id = sid
            for a in np.where(mask_pred[i])[0]:
                pred = pb.SingleObjectPrediction()
                pred.object_id = int(object_id[i, a])
                for k in range(n_k):
                    st = pb.ScoredTrajectory()
                    st.confidence = float(scores[i, a, k])
                    st.trajectory.center_x.extend(trajs_global[i, a, k, :, 0].tolist())
                    st.trajectory.center_y.extend(trajs_global[i, a, k, :, 1].tolist())
                    pred.trajectories.append(st)
                sp.single_predictions.predictions.append(pred)
            self.submission.scenario_predictions.append(sp)

    def save(self, out_dir: str = ".") -> Optional[str]:
        if not self.is_active:
            return None
        sub_dir = Path(out_dir) / f"{self.meta.method_name}_WOMD"
        sub_dir.mkdir(parents=True, exist_ok=True)
        (sub_dir / f"{self.meta.method_name}_WOMD.bin").write_bytes(self.submission.SerializeToString())
        tar_name = sub_dir.as_posix() + ".tar.gz"
        with tarfile.open(tar_name, "w:gz") as tar:
            tar.add(sub_dir, arcname=sub_dir.name)
        return tar_name


class SubWOSAC:
    """WOSAC sharded binproto writer, <= 300 scenarios per shard (submission.py:128-225)."""

    def __init__(self, meta: SubmissionMeta, is_active: bool = True, out_dir: str = "WOSAC"):
        self.is_active = is_active
        self.meta = meta
        self.buffer: List = []
        self.i_file = 0
        self.seen_ids: List[str] = []
        self.dir = Path(out_dir)
        if is_active:
            self.dir.mkdir(parents=True, exist_ok=True)

    def add(self, scenario_rollouts: List):
        if not self.is_active:
            return
        for r in scenario_rollouts:
            if r.scenario_id in self.seen_ids:
                continue
            self.seen_ids.append(r.scenario_id)
            self.buffer.append(r)
            if len(self.buffer) > 300:
                self._save_shard()

    def _save_shard(self):
        from waymo_open_dataset.protos import sim_agents_submission_pb2 as pb

        shard = pb.SimAgentsChallengeSubmission(
            scenario_rollouts=self.buffer,
            submission_type=pb.SimAgentsChallengeSubmission.SIM_AGENTS_SUBMISSION,
            account_name=self.meta.account_name,
            unique_method_name=self.meta.method_name,
            authors=list(self.meta.authors),
            affiliation=self.meta.affiliation,
            description=self.meta.description,
            method_link=self.meta.method_link,
            uses_lidar_data=False,
            uses_camera_data=False,
            uses_public_model_pretraining=False,
            num_model_parameters=self.meta.num_model_parameters,
            acknowledge_complies_with_closed_loop_requirement=True,
        )
        (self.dir / f"submission.binproto-{self.i_file:05d}").write_bytes(shard.SerializeToString())
        self.i_file += 1
        self.buffer = []

    def save(self) -> Optional[str]:
        if not self.is_active:
            return None
        self._save_shard()
        self.i_file = 0
        tar_name = self.dir.as_posix() + ".tar.gz"
        shard_files = sorted(p.as_posix() for p in self.dir.glob("*"))
        with tarfile.open(tar_name, "w:gz") as tar:
            for f in shard_files:
                tar.add(f, arcname=f + f"-of-{len(shard_files):05d}")
        return tar_name
