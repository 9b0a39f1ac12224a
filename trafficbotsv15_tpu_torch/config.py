"""Typed configuration tree of the PyTorch port.

A field-by-field mirror of `trafficbotsv15_tpu/config.py` (the flagship
sim_agent config plus datamodule/trainer knobs as frozen dataclasses), kept
as the port's own copy so the port never imports the JAX package.
`tests/test_torch_config.py` compares the two with `dataclasses.asdict` so
they cannot drift. Fields that select TPU implementations are mirrored for
that comparison; the port reads only those its slice implements (see
`ops/flags.py`). The JAX package's copy carries each field's history.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from trafficbotsv15_tpu_torch.ops.flags import OpsCfg


def _d(factory):
    return dataclasses.field(default_factory=factory)


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    d_model: int = 128
    n_head: int = 4
    k_feedforward: int = 4
    dropout_p: float = 0.1
    bias: bool = True
    activation: str = "relu"
    out_layernorm: bool = False
    apply_q_rpe: bool = False
    use_pallas: bool = False
    attn_dropout_weights: bool = False
    seg_attn: bool = True
    dense_knn_max: int = 128


@dataclasses.dataclass(frozen=True)
class PoseEmbCfg:
    mode: str = "pe_xy_yaw"
    theta_xy: float = 1e3
    theta_cs: float = 1e1


@dataclasses.dataclass(frozen=True)
class InputEncoderCfg:
    mode: str = "cat"
    n_layer: int = 3
    mlp_dropout_p: float = 0.0
    mlp_use_layernorm: bool = False


@dataclasses.dataclass(frozen=True)
class PolylineEncoderCfg:
    pooling_mode: str = "max_valid"
    n_layer: int = 3
    mlp_dropout_p: float = 0.1
    mlp_use_layernorm: bool = False
    use_pointnet: bool = True


@dataclasses.dataclass(frozen=True)
class MapEncoderCfg:
    n_layer_tf: int = 8
    pose_emb: PoseEmbCfg = _d(lambda: PoseEmbCfg(mode="mpa_pl"))
    input_encoder: InputEncoderCfg = _d(lambda: InputEncoderCfg(mode="cat"))
    pl_encoder: PolylineEncoderCfg = _d(PolylineEncoderCfg)


@dataclasses.dataclass(frozen=True)
class TlEncoderCfg:
    temp_stack_input: bool = False
    tl_lane_detach_mp_feature: bool = True
    n_layer_tf: int = 4
    k_tgt_knn_tl2tl: float = 0.75
    k_tgt_knn_tl2mp: float = 0.75
    k_dist_limit: float = 0.5
    pose_emb: PoseEmbCfg = _d(PoseEmbCfg)
    input_encoder: InputEncoderCfg = _d(lambda: InputEncoderCfg(mode="add"))


@dataclasses.dataclass(frozen=True)
class TlStatePredictorCfg:
    detach_tl_feature: bool = True
    n_layer: int = 3
    rnn_dropout_p: float = 0.1


@dataclasses.dataclass(frozen=True)
class AgEncoderCfg:
    n_layer_tf: int = 4
    k_tgt_knn_ag2mp: float = 2.0
    k_tgt_knn_ag2tl: float = 0.8
    k_tgt_knn_ag2ag: float = 0.8
    k_dist_limit: float = 1.0
    rnn_latent_temp_pool_mode: str = "max_valid"
    pose_emb: PoseEmbCfg = _d(PoseEmbCfg)
    input_encoder: InputEncoderCfg = _d(lambda: InputEncoderCfg(mode="cat"))


@dataclasses.dataclass(frozen=True)
class DistEncoderCfg:
    dist_type: str = "diag_gaus"  # std_gaus | diag_gaus | std_cat | cat
    n_cat: int = 8
    log_std: Optional[float] = 0.0
    mlp_use_layernorm: bool = False
    n_layer: int = 3
    branch_type: bool = False


@dataclasses.dataclass(frozen=True)
class LatentEncoderCfg:
    latent_dim: int = 16  # <= 0 disables the CVAE latent
    temporal_down_sample_rate: int = 5
    share_post_prior_encoders: bool = False
    latent_post: DistEncoderCfg = _d(lambda: DistEncoderCfg(dist_type="diag_gaus"))
    latent_prior: DistEncoderCfg = _d(lambda: DistEncoderCfg(dist_type="std_gaus"))


@dataclasses.dataclass(frozen=True)
class NaviEncoderCfg:
    dest_detach_mp_feature: bool = True


@dataclasses.dataclass(frozen=True)
class NaviPredictorCfg:
    detach_input: bool = True
    rnn_res_add: bool = True
    n_layer_tf: int = 3
    n_layer_mlp: int = 3
    mlp_use_layernorm: bool = True
    k_tgt_knn: float = 1.0
    k_dist_limit: float = 1000.0
    goal_log_std: float = 2.0


@dataclasses.dataclass(frozen=True)
class AddNaviLatentCfg:
    mode: str = "cat"  # add | mul | cat
    res_add: bool = True
    n_layer: int = 3
    mlp_use_layernorm: bool = False
    mlp_dropout_p: float = 0.1


@dataclasses.dataclass(frozen=True)
class ActionHeadCfg:
    log_std: Optional[float] = -2.0
    n_layer: int = 3
    branch_type: bool = True
    mlp_use_layernorm: bool = False


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """TrafficBots policy config (sim_agent.yaml `model:` block)."""

    hidden_dim: int = 128
    pairwise_relative: bool = True
    temp_window_size: int = 11
    n_tgt_knn: int = 32
    dist_limit: float = 500.0
    tl_mode: str = "lane"  # lane | stop
    navi_mode: str = "dest"  # cmd | goal | dest | dummy
    tf_cfg: TransformerCfg = _d(TransformerCfg)
    pose_rpe: PoseEmbCfg = _d(PoseEmbCfg)
    mp_encoder: MapEncoderCfg = _d(MapEncoderCfg)
    tl_encoder: TlEncoderCfg = _d(TlEncoderCfg)
    tl_state_predictor: TlStatePredictorCfg = _d(TlStatePredictorCfg)
    ag_encoder: AgEncoderCfg = _d(AgEncoderCfg)
    latent_encoder: LatentEncoderCfg = _d(LatentEncoderCfg)
    navi_encoder: NaviEncoderCfg = _d(NaviEncoderCfg)
    navi_predictor: NaviPredictorCfg = _d(NaviPredictorCfg)
    add_navi_latent: AddNaviLatentCfg = _d(AddNaviLatentCfg)
    action_head: ActionHeadCfg = _d(ActionHeadCfg)


@dataclasses.dataclass(frozen=True)
class DynamicsCfg:
    use_veh_dynamics_for_all: bool = False
    dt: float = 0.1
    max_acc: Tuple[float, float, float] = (5.0, 7.0, 6.0)
    max_yaw_rate: Tuple[float, float, float] = (1.5, 7.0, 3.0)


@dataclasses.dataclass(frozen=True)
class TeacherForcingCfg:
    step_spawn_agent: int = 10
    step_warm_start: int = 10
    step_horizon: int = 0
    step_horizon_decrease_per_epoch: int = 0
    prob_forcing_agent: float = 0.3
    prob_forcing_agent_decrease_per_epoch: float = 0.1
    prob_scheduled_sampling: float = 0.0
    prob_scheduled_sampling_decrease_per_epoch: float = 0.0
    gt_sdc: bool = False
    threshold_xy: float = -1.0
    threshold_yaw: float = -1.0
    threshold_spd: float = -1.0


@dataclasses.dataclass(frozen=True)
class RewardCfg:
    w_collision: float = 0.0
    reduce_collision_with_max: bool = True
    use_il_loss: bool = True
    w_pos: float = 1e-1
    w_rot: float = 1e1
    w_spd: float = 1e-1
    angular_type: str = "cosine"


@dataclasses.dataclass(frozen=True)
class TrainingMetricsCfg:
    w_vae_kl: float = 1.0
    kl_balance_scale: float = 0.2
    kl_free_nats: float = 1.0
    kl_for_unseen_agent: bool = True
    w_diffbar_reward: float = 1.0
    w_navi: float = 1.0
    w_tl_state: float = 1.0
    w_relevant_agent: float = 0.0
    p_loss_for_irrelevant: float = 1.0
    step_training_start: int = 10
    temporal_discount: float = -1.0
    loss_for_teacher_forcing: bool = True


@dataclasses.dataclass(frozen=True)
class ParallelCfg:
    """Mesh layout + parameter-sharding strategy for fit() (mirrored field by
    field), over processes in the port (`parallel/mesh.py`): the mesh is
    (ranks / model_axis, model_axis).

    "dp" is data parallel; "fsdp" splits large params over the data axis and
    "tp" splits projections over the model axis. fsdp and tp need a process
    group (torchrun); on one process they raise, as a model_axis that does not
    divide the ranks does."""

    strategy: str = "dp"  # dp | fsdp | tp
    model_axis: int = 1  # mesh model-axis size (tp uses >1)
    fsdp_min_size: int = 2**14  # params below this stay replicated


@dataclasses.dataclass(frozen=True)
class OptimizerCfg:
    lr: float = 2e-4
    weight_decay: float = 1e-1
    betas: Tuple[float, float] = (0.9, 0.95)
    lr_navi: Optional[float] = None  # None -> same as lr
    scheduler_gamma: float = 0.5
    scheduler_step_epochs: int = 7
    grad_clip_norm: float = 5.0
    accumulate_grad_batches: int = 1  # trainer yaml knob (=1 in the reference)


@dataclasses.dataclass(frozen=True)
class DataCfg:
    """Fixed WOMD tensor schema (data_h5_womd.py:95-134)."""

    n_ag: int = 64
    n_ag_no_sim: int = 256
    n_step: int = 91
    n_step_history: int = 11
    n_mp: int = 1024
    n_mp_pl_node: int = 20
    n_tl_lane: int = 128
    n_tl_stop: int = 50
    n_tl_state: int = 5
    n_mp_type: int = 11
    n_ag_type: int = 3
    n_ag_role: int = 3
    n_ag_cmd: int = 8


@dataclasses.dataclass(frozen=True)
class WOMDPostCfg:
    k_pred: int = 6
    use_ade: bool = True
    score_temperature: float = -1.0
    mpa_nms_thresh: Tuple[float, ...] = (2.0, 2.0, 2.0)
    mtr_nms_thresh: Tuple[float, ...] = ()
    aggr_thresh: Tuple[float, ...] = ()
    n_iter_em: int = 3


@dataclasses.dataclass(frozen=True)
class WOSACPostCfg:
    const_vel_z_sim: bool = True
    const_vel_no_sim: bool = True
    w_road_edge: float = 0.0
    use_wosac_col: bool = True


@dataclasses.dataclass(frozen=True)
class ExperimentCfg:
    """Composition root (= configs/run.yaml + trainer + pl_module args)."""

    seed: int = 2023
    time_step_current: int = 10
    time_step_gt: int = 90
    time_step_end: int = 90
    time_step_sim_start: int = 1
    n_vis_batch: int = 1
    n_joint_future_womd: int = 6
    n_joint_future_wosac: int = 32
    joint_future_pred_deterministic_k0: bool = False
    p_training_rollout_prior: float = 0.1
    training_detach_model_input: bool = True
    training_deterministic_action: bool = True
    pred_navi_after_reached: bool = False
    dropout_p_history: float = 0.1
    native_wosac_realism: bool = True
    tl_prepass: bool = True
    rollout_token_dedup: bool = False

    data: DataCfg = _d(DataCfg)
    model: ModelCfg = _d(ModelCfg)
    dynamics: DynamicsCfg = _d(DynamicsCfg)
    teacher_forcing_training: TeacherForcingCfg = _d(TeacherForcingCfg)
    teacher_forcing_reactive_replay: TeacherForcingCfg = _d(
        lambda: TeacherForcingCfg(step_spawn_agent=90, prob_forcing_agent=0.0, prob_forcing_agent_decrease_per_epoch=0.0)
    )
    teacher_forcing_joint_future_pred: TeacherForcingCfg = _d(
        lambda: TeacherForcingCfg(prob_forcing_agent=0.0, prob_forcing_agent_decrease_per_epoch=0.0)
    )
    reward: RewardCfg = _d(RewardCfg)
    training_metrics: TrainingMetricsCfg = _d(TrainingMetricsCfg)
    optimizer: OptimizerCfg = _d(OptimizerCfg)
    parallel: ParallelCfg = _d(ParallelCfg)
    womd_post: WOMDPostCfg = _d(WOMDPostCfg)
    wosac_post: WOSACPostCfg = _d(WOSACPostCfg)
    ops: OpsCfg = _d(OpsCfg)

    batch_size_train: int = 2
    batch_size_test: int = 4
    max_epochs: int = 6
    limit_train_batches: float = 0.2
    validate_every_epoch: bool = True
    val_epoch_batches: int = 8
    ckpt_every_steps: int = 0
    swa: bool = False
    swa_epoch_start: float = 0.8
    ema_decay: float = 0.0
    precision: str = "bf16"  # compute dtype; params stay fp32
    remat_policy: str = "names"
    scan_unroll: int = 1

    @property
    def n_step_hist(self) -> int:
        return self.time_step_current + 1


def leaderboard_config() -> ExperimentCfg:
    """The flagship 10M-param WOSAC-2024 config (sim_agent.yaml defaults)."""
    return ExperimentCfg()


def tiny_config(
    n_ag: int = 8,
    n_mp: int = 32,
    n_tl: int = 8,
    n_step: int = 21,
    hidden_dim: int = 32,
) -> ExperimentCfg:
    """A CPU-sized config for tests: ~2-layer encoders, small token counts."""
    return ExperimentCfg(
        time_step_gt=n_step - 1,
        time_step_end=n_step - 1,
        data=DataCfg(
            n_ag=n_ag, n_ag_no_sim=16, n_step=n_step, n_mp=n_mp, n_mp_pl_node=10,
            n_tl_lane=n_tl, n_tl_stop=n_tl,
        ),
        model=ModelCfg(
            hidden_dim=hidden_dim,
            n_tgt_knn=4,
            mp_encoder=MapEncoderCfg(n_layer_tf=2, input_encoder=InputEncoderCfg(mode="cat", n_layer=2),
                                     pl_encoder=PolylineEncoderCfg(n_layer=2)),
            tl_encoder=TlEncoderCfg(n_layer_tf=1),
            ag_encoder=AgEncoderCfg(n_layer_tf=2),
            latent_encoder=LatentEncoderCfg(latent_dim=4),
            navi_predictor=NaviPredictorCfg(n_layer_tf=1, n_layer_mlp=2),
            tf_cfg=TransformerCfg(d_model=hidden_dim, n_head=2),
            tl_state_predictor=TlStatePredictorCfg(n_layer=2),
            add_navi_latent=AddNaviLatentCfg(n_layer=2),
            action_head=ActionHeadCfg(n_layer=2),
        ),
        batch_size_train=2,
        batch_size_test=2,
        precision="fp32",
    )


def scaled_config() -> ExperimentCfg:
    """BASELINE config #5: wider/deeper HPTR backbone (~40M params) with
    long-horizon (>8 s) rollouts; K=6 WOMD modes come from the same
    joint-future reduction."""
    return ExperimentCfg(
        time_step_end=120,  # 12 s at 10 Hz (beyond-GT steps run free, no forcing/loss)
        model=ModelCfg(
            hidden_dim=256,
            tf_cfg=TransformerCfg(d_model=256, n_head=8),
            mp_encoder=MapEncoderCfg(n_layer_tf=12),
            tl_encoder=TlEncoderCfg(n_layer_tf=6),
            ag_encoder=AgEncoderCfg(n_layer_tf=6),
            latent_encoder=LatentEncoderCfg(latent_dim=32),
        ),
        batch_size_train=1,
    )


def with_pallas(cfg: ExperimentCfg, use_pallas: bool) -> ExperimentCfg:
    """cfg with `TransformerCfg.use_pallas` set (True runs the KNARPE attention kernels)."""
    tf = dataclasses.replace(cfg.model.tf_cfg, use_pallas=use_pallas)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tf_cfg=tf))


def config_to_dict(cfg: ExperimentCfg) -> dict:
    """The config as nested dicts (`dataclasses.asdict`): the JAX package's `config_to_dict`, key for key, so
    a checkpoint's `<name>.json` reads in either package."""
    return dataclasses.asdict(cfg)


def _build(cls, d: dict):
    """cls from a dict of its fields: nested dicts become the field's dataclass, lists tuples; unknown keys are
    dropped (as the JAX package's `config_from_dict` drops them)."""
    defaults = cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v, default = d[f.name], getattr(defaults, f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(default):
            v = _build(type(default), v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(d: dict) -> ExperimentCfg:
    """An ExperimentCfg from `config_to_dict`'s output (a checkpoint's config, the CLI's merged overrides)."""
    return _build(ExperimentCfg, d)
