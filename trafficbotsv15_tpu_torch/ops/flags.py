"""Implementation-selection flags of the port.

`OpsCfg` mirrors `trafficbotsv15_tpu/ops/flags.py::OpsCfg` field by field
(same names, same defaults) so the config comparison test holds. The port
reads these flags from the config it is given, never from the environment,
and acts on them as follows:

| field                | port                                                      |
|----------------------|-----------------------------------------------------------|
| knn_impl             | "partial" and "sort" both select the stable sort; the     |
|                      | JAX "partial" picks the same set in another tie order      |
| approx_knn           | True raises: the port has only the exact selection        |
| two_stage_knn        | True raises: same                                          |
| knn_pallas           | gates the hand-written KNN kernel (`ops/knn.py`)           |
| mp2mp_lazy           | lazy SE(2) map self-KNN, as in the JAX package             |
| pose_emb_flat        | ignored: a bit-identical TPU layout of the same embedding  |
| narrow_gather_native | ignored: gathers are plain index gathers                   |
| onehot_gather        | ignored: same                                              |
| use_pallas_attention | kill switch of the KNARPE attention kernels              |
|                      | (`ops/knarpe.py`): they run where TransformerCfg.use_pallas |
|                      | is True and this is True; with it False, use_pallas=True  |
|                      | takes the use_pallas=False branches, as in the JAX package |
|                      | (`pallas_knarpe.py::pallas_available`)                     |
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpsCfg:
    """Implementation-selection flags (see the module docstring)."""

    knn_impl: str = "partial"  # "partial" | "sort": one stable sort in the port
    approx_knn: bool = False
    two_stage_knn: bool = False
    knn_pallas: bool = True
    mp2mp_lazy: bool = False
    pose_emb_flat: bool = False
    narrow_gather_native: bool = False
    onehot_gather: bool = True
    use_pallas_attention: bool = True


def check_supported(ops: OpsCfg) -> OpsCfg:
    """Raise for the selections the port does not implement; return `ops`."""
    if ops.knn_impl not in ("partial", "sort"):
        raise ValueError(f"unknown knn_impl {ops.knn_impl!r}")
    if ops.approx_knn or ops.two_stage_knn:
        raise NotImplementedError(
            "approx_knn / two_stage_knn are TPU selections; the port has the exact stable sort only")
    return ops
