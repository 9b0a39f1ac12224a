#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off for matmuls and cuDNN;
  2. build: compiles every CUDA source of the path from csrc/ (nvcc, sm_90a),
     one nvcc per source, all started together; meanwhile four spawned
     processes make the CPU runs of the card-vs-CPU checks of phases 4, 7, 9,
     13 (e), 16 (b), 17 (a), 18 (b) and 19 (c) (`CARD_VS_CPU`), which this
     process keeps for their phase;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at edge cases; times kernel, plain version and
     the nearest PyTorch call or composition of calls (`library_ms`):
     B1 (`knn_xy`; also at the training path's [8, 64, 1024], the training
     entry point's [2, 64, 1024] and its validation's [4, 64, 1024], the
     scaled preset's training [1, 64, 1024] (the serving entry point's too), all
     distances tied, k=1, k = n_tgt, n_tgt 1000 and 2048, every
     source invalid; timed at the eval and training shapes), B4 (`knarpe_attention`; in bf16 on
     the staged kernel of csrc/knarpe_attn_staged.cuh, the route asserted,
     at both paths' shapes, the entry point's 2 x 1024, the serving entry
     point's 1 x 1024, K=5, K=24, 1, 97 and 8 x 1024 + 7 sources and the edge
     shapes; at the scaled preset's
     D=R=256 with 8 heads on the heads kernel of csrc/knarpe_attn_heads.cuh
     (asserted; at the eval shape [4, 1024, 32, 256, 256, 8], the training
     shape [1, 1024, 32, 256, 256, 8], K=5, K=24 and K=40 (the largest its
     shared memory takes) at 97 sources, a single source and 8 x 1024 + 7
     sources, k and v the halves of one tensor and two tensors, each with an
     all-invalid and a one-target source, the same bits on a second launch);
     on the general route (asserted, the heads kernel's refusal code too) at
     K=89 there and at an eight-head shape of other widths; timed at both
     paths' shapes and the scaled preset's two), B2
     (`knarpe_cross_attention`) and B3 (`knarpe_cross_attention_v3`, which
     only this phase launches); B2 and B3 also at the training path's shapes
     (the agent decoder and posterior agent encoder, the posterior TL encoder
     at K=24), at the entry point's batch of 2 and its validation's of 4, B2
     at the serving entry point's 1 x 64, and timed at the first of them; in bf16 these run on the staged
     kernel of csrc/knarpe_staged.cuh (the route asserted); at the shapes it
     refuses, bf16 B2 at the scaled preset's D=R=256 with 8 heads runs on the
     cluster route (csrc/knarpe_cluster.cuh, asserted; at the eval shape, the
     training shape [1, 64, 89, 256, 256, 8], K=5, K=24 and K=104 at 21
     sources, a single source and 8192 + 7 sources, each with an all-invalid
     and a one-target source; timed at the scaled preset's eval and training
     shapes), and on the general route (csrc/knarpe.cu, asserted, the cluster
     kernel's refusal code too) at K=120 there and at K=90 and K=128 at
     D=R=128; bf16 B3 at D=R=256 with 8 heads runs on the heads route
     (csrc/knarpe_v3_heads.cuh, asserted; at the eval shape, the training
     shape, K=5, K=24 and K=200 at 21 sources, a single source and 8192 + 7
     sources, each with an all-invalid and a one-target source; timed at the
     scaled preset's eval and training shapes), on the general route
     (asserted, the heads kernel's refusal code too) at K=90 and K=128 at
     D=R=128; B2 on the cluster route also at the scaled training path's
     posterior TL shape [1, 128, 24, 256, 256, 8]; every bf16 B2/B3 must give the same bits
     on a second launch; then the backward kernels B4-bwd and B2-bwd (B3's backward is B2's)
     through the wrappers' autograd: the card's output has a grad_fn, and its
     gradients match autograd of the plain versions in float32 and bf16, the
     same bits on a second launch; bf16 B2-bwd and B3's backward run on the
     staged kernel of csrc/knarpe_bwd_staged.cuh (the route asserted) at both
     training shapes, K=5 at 21 sources and 200 sources, the eight-head edge
     shape on the general route (csrc/knarpe_bwd.cu), and the entry point's
     batch-2 shapes; bf16 B4-bwd on the
     staged kernel of csrc/knarpe_attn_bwd_staged.cuh at B4's shapes above,
     the eight-head shape on the general route; at the scaled preset's
     D=R=256 with 8 heads bf16 B4-bwd on the heads kernel of
     csrc/knarpe_attn_bwd_heads.cuh (asserted; at the training shape [1,
     1024, 32, 256, 256, 8], K=5, K=24 and K=40 (the largest its shared
     memory takes) at 97 sources, a single source and 8 x 1024 + 7 sources,
     k and v the halves of one tensor and two tensors), on the general route
     (asserted, the heads backward's refusal code too) at K=48 and K=89
     there and at an eight-head shape of other widths; bf16 B2-bwd and B3's
     backward at the scaled preset's D=R=256 with 8 heads on the heads kernel
     of csrc/knarpe_bwd_heads.cuh (asserted; at the scaled training path's
     [1, 64, 89, 256, 256, 8] and [1, 128, 24, 256, 256, 8] through B2's and
     B3's Function, and through B2's at K=1, K=5, K=81 and K=128 (the
     largest it takes) at 21 sources, a single source and 8 x 64 + 7
     sources), on the general route (asserted, the heads backward's refusal
     code too) at K=129 there and at an eight-head shape of other widths;
     timed (eager, and device time from a CUDA graph) against the plain
     backward and the library composition's backward, B2-bwd at both
     training shapes and on the heads route at the scaled preset's two (the
     general kernel's time at those two beside it), B4-bwd at the training
     shape and on the heads route at the scaled training shape;
     last, B3's path: the ported bench (`python -m
     trafficbotsv15_tpu_torch.utils.bench_knarpe --shape scaled`, 3
     iterations), every count at 0 before it, its B3 launches all on the
     heads route and its B2 launches on the cluster route (asserted); and
     the TrafficBots RNN family's shapes (phase 16): B1 at the flattened
     posterior's [8, 64 x 19, 1024], bf16 B2 on the staged route at [128·64,
     K=64], [128·64, K=25], [8·64, K=64], [8·64, K=25], [8, 1216, K=64] and
     [8·19, 64, K=25], each timed, and B2-bwd at the four training ones (no
     new B4 shape: the RNN agent self-attention is dense at 64 agents);
     the variants' (phase 18): bf16 B2 on the staged route at the stop lines'
     [4·50, K=24] and [8·50, K=24] and B2-bwd at [8·50, K=24], each timed;
     and the 4-wide RPE of pose_rpe "xy_dir" (d_rpe = 4): B4 at [1·512, K=4,
     D=64, H=2], [4·1024, K=32, D=128, H=4] and [8·1024, K=32] and B4-bwd
     at [1·512, K=4] and [8·1024, K=32] on the general route (their staged
     kernels refuse d_rpe % 16, the heads kernels take D=R=256 only); B2 at
     [2·16, K=11], [1·16, K=3] (D=64, H=2), [128·64, K=89], [8·64, K=89]
     and [8·128, K=24] (D=128, H=4) and B2-bwd at [1·16, K=11], [1·16, K=3], [8·64, K=89] and [8·128, K=24]
     on the staged route (rpe zero-padded to 16 columns in shared memory),
     with the edge shapes [3·7, K=5, D=16, H=1], [1·1, K=1] and [1·8199,
     K=89] forward and backward, B3 at the forward's shapes and B3's Function
     at [8·64, K=89] on it too, and eight heads [1·33, K=89, D=64] (one group
     of warps a block forward, the general backward); float32 and bf16
     against the plain versions, the route asserted, B4, B2 and their
     backwards timed at their shapes, B2 and B2-bwd with the general kernel's
     time beside them (`knarpe_general_launch`, `knarpe_bwd_general_launch`);
  4. slice checked: a reduced-depth float32 config whose map has 512
     polylines runs `joint_future_pred` (check_level=1) on the card and on
     the CPU with the same weights, once with use_pallas=False and once with
     use_pallas=True; the K0 futures and their rule flags must agree, and the
     kernels must launch as often as the config's layers and steps say;
  5. slice at full width, use_pallas=False: `leaderboard_config()` (bf16
     compute), 4 synthetic scenarios x K=32 futures, 64 agents, 1024
     polylines, 90 steps, check_level=1: finite poses of the documented
     shapes, 90 KNN launches and no attention-kernel launch per call, seconds
     per call, peak memory and agent-steps/s; phases 6 and 8 record the
     shapes at which the paths launch B4 and B2 and fail on one phase 3 did
     not check, and on any B4 or B2 launch, forward or backward, that did not
     take the staged route;
  6. slice at full width, use_pallas=True (the eval main path): the same
     call with the KNARPE attention kernels, checked and timed without a
     warm-up call (phase 5 ran the model); B1, B2 and B4 launches per call
     asserted (90, 4 layers x 90 steps, 8 map layers); then one more call
     whose level-1 rule checks at four steps are replayed on the CPU from the
     card's inputs, the flags to agree;
  7. train step checked: the phase-4 config with every dropout rate at 0
     (CPU and CUDA generators draw different masks) runs one
     `make_train_step` on the card and on the CPU with the same weights and
     the same draws, with use_pallas False and True: loss, grad_norm and every
     parameter's gradient (as the optimizer applies it) agree, and the kernels
     launch, forward and backward, as often as the config implies;
  8. training at full width (the training main path): `leaderboard_config()`
     with use_pallas=True, 8 synthetic scenarios per step, bf16 compute with
     f32 parameters: one warm-up step, then 1 timed step; seconds per step,
     train samples/s, peak memory, forward and backward launches per step
     (asserted), every bf16 B4 and B2 forward and backward launch on the
     staged route at a shape phase 3 checked; loss and grad_norm finite and non-zero,
     parameters changed;
  9. validation step (`eval/runner.py::make_validate_step`: reactive replay, its
     loss and metric sums, K joint futures, WOMD post-processing and native
     motion metrics, the WOSAC filter, native realism): the phase-4 config with
     K=34 futures on the card and on the CPU, same weights and draws, use_pallas
     False and True: buffers, flags and every entry of `out` agree, and the
     card's realism agrees with the CPU's on the card's own futures; then
     `leaderboard_config()` with use_pallas=True, 4 scenarios, K=32, level 1,
     native realism: 1 step checked and timed, a first step (seconds per step,
     wosac_validate_scenarios_per_sec_per_chip, peak memory), launches per step
     asserted (B1 181, B4 16, B2 728, staged, at shapes phase 3 checked), one
     more step split by part with the realism part's working set; (b) `validate`
     over one batch of the phase-4 config (2 scenarios with the test split's
     history keys, scenario ids and scenario bytes) with tests/waymo_stub
     installed for the call only: the WOSAC pool reports every `wosac/wosac/*`
     and `wosac/wosac_likelihood/*` key, the stub's metametric as the
     rollouts' structure gives it;
 10. submission: `test_submission` at `leaderboard_config()` for one test-split
     scenario with K=128 futures: WOMD and WOSAC arrays of the submission's
     shapes, finite, in the global frame; the card's 32 futures equal the CPU's
     filter on the same buffer; the call timed;
 11. the training entry point (`trafficbotsv15_tpu_torch/run.py`), in a
     temporary directory, (b)'s fit first, then (b)'s resume, (a) and (d)
     while (c)'s subprocesses run beside them: (a) `run.fit` for 4 calls (accumulate_grad_batches=2,
     EMA 0.5, SWA from step 0) on the card and on the CPU from the same damped
     seed-0 weights and tbcache file: the first update's gradients agree, and
     each device's parameters, EMA and SWA agree with a CPU replay of its own
     updates; (b) `run.main(["action=fit", ...])` on `leaderboard_config()` with
     use_pallas=True from a tbcache of 8 training and 4 validation scenarios at
     batch 2: 2 steps, launches per step asserted (all staged, every launch at
     a full shape phase 3 checked), loss and grad_norm finite, "last" and "best"
     written, the restored parameters equal the live ones; then `resume=true`
     to step 3 from exactly the saved state and the next batch; (c) a
     `python -m trafficbotsv15_tpu_torch.run action=fit` subprocess at the
     phase-4 config gets SIGTERM after its first step: exit 143, and a resume
     adds one step; (d) `action=validate` from "last" gives the fit's own
     val/loss, `action=test` from "best" writes the K=128 arrays; (e) seconds
     per fit step, samples/s, peak memory, save and write seconds, checkpoint
     bytes, resume seconds (the fit step is (b)'s second);
 12. reference-torch goldens (`tests/golden/`, the original PyTorch modules'
     outputs), through the case functions of `tests/test_torch_golden_model.py`
     and `tests/test_torch_golden_sim.py` on the card: (a) every golden that
     reaches an attention kernel, in float32 with use_pallas=True (`attn_rpe`,
     `tfblock_enc_cross`: B2; `tfblock_enc_self_knn` at dense_knn_max=0: B4;
     `tfblock_dec_cross` at 0: both; `traffic_bots_full` at 0: B4 8, B2 6),
     each output within the CPU test's tolerance, the launches asserted
     exactly and all on the general route (float32); `traffic_bots_rnn` at 0:
     11 steps with both GRU hiddens carried, B4 26, B2 48; then every model
     and sim case with use_pallas=False (`gru_seq`, `gru_step` and
     `traffic_bots_rnn` among them), no kernel launched; (b) `leaderboard_config()`
     with use_pallas=True and damped seed-0 weights exported to the
     reference's state_dict layout (`tests/torch_reference_layout.py`, which
     gives `traffic_bots_full`'s 526 names and shapes), loaded back through
     `utils/torch_import.py::load_reference_state_dict`: every parameter
     bit-equal; one full-width call launches B1 90, B4 8, B2 360 (staged, at
     shapes phase 3 checked) and its K0 futures and rule flags equal, bit for
     bit, the directly loaded model's call. Phase 12's float32 golden launches
     are not recorded for the shape check of phases 6, 8, 9 and 11: the
     goldens themselves hold them;
 13. the scaled preset (`scaled_config()`: hidden 256, 8 heads, 12/6/6
     map/TL/agent layers, 120 steps against the 91 the log holds, bf16
     compute), random seed-0 weights, synthetic scenarios, use_pallas=False
     unless said, each path's one call or step both checked and timed (a
     first call, no warm-up): (a) `joint_future_pred`, 4 scenarios x K=32,
     level 1, in turns with (d)'s, B1 120 per call all at
     [128, 64, 1024], poses [4, 32, 64, 120, 3] finite, past the log no
     agent forced and the TL NLL masked; (b) `make_train_step` at the preset's batch of 1:
     B1 241 per step at [1, 64, 1024] (the
     rollout, its recompute, the posterior encoder), loss and grad_norm
     finite, every parameter a finite non-zero gradient but the action
     head's log_std; (c) `make_validate_step`, 4 scenarios x K=32: one step
     split by part, B1 120 + 121; (d) `joint_future_pred` with
     use_pallas=True, in turns with (a)'s (a d): B1 120, B4 12 and B2 720 per call, every B4 on the heads
     route and every B2 on the cluster route, none on the general route, at
     shapes phase 3 checked (B4 [4, 1024, 32, 256, 256, 8], B2 [128, 64, 89,
     256, 256, 8]); the first B4 and the first B2 launch of its call,
     captured, against the float32 plain versions on their own inputs at
     phase 3's bf16 tolerance; (f) `make_train_step` with use_pallas=True,
     built as (b)'s, in turns with (b)'s (b f): B1 241, B4 12 and B4-bwd 12 (all on the heads route), B2 1452 (all
     on the cluster route), B2-bwd 732 (all on the heads route, none on the general route) per step,
     every launch at a full shape phase 3 checked, the (b) checks of loss,
     grad_norm and gradients; the first B4-bwd and the first B2-bwd launch of its step
     with a non-zero incoming gradient, captured, against the float32 plain backward on its own inputs at
     phase 3's bf16 tolerance;
     (e) the phase-4 config rolled out to 35 steps against its 31 logged:
     the training step's gradients (phase 7's check) and the validation step
     with reactive replay's buffer (phase 9's) card vs CPU. (a)-(d) and (f)
     log seconds and peak memory;
 14. the serving entry point (`serve.py::InteractiveSimulator`) at
     `leaderboard_config()`, 1 scenario x 64 agents x 1024 polylines, random
     seed-0 weights: (a) use_pallas=False and (b) use_pallas=True, each turn
     `bench.py`'s serve measurement (reset, 3 warm-up steps, 50 timed steps
     with fetch=False and one synchronize), in turns a b b a:
     serve_policy_steps_per_sec, ms per step, reset seconds, peak memory;
     launches per reset and per step asserted by full shape (B1 1 per step at
     [1, 64, 1024]; in (b) B4 8 per reset at [1·1024, K=32] and B2 4 per step
     at [1·64, K=89], all staged, shapes phase 3 checked); then 20 steps with
     fetch=True, a step scripting the first valid agent (its bounded action
     the scripted one, its speed moved by dt times it) and `history()` of
     the documented shapes with finite poses; (c) the phase-4 config on the
     card and on the CPU, the CPU's latent and destination draws handed to
     the card, 10 steps with one scripted: poses, motion and actions within
     phase 4's tolerance, validity and TL states identical, launches as the
     config implies;
 15. data parallel over processes (`parallel/mesh.py`): (a) under
     deterministic algorithms, `run.main` fit at
     `leaderboard_config()` with use_pallas=True, batch 2, 1 step, on one
     NCCL rank (a torchrun environment of world 1) and without a process
     group, side by side: the parameters bit for bit; (b) two ranks sharing
     the card over gloo with CUDA tensors, each `make_train_step` on one
     scenario in float32 with dropout 0 and its share of the union's draws,
     against this process's step on the union batch of 2: the loss to 1e-6
     relative, the applied gradients to phase 7's tolerance, the parameters
     after the update to 1e-6 of their largest value against this process's
     AdamW fed each rank's gradients, the ranks' parameters and metrics
     identical, each rank's launches the training step's at half the union's
     shapes (all on the general route in float32); then `validate` of one batch
     per rank, the metrics identical on both; (d) the same two ranks, one step
     each under fsdp on a (2, 1) mesh (one scenario per rank) and under tp on
     a (1, 2) mesh (the union on each rank), from the same weights and draws:
     the loss to 1e-6 relative of (b)'s, the gathered gradients to phase 7's
     tolerance of (b)'s, the gathered parameters after the update to 1e-6 of
     their largest value against this process's AdamW fed the strategy's
     gathered gradients (their gap to (b)'s logged), the JAX package's count
     of sharded leaves (237, 352), the launches per rank (b)'s and their
     shapes (b)'s (fsdp) or the union's (tp), the ranks' parameters identical
     and losses to 1e-6 (tp's two ranks compute the same rows in the card's
     own order), each arm's seconds and peak memory per rank beside (b)'s,
     the dp step ((b) and (d) run off deterministic algorithms); then
     `run.main` fit at the same config cut to 20 rollout steps on synthetic
     scenes, one per rank, one step under fsdp and its checkpoint resumed
     under tp for a second: each
     call one step's launches, the ranks' parameters equal and finite, every
     rank in the collectives again after each call, finite losses at steps 1
     and 2, each call's seconds and peak memory; (c) (b) and (d) over NCCL on
     two cards where there are two, else "not run: 1 card";
 16. the TrafficBots RNN family (`leaderboard_config()` with
     temp_window_size=-1: the GRU agent encoder with tf_ag2mp, tf_ag2tl and
     tf_ag2ag, TL encoded and predicted by a GRU inside each rollout step,
     the flattened posterior, the GRU navi predictor), random seed-0 weights:
     (a) `joint_future_pred`, 4 scenarios x K=32, level 1, use_pallas=True, one
     call checked and timed (a first call): B1 90 at [128, 64, 1024], B2 360 at
     [128·64, K=64] and 360 at [128·64, K=25], B4 8 at [4·1024, K=32], all
     staged, by full shape, each checked in phase 3; seconds, peak memory,
     agent-steps/s; (b) the phase-4 config in the RNN family on the card and
     on the CPU in float32, use_pallas False and True:
     joint_future_pred's K0
     futures, TL states and rule flags, and one training step's loss terms and
     gradients, at phases 4 and 7's tolerances; (c) one training step at
     batch 8, use_pallas=True (a first step): loss and grad_norm finite and
     non-zero, forward and backward launches by full shape and route (B1 181,
     B2 1448, B2-bwd 728, B4 8 and B4-bwd 8, all staged); seconds, peak memory;
 17. the navigation family: (a) the phase-4 config on the card and on the CPU
     in float32 (20 of its 30 steps) with the same weights and draws, all
     with use_pallas: joint_future_pred's K0 futures, TL states and rule
     flags for goal and cmd and for goal and dest re-predicting their navi
     inside the rollout (`pred_navi_after_reached`; the K0 rows' navi
     log-probs too, at least one re-prediction), and one training step's
     loss terms and gradients for cmd, and goal and dest re-predicting (their
     per-step noise drawn on the CPU), at phases 4 and 7's tolerances; dest
     also at batch seed 0, where the CPU's float32 gradient lies across a kink
     of the loss: there the card is held against the CPU in float64, and the
     CPU's float32 distance from it is logged; (b) `leaderboard_config()` with
     navi_mode="goal", re-prediction and use_pallas, joint_future_pred 4
     scenarios x K=32 at level 1, one call checked and timed: B1 90 at [128, 64, 1024], B2 360
     at [128·64, K=89], the goal predictor's B2 3 at [4·64, K=32] and 270 at
     [128·64, K=32], B4 8 at [4·1024, K=32], all staged, by full shape, each
     checked in phase 3; seconds, peak memory, agents re-predicted;
 18. the variants: (a) `leaderboard_config()` with a type-branched `cat`
     posterior and a learned `cat` prior (8 factors of 2 classes over
     latent_dim 16), TL tokens at the 50 stop lines (tl_mode="stop"), the
     stacked TL input and use_pallas, random seed-0 weights: joint_future_pred
     4 scenarios x K=32 at level 1 with the K0 future deterministic, one call
     checked and timed (a first call):
     B1 91 (the prior's agent encoder adds one at [4, 64, 1024]), B4 8, B2 368
     (360 at [128·64, K=89]; the prior's 4 at [4·50, K=24] and 4 at [4·64,
     K=89]), all staged, by full shape, each checked in phase 3; the K0 latent
     the prior's argmax one-hot, every draw one-hot per factor, and std_cat's
     tie (all logits equal) drawing the first class on the card; then one
     training step at batch 8 (a first step): loss, KL and grad_norm finite and
     non-zero; B1 182, B4 and B4-bwd 8, B2 736, B2-bwd 376 (the posterior's and
     the prior's TL encoders at [8·50, K=24]), all staged, by full shape;
     seconds, peak memory, agent-steps/s and samples/s; (b) the phase-4 config
     on the card and on the CPU in float32 (20 of its 30 steps), the same
     weights and draws (the categorical latents' Gumbel noise from the CPU
     generator): joint_future_pred's K0 futures, TL states and rule flags and
     one training step's loss terms and gradients at phases 4 and 7's
     tolerances, launches as the config implies, in three arms
     (`VARIANT_ARMS`), all with use_pallas: cat + stop + stacked (the learned
     prior's B2), std_cat + InputEncoder "input" + pose_rpe "pe_xy_dir" +
     apply_q_rpe (no B2 or B4 launched), and pose_rpe "xy_dir" (B4 and B2 at
     d_rpe = 4, float32, so on the general route); (c) `leaderboard_config()`
     with pose_rpe "xy_dir" (a 4-wide RPE) and use_pallas, nothing else cut,
     random seed-0 weights: joint_future_pred 4 scenarios x K=32 at level 1
     (one call, checked and timed, a first call: B1 90, B4 8 at [4·1024,
     K=32, R=4] general, B2 360 at [128·64, K=89, R=4] staged) and one
     training step at batch 8 (a first step: B1 181, B4 and B4-bwd 8
     general, B2 728 (720 at [8·64, K=89], 8 posterior: 4 there and 4 at
     [8·128, K=24]) and B2-bwd 368 (364 and 4) staged), by full shape and
     route, none of B2's or B2-bwd's on the general route; seconds, peak
     memory and throughputs;
 19. the scene-centric model, token dedup and the last options: (a)
     `leaderboard_config()` with pairwise_relative=False and use_pallas,
     nothing else cut, random seed-0 weights: joint_future_pred 4 scenarios x
     K=32 at level 1 (one call, checked and timed, a first call) and one
     training step at batch 8 (a first step): no kernel launches at all, as
     in the JAX package (its KNN sorts, its attentions take no RPE); seconds,
     agent-steps/s or samples/s, peak memory; (b) `leaderboard_config()` with
     use_pallas, joint_future_pred 4 x K=32 with `rollout_token_dedup` (the
     rollout reading the 4 unique scenarios' map and TL tokens, token_rep 32)
     and without it, the same weights and generator seed, two calls each in
     turns (dedup, replicated, replicated, dedup): the first call of each
     compared over every buffer tensor, the K0 futures, TL states and rule
     flags held bit for bit (the first differing tensor named where any
     differs); each call's launches phase 6's (B1 90, B4 8, B2 360, staged, at
     shapes phase 3 checked); seconds and peak memory above what the call
     started with, of each call; (c) the phase-4
     config card vs CPU in float32 (20 of its 30 steps), use_pallas:
     scene-centric joint_future_pred (K0 futures, TL states, rule flags) and
     training step (loss terms, gradients), and a training step with gelu FFNs,
     `mean_valid` polyline pooling and dropout on the attention weights at p =
     0 (B2 and B4 off, as JAX's gates say), launches as the config implies;
 20. profiling, debugging and the validation videos: (a) `run.main` fit at
     the phase-4 config with use_pallas, 6 steps, `profile_dir` set: the
     trace file (`utils/profiling.py`, rank 0's gzip Chrome trace) parses,
     holds the ranges of fit steps 3-5 and no other, and its kernel events
     of the port's CUDA kernels, matched by kernel name, equal three steps'
     worth of the launch counters (the fit's launches over its six steps, as
     many per step as the config implies), each wrapper launch counted
     kernel by kernel (`CUDA_KERNELS`: the backwards' two weight-gradient
     passes, B4-bwd's drpe pass and B2-bwd's dx pass on their heads routes); the device's idle
     share over steps 3-5 from the trace; (b) phase 6's flagship call
     (use_pallas) cut to its first 30 rollout steps, traced by
     `profiling.trace` inside an `annotate` range, into a temporary directory
     deleted once read: its launches what 30 steps imply (B1 30, B4 8, B2
     120), its kernel events those launches' kernels, the device's busy and
     idle share of the range, the events, bytes and seconds; (c)
     `validation_video_inputs` of a reactive replay on the card at the phase-4
     config: the documented keys and shapes, finite poses; one scenario
     rendered where cv2 imports, else "videos: not run: no cv2"; then (a)'s
     config for one `debug_nans=true` fit step in this process, run under
     anomaly mode with NaN checks and the mode off after it. Three full-width
     fit steps are not traced: ~5,100 device ops per rollout step make a trace
     too large to read within the run.
Then it prints the `serve` JSON line (phase 14's steps/s, ms per step, peak memory
and the card-vs-CPU errors of both arms, with the card's name and power limit), the
`kernels` JSON line (forward launches from phase 6 and, as
`validate_launches`, from phase 9; training-shape and backward ones from phase
8, B4's and the backwards' by route; `fit_launches` per full-width fit step
from phase 11; `reference_layout_launches` from phase 12 (b); `scaled_launches`
per call or step of each path of phase 13, and the backwards' launches by route per
(f) step; B3's, B4's, B4-bwd's and B2-bwd's `heads_route` and
B2's `cluster_route` times at the scaled preset's shapes (B2-bwd's beside the general
kernel's there), B4's and B2's with
their launches per phase 13 (d) call, B4-bwd's and B2-bwd's with their launches per (f) step,
B3's with its launches in phase 3's bench run; the scaled training shapes'
launches per (f) step; B1's, B4's and B2's times at the serving shapes, and every
row's `serve_launches` per reset and per step of each phase 14 arm, by route; and
`parallel`, phase 15's checks, launches per rank and seconds; every row's `rnn_launches` per phase 16 (a) call
and (c) step, B1's and B2's and B2-bwd's `rnn_shapes` timings, and `rnn`, phase 16's seconds, peak memory and
throughputs; every row's `navi_launches` per phase 17 (b) call, B2's and B2-bwd's `navi_shapes`
timings, and `navi`, phase 17's seconds, peak memory, throughputs and re-predictions; every row's `variant_launches`
per phase 18 (a) call and step, by route, and per (c) call and step (`xy_dir_*`), B2's and B2-bwd's `variant_shapes`
and B4's, B2's and their backwards' `rpe4_shapes` timings (d_rpe = 4: B2 and B2-bwd on the staged route with the
general kernel's time beside them, B4 and B4-bwd general), each with its launches per (c) call and step, and
`variants`, phase 18's seconds, peak memory and throughputs, (c)'s as `xy_dir`;
every row's `scene_centric_launches` per phase 19 (a) call and step and per (b) dedup call, and `scene_centric`, phase
19's seconds, peak memory, throughputs and the dedup comparison; every row's `profiled_fit_launches` per phase
20 (a) fit step, and `profiling`, phase 20's trace summaries: events, bytes, busy and idle shares, seconds), the card
line, and last
`{"ok": true, "device": {...}}`.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from trafficbotsv15_tpu_torch import run as run_lib
from trafficbotsv15_tpu_torch.config import leaderboard_config, scaled_config, tiny_config, with_pallas
from trafficbotsv15_tpu_torch.data import tbcache
from trafficbotsv15_tpu_torch.data.preprocessing import pre_processing
from trafficbotsv15_tpu_torch.data.synthetic import make_batch
from trafficbotsv15_tpu_torch.eval import runner as eval_runner
from trafficbotsv15_tpu_torch.eval import wosac_likelihood
from trafficbotsv15_tpu_torch.eval.wosac_post_processing import filter_futures
from trafficbotsv15_tpu_torch.eval.wosac_metrics import FIELD_NAMES as WOSAC_FIELDS
from trafficbotsv15_tpu_torch.ops import knarpe, knn
from trafficbotsv15_tpu_torch.ops.distributions import DestCategorical, DiagGaussian
from trafficbotsv15_tpu_torch.parallel import mesh as mesh_lib
from trafficbotsv15_tpu_torch.serve import InteractiveSimulator
from trafficbotsv15_tpu_torch.sim import rollout as rollout_lib
from trafficbotsv15_tpu_torch.train import checkpoint as checkpoint_lib
from trafficbotsv15_tpu_torch.train import evaluation as eval_lib
from trafficbotsv15_tpu_torch.train import pipeline as train_lib
from trafficbotsv15_tpu_torch.train import swa as swa_lib
from trafficbotsv15_tpu_torch.train.evaluation import joint_future_pred
from trafficbotsv15_tpu_torch.train.optimizer import make_optimizer
from trafficbotsv15_tpu_torch.train.pipeline import build_model
from trafficbotsv15_tpu_torch.utils import bench_knarpe, build
from trafficbotsv15_tpu_torch.utils import profiling
from trafficbotsv15_tpu_torch.utils.logging import MetricsLogger
from trafficbotsv15_tpu_torch.utils.timing import card_line, cuda_ms, graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet, 700 W)
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 on the tensor cores, dense
KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K = 128, 64, 1024, 64  # 4 scenarios x 32 futures, agents, polylines, 2.0 * 32
KNN_TRAIN_ROWS = 8  # the training path's agent->map launch: 8 scenarios, no K-fold replication
SLICE_POSE_ATOL = 1e-3  # m; float32 on card vs CPU, reduction order only
# KNARPE shapes (n_b, n_s, K, D, R, H) on the full-width path: the agent decoder's
# cross-attention (128 rollouts x 64 agents, 64 map + 25 TL targets) and the map encoder
X_PATH = (128, 64, 89, 128, 128, 4)
ATTN_PATH = (4, 1024, 32, 128, 128, 4)
# and on the training path (8 scenarios, no K-fold replication): the agent decoder's B2 and its
# backward at 8 x 64 sources, the map encoder's B4 and its backward at 8 x 1024
TRAIN_X_PATH = (8, 64, 89, 128, 128, 4)
TRAIN_ATTN_PATH = (8, 1024, 32, 128, 128, 4)
# the training path's posterior encoders: the agent encoder's B2 at TRAIN_X_PATH, the TL encoder's
# at 8 x 128 TL lanes over K=24 map targets (0.75 x 32)
POST_TL_X_PATH = (8, 128, 24, 128, 128, 4)
# and the training entry point's (phase 11: `run.fit` at the flagship's batch_size_train=2): the agent decoder's
# B2 and its backward at 2 x 64, the posterior TL encoder's at 2 x 128 over K=24, the map encoder's B4 and its
# backward at 2 x 1024; B1 at [2, 64, 1024]; and its validation's (4 scenarios, as phase 9's): reactive replay's
# B2 at 4 x 64 and its posterior TL encoder's at 4 x 128, B1 at [4, 64, 1024]
FIT_X = [(2, 64, 89, 128, 128, 4), (2, 128, 24, 128, 128, 4)]
VAL_X = [(4, 64, 89, 128, 128, 4), (4, 128, 24, 128, 128, 4)]
FIT_ATTN_PATH = (2, 1024, 32, 128, 128, 4)
FIT_KNN = [(2, 64, 1024, 64), (4, 64, 1024, 64)]
# and the serving entry point's (phase 14: one scenario): the map encoder's B4 at 1 x 1024 at reset, the agent
# decoder's B2 at 1 x 64 and B1 at [1, 64, 1024] every step
SERVE_X_PATH = (1, 64, 89, 128, 128, 4)
SERVE_ATTN_PATH = (1, 1024, 32, 128, 128, 4)
SERVE_KNN = ("knn_xy", 1, 64, 1024, 64)
# and the TrafficBots RNN family's (phase 16: `leaderboard_config()` with temp_window_size=-1): its agent encoder
# attends to the map (K=64) and to the TL lanes (K=25) in separate blocks, where HPTR's decoder attends to both at
# K=89: B2 at [128·64, K=64] and [128·64, K=25] per eval step, at [8·64, ...] per training step and its recompute,
# and the flattened posterior's at [8, 64 agents x 19 down-sampled steps = 1216, K=64] over the map and at
# [8·19, 64, K=25] over the TL lanes; B2-bwd at the training shapes; B1 at the posterior's [8, 1216, 1024]. Its
# agent self-attention (64 agents, K=25) is dense under dense_knn_max 128, so B4 runs in the map encoder only, at
# ATTN_PATH and TRAIN_ATTN_PATH as in HPTR mode
RNN_X = [(128, 64, 64, 128, 128, 4), (128, 64, 25, 128, 128, 4)]
RNN_TRAIN_X = [(8, 64, 64, 128, 128, 4), (8, 64, 25, 128, 128, 4), (8, 1216, 64, 128, 128, 4),
               (152, 64, 25, 128, 128, 4)]
RNN_POST_KNN = (8, 1216, 1024, 64)
# and the navigation family's (phase 17: `leaderboard_config()` with navi_mode="goal" and pred_navi_after_reached): the
# goal predictor's tf_ag2mp (3 layers) attends to the K = n_tgt_knn x k_tgt_knn = 32 nearest map polylines, B2 at
# [4 scenarios, 64 agents, K=32] once per eval call before the futures replicate, then at [128·64, K=32] at every
# rollout step (re-prediction); a training step at batch 8 launches B2 and B2-bwd at [8·64, K=32] (the first
# prediction, every step and its recompute): phase 17 runs no such step, phase 3 checks and times its shape
NAVI_X = [(4, 64, 32, 128, 128, 4), (128, 64, 32, 128, 128, 4)]
NAVI_TRAIN_X = [(8, 64, 32, 128, 128, 4)]
# and the variants' (phase 18 (a): `leaderboard_config()` with categorical latents, a learned `cat` prior, TL tokens
# at the 50 stop lines and the stacked TL input): the prior's TL encoder attends to the K = 0.75 x 32 = 24 nearest map
# polylines, B2 at [4 scenarios, 50 stop lines, K=24] once per eval call (its agent encoder at [4·64, K=89], VAL_X's);
# a training step at batch 8 launches B2 and B2-bwd at [8·50, K=24] in the posterior's and the prior's TL encoders
VARIANT_X = [(4, 50, 24, 128, 128, 4), (8, 50, 24, 128, 128, 4)]
VARIANT_TRAIN_X = [(8, 50, 24, 128, 128, 4)]
# the 4-wide RPE of pose_rpe "xy_dir" (phase 18 (b) at the phase-4 config in float32, (c) at the flagship's widths in
# bf16): bf16 B2 and B2-bwd (B3's too) take the staged route of csrc/knarpe_staged.cuh and csrc/knarpe_bwd_staged.cuh,
# rpe zero-padded there to 16 columns; B4 and B4-bwd the general route of csrc/knarpe.cu and csrc/knarpe_bwd.cu (their
# staged kernels refuse d_rpe % 16, code 2, the heads kernels take only D=R=256). The phase-4 config's shapes (hidden
# 64, 2 heads, n_tgt_knn 4: B4 over 512 polylines at K=4, B2 over 2 futures x 16 agents at K=11 and the posterior TL's
# 16 lanes at K=3; a training step's at batch 1) and the flagship's widths (D=128, H=4) at its eval and training shapes
# and the posterior TL encoder's [8·128, K=24]
RPE4_ATTN = [(1, 512, 4, 64, 4, 2), (4, 1024, 32, 128, 4, 4), (8, 1024, 32, 128, 4, 4)]
RPE4_X = [(2, 16, 11, 64, 4, 2), (1, 16, 3, 64, 4, 2), (128, 64, 89, 128, 4, 4), (8, 64, 89, 128, 4, 4),
          (8, 128, 24, 128, 4, 4)]
RPE4_ATTN_BWD = [(1, 512, 4, 64, 4, 2), (8, 1024, 32, 128, 4, 4)]
RPE4_X_BWD = [(1, 16, 11, 64, 4, 2), (1, 16, 3, 64, 4, 2), (8, 64, 89, 128, 4, 4), (8, 128, 24, 128, 4, 4)]
# and the staged route's edge shapes at d_rpe = 4, forward and backward: one head at D=16, K=5; K=1 at a single
# source (all invalid); 8192 + 7 sources at the flagship's widths (no multiple of the grid). Each takes two groups of
# warps a block in the forward; eight heads take one (staged::group_count), and the general backward (the staged
# backward takes up to 4 heads)
RPE4_X_EDGE = [(3, 7, 5, 16, 4, 1), (1, 1, 1, 64, 4, 2), (1, 8199, 89, 128, 4, 4)]
RPE4_X_EIGHT_HEADS = (1, 33, 89, 64, 4, 8)
# edge cases: an all-invalid and a one-target source in each; source counts that are
# no multiple of any tile; odd K; one and eight heads
X_EDGE = [(3, 7, 5, 16, 16, 2), (1, 33, 89, 32, 16, 8)]
ATTN_EDGE = [(3, 7, 5, 16, 16, 2), (2, 17, 89, 64, 32, 1)]
# bf16 B4 and B4-bwd shapes phase 3 holds on the staged route (csrc/knarpe_attn_staged.cuh,
# csrc/knarpe_attn_bwd_staged.cuh) besides the paths' and ATTN_EDGE: K=5 and K=24 (no multiple of 16) at
# 97 sources (under the 132-block grid, no multiple of the four groups or the ring), a single source and
# 8 x 1024 + 7 sources; and an eight-head shape the staged kernels refuse, on the general route
ATTN_STAGED_EDGE = [(1, 97, 5, 128, 128, 4), (1, 97, 24, 64, 64, 2), (1, 1, 32, 128, 128, 4),
                    (1, 8199, 32, 128, 128, 4), FIT_ATTN_PATH]
ATTN_GENERAL = [(1, 33, 89, 32, 16, 8)]
# the scaled preset's map encoder (4 scenarios x 1024 polylines, D=R=256, 8 heads): B4 forward on the heads route
SCALED_ATTN_PATH = (4, 1024, 32, 256, 256, 8)
# and its training path's (batch 1): B4 forward timed there on the heads route, B4-bwd on the heads route of
# csrc/knarpe_attn_bwd_heads.cuh
SCALED_TRAIN_ATTN_PATH = (1, 1024, 32, 256, 256, 8)
# bf16 B4 on the heads route (csrc/knarpe_attn_heads.cuh) at D=R=256, 8 heads: both scaled shapes, K=5 and K=24
# (no multiple of 16) and K=40 (the largest its shared memory takes) at 97 sources (no multiple of the grid or the
# groups), a single source (fewer than the grid's slots) and 8 x 1024 + 7 sources; each has an all-invalid and a
# one-target source and runs with k and v the halves of one tensor and as two tensors
HEADS_ATTN = [SCALED_ATTN_PATH, SCALED_TRAIN_ATTN_PATH, (1, 97, 5, 256, 256, 8), (1, 97, 24, 256, 256, 8),
              (1, 97, 40, 256, 256, 8), (1, 1, 32, 256, 256, 8), (1, 8199, 32, 256, 256, 8)]
# and the general route where the heads kernel refuses too, by its refusal code: K=89 at D=R=256, 8 heads (its
# shared memory, code 3), and ATTN_GENERAL's eight heads at other widths (widths it is not compiled for, code 2)
GENERAL_B4 = {(1, 33, 89, 256, 256, 8): 3, ATTN_GENERAL[0]: 2}
# bf16 B4-bwd on the heads route (csrc/knarpe_attn_bwd_heads.cuh) at D=R=256, 8 heads: the scaled training shape, K=5
# and K=24 (no multiple of 16) and K=40 (the largest its shared memory takes) at 97 sources, a single source and
# 8 x 1024 + 7 sources; each has an all-invalid and a one-target source and runs with k and v the halves of one
# tensor and as two tensors
HEADS_ATTN_BWD = [SCALED_TRAIN_ATTN_PATH, (1, 97, 5, 256, 256, 8), (1, 97, 24, 256, 256, 8), (1, 97, 40, 256, 256, 8),
                  (1, 1, 32, 256, 256, 8), (1, 8199, 32, 256, 256, 8)]
# and the general route where the heads backward refuses too, by its refusal code: K=48 at D=R=256, 8 heads (its
# shared memory, code 3), K=89 there (over the softmax's 64, code 1), and ATTN_GENERAL's eight heads at other widths
# (widths it is not compiled for, code 2)
GENERAL_B4_BWD = {(1, 33, 48, 256, 256, 8): 3, (1, 33, 89, 256, 256, 8): 1, ATTN_GENERAL[0]: 2}
# bf16 B2 backward shapes phase 3 holds on the staged route (csrc/knarpe_bwd_staged.cuh) besides the
# training path's: K not a multiple of 16 with an all-invalid source at 21 sources (under the 132-block
# grid), and 200 sources (no multiple of the grid); and the eight-head edge shape the staged backward
# refuses, which takes the general route (csrc/knarpe_bwd.cu)
X_BWD_EDGE = [(3, 7, 5, 16, 16, 2), (2, 100, 40, 128, 128, 4), *FIT_X]
X_BWD_GENERAL = [X_EDGE[1]]
# kernel vs plain version: float32 differs by summation order only (the kernel
# reassociates the projections with the attention, csrc/knarpe.cu); bf16 rounds
# once at the output, so half a bf16 ulp (<= 2^-8 of the value) on top. B3 rounds
# k and q*k to bf16 as its plain version does, and a rounding that the other
# float32 summation order flips moves a logit by up to an ulp of one q*k term: one
# ulp of the output (2^-7) plus 2^-8 of the largest output; and its mean error
# must stay under a quarter of what leaving its roundings out would give
KNARPE_F32_ATOL, BF16_HALF_ULP, BF16_ULP = 1e-4, 2.0 ** -8, 2.0 ** -7
# rollout steps whose rule checks phase 6 replays on the CPU; the flags may differ
# where CUDA's sinf/cosf (within 2 ulp of the CPU's) move a box corner across a
# threshold, so at most this share of the flags may differ
RULE_STEPS, RULE_FLAG_SHARE = (0, 30, 60, 89), 1e-4
# backward kernels vs autograd of the plain versions, each gradient against its own largest
# magnitude M: float32 1e-4 M (summation order; dW and db sum over every source); bf16 against
# the float32 plain backward on the same bf16-valued inputs: 2^-8 of each value plus 1e-4 M
KNARPE_BWD_F32_REL = 1e-4
# training step, card vs CPU in float32 (phase 7): loss terms and grad_norm to 1e-4 relative,
# every parameter's gradient to 1e-3 of its scale: summation order in the kernels and cuBLAS
# through 30 BPTT steps of a damped closed loop. A gradient's scale is its largest magnitude, but
# at least 1e-3 of the largest over the model, so that one ~0 by cancellation (a bias before a
# LayerNorm) is not held to its rounding noise
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-3
# validation step, card vs CPU in float32 (phase 9): the rollout buffers to SLICE_POSE_ATOL, the rule flags
# to RULE_FLAG_SHARE; loss terms, error and rule sums, WOMD modes and scores, native motion metrics and the
# realism fields to 1e-4 relative (1e-6 absolute near zero; modes also SLICE_POSE_ATOL absolute). The joint
# futures are more than the 32 the WOSAC filter keeps, so that it selects
VALIDATE_REL, VALIDATE_K = 1e-4, 34
# navi log-probs of the re-predicting rollout, card vs CPU (phase 17 (a)): the slice tests' log-prob tolerance
NAVI_LOGP_ATOL = 1e-4
# phase 17 (a) rolls the phase-4 config out 20 of its 30 steps: it only holds a path against the CPU, and the
# run's length has a budget
NAVI_CHECK_END = 20


def log(*a):
    print(*a, flush=True)


def knn_case(gen, n_rows, n_src, n_tgt, grid=False, p_src=0.2, p_tgt=0.2):
    src = torch.rand(n_rows, n_src, 2, generator=gen) * 200 - 100
    tgt = torch.rand(n_rows, n_tgt, 2, generator=gen) * 200 - 100
    if grid:  # integer grid: exact squares and many distance ties
        src, tgt = (src / 10).round() * 10, (tgt / 10).round() * 10
    src_inv = torch.rand(n_rows, n_src, generator=gen) < p_src
    tgt_inv = torch.rand(n_rows, n_tgt, generator=gen) < p_tgt
    return [t.cuda().contiguous() for t in (src, src_inv, tgt, tgt_inv)]


def time_knn(args, k: int) -> dict:
    """Kernel B1 (eager, and device time from a CUDA graph), its plain version and torch.topk on the
    materialised distances at one shape, with the bound."""
    ms = cuda_ms(lambda: knn.knn_xy(*args, k), 200)
    device_ms = graph_ms(lambda: knn.knn_xy(*args, k))
    plain_ms = cuda_ms(lambda: knn.knn_xy_reference(*args, k), 20)
    src, src_inv, tgt, tgt_inv = args
    dist = torch.cdist(src, tgt)
    dist = torch.where(src_inv[:, :, None] | tgt_inv[:, None, :], float("inf"), dist)
    library_ms = cuda_ms(lambda: torch.topk(dist, k, dim=-1, largest=False), 100)  # timing yardstick only
    n_rows, n_src, n_tgt = src.shape[0], src.shape[1], tgt.shape[1]
    bytes_moved = (src.numel() * 4 + src_inv.numel() + tgt.numel() * 4 + tgt_inv.numel()
                   + n_rows * n_src * k * (4 + 4))
    ops = n_rows * n_src * n_tgt * 7  # 2 sub, 2 mul, add, sqrt, one compare per pair
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  knn_xy timing at [{n_rows},{n_src},{n_tgt}] k={k}: kernel {ms:.4f} ms ({device_ms:.4f} ms of device "
        f"time, launched from a CUDA graph), plain {plain_ms:.4f} ms, torch.topk on materialised distances "
        f"{library_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({bytes_moved / 1e6:.2f} MB), kernel at "
        f"{100 * bound_ms / ms:.2f}% of the bound")
    return {"shape": [n_rows, n_src, n_tgt, k], "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


# B1 cases phase 3 checks, name: (rows, sources, targets, k, knn_case options)
KNN_CASES = {
    "main_path_float": (KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K, {}),
    "integer_grid_ties": (KNN_ROWS, KNN_SRC, KNN_TGT, KNN_K, dict(grid=True)),
    "invalid_rows_and_targets": (8, 64, 1024, KNN_K, dict(grid=True, p_src=0.3, p_tgt=0.97)),
    "k_equals_n_tgt": (2, 8, 128, 128, {}),
    "training_shape": (KNN_TRAIN_ROWS, KNN_SRC, KNN_TGT, KNN_K, {}),
    "all_targets_at_one_point": (4, 64, 1024, KNN_K, dict(p_tgt=0.0)),
    "k_1": (16, 64, 1024, 1, dict(grid=True)),
    "k_equals_n_tgt_1024": (4, 16, 1024, 1024, dict(grid=True)),
    "n_tgt_1000": (8, 64, 1000, KNN_K, {}),
    "n_tgt_2048": (4, 64, 2048, KNN_K, dict(grid=True)),
    "every_source_invalid": (4, 64, 1024, KNN_K, dict(p_src=1.0)),
    "scaled_training_shape": (1, KNN_SRC, KNN_TGT, KNN_K, {}),  # the scaled preset's batch_size_train=1
    "rnn_posterior": (*RNN_POST_KNN, {}),  # the RNN family's flattened posterior (phase 16)
    **{f"entry_{rows}x{src}_k{k}": (rows, src, tgt, k, {}) for rows, src, tgt, k in FIT_KNN},
}


def check_knn_kernel() -> dict:
    """Kernel B1 vs its plain version: identical indices, bit-equal distances; timed at the eval and
    the training path's shapes."""
    gen = torch.Generator().manual_seed(0)
    cases = {name: (knn_case(gen, rows, src, tgt, **kw), k) for name, (rows, src, tgt, k, kw) in KNN_CASES.items()}
    src_inv, tgt_inv = cases["invalid_rows_and_targets"][0][1::2]
    tgt_inv[0] = True  # a row with no valid target: every source emits its +inf tail
    src_inv[1, 5] = True  # an invalid source in another row
    cases["all_targets_at_one_point"][0][2][:] = torch.tensor([3.0, -7.0], device="cuda")  # every distance tied
    max_err = 0.0
    for name, (args, k) in cases.items():
        d, i = knn.knn_xy(*args, k)
        torch.cuda.synchronize()
        d_ref, i_ref = knn.knn_xy_reference(*args, k)
        if not torch.equal(i, i_ref):
            raise AssertionError(f"knn_xy {name}: indices differ from the plain version")
        if not torch.equal(d, d_ref):
            raise AssertionError(f"knn_xy {name}: distances not bit-equal to the plain version")
        fin = torch.isfinite(d_ref)
        max_err = max(max_err, float((d[fin] - d_ref[fin]).abs().max()) if fin.any() else 0.0)
        log(f"  knn_xy {name}: shape {list(d.shape)} indices identical, distances bit-equal "
            f"(+inf entries {int((~fin).sum())})")

    row = time_knn(*cases["main_path_float"])
    train = time_knn(*cases["training_shape"])
    serve = time_knn(*cases["scaled_training_shape"])  # [1, 64, 1024]: also the serving entry point's (phase 14)
    rnn_post = time_knn(*cases["rnn_posterior"])
    row.pop("shape")
    return {"name": "knn_xy", "route": "cuda", "source": "trafficbotsv15_tpu_torch/csrc/knn.cu",
            "replaces": "trafficbotsv15_tpu/ops/pallas_knn.py:143", "launches": None, "max_abs_err": max_err,
            **row, "training_shape": train, "serve_shape": serve, "rnn_shapes": [rnn_post]}


def knarpe_inputs(shape, cross: bool, seed: int, dtype=torch.float32):
    """Operands of B2/B3 (cross) or B4, drawn on the card from a seed (the largest shapes hold ~10^8 values each,
    seconds apiece to draw on the host); one source has no valid target and one has a single valid target."""
    n_b, n_s, n_knn, d, r, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def f(*size, scale=1.0):
        return (scale * torch.randn(size, generator=gen, device="cuda")).to(dtype)

    inv = torch.rand((n_b, n_s, n_knn), generator=gen, device="cuda") < 0.3
    inv[0, 0] = True
    inv[-1, -1, 1:] = True
    w_rpe, b = f(r, 2 * d, scale=r ** -0.5), f(2 * d, scale=0.1)
    if cross:
        return [f(n_b, n_s, d), f(n_b, n_s, n_knn, d), f(n_b, n_s, n_knn, r), inv, f(d, 2 * d, scale=d ** -0.5),
                w_rpe, b]
    kv = f(n_b, n_s, n_knn, 2 * d)  # the map encoder hands B4 the halves of one gathered [.., 2D] tensor
    return [f(n_b, n_s, d), *kv.chunk(2, -1), f(n_b, n_s, n_knn, r), inv, w_rpe, b]


def knarpe_library_call(name: str, args, n_head: int):
    """The PyTorch composition that computes the same function (timing yardstick
    only, never called by the port): one matmul for the projections, then
    scaled_dot_product_attention with a boolean mask."""
    if name != "knarpe_attention":
        return bench_knarpe.library_fullwidth(*args, n_head)
    q, k, v, rpe, inv, w, b = args
    rk, rv = (rpe @ w + b).chunk(2, -1)
    return bench_knarpe.library_attention(q, k + rk, v + rv, inv, n_head)


def knarpe_bound(name: str, args, n_head: int) -> tuple:
    """(bytes, operations) the function needs: each operand read once, the output written once; the
    multiply-adds of the reassociated forward (csrc/knarpe.cu), per source with input width X (R for
    B4, D + R for B2/B3): u_h = W_k[:, h] q_h and out_h = y_h W_v[:, h], 2 X D; logits and
    y_h = sum_j attn_hj x_j, 2 K X H; for B4 q.k and attn.v, 2 K D. B3 forms k for its roundings
    (K X D in place of the logits' K X H, plus q.k, K D). The softmax's K H terms are left out."""
    q = args[0]
    n_b, n_s, d = q.shape
    rpe = args[3] if name == "knarpe_attention" else args[2]
    n_knn, r = rpe.shape[2], rpe.shape[3]
    n_src = n_b * n_s
    nbytes = sum(a.numel() * a.element_size() for a in args) + q.numel() * q.element_size()
    x = r if name == "knarpe_attention" else d + r
    macs = 2 * x * d + 2 * n_knn * x * n_head
    if name == "knarpe_attention":
        macs += 2 * n_knn * d
    elif name == "knarpe_cross_attention_v3":
        macs += n_knn * x * d - n_knn * x * n_head + n_knn * d
    return nbytes, 2 * n_src * macs


def check_one_knarpe(name: str, shape, seed: int, want_route: str = "staged", separate_kv: bool = False) -> tuple:
    """Kernel vs plain version in float32 and bfloat16, bf16 on want_route; B4's k and v the halves of one
    tensor, or with separate_kv two tensors; returns the float32 and the bf16 max |err| (the bf16 one against
    the reference the tolerance is taken from)."""
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    cross, n_head = name != "knarpe_attention", shape[-1]
    args = knarpe_inputs(shape, cross, seed)
    if separate_kv:
        args[1], args[2] = args[1].contiguous(), args[2].contiguous()
    out = kernel(*args, n_head)
    torch.cuda.synchronize()
    ref = plain(*args, n_head)
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and err <= KNARPE_F32_ATOL and torch.all(out[0, 0] == 0)):
        raise AssertionError(f"{name} {shape} float32: max |err| {err} (tolerance {KNARPE_F32_ATOL}), "
                             f"all-invalid source zero: {bool(torch.all(out[0, 0] == 0))}")
    a16 = [a if a.dtype == torch.bool else a.to(torch.bfloat16) for a in args]
    before = dict(knarpe.ROUTE_LAUNCHES)
    out16 = kernel(*a16, n_head).float()
    torch.cuda.synchronize()
    took = [key.split("/")[1] for key, n in knarpe.ROUTE_LAUNCHES.items() if n != before[key]]
    if took != [want_route]:
        raise AssertionError(f"{name} {shape} bf16: launched on the {took} route, expected {want_route}")
    ref32 = plain(*[a if a.dtype == torch.bool else a.float() for a in a16], n_head)
    note = ""
    if name.endswith("_v3"):  # B3's roundings are in its plain version, in bf16
        ref16 = plain(*a16, n_head).float()
        rtol, atol = BF16_ULP, 2.0 ** -8 * float(ref16.abs().max())
        mean_err, mean_unrounded = float((out16 - ref16).abs().mean()), float((ref32 - ref16).abs().mean())
        if not mean_err <= 0.25 * mean_unrounded:
            raise AssertionError(f"{name} {shape} bf16: mean |err| {mean_err} vs {mean_unrounded} without roundings")
        note = f"; mean |err| {mean_err:.2e} against {mean_unrounded:.2e} without its roundings"
    else:
        ref16, rtol, atol = ref32, BF16_HALF_ULP, KNARPE_F32_ATOL
    excess = float(((out16 - ref16).abs() - (rtol * ref16.abs() + atol)).max())
    if not (torch.isfinite(out16).all() and excess <= 0 and torch.all(out16[0, 0] == 0)):
        raise AssertionError(f"{name} {shape} bf16: |err| exceeds {rtol} relative + {atol} by {excess}")
    if not torch.equal(kernel(*a16, n_head).float(), out16):  # no bf16 kernel has atomics
        raise AssertionError(f"{name} {shape} bf16: two launches on the same inputs differ")
    note += f"; {want_route} route, two launches bit-identical" + ("; k and v two tensors" if separate_kv else "")
    err16 = float((out16 - ref16).abs().max())
    log(f"  {name} {list(shape)} (n_b, n_s, K, D, R, H): float32 max |err| {err:.3e} (tolerance "
        f"{KNARPE_F32_ATOL}); bf16 max |err| {err16:.3e}, within {rtol:g} relative + {atol:.3g} absolute{note}; "
        f"all-invalid source zero")
    return err, err16


def time_knarpe(name: str, shape) -> dict:
    """Kernel, plain version and library composition at one shape (bf16), with the bound. The kernel's
    eager time includes the host's launch cost where that is longer (the training path's small
    launches), so its device time from a CUDA graph of 50 launches is logged beside it."""
    kernel, plain = getattr(knarpe, name), getattr(knarpe, f"{name}_reference")
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed=1, dtype=torch.bfloat16)
    ms = cuda_ms(lambda: kernel(*args, n_head), 50)
    device_ms = graph_ms(lambda: kernel(*args, n_head))
    plain_ms = cuda_ms(lambda: plain(*args, n_head), 10)
    library_ms = cuda_ms(lambda: knarpe_library_call(name, args, n_head), 20)
    nbytes, ops = knarpe_bound(name, args, n_head)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name} timing at {list(shape)} bf16: kernel {ms:.4f} ms ({device_ms:.4f} ms of device time, launched "
        f"from a CUDA graph), plain {plain_ms:.4f} ms, "
        f"matmul + scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at {100 * bound_ms / ms:.2f}% of the bound")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


# bf16 B2/B3 shapes that phase 3 holds against the plain versions on the staged route; phases 6 and 8
# check that the paths launch no other
CHECKED_X = {s[2:] for s in (X_PATH, TRAIN_X_PATH, POST_TL_X_PATH, *X_EDGE, *FIT_X, *VAL_X, *RNN_X, *RNN_TRAIN_X,
                              *NAVI_X, *NAVI_TRAIN_X, *VARIANT_X)}
# bf16 B2/B3 shapes the staged kernel refuses: the scaled preset's widths (D=R=256, 8 heads), at its eval
# shape (4 scenarios x 32 futures x 64 agents, K=89) too, and K=90 and K=128 at the flagship's D=R=128, H=4
SCALED_X_PATH = (128, 64, 89, 256, 256, 8)
# B2 the cluster route (csrc/knarpe_cluster.cuh) at D=R=256, 8 heads: the eval shape, the scaled training path's
# (batch 1 x 64 agents, and its posterior TL encoder's), K=5 and K=24 (no multiple of 16) and K=104 (the largest its
# shared memory takes) at 21 sources, a single source (fewer than the clusters), and 8192 + 7 sources (no multiple of
# the grid); each has an all-invalid and a one-target source. Timed at the scaled preset's eval shape
SCALED_TRAIN_X_PATH = (1, 64, 89, 256, 256, 8)
# and the scaled training path's posterior TL encoder (batch 1 x 128 TL lanes over K=24 map targets), on the cluster
# route forward and the heads route backward
SCALED_POST_TL_X_PATH = (1, 128, 24, 256, 256, 8)
CLUSTER_X = [SCALED_X_PATH, (2, 64, 89, 256, 256, 8), SCALED_TRAIN_X_PATH, SCALED_POST_TL_X_PATH,
             (1, 21, 5, 256, 256, 8), (1, 21, 24, 256, 256, 8), (1, 21, 104, 256, 256, 8), (1, 1, 89, 256, 256, 8),
             (1, 8199, 89, 256, 256, 8)]
# and the general route where the cluster kernel refuses too, by its refusal code: K=120 at D=R=256, 8 heads (its
# shared memory, code 3), K=90 and K=128 at D=R=128 (widths it is not compiled for, code 2)
GENERAL_B2_X = {(2, 64, 120, 256, 256, 8): 3, (2, 64, 90, 128, 128, 4): 2, (2, 64, 128, 128, 128, 4): 2}
# B3 the heads route (csrc/knarpe_v3_heads.cuh) at D=R=256, 8 heads: the eval shape, the scaled training path's,
# K=5 and K=24 (under one 32-target tile) and K=200 (seven tiles; the ring streams any K, so none is the largest its
# shared memory takes) at 21 sources, a single source (fewer than the grid's slots) and 8192 + 7 sources (no multiple
# of the grid); each has an all-invalid and a one-target source. Timed at the scaled preset's eval and training shapes
V3_HEADS_X = [SCALED_X_PATH, SCALED_TRAIN_X_PATH, (1, 21, 5, 256, 256, 8), (1, 21, 24, 256, 256, 8),
              (1, 21, 200, 256, 256, 8), (1, 1, 89, 256, 256, 8), (1, 8199, 89, 256, 256, 8)]
# and the general route where the heads kernel refuses too, by its refusal code: K=90 and K=128 at D=R=128 (widths
# it is not compiled for, code 2)
GENERAL_B3_X = {(2, 64, 90, 128, 128, 4): 2, (2, 64, 128, 128, 128, 4): 2}
# bf16 B2-bwd on the heads route (csrc/knarpe_bwd_heads.cuh) at D=R=256, 8 heads: the scaled training path's two
# shapes (B2's and B3's Function), and through B2's K=1, K=5 and K=81 (no multiple of 16) and K=128 (the largest it
# takes) at 21 sources (fewer than the grid's slots), a single source and 8 x 64 + 7 sources (no multiple of the
# slots); each has an all-invalid and a one-target source
SCALED_TRAIN_X_BWD = [SCALED_TRAIN_X_PATH, SCALED_POST_TL_X_PATH]
HEADS_X_BWD = SCALED_TRAIN_X_BWD + [(1, 21, 1, 256, 256, 8), (1, 21, 5, 256, 256, 8), (1, 21, 81, 256, 256, 8),
                                    (1, 21, 128, 256, 256, 8), (1, 1, 89, 256, 256, 8), (1, 519, 89, 256, 256, 8)]
# and the general route where the heads backward refuses too, by its refusal code: K=129 at D=R=256, 8 heads (over its
# softmax's 128, code 1), and X_BWD_GENERAL's eight heads at other widths (widths it is not compiled for, code 2)
GENERAL_B2_BWD = {(1, 9, 129, 256, 256, 8): 1, X_BWD_GENERAL[0]: 2}


def check_knarpe_kernels() -> list:
    """Kernels B4, B2, B3 vs their plain versions at the paths' and edge shapes; times at the eval
    path's shapes (the row) and at the training path's (B4: the row's `training_shape`; B2, B3: logged)
    (bf16)."""
    rows = []
    for name, path, edges, replaces, source in (
            ("knarpe_attention", ATTN_PATH, ATTN_EDGE + [TRAIN_ATTN_PATH, *ATTN_STAGED_EDGE, SERVE_ATTN_PATH],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:243", "trafficbotsv15_tpu_torch/csrc/knarpe_attn_staged.cuh"),
            ("knarpe_cross_attention", X_PATH, X_EDGE + [TRAIN_X_PATH, POST_TL_X_PATH, *FIT_X, *VAL_X, SERVE_X_PATH],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:443", "trafficbotsv15_tpu_torch/csrc/knarpe_staged.cuh"),
            ("knarpe_cross_attention_v3", X_PATH, X_EDGE + [TRAIN_X_PATH, POST_TL_X_PATH, *FIT_X, *VAL_X],
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:742", "trafficbotsv15_tpu_torch/csrc/knarpe_staged.cuh")):
        max_err = check_one_knarpe(name, path, seed=1)[0]
        for i, shape in enumerate(edges):
            check_one_knarpe(name, shape, seed=2 + i)
        row = time_knarpe(name, path)
        serve_shape = {"knarpe_attention": SERVE_ATTN_PATH, "knarpe_cross_attention": SERVE_X_PATH}.get(name)
        if serve_shape:  # the serving entry point's shape (phase 14)
            row["serve_shape"] = {"shape": list(serve_shape), **time_knarpe(name, serve_shape)}
        if name == "knarpe_attention":
            row["training_shape"] = {"shape": list(TRAIN_ATTN_PATH), **time_knarpe(name, TRAIN_ATTN_PATH)}
            # bf16 only: float32 B4 takes the general kernel at these shapes, which check_one_knarpe holds too
            err16 = max(check_one_knarpe(name, shape, seed=20 + i, want_route="heads", separate_kv=separate)[1]
                        for separate in (False, True) for i, shape in enumerate(HEADS_ATTN))
            row["heads_route"] = {"name": "knarpe_attention", "route": "cuda",
                                  "source": "trafficbotsv15_tpu_torch/csrc/knarpe_attn_heads.cuh",
                                  "replaces": replaces, "shape": list(SCALED_ATTN_PATH), "launches": None,
                                  "max_abs_err": err16, **time_knarpe(name, SCALED_ATTN_PATH)}
            row["heads_route"]["scaled_training_shape"] = {"shape": list(SCALED_TRAIN_ATTN_PATH),
                                                           **time_knarpe(name, SCALED_TRAIN_ATTN_PATH)}
            for i, (shape, code) in enumerate(GENERAL_B4.items()):
                got = knarpe.heads_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} {shape}: the heads kernel's refusal code {got}, expected {code}")
                log(f"  {name} {list(shape)}: the heads kernel refuses it with code {got} "
                    f"({knarpe.HEADS_REFUSALS[got]}), so it takes the general route")
                check_one_knarpe(name, shape, seed=40 + i, want_route="general")
        elif name == "knarpe_cross_attention":
            time_knarpe(name, TRAIN_X_PATH)
            # the RNN family's shapes (phase 16) on the staged route, each timed
            for i, shape in enumerate(RNN_X + RNN_TRAIN_X):
                check_one_knarpe(name, shape, seed=60 + i)
            row["rnn_shapes"] = [{"shape": list(shape), **time_knarpe(name, shape)} for shape in RNN_X + RNN_TRAIN_X]
            # the navigation family's shapes (phase 17) on the staged route, each timed
            for i, shape in enumerate(NAVI_X + NAVI_TRAIN_X):
                check_one_knarpe(name, shape, seed=80 + i)
            row["navi_shapes"] = [{"shape": list(shape), **time_knarpe(name, shape)} for shape in NAVI_X + NAVI_TRAIN_X]
            # the variants' stop-line TL shapes (phase 18) on the staged route, each timed
            for i, shape in enumerate(VARIANT_X):
                check_one_knarpe(name, shape, seed=90 + i)
            row["variant_shapes"] = [{"shape": list(shape), **time_knarpe(name, shape)} for shape in VARIANT_X]
            # bf16 only: float32 B2 takes the general kernel at these shapes, which check_one_knarpe holds too
            err16 = max(check_one_knarpe(name, shape, seed=20 + i, want_route="cluster")[1]
                        for i, shape in enumerate(CLUSTER_X))
            row["cluster_route"] = {"name": "knarpe_cross_attention", "route": "cuda",
                                    "source": "trafficbotsv15_tpu_torch/csrc/knarpe_cluster.cuh",
                                    "replaces": replaces, "shape": list(SCALED_X_PATH), "launches": None,
                                    "max_abs_err": err16, **time_knarpe(name, SCALED_X_PATH)}
            row["cluster_route"]["scaled_training_shape"] = {"shape": list(SCALED_TRAIN_X_PATH),
                                                             **time_knarpe(name, SCALED_TRAIN_X_PATH)}
            for i, (shape, code) in enumerate(GENERAL_B2_X.items()):
                got = knarpe.cluster_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} {shape}: the cluster kernel's refusal code {got}, expected {code}")
                check_one_knarpe(name, shape, seed=40 + i, want_route="general")
        else:
            time_knarpe(name, TRAIN_X_PATH)
            # bf16 only: float32 B3 takes the general kernel at these shapes, which check_one_knarpe holds too
            err16 = max(check_one_knarpe(name, shape, seed=20 + i, want_route="heads")[1]
                        for i, shape in enumerate(V3_HEADS_X))
            row["heads_route"] = {"name": name, "route": "cuda",
                                  "source": "trafficbotsv15_tpu_torch/csrc/knarpe_v3_heads.cuh",
                                  "replaces": replaces, "shape": list(SCALED_X_PATH), "launches": None,
                                  "max_abs_err": err16, **time_knarpe(name, SCALED_X_PATH)}
            row["heads_route"]["scaled_training_shape"] = {"shape": list(SCALED_TRAIN_X_PATH),
                                                           **time_knarpe(name, SCALED_TRAIN_X_PATH)}
            for i, (shape, code) in enumerate(GENERAL_B3_X.items()):
                got = knarpe.v3_heads_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} {shape}: the heads kernel's refusal code {got}, expected {code}")
                log(f"  {name} {list(shape)}: the heads kernel refuses it with code {got} "
                    f"({knarpe.V3_HEADS_REFUSALS[got]}), so it takes the general route")
                check_one_knarpe(name, shape, seed=40 + i, want_route="general")
        # d_rpe = 4 (pose_rpe "xy_dir"): B4 on the general route, B2 and B3 on the staged route (its edge shapes
        # too); B4 and B2 timed at their shapes, B2 with the general kernel's time beside it (B3 is on no model path)
        attn = name == "knarpe_attention"
        way, rpe4 = ("general", RPE4_ATTN) if attn else ("staged", RPE4_X)
        errs = [check_one_knarpe(name, shape, seed=100 + i, want_route=way)
                for i, shape in enumerate(rpe4 + ([] if attn else RPE4_X_EDGE + [RPE4_X_EIGHT_HEADS]))]
        if name == "knarpe_cross_attention_v3":
            row["rpe4_bf16_max_abs_err"] = max(err[1] for err in errs)
        else:
            row["rpe4_shapes"] = [{"shape": list(shape), "route": way, "max_abs_err": err[0],
                                   "bf16_max_abs_err": err[1], **time_knarpe(name, shape),
                                   **({} if attn else time_general_fwd(name, shape))}
                                  for shape, err in zip(rpe4, errs)]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, **row})
    return rows


# bf16 B4 shapes that phase 3 holds against the plain version on the staged route, forward and backward
CHECKED_ATTN = {s[2:] for s in (ATTN_PATH, TRAIN_ATTN_PATH, *ATTN_EDGE, *ATTN_STAGED_EDGE)}


@contextlib.contextmanager
def recorded_forward_shapes():
    """The (kernel, dtype, K, D, R, H) of every B4, B2 and B3 forward launch inside the block."""
    real, seen = knarpe._launch, set()

    def recorder(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        seen.add((kernel, q.dtype, rpe.shape[2], q.shape[2], rpe.shape[3], n_head))
        return real(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)

    knarpe._launch = recorder
    try:
        yield seen
    finally:
        knarpe._launch = real


def check_path_forward_shapes(where: str, seen: set) -> None:
    """Every B4 and B2 launch of a path was in bf16 at a shape phase 3 checked on the staged route."""
    for kernel, dtype, *k_d_r_h in sorted(seen, key=str):
        checked = CHECKED_ATTN if kernel == "knarpe_attention" else CHECKED_X
        if dtype != torch.bfloat16 or tuple(k_d_r_h) not in checked:
            raise AssertionError(f"{where}: {kernel} launched in {dtype} at (K, D, R, H)={tuple(k_d_r_h)}, "
                                 f"which phase 3 did not check")
    log(f"  {where}: B4 and B2 launched at (kernel, K, D, R, H) {sorted((s[0], *s[2:]) for s in seen)}, each "
        f"checked in phase 3 on the staged route")


# bf16 B2 backward shapes that phase 3 holds against autograd of the plain version on the staged route;
# phase 8 checks that the training step launches no other
CHECKED_X_BWD = {s[2:] for s in (TRAIN_X_PATH, POST_TL_X_PATH, *X_BWD_EDGE, *RNN_TRAIN_X, *NAVI_TRAIN_X,
                                  *VARIANT_TRAIN_X)}


@contextlib.contextmanager
def recorded_bwd_launches(capture: bool = False):
    """The full shape of every B4 and B2 backward launch inside the block, counted: (kernel + "_bwd", dtype, n_b, n_s,
    K, D, R, H); with capture, also the operands (B4: q, k, v, rpe, invalid, w_rpe, b; B2: q, tgt, rpe, invalid, w_kv,
    w_rpe, b), g, n_head and gradients (B4: dq, dk, dv, drpe, dw_rpe, db; B2: dq, dtgt, drpe, dw_kv, dw_rpe, db) of
    the first B4 and the first B2 backward launch whose incoming gradient g is not all zero (the last rollout step's
    B2 gets none), cloned: {kernel: {"args": [...], "g": g, "n_head": H, "grads": [...]}}, without the kernels that
    did not launch so."""
    real, shapes, first = knarpe._launch_bwd, collections.Counter(), {}

    def record(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head):
        shapes[(f"{kernel}_bwd", str(q.dtype), *q.shape[:2], rpe.shape[2], q.shape[2], rpe.shape[3], n_head)] += 1
        out = real(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head)
        if capture and kernel not in first and bool(g.any()):
            attn = kernel == "knarpe_attention"
            ops = (q, k, v, rpe, invalid, w_rpe, b) if attn else (q, tgt, rpe, invalid, w_kv, w_rpe, b)
            first[kernel] = {"args": [t.clone() for t in ops], "g": g.clone(), "n_head": n_head,
                             "grads": [out[i].clone() for i in ((0, 1, 2, 4, 6, 7) if attn else (0, 3, 4, 5, 6, 7))]}
        return out

    knarpe._launch_bwd = record
    try:
        yield shapes, first
    finally:
        knarpe._launch_bwd = real


def check_path_bwd_shapes(where: str, seen) -> None:
    """Every B4 and B2 backward launch of a path (`recorded_bwd_launches`) was in bf16 at a shape phase 3 checked on
    the staged route."""
    unchecked = [key for key in seen if key[1] != str(torch.bfloat16) or tuple(key[4:]) not in (
        CHECKED_ATTN if key[0] == "knarpe_attention_bwd" else CHECKED_X_BWD)]
    if unchecked:
        raise AssertionError(f"{where}: backward launched at (kernel, dtype, n_b, n_s, K, D, R, H) {sorted(unchecked)}, "
                             f"which phase 3 did not check")
    log(f"  {where}: B4 and B2 backward launches by (kernel, dtype, n_b, n_s, K, D, R, H) {dict(seen)}, each shape "
        f"checked in phase 3 on the staged route")


def check_staged_route(where: str) -> None:
    """Every bf16 B4, B2 and B3 forward launch and every B4 and B2 backward launch since the last reset
    took the staged route: the flagship must not slide onto the slower general kernels unseen."""
    routes = dict(knarpe.ROUTE_LAUNCHES)
    if (any(routes[f"{kernel}/staged"] != n for kernel, n in knarpe.LAUNCHES.items())
            or any(v for key, v in routes.items() if key.endswith("/general"))):
        raise AssertionError(f"{where}: launches by route {routes}, expected all of {knarpe.LAUNCHES} on the "
                             f"staged route")


def knarpe_bwd_bound(name: str, args, g, n_head: int) -> tuple:
    """(bytes, operations) of a backward: operands and g read once, every gradient written once; the
    multiply-adds of the reassociated backward (csrc/knarpe_bwd.cu), per source with input width X:
    u_h, w_h = W_v[:, h] g_h, dq's z_h W_k[:, h] and the rank-1 weight-gradient terms, 5 X D; the
    logits, dattn, dx (two terms), y_h and z_h, 6 K X H; for B4 the k and v terms of the logits, dattn
    and dq, and dk and dv, 5 K D. The softmax's K H terms are left out."""
    q = args[0]
    n_b, n_s, d = q.shape
    rpe = args[3] if name == "knarpe_attention" else args[2]
    n_knn, r = rpe.shape[2], rpe.shape[3]
    n_src = n_b * n_s
    floats = [a for a in args if a.is_floating_point()]
    nbytes = 2 * sum(a.numel() * a.element_size() for a in floats) + g.numel() * g.element_size()
    nbytes += sum(a.numel() * a.element_size() for a in args if not a.is_floating_point())
    x = r if name == "knarpe_attention" else d + r
    macs = 5 * x * d + 6 * n_knn * x * n_head + (5 * n_knn * d if name == "knarpe_attention" else 0)
    return nbytes, 2 * n_src * macs


def _plain_bwd(name: str, args, g, n_head: int):
    if name == "knarpe_attention":
        return list(knarpe.knarpe_attention_bwd_reference(*args, g, n_head))
    return list(knarpe.knarpe_cross_attention_bwd_reference(*args, g, n_head))


def _kernel_bwd(name: str, args, g, n_head: int, halves: bool = False):
    """Gradients through the wrapper's autograd Function on the card (one backward launch); B4's k and v are two
    tensors, or with halves the halves of one [.., 2D] leaf, as the map encoder passes them."""
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    call = leaves
    if halves:
        kv = torch.cat([leaves[1].detach(), leaves[2].detach()], -1).requires_grad_(True)
        call = [leaves[0], *kv.chunk(2, -1), *leaves[3:]]
    out = getattr(knarpe, name)(*call, n_head)
    if not (out.requires_grad and out.grad_fn is not None):
        raise AssertionError(f"{name}: the card's output carries no grad_fn")
    bwd = "knarpe_attention_bwd" if name == "knarpe_attention" else "knarpe_cross_attention_bwd"
    before = knarpe.LAUNCHES[bwd]
    out.backward(g)
    torch.cuda.synchronize()
    if knarpe.LAUNCHES[bwd] != before + 1:
        raise AssertionError(f"{name}: backward launched {knarpe.LAUNCHES[bwd] - before} kernels, expected 1")
    grads = [a.grad for a in leaves if a.requires_grad]
    if halves:
        grads[1], grads[2] = kv.grad.chunk(2, -1)
    return grads


def check_one_knarpe_bwd(name: str, shape, seed: int, want_route: str = "staged", halves: bool = False) -> tuple:
    """Backward kernel vs autograd of the plain version, float32 and bf16, the bf16 backward on want_route
    and bit-identical on a second launch; B4's k and v two tensors, or with halves the halves of one; returns the
    float32 and the bf16 max |err| (the bf16 one against the float32 plain backward on the same bf16 inputs)."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed)
    g = torch.from_numpy(np.random.default_rng(seed + 100).normal(size=args[0].shape).astype(np.float32)).cuda()
    got, want = _kernel_bwd(name, args, g, n_head, halves), _plain_bwd(name, args, g, n_head)
    max_err, worst = 0.0, 0.0
    for a, b in zip(got, want):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        max_err, worst = max(max_err, err), max(worst, err / max(scale, 1e-30))
    if not worst <= KNARPE_BWD_F32_REL or not (torch.all(got[0][0, 0] == 0) and torch.all(got[1][0, 0] == 0)):
        raise AssertionError(f"{name} backward {shape} float32: max |err| / max |grad| {worst} "
                             f"(tolerance {KNARPE_BWD_F32_REL}), all-invalid source zero: {bool(torch.all(got[0][0, 0] == 0))}")
    a16 = [a if a.dtype == torch.bool else a.to(torch.bfloat16) for a in args]
    before = dict(knarpe.ROUTE_LAUNCHES)
    got16 = _kernel_bwd(name, a16, g.to(torch.bfloat16), n_head, halves)
    bwd = "knarpe_attention_bwd" if name == "knarpe_attention" else "knarpe_cross_attention_bwd"
    took = [key.split("/")[1] for key, n in knarpe.ROUTE_LAUNCHES.items()
            if key.startswith(f"{bwd}/") and n != before[key]]
    if took != [want_route]:
        raise AssertionError(f"{name} backward {shape} bf16: launched on the {took} route, expected {want_route}")
    want32 = _plain_bwd(name, [a if a.dtype == torch.bool else a.float() for a in a16], g.bfloat16().float(), n_head)
    for a, b in zip(got16, want32):
        tol = BF16_HALF_ULP * b.abs() + KNARPE_BWD_F32_REL * float(b.abs().max())
        if not (a.dtype == torch.bfloat16 and bool(((a.float() - b).abs() <= tol).all())):
            raise AssertionError(f"{name} backward {shape} bf16: |err| above 2^-8 relative + 1e-4 of the max")
    if not all(torch.all(x[0, 0] == 0) for x in got16[:2]):
        raise AssertionError(f"{name} backward {shape} bf16: the all-invalid source has non-zero gradients")
    if not all(torch.equal(a, b) for a, b in zip(_kernel_bwd(name, a16, g.to(torch.bfloat16), n_head, halves),
                                                  got16)):
        raise AssertionError(f"{name} backward {shape} bf16: two launches on the same inputs differ")
    err16 = max(float((a.float() - b).abs().max()) for a, b in zip(got16, want32))
    log(f"  {name} backward {list(shape)}: output has a grad_fn; float32 max |err| {max_err:.3e}, "
        f"{worst:.2e} of the largest gradient (tolerance {KNARPE_BWD_F32_REL:g}); bf16 max |err| {err16:.3e}, within "
        f"2^-8 relative + 1e-4 of the largest, {want_route} route, two launches bit-identical; all-invalid source zero"
        + ("; k and v the halves of one tensor" if halves else ""))
    return max_err, err16


def time_knarpe_bwd(name: str, shape) -> dict:
    """A backward launch (`_launch_bwd`, bf16) eager and as device time from a CUDA graph, its plain
    version and the library composition's backward, with the bound, at one shape."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed=11, dtype=torch.bfloat16)
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(3)).to("cuda", torch.bfloat16)
    if name == "knarpe_attention":
        q, k, v, rpe, inv, w, b = args
        kernel = lambda: knarpe._launch_bwd(name, q, k, v, None, rpe, inv, None, w, b, g, n_head)
    else:
        q, tgt, rpe, inv, w_kv, w_rpe, b = args
        kernel = lambda: knarpe._launch_bwd(name, q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
    way = knarpe.bwd_route(name, torch.bfloat16, *shape[2:], torch.cuda.current_device())
    ms = cuda_ms(kernel, 20)
    device_ms = graph_ms(kernel)
    plain_ms = cuda_ms(lambda: _plain_bwd(name, args, g, n_head), 5)
    leaves = [a.clone().requires_grad_(a.is_floating_point()) for a in args]
    lib_out = knarpe_library_call(name, leaves, n_head)
    want = [a for a in leaves if a.requires_grad]
    library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, want, g, retain_graph=True), 10)
    nbytes, ops = knarpe_bwd_bound(name, args, g, n_head)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"  {name} backward timing at {list(shape)} bf16, {way} route: kernel {ms:.4f} ms ({device_ms:.4f} ms of "
        f"device time, launched from a CUDA graph), plain (autograd through the plain forward) {plain_ms:.4f} ms, "
        f"backward of matmul + scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), kernel at {100 * bound_ms / ms:.2f}% of the bound "
        f"({100 * bound_ms / device_ms:.2f}% by device time)")
    return {"kernel_route": way, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": library_ms}


def time_general_fwd(name: str, shape) -> dict:
    """The general forward kernel's time (eager and device, `knarpe_general_launch`) at a B2 shape whose route is
    another: the yardstick of the kernel that replaced it there, timed as `time_knarpe` times that one."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, True, seed=1, dtype=torch.bfloat16)
    kernel = lambda: getattr(knarpe, name)(*args, n_head)
    general = knarpe.bind_launch(build.load("knarpe", "knarpe.cu"), "knarpe_general_launch")
    real = knarpe.load_library()
    knarpe._LAUNCH_FN = general
    try:
        ms, device_ms = cuda_ms(kernel, 50), graph_ms(kernel)
    finally:
        knarpe._LAUNCH_FN = real
    log(f"  {name} at {list(shape)} bf16 on the general kernel (knarpe_general_launch): {ms:.4f} ms "
        f"({device_ms:.4f} ms of device time, launched from a CUDA graph)")
    return {"general_ms": ms, "general_device_ms": device_ms}


def time_general_bwd(name: str, shape) -> dict:
    """The general backward kernel's time (eager and device, `knarpe_bwd_general_launch`) at a shape whose route is
    another: the yardstick of the kernel that replaced it there, timed as `time_knarpe_bwd` times that one."""
    n_head = shape[-1]
    args = knarpe_inputs(shape, name != "knarpe_attention", seed=11, dtype=torch.bfloat16)
    g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(3)).to("cuda", torch.bfloat16)
    q, tgt, rpe, inv, w_kv, w_rpe, b = args
    kernel = lambda: knarpe._launch_bwd(name, q, None, None, tgt, rpe, inv, w_kv, w_rpe, b, g, n_head)
    general = knarpe.bind_bwd_launch(build.load("knarpe_bwd", "knarpe_bwd.cu"), "knarpe_bwd_general_launch")
    real = knarpe.load_bwd_library()
    knarpe._BWD_FN = general
    try:
        ms, device_ms = cuda_ms(kernel, 20), graph_ms(kernel)
    finally:
        knarpe._BWD_FN = real
    log(f"  {name} backward at {list(shape)} bf16 on the general kernel (knarpe_bwd_general_launch): {ms:.4f} ms "
        f"({device_ms:.4f} ms of device time, launched from a CUDA graph)")
    return {"general_ms": ms, "general_device_ms": device_ms}


def timed_on(name: str, shape, want_route: str) -> dict:
    """`time_knarpe_bwd` at shape, which must take want_route."""
    row = {"shape": list(shape), **time_knarpe_bwd(name, shape)}
    if row["kernel_route"] != want_route:
        raise AssertionError(f"{name} backward at {list(shape)}: {row['kernel_route']} route, expected {want_route}")
    return row


def check_knarpe_bwd_kernels() -> list:
    """B4-bwd, B2-bwd and B3's backward (B2-bwd through B3's Function) vs autograd of the plain
    versions at the training path's and edge shapes, bf16 on the staged route where it takes the shape,
    bf16 B4-bwd and B2-bwd at the scaled preset's widths on the heads routes, and on the general route at the
    shapes they refuse; B4-bwd timed at the training path's shape and on the heads route at the scaled training
    shape, B2-bwd at both of its training shapes and on the heads route at the scaled preset's two, the general
    kernel beside it there (bf16)."""
    rows = []
    for name, path, edges, replaces in (
            ("knarpe_attention", TRAIN_ATTN_PATH, ATTN_EDGE + ATTN_STAGED_EDGE,
             "trafficbotsv15_tpu/ops/pallas_knarpe.py:293"),
            ("knarpe_cross_attention", TRAIN_X_PATH, X_BWD_EDGE, "trafficbotsv15_tpu/ops/pallas_knarpe.py:579")):
        cross = name != "knarpe_attention"
        max_err = check_one_knarpe_bwd(name, path, seed=11)[0]
        for i, shape in enumerate(edges):
            check_one_knarpe_bwd(name, shape, seed=12 + i)
        if not cross:
            for i, shape in enumerate(ATTN_GENERAL):
                check_one_knarpe_bwd(name, shape, seed=30 + i, want_route="general")
        if cross:
            check_one_knarpe_bwd(name, POST_TL_X_PATH, seed=14, want_route="staged")
            for i, shape in enumerate(RNN_TRAIN_X):  # the RNN family's training shapes (phase 16)
                check_one_knarpe_bwd(name, shape, seed=70 + i, want_route="staged")
            for i, shape in enumerate(NAVI_TRAIN_X):  # the navigation family's (phase 17)
                check_one_knarpe_bwd(name, shape, seed=90 + i, want_route="staged")
            for i, shape in enumerate(VARIANT_TRAIN_X):  # the variants' stop-line TL shape (phase 18)
                check_one_knarpe_bwd(name, shape, seed=95 + i, want_route="staged")
            for i, shape in enumerate(X_BWD_GENERAL):
                check_one_knarpe_bwd(name, shape, seed=17 + i, want_route="general")
            for i, shape in enumerate([path, POST_TL_X_PATH, *X_BWD_EDGE]):
                check_one_knarpe_bwd("knarpe_cross_attention_v3", shape, seed=20 + i, want_route="staged")
            # D=R=256 with 8 heads, which the staged backward refuses (more than 4 heads): the heads route
            # (csrc/knarpe_bwd_heads.cuh) at the scaled training path's two shapes through B2's and B3's Function, at
            # the edge shapes through B2's; the general route where the heads backward refuses too, by its code
            heads_errs = [check_one_knarpe_bwd(kernel, shape, seed=50 + i, want_route="heads")[1]
                          for i, shape in enumerate(HEADS_X_BWD)
                          for kernel in (name, "knarpe_cross_attention_v3")[:2 if shape in SCALED_TRAIN_X_BWD else 1]]
            for i, (shape, code) in enumerate(GENERAL_B2_BWD.items()):
                got = knarpe.x_bwd_heads_refusal(*shape[2:], torch.cuda.current_device())
                if got != code:
                    raise AssertionError(f"{name} backward {shape}: the heads kernel's refusal code {got}, expected "
                                         f"{code}")
                log(f"  {name} backward {list(shape)}: the heads kernel refuses it with code {got} "
                    f"({knarpe.X_BWD_HEADS_REFUSALS[got]}), so it takes the general route")
                check_one_knarpe_bwd(name, shape, seed=65 + i, want_route="general")
        # d_rpe = 4 (pose_rpe "xy_dir"): B2-bwd on the staged route (its edge shapes too, and B3's Function at the
        # flagship's training shape), B4-bwd on the general route
        way, rpe4 = ("staged", RPE4_X_BWD) if cross else ("general", RPE4_ATTN_BWD)
        rpe4_errs = [check_one_knarpe_bwd(name, shape, seed=110 + i, want_route=way, halves=not cross)
                     for i, shape in enumerate(rpe4 + (RPE4_X_EDGE if cross else []))]
        if cross:
            check_one_knarpe_bwd("knarpe_cross_attention_v3", RPE4_X_BWD[2], seed=120, want_route="staged")
            check_one_knarpe_bwd(name, RPE4_X_EIGHT_HEADS, seed=121, want_route="general")
        row = time_knarpe_bwd(name, path)
        source = "trafficbotsv15_tpu_torch/csrc/knarpe_bwd_staged.cuh" if cross else \
            "trafficbotsv15_tpu_torch/csrc/knarpe_attn_bwd_staged.cuh"
        rows.append({"name": f"{name}_bwd", "route": "cuda", "source": source, "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, **row})
        rows[-1]["rpe4_shapes"] = [{"route": way, "max_abs_err": err[0], "bf16_max_abs_err": err[1],
                                    **timed_on(name, shape, way), **(time_general_bwd(name, shape) if cross else {})}
                                   for shape, err in zip(rpe4, rpe4_errs)]
        if cross:
            rows[-1]["post_tl_shape"] = {"shape": list(POST_TL_X_PATH), **time_knarpe_bwd(name, POST_TL_X_PATH)}
            # the heads route at the scaled training path's two shapes, the general kernel's time there beside it
            train_row, post_tl_row = ({**timed_on(name, shape, "heads"), **time_general_bwd(name, shape)}
                                      for shape in SCALED_TRAIN_X_BWD)
            rows[-1].update(scaled_training_shape=train_row, scaled_post_tl_shape=post_tl_row)
            rows[-1]["heads_route"] = {"name": f"{name}_bwd", "route": "cuda",
                                       "source": "trafficbotsv15_tpu_torch/csrc/knarpe_bwd_heads.cuh",
                                       "replaces": replaces, "launches": None, "max_abs_err": max(heads_errs),
                                       **train_row, "scaled_post_tl_shape": post_tl_row}
            rows[-1]["rnn_shapes"] = [timed_on(name, shape, "staged") for shape in RNN_TRAIN_X]
            rows[-1]["navi_shapes"] = [timed_on(name, shape, "staged") for shape in NAVI_TRAIN_X]
            rows[-1]["variant_shapes"] = [timed_on(name, shape, "staged") for shape in VARIANT_TRAIN_X]
            continue
        # bf16 only: float32 B4-bwd takes the general kernel at these shapes, which check_one_knarpe_bwd holds too
        err16 = max(check_one_knarpe_bwd(name, shape, seed=40 + i, want_route="heads", halves=halves)[1]
                    for halves in (True, False) for i, shape in enumerate(HEADS_ATTN_BWD))
        for i, (shape, code) in enumerate(GENERAL_B4_BWD.items()):
            got = knarpe.attn_bwd_heads_refusal(*shape[2:], torch.cuda.current_device())
            if got != code:
                raise AssertionError(f"{name} backward {shape}: the heads kernel's refusal code {got}, expected {code}")
            log(f"  {name} backward {list(shape)}: the heads kernel refuses it with code {got} "
                f"({knarpe.ATTN_BWD_HEADS_REFUSALS[got]}), so it takes the general route")
            check_one_knarpe_bwd(name, shape, seed=60 + i, want_route="general", halves=True)
        rows[-1]["heads_route"] = {"name": f"{name}_bwd", "route": "cuda",
                                   "source": "trafficbotsv15_tpu_torch/csrc/knarpe_attn_bwd_heads.cuh",
                                   "replaces": replaces, "launches": None, "max_abs_err": err16,
                                   **timed_on(name, SCALED_TRAIN_ATTN_PATH, "heads")}
    return rows


def run_bench_knarpe() -> dict:
    """The ported bench (`utils/bench_knarpe.py`, the entry point that reaches B3) once at the scaled shape, a
    few iterations, with every count at 0 just before and read just after: its B3 launches all on the heads
    route, its B2 launches on the cluster route. -> the bench's knarpe launches by route."""
    reset_launches()
    result = bench_knarpe.run("scaled", iters=3)
    routes = {key: n for key, n in knarpe.ROUTE_LAUNCHES.items() if n}
    b3 = knarpe.LAUNCHES["knarpe_cross_attention_v3"]
    want = {"knarpe_cross_attention_v3/heads": b3, "knarpe_cross_attention/cluster": knarpe.LAUNCHES[
        "knarpe_cross_attention"]}
    took = {row["variant"]: row["route"] for row in result["variants"]}
    if not (b3 > 0 and routes == want and took == {"library_fullwidth": "library", "knarpe_v2": "cluster",
                                                   "knarpe_v3": "heads"}):
        raise AssertionError(f"bench_knarpe --shape scaled: launches by route {routes}, routes {took}; expected B3 "
                             f"on the heads route and B2 on the cluster route")
    log(f"  bench_knarpe --shape scaled --iters 3: B3 {b3} launches, all on the heads route; launches by route "
        f"{routes}")
    return routes


def reset_launches() -> None:
    knn.LAUNCHES = 0
    for counts in (knarpe.LAUNCHES, knarpe.ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def launches() -> dict:
    return {"knn_xy": knn.LAUNCHES, **knarpe.LAUNCHES}


def _b2_blocks(cfg) -> int:
    """The agent encoder's B2 blocks per rollout step: HPTR's decoder attends to map and TL targets at once; the
    RNN family's agent encoder to each in a block of its own (`tf_ag2mp`, `tf_ag2tl`). Its agent self-attention
    must be dense here (no B4 per step): every caller's agent count is within dense_knn_max."""
    if cfg.model.temp_window_size > 0:
        return 1
    if cfg.data.n_ag > cfg.model.tf_cfg.dense_knn_max:
        raise AssertionError("RNN configs here keep the agent self-attention dense (n_ag <= dense_knn_max)")
    return 2


def _attends(cfg) -> bool:
    """Whether the config's attentions launch B4 and B2: use_pallas, but never with apply_q_rpe (its query RPE
    keeps every attention on the plain path, as in the JAX package), with dropout on the attention weights (JAX's
    gates turn the kernels off), or in the scene-centric model (no attention of it takes an RPE)."""
    tf = cfg.model.tf_cfg
    return tf.use_pallas and not tf.apply_q_rpe and not tf.attn_dropout_weights and cfg.model.pairwise_relative


def _selects(cfg) -> int:
    """1 where the agent->map KNN goes through B1 (the pairwise-relative model), 0 where it sorts (scene-centric)."""
    return int(cfg.model.pairwise_relative)


def _learned_latents(cfg, train: bool) -> int:
    """The latent heads whose encoders run: at eval the prior's, in training the posterior's and the prior's; a
    constant head (std_gaus, std_cat) runs none."""
    lat = cfg.model.latent_encoder
    heads = (lat.latent_post, lat.latent_prior) if train else (lat.latent_prior,)
    return 0 if lat.latent_dim <= 0 else sum(h.dist_type not in ("std_gaus", "std_cat") for h in heads)


def _navi_b2(cfg) -> int:
    """B2 launches per navi prediction: one per layer of the goal / cmd predictor's tf_ag2mp (none in the dest and
    dummy modes, whose predictors do not attend)."""
    m = cfg.model
    return m.navi_predictor.n_layer_tf if _attends(cfg) and m.navi_mode in ("goal", "cmd") else 0


def _repredictions(cfg) -> int:
    """Navi predictions inside a rollout: one per step with re-prediction (`pred_navi_after_reached`), else none."""
    return cfg.time_step_end if rollout_lib.repredicts(cfg) else 0


def _latent_b2(cfg) -> int:
    """B2 launches of one run of a latent head's encoders: per TL and agent layer (RNN family: per agent layer, one
    over the map and one over the TL lanes, and no TL attention)."""
    m = cfg.model
    return m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf if _b2_blocks(cfg) == 1 else 2 * m.ag_encoder.n_layer_tf


def expected_launches(cfg, n_step: int) -> dict:
    """Kernel launches per joint_future_pred call that the config implies: the navi predictor's once before the
    futures replicate and, with re-prediction, once per rollout step; a learned prior's encoders once (one KNN and
    their B2)."""
    pallas = _attends(cfg)
    navi = _navi_b2(cfg) * (1 + _repredictions(cfg))
    prior = _learned_latents(cfg, train=False)
    return {"knn_xy": (n_step + prior) * _selects(cfg),
            "knarpe_attention": cfg.model.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention": _b2_blocks(cfg) * cfg.model.ag_encoder.n_layer_tf * n_step + navi
            + prior * _latent_b2(cfg) if pallas else 0,
            "knarpe_cross_attention_v3": 0, "knarpe_attention_bwd": 0, "knarpe_cross_attention_bwd": 0}


def expected_train_launches(cfg) -> dict:
    """Kernel launches per training step that the config implies: the rollout's per-step
    recompute runs the step's forward kernels (the agent->map KNN, the agent encoder's B2) a
    second time in the backward pass; the posterior encoders (and a learned prior's) add one KNN and one B2 per TL
    and agent layer (RNN family: per agent layer, one over the map and one over the TL lanes, and no
    TL attention); each forward outside a recompute has one backward. The goal / cmd navi predictor attends once
    before the rollout, with its backward; with re-prediction (goal) again in every step and its recompute, and
    backward in every step but the last, whose draw no later step reads."""
    m, n = cfg.model, cfg.time_step_end
    pallas = _attends(cfg)
    blocks = _b2_blocks(cfg)
    latents = _learned_latents(cfg, train=True)
    post = latents * _latent_b2(cfg)
    steps = _repredictions(cfg)
    navi, navi_bwd = _navi_b2(cfg) * (1 + 2 * steps), _navi_b2(cfg) * (1 + max(steps - 1, 0))
    return {"knn_xy": (2 * n + latents) * _selects(cfg),
            "knarpe_attention": m.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention": 2 * blocks * m.ag_encoder.n_layer_tf * n + post + navi if pallas else 0,
            "knarpe_cross_attention_v3": 0,
            "knarpe_attention_bwd": m.mp_encoder.n_layer_tf if pallas else 0,
            "knarpe_cross_attention_bwd": blocks * m.ag_encoder.n_layer_tf * n + post + navi_bwd if pallas else 0}


def damp_weights(model: torch.nn.Module, gain: float) -> None:
    """Scale every weight matrix: a random policy at full gain is chaotic in closed
    loop, so card-vs-CPU rounding differences would grow instead of showing parity."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(gain)


def rnn_mode(cfg):
    """cfg in the TrafficBots RNN family (temp_window_size=-1, the `traffic_bots_rnn` golden's)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, temp_window_size=-1))


def navi_variant(cfg, navi_mode: str, repredict: bool = False):
    """cfg in a navigation mode, with navi re-prediction inside the rollout where repredict."""
    return dataclasses.replace(cfg, pred_navi_after_reached=repredict,
                               model=dataclasses.replace(cfg.model, navi_mode=navi_mode))


def variant_of(cfg, variant: str):
    """cfg with the input, TL, pose and latent variants named in `variant`, joined by "+" ("" for none): "cat" (a
    type-branched `cat` posterior, a learned `cat` prior), "std_cat" (a plain `cat` posterior, the `std_cat` prior),
    both with 8 factors where latent_dim takes them (the flagship's 16) and 2 at the phase-4 config's 4; "stop"
    (tl_mode "stop"); "stacked" (the stacked TL input); "input" (InputEncoder mode "input" in the map, TL and agent
    encoders); "q_rpe" (apply_q_rpe); "pe_xy_dir", "xy_dir" (pose_rpe's mode); "scene_centric"
    (pairwise_relative=False); "gelu" (the FFNs' activation); "mean_valid" (the polyline and temporal encoders'
    pooling); "wdrop" (dropout on the attention weights)."""
    from trafficbotsv15_tpu_torch.config import DistEncoderCfg, PoseEmbCfg

    m = cfg.model
    for name in filter(None, variant.split("+")):
        lat = m.latent_encoder
        n_cat = 8 if lat.latent_dim % 8 == 0 else 2
        if name in ("cat", "std_cat"):
            post = DistEncoderCfg(dist_type="cat", branch_type=name == "cat", n_cat=n_cat)
            prior = DistEncoderCfg(dist_type=name, n_cat=n_cat)
            m = dataclasses.replace(m, latent_encoder=dataclasses.replace(lat, latent_post=post, latent_prior=prior))
        elif name == "stop":
            m = dataclasses.replace(m, tl_mode="stop")
        elif name == "stacked":
            m = dataclasses.replace(m, tl_encoder=dataclasses.replace(m.tl_encoder, temp_stack_input=True))
        elif name == "input":
            enc = lambda c: dataclasses.replace(c, input_encoder=dataclasses.replace(  # noqa: E731
                c.input_encoder, mode="input"))
            m = dataclasses.replace(m, mp_encoder=enc(m.mp_encoder), tl_encoder=enc(m.tl_encoder),
                                    ag_encoder=enc(m.ag_encoder))
        elif name == "q_rpe":
            m = dataclasses.replace(m, tf_cfg=dataclasses.replace(m.tf_cfg, apply_q_rpe=True))
        elif name in ("pe_xy_dir", "xy_dir"):
            m = dataclasses.replace(m, pose_rpe=PoseEmbCfg(mode=name))
        elif name == "scene_centric":
            m = dataclasses.replace(m, pairwise_relative=False)
        elif name == "gelu":
            m = dataclasses.replace(m, tf_cfg=dataclasses.replace(m.tf_cfg, activation="gelu"))
        elif name == "mean_valid":
            pl = dataclasses.replace(m.mp_encoder.pl_encoder, pooling_mode="mean_valid")
            m = dataclasses.replace(m, mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=pl))
        elif name == "wdrop":
            m = dataclasses.replace(m, tf_cfg=dataclasses.replace(m.tf_cfg, attn_dropout_weights=True))
        else:
            raise ValueError(f"variant {name!r}")
    return dataclasses.replace(cfg, model=m)


_CPU_REFERENCES = {}


def cpu_reference(key: tuple, compute, keep: bool = False):
    """A card-vs-CPU check's CPU run: compute(), or the one `precompute_cpu_references` kept under key. keep: compute
    it now and keep it for the check's phase (-> None)."""
    if keep:
        _CPU_REFERENCES[key] = compute()
        return None
    return _CPU_REFERENCES.pop(key) if key in _CPU_REFERENCES else compute()


def slice_run(cfg, batch, device: str):
    """The phase-4 slice check's joint_future_pred (K=2) of the damped seed-1 model on device -> its buffer."""
    model = build_model(cfg, seed=1, device=device)
    damp_weights(model, 0.5)
    reset_launches()
    _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0), n_joint_future=2,
                               device=device, check_level=1)
    if device == "cuda":
        torch.cuda.synchronize()
    return buf


def check_slice_card_vs_cpu(use_pallas: bool, rnn: bool = False, navi_mode: str = "dest",
                            repredict: bool = False, time_step_end: int = None, batch_seed: int = 3,
                            variant: str = "", reference_only: bool = False) -> None:
    """The phase-4 config's joint_future_pred on the card and on the CPU from the same weights and the same CPU
    generator's draws (in the RNN family with rnn; in a navigation mode, with navi re-prediction where repredict;
    in the input, TL, pose and latent variants `variant_of` names; rolled out to time_step_end steps, None for its
    30): the K0 futures, their TL states and rule flags agree; with re-prediction also the K0 rows' navi log-probs,
    of which at least one is a step's re-prediction. reference_only: only the CPU run, kept for the check
    (`cpu_reference`)."""
    base = horizon(tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=31, hidden_dim=64), time_step_end)
    cfg = with_pallas(dataclasses.replace(base, joint_future_pred_deterministic_k0=True), use_pallas)
    cfg = variant_of(navi_variant(rnn_mode(cfg) if rnn else cfg, navi_mode, repredict), variant)
    batch = make_batch(cfg.data, n_sc=1, seed=batch_seed)
    key = ("slice", use_pallas, rnn, navi_mode, repredict, time_step_end, batch_seed, variant)
    cpu = cpu_reference(key, lambda: slice_run(cfg, batch, "cpu"), keep=reference_only)
    if reference_only:
        return
    gpu = slice_run(cfg, batch, "cuda")
    want = expected_launches(cfg, cfg.time_step_end)
    if launches() != want:
        raise AssertionError(f"slice check: kernel launches {launches()}, expected {want}")
    off_general = {key: n for key, n in knarpe.ROUTE_LAUNCHES.items() if n and not key.endswith("/general")}
    if off_general:  # float32 takes the general kernels at every width, d_rpe = 4 (xy_dir) too
        raise AssertionError(f"slice check: float32 launches off the general route {off_general}")
    pose_err = float((gpu.pred_pose[:, 0].cpu() - cpu.pred_pose[:, 0]).abs().max())
    if not torch.equal(gpu.pred_valid[:, 0].cpu(), cpu.pred_valid[:, 0]) or not pose_err <= SLICE_POSE_ATOL:
        raise AssertionError(f"slice check: K0 futures differ card vs CPU (max pose err {pose_err})")
    if not torch.equal(gpu.tl_state[:, 0].cpu(), cpu.tl_state[:, 0]):
        raise AssertionError("slice check: K0 TL states differ card vs CPU")
    differ = [k for k in cpu.violation if not torch.equal(gpu.violation[k][:, 0].cpu(), cpu.violation[k][:, 0])]
    if differ:
        raise AssertionError(f"slice check: K0 rule flags differ card vs CPU: {differ}")
    fired = sorted(k for k, v in cpu.violation.items() if not k.endswith("_this_step") and bool(v[:, 0].any()))
    note = ""
    if repredict:
        n_re = int(cpu.navi_log_prob_valid[:, 0, :, 1:].sum())
        lp_err = float((gpu.navi_log_prob[:, 0].cpu() - cpu.navi_log_prob[:, 0]).abs().max())
        if not (torch.equal(gpu.navi_log_prob_valid[:, 0].cpu(), cpu.navi_log_prob_valid[:, 0]) and n_re > 0
                and lp_err <= NAVI_LOGP_ATOL):
            raise AssertionError(f"slice check: K0 re-predictions differ card vs CPU or none ({n_re}; navi log-prob "
                                 f"err {lp_err})")
        note = (f"; {n_re} K0 re-predictions, navi log-probs {list(gpu.navi_log_prob.shape)} within {lp_err:.3e} "
                f"(tolerance {NAVI_LOGP_ATOL:g})")
    log(f"  {'RNN family, ' if rnn else ''}{'' if navi_mode == 'dest' and not repredict else navi_mode + ', '}"
        f"{variant + ', ' if variant else ''}{'re-predicting, ' if repredict else ''}use_pallas={use_pallas}: card vs "
        f"CPU, K0 futures of "
        f"{list(gpu.pred_pose.shape)}: pred_valid and TL states equal, max |pose err| {pose_err:.3e} m (tolerance "
        f"{SLICE_POSE_ATOL}); rule flags equal (fired: {fired}); kernel launches "
        f"{expected_launches(cfg, cfg.time_step_end)} as the config implies{note}")


def to_cpu(obj):
    """A rule checker's statics or state (dataclass of tensors and Nones) on the CPU."""
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).cpu() for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)})


def replay_rule_checks_on_cpu(cfg, model, batch, gen) -> None:
    """One more full-width call, recording the rule checker's inputs and flags at
    RULE_STEPS; the CPU recomputes the flags from the same inputs."""
    real, recorded, step = rollout_lib.check_rules, [], [0]

    def recorder(statics, state, *inputs):
        new_state, viol = real(statics, state, *inputs)
        if step[0] in RULE_STEPS:
            recorded.append((statics, state, inputs, viol))
        step[0] += 1
        return new_state, viol

    rollout_lib.check_rules = recorder
    try:
        joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    finally:
        rollout_lib.check_rules = real
    n_diff = n_flags = 0
    fired = set()
    for statics, state, inputs, viol in recorded:
        _, ref = real(to_cpu(statics), to_cpu(state), *(x.cpu() if isinstance(x, torch.Tensor) else x
                                                         for x in inputs))
        for key, val in ref.items():
            n_diff += int((viol[key].cpu() != val).sum())
            n_flags += val.numel()
            if key.endswith("_this_step") and bool(val.any()):
                fired.add(key.removesuffix("_this_step"))
    if len(recorded) != len(RULE_STEPS) or n_diff > RULE_FLAG_SHARE * n_flags:
        raise AssertionError(f"rule checks card vs CPU: {n_diff} of {n_flags} flags differ at {len(recorded)} steps")
    log(f"  rule checks of steps {list(RULE_STEPS)} replayed on the CPU from the card's inputs: {n_diff} of "
        f"{n_flags} flags differ (tolerance {RULE_FLAG_SHARE:g} of them); fired: {sorted(fired)}")


def run_full_width(card: str, use_pallas: bool, n_timed: int = 1, replay_rules: bool = False,
                   warm_up: bool = True) -> dict:
    """leaderboard_config() joint_future_pred, 4 scenarios x K=32, level 1: a warm-up call where warm_up (phase 6 has
    none: phase 5 ran the same model in this process), then n_timed calls, each checked and timed."""
    cfg = with_pallas(leaderboard_config(), use_pallas)
    n_sc, k = 4, cfg.n_joint_future_wosac
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters())
    if warm_up:
        t0 = time.perf_counter()
        joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
        torch.cuda.synchronize()
        log(f"  warm-up call {time.perf_counter() - t0:.3f} s ({n_params} parameters, bf16 compute)")
    torch.cuda.reset_peak_memory_stats()
    times, per_call = [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        with recorded_forward_shapes() as seen:
            _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_call.append(launches())
        if use_pallas:
            check_path_forward_shapes("eval call", seen)
        check_staged_route("eval call")
    n_ag, n_step, n_tl = cfg.data.n_ag, cfg.time_step_end, cfg.data.n_tl_lane
    shapes = {"pred_pose": (n_sc, k, n_ag, n_step, 3), "pred_valid": (n_sc, k, n_ag, n_step),
              "pred_action": (n_sc, k, n_ag, n_step, 2), "tl_state": (n_sc, k, n_tl, n_step, 5),
              "log_prob": (n_sc, k, n_ag)}
    for name, shape in shapes.items():
        got = tuple(getattr(buf, name).shape)
        if got != shape:
            raise AssertionError(f"full width: {name} is {got}, expected {shape}")
    if not (torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()):
        raise AssertionError("full width: non-finite poses or scores")
    want = expected_launches(cfg, n_step)
    if any(c != want for c in per_call):
        raise AssertionError(f"full width: kernel launches per call {per_call}, expected {want}")
    sec = float(np.median(times))
    agent_steps = n_sc * k * n_ag * (cfg.time_step_end - cfg.time_step_current)
    flags = {key: int(v.sum()) for key, v in buf.violation.items() if not key.endswith("_this_step")}
    log(f"  leaderboard_config use_pallas={use_pallas} check_level=1 joint_future_pred: {n_sc} scenarios x K={k}, "
        f"{n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps: seconds per call {[round(t, 4) for t in times]} "
        f"(median {sec:.4f} s{'' if warm_up else '; no warm-up call'}), peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{agent_steps / sec:.1f} agent-steps/s, kernel launches per call {per_call[-1]}, "
        f"agent-steps flagged {flags}, launches by route {knarpe.ROUTE_LAUNCHES} [{card}]")
    routes = dict(knarpe.ROUTE_LAUNCHES)
    if replay_rules:
        replay_rule_checks_on_cpu(cfg, model, batch, gen)
    return per_call[-1], routes


def no_dropout(cfg):
    """cfg with every dropout rate at 0: CPU and CUDA generators draw different masks from one seed."""
    m = cfg.model
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, tf_cfg=dataclasses.replace(m.tf_cfg, dropout_p=0.0),
        mp_encoder=dataclasses.replace(m.mp_encoder, pl_encoder=dataclasses.replace(m.mp_encoder.pl_encoder,
                                                                                      mlp_dropout_p=0.0)),
        add_navi_latent=dataclasses.replace(m.add_navi_latent, mlp_dropout_p=0.0)))


def draw_navi_noise(cfg, batch, generator: torch.Generator) -> list:
    """The training rollout's re-predicted navi noise for every step, drawn up front on the generator's device, so
    that two devices draw alike (the rollout otherwise draws it from each step's dropout stream): a goal's standard
    normal [n_sc, n_ag, 4], a destination's Gumbel noise [n_sc, n_ag, n_mp]."""
    n_sc, n_ag, n_mp = *batch["agent/valid"].shape[:2], batch["map/valid"].shape[1]
    if cfg.model.navi_mode == "goal":
        mean = torch.zeros((n_sc, n_ag, 4))
        return [DiagGaussian(mean, mean).noise(generator) for _ in range(cfg.time_step_end)]
    logits = torch.zeros((n_sc, n_ag, n_mp))
    return [DestCategorical(logits).noise(generator) for _ in range(cfg.time_step_end)]


@contextlib.contextmanager
def recorded_training_rollouts():
    """The buffers of the training rollouts inside the block."""
    real, bufs = rollout_lib.rollout_train, []

    def record(*args, **kwargs):
        bufs.append(real(*args, **kwargs))
        return bufs[-1]

    rollout_lib.rollout_train = record
    try:
        yield bufs
    finally:
        rollout_lib.rollout_train = real


def train_check_setup(use_pallas: bool, time_step_end: int = None, rnn: bool = False, navi_mode: str = "dest",
                      repredict: bool = False, batch_seed: int = 3, variant: str = "") -> tuple:
    """The phase-4 config of the card-vs-CPU training checks, no dropout, and its batch of 2 and draws (on the CPU):
    -> (cfg, batch, noise). rnn: the TrafficBots RNN family (the GRU TL state predictor's dropout at 0 too);
    repredict: the re-predicted navi's noise drawn up front; variant: `variant_of`'s."""
    cfg = with_pallas(no_dropout(horizon(phase4_config(), time_step_end)), use_pallas)
    cfg = variant_of(navi_variant(cfg, navi_mode, repredict), variant)
    if rnn:
        cfg = rnn_mode(cfg)
        tl_pred = dataclasses.replace(cfg.model.tl_state_predictor, rnn_dropout_p=0.0)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, tl_state_predictor=tl_pred))
    batch = make_batch(cfg.data, n_sc=2, seed=batch_seed)
    gen = torch.Generator().manual_seed(0)
    noise = train_lib.draw_training_noise(cfg, batch, gen, "cpu")
    if repredict:
        noise["navi_noise"] = draw_navi_noise(cfg, batch, gen)
    return cfg, batch, noise


@contextlib.contextmanager
def cpu_float64():
    """A float64 CPU reference: the default dtype and Tensor.float() (the port's upcast of bf16 values) give
    float64 inside the block; tensors the port makes as float32 by name stay float32."""
    real = torch.Tensor.float
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = real
        torch.set_default_dtype(torch.float32)


def train_step_run(cfg, batch, noise, device: str, float64: bool = False, perturb: float = 0.0) -> tuple:
    """One make_train_step of the damped seed-1 model on device (float64: the CPU in float64, `cpu_float64`; perturb:
    every weight times 1 + perturb·N(0, 1) first). -> (metrics, the gradients the optimizer applied (clipped where
    grad_norm exceeds the clip norm) in float64 on the CPU, the training rollout's navi log-probs and poses, launches
    by kernel)."""
    model = build_model(cfg, seed=1, device=device)
    damp_weights(model, 0.5)
    if perturb:
        g = torch.Generator().manual_seed(7)
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(1 + perturb * torch.randn(prm.shape, generator=g).to(prm.device))
    dtype = torch.float64 if float64 else torch.float32
    model.to(dtype)
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()), device=device)
    move = lambda t: t.to(device, dtype if t.is_floating_point() else t.dtype)  # noqa: E731
    dev_noise = {k: move(v) if isinstance(v, torch.Tensor) else [move(t) for t in v] if k == "navi_noise" else v
                 for k, v in noise.items()}
    reset_launches()
    with cpu_float64() if float64 else contextlib.nullcontext(), recorded_training_rollouts() as bufs:
        metrics = {k: float(v) for k, v in step(batch, noise=dev_noise).items()}
    if device == "cuda":
        torch.cuda.synchronize()
    return (metrics, {n: prm.grad.double().cpu() for n, prm in model.named_parameters()},
            {k: getattr(bufs[0], k).detach().double().cpu() for k in ("navi_log_prob_valid", "navi_log_prob",
                                                                      "pred_pose", "pred_valid")}, launches())


def grads_against(got: tuple, want: tuple) -> tuple:
    """A train_step_run against a reference run: -> (worst relative loss term / grad_norm error, worst gradient
    error over its scale, its parameter, how many scales were floored). A gradient's scale is its largest magnitude
    in the reference, floored at TRAIN_GRAD_FLOOR of the model's largest."""
    (m_got, g_got), (m_want, g_want) = got[:2], want[:2]
    if set(g_got) != set(g_want):
        raise AssertionError(f"train step check: parameters {sorted(set(g_got) ^ set(g_want))} in one run only")
    loss_err = max(abs(m_got[k] - v) / max(abs(v), 1.0) for k, v in m_want.items())
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in g_want.values())
    worst, worst_name, n_floored = 0.0, "", 0
    for name, g in g_want.items():
        own = float(g.abs().max())
        n_floored += own < floor
        rel = float((g_got[name] - g).abs().max()) / max(own, floor)
        if rel > worst:
            worst, worst_name = rel, name
    return loss_err, worst, worst_name, n_floored


def check_train_step_card_vs_cpu(use_pallas: bool, time_step_end: int = None, rnn: bool = False,
                                 navi_mode: str = "dest", repredict: bool = False, batch_seed: int = 3,
                                 float64_reference: bool = False, variant: str = "",
                                 reference_only: bool = False) -> None:
    """One make_train_step on the card and on the CPU: same weights, same draws, no dropout. time_step_end past
    the log's 30 steps takes the TL pass step by step (phase 13 (e)); rnn, the TrafficBots RNN family (phase 16
    (b)); navi_mode and repredict, the navigation family (phase 17 (a); the re-predicted navi's noise drawn up front
    on the CPU, and at least one re-prediction). float64_reference holds the card against the CPU in float64 and
    logs how far the CPU's float32 lies from it: at a batch where the float32 CPU's rounding falls across a kink of
    the loss (phase 17 (a)'s pinned seed), the float64 run says which float32 run is off. variant: the input, TL,
    pose and latent variants `variant_of` names (phase 18 (b)). reference_only: only the CPU runs, kept for the
    check (`cpu_reference`)."""
    cfg, batch, noise = train_check_setup(use_pallas, time_step_end, rnn, navi_mode, repredict, batch_seed, variant)
    key = ("train", use_pallas, time_step_end, rnn, navi_mode, repredict, batch_seed, float64_reference, variant)
    cpu_runs = cpu_reference(key, lambda: (
        train_step_run(cfg, batch, noise, "cpu"),
        train_step_run(cfg, batch, noise, "cpu", float64=True) if float64_reference else None), keep=reference_only)
    if reference_only:
        return
    cpu, card = cpu_runs[0], train_step_run(cfg, batch, noise, "cuda")
    ref = cpu_runs[1] if float64_reference else cpu
    want = expected_train_launches(cfg)
    if card[3] != want:
        raise AssertionError(f"train step check: kernel launches {card[3]}, expected {want}")
    for run, where in ((cpu, "CPU"), (card, "card")):
        n_re = int(run[2]["navi_log_prob_valid"][..., 1:].sum())
        if repredict and n_re == 0:
            raise AssertionError(f"train step check {navi_mode} on the {where}: no agent re-predicted its navi")
    if repredict:  # the same agents re-predict at the same steps, and their draws score alike
        b_ref, b_gpu = ref[2], card[2]
        steps_ref = b_ref["navi_log_prob_valid"][..., 1:].nonzero().tolist()
        steps_gpu = b_gpu["navi_log_prob_valid"][..., 1:].nonzero().tolist()
        lp_err = float((b_gpu["navi_log_prob"] - b_ref["navi_log_prob"]).abs().max())
        pose_err = (b_gpu["pred_pose"] - b_ref["pred_pose"]).abs().amax((0, 1, 3))
        log(f"  train step check {navi_mode}: re-predictions (scenario, agent, step) card {steps_gpu[:8]}, CPU "
            f"{steps_ref[:8]}; navi log-prob max |err| {lp_err:.3e}; pose |err| by step "
            f"{[float(f'{e:.3g}') for e in pose_err.tolist()]}")
        if steps_ref != steps_gpu or not lp_err <= NAVI_LOGP_ATOL:
            raise AssertionError(f"train step check {navi_mode}: re-predictions card {steps_gpu}, CPU {steps_ref}, "
                                 f"navi log-prob err {lp_err}")
    loss_err, worst, worst_name, n_floored = grads_against(card, ref)
    ref_name = "CPU float64" if float64_reference else "CPU"
    if not (loss_err <= TRAIN_LOSS_REL and worst <= TRAIN_GRAD_REL):
        raise AssertionError(f"train step check use_pallas={use_pallas}: loss terms / grad_norm off by {loss_err} "
                             f"(tolerance {TRAIN_LOSS_REL}), gradient of {worst_name} off by {worst} of its scale "
                             f"(tolerance {TRAIN_GRAD_REL}) against the {ref_name}")
    (m_gpu, g_ref), m_ref = (card[0], ref[1]), ref[0]
    n_re = int(card[2]["navi_log_prob_valid"][..., 1:].sum())
    norm_tgt = [n for n in g_ref if n.endswith("norm_tgt_scale") and float(g_ref[n].abs().max()) > 0]
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in g_ref.values())
    seed_note = f"batch seed {batch_seed}, " if batch_seed != 3 else ""
    log(f"  {'RNN family, ' if rnn else ''}{'' if navi_mode == 'dest' and not repredict else navi_mode + ', '}"
        f"{variant + ', ' if variant else ''}{f're-predicting ({n_re} re-predictions), ' if repredict else ''}"
        f"{seed_note}"
        f"use_pallas={use_pallas}, {cfg.time_step_end} steps: card vs {ref_name}, loss {m_gpu['training/loss']:.6f} "
        f"vs {m_ref['training/loss']:.6f}, grad_norm {m_gpu['grad_norm']:.6f} vs {m_ref['grad_norm']:.6f}, loss terms "
        f"and grad_norm within {loss_err:.2e} relative (tolerance {TRAIN_LOSS_REL:g}); {len(g_ref)} parameter "
        f"gradients within {worst:.2e} of their scale (worst {worst_name}; tolerance {TRAIN_GRAD_REL:g}; scale "
        f"floored at {TRAIN_GRAD_FLOOR:g} of the model's largest, {floor:.3e}, for {n_floored} of them); "
        f"{len(norm_tgt)} folded norm_tgt_scale gradients non-zero; launches {want} as the config implies")
    if float64_reference:
        c_loss, c_worst, c_name, _ = grads_against(cpu, ref)
        g_loss, g_worst, g_name, _ = grads_against(card, cpu)
        off = " (over the tolerance: the CPU's float32 is the run that is off)" if g_worst > TRAIN_GRAD_REL else ""
        log(f"    the CPU's float32 against its float64: loss terms within {c_loss:.2e}, gradients within "
            f"{c_worst:.2e} of their scale (worst {c_name}); the card against the CPU's float32: {g_loss:.2e}, "
            f"{g_worst:.2e} (worst {g_name}){off}")


def run_train_full_width(card: str, n_timed: int = 1) -> dict:
    """leaderboard_config() training with use_pallas=True, 8 scenarios per step, bf16 compute."""
    cfg = with_pallas(leaderboard_config(), True)
    n_sc = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    batch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    with recorded_forward_shapes() as seen, recorded_bwd_launches() as (seen_bwd, _):
        step(batch, gen)
    torch.cuda.synchronize()
    log(f"  warm-up step {time.perf_counter() - t0:.3f} s")
    check_path_forward_shapes("training step", seen)
    check_path_bwd_shapes("training step", seen_bwd)
    torch.cuda.reset_peak_memory_stats()
    times, per_step, metrics = [], [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        m = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launches())
        check_staged_route("training step")
        metrics.append({k: float(v) for k, v in m.items()})
    want = expected_train_launches(cfg)
    if any(c != want for c in per_step):
        raise AssertionError(f"training at full width: kernel launches per step {per_step}, expected {want}")
    for m in metrics:
        if not (math.isfinite(m["training/loss"]) and m["training/loss"] != 0 and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"training at full width: loss {m['training/loss']}, grad_norm {m['grad_norm']}")
    changed = sum(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    if changed < 0.95 * len(before):
        raise AssertionError(f"training at full width: only {changed} of {len(before)} parameters changed")
    sec = float(np.median(times))
    log(f"  leaderboard_config use_pallas=True training: {n_sc} scenarios per step, {cfg.data.n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {cfg.time_step_end} steps: seconds per step {[round(t, 4) for t in times]} "
        f"(median {sec:.4f} s), {n_sc / sec:.3f} train samples/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, losses {[round(m['training/loss'], 4) for m in metrics]}, "
        f"grad_norm {[round(m['grad_norm'], 4) for m in metrics]}, {changed} of {len(before)} parameters changed, "
        f"kernel launches per step {per_step[-1]}, launches by route {knarpe.ROUTE_LAUNCHES} [{card}]")
    return per_step[-1], dict(knarpe.ROUTE_LAUNCHES), seen_bwd


def expected_validate_launches(cfg) -> dict:
    """Kernel launches per validation step that the config implies: reactive replay encodes the scene
    (the map encoder's B4), the posterior latent (one TL KNN, one B2 per TL and agent layer) and runs the
    rollout (one agent->map KNN and the agent decoder's B2 per step); then one joint-future call."""
    m, n = cfg.model, cfg.time_step_end
    pallas = m.tf_cfg.use_pallas
    jf = expected_launches(cfg, n)
    post = m.tl_encoder.n_layer_tf + m.ag_encoder.n_layer_tf
    return {**jf, "knn_xy": jf["knn_xy"] + n + 1,
            "knarpe_attention": 2 * jf["knarpe_attention"],
            "knarpe_cross_attention": 2 * jf["knarpe_cross_attention"] + (post if pallas else 0)}


@contextlib.contextmanager
def captured_rollouts():
    """The reactive-replay and joint-future results (pp, buffer) of the validation steps inside the block."""
    real_rr, real_jf, seen = eval_lib.reactive_replay, eval_lib.joint_future_pred, {}

    def rr(*args, **kwargs):
        out = real_rr(*args, **kwargs)
        seen["reactive_replay"] = out[:2]
        return out

    def jf(*args, **kwargs):
        out = real_jf(*args, **kwargs)
        seen["joint_futures"] = out
        return out

    eval_lib.reactive_replay, eval_lib.joint_future_pred = rr, jf
    try:
        yield seen
    finally:
        eval_lib.reactive_replay, eval_lib.joint_future_pred = real_rr, real_jf


def buffer_to_cpu(buf):
    """A RolloutBuffer with every tensor (and every tensor of its dicts) on the CPU."""
    def cpu(x):
        if isinstance(x, dict):
            return {k: v.cpu() for k, v in x.items()}
        return x.cpu() if isinstance(x, torch.Tensor) else x
    return dataclasses.replace(buf, **{f.name: cpu(getattr(buf, f.name)) for f in dataclasses.fields(buf)})


def _flat_out(out: dict) -> dict:
    """A validation step's `out` as {name: tensor on the CPU}, nested dicts flattened."""
    flat = {}
    for key, val in out.items():
        for sub, v in (val.items() if isinstance(val, dict) else [("", val)]):
            flat[f"{key}/{sub}" if sub else key] = v.detach().float().cpu()
    return flat


def _rel_excess(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max(|got - want| - rtol |want| - atol): <= 0 where got is within the tolerance."""
    return float(((got - want).abs() - rtol * want.abs() - atol).max())


def validate_run(cfg, batch, device: str) -> tuple:
    """The validate check's step of the damped seed-1 model on device -> (its flat out, the rollouts' buffers)."""
    model = build_model(cfg, seed=1, device=device)
    damp_weights(model, 0.5)
    reset_launches()
    with captured_rollouts() as seen:
        out = eval_runner.make_validate_step(cfg, model, device=device)(batch, torch.Generator().manual_seed(0))
    if device == "cuda":
        torch.cuda.synchronize()
    return _flat_out(out), seen


def check_validate_card_vs_cpu(use_pallas: bool, time_step_end: int = None, reference_only: bool = False) -> None:
    """One validation step on the card and on the CPU: the phase-4 config with K=34 joint futures, the same
    weights and the same draws. Every comparison is made and logged before any failure is raised. time_step_end
    past the log's 30 steps runs reactive replay's TL step by step past it (phase 13 (e)). reference_only: only
    the CPU run, kept for the check (`cpu_reference`)."""
    cfg = with_pallas(dataclasses.replace(horizon(phase4_config(), time_step_end), n_joint_future_wosac=VALIDATE_K),
                      use_pallas)
    batch = make_batch(cfg.data, n_sc=1, seed=3)
    cpu_run = cpu_reference(("validate", use_pallas, time_step_end), lambda: validate_run(cfg, batch, "cpu"),
                            keep=reference_only)
    if reference_only:
        return
    (cpu, cpu_seen), (gpu, gpu_seen) = cpu_run, validate_run(cfg, batch, "cuda")
    want = expected_validate_launches(cfg)
    if launches() != want:
        raise AssertionError(f"validate check: kernel launches {launches()}, expected {want}")
    failures, notes = [], []
    if set(cpu) != set(gpu):
        failures.append(f"out entries differ: {sorted(set(cpu) ^ set(gpu))}")
    n_diff = n_flags = 0
    for part in ("reactive_replay", "joint_futures"):
        c_buf, g_buf = cpu_seen[part][1], gpu_seen[part][1]
        pose_err = float((g_buf.pred_pose.cpu() - c_buf.pred_pose).abs().max())
        notes.append(f"{part} poses {pose_err:.2e}")
        if not (torch.equal(g_buf.pred_valid.cpu(), c_buf.pred_valid) and pose_err <= SLICE_POSE_ATOL):
            failures.append(f"{part} buffer: max pose err {pose_err} (tolerance {SLICE_POSE_ATOL}) or validity differs")
        for key, val in c_buf.violation.items():
            n_diff += int((g_buf.violation[key].cpu() != val).sum())
            n_flags += val.numel()
    notes.append(f"{n_diff} of {n_flags} flags differ")
    if n_diff > RULE_FLAG_SHARE * n_flags:
        failures.append(f"rule flags: {n_diff} of {n_flags} differ (tolerance {RULE_FLAG_SHARE:g} of them)")
    worst = {}
    for key in sorted(set(cpu) & set(gpu)):
        atol = SLICE_POSE_ATOL if key.endswith("trajs") else 1e-6
        excess = _rel_excess(gpu[key], cpu[key], VALIDATE_REL, atol)
        rel = float(((gpu[key] - cpu[key]).abs() / cpu[key].abs().clamp_min(1e-12)).max())
        worst[key] = rel
        if excess > 0:
            failures.append(f"{key}: off by {rel:.3e} relative (tolerance {VALIDATE_REL:g} + {atol:g})")
    # the realism code alone: the card's realism against the CPU's on the card's own joint futures
    g_jf = gpu_seen["joint_futures"][1]
    cpu_batch = train_lib.batch_to_device(batch, torch.device("cpu"))
    pp = pre_processing(cpu_batch, tl_mode=cfg.model.tl_mode, navi_mode=cfg.model.navi_mode,
                        n_step_hist=cfg.n_step_hist, training=True)
    replay = wosac_likelihood.realism_from_rollout(cpu_batch, pp, buffer_to_cpu(g_jf), cfg.time_step_current)
    replay_worst = 0.0
    for key, val in replay.items():
        got = gpu[f"wosac_realism/{key}"]
        replay_worst = max(replay_worst, float(((got - val).abs() / val.abs().clamp_min(1e-12)).max()))
        if _rel_excess(got, val, VALIDATE_REL, 1e-6) > 0:
            failures.append(f"realism of the card's futures, card vs CPU: {key} {got.tolist()} vs {val.tolist()}")
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    log(f"  use_pallas={use_pallas}: validation step card vs CPU, K={VALIDATE_K}, {cfg.time_step_end} steps: "
        f"{'; '.join(notes)}; {len(worst)} out "
        f"values, worst relative {[(k, f'{v:.2e}') for k, v in top]} (tolerance {VALIDATE_REL:g}); realism of the "
        f"card's futures recomputed on the CPU: worst relative {replay_worst:.2e}; kernel launches "
        f"{expected_validate_launches(cfg)} as the config implies")
    if failures:
        raise AssertionError(f"validate check use_pallas={use_pallas}: " + "; ".join(failures))


def run_validate_full_width(card: str, n_timed: int = 1) -> dict:
    """The validation step at full width: leaderboard_config() with use_pallas=True, 4 scenarios, K=32, level-1
    rule checks, native realism. n_timed steps, checked and timed (the first a first step: phase 8 ran the model's
    encoders at these widths); one more step split by part."""
    cfg = with_pallas(leaderboard_config(), True)
    if not cfg.native_wosac_realism or cfg.n_joint_future_wosac != 32:
        raise AssertionError("full-width validation: expected native realism and K=32 in leaderboard_config()")
    n_sc = 4
    model = build_model(cfg, seed=0, device="cuda")
    step = eval_runner.make_validate_step(cfg, model)
    batch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_sc, seed=0), torch.device("cuda"))
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    times, per_step = [], []
    for _ in range(n_timed):
        reset_launches()
        t0 = time.perf_counter()
        with recorded_forward_shapes() as seen:
            out = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(launches())
        check_path_forward_shapes("validation step", seen)
        check_staged_route("validation step")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = expected_validate_launches(cfg)
    if any(c != want for c in per_step):
        raise AssertionError(f"full-width validation: kernel launches per step {per_step}, expected {want}")
    n_ag, k = cfg.data.n_ag, cfg.n_joint_future_wosac
    n_fut = cfg.time_step_gt - cfg.time_step_current
    shapes = {"womd_trajs": (n_sc, n_ag, 6, n_fut // 5, 3), "womd_scores": (n_sc, n_ag, 6),
              "wosac_trajs": (n_sc, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if tuple(out[name].shape) != shape or not torch.isfinite(out[name]).all():
            raise AssertionError(f"full-width validation: {name} is {tuple(out[name].shape)} (expected {shape}) or "
                                 f"not finite")
    realism = {key: v.float().cpu() for key, v in out["wosac_realism"].items()}
    loss = {key: float(v) for key, v in out["loss_metrics"].items()}
    if not (all(tuple(v.shape) == (n_sc,) and bool(torch.isfinite(v).all()) for v in realism.values())
            and all(0 < float(v) <= 1 for key, val in realism.items() if key.endswith("likelihood") for v in val)
            and all(math.isfinite(v) for v in loss.values()) and loss["reactive_replay/diffbar_reward"] != 0):
        raise AssertionError(f"full-width validation: realism {realism} or losses {loss} out of range")

    # one more step, split by part (synchronised at the part boundaries), with the realism part's own peak
    real_realism, realism_peak = eval_runner.realism_from_rollout, {}

    def realism_with_peak(*args, **kwargs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = real_realism(*args, **kwargs)
        torch.cuda.synchronize()
        realism_peak["GiB"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        return result

    split = {}
    eval_runner.realism_from_rollout = realism_with_peak
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen, split=split)
        t_split = time.perf_counter() - t0
    finally:
        eval_runner.realism_from_rollout = real_realism
    sec = float(np.median(times))
    log(f"  leaderboard_config use_pallas=True validation step: {n_sc} scenarios, K={k} joint futures, {n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {cfg.time_step_end} steps, check_level=1, native realism: seconds per step "
        f"{[round(t, 4) for t in times]} (median {sec:.4f} s; the first a first step), wosac_validate_scenarios_per_sec_per_chip "
        f"{n_sc / sec:.4f}, peak memory {peak:.2f} GiB; split step {t_split:.4f} s: "
        f"{ {part: round(split.get(part, 0.0), 4) for part in eval_runner.SPLIT_PARTS} }, realism working set above "
        f"its inputs {realism_peak['GiB']:.2f} GiB (chunks of at most {wosac_likelihood.CHUNK_ELEMS} elements); "
        f"metametric {[round(v, 4) for v in realism['metametric'].tolist()]}, val loss "
        f"{loss['reactive_replay/loss']:.4f}; kernel launches per step {per_step[-1]}, launches by route "
        f"{knarpe.ROUTE_LAUNCHES} [{card}]")
    return per_step[-1]


@contextlib.contextmanager
def waymo_stub_installed():
    """The structural waymo_open_dataset stubs of tests/waymo_stub importable inside the block, in this process and
    in the WOSAC pool's children (sys.path and PYTHONPATH), and gone after it: phases 10 and 11 hold the submission
    path to its arrays without the package. Their per-scenario metrics are deterministic functions of the rollout's
    structure; they exercise the port's pool and aggregation, not Waymo's likelihoods."""
    stub_dir = str(Path(__file__).resolve().parent / "tests" / "waymo_stub")
    old_path = os.environ.get("PYTHONPATH")
    sys.path.insert(0, stub_dir)
    os.environ["PYTHONPATH"] = stub_dir + (os.pathsep + old_path if old_path else "")
    try:
        yield
    finally:
        sys.path.remove(stub_dir)
        if old_path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old_path
        for name in [m for m in sys.modules if m.split(".")[0] == "waymo_open_dataset"]:
            del sys.modules[name]


def check_validate_official(card: str) -> None:
    """(b) `eval/runner.py::validate` on the card over one batch of the phase-4 config (2 scenarios, K=32, the test
    split's history keys, scenario ids and frames, scenario bytes attached) with tests/waymo_stub installed: the
    WOSAC pool gets both scenarios' filtered futures in the global frame and reports every `wosac/wosac/*` and
    `wosac/wosac_likelihood/*` key; the stub's metametric is exactly what the rollouts' structure gives."""
    cfg = phase4_config()
    model = build_model(cfg, seed=1, device="cuda")
    damp_weights(model, 0.5)
    batch = make_batch(cfg.data, n_sc=2, seed=3)
    test = make_batch(cfg.data, n_sc=2, seed=3, test_mode=True)
    batch.update({k: v for k, v in test.items() if k.startswith(("history/agent", "scenario_"))})
    batch["scenario_bytes"] = [np.frombuffer(f"scenario {i}".encode(), np.uint8) for i in range(2)]
    with waymo_stub_installed():
        t0 = time.perf_counter()
        metrics = eval_runner.validate(cfg, model, [batch], logger=MetricsLogger(None, echo=False))
        sec = time.perf_counter() - t0
    keys = [f"wosac/wosac/{k}" for k in ("realism_meta_metric", "kinematic_metrics", "interactive_metrics",
                                          "map_based_metrics", "min_ade")]
    keys += [f"wosac/wosac_likelihood/{k}" for k in WOSAC_FIELDS]
    missing = [k for k in keys if k not in metrics or not math.isfinite(metrics[k])]
    # the stub's metametric: 0.1 + 0.001 futures + 0.0001 trajectories (the agents valid at the current step)
    cur = cfg.time_step_current
    n_traj = (batch["history/agent/valid"][:, :, cur].sum(1) + batch["history/agent_no_sim/valid"][:, :, cur].sum(1))
    want = float(np.mean(0.1 + 0.001 * min(cfg.n_joint_future_wosac, 32) + 0.0001 * n_traj))
    got = metrics.get("wosac/wosac/realism_meta_metric", float("nan"))
    if missing or not abs(got - want) <= 1e-5 * want:
        raise AssertionError(f"validate with the WOSAC pool: missing or non-finite {missing}; metametric {got}, "
                             f"expected {want}")
    log(f"  (b) validate on the card, phase-4 config, 2 scenarios with scenario bytes, tests/waymo_stub: {sec:.2f} s; "
        f"{len(keys)} official WOSAC keys from the pool, stub metametric {got:.6f} as the rollouts' structure gives "
        f"({want:.6f}); native metametric {metrics['wosac/realism_meta_metric']:.4f}, val/loss "
        f"{metrics['val/loss']:.4f} [{card}]")


def run_submission(card: str) -> None:
    """test_submission at full width: one test-split scenario, K=128 futures filtered to the 32 of the
    submission; the card's filter against the CPU's on the same buffer."""
    cfg = with_pallas(leaderboard_config(), True)
    model = build_model(cfg, seed=0, device="cuda")
    batch = make_batch(cfg.data, n_sc=1, seed=0, test_mode=True)
    n_ag, n_fut = cfg.data.n_ag, cfg.time_step_gt - cfg.time_step_current
    with captured_rollouts() as seen:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = eval_runner.test_submission(cfg, model, [batch], n_joint_future=128)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    if not isinstance(result, list):  # no waymo_open_dataset: the arrays come back
        raise AssertionError(f"submission: expected the arrays without waymo_open_dataset, got {result}")
    (out,) = result
    shapes = {"womd_trajs": (1, n_ag, 6, n_fut // 5, 3), "womd_scores": (1, n_ag, 6),
              "wosac_trajs": (1, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if out[name].shape != shape or not np.isfinite(out[name]).all():
            raise AssertionError(f"submission: {name} is {out[name].shape} (expected {shape}) or not finite")
    pp, buf = seen["joint_futures"]
    if tuple(buf.pred_pose.shape[:2]) != (1, 128):
        raise AssertionError(f"submission: {tuple(buf.pred_pose.shape[:2])} futures, expected (1, 128)")
    on_card = filter_futures(cfg.wosac_post, buf, pp.ag_role, cfg.time_step_current).cpu()
    on_cpu = filter_futures(cfg.wosac_post, buffer_to_cpu(buf), pp.ag_role.cpu(), cfg.time_step_current)
    if not torch.equal(on_card, on_cpu):
        raise AssertionError("submission: the card's 32 futures differ from the CPU's on the same buffer")
    log(f"  test_submission, leaderboard_config use_pallas=True, 1 test scenario, K=128 -> 32: {sec:.4f} s for the "
        f"call; WOMD {out['womd_trajs'].shape}, WOSAC {out['wosac_trajs'].shape} in the global frame, all finite; "
        f"filter_futures on the card keeps the CPU's 32 futures [{card}]")


# phase 11, the training entry point, card vs CPU after two accumulated updates (float32): the first
# update's gradient (the mean of two calls' at the same parameters) to phase 7's tolerance (TRAIN_GRAD_REL
# of its scale); and the parameters, EMA and SWA elementwise to FIT_REL relative + FIT_ATOL absolute
# against a CPU replay of the same updates from each device's own gradients. Adam turns every gradient
# into a step of about lr whatever its size, so an element whose gradient lies within the gradient
# tolerance of 0 steps by +lr on one device and -lr on the other (89-96 of 758,474 values did in chip
# runs); from then on the two runs' parameters differ, so the second update's gradients are only logged,
# and the replay holds the card's optimizer, EMA and SWA to tight tolerances without that amplification. `action=validate` from the checkpoint against the fit's own
# validation of the same parameters, val/loss to VAL_LOSS_REL relative
FIT_REL, FIT_ATOL, VAL_LOSS_REL = 1e-4, 1e-6, 1e-4


def phase4_config(n_step: int = 31):
    return tiny_config(n_ag=16, n_mp=512, n_tl=16, n_step=n_step, hidden_dim=64)


def horizon(cfg, time_step_end=None):
    """cfg rolled out to time_step_end steps (None: its own)."""
    return cfg if time_step_end is None else dataclasses.replace(cfg, time_step_end=time_step_end)


def config_overrides(base, cfg) -> list:
    """The run.py key=value arguments that turn config `base` into `cfg` (dotted keys, JSON values)."""
    out = []

    def walk(a, b, prefix):
        for key, val in b.items():
            if isinstance(val, dict):
                walk(a[key], val, f"{prefix}{key}.")
            elif a[key] != val:
                out.append(f"{prefix}{key}={json.dumps(val)}")

    walk(run_lib.config_to_dict(base), run_lib.config_to_dict(cfg), "")
    return out


def write_tbcache_split(path, cfg, n_sc: int, seed: int, test_mode: bool = False) -> None:
    """n_sc synthetic scenarios (`make_batch`) as a tbcache file, one episode each."""
    batch = make_batch(cfg.data, n_sc=n_sc, seed=seed, test_mode=test_mode)
    tbcache.write_cache(str(path), ({k: v[i] for k, v in batch.items()} for i in range(n_sc)))


def seed_checkpoint(cfg, ckpt_dir, steps_per_epoch: int) -> None:
    """A "last" checkpoint at step 0 holding the seed-0 weights damped to gain 0.5 (`damp_weights`) and a
    fresh optimizer and schedule: a fit with resume=true starts from it, on the card as on the CPU."""
    model = build_model(cfg, seed=0, device="cpu")
    damp_weights(model, 0.5)
    opt, schedule = make_optimizer(cfg.optimizer, model.named_parameters(), steps_per_epoch=steps_per_epoch)
    ckpt = checkpoint_lib.CheckpointManager(str(ckpt_dir))
    ckpt.save_last({"model": model.state_dict(), "optimizer": opt.state_dict(), "schedule": schedule.state_dict()},
                   cfg, {"step": 0, "epoch": 0})
    ckpt.wait()


@contextlib.contextmanager
def recorded_launch_shapes():
    """The full shape of every B1, B4 and B2/B3 forward launch inside the block, counted: (kernel, dtype, n_b, n_s,
    K, D, R, H), or ("knn_xy", rows, sources, targets, k)."""
    shapes, real_fwd, real_knn = collections.Counter(), knarpe._launch, knn.load_library()

    def fwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        shapes[(kernel, str(q.dtype), *q.shape[:2], rpe.shape[2], q.shape[2], rpe.shape[3], n_head)] += 1
        return real_fwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)

    def knn_launch(*args):
        shapes[("knn_xy", *args[6:10])] += 1
        return real_knn(*args)

    knarpe._launch, knn._LAUNCH_FN = fwd, knn_launch
    try:
        yield shapes
    finally:
        knarpe._launch, knn._LAUNCH_FN = real_fwd, real_knn


@contextlib.contextmanager
def recorded_fit(with_grads: bool = False):
    """What the fits inside the block do: per train-step call its seconds (synchronised), launches, launches by
    route, metrics and batch (with_grads: on an update, the gradients it applied, on the CPU); the full shape of every B1, B4 and B2 launch, forward and backward; the seconds of
    each save_last until it returns and of each background write; restore_resume's seconds; each validation's
    metrics; and the model and optimizer state each fit's first step starts from."""
    rec = {"steps": [], "save_return": [], "write": [], "restore": [], "validate": [], "start_state": []}
    manager = checkpoint_lib.CheckpointManager
    real = dict(make=run_lib.make_train_step, bwd=knarpe._launch_bwd, save_last=manager.save_last,
                write=checkpoint_lib._Write._run, restore=manager.restore_resume, validate=eval_runner.validate)

    def make(cfg, model, opt, *args, **kwargs):
        step, calls = real["make"](cfg, model, opt, *args, **kwargs), []

        def timed(batch, *a, **kw):
            if not calls:  # the state the first step starts from, after a resume's restore
                rec["start_state"].append((checkpoint_lib.to_host(model.state_dict()),
                                           checkpoint_lib.to_host(opt.state_dict())))
            calls.append(1)
            before, routes = launches(), dict(knarpe.ROUTE_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch, *a, **kw)
            torch.cuda.synchronize()
            rec["steps"].append(dict(sec=time.perf_counter() - t0, batch=batch,
                                     launches={k: v - before[k] for k, v in launches().items()},
                                     routes={k: v - routes[k] for k, v in knarpe.ROUTE_LAUNCHES.items()},
                                     metrics={k: float(v) for k, v in metrics.items()}))
            if with_grads and "grad_norm" in metrics:
                rec["steps"][-1]["grads"] = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
            return metrics

        timed.accumulator = step.accumulator
        return timed

    def bwd(kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head):
        key = (f"{kernel}_bwd", str(q.dtype), *q.shape[:2], rpe.shape[2], q.shape[2], rpe.shape[3], n_head)
        rec["shapes"][key] += 1
        return real["bwd"](kernel, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, g, n_head)

    def save_last(self, *args, **kwargs):
        t0 = time.perf_counter()
        real["save_last"](self, *args, **kwargs)
        rec["save_return"].append(time.perf_counter() - t0)

    def write(self, *args):
        t0 = time.perf_counter()
        real["write"](self, *args)
        rec["write"].append(time.perf_counter() - t0)

    def restore(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = real["restore"](self, *args, **kwargs)
        rec["restore"].append(time.perf_counter() - t0)
        return out

    def validate(*args, **kwargs):
        metrics = real["validate"](*args, **kwargs)
        rec["validate"].append(metrics)
        return metrics

    run_lib.make_train_step, knarpe._launch_bwd = make, bwd
    checkpoint_lib.CheckpointManager.save_last, checkpoint_lib._Write._run = save_last, write
    checkpoint_lib.CheckpointManager.restore_resume, eval_runner.validate = restore, validate
    try:
        with recorded_launch_shapes() as shapes:  # the forwards and B1; the backwards join them below
            rec["shapes"] = shapes
            yield rec
    finally:
        run_lib.make_train_step, knarpe._launch_bwd = real["make"], real["bwd"]
        checkpoint_lib.CheckpointManager.save_last, checkpoint_lib._Write._run = real["save_last"], real["write"]
        checkpoint_lib.CheckpointManager.restore_resume, eval_runner.validate = real["restore"], real["validate"]


def grads_excess(got: dict, want: dict) -> tuple:
    """(worst |got - want| over its scale, its name) as phase 7 measures gradients: a tensor's scale is its largest
    |want|, floored at TRAIN_GRAD_FLOOR of the largest over the model."""
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in want.values())
    worst = max((float((got[n] - g).abs().max()) / max(float(g.abs().max()), floor), n) for n, g in want.items())
    return worst


def replay_fit(cfg, seed_model: dict, updates: list, n_calls: int, steps_per_epoch: int) -> dict:
    """The parameters, EMA and SWA that `n_calls` calls of a fit reach on the CPU from `seed_model` when update j
    applies the gradients `updates[j]` (after the clip): AdamW and the schedule on every k-th call, the EMA and
    the SWA average after every call, as `run.fit` does."""
    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(seed_model)
    names, params = zip(*model.named_parameters())
    opt, schedule = make_optimizer(cfg.optimizer, model.named_parameters(), steps_per_epoch=steps_per_epoch)
    ema, swa_state = swa_lib.ema_init(params), swa_lib.swa_init(params)
    swa_start = int(cfg.swa_epoch_start * cfg.max_epochs) * steps_per_epoch
    pending = iter(updates)
    for call in range(n_calls):
        if (call + 1) % cfg.optimizer.accumulate_grad_batches == 0:
            grads = next(pending)
            for n, p in zip(names, params):
                p.grad = grads[n].clone()
            opt.step()
            schedule.step()
        swa_lib.ema_update(ema, params, cfg.ema_decay)
        swa_lib.swa_update(swa_state, params, call, swa_start)
    return {"model": dict(model.state_dict()), "ema": dict(zip(names, ema)),
            "swa": dict(zip(names, swa_lib.swa_params(swa_state, params)))}


def states_excess(got: dict, want: dict) -> tuple:
    """(largest |got - want| - FIT_REL |want| - FIT_ATOL over every tensor, its name, elements outside)."""
    if set(got) != set(want):
        raise AssertionError(f"fit card vs CPU: entries differ: {sorted(set(got) ^ set(want))}")
    worst, worst_name, n_out = -math.inf, "", 0
    for name, w in want.items():
        excess = (got[name].float() - w.float()).abs() - FIT_REL * w.float().abs() - FIT_ATOL
        n_out += int((excess > 0).sum())
        if float(excess.max()) > worst:
            worst, worst_name = float(excess.max()), name
    return worst, worst_name, n_out


def check_fit_card_vs_cpu(tmp) -> None:
    """(a) run.fit for 4 calls (2 updates, accumulate_grad_batches=2) with EMA and SWA on the card and on the CPU,
    from the same damped seed-0 weights and the same tbcache file: parameters, EMA and SWA agree."""
    base = no_dropout(with_pallas(phase4_config(), True))
    cfg = dataclasses.replace(base, ema_decay=0.5, swa=True, swa_epoch_start=0.0, limit_train_batches=1.0,
                              validate_every_epoch=False,
                              optimizer=dataclasses.replace(base.optimizer, accumulate_grad_batches=2))
    data_dir = tmp / "fit_a_data"
    data_dir.mkdir()
    write_tbcache_split(data_dir / "training.tbcache", cfg, 8, seed=3)
    write_tbcache_split(data_dir / "validation.tbcache", cfg, 2, seed=4)
    states, updates = {}, {}
    for device in ("cpu", "cuda"):
        ckpt_dir = tmp / f"fit_a_{device}"
        train_loader, val_loader = run_lib.make_dataloaders(cfg, "tbcache", str(data_dir))
        seed_checkpoint(cfg, ckpt_dir, len(train_loader))
        seed_model = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")[0]["model"]
        t0 = time.perf_counter()
        with recorded_fit(with_grads=True) as rec:
            _, _, stopped = run_lib.fit(cfg, train_loader, val_loader, ckpt_dir=str(ckpt_dir), max_steps=4,
                                        resume=True, device=device)
        sec = time.perf_counter() - t0
        updates[device] = [st["grads"] for st in rec["steps"] if "grads" in st]
        state, _, meta = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
        if stopped or meta["step"] != 4 or not {"ema", "swa", "swa_state", "accumulator"} <= set(state):
            raise AssertionError(f"fit card vs CPU on {device}: stopped {stopped}, last at {meta}, entries "
                                 f"{sorted(state)}")
        states[device] = state
        log(f"  run.fit on {device}: 4 calls, 2 updates in {sec:.2f} s; last.json meta {meta}")
    if not len(updates["cpu"]) == len(updates["cuda"]) == 2:
        raise AssertionError(f"fit card vs CPU: {len(updates['cpu'])} and {len(updates['cuda'])} updates, expected 2")
    notes, failures = [], []
    for j, (g_gpu, g_cpu) in enumerate(zip(updates["cuda"], updates["cpu"])):
        worst, name = grads_excess(g_gpu, g_cpu)
        gated = j == 0  # the later updates' gradients are taken at parameters Adam's sign steps already moved apart
        notes.append(f"update {j + 1}'s gradients within {worst:.2e} of their scale ({name}"
                     f"{f', tolerance {TRAIN_GRAD_REL:g}' if gated else ', not gated'})")
        if gated and not worst <= TRAIN_GRAD_REL:
            failures.append(f"update {j + 1}'s gradient of {name} off by {worst} of its scale")
    steps_per_epoch = len(train_loader)
    for device in ("cpu", "cuda"):
        replay = replay_fit(cfg, seed_model, updates[device], 4, steps_per_epoch)
        for entry in ("model", "ema", "swa"):
            worst, name, n_out = states_excess(states[device][entry], replay[entry])
            notes.append(f"{device} {entry} against the replay of its own gradients: worst excess over the tolerance "
                         f"{worst:.3e} ({name}), {n_out} of {sum(v.numel() for v in replay[entry].values())} outside")
            if n_out:
                failures.append(f"{device} {entry}: {n_out} values beyond {FIT_REL:g} relative + {FIT_ATOL:g} of the "
                                f"replay")
    direct = states_excess(states["cuda"]["model"], states["cpu"]["model"])
    notes.append(f"parameters card vs CPU directly: {direct[2]} values beyond {FIT_REL:g} relative + {FIT_ATOL:g} "
                 f"(Adam's sign steps), worst excess {direct[0]:.3e} ({direct[1]})")
    log("  card vs CPU after 2 accumulated updates: " + "; ".join(notes))
    if failures:
        raise AssertionError("fit card vs CPU: " + "; ".join(failures))


def check_fit_shapes(shapes) -> None:
    """Every B1, B4 and B2 launch of the fits, forward and backward, at a full shape phase 3 checked: bf16 B4 and
    B2 on the staged route, B1 against its plain version."""
    fwd_x = [X_PATH, TRAIN_X_PATH, POST_TL_X_PATH, *X_EDGE, *FIT_X, *VAL_X]
    attn = [ATTN_PATH, TRAIN_ATTN_PATH, *ATTN_EDGE, *ATTN_STAGED_EDGE]
    checked = {("knarpe_attention", *s) for s in attn} | {("knarpe_attention_bwd", *s) for s in attn}
    checked |= {("knarpe_cross_attention", *s) for s in fwd_x}
    checked |= {("knarpe_cross_attention_bwd", *s) for s in [TRAIN_X_PATH, POST_TL_X_PATH, *X_BWD_EDGE]}
    checked_knn = {case[:4] for case in KNN_CASES.values()}
    bad = []
    for key in shapes:  # (kernel, dtype, n_b, n_s, K, D, R, H), or ("knn_xy", rows, sources, targets, k)
        if key[0] == "knn_xy":
            ok = tuple(key[1:]) in checked_knn
        else:
            ok = key[1] == str(torch.bfloat16) and (key[0], *key[2:]) in checked
        if not ok:
            bad.append(key)
    if bad:
        raise AssertionError(f"fit: launches at shapes phase 3 did not check: {sorted(bad, key=str)}")


def run_fit_full_width(card: str, tmp, before_resume=lambda: None) -> tuple:
    """(b) `run.main(["action=fit", ...])` on leaderboard_config() with use_pallas=True from a tbcache of 8
    training and 4 validation scenarios: 2 steps, then (after before_resume()) a resume to 3. -> (launches per step,
    ckpt_dir, data_dir, the resumed fit's validation loss, times)."""
    cfg = with_pallas(leaderboard_config(), True)
    data_dir, ckpt_dir = tmp / "fit_b_data", tmp / "fit_b_ckpt"
    data_dir.mkdir()
    t0 = time.perf_counter()
    write_tbcache_split(data_dir / "training.tbcache", cfg, 8, seed=0)
    write_tbcache_split(data_dir / "validation.tbcache", cfg, 4, seed=1)
    log(f"  tbcache of 8 training and 4 validation scenarios at full width written in {time.perf_counter() - t0:.2f} s "
        f"({(data_dir / 'training.tbcache').stat().st_size} and {(data_dir / 'validation.tbcache').stat().st_size} "
        f"bytes)")
    args = ["action=fit", "data=tbcache", f"data_dir={data_dir}", f"ckpt_dir={ckpt_dir}", "model.tf_cfg.use_pallas=true",
            "ckpt_every_steps=2", "ema_decay=0.999", "val_epoch_batches=1", "batch_size_test=4", "limit_train_batches=1.0",
            "log_every=1"]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_fit() as rec:
        t0 = time.perf_counter()
        model, _, stopped = run_lib.main(args + ["max_steps=2"])
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
    run_counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps, want = rec["steps"], expected_train_launches(cfg)  # a fit step's are a training step's at any batch
    if stopped or len(steps) != 2 or len(rec["validate"]) != 1:
        raise AssertionError(f"fit: stopped {stopped}, {len(steps)} steps, {len(rec['validate'])} validations")
    for i, st in enumerate(steps):
        m = st["metrics"]
        if st["launches"] != want:
            raise AssertionError(f"fit step {i + 1}: kernel launches {st['launches']}, expected {want}")
        if any(v for key, v in st["routes"].items() if key.endswith("/general")):
            raise AssertionError(f"fit step {i + 1}: launches by route {st['routes']}, expected all staged")
        if not (math.isfinite(m["training/loss"]) and math.isfinite(m.get("grad_norm", math.nan)) and m["grad_norm"] > 0):
            raise AssertionError(f"fit step {i + 1}: loss {m['training/loss']}, grad_norm {m.get('grad_norm')}")
    want_run = {k: 2 * want[k] + expected_validate_launches(cfg)[k] for k in want}
    if run_counts != want_run:
        raise AssertionError(f"fit: launches over the run {run_counts}, expected 2 steps and one validation {want_run}")
    check_fit_shapes(rec["shapes"])
    ckpt = checkpoint_lib.CheckpointManager(str(ckpt_dir))
    last, _, meta = ckpt.restore("last")
    _, _, best_meta = ckpt.restore("best")
    live = checkpoint_lib.to_host(model.state_dict())
    if meta["step"] != 2 or best_meta["step"] != 2 or not all(torch.equal(last["model"][n], v) for n, v in live.items()):
        raise AssertionError(f"fit: last {meta}, best {best_meta}, or the restored parameters differ from the live ones")
    ckpt_bytes = ckpt.path("last").stat().st_size
    n_params = sum(v.numel() for v in live.values())
    sec = [st["sec"] for st in steps]
    log(f"  leaderboard_config use_pallas=True run.main action=fit, tbcache, batch 2: steps {[round(t, 4) for t in sec]} s "
        f"(the steps after the first: median {np.median(sec[1:]):.4f} s, {2 / np.median(sec[1:]):.3f} train samples/s), "
        f"whole run {t_fit:.2f} s, peak memory {peak:.2f} GiB, losses "
        f"{[round(st['metrics']['training/loss'], 4) for st in steps]}, grad_norm "
        f"{[round(st['metrics']['grad_norm'], 4) for st in steps]}; launches per step {steps[-1]['launches']} (all "
        f"staged), over the run {run_counts}; launches by full shape {dict(rec['shapes'])}, each checked in phase 3; "
        f"save_last returns in {[round(t, 4) for t in rec['save_return']]} s, writes {[round(t, 4) for t in rec['write']]}"
        f" s; checkpoint {ckpt_bytes} bytes ({n_params} parameters); last {meta}, best {best_meta}; the restored "
        f"parameters equal the live model's bit for bit [{card}]")

    # the resume: from step 2, exactly the saved state, the 3rd batch of epoch 0's permutation
    saved = checkpoint_lib.to_host(ckpt.restore("last")[0])
    before_resume()
    with recorded_fit() as rec2:
        t0 = time.perf_counter()
        run_lib.main(args + ["max_steps=3", "resume=true"])
        t_resume_run = time.perf_counter() - t0
    state, _, meta2 = ckpt.restore("last")
    start_model, start_opt = rec2["start_state"][0]
    same_model = all(torch.equal(start_model[n], v) for n, v in saved["model"].items())
    same_opt = all(torch.equal(a, b) for a, b in zip(_tensors(start_opt), _tensors(saved["optimizer"])))
    idx = np.arange(8)
    np.random.default_rng(cfg.seed).shuffle(idx)
    want_batch = tbcache.TBCacheDataset(str(data_dir / "training.tbcache")).get_batch(idx[4:6])
    got_batch = checkpoint_lib.to_host(rec2["steps"][0]["batch"])  # the fit's prefetch hands the step card tensors
    same_batch = all(np.array_equal(np.asarray(got_batch[k]), v) for k, v in want_batch.items())
    if not (len(rec2["steps"]) == 1 and meta2["step"] == 3 and same_model and same_opt and same_batch):
        raise AssertionError(f"fit resume: {len(rec2['steps'])} steps, last at {meta2}, starts from the saved model "
                             f"{same_model} and optimizer {same_opt}, on the 3rd batch {same_batch}")
    log(f"  resume=true max_steps=3 (beside (c)): restore_resume {rec2['restore'][0]:.4f} s, whole resumed run "
        f"{t_resume_run:.2f} s (one step {rec2['steps'][0]['sec']:.4f} s and one validation); started from the saved model and optimizer "
        f"state bit for bit, at step 2 on the 3rd batch of epoch 0's permutation; last {meta2} [{card}]")
    times = dict(step_s=float(np.median(sec[1:])), samples_per_s=2 / float(np.median(sec[1:])), peak_gib=peak,
                 save_return_s=rec["save_return"], write_s=rec["write"], ckpt_bytes=ckpt_bytes,
                 resume_s=rec2["restore"][0])
    return steps[-1]["launches"], ckpt_dir, data_dir, rec2["validate"][0]["val/loss"], times


def _tensors(obj):
    """The tensors of a nested dict / list, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def check_fit_preemption(card: str, tmp) -> None:
    """(c) A `python -m trafficbotsv15_tpu_torch.run action=fit` subprocess at the phase-4 config gets SIGTERM once
    it has logged its first step (its handler installed): exit 143 with "last" at a step >= 1; a resume=true
    relaunch adds exactly one step."""
    import signal

    ckpt_dir = tmp / "fit_c_ckpt"
    base = tiny_config()
    cfg = dataclasses.replace(with_pallas(phase4_config(), True), validate_every_epoch=False, max_epochs=5)
    args = [sys.executable, "-u", "-m", "trafficbotsv15_tpu_torch.run", "action=fit", "preset=tiny", "data=synthetic",
            f"ckpt_dir={ckpt_dir}", "log_every=1", *config_overrides(base, cfg)]
    t0 = time.perf_counter()
    repo = Path(__file__).resolve().parent
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=repo)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[step 1]"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=300)
        lines.append(rest)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 143:
        raise AssertionError(f"fit preemption: exit {proc.returncode}, expected 143:\n{''.join(lines)[-3000:]}")
    _, _, meta = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
    t_stop = time.perf_counter() - t0
    resumed = subprocess.run(args + ["resume=true", f"max_steps={meta['step'] + 1}"], capture_output=True, text=True,
                             timeout=300, cwd=repo)
    _, _, meta2 = checkpoint_lib.CheckpointManager(str(ckpt_dir)).restore("last")
    if meta["step"] < 1 or resumed.returncode != 0 or meta2["step"] != meta["step"] + 1:
        raise AssertionError(f"fit preemption: stopped at {meta}, resume exit {resumed.returncode} at {meta2}:\n"
                             f"{resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
    log(f"  SIGTERM after the first logged step: exit 143 in {t_stop:.2f} s with last at step {meta['step']}; "
        f"resume=true relaunch: exit 0, last at step {meta2['step']} [{card}]")


def check_validate_and_test(card: str, ckpt_dir, data_dir, fit_val_loss: float, tmp) -> None:
    """(d) `action=validate` from the fit's checkpoint gives the fit's own val/loss; `action=test` from "best" at
    K=128 makes the submission arrays phase 10 checks."""
    common = [f"ckpt_dir={ckpt_dir}", "data=tbcache"]
    t0 = time.perf_counter()
    metrics = run_lib.main(["action=validate", f"data_dir={data_dir}", "model.tf_cfg.use_pallas=true",
                            "batch_size_test=4", *common])
    t_val = time.perf_counter() - t0
    rel = abs(metrics["val/loss"] - fit_val_loss) / max(abs(fit_val_loss), 1e-12)
    if not rel <= VAL_LOSS_REL:
        raise AssertionError(f"action=validate: val/loss {metrics['val/loss']} against the fit's {fit_val_loss}")
    cfg = leaderboard_config()
    test_dir = tmp / "fit_d_test"
    test_dir.mkdir()
    write_tbcache_split(test_dir / "validation.tbcache", cfg, 1, seed=0, test_mode=True)
    write_tbcache_split(test_dir / "training.tbcache", cfg, 1, seed=0)
    t0 = time.perf_counter()
    result = run_lib.main(["action=test", f"data_dir={test_dir}", *common])
    t_test = time.perf_counter() - t0
    if not isinstance(result, list) or len(result) != 1:
        raise AssertionError(f"action=test: expected one batch of arrays without waymo_open_dataset, got {type(result)}")
    (out,) = result
    n_ag, n_fut = cfg.data.n_ag, cfg.time_step_gt - cfg.time_step_current
    shapes = {"womd_trajs": (1, n_ag, 6, n_fut // 5, 3), "womd_scores": (1, n_ag, 6),
              "wosac_trajs": (1, 32, n_ag, n_fut, 3)}
    for name, shape in shapes.items():
        if out[name].shape != shape or not np.isfinite(out[name]).all():
            raise AssertionError(f"action=test: {name} is {out[name].shape} (expected {shape}) or not finite")
    log(f"  action=validate from last: val/loss {metrics['val/loss']:.6f} against the fit's {fit_val_loss:.6f} "
        f"({rel:.2e} relative, tolerance {VAL_LOSS_REL:g}) in {t_val:.2f} s; action=test from best, K=128, batch 1: "
        f"WOMD {out['womd_trajs'].shape}, WOSAC {out['wosac_trajs'].shape}, finite, in {t_test:.2f} s [{card}]")


def run_fit_phase(card: str) -> dict:
    """Phase 11: (b), then (b)'s resume, (a) and (d) with (c)'s subprocesses running beside them (none of them
    times anything (c) would disturb: (b)'s fit step is timed before (c) starts); -> launches per full-width fit
    step."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as name, ThreadPoolExecutor(1) as pool:
        tmp = Path(name)
        started = []

        def preemption():
            t1 = time.perf_counter()
            check_fit_preemption(card, tmp)
            return time.perf_counter() - t1

        counts, ckpt_dir, data_dir, val_loss, times = run_fit_full_width(
            card, tmp, before_resume=lambda: started.append(pool.submit(preemption)))
        t_b = time.perf_counter() - t0
        preempted = started[0]
        t1 = time.perf_counter()
        check_fit_card_vs_cpu(tmp)
        t_a = time.perf_counter() - t1
        t1 = time.perf_counter()
        check_validate_and_test(card, ckpt_dir, data_dir, val_loss, tmp)
        t_d = time.perf_counter() - t1
        t_c = preempted.result()
    total = time.perf_counter() - t0
    log(f"  (e) fit at full width, batch 2: {times['step_s']:.4f} s per step, {times['samples_per_s']:.4f} train "
        f"samples/s, peak {times['peak_gib']:.2f} GiB; save_last returns in "
        f"{[round(t, 4) for t in times['save_return_s']]} s, background writes "
        f"{[round(t, 4) for t in times['write_s']]} s, checkpoint {times['ckpt_bytes']} bytes, resume (restore_resume) "
        f"{times['resume_s']:.4f} s; phase 11 {total:.1f} s ((b) {t_b:.1f} with its resume, (a) {t_a:.1f} and (d) "
        f"{t_d:.1f} beside (c) {t_c:.1f}) [{card}]")
    return counts


def _worst(checks) -> str:
    """The toleranced check nearest its tolerance (largest excess), with its error and tolerance; the checks
    held to equality pass only when equal."""
    tol = [c for c in checks if c.atol or c.rtol]
    if not tol:
        return "every check equal"
    c = max(tol, key=lambda c: c.excess())
    return (f"{c.name}: max |err| {c.max_abs_err():.3e} against atol {c.atol:g} + rtol {c.rtol:g} * |golden|, "
            f"excess {c.excess():.3e}")


def _run_golden(module, case: str, use_pallas: bool, kw: dict, want: dict) -> list:
    """One golden case on the card; every check within its tolerance and the kernels launched exactly as `want`
    says (the others not at all), float32 on the general route."""
    reset_launches()
    checks = module.run_case(case, device="cuda", use_pallas=use_pallas, **kw)
    torch.cuda.synchronize()
    want = {name: want.get(name, 0) for name in launches()}
    routes = {f"{kernel}/{way}": (n if way == "general" else 0) for kernel, n in want.items() if kernel != "knn_xy"
              for way in ("staged", "general")}
    got_routes = {key: knarpe.ROUTE_LAUNCHES[key] for key in routes}
    if launches() != want or got_routes != routes:
        raise AssertionError(f"golden {case} use_pallas={use_pallas} {kw}: launches {launches()} by route "
                             f"{got_routes}, expected {want} on the general route")
    bad = [c for c in checks if not c.excess() <= 0.0]
    if bad:
        raise AssertionError(f"golden {case} use_pallas={use_pallas} {kw} on the card: " + "; ".join(_worst([c])
                                                                                                for c in bad))
    return checks


def check_reference_layout_flagship(card: str, gm, reference_state_dict) -> dict:
    """(b) leaderboard_config's weights through the reference layout: exported, loaded back through
    `load_reference_state_dict`, bit-equal, and one full-width call bit-equal to the directly loaded model's."""
    from trafficbotsv15_tpu_torch.utils.torch_import import load_reference_state_dict

    t0 = time.perf_counter()
    sd = gm.load_golden("model", "traffic_bots_full")[0]
    exported = reference_state_dict(gm.full_model("traffic_bots_full", "cpu")[0])
    if len(sd) != 526 or {k: v.shape for k, v in exported.items()} != {k: v.shape for k, v in sd.items()}:
        raise AssertionError(f"reference layout at traffic_bots_full's config: {len(exported)} keys, the golden "
                             f"{len(sd)}; names or shapes differ")
    cfg = with_pallas(leaderboard_config(), True)
    src = build_model(cfg, seed=0, device="cuda")
    damp_weights(src, 0.5)
    t1 = time.perf_counter()
    ref_sd = reference_state_dict(src, cfg.data)
    t_export = time.perf_counter() - t1
    dst = build_model(cfg, seed=1, device="cuda")
    t1 = time.perf_counter()
    load_reference_state_dict(dst, ref_sd, cfg.model, cfg.time_step_gt)
    t_load = time.perf_counter() - t1
    want = src.state_dict()
    differ = [k for k, v in dst.state_dict().items() if not torch.equal(v.view(torch.int32), want[k].view(torch.int32))]
    if differ:
        raise AssertionError(f"reference layout: parameters differ after the round trip: {differ[:8]}")
    log(f"  (b) the inverse at traffic_bots_full's config gives the golden's {len(sd)} names and shapes; "
        f"leaderboard_config (use_pallas=True, seed 0, damped 0.5): {len(ref_sd)} reference entries exported in "
        f"{t_export:.2f} s, loaded through load_reference_state_dict in {t_load:.2f} s, all {len(want)} parameters "
        f"bit-equal")
    batch = make_batch(cfg.data, n_sc=4, seed=0)
    bufs, counts = {}, {}
    for name, model in (("direct", src), ("reference layout", dst)):
        reset_launches()
        with recorded_forward_shapes() as seen:
            _, bufs[name] = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0),
                                              check_level=1)
        torch.cuda.synchronize()
        counts[name] = launches()
        check_staged_route(f"reference-layout {name} call")
        check_path_forward_shapes(f"reference-layout {name} call", seen)
    want_counts = expected_launches(cfg, cfg.time_step_end)
    if counts["reference layout"] != want_counts or counts["direct"] != want_counts:
        raise AssertionError(f"reference layout: launches {counts}, expected {want_counts} each")
    a, b = bufs["direct"], bufs["reference layout"]
    same = {"pred_pose": torch.equal(a.pred_pose[:, 0], b.pred_pose[:, 0]),
            "pred_valid": torch.equal(a.pred_valid[:, 0], b.pred_valid[:, 0]),
            **{f"violation/{k}": torch.equal(a.violation[k][:, 0], b.violation[k][:, 0]) for k in a.violation}}
    if not all(same.values()):
        raise AssertionError(f"reference layout: K0 futures or rule flags differ from the direct model's: "
                             f"{[k for k, v in same.items() if not v]}")
    flags = {k: int(v[:, 0].sum()) for k, v in b.violation.items() if not k.endswith("_this_step")}
    log(f"  (b) joint_future_pred 4 scenarios x K=32, 64 agents, 1024 polylines, 90 steps, check_level=1 from the "
        f"reloaded model: launches {counts['reference layout']} (as the direct model's, all staged); K0 futures "
        f"{list(b.pred_pose[:, 0].shape)} and all {len(a.violation)} rule flags bit-equal to the direct model's "
        f"(K0 agent-steps flagged {flags}); phase (b) {time.perf_counter() - t0:.1f} s [{card}]")
    return counts["reference layout"]


def run_golden_phase(card: str) -> dict:
    """Phase 12: (a) the reference-torch goldens through the kernels and through the card's plain path; (b) the
    flagship through the reference layout. -> launches of (b)'s full-width call."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import test_torch_golden_model as gm
    import test_torch_golden_sim as gs
    from torch_reference_layout import reference_state_dict

    for case, (kw, want) in gm.KERNEL_CASES.items():
        checks = _run_golden(gm, case, True, kw, want)
        errs = ", ".join(f"{c.name} {c.max_abs_err():.3e} ({c.atol:g}, {c.rtol:g})" for c in checks)
        log(f"  (a) {case} {kw or ''} use_pallas=True float32: launches {want} on the general route; max |err| "
            f"(atol, rtol): {errs}; worst {_worst(checks)}")
    sweep = [(gm, name, kw) for name, kw in gm.MODEL_CASES] + [(gm, "traffic_bots_full", {}),
                                                               (gm, "traffic_bots_rnn", {})]
    sweep += [(gs, name, {}) for name in gs.SIM_CASES]
    worst = []
    for module, case, kw in sweep:
        checks = [c for c in _run_golden(module, case, False, kw, {}) if c.atol or c.rtol]
        worst += [(c.excess(), case, kw, c) for c in checks]
    excess, case, kw, c = max(worst, key=lambda w: w[0])
    log(f"  (a) sweep on the card with use_pallas=False: {len(sweep)} golden cases ({len(gm.MODEL_CASES) + 2} model, "
        f"{len(gs.SIM_CASES)} sim), every check within its tolerance (the exact ones equal), no kernel launch; "
        f"nearest its tolerance: {case} {kw or ''} {_worst([c])} [{card}]")
    counts = check_reference_layout_flagship(card, gm, reference_state_dict)
    log(f"  phase 12 {time.perf_counter() - t0:.1f} s [{card}]")
    return counts

# phase 13, the scaled preset: 4 scenarios x K=32 futures for eval and validation, the preset's own batch of 1 for
# training; (e) rolls the phase-4 config out 10 steps past its 30 logged ones
SCALED_N_SC, SCALED_CHECK_END = 4, 35


def check_scaled_shapes(where: str, shapes, want: dict) -> None:
    """The launches of a scaled-preset call or step, by full shape, are exactly `want`, and each shape is one phase 3
    checked: B1 against its plain version, bf16 B4 against its own on the heads route and bf16 B2 on the cluster
    route, bf16 B4-bwd and B2-bwd against autograd of the plain version on the heads routes."""
    bf = str(torch.bfloat16)
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    checked |= {("knarpe_attention", bf, *s) for s in HEADS_ATTN}
    checked |= {("knarpe_cross_attention", bf, *s) for s in CLUSTER_X}
    checked |= {("knarpe_attention_bwd", bf, *s) for s in HEADS_ATTN_BWD}
    checked |= {("knarpe_cross_attention_bwd", bf, *s) for s in HEADS_X_BWD}
    check_full_shapes(where, shapes, want, checked)


def check_full_shapes(where: str, shapes, want: dict, checked: set) -> None:
    """A call's or step's launches by full shape are exactly `want`, and each shape is in `checked`."""
    if dict(shapes) != want or not set(shapes) <= checked:
        raise AssertionError(f"{where}: launches by shape {dict(shapes)}, expected {want}, each at a shape phase 3 "
                             f"checked (unchecked: {sorted(set(shapes) - checked, key=str)})")


@contextlib.contextmanager
def captured_launches(*kernels: str):
    """The operands (B4: q, k, v, rpe, invalid, w_rpe, b; B2: q, tgt, rpe, invalid, w_kv, w_rpe, b), n_head and
    output of the first forward launch of each of `kernels` inside the block, cloned: {kernel: {"args": [...],
    "n_head": H, "out": tensor}}, without the kernels that did not launch."""
    real, got = knarpe._launch, {}

    def capture(name, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head):
        out = real(name, q, k, v, tgt, rpe, invalid, w_kv, w_rpe, b, n_head)
        if name in kernels and name not in got:
            ops = (q, k, v, rpe, invalid, w_rpe, b) if name == "knarpe_attention" else (q, tgt, rpe, invalid, w_kv,
                                                                                          w_rpe, b)
            got[name] = {"args": [t.clone() for t in ops], "n_head": n_head, "out": out.clone()}
        return out

    knarpe._launch = capture
    try:
        yield got
    finally:
        knarpe._launch = real


def check_path_launch(where: str, kernel: str, got: dict) -> float:
    """A captured bf16 B4 or B2 launch of a path against the float32 plain version on its own (bf16-valued)
    operands, at phase 3's bf16 tolerance; returns the max |err|."""
    what = "B4" if kernel == "knarpe_attention" else "B2"
    if not got:
        raise AssertionError(f"{where}: no {what} launch to check")
    plain = getattr(knarpe, f"{kernel}_reference")
    ref = plain(*[a if a.dtype == torch.bool else a.float() for a in got["args"]], got["n_head"])
    out = got["out"].float()
    err = float((out - ref).abs().max())
    excess = float(((out - ref).abs() - (BF16_HALF_ULP * ref.abs() + KNARPE_F32_ATOL)).max())
    if not (got["out"].dtype == torch.bfloat16 and torch.isfinite(out).all() and excess <= 0):
        raise AssertionError(f"{where}: the first {what} launch's output exceeds {BF16_HALF_ULP} relative + "
                             f"{KNARPE_F32_ATOL} of the plain version on its inputs by {excess}")
    log(f"  {where}: the first {what} launch {list(got['out'].shape)} against the float32 plain version on its own "
        f"inputs: max |err| {err:.3e}, within {BF16_HALF_ULP:g} relative + {KNARPE_F32_ATOL:g} absolute")
    return err


def check_path_bwd_launch(where: str, kernel: str, got: dict) -> float:
    """A captured bf16 B4 or B2 backward launch of a path (`recorded_bwd_launches`) against the float32 plain backward
    on its own (bf16-valued) operands and g, at phase 3's bf16 tolerance (2^-8 of each value plus 1e-4 of each
    gradient's largest), its gradients not all zero; returns the max |err|."""
    attn = kernel == "knarpe_attention"
    what = "B4" if attn else "B2"
    if not got:
        raise AssertionError(f"{where}: no {what} backward launch to check")
    want = _plain_bwd(kernel, [a if a.dtype == torch.bool else a.float() for a in got["args"]], got["g"].float(),
                      got["n_head"])
    names = ("dq", "dk", "dv", "drpe", "dw_rpe", "db") if attn else ("dq", "dtgt", "drpe", "dw_kv", "dw_rpe", "db")
    err = 0.0
    for name, a, b in zip(names, got["grads"], want):
        tol = BF16_HALF_ULP * b.abs() + KNARPE_BWD_F32_REL * float(b.abs().max())
        if not (a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()) and bool(((a.float() - b).abs() <= tol)
                                                                                   .all())):
            raise AssertionError(f"{where}: the first {what} backward launch's {name} exceeds 2^-8 relative + 1e-4 of "
                                 f"the largest against the plain backward on its inputs")
        err = max(err, float((a.float() - b).abs().max()))
    if not any(bool(a.any()) for a in got["grads"]):
        raise AssertionError(f"{where}: the first {what} backward launch with a gradient gave all-zero gradients")
    log(f"  {where}: the first {what} backward launch with a non-zero incoming gradient "
        f"{list(got['args'][1].shape)} against the float32 plain backward on its own inputs: max |err| {err:.3e} over "
        f"its six gradients, each within 2^-8 relative + 1e-4 of the largest")
    return err


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def run_scaled_phase(card: str) -> dict:
    """`scaled_config()` at full width (hidden 256, 8 heads, 12/6/6 layers, 120 steps past the log's 91, bf16
    compute), random seed-0 weights, synthetic scenarios: (a) joint_future_pred, use_pallas=False, and (d) with
    use_pallas=True, B4 on the heads route and B2 on the cluster route, timed in turns; (b) the training step at
    batch 1, and (f) with use_pallas=True, timed in turns; (c) the validation step; (e) the phase-4 config past its
    log, card against CPU. Returns the launches per call or step by path; the max |err| of (d)'s first B4 and first
    B2 launch and of (f)'s first B4-bwd launch against the plain versions on their inputs, by kernel; and (f)'s
    launches by route and by full shape."""
    t_phase = time.perf_counter()
    first_errs = {}
    n_sc = SCALED_N_SC
    knn_eval = ("knn_xy", n_sc * 32, KNN_SRC, KNN_TGT, KNN_K)  # the agent->map KNN of 4 x 32 rollouts

    # (a) eval with use_pallas=False and (d) with use_pallas=True, where B4 in bf16 at D=R=256, H=8 takes the heads
    # route and B2 the cluster route: one call each, checked and timed, in turns (a d), with no warm-up call (each time
    # is a first call's at these shapes); the first B4 and B2 launches of (d)'s call are captured and held against the
    # plain versions on their own inputs
    cfg = with_pallas(scaled_config(), False)
    n_step, n_ag, k = cfg.time_step_end, cfg.data.n_ag, cfg.n_joint_future_wosac
    n_logged = cfg.data.n_step
    if not (n_step >= n_logged and k == 32 and cfg.precision == "bf16"):
        raise AssertionError(f"scaled_config(): {n_step} steps against {n_logged} logged, K={k}, {cfg.precision}")
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(0)
    pcfg = with_pallas(scaled_config(), True)
    pmodel = build_model(pcfg, seed=0, device="cuda")
    pgen = torch.Generator().manual_seed(0)
    n_b4, n_b2 = pcfg.model.mp_encoder.n_layer_tf, pcfg.model.ag_encoder.n_layer_tf * n_step
    arms = {"a": (cfg, model, gen, {knn_eval: n_step}, {}),
            "d": (pcfg, pmodel, pgen,
                  {knn_eval: n_step, ("knarpe_attention", str(torch.bfloat16), *SCALED_ATTN_PATH): n_b4,
                   ("knarpe_cross_attention", str(torch.bfloat16), *SCALED_X_PATH): n_b2},
                  {"knarpe_attention/heads": n_b4, "knarpe_cross_attention/cluster": n_b2})}
    times, peaks, counts, bufs, routes = {}, {}, {}, {}, {}
    for arm in "ad":
        acfg, amodel, agen, want_shapes, want_routes = arms[arm]
        where = f"scaled eval call use_pallas={acfg.model.tf_cfg.use_pallas}"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        with recorded_launch_shapes() as shapes, captured_launches(
                *(("knarpe_attention", "knarpe_cross_attention") if arm == "d" else ())) as first:
            _, bufs[arm] = joint_future_pred(acfg, amodel, batch, generator=agen, check_level=1)
        torch.cuda.synchronize()
        times.setdefault(arm, []).append(time.perf_counter() - t1)
        peaks[arm] = max(peaks.get(arm, 0.0), peak_gib())
        check_scaled_shapes(where, shapes, want_shapes)
        counts[arm], routes[arm] = launches(), dict(knarpe.ROUTE_LAUNCHES)
        by_route = {key: want_routes.get(key, 0) for key in routes[arm]}
        if counts[arm] != expected_launches(acfg, n_step) or routes[arm] != by_route:
            raise AssertionError(f"{where}: launches {counts[arm]}, by route {routes[arm]}, expected "
                                 f"{expected_launches(acfg, n_step)}, by route {by_route}")
        if arm == "d":
            first_errs.update({kernel: check_path_launch(f"(d) {where}", kernel, first.get(kernel, {}))
                               for kernel in ("knarpe_attention", "knarpe_cross_attention")})
        del first
    buf, pbuf = bufs["a"], bufs["d"]
    eval_counts, pallas_counts = counts["a"], counts["d"]
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not (torch.isfinite(buf.pred_pose).all()
                                                                         and torch.isfinite(buf.log_prob).all()):
        raise AssertionError(f"scaled eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    past = n_logged - 1  # buffer index of step 91, the first the log does not hold
    free = int(torch.nonzero(~buf.tl_state_nll_invalid.flatten(0, 2).all(0)).max()) + 1  # first all-invalid index
    if not (buf.tl_state_nll_invalid[..., past:].all() and not buf.mask_teacher_forcing[..., past:].any()):
        raise AssertionError("scaled eval call: TL NLL not masked or agents forced past the log")
    if tuple(pbuf.pred_pose.shape) != tuple(buf.pred_pose.shape) or not torch.isfinite(pbuf.pred_pose).all():
        raise AssertionError("scaled eval call use_pallas=True: poses out of shape or not finite")
    eval_s, pallas_s = (float(np.median(times[arm])) for arm in "ad")
    log(f"  (a) scaled_config use_pallas=False joint_future_pred: {n_sc} scenarios x K={k}, {n_ag} agents, "
        f"{cfg.data.n_mp} polylines, {n_step} steps ({n_logged} logged), {n_params} parameters, bf16 compute: "
        f"seconds per call {[round(t, 4) for t in times['a']]} (median {eval_s:.4f} s; a first call), "
        f"{n_sc * k * n_ag * (n_step - cfg.time_step_current) / eval_s:.1f} agent-steps/s, peak memory "
        f"{peaks['a']:.2f} GiB; launches per call {eval_counts} (B1 all at {list(knn_eval[1:])}); poses "
        f"{list(buf.pred_pose.shape)} finite; from buffer index {free} on (history ends there) and so past index "
        f"{past}: TL NLL masked, no agent forced [{card}]")
    log(f"  (d) scaled_config use_pallas=True joint_future_pred: seconds per call "
        f"{[round(t, 4) for t in times['d']]} (median {pallas_s:.4f} s; a first call) against (a)'s {eval_s:.4f} s, in turns "
        f"a d ({pallas_s - eval_s:+.4f} s), peak memory {peaks['d']:.2f} GiB; launches per call {pallas_counts}, "
        f"by route {routes['d']} (B4 at {list(SCALED_ATTN_PATH)} on the heads route, B2 at {list(SCALED_X_PATH)} on "
        f"the cluster route, shapes phase 3 checked); poses finite [{card}]")
    del pmodel, arms
    torch.cuda.empty_cache()

    # (b) the training step at the preset's batch_size_train with use_pallas=False, and (f) with use_pallas=True, B4,
    # B4-bwd and B2-bwd on the heads routes, B2 on the cluster route: (f)'s model and optimizer built as (b)'s (seed 0),
    # the same batch; one step each, checked and timed, in turns (b f), with no warm-up step (each time is a first
    # step's); the first B4 and the first B2 backward launch of (f)'s step are captured and held against the plain
    # backward on their inputs
    n_train = cfg.batch_size_train
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    tmodel = build_model(pcfg, seed=0, device="cuda")
    tstep = train_lib.make_train_step(pcfg, tmodel, *make_optimizer(pcfg.optimizer, tmodel.named_parameters()))
    tgen = torch.Generator().manual_seed(0)
    bf, knn_train = str(torch.bfloat16), ("knn_xy", n_train, KNN_SRC, KNN_TGT, KNN_K)
    n_map, n_tl, n_agl = (getattr(pcfg.model, enc).n_layer_tf for enc in ("mp_encoder", "tl_encoder", "ag_encoder"))
    # B2 at the agent decoder's and posterior agent encoder's shape: the rollout, its recompute and the posterior
    n_x, n_x_bwd = 2 * n_agl * n_step + n_agl, n_agl * n_step + n_agl
    arms = {"b": (cfg, model, step, gen, {knn_train: 2 * n_step + 1}, {}),
            "f": (pcfg, tmodel, tstep, tgen,
                  {knn_train: 2 * n_step + 1, ("knarpe_attention", bf, *SCALED_TRAIN_ATTN_PATH): n_map,
                   ("knarpe_cross_attention", bf, *SCALED_TRAIN_X_PATH): n_x,
                   ("knarpe_cross_attention", bf, *SCALED_POST_TL_X_PATH): n_tl,
                   ("knarpe_attention_bwd", bf, *SCALED_TRAIN_ATTN_PATH): n_map,
                   ("knarpe_cross_attention_bwd", bf, *SCALED_TRAIN_X_PATH): n_x_bwd,
                   ("knarpe_cross_attention_bwd", bf, *SCALED_POST_TL_X_PATH): n_tl},
                  {"knarpe_attention/heads": n_map, "knarpe_attention_bwd/heads": n_map,
                   "knarpe_cross_attention/cluster": n_x + n_tl, "knarpe_cross_attention_bwd/heads": n_x_bwd + n_tl})}
    times, peaks, metrics, counts, routes, step_shapes = {}, {}, {}, {}, {}, {}
    for arm in "bf":
        acfg, amodel, astep, agen, want_shapes, want_routes = arms[arm]
        where = f"scaled training step use_pallas={acfg.model.tf_cfg.use_pallas}"
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        with recorded_launch_shapes() as shapes, recorded_bwd_launches(capture=arm == "f") as (bwd_shapes, first_bwd):
            m = astep(tbatch, agen)
        torch.cuda.synchronize()
        times.setdefault(arm, []).append(time.perf_counter() - t1)
        if arm == "f":
            for kernel in ("knarpe_attention", "knarpe_cross_attention"):
                first_errs[f"{kernel}_bwd"] = check_path_bwd_launch(f"(f) {where}", kernel, first_bwd.get(kernel, {}))
        del first_bwd
        peaks[arm] = max(peaks.get(arm, 0.0), peak_gib())
        metrics.setdefault(arm, []).append({key: float(v) for key, v in m.items()})
        step_shapes[arm] = shapes + bwd_shapes
        check_scaled_shapes(where, step_shapes[arm], want_shapes)
        counts[arm], routes[arm] = launches(), dict(knarpe.ROUTE_LAUNCHES)
        by_route = {key: want_routes.get(key, 0) for key in routes[arm]}
        if counts[arm] != expected_train_launches(acfg) or routes[arm] != by_route:
            raise AssertionError(f"{where}: launches {counts[arm]}, by route {routes[arm]}, expected "
                                 f"{expected_train_launches(acfg)}, by route {by_route}")
        # every parameter has a finite gradient, non-zero but for the action head's log_std: with deterministic
        # training actions the loss reads the action distribution's mean only (JAX's gradient there is 0 too)
        grads = {n: p.grad for n, p in amodel.named_parameters()}
        bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())]
        zero = [n for n, g in grads.items() if n not in bad and not bool(g.any())]
        unread = [n for n in zero if acfg.training_deterministic_action and n.startswith("action_head.log_std")]
        if bad or zero != unread:
            raise AssertionError(f"{where}: parameters without a finite gradient {bad[:8]}, with a zero one "
                                 f"{zero[:8]}")
        if not all(math.isfinite(mm["training/loss"]) and math.isfinite(mm["grad_norm"]) and mm["grad_norm"] > 0
                   for mm in metrics[arm]):
            raise AssertionError(f"{where}: metrics {metrics[arm]}")
    train_counts, train_pallas_counts = counts["b"], counts["f"]
    train_s, train_pallas_s = (float(np.median(times[arm])) for arm in "bf")
    for arm, what in (("b", "(b) scaled_config use_pallas=False"), ("f", "(f) scaled_config use_pallas=True")):
        log(f"  {what} training step, batch {n_train}: seconds per step "
            f"{[round(t, 4) for t in times[arm]]} (median {float(np.median(times[arm])):.4f} s; a first step), "
            f"{n_train / float(np.median(times[arm])):.4f} train samples/s, peak memory {peaks[arm]:.2f} GiB, losses "
            f"{[round(mm['training/loss'], 4) for mm in metrics[arm]]}, grad_norm "
            f"{[round(mm['grad_norm'], 4) for mm in metrics[arm]]}, all {len(grads)} parameters with a finite, "
            f"non-zero gradient but the {len(unread)} log_std the loss does not read; launches per step {counts[arm]}, "
            f"by route { {key: n for key, n in routes[arm].items() if n} }, by full shape {dict(step_shapes[arm])} "
            f"(each checked in phase 3) [{card}]")
    log(f"  (f) against (b), in turns b f: median {train_pallas_s:.4f} s against {train_s:.4f} s per step "
        f"({train_pallas_s - train_s:+.4f} s), peak memory {peaks['f']:.2f} against {peaks['b']:.2f} GiB")
    del tmodel, tstep, arms

    # (c) the validation step: one step, split by part, with no warm-up step ((a) ran the model at these shapes)
    vstep = eval_runner.make_validate_step(cfg, model)
    vbatch = train_lib.batch_to_device(batch, torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    split = {}
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        out = vstep(vbatch, gen, split=split)
    val_s = time.perf_counter() - t1
    val_counts, val_peak = launches(), peak_gib()
    check_scaled_shapes("scaled validation step", shapes, {knn_eval: n_step, ("knn_xy", n_sc, KNN_SRC, KNN_TGT, KNN_K):
                                                            n_step + 1})
    if val_counts != expected_validate_launches(cfg):
        raise AssertionError(f"scaled validation step: launches {val_counts}, expected "
                             f"{expected_validate_launches(cfg)}")
    n_fut = cfg.time_step_gt - cfg.time_step_current
    realism = {key: v.float().cpu() for key, v in out["wosac_realism"].items()}
    loss = {key: float(v) for key, v in out["loss_metrics"].items()}
    if not (tuple(out["womd_trajs"].shape) == (n_sc, n_ag, 6, n_fut // 5, 3)
            and tuple(out["wosac_trajs"].shape) == (n_sc, 32, n_ag, n_step - cfg.time_step_current, 3)
            and all(torch.isfinite(out[key]).all() for key in ("womd_trajs", "womd_scores", "wosac_trajs"))
            and all(bool(torch.isfinite(v).all()) for v in realism.values())
            and all(math.isfinite(v) for v in loss.values()) and float(out["err_sums"]["err_counter"]) > 0):
        raise AssertionError(f"scaled validation step: outputs out of shape or not finite: losses {loss}")
    log(f"  (c) scaled_config validation step, {n_sc} scenarios, K={k}, native realism: "
        f"split step {val_s:.4f} s (a first step): { {part: round(split.get(part, 0.0), 4) for part in eval_runner.SPLIT_PARTS} }, "
        f"{n_sc / val_s:.4f} scenarios/s, peak memory {val_peak:.2f} GiB; launches per step {val_counts} (B1 "
        f"{n_step} at {list(knn_eval[1:])}, {n_step + 1} at {[n_sc, *knn_eval[2:]]}); WOMD modes over the {n_fut} "
        f"logged future steps, WOSAC futures over all {n_step - cfg.time_step_current}, realism over the logged ones: "
        f"metametric {[round(v, 4) for v in realism['metametric'].tolist()]}, val loss "
        f"{loss['reactive_replay/loss']:.4f} [{card}]")

    del model, step, vstep
    torch.cuda.empty_cache()

    # (e) the TL pass past the log, card against CPU at reduced depth
    t0 = time.perf_counter()
    run_card_vs_cpu(13)
    log(f"  (e) phase-4 config at {SCALED_CHECK_END} steps against 31 logged, card vs CPU: "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"  phase 13 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return ({"eval": eval_counts, "train": train_counts, "validate": val_counts, "eval_use_pallas": pallas_counts,
             "train_use_pallas": train_pallas_counts}, first_errs,
            {"train_use_pallas": {"by_route": routes["f"], "by_shape": step_shapes["f"]}})


# phase 14, the serving entry point: bench.py's serve definition (reset, 3 warm-up steps, SERVE_STEPS timed steps
# with fetch=False and one synchronize at the end), the two arms in turns
SERVE_STEPS, SERVE_WARMUP, SERVE_FETCH_STEPS = 50, 3, 20
SERVE_SCRIPTED = (2.5, -0.1)  # (acc, yaw_rate) the scripted agent takes, inside the vehicle bounds


def serve_expected(cfg) -> tuple:
    """Kernel launches per `reset` and per `step` that the config implies: the map encoder's B4 at reset; the
    agent->map KNN and the agent decoder's B2 per step."""
    reset = expected_launches(cfg, 0)
    step = {**expected_launches(cfg, 1), "knarpe_attention": 0}
    return reset, step


def serve_shapes(cfg) -> tuple:
    """The launches by full shape per `reset` and per `step` (each shape one phase 3 checked)."""
    bf, pallas, m = str(torch.bfloat16), cfg.model.tf_cfg.use_pallas, cfg.model
    reset = {("knarpe_attention", bf, *SERVE_ATTN_PATH): m.mp_encoder.n_layer_tf} if pallas else {}
    step = {SERVE_KNN: 1, **({("knarpe_cross_attention", bf, *SERVE_X_PATH): m.ag_encoder.n_layer_tf}
                             if pallas else {})}
    return reset, step


def serve_turn(sim, batch, cfg, where: str) -> dict:
    """One turn of bench.py's serve measurement: reset, SERVE_WARMUP steps, SERVE_STEPS timed steps with
    fetch=False and one synchronize; the launches of the reset and of the timed steps asserted (all staged)."""
    want_reset, want_step = serve_expected(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    sim.reset(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    if launches() != want_reset:
        raise AssertionError(f"{where}: launches at reset {launches()}, expected {want_reset}")
    check_staged_route(f"{where} reset")
    for _ in range(SERVE_WARMUP):
        out = sim.step(fetch=False)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEPS):
        out = sim.step(fetch=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVE_STEPS
    want = {key: n * SERVE_STEPS for key, n in want_step.items()}
    if launches() != want:
        raise AssertionError(f"{where}: launches over {SERVE_STEPS} steps {launches()}, expected {want}")
    check_staged_route(f"{where} steps")
    if not all(isinstance(v, torch.Tensor) and v.device.type == sim.device.type for v in out.values()):
        raise AssertionError(f"{where}: fetch=False returned values off the simulator's device {sim.device}")
    return {"latency_ms": dt * 1e3, "steps_per_sec": 1.0 / dt, "reset_s": reset_s, "peak_gib": peak_gib()}


def check_serve_card_vs_cpu(use_pallas: bool) -> dict:
    """(c) The phase-4 config (float32) on the card and on the CPU, the same damped weights, the CPU's latent and
    destination draws handed to the card: 10 steps, the sixth scripting the first valid agent. Poses, motion and
    actions agree to SLICE_POSE_ATOL, validity and TL states exactly; on the card the kernels launch as the config
    implies. -> the max errors."""
    cfg = with_pallas(phase4_config(), use_pallas)
    batch = make_batch(cfg.data, n_sc=1, seed=3)
    runs, samples = {}, None
    for device in ("cpu", "cuda"):
        model = build_model(cfg, seed=1, device=device)
        damp_weights(model, 0.5)
        sim = InteractiveSimulator(cfg, model, device=device)
        reset_launches()
        obs = sim.reset(batch, torch.Generator().manual_seed(0))
        if samples is None:
            samples = {k: sim.static[k] for k in ("ag_latent", "ag_latent_valid", "ag_navi", "ag_navi_valid")}
        else:
            sim.static.update({k: None if v is None else v.to(device) for k, v in samples.items()})
        agent = int(np.argmax(obs["valid"][0]))
        act = {"valid": np.zeros(obs["valid"].shape, bool), "action": np.zeros(obs["valid"].shape + (2,), np.float32)}
        act["valid"][0, agent], act["action"][0, agent] = True, SERVE_SCRIPTED
        outs = [sim.step(actions=act if i == 5 else None) for i in range(10)]
        if device == "cuda":
            want_reset, want_step = serve_expected(cfg)
            want = {key: want_reset[key] + 10 * n for key, n in want_step.items()}
            if launches() != want:
                raise AssertionError(f"serve card vs CPU use_pallas={use_pallas}: launches {launches()}, "
                                     f"expected {want}")
        if not np.array_equal(outs[5]["action"][0, agent], np.float32(SERVE_SCRIPTED)):
            raise AssertionError(f"serve on {device}: the scripted agent took {outs[5]['action'][0, agent]}")
        runs[device] = outs
    pairs = list(zip(runs["cuda"], runs["cpu"]))
    errs = {key: max(float(np.abs(g[key] - c[key]).max()) for g, c in pairs) for key in ("pose", "motion", "action")}
    same = all(np.array_equal(g[key], c[key]) for g, c in pairs for key in ("valid", "tl_state"))
    if not (same and all(e <= SLICE_POSE_ATOL for e in errs.values())):
        raise AssertionError(f"serve card vs CPU use_pallas={use_pallas}: max errors {errs} (tolerance "
                             f"{SLICE_POSE_ATOL}), valid and TL states identical: {same}")
    log(f"  (c) use_pallas={use_pallas}: InteractiveSimulator card vs CPU, phase-4 config, 10 steps (step 6 scripts "
        f"agent {agent}): max |err| {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tolerance "
        f"{SLICE_POSE_ATOL}); valid and TL states identical; the scripted action taken on both")
    return errs


def run_serve_phase(card: str) -> tuple:
    """The serving entry point at `leaderboard_config()`, 1 scenario x 64 agents x 1024 polylines, random seed-0
    weights: (a) use_pallas=False and (b) use_pallas=True, timed in turns a b b a; launches per reset and per step by
    full shape; a scripted step; history(); (c) card against CPU. -> (the `serve` summary, launches per reset and
    per step of each arm, by kernel and by route)."""
    t_phase = time.perf_counter()
    arms, counts = {}, {}
    for arm, use_pallas in (("a", False), ("b", True)):
        cfg = with_pallas(leaderboard_config(), use_pallas)
        model = build_model(cfg, seed=0, device="cuda")
        batch = make_batch(cfg.data, n_sc=1, seed=0)
        sim = InteractiveSimulator(cfg, model)
        where = f"serve use_pallas={use_pallas}"
        # one reset and one step with every launch's full shape recorded (outside the timed turns)
        want_reset, want_step = serve_shapes(cfg)
        reset_launches()
        with recorded_launch_shapes() as shapes:
            sim.reset(batch, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        reset_counts, reset_routes, reset_shapes = launches(), dict(knarpe.ROUTE_LAUNCHES), dict(shapes)
        reset_launches()
        with recorded_launch_shapes() as shapes:
            sim.step(fetch=False)
        torch.cuda.synchronize()
        step_counts, step_routes, step_shapes = launches(), dict(knarpe.ROUTE_LAUNCHES), dict(shapes)
        if reset_shapes != want_reset or step_shapes != want_step:
            raise AssertionError(f"{where}: launches by full shape at reset {reset_shapes}, per step {step_shapes}, "
                                 f"expected {want_reset} and {want_step}")
        counts["plain" if arm == "a" else "use_pallas"] = {"reset": reset_counts, "step": step_counts,
                                                           "reset_routes": reset_routes, "step_routes": step_routes}
        arms[arm] = (cfg, sim, batch, where)
        log(f"  {where}: launches at reset {reset_counts}, per step {step_counts}; by full shape at reset "
            f"{reset_shapes}, per step {step_shapes} (each checked in phase 3); by route at reset "
            f"{ {k: n for k, n in reset_routes.items() if n} }, per step "
            f"{ {k: n for k, n in step_routes.items() if n} }")
    turns = {"a": [], "b": []}
    for arm in "abba":
        cfg, sim, batch, where = arms[arm]
        turns[arm].append(serve_turn(sim, batch, cfg, where))
    summary = {"config": "leaderboard_config()", "scenarios": 1, "agents": arms["a"][0].data.n_ag,
               "polylines": arms["a"][0].data.n_mp, "steps_timed": SERVE_STEPS, "warmup_steps": SERVE_WARMUP,
               "card": card}
    for arm, name in (("a", "plain"), ("b", "use_pallas")):
        cfg, sim, batch, where = arms[arm]
        lat = [t["latency_ms"] for t in turns[arm]]
        # fetch=True: one host sync per step (numpy out)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_FETCH_STEPS):
            out = sim.step()
        fetch_ms = (time.perf_counter() - t0) / SERVE_FETCH_STEPS * 1e3
        # the scripted step: the first valid agent takes SERVE_SCRIPTED, the others the policy
        agent = int(np.argmax(out["valid"][0]))
        act = {"valid": np.zeros(out["valid"].shape, bool), "action": np.zeros(out["valid"].shape + (2,), np.float32)}
        act["valid"][0, agent], act["action"][0, agent] = True, SERVE_SCRIPTED
        spd = out["motion"][0, agent, 0]
        scripted = sim.step(actions=act)
        if not (out["valid"][0, agent] and np.array_equal(scripted["action"][0, agent], np.float32(SERVE_SCRIPTED))
                and abs(scripted["motion"][0, agent, 0] - (spd + cfg.dynamics.dt * SERVE_SCRIPTED[0])) <= 1e-4):
            raise AssertionError(f"{where}: the scripted agent {agent} took {scripted['action'][0, agent]}, speed "
                                 f"{spd} -> {scripted['motion'][0, agent, 0]}")
        hist = sim.history()
        n_steps = SERVE_WARMUP + SERVE_STEPS + SERVE_FETCH_STEPS + 1
        n_ag, n_tl = cfg.data.n_ag, cfg.data.n_tl_lane
        want = {"valid": (1, n_ag, n_steps), "pose": (1, n_ag, n_steps, 3), "motion": (1, n_ag, n_steps, 3),
                "tl_state": (1, n_tl, n_steps, 5), "action": (1, n_ag, n_steps, 2)}
        got = {k: v.shape for k, v in hist.items()}
        if got != want or not np.isfinite(hist["pose"]).all():
            raise AssertionError(f"{where}: history shapes {got}, expected {want}, or non-finite poses")
        summary[name] = {"serve_policy_steps_per_sec": 1e3 / float(np.median(lat)),
                         "latency_ms": float(np.median(lat)), "latency_ms_per_turn": lat,
                         "steps_per_sec_per_turn": [t["steps_per_sec"] for t in turns[arm]],
                         "fetch_true_latency_ms": fetch_ms, "reset_s": [t["reset_s"] for t in turns[arm]],
                         "peak_memory_gib": max(t["peak_gib"] for t in turns[arm])}
        log(f"  ({arm}) {where}, leaderboard_config, 1 scenario x {n_ag} agents x {cfg.data.n_mp} polylines: "
            f"latency {[round(x, 4) for x in lat]} ms per step with fetch=False (median {np.median(lat):.4f} ms, "
            f"{1e3 / np.median(lat):.2f} serve_policy_steps_per_sec), fetch=True {fetch_ms:.4f} ms per step, reset "
            f"{[round(t['reset_s'], 4) for t in turns[arm]]} s, peak memory "
            f"{summary[name]['peak_memory_gib']:.3f} GiB; "
            f"scripted agent {agent} took {SERVE_SCRIPTED} exactly; history {got['pose']} finite [{card}]")
    del arms
    torch.cuda.empty_cache()
    summary["card_vs_cpu_max_abs_err"] = {("use_pallas" if p else "plain"): check_serve_card_vs_cpu(p)
                                          for p in (False, True)}
    log(f"  phase 14 {time.perf_counter() - t_phase:.1f} s [{card}]")
    return summary, counts

# phase 15, data parallel over processes (`parallel/mesh.py`), (a)'s processes under deterministic algorithms
# (`spawned`; (b)'s and (d)'s turn them off again): (a) `run.main` fit on one NCCL rank (a torchrun environment of world 1) against the same
# fit without a process group, side by side, the parameters bit for bit; (b) two ranks sharing the card over gloo
# with CUDA tensors, each `make_train_step` on one scenario of a union batch of 2 (float32, dropout 0, the union's
# draws), against this process on the union beside them: the loss to PARALLEL_LOSS_REL relative, the gradients the
# update applies to phase 7's TRAIN_GRAD_REL of their scale (summation order through the BPTT steps: 1.82e-4
# measured, the same with and without deterministic algorithms), and the parameters after the update to
# PARALLEL_PARAM_REL of their largest value against this process's optimizer fed each rank's own gradients. Not
# against the union's own update: AdamW's first step moves an element by ~lr * g / (|g| + 1e-8), so an element whose
# gradient lies within the summation order's noise of 0 steps by up to lr either way, as large as a zero-initialised
# bias's largest value after the step (logged as `union_param_gap`). The same two ranks validate one batch each:
# the same metrics on both. (d) The same two ranks under fsdp and tp (`SHARDED_ARMS`), from the same weights and
# draws, held as (b) is: the loss against (b)'s, the gathered gradients against (b)'s, the gathered parameters against
# this process's optimizer fed the strategy's own gathered gradients (the gap to (b)'s logged as `dp_param_gap`: tp's
# ranks each compute the union, as this process does, in another summation order than (b)'s sum of two halves).
# (c) (b) and (d) over NCCL on two cards, where there are two.
PARALLEL_LOSS_REL, PARALLEL_PARAM_REL = 1e-6, 1e-6
# (d)'s arms, (strategy, model axis) on the two ranks, and the leaves each shards at leaderboard_config(): the JAX
# package's fsdp_shard_params (min size 2**14, n_data 2) and tp_shard_params (n_model 2) shard 237 and 352 of its 720
SHARDED_ARMS = (("fsdp", 1), ("tp", 2))
SHARDED_LEAVES = {"fsdp": 237, "tp": 352}
# (d)'s run.main arm in the same ranks: a fit of one step under fsdp at parallel_cfg() cut to SHARDED_FIT_STEPS rollout
# steps (the arm checks the fit's wiring; the bare steps above hold the numbers at full depth), one scenario per rank,
# resumed under tp on a (1, 2) mesh for a second step
SHARDED_FIT_STEPS = 20
SHARDED_FIT = (("fsdp", ["parallel.strategy=fsdp", "max_steps=1"]),
               ("tp", ["parallel.strategy=tp", "parallel.model_axis=2", "max_steps=2", "resume=true"]))
PARALLEL_TIMEOUT_S = 300  # a rank that outlives this is killed and fails the phase
PARALLEL_THREADS = 2  # CPU threads of each spawned process: up to four run beside this one


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _join_ranks(procs, outs, what: str) -> list:
    """Join the spawned ranks (killing any past PARALLEL_TIMEOUT_S); -> their results. A rank that exits non-zero
    or leaves no result fails the phase."""
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 1.0))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    codes = [proc.exitcode for proc in procs]
    if any(code != 0 for code in codes) or not all(out.exists() for out in outs):
        raise AssertionError(f"{what}: rank exit codes {codes}")
    return [torch.load(out, weights_only=False) for out in outs]


def spawned(fn, *args) -> None:
    """fn(*args) in a process this phase spawns, set up with float32 matmuls and deterministic algorithms (cuBLAS's
    fixed workspace too; an op without a deterministic implementation warns, and `nondeterministic` lists the
    warnings), the process groups on the loopback interface and PARALLEL_THREADS CPU threads. Without them two identical bf16 fits on the card differ (717 of 720 parameter tensors after 2 steps):
    the backward's scatter-adds sum in no fixed order, and AdamW's first step turns a last-bit difference of a
    gradient near 0 into ~lr."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):  # every rank is on this host
        os.environ.setdefault(var, "lo")
    torch.set_num_threads(PARALLEL_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False  # a fill per allocation; determinism needs none
    fn(*args)


def nondeterministic(caught) -> list:
    return sorted({str(w.message)[:200] for w in caught if "deterministic" in str(w.message)})


def fit_process(args: list, out: str, one_rank: bool) -> None:
    """(a)'s process: `run.main(args)`, in a torchrun environment of one rank on NCCL where one_rank; writes its
    parameters, backend and the ops warned as nondeterministic to out."""
    import warnings

    import torch.distributed as dist

    if one_rank:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                          MASTER_PORT=str(free_port()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model, _, _ = run_lib.main(args)
    result = {"params": checkpoint_lib.to_host(dict(model.named_parameters())),
              "backend": dist.get_backend() if dist.is_initialized() else None,
              "world": dist.get_world_size() if dist.is_initialized() else None, "warnings": nondeterministic(caught)}
    torch.save(result, out)
    if dist.is_initialized():
        dist.destroy_process_group()


def check_one_rank_fit(card: str, tmp, meanwhile) -> tuple:
    """(a) run.main fit at leaderboard_config() with use_pallas=True, batch 2, 1 step from a tbcache, in two
    processes side by side, one on one NCCL rank, one without a process group: the same parameters bit for bit.
    meanwhile() runs while they do. -> ((a)'s summary, what meanwhile returned)."""
    import multiprocessing as mp

    cfg = leaderboard_config()
    data_dir = tmp / "dp_a_data"
    data_dir.mkdir()
    write_tbcache_split(data_dir / "training.tbcache", cfg, 4, seed=0)
    write_tbcache_split(data_dir / "validation.tbcache", cfg, 2, seed=1)
    common = ["action=fit", "data=tbcache", f"data_dir={data_dir}", "model.tf_cfg.use_pallas=true", "max_steps=1",
              "validate_every_epoch=false", "log_every=1"]
    t0 = time.perf_counter()
    outs = [tmp / "dp_a_plain.pt", tmp / "dp_a_nccl.pt"]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=spawned, args=(fit_process, common + [f"ckpt_dir={tmp / out.stem}"], str(out),
                                               one_rank)) for out, one_rank in zip(outs, (False, True))]
    for proc in procs:
        proc.start()
    try:
        other = meanwhile()
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.join()
        raise
    plain, rank = _join_ranks(procs, outs, "(a) the fits")
    diff = [n for n, v in plain["params"].items() if not torch.equal(rank["params"][n], v)]
    if (plain["backend"], rank["backend"], rank["world"]) != (None, "nccl", 1) or diff \
            or set(rank["params"]) != set(plain["params"]):
        raise AssertionError(f"(a): backends {plain['backend']} / {rank['backend']}, world {rank['world']}; "
                             f"parameters that differ: {diff[:10]} ({len(diff)} of {len(plain['params'])}); ops "
                             f"warned as nondeterministic: {plain['warnings']}")
    t_a = time.perf_counter() - t0
    log(f"  (a) run.main fit, leaderboard_config use_pallas=True, batch 2, 1 step, deterministic algorithms: on one "
        f"NCCL rank (world 1) and without a process group, side by side (and (b) beside them), {t_a:.1f} s: all "
        f"{len(plain['params'])} parameter tensors equal bit for bit; ops warned as nondeterministic "
        f"{plain['warnings']} [{card}]")
    return {"seconds": t_a, "params_bit_equal": True, "tensors": len(plain["params"]),
            "nondeterministic_ops": plain["warnings"]}, other


def parallel_cfg():
    """(b)'s config: leaderboard_config() in float32 with dropout 0 and the kernels on."""
    return with_pallas(no_dropout(dataclasses.replace(leaderboard_config(), precision="fp32")), True)


def parallel_model(cfg, device):
    """The seed-0 weights damped to gain 0.5, and its optimizer and schedule."""
    model = build_model(cfg, seed=0, device=device)
    damp_weights(model, 0.5)
    return (model, *make_optimizer(cfg.optimizer, model.named_parameters()))


def parallel_process(rank: int, world: int, backend: str | None, device: str, store: str, batch, noise,
                     out: str) -> None:
    """(b)/(c)'s process: one train step on rank's share of the union batch and of the union's draws (with backend
    None, one process on the whole union); then, in a group, validate of one batch of its shard, and (d). Writes
    metrics, gradients, parameters, launches, seconds, peak memory and validation metrics to out."""
    import torch.distributed as dist

    # (b) and (d) hold no two processes bit for bit (the ranks' sums are all-reduced, each against this process's own
    # replay): the card's own summation order, ~1/3 off each step's time, and (b) the dp baseline of (d)'s arms
    torch.use_deterministic_algorithms(False)
    device = torch.device(device)
    torch.cuda.set_device(device)
    if backend is not None:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    cfg = parallel_cfg()
    model, opt, schedule = parallel_model(cfg, device)
    step = train_lib.make_train_step(cfg, model, opt, schedule, device=device)
    n = next(iter(batch.values())).shape[0] // world
    mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    shard = {k: v.to(device) if isinstance(v, torch.Tensor) else v
             for k, v in train_lib.shard_noise(noise, rank, world).items()}
    reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    with recorded_launch_shapes() as shapes:
        t0 = time.perf_counter()
        metrics = step(mine, noise=shard)
        torch.cuda.synchronize(device)
        t_step = time.perf_counter() - t0
    counts, routes = launches(), {k: v for k, v in knarpe.ROUTE_LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(device)
    if backend is not None:
        print(f"  rank {rank} of {world} ({backend}, {device}): launches {counts}, by route {routes}", flush=True)
    result = {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": counts, "routes": routes,
              "shapes": dict(shapes), "step_s": t_step, "peak_bytes": peak,
              "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
              "params": checkpoint_lib.to_host(dict(model.named_parameters()))}
    if backend is not None:
        loader = run_lib.SynthLoader(cfg, 1, 1, 10_000, shard_index=rank, num_shards=world)
        t0 = time.perf_counter()
        result["validate"] = eval_runner.validate(cfg, model, loader, max_batches=1, device=device,
                                                  logger=MetricsLogger(None, echo=False))
        result["validate_s"] = time.perf_counter() - t0
        del model, opt, schedule, step
        result["sharded"] = {strategy: sharded_step(cfg, strategy, n_model, batch, noise, device)
                             for strategy, n_model in SHARDED_ARMS}
        result["sharded_fit_dir"] = str(Path(out).parent / f"sharded_fit_{backend}")
        result["sharded_fit"] = sharded_fit(result["sharded_fit_dir"], device)
    torch.save(result, out)
    if backend is not None:
        dist.destroy_process_group()


def sharded_step(cfg, strategy: str, n_model: int, batch, noise, device) -> dict:
    """(d) in one rank: the mesh of `strategy` with n_model ranks in its model dim, parallel_model's weights placed by
    the strategy, one train step on this rank's data index's share of the union batch and draws -> its metrics,
    launches, shapes, seconds and peak memory, the gathered gradients it applied and the gathered parameters after it,
    the number of sharded leaves."""
    scfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, strategy=strategy, model_axis=n_model))
    with mesh_lib.make_mesh(n_model=n_model) as mesh:
        model = build_model(scfg, seed=0, device=device)
        damp_weights(model, 0.5)
        sharded = mesh_lib.ShardedParams(model, mesh_lib.strategy_placements(scfg.parallel, model, mesh), mesh)
        opt, schedule = make_optimizer(scfg.optimizer, sharded.named_parameters())
        step = train_lib.make_train_step(scfg, model, opt, schedule, device=device, sharded=sharded)
        d, n = mesh_lib.data_index(mesh), mesh_lib.data_count(mesh)
        rows = next(iter(batch.values())).shape[0] // n
        mine = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        shard = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in train_lib.shard_noise(noise, d, n).items()}
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        with recorded_launch_shapes() as shapes:
            t0 = time.perf_counter()
            metrics = step(mine, noise=shard)
            torch.cuda.synchronize(device)
            t_step = time.perf_counter() - t0
        counts, peak = launches(), torch.cuda.max_memory_allocated(device)
        grads = sharded.full({k: t.grad for k, t in sharded.named_parameters()})
        sharded.gather()
        return {"metrics": {k: float(v) for k, v in metrics.items()}, "launches": counts, "shapes": dict(shapes),
                "step_s": t_step, "peak_bytes": peak, "mesh": tuple(mesh.mesh.shape),
                "sharded_leaves": len(sharded.axes), "grads": {k: g.detach().cpu() for k, g in grads.items()},
                "params": checkpoint_lib.to_host(dict(model.named_parameters()))}


def sharded_fit_cfg():
    return horizon(parallel_cfg(), SHARDED_FIT_STEPS)


def sharded_fit(ckpt_dir: Path, device) -> dict:
    """(d)'s run.main arm in one rank (SHARDED_FIT): `run.main` fit at sharded_fit_cfg() on synthetic scenes, one per
    rank, for one step under fsdp, then its checkpoint resumed under tp for a second -> for each: seconds and peak
    memory of the call, the launches, whether a signal stopped it, the rank count after it, the parameters after
    it."""
    base = ["action=fit", "preset=leaderboard", f"device={device}", f"ckpt_dir={ckpt_dir}", "batch_size_train=1",
            "validate_every_epoch=false", "log_every=1", *config_overrides(leaderboard_config(), sharded_fit_cfg())]
    out = {}
    for strategy, args in SHARDED_FIT:
        reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        model, _, stopped = run_lib.main(base + args)
        torch.cuda.synchronize(device)
        out[strategy] = {"seconds": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated(device),
                         "launches": launches(), "stopped": stopped, "ranks_after": mesh_lib.process_count(),
                         "params": checkpoint_lib.to_host(dict(model.named_parameters()))}
        del model
    return out


def replayed_update(cfg, grads: dict, replay, start: dict) -> dict:
    """parallel_model's weights (`replay` loaded with `start`) after a fresh optimizer's first update from `grads`, on
    the card."""
    replay.load_state_dict(start)
    replay_opt = make_optimizer(cfg.optimizer, replay.named_parameters())[0]
    for n, p in replay.named_parameters():
        p.grad = grads[n].cuda()
    replay_opt.step()
    return checkpoint_lib.to_host(dict(replay.named_parameters()))


def _max_rel(got: dict, want: dict, floor: float = 1e-30) -> float:
    """The largest |got - want| of a tensor over max(its largest |want|, floor), over every tensor of want."""
    return max(float((got[n] - w).abs().max()) / max(float(w.abs().max()), floor) for n, w in want.items())


def gib(n_bytes) -> float:
    return n_bytes / 2 ** 30


def check_sharded_arms(card: str, backend: str, ranks: list, union: dict, want_counts: dict, want_shapes,
                       floor: float, replay) -> dict:
    """(d): each strategy's step on both ranks against (b)'s (see SHARDED_ARMS). The ranks of tp's model group compute
    the same rows in the card's own order: their losses agree to PARALLEL_LOSS_REL, their parameters bit for bit (one
    rank's gradients of what the model dim does not split are taken on both, `ShardedParams.scatter_grads`). Then
    the run.main arm (`check_sharded_fit`)."""
    cfg = parallel_cfg()
    b0 = ranks[0]
    out = {}
    for strategy, n_model in SHARDED_ARMS:
        arms = [res["sharded"][strategy] for res in ranks]
        shapes = want_shapes if n_model == 1 else collections.Counter(union["shapes"])
        checks = {}
        for r, arm in enumerate(arms):
            if arm["launches"] != want_counts or collections.Counter(arm["shapes"]) != shapes \
                    or arm["sharded_leaves"] != SHARDED_LEAVES[strategy]:
                raise AssertionError(f"(d) {strategy} rank {r}: launches {arm['launches']} (expected {want_counts}), "
                                     f"shapes {arm['shapes']} (expected {dict(shapes)}), sharded leaves "
                                     f"{arm['sharded_leaves']} (expected {SHARDED_LEAVES[strategy]})")
            checks[r] = dict(
                loss_rel=abs(arm["metrics"]["training/loss"] - b0["metrics"]["training/loss"])
                / abs(b0["metrics"]["training/loss"]),
                grad_rel=_max_rel(arm["grads"], b0["grads"], floor),
                param_rel=_max_rel(arm["params"], replayed_update(cfg, arm["grads"], *replay)),
                dp_param_gap=_max_rel(arm["params"], b0["params"]))
            if not (checks[r]["loss_rel"] <= PARALLEL_LOSS_REL and checks[r]["grad_rel"] <= TRAIN_GRAD_REL
                    and checks[r]["param_rel"] <= PARALLEL_PARAM_REL):
                raise AssertionError(f"(d) {strategy} rank {r} over {backend}: {checks[r]} (tolerances: loss "
                                     f"{PARALLEL_LOSS_REL}, gradients {TRAIN_GRAD_REL}, parameters "
                                     f"{PARALLEL_PARAM_REL})")
        a0, a1 = arms
        loss_gap = abs(a0["metrics"]["training/loss"] - a1["metrics"]["training/loss"]) / \
            abs(a0["metrics"]["training/loss"])
        if loss_gap > PARALLEL_LOSS_REL or not all(torch.equal(a0["params"][n], a1["params"][n]) for n in a0["params"]):
            raise AssertionError(f"(d) {strategy}: the two ranks' losses ({loss_gap} relative apart) or parameters "
                                 "differ")
        log(f"  (d) {strategy} on a {a0['mesh']} mesh over {backend}: loss {a0['metrics']['training/loss']:.7f} vs "
            f"(b)'s {b0['metrics']['training/loss']:.7f}; per rank {checks}; {a0['sharded_leaves']} leaves sharded; "
            f"launches per rank {a0['launches']} (b)'s, shapes {'(b)' if n_model == 1 else 'the union'}'s; steps "
            f"{[round(a['step_s'], 3) for a in arms]} s against (b)'s dp {[round(res['step_s'], 3) for res in ranks]} s "
            f"(each rank's first step), peak memory per rank {[round(gib(a['peak_bytes']), 4) for a in arms]} GiB "
            f"against (b)'s {[round(gib(res['peak_bytes']), 4) for res in ranks]} GiB [{card}]")
        out[strategy] = {"mesh": a0["mesh"], "checks": checks, "sharded_leaves": a0["sharded_leaves"],
                         "launches_per_rank": a0["launches"], "step_seconds": [a["step_s"] for a in arms],
                         "peak_gib": [gib(a["peak_bytes"]) for a in arms]}
    out["run_main"] = check_sharded_fit(card, backend, ranks)
    return out


def check_sharded_fit(card: str, backend: str, ranks: list) -> dict:
    """(d)'s run.main arm (SHARDED_FIT) on both ranks: each call one step's launches, no stop, both ranks' parameters
    equal and finite, the collectives over both ranks again after each call; "last" at step 2 with finite losses
    logged at steps 1 and 2."""
    want_counts = expected_train_launches(sharded_fit_cfg())
    fits = [res["sharded_fit"] for res in ranks]
    ckpt_dir = Path(ranks[0]["sharded_fit_dir"])
    out = {}
    for strategy, _ in SHARDED_FIT:
        arms = [fit[strategy] for fit in fits]
        p0, p1 = arms[0]["params"], arms[1]["params"]
        if any(a["launches"] != want_counts or a["stopped"] or a["ranks_after"] != 2 for a in arms) \
                or not all(torch.equal(p0[n], p1[n]) and torch.isfinite(p0[n]).all() for n in p0):
            raise AssertionError(f"(d) run.main {strategy}: launches {[a['launches'] for a in arms]} (one step: "
                                 f"{want_counts}), stopped {[a['stopped'] for a in arms]}, ranks after "
                                 f"{[a['ranks_after'] for a in arms]}, or the ranks' parameters differ or are not "
                                 "finite")
        out[strategy] = {"seconds": [a["seconds"] for a in arms], "peak_gib": [gib(a["peak_bytes"]) for a in arms]}
    logged = [json.loads(line) for line in (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    losses = {m["step"]: m["training/loss"] for m in logged if "training/loss" in m}
    last_step = json.loads((ckpt_dir / "last.json").read_text())["meta"]["step"]
    if sorted(losses) != [1, 2] or not all(math.isfinite(v) for v in losses.values()) or last_step != 2:
        raise AssertionError(f"(d) run.main: logged losses {losses}, last at step {last_step} (expected steps 1, 2)")
    log(f"  (d) run.main fit at parallel_cfg() cut to {SHARDED_FIT_STEPS} rollout steps, one synthetic scenario per "
        f"rank, over {backend}: 1 step under fsdp on "
        f"a (2, 1) mesh, its checkpoint resumed under tp on a (1, 2) mesh for step 2; losses {losses}; each call one "
        f"step's launches per rank, the ranks' parameters equal; seconds per call and rank "
        f"{ {k: [round(t, 2) for t in v['seconds']] for k, v in out.items()} }, peak memory "
        f"{ {k: [round(g, 4) for g in v['peak_gib']] for k, v in out.items()} } GiB [{card}]")
    out["losses"] = losses
    return out


def check_two_ranks(card: str, tmp, backend: str, devices: list) -> dict:
    """(b) / (c): two spawned ranks against one process on the union batch of 2, this one, beside them (see
    PARALLEL_LOSS_REL)."""
    import multiprocessing as mp

    cfg = parallel_cfg()
    batch = make_batch(cfg.data, n_sc=2, seed=3)
    noise = train_lib.draw_training_noise(cfg, batch, torch.Generator().manual_seed(0), "cpu")
    t0 = time.perf_counter()
    store = tmp / f"dp_{backend}_store"
    outs = [tmp / f"dp_{backend}_rank{r}.pt" for r in range(2)] + [tmp / f"dp_{backend}_union.pt"]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=spawned, args=(parallel_process, r, 2, backend, devices[r], str(store), batch, noise,
                                               str(outs[r]))) for r in range(2)]
    for proc in procs:
        proc.start()
    parallel_process(0, 1, None, devices[0], "", batch, noise, str(outs[2]))
    union = torch.load(outs[2], weights_only=False)
    ranks = _join_ranks(procs, outs[:2], f"two ranks over {backend}")
    t_ranks = time.perf_counter() - t0

    want_counts = expected_train_launches(cfg)
    # a rank's launches are the union step's, each at half its scenarios
    want_shapes = collections.Counter({(key[0], key[1] // 2, *key[2:]) if key[0] == "knn_xy"
                                       else (*key[:2], key[2] // 2, *key[3:]): n for key, n in union["shapes"].items()})
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in union["grads"].values())
    replay = parallel_model(cfg, "cuda")[0]
    replay = (replay, checkpoint_lib.to_host(replay.state_dict()))
    checks = {}
    for r, res in enumerate(ranks):
        if res["launches"] != want_counts or union["launches"] != want_counts \
                or collections.Counter(res["shapes"]) != want_shapes:
            raise AssertionError(f"rank {r}: launches {res['launches']} (union {union['launches']}, expected "
                                 f"{want_counts}), shapes {res['shapes']} (expected {dict(want_shapes)})")
        loss_rel = abs(res["metrics"]["training/loss"] - union["metrics"]["training/loss"]) / \
            abs(union["metrics"]["training/loss"])
        norm_rel = abs(res["metrics"]["grad_norm"] - union["metrics"]["grad_norm"]) / union["metrics"]["grad_norm"]
        grad_rel = _max_rel(res["grads"], union["grads"], floor)
        union_gap = _max_rel(res["params"], union["params"])
        param_rel = _max_rel(res["params"], replayed_update(cfg, res["grads"], *replay))  # its own update
        checks[r] = dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, grad_rel=grad_rel, param_rel=param_rel,
                         union_param_gap=union_gap)
        if not (loss_rel <= PARALLEL_LOSS_REL and grad_rel <= TRAIN_GRAD_REL and param_rel <= PARALLEL_PARAM_REL):
            raise AssertionError(f"rank {r} over {backend}: {checks[r]} (tolerances: loss {PARALLEL_LOSS_REL}, "
                                 f"gradients {TRAIN_GRAD_REL}, parameters {PARALLEL_PARAM_REL})")
    sharded = check_sharded_arms(card, backend, ranks, union, want_counts, want_shapes, floor, replay)
    r0, r1 = ranks
    same_params = all(torch.equal(r0["params"][n], r1["params"][n]) for n in r0["params"])
    if r0["metrics"] != r1["metrics"] or not same_params:
        raise AssertionError(f"the two ranks differ: metrics {r0['metrics']} vs {r1['metrics']}, parameters equal "
                             f"{same_params}")
    if r0["validate"] != r1["validate"] or not all(math.isfinite(v) for v in r0["validate"].values()):
        diff = {k: (v, r1["validate"].get(k)) for k, v in r0["validate"].items() if r1["validate"].get(k) != v}
        raise AssertionError(f"validate over {backend}: the ranks' metrics differ or are not finite: {diff}")
    log(f"  ({'b' if backend == 'gloo' else 'c'}) two ranks over {backend} on {devices}, one scenario each, "
        f"float32, against one process on the union of 2 beside them: loss "
        f"{r0['metrics']['training/loss']:.7f} vs {union['metrics']['training/loss']:.7f}; per rank {checks}; the "
        f"ranks' metrics and parameters identical; launches per rank {r0['launches']} by route {r0['routes']}, "
        f"shapes the union step's at half its scenarios; steps {[round(res['step_s'], 3) for res in ranks]} s "
        f"(union {union['step_s']:.3f} s); validate of one batch per rank "
        f"{[round(res['validate_s'], 3) for res in ranks]} s, {len(r0['validate'])} metrics identical on both "
        f"(val/loss {r0['validate']['val/loss']:.6f}); peak memory per rank "
        f"{[round(gib(res['peak_bytes']), 4) for res in ranks]} GiB; {t_ranks:.1f} s in all [{card}]")
    return {"backend": backend, "devices": devices, "seconds": t_ranks, "checks": checks, "sharded": sharded,
            "launches_per_rank": r0["launches"], "routes_per_rank": r0["routes"],
            "validate_metrics_identical": len(r0["validate"]), "step_seconds": [res["step_s"] for res in ranks],
            "peak_gib": [gib(res["peak_bytes"]) for res in ranks]}


def run_parallel_phase(card: str) -> dict:
    """Phase 15: (a)-(d); -> the `parallel` object of the kernels line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as name:
        tmp = Path(name)
        out = dict(zip(("one_rank_nccl", "two_ranks_gloo_one_card"), check_one_rank_fit(
            card, tmp, lambda: check_two_ranks(card, tmp, "gloo", ["cuda:0", "cuda:0"]))))
        if torch.cuda.device_count() >= 2:
            out["two_ranks_nccl_two_cards"] = check_two_ranks(card, tmp, "nccl", ["cuda:0", "cuda:1"])
        else:
            out["two_ranks_nccl_two_cards"] = "not run: 1 card"
            log("  (c) (b) and (d) over NCCL on two cards: not run: 1 card")
    out["seconds"] = time.perf_counter() - t0
    out["card"] = card
    log(f"  phase 15 {out['seconds']:.1f} s [{card}]")
    return out


def rnn_full_shapes(cfg, n_sc: int, rows: int, train: bool) -> tuple:
    """The launches a `leaderboard_config()`-width RNN-family call (train=False: joint_future_pred over `rows`
    rollouts of n_sc scenarios) or training step (train=True: rows = n_sc) implies, by full shape:
    ({(kernel, dtype, n_b, n_s, K, D, R, H) or ("knn_xy", rows, sources, targets, k): n} forward and backward,
    {kernel/route: n}), every bf16 launch on the staged route. Per rollout step the agent->map KNN, B2 per
    tf_ag2mp (K=64) and tf_ag2tl (K=25) layer, and in training again in the step's recompute; B4 per map layer;
    in training the flattened posterior over the down-sampled track adds one KNN and B2 per layer at [n_sc, n_ag x
    steps, K=64] and [n_sc x steps, n_ag, K=25]; each forward outside a recompute has one backward."""
    m, n, bf = cfg.model, cfg.time_step_end, str(torch.bfloat16)
    n_ag, n_mp, d, h, lay = cfg.data.n_ag, cfg.data.n_mp, m.hidden_dim, m.tf_cfg.n_head, m.ag_encoder.n_layer_tf
    k_mp, k_tl = int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2mp), int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2tl)
    _b2_blocks(cfg)  # the agent self-attention dense
    rep = 2 if train else 1
    x = lambda kernel, b, s_, k: (kernel, bf, b, s_, k, d, d, h)  # noqa: E731
    want = collections.Counter({("knn_xy", rows, n_ag, n_mp, k_mp): rep * n,
                                x("knarpe_cross_attention", rows, n_ag, k_mp): rep * lay * n,
                                x("knarpe_cross_attention", rows, n_ag, k_tl): rep * lay * n,
                                x("knarpe_attention", n_sc, n_mp, m.n_tgt_knn): m.mp_encoder.n_layer_tf})
    if train:
        n_ds = len(range(0, cfg.time_step_gt + 1, m.latent_encoder.temporal_down_sample_rate))
        post = [("knarpe_cross_attention", n_sc, n_ag * n_ds, k_mp), ("knarpe_cross_attention", n_sc * n_ds, n_ag,
                                                                        k_tl)]
        want[("knn_xy", n_sc, n_ag * n_ds, n_mp, k_mp)] += 1
        for kernel, b, s_, k in post:
            want[x(kernel, b, s_, k)] += lay
        for kernel, b, s_, k in [("knarpe_cross_attention", rows, n_ag, k_mp), ("knarpe_cross_attention", rows, n_ag,
                                                                                k_tl)]:
            want[x(kernel + "_bwd", b, s_, k)] += lay * n
        for kernel, b, s_, k in post:
            want[x(kernel + "_bwd", b, s_, k)] += lay
        want[x("knarpe_attention_bwd", n_sc, n_mp, m.n_tgt_knn)] += m.mp_encoder.n_layer_tf
    routes = collections.Counter()
    for key, v in want.items():
        if key[0] != "knn_xy":
            routes[f"{key[0]}/staged"] += v
    return dict(want), dict(routes)


def check_rnn_shapes(where: str, shapes, want: dict) -> None:
    """A phase 16 call's or step's launches by full shape are exactly `want`, each at a shape phase 3 checked: B1
    against its plain version, bf16 B4 and B2 on the staged route against theirs, and their backwards against
    autograd of theirs."""
    bf = str(torch.bfloat16)
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    for kernel, shapes_ in (("knarpe_attention", (ATTN_PATH, TRAIN_ATTN_PATH)),
                            ("knarpe_attention_bwd", (TRAIN_ATTN_PATH,)),
                            ("knarpe_cross_attention", RNN_X + RNN_TRAIN_X),
                            ("knarpe_cross_attention_bwd", RNN_TRAIN_X)):
        checked |= {(kernel, bf, *s_) for s_ in shapes_}
    check_full_shapes(where, shapes, want, checked)


def run_rnn_phase(card: str) -> dict:
    """Phase 16, the TrafficBots RNN family (temp_window_size=-1) at the flagship's widths: (a) joint_future_pred,
    4 scenarios x K=32, level 1, use_pallas=True: one call, checked and timed; (b) the phase-4 config card vs CPU
    in float32, joint_future_pred and one training step, use_pallas False and True; (c) one training step at batch 8,
    use_pallas=True (a first step). Launches of (a) and (c) by full shape and route, each at a shape phase 3
    checked. -> {"eval": launches per (a) call, "train": per (c) step, by kernel;
    seconds, peak memory}."""
    t0 = time.perf_counter()
    cfg = rnn_mode(with_pallas(leaderboard_config(), True))
    n_sc, k = 4, cfg.n_joint_future_wosac
    n_ag, n_step = cfg.data.n_ag, cfg.time_step_end
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(0)
    want, want_routes = rnn_full_shapes(cfg, n_sc, n_sc * k, train=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    check_rnn_shapes("(a) RNN eval call", shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes:
        raise AssertionError(f"(a) RNN eval call: launches by route {routes}, expected {want_routes}")
    eval_counts = launches()
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not (torch.isfinite(buf.pred_pose).all()
                                                                         and torch.isfinite(buf.log_prob).all()):
        raise AssertionError(f"(a) RNN eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    if not buf.tl_state_nll_invalid[..., cfg.n_step_hist - 1:].all():
        raise AssertionError("(a) RNN eval call: the TL-state NLL not masked past the 11 logged steps")
    agent_steps = n_sc * k * n_ag * (n_step - cfg.time_step_current)
    out = {"eval_seconds": sec, "eval_peak_gib": peak_gib(), "eval_agent_steps_per_s": agent_steps / sec,
           "eval": eval_counts}
    log(f"  (a) leaderboard_config temp_window_size=-1 use_pallas=True check_level=1 joint_future_pred: {n_sc} "
        f"scenarios x K={k}, {n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps, {n_params} parameters, bf16: "
        f"one call, checked and timed (a first call) {sec:.4f} s, {agent_steps / sec:.1f} agent-steps/s, peak memory "
        f"{out['eval_peak_gib']:.2f} GiB; launches {eval_counts} by full shape {dict(shapes)}, by route {routes}, "
        f"every shape checked in phase 3; poses {list(buf.pred_pose.shape)} finite, TL free and its NLL masked past "
        f"the history [{card}]")
    del buf, model
    torch.cuda.empty_cache()

    run_card_vs_cpu(16)
    log(f"  (b) the phase-4 config in the RNN family card vs CPU in float32 (above), {time.perf_counter() - t0:.1f} s "
        f"into the phase")

    n_train = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    want, want_routes = rnn_full_shapes(cfg, n_train, n_train, train=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes, recorded_bwd_launches() as (bwd_shapes, _):
        metrics = {key: float(v) for key, v in step(tbatch, torch.Generator().manual_seed(0)).items()}
    torch.cuda.synchronize()
    train_sec = time.perf_counter() - t1
    check_rnn_shapes("(c) RNN training step", shapes + bwd_shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes:
        raise AssertionError(f"(c) RNN training step: launches by route {routes}, expected {want_routes}")
    loss, gnorm = metrics["training/loss"], metrics["grad_norm"]
    if not (math.isfinite(loss) and loss != 0 and math.isfinite(gnorm) and gnorm > 0):
        raise AssertionError(f"(c) RNN training step: loss {loss}, grad_norm {gnorm}")
    out.update(train_seconds=train_sec, train_peak_gib=peak_gib(), train=launches(),
               train_samples_per_s=n_train / train_sec, seconds=time.perf_counter() - t0, card=card)
    log(f"  (c) leaderboard_config temp_window_size=-1 use_pallas=True training step: {n_train} scenarios, a first "
        f"step {train_sec:.4f} s ({n_train / train_sec:.3f} train samples/s), peak memory {out['train_peak_gib']:.2f} "
        f"GiB, loss {loss:.6f}, grad_norm {gnorm:.6f}; launches {out['train']} by full shape "
        f"{dict(shapes + bwd_shapes)}, by route {routes}, every shape checked in phase 3 [{card}]")
    log(f"  phase 16 {out['seconds']:.1f} s [{card}]")
    return out


def navi_full_shapes(cfg, n_sc: int, rows: int) -> tuple:
    """The launches a `leaderboard_config()`-width joint_future_pred call over `rows` rollouts of n_sc scenarios
    implies in goal mode with re-prediction and use_pallas, by full shape: ({(kernel, dtype, n_b, n_s, K, D, R, H) or
    ("knn_xy", rows, sources, targets, k): n}, {kernel/route: n}), every bf16 launch on the staged route. Per rollout
    step the agent->map KNN, the agent decoder's B2 per layer over the map and TL targets (K=89) and the navi
    predictor's B2 per tf_ag2mp layer (K=32); the navi predictor once more before the futures replicate, and B4 per
    map layer. The navi predictor's own KNN is the stable sort, as JAX's (no B1)."""
    m, n, bf = cfg.model, cfg.time_step_end, str(torch.bfloat16)
    n_ag, n_mp, d, h = cfg.data.n_ag, cfg.data.n_mp, m.hidden_dim, m.tf_cfg.n_head
    k_mp = int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2mp)
    k_dec = k_mp + int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2tl)
    k_navi, lay_navi = int(m.n_tgt_knn * m.navi_predictor.k_tgt_knn), m.navi_predictor.n_layer_tf
    x = lambda kernel, b, s_, k: (kernel, bf, b, s_, k, d, d, h)  # noqa: E731
    want = {("knn_xy", rows, n_ag, n_mp, k_mp): n,
            x("knarpe_cross_attention", rows, n_ag, k_dec): m.ag_encoder.n_layer_tf * n,
            x("knarpe_cross_attention", n_sc, n_ag, k_navi): lay_navi,
            x("knarpe_cross_attention", rows, n_ag, k_navi): lay_navi * n,
            x("knarpe_attention", n_sc, n_mp, m.n_tgt_knn): m.mp_encoder.n_layer_tf}
    routes = collections.Counter()
    for key, v in want.items():
        if key[0] != "knn_xy":
            routes[f"{key[0]}/staged"] += v
    return want, dict(routes)


def run_navi_phase(card: str) -> dict:
    """Phase 17, the navigation family: (a) the phase-4 config card vs CPU in float32 with use_pallas, joint_future_pred's
    K0 futures (goal and cmd, goal and dest with re-prediction) and one training step (cmd, goal and dest with
    re-prediction, dest at a second batch seed against the CPU's float64); (b) `leaderboard_config()` with
    navi_mode="goal", pred_navi_after_reached and use_pallas, joint_future_pred 4 scenarios x K=32 at level 1: one
    call, checked and timed, its launches by full shape and route, each at a shape phase 3 checked. The full-width
    training step in this mode is not run: the run's length has a budget (phase 3 checks and times B2 and B2-bwd at
    its [8·64, K=32]). -> {"eval": launches per (b) call by kernel; seconds, peak memory, re-predictions}."""
    t0 = time.perf_counter()
    run_card_vs_cpu(17)
    t_a = time.perf_counter() - t0
    log(f"  (a) the phase-4 config in the navigation modes card vs CPU in float32 (above), {t_a:.1f} s")

    cfg = navi_variant(with_pallas(leaderboard_config(), True), "goal", repredict=True)
    n_sc, k = 4, cfg.n_joint_future_wosac
    n_ag, n_step = cfg.data.n_ag, cfg.time_step_end
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator().manual_seed(0)
    want, want_routes = navi_full_shapes(cfg, n_sc, n_sc * k)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    checked |= {("knarpe_attention", str(torch.bfloat16), *s_) for s_ in (ATTN_PATH,)}
    checked |= {("knarpe_cross_attention", str(torch.bfloat16), *s_) for s_ in (X_PATH, *NAVI_X)}
    check_full_shapes("(b) navi eval call", shapes, want, checked)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes:
        raise AssertionError(f"(b) navi eval call: launches by route {routes}, expected {want_routes}")
    eval_counts = launches()
    n_re = int(buf.navi_log_prob_valid[..., 1:].sum())
    finite = torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    if (tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3)
            or tuple(buf.navi_log_prob.shape) != (n_sc, k, n_ag, 1 + n_step) or not finite or n_re == 0):
        raise AssertionError(f"(b) navi eval call: pred_pose {tuple(buf.pred_pose.shape)}, navi_log_prob "
                             f"{tuple(buf.navi_log_prob.shape)}, {n_re} re-predictions, or not finite")
    agent_steps = n_sc * k * n_ag * (n_step - cfg.time_step_current)
    out = {"eval_seconds": sec, "eval_peak_gib": peak_gib(), "eval_agent_steps_per_s": agent_steps / sec,
           "eval_repredictions": n_re, "eval": eval_counts}
    log(f"  (b) leaderboard_config navi_mode=goal pred_navi_after_reached use_pallas=True check_level=1 "
        f"joint_future_pred: {n_sc} scenarios x K={k}, {n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps, "
        f"{n_params} parameters, bf16: one call, checked and timed (a first call) {sec:.4f} s, "
        f"{agent_steps / sec:.1f} agent-steps/s, peak memory {out['eval_peak_gib']:.2f} GiB, {n_re} agents re-predicted their goal; "
        f"launches {eval_counts} by full shape {dict(shapes)}, by route {routes}, every shape checked in phase 3; "
        f"navi log-probs {list(buf.navi_log_prob.shape)} [{card}]")
    out.update(seconds=time.perf_counter() - t0, card_vs_cpu_seconds=t_a, card=card)
    log(f"  phase 17 {out['seconds']:.1f} s [{card}]")
    return out


def variant_full_shapes(cfg, n_sc: int, rows: int, train: bool) -> tuple:
    """The launches a `leaderboard_config()`-width call (train=False: joint_future_pred over `rows` rollouts of n_sc
    scenarios) or training step (train=True: rows = n_sc) implies with a learned latent prior, by full shape:
    ({(kernel, dtype, n_b, n_s, K, D, R, H) or ("knn_xy", rows, sources, targets, k): n} forward and backward,
    {kernel/route: n}), every bf16 launch on the staged route. Per rollout step the agent->map KNN and the agent
    decoder's B2 per layer over the map and TL targets (K=89), in training again in the step's recompute; B4 per map
    layer; each learned latent head (the prior at eval; the posterior and the prior in training) runs its encoders
    once: one KNN, B2 per TL layer over the TL tokens' K nearest map polylines and per agent layer at K=89. The main
    TL encoder attends over its static K/V, and the TL and agent self-attentions are dense (at most dense_knn_max
    tokens): no kernel. Each forward outside a recompute has one backward. pose_rpe "xy_dir"'s RPE is 4 wide: its B4
    and B4-bwd take the general route, its B2 and B2-bwd the staged route."""
    m, n, bf = cfg.model, cfg.time_step_end, str(torch.bfloat16)
    n_ag, n_mp, d, h = cfg.data.n_ag, cfg.data.n_mp, m.hidden_dim, m.tf_cfg.n_head
    r = 4 if m.pose_rpe.mode == "xy_dir" else d
    n_tl = cfg.data.n_tl_stop if m.tl_mode == "stop" else cfg.data.n_tl_lane
    if max(n_ag, n_tl) > m.tf_cfg.dense_knn_max:
        raise AssertionError("the variant configs keep the TL and agent self-attentions dense")
    k_mp = int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2mp)
    k_dec = k_mp + int(m.n_tgt_knn * m.ag_encoder.k_tgt_knn_ag2tl)
    k_tl = int(m.n_tgt_knn * m.tl_encoder.k_tgt_knn_tl2mp)
    lay_ag, lay_tl, lay_mp = m.ag_encoder.n_layer_tf, m.tl_encoder.n_layer_tf, m.mp_encoder.n_layer_tf
    x = lambda kernel, b, s_, k: (kernel, bf, b, s_, k, d, r, h)  # noqa: E731
    rep, latents = (2 if train else 1), _learned_latents(cfg, train)
    want = collections.Counter({("knn_xy", rows, n_ag, n_mp, k_mp): rep * n,
                                x("knarpe_cross_attention", rows, n_ag, k_dec): rep * lay_ag * n,
                                x("knarpe_attention", n_sc, n_mp, m.n_tgt_knn): lay_mp})
    want[("knn_xy", n_sc, n_ag, n_mp, k_mp)] += latents
    want[x("knarpe_cross_attention", n_sc, n_tl, k_tl)] += latents * lay_tl
    want[x("knarpe_cross_attention", n_sc, n_ag, k_dec)] += latents * lay_ag
    if train:
        want[x("knarpe_cross_attention_bwd", rows, n_ag, k_dec)] += lay_ag * n + latents * lay_ag
        want[x("knarpe_cross_attention_bwd", n_sc, n_tl, k_tl)] += latents * lay_tl
        want[x("knarpe_attention_bwd", n_sc, n_mp, m.n_tgt_knn)] += lay_mp
    routes = collections.Counter()
    for key, v in want.items():
        if key[0] != "knn_xy":
            routes[f"{key[0]}/{'general' if r == 4 and key[0].startswith('knarpe_attention') else 'staged'}"] += v
    return {key: v for key, v in want.items() if v}, {key: v for key, v in routes.items() if v}


@contextlib.contextmanager
def captured_joint_future():
    """The scene (`prepare_joint_future`: the prior latent among it) and the per-future samples
    (`sample_joint_futures`: ag_latent among them) of the joint_future_pred calls inside the block, the last call's."""
    real_prepare, real_sample, got = eval_lib.prepare_joint_future, eval_lib.sample_joint_futures, {}

    def prepare(*args, **kwargs):
        got["scene"] = real_prepare(*args, **kwargs)
        return got["scene"]

    def sample(*args, **kwargs):
        got["samples"] = real_sample(*args, **kwargs)
        return got["samples"]

    eval_lib.prepare_joint_future, eval_lib.sample_joint_futures = prepare, sample
    try:
        yield got
    finally:
        eval_lib.prepare_joint_future, eval_lib.sample_joint_futures = real_prepare, real_sample


def check_variant_shapes(where: str, shapes, want: dict) -> None:
    """A phase 18 (a) call's or step's launches by full shape are exactly `want`, each at a shape phase 3 checked."""
    bf = str(torch.bfloat16)
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    for kernel, shapes_ in (("knarpe_attention", (ATTN_PATH, TRAIN_ATTN_PATH)),
                            ("knarpe_attention_bwd", (TRAIN_ATTN_PATH,)),
                            ("knarpe_cross_attention", (X_PATH, TRAIN_X_PATH, *VAL_X, *VARIANT_X)),
                            ("knarpe_cross_attention_bwd", (TRAIN_X_PATH, *VARIANT_TRAIN_X))):
        checked |= {(kernel, bf, *s_) for s_ in shapes_}
    check_full_shapes(where, shapes, want, checked)


def run_variant_phase(card: str) -> dict:
    """Phase 18, the variants: (a) `leaderboard_config()` with a type-branched `cat` posterior and a learned `cat`
    prior (8 factors of 2 classes over latent_dim 16), TL tokens at the stop lines, the stacked TL input and
    use_pallas, seed-0 weights: joint_future_pred 4 scenarios x K=32 at level 1 (one call, checked and timed, a first
    call) and one training step at batch 8 (a first step), their launches by full shape and route, each at a shape
    phase 3 checked; the K0 latent the prior's argmax one-hot, and the std_cat tie's first class on the card; (b) the
    phase-4 config card vs CPU in float32 (`CARD_VS_CPU[18]`); (c) pose_rpe "xy_dir" at the flagship's widths
    (`run_xy_dir_arm`). -> {"eval": launches per (a) call, "train": per (a) step, by kernel, and by route; seconds,
    peak memory, throughputs; "xy_dir": (c)'s}."""
    from trafficbotsv15_tpu_torch.ops.distributions import MultiCategorical

    t0 = time.perf_counter()
    cfg = variant_of(with_pallas(leaderboard_config(), True), "cat+stop+stacked")
    cfg = dataclasses.replace(cfg, joint_future_pred_deterministic_k0=True)  # the K0 future takes the modes
    n_sc, k = 4, cfg.n_joint_future_wosac
    n_ag, n_step = cfg.data.n_ag, cfg.time_step_end
    lat_cfg = cfg.model.latent_encoder
    n_cat = lat_cfg.latent_prior.n_cat
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    want, want_routes = variant_full_shapes(cfg, n_sc, n_sc * k, train=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes, captured_joint_future() as got:
        _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0), check_level=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    check_variant_shapes("(a) variant eval call", shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes:
        raise AssertionError(f"(a) variant eval call: launches by route {routes}, expected {want_routes}")
    eval_counts = launches()
    finite = torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not finite:
        raise AssertionError(f"(a) variant eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    lat, prior = got["samples"]["ag_latent"], got["scene"].latent_prior
    mode = torch.nn.functional.one_hot(prior.logits.argmax(-1), prior.n_class).to(lat.dtype).reshape(lat[::k].shape)
    per_factor = lat.float().reshape(n_sc * k, n_ag, n_cat, -1).sum(-1)
    if (tuple(lat.shape) != (n_sc * k, n_ag, lat_cfg.latent_dim) or not torch.equal(lat[::k], mode)
            or not bool(((per_factor - 1).abs() <= 1e-2).all())):
        raise AssertionError(f"(a) variant eval call: ag_latent {tuple(lat.shape)}: K0 not the prior's argmax one-hot, "
                             f"or a draw not one-hot per factor")
    tie = MultiCategorical(torch.zeros(n_sc, n_ag, n_cat, 2, device="cuda")).sample(None, True)
    if not torch.equal(tie.reshape(n_sc, n_ag, n_cat, 2)[..., 0], torch.ones(n_sc, n_ag, n_cat, device="cuda")):
        raise AssertionError("(a) std_cat's tie: the card's deterministic draw is not the first class")
    agent_steps = n_sc * k * n_ag * (n_step - cfg.time_step_current)
    out = {"eval_seconds": sec, "eval_peak_gib": peak_gib(), "eval_agent_steps_per_s": agent_steps / sec,
           "eval": eval_counts, "eval_by_route": routes}
    log(f"  (a) leaderboard_config cat posterior (type-branched) + cat prior ({n_cat} x {prior.n_class}), "
        f"tl_mode=stop ({cfg.data.n_tl_stop} stop lines), temp_stack_input, use_pallas=True, check_level=1 "
        f"joint_future_pred: {n_sc} scenarios x K={k}, {n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps, "
        f"{n_params} parameters, bf16: one call, checked and timed (a first call) {sec:.4f} s, "
        f"{agent_steps / sec:.1f} agent-steps/s, peak memory {out['eval_peak_gib']:.2f} GiB; launches {eval_counts} by "
        f"full shape {dict(shapes)}, by route {routes}, every shape checked in phase 3; the K0 latent the prior's "
        f"argmax one-hot, every draw one-hot per factor; std_cat's tie draws the first class [{card}]")
    del buf, model, got
    torch.cuda.empty_cache()

    t_b = time.perf_counter()
    run_card_vs_cpu(18)
    out["card_vs_cpu_seconds"] = time.perf_counter() - t_b
    log(f"  (b) the phase-4 config in the variants card vs CPU in float32 (above), {out['card_vs_cpu_seconds']:.1f} s")

    n_train = 8
    model = build_model(cfg, seed=0, device="cuda")
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    want, want_routes = variant_full_shapes(cfg, n_train, n_train, train=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes, recorded_bwd_launches() as (bwd_shapes, _):
        metrics = {key: float(v) for key, v in step(tbatch, torch.Generator().manual_seed(0)).items()}
    torch.cuda.synchronize()
    train_sec = time.perf_counter() - t1
    check_variant_shapes("(a) variant training step", shapes + bwd_shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes:
        raise AssertionError(f"(a) variant training step: launches by route {routes}, expected {want_routes}")
    loss, kl, gnorm = metrics["training/loss"], metrics["training/vae_kl"], metrics["grad_norm"]
    if not all(math.isfinite(v) and v != 0 for v in (loss, kl, gnorm)):
        raise AssertionError(f"(a) variant training step: loss {loss}, KL {kl}, grad_norm {gnorm}")
    out.update(train_seconds=train_sec, train_peak_gib=peak_gib(), train=launches(), train_by_route=routes,
               train_samples_per_s=n_train / train_sec)
    log(f"  (a) the same config's training step: {n_train} scenarios, a first step {train_sec:.4f} s "
        f"({n_train / train_sec:.3f} train samples/s), peak memory {out['train_peak_gib']:.2f} GiB, loss {loss:.6f}, "
        f"KL {kl:.6f}, grad_norm {gnorm:.6f}; launches {out['train']} by full shape {dict(shapes + bwd_shapes)}, by "
        f"route {routes}, every shape checked in phase 3 [{card}]")
    del step, model, tbatch
    torch.cuda.empty_cache()
    out["xy_dir"] = run_xy_dir_arm(card)
    out.update(seconds=time.perf_counter() - t0, card=card)
    log(f"  phase 18 {out['seconds']:.1f} s [{card}]")
    return out


def check_rpe4_shapes(where: str, shapes, want: dict) -> None:
    """A phase 18 (c) call's or step's launches by full shape are exactly `want`, each at a shape phase 3 checked on
    the route `variant_full_shapes` names (B2 and B2-bwd at d_rpe = 4 staged, B4 and B4-bwd general)."""
    bf = str(torch.bfloat16)
    checked = {("knn_xy", *case[:4]) for case in KNN_CASES.values()}
    for kernel, shapes_ in (("knarpe_attention", RPE4_ATTN), ("knarpe_attention_bwd", RPE4_ATTN_BWD),
                            ("knarpe_cross_attention", RPE4_X), ("knarpe_cross_attention_bwd", RPE4_X_BWD)):
        checked |= {(kernel, bf, *s_) for s_ in shapes_}
    check_full_shapes(where, shapes, want, checked)


def run_xy_dir_arm(card: str) -> dict:
    """Phase 18 (c): `leaderboard_config()` with pose_rpe "xy_dir" (a 4-wide RPE) and use_pallas, nothing else cut,
    seed-0 weights: joint_future_pred 4 scenarios x K=32 at level 1 (one call, checked and timed, a first call) and one
    training step at batch 8 (a first step), their launches by full shape and route (`variant_full_shapes`: every B2
    and B2-bwd at d_rpe = 4 on the staged route, none general; B4 and B4-bwd general), each at a shape phase 3
    checked. -> {"eval": launches per call, "train": per step, by kernel, and by route; seconds, peak memory,
    throughputs}."""
    t0 = time.perf_counter()
    cfg = variant_of(with_pallas(leaderboard_config(), True), "xy_dir")
    n_sc, k = 4, cfg.n_joint_future_wosac
    n_ag, n_step = cfg.data.n_ag, cfg.time_step_end
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    want, want_routes = variant_full_shapes(cfg, n_sc, n_sc * k, train=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0), check_level=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    check_rpe4_shapes("(c) xy_dir eval call", shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if routes != want_routes or routes.get("knarpe_cross_attention/general"):
        raise AssertionError(f"(c) xy_dir eval call: launches by route {routes}, expected {want_routes}")
    out = {"eval": launches(), "eval_by_route": routes, "eval_by_shape": dict(shapes)}
    finite = torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not finite:
        raise AssertionError(f"(c) xy_dir eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    agent_steps = n_sc * k * n_ag * (n_step - cfg.time_step_current)
    out.update(eval_seconds=sec, eval_peak_gib=peak_gib(), eval_agent_steps_per_s=agent_steps / sec)
    log(f"  (c) leaderboard_config pose_rpe=xy_dir (d_rpe = 4), use_pallas=True, check_level=1 joint_future_pred: "
        f"{n_sc} scenarios x K={k}, {n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps, {n_params} parameters, "
        f"bf16: one call, checked and timed (a first call) {sec:.4f} s, {agent_steps / sec:.1f} agent-steps/s, peak "
        f"memory {out['eval_peak_gib']:.2f} GiB; launches {out['eval']} by full shape {dict(shapes)}, by route "
        f"{routes}, every shape checked in phase 3 [{card}]")
    del buf
    n_train = 8
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    want, want_routes = variant_full_shapes(cfg, n_train, n_train, train=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes, recorded_bwd_launches() as (bwd_shapes, _):
        metrics = {key: float(v) for key, v in step(tbatch, torch.Generator().manual_seed(0)).items()}
    torch.cuda.synchronize()
    train_sec = time.perf_counter() - t1
    check_rpe4_shapes("(c) xy_dir training step", shapes + bwd_shapes, want)
    routes = {key: v for key, v in knarpe.ROUTE_LAUNCHES.items() if v}
    if (routes != want_routes or routes.get("knarpe_cross_attention/general")
            or routes.get("knarpe_cross_attention_bwd/general")):
        raise AssertionError(f"(c) xy_dir training step: launches by route {routes}, expected {want_routes}")
    loss, gnorm = metrics["training/loss"], metrics["grad_norm"]
    if not all(math.isfinite(v) and v != 0 for v in (loss, gnorm)):
        raise AssertionError(f"(c) xy_dir training step: loss {loss}, grad_norm {gnorm}")
    out.update(train=launches(), train_by_route=routes, train_by_shape=dict(shapes + bwd_shapes), train_seconds=train_sec,
               train_peak_gib=peak_gib(), train_samples_per_s=n_train / train_sec,
               seconds=time.perf_counter() - t0)
    log(f"  (c) the same config's training step: {n_train} scenarios, a first step {train_sec:.4f} s "
        f"({n_train / train_sec:.3f} train samples/s), peak memory {out['train_peak_gib']:.2f} GiB, loss {loss:.6f}, "
        f"grad_norm {gnorm:.6f}; launches {out['train']} by full shape {dict(shapes + bwd_shapes)}, by route {routes}, "
        f"every shape checked in phase 3; (c) {out['seconds']:.1f} s [{card}]")
    del step, model, tbatch
    torch.cuda.empty_cache()
    return out


def _first_difference(a, b) -> str:
    """The first buffer field (violation flags by name) in which two rollout buffers differ, "" where every bit is
    equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        pairs = [(f"{f.name}/{k}", x[k], y[k]) for k in x] if isinstance(x, dict) else [(f.name, x, y)]
        for name, u, v in pairs:
            if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                return name
    return ""


def run_scene_centric_phase(card: str) -> dict:
    """Phase 19: (a) the scene-centric model at `leaderboard_config()` width with use_pallas, one joint_future_pred
    call (4 scenarios x K=32, level 1) and one training step at batch 8, each a first one, checked and timed: no
    kernel launch; (b) token dedup at the flagship with use_pallas: dedup and replicated calls in turns (two each), the
    same weights and draws, compared bit for bit, each with phase 6's launches, its seconds and peak memory; (c) `CARD_VS_CPU[19]`. -> {"eval":
    launches per (a) call, "train": per (a) step, "dedup": per (b) dedup call, by kernel; seconds, peak memory,
    throughputs, the dedup comparison}."""
    t0 = time.perf_counter()
    zero = {name: 0 for name in launches()}
    cfg = variant_of(with_pallas(leaderboard_config(), True), "scene_centric")
    n_sc, k = 4, cfg.n_joint_future_wosac
    n_ag, n_step = cfg.data.n_ag, cfg.time_step_end
    batch = make_batch(cfg.data, n_sc=n_sc, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes:
        _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0), check_level=1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t1
    if launches() != zero or shapes or expected_launches(cfg, n_step) != zero:
        raise AssertionError(f"(a) scene-centric eval call: launches {launches()}, by shape {dict(shapes)}; the JAX "
                             f"package's scene-centric path reaches no kernel")
    finite = torch.isfinite(buf.pred_pose).all() and torch.isfinite(buf.log_prob).all()
    if tuple(buf.pred_pose.shape) != (n_sc, k, n_ag, n_step, 3) or not finite:
        raise AssertionError(f"(a) scene-centric eval call: pred_pose {tuple(buf.pred_pose.shape)} or not finite")
    agent_steps = n_sc * k * n_ag * (n_step - cfg.time_step_current)
    out = {"eval_seconds": sec, "eval_peak_gib": peak_gib(), "eval_agent_steps_per_s": agent_steps / sec,
           "eval": launches()}
    flags = {key: int(v.sum()) for key, v in buf.violation.items() if not key.endswith("_this_step")}
    log(f"  (a) leaderboard_config pairwise_relative=False, use_pallas=True, check_level=1 joint_future_pred: {n_sc} "
        f"scenarios x K={k}, {n_ag} agents, {cfg.data.n_mp} polylines, {n_step} steps, {n_params} parameters, bf16: "
        f"one call, checked and timed (a first call) {sec:.4f} s, {agent_steps / sec:.1f} agent-steps/s, peak memory "
        f"{out['eval_peak_gib']:.2f} GiB; no kernel launched ({launches()}); agent-steps flagged {flags} [{card}]")
    del buf
    n_train = 8
    step = train_lib.make_train_step(cfg, model, *make_optimizer(cfg.optimizer, model.named_parameters()))
    tbatch = train_lib.batch_to_device(make_batch(cfg.data, n_sc=n_train, seed=0), torch.device("cuda"))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t1 = time.perf_counter()
    with recorded_launch_shapes() as shapes, recorded_bwd_launches() as (bwd_shapes, _):
        metrics = {key: float(v) for key, v in step(tbatch, torch.Generator().manual_seed(0)).items()}
    torch.cuda.synchronize()
    train_sec = time.perf_counter() - t1
    if launches() != zero or shapes or bwd_shapes or expected_train_launches(cfg) != zero:
        raise AssertionError(f"(a) scene-centric training step: launches {launches()}, by shape "
                             f"{dict(shapes + bwd_shapes)}; the scene-centric path reaches no kernel")
    loss, gnorm = metrics["training/loss"], metrics["grad_norm"]
    if not all(math.isfinite(v) and v != 0 for v in (loss, gnorm)):
        raise AssertionError(f"(a) scene-centric training step: loss {loss}, grad_norm {gnorm}")
    out.update(train_seconds=train_sec, train_peak_gib=peak_gib(), train=launches(),
               train_samples_per_s=n_train / train_sec)
    log(f"  (a) the same model's training step: {n_train} scenarios, a first step {train_sec:.4f} s "
        f"({n_train / train_sec:.3f} train samples/s), peak memory {out['train_peak_gib']:.2f} GiB, loss {loss:.6f}, "
        f"grad_norm {gnorm:.6f}; no kernel launched, forward or backward [{card}]")
    del model, step, tbatch
    torch.cuda.empty_cache()

    base = with_pallas(leaderboard_config(), True)
    model = build_model(base, seed=0, device="cuda")
    bufs, secs, peaks, reps = {}, {"dedup": [], "replicated": []}, {"dedup": [], "replicated": []}, []
    real_rollout = rollout_lib.rollout

    def spy(*args, **kwargs):
        reps.append(kwargs.get("token_rep", 1))
        return real_rollout(*args, **kwargs)

    for arm in ("dedup", "replicated", "replicated", "dedup"):
        cfg = dataclasses.replace(base, rollout_token_dedup=arm == "dedup")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_launches()
        rollout_lib.rollout = spy
        t1 = time.perf_counter()
        try:
            with recorded_forward_shapes() as seen:
                _, buf = joint_future_pred(cfg, model, batch, generator=torch.Generator().manual_seed(0),
                                           check_level=1)
            torch.cuda.synchronize()
        finally:
            rollout_lib.rollout = real_rollout
        secs[arm].append(time.perf_counter() - t1)
        # the call's own peak: above what was held when it started (the model, the batch, the other arm's buffer)
        peaks[arm].append((torch.cuda.max_memory_allocated() - held) / 2 ** 30)
        bufs.setdefault(arm, buf)
        del buf
        want = expected_launches(cfg, n_step)
        if launches() != want:
            raise AssertionError(f"(b) {arm} call: launches {launches()}, expected {want}")
        check_path_forward_shapes(f"(b) {arm} call", seen)
        check_staged_route(f"(b) {arm} call")
        if arm == "dedup":
            out["dedup"] = launches()
    if reps != [k, 1, 1, k]:
        raise AssertionError(f"(b) the rollouts took token_rep {reps}, expected [{k}, 1, 1, {k}]")
    a, b = bufs["dedup"], bufs["replicated"]
    first = _first_difference(a, b)
    k0_equal = (torch.equal(a.pred_pose[:, 0], b.pred_pose[:, 0]) and torch.equal(a.pred_valid[:, 0], b.pred_valid[:, 0])
                and torch.equal(a.tl_state[:, 0], b.tl_state[:, 0])
                and all(torch.equal(a.violation[key][:, 0], b.violation[key][:, 0]) for key in a.violation))
    if not k0_equal:
        err = float((a.pred_pose[:, 0] - b.pred_pose[:, 0]).abs().max())
        raise AssertionError(f"(b) dedup vs replicated: the K0 futures, TL states or rule flags differ (first "
                             f"differing tensor {first}; K0 pose max |err| {err})")
    out.update(dedup_seconds=secs["dedup"], replicated_seconds=secs["replicated"], dedup_peak_gib=peaks["dedup"],
               replicated_peak_gib=peaks["replicated"], dedup_first_difference=first or None)
    log(f"  (b) leaderboard_config use_pallas=True joint_future_pred {n_sc} x K={k} with rollout_token_dedup "
        f"(token_rep {k}) and without, in turns dedup, replicated, replicated, dedup: dedup "
        f"{', '.join(f'{s:.4f}' for s in secs['dedup'])} s, replicated "
        f"{', '.join(f'{s:.4f}' for s in secs['replicated'])} s; each call's peak above what it started with: dedup "
        f"{', '.join(f'{g:.4f}' for g in peaks['dedup'])} GiB, replicated "
        f"{', '.join(f'{g:.4f}' for g in peaks['replicated'])} GiB; the first call of each arm compared: "
        + ("every buffer tensor equal bit for bit" if not first else
           f"the K0 futures, TL states and rule flags equal bit for bit, first differing tensor {first}")
        + f"; launches per call {out['dedup']} (phase 6's), staged [{card}]")
    del bufs, a, b, model
    torch.cuda.empty_cache()

    t_c = time.perf_counter()
    run_card_vs_cpu(19)
    out.update(card_vs_cpu_seconds=time.perf_counter() - t_c, seconds=time.perf_counter() - t0, card=card)
    log(f"  (c) the phase-4 config scene-centric, and with gelu + mean_valid + attn_dropout_weights, card vs CPU in "
        f"float32 (above), {out['card_vs_cpu_seconds']:.1f} s")
    log(f"  phase 19 {out['seconds']:.1f} s [{card}]")
    return out


# the CUDA kernels one wrapper launch runs, by wrapper and route (csrc/): every backward adds the two weight-gradient
# passes of knarpe_bwd.cu, B4-bwd's heads route the drpe pass and B2-bwd's the dx pass; the trace's kernel events are
# matched by these names
WGRAD_PASSES = ("knarpe_wgrad_partial", "knarpe_wgrad_reduce")
CUDA_KERNELS = {
    "knn_xy": ("knn_xy_kernel",),
    "knarpe_attention/general": ("knarpe_kernel",),
    "knarpe_attention/staged": ("knarpe_attn_staged_kernel",),
    "knarpe_attention/heads": ("knarpe_attn_heads_kernel",),
    "knarpe_cross_attention/general": ("knarpe_kernel",),
    "knarpe_cross_attention/staged": ("knarpe_x_staged_kernel",),
    "knarpe_cross_attention/cluster": ("knarpe_x_cluster_kernel",),
    "knarpe_cross_attention_v3/general": ("knarpe_kernel",),
    "knarpe_cross_attention_v3/staged": ("knarpe_x_staged_kernel",),
    "knarpe_cross_attention_v3/heads": ("knarpe_x3_heads_kernel",),
    "knarpe_attention_bwd/general": ("knarpe_bwd_kernel", *WGRAD_PASSES),
    "knarpe_attention_bwd/staged": ("knarpe_attn_bwd_staged_kernel", *WGRAD_PASSES),
    "knarpe_attention_bwd/heads": ("knarpe_attn_bwd_heads_kernel", "knarpe_attn_bwd_heads_drpe", *WGRAD_PASSES),
    "knarpe_cross_attention_bwd/general": ("knarpe_bwd_kernel", *WGRAD_PASSES),
    "knarpe_cross_attention_bwd/heads": ("knarpe_x_bwd_heads_kernel", "knarpe_x_bwd_heads_dx", *WGRAD_PASSES),
    "knarpe_cross_attention_bwd/staged": ("knarpe_x_bwd_staged_kernel", *WGRAD_PASSES),
}
PORT_KERNELS = {name for names in CUDA_KERNELS.values() for name in names}
# a port kernel's name in a demangled event name ("void (anonymous namespace)::knn_xy_kernel<8>(float2 const*, ...)")
PORT_KERNEL_NAME = re.compile(rf"(?<!\w)({'|'.join(sorted(PORT_KERNELS))})(?=\s*[<(])")
# phase 20 (a)'s fit: run.py traces fit steps 3-5 of the 6, at the phase-4 config with 13 logged steps (a 12-step
# rollout): at its 31 the trace of three steps held 2.3 M events, 2.2 of the phase's seconds per 100 k
PROFILE_FIT_STEPS, PROFILE_TRACED, PROFILE_N_STEP = 6, 3, 13


def route_counts() -> dict:
    """The launches since the last reset by wrapper and route: B1's under "knn_xy", B4's and B2's as ROUTE_LAUNCHES."""
    return {"knn_xy": knn.LAUNCHES, **{k: n for k, n in knarpe.ROUTE_LAUNCHES.items() if n}}


def expected_kernel_events(routes: dict, scale: float = 1.0) -> dict:
    """The port's CUDA kernel events that `routes` (route_counts) imply, scaled, by kernel name."""
    want = collections.Counter()
    for key, n in routes.items():
        for name in CUDA_KERNELS[key]:
            want[name] += n * scale
    return {name: int(round(n)) for name, n in want.items() if n}


def traced_port_kernels(events: list) -> dict:
    """The trace's kernel events of the port's CUDA kernels, by kernel name (the demangled event name's function)."""
    got = collections.Counter()
    for e in profiling.kernel_events(events):
        m = PORT_KERNEL_NAME.search(e["name"])
        if m:
            got[m.group(1)] += 1
    return dict(got)


def check_trace_kernels(where: str, events: list, want: dict) -> None:
    got = traced_port_kernels(events)
    if got != want:
        raise AssertionError(f"{where}: the trace's kernel events {got}, the launch counters imply {want}")


def trace_summary(path, events: list, t0: float, t1: float) -> dict:
    """The trace's size and the device's busy and idle share of the window [t0, t1] µs."""
    busy = profiling.busy_seconds(profiling.device_intervals(events), t0, t1)
    window = (t1 - t0) / 1e6
    return {"events": len(events), "bytes": Path(path).stat().st_size, "window_s": window, "busy_s": busy,
            "busy_share": busy / window, "idle_share": 1.0 - busy / window}


def profiled_fit(card: str, tmp: Path) -> dict:
    """(a) `run.main` fit with profile_dir at the phase-4 config with use_pallas: the trace of steps 3-5 holds the
    three steps' ranges, and as many kernel events of each port kernel as three of the fit's six steps launched;
    the device's idle share over those steps. (Its debug_nans=true step is `debug_nans_fit`.)"""
    cfg = with_pallas(phase4_config(PROFILE_N_STEP), True)
    prof_dir = tmp / "profile"
    args = ["action=fit", "preset=tiny", "validate_every_epoch=false", "log_every=1000",
            *config_overrides(tiny_config(), cfg)]
    writes, real_stop = [], profiling.Tracer.stop

    def timed_stop(tracer):
        t = time.perf_counter()
        out = real_stop(tracer)
        writes.append(time.perf_counter() - t)
        return out

    reset_launches()
    profiling.Tracer.stop = timed_stop
    try:
        t0 = time.perf_counter()
        run_lib.main(args + [f"ckpt_dir={tmp / 'fit'}", f"max_steps={PROFILE_FIT_STEPS}", f"profile_dir={prof_dir}"])
        t_fit = time.perf_counter() - t0
    finally:
        profiling.Tracer.stop = real_stop
    counts, routes = launches(), route_counts()
    want_step = expected_train_launches(cfg)
    if any(counts[k] != PROFILE_FIT_STEPS * n for k, n in want_step.items()):
        raise AssertionError(f"(a) profiled fit: launches {counts} over {PROFILE_FIT_STEPS} steps, expected "
                             f"{want_step} per step")
    path = profiling.trace_path(str(prof_dir))
    t1 = time.perf_counter()
    events = profiling.read_trace(path)
    t_read = time.perf_counter() - t1
    windows = [profiling.annotation_windows(events, f"fit step {i}") for i in range(PROFILE_FIT_STEPS)]
    if [len(w) for w in windows] != [0, 0, 0, 1, 1, 1]:
        raise AssertionError(f"(a) the trace's fit step ranges {[len(w) for w in windows]} of steps 0-5, expected "
                             f"one each of steps 3-5")
    check_trace_kernels("(a) trace of fit steps 3-5", events,
                        expected_kernel_events(routes, PROFILE_TRACED / PROFILE_FIT_STEPS))
    dev = profiling.device_intervals(events)
    starts = [w[0][0] for w in windows[3:]]
    end = max(windows[5][0][1], dev[-1][1] if dev else 0.0)
    summary = trace_summary(path, events, starts[0], end)
    per_step = [1.0 - profiling.busy_seconds(dev, a, b) / ((b - a) / 1e6)
                for a, b in zip(starts, starts[1:] + [end])]
    summary.update(fit_seconds=t_fit, write_seconds=writes[0], read_seconds=t_read, idle_share_per_step=per_step,
                   launches_per_step={k: n // PROFILE_FIT_STEPS for k, n in counts.items()})
    log(f"  (a) run.main fit at the phase-4 config with {PROFILE_N_STEP} logged steps, use_pallas, {PROFILE_FIT_STEPS} "
        f"steps with profile_dir in {t_fit:.2f} s (the trace written in {writes[0]:.2f} s of them): {path.name} "
        f"{summary['bytes']} bytes, {summary['events']} events (read in {t_read:.2f} s), "
        f"fit step ranges 3-5 only; port kernel events {traced_port_kernels(events)} = 3 steps of the launch "
        f"counters {routes} / {PROFILE_FIT_STEPS}; device idle share over steps 3-5 {summary['idle_share']:.4f} "
        f"(busy {summary['busy_s']:.4f} of {summary['window_s']:.4f} s; per step "
        f"{[round(x, 4) for x in per_step]}, profiler on) [{card}]")
    del events
    return summary


def debug_nans_fit(card: str, tmp: Path) -> float:
    """(a)'s `run.main` fit step with debug_nans=true at the profiled fit's config, in this process: anomaly mode with
    NaN checks on inside run.fit, off again after run.main, a finite loss. -> its seconds."""
    cfg = with_pallas(phase4_config(PROFILE_N_STEP), True)
    args = ["action=fit", "preset=tiny", "validate_every_epoch=false", "log_every=1000", "max_steps=1",
            "debug_nans=true", f"ckpt_dir={tmp / 'nans'}", *config_overrides(tiny_config(), cfg)]
    seen, real_fit = [], run_lib.fit

    def spy(*fit_args, **kwargs):
        seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()))
        return real_fit(*fit_args, **kwargs)

    run_lib.fit = spy
    try:
        t0 = time.perf_counter()
        run_lib.main(args)
        sec = time.perf_counter() - t0
    finally:
        run_lib.fit = real_fit
    loss = json.loads((tmp / "nans" / "metrics.jsonl").read_text().splitlines()[-1])["training/loss"]
    if seen != [(True, True)] or torch.is_anomaly_enabled() or not math.isfinite(loss):
        raise AssertionError(f"(a) debug_nans=true fit step: anomaly mode (on, NaN checks) in fit {seen}, on after "
                             f"{torch.is_anomaly_enabled()}, loss {loss}")
    log(f"  (a) debug_nans=true: one run.main fit step under anomaly mode with NaN checks, the mode off after run.main; "
        f"loss {loss:.6f}; {sec:.2f} s [{card}]")
    return sec


# phase 20 (b) traces phase 6's flagship call cut to its first 30 rollout steps: the call's 90 held 1.33 M events,
# whose file took ~21 s to write and ~9 s to read on an H100 host (NVIDIA H100 80GB HBM3, 700.00 W)
TRACED_EVAL_STEPS = 30


def traced_eval_call(card: str) -> dict:
    """(b) one flagship joint_future_pred call (phase 6's config and batch, use_pallas) cut to TRACED_EVAL_STEPS
    rollout steps, traced by profiling.trace inside an annotate range: its launches are what those steps imply, its
    kernel events the launches' kernels; the device's busy and idle share of the range."""
    import tempfile

    cfg = horizon(with_pallas(leaderboard_config(), True), TRACED_EVAL_STEPS)
    want = expected_launches(cfg, TRACED_EVAL_STEPS)
    batch = make_batch(cfg.data, n_sc=4, seed=0)
    model = build_model(cfg, seed=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as name:
        t0 = time.perf_counter()
        with profiling.trace(name) as path:
            with profiling.annotate("joint_future_pred"):
                _, buf = joint_future_pred(cfg, model, batch, generator=gen, check_level=1)
            t_call = time.perf_counter() - t0
        t_trace = time.perf_counter() - t0
        counts, routes = launches(), route_counts()
        if counts != want:
            raise AssertionError(f"(b) traced eval call: launches {counts}, {TRACED_EVAL_STEPS} steps imply {want}")
        if not torch.isfinite(buf.pred_pose).all():
            raise AssertionError("(b) traced eval call: non-finite poses")
        t1 = time.perf_counter()
        events = profiling.read_trace(path)
        t_read = time.perf_counter() - t1
        check_trace_kernels("(b) trace of the eval call", events, expected_kernel_events(routes))
        (a, b), = profiling.annotation_windows(events, "joint_future_pred")
        dev = profiling.device_intervals(events)
        summary = trace_summary(path, events, a, max(b, dev[-1][1] if dev else 0.0))
        summary.update(device_ops=sum(e.get("cat") in profiling.DEVICE_CATEGORIES for e in events),
                       call_seconds=t_call, write_seconds=t_trace - t_call, read_seconds=t_read)
        del events
    log(f"  (b) leaderboard_config joint_future_pred, use_pallas, {TRACED_EVAL_STEPS} rollout steps, traced by "
        f"profiling.trace: the call {t_call:.2f} s (profiler on), the file written in {t_trace - t_call:.2f} s: "
        f"{summary['bytes']} bytes, {summary['events']} events, {summary['device_ops']} device ops (read in "
        f"{t_read:.2f} s, then deleted); port kernel events = the launches {want} by route {routes}; device busy "
        f"{summary['busy_s']:.4f} of {summary['window_s']:.4f} s, "
        f"busy share {summary['busy_share']:.4f}, idle share {summary['idle_share']:.4f} [{card}]")
    return summary


VIDEO_KEYS = {"step_current", "step_gt", "step_end", "agent/valid", "agent/pos", "agent/yaw_bbox", "action", "act_P",
              "tl_lane/state", "diffbar_reward"}


def video_inputs_on_card(card: str, tmp: Path) -> dict:
    """(c) validation_video_inputs of a reactive replay on the card at the phase-4 config with use_pallas: the
    documented keys and shapes, finite poses; one scenario rendered where cv2 imports."""
    from trafficbotsv15_tpu_torch.utils.visualization import require_cv2

    cfg = with_pallas(phase4_config(), True)
    batch = make_batch(cfg.data, n_sc=2, seed=3)
    model = build_model(cfg, seed=0, device="cuda")
    with torch.no_grad():
        _, buf, *_ = eval_lib.reactive_replay(cfg, model, batch, device="cuda", generator=torch.Generator().manual_seed(0))
    flat = buf.flatten_joint_future(1)
    episode, prediction = eval_runner.validation_video_inputs(cfg, batch, flat, 0)
    n_ag, n_fut = cfg.data.n_ag, cfg.time_step_end - cfg.time_step_current
    shapes = {"agent/valid": (n_ag, n_fut), "agent/pos": (n_ag, n_fut, 2), "agent/yaw_bbox": (n_ag, n_fut, 1),
              "action": (n_ag, n_fut, 2), "act_P": (n_ag, n_fut), "tl_lane/state": (cfg.data.n_tl_lane, n_fut, 5),
              "diffbar_reward": (n_ag, n_fut), **{k: (n_ag, n_fut) for k in flat.violation}}
    missing = (VIDEO_KEYS | set(flat.violation)) - set(prediction)
    wrong = {k: prediction[k].shape for k, shape in shapes.items() if k in prediction and prediction[k].shape != shape}
    if missing or wrong or not all(isinstance(v, np.ndarray) for k, v in prediction.items() if k in shapes):
        raise AssertionError(f"(c) validation_video_inputs: missing {sorted(missing)}, shapes off {wrong}")
    if not (np.isfinite(prediction["agent/pos"]).all() and np.isfinite(prediction["agent/yaw_bbox"]).all()):
        raise AssertionError("(c) validation_video_inputs: non-finite poses")
    if not {"map/valid", "agent/pos", "agent/role", "agent/size"} <= set(episode):
        raise AssertionError(f"(c) validation_video_inputs: episode keys {sorted(episode)}")
    import importlib.util

    h5py = "h5py imports" if importlib.util.find_spec("h5py") else "no h5py (data=h5 and the packer's writer need it)"
    try:
        cv2 = require_cv2()
    except ImportError as e:
        log(f"  (c) validation_video_inputs of a reactive replay on the card: {len(prediction)} keys, shapes and "
            f"finite poses checked; videos: not run: no cv2 ({e}); {h5py} [{card}]")
        return {"videos": "not run: no cv2", "h5py": h5py}
    t0 = time.perf_counter()
    paths = eval_runner.save_validation_videos(cfg, batch, flat, out_dir=str(tmp / "videos"), n_vis=1)
    empty = [p for p in paths if not Path(p).exists() or (Path(p).is_file() and Path(p).stat().st_size == 0)]
    if not paths or empty:
        raise AssertionError(f"(c) save_validation_videos wrote {paths}; missing or empty {empty}")
    t_render = time.perf_counter() - t0
    log(f"  (c) validation_video_inputs of a reactive replay on the card: {len(prediction)} keys, shapes and finite "
        f"poses checked; cv2 {cv2.__version__}: one scenario rendered in {t_render:.2f} s: "
        f"{[Path(p).name for p in paths]}; {h5py} [{card}]")
    return {"videos": len(paths), "render_seconds": t_render, "cv2": cv2.__version__, "h5py": h5py}


def run_profiling_phase(card: str) -> dict:
    """Phase 20: (a) the fit's profile_dir trace, (b) a traced flagship eval call, (c) the validation videos' inputs on
    the card, then (a)'s debug_nans step."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as name:
        tmp = Path(name)
        out = {"fit": profiled_fit(card, tmp)}
        torch.cuda.empty_cache()
        out["eval"] = traced_eval_call(card)
        torch.cuda.empty_cache()
        out.update(video_inputs_on_card(card, tmp))
        out["fit"]["debug_nans_seconds"] = debug_nans_fit(card, tmp)
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 20 {out['seconds']:.1f} s [{card}]")
    return out


# phase 18 (b)'s arms (`variant_of`), all with use_pallas: every variant of the input, TL, pose and latent options in
# one of them; apply_q_rpe keeps its whole arm off B2 and B4, xy_dir's d_rpe = 4 takes them on the general route
# (float32). Three arms, not one a variant: each arm's CPU runs cost ~5 s beside the build
VARIANT_ARMS = (("cat+stop+stacked", True), ("std_cat+input+pe_xy_dir+q_rpe", True), ("xy_dir", True))
# the card-vs-CPU checks at the phase-4 config, by phase, as (check, its arguments). Their CPU runs are made while
# the kernels build (`precompute_cpu_references`), the card's runs and the comparisons in their phase. Phase 17 (a):
# batch seeds at which a K0 row re-predicts within the 20 steps (a destination is reached at step 10 of seed 5's);
# dest re-predicting trains at batch seeds 1 and 0. Seed 0 is pinned: there one ReLU input of the agent encoder's FFN
# (scenario 0, agent 8, unit 175) lies 6.7e-7 above 0 in float64 and below 0 in the CPU's float32
# (scripts/torch_grad_witness.py), so the float32 gradient of ag_encoder.tf_ag2agmptl.layer1.ffn1 takes one of two
# values ~2e-3 of its scale apart: the card is held against the CPU's float64, the CPU's float32 logged
CARD_VS_CPU = {
    4: [("slice", dict(use_pallas=False)), ("slice", dict(use_pallas=True))],
    7: [("train", dict(use_pallas=False)), ("train", dict(use_pallas=True))],
    9: [("validate", dict(use_pallas=False)), ("validate", dict(use_pallas=True))],
    13: [("train", dict(use_pallas=False, time_step_end=SCALED_CHECK_END)),
         ("validate", dict(use_pallas=False, time_step_end=SCALED_CHECK_END))],
    16: [(kind, dict(use_pallas=use_pallas, rnn=True)) for use_pallas in (False, True) for kind in ("slice", "train")],
    17: [("slice", dict(use_pallas=True, navi_mode=mode, repredict=repredict, time_step_end=NAVI_CHECK_END,
                        batch_seed=seed))
         for mode, repredict, seed in (("goal", False, 3), ("cmd", False, 3), ("goal", True, 3), ("dest", True, 5))]
    + [("train", dict(use_pallas=True, time_step_end=NAVI_CHECK_END, navi_mode=mode, repredict=repredict,
                      batch_seed=seed, float64_reference=seed == 0))
       for mode, repredict, seed in (("cmd", False, 3), ("goal", True, 3), ("dest", True, 1), ("dest", True, 0))],
    18: [(kind, dict(use_pallas=use_pallas, time_step_end=NAVI_CHECK_END, variant=variant))
         for variant, use_pallas in VARIANT_ARMS for kind in ("slice", "train")],
    19: [(kind, dict(use_pallas=True, time_step_end=NAVI_CHECK_END, variant="scene_centric"))
         for kind in ("slice", "train")]
    + [("train", dict(use_pallas=True, time_step_end=NAVI_CHECK_END, variant="gelu+mean_valid+wdrop"))],
}


def run_card_vs_cpu(phase: int, reference_only: bool = False, which=None) -> None:
    """CARD_VS_CPU[phase]'s checks (`which`: the indices of those to run, default all)."""
    checks = {"slice": check_slice_card_vs_cpu, "train": check_train_step_card_vs_cpu,
              "validate": check_validate_card_vs_cpu}
    for i, (kind, kwargs) in enumerate(CARD_VS_CPU[phase]):
        if which is None or i in which:
            checks[kind](**kwargs, reference_only=reference_only)


# processes that make the card-vs-CPU checks' CPU runs beside the build, each with this many torch threads: the
# reduced configs' CPU runs are bound by one thread's op dispatch, so processes, not threads, spread them (one process
# of 8 threads took 100-117 s of them against the build's 54-58 s on the NVIDIA H100 80GB HBM3 (700.00 W) machines)
CPU_REFERENCE_WORKERS, CPU_REFERENCE_THREADS = 4, 2


def cpu_references_of(checks: list) -> dict:
    """In a process of its own: the CPU runs of `checks` ((phase, index) in CARD_VS_CPU) -> what each kept."""
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    for phase, i in checks:
        run_card_vs_cpu(phase, reference_only=True, which={i})
    return _CPU_REFERENCES


def precompute_cpu_references() -> tuple:
    """Every CARD_VS_CPU check's CPU run, kept for its phase: the host's cores are idle while nvcc builds the
    kernels. The checks go round-robin to CPU_REFERENCE_WORKERS spawned processes. -> (how many, seconds)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    checks = [(phase, i) for phase in CARD_VS_CPU for i in range(len(CARD_VS_CPU[phase]))]
    with ProcessPoolExecutor(CPU_REFERENCE_WORKERS, mp_context=mp.get_context("spawn")) as pool:
        for refs in pool.map(cpu_references_of, [checks[w::CPU_REFERENCE_WORKERS]
                                                 for w in range(CPU_REFERENCE_WORKERS)]):
            _CPU_REFERENCES.update(refs)
    return len(_CPU_REFERENCES), time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's main path needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    header = lambda text: log(f"{text} (at {time.perf_counter() - t_start:.1f} s)")  # noqa: E731
    card = card_line()
    log(f"[1/20] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}; host: "
        f"{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} usable, {torch.get_num_threads()} torch threads")

    t0 = time.perf_counter()
    built = []
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, all at once
        futures = [pool.submit(knn.load_library), pool.submit(knarpe.load_library),
                   pool.submit(knarpe.load_bwd_library)]
        for fut in futures:
            fut.add_done_callback(lambda _: built.append(time.perf_counter() - t0))
        n_refs, t_refs = precompute_cpu_references()
        for fut in futures:
            fut.result()
    header(f"[2/20] build: csrc/knn.cu, csrc/knarpe.cu and csrc/knarpe_bwd.cu in {max(built):.2f} s; beside it the CPU "
           f"runs of {n_refs} card-vs-CPU checks in {t_refs:.2f} s")

    header("[3/20] kernels vs plain versions")
    rows = [check_knn_kernel(), *check_knarpe_kernels()]
    bwd_rows = check_knarpe_bwd_kernels()
    bench_routes = run_bench_knarpe()

    header("[4/20] slice checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    run_card_vs_cpu(4)

    header("[5/20] slice at full width, use_pallas=False")
    run_full_width(card, use_pallas=False)

    header("[6/20] slice at full width, use_pallas=True (the KNARPE attention kernels)")
    counts, routes = run_full_width(card, use_pallas=True, replay_rules=True, warm_up=False)

    header("[7/20] train step checked: reduced-depth fp32 config, 512 polylines, card vs CPU")
    run_card_vs_cpu(7)

    header("[8/20] training at full width, use_pallas=True (the KNARPE kernels and their backwards)")
    train_counts, train_routes, train_bwd_shapes = run_train_full_width(card)

    header("[9/20] validation step: reduced-depth fp32 config card vs CPU, then full width")
    run_card_vs_cpu(9)
    validate_counts = run_validate_full_width(card)
    check_validate_official(card)

    header("[10/20] submission: test_submission at full width, K=128")
    run_submission(card)

    header("[11/20] the training entry point: run.fit card vs CPU, run.main fit / resume / SIGTERM / validate / test")
    fit_counts = run_fit_phase(card)

    header("[12/20] reference-torch goldens: through the kernels and the card's plain path; the flagship through the "
        "reference layout")
    layout_counts = run_golden_phase(card)

    header("[13/20] the scaled preset at full width: eval, training, validation, eval and training through the kernels "
        "(B4, B4-bwd and B2-bwd heads, B2 cluster route); the TL pass past the log, card vs CPU")
    scaled_counts, first_errs, scaled_train = run_scaled_phase(card)

    header("[14/20] the serving entry point (InteractiveSimulator) at full width: use_pallas False and True in turns, "
        "a scripted agent, history, card vs CPU")
    serve_summary, serve_counts = run_serve_phase(card)

    header("[15/20] data parallel: run.main fit on one NCCL rank vs no process group; two ranks on the card over gloo "
        "vs one process on the union batch, and their validation; fsdp and tp on the same two ranks")
    parallel = run_parallel_phase(card)

    header("[16/20] the TrafficBots RNN family at full width: joint_future_pred and a training step through the "
        "kernels; the phase-4 config card vs CPU")
    rnn = run_rnn_phase(card)

    header("[17/20] the navigation family: goal, cmd and dest (re-predicting) card vs CPU at the phase-4 config; goal "
           "with re-prediction at full width, joint_future_pred through the kernels")
    navi = run_navi_phase(card)

    header("[18/20] the variants: categorical latents with a learned prior, stop-line TL tokens and the stacked TL "
           "input at full width, joint_future_pred and a training step through the kernels; every input, TL, pose "
           "and latent variant card vs CPU at the phase-4 config; pose_rpe xy_dir (d_rpe = 4) at full width")
    variants = run_variant_phase(card)

    header("[19/20] the scene-centric model at full width, joint_future_pred and a training step (no kernel); token "
           "dedup against the replicated rollout through the kernels; scene-centric and gelu + mean_valid + "
           "attn_dropout_weights card vs CPU at the phase-4 config")
    scene = run_scene_centric_phase(card)

    header("[20/20] profiling: run.main fit with profile_dir at the phase-4 config (the trace's kernel events vs the "
           "launch counters) and debug_nans; a traced flagship eval call; the validation videos' inputs on the card")
    profiled = run_profiling_phase(card)
    by_route = lambda counts, kernel: {key.split("/")[1]: n for key, n in counts.items() if key.split("/")[0] == kernel}
    for row in rows:
        row["launches"] = counts[row["name"]]
        row["validate_launches"] = validate_counts[row["name"]]  # per full-width validation step (phase 9)
        row["fit_launches"] = fit_counts[row["name"]]  # per full-width fit step at batch 2 (phase 11)
        row["reference_layout_launches"] = layout_counts[row["name"]]  # phase 12 (b)'s call
        # per call or step of phase 13's paths at scaled_config(): eval (a), training (b), validation (c), and the
        # eval call through the kernels (d), whose B4 launches all take the heads route and B2's the cluster route
        row["scaled_launches"] = {path: counts_[row["name"]] for path, counts_ in scaled_counts.items()}
        row["scaled_train_use_pallas_by_route"] = by_route(scaled_train["train_use_pallas"]["by_route"], row["name"])
    for row in rows + bwd_rows:  # per reset and per step of each phase 14 arm, by kernel and by route
        row["serve_launches"] = {arm: {"per_reset": c["reset"][row["name"]], "per_step": c["step"][row["name"]],
                                       "per_reset_by_route": by_route(c["reset_routes"], row["name"]),
                                       "per_step_by_route": by_route(c["step_routes"], row["name"])}
                                 for arm, c in serve_counts.items()}
    for row, key in ((rows[1], "heads_route"), (rows[2], "cluster_route")):  # launches per (d) call, (d)'s first
        row[key].update(launches=scaled_counts["eval_use_pallas"][row["name"]],  # launch's error
                        path_launch_max_abs_err=first_errs[row["name"]])
    # B3's path is the ported bench (phase 3), which reaches it as scripts/bench_knarpe.py reaches the TPU kernel
    rows[3]["heads_route"]["launches"] = bench_routes["knarpe_cross_attention_v3/heads"]
    rows[3]["heads_route"]["launches_path"] = "python -m trafficbotsv15_tpu_torch.utils.bench_knarpe --shape scaled"
    rows[0]["training_shape"]["launches"] = train_counts["knn_xy"]  # B1: 180 at this shape, 1 posterior TL
    b4 = rows[1]  # per eval call (phase 6), and at the training shape per step (phase 8)
    b4["launches_by_route"] = by_route(routes, "knarpe_attention")
    b4["training_shape"].update(launches=train_counts["knarpe_attention"],
                                launches_by_route=by_route(train_routes, "knarpe_attention"))
    for row in bwd_rows:
        row["launches"] = train_counts[row["name"]]
        row["fit_launches"] = fit_counts[row["name"]]
        row["scaled_launches"] = {path: counts_[row["name"]] for path, counts_ in scaled_counts.items()}
        row["scaled_train_use_pallas_by_route"] = by_route(scaled_train["train_use_pallas"]["by_route"], row["name"])
        row["launches_by_route"] = by_route(train_routes, row["name"])
        if row["name"] == "knarpe_cross_attention_bwd":  # of the 368, per step
            row["post_tl_shape"]["launches"] = train_bwd_shapes[("knarpe_cross_attention_bwd", str(torch.bfloat16),
                                                                 *POST_TL_X_PATH)]
    # per (f) step, by full shape: the scaled training path's launches of each row timed at its shapes; B4-bwd's heads
    # route with the error of (f)'s first B4 backward launch
    by_shape, bf = scaled_train["train_use_pallas"]["by_shape"], str(torch.bfloat16)
    for part, kernel, shape in (
            (rows[1]["heads_route"]["scaled_training_shape"], "knarpe_attention", SCALED_TRAIN_ATTN_PATH),
            (rows[2]["cluster_route"]["scaled_training_shape"], "knarpe_cross_attention", SCALED_TRAIN_X_PATH),
            (bwd_rows[1]["scaled_training_shape"], "knarpe_cross_attention_bwd", SCALED_TRAIN_X_PATH),
            (bwd_rows[1]["scaled_post_tl_shape"], "knarpe_cross_attention_bwd", SCALED_POST_TL_X_PATH)):
        part["launches"] = by_shape[(kernel, bf, *shape)]
    for row in bwd_rows:  # launches per (f) step, all on the heads route, and (f)'s first launch's error
        row["heads_route"].update(launches=scaled_counts["train_use_pallas"][row["name"]],
                                  path_launch_max_abs_err=first_errs[row["name"]])
    for row in rows + bwd_rows:  # per phase 16 (a) call and (c) step, per phase 17 (b) call, per phase 18 (a) call
        row["rnn_launches"] = {"eval_call": rnn["eval"][row["name"]], "train_step": rnn["train"][row["name"]]}
        row["navi_launches"] = {"eval_call": navi["eval"][row["name"]]}
        xy_dir = variants["xy_dir"]  # and per phase 18 (c) call and step (pose_rpe "xy_dir", d_rpe = 4)
        row["variant_launches"] = {"eval_call": variants["eval"][row["name"]],  # and step, by route
                                   "train_step": variants["train"][row["name"]],
                                   "eval_call_by_route": by_route(variants["eval_by_route"], row["name"]),
                                   "train_step_by_route": by_route(variants["train_by_route"], row["name"]),
                                   "xy_dir_eval_call": xy_dir["eval"][row["name"]],
                                   "xy_dir_train_step": xy_dir["train"][row["name"]],
                                   "xy_dir_eval_call_by_route": by_route(xy_dir["eval_by_route"], row["name"]),
                                   "xy_dir_train_step_by_route": by_route(xy_dir["train_by_route"], row["name"])}
        for part in row.get("rpe4_shapes", []):  # each d_rpe = 4 shape's launches per (c) call and step
            key = (row["name"], str(torch.bfloat16), *part["shape"])
            part["launches"] = {"xy_dir_eval_call": xy_dir["eval_by_shape"].get(key, 0),
                                "xy_dir_train_step": xy_dir["train_by_shape"].get(key, 0)}
        row["scene_centric_launches"] = {"eval_call": scene["eval"][row["name"]],  # phase 19 (a) and (b)
                                         "train_step": scene["train"][row["name"]],
                                         "dedup_eval_call": scene["dedup"][row["name"]]}
        row["profiled_fit_launches"] = profiled["fit"]["launches_per_step"][row["name"]]  # phase 20 (a)
    rows += bwd_rows
    for row in rows:
        for key, val in row.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"kernels line: {row['name']} {key} is not finite")

    if _CPU_REFERENCES:
        raise AssertionError(f"CPU runs made beside the build that no check read: {list(_CPU_REFERENCES)}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"serve": serve_summary}))
    print(json.dumps({"kernels": rows, "parallel": parallel,
                      "rnn": {k: v for k, v in rnn.items() if k not in ("eval", "train")},
                      "navi": {k: v for k, v in navi.items() if k != "eval"},
                      "variants": {**{k: v for k, v in variants.items() if k not in ("eval", "train", "xy_dir")},
                                   "xy_dir": {k: v for k, v in variants["xy_dir"].items()
                                              if k not in ("eval", "train", "eval_by_shape", "train_by_shape")}},
                      "scene_centric": {k: v for k, v in scene.items() if k not in ("eval", "train", "dedup")},
                      "profiling": {"fit": {k: v for k, v in profiled["fit"].items() if k != "launches_per_step"},
                                    **{k: v for k, v in profiled.items() if k != "fit"}}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
