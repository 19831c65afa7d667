#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (easyrec_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:
  1. device  the card's name, count, and nvidia-smi's name and power limit;
  2. build   the CUDA kernels from easyrec_torch/csrc with nvcc for
             sm_90a (one nvcc per source, started together), with ptxas's
             report;
  3. kernels each kernel against its plain PyTorch version on the card:
             K1 at the flagship shape (a DummyInput batch of the Criteo
             DeepFM: 39 id slots per example at batch 4096, dim 32, 26M-row
             table) and the Taobao DIN's (a synthetic batch: 115 id slots
             per example at batch 4096, two padding segments of ~100k
             slots, dim 16, 620k-row table); K2 with every block math
             (sgd, momentum, Adagrad, 3-part Adam, compact Adam, FTRL) at
             the flagship shape; K1 in every mode and K2 (compact Adam) at
             the Taobao MMoE's (116 id slots per example at batch 4096,
             dim 16, so K2 runs four lanes a row); K3 with every block math at the DIN shape
             and at dim 256; K2 and K3 with the EV maths (ev_add, ev_set)
             on the [210,002, 1] aux table of the EV sample (phase 10's
             shape); K7 (bag pooling, forward and backward) at the
             DLRM-DCNv2 cell's 16,384 x 214 x 128 in 26 bags
             (phase_bag_pool); all bit-exact, with times from CUDA events
             beside bounds, the plain versions' times and the library
             yardsticks;
  4. groups  K4 (group push) and K5 (group RMW) against their plain
             versions at the ported benchmarks' shapes (K4: 106,496 slots
             into [406,252, 8, 128]; K5: 98,304 groups of a 5 GB
             [406,252, 8, 384] table, and the 106,496 slots with gg),
             with times; then every easyrec_torch.benchmarks main() at its
             full shape and experimental_packed_update at a small one:
             every correctness line must read true, K4 and K5 must
             launch, K1-K3 must not;
  5. agree   a small DeepFM trains 3 steps on the card and on the CPU from
             the same weights and batches once per optimizer message (Adam
             compact and 3-part, Adam with use_moving_average, AdamW,
             Adagrad, momentum, momentumW, RMSProp, FTRL), unfused (K1 +
             K2) and fused (K3), and a small DIN (K3): losses, table
             weights and EMA weights must agree, and K2/K3 must launch
             with the optimizer's block math; f32 losses that part are
             held by kink_witness (the first parting a ReLU input at
             zero, within KINK_RTOL) or fail;
  6. din     the Taobao DIN config through easyrec_torch.main
             .train_and_evaluate at full width with EASYREC_PACKED_FUSED=1
             (num_steps cut to 20; eval runs DummyInput's cap of 50
             batches): K3 (compact Adam) must launch once per step and
             table, K1 and K2 not at all; then the steady-state train-step
             rate over pre-built synthetic batches;
  7. deepfm  the flagship config the same way, unfused, from Criteo's
             binary layout (phase 31 drives it): K1 and K2 (compact Adam)
             once per step and table, K3 not at all; then its rate;
  8. adagrad the flagship with Adagrad tables and Adam dense weights
             (flagship.criteo_deepfm_adagrad_config; the table is [w |
             accum], 6.66 GB) the same way: K1 and K2 (Adagrad) once per
             step and table, K3 not at all; then its rate.
K4 and K5 must launch 0 times in 6-8.
  9. ckpt    the full-width Taobao DIN (K3), unshuffled: a Trainer fits 20
             steps with saves at 10 and 20; a fresh Trainer on the same
             model_dir, its step-20 checkpoint removed, restores step 10 and
             fits to 20, and must equal the uninterrupted run bit for bit
             (step, tables, model, dense optimizer); then a timed save and
             restore, with the checkpoint's size;
 10. ev      samples/deepfm_ev_params.config at its published widths
             through train_and_evaluate, cut to 40 steps with a save (and
             TTL sweep) every 10 and steps_to_live 10, on generated data
             whose ids move halfway: K1 + K2 and K3, each on the card and
             the CPU; ev_add and ev_set once a step each, rows admitted,
             slots masked and rows evicted above zero, counters exact card
             against CPU (phase_ev says how the tables are held);
 11. kernel-only K1, K2 (compact Adam and Adagrad) at the flagship shape,
             K3 and K1 + K2 at the DIN shape and K2 and K3 with the EV maths
             at the EV shape, their kernels alone, timed by torch.profiler
             on the inputs of phase 3 (the kernels launched inside each
             call's window, never the L2 flush before it; a sum above the
             wrapper's event time is logged as not measured), after the
             slices because the profiler stays hooked into the process
             once it has traced the card.
 12. serve   (run between 10 and 11: the profiler slows what follows it)
             the flagship DeepFM at full width: train_and_evaluate on a
             model_dir (20 steps, one save; the checkpoint and the 'final'
             export timed, with their bytes), main.export of the
             checkpoint (equal to the final export bit for bit), then
             PredictorService on the card: load and warmup timed, 10
             timed requests each of 1, 256 and 4096 raw rows (p50, p99,
             rows/s), answers equal to the Trainer's eval forward, /status
             counting them, K1-K5 launched 0 times; then the Taobao DIN
             on a seeded CSV, exported and predicted by predict_csv with
             reserved columns on the card and the CPU (probs within 1e-5,
             reserved columns as in the input);
 13. bst     (run after 8, before 9) the Taobao BST (MultiTowerBST, the
             two histories concatenated into hidden 32, 4 heads, 51
             tokens): a small BST (batch 256, histories of 8) trains 3
             steps on the card and the CPU from one state, unfused and
             fused, under EASYREC_ATTN_IMPL=stock, at the agree phase's
             rule; the full-width BST's eval forward under the default
             vpu_bf16 (and stock) card against CPU from one state, within
             1% of the logits' scale (bf16 payloads round apart where the
             two devices' f32 values straddle a rounding boundary); then
             the full-width BST through train_and_evaluate, unfused (K1 +
             K2, compact Adam) as phase 6 drives the DIN, with its rate and
             peak memory; then a 5-step BST on a seeded CSV exported, and a
             Predictor on the card whose answers at 1 and 4,096 rows must
             bit-equal the training Trainer's eval forward, with no K1-K5
             launch.
 14. mt      (run after 13, before 9) the multi-task family: a small form
             of SimpleMultiTask, MMoE, ESMM, DBMTL and PLE on the Taobao
             schema (batch 256, histories of 8, labels clk and buy) trains
             3 steps on the card and the CPU from one state, unfused and
             fused, at the agree phase's rule; its eval (`auc`, each
             `auc_<task>`, ESMM's `auc_ctcvr` too, and the loss) is held
             card against CPU from the shared state before the steps and
             from the card's trained state after them;
 15. mmoe    the full-width Taobao MMoE (flagship.taobao_mmoe_config,
             mmoe_on_taobao: 4 experts and two towers of [256, 192, 128,
             64] over a 288-wide input) through train_and_evaluate, unfused
             (K1 + K2, compact Adam, once a step each), with its rate,
             launches a step, peak memory, `auc`, `auc_ctr` and `auc_cvr`;
 16. serve mmoe  a 5-step MMoE on a seeded CSV with clk and buy exported,
             PredictorService on the card answering 1 and 4,096 rows over
             HTTP, every output bit-equal to the training Trainer's eval
             forward, with no K1-K5 launch.
 17. zoo     (run after 16, before 9) the classic rank zoo: a small form of
             WideAndDeep, DCN, AutoInt, DLRM, FM, RocketLaunching and a
             DeepFM with deepfm_multi_loss's Uncertainty-weighted terms on
             the flagship Criteo schema (3 raw and 6 id features of 1,000
             buckets, batch 256) trains 3 steps on the card and the CPU
             from one state, unfused and fused, at the agree phase's rule;
             its eval (`auc`, `max_f1`, the loss) is held card against CPU
             from the shared state and from the card's trained state;
 18. dlrm    the full-width Criteo DLRM (flagship.criteo_dlrm_config:
             benchmarks/quality.py's DLRM on the flagship schema, one
             [26,000,014, 16] table, bot_dnn [64, 32, 16], top_dnn [256,
             128, 64]) through train_and_evaluate, unfused (K1 + K2,
             compact Adam, once a step each), with its rate, launches a
             step, id slots a step and peak memory;
 19. serve dlrm  a 5-step DLRM at full width exported, PredictorService on
             the card answering 1 and 4,096 raw rows over HTTP, logits and
             probs bit-equal to the training Trainer's eval forward, with
             no K1-K5 launch.
 20. backbone (run after 19, before 9) the backbone DSL: each of the 20
             backbone samples and the three variational_dropout samples,
             small (batch 256, the sample's own features and tables),
             trains 3 steps on the card and the CPU from one state,
             unfused, and dlrm_backbone and aitm_backbone fused as well,
             at the agree phase's rule, their dropout rates set to 0 and
             the attention under EASYREC_ATTN_IMPL=stock (as phase 13);
             cl4srec_backbone, whose SeqAugment draws in training, has
             its eval held card against CPU from the shared state and its
             3 steps on each side launching K2 and finite;
 21. dlrm backbone  the full-width Criteo DLRM built by the backbone DSL
             (flagship.criteo_dlrm_backbone_config, samples/
             dlrm_backbone.config's blocks on phase 18's schema and table)
             through train_and_evaluate, unfused (K1 + K2, compact Adam,
             once a step each), with its rate, launches a step and peak
             memory; this slice's main path;
 22. serve dlrm backbone  as 19, for the backbone DLRM.
 23. match   (run after 22, before 9) the match family: each of its 19
             samples (DSSM, DSSM_SENet, DAT, MIND, MultiTowerRecall,
             DropoutNet, PDN, CoMetricLearningI2I, the backbone
             MatchModel, and kd_backbone), small (batch 256, hash buckets
             at most 1,000, the sample's own features) on its own input
             pipeline's batches of write_dssm_data's files (1,000 items,
             300 users, a sampler's neg. and hard_neg. views in them),
             trains 3 steps on the card and the CPU from one state,
             unfused, and dssm_neg_sampler fused as well, at the agree
             phase's rule, MIND's routing logits and DropoutNet's
             preference dropout at 0 and the learning rate 0.0001
             (MATCH_EDITS says why); the eval (auc, recall@k, the
             errors) held card against CPU through hold_evals;
 24. dssm    this slice's main path: samples/dssm_neg_sampler.config at
             its published widths (batch 1,024 with 1,024 sampled
             negatives a step, uid and iid of 1,000,000 buckets, cate of
             10,000, tags of 100,000 up to 8 a row, dim 16, towers [256,
             128, 64], inner product at temperature 0.1 with the item-id
             collision mask, compact Adam) on write_dssm_data's generated
             train and eval CSVs and 1,000,000-item items.txt: K1 and K2
             at its mixed pack (the base batch's ids, then the neg.
             view's, in one stream) bit-exact against their plain
             versions, with times, bounds, the plain versions' and
             index_add_'s; then train_and_evaluate, unfused, num_steps cut
             to 20, on phase 26's model_dir (since PR 16): K1 and K2 (compact Adam) once a step and table over
             both views' ids, K3-K5 never; its rate over its own
             pipeline's batches, launches and id slots a step, peak memory
             and the eval's auc; the run sets train_config.is_profiling,
             so fit writes its first logging window's torch.profiler trace
             into model_dir/profile: it must hold an easyrec.step span a
             step, every span of the step and device kernels;
 25. serve dssm  (inside 26, on its export since PR 16) PredictorService
             on the card answering 1 and 4,096 raw rows over HTTP, user_emb
             and item_emb bit-equal to the training Trainer's eval forward,
             with no K1-K5 launch.
 26. retrieve this slice's main path: the full-width DSSM on phase 24's
             files, trained SLICE_STEPS steps through train_and_evaluate on
             a model_dir (K1 + K2) by phase 24 (its own run before PR
             16), main.export and split_model's user and
             item towers (the export served as phase 25 says); the item
             tower's Predictor embeds all 1,000,000
             items of items.txt (calls of 4,096 rows) into a [1,000,000,
             64] corpus and the user tower's the 8,192 eval rows, both
             towers' embeddings of 4,096 rows bit-equal to the Trainer's
             eval forward; a KnnIndex on the card searches the corpus for
             every user's top-10 and top-100 in query batches of 1,024
             (the index's batch for 1,000,000 items; hitrate@k by each
             row's true item, recorded), the top-k of 256 users held
             against a float64 numpy ranking, one batch's search timed
             beside the bound of its function and that of the
             materialised scores; the hitrate CLI on the
             model_dir equal to compute_hitrate in process; the
             vector_retrieve CLI over a 20,000-row doc table written from
             the corpus equal to the in-process search; no K1-K5 launch
             from the export on; the embed, index and search times and
             peak memory logged.
 27. rank extra  (run after 26, before 9) the rest of the rank zoo: each of
             CMBF's and Uniter's samples (image-only and text-only
             variants, cmbf_multi_loss), dbmtl_cmbf, dbmtl_uniter,
             losses_pairwise, deepfm_ziln, deepfm_multi_cls,
             gauc_session_metrics (with precision, recall and accuracy),
             multi_optimizer_freeze and deepfm_bf16, small (batch 256,
             hash buckets at most 1,000, the sample's own features) on its
             pipeline's batches of write_rank_csv's files, trains 3 steps
             on the card and the CPU from one state, unfused, and cmbf
             fused as well, at the agree phase's rule (deepfm_bf16 at its
             bf16 rule, beside its control at f32), the attention under
             EASYREC_ATTN_IMPL=stock, Uniter's dropouts at 0, at the
             samples' rate 0.001 but dbmtl_cmbf's, cut to 0.0001
             (RANK_EXTRA_RATES; rate_witness logs its readings at 0.001);
             the evals held card against CPU through hold_evals, and
             deepfm_ziln's probabilities and expected values.
 28. feature samples  (run after 27) the samples of the remaining feature
             types, fg.json and incremental saves (combo_cross,
             expr_feature, lookup_feature, taobao_fg, deepfm_incr_save,
             ev_incr_save), small (batch 256, hash buckets at most 1,000,
             the sample's own features) on their pipelines' batches of
             write_rank_csv's or write_fg_data's files, train 3 steps on
             the card and the CPU from one state at the agree phase's
             rule, unfused, and ev_incr_save fused as well; the two
             incremental samples publish after each step on both sides,
             and their updates' ids must be equal card against CPU.
 29. fg din  this slice's main path: samples/taobao_fg.config with
             samples/fg/taobao_fg.json unchanged (batch 1,024; hash
             buckets 100,000 for user_id, adgroup_id, brand and the
             uid_x_cate combo, 10,000 for cate_id and tags; price in 5
             buckets; click_seq 50 long; dim 16; towers [128, 64]) on
             write_fg_data's generated CSVs (fg column order, Zipf-skewed
             ids): K1 in every mode and K2 (compact Adam) bit-exact
             against their plain versions on its first batch's pack, with
             their times, bounds, the plain versions' and index_add_'s;
             then through train_and_evaluate on a model_dir with its
             fg_json_path, unfused: K1 and K2 (compact Adam) once a step,
             K3-K5 never; its rate over its own pipeline's batches,
             launches a step, peak memory, the host time of the combo
             feature's transform; its export served by PredictorService,
             1 and 1,024 of the eval rows bit-equal to the Trainer's eval
             forward.
 30. incr big  (inside phase 12, on its model_dir) the flagship DeepFM
             continues from its step-20 checkpoint to step 30 with
             samples/deepfm_incr_save.config's incr_save_config every 5
             steps (to step 40 every 10 before PR 16): a base snapshot at
             20, updates at 25 and 30 (and the empty one of the final
             publish), each update's ids exactly the rows the batches of
             its 5 steps touched; the JAX
             design's host copy and diff of the table timed beside the
             port's device diff; step 20 exported with big_model; a
             Predictor on the card memory-maps the export, consumes the
             updates and must answer as the Trainer's eval forward at step
             30 (bit for bit, or within 1e-6); its latency at 1, 256 and
             4,096 rows beside the in-memory Predictor's of the step-30
             export; no K1-K5 launch while it serves.
 31. criteo binary  (phase 7's place) the flagship
             DeepFM unchanged (criteo_deepfm_config) from CriteoInput files:
             write_criteo_days writes 94,208 rows of day TSVs from seeds
             (blanks, ids of 0x80000000 and above; 21 train and 2 eval
             batches), tools/criteo_convert packs them (15,073,280 bytes;
             s, rows/s), CriteoBinaryReader
             reads them back (rows/s, the wrapped ids negative); K1 and K2
             bit-exact on one batch of this path; phase_slice with the eval
             on day_1.bin, inside it the export and tools/predict_and_chk
             equal to the Trainer's eval forward (tolerance 0);
             tools/pre_check on the config and two batches, tools/
             view_export of the export with its synthetic row on the card.
 32. kafka din  (after 9) the Taobao DIN at its published widths, batch
             1,024, fused (K3), from an in-process broker (MockBroker, a
             copy of tests/kafka_mock.py on the port's codec) whose 4
             partitions tools/kafka_topic fills with 28.3 steps of rows: 10
             steps with a save and data_offset.json, a fresh Trainer
             resumed from those offsets to 20, equal bit for bit in every
             state tensor (and in data_offset.json) to 20 uninterrupted
             steps; K3 once a step; the write and drain rows/s.
 33. small readers  (after 32) RTPInput, an ODPS table's CSV export and
             DataHubInput (resumed from a pipeline's last_batch_offsets,
             equal to the first pipeline's next batches), each a small
             DeepFM card against CPU (phase 5's rule); two random trials of
             hpo/tuner.py on the card and the CPU, with the same parameters.
 34. sharded  (after 31) this slice's main path: in a process of its own
             (parallel/launch.py), a world of one rank over NCCL; the
             flagship DeepFM at full width (the [26,000,014, 32] table,
             batch 4,096) under train_distribute EmbeddingParallelStrategy,
             20 steps through ep_pull_sharded, all_to_all_single and
             packed_update_sharded (K1 twice a step: the local dedup and
             the owner's sum; K2 once), against the unsharded path's 20
             steps from the same step-0 state and batches: losses and
             table bits equal (else the agree phase's rule); ms/step of
             both, the exchange's ms a step, both overflow counts (0), peak
             memory; K1 and K2 bit-exact against their plain versions on
             this path's inputs; then the Taobao DIN's checkpoint written
             in the world restored on one device, equal in every state
             tensor.
 35. parquet dlrm  (after 31, before 34) this slice's main path: the
             Criteo DLRM at full width (flagship.criteo_dlrm_config, the
             [26,000,014, 32] table, batch 4,096) fed from Parquet:
             phase 31's 94,208 rows written as Parquet files by this
             script's write_parquet (the card's machine has no pyarrow:
             PLAIN and RLE_DICTIONARY pages, uncompressed and snappy, two
             row groups, blanks null), day_1 also as a TSV; the CSV and
             Parquet readers' rows/s on day_1 alone and with the
             transforms, every Parquet batch of day_1 equal to the CSV
             pipeline's; K1 and K2 bit-exact on one batch of this path;
             train_and_evaluate 20 steps from day_0.parquet (K1 and K2 once
             a step), the eval on day_1.parquet.
 36. pod tools  (after 34) tools/aot_pod_check --world 8: a world of 8
             gloo processes on the card's host runs the row-sharded
             flagship step (its checks; each rank's memory at the run's
             and at full width), then K1 and K2 on the card at rank 0's
             owner shapes for that world at full width, bit-exact, with
             their times; tools/scaling_model's world of 8 at 4,096
             buckets (the JAX tool's default; the full table cut, see
             SCALING_BUCKETS) and 4,096 rows a rank, projected from phase
             34's sharded ms/step.
 37. gates   (after 12, before 11) the JAX package's learnability gates
             on the card: first K1 (every mode), K2 and K3 (compact Adam)
             bit-exact against their plain versions on the ids of the
             first batch of 256 rows of the FM gate (table dim 16, 9
             used) and of the MMoE gate (dim 8); then the port's
             Trainer.fit on the gates' own files,
             configs, steps and bars (tests/test_torch_learnability_data.py,
             a JAX-free copy of tests/test_learnability*.py's): FM on K1 +
             K2 and fused on K3, the DeepFM at f32 and under compute_dtype
             bfloat16 (its eval loss apart from the f32 run's),
             MultiTowerDIN, MMoE, ESMM, MIND recall@5 and DSSM pointwise,
             each above its Bayes-derived bar; FM with its tables'
             learning rate 0 (K1 + K2 still launched) under the bar; FM on
             the CPU within GATE_CPU_STDS stds of the card's AUC; each
             gate's kernels once a step and table.
Then one JSON line of kernel numbers, nvidia-smi's line, and as the last
line {"ok": true, "device": {...}}.
"""

import collections
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 outside the tensor
# cores; every bound below is computed from these and this run's inputs
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SLICE_STEPS = 20
RATE_STEPS = 10
BF16_ULP = 2.0 ** -7      # the spacing of bf16's 8-bit significands
# the bf16 rule of a bf16 compute_dtype model, card against CPU (ROADMAP's
# known divergences): its eval logits within BF16_LOGIT_TOL of their scale
# (deepfm_bf16 read 9.5e-5, its control at f32 6.4e-3), its losses within
# BF16_LOSS_RTOL relative (1.79e-3; the control 3.24e-3), at most 1 in
# BF16_FAR_SHARE table weights past 1e-5 (7,310 of 128,096; the control
# 8,211: the count does not tell the two apart). NVIDIA H100 80GB HBM3,
# 700 W, at the sample's rate 0.001
BF16_LOGIT_TOL = BF16_ULP / 8
BF16_LOSS_RTOL = 2.5e-3
BF16_FAR_SHARE = 10


def fail(msg):
  print('chip_smoke: FAIL: %s' % msg, file=sys.stderr, flush=True)
  sys.exit(1)


# when main() started; each log line carries the seconds since
STARTED = [None]


def log(msg):
  if STARTED[0] is not None:
    msg = '[%.1f s] %s' % (time.time() - STARTED[0], msg)
  print(msg, flush=True)


def nvidia_smi_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, flush):
  """Mean device time of fn() over reps launches, each after a write of a
  buffer larger than L2 so the call finds its inputs cold."""
  fn()
  torch.cuda.synchronize()
  total = 0.0
  for _ in range(reps):
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    total += start.elapsed_time(end)
  return total / reps


def bound_ms(nbytes, nops):
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = nops / F32_OPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


# wrapper calls whose kernels torch.profiler times after the slices: once
# the profiler has traced the card it stays hooked into the process, so the
# step rates are taken first. (label, event ms, bound ms, call, a function
# that makes the call's inputs on the card)
KERNEL_ONLY = []


def queue_kernel_only(label, event_ms, bound, call, make=None, **tensors):
  """Queue `call` for phase_kernel_only: on `make()`'s inputs, or on copies
  of `tensors` kept on the host until then."""
  if make is None:
    host = {k: v.cpu() for k, v in tensors.items()}
    make = lambda: {k: v.cuda() for k, v in host.items()}  # noqa: E731
  KERNEL_ONLY.append((label, event_ms, bound, call, make))


def phase_kernel_only(torch):
  """The queued wrapper calls again, on their inputs remade on the card,
  under torch.profiler: the kernels' own device time beside the event
  time of the whole wrapper and the bound."""
  from easyrec_torch.tools.time_update import kernel_times
  flush = torch.empty(64 << 20, dtype=torch.float32, device='cuda')
  for label, event_ms, bound, call, make in KERNEL_ONLY:
    dev = make()
    total = log_kernel_ms(label, kernel_times(torch, lambda: call(**dev),
                                              20, flush), event_ms, bound)
    if total is not None:
      log('%s: kernels only %.2f x the bound (%.4f ms)'
          % (label, total / bound, bound))
    del dev
    torch.cuda.empty_cache()
  del flush
  torch.cuda.empty_cache()


def log_kernel_ms(what, by_name, event_ms, bound):
  """One line: the kernels' summed device time beside the event time of
  the whole wrapper, and each kernel's share. A sum above the event time
  is not the kernels' alone, and a sum under the bound is not all of
  them (no kernel moves its bytes faster than the card's bandwidth, nor
  does its operations faster than its peak): each is logged as not
  measured."""
  if not by_name:
    log('%s: kernel-only time not measured (the profiler recorded no '
        'device time); event time %.4f ms' % (what, event_ms))
    return None
  total = sum(by_name.values())
  if total > event_ms:
    log('%s: kernel-only time not measured (the profiler\'s sum %.4f ms '
        'exceeds the event time of the wrapper %.4f ms; %s)'
        % (what, total, event_ms, '; '.join(
            '%s %.4f' % (k[:60], v) for k, v in by_name.items())))
    return None
  if total < bound:
    log('%s: kernel-only time not measured (the profiler\'s sum %.4f ms is '
        'under the bound %.4f ms: it lacks some of the calls\' kernels; '
        'event time of the wrapper %.4f ms)' % (what, total, bound,
                                                 event_ms))
    return None
  log('%s: kernels only %.4f ms a call (profiler), event time of the '
      'wrapper %.4f ms; %s' % (what, total, event_ms, '; '.join(
          '%s %.4f' % (k[:60], v) for k, v in sorted(
              by_name.items(), key=lambda kv: -kv[1]))))
  return total


def block_maths():
  """Every block math of K2 and K3, as the kernel phases drive it: (name,
  optimizer, compact layout, f32 operations an element of the math, for
  the bound). Constants off their defaults so every term of the math
  runs (Adam's weight decay, FTRL's l1, l2 and shrinkage); the flagship's
  compact Adam and the Adagrad of its Adagrad-tables path at theirs."""
  from easyrec_torch.optim import sparse
  return [('sgd', sparse.SparseSGD(), False, 2),
          ('momentum', sparse.SparseMomentum(0.8), False, 4),
          ('adagrad', sparse.SparseAdagrad(), False, 8),
          ('adam', sparse.SparseAdam(weight_decay=0.01), False, 17),
          ('compact_adam', sparse.SparseAdam(), True, 14),
          ('ftrl', sparse.SparseFtrl(l1=0.01, l2=0.02, l2_shrinkage=0.05),
           False, 20)]


def math_table(torch, layout, key, rows, dim, opt, compact, gen):
  """A [rows, P*dim] table of `opt`'s layout on the card: the layout's
  initial weights, then slots drawn chunk by chunk (Adam moments small
  with v >= 0, accumulators at least 0.1, FTRL's z of either sign)."""
  from easyrec_torch.optim.sparse import pack_pair
  dev = torch.device('cuda')
  width = (2 if compact else opt.n_parts) * dim
  table = torch.empty((rows, width), device=dev)
  if layout is not None:
    layout.init_weights(key, 7, dev, table)
  else:
    table[:, :dim] = torch.randn((rows, dim), generator=gen, device=dev)
  for lo in range(0, rows, 1 << 22):
    hi = min(rows, lo + (1 << 22))
    slots = []
    for name in opt.slot_names:
      shape = (hi - lo, dim)
      slots.append(
          torch.rand(shape, generator=gen, device=dev) * 1e-6
          if name == 'v' else
          0.1 + torch.rand(shape, generator=gen, device=dev) * 0.5
          if name == 'accum' else
          torch.randn(shape, generator=gen, device=dev) *
          (0.05 if name == 'z' else 1e-3))
    if compact:
      slots = [pack_pair(slots[0], slots[1])]
    for p, part in enumerate(slots, 1):
      table[lo:hi, p * dim:(p + 1) * dim] = part
  return table


def phase_kernels(torch):
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship

  dev = torch.device('cuda')
  trainer = Trainer(flagship.criteo_deepfm_config(), device='cuda')
  batch = next(iter(trainer.train_input()))
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch, dev))
  (key, meta), = trainer.metas.items()
  used = trainer.layout.tables[key].used_dim
  ids = packs[key].reshape(-1)
  n, dim = ids.shape[0], meta.dim
  log('kernel shapes: table %s [%d, %d] f32, %d id slots, dim %d (%d used)'
      % (key, meta.rows, meta.width, n, dim, used))

  gen = torch.Generator(device=dev).manual_seed(1234)
  grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
  grads[:, used:] = 0.0                 # alignment lanes carry no gradient
  grads[::97] = 0.0                     # zero-sum rows stay untouched
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB

  sids, order, starts = pt.sort_segments(ids)
  n_seg = int((starts[:n] < n).sum())
  results = []

  # -- K1: segmented gradient sum, every EASYREC_GG_BF16 mode, bit-exact
  err1 = check_seg_sum(torch, pt, sids, order, starts, grads, meta.sentinel,
                       'flagship shape')
  log('seg_sum: %d segments, bit-exact against the plain version in modes '
      '0, mix and 1 (tolerance 0: the same f32 additions in the same order)'
      % n_seg)
  k1_ms = cuda_ms(torch, lambda: pt.seg_sum(sids, order, starts, grads,
                                            meta.sentinel, '1'), 20, flush)
  k1_plain = cuda_ms(torch, lambda: pt.seg_sum_plain(
      sids, order, starts, grads, meta.sentinel, '1'), 2, flush)
  first = torch.ones(n, dtype=torch.bool, device=dev)
  first[1:] = sids[1:] != sids[:-1]
  seg_of_slot = torch.empty(n, dtype=torch.int64, device=dev)
  seg_of_slot[order] = torch.cumsum(first, 0) - 1
  acc = torch.zeros((n, dim), device=dev)
  k1_lib = cuda_ms(torch, lambda: acc.index_add_(0, seg_of_slot, grads),
                   20, flush)
  del acc
  k1_bytes = (n + 1) * 8 + n * 8 + n * dim * 4 + n_seg * 8 + \
      n * 8 + n * dim * 4
  k1_bound, k1_by = bound_ms(k1_bytes, n * dim)
  log('seg_sum: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.3f ms, index_add_ %.4f ms; %s than index_add_'
      % (k1_ms, k1_bound, k1_bytes, k1_plain, k1_lib,
         'no slower' if k1_ms <= k1_lib else 'SLOWER'))
  sentinel = meta.sentinel
  queue_kernel_only(
      'seg_sum (flagship, mode 1)', k1_ms, k1_bound,
      lambda sids, order, starts, grads: pt.seg_sum(sids, order, starts,
                                                    grads, sentinel, '1'),
      sids=sids, order=order, starts=starts, grads=grads)
  results.append(dict(
      name='seg_sum', route='cuda', source='easyrec_torch/csrc/seg_sum.cu',
      replaces='easyrec_tpu/ops/packed_table.py:301', max_abs_err=err1,
      ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
      library_ms=k1_lib))

  # -- K2: row read-modify-write, every block math, at the flagship shape
  uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '1')
  live = uids < meta.rows
  touched_slot = live & (gsum != 0).any(dim=1)
  n_touched = int(touched_slot.sum())
  log('rmw_rows inputs: %d touched rows, %d live untouched (zero-sum) '
      'slots, %d sentinel slots' % (n_touched,
                                    int((live & ~touched_slot).sum()),
                                    n - n_seg))
  k2_compact = None
  for name, opt, compact, ops in block_maths():
    table = math_table(torch, trainer.layout, key, meta.rows, dim, opt,
                       compact, gen)
    width = table.shape[1]
    hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                        torch.tensor(3, dtype=torch.int32, device=dev))
    err = check_rmw_rows(torch, pt, table, uids, gsum, hypers, opt, name)
    ms = cuda_ms(torch, lambda: pt.rmw_rows(table, uids, gsum, hypers,
                                            opt), 20, flush)
    plain = cuda_ms(torch, lambda: pt.rmw_rows_plain(table, uids, gsum,
                                                     hypers, opt), 3, flush)
    nbytes = n * 8 + opt.n_hypers * 4 + n_seg * dim * 4 + \
        n_touched * width * 4 * 2
    bound, by = bound_ms(nbytes, n_touched * dim * ops)
    log('rmw_rows (%s, [%d, %d]): bit-exact against the plain version '
        '(tolerance 0); %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s, %.2f '
        'x the compact Adam row), %.2f x the bound, plain %.3f ms'
        % (name, meta.rows, width, ms, bound, nbytes,
           width / (2.0 * dim), ms / bound, plain))
    queue_k2(torch, pt, trainer.layout, key, meta, name, opt, compact, ms,
             bound, uids, gsum, hypers)
    if name == 'compact_adam':
      k2_compact = (table, ms, bound, opt, hypers)
    else:
      del table
    torch.cuda.empty_cache()
    results.append(dict(
        name='rmw_rows/%s' % name, route='cuda',
        source='easyrec_torch/csrc/rmw_rows.cu',
        replaces='easyrec_tpu/ops/packed_table.py:701', max_abs_err=err,
        ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
        library_ms=None))

  # -- K3 (compact Adam) at the flagship shape: 13 segments of 4,096 slots
  table, k2_ms, k2_bound, opt, hypers = k2_compact
  _, _, err3f = check_fused(torch, pt, table, sids, order, starts, grads,
                            hypers, opt, 'flagship, compact_adam')
  k3f_ms = cuda_ms(torch, lambda: pt.rmw_fused(
      table, sids, order, starts, grads, hypers, opt), 20, flush)
  log('rmw_fused (compact_adam) at the flagship shape: %.4f ms (K1 + K2 '
      'above: %.4f ms)' % (k3f_ms, k1_ms + k2_ms))
  del table, flush, grads, uids, gsum
  torch.cuda.empty_cache()
  k3 = phase_kernel_din(torch)
  for r in k3:
    if r['name'] == 'rmw_fused/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err3f)
  # the main paths' own shapes: the MMoE's and the DLRM's dim-16 tables
  errs = [phase_kernel_path(torch, flagship.taobao_mmoe_config(), 'MMoE'),
          phase_kernel_path(torch, flagship.criteo_dlrm_config(), 'DLRM')]
  results[0]['max_abs_err'] = max([err1, k3[0].pop('seg_sum_din_err')] +
                                  [e1 for e1, _ in errs])
  for r in results:
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max([r['max_abs_err']] + [e2 for _, e2 in errs])
  return results + k3


def check_rmw_rows(torch, pt, table, uids, gsum, hypers, opt, what):
  """K2 and its plain version from the same table: equal bit for bit
  (the plain version writes only the touched rows, so equal tables leave
  every untouched and sentinel row byte-identical too), and every touched
  row changed. Returns the largest |w| difference."""
  dim = gsum.shape[1]
  rows = uids[(uids < table.shape[0]) & (gsum != 0).any(dim=1)]
  before = table.index_select(0, rows)
  ref = table.clone()
  pt.rmw_rows(table, uids, gsum, hypers, opt)
  pt.rmw_rows_plain(ref, uids, gsum, hypers, opt)
  torch.cuda.synchronize()
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    bad = int((table.view(torch.int32) != ref.view(torch.int32))
              .any(dim=1).sum())
    fail('rmw_rows (%s): %d rows differ from the plain version'
         % (what, bad))
  err = float((table[:, :dim] - ref[:, :dim]).abs().max())
  del ref
  after = table.index_select(0, rows)
  if not bool((after.view(torch.int32) != before.view(torch.int32))
              .any(dim=1).all()):
    fail('rmw_rows (%s): a touched row kept its bytes' % what)
  return err


# MLPerf DLRM-DCNv2's multi-hot bag sizes, the cell dlrm_dcnv2's 26 bags
DLRM_BAGS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)


def phase_bag_pool(torch, batch=16384, dim=128):
  """K7 (csrc/bag_pool.cu) at the DLRM-DCNv2 cell's shape: a pack of
  16,384 x 214 rows of 128 f32 in its 26 bags, every weight 1. Forward
  and backward bit-exact against the plain version run on the card (the
  same roundings in the same order as on the CPU), then each direction's
  CUDA-event ms after an L2 flush beside its byte bound, the plain
  version and the path K7 replaces: 26 einsums on the split's pieces
  forward, their 26 backward products and the split's backward (a cat)
  backward. Queues each direction for phase_kernel_only. Returns the two
  kernels' result rows."""
  from easyrec_torch.ops import embedding as emb_ops
  dev = torch.device('cuda')
  sizes = DLRM_BAGS
  tot = sum(sizes)
  bags = tuple((sum(sizes[:j]), k, 0) for j, k in enumerate(sizes))

  def make():
    gen = torch.Generator(device=dev).manual_seed(26)
    return dict(rows=torch.randn((batch, tot, dim), generator=gen,
                                 device=dev),
                w=torch.ones((batch, tot), device=dev),
                g=torch.randn((batch, len(bags), dim), generator=gen,
                              device=dev))

  made = make()
  rows, w, g = made['rows'], made['w'], made['g']
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
  out = emb_ops.pool_bags(rows, w, bags)
  grad = emb_ops.pool_bags_grad(g, w, bags)
  err = 0.0
  for what, got, want in (
      ('forward', out, emb_ops.pool_bags_plain(rows, w, bags)),
      ('backward', grad, emb_ops.pool_bags_grad_plain(g, w, bags))):
    torch.cuda.synchronize()
    if not torch.equal(got, want):
      fail('bag_pool %s: differs from the plain version (max %g)'
           % (what, float((got - want).abs().max())))
    err = max(err, float((got - want).abs().max()))
    del want
  log('bag_pool: forward and backward bit-exact against the plain version '
      'at [%d, %d, %d] in %d bags' % (batch, tot, dim, len(bags)))
  del out, grad
  nbytes = batch * tot * dim * 4 + batch * tot * 4 + \
      batch * len(bags) * dim * 4
  bound, by = bound_ms(nbytes, 2 * batch * tot * dim)
  pieces = torch.split(rows, list(sizes), dim=1)
  wp = torch.split(w, list(sizes), dim=1)
  gb = torch.unbind(g, dim=1)
  fwd = lambda: emb_ops.pool_bags(rows, w, bags)  # noqa: E731
  bwd = lambda: emb_ops.pool_bags_grad(g, w, bags)  # noqa: E731
  lib_fwd = lambda: [torch.einsum('bk,bkd->bd', a, b)  # noqa: E731
                     for a, b in zip(wp, pieces)]
  lib_bwd = lambda: torch.cat([torch.einsum(  # noqa: E731
      'bk,bd->bkd', a, b) for a, b in zip(wp, gb)], dim=1)
  results = []
  for name, fn, plain, lib, call in (
      ('bag_pool', fwd, lambda: emb_ops.pool_bags_plain(rows, w, bags),
       lib_fwd, lambda rows, w, g: emb_ops.pool_bags(rows, w, bags)),
      ('bag_pool_grad', bwd,
       lambda: emb_ops.pool_bags_grad_plain(g, w, bags), lib_bwd,
       lambda rows, w, g: emb_ops.pool_bags_grad(g, w, bags))):
    ms = cuda_ms(torch, fn, 20, flush)
    plain_ms = cuda_ms(torch, plain, 3, flush)
    lib_ms = cuda_ms(torch, lib, 20, flush)
    log('%s: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s, %.1f%% of it), '
        'plain %.3f ms, the einsum path it replaces %.4f ms'
        % (name, ms, bound, nbytes, 100.0 * bound / ms, plain_ms, lib_ms))
    queue_kernel_only('%s (DLRM-DCNv2 cell shape)' % name, ms, bound, call,
                      make=make)
    results.append(dict(
        name=name, route='cuda', source='easyrec_torch/csrc/bag_pool.cu',
        replaces='none (XLA combine)', max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms))
  del flush, made, rows, w, g, pieces, wp, gb
  torch.cuda.empty_cache()
  return results


def check_seg_sum(torch, pt, sids, order, starts, grads, sentinel, what):
  """K1 in every EASYREC_GG_BF16 mode against its plain version: the
  unique ids equal and the sums bit for bit (the same f32 additions in
  the same order). Returns the largest difference of the sums."""
  err = 0.0
  for mode in ('0', 'mix', '1'):
    uk, sk = pt.seg_sum(sids, order, starts, grads, sentinel, mode)
    up, sp = pt.seg_sum_plain(sids, order, starts, grads, sentinel, mode)
    torch.cuda.synchronize()
    if not (torch.equal(uk, up) and
            torch.equal(sk.view(torch.int32), sp.view(torch.int32))):
      fail('seg_sum mode %s (%s): differs from the plain version (max %g)'
           % (mode, what, float((sk - sp).abs().max())))
    err = max(err, float((sk - sp).abs().max()))
  return err


def synthetic_pack(torch, cfg):
  """A trainer of `cfg` on the card and the pack of one synthetic batch
  of it: (trainer, table key, TableMeta, the flat id slots)."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  trainer = Trainer(cfg, device='cuda')
  bs = int(trainer.data_config.batch_size)
  batch = synthetic_batch(trainer.specs, list(trainer.ctx.label_fields), bs,
                          seed=0)
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch,
                                                     torch.device('cuda')))
  (key, meta), = trainer.metas.items()
  return trainer, key, meta, packs[key].reshape(-1)


def phase_kernel_path(torch, cfg, what, pack=synthetic_pack,
                      yardsticks=False, fused=False):
  """K1 in every mode and K2's compact Adam at the shape a main path at
  full width (`cfg`) gives them: the pack of one synthetic batch of it
  (or `pack`'s), at its table's dim (16 on the full-width paths and the
  FM gate's, so K2 runs four lanes a row; 8 on the other gates', two),
  its alignment lanes without gradient, each
  bit-exact against its plain version; K2 on the sums of mode 1, the
  path's default. With `fused`, K3 (compact Adam) on the same ids and
  gradients too, bit-exact against its plain version. With `yardsticks`,
  the plain versions' and index_add_'s times too, and both kernels
  queued for the kernel-only phase. Returns (K1's, K2's) largest
  difference, and K3's with `fused`."""
  from easyrec_torch.ops import packed_table as pt

  dev = torch.device('cuda')
  trainer, key, meta, ids = pack(torch, cfg)
  n, dim = ids.shape[0], meta.dim
  gen = torch.Generator(device=dev).manual_seed(2468)
  grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
  grads[:, trainer.layout.tables[key].used_dim:] = 0.0
  grads[::97] = 0.0
  sids, order, starts = pt.sort_segments(ids)
  n_seg = int((starts[:n] < n).sum())
  err1 = check_seg_sum(torch, pt, sids, order, starts, grads, meta.sentinel,
                       '%s shape' % what)
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  k1_ms = cuda_ms(torch, lambda: pt.seg_sum(sids, order, starts, grads,
                                            meta.sentinel, '1'), 20, flush)
  k1_bound, _ = bound_ms((n + 1) * 8 + n * 8 + n * dim * 4 + n_seg * 8 +
                         n * 8 + n * dim * 4, n * dim)
  uids, gsum = pt.seg_sum(sids, order, starts, grads, meta.sentinel, '1')
  name, opt, compact, ops = next(m for m in block_maths()
                                 if m[0] == 'compact_adam')
  table = math_table(torch, trainer.layout, key, meta.rows, dim, opt,
                     compact, gen)
  hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                      torch.tensor(3, dtype=torch.int32, device=dev))
  err2 = check_rmw_rows(torch, pt, table, uids, gsum, hypers, opt,
                        '%s, %s shape' % (name, what))
  n_touched = int(((uids < meta.rows) & (gsum != 0).any(dim=1)).sum())
  k2_ms = cuda_ms(torch, lambda: pt.rmw_rows(table, uids, gsum, hypers,
                                             opt), 20, flush)
  k2_bound, _ = bound_ms(n * 8 + opt.n_hypers * 4 + n_seg * dim * 4 +
                         n_touched * table.shape[1] * 4 * 2,
                         n_touched * dim * ops)
  log('K1 and K2 at the %s shape: table %s [%d, %d] f32, %d id slots, '
      '%d segments, %d touched rows, dim %d; seg_sum bit-exact against the '
      'plain version in modes 0, mix and 1, rmw_rows (compact_adam) '
      'bit-exact and every touched row changed (tolerance 0); seg_sum '
      '(mode 1) %.4f ms (bound %.4f ms), rmw_rows %.4f ms (bound %.4f ms)'
      % (what, key, meta.rows, meta.width, n, n_seg, n_touched, dim, k1_ms,
         k1_bound, k2_ms, k2_bound))
  if yardsticks:
    k1_plain = cuda_ms(torch, lambda: pt.seg_sum_plain(
        sids, order, starts, grads, meta.sentinel, '1'), 2, flush)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = sids[1:] != sids[:-1]
    seg_of_slot = torch.empty(n, dtype=torch.int64, device=dev)
    seg_of_slot[order] = torch.cumsum(first, 0) - 1
    acc = torch.zeros((n, dim), device=dev)
    k1_lib = cuda_ms(torch, lambda: acc.index_add_(0, seg_of_slot, grads),
                     20, flush)
    ref = table.clone()
    k2_plain = cuda_ms(torch, lambda: pt.rmw_rows_plain(
        ref, uids, gsum, hypers, opt), 2, flush)
    del acc, ref, seg_of_slot, first
    log('K1 and K2 at the %s shape: plain seg_sum %.3f ms, index_add_ '
        '%.4f ms (K1 %s); plain rmw_rows %.3f ms'
        % (what, k1_plain, k1_lib,
           'no slower' if k1_ms <= k1_lib else 'SLOWER', k2_plain))
    sentinel = meta.sentinel
    queue_kernel_only(
        'seg_sum (%s, mode 1)' % what, k1_ms, k1_bound,
        lambda sids, order, starts, grads: pt.seg_sum(
            sids, order, starts, grads, sentinel, '1'),
        sids=sids, order=order, starts=starts, grads=grads)
    queue_kernel_only(
        'rmw_rows (compact_adam, %s)' % what, k2_ms, k2_bound,
        lambda table, uids, gsum, hypers: pt.rmw_rows(table, uids, gsum,
                                                      hypers, opt),
        table=table, uids=uids, gsum=gsum, hypers=hypers)
  errs = (err1, err2)
  if fused:
    table = math_table(torch, trainer.layout, key, meta.rows, dim, opt,
                       compact, gen)
    errs += (check_fused(torch, pt, table, sids, order, starts, grads,
                         hypers, opt, '%s shape, %s' % (what, name))[2],)
  del trainer, table, grads, flush, uids, gsum
  torch.cuda.empty_cache()
  return errs


def queue_k2(torch, pt, layout, key, meta, name, opt, compact, ms, bound,
             uids, gsum, hypers):
  """Queue K2 at the flagship shape for the kernel-only phase; its 26M-row
  table is drawn anew on the card then, not kept on the host."""
  host = dict(uids=uids.cpu(), gsum=gsum.cpu(), hypers=hypers.cpu())

  def make():
    gen = torch.Generator(device='cuda').manual_seed(99)
    return dict(table=math_table(torch, layout, key, meta.rows, meta.dim,
                                 opt, compact, gen),
                **{k: v.cuda() for k, v in host.items()})

  queue_kernel_only('rmw_rows (flagship, %s)' % name, ms, bound,
                    lambda table, uids, gsum, hypers: pt.rmw_rows(
                        table, uids, gsum, hypers, opt), make=make)


def check_fused(torch, pt, table, sids, order, starts, grads, hypers, opt,
                what):
  """K3 and its plain version from the same table: every part must agree
  bit for bit (the same f32 additions in the same order, the same IEEE
  block math), and every row whose segment sums to zero, that no id names,
  or that lies outside the table keeps its bytes (the plain version writes
  only touched rows). Returns the number of touched rows, the number of
  live segments and the largest |w| difference between the kernel and its
  plain version."""
  n, dim = grads.shape
  rows = table.shape[0]
  sums = pt.segment_sums_by_chunk(order, starts, grads)
  live = starts[:n] < n
  nz = live & (sums != 0).any(dim=1)
  uids = sids[starts[:n].clamp(max=n - 1)]
  touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
  touched[uids[nz & (uids < rows)]] = True
  del sums
  idx = torch.nonzero(touched)[:, 0]
  before = table.index_select(0, idx)
  ref = table.clone()
  pt.rmw_fused(table, sids, order, starts, grads, hypers, opt)
  pt.rmw_fused_plain(ref, sids, order, starts, grads, hypers, opt)
  torch.cuda.synchronize()
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    bad = int((table.view(torch.int32) != ref.view(torch.int32)).any(dim=1)
              .sum())
    fail('rmw_fused (%s): %d rows differ from the plain version'
         % (what, bad))
  err = float((table[:, :dim] - ref[:, :dim]).abs().max())
  del ref
  after = table.index_select(0, idx)
  if not bool((after.view(torch.int32) != before.view(torch.int32))
              .any(dim=1).all()):
    fail('rmw_fused (%s): a touched row kept its bytes' % what)
  lens = starts[1:] - starts[:n]
  n_touched = int(idx.shape[0])
  log('rmw_fused (%s): %d slots, %d segments (%d longer than %d slots, the '
      'longest %d), %d touched rows, %d live zero-sum segments; every part '
      'bit-exact against the plain version (tolerance 0), untouched rows '
      'byte-identical'
      % (what, n, int(live.sum()), int((lens > pt.FUSED_CHUNK).sum()),
         pt.FUSED_CHUNK, int(lens.max()), n_touched,
         int((live & ~nz).sum())))
  return n_touched, int(live.sum()), err


def phase_kernel_din(torch):
  """K3 at the shape the DIN path gives it, for every block math: the pack
  of one synthetic batch of the full-width Taobao DIN (lengths uniform in
  1..50, so each of the two sequence features' padding id 0 collects ~100k
  slots), at the DIN's dim 16 and at dim 256 (the widest compact Adam the
  JAX package's fused kernel takes). Returns one result record a math at
  dim 16, the compact Adam's first."""
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.utils import flagship

  dev = torch.device('cuda')
  trainer, key, meta, ids = synthetic_pack(torch, flagship.taobao_din_config())
  n = ids.shape[0]
  log('K3 DIN shape: table %s [%d, %d] f32, %d id slots, dim %d'
      % (key, meta.rows, meta.width, n, meta.dim))
  gen = torch.Generator(device=dev).manual_seed(4321)
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  sids, order, starts = pt.sort_segments(ids)
  maths = sorted(block_maths(), key=lambda m: m[0] != 'compact_adam')
  results = []
  for dim in (meta.dim, 256):
    grads = torch.randn((n, dim), generator=gen, device=dev) * 1e-3
    grads[::97] = 0.0
    if dim == meta.dim:
      err1 = check_seg_sum(torch, pt, sids, order, starts, grads,
                           meta.sentinel, 'DIN shape')
      log('seg_sum at the DIN shape: bit-exact against the plain version '
          'in modes 0, mix and 1 (tolerance 0)')
    for name, opt, compact, ops in maths:
      table = math_table(torch, trainer.layout if dim == meta.dim else None,
                         key, meta.rows, dim, opt, compact, gen)
      hypers = opt.hypers(torch.tensor(1e-3, device=dev),
                          torch.tensor(3, dtype=torch.int32, device=dev))
      what = '%s, DIN shape, dim %d' % (name, dim)
      n_touched, n_live, err = check_fused(torch, pt, table, sids, order,
                                           starts, grads, hypers, opt, what)
      ms = cuda_ms(torch, lambda: pt.rmw_fused(
          table, sids, order, starts, grads, hypers, opt), 20, flush)
      plain = cuda_ms(torch, lambda: pt.rmw_fused_plain(
          table, sids, order, starts, grads, hypers, opt), 2, flush)
      # library yardstick for the sum half: index_add_ (atomics, no fixed
      # order) into a zero [rows, dim] buffer, then K2 over every row
      acc = torch.zeros((meta.rows, dim), device=dev)
      every_row = torch.arange(meta.rows, device=dev)

      def library():
        acc.zero_()
        acc.index_add_(0, ids, grads)
        pt.rmw_rows(table, every_row, acc, hypers, opt)

      lib = cuda_ms(torch, library, 20, flush)
      del acc, every_row
      # gradients, order and starts read whole, the first sid of each live
      # segment, hypers, and each touched row read and written
      nbytes = n * dim * 4 + 2 * n * 8 + 8 + n_live * 8 + \
          opt.n_hypers * 4 + n_touched * table.shape[1] * 4 * 2
      bound, by = bound_ms(nbytes, n * dim + n_touched * dim * ops)
      log('rmw_fused (%s): %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), '
          '%.2f x the bound, plain %.3f ms, index_add_ + K2 over all rows '
          '(closest library call for the sum half) %.4f ms (%s)'
          % (what, ms, bound, nbytes, ms / bound, plain, lib,
             'K3 faster' if ms < lib else 'K3 SLOWER'))
      if dim == meta.dim:
        inputs = dict(table=table, sids=sids, order=order, starts=starts,
                      grads=grads, hypers=hypers)
        queue_kernel_only(
            'rmw_fused (DIN, %s)' % name, ms, bound,
            lambda _o=opt, **t: pt.rmw_fused(
                t['table'], t['sids'], t['order'], t['starts'], t['grads'],
                t['hypers'], _o), **inputs)
      if dim == meta.dim and name == 'compact_adam':
        # the unfused path at the same shape, for comparison: K1 (mode 0)
        # by the same chunk tree, then K2
        sentinel = meta.sentinel

        def k1_k2(table, sids, order, starts, grads, hypers, _o=opt):
          uids, gsum = pt.seg_sum(sids, order, starts, grads, sentinel, '0')
          pt.rmw_rows(table, uids, gsum, hypers, _o)

        k12_ms = cuda_ms(torch, lambda: k1_k2(**inputs), 20, flush)
        log('K1 (mode 0) + K2 at the DIN shape: %.4f ms' % k12_ms)
        queue_kernel_only('K1 (mode 0) + K2 (DIN, compact_adam)', k12_ms,
                          bound, k1_k2, **inputs)
      if dim == meta.dim:
        del inputs
      del table
      torch.cuda.empty_cache()
      if dim == meta.dim:
        results.append(dict(
            name='rmw_fused/%s' % name, route='cuda',
            source='easyrec_torch/csrc/rmw_fused.cu',
            replaces='easyrec_tpu/ops/packed_table.py:1024',
            max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
            bound_by=by, library_ms=lib))
    del grads
  results[0]['seg_sum_din_err'] = err1
  del flush
  torch.cuda.empty_cache()
  return results


def group_gids(torch, meta, n_ids, seed):
  """Group slot ids as the packed-v2 update makes them: n_ids random
  logical ids, dedup_sum, group_prep; real groups first, then slots
  naming the scratch group. Returns (ugids int32, gg, n_real)."""
  from easyrec_torch.benchmarks import bench_packed_v2 as v2
  from easyrec_torch.optim.sparse import dedup_sum

  dev = torch.device('cuda')
  gen = torch.Generator(device=dev).manual_seed(seed)
  ids = torch.randint(0, meta.rows, (n_ids,), generator=gen, device=dev,
                      dtype=torch.int32)
  grads = torch.randn((n_ids, meta.dim), generator=gen, device=dev)
  ugids, gg, _ = v2.group_prep(*dedup_sum(ids, grads, meta.scratch), meta)
  real = ugids != meta.scratch_gid
  n_real = int(real.sum())
  if bool(real[n_real:].any()):
    fail('group ids: a real group slot follows a scratch slot')
  return ugids, gg.contiguous(), n_real


def phase_groups(torch):
  """K4 and K5 against their plain versions at the ported benchmarks'
  shapes, with times; then every ported benchmark's main() at its full
  shape, each correctness line required true, with K4 and K5 launch
  counts over those runs. Returns the two kernels' result records."""
  import numpy as np
  from easyrec_torch.benchmarks import (bench_dma_issue, bench_group_dma,
                                        bench_packed_stages,
                                        bench_packed_v2 as v2)
  from easyrec_torch.ops import group_dma, kernels

  dev = torch.device('cuda')
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
  results = []

  # -- K4 at the bench_packed_v2 deep shape: 106,496 slots, W 128
  meta = v2.PackMeta(26_000_000, 16)
  ugids, gg, n_real = group_gids(torch, meta, 4096 * 26, 21)
  n = ugids.shape[0]
  gen = torch.Generator(device=dev).manual_seed(22)
  table = torch.randn((meta.groups, 8, meta.width), generator=gen,
                      device=dev)
  rows = torch.randn((n, 8, meta.width), generator=gen, device=dev)
  rows[n_real:] = table[meta.scratch_gid]    # pads carry current bytes
  ref = table.clone()
  group_dma.group_push(table, ugids, rows)
  group_dma.group_push_plain(ref, ugids, rows)
  group_dma.check_ids(dev)
  if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
    fail('group_push: the table differs from the plain version')
  err4 = float((table - ref).abs().max())
  del ref
  log('group_push (push shape): %d slots (%d real groups, %d scratch pads) '
      'into [%d, 8, %d] f32; byte-equal to the plain version over the whole '
      'table, scratch group included (tolerance 0)'
      % (n, n_real, n - n_real, meta.groups, meta.width))
  k4_ms = cuda_ms(torch, lambda: group_dma.group_push(table, ugids, rows),
                  20, flush)
  k4_plain = cuda_ms(torch, lambda: group_dma.group_push_plain(
      table, ugids, rows), 20, flush)
  flat, ids64, rows2 = table.view(meta.groups, -1), ugids.long(), \
      rows.view(n, -1)
  k4_lib = cuda_ms(torch, lambda: flat.index_copy_(0, ids64, rows2), 20,
                   flush)
  k4_bytes = n * rows2.shape[1] * 4 * 2 + n * 4
  k4_bound, k4_by = bound_ms(k4_bytes, 0)
  log('group_push: %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), plain '
      '%.4f ms, index_copy_ (int64 ids) %.4f ms'
      % (k4_ms, k4_bound, k4_bytes, k4_plain, k4_lib))
  results.append(dict(
      name='group_push', route='cuda',
      source='easyrec_torch/csrc/group_push.cu',
      replaces='benchmarks/bench_packed_v2.py:127', max_abs_err=err4,
      ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound, bound_by=k4_by,
      library_ms=k4_lib))
  del rows, rows2, flat

  # -- K5 at the rmw_variant shape: the same slots with gg, W 128
  gg = gg.reshape(n, 8, meta.width)
  err5, t5 = check_group_rmw(torch, group_dma, table, ugids, gg,
                             meta.scratch_gid, 'rmw_variant shape', flush)
  del table, gg, ugids

  # -- K5 at the bench_pallas_group_dma shape: 98,304 groups, W 384, 5 GB
  groups = bench_group_dma.G
  sgids = np.sort(np.random.default_rng(0).choice(
      groups, bench_group_dma.SLOTS, replace=False)).astype(np.int32)
  table = torch.randn((groups, 8, bench_group_dma.W), generator=gen,
                      device=dev)
  e, t = check_group_rmw(torch, group_dma, table,
                         torch.from_numpy(sgids).to(dev), None, None,
                         'group-DMA shape', flush)
  del table
  results.append(dict(
      name='group_rmw', route='cuda',
      source='easyrec_torch/csrc/group_rmw.cu',
      replaces='benchmarks/bench_pallas_group_dma.py:22',
      max_abs_err=max(err5, e), ms=t['ms'], plain_ms=t['plain_ms'],
      bound_ms=t['bound_ms'], bound_by=t['bound_by'], library_ms=None))
  log('group_rmw in the kernels line: the group-DMA shape; at the '
      'rmw_variant shape %.4f ms, bound %.4f ms, plain %.4f ms'
      % (t5['ms'], t5['bound_ms'], t5['plain_ms']))
  del flush
  torch.cuda.empty_cache()

  # -- every ported benchmark at its full shape
  kernels.reset_launches()
  runs = [('bench_group_dma', bench_group_dma.main([])),
          ('bench_dma_issue', bench_dma_issue.main([])),
          ('bench_packed_stages', bench_packed_stages.main([])),
          ('bench_packed_v2', v2.main([]))]
  torch.cuda.empty_cache()
  runs.append(('experimental_packed_update', phase_experimental(torch)))
  counts = kernels.launch_counts()
  for name, out in runs:
    if not out['correct']:
      fail('%s: a correctness line is false: %s' % (name, out))
  log('ported benchmarks: every correctness line true; launches %s'
      % counts)
  for name in ('group_push', 'group_rmw'):
    if counts[name] == 0:
      fail('%s never launched in the ported benchmarks' % name)
  for name in ('seg_sum', 'rmw_rows', 'rmw_fused'):
    if counts[name] != 0:
      fail('%s launched in the ported benchmarks' % name)
  for r in results:
    r['launches'] = counts[r['name']]
  torch.cuda.empty_cache()
  return results


def check_group_rmw(torch, group_dma, table, gids, gg, scratch_gid, what,
                    flush):
  """K5 and its plain version from the same table, byte-equal on every
  group but the scratch group (whose pad slots race on the card); then
  times. Returns (max |difference|, timing record)."""
  a, b, c = (0.999, 0.0, -0.001) if gg is not None else (0.999, 0.001, 0.0)
  ref = table.clone()
  group_dma.group_rmw(table, gids, a, b, gg=gg, c=c)
  group_dma.group_rmw_plain(ref, gids, a, b, gg=gg, c=c)
  group_dma.check_ids(table.device)
  keep = torch.ones(table.shape[0], dtype=torch.bool, device=table.device)
  if scratch_gid is not None:
    keep[scratch_gid] = False
  diff = (table.view(torch.int32) != ref.view(torch.int32)).flatten(
      1).any(dim=1)
  if bool(diff[keep].any()):
    fail('group_rmw (%s): %d groups differ from the plain version'
         % (what, int(diff[keep].sum())))
  err = float((table[keep] - ref[keep]).abs().max()) if \
      scratch_gid is not None else float((table - ref).abs().max())
  del ref, diff
  n = gids.shape[0]
  elems = table[0].numel()
  n_scratch = 0 if scratch_gid is None else int((gids == scratch_gid).sum())
  log('group_rmw (%s): %d slots (%d naming the scratch group) of [%d, %d] '
      'f32 groups%s; byte-equal to the plain version on every other group '
      '(tolerance 0)' % (what, n, n_scratch, table.shape[0], elems,
                         ', with gg' if gg is not None else ''))
  ms = cuda_ms(torch, lambda: group_dma.group_rmw(table, gids, a, b, gg=gg,
                                                  c=c), 20, flush)
  plain = cuda_ms(torch, lambda: group_dma.group_rmw_plain(
      table, gids, a, b, gg=gg, c=c), 5, flush)
  nbytes = n * elems * 4 * (3 if gg is not None else 2) + n * 4
  bound, by = bound_ms(nbytes, n * elems * (3 if gg is not None else 2))
  log('group_rmw (%s): %.4f ms, bound %.4f ms (%d bytes / 3.35 TB/s), '
      'plain (index_select, the math, index_copy_: the closest PyTorch '
      'composite; no single call computes it) %.4f ms'
      % (what, ms, bound, nbytes, plain))
  return err, dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by)


class LazySgd:
  """The `update_parts` that experimental_packed_update expects and the
  JAX package does not define: lazy SGD on the weights, the slots decayed
  toward the gradient."""

  def update_parts(self, w, slots, g, lr, step):
    return w - lr * g, [0.9 * s + 0.1 * g for s in slots]


class GroupMeta:
  """A small FusedTable-like geometry: dim 16, weight + 2 slots (48
  combined columns), 8 logical rows a physical row (W 384)."""

  def __init__(self, rows):
    self.rows, self.dim, self.pack, self.combined_cols = rows, 16, 8, 48
    self.width = self.pack * self.combined_cols
    self.group_rows = 8 * self.pack
    groups = rows // self.group_rows + 2
    self.scratch = (groups - 1) * self.group_rows


def phase_experimental(torch):
  """apply_group_updates at a small geometry on the card: the K4 path
  against the index_copy_ path from the same table, byte-equal."""
  from easyrec_torch.benchmarks import experimental_packed_update as xp
  from easyrec_torch.ops import group_dma
  from easyrec_torch.optim.sparse import dedup_sum

  dev = torch.device('cuda')
  meta = GroupMeta(200_000)
  groups = meta.rows // meta.group_rows + 2
  gen = torch.Generator(device=dev).manual_seed(31)
  table = torch.randn((groups, 8, meta.width), generator=gen, device=dev)
  ids = torch.randint(0, meta.rows, (20_000,), generator=gen, device=dev)
  grads = torch.randn((20_000, meta.dim), generator=gen, device=dev)
  grads[::7] = 0.0
  uids, ug = dedup_sum(ids, grads, meta.scratch)
  ref = table.clone()
  xp.apply_group_updates(table, uids, ug, LazySgd(), 0.1, 0, meta)
  xp._plain_apply(ref, *xp._group_prep(uids, ug, meta), LazySgd(), 0.1, 0,
                  meta)
  group_dma.check_ids(dev)
  ok = torch.equal(table.view(torch.int32), ref.view(torch.int32))
  log('experimental_packed_update.apply_group_updates: %d ids into [%d, 8, '
      '%d]; K4 write-back byte-equal to index_copy_: correct=%s'
      % (ids.shape[0], groups, meta.width, ok))
  return {'correct': ok}


# kink_witness: a tensor of a train step's forward parts, card against CPU,
# where its largest gap passes KINK_RTOL of its largest magnitude. The
# small samples' readings before their kink, NVIDIA H100 80GB HBM3, 700 W:
# up to 1.3e-4 (dlrm_periodic's top_mlp.bn_0, a BatchNorm over 256 rows
# that divides the dense layers' last-bit gaps by a small deviation), 2.3e-7
# in dat's user_dnn.bn_0; a dense layer's own rounding reads 1e-7 to 1e-6
KINK_RTOL = 1e-3


def _tensors(x):
  """The floating tensors of a module's output, in order."""
  import torch
  if isinstance(x, torch.Tensor):
    return [x] if x.is_floating_point() else []
  if isinstance(x, (list, tuple)):
    return [t for y in x for t in _tensors(y)]
  if isinstance(x, dict):
    return [t for y in x.values() for t in _tensors(y)]
  return []


def forward_events(torch, trainer, batch):
  """One train step of `trainer` on `batch`, recording its forward in
  order: each module's output tensors as the module returns (named by
  the module), and each ReLU's input as the ReLU is called (named by the
  module that calls it and the call's number there). Returns the step's
  total loss and the events [(name, is_relu, tensor on the CPU)]."""
  import torch.nn.functional as F
  from torch.overrides import TorchFunctionMode
  events, stack, calls, hooks = [], [], collections.Counter(), []
  relus = {F.relu, torch.relu, torch.relu_, torch.Tensor.relu,
           torch.Tensor.relu_}

  class Relus(TorchFunctionMode):

    def __torch_function__(self, func, types, args=(), kwargs=None):
      if func in relus and torch.is_grad_enabled():
        where = stack[-1] if stack else ''
        calls[where] += 1
        events.append(('%s/relu%d' % (where, calls[where]), True,
                       args[0].detach().cpu().clone()))
      return func(*args, **(kwargs or {}))

  for name, m in trainer.model.named_modules():
    hooks.append(m.register_forward_pre_hook(
        lambda mod, inp, name=name: stack.append(name)))

    def done(mod, inp, out, name=name):
      stack.pop()
      if torch.is_grad_enabled():
        events.extend(('%s:%d' % (name, i), False, o.detach().cpu().clone())
                      for i, o in enumerate(_tensors(out)))
    hooks.append(m.register_forward_hook(done))
  try:
    with Relus():
      loss = float(trainer.train_step(batch)['total_loss'])
  finally:
    for h in hooks:
      h.remove()
  return loss, events


def kink_witness(torch, cfg, state, train, what, loss_rtol, card='cuda'):
  """Why the card's and the CPU's losses part, where they do: two
  trainers of `cfg` from the shared `state` (the model's state_dict and
  the tables) train on `train` again, card and CPU, recording each step's
  forward (forward_events). The first step whose forward holds a tensor
  that parts (past KINK_RTOL of its scale), or a ReLU whose input has
  another sign on each side, is searched event by event. The runs are
  explained only where that first parting is a ReLU whose input is
  within KINK_RTOL on each side (the dense rounding before it) and takes
  another sign on the card than on the CPU somewhere, and the step's loss
  is within the rule: from there the two sides take another branch of
  the ReLU, and the optimizer turns the gradient it passes on one side
  and not on the other into steps apart. Fails naming the first parting
  otherwise. Returns a line that names the kink."""
  from easyrec_torch.train.trainer import Trainer, to_device
  runs = []
  for dev in ('cpu', card):
    t = Trainer(cfg, device=dev)
    t.init_state()
    t.model.load_state_dict(state[0])
    for key, table in state[1].items():
      t.tables[key].copy_(table)
    runs.append(t)
  for step, batch in enumerate(train, 1):
    got = [forward_events(torch, t, to_device(batch, t.device))
           for t in runs]
    (loss_cpu, cpu), (loss_card, on_card) = got
    if [e[:2] for e in cpu] != [e[:2] for e in on_card]:
      fail('small %s: the card\'s and the CPU\'s forward of step %d ran '
           'other modules or ReLUs' % (what, step))
    for (name, relu, x), (_, _, y) in zip(cpu, on_card):
      scale = float(x.abs().max()) if x.numel() else 0.0
      gap = float((x - y).abs().max()) if x.numel() else 0.0
      apart = (x > 0) != (y > 0) if relu else None
      if gap <= KINK_RTOL * scale and (apart is None or not bool(
          apart.any())):
        continue
      if apart is None or gap > KINK_RTOL * scale:
        fail('small %s: losses differ; the card and the CPU first part in '
             'step %d at %s (%s), by %g of %g, past the dense rounding '
             '%g of its scale' % (what, step, name,
                                  'a ReLU\'s input' if relu else 'not a '
                                  'ReLU', gap, scale, KINK_RTOL))
      if abs(loss_card - loss_cpu) > loss_rtol * max(1.0, abs(loss_cpu)):
        fail('small %s: losses differ; the kink at %s in step %d comes with '
             'that step\'s losses apart already, card %r and CPU %r'
             % (what, name, step, loss_card, loss_cpu))
      near = int(torch.argmin(torch.where(apart, x.abs(), torch.full_like(
          x, math.inf))))
      return ('step %d\'s forward first parts at the ReLU %s: %d of its '
              '%d inputs take another sign on each side, the one nearest '
              'zero CPU %.6g, card %.6g; the input\'s gap %.3g of its scale '
              '%.3g (rule %g), every tensor before it within the rule'
              % (step, name, int(apart.sum()), x.numel(),
                 float(x.reshape(-1)[near]), float(y.reshape(-1)[near]),
                 gap, scale, KINK_RTOL))
  fail('small %s: losses differ, and no tensor of the three steps\' '
       'forwards parts: the sides part in a backward or an update' % what)


def phase_agree(torch, what, cfg, fused, compact='1', draws=False,
                batches=None):
  """A small model: 3 steps on the card and on the CPU from the same
  weights and batches. The CPU path runs the kernels' plain versions,
  whose agreement with the JAX package the CPU tests hold. On the card
  the update must go through K2 (or K3 under EASYREC_PACKED_FUSED=1) with
  the embedding optimizer's block math, once a step and table (with
  ev_params also ev_add and ev_set, once a step and EV table each). A model
  with per-task metrics (metric_task_names), or whose metrics_set holds
  more than `auc`, is also evaluated on two synthetic batches, card
  against CPU: from the
  shared state before training, and after the 3 steps from the card's
  trained state copied into the CPU trainer. Each time `auc`, every other
  metric of its metrics_set (`max_f1`) and every `auc_<task>` within 1e-3
  (8192-bin histograms: a probability at a bin edge may land one bin
  over) and the loss within 1e-5 relative. Each side's eval of its own
  trained state is logged beside them, not held: the two sides' weights
  part by what the rule below allows. A model whose training draws random
  numbers (`draws`: the card and the CPU draw from generators of their
  own) is evaluated from the shared state, then trains its 3 steps on
  each side, which must launch as above and give finite losses; its
  losses and tables are not held. `batches`, where given, are the
  model's input pipeline's ({'train': 3 batches, 'eval': 2}: a sampler's
  views and the extra fields in them), which the model always evaluates,
  in place of synthetic ones. A model of bf16 compute_dtype is held to
  the bf16 rule instead (ROADMAP's known divergences say why): its eval
  logits as bf16_control holds them, its losses and eval losses within
  BF16_LOSS_RTOL relative, at most 1 in BF16_FAR_SHARE of its table
  weights past 1e-5, each within 2 lr a step. Losses of an f32 model
  that part past the rule are explained by kink_witness or fail: its
  first parting must be a ReLU at its kink, and the tables are held all
  the same. Returns the card's launches by kernel and math."""
  from easyrec_torch.ops import kernels
  from easyrec_torch.optim.sparse import MATH_NAMES
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  os.environ['EASYREC_PACKED_FUSED'] = fused
  os.environ['EASYREC_PACKED_COMPACT'] = compact
  bs = int(cfg.data_config.batch_size)
  bf16 = cfg.train_config.compute_dtype == 'bfloat16'
  runs = {}
  for name in ('cpu', 'cuda'):
    t = Trainer(cfg, device=name)
    t.init_state()
    runs[name] = t
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  state = ({k: v.clone() for k, v in runs['cpu'].model.state_dict().items()},
           {k: v.clone() for k, v in runs['cpu'].tables.items()})
  tasks = runs['cpu'].model.metric_task_names()
  keys = runs['cpu'].metrics.result_names() + ['auc_%s' % k for k in tasks]
  evaluate = bool(tasks) or keys != ['auc'] or draws or batches is not None
  evals = batches['eval'] if batches is not None else None
  train = batches['train'] if batches is not None else [
      synthetic_batch(runs['cpu'].specs, list(runs['cpu'].ctx.label_fields),
                      bs, seed=step) for step in range(3)]
  loss_rtol = BF16_LOSS_RTOL if bf16 else 1e-5
  control = bf16_control(torch, cfg, runs, evals, train, what) \
      if bf16 else None
  if evaluate:
    hold_evals(eval_both(runs, bs, keys, what, fused, evals), keys, what,
               loss_rtol)
  kernels.reset_launches()
  losses = {}
  for name, t in runs.items():
    dev = torch.device(name)
    losses[name] = []
    for batch in train:
      losses[name].append(float(t.train_step(to_device(batch,
                                                        dev))['total_loss']))
  tagged = kernels.tagged_counts()
  t = runs['cuda']
  math_ids = {MATH_NAMES[t.embed_pair.sparse.kernel_math(m.compact)[0]]
              for m in t.metas.values()}
  kernel = 'rmw_fused' if fused == '1' else 'rmw_rows'
  want = {'%s/%s' % (kernel, m): 3 * len(t.tables) for m in math_ids}
  # with ev_params, each EV table's counts and last-seen steps (ev_add,
  # ev_set) take one update a step each
  for m in ('ev_add', 'ev_set') if t.ev_plan else ():
    want['%s/%s' % (kernel, m)] = 3 * len(t.ev_plan)
  if tagged != want:
    fail('small %s: the card launched %s, %s expected' % (what, tagged,
                                                          want))
  if draws:
    if not all(math.isfinite(x) for v in losses.values() for x in v):
      fail('small %s: a loss is not finite: card %s, CPU %s'
           % (what, losses['cuda'], losses['cpu']))
    log('agree: small %s, EASYREC_PACKED_FUSED=%s, training draws random '
        'numbers on each side: eval of the shared state held; 3 steps, '
        'card losses %s, CPU %s (not held); card launches %s'
        % (what, fused, losses['cuda'], losses['cpu'], tagged))
    return tagged
  for a, b in zip(losses['cpu'], losses['cuda']):
    if not math.isfinite(b) or (abs(a - b) > loss_rtol * max(1.0, abs(a))
                                and bf16):
      fail('small %s: losses differ on the card %s and the CPU %s'
           % (what, losses['cuda'], losses['cpu']))
  if rel_gap(losses['cpu'], losses['cuda']) > loss_rtol:
    log('agree: small %s: losses part on the card %s and the CPU %s, by up '
        'to %.3g relative; kink witness: %s'
        % (what, losses['cuda'], losses['cpu'],
           rel_gap(losses['cpu'], losses['cuda']),
           kink_witness(torch, cfg, state, train, what, loss_rtol)))
  # f32 reduction order differs between the card's dense model and the
  # CPU's, so the summed table gradients differ in their last bits; where a
  # sum cancels to rounding noise its sign may differ, and Adam turns
  # either sign into a step of about lr (AdamW measured 176 of 192,128
  # weights apart by more than 1e-5, all within 2 lr a step). So at most 1
  # in 100 weights may part by more than 1e-5, and none by more than 2 lr
  # a step; the kernels themselves are held bit-exact in phase 3
  emb = t.embed_pair
  lr_sum = sum(float(emb.schedule(torch.tensor(s))) for s in range(3)) * \
      emb.embedding_lr_multiplier
  far_all = 0
  for key, table in runs['cpu'].tables.items():
    dim = runs['cpu'].metas[key].dim
    diff = (runs['cuda'].tables[key][:, :dim].cpu() - table[:, :dim]).abs()
    far = int((diff > 1e-5).sum())
    err = float(diff.max())
    if (far > diff.numel() // 100 and not bf16) or err > 2 * lr_sum:
      cols = sorted(set(torch.nonzero(diff > 1e-5)[:, 1].tolist()))
      fail('small %s: table %s weights differ by up to %g, %d of %d by more '
           'than 1e-5 (columns %s)' % (what, key, err, far, diff.numel(),
                                       cols))
    far_all += far
    if not bool(torch.isfinite(runs['cuda'].tables[key]).all()):
      fail('small %s: table %s holds a value that is not finite'
           % (what, key))
  if bf16:
    # the rule's readings beside its control's (the card at f32)
    c_t, c_losses = control
    c_far = sum(int(((c_t.tables[k][:, :m.dim].cpu() -
                      runs['cpu'].tables[k][:, :m.dim]).abs() > 1e-5).sum())
                for k, m in runs['cpu'].metas.items())
    total = sum(tb.shape[0] * runs['cpu'].metas[k].dim
                for k, tb in runs['cpu'].tables.items())
    log('agree: small %s: bf16 losses card against CPU within %g relative, '
        'the f32 control\'s %g; table weights past 1e-5: %d of %d, the '
        'control\'s %d' % (what, rel_gap(losses['cpu'], losses['cuda']),
                            rel_gap(losses['cpu'], c_losses), far_all,
                            total, c_far))
    if far_all > total // BF16_FAR_SHARE:
      fail('small %s: %d of %d table weights past 1e-5, more than 1 in %d'
           % (what, far_all, total, BF16_FAR_SHARE))
    del c_t
  ema = ''
  if t.dense_opt.named_ema() is not None:
    # use_moving_average: the EMA of the dense weights, held card against
    # CPU by the same rule as the table weights (the EMA averages
    # parameters that each move at most lr a step)
    dense_lr = sum(float(t.dense_pair.schedule(torch.tensor(s)))
                   for s in range(3))
    cpu_ema = runs['cpu'].dense_opt.named_ema()
    far, total, err = 0, 0, 0.0
    for name, e in t.dense_opt.named_ema().items():
      diff = (e.cpu() - cpu_ema[name]).abs()
      far += int((diff > 1e-5).sum())
      total += diff.numel()
      err = max(err, float(diff.max()))
    if far > total // 100 or err > 2 * dense_lr or not all(
        bool(torch.isfinite(e).all()) for e in t.dense_opt.ema):
      fail('small %s: EMA weights differ by up to %g, %d of %d by more '
           'than 1e-5' % (what, err, far, total))
    ema = ('; EMA weights (decay %g) within 1e-5 but %d of %d, largest '
           'gap %g' % (t.dense_opt.ema_decay, far, total, err))
  log('agree: small %s, EASYREC_PACKED_FUSED=%s, 3 steps, card vs CPU '
      'losses %s vs %s; table weights within 1e-5 but %d (%s, each within '
      '2 lr a step)%s; card launches %s'
      % (what, fused, losses['cuda'], losses['cpu'], far_all,
         'at most 1 in %d of all under the bf16 rule' % BF16_FAR_SHARE
         if bf16 else 'at most 1 in 100',
         ema, tagged))
  if evaluate:
    eval_both(runs, bs, keys, what + ' after 3 steps, each side its own '
              'state', fused, evals)
    runs['cpu'].model.load_state_dict(t.model.state_dict())
    for key, table in runs['cpu'].tables.items():
      table.copy_(t.tables[key])
    hold_evals(eval_both(runs, bs, keys, what + ' after 3 steps, the '
                         'card\'s state on both', fused, evals), keys,
               what + ' after 3 steps', loss_rtol)
  return tagged


def hold_evals(evals, keys, what, loss_rtol=1e-5):
  """Each of `keys` within 1e-3 card against CPU, the loss within 1e-5
  relative. The AUC and max_f1 are read from 8192-bin histograms of the
  probabilities: where a model's probabilities crowd into a few bins (a
  barely trained tower: 512 rows in 8 bins), one row a rounding error from
  a bin edge landing one bin over moves them by more than 1e-3. Such a
  part is held instead by the probabilities it reads: every row's within
  1e-5 card against CPU, and at least one row in another bin on the two
  sides, which is then the whole of the part. A metric read from no
  histogram (recall@k, the errors, accuracy, precision, recall, and gauc
  and session_auc, exact rank sums on the host) is held to 1e-3 alone.
  The loss is held to `loss_rtol` relative (the bf16 rule's 2^-7 for a
  bf16 model)."""
  from easyrec_torch.metrics.metrics import AUC_BINS
  for k in keys:
    a, b = evals['cpu'][k], evals['cuda'][k]
    if abs(a - b) <= 1e-3:
      continue
    probs = 'auc' if k == 'max_f1' else k
    if probs not in evals['cpu']['probs']:
      fail('small %s: eval %s card %r, CPU %r' % (what, k, b, a))
    pa, pb = evals['cpu']['probs'][probs], evals['cuda']['probs'][probs]
    err = float((pa - pb).abs().max())
    moved = int(((pa * AUC_BINS).floor() != (pb * AUC_BINS).floor()).sum())
    if err > 1e-5 or not moved:
      fail('small %s: eval %s card %r, CPU %r (probabilities within %g, '
           '%d rows a bin apart)' % (what, k, b, a, err, moved))
    log('agree: small %s: eval %s card %r, CPU %r, apart by %d of %d rows '
        'landing in a neighbouring bin of %d (%d bins hold every row); '
        'the probabilities within %g card against CPU'
        % (what, k, b, a, moved, pa.numel(), AUC_BINS,
           len(set((pa * AUC_BINS).floor().tolist())), err))
  a, b = evals['cpu']['loss'], evals['cuda']['loss']
  if abs(a - b) > loss_rtol * max(1.0, abs(a)):
    fail('small %s: eval loss card %r, CPU %r' % (what, b, a))


def rel_gap(want, got):
  """The largest |got - want| / max(1, |want|) over two lists of losses."""
  return max(abs(a - b) / max(1.0, abs(a)) for a, b in zip(want, got))


def hold_eval_outputs(torch, runs, batches, what, keys, tol, apart=False):
  """The outputs `keys` of the eval forward over `batches`, card against
  CPU: each within `tol` of its scale (the largest |value| on the CPU),
  or with `apart` (a rule's control) one of them beyond it. Logs each
  gap as a share of its scale."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  outs = {}
  with torch.no_grad():
    for name, t in runs.items():
      parts = {k: [] for k in keys}
      for batch in batches:
        b = to_device(batch, t.device)
        pulled = emb_ops.pull_embeddings(
            t.tables, emb_ops.pack_all_views(t.layout, b), t.metas)
        o = t.eval_forward(b, pulled)
        for k in keys:
          parts[k].append(o[k].float().cpu())
      outs[name] = {k: torch.cat(v) for k, v in parts.items()}
  gaps = {k: float((outs['cuda'][k] - outs['cpu'][k]).abs().max()) /
          float(outs['cpu'][k].abs().max()) for k in keys}
  within = all(g <= tol for g in gaps.values())
  if within == apart:
    fail('small %s: eval %s card against CPU apart by %s of their scale, '
         'tolerance %g%s' % (what, keys, gaps, tol,
                             ' (a control, which must part)' if apart
                             else ''))
  log('agree: small %s: eval %s of %d rows card against CPU apart by %s of '
      'their scale (tolerance %g%s)'
      % (what, keys, outs['cpu'][keys[0]].shape[0], gaps, tol,
         ', which the control must pass' if apart else ''))


def bf16_control(torch, cfg, runs, evals, train, what):
  """The bf16 rule (ROADMAP's known divergences): the eval logits of the
  shared state card against CPU within BF16_LOGIT_TOL of their scale; the
  rule's control, the card's trainer at f32 from the same state, beyond
  it. The control then trains on `train`: returns it and its losses, for
  the readings of the losses and table weights beside the card's."""
  import copy
  from easyrec_torch.train.trainer import Trainer, to_device
  hold_eval_outputs(torch, runs, evals, what, ('logits',), BF16_LOGIT_TOL)
  f32 = copy.deepcopy(cfg)
  f32.train_config.compute_dtype = 'float32'
  t = Trainer(f32, device='cuda')
  t.init_state()
  t.model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    t.tables[key].copy_(table)
  hold_eval_outputs(torch, {'cpu': runs['cpu'], 'cuda': t}, evals,
                    what + ', the control at f32 on the card', ('logits',),
                    BF16_LOGIT_TOL, apart=True)
  losses = [float(t.train_step(to_device(b, t.device))['total_loss'])
            for b in train]
  return t, losses


def eval_probs(torch, t, batches):
  """The probabilities `t`'s eval reads for `auc` and each `auc_<task>`,
  over `batches` (with their sampled views), on the CPU."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  out = {}
  with torch.no_grad():
    for batch in batches:
      b = to_device(batch, t.device)
      pulled = emb_ops.pull_embeddings(
          t.tables, emb_ops.pack_all_views(t.layout, b), t.metas)
      outputs = t.eval_forward(b, pulled)
      parts = {'auc': t.model.metric_inputs(outputs, b)['probs']}
      for task, mi in t.model.metric_inputs_per_task(outputs, b).items():
        parts['auc_%s' % task] = mi['probs']
      for k, v in parts.items():
        out.setdefault(k, []).append(v.float().cpu())
  return {k: torch.cat(v) for k, v in out.items()}


def eval_both(runs, bs, keys, what, fused, batches=None):
  """Each trainer of `runs` evaluates the same two batches (`batches`, or
  synthetic ones); each of `keys` must be reported, finite, and in [0, 1]
  but the errors, with a finite loss. Returns the results by device, with
  the probabilities they read (`probs`)."""
  import torch
  from easyrec_torch.utils.synthetic import synthetic_batch
  evals = {}
  for name, t in runs.items():
    if batches is None:
      batches = [synthetic_batch(t.specs, list(t.ctx.label_fields), bs,
                                 seed=50 + i) for i in range(2)]
    evals[name] = t.evaluate(eval_iter=batches)
    if not all(k in evals[name] and math.isfinite(evals[name][k]) and (
        'error' in k or 0.0 <= evals[name][k] <= 1.0) for k in keys) or \
        not math.isfinite(evals[name]['loss']):
      fail('small %s: eval on %s reports %s, %s expected'
           % (what, name, evals[name], keys))
    evals[name]['probs'] = eval_probs(torch, t, batches)
  log('agree: small %s, EASYREC_PACKED_FUSED=%s, eval of 2 batches, card '
      '%s; CPU %s' % (what, fused,
                      {k: v for k, v in evals['cuda'].items() if k != 'probs'},
                      {k: v for k, v in evals['cpu'].items() if k != 'probs'}))
  return evals


# the optimizer messages the agree phase trains a small DeepFM with, each
# driving the tables and the dense weights: (what, Optimizer message body
# without the learning rate, EASYREC_PACKED_COMPACT)
AGREE_OPTIMIZERS = [
    ('adam', 'adam_optimizer {%s}', '1'),
    ('adam, EMA 0.99', 'adam_optimizer {%s} use_moving_average: true '
                       'moving_average_decay: 0.99', '1'),
    ('adam, 3-part', 'adam_optimizer {%s}', '0'),
    ('adamw', 'adamw_optimizer {%s weight_decay: 0.01}', '1'),
    ('adagrad', 'adagrad_optimizer {%s}', '1'),
    ('momentum', 'momentum_optimizer {%s}', '1'),
    ('momentumw', 'momentumw_optimizer {%s weight_decay: 0.01}', '1'),
    ('rms_prop', 'rms_prop_optimizer {%s}', '1'),
    ('ftrl', 'ftrl_optimizer {%s l1_reg: 0.001 l2_reg: 0.01 '
             'l2_shrinkage_reg: 0.01}', '1'),
]


def phase_optimizers(torch):
  """The agree phase once per optimizer message, unfused (K1 + K2) and
  fused (K3): every sparse math that a config reaches, and every dense
  optimizer, on the card against the CPU."""
  from easyrec_torch.config.text_format import parse
  from easyrec_torch.utils import flagship

  launches = {}
  # the flagship's schedule (0.001, decaying): at larger rates Adam turns a
  # bf16 rounding of a gradient sum that differs between the card and the
  # CPU (their dense reductions add in other orders) into a full step
  lr = (' learning_rate { exponential_decay_learning_rate { '
        'initial_learning_rate: 0.001 decay_steps: 1000 decay_factor: 0.5 '
        'min_learning_rate: 0.00001 } }')
  for what, body, compact in AGREE_OPTIMIZERS:
    for fused in ('0', '1'):
      cfg = flagship.criteo_deepfm_config(
          batch_size=256, hash_bucket_size=1000, num_dense=3, num_cat=6)
      opt = parse('optimizer_config { %s }' % (body % lr), 'TrainConfig')
      cfg.train_config.optimizer_config = list(opt.optimizer_config)
      for k, c in phase_agree(torch, 'DeepFM, %s' % what, cfg, fused,
                              compact).items():
        launches[k] = launches.get(k, 0) + c
  os.environ['EASYREC_PACKED_COMPACT'] = '1'
  log('agree: launches by kernel and math over the optimizer runs: %s'
      % launches)


# K7's forward and backward (csrc/bag_pool.cu)
POOL_KERNELS = ('bag_pool', 'bag_pool_grad')


def phase_slice(torch, card, what, cfg, fused, path_kernels, path_math,
                pool=0, views=False, after=None):
  """train_and_evaluate of `cfg` at full width, SLICE_STEPS steps, with
  every launch counter set to 0 just before and read just after: each
  kernel of `path_kernels` must launch once per step and table, K7
  (POOL_KERNELS) `pool` times a step each way (the model's packs whose
  bags it pools), every other kernel not at all, and K2 or K3 only
  with the block math `path_math`; the eval must report `auc` and `auc_<task>` for each of
  the model's metric_task_names(). Then the steady-state train-step rate over pre-built
  synthetic batches, or with `views` (a sampler's) over batches of the
  model's own input pipeline, whose id slots a step are logged by view.
  `after`, where given, is called with train_and_evaluate's result before
  the rate's steps change the trained state. Returns the launches by
  kernel and by kernel/math."""
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.train.trainer import to_device
  from easyrec_torch.utils.synthetic import synthetic_batch

  os.environ['EASYREC_PACKED_FUSED'] = fused
  bs = int(cfg.data_config.batch_size)
  edits = {'train_config.num_steps': SLICE_STEPS,
           'train_config.log_step_count_steps': 5}
  # earlier phases' tensors the collector has not freed yet (a served
  # export's tables in a reference cycle) would count in this path's peak
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated()
  kernels.reset_launches()
  t0 = time.time()
  result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                     device='cuda')
  torch.cuda.synchronize()
  wall = time.time() - t0
  counts = kernels.launch_counts()
  tagged = kernels.tagged_counts()
  losses = result['losses']
  log('%s: train_and_evaluate, EASYREC_PACKED_FUSED=%s, %d steps in %.1f s '
      '(set-up, input and eval included)'
      % (what, fused, result['global_step'], wall))
  log('%s losses: %s' % (what, ['%.6f' % x for x in losses]))
  log('%s eval: %s' % (what, result.get('eval_metrics')))
  log('%s launches: %s; by math: %s' % (what, counts, tagged))
  if result['global_step'] != SLICE_STEPS or len(losses) != SLICE_STEPS:
    fail('%s ran %d steps, %d asked' % (what, result['global_step'],
                                        SLICE_STEPS))
  if not all(math.isfinite(x) for x in losses):
    fail('%s: a loss is not finite' % what)
  tasks = result['trainer'].model.metric_task_names()
  for key in ['auc'] + ['auc_%s' % t for t in tasks]:
    auc = result.get('eval_metrics', {}).get(key)
    if auc is None or not 0.0 <= auc <= 1.0:
      fail('%s: eval %s missing or out of range: %r' % (what, key, auc))
  n_tables = len(result['trainer'].tables)
  for name, c in counts.items():
    want = SLICE_STEPS * n_tables if name in path_kernels else \
        SLICE_STEPS * pool if name in POOL_KERNELS else 0
    if c != want:
      fail('%s: kernel %s launched %d times in %d steps over %d tables, '
           '%d expected' % (what, name, c, SLICE_STEPS, n_tables, want))
  want = {'%s/%s' % (k, path_math): SLICE_STEPS * n_tables
          for k in path_kernels if k in ('rmw_rows', 'rmw_fused')}
  if tagged != want:
    fail('%s: K2/K3 launched with the block maths %s, %s expected'
         % (what, tagged, want))
  peak = torch.cuda.max_memory_allocated()
  if after is not None:
    after(result)
  trainer = result['trainer']
  if views:
    from easyrec_torch.ops import embedding as emb_ops
    batches = [to_device(b, torch.device('cuda')) for _, b in
               zip(range(4), trainer.train_input())]
    slots = {k: int(p.numel()) for k, p in emb_ops.pack_all_views(
        trainer.layout, batches[0]).items()}
  else:
    batches = [to_device(synthetic_batch(
        trainer.specs, list(trainer.ctx.label_fields), bs, seed=100 + i),
                         torch.device('cuda')) for i in range(4)]
    slots = {k: t.tot_k * bs for k, t in trainer.layout.tables.items()}
  log('%s peak device memory: %.3f GB (%.3f GB held before it started); '
      'launches a step: %s; id slots a step: %s'
      % (what, peak / 1e9, held / 1e9,
         {k: c / SLICE_STEPS for k, c in counts.items() if c}, slots))

  for b in batches[:3]:
    trainer.train_step(b)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(RATE_STEPS):
    out = trainer.train_step(batches[i % len(batches)])
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  if not math.isfinite(float(out['total_loss'])):
    fail('%s rate: a loss is not finite' % what)
  log('train step (%s, batch %d, pre-built %s batches on the '
      'device): %.3f ms/step, %.1f examples/s on %s'
      % (what, bs, 'input-pipeline' if views else 'synthetic',
         dt / RATE_STEPS * 1e3, RATE_STEPS * bs / dt, card))
  del result, trainer, batches
  torch.cuda.empty_cache()
  return dict(counts, **tagged)


SCRATCH = os.path.join(HERE, 'build', 'chip_smoke')

# the EV phase: samples/deepfm_ev_params.config at its published widths,
# cut in depth so that its sweeps fall inside the run. (field, published,
# here)
EV_STEPS = 40
EV_CUTS = (('train_config.num_steps', 10000, EV_STEPS),
           ('train_config.save_checkpoints_steps', 2000, 10),
           ('uid ev_params.steps_to_live', 4000, 10))
EV_BATCH = 1024
EV_COLS = ('label', 'uid', 'iid', 'cate', 'tags', 'age', 'price', 'seq_cate')


def write_ev_csv(path, seed=2026):
  """EV_STEPS batches of the sample's columns, made from `seed`: uid ids
  from 5,000 values and iid ids from 3,000, both moving to new ranges
  halfway, so ids are admitted (filter_freq 2 and 3), masked before, and
  the first half's rows go stale after (steps_to_live cut to 10)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  half = EV_STEPS * EV_BATCH // 2
  lines = []
  for i in range(EV_STEPS * EV_BATCH):
    shift = 0 if i < half else 1
    lines.append('%d,u%d,i%d,c%d,t%d,%.4f,%.2f,c%d' % (
        rng.integers(0, 2), rng.integers(0, 5000) + 5000 * shift,
        rng.integers(0, 3000) + 3000 * shift, rng.integers(0, 1000),
        rng.integers(0, 50), rng.random(), rng.random() * 100,
        rng.integers(0, 1000)))
  with open(path, 'w') as f:
    f.write('\n'.join(lines) + '\n')


def ev_config(data, model_dir):
  """The EV sample as a user loads it, with EV_CUTS, the generated data
  and `model_dir`."""
  from easyrec_torch import main as main_lib
  cfg = main_lib.load_config(
      os.path.join(HERE, 'samples', 'deepfm_ev_params.config'),
      {'train_input_path': data, 'eval_input_path': data,
       'model_dir': model_dir, 'train_config.num_steps': EV_STEPS,
       'train_config.save_checkpoints_steps': 10,
       'train_config.log_step_count_steps': 10})
  cols = [f.input_name for f in cfg.data_config.input_fields]
  if tuple(cols) != EV_COLS or int(cfg.data_config.batch_size) != EV_BATCH:
    fail('samples/deepfm_ev_params.config: columns %s, batch %d; the EV '
         'phase writes %s at %d' % (cols, cfg.data_config.batch_size,
                                    EV_COLS, EV_BATCH))
  for fc in cfg.feature_config.features:
    if fc.input_names[0] == 'uid':
      ev = fc.ev_params
      if int(ev.steps_to_live) != 4000:
        fail('uid steps_to_live %d, 4000 expected' % ev.steps_to_live)
      ev.steps_to_live = 10
      fc.ev_params = ev
  return cfg


def ev_kernel_inputs(torch):
  """The EV phase's shape for K2 and K3: the id pack of the first batch of
  the EV data ([1024, 4] slots of the 210,002-row fused table: uid, iid,
  cate and the raw age row, 1,024 times) with a gradient of ones."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  data = os.path.join(SCRATCH, 'ev', 'train.csv')
  write_ev_csv(data)
  trainer = Trainer(ev_config(data, ''), device='cuda')
  batch = next(iter(trainer.train_input()))
  packs = emb_ops.pack_ids(trainer.layout, to_device(batch,
                                                      torch.device('cuda')))
  (key, meta), = trainer.metas.items()
  return packs[key].reshape(-1), meta.rows


def phase_kernels_ev(torch):
  """K2 and K3 with the EV maths (ev_add on the admission counts, ev_set on
  the last-seen steps) at the EV phase's shape, each bit-exact against its
  plain version over the whole [rows, 1] aux table, with times and byte
  bounds. Returns one result record a kernel and math."""
  from easyrec_torch.features import ev as ev_lib
  from easyrec_torch.ops import packed_table as pt

  dev = torch.device('cuda')
  ids, rows = ev_kernel_inputs(torch)
  n = ids.shape[0]
  ones = torch.ones((n, 1), device=dev)
  sids, order, starts = pt.sort_segments(ids)
  uids, gsum = pt.seg_sum(sids, order, starts, ones, rows, '1')
  n_seg = int((starts[:n] < n).sum())
  n_touched = int(((uids < rows) & (gsum[:, 0] != 0)).sum())
  flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
  gen = torch.Generator(device=dev).manual_seed(77)
  step = torch.tensor(17, dtype=torch.int32, device=dev)
  log('EV kernel shape: aux table [%d, 1] f32, %d id slots, %d segments '
      '(the raw age row %d slots), %d touched rows'
      % (rows, n, n_seg, int((starts[1:] - starts[:n]).max()), n_touched))
  results = []
  for name, opt in (('ev_add', ev_lib.EV_ADD), ('ev_set', ev_lib.EV_SET)):
    hypers = opt.hypers(None, step)
    table = torch.randint(0, 40, (rows, 1), generator=gen,
                          device=dev).to(torch.float32)
    # the function reads a row only to add to it; both write touched rows
    row_bytes = n_touched * 4 * (2 if name == 'ev_add' else 1)
    for kernel in ('rmw_rows', 'rmw_fused'):
      ref = table.clone()
      if kernel == 'rmw_rows':
        call = lambda: pt.rmw_rows(table, uids, gsum, hypers, opt)  # noqa
        plain = lambda: pt.rmw_rows_plain(table, uids, gsum, hypers,  # noqa
                                          opt)
        pt.rmw_rows_plain(ref, uids, gsum, hypers, opt)
        nbytes = n * 8 + 4 + n_seg * 4 + row_bytes
      else:
        call = lambda: pt.rmw_fused(table, sids, order, starts, ones,  # noqa
                                    hypers, opt)
        plain = lambda: pt.rmw_fused_plain(table, sids, order,  # noqa
                                           starts, ones, hypers, opt)
        pt.rmw_fused_plain(ref, sids, order, starts, ones, hypers, opt)
        nbytes = n * 4 + 2 * n * 8 + 8 + n_seg * 8 + 4 + row_bytes
      call()
      torch.cuda.synchronize()
      if not torch.equal(table.view(torch.int32), ref.view(torch.int32)):
        fail('%s (%s) at the EV shape: %d rows differ from the plain '
             'version' % (kernel, name, int((table != ref).sum())))
      err = float((table - ref).abs().max())
      ms = cuda_ms(torch, call, 20, flush)
      plain_ms = cuda_ms(torch, plain, 3, flush)
      bound, by = bound_ms(nbytes, n_touched + (n if kernel == 'rmw_fused'
                                                else 0))
      log('%s (%s, [%d, 1]): bit-exact against the plain version (tolerance '
          '0); %.4f ms, bound %.6f ms (%d bytes / 3.35 TB/s), plain %.3f ms; '
          'no single library call computes it'
          % (kernel, name, rows, ms, bound, nbytes, plain_ms))
      if kernel == 'rmw_rows':
        queue_kernel_only(
            'rmw_rows (EV shape, %s)' % name, ms, bound,
            lambda table, uids, gsum, hypers, _o=opt: pt.rmw_rows(
                table, uids, gsum, hypers, _o),
            table=table, uids=uids, gsum=gsum, hypers=hypers)
      else:
        queue_kernel_only(
            'rmw_fused (EV shape, %s)' % name, ms, bound,
            lambda _o=opt, **t: pt.rmw_fused(
                t['table'], t['sids'], t['order'], t['starts'], t['ones'],
                t['hypers'], _o),
            table=table, sids=sids, order=order, starts=starts, ones=ones,
            hypers=hypers)
      results.append(dict(
          name='%s/%s' % (kernel, name), route='cuda',
          source='easyrec_torch/csrc/%s.cu' % kernel,
          replaces='easyrec_tpu/ops/packed_table.py:%s' % (
              '701' if kernel == 'rmw_rows' else '1024'),
          max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
          bound_by=by, library_ms=None))
  del flush
  torch.cuda.empty_cache()
  return results


def ev_run_config(data, model_dir, use_bn):
  cfg = ev_config(data, model_dir)
  if not use_bn:
    cfg.model_config.deepfm.dnn.use_bn = False
    cfg.model_config.deepfm.final_dnn.use_bn = False
  return cfg


def ev_initial_state(torch, data, use_bn, nudge=False):
  """The EV model's initial state, drawn on the CPU: every run of the EV
  phase starts from it, restored from a step-0 checkpoint, since a
  trainer draws its tables on its own device (the card's generator and the
  CPU's give other weights). With `nudge`, every weight of the first dense
  layer moves by one ulp: the yardstick of how far the run itself parts
  under a change of rounding. Returns (state, layout stamp)."""
  from easyrec_torch.train.trainer import Trainer
  t = Trainer(ev_run_config(data, '', use_bn), device='cpu')
  t.init_state()
  if nudge:
    with torch.no_grad():
      w = t.model.get_parameter('dnn.dense_0.weight')
      w.copy_(torch.nextafter(w, torch.full_like(w, float('inf'))))
  return t.state_dict(), t.layout_stamp()


def run_ev(torch, data, fused, device, use_bn, init, tag=''):
  """One EV run (ev_config) through train_and_evaluate from `init`
  (ev_initial_state, saved as step 0 of the run's model_dir, which
  train_and_evaluate restores), with every launch counter set to 0 just
  before and read just after: on the card the table's Adam, ev_add and
  ev_set launch once a step each (K1 three times a step unfused), on the
  CPU nothing. Returns (trainer, launches by kernel/math)."""
  import shutil
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.train import checkpoints as ckpt_lib

  os.environ['EASYREC_PACKED_FUSED'] = fused
  tag = '%s_%s_%s%s' % (fused, device, 'bn' if use_bn else 'nobn', tag)
  model_dir = os.path.join(SCRATCH, 'ev', 'model_' + tag)
  shutil.rmtree(model_dir, ignore_errors=True)
  cfg = ev_run_config(data, model_dir, use_bn)
  state, stamp = init
  ckpt_lib.CheckpointManager(model_dir, layout_stamp=stamp).save(state, 0)
  kernels.reset_launches()
  t0 = time.time()
  result = main_lib.train_and_evaluate(cfg, device=device)
  if device == 'cuda':
    torch.cuda.synchronize()
  wall = time.time() - t0
  counts, tagged = kernels.launch_counts(), kernels.tagged_counts()
  what = 'ev (%s, %s, BatchNorm %s)' % ('K3' if fused == '1' else 'K1 + K2',
                                        device, 'on' if use_bn else 'off')
  log('%s: %d steps in %.1f s through train_and_evaluate (input, sweeps, '
      'saves and eval included); eval %s; launches %s, by math %s'
      % (what, result['global_step'], wall, result.get('eval_metrics'),
         counts, tagged))
  if result['global_step'] != EV_STEPS:
    fail('%s ran %d steps' % (what, result['global_step']))
  steps = sorted(int(d) for d in os.listdir(
      os.path.join(model_dir, 'checkpoints')) if d.isdigit())
  if steps != [0, 10, 20, 30, 40]:
    fail('%s: checkpoints %s, 0 (the initial state) 10 20 30 40 expected'
         % (what, steps))
  if device == 'cpu':
    if any(counts.values()):
      fail('%s: the CPU launched %s' % (what, counts))
    return result['trainer'], {}
  k = 'rmw_fused' if fused == '1' else 'rmw_rows'
  want = {'%s/%s' % (k, m): EV_STEPS
          for m in ('compact_adam', 'ev_add', 'ev_set')}
  want_k1 = 0 if fused == '1' else 3 * EV_STEPS
  if tagged != want or counts['seg_sum'] != want_k1:
    fail('%s: launches %s and K1 %d, %s and K1 %d expected'
         % (what, tagged, counts['seg_sum'], want, want_k1))
  return result['trainer'], tagged


def ev_table_diff(a, b):
  """(weights apart by more than 1e-5, of how many, the largest gap) of
  the EV table's weight columns in trainers a and b."""
  (key, _), = a.ev_plan.items()
  dim = a.metas[key].dim
  diff = (a.tables[key][:, :dim].cpu() - b.tables[key][:, :dim].cpu()).abs()
  return int((diff > 1e-5).sum()), diff.numel(), float(diff.max())


def phase_ev(torch):
  """samples/deepfm_ev_params.config through train_and_evaluate at its
  published widths (uid and iid 100,000 buckets, cate 10,000, dim 16,
  batch 1024, Adam), cut in depth (EV_CUTS), on write_ev_csv's data: once
  with K1 + K2 and once with K3, each on the card and on the CPU (run_ev)
  from one initial state. Rows admitted, id slots masked and trained rows
  evicted must each be above zero, and card and CPU must agree exactly on
  both counters, the masked slots and the sweeps. The table weights: the
  same runs with the sample's BatchNorm off (the one change) within the
  agree phase's tolerance; with it on, each within 2 lr a step, since the
  run itself is unsteady in its rounding there (a CPU run from a start one
  ulp away, measured here, parts as far). Returns the card's launches by
  kernel/math of the published runs."""
  data = os.path.join(SCRATCH, 'ev', 'train.csv')
  for field, was, now in EV_CUTS:
    log('ev: cut %s %d -> %d (depth; widths, filter_freq and the model as '
        'published)' % (field, was, now))
  launches = {}
  lr_sum = 0.001 * EV_STEPS            # the sample's constant rate
  inits = {bn: ev_initial_state(torch, data, bn) for bn in (True, False)}
  for fused in ('0', '1'):
    path = 'K3' if fused == '1' else 'K1 + K2'
    for use_bn in (True, False):
      card, tagged = run_ev(torch, data, fused, 'cuda', use_bn,
                            inits[use_bn])
      cpu, _ = run_ev(torch, data, fused, 'cpu', use_bn, inits[use_bn])
      if use_bn:
        for key, c in tagged.items():
          launches[key] = launches.get(key, 0) + c
      (key, ev), = card.ev_plan.items()
      count = card.ev_state[key]['ev_count'][:, 0].cpu()
      admitted = sum(int((count[a:b] >= ff).sum())
                     for a, b, ff, _ in ev.row_segments if ff > 0)
      masked = int(card.ev_masked)
      swept = [(step, by_table[key]) for step, by_table in card.ev_swept]
      evicted = sum(seen for _, (_, seen) in swept)
      what = 'ev (%s, BatchNorm %s)' % (path, 'on' if use_bn else 'off')
      log('%s: rows admitted %d (count >= filter_freq at the end), id slots '
          'masked %d, rows evicted %d (trained rows swept); (step, (rows '
          'swept, of them trained)) at each save %s'
          % (what, admitted, masked, evicted, swept))
      if admitted <= 0 or masked <= 0 or evicted <= 0:
        fail('%s: admitted %d, masked %d, evicted %d: each must be above '
             'zero' % (what, admitted, masked, evicted))
      if masked != int(cpu.ev_masked) or card.ev_swept != cpu.ev_swept:
        fail('%s: masked %d / %d or swept %s / %s differ card / CPU'
             % (what, masked, int(cpu.ev_masked), card.ev_swept,
                cpu.ev_swept))
      for aux_name, t in card.ev_state[key].items():
        if not torch.equal(t.cpu(), cpu.ev_state[key][aux_name]):
          fail('%s: %s differs between the card and the CPU (%d rows)'
               % (what, aux_name, int((t.cpu() != cpu.ev_state[key]
                                       [aux_name]).sum())))
      far, n, err = ev_table_diff(card, cpu)
      yardstick = ''
      if use_bn and fused == '0':
        nudged, _ = run_ev(torch, data, fused, 'cpu', use_bn,
                           ev_initial_state(torch, data, True, nudge=True),
                           tag='_nudged')
        n_far, _, n_err = ev_table_diff(nudged, cpu)
        yardstick = ('; a CPU run from dense weights one ulp away parts '
                     'from the CPU run on %d by more than 1e-5, the largest '
                     'by %g' % (n_far, n_err))
        del nudged
      # the agree phase's rule and reason: the dense reductions add in
      # other orders on the card and the CPU, and Adam turns a summed
      # gradient that cancels into a step of about lr of either sign. With
      # BatchNorm over mostly zero inputs (unadmitted ids read zero) the
      # run itself is that unsteady (the yardstick above), so only the
      # 2 lr bound holds there
      if err > 2 * lr_sum or (not use_bn and far > n // 100):
        fail('%s: table weights card vs CPU differ by up to %g, %d of %d '
             'by more than 1e-5' % (what, err, far, n))
      log('%s: card and CPU agree: ev_count, ev_last, masked slots and '
          'sweeps exactly; table weights: %d of %d apart by more than 1e-5 '
          '(%s), the largest by %g (at most 2 lr a step: %g)%s'
          % (what, far, n, 'at most 1 in 100' if not use_bn
             else 'not bounded with BatchNorm', err, 2 * lr_sum, yardstick))
      del card, cpu
  torch.cuda.empty_cache()
  log('ev: launches by kernel and math over the published card runs: %s'
      % launches)
  return launches


def state_differences(torch, a, b):
  """Two trainers' state_dicts flattened by path: (a's, the sorted paths
  whose tensors differ from b's bit for bit, or that only one holds)."""
  def flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
      if isinstance(v, dict):
        out.update(flat(v, prefix + k + '/'))
      else:
        out[prefix + k] = v
    return out

  def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t

  sa, sb = flat(a.state_dict()), flat(b.state_dict())
  return sa, sorted(set(sa) ^ set(sb)) + sorted(
      k for k in set(sa) & set(sb) if not torch.equal(bits(sa[k]),
                                                      bits(sb[k])))


def phase_ckpt(torch):
  """The Taobao DIN at full width (K3), unshuffled DummyInput: a Trainer
  fits 20 steps on a model_dir with a save every 10; the step-20
  checkpoint is removed, and a fresh Trainer on the same model_dir
  restores step 10 and fits to 20. Its step, tables, model (dense
  parameters, BatchNorm statistics) and dense optimizer state must equal
  the uninterrupted run's bit for bit. Then a save and a restore of that
  state on their own, timed, with the checkpoint's size."""
  import shutil
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.train.trainer import Trainer
  from easyrec_torch.utils import flagship
  from easyrec_torch.ops import kernels

  os.environ['EASYREC_PACKED_FUSED'] = '1'
  model_dir = os.path.join(SCRATCH, 'din_ckpt')
  shutil.rmtree(model_dir, ignore_errors=True)
  cfg = flagship.taobao_din_config(model_dir=model_dir)
  cfg.data_config.shuffle = False
  cfg.train_config.num_steps = 20
  cfg.train_config.save_checkpoints_steps = 10
  kernels.reset_launches()
  a = Trainer(cfg, device='cuda')
  ra = a.fit(eval_at_end=False)
  torch.cuda.synchronize()
  counts = kernels.launch_counts()
  ckpts = os.path.join(model_dir, 'checkpoints')
  if sorted(os.listdir(ckpts)) != ['10', '20'] or counts['rmw_fused'] != 20:
    fail('ckpt: checkpoints %s, K3 launches %d' % (os.listdir(ckpts),
                                                   counts['rmw_fused']))
  shutil.rmtree(os.path.join(ckpts, '20'))
  kernels.reset_launches()
  b = Trainer(cfg, device='cuda')
  rb = b.fit(eval_at_end=False)
  torch.cuda.synchronize()
  if rb['global_step'] != 20 or len(rb['losses']) != 10 or \
      kernels.launch_counts()['rmw_fused'] != 10:
    fail('ckpt: the resumed run took %d steps to step %d'
         % (len(rb['losses']), rb['global_step']))

  sa, differ = state_differences(torch, a, b)
  log('ckpt: Taobao DIN, K3, 20 steps with saves at 10 and 20; a fresh '
      'Trainer restored step 10 and trained to 20: losses %s (resumed) vs '
      '%s; %d of %d state tensors differ from the uninterrupted run'
      % (['%.6f' % x for x in rb['losses']],
         ['%.6f' % x for x in ra['losses'][10:]], len(differ), len(sa)))
  if differ or rb['losses'] != ra['losses'][10:]:
    fail('ckpt: the resumed run differs from the uninterrupted one in %s'
         % differ[:20])
  timing_dir = os.path.join(SCRATCH, 'din_ckpt_timing')
  shutil.rmtree(timing_dir, ignore_errors=True)
  manager = ckpt_lib.CheckpointManager(timing_dir,
                                       layout_stamp=a.layout_stamp())
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  manager.save(a.state_dict(), 20)
  save_s = time.perf_counter() - t0
  nbytes = os.path.getsize(os.path.join(manager.step_dir(20), 'state.pt'))
  c = Trainer(cfg, device='cuda')
  c.init_state()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  c.load_state_dict(manager.restore(20))
  torch.cuda.synchronize()
  restore_s = time.perf_counter() - t0
  log('ckpt: save %.3f s, restore (read and copy to the card) %.3f s, '
      'checkpoint %d bytes (the [%d, %d] table %d bytes)'
      % (save_s, restore_s, nbytes, a.metas['emb16'].rows,
         a.metas['emb16'].width, a.tables['emb16'].numel() * 4))
  del a, b, c
  shutil.rmtree(timing_dir, ignore_errors=True)
  torch.cuda.empty_cache()



def dir_bytes(path):
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


class Timed:
  """Wraps fn (a module attribute, replaced for the phase): each call's
  seconds and return value are recorded in `calls`."""

  def __init__(self, owner, name):
    self.owner, self.name = owner, name
    self.fn = getattr(owner, name)
    self.calls = []

  def __enter__(self):
    def timed(*args, **kwargs):
      t0 = time.perf_counter()
      out = self.fn(*args, **kwargs)
      self.calls.append((time.perf_counter() - t0, out))
      return out
    setattr(self.owner, self.name, timed)
    return self

  def __exit__(self, *exc):
    setattr(self.owner, self.name, self.fn)


SERVE_SIZES = (1, 256, 4096)
SERVE_REQUESTS = 10


def serve_rows(n, seed):
  """n raw flagship rows made from `seed`: F1-F13 as JSON numbers and
  C1-C26 as strings, DummyInput's value ranges."""
  import numpy as np
  rng = np.random.default_rng(seed)
  dense = rng.random((n, 13))
  ids = rng.integers(0, 100000, (n, 26))
  return [dict({'F%d' % (j + 1): float(dense[i, j]) for j in range(13)},
               **{'C%d' % (j + 1): 'id%d' % ids[i, j] for j in range(26)})
          for i in range(n)]


def trainer_outputs(torch, trainer, rows):
  """The training Trainer's own eval forward on `rows`, transformed as the
  Predictor transforms a request: {output: numpy}."""
  import numpy as np
  from easyrec_torch.features import transforms as tr
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  names = list(dict.fromkeys(n for fc in trainer.feature_configs
                             for n in fc.input_names))
  columns = {n: np.array([r.get(n, '') for r in rows], dtype=object)
             for n in names}
  packed = tr.apply_transforms(tr.build_transforms(trainer.specs), columns)
  packed['sample_weight'] = np.ones(len(rows), np.float32)
  batch = to_device({k: np.array(v) for k, v in packed.items()},
                    trainer.device)
  with torch.no_grad():
    packs = emb_ops.pack_ids(trainer.layout, batch)
    pulled = emb_ops.pull_embeddings(trainer.tables, packs, trainer.metas)
    out = trainer.model.export_outputs(trainer.eval_forward(batch, pulled))
  return {k: v.cpu().numpy() for k, v in out.items()}


def phase_serve_deepfm(torch, smi):
  """The flagship DeepFM at full width through the user's entry points:
  train_and_evaluate on a model_dir (20 steps, one save at the end, the
  'final' export of the logical [26,000,014, 32] table), main.export of
  the step-20 checkpoint into a second directory (its variables must equal
  the final export's bit for bit), then PredictorService on the card: load
  and warmup timed, /healthz 200, SERVE_REQUESTS timed requests (after
  one untimed)
  of 1, 256 and 4096 raw rows each, /status counting them, and every
  answer equal to the training Trainer's own eval forward on the same
  transformed rows (each request one chunk, as the Trainer's batch; held
  bit for bit, and to 1e-6 if the card's kernels differ in their last
  bits). K1-K5 must launch 0 times while it serves."""
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.export import saved_model as sm
  from easyrec_torch.features import transforms as tr
  from easyrec_torch.ops import kernels
  from easyrec_torch.serving.client import PredictClient
  from easyrec_torch.serving.server import PredictorService
  from easyrec_torch.train import checkpoints as ckpt_lib
  from easyrec_torch.utils import flagship

  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = os.path.join(SCRATCH, 'serve')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  model_dir = os.path.join(root, 'deepfm')
  usage = shutil.disk_usage(root)
  log('serve: disk under %s: %.1f GB free of %.1f GB before the flagship '
      'checkpoint; %s' % (root, usage.free / 1e9, usage.total / 1e9, smi))
  cfg = flagship.criteo_deepfm_config(model_dir=model_dir)
  edits = {'train_config.num_steps': SLICE_STEPS,
           'train_config.save_checkpoints_steps': SLICE_STEPS,
           'train_config.log_step_count_steps': 10}
  kernels.reset_launches()
  t0 = time.time()
  with Timed(ckpt_lib.CheckpointManager, 'save') as saves, \
      Timed(sm, 'export_saved_model') as exports:
    result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                       device='cuda')
  torch.cuda.synchronize()
  wall = time.time() - t0
  counts = kernels.launch_counts()
  trainer = result['trainer']
  ckpt = os.path.join(model_dir, 'checkpoints', str(SLICE_STEPS), 'state.pt')
  final = result.get('export_dir')
  if result['global_step'] != SLICE_STEPS or not final or \
      [w for _, w in saves.calls] != [True, False] or \
      len(exports.calls) != 1:
    fail('serve: train_and_evaluate ran %d steps, saves %s, exports %d'
         % (result['global_step'], saves.calls, len(exports.calls)))
  if counts['seg_sum'] != SLICE_STEPS or counts['rmw_rows'] != SLICE_STEPS:
    fail('serve: training launched %s' % counts)
  (table_key, meta), = trainer.metas.items()
  log('serve: flagship DeepFM, train_and_evaluate with model_dir: %d steps '
      'in %.1f s (checkpoint, eval and export included); checkpoint of step '
      '%d: %d bytes in %.3f s (torch.save of the [%d, %d] table and the '
      'rest); final export: %d bytes in %.3f s (logical [%d, %d] f32 '
      'weights %d bytes); %s'
      % (result['global_step'], wall, SLICE_STEPS, os.path.getsize(ckpt),
         saves.calls[0][0], meta.rows, meta.width, dir_bytes(final),
         exports.calls[0][0], meta.rows, meta.dim, meta.rows * meta.dim * 4,
         smi))

  rows = {n: serve_rows(n, seed=n) for n in SERVE_SIZES}
  want = {n: trainer_outputs(torch, trainer, rows[n]) for n in SERVE_SIZES}
  del result, trainer
  torch.cuda.empty_cache()

  from easyrec_torch.train.trainer import Trainer
  t0 = time.perf_counter()
  with Timed(ckpt_lib.CheckpointManager, 'restore') as reads, \
      Timed(Trainer, 'load_state_dict') as copies, \
      Timed(sm, 'export_saved_model') as exports:
    again = main_lib.export(cfg, export_dir=os.path.join(root, 'again'),
                            checkpoint_path=os.path.dirname(ckpt),
                            edit_config_json=edits, device='cuda')
  torch.cuda.synchronize()
  export_s = time.perf_counter() - t0
  torch.cuda.empty_cache()
  _, a = sm.load_serving_state(final)
  _, b = sm.load_serving_state(again)
  differ = [k for sec in ('model', 'tables') for k in a[sec]
            if not torch.equal(a[sec][k], b[sec][k])]
  if differ or int(a['step']) != int(b['step']) or \
      sorted(a['tables']) != sorted(b['tables']):
    fail('serve: main.export of the step-%d checkpoint differs from the '
         'final export in %s' % (SLICE_STEPS, differ))
  log('serve: main.export of the step-%d checkpoint in %.3f s (a Trainer on '
      'the card; checkpoint restore %.3f s: read %.3f s, copy to the card '
      '%.3f s; export %.3f s): its variables equal the final export\'s bit '
      'for bit (%d tensors); %s'
      % (SLICE_STEPS, export_s, reads.calls[0][0] + copies.calls[0][0],
         reads.calls[0][0], copies.calls[0][0], exports.calls[0][0],
         len(a['model']) + len(a['tables']), smi))
  del a, b
  shutil.rmtree(os.path.join(root, 'again'))

  kernels.reset_launches()
  t0 = time.perf_counter()
  service = PredictorService(final, batch_size=max(SERVE_SIZES),
                             device='cuda')
  torch.cuda.synchronize()
  load_s = time.perf_counter() - t0
  if service.predictor.device.type != 'cuda' or any(
      t.device.type != 'cuda' for t in service.predictor.tables.values()):
    fail('serve: the Predictor is not on the card')
  warm_s = service.warmup()
  service.start()
  try:
    client = PredictClient('127.0.0.1:%d' % service.port, timeout=300)
    conn_check = client._request('GET', '/healthz')
    if conn_check != {'status': 'warm'}:
      fail('serve: /healthz answered %s' % conn_check)
    log('serve: Predictor load (variables read, table to the card) %.3f s, '
        'warmup %.3f s, /healthz 200 %s; %s'
        % (load_s, warm_s, conn_check, smi))
    worst = 0.0
    bit_equal = True
    for n in SERVE_SIZES:
      got = client.predict(rows[n])
      times = []
      for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        client.predict(rows[n])
        times.append(time.perf_counter() - t0)
      for key, ref in want[n].items():
        served = np.float32([r[key] for r in got])
        if served.shape != ref.shape or not np.isfinite(served).all():
          fail('serve: %s of %d rows: shape %s, finite %s'
               % (key, n, served.shape, np.isfinite(served).all()))
        err = float(np.abs(served - ref).max())
        worst = max(worst, err)
        bit_equal &= served.tobytes() == ref.tobytes()
      times = np.array(times) * 1e3
      # where a request's time goes: the Predictor in this process (no
      # HTTP, no JSON), and within it the host transforms alone
      inner, host = [], []
      for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        with service.lock:
          service.predictor.predict(rows[n])
        inner.append(time.perf_counter() - t0)
        columns = {c: np.array([r.get(c, '') for r in rows[n]],
                               dtype=object)
                   for c in service.predictor.input_names}
        t0 = time.perf_counter()
        tr.apply_transforms(service.predictor.transforms, columns)
        host.append(time.perf_counter() - t0)
      log('serve: %d rows a request, %d requests: latency p50 %.3f ms, p99 '
          '%.3f ms, mean %.3f ms, %.1f rows/s (HTTP on 127.0.0.1, JSON both '
          'ways, one chunk of %d rows on the card); in process, '
          'Predictor.predict p50 %.3f ms, of it the host transforms p50 '
          '%.3f ms; %s'
          % (n, SERVE_REQUESTS, np.percentile(times, 50),
             np.percentile(times, 99), times.mean(),
             n * SERVE_REQUESTS / (times.sum() / 1e3), n,
             np.percentile(inner, 50) * 1e3, np.percentile(host, 50) * 1e3,
             smi))
    status = client.status()
    client.close()
  finally:
    service.stop()
  torch.cuda.synchronize()
  launched = kernels.launch_counts()
  n_req = len(SERVE_SIZES) * (SERVE_REQUESTS + 1)
  n_rows = sum(SERVE_SIZES) * (SERVE_REQUESTS + 1)
  if status['requests'] != n_req or status['rows'] != n_rows:
    fail('serve: /status counts %d requests and %d rows, %d and %d sent'
         % (status['requests'], status['rows'], n_req, n_rows))
  if any(launched.values()):
    fail('serve: K1-K5 launched %s while serving' % launched)
  if worst > 1e-6:
    fail('serve: answers differ from the Trainer\'s eval forward by %g'
         % worst)
  log('serve: answers against the training Trainer\'s eval forward on the '
      'same rows: %s (largest difference %g); /status %d requests, %d rows; '
      'launches while serving %s'
      % ('bit-equal' if bit_equal else 'within 1e-6', worst,
         status['requests'], status['rows'], launched))
  del service
  torch.cuda.empty_cache()
  shutil.rmtree(final)
  phase_incr_big(torch, smi, cfg, model_dir, root, rows)
  shutil.rmtree(root, ignore_errors=True)
  torch.cuda.empty_cache()


INCR_EVERY = 5        # phase 30's publish interval, in steps (10 before
                      # PR 16)


def incr_save_config():
  """samples/deepfm_incr_save.config's incr_save_config, publishing every
  INCR_EVERY steps (the sample's 100 is cut with its 10,000 steps)."""
  from easyrec_torch.config import config_util
  cfg = config_util.get_configs_from_pipeline_file(
      os.path.join(HERE, 'samples', 'deepfm_incr_save.config'))
  ic = cfg.train_config.incr_save_config
  if (ic.sparse_save_steps, ic.dense_save_steps,
      ic.WhichOneof('incr_update')) != (100, 100, 'fs'):
    fail('samples/deepfm_incr_save.config\'s incr_save_config changed: %s'
         % ic)
  ic.sparse_save_steps = ic.dense_save_steps = INCR_EVERY
  return ic


def touched_rows(torch, trainer, skip_rows, windows, steps):
  """For each of `windows` runs of `steps` batches, from skip_rows raw rows
  on, of the trainer's input (one pipeline, as the resumed run read it:
  a shuffled pipeline started at another row permutes other chunks), the
  rows of each table its batches reach, sorted."""
  import numpy as np
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import to_device
  out = [{} for _ in range(windows)]
  batches = zip(range(windows * steps), trainer.train_input(
      skip_rows=skip_rows))
  for i, b in batches:
    for key, pack in emb_ops.pack_ids(
        trainer.layout, to_device(b, torch.device('cpu'))).items():
      out[i // steps].setdefault(key, []).append(np.unique(pack.numpy()))
  return [{k: np.unique(np.concatenate(v)) for k, v in w.items()}
          for w in out]


def phase_incr_big(torch, smi, cfg, model_dir, root, rows):
  """Phase 30 on phase 12's model_dir (its step-20 checkpoint): the
  flagship continues to step 30 through train_and_evaluate with
  incr_save_config() (K1 + K2 once a step), publishing a base snapshot at
  20 and updates at 25 and 30, and an empty one at the end; each update's
  sparse ids exactly the rows its steps' batches touched (touched_rows),
  its dense deltas every dense parameter that moved. Then the JAX
  design's host work for one publish of the table (a copy of its weight
  columns to the host and a compare of two copies) timed beside the
  port's diff on the card. Step 20 exported with big_model (its seconds
  and bytes); a Predictor on the card memory-maps it, consumes the three
  updates, and answers `rows` (1, 256 and 4,096 raw rows) as the Trainer's
  eval forward at step 30, bit for bit or within 1e-6; its latency
  (Predictor.predict in process, SERVE_REQUESTS calls after one untimed)
  beside the in-memory Predictor's of the step-30 export. K1-K5 launch 0
  times from the export on."""
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.export import saved_model as sm
  from easyrec_torch.export.predictor import Predictor
  from easyrec_torch.ops import kernels
  from easyrec_torch.train import incremental as incr_lib

  steps = SLICE_STEPS + 2 * INCR_EVERY
  cfg = cfg.copy()
  cfg.train_config.incr_save_config = incr_save_config()
  edits = {'train_config.num_steps': steps,
           'train_config.save_checkpoints_steps': SLICE_STEPS,
           'train_config.log_step_count_steps': 10}
  kernels.reset_launches()
  t0 = time.time()
  with Timed(incr_lib.IncrementalPublisher, 'publish') as pubs:
    result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                         device='cuda')
  torch.cuda.synchronize()
  wall = time.time() - t0
  counts = kernels.launch_counts()
  trainer = result['trainer']
  if result['global_step'] != steps or \
      counts['seg_sum'] != steps - SLICE_STEPS or \
      counts['rmw_rows'] != steps - SLICE_STEPS:
    fail('incr: train_and_evaluate from step %d ran to %d with %s'
         % (SLICE_STEPS, result['global_step'], counts))
  incr_dir = os.path.join(model_dir, 'incr_save')
  updates = incr_lib.list_updates(incr_dir)
  names = [os.path.basename(u) for u in updates]
  want_names = ['update-000001-step-%d.npz' % (SLICE_STEPS + INCR_EVERY),
                'update-000002-step-%d.npz' % steps,
                'update-000003-step-%d.npz' % steps]
  if names != want_names or [out for _, out in pubs.calls][0] is not None \
      or len(pubs.calls) != 4:
    fail('incr: published %s (%d calls), %s expected'
         % (names, len(pubs.calls), want_names))
  (key, meta), = trainer.metas.items()
  bs = int(cfg.data_config.batch_size)
  params = incr_lib.dense_arrays(trainer.model)['params']
  windows = touched_rows(torch, trainer, SLICE_STEPS * bs, 2, INCR_EVERY)
  for i, (u, touched) in enumerate(zip(updates[:2], windows)):
    blob = incr_lib.read_update(u)
    got = blob.get('sparse_ids/' + key)
    if got is None or not np.array_equal(got, touched[key]):
      fail('incr: update %s carries %s rows, the %d steps touched %d; '
           'equal: %s' % (names[i], None if got is None else got.size,
                          INCR_EVERY, touched[key].size,
                          got is not None and np.array_equal(
                              got, touched[key])))
    dense = sorted(k[len('dense/'):] for k in blob if k.startswith('dense/'))
    if not dense or not set(dense) <= set(params):
      fail('incr: update %s carries dense %s of %s' % (names[i], dense,
                                                       sorted(params)))
    if i == 1:
      for k in dense:
        if not np.array_equal(blob['dense/' + k], params[k]):
          fail('incr: update %s\'s %s differs from the step-%d parameter'
               % (names[i], k, steps))
      if not np.array_equal(blob['sparse_vals/' + key],
                            trainer.tables[key][got, :meta.dim].cpu()
                            .numpy()):
        fail('incr: update %s\'s rows differ from the table at step %d'
             % (names[i], steps))
    log('incr: update %s: %d rows (exactly the rows steps %d-%d touched), '
        '%d of %d dense parameters, %d bytes; published in %.3f s; %s'
        % (names[i], got.size, SLICE_STEPS + i * INCR_EVERY + 1,
           SLICE_STEPS + (i + 1) * INCR_EVERY, len(dense), len(params),
           os.path.getsize(u), pubs.calls[i + 1][0], smi))
  last = incr_lib.read_update(updates[2])
  if any(k.startswith('sparse_') for k in last):
    fail('incr: the final publish at step %d carries rows' % steps)
  log('incr: train_and_evaluate from step %d to %d with incr_save_config in '
      '%.1f s (checkpoint, eval and export included); base snapshot %.3f s; '
      'final publish (nothing moved) %.3f s, %d bytes; launches %s; %s'
      % (SLICE_STEPS, steps, wall, pubs.calls[0][0], pubs.calls[3][0],
         os.path.getsize(updates[2]), counts, smi))

  # one publish's table work: the JAX design copies the weight columns
  # to the host and compares them there; the port compares on the card
  weights = trainer.tables[key][:, :meta.dim]
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  host_a = weights.cpu().numpy()
  copy_s = time.perf_counter() - t0
  host_b = host_a.copy()
  t0 = time.perf_counter()
  host_ids = np.nonzero(np.any(host_a != host_b, axis=1))[0]
  diff_s = time.perf_counter() - t0
  snap = weights.clone()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  dev_ids = torch.nonzero((weights != snap).any(dim=1)).flatten().cpu()
  dev_s = time.perf_counter() - t0
  if host_ids.size or dev_ids.numel():
    fail('incr: a table compared with its own copy differs')
  log('incr: the table\'s [%d, %d] f32 weights (%d bytes) in one publish: '
      'the JAX design\'s host copy %.3f s and host compare %.3f s; the '
      'port\'s compare on the card %.4f s (its snapshot %d bytes on the '
      'card); %s' % (meta.rows, meta.dim, meta.rows * meta.dim * 4, copy_s,
                     diff_s, dev_s, meta.rows * meta.dim * 4, smi))
  del host_a, host_b, snap, weights
  want = {n: trainer_outputs(torch, trainer, rows[n]) for n in SERVE_SIZES}
  final = result['export_dir']
  del result, trainer
  torch.cuda.empty_cache()

  t0 = time.perf_counter()
  with Timed(sm, 'export_saved_model') as exports:
    big = main_lib.export(cfg, export_dir=os.path.join(root, 'big'),
                          checkpoint_path=os.path.join(
                              model_dir, 'checkpoints', str(SLICE_STEPS)),
                          edit_config_json=edits, big_model=True,
                          device='cuda')
  torch.cuda.synchronize()
  export_s = time.perf_counter() - t0
  torch.cuda.empty_cache()
  with open(os.path.join(big, sm.EXPORT_META)) as f:
    meta_json = json.load(f)
  if not meta_json['big_model'] or meta_json['global_step'] != SLICE_STEPS:
    fail('incr: the big-model export says %s' % meta_json)
  log('incr: big-model export of the step-%d checkpoint in %.3f s (a '
      'Trainer on the card, restore included; export_saved_model %.3f s): '
      '%d bytes, of them the KV store %d bytes; %s'
      % (SLICE_STEPS, export_s, exports.calls[0][0], dir_bytes(big),
         dir_bytes(os.path.join(big, 'kv')), smi))

  kernels.reset_launches()
  t0 = time.perf_counter()
  pb = Predictor(big, batch_size=max(SERVE_SIZES), device='cuda')
  load_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  applied = pb.consume_incremental(incr_dir)
  consume_s = time.perf_counter() - t0
  if applied != 3 or pb.tables:
    fail('incr: the big-model Predictor applied %d updates, holds tables '
         '%s' % (applied, sorted(pb.tables)))
  worst, bit_equal = 0.0, True
  for n in SERVE_SIZES:
    got = pb.predict(rows[n])
    for k, ref in want[n].items():
      served = np.float32([r[k] for r in got])
      if served.shape != ref.shape or not np.isfinite(served).all():
        fail('incr: %s of %d rows: shape %s' % (k, n, served.shape))
      worst = max(worst, float(np.abs(served - ref).max()))
      bit_equal &= served.tobytes() == ref.tobytes()
  if worst > 1e-6:
    fail('incr: the big-model Predictor after the updates differs from the '
         'Trainer\'s eval forward at step %d by %g' % (steps, worst))
  log('incr: big-model Predictor on the card: load (memory map) %.3f s, '
      'consume of %d updates %.3f s; answers at %s rows %s the Trainer\'s '
      'eval forward at step %d (largest difference %g); %s'
      % (load_s, applied, consume_s, list(SERVE_SIZES),
         'bit-equal to' if bit_equal else 'within 1e-6 of', steps, worst,
         smi))
  pm = Predictor(final, batch_size=max(SERVE_SIZES), device='cuda')
  for n in SERVE_SIZES:
    lat = {}
    for what, p in (('big-model', pb), ('in-memory', pm)):
      p.predict(rows[n])
      times = []
      for _ in range(SERVE_REQUESTS):
        t0 = time.perf_counter()
        p.predict(rows[n])
        times.append((time.perf_counter() - t0) * 1e3)
      lat[what] = times
    log('incr: %d rows a call, %d calls of Predictor.predict in process: '
        'big-model p50 %.3f ms, p99 %.3f ms; in-memory (step-%d export) p50 '
        '%.3f ms, p99 %.3f ms; %s'
        % (n, SERVE_REQUESTS, np.percentile(lat['big-model'], 50),
           np.percentile(lat['big-model'], 99), steps,
           np.percentile(lat['in-memory'], 50),
           np.percentile(lat['in-memory'], 99), smi))
  torch.cuda.synchronize()
  if any(kernels.launch_counts().values()):
    fail('incr: K1-K5 launched %s while serving' % kernels.launch_counts())
  del pb, pm
  torch.cuda.empty_cache()


DIN_SERVE_ROWS = 4096 + 100


def write_din_csv(path, n, seed=7, labels=1):
  """n rows of the Taobao schema's columns made from `seed`: `labels` 0/1
  labels (the DIN's clk; the MMoE's clk and buy), the 15 id features,
  price, and the two behaviour sequences (0 to 60 ids)."""
  import numpy as np
  from easyrec_torch.utils.flagship import _TAOBAO_ID_FEATURES
  rng = np.random.default_rng(seed)
  with open(path, 'w') as f:
    for _ in range(n):
      ids = ['%s%d' % (name[:2], rng.integers(0, max(buckets // 2, 2)))
             for name, buckets in _TAOBAO_ID_FEATURES]
      seqs = ['|'.join('%s%d' % (p, v) for v in rng.integers(
          0, 5000, rng.integers(0, 61))) for p in ('ca', 'br')]
      f.write(','.join(['%d' % rng.integers(0, 2) for _ in range(labels)] +
                       ids + ['%d' % rng.integers(0, 60)] + seqs) + '\n')


def phase_serve_din(torch, smi):
  """The Taobao DIN at full width on a seeded CSV (CSVInput):
  train_and_evaluate (5 steps, K3) exports it; Predictor.predict_csv with
  reserved columns on the card and on the CPU: probs within 1e-5 (f32,
  the card's reduction orders against the CPU's), the reserved columns
  equal to the input's, and no K1-K5 launch on the card."""
  import csv
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.export.predictor import Predictor
  from easyrec_torch.ops import kernels
  from easyrec_torch.utils import flagship

  os.environ['EASYREC_PACKED_FUSED'] = '1'
  root = os.path.join(SCRATCH, 'serve_din')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  data = os.path.join(root, 'din.csv')
  write_din_csv(data, DIN_SERVE_ROWS)
  cfg = flagship.taobao_din_config(model_dir=os.path.join(root, 'md'))
  edits = {'data_config.input_type': 'CSVInput', 'train_input_path': data,
           'eval_input_path': data, 'train_config.num_steps': 5}
  result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                     device='cuda')
  export_dir = result['export_dir']
  del result
  torch.cuda.empty_cache()
  reserved = ['user_id', 'adgroup_id', 'tag_brand_list']
  outs = {}
  for dev in ('cuda', 'cpu'):
    kernels.reset_launches()
    p = Predictor(export_dir, batch_size=4096, device=dev)
    out = os.path.join(root, 'pred_%s.csv' % dev)
    t0 = time.perf_counter()
    n = p.predict_csv(data, out, reserved_cols=reserved)
    dt = time.perf_counter() - t0
    if dev == 'cuda':
      torch.cuda.synchronize()
      if any(kernels.launch_counts().values()):
        fail('serve DIN: K1-K5 launched %s' % kernels.launch_counts())
    with open(out) as f:
      outs[dev] = (n, dt, list(csv.reader(f)))
    del p
  (ng, tg, g), (nc, tc, c) = outs['cuda'], outs['cpu']
  with open(data) as f:
    src = list(csv.reader(f))
  header = reserved + ['logits', 'probs']
  names = ['clk'] + [n for n, _ in flagship._TAOBAO_ID_FEATURES] + \
      ['price', 'tag_category_list', 'tag_brand_list']
  cols = [names.index(r) for r in reserved]
  if ng != nc or ng != DIN_SERVE_ROWS or g[0] != header or c[0] != header:
    fail('serve DIN: %d and %d rows, headers %s and %s' % (ng, nc, g[0],
                                                          c[0]))
  if [r[:3] for r in g[1:]] != [[s[i] for i in cols] for s in src] or \
      [r[:3] for r in c[1:]] != [r[:3] for r in g[1:]]:
    fail('serve DIN: the reserved columns differ from the input\'s')
  pg = np.float64([r[4] for r in g[1:]])
  pc = np.float64([r[4] for r in c[1:]])
  err = float(np.abs(pg - pc).max())
  if not np.isfinite(pg).all() or err > 1e-5:
    fail('serve DIN: probs card against CPU differ by %g' % err)
  log('serve: Taobao DIN predict_csv of %d rows with reserved columns %s: '
      'card %.3f s, CPU %.3f s; probs card against CPU within %g, reserved '
      'columns equal to the input\'s; %s'
      % (ng, reserved, tg, tc, err, smi))
  shutil.rmtree(root, ignore_errors=True)


def phase_bst_agree(torch):
  """The agree phase for a small Taobao BST, unfused (K1 + K2) and fused
  (K3), under EASYREC_ATTN_IMPL=stock: the vpu_bf16 payloads of the card
  and the CPU round apart where their f32 values straddle a bf16
  boundary, which a loss rule of 1e-5 would read as disagreement (that
  forward is held on its own, in phase_bst_forward)."""
  from easyrec_torch.utils import flagship
  os.environ['EASYREC_ATTN_IMPL'] = 'stock'
  try:
    for fused in ('0', '1'):
      phase_agree(torch, 'BST (stock attention)',
                  flagship.taobao_bst_config(batch_size=256, seq_len=8),
                  fused)
  finally:
    os.environ.pop('EASYREC_ATTN_IMPL', None)


BF16_TOL = 1e-2


def phase_bst_forward(torch, smi):
  """The full-width Taobao BST's eval forward (batch 1024) on the card
  and the CPU from one state, under vpu_bf16 (the default) and stock:
  logits within BF16_TOL of their scale under vpu_bf16, within 1e-5
  under stock, and the two impls apart on the card (the bf16 payloads are
  in effect)."""
  import numpy as np
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch

  cfg = flagship.taobao_bst_config(batch_size=1024)
  runs = {}
  for name in ('cpu', 'cuda'):
    runs[name] = Trainer(cfg, device=name)
    runs[name].init_state()
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  batch = synthetic_batch(runs['cpu'].specs, ['clk'], 1024, seed=9)
  logits = {}
  try:
    for impl in ('vpu_bf16', 'stock'):
      os.environ['EASYREC_ATTN_IMPL'] = impl
      for name, t in runs.items():
        b = to_device(batch, torch.device(name))
        with torch.no_grad():
          pulled = emb_ops.pull_embeddings(
              t.tables, emb_ops.pack_ids(t.layout, b), t.metas)
          logits[impl, name] = t.eval_forward(b, pulled)['logits'] \
              .cpu().numpy()
  finally:
    os.environ.pop('EASYREC_ATTN_IMPL', None)
  scale = float(np.abs(logits['vpu_bf16', 'cpu']).max())
  err = float(np.abs(logits['vpu_bf16', 'cuda'] -
                     logits['vpu_bf16', 'cpu']).max())
  err_stock = float(np.abs(logits['stock', 'cuda'] -
                           logits['stock', 'cpu']).max())
  apart = float(np.abs(logits['vpu_bf16', 'cuda'] -
                       logits['stock', 'cuda']).max())
  if not all(np.isfinite(v).all() for v in logits.values()) or \
      err > BF16_TOL * scale or err_stock > 1e-5 * max(1.0, scale) or \
      apart == 0.0:
    fail('BST forward: vpu_bf16 card against CPU %g (tolerance %g), stock '
         '%g, vpu_bf16 against stock on the card %g'
         % (err, BF16_TOL * scale, err_stock, apart))
  log('BST forward, full width, batch 1024, card against CPU from one '
      'state: vpu_bf16 logits within %g (tolerance %g = %g of their scale '
      '%g), stock within %g; vpu_bf16 against stock on the card %g; %s'
      % (err, BF16_TOL * scale, BF16_TOL, scale, err_stock, apart, smi))
  del runs
  torch.cuda.empty_cache()


def phase_serve_bst(torch, smi):
  """The Taobao BST at full width on a seeded CSV: train_and_evaluate (5
  steps, K1 + K2) exports it; a Predictor on the card answers 1 and 4,096
  of the CSV's rows, each one chunk, bit-equal to the training Trainer's
  eval forward on the same rows, with no K1-K5 launch."""
  import csv
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.export.predictor import Predictor
  from easyrec_torch.ops import kernels
  from easyrec_torch.utils import flagship

  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = os.path.join(SCRATCH, 'serve_bst')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  data = os.path.join(root, 'bst.csv')
  write_din_csv(data, DIN_SERVE_ROWS, seed=8)
  cfg = flagship.taobao_bst_config(model_dir=os.path.join(root, 'md'))
  edits = {'data_config.input_type': 'CSVInput', 'train_input_path': data,
           'eval_input_path': data, 'train_config.num_steps': 5}
  result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                     device='cuda')
  export_dir = result['export_dir']
  names = [f.input_name for f in cfg.data_config.input_fields]
  with open(data) as f:
    rows = [dict(zip(names, r)) for r in csv.reader(f)]
  sizes = (1, 4096)
  want = {n: trainer_outputs(torch, result['trainer'], rows[:n])
          for n in sizes}
  del result
  torch.cuda.empty_cache()
  kernels.reset_launches()
  t0 = time.perf_counter()
  p = Predictor(export_dir, batch_size=4096, device='cuda')
  load_s = time.perf_counter() - t0
  worst, bit_equal, times = 0.0, True, {}
  for n in sizes:
    got = p.predict(rows[:n])
    t0 = time.perf_counter()
    p.predict(rows[:n])
    times[n] = (time.perf_counter() - t0) * 1e3
    for key, ref in want[n].items():
      served = np.float32([r[key] for r in got])
      if served.shape != ref.shape or not np.isfinite(served).all():
        fail('serve BST: %s of %d rows: shape %s' % (key, n, served.shape))
      worst = max(worst, float(np.abs(served - ref).max()))
      bit_equal &= served.tobytes() == ref.tobytes()
  torch.cuda.synchronize()
  if any(kernels.launch_counts().values()):
    fail('serve BST: K1-K5 launched %s' % kernels.launch_counts())
  if not bit_equal:
    fail('serve BST: the Predictor\'s answers differ from the Trainer\'s '
         'eval forward by up to %g' % worst)
  log('serve: Taobao BST export, Predictor on the card (load %.3f s): '
      'answers at %s rows bit-equal to the training Trainer\'s eval '
      'forward; Predictor.predict %s ms; no K1-K5 launch; %s'
      % (load_s, sizes, ', '.join('%d rows %.3f' % (n, times[n])
                                  for n in sizes), smi))
  del p
  shutil.rmtree(root, ignore_errors=True)
  torch.cuda.empty_cache()


# the small forms of the multi-task family on the Taobao schema, labels
# clk and buy (the MMoE's is flagship.taobao_mmoe_config at a small batch
# and short histories): every model message, ESMM's groups, DBMTL's
# relation DAG over a sequence sub-group, PLE's two CGC layers
MT_BLOCKS = {
    'SimpleMultiTask': """  model_class: "SimpleMultiTask"
%(all)s
  simple_multi_task {
    task_towers { tower_name: "ctr" label_name: "clk"
                  dnn { hidden_units: [128, 64] } }
    task_towers { tower_name: "cvr" label_name: "buy"
                  dnn { hidden_units: [128, 64] } }
  }""",
    'ESMM': """  model_class: "ESMM"
%(two)s
  esmm {
    groups { input: "user" dnn { hidden_units: [128, 64] } }
    groups { input: "item" dnn { hidden_units: [128, 64] } }
    ctr_tower { tower_name: "ctr" label_name: "clk"
                dnn { hidden_units: [64, 32] } }
    cvr_tower { tower_name: "cvr" label_name: "buy"
                dnn { hidden_units: [64, 32] } }
  }""",
    'DBMTL': """  model_class: "DBMTL"
  feature_groups {
    group_name: "all"
    %(ids)s
    wide_deep: DEEP
    sequence_features {
      group_name: "seq"
      seq_att_map { key: "brand" hist_seq: "tag_brand_list" }
      seq_att_map { key: "cate_id" hist_seq: "tag_category_list" }
    }
  }
  dbmtl {
    bottom_dnn { hidden_units: [256, 128] }
    expert_dnn { hidden_units: [64, 32] }
    num_expert: 3
    task_towers { tower_name: "ctr" label_name: "clk"
                  dnn { hidden_units: [64, 32] } }
    task_towers { tower_name: "cvr" label_name: "buy"
                  dnn { hidden_units: [64, 32] }
                  relation_tower_names: "ctr"
                  relation_dnn { hidden_units: [32] } }
  }""",
    'PLE': """  model_class: "PLE"
%(all)s
  ple {
    extraction_networks {
      network_name: "layer1" expert_num_per_task: 2 share_num: 2
      task_expert_net { hidden_units: [128, 64] }
      share_expert_net { hidden_units: [128, 64] }
    }
    extraction_networks {
      network_name: "layer2" expert_num_per_task: 2 share_num: 2
      task_expert_net { hidden_units: [64] }
    }
    task_towers { tower_name: "ctr" label_name: "clk"
                  dnn { hidden_units: [32] } }
    task_towers { tower_name: "cvr" label_name: "buy"
                  dnn { hidden_units: [32] } }
  }""",
}


def multi_task_config(model, batch_size, seq_len):
  from easyrec_torch.utils import flagship as fl
  if model == 'MMoE':
    return fl.taobao_mmoe_config(batch_size=batch_size, seq_len=seq_len)
  ids = [n for n, _ in fl._TAOBAO_ID_FEATURES] + ['price']
  names = lambda fs: '\n    '.join(  # noqa: E731
      'feature_names: "%s"' % f for f in fs)
  groups = {'all': '  feature_groups {\n    group_name: "all"\n    %s\n'
                   '    wide_deep: DEEP\n  }' % names(
                       ids + ['tag_category_list', 'tag_brand_list']),
            'two': fl._tower_groups(), 'ids': names(ids)}
  return fl._taobao_pipeline(MT_BLOCKS[model] % groups, ['clk', 'buy'],
                             batch_size, seq_len, 16, '')


def phase_multi_task(torch):
  """The agree phase for a small form of each multi-task model (batch
  256, histories of 8, labels clk and buy), unfused (K1 + K2) and fused
  (K3), with the per-task eval: ESMM must report auc_ctcvr."""
  for model in ('SimpleMultiTask', 'MMoE', 'ESMM', 'DBMTL', 'PLE'):
    for fused in ('0', '1'):
      phase_agree(torch, 'Taobao %s' % model,
                  multi_task_config(model, 256, 8), fused)


def serve_bit_equal(torch, what, export_dir, rows, want, smi):
  """PredictorService on the card over `export_dir` answers each of
  want's row counts (the first n of `rows`, one request, one chunk) over
  HTTP: every output of the export bit-equal to `want[n]`, the training
  Trainer's eval forward on the same rows, with no K1-K5 launch."""
  import numpy as np
  from easyrec_torch.ops import kernels
  from easyrec_torch.serving.client import PredictClient
  from easyrec_torch.serving.server import PredictorService

  sizes = sorted(want)
  outputs = sorted(want[sizes[0]])
  torch.cuda.empty_cache()
  kernels.reset_launches()
  t0 = time.perf_counter()
  service = PredictorService(export_dir, batch_size=max(sizes),
                             device='cuda')
  load_s = time.perf_counter() - t0
  service.warmup()
  service.start()
  worst, bit_equal, times = 0.0, True, {}
  try:
    client = PredictClient('127.0.0.1:%d' % service.port, timeout=300)
    for n in sizes:
      t0 = time.perf_counter()
      got = client.predict(rows[:n])
      times[n] = (time.perf_counter() - t0) * 1e3
      if any(sorted(r) != outputs for r in got):
        fail('serve %s: answers carry %s' % (what, sorted(got[0])))
      for key, ref in want[n].items():
        served = np.float32([r[key] for r in got])
        if served.shape != ref.shape or not np.isfinite(served).all():
          fail('serve %s: %s of %d rows: shape %s' % (what, key, n,
                                                      served.shape))
        worst = max(worst, float(np.abs(served - ref).max()))
        bit_equal &= served.tobytes() == ref.tobytes()
    client.close()
  finally:
    service.stop()
  torch.cuda.synchronize()
  if any(kernels.launch_counts().values()):
    fail('serve %s: K1-K5 launched %s' % (what, kernels.launch_counts()))
  if not bit_equal:
    fail('serve %s: the served answers differ from the Trainer\'s eval '
         'forward by up to %g' % (what, worst))
  log('serve: %s export, PredictorService on the card (load %.3f s): %s at '
      '%s rows bit-equal to the training Trainer\'s eval forward; a '
      'request over HTTP %s ms; no K1-K5 launch; %s'
      % (what, load_s, outputs, sizes,
         ', '.join('%d rows %.3f' % (n, times[n]) for n in sizes), smi))
  del service
  torch.cuda.empty_cache()


def phase_serve_mmoe(torch, smi):
  """The Taobao MMoE at full width on a seeded CSV with clk and buy:
  train_and_evaluate (5 steps, K1 + K2) exports it; PredictorService on
  the card answers 1 and 4,096 of the CSV's rows over HTTP, each request
  one chunk, every output (logits_ and probs_ of ctr and cvr) bit-equal
  to the training Trainer's eval forward on the same rows, with no K1-K5
  launch."""
  import csv
  import shutil
  from easyrec_torch import main as main_lib
  from easyrec_torch.utils import flagship

  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = os.path.join(SCRATCH, 'serve_mmoe')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  data = os.path.join(root, 'mmoe.csv')
  write_din_csv(data, DIN_SERVE_ROWS, seed=9, labels=2)
  cfg = flagship.taobao_mmoe_config(model_dir=os.path.join(root, 'md'))
  edits = {'data_config.input_type': 'CSVInput', 'train_input_path': data,
           'eval_input_path': data, 'train_config.num_steps': 5}
  result = main_lib.train_and_evaluate(cfg, edit_config_json=edits,
                                     device='cuda')
  names = [f.input_name for f in cfg.data_config.input_fields]
  with open(data) as f:
    rows = [dict(zip(names, r)) for r in csv.reader(f)]
  want = {n: trainer_outputs(torch, result['trainer'], rows[:n])
          for n in (1, 4096)}
  outputs = sorted(want[1])
  if outputs != ['logits_ctr', 'logits_cvr', 'probs_ctr', 'probs_cvr']:
    fail('serve MMoE: the export outputs %s' % outputs)
  export_dir = result['export_dir']
  del result
  serve_bit_equal(torch, 'Taobao MMoE', export_dir, rows, want, smi)
  shutil.rmtree(root, ignore_errors=True)


# the classic rank zoo, small, on the flagship Criteo schema (3 raw and 6 id
# features of 1,000 buckets, dim 16, batch 256; _criteo_pipeline fills in
# the groups' features): every model message of the slice, with
# deepfm_multi_loss's Uncertainty-weighted terms on the DeepFM
ZOO_BLOCKS = {
    'WideAndDeep': """  model_class: "WideAndDeep"
  feature_groups { group_name: "deep" %(dense)s %(cat)s wide_deep: DEEP }
  feature_groups { group_name: "wide" %(cat)s wide_deep: WIDE }
  wide_and_deep { dnn { hidden_units: [128, 64] }
                  final_dnn { hidden_units: [64] } }""",
    'DCN': """  model_class: "DCN"
  feature_groups { group_name: "all" %(dense)s %(cat)s wide_deep: DEEP }
  dcn { deep_tower { input: "all" dnn { hidden_units: [128, 64] } }
        cross_tower { input: "all" cross_num: 3 }
        final_dnn { hidden_units: [64] } }""",
    'AutoInt': """  model_class: "AutoInt"
  feature_groups { group_name: "all" %(dense)s %(cat)s wide_deep: DEEP }
  autoint { multi_head_num: 2 multi_head_size: 16
            interacting_layer_num: 2 }""",
    'DLRM': """  model_class: "DLRM"
  feature_groups { group_name: "dense" %(dense)s wide_deep: DEEP }
  feature_groups { group_name: "sparse" %(cat)s wide_deep: DEEP }
  dlrm { bot_dnn { hidden_units: [64, 32, 16] }
         top_dnn { hidden_units: [128, 64] } }""",
    'FM': """  model_class: "FM"
  feature_groups { group_name: "deep" %(cat)s wide_deep: DEEP }
  feature_groups { group_name: "wide" %(cat)s wide_deep: WIDE }
  fm {}""",
    'RocketLaunching': """  model_class: "RocketLaunching"
  feature_groups { group_name: "all" %(dense)s %(cat)s wide_deep: DEEP }
  rocket_launching {
    share_dnn { hidden_units: [128] }
    booster_dnn { hidden_units: [64, 32] }
    light_dnn { hidden_units: [64] }
    feature_based_distillation: true }""",
    'DeepFM, Uncertainty losses': """  model_class: "DeepFM"
  feature_groups { group_name: "deep" %(dense)s %(cat)s wide_deep: DEEP }
  feature_groups { group_name: "wide" %(cat)s wide_deep: WIDE }
  deepfm { dnn { hidden_units: [128, 64] } final_dnn { hidden_units: [64] } }
  losses { loss_type: CLASSIFICATION weight: 1.0 }
  losses { loss_type: BINARY_FOCAL_LOSS weight: 1.0
           binary_focal_loss { gamma: 2.0 alpha: 0.85 } }
  loss_weight_strategy: Uncertainty""",
}


def zoo_config(model):
  from easyrec_torch.config.text_format import parse
  from easyrec_torch.utils import flagship as fl
  cfg = fl._criteo_pipeline(ZOO_BLOCKS[model], 256, 1000, 16, 3, 6, '')
  cfg.eval_config.metrics_set = list(parse(
      'metrics_set { auc {} } metrics_set { max_f1 {} }',
      'EvalConfig').metrics_set)
  return cfg


def phase_zoo(torch):
  """The agree phase for a small form of each model of the rank zoo
  (batch 256), unfused (K1 + K2) and fused (K3), with its eval: `auc`
  and `max_f1` card against CPU."""
  for model in ZOO_BLOCKS:
    for fused in ('0', '1'):
      phase_agree(torch, 'Criteo %s' % model, zoo_config(model), fused)


def phase_serve_dlrm(torch, smi, what='Criteo DLRM',
                     config='criteo_dlrm_config'):
  """A Criteo DLRM at full width (flagship's `config`: the zoo's, or the
  backbone DSL's): train_and_evaluate on a model_dir (5 steps, K1 + K2,
  the 'final' export of its [26,000,014, 16] table); PredictorService on
  the card answers 1 and 4,096 raw flagship rows over HTTP, logits and
  probs bit-equal to the training Trainer's eval forward on the same rows,
  with no K1-K5 launch."""
  import shutil
  from easyrec_torch import main as main_lib
  from easyrec_torch.utils import flagship

  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = os.path.join(SCRATCH, 'serve_dlrm')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  cfg = getattr(flagship, config)(model_dir=os.path.join(root, 'md'))
  result = main_lib.train_and_evaluate(
      cfg, edit_config_json={'train_config.num_steps': 5}, device='cuda')
  rows = serve_rows(4096, seed=13)
  want = {n: trainer_outputs(torch, result['trainer'], rows[:n])
          for n in (1, 4096)}
  if sorted(want[1]) != ['logits', 'probs']:
    fail('serve %s: the export outputs %s' % (what, sorted(want[1])))
  export_dir = result['export_dir']
  del result
  serve_bit_equal(torch, what, export_dir, rows, want, smi)
  shutil.rmtree(root, ignore_errors=True)


# the backbone samples (tests/test_torch_samples.py's BACKBONE) and the
# three variational_dropout samples, whose models ignore it; the dropout
# rates the agree runs set to 0 (the card and the CPU draw apart), and
# the sample whose training still draws (SeqAugment)
BACKBONE_SAMPLES = (
    'aitm_backbone', 'autodis_numeric', 'bst_backbone', 'cdn_backbone',
    'cin_backbone', 'cl4srec_backbone', 'contrastive_backbone',
    'dcn_backbone', 'deepfm_backbone', 'dlrm_autodis', 'dlrm_backbone',
    'dlrm_narydis', 'dlrm_periodic', 'dlrm_senet_backbone',
    'fibinet_backbone', 'highway_backbone', 'masknet_backbone',
    'periodic_numeric', 'ppnet_backbone', 'wide_and_deep_backbone',
    'dbmtl_variational_dropout', 'esmm_variational_dropout',
    'multi_tower_variational_dropout')
BACKBONE_NO_DROPOUT = (('hidden_dropout_prob: 0.1',
                        'hidden_dropout_prob: 0.0'),
                       ('input_layer { dropout_rate: 0.1 }',
                        'input_layer {}'))
BACKBONE_DRAWS = ('cl4srec_backbone',)
BACKBONE_FUSED = ('dlrm_backbone', 'aitm_backbone')


def backbone_sample_config(name):
  """samples/<name>.config at batch 256 on DummyInput over its own
  input_fields, no model_dir, its dropout rates 0."""
  from easyrec_torch.config import config_util
  with open(os.path.join(HERE, 'samples', name + '.config')) as f:
    text = f.read()
  for old, new in BACKBONE_NO_DROPOUT:
    text = text.replace(old, new)
  cfg = config_util.get_configs_from_pipeline_str(text)
  cfg.data_config.batch_size = 256
  cfg.data_config.input_type = 'DummyInput'
  cfg.model_dir = ''
  return cfg


def phase_backbone(torch):
  """The agree phase for each backbone sample and variational_dropout
  sample, small, unfused (K1 + K2), and fused (K3) for BACKBONE_FUSED;
  BACKBONE_DRAWS by the agree phase's rule for models that draw. Under
  EASYREC_ATTN_IMPL=stock, as phase_bst_agree and for its reason (the
  BST samples' attention)."""
  os.environ['EASYREC_ATTN_IMPL'] = 'stock'
  try:
    for name in BACKBONE_SAMPLES:
      for fused in ('0', '1') if name in BACKBONE_FUSED else ('0',):
        phase_agree(torch, 'backbone sample %s' % name,
                    backbone_sample_config(name), fused,
                    draws=name in BACKBONE_DRAWS)
  finally:
    os.environ.pop('EASYREC_ATTN_IMPL', None)


# the match family (phases 23-25): its samples small, card against CPU;
# samples/dssm_neg_sampler.config at its published widths on data made
# by write_dssm_data; the DSSM's export served
MATCH_SAMPLES = (
    'dat', 'dat_inner_simi', 'dropoutnet', 'dropoutnet_neg_sampler_v2',
    'dssm_hard_neg_sampler', 'dssm_kd', 'dssm_neg_sampler', 'dssm_reg',
    'dssm_senet', 'kd_backbone', 'metric_learning_i2i', 'metric_learning_ms',
    'mind', 'mind_neg_sampler', 'mind_time_id', 'multi_tower_recall',
    'parallel_dssm_backbone', 'pdn', 'pdn_neg_sampler')
# the agree runs' edits of a match sample: the draws the card and the CPU
# make apart set to 0 (MIND's routing logits, DropoutNet's preference
# dropout), and the samples' constant rate 0.001 cut to 0.0001. An inner
# product at temperature 0.05 over untrained towers (dat_inner_simi,
# loss 125) turns the weights' last-bit differences after one Adam step
# (a gradient sum that cancels steps by about lr either way, as the
# agree rule says) into loss differences of 2e-5 to 4e-5 relative at
# 0.001 (the card against the CPU, NVIDIA H100 80GB HBM3, 700 W): the
# steps, and with them those differences, scale with the rate
MATCH_EDITS = (('num_iters: 3 }',
                'num_iters: 3 routing_logits_stddev: 0.0 }'),
               ('user_dropout_rate: 0.1', 'user_dropout_rate: 0.0'),
               ('item_dropout_rate: 0.5', 'item_dropout_rate: 0.0'),
               ('constant_learning_rate { learning_rate: 0.001 }',
                'constant_learning_rate { learning_rate: 0.0001 }'))
MATCH_FUSED = ('dssm_neg_sampler',)
MATCH_COLS = ('label', 'uid', 'iid', 'cate', 'tags', 'age', 'price',
              'seq_cate', 'teacher')
DSSM_CATES = 10000        # the sample's cate hash buckets
DSSM_TAGS = 100000        # its tags hash buckets


def write_dssm_data(directory, cols=MATCH_COLS[:8], n_items=1000000,
                    n_users=1000000, train_rows=(SLICE_STEPS + 4) * 1024,
                    eval_rows=8192, edges=False, seed=2026):
  """The columns `cols` of the match samples (by default
  samples/dssm_neg_sampler.config's: label, uid, iid, cate, tags, age,
  price, seq_cate; `teacher`, a kd teacher's probability, besides) as
  headerless train.csv and eval.csv in `directory`, and the sampler's
  items.txt in
  the GraphLearn text format the sample names (`id<TAB>weight<TAB>
  iid:cate:price` under a header line) over n_items items with Zipf
  weights (1 / rank^1.1); with `edges`, edges.txt of 3 items a user for
  the hard-negative and V2 samplers. Users and items of a row are drawn
  Zipf-skewed from the same ids, so a batch's items recur among the
  sampled negatives; an item's cate and price are the same in every row
  and in items.txt. The label is 1 on one row in three. Returns the
  paths by name. Defaults: the published widths (1,000,000 items and
  users, as the sample's hash buckets)."""
  import numpy as np
  os.makedirs(directory, exist_ok=True)
  rng = np.random.default_rng(seed)
  item_cate = rng.integers(0, DSSM_CATES, n_items)
  item_price = rng.random(n_items)
  weights = 1.0 / np.power(np.arange(1, n_items + 1), 1.1)
  paths = {name: os.path.join(directory, name) for name in
           ('train.csv', 'eval.csv', 'items.txt', 'edges.txt')}
  with open(paths['items.txt'], 'w') as f:
    f.write('id:int64\tweight:float\tfeature:string\n')
    f.write(''.join('i%d\t%.6g\ti%d:c%d:%.4f\n' % (i, weights[i], i,
                                                   item_cate[i],
                                                   item_price[i])
                    for i in range(n_items)))

  def zipf(n, size):
    return np.clip(np.floor(n * np.power(rng.random(size), 3.0)), 0,
                   n - 1).astype(np.int64)

  for name, rows in (('train.csv', train_rows), ('eval.csv', eval_rows)):
    items = zipf(n_items, rows)
    users = zipf(n_users, rows)
    n_tags = rng.integers(1, 9, rows)
    tags = rng.integers(0, DSSM_TAGS, (rows, 8))
    n_seq = rng.integers(1, 51, rows)
    seq = rng.integers(0, DSSM_CATES, (rows, 50))
    label = (rng.random(rows) < 1 / 3).astype(np.int64)
    age, teacher = rng.random(rows), rng.random(rows)
    values = {
        'label': ['%d' % v for v in label],
        'uid': ['u%d' % v for v in users],
        'iid': ['i%d' % v for v in items],
        'cate': ['c%d' % item_cate[v] for v in items],
        'tags': ['|'.join('t%d' % t for t in tags[r, :n_tags[r]])
                 for r in range(rows)],
        'age': ['%.4f' % v for v in age],
        'price': ['%.4f' % item_price[v] for v in items],
        'seq_cate': ['|'.join('c%d' % c for c in seq[r, :n_seq[r]])
                     for r in range(rows)],
        'teacher': ['%.4f' % v for v in teacher]}
    with open(paths[name], 'w') as f:
      f.write(''.join(','.join(parts) + '\n'
                      for parts in zip(*(values[c] for c in cols))))
  if edges:
    with open(paths['edges.txt'], 'w') as f:
      f.write(''.join('u%d\ti%d\t1.0\n' % (u, i) for u in range(n_users)
                      for i in rng.choice(n_items, 3, replace=False)))
  return paths


def match_config(name, data):
  """samples/<name>.config on write_dssm_data's files in `data`, written
  with the sample's input_fields, small: batch and eval batch 256, hash
  buckets at most 1,000, with MATCH_EDITS."""
  from easyrec_torch.config import config_util
  with open(os.path.join(HERE, 'samples', name + '.config')) as f:
    text = f.read()
  for old, new in MATCH_EDITS:
    text = text.replace(old, new)
  cfg = config_util.get_configs_from_pipeline_str(text)
  dc = cfg.data_config
  cfg.train_input_path = os.path.join(data, 'train.csv')
  cfg.eval_input_path = os.path.join(data, 'eval.csv')
  cfg.model_dir = ''
  which = dc.WhichOneof('sampler')
  if which:
    sampler = getattr(dc, which)
    for field in ('input_path', 'user_input_path', 'item_input_path',
                  'pos_edge_input_path', 'hard_neg_edge_input_path'):
      if getattr(sampler, field, ''):
        setattr(sampler, field, os.path.join(
            data, 'edges.txt' if 'edge' in field else 'items.txt'))
  dc.batch_size = dc.eval_batch_size = 256
  for fc in config_util.get_feature_configs(cfg):
    fc.hash_bucket_size = min(int(fc.hash_bucket_size), 1000)
  return cfg


def pipeline_batches(cfg, mode, n):
  """The first n batches of cfg's input pipeline in `mode`, with the
  extra fields its models read."""
  from easyrec_torch.config import config_util
  from easyrec_torch.data.input_pipeline import InputPipeline
  path = config_util.get_train_input_path(cfg) if mode == 'train' else \
      config_util.get_eval_input_path(cfg)
  pipe = InputPipeline(cfg.data_config,
                       config_util.get_feature_configs(cfg), path, mode=mode,
                       extra_fields=config_util.collect_extra_fields(cfg))
  out = [b for _, b in zip(range(n), pipe)]
  if len(out) != n:
    fail('%s input of %s gave %d batches, %d asked' % (mode, path, len(out),
                                                        n))
  return out


def phase_match(torch):
  """The agree phase for each match sample, small, on its own pipeline's
  batches (write_dssm_data's columns, 1,000 items and 300 users): 3 steps
  card against CPU from one state, unfused (K1 + K2), and fused (K3) for
  MATCH_FUSED; the eval of 2 batches (auc, recall@k, the errors) held
  card against CPU from the shared state and from the card's trained
  state."""
  from easyrec_torch.config import config_util
  launches = {}
  for name in MATCH_SAMPLES:
    data = os.path.join(SCRATCH, 'match', name)
    cols = [f.input_name for f in config_util.get_configs_from_pipeline_file(
        os.path.join(HERE, 'samples', name + '.config'))
            .data_config.input_fields]
    write_dssm_data(data, cols=cols, n_items=1000, n_users=300,
                    train_rows=768, eval_rows=512, edges=True, seed=7)
    cfg = match_config(name, data)
    batches = {'train': pipeline_batches(cfg, 'train', 3),
               'eval': pipeline_batches(cfg, 'eval', 2)}
    for fused in ('0', '1') if name in MATCH_FUSED else ('0',):
      for k, c in phase_agree(torch, 'match sample %s' % name, cfg, fused,
                              batches=batches).items():
        launches[k] = launches.get(k, 0) + c
  log('agree: launches by kernel and math over the match samples: %s'
      % launches)


def dssm_pack(torch, cfg):
  """A trainer of the full-width DSSM on the card and the id stream its
  sparse update takes from one batch of its pipeline: the base batch's
  pack, then the `neg.` view's, concatenated (Trainer's view_stream)."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  trainer = Trainer(cfg, device='cuda')
  batch = to_device(next(iter(trainer.train_input())), torch.device('cuda'))
  packs = emb_ops.pack_all_views(trainer.layout, batch)
  (key, meta), = trainer.metas.items()
  base, neg = packs[key].reshape(-1), packs['neg.' + key].reshape(-1)
  shared = int(torch.isin(torch.unique(neg), torch.unique(base)).sum())
  log('DSSM pack: table %s, %d base id slots and %d neg. slots (%d of '
      'them the filler id 0 of the features the view lacks), %d distinct '
      'ids in both views (segments that span the two)'
      % (key, base.numel(), neg.numel(), int((neg == 0).sum()), shared))
  return trainer, key, meta, torch.cat([base, neg])


def dssm_config(data, model_dir=''):
  """samples/dssm_neg_sampler.config at its published widths on
  write_dssm_data's full-width files in `data`."""
  from easyrec_torch.utils import flagship
  return flagship.dssm_neg_sampler_config(data, model_dir)


def phase_dssm(torch, card):
  """This slice's main path: the DSSM of samples/dssm_neg_sampler.config
  at its published widths (batch 1,024 and 1,024 sampled negatives a
  step, towers [256, 128, 64], uid and iid of 1,000,000 buckets, dim
  16, compact Adam) on write_dssm_data's generated files: K1 and K2 at
  its mixed base + neg. pack bit-exact against their plain versions,
  with times, bounds and index_add_'s; then train_and_evaluate unfused,
  num_steps cut to SLICE_STEPS: K1 and K2 once a step and table over
  both views' ids, K3-K5 never; its rate over its own pipeline's batches.
  Returns (the launches, (K1's, K2's) largest difference, what phase 26
  takes from the run: dssm_trained's and the model_dir's root)."""
  import shutil
  data = os.path.join(SCRATCH, 'dssm')
  t0 = time.time()
  write_dssm_data(data)
  log('dssm: wrote 1,000,000 items and %d train and 8,192 eval rows in '
      '%.1f s' % ((SLICE_STEPS + 4) * 1024, time.time() - t0))
  errs = phase_kernel_path(torch, dssm_config(data), 'DSSM', pack=dssm_pack,
                           yardsticks=True)
  # the run trains on phase 26's model_dir, which retrieves from it
  root = os.path.join(SCRATCH, 'retrieve')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  trained = {'root': root}
  # the operator's step trace: fit profiles its first logging window
  cfg = dssm_config(data, model_dir=os.path.join(root, 'md'))
  cfg.train_config.is_profiling = True
  counts = phase_slice(
      torch, card, 'DSSM (dssm_neg_sampler)', cfg, '0',
      ('seg_sum', 'rmw_rows'), 'compact_adam', pool=1, views=True,
      after=lambda result: trained.update(dssm_trained(torch, result,
                                                       data)))
  check_step_trace(os.path.join(root, 'md', 'profile',
                                'rank0.pt.trace.json'), 'DSSM')
  return counts, errs, trained


# the spans of every train step (easyrec_torch/utils/spans.py)
STEP_SPANS = ('easyrec.step', 'easyrec.pack', 'easyrec.pull',
              'easyrec.forward', 'easyrec.embed', 'easyrec.loss',
              'easyrec.backward', 'easyrec.dense_opt',
              'easyrec.sparse_update', 'easyrec.sparse_update.sort')


def check_step_trace(path, what):
  """The chrome trace fit writes under train_config.is_profiling (phase
  slice's log window: 5 steps): an easyrec.step span a step, every span of
  the step, and kernels on the card. Logs each span's count and host ms,
  the kernels' device ms and the synchronizing calls a step."""
  if not os.path.exists(path):
    fail('%s: is_profiling wrote no %s' % (what, path))
  with open(path) as f:
    events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
  spans = collections.Counter()
  host = collections.Counter()
  for e in events:
    if e.get('cat') == 'user_annotation' and \
        e['name'].startswith('easyrec.'):
      spans[e['name']] += 1
      host[e['name']] += float(e.get('dur', 0.0))
  kernels = [e for e in events if e.get('cat') == 'kernel']
  syncs = sum(1 for e in events if e.get('cat') == 'cuda_runtime' and
              e['name'] in ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
                            'cudaEventSynchronize', 'cudaMemcpy'))
  steps = spans['easyrec.step']
  log('%s step trace %s: %d easyrec.step spans, %d kernels (%.3f device ms '
      'a step), %.1f synchronizing calls a step; spans (count, host ms a '
      'step): %s' % (what, path, steps, len(kernels),
                     sum(float(e.get('dur', 0.0)) for e in kernels) / 1e3 /
                     max(steps, 1), syncs / max(steps, 1),
                     {n: (c, round(host[n] / 1e3 / max(steps, 1), 3))
                      for n, c in sorted(spans.items())}))
  if steps != 5:
    fail('%s step trace: %d easyrec.step spans, 5 expected' % (what, steps))
  missing = [n for n in STEP_SPANS if not spans[n]]
  if missing:
    fail('%s step trace: no %s span' % (what, ', '.join(missing)))
  if not kernels:
    fail('%s step trace: no device kernel' % what)


def dssm_trained(torch, result, data):
  """What phases 25 and 26 take from the DSSM's train_and_evaluate
  `result` (its launches read just after it): the run's summary, the
  eval columns, the Trainer's eval forward of 4,096 eval rows, and of
  1 and 4,096 raw request rows."""
  from easyrec_torch.ops import kernels
  trainer = result['trainer']
  cols = read_eval_columns(os.path.join(data, 'eval.csv'))
  rows4k = [{c: cols[c][i] for c in cols} for i in range(4096)]
  served = dssm_serve_rows(os.path.join(data, 'eval.csv'), 4096)
  return {'summary': (result['global_step'], result['losses'][0],
                      result['losses'][-1], result['eval_metrics']),
          'launches': kernels.launch_counts(),
          'tagged': kernels.tagged_counts(), 'cols': cols,
          'want': trainer_outputs(torch, trainer, rows4k),
          'served': served,
          'served_want': {n: trainer_outputs(torch, trainer, served[:n])
                          for n in (1, 4096)}}


def dssm_serve_rows(path, n):
  """The first n rows of a write_dssm_data CSV as raw request rows."""
  cols = MATCH_COLS[:8]
  rows = []
  with open(path) as f:
    for line in f:
      parts = dict(zip(cols, line.rstrip('\n').split(',')))
      for c in ('label', 'age', 'price'):
        parts[c] = float(parts[c])
      rows.append(parts)
      if len(rows) == n:
        break
  return rows


# the retrieve phase (26): the full-width DSSM's item corpus searched
HELD_QUERIES = 256        # queries held against a float64 numpy top-k
# rows of the vector_retrieve CLI's doc table, cut in depth from 100,000
# (a text table of that size took ~10 s to write and read)
DOC_ROWS = 20000
IVF_ROWS = 20000          # corpus rows of the IVF index held on the card


def read_items(path):
  """The columns iid, cate and price of a write_dssm_data items.txt."""
  import numpy as np
  with open(path) as f:
    next(f)
    feats = [line.rstrip('\n').split('\t')[2].split(':') for line in f]
  iid, cate, price = zip(*feats)
  return {'iid': np.array(iid, dtype=object),
          'cate': np.array(cate, dtype=object),
          'price': np.array(price, dtype=np.float64)}


def read_eval_columns(path):
  """The columns of a write_dssm_data eval.csv (MATCH_COLS[:8]), the
  numeric ones as float64."""
  import numpy as np
  with open(path) as f:
    rows = [line.rstrip('\n').split(',') for line in f]
  cols = {c: np.array([r[i] for r in rows], dtype=object)
          for i, c in enumerate(MATCH_COLS[:8])}
  for c in ('label', 'age', 'price'):
    cols[c] = cols[c].astype(np.float64)
  return cols


def held_topk(torch, index, queries, k, what):
  """The card's top-k of `queries` against a float64 numpy ranking over
  the whole corpus: each returned row's f32 score within 1e-5 of the
  row's score scale of its float64 score, the rows in float64 order up to
  that tolerance, and the set of rows the float64 top-k's but for rows
  tied with its k-th score within the tolerance. Returns the rows where
  such a tie changed which rows entered."""
  import numpy as np
  q = queries.astype(np.float64)
  corpus = index.embeddings.double().cpu().numpy()
  s64 = q @ corpus.T
  got_s, got_i = index.search(queries, k)
  top = np.argpartition(-s64, k, axis=1)[:, :k]
  order = np.argsort(-np.take_along_axis(s64, top, axis=1), axis=1,
                     kind='stable')
  want_i = np.take_along_axis(top, order, axis=1)
  tied_rows = 0
  for r in range(len(q)):
    scale = float(np.abs(s64[r]).max())
    tol = 1e-5 * scale
    exact = s64[r, got_i[r]]
    if np.abs(got_s[r] - exact).max() > tol:
      fail('%s: query %d, scores off their float64 values by %g (scale %g)'
           % (what, r, np.abs(got_s[r] - exact).max(), scale))
    if (np.diff(exact) > tol).any():
      fail('%s: query %d, rows out of order' % (what, r))
    if list(got_i[r]) != list(want_i[r]):
      kth = s64[r, want_i[r, -1]]
      diff = set(got_i[r]) ^ set(want_i[r])
      near = all(abs(s64[r, i] - kth) <= tol for i in diff)
      same_order = all(abs(s64[r, a] - s64[r, b]) <= tol
                       for a, b in zip(got_i[r], want_i[r]) if a != b)
      if not (near and same_order):
        fail('%s: query %d, top-%d rows %s, float64 %s' %
             (what, r, k, list(got_i[r][:8]), list(want_i[r][:8])))
      tied_rows += 1
  return tied_rows


def phase_retrieve(torch, smi, data, trained, n_users=8192, device='cuda'):
  """Retrieval after the full-width DSSM (phase 26): samples/
  dssm_neg_sampler.config on write_dssm_data's files in `data` trained
  SLICE_STEPS steps through train_and_evaluate on a model_dir (K1 + K2)
  by phase 24, which hands over `trained` (phase_dssm's), then
  main.export of its checkpoint and split_model's user and item towers;
  from the export on no K1-K5 launch. The item tower's Predictor embeds
  every item of items.txt into the corpus and the user tower's the eval
  rows; their embeddings of 4,096 eval rows must bit-equal the training
  Trainer's eval forward. An exact KnnIndex on the card searches the
  corpus for each eval user's top-10 and top-100 in its query batches
  (hitrate@k by each row's true item, recorded); the top-k of
  HELD_QUERIES users is held against a float64 numpy ranking; the search
  of one query batch is timed by CUDA events beside the bound of its
  function (the corpus and queries read, the top-k written, its f32
  operations) and that of the materialised design (its [B, N] scores
  also written and read); an
  IvfIndex of IVF_ROWS corpus rows probing all its clusters must equal
  the exact index. Then the
  hitrate CLI on the model_dir must print what compute_hitrate gives in
  process, and the vector_retrieve CLI on a DOC_ROWS-row doc table
  written from the corpus must write the in-process search's rows.
  Returns the training's launches by kernel and by kernel/math."""
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.config import config_util
  from easyrec_torch.export.predictor import Predictor
  from easyrec_torch.ops import kernels
  from easyrec_torch.retrieval import knn
  from easyrec_torch.retrieval.vector_retrieve import read_embedding_table
  from easyrec_torch.tools import hitrate, split_model
  what = 'retrieve'
  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = trained['root']
  gc.collect()
  if device == 'cuda':
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
  launched, tagged = trained['launches'], trained['tagged']
  # K7 pools the base batch's pack once a step; the 'neg.' view, which
  # lacks the user features, is split
  if device == 'cuda' and launched != dict(
      {k: 0 for k in launched}, seg_sum=SLICE_STEPS, rmw_rows=SLICE_STEPS,
      bag_pool=SLICE_STEPS, bag_pool_grad=SLICE_STEPS):
    fail('%s: training launched %s, K1, K2 and K7 once a step expected'
         % (what, launched))
  log('%s: the DSSM trained %d steps through train_and_evaluate on this '
      'phase\'s model_dir in phase 24 (losses %s ... %s; eval %s); '
      'launches %s' % ((what,) + trained['summary'] + (launched,)))
  cols, want = trained['cols'], trained['want']
  # phase 25 serves this export: raw request rows and their answers
  served, served_want = trained['served'], trained['served_want']
  if sorted(served_want[1]) != ['item_emb', 'user_emb']:
    fail('serve DSSM: the export outputs %s' % sorted(served_want[1]))

  kernels.reset_launches()
  t0 = time.perf_counter()
  export_dir = main_lib.export(os.path.join(root, 'md', 'pipeline.config'),
                               export_dir=os.path.join(root, 'export'),
                               device=device)
  towers = split_model.split_export(export_dir, os.path.join(root, 'split'),
                                    device=device)
  log('%s: main.export and split_model in %.1f s: %s'
      % (what, time.perf_counter() - t0, towers))
  if device == 'cuda':
    serve_bit_equal(torch, 'DSSM', export_dir, served, served_want, smi)
  user = Predictor(towers['user'], batch_size=4096, device=device)
  item = Predictor(towers['item'], batch_size=4096, device=device)
  for pred, out in ((user, 'user_emb'), (item, 'item_emb')):
    own = {c: cols[c][:4096] for c in pred.meta['required_columns']}
    got = pred.predict_columns(own)
    if sorted(got) != [out]:
      fail('%s: the %s tower answers %s' % (what, pred.meta['tower'],
                                            sorted(got)))
    if got[out].tobytes() != want[out].tobytes():
      fail('%s: the %s tower\'s %s of 4,096 rows differs from the Trainer\'s '
           'eval forward by up to %g' % (what, pred.meta['tower'], out,
                                         float(np.abs(got[out] -
                                                      want[out]).max())))
  log('%s: the split towers\' user_emb and item_emb of 4,096 eval rows, each '
      'fed only its own columns, bit-equal to the training Trainer\'s eval '
      'forward' % what)

  t0 = time.perf_counter()
  items = read_items(os.path.join(data, 'items.txt'))
  read_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  corpus = item.predict_columns(items)['item_emb']
  if device == 'cuda':
    torch.cuda.synchronize()
  embed_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  users = user.predict_columns(
      {c: cols[c][:n_users] for c in user.meta['required_columns']}
  )['user_emb']
  user_s = time.perf_counter() - t0
  n_items, dim = corpus.shape
  if not np.isfinite(corpus).all() or not np.isfinite(users).all():
    fail('%s: an embedding is not finite' % what)
  log('%s: items.txt read in %.3f s; the item tower embedded %d items '
      '(%d calls of 4,096 rows) into a [%d, %d] corpus in %.3f s; the user '
      'tower %d eval rows in %.3f s; %s'
      % (what, read_s, n_items, -(-n_items // 4096), n_items, dim, embed_s,
         len(users), user_s, smi))

  t0 = time.perf_counter()
  index = knn.KnnIndex(corpus, device=device)
  if device == 'cuda':
    torch.cuda.synchronize()
  build_s = time.perf_counter() - t0
  truth = np.array([int(i[1:]) for i in cols['iid'][:n_users]])
  rates = {}
  for k in (10, 100):
    t0 = time.perf_counter()
    rates[k] = knn.hitrate_at_k(index, users, truth, k)
    rates[k]['seconds'] = time.perf_counter() - t0
  held = HELD_QUERIES
  tied = {k: held_topk(torch, index, users[:held], k, what)
          for k in (10, 100)}
  log('%s: KnnIndex of %d items built in %.3f s; %s; the top-10 and top-100 '
      'of %d queries held against a float64 numpy ranking (rows whose '
      'k-th score ties a row left out: %s)'
      % (what, n_items, build_s, rates, held, tied))

  # the IVF index on the card, small (its probe gathers [B, nprobe, cap,
  # D] candidates): probing every cluster equals the exact index
  sub = corpus[:IVF_ROWS]
  ivf = knn.IvfIndex(sub, n_clusters=64, device=device)
  _, exact = knn.KnnIndex(sub, device=device).search(users[:held], 10)
  _, every = ivf.search(users[:held], 10, nprobe=64)
  if not np.array_equal(every, exact):
    fail('%s: the IVF index probing all 64 clusters differs from the exact '
         'index on %d of %d queries' % (what, int((every != exact).any(1)
                                                  .sum()), held))
  _, some = ivf.search(users[:held], 10, nprobe=8)
  recall = np.mean([len(set(a) & set(b)) / 10.0
                    for a, b in zip(some, exact)])
  log('%s: IvfIndex of the first %d corpus rows in 64 clusters on the card: '
      'probing all 64 equals the exact top-10 of %d queries; recall@10 at '
      'nprobe 8 %.4f' % (what, IVF_ROWS, held, recall))
  del ivf

  if device == 'cuda':
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)
    q = torch.from_numpy(users[:index.query_batch]).to(device)
    b = q.shape[0]
    ops = 2.0 * b * n_items * dim
    for k in (10, 100):
      ms = cuda_ms(torch, lambda: index.search_tensor(q, k), 5, flush)
      gemm_ms = cuda_ms(torch, lambda: index.scores(q), 5, flush)
      # the function: corpus and queries read, top-k scores (f32) and
      # rows (int64) written
      nbytes = n_items * dim * 4 + b * dim * 4 + b * k * (4 + 8)
      bound, by = bound_ms(nbytes, ops)
      # the materialised design: its [B, N] scores written and read too
      mat_bytes = nbytes + 2 * b * n_items * 4
      mat_bound, mat_by = bound_ms(mat_bytes, ops)
      log('%s: search of %d queries over %d items, top-%d: %.4f ms a query '
          'batch (of it the [%d, %d] GEMM %.4f ms); bound %.4f ms (%s: '
          '%d bytes, %.3g f32 operations); %.2f x the bound; the '
          'materialised design\'s bound %.4f ms (%s: %d bytes with the '
          'scores); %s'
          % (what, b, n_items, k, ms, b, n_items, gemm_ms, bound, by,
             nbytes, ops, ms / bound, mat_bound, mat_by, mat_bytes, smi))
    del flush

  # the hitrate CLI on the model_dir and the vector_retrieve CLI on a doc
  # table written from the corpus, each in a process of its own, both
  # started together and run beside compute_hitrate and the search here
  # (nothing is timed on the card meanwhile)
  md_cfg = os.path.join(root, 'md', 'pipeline.config')
  doc_path = os.path.join(root, 'docs.csv')
  q_path = os.path.join(root, 'queries.csv')
  t0 = time.perf_counter()
  with open(doc_path, 'w') as f:
    f.write(''.join('d%d,%s\n' % (i, '|'.join('%.6g' % x for x in v))
                    for i, v in enumerate(corpus[:DOC_ROWS])))
  with open(q_path, 'w') as f:
    f.write(''.join('q%d,%s\n' % (i, '|'.join('%.6g' % x for x in v))
                    for i, v in enumerate(users[:held])))
  out_path = os.path.join(root, 'retrieved.csv')
  t1 = time.perf_counter()
  clis = {name: subprocess.Popen(
      [sys.executable, '-m'] + argv, stdout=subprocess.PIPE,
      stderr=subprocess.PIPE, text=True, cwd=HERE) for name, argv in (
          ('hitrate', ['easyrec_torch.tools.hitrate', '--pipeline_config_path',
                       md_cfg, '--top_k', '10', '--device', device]),
          ('vector_retrieve', [
              'easyrec_torch.retrieval.vector_retrieve', '--query_table',
              q_path, '--doc_table', doc_path, '--output_table', out_path,
              '--top_k', '10', '--device', device]))}
  try:
    here = hitrate.compute_hitrate(
        config_util.get_configs_from_pipeline_file(md_cfg), 10,
        device=device)
    outs = {name: p.communicate(timeout=600) for name, p in clis.items()}
  finally:
    for p in clis.values():
      if p.poll() is None:
        p.kill()
        p.wait()
  cli_s = time.perf_counter() - t1
  for name, p in clis.items():
    if p.returncode != 0:
      fail('%s: %s CLI: %s' % (what, name, outs[name][1][-2000:]))
  cli = json.loads(outs['hitrate'][0].strip().splitlines()[-1])
  if cli != here:
    fail('%s: the hitrate CLI printed %s, compute_hitrate %s'
         % (what, cli, here))
  log('%s: python -m easyrec_torch.tools.hitrate on the model_dir: %s, as '
      'compute_hitrate in process' % (what, cli))
  doc_ids, doc_emb = read_embedding_table(doc_path)
  q_ids, q_emb = read_embedding_table(q_path)
  scores, ids = knn.KnnIndex(doc_emb, item_ids=doc_ids,
                             device=device).search_ids(q_emb, 10)
  with open(out_path) as f:
    lines = f.read().splitlines()
  if lines[0] != 'query,doc,score' or len(lines) != 1 + held * 10:
    fail('%s: vector_retrieve wrote %d lines' % (what, len(lines)))
  for n, line in enumerate(lines[1:]):
    qid, doc, score = line.split(',')
    i, j = divmod(n, 10)
    if qid != q_ids[i] or doc != ids[i, j] or \
        abs(float(score) - scores[i, j]) > 1e-5 * max(1.0, abs(scores[i, j])):
      fail('%s: vector_retrieve line %d %r, in process %s,%s,%g'
           % (what, n + 1, line, q_ids[i], ids[i, j], scores[i, j]))
  log('%s: python -m easyrec_torch.retrieval.vector_retrieve: %d queries '
      'over a %d-row doc table (tables written in %.1f s), its %d rows the '
      'in-process search\'s; both CLIs and compute_hitrate here in %.1f s'
      % (what, held, DOC_ROWS, t1 - t0, held * 10, cli_s))

  launched = kernels.launch_counts()
  if any(launched.values()):
    fail('%s: K1-K5 launched %s from the export on' % (what, launched))
  peak = torch.cuda.max_memory_allocated() / 1e9 if device == 'cuda' else 0
  log('%s: no K1-K5 launch from the export on; peak device memory %.3f GB; '
      'hitrate@10 %.6f, hitrate@100 %.6f (random labels: near chance, not '
      'held); %s' % (what, peak, rates[10]['hitrate@10'],
                     rates[100]['hitrate@100'], smi))
  del index, user, item, corpus
  shutil.rmtree(root, ignore_errors=True)
  shutil.rmtree(data, ignore_errors=True)
  if device == 'cuda':
    torch.cuda.empty_cache()
  return dict(launched, **tagged)


# the rest of the rank zoo (phase 27): each sample small, card against CPU
RANK_EXTRA_SAMPLES = (
    'cmbf', 'cmbf_image_only', 'cmbf_multi_loss', 'cmbf_text_only',
    'uniter', 'uniter_image_only', 'uniter_text_only', 'dbmtl_cmbf',
    'dbmtl_uniter', 'losses_pairwise', 'deepfm_ziln', 'deepfm_multi_cls',
    'gauc_session_metrics', 'multi_optimizer_freeze', 'deepfm_bf16')
RANK_EXTRA_FUSED = ('cmbf',)
# the agree runs' edits: Uniter's dropouts (UniterTower's defaults are
# 0.1; the card and the CPU draw apart) at 0, and precision, recall and
# accuracy beside gauc_session_metrics' grouped AUCs
RANK_EXTRA_EDITS = (
    ('uniter {\n    config {', 'uniter {\n    config {\n      '
     'hidden_dropout_prob: 0.0 attention_probs_dropout_prob: 0.0'),
    ('bottom_uniter {', 'bottom_uniter {\n      hidden_dropout_prob: 0.0 '
     'attention_probs_dropout_prob: 0.0'),
    ('metrics_set { session_auc { session_id_field: "cate" } }',
     'metrics_set { session_auc { session_id_field: "cate" } }\n'
     '  metrics_set { precision {} } metrics_set { recall {} }\n'
     '  metrics_set { accuracy {} }'))
# samples whose constant rate (0.001) the agree run cuts: dbmtl_cmbf's
# third loss parted card from CPU by 6.8e-5 relative at 0.001 (NVIDIA H100
# 80GB HBM3, 700 W), past the rule's 1e-5; rate_witness reads it each run
RANK_EXTRA_RATES = {'dbmtl_cmbf': 0.0001}
SAMPLE_RATE = 'constant_learning_rate { learning_rate: 0.001 }'


def write_rank_csv(path, cols, rows, label, seed):
  """A headerless CSV of the rank samples' columns (label, uid, iid, cate,
  tags, age, price, seq_cate, title, img_vec, lkp_map): ids Zipf-skewed
  over 300
  users and 1,000 items, 1-8 tags, 1-50 categories, 1-16 title words,
  64 image floats. `label`: 'binary' (one row in three 1), 'class4'
  (class ids 0-3) or 'ltv' (zero on two rows in three, else lognormal)."""
  import numpy as np
  rng = np.random.default_rng(seed)

  def zipf(n):
    return np.floor(n * np.power(rng.random(rows), 3.0)).astype(np.int64)

  n_tags, n_seq, n_title = (rng.integers(1, 9, rows), rng.integers(1, 51, rows),
                            rng.integers(1, 17, rows))
  tags, seq, title = (rng.integers(0, 200, (rows, 8)),
                      rng.integers(0, 50, (rows, 50)),
                      rng.integers(0, 500, (rows, 16)))
  img = rng.standard_normal((rows, 64))
  if label == 'class4':
    labels = ['%d' % v for v in rng.integers(0, 4, rows)]
  elif label == 'ltv':
    labels = ['%.4f' % v for v in np.where(
        rng.random(rows) < 2 / 3, 0.0, rng.lognormal(1.0, 1.0, rows))]
  else:
    labels = ['%d' % v for v in (rng.random(rows) < 1 / 3)]
  values = {
      'label': labels,
      'uid': ['u%d' % v for v in zipf(300)],
      'iid': ['i%d' % v for v in zipf(1000)],
      'cate': ['c%d' % v for v in rng.integers(0, 50, rows)],
      'tags': ['|'.join('t%d' % t for t in tags[r, :n_tags[r]])
               for r in range(rows)],
      'age': ['%.4f' % v for v in rng.random(rows)],
      'price': ['%.4f' % v for v in rng.random(rows)],
      'seq_cate': ['|'.join('c%d' % c for c in seq[r, :n_seq[r]])
                   for r in range(rows)],
      'title': ['|'.join('w%d' % w for w in title[r, :n_title[r]])
                for r in range(rows)],
      'img_vec': ['|'.join('%.4f' % x for x in img[r]) for r in range(rows)]}
  # lookup_feature's kv map (drawn last, so the other columns do not
  # change): 1-3 categories a row, and the row's own on half the rows
  values['lkp_map'] = [
      '|'.join('c%d:%.2f' % (c, w) for c, w in zip(
          ([int(cate[1:])] if own else []) + list(rng.integers(0, 50, k)),
          rng.random(k + 1)))
      for cate, own, k in zip(values['cate'], rng.random(rows) < 0.5,
                              rng.integers(1, 4, rows))]
  with open(path, 'w') as f:
    f.write(''.join(','.join(parts) + '\n'
                    for parts in zip(*(values[c] for c in cols))))


def rank_extra_config(name, data, rate=None):
  """samples/<name>.config with RANK_EXTRA_EDITS, and its constant rate
  at `rate` where given, on write_rank_csv's files of its columns in
  `data`, small: batch and eval batch 256, hash buckets at most 1,000,
  model_dir cleared."""
  from easyrec_torch.config import config_util
  with open(os.path.join(HERE, 'samples', name + '.config')) as f:
    text = f.read()
  edits = RANK_EXTRA_EDITS
  if rate is not None:
    if SAMPLE_RATE not in text:
      fail('samples/%s.config has no %r' % (name, SAMPLE_RATE))
    edits += ((SAMPLE_RATE, SAMPLE_RATE.replace('0.001', repr(rate))),)
  for old, new in edits:
    text = text.replace(old, new)
  cfg = config_util.get_configs_from_pipeline_str(text)
  dc = cfg.data_config
  cols = [f.input_name for f in dc.input_fields]
  label = 'class4' if int(cfg.model_config.num_class) > 1 and \
      cfg.model_config.loss_type == 'CLASSIFICATION' else \
      'ltv' if cfg.model_config.loss_type == 'ZILN_LOSS' else 'binary'
  os.makedirs(data, exist_ok=True)
  for split, rows, seed in (('train', 768, 11), ('eval', 512, 12)):
    write_rank_csv(os.path.join(data, split + '.csv'), cols, rows, label,
                   seed)
  cfg.train_input_path = os.path.join(data, 'train.csv')
  cfg.eval_input_path = os.path.join(data, 'eval.csv')
  cfg.model_dir = ''
  dc.batch_size = dc.eval_batch_size = 256
  for fc in config_util.get_feature_configs(cfg):
    fc.hash_bucket_size = min(int(fc.hash_bucket_size), 1000)
  return cfg


def rate_witness(torch, name, data):
  """The readings behind a cut of RANK_EXTRA_RATES, not held: `name` at
  its sample's rate 0.001 trains 3 steps on the same batches as two
  trainers on the card, one on the CPU, and one on the CPU whose dense
  weights start one f32 ulp up, all from one state. Logs each loss
  term's largest relative gap per step, card against CPU, card against
  card and CPU against the perturbed CPU; then the dense parameters
  furthest apart card against CPU and the table weights past 1e-5."""
  from easyrec_torch.train.trainer import Trainer, to_device
  os.environ['EASYREC_PACKED_FUSED'] = '0'
  cfg = rank_extra_config(name, data, rate=0.001)
  train = pipeline_batches(cfg, 'train', 3)
  runs = {}
  for key, dev in (('cpu', 'cpu'), ('cuda', 'cuda'), ('cuda2', 'cuda'),
                   ('cpu_ulp', 'cpu')):
    runs[key] = Trainer(cfg, device=dev)
    runs[key].init_state()
  for key in ('cuda', 'cuda2', 'cpu_ulp'):
    runs[key].model.load_state_dict(runs['cpu'].model.state_dict())
    for k, table in runs['cpu'].tables.items():
      runs[key].tables[k].copy_(table)
  with torch.no_grad():
    for p in runs['cpu_ulp'].model.parameters():
      p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
  losses = {key: [{k: float(v) for k, v in t.train_step(
      to_device(b, t.device)).items()} for b in train]
      for key, t in runs.items()}
  for a, b in (('cpu', 'cuda'), ('cuda', 'cuda2'), ('cpu', 'cpu_ulp')):
    gaps = [{k: abs(x[k] - y[k]) / max(1.0, abs(x[k])) for k in x}
            for x, y in zip(losses[a], losses[b])]
    log('agree: %s at rate 0.001, %s against %s: loss terms\' relative gaps '
        'by step %s' % (name, b, a, gaps))
  cpu = dict(runs['cpu'].model.named_parameters())
  far = sorted(((float((p.detach().cpu() - cpu[n]).abs().max()), n)
                for n, p in runs['cuda'].model.named_parameters()),
               reverse=True)[:4]
  past = sum(int(((runs['cuda'].tables[k][:, :m.dim].cpu() -
                   runs['cpu'].tables[k][:, :m.dim]).abs() > 1e-5).sum())
             for k, m in runs['cpu'].metas.items())
  log('agree: %s at rate 0.001 after 3 steps, card against CPU: dense '
      'parameters furthest apart %s; table weights past 1e-5: %d'
      % (name, far, past))


def phase_rank_extra(torch):
  """The rest of the rank zoo (phase 27): each of RANK_EXTRA_SAMPLES small
  on its own pipeline's batches of write_rank_csv's files (the sample's
  own features, batch 256, hash buckets at most 1,000) trains 3 steps on
  the card and the CPU from one state, unfused, and RANK_EXTRA_FUSED
  fused as well, at the agree phase's rule (deepfm_bf16 at its bf16
  rule), under EASYREC_ATTN_IMPL=stock with the dropouts at 0, each at
  RANK_EXTRA_RATES' rate where it names one (then rate_witness's
  readings at the sample's own); the eval (auc, gauc, session_auc,
  accuracy, precision, recall) held card against CPU through
  hold_evals, and deepfm_ziln's probabilities and expected values."""
  from easyrec_torch.train.trainer import Trainer
  os.environ['EASYREC_ATTN_IMPL'] = 'stock'
  launches = {}
  try:
    for name in RANK_EXTRA_SAMPLES:
      data = os.path.join(SCRATCH, 'rank_extra', name)
      cfg = rank_extra_config(name, data, RANK_EXTRA_RATES.get(name))
      batches = {'train': pipeline_batches(cfg, 'train', 3),
                 'eval': pipeline_batches(cfg, 'eval', 2)}
      if name == 'deepfm_ziln':
        runs = {}
        for dev in ('cpu', 'cuda'):
          runs[dev] = Trainer(cfg, device=dev)
          runs[dev].init_state()
        runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
        for key, table in runs['cpu'].tables.items():
          runs['cuda'].tables[key].copy_(table)
        hold_eval_outputs(torch, runs, batches['eval'], name,
                          ('probs', 'y'), 1e-5)
        del runs
      for fused in ('0', '1') if name in RANK_EXTRA_FUSED else ('0',):
        got = phase_agree(torch, 'rank sample %s' % name, cfg, fused,
                          batches=batches)
        for k, c in got.items():
          launches[k] = launches.get(k, 0) + c
      if name in RANK_EXTRA_RATES:
        rate_witness(torch, name, data)
  finally:
    os.environ.pop('EASYREC_ATTN_IMPL', None)
  log('agree: launches by kernel and math over the rank samples: %s'
      % launches)

# the fg-driven Taobao DIN (phase 29) and the feature samples (phase 28)
FG_CONFIG = os.path.join(HERE, 'samples', 'taobao_fg.config')
FG_JSON = os.path.join(HERE, 'samples', 'fg', 'taobao_fg.json')
# Taobao's ad-display ids (the Ali-CCP / Taobao display-ad click log the
# fg's schema comes from): users, ad groups, categories, brands
FG_IDS = {'user_id': 1141729, 'adgroup_id': 846811, 'cate_id': 12977,
          'brand': 461497, 'tags': 10000}
FEATURE_SAMPLES = ('combo_cross', 'expr_feature', 'lookup_feature',
                   'taobao_fg', 'deepfm_incr_save', 'ev_incr_save')
FEATURE_FUSED = ('ev_incr_save',)


def write_fg_data(directory, train_rows=(SLICE_STEPS + 4) * 1024,
                  eval_rows=4096, seed=2026):
  """train.csv and eval.csv of samples/fg/taobao_fg.json's columns, in
  the fg's column order (utils/fg_util.convert_rtp_fg): clk on one row in
  twenty; user_id, adgroup_id, cate_id and brand Zipf-skewed over FG_IDS;
  cms_segid, final_gender_code, age_level and occupation uniform over
  their few values; price log-uniform over [0.1, 10,000) (all five of the
  fg's buckets); 1-8 tags; a click sequence of 0-60 (cate_id, brand)
  pairs, the two columns aligned. Returns the paths by name."""
  import numpy as np
  from easyrec_torch.utils.fg_util import convert_rtp_fg
  with open(FG_JSON) as f:
    cols = [fd.input_name for fd in convert_rtp_fg(json.load(f))[
        'input_fields']]
  os.makedirs(directory, exist_ok=True)
  rng = np.random.default_rng(seed)

  def zipf(n, size):
    return np.clip(np.floor(n * np.power(rng.random(size), 3.0)), 0,
                   n - 1).astype(np.int64)

  paths = {}
  for name, rows in (('train.csv', train_rows), ('eval.csv', eval_rows)):
    n_tags, n_seq = rng.integers(1, 9, rows), rng.integers(0, 61, rows)
    tags = zipf(FG_IDS['tags'], (rows, 8))
    seq_cate = zipf(FG_IDS['cate_id'], (rows, 60))
    seq_brand = zipf(FG_IDS['brand'], (rows, 60))
    values = {
        'clk': ['%d' % v for v in rng.random(rows) < 0.05],
        'user_id': ['%d' % v for v in zipf(FG_IDS['user_id'], rows)],
        'cms_segid': ['%d' % v for v in rng.integers(0, 97, rows)],
        'final_gender_code': ['%d' % v for v in rng.integers(1, 3, rows)],
        'age_level': ['%d' % v for v in rng.integers(0, 7, rows)],
        'occupation': ['%d' % v for v in rng.integers(0, 2, rows)],
        'adgroup_id': ['%d' % v for v in zipf(FG_IDS['adgroup_id'], rows)],
        'cate_id': ['%d' % v for v in zipf(FG_IDS['cate_id'], rows)],
        'brand': ['%d' % v for v in zipf(FG_IDS['brand'], rows)],
        'price': ['%.2f' % v for v in 0.1 * 1e5 ** rng.random(rows)],
        'tags': ['|'.join('%d' % t for t in tags[r, :n_tags[r]])
                 for r in range(rows)],
        'click_seq__cate_id': ['|'.join('%d' % c for c in
                                        seq_cate[r, :n_seq[r]])
                               for r in range(rows)],
        'click_seq__brand': ['|'.join('%d' % b for b in
                                      seq_brand[r, :n_seq[r]])
                             for r in range(rows)]}
    paths[name] = os.path.join(directory, name)
    with open(paths[name], 'w') as f:
      f.write(''.join(','.join(parts) + '\n'
                      for parts in zip(*(values[c] for c in cols))))
  return paths


def csv_rows(path, names, n):
  """The first n rows of a headerless CSV as {column: string} dicts, the
  raw requests a user sends."""
  import csv as csv_lib
  with open(path, newline='') as f:
    return [dict(zip(names, r)) for _, r in zip(range(n),
                                                csv_lib.reader(f))]


def pipeline_pack(torch, cfg):
  """phase_kernel_path's pack at a main path's shape (the fg DIN's, the
  Criteo-binary DeepFM's): a trainer of `cfg` on the card and the ids of
  the first batch of its own input."""
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.train.trainer import Trainer, to_device
  trainer = Trainer(cfg, device='cuda')
  batch = to_device(pipeline_batches(cfg, 'train', 1)[0],
                    torch.device('cuda'))
  (key, meta), = trainer.metas.items()
  return trainer, key, meta, emb_ops.pack_ids(trainer.layout,
                                              batch)[key].reshape(-1)


def phase_fg_din(torch, card, smi):
  """Phase 29: samples/taobao_fg.config through train_and_evaluate on a
  model_dir, fg_json_path pointing at samples/fg/taobao_fg.json (the
  config and the fg unchanged but the paths), on write_fg_data's files,
  unfused: first K1 (every mode) and K2 (compact Adam) bit-exact against
  their plain versions on its first batch's pack (phase_kernel_path, with
  the yardsticks); then the published widths checked on the trainer's
  specs, K1 and K2 once a step, K3-K5 never, finite losses and an auc;
  then its rate over its own pipeline's batches, launches a step, peak
  memory, and the host time of the combo feature's transform and of all
  transforms on one batch's columns; its export served bit-equal to the
  Trainer's eval forward. Returns the launches by kernel and math, and
  K1's and K2's largest differences."""
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.features import transforms as tr
  from easyrec_torch.ops import kernels
  from easyrec_torch.train.trainer import to_device

  what = 'fg Taobao DIN'
  os.environ['EASYREC_PACKED_FUSED'] = '0'
  root = os.path.join(SCRATCH, 'fg_din')
  shutil.rmtree(root, ignore_errors=True)
  paths = write_fg_data(os.path.join(root, 'data'))
  edits = {'fg_json_path': FG_JSON,
           'train_input_path': paths['train.csv'],
           'eval_input_path': paths['eval.csv'],
           'model_dir': os.path.join(root, 'md'),
           'train_config.num_steps': SLICE_STEPS,
           'train_config.save_checkpoints_steps': SLICE_STEPS,
           'train_config.log_step_count_steps': 5}
  errs = phase_kernel_path(torch, main_lib.load_config(FG_CONFIG, edits),
                           what, pack=pipeline_pack, yardsticks=True)
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  held = torch.cuda.memory_allocated()
  kernels.reset_launches()
  t0 = time.time()
  result = main_lib.train_and_evaluate(FG_CONFIG, edit_config_json=edits,
                                       device='cuda')
  torch.cuda.synchronize()
  wall = time.time() - t0
  counts, tagged = kernels.launch_counts(), kernels.tagged_counts()
  peak = torch.cuda.max_memory_allocated()
  trainer = result['trainer']
  specs = trainer.specs
  widths = {name: (specs[name].rows, specs[name].num_ids,
                   specs[name].embedding_dim)
            for name in ('user_id', 'adgroup_id', 'brand', 'uid_x_cate',
                         'cate_id', 'tags', 'price', 'click_seq__cate_id',
                         'click_seq__brand')}
  want_widths = {'user_id': (100000, 1, 16), 'adgroup_id': (100000, 1, 16),
                 'brand': (100000, 1, 16), 'uid_x_cate': (100000, 1, 16),
                 'cate_id': (10000, 1, 16), 'tags': (10000, 16, 16),
                 'price': (5, 1, 16), 'click_seq__cate_id': (10000, 50, 16),
                 'click_seq__brand': (100000, 50, 16)}
  towers = [list(t.dnn.hidden_units)
            for t in trainer.pipeline_config.model_config.multi_tower.towers]
  if widths != want_widths or towers != [[128, 64], [128, 64]] or \
      specs['uid_x_cate'].config.feature_type != 'ComboFeature':
    fail('%s: widths %s, towers %s' % (what, widths, towers))
  losses = result['losses']
  n_tables = len(trainer.tables)
  log('%s: train_and_evaluate through fg_json_path, EASYREC_PACKED_FUSED=0, '
      '%d steps in %.1f s (set-up, input, checkpoint, eval and export '
      'included); widths (rows, ids a row, dim) %s; towers %s; losses %s; '
      'eval %s; launches %s; by math %s'
      % (what, result['global_step'], wall, widths, towers,
         ['%.6f' % x for x in losses], result.get('eval_metrics'), counts,
         tagged))
  if result['global_step'] != SLICE_STEPS or \
      not all(math.isfinite(x) for x in losses):
    fail('%s: %d steps, losses %s' % (what, result['global_step'], losses))
  auc = result.get('eval_metrics', {}).get('auc')
  if auc is None or not 0.0 <= auc <= 1.0:
    fail('%s: eval auc %r' % (what, auc))
  for name, c in counts.items():
    want = SLICE_STEPS * n_tables if name in ('seg_sum', 'rmw_rows') else 0
    if c != want:
      fail('%s: kernel %s launched %d times in %d steps over %d tables, %d '
           'expected' % (what, name, c, SLICE_STEPS, n_tables, want))
  if tagged != {'rmw_rows/compact_adam': SLICE_STEPS * n_tables}:
    fail('%s: K2 launched with the block maths %s' % (what, tagged))

  # the served answers are held to this state, before the rate's steps
  names = [f.input_name for f in trainer.data_config.input_fields]
  rows = csv_rows(paths['eval.csv'], names, 1024)
  want = {n: trainer_outputs(torch, trainer, rows[:n]) for n in (1, 1024)}
  pipe = trainer.train_input()
  batches = [to_device(b, torch.device('cuda'))
             for _, b in zip(range(4), pipe)]
  for b in batches[:3]:
    trainer.train_step(b)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(RATE_STEPS):
    out = trainer.train_step(batches[i % len(batches)])
  torch.cuda.synchronize()
  dt = (time.perf_counter() - t0) / RATE_STEPS
  if not math.isfinite(float(out['total_loss'])):
    fail('%s rate: a loss is not finite' % what)
  columns = next(iter(pipe.reader.chunks(1024)))
  combo = tr.build_transform(specs['uid_x_cate'])
  every = tr.build_transforms(specs)
  combo_s, all_s = [], []
  for _ in range(5):
    t0 = time.perf_counter()
    combo(columns)
    combo_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    tr.apply_transforms(every, columns)
    all_s.append(time.perf_counter() - t0)
  log('train step (%s, batch %d, pre-built input-pipeline batches on the '
      'device): %.3f ms/step, %.1f examples/s on %s; launches a step %s; '
      'peak device memory %.3f GB (%.3f GB held before it started); host '
      'transforms of one batch\'s 1,024 rows: the uid_x_cate combo p50 %.3f '
      'ms, all %d features p50 %.3f ms'
      % (what, 1024, dt * 1e3, 1024 / dt, card,
         {k: c / SLICE_STEPS for k, c in counts.items() if c}, peak / 1e9,
         held / 1e9, np.median(combo_s) * 1e3, len(specs),
         np.median(all_s) * 1e3))

  export_dir = result['export_dir']
  del result, trainer, batches, pipe
  torch.cuda.empty_cache()
  serve_bit_equal(torch, what, export_dir, rows, want, smi)
  shutil.rmtree(root, ignore_errors=True)
  return dict(counts, **tagged), errs


def feature_sample_config(name, data):
  """samples/<name>.config small, as rank_extra_config cuts a sample; the
  fg sample with its fg.json's fields and features loaded, on
  write_fg_data's files in `data`."""
  from easyrec_torch.config import config_util
  from easyrec_torch.utils.fg_util import load_fg_json_to_config
  cfg = config_util.get_configs_from_pipeline_file(
      os.path.join(HERE, 'samples', name + '.config'))
  if not cfg.fg_json_path:
    return rank_extra_config(name, data)
  cfg.fg_json_path = FG_JSON
  load_fg_json_to_config(cfg)
  paths = write_fg_data(data, train_rows=768, eval_rows=512)
  cfg.train_input_path = paths['train.csv']
  cfg.eval_input_path = paths['eval.csv']
  cfg.model_dir = ''
  dc = cfg.data_config
  dc.batch_size = dc.eval_batch_size = 256
  for fc in config_util.get_feature_configs(cfg):
    fc.hash_bucket_size = min(int(fc.hash_bucket_size), 1000)
  return cfg


def hold_update_ids(torch, what, cfg, batches, data):
  """Two trainers, on the card and the CPU, from one state, each with an
  IncrementalPublisher of cfg's incr_save_config into a directory of its
  own: a base snapshot, then 3 steps on `batches`, publishing after each.
  Every update's sparse ids must be equal card against CPU; its values
  are logged beside them."""
  import numpy as np
  from easyrec_torch.train import incremental as incr_lib
  from easyrec_torch.train.trainer import Trainer, to_device
  runs, pubs = {}, {}
  for dev in ('cpu', 'cuda'):
    runs[dev] = Trainer(cfg, device=dev)
    runs[dev].init_state()
  runs['cuda'].model.load_state_dict(runs['cpu'].model.state_dict())
  for key, table in runs['cpu'].tables.items():
    runs['cuda'].tables[key].copy_(table)
  for dev, t in runs.items():
    pubs[dev] = incr_lib.IncrementalPublisher(
        cfg.train_config.incr_save_config, os.path.join(data, dev))
    pubs[dev].publish(t, 0)
  rows, gap = [], 0.0
  for step, b in enumerate(batches, 1):
    blobs = {}
    for dev, t in runs.items():
      t.train_step(to_device(b, torch.device(dev)))
      blobs[dev] = incr_lib.read_update(pubs[dev].publish(t, step))
    for key in runs['cpu'].tables:
      a = blobs['cpu'].get('sparse_ids/' + key)
      c = blobs['cuda'].get('sparse_ids/' + key)
      if a is None or c is None or not np.array_equal(a, c):
        fail('incr %s: step %d update of table %s: card ids %s, CPU %s'
             % (what, step, key, None if c is None else c.size,
                None if a is None else a.size))
      rows.append(int(a.size))
      gap = max(gap, float(np.abs(blobs['cpu']['sparse_vals/' + key] -
                                  blobs['cuda']['sparse_vals/' + key]).max()))
  log('agree: small %s: updates after each of 3 steps, card and CPU '
      'publishers: sparse ids equal (%s rows by step and table); their '
      'values within %g' % (what, rows, gap))


def phase_feature_samples(torch):
  """Phase 28: each of FEATURE_SAMPLES small on its own pipeline's
  batches trains 3 steps on the card and the CPU from one state at the
  agree phase's rule, unfused, and FEATURE_FUSED fused as well, its eval
  held card against CPU through hold_evals; the incremental samples'
  updates' ids card against CPU (hold_update_ids)."""
  import shutil
  launches = {}
  for name in FEATURE_SAMPLES:
    data = os.path.join(SCRATCH, 'feature_samples', name)
    cfg = feature_sample_config(name, data)
    batches = {'train': pipeline_batches(cfg, 'train', 3),
               'eval': pipeline_batches(cfg, 'eval', 2)}
    for fused in ('0', '1') if name in FEATURE_FUSED else ('0',):
      got = phase_agree(torch, 'feature sample %s' % name, cfg, fused,
                        batches=batches)
      for k, c in got.items():
        launches[k] = launches.get(k, 0) + c
      if cfg.train_config.HasField('incr_save_config'):
        hold_update_ids(torch, '%s, EASYREC_PACKED_FUSED=%s' % (name, fused),
                        cfg, batches['train'],
                        os.path.join(data, 'incr%s' % fused))
    shutil.rmtree(data, ignore_errors=True)
  log('agree: launches by kernel and math over the feature samples: %s'
      % launches)


# day_0: 86,016 records, the 20 steps' and one spare batch; day_1: 8,192
# records (2 eval batches). Cut from 64 and 10 batches to pay for phase 34
CRITEO_TRAIN_ROWS = 21 * 4096
CRITEO_EVAL_ROWS = 2 * 4096


def criteo_day_columns(n, seed):
  """The 40 columns of n Criteo day-log rows made from `seed`, as object
  arrays of strings ('' where blank): labels at a 0.25 click rate,
  integers from -2 up, ids a Zipf draw per feature scrambled over 32 bits
  (so about half are 0x80000000 or above) in hex, about 5% of the values
  blank (labels never)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  label = (rng.random(n) < 0.25).astype(np.int64)
  dense = rng.integers(-2, 2000, (n, 13))
  ranks = rng.zipf(1.15, (n, 26)).astype(np.uint64) % np.uint64(1 << 31)
  ids = (ranks * np.uint64(2654435761) +
         np.arange(26, dtype=np.uint64) * np.uint64(40503)) % \
      np.uint64(1 << 32)
  blank = rng.random((n, 39)) < 0.05
  cols = [np.array(label.astype(str), dtype=object)]
  for j in range(39):
    if j < 13:
      col = np.array(dense[:, j].astype(str), dtype=object)
    else:
      text = ids[:, j - 13].astype('>u4').tobytes().hex()
      col = np.array([text[k:k + 8] for k in range(0, 8 * n, 8)],
                     dtype=object)
    col[blank[:, j]] = ''
    cols.append(col)
  return cols


def write_criteo_days(directory, days=(('day_0', CRITEO_TRAIN_ROWS, 31),
                                       ('day_1', CRITEO_EVAL_ROWS, 32))):
  """Criteo day logs (TSV: label, 13 integer features, 26 hex ids) of
  criteo_day_columns' rows. Returns the TSV paths by day."""
  os.makedirs(directory, exist_ok=True)
  paths = {}
  for name, n, seed in days:
    cols = criteo_day_columns(n, seed)
    path = os.path.join(directory, name + '.tsv')
    with open(path, 'w') as f:
      f.writelines('\t'.join(row) + '\n' for row in zip(*cols))
    paths[name] = path
  return paths


def criteo_binary_config(paths):
  """The flagship DeepFM (criteo_deepfm_config, unchanged) on CriteoInput
  files: day_0.bin to train, day_1.bin to evaluate."""
  from easyrec_torch import main as main_lib
  from easyrec_torch.utils import flagship
  return main_lib.load_config(flagship.criteo_deepfm_config(), {
      'data_config.input_type': 'CriteoInput',
      'train_input_path': paths['day_0'], 'eval_input_path': paths['day_1']})


def phase_criteo_binary(torch, card, smi):
  """Phase 31, this slice's main path (phase 7 reads its input now): the
  flagship DeepFM from Criteo's binary layout. write_criteo_days writes
  the day TSVs (blanks, ids of 0x80000000 and above), tools/criteo_convert
  packs them (its seconds, bytes and rows/s), CriteoBinaryReader reads
  them back (rows/s; ids of 0x80000000 and above read as negative int64,
  the records equal to the converted ones); K1 (every mode) and K2 (compact
  Adam) bit-exact against their plain versions on one batch of this path
  (phase_kernel_path, pipeline_pack); then phase_slice (train_and_evaluate,
  20 steps, K1 and K2 once a step, the eval on day_1.bin; the rate,
  peak memory and launches), inside which the trained state is exported
  and tools/predict_and_chk predicts day_1.bin from the export and must
  equal the Trainer's eval forward on it (tolerance 0); tools/pre_check
  passes the config and two batches of its data; tools/view_export
  describes the export and runs its synthetic row on the card. Returns
  the launches by kernel and math, and K1's and K2's largest
  differences."""
  import shutil
  import numpy as np
  from easyrec_torch.data.input_pipeline import CriteoBinaryReader
  from easyrec_torch.export.saved_model import export_saved_model
  from easyrec_torch.ops import embedding as emb_ops
  from easyrec_torch.tools import criteo_convert, pre_check, predict_and_chk
  from easyrec_torch.tools import view_export
  from easyrec_torch.train.trainer import to_device

  what = 'flagship DeepFM, Criteo binary'
  root = os.path.join(SCRATCH, 'criteo_binary')
  shutil.rmtree(root, ignore_errors=True)
  t0 = time.time()
  tsv = write_criteo_days(os.path.join(root, 'tsv'))
  gen_s = time.time() - t0
  t0 = time.time()
  criteo_convert.main(['--input_path', os.path.join(root, 'tsv', 'day_*.tsv'),
                       '--output_dir', os.path.join(root, 'bin')])
  conv_s = time.time() - t0
  paths = {d: os.path.join(root, 'bin', d + '.bin') for d in tsv}
  n_rows = CRITEO_TRAIN_ROWS + CRITEO_EVAL_ROWS
  nbytes = sum(os.path.getsize(p) for p in paths.values())
  tsv_bytes = sum(os.path.getsize(p) for p in tsv.values())
  recs = np.fromfile(paths['day_0'], '<i4').reshape(-1, 40)
  if nbytes != n_rows * 160 or len(recs) != CRITEO_TRAIN_ROWS:
    fail('%s: converted %d bytes, %d records' % (what, nbytes, len(recs)))
  high = int((recs[:, 14:] < 0).sum())
  log('%s: day TSVs of %d rows (%d bytes) written in %.1f s; criteo_convert '
      'packed them into %d bytes in %.3f s, %.0f rows/s; %d of the %d '
      'train ids are 0x80000000 or above (negative int32), %d of its '
      'values read 0 (the blanks among them)'
      % (what, n_rows, tsv_bytes, gen_s, nbytes, conv_s, n_rows / conv_s,
         high, recs[:, 14:].size, int((recs[:, 1:] == 0).sum())))
  cfg = criteo_binary_config(paths)
  reader = CriteoBinaryReader(cfg.data_config, paths['day_0'])
  t0 = time.perf_counter()
  got = []
  for chunk in reader.chunks(65536):
    got.append(np.stack([chunk[f.input_name] for f in
                         cfg.data_config.input_fields[14:]], 1))
  read_s = time.perf_counter() - t0
  got = np.concatenate(got)
  if high == 0 or not np.array_equal(got, recs[:, 14:].astype(np.int64)):
    fail('%s: the reader\'s ids differ from the converted records' % what)
  log('%s: CriteoBinaryReader read %d records in %.3f s, %.0f rows/s; '
      'their ids equal the records\', the high ones negative'
      % (what, len(got), read_s, len(got) / read_s))
  errs = phase_kernel_path(torch, cfg, what, pack=pipeline_pack)

  exported = []

  def check_export(result):
    trainer = result['trainer']
    export_dir = export_saved_model(trainer, os.path.join(root, 'export'))
    exported.append(export_dir)
    # the Trainer's eval forward on every row of day_1.bin
    probs = []
    with torch.no_grad():
      for batch in trainer.eval_input():
        valid = batch['sample_weight'] > 0
        dev = to_device(batch, trainer.device)
        packs = emb_ops.pack_ids(trainer.layout, dev)
        pulled = emb_ops.pull_embeddings(trainer.tables, packs,
                                         trainer.metas)
        out = trainer.model.export_outputs(trainer.eval_forward(dev, pulled))
        probs.extend(out['probs'].cpu().numpy()[valid].tolist())
    want = os.path.join(root, 'want.csv')
    with open(want, 'w') as f:
      f.write('probs\n' + ''.join('%r\n' % p for p in probs))
    args = ['--export_dir', export_dir, '--input_path', paths['day_1'],
            '--output_path', os.path.join(root, 'pred.csv'), '--cmp_path',
            want, '--tol', '0', '--batch_size',
            str(trainer.data_config.eval_batch_size), '--device', 'cuda']
    t0 = time.time()
    try:
      predict_and_chk.main(args)
    except SystemExit as e:
      fail('%s: predict_and_chk exited %r: the export\'s answers differ '
           'from the Trainer\'s eval forward' % (what, e.code))
    log('%s: exported in %s; predict_and_chk --tol 0 on day_1.bin\'s %d '
        'rows matched the Trainer\'s eval forward (%.1f s)'
        % (what, export_dir, len(probs), time.time() - t0))
    if len(probs) != CRITEO_EVAL_ROWS:
      fail('%s: the eval forward gave %d rows' % (what, len(probs)))

  launches = phase_slice(torch, card, what, cfg, '0', ('seg_sum', 'rmw_rows'),
                         'compact_adam', after=check_export)
  t0 = time.time()
  problems = pre_check.check_config(cfg) + pre_check.check_data(cfg, 2)
  if problems:
    fail('%s: pre_check: %s' % (what, problems))
  summary = view_export.describe_export(exported[0])
  smoke = view_export.smoke_predict(summary['export_dir'], device='cuda')
  if not 0.0 < smoke.get('probs', -1.0) < 1.0:
    fail('%s: view_export --smoke gave %s' % (what, smoke))
  log('%s: pre_check passed the config and 2 batches; view_export: %d '
      'tensors, %d parameters, smoke probs %.6f (%.1f s, %s)'
      % (what, len(summary['variables']), summary['num_parameters'],
         smoke['probs'], time.time() - t0, smi))
  shutil.rmtree(root, ignore_errors=True)
  return launches, errs


class MockBroker:
  """tests/kafka_mock.py's in-process Kafka broker (Metadata v1,
  ListOffsets v1, Fetch v4 at most 500 records a partition, Produce v3,
  RecordBatch v2), its codec taken from easyrec_torch.data.kafka_client."""

  def __init__(self):
    # logs[(topic, partition)] = list of (key, value) in offset order
    self.logs = {}
    self.lock = threading.Lock()
    self._srv = None
    self._thread = None
    self.port = None

  # -- data ----------------------------------------------------------
  def create_topic(self, topic, partitions):
    with self.lock:
      for p in range(partitions):
        self.logs.setdefault((topic, p), [])

  def produce(self, topic, partition, value, key=None):
    with self.lock:
      self.logs.setdefault((topic, partition), []).append((key, value))

  # -- server --------------------------------------------------------
  def start(self):
    import socketserver
    import struct
    from easyrec_torch.data.kafka_client import (
        API_FETCH, API_LIST_OFFSETS, API_METADATA, API_PRODUCE,
        _Reader as _reader, _Writer,
        build_record_batch, parse_record_batches)
    broker = self

    class Handler(socketserver.BaseRequestHandler):
      def handle(self):
        try:
          while True:
            raw = self._read_exact(4)
            if raw is None:
              return
            size = struct.unpack('>i', raw)[0]
            body = self._read_exact(size)
            if body is None:
              return
            self._dispatch(_reader(body))
        except (ConnectionError, OSError):
          return

      def _read_exact(self, n):
        chunks = []
        while n > 0:
          try:
            b = self.request.recv(min(n, 1 << 20))
          except OSError:
            return None
          if not b:
            return None
          chunks.append(b)
          n -= len(b)
        return b''.join(chunks)

      def _dispatch(self, r):
        api_key = r.i16()
        api_version = r.i16()
        corr = r.i32()
        r.string()                             # client id
        w = _Writer()
        w.i32(corr)
        if api_key == API_METADATA and api_version == 1:
          self._metadata(r, w)
        elif api_key == API_LIST_OFFSETS and api_version == 1:
          self._list_offsets(r, w)
        elif api_key == API_FETCH and api_version == 4:
          self._fetch(r, w)
        elif api_key == API_PRODUCE and api_version == 3:
          self._produce(r, w)
        else:
          raise AssertionError('mock broker: unsupported api %d v%d'
                               % (api_key, api_version))
        out = w.getvalue()
        self.request.sendall(struct.pack('>i', len(out)) + out)

      def _metadata(self, r, w):
        n = r.i32()
        topics = [r.string() for _ in range(n)]
        host, port = broker._srv.server_address
        w.i32(1)                               # brokers
        w.i32(0)
        w.string('127.0.0.1')
        w.i32(port)
        w.string(None)                         # rack
        w.i32(0)                               # controller id
        with broker.lock:
          if not topics:
            topics = sorted({t for t, _ in broker.logs})
          w.i32(len(topics))
          for t in topics:
            parts = sorted(p for tt, p in broker.logs if tt == t)
            w.i16(0 if parts else 3)           # 3: unknown topic
            w.string(t)
            w.i8(0)                            # internal
            w.i32(len(parts))
            for p in parts:
              w.i16(0)
              w.i32(p)
              w.i32(0)                         # leader
              w.i32(1)
              w.i32(0)                         # replicas [0]
              w.i32(1)
              w.i32(0)                         # isr [0]

      def _produce(self, r, w):
        r.string()                             # transactional id
        r.i16()                                # acks
        r.i32()                                # timeout
        n_topics = r.i32()
        results = []                           # (topic, pid, base_offset)
        with broker.lock:
          for _ in range(n_topics):
            t = r.string()
            for _ in range(r.i32()):
              pid = r.i32()
              record_set = r.bytes_() or b''
              # auto-create topic-partition on produce (the broker
              # default the incr-update channel relies on)
              log = broker.logs.setdefault((t, pid), [])
              base = len(log)
              for _off, key, value in parse_record_batches(record_set):
                log.append((key, value))
              results.append((t, pid, base))
        w.i32(len(results))
        for t, pid, base in results:
          w.string(t)
          w.i32(1)
          w.i32(pid)
          w.i16(0)                             # error
          w.i64(base)
          w.i64(-1)                            # log append time
        w.i32(0)                               # throttle ms

      def _list_offsets(self, r, w):
        r.i32()                                # replica id
        n_topics = r.i32()
        reqs = []
        for _ in range(n_topics):
          t = r.string()
          parts = []
          for _ in range(r.i32()):
            parts.append((r.i32(), r.i64()))
          reqs.append((t, parts))
        w.i32(len(reqs))
        with broker.lock:
          for t, parts in reqs:
            w.string(t)
            w.i32(len(parts))
            for p, ts in parts:
              log = broker.logs.get((t, p))
              w.i32(p)
              if log is None:
                w.i16(3)
                w.i64(-1)
                w.i64(-1)
              else:
                w.i16(0)
                w.i64(-1)                      # timestamp
                w.i64(0 if ts == -2 else len(log))

      def _fetch(self, r, w):
        r.i32()                                # replica
        r.i32()                                # max wait
        r.i32()                                # min bytes
        r.i32()                                # max bytes
        r.i8()                                 # isolation
        n_topics = r.i32()
        reqs = []
        for _ in range(n_topics):
          t = r.string()
          parts = []
          for _ in range(r.i32()):
            pid = r.i32()
            off = r.i64()
            r.i32()                            # partition max bytes
            parts.append((pid, off))
          reqs.append((t, parts))
        w.i32(0)                               # throttle
        w.i32(len(reqs))
        with broker.lock:
          for t, parts in reqs:
            w.string(t)
            w.i32(len(parts))
            for pid, off in parts:
              log = broker.logs.get((t, pid), [])
              w.i32(pid)
              w.i16(0)
              w.i64(len(log))                  # high watermark
              w.i64(len(log))                  # last stable offset
              w.i32(0)                         # aborted txns
              if off < len(log):
                chunk = log[off:off + 500]
                w.bytes_(build_record_batch(off, chunk))
              else:
                w.bytes_(b'')

    srv = socketserver.ThreadingTCPServer(('127.0.0.1', 0), Handler)
    srv.daemon_threads = True
    srv.allow_reuse_address = True
    self._srv = srv
    self.port = srv.server_address[1]
    self._thread = threading.Thread(target=srv.serve_forever, daemon=True)
    self._thread.start()
    return '127.0.0.1:%d' % self.port

  def stop(self):
    if self._srv is not None:
      self._srv.shutdown()
      self._srv.server_close()
      self._srv = None


# 28.3 steps of 1,024 rows (40 before PR 16), for the 20 the phase reads:
# a run asks for the batch after its last, and the pipeline reads chunks
# of 4 batches, so a 20-step run needs 6 chunks (24,576 rows) in the topic
# (a train-mode stream polls on at its end)
KAFKA_PARTITIONS = (1240, 9240, 9240, 9240)


def phase_kafka_din(torch, card):
  """Phase 32: the Taobao DIN at its published widths, batch 1,024, fused
  (K3), streamed from Kafka, stopped and resumed. MockBroker serves a
  topic of 4 partitions; tools/kafka_topic writes 28.3 steps of
  write_din_csv's rows into it, one file a partition (rows/s), and a
  KafkaReader drains it in eval mode (rows/s). A Trainer trains 10 steps
  on one model_dir (a save at 10 with its data_offset.json), a fresh
  Trainer resumes from those offsets to step 20, and a third trains 20
  steps on another model_dir: the resumed run's every state tensor must
  equal the uninterrupted run's bit for bit, its losses the last ten of
  the uninterrupted run's, its data_offset.json the same text; K3 once a
  step and table in each run, K1, K2, K4 and K5 never. The broker returns
  at most 500 records a partition per fetch, so a resume keeps the
  uninterrupted order across partitions where the cut ends a fetch round
  (KafkaReader's docstring): partition 0 holds 1,240 rows and 1-3 9,240
  each, so step 10's 10,240 rows end the sixth round (1,240 + 3 x 3,000).
  Returns the uninterrupted run's launches by kernel and math."""
  import shutil
  from easyrec_torch import main as main_lib
  from easyrec_torch.data.input_pipeline import KafkaReader
  from easyrec_torch.ops import kernels
  from easyrec_torch.tools import kafka_topic
  from easyrec_torch.train.trainer import Trainer
  from easyrec_torch.utils import flagship

  what = 'Kafka Taobao DIN'
  os.environ['EASYREC_PACKED_FUSED'] = '1'
  root = os.path.join(SCRATCH, 'kafka_din')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  broker = MockBroker()
  server = broker.start()
  try:
    broker.create_topic('din', len(KAFKA_PARTITIONS))
    data = os.path.join(root, 'din.csv')
    write_din_csv(data, sum(KAFKA_PARTITIONS), seed=11)
    with open(data) as f:
      lines = f.readlines()
    t0 = time.time()
    lo = 0
    for p, n in enumerate(KAFKA_PARTITIONS):
      written = kafka_topic.write_topic(server, 'din', lines[lo:lo + n],
                                        partition=p)
      if written != n:
        fail('%s: kafka_topic wrote %d of %d rows' % (what, written, n))
      lo += n
    write_s = time.time() - t0

    def din_config(model_dir, steps):
      return main_lib.load_config(
          flagship.taobao_din_config(batch_size=1024, model_dir=model_dir), {
              'kafka_train_input': 'server: "%s" topic: "din"' % server,
              'data_config.input_type': 'KafkaInput',
              'data_config.shuffle': False,
              'train_config.num_steps': steps,
              'train_config.save_checkpoints_steps': 10})

    cfg = din_config('', 20)
    reader = KafkaReader(cfg.data_config, cfg.kafka_train_input)
    reader.mode = 'eval'
    t0 = time.perf_counter()
    n_read = sum(len(c['__stream_pid']) for c in reader.chunks(4096))
    read_s = time.perf_counter() - t0
    log('%s: kafka_topic wrote %d rows to %d partitions %s in %.2f s (%.0f '
        'rows/s); a KafkaReader drained them in %.3f s (%.0f rows/s)'
        % (what, lo, len(KAFKA_PARTITIONS), KAFKA_PARTITIONS, write_s,
           lo / write_s, read_s, n_read / read_s))
    if n_read != lo:
      fail('%s: the reader drained %d of %d rows' % (what, n_read, lo))

    def fit(model_dir, steps, want_steps):
      kernels.reset_launches()
      gc.collect()
      torch.cuda.empty_cache()
      torch.cuda.reset_peak_memory_stats()
      t = Trainer(din_config(model_dir, steps), device='cuda')
      t0 = time.time()
      r = t.fit(eval_at_end=False)
      torch.cuda.synchronize()
      wall = time.time() - t0
      counts, tagged = kernels.launch_counts(), kernels.tagged_counts()
      n_tables = len(t.tables)
      want = {name: (want_steps * n_tables if name == 'rmw_fused' else 0)
              for name in counts}
      if counts != want or len(r['losses']) != want_steps or \
          r['global_step'] != steps or \
          not all(math.isfinite(x) for x in r['losses']):
        fail('%s: %d steps to %d, launches %s (%s expected), losses %s'
             % (what, len(r['losses']), r['global_step'], counts, want,
                r['losses']))
      with open(os.path.join(model_dir, 'data_offset.json')) as f:
        offsets = f.read()
      return t, r, dict(counts, **tagged), offsets, wall, \
          torch.cuda.max_memory_allocated()

    cut_dir = os.path.join(root, 'cut')
    _, _, _, cut_offsets, _, _ = fit(cut_dir, 10, 10)
    resumed, rr, _, resumed_offsets, _, _ = fit(cut_dir, 20, 10)
    one, ro, launches, one_offsets, wall, peak = fit(
        os.path.join(root, 'whole'), 20, 20)

    sa, differ = state_differences(torch, resumed, one)
    log('%s: 10 steps, data_offset.json %s; a fresh Trainer resumed from '
        'those offsets to step 20: losses %s vs %s; %d of %d state tensors '
        'differ from the uninterrupted run; data_offset.json at 20: %s '
        '(uninterrupted: %s)'
        % (what, cut_offsets, ['%.6f' % x for x in rr['losses']],
           ['%.6f' % x for x in ro['losses'][10:]], len(differ), len(sa),
           resumed_offsets, one_offsets))
    if differ or rr['losses'] != ro['losses'][10:] or \
        resumed_offsets != one_offsets:
      fail('%s: the resumed run differs from the uninterrupted one in %s'
           % (what, differ[:20]))
    log('%s: uninterrupted 20 steps through Trainer.fit in %.2f s (%.3f '
        'ms/step, Kafka input, two saves and the first step\'s set-up '
        'included); launches %s; peak device memory %.3f GB on %s'
        % (what, wall, wall / 20 * 1e3, launches, peak / 1e9, card))
  finally:
    broker.stop()
  del resumed, one
  torch.cuda.empty_cache()
  shutil.rmtree(root, ignore_errors=True)
  return launches


SMALL_ROWS = 1500     # rows of each small reader's data (3 shards of 500)


def small_criteo_rows(n, seed):
  """Rows of the small Criteo schema (label, F1-F3, C1-C6) as strings."""
  import numpy as np
  rng = np.random.default_rng(seed)
  return [['%d' % (rng.random() < 0.3)] +
          ['%d' % v for v in rng.integers(0, 900, 3)] +
          ['%x' % v for v in rng.integers(0, 1 << 32, 6, dtype=np.uint64)]
          for _ in range(n)]


def small_deepfm(edits):
  """A small DeepFM on the Criteo schema (3 raw and 6 id features of
  1,000 buckets, batch 256, eval batch 256) with `edits`."""
  from easyrec_torch import main as main_lib
  from easyrec_torch.utils import flagship
  return main_lib.load_config(flagship.criteo_deepfm_config(
      batch_size=256, hash_bucket_size=1000, num_dense=3, num_cat=6),
      dict({'data_config.eval_batch_size': 256,
            'data_config.shuffle': False}, **edits))


def phase_small_readers(torch):
  """Phase 33: the small readers card against CPU (phase_agree on each
  reader's own pipeline batches): RTPInput ('\\002' between features),
  an ODPS table read from its CSV export under
  EASYREC_WAREHOUSE_EXPORT_DIR, and DataHubInput through
  tests/datahub_mock.py, whose batches after 3 come from a second
  pipeline resumed at the first one's last_batch_offsets and must equal
  the first pipeline's next 3. Each reader's rows/s is logged. Then two
  random trials of hpo/tuner.py on the warehouse DeepFM, 5 steps each, on
  the card and on the CPU: the same trial parameters (the seed's), each
  auc in [0, 1]."""
  import copy
  import shutil
  import numpy as np
  from easyrec_torch.hpo.tuner import LocalTuner
  from tests.datahub_mock import MockDataHub

  root = os.path.join(SCRATCH, 'small_readers')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  rows = small_criteo_rows(SMALL_ROWS, 5)
  names = ['label', 'F1', 'F2', 'F3'] + ['C%d' % i for i in range(1, 7)]

  def agree(what, cfg, train=None):
    if train is None:
      t0 = time.perf_counter()
      train = pipeline_batches(cfg, 'train', 3)
      read_s = time.perf_counter() - t0
      log('%s: the pipeline read 3 batches of 256 rows in %.3f s (%.0f '
          'rows/s, transforms included)' % (what, read_s, 768 / read_s))
    phase_agree(torch, what, cfg, '0', batches={
        'train': train, 'eval': pipeline_batches(cfg, 'eval', 2)})

  rtp = os.path.join(root, 'data.rtp')
  with open(rtp, 'w') as f:
    f.writelines('%s;%s\n' % (r[0], '\002'.join(r[1:])) for r in rows)
  agree('DeepFM, RTPInput', small_deepfm({
      'data_config.input_type': 'RTPInput', 'data_config.separator': '\002',
      'train_input_path': rtp, 'eval_input_path': rtp}))

  export_root = os.path.join(root, 'exports')
  os.makedirs(os.path.join(export_root, 'criteo_small'))
  with open(os.path.join(export_root, 'criteo_small', 'part-0.csv'),
            'w') as f:
    f.writelines(','.join(r) + '\n' for r in rows)
  os.environ['EASYREC_WAREHOUSE_EXPORT_DIR'] = export_root
  table = 'odps://proj/tables/criteo_small'
  warehouse = small_deepfm({'data_config.input_type': 'OdpsInputV2',
                            'data_config.separator': ',',
                            'train_input_path': table,
                            'eval_input_path': table})
  agree('DeepFM, OdpsInputV2 from its CSV export', warehouse)

  dh = MockDataHub()
  endpoint = dh.start()
  try:
    dh.create_topic('p', 'criteo', [(n, 'STRING') for n in names], 3)
    for i, r in enumerate(rows):
      dh.put('p', 'criteo', i // 500, r)
    source = ('akId: "ak" akSecret: "sk" region: "%s" project: "p" '
              'topic: "criteo"' % endpoint)
    cfg = small_deepfm({'datahub_train_input': source,
                        'datahub_eval_input': source,
                        'data_config.input_type': 'DataHubInput'})
    from easyrec_torch.config import config_util
    from easyrec_torch.data.input_pipeline import InputPipeline
    feats = config_util.get_feature_configs(cfg)
    os.environ['EASYREC_DATAHUB_STOP_AT_END'] = '1'
    first = InputPipeline(cfg.data_config, feats, cfg.datahub_train_input)
    it = iter(first)
    for _ in range(3):
      next(it)
    cut = dict(first.last_batch_offsets)
    tail = [next(it) for _ in range(3)]
    resumed_cfg = copy.deepcopy(cfg)
    resumed_cfg.datahub_train_input.offset_info = json.dumps(
        {str(k): v for k, v in cut.items()})
    t0 = time.perf_counter()
    resumed = InputPipeline(resumed_cfg.data_config, feats,
                            resumed_cfg.datahub_train_input)
    again = [b for _, b in zip(range(3), resumed)]
    read_s = time.perf_counter() - t0
    del os.environ['EASYREC_DATAHUB_STOP_AT_END']
    same = len(again) == 3 and all(
        sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        for a, b in zip(again, tail))
    log('DeepFM, DataHubInput: 3 batches to offsets %s; a pipeline resumed '
        'there read 3 more in %.3f s (%.0f rows/s), %s the first '
        'pipeline\'s next 3' % (cut, read_s, 768 / read_s,
                                'equal to' if same else 'DIFFERENT from'))
    if not same:
      fail('DataHubInput: the resumed batches differ')
    agree('DeepFM, DataHubInput resumed', resumed_cfg, again)
  finally:
    dh.stop()

  space = [{'name': 'train_config.optimizer_config[0].adam_optimizer.'
                    'learning_rate.exponential_decay_learning_rate.'
                    'initial_learning_rate',
            'type': 'double', 'min': 1e-4, 'max': 1e-2, 'log_scale': True},
           {'name': 'model_config.deepfm.dnn.hidden_units',
            'type': 'categorical', 'candidates': [[64, 32], [32]]}]
  trials = {}
  for dev in ('cuda', 'cpu'):
    cfg = copy.deepcopy(warehouse)
    cfg.model_dir = os.path.join(root, 'hpo_' + dev)
    cfg.train_config.num_steps = 5
    t0 = time.time()
    summary = LocalTuner(cfg, space, num_trials=2, device=dev).run()
    trials[dev] = [(t['assignment'], t['auc']) for t in summary['trials']]
    log('hpo tuner, 2 random trials on %s in %.1f s: %s'
        % (dev, time.time() - t0, trials[dev]))
  if [a for a, _ in trials['cuda']] != [a for a, _ in trials['cpu']] or \
      not all(0.0 <= auc <= 1.0 for t in trials.values() for _, auc in t):
    fail('hpo tuner: trials %s' % trials)
  del os.environ['EASYREC_WAREHOUSE_EXPORT_DIR']
  shutil.rmtree(root, ignore_errors=True)

# -- a minimal Parquet writer: the card's machine has no pyarrow, and phase
# 35 feeds the port's Parquet reader files of its own making

def _uleb(v):
  out = bytearray()
  while True:
    b, v = v & 0x7f, v >> 7
    out.append(b | (0x80 if v else 0))
    if not v:
      return bytes(out)


def _thrift(fields):
  """A Thrift compact-protocol struct of (field id, kind, value) in field
  order; kinds i32, i64, bin, struct, and list_i32 / list_bin /
  list_struct; a None value is left out."""
  types = {'i32': 5, 'i64': 6, 'bin': 8, 'struct': 12}
  out = bytearray()
  last = 0

  def value(kind, v):
    if kind in ('i32', 'i64'):
      return _uleb((v << 1) ^ (v >> 63))
    if kind == 'bin':
      return _uleb(len(v)) + v
    return _thrift(v)

  for fid, kind, v in fields:
    if v is None:
      continue
    if kind.startswith('list_'):
      elem = kind[5:]
      head = bytes([(min(len(v), 15) << 4) | types[elem]])
      body = head + (_uleb(len(v)) if len(v) >= 15 else b'') + \
          b''.join(value(elem, x) for x in v)
      t = 9
    else:
      body, t = value(kind, v), types[kind]
    out += bytes([((fid - last) << 4) | t]) if 0 < fid - last <= 15 else \
        bytes([t]) + _uleb((fid << 1) ^ (fid >> 63))
    out += body
    last = fid
  return bytes(out + b'\x00')


def snappy_compress(data):
  """A Snappy raw-format block of `data`: each run of 8 or more equal
  bytes a literal byte and copies at offset 1 (overlapping), the rest
  literals of up to 65,536 bytes."""
  import numpy as np
  a = np.frombuffer(data, np.uint8)
  out = bytearray(_uleb(len(data)))

  def literal(lo, hi):
    for s in range(lo, hi, 65536):
      n = min(hi, s + 65536) - s
      if n <= 60:
        out.append((n - 1) << 2)
      elif n <= 256:
        out.extend((60 << 2, n - 1))
      else:
        out.extend((61 << 2, (n - 1) & 0xff, (n - 1) >> 8))
      out.extend(data[s:s + n])

  cuts = np.flatnonzero(np.diff(a) != 0) + 1
  starts = np.concatenate([[0], cuts]).astype(np.int64)
  ends = np.concatenate([cuts, [a.size]]).astype(np.int64)
  long_runs = (ends - starts) >= 8
  pos = 0
  for lo, hi in zip(starts[long_runs].tolist(), ends[long_runs].tolist()):
    literal(pos, lo + 1)
    left = hi - lo - 1
    while left > 0:
      k = min(left, 64)
      out.extend((((k - 1) << 2) | 2, 1, 0))
      left -= k
    pos = hi
  literal(pos, a.size)
  return bytes(out)


def _bit_packed(values, width):
  """The RLE / bit-packed hybrid of `values` as bit-packed groups of 8."""
  import numpy as np
  v = np.asarray(values, np.uint64)
  groups = -(-v.size // 8)
  v = np.concatenate([v, np.zeros(groups * 8 - v.size, np.uint64)])
  bits = ((v[:, None] >> np.arange(width, dtype=np.uint64)) &
          np.uint64(1)).astype(np.uint8)
  return _uleb((groups << 1) | 1) + np.packbits(bits.reshape(-1),
                                                bitorder='little').tobytes()


def _plain(kind, values):
  import numpy as np
  if kind == 'string':
    enc = [v.encode('utf-8') for v in values]
    return b''.join(len(b).to_bytes(4, 'little') + b for b in enc)
  return np.asarray(values, {'int32': '<i4', 'int64': '<i8',
                             'double': '<f8'}[kind]).tobytes()


PQ_TYPES = {'int32': 1, 'int64': 2, 'double': 5, 'string': 6}


def write_parquet(path, columns, row_groups, codecs, dictionary=()):
  """A Parquet file of `columns` [(name, kind, values, nulls)] (kind
  int32, int64, double or string; nulls a bool mask or None, a column
  with one OPTIONAL, else REQUIRED) in the row groups [(lo, hi)], each
  column chunk one V1 data page compressed by codecs[i] ('none' or
  'snappy'), PLAIN, or RLE_DICTIONARY behind a dictionary page for the
  columns named in `dictionary`."""
  import numpy as np
  body = bytearray(b'PAR1')
  groups = []
  for (lo, hi), codec in zip(row_groups, codecs):
    code = {'none': 0, 'snappy': 1}[codec]
    pack = snappy_compress if codec == 'snappy' else bytes
    chunks, sizes = [], []
    for name, kind, values, nulls in columns:
      vals = values[lo:hi]
      page = b''
      if nulls is not None:
        live = ~nulls[lo:hi]
        levels = _bit_packed(live.astype(np.uint64), 1)
        page = len(levels).to_bytes(4, 'little') + levels
        vals = vals[live]
      start = len(body)
      dict_off = None
      encodings = [0, 3]
      if name in dictionary:
        uniq, idx = np.unique(vals, return_inverse=True)
        raw = _plain(kind, uniq)
        comp = pack(raw)
        dict_off = start
        body += _thrift([(1, 'i32', 2), (2, 'i32', len(raw)),
                         (3, 'i32', len(comp)),
                         (7, 'struct', [(1, 'i32', len(uniq)),
                                        (2, 'i32', 0)])]) + comp
        width = max(1, int(len(uniq) - 1).bit_length())
        page += bytes([width]) + _bit_packed(idx, width)
        encoding = 8
        encodings = [0, 3, 8]
      else:
        page += _plain(kind, vals)
        encoding = 0
      data_off = len(body)
      comp = pack(page)
      body += _thrift([(1, 'i32', 0), (2, 'i32', len(page)),
                       (3, 'i32', len(comp)),
                       (5, 'struct', [(1, 'i32', hi - lo),
                                      (2, 'i32', encoding), (3, 'i32', 3),
                                      (4, 'i32', 3)])]) + comp
      size = len(body) - start
      sizes.append(size)
      chunks.append([(2, 'i64', start), (3, 'struct', [
          (1, 'i32', PQ_TYPES[kind]), (2, 'list_i32', encodings),
          (3, 'list_bin', [name.encode()]), (4, 'i32', code),
          (5, 'i64', hi - lo), (6, 'i64', size), (7, 'i64', size),
          (9, 'i64', data_off), (11, 'i64', dict_off)])])
    groups.append([(1, 'list_struct', chunks), (2, 'i64', sum(sizes)),
                   (3, 'i64', hi - lo)])
  schema = [[(4, 'bin', b'schema'), (5, 'i32', len(columns))]]
  for name, kind, _, nulls in columns:
    schema.append([(1, 'i32', PQ_TYPES[kind]),
                   (3, 'i32', 0 if nulls is None else 1),
                   (4, 'bin', name.encode()),
                   (6, 'i32', 0 if kind == 'string' else None)])
  meta = _thrift([(1, 'i32', 1), (2, 'list_struct', schema),
                  (3, 'i64', row_groups[-1][1] - row_groups[0][0]),
                  (4, 'list_struct', groups),
                  (6, 'bin', b'easyrec_torch chip_smoke.py')])
  body += meta + len(meta).to_bytes(4, 'little') + b'PAR1'
  with open(path, 'wb') as f:
    f.write(bytes(body))


# phase 35's Parquet files: C1-C13 dictionary-encoded, the rest PLAIN
PARQUET_DICT = tuple('C%d' % i for i in range(1, 14))


def criteo_parquet_columns(cols):
  """criteo_day_columns' strings as write_parquet's columns: the label
  int32, F1-F13 int64 and C1-C26 strings, each blank a null."""
  import numpy as np
  out = [('label', 'int32', cols[0].astype(np.int32), None)]
  for j in range(1, 40):
    blank = cols[j] == ''
    if j <= 13:
      out.append(('F%d' % j, 'int64',
                  np.where(blank, '0', cols[j]).astype(np.int64), blank))
    else:
      out.append(('C%d' % (j - 13), 'string', cols[j], blank))
  return out


def phase_parquet_dlrm(torch, card, smi):
  """Phase 35, this slice's main path: the full-width Criteo DLRM
  (flagship.criteo_dlrm_config: the [26,000,014, 32] table, batch 4,096)
  fed from Parquet. criteo_day_columns' rows (phase 31's seeds) are
  written as Parquet files by write_parquet, day_1 also as a TSV (the label
  int32, F1-F13 int64 and C1-C26 strings, blanks null; C1-C13
  RLE_DICTIONARY, the rest PLAIN; two row groups, the first uncompressed,
  the second snappy). The CSV and Parquet readers alone read day_1
  (rows/s), and the two pipelines' batches of day_1 must be equal key for
  key and bit for bit (rows/s of each); K1 (every mode) and K2 (compact
  Adam) bit-exact against their plain versions on one batch of the
  Parquet path (phase_kernel_path, pipeline_pack); then phase_slice
  (train_and_evaluate from day_0.parquet, 20 steps, K1 and K2 once a step,
  the eval on day_1.parquet). Returns the launches by kernel and math,
  and K1's and K2's largest differences."""
  import shutil
  import numpy as np
  from easyrec_torch import main as main_lib
  from easyrec_torch.config import config_util
  from easyrec_torch.data.input_pipeline import InputPipeline, create_reader
  from easyrec_torch.ops import parquet_ops
  from easyrec_torch.utils import flagship

  what = 'Criteo DLRM, Parquet'
  root = os.path.join(SCRATCH, 'parquet_dlrm')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  t0 = time.time()
  tsv, pq = {}, {}
  for name, n, seed in (('day_0', CRITEO_TRAIN_ROWS, 31),
                        ('day_1', CRITEO_EVAL_ROWS, 32)):
    cols = criteo_day_columns(n, seed)
    tsv[name] = os.path.join(root, name + '.tsv')
    if name == 'day_1':      # the CSV side reads day_1 only
      with open(tsv[name], 'w') as f:
        f.writelines('\t'.join(row) + '\n' for row in zip(*cols))
    pq[name] = os.path.join(root, name + '.parquet')
    write_parquet(pq[name], criteo_parquet_columns(cols),
                  [(0, n // 2), (n // 2, n)], ['none', 'snappy'],
                  PARQUET_DICT)
  log('%s: %d rows written as Parquet files (%d bytes: two row groups, '
      'uncompressed and snappy, C1-C13 RLE_DICTIONARY), day_1 also as a TSV '
      '(%d bytes), in %.1f s'
      % (what, CRITEO_TRAIN_ROWS + CRITEO_EVAL_ROWS,
         sum(os.path.getsize(p) for p in pq.values()),
         os.path.getsize(tsv['day_1']), time.time() - t0))

  def config(input_type, paths):
    return main_lib.load_config(flagship.criteo_dlrm_config(), {
        'data_config.input_type': input_type,
        'train_input_path': paths['day_0'], 'eval_input_path': paths['day_1']})

  cfg_csv, cfg_pq = config('CSVInput', tsv), config('ParquetInput', pq)
  # the decoder's native loops build at their first use: apart from the
  # rates below
  t0 = time.perf_counter()
  parquet_ops.native()
  log('%s: the native Parquet decoder (ops/native/parquet_ops.cc) built and '
      'loaded in %.2f s' % (what, time.perf_counter() - t0))
  # the readers and the batches on day_1 (both row groups, both codecs):
  # day_0's 86,016 rows took 12 s of the 60 that phases 35 and 36 may cost
  rates = {}
  for kind, cfg, path in (('CSV', cfg_csv, tsv['day_1']),
                          ('Parquet', cfg_pq, pq['day_1'])):
    t0 = time.perf_counter()
    rows = sum(len(c['label']) for c in create_reader(
        cfg.data_config, path).chunks(4096))
    rates[kind] = rows / (time.perf_counter() - t0)
    if rows != CRITEO_EVAL_ROWS:
      fail('%s: the %s reader read %d rows' % (what, kind, rows))
  pipes = {}
  for kind, cfg, path in (('CSV', cfg_csv, tsv['day_1']),
                          ('Parquet', cfg_pq, pq['day_1'])):
    t0 = time.perf_counter()
    pipes[kind] = list(InputPipeline(
        cfg.data_config, config_util.get_feature_configs(cfg), path,
        mode='eval'))
    rates[kind + ' pipeline'] = CRITEO_EVAL_ROWS / (time.perf_counter() -
                                                     t0)
  if len(pipes['CSV']) != len(pipes['Parquet']):
    fail('%s: %d Parquet batches, %d CSV' % (what, len(pipes['Parquet']),
                                             len(pipes['CSV'])))
  for i, (a, b) in enumerate(zip(pipes['CSV'], pipes['Parquet'])):
    if sorted(a) != sorted(b) or any(
        a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
        for k in a):
      fail('%s: batch %d of the Parquet pipeline differs from the CSV '
           'pipeline\'s' % (what, i))
  log('%s: the Parquet pipeline\'s %d batches of day_1 equal the CSV '
      'pipeline\'s key for key, bit for bit; rows/s on the card\'s host: '
      'readers alone CSV %.0f, Parquet %.0f (%.2fx); reader + transforms '
      'CSV %.0f, Parquet %.0f (%.2fx) (%s)'
      % (what, len(pipes['CSV']), rates['CSV'], rates['Parquet'],
         rates['Parquet'] / rates['CSV'], rates['CSV pipeline'],
         rates['Parquet pipeline'],
         rates['Parquet pipeline'] / rates['CSV pipeline'], smi))
  del pipes
  errs = phase_kernel_path(torch, cfg_pq, what, pack=pipeline_pack)
  launches = phase_slice(torch, card, what, cfg_pq, '0',
                         ('seg_sum', 'rmw_rows'), 'compact_adam', pool=1)
  shutil.rmtree(root, ignore_errors=True)
  return launches, errs


# phase 36's scaling world at the JAX tool's 4,096 buckets a feature: at
# the flagship's 1,000,000 each of its 8 ranks draws the 6.66 GB table, and
# the world took 33.9 s against 17.1 (NVIDIA H100 80GB HBM3, 700 W), past
# the 60 s phases 35 and 36 may cost together; PERF.md's records at the
# full table come from scaling_model's own run on the card's host
SCALING_BUCKETS = 4096


def phase_pod_tools(torch, smi, step_ms):
  """Phase 36: the two multi-GPU tools. tools/aot_pod_check at --world 8
  (one 8-GPU node: 8 gloo processes of this host, the flagship DeepFM
  row-sharded at 8 rows a rank, one step; its checks, and each rank's
  memory at the run's and at full width), which launches K1 and K2 on
  the card at rank 0's owner shapes for that world at full width, each
  bit-exact against its plain version, with their times; then
  tools/scaling_model's world of 8 (the flagship at SCALING_BUCKETS
  buckets and 4,096 rows a rank, 8 gloo processes, its collectives
  counted) projected from phase 34's sharded ms/step. Returns K1's and
  K2's largest differences."""
  from easyrec_torch.tools import aot_pod_check, scaling_model
  # both tools' worlds in one start of 8 processes (each start costs about
  # 10 s on the card's host, most of it importing torch)
  t0 = time.time()
  pod, scale = aot_pod_check.run_worlds(8, [(8, 4096, 16),
                                            (4096, SCALING_BUCKETS, 16)])
  log('phase 36: one world of 8 gloo processes ran both tools\' steps in '
      '%.1f s' % (time.time() - t0))
  t0 = time.time()
  summary = aot_pod_check.check(world=8, device='cuda', results=pod,
                                log=lambda m: log('aot_pod_check: ' + m))
  if not summary['ok']:
    fail('aot_pod_check --world 8: %s' % summary['failures'])
  (k,) = summary['kernels']
  shape = summary['owner_shapes'][k['table']]
  log('aot_pod_check --world 8 passed in %.1f s: K1 %.4f ms over %d slots '
      '(%d filled), K2 %.4f ms on the [%d, %d] shard, both bit-exact (%s)'
      % (time.time() - t0, k['k1_ms'], shape['slots'], shape['fill'],
         k['k2_ms'], shape['rows'], shape['width'], smi))
  t0 = time.time()
  rec = scaling_model.model_world(8, 8, 4096, SCALING_BUCKETS, step_ms,
                                  'chip_smoke.py phase 34', results=scale)
  log('scaling_model --worlds 8 --hash_buckets %d --step_ms %.3f (%.1f s): '
      '%s' % (SCALING_BUCKETS, step_ms, time.time() - t0,
              json.dumps(rec, sort_keys=True)))
  if rec['overflow'] != [0.0, 0.0] or not rec['projected_step_ms'] > \
      step_ms or rec['collective_counts'].get('all_to_all', 0) < 4:
    fail('scaling_model: %s' % rec)
  return k['k1_max_abs_err'], k['k2_max_abs_err']


SHARDED_STEPS = 20


def _exchange_timer(sync, xch):
  """Wrap the exchange's three functions to add their wall time (the card
  synchronised before and after) to the returned list's first item."""
  spent = [0.0]

  def timed(fn):
    def run(*args, **kw):
      sync()
      t0 = time.perf_counter()
      out = fn(*args, **kw)
      sync()
      spent[0] += time.perf_counter() - t0
      return out
    return run

  saved = (xch.build_route, xch.send_to_owners, xch.return_to_requesters)
  xch.build_route, xch.send_to_owners, xch.return_to_requesters = map(
      timed, saved)

  def restore():
    xch.build_route, xch.send_to_owners, xch.return_to_requesters = saved
  return spent, restore


def _capture_kernels(torch, pt):
  """Record the inputs of K1's and K2's calls (K2's touched rows as they
  were before the update) until stop() is called."""
  seen = {'seg_sum': [], 'rmw_rows': []}
  seg, rmw = pt.seg_sum, pt.rmw_rows

  def seg_capture(sids, order, starts, grads, sentinel, mode=None):
    seen['seg_sum'].append((sids.clone(), order.clone(), starts.clone(),
                            grads.clone(), sentinel,
                            pt.gg_mode() if mode is None else mode))
    return seg(sids, order, starts, grads, sentinel, mode)

  def rmw_capture(table, uids, gsum, hypers, opt):
    ok = (uids >= 0) & (uids < table.shape[0])
    seen['rmw_rows'].append((table.index_select(0, uids[ok]), uids.clone(),
                             gsum.clone(), hypers.clone(), opt, ok))
    return rmw(table, uids, gsum, hypers, opt)

  pt.seg_sum, pt.rmw_rows = seg_capture, rmw_capture

  def stop():
    pt.seg_sum, pt.rmw_rows = seg, rmw
  return seen, stop


def _held_kernels(torch, pt, seen, sync):
  """K1 and K2 on the captured inputs of the sharded path against their
  plain versions, bit for bit; K2 on a table of just the touched rows.
  Returns their largest differences."""
  err1 = err2 = 0.0
  for sids, order, starts, grads, sentinel, mode in seen['seg_sum']:
    uk, sk = pt.seg_sum(sids, order, starts, grads, sentinel, mode)
    up, sp = pt.seg_sum_plain(sids, order, starts, grads, sentinel, mode)
    sync()
    if not (torch.equal(uk, up) and
            torch.equal(sk.view(torch.int32), sp.view(torch.int32))):
      fail('sharded: seg_sum (mode %s) differs from its plain version'
           % mode)
    err1 = max(err1, float((sk - sp).abs().max()))
  for rows, uids, gsum, hypers, opt, ok in seen['rmw_rows']:
    local = torch.full_like(uids, rows.shape[0])
    local[ok] = torch.arange(rows.shape[0], device=uids.device)
    a, b = rows.clone(), rows.clone()
    pt.rmw_rows(a, local, gsum, hypers, opt)
    pt.rmw_rows_plain(b, local, gsum, hypers, opt)
    sync()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
      fail('sharded: rmw_rows differs from its plain version')
    err2 = max(err2, float((a - b).abs().max()))
  return err1, err2


def sharded_worker(world, root, small=False):
  """Phase 34 in a process of its own, rank 0 of a world of one over NCCL
  (parallel/launch.py): the flagship DeepFM at full width under
  train_distribute EmbeddingParallelStrategy against the unsharded path
  from one state, then the Taobao DIN's sharded checkpoint restored on one
  device. Returns what phase_sharded logs and holds. `small` cuts both
  models to a few thousand rows, for a check of this code on the CPU."""
  import copy
  import shutil
  import torch
  from easyrec_torch import main as main_lib
  from easyrec_torch.ops import kernels
  from easyrec_torch.ops import packed_table as pt
  from easyrec_torch.parallel import exchange as xch
  from easyrec_torch.train.trainer import Trainer, to_device
  from easyrec_torch.utils import flagship
  from easyrec_torch.utils.synthetic import synthetic_batch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  os.environ['EASYREC_PACKED_FUSED'] = '0'
  dev = world.device
  cuda = dev.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  ep = {'train_distribute': 'EmbeddingParallelStrategy'}
  cfg = main_lib.load_config(
      flagship.criteo_deepfm_config(batch_size=64, hash_bucket_size=1000)
      if small else flagship.criteo_deepfm_config(),
      {'train_config.' + k: v for k, v in ep.items()})
  bs = int(cfg.data_config.batch_size)
  out = {'backend': torch.distributed.get_backend(), 'world': world.size,
         'device': str(world.device)}

  plain = Trainer(cfg, device=dev, world=None)
  plain.init_state()
  labels = list(cfg.data_config.label_fields)
  batches = [to_device(synthetic_batch(plain.specs, labels, bs, seed=s),
                       dev) for s in range(SHARDED_STEPS)]
  # the step-0 state both runs start from, kept on the card
  start = {'step': plain.step.clone(),
           'model': {k: v.clone() for k, v in
                     plain.model.state_dict().items()},
           'tables': {k: v.clone() for k, v in plain.tables.items()},
           'ev': {}, 'dense_opt': copy.deepcopy(plain.dense_opt.state_dict())}

  def run(trainer):
    losses = [trainer.train_step(batches[0])]   # a warm-up step, untimed
    sync()
    t0 = time.perf_counter()
    losses += [trainer.train_step(b) for b in batches[1:]]
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    return ms, [{k: float(v) for k, v in d.items()} for d in losses]

  sharded = Trainer(cfg, device=dev)
  if sharded.world is None or list(sharded.sharding.splits) != \
      list(sharded.metas):
    fail('sharded: the trainer did not row-shard its tables in the world')
  sharded.init_state()
  sharded.load_state_dict(start)
  del start
  sync()
  if cuda:
    torch.cuda.reset_peak_memory_stats()
  kernels.reset_launches()
  out['ms_sharded'], out['losses_sharded'] = run(sharded)
  out['counts'] = kernels.launch_counts()
  out['tagged'] = kernels.tagged_counts()
  out['peak_gb'] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
  out['ms_plain'], out['losses_plain'] = run(plain)
  out['tables_equal'] = {k: torch.equal(plain.tables[k].view(torch.int32),
                                        sharded.tables[k].view(torch.int32))
                         for k in plain.tables}
  far = 0
  for k, t in plain.tables.items():
    d = plain.metas[k].dim
    far += int(((t[:, :d] - sharded.tables[k][:, :d]).abs() > 1e-5).sum())
  out['weights_past_1e5'] = far
  out['weights'] = sum(int(t[:, :plain.metas[k].dim].numel())
                       for k, t in plain.tables.items())
  sp, pp = sharded.model.state_dict(), plain.model.state_dict()
  out['model_differ'] = sorted(k for k in pp if not torch.equal(pp[k],
                                                                sp[k]))
  # the exchange's time a step, and K1 and K2 against their plain versions
  # on this path's inputs, over two more steps
  spent, restore = _exchange_timer(sync, xch)
  seen, stop = _capture_kernels(torch, pt)
  for b in batches[:2]:
    sharded.train_step(b)
  stop()
  restore()
  out['exchange_ms'] = spent[0] * 1e3 / 2
  out['err1'], out['err2'] = _held_kernels(torch, pt, seen, sync)
  out['held'] = (len(seen['seg_sum']), len(seen['rmw_rows']))
  del plain, sharded, batches, seen
  if cuda:
    torch.cuda.empty_cache()

  # the Taobao DIN trained 3 steps in the world and saved (rank 0's file
  # holds every row); one device restores it and must hold the same state
  model_dir = os.path.join(root, 'din_sharded')
  shutil.rmtree(model_dir, ignore_errors=True)
  din = main_lib.load_config(
      flagship.taobao_din_config(batch_size=64) if small else
      flagship.taobao_din_config(),
      {'train_config.' + k: v for k, v in ep.items()})
  a = Trainer(din, device=dev)
  a.init_state()
  for s in range(3):
    a.step_batch(synthetic_batch(a.specs, list(din.data_config.label_fields),
                                 int(din.data_config.batch_size), seed=s))
  a.save(a.checkpoint_manager(model_dir), 3)
  b = Trainer(din, device=dev, world=None)
  b.init_state()
  b.load_state_dict(b.checkpoint_manager(model_dir).restore_latest())
  out['din_differ'] = state_differences(torch, a, b)[1]
  with open(os.path.join(model_dir, 'checkpoints', '3', 'layout.json')) as f:
    out['din_world'] = json.load(f)['world']
  return out


def phase_sharded(torch, smi):
  """Phase 34: the flagship DeepFM at full width (the 26,000,014-row table,
  batch 4,096) in a world of one rank over NCCL, in a process of its own
  (parallel/launch.py), 20 steps under train_distribute
  EmbeddingParallelStrategy: every step reads its rows through
  ep_pull_sharded and updates them through packed_update_sharded (K1's
  local dedup, all_to_all_single to the owner, K1 + K2 there). From the
  same step-0 state and batches, the unsharded path's 20 steps must give
  the same losses and table bits. The ms/step of both (after one warm-up
  step each, in one process), K1's and K2's launches a step, the
  exchange's ms a step, both overflow counts (0), peak memory; K1 and K2
  bit-exact against their plain versions on this path's inputs. Then the
  Taobao DIN's checkpoint written in the world restores on one device to
  the same state. Returns the launches by kernel and math, and K1's and
  K2's largest differences."""
  from easyrec_torch.parallel import launch
  gc.collect()
  torch.cuda.empty_cache()
  t0 = time.time()
  (res,) = launch.spawn('chip_smoke:sharded_worker', [SCRATCH], 1,
                        device='cuda', timeout_s=300)
  wall = time.time() - t0
  steps = SHARDED_STEPS
  k1, k2 = res['counts']['seg_sum'], res['counts']['rmw_rows']
  over = [(d['exchange_update_overflow'], d['exchange_ep_pull_overflow'])
          for d in res['losses_sharded']]
  log('sharded: flagship DeepFM, %s world of %d on %s, %d steps (the last '
      '19 timed): %.3f ms/step sharded against %.3f unsharded (%s); K1 %d '
      'and K2 %d '
      'launches (%.1f and %.1f a step); the exchange %.3f ms a step; '
      'overflow (update, pull) summed %s; peak %.3f GB; K1 and K2 held on '
      '%d and %d calls of this path, bit-exact (max %g, %g); process '
      '%.1f s'
      % (res['backend'], res['world'], res['device'], steps,
         res['ms_sharded'], res['ms_plain'], smi, k1, k2, k1 / steps,
         k2 / steps, res['exchange_ms'],
         tuple(map(sum, zip(*over))), res['peak_gb'], res['held'][0],
         res['held'][1], res['err1'], res['err2'], wall))
  if res['backend'] != 'nccl' or res['world'] != 1:
    fail('sharded: a world of %d over %s' % (res['world'], res['backend']))
  if k1 != 2 * steps or k2 != steps or res['counts']['rmw_fused']:
    fail('sharded: launches %s over %d steps' % (res['counts'], steps))
  if any(o != (0.0, 0.0) for o in over):
    fail('sharded: the exchange dropped rows: %s' % over)
  lp = [d['total_loss'] for d in res['losses_plain']]
  ls = [d['total_loss'] for d in res['losses_sharded']]
  equal = lp == ls and all(res['tables_equal'].values()) and \
      not res['model_differ']
  log('sharded: losses %s sharded, %s unsharded; tables equal bit for bit '
      '%s; %d of %d weights past 1e-5; dense parameters differing %s'
      % (['%.6f' % x for x in ls], ['%.6f' % x for x in lp],
         res['tables_equal'], res['weights_past_1e5'], res['weights'],
         res['model_differ']))
  if not equal:
    # the agree phase's rule; the dense gradients' all-reduce is the one
    # reduction written otherwise (a copy at one rank)
    rel = max(abs(a - b) / abs(b) for a, b in zip(ls, lp))
    if rel > 1e-5 or res['weights_past_1e5'] * 100 > res['weights']:
      fail('sharded: the sharded run parts from the unsharded one (loss '
           '%g relative, %d weights past 1e-5)'
           % (rel, res['weights_past_1e5']))
  if res['din_differ'] or res['din_world']['size'] != 1:
    fail('sharded: the DIN restored on one device differs in %s (world %s)'
         % (res['din_differ'][:10], res['din_world']))
  log('sharded: the Taobao DIN saved in the world (stamp world %s) '
      'restored on one device equal in every state tensor'
      % {'size': res['din_world']['size']})
  counts = dict(res['counts'])
  counts.update(res['tagged'])
  return counts, (res['err1'], res['err2']), res['ms_sharded']



# phase 37: the FM gate's eval AUC, card against CPU. The two runs train on
# the same files from different initial tables (a trainer draws them on its
# own device) and sum in other orders, so they part in how they order the
# (iid, cate) cells inside each of lint's two Bayes levels. Two random such
# orders read sqrt(2) x lint_order_spread apart as one std (0.0028 on the
# gate's eval file); the tolerance is GATE_CPU_STDS of those stds, 0.0098.
GATE_CPU_STDS = 3.5


def phase_gates(torch, card):
  """Phase 37: the JAX package's learnability gates on the card, through
  the port's Trainer.fit at the gates' sizes, seeds, steps, learning rates
  and bars (tests/test_torch_learnability_data.py, the JAX-free copy the
  CPU gates read): FM on K1 + K2 and again fused on K3, the DeepFM at f32
  and under compute_dtype bfloat16 (its DNNs on cuBLAS in bf16; its eval
  loss must differ from the f32 run's), MultiTowerDIN, MMoE, ESMM, MIND
  recall and DSSM pointwise, each above its bar. A control that a broken
  sparse update fails: FM with the tables' learning rate 0
  (embedding_learning_rate_multiplier), which runs K1 + K2 but moves no
  table weight, must read under the bar. Then FM on the CPU from the same
  files, its AUC within GATE_CPU_STDS stds of two random orders of lint's
  cells of the card's. Every launch counter is set to 0 before each gate
  and read after it: the gate's kernels once a step and table (K2 or K3
  with compact Adam), the others never. First K1, K2 and K3 bit-exact
  against their plain versions on the ids of the first batch of the FM
  gate (its table dim 16: the dim-8 embeddings and FM's merged wide
  weight, 9 used) and of the MMoE gate (dim 8), phase_kernel_path.
  Returns the launches of the gates
  together, by kernel and by kernel/math, and K1's, K2's and K3's
  largest differences."""
  from easyrec_torch.config import config_util
  from easyrec_torch.ops import kernels
  from tests import test_torch_learnability_data as d
  root = os.path.join(SCRATCH, 'gates')
  os.makedirs(root, exist_ok=True)
  lint = d.BAYES['lint'] - d.MARGIN['rank']
  lseq = d.BAYES['lseq'] - d.MARGIN['seq']
  mt = {'auc_ctr': d.BAYES['lctr'] - d.MARGIN['mt'],
        'auc_cvr': d.BAYES['lcvr'] - d.MARGIN['mt']}
  unfused, fused = ('seg_sum', 'rmw_rows'), ('rmw_fused',)
  total = {}

  def gate(what, path, path_kernels, bars, device='cuda', under=False,
           pool=0):
    """Train one gate; each metric of `bars` must read above its bar (with
    `under`, under it). On the card K7 launches `pool` times a step each
    way: once for a table of sum or mean bags alone, which the multi-task
    and two-tower gates have."""
    os.environ['EASYREC_PACKED_FUSED'] = '1' if path_kernels == fused \
        else '0'
    kernels.reset_launches()
    m, trainer, result, secs = d.run_gate(path, device)
    if device == 'cuda':
      torch.cuda.synchronize()
    counts = kernels.launch_counts()
    tagged = kernels.tagged_counts()
    steps, n_tables = result['global_step'], len(trainer.tables)
    log('phase 37 %s on %s: %d steps over %d table(s) in %.1f s (input '
        'and eval included); %s; bars %s; launches %s'
        % (what, device, steps, n_tables, secs, m,
           {k: round(v, 4) for k, v in bars.items()},
           {k: c for k, c in dict(counts, **tagged).items() if c}))
    losses = result['losses']
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
      fail('phase 37 %s: %d losses for %d steps, or one not finite'
           % (what, len(losses), steps))
    for name, c in counts.items():
      want = steps * n_tables if device == 'cuda' and \
          name in path_kernels else steps * pool if device == 'cuda' and \
          name in POOL_KERNELS else 0
      if c != want:
        fail('phase 37 %s: kernel %s launched %d times in %d steps over %d '
             'tables, %d expected' % (what, name, c, steps, n_tables, want))
    want = {'%s/compact_adam' % k: steps * n_tables for k in path_kernels
            if k != 'seg_sum'} if device == 'cuda' else {}
    if tagged != want:
      fail('phase 37 %s: K2/K3 launched with the block maths %s, %s '
           'expected' % (what, tagged, want))
    for k, c in dict(counts, **tagged).items():
      total[k] = total.get(k, 0) + c
    for key, bar in bars.items():
      if (m[key] < bar) != under or m[key] == bar:
        fail('phase 37 %s gate: %s=%.4f not %s its bar %.4f'
             % (what, key, m[key], 'under' if under else 'above', bar))
    return m

  t0 = time.time()
  fm = d.gate_config(root, d.RANK_BODIES['FM'], ['lint'])
  mmoe = d.gate_config(root, d.MT_BODIES['MMoE'], ['lctr', 'lcvr'])
  errs = (0.0, 0.0, 0.0)
  for what, path in (('FM gate', fm), ('MMoE gate', mmoe)):
    errs = [max(a, b) for a, b in zip(errs, phase_kernel_path(
        torch, config_util.get_configs_from_pipeline_file(path), what,
        pack=pipeline_pack, fused=True))]
  m_fm = gate('FM (K1 + K2)', fm, unfused, {'auc': lint})
  gate('FM, EASYREC_PACKED_FUSED=1 (K3)', fm, fused, {'auc': lint})
  m_f32 = gate('DeepFM', d.gate_config(root, d.DEEPFM_BODY, ['lint']),
               unfused, {'auc': lint})
  m = gate('DeepFM, compute_dtype bfloat16', d.gate_config(
      root, d.DEEPFM_BODY, ['lint'], bf16=True), unfused, {'auc': lint})
  if m['loss'] == m_f32['loss']:
    fail('phase 37: the bf16 DeepFM read the f32 eval loss %r: '
         'compute_dtype ignored' % m['loss'])
  gate('MultiTowerDIN', d.gate_config(root, d.SEQ_BODIES['MultiTowerDIN'],
                                      ['lseq']), unfused, {'auc': lseq})
  gate('MMoE', mmoe, unfused, mt, pool=1)
  gate('ESMM', d.gate_config(root, d.ESMM_BODY, ['lctr', 'lcvr']), unfused,
       dict(mt, auc_cvr=d.BAYES['lcvr'] - d.MARGIN['esmm_cvr']), pool=1)
  mind, evalp = d.mind_config(os.path.join(root, 'mind'))
  gate('MIND', mind, unfused, {'recall@5': d.mind_gate(evalp)})
  gate('DSSM pointwise', d.extra_config(os.path.join(root, 'extra'),
                                        d.DSSM_POINTWISE, 'ltwr'),
       unfused, {'auc': d.TWO_TOWER_BAR}, pool=1)
  control = gate('FM, tables frozen (control)', d.gate_config(
      root, d.RANK_BODIES['FM'], ['lint'], frozen=True), unfused,
                 {'auc': lint}, under=True)
  m_cpu = gate('FM', fm, unfused, {'auc': lint}, device='cpu')
  gap = abs(m_cpu['auc'] - m_fm['auc'])
  std = d.lint_order_spread(d.data_file(root, d.make_csv, 4096, 6)) * \
      math.sqrt(2)
  log('phase 37: FM auc card %.4f, CPU %.4f, gap %.4f (tolerance %.4f: %g '
      'times %.4f, one std of two random orders of the cells inside lint\'s '
      'levels); the control %.4f under the bar %.4f; %.1f s in all on %s; '
      'launches %s'
      % (m_fm['auc'], m_cpu['auc'], gap, GATE_CPU_STDS * std, GATE_CPU_STDS,
         std, control['auc'], lint, time.time() - t0, card, total))
  if not gap <= GATE_CPU_STDS * std:
    fail('phase 37: FM auc card %.4f against CPU %.4f, %.4f apart, past '
         '%.4f' % (m_fm['auc'], m_cpu['auc'], gap, GATE_CPU_STDS * std))
  os.environ['EASYREC_PACKED_FUSED'] = '0'
  return total, errs


def main():
  STARTED[0] = time.time()
  if not os.path.isdir(os.path.join(HERE, 'easyrec_torch')):
    fail('easyrec_torch/ is not beside chip_smoke.py: run it from the '
         'root of a checkout')
  sys.path.insert(0, HERE)
  import torch
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is False: this script needs a GPU')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  # 1. device
  name = torch.cuda.get_device_name(0)
  count = torch.cuda.device_count()
  smi = nvidia_smi_line()
  log('device: %s, count %d; nvidia-smi: %s; torch %s, CUDA %s'
      % (name, count, smi, torch.__version__, torch.version.cuda))
  card = '%s (nvidia-smi: %s)' % (name, smi)

  # 2. build
  from easyrec_torch.ops import kernels
  t0 = time.time()
  reports = kernels.build_all(verbose=True)
  log('build: %d kernels in %.1f s' % (len(reports), time.time() - t0))
  for kname, report in reports.items():
    for line in report.splitlines():
      if line.strip():
        log('  [%s] %s' % (kname, line.strip()))
  log('kernels: %s' % ', '.join(k.name for k in kernels.ALL))

  # 3-7
  from easyrec_torch.utils import flagship
  results = phase_kernels(torch)
  results += phase_kernels_ev(torch)
  results += phase_bag_pool(torch)
  groups = phase_groups(torch)
  phase_optimizers(torch)
  phase_agree(torch, 'DIN', flagship.taobao_din_config(
      batch_size=256, seq_len=8), '1')
  din = phase_slice(torch, card, 'Taobao DIN', flagship.taobao_din_config(),
                    '1', ('rmw_fused',), 'compact_adam')
  # 7 and 31: the flagship DeepFM from Criteo's binary layout
  deepfm, (err1, err2) = phase_criteo_binary(torch, card, smi)
  for r in results:
    if r['name'] == 'seg_sum':
      r['max_abs_err'] = max(r['max_abs_err'], err1)
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err2)
  # 35: the Criteo DLRM at full width from Parquet
  parquet, (err1, err2) = phase_parquet_dlrm(torch, card, smi)
  for r in results:
    if r['name'] == 'seg_sum':
      r['max_abs_err'] = max(r['max_abs_err'], err1)
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err2)
  # 34: the flagship DeepFM row-sharded in a world of one over NCCL
  sharded, (err1, err2), sharded_ms = phase_sharded(torch, smi)
  # 36: aot_pod_check and scaling_model at a world of 8
  errs = phase_pod_tools(torch, smi, sharded_ms)
  for r in results:
    if r['name'] == 'seg_sum':
      r['max_abs_err'] = max(r['max_abs_err'], err1, errs[0])
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err2, errs[1])
  adagrad = phase_slice(torch, card, 'flagship DeepFM, Adagrad tables',
                        flagship.criteo_deepfm_adagrad_config(), '0',
                        ('seg_sum', 'rmw_rows'), 'adagrad')
  phase_bst_agree(torch)
  phase_bst_forward(torch, smi)
  bst = phase_slice(torch, card, 'Taobao BST', flagship.taobao_bst_config(),
                    '0', ('seg_sum', 'rmw_rows'), 'compact_adam')
  phase_serve_bst(torch, smi)
  phase_multi_task(torch)
  mmoe = phase_slice(torch, card, 'Taobao MMoE', flagship.taobao_mmoe_config(),
                     '0', ('seg_sum', 'rmw_rows'), 'compact_adam')
  phase_serve_mmoe(torch, smi)
  phase_zoo(torch)
  dlrm = phase_slice(torch, card, 'Criteo DLRM', flagship.criteo_dlrm_config(),
                     '0', ('seg_sum', 'rmw_rows'), 'compact_adam', pool=1)
  phase_serve_dlrm(torch, smi)
  phase_backbone(torch)
  backbone = phase_slice(torch, card, 'Criteo DLRM, backbone DSL',
                         flagship.criteo_dlrm_backbone_config(), '0',
                         ('seg_sum', 'rmw_rows'), 'compact_adam', pool=1)
  phase_serve_dlrm(torch, smi, 'Criteo DLRM, backbone DSL',
                   'criteo_dlrm_backbone_config')
  phase_match(torch)
  dssm, (err1, err2), trained = phase_dssm(torch, card)
  for r in results:
    if r['name'] == 'seg_sum':
      r['max_abs_err'] = max(r['max_abs_err'], err1)
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err2)
  retrieve = phase_retrieve(torch, smi, os.path.join(SCRATCH, 'dssm'),
                            trained)
  del trained
  phase_rank_extra(torch)
  phase_feature_samples(torch)
  fg, (err1, err2) = phase_fg_din(torch, card, smi)
  for r in results:
    if r['name'] == 'seg_sum':
      r['max_abs_err'] = max(r['max_abs_err'], err1)
    if r['name'] == 'rmw_rows/compact_adam':
      r['max_abs_err'] = max(r['max_abs_err'], err2)
  phase_ckpt(torch)
  kafka = phase_kafka_din(torch, card)
  phase_small_readers(torch)
  ev = phase_ev(torch)
  phase_serve_deepfm(torch, smi)
  phase_serve_din(torch, smi)
  # 37: the learnability gates on the card (K1 + K2, K3)
  gates, errs = phase_gates(torch, card)
  errs = dict(zip(('seg_sum', 'rmw_rows/compact_adam',
                   'rmw_fused/compact_adam'), errs))
  for r in results:
    r['max_abs_err'] = max(r['max_abs_err'], errs.get(r['name'], 0.0))
  phase_kernel_only(torch)
  # launches on the paths: each kernel and math on the first path of
  # these that runs it (K1 and K2's compact Adam on the Parquet-fed DLRM;
  # K3 on the Kafka-streamed DIN, Adagrad on the Adagrad DeepFM's, the EV
  # maths on the EV phase's), 0 for a math no path runs, plus the
  # learnability gates' own (phase 37, this slice's path: K1, K2 and K3
  # with compact Adam)
  for r in results:
    r['launches'] = next((path[r['name']] for path in
                          (parquet, sharded, deepfm, kafka, fg, retrieve,
                           dssm, backbone, dlrm, mmoe, bst, din, adagrad,
                           ev)
                          if path.get(r['name'], 0)), 0) + \
        gates.get(r['name'], 0)
  results += groups
  keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
          'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
  print(json.dumps({'kernels': [{k: r[k] for k in keys} for r in results]}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                           'count': count}}), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
