"""Drive lightgbm_tpu_torch's training and serving paths on one CUDA card
and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:
  device  - nvidia-smi's name and power limit, torch and CUDA versions;
  build   - seconds to build the kernel library from csrc/ (0 on a hit)
            and the native host library (native/fastparse.cpp, g++); the
            script fails if the native library is not loaded;
  kernel  - one line per kernel (or kernel mode) at its path's shapes: its
            result against the plain PyTorch version on the same inputs
            (exact for the integer histograms, int16 and int8 modes, take
            and the fixed-point f32 histograms; seg_sum within rtol 1e-5 of
            the plain version in f64),
            bitwise equality across two launches for the f32 reductions
            and the int8 modes, and its median time over CUDA events
            beside the plain version's, one PyTorch library call's, and
            the least time the card could take; every line also gives the
            kernel's device time per call (device_ms: CUDA events around
            50 calls enqueued while the card spins; the profiler for a
            library call that reads back from the card) and the host's
            enqueue per call (host_us). The seg_sum line (the renewal's
            k = 2 and the refit totals' k = 1 at 255 and 31 leaves, the
            kernel and index_add_ timed in turns), the hist_nat,
            hist_nat_int8, hist, hist_slots and hist_round lines also give
            the kernel's device operations per call (torch.profiler); the
            hist_round lines (int16, int8, f32)
            come after the f32 paths and also run on the arguments of the
            first and the fullest round of the first tree of train,
            train_quant and train_f32; the take_small and hist_nat_f32
            lines come later too, on arguments captured from the training
            paths, kernel and library timed in turns;
  small   - 20k-row runs on the card against the same runs on the CPU
            (2 trees, 5 before the distributed phase came, 3 before
            ops_processes; the early stopping and replay runs keep
            theirs)
            (plain versions), default, exact, use_quantized_grad,
            regression_l1, dart, rf, extras, monotone intermediate and
            advanced, and linear_tree runs, and categorical runs (the
            train_cat schema
            plus a 3-category column, so one-vs-rest runs too) on the
            int16, use_quantized_grad (bench.py's parameters, and
            cat_quant_det without stochastic rounding and leaf renewal)
            and bf16x2 paths: predictions within 1e-4, except cat_quant
            (bench.py's parameters), whose difference is printed and
            whose every fused round and split search is replayed on the
            CPU from the card call's inputs and must match bit for bit;
            and the sampled runs: bagging (int16, pos / neg,
            use_quantized_grad, regression_l1, exact), GOSS on regression
            (int16; exact + tpu_growth_rounds), feature_fraction, early
            stopping that fires (the same best_iteration and trees),
            multiclassova and cross_entropy, held at 1e-4, and binary GOSS,
            held by its AUC rising and by replay_check;
  train   - the 1M x 28, 255-leaf binary workload (bench.py:386-406) on
            the default int16 rounds path, 2 warmup trees then 10 timed
            trees: trees/s, validation AUC after tree 1 and after the last
            tree, launches per kernel;
  profile - torch.profiler over 1 more tree (2 before the online loop
            came): device busy share and the
            kernels taking the most device time per tree;
  model   - save_model -> Booster(model_file=...) -> identical predictions
            on 1000 validation rows; host predictions match the scores
            the card accumulated;
  data_plane - data_source=chunked on the train phase's rows
            (ram_budget_mb=64: 14 chunks spooled to disk, binned in two
            passes, the card's matrix assembled from pinned slots on a
            copy stream): two fused trees equal the in-RAM set's (model
            text, raw predictions and device bins bit for bit), at
            prefetch depth 1 too; a 50,000-row CSV through the chunked
            text spool (bit for bit the in-RAM text fit) and two_round
            (its bins the CPU construct's); spool rows/s, pass seconds,
            the assembly's H2D bytes and GB/s, pinned MB, RSS peak and
            spread, beside the in-RAM device_arrays time;
  train_bag, train_goss - the workload with bagging (0.8 every tree) and
            feature_fraction 0.8, and with GOSS (top_rate 0.2, other_rate
            0.1: 11 trees before it samples): 2 warmup then 10 timed
            sampled trees, trees/s, AUC after the first sampled and the
            last tree, the rows in each tree's sample (bagging's counted
            against k = round(0.8 * rows) and the ties at its threshold,
            exactly; one bag drawn again on the CPU must be the same
            bits), features per tree, launches per tree, a 1-tree profile;
  train_continue - init_model = the model phase's file: the seeded
            validation scores against Booster(model_file=...)'s raw
            predictions (1e-5), then 3 trees with bagging, early stopping
            on validation AUC, record_evaluation and reset_parameter;
  api_cv - lgb.cv on the train phase's 1M rows (5 stratified folds of
            799,999-800,001 training rows, 10 rounds (20 before the
            online loop came), early stopping 5 on
            AUC) on the fused loop: 5 graph captures, valid auc-mean
            rising, fold 0's model text equal to train() on
            ds.subset(train_idx) with ds.subset(test_idx) as validation
            set, rollback_one_iter on that fused booster (host and device
            trees in step, the card's scores the host's within 1e-4), and
            fused cv against eager cv on 2 folds x 3 rounds bit for bit;
            capture s, trees/s over all folds, peak device MB;
  api_booster - on the train phase's booster: one more tree rolled back
            (validation scores within 1e-6 of before), set_leaf_output (the
            host predict, the device tree's leaf_value, predict on the
            card), refit on the 100,000 validation rows against the same
            refit under device_type=cpu (leaves within 1e-5), lower_bound
            <= raw predictions <= upper_bound, split importances equal to
            the model text's, shuffle_models (predictions within 1e-6);
  api_sparse - a 1M x 1,000 one-hot CSR (onehot_csr: 20 fields of 50
            levels, Zipf-like level frequencies, 20M non-zeros) built
            without densifying (its toarray raises): construct seconds,
            the bundled columns (EFB folds each field into one), 10 trees
            on the fused loop with validation AUC rising, and a 20,000-row
            slice trained on the card and on the CPU within 1e-4;
  api_file - the first 50,000 rows (200,000, then 100,000, before the
            script outgrew its limit) as CSV with
            a header, TSV and LibSVM (%.17g), each through Dataset(path): the numpy Dataset's bin
            matrix and 5-tree model text bit for bit; save_binary ->
            Dataset(bin_path) and a .weight sidecar give the same model
            as the numpy input and as weight=; write and parse seconds;
            the parse runs in the native library (native/fastparse.cpp,
            which must be loaded): its seconds and rows/s per format, and
            the CSV through np.loadtxt too, the same matrix bit for bit;
  cli     - python -m lightgbm_tpu_torch at the train phase's width on
            save_binary caches of its data: task=train (10 trees,
            snapshot_freq=5, resume=auto) killed by the fault plan
            round:7:kill, run again (it resumes from round 5) and run
            clean elsewhere: the two model files bit for bit, on the
            fused loop; task=predict on the card on the validation rows
            against the host walker (Booster.predict) within 1e-5;
            task=serve over stdio with
            device_put:2:raise and host_fallback=true: the faulted
            request's scores within 1e-5 of the device's; task=loop over
            stdio in a process of its own (a 50,000-row microbatch
            through the ingest op, one promoted verdict, quit); wall
            seconds, the snapshot round's ms;
  fallback_latency - in one process, a registry on the card with
            host_fallback: median ms of a 1-row and a 1,000-row request
            answered by the card and by the host fallback;
  online_loop - the online train-and-serve loop (online/) on the cli
            phase's clean model: a card registry serves while four
            cycles refit 10 trees on 50,000 fresh rows of the same
            concept each (clean, NaN labels, flipped labels, clean:
            promoted, rolled_back, rejected, promoted; the first batch
            through the HTTP ingest op), judged on the 100,000
            validation rows (AUC); two threads score the registry during
            every cycle (0 torn answers: each within 1e-5 of v(n)'s or
            v(n+1)'s host walker; p50 / p99 inside and outside the
            cycles); a raise at loop_refit on a fifth cycle, a restart
            serving the last promotion's bits, a refit of the same rows
            twice (the same text) and the replayed cycle, profiled: the
            launches of hist_nat, hist_round, seg_sum and take_small in
            one cycle;
  recorder - train() with record_file and anomaly_policy=warn against
            train() without, on the fused loop, in turns (1 + 20 trees,
            40 before the online loop came): trees/s and
            graph nodes of each; 6 recorded trees on both loops, the
            fused records the eager records key for key and bit for bit
            but the timings and the evaluations (within 1e-6);
  train_exact, train_exact_rounds, train_f32 - the same workload on the
            f32 paths (tpu_growth_mode=exact; exact + tpu_growth_rounds;
            rounds + tpu_hist_dtype=bf16x2), 1 warmup tree then 2 timed
            trees each (3 before the online loop came), with the same
            checks and a 1-tree profile; then
            the hist_slots line (the warmup tree's fullest round of
            train_exact_rounds) and two replay lines: hist_tree, every
            hist call of train_exact's warmup tree (its segment bounds
            recorded at call time), and hist_slots_tree, every round of
            train_exact_rounds' warmup tree, each replayed on its tree's
            final leaf-grouped matrix: every call bitwise against its
            plain version and across two replays, the replay's device
            time (CUDA events around it, enqueued behind a spin) beside
            the sum of the calls' bounds, the calls and their sizes;
  train_quant - the workload with bench.py's quantized parameters
            (use_quantized_grad, 4 levels, quant_train_renew_leaf): the
            int8 modes of hist_nat and hist_round; 2 warmup then 10 timed
            trees, AUC beside the int16 `train` phase's at the same tree
            count, and a 1-tree profile;
  train_l1 - the same features with the continuous label (the logits
            plus noise before bench.py thresholds them), regression_l1 on
            the default int16 path: the percentile leaf refit through
            hist_nat's f32 mode, 4 launches per tree; 1 warmup then 3
            timed trees, validation L1 after the first and the last tree,
            and a 1-tree profile;
  train_l1_31 - the same at LightGBM's default 31 leaves, 1 warmup then
            2 timed trees; the hist_nat_f32 kernel line runs on the
            arguments of the first tree's first and fourth refit passes
            of train_l1 and of train_l1_31 (train_l1_31's first pass
            timed twice: at the start of the line and in its place),
            and the take_small line on
            train's validation traversal (k = 8), train's score update
            (k = 1) and train_l1's refit (k = 2), with the 1M-row
            synthetic numbers of earlier runs beside them;
  train_cat - categorical splits: a 1M-row synthetic dataset with the
            schema of the airline departure-delay benchmark
            (szilard/benchm-ml, dep_delayed_15min: six code columns marked
            categorical, DepTime and Distance numerical), the default int16
            rounds path with the sorted-subset search and hist_round's
            categorical variant; 2 warmup then 10 timed trees, AUC after
            the first and the last tree, categorical splits in the trees,
            hist_round_cat launches per tree, and a 1-tree profile; the
            hist_round_cat kernel line runs on the arguments of the first
            tree's round with the most categorical slots, with its time
            on the int16 line's inputs (G = 28, every other slot
            categorical) beside it;
  *_fused_vs_eager - the fused loop against the eager loop in turns, on
            the same data and parameters, for train, train_bag,
            train_goss, train_quant, train_l1, train_f32 (after the f32
            paths), train_exact and train_exact_rounds (the exact grower,
            its splits on the segment ladder and its round phase in the
            graph: 1 warm-up and 1 timed tree, 3 before the online loop
            came, 2 before ops_processes) and train_cat (after its
            phase): 1 warm-up and 3 timed trees each (6 before
            ops_processes; train_goss 11 unsampled trees first, then 3 timed
            trees; train_cat, train_extras and train_forced 3; 6 before
            the online loop came); trees/s, host ms a tree, splits a
            tree, device busy share and device operations a tree for both
            loops; capture seconds, graph nodes, graph launches a tree,
            rounds per tree and overflows for the graph; model text and
            validation scores bitwise equal, eval records within 1e-5, 0
            overflows and the path's kernels in the graph (fused_summary
            gathers the paths). The small phase's early stopping also
            runs the eager loop on the card (the same stop, the same
            model text as the fused loop);
  mono_dataset, train_mono_intermediate, train_mono_advanced,
  train_mono_basic, train_mono_exact - monotone constraints on the
            Higgs-like rows (binned again: a Dataset takes its
            constraints when it is constructed) on columns 0, 1, 3 and
            5, each in the direction the label moves with it
            (mono_directions); intermediate and advanced through
            fused_vs_eager (1 warm-up and 2 timed trees; 4 before the
            online loop came), their check
            the resolved method, the splits the conflict guard deferred
            and those on the constrained columns a tree, and on the
            eager loop the violation scan (2,000 validation rows, each
            constrained column swept across the model's thresholds on
            it: no step against its direction beyond 1e-6), AUC rising
            on both loops; a `*_tables` line each: grower.mono_bounds
            and the all-leaf re-search of one eager tree replayed, device
            ms a tree; basic on the fused loop (AUC, trees/s); and
            intermediate on the exact grower (63 leaves, 2 eager trees),
            then train_mono_exact_fused_vs_eager (the same, 1 warm-up and
            2 timed trees each loop);
  train_linear - linear_tree (linear_lambda 0.1) on the binary
            workload, 2 eager trees (5 before the cli phase came, 3
            before the distributed phase): trees/s, host ms a tree in the leaf
            fits and in the rest, AUC after each tree; the train score of
            50,000 rows against a fresh predict(raw_score=True) and
            predict(device="cuda") against the host walker on 20,000
            validation rows (1e-5), the model text round trip;
  train_rank, train_rank_xendcg - learning to rank at MSLR-WEB10K's
            shape (mslr_like: 10,000 queries, ~1.2M documents averaging
            ~120 a query with one of 908, 136 float32 features, labels
            0-4 skewed toward 0; 2,000 validation queries), lambdarank
            then rank_xendcg at the headline widths, validation ndcg@1/3/
            5/10: fused_vs_eager (1 warm-up + 3 timed trees, 5 before
            the cli phase came; rank_xendcg 1 + 3), ndcg@10 rising on both loops, one lambdarank launch a
            tree on the eager loop and one in the graph, dataset seconds
            and peak device MB; then train_rank_profile (1 tree) and the
            `lambdarank` kernel line: the kernel against its plain
            version on the whole training set at iteration 0's equal
            scores, the profiled model's scores and those scores with
            ties, norm on and off, and on a 908- and a 4,096-document
            query, within 5e-5 of the plain version's largest value,
            bitwise across calls; its times against its bound (pairs a
            call, unequal-label pairs x 24 operations / 67 TFLOP/s);
  rank_small - 4,915 MSLR-shaped rows on the card against the CPU:
            bagging_by_query (whole queries, the CPU's bags bit for bit)
            and position debiasing (the eager loop and its reason,
            finite biases); predictions within 1e-4, or the models part
            at a near tie (gains within 1e-6 relative);
  serve_forest - serving: the Higgs-like binary model
            trained to 500 trees on the fused loop, then
            Booster.predict(device="cuda") (the tensorized forest,
            serving/forest.py: one take_small gather of the packed node
            table a level) on the 100,000 validation rows, the first
            10,000 of them (all 100,000, then 20,000, before the script
            outgrew its limit) against the host
            walker: raw scores within rtol 1e-5 / atol 1e-5, pred_leaf
            exactly, rows/s of both; the same on 20-tree models of
            train_cat's data (category bitsets) and train_rank's (136
            columns); take_small launches counted from zero over the
            Higgs-like check (the kernels line's launches);
  take_small_serve - kernel line: one level's gather of a 4096-row bucket
            over the 500 trees (2,048,000 lanes, k = 9, L = 500 x
            max_nodes, the unstaged path), bitwise against
            take_cols_plain and across launches, in turns with
            index_select, its bound (bytes / 3.35 TB/s) and launches per
            call;
  serve_dispatch - BucketDispatcher warmed up (one CUDA graph per rung
            of 16 ... 4096), then 100 requests of 1-5,000 rows: captures
            equal the rungs and do not grow, every answer bitwise the
            unbucketed forest's; graph nodes and device ms a replay per
            rung;
  serve_loaded - bench_serve.py's phases 1-2 (20,000 x 16 rows,
            RandomState(0), 50 trees x 31 leaves, batch 1): baseline (1
            replica, 256 direct requests) and loaded (2 replicas behind
            the MicroBatcher, 8 threads x a window of 128, 8,192
            requests): qps, p50 / p99 ms, coalesce ratio, device calls, a
            64-row probe bitwise equal across both paths; then the same
            with the 500-tree, 255-leaf forest;
  serve_http - serve_http on a free local port: /readyz 200 after
            warm-up, /v1/score equal to a direct predict, /metrics with
            lgbmtpu_serve_* series;
  gateway - serving/gateway.py in front of two serve_http backends on
            card registries (the 50 x 31 model): 8 client threads, 1,000
            batch-1 requests through the gateway and 1,000 direct (2,000
            each before the distributed phase came; qps,
            p50 / p99); 400 requests each under gw_backend_5xx, under
            gw_slow_backend (hedges fired and won within their budget)
            and across a backend's drain (its /readyz 503, no attempt
            reaches it): 0 client failures, every answer within 1e-5 of
            the host walker; the gateway's /metrics merges both
            backends' series;
  ops_processes - the same 50 x 31 model saved to a file behind the
            operations scripts' process fleet
            (lightgbm_tpu_torch/tools/gateway_rolling.py): 2 task=serve
            backend processes on the card and one task=gateway process
            (the runbook's settings: no hedges, a breaker that opens on
            one failure), each backend warmed directly; 8 client threads, 1,000 batch-1
            requests through the gateway process and 1,000 straight to
            one backend (qps, p50 / p99); the rolling SIGTERM restart of
            both backends on their ports under a continuous client; kill
            -9 of one backend under load, its restart and its breaker's
            open -> half_open -> closed read from the gateway process's
            /metrics (seconds to closed); the processes the gateway's
            merged /metrics covers (3); the gateway's SIGTERM drain with
            a 50,000-row request in flight (new work 503 shutdown, the
            request 200, exit 0); every process's exit codes. Fails on a
            client failure, an answer more than 1e-5 from the host
            walker, a breaker that does not close, a merged pane of other
            than 3 processes or a drained process exiting non-zero;
  serve_contrib - device TreeSHAP on the 50-tree model, 64 rows (1,024
            before the cli phase came, 512 before the online loop, 256
            before the distributed phase, 128 before ops_processes),
            against host shap.py (8 worker processes): within 1e-5, rows
            summing to the raw score; device ms and peak memory;
  serve_fleet - the multi-tenant ModelFleet: 7 tenants (text cuts of the
            500-tree forest at 50, 100, 200, 300 and 500 trees, the
            20-tree categorical and ranking models; at least 3 shape
            families) behind 4 resident slots, rungs 16 / 64 / 256: one
            request a tenant and rung (captures = families x rungs),
            then a Zipf-like churn trace of 600 requests of 1-256 rows:
            page-ins, evictions, captures (unchanged by the trace), p50 /
            p99 ms of resident and of paged requests, qps, each tenant's
            worst difference from its own TensorForest on the card
            (<= 1e-5) and the slots it used; and one tenant scored from
            two slots of its stack (the same bits, one capture);
  distributed - the distributed learners (ROADMAP A.8) on the train
            phase's 1M x 28 rows at 255 leaves: two gloo ranks sharing
            the card (NCCL takes one rank a GPU), each a process holding
            half the rows (all of them under feature), binned on the
            gathered sample; tree_learner data and voting (int16 rounds
            path, whose sums cross as f32 at this size; voting's default
            top_k elects all 28 columns) 3 trees, data_quant (data with
            use_quantized_grad: the int32 reduce-scatter) 3 trees,
            feature (the exact grower) 2 trees; each rank's trees against
            the serial run on the card on the same bins, bit for bit:
            trees/s after a warm tree, collective ms a tree (host wall of
            the collectives, pinned staging included), wire bytes a tree,
            launches a tree (each rank's counts, reset before its timed
            trees); serving's mesh= at the two ranks against the
            single-process forest and registry (bit for bit); then one
            NCCL rank (world size 1, the collective layer forced onto it)
            through every run against serial, 2 trees on 50,000 rows
            (where the int16 sums take the reduce-scatter too),
            and the layer's reduce_scatter / all_gather / all_reduce on
            CUDA tensors (the loop stays eager under a mesh: nothing is
            captured);
then the `kernels` summary line and, last, {"ok": true, "device": ...}.
Any failure raises: no `ok` line, non-zero exit. Without a CUDA device,
or without the package beside it, the script exits non-zero at once.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the card's published peaks (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12  # f32 / int32 outside the tensor cores

N_ROWS = 1_001_472  # 1M rows padded to the 2048-row block
G, BC, S_ROUND, L = 28, 256, 48, 255
S_ROUND_F32, S_SLOTS = 25, L // 2 + 1
REPLACES = {
    "hist_nat": "lightgbm_tpu/learner/pallas_hist.py:202",
    "hist_round": "lightgbm_tpu/learner/pallas_hist.py:505",
    "take_small": "lightgbm_tpu/learner/pallas_hist.py:569",
    "seg_sum": "lightgbm_tpu/learner/pallas_hist.py:617",
    "hist": "lightgbm_tpu/learner/pallas_hist.py:766",
    "hist_slots": "lightgbm_tpu/learner/pallas_hist.py:742",
    "hist_round_f32": "lightgbm_tpu/learner/pallas_hist.py:505",
    "hist_nat_int8": "lightgbm_tpu/learner/pallas_hist.py:202",
    "hist_round_int8": "lightgbm_tpu/learner/pallas_hist.py:505",
    "hist_nat_f32": "lightgbm_tpu/learner/pallas_hist.py:202",
    "hist_round_cat": "lightgbm_tpu/learner/pallas_hist.py:505 "
                      "(has_cat :416-432)",
    "lambdarank": "lightgbm_tpu/learner/ranking.py:109 (XLA, no "
                  "pallas_call)",
    "take_small_serve": "lightgbm_tpu/learner/pallas_hist.py:569 (via "
                        "lightgbm_tpu/serving/forest.py:253 take_cols)",
}
SOURCES = {
    "hist_nat": "lightgbm_tpu_torch/csrc/hist_nat.cu",
    "hist_round": "lightgbm_tpu_torch/csrc/hist_round.cu",
    "take_small": "lightgbm_tpu_torch/csrc/take_small.cu",
    "seg_sum": "lightgbm_tpu_torch/csrc/seg_sum.cu",
    "hist": "lightgbm_tpu_torch/csrc/hist.cu",
    "hist_slots": "lightgbm_tpu_torch/csrc/hist.cu",
    "hist_round_f32": "lightgbm_tpu_torch/csrc/hist_round.cu",
    "hist_nat_int8": "lightgbm_tpu_torch/csrc/hist_nat.cu",
    "hist_round_int8": "lightgbm_tpu_torch/csrc/hist_round.cu",
    "hist_nat_f32": "lightgbm_tpu_torch/csrc/hist_nat.cu",
    "hist_round_cat": "lightgbm_tpu_torch/csrc/hist_round.cu",
    "lambdarank": "lightgbm_tpu_torch/csrc/lambdarank.cu",
    "take_small_serve": "lightgbm_tpu_torch/csrc/take_small.cu",
}
# the training path whose run counts each kernel's launches
PATH_OF = {"hist_nat": "train", "hist_round": "train", "take_small": "train",
           "seg_sum": "train", "hist": "train_exact",
           "hist_slots": "train_exact_rounds",
           "hist_round_f32": "train_f32", "hist_nat_int8": "train_quant",
           "hist_round_int8": "train_quant", "hist_nat_f32": "train_l1",
           "hist_round_cat": "train_cat", "lambdarank": "train_rank",
           "take_small_serve": "serve_forest"}
F32_PATHS = {
    "train_exact": {"tpu_growth_mode": "exact"},
    "train_exact_rounds": {"tpu_growth_mode": "exact",
                           "tpu_growth_rounds": True},
    "train_f32": {"tpu_growth_mode": "rounds", "tpu_hist_dtype": "bf16x2"},
}
# kernels each f32 path must launch
F32_NEEDS = {"train_exact": ("hist",),
             "train_exact_rounds": ("hist", "hist_slots"),
             "train_f32": ("hist", "hist_round_f32")}
# bench.py:409-415's quantized-gradient parameters
QUANT_PARAMS = {"use_quantized_grad": True, "num_grad_quant_bins": 4,
                "quant_train_renew_leaf": True}


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the script's seconds
    so far (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 15, warm: int = 3) -> float:
    """Median milliseconds of fn() over CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 50) -> float:
    """Median microseconds the host spends in one call of fn: its
    enqueue, time.perf_counter around the call with no synchronization."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


EVENTS_TIME = ("CUDA events around 50 back-to-back calls, / 50; the calls "
               "are enqueued while the card spins (torch.cuda._sleep), so "
               "the card runs them back to back: the kernels and the gaps "
               "between them, not the host's enqueue")
PROFILER_TIME = ("torch.profiler over 50 calls: per kernel name its mean "
                 "CUPTI event time times its launches per call; for a call "
                 "that reads back from the card (bincount sizes its output "
                 "from the key's maximum), which the host cannot enqueue "
                 "ahead of the card")


def device_ms(fn, calls: int = 50):
    """(device milliseconds per call of fn, how it was measured): CUDA
    events (EVENTS_TIME) when the host can enqueue the calls while the
    card still spins, else the profiler (PROFILER_TIME); (None, ...)
    when the profiler returns no event of fn. The profiler's sessions
    can come back short, so it is not the first choice."""
    import torch

    fn()
    torch.cuda.synchronize()
    for spin in (1 << 24, 1 << 27):  # ~10 ms, ~80 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        ahead = not start.query()  # the card still spun when all were in
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / calls, EVENTS_TIME
    return profiled_ms(fn, calls), PROFILER_TIME


def profiled_ms(fn, calls: int):
    """PROFILER_TIME of fn, or None when the session holds no event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = 0.0
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0 and e.count:
            ms += t / e.count * max(1, round(e.count / calls)) / 1e3
    return ms or None


def in_turns(kernel, library) -> dict:
    """A kernel and the library call computing the same function, timed
    in turns in this run (kernel, library, library, kernel): single-call
    CUDA-event medians (ms), device time per call (device_ms, with how
    it was measured) and the host's enqueue per call (host_us)."""
    ms = [cuda_ms(f) for f in (kernel, library, library, kernel)]
    dev = [device_ms(f) for f in (kernel, library, library, kernel)]
    lib = [d[0] for d in dev[1:3] if d[0] is not None]
    if dev[0][1] != EVENTS_TIME or dev[3][1] != EVENTS_TIME:
        raise AssertionError("the host could not enqueue the kernel's calls "
                             "ahead of the card")
    return dict(
        ms=(ms[0] + ms[3]) / 2, ms_turns=[ms[0], ms[3]],
        library_ms=(ms[1] + ms[2]) / 2, library_ms_turns=[ms[1], ms[2]],
        device_ms=(dev[0][0] + dev[3][0]) / 2,
        device_ms_turns=[dev[0][0], dev[3][0]], device_time=dev[0][1],
        library_device_ms=sum(lib) / len(lib) if lib else None,
        library_device_ms_turns=[d[0] for d in dev[1:3]],
        library_device_time=dev[1][1],
        host_us=host_us(kernel), library_host_us=host_us(library))


def kernel_times(fn) -> dict:
    """A kernel's device time per call (device_ms, with how it was
    measured: the profiler when a call waits for the card, as hist's
    copy of a host row range does) and the host's enqueue per call
    (host_us)."""
    dev, how = device_ms(fn)
    return dict(device_ms=dev, device_time=how, host_us=host_us(fn))


def kernel_numbers(fn) -> dict:
    """A kernel's single-call CUDA-event median (ms), its device time and
    host enqueue per call (kernel_times, CUDA events), and its device
    operations per call (launches_per_call)."""
    d = kernel_times(fn)
    if d["device_time"] != EVENTS_TIME:
        raise AssertionError("the host could not enqueue the kernel's calls "
                             "ahead of the card")
    return dict(ms=cuda_ms(fn), **d, launches_per_call=launches_per_call(fn))


def launches_per_call(fn, calls: int = 10):
    """Device operations (kernels and fills) per call of fn, counted by
    torch.profiler over `calls` calls; None when the session holds no
    event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if "cuda" in str(getattr(e, "device_type", "")).lower())
    return n / calls if n else None


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, hist, ch):
    """Each kernel at the main path's shapes against its plain version."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(17)
    bins = torch.randint(0, BC - 1, (G, N_ROWS), generator=gen,
                         dtype=torch.int32).to(dev)
    gq = torch.randint(-128, 129, (N_ROWS,), generator=gen)
    hq = torch.randint(0, 257, (N_ROWS,), generator=gen)
    cnt = torch.ones(N_ROWS, dtype=torch.int64)
    cnt[-1472:] = 0  # padding rows carry zero channels
    gq[-1472:] = 0
    hq[-1472:] = 0
    gh = torch.stack([gq, hq, cnt]).to(torch.int32).to(dev)
    lines = {}

    # ---- hist_nat: the root histogram (S = 1)
    slot0 = torch.zeros(N_ROWS, dtype=torch.int32, device=dev)
    run = lambda: hist.hist_nat_slots(bins, gh, slot0, 1, BC)
    plain = lambda: hist.hist_nat_slots_plain(bins, gh, slot0, 1, BC)
    res = f32_compare(torch, run, plain, "hist_nat",
                      "exact (integer sums on both sides)")
    key, w, size = flat_key(torch, bins, gh, slot0, 1, BC)
    rows = int((gh[2] != 0).sum())
    b, bb = bound(N_ROWS * 4 * (G + 4) + 1 * 3 * G * BC * 4, rows * G * 3)
    lines["hist_nat"] = dict(
        shape=f"bins ({G},{N_ROWS}) S=1 Bc={BC}", **res,
        plain_ms=cuda_ms(plain, reps=10),
        library_ms=cuda_ms(lambda: torch.bincount(
            key, weights=w, minlength=size + 1), reps=10),
        bound_ms=b, bound_by=bb, **kernel_numbers(run))
    del key, w

    # ---- hist_round: one full-width round (S = 48) with random valid
    # splits; a few slots decode EFB bundle columns, two are unused
    pleaf = torch.randint(0, L + 1, (N_ROWS,), generator=gen,
                          dtype=torch.int32).to(dev)
    leaves = torch.randperm(L, generator=gen)[:S_ROUND].to(torch.int32)
    params = torch.zeros((S_ROUND, 16), dtype=torch.int32)
    params[:, 0] = leaves
    params[:, 1] = torch.randint(0, G, (S_ROUND,), generator=gen)
    params[:, 2] = torch.randint(0, BC - 2, (S_ROUND,), generator=gen)
    params[:, 3] = torch.randint(0, 2, (S_ROUND,), generator=gen)
    params[:, 4] = torch.where(torch.rand(S_ROUND, generator=gen) < 0.5,
                               BC - 1, -1)
    params[:, 5] = torch.randint(0, 2, (S_ROUND,), generator=gen)
    params[:, 6] = 200 + torch.arange(S_ROUND)
    params[:, 8] = -1
    efb = torch.arange(S_ROUND) % 8 == 3
    params[efb, 7] = 16
    params[efb, 8] = 2
    params[efb, 9] = 64
    params[-2:, 0] = -1
    params = params.to(dev)
    lines["hist_round"] = round_shape(
        torch, hist, ch, (bins, gh, pleaf, params, S_ROUND, BC, L, None,
                          256), "hist_round")

    cat_synth = hist_round_cat_synth(torch, hist, ch, bins, gh, pleaf,
                                     params, gen)

    # ---- take_small: score update (k = 1) and traversal (k = 8)
    idx = torch.randint(-1, L + 1, (N_ROWS,), generator=gen,
                        dtype=torch.int32).to(dev)
    takes = {}
    for k in (1, 8):
        tab = torch.randn((k, L), generator=gen).to(dev)
        ok_ = torch.equal(hist.take_cols(tab, idx),
                          hist.take_cols_plain(tab, idx))
        if not ok_:
            raise AssertionError(f"take_small k={k} disagrees")
        b, bb = bound(N_ROWS * 4 + k * L * 4 + k * N_ROWS * 4, 0)
        safe = idx.clamp(0, L - 1).long()
        takes[k] = dict(
            ms=cuda_ms(lambda: hist.take_cols(tab, idx)),
            plain_ms=cuda_ms(lambda: hist.take_cols_plain(tab, idx)),
            library_ms=cuda_ms(lambda: torch.index_select(tab, 1, safe)),
            bound_ms=b, bound_by=bb)
    # the shapes this line timed before it took the training paths'
    # arguments (take_small_line), kept beside them for comparison
    take_synth = dict(shape=f"tab (8,{L}) idx ({N_ROWS},); k=1 in k1",
                      k1=takes[1], **takes[8])

    # ---- seg_sum: true-gradient renewal (k = 2, L = 255) and the refit's
    # per-leaf totals (k = 1, L = 255 and 31)
    vals = torch.randn((2, N_ROWS), generator=gen).to(dev)
    idx_s = torch.where(torch.rand(N_ROWS, generator=gen).to(dev) < 0.9,
                        idx, torch.full_like(idx, L))
    seg = {}
    for name, k, nl in (("renewal_k2", 2, L), ("refit_k1", 1, L),
                        ("refit_k1_31", 1, 31)):
        seg[name] = seg_sum_numbers(torch, hist, ch, vals[:k].contiguous(),
                                    idx_s.remainder(nl + 1) if nl != L
                                    else idx_s, nl)
    lines["seg_sum"] = dict(seg["renewal_k2"], shapes=seg)
    lines["seg_sum"]["shape"] += " (renewal; the refit totals in shapes)"
    lines.update(f32_kernel_lines(torch, hist, ch, bins, gen, pleaf,
                                  params))
    lines.update(int8_kernel_lines(torch, hist, ch, bins, gen, pleaf,
                                   params))
    for name, d in lines.items():
        # hist_round and hist_nat come after the captured calls
        if not name.startswith("hist_round") and name != "hist_nat":
            emit_kernel(name, d)
    return lines, cat_synth, take_synth


def hist_round_cat_synth(torch, hist, ch, bins, gh, pleaf, params, gen):
    """hist_round's categorical variant on the int16 line's inputs (G =
    28), every other slot flagged categorical with a random category
    set: a secondary field of the hist_round_cat line, whose own numbers
    come from a train_cat round (hist_round_cat_line)."""
    dev = bins.device
    prm = params.clone()
    prm[0::2, 10] = 1
    cat_mask = (torch.rand((S_ROUND, BC), generator=gen) < 0.5).to(dev)
    d = round_shape(torch, hist, ch, (bins, gh, pleaf, prm, S_ROUND, BC, L,
                                      cat_mask, 256), "hist_round_cat")
    # the categorical variant on the int16 line's own (numerical) slots:
    # what the variant costs apart from the categorical decisions
    d["numeric_slots"] = kernel_times(lambda: hist.hist_round(
        bins, gh, pleaf, params, S_ROUND, BC, L, cat_mask=cat_mask))
    d["shape"] = (f"bins ({G},{N_ROWS}) S={S_ROUND} Bc={BC}, "
                  f"{S_ROUND // 2} categorical slots")
    return d


def round_bound(torch, bins, gh, n_split, n_kept, S, Bc, words=0):
    """The least bytes and operations of one hist_round call: pleaf read
    and the new ids written (8 B a row; the f32 mode reads every row's
    channels for the scale), one split-column bin and one count per row of
    a split leaf, the G bins and channels of each kept row, the params and
    category sets, the (S, 3, G, Bc) f32 output written once."""
    Gk, n = bins.shape
    es = gh.element_size()
    scale = n * 3 * es if gh.dtype == torch.float32 else 0
    return bound(n * 8 + scale + n_split * (4 + es)
                 + n_kept * (Gk * 4 + 3 * es) + S * 16 * 4 + words * 4
                 + S * 3 * Gk * Bc * 4,
                 n_kept * Gk * 3 + n_split * 8)


def round_shape(torch, hist, ch, args, name, library=True):
    """hist_round on one round's arguments (bins, gh, pleaf, params, S,
    Bc, num_leaves, cat_mask, levels): the histograms and the row -> leaf
    bitwise against the plain version and across two launches, the
    kernel's times and device operations per call (kernel_numbers), the
    plain version's time, bincount's (the histogram half only) and the
    bound."""
    bins, gh, pleaf, prm, S, Bc, num_leaves, cat_mask, levels = args
    quant = gh.dtype != torch.float32
    run = lambda: hist.hist_round(bins, gh, pleaf, prm, S, Bc, num_leaves,
                                  quant=quant, cat_mask=cat_mask,
                                  levels=levels)
    plain = lambda: hist.hist_round_plain(bins, gh, pleaf, prm, S, Bc,
                                          quant=quant, cat_mask=cat_mask)
    res = f32_compare(torch, lambda: run()[0], lambda: plain()[0], name,
                      "exact (integer sums on both sides)" if quant else
                      "exact (int64 fixed point on both sides)")
    pk, pk2 = run()[1], run()[1]
    pl_p, hslot = hist.round_partition_plain(bins, pleaf, prm, S, cat_mask)
    if not (torch.equal(pk, pl_p) and torch.equal(pk, pk2)):
        raise AssertionError(f"{name}'s row -> leaf disagrees")
    Gk, n = bins.shape
    n_split = int(torch.isin(pleaf, prm[:, 0][prm[:, 0] >= 0]).sum())
    small = hslot < S
    kept = small & (gh[2] != 0)
    n_kept = int(kept.sum())
    kept_per_slot = torch.bincount(hslot[kept].long(), minlength=S)[:S]
    words = 0 if cat_mask is None else S * -(-Bc // 32)
    b, bb = round_bound(torch, bins, gh, n_split, n_kept, S, Bc, words)
    return dict(
        shape=f"bins ({Gk},{n}) S={S} Bc={Bc}", **res,
        used_slots=int((prm[:, 0] >= 0).sum()), n_split=n_split,
        n_small=int(small.sum()), n_kept=n_kept,
        kept_per_slot=kept_per_slot.tolist(),
        categorical_slots=int((prm[:, 10] != 0).sum()),
        **kernel_numbers(run), plain_ms=cuda_ms(plain, reps=5),
        library_ms=(bincount_ms(torch, bins, gh, hslot, S, Bc) if library
                    else None),
        library_note="bincount of the histogram half only",
        bound_ms=b, bound_by=bb)


def seg_sum_numbers(torch, hist, ch, vals, idx, num_out):
    """seg_sum on (k, N) values: bitwise across two launches, within rtol
    1e-5 (atol 1e-3) of the plain version evaluated in f64 on the same
    values, and within the kernel's own bound of it (|sum| x 2^-23 + N x
    2^-38: the fixed-point rounding and the one f32 rounding), the kernel
    and index_add_ timed in turns (in_turns), its device operations per
    call, and the bound. The plain version in f32 (index_add_ with float
    atomics on the card) lands its adds in no fixed order, and at L = 31
    its own rounding error moves from run to run past the atol, so it is
    timed and its distance from the f64 sums reported, but the kernel is
    held against the f64 sums."""
    run = lambda: hist.seg_sum(vals, idx, num_out)
    s1, s2 = run(), run()
    sp = hist.seg_sum_plain(vals, idx, num_out)
    sp64 = hist.seg_sum_plain(vals.double(), idx, num_out)
    torch.cuda.synchronize()
    if not torch.equal(s1, s2):
        raise AssertionError("seg_sum is not bitwise reproducible")
    a64 = s1.double()
    n_rows = vals.shape[1]
    if not (torch.allclose(a64, sp64, rtol=1e-5, atol=1e-3)
            and bool(((a64 - sp64).abs() <= sp64.abs() * 2.0 ** -23
                      + n_rows * 2.0 ** -38).all())):
        raise AssertionError("seg_sum disagrees with its plain version")
    k, n = vals.shape
    ok_i = (idx >= 0) & (idx < num_out)
    safe = torch.where(ok_i, idx, num_out).long()
    lib_out = torch.zeros((k, num_out + 1), device=vals.device)
    turns = in_turns(run, lambda: lib_out.index_add_(1, safe, vals))
    b, bb = bound(n * 4 * (k + 1) + k * num_out * 4, k * n)
    return dict(
        shape=f"vals ({k},{n}) L={num_out}",
        tolerance=("rtol 1e-5 (atol 1e-3) and |sum| x 2^-23 + N x 2^-38 "
                   "vs the plain version in f64; bitwise across runs"),
        max_abs_err=float((a64 - sp64).abs().max()),
        plain_f32_max_abs_err=float((sp.double() - sp64).abs().max()),
        max_abs_err_vs_plain_f32=float((s1 - sp).abs().max()),
        bitwise_repeat=True,
        **turns, launches_per_call=launches_per_call(run),
        library_call="index_add_ into a (k, L + 1) buffer",
        plain_ms=cuda_ms(lambda: hist.seg_sum_plain(vals, idx, num_out)),
        bound_ms=b, bound_by=bb)


def hist_round_cat_line(torch, hist, ch, captured, synth):
    """hist_round's categorical variant on the arguments of the fullest
    round of a real train_cat tree (the round with the most categorical
    slots at the widest slot count), with the int16 line's synthetic
    inputs beside it (synth)."""
    d = round_shape(torch, hist, ch, captured["args"], "hist_round_cat")
    d["shape"] += (f", {d['categorical_slots']} categorical slots, from "
                   f"train_cat round {captured['round']} of its first tree")
    d["int16_line_inputs"] = {k: v for k, v in synth.items()
                              if k not in ("tolerance", "library_note")}
    return d


@contextlib.contextmanager
def recording_rounds(store, key=None):
    """While active, keep the arguments of rounds.hist_round's calls:
    store["first"], the first call's; store["fullest"], the call with the
    largest key(params, S, cat_mask) (default: the most used slots, then
    the widest slot count); key None skips a call. The arguments are
    (bins, gh, pleaf, params, S, Bc, num_leaves, cat_mask, levels)."""
    from lightgbm_tpu_torch.learner import rounds

    orig = rounds.hist_round
    n_round = [0]
    if key is None:
        key = lambda prm, S, cm: (int((prm[:, 0] >= 0).sum()), S)

    def recording(bins, gh, pleaf, params, S, Bc, num_leaves, quant=True,
                  cat_mask=None, levels=None):
        args = (bins, gh, pleaf.clone(), params.clone(), S, Bc, num_leaves,
                None if cat_mask is None else cat_mask.clone(), levels)
        out = orig(bins, gh, pleaf, params, S, Bc, num_leaves, quant=quant,
                   cat_mask=cat_mask, levels=levels)
        n_round[0] += 1
        if "first" not in store:
            store["first"] = dict(args=args, round=n_round[0])
        k = key(params, S, cat_mask)
        if k is not None and k > store.get("key", ()):
            store.update(key=k, fullest=dict(args=args, round=n_round[0]))
        return out
    rounds.hist_round = recording
    try:
        yield
    finally:
        rounds.hist_round = orig


def captured_round_shapes(torch, hist, ch, store, path):
    """round_shape on a training path's first and fullest captured rounds
    (recording_rounds), keyed '<path>_first' / '<path>_fullest'."""
    out = {}
    for which in ("first", "fullest"):
        cap = store[which]
        d = round_shape(torch, hist, ch, cap["args"], f"{path} {which}")
        d["shape"] += f", round {cap['round']} of {path}'s first tree"
        out[f"{path}_{which}"] = d
    return out


@contextlib.contextmanager
def recording_root(store):
    """While active, keep the arguments of the rounds grower's first root
    histogram (rounds.hist_nat_slots): store["args"] = (bins, gh, slot,
    S, Bc, levels)."""
    from lightgbm_tpu_torch.learner import rounds

    orig = rounds.hist_nat_slots

    def recording(bins, gh, slot, S, Bc, quant=True, levels=256):
        if "args" not in store:
            store["args"] = (bins, gh, slot.clone(), S, Bc, levels)
        return orig(bins, gh, slot, S, Bc, quant=quant, levels=levels)
    rounds.hist_nat_slots = recording
    try:
        yield
    finally:
        rounds.hist_nat_slots = orig


def nat_shape(torch, hist, args, name):
    """hist_nat's integer mode on one root call's arguments: bitwise
    against the plain version and across two launches, its times, the
    plain version's and bincount's, the bound, and the in-bag rows."""
    bins, gh, slot, S, Bc, levels = args
    run = lambda: hist.hist_nat_slots(bins, gh, slot, S, Bc, levels=levels)
    plain = lambda: hist.hist_nat_slots_plain(bins, gh, slot, S, Bc)
    res = f32_compare(torch, run, plain, name,
                      "exact (integer sums on both sides)")
    Gk, n = bins.shape
    rows = int((gh[2] != 0).sum())
    b, bb = bound(n * (4 * Gk + 3 * gh.element_size() + 4)
                  + S * 3 * Gk * Bc * 4, rows * Gk * 3)
    return dict(shape=f"bins ({Gk},{n}) S={S} Bc={Bc}, {rows} rows in the "
                f"bag", in_bag_rows=rows, **res,
                plain_ms=cuda_ms(plain, reps=5),
                library_ms=bincount_ms(torch, bins, gh, slot, S, Bc),
                bound_ms=b, bound_by=bb, **kernel_numbers(run))


def emit_kernel(name, d) -> None:
    emit({"phase": "kernel", "name": name, "kernel_ms": d["ms"],
          **{k: v for k, v in d.items() if k != "ms"}})


def flat_key(torch, bins, gh, slot, num_slots, num_bins):
    """The flat (slot, channel, column, bin) key of every (row, channel,
    column) and its f64 weight: the inputs of the one torch.bincount
    that computes the same histograms (rows outside the slots go to the
    last key)."""
    dev = bins.device
    Gk, n = bins.shape
    s = slot.to(torch.int64)[None, None, :]
    c = torch.arange(3, device=dev)[:, None, None]
    g = torch.arange(Gk, device=dev)[None, :, None]
    size = num_slots * 3 * Gk * num_bins
    key = torch.where((s >= 0) & (s < num_slots),
                      ((s * 3 + c) * Gk + g) * num_bins
                      + bins.to(torch.int64)[None], size).reshape(-1)
    w = gh.to(torch.float64)[:, None, :].expand(3, Gk, n).reshape(-1)
    return key, w, size


def bincount_ms(torch, bins, gh, slot, num_slots, num_bins=BC) -> float:
    """One torch.bincount over the flat (slot, channel, column, bin) key,
    weighted by the channel values: the library call that computes the
    same histograms (key construction not timed)."""
    key, w, size = flat_key(torch, bins, gh, slot, num_slots, num_bins)
    ms = cuda_ms(lambda: torch.bincount(key, weights=w, minlength=size + 1),
                 reps=5)
    del key, w
    return ms


def f32_compare(torch, run, plain, name,
                tolerance="exact (int64 fixed point on both sides)"):
    """Kernel against plain on the same tensors, and two kernel launches
    against each other: both bitwise (the fixed-point f32 sums, the
    integer sums)."""
    a, b, p = run(), run(), plain()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name} is not bitwise equal across launches")
    err = (a.double() - p.double()).abs()
    rel = float((err / p.double().abs().clamp_min(1e-30)).max())
    if not torch.equal(a, p):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs {float(err.max())}")
    return dict(tolerance=tolerance, max_abs_err=float(err.max()),
                max_rel_err=rel, bitwise_repeat=True)


def f32_kernel_lines(torch, hist, ch, bins, gen, pleaf, params):
    """hist (the root and one N/2 segment) and hist_round's f32 mode at
    the f32 paths' shapes, on f32 channels like a first tree's."""
    dev = bins.device
    g = torch.randn(N_ROWS, generator=gen)
    h = torch.rand(N_ROWS, generator=gen) * 0.25
    cnt = torch.ones(N_ROWS)
    for v in (g, h, cnt):
        v[-1472:] = 0.0
    gh = torch.stack([g, h, cnt]).to(dev)
    lines = {}
    # ---- hist: the root (all rows) and an N/2 segment whose bounds live
    # on the device, as the sequential grower's smaller child
    b0, c0 = N_ROWS // 4, N_ROWS // 2
    bd = torch.tensor(b0, device=dev)
    cd = torch.tensor(c0, device=dev)
    root_run = lambda: hist.histogram(bins, gh, BC)
    seg_run = lambda: hist.histogram(bins, gh, BC, bd, cd, cap=c0)
    root = f32_compare(torch, root_run,
                       lambda: hist.histogram_plain(bins, gh, BC), "hist")
    seg = f32_compare(
        torch, seg_run,
        lambda: hist.histogram_plain(bins, gh, BC, b0, c0, c0), "hist(seg)")
    zero = torch.zeros(N_ROWS, dtype=torch.int32, device=dev)
    rows = int((gh[2] != 0).sum())
    b, bb = bound(N_ROWS * 4 * (G + 3) + 3 * G * BC * 4, rows * G * 3)
    sb, sbb = bound(c0 * 4 * (G + 3) + 3 * G * BC * 4, c0 * G * 3)
    lines["hist"] = dict(
        shape=f"bins ({G},{N_ROWS}) all rows, Bc={BC}; seg: {c0} rows",
        **root,
        plain_ms=cuda_ms(lambda: hist.histogram_plain(bins, gh, BC), reps=5),
        library_ms=bincount_ms(torch, bins, gh, zero, 1),
        bound_ms=b, bound_by=bb, **kernel_numbers(root_run),
        seg=dict(**seg,
                 plain_ms=cuda_ms(lambda: hist.histogram_plain(
                     bins, gh, BC, b0, c0, c0), reps=5),
                 library_ms=bincount_ms(torch, bins[:, b0:b0 + c0],
                                        gh[:, b0:b0 + c0], zero[:c0], 1),
                 bound_ms=sb, bound_by=sbb, **kernel_numbers(seg_run)))
    # ---- hist_round, f32 mode: one full-width f32 round (S = 25)
    prm = params[:S_ROUND_F32].clone()
    prm[-1, 0] = -1  # one unused slot
    lines["hist_round_f32"] = round_shape(
        torch, hist, ch, (bins, gh, pleaf, prm, S_ROUND_F32, BC, L, None,
                          None), "hist_round_f32")
    return lines


def int8_kernel_lines(torch, hist, ch, bins, gen, pleaf, params):
    """hist_nat (the root, S = 1) and hist_round (S = 48) in their int8
    mode, on the levels of a use_quantized_grad tree at 4 levels
    (gradient in [-2, 2], hessian in [0, 4])."""
    dev = bins.device
    gq = torch.randint(-2, 3, (N_ROWS,), generator=gen)
    hq = torch.randint(0, 5, (N_ROWS,), generator=gen)
    cnt = torch.ones(N_ROWS, dtype=torch.int64)
    for v in (gq, hq, cnt):
        v[-1472:] = 0
    gh = hist.build_gh8_quant(gq, hq, cnt, int8_levels=4).to(dev)
    if gh.dtype != torch.int8:
        raise AssertionError(f"4-level channels built as {gh.dtype}")
    exact = "exact (integer sums on both sides)"
    lines = {}
    slot0 = torch.zeros(N_ROWS, dtype=torch.int32, device=dev)
    run = lambda: hist.hist_nat_slots(bins, gh, slot0, 1, BC, levels=4)
    plain = lambda: hist.hist_nat_slots_plain(bins, gh, slot0, 1, BC)
    res = f32_compare(torch, run, plain, "hist_nat_int8", exact)
    rows = int((gh[2] != 0).sum())
    b, bb = bound(N_ROWS * (4 * G + 4 + 3) + 3 * G * BC * 4, rows * G * 3)
    lines["hist_nat_int8"] = dict(
        shape=f"bins ({G},{N_ROWS}) S=1 Bc={BC}, int8 levels", **res,
        plain_ms=cuda_ms(plain, reps=5),
        library_ms=bincount_ms(torch, bins, gh, slot0, 1),
        bound_ms=b, bound_by=bb, **kernel_numbers(run))
    lines["hist_round_int8"] = round_shape(
        torch, hist, ch, (bins, gh, pleaf, params, S_ROUND, BC, L, None, 4),
        "hist_round_int8")
    lines["hist_round_int8"]["shape"] += ", int8 levels"
    return lines


def hist_nat_f32_line(torch, hist, ch, captured):
    """hist_nat's f32 mode on the arguments of the first and the fourth
    (last) refit pass of a real tree of each refit path (captured[path]:
    train_l1 at 255 leaves, train_l1_31 at 31): one column of residual
    bins, one slot per leaf, the rows outside every bracket in the
    trash slot; in the late pass few rows remain, in few bins. Per pass:
    bitwise against the plain version and across launches, the kernel
    and bincount in turns. train_l1_31's pass 1 is also timed at the
    start of the line, before the other passes (`timed_first`: two
    device-ms readings), beside its reading in place; both follow the
    same phases of the script, a few milliseconds apart."""
    bins, gh, slot, S, Bc = captured["train_l1_31"]["passes"][0]["args"]
    first = [device_ms(lambda: hist.hist_nat_slots(
        bins, gh, slot, S, Bc, quant=False))[0] for _ in range(2)]
    passes = {}
    for path, cap in captured.items():
        for i, p in ((0, 1), (1, 4)):
            bins, gh, slot, S, Bc = cap["passes"][i]["args"]
            rows = cap["passes"][i]["rows"]
            run = lambda: hist.hist_nat_slots(bins, gh, slot, S, Bc,
                                              quant=False)
            plain = lambda: hist.hist_nat_slots_plain(bins, gh, slot, S, Bc,
                                                      quant=False)
            name = f"{path} pass{p}"
            res = f32_compare(torch, run, plain, f"hist_nat_f32 {name}")
            Gk, n = bins.shape
            # the scale reads every row's channels, the histogram the
            # slots and the in-slot rows' bins
            b, bb = bound(n * 16 + rows * 4 * Gk + S * 3 * Gk * Bc * 4,
                          rows * Gk * 3)
            key, w, size = flat_key(torch, bins, gh, slot, S, Bc)
            passes[name] = dict(
                shape=f"bins ({Gk},{n}) S={S} Bc={Bc}, {rows} rows in a "
                f"slot", **res,
                **in_turns(run, lambda: torch.bincount(
                    key, weights=w, minlength=size + 1)),
                plain_ms=cuda_ms(plain, reps=5), bound_ms=b, bound_by=bb)
            del key, w
    passes["train_l1_31 pass1"]["timed_first"] = first
    p1 = passes["train_l1 pass1"]
    return dict(shape=p1["shape"] + " (train_l1 pass 1; the others in "
                "passes)",
                **{k: p1[k] for k in (
                    "tolerance", "max_abs_err", "max_rel_err",
                    "bitwise_repeat", "ms", "device_ms", "host_us",
                    "plain_ms", "library_ms", "library_device_ms",
                    "bound_ms", "bound_by")},
                passes=passes)


@contextlib.contextmanager
def recording_takes(ch, store, heights):
    """While active, keep the arguments of the take_small call with the
    most rows per table height k in `heights` (store[k] = (tab, idx))."""
    orig = ch.take_small

    def recording(tab, idx):
        k = tab.shape[0]
        if k in heights and (k not in store
                             or idx.shape[0] > store[k][1].shape[0]):
            store[k] = (tab.clone(), idx.clone())
        return orig(tab, idx)
    ch.take_small = recording
    try:
        yield
    finally:
        ch.take_small = orig


def take_small_line(torch, hist, captured, synth):
    """take_small on arguments captured from the training paths: train's
    validation traversal (k = 8, a depth level of its first tree),
    train's score update of the training rows (k = 1) and train_l1's
    refit (k = 2). Each bitwise against the plain version and across two
    launches, in turns with index_select; the traversal is the line's
    headline (10 launches a tree). synth: the 1M-row k = 8 and k = 1
    numbers of earlier runs, for comparison."""
    shapes = {}
    for name, k in (("traversal_k8", 8), ("score_k1", 1), ("refit_k2", 2)):
        tab, idx = captured[k]
        run = lambda: hist.take_cols(tab, idx)
        a, b, p = run(), run(), hist.take_cols_plain(tab, idx)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, p)):
            raise AssertionError(f"take_small {name} disagrees with its "
                                 "plain version or across launches")
        kk, L = tab.shape
        n = idx.shape[0]
        safe = idx.clamp(0, L - 1).long()
        bb, by = bound(n * 4 + kk * L * 4 + kk * n * 4, 0)
        shapes[name] = dict(
            shape=f"tab ({kk},{L}) idx ({n},)",
            max_abs_err=float((a - p).abs().max()),
            **in_turns(run, lambda: torch.index_select(tab, 1, safe)),
            plain_ms=cuda_ms(lambda: hist.take_cols_plain(tab, idx)),
            bound_ms=bb, bound_by=by)
    head = shapes["traversal_k8"]
    return dict(shape="traversal k=8 " + head["shape"]
                + " (score_k1 and refit_k2 in shapes)",
                tolerance="exact", bitwise_repeat=True,
                max_abs_err=max(d["max_abs_err"] for d in shapes.values()),
                **{k: head[k] for k in (
                    "ms", "device_ms", "host_us", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "bound_by")},
                shapes=shapes, synthetic_1M=synth)


def hist_slots_line(torch, hist, captured):
    """hist_slots on the arguments of the fullest round of a real
    train_exact_rounds tree (the leaf-grouped matrix and its segments)."""
    bins, gh, begins, counts, Bc, S = captured["args"]
    res = f32_compare(
        torch, lambda: hist.hist_slots(bins, gh, begins, counts, Bc, S),
        lambda: hist.hist_slots_plain(bins, gh, begins, counts, Bc, S),
        "hist_slots")
    slot = hist.segment_slots(begins, counts, bins.shape[1])
    rows = int((slot < S).sum())
    b, bb = bound(rows * 4 * (bins.shape[0] + 3) + S * 8
                  + S * 3 * bins.shape[0] * Bc * 4, rows * bins.shape[0] * 3)
    run = lambda: hist.hist_slots(bins, gh, begins, counts, Bc, S)
    return dict(
        shape=(f"bins ({bins.shape[0]},{bins.shape[1]}) S={S} Bc={Bc}, "
               f"{captured['n']} segments, {rows} rows"), **res,
        plain_ms=cuda_ms(lambda: hist.hist_slots_plain(
            bins, gh, begins, counts, Bc, S), reps=5),
        library_ms=bincount_ms(torch, bins, gh, slot, S, Bc),
        bound_ms=b, bound_by=bb, **kernel_numbers(run))


def seg_bound(rows, G_, Bc, S=1, scale_rows=0):
    """The least time of one hist / hist_slots call (bound): each row of
    the segments read once (G bins and 3 channels), the scale's other
    rows' channels, the (S, 3, G, Bc) f32 output written once; 3 adds a
    row and column."""
    return bound(rows * 4 * (G_ + 3) + scale_rows * 12 + S * 3 * G_ * Bc * 4,
                 rows * G_ * 3)


def replay_numbers(torch, run, plain, name):
    """A replay of a tree's calls (run, plain: lists of outputs): every
    call bitwise against the plain version and across two replays, and
    the replay's device time (CUDA events around the whole replay,
    enqueued behind a spin of the card) and host time."""
    a, b, p = run(), run(), plain()
    torch.cuda.synchronize()
    bad = [i for i, (x, y, z) in enumerate(zip(a, b, p))
           if not (torch.equal(x, y) and torch.equal(x, z))]
    if bad or len(a) != len(p):
        raise AssertionError(f"{name}: calls {bad[:10]} disagree with the "
                             "plain version or across replays")
    dev, how = device_ms(run, calls=1)
    if how != EVENTS_TIME:
        raise AssertionError(f"{name}: the host could not enqueue the "
                             "replay ahead of the card")
    return dict(tolerance="exact (int64 fixed point on both sides)",
                max_abs_err=0.0, bitwise_repeat=True, calls_bitwise=len(a),
                device_ms=dev, device_time=EVENTS_TIME,
                host_ms=host_us(run, reps=5) / 1e3)


def hist_tree_line(torch, hist, store):
    """Every hist call of one train_exact tree (recorded with its device
    bounds at call time), replayed on the tree's final leaf-grouped
    matrix: each call bitwise against histogram_plain, the replay's
    summed device time beside the summed bound, the calls and their
    segment sizes."""
    from lightgbm_tpu_torch.tools.hist_tiling import (
        replay_hist, segment_rows, size_histogram)

    rows = segment_rows(store)
    Gk, n = store["bins"].shape
    run = lambda: replay_hist(store)
    d = replay_numbers(torch, run,
                       lambda: replay_hist(store, hist.histogram_plain),
                       "hist_tree")
    return dict(
        shape=(f"{len(rows)} hist calls of one train_exact tree on its "
               f"final leaf-grouped matrix ({Gk},{n}), Bc={store['Bc']}"),
        calls=len(rows), rows=sum(rows), sizes=size_histogram(rows), **d,
        bound_ms=sum(seg_bound(r, Gk, store["Bc"])[0] for r in rows),
        bound_by="sum over the calls of each call's bound")


def hist_slots_tree_line(torch, hist, store):
    """Every hist_slots call (round) of one train_exact_rounds tree,
    replayed on the tree's final leaf-grouped matrix, as hist_tree_line."""
    from lightgbm_tpu_torch.tools.hist_tiling import replay_slots

    Gk, n = store["bins"].shape
    Bc = store["Bc"]
    rows = [int(co.clamp_min(0).sum()) for _, co, _ in store["slots"]]
    used = [int((co > 0).sum()) for _, co, _ in store["slots"]]
    run = lambda: replay_slots(store)
    d = replay_numbers(torch, run,
                       lambda: replay_slots(store, hist.hist_slots_plain),
                       "hist_slots_tree")
    return dict(
        shape=(f"{len(rows)} hist_slots calls of one train_exact_rounds "
               f"tree on its final leaf-grouped matrix ({Gk},{n}), "
               f"Bc={Bc}, S={store['slots'][0][2]}"),
        calls=len(rows), rows_per_call=rows, used_slots_per_call=used, **d,
        bound_ms=sum(seg_bound(r, Gk, Bc, S, n - r)[0]
                     for r, (_, _, S) in zip(rows, store["slots"])),
        bound_by="sum over the calls of each call's bound")


def higgs_stream(rows: int, feats: int = 28):
    """bench.py:386-395: RandomState(17) features and the label before
    bench.py:390 thresholds it (logits plus noise, float32), with the
    held-out validation rows drawn the same way."""
    import numpy as np

    rs = np.random.RandomState(17)
    X = rs.randn(rows, feats).astype(np.float32)
    w = rs.randn(feats)
    logits = X[:, : feats // 2] @ w[: feats // 2] + np.sin(X[:, feats // 2]) * 2.0
    z = (logits + rs.randn(rows)).astype(np.float32)
    nv = min(rows // 10, 100_000)
    Xv = rs.randn(nv, feats).astype(np.float32)
    lv = Xv[:, : feats // 2] @ w[: feats // 2] + np.sin(Xv[:, feats // 2]) * 2.0
    zv = (lv + rs.randn(nv)).astype(np.float32)
    return X, z, Xv, zv


def higgs_like(rows: int, feats: int = 28):
    """bench.py:386-395: the binary label y = (logits + noise > 0)."""
    import numpy as np

    X, z, Xv, zv = higgs_stream(rows, feats)
    return X, (z > 0).astype(np.float32), Xv, (zv > 0).astype(np.float32)


# the airline departure-delay schema (szilard/benchm-ml, dep_delayed_15min):
# code columns (name, categories, Zipf-like frequencies) and the numerical
# DepTime (hhmm) and Distance; Origin and Dest cut to their 250 busiest
# airports, so every category keeps its own bin at max_bin=255
AIRLINE_CODES = (("Month", 12, False), ("DayofMonth", 31, False),
                 ("DayOfWeek", 7, False), ("UniqueCarrier", 22, True),
                 ("Origin", 250, True), ("Dest", 250, True))
AIRLINE_COLUMNS = ("Month", "DayofMonth", "DayOfWeek", "DepTime", "Distance",
                   "UniqueCarrier", "Origin", "Dest")
AIRLINE_CATEGORICAL = [0, 1, 2, 5, 6, 7]


def airline_like(rows: int, valid_rows: int, seed: int = 23,
                 extra_3cat: bool = False):
    """Synthetic rows with the airline schema, from one RandomState: the
    calendar codes uniform, carriers and airports with p ~ 1/rank; the
    label is 1 when a logit (per-category N(0, 0.5) effects of carrier,
    origin, dest, month and day of week, a smooth DepTime effect,
    logistic noise) exceeds its 81st percentile (~19% delayed). With
    extra_3cat a 3-category column (its own effect) is appended, so the
    one-vs-rest search runs beside the sorted-subset one."""
    import numpy as np

    rs = np.random.RandomState(seed)
    n = rows + valid_rows
    codes, effects = {}, {}
    for name, k, zipf in AIRLINE_CODES:
        p = 1.0 / np.arange(1, k + 1) if zipf else np.ones(k)
        codes[name] = rs.choice(k, n, p=p / p.sum())
        effects[name] = rs.normal(0.0, 0.5, k)
    minutes = np.clip(rs.normal(13.5 * 60, 4.5 * 60, n), 0, 1439).astype(int)
    dep = (minutes // 60) * 100 + minutes % 60
    dist = np.clip(rs.lognormal(6.4, 0.6, n), 30, 4980).round()
    logit = sum(effects[c][codes[c]] for c in
                ("UniqueCarrier", "Origin", "Dest", "Month", "DayOfWeek"))
    logit = logit + 0.9 * np.tanh((minutes - 13 * 60) / 240.0)
    cols = [codes["Month"] + 1, codes["DayofMonth"] + 1,
            codes["DayOfWeek"] + 1, dep, dist, codes["UniqueCarrier"],
            codes["Origin"], codes["Dest"]]
    if extra_3cat:
        c3 = rs.randint(0, 3, n)
        logit = logit + np.array([-0.6, 0.1, 0.5])[c3]
        cols.append(c3)
    z = logit + rs.logistic(size=n)
    y = (z > np.quantile(z, 0.81)).astype(np.float32)
    X = np.column_stack(cols).astype(np.float32)
    return X[:rows], y[:rows], X[rows:], y[rows:]


# trees of small's card-against-CPU runs (5 until the distributed phase
# came, 3 until ops_processes; the early stopping and replay runs keep
# theirs)
SMALL_TREES = 2


def small_phase(lgb, np):
    """Small runs on the card against the same runs on the CPU: the
    default path, the exact path, use_quantized_grad (int8 modes),
    regression_l1 (the percentile refit), DART (dropping more often than
    its defaults), RF and every per-node extra on together, categorical
    runs on the int16,
    use_quantized_grad (as bench.py sets it, and without stochastic
    rounding and leaf renewal) and bf16x2 paths, and the sampled runs
    (sampled_runs); the first categorical use_quantized_grad run and the
    binary GOSS run are held by replay_check instead."""
    X, z, Xv, zv = higgs_stream(20_000, 8)
    y = (z > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
              "min_data_in_leaf": 20}
    errs = {}
    for path, extra, label in (
            ("default", {}, y),
            ("exact", {"tpu_growth_mode": "exact"}, y),
            ("quant", QUANT_PARAMS, y),
            ("l1", {"objective": "regression_l1"}, z),
            ("dart", dict(DART_PARAMS, drop_rate=0.3, skip_drop=0.2), y),
            ("rf", RF_PARAMS, y),
            ("extras", extras_params(X.shape[1]), y),
            ("mono_intermediate", mono_params(
                X.shape[1], "intermediate", mono_directions(np, X, y)), y),
            ("mono_advanced", mono_params(
                X.shape[1], "advanced", mono_directions(np, X, y)), y),
            ("linear", {"linear_tree": True, "linear_lambda": 0.1}, y)):
        preds = {}
        for device in ("cuda", "cpu"):
            p = dict(params, device_type=device, **extra)
            bst = lgb.train(p, lgb.Dataset(X, label=label, params=p),
                            SMALL_TREES)
            preds[device] = bst.predict(Xv, raw_score=True)
        errs[path] = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    # categorical: the airline schema plus a 3-category column
    Xc, yc, Xcv, _ = airline_like(20_000, 2_000, seed=29, extra_3cat=True)
    cat_cols = AIRLINE_CATEGORICAL + [Xc.shape[1] - 1]
    for path, extra in (("cat_int16", {}), ("cat_quant", QUANT_PARAMS),
                        ("cat_quant_det", dict(
                            QUANT_PARAMS, stochastic_rounding=False,
                            quant_train_renew_leaf=False)),
                        ("cat_bf16x2", {"tpu_hist_dtype": "bf16x2"})):
        preds = {}
        for device in ("cuda", "cpu"):
            p = dict(params, device_type=device, **extra)
            ds = lgb.Dataset(Xc, label=yc, categorical_feature=cat_cols,
                             params=p)
            bst = lgb.train(p, ds, SMALL_TREES)
            preds[device] = bst.predict(Xcv, raw_score=True)
            if not any(int(t.num_cat) > 0 for t in bst._gbdt.models):
                raise AssertionError(f"small {path}: no categorical split")
        errs[path] = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    # cat_quant is held by replay instead (ROADMAP C): its 4 levels make
    # exact ties between different splits common, and last-ulp
    # differences decide them: the card's sigmoid moves the level scale,
    # the leaf renewal's seg_sum sums in fixed point where the CPU sums
    # in f32.
    # cat_quant_det (deterministic rounding, no renewal) runs the same
    # categorical int8 path and is held at the tolerance
    replay = replay_check(lgb, dict(params, **QUANT_PARAMS), Xc, yc,
                          cat_cols)
    sampled, goss_binary = sampled_runs(lgb, np, params, X, z, Xv, zv)
    errs.update(sampled)
    held = {k: v for k, v in errs.items() if k != "cat_quant"}
    emit({"phase": "small", "rows": 20000, "trees": SMALL_TREES,
          "max_abs_pred_diff_card_vs_cpu": errs, "tolerance": 1e-4,
          "held": sorted(held), "cat_quant_replay": replay,
          "goss_binary": goss_binary})
    if not all(e < 1e-4 for e in held.values()):
        raise AssertionError(f"card and CPU runs disagree: {errs}")


def sampled_runs(lgb, np, params, X, z, Xv, zv):
    """The sampled options at 20k rows, each on the card and on the CPU
    (predictions compared by the caller at 1e-4): bagging on the int16
    rounds path, pos / neg bagging, use_quantized_grad with bagging,
    regression_l1 with bagging (the refit's hist_nat f32 mode on w *
    mask), exact with bagging (hist), exact + tpu_growth_rounds with GOSS
    on regression (hist_slots), GOSS on regression (lr 0.5: sampling from
    tree 3), feature_fraction 0.5, early stopping that fires (the same
    best_iteration and tree count on both), multiclassova and
    cross_entropy. Binary GOSS is held on the card alone: its AUC rises
    and every fused round and split search replays on the CPU bit for bit
    (replay_check); card against CPU its sigmoid's last ulp moves rows
    across GOSS's threshold (ROADMAP C)."""
    y, yv = (z > 0).astype(np.float32), (zv > 0).astype(np.float32)
    cls = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    prob = (1.0 / (1.0 + np.exp(-z / 2.0))).astype(np.float32)
    bag = {"bagging_fraction": 0.8, "bagging_freq": 1}
    goss = dict(GOSS_PARAMS, learning_rate=0.5)
    l2 = {"objective": "regression"}
    runs = (("bag_int16", bag, y), ("bag_pos_neg", {
                "pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.8,
                "bagging_freq": 1}, y),
            ("bag_quant", dict(QUANT_PARAMS, **bag), y),
            ("bag_l1", dict(bag, objective="regression_l1"), z),
            ("bag_exact", dict(bag, tpu_growth_mode="exact"), y),
            ("goss_exact_rounds", dict(goss, tpu_growth_mode="exact",
                                       tpu_growth_rounds=True, **l2), z),
            ("goss_l2", dict(goss, **l2), z),
            ("feature_fraction", {"feature_fraction": 0.5}, y),
            ("multiclassova", {"objective": "multiclassova",
                               "num_class": 3}, cls),
            ("cross_entropy", {"objective": "cross_entropy"}, prob))
    errs = {}
    for name, extra, label in runs:
        preds = {}
        for device in ("cuda", "cpu"):
            p = dict(params, device_type=device, **extra)
            bst = lgb.train(p, lgb.Dataset(X, label=label, params=p),
                            SMALL_TREES)
            preds[device] = bst.predict(Xv, raw_score=True)
        errs[name] = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    # early stopping that fires: at 63 leaves and lr 1 the validation
    # logloss is best after tree 3, and 6e-3 worse after trees 4 and 5
    es = {}
    for run, device, cbs in (("cuda", "cuda", []), ("cpu", "cpu", []),
                             ("cuda_eager", "cuda", [_eager])):
        p = dict(params, device_type=device, learning_rate=1.0,
                 num_leaves=63, metric="binary_logloss",
                 early_stopping_round=2)
        ds = lgb.Dataset(X, label=y, params=p)
        bst = lgb.train(p, ds, 30, valid_sets=[lgb.Dataset(
            Xv, label=yv, reference=ds)], callbacks=cbs)
        es[run] = (bst.best_iteration, bst.num_trees(),
                   bst.predict(Xv, raw_score=True), bst.model_to_string())
    # the fused loop (the default) on both devices, and the eager loop on
    # the card: the same stop, and fused == eager on the card bit for bit
    if (es["cuda"][:2] != es["cpu"][:2] or es["cuda"][1] >= 30
            or es["cuda"][:2] != es["cuda_eager"][:2]
            or es["cuda"][3] != es["cuda_eager"][3]):
        raise AssertionError(f"early stopping: card (best_iteration, "
                             f"trees) {es['cuda'][:2]}, CPU {es['cpu'][:2]}, "
                             f"card eager {es['cuda_eager'][:2]}")
    errs["early_stopping"] = float(np.abs(es["cuda"][2] - es["cpu"][2]).max())
    goss_binary = replay_check(lgb, dict(params, **goss), X, y, None,
                               n_trees=5, valid=(Xv, yv))
    goss_binary["early_stopping_best_iteration"] = es["cuda"][0]
    auc = goss_binary["auc"]
    if not auc[-1] > auc[2]:
        raise AssertionError(f"binary GOSS: AUC did not rise over the "
                             f"sampled trees: {auc}")
    return errs, goss_binary


def _to_cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to_cpu(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _bitwise(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))


def replay_check(lgb, params, X, y, cat_cols, n_trees: int = 2,
                 valid=None):
    """Train n_trees on the card; replay every fused round (hist_round)
    and every batched split search (best_split) of the rounds grower on
    the CPU from the call's own inputs, and require the card's outputs
    bit for bit. With valid = (X, y), also the validation AUC after each
    tree."""
    from lightgbm_tpu_torch.learner import rounds

    orig = {"hist_round": rounds.hist_round, "best_split": rounds.best_split}
    calls = {k: 0 for k in orig}

    def replaying(name):
        fn = orig[name]

        def call(*a, **k):
            out = fn(*a, **k)
            ref = fn(*_to_cpu(a), **_to_cpu(k))
            if not _bitwise(tuple(out), tuple(ref)):
                raise AssertionError(f"{name} call {calls[name]}: the card "
                                     "and its CPU replay disagree")
            calls[name] += 1
            return out
        return call

    for name in orig:
        setattr(rounds, name, replaying(name))
    ev = {}
    try:
        p = dict(params, device_type="cuda")
        ds = lgb.Dataset(X, label=y, categorical_feature=cat_cols or "auto",
                         params=p)
        # the eager loop: a graph capture would record these calls'
        # inputs before they are computed
        if valid is None:
            lgb.train(p, ds, n_trees, callbacks=[_eager])
        else:
            p["metric"] = "auc"
            lgb.train(p, ds, n_trees, valid_sets=[lgb.Dataset(
                valid[0], label=valid[1], reference=ds)],
                valid_names=["v"], evals_result=ev, callbacks=[_eager])
    finally:
        for name, fn in orig.items():
            setattr(rounds, name, fn)
    if not all(calls.values()):
        raise AssertionError(f"replay saw no calls: {calls}")
    out = {"trees": n_trees, "calls_bitwise": calls}
    if ev:
        out["auc"] = ev["v"]["auc"]
    return out


def profile_phase(torch, bst, n_trees: int = 2, name: str = "profile",
                  cpu: bool = True):
    """Where a tree's time goes: torch.profiler over n_trees more trees
    (CUPTI kernel times), the device's busy share of the wall time, and
    the kernels that take the most device time. Only the CUDA rows are
    read; ``cpu=False`` records no CPU activity (an exact tree's ~100,000
    host ops made its profile take ~60 s)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_trees):
            bst.update()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0:
            rows.append((e.key[:80], us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    out = {"phase": name, "trees": n_trees,
          "wall_ms_per_tree": wall_ms / n_trees,
          "device_ms_per_tree": device_ms / n_trees,
          "device_busy_share": device_ms / wall_ms,
          "kernel_launches_per_tree": sum(r[2] for r in rows) / n_trees,
           "top_ms_per_tree": [[k, ms / n_trees, c / n_trees]
                               for k, ms, c in rows[:12]]}
    emit(out)
    return out


def train_f32_path(torch, lgb, ch, perm, ds, vs, name, n_timed=2,
                   capture=None, rounds_cap=None, seg_calls=None):
    """One f32 path on the headline workload: 1 warmup tree, n_timed
    timed trees, AUC after the first and the last tree, launches, a
    1-tree profile. With `capture`, the warmup tree also records the
    fullest hist_slots call's arguments (for its kernel line); with
    `rounds_cap`, its first and fullest hist_round calls'
    (recording_rounds); with `seg_calls`, every hist and hist_slots call
    (hist_tiling.recording_seg_calls, for the hist_tree and
    hist_slots_tree lines)."""
    from lightgbm_tpu_torch.tools.hist_tiling import recording_seg_calls

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **F32_PATHS[name]}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    orig = perm.hist_slots
    if capture is not None:
        def recording(bins, gh, begins, counts, Bc, S):
            out = orig(bins, gh, begins, counts, Bc, S)
            n = int((counts > 0).sum())
            if n > capture.get("n", -1):
                capture.update(n=n, args=(bins, gh, begins.clone(),
                                          counts.clone(), Bc, S))
            return out
        perm.hist_slots = recording
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    try:
        with (recording_rounds(rounds_cap) if rounds_cap is not None
              else contextlib.nullcontext()), \
                (recording_seg_calls(seg_calls) if seg_calls is not None
                 else contextlib.nullcontext()):
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
    finally:
        perm.hist_slots = orig
    auc1 = bst.eval_valid()[0][2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    auc_last = bst.eval_valid()[0][2]
    gb = bst._gbdt
    splits = [int(a.num_nodes) for a in gb.device_trees[-n_timed:]]
    # the trees' arrays are on the card: read them after the timing
    line = {"phase": name, **F32_PATHS[name], "rows": gb.train_set.num_data,
            "num_leaves": L, "hist_dtype": gb.hist_dtype,
            "rounds_slots": gb.spec.rounds_slots, "warmup_trees": 1,
            "warmup_s": warm_s, "timed_trees": n_timed,
            "trees_per_s": n_timed / dt, "ms_per_split":
            dt * 1e3 / max(sum(splits), 1), "splits_per_tree": splits,
            "auc_tree1": auc1, "auc_last": auc_last,
            "launches": launches,
            "launches_per_tree": {k: v / (1 + n_timed)
                                  for k, v in launches.items() if v}}
    emit(line)
    missing = [k for k in F32_NEEDS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: {missing} not launched: {launches}")
    if not (auc_last > auc1 and auc_last > 0.85):
        raise AssertionError(f"{name}: AUC did not improve: {auc1} -> "
                             f"{auc_last}")
    # the exact paths' host ops: CUDA activity alone (the profile of one
    # train_exact tree took 64.7 s with the CPU's)
    prof = profile_phase(torch, bst, 1, name + "_profile",
                         cpu=not name.startswith("train_exact"))
    return launches, prof


def train_int_path(torch, lgb, ch, ds, vs, name, extra, n_warm, n_timed,
                   needs, capture=None, takes=None, rounds_cap=None):
    """An integer-level rounds path on the headline workload: n_warm
    warmup trees, n_timed timed trees, the validation metric after the
    first and the last tree, launches, peak device memory and a 1-tree
    profile. With `capture`, the first tree also records the arguments
    of the refit's first and last hist_nat_slots calls (for the
    hist_nat_f32 line); with `takes`, those of its widest k = 2
    take_small call (the refit's, for the take_small line); with
    `rounds_cap`, those of its first and fullest hist_round calls
    (recording_rounds)."""
    from lightgbm_tpu_torch.learner import renewal

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **extra}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    orig = renewal.hist_nat_slots
    if capture is not None:
        def recording(bins, gh, slot, S, Bc, quant=True):
            out = orig(bins, gh, slot, S, Bc, quant=quant)
            # the first pass and the latest (the fourth once the tree is
            # done); bins and gh are new tensors every pass
            passes = capture.setdefault("passes", [])
            del passes[1:]
            passes.append(dict(rows=int((slot < S).sum()),
                               args=(bins, gh, slot.clone(), S, Bc)))
            capture["n"] = capture.get("n", 0) + 1
            return out
        renewal.hist_nat_slots = recording
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    try:
        with (recording_takes(ch, takes, (2,)) if takes is not None
              else contextlib.nullcontext()), \
                (recording_rounds(rounds_cap) if rounds_cap is not None
                 else contextlib.nullcontext()):
            bst.update()
    finally:
        renewal.hist_nat_slots = orig
    metric, m1 = bst.eval_valid()[0][1:3]
    for _ in range(n_warm - 1):
        bst.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    m_last = bst.eval_valid()[0][2]
    gb = bst._gbdt
    trees = n_warm + n_timed
    line = {"phase": name, **extra, "rows": gb.train_set.num_data,
            "num_leaves": params["num_leaves"], "hist_dtype": gb.hist_dtype,
            "rounds_slots": gb.spec.rounds_slots, "warmup_trees": n_warm,
            "timed_trees": n_timed, "trees_per_s": n_timed / dt,
            "metric": metric, "metric_tree1": m1, "metric_last": m_last,
            "trees": trees, "launches": launches,
            "launches_per_tree": {k: v / trees
                                  for k, v in launches.items() if v},
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit(line)
    missing = [k for k in needs if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: {missing} not launched: {launches}")
    prof = profile_phase(torch, bst, 1, name + "_profile")
    return line, prof


def train_cat_path(torch, lgb, ch, np, n_warm: int = 2, n_timed: int = 10,
                   capture=None):
    """Categorical splits at full width: the airline-schema dataset (1M
    training rows, 100k validation rows), six code columns categorical,
    the default int16 rounds path (sorted-subset search, hist_round's
    categorical variant). Fails unless AUC rises, every tree launches
    hist_round_cat and the trees hold categorical splits. With
    `capture`, the first tree also records the arguments of its round
    with the most categorical slots at the widest slot count (for the
    hist_round_cat kernel line)."""
    X, y, Xv, yv = airline_like(1_000_000, 100_000)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, categorical_feature=AIRLINE_CATEGORICAL,
                     feature_name=list(AIRLINE_COLUMNS),
                     free_raw_data=False)
    ds.construct()
    vs = lgb.Dataset(Xv, label=yv, reference=ds, free_raw_data=False)
    t_data = time.perf_counter() - t0
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1}
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    per_tree = []

    def tree():
        before = ch.LAUNCHES["hist_round_cat"]
        bst.update()
        per_tree.append(ch.LAUNCHES["hist_round_cat"] - before)

    # the round with the most categorical slots at the widest slot count
    cat_key = (lambda prm, S, cm: None if cm is None
               else (S, int((prm[:, 10] != 0).sum())))
    with (recording_rounds(capture, cat_key) if capture is not None
          else contextlib.nullcontext()):
        tree()
    auc1 = bst.eval_valid()[0][2]
    for _ in range(n_warm - 1):
        tree()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        tree()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    auc_last = bst.eval_valid()[0][2]
    gb = bst._gbdt
    trees = n_warm + n_timed
    cat_splits = [int(a.node_cat[:int(a.num_nodes)].sum())
                  for a in gb.device_trees]
    line = {"phase": "train_cat", "rows": gb.train_set.num_data,
            "features": len(AIRLINE_COLUMNS),
            "categorical": [AIRLINE_COLUMNS[i] for i in AIRLINE_CATEGORICAL],
            "num_bin": [int(m.num_bin) for m in gb.train_set.mappers],
            "num_leaves": L, "hist_dtype": gb.hist_dtype,
            "cat_subset": gb.spec.cat_subset, "has_cat": gb.spec.has_cat,
            "rounds_slots": gb.spec.rounds_slots,
            "dataset_seconds": t_data, "warmup_trees": n_warm,
            "timed_trees": n_timed, "trees_per_s": n_timed / dt,
            "auc_tree1": auc1, "auc_last": auc_last, "trees": trees,
            "categorical_splits_per_tree": cat_splits,
            "splits_per_tree": [int(a.num_nodes) for a in gb.device_trees],
            "hist_round_cat_per_tree": per_tree, "launches": launches,
            "launches_per_tree": {k: v / trees
                                  for k, v in launches.items() if v},
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit(line)
    if not (gb.spec.has_cat and gb.spec.cat_subset):
        raise AssertionError(f"train_cat: spec {gb.spec}")
    if min(per_tree) < 1:
        raise AssertionError(f"train_cat: a tree did not launch "
                             f"hist_round_cat: {per_tree}")
    if sum(cat_splits) == 0:
        raise AssertionError("train_cat: no categorical split in the trees")
    if not auc_last > auc1:
        raise AssertionError(f"train_cat: AUC did not rise: {auc1} -> "
                             f"{auc_last}")
    prof = profile_phase(torch, bst, 1, "train_cat_profile")
    return line, prof, (ds, vs)


# the fused loop's kernels, by symbol name in the profile of its replays
FUSED_KERNELS = {"hist_round": "round_hist_kernel", "hist_nat": "nat_kernel",
                 "take_small": "take_small_kernel",
                 "seg_sum": "seg_sum_kernel", "hist": "seg_hist_kernel",
                 "hist_nat_f32": "f32_atomic_kernel",
                 "lambdarank": "lambdarank_kernel"}
# the kernels (by their launch counters) each path's graph must hold
FUSED_NEEDS = {
    "train": ("hist_round", "hist_nat", "take_small", "seg_sum"),
    "train_bag": ("hist_round", "hist_nat", "take_small", "seg_sum"),
    "train_goss": ("hist_round", "hist_nat", "take_small", "seg_sum"),
    "train_quant": ("hist_round_int8", "hist_nat_int8", "take_small",
                    "seg_sum"),
    "train_l1": ("hist_round", "hist_nat", "hist_nat_f32", "take_small",
                 "seg_sum"),
    "train_f32": ("hist_round_f32", "hist", "take_small"),
    "train_cat": ("hist_round", "hist_round_cat", "hist_nat", "take_small",
                  "seg_sum"),
    "train_rank": ("hist_round", "hist_nat", "take_small", "seg_sum",
                   "lambdarank"),
    "train_extras": ("hist_round", "hist_nat", "take_small", "seg_sum"),
    "train_forced": ("hist_round", "hist_nat", "take_small", "seg_sum"),
    "train_rank_xendcg": ("hist_round", "hist_nat", "take_small",
                          "seg_sum"),
    # monotone constraints turn the true-gradient leaf renewal off (it
    # would bypass their clamps), so seg_sum does not run there
    "train_mono_intermediate": ("hist_round", "hist_nat", "take_small"),
    "train_mono_advanced": ("hist_round", "hist_nat", "take_small"),
    # the exact grower: hist for the root and every split's smaller
    # child, hist_slots for the round phase
    "train_exact": ("hist", "take_small"),
    "train_exact_rounds": ("hist", "hist_slots", "take_small"),
    "train_mono_exact": ("hist", "take_small"),
}


def _eager(env):
    """A no-op before-iteration callback: keeps lgb.train on the eager
    loop."""


_eager.before_iteration = True


def loop_profile(torch, run, n_trees, cpu: bool = True):
    """torch.profiler around run() (n_trees trees): device busy share,
    device operations a tree (CUPTI sees the kernels a graph launches),
    and the kernel names with their counts. Only the CUDA rows are read;
    ``cpu=False`` records no CPU activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    names, device_ms, ops = {}, 0.0, 0
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us > 0:
            device_ms += us / 1e3
            ops += e.count
            names[e.key] = names.get(e.key, 0) + e.count
    return {"profiled_wall_ms_per_tree": wall_ms / n_trees,
            "device_ms_per_tree": device_ms / n_trees,
            "device_busy_share": device_ms / wall_ms,
            "device_ops_per_tree": ops / n_trees}, names


def fused_vs_eager(torch, lgb, ds, vs, name, extra, n_timed=6, n_skip=0,
                   check=None, n_profile=1, eager_profile=None):
    """The eager loop, then the fused CUDA-graph loop, on the same data
    and parameters at the headline widths: n_skip untimed trees (GOSS
    samples from tree 12), 1 warm-up tree, n_timed timed trees. Eager:
    Booster.update per tree (the host reads each round's predicate),
    each timed tree between two synchronizations, its evaluation (host
    metrics) outside the timing. Fused: GBDT.fused_dispatch / collect;
    the first dispatch runs the warm-up tree and captures the
    iteration's graph, the timed trees are one dispatch of replays.
    Per loop: trees/s (card synchronized), host ms a tree (the host
    clock until the trees are enqueued), and from an n_profile-tree
    torch.profiler run (the eager loop's with CUDA activity alone) the
    device busy share, device operations a tree
    and (fused) the kernel symbols its replays ran; for the graph: capture seconds,
    nodes, graph launches a tree, rounds per tree (min / median / max;
    the exact grower's: its round phase's) and overflows; splits per tree
    (min / median / max) under each loop. Holds model text and validation scores bitwise equal,
    eval records within 1e-5, 0 overflows and FUSED_NEEDS[name] in the
    graph (their wrappers ran during the capture; the profile's kernel
    symbols of the profiled replays are printed beside). check(booster), when
    given, holds each loop's model (it raises) and its result is printed
    under the loop. n_profile: the trees (replays) each profile runs;
    eager_profile: a profile_phase line of the same eager run taken
    earlier in the script, whose numbers stand in for the eager loop's
    profile (the f32 path phases profile one eager exact tree each).
    `seconds` gives each part's wall time."""
    from lightgbm_tpu_torch.learner import cuda_hist as ch

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **extra}
    res, line = {}, {"phase": name + "_fused_vs_eager",
                     "trees": n_skip + 1 + n_timed, "timed_trees": n_timed}
    secs = line["seconds"] = {}
    for loop in ("eager", "fused"):
        t_loop = time.perf_counter()
        bst = lgb.Booster(params, ds)
        bst.add_valid(vs, "valid")
        gb = bst._gbdt
        records = []
        ch.reset_launch_counts()
        torch.cuda.synchronize()
        if loop == "eager":
            wall = host = 0.0
            for t in range(n_skip + 1 + n_timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bst.update()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if t > n_skip:
                    wall, host = wall + t2 - t0, host + t1 - t0
                records.append(bst.eval_valid())

            def two():
                for _ in range(n_profile):
                    bst.update()
        else:
            gb.fused_start(track_train=False)
            gb.fused_dispatch(n_skip + 1)
            records += gb.fused_collect()
            torch.cuda.synchronize()
            secs["fused_first_dispatch"] = time.perf_counter() - t_loop
            t0 = time.perf_counter()
            gb.fused_dispatch(n_timed)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            records += gb.fused_collect()

            def two():
                gb.fused_dispatch(n_profile)
                gb.fused_collect()
        launches = {k: v for k, v in ch.LAUNCHES.items() if v}
        checked = check(bst) if check is not None else None
        splits = sorted(t.num_leaves - 1 for t in gb.models)
        res[loop] = (bst.model_to_string(),
                     gb.valids[0].score.clone(), records)
        secs[loop] = time.perf_counter() - t_loop
        t_prof = time.perf_counter()
        if loop == "eager" and eager_profile is not None:
            p = eager_profile
            prof, names = {"profile_of": p["phase"],
                           "profiled_wall_ms_per_tree": p["wall_ms_per_tree"],
                           "device_ms_per_tree": p["device_ms_per_tree"],
                           "device_busy_share": p["device_busy_share"],
                           "device_ops_per_tree":
                               p["kernel_launches_per_tree"]}, {}
        else:
            # the eager loop with CUDA activity alone (with the CPU's its
            # profiles took 138 s of the script, the monotone ones 20-33 s
            # each); the fused loop's replays keep both
            prof, names = loop_profile(torch, two, n_profile,
                                       cpu=loop == "fused")
        secs[loop + "_profile"] = time.perf_counter() - t_prof
        line[loop] = {"trees_per_s": n_timed / wall,
                      "host_ms_per_tree": host * 1e3 / n_timed,
                      "wall_ms_per_tree": wall * 1e3 / n_timed,
                      "splits_per_tree": [splits[0], splits[len(splits) // 2],
                                          splits[-1]],
                      "launches_counted": launches, **prof}
        if checked is not None:
            line[loop]["check"] = checked
        if loop == "fused":
            fp = gb._fused
            r = sorted(fp.rounds)
            line[loop].update({
                "graph_launches_per_tree": fp.graph.replays
                / (n_skip + n_timed + n_profile),
                "capture_s": fp.graph.capture_s, "graph_nodes":
                fp.graph.nodes, "round_cap": fp.round_cap,
                "rounds_per_tree": [r[0], r[len(r) // 2], r[-1]],
                "overflows": gb.fused_overflow_count})
            ran = {k: sum(c for nm, c in names.items() if sym in nm)
                   for k, sym in FUSED_KERNELS.items()}
            line[loop].update(
                captured_launches=fp.captured_launches,
                kernels_in_replays_profile=ran,
                replay_kernels_top=sorted(names.items(),
                                          key=lambda kv: -kv[1])[:12])
    (me, se, re_), (mf, sf, rf) = res["eager"], res["fused"]
    gaps = [abs(a[2] - b[2]) for ev_e, ev_f in zip(re_, rf)
            for a, b in zip(ev_e, ev_f)]
    line.update(model_text_equal=me == mf,
                valid_scores_equal=bool(torch.equal(se, sf)),
                eval_records=[len(re_), len(rf)],
                max_eval_gap=max(gaps) if gaps else None,
                metric_last=[re_[-1][0][2], rf[-1][0][2]],
                records_first_last={"eager": [re_[0], re_[-1]],
                                    "fused": [rf[0], rf[-1]]},
                speedup=line["fused"]["trees_per_s"]
                / line["eager"]["trees_per_s"])
    emit(line)
    # the graph holds each kernel of the path (its wrapper ran during the
    # capture), and the replays' models equal the eager loop's
    missing = [k for k in FUSED_NEEDS[name]
               if not line["fused"]["captured_launches"].get(k)]
    if not (line["model_text_equal"] and line["valid_scores_equal"]):
        raise AssertionError(f"{name}: the fused loop's model differs from "
                             "the eager loop's")
    if len(re_) != len(rf) or not gaps or max(gaps) > 1e-5:
        raise AssertionError(f"{name}: eval records {line['eval_records']} "
                             f"apart by {line['max_eval_gap']}")
    if line["fused"]["overflows"] or missing:
        raise AssertionError(f"{name}: overflows "
                             f"{line['fused']['overflows']}, kernels not in "
                             f"the graph {missing}")
    return line


# the sampled paths' parameters: bagging and feature sub-sampling as
# LightGBM's tuning guide sets them, and GOSS at its defaults
BAG_PARAMS = {"bagging_fraction": 0.8, "bagging_freq": 1,
              "feature_fraction": 0.8}
GOSS_PARAMS = {"data_sample_strategy": "goss", "top_rate": 0.2,
               "other_rate": 0.1}


# DART at LightGBM's defaults, RF as its docs set it (bagging at the
# bootstrap's 0.632 plus feature_fraction)
DART_PARAMS = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5,
               "max_drop": 50}
RF_PARAMS = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
             "feature_fraction": 0.8}
# the kernels of the int16 rounds path that DART, RF, the extras and the
# forced plan run
INT16_NEEDS = ("hist_round", "hist_nat", "take_small", "seg_sum")


def extras_params(n_feat: int) -> dict:
    """Every per-node extra on together: extra_trees, a per-node half of
    the features, two interaction groups (the first and second half of
    the columns), and split + lazy CEGB costs of about one gain unit at
    the root of 1M rows."""
    half = n_feat // 2
    groups = [list(range(half)), list(range(half, n_feat))]
    return {"extra_trees": True, "feature_fraction_bynode": 0.5,
            "interaction_constraints": ",".join(
                "[" + ",".join(map(str, g)) + "]" for g in groups),
            "cegb_penalty_split": 1e-6,
            "cegb_penalty_feature_lazy": [2e-6] * n_feat}


def group_crossings(bst, n_feat: int) -> dict:
    """Root-to-leaf paths of every tree, and those whose split features
    fall in both halves of the columns (there must be none)."""
    half = n_feat // 2
    paths = crossing = 0
    for tree in bst._gbdt.models:
        stack = [(0, frozenset())]
        while stack:
            n, feats = stack.pop()
            if n < 0 or tree.num_leaves < 2:
                paths += 1
                lo = any(f < half for f in feats)
                crossing += lo and any(f >= half for f in feats)
                continue
            f = feats | {int(tree.split_feature[n])}
            stack += [(int(tree.left_child[n]), f),
                      (int(tree.right_child[n]), f)]
    if crossing or not paths:
        raise AssertionError(f"{crossing} of {paths} paths cross the "
                             "interaction groups")
    return {"paths": paths, "crossing_paths": crossing}


# a 3-level forced plan (7 splits) on the first seven columns at 0.0,
# their medians
FORCED_PLAN = {"feature": 0, "threshold": 0.0,
               "left": {"feature": 1, "threshold": 0.0,
                        "left": {"feature": 3, "threshold": 0.0},
                        "right": {"feature": 4, "threshold": 0.0}},
               "right": {"feature": 2, "threshold": 0.0,
                         "left": {"feature": 5, "threshold": 0.0},
                         "right": {"feature": 6, "threshold": 0.0}}}


def forced_plan_held(bst) -> dict:
    """The first 7 splits of every tree are the plan: nodes 0..6 split
    features 0..6 in BFS order at the bin bound nearest 0, node i's
    children nodes 2i + 1 and 2i + 2."""
    trees = bst._gbdt.models
    for i, tree in enumerate(trees):
        ok = (tree.num_leaves > 7
              and list(tree.split_feature[:7]) == list(range(7))
              and all(abs(float(tree.threshold[n])) < 0.05
                      for n in range(7))
              and all(int(tree.left_child[n]) == 2 * n + 1
                      and int(tree.right_child[n]) == 2 * n + 2
                      for n in range(3)))
        if not ok:
            raise AssertionError(f"tree {i} does not start with the plan: "
                                 f"{list(tree.split_feature[:7])}")
    return {"trees_starting_with_plan": len(trees)}


# the constrained Higgs-like columns; each is constrained in the direction
# the label moves with it on the rows at hand (mono_directions): at 1M
# rows bench.py's logit weights of columns 0, 1, 3 and 5 are -2.06,
# +1.61, -0.51 and -0.04, so a constraint against them would keep every
# split off these columns and leave the bounds nothing to do
MONO_COLUMNS = (0, 1, 3, 5)


def mono_directions(np, X, y) -> dict:
    """+1 / -1 for each constrained column: the sign of its correlation
    with the label."""
    return {f: 1 if np.corrcoef(X[:, f], y)[0, 1] >= 0 else -1
            for f in MONO_COLUMNS}


def mono_params(n_feat: int, method: str, directions: dict) -> dict:
    mono = [directions.get(f, 0) for f in range(n_feat)]
    return {"monotone_constraints": mono,
            "monotone_constraints_method": method}


def mono_sets(lgb, X, y, Xv, yv, directions: dict):
    """The Higgs-like rows binned again with the constraints: a Dataset
    takes its monotone_constraints when it is constructed, and one built
    on a reference takes the reference's."""
    t0 = time.perf_counter()
    dm = lgb.Dataset(X, label=y, free_raw_data=False,
                     params={"monotone_constraints": mono_params(
                         X.shape[1], "basic", directions)[
                             "monotone_constraints"]})
    dm.construct()
    vm = lgb.Dataset(Xv, label=yv, reference=dm, free_raw_data=False)
    emit({"phase": "mono_dataset", "seconds": time.perf_counter() - t0,
          "directions": directions})
    return dm, vm


def violation_scan(np, bst, Xv, directions: dict, rows: int = 2000) -> dict:
    """Each constrained column swept across its bin thresholds on `rows`
    validation rows: the host walker's raw predictions must not fall
    (rise, for a decreasing column) by more than 1e-6 from one grid value
    to the next. The grid is every threshold the model splits the column
    at (each a bin upper bound; a prediction changes nowhere else) and
    one value past the last."""
    base = np.asarray(Xv[:rows], np.float64)
    rows = len(base)
    worst, points = {}, {}
    for f, d in directions.items():
        thr = sorted({float(t.threshold[n]) for t in bst._gbdt.models
                      for n in range(len(t.split_feature))
                      if int(t.split_feature[n]) == f})
        grid = np.array(thr + [thr[-1] + 1.0] if thr else [0.0])
        points[f] = len(grid)
        Xg = np.repeat(base, len(grid), axis=0)
        Xg[:, f] = np.tile(grid, rows)
        pred = bst.predict(Xg, raw_score=True).reshape(rows, len(grid))
        worst[f] = float((np.diff(pred, axis=1) * d).min()) \
            if len(grid) > 1 else 0.0
    if min(worst.values()) < -1e-6:
        raise AssertionError(f"monotone violation: worst steps {worst}")
    return {"rows": rows, "grid_points_by_column": points,
            "worst_step_by_column": worst}


def mono_check(np, Xv, method: str, directions: dict):
    """fused_vs_eager's check for a monotone path: the method resolved,
    the splits the conflict guard deferred and the splits on the
    constrained columns, a tree, and on the eager loop the violation
    scan."""
    mode = {"intermediate": 1, "advanced": 2}[method]

    def check(bst):
        gb = bst._gbdt
        if gb.spec.mono_mode != mode:
            raise AssertionError(f"mono_mode {gb.spec.mono_mode}, not {mode}")
        models = gb.models
        out = {"mono_mode": mode, "deferred_per_tree":
               int(gb.mono_deferred) / len(models),
               "constrained_splits_per_tree": sum(
                   int(f) in directions for t in models
                   for f in t.split_feature) / len(models)}
        if gb._fused is None:
            out["violation_scan"] = violation_scan(np, bst, Xv, directions)
        return out

    return check


def mono_tables_ms(torch, lgb, ds, method: str, directions: dict) -> dict:
    """One eager tree of the monotone path with every call of
    grower.mono_bounds (the bounds' tables) and of the re-search (the
    batched split search over all L leaves) recorded, then each set
    replayed as one call of device_ms: device ms a tree of each (the
    calls are dense, so the final tensors time as the recorded ones)."""
    from lightgbm_tpu_torch.learner import rounds

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, **mono_params(28, method, directions)}
    tables, research = [], []
    orig_b, orig_s = rounds.mono_bounds, rounds.best_split

    def rec_bounds(*a):
        tables.append(a)
        return orig_b(*a)

    def rec_search(hist, *a, **k):
        if hist.shape[0] == L:
            research.append((hist,) + a + (k,))
        return orig_s(hist, *a, **k)

    rounds.mono_bounds, rounds.best_split = rec_bounds, rec_search
    try:
        bst = lgb.Booster(params, ds)
        bst.update()
        torch.cuda.synchronize()
    finally:
        rounds.mono_bounds, rounds.best_split = orig_b, orig_s

    def replay(fn, calls, kw):
        def run():
            for c in calls:
                fn(*c[:-1], **c[-1]) if kw else fn(*c)
        return device_ms(run, 1)

    (t_ms, t_how), (r_ms, r_how) = (replay(orig_b, tables, False),
                                    replay(orig_s, research, True))
    return {"rounds": len(tables), "tables_device_ms_per_tree": t_ms,
            "research_device_ms_per_tree": r_ms,
            "timed_by": sorted({t_how, r_how})}


def train_mono_phase(torch, lgb, np, ds, vs, Xv, method: str,
                     directions: dict) -> dict:
    """train_mono_<method>: the monotone path through fused_vs_eager (1
    warm-up and 1 timed tree a loop, 2 before the distributed phase
    came), AUC rising from the first tree to
    the last on both loops, with the tables' device ms a tree beside."""
    tables = mono_tables_ms(torch, lgb, ds, method, directions)
    name = "train_mono_" + method
    line = fused_vs_eager(torch, lgb, ds, vs, name,
                          mono_params(28, method, directions), n_timed=1,
                          check=mono_check(np, Xv, method, directions))
    emit({"phase": name + "_tables", **tables})
    for loop, (first, last) in line["records_first_last"].items():
        if not last[0][2] > first[0][2]:
            raise AssertionError(f"{name} {loop}: AUC did not rise: "
                                 f"{first[0][2]} -> {last[0][2]}")
    line["tables"] = tables
    return line


def train_mono_basic_line(torch, lgb, ds, vs, directions: dict,
                          n_timed: int = 4) -> dict:
    """Basic monotone with the same constraints on the fused loop (1
    warm-up, n_timed timed trees), for the AUC and trees/s beside
    intermediate and advanced."""
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **mono_params(28, "basic", directions)}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    gb = bst._gbdt
    gb.fused_start(track_train=False)
    gb.fused_dispatch(1)
    first = gb.fused_collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gb.fused_dispatch(n_timed)
    last = gb.fused_collect()
    torch.cuda.synchronize()
    line = {"phase": "train_mono_basic", "timed_trees": n_timed,
            "trees_per_s": n_timed / (time.perf_counter() - t0),
            "auc_first_last": [first[0][0][2], last[-1][0][2]],
            "mono_mode": gb.spec.mono_mode}
    emit(line)
    return line


def train_mono_exact_phase(torch, lgb, ch, np, ds, vs, Xv, directions: dict,
                           n_trees: int = 2) -> dict:
    """train_mono_exact: intermediate on the exact grower (the per-split
    recompute and re-search), eager, n_trees trees at 63 leaves (cut from
    the headline 255: the exact grower searches every leaf again after
    each split), AUC after the first and the last tree, launches, the
    violation scan."""
    params = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, "tpu_growth_mode": "exact",
              **mono_params(28, "intermediate", directions)}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    ch.reset_launch_counts()
    aucs, wall = [], 0.0
    for _ in range(n_trees):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        aucs.append(bst.eval_valid()[0][2])
    gb = bst._gbdt
    launches = {k: v for k, v in ch.LAUNCHES.items() if v}
    line = {"phase": "train_mono_exact", "num_leaves": 63,
            "reduced": "num_leaves 255 -> 63", "trees": n_trees,
            "trees_per_s": n_trees / wall, "auc": aucs,
            "mono_mode": gb.spec.mono_mode,
            "rounds_slots": gb.spec.rounds_slots, "launches": launches,
            "launches_per_tree": {k: v / n_trees
                                  for k, v in launches.items()},
            "violation_scan": violation_scan(np, bst, Xv, directions)}
    emit(line)
    if gb.spec.mono_mode != 1 or gb.spec.rounds_slots != 0:
        raise AssertionError("train_mono_exact: not intermediate on exact")
    if not launches.get("hist") or not aucs[-1] > aucs[0]:
        raise AssertionError(f"train_mono_exact: {line}")
    return line


def train_linear_phase(torch, lgb, ch, np, X, y, Xv, yv, ds,
                       n_trees: int = 5) -> dict:
    """train_linear: linear_tree on the binary workload (linear_lambda
    0.1), eager, n_trees trees: trees/s, host ms a tree in the leaf fits
    (GBDT._fit_linear) and in the rest, AUC after the first and the last
    tree, launches; the train score of the first 50,000 rows against a
    fresh predict(raw_score=True) (1e-5), predict(device="cuda") against
    the host walker on 20,000 validation rows (1e-5), and the model text
    round trip (the same trees, the same predictions)."""
    from lightgbm_tpu_torch import boosting

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, "linear_tree": True, "linear_lambda": 0.1}
    t0 = time.perf_counter()
    dl = lgb.Dataset(X, label=y, reference=ds, params={"linear_tree": True},
                     free_raw_data=False)
    dl.construct()
    vl = lgb.Dataset(Xv, label=yv, reference=dl, free_raw_data=False)
    t_data = time.perf_counter() - t0
    bst = lgb.Booster(params, dl)
    bst.add_valid(vl, "valid")
    fit_s = []
    orig = boosting.GBDT._fit_linear

    def timed_fit(self, *a, **k):
        t = time.perf_counter()
        orig(self, *a, **k)
        fit_s.append(time.perf_counter() - t)

    boosting.GBDT._fit_linear = timed_fit
    ch.reset_launch_counts()
    aucs, wall = [], 0.0
    try:
        for _ in range(n_trees):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bst.update()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            aucs.append(bst.eval_valid()[0][2])
    finally:
        boosting.GBDT._fit_linear = orig
    gb = bst._gbdt
    launches = {k: v for k, v in ch.LAUNCHES.items() if v}
    n_chk = 50_000
    train_gap = float(np.abs(
        gb.train.score[0, :n_chk].cpu().numpy().astype(np.float64)
        - bst.predict(X[:n_chk], raw_score=True)).max())
    host = bst.predict(Xv[:20_000], raw_score=True)
    card = bst.predict(Xv[:20_000], raw_score=True, device="cuda")
    card_gap = float(np.abs(card - host).max())
    path = Path("build") / "chip_smoke" / "linear.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    bst.save_model(path)
    loaded = lgb.Booster(model_file=path)
    trees = lambda t: t.split("end of trees")[0]
    round_trip = {
        "text": trees(loaded.model_to_string()) == trees(
            bst.model_to_string()),
        "predict": bool(np.array_equal(
            loaded.predict(Xv[:2000], raw_score=True),
            bst.predict(Xv[:2000], raw_score=True)))}
    models = gb.models
    line = {"phase": "train_linear", "rows": int(X.shape[0]),
            "num_leaves": L, "trees": n_trees, "dataset_seconds": t_data,
            "trees_per_s": n_trees / wall,
            "host_ms_per_tree_fit": 1e3 * sum(fit_s) / n_trees,
            "host_ms_per_tree_rest": 1e3 * (wall - sum(fit_s)) / n_trees,
            "auc": aucs, "launches": launches,
            "launches_per_tree": {k: v / n_trees
                                  for k, v in launches.items()},
            "all_linear": all(t.is_linear for t in models),
            "fitted_leaves": sum(1 for t in models for c in t.leaf_coeff
                                 if len(c)),
            "train_score_vs_predict": train_gap,
            "card_vs_host_predict": card_gap, "tolerance": 1e-5,
            "model_text_round_trip": round_trip,
            "fused_ineligible_reason": gb.fused_ineligible_reason()}
    emit(line)
    if not (line["all_linear"] and line["fitted_leaves"]
            and all(round_trip.values()) and train_gap < 1e-5 and card_gap < 1e-5
            and aucs[-1] > aucs[0]):
        raise AssertionError(f"train_linear: {line}")
    missing = [k for k in INT16_NEEDS if not launches.get(k)]
    if missing:
        raise AssertionError(f"train_linear: {missing} not launched")
    return line


def fresh_train_score(torch, gb):
    """The train score rebuilt from the stored model: each device tree
    traversed over the binned rows, its leaf values summed."""
    score = torch.zeros_like(gb.train.score[0])
    for arrays in gb.device_trees:
        leaf = gb._traverse(arrays, gb.train.dev).long()
        score += torch.where(leaf >= 0, arrays.leaf_value[leaf.clamp_min(0)],
                             torch.zeros_like(score))
    return score


def train_dart_phase(torch, lgb, ch, np, ds, vs, n_trees=30):
    """DART at its defaults on the headline workload, eager loop (its
    fused_ineligible_reason): AUC after the first and the last tree,
    drops a tree, trees/s, device ms a tree (2 profiled trees), and the
    train score against a fresh traversal of the stored, renormalized
    model (within 1e-4)."""
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **DART_PARAMS}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    gb = bst._gbdt
    drops = []
    select = gb._select_drops

    def recording():
        d = select()
        drops.append(len(d))
        return d

    gb._select_drops = recording
    ch.reset_launch_counts()
    bst.update()
    auc1 = bst.eval_valid()[0][2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_trees - 3):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prof, _names = loop_profile(torch, lambda: (bst.update(), bst.update()),
                                2)
    launches = {k: v for k, v in ch.LAUNCHES.items() if v}
    auc_last = bst.eval_valid()[0][2]
    n = gb.train_set.num_data
    err = float((fresh_train_score(torch, gb)[:n]
                 - gb.train.score[0, :n]).abs().max())
    line = {"phase": "train_dart", **DART_PARAMS, "rows": n,
            "num_leaves": L, "trees": len(gb.models),
            "trees_per_s": (n_trees - 3) / dt, "auc_tree1": auc1,
            "auc_last": auc_last, "drops_per_tree": float(np.mean(drops)),
            "iterations_with_drops": int(sum(d > 0 for d in drops)),
            "max_drops": max(drops), "launches": launches,
            "launches_per_tree": {k: v / n_trees for k, v in launches.items()},
            "train_score_vs_fresh_traversal": err, "tolerance": 1e-4,
            "fused_ineligible_reason": gb.fused_ineligible_reason(), **prof}
    emit(line)
    missing = [k for k in INT16_NEEDS if not launches.get(k)]
    if missing or not sum(drops):
        raise AssertionError(f"train_dart: {missing} not launched, "
                             f"{sum(drops)} drops")
    if not (auc_last > auc1 and err < 1e-4 and len(gb.models) == n_trees):
        raise AssertionError(f"train_dart: AUC {auc1} -> {auc_last}, "
                             f"score vs fresh traversal {err}")
    return line


def train_rf_phase(torch, lgb, ch, np, ds, vs, Xv, n_trees=30):
    """Random forest on the headline workload, eager loop: AUC after the
    first and the last tree, trees/s; the validation score against the
    mean of the host walker's per-tree predictions; a save / load round
    trip; Booster.predict(device="cuda") (the tensorized forest's
    average_output branch) against the host walker within 1e-5."""
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "min_data_in_leaf": 20, "metric": "auc", "verbosity": -1,
              **RF_PARAMS}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    gb = bst._gbdt
    ch.reset_launch_counts()
    bst.update()
    auc1 = bst.eval_valid()[0][2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_trees - 3):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    prof, _names = loop_profile(torch, lambda: (bst.update(), bst.update()),
                                2)
    launches = {k: v for k, v in ch.LAUNCHES.items() if v}
    auc_last = bst.eval_valid()[0][2]
    rows = Xv[:2000]
    per_tree = np.stack([t.predict(rows) for t in gb.models])
    card = gb.valids[0].score[0, :2000].cpu().numpy().astype(np.float64)
    mean_err = float(np.abs(card - per_tree.mean(axis=0)).max())
    path = Path("build") / "chip_smoke" / "rf_model.txt"
    bst.save_model(path)
    host = bst.predict(Xv[:20000], raw_score=True)
    reloaded = lgb.Booster(model_file=path).predict(Xv[:20000],
                                                    raw_score=True)
    on_card = bst.predict(Xv[:20000], raw_score=True, device="cuda")
    card_err = float(np.abs(on_card - host).max())
    line = {"phase": "train_rf", **RF_PARAMS, "rows": gb.train_set.num_data,
            "num_leaves": L, "trees": len(gb.models),
            "trees_per_s": (n_trees - 3) / dt, "auc_tree1": auc1,
            "auc_last": auc_last,
            "valid_score_vs_mean_of_trees": mean_err,
            "identical_after_reload": bool(np.array_equal(host, reloaded)),
            "predict_cuda_vs_host": card_err, "tolerance": 1e-5,
            "launches": launches,
            "launches_per_tree": {k: v / n_trees for k, v in launches.items()},
            "fused_ineligible_reason": gb.fused_ineligible_reason(), **prof}
    emit(line)
    missing = [k for k in INT16_NEEDS if not launches.get(k)]
    if missing:
        raise AssertionError(f"train_rf: {missing} not launched")
    if not (auc_last > auc1 and mean_err < 1e-4 and card_err < 1e-5
            and line["identical_after_reload"]):
        raise AssertionError(f"train_rf: AUC {auc1} -> {auc_last}, mean "
                             f"{mean_err}, card {card_err}, reload "
                             f"{line['identical_after_reload']}")
    return line


def bag_ties(torch, gb, it: int, mask) -> dict:
    """One bagging window's draw counted exactly: k = round(f32(eligible)
    * f32(fraction)), the threshold (the k-th smallest eligible uniform),
    the eligible rows whose uniform equals it, and the rows in the bag,
    which must be k plus the ties beyond the k-th row."""
    import numpy as np

    from lightgbm_tpu_torch import rng

    c = gb.config
    valid = gb.dev["valid"]
    window = (it // c.bagging_freq) * c.bagging_freq
    u = rng.uniform(rng.fold_in(rng.key(c.bagging_seed, valid.device),
                                window), valid.shape)
    elig = valid > 0
    n_elig = int(elig.sum())
    k = int(np.round(np.float32(n_elig) * np.float32(c.bagging_fraction)))
    thr = torch.sort(u[elig]).values[k - 1]
    at_thr = int(((u == thr) & elig).sum())
    below = int(((u < thr) & elig).sum())
    in_bag = int((mask > 0).sum())
    if in_bag != below + at_thr or not below < k <= below + at_thr:
        raise AssertionError(f"bag of window {window}: {in_bag} rows, k "
                             f"{k}, {below} below and {at_thr} at the "
                             "threshold")
    return dict(window=window, k=k, in_bag=in_bag, at_threshold=at_thr,
                beyond_k=in_bag - k)


def train_sampled_path(torch, lgb, ch, ds, vs, name, extra, n_skip, n_warm,
                       n_timed, round_cap, root_cap):
    """A sampled path on the headline workload (bench.py:386-406, the
    default int16 rounds path): n_skip trees that do not sample (GOSS's
    warm-up), then n_warm warmup and n_timed timed sampled trees, the
    first sampled tree recording its first and fullest hist_round calls
    (round_cap) and its root hist_nat call (root_cap). Prints trees/s,
    AUC after the first tree, the first sampled tree and the last, the
    rows in each tree's sample, the features each tree may split on,
    launches per tree, and a 1-tree profile. Fails unless AUC rises over
    the sampled trees, every sample holds rows (GOSS's within 1% of
    top_rate * rows + other_rate * the rest) and each tree may split on
    ceil(feature_fraction * 28) features."""
    import numpy as np

    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, **extra}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    gb = bst._gbdt
    masks, feats = [], []
    sample, features = gb.strategy.sample, gb._sample_features

    def keep_mask(*a):
        out = sample(*a)
        masks.append(out[0])
        return out

    def keep_features(it, k):
        m = features(it, k)
        feats.append(m)
        return m

    gb.strategy.sample, gb._sample_features = keep_mask, keep_features
    ch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    auc0 = None
    for _ in range(n_skip):
        bst.update()
        auc0 = auc0 if auc0 is not None else bst.eval_valid()[0][2]
    with recording_rounds(round_cap), recording_root(root_cap):
        bst.update()
    auc1 = bst.eval_valid()[0][2]
    auc0 = auc1 if auc0 is None else auc0
    for _ in range(n_warm - 1):
        bst.update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ch.LAUNCHES)
    auc_last = bst.eval_valid()[0][2]
    trees = n_skip + n_warm + n_timed
    in_sample = [int((m > 0).sum()) for m in masks]
    line = {"phase": name, **extra, "rows": gb.train_set.num_data,
            "num_leaves": L, "hist_dtype": gb.hist_dtype,
            "unsampled_trees": n_skip, "warmup_trees": n_warm,
            "timed_trees": n_timed, "trees_per_s": n_timed / dt,
            "auc_tree1": auc0, "auc_first_sampled": auc1,
            "auc_last": auc_last, "trees": trees,
            "rows_in_sample_per_tree": in_sample,
            "features_per_tree": [int(f.sum()) for f in feats],
            "splits_per_tree": [int(a.num_nodes) for a in gb.device_trees],
            "launches": launches,
            "launches_per_tree": {k: v / trees
                                  for k, v in launches.items() if v},
            "peak_device_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    if gb.strategy.__class__.__name__ == "BaggingStrategy":
        line["bag_draws"] = [bag_ties(torch, gb, it, m)
                             for it, m in enumerate(masks)]
        # the first window's bag drawn again on the CPU: the same bits
        cpu = gb.strategy.window_mask(0, gb.dev["valid"].cpu(),
                                      gb._label_dev.cpu())
        line["bag_equals_cpu_draw"] = bool(torch.equal(
            cpu, (masks[0] > 0).cpu()))
        if not line["bag_equals_cpu_draw"]:
            raise AssertionError(f"{name}: the card's bag differs from the "
                                 "CPU's draw")
    else:
        n = gb.train_set.num_data
        line["rows_in_sample_expected"] = (
            int(n * GOSS_PARAMS["top_rate"])
            + (1 - GOSS_PARAMS["top_rate"]) * n * GOSS_PARAMS["other_rate"]
            / (1 - GOSS_PARAMS["top_rate"]))
    emit(line)
    gb.strategy.sample, gb._sample_features = sample, features
    missing = [k for k in ("hist_nat", "hist_round", "take_small", "seg_sum")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: {missing} not launched: {launches}")
    sampled = in_sample[n_skip:]
    if not (0 < min(sampled) and max(sampled) < gb.train_set.num_data):
        raise AssertionError(f"{name}: samples of {sampled} rows")
    want = int(np.ceil(extra.get("feature_fraction", 1.0) * G))
    if any(int(f.sum()) != want for f in feats):
        raise AssertionError(f"{name}: features per tree "
                             f"{line['features_per_tree']}, not {want}")
    expected = line.get("rows_in_sample_expected")
    if expected and not all(abs(r - expected) < 0.01 * expected
                            for r in sampled):
        raise AssertionError(f"{name}: samples of {sampled} rows, "
                             f"expected ~{expected}")
    del masks, feats
    if not (auc_last > auc1 and auc_last > 0.85):
        raise AssertionError(f"{name}: AUC did not rise: {auc1} -> "
                             f"{auc_last}")
    prof = profile_phase(torch, bst, 1, name + "_profile")
    return line, prof


def train_continue_phase(torch, lgb, np, ds, vs, Xv, model_path):
    """Continued training from the `model` phase's saved model: the
    validation scores seeded by the loaded trees' binned traversal equal
    Booster(model_file=...)'s raw predictions within 1e-5; then 3 more
    trees with bagging, early_stopping_round 2 on validation AUC, a
    learning-rate schedule (reset_parameter) and record_evaluation.
    best_iteration must be the first argmax of the recorded AUCs, and a
    stop must come exactly 2 rounds after it."""
    loaded = lgb.Booster(model_file=model_path)
    n_loaded = loaded.num_trees()
    raw = loaded.predict(Xv, raw_score=True)
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1, "bagging_fraction": 0.8, "bagging_freq": 1,
              "early_stopping_round": 2}
    b = lgb.Booster(params, ds)
    b.add_valid(vs, "valid")
    b._continue_from(loaded)
    seeded = b._gbdt.valids[0].score[0, :len(Xv)].cpu().numpy()
    seed_err = float(np.abs(seeded.astype(np.float64) - raw).max())
    del b
    ev = {}
    lrs = [0.1, 0.08, 0.05]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, 3, valid_sets=[vs], valid_names=["valid"],
                    init_model=model_path,
                    callbacks=[lgb.record_evaluation(ev),
                               lgb.reset_parameter(learning_rate=lrs)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hist = ev["valid"]["auc"]
    best = bst.best_iteration
    first_argmax = int(np.argmax(hist)) + 1
    stopped = len(hist) < 3
    line = {"phase": "train_continue", "loaded_trees": n_loaded,
            "seeded_max_abs_vs_loaded_predict": seed_err, "tolerance": 1e-5,
            "new_trees": bst.num_trees() - n_loaded, "auc_history": hist,
            "best_iteration": best, "first_argmax": first_argmax,
            "stopped_early": stopped, "seconds": dt,
            "shrinkage": [t.shrinkage for t in bst._gbdt.models[n_loaded:]]}
    emit(line)
    if not seed_err < 1e-5:
        raise AssertionError(f"train_continue: seeded scores {seed_err} "
                             "from the loaded model's predictions")
    if best != first_argmax or bst.num_trees() != n_loaded + len(hist):
        raise AssertionError(f"train_continue: best_iteration {best}, "
                             f"history {hist}, {bst.num_trees()} trees")
    if stopped and len(hist) != best + 2:
        raise AssertionError(f"train_continue: stopped {len(hist) - best} "
                             "rounds after the best")
    if line["shrinkage"] != lrs[:len(hist)]:
        raise AssertionError(f"train_continue: shrinkage {line['shrinkage']}")
    return line

# ---- the Python API on the card (api_cv, api_booster, api_sparse,
# api_file): the train phase's data and booster
API_PARAMS = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1}


def api_cv_phase(torch, lgb, np, ds):
    """lgb.cv on the train phase's 1M rows: 5 stratified folds, 10 rounds,
    early stopping 5 on AUC, every fold on the fused loop (one CUDA graph
    captured a fold); fold 0 against train() on ds.subset(train_idx) with
    ds.subset(test_idx) as its validation set, bit for bit; rollback on
    fold 0's fused booster; fused cv against eager cv on 2 folds x 3
    rounds, bit for bit."""
    from lightgbm_tpu_torch.engine import _make_n_folds

    params = dict(API_PARAMS, early_stopping_round=5)
    folds = list(_make_n_folds(ds, 5, params, 0, True, True))
    sizes = [[len(tr), len(te)] for tr, te in folds]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = lgb.cv(params, ds, 10, nfold=5, stratified=True, seed=0,
                 return_cvbooster=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    cvb = res.pop("cvbooster")
    best = cvb.best_iteration
    fused = [b._gbdt._fused for b in cvb.boosters]
    graphs = [f.graph for f in fused if f is not None and f.graph]
    capture_s = [g.capture_s for g in graphs]
    trees = sum(b.num_trees() for b in cvb.boosters)
    auc = res["valid auc-mean"]
    # fold 0 against train() on the same subsets
    tr, te = folds[0]
    b0 = cvb.boosters[0]
    n0 = b0.num_trees()
    ref = lgb.train(params, ds.subset(tr), n0, valid_sets=[ds.subset(te)],
                    valid_names=["valid"])
    fold0_equal = (ref.model_to_string(num_iteration=-1)
                   == b0.model_to_string(num_iteration=-1))
    # rollback on a fused booster: host and device trees in step, the
    # card's validation scores those of the first n0 - 1 iterations
    b0.rollback_one_iter()
    m = min(20000, len(te))
    host = b0.predict(ds.data[te[:m]], raw_score=True, num_iteration=n0 - 1)
    card = b0._gbdt.valids[0].score[0, :m].cpu().numpy()
    rollback = {"trees": b0.num_trees(),
                "device_trees": len(b0._gbdt.device_trees),
                "iteration": b0.current_iteration(),
                "max_abs_card_vs_host": float(np.abs(card - host).max())}
    del ref, cvb, b0, fused, graphs
    # the fused loop against the eager loop, 2 folds x 3 rounds
    two = {}
    for name, cbs in (("fused", []), ("eager", [_eager])):
        two[name] = lgb.cv(API_PARAMS, ds, 3, folds=folds[:2],
                           return_cvbooster=True, callbacks=cbs)
    pairs = zip(two["fused"]["cvbooster"].boosters,
                two["eager"]["cvbooster"].boosters)
    fused_eq_eager = all(
        a.model_to_string() == b.model_to_string()
        and torch.equal(a._gbdt.valids[0].score, b._gbdt.valids[0].score)
        for a, b in pairs)
    del two
    torch.cuda.empty_cache()
    line = {"phase": "api_cv", "rows": ds.num_data(), "folds": 5,
            "fold_sizes_train_test": sizes, "rounds": 20,
            "early_stopping_round": 5, "iterations": len(auc),
            "best_iteration": best, "valid_auc_mean": auc,
            "captures": len(capture_s), "capture_s": capture_s,
            "seconds": dt, "trees": trees, "trees_per_s": trees / dt,
            "trees_per_s_after_capture": trees / (dt - sum(capture_s)),
            "peak_device_mb": peak, "fold0_equals_train": fold0_equal,
            "fused_rollback": rollback, "fused_equals_eager_2x3":
            fused_eq_eager}
    emit(line)
    if all(n % 16 == 0 for s in sizes for n in s):
        raise AssertionError(f"api_cv: every fold size is a multiple of 16")
    if len(capture_s) != 5:
        raise AssertionError(f"api_cv: {len(capture_s)} graph captures")
    if not auc[-1] > auc[0]:
        raise AssertionError(f"api_cv: AUC did not rise: {auc}")
    if not fold0_equal:
        raise AssertionError("api_cv: fold 0 differs from train() on its "
                             "subsets")
    if (rollback["trees"] != n0 - 1 or rollback["device_trees"] != n0 - 1
            or rollback["max_abs_card_vs_host"] > 1e-4):
        raise AssertionError(f"api_cv: fused rollback {rollback}")
    if not fused_eq_eager:
        raise AssertionError("api_cv: fused cv differs from eager cv")
    return line


def api_booster_phase(torch, lgb, np, bst, Xv, yv):
    """The Booster accessors on the train phase's booster: rollback_one_iter
    (one more tree, rolled back: the validation scores of before, within
    1e-6), set_leaf_output (host predict, the device tree and
    predict(device="cuda")), refit on the 100,000 validation rows against
    the same refit under device_type=cpu (1e-5), the bounds around the raw
    predictions, split importances against the model text's, and
    shuffle_models (predictions within 1e-6)."""
    gb = bst._gbdt
    line = {"phase": "api_booster", "trees": bst.num_trees()}
    # rollback_one_iter
    n_it = bst.current_iteration()
    before = gb.valids[0].score.clone()
    bst.update()
    bst.rollback_one_iter()
    rb = float((gb.valids[0].score - before).abs().max())
    line["rollback"] = {"iteration_after_update": n_it + 1,
                        "iteration": bst.current_iteration(),
                        "max_abs_valid_score_vs_before": rb,
                        "tolerance": 1e-6}
    if not (rb <= 1e-6 and bst.current_iteration() == n_it
            and bst.num_trees() == n_it and len(gb.device_trees) == n_it):
        raise AssertionError(f"api_booster: rollback {line['rollback']}")
    # set_leaf_output
    rows = Xv[:5000]
    p0 = bst.predict(rows, raw_score=True)
    leaf0 = bst.predict(rows, pred_leaf=True)[:, 0]
    lid = int(np.bincount(leaf0).argmax())
    v = bst.get_leaf_output(0, lid)
    bst.set_leaf_output(0, lid, v + 0.5)
    d = bst.predict(rows, raw_score=True) - p0
    dev_v = float(gb.device_trees[0].leaf_value[lid])
    p_card = bst.predict(rows, raw_score=True, device="cuda")
    card_err = float(np.abs(p_card - (p0 + d)).max())
    bst.set_leaf_output(0, lid, v)
    hit = leaf0 == lid
    line["set_leaf_output"] = {
        "leaf": lid, "rows_in_leaf": int(hit.sum()),
        "host_shift_in_leaf": float(np.abs(d[hit] - 0.5).max()),
        "host_shift_elsewhere": float(np.abs(d[~hit]).max()),
        "device_leaf_value_err": abs(dev_v - (v + 0.5)),
        "card_predict_vs_host": card_err}
    s = line["set_leaf_output"]
    if not (s["host_shift_in_leaf"] < 1e-9 and s["host_shift_elsewhere"] == 0
            and s["device_leaf_value_err"] < 1e-6 and card_err < 1e-5):
        raise AssertionError(f"api_booster: set_leaf_output {s}")
    # refit on the validation rows, on the card and on the CPU
    text = bst.model_to_string()
    t0 = time.perf_counter()
    r_card = bst.refit(Xv, yv)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_cpu = lgb.Booster(params={"device_type": "cpu"},
                        model_str=text).refit(Xv, yv)
    t_cpu = time.perf_counter() - t0
    leaf_err = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                   for a, b in zip(r_card._gbdt.models, r_cpu._gbdt.models))
    changed = max(float(np.abs(a.leaf_value - b.leaf_value).max())
                  for a, b in zip(r_card._gbdt.models, gb.models))
    line["refit"] = {"rows": int(len(yv)), "seconds_card": t_card,
                     "seconds_cpu": t_cpu, "max_leaf_diff_card_vs_cpu":
                     leaf_err, "tolerance": 1e-5,
                     "max_leaf_change": changed,
                     "source_unchanged": bst.model_to_string() == text}
    if not (leaf_err < 1e-5 and changed > 0
            and line["refit"]["source_unchanged"]):
        raise AssertionError(f"api_booster: refit {line['refit']}")
    del r_card, r_cpu
    # bounds, importances, shuffle
    raw = bst.predict(Xv, raw_score=True)
    lo, hi = bst.lower_bound(), bst.upper_bound()
    line["bounds"] = {"lower": lo, "upper": hi, "raw_min": float(raw.min()),
                      "raw_max": float(raw.max())}
    if not lo <= raw.min() <= raw.max() <= hi:
        raise AssertionError(f"api_booster: bounds {line['bounds']}")
    imp = bst.feature_importance("split")
    names = bst.feature_name()
    footer = text.split("feature_importances:\n")[1].split("\n\n")[0]
    from_text = {k: int(v) for k, v in
                 (ln.split("=") for ln in footer.strip().splitlines())}
    ours = {names[i]: int(imp[i]) for i in range(len(names)) if imp[i] > 0}
    line["feature_importance_equals_text"] = ours == from_text
    if ours != from_text:
        raise AssertionError(f"api_booster: importances {ours} {from_text}")
    sb = lgb.Booster(model_str=text)
    np.random.seed(0)
    sb.shuffle_models()
    order_changed = [t.leaf_value[0] for t in sb._gbdt.models] != \
        [t.leaf_value[0] for t in gb.models]
    sh = float(np.abs(sb.predict(rows, raw_score=True) - p0).max())
    line["shuffle_models"] = {"order_changed": order_changed,
                              "max_abs_pred_diff": sh}
    emit(line)
    if not (order_changed and sh < 1e-6):
        raise AssertionError(f"api_booster: shuffle {line['shuffle_models']}")
    return line


ONEHOT_FIELDS, ONEHOT_LEVELS = 20, 50


def onehot_csr(rows: int, valid_rows: int, seed: int = 29):
    """(train CSR, label, validation CSR, label): rows x 1,000 one-hot
    columns, 20 fields of 50 levels each from RandomState(seed), a field's
    level frequencies Zipf-like (1 / rank^1.2, the ranks in a random
    order), 20 non-zeros a row; the label from a logistic model over the
    levels (a weight per level, the logit centred on its median)."""
    import numpy as np
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    F, V = ONEHOT_FIELDS, ONEHOT_LEVELS
    n = rows + valid_rows
    levels = np.empty((n, F), np.int32)
    for f in range(F):
        p = 1.0 / np.arange(1, V + 1) ** 1.2
        p = p[rs.permutation(V)]
        levels[:, f] = rs.choice(V, size=n, p=p / p.sum())
    w = rs.randn(F, V) * 0.6
    logit = w[np.arange(F), levels].sum(axis=1)
    logit -= np.median(logit)
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    cols = (levels + np.arange(F, dtype=np.int32) * V).ravel()
    m = sp.csr_matrix((np.ones(n * F, np.float32), cols,
                       np.arange(0, n * F + 1, F)), shape=(n, F * V))
    return m[:rows], y[:rows], m[rows:], y[rows:]


def api_sparse_phase(torch, lgb, np, ch):
    """A 1M x 1,000 one-hot CSR (onehot_csr) built into a Dataset without
    densifying it (its toarray raises), EFB folding each field into few
    columns; 10 trees on the fused loop with validation AUC rising; a
    20,000-row slice trained on the card and on the CPU, predictions
    within 1e-4."""
    import scipy.sparse as sp

    class NoDense(sp.csr_matrix):
        def toarray(self, *a, **k):
            raise AssertionError("api_sparse: the CSR input was densified")

    t0 = time.perf_counter()
    Xs, ys, Xsv, ysv = onehot_csr(1_000_000, 100_000)
    t_make = time.perf_counter() - t0
    train_csr = NoDense(Xs)
    params = dict(API_PARAMS)
    t0 = time.perf_counter()
    ds = lgb.Dataset(train_csr, label=ys).construct()
    t_construct = time.perf_counter() - t0
    b = ds._binned
    vs = lgb.Dataset(Xsv, label=ysv, reference=ds)
    ev = {}
    ch.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, 10, valid_sets=[vs], valid_names=["valid"],
                    evals_result=ev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in ch.LAUNCHES.items() if v}
    auc = ev["valid"]["auc"]
    fused = bst._gbdt._fused
    preds = {}
    for device in ("cuda", "cpu"):
        p = dict(params, num_leaves=31, device_type=device)
        small = lgb.Dataset(Xs[:20000], label=ys[:20000], params=p)
        preds[device] = lgb.train(p, small, 5).predict(Xsv[:2000],
                                                       raw_score=True)
    err = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    line = {"phase": "api_sparse", "rows": Xs.shape[0],
            "columns": Xs.shape[1], "nnz": int(Xs.nnz),
            "make_seconds": t_make, "construct_seconds": t_construct,
            "used_features": int(b.num_used_features),
            "bundled_columns": int(b.bins.shape[0]),
            "col_bins": int(b.col_bins), "trees": bst.num_trees(),
            "train_seconds": dt, "trees_per_s": bst.num_trees() / dt,
            "fused_captured": bool(fused is not None and fused.graph.captured),
            "valid_auc": auc, "launches": launches,
            "small_max_abs_pred_diff_card_vs_cpu": err, "tolerance": 1e-4}
    emit(line)
    if not (fused is not None and fused.graph.captured):
        raise AssertionError("api_sparse: the fused loop did not capture")
    if not auc[-1] > auc[0]:
        raise AssertionError(f"api_sparse: AUC did not rise: {auc}")
    if not err < 1e-4:
        raise AssertionError(f"api_sparse: card and CPU differ by {err}")
    if not all(launches.get(k, 0) > 0 for k in ("hist_round", "take_small")):
        raise AssertionError(f"api_sparse: launches {launches}")
    return line


def api_file_phase(torch, lgb, np, X, y):
    """The first 100,000 rows (200,000 before; halved to keep the script
    inside its limit) written as CSV with a header, as TSV and as
    LibSVM (%.17g: the float64 values exactly), each read back through
    Dataset(path): the numpy Dataset's bin matrix and, after 5 trees, its
    model text bit for bit; save_binary -> Dataset(bin_path) and a .weight
    sidecar (against weight=) give the same model too. The files go
    through the native library's parsers (it must be loaded): each
    format's parse seconds and rows/s (parsers.load_text_file alone),
    and the CSV also through np.loadtxt (the Python path) in the same
    run, its matrix bit for bit the native one's."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.parsers import load_text_file

    if native.get_lib() is None:
        raise AssertionError(f"api_file: the native library is not loaded: "
                             f"{native.BUILD_ERROR}")
    out = Path("build") / "chip_smoke" / "api_file"
    out.mkdir(parents=True, exist_ok=True)
    n, f = min(50_000, len(y)), X.shape[1]
    Xf = np.asarray(X[:n], np.float64)
    yf = np.asarray(y[:n], np.float64)
    rows = np.column_stack([yf, Xf])
    names = [f"Column_{i}" for i in range(f)]
    header = {"header": True}
    write_s, paths = {}, {}
    for fmt, delim in (("csv", ","), ("tsv", "\t")):
        paths[fmt] = out / f"train.{fmt}"
        t0 = time.perf_counter()
        with open(paths[fmt], "w") as fh:
            fh.write(delim.join(["label"] + names) + "\n")
            np.savetxt(fh, rows, delimiter=delim, fmt="%.17g")
        write_s[fmt] = time.perf_counter() - t0
    paths["libsvm"] = out / "train.svm"
    t0 = time.perf_counter()
    np.savetxt(paths["libsvm"], rows, fmt="%.17g " + " ".join(
        f"{j}:%.17g" for j in range(f)))
    write_s["libsvm"] = time.perf_counter() - t0
    params = dict(API_PARAMS, metric="auc")

    def model(ds):
        return lgb.train(params, ds, 5).model_to_string()

    refs = {}
    for key, p in (("header", header), ("plain", {})):
        ds = lgb.Dataset(Xf, label=yf, params=p).construct()
        refs[key] = (ds, model(ds))
    result = {}
    for fmt in ("csv", "tsv", "libsvm"):
        key = "plain" if fmt == "libsvm" else "header"
        ref_ds, ref_text = refs[key]
        t0 = time.perf_counter()
        ds = lgb.Dataset(str(paths[fmt]),
                         params=header if key == "header" else {})
        ds.construct()
        parse_s = time.perf_counter() - t0
        b, rb = ds._binned, ref_ds._binned
        t0 = time.perf_counter()
        parsed = load_text_file(str(paths[fmt]), header=key == "header")
        native_s = time.perf_counter() - t0
        result[fmt] = {
            "write_seconds": write_s[fmt], "construct_seconds": parse_s,
            "native_parse_seconds": native_s,
            "native_rows_per_s": n / native_s,
            "bins_equal": bool(np.array_equal(b.bins, rb.bins)),
            "model_text_equal": model(ds) == ref_text}
        if fmt == "csv":
            t0 = time.perf_counter()
            plain = np.loadtxt(paths[fmt], delimiter=",", skiprows=1,
                               dtype=np.float64, ndmin=2)
            result[fmt]["np_loadtxt_seconds"] = time.perf_counter() - t0
            result[fmt]["native_equals_loadtxt"] = bool(np.array_equal(
                np.column_stack([parsed["label"], parsed["X"]]), plain))
    bin_path = out / "train.bin"
    refs["plain"][0].save_binary(bin_path)
    t0 = time.perf_counter()
    ds = lgb.Dataset(str(bin_path)).construct()
    result["binary"] = {"load_seconds": time.perf_counter() - t0,
                        "model_text_equal": model(ds) == refs["plain"][1]}
    w = np.random.RandomState(31).uniform(0.5, 1.5, n)
    wpath = out / "weighted.csv"
    np.savetxt(wpath, rows, delimiter=",", fmt="%.17g")
    np.savetxt(str(wpath) + ".weight", w, fmt="%.17g")
    with_weight = model(lgb.Dataset(Xf, label=yf, weight=w))
    result["weight_sidecar"] = {
        "model_text_equal": model(lgb.Dataset(str(wpath))) == with_weight}
    line = {"phase": "api_file", "rows": n, "features": f,
            "reduced": "rows 200,000 -> 100,000", **result}
    emit(line)
    bad = {k: v for k, v in result.items()
           if not all(v.get(c, True) for c in ("bins_equal",
                                                "model_text_equal",
                                                "native_equals_loadtxt"))}
    if bad:
        raise AssertionError(f"api_file: {bad}")
    return line


DATA_PLANE_LINES = ("[data_source", "[ram_budget_mb", "[data_chunk_rows",
                    "[data_spool_dir")


def _strip_data_lines(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(DATA_PLANE_LINES))


def data_plane_phase(torch, lgb, ch, np, X, y, Xv, ds, params, smi):
    """The out-of-core data plane (lightgbm_tpu_torch/data/) on the train
    phase's rows: data_source=chunked with ram_budget_mb=64 (73,728-row
    chunks, 14 of them; the raw float32 matrix 112 MB) spools X to disk,
    bins it in two passes and assembles the card's matrix from pinned
    slots on a copy stream; two fused trees on it and two on the train
    phase's in-RAM set must give the same model text (apart from the
    data-plane parameter lines), bitwise the same raw predictions on 4,096
    validation rows and bitwise the same device bins, with the
    assembly's steady-state RSS spread at most 64 MB and hist_nat,
    hist_round, seg_sum and take_small launched by the streamed fit. The
    assembly runs again at prefetch depth 1 (each pinned slot waits for
    its copy before it is refilled): the same bins. A 50,000-row CSV of
    the same rows is read three ways, each training 2 trees on the card:
    the chunked text spool (data_chunk_rows=8192), bitwise the in-RAM
    text fit; and a two_round construct, whose bins equal the CPU
    construct's of the same file. The in-RAM set's device_arrays time is
    timed beside the assembly's, and the link's rate from pinned memory
    (the matrix's stored bytes in one copy, and one chunk's) beside its
    copies'."""
    import shutil

    from lightgbm_tpu_torch.data import last_stats, reset_stats, streaming

    out = Path("build") / "chip_smoke" / "data_plane"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pc = {**params, "data_source": "chunked", "ram_budget_mb": 64,
          "data_spool_dir": str(out / "chunked")}
    reset_stats()
    t0 = time.perf_counter()
    dc = lgb.Dataset(X, label=y, params=pc)
    dc.construct()
    construct_s = time.perf_counter() - t0
    ch.reset_launch_counts()
    t0 = time.perf_counter()
    bc = lgb.train(pc, dc, 2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {k: ch.LAUNCHES[k]
                for k in ("hist_nat", "hist_round", "seg_sum", "take_small")}
    st = last_stats()
    asm = st["assemble"]

    # the in-RAM set's device matrix, assembled again and timed; the train
    # phase's dict goes back afterwards
    rb = ds._binned
    saved = rb._device
    rb._device = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_r = rb.device_arrays("cuda")
    torch.cuda.synchronize()
    inram_s = time.perf_counter() - t0
    rb._device = saved
    br = lgb.train(params, ds, 2)
    rows = Xv[:4096]
    text_equal = (_strip_data_lines(bc.model_to_string())
                  == _strip_data_lines(br.model_to_string()))
    pred_equal = bool(np.array_equal(bc.predict(rows, raw_score=True),
                                      br.predict(rows, raw_score=True)))
    bins_equal = bool(torch.equal(dc._binned.device_arrays("cuda")["bins"],
                                  dev_r["bins"]))

    # depth 1: a slot is refilled only after its copy has completed
    real_depth = streaming.prefetch_depth
    streaming.prefetch_depth = lambda *a: 1
    try:
        dc._binned._device = None
        dev1 = dc._binned.device_arrays("cuda")
    finally:
        streaming.prefetch_depth = real_depth
    asm1 = last_stats()["assemble"]
    depth1_equal = bool(torch.equal(dev1["bins"], dev_r["bins"]))
    del dev1, dev_r

    # the link beside the assembly: the matrix's stored bytes from pinned
    # memory in one copy, and one chunk's (median of 5 each)
    host = torch.empty(int(asm["h2d_bytes"]), dtype=torch.uint8,
                       pin_memory=True)
    card = torch.empty_like(host, device="cuda")
    link = {}
    for key, nb in (("whole", host.numel()),
                    ("chunk", X.shape[1] * asm["chunk_rows"])):
        ms = cuda_ms(lambda: card[:nb].copy_(host[:nb], non_blocking=True),
                     reps=5, warm=1)
        link[key] = {"bytes": int(nb), "ms": ms, "gb_per_s": nb / ms / 1e6}
    del host, card

    # the text inputs: 50,000 rows as CSV (%.17g: the float64 values)
    n = 50_000
    csv = out / "train.csv"
    np.savetxt(csv, np.column_stack([y[:n], X[:n]]).astype(np.float64),
               delimiter=",", fmt="%.17g")
    pt = {**params, "data_source": "chunked", "data_chunk_rows": 8192,
          "data_spool_dir": str(out / "text")}
    reset_stats()
    t0 = time.perf_counter()
    dtc = lgb.Dataset(str(csv), params=pt)
    btc = lgb.train(pt, dtc, 2)
    text_chunked_s = time.perf_counter() - t0
    text_spool = last_stats()["spool"]
    t0 = time.perf_counter()
    btr = lgb.train(params, lgb.Dataset(str(csv), params=params), 2)
    text_inram_s = time.perf_counter() - t0
    p2 = {**params, "two_round": True}
    t0 = time.perf_counter()
    d2 = lgb.Dataset(str(csv), params=p2)
    b2 = lgb.train(p2, d2, 2)
    two_round_s = time.perf_counter() - t0
    d2cpu = lgb.Dataset(str(csv), params={**p2, "device_type": "cpu"})
    d2cpu.construct()
    text = {
        "rows": n, "chunks": text_spool["chunks"],
        "spool_rows_per_s": text_spool["rows_per_sec"],
        "chunked_seconds": text_chunked_s, "inram_seconds": text_inram_s,
        "two_round_seconds": two_round_s,
        "chunked_model_text_equal": (
            _strip_data_lines(btc.model_to_string())
            == _strip_data_lines(btr.model_to_string())),
        "chunked_predictions_equal": bool(np.array_equal(
            btc.predict(rows, raw_score=True),
            btr.predict(rows, raw_score=True))),
        "two_round_bins_equal_cpu": bool(np.array_equal(
            d2._binned.bins, d2cpu._binned.bins)),
        "two_round_finite": bool(np.isfinite(b2.predict(rows)).all()),
        "trees": [btc.num_trees(), btr.num_trees(), b2.num_trees()]}
    gbps = lambda a: (a["h2d_bytes"] / a["h2d_seconds"] / 1e9
                      if a["h2d_seconds"] else None)
    line = {"phase": "data_plane", "nvidia_smi": smi,
            "rows": int(X.shape[0]), "features": int(X.shape[1]),
            "raw_mb": X.nbytes / 2 ** 20, "ram_budget_mb": 64,
            "chunks": asm["chunks"], "chunk_rows": asm["chunk_rows"],
            "prefetch_depth": asm["prefetch_depth"],
            "spool_rows_per_s": st["spool"]["rows_per_sec"],
            "spool_seconds": st["spool"]["seconds"],
            "pass1_seconds": st["pass1"]["seconds"],
            "pass2_seconds": st["pass2"]["seconds"],
            "pass2_rows_per_s": st["pass2"]["rows_per_sec"],
            "construct_seconds": construct_s,
            "assemble_seconds": asm["seconds"],
            "h2d_bytes": asm["h2d_bytes"], "h2d_seconds": asm["h2d_seconds"],
            "h2d_gb_per_s": gbps(asm), "pinned_link": link,
            "h2d_ms_per_chunk": [c["h2d_ms"] for c in asm["per_chunk"]],
            "pinned_mb": asm["pinned_mb"],
            "peak_rss_mb": asm["peak_rss_mb"],
            "rss_spread_mb": asm["rss_spread_mb"],
            "inram_device_arrays_seconds": inram_s,
            "train_2_trees_seconds": train_s, "launches": launches,
            "model_text_equal": text_equal, "predictions_equal": pred_equal,
            "bins_equal": bins_equal,
            "depth1": {"chunks": asm1["chunks"],
                       "prefetch_depth": asm1["prefetch_depth"],
                       "assemble_seconds": asm1["seconds"],
                       "h2d_gb_per_s": gbps(asm1),
                       "bins_equal": depth1_equal},
            "text": text}
    emit(line)
    bad = [k for k, ok in (
        ("model_text_equal", text_equal), ("predictions_equal", pred_equal),
        ("bins_equal", bins_equal), ("depth1_bins_equal", depth1_equal),
        ("chunks", asm["chunks"] == 14 and asm1["prefetch_depth"] == 1),
        ("rss_spread_mb", asm["rss_spread_mb"] <= 64.0),
        ("h2d_bytes", asm["h2d_bytes"] == X.shape[0] * X.shape[1]),
        ("launches", all(v > 0 for v in launches.values())),
        ("text", all(text[k] for k in (
            "chunked_model_text_equal", "chunked_predictions_equal",
            "two_round_bins_equal_cpu", "two_round_finite"))
         and text["trees"] == [2, 2, 2]))
        if not ok]
    if bad:
        raise AssertionError(f"data_plane: {bad}")
    return line


def cli_phase(torch, lgb, np, ds, vs, Xv, yv, n_serve: int = 5):
    """The command line at the Higgs-like width (1M x 28, 255 leaves,
    max_bin 255), on binary caches of the train phase's data written by
    save_binary: python -m lightgbm_tpu_torch task=train with
    snapshot_freq=5 and resume=auto (10 trees, validation AUC), first
    under the fault plan round:7:kill (LGBMTPU_FAULT_PLAN: it must die by
    SIGKILL and leave the checkpoint of round 5), then the same command
    again (it resumes), each in a process of its own; then a clean run
    in another directory: the resumed model file bit for bit the clean
    one, both on the fused loop (their manifests' phase timers hold its
    round span). Then task=predict (on the card: the tensorized forest)
    on the validation rows against the host walker (Booster.predict)
    within 1e-5, and task=serve over stdio with
    fault_plan=device_put:2:raise and host_fallback=true: the faulted
    request's scores (the host walker's) against the device answers to
    the same rows within 1e-5. The clean run, predict and serve call
    cli.main in this process (the same entry point without a process's
    ~10 s start; cut to keep the script inside its limit). Last,
    task=loop over stdio in a process of its own on the clean model: a
    50,000-row microbatch of the same concept through the ingest op, one
    verdict cycle (it must promote: the models op then reads version 2
    active), quit. Wall seconds of each command, the snapshot round's ms
    (the manifest's timer)."""
    out = Path("build") / "chip_smoke" / "cli"
    out.mkdir(parents=True, exist_ok=True)
    ds.save_binary(out / "train.bin")
    vs.save_binary(out / "valid.bin")
    conf = "\n".join([
        "task = train", "data = ../train.bin", "valid_data = ../valid.bin",
        "objective = binary", "metric = auc", f"num_leaves = {L}",
        "max_bin = 255", "learning_rate = 0.1", "min_data_in_leaf = 20",
        "num_trees = 10", "snapshot_freq = 5", "resume = auto",
        "output_model = model.txt", "verbosity = -1", ""])
    env = dict(os.environ, PYTHONPATH=str(Path.cwd().resolve()))
    env.pop("LGBMTPU_FAULT_PLAN", None)

    def run(cwd, args, plan=None, timeout=300):
        """python -m lightgbm_tpu_torch in a process of its own."""
        e = dict(env, **({"LGBMTPU_FAULT_PLAN": plan} if plan else {}))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                            *args], cwd=cwd, env=e, capture_output=True,
                           text=True, timeout=timeout)
        return p, time.perf_counter() - t0

    def run_here(cwd, args, stdin=""):
        """The same entry point, cli.main, in this process (no interpreter
        and CUDA start): stdin and stdout swapped for the call, the phase
        timer that timetag turns on reset before and after it."""
        import io

        from lightgbm_tpu_torch import cli
        from lightgbm_tpu_torch.resilience import faultinject
        from lightgbm_tpu_torch.timer import global_timer

        here, saved = os.getcwd(), (sys.stdin, sys.stdout)
        out = io.StringIO()
        global_timer.reset()
        t0 = time.perf_counter()
        try:
            os.chdir(cwd)
            sys.stdin, sys.stdout = io.StringIO(stdin), out
            rc = cli.main(list(args))
        finally:
            sys.stdin, sys.stdout = saved
            os.chdir(here)
            global_timer.disable()
            global_timer.reset()
            faultinject.disarm()
        return rc, out.getvalue(), time.perf_counter() - t0

    walls = {}
    for d in ("crashed", "clean"):
        (out / d).mkdir(exist_ok=True)
        for f in (out / d).iterdir():
            f.unlink()
        (out / d / "train.conf").write_text(conf)
    train_args = ["config=train.conf", "timetag=true",
                  "run_manifest=manifest.json"]
    p, walls["train_killed"] = run(out / "crashed", train_args,
                                   plan="round:7:kill")
    killed = p.returncode == -9 and not (out / "crashed" / "model.txt"
                                         ).exists()
    state = json.loads((out / "crashed" / "model.txt.ckpt").read_text())
    ckpt_round = state["engine_round"]
    p2, walls["train_resumed"] = run(out / "crashed", train_args)
    if p2.returncode != 0:
        raise AssertionError(f"cli train failed: {p2.stderr[-3000:]}")
    rc3, _, walls["train_clean_in_process"] = run_here(out / "clean",
                                                       train_args)
    resumed = (out / "crashed" / "model.txt").read_bytes()
    clean = (out / "clean" / "model.txt").read_bytes()
    timers = {d: json.loads((out / d / "manifest.json").read_text()
                            )["phase_timers"] for d in ("crashed", "clean")}
    fused = all("round: fused step" in t for t in timers.values())
    snap = timers["clean"].get("snapshot", {"seconds": 0.0, "calls": 0})
    # predict: the validation rows as a text file
    np.savetxt(out / "valid.tsv", np.column_stack([np.zeros(len(Xv)), Xv]),
               delimiter="\t", fmt="%.17g")
    from lightgbm_tpu_torch.learner import cuda_hist

    # the traversal's launches (read as a difference: no count is reset)
    taken = cuda_hist.LAUNCHES["take_small"]
    rc4, _, walls["predict_in_process"] = run_here(out / "clean", [
        "task=predict", "data=../valid.tsv", "input_model=model.txt",
        "output_result=pred.txt"])
    taken = cuda_hist.LAUNCHES["take_small"] - taken
    ref = lgb.Booster(model_file=str(out / "clean" / "model.txt"))
    pred_err = float(np.abs(np.loadtxt(out / "clean" / "pred.txt")
                            - ref.predict(Xv)).max())
    # serve: the same rows in every request; the second is faulted
    rows = np.asarray(Xv[:n_serve], np.float64).tolist()
    reqs = [{"op": "ping"}] + [{"op": "score", "rows": rows,
                                "raw_score": True}] * 3 + [{"op": "quit"}]
    rc5, served, walls["serve_in_process"] = run_here(out / "clean", [
        "task=serve", "input_model=model.txt", "host_fallback=true",
        "fault_plan=device_put:2:raise", "serve_buckets=16,64"],
        stdin="".join(json.dumps(r) + "\n" for r in reqs))
    if (rc3, rc4, rc5) != (0, 0, 0):
        raise AssertionError(f"cli: train / predict / serve returned "
                             f"{(rc3, rc4, rc5)}")
    loop_line = cli_loop_process(np, out / "clean", env, Xv, yv, walls)
    resp = [json.loads(x) for x in served.splitlines() if x.strip()]
    scores = [np.asarray(r["pred"], np.float64) for r in resp[1:4]]
    fallback_err = float(np.abs(scores[1] - scores[0]).max())
    device_err = float(np.abs(scores[2] - scores[0]).max())
    line = {"phase": "cli", "rows": ds.num_data(), "features": 28,
            "num_leaves": L, "trees": 10, "killed_by_sigkill": killed,
            "checkpoint_round": ckpt_round,
            "resumed_equals_clean": resumed == clean, "fused_loop": fused,
            "wall_seconds": walls,
            "snapshot_ms_per_round": (1000 * snap["seconds"]
                                      / max(snap["calls"], 1)),
            "snapshot_rounds": snap["calls"],
            "predict_rows": len(Xv), "predict_card_vs_host": pred_err,
            "predict_take_small_launches": taken,
            "serve_ok": all(r.get("ok") for r in resp),
            "serve_fallback_vs_device": fallback_err,
            "serve_device_vs_device": device_err, "tolerance": 1e-5,
            "loop_process": loop_line}
    emit(line)
    if not (killed and ckpt_round == 5 and resumed == clean and fused):
        raise AssertionError(f"cli: kill / resume failed: {line} "
                             f"{p.stderr[-2000:]}")
    if not (pred_err < 1e-5 and taken > 0 and line["serve_ok"]
            and len(resp) == 5
            and fallback_err < 1e-5):
        raise AssertionError(f"cli: predict / serve failed: {line}")
    if not (loop_line["rc"] == 0 and loop_line["outcome"] == "promoted"
            and loop_line["active_version"] == 2):
        raise AssertionError(f"cli: task=loop failed: {loop_line}")
    return line


def cli_loop_process(np, cwd, env, Xv, yv, walls, hold_rows=20_000):
    """python -m lightgbm_tpu_torch task=loop over stdio in cwd (on its
    model.txt, the holdout the first hold_rows validation rows with
    their labels): one 50,000-row microbatch (higgs_batch, seed 111)
    through the ingest op, then, once the loop's state records a
    verdict, the models op and quit. Its stderr goes to loop.log."""
    import shutil

    np.savetxt(cwd / "holdout.tsv", np.column_stack(
        [yv[:hold_rows], Xv[:hold_rows]]), delimiter="\t", fmt="%.9g")
    shutil.rmtree(cwd / "loop", ignore_errors=True)
    Xb, yb = higgs_batch(50_000, 111)
    args = ["task=loop", "input_model=model.txt",
            "valid_data=holdout.tsv", "loop_dir=loop",
            "serve_buckets=16,64"] + [f"{k}={v}"
                                      for k, v in LOOP_PARAMS.items()]
    state = cwd / "loop" / "loop_state.json"
    t0 = time.perf_counter()
    with open(cwd / "loop.log", "w") as err:
        p = subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch",
                              *args], cwd=cwd, env=env, text=True,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             stderr=err)
        try:
            p.stdin.write(json.dumps({"op": "ingest", "rows": Xb.tolist(),
                                      "labels": yb.tolist()}) + "\n")
            p.stdin.flush()
            while time.perf_counter() - t0 < 300 and p.poll() is None:
                if state.exists() and json.loads(
                        state.read_text())["cycle"] >= 1:
                    break
                time.sleep(0.2)
            out, _ = p.communicate(
                json.dumps({"op": "models"}) + "\n"
                + json.dumps({"op": "quit"}) + "\n", timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
    walls["loop_process"] = time.perf_counter() - t0
    resp = [json.loads(x) for x in out.splitlines() if x.strip()]
    st = json.loads(state.read_text()) if state.exists() else {}
    models = [r for r in resp if "models" in r]
    return {"rc": p.returncode, "responses": len(resp),
            "ingest_ok": bool(resp and resp[0].get("ok")),
            "outcome": st.get("last_outcome"), "version": st.get("version"),
            "holdout_auc": st.get("incumbent_metrics"),
            "active_version": (models[0]["models"]["default"]["active"]
                               if models else None),
            "log_tail": (cwd / "loop.log").read_text()[-1500:]
            if p.returncode else ""}


def fallback_latency(np, lgb, model_path, Xv, n_rows=(1, 1000), reps=20):
    """Device answers against host-fallback answers in one process: a
    registry on the card with host_fallback=True, each request scored
    normally and with its device call faulted (device_put:1:raise armed
    before each), median ms of each."""
    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.serving import ModelRegistry

    reg = ModelRegistry(buckets=(16, 1024), warmup=True, host_fallback=True)
    reg.load("m", str(model_path))
    out = {}
    for n in n_rows:
        X = np.asarray(Xv[:n], np.float32)
        dev, host = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            a = reg.predict("m", X, raw_score=True)
            dev.append(time.perf_counter() - t0)
            faultinject.arm("device_put:1:raise")
            t0 = time.perf_counter()
            b = reg.predict("m", X, raw_score=True)
            host.append(time.perf_counter() - t0)
        faultinject.disarm()
        out[str(n)] = {"device_ms": 1000 * statistics.median(dev),
                       "fallback_ms": 1000 * statistics.median(host),
                       "max_abs_diff": float(np.abs(a - b).max())}
    return out


_CONCEPT_W = {}


def higgs_batch(rows: int, seed: int, feats: int = 28,
                concept_rows: int = 1_000_000):
    """Fresh rows of the Higgs-like concept of higgs_like(concept_rows):
    the weight vector w that higgs_stream draws after its X (so the same
    RandomState(17) stream), features, noise and labels from
    RandomState(seed). The online loop's microbatches."""
    import numpy as np

    key = (concept_rows, feats)
    if key not in _CONCEPT_W:
        rs = np.random.RandomState(17)
        rs.standard_normal((concept_rows, feats))
        _CONCEPT_W[key] = rs.randn(feats)
    w = _CONCEPT_W[key]
    r = np.random.RandomState(seed)
    X = r.randn(rows, feats).astype(np.float32)
    logits = X[:, : feats // 2] @ w[: feats // 2] + np.sin(X[:, feats // 2]) * 2.0
    z = (logits + r.randn(rows)).astype(np.float32)
    return X, (z > 0).astype(np.float32)


LOOP_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": L,
               "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 20,
               "verbosity": -1, "loop_rounds": 10, "loop_min_rows": 50_000}
# the online loop's microbatches: (kind, seed); kind names the labels
LOOP_BATCHES = (("clean", 101), ("nan", 102), ("flip", 103), ("clean", 104))
LOOP_KERNELS = ("hist_nat", "hist_round", "seg_sum", "take_small")


def _pcts(lat):
    return {"requests": len(lat), "p50_ms": 1e3 * _pct(lat, 0.50),
            "p99_ms": 1e3 * _pct(lat, 0.99)}


class _Scorers:
    """Two threads scoring 1-256-row requests of a fixed pool through a
    registry while ``run`` is set: each answer with its rows and latency,
    tagged by whether a verdict cycle was running when it was sent."""

    def __init__(self, np, reg, pool, seed=0):
        import threading

        self.np, self.reg, self.pool = np, reg, pool
        self.in_cycle = threading.Event()
        self.run = threading.Event()
        self.stop = threading.Event()
        self.answers, self.errors = [], []
        self.threads = [threading.Thread(target=self._run, args=(seed + i,),
                                         daemon=True) for i in range(2)]
        for t in self.threads:
            t.start()

    def _run(self, seed):
        rs = self.np.random.RandomState(seed)
        while not self.stop.is_set():
            if not self.run.wait(0.05):
                continue
            n = int(rs.randint(1, 257))
            a = int(rs.randint(0, len(self.pool) - n + 1))
            during = self.in_cycle.is_set()
            t0 = time.perf_counter()
            try:
                p = self.reg.predict("default", self.pool[a:a + n],
                                     raw_score=True)
            except Exception as e:  # noqa: BLE001 — shown by the phase
                self.errors.append(repr(e))
                return
            self.answers.append((a, n, self.np.asarray(p, self.np.float64),
                                 time.perf_counter() - t0, during))

    def close(self):
        self.run.clear()
        self.stop.set()
        for t in self.threads:
            t.join(timeout=60)


def online_loop_phase(torch, lgb, ch, np, Xv, yv, v0_path):
    """The online train-and-serve loop on the card (online/, ROADMAP
    A.11): v0 is the cli phase's clean 10-tree model, the holdout the
    100,000 validation rows (metric auc); a card registry serves while
    four cycles refit 10 trees of 255 leaves on 50,000 fresh rows of v0's
    concept each (higgs_batch, seeds 101-104): clean -> promoted, NaN
    labels -> rolled_back, flipped labels -> rejected, clean ->
    promoted; the first arrives through the serving ingest op over HTTP.
    Two threads score 1-256-row requests through the registry the whole
    time: every answer within 1e-5 of v(n)'s or v(n+1)'s host walker (0
    torn), p50 / p99 inside the cycles and in a window outside them.
    Then a raise at loop_refit on a fifth cycle: a new OnlineLoop and
    registry on the same directory serve the last promotion's bits; the
    restarted loop refits the fifth batch twice (the same candidate text,
    byte for byte) and replays the cycle. Per cycle: seconds of the
    margins, the refit (its capture s, trees/s), the evaluation and the
    promotion (the registry's load with its warm-up captures); holdout
    AUC per version; the kernels' launches over the replayed cycle, with
    no scorer running (torch.profiler's kernel symbols, CUDA graph
    replays included), and the launch counters over the phase (reset
    before it). The scorers pause while a batch is drawn and spooled."""
    import shutil
    import threading
    import urllib.request

    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch import online
    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.resilience.errors import InjectedFault
    from lightgbm_tpu_torch.serving import ModelRegistry, serve_http

    d = Path("build") / "chip_smoke" / "online_loop"
    shutil.rmtree(d, ignore_errors=True)
    params = dict(LOOP_PARAMS, loop_dir=str(d))
    hold = (Xv, yv)
    pool = np.asarray(Xv[:1024], np.float32)
    ch.reset_launch_counts()
    t_phase = time.perf_counter()
    loop = online.OnlineLoop(params, hold, initial_model=str(v0_path))
    reg = ModelRegistry(buckets=(16, 64, 256), warmup=True)
    loop.attach(reg)
    httpd = serve_http(reg, 0, block=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    versions = {0: lgb.Booster(model_file=str(v0_path))}
    host = {0: versions[0].predict(pool, raw_score=True)}
    scorers = _Scorers(np, reg, pool)
    scorers.run.set()
    time.sleep(1.0)  # the window outside any cycle
    scorers.run.clear()
    cycles, auc = [], {}
    try:
        for i, (kind, seed) in enumerate(LOOP_BATCHES):
            t_spool = time.perf_counter()
            Xb, yb = higgs_batch(50_000, seed)
            labels = {"nan": np.full(len(yb), np.nan),
                      "flip": 1.0 - yb}.get(kind, yb)
            body = {"rows": Xb.tolist(), "labels": labels.tolist()}
            if i == 0:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}/v1/ingest",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    if not json.loads(r.read())["ok"]:
                        raise AssertionError("online_loop: ingest refused")
            else:
                loop.spool.append(body["rows"], body["labels"])
            del body
            t_cycle = time.perf_counter()
            scorers.in_cycle.set()
            scorers.run.set()
            outcome = loop.cycle()
            scorers.run.clear()
            scorers.in_cycle.clear()
            t_end = time.perf_counter()
            lc = dict(loop.last_cycle)
            v = loop.state["version"]
            if v not in versions:
                versions[v] = lgb.Booster(model_file=loop.state["model_path"])
                host[v] = versions[v].predict(pool, raw_score=True)
            cand = lc["candidate_metrics"]
            cycles.append({
                "kind": kind, "outcome": outcome, "serving_version": v,
                "rows": lc["rows"], "spool_s": t_cycle - t_spool,
                "cycle_s": t_end - t_cycle, "margins_s": lc["margins_s"],
                "refit_s": lc["refit_s"],
                "refit_capture_s": lc["refit_capture_s"],
                "refit_trees_per_s": (LOOP_PARAMS["loop_rounds"]
                                      / lc["refit_s"]),
                "eval_s": lc["eval_s"], "promote_ms": 1e3 * lc["promote_s"],
                "candidate_auc": cand[0] if cand else None,
                "incumbent_auc": lc["incumbent_metrics"][0]})
            auc[v] = (cand[0] if outcome == "promoted"
                      else lc["incumbent_metrics"][0])
        auc[0] = cycles[0]["incumbent_auc"]
        served = np.asarray(reg.predict("default", pool, raw_score=True))
    finally:
        scorers.close()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    launches = {k: ch.LAUNCHES[k] for k in LOOP_KERNELS}
    # torn answers: neither the serving version's nor the next one's
    torn = 0
    vs = sorted(host)
    for a, n, p, _, _ in scorers.answers:
        if not any(np.allclose(p, host[v][a:a + n], rtol=1e-5, atol=1e-5)
                   for v in vs):
            torn += 1
    lat_in = [x[3] for x in scorers.answers if x[4]]
    lat_out = [x[3] for x in scorers.answers if not x[4]]
    # ---- a raise at loop_refit on the fifth cycle, then a restart
    Xb, yb = higgs_batch(50_000, 105)
    loop.spool.append(Xb.tolist(), yb.tolist())
    plan = f"loop_refit:{loop.state['cycle']}:raise"
    faultinject.arm(plan)
    try:
        loop.cycle()
        raised = False
    except InjectedFault:
        raised = True
    finally:
        faultinject.disarm()
    del loop
    t_restart = time.perf_counter()
    re_loop = online.OnlineLoop(params, hold)
    reg2 = ModelRegistry(buckets=(16, 64, 256), warmup=True)
    re_loop.attach(reg2)
    restart_bits = bool(np.array_equal(
        np.asarray(reg2.predict("default", pool, raw_score=True)), served))
    st = re_loop.state
    batches, _ = re_loop.spool.read_from(st["ingest_offset"])
    Xr, yr, wr = online.stack_batches(batches)
    init = re_loop._margins(re_loop._incumbent, Xr)
    first = re_loop._splice(re_loop._train_delta(Xr, yr, wr, init))
    restart_s = time.perf_counter() - t_restart
    # the replay, with no scorer running: the cycle's own kernels (CUDA
    # activity alone: with the CPU's too, this cycle's counts read short
    # and the session took ~28 s on the H100)
    t_replay = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay = re_loop.cycle()
        torch.cuda.synchronize()
    names = {}
    for e in prof.key_averages():
        if "cuda" in str(getattr(e, "device_type", "")).lower():
            names[e.key] = names.get(e.key, 0) + e.count
    prof_launches = {k: sum(c for nm, c in names.items()
                            if FUSED_KERNELS[k] in nm) for k in LOOP_KERNELS}
    replay_times = {k: v for k, v in re_loop.last_cycle.items()
                    if k.endswith("_s")}
    replay_times["profiled_cycle_s"] = time.perf_counter() - t_replay
    second = open(online.model_path(str(d), st["version"] + 1)).read()
    line = {"phase": "online_loop", "holdout_rows": len(yv),
            "batch_rows": 50_000, "num_leaves": L,
            "loop_rounds": LOOP_PARAMS["loop_rounds"],
            "verdicts": [c["outcome"] for c in cycles], "cycles": cycles,
            "holdout_auc_by_version": {str(k): v for k, v in auc.items()},
            "answers": len(scorers.answers), "scorer_errors": scorers.errors,
            "torn_answers": torn,
            "scorers_in_cycles": _pcts(lat_in),
            "scorers_outside": _pcts(lat_out),
            "fault_raised_at_loop_refit": raised,
            "restart_serves_same_bits": restart_bits,
            "restart_version": st["version"], "replay_outcome": replay,
            "replay_cycle_s": replay_times,
            "restart_and_second_refit_s": restart_s,
            "refit_twice_same_text": first == second,
            "launches_counted": launches,
            "launches_profiled_replay_cycle": prof_launches,
            "phase_s": time.perf_counter() - t_phase}
    emit(line)
    if line["verdicts"] != ["promoted", "rolled_back", "rejected",
                            "promoted"]:
        raise AssertionError(f"online_loop: verdicts {line['verdicts']}")
    if torn or scorers.errors or not lat_in or not lat_out:
        raise AssertionError(f"online_loop: {torn} torn answers, errors "
                             f"{scorers.errors[:3]}")
    if not (raised and restart_bits and first == second
            and st["version"] == 2):
        raise AssertionError(f"online_loop: restart / replay failed: "
                             f"{line}")
    if not all(launches[k] > 0 and prof_launches[k] > 0
               for k in LOOP_KERNELS):
        raise AssertionError(f"online_loop: a kernel was not launched: "
                             f"{launches} {prof_launches}")
    return line


def recorder_phase(torch, lgb, np, ds, vs, n_trees: int = 20):
    """The flight recorder on the fused loop: train() with record_file
    and anomaly_policy=warn against train() without, after an untimed
    1-tree run of each, 1 and 1 + n_trees trees each (in turns: off, on,
    on, off), trees/s = n_trees / (the median 1 + n_trees run - the
    median 1-tree run), the walls themselves, and the train graph's nodes
    with the recorder off and on; then 6 recorded trees on both loops
    (a no-op before-iteration callback keeps one eager): the fused
    records equal the eager records key for key, every value bit for
    bit but the timings and the evaluations (device f32 metrics on the
    fused loop, host metrics on the eager loop: within 1e-6)."""
    from lightgbm_tpu_torch.obs.recorder import read_stream

    out = Path("build") / "chip_smoke" / "recorder"
    out.mkdir(parents=True, exist_ok=True)
    base = dict(API_PARAMS)
    rec = dict(base, record_file=str(out / "fused.jsonl"),
               anomaly_policy="warn")
    from lightgbm_tpu_torch import engine
    from lightgbm_tpu_torch.obs.recorder import FlightRecorder

    walls = {"off": {}, "on": {}}
    nodes = {}
    host = {"fused_round": [0.0, 0], "record_write": [0.0, 0]}

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key][0] += time.perf_counter() - t0
                host[key][1] += 1
        return wrapper

    for p in (base, rec):  # untimed: this shape's first calls warm up
        lgb.train(p, ds, 1, valid_sets=[vs], valid_names=["v"])
    orig = engine._ObsHooks.fused_round, FlightRecorder.record
    # the recorder's host work a round: its whole hook (tree stats, the
    # JSON line, the sentinel) and the line's write and flush in it
    engine._ObsHooks.fused_round = timed("fused_round", orig[0])
    FlightRecorder.record = timed("record_write", orig[1])
    try:
        for mode in ("off", "on", "on", "off"):
            p = base if mode == "off" else rec
            for n in (1, 1 + n_trees):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = lgb.train(p, ds, n, valid_sets=[vs], valid_names=["v"])
                torch.cuda.synchronize()
                walls[mode].setdefault(n, []).append(
                    time.perf_counter() - t0)
                nodes[mode] = b._gbdt._fused.graph.nodes
    finally:
        engine._ObsHooks.fused_round, FlightRecorder.record = orig
    tps = {m: n_trees / (statistics.median(w[1 + n_trees])
                         - statistics.median(w[1]))
           for m, w in walls.items()}
    fused = read_stream(str(out / "fused.jsonl"))

    def no_op(env):
        pass

    no_op.before_iteration = True
    paths = {}
    for loop, cbs in (("fused", []), ("eager", [no_op])):
        paths[loop] = str(out / f"{loop}6.jsonl")
        lgb.train(dict(rec, record_file=paths[loop]), ds, 6,
                  valid_sets=[vs], valid_names=["v"], callbacks=cbs)
    fr, er = (read_stream(paths[k]) for k in ("fused", "eager"))
    timing = {"t_unix", "phases", "chunk_phases", "trees_per_sec"}
    same_keys = [sorted(set(a) - {"chunk_phases"})
                 == sorted(set(b) - {"chunk_phases"})
                 for a, b in zip(fr, er)]
    bitwise = [all(a[k] == b[k] for k in a if k not in timing | {"evals"})
               for a, b in zip(fr, er)]
    eval_gap = max(abs(a["evals"][k] - b["evals"][k])
                   for a, b in zip(fr, er) for k in a["evals"])
    line = {"phase": "recorder", "rows": ds.num_data(), "timed_trees":
            n_trees, "fused_trees_per_s_off": tps["off"],
            "fused_trees_per_s_on": tps["on"],
            "on_over_off": tps["on"] / tps["off"],
            "graph_nodes_off": nodes["off"], "graph_nodes_on": nodes["on"],
            "walls": {m: {str(k): v for k, v in w.items()}
                      for m, w in walls.items()},
            "host_ms_per_round": {k: 1000 * t / max(c, 1)
                                  for k, (t, c) in host.items()},
            "records": len(fused), "records_compared": len(fr),
            "same_keys": all(same_keys), "bitwise_but_timing_and_evals":
            all(bitwise), "eval_max_abs_gap": eval_gap,
            "eval_tolerance": 1e-6}
    emit(line)
    if not (len(fr) == len(er) == 6 and all(same_keys) and all(bitwise)
            and eval_gap < 1e-6 and len(fused) == 1 + n_trees):
        raise AssertionError(f"recorder: fused records differ: {line} "
                             f"{fr[0]} {er[0]}")
    return line


# ---- learning to rank at MSLR-WEB10K's published shape (Microsoft's
# LETOR set: 10,000 queries, ~1.2M documents, 136 features, relevance
# labels 0-4; LightGBM's Experiments page benchmarks its larger sibling
# WEB30K as "MS LTR"), synthetic: query sizes averaging ~120 with a tail to
# 908 documents
MSLR_QUERIES, MSLR_VALID_QUERIES, MSLR_FEATURES = 10_000, 2_000, 136
MSLR_MAX_DOCS = 908
RANK_PARAMS = {"objective": "lambdarank", "metric": "ndcg",
               "eval_at": [1, 3, 5, 10]}
# kernel against plain: max |kernel - plain| <= RANK_TOL * max |plain|, for
# g and h. The two differ only in the order of their f32 sums (a
# document's <= cnt pair terms, sequential in the kernel, a tree in
# torch): ~sqrt(cnt) x 2^-24 relative, ~4e-6 at 4,096 documents.
RANK_TOL = 5e-5
# operations of one pair's lambda and hessian: 2 differences and 2
# absolute values, 3 products for delta-NDCG, the norm's add and divide,
# the sigmoid (a product, an exp counted as 4, an add, a divide), 2
# products for the lambda, 4 for the hessian, 3 sums
PAIR_FLOPS = 24


def mslr_like(n_q: int, seed: int):
    """(X (n, 136) float32, labels, query sizes) in MSLR-WEB10K's shape,
    from RandomState(seed): log-normal query sizes (median ~100, mean
    ~120), one query at the published largest, 908; every fourth feature
    a small count (as MSLR's term-frequency and length columns), the
    rest at three decimals; labels 0-4 skewed toward 0 (MSLR's ~52 / 32 /
    13 / 2 / 1 percent) from four features, a per-query offset and
    noise."""
    import numpy as np

    rs = np.random.RandomState(seed)
    g = np.clip(np.round(rs.lognormal(4.6, 0.6, n_q)), 1,
                MSLR_MAX_DOCS).astype(np.int64)
    g[rs.randint(n_q)] = MSLR_MAX_DOCS
    n = int(g.sum())
    X = np.empty((n, MSLR_FEATURES), np.float32)
    for j in range(MSLR_FEATURES):
        col = rs.randn(n).astype(np.float32)
        X[:, j] = (np.floor(np.expm1(1.2 * np.abs(col))) if j % 4 == 0
                   else np.round(col, 3))
    z = (X[:, 1] + 0.6 * X[:, 2] - 0.4 * X[:, 3] + 0.2 * X[:, 4]
         + np.repeat(0.5 * rs.randn(n_q), g) + 0.8 * rs.randn(n))
    y = np.digitize(z, np.quantile(z, [0.52, 0.84, 0.97, 0.99]))
    return X, y.astype(np.float32), g


def rank_pairs(lay, label, score, trunc: int):
    """The pairs a lambdarank call visits: index pairs (i, j), i < j, i
    below the truncation level, and among them those of unequal labels
    (the only ones that do work), with each query sorted by `score`."""
    import numpy as np

    lab, sc = label.cpu().numpy(), score.cpu().numpy()
    pairs = work = 0
    for q in range(lay.num_queries):
        a, b = int(lay.offsets[q]), int(lay.offsets[q + 1])
        cnt = b - a
        T = min(cnt, trunc)
        pairs += T * (cnt - 1) - T * (T - 1) // 2
        sl = lab[a:b][np.argsort(-sc[a:b], kind="stable")]
        for i in range(T):
            work += int(np.count_nonzero(sl[i + 1:] != sl[i]))
    return pairs, work


def _rank_err(kernel, plain) -> dict:
    """max |kernel - plain| (abs) and over max |plain| (rel), for g and
    h."""
    out = {"abs": [], "rel": []}
    for k, p in zip(kernel, plain):
        err = float((k - p).abs().max())
        out["abs"].append(err)
        out["rel"].append(err / max(float(p.abs().max()), 1e-30))
    return out


def lambdarank_line(torch, gb, later):
    """The lambdarank kernel against its plain version (ranking.
    lambdarank_plain) on the whole MSLR-shaped training set: iteration
    0's equal scores, a later iteration's training scores and those
    scores with injected ties (rounded to 1/8), each with the norm on and
    off; a query of 908 and one of 4,096 documents; two calls bitwise.
    Times on the later scores: the kernel's single-call CUDA-event median
    (ms), device_ms, host_us, device operations a call, the plain
    version's ms; the pairs a call, and the bound max(bytes / 3.35 TB/s,
    unequal-label pairs x PAIR_FLOPS / 67 TFLOP/s). No single torch call
    computes the lambdas (library_ms null)."""
    from lightgbm_tpu_torch.learner import cuda_rank, ranking

    o = gb.objective
    lay = o._layout
    args = (o.label, o._gain_dev, o._imd_dev, o._sigmoid, o._trunc)
    later = later.contiguous()
    sets = {"iter0_equal": torch.zeros_like(later), "later": later,
            "later_ties": torch.round(later * 8) / 8}
    compare = {}
    for sname, sc in sets.items():
        for norm in (True, False):
            k = cuda_rank.lambdarank(lay, sc, *args, norm, o.weight)
            p = ranking.lambdarank_plain(lay, sc, *args, norm, o.weight)
            compare[f"{sname}_norm{int(norm)}"] = _rank_err(k, p)
    # a 908- and a 4,096-document query (random scores, MSLR's label mix)
    rs_ = torch.Generator(device="cpu").manual_seed(31)
    big = ranking.QueryLayout([4096, MSLR_MAX_DOCS, 120, 1], 5125 + 43)
    bl = torch.multinomial(torch.tensor([.52, .32, .13, .02, .01]),
                           big.npad, True, generator=rs_).to(torch.float32)
    bs = torch.randn(big.npad, generator=rs_)
    bg = ranking.default_label_gain(4)
    bimd = ranking.inverse_max_dcg(bl.numpy(), big, bg, 30)
    dev = later.device
    bargs = (bl.to(dev), torch.from_numpy(bg.astype("float32")).to(dev),
             torch.from_numpy(bimd.astype("float32")).to(dev), 1.0, 30, True)
    kb = cuda_rank.lambdarank(big, bs.to(dev), *bargs)
    pb = ranking.lambdarank_plain(big, bs.to(dev), *bargs)
    compare["q4096_q908"] = _rank_err(kb, pb)
    a = cuda_rank.lambdarank(lay, later, *args, o._norm, o.weight)
    b = cuda_rank.lambdarank(lay, later, *args, o._norm, o.weight)
    bitwise = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                  for x, y in zip(a, b))
    run = lambda: cuda_rank.lambdarank(lay, later, *args, o._norm, o.weight)
    plain = lambda: ranking.lambdarank_plain(lay, later, *args, o._norm,
                                             o.weight)
    nums = kernel_numbers(run)
    plain_ms = cuda_ms(plain, reps=5, warm=1)
    pairs, work = rank_pairs(lay, o.label[:lay.num_docs], later[:lay.num_docs],
                             o._trunc)
    nbytes = 4 * lay.npad * (2 + (o.weight is not None) + 2) + 8 * \
        lay.num_queries
    bms, by = bound(nbytes, work * PAIR_FLOPS)
    rel = max(e for v in compare.values() for e in v["rel"])
    d = dict(max_abs_err=max(e for v in compare.values() for e in v["abs"]),
             max_rel_err=rel, err_by_set=compare,
             tolerance=f"max |kernel - plain| <= {RANK_TOL} x max |plain|",
             bitwise_across_calls=bitwise, plain_ms=plain_ms,
             bound_ms=bms, bound_by=by, library_ms=None,
             library="none: no single torch call computes the lambdas",
             shape=f"{lay.num_queries} queries, {lay.num_docs} documents, "
                   f"largest {lay.max_docs}, truncation {o._trunc}",
             pairs_per_call=pairs, unequal_label_pairs_per_call=work,
             bytes_per_call=nbytes, **nums)
    emit_kernel("lambdarank", d)
    if not (rel <= RANK_TOL and bitwise):
        raise AssertionError(f"lambdarank: kernel against plain {compare}, "
                             f"bitwise across calls {bitwise}")
    return d


def _ndcg10(records) -> float:
    return [v for _s, name, v, _h in records if name == "ndcg@10"][0]


def train_rank_phase(torch, lgb, ch):
    """train_rank and train_rank_xendcg: lambdarank (then rank_xendcg) on
    the MSLR-shaped set at the headline widths (255 leaves, 255 bins, lr
    0.1, min_data_in_leaf 20), validation ndcg@1/3/5/10: fused_vs_eager
    (1 warm-up + 3 timed trees; rank_xendcg 1 + 3), a 1-tree profile of
    lambdarank's eager loop, and the lambdarank kernel line on that
    model's training scores."""
    import numpy as np

    t0 = time.perf_counter()
    X, y, g = mslr_like(MSLR_QUERIES, 41)
    Xv, yv, gv = mslr_like(MSLR_VALID_QUERIES, 43)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, group=g, free_raw_data=False)
    ds.construct()
    vs = lgb.Dataset(Xv, label=yv, group=gv, reference=ds,
                     free_raw_data=False)
    vs.construct()
    t_data = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    rank = fused_vs_eager(torch, lgb, ds, vs, "train_rank", RANK_PARAMS,
                          n_timed=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    eager_launch = rank["eager"]["launches_counted"].get("lambdarank", 0)
    first_last = rank["records_first_last"]
    ndcg = {loop: [_ndcg10(r) for r in first_last[loop]]
            for loop in first_last}
    emit({"phase": "train_rank", "rows": int(X.shape[0]),
          "valid_rows": int(Xv.shape[0]), "features": MSLR_FEATURES,
          "queries": len(g), "valid_queries": len(gv),
          "largest_query": int(g.max()), "mean_query": float(g.mean()),
          "label_mix": np.bincount(y.astype(int), minlength=5).tolist(),
          "num_leaves": L, "data_seconds": t_gen,
          "dataset_seconds": t_data, "peak_device_mb": peak,
          "ndcg10_tree1_last": ndcg, "lambdarank_launches_eager":
          eager_launch, "eager_trees": rank["trees"],
          "lambdarank_in_graph":
          rank["fused"]["captured_launches"].get("lambdarank"),
          "trees_per_s": [rank["eager"]["trees_per_s"],
                          rank["fused"]["trees_per_s"]]})
    if eager_launch != rank["trees"] or \
            rank["fused"]["captured_launches"].get("lambdarank") != 1:
        raise AssertionError(f"train_rank: lambdarank launched "
                             f"{eager_launch} times in {rank['trees']} "
                             "eager trees, or not once in the graph")
    if not all(v[1] > v[0] for v in ndcg.values()):
        raise AssertionError(f"train_rank: ndcg@10 did not rise: {ndcg}")
    xe = fused_vs_eager(torch, lgb, ds, vs, "train_rank_xendcg",
                        {**RANK_PARAMS, "objective": "rank_xendcg"},
                        n_timed=3)
    xe_ndcg = [_ndcg10(r) for r in xe["records_first_last"]["fused"]]
    emit({"phase": "train_rank_xendcg", "ndcg10_tree1_last": xe_ndcg,
          "trees_per_s": [xe["eager"]["trees_per_s"],
                          xe["fused"]["trees_per_s"]]})
    if not xe_ndcg[1] > xe_ndcg[0]:
        raise AssertionError(f"train_rank_xendcg: ndcg@10 {xe_ndcg}")
    params = {"num_leaves": L, "max_bin": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 20, "verbosity": -1, **RANK_PARAMS}
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    bst.update()
    profile_phase(torch, bst, 1, "train_rank_profile")
    line = lambdarank_line(torch, bst._gbdt, bst._gbdt.train.score[0])
    return rank, line, (ds, vs)


def first_split_gap(ta, tb):
    """The first node, over two models' trees in order, whose split
    (feature, threshold) differs: (tree, node, gain_a, gain_b), or None
    when every split agrees."""
    for i, (a, b) in enumerate(zip(ta, tb)):
        for n in range(min(a.num_leaves, b.num_leaves) - 1):
            if (a.split_feature[n], a.threshold[n]) != \
                    (b.split_feature[n], b.threshold[n]):
                return i, n, float(a.split_gain[n]), float(b.split_gain[n])
        if a.num_leaves != b.num_leaves:
            return i, min(a.num_leaves, b.num_leaves) - 1, None, None
    return None


def rank_small_phase(lgb, np):
    """A few thousand rows of the MSLR shape on the card against the CPU:
    lambdarank with bagging_by_query (whole queries in every bag, exactly
    round(0.5 Q) of them, the card's bags of 5 windows bitwise the CPU's),
    and lambdarank with positions (the eager loop and the reason train
    logs, finite position biases). Predictions within 1e-4 of the CPU
    run's, or the models agree up to a near tie: the first split where
    they part has gains within 1e-6 relative (ROADMAP C; the lambdas'
    f32 sums run in another order on the card, and 132 of the 136
    features carry no signal, so such ties are common here)."""
    X, y, g = mslr_like(40, 47)
    Xv, yv, gv = mslr_like(10, 53)
    pos = np.concatenate([np.arange(c) % 10 for c in g])
    base = {"num_leaves": 31, "min_data_in_leaf": 20, "verbosity": -1,
            **RANK_PARAMS}
    out, errs, ties = {}, {}, {}
    for name, extra, position in (
            ("bagging_by_query", {"bagging_fraction": 0.5,
                                  "bagging_freq": 1,
                                  "bagging_by_query": True}, None),
            ("positions", {}, pos)):
        preds, models, bags = {}, {}, {}
        for device in ("cuda", "cpu"):
            p = dict(base, device_type=device, **extra)
            ds = lgb.Dataset(X, label=y, group=g, position=position,
                             params=p)
            vs = lgb.Dataset(Xv, label=yv, group=gv, reference=ds)
            ev = {}
            bst = lgb.train(p, ds, 5, valid_sets=[vs], valid_names=["v"],
                            evals_result=ev)
            preds[device] = bst.predict(Xv, raw_score=True)
            gb = bst._gbdt
            models[device] = gb.models
            if getattr(gb.strategy, "by_query", False):
                bags[device] = np.stack([gb.strategy.window_mask(
                    w, gb.dev["valid"], None).cpu().numpy()
                    for w in range(5)])
            if device == "cuda":
                rec = {"ndcg10": [ev["v"]["ndcg@10"][0],
                                  ev["v"]["ndcg@10"][-1]],
                       "fused": gb._fused is not None,
                       "eager_reason": gb.fused_ineligible_reason()}
                if name == "positions":
                    pb = gb.objective.position_biases.cpu().numpy()
                    rec["position_biases"] = pb.tolist()
                    rec["finite"] = bool(np.isfinite(pb).all())
                else:
                    bag = gb.strategy.window_mask(
                        0, gb.dev["valid"], None).cpu().numpy()
                    qb = np.r_[0, np.cumsum(g)]
                    per_q = [bag[qb[q]:qb[q + 1]] for q in range(len(g))]
                    rec["whole_queries"] = all(v.min() == v.max()
                                               for v in per_q)
                    rec["queries_in_bag"] = int(sum(v[0] for v in per_q))
                out[name] = rec
        if bags:
            out[name]["bags_equal_cpu"] = bool(np.array_equal(
                bags["cuda"], bags["cpu"]))
        errs[name] = float(np.abs(preds["cuda"] - preds["cpu"]).max())
        ties[name] = first_split_gap(models["cuda"], models["cpu"])
    emit({"phase": "rank_small", "rows": int(len(y)), "trees": 5, **out,
          "max_abs_pred_diff_card_vs_cpu": errs, "tolerance": 1e-4,
          "first_split_gap_card_vs_cpu": ties})
    bq, ps = out["bagging_by_query"], out["positions"]
    if not (bq["whole_queries"] and bq["queries_in_bag"] == round(
            0.5 * len(g)) and bq["fused"] and bq["bags_equal_cpu"]):
        raise AssertionError(f"rank_small: bagging_by_query {bq}")
    if ps["fused"] or "position debiasing" not in str(ps["eager_reason"]) \
            or not ps["finite"]:
        raise AssertionError(f"rank_small: positions {ps}")
    for name, e in errs.items():
        t = ties[name]
        near = t is not None and t[2] is not None and \
            abs(t[2] - t[3]) <= 1e-6 * abs(t[3])
        if not (e < 1e-4 or near):
            raise AssertionError(f"rank_small {name}: card and CPU disagree "
                                 f"by {e}, first split apart {t}")


# ---- serving: the tensorized forest, the bucketed
# dispatcher's CUDA graphs, the registry under load, HTTP, device SHAP
SERVE_TREES = 500
SERVE_ROWS = 100_000
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
# bench_serve.py's defaults (phases 1-2): 20,000 x 16 training rows,
# RandomState(0), 50 trees x 31 leaves, batch 1; baseline 256 direct
# requests, loaded 8,192 through 2 replicas, 8 threads x a window of 128
BENCH_SERVE = dict(train_rows=20_000, features=16, trees=50, leaves=31,
                   base_requests=256, requests=8192, threads=8,
                   window=128, replicas=2)


def serve_check(np, bst, X, name, n_host=2000, n_check=10_000):
    """Booster.predict(device="cuda") against the host walker: the card
    scores all of X (its rows/s is the second call's: the first also
    packs and uploads the tables); on the first n_check rows (all of X
    before; cut to keep the script inside its limit) its raw
    scores are held within SERVE_TOL and its pred_leaf exactly. The
    walker runs once over those rows for their leaves (pred_leaf); its
    raw scores are those leaves' values added tree by tree, as
    GBDT.predict_raw adds them, and equal Booster.predict(raw_score=True)
    on the first n_host rows, whose time gives the walker's rows/s."""
    bst.predict(X[:1000], device="cuda", raw_score=True)
    t0 = time.perf_counter()
    raw_d = bst.predict(X, device="cuda", raw_score=True)
    t_dev = time.perf_counter() - t0
    rows = X.shape[0]
    X = X[:n_check]
    raw_d = raw_d[:n_check]
    leaf_d = bst.predict(X, device="cuda", pred_leaf=True)
    leaf_h = bst.predict(X, pred_leaf=True)
    raw_h = np.zeros(X.shape[0])
    for t, tree in enumerate(bst._gbdt.models):
        raw_h += tree.leaf_value[leaf_h[:, t]]
    t0 = time.perf_counter()
    walked = bst.predict(X[:n_host], raw_score=True)
    t_host = time.perf_counter() - t0
    ok = bool(np.allclose(raw_d, raw_h, **SERVE_TOL))
    line = {"model": name, "rows": int(rows),
            "rows_checked": int(X.shape[0]),
            "trees": bst.num_trees(), "features": int(X.shape[1]),
            "max_abs_err": float(np.abs(raw_d - raw_h).max()),
            "within_tol": ok, "tolerance": SERVE_TOL,
            "leaves_equal": bool(np.array_equal(leaf_d, leaf_h)),
            "host_raw_is_walker": bool(np.array_equal(walked,
                                                      raw_h[:n_host])),
            "card_rows_per_s": rows / t_dev,
            "host_rows_per_s": n_host / t_host}
    if not (ok and line["leaves_equal"] and line["host_raw_is_walker"]):
        raise AssertionError(f"serve_forest: {name} on the card differs "
                             f"from the host walker: {line}")
    return line


def serve_forest_phase(torch, lgb, ch, np, ds, Xv, cat_sets, rank_sets):
    """The Higgs-like binary model (255 leaves, max_bin 255) trained to
    SERVE_TREES trees on the fused loop, scored on the 100,000 validation
    rows on the card (Booster.predict(device="cuda"): the tensorized
    forest, take_small at every level) against the host walker; then the
    same check on 20-tree models of train_cat's data (category bitsets
    on the card) and train_rank's (136 columns). Returns the 500-tree
    booster, the take_small launches of the Higgs-like check, and the
    20-tree boosters by name with 4,096 of their validation rows."""
    params = {"objective": "binary", "num_leaves": L, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lgb.train(params, ds, SERVE_TREES)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    if bst._gbdt._fused is None or bst.num_trees() != SERVE_TREES:
        raise AssertionError("serve_forest: the model was not trained on "
                             "the fused loop")
    ch.reset_launch_counts()
    higgs = serve_check(np, bst, Xv[:SERVE_ROWS], "higgs_500")
    launches = dict(ch.LAUNCHES)
    if launches["take_small"] == 0:
        raise AssertionError("serve_forest: take_small was not launched")
    checks = [higgs]
    small = {}
    for name, (cds, cvs), extra in (
            ("train_cat_20", cat_sets, {}),
            ("train_rank_20", rank_sets, RANK_PARAMS)):
        b = lgb.train({**params, **extra}, cds, 20)
        checks.append(serve_check(np, b, cvs.data[:SERVE_ROWS], name))
        small[name] = (b, cvs.data[:4096])
    forest_meta = lgb.serving.TensorForest.from_booster(bst).meta
    emit({"phase": "serve_forest", "train_trees": SERVE_TREES,
          "reduced": "host-checked rows 100,000 -> 20,000",
          "train_seconds": t_train,
          "train_trees_per_s": SERVE_TREES / t_train,
          "forest": forest_meta, "checks": checks,
          "take_small_launches": launches["take_small"],
          "launches": {k: v for k, v in launches.items() if v}})
    return bst, launches, small


@contextlib.contextmanager
def recording_take_call(ch, k, nth, store):
    """While active, keep the arguments of the nth take_small call of
    table height k (store["args"] = (tab, idx))."""
    orig = ch.take_small
    seen = [0]

    def recording(tab, idx):
        if tab.shape[0] == k:
            if seen[0] == nth:
                store["args"] = (tab.clone(), idx.clone())
            seen[0] += 1
        return orig(tab, idx)
    ch.take_small = recording
    try:
        yield
    finally:
        ch.take_small = orig


def take_small_serve_line(torch, hist, ch, forest):
    """take_small at the serving shape: one level's gather (the fourth)
    of a 4096-row bucket over the SERVE_TREES-tree forest, k = 9 packed
    node fields, L = trees x max_nodes (past the 48 KB shared-memory
    stage: the unstaged generic path). Bitwise against take_cols_plain
    and across two launches; in turns with index_select; launches per
    call from the profiler."""
    store = {}
    x = torch.randn((4096, 28), device="cuda")
    tw = torch.ones(forest.num_trees, device="cuda")
    with recording_take_call(ch, 9, 3, store):
        forest.apply(x, tw)
    tab, idx = store["args"]
    run = lambda: hist.take_cols(tab, idx)  # noqa: E731
    a, b, p = run(), run(), hist.take_cols_plain(tab, idx)
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(a, p)):
        raise AssertionError("take_small_serve disagrees with its plain "
                             "version or across launches")
    k, Lt = tab.shape
    n = idx.shape[0]
    safe = idx.clamp(0, Lt - 1).long()
    # idx read once, the table once, the (9, n) output written once
    bb, by = bound(n * 4 + k * Lt * 4 + k * n * 4, 0)
    d = dict(shape=f"tab ({k},{Lt}) idx ({n},)", lanes=n, k=k, L=Lt,
             tolerance="exact", bitwise_repeat=True,
             max_abs_err=float((a - p).abs().max()),
             **in_turns(run, lambda: torch.index_select(tab, 1, safe)),
             plain_ms=cuda_ms(lambda: hist.take_cols_plain(tab, idx)),
             bound_ms=bb, bound_by=by,
             launches_per_call=launches_per_call(run))
    return d


def serve_dispatch_phase(torch, np, lgb, bst, X_pool):
    """BucketDispatcher on the card: warm up every rung (one CUDA graph
    each), then 100 requests of 1-5,000 rows from a 20,000-row pool:
    captures equal the rungs and do not grow, every answer (scores and
    leaves) bitwise the unbucketed forest's on the pool; per rung the
    graph's nodes and its device ms a replay."""
    f = lgb.serving.TensorForest.from_booster(bst)
    disp = lgb.serving.BucketDispatcher(f, name="chip_dispatch")
    t0 = time.perf_counter()
    disp.warmup(num_features=X_pool.shape[1])
    warm_s = time.perf_counter() - t0
    caps = disp.captures
    xt = torch.from_numpy(np.ascontiguousarray(X_pool, np.float32)).cuda()
    score, leaf = f.apply(xt, torch.ones(f.num_trees, device="cuda"))
    score = score.cpu().numpy().T.astype(np.float64)
    leaf = leaf.cpu().numpy().astype(np.int64)
    rs = np.random.RandomState(29)
    sizes = [int(s) for s in rs.randint(1, 5001, 100)]
    bad = []
    t0 = time.perf_counter()
    for n in sizes:
        lo = int(rs.randint(0, len(X_pool) - n + 1))
        r = disp.score_raw(X_pool[lo:lo + n])
        lf = disp.predict_leaf(X_pool[lo:lo + n])
        if not (np.array_equal(r, score[:, lo:lo + n])
                and np.array_equal(lf, leaf[lo:lo + n])):
            bad.append(n)
    t_req = time.perf_counter() - t0
    rungs = {}
    with torch.cuda.stream(disp.stream):
        for (b, _), prog in disp._programs.items():
            rep = prog.graph.replay
            dev_ms, how = device_ms(rep, calls=20)
            rungs[b] = {"graph_nodes": prog.graph.nodes,
                        "capture_s": prog.graph.capture_s,
                        "ms": cuda_ms(rep, reps=10), "device_ms": dev_ms,
                        "device_time": how, "replays": prog.graph.replays}
    line = {"phase": "serve_dispatch", "buckets": list(disp.buckets),
            "trees": f.num_trees, "levels": f.levels,
            "warmup_seconds": warm_s, "captures_after_warmup": caps,
            "captures_after_requests": disp.captures,
            "requests": len(sizes), "rows": int(sum(sizes)),
            "seconds_for_requests": t_req, "mismatched_requests": bad,
            "rungs": rungs}
    emit(line)
    if caps != len(disp.buckets) or disp.captures != caps or bad:
        raise AssertionError(f"serve_dispatch: captures {caps} -> "
                             f"{disp.captures} for {len(disp.buckets)} "
                             f"buckets, mismatched requests {bad}")
    return line


def _pct(vals, p):
    v = sorted(vals)
    return v[min(len(v) - 1, int(p * (len(v) - 1) + 0.5))] if v else 0.0


def _lat_summary(lat, wall):
    return {"qps": len(lat) / wall, "p50_ms": 1e3 * _pct(lat, 0.50),
            "p95_ms": 1e3 * _pct(lat, 0.95), "p99_ms": 1e3 * _pct(lat, 0.99),
            "mean_ms": 1e3 * sum(lat) / len(lat), "requests": len(lat),
            "wall_s": wall}


def _fire(np, predict, n_requests, n_feat):
    """bench_serve.py _fire with one client: closed-loop batch-1 calls."""
    wrs = np.random.RandomState(0)
    lat = []
    t0 = time.perf_counter()
    for _ in range(n_requests):
        rows = wrs.randn(1, n_feat).astype(np.float32)
        t = time.perf_counter()
        predict(rows)
        lat.append(time.perf_counter() - t)
    return _lat_summary(lat, time.perf_counter() - t0)


def _fire_pipelined(np, submit, n_requests, n_threads, window, n_feat):
    """bench_serve.py _fire_pipelined: each client thread keeps up to
    `window` futures outstanding; latency is submit -> completion."""
    import threading

    lat, lock = [], threading.Lock()
    per_thread = max(n_requests // n_threads, 1)

    def worker(seed):
        wrs = np.random.RandomState(seed)
        mine, outstanding = [], []

        def collect(pair):
            t_submit, fut = pair
            fut.result()
            mine.append(time.perf_counter() - t_submit)

        for _ in range(per_thread):
            rows = wrs.randn(1, n_feat).astype(np.float32)
            outstanding.append((time.perf_counter(), submit(rows)))
            if len(outstanding) >= window:
                collect(outstanding.pop(0))
        for pair in outstanding:
            collect(pair)
        with lock:
            lat.extend(mine)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return _lat_summary(lat, time.perf_counter() - t0)


def _serve_counters():
    from lightgbm_tpu_torch.obs.metrics import default_registry

    return {name: sum(v.values())
            for name, v in default_registry().snapshot().items()
            if name.startswith("lgbmtpu_serve_")}


def serve_loaded_phase(torch, np, lgb, bst, n_feat, name):
    """bench_serve.py's phases 1-2 on the card: baseline (1 replica,
    direct calls, 256 batch-1 requests, one client) and loaded (2
    replicas behind the MicroBatcher, 8 threads x a window of 128, 8,192
    batch-1 requests): qps, p50 / p99 ms, coalesce ratio and device calls
    (from the /metrics counters), and a 64-row probe bitwise equal across
    the direct and the batched paths."""
    B = BENCH_SERVE
    rs = np.random.RandomState(0)
    probe = rs.randn(64, n_feat).astype(np.float32)
    warm = rs.randn(1, n_feat).astype(np.float32)
    base_reg = lgb.serving.ModelRegistry(warmup=True)
    base_reg.load("bench", bst, num_features=n_feat)
    for _ in range(3):
        base_reg.predict("bench", warm, raw_score=True)
        base_reg.predict("bench", probe, raw_score=True)
    before = _serve_counters()
    baseline = _fire(np, lambda r: base_reg.predict("bench", r,
                                                    raw_score=True),
                     B["base_requests"], n_feat)
    after = _serve_counters()
    baseline["device_calls"] = int(
        after.get("lgbmtpu_serve_bucket_dispatch_total", 0)
        - before.get("lgbmtpu_serve_bucket_dispatch_total", 0))
    base_pred = np.asarray(base_reg.predict("bench", probe))
    loaded_reg = lgb.serving.ModelRegistry(warmup=True,
                                           replicas=B["replicas"])
    loaded_reg.load("bench", bst, num_features=n_feat)
    batcher = loaded_reg.batcher("bench")
    for _ in range(3):
        batcher.submit(warm).result()
        loaded_reg.predict("bench", probe, via_queue=True)
    before = _serve_counters()
    loaded = _fire_pipelined(np, batcher.submit, B["requests"],
                             B["threads"], B["window"], n_feat)
    after = _serve_counters()
    d = {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after}
    drains = d.get("lgbmtpu_serve_coalesced_batch_rows_count", 0.0)
    loaded.update(
        device_calls=int(d.get("lgbmtpu_serve_bucket_dispatch_total", 0)),
        coalesce_ratio=(d.get("lgbmtpu_serve_coalesced_requests_total", 0)
                        / drains if drains else 0.0),
        padded_rows=int(d.get("lgbmtpu_serve_padded_rows_total", 0)))
    loaded_pred = np.asarray(loaded_reg.predict("bench", probe,
                                                via_queue=True))
    mv = loaded_reg._entry("bench")
    line = {"phase": "serve_loaded", "model": name,
            "trees": bst.num_trees(), "features": n_feat,
            "max_leaves": max(t.num_leaves for t in bst._gbdt.models),
            "baseline": baseline, "loaded": loaded,
            "speedup_x": loaded["qps"] / baseline["qps"],
            "probe_bit_identical": bool(np.array_equal(base_pred,
                                                       loaded_pred)),
            "captures_per_replica": [r.captures for r in mv.replicas],
            "traffic": {k: B[k] for k in ("base_requests", "requests",
                                          "threads", "window",
                                          "replicas")}}
    emit(line)
    loaded_reg.unload("bench")
    base_reg.unload("bench")
    if not line["probe_bit_identical"]:
        raise AssertionError(f"serve_loaded {name}: the probe differs "
                             "between the direct and the batched paths")
    return line


def serve_http_phase(np, lgb, bst, n_feat):
    """serve_http on a free local port: /readyz 200 after warm-up,
    /v1/score equal to a direct predict, /metrics with lgbmtpu_serve_*
    series; the server is shut down and its thread joined."""
    import threading
    import urllib.request

    reg = lgb.serving.ModelRegistry(warmup=True)
    reg.load("default", bst, num_features=n_feat)
    httpd = lgb.serving.serve_http(reg, port=0, block=False)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rows = np.random.RandomState(3).randn(5, n_feat).astype(np.float32)
    try:
        with urllib.request.urlopen(base + "/readyz", timeout=30) as r:
            ready = (r.status, json.loads(r.read()))
        req = urllib.request.Request(
            base + "/v1/score", data=json.dumps(
                {"rows": rows.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            scored = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    direct = reg.predict("default", rows)
    series = sorted({ln.split("{")[0].split(" ")[0]
                     for ln in metrics.splitlines()
                     if ln.startswith("lgbmtpu_serve_")})
    line = {"phase": "serve_http", "readyz": ready[0],
            "ready": ready[1].get("ok"),
            "score_equal_direct": bool(np.array_equal(
                np.asarray(scored["pred"]), direct)),
            "metrics_series": series, "thread_joined": not th.is_alive()}
    emit(line)
    if not (ready[0] == 200 and line["score_equal_direct"] and series
            and line["thread_joined"]):
        raise AssertionError(f"serve_http: {line}")
    return line


def _gw_client(np, url, pool, ref, n_requests, n_threads=8, seed=0):
    """n_threads client threads sending n_requests batch-1 score requests
    (a row of the pool each) to url: latencies, failures and the worst
    difference from the host walker's answer (ref)."""
    import http.client
    import threading
    import urllib.parse

    lat, fails, worst, lock = [], [], [0.0], threading.Lock()
    per = n_requests // n_threads
    host, port = urllib.parse.urlsplit(url).hostname, urllib.parse.urlsplit(
        url).port

    def worker(k):
        rs = np.random.RandomState(seed * 100 + k)
        mine, bad, w = [], [], 0.0
        for _ in range(per):
            i = int(rs.randint(0, len(pool)))
            body = json.dumps({"rows": pool[i:i + 1].tolist(),
                               "raw_score": True})
            t0 = time.perf_counter()
            conn = http.client.HTTPConnection(host, port, timeout=60)
            try:
                conn.request("POST", "/v1/score", body=body, headers={
                    "Content-Type": "application/json"})
                r = conn.getresponse()
                out = json.loads(r.read())
                if r.status != 200:
                    raise OSError(f"HTTP {r.status}: {out}")
                mine.append(time.perf_counter() - t0)
                w = max(w, abs(float(out["pred"][0]) - float(ref[i])))
            except (OSError, KeyError, ValueError) as e:
                bad.append(repr(e)[:200])
            finally:
                conn.close()
        with lock:
            lat.extend(mine)
            fails.extend(bad)
            worst[0] = max(worst[0], w)

    ths = [threading.Thread(target=worker, args=(k,), daemon=True)
           for k in range(n_threads)]
    t0 = time.perf_counter()
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    out = _lat_summary(lat, time.perf_counter() - t0) if lat else {}
    out.update(failures=len(fails), failure_samples=fails[:3],
               max_abs_vs_host=worst[0])
    return out


def _gw_counts():
    """The gateway's counters, once every attempt thread has ended: a
    hedged loser's thread outlives its request (it counts its attempt
    when its delayed read fails), so a snapshot taken at once could
    count a stage's attempt in the next stage."""
    import threading

    from lightgbm_tpu_torch.obs.metrics import default_registry

    deadline = time.monotonic() + 30
    while any(t.name.startswith("gw-attempt-") and t.is_alive()
              for t in threading.enumerate()):
        if time.monotonic() > deadline:
            raise AssertionError("gateway: attempt threads still running")
        time.sleep(0.02)
    out = {}
    for s in default_registry().samples():
        if s.name.startswith("lgbmtpu_gateway_") and s.kind == "counter":
            key = s.name[len("lgbmtpu_gateway_"):] + "".join(
                f"|{v}" for _, v in s.labels)
            out[key] = s.value
    return out


def _gw_delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def gateway_phase(torch, np, lgb, ch, bst, n_feat, n_requests=1000,
                  n_fault=200):
    """The serving gateway (serving/gateway.py) in front of two
    serve_http backends, each on a card registry in this process with
    bench_serve's 50 x 31 model: 8 client threads (a connection a
    request) send n_requests batch-1 score requests through the gateway,
    then n_requests straight to one backend (qps, p50 / p99 of each);
    then n_fault requests each under gw_backend_5xx (one attempt in 20
    raises, 3 retries: 0 client failures, retries and breaker
    transitions counted), under gw_slow_backend (one attempt in 25
    stalls 200 ms: hedges fired and won, within the hedge budget), and
    across one backend's drain (its /readyz 503, no attempt reaches it,
    0 failures); the gateway's /metrics merging both backends' series.
    Every answer within 1e-5 of the host walker. The launch counters are
    reset before the backends load (their warm-up captures the
    take_small gathers)."""
    import threading
    import urllib.request

    from lightgbm_tpu_torch.resilience import faultinject
    from lightgbm_tpu_torch.serving import (Gateway, ModelRegistry,
                                            gateway_http, serve_http)

    rs = np.random.RandomState(5)
    pool = rs.randn(2000, n_feat).astype(np.float32)
    ref = bst.predict(pool, raw_score=True)
    text = bst.model_to_string()
    ch.reset_launch_counts()
    backs = []
    for _ in range(2):
        reg = ModelRegistry(warmup=True)
        reg.load("default", text, num_features=n_feat)
        drain = threading.Event()
        h = serve_http(reg, 0, block=False, draining=drain)
        t = threading.Thread(target=h.serve_forever, daemon=True)
        t.start()
        backs.append((h, t, drain,
                      f"http://127.0.0.1:{h.server_address[1]}"))
    gw = Gateway([b[3] for b in backs], retries=3, backoff_base_s=0.01,
                 health_interval_s=60.0)
    gw.start(wait_ready_s=30.0)
    front = gateway_http(gw, 0, block=False)
    ft = threading.Thread(target=front.serve_forever, daemon=True)
    ft.start()
    url = f"http://127.0.0.1:{front.server_address[1]}"
    line = {"phase": "gateway", "model": "bench_serve_50x31",
            "backends": 2, "client_threads": 8, "requests": n_requests}
    try:
        line["gateway_load"] = _gw_client(np, url, pool, ref, n_requests,
                                          seed=0)
        line["direct_load"] = _gw_client(np, backs[0][3], pool, ref,
                                         n_requests, seed=1)
        c0 = _gw_counts()
        faultinject.arm(";".join(f"gw_backend_5xx:{k}:raise"
                                 for k in range(5, 3 * n_fault, 20)))
        line["backend_5xx"] = _gw_client(np, url, pool, ref, n_fault, seed=7)
        faultinject.disarm()
        c1 = _gw_counts()
        line["backend_5xx"]["counters"] = _gw_delta(c0, c1)
        hedges0 = gw.hedge.counters()
        faultinject.arm(";".join(f"gw_slow_backend:{k}:delay:0.2"
                                 for k in range(3, 3 * n_fault, 25)))
        line["slow_backend"] = _gw_client(np, url, pool, ref, n_fault,
                                          seed=8)
        faultinject.disarm()
        c2 = _gw_counts()
        h1 = gw.hedge.counters()
        cap = gw.hedge.burst + gw.hedge.budget_frac * h1["requests"]
        line["slow_backend"].update(
            counters=_gw_delta(c1, c2),
            hedges=h1["hedges"] - hedges0["hedges"],
            hedge_cap=cap, hedges_total=h1["hedges"])
        backs[0][2].set()  # backend 0 drains
        try:
            urllib.request.urlopen(backs[0][3] + "/readyz", timeout=30)
            drained_readyz = 200
        except urllib.error.HTTPError as e:
            drained_readyz = e.code
        pool_counts = gw.check_now()
        name0 = gw.pool.backends[0].name
        line["drain"] = _gw_client(np, url, pool, ref, n_fault, seed=9)
        c3 = _gw_counts()
        line["drain"].update(
            backend0_readyz=drained_readyz,
            alive_ready_after=list(pool_counts),
            attempts_to_drained=sum(v for k, v in _gw_delta(c2, c3).items()
                                    if k.startswith("attempts")
                                    and name0 in k))
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        line["merged_metrics"] = {
            "gateway_series": sum(1 for ln in metrics.splitlines()
                                  if ln.startswith("lgbmtpu_gateway_")),
            "serve_series": sum(1 for ln in metrics.splitlines()
                                if ln.startswith("lgbmtpu_serve_")),
            "processes": gw.merged_metrics()["processes"]}
        line["take_small_launches"] = ch.LAUNCHES["take_small"]
    finally:
        faultinject.disarm()
        gw.stop()
        for h, t, _, _ in [(front, ft, None, None)] + backs:
            h.shutdown()
            h.server_close()
            t.join(timeout=10)
    emit(line)
    runs = [line[k] for k in ("gateway_load", "direct_load", "backend_5xx",
                              "slow_backend", "drain")]
    if any(r["failures"] or r["max_abs_vs_host"] > 1e-5 for r in runs):
        raise AssertionError(f"gateway: failures or answers off: {line}")
    sb, bx = line["slow_backend"], line["backend_5xx"]["counters"]
    if not (bx.get("retries_total", 0) > 0 and sb["hedges"] > 0
            and sb["hedges_total"] <= sb["hedge_cap"]
            and sb["counters"].get("hedges_total|won", 0) > 0):
        raise AssertionError(f"gateway: retries / hedges: {line}")
    if not (line["drain"]["backend0_readyz"] == 503
            and line["drain"]["attempts_to_drained"] == 0
            and line["merged_metrics"]["serve_series"] > 0
            and line["merged_metrics"]["gateway_series"] > 0
            and line["merged_metrics"]["processes"] == 3
            and line["take_small_launches"] > 0):
        raise AssertionError(f"gateway: drain / metrics: {line}")
    return line


def ops_processes_phase(np, bst, n_feat, n_requests=1000,
                        drain_rows=50_000):
    """gateway_phase's model behind separate processes on the card, driven
    through lightgbm_tpu_torch/tools/gateway_rolling.py: 2 task=serve
    backends and a task=gateway process (ProcessFleet), warmed directly;
    1,000 batch-1 requests from 8 threads through the gateway and 1,000
    straight to backend 0; then the runbook (the rolling SIGTERM restart
    under a continuous client, kill -9 of backend 0 and its breaker's
    recovery, the merged pane's process count, the gateway's drain with
    a drain_rows request in flight). Every answer within 1e-5 of the host
    walker (a client counts a score further off as a failure). The
    children are SIGKILLed in a finally; a failure still prints the line
    (with its error) and then raises."""
    import shutil

    from lightgbm_tpu_torch.tools import _procs
    from lightgbm_tpu_torch.tools import gateway_rolling as gr

    t0 = time.perf_counter()
    work = (Path("build") / "chip_smoke" / "ops_processes").resolve()
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    bst.save_model(work / "model.txt")
    rs = np.random.RandomState(5)
    pool = rs.randn(2000, n_feat).astype(np.float32)
    ref = bst.predict(pool, raw_score=True)
    line = {"phase": "ops_processes", "model": "bench_serve_50x31",
            "backends": 2, "client_threads": 8, "requests": n_requests,
            "build": _procs.prebuild("cuda")}
    fleet = gr.ProcessFleet(work / "model.txt", "cuda", work, 2)
    err = None
    try:
        fleet.start()
        line["start_s"] = time.perf_counter() - t0
        fleet.warm(pool[:1].tolist())
        line["gateway_load"] = gr.fixed_load(fleet.gateway_url, pool, ref,
                                             n_requests, seed=0)
        line["direct_load"] = gr.fixed_load(fleet.urls[0], pool, ref,
                                            n_requests, seed=1)
        for k in ("gateway_load", "direct_load"):
            if line[k]["failures"] or line[k]["max_abs_vs_host"] > 1e-5:
                raise AssertionError(f"ops_processes {k}: {line[k]}")
        line.update(gr.runbook(fleet, pool, ref, drain_rows=drain_rows))
        for i in range(2):
            fleet.stop_backend(i)
        drained = {k: [rc for rc in v if rc != -9]
                   for k, v in fleet.exit_codes.items()}
        if any(rc != 0 for v in drained.values() for rc in v):
            raise AssertionError(f"a drained process exited non-zero: "
                                 f"{fleet.exit_codes}")
    except Exception as e:  # noqa: BLE001 — printed with the line, re-raised
        err = e
        line["error"] = repr(e)[:3000]
    finally:
        line["killed_at_end"] = fleet.close()
    line.update(exit_codes=fleet.exit_codes, ready_s=fleet.ready_s,
                seconds=time.perf_counter() - t0)
    emit(line)
    if err is not None:
        raise err
    return line


def _host_contrib(args):
    """Host TreeSHAP of a chunk of rows (a worker of serve_contrib)."""
    model_str, X = args
    import lightgbm_tpu_torch as lgb

    return lgb.Booster(model_str=model_str).predict(X, pred_contrib=True)


def serve_contrib_phase(torch, np, lgb, bst, n_feat, rows=1024):
    """Device TreeSHAP (contrib_apply) on the bench_serve model, `rows`
    rows, against host shap.py (8 worker processes): within SERVE_TOL
    (rtol 1e-5, atol 1e-5, as the CPU tests hold it), rows summing to the
    raw score as closely; device ms (CUDA events, tables packed first)
    and peak device memory of the call."""
    import multiprocessing as mp

    X = np.random.RandomState(5).randn(rows, n_feat).astype(np.float32)
    f = lgb.serving.TensorForest.from_booster(bst)
    f.contrib_tables()
    f.predict_contrib(X[:16])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    xt = torch.from_numpy(X).cuda()
    tw = torch.ones(f.num_trees, device="cuda")
    ms = cuda_ms(lambda: f.apply_contrib(xt, tw), reps=5, warm=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb
    dev = f.predict_contrib(X)
    t0 = time.perf_counter()
    text = bst.model_to_string()
    with mp.get_context("spawn").Pool(8) as pool:
        host = np.concatenate(pool.map(
            _host_contrib, [(text, c) for c in np.array_split(X, 8)]))
    t_host = time.perf_counter() - t0
    raw = bst.predict(X, raw_score=True)
    err = float(np.abs(dev - host).max())
    sum_err = float(np.abs(dev.sum(axis=1) - raw).max())
    ok = bool(np.allclose(dev, host, **SERVE_TOL)
              and np.allclose(dev.sum(axis=1), raw, **SERVE_TOL))
    line = {"phase": "serve_contrib", "rows": rows, "trees": f.num_trees,
            "max_leaves": f.meta["max_leaves"],
            "path_feats": f.contrib_tables()[1]["path_feats"],
            "path_edges": f.contrib_tables()[1]["path_edges"],
            "max_abs_err_vs_host": err, "row_sum_err": sum_err,
            "within_tol": ok, "tolerance": SERVE_TOL, "device_ms": ms,
            "peak_device_mb": peak, "host_seconds_8_procs": t_host}
    emit(line)
    if not ok:
        raise AssertionError(f"serve_contrib: {line}")
    return line


# serve_fleet: cuts of the 500-tree forest (text models at these
# num_iteration values) beside the 20-tree categorical and ranking
# models, behind a fleet of FLEET_CAPACITY resident slots
FLEET_CUTS = (50, 100, 200, 300, 500)
FLEET_CAPACITY = 4
FLEET_BUCKETS = (16, 64, 256)
FLEET_REQUESTS = 600


def serve_fleet_phase(torch, np, lgb, bst, Xh, small20):
    """The model fleet on the card: tenants of at least three shape
    families (the cuts, and the 20-tree categorical and ranking models),
    more than FLEET_CAPACITY of them. First every tenant takes one
    request a rung (it pages in, and each family stack captures its
    rungs: captures = families x rungs); then a Zipf-like churn trace
    (tenant i drawn with weight 1 / (i + 1), RandomState(31)) of
    FLEET_REQUESTS requests of 1-256 rows (log-uniform). Prints page-ins,
    evictions, captures (which must not grow over the trace), p50 / p99
    ms of requests served resident and of requests that paged their
    tenant in, qps, and per tenant its worst difference from its own
    TensorForest on the card over every request (<= 1e-5; 0 means the
    same bits) and the slots it was paged into: a tenant seen in two
    slots scored the same bits in both."""
    from lightgbm_tpu_torch.serving import ModelFleet, TensorForest

    tenants = {f"higgs_{n}": (bst.model_to_string(num_iteration=n), Xh)
               for n in FLEET_CUTS}
    for name, (b, rows) in small20.items():
        tenants[name] = (b.model_to_string(), rows)
    names = list(tenants)
    refs = {}
    for name, (text, rows) in tenants.items():
        own = TensorForest.from_booster(lgb.Booster(model_str=text))
        refs[name] = own.predict_raw(rows)[0]
    fleet = ModelFleet(buckets=FLEET_BUCKETS, capacity=FLEET_CAPACITY,
                       slots_per_family=FLEET_CAPACITY)
    for name, (text, rows) in tenants.items():
        fleet.load(name, text, num_features=rows.shape[1])
    worst = {n: 0.0 for n in names}
    slots = {n: set() for n in names}

    def request(name, lo, n):
        rows = tenants[name][1]
        before = fleet.fleet_stats()["pages_in"]
        t0 = time.perf_counter()
        got = fleet.predict(name, rows[lo:lo + n], raw_score=True)
        dt = (time.perf_counter() - t0) * 1e3
        paged = fleet.fleet_stats()["pages_in"] > before
        entry = fleet._names[name]["versions"][0]
        slots[name].add((id(entry.stack), entry.slot))
        worst[name] = max(worst[name], float(np.abs(
            got - refs[name][lo:lo + n]).max()))
        return dt, paged

    t0 = time.perf_counter()
    for name in names:
        for n in (1, 17, 65):
            request(name, 0, n)
    warm_s = time.perf_counter() - t0
    fs0 = fleet.fleet_stats()
    captures0 = fleet.captures()
    rs = np.random.RandomState(31)
    w = 1.0 / np.arange(1, len(names) + 1)
    picks = rs.choice(len(names), FLEET_REQUESTS, p=w / w.sum())
    sizes = np.exp(rs.uniform(0, np.log(256), FLEET_REQUESTS)).astype(int)
    lat = {"resident": [], "paged": []}
    t0 = time.perf_counter()
    for i, n in zip(picks, sizes):
        name = names[i]
        lo = int(rs.randint(0, tenants[name][1].shape[0] - n + 1))
        dt, paged = request(name, lo, int(n))
        lat["paged" if paged else "resident"].append(dt)
    wall = time.perf_counter() - t0
    fs = fleet.fleet_stats()
    graphs = {str(k): {b: p.graph.nodes
                       for (b, _), p in st.programs.by_shape.items()
                       if p.graph is not None}
              for k, v in fleet._stacks.items() for st in v}
    captures1 = fleet.captures()
    # one graph a stack, rung and row width: the tenants here give each
    # family one width
    widths = {(e.family, e.width) for r in fleet._names.values()
              for e in r["versions"]}
    fleet.close()
    move = fleet_slot_move(np, lgb, tenants, refs)
    moved = [n for n in names if len(slots[n]) > 1]
    line = {"phase": "serve_fleet", "tenants": len(names),
            "capacity": FLEET_CAPACITY, "buckets": list(FLEET_BUCKETS),
            "families": len(fs["families"]), "stacks": fs["stacks"],
            "family_widths": len(widths),
            "warm_seconds": warm_s, "captures_after_warm": captures0,
            "captures_after_trace": captures1,
            "pages_in_warm": fs0["pages_in"],
            "pages_in": fs["pages_in"], "evictions": fs["evictions"],
            "requests": FLEET_REQUESTS, "rows": int(sizes.sum()),
            "qps": FLEET_REQUESTS / wall,
            "resident_requests": len(lat["resident"]),
            "paged_requests": len(lat["paged"]),
            "resident_p50_ms": _pct(lat["resident"], 0.5),
            "resident_p99_ms": _pct(lat["resident"], 0.99),
            "paged_p50_ms": _pct(lat["paged"], 0.5),
            "paged_p99_ms": _pct(lat["paged"], 0.99),
            "worst_vs_own_forest": worst,
            "slots_seen": {n: len(slots[n]) for n in names},
            "moved_tenants": moved, "slot_move": move,
            "graph_nodes": graphs, "tolerance": 1e-5}
    emit(line)
    rungs = len(FLEET_BUCKETS)
    if not (line["families"] >= 3 and len(names) > FLEET_CAPACITY
            and fs["stacks"] == line["families"] == len(widths)
            and captures0 == line["families"] * rungs
            and line["captures_after_trace"] == captures0):
        raise AssertionError(f"serve_fleet: families, stacks or captures: "
                             f"{line}")
    if max(worst.values()) > 1e-5 or any(worst[n] != 0.0 for n in moved):
        raise AssertionError(f"serve_fleet: a tenant differs from its own "
                             f"forest: {line}")
    if not (move["slots"][0] != move["slots"][1] and move["same_bits"]
            and move["captures"] == 1):
        raise AssertionError(f"serve_fleet: the slot move: {move}")
    if not (fs["evictions"] > 0 and line["paged_requests"] > 0):
        raise AssertionError(f"serve_fleet: no paging under churn: {line}")
    return line


def fleet_slot_move(np, lgb, tenants, refs):
    """One tenant scored from two slots of its family's stack: a fleet of
    two slots a family and a residency of two pages a second tenant of
    higgs_300's family ("other", the same text) into slot 0 and
    higgs_300 into slot 1, scores it, touches "other", pages
    train_cat_20 in (evicting higgs_300) and higgs_300 again (evicting
    "other": it takes slot 0). Both higgs_300 answers must be the same
    bits, its own forest's, through the stack's one graph."""
    from lightgbm_tpu_torch.serving import ModelFleet

    fleet = ModelFleet(buckets=(16,), capacity=2, slots_per_family=2)
    t = f"higgs_{FLEET_CUTS[-2]}"  # higgs_300
    srcs = {"other": t, t: t, "train_cat_20": "train_cat_20"}
    for name, src in srcs.items():
        fleet.load(name, tenants[src][0],
                   num_features=tenants[src][1].shape[1])
    rows = tenants[t][1][:16]
    got, where = [], []
    for name in ("other", t, "other", "train_cat_20", t):
        out = fleet.predict(name, tenants[srcs[name]][1][:16],
                            raw_score=True)
        if name == t:
            got.append(out)
            where.append(fleet._names[name]["versions"][0].slot)
    stack, = fleet._stacks[fleet._names[t]["versions"][0].family]
    out = {"slots": where, "same_bits": bool(
        np.array_equal(got[0], got[1])
        and np.array_equal(got[0], refs[t][:16])),
        "captures": stack.programs.captures, "rows": int(rows.shape[0])}
    fleet.close()
    return out


def serve_phases(torch, lgb, ch, hist, np, ds, Xv, cat_sets, rank_sets):
    """Every serving phase in order; returns the take_small_serve kernel
    line and the launches of the serve_forest run."""
    bst, launches, small20 = serve_forest_phase(torch, lgb, ch, np, ds, Xv,
                                                cat_sets, rank_sets)
    forest = lgb.serving.TensorForest.from_booster(bst)
    line = take_small_serve_line(torch, hist, ch, forest)
    emit_kernel("take_small_serve", line)
    del forest
    pool = Xv[:20_000]
    serve_dispatch_phase(torch, np, lgb, bst, pool)
    B = BENCH_SERVE
    rs = np.random.RandomState(0)
    Xb = rs.randn(B["train_rows"], B["features"]).astype(np.float32)
    yb = (Xb[:, 0] + 0.5 * Xb[:, 1] > 0).astype(np.float32)
    small = lgb.train({"objective": "binary", "num_leaves": B["leaves"],
                       "verbosity": -1},
                      lgb.Dataset(Xb, label=yb, free_raw_data=False),
                      B["trees"])
    serve_loaded_phase(torch, np, lgb, small, B["features"],
                       "bench_serve_50x31")
    serve_loaded_phase(torch, np, lgb, bst, Xv.shape[1], "higgs_500x255")
    serve_http_phase(np, lgb, small, B["features"])
    gateway_phase(torch, np, lgb, ch, small, B["features"])
    ops_processes_phase(np, small, B["features"])
    serve_contrib_phase(torch, np, lgb, small, B["features"], rows=64)
    serve_fleet_phase(torch, np, lgb, bst, Xv[:4096], small20)
    return line, launches


# ---- the distributed learners (ROADMAP A.8) ----------------------------
DIST_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 20,
               "verbosity": -1}
# run, tree learner, extra params, trees (the first is the warm tree).
# At 500,000 rows a rank the int16 path's worst-case sums pass 2^24, so
# its histograms cross as f32 sums of the integer levels (rs_wire_dtype
# None, as in the JAX package); use_quantized_grad's 4 levels keep them
# under it and ride the int32 reduce-scatter (use_rs)
DIST_RUNS = (("data", "data", {}, 3),
             ("data_quant", "data", {"use_quantized_grad": True}, 3),
             ("voting", "voting", {}, 3),
             ("feature", "feature", {"tpu_growth_mode": "exact",
                                     "enable_bundle": False}, 2))
# the kernels each run's trees launch on every rank
DIST_KERNELS = {"data": ("hist_nat", "hist_round", "take_small", "seg_sum"),
                "data_quant": ("hist_nat_int8", "hist_round_int8",
                               "take_small"),
                "voting": ("hist_nat", "hist_round", "take_small",
                           "seg_sum"),
                "feature": ("hist", "take_small")}


def _trees_text(model: str) -> str:
    """The trees of a model text, without the header and parameters that
    name the learner."""
    i = model.index("Tree=0") if "Tree=0" in model else 0
    return model[i:model.index("end of trees")]


def _eager_cb():
    def eager(env):
        pass

    eager.before_iteration = True  # keeps a serial run on the eager loop
    return eager


def _dist_blocks(n: int, world: int):
    return [(n * r // world, n * (r + 1) // world) for r in range(world)]


def dist_rank_main(argv) -> int:
    """One gloo rank of the distributed phase: python3 chip_smoke.py
    --dist-rank RANK WORLD STORE OUT_DIR MODEL DEVICE ROWS."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.learner import cuda_hist as ch
    from lightgbm_tpu_torch.parallel import multihost
    from lightgbm_tpu_torch.serving import ModelRegistry, TensorForest

    rank, world = int(argv[0]), int(argv[1])
    store, out_dir, model_path, device, rows = argv[2:7]
    rows = int(rows)
    multihost.init_distributed(
        init_method=f"file://{Path(store).resolve()}", num_machines=world,
        machine_rank=rank, backend="gloo")
    X, y, Xv, _ = higgs_like(rows)
    lo, hi = _dist_blocks(len(X), world)[rank]
    params = dict(DIST_PARAMS, device_type=device)
    ref = multihost.bin_reference(X[lo:hi], params)
    out = {"rank": rank, "world": world}
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for run, learner, extra, n_trees in DIST_RUNS:
        p = {**params, **extra, "tree_learner": learner}
        Xr, yr = (X, y) if learner == "feature" else (X[lo:hi], y[lo:hi])
        bst = lgb.Booster(p, lgb.Dataset(Xr, label=yr, reference=ref,
                                         params=p))
        gb = bst._gbdt
        bst.update()  # the warm tree
        sync()
        dist.barrier()
        gb._mesh.stats.reset()
        ch.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n_trees - 1):
            bst.update()
        sync()
        dt = time.perf_counter() - t0
        launches = dict(ch.LAUNCHES)
        st = gb._mesh.stats.as_dict()
        n_t = n_trees - 1
        out[run] = {
            "trees": _trees_text(bst.model_to_string()),
            "resolved": gb.tree_learner_resolved,
            "mesh": gb._mesh.describe(),
            "timed_trees": n_t, "trees_per_s": n_t / dt,
            "collective_ms_per_tree": 1e3 * sum(st["seconds"].values()) / n_t,
            "wire_bytes_per_tree": st["total_bytes"] / n_t,
            "staged_bytes_per_tree": st["staged_bytes"] / n_t,
            "calls_per_tree": {k: v / n_t for k, v in st["calls"].items()},
            "wire_est_bytes_per_tree": (
                gb._dp.wire_bytes_per_tree(int(gb.dev["bins"].shape[0]))
                if learner != "feature" else 0),
            "launches_per_tree": {k: v / n_t for k, v in launches.items()
                                  if v},
        }
        del bst, gb
    # serving's mesh=: this rank scores its block of every request
    with open(model_path) as f:
        text = f.read()
    mesh = multihost.world_mesh()
    Xs = Xv[:20000]
    forest = TensorForest.from_booster(lgb.Booster(model_str=text),
                                       device=device, mesh=mesh)
    reg = ModelRegistry(device=device, mesh=mesh, buckets=(256, 4096))
    reg.load("m", text)
    t0 = time.perf_counter()
    raw = forest.predict_raw(Xs)
    out["serve_s"] = time.perf_counter() - t0
    np.save(Path(out_dir) / f"serve_raw.{rank}.npy", raw)
    np.save(Path(out_dir) / f"serve_reg.{rank}.npy",
            np.asarray(reg.predict("m", Xs)))
    out["serve_buckets"] = list(reg._entry("m").dispatcher.buckets)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def nccl_rank_main(argv) -> int:
    """The one-rank NCCL run of the distributed phase: python3
    chip_smoke.py --nccl-rank STORE OUT_DIR ROWS. The collective layer is
    forced onto the one rank (comm.make_mesh at min_size 1), so data,
    voting and feature run every collective through NCCL on CUDA
    tensors, against the serial run."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.parallel import comm, multihost

    store, out_dir, rows = argv[0], argv[1], int(argv[2])
    multihost.init_distributed(
        init_method=f"file://{Path(store).resolve()}", num_machines=1,
        machine_rank=0, backend="nccl", device="cuda:0")
    make_mesh = comm.make_mesh
    comm.make_mesh = lambda axis_name="data", device=None, min_size=2: \
        make_mesh(axis_name, device, 1)
    X, y, _, _ = higgs_like(rows)
    params = dict(DIST_PARAMS, device_type="cuda")
    out = {"backend": str(dist.get_backend())}
    for run, learner, extra, _n in DIST_RUNS:
        p = {**params, **extra}
        ds = lgb.Dataset(X, label=y, params=p)
        serial = lgb.train(p, ds, 2, callbacks=[_eager_cb()])
        bst = lgb.train({**p, "tree_learner": learner},
                        lgb.Dataset(X, label=y, reference=ds, params=p), 2)
        gb = bst._gbdt
        out[run] = {
            "bitwise_vs_serial": _trees_text(bst.model_to_string())
            == _trees_text(serial.model_to_string()),
            "resolved": gb.tree_learner_resolved,
            "mesh": gb._mesh.describe(),
            "calls": gb._mesh.stats.as_dict()["calls"],
            "fused": gb._fused is not None,
        }
    # the layer on CUDA tensors at one rank: reduce_scatter (int16 ->
    # int32, padded), all_gather, all_reduce sum and max
    m = comm.Mesh(None, "data", torch.device("cuda"))
    x = torch.arange(3 * 5 * 2, dtype=torch.int16,
                     device="cuda").reshape(3, 5, 2)
    rs = m.reduce_scatter(x, dim=1)
    ag = m.all_gather(torch.ones(4, device="cuda"))
    ar = m.all_reduce(torch.tensor([1.5, 2.0], device="cuda"), "max")
    out["layer"] = {
        "reduce_scatter_ok": bool(torch.equal(rs.cpu(), x.cpu().int())),
        "reduce_scatter_dtype": str(rs.dtype),
        "all_gather_shape": list(ag.shape),
        "all_reduce_max": ar.cpu().tolist(),
        "stats": m.stats.as_dict()}
    with open(Path(out_dir) / "nccl.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _spawn(args, log_path, env=None):
    with open(log_path, "w") as lf:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                                + [str(a) for a in args], stdout=lf,
                                stderr=subprocess.STDOUT, env=env)


def _wait_all(procs, logs, timeout: float) -> None:
    """Wait for every process; kill them all on a timeout or a failure,
    and raise with the failing one's log."""
    deadline = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, lp in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"{lp} exited {p.returncode}: "
                                 + Path(lp).read_text()[-3000:])


def distributed_phase(torch, np, lgb, X, y, Xv, device="cuda",
                      nccl_rows=50_000, world=2):
    """The distributed learners on the card (module docstring,
    `distributed`): the serial runs here, the ranks in processes."""
    import shutil

    t_phase = time.perf_counter()
    work = Path("build") / "chip_smoke" / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the one-rank NCCL process checks equality only: it runs beside the
    # serial references and the gloo ranks' set-up
    nlog = str(work / "nccl.log")
    nccl_proc = (_spawn(["--nccl-rank", work / "nccl_store", work,
                         nccl_rows], nlog) if nccl_rows else None)
    try:
        _distributed_checks(torch, np, lgb, X, y, Xv, device, world, work,
                            t_phase, nccl_rows, nccl_proc, nlog)
    finally:
        if nccl_proc is not None and nccl_proc.poll() is None:
            nccl_proc.kill()
            nccl_proc.wait()


def _distributed_checks(torch, np, lgb, X, y, Xv, device, world, work,
                        t_phase, nccl_rows, nccl_proc, nlog):
    """distributed_phase's serial runs, gloo ranks and checks (the NCCL
    process already started beside them)."""
    from lightgbm_tpu_torch.parallel.multihost import (binning_sample,
                                                       reference_dataset)
    from lightgbm_tpu_torch.serving import ModelRegistry, TensorForest

    params = dict(DIST_PARAMS, device_type=device)
    # one process holding every row, binned on the ranks' gathered sample
    ref = reference_dataset(np.concatenate(
        [binning_sample(X[lo:hi], params, world)
         for lo, hi in _dist_blocks(len(X), world)]), params)
    serial = {}
    for run, learner, extra, n_trees in DIST_RUNS:
        p = {**params, **extra}
        t0 = time.perf_counter()
        bst = lgb.train(p, lgb.Dataset(X, label=y, reference=ref, params=p),
                        n_trees, callbacks=[_eager_cb()])
        serial[run] = {"trees": _trees_text(bst.model_to_string()),
                       "seconds": time.perf_counter() - t0}
        if run == "data":
            model_path = work / "serial_data.txt"
            bst.save_model(model_path)
        del bst
    text = model_path.read_text()
    Xs = Xv[:20000]
    raw_1 = TensorForest.from_booster(lgb.Booster(model_str=text),
                                      device=device).predict_raw(Xs)
    reg = ModelRegistry(device=device, buckets=(256, 4096))
    reg.load("m", text)
    reg_1 = np.asarray(reg.predict("m", Xs))
    del reg

    t_ranks = time.perf_counter()
    logs = [str(work / f"rank{r}.log") for r in range(world)]
    procs = [_spawn(["--dist-rank", r, world, work / "store", work,
                     model_path, device, len(X)], logs[r])
             for r in range(world)]
    _wait_all(procs, logs, 900)
    ranks_s = time.perf_counter() - t_ranks
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]
    failures = []
    for run, learner, _extra, n_trees in DIST_RUNS:
        r0 = outs[0][run]
        bitwise = all(o[run]["trees"] == serial[run]["trees"]
                      for o in outs)
        missing = [k for k in DIST_KERNELS[run]
                   if not all(o[run]["launches_per_tree"].get(k, 0) > 0
                              for o in outs)]
        emit({"phase": "distributed", "run": run, "learner": learner,
              "world": world,
              "rows": int(len(X)), "features": int(X.shape[1]),
              "num_leaves": DIST_PARAMS["num_leaves"], "trees": n_trees,
              "mesh": r0["mesh"], "resolved": r0["resolved"],
              "bitwise_vs_serial": bitwise,
              "trees_per_s": [o[run]["trees_per_s"] for o in outs],
              "serial_seconds_incl_dataset": serial[run]["seconds"],
              "collective_ms_per_tree": [o[run]["collective_ms_per_tree"]
                                         for o in outs],
              "wire_bytes_per_tree": r0["wire_bytes_per_tree"],
              "wire_est_bytes_per_tree": r0["wire_est_bytes_per_tree"],
              "staged_bytes_per_tree": r0["staged_bytes_per_tree"],
              "calls_per_tree": r0["calls_per_tree"],
              "launches_per_tree": [o[run]["launches_per_tree"]
                                    for o in outs],
              "kernels_not_launched": missing})
        if not bitwise or missing or r0["resolved"] != learner:
            failures.append(run)
    serve_ok = []
    for r in range(world):
        raw_m = np.load(work / f"serve_raw.{r}.npy")
        reg_m = np.load(work / f"serve_reg.{r}.npy")
        serve_ok.append(bool(np.array_equal(raw_m, raw_1)
                             and np.array_equal(reg_m, reg_1)))
    emit({"phase": "distributed_serve", "world": world, "rows": len(Xs),
          "bitwise_vs_single_process": serve_ok,
          "buckets": outs[0]["serve_buckets"],
          "predict_raw_s": [o["serve_s"] for o in outs]})
    if not all(serve_ok):
        failures.append("serve")

    if nccl_proc is not None:
        failures += nccl_part(work, nccl_rows, nccl_proc, nlog)
    emit({"phase": "distributed_summary", "seconds":
          time.perf_counter() - t_phase, "ranks_seconds": ranks_s,
          "failures": failures})
    if failures:
        raise AssertionError(f"distributed phase failed: {failures}")




def nccl_part(work, nccl_rows, proc, nlog) -> list:
    """The one-rank NCCL process of the distributed phase, waited for;
    -> what failed."""
    failures = []
    t_wait = time.perf_counter()
    _wait_all([proc], [nlog], 600)
    nccl = json.loads((work / "nccl.json").read_text())
    emit({"phase": "distributed_nccl", "world": 1, "rows": nccl_rows,
          "wait_seconds": time.perf_counter() - t_wait, **nccl})
    for run, learner, _e, _n in DIST_RUNS:
        if not (nccl[run]["bitwise_vs_serial"]
                and nccl[run]["resolved"] == learner
                and nccl[run]["mesh"]["backend"] == "nccl"):
            failures.append(f"nccl_{run}")
    if not nccl["data_quant"]["calls"].get("reduce_scatter"):
        failures.append("nccl_reduce_scatter")
    if not (nccl["layer"]["reduce_scatter_ok"]
            and nccl["layer"]["reduce_scatter_dtype"] == "torch.int32"):
        failures.append("nccl_layer")
    return failures


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch sees no CUDA device\n")
        return 2
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.learner import cuda_hist as ch
    from lightgbm_tpu_torch.learner import histogram as hist

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0)})

    from lightgbm_tpu_torch import native

    t0 = time.perf_counter()
    ch.build()
    ch.load()
    nvcc_wall = time.perf_counter() - t0
    native_lib = native.get_lib()
    emit({"phase": "build", "seconds": nvcc_wall,
          "nvcc_seconds": ch.BUILD_SECONDS,
          "library": str(ch.library_path()),
          "native_loaded": native_lib is not None,
          "native_gxx_seconds": native.BUILD_SECONDS,
          "native_library": str(native.library_path())})
    if native_lib is None:
        raise AssertionError(f"the native library did not build: "
                             f"{native.BUILD_ERROR}")

    lines, cat_synth, take_synth = kernel_phase(torch, hist, ch)
    small_phase(lgb, np)

    # ---- train: the repo's headline workload at full width
    X, y, Xv, yv = higgs_like(1_000_000)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "metric": "auc",
              "verbosity": -1}
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, free_raw_data=False)
    ds.construct()
    vs = lgb.Dataset(Xv, label=yv, reference=ds, free_raw_data=False)
    t_data = time.perf_counter() - t0
    ch.reset_launch_counts()
    # the peak of this path, not of the kernel phase's plain versions
    torch.cuda.reset_peak_memory_stats()
    bst = lgb.Booster(params, ds)
    bst.add_valid(vs, "valid")
    takes = {}  # the take_small line's arguments, k -> (tab, idx)
    round_caps = {"train": {}, "train_quant": {}, "train_f32": {},
                  "train_bag": {}, "train_goss": {}}
    root_caps = {"train": {}, "train_bag": {}, "train_goss": {}}
    with recording_takes(ch, takes, (1, 8)), \
            recording_rounds(round_caps["train"]), \
            recording_root(root_caps["train"]):
        bst.update()
    auc1 = bst.eval_valid()[0][2]
    bst.update()
    torch.cuda.synchronize()
    n_timed = 10
    t0 = time.perf_counter()
    for _ in range(n_timed):
        bst.update()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    auc_last = bst.eval_valid()[0][2]
    launches = dict(ch.LAUNCHES)
    gb = bst._gbdt
    emit({"phase": "train", "rows": int(X.shape[0]), "features": 28,
          "num_leaves": 255, "hist_dtype": gb.hist_dtype,
          "dataset_seconds": t_data, "warmup_trees": 2,
          "timed_trees": n_timed, "trees_per_s": n_timed / dt,
          "auc_tree1": auc1, "auc_last": auc_last,
          "trees": 2 + n_timed, "launches": launches,
          "peak_device_mb": torch.cuda.max_memory_allocated() / 2 ** 20})
    int_path = [k for k, p in PATH_OF.items() if p == "train"]
    if not all(launches[k] > 0 for k in int_path):
        raise AssertionError(f"a kernel was not launched: {launches}")
    if not (auc_last > auc1 and auc_last > 0.85):
        raise AssertionError(f"AUC did not improve: {auc1} -> {auc_last}")
    profile_phase(torch, bst, 1)

    # ---- model: text round trip and host-vs-card agreement
    out_dir = Path("build") / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "model.txt"
    bst.save_model(path)
    loaded = lgb.Booster(model_file=path)
    p_trained = bst.predict(Xv[:1000], raw_score=True)
    p_loaded = loaded.predict(Xv[:1000], raw_score=True)
    card = gb.valids[0].score[0, :1000].cpu().numpy().astype(np.float64)
    host_vs_card = float(np.abs(p_trained - card).max())
    emit({"phase": "model", "rows": 1000,
          "identical_after_reload": bool(np.array_equal(p_trained, p_loaded)),
          "max_abs_host_vs_card": host_vs_card, "tolerance": 1e-4,
          "finite": bool(np.isfinite(p_trained).all())})
    if not np.array_equal(p_trained, p_loaded):
        raise AssertionError("reloaded model predicts differently")
    if not (np.isfinite(p_trained).all() and host_vs_card < 1e-4):
        raise AssertionError("host predictions disagree with card scores")
    # ---- the out-of-core data plane on the same rows
    data_plane_phase(torch, lgb, ch, np, X, y, Xv, ds, params, smi)

    # ---- the sampled paths: bagging with feature_fraction, then GOSS
    # (int(1 / 0.1) + 1 = 11 trees before it samples), and continued
    # training from the saved model
    bag, _ = train_sampled_path(
        torch, lgb, ch, ds, vs, "train_bag", BAG_PARAMS, 0, 2, n_timed,
        round_caps["train_bag"], root_caps["train_bag"])
    goss, _ = train_sampled_path(
        torch, lgb, ch, ds, vs, "train_goss", GOSS_PARAMS, 11, 2, n_timed,
        round_caps["train_goss"], root_caps["train_goss"])
    train_continue_phase(torch, lgb, np, ds, vs, Xv, path)

    # ---- the Python API: cv on the fused loop, the Booster accessors,
    # a one-hot CSR and text / binary file inputs
    api_cv_phase(torch, lgb, np, ds)
    api_booster_phase(torch, lgb, np, bst, Xv, yv)
    api_sparse_phase(torch, lgb, np, ch)
    api_file_phase(torch, lgb, np, X, y)
    # ---- the command line (kill, resume, predict, serve with a faulted
    # device call) on binary caches of this data; the flight recorder
    cli = cli_phase(torch, lgb, np, ds, vs, Xv, yv)
    v0_path = Path("build") / "chip_smoke" / "cli" / "clean" / "model.txt"
    emit({"phase": "fallback_latency", **fallback_latency(
        np, lgb, v0_path, Xv),
        "cli_serve_fallback_vs_device": cli["serve_fallback_vs_device"]})
    # ---- the online train-and-serve loop on the cli phase's model
    online_loop_phase(torch, lgb, ch, np, Xv, yv, v0_path)
    recorder_phase(torch, lgb, np, ds, vs)

    # ---- use_quantized_grad on the same binned data: the int8 modes,
    # compared with the int16 path at the same tree count
    quant, _ = train_int_path(
        torch, lgb, ch, ds, vs, "train_quant", QUANT_PARAMS, 2, n_timed,
        ("hist_nat_int8", "hist_round_int8", "take_small", "seg_sum"),
        rounds_cap=round_caps["train_quant"])
    emit({"phase": "train_quant_vs_int16", "trees": quant["trees"],
          "auc_int16": auc_last, "auc_quant": quant["metric_last"],
          "auc_gap": quant["metric_last"] - auc_last})
    if quant["hist_dtype"] != "int8":
        raise AssertionError(f"train_quant ran {quant['hist_dtype']}")
    if not (quant["metric_last"] > quant["metric_tree1"]
            and quant["metric_last"] > 0.85):
        raise AssertionError(f"train_quant: AUC did not improve: {quant}")

    # ---- regression_l1: the percentile refit through hist_nat's f32 mode
    _, z, _, zv = higgs_stream(1_000_000)
    ds_l1 = lgb.Dataset(X, label=z, reference=ds, free_raw_data=False)
    vs_l1 = lgb.Dataset(Xv, label=zv, reference=ds, free_raw_data=False)
    refit = {"train_l1": {}, "train_l1_31": {}}
    l1, _ = train_int_path(
        torch, lgb, ch, ds_l1, vs_l1, "train_l1",
        {"objective": "regression_l1", "metric": "l1"}, 1, 3,
        ("hist_nat", "hist_round", "hist_nat_f32", "take_small", "seg_sum"),
        capture=refit["train_l1"], takes=takes)
    if l1["launches"]["hist_nat_f32"] != 4 * l1["trees"]:
        raise AssertionError(f"train_l1: hist_nat_f32 launched "
                             f"{l1['launches']['hist_nat_f32']} times in "
                             f"{l1['trees']} trees, not 4 per tree")
    if not l1["metric_last"] < l1["metric_tree1"]:
        raise AssertionError(f"train_l1: L1 did not fall: {l1}")
    # LightGBM's default 31 leaves: the refit's other slot count
    l1_31, _ = train_int_path(
        torch, lgb, ch, ds_l1, vs_l1, "train_l1_31",
        {"objective": "regression_l1", "metric": "l1", "num_leaves": 31},
        1, 2, ("hist_nat_f32",), capture=refit["train_l1_31"])
    if not l1_31["metric_last"] < l1_31["metric_tree1"]:
        raise AssertionError(f"train_l1_31: L1 did not fall: {l1_31}")
    if ([c.get("n") for c in refit.values()] != [4, 4]
            or sorted(takes) != [1, 2, 8]):
        raise AssertionError(f"captured {[c.get('n') for c in refit.values()]}"
                             f" refit passes and take_small heights "
                             f"{sorted(takes)}")
    lines["hist_nat_f32"] = hist_nat_f32_line(torch, hist, ch, refit)
    emit_kernel("hist_nat_f32", lines["hist_nat_f32"])
    lines["take_small"] = take_small_line(torch, hist, takes, take_synth)
    emit_kernel("take_small", lines["take_small"])
    del refit, takes
    path_launches = {"train": launches, "train_quant": quant["launches"],
                     "train_l1": l1["launches"]}

    # ---- the f32 paths on the same binned data
    from lightgbm_tpu_torch.learner import permuted

    captured = {}
    seg_calls = {"train_exact": {}, "train_exact_rounds": {}}
    f32_profiles = {}
    for name in F32_PATHS:
        path_launches[name], f32_profiles[name] = train_f32_path(
            torch, lgb, ch, permuted, ds, vs, name,
            capture=captured if name == "train_exact_rounds" else None,
            rounds_cap=round_caps.get(name), seg_calls=seg_calls.get(name))
    if not captured:
        raise AssertionError("no hist_slots call was captured")
    lines["hist_slots"] = hist_slots_line(torch, hist, captured)
    emit_kernel("hist_slots", lines["hist_slots"])
    # ---- a whole tree's hist and hist_slots calls, replayed
    emit({"phase": "kernel", "name": "hist_tree",
          **hist_tree_line(torch, hist, seg_calls["train_exact"])})
    emit({"phase": "kernel", "name": "hist_slots_tree",
          **hist_slots_tree_line(torch, hist,
                                 seg_calls["train_exact_rounds"])})
    del seg_calls

    # ---- the fused loop: the eager loop and the CUDA-graph loop in turns
    # on each rounds path (train_cat after its own phase)
    fused_lines = {}
    # (train_goss: 3 timed trees, 6 before the online loop came)
    for name, sets, extra, skip, timed in (
            ("train", (ds, vs), {}, 0, 3),
            ("train_bag", (ds, vs), BAG_PARAMS, 0, 3),
            ("train_goss", (ds, vs), GOSS_PARAMS, 11, 3),
            ("train_quant", (ds, vs), QUANT_PARAMS, 0, 3),
            ("train_l1", (ds_l1, vs_l1),
             {"objective": "regression_l1", "metric": "l1"}, 0, 3),
            ("train_f32", (ds, vs), F32_PATHS["train_f32"], 0, 3)):
        fused_lines[name] = fused_vs_eager(torch, lgb, *sets, name, extra,
                                           n_timed=timed, n_skip=skip)
    # ... and on the exact grower with and without its round phase: 1
    # timed tree (3 before the online loop came, 2 before ops_processes;
    # an eager exact tree takes ~1.7 s) and the eager loop's profile from
    # its f32 path phase
    for name in ("train_exact", "train_exact_rounds"):
        fused_lines[name] = fused_vs_eager(
            torch, lgb, ds, vs, name, F32_PATHS[name], n_timed=1,
            eager_profile=f32_profiles[name])

    # ---- DART and RF (eager loop), every per-node extra on together and
    # a 3-level forced plan (both loops, in turns)
    # (20 trees each, 30 before the online loop came; train_extras and
    # train_forced 3 timed trees, 6 before)
    train_dart_phase(torch, lgb, ch, np, ds, vs, n_trees=20)
    train_rf_phase(torch, lgb, ch, np, ds, vs, Xv, n_trees=20)
    fused_lines["train_extras"] = fused_vs_eager(
        torch, lgb, ds, vs, "train_extras", extras_params(X.shape[1]),
        n_timed=3, check=lambda b: group_crossings(b, X.shape[1]))
    forced_path = Path("build") / "chip_smoke" / "forced.json"
    forced_path.write_text(json.dumps(FORCED_PLAN))
    fused_lines["train_forced"] = fused_vs_eager(
        torch, lgb, ds, vs, "train_forced",
        {"forcedsplits_filename": str(forced_path)}, n_timed=3,
        check=forced_plan_held)

    # ---- monotone intermediate and advanced (both loops, in turns) with
    # basic beside them, intermediate on the exact grower, linear trees
    dirs = mono_directions(np, X, y)
    dm, vm = mono_sets(lgb, X, y, Xv, yv, dirs)
    for method in ("intermediate", "advanced"):
        fused_lines["train_mono_" + method] = train_mono_phase(
            torch, lgb, np, dm, vm, Xv, method, dirs)
    train_mono_basic_line(torch, lgb, dm, vm, dirs)
    train_mono_exact_phase(torch, lgb, ch, np, dm, vm, Xv, dirs)
    fused_lines["train_mono_exact"] = fused_vs_eager(
        torch, lgb, dm, vm, "train_mono_exact",
        {"num_leaves": 63, "tpu_growth_mode": "exact",
         **mono_params(X.shape[1], "intermediate", dirs)}, n_timed=2)
    del dm, vm
    train_linear_phase(torch, lgb, ch, np, X, y, Xv, yv, ds, n_trees=2)

    # ---- hist_round in each mode on its path's first and fullest rounds
    # (the int16 mode also on the sampled paths' first sampled trees), and
    # hist_nat on the roots of the unsampled and the sampled paths
    for name, paths in (("hist_round", ("train", "train_bag", "train_goss")),
                        ("hist_round_int8", ("train_quant",)),
                        ("hist_round_f32", ("train_f32",))):
        lines[name]["shapes"] = {}
        for path_ in paths:
            lines[name]["shapes"].update(captured_round_shapes(
                torch, hist, ch, round_caps[path_], path_))
        emit_kernel(name, lines[name])
    lines["hist_nat"]["shapes"] = {
        f"{p_}_root": nat_shape(torch, hist, root_caps[p_]["args"],
                                f"hist_nat {p_} root")
        for p_ in root_caps}
    emit_kernel("hist_nat", lines["hist_nat"])
    del round_caps, root_caps

    # ---- categorical splits on the airline schema
    cat_round = {}
    cat, _, cat_sets = train_cat_path(torch, lgb, ch, np, capture=cat_round)
    path_launches["train_cat"] = cat["launches"]
    # (3 timed trees, 6 before the online loop came)
    fused_lines["train_cat"] = fused_vs_eager(torch, lgb, *cat_sets,
                                              "train_cat", {}, n_timed=3)
    if "fullest" not in cat_round:
        raise AssertionError("no categorical hist_round call was captured")
    lines["hist_round_cat"] = hist_round_cat_line(torch, hist, ch,
                                                  cat_round["fullest"],
                                                  cat_synth)
    emit_kernel("hist_round_cat", lines["hist_round_cat"])

    # ---- learning to rank at MSLR-WEB10K's shape: lambdarank (the
    # lambdarank kernel) and rank_xendcg, both loops; then small runs of
    # bagging_by_query and position debiasing against the CPU
    rank, lines["lambdarank"], rank_sets = train_rank_phase(torch, lgb, ch)
    path_launches["train_rank"] = rank["eager"]["launches_counted"]
    fused_lines["train_rank"] = rank
    rank_small_phase(lgb, np)

    # ---- serving: the 500-tree forest on the card against the host
    # walker, the take_small_serve line, the bucketed dispatcher's
    # graphs, bench_serve's loaded phases, HTTP and device TreeSHAP
    lines["take_small_serve"], serve_launches = serve_phases(
        torch, lgb, ch, hist, np, ds, Xv, cat_sets, rank_sets)
    path_launches["serve_forest"] = {"take_small_serve":
                                     serve_launches["take_small"]}
    del cat_sets, rank_sets

    # ---- the distributed learners: gloo ranks sharing the card, one
    # NCCL rank, serving's mesh=
    distributed_phase(torch, np, lgb, X, y, Xv)

    kernels = []
    for name, d in lines.items():
        path = PATH_OF[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "path": path,
            "launches": path_launches[path][name],
            "max_abs_err": d["max_abs_err"], "ms": d["ms"],
            "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": d["library_ms"],
            **{k: d[k] for k in ("device_ms", "host_us") if k in d},
        })
    emit({"phase": "fused_summary", "nvidia_smi": smi, "paths": {
        k: {"eager_trees_per_s": v["eager"]["trees_per_s"],
            "fused_trees_per_s": v["fused"]["trees_per_s"],
            "speedup": v["speedup"],
            "eager_busy": v["eager"]["device_busy_share"],
            "fused_busy": v["fused"]["device_busy_share"],
            "capture_s": v["fused"]["capture_s"],
            "graph_nodes": v["fused"]["graph_nodes"],
            "rounds_per_tree": v["fused"]["rounds_per_tree"]}
        for k, v in fused_lines.items()}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-rank"]:
        sys.exit(nccl_rank_main(sys.argv[2:]))
    sys.exit(main())
