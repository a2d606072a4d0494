#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (h2o3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --psvm-cpu-reference
    python3 chip_smoke.py --airline-cpu-reference

The second form only runs run (ac)'s PSVM on the host's CPU, on (ac)'s
frame made on the card and copied to the host, and prints the AUC that
PSVM_AUC_BAR is set from; the third runs (ao)'s GBM on the host's CPU at
AIR_CPU_N rows of its generator and prints the held-out AUC that
AIR_AUC_BAR is set from. Neither prints a result line.

Phases, each printing its lines before the last:
  1. the card (nvidia-smi name and power limit, torch's device name) and
     the kernels' build: every csrc/*.cu compiled by nvcc for sm_90a, all
     sources at once, with each kernel's registers and the atomic
     instructions it compiled to; the f32 dense, fused and shallow-window
     kernels must show no compare-and-swap shared atomic, and no
     instantiation of the shallow-window kernel, of the int8 fused or
     int8 dense kernels' column groups, of the int8 pack kernel or of the
     non-terminal route kernel's rows per thread may spill;
  2. each kernel against its plain PyTorch version on the card (for f32
     histograms, the plain version in float64; int32 histograms must be
     equal), at small shapes and at C_pad 32 and 56 (Covertype's 54
     columns: a partial last column group in every kernel): route with
     and without the margin update at L = 64, 256 and 512; the dense
     histogram, f32 and int8, with half False and True at L = 1, 64 and
     128 and half at L = 256 and 512 (levels 8 and 9 of a depth-10 tree);
     the shallow-window histogram at L = 1 full and L = 2 and 4 half, f32
     and int8; the fused route+histogram at L_h = 2, 4 and 32, f32 and
     int8, heap ids identical; then the f32 dense, fused and
     shallow-window kernels on adversarial stats (weights up to 1e4,
     alternating-sign grads, every row in one slot and one bin, one NaN
     and one inf stat: their bins as in float64, every other bin within
     tolerance), each launched twice on the same inputs with bit-identical
     results; and (be) the port's own gate, ops/parity.kernel_parity_check
     (its deviations printed);
  3. the main path at small size: a seeded CSV through import_file, a
     bernoulli GBM (the default configuration, then int8_hist=True),
     predict and AUC, on the card and on the CPU (plain versions), which
     must agree; then on the same CSV XGBoost, a UniformAdaptive GBM and an
     isolation forest (the same draws on both) on the adaptive engine,
     card against CPU: AUC (the forest's score AUC against the label)
     within 1e-3, no kernel launch; and a seeded SVMLight, ARFF, csv.gz
     and csv.zip file through import_file on the card and the CPU (the
     same columns bit for bit; StrVec and UuidVec ops; the SVMLight
     frame's sparse GLM within 1e-5 of the largest coefficient);
  4. the multinomial path at Covertype width (581,012 rows x 54 features,
     7 classes, made on the card from a seeded torch.Generator), each run
     with its launch counts per tree and its peak memory:
       (d) GBM distribution="multinomial", depth 8 over 255 bins, 20
           iterations (140 trees) with a 100,000-row validation frame:
           probabilities sum to 1, training logloss below the class
           prior's entropy, the last history entry equal to the final
           training logloss;
       (e) (d) as 10 iterations, then a checkpoint restart to 20: its
           training and validation logloss against (d)'s, its trees that
           split as (d)'s, and a restart with too few trees refused;
     and 2 iterations of (d) with a stopwatch on each estimator stage;
       (i) a multinomial DRF at DRF's defaults (depth 20) on the same
           frame, 3 iterations of 7 class trees: training logloss at
           least 0.25 below the class prior's entropy;
     then the main path at full width on a HIGGS-shaped frame (11M rows x
     28 features, made on the card from a seeded torch.Generator), GBM of
     depth 8 over 255 bins through the estimator, each run with its launch
     counts per tree checked:
       (a) the sequential route-then-histogram path
           (radix_shallow=False, fused_level=False), 10 trees, predict
           and AUC;
       (b) the default configuration (shallow-window kernel at level 0,
           fused kernel at levels 1-5, route + dense histogram at 6-7),
           50 trees with a 1M-row validation frame and early stopping
           armed; train and validation AUC, trees built, throughput and
           peak memory; model_performance(valid) equal to train()'s
           validation metrics within 1e-7 (AUC, logloss), and to_dict()
           through json.dumps;
       (c) (b) with int8_hist=True;
       (f) a binomial DRF to depth 10 on the same frame, 20 trees,
           sample_rate 0.632, mtries -1, with the validation frame: OOB
           and validation AUC, the validation series, predict timed;
     then a default-configuration run of 10 trees with a stopwatch on each
     estimator stage and each kernel wrapper, and a run (c) of 10 trees
     under torch.profiler: the share of the train() window in which the
     card is busy, and the busiest kernels; then on the adaptive engine
     (plain PyTorch: no kernel launch may count), each run with the
     seconds a tree, the deepest level and its peak memory:
       (g) XGBoost at its defaults (depth 6, eta 0.3, 256 bins), 20 trees
           with the validation frame: train and validation AUC > 0.7, the
           history's validation AUC equal to the final one, a second
           training's trees equal bit for bit; TreeSHAP of 10,000 rows
           summing to the margin within 1e-4;
       (h) DRF at H2O's defaults (depth 20, 20 bins, mtries -1, sample
           rate 0.632, min_rows 1), 10 trees: OOB AUC > 0.7;
     with one tree of (g) and one of (h) under a stopwatch on each stage
     of the adaptive engine (select, ranges, binning, histogram, split
     search, route, gamma_pass, covers), each beside its bound;
     and (j) an isolation forest at H2O's defaults (50 trees, depth 8,
     256-row samples) at the width of the credit-card fraud set (284,807
     rows x 30 columns, 492 planted anomalies): the score's AUC against the
     planted labels above a bar set from a CPU run;
     then GLM, cross-validation and the custom distribution (phase 3 also
     fits the CSV's GLM binomial and gaussian on the card and the CPU:
     the coefficients its one-hot design determines within 1e-4,
     predictions within 1e-5, each widened to 8 f32 ulps of the largest
     coefficient where a singular design let them drift), with the TF32
     setting printed (it must be off):
       (k) GLM binomial IRLSM at lambda 0 on the HIGGS frame, standardised,
           with p-values, 5-fold CV and a torch custom-metric logloss: train
           and validation AUC > 0.7, the custom metric within 1e-6 of the
           logloss, CV AUC within 0.01 of the training AUC, the f32 Gram
           within 1e-5 of a float64 Gram of the same X (relative to its
           largest entry), a 200,000-row slice fitted on the card and on
           the CPU (coefficients within 1e-4, AUC within 1e-5);
           model_performance(valid) equal to the validation metrics
           within 1e-7 (AUC, logloss) and to_dict() through json.dumps,
           as for (b); the CV
           split and fold fits timed apart; then one fit under a stopwatch
           on each IRLS stage (eta pass, working weights, Gram pass, host
           copy, float64 solve), each beside its bound;
       (l) elastic net (alpha 0.5) down a 30-step lambda path: 30 lambdas,
           no active predictor at the first, more at the last, whose AUC
           is within 0.002 of (k)'s;
       (m) GLM multinomial IRLSM on the Covertype frame with its 4 + 40
           indicator fields as two categorical columns, which the one-hot
           design expands back, less each column's first level (neither
           has an NA): its 52 feature names, training logloss below the
           class prior's entropy, the per-class Gram timed; and the same
           fit on every level's design (the JAX package's, before the
           repair): its IRLS sweeps and logloss beside (m)'s, which may
           not be higher by more than 1e-4;
       (n) (m) by L-BFGS: logloss within 1e-3 of (m)'s;
       (o) GBM with a gaussian custom distribution (a torch UDF) against
           distribution="gaussian", 10 UniformAdaptive trees of depth 6 on
           the HIGGS frame's 0/1 response as a number: the same splits bit
           for bit, the last level's leaves equal, predictions within 1e-6,
           no kernel launch;
       (p) a binned bernoulli GBM, 10 trees of depth 8, 3 stratified
           folds: launches per tree over every tree built as in (b), CV
           AUC within 0.01 of the training AUC, fold sizes within 1% of a
           third;
     then DeepLearning and the unsupervised family (plain PyTorch, TF32
     off; no kernel launch may count), each with its train() seconds and
     peak memory:
       (q) DL binomial at H2O's defaults (hidden [200, 200], Rectifier,
           ADADELTA, mini-batch 256) on the HIGGS frame with its
           validation frame, 0.1 epochs: train AUC > 0.7, validation AUC
           within 0.01 of it; a stage table of a step (forward,
           backward, optimizer, each beside its bound); a torch.profiler
           busy share, launches a step and host time by op over 0.02
           epochs, trained again with the same seed (the largest weight
           difference, and the first op that differs if it is not 0); a
           20,000-row slice card vs CPU with the CPU's draws
           (probabilities within 1e-3);
       (r) DL multinomial on (m)'s Covertype frame, 1 epoch: training
           logloss below the class prior's entropy;
       (s) a Tanh DL autoencoder on (j)'s credit-card frame, 1 epoch:
           anomaly()'s AUC against the planted labels above a bar set from
           a CPU run;
       (t) KMeans k 10 (Furthest, standardised, 10 iterations) on 10
           Gaussian blobs at HIGGS shape: tot_withinss never rising,
           totss and tot_withinss within 1e-5 of float64 sums, sizes
           summing to nobs, each planted centre recovered, a second
           training bit-identical, a 200,000-row slice card vs CPU
           (centroids within 1e-4), a stage table of the Lloyd step;
       (u) PCA k 5 STANDARDIZE on a rank-5 frame at HIGGS shape (+ N(0,
           0.1²) noise): eigenvalues within 1e-5 of a float64 Gram of the
           same X, the cumulative proportion at 5 PCs as planted (1e-3),
           principal angles to the planted loadings below 0.01 rad;
       (v) SVD nv 5 with keep_u on the same frame: d within 1e-5 of
           float64, UᵀU within 1e-4 of I, U·diag(d)·Vᵀ leaving the noise
           outside 5 dimensions (within 5%);
       (w) GLRM k 5 on the same frame with 5% NA: the objective never
           rising, reconstruct()'s RMSE on the held-out entries within 5%
           of what the noise leaves, a stage table of step_A, step_B and
           the objective;
     then the model framework and the standalone models, each with its
     seconds:
       (x) a Cartesian grid of GBMs on the HIGGS frame (max_depth 6, 8 x
           learn_rate 0.1, 0.3, 5 trees) with its validation frame:
           get_grid("auc") sorted, each model's validation AUC equal bit
           for bit to the same parameters trained alone, the grid with
           parallelism 2 the same models, a RandomDiscrete walk
           (max_models 2, seed 42) picking the CPU's combinations, every
           binned kernel launched;
       (y) a stacked ensemble of a GBM (depth 8, 10 trees) and a binomial
           GLM, both 5-fold on the same folds, AUTO metalearner: its
           validation AUC at least the best base model's less 0.001,
           non-negative metalearner coefficients, the level-one set-up
           and the metalearner timed apart;
       (z) train_segments: a multinomial GBM (depth 8, 3 iterations) on
           each wilderness area of (m)'s frame: every segment SUCCEEDED,
           the rows summing to 581,012, each model's training logloss
           equal bit for bit to the same GBM trained alone on its
           subframe;
       (aa) Naive Bayes binomial on the HIGGS frame (AUC above a bar set
           from a CPU run) and multinomial with laplace 1 on (m)'s frame
           (logloss below the prior's entropy), a 20,000-row slice card vs
           CPU (probabilities within 1e-5);
       (ab) CoxPH, Efron ties and 4 strata, on a planted survival frame
           (1M rows x 10 covariates, times in whole days, about 30%
           censored): each beta within 4 SE of its plant, the
           log-likelihood within 1e-6 of a float64 numpy Efron evaluation,
           concordance above 0.5, a Newton iteration beside its bound;
       (ac) PSVM at its defaults on the HIGGS frame: AUC above a bar set
           from CPU fits of the same frame (halfway between the
           converged fit's and one stalled after its first step), the
           float64 gradient at the fit below 1e-3 of its norm at zero (a
           fit stalled at its first step, also run, must fail both), peak
           memory, an iteration's
           and a line-search evaluation's ms, a 20,000-row slice card vs
           CPU (final objective within 1e-5 relative);
       (ad) the quantiles of the HIGGS frame's 28 columns at H2O's default
           probabilities, unweighted and with integer weights 1-3: the
           exact ranks equal to the sorted order statistics, the
           interpolated values within 1 f32 ulp, ms a column beside its
           bound;
     then the models built on ported estimators, each with its seconds:
       (ae) the aggregator at H2O's defaults (5000 exemplars, tolerance
           0.5) on (j)'s credit-card frame: the exemplar count in the
           band, the seconds of each radius sweep; over all rows, in the
           direct distance form, every exemplar farther than r from every
           earlier one, every other row within r of an earlier one and
           counted to its nearest earlier exemplar, the counts summing to
           the rows; the plain row-by-row walk on the CPU over the first
           20,000 rows giving the same exemplars and counts;
       (af) the extended isolation forest at H2O's defaults (100 trees,
           sample size 256) on the same frame, extension_level 0 and 29:
           the score's AUC against the planted labels above a bar set
           from a CPU run; a 10,000-row slice card vs CPU with the same
           draws (mean lengths within 1e-5);
       (ag) GAM binomial on the HIGGS frame with x0, x1 and x4 as gam
           columns: training AUC above a plain binomial GLM's on the same
           predictors, the seconds an IRLS iteration, a 200,000-row slice
           card vs CPU (coefficients within 1e-4 of the largest);
       (ah) RuleFit at its defaults (rule length 3, 20 trees, rules and
           linear terms) on the HIGGS frame: rules generated and selected,
           each selected rule's support in (1%, 99%), the L1 GLM's AUC
           above (ag)'s plain GLM's, launches per tree checked, the
           seconds of the GBM, the rule columns and the GLM path;
       (ai) target encoding on a planted click-through frame (11M rows,
           categoricals of 1,000, 30,000 and 1,000,000 Zipf(1.1) levels,
           5 folds), modes none, loo and kfold with blending: every
           encoded column within 1e-6 relative of a float64 numpy bincount
           version, the seconds of train() and transform;
       (aj) the infogram on the HIGGS frame (28 predictors, depth 5, 20
           bins, 5 trees a model): x0 and x1 admissible, x4 (0.4 sin(X4)
           in the logit) above the information threshold, none of the 21
           noise columns admissible or above it, launches per tree
           checked, the 29 GBMs' seconds;
       (ak) Word2Vec at H2O's defaults (5 epochs) on a planted corpus of
           1M tokens over 3,000 topics of 10 words: the share of 200 probe
           words with 3 of 5 synonyms in their topic above a bar set from
           a CPU run, AVERAGE rows equal to their words' mean vector
           within 1e-6, ms a step and a torch.profiler busy share, and
           whether a short training run twice is bit-identical;
     then the frame data plane (no kernel on its path), each run with
     its seconds and peak memory:
       (al) GLM binomial, alpha 0, lambda 1/n, on rcv1.binary's width
           (697,641 rows x 47,236 Zipf(1.1) terms, ~74 tf-idf nonzeros a
           row, made on the card, built as 47,236 SparseVecs from host
           COO arrays; a planted logit, a 100,000-row validation frame):
           the sparse L-BFGS path, no dense design, two fits compared bit
           for bit, validation AUC within 0.02 of the planted logit's,
           the float64 gradient below 1e-3 of its norm at zero,
           model_performance(valid) = the validation metrics within
           1e-7, a 50,000-row slice card vs CPU (1e-4 of the largest
           coefficient, predictions 1e-5), ms an evaluation beside its
           bound;
       (am) (d)'s frame as covtype.binary (class 2 against the rest)
           written as an SVMLight file and read by import_file (MB/s;
           every feature a SparseVec, the values the generator's f32 bit
           for bit), GLM at its defaults against a dense IRLSM fit
           (training logloss within 1e-4);
       (an) the HIGGS frame through Vec.from_numpy under an HBM budget of
           a third of its packed bytes: GBM 10 trees of (b)'s
           configuration, predictions bit for bit those of the
           unconstrained frame with the pager's prefetch on and off, its
           peak HBM bytes under the budget; every chunk to host, to disk
           and back bit for bit, each transfer's GB/s beside the host
           link's bound; rebalance_frame, the same values;
     then ingest and persistence (no kernel of their own; the GBMs
     launch the binned kernels), each run with its seconds and peak
     memory:
       (ao) the benchm-ml airline frame (10M rows, 9 columns: 3 "c-<n>"
           date levels, DepTime, 22 carriers, about 300 Zipf(1.1)
           airports twice, Distance, a Y/N response from a planted
           logit) generated by numpy from seed 19 into one CSV, and from
           its bytes 8 parts, a level-1 gzip and a localhost HTTP server
           with ranges: import_file of each the same Frame bit for bit
           (names, types, domains, codecs, planes, NA planes), every byte
           counted by the native tokenizer, MB/s beside the host's CPUs
           and the tokenizer threads; the Python tokenizer on the first
           1M rows equal to the native parse of them and to the frame's
           rows; GBM at H2O's defaults (50 trees, depth 5, nbins 20,
           nbins_cats 1024) with its AUC above a bar from a CPU run;
           export_file and import_frame bit for bit (MB/s); save_model and
           load_model (seconds) with the card's predictions bit for bit,
           and a process without a card (CUDA_VISIBLE_DEVICES='') loading
           it onto the CPU and predicting 100,000 rows within 1e-5; a
           4-model grid with a recovery directory killed after 2 models
           and resumed: 2 trained, none twice, each model bit for bit the
           uninterrupted grid's;
       (ap) the first 1M rows of the HIGGS frame of runs (a)-(c) written
           with %.9g and read by import_file: the in-memory values bit for
           bit, MB/s at float width; (b)'s GBM for 10 trees on both frames
           with the same predictions bit for bit and (b)'s launches per
           tree;
     then munging through h2o3_tpu_torch.rapids (no kernel on its path),
     each run with its peak device memory:
       (aq) h2oai/db-benchmark's group-by data G1_1e7_1e2_0_0 (numpy seed
           20) and its questions 1-8 and 10, each twice, both times and
           rows/s printed: group keys, counts and integer sums equal to
           float64 numpy's, means within 1e-6 and sd within 1e-5
           relative, q6's medians numpy's over the f32 values, q1 and q10
           bit for bit across the two runs;
       (as) on (aq)'s frame: sort by id4 ascending and v3 descending
           (np.lexsort's order), cut, h2o.fillna forward and backward
           (maxlen 2) on v3 with 1% NAs, rank_within_groupby, melt, pivot
           of a duplicate-free 1M-row slice, cor, scale, ifelse, cumsum,
           each against numpy; a Session's chain of temps with tmp= and
           rm, released at its end; create_frame at 1e6 x 100;
       (ar) db-benchmark's join data J1_1e7_NA_0_0 (numpy seed 21) and
           its questions 1-5 through (merge …), and an outer join of x
           and medium (q6, the port's own join in place of pandas), each
           twice: the rows, the sums of v1 and v2 over the joined rows,
           q3's NaN rows, q6's NaN counts and key order, and the clashing
           names' _x and _y against numpy;
     then export, explanation and AutoML at HIGGS width (phase
     export_explain; the models of (b), (k), (q) and (t), trained again
     at their settings when the phase runs alone):
       (at) (b)'s GBM as an H2O-3 MOJO, read back by import_mojo and
           scored on all 11M rows on the card by H2OGenericEstimator: the
           imported trees' col, thr and na_left bit for bit where a walk
           reaches, each leaf f32(value*learn_rate), probabilities within
           1e-5 of predict; its native MOJO (the numpy scorer) on the 1M
           validation rows and its POJO's arrays replayed on 10,000, each
           within 1e-5; (k)'s GLM, (q)'s net and (t)'s KMeans through their
           H2O-3 MOJO oracles on 1M rows (1e-5; the same clusters); export
           and import seconds and MB/s, rows/s of each scorer;
       (au) on (b)'s model over the validation rows: the PDP of x0 and x4
           at 20 bins (one bin equal, bit for bit, to the weighted mean of
           predict on the frame with x0 set to its value), ICE of 100 rows,
           permutation importance by AUC of the 28 columns (x0 and x1
           first; x7-x27, which the logit never reads, under 2e-3);
       (av) AutoML (GLM and GBM, 4 models, 3 folds, seed 1) on the first
           1M rows: the binned kernels launched, the leaderboard sorted by
           AUC, the best CV AUC above 0.7, the best GBM step trained alone
           the same trees bit for bit (its binned kernels' share of its
           train(), by CUDA events around each launch), the leader trained
           alone the same, each ensemble's CV AUC (its metalearner on the
           holdout predictions) at least the best base model's less 1e-3;
     then observability and serving (phase obs_serving; the models of
     (b), (k), (q) and (t) as phase export_explain takes them):
       (aw) a 10-tree GBM of (b)'s configuration at HIGGS width trained
           without a trace, then under a trace with lockdep raising: no
           lock-order inversion, the trees bit for bit, one job.run span
           and gbm.chunk spans whose trees sum to 10,
           h2o3_gbm_row_trees_total{engine="binned"} up by exactly 11M x
           10, the trace back from the flight recorder's segment, the log
           records of the run carrying its trace id, (b)'s launches per
           tree; a 100,000-row HIGGS CSV through import_file (the parse
           counters up by its bytes and rows, the four parse stage spans);
           a metrics scrape (every Prometheus line in the exposition
           grammar, the OpenMetrics text ending in # EOF, the device
           memory gauge equal to torch.cuda.memory_allocated); both
           train() times;
       (ax) the four models through the scorer cache on rows of the 1M
           validation frame (KMeans: blob rows of seed 12): at buckets
           128-65,536 and 1, b/2+1 and b rows, each bucket's first call
           one CUDA graph capture and a warm hit after, a replay equal to
           the eager scorer on the same padded buffer bit for bit, against
           the unpadded eager scorer the GBM bit for bit, GLM and DL
           within 1e-6, KMeans the same clusters; model_performance
           through score_frame_with_response within 1e-7 of the eager
           metrics; a warm dispatch under set_sync_debug_mode("error");
           the param bytes one copy, constant over buckets, and the MiB
           the graphs hold; 500 one-row requests in turn under an HBM
           budget the two largest models' params do not fit together, and
           again with a host budget that spills every demote to an npz:
           predictions bit for bit, the budget kept, one capture per
           promotion; 8 threads scoring at once = their serial answers;
           warm rows/s of predict at 4,096 rows and one-row p50/p99 of
           score_rows and predict, through the cache and eagerly
           (H2O3_SCORE_FASTPATH_MAX_ROWS=0), the cache's one-row p50s
           below the eager ones; (b)'s key overwritten
           by a retrained model and DELETE, each freeing the programs
           and the placement once;
     then the rest of serving (phase qos_serving, on the same models;
     lockdep raising throughout; no trace-error fallback):
       (ay) 20,000 requests from 64 threads, sizes 1/8/64 rows at
           70/20/10% of validation rows (KMeans: blob rows), half through
           score_payload (dict rows), half through predict_via_rest (frames
           made on the card), over the four models, at a 2 ms linger and
           at none: every answer equal to its rows scored alone (GBM and
           KMeans bit for bit, GLM and DL within 1e-6), none lost or
           answered twice; requests and rows a dispatch, requests/s,
           p50/p99, the mean stage waterfall of the slowest 1%;
       (az) tenants gold, silver and flood at weights 4:1:1 on one device
           slot: flood over its rate (429) and its queue share (503), gold
           and silver neither; blown deadlines (504) at admission and in
           the batch, an all-dead batch with no dispatch and no capture;
           gold's p50/p99 alone and under the flood, with the waterfall of
           its slowest 1%; the usage ledger by principal summing to the
           total within 1%, charging each principal the rows of its
           answered requests and one call a dispatch, every request's
           stages; a train() beside a job holding gold's one slot under
           H2O3_QOS_MAX_JOBS=1 refused and the slot freed; chaos failing
           one dispatch (one epoch retry,
           every request answered) and delaying one past the follower's
           watch (one watchdog trip whose dump names the leader);
       (ba) the drift baselines of (b) and (k) on their 11M-row frame
           (seconds each; the card's counts equal to numpy's on its first
           1M rows); 1M unshifted validation rows scored, the tap folding
           a stride sample of 62,500 (every PSI < 0.1),
           the same rows with x3 moved by its sd (its PSI > 0.25, the
           others < 0.1, the drift gauge following); two retrains under
           (k)'s key (the generation-skew gauge set); DELETE leaving no
           per-model series; the pressure document's seven dimensions;
     then the REST front end (phase rest: the port's H2OServer in this
     process with a basic-auth file of three users, spoken to over
     loopback HTTP; lockdep and leaktrack raising throughout):
       (bb) (ap)'s 1M-row HIGGS CSV through /3/ImportFiles, /3/ParseSetup
           and /3/Parse polled on /3/Jobs (the frame = import_file's bit
           for bit, MB/s of both); POST /3/ModelBuilders/gbm on the 11M
           HIGGS frame at (b)'s configuration cut to 10 trees (the trees
           = train()'s with the same keyword arguments bit for bit,
           seconds and launches a tree of both); POST /3/Predictions on
           the 1M validation rows (= predict bit for bit, the AUC =
           model_performance's); GET /3/Models/{m}/mojo through
           import_mojo (1e-5 of predict); /99/Rapids group-by and row
           filter = rapids_exec's;
       (bc) 5,000 of (ay)'s requests from 4 client processes x 16
           closed-loop threads to POST /3/Predictions/models/{m}: every
           answer = score_payload of its rows alone (GBM and KMeans bit
           for bit, GLM and DL within 1e-6), no graph captured on the
           handler threads; requests/s, p50/p99, requests a dispatch,
           the Server-Timing split of the slowest 1%, the server's
           process CPU and its handler threads' CPU a request beside
           (ay)'s in process numbers, and the server's own overhead a
           request (serialized time, process CPU, p50); then (az)'s
           tenants as basic-auth users:
           the flood's 429 and 503 with Retry-After, a 0 ms deadline 504,
           gold and silver never refused;
       (bd) /3/Cloud and /3/About name the card and torch/cuda; 1,000
           unauthenticated requests 401 with the QoS counters unchanged;
           /3/Profiler kind torch around a 2-tree REST build on 1M rows
           (the trace's CUDA kernel events name fused_kernel,
           radix_kernel, route_kernel); /3/Trace of the build,
           /3/Timeline, /3/JStack, /3/Alerts, /3/Usage (= the ledger),
           /3/CloudHealth, /3/ModelMonitor; /metrics in the exposition
           grammar counting every request of the phase, its device gauge
           = torch.cuda.memory_allocated; a second server under
           H2O3_TRANSFER_GUARD=disallow answering 100 warm one-row
           predicts while an .item() raises;
       (bg) bindings/gen.py against that server: the generated module
           (standard library only) trains a 10-tree GBM at (bb)'s
           configuration over HTTP (its trees = (bb)'s REST GBM's bit
           for bit) and predicts (= (bb)'s predict bit for bit);
     then (bh) the cloud: two processes of `python -m h2o3_tpu_torch` on
     cuda:0 over gloo, started beside phase rest (a coordinator serving
     REST to this script, a worker replaying each request), and a third
     started after the parse to replace the worker: /3/Cloud 2 nodes;
     /3/ParseDistributed of (ap)'s CSV (= import_file's frame bit for
     bit, MB/s beside (bb)'s); (b)'s frames, written as stored .hex files
     beside phase rest, through /3/Frames/load (each rank holds its rows);
     (bb)'s GBM over REST (= (bb)'s trees bit for bit; launches a tree in
     each process = (bb)'s; all-reduce calls, MB and seconds a tree from
     /metrics?scope=cluster); /3/Predictions on the validation rows (=
     (bb)'s bit for bit, the same AUC); the collect fan-outs (/3/JStack,
     /3/Timeline, /3/Usage, /3/CloudHealth, /3/ModelMonitor, /3/Logs,
     /3/Trace, /3/WaterMeter?cluster=1, /3/Profiler cluster=1) with both
     processes' entries; the divergence sanitizer raising and counting no
     mismatch; the worker killed after a third of 300 (ay)-size requests
     from 16 threads (excised, the epoch up, no request failed), the
     replacement joined, synced and answering 100 of them again as before
     bit for bit (= score_payload's; its answers equal the coordinator's);
     /3/Cloud/drain; every process stopped;
     then (bf) the h2o-py client (h2o3_tpu_torch.client) on (b)'s 11M x
     28 frame made on the card: arithmetic over two columns, a row
     filter, mean and sd, split_frame([0.75], seed=42), a group-by of a
     binned column with sum and count, every Rapids text it sent sent
     again straight to rapids_exec with the same answer bit for bit;
     utils/selfbench.run_all() (the triad's GB/s and the bf16 and f32
     matmuls' TFLOPS beside the card's published peaks); a line saying
     why the scikit-learn adapters do not run here;
     then phase analysis: the port's static analyzer (python -m
     h2o3_tpu_torch.analysis, all 25 rules, --check-census) over the
     package and tests/test_torch_*.py, run in the host worker from the
     start of main(): files analysed, findings by rule, waived count,
     seconds and the three slowest rules; an unwaived finding or a stale
     census fails the script; and (bi) the capture cross-check, phase
     capture_check, right after phase obs_serving: each scorer family's
     static capture verdict (an R002 finding in the capture scope or an
     R025 finding, waived or not, in its modules) held against its
     program at one 1,024-row bucket on the card: GBM (b), GLM (k), DL
     (q), KMeans (t) and (w)'s GLRM; a family without such a finding
     must capture one graph and no strike, a family with one must
     strike; any disagreement fails the script;
  5. each kernel at the shapes of one tree of runs (a)-(d) and of levels
     8 and 9 of a run (f) tree (with its terminal route): its time from
     CUDA events beside its plain version's, one PyTorch library call's
     where there is one, and its bound (the bytes that tree's data needs,
     each input read once and each output written once, over 3.35 TB/s,
     or its f32 operations over 67 TFLOP/s, whichever is larger), and its
     agreement with the plain version on those inputs; the f32 dense and
     fused kernels also at one column per block and at the column groups
     of two shared-memory budgets, the int8 fused kernel at its column
     groups of both budgets and one column, 512 and 1024 threads, the
     shallow-window kernel (both forms) at every column group it is built
     for, 512 and 1024 threads (one window copy per warp where they fit),
     warp aggregation on and off, the int8 dense kernel at levels 6 and 7
     at each window width with its widest column group (level 7 in one
     pass or two), 512 and 1024 threads, bank padding on and off and 1, 2
     and 4 waves of blocks: each layout's result bit-identical; and the
     non-terminal route at 4 and 8 rows a thread-step and 256, 512 and
     1024 threads, heap ids identical, with the 32-byte sectors of the
     code planes its gathers touch.
Each phase prints `phase <name>: <wall> s (card idle for host-only
work <s> s)`: the seconds of its host-only blocks (CPU fits, numpy
references, file writing, a wait on the host worker). The host-only work
that needs no card runs beside the card's in a spawned worker process
with CUDA_VISIBLE_DEVICES="" (started at the top of main(): (ao)'s files
and its Python tokenizer, (ap)'s CSV, (aq)-(ar)'s data and numpy
answers, (al)'s CPU slice fit, (at)'s float64 scorers), each result held
where the phase checks it; a failure there fails the script. The lines
of runs (d)-(bh) and the phase lines are printed again just before the
two JSON lines. The line before the last is the kernels' JSON record
(the adaptive engine, GLM, DeepLearning, the unsupervised family and the
runs (x)-(bh) add no kernel to it); the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Without a
CUDA card, or without the rest of the repository beside it, the script
exits non-zero before printing a result.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import gc
import gzip
import hashlib
import http.server
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
BF16_DENSE_PEAK = 989e12    # bf16 tensor-core FLOP/s, dense
HIST_RTOL = 1e-4      # f32 results of sums in another order or fixed point
F_ATOL = 1e-5         # one f32 multiply-add
TPU_KERNELS = {
    "sbh_route": "h2o3_tpu/ops/hist_pallas.py:425",
    "sbh_route_emit_f": "h2o3_tpu/ops/hist_pallas.py:458",
    "sbh_hist": "h2o3_tpu/ops/hist_pallas.py:574",
    "sbh_hist_i8": "h2o3_tpu/ops/hist_pallas.py:585",
    "sbh_hist_radix": "h2o3_tpu/ops/hist_pallas.py:702",
    "sbh_route_hist_fused": "h2o3_tpu/ops/hist_pallas.py:798",
}
SOURCE = "h2o3_tpu_torch/ops/csrc/hist.cu"
HIGGS_N, HIGGS_C, HIGGS_TREES, HIGGS_DEPTH, HIGGS_NBINS = \
    11_000_000, 28, 10, 8, 255
HIGGS_VALID_N = 1_000_000
# run (b)/(c): the default configuration with early stopping armed
HIGGS_DEFAULT = dict(ntrees=50, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
                     score_tree_interval=5, stopping_rounds=3,
                     stopping_metric="logloss", distribution="bernoulli",
                     seed=1)
# run (f): a binomial forest to depth 10 on the HIGGS frame, mtries -1
# (5 of 28 columns a node)
DRF_HIGGS = dict(ntrees=20, max_depth=10, nbins=HIGGS_NBINS, sample_rate=0.632,
                 mtries=-1, score_tree_interval=5, seed=1)
# runs (d) and (e): a multinomial GBM at the width of the UCI Covertype set
# (581,012 rows, 10 numeric fields, 4 + 40 one-hot wilderness and soil
# fields, 7 classes), depth 8, 20 iterations of 7 class trees
COV_N, COV_VALID_N, COV_NUM, COV_WILD, COV_SOIL = 581_012, 100_000, 10, 4, 40
COV_GBM = dict(distribution="multinomial", ntrees=20, max_depth=8,
               nbins=HIGGS_NBINS, learn_rate=0.1, score_tree_interval=5,
               seed=1)
# runs (al)-(an), the frame data plane: (al) at the width of LIBSVM's
# rcv1.binary (Lewis et al. 2004, train and test together: 697,641 rows x
# 47,236 terms, about 74 nonzeros a row), Zipf(1.1) term ids; the planted
# logit on the RCV1_SIGNAL most frequent terms, N(0, RCV1_SCALE) weights;
# a 100,000-row validation frame and a 50,000-row card-vs-CPU slice; an
# evaluation's bound reads the ri, ci and vals planes forward and back
RCV1_N, RCV1_C, RCV1_NNZ_ROW = 697_641, 47_236, 74
RCV1_VALID_N, RCV1_SLICE_N = 100_000, 50_000
RCV1_ZIPF, RCV1_SIGNAL, RCV1_SCALE, RCV1_POS = 1.1, 500, 4.0, 0.52
RCV1_EVAL_BYTES = 2 * 3 * 4
# (am): covtype.binary, class 2 (Lodgepole Pine) against the rest
COVB_CLASS = 1
# (an): PCIe gen 5 x16, 32 GT/s x 16 lanes x 128/130 / 8 bits, a direction
PCIE5_X16_GBS = 32 * 16 * 128 / 130 / 8
# Covertype's class shares (covtype.data: 211,840, 283,301, 35,754, 2,747,
# 9,493, 17,367 and 20,510 rows)
COV_PRIOR = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
# (d)'s training logloss must fall this far below the entropy of the class
# prior (where f0 starts): a CPU run of the same generator at 30,000 rows
# fell 0.66 nats in 20 iterations; a kernel that misbuilds the histograms
# leaves the model near the prior
COV_LOGLOSS_MARGIN = 0.25
# Launches per tree, worked out from the dispatch (ops/hist_cuda.py) before
# the runs: level 0 takes the shallow-window kernel (one slot, 256 bins);
# levels 1-5 the fused kernel (at most 16 left children, and the 6 MB cap
# over 4 * packed_words(C_pad) columns holds: 32 packed columns for HIGGS's
# C_pad 32, 64 for Covertype's 56); deeper levels the route and the dense
# histogram; the last level the terminal route.
PER_TREE = {
    "sequential": {"hist": 8, "route": 7, "route_f": 1},
    "default": {"radix": 1, "fused": 5, "route": 2, "hist": 2, "route_f": 1},
    "int8": {"radix": 1, "fused": 5, "route": 2, "hist_i8": 2, "route_f": 1},
    # (d), (e): depth 8 at C_pad 56, as the default configuration
    "multinomial": {"radix": 1, "fused": 5, "route": 2, "hist": 2,
                    "route_f": 1},
    # (f): depth 10, levels 6-9 on the route and dense histogram
    "drf10": {"radix": 1, "fused": 5, "route": 4, "hist": 4, "route_f": 1},
}


# runs (k)-(p): GLM, cross-validation and the custom distribution
# (k) binomial IRLSM at lambda 0 on the HIGGS frame, cross-validated
GLM_K = dict(family="binomial", solver="IRLSM", lambda_=0.0,
             standardize=True, compute_p_values=True, nfolds=5, seed=42)
# (l) elastic net down a 30-step lambda path
GLM_L = dict(family="binomial", alpha=0.5, lambda_search=True, nlambdas=30)
# (k)'s card-vs-CPU slice, and the f32 Gram's limit against float64
GLM_SLICE_N = 200_000
GLM_GRAM_RTOL = 1e-5
# (m), (n): multinomial GLM on the Covertype frame's one-hot design
COV_GLM = dict(family="multinomial", solver="IRLSM", lambda_=0.0)
# (o) a gaussian custom distribution against distribution="gaussian"
CUSTOM_GBM = dict(ntrees=10, max_depth=6, histogram_type="UniformAdaptive",
                  seed=1)
# (p) a binned bernoulli GBM cross-validated over 3 stratified folds
CV_GBM = dict(ntrees=10, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS, nfolds=3,
              fold_assignment="Stratified",
              keep_cross_validation_fold_assignment=True,
              distribution="bernoulli", seed=1)


# runs (g)-(j), the adaptive engine (no kernel of ops/csrc on its path):
# (g) XGBoost at its own defaults as the estimator sets them (depth 6,
# eta 0.3, 256 bins, reg_lambda 1, min_child_weight 1), 20 trees on the
# HIGGS frame with its validation frame
XGB_HIGGS = dict(ntrees=20, max_depth=6, nbins=256, seed=1,
                 score_tree_interval=5)
XGB_SHAP_ROWS = 10_000
# (h) DRF at H2O's defaults on the HIGGS frame (mtries -1: 5 of 28), 10
# trees
DRF_DEEP = dict(ntrees=10, max_depth=20, nbins=20, mtries=-1,
                sample_rate=0.632, min_rows=1, seed=1, score_tree_interval=5)
# (i) multinomial DRF at DRF's defaults (depth 20) on the Covertype frame,
# 3 iterations of 7 class trees
COV_DRF = dict(ntrees=3, max_depth=20, nbins=20, seed=1)
# (j) an isolation forest at H2O's defaults at the width of the Kaggle
# credit-card fraud set (Dal Pozzolo et al. 2015: 284,807 rows x 30
# columns, 492 frauds): N(0,1) inliers, and 492 planted anomalies shifted
# by ISO_SHIFT in ISO_SHIFT_COLS seeded columns
CC_N, CC_C, CC_ANOM = 284_807, 30, 492
ISO_SHIFT, ISO_SHIFT_COLS = 2.5, 6
ISO = dict(ntrees=50, max_depth=8, sample_size=256, nbins=20, seed=1)
# the score's AUC against the planted labels must pass this: a CPU run of
# the same generator (torch's CPU generator, seed 11) at this size, through
# the port on the CPU, gave ISO_AUC_CPU; the card's generator draws other
# numbers, and an isolation forest that splits at random scores 0.5
ISO_AUC_CPU = 0.855526
ISO_AUC_BAR = 0.80
# runs (q)-(w): DeepLearning and the unsupervised family (plain PyTorch;
# no kernel of ops/csrc on their paths)
# (q) DL binomial at H2O's defaults (hidden [200, 200], Rectifier,
# ADADELTA rho 0.99 eps 1e-8, mini-batch 256) on the HIGGS frame with its
# validation frame, 0.1 epochs (of 10)
DL_HIGGS = dict(epochs=0.1, seed=1)
# (q)'s card-vs-CPU slice, 1 epoch, and its limit on the probabilities:
# f32 sums in another order over 78 steps
DL_SLICE_N, DL_SLICE_TOL = 20_000, 1e-3
# (q)'s configuration under torch.profiler: 859 steps
DL_PROFILE_EPOCHS = 0.02
# (r) DL multinomial on the Covertype frame of (m), 1 epoch (of 10)
DL_COV = dict(epochs=1.0, seed=1)
# (s) a Tanh autoencoder (the activation of H2O's anomaly examples) at
# the default width [200, 200] on the credit-card frame of (j), 1 epoch
# (of 10); the reconstruction MSE's AUC against the planted labels must
# pass DL_AE_AUC_BAR: a CPU run of the same generator (torch's CPU
# generator, seed 11) through the port on the CPU gave DL_AE_AUC_CPU
DL_AE = dict(autoencoder=True, activation="Tanh", epochs=1.0, seed=1)
DL_AE_AUC_CPU = 0.977605
DL_AE_AUC_BAR = 0.95
# (t) KMeans at H2O's defaults (Furthest, standardize, 10 iterations) with
# k 10 on BLOB_K blobs at HIGGS shape (centres N(0, BLOB_SPREAD²), unit
# noise); each planted centre must lie within BLOB_RECOVER standardised
# units of its own centroid; a KM_SLICE_N-row slice card vs CPU
BLOB_K, BLOB_SPREAD, BLOB_RECOVER = 10, 5.0, 0.02
KM_BLOBS = dict(k=BLOB_K, init="Furthest", standardize=True,
                max_iterations=10, seed=1)
KM_SLICE_N = 200_000
# (u)-(w): a rank-RANK signal plus N(0, RANK_NOISE²) noise at HIGGS
# shape; NA_SHARE of its entries NA for GLRM
RANK, RANK_NOISE, NA_SHARE = 5, 0.1, 0.05
# runs (x)-(ad): the model framework and the standalone models
# (x) a Cartesian grid of binned GBMs on the HIGGS frame with its
# validation frame: max_depth x learn_rate, 5 trees each (of the 10 asked:
# with its models trained alone, from two threads and the RandomDiscrete
# walk, 14 trains of 10 trees took 15.3 s)
GRID_HYPER = {"max_depth": [6, 8], "learn_rate": [0.1, 0.3]}
GRID_GBM = dict(ntrees=5, nbins=HIGGS_NBINS, distribution="bernoulli",
                seed=1)
# (y) a stacked ensemble of a GBM and a binomial GLM on 5 shared folds;
# the GBM 10 trees (of the 20 asked: its 6 fits of 20 took 9.7 s)
ENS_GBM = dict(ntrees=10, max_depth=8, nbins=HIGGS_NBINS,
               distribution="bernoulli")
# (z) one multinomial GBM a wilderness area of (m)'s Covertype frame, 3
# iterations (of the 10 asked: 4 segments and 4 models trained alone of 70
# trees each took 21 s, of 35 trees 14.5-16.1 s, host-bound)
SEG_GBM = dict(distribution="multinomial", ntrees=3, max_depth=8,
               nbins=HIGGS_NBINS, seed=1)
# (aa) Naive Bayes at its defaults; its AUC on the HIGGS frame must pass
# NB_AUC_BAR: a CPU run of the same generator (torch's CPU generator,
# seed 7) at 1M rows, through the port on the CPU, gave NB_AUC_CPU
NB_AUC_CPU, NB_AUC_BAR, NB_SLICE_N = 0.793065, 0.78, 20_000
# (ab) CoxPH on a planted survival frame: COX_N rows (a churn table's
# size), COX_P N(0,1) covariates and a COX_STRATA-level stratum (H2O's
# CoxPH usage: a handful of covariates and strata)
COX_N, COX_P, COX_STRATA = 1_000_000, 10, 4
COX_BETA = (0.5, -0.4, 0.3, -0.2, 0.15, -0.1, 0.05, 0.0, 0.25, -0.3)
# (ac) PSVM at its defaults (gaussian kernel, 256 Fourier features, C 1,
# up to 200 iterations), seed 1. `--psvm-cpu-reference` fits it on the
# host's CPU on this run's frame: AUC PSVM_AUC_CPU (7 iterations, until
# two f32 objectives are equal), and PSVM_AUC_STALLED for a fit stopped
# after its first step, whose direction is the gradient at zero. The bar
# is halfway between them (random scores give 0.5). A fit stalled a step
# or two later is closer still in AUC, so the fit's float64 gradient must
# also fall below PSVM_GRAD_RATIO of its norm at zero: 4.9e-6 on the CPU,
# 0.035 for the fit of one step
PSVM_AUC_CPU, PSVM_AUC_STALLED = 0.739178, 0.738383
PSVM_AUC_BAR = (PSVM_AUC_CPU + PSVM_AUC_STALLED) / 2
PSVM_SLICE_N, PSVM_GRAD_RATIO = 20_000, 1e-3
# runs (ae)-(ak): the models built on ported estimators
# (ae) the aggregator at H2O's defaults on (j)'s credit-card frame; the
# plain row-by-row walk on its first AGG_PLAIN_N rows
AGG = dict(target_num_exemplars=5000, rel_tol_num_exemplars=0.5)
AGG_PLAIN_N = 20_000
# (af) the extended isolation forest at H2O's defaults (100 trees,
# sample_size 256) on (j)'s frame, at extension_level 0 and 29; the score's
# AUC against the planted labels must pass EIF_AUC_BAR: a CPU run of the
# same generator (torch's CPU generator, seed 11) through the port on the
# CPU gave EIF_AUC_CPU
EIF_PARAMS = dict(ntrees=100, sample_size=256, seed=1)
EIF_AUC_CPU = {0: 0.964786, 29: 0.973317}
EIF_AUC_BAR = {0: 0.93, 29: 0.94}
EIF_SLICE_N = 10_000
# (ag) GAM binomial on the HIGGS frame: gam columns x0, x1 and x4 (the
# generator's X0, X1 and sin(X4)) at the default 6 knots
GAM_COLS = ["x0", "x1", "x4"]
GAM_SLICE_N = 200_000
# (ah) RuleFit at its defaults (rule length 3, 20 trees): per tree of
# depth 3 the shallow-window kernel, 2 fused levels, the terminal route
RULEFIT_PER_TREE = {"radix": 1.0, "fused": 2.0, "route_f": 1.0}
# (ai) target encoding on a click-through frame shaped as the Avazu CTR
# set (Kaggle 2014): TE_N rows, three categoricals of TE_LEVELS levels
# drawn Zipf(TE_ZIPF), a per-level N(0, TE_SD^2) logit effect each, and a
# TE_FOLDS-fold column
TE_N, TE_LEVELS, TE_ZIPF, TE_SD, TE_FOLDS = \
    11_000_000, (1000, 30_000, 1_000_000), 1.1, 0.5, 5
# (aj) the infogram on the HIGGS frame: depth 5, 20 bins, 5 trees a model
# (of the 20 asked: 29 models); per tree the shallow-window kernel, 4
# fused levels, the terminal route
INFOGRAM = dict(ntrees=5, max_depth=5, nbins=20)
INFOGRAM_PER_TREE = {"radix": 1.0, "fused": 4.0, "route_f": 1.0}
# (ak) Word2Vec at H2O's defaults (vec_size 100, window 5, min_word_freq
# 5, 5 negatives, 5 epochs: one epoch leaves every topic unlearned, share
# 0.0 in a CPU run of this corpus) on W2V_TOKENS tokens of W2V_TOPICS
# topics of W2V_TOPIC_WORDS words, sentences of W2V_SENT words of one
# topic; the share of W2V_PROBES probe words with 3 of 5 synonyms in their
# topic must pass W2V_SHARE_BAR: a CPU run (torch's CPU generator) of the
# same corpus gave W2V_SHARE_CPU; the busy share over the corpus's first
# W2V_PROFILE_SHARE, one epoch
W2V_TOKENS, W2V_TOPICS, W2V_TOPIC_WORDS, W2V_SENT = \
    1_000_000, 3000, 10, (10, 30)
W2V_PARAMS = dict(epochs=5, seed=16)
W2V_PROBES = 200
W2V_SHARE_CPU, W2V_SHARE_BAR = 0.145, 0.08
W2V_PROFILE_SHARE = 0.05
# runs (ao) and (ap): ingest and persistence
# (ao) the benchm-ml airline frame (szilard/benchm-ml train-10m.csv: 10M
# US flights of 2005-2006, H2O's own GBM benchmark): Month, DayofMonth and
# DayOfWeek as "c-<n>" levels, DepTime hhmm, 22 carriers, about 300
# three-letter airports drawn Zipf(AIR_ZIPF) for Origin and Dest, Distance
# in miles, dep_delayed_15min Y/N (about 19% Y) from a planted logit on
# the hour, the carrier, the origin and the distance; seed AIR_SEED. The
# same bytes as AIR_PARTS parts (each with the header), a level-1 gzip and
# a localhost HTTP server with ranges; the Python tokenizer on the first
# AIR_PY_ROWS rows
AIR_N, AIR_SEED, AIR_PORTS, AIR_ZIPF, AIR_PARTS = \
    10_000_000, 19, 300, 1.1, 8
AIR_PY_ROWS, AIR_SLICE_N = 1_000_000, 100_000
AIR_HEADER = ("Month,DayofMonth,DayOfWeek,DepTime,UniqueCarrier,Origin,"
              "Dest,Distance,dep_delayed_15min")
AIR_CARRIERS = ("AA AQ AS B6 CO DH DL EV F9 FL HA HP MQ NW OH OO TZ UA US "
                "WN XE YV").split()
# GBM at H2O's defaults
AIR_GBM = dict(ntrees=50, max_depth=5, nbins=20, nbins_cats=1024,
               learn_rate=0.1, distribution="bernoulli", seed=1)
# its training AUC must pass AIR_AUC_BAR, 0.01 under AIR_AUC_CPU: the AUC
# that `--airline-cpu-reference` (the generator's first AIR_CPU_N rows of
# a draw of twice that, through the port on a CPU: 8 threads of the build
# sandbox) gave on the draw's other AIR_CPU_N rows. At 10M rows the
# training AUC is near that held-out AUC (at 1M it was 0.0145 above it:
# the 300-level airports overfit); the hour, the carrier and the origin
# carry the signal, and a model that misroutes its splits falls below
AIR_CPU_N = 1_000_000
AIR_AUC_CPU, AIR_AUC_BAR = 0.699391, 0.689
# a 4-model grid with a recovery directory, stopped after 2 and resumed
AIR_GRID = {"max_depth": [3, 5], "learn_rate": [0.1, 0.3]}
AIR_GRID_GBM = dict(ntrees=5, nbins=20, distribution="bernoulli", seed=1)
# (ap) the first HIGGS_CSV_N rows of the HIGGS frame of runs (a)-(c)
# (seed 7, 29 columns) written with %.9g (every f32 round-trips) and read
# back; (b)'s GBM for 10 trees on both frames
HIGGS_CSV_N = 1_000_000
# runs (at)-(av): export and import (probabilities within EXPORT_TOL of
# predict, the POJO replayed on POJO_ROWS rows), the PDP of PDP_COLS at
# PDP_BINS bins (PDP_CHECK_BIN held against predict bit for bit), ICE of
# ICE_ROWS rows, permutation importance (the logit never reads x7-x27:
# each moves the AUC by less than NOISE_DAUC), AutoML on the first
# AML_ROWS rows (the best CV AUC above AML_AUC_BAR, each stacked
# ensemble's at least the best base model's less SE_MARGIN)
EXPORT_TOL = 1e-5
POJO_ROWS = 10_000
PDP_COLS, PDP_BINS, PDP_CHECK_BIN, ICE_ROWS = ("x0", "x4"), 20, 7, 100
NOISE_COLS, NOISE_DAUC = range(7, 28), 2e-3
AML = dict(include_algos=["GLM", "GBM"], max_models=4, nfolds=3, seed=1)
AML_ROWS, AML_AUC_BAR, SE_MARGIN = 1_000_000, 0.7, 1e-3
# runs (aq)-(as): munging at h2oai/db-benchmark's published 1e7 sizes,
# the data made from numpy seeds (`groupby_columns`, `join_tables`: the
# benchmark's generated CSVs are not in the repository)
GB_N, GB_K, GB_SEED = 10_000_000, 100, 20
JN_N, JN_SEED = 10_000_000, 21
# (as): the pivot's duplicate-free slice, create_frame's size
PIVOT_ROWS, CF_ROWS, CF_COLS = 1_000_000, 1_000_000, 100
# the adaptive engine's stages, as its functions (engine.py)
STAGES = (("select", "in_sample_rows"), ("ranges", "_ranges"),
          ("binning", "bin_rows"), ("histogram", "build_histograms"),
          ("split search", "find_best_splits"), ("route", "route_rows"),
          ("gamma_pass", "gamma_pass"), ("covers", "node_covers"))


def groupby_columns(n, k, seed):
    """db-benchmark's groupby-datagen.R, G1_<n>_<k>_0_0 (no NAs, rows
    unsorted): {name: (values, levels)}, a categorical as its codes into
    the sorted levels. id1 and id2 take k levels id001…, id3 n/k levels
    id0000000001…; id4 and id5 are integers in 1..k, id6 in 1..n/k; v1 in
    1..5, v2 in 1..15, v3 uniform in [0, 100) rounded to 6 digits."""
    rng = np.random.default_rng(seed)
    nk = n // k

    def levels(m, width):
        return [f"id{i:0{width}d}" for i in range(1, m + 1)]

    def ints(lo, hi):
        return rng.integers(lo, hi, n).astype(np.float64)

    return {"id1": (ints(0, k), levels(k, 3)),
            "id2": (ints(0, k), levels(k, 3)),
            "id3": (ints(0, nk), levels(nk, 10)),
            "id4": (ints(1, k + 1), None), "id5": (ints(1, k + 1), None),
            "id6": (ints(1, nk + 1), None), "v1": (ints(1, 6), None),
            "v2": (ints(1, 16), None),
            "v3": (np.round(rng.uniform(0, 100, n), 6), None)}


def join_tables(n, seed, n1=None, n2=None):
    """db-benchmark's join-datagen.R, J1_<n>_NA_0_0: the tables x (n
    rows), small (n1 = n/1e6), medium (n2 = n/1e3) and big (n), each
    {name: (values, levels)}. Each key set is split as the script splits
    it: of 1.1 m shuffled keys, 0.9 m are on both sides, 0.1 m on x's side
    only and 0.1 m on the right's only. id1, id2 and id3 are integer keys
    (id3 a permutation); id4 and id5 the factors "id<key>" of id1 and id2
    (levels sorted as text); v1 and v2 uniform in [0, 100) rounded to 6
    digits. The 1e7-level factor id6 is left out: no question reads it,
    and its levels would be 1e7 host strings."""
    rng = np.random.default_rng(seed)
    n1 = n // 10**6 if n1 is None else n1
    n2 = n // 10**3 if n2 is None else n2

    def split(m):
        key = rng.permutation(int(m * 1.1)) + 1
        a = int(m * 0.9)
        return key[:a], key[a:m], key[m:int(m * 1.1)]

    def sample_all(keys, size):
        extra = rng.choice(keys, size - keys.size)
        return rng.permutation(np.concatenate([keys, extra]))

    def factor(ids):
        u, inv = np.unique(ids, return_inverse=True)
        text = np.array([f"id{v}" for v in u])
        order = np.argsort(text)
        rank = np.empty(u.size, np.int64)
        rank[order] = np.arange(u.size)
        return rank[inv].astype(np.float64), text[order].tolist()

    def v(size):
        return (np.round(rng.uniform(0, 100, size), 6), None)

    k1, k2, k3 = split(n1), split(n2), split(n)
    x1 = sample_all(np.concatenate([k1[0], k1[1]]), n)
    x2 = sample_all(np.concatenate([k2[0], k2[1]]), n)
    x = {"id1": (x1.astype(np.float64), None),
         "id2": (x2.astype(np.float64), None),
         "id3": (rng.permutation(np.concatenate([k3[0], k3[1]]))
                 .astype(np.float64), None),
         "id4": factor(x1), "id5": factor(x2), "v1": v(n)}
    s1 = rng.permutation(np.concatenate([k1[0], k1[2]]))
    small = {"id1": (s1.astype(np.float64), None), "id4": factor(s1),
             "v2": v(n1)}
    m1 = sample_all(np.concatenate([k1[0], k1[2]]), n2)
    m2 = rng.permutation(np.concatenate([k2[0], k2[2]]))
    medium = {"id1": (m1.astype(np.float64), None),
              "id2": (m2.astype(np.float64), None),
              "id4": factor(m1), "id5": factor(m2), "v2": v(n2)}
    b1 = sample_all(np.concatenate([k1[0], k1[2]]), n)
    b2 = sample_all(np.concatenate([k2[0], k2[2]]), n)
    big = {"id1": (b1.astype(np.float64), None),
           "id2": (b2.astype(np.float64), None),
           "id3": (rng.permutation(np.concatenate([k3[0], k3[2]]))
                   .astype(np.float64), None),
           "id4": factor(b1), "id5": factor(b2), "v2": v(n)}
    return x, small, medium, big


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


LOG = []
# the lines of runs (d)-(f) and of their kernels' timings, printed again
# just before the result so that the end of the output holds them
RECAP = re.compile(r"(covtype|drf \(f\)|kernel time of (one tree, run "
                   r"\(d\)|levels 8-9)|timing .*(C=56|\(level [89]\))|"
                   r"xgboost \(g\)|drf \(h\)|isolation forest \(j\)|"
                   r"adaptive|glm|gbm (custom|cv)|deeplearning|kmeans|"
                   r"pca \(|svd \(|glrm \(|grid \(x\)|ensemble \(y\)|"
                   r"segments \(z\)|naive bayes|coxph|psvm|quantiles|"
                   r"framework and standalone|model_performance|"
                   r"aggregator \(ae|extended isolation|gam \(ag|"
                   r"rulefit \(ah|target encoding \(ai|infogram \(aj|"
                   r"word2vec \(ak|models on ported|small path ingest|"
                   r"sparse glm \(al|svmlight \(am|pager \(an|"
                   r"frame data plane|airline \(ao|higgs csv \(ap|"
                   r"ingest and persistence|munging|export and import "
                   r"\(at|explain \(au|automl \(av|export, explain|"
                   r"observability|"
                   r"serving \(ax\) (speed|lifecycle|1000|predict)|"
                   r"serving \(ax\) [bkqt]:|qos serving|rest|"
                   r"kernel parity \(be\)|client \(bf\)|front ends|"
                   r"cloud \(bh\)|the cloud|analysis|capture cross)")


def say(msg):
    LOG.append(msg)
    print(msg, flush=True)


# models of runs (b), (k), (q) and (t) kept for phases export_explain,
# obs_serving, qos_serving and rest, which retrain one at the same
# settings when the phase runs alone
KEPT = {}


def check(cond, msg):
    if not cond:
        fail(msg)


# seconds of host-only work inside the blocks that `host_only` marks: the
# card waits while the host computes (CPU fits, numpy references, file
# writing, a worker's result awaited)
HOST_ONLY = [0.0]


def host_seconds(t):
    """Adds t host-only seconds measured by the caller; returns t."""
    HOST_ONLY[0] += t
    return t


class host_only:
    """Adds the block's host-clock seconds to HOST_ONLY."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        HOST_ONLY[0] += time.perf_counter() - self.t0


class HostWorker:
    """Host-only work moved off the card's critical path: a pool of
    spawned processes that see no card (CUDA_VISIBLE_DEVICES=""), each
    with TORCH_THREADS of torch's CPU threads. A task is a module-level
    function of this script taking its sizes as arguments (a spawned
    process imports the script afresh); host_result reads its result."""

    TORCH_THREADS = 2

    def __init__(self, processes=2):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            processes, mp_context=multiprocessing.get_context("spawn"),
            initializer=_host_worker_init,
            initargs=(self.TORCH_THREADS,))

    def submit(self, fn, *args):
        return self.pool.submit(fn, *args)

    def close(self, kill=False):
        """Wait for the pool; with kill, end its processes first (a
        failed run does not wait for a task)."""
        if kill:
            for proc in list((self.pool._processes or {}).values()):
                proc.terminate()
        self.pool.shutdown(wait=not kill, cancel_futures=True)


def _host_worker_init(threads):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch
    torch.set_num_threads(threads)


def host_submit(host, fn, *args):
    """fn(*args) in `host` (a HostWorker) as a future, or, with None (a
    phase run alone), here and now as a done future."""
    import concurrent.futures
    if host is not None:
        return host.submit(fn, *args)
    fut = concurrent.futures.Future()
    try:
        with host_only():
            fut.set_result(fn(*args))
    except Exception as e:      # noqa: BLE001 — re-raised by host_result
        fut.set_exception(e)
    return fut


def host_result(fut, what):
    """The worker's result; the seconds waited for it count as host-only.
    A failure in the worker fails the script."""
    with host_only():
        try:
            return fut.result()
        except Exception as e:  # noqa: BLE001 — any failure fails the run
            fail(f"{what}: the host worker failed: {e!r}")


def analysis_task(repo):
    """Phase analysis's work, in the host worker: the port's analyzer over
    the package and its tests, every rule, the censuses checked. Returns
    (exit code, the --json report, the end of stderr, wall seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "h2o3_tpu_torch.analysis", "h2o3_tpu_torch",
         "tests", "--json", "--all", "--check-census"],
        cwd=repo, capture_output=True, text=True, timeout=600)
    return (out.returncode, out.stdout, out.stderr[-2000:],
            time.perf_counter() - t0)


def phase_analysis(analysis):
    """Phase analysis: the host worker's analyzer run (a future of
    analysis_task); returns its findings, waived ones included."""
    rc, stdout, stderr, wall = host_result(analysis, "analysis")
    try:
        rep = json.loads(stdout)
    except ValueError:
        fail(f"analysis: no JSON report (exit {rc}): {stderr}")
    slow = sorted(rep["rule_timings_s"].items(), key=lambda kv: -kv[1])[:3]
    waived = sum(1 for f in rep["findings"] if f["suppressed"])
    say(f"analysis: python -m h2o3_tpu_torch.analysis h2o3_tpu_torch tests "
        f"--check-census: {rep['files_analyzed']} files, "
        f"{rep['total']} findings, {waived} waived, {rep['unsuppressed']} "
        f"unwaived; by rule {rep['by_rule']}; the analyzer's "
        f"{rep['elapsed_s']} s ({wall:.1f} s with the interpreter's "
        f"start, in the host worker); slowest "
        + ", ".join(f"{k} {v:.3f} s" for k, v in slow))
    check(rep["unsuppressed"] == 0, "analysis: unwaived findings: "
          + "; ".join(f"{f['file']}:{f['line']} {f['rule']}"
                      for f in rep["findings"] if not f["suppressed"]))
    check(rc == 0 and "stale" not in stderr,
          f"analysis: exit {rc} (a stale census?): {stderr}")
    return rep["findings"]


# (w)'s model and the first CAPTURE_ROWS rows of its frame, kept by run
# (w) for the capture cross-check (bi)
KEPT_GLRM = {}
# the families of the capture cross-check: (run, family)
CAPTURE_FAMILIES = (("b", "gbm"), ("k", "glm"), ("q", "deeplearning"),
                    ("t", "kmeans"), ("w", "glrm"))
CAPTURE_ROWS = 1024


def capture_outcome(torch, m, fr):
    """One program of `m` at the bucket of fr's rows through the scorer
    cache, none resident before: (graphs captured, strikes added)."""
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import scorer_cache as SC
    SC.CACHE.invalidate_key(m.key)
    key = (m.key, SC.model_token(m))
    c0 = om.graph_capture_count()
    s0 = SC._BROKEN.get(key, (0, 0.0))[0]
    out = SC.score_frame(m, fr)
    torch.cuda.synchronize()
    strikes = SC._BROKEN.get(key, (0, 0.0))[0] - s0
    captured = om.graph_capture_count() - c0
    check((out is None) == (strikes > 0),
          f"(bi) {m.key}: a result {out is not None} with {strikes} strikes")
    SC.CACHE.invalidate_key(m.key)
    return captured, strikes


def phase_capture_check(torch, h2o, HC, findings):
    """Run (bi): the static capture verdicts against the card."""
    from h2o3_tpu_torch.analysis import rules_torch
    from h2o3_tpu_torch.core.kvstore import DKV
    verdicts = rules_torch.capture_verdicts(findings)
    dev = h2o.init().device
    valid = _higgs_frame(torch, h2o, dev, CAPTURE_ROWS, 8)
    blobs, _ = _blob_frame(torch, dev, CAPTURE_ROWS, 12)
    frames = {"b": valid, "k": valid, "q": valid, "t": blobs}
    models = dict(KEPT)
    if not all(t in models for t in "bkqt"):
        fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
        models = _kept_models(torch, h2o, fr, valid, _blob_frame(
            torch, dev, HIGGS_N, 12)[0], label="capture cross-check (bi)")
        del fr
    if "w" not in KEPT_GLRM:
        # the phase run alone: (w)'s GLRM on a cut frame of its kind
        _full, holed, _X, _L, _na = _rank_frame(torch, dev, 20_000, 13)
        m = h2o.H2OGeneralizedLowRankEstimator(k=RANK, seed=3)
        m.train(training_frame=holed)
        KEPT_GLRM["w"] = (m, _sub_frame(holed, CAPTURE_ROWS))
    models["w"], frames["w"] = KEPT_GLRM["w"]
    lines = []
    for tag, fam in CAPTURE_FAMILIES:
        m = models[tag]
        DKV.put(m.key, m)
        captured, strikes = capture_outcome(torch, m, frames[tag])
        found = verdicts[fam]
        where = ", ".join(f"{f['rule']} {f['file']}:{f['line']}"
                          f"{' (waived)' if f['suppressed'] else ''}"
                          for f in found) or "no capture finding"
        lines.append(f"{fam} ({tag}) {where}: {int(captured)} graph(s), "
                     f"{strikes} strike(s)")
        if found:
            check(strikes == 1 and captured == 0,
                  f"(bi) {fam}: the analyzer says {where}, but the card "
                  f"captured {captured} graph(s) with {strikes} strike(s)")
        else:
            check(captured == 1 and strikes == 0,
                  f"(bi) {fam}: no capture finding, but the card captured "
                  f"{captured} graph(s) with {strikes} strike(s)")
    say(f"capture cross-check (bi), one program at bucket {CAPTURE_ROWS} "
        f"each, static verdict vs the card, all agree: " + "; ".join(lines))
    DKV.clear()


def run_phase(name, fn, *args, **kw):
    """fn(*args, **kw) with its wall seconds and the host-only seconds
    inside it printed as one `phase` line."""
    t0, h0 = time.perf_counter(), HOST_ONLY[0]
    out = fn(*args, **kw)
    say(f"phase {name}: {time.perf_counter() - t0:.1f} s (card idle for "
        f"host-only work {HOST_ONLY[0] - h0:.1f} s)")
    return out


# ---------------------------------------------------------------------------
def phase_card(torch, _build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"build: {sorted(logs)} in "
        f"{host_seconds(time.perf_counter() - t0):.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" \
                    in line:
                say(f"ptxas {name}: {line.strip()}")
        # the shallow-window kernel, the int8 kernels' column groups and
        # the route's rows per thread are unrolled at compile time: none
        # of them may spill
        for fn, spilled in ptxas_spills(log).items():
            if re.search(r"radix_kernel|fused_i8_kernel|hist_i8_kernel|"
                         r"pack_i8_kernel|route_rows_kernel", fn):
                check(not spilled, f"{fn} spills: {spilled} bytes")
    ops = {}
    for name in logs:
        ops.update(sass_atomics(_build, name))
    # the f32 kernels sum in fixed point: no shared atomic of theirs may be
    # a compare-and-swap loop (the f64 adds they replace compiled to
    # ATOMS.CAST.SPIN.64)
    f32 = {fn: found for fn, found in ops.items()
           if re.search(r"(hist|fused|radix)_kernelIf", fn)}
    for kind in ("hist", "fused", "radix"):
        check(any(f"{kind}_kernelIf" in fn for fn in f32),
              f"f32 {kind} kernel not found in the SASS: {sorted(ops)}")
    for fn, found in f32.items():
        cas = sorted(op for op in found if op.startswith("ATOMS.CAS"))
        check(not cas, f"{fn} compiled a compare-and-swap shared atomic: "
              f"{cas}")
    say(f"sass: {len(f32)} f32 histogram kernels, no compare-and-swap "
        "shared atomic")
    return card


def ptxas_spills(log):
    """{function: spill store + load bytes} from nvcc's -Xptxas -v log."""
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = int(m.group(1)) + int(m.group(2))
    return out


def sass_atomics(_build, name):
    """Print the atomic instructions each kernel of a built library
    compiled to, from cuobjdump -sass: shared-memory ATOMS.* (an add done
    as a compare-and-swap loop shows as ATOMS.CAS*, a native one as
    ATOMS.ADD*) and global RED.* / ATOM.*. Returns {function: set of
    ops}."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    check(os.path.isfile(tool), f"cuobjdump not found beside nvcc: {tool}")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    fn, ops = None, {}
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            ops[fn] = set()
        elif fn:
            m = re.search(r"\b(ATOMS|RED|ATOM)\.([A-Z0-9_.]+)", line)
            if m:
                ops[fn].add(f"{m.group(1)}.{m.group(2)}")
    for fn, found in ops.items():
        if found:
            say(f"sass {name} {fn}: {{{', '.join(sorted(found))}}}")
    return ops


def _codes_heap_stats(torch, dev, seed, *, n, c_pad, b_val, L, int8=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[rng.random((c_pad, n)) < 0.05] = b_val
    codes[-2:] = 0                     # padding columns: every row in bin 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    heap[rng.random(n) < 0.1] = max(0, base - 1)
    stats = rng.normal(0, 1, (4, n)).astype(np.float32)
    stats[3] = 0.0
    if int8:
        stats = np.clip(np.round(stats * 40.0), -127, 127).astype(np.int32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(heap).to(dev),
            torch.from_numpy(stats).to(dev), base)


def _route_tables(torch, dev, seed, L, c_pad, n_bins):
    rng = np.random.default_rng(seed)
    lp = max(8, L)
    tbl = np.zeros((8, lp), np.float32)
    tbl[0, :L] = rng.integers(0, c_pad, L)
    tbl[1, :L] = rng.random(L) < 0.8
    route_f = (rng.random((lp, n_bins)) < 0.5).astype(np.float32)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(route_f).to(dev)


def hist_rel_err(got, want):
    """max |got - want| per stat row over that row's max |want|."""
    errs = []
    for s in range(got.shape[2]):
        scale = max(want[:, :, s].abs().max().item(), 1e-30)
        errs.append((got[:, :, s] - want[:, :, s]).abs().max().item() / scale)
    return max(errs)


def phase_kernels_small(torch, HC, dev, c_pad):
    n, n_bins, b_val = 1 << 16, 256, 255
    # L = 256 and 512: the levels 8 and 9 of a depth-10 tree (route tables
    # of 256 and 512 leaves, the dense histograms in passes of 64 slots)
    for L in (64, 256, 512):
        for emit_f in (False, True):
            codes, heap, _, base = _codes_heap_stats(torch, dev, 1, n=n,
                                                     c_pad=c_pad,
                                                     b_val=b_val, L=L)
            rng = np.random.default_rng(2)
            tbl = np.zeros((8, L), np.float32)
            tbl[0] = rng.integers(0, c_pad, L)
            tbl[1] = rng.random(L) < 0.8
            route_f = (rng.random((L, n_bins)) < 0.5).astype(np.float32)
            nodes_p = -(-(2 * (base + L) + 1) // 128) * 128
            valtab = np.zeros((8, nodes_p), np.float32)
            valtab[0] = rng.normal(0, 1, nodes_p)
            F = rng.normal(0, 1, n).astype(np.float32)
            args = [codes, heap] + [torch.from_numpy(a).to(dev)
                                    for a in (tbl, route_f, valtab, F)]
            kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
            h_k, f_k = HC.sbh_route(*args, **kw)
            h_p, f_p = HC.sbh_route_plain(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(h_k, h_p),
                  f"route emit_f={emit_f} L={L} C={c_pad}: heap differs")
            ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
            check(ferr < F_ATOL, f"route emit_f={emit_f} L={L} C={c_pad}: "
                  f"F err {ferr}")
            say(f"kernel route emit_f={emit_f} L={L} n={n} C={c_pad}: heap "
                f"identical, F max err {ferr:.3g} (tol {F_ATOL})")
    for L, half in ((1, False), (1, True), (64, False), (64, True),
                    (128, False), (128, True), (256, True), (512, True)):
        for int8 in (False, True):
            codes, heap, stats, base = _codes_heap_stats(
                torch, dev, 10 + L, n=n, c_pad=c_pad, b_val=b_val, L=L,
                int8=int8)
            kw = dict(base=base, L=L, n_bins=n_bins, half=half)
            got = HC.sbh_hist_dense(codes, heap, stats, int8=int8, **kw)
            check_hist(torch, HC, f"hist int8={int8} L={L} half={half} "
                       f"n={n} C={c_pad}", got, codes, heap, stats, kw, int8)
    for L, half in ((1, False), (2, True), (4, True)):
        for int8 in (False, True):
            codes, heap, stats, base = _codes_heap_stats(
                torch, dev, 20 + L, n=n, c_pad=c_pad, b_val=b_val, L=L,
                int8=int8)
            kw = dict(base=base, L=L, n_bins=n_bins, half=half)
            got = HC.sbh_hist_radix(codes, heap, stats, int8=int8, **kw)
            check_hist(torch, HC, f"radix int8={int8} L={L} half={half} "
                       f"n={n} C={c_pad}", got, codes, heap, stats, kw, int8)
    for L_h in (2, 4, 32):
        for int8 in (False, True):
            L_r = L_h // 2
            codes, heap, stats, base_r = _codes_heap_stats(
                torch, dev, 30 + L_h, n=n, c_pad=c_pad, b_val=b_val, L=L_r,
                int8=int8)
            tbl, route_f = _route_tables(torch, dev, 31 + L_h, L_r, c_pad,
                                         n_bins)
            kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h,
                      n_bins=n_bins)
            h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f,
                                               stats, int8=int8, **kw)
            check_fused(torch, HC, f"fused int8={int8} L_h={L_h} n={n} "
                        f"C={c_pad}",
                        h_k, got, (codes, heap, tbl, route_f, stats), kw, int8)


def parity_run(torch, dev, c_pad):
    """(be): ops/parity.kernel_parity_check on the card at c_pad code
    columns: every kernel against its plain version through the port's
    own gate."""
    from h2o3_tpu_torch.ops import parity
    t0 = time.perf_counter()
    devs = parity.kernel_parity_check(seed=0, device=dev, c_pad=c_pad)
    t = time.perf_counter() - t0
    say(f"kernel parity (be) C={c_pad}: {len(devs)} checks in {t:.2f} s, "
        f"largest deviations "
        + ", ".join(f"{k} {v:.3g}" for k, v in devs.items()))
    return t


def _adversarial(torch, dev, seed, *, n, c_pad, b_val, L, one_bin=False,
                 nonfinite=False):
    """Stats that stress a fixed-point sum: weights up to 1e4, grads of
    alternating sign (the first half of the rows in pairs that cancel
    exactly), hess a fraction of the weight. one_bin puts every row in the
    window's first slot and every code in one bin; nonfinite makes one
    grad NaN and one hess +inf, in rows of the window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[-2:] = 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    if one_bin:
        codes[:] = 7
        heap[:] = base
    w = rng.uniform(0.0, 1e4, n)
    g = w * rng.uniform(0.5, 1.5, n)
    g[1: n // 2: 2] = g[0: n // 2 - 1: 2]
    g[1::2] *= -1.0
    stats = np.stack([w, g, w * rng.uniform(0.05, 0.25, n),
                      np.zeros(n)]).astype(np.float32)
    if nonfinite:
        stats[1, 10] = np.nan
        stats[2, 21] = np.inf
        heap[[10, 21]] = base            # leaf 0: slot 0 of a half window
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(heap).to(dev),
            torch.from_numpy(stats).to(dev), base)


def bit_equal(torch, a, b):
    """Equal bit for bit (NaN included) and of one shape."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_adversarial(torch, what, got, again, want, nonfinite):
    """Hold an f32 histogram of adversarial stats to the float64 plain
    version: bins the plain version makes NaN or +-inf equal (and present
    where the stats hold a NaN and an inf), every other bin within
    HIST_RTOL of its stat row's scale; and a second launch on the same
    inputs bit-identical to the first."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    check(bit_equal(torch, got, again), f"{what}: two launches differ")
    fin = torch.isfinite(want)
    check(bool((~fin).any()) == nonfinite, f"{what}: "
          f"{int((~fin).sum())} non-finite bins in the plain version")
    check(torch.equal(fin, torch.isfinite(got)), f"{what}: non-finite bins "
          f"differ ({int((~fin).sum())} in the plain version)")
    check(torch.equal(torch.isnan(want), torch.isnan(got)),
          f"{what}: NaN bins differ")
    inf = torch.isinf(want)
    check(torch.equal(got[inf].double(), want[inf]), f"{what}: inf bins "
          "differ")
    zero = torch.zeros((), dtype=torch.float64, device=want.device)
    err = hist_rel_err(torch.where(fin, got.double(), zero),
                       torch.where(fin, want, zero))
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: rel err {err:.3g} (tol {HIST_RTOL}), "
        f"{int((~fin).sum())} non-finite bins as in f64, two launches "
        "bit-identical")
    return err


def phase_adversarial(torch, HC, dev, c_pad):
    n, n_bins, b_val = 1 << 16, 256, 255
    cases = (("one slot, one bin", 1, dict(one_bin=True)),
             ("L=64 half", 64, {}),
             ("L=64 half, NaN and inf", 64, dict(nonfinite=True)),
             ("L=512 half", 512, {}))
    for what, L, extra in cases:
        codes, heap, stats, base = _adversarial(torch, dev, 60 + L, n=n,
                                                c_pad=c_pad, b_val=b_val,
                                                L=L, **extra)
        kw = dict(base=base, L=L, n_bins=n_bins, half=L > 1)
        got, again = (HC.sbh_hist_dense(codes, heap, stats, **kw)
                      for _ in range(2))
        want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
        check_adversarial(torch, f"hist adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)
    for what, L_h, extra in (("every row to one slot, one bin", 2,
                              dict(one_bin=True)),
                             ("L_h=32", 32, {}),
                             ("L_h=32, NaN and inf", 32,
                              dict(nonfinite=True))):
        L_r = L_h // 2
        codes, heap, stats, base_r = _adversarial(torch, dev, 70 + L_h, n=n,
                                                  c_pad=c_pad, b_val=b_val,
                                                  L=L_r, **extra)
        tbl, route_f = _route_tables(torch, dev, 71 + L_h, L_r, c_pad, n_bins)
        if extra:
            tbl[1, 0] = 1.0               # leaf 0 splits, every row left
            route_f[0] = 0.0
        kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h,
                  n_bins=n_bins)
        (h_k, got), (h_2, again) = (
            HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats, **kw)
            for _ in range(2))
        h_p, want = HC.sbh_route_hist_plain(codes, heap, tbl, route_f,
                                            stats.double(), **kw)
        torch.cuda.synchronize()
        check(torch.equal(h_k, h_p) and torch.equal(h_k, h_2),
              f"fused adversarial {what}: heap differs")
        check_adversarial(torch, f"fused adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)
    # the shallow-window kernel: one slot (full warps of one key), and a
    # half window of two slots
    for what, L, extra in (("one slot, one bin", 1, dict(one_bin=True)),
                           ("L=4 half", 4, {}),
                           ("L=4 half, NaN and inf", 4,
                            dict(nonfinite=True))):
        codes, heap, stats, base = _adversarial(torch, dev, 80 + L, n=n,
                                                c_pad=c_pad, b_val=b_val,
                                                L=L, **extra)
        kw = dict(base=base, L=L, n_bins=n_bins, half=L > 1)
        got, again = (HC.sbh_hist_radix(codes, heap, stats, **kw)
                      for _ in range(2))
        want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
        check_adversarial(torch, f"radix adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)


def check_hist(torch, HC, what, got, codes, heap, stats, kw, int8):
    """Hold a histogram kernel's result against the plain version: equal
    for int32 sums, within HIST_RTOL of each stat row's scale against the
    plain version in f64 for f32 sums. Returns the max abs error."""
    want = HC.sbh_hist_plain(codes, heap, stats if int8 else stats.double(),
                             **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}, "
          f"expected {tuple(want.shape)}")
    if int8:
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"{what}: int32 sums differ")
        say(f"kernel {what}: int32 sums equal")
        return 0.0
    err = hist_rel_err(got.double(), want)
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: rel err {err:.3g} (tol {HIST_RTOL})")
    return (got.double() - want).abs().max().item()


def check_fused(torch, HC, what, h_k, got, args, kw, int8):
    """Hold the fused kernel against the sequential plain pair: heap ids
    identical, the histogram as check_hist holds it."""
    codes, heap, tbl, route_f, stats = args
    h_p, want = HC.sbh_route_hist_plain(
        codes, heap, tbl, route_f, stats if int8 else stats.double(), **kw)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"{what}: heap differs")
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    if int8:
        check(torch.equal(got, want), f"{what}: int32 sums differ")
        say(f"kernel {what}: heap identical, int32 sums equal")
        return 0.0
    err = hist_rel_err(got.double(), want)
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: heap identical, rel err {err:.3g} (tol {HIST_RTOL})")
    return (got.double() - want).abs().max().item()


# ---------------------------------------------------------------------------
def _write_csv(path, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 4)), 4)
    X[rng.random((n, 4)) < 0.05] = np.nan
    color = rng.choice(["red", "green", "blue", "teal"], n)
    logit = (1.4 * np.nan_to_num(X[:, 0]) - 0.9 * np.nan_to_num(X[:, 1])
             + np.where(color == "blue", 1.0, 0.0))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    with open(path, "w") as f:
        f.write("a,b,c,d,color,label\n")
        for i in range(n):
            nums = ["NA" if np.isnan(v) else repr(float(v)) for v in X[i]]
            f.write(",".join(nums + [color[i], "yes" if y[i] else "no"])
                    + "\n")


def phase_small_path(torch, h2o, HC):
    """The CSV path on the card against the CPU, in the default
    configuration and with int8_hist=True. At depth 4 every level runs the
    shallow-window or the fused kernel."""
    for extra in ({}, {"int8_hist": True}):
        gbm = dict(ntrees=5, max_depth=4, learn_rate=0.2,
                   distribution="bernoulli", seed=5, **extra)
        with tempfile.TemporaryDirectory() as tmp:
            csv = os.path.join(tmp, "train.csv")
            _write_csv(csv)
            h2o.init(device="cpu")
            cfr = h2o.import_file(csv)
            cm = h2o.H2OGradientBoostingEstimator(**gbm)
            cm.train(y="label", training_frame=cfr)
            cpu_p = cm.predict(cfr).to_numpy()
            h2o.init()
            HC.reset_launches()
            fr = h2o.import_file(csv)
            m = h2o.H2OGradientBoostingEstimator(**gbm)
            m.train(y="label", training_frame=fr)
            pred = m.predict(fr)
            torch.cuda.synchronize()
            launches = dict(HC.LAUNCHES)
        check(fr.matrix().device.type == "cuda", "frame not on the card")
        p = pred.to_numpy()
        check(p.shape == (4000, 3) and np.isfinite(p).all(),
              "bad predictions")
        want = {"radix": 5, "fused": 15, "route_f": 5}
        got = {k: v for k, v in launches.items() if v}
        check(got == want, f"small path {extra} launches {launches}, "
              f"expected {want}")
        perr = float(np.abs(p[:, 1:] - cpu_p[:, 1:]).max())
        aerr = abs(m.auc() - cm.auc())
        say(f"small path {extra or 'default'}: 4000 rows csv -> gbm 5x4 -> "
            f"predict: AUC card {m.auc():.6f} cpu {cm.auc():.6f}; pred max "
            f"err {perr:.3g}; launches {got}")
        check(perr < 1e-3 and aerr < 1e-3,
              f"card and CPU disagree: pred {perr} auc {aerr}")
        check(m.auc() > 0.75, f"small path AUC {m.auc()}")


# ---------------------------------------------------------------------------
class EventTimer:
    """Wraps a kernel wrapper to time each call between two CUDA events
    (no synchronise: the events are read after the run)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.pairs = torch, fn, []

    def __call__(self, *args, **kw):
        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = self.fn(*args, **kw)
        ev[1].record()
        self.pairs.append(ev)
        return out

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its first `keep`
    calls (one tree's levels); the wrapper itself still runs and counts."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls = fn, keep, []

    def __call__(self, *args, **kw):
        if len(self.calls) < self.keep:
            self.calls.append((args, kw))
        return self.fn(*args, **kw)


def _higgs_frame(torch, h2o, dev, n, seed):
    """HIGGS-shaped frame made on the card: C N(0,1) features, the bench's
    logit, y ~ Bernoulli(sigmoid(logit))."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    C = HIGGS_C
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((n, C), generator=g, device=dev)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * torch.sin(X[:, 4]) + 0.3 * X[:, 5] * X[:, 6])
    y = (torch.rand(n, generator=g, device=dev)
         < torch.sigmoid(logit)).float()
    names = [f"x{j}" for j in range(C)] + ["y"]
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(C)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    return Frame(names, vecs)


# kernel wrappers recorded in the HIGGS runs (the dispatchers reach them
# through the module, so recording them catches every launch)
RECORDED = ("sbh_hist_dense", "sbh_route", "sbh_hist_radix",
            "sbh_route_hist_fused")


def train_run(torch, h2o, HC, fr, label, expect, keep, valid=None,
              estimator="H2OGradientBoostingEstimator", prior_trees=0,
              **params):
    """Train one model through the estimator with the launch counts reset
    just before and read just after; keep the first `keep[name]` calls of
    each recorded wrapper (one tree's). The launches per tree (over the
    trees this run built: a restart's prior trees are not counted) must
    equal `expect`. Returns (model, launches, train seconds, trees built,
    {name: calls})."""
    recs = {name: Recorder(getattr(HC, name), keep.get(name, 0))
            for name in RECORDED}
    saved = {name: getattr(HC, name) for name in RECORDED}
    for name, r in recs.items():
        setattr(HC, name, r)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        m = getattr(h2o, estimator)(**params)
        HC.reset_launches()
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(HC.LAUNCHES)
    finally:
        for name, fn in saved.items():
            setattr(HC, name, fn)
    trees = int(m.summary()["number_of_trees"]) - prior_trees
    per_tree = {k: v / trees for k, v in launches.items() if v}
    say(f"{label}: {fr.nrows} rows x {len(fr.names) - 1} features, {trees} "
        f"trees depth {params['max_depth']} nbins {params['nbins']}: train "
        f"{t_train:.3f} s ({fr.nrows * trees / t_train:.0f} row*trees/s), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
        "above what was held before train())")
    say(f"{label} launches per tree: {per_tree} (expected {expect})")
    check(per_tree == expect, f"{label} launches per tree {per_tree}, "
          f"expected {expect}")
    for name, r in recs.items():
        check(len(r.calls) == keep.get(name, 0),
              f"{label}: {len(r.calls)} calls of {name} recorded")
    return m, launches, t_train, trees, {n: r.calls for n, r in recs.items()}


def performance_check(label, m, valid):
    """model_performance(valid) scores the validation frame anew: its AUC
    and logloss equal train()'s validation metrics within 1e-7, and the
    model's to_dict() goes through json.dumps."""
    t0 = time.perf_counter()
    perf = m.model_performance(valid)
    t_perf = time.perf_counter() - t0
    d_auc = abs(perf.auc - m.auc(valid=True))
    d_ll = abs(perf.logloss - m.logloss(valid=True))
    text = json.dumps(m.to_dict())
    say(f"{label}: model_performance(valid) in {t_perf:.3f} s: AUC "
        f"{perf.auc!r}, logloss {perf.logloss!r} (train()'s validation "
        f"metrics differ by {d_auc:.3g}, {d_ll:.3g}); to_dict() "
        f"{len(text)} bytes of JSON")
    check(d_auc <= 1e-7 and d_ll <= 1e-7, f"{label}: model_performance "
          f"differs from the validation metrics by {d_auc}, {d_ll}")


def higgs_run(torch, h2o, HC, fr, label, expect, keep, valid=None, **params):
    """A HIGGS run (train_run) whose train AUC must pass 0.7."""
    out = train_run(torch, h2o, HC, fr, f"higgs ({label})", expect, keep,
                    valid=valid, **params)
    m = out[0]
    say(f"higgs ({label}): train AUC {m.auc():.6f}")
    check(m.auc() > 0.7, f"higgs ({label}) train AUC {m.auc()}")
    return out


def phase_higgs(torch, h2o, HC):
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    torch.cuda.synchronize()
    D = HIGGS_DEPTH
    out = {}

    # (a) the sequential route-then-histogram path, flags passed explicitly
    m, launches, _, _, calls = higgs_run(
        torch, h2o, HC, fr, "a: sequential", PER_TREE["sequential"],
        {"sbh_hist_dense": D, "sbh_route": D}, ntrees=HIGGS_TREES,
        max_depth=D, nbins=HIGGS_NBINS, distribution="bernoulli", seed=1,
        radix_shallow=False, fused_level=False)
    t0 = time.perf_counter()
    pred = m.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.vec("p1").as_f32()
    check(pred.nrows == HIGGS_N and bool(torch.isfinite(p1).all()),
          "HIGGS predictions not finite")
    say(f"higgs (a) predict {HIGGS_N} rows: {t_pred:.3f} s")
    out["a"] = (launches, calls)
    del m, pred, p1

    # (b) the default configuration, validation frame, early stopping
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    keep = {"sbh_hist_radix": 1, "sbh_route_hist_fused": 5,
            "sbh_hist_dense": 2, "sbh_route": 3}
    aucs = {}
    for label, extra, expect in (("b: default", {}, PER_TREE["default"]),
                                 ("c: int8_hist", {"int8_hist": True},
                                  PER_TREE["int8"])):
        m, launches, t_train, trees, calls = higgs_run(
            torch, h2o, HC, fr, label, expect, keep, valid=valid,
            **HIGGS_DEFAULT, **extra)
        hist = m.scoring_history()
        vauc, last = m.auc(valid=True), hist[-1]
        stopped = trees < HIGGS_DEFAULT["ntrees"]
        say(f"higgs ({label}): train AUC {m.auc():.6f}, validation AUC "
            f"{vauc:.6f} (last history entry {last['validation_auc']:.6f}, "
            f"validation logloss {last['validation_logloss']:.6f}); "
            f"{trees} trees built, stopped early: {stopped}")
        check(vauc > 0.7, f"higgs ({label}) validation AUC {vauc}")
        check(abs(last["validation_auc"] - vauc) < 1e-4,
              f"higgs ({label}): history validation AUC "
              f"{last['validation_auc']} vs final {vauc}")
        aucs[label[0]] = m.auc()
        out[label[0]] = (launches, calls)
        if label[0] == "b":
            performance_check("higgs (b)", m, valid)
            KEPT["b"] = m
        del m
    say(f"higgs train AUC: default {aucs['b']:.6f}, int8_hist "
        f"{aucs['c']:.6f}")
    out["f"] = drf_run(torch, h2o, HC, fr, valid)
    # (g) and (h): the adaptive engine at HIGGS width
    xgboost_run(torch, h2o, HC, fr, valid)
    del valid
    adaptive_stage_table(torch, h2o, fr, "run (g)", "H2OXGBoostEstimator",
                         **XGB_HIGGS)
    time_range_forms(torch, fr)
    deep_drf_run(torch, h2o, HC, fr)
    adaptive_stage_table(torch, h2o, fr, "run (h)",
                         "H2ORandomForestEstimator", **DRF_DEEP)
    breakdown(torch, h2o, HC, fr, "higgs (default configuration)",
              ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
              distribution="bernoulli", seed=1)
    busy_share(torch, h2o, fr)
    return out


def drf_run(torch, h2o, HC, fr, valid):
    """Run (f): a binomial forest to depth 10 on the HIGGS frame with the
    validation frame; OOB and validation AUC, the validation series, and
    the predict time of every training row. Keeps one tree's dense
    histogram and route calls (levels 6-9 and the terminal route)."""
    m, launches, _, trees, calls = train_run(
        torch, h2o, HC, fr, "drf (f): binomial forest", PER_TREE["drf10"],
        {"sbh_hist_dense": 4, "sbh_route": 5}, valid=valid,
        estimator="H2ORandomForestEstimator", **DRF_HIGGS)
    summary, last = m.summary(), m.scoring_history()[-1]
    oob, vauc = m.auc(), m.auc(valid=True)
    t0 = time.perf_counter()
    pred = m.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.vec("p1").as_f32()
    say(f"drf (f): {trees} trees, mtries {summary['mtries']}, OOB (training) "
        f"AUC {oob:.6f}, validation AUC {vauc:.6f} (last history entry "
        f"{last['validation_auc']:.6f}), oob_scored {summary['oob_scored']};"
        f" predict {fr.nrows} rows: {t_pred:.3f} s")
    check(summary["oob_scored"] is True, "drf (f): not OOB-scored")
    check(trees == DRF_HIGGS["ntrees"], f"drf (f): {trees} trees")
    check(oob > 0.7 and vauc > 0.7, f"drf (f) AUC: OOB {oob}, valid {vauc}")
    check(abs(last["validation_auc"] - vauc) < 1e-4,
          f"drf (f): history validation AUC {last['validation_auc']} vs "
          f"final {vauc}")
    check(pred.nrows == fr.nrows and bool(torch.isfinite(p1).all())
          and bool(((p1 >= 0) & (p1 <= 1)).all()),
          "drf (f): predictions not probabilities")
    return launches, calls


def _covtype_frame(torch, dev, n, seed):
    """Covertype-shaped frame made on the card from a seeded
    torch.Generator: 10 N(0,1) columns for the numeric fields, 4 one-hot
    0/1 wilderness and 40 one-hot 0/1 soil columns, and 7 classes, the
    argmax over classes of log(Covertype's class share) + a fixed score of
    a few columns + Gumbel noise. Returns (frame, class ids)."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    K = len(COV_PRIOR)
    Xn = torch.randn((n, COV_NUM), generator=g, device=dev)
    wild = torch.randint(0, COV_WILD, (n,), generator=g, device=dev)
    soil = torch.randint(0, COV_SOIL, (n,), generator=g, device=dev)
    onehot = torch.nn.functional.one_hot
    B = torch.cat([onehot(wild, COV_WILD), onehot(soil, COV_SOIL)], 1)
    k = torch.arange(K, device=dev)
    score = (torch.log(torch.tensor(COV_PRIOR, device=dev))[None, :]
             + 1.2 * Xn[:, :K] - 0.6 * Xn[:, 7:10].repeat(1, 3)[:, :K]
             + 0.8 * (wild[:, None] == (k % COV_WILD)[None, :])
             + 1.0 * ((soil[:, None] % K) == k[None, :]))
    u = torch.rand((n, K), generator=g, device=dev).clamp(1e-12, 1 - 1e-7)
    y = torch.argmax(score - torch.log(-torch.log(u)), dim=1)
    X = torch.cat([Xn, B.float()], 1)
    names = ([f"n{j}" for j in range(COV_NUM)]
             + [f"wild{j}" for j in range(COV_WILD)]
             + [f"soil{j}" for j in range(COV_SOIL)] + ["y"])
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(X.shape[1])]
    vecs.append(Vec.from_tensor(y.float(), type=T_CAT,
                                domain=[str(c + 1) for c in range(K)]))
    return Frame(names, vecs), y


def _same_splits(torch, a, b, t):
    """Tree t of two ensembles splits alike node for node (columns,
    thresholds, NA directions)."""
    return all(torch.equal(getattr(a, f)[t], getattr(b, f)[t])
               for f in ("col", "thr", "na_left"))


class RestartProbe:
    """Hooks on the multinomial chunk trainer and the split search for one
    training run: the margins that the `at`-th chunk (counting from 0)
    starts from, and the histogram, lam and choice of each of the
    `searches` split searches that follow (the K class trees' levels of
    that chunk's first iteration). The copies cost a few milliseconds of
    the run's train()."""

    def __init__(self, BN, at, searches):
        self.BN, self.at, self.searches = BN, at, searches
        self.trainer, self.find = BN.gbm_multi_chunk_trainer, \
            BN.find_splits_binned
        self.chunks, self.left, self.F, self.splits = 0, 0, None, []

    def __enter__(self):
        probe = self

        def trainer(*a, **k):
            run = probe.trainer(*a, **k)

            def call(codes, y1, w1, F, generator=None):
                if probe.chunks == probe.at:
                    probe.F, probe.left = F.clone(), probe.searches
                probe.chunks += 1
                return run(codes, y1, w1, F, generator)
            return call

        def find(hist, *a, **k):
            s = probe.find(hist, *a, **k)
            if probe.left:
                probe.left -= 1
                probe.splits.append((hist.clone(), k, {
                    f: s[f].clone() for f in ("did", "col", "bin", "nal",
                                              "gain")}))
            return s
        self.BN.gbm_multi_chunk_trainer = trainer
        self.BN.find_splits_binned = find
        return self

    def __exit__(self, *exc):
        self.BN.gbm_multi_chunk_trainer = self.trainer
        self.BN.find_splits_binned = self.find


def _split_gain(torch, h, col, b, nal, k):
    """The split search's gain of one numeric split (column, last bin on
    the left, NA direction) of one leaf's histogram h (C_pad, 4, BP), in
    float64."""
    B, lam = k["b_val"], k["lam"]
    rows = h[col].double()
    den = rows[2] if k["use_hess"] else rows[0]
    g = rows[1]
    gl = g[:b + 1].sum() + (g[B] if nal else 0.0)
    dl = den[:b + 1].sum() + (den[B] if nal else 0.0)
    gt, dt = g[:B + 1].sum(), den[:B + 1].sum()

    def score(d_, g_):
        return float(g_ * g_ / max(float(d_) + lam, 1e-30)) if d_ > 0 \
            else 0.0
    return score(dl, gl) + score(dt - dl, gt - gl) - score(dt, gt)


def restart_probe_report(torch, n, depth, dp, ep):
    """The restart's margins against the ones (d) had routed at the same
    iteration, and the first split of the restart's first iteration that
    differs from (d)'s: both choices' gains on both runs' histograms."""
    dF = (ep.F[:n] - dp.F[:n]).abs().max().item()
    say(f"covtype (e): margins the restart walked from the prior's trees "
        f"vs (d)'s routed margins after the same iterations: max abs diff "
        f"{dF:.3g} over {n} rows x {dp.F.shape[1]} classes (max |F| "
        f"{dp.F[:n].abs().max().item():.3g})")
    check(dF < 1e-4, f"covtype (e): the restart resumed from other margins "
          f"(max abs diff {dF})")
    for i, ((hd, k, sd), (he, _, se)) in enumerate(zip(dp.splits,
                                                       ep.splits)):
        diff = (sd["did"] != se["did"]) | (sd["did"] & (
            (sd["col"] != se["col"]) | (sd["bin"] != se["bin"])
            | (sd["nal"] != se["nal"])))
        if not bool(diff.any()):
            continue
        c, lev = divmod(i, depth)
        leaf = int(diff.nonzero()[0, 0])
        pick = [(int(s["col"][leaf]), int(s["bin"][leaf]),
                 bool(s["nal"][leaf])) for s in (sd, se)]
        gains = [[_split_gain(torch, h[leaf], *sp, k) for sp in pick]
                 for h in (hd, he)]
        rel = [abs(g[0] - g[1]) / max(abs(g[0]), 1e-300) for g in gains]
        hrel = ((hd[leaf] - he[leaf]).abs().amax(dim=(0, 2))
                / hd[leaf].abs().amax(dim=(0, 2)).clamp(min=1e-30))
        say(f"covtype (e): first split of the restart's first iteration "
            f"that differs from (d)'s: class {c} level {lev} leaf {leaf} "
            f"({float(hd[leaf, 0, 0].sum()):.0f} rows); (d) chose column/"
            f"bin/NA-left {pick[0]} with gain {float(sd['gain'][leaf]):.9g}"
            f", the restart {pick[1]} with gain {float(se['gain'][leaf]):.9g}"
            f"; in float64 on (d)'s histogram {gains[0][0]:.9g} vs "
            f"{gains[0][1]:.9g} (relative gap {rel[0]:.3g}), on the "
            f"restart's {gains[1][0]:.9g} vs {gains[1][1]:.9g} (relative "
            f"gap {rel[1]:.3g}); the leaf's histograms differ by at most "
            f"{hrel[0].item():.3g} / {hrel[1].item():.3g} / "
            f"{hrel[2].item():.3g} of their largest w / wg / wh bin")
        return
    say("covtype (e): every split of the restart's first iteration is "
        "(d)'s")


def phase_covtype(torch, h2o, HC):
    """Runs (d) and (e): a multinomial GBM at Covertype width, then the
    same model built as 10 iterations and a checkpoint restart to 20.
    Returns (d)'s launches and one tree's recorded calls."""
    from h2o3_tpu_torch.models.tree import binned as BN
    dev = h2o.init().device
    fr, y = _covtype_frame(torch, dev, COV_N, 9)
    valid, _ = _covtype_frame(torch, dev, COV_VALID_N, 10)
    K = len(COV_PRIOR)
    prior = torch.bincount(y, minlength=K).double() / COV_N
    entropy = float(-(prior * prior.clamp(min=1e-300).log()).sum())
    del y
    torch.cuda.synchronize()
    keep = {"sbh_hist_radix": 1, "sbh_route_hist_fused": 5,
            "sbh_hist_dense": 2, "sbh_route": 3}
    half = COV_GBM["ntrees"] // 2
    interval = COV_GBM["score_tree_interval"]
    searches = K * COV_GBM["max_depth"]
    # (d)'s margins after `half` iterations, where (e)'s restart starts
    with RestartProbe(BN, half // interval, searches) as dp:
        d, launches, _, trees, calls = train_run(
            torch, h2o, HC, fr, "covtype (d): multinomial GBM",
            PER_TREE["multinomial"], keep, valid=valid, **COV_GBM)
    check(trees == COV_GBM["ntrees"] * K, f"covtype (d): {trees} trees")
    ll, vll = d.logloss(), d.logloss(valid=True)
    last = d.scoring_history()[-1]
    t0 = time.perf_counter()
    pv = d.predict(valid)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    P = torch.stack([pv.vec(f"p{c + 1}").as_f32() for c in range(K)], 1)
    psum_err = (P.double().sum(1) - 1).abs().max().item()
    say(f"covtype (d): {trees} trees ({COV_GBM['ntrees']} iterations x "
        f"{K} classes); training logloss {ll:.6f} (last history entry "
        f"{last['training_logloss']:.6f}, class prior entropy "
        f"{entropy:.6f}), error {d._output.training_metrics.error:.6f}; "
        f"validation logloss {vll:.6f}; predict {COV_VALID_N} rows "
        f"{t_pred:.3f} s, probabilities sum to 1 within {psum_err:.3g}")
    check(bool(torch.isfinite(P).all()) and psum_err < 1e-5,
          f"covtype (d): probabilities bad (sum err {psum_err})")
    check(ll < entropy - COV_LOGLOSS_MARGIN, f"covtype (d): training logloss "
          f"{ll} not below the prior's entropy {entropy} by "
          f"{COV_LOGLOSS_MARGIN}")
    check(abs(last["training_logloss"] - ll) < 1e-4, f"covtype (d): history "
          f"logloss {last['training_logloss']} vs final {ll}")
    check(math.isfinite(vll), f"covtype (d): validation logloss {vll}")
    del pv, P

    # (e) the same model as 10 iterations, then a restart to 20
    e1, *_ = train_run(
        torch, h2o, HC, fr, "covtype (e): first 10 iterations",
        PER_TREE["multinomial"], {}, valid=valid,
        **dict(COV_GBM, ntrees=half, model_id="covtype_e1"))
    with RestartProbe(BN, 0, searches) as ep:
        e2, *_ = train_run(
            torch, h2o, HC, fr, "covtype (e): restart to 20 iterations",
            PER_TREE["multinomial"], {}, valid=valid, prior_trees=half * K,
            **dict(COV_GBM, checkpoint="covtype_e1"))
    restart_probe_report(torch, COV_N, COV_GBM["max_depth"], dp, ep)
    del dp, ep
    same = [sum(_same_splits(torch, a, b, t)
                for a, b in zip(d._trees_k, e2._trees_k))
            for t in range(COV_GBM["ntrees"])]
    dval = [max((a.value[t] - b.value[t]).abs().max().item()
                for a, b in zip(d._trees_k, e2._trees_k))
            for t in range(COV_GBM["ntrees"])]
    dll, dvll = abs(e2.logloss() - ll), abs(e2.logloss(valid=True) - vll)
    say(f"covtype (e): restart training logloss {e2.logloss():.6f} (d: "
        f"{ll:.6f}, diff {dll:.3g}), validation logloss "
        f"{e2.logloss(valid=True):.6f} (d: {vll:.6f}, diff {dvll:.3g}); "
        f"trees that split as (d)'s node for node: prior {sum(same[:half])} "
        f"of {half * K} (leaf values max diff {max(dval[:half]):.3g}), "
        f"restart {sum(same[half:])} of {half * K} (leaf values max diff "
        f"{max(dval[half:]):.3g})")
    # the prior is (d)'s first iterations built again: the same bits
    check(all(c == K for c in same[:half]) and max(dval[:half]) == 0.0,
          f"covtype (e): the prior's trees differ from (d)'s first {half} "
          f"iterations: {same[:half]}, values {max(dval[:half])}")
    check(dll < 1e-3 and dvll < 1e-3, f"covtype (e): restart logloss off by "
          f"{dll} (training), {dvll} (validation)")
    try:
        h2o.H2OGradientBoostingEstimator(
            **dict(COV_GBM, ntrees=half, checkpoint="covtype_e1")).train(
            y="y", training_frame=fr)
        fail("covtype (e): a restart with ntrees not above the prior's ran")
    except ValueError as e:
        say(f"covtype (e): a restart to {half} iterations raises ValueError: "
            f"{e}")
    breakdown(torch, h2o, HC, fr, "covtype (d) configuration",
              **dict(COV_GBM, ntrees=2))
    del d, e1, e2, valid
    covtype_drf_run(torch, h2o, HC, fr, entropy)
    return launches, calls


class Stopwatch:
    """Times every call of a function, synchronising the card before and
    after so that each span holds its own device work."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.seconds, self.calls = torch, fn, 0.0, 0

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _watch(obj, name, torch):
    """Put a Stopwatch on obj.name (a module function or a class's
    method); returns (watch, restore)."""
    fn = getattr(obj, name)
    w = Stopwatch(torch, fn)
    setattr(obj, name, (lambda *a, _w=w, **k: _w(*a, **k))
            if isinstance(obj, type) else w)
    return w, lambda: setattr(obj, name, fn)


def breakdown(torch, h2o, HC, fr, label, **params):
    """A GBM training run (no validation frame) with a stopwatch on each
    stage of the estimator and on each kernel wrapper (the syncs make it a
    little slower than an unperturbed run)."""
    from h2o3_tpu_torch.models import model as MB
    from h2o3_tpu_torch.models.tree import binned as BN
    from h2o3_tpu_torch.models.tree import shared_tree as ST
    stages = [(MB.ModelBase, "_resolve_predictors"),
              (ST.SharedTreeEstimator, "_binned_setup"),
              (BN.BinnedGrower, "grow"), (BN, "find_splits_binned"),
              (ST.SharedTreeEstimator, "_record_history"),
              (ST.SharedTreeEstimator, "_record_history_multi"),
              (MB.ModelBase, "_score_train_valid")]
    stages += [(HC, name) for name in RECORDED]
    watches, restores = {}, []
    try:
        for obj, name in stages:
            watches[name], r = _watch(obj, name, torch)
            restores.append(r)
        m = h2o.H2OGradientBoostingEstimator(**params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for r in restores:
            r()
    parts = ", ".join(f"{n} {w.seconds:.3f} s/{w.calls}"
                      for n, w in watches.items())
    say(f"{label} train breakdown, {m.summary()['number_of_trees']} trees: "
        f"total {total:.3f} s; {parts} (find_splits_binned and the kernel "
        "wrappers run inside grow)")


def busy_share(torch, h2o, fr):
    """Run (c)'s configuration for 10 trees (no validation frame) under
    torch.profiler, and print the share of the train() window in which the
    card ran a kernel, a copy or a fill (the union of their intervals in
    the trace), with the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    m = h2o.H2OGradientBoostingEstimator(
        ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
        distribution="bernoulli", seed=1, int8_hist=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("h2o3_train"):
            m.train(y="y", training_frame=fr)
            torch.cuda.synchronize()
    t0, t1, dev = _trace_window(prof, "h2o3_train")
    if not dev:
        say("profiler: busy share not measured (the trace holds no device "
            "activity)")
        return
    busy = _busy(t0, dev)
    by_name = {}
    for a, b, e in dev:
        if e.get("cat") == "kernel":
            key = re.sub(r"^void |\(anonymous namespace\)::", "", e["name"])
            key = re.sub(r"[<(].*", "", key)
            by_name[key] = by_name.get(key, 0.0) + max(0.0, b - a)
    ours = sum(v for k, v in by_name.items() if re.search(
        r"(route|hist|radix|fused|pack)\w*_kernel$", k)
        and "::" not in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profiler, run (c) configuration, {HIGGS_TREES} trees: the card is "
        f"busy {busy / 1e3:.3f} ms of the {(t1 - t0) / 1e3:.3f} ms train() "
        f"window: busy share {busy / (t1 - t0):.4f}; the port's kernels "
        f"{ours / 1e3:.3f} ms; {len(dev)} device events; most device time: "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top))


# ---------------------------------------------------------------------------
# Runs (g)-(j): the adaptive engine (models/tree/engine.py TreeGrower). It
# is plain PyTorch: no wrapper of ops/hist_cuda.py may count a launch.
def _sub_frame(fr, n):
    """The first n rows of a frame, as a frame on the same device."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    return Frame(fr.names, [Vec.from_tensor(v.as_f32()[:n].contiguous(),
                                            type=v.type, domain=v.domain)
                            for v in fr.vecs])


def _deepest_level(trees):
    """The depth of the deepest leaf: one below the deepest split node."""
    split = (trees.col >= 0).nonzero()
    if split.numel() == 0:
        return 0
    return int(math.log2(int(split[:, 1].max()) + 1)) + 1


def _stage_bytes(fn, args, out):
    """The bytes one call of an adaptive stage must move: every input read
    once and every output written once, as the port holds them."""
    def nb(t):
        return t.numel() * t.element_size() if hasattr(t, "numel") else 0
    outs = out if isinstance(out, tuple) else (out,)
    if fn == "route_rows":
        # one f32 of the split column per row, the row state in and out,
        # the per-leaf tables
        X, leaf, heap, active = args[:4]
        return (4 * leaf.numel() + 2 * (nb(leaf) + nb(heap) + nb(active))
                + sum(nb(t) for t in args[4:8]))
    if fn == "in_sample_rows":
        args = args[:3]
    return sum(nb(a) for a in args) + sum(nb(o) for o in outs)


class StageWatch(Stopwatch):
    """A Stopwatch on one stage function of the adaptive engine that also
    adds up the bytes its calls must move (the stage table's bound)."""

    def __init__(self, torch, fn, name):
        super().__init__(torch, fn)
        self.name, self.nbytes = name, 0

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        self.nbytes += _stage_bytes(self.name, args, out)
        return out


def adaptive_stage_table(torch, h2o, fr, label, estimator, **params):
    """One tree of a run with a StageWatch on each stage function of the
    adaptive engine (module globals, so the level step reaches them);
    prints each stage's time beside its bound (bytes over 3.35 TB/s)."""
    from h2o3_tpu_torch.models.tree import engine as E
    m = getattr(h2o, estimator)(**dict(params, ntrees=1))
    watches = {key: StageWatch(torch, getattr(E, fn), fn)
               for key, fn in STAGES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for key, fn in STAGES:
            setattr(E, fn, watches[key])
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
    finally:
        for key, fn in STAGES:
            setattr(E, fn, watches[key].fn)
    total = time.perf_counter() - t0
    say(f"adaptive stages, one tree of {label}: train {total:.3f} s; "
        + ", ".join(f"{k} {1e3 * w.seconds:.3f} ms/{w.calls} (bound "
                    f"{1e3 * w.nbytes / HBM_BYTES_S:.4f})"
                    for k, w in watches.items()))


def time_range_forms(torch, fr):
    """The two forms of the adaptive engine's per-(leaf, column) ranges at
    run (g)'s rows (11M x 28 of the HIGGS frame), over seeded random
    leaves: rows sorted by leaf and reduced a leaf at a time, against a
    scatter min/max (engine.SORTED_RANGE_LEAVES picks
    between them by the level's leaves). Both give the same bits."""
    from h2o3_tpu_torch.models.tree import engine as E
    X = torch.stack([v.as_f32() for v in fr.vecs[:HIGGS_C]], 1)
    g = torch.Generator(device=X.device)
    g.manual_seed(3)
    saved, parts = E.SORTED_RANGE_LEAVES, []
    try:
        for L in (2, 32, 128, 512, 4096):
            ls = torch.randint(0, L, (X.shape[0],), generator=g,
                               device=X.device)
            res = {}
            for form, limit in (("sorted", 1 << 30), ("scatter", 0)):
                E.SORTED_RANGE_LEAVES = limit
                res[form] = (time_ms(torch, lambda: E._ranges(X, ls, L), 3),
                             E._ranges(X, ls, L))
            same = all(torch.equal(a, b) for a, b in
                       zip(res["sorted"][1], res["scatter"][1]))
            check(same, f"range forms differ at L {L}")
            parts.append(f"L {L}: sorted {res['sorted'][0]:.3f} ms, "
                         f"scatter {res['scatter'][0]:.3f} ms")
    finally:
        E.SORTED_RANGE_LEAVES = saved
    say(f"adaptive ranges, {X.shape[0]} rows x {X.shape[1]} columns, the "
        f"two forms (bit-identical): " + "; ".join(parts))


def adaptive_run(torch, h2o, HC, fr, label, valid=None, **params):
    """An adaptive-engine run through train_run: no kernel launch, the
    deepest level reached and the seconds a tree."""
    m, launches, t_train, trees, _ = train_run(
        torch, h2o, HC, fr, label, {}, {}, valid=valid, **params)
    check(not any(launches.values()), f"{label}: kernel launches "
          f"{launches} on the adaptive engine")
    ens = m._trees_k if getattr(m, "_trees_k", None) is not None \
        else [m._trees]
    deepest = max(_deepest_level(t) for t in ens)
    grown = sum(t.ntrees for t in ens)
    say(f"{label}: {grown} trees grown, {t_train / max(grown, 1):.3f} s a "
        f"tree, deepest level reached {deepest} of {params['max_depth']}")
    return m, t_train, trees, deepest


def xgboost_run(torch, h2o, HC, fr, valid):
    """Run (g): XGBoost at its defaults, 20 trees, on the HIGGS frame with
    its validation frame; then TreeSHAP over 10,000 of its rows."""
    m, *_ = adaptive_run(torch, h2o, HC, fr, "xgboost (g): HIGGS",
                         valid=valid, estimator="H2OXGBoostEstimator",
                         **XGB_HIGGS)
    auc, vauc = m.auc(), m.auc(valid=True)
    last = m.scoring_history()[-1]
    say(f"xgboost (g): train AUC {auc:.6f}, validation AUC {vauc:.6f} (last "
        f"history entry {last['validation_auc']:.6f})")
    check(auc > 0.7 and vauc > 0.7, f"xgboost (g) AUC {auc}, valid {vauc}")
    check(abs(last["validation_auc"] - vauc) < 1e-4, f"xgboost (g): history "
          f"validation AUC {last['validation_auc']} vs final {vauc}")
    # the histogram sums in exact fixed point: a second training builds the
    # same trees bit for bit (an f32 scatter-add's order would not)
    again = h2o.H2OXGBoostEstimator(**XGB_HIGGS)
    again.train(y="y", training_frame=fr)
    same = all(torch.equal(getattr(m._trees, k), getattr(again._trees, k))
               for k in ("col", "thr", "na_left", "value"))
    say(f"xgboost (g): trained again, the same trees bit for bit: {same} "
        f"(train AUC {again.auc():.6f})")
    check(same, "xgboost (g): a second training built other trees")
    del again
    sub = _sub_frame(fr, XGB_SHAP_ROWS)
    from h2o3_tpu_torch.models.tree import engine as E
    X = m._dinfo.matrix(sub)
    margin = (m._f0 + float(m.params["learn_rate"])
              * E.predict_ensemble(X, m._trees)).double().cpu().numpy()
    t0 = time.perf_counter()
    phi = m.predict_contributions(sub).to_numpy()
    t_shap = time.perf_counter() - t0
    err = float(np.abs(phi.sum(1) - margin).max())
    say(f"xgboost (g): TreeSHAP of {XGB_SHAP_ROWS} rows x {X.shape[1]} "
        f"features over {m._trees.ntrees} trees in {t_shap:.3f} s (host "
        f"C++); rows sum to the margin within {err:.3g}")
    check(phi.shape == (XGB_SHAP_ROWS, X.shape[1] + 1) and err < 1e-4,
          f"xgboost (g): SHAP rows off the margin by {err}")
    del m


def deep_drf_run(torch, h2o, HC, fr):
    """Run (h): DRF at H2O's defaults (depth 20) on the HIGGS frame."""
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "drf (h): HIGGS at H2O's defaults",
        estimator="H2ORandomForestEstimator", **DRF_DEEP)
    oob = m.auc()
    say(f"drf (h): OOB AUC {oob:.6f}, mtries {m.summary()['mtries']}, "
        f"engine {m.summary()['engine']}")
    check(oob > 0.7, f"drf (h) OOB AUC {oob}")
    check(trees == DRF_DEEP["ntrees"], f"drf (h): {trees} trees")
    del m


def covtype_drf_run(torch, h2o, HC, fr, entropy):
    """Run (i): a multinomial DRF at DRF's defaults (depth 20) on the
    Covertype frame, 3 iterations of 7 class trees."""
    K = len(COV_PRIOR)
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "covtype (i): multinomial DRF",
        estimator="H2ORandomForestEstimator", **COV_DRF)
    ll = m.logloss()
    say(f"covtype (i): training logloss {ll:.6f} (class prior entropy "
        f"{entropy:.6f}), {m.summary()['number_of_trees']} iterations of "
        f"{K} class trees")
    check(trees == COV_DRF["ntrees"],
          f"covtype (i): {trees} iterations built")
    check(ll < entropy - COV_LOGLOSS_MARGIN, f"covtype (i): training "
          f"logloss {ll} not below the prior's entropy {entropy} by "
          f"{COV_LOGLOSS_MARGIN}")
    del m


def _cc_frame(torch, dev, seed=11):
    """The credit-card-width frame: CC_N rows x CC_C N(0,1) columns made
    from a seeded torch.Generator on `dev`, CC_ANOM anomalies at seeded
    rows shifted by ISO_SHIFT in ISO_SHIFT_COLS seeded columns, and their
    0/1 labels as column "y" (which the isolation forest leaves out as
    the response)."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((CC_N, CC_C), generator=g, device=dev)
    rows = torch.randperm(CC_N, generator=g, device=dev)[:CC_ANOM]
    cols = torch.randperm(CC_C, generator=g, device=dev)[:ISO_SHIFT_COLS]
    X[rows[:, None], cols[None, :]] += ISO_SHIFT
    y = torch.zeros(CC_N, device=dev)
    y[rows] = 1.0
    names = [f"v{j}" for j in range(CC_C)] + ["y"]
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(CC_C)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    return Frame(names, vecs), y


def iso_auc(torch, m, fr, y):
    from h2o3_tpu_torch.models import metrics as M
    score = torch.as_tensor(m.predict(fr).to_numpy()[:, 0],
                            dtype=torch.float32)
    return M.binomial_metrics(y.cpu(), score).auc


def phase_isofor(torch, h2o, HC):
    """Run (j): an isolation forest at H2O's defaults at the width of the
    credit-card fraud set; the AUC of its score against the planted
    labels."""
    dev = h2o.init().device
    fr, y = _cc_frame(torch, dev)
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "isolation forest (j): credit-card width",
        estimator="H2OIsolationForestEstimator", **ISO)
    t0 = time.perf_counter()
    auc = iso_auc(torch, m, fr, y)
    t_pred = time.perf_counter() - t0
    say(f"isolation forest (j): {CC_N} rows x {CC_C} columns, {CC_ANOM} "
        f"planted anomalies: score AUC {auc:.6f} (bar {ISO_AUC_BAR}; a CPU "
        f"run of the same generator: {ISO_AUC_CPU}); sample size "
        f"{m._psi}; predict {t_pred:.3f} s")
    check(auc > ISO_AUC_BAR, f"isolation forest (j) AUC {auc}")


def phase_small_adaptive(torch, h2o, HC):
    """The CSV of phase 3 on the card against the CPU: XGBoost and a
    UniformAdaptive GBM (AUC within 1e-3), and an isolation forest with
    the same draws (the CPU generator's, moved to the card) whose score
    AUC against the label must agree within 1e-3. No kernel launches."""
    from h2o3_tpu_torch.models.tree import engine as E
    from h2o3_tpu_torch.models.tree import shared_tree as ST
    runs = (("xgboost", "H2OXGBoostEstimator",
             dict(ntrees=5, max_depth=4, seed=5)),
            ("gbm UniformAdaptive", "H2OGradientBoostingEstimator",
             dict(ntrees=5, max_depth=5, seed=5,
                  histogram_type="UniformAdaptive")),
            ("isolation forest", "H2OIsolationForestEstimator",
             dict(ntrees=20, max_depth=6, sample_size=128, seed=5)))
    saved = ST.SharedTreeEstimator._draws
    try:
        with tempfile.TemporaryDirectory() as tmp:
            csv = os.path.join(tmp, "train.csv")
            _write_csv(csv)
            for label, est, params in runs:
                res = {}
                for where in ("cpu", "cuda"):
                    h2o.init(device="cpu") if where == "cpu" else h2o.init()
                    ST.SharedTreeEstimator._draws = (
                        lambda self, device: E.Draws(
                            torch.Generator().manual_seed(5), device))
                    fr = h2o.import_file(csv)
                    HC.reset_launches()
                    m = getattr(h2o, est)(**params)
                    m.train(y="label", training_frame=fr)
                    launches = {k: v for k, v in HC.LAUNCHES.items() if v}
                    y = fr.vec("label").as_f32().cpu()
                    res[where] = (iso_auc(torch, m, fr, y)
                                  if est == "H2OIsolationForestEstimator"
                                  else m.auc(), launches,
                                  fr.matrix().device.type)
                (ca, _, _), (ga, gl, gd) = res["cpu"], res["cuda"]
                say(f"small path adaptive {label}: AUC card {ga:.6f} cpu "
                    f"{ca:.6f} (diff {abs(ga - ca):.3g}); launches {gl}")
                check(gd == "cuda" and not gl, f"small path {label}: "
                      f"device {gd}, launches {gl}")
                check(abs(ga - ca) < 1e-3, f"small path {label}: card AUC "
                      f"{ga} vs cpu {ca}")
    finally:
        ST.SharedTreeEstimator._draws = saved


# ---------------------------------------------------------------------------
# Runs (k)-(p): GLM on the one-hot design matrix, cross-validation and the
# custom GBM distribution. GLM's passes over the rows are PyTorch on the
# card (its Gram one cuBLAS f32 matrix product, TF32 off) and its solves
# float64 numpy on the host, as in the JAX package: no kernel of ops/csrc
# is on its path. Only (p), cross-validation of a binned GBM, launches
# them.
def _glm_tf32(torch):
    on = bool(torch.backends.cuda.matmul.allow_tf32)
    say(f"glm: TF32 for float32 matmuls: allow_tf32 {on}, float32 matmul "
        f"precision {torch.get_float32_matmul_precision()!r} (the port "
        "never turns TF32 on)")
    check(not on and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the GLM Gram would lose 13 mantissa bits a product")


def _logloss_udf(torch):
    """A custom metric: the binomial logloss as the metrics compute it,
    per-row components folded by the model's map-reduce."""
    from h2o3_tpu_torch import udf

    class Logloss(udf.CustomMetric):
        name = "logloss"

        def map(self, pred, y, w):
            p = pred[:, 1].clamp(1e-15, 1 - 1e-15)
            return (-w * (y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)

        def metric(self, agg):
            return float(agg[0] / agg[1])
    return Logloss()


def _gaussian_udf(torch):
    """A custom distribution that is gaussian: y - F, ones, identity."""
    from h2o3_tpu_torch import udf

    class Gaussian(udf.CustomDistribution):
        def grad_hess(self, F, y):
            return y - F, torch.ones_like(F)
    return Gaussian()


def _glm_stage_bounds(n, p1):
    """Bounds (ms) of one IRLS iteration's device stages at n rows and p1
    columns: each input read once and each output written once over
    3.35 TB/s, or the f32 operations over 67 TFLOP/s, whichever is
    larger."""
    return {
        "_eta_pass": _bound_ms(4 * (n * p1 + p1 + n), 2 * n * p1),
        "_irls_weights": _bound_ms(4 * 5 * n, 10 * n),
        "_gram_pass": _bound_ms(4 * (n * p1 + 2 * n + p1 * p1 + p1),
                                2 * n * p1 * p1 + 3 * n * p1),
    }


def glm_stage_table(torch, h2o, fr, label, **params):
    """One GLM fit with a stopwatch (synchronising each call) on each stage
    of an IRLS iteration: the passes over the rows on the card, then the
    copy of G and q to the host and the float64 solve (or COD)."""
    from h2o3_tpu_torch.models import glm as GLM
    names = (("eta pass", "_eta_pass"),
             ("working weights and response", "_irls_weights"),
             ("Gram pass", "_gram_pass"), ("host copy of G, q", "_host_gram"),
             ("f64 solve / COD", "_irls_solve"))
    watches, restores = {}, []
    for _, fn in names:
        watches[fn], r = _watch(GLM, fn, torch)
        restores.append(r)
    fit, r = _watch(GLM.H2OGeneralizedLinearEstimator, "_fit_irls", torch)
    restores.append(r)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = h2o.H2OGeneralizedLinearEstimator(**params)
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for r in restores:
            r()
    n, p1 = fr.nrows, m._dinfo.n_features + 1
    bounds = _glm_stage_bounds(n, p1)
    its = m._iterations
    say(f"glm stage table, {label}: {n} rows x {p1} columns (intercept "
        f"included), {its} IRLS iterations (+1 null-model Gram); ms a call "
        "(bound):")
    per_it = 0.0
    for title, fn in names:
        w = watches[fn]
        ms = 1000 * w.seconds / max(w.calls, 1)
        per_it += ms
        b = bounds.get(fn)
        say(f"glm stage {title} ({fn}): {ms:.3f} ms x {w.calls} calls "
            f"(bound {'%.3f ms, by %s' % b if b is not None else '-'})")
    say(f"glm stage one IRLS iteration: {per_it:.3f} ms (bound "
        f"{sum(b for b, _ in bounds.values()):.3f} ms); _fit_irls {fit.seconds:.3f} s; "
        f"whole train() {total:.3f} s; host syncs an iteration: 1 copy of "
        "G and q (plus the intercept start's two sums once)")


def glm_gram_check(torch, m, fr):
    """The card's f32 Gram of (k)'s design at its final coefficients
    against the float64 Gram of the same X, w and z on the card."""
    from h2o3_tpu_torch.models import glm as GLM
    di = m._dinfo
    X = di.matrix(fr)
    Xi = torch.cat([X, torch.ones((X.shape[0], 1), device=X.device)], 1)
    del X
    y, w = di.response(fr), di.weights(fr)
    beta = torch.as_tensor(m._state.beta, dtype=torch.float32,
                           device=Xi.device)
    wi, z = GLM._irls_weights("binomial", "logit", GLM._eta_pass(Xi, beta),
                              y, w)
    G, q = GLM._gram_pass(Xi, wi, z)
    G64, q64 = GLM._gram_pass(Xi.double(), wi.double(), z.double())
    rg = ((G.double() - G64).abs().max() / G64.abs().max()).item()
    rq = ((q.double() - q64).abs().max() / q64.abs().max()).item()
    say(f"glm (k): f32 Gram on the card vs float64 Gram of the same X: max "
        f"abs diff {rg:.3g} of the largest |G| entry, q {rq:.3g} (limit "
        f"{GLM_GRAM_RTOL})")
    check(rg <= GLM_GRAM_RTOL and rq <= GLM_GRAM_RTOL,
          f"glm (k): f32 Gram off the float64 one by {rg} (q {rq})")


def glm_slice_card_vs_cpu(torch, h2o, fr):
    """(k)'s fit without cross-validation on the frame's first 200,000
    rows, on the card and on the CPU."""
    params = {k: v for k, v in GLM_K.items() if k not in ("nfolds", "seed")}
    sl = _sub_frame(fr, GLM_SLICE_N)

    def fit(frame):
        m = h2o.H2OGeneralizedLinearEstimator(**params)
        m.train(y="y", training_frame=frame)
        return m
    card = fit(sl)
    cpu = _on_cpu(h2o, lambda: fit(_cpu_frame(sl)))
    db = float(np.abs(card._state.beta - cpu._state.beta).max()
               / np.abs(cpu._state.beta).max())
    da = abs(card.auc() - cpu.auc())
    say(f"glm (k) slice: {GLM_SLICE_N} rows, card vs CPU: coefficients max "
        f"diff {db:.3g} of the largest, AUC {card.auc():.6f} vs "
        f"{cpu.auc():.6f} (diff {da:.3g})")
    check(db <= 1e-4 and da <= 1e-5, f"glm (k) slice: card and CPU differ: "
          f"coefficients {db}, AUC {da}")


def glm_higgs_runs(torch, h2o, HC, fr, valid):
    """Runs (k) and (l) on the HIGGS frame."""
    from h2o3_tpu_torch import udf
    from h2o3_tpu_torch.models import model as MB
    ref = udf.register_udf("chip_logloss", _logloss_udf(torch))
    # the p-values import scipy.stats at their first use, once a process
    # (as the JAX package does): timed here, apart from (k)'s fits
    t0 = time.perf_counter()
    try:
        from scipy import stats  # noqa: F401
        say(f"glm: scipy.stats imported in {time.perf_counter() - t0:.3f} s "
            "(the first p-values' one-time cost, kept out of (k)'s fits)")
    except ImportError:
        say("glm: no scipy; p-values by math.erf")
    cv, r1 = _watch(MB.ModelBase, "_run_cross_validation", torch)
    split, r2 = _watch(MB, "_subframe", torch)
    # where a fit's time goes, over the five fold fits and the final one
    fit_stages = {name: _watch(MB.ModelBase, name, torch)
                  for name in ("_resolve_predictors", "_make_data_info",
                               "_score_train_valid")}
    fit_stages["_fit"] = _watch(h2o.H2OGeneralizedLinearEstimator, "_fit",
                                torch)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        HC.reset_launches()
        t0 = time.perf_counter()
        m = h2o.H2OGeneralizedLinearEstimator(custom_metric_func=ref,
                                              **GLM_K)
        m.train(y="y", training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k: v for k, v in HC.LAUNCHES.items() if v}
    finally:
        r1()
        r2()
        for _, r in fit_stages.values():
            r()
    peak = torch.cuda.max_memory_allocated()
    tm = m._output.training_metrics
    cvm = m._output.cross_validation_metrics
    custom = tm.custom_metric["value"]
    folds = [f._iterations for f in m._cv_models]
    say(f"glm (k): binomial IRLSM lambda 0, standardize, p-values, "
        f"nfolds 5: {fr.nrows} rows x {len(fr.names) - 1} features: train() "
        f"{t_train:.3f} s (cross-validation {cv.seconds:.3f} s: the split "
        f"{split.seconds:.3f} s in {split.calls} subsets on the card, the "
        f"five fold fits and their holdout scoring "
        f"{cv.seconds - split.seconds:.3f} s); IRLS iterations {m._iterations}"
        f" (folds {folds}); peak memory {peak / 2**30:.2f} GiB "
        f"({(peak - held) / 2**30:.2f} GiB above what was held)")
    say("glm (k): the six fits' stages (five folds and the final model): "
        + ", ".join(f"{n} {w.seconds:.3f} s/{w.calls}"
                    for n, (w, _) in fit_stages.items())
        + " (_resolve_predictors rolls up every column of a new frame; "
        "_score_train_valid scores the training (and validation) rows with "
        "the custom metric)")
    say(f"glm (k): train AUC {m.auc():.6f}, validation AUC "
        f"{m.auc(valid=True):.6f}, CV AUC {cvm.auc:.6f}; logloss "
        f"{m.logloss():.9f}, custom metric {custom:.9f} (diff "
        f"{abs(custom - m.logloss()):.3g}); p-values of x0, x1: "
        f"{m._p_values[0]:.3g}, {m._p_values[1]:.3g}; launches {launches}")
    check(not launches, f"glm (k): kernel launches {launches}")
    check(m.auc() > 0.7 and m.auc(valid=True) > 0.7,
          f"glm (k) AUC: train {m.auc()}, validation {m.auc(valid=True)}")
    check(abs(custom - m.logloss()) <= 1e-6,
          f"glm (k): custom metric {custom} vs logloss {m.logloss()}")
    check(abs(cvm.auc - m.auc()) < 0.01,
          f"glm (k): CV AUC {cvm.auc} vs train AUC {m.auc()}")
    check(np.isfinite(m._p_values).all(), "glm (k): p-values not finite")
    performance_check("glm (k)", m, valid)
    glm_gram_check(torch, m, fr)
    k_auc = m.auc()
    KEPT["k"] = m
    del m
    glm_slice_card_vs_cpu(torch, h2o, fr)
    glm_stage_table(torch, h2o, fr, "run (k) without cross-validation",
                    **{k: v for k, v in GLM_K.items() if k != "nfolds"})

    # (l) elastic net down a 30-step lambda path (COD on the Gram)
    t0 = time.perf_counter()
    m = h2o.H2OGeneralizedLinearEstimator(**GLM_L)
    m.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t_l = time.perf_counter() - t0
    path = m._lambda_path
    active = [int((np.abs(b[:-1]) > 1e-10).sum()) for _, b in path]
    say(f"glm (l): elastic net alpha 0.5, lambda search: {len(path)} "
        f"lambdas from {path[0][0]:.4g} to {path[-1][0]:.4g}, active "
        f"predictors {active}; {m._iterations} IRLS iterations in "
        f"{t_l:.3f} s; last lambda's AUC {m.auc():.6f} ((k): {k_auc:.6f})")
    check(len(path) == GLM_L["nlambdas"], f"glm (l): {len(path)} lambdas")
    check(active[0] == 0 and active[-1] > active[0],
          f"glm (l): active predictors {active}")
    check(abs(m.auc() - k_auc) < 0.002,
          f"glm (l): last AUC {m.auc()} vs (k) {k_auc}")


def _covtype_categorical(torch, fr):
    """(d)'s Covertype frame with its 4 wilderness and 40 soil indicator
    columns folded back into two categorical columns of 4 and 40 levels."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    wild = fr.matrix([f"wild{j}" for j in range(COV_WILD)]).argmax(1)
    soil = fr.matrix([f"soil{j}" for j in range(COV_SOIL)]).argmax(1)
    num = [f"n{j}" for j in range(COV_NUM)]
    return Frame(num + ["wilderness", "soil", "y"],
                 [fr.vec(c) for c in num]
                 + [Vec.from_tensor(wild.float(), type=T_CAT,
                                    domain=[f"w{i}" for i in range(COV_WILD)]),
                    Vec.from_tensor(soil.float(), type=T_CAT,
                                    domain=[f"s{i:02d}"
                                            for i in range(COV_SOIL)]),
                    fr.vec("y")])


def glm_covtype_runs(torch, h2o, HC):
    """Runs (m) and (n): multinomial GLM at Covertype width on the one-hot
    design, by IRLSM and by L-BFGS."""
    from h2o3_tpu_torch.models import glm as GLM
    dev = h2o.init().device
    base, y = _covtype_frame(torch, dev, COV_N, 9)
    fr = _covtype_categorical(torch, base)
    K = len(COV_PRIOR)
    prior = torch.bincount(y, minlength=K).double() / COV_N
    entropy = float(-(prior * prior.clamp(min=1e-300).log()).sum())
    del y
    # the reduced design: neither categorical has an NA, so each loses
    # its first level beside the intercept
    want = ([f"wilderness.w{i}" for i in range(1, COV_WILD)]
            + [f"soil.s{i:02d}" for i in range(1, COV_SOIL)]
            + [f"n{j}" for j in range(COV_NUM)])

    class AllLevels(h2o.H2OGeneralizedLinearEstimator):
        """(m) on the design before the repair: every level beside the
        intercept (the JAX package's), a singular Gram."""

        def _reduced_design(self):
            return False
    t0 = time.perf_counter()
    before = AllLevels(**COV_GLM)
    before.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t_before = time.perf_counter() - t0
    it_before, ll_before = before._iterations, before.logloss()
    del before
    gram, restore = _watch(GLM, "_class_gram", torch)
    try:
        HC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = h2o.H2OGeneralizedLinearEstimator(**COV_GLM)
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        t_m = time.perf_counter() - t0
    finally:
        restore()
    launches = {k: v for k, v in HC.LAUNCHES.items() if v}
    p1 = m._dinfo.n_features + 1
    b, by = _bound_ms(4 * (COV_N * (p1 + 2) + K * p1 + p1 * p1 + p1),
                      2 * COV_N * p1 * (K + p1) + 12 * COV_N * K)
    say(f"glm (m): multinomial IRLSM on the one-hot design, {COV_N} rows, "
        f"{m._dinfo.n_features} features + intercept, {K} classes: "
        f"{m._iterations} sweeps in {t_m:.3f} s; per-class Gram "
        f"{1000 * gram.seconds / max(gram.calls, 1):.3f} ms x {gram.calls} "
        f"(bound {b:.3f} ms, by {by}); training logloss {m.logloss():.6f} (class "
        f"prior entropy {entropy:.6f}); launches {launches}")
    say(f"glm (m): the repair: {it_before} IRLS sweeps and training "
        f"logloss {ll_before!r} on every level's design ({t_before:.3f} s), "
        f"{m._iterations} sweeps and logloss {m.logloss()!r} on the "
        f"reduced design (diff {m.logloss() - ll_before:.3g}, limit 1e-4)")
    check(m.logloss() <= ll_before + 1e-4, f"glm (m): the reduced design's "
          f"logloss {m.logloss()} vs {ll_before} on every level's")
    check(m._dinfo.feature_names == want,
          f"glm (m): feature names {m._dinfo.feature_names}")
    check(m.logloss() < entropy, f"glm (m): logloss {m.logloss()} not below "
          f"the prior's entropy {entropy}")
    check(not launches, f"glm (m): kernel launches {launches}")
    ll_m = m.logloss()
    del m
    t0 = time.perf_counter()
    n = h2o.H2OGeneralizedLinearEstimator(
        **dict(COV_GLM, solver="L_BFGS"))
    n.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t_n = time.perf_counter() - t0
    say(f"glm (n): multinomial L-BFGS on (m)'s frame: {t_n:.3f} s; training "
        f"logloss {n.logloss():.6f} ((m): {ll_m:.6f}, diff "
        f"{abs(n.logloss() - ll_m):.3g})")
    check(abs(n.logloss() - ll_m) < 1e-3,
          f"glm (n): logloss {n.logloss()} vs (m) {ll_m}")


def custom_gbm_run(torch, h2o, HC, fr):
    """Run (o): GBM with a gaussian custom distribution against
    distribution="gaussian", both on the adaptive engine, on the HIGGS
    frame's 0/1 response as a number, and no kernel launch. The trees
    split alike, bit for bit, and their last level's leaves are equal; a
    leaf that stops above the last level takes a Newton refit from exact
    sums in the custom path (the JAX package's GammaPass for every
    distribution but gaussian) and its histogram's f32 sum under
    gaussian, so it may differ in its last bits (within 1e-6 relative);
    predictions within 1e-6. Whether all of it came out bit for bit is
    printed."""
    from h2o3_tpu_torch import udf
    from h2o3_tpu_torch.core.frame import Frame, Vec
    num = Frame(fr.names, fr.vecs[:-1] + [Vec.from_tensor(fr.vec("y").as_f32())])
    ref = udf.register_udf("chip_gaussian", _gaussian_udf(torch))
    models = {}
    for dist in ("custom", "gaussian"):
        HC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = h2o.H2OGradientBoostingEstimator(
            distribution=dist, custom_distribution_func=ref, **CUSTOM_GBM)
        m.train(y="y", training_frame=num)
        torch.cuda.synchronize()
        launches = {k: v for k, v in HC.LAUNCHES.items() if v}
        models[dist] = (m, time.perf_counter() - t0, launches)
    (c, tc, lc), (g, tg, lg) = models["custom"], models["gaussian"]
    ct, gt = c._trees, g._trees
    splits = all(torch.equal(getattr(ct, f), getattr(gt, f))
                 for f in ("col", "thr", "na_left"))
    # a leaf above the last level: the custom path refits it from exact
    # sums (GammaPass), gaussian keeps the f32 sum of its histogram bins
    D = CUSTOM_GBM["max_depth"]
    early = (torch.arange(ct.value.shape[1], device=ct.value.device)
             < 2 ** D - 1)[None, :] & (ct.col < 0)
    dv = (ct.value - gt.value).abs()
    rel = (dv / gt.value.abs().clamp(min=1e-30))[early]
    X = c._dinfo.matrix(num)
    pc, pg = c._score_matrix(X), g._score_matrix(X)
    bits = splits and torch.equal(ct.value, gt.value) and torch.equal(pc, pg)
    say(f"gbm custom (o): {CUSTOM_GBM['ntrees']} trees depth {D} "
        f"UniformAdaptive on {fr.nrows} rows: custom {tc:.3f} s "
        f"({c.summary()['engine']}), gaussian {tg:.3f} s; same splits: "
        f"{splits}; trees and predictions bit for bit: {bits}; leaves above "
        f"the last level: {int(early.sum())}, their values within "
        f"{(rel.max().item() if rel.numel() else 0.0):.3g} relative; the "
        f"last level's leaves equal: "
        f"{torch.equal(ct.value[:, 2 ** D - 1:], gt.value[:, 2 ** D - 1:])}"
        f"; predictions max diff {(pc - pg).abs().max().item():.3g}; rmse "
        f"{c.rmse():.6f} / {g.rmse():.6f}; launches {lc} / {lg}")
    check(c.summary()["engine"] == "adaptive", "gbm custom (o): not on the "
          "adaptive engine")
    check(splits and torch.equal(ct.value[:, 2 ** D - 1:],
                                 gt.value[:, 2 ** D - 1:])
          and (rel.numel() == 0 or rel.max().item() <= 1e-6)
          and (pc - pg).abs().max().item() <= 1e-6,
          "gbm custom (o): custom gaussian and gaussian differ")
    check(not lc and not lg, f"gbm custom (o): kernel launches {lc} {lg}")


def cv_gbm_run(torch, h2o, HC, fr):
    """Run (p): a bernoulli GBM with 3 stratified folds over the binned
    kernels: launches per tree over every tree built (fold models and the
    final model) as in (b), CV AUC near the training AUC, fold sizes."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.models import model as MB
    cv, r1 = _watch(MB.ModelBase, "_run_cross_validation", torch)
    split, r2 = _watch(MB, "_subframe", torch)
    try:
        HC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = h2o.H2OGradientBoostingEstimator(**CV_GBM)
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(HC.LAUNCHES)
    finally:
        r1()
        r2()
    trees = sum(int(x.summary()["number_of_trees"])
                for x in [m] + m._cv_models)
    per_tree = {k: v / trees for k, v in launches.items() if v}
    cv_auc = m._output.cross_validation_metrics.auc
    fa = DKV.get(m._output.cv_fold_assignment_key).vec("C1").as_f32()
    sizes = torch.bincount(fa.long(), minlength=3).tolist()
    off = max(abs(s - fr.nrows / 3) for s in sizes) / (fr.nrows / 3)
    say(f"gbm cv (p): bernoulli, 3 stratified folds, {trees} trees of depth "
        f"{CV_GBM['max_depth']} (folds + final): train() {t_train:.3f} s "
        f"(cross-validation {cv.seconds:.3f} s, split {split.seconds:.3f} s);"
        f" train AUC {m.auc():.6f}, CV AUC {cv_auc:.6f}; fold sizes {sizes} "
        f"(max off a third {off:.3g}); launches per tree {per_tree} "
        f"(expected {PER_TREE['default']})")
    check(per_tree == PER_TREE["default"],
          f"gbm cv (p): launches per tree {per_tree}")
    check(abs(cv_auc - m.auc()) < 0.01,
          f"gbm cv (p): CV AUC {cv_auc} vs train AUC {m.auc()}")
    check(off < 0.01, f"gbm cv (p): fold sizes {sizes}")


def phase_glm_cv(torch, h2o, HC):
    """Runs (k)-(p) at full width."""
    _glm_tf32(torch)
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    glm_higgs_runs(torch, h2o, HC, fr, valid)
    del valid
    custom_gbm_run(torch, h2o, HC, fr)
    cv_gbm_run(torch, h2o, HC, fr)
    del fr
    glm_covtype_runs(torch, h2o, HC)


def _identifiable(m):
    """A GLM's coefficients that its design determines: the numeric ones
    and, per categorical column, each level's coefficient less the first
    level's. A design that keeps every level of a categorical without NAs
    beside the intercept (the JAX package's) makes the Gram singular: the
    levels and the intercept move together along its null direction, by
    an amount the Gram's f32 rounding alone decides (ROADMAP.md §3). The
    port's reduced design drops the first level there, so its columns
    are already those differences."""
    di, b = m._dinfo, m._state.beta
    out, j = [], 0
    for c in di.cat_cols:
        k = di.cardinalities[c]
        if c in di.drop_first:
            out += list(b[j:j + k - 1])
            j += k - 1
        else:
            out += list(b[j + 1:j + k] - b[j])
            j += k
    return np.asarray(out + list(b[j:-1]))


def phase_small_glm(torch, h2o, HC):
    """The CSV of phase 3 on the card against the CPU: GLM binomial (on
    the label) and gaussian (on column a, whose NA rows drop out), both on
    the one-hot design of its color column, which has no NA: the
    coefficients the design determines (`_identifiable`) within 1e-4 of
    the largest, and predictions within 1e-5, each widened to 8 f32 ulps
    of the largest coefficient where the null direction has carried the
    coefficients far (the f32 resolution at which eta is computed); no
    kernel launch."""
    fits = (("binomial", "label", None),
            ("gaussian", "a", ["b", "c", "d", "color"]))
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "train.csv")
        _write_csv(csv)
        for fam, y, x in fits:
            res = {}
            for where in ("cpu", "cuda"):
                h2o.init(device="cpu") if where == "cpu" else h2o.init()
                fr = h2o.import_file(csv)
                HC.reset_launches()
                m = h2o.H2OGeneralizedLinearEstimator(family=fam,
                                                      lambda_=0.0)
                m.train(x=x, y=y, training_frame=fr)
                launches = {k: v for k, v in HC.LAUNCHES.items() if v}
                pred = m.predict(fr)
                res[where] = (m, launches, pred.vecs[-1].as_f32().device.type,
                              pred.vecs[-1].as_f32().cpu().numpy())
            (cm, _, _, cp), (gm, gl, gd, gp) = res["cpu"], res["cuda"]
            cb, gb = _identifiable(cm), _identifiable(gm)
            big = max(np.abs(cm._state.beta).max(),
                      np.abs(gm._state.beta).max())
            ulps = 8 * 2.0 ** -23 * big
            tol_b = max(1e-4, ulps / np.abs(cb).max())
            tol_p = max(1e-5, ulps)
            db = float(np.abs(gb - cb).max() / np.abs(cb).max())
            dp = float(np.nanmax(np.abs(gp - cp)))
            say(f"small path glm {fam}: IRLS iterations cpu "
                f"{cm._iterations} card {gm._iterations}, largest |coef| "
                f"{big:.6g}; {len(cb)} identifiable coefficients, card vs "
                f"cpu max diff {db:.3g} of the largest (limit {tol_b:.3g}); "
                f"predictions max diff {dp:.3g} (limit {tol_p:.3g}); "
                f"launches {gl}")
            check(gd == "cuda" and not gl, f"small path glm {fam}: device "
                  f"{gd}, launches {gl}")
            check(db <= tol_b and dp <= tol_p, f"small path glm {fam}: "
                  f"coefficients differ by {db}, predictions by {dp}")


# ---------------------------------------------------------------------------
# Runs (q)-(w): DeepLearning and the unsupervised family. The JAX package
# computes them in XLA without a Pallas call, so they are plain PyTorch on
# the card (their products cuBLAS f32 matmuls, TF32 off): no kernel of
# ops/csrc is on their paths, and none may count a launch.
def _cpu_frame(fr):
    """A frame's columns copied to the CPU (the card-vs-CPU slices)."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    return Frame(fr.names, [Vec.from_tensor(v.as_f32().cpu(), type=v.type,
                                            domain=v.domain)
                            for v in fr.vecs])


def _on_cpu(h2o, fn):
    """fn() with the cloud on the CPU; the card's cloud again after."""
    h2o.init(device="cpu")
    try:
        with host_only():
            return fn()
    finally:
        h2o.init()


def _peak_gib(torch, held):
    peak = torch.cuda.max_memory_allocated()
    return (f"peak memory {peak / 2**30:.2f} GiB "
            f"({(peak - held) / 2**30:.2f} GiB above what was held before "
            "train())")


def timed_train(torch, HC, label, make, **train_kw):
    """make() an estimator and train it with the launch counts reset just
    before and read just after (none may count); returns (model, train
    seconds, peak memory text)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m = make()
    HC.reset_launches()
    t0 = time.perf_counter()
    m.train(**train_kw)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = {k: v for k, v in HC.LAUNCHES.items() if v}
    check(not launches, f"{label}: kernel launches {launches}")
    return m, t, _peak_gib(torch, held)


def _dl_step_bounds(mb, dims, params):
    """Bounds (ms, by) of one step's stages at mini-batch mb through
    layers of `dims`: forward (the batch gathered, weights read,
    activations written), backward (activations and weights read, their
    gradients written; two products a layer) and ADADELTA (each parameter,
    its gradient and two accumulators read, three written)."""
    mac = sum(a * b for a, b in zip(dims, dims[1:]))
    acts = sum(dims[1:])
    return {
        "forward": _bound_ms(4 * (mb * dims[0] + params + mb * acts + 2 * mb),
                             2 * mb * mac),
        "backward": _bound_ms(4 * (2 * mb * acts + 2 * params), 4 * mb * mac),
        "optimizer": _bound_ms(4 * 7 * params, 10 * params),
    }


def dl_stage_table(torch, m, fr, label, steps=200):
    """`steps` ADADELTA steps of (a copy of) m's net on random batches of
    fr, synchronising between the stages: batch gather + forward + loss,
    backward, optimizer, each beside its bound."""
    import copy
    net = copy.deepcopy(m._net).requires_grad_(True)
    opt = torch.optim.Adadelta(net.parameters(), lr=1.0,
                               rho=float(m.params["rho"]),
                               eps=float(m.params["epsilon"]))
    di = m._dinfo
    X = di.matrix(fr)
    Xz = torch.where(torch.isnan(X), 0.0, X)
    y = di.response(fr).long()
    w = di.weights(fr)
    n, mb = Xz.shape[0], 256
    g = torch.Generator(device=Xz.device)
    g.manual_seed(2)
    idx = torch.randint(0, n, (steps, mb), generator=g, device=Xz.device)
    secs = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}

    def forward(i):
        out = net(Xz.index_select(0, i))
        ll = torch.nn.functional.cross_entropy(out, y.index_select(0, i),
                                               reduction="none")
        wb = w.index_select(0, i)
        return (wb * ll).sum() / torch.clamp(wb.sum(), min=1e-8)

    def backward(loss):
        opt.zero_grad(set_to_none=True)
        loss.backward()

    def step(i):
        backward(forward(i))
        opt.step()
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = forward(idx[s])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        backward(loss)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if s >= 10:                       # the first steps warm up
            secs["forward"] += t1 - t0
            secs["backward"] += t2 - t1
            secs["optimizer"] += t3 - t2
    # the same steps unsynchronised, as train() runs them
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(steps):
        step(idx[s])
    torch.cuda.synchronize()
    loop_ms = 1e3 * (time.perf_counter() - t0) / steps
    dims = [int(W.shape[0]) for W in net.W] + [int(net.W[-1].shape[1])]
    params = sum(p.numel() for p in net.parameters())
    bounds = _dl_step_bounds(mb, dims, params)
    timed = steps - 10
    say(f"{label} stage table, a step of {mb} rows through {dims} "
        f"({params} parameters), {timed} steps synchronised between stages; "
        "ms a step (bound, by): "
        + ", ".join(f"{k} {1e3 * v / timed:.4f} ({bounds[k][0]:.5f}, "
                    f"{bounds[k][1]})" for k, v in secs.items())
        + f"; sum {1e3 * sum(secs.values()) / timed:.4f} ms (bound "
        f"{sum(b for b, _ in bounds.values()):.5f}); the same {steps} steps "
        f"unsynchronised: {loop_ms:.4f} ms a step")


def _trace_window(prof, name):
    """The (t0, t1) of the user annotation `name` in a profiler trace, and
    the device events (copies, fills, kernels) clipped to it."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == name
              and e.get("cat") == "user_annotation" and "dur" in e]
    check(len(window) == 1, f"profiler: {len(window)} {name} windows")
    t0, t1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    dev = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1), e)
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e and e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    return t0, t1, dev


def _busy(t0, dev):
    busy, end = 0.0, t0
    for a, b, _ in dev:
        if b > max(a, end):
            busy += b - max(a, end)
        end = max(end, b)
    return busy


def dl_busy_share(torch, h2o, fr, epochs):
    """(q)'s configuration for `epochs` under torch.profiler: the share of
    the train() window in which the card ran a kernel, a copy or a fill,
    the kernels and host-to-device copies a step, the host's time by op.
    Returns the model."""
    from torch.profiler import ProfilerActivity, profile, record_function
    m = h2o.H2ODeepLearningEstimator(**dict(DL_HIGGS, epochs=epochs))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("h2o3_train"):
            m.train(y="y", training_frame=fr)
            torch.cuda.synchronize()
    t0, t1, dev = _trace_window(prof, "h2o3_train")
    if not dev:
        say("deeplearning (q) profiler: busy share not measured (the trace "
            "holds no device activity)")
        return m
    steps = int(epochs * fr.nrows / 256)
    kernels = [e for _, _, e in dev if e.get("cat") == "kernel"]
    h2d = [e for _, _, e in dev if e.get("cat") == "gpu_memcpy"
           and "HtoD" in e.get("name", "")]
    busy = _busy(t0, dev)
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    say("deeplearning (q) profiler: host time a step by op (self): "
        + ", ".join(f"{a.key} {a.self_cpu_time_total / 1e3 / steps:.4f} ms"
                    f" x {a.count / steps:.1f}" for a in host[:8]))
    say(f"deeplearning (q) profiler, {steps} steps of (q)'s configuration "
        f"(epochs {epochs}): the card is busy {busy / 1e3:.3f} ms of the "
        f"{(t1 - t0) / 1e3:.3f} ms train() window: busy share "
        f"{busy / (t1 - t0):.4f}; {len(kernels) / steps:.1f} kernel "
        f"launches a step ({len(kernels)} in all); {len(h2d)} host-to-device "
        f"copies ({sum(e['dur'] for e in h2d) / 1e3:.3f} ms)")
    return m


def _dl_net_diff(a, b):
    """The largest difference of two nets' parameters (b's moved to a's
    device)."""
    return max(float((p - q.to(p.device)).abs().max())
               for p, q in zip(a._net.parameters(), b._net.parameters()))


def dl_twice(torch, h2o, fr, m, epochs):
    """m, (q)'s configuration at `epochs`, trained again with the same
    seed: the largest weight difference from the first training; if it is
    not 0, one step run twice from the same state names the first stage
    whose output differs."""
    m2 = h2o.H2ODeepLearningEstimator(**dict(DL_HIGGS, epochs=epochs))
    m2.train(y="y", training_frame=fr)
    diff = _dl_net_diff(m, m2)
    where = "-"
    if diff:
        import copy
        X = m._dinfo.matrix(fr)[:256]
        y = m._dinfo.response(fr)[:256].long()
        outs = []
        for _ in range(2):
            net = copy.deepcopy(m._net).requires_grad_(True)
            opt = torch.optim.Adadelta(net.parameters(), lr=1.0, rho=0.99,
                                       eps=1e-8)
            out = net(X)
            loss = torch.nn.functional.cross_entropy(out, y)
            loss.backward()
            grads = [p.grad.clone() for p in net.parameters()]
            opt.step()
            outs.append((out, loss, grads, list(net.parameters())))
        (o1, l1, g1, p1), (o2, l2, g2, p2) = outs
        where = ("forward (addmm/relu)" if not torch.equal(o1, o2) else
                 "loss (cross_entropy)" if not torch.equal(l1, l2) else
                 "backward (autograd)" if any(not torch.equal(a, b)
                                              for a, b in zip(g1, g2)) else
                 "optimizer (Adadelta)" if any(not torch.equal(a, b)
                                               for a, b in zip(p1, p2)) else
                 "none in one step: the difference builds over steps")
    say(f"deeplearning (q): {epochs} epochs ({int(epochs * fr.nrows / 256)}"
        f" steps) trained twice with seed {DL_HIGGS['seed']}, the first "
        f"under the profiler: largest weight difference {diff:.3g}; first op "
        f"that differs: {where}")
    return diff


def dl_slice_card_vs_cpu(torch, h2o, fr):
    """(q)'s configuration on the frame's first DL_SLICE_N rows for one
    epoch, on the card and on the CPU, with the same draws (made on the
    CPU, moved to the card): the probabilities within DL_SLICE_TOL."""
    from h2o3_tpu_torch.models import deeplearning as DL
    params = dict(DL_HIGGS, epochs=1.0)
    sl = _sub_frame(fr, DL_SLICE_N)

    def fit(frame):
        m = h2o.H2ODeepLearningEstimator(**params)
        m._draws = lambda device: DL.Draws(
            torch.Generator().manual_seed(DL_HIGGS["seed"]), device)
        m.train(y="y", training_frame=frame)
        return m, m._score_matrix(m._dinfo.matrix(frame))[:, 1].cpu()
    card, pc = fit(sl)
    cpu, pp = _on_cpu(h2o, lambda: fit(_cpu_frame(sl)))
    dp = float((pc - pp).abs().max())
    dw = _dl_net_diff(card, cpu)
    say(f"deeplearning (q) slice: {DL_SLICE_N} rows, 1 epoch "
        f"({len(card.scoring_history())} history entries), card vs CPU "
        f"with the CPU's draws: probabilities max diff {dp:.3g} (limit "
        f"{DL_SLICE_TOL}), weights max diff {dw:.3g}; AUC card "
        f"{card.auc():.6f} cpu {cpu.auc():.6f}")
    check(dp <= DL_SLICE_TOL, f"deeplearning (q) slice: card and CPU "
          f"probabilities differ by {dp}")


def dl_higgs_run(torch, h2o, HC, fr, valid):
    """Run (q): DL binomial at H2O's defaults on the HIGGS frame with its
    validation frame."""
    m, t, peak = timed_train(
        torch, HC, "deeplearning (q)",
        lambda: h2o.H2ODeepLearningEstimator(**DL_HIGGS), y="y",
        training_frame=fr, validation_frame=valid)
    steps = int(DL_HIGGS["epochs"] * fr.nrows / 256)
    say(f"deeplearning (q): binomial, hidden {m.summary()['hidden']} "
        f"Rectifier, ADADELTA, mini-batch 256, epochs {DL_HIGGS['epochs']}: "
        f"{fr.nrows} rows x {len(fr.names) - 1} features, {steps} steps: "
        f"train() {t:.3f} s ({1e3 * t / steps:.4f} ms a step, scoring the "
        f"training and validation frames included); {peak}; train AUC "
        f"{m.auc():.6f}, validation AUC {m.auc(valid=True):.6f}; last "
        f"training loss {m.scoring_history()[-1]['training_loss']:.6f}")
    check(m.auc() > 0.7 and abs(m.auc(valid=True) - m.auc()) < 0.01,
          f"deeplearning (q) AUC: train {m.auc()}, validation "
          f"{m.auc(valid=True)}")
    dl_stage_table(torch, m, fr, "deeplearning (q)")
    KEPT["q"] = m
    del m
    m = dl_busy_share(torch, h2o, fr, DL_PROFILE_EPOCHS)
    dl_twice(torch, h2o, fr, m, DL_PROFILE_EPOCHS)
    dl_slice_card_vs_cpu(torch, h2o, fr)


def dl_covtype_run(torch, h2o, HC):
    """Run (r): DL multinomial on (m)'s Covertype frame (two categorical
    columns, expanded back to 54 one-hot features), 1 epoch."""
    dev = h2o.init().device
    base, y = _covtype_frame(torch, dev, COV_N, 9)
    fr = _covtype_categorical(torch, base)
    K = len(COV_PRIOR)
    prior = torch.bincount(y, minlength=K).double() / COV_N
    entropy = float(-(prior * prior.clamp(min=1e-300).log()).sum())
    m, t, peak = timed_train(
        torch, HC, "deeplearning (r)",
        lambda: h2o.H2ODeepLearningEstimator(**DL_COV), y="y",
        training_frame=fr)
    steps = int(DL_COV["epochs"] * COV_N / 256)
    say(f"deeplearning (r): multinomial on Covertype's one-hot design "
        f"({m._dinfo.n_features} features, {K} classes), epochs "
        f"{DL_COV['epochs']}, {steps} steps: train() {t:.3f} s "
        f"({1e3 * t / steps:.4f} ms a step); {peak}; training logloss "
        f"{m.logloss():.6f} (class prior's entropy {entropy:.6f})")
    check(m._dinfo.n_features == COV_NUM + COV_WILD + COV_SOIL,
          f"deeplearning (r): {m._dinfo.n_features} features")
    check(m.logloss() < entropy, f"deeplearning (r): logloss "
          f"{m.logloss()} not below the prior's entropy {entropy}")


def dl_autoencoder_run(torch, h2o, HC):
    """Run (s): a DL autoencoder at credit-card width, anomaly()'s AUC
    against the planted labels."""
    from h2o3_tpu_torch.models import metrics as M
    dev = h2o.init().device
    fr, y = _cc_frame(torch, dev)
    xs = [f"v{j}" for j in range(CC_C)]
    m, t, peak = timed_train(
        torch, HC, "deeplearning (s)",
        lambda: h2o.H2ODeepLearningEstimator(**DL_AE), x=xs,
        training_frame=fr)
    t0 = time.perf_counter()
    mse = m.anomaly(fr).vecs[0].as_f32()
    torch.cuda.synchronize()
    t_an = time.perf_counter() - t0
    auc = M.binomial_metrics(y, mse).auc
    steps = int(DL_AE["epochs"] * CC_N / 256)
    say(f"deeplearning (s): autoencoder {DL_AE['activation']} hidden "
        f"{m.summary()['hidden']}, {CC_N} rows x {CC_C} columns, epochs "
        f"{DL_AE['epochs']}, {steps} steps: train() {t:.3f} s; {peak}; "
        f"anomaly() {t_an:.3f} s; reconstruction-MSE AUC against the "
        f"{CC_ANOM} planted anomalies {auc:.6f} (bar {DL_AE_AUC_BAR}; a CPU "
        f"run of the same generator: {DL_AE_AUC_CPU})")
    check(auc > DL_AE_AUC_BAR, f"deeplearning (s) AUC {auc}")


def _blob_frame(torch, dev, n, seed):
    """The KMeans frame at HIGGS shape, made on `dev` from a seeded
    generator: BLOB_K centres of HIGGS_C coordinates N(0, BLOB_SPREAD²),
    each row one of them (uniformly) plus N(0, 1) noise. Returns (frame,
    centres)."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    centres = BLOB_SPREAD * torch.randn((BLOB_K, HIGGS_C), generator=g,
                                        device=dev)
    lab = torch.randint(0, BLOB_K, (n,), generator=g, device=dev)
    X = centres[lab] + torch.randn((n, HIGGS_C), generator=g, device=dev)
    return Frame([f"x{j}" for j in range(HIGGS_C)],
                 [Vec.from_tensor(X[:, j].contiguous())
                  for j in range(HIGGS_C)]), centres


def kmeans_stage_table(torch, m, fr):
    """One Lloyd step at (t)'s shape, and its parts, by CUDA events, each
    beside its bound."""
    from h2o3_tpu_torch.models import kmeans as KM
    from h2o3_tpu_torch.models.tree import engine as E
    X = m._dinfo.matrix(fr)
    w = m._dinfo.weights(fr)
    C = m._centroids
    n, p = X.shape
    k = C.shape[0]
    best, assign = torch.min(KM._distances(X, C), dim=1)
    vals = torch.cat([w[:, None] * X, w[:, None], (w * best)[:, None]], 1)
    parts = {
        "one Lloyd step": (lambda: KM._lloyd_step(X, C, w),
                           _bound_ms(4 * n * (p + 1) + 4 * k * p,
                                     2 * n * k * p + 3 * n * k)),
        "distances X·Cᵀ + argmin": (
            lambda: torch.min(KM._distances(X, C), dim=1),
            _bound_ms(4 * n * p + 12 * n, 2 * n * k * p)),
        "fixed-point segment sum": (
            lambda: E.segment_sum(assign, vals, k),
            _bound_ms(4 * n * (p + 2) + 8 * n, n * (p + 2))),
    }
    out = []
    for name, (fn, (b, by)) in parts.items():
        ms = time_ms(torch, fn, 5)
        out.append(f"{name} {ms:.3f} ms (bound {b:.3f}, {by})")
    say(f"kmeans (t) stage table, {n} rows x {p} columns, k {k}: "
        + "; ".join(out))


def kmeans_blob_run(torch, h2o, HC):
    """Run (t): KMeans on the blob frame, trained twice; a slice card vs
    CPU."""
    dev = h2o.init().device
    fr, centres = _blob_frame(torch, dev, HIGGS_N, 12)
    m, t, peak = timed_train(torch, HC, "kmeans (t)",
                             lambda: h2o.H2OKMeansEstimator(**KM_BLOBS),
                             training_frame=fr)
    cm = m.centroid_stats()
    hist = [h["tot_withinss"] for h in m.scoring_history()]
    say(f"kmeans (t): {HIGGS_N} rows x {HIGGS_C} columns, {BLOB_K} planted "
        f"blobs, k {KM_BLOBS['k']} Furthest, standardize: train() {t:.3f} "
        f"s, {len(hist)} iterations + the final step; {peak}; "
        f"tot_withinss by iteration {[round(v, 1) for v in hist]}; final "
        f"{cm.tot_withinss:.6g}, totss {cm.totss:.6g}, betweenss "
        f"{cm.betweenss:.6g}, sizes {[int(s) for s in cm.size]}")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
          f"kmeans (t): tot_withinss rose: {hist}")
    check(abs(cm.betweenss + cm.tot_withinss - cm.totss)
          <= 1e-5 * cm.totss, "kmeans (t): betweenss + tot_withinss != "
          "totss")
    check(sum(cm.size) == cm.nobs == HIGGS_N,
          f"kmeans (t): sizes sum to {sum(cm.size)}, nobs {cm.nobs}")
    # totss and tot_withinss against float64 sums of the same X
    X = m._dinfo.matrix(fr).double()
    Xc = X - X.mean(0)
    tot64 = float((Xc * Xc).sum())
    del Xc
    C64 = m._centroids.double()
    d = ((X * X).sum(1, keepdim=True) + (C64 * C64).sum(1)[None]
         - 2 * X @ C64.T).min(1).values.clamp(min=0)
    wss64 = float(d.sum())
    del X, d
    rt, rw = abs(cm.totss - tot64) / tot64, abs(cm.tot_withinss - wss64) \
        / wss64
    # the planted centres in the model's (standardised) space
    di = m._dinfo
    mu = torch.tensor([di.means[c] for c in di.num_cols], device=dev)
    sd = torch.tensor([di.sigmas[c] for c in di.num_cols], device=dev)
    planted = (centres - mu) / sd
    dist = torch.cdist(planted, m._centroids)
    near = dist.min(1)
    one_to_one = len(set(near.indices.tolist())) == BLOB_K
    say(f"kmeans (t): totss vs float64 {rt:.3g} relative, tot_withinss vs "
        f"float64 at the final centroids {rw:.3g} (limit 1e-5); planted "
        f"centres recovered: largest distance to the nearest centroid "
        f"{float(near.values.max()):.4g} standardised units (limit "
        f"{BLOB_RECOVER}), one centroid a centre: {one_to_one}")
    check(rt <= 1e-5 and rw <= 1e-5, f"kmeans (t): f32 sums off float64: "
          f"totss {rt}, tot_withinss {rw}")
    check(one_to_one and float(near.values.max()) < BLOB_RECOVER,
          "kmeans (t): planted centres not recovered")
    # a second training: the same centroids bit for bit
    m2 = h2o.H2OKMeansEstimator(**KM_BLOBS)
    m2.train(training_frame=fr)
    same = torch.equal(m._centroids, m2._centroids)
    say(f"kmeans (t): trained twice: centroids bit-identical {same} (max "
        f"diff {float((m._centroids - m2._centroids).abs().max()):.3g})")
    check(same, "kmeans (t): a second training gave other centroids")
    KEPT["t"] = m
    del m2
    kmeans_stage_table(torch, m, fr)
    # the first KM_SLICE_N rows on the card and on the CPU
    sl = _sub_frame(fr, KM_SLICE_N)
    card = h2o.H2OKMeansEstimator(**KM_BLOBS)
    card.train(training_frame=sl)

    def cpu_fit():
        c = h2o.H2OKMeansEstimator(**KM_BLOBS)
        c.train(training_frame=_cpu_frame(sl))
        return c
    cpu = _on_cpu(h2o, cpu_fit)
    dc = float((card._centroids.cpu() - cpu._centroids).abs().max())
    say(f"kmeans (t) slice: {KM_SLICE_N} rows, card vs CPU: centroids max "
        f"diff {dc:.3g} (limit 1e-4), iterations card "
        f"{len(card.scoring_history())} cpu {len(cpu.scoring_history())}")
    check(dc <= 1e-4, f"kmeans (t) slice: centroids differ by {dc}")


def _rank_frame(torch, dev, n, seed):
    """The PCA/SVD/GLRM frame at HIGGS shape, made on `dev`: a rank-RANK
    signal Z·L (Z (n, RANK) and L (RANK, HIGGS_C) N(0, 1)) plus N(0,
    RANK_NOISE²) noise; and a copy with NA_SHARE of its entries NA.
    Returns (frame, frame with NAs, X, L, NA mask)."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    L = torch.randn((RANK, HIGGS_C), generator=g, device=dev)
    X = torch.randn((n, RANK), generator=g, device=dev) @ L \
        + RANK_NOISE * torch.randn((n, HIGGS_C), generator=g, device=dev)
    na = torch.rand((n, HIGGS_C), generator=g, device=dev) < NA_SHARE
    names = [f"x{j}" for j in range(HIGGS_C)]
    full = Frame(names, [Vec.from_tensor(X[:, j].contiguous())
                         for j in range(HIGGS_C)])
    Xna = torch.where(na, float("nan"), X)
    holed = Frame(names, [Vec.from_tensor(Xna[:, j].contiguous())
                          for j in range(HIGGS_C)])
    return full, holed, X, L, na


def _gram_bound(n, p):
    return _bound_ms(4 * n * (p + 1) + 4 * p * p, 2 * n * p * p)


def pca_run(torch, h2o, HC, fr, X, L):
    """Run (u): PCA k RANK, STANDARDIZE, GramSVD on the rank frame."""
    from h2o3_tpu_torch.models import pca as PCA
    gram, restore = _watch(PCA, "_gram", torch)
    try:
        m, t, peak = timed_train(
            torch, HC, "pca (u)",
            lambda: h2o.H2OPrincipalComponentAnalysisEstimator(
                k=RANK, transform="STANDARDIZE", pca_method="GramSVD"),
            training_frame=fr)
    finally:
        restore()
    n, p = X.shape
    sdev = np.asarray(m.summary()["std_deviation"])
    cum = m.summary()["cumulative_proportion"][-1]
    # float64 Gram of the same standardised X on the card
    Xs = (X - torch.as_tensor(m._mean, device=X.device)) \
        / torch.as_tensor(m._sd, device=X.device)
    G64 = (Xs.double().T @ Xs.double()).cpu().numpy() / (n - 1)
    del Xs
    ev64 = np.sort(np.linalg.eigvalsh(G64))[::-1][:RANK]
    rel = float(np.abs(sdev ** 2 - ev64).max() / ev64.max())
    # the planted population: standardised (LᵀL + noise² I)
    Ld = L.double().cpu().numpy()
    S = Ld.T @ Ld + RANK_NOISE ** 2 * np.eye(p)
    dinv = 1 / np.sqrt(np.diag(S))
    ev, evec = np.linalg.eigh(S * dinv[:, None] * dinv[None, :])
    planted_cum = float(ev[::-1][:RANK].sum() / p)
    cosines = np.linalg.svd(evec[:, ::-1][:, :RANK].T @ m.rotation(),
                            compute_uv=False)
    angle = float(np.arccos(np.clip(cosines.min(), -1, 1)))
    b, by = _gram_bound(n, p)
    say(f"pca (u): {n} rows x {p} columns, rank-{RANK} signal + N(0, "
        f"{RANK_NOISE}²) noise, k {RANK} STANDARDIZE GramSVD: train() "
        f"{t:.3f} s; {peak}; Gram pass {1e3 * gram.seconds:.3f} ms (bound "
        f"{b:.3f}, {by}); eigenvalues {np.round(sdev ** 2, 4).tolist()}, vs "
        f"a float64 Gram of the same X: {rel:.3g} relative (limit 1e-5); "
        f"cumulative proportion at {RANK} PCs {cum:.6f} (planted "
        f"{planted_cum:.6f}); largest principal angle to the planted "
        f"loadings {angle:.3g} rad")
    check(rel <= 1e-5, f"pca (u): eigenvalues off float64 by {rel}")
    check(abs(cum - planted_cum) < 1e-3,
          f"pca (u): cumulative proportion {cum} vs planted {planted_cum}")
    check(angle < 0.01, f"pca (u): principal angle {angle}")


def svd_run(torch, h2o, HC, fr, X):
    """Run (v): SVD nv RANK with keep_u on the rank frame."""
    from h2o3_tpu_torch.models import svd as SVD
    gram, restore = _watch(SVD, "_gram_xtx", torch)
    try:
        m, t, peak = timed_train(
            torch, HC, "svd (v)",
            lambda: h2o.H2OSingularValueDecompositionEstimator(
                nv=RANK, keep_u=True), training_frame=fr)
    finally:
        restore()
    n, p = X.shape
    d = m.d()
    Xd = X.double()
    d64 = np.sqrt(np.sort(np.linalg.eigvalsh(
        (Xd.T @ Xd).cpu().numpy()))[::-1][:RANK])
    rel = float(np.abs(d - d64).max() / d64.max())
    U = m.u().matrix().double()
    orth = float((U.T @ U - torch.eye(RANK, device=U.device,
                                      dtype=torch.float64)).abs().max())
    V = torch.as_tensor(m.v(), device=U.device)
    R = Xd - (U * torch.as_tensor(d, device=U.device)) @ V.T
    rms = float(R.pow(2).mean().sqrt())
    del Xd, R, U
    want = RANK_NOISE * math.sqrt((p - RANK) / p)
    b, by = _gram_bound(n, p)
    say(f"svd (v): {n} rows x {p} columns, nv {RANK}, keep_u: train() "
        f"{t:.3f} s; {peak}; Gram pass {1e3 * gram.seconds:.3f} ms (bound "
        f"{b:.3f}, {by}); d {np.round(d, 3).tolist()}, vs float64 "
        f"{rel:.3g} relative (limit 1e-5); |UᵀU - I| {orth:.3g} (limit "
        f"1e-4); RMS of X - U·diag(d)·Vᵀ {rms:.6f} (the noise left outside "
        f"{RANK} dimensions: {want:.6f})")
    check(rel <= 1e-5, f"svd (v): d off float64 by {rel}")
    check(orth <= 1e-4, f"svd (v): UᵀU off I by {orth}")
    check(abs(rms - want) < 0.05 * want, f"svd (v): reconstruction RMS "
          f"{rms} vs noise {want}")


def glrm_run(torch, h2o, HC, fr, X, na):
    """Run (w): GLRM k RANK on the rank frame with NA_SHARE of it NA; the
    reconstruction's RMSE on the held-out entries."""
    from h2o3_tpu_torch.models import glrm as GL
    watches, restores = {}, []
    for name in ("step_A", "step_B", "objective"):
        watches[name], r = _watch(GL, name, torch)
        restores.append(r)
    try:
        m, t, peak = timed_train(
            torch, HC, "glrm (w)",
            lambda: h2o.H2OGeneralizedLowRankEstimator(k=RANK, seed=3),
            training_frame=fr)
    finally:
        for r in restores:
            r()
    obj = [h["objective"] for h in m.scoring_history()]
    R = m.reconstruct(fr).matrix()
    rmse = float((R - X)[na].pow(2).mean().sqrt())
    del R
    n, p = X.shape
    k = RANK
    # a held-out entry's error: the noise, and the error of the row's
    # coefficients fitted on its m = p(1 - NA_SHARE) observed entries,
    # k / (m - k - 1) of the noise's variance for Gaussian loadings (the
    # mean of an inverse Wishart)
    m_obs = p * (1 - NA_SHARE)
    want = RANK_NOISE * math.sqrt(1 + k / (m_obs - k - 1))
    rows = 4 * n * (2 * p + k)          # X and the mask read, A written
    bounds = {
        "step_A": _bound_ms(rows + 4 * k * p,
                            2 * n * p * k * k + 2 * n * p * k
                            + n * (2 * k ** 3 // 3 + 2 * k * k)),
        "step_B": _bound_ms(rows + 4 * k * p,
                            2 * n * p * k * k + 2 * n * p * k),
        "objective": _bound_ms(rows, 2 * n * p * k + 4 * n * p),
    }
    say(f"glrm (w): {n} rows x {p} columns, {NA_SHARE:.0%} NA, k {k}: "
        f"train() {t:.3f} s, {len(obj)} iterations; {peak}; objective "
        f"{obj[0]:.6g} -> {obj[-1]:.6g}; reconstruct() RMSE on the "
        f"{int(na.sum())} held-out entries {rmse:.6f} (what the noise "
        f"leaves: {want:.6f}); stage table, ms a call (bound, by): "
        + ", ".join(f"{name} {1e3 * w.seconds / max(w.calls, 1):.3f} "
                    f"x {w.calls} ({bounds[name][0]:.3f}, "
                    f"{bounds[name][1]})" for name, w in watches.items()))
    check(all(b <= a * (1 + 1e-6) for a, b in zip(obj, obj[1:])),
          f"glrm (w): the objective rose: {obj}")
    check(abs(rmse - want) < 0.05 * want,
          f"glrm (w): held-out RMSE {rmse} vs {want}")
    # its program at one bucket for the capture cross-check (bi)
    KEPT_GLRM["w"] = (m, _sub_frame(fr, CAPTURE_ROWS))


def phase_dl_unsupervised(torch, h2o, HC):
    """Runs (q)-(w) at full width."""
    t0 = time.perf_counter()
    _glm_tf32(torch)
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    dl_higgs_run(torch, h2o, HC, fr, valid)
    del fr, valid
    dl_covtype_run(torch, h2o, HC)
    dl_autoencoder_run(torch, h2o, HC)
    kmeans_blob_run(torch, h2o, HC)
    full, holed, X, L, na = _rank_frame(torch, dev, HIGGS_N, 13)
    pca_run(torch, h2o, HC, full, X, L)
    svd_run(torch, h2o, HC, full, X)
    del full
    glrm_run(torch, h2o, HC, holed, X, na)
    say(f"deeplearning and unsupervised runs (q)-(w): "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Runs (x)-(ad): the model framework and the standalone models. Grid
# search, the stacked ensemble and segments train binned GBMs, so they
# launch the kernels of ops/csrc; Naive Bayes, CoxPH, PSVM and the
# quantiles are plain PyTorch (the JAX package computes them in XLA
# without a Pallas call), and none may count a launch.
def _kernel_launches(HC):
    return {k: v for k, v in HC.LAUNCHES.items() if v}


def grid_run(torch, h2o, HC, fr, valid):
    """Run (x): a Cartesian GBM grid on the HIGGS frame, each model against
    the same parameters trained alone, the same grid from two threads, and
    a RandomDiscrete walk against the CPU's numpy draws."""
    from h2o3_tpu_torch.models import grid as G
    base = dict(GRID_GBM)
    torch.cuda.synchronize()
    HC.reset_launches()
    t0 = time.perf_counter()
    g = h2o.H2OGridSearch(h2o.H2OGradientBoostingEstimator, GRID_HYPER,
                          grid_id="grid_x")
    g.train(y="y", training_frame=fr, validation_frame=valid, **base)
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    launches = _kernel_launches(HC)
    check(not g.failures and len(g) == 4, f"grid (x): {len(g)} models, "
          f"failures {g.failures}")
    models = {m.key: m for m in g.models}
    ranked = g.get_grid("auc")
    vaucs = [m.auc(valid=True) for m in ranked]
    check(vaucs == sorted(vaucs, reverse=True),
          f"grid (x): get_grid('auc') not sorted: {vaucs}")
    secs = []
    for key in sorted(models):
        m = models[key]
        combo = {k: m.params[k] for k in GRID_HYPER}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = h2o.H2OGradientBoostingEstimator(**base, **combo)
        alone.train(y="y", training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        say(f"grid (x) {key} {combo}: validation AUC {m.auc(valid=True)!r}"
            f" (trained alone {alone.auc(valid=True)!r}, {secs[-1]:.3f} s)")
        check(m.auc(valid=True) == alone.auc(valid=True),
              f"grid (x) {key}: validation AUC {m.auc(valid=True)} vs "
              f"{alone.auc(valid=True)} trained alone")
        del alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g2 = h2o.H2OGridSearch(h2o.H2OGradientBoostingEstimator, GRID_HYPER,
                           grid_id="grid_x2", parallelism=2)
    g2.train(y="y", training_frame=fr, validation_frame=valid, **base)
    torch.cuda.synchronize()
    t_par = time.perf_counter() - t0
    par = {m.key.replace("grid_x2", "grid_x"): m.auc(valid=True)
           for m in g2.models}
    check(par == {k: m.auc(valid=True) for k, m in models.items()},
          f"grid (x): parallelism 2 gave {par}")
    crit = {"strategy": "RandomDiscrete", "max_models": 2, "seed": 42}
    cpu = _on_cpu(h2o, lambda: G.H2OGridSearch(
        h2o.H2OGradientBoostingEstimator, GRID_HYPER,
        search_criteria=crit)._combos())
    rd = h2o.H2OGridSearch(h2o.H2OGradientBoostingEstimator, GRID_HYPER,
                           grid_id="grid_xr", search_criteria=crit)
    rd.train(y="y", training_frame=fr, validation_frame=valid, **base)
    picked = [{k: m.params[k] for k in GRID_HYPER}
              for m in sorted(rd.models, key=lambda m: m.key)]
    check(picked == cpu, f"grid (x): RandomDiscrete picked {picked}, the "
          f"CPU's walk {cpu}")
    alone = ", ".join(f"{s:.3f}" for s in secs)
    say(f"grid (x): GBM {base['ntrees']} trees, {GRID_HYPER} on {fr.nrows} "
        f"rows x {len(fr.names) - 1} features: grid {t_grid:.3f} s "
        f"({t_grid / 4:.3f} s a model; each alone {alone} s), parallelism "
        f"2 {t_par:.3f} s (one walk for every parallelism, models bit "
        f"for bit the same); RandomDiscrete "
        f"max_models 2 seed 42 picked {picked} as the CPU's numpy walk; "
        f"launches over the grid {launches}")
    for name in ("radix", "fused", "route", "hist", "route_f"):
        check(launches.get(name, 0) > 0, f"grid (x): {name} never launched")
    return launches


def ensemble_run(torch, h2o, HC, fr, valid):
    """Run (y): a stacked ensemble of a GBM and a GLM cross-validated on
    the same 5 folds, with the AUTO metalearner."""
    from h2o3_tpu_torch.models import ensemble as EN
    cv = dict(nfolds=5, fold_assignment="Modulo", seed=5,
              keep_cross_validation_predictions=True)
    torch.cuda.synchronize()
    HC.reset_launches()
    t0 = time.perf_counter()
    gbm = h2o.H2OGradientBoostingEstimator(**ENS_GBM, **cv)
    gbm.train(y="y", training_frame=fr, validation_frame=valid)
    torch.cuda.synchronize()
    t_gbm = time.perf_counter() - t0
    t0 = time.perf_counter()
    glm = h2o.H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                            **cv)
    glm.train(y="y", training_frame=fr, validation_frame=valid)
    torch.cuda.synchronize()
    t_glm = time.perf_counter() - t0
    meta, restore = _watch(h2o.H2OGeneralizedLinearEstimator, "train",
                           torch)
    fit, restore2 = _watch(EN.H2OStackedEnsembleEstimator, "_fit", torch)
    try:
        t0 = time.perf_counter()
        se = h2o.H2OStackedEnsembleEstimator(base_models=[gbm, glm])
        se.train(y="y", training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        t_se = time.perf_counter() - t0
    finally:
        restore()
        restore2()
    launches = _kernel_launches(HC)
    beta = se._meta._state.beta
    coefs = dict(zip(se._meta._dinfo.feature_names + ["Intercept"],
                     np.round(beta, 6).tolist()))
    best = max(gbm.auc(valid=True), glm.auc(valid=True))
    say(f"ensemble (y): GBM depth {ENS_GBM['max_depth']} "
        f"{ENS_GBM['ntrees']} trees 5-fold CV {t_gbm:.3f} s, GLM 5-fold CV "
        f"{t_glm:.3f} s; the ensemble's train() {t_se:.3f} s: level-one "
        f"set-up {fit.seconds - meta.seconds:.3f} s, the metalearner's "
        f"train() {meta.seconds:.3f} s, the ensemble's training and "
        f"validation scoring {t_se - fit.seconds:.3f} s; validation AUC GBM "
        f"{gbm.auc(valid=True):.6f}, GLM {glm.auc(valid=True):.6f}, "
        f"ensemble {se.auc(valid=True):.6f}; metalearner coefficients "
        f"{coefs}; launches {launches}")
    check(se.auc(valid=True) >= best - 0.001,
          f"ensemble (y): validation AUC {se.auc(valid=True)} below the best "
          f"base model's {best} - 0.001")
    check((beta[:-1] >= 0).all(), f"ensemble (y): metalearner {beta}")
    check(launches.get("fused", 0) > 0, "ensemble (y): no kernel launched")
    return launches


def segments_run(torch, h2o, HC, fr):
    """Run (z): one multinomial GBM a wilderness area of (m)'s frame, each
    against the same GBM trained alone on its subframe."""
    from h2o3_tpu_torch.models import model as MB
    torch.cuda.synchronize()
    HC.reset_launches()
    t0 = time.perf_counter()
    res = h2o.train_segments(h2o.H2OGradientBoostingEstimator, SEG_GBM,
                             "wilderness", y="y", training_frame=fr)
    torch.cuda.synchronize()
    t_seg = time.perf_counter() - t0
    launches = _kernel_launches(HC)
    rows = res.as_list()
    wild = fr.vec("wilderness").as_f32()
    for r in rows:
        check(r["status"] == "SUCCEEDED", f"segments (z): {r}")
        m = h2o.get_model(r["model"])
        code = fr.vec("wilderness").levels().index(r["segment"]["wilderness"])
        sub = MB._subframe(fr, torch.nonzero(wild == code)[:, 0])
        alone = h2o.H2OGradientBoostingEstimator(**SEG_GBM)
        alone.train(y="y", training_frame=sub)
        say(f"segments (z) {r['segment']}: {r['status']}, {r['nrows']} rows, "
            f"training logloss {m.logloss()!r} (alone {alone.logloss()!r})")
        check(m.logloss() == alone.logloss(), f"segments (z) {r['segment']}"
              f": logloss {m.logloss()} vs {alone.logloss()} alone")
        h2o.remove(sub.key)
    total = sum(r["nrows"] for r in rows)
    say(f"segments (z): {len(rows)} segments of a multinomial GBM depth "
        f"{SEG_GBM['max_depth']}, {SEG_GBM['ntrees']} iterations: "
        f"{t_seg:.3f} s; rows {total}; launches {launches}")
    check(len(rows) == COV_WILD and total == fr.nrows,
          f"segments (z): {len(rows)} segments, {total} rows")
    check(launches.get("fused", 0) > 0, "segments (z): no kernel launched")
    return launches


def naive_bayes_runs(torch, h2o, HC, fr, cov, entropy):
    """Run (aa): Naive Bayes binomial at HIGGS width and multinomial at
    Covertype width, and a slice card vs CPU."""
    m, t, peak = timed_train(torch, HC, "naive bayes (aa)",
                             lambda: h2o.H2ONaiveBayesEstimator(),
                             y="y", training_frame=fr)
    say(f"naive bayes (aa): binomial on {fr.nrows} rows x "
        f"{len(fr.names) - 1} features: train() {t:.3f} s, {peak}; train "
        f"AUC {m.auc():.6f} (bar {NB_AUC_BAR}; a CPU run of the generator "
        f"at 1M rows: {NB_AUC_CPU})")
    check(m.auc() > NB_AUC_BAR, f"naive bayes (aa): AUC {m.auc()}")
    c, t, peak = timed_train(torch, HC, "naive bayes (aa)",
                             lambda: h2o.H2ONaiveBayesEstimator(laplace=1),
                             y="y", training_frame=cov)
    say(f"naive bayes (aa): multinomial on {cov.nrows} rows (two "
        f"categoricals, 7 classes), laplace 1: train() {t:.3f} s, {peak}; "
        f"training logloss {c.logloss():.6f} (class prior entropy "
        f"{entropy:.6f})")
    check(c.logloss() < entropy, f"naive bayes (aa): logloss {c.logloss()}")
    sl = _sub_frame(fr, NB_SLICE_N)
    card = h2o.H2ONaiveBayesEstimator().train(y="y", training_frame=sl)
    pc = card.predict(sl).vecs[-1].as_f32().cpu().numpy()

    def cpu_fit():
        f = _cpu_frame(sl)
        m = h2o.H2ONaiveBayesEstimator().train(y="y", training_frame=f)
        return m.predict(f).vecs[-1].as_f32().numpy()
    pp = _on_cpu(h2o, cpu_fit)
    d = float(np.abs(pc - pp).max())
    say(f"naive bayes (aa): {NB_SLICE_N}-row slice card vs CPU: "
        f"probabilities max diff {d:.3g} (limit 1e-5)")
    check(d < 1e-5, f"naive bayes (aa): card vs CPU {d}")


def _survival_frame(torch, dev, n, seed):
    """A planted survival frame made on the card: COX_P N(0,1) covariates,
    a COX_STRATA-level stratum with its own baseline (median 400-1000
    days), exponential event times with hazard exp(x·COX_BETA), exponential
    censoring at 0.45 of the stratum's baseline rate (about 30%
    censored), the observed time rounded up to whole days."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((n, COX_P), generator=g, device=dev)
    s = torch.randint(0, COX_STRATA, (n,), generator=g, device=dev)
    lam = math.log(2) / torch.tensor([400.0, 600.0, 800.0, 1000.0],
                                     device=dev)[s]
    rate = lam * torch.exp(X @ torch.tensor(COX_BETA, device=dev))

    def draw(r):
        u = torch.rand(n, generator=g, device=dev).clamp(min=1e-12)
        return -torch.log(u) / r
    T, C = draw(rate), draw(0.45 * lam)
    t = torch.ceil(torch.minimum(T, C))
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(COX_P)]
    vecs += [Vec.from_tensor(s.float(), type=T_CAT,
                             domain=[f"s{i}" for i in range(COX_STRATA)]),
             Vec.from_tensor(t), Vec.from_tensor((T <= C).float())]
    return Frame([f"z{j}" for j in range(COX_P)]
                 + ["stratum", "time", "event"], vecs)


def _numpy_efron_loglik(X, t, ev, strat, beta):
    """The Efron partial log-likelihood with strata, float64 numpy, from
    host arrays."""
    order = np.lexsort((-t, strat))
    X, t, ev, strat = X[order], t[order], ev[order], strat[order]
    n = len(t)
    eta = X @ beta
    r = np.exp(eta)
    new_g = np.r_[True, (strat[1:] != strat[:-1]) | (t[1:] != t[:-1])]
    gid = np.cumsum(new_g) - 1
    last = np.r_[np.flatnonzero(new_g)[1:], n] - 1
    new_s = np.r_[True, strat[1:] != strat[:-1]]
    sid = np.cumsum(new_s) - 1
    first = np.flatnonzero(new_s)
    csum = np.cumsum(r)
    before = np.where(first > 0, csum[np.maximum(first - 1, 0)], 0.0)
    risk = csum[last][gid] - before[sid]
    e = ev > 0
    tie = np.bincount(gid, weights=r * e)[gid]
    d = np.maximum(np.bincount(gid, weights=e.astype(float)), 1.0)[gid]
    ecum = np.cumsum(e)
    starts = np.flatnonzero(new_g)
    prior = np.where(starts > 0, ecum[np.maximum(starts - 1, 0)], 0)[gid]
    rank = ecum - 1 - prior
    denom = risk - rank / d * tie
    return float((eta * e).sum() - np.log(denom[e]).sum())


def coxph_run(torch, h2o, HC):
    """Run (ab): CoxPH with Efron ties and strata on a planted survival
    frame of 1M rows."""
    from h2o3_tpu_torch.models import coxph as CX
    dev = h2o.init().device
    fr = _survival_frame(torch, dev, COX_N, 14)
    x = [f"z{j}" for j in range(COX_P)]
    m, t, peak = timed_train(
        torch, HC, "coxph (ab)",
        lambda: h2o.H2OCoxProportionalHazardsEstimator(
            stop_column="time", stratify_by="stratum", ties="efron",
            standardize=False),
        x=x, y="event", training_frame=fr)
    s = m._output.model_summary
    ev, tt = fr.vec("event").to_numpy(), fr.vec("time").to_numpy()
    st = fr.vec("stratum").to_numpy().astype(np.int64)
    ll = _numpy_efron_loglik(fr.to_numpy(x), tt, ev, st, m._beta)
    rel = abs(ll - s["loglik"]) / abs(ll)
    z = (m._beta - np.asarray(COX_BETA)) / m._se
    # one Newton iteration as train() takes it: the value, the gradient,
    # the Hessian (autograd's p backward passes) and the value at the new
    # point, over the rows in (stratum, -time) order
    order = np.lexsort((-tt, st))
    f = CX._nll_fn(fr.matrix(x).index_select(
        0, torch.from_numpy(order).to(dev)), tt[order], ev[order],
        np.ones(len(ev)), st[order], "efron")
    b32 = torch.tensor(m._beta, dtype=torch.float32, device=dev)

    def newton_iter():
        b = b32.clone().requires_grad_(True)
        torch.autograd.grad(f(b), b)
        torch.autograd.functional.hessian(f, b32)
        with torch.no_grad():
            f(b32)
    it_ms = time_ms(torch, newton_iter, 1)
    n = COX_N
    # bytes: the f32 covariates once and eight 8-byte row vectors (the
    # group, end, stratum and Efron indices and weights); operations: XᵀDX
    # and the gradient's and η's products (at the f32 peak; the float64
    # peak halves it, and the bytes still bound)
    b_ms, by = _bound_ms(n * (4 * COX_P + 64), 2 * n * COX_P * (COX_P + 2))
    say(f"coxph (ab): {n} rows x {COX_P} covariates, {COX_STRATA} strata, "
        f"Efron ties ({len(np.unique(fr.vec('time').to_numpy()))} distinct "
        f"days), {1 - ev.mean():.3f} censored: train() {t:.3f} s, {peak}; "
        f"{s['iterations']} Newton iterations; a Newton iteration "
        f"{it_ms:.3f} ms (bound {b_ms:.4f} ms, by {by}); loglik "
        f"{s['loglik']!r} vs float64 numpy {ll!r} (rel {rel:.3g}); beta "
        f"{np.round(m._beta, 5).tolist()}, |beta - planted| / SE "
        f"{np.round(np.abs(z), 3).tolist()}; concordance "
        f"{s['concordance']:.6f}; launches {_kernel_launches(HC)}")
    check(np.abs(z).max() < 4, f"coxph (ab): beta off its plant by {z} SE")
    check(rel < 1e-6, f"coxph (ab): loglik {s['loglik']} vs {ll}")
    check(s["concordance"] > 0.5, f"coxph (ab): concordance "
          f"{s['concordance']}")
    check(not _kernel_launches(HC), "coxph (ab): a kernel launched")


def psvm_run(torch, h2o, HC, fr):
    """Run (ac): PSVM at its defaults on the HIGGS frame, and a slice card
    vs CPU."""
    from h2o3_tpu_torch.models import _lbfgs as LB
    ls, restore = _watch(LB.ZoomLBFGS, "step", torch)
    fit, restore2 = _watch(h2o.H2OSupportVectorMachineEstimator, "_fit",
                           torch)
    try:
        m, t, peak = timed_train(
            torch, HC, "psvm (ac)",
            lambda: h2o.H2OSupportVectorMachineEstimator(seed=1),
            y="y", training_frame=fr)
    finally:
        restore()
        restore2()
    s = m._output.model_summary
    its, lse = s["iterations"], s["linesearch_evaluations"]
    say(f"psvm (ac): gaussian kernel, {m._beta.numel()} Fourier features, "
        f"C 1, on {fr.nrows} rows x {len(fr.names) - 1} features: train() "
        f"{t:.3f} s, {peak}; the fit {fit.seconds:.3f} s over {its} "
        f"iterations ({1000 * fit.seconds / max(its, 1):.3f} ms an "
        f"iteration, the feature map's build included); the L-BFGS steps "
        f"{1000 * ls.seconds:.3f} ms over {lse} line-search evaluations "
        f"({1000 * ls.seconds / max(lse, 1):.3f} ms an evaluation with the "
        f"step's direction); final objective {s['final_objective']!r}; train "
        f"AUC {m.auc():.6f} (bar {PSVM_AUC_BAR:.6f}; the CPU on this frame: "
        f"{PSVM_AUC_CPU}, stalled after one step {PSVM_AUC_STALLED}); "
        f"launches {_kernel_launches(HC)}")
    check(m.auc() > PSVM_AUC_BAR, f"psvm (ac): AUC {m.auc()}")
    check(not _kernel_launches(HC), "psvm (ac): a kernel launched")
    ratio = _psvm_grad_ratio(torch, m, fr)
    del m
    stalled = h2o.H2OSupportVectorMachineEstimator(
        seed=1, max_iterations=1).train(y="y", training_frame=fr)
    s_ratio = _psvm_grad_ratio(torch, stalled, fr)
    say(f"psvm (ac): float64 gradient at the fit / at zero {ratio:.3e} "
        f"(limit {PSVM_GRAD_RATIO}); a fit stalled at its first step: "
        f"{s_ratio:.3e}, train AUC {stalled.auc():.6f}")
    check(ratio < PSVM_GRAD_RATIO, f"psvm (ac): gradient ratio {ratio}")
    check(s_ratio > PSVM_GRAD_RATIO and stalled.auc() < PSVM_AUC_BAR,
          f"psvm (ac): a fit of one step passes the checks ({s_ratio}, AUC "
          f"{stalled.auc()})")
    del stalled
    sl = _sub_frame(fr, PSVM_SLICE_N)
    card = h2o.H2OSupportVectorMachineEstimator(seed=1).train(
        y="y", training_frame=sl)
    oc = card._output.model_summary["final_objective"]
    oh = _on_cpu(h2o, lambda: h2o.H2OSupportVectorMachineEstimator(
        seed=1).train(y="y", training_frame=_cpu_frame(sl))
        ._output.model_summary["final_objective"])
    rel = abs(oc - oh) / abs(oh)
    say(f"psvm (ac): {PSVM_SLICE_N}-row slice card vs CPU: final objective "
        f"{oc!r} vs {oh!r} (rel {rel:.3g}, limit 1e-5)")
    check(rel < 1e-5, f"psvm (ac): card vs CPU objective {oc} vs {oh}")


def _psvm_grad_ratio(torch, m, fr, block=1 << 20):
    """The norm of the PSVM objective's gradient at the model's (beta, b0)
    over its norm at zero, in float64 and in row blocks, with the
    squared hinge's gradient written out by hand (psvm.py takes autograd's
    of its f32 loss) and the model's Fourier features W and b."""
    di = m._dinfo
    X = torch.nan_to_num(di.matrix(fr))
    y = di.response(fr)
    ys = torch.where(y > 0.5, 1.0, -1.0).double()
    w = torch.where(torch.isnan(y), 0.0, di.weights(fr)).double() \
        * torch.where(ys > 0, float(m.params["positive_weight"]),
                      float(m.params["negative_weight"]))
    W, b = (t.double() for t in m._rff)
    scale = float(m.params["hyper_param"]) / max(float(w.sum()), 1.0)

    def norm(beta, b0):
        g, g0 = beta.clone(), 0.0
        for s in range(0, X.shape[0], block):
            Z = torch.cos(X[s:s + block].double() @ W + b) \
                * math.sqrt(2.0 / W.shape[1])
            ysb = ys[s:s + block]
            h = torch.clamp(1.0 - ysb * (Z @ beta + b0), min=0.0)
            r = -2.0 * scale * w[s:s + block] * ysb * h
            g += Z.T @ r
            g0 += float(r.sum())
        return math.sqrt(float(g @ g) + g0 * g0)

    zero = torch.zeros(W.shape[1], dtype=torch.float64, device=X.device)
    return norm(m._beta.double(), float(m._b0)) / norm(zero, 0.0)


def psvm_cpu_reference(torch, h2o):
    """`--psvm-cpu-reference`: run (ac)'s PSVM fits on the host's CPU at
    the card's size and width, on (ac)'s HIGGS frame (the same generator
    on the card, seed 7) copied to the host: its AUC, iterations, final
    objective and gradient ratio, and those of a fit stalled at its first
    step."""
    fr = _cpu_frame(_higgs_frame(torch, h2o, h2o.init().device, HIGGS_N, 7))
    torch.cuda.empty_cache()

    def fits():
        for cap in (200, 1):
            t0 = time.perf_counter()
            m = h2o.H2OSupportVectorMachineEstimator(
                seed=1, max_iterations=cap).train(y="y", training_frame=fr)
            t = time.perf_counter() - t0
            s = m._output.model_summary
            say(f"psvm (ac) on the CPU, {fr.nrows} rows x "
                f"{len(fr.names) - 1} features, max_iterations {cap}: "
                f"train AUC {m.auc()!r}, {s['iterations']} iterations, "
                f"final objective {s['final_objective']!r}, float64 "
                f"gradient at the fit / at zero "
                f"{_psvm_grad_ratio(torch, m, fr):.3e}; train() {t:.1f} s "
                f"on {torch.get_num_threads()} threads")
    _on_cpu(h2o, fits)


def _order_stat_reference(torch, x, w, probs):
    """Each quantile from the exact order statistics: the f32 values
    sorted on the card, the weights' cumulative sum in float64, Type 7 on
    h = p·(W−1) in float64 numpy."""
    ok = ~torch.isnan(x)
    xs, order = torch.sort(x[ok])
    cw = torch.cumsum(w[ok][order].double(), 0)
    h = np.asarray(probs) * (float(cw[-1]) - 1.0)
    ks = torch.tensor(np.concatenate([np.floor(h), np.ceil(h)]),
                      dtype=torch.float64, device=x.device)
    vals = xs[torch.searchsorted(cw, ks, right=True)].double().cpu().numpy()
    lo, hi = vals[:len(h)], vals[len(h):]
    return lo, hi, lo + (h - np.floor(h)) * (hi - lo)


def quantiles_run(torch, h2o, HC, fr):
    """Run (ad): the quantiles of the HIGGS frame's 28 columns at H2O's
    default probabilities, unweighted and with integer weights 1-3."""
    from h2o3_tpu_torch.models import quantile as Q
    g = torch.Generator(device=fr.vecs[0].device)
    g.manual_seed(15)
    wts = torch.randint(1, 4, (fr.nrows,), generator=g,
                        device=fr.vecs[0].device).float()
    probs = list(Q.DEFAULT_PROBS)
    cols = [c for c in fr.names if c != "y"]
    worst = {}
    HC.reset_launches()
    for label, w in (("unweighted", None), ("weighted", wts)):
        ms, err_exact, err_ulp = [], 0, 0.0
        for c in cols:
            x = fr.vec(c).as_f32()
            lo, hi, want = _order_stat_reference(
                torch, x, torch.ones_like(x) if w is None else w, probs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = Q.quantile(x, probs, weights=w)
            ms.append(1000 * (time.perf_counter() - t0))
            # the exact ranks themselves: the order statistics at
            # floor(h) and ceil(h)
            h = np.asarray(probs) * (float(
                (torch.ones_like(x) if w is None else w).double().sum())
                - 1.0)
            ranks = Q._order_stats(
                x, torch.ones_like(x) if w is None else w,
                np.concatenate([np.floor(h), np.ceil(h)])).cpu().numpy()
            err_exact += int((ranks != np.concatenate([lo, hi])).sum())
            ulp = np.spacing(np.abs(want).astype(np.float32))
            err_ulp = max(err_ulp, float((np.abs(got - want) / ulp).max()))
        worst[label] = (err_exact, err_ulp)
        b_ms, by = _bound_ms(4 * 4 * fr.nrows * (1 if w is None else 2), 0)
        say(f"quantiles (ad) {label}: {len(cols)} columns x {fr.nrows} rows "
            f"at {len(probs)} probabilities: {np.mean(ms):.3f} ms a column "
            f"(bound {b_ms:.4f} ms, by {by}: 4 reads of the column"
            f"{'' if w is None else ' and its weights'}); exact ranks "
            f"differing from the sorted order statistics {err_exact}, "
            f"interpolated values within {err_ulp:.3g} f32 ulp")
        check(err_exact == 0 and err_ulp <= 1.0,
              f"quantiles (ad) {label}: {err_exact} ranks differ, "
              f"{err_ulp} ulp")
    check(not _kernel_launches(HC), "quantiles (ad): a kernel launched")


def phase_framework(torch, h2o, HC):
    """Runs (x)-(ad) at full width, each timed."""
    t_all = time.perf_counter()
    _glm_tf32(torch)
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    launches = {}
    times = {}
    for label, fn in (("x", lambda: grid_run(torch, h2o, HC, fr, valid)),
                      ("y", lambda: ensemble_run(torch, h2o, HC, fr,
                                                 valid))):
        t0 = time.perf_counter()
        launches[label] = fn()
        times[label] = time.perf_counter() - t0
    del valid
    base, y = _covtype_frame(torch, dev, COV_N, 9)
    cov = _covtype_categorical(torch, base)
    prior = torch.bincount(y, minlength=len(COV_PRIOR)).double() / COV_N
    entropy = float(-(prior * prior.clamp(min=1e-300).log()).sum())
    del base, y
    for label, fn in (
            ("z", lambda: segments_run(torch, h2o, HC, cov)),
            ("aa", lambda: naive_bayes_runs(torch, h2o, HC, fr, cov,
                                            entropy)),
            ("ab", lambda: coxph_run(torch, h2o, HC)),
            ("ac", lambda: psvm_run(torch, h2o, HC, fr)),
            ("ad", lambda: quantiles_run(torch, h2o, HC, fr))):
        t0 = time.perf_counter()
        out = fn()
        if out is not None:
            launches[label] = out
        times[label] = time.perf_counter() - t0
    say("framework and standalone runs (x)-(ad): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in times.items())
        + f"; total {time.perf_counter() - t_all:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Runs (ae)-(ak): the models built on ported estimators. The aggregator,
# the extended isolation forest, GAM, target encoding and Word2Vec are
# plain PyTorch (no kernel of ops/csrc on their paths); RuleFit and the
# infogram train binned GBMs, so they launch the binned kernels.
def _rows_nearest_earlier(torch, X, ex, block=4096):
    """Each row's nearest exemplar among those of earlier rows (ties to
    the earliest), in the direct form, row block by row block: the
    exemplar index, and the squared distance (inf for row 0)."""
    from h2o3_tpu_torch.models import aggregator as A
    n = X.shape[0]
    E = X[ex]
    own = torch.empty(n, dtype=torch.int64, device=X.device)
    best = torch.empty(n, dtype=torch.float32, device=X.device)
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(n, r0 + block), device=X.device)
        d = A._sqdist(X[rows], E)
        d = torch.where(ex[None, :] < rows[:, None], d, math.inf)
        best[rows], own[rows] = torch.min(d, dim=1)
    return own, best


def aggregator_run(torch, h2o, HC, fr, vcols):
    """Run (ae): the aggregator at H2O's defaults on (j)'s credit-card
    frame; the leader-set invariants over all rows in the direct distance
    form; the plain row-by-row walk on the first AGG_PLAIN_N rows."""
    from h2o3_tpu_torch.models import aggregator as A
    m, t, peak = timed_train(torch, HC, "aggregator (ae)",
                             lambda: h2o.H2OAggregatorEstimator(**AGG),
                             x=vcols, training_frame=fr)
    ex, counts = m._exemplar_rows, m._counts
    k, radius = ex.shape[0], m.summary()["radius"]
    n, target = fr.nrows, AGG["target_num_exemplars"]
    tol = AGG["rel_tol_num_exemplars"] * target
    sweeps = m._sweep_seconds
    say(f"aggregator (ae): {n} rows x {len(vcols)} columns, target "
        f"{target} exemplars: {k} exemplars at radius {radius:.6f} after "
        f"{len(sweeps)} sweeps ({', '.join(f'{s:.3f}' for s in sweeps)} s); "
        f"train() {t:.3f} s, {peak}")
    check(abs(k - target) <= tol or k == n,
          f"aggregator (ae): {k} exemplars outside {target} +- {tol}")
    X = m._normalized(fr)
    r2 = radius * radius
    t0 = time.perf_counter()
    E = X[ex]
    dd = A._sqdist(E, E)
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=X.device).tril(-1)
    closest = float(torch.where(earlier, dd, math.inf).min())
    own, best = _rows_nearest_earlier(torch, X, ex)
    is_ex = torch.zeros(n, dtype=torch.bool, device=X.device)
    is_ex[ex] = True
    own[ex] = torch.arange(k, device=X.device)
    want = torch.bincount(own, minlength=k)
    covered = bool((best[~is_ex] <= r2).all())
    t_inv = time.perf_counter() - t0
    say(f"aggregator (ae) invariants over all {n} rows (direct form, "
        f"{t_inv:.3f} s): the closest pair of exemplars {closest:.6f} "
        f"(r^2 {r2:.6f}); every other row within r^2 of an earlier "
        f"exemplar: {covered}; counts equal to each row's nearest earlier "
        f"exemplar: {torch.equal(want, counts)}; counts sum "
        f"{int(counts.sum())}")
    check(closest > r2 and covered and torch.equal(want, counts)
          and int(counts.sum()) == n, "aggregator (ae): leader-set "
          "invariants fail")
    Xs = X[:AGG_PLAIN_N]
    t0 = time.perf_counter()
    bex, bcnt = A._sweep(Xs, radius)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    pex, pcnt = A._sweep_plain(Xs.cpu(), radius)
    t_p = time.perf_counter() - t0
    same = torch.equal(bex.cpu(), pex) and torch.equal(bcnt.cpu(), pcnt)
    say(f"aggregator (ae): the first {AGG_PLAIN_N} rows at the same radius: "
        f"{pex.shape[0]} exemplars; batched on the card {t_b:.3f} s, the "
        f"plain row-by-row walk on the CPU {t_p:.3f} s; the same exemplars "
        f"and counts: {same}")
    check(same, "aggregator (ae): batched and plain sweeps differ")


def eif_run(torch, h2o, HC, fr, y, vcols):
    """Run (af): the extended isolation forest at H2O's defaults on (j)'s
    frame, at extension_level 0 and C - 1; a slice card vs CPU with the
    CPU generator's draws."""
    from h2o3_tpu_torch.models import extended_isofor as EIF
    from h2o3_tpu_torch.models.tree import engine as E
    for ext in (0, len(vcols) - 1):
        m, t, peak = timed_train(
            torch, HC, "extended isolation forest (af)",
            lambda: h2o.H2OExtendedIsolationForestEstimator(
                **EIF_PARAMS, extension_level=ext),
            x=vcols, training_frame=fr)
        t0 = time.perf_counter()
        auc = iso_auc(torch, m, fr, y)
        t_pred = time.perf_counter() - t0
        bar = EIF_AUC_BAR[ext]
        say(f"extended isolation forest (af): extension_level {ext}, "
            f"{EIF_PARAMS['ntrees']} trees of depth {m._D}: train() "
            f"{t:.3f} s, {peak}; score AUC {auc:.6f} (bar {bar}; a CPU run "
            f"of the same generator: {EIF_AUC_CPU[ext]}); predict "
            f"{t_pred:.3f} s")
        check(auc > bar, f"extended isolation forest (af): AUC {auc}")
    sl = _sub_frame(fr, EIF_SLICE_N)
    saved = EIF.H2OExtendedIsolationForestEstimator._draws
    lengths = {}
    try:
        EIF.H2OExtendedIsolationForestEstimator._draws = (
            lambda self, device: E.Draws(torch.Generator().manual_seed(5),
                                         device))
        for where in ("cuda", "cpu"):
            def fit(f):
                m = h2o.H2OExtendedIsolationForestEstimator(
                    **EIF_PARAMS, extension_level=len(vcols) - 1)
                m.train(x=vcols, training_frame=f)
                return m.predict(f).to_numpy()[:, 1]
            lengths[where] = (fit(sl) if where == "cuda"
                              else _on_cpu(h2o, lambda: fit(_cpu_frame(sl))))
    finally:
        EIF.H2OExtendedIsolationForestEstimator._draws = saved
    d = float(np.abs(lengths["cuda"] - lengths["cpu"]).max())
    say(f"extended isolation forest (af): {EIF_SLICE_N}-row slice card vs "
        f"CPU, the same draws: mean lengths max diff {d:.3g} (limit 1e-5)")
    check(d < 1e-5, f"extended isolation forest (af): card vs CPU {d}")


def gam_run(torch, h2o, HC, fr):
    """Run (ag): GAM binomial on the HIGGS frame with the columns of X0,
    X1 and sin(X4) as gam columns, against a plain binomial GLM on the
    same predictors; a slice card vs CPU. Returns the plain GLM's AUC."""
    glm, t_glm, _ = timed_train(
        torch, HC, "gam (ag)",
        lambda: h2o.H2OGeneralizedLinearEstimator(family="binomial",
                                                  lambda_=0.0),
        y="y", training_frame=fr)
    m, t, peak = timed_train(
        torch, HC, "gam (ag)",
        lambda: h2o.H2OGeneralizedAdditiveEstimator(family="binomial",
                                                    gam_columns=GAM_COLS),
        y="y", training_frame=fr)
    it = m._glm._iterations
    say(f"gam (ag): binomial on {fr.nrows} rows, gam columns {GAM_COLS} "
        f"(6 knots each), 25 linear columns: train() {t:.3f} s, {peak}; "
        f"{it} IRLS iterations, {t / max(it, 1):.3f} s an iteration (the "
        f"basis included); training AUC {m.auc():.6f} against the plain "
        f"GLM's {glm.auc():.6f} ({t_glm:.3f} s, {glm._iterations} "
        f"iterations)")
    check(m.auc() > glm.auc(), f"gam (ag): AUC {m.auc()} not above the "
          f"plain GLM's {glm.auc()}")
    sl = _sub_frame(fr, GAM_SLICE_N)

    def fit(f):
        g = h2o.H2OGeneralizedAdditiveEstimator(family="binomial",
                                                gam_columns=GAM_COLS)
        g.train(y="y", training_frame=f)
        return g.coef()
    card = fit(sl)
    cpu = _on_cpu(h2o, lambda: fit(_cpu_frame(sl)))
    d = max(abs(card[k] - cpu[k]) for k in card)
    big = max(abs(v) for v in cpu.values())
    say(f"gam (ag): {GAM_SLICE_N}-row slice card vs CPU: coefficients max "
        f"diff {d:.3g}, the largest coefficient {big:.4g} (limit 1e-4 of "
        f"it)")
    check(d < 1e-4 * max(big, 1.0), f"gam (ag): card vs CPU {d}")
    return glm.auc()


def rulefit_run(torch, h2o, HC, fr, glm_auc):
    """Run (ah): RuleFit at its defaults on the HIGGS frame: rule length
    3, 20 trees, rules and linear terms. Returns its kernel launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m = h2o.H2ORuleFitEstimator(seed=1)
    HC.reset_launches()
    t0 = time.perf_counter()
    m.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = _kernel_launches(HC)
    trees = 20
    per_tree = {k: v / trees for k, v in launches.items()}
    s = m.summary()
    kept = {r["name"]: r["support"] for r in m._rules}
    sel = [r["rule"] for r in m.rule_importance() if r["rule"] in kept]
    sup = [kept[r] for r in sel]
    tm = m._timings
    say(f"rulefit (ah): {fr.nrows} rows, rule length 3, {trees} trees: "
        f"train() {t:.3f} s ({_peak_gib(torch, held)}): GBM "
        f"{tm['gbm']:.3f} s, rule columns {tm['rule columns']:.3f} s, GLM "
        f"path {tm['glm']:.3f} s; {s['rules_generated']} rules generated, "
        f"{s['rules_selected']} terms selected ({len(sel)} rules, support "
        f"{min(sup, default=0):.4f}-{max(sup, default=0):.4f}); training "
        f"AUC {m.auc():.6f} against (ag)'s plain GLM's {glm_auc:.6f}; "
        f"launches per tree {per_tree}; top rules "
        f"{[(r['rule'], round(r['coefficient'], 4)) for r in m.rule_importance()[:4]]}")
    check(s["rules_generated"] > 0 and sel, "rulefit (ah): no rule")
    check(all(0.01 < v < 0.99 for v in sup), "rulefit (ah): support")
    check(m.auc() > glm_auc, f"rulefit (ah): AUC {m.auc()} not above the "
          f"plain GLM's {glm_auc}")
    check(per_tree == RULEFIT_PER_TREE, f"rulefit (ah): launches per tree "
          f"{per_tree}, expected {RULEFIT_PER_TREE}")
    return launches


def _te_frame(torch, dev):
    """(ai)'s click-through frame, made on the card: TE_LEVELS-level
    categoricals drawn Zipf(TE_ZIPF), a binary response whose logit adds
    a per-level N(0, TE_SD^2) effect of each, and a TE_FOLDS-fold column."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    names, vecs = [], []
    logit = torch.full((TE_N,), -1.5, device=dev)
    for j, L in enumerate(TE_LEVELS):
        p = torch.arange(1, L + 1, device=dev, dtype=torch.float64) \
            ** -TE_ZIPF
        cdf = torch.cumsum(p / p.sum(), 0)
        u = torch.rand(TE_N, generator=g, device=dev, dtype=torch.float64)
        code = torch.searchsorted(cdf, u).clamp(max=L - 1)
        eff = torch.randn(L, generator=g, device=dev) * TE_SD
        logit += eff[code]
        names.append(f"c{j}")
        vecs.append(Vec.from_tensor(code.float(), type=T_CAT,
                                    domain=[f"l{i}" for i in range(L)]))
    y = (torch.rand(TE_N, generator=g, device=dev)
         < torch.sigmoid(logit)).float()
    fold = torch.randint(0, TE_FOLDS, (TE_N,), generator=g, device=dev)
    names += ["y", "fold"]
    vecs += [Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]),
             Vec.from_tensor(fold.float())]
    return Frame(names, vecs)


def _te_numpy(codes, y, folds, L, prior, mode, k=10.0, f=20.0):
    """The target encoding of one column in float64 numpy on the host,
    from bincounts: the reference's formulas."""
    s = np.bincount(codes, weights=y, minlength=L)
    n = np.bincount(codes, minlength=L).astype(np.float64)
    s, n = s[codes], n[codes]
    if mode == "loo":
        s, n = s - y, n - 1
    elif mode == "kfold":
        key = folds * L + codes
        size = TE_FOLDS * L
        s = s - np.bincount(key, weights=y, minlength=size)[key]
        n = n - np.bincount(key, minlength=size)[key]
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = 1.0 / (1.0 + np.exp(-(n - k) / f))
        out = lam * (s / n) + (1 - lam) * prior
    return np.where(n > 0, out, prior)


def target_encoding_run(torch, h2o, HC):
    """Run (ai): target encoding of three high-cardinality categoricals on
    a planted click-through frame, modes none, loo and kfold with
    blending, against a float64 numpy version on the host."""
    dev = h2o.init().device
    fr = _te_frame(torch, dev)
    y = fr.vec("y").as_f32().double().cpu().numpy()
    folds = fr.vec("fold").as_f32().long().cpu().numpy()
    codes = {c: fr.vec(c).as_f32().long().cpu().numpy() for c in
             ("c0", "c1", "c2")}
    cols = list(codes)
    for mode in ("none", "loo", "kfold"):
        te, t, peak = timed_train(
            torch, HC, "target encoding (ai)",
            lambda: h2o.H2OTargetEncoderEstimator(
                data_leakage_handling=mode, blending=True,
                fold_column="fold", columns_to_encode=cols),
            y="y", training_frame=fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = te.transform(fr, as_training=True)
        torch.cuda.synchronize()
        t_tr = time.perf_counter() - t0
        worst = 0.0
        for c, L in zip(cols, TE_LEVELS):
            got = out.vec(f"{c}_te").as_f32().double().cpu().numpy()
            want = _te_numpy(codes[c], y, folds, L, float(y.mean()), mode)
            worst = max(worst, float((np.abs(got - want)
                                      / np.abs(want)).max()))
        seen = [int(np.unique(codes[c]).size) for c in cols]
        say(f"target encoding (ai) {mode}: {TE_N} rows, levels "
            f"{list(TE_LEVELS)} ({seen} seen), blending: train() {t:.3f} s, "
            f"{peak}; transform {t_tr:.3f} s; encoded columns within "
            f"{worst:.3g} relative of the float64 numpy bincount version "
            f"(limit 1e-6)")
        check(worst < 1e-6, f"target encoding (ai) {mode}: {worst}")


def infogram_run(torch, h2o, HC, fr):
    """Run (aj): the infogram on the HIGGS frame. Returns its launches."""
    torch.cuda.synchronize()
    HC.reset_launches()
    t0 = time.perf_counter()
    ig = h2o.H2OInfogram(**INFOGRAM)
    ig.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    launches = _kernel_launches(HC)
    adm = ig.get_admissible_features()
    secs = ig.gbm_seconds
    trees = len(secs) * INFOGRAM["ntrees"]
    per_tree = {k: v / trees for k, v in launches.items()}
    rows = {r["column"]: r for r in ig.result}
    show = ", ".join(
        f"{c} {rows[c]['relevance_index']:.3f}/"
        f"{rows[c]['total_information_index']:.3f}"
        for c in [f"x{j}" for j in range(8)])
    say(f"infogram (aj): {fr.nrows} rows x {len(rows)} predictors, "
        f"{len(secs)} GBMs of {INFOGRAM['ntrees']} trees, depth "
        f"{INFOGRAM['max_depth']}: {t:.3f} s (the full model "
        f"{secs[0]:.3f} s, one-column models {np.mean(secs[1:]):.3f} s "
        f"each); admissible {adm}; relevance/information {show}; launches "
        f"per tree {per_tree}")
    # x4 enters the logit as 0.4 sin(x4): its gain share in the full
    # model stays under the 0.1 relevance threshold (0.022 in a CPU run at
    # 1M rows), so it carries information without being admissible
    noise = [f"x{j}" for j in range(7, HIGGS_C)]
    info = {c: r["total_information_index"] for c, r in rows.items()}
    check({"x0", "x1"} <= set(adm), f"infogram (aj): admissible {adm}")
    check(info["x4"] >= ig.info_thresh, f"infogram (aj): x4's information "
          f"index {info['x4']}")
    check(not set(noise) & set(adm)
          and max(info[c] for c in noise) < ig.info_thresh,
          f"infogram (aj): noise admissible {sorted(set(noise) & set(adm))} "
          f"or informative {max(info[c] for c in noise)}")
    check(per_tree == INFOGRAM_PER_TREE, f"infogram (aj): launches per tree "
          f"{per_tree}, expected {INFOGRAM_PER_TREE}")
    return launches


def _w2v_corpus(seed=16):
    """(ak)'s corpus: W2V_TOKENS words of W2V_TOPICS topics of
    W2V_TOPIC_WORDS words, each sentence W2V_SENT words of one topic with
    Zipf(1.0) frequencies inside it, sentences ending in NA. Returns the
    words (None for NA)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, W2V_TOPIC_WORDS + 1)
    zipf /= zipf.sum()
    n_sent = W2V_TOKENS // ((W2V_SENT[0] + W2V_SENT[1]) // 2)
    lens = rng.integers(W2V_SENT[0], W2V_SENT[1] + 1, n_sent)
    topics = rng.integers(0, W2V_TOPICS, n_sent)
    wid = rng.choice(W2V_TOPIC_WORDS, size=int(lens.sum()), p=zipf)
    tid = np.repeat(topics, lens)
    names = np.array([f"t{t}w{w}" for t in range(W2V_TOPICS)
                      for w in range(W2V_TOPIC_WORDS)], object)
    words = names[tid * W2V_TOPIC_WORDS + wid]
    ends = np.cumsum(lens)
    return np.insert(words, ends, None)


def _synonym_share(m, rng):
    """The share of W2V_PROBES vocabulary words whose top-5 synonyms are
    mostly (3 or more) of their own topic."""
    vocab = m._vocab_list
    probes = rng.choice(len(vocab), W2V_PROBES, replace=False)
    hits = 0
    for i in probes:
        w = vocab[i]
        topic = w.split("w")[0]
        syn = list(m.find_synonyms(w, 5))
        hits += sum(s.split("w")[0] == topic for s in syn) >= 3
    return hits / W2V_PROBES


def word2vec_run(torch, h2o, HC):
    """Run (ak): Word2Vec at H2O's defaults on a planted topic corpus,
    W2V_PARAMS' epochs; synonyms, AVERAGE transform, busy share."""
    from h2o3_tpu_torch.core.frame import Frame, T_STR, Vec
    from torch.profiler import ProfilerActivity, profile, record_function
    words = _w2v_corpus()
    fr = Frame(["w"], [Vec.from_numpy(words, type=T_STR)])
    m, t, peak = timed_train(torch, HC, "word2vec (ak)",
                             lambda: h2o.H2OWord2vecEstimator(**W2V_PARAMS),
                             training_frame=fr)
    share = _synonym_share(m, np.random.default_rng(16))
    n_tok = int(sum(w is not None for w in words))
    say(f"word2vec (ak): {n_tok} tokens, {len(m._vocab_list)} words in "
        f"the vocabulary, {m._pairs} pairs, "
        f"{W2V_PARAMS['epochs']} epochs: {m._steps} steps, train() {t:.3f} "
        f"s ({1000 * t / m._steps:.4f} ms a step, the corpus and pairs "
        f"included), {peak}; {W2V_PROBES} probe words with 3 of 5 synonyms "
        f"in their topic: share {share:.3f} (bar {W2V_SHARE_BAR}; a CPU run "
        f"of the same corpus: {W2V_SHARE_CPU})")
    check(share > W2V_SHARE_BAR, f"word2vec (ak): synonym share {share}")
    # AVERAGE: each sentence's row is the mean of its words' vectors
    head = Frame(["w"], [Vec.from_numpy(words[:2000], type=T_STR)])
    avg = torch.from_numpy(m.transform(head, "AVERAGE").to_numpy())
    V = m._vectors.double().cpu()
    rows, cur = [], []
    for w in words[:2000]:
        if w is None:
            rows.append(torch.stack(cur).mean(0) if cur
                        else torch.full((V.shape[1],), math.nan,
                                        dtype=torch.float64))
            cur = []
        elif w in m._vocab:
            cur.append(V[m._vocab[w]])
    ref = torch.stack(rows)
    same_na = torch.equal(torch.isnan(avg), torch.isnan(ref))
    d = float((avg - ref).abs().nan_to_num(0.0).max())
    say(f"word2vec (ak): AVERAGE transform of {len(rows)} sentences: max "
        f"diff from the mean of their words' vectors {d:.3g} (limit 1e-6)")
    check(same_na and d < 1e-6, f"word2vec (ak): AVERAGE {d}")
    # the card's busy share over a short training
    frac = W2V_PROFILE_SHARE
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("h2o3_train"):
            p = h2o.H2OWord2vecEstimator(**dict(W2V_PARAMS, epochs=1))
            p.train(training_frame=Frame(
                ["w"], [Vec.from_numpy(words[:int(frac * len(words))],
                                       type=T_STR)]))
            torch.cuda.synchronize()
    # the same short training again: index_add_ of float gradients on
    # the card adds in no fixed order
    q = h2o.H2OWord2vecEstimator(**dict(W2V_PARAMS, epochs=1))
    q.train(training_frame=Frame(
        ["w"], [Vec.from_numpy(words[:int(frac * len(words))], type=T_STR)]))
    same = torch.equal(p._vectors, q._vectors)
    say(f"word2vec (ak): the short training run twice: bit-identical "
        f"{same}, vectors max diff "
        f"{float((p._vectors - q._vectors).abs().max()):.3g}")
    t0, t1, dev = _trace_window(prof, "h2o3_train")
    if not dev:
        say("word2vec (ak) profiler: busy share not measured (the trace "
            "holds no device activity)")
        return
    kernels = [e for _, _, e in dev if e.get("cat") == "kernel"]
    say(f"word2vec (ak) profiler, {p._steps} steps on the corpus's first "
        f"{frac:.0%}: the card is busy {_busy(t0, dev) / 1e3:.3f} ms of the "
        f"{(t1 - t0) / 1e3:.3f} ms train() window: busy share "
        f"{_busy(t0, dev) / (t1 - t0):.4f}; "
        f"{len(kernels) / p._steps:.1f} kernel launches a step")


def phase_derived(torch, h2o, HC):
    """Runs (ae)-(ak) at full width, each timed. Returns the launches of
    (ah) and (aj)."""
    t_all = time.perf_counter()
    _glm_tf32(torch)
    dev = h2o.init().device
    times, launches = {}, {}
    cc, y = _cc_frame(torch, dev)
    vcols = [f"v{j}" for j in range(CC_C)]
    for label, fn in (("ae", lambda: aggregator_run(torch, h2o, HC, cc,
                                                    vcols)),
                      ("af", lambda: eif_run(torch, h2o, HC, cc, y, vcols))):
        t0 = time.perf_counter()
        fn()
        times[label] = time.perf_counter() - t0
    del cc, y
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    t0 = time.perf_counter()
    glm_auc = gam_run(torch, h2o, HC, fr)
    times["ag"] = time.perf_counter() - t0
    for label, fn in (("ah", lambda: rulefit_run(torch, h2o, HC, fr,
                                                 glm_auc)),
                      ("aj", lambda: infogram_run(torch, h2o, HC, fr))):
        t0 = time.perf_counter()
        launches[label] = fn()
        times[label] = time.perf_counter() - t0
    del fr
    for label, fn in (("ai", lambda: target_encoding_run(torch, h2o, HC)),
                      ("ak", lambda: word2vec_run(torch, h2o, HC))):
        t0 = time.perf_counter()
        fn()
        times[label] = time.perf_counter() - t0
    say("models on ported estimators, runs (ae)-(ak): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in sorted(times.items()))
        + f"; total {time.perf_counter() - t_all:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# The frame data plane (no kernel on its path, none may count a launch):
# ingest of SVMLight, ARFF, gzip and zip files, string and UUID columns,
# GLM's sparse path and the chunk pager.
def _small_files(tmp):
    """A seeded SVMLight file, an ARFF file, and a CSV with a string and a
    uuid column gzip'd and zipped; returns their paths."""
    import gzip
    import uuid
    import zipfile
    rng = np.random.default_rng(23)
    svm = os.path.join(tmp, "small.svm")
    with open(svm, "w") as f:
        for _ in range(3000):
            idx = np.sort(rng.choice(200, int(rng.integers(1, 12)),
                                     replace=False))
            v = rng.normal(size=len(idx)).astype(np.float32)
            y = int(v[idx < 3].sum() + rng.normal(0, 0.5) > 0)
            f.write(f"{y} " + " ".join(f"{j}:{x:.9g}"
                                       for j, x in zip(idx, v)) + "\n")
    arff = os.path.join(tmp, "small.arff")
    with open(arff, "w") as f:
        f.write("@relation r\n@attribute a numeric\n@attribute c {p,q,r}\n"
                "@attribute s string\n@data\n")
        for i in range(1000):
            f.write(f"{rng.normal():.5f},{rng.choice(['p', 'q', 'r'])},"
                    f"w{rng.integers(0, 50)}\n")
    lines = ["id,x,word"] + [
        f"{uuid.UUID(bytes=rng.bytes(16)) if i % 17 else ''},"
        f"{rng.normal():.6f},{rng.choice(['alpha', 'beta', 'gamma'])}"
        for i in range(2000)]
    text = "\n".join(lines) + "\n"
    gz = os.path.join(tmp, "small.csv.gz")
    with gzip.open(gz, "wt") as f:
        f.write(text)
    zp = os.path.join(tmp, "small.csv.zip")
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("small.csv", text)
    return {"svm": svm, "arff": arff, "gz": gz, "zip": zp}


def _frame_bits(fr):
    """Every column of a frame as host arrays (f32 bits, levels, strings,
    uuids), for card-vs-CPU equality."""
    out = []
    for v in fr.vecs:
        if v.type in ("str", "uuid"):
            out.append((v.type, [str(x) for x in v.to_numpy()]))
        else:
            out.append((v.type, v.levels(),
                        v.as_f32().cpu().numpy().view(np.int32).tobytes()))
    return out


def phase_small_ingest(torch, h2o, HC):
    """Phase 3's ingest path: the four file kinds through import_file on
    the card and on the CPU (the same columns bit for bit, every plane on
    the card), a string and a uuid column's device ops, and the sparse GLM
    fitted on the card and the CPU (coefficients within 1e-5 of the
    largest, predict_sparse within 1e-6: both sum in float64 in a fixed
    order); no kernel launch."""
    from h2o3_tpu_torch.core.frame import SparseVec
    with tempfile.TemporaryDirectory() as tmp:
        paths = _small_files(tmp)
        res = {}
        for where in ("cpu", "cuda"):
            h2o.init(device="cpu") if where == "cpu" else h2o.init()
            HC.reset_launches()
            frames = {k: h2o.import_file(
                p, col_types={"word": "str"} if k in ("gz", "zip") else None)
                for k, p in paths.items()}
            csv = frames["gz"]
            word, ids = csv.vec("word"), csv.vec("id")
            m = h2o.H2OGeneralizedLinearEstimator(family="binomial",
                                                  lambda_=1e-3, alpha=0.0)
            m.train(y="target", training_frame=frames["svm"])
            res[where] = {
                "bits": {k: _frame_bits(f) for k, f in frames.items()},
                "devices": {v.device.type for f in frames.values()
                            for v in f.vecs},
                "types": (type(word).__name__, type(ids).__name__,
                          all(isinstance(frames["svm"].vec(c), SparseVec)
                              for c in frames["svm"].names[1:])),
                "upper": word.map_values(str.upper).codes.cpu().numpy(),
                "eq": ids.eq(frames["zip"].vec("id")).cpu().numpy(),
                "isna": ids.isna_f32().cpu().numpy(),
                "glm": (m._sparse_fit, np.array(m._state.beta),
                        m.predict_sparse(frames["svm"])),
                "launches": {k: v for k, v in HC.LAUNCHES.items() if v}}
        c, g = res["cpu"], res["cuda"]
        check(g["devices"] == {"cuda"}, f"ingest devices {g['devices']}")
        check(c["bits"] == g["bits"], "ingested frames differ card vs CPU")
        check(g["types"] == ("StrVec", "UuidVec", True) == c["types"],
              f"ingest column layouts {g['types']}")
        for k in ("upper", "eq", "isna"):
            check(np.array_equal(c[k], g[k]), f"{k} differs card vs CPU")
        (cs, cb, cp), (gs, gb, gp) = c["glm"], g["glm"]
        db = float(np.abs(cb - gb).max() / np.abs(cb).max())
        dp = float(np.abs(cp - gp).max())
        check(cs and gs, "the small SVMLight GLM left the sparse path")
        check(db <= 1e-5 and dp <= 1e-6,
              f"small sparse glm card vs CPU: coef {db}, pred {dp}")
        check(not g["launches"], f"ingest launches {g['launches']}")
        say(f"small path ingest: svm {len(g['bits']['svm'])} columns "
            f"(SparseVec), arff, csv.gz, csv.zip (StrVec, UuidVec) card == "
            f"cpu bit for bit; sparse glm card vs cpu coef max diff {db:.3g} "
            f"of the largest, predict_sparse {dp:.3g}")
    h2o.init()


def _zipf_draws():
    """Draws a row (with replacement) whose distinct terms average
    RCV1_NNZ_ROW under Zipf(RCV1_ZIPF) over RCV1_C terms, and the chance
    p_in of each term to be in a row."""
    p = np.arange(1, RCV1_C + 1, dtype=np.float64) ** -RCV1_ZIPF
    p /= p.sum()
    best = None
    for d in range(RCV1_NNZ_ROW, 4 * RCV1_NNZ_ROW):
        e = float((1 - (1 - p) ** d).sum())
        if best is None or abs(e - RCV1_NNZ_ROW) < abs(best[1]
                                                      - RCV1_NNZ_ROW):
            best = (d, e)
        if e > RCV1_NNZ_ROW:
            break
    return best[0], 1 - (1 - p) ** best[0]


def _rcv1_coo(torch, dev, n, seed, planted=None):
    """rcv1.binary-shaped nonzeros made on the card: Zipf(1.1) term ids,
    no repeat within a row (repeats fold into the term frequency), values
    log(1 + tf) * idf, rows at unit L2 norm; y from a planted logit on the
    RCV1_SIGNAL most frequent terms, its intercept set for RCV1_POS
    positives. Returns (rows, cols, vals, y, p_true, planted), the
    nonzeros sorted by row, then column."""
    from h2o3_tpu_torch.models.glm import _offsets, _segment_sums
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    draws, p_in = _zipf_draws()
    p = torch.arange(1, RCV1_C + 1, dtype=torch.float64,
                     device=dev) ** -RCV1_ZIPF
    cdf = torch.cumsum(p, 0)
    cdf /= cdf[-1].clone()
    keys = torch.empty(0, dtype=torch.int64, device=dev)
    tf = torch.empty(0, dtype=torch.int64, device=dev)
    step = 1 << 17                      # rows a block: bounded memory
    for r0 in range(0, n, step):
        m = min(step, n - r0)
        u = torch.rand((m, draws), generator=g, device=dev,
                       dtype=torch.float64)
        terms = torch.searchsorted(cdf, u).clamp_(max=RCV1_C - 1)
        k = ((torch.arange(r0, r0 + m, device=dev)[:, None] * RCV1_C)
             + terms).reshape(-1)
        k, c = torch.unique(k, return_counts=True)
        keys, tf = torch.cat([keys, k]), torch.cat([tf, c])
    rows, cols = keys // RCV1_C, keys % RCV1_C
    idf = torch.log(1.0 / torch.as_tensor(p_in, device=dev))
    vals = torch.log1p(tf.double()) * idf[cols]
    ptr = _offsets(rows, n)
    norm = torch.sqrt(_segment_sums(vals * vals, ptr))
    vals = (vals / norm[rows]).float()
    if planted is None:
        beta = torch.zeros(RCV1_C, dtype=torch.float64, device=dev)
        beta[:RCV1_SIGNAL] = torch.randn(RCV1_SIGNAL, generator=g,
                                         device=dev, dtype=torch.float64) \
            * RCV1_SCALE
        eta0 = _segment_sums(vals.double() * beta[cols], ptr)
        lo, hi = -20.0, 20.0
        for _ in range(60):              # the intercept for RCV1_POS
            b0 = (lo + hi) / 2
            if float(torch.sigmoid(eta0 + b0).mean()) < RCV1_POS:
                lo = b0
            else:
                hi = b0
        planted = (beta, b0)
    beta, b0 = planted
    p_true = torch.sigmoid(_segment_sums(vals.double() * beta[cols], ptr)
                           + b0)
    y = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
         < p_true).float()
    return rows, cols, vals, y, p_true, planted


def _sparse_frame(torch, h2o, rows, cols, vals, y, n, device=None):
    """A frame of the target and one SparseVec a column, built from host
    COO arrays as the loaders build them. Returns (frame, construction
    seconds, pager registration seconds)."""
    from h2o3_tpu_torch.core import tiering
    from h2o3_tpu_torch.core.frame import Frame, SparseVec, T_CAT, Vec
    order = torch.argsort(cols * n + rows)
    r = rows[order].to(torch.int32).cpu().numpy()
    v = vals[order].cpu().numpy()
    starts = np.searchsorted(cols[order].cpu().numpy(),
                             np.arange(RCV1_C + 1))
    yc = y.cpu().numpy().astype(np.float64)
    reg = [0.0]
    orig = tiering.PAGER.new_chunk

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            reg[0] += time.perf_counter() - t
    tiering.PAGER.new_chunk = timed
    try:
        t0 = time.perf_counter()
        vecs = [Vec.from_numpy(yc, type=T_CAT, domain=["0", "1"],
                               device=device)]
        vecs += [SparseVec(r[starts[j]:starts[j + 1]],
                           v[starts[j]:starts[j + 1]], n, device=device)
                 for j in range(RCV1_C)]
        fr = Frame(["target"] + [f"t{j}" for j in range(RCV1_C)], vecs)
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        del tiering.PAGER.new_chunk
    return fr, t_build, reg[0]


class _NoDense:
    """Frame.matrix over more than one column, or a SparseVec densified,
    fails the run while inside."""

    def __enter__(self):
        from h2o3_tpu_torch.core.frame import Frame, SparseVec
        self.saved = (Frame.matrix, SparseVec.as_f32)
        orig = Frame.matrix

        def poisoned(fr, cols=None):
            check(len(list(cols if cols is not None else fr.names)) <= 1,
                  "the dense design matrix was built")
            return orig(fr, cols)

        def densify(v):
            fail("a sparse column was densified")
        Frame.matrix, SparseVec.as_f32 = poisoned, densify
        return self

    def __exit__(self, *exc):
        from h2o3_tpu_torch.core.frame import Frame, SparseVec
        Frame.matrix, SparseVec.as_f32 = self.saved


class _EvalClock:
    """Counts and times the L-BFGS objective evaluations of GLM fits
    (host clock around each: the evaluation returns host numbers, so it
    ends synchronised)."""

    def __enter__(self):
        from h2o3_tpu_torch.models import glm as G
        self.G, self.orig, self.evals, self.s = G, G._lbfgs, 0, 0.0

        def counted(vg, x0, **kw):
            def vg2(x):
                t0 = time.perf_counter()
                out = vg(x)
                self.s += time.perf_counter() - t0
                self.evals += 1
                return out
            return self.orig(vg2, x0, **kw)
        G._lbfgs = counted
        return self

    def __exit__(self, *exc):
        self.G._lbfgs = self.orig


def sparse_slice_fit(sl, params, n, threads=None):
    """(al)'s slice of n rows fitted on the cloud's device, or on a CPU
    cloud (with `threads` of torch's, in the host worker) when `sl`, the
    slice's (rows, cols, vals, y), holds host arrays. Returns
    (coefficients, predict_sparse, train() seconds)."""
    import torch
    import h2o3_tpu_torch as h2o

    def fit():
        dev = h2o.cloud().device
        sf, _, _ = _sparse_frame(torch, h2o, *(torch.as_tensor(t).to(dev)
                                               for t in sl), n, device=dev)
        sm = h2o.H2OGeneralizedLinearEstimator(**dict(params, lambda_=1.0 / n))
        t0 = time.perf_counter()
        sm.train(y="target", training_frame=sf)
        out = (sm._state.beta, sm.predict_sparse(sf),
               time.perf_counter() - t0)
        h2o.remove(sf.key)
        return out
    if all(isinstance(t, np.ndarray) for t in sl):
        if threads:
            torch.set_num_threads(threads)
        return _cpu_cloud(h2o, fit)
    return fit()


def sparse_glm_rcv1_run(torch, h2o, HC, host=None):
    """(al): GLM binomial, alpha 0, lambda 1/n (LIBLINEAR's C = 1 L2
    logistic regression) at rcv1.binary's width; its CPU slice fit in
    `host` (a HostWorker) when given."""
    from h2o3_tpu_torch.models import metrics as M
    dev = h2o.init().device
    t0 = time.perf_counter()
    rows, cols, vals, y, p_true, planted = _rcv1_coo(torch, dev, RCV1_N, 17)
    vr, vc, vv, vy, vp, _ = _rcv1_coo(torch, dev, RCV1_VALID_N, 18, planted)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    nnz = int(rows.numel())
    empty = RCV1_C - int(torch.unique(cols).numel())
    params = dict(family="binomial", alpha=0.0, lambda_=1.0 / RCV1_N)
    # the card against the CPU on a slice of rows, every column kept: the
    # CPU fit runs in the host worker while the card fits below
    keep = rows < RCV1_SLICE_N
    sl = (rows[keep], cols[keep], vals[keep], y[:RCV1_SLICE_N])
    # the worker's other tasks are done by now; the card's process runs one
    # thread of Python meanwhile
    cpu_fit = host_submit(host, sparse_slice_fit, tuple(
        t.cpu().numpy() for t in sl), params, RCV1_SLICE_N,
        max(1, (os.cpu_count() or 2) - 2) if host else None)
    fr, t_build, t_reg = _sparse_frame(torch, h2o, rows, cols, vals, y,
                                       RCV1_N)
    valid, _, _ = _sparse_frame(torch, h2o, vr, vc, vv, vy, RCV1_VALID_N)
    preds = fr.names[1:]
    t0 = time.perf_counter()
    fr.sparse_coo(preds)
    torch.cuda.synchronize()
    t_coo = time.perf_counter() - t0
    say(f"sparse glm (al): {RCV1_N} rows x {RCV1_C} columns, {nnz} "
        f"nonzeros ({nnz / RCV1_N:.1f} a row, {empty} columns empty), "
        f"positives {float(y.mean()):.4f}; generated on the card "
        f"{t_gen:.2f} s; {RCV1_C} SparseVecs built {t_build:.2f} s, of "
        f"which the pager's registration {t_reg:.2f} s; sparse_coo "
        f"{t_coo:.3f} s; a validation frame of {RCV1_VALID_N} rows")
    betas, evals = [], []
    for k in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        HC.reset_launches()
        with _NoDense(), _EvalClock() as clock:
            m = h2o.H2OGeneralizedLinearEstimator(**params)
            t0 = time.perf_counter()
            m.train(y="target", training_frame=fr, validation_frame=valid)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            perf = m.model_performance(valid)
        launches = {k2: v for k2, v in HC.LAUNCHES.items() if v}
        check(not launches, f"sparse glm (al) launches {launches}")
        check(m._sparse_fit and m._solver == "L_BFGS",
              f"(al) took solver {m._solver}, sparse {m._sparse_fit}")
        betas.append(m._state.beta.copy())
        evals.append(clock.evals)
        say(f"sparse glm (al) fit {k + 1}: train {t_fit:.2f} s, "
            f"{clock.evals} L-BFGS evaluations, "
            f"{1000 * clock.s / max(clock.evals, 1):.2f} ms an evaluation "
            f"(bound {RCV1_EVAL_BYTES * nnz / HBM_BYTES_S * 1e3:.3f} ms: "
            f"the ri, ci and vals planes read forward and back, "
            f"{RCV1_EVAL_BYTES * nnz / 1e9:.2f} GB); "
            + _peak_gib(torch, held))
    same = np.array_equal(betas[0], betas[1])
    say(f"sparse glm (al): the two fits bit-identical: {same}; largest "
        f"coefficient difference {float(np.abs(betas[0] - betas[1]).max()):.3g}"
        f"; evaluations {evals}")
    vauc = m.auc(valid=True)
    pauc = M.binomial_metrics(vy, vp.float()).auc
    say(f"sparse glm (al): validation AUC {vauc:.6f}, the planted logit's "
        f"{pauc:.6f} on the same rows; train AUC {m.auc():.6f}")
    check(abs(vauc - pauc) <= 0.02, f"(al) validation AUC {vauc} vs planted "
          f"{pauc}")
    vm = m._output.validation_metrics
    for k in ("auc", "logloss"):
        d = abs(getattr(perf, k) - getattr(vm, k))
        check(d <= 1e-7, f"(al) model_performance {k} differs by {d}")
    vg, x0 = m._sparse_objective(fr)
    g_end = np.linalg.norm(vg(m._state.beta)[1])
    g_0 = np.linalg.norm(vg(np.zeros_like(x0))[1])
    say(f"sparse glm (al): float64 gradient norm at the solution {g_end:.4g}"
        f", at zero {g_0:.4g} (ratio {g_end / g_0:.3g}, limit 1e-3); "
        "model_performance(valid) = train()'s validation metrics")
    check(g_end <= 1e-3 * g_0, f"(al) gradient ratio {g_end / g_0}")
    del fr, valid, vg
    gb, gp, gt = sparse_slice_fit(sl, params, RCV1_SLICE_N)
    cb, cp, ct = host_result(cpu_fit, "(al) the CPU slice fit")
    db = float(np.abs(cb - gb).max() / np.abs(cb).max())
    dp = float(np.abs(cp - gp).max())
    say(f"sparse glm (al) slice {RCV1_SLICE_N} rows x {RCV1_C} columns: "
        f"card {gt:.2f} s, cpu {ct:.2f} s; coefficients max diff {db:.3g} "
        f"of the largest (limit 1e-4), predictions {dp:.3g} (limit 1e-5)")
    check(db <= 1e-4 and dp <= 1e-5, f"(al) slice card vs CPU {db} {dp}")


def svmlight_covtype_run(torch, h2o, HC):
    """(am): the covtype.binary-shaped frame written as SVMLight, ingested
    through import_file, and GLM binomial at its defaults (the sparse
    L-BFGS path) against a dense IRLSM fit of the same columns."""
    from h2o3_tpu_torch.core.frame import Frame, SparseVec, T_CAT, Vec
    dev = h2o.init().device
    gen, ycls = _covtype_frame(torch, dev, COV_N, 9)
    feats = gen.names[:-1]
    X = gen.matrix(feats)
    label = (ycls == COVB_CLASS).float()
    # the generator's nonzeros by column, rows ascending: sparse_coo's order
    nz_col, nz_row = torch.nonzero(X.T != 0, as_tuple=True)
    nz_vals = X[nz_row, nz_col]
    per_col = torch.bincount(nz_col, minlength=len(feats)).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "covtype.binary.svm")
        t0 = time.perf_counter()
        Xh, yh = X.cpu().numpy(), label.cpu().numpy()
        nz = Xh != 0
        k = nz.sum(1)
        with open(path, "w") as f:
            if (k == k[0]).all():       # 12 a row: one format a row
                c = np.nonzero(nz)[1].reshape(len(yh), k[0])
                v = Xh[nz].reshape(len(yh), k[0]).astype(np.float64)
                M = np.empty((len(yh), 1 + 2 * k[0]))
                M[:, 0], M[:, 1::2], M[:, 2::2] = yh, c, v
                fmt = "%d" + " %d:%.9g" * k[0] + "\n"
                f.write("".join(fmt % tuple(r) for r in M.tolist()))
            else:
                for i in range(len(yh)):
                    idx = np.nonzero(nz[i])[0]
                    f.write(f"{int(yh[i])} " + " ".join(
                        f"{j}:{float(Xh[i, j]):.9g}" for j in idx) + "\n")
        t_write = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        fr = h2o.import_file(path)
        torch.cuda.synchronize()
        t_ing = time.perf_counter() - t0
    pairs = int(nz_row.numel())
    say(f"svmlight (am): {COV_N} rows x {len(feats)} columns, {pairs} "
        f"pairs ({pairs / COV_N:.1f} a row), class {COVB_CLASS + 1} share "
        f"{float(label.mean()):.4f}; file {size / 1e6:.1f} MB written in "
        f"{t_write:.2f} s; import_file {t_ing:.2f} s "
        f"({size / 1e6 / t_ing:.1f} MB/s)")
    check(fr.names[1:] == [f"C{j + 1}" for j in range(len(feats))],
          f"(am) columns {fr.names[:3]}...")
    check(all(isinstance(fr.vec(c), SparseVec) for c in fr.names[1:]),
          "(am) a feature column is not a SparseVec")
    got = np.array([fr.vec(c).nnz for c in fr.names[1:]])
    check(np.array_equal(got, per_col), f"(am) nonzeros a column {got} vs "
          f"{per_col}")
    r, _, v, _ = fr.sparse_coo(fr.names[1:])
    check(torch.equal(r.long(), nz_row) and torch.equal(
        v.view(torch.int32), nz_vals.contiguous().view(torch.int32)),
        "(am) ingested values differ from the generator's f32")
    check(torch.equal(fr.vec("target").as_f32(), label),
          "(am) targets differ")
    fr["target"] = Vec.from_tensor(label, type=T_CAT, domain=["0", "1"])
    HC.reset_launches()
    with _NoDense(), _EvalClock() as clock:
        m = h2o.H2OGeneralizedLinearEstimator(family="binomial")
        t0 = time.perf_counter()
        m.train(y="target", training_frame=fr)
        t_fit = time.perf_counter() - t0
    check(m._sparse_fit and m._solver == "L_BFGS", "(am) left the sparse "
          "path")
    dense = Frame(feats + ["y"], [gen.vec(c) for c in feats]
                  + [Vec.from_tensor(label, type=T_CAT, domain=["0", "1"])])
    d = h2o.H2OGeneralizedLinearEstimator(family="binomial", solver="IRLSM")
    t0 = time.perf_counter()
    d.train(y="y", training_frame=dense)
    t_dense = time.perf_counter() - t0
    launches = {k2: v2 for k2, v2 in HC.LAUNCHES.items() if v2}
    check(not launches, f"(am) launches {launches}")
    dl = abs(m.logloss() - d.logloss())
    say(f"svmlight (am): sparse L-BFGS {t_fit:.2f} s ({clock.evals} "
        f"evaluations, {1000 * clock.s / max(clock.evals, 1):.2f} ms each); "
        f"training logloss {m.logloss():.7f}, dense IRLSM {d.logloss():.7f} "
        f"({t_dense:.2f} s): diff {dl:.3g} (limit 1e-4); AUC sparse "
        f"{m.auc():.6f} dense {d.auc():.6f}")
    check(dl <= 1e-4, f"(am) logloss sparse vs dense {dl}")


def _link_bound():
    """The host link's bound in GB/s a direction from nvidia-smi's PCIe
    generation and width (current and max), and the text of the reading."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    try:
        gc_, wc, gm, wm = (int(x) for x in
                           q.stdout.strip().splitlines()[0].split(","))
    except (ValueError, IndexError):
        return None, f"unreadable: {q.stdout.strip()!r}"

    def gbs(gen, width):
        gts = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}[gen]
        enc = 0.8 if gen <= 2 else 128 / 130
        return gts * width * enc / 8
    return gbs(max(gc_, gm), max(wc, wm)), (
        f"gen {gc_} x{wc} now, gen {gm} x{wm} at most")


def pager_higgs_run(torch, h2o, HC):
    """(an): the HIGGS frame through Vec.from_numpy under an HBM budget of
    a third of its packed bytes; GBM with prefetch on and off against the
    unconstrained frame; the spill ladder; rebalance_frame."""
    from h2o3_tpu_torch.core import tiering
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec, rebalance_frame
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.core.memory import frame_chunks
    from h2o3_tpu_torch.parallel import mrtask
    P = tiering.PAGER
    dev = h2o.init().device
    gen = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    Xh = gen.matrix(gen.names[:-1]).cpu().numpy()
    yh = gen.vec("y").as_f32().cpu().numpy().astype(np.float64)
    DKV.remove(gen.key)
    del gen
    names = [f"x{j}" for j in range(HIGGS_C)] + ["y"]

    def ingest():
        t0 = time.perf_counter()
        vecs = [Vec.from_numpy(Xh[:, j]) for j in range(HIGGS_C)]
        vecs.append(Vec.from_numpy(yh, type=T_CAT, domain=["0", "1"]))
        return Frame(names, vecs), time.perf_counter() - t0

    gbm = dict(HIGGS_DEFAULT, ntrees=10)

    def train_predict(fr):
        HC.reset_launches()
        m = h2o.H2OGradientBoostingEstimator(**gbm)
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr)
        p = m.predict(fr).vec("p1").as_f32()
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0, dict(HC.LAUNCHES)

    P.hbm_budget = 0
    ref_fr, t_ing = ingest()
    p_ref, t_ref, l_ref = train_predict(ref_fr)
    packed = sum(c.nbytes for c in frame_chunks(ref_fr))
    codecs = sorted({v.codec.kind for v in ref_fr.vecs})
    del ref_fr
    DKV.clear()                   # the reference run's frames and model
    gc.collect()
    base = P.tier_bytes()["hbm"]
    P.hbm_budget = base + packed // 3
    fr, t_cold = ingest()
    chunks = frame_chunks(fr)
    check(all(c.tier == "host" for c in chunks), "(an) ingest was not cold")
    for v in fr.vecs:       # the rollups, once: both runs below reuse them
        v.rollups()
    say(f"pager (an): {HIGGS_N} rows x {HIGGS_C} columns through "
        f"Vec.from_numpy ({t_ing:.2f} s unconstrained, {t_cold:.2f} s cold),"
        f" codecs {codecs}, packed {packed / 1e9:.3f} GB; HBM budget "
        f"{packed // 3 / 1e9:.3f} GB above {base / 1e9:.3f} GB held by other "
        f"chunks; unconstrained GBM 10 trees + predict {t_ref:.2f} s")
    saved = mrtask.prefetch_chunks
    for label in ("on", "off"):
        for c in chunks:
            P.demote(c, tiering.TIER_HOST)
        fr._matrix_cache.clear()
        gc.collect()
        if label == "off":
            mrtask.prefetch_chunks = lambda handles: None
        s0 = P.stats()
        P.reset_peak()
        try:
            p, t, launches = train_predict(fr)
        finally:
            mrtask.prefetch_chunks = saved
        s1 = P.stats()
        faults = {k: s1["faults_by_tier"][k] - s0["faults_by_tier"][k]
                  for k in s1["faults_by_tier"]}
        pf = (s1["prefetch_requests"] - s0["prefetch_requests"],
              s1["prefetch_hits"] - s0["prefetch_hits"])
        same = torch.equal(p.view(torch.int32), p_ref.view(torch.int32))
        say(f"pager (an) prefetch {label}: GBM 10 trees + predict {t:.2f} s;"
            f" faults {faults}, prefetch requests/hits {pf}, peak HBM "
            f"{s1['peak_hbm_bytes'] / 1e9:.3f} GB (budget "
            f"{P.hbm_budget / 1e9:.3f}); predictions bit for bit the "
            f"unconstrained run's: {same}")
        check(same, f"(an) prefetch {label}: predictions differ")
        check(launches == l_ref, f"(an) launches {launches} vs {l_ref}")
        check(s1["peak_hbm_bytes"] <= P.hbm_budget,
              f"(an) peak {s1['peak_hbm_bytes']} over {P.hbm_budget}")
        check(sum(faults.values()) > 0, "(an) the budgeted run never paged")
        check((pf[0] > 0) == (label == "on"), f"(an) prefetch {label} {pf}")
    # the ladder, unbudgeted (no host copy is kept): card, host, disk and
    # back
    for c in chunks:
        P.demote(c, tiering.TIER_HOST)
    P.hbm_budget = 0
    fr._matrix_cache.clear()
    before = [tuple(None if a is None else np.array(a) for a in
                    c.staging_view()) for c in chunks]
    nbytes = sum(c.nbytes for c in chunks)
    bound, link = _link_bound()
    rates = {}

    def move(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in chunks:
            fn(c)
        torch.cuda.synchronize()
        rates[what] = nbytes / (time.perf_counter() - t0) / 1e9
    move("host -> card", lambda c: c.device())
    check(all(c._host is None for c in chunks), "(an) host copies kept")
    move("card -> host", lambda c: P.demote(c, tiering.TIER_HOST))
    move("host -> disk", lambda c: P.demote(c, tiering.TIER_DISK))
    move("disk -> card", lambda c: c.device())
    for c, b in zip(chunks, before):
        got = c.device()
        check(c.tier == "hbm" and all(
            (x is None and y is None) or np.array_equal(
                x.cpu().numpy().view(np.uint8), y.view(np.uint8))
            for x, y in zip(got, b)), f"(an) {c.key} changed on the ladder")
    say(f"pager (an) ladder of {nbytes / 1e9:.3f} GB, planes bit-identical "
        f"after it: " + ", ".join(f"{k} {v:.2f} GB/s" for k, v in
                                  rates.items())
        + (f"; the host link's bound {bound:.1f} GB/s a direction "
           f"({link})" if bound else f"; the host link not readable "
           f"({link}): the H100 SXM's PCIe gen 5 x16 data-sheet figure is "
           f"{PCIE5_X16_GBS:.1f} GB/s a direction"))
    t0 = time.perf_counter()
    rb = rebalance_frame(fr)
    same = all(torch.equal(a.as_f32().view(torch.int32),
                           b.as_f32().view(torch.int32))
               for a, b in zip(fr.vecs, rb.vecs))
    say(f"pager (an) rebalance_frame {time.perf_counter() - t0:.2f} s: the "
        f"same values {same}")
    check(same, "(an) rebalance_frame changed values")
    DKV.remove(rb.key)
    DKV.remove(fr.key)


def phase_data_plane(torch, h2o, HC, host=None):
    """Runs (al)-(an), each timed, after every earlier frame is dropped
    from the store; (al)'s CPU slice fit in `host` when given."""
    from h2o3_tpu_torch.core.kvstore import DKV
    DKV.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    times = {}
    for label, fn in (("al", lambda *a: sparse_glm_rcv1_run(*a, host)),
                      ("am", svmlight_covtype_run),
                      ("an", pager_higgs_run)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn(torch, h2o, HC)
        times[label] = time.perf_counter() - t0
        say(f"frame data plane ({label}): {times[label]:.1f} s, "
            + _peak_gib(torch, held).replace("train()", "the run"))
        DKV.clear()
        gc.collect()
    say("frame data plane, runs (al)-(an): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in sorted(times.items()))
        + f"; total {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# Runs (ao) and (ap): ingest and persistence
def _vocab_table(tokens):
    """A vocabulary as a zero-padded byte matrix and the token lengths."""
    enc = [t.encode() for t in tokens]
    tab = np.zeros((len(enc), max(len(t) for t in enc)), np.uint8)
    for i, t in enumerate(enc):
        tab[i, :len(t)] = np.frombuffer(t, np.uint8)
    return tab, np.array([len(t) for t in enc], np.int64)


def airline_csv(path, n, seed=AIR_SEED):
    """(ao)'s file: n rows drawn by numpy from `seed`, every column a code
    into a small vocabulary, the rows' bytes laid out by numpy scatters
    (no per-row formatting). Returns the Y share."""
    rng = np.random.default_rng(seed)
    ports = set()
    while len(ports) < AIR_PORTS:
        ports.add("".join(chr(65 + c) for c in rng.integers(0, 26, 3)))
    ports = sorted(ports)
    zipf = np.arange(1, AIR_PORTS + 1, dtype=np.float64) ** -AIR_ZIPF
    zipf /= zipf.sum()
    share = rng.dirichlet(np.full(len(AIR_CARRIERS), 2.0))
    # the planted effects before the rows: every n draws its rows from the
    # same population
    c_eff = rng.normal(0, 0.4, len(AIR_CARRIERS))
    o_eff = rng.normal(0, 0.3, AIR_PORTS)
    hour_p = np.array([1, .5, .3, .2, .3, 2, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6,
                       6, 6, 6, 5, 4, 3, 2, 1.5])
    month, dom = rng.integers(1, 13, n), rng.integers(1, 32, n)
    dow = rng.integers(1, 8, n)
    hour = rng.choice(24, n, p=hour_p / hour_p.sum())
    dep = hour * 100 + rng.integers(0, 60, n)
    carrier = rng.choice(len(AIR_CARRIERS), n, p=share)
    origin = rng.choice(AIR_PORTS, n, p=zipf)
    dest = rng.choice(AIR_PORTS, n, p=zipf)
    dist = np.clip(np.exp(rng.normal(6.4, 0.65, n)), 30, 4962).astype(
        np.int64)
    logit = (-2.0 + 0.09 * (hour - 12) + 0.006 * (hour - 12) ** 2
             + c_eff[carrier] + o_eff[origin] + 0.00012 * (dist - 700))
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    cols = [([f"c-{k}" for k in range(13)], month),
            ([f"c-{k}" for k in range(32)], dom),
            ([f"c-{k}" for k in range(8)], dow),
            ([str(k) for k in range(2400)], dep), (AIR_CARRIERS, carrier),
            (ports, origin), (ports, dest),
            ([str(k) for k in range(4963)], dist), (["N", "Y"], y)]
    tabs = [(_vocab_table(v), c) for v, c in cols]
    rowlen = sum(lens[c] for (_t, lens), c in tabs) + len(tabs)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(rowlen, out=starts[1:])
    out = np.empty(int(starts[-1]), np.uint8)
    pos = starts[:-1].copy()
    for k, ((tab, lens), c) in enumerate(tabs):
        lc = lens[c]
        for b in range(tab.shape[1]):
            sel = lc > b
            out[pos[sel] + b] = tab[c[sel], b]
        pos += lc
        out[pos] = ord("\n") if k == len(tabs) - 1 else ord(",")
        pos += 1
    with open(path, "wb") as f:
        f.write((AIR_HEADER + "\n").encode())
        f.write(out.data)
    return float(y.mean())


def airline_cpu_reference(torch, h2o):
    """`--airline-cpu-reference`: (ao)'s GBM on AIR_CPU_N rows of its
    generator through the port on the cloud's device (main puts it on the
    host's CPU), scored on its training rows and on the next AIR_CPU_N
    rows of the same draw; the held-out AUC (what the training AUC tends
    to as the rows grow) sets AIR_AUC_BAR."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "airline.csv")
        ys = airline_csv(path, 2 * AIR_CPU_N)
        head, tail = os.path.join(tmp, "head.csv"), os.path.join(tmp,
                                                                "tail.csv")
        _head_rows(path, head, AIR_CPU_N)
        with open(path, "rb") as fi, open(tail, "wb") as fo:
            fo.write(fi.readline())
            fi.seek(os.path.getsize(head))
            shutil.copyfileobj(fi, fo)
        fr, test = h2o.import_file(head), h2o.import_file(tail)
    t0 = time.perf_counter()
    m = h2o.H2OGradientBoostingEstimator(**AIR_GBM)
    m.train(y="dep_delayed_15min", training_frame=fr)
    t = time.perf_counter() - t0
    say(f"airline (ao) on the CPU, {fr.nrows} rows, Y share {ys:.4f}: "
        f"train AUC {m.auc()!r}, AUC on the next {test.nrows} rows "
        f"{m.model_performance(test).auc!r}; train() {t:.1f} s on "
        f"{torch.get_num_threads()} threads")


class _RangeHandler(http.server.SimpleHTTPRequestHandler):
    """A static file server of one directory that answers a Range request
    with 206 and the bytes asked for."""

    def log_message(self, *args):
        pass

    def send_head(self):
        rng = self.headers.get("Range")
        path = self.translate_path(self.path)
        if not rng or not os.path.isfile(path):
            return super().send_head()
        size = os.path.getsize(path)
        lo, hi = rng.split("=")[1].split("-")
        lo, hi = int(lo), min(int(hi or size - 1), size - 1)
        with open(path, "rb") as f:
            f.seek(lo)
            body = f.read(max(hi - lo + 1, 0))
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        return io.BytesIO(body)


def _frame_digest(fr):
    """A column's name, type, levels, codec and the sha256 of its packed
    plane and NA plane, read from the cheapest tier."""
    out = []
    for name, v in zip(fr.names, fr.vecs):
        d, m = v._chunk.staging_view()
        c = v.codec
        out.append((name, v.type, tuple(v.levels() or ()),
                    (c.kind, c.bias, repr(c.const_val)),
                    hashlib.sha256(np.ascontiguousarray(d)).hexdigest(),
                    None if m is None else hashlib.sha256(
                        np.ascontiguousarray(m)).hexdigest()))
    return out


def _decoded(fr, n):
    """The first n rows of each column by value: a categorical's level
    strings, a number's f32 bits."""
    out = []
    for v in fr.vecs:
        x = v.as_f32()[:n].cpu().numpy()
        if v.domain is not None:
            out.append(np.asarray(v.domain, object)[x.astype(np.int64)])
        else:
            out.append(x.view(np.uint32))
    return out


def _head_rows(path, out, rows):
    """The header and the first `rows` rows of `path` into `out`."""
    with open(path, "rb") as f:
        buf = f.read(min(os.path.getsize(path), (rows + 1) * 128))
    nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
    with open(out, "wb") as f:
        f.write(buf[: int(nl[rows]) + 1])


def _grid_trains(cls, kill_after=None):
    """Record the model ids `cls` trains, and stop the walk with
    KeyboardInterrupt at the train after `kill_after` of them (a grid
    records an Exception as a failure and goes on; this stops it as a
    killed process would). Returns (trained ids, restore)."""
    had = "train" in cls.__dict__
    old = cls.__dict__.get("train")
    train = cls.train
    trained = []

    def counting(self, *a, **k):
        if kill_after is not None and len(trained) >= kill_after:
            raise KeyboardInterrupt
        trained.append(self.params.get("model_id"))
        return train(self, *a, **k)

    def restore():
        if had:
            cls.train = old
        else:
            del cls.train
    cls.train = counting
    return trained, restore


def _run_grid(h2o, gid, rdir, fr, kill_after=None):
    cls = h2o.H2OGradientBoostingEstimator
    trained, restore = _grid_trains(cls, kill_after)
    g = h2o.H2OGridSearch(cls, AIR_GRID, grid_id=gid, recovery_dir=rdir)
    try:
        g.train(y="dep_delayed_15min", training_frame=fr, **AIR_GRID_GBM)
    except KeyboardInterrupt:
        pass
    finally:
        restore()
    return g, trained


def _cpu_cloud(h2o, fn):
    """fn() on a CPU cloud: in the host worker (no card visible) the
    cloud stays there; in the card's process the card's cloud comes back
    after."""
    import torch
    if torch.cuda.is_available():
        return _on_cpu(h2o, fn)
    h2o.init(device="cpu")
    return fn()


def airline_files(tmp, n=AIR_N, py_rows=AIR_PY_ROWS):
    """(ao)'s host work, in the host worker from the top of main(): the
    n-row file, its AIR_PARTS parts and level-1 gzip, the head of py_rows
    rows, and the plain Python tokenizer's parse of the head on a CPU
    cloud (the frame's digest, for airline_run to hold against the native
    parse on the card). Returns what airline_run prints."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.io import dparse
    out = {}
    path = os.path.join(tmp, "train-10m.csv")
    t0 = time.perf_counter()
    out["yshare"] = airline_csv(path, n)
    out["t_gen"] = time.perf_counter() - t0
    # the other forms, from the file's bytes
    t0 = time.perf_counter()
    parts = os.path.join(tmp, "parts")
    os.makedirs(parts)
    with open(path, "rb") as f:
        head = f.readline()
        body = f.read()
    cuts = [0]
    for k in range(1, AIR_PARTS):
        cuts.append(body.index(b"\n", len(body) * k // AIR_PARTS) + 1)
    cuts.append(len(body))
    for k in range(AIR_PARTS):
        with open(os.path.join(parts, f"part-{k}.csv"), "wb") as f:
            f.write(head)
            f.write(body[cuts[k]:cuts[k + 1]])
    del body
    with open(path, "rb") as fi, gzip.open(path + ".gz", "wb",
                                           compresslevel=1) as fo:
        shutil.copyfileobj(fi, fo, 16 << 20)
    out["t_forms"] = time.perf_counter() - t0
    # the plain Python tokenizer on the head of the file
    hpath = os.path.join(tmp, "head.csv")
    _head_rows(path, hpath, py_rows)

    def python_parse():
        t0 = time.perf_counter()
        cols = dparse._tokenize_range_py(hpath, ",", True, 0, -1)
        py = dparse._merge_chunks([cols], h2o.parse_setup(hpath), None,
                                  None)
        t_py = time.perf_counter() - t0
        digest = _frame_digest(py)
        h2o.remove(py.key)
        return t_py, digest
    out["t_py"], out["py_digest"] = _cpu_cloud(h2o, python_parse)
    return out


def airline_run(torch, h2o, HC, files=None):
    """(ao): the airline file in four forms through import_file, the same
    Frame from each and every byte through the native tokenizer; the
    Python tokenizer on its head; GBM at H2O's defaults; the .hex round
    trip; save and load on the card and in a card-less process; a grid
    killed after 2 models and resumed. `files`: (directory, the host
    worker's airline_files future), or None to make them here."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.core.memory import frame_chunks
    from h2o3_tpu_torch.io import dparse, fastcsv
    from h2o3_tpu_torch.io.persist import import_frame
    y = "dep_delayed_15min"
    if files is None:
        tmp = tempfile.mkdtemp(prefix="h2o3_air_")
        files = (tmp, host_submit(None, airline_files, tmp, AIR_N,
                                  AIR_PY_ROWS))
    tmp, fut = files
    try:
        info = host_result(fut, "(ao) the airline files")
        path = os.path.join(tmp, "train-10m.csv")
        parts, gz = os.path.join(tmp, "parts"), path + ".gz"
        size = os.path.getsize(path)
        yshare, t_gen, t_forms = info["yshare"], info["t_gen"], \
            info["t_forms"]
        httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(_RangeHandler,
                                                directory=tmp))
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/train-10m.csv"
        say(f"airline (ao): {AIR_N} rows, {size / 1e6:.1f} MB written in "
            f"{t_gen:.1f} s (Y share {yshare:.4f}); {AIR_PARTS} parts and a "
            f"level-1 gzip of {os.path.getsize(gz) / 1e6:.1f} MB in "
            f"{t_forms:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        frames, rates = {}, {}
        cpus = os.cpu_count()
        try:
            for label, src in (("one file", path), ("8 parts", parts),
                               ("gzip", gz), ("http ranges", url)):
                fastcsv.reset_counts()
                t0 = time.perf_counter()
                fr = h2o.import_file(src)
                torch.cuda.synchronize()
                t = time.perf_counter() - t0
                counts = dict(fastcsv.TOKENIZED_BYTES)
                frames[label] = fr
                rates[label] = size / t / 1e6
                # the pool's threads: one a plan entry at most (a gzip's
                # windows take the pool of 8 units)
                units = {"one file": None, "8 parts": AIR_PARTS,
                         "gzip": 8}.get(
                    label, -(-size // dparse._chunk_bytes_default()))
                threads = 1 if units is None else dparse._pool_workers(units)
                say(f"airline (ao) ingest {label}: {t:.2f} s, "
                    f"{rates[label]:.1f} MB/s ({cpus} host CPUs, {threads} "
                    f"tokenizer threads); bytes tokenized {counts}")
                check(counts["python"] == 0 and counts["fastcsv"] >= size,
                      f"(ao) {label}: not every byte went through the "
                      f"native tokenizer: {counts}")
        finally:
            httpd.shutdown()
            server.join()
            httpd.server_close()
        peak_parse = torch.cuda.max_memory_allocated()
        one = frames["one file"]
        check(one.nrows == AIR_N and len(one.names) == 9,
              f"(ao) shape {one.shape}")
        check(one.types == {**{c: "enum" for c in one.names},
                            "DepTime": "num", "Distance": "num"},
              f"(ao) types {one.types}")
        want = _frame_digest(one)
        for label, fr in frames.items():
            check(_frame_digest(fr) == want,
                  f"(ao) {label}: not the one-file frame")
            if fr is not one:
                DKV.remove(fr.key)
        say(f"airline (ao): the one-file, 8-part, gzip and http frames "
            f"are the same bit for bit (names, types, domains of "
            f"{[len(v.levels() or ()) for v in one.vecs]} levels, codecs "
            f"{[v.codec.kind for v in one.vecs]}, planes and NA planes)")
        shutil.rmtree(parts)
        os.unlink(gz)
        # the plain Python tokenizer's parse of the head (in the host
        # worker) against the native one here
        hpath = os.path.join(tmp, "head.csv")
        t_py = info["t_py"]
        native = h2o.import_file(hpath)
        same = info["py_digest"] == _frame_digest(native)
        rows_same = all(np.array_equal(a, b) for a, b in zip(
            _decoded(native, AIR_PY_ROWS), _decoded(one, AIR_PY_ROWS)))
        say(f"airline (ao): the Python tokenizer on the first "
            f"{AIR_PY_ROWS} rows in {t_py:.1f} s "
            f"({os.path.getsize(hpath) / t_py / 1e6:.2f} MB/s): the native "
            f"parse of those rows bit for bit {same}, their values the "
            f"10M-row frame's {rows_same}")
        check(same and rows_same, "(ao) the Python tokenizer disagrees")
        DKV.remove(native.key)
        os.unlink(path)
        # GBM at H2O's defaults
        HC.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = h2o.H2OGradientBoostingEstimator(**AIR_GBM)
        m.train(y=y, training_frame=one)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = {k: v for k, v in HC.LAUNCHES.items() if v}
        peak_train = torch.cuda.max_memory_allocated()
        say(f"airline (ao) GBM {AIR_GBM['ntrees']} trees depth "
            f"{AIR_GBM['max_depth']} nbins {AIR_GBM['nbins']}: train() "
            f"{t_train:.2f} s, train AUC {m.auc():.6f} (bar {AIR_AUC_BAR}, "
            f"the CPU's held-out {AIR_AUC_CPU} at {AIR_CPU_N} rows); "
            f"launches {launches}; peak HBM of the four parses "
            f"{peak_parse / 2**30:.2f} GiB, of train() "
            f"{peak_train / 2**30:.2f} GiB")
        check(m.auc() > AIR_AUC_BAR, f"(ao) AUC {m.auc()}")
        check(all(launches.get(k) for k in ("radix", "fused", "route_f")),
              f"(ao) launches {launches}")
        # the .hex round trip
        packed = sum(c.nbytes for c in frame_chunks(one))
        hexp = os.path.join(tmp, "airline.hex")
        t0 = time.perf_counter()
        h2o.export_file(one, hexp)
        t_exp = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = import_frame(hexp, key="airline_hex")
        torch.cuda.synchronize()
        t_imp = time.perf_counter() - t0
        same = _frame_digest(back) == want
        say(f"airline (ao) export_file {packed / 1e6:.1f} MB of packed "
            f"planes to {os.path.getsize(hexp) / 1e6:.1f} MB in "
            f"{t_exp:.2f} s ({packed / t_exp / 1e6:.1f} MB/s), "
            f"import_frame in {t_imp:.2f} s ({packed / t_imp / 1e6:.1f} "
            f"MB/s): bit for bit {same}")
        check(same, "(ao) the .hex round trip changed the frame")
        DKV.remove(back.key)
        os.unlink(hexp)
        # save and load, on the card and in a process without one
        mpath = os.path.join(tmp, "gbm.bin")
        p_card = m.predict(one).vecs[-1].as_f32()      # P(Y)
        t0 = time.perf_counter()
        h2o.save_model(m, mpath)
        t_save = time.perf_counter() - t0
        DKV.remove(m.key)
        t0 = time.perf_counter()
        lm = h2o.load_model(mpath)
        t_load = time.perf_counter() - t0
        p_back = lm.predict(one).vecs[-1].as_f32()
        same = torch.equal(p_back.view(torch.int32), p_card.view(torch.int32))
        sl = _sub_frame(one, AIR_SLICE_N)
        slp, outp = os.path.join(tmp, "slice.hex"), os.path.join(tmp, "p.npy")
        h2o.export_file(sl, slp)
        code = (
            "import sys\nsys.path.insert(0, sys.argv[1])\n"
            "import numpy as np, torch\nimport h2o3_tpu_torch as h2o\n"
            "from h2o3_tpu_torch.io.persist import import_frame\n"
            "assert not torch.cuda.is_available()\n"
            "h2o.init(device='cpu')\nm = h2o.load_model(sys.argv[2])\n"
            "np.save(sys.argv[4], m.predict(import_frame(sys.argv[3]))"
            ".vecs[-1].to_numpy())\n")
        # the card-less process runs while the grid below trains
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", code,
             os.path.dirname(os.path.abspath(__file__)), mpath, slp, outp],
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        # a grid killed after 2 models and resumed
        t_grid0 = time.perf_counter()
        full, _ = _run_grid(h2o, "air_full", None, one)
        rdir = os.path.join(tmp, "recovery")
        first, trained1 = _run_grid(h2o, "air_rec", rdir, one, kill_after=2)
        for key in first.model_ids:
            DKV.remove(key)
        second, trained2 = _run_grid(h2o, "air_rec", rdir, one)
        t_grid = time.perf_counter() - t_grid0
        with host_only():
            try:
                _, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
        t_sub = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"(ao) the card-less load failed: {err[-2000:]}")
        cpu_err = float(np.abs(np.load(outp) - p_card[:AIR_SLICE_N]
                               .cpu().numpy()).max())
        say(f"airline (ao) save_model {os.path.getsize(mpath) / 1e6:.2f} MB "
            f"in {t_save:.3f} s, load_model in {t_load:.3f} s: predictions "
            f"on the card bit for bit {same}; a process with "
            f"CUDA_VISIBLE_DEVICES='' loaded it onto the CPU and predicted "
            f"{AIR_SLICE_N} rows within {cpu_err:.3g} of the card (limit "
            f"1e-5; {t_sub:.1f} s with its start, beside the grid below)")
        check(same and cpu_err <= 1e-5, f"(ao) save/load: card {same}, "
              f"CPU {cpu_err}")

        def by_combo(g):
            return {(mm.params["max_depth"], mm.params["learn_rate"]): mm
                    for mm in g.models}
        fb, rb = by_combo(full), by_combo(second)
        same = fb.keys() == rb.keys() and len(fb) == 4 and all(
            torch.equal(fb[k].predict(sl).vecs[-1].as_f32().view(
                torch.int32), rb[k].predict(sl).vecs[-1].as_f32().view(
                    torch.int32)) and fb[k].auc() == rb[k].auc()
            for k in fb)
        say(f"airline (ao) grid {AIR_GRID}: killed after {len(trained1)} "
            f"models, resumed with {len(second.models)} ({len(trained2)} "
            f"trained, none twice: {not set(trained1) & set(trained2)}); "
            f"each model bit for bit the uninterrupted grid's {same} "
            f"({t_grid:.1f} s for the three walks)")
        check(len(trained1) == 2 and len(trained2) == 2
              and not set(trained1) & set(trained2) and same,
              "(ao) the resumed grid is not the uninterrupted one")
        say(f"airline (ao): peak HBM since train() "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, of the "
            f"parses {peak_parse / 2**30:.2f} GiB "
            f"({(peak_parse - held) / 2**30:.2f} GiB above what was held "
            f"before them)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    DKV.clear()


def _higgs_csv_rows(torch, big):
    """The first HIGGS_CSV_N rows of the HIGGS frame `big`: (their Frame,
    float64 host values, names)."""
    fr = _sub_frame(big, HIGGS_CSV_N)
    X = fr.matrix(fr.names[:-1]).cpu().numpy().astype(np.float64)
    data = np.column_stack([X, fr.vec("y").as_f32().cpu().numpy()])
    return fr, data, list(fr.names)


def write_csv_rows(names, data, path):
    """`data` (a matrix, or the .npy holding it) written to `path` with
    %.9g (every f32 round-trips): (bytes, seconds). (ap)'s file, written
    by the host worker from main()'s early copy of the rows."""
    if isinstance(data, str):
        data = np.load(data)
    fmt = ",".join(["%.9g"] * data.shape[1]) + "\n"
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for s in range(0, data.shape[0], 100_000):
            blk = data[s:s + 100_000]
            f.write((fmt * len(blk)) % tuple(blk.ravel().tolist()))
    return os.path.getsize(path), time.perf_counter() - t0


def _write_higgs_csv(torch, big, path):
    """The first HIGGS_CSV_N rows of the HIGGS frame `big` written to
    `path` with %.9g: (the rows' Frame, the file's bytes, seconds)."""
    fr, data, names = _higgs_csv_rows(torch, big)
    with host_only():
        size, t = write_csv_rows(names, data, path)
    return fr, size, t


def start_higgs_csv(torch, h2o, path, host):
    """(ap)'s rows copied off the card now and written to `path` by
    `host` (a HostWorker) meanwhile; the future for higgs_csv_run."""
    from h2o3_tpu_torch.core.kvstore import DKV
    big = _higgs_frame(torch, h2o, h2o.init().device, HIGGS_N, 7)
    fr, data, names = _higgs_csv_rows(torch, big)
    npy = path + ".npy"
    np.save(npy, data)
    for f in (fr, big):
        DKV.remove(f.key)
    del fr, big
    gc.collect()
    torch.cuda.empty_cache()        # the next phase starts from the same pool
    return host_submit(host, write_csv_rows, names, npy, path)


def higgs_csv_run(torch, h2o, HC, path, written=None):
    """(ap): the first HIGGS_CSV_N rows of the HIGGS frame written with
    %.9g to `path` and read back by import_file: the in-memory values bit
    for bit, and (b)'s GBM for 10 trees the same predictions bit for bit on
    both. The file stays for (bb), which parses it again over REST.
    `written`: the host worker's write of the file (start_higgs_csv), or
    None to write it here."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.io import fastcsv
    dev = h2o.init().device
    big = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    if written is None:
        fr, size, t_write = _write_higgs_csv(torch, big, path)
    else:
        fr = _sub_frame(big, HIGGS_CSV_N)
        size, t_write = host_result(written, "(ap) the CSV's writing")
        os.unlink(path + ".npy")
    DKV.remove(big.key)
    del big
    gc.collect()
    fastcsv.reset_counts()
    t0 = time.perf_counter()
    pf = h2o.import_file(path, col_types={"y": "enum"})
    torch.cuda.synchronize()
    t_parse = time.perf_counter() - t0
    counts = dict(fastcsv.TOKENIZED_BYTES)
    same = pf.names == fr.names and pf.types == fr.types and \
        pf.vec("y").levels() == fr.vec("y").levels() and all(
            torch.equal(a.as_f32().view(torch.int32),
                        b.as_f32().view(torch.int32))
            for a, b in zip(pf.vecs, fr.vecs))
    say(f"higgs csv (ap): {HIGGS_CSV_N} rows x {len(fr.names)} columns "
        f"written with %.9g ({size / 1e6:.1f} MB in {t_write:.1f} s), "
        f"import_file {t_parse:.2f} s ({size / t_parse / 1e6:.1f} MB/s, "
        f"{os.cpu_count()} host CPUs, one tokenizer thread); bytes "
        f"tokenized {counts}; the in-memory frame's values bit for bit "
        f"{same}")
    check(same and counts["python"] == 0 and counts["fastcsv"] == size,
          f"(ap) parse: values {same}, counts {counts}")
    gbm = dict(HIGGS_DEFAULT, ntrees=10)
    preds = []
    for frame in (fr, pf):
        HC.reset_launches()
        m = h2o.H2OGradientBoostingEstimator(**gbm)
        m.train(y="y", training_frame=frame)
        preds.append(m.predict(frame).vec("p1").as_f32())
        torch.cuda.synchronize()
        per_tree = {k: v / 10 for k, v in HC.LAUNCHES.items() if v}
        check(per_tree == PER_TREE["default"],
              f"(ap) launches per tree {per_tree}")
    same = torch.equal(preds[0].view(torch.int32), preds[1].view(torch.int32))
    say(f"higgs csv (ap) GBM 10 trees of (b)'s configuration on the "
        f"in-memory and the parsed frame: predictions bit for bit {same}, "
        f"launches per tree {per_tree}")
    check(same, "(ap) GBM predictions differ between the two frames")
    DKV.clear()


def phase_ingest(torch, h2o, HC, higgs_csv, airline=None, written=None):
    """Runs (ao) and (ap), each timed, after every earlier frame is
    dropped from the store; (ap) writes its CSV to `higgs_csv`.
    `airline`, `written`: (ao)'s files and (ap)'s CSV as main() started
    them in the host worker (airline_run's `files`, higgs_csv_run's
    `written`), or None."""
    from h2o3_tpu_torch.core.kvstore import DKV
    DKV.clear()
    gc.collect()
    torch.cuda.empty_cache()
    t_all = time.perf_counter()
    times = {}
    for label, fn in (("ao", lambda *a: airline_run(*a, files=airline)),
                      ("ap", lambda *a: higgs_csv_run(*a, higgs_csv,
                                                      written))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn(torch, h2o, HC)
        times[label] = time.perf_counter() - t0
        say(f"ingest and persistence ({label}): {times[label]:.1f} s, "
            + _peak_gib(torch, held).replace("train()", "the run"))
        gc.collect()
    from h2o3_tpu_torch.io import columnar
    say("ingest and persistence, runs (ao)-(ap): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in sorted(times.items()))
        + f"; total {time.perf_counter() - t_all:.1f} s; the columnar "
        f"readers were not driven (available here: "
        f"{columnar.available_formats()}; the CPU tests drive them)")


# ---------------------------------------------------------------------------
# runs (aq)-(as): munging through h2o3_tpu_torch.rapids at db-benchmark's
# 1e7 sizes
def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _db_frame(torch, cols, levels, key, dev):
    """A Frame of f32 columns made on the device from {name: f32 values}
    and {name: levels or None} (integer codes and keys below 2^24 are
    exact in f32)."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, T_NUM, Vec
    return Frame(list(cols), [
        Vec.from_tensor(torch.from_numpy(np.array(v, np.float32)).to(dev),
                        T_CAT if levels.get(name) is not None else T_NUM,
                        levels.get(name))
        for name, v in cols.items()], key)


def _np_of(fr, j):
    return fr.vecs[j].as_f32().cpu().numpy().astype(np.float64)


def _drop_new(before):
    """Every store key made since `before` removed (a query's temps)."""
    from h2o3_tpu_torch.core.kvstore import DKV
    for k in set(DKV.keys()) - before:
        DKV.remove(k)


def _twice(torch, h2o, expr):
    """A Rapids expression run twice, as db-benchmark runs each question:
    both results and both times (each ending in a synchronise)."""
    out = []
    for _ in range(2):
        _sync(torch)
        t0 = time.perf_counter()
        r = h2o.rapids(expr)
        _sync(torch)
        out.append((r, time.perf_counter() - t0))
    return out


def _np_groups(keys):
    """Groups of non-negative integer key columns in sorted tuple order:
    the key tuples, each row's group, the group sizes."""
    comb = np.zeros(keys[0].size, np.int64)
    for k in keys:
        comb = comb * (int(k.max()) + 1) + k.astype(np.int64)
    _, first, inv, cnt = np.unique(comb, return_index=True,
                                   return_inverse=True, return_counts=True)
    return [k[first] for k in keys], inv.reshape(-1), cnt


def _same_bits(torch, a, b):
    return all(torch.equal(u.as_f32().view(torch.int32),
                           v.as_f32().view(torch.int32))
               for u, v in zip(a.vecs, b.vecs))


def _spill_arrays(tmp, tag, obj, limit=1 << 20):
    """obj with every numpy array above `limit` bytes saved under tmp as
    .npy and replaced by {"npy": path}: the host worker's large results
    cross as files, read back memory-mapped by _load_arrays."""
    if isinstance(obj, np.ndarray) and obj.nbytes > limit:
        path = os.path.join(tmp, f"{tag}.npy")
        np.save(path, obj)
        return {"npy": path}
    if isinstance(obj, dict):
        return {k: _spill_arrays(tmp, f"{tag}_{k}", v, limit)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_spill_arrays(tmp, f"{tag}_{j}", v, limit)
                         for j, v in enumerate(obj))
    return obj


def _load_arrays(obj):
    if isinstance(obj, dict):
        if list(obj) == ["npy"]:
            return np.load(obj["npy"], mmap_mode="r")
        return {k: _load_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_load_arrays(v) for v in obj)
    return obj


def _db_columns(cols):
    """{name: (values, levels)} as the frame holds it: f32 values (codes,
    keys below 2^24 and numbers) and the levels apart."""
    return ({name: np.asarray(v, np.float32) for name, (v, _) in
             cols.items()}, {name: lv for name, (_, lv) in cols.items()})


def groupby_wants(c, n):
    """float64 numpy's answers to (aq)'s questions over the f32 values c
    of G1's columns."""
    v1, v2, v3 = c["v1"], c["v2"], c["v3"]
    cache = {}

    def groups(*names):
        if names not in cache:
            cache[names] = _np_groups([c[m] for m in names])
        return cache[names]

    def sums(inv, x):
        return np.bincount(inv, weights=x)

    w = {}
    keys, inv, cnt = groups("id1")
    w["q1"] = {"keys": keys, "sum_v1": sums(inv, v1)}
    keys, inv, cnt = groups("id1", "id2")
    w["q2"] = {"keys": keys, "sum_v1": sums(inv, v1)}
    keys, inv, cnt = groups("id3")
    w["q3"] = {"keys": keys, "sum_v1": sums(inv, v1),
               "mean_v3": sums(inv, v3) / cnt}
    order = np.argsort(inv, kind="stable")
    start = np.cumsum(cnt) - cnt
    w["q7"] = {"groups": cnt.size,
               "range": np.maximum.reduceat(v1[order], start)
               - np.minimum.reduceat(v2[order], start)}
    keys, inv, cnt = groups("id4")
    w["q4"] = {"keys": keys, "means": [sums(inv, x) / cnt
                                       for x in (v1, v2, v3)]}
    keys, inv, cnt = groups("id6")
    w["q5"] = {"keys": keys, "sums": [sums(inv, x) for x in (v1, v2, v3)]}
    keys, inv, cnt = groups("id4", "id5")
    # medians as numpy's nanmedian gives them over the f32 values
    x32 = v3.astype(np.float32)
    order = np.lexsort((x32, inv))
    xs = x32[order]
    start = np.cumsum(cnt) - cnt
    lo, hi = xs[start + (cnt - 1) // 2], xs[start + cnt // 2]
    med = np.where(cnt % 2 == 1, lo, (lo + hi) / np.float32(2))
    mean = sums(inv, v3) / cnt
    w["q6"] = {"keys": keys, "median": med.astype(np.float64),
               "sd": np.sqrt(sums(inv, (v3 - mean[inv]) ** 2) / (cnt - 1))}
    order = np.lexsort((-v3, c["id6"]))
    g = c["id6"][order]
    new = np.concatenate([[True], g[1:] != g[:-1]])
    pos = np.arange(n)
    start = np.maximum.accumulate(np.where(new, pos, 0))
    top = order[pos - start < 2]
    want = np.lexsort((c["v3"][top], c["id6"][top]))
    w["q8"] = {"rows": top.size, "id6": c["id6"][top][want],
               "v3": v3[top][want]}
    keys, inv, cnt = groups("id1", "id2", "id3", "id4", "id5", "id6")
    w["q10"] = {"keys": keys, "sum_v3": sums(inv, v3),
                "count": cnt.astype(np.float64)}
    return w


def munger_wants(c, n):
    """(as)'s inputs beside G1 (v3 with 1% NAs, the pivot's slice) and
    float64 numpy's answer to each munger over the f32 values c."""
    v1, v2, v3, id4 = c["v1"], c["v2"], c["v3"], c["id4"]
    rng = np.random.default_rng(GB_SEED + 1)
    v3na = v3.copy()
    v3na[rng.random(n) < 0.01] = np.nan
    npiv = min(PIVOT_ROWS, n)
    o = np.lexsort((-v3, id4))
    br = np.float32([0, 25, 50, 75, 100])
    code = np.searchsorted(br, v3.astype(np.float32), "left") - 1
    r = np.lexsort((v3, id4))
    g = id4[r]
    new = np.concatenate([[True], g[1:] != g[:-1]])
    pos = np.arange(n)
    rank = np.empty(n)
    rank[r] = pos - np.maximum.accumulate(np.where(new, pos, 0)) + 1
    _, inv, _ = _np_groups([id4])
    return {"v3na": v3na, "pivot": v3[:npiv].copy(),
            "sort": [id4[o], v3[o], v1[o]],
            "cut": np.where((code < 0) | (code >= 4), np.nan, code),
            "fill": [_fill_np(v3na, 2, True), _fill_np(v3na, 2, False)],
            "rank": rank,
            "melt": [np.tile(id4, 3), np.repeat([0.0, 1.0, 2.0], n),
                     np.concatenate([v1, v2, v3])],
            "cor": np.corrcoef(np.stack([v1, v2, v3])),
            "scale": [(x - x.mean()) / x.std(ddof=1) for x in (v1, v2, v3)],
            "ifelse": np.where(v3 > 50, v1, v2),
            "cumsum": np.cumsum(v1.astype(np.float32)).astype(np.float64),
            "chain": 2 * np.bincount(inv, weights=v1)}


def groupby_data(tmp, n=GB_N, k=GB_K):
    """(aq) and (as)'s host work, in the host worker: G1's columns as the
    frame holds them, and every numpy answer (aq)'s questions and (as)'s
    mungers are held against. The large arrays come back as files."""
    t0 = time.perf_counter()
    cols, levels = _db_columns(groupby_columns(n, k, GB_SEED))
    t_gen = time.perf_counter() - t0
    c = {name: v.astype(np.float64) for name, v in cols.items()}
    t0 = time.perf_counter()
    out = {"cols": cols, "levels": levels, "aq": groupby_wants(c, n)}
    t_aq = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["as"] = munger_wants(c, n)
    out["seconds"] = (t_gen, t_aq, time.perf_counter() - t0)
    return _spill_arrays(tmp, f"gb{n}", out)


JOIN_QUESTIONS = [("q1 small inner on int", "small", "id1", "inner"),
                  ("q2 medium inner on int", "medium", "id2", "inner"),
                  ("q3 medium left on int", "medium", "id2", "left"),
                  ("q4 medium inner on factor", "medium", "id5", "inner"),
                  ("q5 big inner on int", "big", "id3", "inner"),
                  ("q6 medium outer on int", "medium", "id2", "outer")]


def join_wants(x, tabs):
    """float64 numpy's answers to (ar)'s questions: each x row's matches
    (a factor id<k> matches as its key), the joined rows, the sums of v1
    and v2 over them, the names, q3's NaN rows, q6's NaN counts."""
    v1 = x["v1"][0].astype(np.float32).astype(np.float64)
    out = {}
    for label, side, key, how in JOIN_QUESTIONS:
        tab = tabs[side]
        ikey = {"id5": "id2"}.get(key, key)
        rk = tab[ikey][0]
        uk, rcnt = np.unique(rk, return_counts=True)
        v2 = tab["v2"][0].astype(np.float32).astype(np.float64)
        v2sum = np.bincount(np.searchsorted(uk, rk), weights=v2)
        pos = np.clip(np.searchsorted(uk, x[ikey][0]), 0, uk.size - 1)
        hit = uk[pos] == x[ikey][0]
        cnt = np.where(hit, rcnt[pos], 0)
        xrows = cnt if how == "inner" else np.maximum(cnt, 1)
        w = {"rows": int(xrows.sum()), "s1": float((v1 * xrows).sum()),
             "s2": float(np.where(hit, v2sum[pos], 0.0).sum())}
        lnames = list(x)
        rnames = [c for c in tab if c != key]
        if how == "outer":
            # the right rows x's keys miss, once each; pandas' _x and _y
            lone = ~np.isin(rk, x[ikey][0])
            w["rows"] += int(lone.sum())
            w["s2"] += float(v2[lone].sum())
            w["lone"], w["nohit"] = int(lone.sum()), int((~hit).sum())
            clash = set(lnames) & set(rnames)
            w["names"] = [c + "_x" if c in clash else c for c in lnames] + [
                c + "_y" if c in clash else c for c in rnames]
        else:
            w["names"] = lnames + [
                (c if c not in lnames else c + "_y") for c in rnames]
        if how == "left":
            w["nan_rows"] = np.repeat(~hit, np.maximum(cnt, 1))
        out[label] = w
    return out


def join_data(tmp, n=JN_N, n1=None, n2=None):
    """(ar)'s host work, in the host worker: J1's four tables as the
    frames hold them and every numpy answer of (ar)'s questions."""
    t0 = time.perf_counter()
    x, small, medium, big = join_tables(n, JN_SEED, n1, n2)
    t_gen = time.perf_counter() - t0
    tabs = {"small": small, "medium": medium, "big": big}
    t0 = time.perf_counter()
    wants = join_wants(x, tabs)
    out = {"tables": {t: _db_columns(tab) for t, tab in
                      (("x", x), *tabs.items())},
           "wants": wants,
           "seconds": (t_gen, time.perf_counter() - t0)}
    return _spill_arrays(tmp, f"jn{n}", out)


def groupby_run(torch, h2o, n=GB_N, k=GB_K, data=None):
    """Run (aq): db-benchmark's group-by questions 1-8 and 10 on
    G1_<n>_<k>_0_0, each twice, each checked against float64 numpy over
    the frame's values (`groupby_wants`, from the host worker's
    `groupby_data`: `data` is its result, made here when None). Returns
    the frame and the munger answers for (as)."""
    from h2o3_tpu_torch.core.kvstore import DKV
    dev = h2o.cloud().device
    if data is None:
        tmp = tempfile.mkdtemp(prefix="h2o3_gb_")
        data = host_result(host_submit(None, groupby_data, tmp, n, k),
                           "(aq) the group-by answers")
    d = _load_arrays(data)
    t0 = time.perf_counter()
    fr = _db_frame(torch, d["cols"], d["levels"], "gb_x", dev)
    t_gen, t_aq, t_as = d["seconds"]
    say(f"munging (aq) G1_{n:.0e}_{k:.0e}_0_0 uploaded in "
        f"{time.perf_counter() - t0:.1f} s (made in {t_gen:.1f} s, the "
        f"numpy answers in {t_aq:.1f} s, (as)'s in {t_as:.1f} s, in the "
        f"host worker): {fr.nrows} rows, "
        f"{[len(lv) for lv in d['levels'].values() if lv is not None]} "
        f"levels")
    w = d["aq"]

    def keys_equal(r, keys):
        for j, kv in enumerate(keys):
            check(np.array_equal(_np_of(r, j), kv), f"{r.names[j]} keys")
        check(r.nrows == keys[0].size, "group count")

    def q1(r):
        keys_equal(r, w["q1"]["keys"])
        check(np.array_equal(_np_of(r, 1), w["q1"]["sum_v1"]), "q1 sum v1")

    def q2(r):
        keys_equal(r, w["q2"]["keys"])
        check(np.array_equal(_np_of(r, 2), w["q2"]["sum_v1"]), "q2 sum v1")

    def q3(r):
        keys_equal(r, w["q3"]["keys"])
        check(np.array_equal(_np_of(r, 1), w["q3"]["sum_v1"]), "q3 sum v1")
        rel(_np_of(r, 2), w["q3"]["mean_v3"], 1e-6, "q3 mean v3")

    def q4(r):
        keys_equal(r, w["q4"]["keys"])
        for j, mean in enumerate(w["q4"]["means"]):
            rel(_np_of(r, 1 + j), mean, 1e-6, f"q4 mean {j}")

    def q5(r):
        keys_equal(r, w["q5"]["keys"])
        s1, s2, s3 = w["q5"]["sums"]
        check(np.array_equal(_np_of(r, 1), s1), "q5 sum v1")
        check(np.array_equal(_np_of(r, 2), s2), "q5 sum v2")
        rel(_np_of(r, 3), s3, 1e-6, "q5 sum v3")

    def q6(r):
        keys_equal(r, w["q6"]["keys"])
        check(np.array_equal(_np_of(r, 2), w["q6"]["median"]),
              "q6 median v3")
        rel(_np_of(r, 3), w["q6"]["sd"], 1e-5, "q6 sd v3")

    def q7(r):
        check(r.nrows == w["q7"]["groups"]
              and np.array_equal(_np_of(r, 0), w["q7"]["range"]),
              "q7 max v1 - min v2")

    def q8(r):
        got_g, got_v = _np_of(r, 5), _np_of(r, 8)
        got = np.lexsort((got_v, got_g))
        check(r.nrows == w["q8"]["rows"]
              and np.array_equal(got_g[got], w["q8"]["id6"])
              and np.array_equal(got_v[got], w["q8"]["v3"]),
              "q8 the largest two v3 by id6")

    def q10(r):
        keys_equal(r, w["q10"]["keys"])
        rel(_np_of(r, 6), w["q10"]["sum_v3"], 1e-6, "q10 sum v3")
        check(np.array_equal(_np_of(r, 7), w["q10"]["count"]), "q10 count")

    questions = [
        ("q1 sum v1 by id1", "(GB gb_x [0] sum 6 \"rm\")", q1),
        ("q2 sum v1 by id1:id2", "(GB gb_x [0 1] sum 6 \"rm\")", q2),
        ("q3 sum v1 mean v3 by id3",
         "(GB gb_x [2] sum 6 \"rm\" mean 8 \"rm\")", q3),
        ("q4 mean v1:v3 by id4",
         "(GB gb_x [3] mean 6 \"rm\" mean 7 \"rm\" mean 8 \"rm\")", q4),
        ("q5 sum v1:v3 by id6",
         "(GB gb_x [5] sum 6 \"rm\" sum 7 \"rm\" sum 8 \"rm\")", q5),
        ("q6 median sd v3 by id4 id5",
         "(GB gb_x [3 4] median 8 \"rm\" sd 8 \"rm\")", q6),
        ("q7 max v1 - min v2 by id3",
         "({g . (- (cols g [1]) (cols g [2]))} "
         "(GB gb_x [2] max 6 \"rm\" min 7 \"rm\"))", q7),
        ("q8 largest two v3 by id6",
         "(rows gb_x (<= (cols (rank_within_groupby (cbind gb_x "
         "(* (cols gb_x [8]) -1)) [5] [9] [1] \"r\" 0) [10]) 2))", q8),
        ("q10 sum v3 count by id1:id6",
         "(GB gb_x [0 1 2 3 4 5] sum 8 \"rm\" nrow 8 \"rm\")", q10),
    ]
    times = {}
    for label, expr, chk in questions:
        before = set(DKV.keys())
        (r1, t1), (r2, t2) = _twice(torch, h2o, expr)
        tc = time.perf_counter()
        chk(r1)
        same = _same_bits(torch, r1, r2)
        if not same:
            chk(r2)
        if label.split()[0] in ("q1", "q10"):
            check(same, f"(aq) {label}: two runs differ")
        times[label.split()[0]] = (t1, t2)
        say(f"munging (aq) {label}: {t1:.3f} s, {t2:.3f} s "
            f"({n / t2:.3e} rows/s), {r1.nrows} rows out, the two runs "
            f"{'bit for bit' if same else 'differ in bits'}; the check "
            f"against numpy's answers "
            f"{host_seconds(time.perf_counter() - tc):.1f} s")
        del r1, r2
        _drop_new(before)
    return fr, d["as"], times


def rel(got, want, tol, what):
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                       1e-30)))
    check(err <= tol, f"{what}: relative error {err:.3g} above {tol}")


def join_run(torch, h2o, n=JN_N, n1=None, n2=None, data=None):
    """Run (ar): db-benchmark's join questions 1-5 on J1_<n>_NA_0_0 through
    (merge …), and q6, x outer-joined with medium, each twice; rows, the
    sums of v1 and v2 over the joined rows and the names against numpy,
    q3's NaN rows exactly, q6's NaN counts and its key in sorted order
    (`join_wants`, from the host worker's `join_data`: `data` is its
    result, made here when None)."""
    from h2o3_tpu_torch.core.kvstore import DKV
    dev = h2o.cloud().device
    if data is None:
        tmp = tempfile.mkdtemp(prefix="h2o3_jn_")
        data = host_result(host_submit(None, join_data, tmp, n, n1, n2),
                           "(ar) the join answers")
    d = _load_arrays(data)
    t0 = time.perf_counter()
    tables = d["tables"]
    fx = _db_frame(torch, *tables["x"], "jn_x", dev)
    rhs = {side: _db_frame(torch, *tables[side], f"jn_{side}", dev)
           for side in ("small", "medium", "big")}
    t_gen, t_np = d["seconds"]
    say(f"munging (ar) J1_{n:.0e}_NA_0_0 uploaded in "
        f"{time.perf_counter() - t0:.1f} s (made in {t_gen:.1f} s, the "
        f"numpy answers in {t_np:.1f} s, in the host worker): x "
        f"{fx.nrows}, small {rhs['small'].nrows}, medium "
        f"{rhs['medium'].nrows}, big {rhs['big'].nrows} rows")
    lnames = list(tables["x"][0])
    times = {}
    for label, side, key, how in JOIN_QUESTIONS:
        rf, w = rhs[side], d["wants"][label]
        rows, s1, s2 = w["rows"], w["s1"], w["s2"]
        before = set(DKV.keys())
        expr = (f"(merge jn_x jn_{side} {int(how != 'inner')} "
                f"{int(how == 'outer')} [{lnames.index(key)}] "
                f"[{list(tables[side][0]).index(key)}] \"auto\")")
        (r1, t1), (r2, t2) = _twice(torch, h2o, expr)
        t_check = time.perf_counter()
        for r in (r1, r2):
            check(list(r.names) == w["names"], f"(ar) {label}: names "
                  f"{r.names}, want {w['names']}")
            check(r.nrows == rows, f"(ar) {label}: {r.nrows} rows, numpy "
                  f"{rows}")
            w1 = r.vec("v1").as_f32().double()
            w2 = r.vec("v2").as_f32().double()
            g1, g2 = float(torch.nansum(w1)), float(torch.nansum(w2))
            check(abs(g1 - s1) <= 1e-9 * abs(s1)
                  and abs(g2 - s2) <= 1e-9 * abs(s2),
                  f"(ar) {label}: sums {g1}, {g2}; numpy {s1}, {s2}")
            if how == "left":
                check(np.array_equal(torch.isnan(w2).cpu().numpy(),
                                     w["nan_rows"]), f"(ar) {label}: NaN "
                      "rows")
            if how == "outer":
                kk = r.vec(key).as_f32()
                check(int(torch.isnan(w1).sum()) == w["lone"]
                      and int(torch.isnan(w2).sum()) == w["nohit"]
                      and not bool(torch.isnan(kk).any())
                      and bool((kk[1:] >= kk[:-1]).all()),
                      f"(ar) {label}: NaN counts or key order")
        times[label.split()[0]] = (t1, t2)
        tc = host_seconds(time.perf_counter() - t_check)
        say(f"munging (ar) {label}: {t1:.3f} s, {t2:.3f} s, {rows} rows "
            f"out ({(n + rf.nrows) / t2:.3e} input rows/s), names "
            f"{r1.names[len(lnames):]}; checks {tc:.1f} s")
        del r1, r2
        _drop_new(before)
    return times


def _fill_np(x, maxlen, forward=True):
    """Forward (or backward) fill of NAs at most `maxlen` rows from the
    last valid value, in numpy."""
    y = x if forward else x[::-1]
    idx = np.where(~np.isnan(y), np.arange(y.size), -1)
    last = np.maximum.accumulate(idx)
    src = y[np.maximum(last, 0)]
    ok = np.isnan(y) & (last >= 0) & (np.arange(y.size) - last <= maxlen)
    out = np.where(ok, src, y)
    return out if forward else out[::-1]


def mungers_run(torch, h2o, fr, w):
    """Run (as): the card's mungers on (aq)'s frame, each timed and held
    against numpy (`munger_wants`, from the host worker: `w`); a Rapids
    chain of temps in a session; create_frame."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.rapids import Session
    dev = h2o.cloud().device
    n = fr.nrows
    _db_frame(torch, {"v3na": w["v3na"]}, {}, "gb_na", dev)
    npiv = len(w["pivot"])
    i = np.arange(npiv)
    _db_frame(torch, {"i": i // 100, "c": i % 100, "v": w["pivot"]}, {},
              "gb_pv", dev)
    out = {}

    def run(label, expr, chk):
        before = set(DKV.keys())
        _sync(torch)
        t0 = time.perf_counter()
        r = h2o.rapids(expr)
        _sync(torch)
        out[label] = time.perf_counter() - t0
        with host_only():
            chk(r)
        del r
        _drop_new(before)

    def sort_chk(r):
        for j, want in zip((3, 8, 6), w["sort"]):
            check(np.array_equal(_np_of(r, j), want), "sort order")

    def cut_chk(r):
        check(np.array_equal(_np_of(r, 0), w["cut"], equal_nan=True), "cut")

    def fill_chk(forward):
        want = w["fill"][0 if forward else 1]
        return lambda r: check(np.array_equal(_np_of(r, 0), want,
                                              equal_nan=True), "fillna")

    def rank_chk(r):
        check(np.array_equal(_np_of(r, 9), w["rank"]), "rank_within_groupby")

    def melt_chk(r):
        check(r.nrows == 3 * n and all(np.array_equal(_np_of(r, j), want)
                                       for j, want in enumerate(w["melt"])),
              "melt")

    def pivot_chk(r):
        want = np.asarray(w["pivot"]).reshape(-1, 100)
        got = np.column_stack([_np_of(r, 1 + j) for j in range(100)])
        check(r.nrows == npiv // 100 and np.array_equal(got, want)
              and r.names[1] == "0.0", "pivot")

    def cor_chk(r):
        got = np.column_stack([_np_of(r, j) for j in range(3)])
        check(np.max(np.abs(got - w["cor"])) <= 1e-9, "cor")

    def scale_chk(r):
        for j, z in enumerate(w["scale"]):
            check(np.max(np.abs(_np_of(r, j) - z)) <= 1e-5, "scale")

    def ifelse_chk(r):
        check(np.array_equal(_np_of(r, 0), w["ifelse"]), "ifelse")

    def cumsum_chk(r):
        check(np.array_equal(_np_of(r, 0), w["cumsum"]), "cumsum")

    run("sort by id4 asc, v3 desc", "(sort gb_x [3 8] [1 0])", sort_chk)
    run("cut", "(cut (cols gb_x [8]) [0 25 50 75 100])", cut_chk)
    run("fillna forward", "(h2o.fillna gb_na \"forward\" 0 2)",
        fill_chk(True))
    run("fillna backward", "(h2o.fillna gb_na \"backward\" 0 2)",
        fill_chk(False))
    run("rank_within_groupby", "(rank_within_groupby gb_x [3] [8] [1] "
        "\"r\" 0)", rank_chk)
    run("melt", "(melt gb_x [3] [6 7 8] \"variable\" \"value\" 0)",
        melt_chk)
    run("pivot", "(pivot gb_pv \"i\" \"c\" \"v\")", pivot_chk)
    run("cor", "(cor (cols gb_x [6 7 8]))", cor_chk)
    run("scale", "(scale (cols gb_x [6 7 8]) 1 1)", scale_chk)
    run("ifelse", "(ifelse (> (cols gb_x [8]) 50) (cols gb_x [6]) "
        "(cols gb_x [7]))", ifelse_chk)
    run("cumsum", "(cumsum (cols gb_x [6]))", cumsum_chk)
    # a session's chain of temps
    s = Session("as_chain")
    _sync(torch)
    t0 = time.perf_counter()
    h2o.rapids("(tmp= as_a (cols gb_x [6 7 8]))", s)
    h2o.rapids("(tmp= as_b (* as_a 2))", s)
    g = h2o.rapids("(tmp= as_c (GB (cbind (cols gb_x [3]) as_b) [0] sum 1 "
                   "\"rm\"))", s)
    h2o.rapids("(rm as_a)", s)
    check(DKV.get("as_a") is None and np.array_equal(
        _np_of(g, 1), w["chain"]), "session chain")
    s.end()
    check(all(DKV.get(k) is None for k in ("as_b", "as_c")),
          "session temps left after end()")
    _sync(torch)
    out["a session's chain"] = time.perf_counter() - t0
    del g
    # create_frame at its defaults
    t0 = time.perf_counter()
    cf = h2o.create_frame(rows=min(CF_ROWS, n), cols=CF_COLS, seed=22)
    _sync(torch)
    out["create_frame"] = time.perf_counter() - t0
    kinds = [v.type for v in cf.vecs]
    na = float(np.mean([np.isnan(v.as_f32().cpu().numpy()).mean()
                        for v in cf.vecs]))
    check(cf.shape == (min(CF_ROWS, n), CF_COLS)
          and kinds.count("enum") == CF_COLS // 5 and 0.005 < na < 0.02,
          f"create_frame: {cf.shape}, {kinds.count('enum')} categorical, "
          f"NA share {na}")
    DKV.remove(cf.key)
    for k in ("gb_na", "gb_pv"):
        DKV.remove(k)
    say("munging (as) " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                    out.items())
        + f"; create_frame {cf.shape[0]} x {cf.shape[1]}, NA share "
        f"{na:.4f}")
    return out


def phase_munging(torch, h2o, HC, gb_n=GB_N, jn_n=JN_N, data=None):
    """Runs (aq), (as) and (ar), each timed with its peak device memory,
    after every earlier frame is dropped from the store. `data`: the host
    worker's (groupby_data, join_data) futures as main() started them, or
    None to make the answers here."""
    from h2o3_tpu_torch.core.kvstore import DKV
    DKV.clear()
    gc.collect()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.empty_cache()
    t_all = time.perf_counter()
    times = {}
    n1 = None if jn_n >= 10**7 else 10
    n2 = None if jn_n >= 10**5 else 100
    tmp = None
    if data is None:
        tmp = tempfile.mkdtemp(prefix="h2o3_munging_")
        data = (host_submit(None, groupby_data, tmp, gb_n, GB_K),
                host_submit(None, join_data, tmp, jn_n, n1, n2))

    def start():
        if cuda:
            _sync(torch)
            torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def peak():
        return (f"peak HBM {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                "GiB") if cuda else "on the CPU"

    try:
        t0 = start()
        fr, w_as, _ = groupby_run(torch, h2o, n=gb_n, data=host_result(
            data[0], "(aq) the group-by answers"))
        times["aq"] = time.perf_counter() - t0
        say(f"munging (aq): {times['aq']:.1f} s, {peak()}")
        t0 = start()
        mungers_run(torch, h2o, fr, w_as)
        times["as"] = time.perf_counter() - t0
        say(f"munging (as): {times['as']:.1f} s, {peak()}")
        del fr, w_as
        DKV.clear()
        gc.collect()
        t0 = start()
        join_run(torch, h2o, n=jn_n, n1=n1, n2=n2,
                 data=host_result(data[1], "(ar) the join answers"))
        times["ar"] = time.perf_counter() - t0
        say(f"munging (ar): {times['ar']:.1f} s, {peak()}")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    DKV.clear()
    gc.collect()
    say("munging, runs (aq)-(as): "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in times.items())
        + f"; total {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# Runs (at)-(av), phase_export_explain: (b)'s GBM, (k)'s GLM, (q)'s net and
# (t)'s KMeans through their artifacts and back, the explanation of (b)'s
# model, and AutoML at HIGGS width. (at) and (au) launch no kernel of
# ops/hist_cuda.py (scoring walks the trees in plain PyTorch); (av)'s GBM
# steps train on the binned engine and launch them.
def _np_tree_walk(col, thr, nal, val, depth, X):
    """The sum over trees of each row's leaf value, walked as the POJO's
    score0 walks its arrays (x > thr right, NaN by the NA direction)."""
    T, nodes = col.shape
    rows = np.arange(X.shape[0])
    out = np.zeros(X.shape[0])
    for t in range(T):
        node = np.zeros(X.shape[0], np.int64)
        for _ in range(depth):
            c = col[t, node]
            x = X[rows, np.maximum(c, 0)]
            right = np.where(np.isnan(x), nal[t, node] == 0,
                             x > thr[t, node])
            node = np.where(c < 0, node, 2 * node + 1 + right)
        out += val[t, node]
    return out


def _pojo_arrays(src, prefix):
    """The tree arrays of a POJO's source, as test_pojo.py pulls them."""
    def arr(name, dtype):
        m = re.search(rf"{prefix}_{name}\s*=\s*\{{(.*?)\}};", src, re.S)
        vals = [v.strip().rstrip("f") for v in m.group(1).split(",")]
        return np.array([dtype(v) for v in vals if v])
    T = int(re.search(rf"{prefix}_NTREES = (\d+)", src).group(1))
    depth = int(re.search(rf"{prefix}_DEPTH = (\d+)", src).group(1))
    return (arr("COL", int).reshape(T, -1), arr("THR", float).reshape(T, -1),
            arr("NAL", int).reshape(T, -1), arr("VAL", float).reshape(T, -1),
            depth)


def _reached(torch, col):
    """(T, nodes) bool: the heap nodes a walk from the root reaches."""
    inner = col >= 0
    reach = torch.zeros_like(inner)
    reach[:, 0] = True
    for i in range(col.shape[1] // 2):
        reach[:, 2 * i + 1] |= reach[:, i] & inner[:, i]
        reach[:, 2 * i + 2] |= reach[:, i] & inner[:, i]
    return reach


def _raw_matrix(fr, cols):
    """Host float64 columns of a frame (the oracles' rows)."""
    return np.column_stack([fr.vec(c).to_numpy() for c in cols])


def _kept_models(torch, h2o, fr, valid, blobs, label="export and import (at)"):
    """(b), (k), (q), (t) as the earlier runs left them, or each trained
    again at its run's settings (the phase run alone)."""
    out = dict(KEPT)
    fresh = []
    if "b" not in out:
        m = h2o.H2OGradientBoostingEstimator(**HIGGS_DEFAULT)
        m.train(y="y", training_frame=fr, validation_frame=valid)
        out["b"] = m
        fresh.append("b")
    if "k" not in out:
        m = h2o.H2OGeneralizedLinearEstimator(**GLM_K)
        m.train(y="y", training_frame=fr, validation_frame=valid)
        out["k"] = m
        fresh.append("k")
    if "q" not in out:
        m = h2o.H2ODeepLearningEstimator(**DL_HIGGS)
        m.train(y="y", training_frame=fr, validation_frame=valid)
        out["q"] = m
        fresh.append("q")
    if "t" not in out:
        m = h2o.H2OKMeansEstimator(**KM_BLOBS)
        m.train(training_frame=blobs)
        out["t"] = m
        fresh.append("t")
    torch.cuda.synchronize()
    say(f"{label}: models of runs (b), (k), (q), (t): "
        f"{'trained again ' + str(fresh) if fresh else 'kept from the runs'}")
    return out


def mojo_scores(paths, xv_path, xb_path, pojo_path, xd):
    """(at)'s float64 scorers, in the host worker: (b)'s native MOJO
    through its numpy scorer on the validation rows (a frame of them on a
    CPU cloud, built a column at a time as on the card), the H2O-3 MOJO
    oracles of (k), (q) and (t) on their matrices, and (b)'s POJO arrays
    replayed on `xd`. Returns each scorer's output and seconds."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.core.frame import Frame
    from h2o3_tpu_torch.genmodel import h2o_mojo as HM
    Xv, Xb = np.load(xv_path), np.load(xb_path)
    out = {}

    def native():
        gn = h2o.import_mojo(paths["native"])
        fr = Frame.from_dict({f"x{j}": Xv[:, j] for j in range(HIGGS_C)})
        t0 = time.perf_counter()
        pn = gn.predict(fr).vec("p1").to_numpy()
        return pn, time.perf_counter() - t0
    out["native"] = _cpu_cloud(h2o, native)
    for key in ("k", "q", "t"):
        t0 = time.perf_counter()
        o = HM.import_h2o_mojo_any(paths[key])
        t_i = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = o.predict_raw(Xb if key == "t" else Xv)
        out[key] = (raw, t_i, time.perf_counter() - t0)
    with open(pojo_path) as f:
        col, thr, nal, val, depth = _pojo_arrays(f.read(), "T")
    out["pojo"] = _np_tree_walk(col, thr, nal, val, depth, xd)
    return out


def export_import_run(torch, h2o, HC, fr, valid, models, blobs_valid, tmp,
                      host=None):
    """Run (at). The float64 scorers run in `host` (a HostWorker, or here
    when None: mojo_scores) from the artifacts written to `tmp`; the
    returned function waits for them and holds each against predict on
    the card (the phase calls it after (au) and (av), which keep the card
    busy meanwhile)."""
    from h2o3_tpu_torch.genmodel import h2o_mojo as HM
    gbm = models["b"]
    lr = float(gbm.params["learn_rate"])
    HC.reset_launches()
    # (b)'s GBM as an H2O-3 MOJO, imported, scored on all of fr on the card
    t0 = time.perf_counter()
    path = gbm.download_mojo(os.path.join(tmp, "gbm_h2o3.zip"), format="h2o3")
    t_exp = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    g = h2o.import_mojo(path)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = g.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p_got = got.vec("p1").as_f32()
    t0 = time.perf_counter()
    want = gbm.predict(fr)
    torch.cuda.synchronize()
    t_own = time.perf_counter() - t0
    p_want = want.vec("p1").as_f32()
    d_p = float((p_got - p_want).abs().max())
    imp, own = g._ref.trees_k[0], gbm._trees.to(p_got.device)
    reach = _reached(torch, own.col)
    node = reach & (own.col >= 0)
    leaf = reach & (own.col < 0)
    same_col = torch.equal(imp.col[reach], own.col[reach])
    same_thr = torch.equal(imp.thr[node].view(torch.int32),
                           own.thr[node].view(torch.int32))
    same_nal = torch.equal(imp.na_left[node], own.na_left[node])
    same_val = torch.equal(imp.value[leaf], own.value[leaf] * torch.tensor(
        lr, dtype=torch.float32, device=own.value.device))
    say(f"export and import (at): (b)'s GBM ({own.ntrees} trees, depth "
        f"{own.depth}) as an H2O-3 MOJO: export {t_exp:.3f} s ({mb:.3f} MB, "
        f"{mb / t_exp:.1f} MB/s), import_mojo {t_imp:.3f} s "
        f"({mb / t_imp:.1f} MB/s); H2OGenericEstimator.predict of "
        f"{fr.nrows} rows on the card {t_pred:.3f} s "
        f"({fr.nrows / t_pred:.0f} rows/s; the model's own predict "
        f"{t_own:.3f} s); {int(reach.sum())} nodes reached: col "
        f"{same_col}, thr {same_thr}, na_left {same_nal} bit for bit, "
        f"leaves f32(value*lr) {same_val}; probabilities max diff "
        f"{d_p:.3g} (limit {EXPORT_TOL})")
    check(same_col and same_thr and same_nal and same_val,
          "export and import (at): the imported trees route otherwise")
    check(d_p <= EXPORT_TOL, f"export and import (at): probabilities "
          f"differ by {d_p}")
    del got, want, p_got, p_want
    # the other artifacts, scored in the host worker
    paths, sizes, t_e = {}, {}, {}
    t0 = time.perf_counter()
    paths["native"] = gbm.download_mojo(os.path.join(tmp, "gbm.zip"))
    t_e["native"] = time.perf_counter() - t0
    for key in ("k", "q", "t"):
        t0 = time.perf_counter()
        paths[key] = models[key].download_mojo(
            os.path.join(tmp, f"{key}.zip"), format="h2o3")
        t_e[key] = time.perf_counter() - t0
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    t0 = time.perf_counter()
    pojo_path = gbm.download_pojo(tmp)
    t_pojo = time.perf_counter() - t0
    xv_path, xb_path = (os.path.join(tmp, f"{k}.npy") for k in ("xv", "xb"))
    mt = models["t"]
    np.save(xv_path, _raw_matrix(valid, [f"x{j}" for j in range(HIGGS_C)]))
    np.save(xb_path, _raw_matrix(blobs_valid, mt._dinfo.cat_cols
                                 + mt._dinfo.num_cols))
    xd = gbm._dinfo.matrix(valid)[:POJO_ROWS].cpu().double().numpy()
    scores = host_submit(host, mojo_scores, paths, xv_path, xb_path,
                         pojo_path, xd)
    # the card's answers they are held against
    pv = gbm.predict(valid).vec("p1").to_numpy()
    preds = {key: models[key].predict(blobs_valid if key == "t" else
                                      valid).to_numpy()
             for key in ("k", "q", "t")}
    launches = {k: v for k, v in HC.LAUNCHES.items() if v}
    f0, pojo_mb = float(gbm._f0), os.path.getsize(pojo_path) / 1e6

    def finish():
        out = host_result(scores, "(at) the float64 scorers")
        pn, t_npred = out["native"]
        d_n = float(np.abs(pn - pv).max())
        nmb = sizes["native"] / 1e6
        say(f"export and import (at): native MOJO of (b): export "
            f"{t_e['native']:.3f} s ({nmb:.3f} MB, "
            f"{nmb / t_e['native']:.1f} MB/s); the numpy scorer on "
            f"{valid.nrows} validation rows (the matrix built a column at "
            f"a time) {t_npred:.3f} s ({valid.nrows / t_npred:.0f} rows/s, "
            f"in the host worker); max diff {d_n:.3g} (limit {EXPORT_TOL})")
        check(d_n <= EXPORT_TOL, f"export and import (at): native MOJO "
              f"differs by {d_n}")
        for key, label in (("k", "glm (k)"), ("q", "deeplearning (q)"),
                           ("t", "kmeans (t)")):
            raw, t_i, t_s = out[key]
            pred = preds[key]
            rows = pred.shape[0]
            if key == "t":
                diff = int((raw != pred[:, 0]).sum())
                ok = diff == 0
                what = f"{diff} rows in another cluster"
            else:
                diff = float(np.abs(raw[:, 1] - pred[:, 2]).max())
                ok = diff <= EXPORT_TOL
                what = (f"probabilities max diff {diff:.3g} (limit "
                        f"{EXPORT_TOL})")
            say(f"export and import (at): {label} as an H2O-3 MOJO: export "
                f"{t_e[key]:.3f} s ({sizes[key] / 1e3:.1f} kB), the oracle "
                f"loaded in {t_i:.3f} s, scored {rows} rows in {t_s:.3f} s "
                f"({rows / t_s:.0f} rows/s, float64 numpy in the host "
                f"worker); {what}")
            check(ok, f"export and import (at): {label}'s oracle: {what}")
        pj = 1.0 / (1.0 + np.exp(-(f0 + lr * out["pojo"])))
        d_j = float(np.abs(pj - pv[:POJO_ROWS]).max())
        say(f"export and import (at): POJO of (b): {pojo_mb:.3f} MB of "
            f"Java in {t_pojo:.3f} s; its arrays replayed on {POJO_ROWS} "
            f"rows: max diff {d_j:.3g} (limit {EXPORT_TOL})")
        check(d_j <= EXPORT_TOL, f"export and import (at): POJO differs by "
              f"{d_j}")
        say(f"export and import (at): kernel launches {launches} (scoring "
            "walks the trees in plain PyTorch)")
    return finish


def explain_run(torch, h2o, HC, valid, gbm):
    """Run (au): (b)'s model explained over the validation rows."""
    from h2o3_tpu_torch import explain_data as EX
    from h2o3_tpu_torch.core.frame import Frame, Vec
    out = {}
    for c in PDP_COLS:
        t0 = time.perf_counter()
        out[c] = EX.partial_dependence(gbm, valid, c, nbins=PDP_BINS)
        out[c]["s"] = time.perf_counter() - t0
    pd = out[PDP_COLS[0]]
    # one bin again: predict on the frame with the column set to its value
    g = pd["grid"][PDP_CHECK_BIN]
    n = valid.nrows
    dev = valid.vecs[0].device
    vf = Frame(valid.names, [
        Vec.from_tensor(torch.full((n,), g, dtype=torch.float32,
                                   device=dev))
        if c == PDP_COLS[0] else valid.vec(c) for c in valid.names])
    p = gbm.predict(vf).vec("p1").as_f32()
    w = gbm._dinfo.weights(vf)
    mu = float(torch.sum(p * w)) / max(float(torch.sum(w)), 1e-30)
    same = mu == pd["mean_response"][PDP_CHECK_BIN]
    say(f"explain (au): PDP of {PDP_COLS} at {PDP_BINS} bins over {n} rows: "
        + ", ".join(f"{c} {out[c]['s']:.3f} s (mean response "
                    f"{min(out[c]['mean_response']):.4f}-"
                    f"{max(out[c]['mean_response']):.4f})"
                    for c in PDP_COLS)
        + f"; bin {PDP_CHECK_BIN} of {PDP_COLS[0]} ({g:.6g}) against the "
        f"weighted mean of predict with the column set: {mu!r} vs "
        f"{pd['mean_response'][PDP_CHECK_BIN]!r}, bit for bit {same}")
    check(same, "explain (au): a PDP bin is not the mean of predict")
    t0 = time.perf_counter()
    grid, curves = EX.ice(gbm, valid, PDP_COLS[0], nbins=PDP_BINS,
                          row_fraction=ICE_ROWS / n)
    t_ice = time.perf_counter() - t0
    check(curves.shape == (ICE_ROWS, PDP_BINS)
          and np.isfinite(curves).all(), f"explain (au): ICE {curves.shape}")
    t0 = time.perf_counter()
    vi = EX.permutation_varimp(gbm, valid, metric="auc", seed=42)
    t_vi = time.perf_counter() - t0
    rank = [r["variable"] for r in vi]
    noise = max(abs(r["relative_importance"]) for r in vi
                if int(r["variable"][1:]) in NOISE_COLS)
    say(f"explain (au): ICE of {ICE_ROWS} rows x {PDP_BINS} bins "
        f"{t_ice:.3f} s; permutation importance (AUC) of {len(vi)} columns "
        f"{t_vi:.3f} s ({t_vi / len(vi):.3f} s a column): "
        + ", ".join(f"{r['variable']} {r['relative_importance']:.5f}"
                    for r in vi[:7])
        + f"; largest |delta AUC| of x7-x27 {noise:.3g} (limit {NOISE_DAUC})")
    check(rank[:2] == ["x0", "x1"], f"explain (au): importance order {rank}")
    check(noise < NOISE_DAUC, f"explain (au): a column the logit never "
          f"reads moves the AUC by {noise}")


def automl_run(torch, h2o, HC, fr):
    """Run (av): AutoML on the first AML_ROWS rows of the HIGGS frame."""
    from h2o3_tpu_torch.automl.automl import _steps
    from h2o3_tpu_torch.models.ensemble import H2OStackedEnsembleEstimator
    from h2o3_tpu_torch.models.model import _subframe
    dev = fr.vecs[0].device
    sub = _subframe(fr, torch.arange(AML_ROWS, device=dev))
    torch.cuda.synchronize()
    HC.reset_launches()
    t0 = time.perf_counter()
    aml = h2o.automl(project_name="chip_aml", **AML)
    aml.train(y="y", training_frame=sub)
    torch.cuda.synchronize()
    t_aml = time.perf_counter() - t0
    launches = dict(HC.LAUNCHES)
    log = aml.event_log
    secs = {e["message"][len("building "):]: log[i + 1]["t"] - e["t"]
            for i, e in enumerate(log[:-1])
            if e["message"].startswith("building ")}
    rows = aml.leaderboard_obj.as_list()
    say(f"automl (av): {AML} on {AML_ROWS} rows x {HIGGS_C} features: "
        f"{t_aml:.3f} s; each model's train() s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items())
        + "; leaderboard (auc): " + ", ".join(
            f"{r['step']} {r['auc']:.6f}" for r in rows)
        + f"; launches {launches}")
    on_path = ("radix", "fused", "hist", "route", "route_f")
    check(all(launches[k] > 0 for k in on_path),
          f"automl (av): a binned kernel never launched: {launches}")
    aucs = [r["auc"] for r in rows]
    check(aucs == sorted(aucs, reverse=True),
          "automl (av): the leaderboard is not sorted by AUC")
    steps = {n: (c, p) for n, c, p in _steps(AML["seed"])}
    base = [(r["step"], m) for r, m in aml.leaderboard_obj.rows
            if r["step"] in steps]
    best_cv = max(m._output.cross_validation_metrics.auc for _, m in base)
    check(best_cv > AML_AUC_BAR, f"automl (av): the best CV AUC {best_cv}")

    def alone(step, timed=False):
        """The step's estimator trained alone on the same folds: the same
        trees or coefficients as the run's model, bit for bit. Timed: each
        binned kernel wrapper's launch between two CUDA events, and the
        train() seconds. Returns (same, train s, the wrappers' ms)."""
        cls, params = steps[step]
        m = cls(**{"seed": AML["seed"], **params}, nfolds=AML["nfolds"],
                keep_cross_validation_predictions=True)
        timers = {name: EventTimer(torch, getattr(HC, name))
                  for name in RECORDED} if timed else {}
        saved = {name: getattr(HC, name) for name in timers}
        for name, tm in timers.items():
            setattr(HC, name, tm)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.train(y="y", training_frame=sub)
            torch.cuda.synchronize()
            t_train = time.perf_counter() - t0
        finally:
            for name, fn in saved.items():
                setattr(HC, name, fn)
        run_m = dict(base)[step]
        if m.algo == "glm":
            same = np.array_equal(m._state.beta, run_m._state.beta)
        else:
            same = all(torch.equal(getattr(m._trees, f),
                                   getattr(run_m._trees, f))
                       for f in ("col", "thr", "na_left", "value"))
        check(same, f"automl (av): {step} trained alone differs")
        return same, t_train, {k: t.ms() for k, t in timers.items()}

    # the best GBM step again: the binned kernels' share of its train()
    gbm_step = next(s for s, m in base if m.algo == "gbm")
    same, t_alone, kms = alone(gbm_step, timed=True)
    ours = sum(kms.values())
    say(f"automl (av): the best GBM step {gbm_step} trained alone with its "
        f"parameters and folds: the same trees bit for bit {same}; train() "
        f"{t_alone:.3f} s, the binned kernel wrappers (CUDA events around "
        f"each launch) {ours:.1f} ms: busy share of the binned kernels "
        f"{ours / 1e3 / t_alone:.4f} ("
        + ", ".join(f"{k} {v:.1f} ms" for k, v in kms.items()) + ")")
    leader = aml.leader
    if leader.algo == "stackedensemble":
        se = H2OStackedEnsembleEstimator(base_models=leader._base)
        se.train(y="y", training_frame=sub)
        lsame = np.array_equal(se._meta._state.beta,
                               leader._meta._state.beta)
        check(lsame, "automl (av): the leader trained alone differs")
    else:
        lsame = alone(rows[0]["step"])[0] if rows[0]["step"] != gbm_step \
            else same
    say(f"automl (av): the leader {leader.key} trained alone (an ensemble: "
        f"on the same base models): the same "
        f"{'trees' if leader.algo == 'gbm' else 'coefficients'} bit for "
        f"bit {lsame}")
    ses = [(r["step"], m) for r, m in aml.leaderboard_obj.rows
           if r["step"].startswith("StackedEnsemble")]
    bests = best_cv
    for name, se in ses:
        cv = se._meta._output.training_metrics.auc
        say(f"automl (av): {name}: CV AUC (the metalearner on the base "
            f"models' holdout predictions) {cv:.6f}, the best base model's "
            f"{bests:.6f}")
        check(cv >= bests - SE_MARGIN, f"automl (av): {name} CV AUC {cv}")


def phase_export_explain(torch, h2o, HC, host=None):
    """Runs (at)-(av); (at)'s float64 scorers in `host` when given."""
    t_phase = time.perf_counter()
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    blobs, _ = _blob_frame(torch, dev, HIGGS_N, 12) if "t" not in KEPT \
        else (None, None)
    # the same planted centres (drawn first from the seed), other rows
    blobs_valid, _ = _blob_frame(torch, dev, HIGGS_VALID_N, 12)
    models = _kept_models(torch, h2o, fr, valid, blobs)
    del blobs
    tmp = tempfile.mkdtemp(prefix="h2o3_export_")
    try:
        t0 = time.perf_counter()
        finish_at = export_import_run(torch, h2o, HC, fr, valid, models,
                                      blobs_valid, tmp, host)
        t_at = time.perf_counter() - t0
        t0 = time.perf_counter()
        explain_run(torch, h2o, HC, valid, models["b"])
        t_au = time.perf_counter() - t0
        del blobs_valid, valid, models
        t0 = time.perf_counter()
        automl_run(torch, h2o, HC, fr)
        t_av = time.perf_counter() - t0
        # (at)'s float64 scorers, which ran in the host worker meanwhile
        t0 = time.perf_counter()
        finish_at()
        t_at += time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"export, explain and automl: (at) {t_at:.1f} s, (au) {t_au:.1f} s, "
        f"(av) {t_av:.1f} s; the phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# observability and serving: runs (aw) and (ax)
# Prometheus 0.0.4 exposition grammar, one line at a time
_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_LINE = re.compile(
    r"(# HELP " + _PROM_NAME + r" .*|# TYPE " + _PROM_NAME
    + r" (counter|gauge|histogram|summary|untyped)|" + _PROM_NAME
    + r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"([^\"\\\n]|\\[\\\"n])*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"([^\"\\\n]|\\[\\\"n])*\")*\})?"
    r" (-?[0-9.e+-]+|[+-]?Inf|NaN))$")
# (ax)'s row buckets and the requests of its timings
SERVE_BUCKETS = [128 << i for i in range(10)]          # 128 .. 65,536
SERVE_REQUESTS = 1000            # (of 2,000: time)
SERVE_BUDGET_REQUESTS = 500      # (of 1,000: time)
SERVE_THREADS = 8


def _trees_equal(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("col", "thr", "na_left", "value"))


def _series_value(text, name, labels):
    """The value of one series line of a Prometheus text, or None."""
    want = name + "{" + ",".join(f'{k}="{v}"' for k, v in
                                 sorted(labels.items())) + "}"
    for line in text.splitlines():
        if line.startswith(want + " "):
            return float(line.split(" ")[1])
    return None


def obs_training_run(torch, h2o, HC, fr):
    """(aw): a 10-tree GBM of (b)'s configuration, trained untraced, then
    traced with lockdep raising; a 100,000-row HIGGS CSV parsed; the
    metrics scraped."""
    from h2o3_tpu_torch.analysis import lockdep
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.obs import recorder, timeline, tracing
    from h2o3_tpu_torch.utils import log
    gbm = dict(HIGGS_DEFAULT, ntrees=10)
    row_trees = om.REGISTRY.get("h2o3_gbm_row_trees_total")
    times, models = [], []
    for traced in (False, True):
        tid = None
        if traced:
            lockdep.reset()
            lockdep.enable("raise")
            tid = tracing.new_trace_id()
            recorder.RECORDER.pin(tid)
        rt0 = row_trees.value(engine="binned")
        HC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with tracing.trace(tid):
                if traced:
                    log.info("(aw) traced train() of 10 trees starts")
                m = h2o.H2OGradientBoostingEstimator(**gbm)
                m.train(y="y", training_frame=fr)
                torch.cuda.synchronize()
                if traced:
                    log.info("(aw) traced train() done")
        finally:
            if traced:
                lockdep.disable()
        times.append(time.perf_counter() - t0)
        drt = row_trees.value(engine="binned") - rt0
        per_tree = {k: v / 10 for k, v in HC.LAUNCHES.items() if v}
        models.append(m)
    counts = lockdep.counts()
    same = _trees_equal(torch, models[0]._trees, models[1]._trees)
    spans = timeline.SPANS.trace_snapshot(tid)
    names = [s["name"] for s in spans]
    chunk_trees = sum(s["attrs"].get("trees", 0) for s in spans
                      if s["name"] == "gbm.chunk")
    stored = recorder.RECORDER.load_trace(tid)
    stored_names = sorted({s["name"] for s in stored})
    log.flush()
    recs = log.search(trace=tid, limit=50)
    say(f"observability (aw) GBM 10 trees of (b)'s configuration at "
        f"{HIGGS_N:,} x {HIGGS_C}: train() {times[0]:.3f} s untraced, "
        f"{times[1]:.3f} s traced with lockdep raising ({counts['edges']} "
        f"lock-order edges, {counts['inversions']} inversions); trees bit "
        f"for bit {same}; the trace's spans: {names.count('job.run')} "
        f"job.run, {names.count('gbm.chunk')} gbm.chunk with trees summing "
        f"to {chunk_trees}; h2o3_gbm_row_trees_total{{engine=\"binned\"}} "
        f"+{drt:.0f}; the flight recorder's segment holds {len(stored)} "
        f"spans ({stored_names}); {len(recs)} log records carry the trace "
        f"id; launches per tree {per_tree}")
    check(counts["inversions"] == 0, "(aw) lock-order inversion")
    check(same, "(aw) traced trees differ from the untraced ones")
    check(names.count("job.run") == 1 and chunk_trees == 10,
          f"(aw) spans {names}")
    check(drt == HIGGS_N * 10, f"(aw) row-trees counter rose by {drt}")
    check({"job.run", "gbm.chunk"} <= set(stored_names),
          f"(aw) recorder returned {stored_names}")
    check(len(recs) >= 2 and all(r.get("trace") == tid for r in recs),
          f"(aw) log records {recs}")
    check(per_tree == PER_TREE["default"], f"(aw) launches {per_tree}")
    # a 100,000-row HIGGS CSV through import_file
    sub = _sub_frame(fr, 100_000)
    X = sub.matrix(sub.names).cpu().numpy().astype(np.float64)
    pb = om.REGISTRY.get("h2o3_parse_bytes_total")
    pr = om.REGISTRY.get("h2o3_parse_rows_total")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "higgs-100k.csv")
        np.savetxt(path, X, fmt="%.9g", delimiter=",",
                   header=",".join(sub.names), comments="")
        size = os.path.getsize(path)
        b0, r0 = pb.value(type="CSV"), pr.value()
        tid = tracing.new_trace_id()
        with tracing.trace(tid):
            with timeline.span("parse.request"):
                pf = h2o.import_file(path)
        db, dr = pb.value(type="CSV") - b0, pr.value() - r0
    pnames = {s["name"] for s in timeline.SPANS.trace_snapshot(tid)}
    want = {"parse.setup", "parse.file", "parse.tokenize", "parse.pack"}
    say(f"observability (aw) parse of a 100,000-row HIGGS CSV "
        f"({size} bytes): h2o3_parse_bytes_total +{db:.0f}, "
        f"h2o3_parse_rows_total +{dr:.0f}; spans {sorted(pnames)}")
    check(db == size and dr == 100_000 and pf.nrows == 100_000,
          f"(aw) parse counters +{db}, +{dr}")
    check(want <= pnames, f"(aw) parse spans {pnames}")
    # the scrape
    text = om.REGISTRY.prometheus_text()
    allocated = torch.cuda.memory_allocated(0)
    dev_bytes = _series_value(text, "h2o3_device_memory_bytes",
                              {"device": "0", "kind": "bytes_in_use"})
    bad = [ln for ln in text.splitlines() if not _PROM_LINE.fullmatch(ln)]
    om_text = om.REGISTRY.openmetrics_text()
    say(f"observability (aw) scrape: {len(text.splitlines())} Prometheus "
        f"lines, {len(bad)} outside the exposition grammar; OpenMetrics "
        f"ends in # EOF {om_text.endswith('# EOF' + chr(10))}; "
        f"h2o3_device_memory_bytes{{device=\"0\",kind=\"bytes_in_use\"}} "
        f"{dev_bytes:.0f} = torch.cuda.memory_allocated(0) {allocated}; "
        f"graph captures so far {om.graph_capture_count():.0f}")
    check(not bad, f"(aw) lines outside the grammar: {bad[:3]}")
    check(om_text.endswith("# EOF\n"), "(aw) OpenMetrics text")
    check(dev_bytes == allocated, f"(aw) device bytes {dev_bytes} vs "
          f"{allocated}")
    from h2o3_tpu_torch.core.kvstore import DKV
    for k in (models[0].key, models[1].key, pf.key, sub.key):
        DKV.remove(k)
    return times


def _pctl(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8)


def serve_correctness(torch, h2o, models, frames):
    """(ax) correctness: each bucket's first call one capture, then none;
    replay = eager scorer on the same padded buffer, bit for bit; against
    predict without padding (the eager path); model_performance through
    score_frame_with_response against the eager metrics."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import scorer_cache as SC
    dev = h2o.init().device
    hits = om.REGISTRY.get("h2o3_scorer_cache_hits_total")
    misses = om.REGISTRY.get("h2o3_scorer_cache_misses_total")
    graph_mib = {}
    for tag, m in models.items():
        fr = frames[tag]
        di = m._dinfo
        worst = 0.0
        bytes_seen = set()
        graph_mib[tag] = []
        for b in SERVE_BUCKETS:
            ns = ([1] if b == SERVE_BUCKETS[0] else []) + [b // 2 + 1, b]
            for i, n in enumerate(ns):
                sub = _sub_frame(fr, n)
                c0, h0, m0 = (om.graph_capture_count(), hits.value(),
                              misses.value())
                raw = SC.stage_frame(di, di.adapt(sub), SC.row_bucket(n))
                out = SC.score_rows(m, raw, n)
                dc, dh, dm = (om.graph_capture_count() - c0,
                              hits.value() - h0, misses.value() - m0)
                first = i == 0
                check((dc, dm, dh) == ((1, 1, 0) if first else (0, 0, 1)),
                      f"(ax) {tag} bucket {b} rows {n}: captures {dc}, "
                      f"misses {dm}, hits {dh}")
                prog = SC.CACHE.program(m, b)
                params = serving.PARAMS.placed(m, SC.model_token(m))
                with torch.no_grad():
                    eager_pad = prog._fn(
                        params, torch.from_numpy(raw).to(dev)).cpu().numpy()
                check(np.array_equal(_bits(out), _bits(eager_pad)),
                      f"(ax) {tag} bucket {b}: replay vs eager scorer")
                with torch.no_grad():
                    plain = m._score_matrix(di.matrix(sub)).cpu().numpy()
                if tag == "b":
                    check(np.array_equal(_bits(out[:n]), _bits(plain)),
                          f"(ax) {tag} rows {n}: not bit for bit")
                elif tag == "t":
                    check(np.array_equal(out[:n], plain),
                          f"(ax) {tag} rows {n}: clusters differ")
                else:
                    d = float(np.abs(out[:n] - plain).max())
                    worst = max(worst, d)
                    check(d <= 1e-6, f"(ax) {tag} rows {n}: {d}")
                bytes_seen.add(serving.PARAMS.bytes_for(m.key))
                DKV.remove(sub.key)
            graph_mib[tag].append(sum(
                p.graph_bytes for p in SC.CACHE.programs(m.key)) / 2**20)
        check(len(bytes_seen) == 1,
              f"(ax) {tag} param bytes moved: {bytes_seen}")
        say(f"serving (ax) {tag}: 10 buckets 128-65,536, one capture each "
            f"and warm hits after; replay = eager scorer on the padded "
            f"buffer bit for bit; vs the unpadded eager scorer "
            f"{'bit for bit' if tag == 'b' else 'same clusters' if tag == 't' else f'max |diff| {worst:.3g}'}; "
            f"params {bytes_seen.pop()} bytes, one copy (the same from 1 "
            f"bucket to 10); MiB the graphs hold after each bucket "
            f"{[round(x, 1) for x in graph_mib[tag]]}")
    # model_performance: the cache's metrics against the eager ones
    for tag in ("b", "k", "q"):
        m, fr = models[tag], frames[tag]
        for n in (4096, 65_536):
            sub = _sub_frame(fr, n)
            fast = m.model_performance(sub)
            os.environ["H2O3_SCORE_FASTPATH_MAX_ROWS"] = "0"
            try:
                eager = m.model_performance(sub)
            finally:
                del os.environ["H2O3_SCORE_FASTPATH_MAX_ROWS"]
            diffs = {k: abs(getattr(fast, k) - getattr(eager, k))
                     for k in ("auc", "logloss", "mse")}
            say(f"serving (ax) {tag} model_performance at {n} rows through "
                f"score_frame_with_response vs eager: |diff| {diffs}")
            check(max(diffs.values()) <= 1e-7,
                  f"(ax) {tag} metrics differ: {diffs}")
            DKV.remove(sub.key)
    return graph_mib


def serve_sync_free(torch, models, raws):
    """(ax): a warm dispatch under torch.cuda.set_sync_debug_mode("error")
    (its one wait is the event before the host reads the output)."""
    from h2o3_tpu_torch.serving import scorer_cache as SC
    for tag, m in models.items():
        SC.score_rows(m, raws[tag], 1)          # warm
        torch.cuda.set_sync_debug_mode("error")
        try:
            SC.score_rows(m, raws[tag], 1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    say("serving (ax) warm dispatches of the four models under "
        "set_sync_debug_mode('error'): no synchronising call")


def serve_budget(torch, models, raws, refs, host_spill):
    """(ax): SERVE_BUDGET_REQUESTS one-row requests in turn across the
    models under an HBM budget one byte short of the two largest models'
    params (they never sit together); with `host_spill` a host budget
    below every model's params too, so each demote spills to an npz."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import params as SP
    from h2o3_tpu_torch.serving import scorer_cache as SC
    sizes = {t: serving.PARAMS.bytes_for(m.key) for t, m in models.items()}
    two = sorted(sizes.values())[-2:]
    budget = sum(two) - 1
    os.environ["H2O3_SERVE_HBM_BUDGET_MB"] = repr(budget / 2**20)
    if host_spill:
        os.environ["H2O3_SERVE_HOST_BUDGET_MB"] = repr(
            min(sizes.values()) / 2 / 2**20)
    faults = om.REGISTRY.get("h2o3_serve_param_faults_total")
    f0 = {t: faults.value(tier=t) for t in ("host", "disk")}
    try:
        for m in models.values():
            serving.PARAMS.demote_key(
                m.key, SP.TIER_DISK if host_spill else SP.TIER_HOST)
        c0 = om.graph_capture_count()
        cs0 = SC.CAPTURE_SECONDS.snapshot()["sum"]
        p0 = serving.PARAMS.stats()["faults"]
        over, wrong = 0, 0
        tags = list(models)
        t0 = time.perf_counter()
        for i in range(SERVE_BUDGET_REQUESTS):
            tag = tags[i % len(tags)]
            out = SC.score_rows(models[tag], raws[tag], 1)
            wrong += not np.array_equal(_bits(out), _bits(refs[tag]))
            gauge = sum(v for _, v in
                        om.REGISTRY.get("h2o3_scorer_params_bytes")
                        ._collect())
            over += (serving.PARAMS.admitted_bytes() > budget
                     or gauge > budget)
        dt = time.perf_counter() - t0
        promotes = serving.PARAMS.stats()["faults"] - p0
        caps = om.graph_capture_count() - c0
        cap_ms = (SC.CAPTURE_SECONDS.snapshot()["sum"] - cs0) * 1e3 \
            / max(caps, 1)
        df = {t: faults.value(tier=t) - f0[t] for t in f0}
        npz = len([f for f in os.listdir(_params_dir())
                   if f.endswith(".npz")]) if host_spill else 0
    finally:
        os.environ.pop("H2O3_SERVE_HBM_BUDGET_MB", None)
        os.environ.pop("H2O3_SERVE_HOST_BUDGET_MB", None)
    say(f"serving (ax) {SERVE_BUDGET_REQUESTS} one-row requests in turn "
        f"under an HBM budget of {budget} bytes (params {sizes})"
        f"{', host budget ' + str(min(sizes.values()) // 2) + ' bytes' if host_spill else ''}: "
        f"{wrong} predictions not bit for bit, {over} samples over the "
        f"budget, {promotes} promotions ({df}), {caps} captures "
        f"({cap_ms:.3f} ms each on average), {npz} npz files left; "
        f"{dt:.2f} s")
    check(wrong == 0 and over == 0, f"(ax) budget: {wrong} wrong, "
          f"{over} over")
    check(caps == promotes and promotes > 0,
          f"(ax) {caps} captures for {promotes} promotions")
    if host_spill:
        check(df["disk"] > 0, f"(ax) no fault from npz: {df}")


def _params_dir():
    from h2o3_tpu_torch.io import spill
    d = spill.params_dir()
    os.makedirs(d, exist_ok=True)
    return d


def serve_threads(torch, models, frames):
    """(ax): SERVE_THREADS threads score their own frames at once, with
    lockdep raising; each answer equals its serial run's."""
    from h2o3_tpu_torch.analysis import lockdep
    from h2o3_tpu_torch.core.kvstore import DKV
    jobs = []
    tags = list(models)
    for i in range(SERVE_THREADS):
        tag = tags[i % len(tags)]
        jobs.append((models[tag], _sub_frame(frames[tag], 300 + 97 * i)))
    serial = [m._score_host(f) for m, f in jobs]
    results = [None] * len(jobs)
    errors = []
    barrier = threading.Barrier(len(jobs))

    def work(i):
        try:
            m, f = jobs[i]
            barrier.wait()
            results[i] = [m._score_host(f) for _ in range(20)]
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))
    ts = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
    lockdep.reset()
    lockdep.enable("raise")
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        lockdep.disable()
    counts = lockdep.counts()
    same = not errors and all(
        np.array_equal(_bits(r), _bits(serial[i]))
        for i in range(len(jobs)) for r in results[i])
    say(f"serving (ax) {len(jobs)} threads x 20 requests of their own "
        f"frames at once, lockdep raising ({counts['edges']} lock-order "
        f"edges, {counts['inversions']} inversions): every answer its "
        f"serial run's {same}")
    check(same and not counts["inversions"], f"(ax) threads: {errors[:2]}")
    for _, f in jobs:
        DKV.remove(f.key)


class _PredictStages:
    """perf_counter_ns around each stage of one model's `predict` of a
    one-row frame, read by wrapping the functions predict calls: the
    design's assembly (the adapted frame staged into its bucket, or the
    eager design matrix), the scorer (the graph's replay or the eager
    scorer, with the host copy), `_prediction_columns`, the rest of
    `_prediction_frame` (the Vecs, their pager chunks, the Frame's store
    entry) and the store's `remove`; `other` is what is left of the
    call. Each `sample(fn)` adds one call's stages."""

    STAGES = ("design", "scorer", "columns", "frame", "remove", "other")

    def __init__(self, m):
        from h2o3_tpu_torch import serving
        from h2o3_tpu_torch.core.kvstore import DKV
        from h2o3_tpu_torch.serving import scorer_cache as SC
        self.ns = {}
        self.samples = {k: [] for k in self.STAGES}
        self.patches = [(serving, "score_frame"), (SC, "score_rows"),
                        (m._dinfo, "matrix"), (m, "_score_host"),
                        (m, "_prediction_columns"),
                        (m, "_prediction_frame"), (DKV, "remove")]

    def _wrap(self, obj, name):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.ns[name] = self.ns.get(name, 0) + \
                    time.perf_counter_ns() - t0
        return timed

    def __enter__(self):
        self.saved = [(o, n, n in vars(o), vars(o).get(n))
                      for o, n in self.patches]
        for o, n in self.patches:
            setattr(o, n, self._wrap(o, n))
        return self

    def __exit__(self, *exc):
        for o, n, had, old in self.saved:
            if had:
                setattr(o, n, old)
            else:
                delattr(o, n)

    def sample(self, fn):
        self.ns = {}
        t0 = time.perf_counter_ns()
        fn()
        total = time.perf_counter_ns() - t0
        g = self.ns.get
        design = g("score_frame", 0) - g("score_rows", 0) + g("matrix", 0)
        part = {"design": design, "scorer": g("_score_host", 0) - design,
                "columns": g("_prediction_columns", 0),
                "frame": g("_prediction_frame", 0)
                - g("_prediction_columns", 0), "remove": g("remove", 0)}
        part["other"] = total - g("_score_host", 0) \
            - g("_prediction_frame", 0) - g("remove", 0)
        for k, v in part.items():
            self.samples[k].append(v)
        return total / 1e9

    def line(self):
        return ", ".join(f"{k} {_pctl(v, 50) / 1e3:.1f}" for k, v in
                         self.samples.items())


def serve_speed(torch, h2o, models, frames, raws):
    """(ax): warm rows/s of predict on 4,096-row frames; p50/p99 of
    score_rows with one row and of predict on a one-row frame, through
    the cache and eagerly (H2O3_SCORE_FASTPATH_MAX_ROWS=0), in turns."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.serving import scorer_cache as SC
    dev = h2o.init().device
    out = {}
    for tag, m in models.items():
        di = m._dinfo
        f4k = _sub_frame(frames[tag], 4096)
        f1 = _sub_frame(frames[tag], 1)
        raw1 = raws[tag]
        x1 = torch.from_numpy(raw1[:1]).to(dev)

        def eager_score():
            with torch.no_grad():
                return m._score_matrix(di.assemble_design(
                    torch.from_numpy(raw1[:1]).to(dev))).cpu().numpy()

        def predict(f):
            p = m.predict(f)
            DKV.remove(p.key)
        r = {}
        stages = {}
        for mode in ("graph", "eager"):
            if mode == "eager":
                os.environ["H2O3_SCORE_FASTPATH_MAX_ROWS"] = "0"
            # (q)'s one-row predict, stage by stage, in the timed loop
            clock = _PredictStages(m) if tag == "q" else None
            try:
                predict(f4k)
                t0 = time.perf_counter()
                for _ in range(20):
                    predict(f4k)
                r[mode + "_rows_s"] = 20 * 4096 / (time.perf_counter() - t0)
                lat_s, lat_p = [], []
                one = (lambda: SC.score_rows(m, raw1, 1)) \
                    if mode == "graph" else eager_score
                for _ in range(50):
                    one()
                    predict(f1)
                with clock or contextlib.nullcontext():
                    for _ in range(SERVE_REQUESTS):
                        t0 = time.perf_counter()
                        one()
                        lat_s.append(time.perf_counter() - t0)
                        if clock is None:
                            t0 = time.perf_counter()
                            predict(f1)
                            lat_p.append(time.perf_counter() - t0)
                        else:
                            lat_p.append(clock.sample(lambda: predict(f1)))
                if clock is not None:
                    stages[mode] = clock.line()
                r[mode + "_score_ms"] = (_pctl(lat_s, 50) * 1e3,
                                         _pctl(lat_s, 99) * 1e3)
                r[mode + "_predict_ms"] = (_pctl(lat_p, 50) * 1e3,
                                           _pctl(lat_p, 99) * 1e3)
            finally:
                os.environ.pop("H2O3_SCORE_FASTPATH_MAX_ROWS", None)
        del x1
        out[tag] = r
        say(f"serving (ax) speed {tag}: predict on 4,096-row frames "
            f"{r['graph_rows_s']:,.0f} rows/s (eager "
            f"{r['eager_rows_s']:,.0f}); one-row score_rows p50/p99 "
            f"{r['graph_score_ms'][0]:.4f}/{r['graph_score_ms'][1]:.4f} ms "
            f"(eager scorer {r['eager_score_ms'][0]:.4f}/"
            f"{r['eager_score_ms'][1]:.4f}); one-row predict p50/p99 "
            f"{r['graph_predict_ms'][0]:.4f}/{r['graph_predict_ms'][1]:.4f}"
            f" ms (eager {r['eager_predict_ms'][0]:.4f}/"
            f"{r['eager_predict_ms'][1]:.4f})")
        if stages:
            say(f"serving (ax) predict stages {tag}, one-row p50 in us "
                f"(perf_counter_ns): cache: {stages['graph']}; eager: "
                f"{stages['eager']}")
        check(r["graph_score_ms"][0] < r["eager_score_ms"][0]
              and r["graph_predict_ms"][0] < r["eager_predict_ms"][0],
              f"(ax) {tag}: the cache's one-row p50 is not below eager's")
        for f in (f4k, f1):
            DKV.remove(f.key)
    return out


def serve_lifecycle(torch, h2o, models, frames):
    """(ax): (b)'s key overwritten in DKV by a retrained model frees the
    old generation's programs and placement once and the new model
    scores; DELETE frees everything once."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import scorer_cache as SC
    old = models["b"]
    key = old.key
    old_tok = SC.model_token(old)
    n_old = len(SC.CACHE.programs(key))
    ev = om.REGISTRY.get("h2o3_scorer_cache_evictions_total")
    e0 = ev.value()
    small = _sub_frame(frames["train"], 200_000)
    new = h2o.H2OGradientBoostingEstimator(
        **dict(HIGGS_DEFAULT, ntrees=5, model_id=key))
    new.train(y="y", training_frame=small)     # DKV.put replaces (b)
    # the old generation's programs and placement are gone; the retrain's
    # drift baseline (obs/modelmon.py) scored its training frame, so the
    # new generation holds one program, of the training bucket
    progs = SC.CACHE.programs(key)
    gone = not [p for p in progs if p.token == old_tok] and \
        (key, old_tok) not in serving.PARAMS._placements
    baseline = [p.bucket for p in progs
                if p.token == SC.model_token(new)] == \
        [SC.row_bucket(small.nrows)] and len(progs) == 1
    sub = _sub_frame(frames["b"], 1000)
    p = new.predict(sub).vec("p1").as_f32().cpu().numpy()
    with torch.no_grad():
        plain = new._score_matrix(new._dinfo.matrix(sub))[:, 1].cpu().numpy()
    scores = np.array_equal(_bits(p), _bits(plain))
    n_new = len(SC.CACHE.programs(key))
    nbytes = serving.PARAMS.bytes_for(key)
    h2o.remove(key)
    text = om.REGISTRY.prometheus_text()
    freed = (not SC.CACHE.programs(key)
             and serving.PARAMS.bytes_for(key) == 0
             and f'model="{key}"' not in text)
    say(f"serving (ax) lifecycle: (b)'s key overwritten by a retrained "
        f"model: its {n_old} programs and placement freed {gone} "
        f"({ev.value() - e0:.0f} evictions), the retrain's drift baseline "
        f"holds one program of its training bucket {baseline}, the new "
        f"model scores bit for bit {scores} ({n_new} programs, {nbytes} "
        f"param bytes); DELETE frees every program, placement and series "
        f"{freed}")
    check(gone and baseline and scores and freed, "(ax) lifecycle")
    for f in (small, sub):
        DKV.remove(f.key)


def phase_obs_serving(torch, h2o, HC):
    """Runs (aw) and (ax)."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.serving import scorer_cache as SC
    t_phase = time.perf_counter()
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    t0 = time.perf_counter()
    obs_training_run(torch, h2o, HC, fr)
    t_aw = time.perf_counter() - t0
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    blobs = _blob_frame(torch, dev, HIGGS_N, 12)[0] if "t" not in KEPT \
        else None
    blobs_valid, _ = _blob_frame(torch, dev, HIGGS_VALID_N, 12)
    models = _kept_models(torch, h2o, fr, valid, blobs,
                          label="serving (ax)")
    models = {t: models[t] for t in ("b", "k", "q", "t")}
    # the programs of earlier runs' models go; the four models are in the
    # store under their keys, and (k)'s custom metric under its name (an
    # earlier phase may have cleared the store)
    SC.CACHE.clear()
    for m in models.values():
        DKV.put(m.key, m)
    from h2o3_tpu_torch import udf
    udf.register_udf("chip_logloss", _logloss_udf(torch))
    if blobs is not None:
        DKV.remove(blobs.key)
    del blobs
    frames = {"b": valid, "k": valid, "q": valid, "t": blobs_valid,
              "train": fr}
    t0 = time.perf_counter()
    graph_mib = serve_correctness(torch, h2o, models, frames)
    t_corr = time.perf_counter() - t0
    raws = {}
    for tag, m in models.items():
        sub = _sub_frame(frames[tag], 1)
        raws[tag] = SC.stage_frame(m._dinfo, m._dinfo.adapt(sub), 128)
        DKV.remove(sub.key)
    refs = {t: SC.score_rows(m, raws[t], 1) for t, m in models.items()}
    serve_sync_free(torch, models, raws)
    t0 = time.perf_counter()
    serve_budget(torch, models, raws, refs, host_spill=False)
    serve_budget(torch, models, raws, refs, host_spill=True)
    t_budget = time.perf_counter() - t0
    serve_threads(torch, models, frames)
    t0 = time.perf_counter()
    speed = serve_speed(torch, h2o, models, frames, raws)
    t_speed = time.perf_counter() - t0
    serve_lifecycle(torch, h2o, models, frames)
    say(f"observability and serving: (aw) {t_aw:.1f} s, (ax) correctness "
        f"{t_corr:.1f} s, budgets {t_budget:.1f} s, speed {t_speed:.1f} s; "
        f"the phase {time.perf_counter() - t_phase:.1f} s")
    DKV.clear()
    return {"graph_mib": graph_mib, "speed": speed}


# ---------------------------------------------------------------------------
# (ay)-(ba): the rest of serving — the micro-batcher under QoS, usage
# attribution, the watchdog and chaos, drift
QOS_REQUESTS = 6_000         # (ay) requests a run (of 20,000: time)
QOS_THREADS = 64             # (ay) client threads
QOS_SIZES = (1, 8, 64)       # (ay) rows a request ...
QOS_SIZE_P = (0.7, 0.2, 0.1)  # ... and their shares
QOS_POOL = 4096              # (ay) validation rows the requests draw from
QOS_TOL = 1e-6               # GLM and DL rows scored in another bucket
QOS_TENANT_REQUESTS = 150    # (az) requests of each gold/silver thread
QOS_TENANT_THREADS = 4       # (az) gold and silver threads each
QOS_FLOOD_THREADS = 32       # (az) flood threads
QOS_FLOOD_RPS = 400          # (az) flood's H2O3_QOS_RATES rate
QOS_QUEUE_DEPTH = 40         # (az) H2O3_SCORE_QUEUE_DEPTH: share cap 20
DRIFT_SHIFT_COL = "x3"       # (ba) the feature shifted by one sd
DRIFT_TAP_ROWS = 65_536      # (ba) H2O3_MODELMON_TAP_ROWS: rows a fold


def _set_env(**kw):
    """Set (a str) or unset (None) env knobs; returns the old values."""
    old = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    return old


def _payload(rows, names):
    return [dict(zip(names, map(float, r))) for r in rows]


def _frame_of(torch, dev, rows, names):
    from h2o3_tpu_torch.core.frame import Frame, Vec
    t = torch.from_numpy(np.ascontiguousarray(rows.T)).to(dev)
    return Frame(list(names), [Vec.from_tensor(t[j].contiguous())
                               for j in range(len(names))])


def _answer(tag, out, route):
    """The number a request's answer is checked on: p1 for the binomial
    models, the cluster for KMeans."""
    col = "predict" if tag == "t" else "p1"
    if route == "payload":
        return np.array([d[col] for d in out], np.float64)
    return out.vec(col).to_numpy().astype(np.float64)


def _qos_reference(torch, models, pools):
    """Every pool row scored through its model's program at once, and
    200 of the (ay) requests' row sets scored alone in their own bucket:
    the GBM and KMeans rows bit for bit the pool's, GLM and DL within
    QOS_TOL."""
    from h2o3_tpu_torch.serving import scorer_cache as SC
    ref = {}
    for tag, m in models.items():
        out = SC.score_rows(m, pools[tag], QOS_POOL)[:QOS_POOL]
        ref[tag] = (out[:, 1] if out.ndim == 2 else out).astype(np.float64)
    rng = np.random.default_rng(31)
    worst = 0.0
    for _ in range(200):
        tag = "bkqt"[int(rng.integers(0, 4))]
        k = int(rng.choice(QOS_SIZES))
        o = int(rng.integers(0, QOS_POOL - 64))
        raw = np.full((SC.row_bucket(k), pools[tag].shape[1]), np.nan,
                      np.float32)
        raw[:k] = pools[tag][o:o + k]
        a = SC.score_rows(models[tag], raw, k)[:k]
        a = (a[:, 1] if a.ndim == 2 else a).astype(np.float64)
        d = float(np.abs(a - ref[tag][o:o + k]).max())
        check(d <= (0.0 if tag in "bt" else QOS_TOL),
              f"(ay) {tag} rows {o}+{k} alone vs the pool: {d}")
        worst = max(worst, d)
    return ref, worst


def qos_coalesced_run(torch, h2o, models, pools, names, ref, linger,
                      n_requests, n_threads):
    """(ay): n_requests from n_threads closed-loop clients, half through
    score_payload (dict rows), half through predict_via_rest (frames),
    spread over the four models; sizes 1/8/64 at 70/20/10%."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import usage
    from h2o3_tpu_torch.serving import microbatch as mb
    dev = h2o.init().device
    rng = np.random.default_rng(29)
    tags = rng.choice(list("bkqt"), n_requests)
    sizes = rng.choice(QOS_SIZES, n_requests, p=QOS_SIZE_P)
    payload = rng.random(n_requests) < 0.5
    offs = rng.integers(0, QOS_POOL - 64, n_requests)
    # frames: one per (thread, size, model's pool), made on the card
    # before the clock starts, as a parsed request frame would be
    frames = {}
    for th in range(n_threads):
        for k in QOS_SIZES:
            o = (th * 61) % (QOS_POOL - 64)
            for g in ("x", "t"):
                frames[th, k, g] = (o, _frame_of(
                    torch, dev, pools["b" if g == "x" else "t"][o:o + k],
                    names))
    bodies = [None] * n_requests
    for i in range(n_requests):
        if payload[i]:
            o, k = int(offs[i]), int(sizes[i])
            bodies[i] = _payload(pools[tags[i]][o:o + k], names)
    results = [None] * n_requests
    stages = [None] * n_requests
    writes = np.zeros(n_requests, np.int64)
    lat = np.zeros(n_requests)
    errors = []
    old = _set_env(H2O3_SCORE_LINGER_MS=linger)
    barrier = threading.Barrier(n_threads)

    def client(th):
        try:
            barrier.wait()
            for i in range(th, n_requests, n_threads):
                m = models[tags[i]]
                usage.begin_request()
                t0 = time.perf_counter()
                if payload[i]:
                    out = serving.score_payload(m, bodies[i])
                else:
                    g = "t" if tags[i] == "t" else "x"
                    out = serving.predict_via_rest(
                        m, frames[th, int(sizes[i]), g][1])
                lat[i] = time.perf_counter() - t0
                stages[i] = usage.finish_request(lat[i])
                writes[i] += 1
                results[i] = out
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(repr(e))

    r0, d0 = mb.REQUESTS.value(), mb.DISPATCHES.value()
    rows0 = mb.BATCH_ROWS.snapshot()
    ts = [threading.Thread(target=client, args=(th,), name=f"client-{th}")
          for th in range(n_threads)]
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        _set_env(**old)
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    dr, dd = mb.REQUESTS.value() - r0, mb.DISPATCHES.value() - d0
    rows1 = mb.BATCH_ROWS.snapshot()
    check(not errors, f"(ay) client errors {errors[:3]}")
    # every request answered exactly once, with its own rows
    lost = int((writes == 0).sum())
    twice = int((writes > 1).sum())
    wrong, worst = 0, {t: 0.0 for t in "bkqt"}
    for i in range(n_requests):
        tag, k = str(tags[i]), int(sizes[i])
        route = "payload" if payload[i] else "frame"
        o = int(offs[i]) if payload[i] else frames[
            i % n_threads, k, "t" if tag == "t" else "x"][0]
        got = _answer(tag, results[i], route)
        want = ref[tag][o:o + k]
        d = float(np.abs(got - want).max()) if len(got) == k else np.inf
        worst[tag] = max(worst[tag], d)
        wrong += d > (0.0 if tag in "bt" else QOS_TOL)
        if route == "frame":
            DKV.remove(results[i].key)
    for _, f in frames.values():
        DKV.remove(f.key)
    batched = int(sum(1 for t in tags if t != "t"))
    return {"wall": wall, "rps": n_requests / wall,
            "cpu_ms": cpu / n_requests * 1e3, "cores": cpu / wall,
            "p50": _pctl(lat, 50) * 1e3, "p99": _pctl(lat, 99) * 1e3,
            "p50_payload": _pctl(lat[payload], 50) * 1e3,
            "p50_frame": _pctl(lat[~payload], 50) * 1e3,
            "per_dispatch": dr / max(dd, 1), "dispatches": dd,
            "requests": dr, "batched": batched,
            "rows_per_dispatch": (rows1["sum"] - rows0["sum"])
            / max(rows1["count"] - rows0["count"], 1),
            "tail": _tail_split(lat, stages),
            "tail_models": {str(t): int(c) for t, c in zip(*np.unique(
                tags[lat >= _pctl(lat, 99)], return_counts=True))},
            "lost": lost, "twice": twice, "wrong": wrong, "worst": worst}


def _split_text(tail):
    return ", ".join(f"{k} {v:.3f}" for k, v in tail.items() if k != "n")


def _tail_split(lat, stages, q=99):
    """The mean waterfall (ms a stage) of the requests at or above the
    q-th percentile of `lat`, and how many they are."""
    lat = np.asarray(lat)
    cut = _pctl(lat, q)
    slow = [stages[i] or {} for i in np.flatnonzero(lat >= cut)]
    names = sorted({k for st in slow for k in st})
    return {"n": len(slow),
            **{k: round(1e3 * sum(st.get(k, 0.0) for st in slow)
                        / len(slow), 3) for k in names}}


def _tenant_clients(principal, m, rows, names, n_threads, n_req, lats,
                    outcome, rows_ok, stop=None, deadline_ms=None,
                    stages=None):
    """Threads sending one-row (gold/silver) or 64-row (flood) payloads
    as `principal`; outcome[principal] counts ok/429/503/504 and
    rows_ok[principal] the rows of its answered requests."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.obs import tracing, usage
    from h2o3_tpu_torch.serving import qos
    k = 64 if principal == "flood" else 1
    bodies = [_payload(rows[o:o + k], names) for o in range(0, 512, 7)]

    def client(th):
        i = th
        while (stop is None and i < n_req * n_threads) or \
                (stop is not None and not stop):
            body = bodies[i % len(bodies)]
            dl = None if deadline_ms is None else \
                time.monotonic() + deadline_ms / 1e3
            usage.begin_request()
            t0 = time.perf_counter()
            try:
                with tracing.request_context(principal, dl):
                    serving.score_payload(m, body)
                key = "ok"
            except qos.RateLimited:
                key = "429"
            except serving.QueueFull:
                key = "503"
            except qos.DeadlineExceeded:
                key = "504"
            dt = time.perf_counter() - t0
            if key != "ok" and stop is not None:
                time.sleep(0.001)       # a flood client's retry delay
            st = usage.finish_request(dt)
            with _OUTCOME_LOCK:
                outcome[principal][key] = outcome[principal].get(key, 0) + 1
                if key == "ok":
                    lats.append(dt)
                    if stages is not None:
                        stages.append(st or {})
                    rows_ok[principal] = rows_ok.get(principal, 0) + k
            i += n_threads
    return [threading.Thread(target=client, args=(th,), daemon=True,
                             name=f"{principal}-{th}")
            for th in range(n_threads)]


_OUTCOME_LOCK = threading.Lock()


def _run_threads(ts):
    for t in ts:
        t.start()
    for t in ts:
        t.join()


def qos_tenants_run(torch, h2o, models, pools, names, ref, fr):
    """(az): gold, silver and flood at weights 4:1:1 on one device slot
    (H2O3_QOS_MAX_INFLIGHT=1): flood's rate limit (429) and queue share
    (503), deadlines (504), an all-dead batch, gold's p99 under the flood
    beside unloaded, the usage ledger, a job quota, an epoch retry and a
    watchdog trip from the chaos layer."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.deploy import chaos
    from h2o3_tpu_torch.deploy import membership
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.obs import recorder, tracing, usage, watchdog
    from h2o3_tpu_torch.serving import microbatch as mb
    from h2o3_tpu_torch.serving import qos
    m = models["b"]
    rows = pools["b"]
    old = _set_env(H2O3_QOS_WEIGHTS="gold:4,silver:1,flood:1",
                   H2O3_QOS_MAX_INFLIGHT=1,
                   H2O3_QOS_RATES=f"flood:{QOS_FLOOD_RPS}",
                   H2O3_SCORE_QUEUE_DEPTH=QOS_QUEUE_DEPTH)
    out = {}
    try:
        qos.reset()
        usage.reset()
        d_start = mb.DISPATCHES.value()
        # gold alone
        outcome = {p: {} for p in ("gold", "silver", "flood")}
        rows_ok = {}
        lat_alone, st_alone = [], []
        _run_threads(_tenant_clients("gold", m, rows, names,
                                     QOS_TENANT_THREADS, QOS_TENANT_REQUESTS,
                                     lat_alone, outcome, rows_ok,
                                     stages=st_alone))
        # gold and silver under the flood
        rej0 = {(p, r): qos.REJECTS.value(principal=p, reason=r)
                for p in ("gold", "silver", "flood")
                for r in ("rate", "share")}
        stop = []
        lat_gold, lat_silver, st_gold, st_silver = [], [], [], []
        flood = _tenant_clients("flood", m, rows, names, QOS_FLOOD_THREADS,
                                0, [], outcome, rows_ok, stop=stop)
        for t in flood:
            t.start()
        time.sleep(0.2)
        _run_threads(
            _tenant_clients("gold", m, rows, names, QOS_TENANT_THREADS,
                            QOS_TENANT_REQUESTS, lat_gold, outcome,
                            rows_ok, stages=st_gold)
            + _tenant_clients("silver", m, rows, names, QOS_TENANT_THREADS,
                              QOS_TENANT_REQUESTS, lat_silver, outcome,
                              rows_ok, stages=st_silver))
        stop.append(1)
        for t in flood:
            t.join()
        dispatches = mb.DISPATCHES.value() - d_start
        rej = {k: qos.REJECTS.value(principal=k[0], reason=k[1]) - v
               for k, v in rej0.items()}
        n_ok = 2 * QOS_TENANT_REQUESTS * QOS_TENANT_THREADS
        check(outcome["gold"] == {"ok": n_ok}
              and outcome["silver"] == {"ok": n_ok // 2},
              f"(az) gold/silver outcomes {outcome}")
        check(outcome["flood"].get("429", 0) > 0
              and outcome["flood"].get("503", 0) > 0,
              f"(az) the flood was neither rate-limited nor shed: "
              f"{outcome['flood']}")
        check(rej[("flood", "rate")] == outcome["flood"]["429"]
              and rej[("flood", "share")] == outcome["flood"]["503"]
              and not any(v for (p, _), v in rej.items() if p != "flood"),
              f"(az) rejection counters {rej} vs {outcome['flood']}")
        stages = st_alone + st_gold + st_silver
        short = [s for s in stages
                 if not {"queue", "gate", "decode", "device"} <= set(s)]
        check(not short, f"(az) waterfalls without a stage: {short[:2]}")
        # usage: the ledger by principal against the total, and against
        # what the clients saw: each principal charged the rows of its
        # answered requests, and one call a dispatch
        snap = usage.usage_snapshot()
        by_p, led = {}, {}
        for r in snap["ledger"]:
            by_p[r["principal"]] = by_p.get(r["principal"], 0.0) \
                + r["device_seconds"]
            c, n = led.get(r["principal"], (0, 0))
            led[r["principal"]] = (c + r["calls"], n + r["rows"])
        total = usage.device_seconds_total()
        share_err = abs(sum(by_p.values()) - total) / max(total, 1e-12)
        check(share_err <= 0.01, f"(az) ledger {by_p} vs total {total}")
        check({p: n for p, (_, n) in led.items()} == rows_ok
              and sum(c for c, _ in led.values()) == dispatches
              and all(1 <= led[p][0] <= outcome[p]["ok"] for p in rows_ok),
              f"(az) ledger (calls, rows) {led}: rows answered {rows_ok}, "
              f"{dispatches} dispatches")
        out.update(outcome=outcome, rej=rej, by_p=by_p, total=total,
                   led=led, dispatches=dispatches,
                   tail_alone=_tail_split(lat_alone, st_alone),
                   tail_gold=_tail_split(lat_gold, st_gold),
                   share_err=share_err, n_stages=len(stages),
                   gold_alone=(_pctl(lat_alone, 50) * 1e3,
                               _pctl(lat_alone, 99) * 1e3),
                   gold=(_pctl(lat_gold, 50) * 1e3,
                         _pctl(lat_gold, 99) * 1e3),
                   silver=(_pctl(lat_silver, 50) * 1e3,
                           _pctl(lat_silver, 99) * 1e3))
        # deadlines: blown at admission, blown while the batch lingers,
        # and an all-dead batch
        s0 = {r: qos.SHED.value(reason=r) for r in ("admission", "batch")}
        n504 = 0
        for _ in range(50):
            try:
                with tracing.request_context("gold",
                                             time.monotonic() - 0.01):
                    serving.score_payload(m, _payload(rows[:1], names))
            except qos.DeadlineExceeded:
                n504 += 1
        os.environ["H2O3_SCORE_LINGER_MS"] = "50"
        try:
            for _ in range(5):
                try:
                    with tracing.request_context(
                            "gold", time.monotonic() + 0.01):
                        serving.score_payload(m, _payload(rows[:1], names))
                except qos.DeadlineExceeded:
                    n504 += 1
        finally:
            os.environ.pop("H2O3_SCORE_LINGER_MS", None)
        ds = {r: qos.SHED.value(reason=r) - s0[r] for r in s0}
        check(n504 == 55 and ds == {"admission": 50, "batch": 5},
              f"(az) {n504} deadline rejections, shed {ds}")
        with tracing.request_context("late", time.monotonic() - 1.0):
            dead = [mb._Request(np.zeros((5000, len(names)), np.float32),
                                5000) for _ in range(3)]
        d0, c0 = mb.DISPATCHES.value(), om.graph_capture_count()
        mb.MicroBatcher._dispatch_chunk(models["q"], dead)
        check(all(isinstance(r.error, qos.DeadlineExceeded) for r in dead)
              and mb.DISPATCHES.value() == d0
              and om.graph_capture_count() == c0,
              "(az) an all-dead batch reached the device")
        out["n504"], out["shed"] = n504, ds
        # the job quota
        os.environ["H2O3_QOS_MAX_JOBS"] = "1"
        try:
            from h2o3_tpu_torch.core.jobs import DONE, Job
            sub = _sub_frame(fr, 1_000_000)
            go = threading.Event()
            # a job of gold's (as a train() runs in one) holds its one
            # slot until `go` is set
            with tracing.request_context("gold"):
                holder = Job("quota holder").start(lambda job: go.wait(30))
            held = dict(qos._job_counts).get("gold")
            q0 = qos.REJECTS.value(principal="gold", reason="quota")
            quota = None
            try:
                with tracing.request_context("gold"):
                    h2o.H2OGeneralizedLinearEstimator(
                        **dict(GLM_K, nfolds=0)).train(
                        y="y", training_frame=sub)
            except qos.QuotaExceeded as e:
                quota = e
            finally:
                go.set()
                holder.join(30)
            freed = not qos._jobs_series()
            check(held == 1 and quota is not None and freed
                  and holder.status == DONE
                  and qos.REJECTS.value(principal="gold", reason="quota")
                  == q0 + 1,
                  f"(az) job quota: held {held}, raised {quota!r}, "
                  f"freed {freed}")
            DKV.remove(sub.key)
        finally:
            os.environ.pop("H2O3_QOS_MAX_JOBS", None)
        # chaos: one failed dispatch retried over the epoch change
        os.environ["H2O3_SCORE_LINGER_MS"] = "50"
        try:
            chaos.install("point=microbatch.dispatch,action=fail,times=1")
            e0 = membership.EPOCH_RETRIES.value(op="microbatch")
            d0 = mb.DISPATCHES.value()
            bodies = [rows[8 * i:8 * i + 8] for i in range(8)]
            got = [None] * 8
            errs = []

            def one(i):
                try:
                    got[i] = serving.score_payload(
                        m, _payload(bodies[i], names))
                except Exception as e:      # noqa: BLE001 — reported
                    errs.append(repr(e))
            _run_threads([threading.Thread(target=one, args=(i,))
                          for i in range(8)])
            chaos.reset()
            answered = sum(
                g is not None and np.array_equal(
                    _answer("b", g, "payload"), ref["b"][8 * i:8 * i + 8])
                for i, g in enumerate(got))
            retries = membership.EPOCH_RETRIES.value(op="microbatch") - e0
            check(not errs and answered == 8 and retries == 1,
                  f"(az) chaos fail: {answered}/8 answered, {retries} "
                  f"retries, {errs[:2]}")
            out["chaos_dispatches"] = mb.DISPATCHES.value() - d0
            out["retries"] = retries
            # chaos: a delay past the follower's watch deadline trips the
            # watchdog once, with a dump naming the leader
            os.environ["H2O3_WATCHDOG_STALL_S"] = "0.3"
            os.environ["H2O3_WATCHDOG_POLL_S"] = "0.05"
            watchdog.reset()
            tr0 = watchdog.TRIPS.value(kind="microbatch")
            chaos.install("point=microbatch.dispatch,action=delay,"
                          "delay_s=1.5,times=1")
            got = [None] * 2
            _run_threads([threading.Thread(
                target=lambda i=i: got.__setitem__(i, serving.score_payload(
                    m, _payload(rows[i:i + 1], names))),
                name=f"watch-probe-{i}") for i in range(2)])
            chaos.reset()
            trips = watchdog.WATCHDOG.trips()
            recorder.RECORDER.flush()
            spans = recorder.RECORDER.load_trace(trips[0]["trace"]) \
                if trips else []
            sp = next((s for s in spans if s["name"] == "watchdog.trip"),
                      None)
            dump = sp["attrs"]["jstack"] if sp else ""
            leader = None
            for block in dump.split('--- thread "')[1:]:
                name, _, stack = block.partition('"')
                if "_dispatch_chunk" in stack and "chaos.py" in stack:
                    leader = name
            stalled = sp["attrs"]["stalls"][0]["thread"] if sp else None
            dtrips = watchdog.TRIPS.value(kind="microbatch") - tr0
            check(len(trips) == 1 and dtrips == 1 and all(got)
                  and leader is not None
                  and leader.startswith("watch-probe-")
                  and stalled.startswith("watch-probe-")
                  and leader != stalled,
                  f"(az) watchdog: {len(trips)} trips, leader {leader}, "
                  f"stalled {stalled}")
            out["trip"] = (leader, stalled)
        finally:
            chaos.reset()
            watchdog.reset()
            _set_env(H2O3_SCORE_LINGER_MS=None, H2O3_WATCHDOG_STALL_S=None,
                     H2O3_WATCHDOG_POLL_S=None)
    finally:
        _set_env(**old)
        qos.reset()
    return out


def _shifted(torch, fr, col, by):
    """`fr` with column `col` moved by `by` (the other columns shared)."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    return Frame(fr.names, [
        Vec.from_tensor(v.as_f32() + by, type=v.type, domain=v.domain)
        if n == col else v for n, v in zip(fr.names, fr.vecs)])


def _timed_baseline(torch, m, fr):
    from h2o3_tpu_torch.obs import modelmon
    _sync(torch)
    t0 = time.perf_counter()
    prof = modelmon.install_baseline(m, fr)
    _sync(torch)
    check(prof is not None, f"(ba) no baseline for {m.key}")
    return time.perf_counter() - t0


def qos_drift_run(torch, h2o, models, fr, valid):
    """(ba): drift of the 1M validation rows against (b)'s and (k)'s
    baselines from their 11M-row training frame; one feature shifted by
    one sd; retrains under (k)'s key; DELETE; the pressure document."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.obs import modelmon, usage
    # every batch folds (no duty cycle), a stride sample of at most
    # DRIFT_TAP_ROWS rows of it (the tap's own bound on one fold's cost)
    old = _set_env(H2O3_MODELMON_TAP_ROWS=DRIFT_TAP_ROWS,
                   H2O3_MODELMON_TAP_PCT=100, H2O3_MODELMON_EVAL_S=0)
    out = {}
    try:
        b, k = models["b"], models["k"]
        # fresh monitoring states: a baseline installed over a monitored
        # key keeps its tap's duty-cycle deferral, which (ay)'s and (az)'s
        # traffic at the default share set and a slow host stretches past
        # this run's scoring (then none of its rows fold)
        for m in (b, k):
            modelmon.forget(m.key)
        times = [_timed_baseline(torch, b, fr),
                 _timed_baseline(torch, k, fr)]
        # the card's counts against numpy's on the first 1M training rows
        from h2o3_tpu_torch.serving import scorer_cache as SC
        sub = _sub_frame(fr, 1_000_000)
        di = b._dinfo
        card = modelmon.build_baseline(di, modelmon.FrameColumns(
            sub, di.raw_columns(), sub.vecs[0].device), None)
        host = modelmon.build_baseline(
            di, SC.stage_frame(di, di.adapt(sub), sub.nrows), None)
        same = (all(np.array_equal(x, y)
                    for x, y in zip(card.counts, host.counts))
                and np.array_equal(card.na, host.na)
                and all(f.get("codes") == g.get("codes")
                        and np.array_equal(f.get("edges", ()),
                                           g.get("edges", ()))
                        for f, g in zip(card.features, host.features)))
        check(same, "(ba) the card's baseline counts differ from numpy's")
        out["base_rows"] = sub.nrows
        n = valid.nrows
        scored = om.REGISTRY.get("h2o3_model_scored_rows_total")
        s0 = {m.key: scored.value(model=m.key) for m in (b, k)}
        for m in (b, k):
            serving.score_frame(m, valid)
        docs = modelmon.evaluate()
        gen0 = docs[k.key]["generation"]
        psi = {t: {f["name"]: f["psi"] for f in docs[m.key]["features"]}
               for t, m in (("b", b), ("k", k))}
        folded = -(-n // -(-n // DRIFT_TAP_ROWS))     # the stride sample
        check(all(docs[m.key]["rows"] == folded
                  and scored.value(model=m.key) - s0[m.key] == n
                  for m in (b, k)),
              f"(ba) rows folded {[docs[m.key]['rows'] for m in (b, k)]} "
              f"of {folded}")
        check(all(v < 0.1 for d in psi.values() for v in d.values()),
              f"(ba) unshifted PSI {psi}")
        quiet = {t: modelmon.DRIFT.value(model=m.key, feature_kind="numeric")
                 for t, m in (("b", b), ("k", k))}
        # the same rows with one feature moved by its sd, through (b) on a
        # fresh generation of its baseline
        times.append(_timed_baseline(torch, b, fr))
        sd = float(valid.vec(DRIFT_SHIFT_COL).as_f32().double().std())
        sh = _shifted(torch, valid, DRIFT_SHIFT_COL, sd)
        serving.score_frame(b, sh)
        doc = modelmon.evaluate()[b.key]
        spsi = {f["name"]: f["psi"] for f in doc["features"]}
        others = max(v for c, v in spsi.items() if c != DRIFT_SHIFT_COL)
        loud = modelmon.DRIFT.value(model=b.key, feature_kind="numeric")
        check(spsi[DRIFT_SHIFT_COL] > 0.25 and others < 0.1
              and loud == spsi[DRIFT_SHIFT_COL] and quiet["b"] < 0.1,
              f"(ba) shifted PSI {spsi}, gauge {loud}")
        DKV.remove(sh.key)
        # retrains under (k)'s key on 1M rows: generation 2 has a
        # prediction distribution (11M rows exceed the fast path's 1<<20,
        # so (k)'s own baseline has none), generation 3 is compared to it
        gens = [k]
        for lam in (0.0, 1e-3):
            g = h2o.H2OGeneralizedLinearEstimator(
                **dict(GLM_K, nfolds=0, lambda_=lam, model_id=k.key))
            g.train(y="y", training_frame=sub)
            gens.append(g)
        serving.score_frame(gens[2], valid)
        serving.score_frame(gens[1], valid)       # the old object: shadow
        doc = modelmon.evaluate()[k.key]
        skew = om.REGISTRY.get("h2o3_model_generation_skew").value(
            model=k.key)
        check(doc["generation"] == gen0 + 2
              and doc["generation_skew"] is not None
              and skew == doc["generation_skew"]
              and doc["prev_rows"] == folded,
              f"(ba) generation skew {doc['generation_skew']} gauge {skew}")
        out.update(times=times, psi=psi, shifted=spsi, quiet=quiet,
                   loud=loud, skew=skew, sd=sd, folded=folded)
        # the pressure document
        press = usage.evaluate_pressure()
        dims = set(press["dimensions"])
        check(dims == {"queue", "utilization", "slo_burn", "tier_occupancy",
                       "tier_faults", "stalls", "drift"},
              f"(ba) pressure dimensions {sorted(dims)}")
        out["pressure"] = press["dimensions"]
        # DELETE: every per-model series once, the baseline key, forget
        for key in (b.key, k.key):
            h2o.remove(key)
        text = om.REGISTRY.prometheus_text()
        gone = all(f'model="{key}"' not in text
                   and DKV.get(modelmon.monitor_key(key)) is None
                   and not modelmon.forget(key) for key in (b.key, k.key))
        check(gone, "(ba) a model series outlived DELETE")
        DKV.remove(sub.key)
    finally:
        _set_env(**old)
    return out


def phase_qos_serving(torch, h2o, HC, n_requests=QOS_REQUESTS,
                      n_threads=QOS_THREADS):
    """Runs (ay)-(ba)."""
    from h2o3_tpu_torch.analysis import lockdep
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import modelmon, usage
    from h2o3_tpu_torch.serving import qos
    from h2o3_tpu_torch.serving import scorer_cache as SC
    t_phase = time.perf_counter()
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    blobs = _blob_frame(torch, dev, HIGGS_N, 12)[0] if "t" not in KEPT \
        else None
    blobs_valid, _ = _blob_frame(torch, dev, QOS_POOL, 12)
    models = _kept_models(torch, h2o, fr, valid, blobs,
                          label="qos serving (ay)")
    models = {t: models[t] for t in ("b", "k", "q", "t")}
    for m in models.values():
        DKV.put(m.key, m)
    if blobs is not None:
        DKV.remove(blobs.key)
    del blobs
    from h2o3_tpu_torch import udf
    udf.register_udf("chip_logloss", _logloss_udf(torch))
    modelmon.reset()
    usage.reset()
    qos.reset()
    fb0 = SC.FALLBACKS.value(reason="trace-error")
    # (b) and (k) monitored as their 11M-row train() leaves them
    t_base = [_timed_baseline(torch, models[t], fr) for t in ("b", "k")]
    names = [f"x{j}" for j in range(HIGGS_C)]
    vsub = _sub_frame(valid, QOS_POOL)
    pools = {}
    for t, m in models.items():
        src = blobs_valid if t == "t" else vsub
        pools[t] = SC.stage_frame(m._dinfo, m._dinfo.adapt(src), QOS_POOL)
    DKV.remove(vsub.key)
    # every bucket a coalesced dispatch can reach, captured off the clock
    for t in models:
        b = SC.row_bucket(1)
        while b <= SC.row_bucket(64 * n_threads):
            SC.score_rows(models[t], pools[t][:b] if b <= QOS_POOL else
                          np.resize(pools[t], (b, HIGGS_C)), 1)
            b <<= 1
    ref, alone_worst = _qos_reference(torch, models, pools)
    lockdep.reset()
    lockdep.enable("raise")
    try:
        runs = {}
        for linger in ("2", "0"):
            r = qos_coalesced_run(torch, h2o, models, pools, names, ref,
                                  linger, n_requests, n_threads)
            runs[linger] = r
            say(f"qos serving (ay) {n_requests:,} requests from "
                f"{n_threads} threads (sizes 1/8/64 rows at 70/20/10%, "
                f"half score_payload, half predict_via_rest, over (b), "
                f"(k), (q), (t)) at H2O3_SCORE_LINGER_MS={linger}: "
                f"{r['rps']:,.0f} requests/s warm, p50/p99 "
                f"{r['p50']:.3f}/{r['p99']:.3f} ms (p50 payload "
                f"{r['p50_payload']:.3f}, frame {r['p50_frame']:.3f}); "
                f"{r['requests']:.0f} micro-batched requests in "
                f"{r['dispatches']:.0f} dispatches = "
                f"{r['per_dispatch']:.2f} requests "
                f"({r['rows_per_dispatch']:.1f} rows) a dispatch; "
                f"{r['lost']} lost, {r['twice']} answered twice, "
                f"{r['wrong']} wrong; largest |diff| vs the pool's rows "
                f"{ {t: float(v) for t, v in r['worst'].items()} }; the "
                f"mean waterfall (ms) of the {r['tail']['n']} requests at "
                f"or above p99 {_split_text(r['tail'])} (requests of each "
                f"model among them {r['tail_models']})")
            check(r["lost"] == 0 and r["twice"] == 0 and r["wrong"] == 0,
                  f"(ay) linger {linger}: {r['lost']} lost, {r['twice']} "
                  f"twice, {r['wrong']} wrong")
            check(r["requests"] == r["batched"],
                  f"(ay) {r['requests']} micro-batched of {r['batched']}")
        check(runs["2"]["per_dispatch"] > runs["0"]["per_dispatch"],
              "(ay) the linger coalesced nothing")
        say(f"qos serving (ay) 200 request row sets scored alone in their "
            f"own bucket vs the same rows in the pool's dispatch: GBM and "
            f"KMeans bit for bit, GLM/DL largest |diff| {alone_worst:.3g} "
            f"(tolerance {QOS_TOL:g}); the DL net's largest |diff| under "
            f"coalescing {float(runs['2']['worst']['q']):.3g}")
        t0 = time.perf_counter()
        az = qos_tenants_run(torch, h2o, models, pools, names, ref, fr)
        t_az = time.perf_counter() - t0
        counts = lockdep.counts()
        ba = qos_drift_run(torch, h2o, models, fr, valid)
    finally:
        lockdep.disable()
    check(lockdep.counts()["inversions"] == 0,
          "(ay)-(ba) lock-order inversion")
    fl = az["outcome"]["flood"]
    say(f"qos serving (az) gold/silver/flood at weights 4:1:1, one device "
        f"slot, flood rate {QOS_FLOOD_RPS}/s, queue depth "
        f"{QOS_QUEUE_DEPTH} (share cap {QOS_QUEUE_DEPTH // 2}): gold "
        f"p50/p99 {az['gold_alone'][0]:.3f}/{az['gold_alone'][1]:.3f} ms "
        f"alone, {az['gold'][0]:.3f}/{az['gold'][1]:.3f} ms under the "
        f"flood (silver {az['silver'][0]:.3f}/{az['silver'][1]:.3f}); "
        f"flood {fl.get('ok', 0)} ok, {fl.get('429', 0)} 429 "
        f"(RateLimited), {fl.get('503', 0)} 503 (QueueFull); gold and "
        f"silver none; {az['n504']} 504 (shed {az['shed']}); an all-dead "
        f"batch no dispatch, no capture; ledger by principal "
        f"{ {p: round(v, 6) for p, v in az['by_p'].items()} } sums to "
        f"the total {az['total']:.6f} s within {az['share_err']:.2e}; "
        f"its (calls, rows) {az['led']}: the rows each principal's "
        f"answered requests sent, {az['dispatches']:.0f} calls = the "
        f"dispatches; gold's slowest 1% (ms a stage) "
        f"{_split_text(az['tail_alone'])} alone, "
        f"{_split_text(az['tail_gold'])} under the flood; "
        f"{az['n_stages']} waterfalls with queue, gate, decode, device; "
        f"a train() beside a job holding gold's one slot under "
        f"H2O3_QOS_MAX_JOBS=1 raised QuotaExceeded and the slot was "
        f"freed; chaos fail: 8/8 answered, "
        f"{az['retries']:.0f} epoch retry, {az['chaos_dispatches']:.0f} "
        f"dispatches; chaos delay: one watchdog trip, the dump names the "
        f"leader {az['trip'][0]} (stalled follower {az['trip'][1]}); "
        f"lockdep raising: {counts['edges']} edges, "
        f"{counts['inversions']} inversions; {t_az:.1f} s")
    fb = SC.FALLBACKS.value(reason="trace-error") - fb0
    check(fb == 0, f"(ay)-(ba) {fb} trace-error fallbacks")
    worst_psi = {t: round(max(d.values()), 6) for t, d in ba["psi"].items()}
    say(f"qos serving (ba) drift baseline of an {HIGGS_N:,}-row train "
        f"(install_baseline, as train() runs it): "
        f"{', '.join(f'{x:.3f}' for x in t_base + ba['times'])} s; its "
        f"counts on the card = numpy's on {ba['base_rows']:,} rows (the "
        f"edges equal); "
        f"{HIGGS_VALID_N:,} unshifted validation rows scored (the tap "
        f"folds a stride sample of {ba['folded']:,}): largest PSI "
        f"{worst_psi}, h2o3_model_drift{{numeric}} {ba['quiet']}; "
        f"{DRIFT_SHIFT_COL} moved by its sd {ba['sd']:.4f}: its PSI "
        f"{ba['shifted'][DRIFT_SHIFT_COL]:.4f}, the others' largest "
        f"{max(v for c, v in ba['shifted'].items() if c != DRIFT_SHIFT_COL):.4f}, "
        f"gauge {ba['loud']:.4f}; two retrains under (k)'s key: "
        f"h2o3_model_generation_skew {ba['skew']:.6f}; DELETE left no "
        f"series; pressure {ba['pressure']}; trace-error fallbacks "
        f"{fb:.0f}; lockdep raising through (ba): "
        f"{lockdep.counts()['inversions']} inversions")
    modelmon.reset()
    usage.reset()
    say(f"qos serving: the phase {time.perf_counter() - t_phase:.1f} s")
    DKV.clear()
    return runs["2"]


# ---------------------------------------------------------------------------
# (bb)-(bd): the REST front end — the port's H2OServer in this process,
# spoken to over loopback HTTP
REST_USERS = {"gold": "gold-pw", "silver": "silver-pw", "flood": "flood-pw"}
REST_REQUESTS = 3000         # (bc) requests over HTTP (of 5,000: time)
REST_PROCS = 4               # (bc) client processes ...
REST_THREADS = 16            # ... of 16 closed-loop threads each
REST_TENANT_REQUESTS = 20    # (bc) requests of each gold/silver thread
# (bc)'s tenants over HTTP: the flood's rate well below the ~100-140
# requests/s the server answers on an H100's host (so 429s), and a queue
# share of 6 of a depth of 16 (so 503s), which gold's and silver's 4
# threads each never reach, nor all three the depth (6 + 4 + 4 < 16)
REST_FLOOD_RPS, REST_QUEUE_DEPTH, REST_TENANT_SHARE = 20, 16, 0.375
REST_UNAUTH = 1000           # (bd) unauthenticated requests
REST_GUARDED = 100           # (bd) warm one-row predicts under the guard
REST_PROFILE_N = 1_000_000   # (bd) rows of the profiled two-tree build
REST_GBM = dict(HIGGS_DEFAULT, ntrees=10)   # (b) cut to 10 of 50 trees
REST_SENT = [0]              # requests this process sent to a server
_SENT_LOCK = threading.Lock()

# the (bc) client: stdlib only, so that a process starts in milliseconds
# and its interpreter lock holds no part of the server
_REST_CLIENT = r"""
import http.client, json, sys, threading, time
job = json.load(open(sys.argv[1]))
reqs, out = job["requests"], [None] * len(job["requests"])
def client(th):
    for j in range(th, len(reqs), job["threads"]):
        i, path, body = reqs[j]
        t0 = time.perf_counter()
        try:
            c = http.client.HTTPConnection("127.0.0.1", job["port"],
                                           timeout=300)
            c.request("POST", path, body=body.encode(), headers={
                "Content-Type": "application/json",
                "Authorization": job["auth"]})
            r = c.getresponse()
            raw = r.read()
            c.close()
            out[j] = [i, r.status, time.perf_counter() - t0,
                      r.getheader("Server-Timing"), raw.decode()]
        except Exception as e:
            out[j] = [i, -1, time.perf_counter() - t0, None, repr(e)]
ts = [threading.Thread(target=client, args=(th,))
      for th in range(job["threads"])]
while time.time() < job["start_at"]:
    time.sleep(0.001)
t0 = time.time()
for t in ts:
    t.start()
for t in ts:
    t.join()
json.dump({"t0": t0, "t1": time.time(), "out": out}, open(sys.argv[2], "w"))
"""


def _basic(user):
    import base64
    return "Basic " + base64.b64encode(
        f"{user}:{REST_USERS[user]}".encode()).decode()


def _http(port, method, path, data=None, body=None, user=None,
          headers=None):
    """One request over loopback: (status, lower-cased headers, the JSON
    answer or the raw bytes). Counted in REST_SENT."""
    import http.client
    import urllib.parse
    hdrs = dict(headers or {})
    if user is not None:
        hdrs["Authorization"] = _basic(user)
    if data is not None:
        body = urllib.parse.urlencode(
            {k: (json.dumps(v) if isinstance(v, (list, dict)) else str(v))
             for k, v in data.items()}).encode()
        hdrs["Content-Type"] = "application/x-www-form-urlencoded"
    elif isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
        hdrs["Content-Type"] = "application/json"
    with _SENT_LOCK:
        REST_SENT[0] += 1
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request(method, path, body=body, headers=hdrs)
    r = c.getresponse()
    raw = r.read()
    h = {k.lower(): v for k, v in r.getheaders()}
    c.close()
    try:
        return r.status, h, json.loads(raw) if raw else None
    except ValueError:
        return r.status, h, raw


def _rest_ok(port, method, path, schema, **kw):
    st, h, js = _http(port, method, path, **kw)
    check(st == 200 and isinstance(js, dict)
          and js.get("__meta", {}).get("schema_type") == schema,
          f"(bd) {method} {path}: {st} {str(js)[:300]}")
    return h, js


def _rest_job(port, key, user="gold"):
    while True:
        st, _, js = _http(port, "GET", f"/3/Jobs/{key}", user=user)
        check(st == 200, f"job {key}: {st} {js}")
        j = js["jobs"][0]
        if j["status"] in ("DONE", "FAILED", "CANCELLED"):
            check(j["status"] == "DONE", f"job {key}: {j}")
            return j
        time.sleep(0.02)


def _frames_bits_equal(torch, a, b):
    return a.names == b.names and a.types == b.types and all(
        va.levels() == vb.levels() and torch.equal(
            va.as_f32().view(torch.int32), vb.as_f32().view(torch.int32))
        for va, vb in zip(a.vecs, b.vecs))


def _timings(header):
    """Server-Timing `stage;dur=ms, ...` as {stage: seconds}."""
    out = {}
    for part in (header or "").split(","):
        name, _, dur = part.strip().partition(";dur=")
        if name and dur:
            out[name] = float(dur) / 1e3
    return out


def rest_main_path_run(torch, h2o, HC, port, fr, valid, tmp, path):
    """(bb): the main path over REST at HIGGS width — parse of (ap)'s CSV
    at `path`, GBM build, predictions and their metrics, the MOJO, Rapids
    — each against its in-process counterpart."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.rapids import rapids_exec
    out = {}
    # parse: ImportFiles, ParseSetup, Parse polled through /3/Jobs, of
    # the file (ap) wrote
    mem, size = _sub_frame(fr, HIGGS_CSV_N), os.path.getsize(path)
    _, imp = _rest_ok(port, "GET", "/3/ImportFiles?path=" + path,
                      "ImportFilesV3", user="gold")
    _, setup = _rest_ok(port, "POST", "/3/ParseSetup", "ParseSetupV3",
                        data={"source_frames": imp["destination_frames"]},
                        user="gold")
    t0 = time.perf_counter()
    pf = h2o.import_file(path, col_types={"y": "enum"})
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, p = _rest_ok(port, "POST", "/3/Parse", "ParseV3", user="gold", data={
        "source_frames": [path], "destination_frame": "higgs_rest.csv.hex",
        "column_names": setup["column_names"],
        "column_types": {"y": "enum"}})
    _rest_job(port, p["job"]["key"])
    torch.cuda.synchronize()
    t_rest = time.perf_counter() - t0
    rf = DKV.get("higgs_rest.csv.hex")
    same = _frames_bits_equal(torch, rf, pf) and \
        _frames_bits_equal(torch, rf, mem)
    check(same, "(bb) the REST-parsed frame differs from import_file's")
    out["parse"] = (size, t_rest, t_in, setup["column_types"][:2])
    for f in (rf, pf, mem):
        DKV.remove(f.key)
    # GBM: (b)'s configuration over REST and through train()
    form = dict(REST_GBM, training_frame=fr.key, response_column="y",
                model_id="rest_gbm_b")
    HC.reset_launches()
    t0 = time.perf_counter()
    _, b = _rest_ok(port, "POST", "/3/ModelBuilders/gbm",
                    "ModelBuilderJobV3", data=form, user="gold")
    _rest_job(port, b["job"]["key"])
    torch.cuda.synchronize()
    t_gbm_rest = time.perf_counter() - t0
    m = DKV.get("rest_gbm_b")
    per_rest = {k: v / REST_GBM["ntrees"] for k, v in HC.LAUNCHES.items()
                if v}
    HC.reset_launches()
    t0 = time.perf_counter()
    ref = h2o.H2OGradientBoostingEstimator(**REST_GBM)
    ref.train(y="y", training_frame=fr)
    torch.cuda.synchronize()
    t_gbm_in = time.perf_counter() - t0
    per_in = {k: v / REST_GBM["ntrees"] for k, v in HC.LAUNCHES.items()
              if v}
    trees_same = _trees_equal(torch, m._trees, ref._trees)
    check(trees_same, "(bb) the REST-built GBM's trees differ from train()'s")
    check(per_rest == per_in == PER_TREE["default"],
          f"(bb) launches per tree REST {per_rest}, train() {per_in}")
    out["gbm"] = (t_gbm_rest, t_gbm_in, per_rest)
    DKV.remove(ref.key)
    # predictions on the 1M validation rows, with their metrics
    _, pr = _rest_ok(port, "POST",
                     f"/3/Predictions/models/{m.key}/frames/{valid.key}",
                     "ModelMetricsListSchemaV3", user="gold",
                     data={"predictions_frame": "rest_pred_b"})
    rp = DKV.get("rest_pred_b")
    ip = m.predict(valid)
    check(_frames_bits_equal(torch, rp, ip),
          "(bb) REST predictions differ from predict's")
    auc_rest = pr["model_metrics"][0]["auc"]
    auc_in = m.model_performance(valid).auc
    check(auc_rest == auc_in, f"(bb) AUC {auc_rest} vs {auc_in}")
    out["auc"] = auc_rest
    out["pred"] = (rp.names, [v.as_f32().cpu() for v in rp.vecs])
    # the MOJO bytes through import_mojo
    st, h, raw = _http(port, "GET", f"/3/Models/{m.key}/mojo", user="gold")
    check(st == 200 and h["content-type"] == "application/zip",
          f"(bb) mojo: {st}")
    mpath = os.path.join(tmp, "rest_gbm_b.zip")
    with open(mpath, "wb") as f:
        f.write(raw)
    gen = h2o.import_mojo(mpath)
    gp = gen.predict(valid)
    d = float((gp.vec("p1").as_f32() - ip.vec("p1").as_f32()).abs().max())
    check(d <= EXPORT_TOL, f"(bb) MOJO vs predict {d}")
    out["mojo"] = (len(raw), d)
    for f in (rp, ip, gp):
        DKV.remove(f.key)
    # Rapids: a group-by and a row filter against rapids_exec
    exprs = [f'(GB {fr.key} [28] mean 0 "all" nrow 0 "all")',
             f"(rows {fr.key} (> (cols {fr.key} [0]) 1.5))"]
    rows = []
    for e in exprs:
        _, r = _rest_ok(port, "POST", "/99/Rapids", "RapidsFrameV3",
                        data={"ast": e}, user="gold")
        a = DKV.get(r["key"]["name"])
        b2 = rapids_exec(e)
        check(_frames_bits_equal(torch, a, b2),
              f"(bb) REST Rapids differs: {e}")
        rows.append(a.nrows)
        DKV.remove(a.key)
        DKV.remove(b2.key)
    out["rapids"] = rows
    return m, out


def rest_traffic_run(torch, port, models, pools, names, tmp):
    """(bc): (ay)'s mix of requests over HTTP from REST_PROCS client
    processes of REST_THREADS closed-loop threads, POST
    /3/Predictions/models/{m}; every answer against score_payload of its
    rows alone. The server's process CPU time over the traffic, and that
    of its handler threads (each request's thread: HTTP, auth, JSON and
    the serving work it runs, a micro-batch leader's dispatch included)."""
    from h2o3_tpu_torch import serving
    from h2o3_tpu_torch.api import server as S
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import microbatch as mb
    rng = np.random.default_rng(37)
    n = REST_REQUESTS
    tags = rng.choice(list("bkqt"), n)
    sizes = rng.choice(QOS_SIZES, n, p=QOS_SIZE_P)
    offs = rng.integers(0, QOS_POOL - 64, n)
    bodies = [_payload(pools[t][o:o + k], names)
              for t, o, k in zip(tags, offs, sizes)]
    jobs = [[] for _ in range(REST_PROCS)]
    for i in range(n):
        jobs[i % REST_PROCS].append(
            [i, f"/3/Predictions/models/{models[tags[i]].key}",
             json.dumps({"rows": bodies[i]})])
    start_at = time.time() + 3.0
    procs, outs = [], []
    for p, reqs in enumerate(jobs):
        jf = os.path.join(tmp, f"client{p}.json")
        of = os.path.join(tmp, f"client{p}.out.json")
        with open(jf, "w") as f:
            json.dump({"port": port, "auth": _basic("gold"),
                       "threads": REST_THREADS, "start_at": start_at,
                       "requests": reqs}, f)
        procs.append(subprocess.Popen([sys.executable, "-c", _REST_CLIENT,
                                       jf, of]))
        outs.append(of)
    c0, r0, d0 = om.graph_capture_count(), mb.REQUESTS.value(), \
        mb.DISPATCHES.value()
    handler_cpu, cpu_lock, handle = [0.0], threading.Lock(), \
        S._Handler.handle

    def timed_handle(self):
        t = time.thread_time()
        try:
            handle(self)
        finally:
            with cpu_lock:
                handler_cpu[0] += time.thread_time() - t

    S._Handler.handle = timed_handle
    try:
        time.sleep(max(start_at - time.time(), 0.0))
        cpu0 = time.process_time()
        rcs = [pr.wait(timeout=600) for pr in procs]
        cpu = time.process_time() - cpu0
    finally:
        S._Handler.handle = handle
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    check(rcs == [0] * REST_PROCS, f"(bc) client processes exited {rcs}")
    captures = om.graph_capture_count() - c0
    dr, dd = mb.REQUESTS.value() - r0, mb.DISPATCHES.value() - d0
    with _SENT_LOCK:
        REST_SENT[0] += n
    res = [None] * n
    t0s, t1s = [], []
    for of in outs:
        with open(of) as f:
            o = json.load(f)
        t0s.append(o["t0"])
        t1s.append(o["t1"])
        for i, st, dt, timing, raw in o["out"]:
            res[i] = (st, dt, timing, raw)
    check(all(r is not None and r[0] == 200 for r in res),
          f"(bc) answers not 200: "
          f"{[(r[0], r[3][:200]) for r in res if r[0] != 200][:3]}")
    # every answer against its rows scored alone, in their own dispatch
    t_verify = time.perf_counter()
    old = _set_env(H2O3_SCORE_LINGER_MS="0")
    wrong, worst = 0, {t: 0.0 for t in "bkqt"}
    try:
        for i in range(n):
            got = json.loads(res[i][3])["predictions"]
            want = serving.score_payload(models[tags[i]], bodies[i])
            tag = str(tags[i])
            exact = tag in "bt"
            for g, w in zip(got, want):
                for k, wv in w.items():
                    gv = g[k]
                    if isinstance(wv, str) or exact:
                        wrong += (gv != wv) and (exact or k != "predict")
                    else:
                        d = abs(float(gv) - float(wv))
                        worst[tag] = max(worst[tag], d)
                        wrong += d > QOS_TOL
            wrong += len(got) != len(want)
    finally:
        _set_env(**old)
    t_verify = time.perf_counter() - t_verify
    check(wrong == 0, f"(bc) {wrong} answers differ from score_payload "
          f"of their rows alone; largest |diff| {worst}")
    lat = np.array([r[1] for r in res])
    stages = [_timings(r[2]) for r in res]
    wall = max(t1s) - min(t0s)
    slow = lat >= _pctl(lat, 99)
    return {"rps": n / wall, "p50": _pctl(lat, 50) * 1e3,
            "p99": _pctl(lat, 99) * 1e3, "wall": wall,
            "cpu_ms": cpu / n * 1e3, "cores": cpu / wall,
            "handler_cpu_ms": handler_cpu[0] / n * 1e3,
            "per_dispatch": dr / max(dd, 1), "requests": dr,
            "dispatches": dd, "batched": int(sum(t != "t" for t in tags)),
            "captures": captures, "worst": worst, "t_verify": t_verify,
            "tail": _tail_split(lat, stages),
            "tail_models": {str(t): int(c) for t, c in zip(*np.unique(
                tags[slow], return_counts=True))}}


def rest_tenants_run(torch, port, m, rows, names):
    """(bc) continued: (az)'s tenants as the basic-auth users gold,
    silver and flood on one device slot — flood over its rate (429) and
    its queue share (503), both with Retry-After; a 0 ms deadline 504;
    gold and silver never refused."""
    from h2o3_tpu_torch.serving import qos
    old = _set_env(H2O3_QOS_WEIGHTS="gold:4,silver:1,flood:1",
                   H2O3_QOS_MAX_INFLIGHT=1,
                   H2O3_QOS_RATES=f"flood:{REST_FLOOD_RPS}",
                   H2O3_SCORE_QUEUE_DEPTH=REST_QUEUE_DEPTH,
                   H2O3_QOS_TENANT_SHARE=REST_TENANT_SHARE)
    outcome = {p: {} for p in REST_USERS}
    lock = threading.Lock()
    path = f"/3/Predictions/models/{m.key}"
    one = [{"rows": _payload(rows[o:o + 1], names)} for o in range(0, 512, 7)]
    big = [{"rows": _payload(rows[o:o + 64], names)}
           for o in range(0, 512, 7)]
    stop = []
    barrier = threading.Barrier(QOS_FLOOD_THREADS)

    def note(user, st, h):
        key = str(st) if st == 200 or "retry-after" in h or st == 504 \
            else f"{st} without Retry-After"
        with lock:
            outcome[user][key] = outcome[user].get(key, 0) + 1

    def tenant(user, th):
        for i in range(REST_TENANT_REQUESTS):
            st, h, _ = _http(port, "POST", path, user=user,
                             body=one[(th * 13 + i) % len(one)])
            note(user, st, h)

    def flood(th):
        barrier.wait()          # a burst first: the queue share
        i = th
        while not stop:
            st, h, _ = _http(port, "POST", path, user="flood",
                             body=big[i % len(big)])
            note("flood", st, h)
            if st != 200:
                time.sleep(0.001)
            i += QOS_FLOOD_THREADS
    try:
        qos.reset()
        fl = [threading.Thread(target=flood, args=(th,), daemon=True)
              for th in range(QOS_FLOOD_THREADS)]
        for t in fl:
            t.start()
        time.sleep(0.2)
        _run_threads([threading.Thread(target=tenant, args=(u, th))
                      for u in ("gold", "silver")
                      for th in range(QOS_TENANT_THREADS)])
        stop.append(1)
        for t in fl:
            t.join()
        st, h, _ = _http(port, "POST", path, user="gold", body=one[0],
                         headers={"X-H2O3-Deadline-Ms": "0"})
        note("gold", st, h)
    finally:
        _set_env(**old)
        qos.reset()
    n_ok = REST_TENANT_REQUESTS * QOS_TENANT_THREADS
    check(outcome["gold"] == {"200": n_ok, "504": 1}
          and outcome["silver"] == {"200": n_ok},
          f"(bc) gold/silver over REST: {outcome}")
    check(set(outcome["flood"]) <= {"200", "429", "503"}
          and outcome["flood"].get("429", 0) > 0
          and outcome["flood"].get("503", 0) > 0,
          f"(bc) the flood over REST: {outcome['flood']}")
    return outcome


def _rest_count(text):
    """Requests in h2o3_rest_request_seconds, over every label set."""
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("h2o3_rest_request_seconds_count"))


def rest_operations_run(torch, port, models, fr, tmp):
    """(bd): the operations surface of the server on the card."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.obs import usage
    out = {}
    _, cl = _rest_ok(port, "GET", "/3/Cloud", "CloudV3", user="gold")
    name = torch.cuda.get_device_name(0)
    check(cl["cloud_size"] == 1 and cl["nodes"][0]["h2o"] == name,
          f"(bd) /3/Cloud {cl}")
    _, ab = _rest_ok(port, "GET", "/3/About", "AboutV3", user="gold")
    about = {e["name"]: e["value"] for e in ab["entries"]}
    check(about["Backend"] == "torch/cuda" and about["Device"] == name,
          f"(bd) /3/About {about}")
    # 1,000 unauthenticated requests: 401, no QoS counter moved
    qos_lines = [ln for ln in om.REGISTRY.prometheus_text().splitlines()
                 if ln.startswith("h2o3_qos_")]
    codes = {}
    lock = threading.Lock()

    def unauth(th):
        for _ in range(REST_UNAUTH // 8):
            st, h, _ = _http(port, "POST", f"/3/Predictions/models/"
                             f"{models['b'].key}", body={"rows": []})
            key = (st, "www-authenticate" in h)
            with lock:
                codes[key] = codes.get(key, 0) + 1
    _run_threads([threading.Thread(target=unauth, args=(th,))
                  for th in range(8)])
    after = [ln for ln in om.REGISTRY.prometheus_text().splitlines()
             if ln.startswith("h2o3_qos_")]
    check(codes == {(401, True): REST_UNAUTH} and after == qos_lines,
          f"(bd) unauthenticated: {codes}; QoS lines moved "
          f"{sorted(set(after) ^ set(qos_lines))[:4]}")
    out["unauth"] = codes
    # the profiler around a two-tree REST build on 1M rows
    sub = _sub_frame(fr, REST_PROFILE_N)
    _, st = _rest_ok(port, "POST", "/3/Profiler", "ProfilerV3", user="gold",
                     data={"action": "start", "kind": "auto",
                           "trace_dir": os.path.join(tmp, "profile")})
    check(st["kind"] == "torch", f"(bd) profiler kind {st}")
    tid = "rest-bd-build"
    h, b = _rest_ok(port, "POST", "/3/ModelBuilders/gbm",
                    "ModelBuilderJobV3", user="gold",
                    headers={"X-H2O3-Trace-Id": tid},
                    data=dict(REST_GBM, ntrees=2, training_frame=sub.key,
                              response_column="y", model_id="rest_prof"))
    check(h.get("x-h2o3-trace-id") == tid, f"(bd) trace echo {h}")
    _rest_job(port, b["job"]["key"])
    torch.cuda.synchronize()
    _, sp = _rest_ok(port, "POST", "/3/Profiler", "ProfilerV3", user="gold",
                     data={"action": "stop"})
    check("trace" in sp and "error" not in sp, f"(bd) profiler stop {sp}")
    with open(sp["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            for k in ("fused_kernel", "radix_kernel", "route_kernel"):
                if k in e.get("name", ""):
                    kernels[k] = kernels.get(k, 0) + 1
    check(set(kernels) == {"fused_kernel", "radix_kernel", "route_kernel"},
          f"(bd) the trace's kernel events {kernels}")
    out["profile"] = (sp["seconds"], len(events), kernels,
                      os.path.getsize(sp["trace"]))
    DKV.remove("rest_prof")
    DKV.remove(sub.key)
    _, tr = _rest_ok(port, "GET", f"/3/Trace/{tid}", "TraceV3", user="gold")
    names = {s["name"] for s in tr["spans"]}
    check({"rest.request", "job.run"} <= names, f"(bd) trace spans {names}")
    out["trace"] = (tr["n_spans"], sorted(names)[:8])
    for path, schema in (("/3/Timeline", "TimelineV3"),
                         ("/3/JStack", "JStackV3"),
                         ("/3/Alerts", "AlertsV3"),
                         ("/3/CloudHealth", "CloudHealthV3"),
                         (f"/3/ModelMonitor/{models['b'].key}",
                          "ModelMonitorV3")):
        _rest_ok(port, "GET", path, schema, user="gold")
    _, us = _rest_ok(port, "GET", "/3/Usage", "UsageV3", user="gold")
    snap = usage.merge_usage([usage.usage_snapshot()])
    check(us["device_seconds_total"] == snap["device_seconds_total"]
          and us["ledger"] == snap["ledger"],
          f"(bd) /3/Usage {us['device_seconds_total']} vs the ledger "
          f"{snap['device_seconds_total']}")
    out["usage"] = (us["device_seconds_total"], len(us["ledger"]))
    # /metrics: the exposition grammar; every request of the phase in
    # h2o3_rest_request_seconds (the observe lands a hair after each
    # response: poll); the device gauge = torch.cuda.memory_allocated
    deadline = time.monotonic() + 10.0
    while _rest_count(om.REGISTRY.prometheus_text()) < REST_SENT[0] \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    sent = REST_SENT[0]
    st, h, raw = _http(port, "GET", "/metrics", user="gold")
    text = raw.decode() if isinstance(raw, bytes) else str(raw)
    allocated = torch.cuda.memory_allocated(0)
    bad = [ln for ln in text.splitlines() if not _PROM_LINE.fullmatch(ln)]
    n_scraped = _rest_count(text)
    dev_bytes = _series_value(text, "h2o3_device_memory_bytes",
                              {"device": "0", "kind": "bytes_in_use"})
    check(st == 200 and not bad and n_scraped == sent
          and dev_bytes == allocated,
          f"(bd) /metrics: {len(bad)} lines outside the grammar "
          f"{bad[:2]}; h2o3_rest_request_seconds counts {n_scraped} of "
          f"{sent}; device bytes {dev_bytes} vs {allocated}")
    out["metrics"] = (len(text.splitlines()), n_scraped, dev_bytes)
    return out


def rest_guarded_run(torch, m, rows, names):
    """(bd) continued: a second server started with
    H2O3_TRANSFER_GUARD=disallow (torch's sync debug mode "error",
    process-wide): REST_GUARDED warm one-row predicts answer 200, and an
    .item() on a card tensor raises, so the guard is live."""
    from h2o3_tpu_torch.api import server as S
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.serving import scorer_cache as SC
    old = _set_env(H2O3_TRANSFER_GUARD="disallow")
    srv = None
    try:
        body = {"rows": _payload(rows[:1], names)}
        srv = S.H2OServer(port=0).start()
        mode = torch.cuda.get_sync_debug_mode()
        c0 = om.graph_capture_count()
        f0 = SC.FALLBACKS.value(reason="trace-error")
        codes = {}
        for i in range(REST_GUARDED):
            st, _, js = _http(srv.port, "POST",
                              f"/3/Predictions/models/{m.key}", body=body)
            codes[st] = codes.get(st, 0) + 1
            if st != 200:
                say(f"rest (bd) guarded predict {i}: {st} {str(js)[:300]}")
        live = False
        try:
            torch.ones(1, device="cuda").sum().item()
        except RuntimeError:
            live = True
        captures = om.graph_capture_count() - c0
        fb = SC.FALLBACKS.value(reason="trace-error") - f0
    finally:
        torch.cuda.set_sync_debug_mode("default")
        _set_env(**old)
        if srv is not None:
            srv.stop()
    check(mode == 2 and live and codes == {200: REST_GUARDED}
          and captures == 0 and fb == 0,
          f"(bd) under the transfer guard: mode {mode}, guard live {live}, "
          f"answers {codes}, captures {captures}, trace-error fallbacks "
          f"{fb}")
    return codes


def phase_rest(torch, h2o, HC, higgs_csv, ay, card, cloud=None):
    """Runs (bb)-(bd): the port's H2OServer in this process with a
    basic-auth file of three users, spoken to over loopback HTTP; lockdep
    and leaktrack raising over the whole phase. `higgs_csv` is (ap)'s file
    (run alone: `_write_higgs_csv` of the HIGGS frame first), `ay` (ay)'s
    numbers at a 2 ms linger from the same call (or None), `card`
    nvidia-smi's name and power limit."""
    from h2o3_tpu_torch.analysis import leaktrack, lockdep
    from h2o3_tpu_torch.api import server as S
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.obs import metrics as om
    from h2o3_tpu_torch.obs import modelmon, watchdog
    from h2o3_tpu_torch.serving import scorer_cache as SC
    t_phase = time.perf_counter()
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    DKV.put(fr.key, fr)
    DKV.put(valid.key, valid)
    if cloud is not None:
        save_cloud_frames(torch, fr, valid, cloud)     # for (bh)
    blobs = _blob_frame(torch, dev, HIGGS_N, 12)[0] if "t" not in KEPT \
        else None
    blobs_valid, _ = _blob_frame(torch, dev, QOS_POOL, 12)
    models = _kept_models(torch, h2o, fr, valid, blobs, label="rest (bb)")
    models = {t: models[t] for t in ("b", "k", "q", "t")}
    for m in models.values():
        DKV.put(m.key, m)
    if blobs is not None:
        DKV.remove(blobs.key)
    del blobs
    from h2o3_tpu_torch import udf
    udf.register_udf("chip_logloss", _logloss_udf(torch))
    modelmon.reset()
    _timed_baseline(torch, models["b"], fr)
    names = [f"x{j}" for j in range(HIGGS_C)]
    vsub = _sub_frame(valid, QOS_POOL)
    pools = {}
    for t, m in models.items():
        src = blobs_valid if t == "t" else vsub
        pools[t] = SC.stage_frame(m._dinfo, m._dinfo.adapt(src), QOS_POOL)
    DKV.remove(vsub.key)
    # every bucket a request can reach, captured here on the main thread
    for t in models:
        b = SC.row_bucket(1)
        while b <= SC.row_bucket(64 * REST_PROCS * REST_THREADS):
            SC.score_rows(models[t], pools[t][:b] if b <= QOS_POOL else
                          np.resize(pools[t], (b, HIGGS_C)), 1)
            b <<= 1
    tmp = tempfile.mkdtemp(prefix="h2o3_rest_")
    auth = os.path.join(tmp, "realm.properties")
    with open(auth, "w") as f:
        f.write("".join(f"{u}:{p}\n" for u, p in REST_USERS.items()))
    REST_SENT[0] = 0
    lockdep.reset()
    lockdep.enable("raise")
    leaktrack.enable("raise")
    srv = S.H2OServer(port=0, auth=auth).start()
    try:
        t0 = time.perf_counter()
        m_b, bb = rest_main_path_run(torch, h2o, HC, srv.port, fr, valid,
                                     tmp, higgs_csv)
        t_bb = time.perf_counter() - t0
        BB.update(trees=m_b._trees.to("cpu"), pred=bb["pred"],
                  auc=bb["auc"], gbm=bb["gbm"], parse=bb["parse"])
        size, t_rest, t_in, types = bb["parse"]
        say(f"rest (bb) parse of (ap)'s {HIGGS_CSV_N:,}-row HIGGS CSV "
            f"({size / 1e6:.1f} MB) through "
            f"/3/ImportFiles, /3/ParseSetup (types {types}...) and "
            f"/3/Parse polled on /3/Jobs: {t_rest:.2f} s "
            f"({size / t_rest / 1e6:.1f} MB/s) against import_file "
            f"{t_in:.2f} s ({size / t_in / 1e6:.1f} MB/s) in the same call; "
            f"the frame = import_file's = the in-memory rows bit for bit")
        t_gr, t_gi, per = bb["gbm"]
        say(f"rest (bb) POST /3/ModelBuilders/gbm on the {HIGGS_N:,} x "
            f"{HIGGS_C} HIGGS frame at (b)'s configuration cut to "
            f"{REST_GBM['ntrees']} trees: {t_gr:.2f} s to the job's DONE "
            f"against train() {t_gi:.2f} s with the same keyword "
            f"arguments; the trees bit for bit; hist.cu launches per tree "
            f"{per} (= (ap)'s {PER_TREE['default']})")
        say(f"rest (bb) POST /3/Predictions on the {HIGGS_VALID_N:,} "
            f"validation rows: the predictions frame = predict's bit for "
            f"bit, model_metrics AUC {bb['auc']:.6f} = "
            f"model_performance's; GET /3/Models/{{m}}/mojo "
            f"{bb['mojo'][0]:,} bytes through import_mojo: largest "
            f"|p1 - predict| {bb['mojo'][1]:.3g} (<= {EXPORT_TOL:g}); "
            f"POST /99/Rapids group-by ({bb['rapids'][0]} groups) and row "
            f"filter ({bb['rapids'][1]:,} rows) = rapids_exec's bit for "
            f"bit; {t_bb:.1f} s")
        t0 = time.perf_counter()
        bc = rest_traffic_run(torch, srv.port, models, pools, names, tmp)
        if ay:
            BB["rps"] = (bc["rps"], ay["rps"])
        say(f"rest (bc) {REST_REQUESTS:,} requests over HTTP from "
            f"{REST_PROCS} client processes x {REST_THREADS} closed-loop "
            f"threads ((ay)'s mix: sizes 1/8/64 rows at 70/20/10%, over "
            f"(b), (k), (q), (t)) to POST /3/Predictions/models/{{m}} at "
            f"the default 2 ms linger, card {card}: "
            f"{bc['rps']:,.0f} requests/s, p50/p99 {bc['p50']:.3f}/"
            f"{bc['p99']:.3f} ms; {bc['requests']:.0f} micro-batched "
            f"requests in {bc['dispatches']:.0f} dispatches = "
            f"{bc['per_dispatch']:.2f} a dispatch; the server's process "
            f"CPU {bc['cpu_ms']:.3f} ms a request ({bc['cores']:.2f} "
            f"cores busy), its handler threads' {bc['handler_cpu_ms']:.3f} "
            f"ms; beside (ay) in process in this call: "
            + (f"{ay['rps']:,.0f} requests/s, p50/p99 {ay['p50']:.3f}/"
               f"{ay['p99']:.3f} ms (payload p50 {ay['p50_payload']:.3f}), "
               f"{ay['per_dispatch']:.2f} a dispatch, process CPU "
               f"{ay['cpu_ms']:.3f} ms a request ({ay['cores']:.2f} cores "
               f"busy, its client threads included); the server's own "
               f"overhead a request: serialized time (1/requests/s over "
               f"HTTP less in process) "
               f"{1e3 / bc['rps'] - 1e3 / ay['rps']:.3f} ms, process CPU "
               f"{bc['cpu_ms'] - ay['cpu_ms']:.3f} ms, p50 "
               f"{bc['p50'] - ay['p50_payload']:.3f} ms over (ay)'s "
               f"payload p50" if ay else "(ay) not run")
            + f"; the slowest 1% (ms a stage from Server-Timing) "
            f"{_split_text(bc['tail'])} (requests of each model "
            f"{bc['tail_models']}); every answer = score_payload of its "
            f"rows alone (GBM and KMeans bit for bit, GLM/DL largest "
            f"|diff| {max(bc['worst']['k'], bc['worst']['q']):.3g}; "
            f"checked in {bc['t_verify']:.1f} s); graph captures during "
            f"(bc) {bc['captures']:.0f}; {time.perf_counter() - t0:.1f} s")
        check(bc["captures"] == 0,
              f"(bc) {bc['captures']} captures on the handler threads")
        check(bc["requests"] == bc["batched"],
              f"(bc) {bc['requests']} micro-batched of {bc['batched']}")
        ten = rest_tenants_run(torch, srv.port, models["b"], pools["b"],
                               names)
        t_bc = time.perf_counter() - t0
        say(f"rest (bc) tenants over HTTP as basic-auth users (weights "
            f"4:1:1, one device slot, flood rate {REST_FLOOD_RPS}/s, queue "
            f"depth {REST_QUEUE_DEPTH}, share "
            f"{int(REST_QUEUE_DEPTH * REST_TENANT_SHARE)}): gold "
            f"{ten['gold']}, silver "
            f"{ten['silver']}, flood {ten['flood']} (every 429 and 503 "
            f"with Retry-After; gold's one 504 a 0 ms "
            f"X-H2O3-Deadline-Ms); {t_bc:.1f} s")
        t0 = time.perf_counter()
        bd = rest_operations_run(torch, srv.port, models, fr, tmp)
        codes = rest_guarded_run(torch, models["b"], pools["b"], names)
        t_bd = time.perf_counter() - t0
        say(f"rest (bd) /3/Cloud names {torch.cuda.get_device_name(0)}, "
            f"/3/About torch/cuda; {REST_UNAUTH} unauthenticated requests "
            f"{bd['unauth']} (401 with WWW-Authenticate), the QoS counters "
            f"unchanged; /3/Profiler kind torch around a 2-tree REST build "
            f"on {REST_PROFILE_N:,} rows: {bd['profile'][0]:.2f} s, "
            f"{bd['profile'][1]:,} trace events "
            f"({bd['profile'][3] / 1e6:.1f} MB), CUDA kernel events "
            f"{bd['profile'][2]}; /3/Trace of the build {bd['trace'][0]} "
            f"spans {bd['trace'][1]}, the X-H2O3-Trace-Id echoed; "
            f"/3/Timeline, /3/JStack, /3/Alerts, /3/CloudHealth, "
            f"/3/ModelMonitor/{{b}} 200; /3/Usage {bd['usage'][0]:.6f} "
            f"device-s over {bd['usage'][1]} ledger rows = the ledger; "
            f"/metrics {bd['metrics'][0]} lines in the grammar, "
            f"h2o3_rest_request_seconds counting all {bd['metrics'][1]:.0f} "
            f"requests of the phase, device bytes {bd['metrics'][2]:.0f} = "
            f"torch.cuda.memory_allocated; a second server under "
            f"H2O3_TRANSFER_GUARD=disallow: {REST_GUARDED} warm one-row "
            f"predicts {codes}, no capture, an .item() raised; "
            f"{t_bd:.1f} s")
        t_bg = bindings_run(torch, HC, srv.port, m_b, fr, valid, tmp)
    finally:
        srv.stop()
        leaktrack_reports = leaktrack.reports()
        deadline = time.monotonic() + 5.0
        while leaktrack.open_counts() and time.monotonic() < deadline:
            time.sleep(0.01)
        leak_open = leaktrack.open_counts()
        leaktrack.disable()
        inversions = lockdep.counts()["inversions"]
        lockdep.disable()
        watchdog.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    check(not leaktrack_reports and not leak_open,
          f"(bd) leaktrack: {leaktrack_reports[:3]} open {leak_open}")
    check(inversions == 0, f"(bb)-(bd) {inversions} lock-order inversions")
    say(f"rest (bd) leaktrack raising over the phase: 0 leaks, nothing "
        f"open; lockdep raising: {inversions} inversions; graph captures "
        f"so far {om.graph_capture_count():.0f}")
    modelmon.reset()
    KEPT.clear()
    say(f"rest: the phase {time.perf_counter() - t_phase:.1f} s")
    DKV.clear()
    return t_bg


class _BasicAuth(urllib.request.BaseHandler):
    """Sends one user's basic-auth header with every urllib request (the
    generated bindings speak plain urllib, and the server asks for
    auth)."""

    def __init__(self, user):
        self.header = _basic(user)

    def http_request(self, req):
        req.add_unredirected_header("Authorization", self.header)
        with _SENT_LOCK:
            REST_SENT[0] += 1
        return req


def bindings_run(torch, HC, port, m_b, fr, valid, tmp):
    """(bg): bindings/gen.py against the phase's server: the generated
    estimators module (standard library only) imported, a 10-tree GBM at
    (bb)'s configuration trained through its H2OGradientBoostingEstimator
    over HTTP on (bb)'s training frame (its trees = (bb)'s REST GBM's bit
    for bit), then its predict on the validation rows (= (bb)'s model's
    predict bit for bit)."""
    import importlib.util
    from h2o3_tpu_torch.bindings import gen_python
    from h2o3_tpu_torch.core.kvstore import DKV
    t_all = time.perf_counter()
    url = f"http://127.0.0.1:{port}"
    out = os.path.join(tmp, "bindings")
    urllib.request.install_opener(urllib.request.build_opener(
        _BasicAuth("gold")))
    try:
        t0 = time.perf_counter()
        names = gen_python(url, out)
        t_gen = time.perf_counter() - t0
        spec = importlib.util.spec_from_file_location(
            "h2o3_generated_estimators", os.path.join(out, "estimators.py"))
        gen = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gen)
        with open(os.path.join(out, "estimators.py")) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names} | {n.module for n in ast.walk(tree)
                                     if isinstance(n, ast.ImportFrom)}
        check(mods <= {"json", "time", "urllib.parse", "urllib.request"},
              f"(bg) the generated module imports {sorted(mods)}")
        conn = gen.H2OConnection(url)
        est = gen.H2OGradientBoostingEstimator(conn, model_id="bind_gbm_b",
                                               **REST_GBM)
        HC.reset_launches()
        t0 = time.perf_counter()
        est.train(y="y", training_frame=fr.key)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        per = {k: v / REST_GBM["ntrees"] for k, v in HC.LAUNCHES.items()
               if v}
        m = DKV.get(est.key)
        same = _trees_equal(torch, m._trees, m_b._trees)
        check(same, "(bg) the generated binding's GBM differs from (bb)'s")
        check(per == PER_TREE["default"], f"(bg) launches per tree {per}")
        t0 = time.perf_counter()
        dest = est.predict(valid.key)
        t_pred = time.perf_counter() - t0
        got, want = DKV.get(dest), m_b.predict(valid)
        check(_frames_bits_equal(torch, got, want),
              "(bg) the generated binding's predictions differ")
        for f in (got, want):
            DKV.remove(f.key)
        DKV.remove(m.key)
    finally:
        urllib.request.install_opener(None)
    say(f"rest (bg) bindings: gen_python against the server in "
        f"{t_gen:.2f} s ({len(names)} estimator classes, "
        f"NUM_SERVER_ROUTES {gen.NUM_SERVER_ROUTES}; imports "
        f"{sorted(mods)}); the generated H2OGradientBoostingEstimator "
        f"over HTTP at (bb)'s configuration ({REST_GBM['ntrees']} trees): "
        f"{t_train:.2f} s to DONE, the trees = (bb)'s REST GBM's bit for "
        f"bit, launches per tree {per}; predict of {valid.nrows:,} rows "
        f"{t_pred:.2f} s = (bb)'s predict bit for bit; "
        f"{time.perf_counter() - t_all:.1f} s")
    return time.perf_counter() - t_all


# ---------------------------------------------------------------------------
# run (bf): the h2o-py client at HIGGS width, and the self-benchmarks
CLIENT_BINS = [-100.0, -1.0, 0.0, 1.0, 100.0]


def _same_result(torch, a, b):
    """Two Rapids results bit for bit: frames column by column, numbers
    (NaN as NaN), lists element by element."""
    from h2o3_tpu_torch.core.frame import Frame
    if isinstance(a, Frame):
        return isinstance(b, Frame) and _frames_bits_equal(torch, a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same_result(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


def client_run(torch, h2o, card):
    """(bf): h2o3_tpu_torch.client on (b)'s 11M x 28 HIGGS frame made on
    the card: arithmetic over two columns, a boolean row filter, mean and
    sd, split_frame([0.75], seed=42), a group-by of a binned column with
    sum and count. Every Rapids text the client sent is sent again
    straight to rapids_exec, and each answer must be the client's bit for
    bit. Then utils/selfbench.run_all() on the card."""
    from h2o3_tpu_torch import client
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.rapids import rapids as R
    from h2o3_tpu_torch.utils import selfbench
    dev = h2o.init().device
    t_all = time.perf_counter()
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    torch.cuda.synchronize()
    sent = []

    def recording(expr, *a, **kw):
        out = R.rapids_exec(expr, *a, **kw)
        sent.append((expr, out))
        return out
    steps = {}

    def step(name, fn):
        n0 = len(sent)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = [time.perf_counter() - t0, len(sent) - n0, 0.0]
        return out
    saved = client.rapids_exec
    client.rapids_exec = recording
    try:
        hf = client.H2OFrame_from(fr)
        arith = step("x0 * 2 + x1", lambda: hf["x0"] * 2 + hf["x1"])
        sub = step("rows where x0 > 0", lambda: hf[hf["x0"] > 0])
        mean = step("mean x0", lambda: hf["x0"].mean())
        sd = step("sd x0", lambda: hf["x0"].sd())
        tr, te = step("split_frame [0.75] seed 42",
                      lambda: hf.split_frame([0.75], seed=42))
        gb = step("group_by cut(x0) sum x1 count", lambda: hf["x0"].cut(
            CLIENT_BINS).cbind(hf["x1"]).group_by(0).sum(1).count()
            .get_frame())
    finally:
        client.rapids_exec = saved
    # every text again, straight to rapids_exec: the same answers
    k = 0
    for name, st in steps.items():
        t0 = time.perf_counter()
        for expr, out in sent[k:k + st[1]]:
            again = R.rapids_exec(expr)
            check(_same_result(torch, out, again),
                  f"(bf) {name}: rapids_exec({expr[:80]}...) differs from "
                  "the client's answer")
        torch.cuda.synchronize()
        st[2] = time.perf_counter() - t0
        k += st[1]
    pos = int((fr.vec("x0").as_f32() > 0).sum())
    check(sub.nrows == pos and tr.nrows + te.nrows == HIGGS_N
          and gb.nrows == 4
          and float(gb.frame.vecs[-1].as_f32().sum()) == HIGGS_N
          and math.isfinite(mean) and math.isfinite(sd)
          and arith.nrows == HIGGS_N,
          f"(bf) shapes: filter {sub.nrows}, split {tr.nrows}+{te.nrows}, "
          f"groups {gb.nrows}")
    say(f"client (bf) on the {HIGGS_N:,} x {HIGGS_C} HIGGS frame: "
        + "; ".join(f"{n} {t:.3f} s ({c} Rapids texts, again through "
                    f"rapids_exec {t2:.3f} s, bit for bit)"
                    for n, (t, c, t2) in steps.items())
        + f"; filter {sub.nrows:,} rows, mean {mean:.6g}, sd {sd:.6g}, "
        f"split {tr.nrows:,} + {te.nrows:,}, {gb.nrows} groups")
    del arith, sub, tr, te, gb, hf, sent
    DKV.clear()
    t0 = time.perf_counter()
    sb = selfbench.run_all()
    t_sb = time.perf_counter() - t0
    lp, lp32, mb = sb["linpack"], sb["linpack_f32"], sb["memory_bandwidth"]
    check(all(x > 0 and math.isfinite(x) for x in (
        lp["gflops"], lp32["gflops"], mb["gbps"])), f"(bf) selfbench {sb}")
    say(f"client (bf) selfbench.run_all() on {card} in {t_sb:.2f} s: "
        f"triad a = b + 2c over {mb['elements']:,} f32 "
        f"{mb['gbps']:,.1f} GB/s (nominal HBM3 "
        f"{HBM_BYTES_S / 1e9:,.0f} GB/s); linpack n {lp['n']} bf16 "
        f"{lp['gflops'] / 1e3:,.1f} TFLOPS (published dense peak "
        f"{BF16_DENSE_PEAK / 1e12:,.0f}), f32 with TF32 off "
        f"{lp32['gflops'] / 1e3:,.1f} TFLOPS (published peak "
        f"{F32_OPS_S / 1e12:,.0f}); device reductions "
        + ", ".join(f"{r['payload_bytes_per_device']:,} B "
                    f"{r['latency_us']:.2f} us" for r in sb["network"])
        + " (one card: no collective)")
    try:
        import sklearn  # noqa: F401
        why = "scikit-learn is installed here, but this script holds no run"
    except ImportError:
        why = "scikit-learn is not installed on this host"
    say(f"client (bf): the scikit-learn adapters (h2o3_tpu_torch.sklearn) "
        f"were not run on the card: {why}; tests/test_torch_sklearn.py "
        f"holds them against the JAX package's on the CPU")
    t_bf = time.perf_counter() - t_all
    say(f"client (bf): {t_bf:.1f} s")
    return t_bf


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# (bh): the cloud of two processes on the card
CLOUD_REQUESTS = 300      # (bh) scoring requests of the load around the kill
CLOUD_AFTER = 100         # ... and of the load after the replacement joined
CLOUD_THREADS = 16        # (bh) client threads
CLOUD_PROCS = []          # every process (bh) starts; all stopped at exit
BB = {}                   # (bb)'s REST GBM: trees, predictions, AUC, times
CLOUD_ENV = {}            # more environment for (bh)'s processes
ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rest_port():
    """A free port whose replay channel (the port + 2) is free too."""
    import socket
    while True:
        port = _free_port()
        s = socket.socket()
        try:
            s.bind(("0.0.0.0", port + 2))
            return port
        except OSError:
            continue
        finally:
            s.close()


def _stop_cloud():
    """Stops every process (bh) started (also at exit, after a failure)."""
    import signal
    for p in CLOUD_PROCS:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in CLOUD_PROCS:
        try:
            p.wait(20)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(10)


def _cloud_proc(cloud, pid, join=False):
    """One `python -m h2o3_tpu_torch` of the cloud on cuda:0, its output in
    the cloud's directory."""
    env = dict(cloud["env"], H2O3_PROCESS_ID=str(pid))
    if join:
        env["H2O3_JOIN_CLOUD"] = "1"
    tag = f"p{pid}{'-join' if join else ''}"
    log = open(os.path.join(cloud["tmp"], f"cloud-{tag}.log"), "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "h2o3_tpu_torch", "-port",
         str(cloud["rest"]), "-basic_auth", cloud["auth"]],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    CLOUD_PROCS.append(p)
    return p


def start_cloud():
    """(bh)'s two processes, a coordinator (rank 0, REST) and a worker
    (rank 1), started while the phase before runs: their interpreters,
    CUDA contexts and kernel loads are host-only time the card does not
    wait for. They form their world over gloo and wait for requests."""
    import atexit
    import secrets
    tmp = tempfile.mkdtemp(prefix="h2o3_cloud_")
    auth = os.path.join(tmp, "realm.properties")
    with open(auth, "w") as f:
        f.write("".join(f"{u}:{p}\n" for u, p in REST_USERS.items()))
    env = {k: v for k, v in os.environ.items() if not k.startswith("H2O3_")}
    env.update(H2O3_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
               H2O3_NUM_PROCESSES="2",
               H2O3_CLUSTER_SECRET=secrets.token_hex(16),
               H2O3_DIVERGENCE="1", H2O3_CLOUD_FORM_TIMEOUT_S="600",
               H2O3_REPLAY_ACK_TIMEOUT_S="120",
               H2O3_REPLAY_RECONNECT_S="600", **CLOUD_ENV)
    cloud = {"rest": _rest_port(), "env": env, "tmp": tmp, "auth": auth,
             "t0": time.perf_counter()}
    atexit.register(_stop_cloud)
    cloud["procs"] = [_cloud_proc(cloud, r) for r in (0, 1)]
    return cloud


def save_cloud_frames(torch, fr, valid, cloud):
    """(b)'s training and validation frames as .hex files in the cloud's
    directory, written on a thread while the phase runs on (the rows come
    off the card first)."""
    from h2o3_tpu_torch.io.persist import export_frame
    jobs = [(f, os.path.join(cloud["tmp"], name + ".h2o3frame"))
            for f, name in ((fr, "cloud_higgs"), (valid, "cloud_valid"))]
    out = {}

    def write():
        t0 = time.perf_counter()
        try:
            for f, path in jobs:
                # stored, not deflated: random floats do not compress, and
                # each rank reads the whole member
                export_frame(f, path, compress=False)
            out["s"] = time.perf_counter() - t0
        except Exception as e:      # noqa: BLE001 — joined and failed below
            out["err"] = repr(e)
    t = threading.Thread(target=write, daemon=True, name="cloud-save")
    t.start()
    cloud["save"] = (t, out)


def _cloud_scrape(port):
    """The cloud's per-host launch counts, all-reduce and row-gather totals
    from /metrics?scope=cluster: {host: {"launches": {kernel: n}, "bytes",
    "seconds", "calls", "gather_bytes", "gather_seconds", "gather_calls",
    "checks", "mismatches"}}."""
    st, _, text = _http(port, "GET", "/metrics?scope=cluster", user="gold")
    check(st == 200, f"(bh) /metrics?scope=cluster {st}")
    text = text.decode() if isinstance(text, bytes) else str(text)
    out = {}
    pat = re.compile(r'^(h2o3_[a-z_]+)\{([^}]*)\} (\S+)$')
    for line in text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        name, labels, val = m.group(1), dict(
            kv.split("=", 1) for kv in m.group(2).split(",")), \
            float(m.group(3))
        labels = {k: v.strip('"') for k, v in labels.items()}
        h = out.setdefault(labels.get("host"), {"launches": {}})
        if name == "h2o3_hist_kernel_launches":
            h["launches"][labels["kernel"]] = val
        elif name.startswith("h2o3_allreduce_"):
            h[name[len("h2o3_allreduce_"):]] = val
        elif name.startswith("h2o3_gather_"):
            h["gather_" + name[len("h2o3_gather_"):]] = val
        elif name == "h2o3_divergence_checks_total":
            h["checks"] = val
        elif name == "h2o3_divergence_mismatches_total":
            h["mismatches"] = val
    return out


def _cloud_build_split(port, trace):
    """Each host's seconds of the traced build from GET /3/Trace: its
    job.run, the set-up before the first gbm.chunk, the chunks (with the
    level all-reduces' dispatches inside them), the scoring events
    between the chunks, and what follows the last chunk (the final
    metrics)."""
    st, _, js = _http(port, "GET", f"/3/Trace/{trace}", user="gold")
    check(st == 200 and isinstance(js, dict), f"(bh) /3/Trace {st}")
    out = {}
    for host in {str(sp.get("host")) for sp in js.get("spans", [])}:
        sps = [sp for sp in js["spans"] if str(sp.get("host")) == host
               and sp.get("end") is not None]
        job = [sp for sp in sps if sp["name"] == "job.run"]
        ch = sorted((sp for sp in sps if sp["name"] == "gbm.chunk"),
                    key=lambda sp: sp["start"])
        if not job or not ch:
            continue
        red = [sp for sp in sps if sp["name"] == "mrtask.map_reduce"]
        j = job[0]
        whole = j["end"] - j["start"]
        setup = ch[0]["start"] - j["start"]
        chunks = sum(sp["end"] - sp["start"] for sp in ch)
        after = j["end"] - ch[-1]["end"]
        out[host] = {
            "job": round(whole, 3), "setup": round(setup, 3),
            "chunks": round(chunks, 3),
            "level_all_reduces": round(sum(sp["end"] - sp["start"]
                                           for sp in red), 3),
            "n_level_all_reduces": len(red),
            "between": round(whole - setup - chunks - after, 3),
            "after": round(after, 3)}
    check(set(out) >= {"0", "1"}, f"(bh) the build's spans {out}")
    return out


def _cloud_state(port):
    st, _, js = _http(port, "GET", "/3/Cloud", user="gold")
    check(st == 200, f"(bh) /3/Cloud {st} {str(js)[:300]}")
    return js


def _cloud_load(port, mid, bodies, threads, on_answer=None):
    """POST /3/Predictions/models/{mid} of each body from `threads`
    closed-loop threads: the answers in order, and the failures."""
    out, fails, nxt, lock = [None] * len(bodies), [], [0], threading.Lock()

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(bodies):
                return
            st, _, js = _http(port, "POST", f"/3/Predictions/models/{mid}",
                              body={"rows": bodies[i]}, user="gold")
            if st == 200 and isinstance(js, dict) \
                    and len(js.get("predictions", ())) == len(bodies[i]):
                out[i] = js["predictions"]
                if on_answer is not None:
                    on_answer(i)
            else:
                with lock:
                    fails.append((i, st, str(js)[:200]))
    ts = [threading.Thread(target=client) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out, fails, time.perf_counter() - t0


def phase_cloud(torch, h2o, HC, cloud, higgs_csv, card):
    """(bh): the cloud of two processes on cuda:0 (deploy/multihost), over
    REST from this script: /3/Cloud; /3/ParseDistributed of (ap)'s CSV (=
    import_file's frame bit for bit); (b)'s frames through /3/Frames/load,
    each rank keeping its own rows; (bb)'s GBM over REST (= (bb)'s trees
    bit for bit; launches a tree in each process; the all-reduce seconds
    and bytes a tree); /3/Predictions on the validation rows (= (bb)'s bit
    for bit, the same AUC); the collect fan-outs with both processes'
    entries; the divergence sanitizer raising and counting no mismatch;
    the worker killed under a scoring load (excised, the epoch up, no
    request failed), a replacement that joins, syncs and answers as
    before, and /3/Cloud/drain."""
    from h2o3_tpu_torch.core.kvstore import DKV
    from h2o3_tpu_torch.io.persist import import_frame
    port, tmp = cloud["rest"], cloud["tmp"]
    torch.cuda.empty_cache()        # the cloud's processes load next
    t_phase = time.perf_counter()
    deadline = time.monotonic() + 300
    while True:
        try:
            st, _, js = _http(port, "GET", "/3/Cloud", user="gold")
            if st == 200:
                break
        except OSError:
            pass
        for p in cloud["procs"]:
            check(p.poll() is None, f"(bh) a cloud process exited "
                  f"({p.returncode}); see {tmp}")
        check(time.monotonic() < deadline, "(bh) the cloud did not form")
        time.sleep(0.05)
    t_up = time.perf_counter() - cloud["t0"]
    t_wait = time.perf_counter() - t_phase
    check(js["cloud_size"] == 2 and js["epoch"] == 1
          and [(w["pid"], w["state"]) for w in js["workers"]]
          == [(1, "active")] and js["locked"] is False,
          f"(bh) /3/Cloud {js}")
    # /3/ParseDistributed of (ap)'s CSV: the coordinator plans the byte
    # ranges, the worker tokenizes its share
    size = os.path.getsize(higgs_csv)
    t0 = time.perf_counter()
    _, p = _rest_ok(port, "POST", "/3/ParseDistributed", "ParseV3",
                    user="gold", data={"source_frames": [higgs_csv],
                                       "destination_frame": "cloud_csv"})
    _rest_job(port, p["job"]["key"])
    t_pd = time.perf_counter() - t0
    _rest_ok(port, "POST", "/3/Frames/cloud_csv/save", "FramesV3",
             user="gold", data={"dir": tmp})
    got = import_frame(os.path.join(tmp, "cloud_csv.h2o3frame"),
                       key="cloud_csv_back")
    t0 = time.perf_counter()
    pf = h2o.import_file(higgs_csv)
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t0
    check(_frames_bits_equal(torch, got, pf),
          "(bh) /3/ParseDistributed's frame differs from import_file's")
    DKV.remove(got.key)
    DKV.remove(pf.key)
    # the replacement of the worker killed below starts now: its
    # interpreter and CUDA context come up while the phase runs on, and
    # the coordinator refuses its handshakes until the worker is cut out
    replacement = _cloud_proc(cloud, 1, join=True)
    # (b)'s frames through /3/Frames/load: each rank keeps its own rows
    t_save, out = cloud["save"][0], cloud["save"][1]
    with host_only():
        t_save.join()
    check("err" not in out, f"(bh) saving (b)'s frames: {out.get('err')}")
    t0 = time.perf_counter()
    for name in ("cloud_higgs", "cloud_valid"):
        _rest_ok(port, "POST", "/3/Frames/load", "FramesV3", user="gold",
                 data={"dir": tmp, "frame_id": name})
    t_load = time.perf_counter() - t0
    # (bb)'s GBM over REST, traced: each rank's job and its spans
    before = _cloud_scrape(port)
    t0 = time.perf_counter()
    _, b = _rest_ok(port, "POST", "/3/ModelBuilders/gbm",
                    "ModelBuilderJobV3", user="gold",
                    data=dict(REST_GBM, training_frame="cloud_higgs",
                              response_column="y", model_id="cloud_gbm"),
                    headers={"X-H2O3-Trace-Id": "cloud-bh-gbm"})
    _rest_job(port, b["job"]["key"])
    t_gbm = time.perf_counter() - t0
    after = _cloud_scrape(port)
    split = _cloud_build_split(port, "cloud-bh-gbm")
    nt = REST_GBM["ntrees"]
    per = {}
    for host in ("0", "1"):
        a, z = after.get(host, {}), before.get(host, {})
        per[host] = {
            "launches": {k: (v - z["launches"].get(k, 0.0)) / nt
                         for k, v in a.get("launches", {}).items()
                         if v - z["launches"].get(k, 0.0)},
            "seconds": (a.get("seconds", 0) - z.get("seconds", 0)) / nt,
            "mb": (a.get("bytes", 0) - z.get("bytes", 0)) / nt / 1e6,
            "calls": (a.get("calls", 0) - z.get("calls", 0)) / nt,
            # the row gathers of the whole build (f0's response and
            # weights, the bin edges' sample), not a tree's
            "g_calls": a.get("gather_calls", 0) - z.get("gather_calls", 0),
            "g_mb": (a.get("gather_bytes", 0)
                     - z.get("gather_bytes", 0)) / 1e6,
            "g_s": a.get("gather_seconds", 0) - z.get("gather_seconds", 0)}
        check(per[host]["launches"] == PER_TREE["default"],
              f"(bh) host {host}'s launches a tree {per[host]['launches']}")
    st, _, raw = _http(port, "GET", "/3/Models.fetch.bin/cloud_gbm",
                       user="gold")
    check(st == 200 and isinstance(raw, bytes), f"(bh) fetch.bin {st}")
    mpath = os.path.join(tmp, "cloud_gbm.bin")
    with open(mpath, "wb") as f:
        f.write(raw)
    cm = h2o.load_model(mpath)
    check(_trees_equal(torch, cm._trees.to("cpu"), BB["trees"]),
          "(bh) the cloud's trees differ from (bb)'s")
    # predictions on the validation rows
    _, pr = _rest_ok(port, "POST",
                     "/3/Predictions/models/cloud_gbm/frames/cloud_valid",
                     "ModelMetricsListSchemaV3", user="gold",
                     data={"predictions_frame": "cloud_pred"})
    auc = pr["model_metrics"][0]["auc"]
    check(auc == BB["auc"], f"(bh) AUC {auc} against (bb)'s {BB['auc']}")
    _rest_ok(port, "POST", "/3/Frames/cloud_pred/save", "FramesV3",
             user="gold", data={"dir": tmp})
    pred = import_frame(os.path.join(tmp, "cloud_pred.h2o3frame"),
                        key="cloud_pred_back")
    names, cols = BB["pred"]
    check(pred.names == names and all(
        torch.equal(v.as_f32().cpu().view(torch.int32), c.view(torch.int32))
        for v, c in zip(pred.vecs, cols)),
        "(bh) the cloud's predictions differ from (bb)'s")
    DKV.remove(pred.key)
    # the collect fan-outs answer with both processes' entries
    trace = "cloud-bh-trace"
    _http(port, "GET", "/3/Jobs", user="gold",
          headers={"X-H2O3-Trace-Id": trace})
    fan = {}
    for path, key in (("/3/JStack", "traces"), ("/3/Timeline", "hosts"),
                      ("/3/Usage", "hosts"), ("/3/CloudHealth", "hosts"),
                      ("/3/ModelMonitor/cloud_gbm", "hosts"),
                      ("/3/Logs", "hosts"), (f"/3/Trace/{trace}", "hosts"),
                      ("/3/WaterMeter?cluster=1", "hosts")):
        st, _, js = _http(port, "GET", path, user="gold")
        check(st == 200 and isinstance(js, dict),
              f"(bh) {path}: {st} {str(js)[:200]}")
        entries = js.get(key) or []
        hosts = {str(e.get("host", e)) if isinstance(e, dict) else str(e)
                 for e in entries}
        fan[path.split("?")[0]] = len(entries)
        check(not js.get("lagging_hosts") and len(entries) >= 2
              and {"0", "1"} <= hosts | {"0"},
              f"(bh) {path} hosts {hosts} lagging "
              f"{js.get('lagging_hosts')}")
    for action in ("start", "stop"):
        _, js = _rest_ok(port, "POST", "/3/Profiler", "ProfilerV3",
                         user="gold", data={"action": action,
                                            "kind": "sampling",
                                            "cluster": 1})
        check(len(js.get("hosts", [])) == 2 and not js["lagging_hosts"],
              f"(bh) /3/Profiler cluster {action}: {str(js)[:300]}")
    scrape = _cloud_scrape(port)
    check(set(scrape) >= {"0", "1"}, f"(bh) cluster scrape {set(scrape)}")
    checks0 = scrape["0"].get("checks", 0.0)
    check(checks0 > 0 and scrape["0"].get("mismatches", 0.0) == 0,
          f"(bh) divergence {scrape['0']}")
    # a scoring load of (ay)'s sizes on the validation rows; the worker
    # is killed when a third of it is answered; a replacement starts then
    vrows = np.stack([v.to_numpy() for v in import_frame(
        os.path.join(tmp, "cloud_valid.h2o3frame"),
        key="cloud_pool").vecs[:HIGGS_C]], 1)[:QOS_POOL]
    DKV.remove("cloud_pool")
    names_x = [f"x{j}" for j in range(HIGGS_C)]
    rng = np.random.default_rng(41)
    sizes = rng.choice(QOS_SIZES, CLOUD_REQUESTS, p=QOS_SIZE_P)
    offs = rng.integers(0, QOS_POOL - 64, CLOUD_REQUESTS)
    bodies = [_payload(vrows[o:o + k], names_x) for o, k in zip(offs, sizes)]
    killed = {}
    lock = threading.Lock()

    def kill_at_third(_i):
        with lock:
            killed["n"] = killed.get("n", 0) + 1
            if killed["n"] == CLOUD_REQUESTS // 3 and "t" not in killed:
                cloud["procs"][1].kill()
                killed["t"] = time.perf_counter()
    killed["join"] = replacement
    ans, fails, t_load1 = _cloud_load(port, "cloud_gbm", bodies,
                                      CLOUD_THREADS, kill_at_third)
    check("t" in killed, "(bh) the worker was not killed")
    check(not fails, f"(bh) {len(fails)} requests failed around the "
          f"kill: {fails[:3]}")
    # the excision (the replacement may have joined already: it knocks
    # until the worker is cut out)
    st1 = _cloud_state(port)
    st, _, text = _http(port, "GET", "/metrics", user="gold")
    text = text.decode() if isinstance(text, bytes) else str(text)
    cut = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^h2o3_cloud_excisions_total\{reason="([a-z_]+)"\} (\S+)$', text,
        re.M)}
    check(st1["epoch"] >= 2 and sum(cut.values()) == 1
          and set(cut) <= {"recv_error", "bad_ack", "send_error", "eof",
                           "ack_timeout"},
          f"(bh) after the kill: {st1} excisions {cut}")
    dead = [{"reason": next(iter(cut))}]
    # the replacement joins: GET /3/Cloud answers once its sync is done
    t0 = time.perf_counter()
    while True:
        st2 = _cloud_state(port)
        if st2["epoch"] >= 3:
            break
        check(killed["join"].poll() is None,
              f"(bh) the replacement exited; see {tmp}")
        check(time.perf_counter() - t0 < 240, "(bh) no replacement joined")
        time.sleep(0.1)
    t_join = time.perf_counter() - killed["t"]
    check([(w["pid"], w["state"]) for w in st2["workers"]] == [(1, "active")]
          and st2["cloud_healthy"], f"(bh) after the join: {st2}")
    # the same requests again: the coordinator answers as before and the
    # replacement's answers equal its (the sanitizer's answer digests)
    checks1 = _cloud_scrape(port)["0"].get("checks", 0.0)
    again, fails2, t_load2 = _cloud_load(port, "cloud_gbm",
                                         bodies[:CLOUD_AFTER], CLOUD_THREADS)
    check(not fails2, f"(bh) {len(fails2)} requests failed after the join")
    check(again == ans[:CLOUD_AFTER],
          "(bh) the answers after the join differ from before")
    from h2o3_tpu_torch import serving
    want = [serving.score_payload(cm, b) for b in bodies[:CLOUD_AFTER]]
    check(all([d["p1"] for d in a] == [d["p1"] for d in w]
              for a, w in zip(again, want)),
          "(bh) the cloud's answers differ from score_payload's")
    deadline = time.monotonic() + 30
    while True:
        sc = _cloud_scrape(port)["0"]
        if sc.get("checks", 0) >= checks1 + CLOUD_AFTER:
            break
        check(time.monotonic() < deadline, f"(bh) divergence checks {sc}")
        _cloud_state(port)          # a frame home for the last riders
    check(sc.get("mismatches", 0.0) == 0, f"(bh) divergence {sc}")
    st, _, dr = _http(port, "POST", "/3/Cloud/drain", data={"node": 1},
                      user="gold")
    check(st == 200 and dr["left_cleanly"] and dr["epoch"] >= 4,
          f"(bh) drain {st} {dr}")
    check(killed["join"].wait(60) == 0, "(bh) the drained worker's exit")
    st3 = _cloud_state(port)
    _stop_cloud()
    t_ph = time.perf_counter() - t_phase
    shutil.rmtree(tmp, ignore_errors=True)
    t_gr, _, _ = BB["gbm"]
    bsize, bt_rest, bt_in, _ = BB["parse"]
    say(f"cloud (bh) two processes of python -m h2o3_tpu_torch on cuda:0 "
        f"over gloo, card {card}: up {t_up:.1f} s after their start (the "
        f"phase waited {t_wait:.2f} s for it); /3/Cloud 2 nodes, epoch 1; "
        f"/3/ParseDistributed of (ap)'s {HIGGS_CSV_N:,}-row CSV "
        f"({size / 1e6:.1f} MB) {t_pd:.2f} s ({size / t_pd / 1e6:.1f} MB/s) "
        f"= import_file's frame bit for bit (in this process "
        f"{size / t_in / 1e6:.1f} MB/s; (bb)'s /3/Parse "
        f"{bsize / bt_rest / 1e6:.1f} MB/s); (b)'s {HIGGS_N:,} x {HIGGS_C} "
        f"and {HIGGS_VALID_N:,}-row frames through /3/Frames/load "
        f"{t_load:.2f} s (written beside the phase before in "
        f"{out['s']:.1f} s), each rank holding its rows")
    say(f"cloud (bh) POST /3/ModelBuilders/gbm at (bb)'s configuration "
        f"({nt} trees): {t_gbm:.2f} s to DONE against (bb)'s {t_gr:.2f} s "
        f"in one process; the trees = (bb)'s bit for bit; hist.cu launches "
        f"a tree on rank 0 {per['0']['launches']}, on rank 1 "
        f"{per['1']['launches']}; all-reduces a tree: rank 0 "
        f"{per['0']['calls']:.0f} of {per['0']['mb']:.2f} MB in "
        f"{per['0']['seconds']:.3f} s, rank 1 {per['1']['calls']:.0f} of "
        f"{per['1']['mb']:.2f} MB in {per['1']['seconds']:.3f} s; row "
        f"gathers of the whole build: rank 0 {per['0']['g_calls']:.0f} of "
        f"{per['0']['g_mb']:.2f} MB in {per['0']['g_s']:.3f} s, rank 1 "
        f"{per['1']['g_calls']:.0f} of {per['1']['g_mb']:.2f} MB in "
        f"{per['1']['g_s']:.3f} s; the build's spans (s): "
        + "; ".join(f"rank {h} {v}" for h, v in sorted(split.items())))
    say(f"cloud (bh) /3/Predictions on the {HIGGS_VALID_N:,} validation "
        f"rows = (bb)'s bit for bit, AUC {auc:.6f} = (bb)'s; collect "
        f"fan-outs with both hosts {fan}, /3/Profiler cluster=1 2 hosts; "
        f"divergence (raise mode) {sc.get('checks', 0):.0f} checks, "
        f"{sc.get('mismatches', 0):.0f} mismatches")
    say(f"cloud (bh) the worker killed after {CLOUD_REQUESTS // 3} of "
        f"{CLOUD_REQUESTS} (ay)-size requests from {CLOUD_THREADS} threads "
        f"({t_load1:.2f} s): excised ({dead[0]['reason']}), epoch "
        f"{st1['epoch']}, 0 requests failed; the replacement (started after "
        f"the parse, refused while the worker lived) joined, synced the "
        f"snapshot and served {t_join:.1f} s after the kill, epoch "
        f"{st2['epoch']}; {CLOUD_AFTER} requests "
        f"again ({t_load2:.2f} s, {CLOUD_AFTER / t_load2:,.0f} requests/s "
        f"against {CLOUD_REQUESTS / t_load1:,.0f} around the kill"
        + (f"; one process: (bc) over HTTP, {REST_PROCS} x {REST_THREADS} "
           f"threads on 4 models, {BB['rps'][0]:,.0f} requests/s, (ay) in "
           f"process {BB['rps'][1]:,.0f}" if "rps" in BB
           else "; (bc) not run in this call") +
        f"): the answers of before bit for bit, = "
        f"score_payload's, the replacement's equal (0 mismatches); "
        f"/3/Cloud/drain left cleanly, epoch {st3['epoch']}; the phase "
        f"{t_ph:.1f} s")
    return t_ph


def cloud_only(torch, h2o, HC, _build):
    """`python3 chip_smoke.py --cloud-only`: (bh) alone after the build,
    against (bb)'s GBM trained by train() in this process (the same trees
    (bb) holds its REST GBM to), with (ap)'s CSV written first."""
    from h2o3_tpu_torch.core.kvstore import DKV
    t_all = time.perf_counter()
    card = run_phase("card", phase_card, torch, _build)
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    keep = tempfile.mkdtemp(prefix="h2o3_smoke_")
    try:
        csv = os.path.join(keep, "higgs-1m.csv")
        cloud = start_cloud()
        _write_higgs_csv(torch, fr, csv)
        save_cloud_frames(torch, fr, valid, cloud)
        t0 = time.perf_counter()
        DKV.remove(h2o.import_file(csv).key)
        torch.cuda.synchronize()
        t_in = time.perf_counter() - t0
        HC.reset_launches()
        t0 = time.perf_counter()
        m = h2o.H2OGradientBoostingEstimator(**REST_GBM)
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        t_gbm = time.perf_counter() - t0
        per = {k: v / REST_GBM["ntrees"] for k, v in HC.LAUNCHES.items()
               if v}
        p = m.predict(valid)
        BB.update(trees=m._trees.to("cpu"),
                  pred=(p.names, [v.as_f32().cpu() for v in p.vecs]),
                  auc=m.model_performance(valid).auc,
                  gbm=(t_gbm, t_gbm, per),
                  parse=(os.path.getsize(csv), t_in, t_in, None))
        say(f"cloud (bh) reference: train() {t_gbm:.2f} s, launches a tree "
            f"{per}; import_file of (ap)'s CSV {t_in:.2f} s")
        DKV.clear()
        del p
        try:
            run_phase("cloud", phase_cloud, torch, h2o, HC, cloud, csv, card)
        finally:
            _stop_cloud()
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    say(f"cloud only: total {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def time_ms(torch, fn, reps):
    fn()                                  # warm up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _bound_ms(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def _hist_index_add(torch, HC, codes, heap, stats, base, L, n_bins, half):
    """One library call computing the same histogram: index_add_ over the
    flattened (slot, column, bin) index of every (row, column), in the
    stats' dtype. Returns the call; building its index is set-up, not
    timed."""
    _, _, _, L_pad = HC.hist_layout(L, half)
    c_pad, n = codes.shape
    leaf = heap.long() - base
    ok = (leaf >= 0) & (leaf < L)
    if half:
        ok &= (leaf & 1) == 0
        leaf = leaf >> 1
    slot = torch.where(ok, leaf, L_pad)
    cols = torch.arange(c_pad, device=codes.device)[:, None]
    idx = ((slot[None, :] * c_pad + cols) * n_bins + codes.long()).reshape(-1)
    src = stats[:3].t().repeat(c_pad, 1)
    out = torch.zeros(((L_pad + 1) * c_pad * n_bins, 3), dtype=stats.dtype,
                      device=codes.device)
    return lambda: out.index_add_(0, idx, src)


def _rows_in(heap, base, L, half):
    """Rows a histogram of leaves [base, base+L) sums (even leaves only
    with half)."""
    leaf = heap.long() - base
    inw = (leaf >= 0) & (leaf < L)
    if half:
        inw &= (leaf & 1) == 0
    return int(inw.sum().item())


def _rows_routed(heap, tbl, base, L):
    """Rows of leaves [base, base+L) that split: each reads one code byte
    of its split column."""
    leaf = heap.long() - base
    active = (leaf >= 0) & (leaf < L)
    did = tbl[1, leaf.clamp(0, L - 1)] > 0.5
    return int((active & did).sum().item())


def time_hist(torch, HC, name, args, kw):
    """Time one recorded histogram launch (dense or shallow-window) beside
    its plain version, index_add_ and its bound; hold it to the plain
    version first."""
    codes, heap, stats = args
    fn = getattr(HC, name)
    int8 = bool(kw.get("int8", False))
    pkw = {k: v for k, v in kw.items() if k not in ("int8", "scale")}
    c_pad, n = codes.shape
    half = pkw.get("half", False)
    l_eff, _, _, L_pad = HC.hist_layout(pkw["L"], half)
    what = f"{name} int8={int8} L={pkw['L']} half={half} n={n} C={c_pad}"
    abs_err = check_hist(torch, HC, what, fn(*args, **kw), codes, heap,
                         stats, pkw, int8)
    k_ms = time_ms(torch, lambda: fn(*args, **kw), 10)
    p_ms = time_ms(torch, lambda: HC.sbh_hist_plain(*args, **pkw), 2)
    lib = _hist_index_add(torch, HC, codes, heap, stats, pkw["base"],
                          pkw["L"], pkw["n_bins"], half)
    l_ms = time_ms(torch, lib, 2)
    del lib
    torch.cuda.empty_cache()
    # bytes this data needs: every heap id, then the codes and the three
    # used stats of the rows the level sums (left children with half), and
    # the output once
    rows_in = _rows_in(heap, pkw["base"], pkw["L"], half)
    nbytes = 4 * n + rows_in * (c_pad + 12) + L_pad * c_pad * 4 * \
        pkw["n_bins"] * 4
    b_ms, by = _bound_ms(nbytes, 3 * c_pad * rows_in)
    groups = ""
    if name == "sbh_hist_dense" and not int8:
        groups = "; " + time_groups(
            torch, HC, lambda g: fn(*args, **kw, group=g), l_eff, c_pad,
            pkw["n_bins"])
    elif name == "sbh_hist_dense":
        groups = "; layouts " + time_layouts(
            torch, lambda **v: fn(*args, **kw, **v),
            i8_dense_layouts(HC, l_eff, pkw["n_bins"], c_pad, n))
    elif name == "sbh_hist_radix":
        slot = l_eff * 3 * (4 if int8 else 8) * pkw["n_bins"]
        groups = "; layouts " + time_layouts(torch, lambda **v: fn(
            *args, **kw, **v), [
            (f"G={g} T={t} agg={int(a)} copies="
             f"{HC.radix_grid(l_eff, pkw['n_bins'], c_pad, int8, g, t)[2]}",
             dict(group=g, threads=t, agg=a))
            for g in HC.RADIX_GROUPS[int8] if g <= c_pad and g * slot <= HC.SMEM_MAX
            for t in (512, 1024) for a in (True, False)])
    level = (pkw["L"] - 1).bit_length()
    say(f"timing {what} (level {level}): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({by}, {rows_in} rows summed of {l_eff} slots){groups}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=abs_err)


def i8_dense_layouts(HC, l_eff, n_bins, c_pad, n):
    """(label, layout) of the int8 dense launch at a level of l_eff slots,
    the default first: each window width (the level in one pass, two or
    four) with the widest column group it leaves room for, at 512 and
    1024 threads; the default without the bank padding; and 2 and 4 waves
    of blocks."""
    def label(v):
        win, n_win, g, nt, spad, rows = HC.dense_i8_grid(
            min(l_eff, HC.I8_BAND), n_bins, c_pad, n_pad=n, **v)
        return (f"win={win}x{n_win} G={g} T={nt} spad={spad} "
                f"rows/block={rows}")
    out = [{}]
    for win in sorted({l_eff, max(1, l_eff // 2), max(1, l_eff // 4)},
                      reverse=True):
        out += [dict(win=win, threads=t) for t in (512, 1024)]
    out += [dict(spad=0), dict(waves=2), dict(waves=4)]
    return [(label(v), v) for v in out]


def time_groups(torch, HC, run, l_eff, c_pad, n_bins):
    """Time an f32 dense or fused launch, run(group), at one column per
    block (the widest window), two, and the column groups that a 96 KB and
    the largest shared-memory budget give at the default window; every
    grouping's histogram must equal the first's bit for bit (fixed-point
    sums are exact). Returns the times as text."""
    win = HC.level_grid(l_eff, n_bins, c_pad, False)[0]
    gs = sorted({1, min(2, c_pad),
                 HC.column_group(win, n_bins, c_pad, 96 * 1024),
                 HC.column_group(win, n_bins, c_pad, HC.SMEM_MAX)})
    return "columns per block " + time_layouts(
        torch, lambda group: run(group),
        [(f"G={g}", dict(group=g)) for g in gs])


def time_layouts(torch, run, layouts, reps=10, ref=None):
    """Time run(**kw) for each (label, kw) of `layouts`, each result held
    equal bit for bit to `ref`, or to the first layout's (exact sums do not
    depend on the layout). Returns the times as text."""
    parts, against = [], "the reference" if ref is not None else \
        layouts[0][0]
    for label, kw in layouts:
        out = run(**kw)
        if ref is None:
            ref = out
        check(bit_equal(torch, out, ref), f"layout {label}: result "
              f"differs from {against}")
        parts.append(f"{label} {time_ms(torch, lambda: run(**kw), reps):.4f}"
                     " ms")
    return ", ".join(parts) + " (bit-identical)"


def time_route(torch, HC, args, kw):
    emit_f = kw.get("emit_f", False)
    codes, heap, tbl, route_f = args[:4]
    n = heap.numel()
    h_k, f_k = HC.sbh_route(*args, **kw)
    h_p, f_p = HC.sbh_route_plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"route L={kw['L']}: heap differs")
    ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
    check(ferr < F_ATOL, f"route L={kw['L']}: F err {ferr}")
    k_ms = time_ms(torch, lambda: HC.sbh_route(*args, **kw), 20)
    p_ms = time_ms(torch, lambda: HC.sbh_route_plain(*args, **kw), 3)
    # bytes this data needs: heap in and out, one code byte for each row
    # of a leaf that split, the tables, and F in and out with emit_f
    moved = _rows_routed(heap, tbl, kw["base"], kw["L"])
    nbytes = 8 * n + moved + tbl.numel() * 4 + route_f.numel() * 4
    if emit_f:
        nbytes += 8 * n + args[4].numel() * 4
    b_ms, by = _bound_ms(nbytes, (2 if emit_f else 0) * n)
    sectors = _sectors_touched(torch, codes, heap, tbl, kw["base"], kw["L"])
    layouts = ""
    if not emit_f:
        layouts = "; layouts " + time_layouts(
            torch, lambda **v: HC.sbh_route(*args, **kw, **v)[0],
            [(f"rows={r} T={t}", dict(rows=r, threads=t))
             for r in (4, 8) for t in (256, 512, 1024)], reps=20,
            ref=h_p)
    say(f"timing route L={kw['L']} emit_f={emit_f} n={n}: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
        f"rows routed {moved}, code sectors touched {sectors} ({sectors * 32} "
        f"B; with the heap {(8 * n + sectors * 32) / HBM_BYTES_S * 1e3:.4f} "
        f"ms at {HBM_BYTES_S / 1e12:.2f} TB/s); heap identical, F err "
        f"{ferr:.3g}{layouts}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=ferr)


def _sectors_touched(torch, codes, heap, tbl, base, L):
    """32-byte sectors of the code planes that a route's gathers touch:
    distinct (split column, row // 32) over the rows of leaves that
    split."""
    n = heap.numel()
    leaf = heap.long() - base
    active = (leaf >= 0) & (leaf < L)
    lc = leaf.clamp(0, L - 1)
    did = active & (tbl[1, lc] > 0.5)
    col = tbl[0, lc].long().clamp(0, codes.shape[0] - 1)
    rows = torch.arange(n, device=heap.device)
    return int(torch.unique(((col * n + rows) // 32)[did]).numel())


def time_fused(torch, HC, args, kw):
    codes, heap, tbl, route_f, stats = args
    int8 = bool(kw.get("int8", False))
    pkw = {k: v for k, v in kw.items() if k not in ("int8", "scale")}
    c_pad, n = codes.shape
    l_eff = (pkw["L_h"] + 1) // 2
    what = f"fused int8={int8} L_h={pkw['L_h']} n={n} C={c_pad}"
    h_k, got = HC.sbh_route_hist_fused(*args, **kw)
    abs_err = check_fused(torch, HC, what, h_k, got, args, pkw, int8)
    del got
    k_ms = time_ms(torch, lambda: HC.sbh_route_hist_fused(*args, **kw), 10)
    p_ms = time_ms(torch, lambda: HC.sbh_route_hist_plain(*args, **pkw), 2)
    # bytes this data needs: the heap read and written, the split column's
    # byte of each row of a split leaf, the tables, the codes and three
    # stats of the rows summed (over the new heap), and the output once
    moved = _rows_routed(heap, tbl, pkw["base_r"], pkw["L_r"])
    rows_in = _rows_in(h_k, pkw["base_h"], pkw["L_h"], True)
    nbytes = (8 * n + moved + tbl.numel() * 4 + route_f.numel() * 4
              + rows_in * (c_pad + 12)
              + l_eff * c_pad * 4 * pkw["n_bins"] * 4)
    b_ms, by = _bound_ms(nbytes, 3 * c_pad * rows_in)
    groups = ""
    if not int8:
        groups = "; " + time_groups(
            torch, HC,
            lambda g: HC.sbh_route_hist_fused(*args, **kw, group=g)[1],
            l_eff, c_pad, pkw["n_bins"])
    else:
        # the int8 form's compile-time groups: one column, and the groups
        # of a 96 KB and the largest budget, at 512 and 1024 threads
        win = HC.level_grid(l_eff, pkw["n_bins"], c_pad, True)[0]
        gs = sorted({1} | {min(32, HC._pow2_floor(HC.column_group(
            win, pkw["n_bins"], c_pad, b, 4))) for b in (96 * 1024,
                                                        HC.SMEM_MAX)})
        groups = "; layouts " + time_layouts(
            torch, lambda **v: HC.sbh_route_hist_fused(*args, **kw, **v)[1],
            [(f"G={g} T={t}", dict(group=g, threads=t))
             for g in gs for t in (512, 1024)])
    say(f"timing {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by}, {moved} rows routed, {rows_in} rows summed "
        f"of {l_eff} slots){groups}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=abs_err)


def _summary(rs):
    """One kernels-JSON entry's numbers from one tree's launches: means,
    the largest error, what bounds most of them."""
    mean = lambda k: float(np.mean([r[k] for r in rs]))  # noqa: E731
    lib = [r["library_ms"] for r in rs]
    return {"max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(("bytes", "operations"),
                            key=[r["bound_by"] for r in rs].count),
            "library_ms": None if lib[0] is None else float(np.mean(lib))}


def phase_timing(torch, HC, runs):
    """Every kernel at the shapes of one tree of the HIGGS runs and of run
    (d) (Covertype width, C_pad 56), and the dense histogram and route
    launches of levels 8 and 9 of a run (f) tree with its terminal route.
    The kernels-JSON entries come from run (b), the default configuration,
    and for sbh_hist_i8 from run (c); the other runs' launches are printed
    beside them."""
    rows = {}
    for run in ("a", "b", "c", "d"):
        launches, calls = runs[run]
        rs = {}
        rs["sbh_hist"] = [time_hist(torch, HC, "sbh_hist_dense", a, k)
                          for a, k in calls["sbh_hist_dense"]]
        rs["sbh_hist_radix"] = [time_hist(torch, HC, "sbh_hist_radix", a, k)
                                for a, k in calls["sbh_hist_radix"]]
        rs["sbh_route_hist_fused"] = [
            time_fused(torch, HC, a, k)
            for a, k in calls["sbh_route_hist_fused"]]
        route = [time_route(torch, HC, a, k) for a, k in calls["sbh_route"]]
        rs["sbh_route"] = route[:-1]
        rs["sbh_route_emit_f"] = route[-1:]
        if run == "c":
            rs["sbh_hist_i8"] = rs.pop("sbh_hist")
        rs = {k: v for k, v in rs.items() if v}
        per_tree = sum(r["ms"] for v in rs.values() for r in v)
        parts = ", ".join(f"{k} {sum(r['ms'] for r in v):.4f} ms/{len(v)}"
                          for k, v in rs.items())
        say(f"kernel time of one tree, run ({run}): {per_tree:.4f} ms "
            f"({parts})")
        rows[run] = (launches, rs)
    # run (f): the dense histogram of levels 8 and 9 (256 and 512 leaves,
    # left children summed), their routes and the terminal route (L 512)
    _, calls = runs["f"]
    deep = [time_hist(torch, HC, "sbh_hist_dense", a, k)
            for a, k in calls["sbh_hist_dense"][2:]]
    route = [time_route(torch, HC, a, k) for a, k in calls["sbh_route"][2:]]
    say(f"kernel time of levels 8-9 of one tree, run (f): sbh_hist "
        f"{sum(r['ms'] for r in deep):.4f} ms/{len(deep)} (bound "
        f"{sum(r['bound_ms'] for r in deep):.4f}), sbh_route "
        f"{sum(r['ms'] for r in route[:-1]):.4f} ms/{len(route) - 1} (bound "
        f"{sum(r['bound_ms'] for r in route[:-1]):.4f}); the terminal route "
        f"{route[-1]['ms']:.4f} ms (bound {route[-1]['bound_ms']:.4f})")
    counts = {"sbh_route": "route", "sbh_route_emit_f": "route_f",
              "sbh_hist": "hist", "sbh_hist_i8": "hist_i8",
              "sbh_hist_radix": "radix", "sbh_route_hist_fused": "fused"}
    out = []
    for name, key in counts.items():
        launches, rs = rows["c" if name == "sbh_hist_i8" else "b"]
        check(launches[key] > 0, f"{name} never launched on its path")
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": TPU_KERNELS[name], "launches": launches[key],
                    **_summary(rs[name])})
    return out


# ---------------------------------------------------------------------------
def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a card")
    try:
        import h2o3_tpu_torch as h2o
        from h2o3_tpu_torch.ops import _build
        from h2o3_tpu_torch.ops import hist_cuda as HC
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    # a float32 matmul stays full precision on the card; state it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--psvm-cpu-reference"]:
        psvm_cpu_reference(torch, h2o)
        return
    if sys.argv[1:] == ["--airline-cpu-reference"]:
        _on_cpu(h2o, lambda: airline_cpu_reference(torch, h2o))
        return
    if sys.argv[1:] == ["--cloud-only"]:
        cloud_only(torch, h2o, HC, _build)
        return
    t_start = time.perf_counter()
    # host-only work off the card's critical path: (ao)'s files and its
    # Python tokenizer, (aq)-(as)'s and (ar)'s data and numpy answers,
    # made from their seeds in the host worker while the card runs
    work = tempfile.mkdtemp(prefix="h2o3_smoke_host_")
    host = HostWorker()
    try:
        air_dir = os.path.join(work, "airline")
        os.makedirs(air_dir)
        airline = (air_dir, host.submit(airline_files, air_dir, AIR_N,
                                        AIR_PY_ROWS))
        munging = (host.submit(groupby_data, work, GB_N, GB_K),
                   host.submit(join_data, work, JN_N))
        analysis = host.submit(
            analysis_task, os.path.dirname(os.path.abspath(__file__)))
        run_main_path(torch, h2o, HC, _build, t_start, host, airline,
                      munging, analysis)
    except BaseException:
        host.close(kill=True)
        raise
    else:
        host.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_main_path(torch, h2o, HC, _build, t_start, host, airline, munging,
                  analysis):
    """Every phase in order, then the recap and the two JSON lines."""
    card = run_phase("card", phase_card, torch, _build)
    dev = torch.device("cuda", 0)

    def kernels_small():
        # 32 columns: HIGGS's 28 padded; 56: Covertype's 54, a partial
        # last group in every kernel's column groups
        t_be = 0.0
        for c_pad in (32, 56):
            phase_kernels_small(torch, HC, dev, c_pad)
            phase_adversarial(torch, HC, dev, c_pad)
            t_be += parity_run(torch, dev, c_pad)
        return t_be
    t_be = run_phase("kernels", kernels_small)
    # (ap)'s CSV, parsed again over REST by (bb); removed on any exit
    keep = tempfile.mkdtemp(prefix="h2o3_smoke_")
    try:
        _run_phases(torch, h2o, HC, t_start, card, dev, host, airline,
                    munging, os.path.join(keep, "higgs-1m.csv"), t_be,
                    analysis)
    finally:
        shutil.rmtree(keep, ignore_errors=True)


def _run_phases(torch, h2o, HC, t_start, card, dev, host, airline, munging,
                higgs_csv, t_be, analysis):
    for name, fn in (("small_path", phase_small_path),
                     ("small_adaptive", phase_small_adaptive),
                     ("small_glm", phase_small_glm),
                     ("small_ingest", phase_small_ingest)):
        run_phase(name, fn, torch, h2o, HC)
    covtype = run_phase("covtype", phase_covtype, torch, h2o, HC)
    runs = run_phase("higgs", phase_higgs, torch, h2o, HC)
    run_phase("isofor", phase_isofor, torch, h2o, HC)
    run_phase("glm_cv", phase_glm_cv, torch, h2o, HC)
    run_phase("dl_unsupervised", phase_dl_unsupervised, torch, h2o, HC)
    framework = run_phase("framework", phase_framework, torch, h2o, HC)
    derived = run_phase("derived", phase_derived, torch, h2o, HC)
    # (ap)'s rows, written to its CSV by the host worker during (al)-(an)
    written = start_higgs_csv(torch, h2o, higgs_csv, host)
    run_phase("data_plane", phase_data_plane, torch, h2o, HC, host)
    run_phase("ingest", phase_ingest, torch, h2o, HC, higgs_csv, airline,
              written)
    run_phase("munging", phase_munging, torch, h2o, HC, data=munging)
    run_phase("export_explain", phase_export_explain, torch, h2o, HC, host)
    run_phase("obs_serving", phase_obs_serving, torch, h2o, HC)
    findings = run_phase("analysis", phase_analysis, analysis)
    run_phase("capture_check", phase_capture_check, torch, h2o, HC,
              findings)
    ay = run_phase("qos_serving", phase_qos_serving, torch, h2o, HC)
    # (bh)'s processes start here, beside phase rest
    cloud = start_cloud()
    t_bg = run_phase("rest", phase_rest, torch, h2o, HC, higgs_csv, ay,
                     card, cloud=cloud)
    t_bh = run_phase("cloud", phase_cloud, torch, h2o, HC, cloud,
                     higgs_csv, card)
    t_bf = run_phase("client", client_run, torch, h2o, card)
    say(f"front ends and the parity gate, runs (be)-(bg): (be) {t_be:.1f} "
        f"s, (bf) {t_bf:.1f} s, (bg) {t_bg:.1f} s; {t_be + t_bf + t_bg:.1f} "
        f"s together")
    say(f"the cloud, run (bh): {t_bh:.1f} s")
    runs["d"] = covtype
    kernels = run_phase("timing", phase_timing, torch, HC, runs)
    recap = [line for line in LOG if RECAP.match(line)]
    say("launches over the grid (x), the ensemble (y) and the segments "
        "(z): " + "; ".join(f"({k}) {v}" for k, v in framework.items()))
    say("launches over RuleFit (ah) and the infogram (aj): "
        + "; ".join(f"({k}) {v}" for k, v in derived.items()))
    say(f"recap of runs (d)-(bg) and the (d)-(f) kernels' timings "
        f"({len(recap)} lines, as printed above):")
    for line in recap:
        print(f"  {line}", flush=True)
    for line in LOG:
        if line.startswith("phase "):
            print(f"  {line}", flush=True)
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s (card "
        f"idle for host-only work {HOST_ONLY[0]:.1f} s)")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
