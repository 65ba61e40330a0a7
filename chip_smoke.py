#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`gsrs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

1. Prints the card's name and power limit, and turns TF32 off.
2. Builds every CUDA kernel from ``gsrs_tpu_torch/csrc``, one ``nvcc``
   per source, all started together.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card. Masked scoring (K1/K2) with random bitsets at B = 1, 13, 256 and
   2048 (the eval batch), d = 40 and 64, the odd m = 40,981 in natural
   order and in the bit-plane layout at block_m = 64, 4096 and 8192, and
   at m = 100; and at NGCF's width d = 256. The ELL gather-reduce (K4) on
   every bucket of both sides of the Gowalla-shaped stand-in, fp32 and
   bf16, with and without an edge mask; on a side whose hub row of 140,000
   slots crosses max_width twice (the layout adds its two overflow chunks
   one chunk level after the other; two applies bitwise equal, the card
   against the CPU) and on rows of exactly S, S + 1 and 2S real
   slots and one that is padding after slot 1 (S = the split length: rows
   longer go through the kernel's second pass); two calls on the same
   inputs must be bitwise equal; and at the TPU probe's shape against the
   probe's own oracle. Fused Adam (K3), one launch over all the leaves of
   a step, bit for bit against its plain version in fp32 and bf16 over 3
   steps across an lr milestone: one leaf each of 37 × 11 (a ragged end)
   and of the Gowalla-shaped tables; NGCF's 14 leaves at full width in fp32
   and in bf16; one launch mixing fp32 and bf16 leaves with a leaf whose
   gradient is None; views at storage offset 1 (the scalar path); 70
   leaves (two launches a step, counted). Then every ranking path (exact,
   threshold, approx, a one-rank `merge_topk`) in ``lax.top_k``'s order
   at B 2048 x m 91,599, k 20: exact bitwise equal to `stable_topk` on
   scores rounded to 0.1 with an all-zero row, and with −0.0 kept; each
   path bitwise the CPU's result on those rows (threshold's whole-batch
   fallback) and on rows whose 20th and 21st scores are +0.0 and −0.0
   (its candidate path), threshold and the merge bitwise exact's; their
   times beside a bare `torch.topk`'s on tie-free scores. Then the exact
   top-k kernel (``csrc/exact_topk.cu``, `time_exact_topk`) at the
   amazon-book eval's and the Gowalla request's shapes: launch counts,
   bitwise `stable_topk`'s and its plain version's, device time beside its
   byte bound, its plain version, the plain path before it and
   `torch.topk`. Every later phase that ranks by exact top-k checks that
   the kernel ran once a top-k call and the plain path never.
4. Serving phase, LightGCN at Gowalla's shape (a seeded power-law
   stand-in: 29,858 users × 40,981 items, average degree 27), 3 layers at
   dim 64, fp32, seeded weights: build the graph, propagate, build the
   Retriever and answer 4 requests of 256 users with top-20, in the
   natural and the bit-plane layout, checked against the plain path on
   the card; an npz export → load round trip must be identical.
5. Training phase, the same shape with a 20% holdout: through `Trainer`,
   20 steps at batch 2048 under ``fused_adam="off"``, the same under
   "pallas", 20 steps at 8192 under "off" and one full `train_epoch` at
   8192 under "pallas". Then one seeded model and optimizer state on the
   card and on the CPU take the same 3 triplet batches through
   `run_steps`: parameters and losses must agree within 1e-5.
6. Eval phase: `Trainer.evaluate` on the card and on the CPU from the
   same parameters; recall, precision and NDCG@20 must agree within 1e-6.
7. Quality drive (`gsrs_tpu_torch.drive`): 150 BPR steps on a clustered
   200 × 300 set; loss < 0.1, valid triplets, no train positive in the
   top-20, recall@20 > 0.3.
8. Tiled phase, the configuration of ``bench.py``: the tiled layout
   (G = 64 groups × C = 2048 hub columns) on the training data: its
   build seconds (spectral order, layout) and dense coverage; one tiled
   layer against the ELL layer, forward and VJP, in fp32 (within the ELL
   tolerance), in bf16 (within a limit counted from its bf16 roundings)
   and with a hash mask; 3 `run_steps` on the card and on the CPU over a
   16 × 256 tiled layout in fp32 and bf16; then, counted, one
   `Trainer.train_epoch` of ``bench.py``'s configuration
   (`gsrs_tpu_torch.bench.bench_config`: bf16, batch 131072,
   ``neg_candidates=4``; the benchmark's ``gowalla-train`` times it),
   which must launch K4 on every residual and ``occ`` side; one epoch
   under torch.profiler, and the device time of each K4 side and each grouped hub product. K4
   against its plain version on each of those six sides (fp32 and bf16,
   the residual without and with its hash mask), and each grouped product
   within one bf16 rounding of its fp32 result.
9. CLI phase, ``python -m gsrs_tpu_torch``'s lifecycle at full width:
   the stand-in written as a dataset directory under ``build/smoke`` and
   its i2i npz (`gsrs_tpu_torch.data.i2i`, cooc, top 10); then, counted,
   `gsrs_tpu_torch.cli.main` for 3 epochs (bf16, batch 2048, pop gate, i2i
   smoothing, approx top-k, the fused Adam kernel, an eval every epoch,
   periodic saves every 2, keep-top-1), which must write the JAX
   trainer's CSVs, checkpoint listing and ``model_meta.json`` and launch
   K4 on the user, item and both i2i sides, K1 once per eval batch and K3
   once per step (⌈leaves/64⌉ launches). A ``--resume`` to 4 epochs must start at epoch
   3 and end within 1e-6 of an uninterrupted 4-epoch run, the first run's
   trainer taking a fourth epoch in memory (bitwise equality logged;
   evals draw no randomness, so its missing eval changes nothing);
   ``serve export`` then ``serve query`` must give the top-20 of
   a Retriever built from the trained model; the Evaluator with exact,
   threshold and approx on the final parameters (threshold bitwise exact,
   approx's recall at least its target less 0.02, each method's eval
   seconds); and K4 on both i2i sides against its plain version.
10. Zoo phase, the graph family's other models and layouts at full width:
   the segment layer (JAX's interface over the ELL layer, K4 on both
   sides) forward and VJP on the card against the CPU (fp32 and bf16,
   without and with an edge mask, two calls bitwise equal) and the ELL
   layer's device time beside `torch.segment_reduce`'s; the hybrid layout at C = 8192
   in fp32 and bf16 (build seconds, dense coverage, its layer forward and
   VJP against the CPU's ELL layer without and with hash dropout, two
   calls bitwise equal, K4 against its plain version on both residual
   sides of both directions, device time of the layer, of each dense
   product beside its bound and of each K4 residual side); K1 at d = 256
   timed; each model and layout (MF, NGCF,
   XSimGCL, UltraGCN `full` and `pool` with `ug_sift_pos`, LightGCN on
   the hybrid and segment layouts) on the card against the CPU for 3
   steps on a 1,500 × 2,000 graph at three seeds (losses, the first
   step's gradients before Adam, the parameters after it; and a control
   with K3's bias correction one step late, which must fail the
   parameter check); then, counted, each through
   `gsrs_tpu_torch.cli.main` for one whole epoch with an eval before and
   after it, launching K1 once per eval batch, K3 once per step and K4
   on every side of its layout (none without one), and after it,
   uncounted, 5 more steps under torch.profiler (wall and device µs a
   step, busy share, the costliest device rows).
11. Seq phase, the sequential family (SASRec, GRU4Rec, BERT4Rec) at the
   CLI's full width (dim 64, 2 blocks, max_len 50, batch 256): each
   model, and SASRec under ``--bf16``, on the card against the CPU for 3
   steps on a 1,500 × 2,000 stand-in's sequences (max_len 20, batch 512)
   at three seeds, both sides handed the same batches and draws, the CPU's
   steps under `torch.use_deterministic_algorithms(True)` (losses,
   the first step's gradients before Adam, the parameters after it, and
   for fp32 the eval of the same parameters within 1e-6; controls: Adam's
   bias correction one step late must fail the parameter check, BERT4Rec
   with the erf GELU the gradient check); then, counted, each through
   `gsrs_tpu_torch.seq_cli.main` on the stand-in for 2 epochs with an eval
   every epoch, launching K1 once per eval batch (⌈N/256⌉ an eval) and no
   other kernel, with the JAX trainer's CSVs, checkpoints and
   ``model_meta.json``; a warm eval and 5 profiled steps each; SASRec's
   ``--resume`` to 3 epochs bitwise equal to its first run's trainer
   taking epoch 3 in memory; ``serve_seq export`` then ``serve_seq
   query`` (K1 once, top-20 equal to the plain version's on the card);
   request p50 at 1 and 64 sessions and K1's time at those shapes; the
   learning check (SASRec on ``--synthetic`` Markov data: recall@10 above
   twice its start and above 0.2); and the native host sampler's build.
12. Hits phase: the stand-in holds out each user's least popular item,
   so a trained graph model scores 0 there and a check that holds its
   metrics equal holds zeros equal. So LightGCN at full width (3 layers,
   dim 64, ELL fp32, exact top-k, the fused Adam kernel, lr 5e-2) goes
   through `gsrs_tpu_torch.cli.main` for 10 epochs, counted, on a clustered
   set of 8,000 users x 10,000 items in 64 clusters (degree about 28; each
   test item an unseen item of the user's cluster): K4 on both sides, K3
   once a step, K1 once an eval batch; its last recall@20 at least 10x
   chance (the mean over test users of 20 over their unseen items), and
   the same parameters on a split of random unseen test items (the
   control) below that floor. On that run: card against CPU (metrics
   within 1e-6, every test user's top-20 ids equal but for boundary
   swaps), threshold's metrics and ids equal exact's and approx's recall
   at its target less 0.02, and the natural and bit-plane Retrievers'
   top-20 over every test user equal (K1 on one side, K2 on the other).
13. Tools phase, the JAX package's user tools as ported in
   `gsrs_tpu_torch.tools`, each through its ``main`` on the card, counted,
   on what the CLI, zoo, seq and hits phases left: ``eval_checkpoint`` of
   the zoo's lgn_segment run, of the SASRec run and of the hits run, each
   reproducing the run's last valid CSV row within METRIC_ATOL (the hits
   run's at least its floor; K1, and K4 on the graph);
   ``bench_serving`` on the CLI run's checkpoint (its rows, K1 on each; its
   fp32 batch-256 top-20 equal to a Retriever of the CLI run's model);
   ``bench_eval``'s five variants on the stand-in (the lgn_segment
   parameters) and the amazon-book-scale stand-in (52,643 × 91,599): K2 in
   the bit-plane row only, K1 in the others, exact and bit-plane metrics
   within METRIC_ATOL; and on the hits run (``--skip_scale``), whose exact,
   natural and bit-plane rows agree within METRIC_ATOL at or above its
   floor, and whose approx row reaches its target less 0.02 of exact's;
   K1 and K2 at B 2048 × d 64 × m 91,599 against their
   plain versions, timed beside their bound and `torch.matmul`;
   ``visualize``'s pop gates of the CLI run on the card against the CPU
   within 1e-5 (K4) and its curve series; ``compute_ppr``'s rows summing
   to 1; ``bench_spmm_modes`` (ell, hybrid8192, tiled 64:2048 at batch 2048
   and 8192, one timed epoch; K4 on each); ``bench_seq`` at 100k × 20k ×
   64 (one timed epoch a model; K1 on each eval batch) and one profiled
   step of each model; ``bench_scaling`` at its default shapes (100k ×
   50k, batch 8192, bf16) on 1, 2 and 4 gloo ranks sharing the card for 3
   steps (meshes 1x1, 2x1, 2x2; warm-up losses within the bf16 mesh
   limit of size 1's; K4 on rank 0; a shared card: no speed-up is read);
   ``sweep_xsimgcl`` on the stand-in's directory (2 configurations x 2
   epochs at batch 8192, an eval each; K4 and K1); ``profile_epoch
   --eval`` (its phases, and a trace whose device events name K4's and
   K1's kernels); ``bench_scale_standin``'s four subprocesses (yelp2018
   and amazon-book shapes, ELL and hybrid, batch 8192: no FAILED row,
   device memory in use beside the parameters' and layout's bytes, K4 and
   K1); ``bench_seq_markov`` at its shapes for 30 epochs (SASRec and
   GRU4Rec at 5x the popularity ranker's recall@10 or more).
14. Mesh phase: the (data, model) mesh of ``gsrs_tpu_torch.parallel`` on
   the card, at full width, fp32, on the ELL layout: four gloo ranks on
   the one card form a 2 × 2 mesh (NCCL refuses two ranks on one
   device); in every rank `cli.main` trains LightGCN for 10 steps of 2048
   (fused Adam kernel, an eval before and after, a checkpoint) and resumes
   for one more step; the same 3 batches through `make_train_step` and
   `make_shard_map_train_step` from seeded parameters, a sharded eval and
   4 requests × 256 users of the sharded Retriever, each against the
   single card on the same parameters and batches (losses, parameters,
   metrics, top-20), and the hits run restored on the mesh and evaluated
   sharded (equal on every rank, within 1e-6 of one card's, at or above
   its floor), with a control (the model-axis copies not divided
   out: the loss doubles) that must fail the loss limit; SASRec through
   `seq_cli` on the same mesh against the card. Every rank must launch
   K4, K1 and K3 (K3 once per step of its CLI run and resume). Readings:
   ms a mesh step, its collectives' wall time
   (gloo: host-staged, not NVLink), each rank's K4 side and K1 shard
   against the single card's whole tables. The same ranks then run the
   tiled and hybrid layouts, their dense blocks column-sharded
   (`MESH_BLOCKS`): 3 seeded steps each of bench.py's tiled G64 x C2048
   bf16 at batch 131072, hybrid C = 8192 bf16 with hash dropout, and tiled
   C = 2050 fp32 (C not dividing 4: whole on every rank, added by rank 0)
   through `make_train_step` against the single card, each with a control
   adding the whole blocks on every rank that must fail the limits; each
   rank's dense bytes (a quarter, or the whole), K4 launched on each of
   its residual and `occ` sides, a bf16 mesh layer against its rounding
   limit, per-rank K4 and product device times beside the whole layout's,
   the tiled step's collective share, and whether gloo (and NCCL) reduce
   a bf16 tensor themselves. Then NCCL: the CLI across min(cards, 4) cards
   when there are two or more, else a one-rank NCCL group running the
   mesh step on this card; the line says which.
15. Stress phase, ``python -m gsrs_tpu_torch.stress_pod`` through its
   `main`: BASELINE config 5's plan on H100s (``--plan_only --chip
   h100``), one counted run on the card at 1M users x 500k items, dim 256
   (K4, K1 launched, K3 once per step; its peak device memory beside the plan's total),
   K1 timed at its eval's shape, then ``--smoke`` on four gloo ranks.
16. Times each kernel by its device time (the kernels' own time in
   torch.profiler's device-side events over a window of launches, after a
   warm-up; CUDA events around the same calls are logged beside it where
   the two differ by more than 10%) beside its bound, its plain version
   and one PyTorch call (K3 as one launch over the leaves of a step: the
   two tables, the CLI run's 10 leaves and NGCF's 14, beside the library's
   Adam over the same leaves and the same leaves as one-leaf launches, on
   copies that cycle through more than the L2, as in a train step; and
   the host µs of a `FusedAdam.step` call), and
   the end-to-end numbers: request latency,
   propagation forward and forward + backward, ms per step, seconds per
   epoch and per eval, peak device memory, and the device's busy share
   during requests and train steps (torch.profiler).

Each phase counts every kernel's launches from just before it drives its
path (`gsrs_tpu_torch.kernels.launch_counts`) and fails unless the
kernels of that path launched. Every bound is a least time by
``benchmark/counts/``: the card's peaks (`peaks.least_s`), and K3's and
K4's counts. Prints ``{"kernels": [...]}`` on the line before the last
and, as the last line, ``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero; without a CUDA card it exits 2 and prints no result. It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from benchmark.counts.kernels import k3_least_s, k4_least_s
from benchmark.counts.peaks import least_s
from gsrs_tpu_torch.kernels import (
    CSRC_DIR, KERNELS, build_kernels, launch_counts, launches_since, library_path,
)

SEED = 2020
GOWALLA_SHAPE = dict(n_users=29858, m_items=40981, avg_degree=27)
BATCH, K, N_REQUESTS = 256, 20, 4
ATOL = 1e-4  # kernel vs plain: fp32 sums in another order, |score| ≲ 30
SWAP_TOL = 1e-5  # top-k boundary ties the two orders may rank either way
ELL_ATOL = 1e-5  # K4 fp32: sums of O(1) in another order
# K4 bf16 against the fp32 sum of the weights rounded to bf16 (as the kernel and JAX round
# them): one rounding of that sum to bf16 (at most 2^-8 relative) ...
ELL_BF16_RTOL = 2.0**-8
ELL_BF16_ATOL = 1e-5  # ... plus the fp32 order difference near zero
TRAIN_ATOL = 1e-5  # card vs CPU after 3 steps: parameters and losses
METRIC_ATOL = 1e-6  # card vs CPU eval metrics
# the hits phase's trained recall@20 must reach this multiple of chance (`chance_recall`), and
# its random-item control must stay below it
HITS_FLOOR_VS_CHANCE = 10.0
# the tiled phase: bench.py's layout, and a small one for the card-vs-CPU steps
TILED_G, TILED_C = 64, 2048
SMALL_G, SMALL_C = 16, 256
TILED_DROP = (0x2545F491, 0x9E3779B9, 0.6)  # hash dropout's key words (one above 2**31), keep
# bf16 tiled layer against the fp32 result of the bf16-rounded inputs and weights: each
# rounding to bf16 errs by at most 2^-8 of its value, and a path through the layer rounds at
# most twice forward (the hub product or the residual sum, then their sum) and three times
# backward (the hub cotangent, the occ sum, then the sum with the residual); every value on
# the path is at most sum |w| |x|, which the limit scales
TILED_BF16_ROUNDINGS = {"forward": 2, "backward": 3}
TILED_BF16_ATOL = 1e-5  # plus the fp32 order difference near zero
# bf16 tiled training, card vs CPU after 3 Adam steps at lr 1e-3: the layers round in other
# orders, so gradients differ by about one bf16 rounding (2^-8 relative). Adam's update
# m/sqrt(v) barely moves with that, except where a gradient sits at the rounding noise and
# its sign can flip (a difference of up to 2 lr a step): the losses agree within 2^-8 of
# their size, at most this share of parameters differ by more than TILED_PARAM_ATOL, and
# none by more than 2 lr a step
TILED_BF16_LOSS_RTOL = 2.0**-8
TILED_PARAM_ATOL = 1e-4
TILED_BF16_PARAM_SHARE = 1e-3
# the CLI phase: 3 epochs at full width, then a resume to 4 against 4 without a stop
CLI_DATASET, CLI_EPOCHS = "cli_data", 3
RESUME_ATOL = 1e-6  # resumed vs uninterrupted parameters on the card
APPROX_SLACK = 0.02  # approx's measured recall may fall this far under its target
# the hits phase: LightGCN at full width through the CLI on a clustered set whose test item is
# an unseen item of the user's cluster, which a trained model ranks far above chance (the
# stand-in holds out each user's least popular item, and its trained metrics read 0). 156
# items and 125 users a cluster, degree about 28 (Gowalla's 27), one test item a user
HITS_DATASET, HITS_CKPT = "hits_data", "hits_ckpt"
HITS_SHAPE = dict(n_users=8000, m_items=10000, n_clusters=64, in_cluster_p=0.12,
                  cross_cluster_p=0.00084)
HITS_EPOCHS, HITS_LR = 10, 5e-2
# the zoo phase: each model and layout of the graph family through the CLI for one epoch
ZOO_RUNS = {
    "mf": ["--model", "mf"],
    "ngcf": ["--model", "ngcf"],
    "xsimgcl": ["--model", "xsimgcl"],
    "ultragcn_full": ["--model", "ultragcn", "--ug_neg_sharing", "full"],
    "ultragcn_pool_sift": ["--model", "ultragcn", "--ug_neg_sharing", "pool", "--ug_sift_pos"],
    "lgn_hybrid": ["--spmm", "hybrid", "--bf16", "--dropout", "1"],
    "lgn_segment": ["--spmm", "segment", "--dropout", "1"],
}
ZOO_D = 256  # NGCF's scoring width, d·(K+1) at 3 layers of 64
HYBRID_C = 8192  # the hybrid layout's default hub columns
# bf16 hybrid layer against the fp32 result of the bf16-rounded inputs and weights: two
# roundings forward (the product or the residual sum, then their sum) and two backward (the
# hub cotangent or the residual, then their sum in the hub rows); a mask rounds w · mask and
# the masked dense cell once more each
HYBRID_BF16_ROUNDINGS = 2
# the segment layer (the ELL layer, K4 on each side) rounds w · mask to bf16 and then its fp32
# sum: two roundings, so a card and a CPU result differ by at most twice that
SEGMENT_BF16_ROUNDINGS = 2
# the zoo's card-vs-CPU steps: each configuration on a small graph at each seed
ZOO_SMALL = dict(n_users=1500, m_items=2000, avg_degree=20)
ZOO_SEEDS = (SEED, SEED + 1, SEED + 2)
ZOO_CARD_VS_CPU = {
    "mf": dict(model="mf"), "ngcf": dict(model="ngcf"), "xsimgcl": dict(model="xsimgcl"),
    "ultragcn_full": dict(model="ultragcn", ug_neg_sharing="full"),
    "ultragcn_pool_sift": dict(model="ultragcn", ug_neg_sharing="pool", ug_sift_pos=True),
    "lgn_hybrid": dict(spmm_mode="hybrid", hybrid_cols=256),
    "lgn_segment": dict(spmm_mode="segment"),
}
# the first step's gradients, before Adam: fp32 sums in another order, against the leaf's
# largest gradient
ZOO_GRAD_RTOL = 1e-5
# the parameters after 3 Adam steps at lr 1e-3. Adam divides each element's update by that
# element's own gradient RMS, so an element whose gradient is a small remainder of larger
# terms (UltraGCN's tables start at N(0, 1e-4^2), its losses are sums) carries the sums'
# rounding, scaled up by the leaf's largest gradient over its own, into its update. The
# limit sits between the sound runs' readings and the control's (PERF.md)
ZOO_PARAM_ATOL = 5e-5
# the seq phase: the sequential family through seq_cli at its full width (dim 64, 2 blocks,
# max_len 50, batch 256) on the stand-in, 2 epochs each, an eval every epoch
SEQ_RUNS = {"sasrec": ["--model", "sasrec"], "gru4rec": ["--model", "gru4rec"],
            "bert4rec": ["--model", "bert4rec"], "sasrec_bf16": ["--model", "sasrec", "--bf16"]}
SEQ_EPOCHS = 2
SEQ_GATHERS = {"sasrec": 2, "gru4rec": 1, "bert4rec": 2, "sasrec_bf16": 2}  # a step's
SEQ_LEARN_EPOCHS = 20
SEQ_REQUESTS = 20
# card vs CPU: 3 steps of each configuration on the 1,500 × 2,000 stand-in's sequences
SEQ_VS_CPU = {"sasrec": ("sasrec", False), "gru4rec": ("gru4rec", False),
              "bert4rec": ("bert4rec", False), "sasrec_bf16": ("sasrec", True)}
SEQ_SMALL_LEN, SEQ_SMALL_BATCH = 20, 512
# controls on the card that must break the check named: Adam's bias
# correction one step late; BERT4Rec with torch's erf GELU; SASRec computing in fp32 where
# the CPU computes in bf16
SEQ_CONTROLS = {"sasrec": (("late_bias", "params"),), "bert4rec": (("erf_gelu", "grad"),),
                "sasrec_bf16": (("late_bias", "share_over"), ("fp32", "grad"))}
SEQ_VS_CPU_TOPKS = (20, 500)  # 500 of 2,000 items: enough hits that the eval check shows them
# Card against CPU after 3 steps at lr 1e-3. fp32: sums in another order; Adam's first update
# lr·g/(|g| + ε) is steepest where |g| ≲ ε, so the parameters carry more than the gradients do.
# bf16: the two sides round in other orders (cuBLAS with an fp32 reduction against the CPU's
# GEMM), so gradients differ by about one bf16 rounding (2^-8) of the leaf's largest, and an
# element whose gradient sits at that noise can flip its Adam sign (up to 2 lr a step): the
# parameters are held by their largest difference (3 steps · 2 lr) and by the share of
# elements over SEQ_PARAM_ATOL. Each limit lies between the largest sound reading and its
# control's (PERF.md §6, PR 7).
SEQ_PARAM_ATOL = 5e-5
SEQ_LIMITS = {
    "fp32": dict(loss=1e-5, grad=1e-5, params=SEQ_PARAM_ATOL, share_over=0.0),
    "bf16": dict(loss=2.0**-8, grad=2.0**-6, params=6e-3, share_over=0.2),
}
L2_BYTES = 50 * 2**20  # the H100's L2: a timing meant to read HBM cycles through more
REPLACES = {
    "masked_scores": "gsrs_tpu/ops/pallas_kernels.py:65",
    "masked_scores_bitplane": "gsrs_tpu/ops/pallas_kernels.py:190",
    "fused_adam": "gsrs_tpu/train/fused_adam.py:76",
    "ell_gather_reduce": "tools/probe_pallas_gather.py:28",
    "exact_topk": "no Pallas kernel: lax.top_k in gsrs_tpu/ops/topk.py:topk_scores (exact)",
    "gather_rows_grad": "no Pallas kernel: XLA's scatter-add, the gradient of a table row "
                        "gather",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, warmup: int = 5, events: Optional[int] = None) -> float:
    """Mean device milliseconds per call of ``fn``: the device time of the
    kernels and copies its ``reps`` calls launched (torch.profiler,
    device-side events only), so no host dispatch enters the figure.
    The profiler drops device events: often the first one or two of a
    window (98 of 100 one-kernel calls), at times most of it (K3 once read
    2.6 µs for a 20 µs kernel) or all of it. So the time a call is the
    window's device time over the calls it saw, ``n / c`` for ``n``
    events of ``c`` (``events`` where the caller knows it, else the
    nearest whole count, at least 1) a call, and a window that lost more
    than 3% of ``c · reps`` is profiled again, up to three times in all;
    then the fullest one is taken, and one with no event fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    windows = []
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        n = sum(c for _, _, c in rows)
        per_call = events or max(1, round(n / reps))
        windows.append((n, sum(t for _, t, _ in rows), per_call))
        if n >= 0.97 * per_call * reps:
            break
        log(f"[profile] the profiler delivered {n} device events for {reps} calls: "
            "profiling again")
    else:
        log(f"[profile] no whole window in three: taking the fullest, {max(windows)[0]} events")
    n, us, per_call = max(windows)
    check(us > 0, "the profiler saw no device time")
    return us / 1e3 * per_call / n


def device_rows(prof):
    """[(name, device µs, calls)] of the kernels and copies a profile
    saw. Only device-side events are summed: a CPU operator's device time
    is that of the kernels it launched, which are counted already, and a
    `record_function` range (torch.optim's ``Optimizer.step#…``) also
    appears on the device timeline as a user annotation spanning its
    kernels, which would count them twice."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def kernel_ms(fn, reps: int, what: str, warmup: int = 5, events: Optional[int] = None) -> dict:
    """{"ms": device time per call (`device_ms`), "events_ms": CUDA events
    around the same number of back-to-back calls}. The events also time
    the host's enqueue of each call; where they differ from the device
    time by more than 10%, both are logged."""
    t = dict(ms=device_ms(fn, reps, warmup, events), events_ms=cuda_ms(fn, reps, warmup))
    if abs(t["events_ms"] - t["ms"]) > 0.1 * t["ms"]:
        log(f"[time] {what}: device {t['ms'] * 1e3:.1f} us a call, CUDA events "
            f"{t['events_ms'] * 1e3:.1f} us")
    return t


def events_per_call(fn, reps: int = 10) -> int:
    """The device events one call of ``fn`` makes, where the caller cannot
    count them: after ``reps`` calls of warm-up (a fresh optimizer's first
    step also fills its moments), each kernel's count is the most it
    reached in three windows of ``reps`` calls, since the profiler drops
    events but adds none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(reps):
        fn()
    most = {}
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for name, _, count in device_rows(prof):
            most[name] = max(most.get(name, 0), count)
    return max(1, round(sum(most.values()) / reps))


def cold_copies(make, nbytes: int):
    """An endless cycle over copies made by ``make()``, each of ``nbytes``,
    enough of them that between two uses of one copy the others touch
    twice the L2: a call timed on the next copy reads HBM, as it does
    inside a train step."""
    return itertools.cycle([make() for _ in range(1 + -(-2 * L2_BYTES // nbytes))])


def adam_step_times(dev, spec, reps: int = 50, calls: int = 300,
                    bound_ms: Optional[float] = None) -> dict:
    """`FusedAdam(backend="pallas").step` over leaves ``spec`` [(shape,
    dtype)], reached only through `FusedAdam` and ``LAUNCHES`` (so it also
    times another checkout of the port, put first on ``sys.path``) →
    {"launches": K3's launches a step, "ms": device time of a step (each
    on the next of `cold_copies`, as a train step finds its leaves; timed
    again, up to three times, while under ``bound_ms``), "events_ms",
    "host_us": host µs of a call, ``perf_counter`` around `step` with no
    synchronize, mean of ``calls`` after 20 (the queue drained every 50
    calls, outside the clock)}."""
    from gsrs_tpu_torch.train.fused_adam import LAUNCHES, FusedAdam

    opt = FusedAdam(schedule=lambda count: 1e-3, backend="pallas")

    def copy():
        params = {f"leaf{i}": torch.nn.Parameter((0.1 * torch.randn(s, device=dev)).to(dt))
                  for i, (s, dt) in enumerate(spec)}
        grads = [(1e-3 * torch.randn(s, device=dev)).to(dt) for s, dt in spec]
        return [params, grads, opt.init(params)]

    def step(c):
        for p, g in zip(c[0].values(), c[1]):
            p.grad = g
        c[2] = opt.step(c[0], c[2])

    nbytes = sum(4 * int(np.prod(s)) * torch.tensor([], dtype=dt).element_size()
                 for s, dt in spec)
    copies = cold_copies(copy, nbytes)
    c = next(copies)
    before = LAUNCHES["fused_adam"]
    step(c)
    launches = LAUNCHES["fused_adam"] - before
    total = 0.0
    for i in range(20 + calls):
        if i % 50 == 0:
            torch.cuda.synchronize(dev)
        for p, g in zip(c[0].values(), c[1]):
            p.grad = g
        t0 = time.perf_counter()
        c[2] = opt.step(c[0], c[2])
        if i >= 20:
            total += time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    t = timed_over_bound(lambda: step(next(copies)), reps, f"FusedAdam.step {len(spec)} leaves",
                         max(1, launches), bound_ms)
    return dict(launches=launches, host_us=1e6 * total / calls, **t)


def timed_over_bound(fn, reps: int, what: str, events: int,
                     bound_ms: Optional[float] = None) -> dict:
    """`kernel_ms`, timed again, up to three times in all, while it reads
    under ``bound_ms``: the profiler misreported that window."""
    for _ in range(3):
        t = kernel_ms(fn, reps, what, events=events)
        if bound_ms is None or t["ms"] >= bound_ms:
            break
        log(f"[time] {what}: {t['ms'] * 1e3:.1f} us is under the HBM bound "
            f"{bound_ms * 1e3:.1f} us: timing again")
    return t


def least_ms(flops: float, nbytes: float, dtype: str = "float32"):
    """`benchmark.counts.peaks.least_s` in ms → (ms, "flops" | "bytes")."""
    s, by = least_s(flops, nbytes, dtype)
    return 1e3 * s, by


def k1_least_ms(B: int, d: int, m: int, W: int):
    """(ms, bound by) of one masked-scoring call on (B, d) users, (m, d)
    items and (B, W) bitset words: 2·B·m·d fp32 operations, the inputs
    read once and the (B, m) scores written once (K1 writes them; the
    benchmark's `k1_least_s`, which counts a top-k fused into K1, does
    not)."""
    return least_ms(2.0 * B * m * d, 4.0 * (B * d + m * d + B * W + B * m))


def k4_least_ms(slots: int, x, n_rows: int):
    """(ms, "bytes") of one K4 call of ``slots`` slots from the source rows
    ``x`` into ``n_rows`` rows (`benchmark.counts.kernels.k4_least_s`): at
    the widths timed here (d < 80) its 8 B a slot outlast its 2·d fp32
    operations, so bytes bound it."""
    return 1e3 * k4_least_s(slots, x.shape[0], n_rows, x.shape[1], x.element_size()), "bytes"


def source(name: str) -> str:
    """The repository path of kernel ``name``'s source."""
    return os.path.relpath(os.path.join(CSRC_DIR, f"{name}.cu"),
                           os.path.dirname(os.path.abspath(__file__)))


def check_launched(launches: dict, name: str, calls: int, what: str) -> None:
    """``what`` launched kernel ``name`` ``calls`` times, and its plain
    version (``<name>_plain``, where the wrapper counts one) never."""
    plain = launches.get(f"{name}_plain", 0)
    check(launches[name] == calls and plain == 0,
          f"{what}: {name} launched {launches[name]} times for {calls} calls (the plain "
          f"version {plain} times)")


def bpr_gathers(model) -> int:
    """The gathers a LightGCN-family BPR step makes (`_pairwise_bpr`): the
    users' and the items' rows, and with ``reg_mode`` "ego" the raw
    tables' too."""
    return 4 if model.cfg.reg_mode == "ego" else 2


def epoch_steps(trainer) -> int:
    """The steps of one `Trainer.train_epoch`: its ``epoch_samples``
    (default the train size) in whole batches."""
    epoch_size = trainer.epoch_samples or trainer.data.train_size
    return max(1, -(-epoch_size // trainer.cfg.train.batch_size))


def adam_launches_per_step(model) -> int:
    """K3's launches in one step of ``model``: one per 64 leaves."""
    from gsrs_tpu_torch.train.fused_adam import MAX_LEAVES

    return -(-len(list(model.parameters())) // MAX_LEAVES)


# ------------------------------------------------------------- kernel phase


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Identical mask positions, other scores within ATOL → max abs error."""
    from gsrs_tpu_torch.ops.scoring import NEG_INF

    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite scores")
    gm, rm = got == NEG_INF, ref == NEG_INF
    check(bool((gm == rm).all()), f"{what}: mask positions differ")
    err = float((got - ref).abs().masked_fill(rm, 0).max()) if got.numel() else 0.0
    check(err <= ATOL, f"{what}: max abs error {err} > {ATOL}")
    return err


def kernel_phase(dev: torch.device) -> dict:
    """Kernel vs plain version in both layouts → {kernel: max abs error
    at the serving shape}."""
    from gsrs_tpu_torch.ops.scoring import masked_scores, masked_scores_reference

    g = torch.Generator(device=dev).manual_seed(SEED)
    m_main = GOWALLA_SHAPE["m_items"]  # odd: every score row starts at a 4-byte offset
    cases = [(B, d, m_main, bitplane, block_m) for B in (1, 13, BATCH, 2048) for d in (40, 64)
             for bitplane, block_m in ((False, 4096), (True, 64), (True, 4096), (True, 8192))]
    cases += [(BATCH, 64, 100, False, 4096), (BATCH, 64, 100, True, 4096)]
    # NGCF's scoring width: d·(K+1) = 256 at 3 layers of 64
    cases += [(B, ZOO_D, m_main, False, 4096) for B in (1, 13, BATCH, 2048)]
    cases += [(BATCH, ZOO_D, m_main, True, 4096)]
    errs = {}
    for B, d, m, bitplane, block_m in cases:
        rows = -(-m // block_m) * block_m if bitplane else m
        W = rows // 32 if bitplane else -(-m // 32)
        u = torch.randn(B, d, device=dev, generator=g)
        it = torch.randn(rows, d, device=dev, generator=g)
        bits = torch.randint(-2**31, 2**31, (B, W), device=dev, generator=g,
                             dtype=torch.int64).to(torch.int32)
        got = masked_scores(u, it, bits, bitplane=bitplane, block_m=block_m)
        ref = masked_scores_reference(u, it, bits, bitplane=bitplane, block_m=block_m)
        torch.cuda.synchronize()
        name = "masked_scores_bitplane" if bitplane else "masked_scores"
        err = compare(got, ref, f"{name} B={B} d={d} m={m} block_m={block_m}")
        log(f"[kernel] {name:24s} B={B:4d} d={d} m={m:5d}"
            f"{f' block_m={block_m:4d}' if bitplane else ''}: max abs err {err:.3e}")
        if (B, d, m, block_m) == (BATCH, 64, m_main, 4096):
            errs[name] = err
        if (B, d, m, bitplane) == (2048, ZOO_D, m_main, False):
            errs["masked_scores_d256"] = err
    return errs


TIE_SHAPE = dict(B=2048, m=91599, k=20)  # the amazon-book-scale eval batch


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits (−0.0 differs from +0.0)."""
    if a.is_floating_point():
        a, b = a.float().view(torch.int32), b.float().view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def boundary_rows(B: int, m: int, g: torch.Generator, dev: torch.device) -> torch.Tensor:
    """(B, m) scores of −1.0 with 19 of 1.0, one −0.0 and one +0.0 at
    random columns of each row: the two zeros are the 20th and 21st, and
    `topk_threshold` at k = 20 takes its candidate path."""
    x = torch.full((B, m), -1.0, device=dev)
    cols = torch.rand(B, m, generator=g, device=dev).topk(21, dim=1).indices
    x.scatter_(1, cols[:, :19], 1.0)
    x.scatter_(1, cols[:, 19:20], torch.full((B, 1), -0.0, device=dev))
    x.scatter_(1, cols[:, 20:21], torch.zeros(B, 1, device=dev))
    return x


def merged_halves(x: torch.Tensor, k: int):
    """`merge_topk` on a one-rank mesh of the two column halves' exact
    top-k candidates (global ids), as `dist_train.sharded_topk` merges
    catalog shards."""
    from gsrs_tpu_torch.ops.topk import topk_scores
    from gsrs_tpu_torch.parallel.collectives import merge_topk
    from gsrs_tpu_torch.parallel.mesh import single_device_mesh

    h = x.shape[1] // 2
    (v0, i0), (v1, i1) = topk_scores(x[:, :h], k, "exact"), topk_scores(x[:, h:], k, "exact")
    return merge_topk(torch.cat([v0, v1], dim=1), torch.cat([i0, i1 + h], dim=1), k,
                      single_device_mesh(x.device))


TOPK_TURNS = ("topk", "exact", "threshold", "approx", "stable_topk")


def topk_times(topk, raw: torch.Tensor, k: int) -> dict:
    """Ms a call, between CUDA events around 20 calls (the methods read
    the host inside, so a call's whole time, not its kernels' alone), of
    ``torch.topk`` and of the ``topk`` module's exact, threshold, approx
    and `stable_topk` (a whole-row sort, threshold's fallback) on ``raw``,
    each timed twice in turns (forward, then backward through
    `TOPK_TURNS`). ``topk`` is a module argument, so another checkout's
    `gsrs_tpu_torch.ops.topk` can be timed beside this one's."""
    fns = {"topk": lambda: torch.topk(raw, k, dim=1),
           "stable_topk": lambda: topk.stable_topk(raw, k)}
    for method in ("exact", "threshold", "approx"):
        fns[method] = functools.partial(topk.topk_scores, raw, k, method)
    runs = {name: [] for name in TOPK_TURNS}
    with torch.no_grad():
        for name in TOPK_TURNS + TOPK_TURNS[::-1]:
            runs[name].append(cuda_ms(fns[name], reps=20, warmup=3))
    return runs


def exact_tie_check(dev: torch.device) -> dict:
    """``lax.top_k``'s order on the card at the amazon-book-scale eval
    batch, on every ranking path: ``exact``, ``threshold``, ``approx`` and
    a one-rank `merge_topk` (`merged_halves`).
    - Scores rounded to 0.1 (the k-th and (k + 1)-th values tie in nearly
      every row) with an all-zero row, on +0.0 only: exact's ids and
      values bitwise `stable_topk`'s.
    - The same with −0.0 kept and rows of +0.0 and of −0.0 (which send
      threshold to its whole-batch fallback): exact bitwise
      `stable_topk`'s on all rows, the merge bitwise exact's, and every
      path's first 256 rows bitwise the CPU's result, whose order
      tests/test_torch_topk_ties.py and tests/test_torch_topk_signed_zero.py
      hold to ``lax.top_k``.
    - `boundary_rows` (±0 at the k-th boundary; threshold's candidate
      path, asserted): threshold and the merge bitwise exact, every path's
      first 256 rows bitwise the CPU's.
    Then `topk_times` on tie-free scores."""
    from gsrs_tpu_torch.ops import topk

    B, m, k = TIE_SHAPE["B"], TIE_SHAPE["m"], TIE_SHAPE["k"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    raw = torch.randn(B, m, device=dev, generator=g)
    signed = torch.round(raw * 10) / 10
    signed[1] = 0.0
    signed[2] = -0.0
    ties = signed + 0.0  # −0.0 + 0.0 is +0.0
    edge = boundary_rows(B, m, g, dev)

    def tied_rows(x):
        top = torch.topk(x, k + 1, dim=1).values
        return int((top[:, k - 1] == top[:, k]).sum())

    def same(got, want, what):
        check(bitwise_equal(got[1], want[1]) and bitwise_equal(got[0], want[0]),
              f"{what}: differs in {int((got[1] != want[1]).any(dim=1).sum())} rows")

    paths = {"exact": lambda x: topk.topk_scores(x, k, "exact"),
             "threshold": lambda x: topk.topk_scores(x, k, "threshold"),
             "approx": lambda x: topk.topk_scores(x, k, "approx"),
             "merge": lambda x: merged_halves(x, k)}
    candidates = []
    real_candidates = topk._threshold_candidates

    def counted_candidates(*args):
        candidates.append(args[0].device.type)
        return real_candidates(*args)

    with torch.no_grad():
        got = topk.topk_scores(ties, k, "exact")
        same(got, topk.stable_topk(ties, k), f"exact top-{k} on rounded scores vs stable_topk")
        check(bool((got[1][1] == torch.arange(k, device=dev)).all()),
              f"the all-zero row's top-{k} is {got[1][1].tolist()}")
        topk._threshold_candidates = counted_candidates
        try:
            for rows, x in (("signed", signed), ("boundary", edge)):
                card = {name: fn(x) for name, fn in paths.items()}
                cpu = {name: fn(x[:256].cpu()) for name, fn in paths.items()}
                for name in paths:
                    same(tuple(t[:256].cpu() for t in card[name]), cpu[name],
                         f"{name} top-{k} on the {rows} rows, card vs CPU")
                same(card["merge"], card["exact"], f"the merge vs exact on the {rows} rows")
                if rows == "signed":
                    same(card["exact"], topk.stable_topk(x, k), "exact vs stable_topk with −0.0")
                else:
                    same(card["threshold"], card["exact"], "threshold vs exact on the boundary")
                    check(bool(((card["exact"][0][:, k - 1] == 0)
                                & ~torch.signbit(card["exact"][0][:, k - 1])).all()),
                          "a boundary row's k-th score is not +0.0")
        finally:
            topk._threshold_candidates = real_candidates
    # threshold's whole-batch fallback on the signed rows; its candidate path on the boundary's
    check(candidates == ["cuda", "cpu"], f"threshold's candidate path ran on {candidates}")
    runs = topk_times(topk, raw, k)
    out = {"tied_rows_rounded": tied_rows(ties), "tied_rows_tie_free": tied_rows(raw),
           **{f"{n}_ms": float(np.mean(v)) for n, v in runs.items()}, "runs": runs}
    out["exact_over_topk"] = out["exact_ms"] / out["topk_ms"]
    log(f"[topk] at B {B} x m {m}, top-{k}: exact bitwise stable_topk's on 0.1-rounded scores "
        f"({out['tied_rows_rounded']} of {B} rows tied at the k-th value) and with −0.0 kept; "
        f"exact, threshold, approx and the one-rank merge bitwise the CPU's on those rows and "
        f"on ±0 boundary rows, threshold and the merge bitwise exact's; on tie-free scores "
        f"({out['tied_rows_tie_free']} rows tied) ms a call: "
        + ", ".join(f"{n} {out[n + '_ms']:.4f}" for n in TOPK_TURNS)
        + f" (exact {out['exact_over_topk']:.3f}x torch.topk; runs {runs})")
    return out


EXACT_TOPK_SHAPES = {"amazon-book-eval": (2048, 91599, 20), "gowalla-serve": (1, 40981, 20)}


def exact_topk_inputs(B: int, m: int, k: int, g: torch.Generator, dev) -> torch.Tensor:
    """(B, m) seeded normals with K1's −1e9 at a tenth of the columns, a row
    rounded to 0.1 (ties at the k-th value), a row of ±0.0 and one all
    −1e9 where B allows."""
    from gsrs_tpu_torch.ops.scoring import NEG_INF

    x = torch.randn(B, m, device=dev, generator=g)
    x[torch.rand(B, m, device=dev, generator=g) < 0.1] = NEG_INF
    if B >= 4:
        x[1] = torch.round(x[1] * 10) / 10
        x[2] = torch.where(torch.rand(m, device=dev, generator=g) < 0.5, -0.0, 0.0)
        x[3] = NEG_INF
    return x


def time_exact_topk(dev) -> dict:
    """The exact top-k kernel (``csrc/exact_topk.cu`` through
    `ops/topk.py::exact_topk`) at the two cells' shapes, one launch a call,
    bitwise `stable_topk`'s and its plain version's (`exact_topk_reference`)
    first, then device ms a call beside its byte bound (the scores read
    once), the plain version, the plain path the port took before the
    kernel (`torch.topk` of k + 1, the sorts and the tie read) and
    `torch.topk` of k (a yardstick the port never calls). At B = 1 the
    scores, 164 KB, stay in L2 between calls, as they do after K1 in a
    request."""
    from gsrs_tpu_torch.ops import topk

    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    out = {}
    for cell, (B, m, k) in EXACT_TOPK_SHAPES.items():
        x = exact_topk_inputs(B, m, k, g, dev)
        before = launch_counts()
        got = topk.exact_topk(x, k)
        check_launched(launches_since(before), "exact_topk", 1, f"exact_topk at {cell}'s shape")
        for name, want in (("stable_topk", topk.stable_topk(x, k)),
                           ("its plain version", topk.exact_topk_reference(x, k))):
            check(bitwise_equal(got[0], want[0]) and bitwise_equal(got[1], want[1]),
                  f"exact_topk at {cell}'s shape differs from {name}")
        b_ms, b_by = least_ms(0, 4 * B * m)
        t = {name: kernel_ms(fn, reps, f"exact_topk {cell} {name}") for name, fn, reps in (
            ("ms", lambda: topk.exact_topk(x, k), 50),
            ("plain_ms", lambda: topk.exact_topk_reference(x, k), 10),
            ("before_ms", lambda: topk._exact_topk_plain(x, k), 20),
            ("library_ms", lambda: torch.topk(x, k, dim=1), 50))}
        row = dict(shape=[B, m, k], bound_ms=b_ms, bound_by=b_by, roofline=b_ms / t["ms"]["ms"],
                   **t)
        log(f"[time] exact_topk at {cell}'s shape B={B} m={m} k={k}: "
            f"{t['ms']['ms'] * 1e3:.1f} us ({100 * row['roofline']:.1f}% of its bound "
            f"{b_ms * 1e3:.1f} us, {b_by}), plain {t['plain_ms']['ms'] * 1e3:.1f} us, the "
            f"path before {t['before_ms']['ms'] * 1e3:.1f} us, torch.topk "
            f"{t['library_ms']['ms'] * 1e3:.1f} us; bitwise stable_topk's and the plain "
            "version's")
        out[cell] = row
    return out


def exact_topk_entry(timed: dict, launches: dict) -> dict:
    """The exact top-k kernel's row of the ``{"kernels": ...}`` line: its
    times at the amazon-book eval batch (`time_exact_topk`), the Gowalla
    request's beside them, and its launches on the main paths, by phase."""
    row = timed["amazon-book-eval"]
    return dict(name="exact_topk", route="cuda", source=source("exact_topk"),
                replaces=REPLACES["exact_topk"], launches=sum(launches.values()),
                max_abs_err=0.0, ms=row["ms"]["ms"], plain_ms=row["plain_ms"]["ms"],
                before_ms=row["before_ms"]["ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"]["ms"],
                events_ms={k: row[k]["events_ms"]
                           for k in ("ms", "plain_ms", "before_ms", "library_ms")},
                shape=row["shape"], request=timed["gowalla-serve"],
                launches_by_phase=launches)


def gather_rows_inputs(cell: str, dev):
    """(ids, rows) of a training cell's table gathers: BERT4Rec's batch of
    256 sequences of 200 (27,700 PAD ids, 4,300 MASK ids, the rest Zipf
    1.1 over the 26,744 items) into 26,746 rows; Gowalla's BPR batch, the
    items' 131,072 Zipf 1.1 positives and 131,072 uniform negatives into
    40,981 rows, and its 131,072 users into 29,858."""
    rng = np.random.default_rng(SEED + 22)

    def zipf(n, rows, first=0):
        p = np.arange(1, rows - first + 1, dtype=np.float64) ** -1.1
        return first + rng.choice(rows - first, size=n, p=p / p.sum())

    if cell == "bert4rec-ml20m-train":
        rows = 26746
        ids = np.concatenate([np.zeros(27700, np.int64), np.full(4300, rows - 1),
                              zipf(51200 - 32000, rows - 1, first=1)])
        ids = rng.permutation(ids).reshape(256, 200)
    elif cell == "gowalla-train items":
        rows = 40981
        ids = np.concatenate([zipf(131072, rows), rng.integers(0, rows, 131072)])
    else:
        rows = 29858
        ids = rng.integers(0, rows, 131072)
    return torch.from_numpy(ids).to(dev), rows


def time_gather_rows_grad(dev) -> dict:
    """The table gathers' backward kernel (``csrc/gather_rows_grad.cu``
    through `ops/gather.py::gather_rows_grad`, the ids' sort included) at
    the training cells' shapes, d 64 fp32: one launch a call, within
    fp32's summation bound of a float64 ``index_add_``, two calls bitwise
    equal; then device ms a call beside its byte bound (each gradient
    row and id read once, each table row written once), its kernels apart
    (the sort's and the kernel's own), the plain version (``index_put_``
    with accumulation, the backward the port took before), and
    ``F.embedding``'s dense backward (a yardstick the port never
    calls)."""
    from torch.profiler import ProfilerActivity, profile

    from gsrs_tpu_torch.ops import gather

    out = {}
    for cell in ("bert4rec-ml20m-train", "gowalla-train items", "gowalla-train users"):
        ids, rows = gather_rows_inputs(cell, dev)
        d = 64
        g = torch.randn(*ids.shape, d, device=dev, generator=torch.Generator(dev).manual_seed(SEED))
        before = launch_counts()
        got = gather.gather_rows_grad(g, ids, rows)
        check_launched(launches_since(before), "gather_rows_grad", 1,
                       f"gather_rows_grad at {cell}'s shape")
        flat = ids.reshape(-1)
        ref = torch.zeros(rows, d, dtype=torch.float64, device=dev).index_add_(
            0, flat, g.reshape(-1, d).double())
        mag = torch.zeros_like(ref).index_add_(0, flat, g.reshape(-1, d).double().abs())
        count = torch.bincount(flat, minlength=rows).double()[:, None]
        err = (got.double() - ref).abs()
        check(bool((err <= (count + 1) * 2.0**-24 * mag).all()),
              f"gather_rows_grad at {cell}'s shape: off a float64 index_add_ by "
              f"{err.max().item():.3g}, past fp32's summation bound")
        check(bitwise_equal(got, gather.gather_rows_grad(g, ids, rows)),
              f"gather_rows_grad at {cell}'s shape: two calls differ")
        n = ids.numel()
        b_ms, b_by = least_ms(n * d, 4 * n * d + ids.element_size() * n + 4 * rows * d)
        t = {name: kernel_ms(fn, reps, f"gather_rows_grad {cell} {name}") for name, fn, reps in (
            ("ms", lambda: gather.gather_rows_grad(g, ids, rows), 50),
            ("plain_ms", lambda: gather.gather_rows_grad_plain(g, ids, rows), 10),
            ("library_ms", lambda: torch.ops.aten.embedding_dense_backward(
                g.reshape(-1, d), flat, rows, -1, False), 10))}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                gather.gather_rows_grad(g, ids, rows)
            torch.cuda.synchronize()
        parts = {key[:80]: us / 10 for key, us, _ in device_rows(prof)}
        row = dict(ids=n, rows=rows, d=d, bound_ms=b_ms, bound_by=b_by,
                   roofline=b_ms / t["ms"]["ms"], max_abs_err=err.max().item(),
                   kernels_us=parts, **t)
        log(f"[time] gather_rows_grad at {cell}'s shape ({n} ids into {rows} rows, d {d}): "
            f"{t['ms']['ms'] * 1e3:.1f} us ({100 * row['roofline']:.1f}% of its bound "
            f"{b_ms * 1e3:.1f} us, {b_by}), plain {t['plain_ms']['ms'] * 1e3:.1f} us, "
            f"F.embedding's backward {t['library_ms']['ms'] * 1e3:.1f} us; by kernel "
            f"{ {k: round(v, 1) for k, v in parts.items()} } us; max error "
            f"{row['max_abs_err']:.3g}, two calls bitwise equal")
        out[cell] = row
    return out


def gather_rows_entry(timed: dict, launches: dict) -> dict:
    """The gather kernel's row of the ``{"kernels": ...}`` line: its times
    at BERT4Rec's batch (`time_gather_rows_grad`), Gowalla's two tables
    beside them, and its launches on the main paths, by phase."""
    row = timed["bert4rec-ml20m-train"]
    return dict(name="gather_rows_grad", route="cuda", source=source("gather_rows_grad"),
                replaces=REPLACES["gather_rows_grad"], launches=sum(launches.values()),
                max_abs_err=row["max_abs_err"], ms=row["ms"]["ms"],
                plain_ms=row["plain_ms"]["ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"]["ms"],
                events_ms={k: row[k]["events_ms"] for k in ("ms", "plain_ms", "library_ms")},
                shape=[row["ids"], row["rows"], row["d"]],
                gowalla={k: v for k, v in timed.items() if k.startswith("gowalla")},
                launches_by_phase=launches)


# ------------------------------------------------------------ serving phase


def same_topk(items, plain_scores: torch.Tensor, ref_items, what: str) -> None:
    """Equal top-k ids, except swaps of items whose plain scores differ
    by less than SWAP_TOL."""
    items = torch.as_tensor(np.asarray(items), dtype=torch.int64, device=plain_scores.device)
    ref = torch.as_tensor(np.asarray(ref_items), dtype=torch.int64, device=plain_scores.device)
    diff = items != ref
    if bool(diff.any()):
        gap = (plain_scores.gather(1, items) - plain_scores.gather(1, ref)).abs()
        worst = float(gap[diff].max())
        check(worst < SWAP_TOL, f"{what}: top-k differs beyond ties (score gap {worst})")
        log(f"[serve] {what}: {int(diff.sum())} boundary swaps, gap ≤ {worst:.2e}")


def serving_phase(dev: torch.device, shape: dict, out_dir: str) -> dict:
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops import scoring
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference
    from gsrs_tpu_torch.serve import (
        Retriever, export_embeddings, load_retriever, retriever_from_model,
    )

    data = synthetic.powerlaw(shape["n_users"], shape["m_items"],
                              avg_degree=shape["avg_degree"], seed=SEED)
    users = np.random.default_rng(SEED).choice(data.n_users, BATCH * N_REQUESTS, replace=False)
    batches = [users[i * BATCH:(i + 1) * BATCH] for i in range(N_REQUESTS)]
    log(f"[serve] data {data.n_users} users x {data.m_items} items, {data.train_size} edges")

    # ---- the main path, counted: graph → model → propagation → retriever → requests
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    graph = build_graph(data)
    ell = ell_from_interactions(data)
    t_graph = time.perf_counter() - t0
    model = build_model(ModelConfig(num_layers=3, embedding_dim=64), graph, ell=ell,
                        device=dev, generator=torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    retriever = retriever_from_model(model, data, batch_size=BATCH, device=dev)
    torch.cuda.synchronize()
    t_retriever = time.perf_counter() - t0
    natural = [retriever.recommend(b, k=K) for b in batches]
    bitplane = Retriever(retriever.user_emb, retriever.item_emb, retriever.seen_bitset,
                         batch_size=BATCH, use_pallas_scoring="on", device=dev)
    planes = [bitplane.recommend(b, k=K) for b in batches]
    torch.cuda.synchronize()
    launches = launches_since(before)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[serve] graph+ELL build {t_graph:.3f} s, retriever_from_model {t_retriever:.3f} s, "
        f"launches {launches}")
    for name in scoring.LAUNCHES:
        check(launches[name] >= N_REQUESTS, f"{name} launched {launches[name]} times on the "
              "serving path")
    check_launched(launches, "exact_topk", 2 * N_REQUESTS,
                   "the serving path, natural and bit-plane")
    check(launches["ell_gather_reduce"] >= 2 * model.cfg.num_layers,
          "the propagation did not run through ell_gather_reduce")

    # ---- checks against the plain path on the card
    net = data.user_item_net
    ue, ie, seen = retriever._serve_tables
    for b, (items, scores), (bp_items, bp_scores) in zip(batches, natural, planes):
        check(items.shape == (BATCH, K) and np.isfinite(scores).all(), "bad result shape/values")
        check(bool(((items >= 0) & (items < data.m_items)).all()), "item id out of range")
        seen_hits = np.asarray(net[np.repeat(b, K), items.ravel()]).ravel()
        check(not seen_hits.any(), "a train positive was recommended")
        ids = torch.as_tensor(b, device=dev)
        plain = masked_scores_reference(ue[ids], ie, seen[ids])
        p_scores, p_items = torch.topk(plain, K, dim=1)
        check(np.allclose(scores, p_scores.cpu().numpy(), atol=ATOL), "top-k scores differ")
        same_topk(items, plain, p_items.cpu().numpy(), "natural vs plain")
        same_topk(bp_items, plain, items, "bit-plane vs natural")
        check(np.allclose(bp_scores, scores, atol=ATOL), "bit-plane scores differ")

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "smoke_emb.npz")
    export_embeddings(retriever, path)
    loaded = load_retriever(path, batch_size=BATCH, device=dev)
    for b, (items, scores) in zip(batches, natural):
        items2, scores2 = loaded.recommend(b, k=K)
        check(np.array_equal(items, items2) and np.array_equal(scores, scores2),
              "npz round trip changed the recommendations")
    q8 = os.path.join(out_dir, "smoke_emb_q8.npz")
    export_embeddings(retriever, q8, quantize="int8")
    rq = load_retriever(q8, batch_size=BATCH, device=dev)
    uq, iq, _ = rq._serve_tables
    ids = torch.as_tensor(batches[0], device=dev)
    raw = masked_scores_reference(uq[ids], iq, seen[ids])
    plain_q = torch.where(raw == scoring.NEG_INF, raw,
                          raw * rq.user_scale[ids][:, None] * rq.item_scale[None, :])
    q_items, _ = rq.recommend(batches[0], k=K)
    same_topk(q_items, plain_q, torch.topk(plain_q, K, dim=1).indices.cpu().numpy(),
              "int8 vs plain")
    log("[serve] checks passed: ids in range, no train positive, natural = plain, "
        "bit-plane = natural, npz round trip identical, int8 = plain")

    # ---- timing
    with torch.no_grad():
        prop_ms = cuda_ms(model.final_embeddings, reps=20, warmup=5)
    lat = []
    for i in range(30):
        t0 = time.perf_counter()
        retriever.recommend(batches[i % N_REQUESTS], k=K)
        lat.append(time.perf_counter() - t0)
    lat_p50_ms = 1e3 * float(np.median(lat[5:]))
    busy = profile_recommend(retriever, batches)

    d = ue.shape[1]
    u = ue[torch.as_tensor(batches[0], device=dev)].contiguous()
    rows = seen[torch.as_tensor(batches[0], device=dev)].contiguous()
    _, bp_items_t, bp_seen = bitplane._serve_tables
    bp_rows = bp_seen[torch.as_tensor(batches[0], device=dev)].contiguous()
    kernels = []
    for name, it, bits, flag in (
        ("masked_scores", ie, rows, False),
        ("masked_scores_bitplane", bp_items_t, bp_rows, True),
    ):
        t = {k: kernel_ms(fn, reps, f"{name} {k}", warmup=10) for k, fn, reps in (
            ("ms", lambda: scoring.masked_scores(u, it, bits, bitplane=flag), 200),
            ("plain_ms", lambda: masked_scores_reference(u, it, bits, bitplane=flag), 50),
            ("library_ms", lambda: torch.matmul(u, it.T), 200))}
        ms, plain_ms, library_ms = (t[k]["ms"] for k in ("ms", "plain_ms", "library_ms"))
        b_ms, b_by = k1_least_ms(u.shape[0], d, it.shape[0], bits.shape[1])
        kernels.append(dict(
            name=name, route="cuda", source=source("masked_scores"), replaces=REPLACES[name],
            launches=launches[name], max_abs_err=None, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            events_ms={k: v["events_ms"] for k, v in t.items()},
            shape=[int(u.shape[0]), int(d), int(it.shape[0])],
        ))
        log(f"[time] {name}: {ms * 1e3:.1f} us/launch (device), bound {b_ms * 1e3:.1f} us "
            f"({b_by}), plain {plain_ms * 1e3:.1f} us, torch.matmul {library_ms * 1e3:.1f} us")
    u_eval = ue[:2048].contiguous()
    bits_eval = seen[:2048].contiguous()
    eval_ms = kernel_ms(lambda: scoring.masked_scores(u_eval, ie, bits_eval), 50,
                        "masked_scores B=2048")["ms"]
    eval_lib_ms = kernel_ms(lambda: torch.matmul(u_eval, ie.T), 50, "torch.matmul B=2048")["ms"]
    b_ms, b_by = k1_least_ms(2048, d, ie.shape[0], bits_eval.shape[1])
    log(f"[time] masked_scores at the eval batch (2048 users): {eval_ms * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.1f} us ({b_by}), torch.matmul {eval_lib_ms * 1e3:.1f} us")
    kernels[0]["eval_batch"] = dict(B=2048, ms=eval_ms, bound_ms=b_ms, library_ms=eval_lib_ms)
    log(f"[time] propagation (final_embeddings, 3 layers) {prop_ms:.3f} ms; "
        f"recommend p50 {lat_p50_ms:.3f} ms for {BATCH} users; peak device memory "
        f"{peak_mib:.1f} MiB")
    return dict(kernels=kernels, prop_ms=prop_ms, recommend_p50_ms=lat_p50_ms,
                peak_mib=peak_mib, recommend_device_busy=busy, launches=launches)


def profile_recommend(retriever, batches, rounds: int = 5) -> Optional[float]:
    """Device busy share of ``recommend`` (device time of all kernels and
    copies over the wall time of the window), with the kernels that take
    it (`device_rows`)."""
    from torch.profiler import ProfilerActivity, profile

    retriever.recommend(batches[0], k=K)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            for b in batches:
                retriever.recommend(b, k=K)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    calls = rounds * len(batches)
    rows = device_rows(prof)
    device_us = sum(t for _, t, _ in rows)
    if not device_us:
        log("[profile] the profiler saw no device time: busy share not measured")
        return None
    log(f"[profile] recommend: {wall_us / calls:.1f} us wall, {device_us / calls:.1f} us "
        f"device per request of {BATCH} users (busy share {device_us / wall_us:.3f})")
    for key, t, _ in sorted(rows, key=lambda r: -r[1])[:6]:
        log(f"[profile]   {t / calls:8.1f} us/request  {key[:90]}")
    return device_us / wall_us


# ------------------------------------------------------ K3 and K4 on the card


def training_data():
    from gsrs_tpu_torch.data import synthetic

    return synthetic.powerlaw(GOWALLA_SHAPE["n_users"], GOWALLA_SHAPE["m_items"],
                              avg_degree=GOWALLA_SHAPE["avg_degree"], seed=SEED,
                              holdout_frac=0.2)


def ell_side_check(table, x, mask, what: str, slots: int = 1 << 22) -> float:
    """K4 on one side's BucketTable against the plain version, bucket by
    bucket (a large bucket in chunks of rows, so that the plain version's
    gathered rows stay near ``slots`` a chunk), the weights (w · mask)
    rounded to x's dtype as the kernel and the JAX einsum round them,
    summed in fp32 → max abs error (fp32) or max error over the allowed
    error (bf16)."""
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce, gather_reduce_reference

    got = gather_reduce(table, x, mask)
    torch.cuda.synchronize()
    check(got.dtype == x.dtype, f"{what}: output dtype {got.dtype}")
    row0, worst = 0, 0.0
    x32 = x.float()
    for cols, w, eidx in table.buckets:
        n_b = cols.shape[0]
        wm = w if mask is None else w * mask[eidx]
        step = max(1, slots // max(1, cols.shape[1]))
        for lo in range(0, n_b, step):
            hi = min(n_b, lo + step)
            want = gather_reduce_reference(cols[lo:hi], wm[lo:hi].to(x.dtype).float(), x32)
            err = (got[row0 + lo:row0 + hi].float() - want).abs()
            if x.dtype == torch.float32:
                worst = max(worst, float(err.max()))
            else:
                worst = max(worst, float((err / (ELL_BF16_RTOL * want.abs()
                                                 + ELL_BF16_ATOL)).max()))
        row0 += n_b
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    if x.dtype == torch.float32:
        check(worst <= ELL_ATOL, f"{what}: max abs error {worst} > {ELL_ATOL}")
    else:
        check(worst <= 1.0, f"{what}: error {worst}x the bf16 limit")
    return worst


def ell_variants(table, x, mask, what: str) -> float:
    """ell_side_check in fp32 and bf16, with and without the mask (if one
    is given) → max fp32 abs error."""
    err32 = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for m in (None,) if mask is None else (None, mask):
            label = f"{what} {str(dtype)[6:]} {'masked' if m is not None else 'unmasked'}"
            err = ell_side_check(table, x.to(dtype), m, label)
            log(f"[kernel] {label}: max {'abs err' if dtype == torch.float32 else 'err/limit'}"
                f" {err:.3e}")
            if dtype == torch.float32:
                err32 = max(err32, err)
    return err32


def split_row_checks(dev) -> None:
    """K4 where the work list splits rows: a hub row of 140,000 slots that
    crosses max_width (65,536) twice, so the layout adds two overflow
    chunks into it, one chunk level after the other (its extra_levels),
    and rows of exactly S, S + 1 and 2S real slots beside one that is
    padding after slot 1 (S = SPLIT_SLOTS). The hub side's apply on the
    card is held against the CPU and must repeat bit for bit."""
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights
    from gsrs_tpu_torch.ops.ell import _apply_side, build_ell_graph
    from gsrs_tpu_torch.ops.ell_kernel import SPLIT_SLOTS, BucketTable

    n, m = 140_000, 40
    rng = np.random.default_rng(SEED)
    pairs = np.unique(np.stack([np.concatenate([np.arange(n), rng.integers(0, n, 20_000)]),
                                np.concatenate([np.zeros(n, np.int64),
                                                rng.integers(1, m, 20_000)])], 1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    w = normalized_edge_weights(users, items, np.bincount(users, minlength=n),
                                np.bincount(items, minlength=m))
    graph = build_ell_graph(users.astype(np.int32), items.astype(np.int32), w, n, m)
    levels = len(graph.by_item.extra_levels)
    check(levels >= 2, f"the hub row has {levels} overflow chunk levels, not 2")
    side = graph.to(dev).by_item
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(n, 64, device=dev, generator=g) / 4
    mask = (torch.rand(users.size, device=dev, generator=g) < 0.6).float() / 0.6
    n_split = sum(work.splits.shape[0] for _, work in side.table._tables)
    check(n_split >= 3, f"the hub side split {n_split} rows")
    ell_variants(side.table, x, mask, f"ell_gather_reduce hub side ({n_split} split rows)")
    for dtype in (torch.float32, torch.bfloat16):
        first, second = (_apply_side(side, x.to(dtype), mask) for _ in range(2))
        torch.cuda.synchronize()
        check(torch.equal(first, second), f"hub side {dtype}: two applies differ")
    got = _apply_side(side, x, mask).cpu()
    want = _apply_side(graph.by_item, x.cpu(), mask.cpu())
    err = float((got - want).abs().max())
    check(err <= ELL_ATOL, f"hub side through its overflow chunks: card vs CPU {err}")
    log(f"[kernel] ell hub row of {int(np.bincount(items)[0])} slots, {levels + 1} chunks added "
        f"in order (fp32, masked): card vs CPU max abs err {err:.3e}; two applies bitwise equal "
        "(fp32 and bf16)")

    S, width = SPLIT_SLOTS, 2 * SPLIT_SLOTS + 64
    lengths = (S, S + 1, 2 * S, 1)
    cols = torch.randint(0, 3000, (len(lengths), width), device=dev, generator=g,
                         dtype=torch.int32)
    wt = (torch.rand(len(lengths), width, device=dev, generator=g) + 0.1) / width**0.5
    eidx = torch.randint(0, 5000, (len(lengths), width), device=dev, generator=g,
                         dtype=torch.int32)
    for r, length in enumerate(lengths):
        cols[r, length:], wt[r, length:], eidx[r, length:] = 0, 0.0, 0
    table = BucketTable([(cols, wt, eidx)])
    n_split = sum(work.splits.shape[0] for _, work in table._tables)
    check(n_split == 2, f"rows of S + 1 and 2S slots: {n_split} split rows")
    mask = (torch.rand(5000, device=dev, generator=g) < 0.6).float() / 0.6
    ell_variants(table, torch.randn(3000, 64, device=dev, generator=g), mask,
                 f"ell_gather_reduce rows of {lengths} real slots (S = {S})")


def determinism_check(side, x, mask) -> None:
    """Two calls on the same inputs are bitwise equal (no atomics; split
    rows' partials are added in chunk order)."""
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce

    for dtype in (torch.float32, torch.bfloat16):
        first = gather_reduce(side.table, x.to(dtype), mask)
        second = gather_reduce(side.table, x.to(dtype), mask)
        torch.cuda.synchronize()
        check(torch.equal(first, second), f"ell_gather_reduce {dtype}: two calls differ")
    log("[kernel] ell_gather_reduce by_item: two calls bitwise equal (fp32 and bf16, masked)")


def probe_check(dev) -> None:
    """K4 at the TPU probe's default shape (N=65,536, D=64, M=262,144,
    B=256, the probe's seeds) with w = 1 and cols = idx.reshape(M/B, B),
    summed over d, against the probe's oracle np.add.reduceat. rtol 1e-4
    as the probe; atol 1e-3 (1e-5 of the sums' scale of ~128) for the few
    sums that land near 0, where the order of summation decides."""
    from gsrs_tpu_torch.ops.ell_kernel import BucketTable, gather_reduce

    N, D, M, B = 1 << 16, 64, 1 << 18, 256
    x = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    idx = np.random.default_rng(1).integers(0, N, M).astype(np.int32)
    cols = torch.from_numpy(idx.reshape(M // B, B)).to(dev)
    table = BucketTable([(cols, torch.ones(M // B, B, device=dev),
                          torch.zeros(M // B, B, dtype=torch.int32, device=dev))])
    xt = torch.from_numpy(x).to(dev)
    out = gather_reduce(table, xt).sum(dim=1).cpu().numpy()
    ref = np.add.reduceat(x[idx].sum(axis=1), np.arange(0, M, B))
    check(np.allclose(out, ref, rtol=1e-4, atol=1e-3), "probe shape: kernel != probe oracle")
    us = 1e3 * kernel_ms(lambda: gather_reduce(table, xt), 50, "ell_gather_reduce probe")["ms"]
    log(f"[kernel] ell_gather_reduce at the probe's shape: matches np.add.reduceat "
        f"(max rel err {float(np.max(np.abs(out - ref) / np.maximum(np.abs(ref), 1))):.2e}); "
        f"{us:.1f} us/launch, {M / us:.0f} M gathered rows/s")


def ngcf_leaf_shapes(graph, ell, dev) -> list:
    """The leaf shapes of an NGCF step at full width, read from the port's
    NGCF (3 layers of 64) on ``graph``: the two tables, then W1, W2, b1, b2
    a layer, 14 in all."""
    from gsrs_tpu_torch.config import ModelConfig
    from gsrs_tpu_torch.models.registry import build_model

    model = build_model(ModelConfig(model="ngcf", num_layers=3, embedding_dim=64), graph, ell=ell,
                        device=dev, generator=torch.Generator().manual_seed(SEED))
    return [tuple(p.shape) for p in model.parameters()]


def adam_table_check(dev, what: str, spec, g, missing=None, offset=()) -> float:
    """K3 over the leaves ``spec`` [(shape, dtype)] against its plain
    version (``backend="jnp"``) on the same card tensors: 3 steps across an
    lr milestone through `FusedAdam.step`; leaf ``missing`` has no gradient
    at steps 2 and 3, and the leaves ``offset`` are views at storage offset
    1. Every parameter and moment must equal the plain version's bit for
    bit, and the kernel must launch ⌈leaves/64⌉ times a step → the max abs
    error over the fp32 leaves (0)."""
    from gsrs_tpu_torch.config import TrainConfig
    from gsrs_tpu_torch.train.fused_adam import LAUNCHES, MAX_LEAVES, FusedAdam
    from gsrs_tpu_torch.train.optim import lr_schedule

    sched = lr_schedule(TrainConfig(lr=1e-2, use_scheduler=True, sched_milestones=(2,),
                                    sched_gamma=0.5), 1)
    p0 = [(0.1 * torch.randn(s, device=dev, generator=g)).to(dt) for s, dt in spec]
    grads = [[torch.randn(s, device=dev, generator=g).to(dt) for s, dt in spec]
             for _ in range(3)]
    runs = []
    for backend in ("pallas", "jnp"):
        params = {}
        for i, p in enumerate(p0):
            q = p.clone()
            if i in offset:
                base = torch.empty(p.numel() + 1, dtype=p.dtype, device=dev)
                base[1:] = p.flatten()
                q = base[1:].view(p.shape)
                check(q.data_ptr() % 16 != 0, f"fused_adam {what}: leaf {i} is aligned")
            params[f"leaf{i}"] = torch.nn.Parameter(q)
        opt = FusedAdam(schedule=sched, backend=backend)
        st = opt.init(params)
        before = LAUNCHES["fused_adam"]
        for step, gr in enumerate(grads):
            for i, p in enumerate(params.values()):
                p.grad = None if (i == missing and step > 0) else gr[i].clone()
            st = opt.step(params, st)
        torch.cuda.synchronize()
        runs.append(([t for k, p in params.items() for t in (p.detach(), st.mu[k], st.nu[k])],
                     LAUNCHES["fused_adam"] - before))
    (got, launched), (want, plain_launched) = runs
    per_step = -(-len(spec) // MAX_LEAVES)
    check(launched == 3 * per_step and plain_launched == 0,
          f"fused_adam {what}: {launched} launches in 3 steps, not {3 * per_step}")
    dts = [dt for _, dt in spec for _ in range(3)]  # of p, m and v of each leaf
    check(all(a.dtype == b.dtype == dt for a, b, dt in zip(got, want, dts)),
          f"fused_adam {what}: dtypes differ")
    errs = {dt: max((float((a.float() - b.float()).abs().max())
                     for a, b, d in zip(got, want, dts) if d == dt), default=0.0)
            for dt in (torch.float32, torch.bfloat16)}
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    check(equal, f"fused_adam {what}: not bitwise the plain version's (max abs err fp32 "
          f"{errs[torch.float32]:.3e}, bf16 {errs[torch.bfloat16]:.3e})")
    log(f"[kernel] fused_adam {what}: {len(spec)} leaves, {per_step} launch(es) a step, 3 "
        f"steps across a milestone: parameters and moments bit for bit the plain version's "
        f"(max abs err fp32 {errs[torch.float32]:.1e}, bf16 {errs[torch.bfloat16]:.1e})")
    return errs[torch.float32]


def kernel_phase_train(dev, data) -> dict:
    """K4 and K3 against their plain versions on the card → {kernel: max
    abs err in fp32 at the main path's shapes}."""
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.ops.ell import ell_from_interactions

    ell = ell_from_interactions(data).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    tables = {"user": torch.randn(data.n_users, 64, device=dev, generator=g),
              "item": torch.randn(data.m_items, 64, device=dev, generator=g)}
    n_edges = data.train_size
    mask = (torch.rand(n_edges, device=dev, generator=g) < 0.6).float() / 0.6
    ell_err = 0.0
    for side_name, side, x in (("by_user", ell.by_user, tables["item"]),
                               ("by_item", ell.by_item, tables["user"])):
        n_split = sum(work.splits.shape[0] for _, work in side.table._tables)
        ell_err = max(ell_err, ell_variants(
            side.table, x, mask, f"ell_gather_reduce {side_name} {len(side.buckets)} buckets, "
            f"{n_split} split rows"))
    determinism_check(ell.by_item, tables["user"], mask)
    split_row_checks(dev)
    probe_check(dev)

    adam_err = 0.0
    for shape in ((37, 11), (data.n_users, 64), (data.m_items, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            err = adam_table_check(dev, f"{shape} {str(dtype)[6:]}", [(shape, dtype)], g)
            if dtype == torch.float32 and shape[1] == 64:
                adam_err = max(adam_err, err)
    ngcf = ngcf_leaf_shapes(build_graph(data), ell, dev)
    for dtype in (torch.float32, torch.bfloat16):
        adam_table_check(dev, f"NGCF's 14 leaves {str(dtype)[6:]}", [(s, dtype) for s in ngcf], g)
    mixed = [(s, (torch.float32, torch.bfloat16)[i % 2]) for i, s in enumerate(ngcf)]
    adam_table_check(dev, "NGCF's 14 leaves fp32/bf16 mixed, (37, 11) bf16, leaf 3 without "
                     "gradient at steps 2-3", mixed + [((37, 11), torch.bfloat16)], g,
                     missing=3)
    adam_table_check(dev, "views at storage offset 1 (scalar path) beside aligned leaves",
                     [((37, 11), torch.float32), ((64, 64), torch.float32),
                      ((37, 11), torch.bfloat16), ((4099,), torch.bfloat16)], g, offset=(0, 2))
    adam_table_check(dev, "70 leaves (two launches)",
                     [((i % 9 + 1, 5 + i % 4), (torch.float32, torch.bfloat16)[i % 3 == 0])
                      for i in range(70)], g)
    return {"ell_gather_reduce": ell_err, "fused_adam": adam_err}


# ----------------------------------------------------------- training phase


def make_trainer(dev, data, graph, ell, batch: int, fused: str, model=None):
    from gsrs_tpu_torch.config import EvalConfig, ExperimentConfig, ModelConfig, TrainConfig
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    cfg = ExperimentConfig(model=ModelConfig(num_layers=3, embedding_dim=64),
                           train=TrainConfig(batch_size=batch, fused_adam=fused, seed=SEED),
                           eval=EvalConfig(topks=(20,)))
    if model is None:
        model = build_model(cfg.model, graph, ell=ell, device=dev,
                            generator=torch.Generator().manual_seed(SEED))
    return Trainer(cfg, data, graph, model, device=dev)


def timed_steps(trainer, state, steps: int):
    """``steps`` steps through train_epoch → (state, ms per step, loss)."""
    trainer.epoch_samples = steps * trainer.cfg.train.batch_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = trainer.train_epoch(state)  # reads the loss: ends synchronized
    return state, 1e3 * (time.perf_counter() - t0) / steps, loss


def training_phase(dev, data) -> dict:
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.ops.ell import ell_from_interactions

    graph, ell = build_graph(data), ell_from_interactions(data)
    log(f"[train] data {data.n_users} users x {data.m_items} items, {data.train_size} train "
        f"edges, {len(data.test_dict)} test users")
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    model = None
    trainers, states = {}, {}
    steps_run = 0
    configs = ((2048, "off"), (2048, "pallas"), (8192, "off"), (8192, "pallas"))
    for batch, fused in configs:  # warm-up: 3 steps each
        tr = trainers[(batch, fused)] = make_trainer(dev, data, graph, ell, batch, fused, model)
        model = tr.model
        states[(batch, fused)], _, _ = timed_steps(tr, tr.init_state(), 3)
        steps_run += 3
    # 20 timed steps per config, in turns: forward order, then backward
    ms = {c: [] for c in configs[:3]}
    for c in configs[:3] + configs[2::-1]:
        tr = trainers[c]  # all four share one model, so its parameters keep training
        states[c], t, loss = timed_steps(tr, states[c], 20)
        ms[c].append(t)
        steps_run += 20
        check(np.isfinite(loss), f"loss {loss} at batch {c[0]} {c[1]}")
    for (batch, fused), ts in ms.items():
        log(f"[train] batch {batch} fused_adam={fused}: {ts[0]:.3f} / {ts[1]:.3f} ms/step over "
            f"20 steps (two turns)")
    tr = trainers[(8192, "pallas")]
    tr.epoch_samples = None  # a full epoch: train_size triplets
    state = tr.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss0 = tr.train_epoch(state)
    epoch_s = time.perf_counter() - t0
    steps_run += tr.steps_per_epoch
    state, loss1 = tr.train_epoch(state)
    steps_run += tr.steps_per_epoch
    ms[(8192, "pallas")] = [1e3 * epoch_s / tr.steps_per_epoch]
    launches = launches_since(before)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    log(f"[train] batch 8192 fused_adam=pallas: one epoch of {tr.steps_per_epoch} steps in "
        f"{epoch_s:.3f} s ({ms[(8192, 'pallas')][0]:.3f} ms/step); epoch losses {loss0:.5f} -> "
        f"{loss1:.5f}; {steps_run} steps on the path; launches {launches}")
    check(np.isfinite(loss0) and loss1 < loss0, f"epoch losses {loss0} -> {loss1} do not fall")
    check(launches["ell_gather_reduce"] >= 12 * steps_run,
          f"ell_gather_reduce launched {launches['ell_gather_reduce']} times in {steps_run} steps")
    check_launched(launches, "gather_rows_grad", bpr_gathers(tr.model) * steps_run,
                   "the training phase")
    # K3 once a step (⌈leaves/64⌉ launches) in the "pallas" steps: 3 warm-up and 2 x 20 timed
    # at 2048, 3 warm-up and two epochs at 8192
    pallas_steps = 2 * 3 + 2 * 20 + 2 * tr.steps_per_epoch
    per_step = adam_launches_per_step(tr.model)
    check(launches["fused_adam"] == per_step * pallas_steps,
          f"fused_adam launched {launches['fused_adam']} times in {pallas_steps} steps, not "
          f"{per_step} a step")
    return dict(data=data, graph=graph, ell=ell, trainer=tr, state=state, ms=ms,
                epoch_s=epoch_s, launches=launches, steps=steps_run, peak_mib=peak_mib)


def card_vs_cpu_phase(dev, train: dict) -> None:
    """One seeded model and optimizer state on the card and on the CPU,
    the same 3 triplet batches through run_steps (kernels on the card,
    plain versions on the CPU)."""
    from gsrs_tpu_torch.ops.sampling import sample_epoch

    data, graph, ell = train["data"], train["graph"], train["ell"]
    runs = []
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    batches = [t.cpu() for t in sample_epoch(g, train["trainer"].sampler_state, 3 * 2048, 2048)]
    for device in (dev, torch.device("cpu")):
        tr = make_trainer(device, data, graph, ell, 2048, "pallas")
        state = tr.init_state()
        t0 = time.perf_counter()
        state, losses = tr.run_steps(state, *batches)
        losses = losses.cpu()
        runs.append((losses, {k: v.detach().cpu() for k, v in state.params.items()}))
        log(f"[train] 3 run_steps on {device}: losses {losses.tolist()} "
            f"({time.perf_counter() - t0:.2f} s)")
    (l_card, p_card), (l_cpu, p_cpu) = runs
    loss_err = float((l_card - l_cpu).abs().max())
    param_err = max(float((p_card[k] - p_cpu[k]).abs().max()) for k in p_cpu)
    check(loss_err <= TRAIN_ATOL, f"card vs CPU losses differ by {loss_err}")
    check(param_err <= TRAIN_ATOL, f"card vs CPU parameters differ by {param_err}")
    log(f"[train] card vs CPU after 3 steps: max loss diff {loss_err:.2e}, max parameter diff "
        f"{param_err:.2e} (limit {TRAIN_ATOL})")


def eval_phase(dev, train: dict) -> dict:
    """Trainer.evaluate on the card (counted), then the CPU from the same
    parameters: the trained ones, and the seeded initial ones with top-2000
    as well as top-20. This data holds out each user's least popular item,
    which a model that ranks by popularity never puts in its top-20, so
    the trained metrics are 0; at the initial parameters the top-2000 hits
    many held-out items, and card and CPU must find the same ones."""
    from gsrs_tpu_torch.config import EvalConfig
    from gsrs_tpu_torch.train.evaluator import Evaluator

    tr, state = train["trainer"], train["state"]
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = tr.evaluate(state)
    eval_s = time.perf_counter() - t0
    launches = launches_since(before)
    check(launches["masked_scores"] >= 1, "the eval did not score through masked_scores")
    check(launches["ell_gather_reduce"] >= 2 * 3, "the eval did not propagate through K4")
    check_launched(launches, "exact_topk", tr.evaluator._users.shape[0], "the eval")
    t0 = time.perf_counter()
    tr.evaluate(state)
    eval2_s = time.perf_counter() - t0
    args = (train["data"], train["graph"], train["ell"], 8192, "pallas")
    k_wide = min(2000, train["data"].m_items // 2)
    wide = EvalConfig(topks=(20, k_wide))
    models = [make_trainer(d, *args).model for d in (dev, torch.device("cpu"))]
    pairs = {"initial": tuple(Evaluator(train["data"], m, wide, device=m.user_emb.device).run()
                              for m in models)}
    cpu_tr = make_trainer(torch.device("cpu"), *args)
    cpu_tr.model.load_state_dict({k: v.cpu() for k, v in tr.model.state_dict().items()})
    pairs["trained"] = (card, cpu_tr.evaluator.run())
    for what, (on_card, on_cpu) in pairs.items():
        check(set(on_card) == set(on_cpu), "metric names differ")
        check(all(np.isfinite(v) for v in on_card.values()), "non-finite metrics")
        worst = max(abs(on_card[k] - on_cpu[k]) for k in on_card)
        check(worst <= METRIC_ATOL, f"{what}: card vs CPU metrics differ by {worst}: "
              f"{on_card} vs {on_cpu}")
        log(f"[eval] {what} parameters: card {on_card}; CPU {on_cpu}; max diff {worst:.2e}")
    check(pairs["initial"][0][f"recall@{k_wide}"] > 0,
          "no hit at all: the comparison shows nothing")
    log(f"[eval] Trainer.evaluate {eval_s:.3f} s first, {eval2_s:.3f} s warm; "
        f"launches {launches}")
    return dict(metrics=card, eval_s=eval2_s, launches=launches)


def hits_card_vs_cpu(trainer, state, floor: float) -> dict:
    """`eval_phase`'s comparison on the hits run, where a trained model
    hits: `Trainer.evaluate` on the card and a CPU Evaluator from the same
    parameters within METRIC_ATOL, recall@20 at least ``floor``, and every
    test user's top-20 ids equal on both, boundary swaps aside."""
    from gsrs_tpu_torch import cli
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference
    from gsrs_tpu_torch.train.evaluator import Evaluator

    data, model, cpu = trainer.data, trainer.model, torch.device("cpu")
    card = trainer.evaluate(state)
    cpu_model = build_model(trainer.cfg.model, trainer.graph, None,
                            cli.layout_from_interactions(trainer.cfg.model, data), device=cpu)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_ev = Evaluator(data, cpu_model, trainer.cfg.eval, device=cpu)
    on_cpu = cpu_ev.run()
    check(set(card) == set(on_cpu), "metric names differ")
    worst = max(abs(card[k] - on_cpu[k]) for k in card)
    check(worst <= METRIC_ATOL, f"hits: card vs CPU metrics differ by {worst}: {card} vs {on_cpu}")
    check(card[f"recall@{K}"] >= floor, f"hits: recall@{K} {card[f'recall@{K}']} < floor {floor}")
    users = torch.from_numpy(data.test_users()).to(model.user_emb.device)
    with torch.no_grad():
        all_users, items, _ = model.final_embeddings()
        plain = masked_scores_reference(all_users[users], items,
                                        trainer.sampler_state.train_bitset[users])
        same_topk(trainer.evaluator.top_items().cpu(), plain, cpu_ev.top_items(),
                  f"hits card vs CPU top-{K} of {users.numel()} test users")
    log(f"[hits] card {card}; CPU {on_cpu}; max diff {worst:.2e}; every test user's top-{K} ids "
        "equal, boundary swaps aside")
    return dict(card=card, cpu=on_cpu, max_diff=worst, plain_scores=plain)


def drive_phase(dev) -> dict:
    from gsrs_tpu_torch.drive import drive

    t0 = time.perf_counter()
    out = drive(dev)
    log(f"[drive] {out} ({time.perf_counter() - t0:.2f} s)")
    check(out["loss_last"] < 0.1, f"drive loss {out['loss_last']} >= 0.1")
    check(out["bad_triplets"] == 0, "the drive sampled invalid triplets")
    check(out["leaked_positives"] == 0, "a train positive reached the drive's top-20")
    check(out["recall20"] > 0.3, f"drive recall@20 {out['recall20']} <= 0.3")
    return out


# ----------------------------------------------------------------- timings


def side_csr(side, n_src: int):
    """The side's W as a CSR matrix (n_rows × n_src) over its real edges."""
    rows, cols, vals = [], [], []
    for b in side.buckets:
        keep = b.w != 0
        rows.append(b.rows.long()[:, None].expand_as(b.cols)[keep])
        cols.append(b.cols.long()[keep])
        vals.append(b.w[keep])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (side.n_rows, n_src),
                                  check_invariants=True).coalesce()
    return coo.to_sparse_csr()


def sparse_mm(side, x, what: str) -> dict:
    """``torch.sparse.mm`` on the side as CSR (its real edges) times ``x``,
    by device time: the library call beside K4 on that side. Where the
    library has no kernel for the side's dtype (bf16 CSR), it runs on the
    fp32 copies of the same weights and ``x``, and says so →
    {"library_ms", "library_dtype"}."""
    csr = side_csr(side, x.shape[0])
    try:
        torch.sparse.mm(csr, x)
    except RuntimeError as e:
        log(f"[time] torch.sparse.mm on {what} in {x.dtype}: {str(e).splitlines()[0]}; timed in "
            "float32")
        csr, x = csr.to(torch.float32), x.float()
    t = kernel_ms(lambda: torch.sparse.mm(csr, x), 50, f"torch.sparse.mm {what}")
    return dict(library_ms=t["ms"], library_dtype=str(x.dtype).replace("torch.", ""))


def time_ell_side(name: str, table, x, csr) -> dict:
    """K4 on one side's table by device time, beside its bound over its
    real edges (the bound counting every padding slot too), its plain
    version and ``torch.sparse.mm`` on the side as CSR."""
    from gsrs_tpu_torch.ops.ell_kernel import SPLIT_SLOTS, gather_reduce, gather_reduce_reference

    d = x.shape[1]
    out = torch.empty(table.n_rows + 1, d, device=x.device, dtype=x.dtype)

    def plain():
        row0 = 0
        for cols, w, eidx in table.buckets:
            out[row0:row0 + cols.shape[0]] = gather_reduce_reference(cols, w, x)
            row0 += cols.shape[0]

    slots = sum(c.numel() for c, _, _ in table.buckets)
    nnz = csr.values().numel()
    b_ms, b_by = k4_least_ms(nnz, x, table.n_rows)
    b_slots_ms, _ = k4_least_ms(slots, x, table.n_rows)
    n_split = sum(work.splits.shape[0] for _, work in table._tables)
    timed = {k: kernel_ms(fn, reps, f"ell_gather_reduce {name} {k}", warmup)
             for k, fn, reps, warmup in (
                 ("ms", lambda: gather_reduce(table, x, out=out), 200, 100),
                 ("plain_ms", plain, 10, 5),
                 ("library_ms", lambda: torch.sparse.mm(csr, x), 50, 5))}
    t = dict({k: v["ms"] for k, v in timed.items()}, bound_ms=b_ms)
    log(f"[time] ell_gather_reduce {name}: {len(table.buckets)} buckets, {slots} slots "
        f"({nnz} edges, {n_split} rows split at S = {SPLIT_SLOTS}), "
        f"{t['ms'] * 1e3:.1f} us/call, bound {b_ms * 1e3:.2f} us ({b_by}; "
        f"{b_slots_ms * 1e3:.2f} us counting every slot), plain "
        f"{t['plain_ms'] * 1e3:.1f} us, torch.sparse.mm (CSR) "
        f"{t['library_ms'] * 1e3:.1f} us")
    return dict(t, bound_by=b_by, slots=slots, edges=nnz, split_rows=n_split,
                bound_ms_all_slots=b_slots_ms,
                events_ms={k: v["events_ms"] for k, v in timed.items()})


def time_ell(model, launches: int, per_step: float, err: float) -> dict:
    """K4 per call, averaged over the two sides of a forward layer at the
    trained model's tables (`time_ell_side`), and the by_item side at
    other split lengths S."""
    from gsrs_tpu_torch.ops.ell_kernel import BucketTable, gather_reduce

    d = model.cfg.embedding_dim
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    bound_by, sides = set(), {}
    todo = [(name, side, x, side_csr(side, x.shape[0])) for name, side, x in (
        ("by_user", model.ell.by_user, model.item_emb.detach()),
        ("by_item", model.ell.by_item, model.user_emb.detach()))]  # host work before any timing
    with torch.no_grad():
        for name, side, x, csr in todo:
            sides[name] = time_ell_side(name, side.table, x, csr)
            bound_by.add(sides[name]["bound_by"])
            for k in tot:
                tot[k] += sides[name][k] / 2
        side, x = model.ell.by_item, model.user_emb.detach()
        buckets = side.table.buckets
        out = torch.empty(side.table.n_rows + 1, d, device=x.device)
        sweep = {}
        for split in (64, 128, 256, 512, 1024):
            table = BucketTable(buckets, split=split)
            sweep[split] = kernel_ms(lambda: gather_reduce(table, x, out=out), 200,
                                     f"ell_gather_reduce by_item S={split}", warmup=100)["ms"]
        log("[time] ell_gather_reduce by_item at split length S: " + ", ".join(
            f"S={k} {v * 1e3:.1f} us" for k, v in sweep.items()))
    return dict(name="ell_gather_reduce", route="cuda", source=source("ell_gather_reduce"),
                replaces=REPLACES["ell_gather_reduce"], launches=launches, max_abs_err=err,
                bound_by="/".join(sorted(bound_by)), launches_per_step=per_step,
                shape=[int(model.n_users), int(model.m_items), d], sides=sides,
                by_item_ms_at_split={str(k): v for k, v in sweep.items()}, **tot)


def time_adam_leaves(dev, what: str, spec) -> dict:
    """K3 over the leaves ``spec`` [(shape, dtype)] of a step through
    `FusedAdam.step`, one launch, by device and host time
    (`adam_step_times`), beside the bound of the step's bytes, the plain
    version, torch.optim.Adam(fused=True) over the same leaves and the same
    leaves as one-leaf launches (`fused_adam_`); each device reading on the
    next of copies cycling through more than the L2 (`cold_copies`), as a
    train step finds them."""
    from gsrs_tpu_torch.train.fused_adam import MAX_LEAVES, _adam_math_, FusedAdam, fused_adam_

    lr, c1, c2 = FusedAdam(schedule=lambda c: 1e-3, backend="pallas").scalars(10)
    consts = (0.9, 0.999, 1e-8)
    sizes = [(int(np.prod(s)), torch.tensor([], dtype=dt).element_size()) for s, dt in spec]
    nbytes = sum(4 * n * e for n, e in sizes)  # p, m, v and g

    def leaves():
        out = []
        for s, dt in spec:
            p, m, v, g = (torch.randn(s, device=dev) * 1e-3 for _ in range(4))
            out.append(tuple(t.to(dt) for t in (p, m, v.abs(), g)))
        return out

    def library():
        params = [torch.nn.Parameter(torch.randn(s, device=dev).to(dt)) for s, dt in spec]
        for q in params:
            q.grad = torch.randn_like(q) * 1e-3
        return torch.optim.Adam(params, lr=1e-3, fused=True)

    def plain():
        for p, m, v, g in next(sets):
            _adam_math_(p, m, v, g, lr, c1, c2, *consts)

    bound_ms = 1e3 * k3_least_s(sizes)
    t = adam_step_times(dev, spec, bound_ms=bound_ms)
    per_step = -(-len(spec) // MAX_LEAVES)
    check(t["launches"] == per_step, f"fused_adam {what}: {t['launches']} launches in a "
          f"FusedAdam.step, not {per_step}")
    sets, libs = cold_copies(leaves, nbytes), cold_copies(library, nbytes)
    per_leaf = timed_over_bound(
        lambda: [fused_adam_(*leaf, lr, c1, c2, *consts) for leaf in next(sets)], 50,
        f"fused_adam one launch a leaf {what}", len(spec), bound_ms)
    tl = timed_over_bound(lambda: next(libs).step(), 50, f"torch.optim.Adam(fused=True) {what}",
                          events_per_call(lambda: next(libs).step()), bound_ms)
    tp = kernel_ms(plain, 20, f"fused_adam plain {what}", events=events_per_call(plain, 5))
    out = dict(leaves=len(spec), ms=t["ms"], events_ms=t["events_ms"], bound_ms=bound_ms,
               per_leaf_ms=per_leaf["ms"], library_ms=tl["ms"], plain_ms=tp["ms"],
               host_step_us=t["host_us"])
    log(f"[time] fused_adam over {what} ({len(spec)} leaves, one launch): {out['ms'] * 1e3:.1f} "
        f"us device from HBM, bound {bound_ms * 1e3:.1f} us (bytes) = "
        f"{bound_ms / out['ms']:.2f} of it; torch.optim.Adam(fused=True) "
        f"{out['library_ms'] * 1e3:.1f} us; one launch a leaf {out['per_leaf_ms'] * 1e3:.1f} us; "
        f"plain {out['plain_ms'] * 1e3:.1f} us; host {t['host_us']:.1f} us a FusedAdam.step call")
    check(out["ms"] >= bound_ms, f"fused_adam {what} timed under its HBM bound: the leaves did "
          "not leave the L2")
    return out


def time_adam(model, cli_model, launches: int, per_step: float, err: float,
              in_step_ms) -> dict:
    """K3's entry of the kernels line: one launch over the ELL step's two
    tables (`time_adam_leaves`), whose time inside a train step by the
    step's profile is ``in_step_ms``; beside it the same readings over the
    CLI run's 10 leaves and NGCF's 14 at full width. Before this redesign
    K3 took one launch a leaf: 77.0 us device over NGCF's 14 leaves
    (PERF.md, PR 6's figure, not measured here)."""
    dev = model.user_emb.device
    f32 = torch.float32
    sets = {
        "the ELL step's 2 tables": [(tuple(p.shape), p.dtype) for p in model.parameters()],
        "the CLI run's 10 leaves": [(tuple(p.shape), p.dtype) for p in cli_model.parameters()],
        "NGCF's 14 leaves": [(s, f32) for s in ngcf_leaf_shapes(model.graph, model.ell, dev)],
    }
    times = {what: time_adam_leaves(dev, what, spec) for what, spec in sets.items()}
    main = times["the ELL step's 2 tables"]
    in_step = "not measured" if in_step_ms is None else f"{in_step_ms * 1e3:.1f} us"
    log(f"[time] fused_adam inside a train step: {in_step} (one launch a step); PR 6's "
        "one-launch-a-leaf kernel took 77.0 us over NGCF's 14 leaves (PERF.md)")
    return dict(name="fused_adam", route="cuda", source=source("fused_adam"),
                replaces=REPLACES["fused_adam"], launches=launches, max_abs_err=err,
                bound_by="bytes", launches_per_step=per_step, in_step_ms=in_step_ms,
                shape=[int(model.n_users) + int(model.m_items), int(model.cfg.embedding_dim)],
                **{k: main[k] for k in ("ms", "events_ms", "plain_ms", "bound_ms", "library_ms",
                                        "per_leaf_ms", "host_step_us")},
                leaf_sets=times)


def time_training(dev, train: dict) -> dict:
    """Propagation forward and forward + backward, and the device's busy
    share of train steps (torch.profiler, device-side events only)."""
    from torch.profiler import ProfilerActivity, profile

    from gsrs_tpu_torch.ops.sampling import sample_epoch

    tr = train["trainer"]
    model = tr.model
    with torch.no_grad():
        fwd_ms = cuda_ms(model.propagate, reps=10, warmup=2)
    g = torch.Generator(device=dev).manual_seed(3)
    cu = torch.randn(model.n_users, 64, device=dev, generator=g)
    ci = torch.randn(model.m_items, 64, device=dev, generator=g)

    def fwd_bwd():
        u, i = model.propagate()
        ((u * cu).sum() + (i * ci).sum()).backward()
        model.zero_grad(set_to_none=True)

    fb_ms = cuda_ms(fwd_bwd, reps=10, warmup=2)
    log(f"[time] propagation, 3 layers at dim 64: forward {fwd_ms:.3f} ms, forward + backward "
        f"{fb_ms:.3f} ms")

    batches = sample_epoch(g, tr.sampler_state, 10 * 8192, 8192)
    state = train["state"]
    state, _ = tr.run_steps(state, *(b[:2] for b in batches))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = tr.run_steps(state, *batches)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    device_us = sum(t for _, t, _ in rows)
    busy = device_us / wall_us if device_us else None
    if busy is None:
        log("[profile] the profiler saw no device time: busy share not measured")
    else:
        log(f"[profile] train step at batch 8192 (fused_adam=pallas): {wall_us / 10:.1f} us wall, "
            f"{device_us / 10:.1f} us device per step (busy share {busy:.3f})")
        for key, t, n in sorted(rows, key=lambda r: -r[1])[:12]:
            log(f"[profile]   {t / 10:9.1f} us/step  {n / 10:6.1f} calls/step  {key[:80]}")
    adam = [(t, n) for key, t, n in rows if "fused_adam_kernel" in key]
    return dict(fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms, train_device_busy=busy,
                adam_in_step_ms=adam[0][0] / adam[0][1] / 1e3 if adam else None,
                train_step_device_us=device_us / 10 if device_us else None,
                train_step_wall_us=wall_us / 10)


# -------------------------------------------------------------- tiled phase


def rounded_ell(ell):
    """The ELL graph with its weights rounded to bf16 (as K4 and the
    tiled layout's bf16 dense blocks round them), kept in fp32."""
    from gsrs_tpu_torch.ops.ell import EllBucket

    def side(s):
        return dataclasses.replace(s, buckets=tuple(
            EllBucket(b.rows, b.cols, b.w.bfloat16().float(), b.eidx) for b in s.buckets))

    return dataclasses.replace(ell, by_user=side(ell.by_user), by_item=side(ell.by_item))


def layer_and_vjp(layer, graph, u, x, gu, gx, drop=None):
    """(new_u, new_i, d_user, d_item) of one layer and its VJP for the
    cotangents (gu, gx)."""
    u, x = u.detach().requires_grad_(), x.detach().requires_grad_()
    nu, ni = layer(graph, u, x, drop)
    torch.autograd.backward((nu, ni), (gu, gx))
    return nu.detach(), ni.detach(), u.grad, x.grad


def tiled_layer_checks(dev, data, t32, ell) -> dict:
    """(b) one tiled layer against the ELL layer, forward and VJP: fp32
    within ELL_ATOL, and bf16 against the fp32 result of the bf16-rounded
    inputs and weights within the rounding limit of TILED_BF16_ROUNDINGS;
    (c) fp32 with a hash mask against the ELL layer with the same mask in
    canonical edge order → {check: max error}."""
    from gsrs_tpu_torch.ops.ell import ell_propagate_layer
    from gsrs_tpu_torch.ops.hashdrop import canonical_hash_mask
    from gsrs_tpu_torch.ops.tiled import tiled_masks, tiled_propagate_layer

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    u, x, gu, gx = (torch.randn(n, 64, device=dev, generator=g)
                    for n in (data.n_users, data.m_items, data.n_users, data.m_items))
    names = ("new_u", "new_i", "d_user", "d_item")
    errs = {}
    got = layer_and_vjp(tiled_propagate_layer, t32, u, x, gu, gx)
    ref = layer_and_vjp(ell_propagate_layer, ell, u, x, gu, gx)
    errs["fp32"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(errs["fp32"] <= ELL_ATOL, f"tiled fp32 layer vs ELL: {errs['fp32']} > {ELL_ATOL}")

    # bf16: the layout of bench.py (dense blocks rounded to bf16) on bf16 inputs
    t16 = dataclasses.replace(t32, **{
        k: dataclasses.replace(getattr(t32, k), dense=getattr(t32, k).dense.bfloat16())
        for k in ("user_from_item", "item_from_user")})
    b16 = [a.bfloat16() for a in (u, x, gu, gx)]
    got = layer_and_vjp(tiled_propagate_layer, t16, *b16)
    ell_r = rounded_ell(ell)
    ref = layer_and_vjp(ell_propagate_layer, ell_r, *(a.float() for a in b16))
    mag = layer_and_vjp(ell_propagate_layer, ell_r, *(a.float().abs() for a in b16))
    worst = 0.0
    for i, (a, want, m) in enumerate(zip(got, ref, mag)):
        check(a.dtype == torch.bfloat16, f"tiled bf16 {names[i]} is {a.dtype}")
        k = TILED_BF16_ROUNDINGS["forward" if i < 2 else "backward"]
        limit = ((1 + 2.0**-8) ** k - 1) * m + TILED_BF16_ATOL
        worst = max(worst, float(((a.float() - want).abs() / limit).max()))
    errs["bf16_over_limit"] = worst
    check(worst <= 1.0, f"tiled bf16 layer: error {worst}x its rounding limit")

    users = torch.from_numpy(data.train_users).to(dev)
    items = torch.from_numpy(data.train_items).to(dev)
    mask = canonical_hash_mask(users, items, TILED_DROP)
    got = layer_and_vjp(tiled_propagate_layer, t32, u, x, gu, gx, tiled_masks(t32, TILED_DROP))
    ref = layer_and_vjp(ell_propagate_layer, ell, u, x, gu, gx, mask)
    errs["fp32_hash_mask"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    check(errs["fp32_hash_mask"] <= ELL_ATOL,
          f"tiled layer with a hash mask vs ELL: {errs['fp32_hash_mask']} > {ELL_ATOL}")
    kept = float((mask > 0).float().mean())
    log(f"[tiled] layer vs ELL, forward and VJP: fp32 max abs err {errs['fp32']:.2e}; bf16 "
        f"{worst:.3f} of its rounding limit; fp32 with a hash mask (keep 0.6, kept {kept:.4f}) "
        f"{errs['fp32_hash_mask']:.2e}")
    return errs


def tiled_card_vs_cpu(dev, data, orders) -> dict:
    """(d) one seeded model on the card and on the CPU, a SMALL_G × SMALL_C
    tiled layout over the bench layout's order, the same 3 triplet
    batches through run_steps, in fp32 and bf16 → max differences."""
    from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from gsrs_tpu_torch.data.adjacency import build_graph, normalized_edge_weights
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_epoch
    from gsrs_tpu_torch.ops.tiled import _build_tiled_graph
    from gsrs_tpu_torch.train.trainer import Trainer

    graph = build_graph(data)
    users, items = data.train_users.astype(np.int64), data.train_items.astype(np.int64)
    w = normalized_edge_weights(users, items, data.user_degrees, data.item_degrees)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    batches = [t.cpu() for t in sample_epoch(g, make_sampler_state(data, dev), 3 * 8192, 8192,
                                              neg_candidates=4)]
    out = {}
    for bf16 in (False, True):
        dtype = torch.bfloat16 if bf16 else torch.float32
        layout = _build_tiled_graph(users, items, w.astype(np.float32), data.n_users,
                                    data.m_items, SMALL_G, SMALL_C, dtype, 4, 0, orders)
        cfg = ExperimentConfig(
            model=ModelConfig(num_layers=3, embedding_dim=64, bf16_compute=bf16,
                              spmm_mode="tiled", tiled_groups=SMALL_G, tiled_cols=SMALL_C),
            train=TrainConfig(batch_size=8192, seed=SEED, neg_candidates=4))
        runs = []
        for device in (dev, torch.device("cpu")):
            model = build_model(cfg.model, graph, ell=layout, device=device)
            tr = Trainer(cfg, data, graph, model, run_eval=False, device=device)
            t0 = time.perf_counter()
            state, losses = tr.run_steps(tr.init_state(), *batches)
            losses = losses.cpu()
            runs.append((losses, {k: v.detach().cpu() for k, v in state.params.items()}))
            log(f"[tiled] 3 run_steps {str(dtype)[6:]} G={SMALL_G} C={SMALL_C} on {device}: "
                f"losses {losses.tolist()} ({time.perf_counter() - t0:.2f} s)")
        (l_card, p_card), (l_cpu, p_cpu) = runs
        diff = torch.cat([(p_card[k] - p_cpu[k]).abs().reshape(-1) for k in p_cpu])
        res = dict(loss=float((l_card - l_cpu).abs().max()), param_max=float(diff.max()),
                   param_share_over=float((diff > TILED_PARAM_ATOL).float().mean()))
        if bf16:
            check(res["loss"] <= TILED_BF16_LOSS_RTOL * float(l_cpu.abs().max()),
                  f"bf16 card vs CPU losses differ by {res['loss']}")
            check(res["param_share_over"] <= TILED_BF16_PARAM_SHARE,
                  f"bf16 card vs CPU: {res['param_share_over']} of the parameters differ by "
                  f"more than {TILED_PARAM_ATOL}")
            check(res["param_max"] <= 2 * 3 * cfg.train.lr,
                  f"bf16 card vs CPU parameters differ by {res['param_max']}")
        else:
            check(res["loss"] <= TRAIN_ATOL and res["param_max"] <= TRAIN_ATOL,
                  f"fp32 tiled card vs CPU: {res}")
        out[str(dtype)[6:]] = res
        log(f"[tiled] card vs CPU after 3 steps, {str(dtype)[6:]}: max loss diff "
            f"{res['loss']:.2e}, max parameter diff {res['param_max']:.2e}, share over "
            f"{TILED_PARAM_ATOL}: {res['param_share_over']:.2e}")
    return out


def tiled_k4_checks(model) -> float:
    """K4 against its plain version (`ell_variants`, fp32 and bf16) on the
    six sides the bench path gives it: each direction's residual forward
    (dst side) and backward (src side), without and with the residual's
    hash mask, and ``occ`` (unit weights over the G·C hub slots, no mask)
    → max fp32 abs error."""
    from gsrs_tpu_torch.ops.tiled import tiled_masks

    dev, d = model.user_emb.device, model.cfg.embedding_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    n_src = {"user_from_item": model.m_items, "item_from_user": model.n_users}
    n_dst = {"user_from_item": model.n_users, "item_from_user": model.m_items}
    err = 0.0
    for name, masks in zip(("user_from_item", "item_from_user"),
                           tiled_masks(model.ell, TILED_DROP)):
        t = getattr(model.ell, name)
        for side_name, side, x, mask in (
            ("residual fwd", t.residual.by_user, torch.randn(n_src[name], d, device=dev,
                                                             generator=g), masks.residual),
            ("residual bwd", t.residual.by_item, torch.randn(n_dst[name], d, device=dev,
                                                             generator=g), masks.residual),
            # ≤ G unit-weight slots a row: inputs of 1/sqrt(G) keep the sums O(1)
            ("occ", t.occ, torch.randn(t.groups * t.cols, d, device=dev, generator=g)
             / t.groups**0.5, None),
        ):
            err = max(err, ell_variants(side.table, x, mask,
                                        f"ell_gather_reduce tiled {name} {side_name}"))
    return err


def hub_product_rounding(a, b) -> dict:
    """The bf16 grouped product against the fp32 product of the same
    inputs, as a share of one rounding to bf16 (2^-8 of sum |a| |b|, plus
    TILED_BF16_ATOL), through the port's `_hub_product` (fp32 reduction)
    and through `torch.bmm` under PyTorch's default (which lets cuBLAS add
    split-K partials in bf16) → {"fp32_reduction": x, "default": x}."""
    from gsrs_tpu_torch.ops.tiled import _hub_product

    ref = torch.bmm(a.float(), b.float())
    limit = 2.0**-8 * torch.bmm(a.float().abs(), b.float().abs()) + TILED_BF16_ATOL
    out = {"fp32_reduction": _hub_product(a, b), "default": torch.bmm(a, b)}
    return {k: float(((v.float() - ref).abs() / limit).max()) for k, v in out.items()}


def time_tiled(model) -> dict:
    """Device time per call of each K4 side of the bench layout (bf16)
    beside its bound over its real slots, and of the grouped hub products
    (`torch.bmm`, forward and on the transposed view) beside theirs."""
    from gsrs_tpu_torch.ops.ell import _apply_side
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce
    from gsrs_tpu_torch.ops.tiled import _hub_product

    d = model.cfg.embedding_dim
    g = torch.Generator(device=model.user_emb.device).manual_seed(SEED + 4)
    n_src = {"user_from_item": model.m_items, "item_from_user": model.n_users}
    n_dst = {"user_from_item": model.n_users, "item_from_user": model.m_items}
    sides, bmm = {}, {}
    with torch.no_grad():
        for name in ("user_from_item", "item_from_user"):
            t = getattr(model.ell, name)
            G, rows_g, C = t.groups, t.rows_g, t.cols
            x_src = torch.randn(n_src[name], d, device=g.device, generator=g).bfloat16()
            x_dst = torch.randn(n_dst[name], d, device=g.device, generator=g).bfloat16()
            hub = torch.randn(G * C, d, device=g.device, generator=g).bfloat16()
            for side_name, side, x in (("residual fwd", t.residual.by_user, x_src),
                                       ("residual bwd", t.residual.by_item, x_dst),
                                       ("occ", t.occ, hub)):
                table = side.table
                nnz = sum(int((b.w != 0).sum()) for b in side.buckets)
                b_ms, b_by = k4_least_ms(nnz, x, table.n_rows)
                out = x.new_empty(table.n_rows + 1, d)
                k4 = kernel_ms(lambda: gather_reduce(table, x, out=out), 100,
                               f"tiled K4 {name} {side_name}")
                apply = kernel_ms(lambda: _apply_side(side, x), 100,
                                  f"tiled apply {name} {side_name}")
                sides[f"{name} {side_name}"] = dict(
                    ms=k4["ms"], events_ms=k4["events_ms"], apply_ms=apply["ms"], bound_ms=b_ms,
                    bound_by=b_by, edges=nnz, rows=side.n_rows, buckets=len(side.buckets),
                    **sparse_mm(side, x, f"tiled {name} {side_name}"))
            dd = t.dense.view(G, rows_g, C)
            xg = x_src.index_select(0, t.top_src.reshape(-1)).reshape(G, C, d)
            gy = x_dst.index_select(0, t.row_nat).view(G, rows_g, d)
            b_ms = least_ms(2 * dd.numel() * d, dd.numel() * dd.element_size(), "bfloat16")[0]
            for kind, a, b in (("forward", dd, xg), ("transpose", dd.transpose(1, 2), gy)):
                ms = kernel_ms(lambda: _hub_product(a, b), 100, f"tiled {name} bmm {kind}")
                bmm[f"{name} {kind}"] = dict(ms=ms["ms"], events_ms=ms["events_ms"],
                                             bound_ms=b_ms, shape=[G, rows_g, C, d],
                                             rounding=hub_product_rounding(a, b))
    for k, v in sides.items():
        log(f"[time] tiled K4 {k}: {v['ms'] * 1e3:.1f} us/call (bf16, {v['buckets']} buckets, "
            f"{v['edges']} slots of weight != 0, {v['rows']} rows), bound "
            f"{v['bound_ms'] * 1e3:.2f} us ({v['bound_by']}); the side's whole apply (zero row, "
            f"K4, assemble gather) {v['apply_ms'] * 1e3:.1f} us; torch.sparse.mm (CSR, "
            f"{v['library_dtype']}) {v['library_ms'] * 1e3:.1f} us")
    for k, v in bmm.items():
        r = v["rounding"]
        log(f"[time] tiled bmm {k} {v['shape']}: {v['ms'] * 1e3:.1f} us/call, bound "
            f"{v['bound_ms'] * 1e3:.1f} us (the dense block read once); error against fp32 "
            f"{r['fp32_reduction']:.3f} of one bf16 rounding (PyTorch's default reduction "
            f"{r['default']:.3f})")
        check(r["fp32_reduction"] <= 1.0, f"tiled bmm {k}: {r['fp32_reduction']} roundings")
    return dict(k4_sides=sides, bmm=bmm)


def tiled_phase(dev, data) -> dict:
    """The bench.py configuration: the tiled layout (G = 64 groups of
    C = 2048 hub columns, bf16) on the training data, (a) build seconds
    and dense coverage, (b)-(c) layer checks, (d) card vs CPU, (e) one
    `Trainer.train_epoch` of `gsrs_tpu_torch.bench.bench_config`
    (counted), (f) a profiled epoch and per-call times."""
    from gsrs_tpu_torch.bench import bench_config
    from gsrs_tpu_torch.data.adjacency import build_graph, normalized_edge_weights
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.ell import ell_from_interactions
    from gsrs_tpu_torch.ops.reorder import spectral_cluster_order
    from gsrs_tpu_torch.ops.sampling import sample_epoch
    from gsrs_tpu_torch.ops.tiled import _build_tiled_graph, tiled_from_interactions
    from gsrs_tpu_torch.train.trainer import Trainer

    users, items = data.train_users.astype(np.int64), data.train_items.astype(np.int64)
    w = normalized_edge_weights(users, items, data.user_degrees, data.item_degrees)
    t0 = time.perf_counter()
    orders = spectral_cluster_order(users, items, data.n_users, data.m_items, n_clusters=TILED_G)
    order_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t32 = _build_tiled_graph(users, items, w.astype(np.float32), data.n_users, data.m_items,
                             TILED_G, TILED_C, torch.float32, 4, 0, orders)
    layout_s = time.perf_counter() - t0
    E = data.train_size
    coverage = {k: 1.0 - getattr(t32, k).res_dst.numel() / E
                for k in ("user_from_item", "item_from_user")}
    log(f"[tiled] G={TILED_G} C={TILED_C} on {E} edges: spectral order {order_s:.2f} s, "
        f"layout {layout_s:.2f} s (host); dense coverage user_from_item "
        f"{coverage['user_from_item']:.4f}, item_from_user {coverage['item_from_user']:.4f}")
    checks = tiled_layer_checks(dev, data, t32.to(dev), ell_from_interactions(data).to(dev))
    del t32
    card_vs_cpu = tiled_card_vs_cpu(dev, data, orders)

    # ---- the main path, counted: one epoch of bench.py's configuration (gowalla-train times it)
    cfg = bench_config()
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    graph = build_graph(data)
    layout = tiled_from_interactions(data, groups=cfg.model.tiled_groups,
                                     cols=cfg.model.tiled_cols, dtype=torch.bfloat16)
    model = build_model(cfg.model, graph, ell=layout, device=dev)
    tr = Trainer(cfg, data, graph, model, run_eval=False, device=dev)
    state, loss = tr.train_epoch(tr.init_state())
    launches = launches_since(before)
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    steps = tr.steps_per_epoch
    tables = {}
    for name in ("user_from_item", "item_from_user"):
        t = getattr(model.ell, name)
        for side_name, side in (("residual fwd", t.residual.by_user),
                                ("residual bwd", t.residual.by_item), ("occ", t.occ)):
            tables[f"{name} {side_name}"] = side.table.launches
    log(f"[tiled] bench.py's configuration: one epoch of {steps} steps of "
        f"{tr.cfg.train.batch_size}, loss {loss:.5f}; launches {launches}; K4 calls by side "
        f"{tables}; peak device memory {peak_mib:.1f} MiB")
    check(np.isfinite(loss), f"bench.py's configuration: epoch loss {loss}")
    for side, n in tables.items():
        check(n >= model.cfg.num_layers * steps, f"K4 launched {n} times on the {side} side "
              f"in {steps} steps")
    check_launched(launches, "gather_rows_grad", bpr_gathers(model) * steps, "the bench")
    k4_err = tiled_k4_checks(model)

    # ---- (f) one epoch under the profiler: device time by kernel per step
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = tr.train_epoch(state)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = device_rows(prof)
    device_us = sum(t for _, t, _ in rows)
    n = steps
    busy = device_us / wall_us
    log(f"[profile] bench epoch ({n} steps + sampling): {wall_us / n:.1f} us wall, "
        f"{device_us / n:.1f} us device per step (busy share {busy:.3f})")
    top = [(key, t / n, c / n) for key, t, c in sorted(rows, key=lambda r: -r[1])[:16]]
    for key, t, c in top:
        log(f"[profile]   {t:9.1f} us/step  {c:6.1f} calls/step  {key[:80]}")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    B = tr.cfg.train.batch_size
    sample_us = 1e3 * kernel_ms(lambda: sample_epoch(g, tr.sampler_state, n * B, B,
                                                     neg_candidates=4), 5, "sampler")["ms"]
    log(f"[time] sampler, one epoch of {n} x {B} triplets: {sample_us:.1f} us device")
    times = time_tiled(model)
    return dict(order_s=order_s, layout_s=layout_s, coverage=coverage, checks=checks,
                card_vs_cpu=card_vs_cpu, loss=loss, launches=launches, k4_calls_by_side=tables,
                peak_mib=peak_mib, step_device_us=device_us / n, step_wall_us=wall_us / n,
                busy=busy, sampler_epoch_us=sample_us, k4_err=k4_err,
                profile_top=top, **times)


# ---------------------------------------------------------------- CLI phase


def csv_rows(path: str):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def run_quiet(fn, *args, **kw):
    """fn's result and its standard output, captured."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def write_cli_dataset(data, data_dir: str) -> float:
    """``data`` as a dataset directory (train.txt, test.txt) with its ids
    as they are, so a run keeps its shape (the stand-in's 29,858 × 40,981)
    → seconds."""
    from gsrs_tpu_torch.data.dataset import write_interaction_file

    t0 = time.perf_counter()
    os.makedirs(data_dir)
    write_interaction_file(os.path.join(data_dir, "train.txt"), data.train_users,
                           data.train_items)
    te_u = np.concatenate([np.full(len(v), k) for k, v in data.test_dict.items()])
    te_i = np.concatenate(list(data.test_dict.values()))
    write_interaction_file(os.path.join(data_dir, "test.txt"), te_u, te_i)
    return time.perf_counter() - t0


def cli_argv(root: str, ckpt: str, i2i_path: str, epochs: int) -> list:
    return ["--data_root", root, "--dataset", CLI_DATASET, "--bf16", "--epochs", str(epochs),
            "--eval_every", "1", "--use_pop_gate", "--use_item_item", "--i2i_path", i2i_path,
            "--topk_method", "approx", "--fused_adam", "pallas", "--save_every", "2",
            "--keep_topk", "1", "--tensorboard", "0", "--checkpoint_dir", ckpt]


def side_launches(model) -> dict:
    return {"user": model.ell.by_user.table.launches, "item": model.ell.by_item.table.launches,
            "i2i_forward": model.i2i.ell.by_user.table.launches,
            "i2i_backward": model.i2i.ell.by_item.table.launches}


def cli_run(argv, what: str):
    """`gsrs_tpu_torch.cli.main` counted → (trainer, state, launches,
    seconds)."""
    from gsrs_tpu_torch import cli

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launches_since(before), sides=side_launches(trainer.model))
    log(f"[cli] {what}: {wall:.2f} s, epoch {state.epoch}, launches {launches}")
    return trainer, state, launches, wall


def topk_method_checks(trainer) -> dict:
    """The Evaluator on the final parameters with exact, threshold and
    approx: threshold's ids bitwise exact's and its metrics within
    METRIC_ATOL, and on each batch's K1 scores threshold's ids and values
    bitwise exact's (both rank in ``lax.top_k``'s order); approx's recall
    of exact's top-20, averaged over the test users, at least the target
    less APPROX_SLACK. Each method's eval seconds, warm."""
    from gsrs_tpu_torch.ops.scoring import masked_scores
    from gsrs_tpu_torch.ops.topk import topk_scores
    from gsrs_tpu_torch.train.evaluator import Evaluator

    data, model, ecfg = trainer.data, trainer.model, trainer.cfg.eval
    out, tops, metrics = {"eval_s": {}}, {}, {}
    for method in ("exact", "threshold", "approx"):
        ev = Evaluator(data, model, dataclasses.replace(ecfg, topk_method=method),
                       train_bitset=trainer.sampler_state.train_bitset, device=model.user_emb.device)
        before = launch_counts()
        ev.run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics[method] = ev.run()
        out["eval_s"][method] = time.perf_counter() - t0
        check_launched(launches_since(before), "exact_topk",
                       2 * ev._users.shape[0] if method == "exact" else 0,
                       f"two evals by {method} top-k")
        tops[method] = ev.top_items()
    diff = max(abs(metrics["threshold"][k] - metrics["exact"][k]) for k in metrics["exact"])
    check(diff <= METRIC_ATOL, f"threshold vs exact metrics differ by {diff}")
    check(torch.equal(tops["threshold"], tops["exact"]), "the Evaluator's threshold ids differ "
          f"from exact's in {int((tops['threshold'] != tops['exact']).any(dim=1).sum())} rows")
    all_users, items, _ = model.final_embeddings()
    users = torch.from_numpy(data.test_users()).to(model.user_emb.device)
    k = tops["exact"].shape[1]
    hits = 0
    with torch.no_grad():
        for s in range(0, users.numel(), ecfg.test_batch):
            ids = users[s:s + ecfg.test_batch]
            scores = masked_scores(all_users[ids], items, ev.train_bitset[ids])
            got, want = topk_scores(scores, k, "threshold"), topk_scores(scores, k, "exact")
            check(bitwise_equal(got[1], want[1]) and bitwise_equal(got[0], want[0]),
                  f"threshold vs exact on the K1 scores of users {s}..: ids or values differ")
            rows = slice(s, s + ids.numel())
            a, e = tops["approx"][rows], tops["exact"][rows]
            hits += int((a[:, :, None] == e[:, None, :]).any(dim=2).sum())
    out["approx_recall"] = hits / (users.numel() * k)
    out["metrics"] = metrics
    target = ecfg.topk_recall_target
    check(out["approx_recall"] >= target - APPROX_SLACK,
          f"approx recall {out['approx_recall']} < {target} - {APPROX_SLACK}")
    log(f"[cli] top-k methods on the final parameters ({users.numel()} test users, top-{k}): "
        f"threshold = exact bitwise (metrics within {diff:.1e}); approx recall of exact's top-{k} "
        f"{out['approx_recall']:.4f} (target {target}); warm eval "
        + ", ".join(f"{m} {t:.4f} s" for m, t in out["eval_s"].items()))
    return out


def cli_phase(dev, data, out_dir: str) -> dict:
    """`python -m gsrs_tpu_torch`'s lifecycle at full width on the card:
    the stand-in written as a dataset directory and its i2i npz (cooc, top
    10), a counted 3-epoch run (bf16, pop gate, i2i, approx top-k, fused
    Adam kernel), its logs and checkpoints, a resume to 4 epochs against
    an uninterrupted 4-epoch run, serve export → query against a Retriever
    of the trained model, the three top-k methods, and K4 on the i2i sides
    against its plain version."""
    import shutil

    from gsrs_tpu_torch import serve
    from gsrs_tpu_torch.data import i2i as i2i_builder
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference
    from gsrs_tpu_torch.serve import retriever_from_model
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    root = out_dir
    data_dir = os.path.join(root, CLI_DATASET)
    ckpt = os.path.join(root, "cli_ckpt")
    for d in (data_dir, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    write_s = write_cli_dataset(data, data_dir)
    i2i_path = os.path.join(data_dir, "i2i.npz")
    t0 = time.perf_counter()
    i2i_builder.main(["--dataset_dir", data_dir, "--scheme", "cooc", "--topk", "10",
                      "--out", i2i_path])
    i2i_s = time.perf_counter() - t0
    log(f"[cli] dataset directory written in {write_s:.2f} s, i2i npz built in {i2i_s:.2f} s")

    # ---- the main path, counted: 3 epochs through the CLI
    tr, state, launches, wall = cli_run(cli_argv(root, ckpt, i2i_path, CLI_EPOCHS), "3 epochs")
    model, steps = tr.model, CLI_EPOCHS * tr.steps_per_epoch
    check(state.epoch == CLI_EPOCHS, f"the run ended at epoch {state.epoch}")
    train_rows = csv_rows(os.path.join(ckpt, "train_epoch_metrics.csv"))
    valid_rows = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))
    check([r["epoch"] for r in train_rows] == ["1", "2", "3"], f"train CSV {train_rows}")
    check([r["epoch"] for r in valid_rows] == ["0", "1", "2", "3"], f"valid CSV {valid_rows}")
    check(all(np.isfinite(float(r["train_loss"])) for r in train_rows), "non-finite loss")
    listing = sorted(os.listdir(ckpt))
    bests = [n for n in listing if n.startswith("best-epoch")]
    check(len(bests) == (1 if state.best_metric > 0 else 0), f"best checkpoints {bests}")
    legacy = f"lgn-{CLI_DATASET}-3-64"
    check(set(listing) - set(bests) == {"last", legacy, "model_meta.json",
                                        "train_epoch_metrics.csv", "valid_epoch_metrics.csv"},
          f"checkpoint listing {listing}")
    with open(os.path.join(ckpt, "model_meta.json")) as f:
        check(json.load(f) == dataclasses.asdict(tr.cfg.model), "model_meta.json differs")
    n_leaves = len(list(model.parameters()))
    evals, n_batches = len(valid_rows), tr.evaluator._users.shape[0]
    sides = launches["sides"]
    check(launches["fused_adam"] == adam_launches_per_step(model) * steps,
          f"fused_adam launched {launches['fused_adam']} times for {n_leaves} leaves in {steps} "
          "steps")
    check(launches["masked_scores"] == evals * n_batches,
          f"masked_scores launched {launches['masked_scores']} times for {evals} evals of "
          f"{n_batches} batches")
    check_launched(launches, "exact_topk", 0, "the CLI run, approx top-k")
    layers = model.cfg.num_layers
    for side in ("user", "item"):  # each layer's forward and backward apply
        check(sides[side] >= 2 * layers * steps, f"K4 on the {side} side: {sides[side]}")
    per_apply = len(model.i2i.ell.by_user.table._tables)  # launches per apply of a side
    check(sides["i2i_forward"] == (steps + evals) * per_apply
          and sides["i2i_backward"] == steps * len(model.i2i.ell.by_item.table._tables),
          f"K4 on the i2i sides: {sides} in {steps} steps and {evals} evals")
    epoch_s = [float(r["time_sec"]) for r in train_rows]
    eval_s = [float(r["time_sec"]) for r in valid_rows]
    t0 = time.perf_counter()
    tr.save_last(state)
    save_s = time.perf_counter() - t0
    log(f"[cli] logs and checkpoints as the JAX trainer writes them: {listing}; epochs "
        f"{epoch_s} s ({tr.steps_per_epoch} steps of {tr.cfg.train.batch_size}); evals {eval_s} "
        f"s; one save_last {save_s:.3f} s")

    # ---- resume to 4 epochs, against 4 epochs without a stop
    argv4 = cli_argv(root, ckpt, i2i_path, CLI_EPOCHS + 1)
    tr4, s4, l4, wall4 = cli_run(argv4 + ["--resume"], "resume to 4 epochs")
    check(l4["fused_adam"] == adam_launches_per_step(model) * tr4.steps_per_epoch,
          f"the resumed run launched fused_adam {l4['fused_adam']} times, not once a step of "
          "one epoch")
    check_launched(l4, "exact_topk", 0, "the resumed CLI run, approx top-k")
    rows = csv_rows(os.path.join(ckpt, "train_epoch_metrics.csv"))
    check([r["epoch"] for r in rows] == ["1", "2", "3", "4"], f"train CSV after resume {rows}")
    rows = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))  # epoch 3 evaluated again
    check([r["epoch"] for r in rows] == ["0", "1", "2", "3", "3", "4"],
          f"valid CSV after resume {rows}")
    t0 = time.perf_counter()
    restored = tr4.maybe_resume(tr4.init_state())
    resume_s = time.perf_counter() - t0
    check(restored.epoch == CLI_EPOCHS + 1, f"restored epoch {restored.epoch}")
    # the uninterrupted run: the first run's trainer, whose parameters and
    # optimizer state never went through a checkpoint, takes epoch 4
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_full, _ = tr.train_epoch(state)
    torch.cuda.synchronize()
    wall_full = time.perf_counter() - t0
    check(s_full.epoch == CLI_EPOCHS + 1, f"the uninterrupted run ended at epoch {s_full.epoch}")
    resumed = CheckpointManager(ckpt).restore(os.path.join(ckpt, "last"))["params"]
    whole = {k: p.detach().cpu() for k, p in s_full.params.items()}
    resume_diff = max(float((resumed[k] - whole[k]).abs().max()) for k in whole)
    bitwise = all(torch.equal(resumed[k], whole[k]) for k in whole)
    check(resume_diff <= RESUME_ATOL, f"resumed vs uninterrupted parameters: {resume_diff}")
    log(f"[cli] resume: started at epoch {CLI_EPOCHS}, restore {resume_s:.3f} s; against the "
        f"first run taking epoch 4 in memory ({wall_full:.2f} s): max parameter diff "
        f"{resume_diff:.2e}, bitwise equal {bitwise}")

    # ---- serve export → query, against a Retriever of the trained model
    art = os.path.join(root, "cli_emb.npz")
    t0 = time.perf_counter()
    _, text = run_quiet(serve.main, ["export", "--checkpoint_dir", ckpt, "--dataset_dir",
                                     data_dir, "--out", art])
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    log(text.strip())
    users = [int(u) for u in np.random.default_rng(SEED).choice(tr4.data.n_users, 64,
                                                                  replace=False)]
    t0 = time.perf_counter()
    _, text = run_quiet(serve.main, ["query", "--artifact", art, "--users", *map(str, users),
                                     "--k", str(K)])
    query_s = time.perf_counter() - t0
    lines = text.strip().splitlines()
    check(len(lines) == len(users), f"query printed {len(lines)} lines for {len(users)} users")
    printed = np.array([[int(p.split(":")[0]) for p in ln.split(": ", 1)[1].split()]
                        for ln in lines])
    live = retriever_from_model(tr4.model, tr4.data, batch_size=BATCH)
    live_items, _ = live.recommend(users, k=K)
    ue, ie, seen = live._serve_tables
    ids = torch.as_tensor(users, device=dev)
    same_topk(printed, masked_scores_reference(ue[ids], ie, seen[ids]), live_items,
              "serve query vs the live Retriever")
    log(f"[cli] serve export {export_s:.2f} s, query of {len(users)} users {query_s:.2f} s: "
        "top-20 equal to the trained model's Retriever")

    methods = topk_method_checks(tr4)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn(model.m_items, model.cfg.embedding_dim, device=dev, generator=g)
    i2i_err = max(ell_variants(side.table, x, None, f"ell_gather_reduce i2i {name}")
                  for name, side in (("forward", tr4.model.i2i.ell.by_user),
                                     ("backward", tr4.model.i2i.ell.by_item)))
    main_launches = {k: launches[k] + l4[k] for k in ("masked_scores", "ell_gather_reduce",
                                                      "fused_adam", "exact_topk",
                                                      "gather_rows_grad")}
    return dict(model=tr4.model, launches=main_launches,
                sides={k: sides[k] + l4["sides"][k] for k in sides}, steps=steps,
                steps_per_epoch=tr.steps_per_epoch, n_leaves=n_leaves, epoch_s=epoch_s,
                eval_s_in_run=eval_s, run_s=wall, resume_run_s=wall4, continued_epoch_s=wall_full,
                save_last_s=save_s, resume_s=resume_s, resume_max_diff=resume_diff,
                resume_bitwise=bitwise, export_s=export_s, query_s=query_s,
                write_dataset_s=write_s, i2i_build_s=i2i_s, i2i_edges=int(model.i2i.n_edges),
                i2i_k4_err=i2i_err, best_metric=state.best_metric,
                topk_eval_s=methods["eval_s"], approx_recall=methods["approx_recall"],
                topk_metrics=methods["metrics"])


# ---------------------------------------------------------------- zoo phase


def bf16_limit(mag: torch.Tensor, roundings: int) -> torch.Tensor:
    """The error of ``roundings`` roundings to bf16 (2^-8 relative each) of
    values bounded by ``mag``, plus the fp32 order difference near 0."""
    return ((1 + 2.0**-8) ** roundings - 1) * mag + ELL_BF16_ATOL


def check_repeats(first, second, what: str) -> None:
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, second)), f"{what}: two calls differ")


def segment_checks(dev, data, ell) -> dict:
    """The segment layer (`ops.spmm.propagate_layer`: JAX's sort-order
    masks back to canonical order, then the ELL layer, K4 on both sides)
    forward and VJP on the card against the CPU in fp32 (within ELL_ATOL)
    and bf16 (within twice SEGMENT_BF16_ROUNDINGS of the fp32
    magnitudes), without and with an edge mask, two calls on the card
    bitwise equal; `torch.segment_reduce` (the library's segment sum over
    the sorted edge arrays, JAX's `jax.ops.segment_sum`) equal to it in
    fp32 within ELL_ATOL; then the device time of a layer of each →
    {check: max error, times}."""
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.ops.ell import ell_propagate_layer
    from gsrs_tpu_torch.ops.spmm import make_edge_dropout_masks, propagate_layer

    graph = build_graph(data)
    ell_dev = ell.to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    arrays = [torch.randn(n, 64, device=dev, generator=g)
              for n in (data.n_users, data.m_items, data.n_users, data.m_items)]

    def layer(layout, *args):
        return propagate_layer(graph, *args, ell=layout)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for masked in (False, True):
            masks = (make_edge_dropout_masks(torch.Generator().manual_seed(SEED), graph, 0.6,
                                             dtype) if masked else None)
            dmasks = None if masks is None else tuple(m.to(dev) for m in masks)
            ins = [a.to(dtype) for a in arrays]
            card = layer_and_vjp(layer, ell_dev, *ins, dmasks)
            again = layer_and_vjp(layer, ell_dev, *ins, dmasks)
            label = f"segment layer {str(dtype)[6:]} {'masked' if masked else 'unmasked'}"
            check_repeats(card, again, label)
            cpu = layer_and_vjp(layer, ell, *(a.cpu() for a in ins), masks)
            if dtype == torch.float32:
                err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu))
                check(err <= ELL_ATOL, f"{label}: card vs CPU {err} > {ELL_ATOL}")
            else:
                fm = None if masks is None else tuple(m.float() for m in masks)
                mag = layer_and_vjp(layer, ell, *(a.cpu().float().abs() for a in ins), fm)
                err = max(float(((a.cpu().float() - b.float()).abs()
                                 / (2 * bf16_limit(m, SEGMENT_BF16_ROUNDINGS))).max())
                          for a, b, m in zip(card, cpu, mag))
                check(err <= 1.0, f"{label}: card vs CPU {err}x the bf16 limit")
            out[label] = err
            log(f"[zoo] {label}, forward and VJP: card vs CPU "
                f"{'max abs err' if dtype == torch.float32 else 'err/limit'} {err:.3e}; two calls "
                "bitwise equal")
    edges = {k: torch.from_numpy(getattr(graph, k)).to(dev) for k in (
        "edge_u_by_u", "edge_i_by_u", "edge_w_by_u", "edge_i_by_i", "edge_u_by_i", "edge_w_by_i")}
    edges["runs_by_u"] = torch.bincount(edges["edge_u_by_u"].long(), minlength=graph.n_users)
    edges["runs_by_i"] = torch.bincount(edges["edge_i_by_i"].long(), minlength=graph.m_items)
    times = {}
    with torch.no_grad():
        lib = segment_reduce_layer(edges, *arrays[:2])
        err = max(float((a - b).abs().max())
                  for a, b in zip(lib, layer(ell_dev, *arrays[:2])))
        check(err <= ELL_ATOL, f"torch.segment_reduce against the segment layer: {err}")
        for dtype in (torch.float32, torch.bfloat16):
            u, x = (a.to(dtype) for a in arrays[:2])
            for name, fn, g in (("ell", ell_propagate_layer, ell_dev),
                                ("torch.segment_reduce", segment_reduce_layer, edges)):
                times[f"{name} {str(dtype)[6:]}"] = kernel_ms(
                    lambda: fn(g, u, x), 20, f"{name} layer {dtype}")["ms"]
    log("[time] one layer forward (both sides), device time: " + ", ".join(
        f"{k} {v * 1e3:.1f} us" for k, v in times.items()))
    return dict(errors=out, layer_ms=times, segment_reduce_err=err)


def segment_reduce_layer(edges: dict, user_emb, item_emb):
    """The segment layer's two sums by `torch.segment_reduce` over the
    graph's sorted edge arrays (``edges``: the `BipartiteGraph`'s arrays
    on the card and the run length of each user and item), the library
    counterpart of JAX's `jax.ops.segment_sum`: products in x's dtype,
    summed in fp32, rounded once. Timed beside the port's K4 sides."""
    out = []
    for lengths, src, w, x in (
            (edges["runs_by_u"], edges["edge_i_by_u"], edges["edge_w_by_u"], item_emb),
            (edges["runs_by_i"], edges["edge_u_by_i"], edges["edge_w_by_i"], user_emb)):
        gathered = x.index_select(0, src) * w.to(x.dtype)[:, None]
        out.append(torch.segment_reduce(gathered.float(), "sum", lengths=lengths,
                                        unsafe=True).to(x.dtype))
    return out


def hybrid_checks(dev, data, ell) -> dict:
    """The hybrid layout at C = HYBRID_C in fp32 and bf16: build seconds
    and dense coverage; its layer forward and VJP on the card against the
    CPU's ELL layer (the same product, and the same edges kept: the hash
    mask in canonical order), fp32 within ELL_ATOL and bf16 within the
    HYBRID_BF16_ROUNDINGS limit of the fp32 result of the rounded inputs
    and weights, without and with hash dropout, two calls bitwise equal;
    K4 against its plain version on both residual sides of both
    directions; device time of the layer, of each dense product beside its
    bound and of each K4 residual side → results."""
    from gsrs_tpu_torch.ops.ell import _apply_side, ell_propagate_layer
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce
    from gsrs_tpu_torch.ops.hashdrop import canonical_hash_mask
    from gsrs_tpu_torch.ops.hybrid import (
        hybrid_from_interactions, hybrid_masks, hybrid_propagate_layer,
    )
    from gsrs_tpu_torch.ops.tiled import _hub_product

    E = data.train_size
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    arrays = [torch.randn(n, 64, device=dev, generator=g)
              for n in (data.n_users, data.m_items, data.n_users, data.m_items)]
    users, items = torch.from_numpy(data.train_users), torch.from_numpy(data.train_items)
    cpu_mask = canonical_hash_mask(users, items, TILED_DROP)
    ell_r = rounded_ell(ell)
    out = dict(errors={}, build_s={}, layer_ms={}, dense={}, k4_sides={})
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        t0 = time.perf_counter()
        hg = hybrid_from_interactions(data, cols=HYBRID_C, dtype=dtype)
        out["build_s"][dt] = time.perf_counter() - t0
        if dtype == torch.float32:
            out["coverage"] = {k: 1.0 - getattr(hg, k).res_dst.numel() / E
                               for k in ("user_from_item", "item_from_user")}
            log(f"[zoo] hybrid C={HYBRID_C} on {E} edges: built in {out['build_s'][dt]:.2f} s "
                f"(host); dense coverage user_from_item {out['coverage']['user_from_item']:.4f}, "
                f"item_from_user {out['coverage']['item_from_user']:.4f}")
        hgd = hg.to(dev)
        del hg
        ins = [a.to(dtype) for a in arrays]
        for masked in (False, True):
            drop = TILED_DROP if masked else None
            label = f"hybrid layer {dt} {'hash-masked' if masked else 'unmasked'}"
            card = layer_and_vjp(hybrid_propagate_layer, hgd, *ins, hybrid_masks(hgd, drop))
            again = layer_and_vjp(hybrid_propagate_layer, hgd, *ins, hybrid_masks(hgd, drop))
            check_repeats(card, again, label)
            mask = cpu_mask if masked else None
            if dtype == torch.float32:
                ref = layer_and_vjp(ell_propagate_layer, ell, *(a.cpu() for a in ins), mask)
                err = max(float((a.cpu() - b).abs().max()) for a, b in zip(card, ref))
                check(err <= ELL_ATOL, f"{label}: card vs the CPU's ELL layer {err}")
            else:
                f32 = [a.cpu().float() for a in ins]
                ref = layer_and_vjp(ell_propagate_layer, ell_r, *f32, mask)
                mag = layer_and_vjp(ell_propagate_layer, ell_r, *(a.abs() for a in f32), mask)
                k = HYBRID_BF16_ROUNDINGS + 2 * int(masked)
                err = max(float(((a.cpu().float() - b).abs() / bf16_limit(m, k)).max())
                          for a, b, m in zip(card, ref, mag))
                check(err <= 1.0, f"{label}: {err}x its rounding limit")
                check(all(a.dtype == dtype for a in card), f"{label}: not bf16")
            out["errors"][label] = err
            log(f"[zoo] {label}, forward and VJP: against the CPU's ELL layer "
                f"{'max abs err' if dtype == torch.float32 else 'err/limit'} {err:.3e}; two calls "
                "bitwise equal")
        masks = hybrid_masks(hgd, TILED_DROP)
        with torch.no_grad():
            u, x = ins[:2]
            out["layer_ms"][dt] = kernel_ms(lambda: hybrid_propagate_layer(hgd, u, x), 20,
                                            f"hybrid layer {dt}")["ms"]
            out["layer_ms"][f"{dt} hash-masked"] = kernel_ms(
                lambda: hybrid_propagate_layer(hgd, u, x, masks), 20,
                f"hybrid layer {dt} masked")["ms"]
            for name, direction, x_src, x_dst in (
                    ("user_from_item", hgd.user_from_item, ins[1], ins[0]),
                    ("item_from_user", hgd.item_from_user, ins[0], ins[1])):
                dense = direction.dense
                n_dst, C = dense.shape
                b_ms, b_by = least_ms(2 * n_dst * C * x_src.shape[1],
                                      dense.numel() * dense.element_size(),
                                      str(dtype).removeprefix("torch."))
                hub = x_src.index_select(0, direction.top_src)
                for kind, a, b in (("forward", dense[None], hub[None]),
                                   ("transpose", dense.t()[None], x_dst[None])):
                    t = kernel_ms(lambda: _hub_product(a, b), 20, f"hybrid {name} {kind} {dt}")
                    out["dense"][f"{name} {kind} {dt}"] = dict(
                        ms=t["ms"], events_ms=t["events_ms"], bound_ms=b_ms, bound_by=b_by,
                        shape=[n_dst, C, int(x_src.shape[1])])
                if dtype != torch.float32:
                    continue
                m = masks[0 if name == "user_from_item" else 1].residual
                for side_name, side, xs in (("residual fwd", direction.residual.by_user, x_src),
                                            ("residual bwd", direction.residual.by_item, x_dst)):
                    what = f"ell_gather_reduce hybrid {name} {side_name}"
                    out["errors"][what] = ell_variants(side.table, xs, m, what)
                    nnz = sum(int((bk.w != 0).sum()) for bk in side.buckets)
                    b_ms, b_by = k4_least_ms(nnz, xs, side.table.n_rows)
                    o = xs.new_empty(side.table.n_rows + 1, xs.shape[1])
                    k4 = kernel_ms(lambda: gather_reduce(side.table, xs, out=o), 100, what)
                    apply = kernel_ms(lambda: _apply_side(side, xs), 100, f"{what} apply")
                    out["k4_sides"][f"{name} {side_name}"] = dict(
                        ms=k4["ms"], events_ms=k4["events_ms"], apply_ms=apply["ms"],
                        bound_ms=b_ms, bound_by=b_by, edges=nnz, rows=side.n_rows,
                        buckets=len(side.buckets),
                        **sparse_mm(side, xs, f"hybrid {name} {side_name}"))
        del hgd, masks
    for k, v in out["dense"].items():
        log(f"[time] hybrid dense product {k} {v['shape']}: {v['ms'] * 1e3:.1f} us/call, bound "
            f"{v['bound_ms'] * 1e3:.1f} us ({v['bound_by']})")
    for k, v in out["k4_sides"].items():
        log(f"[time] hybrid K4 {k} (fp32): {v['ms'] * 1e3:.1f} us/call ({v['buckets']} buckets, "
            f"{v['edges']} edges, {v['rows']} rows), bound {v['bound_ms'] * 1e3:.2f} us "
            f"({v['bound_by']}); the side's whole apply {v['apply_ms'] * 1e3:.1f} us; "
            f"torch.sparse.mm (CSR, {v['library_dtype']}) {v['library_ms'] * 1e3:.1f} us")
    log("[time] hybrid layer forward (both directions): " + ", ".join(
        f"{k} {v * 1e3:.1f} us" for k, v in out["layer_ms"].items()))
    return out


def layout_launches(model) -> dict:
    """K4 calls on each side of the model's layout (none for MF and
    UltraGCN)."""
    from gsrs_tpu_torch.ops.ell import EllGraph
    from gsrs_tpu_torch.ops.hybrid import HybridGraph

    ell = model.ell
    if isinstance(ell, EllGraph):  # the ELL and the segment layouts
        return {"user": ell.by_user.table.launches, "item": ell.by_item.table.launches}
    if isinstance(ell, HybridGraph):
        return {f"{name} {kind}": getattr(getattr(ell, name).residual, side).table.launches
                for name in ("user_from_item", "item_from_user")
                for kind, side in (("fwd", "by_user"), ("bwd", "by_item"))}
    return {}


def zoo_cli_runs(root: str) -> dict:
    """Each ZOO_RUNS entry through `gsrs_tpu_torch.cli.main` for one
    epoch (batch 2048, an eval before and after it, the fused Adam
    kernel), counted: K1 once per eval batch, K3 once per leaf per step,
    K4 on every side of an ELL, hybrid or segment layout at least once per
    layer per step each way, and on no side without one; each run's
    checkpoint directory starts empty → {run: results}."""
    import shutil

    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.models.ultragcn import build_ii_constraint

    data_dir = os.path.join(root, CLI_DATASET)
    t0 = time.perf_counter()
    graph = build_graph(load_dataset(data_dir))
    build_ii_constraint(graph, 10, cache_dir=data_dir)  # the runs read this cache
    ii_s = time.perf_counter() - t0
    log(f"[zoo] UltraGCN's item-item top-10 built and cached in {ii_s:.2f} s (host, with the "
        "dataset's load)")
    runs = {}
    for name, extra in ZOO_RUNS.items():
        ckpt = os.path.join(root, f"zoo_{name}")
        shutil.rmtree(ckpt, ignore_errors=True)  # the CSV loggers append to what is there
        argv = ["--data_root", root, "--dataset", CLI_DATASET, "--epochs", "1", "--eval_every",
                "1", "--fused_adam", "pallas", "--tensorboard", "0", "--checkpoint_dir",
                ckpt] + extra
        tr, state = cli_run_counted(argv)
        tr_rows = csv_rows(os.path.join(ckpt, "train_epoch_metrics.csv"))
        va_rows = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))
        launches, wall = tr.zoo_launches, tr.zoo_wall
        model, steps = tr.model, tr.steps_per_epoch
        check(state.epoch == 1, f"{name}: ended at epoch {state.epoch}")
        check([r["epoch"] for r in va_rows] == ["0", "1"], f"{name}: valid CSV {va_rows}")
        loss = float(tr_rows[0]["train_loss"])
        check(np.isfinite(loss), f"{name}: loss {loss}")
        metrics = {k: float(v) for k, v in va_rows[-1].items() if "@" in k}
        check(all(np.isfinite(v) for v in metrics.values()), f"{name}: metrics {metrics}")
        n_leaves = len(list(model.parameters()))
        n_batches = tr.evaluator._users.shape[0]
        check(launches["masked_scores"] == 2 * n_batches,
              f"{name}: masked_scores launched {launches['masked_scores']} times for 2 evals of "
              f"{n_batches} batches")
        check_launched(launches, "exact_topk", 2 * n_batches, name)
        check(launches["fused_adam"] == adam_launches_per_step(model) * steps,
              f"{name}: fused_adam launched {launches['fused_adam']} times for {n_leaves} leaves "
              f"in {steps} steps")
        sides = launches["sides"]
        layers = model.cfg.num_layers
        for side, n in sides.items():
            check(n >= layers * steps, f"{name}: K4 on the {side} side {n} times in {steps} steps")
        if not sides:
            check(launches["ell_gather_reduce"] == 0,
                  f"{name}: K4 launched {launches['ell_gather_reduce']} times without a layout")
        width = int(model.final_embeddings()[1].shape[1])
        runs[name] = dict(
            epoch_s=float(tr_rows[0]["time_sec"]), steps=steps, batch=tr.cfg.train.batch_size,
            eval_s=[float(r["time_sec"]) for r in va_rows], loss=loss, metrics=metrics,
            run_s=wall, launches={k: v for k, v in launches.items() if k != "sides"},
            k4_sides=sides, leaves=n_leaves, width=width,
            layout=type(model.ell).__name__ if model.ell is not None else None,
            profile=profile_steps(tr, state, name))
        log(f"[zoo] {name}: {runs[name]['epoch_s']:.3f} s/epoch ({steps} steps of "
            f"{tr.cfg.train.batch_size}), evals {runs[name]['eval_s']} s (the second warm), run "
            f"{wall:.2f} s; scoring width {width}; {n_leaves} leaves; loss {loss:.5f}; "
            f"{metrics}; launches {launches}")
        del tr, state, model
    return dict(runs=runs, ii_build_s=ii_s)


def profile_steps(tr, state, what: str, steps: int = 5) -> dict:
    """``steps`` more train steps of a zoo run's trainer at its batch under
    torch.profiler, after one warm step (outside the counted run): wall
    and device µs a step, device events a step, the device's busy share
    and the four costliest device rows."""
    from torch.profiler import ProfilerActivity, profile

    from gsrs_tpu_torch.ops.sampling import sample_epoch

    B = tr.cfg.train.batch_size
    g = torch.Generator(device=tr.device).manual_seed(SEED + 11)
    batches = sample_epoch(g, tr.sampler_state, (steps + 1) * B, B,
                           by_edge=getattr(tr.model, "samples_pairs_by_edge", False))
    drop = torch.Generator(device=tr.device).manual_seed(SEED + 12)
    state, _ = tr.run_steps(state, *(b[:1] for b in batches), dropout_generator=drop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_steps(state, *(b[1:] for b in batches), dropout_generator=drop)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / steps
    rows = device_rows(prof)
    device_us = sum(t for _, t, _ in rows) / steps
    top = [[key[:70], t / steps, n / steps] for key, t, n in sorted(rows, key=lambda r: -r[1])[:4]]
    busy = device_us / wall_us if device_us else None
    kernels = sum(n for _, _, n in rows) / steps
    log(f"[profile] {what} step: {wall_us:.1f} us wall under the profiler, {device_us:.1f} us "
        f"device in {kernels:.0f} kernels and copies (busy share "
        f"{busy if busy is None else round(busy, 3)}); top: "
        + "; ".join(f"{k} {t:.1f} us x{n:.0f}" for k, t, n in top))
    return dict(wall_us=wall_us, device_us=device_us, kernels=kernels, busy=busy, top=top)


def cli_run_counted(argv):
    """`gsrs_tpu_torch.cli.main` with every kernel's launches counted
    from just before it; the counts and seconds ride on the returned
    trainer."""
    from gsrs_tpu_torch import cli

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = cli.main(argv)
    torch.cuda.synchronize()
    trainer.zoo_wall = time.perf_counter() - t0
    trainer.zoo_launches = dict(launches_since(before), sides=layout_launches(trainer.model))
    return trainer, state


def zoo_config(name: str, seed: int):
    """The ExperimentConfig of ZOO_CARD_VS_CPU[name] at seed ``seed``."""
    from gsrs_tpu_torch.config import ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        model=ModelConfig(num_layers=3, embedding_dim=64, **ZOO_CARD_VS_CPU[name]),
        train=TrainConfig(batch_size=512, fused_adam="pallas", seed=seed))


def zoo_steps(cfg, data, graph, batches, device, wrong_bias_correction: bool = False):
    """3 `run_steps` of a seeded model of ``cfg`` on ``device`` with the
    host step generator → (losses, parameters, each step's gradients as
    the optimizer read them, all on the CPU). ``wrong_bias_correction``:
    the control, Adam's first-moment correction taken one step late."""
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    seed = cfg.train.seed
    model = build_model(cfg.model, graph, device=device,
                        generator=torch.Generator().manual_seed(seed))
    tr = Trainer(cfg, data, graph, model, run_eval=False, device=device)
    opt, grads = tr.optimizer, []
    step, scalars = opt.step, opt.scalars

    def recording_step(params, state):
        grads.append({k: p.grad.detach().cpu().clone() for k, p in params.items()})
        return step(params, state)

    opt.step = recording_step
    if wrong_bias_correction:
        opt.scalars = lambda count: (scalars(count)[0], scalars(count + 1)[1], scalars(count)[2])
    state, losses = tr.run_steps(tr.init_state(), *batches,
                                 dropout_generator=torch.Generator().manual_seed(seed))
    return losses.cpu(), {k: v.detach().cpu() for k, v in state.params.items()}, grads


def zoo_card_vs_cpu(dev) -> dict:
    """Each ZOO_CARD_VS_CPU configuration (fp32, no edge dropout, the
    hybrid layout at C = 256) on the card and on the CPU takes the same 3
    triplet batches through run_steps with the same host step generator
    (XSimGCL's noise and UltraGCN's negatives are drawn on the host), at
    each of ZOO_SEEDS. Checked: every loss within TRAIN_ATOL of its size;
    the first step's gradients, before any Adam step, within
    ZOO_GRAD_RTOL of each leaf's largest; the parameters after 3 steps
    within ZOO_PARAM_ATOL. The control, UltraGCN pool + sift with K3's
    bias correction one step late on the card, must break that limit →
    {run: readings}."""
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_epoch

    out = {}
    for seed in ZOO_SEEDS:
        data = synthetic.powerlaw(ZOO_SMALL["n_users"], ZOO_SMALL["m_items"],
                                  avg_degree=ZOO_SMALL["avg_degree"], seed=seed, holdout_frac=0.2)
        graph = build_graph(data)
        batches = sample_epoch(torch.Generator().manual_seed(seed),
                               make_sampler_state(data, "cpu"), 3 * 512, 512)
        for name in ZOO_CARD_VS_CPU:
            cfg = zoo_config(name, seed)
            l_card, p_card, g_card = zoo_steps(cfg, data, graph, batches, dev)
            l_cpu, p_cpu, g_cpu = zoo_steps(cfg, data, graph, batches, torch.device("cpu"))
            loss_err = float(((l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1.0)).max())
            grad_err = max(float((g_card[0][k] - g_cpu[0][k]).abs().max()
                                 / g_cpu[0][k].abs().max().clamp(min=1e-30)) for k in p_cpu)
            diffs = {k: (p_card[k] - p_cpu[k]).abs() for k in p_cpu}
            leaf = max(diffs, key=lambda k: float(diffs[k].max()))
            param_err = float(diffs[leaf].max())
            at = int(diffs[leaf].argmax())
            history = [float(g[leaf].flatten()[at]) for g in g_cpu]
            row_max = [float(g[leaf].abs().max()) for g in g_cpu]
            check(loss_err <= TRAIN_ATOL, f"{name} seed {seed}: card vs CPU losses differ by "
                  f"{loss_err} of their size")
            check(grad_err <= ZOO_GRAD_RTOL, f"{name} seed {seed}: card vs CPU first gradients "
                  f"differ by {grad_err} of the leaf's largest")
            check(param_err <= ZOO_PARAM_ATOL, f"{name} seed {seed}: card vs CPU parameters "
                  f"differ by {param_err}")
            out[f"{name} seed {seed}"] = dict(loss=loss_err, grad=grad_err, params=param_err,
                                             leaf=leaf, grads_there=history,
                                             leaf_max_grads=row_max)
            log(f"[zoo] {name} seed {seed}: card vs CPU, 3 steps at batch 512 on {data.n_users} x "
                f"{data.m_items}: max loss diff {loss_err:.2e} of its size; first gradients "
                f"{grad_err:.2e} of the leaf's largest (limit {ZOO_GRAD_RTOL}); parameters "
                f"{param_err:.2e} (limit {ZOO_PARAM_ATOL}), at {leaf}[{at}] whose CPU gradients "
                f"were {', '.join(f'{g:.3e}' for g in history)} (the leaf's largest "
                f"{', '.join(f'{g:.3e}' for g in row_max)})")
        if seed == SEED:
            cfg = zoo_config("ultragcn_pool_sift", seed)
            _, p_bad, _ = zoo_steps(cfg, data, graph, batches, dev, wrong_bias_correction=True)
            _, p_cpu, _ = zoo_steps(cfg, data, graph, batches, torch.device("cpu"))
            control = max(float((p_bad[k] - p_cpu[k]).abs().max()) for k in p_cpu)
            check(control > ZOO_PARAM_ATOL, f"the control (K3's bias correction one step late) "
                  f"passed the parameter check: {control}")
            out["control ultragcn_pool_sift"] = dict(params=control)
            log(f"[zoo] control, ultragcn_pool_sift with K3's bias correction one step late on "
                f"the card: parameters differ from the CPU's by {control:.2e} (limit "
                f"{ZOO_PARAM_ATOL})")
    return out


def time_k1_at(dev, B: int, d: int, m: int, what: str, bitplane: bool = False,
               block_m: int = 4096) -> dict:
    """K1 (K2 with ``bitplane``: m padded to whole blocks of ``block_m``) on
    random (B, d) users, (m, d) items and their bitset words, held against
    its plain version on them (`compare`), by device time beside its
    bound, the plain version and `torch.matmul`."""
    from gsrs_tpu_torch.ops.scoring import masked_scores, masked_scores_reference

    rows = -(-m // block_m) * block_m if bitplane else m
    W = rows // 32 if bitplane else -(-m // 32)
    name = "masked_scores_bitplane" if bitplane else "masked_scores"
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    u = torch.randn(B, d, device=dev, generator=g)
    it = torch.randn(rows, d, device=dev, generator=g)
    bits = torch.randint(-2**31, 2**31, (B, W), device=dev, generator=g,
                         dtype=torch.int64).to(torch.int32)
    kw = dict(bitplane=bitplane, block_m=block_m)
    err = compare(masked_scores(u, it, bits, **kw), masked_scores_reference(u, it, bits, **kw),
                  f"{name} {what}")
    torch.cuda.empty_cache()
    b_ms, b_by = k1_least_ms(B, d, rows, W)
    t = {k: kernel_ms(fn, reps, f"{name} {what} {k}")["ms"] for k, fn, reps in (
        ("ms", lambda: masked_scores(u, it, bits, **kw), 50),
        ("plain_ms", lambda: masked_scores_reference(u, it, bits, **kw), 10),
        ("library_ms", lambda: torch.matmul(u, it.T), 50))}
    log(f"[time] {name} {what}, B={B} d={d} m={rows}: {t['ms'] * 1e3:.1f} us, bound "
        f"{b_ms * 1e3:.1f} us ({b_by}), plain {t['plain_ms'] * 1e3:.1f} us, torch.matmul "
        f"{t['library_ms'] * 1e3:.1f} us; max abs error against the plain version {err:.3e}")
    return dict(t, bound_ms=b_ms, bound_by=b_by, shape=[B, d, rows], max_abs_err=err)


def time_k1_d256(dev) -> dict:
    """K1 at NGCF's eval shape (B = 2048, d = 256, m = 40,981)."""
    return time_k1_at(dev, 2048, ZOO_D, GOWALLA_SHAPE["m_items"], "NGCF's eval")


def zoo_phase(dev, data, ell, out_dir: str) -> dict:
    """The graph zoo on the stand-in at full width: the segment and hybrid
    layers' checks and times, each ZOO_RUNS configuration through the CLI
    (counted), and each on the card against the CPU on a small graph."""
    seg = segment_checks(dev, data, ell)
    hyb = hybrid_checks(dev, data, ell)
    k1 = time_k1_d256(dev)
    vs_cpu = zoo_card_vs_cpu(dev)
    cli_runs = zoo_cli_runs(out_dir)
    launches = {k: sum(r["launches"][k] for r in cli_runs["runs"].values())
                for k in ("masked_scores", "ell_gather_reduce", "fused_adam", "exact_topk",
                          "gather_rows_grad")}
    return dict(segment=seg, hybrid=hyb, k1_d256=k1, card_vs_cpu=vs_cpu,
                launches=launches, **cli_runs)


# ---------------------------------------------------------------- seq phase


def seq_trainer(kind: str, bf16: bool, data, seed: int, device):
    """A `SeqTrainer` of a seeded sequential model at the CLI's widths
    (dim 64, hidden 64, 2 blocks, 1 head, dropout 0.2; max_len
    SEQ_SMALL_LEN) at batch SEQ_SMALL_BATCH."""
    from gsrs_tpu_torch.models.registry import build_seq_model
    from gsrs_tpu_torch.train.seq_trainer import SeqTrainer

    model = build_seq_model(kind, data.m_items, max_len=SEQ_SMALL_LEN, bf16=bf16, device=device,
                            generator=torch.Generator().manual_seed(seed))
    return SeqTrainer(model, data, batch_size=SEQ_SMALL_BATCH, seed=seed,
                      topks=SEQ_VS_CPU_TOPKS, device=device)


def seq_steps(kind, bf16, data, batches, draws, seed, device, control=None):
    """3 `run_steps` of a seeded sequential model on ``device`` with draws
    made on the host → (losses, parameters, the first step's gradients as
    Adam read them, the trainer), on the CPU. On the CPU the steps run
    under `deterministic_on_cpu`, so the reference repeats bit for bit.
    ``control``: "late_bias"
    starts Adam's step count at 1 (its bias correction one step late),
    "erf_gelu" gives BERT4Rec torch's exact GELU ("fp32" is the caller's
    bf16=False)."""
    from unittest import mock

    from gsrs_tpu_torch.models import bert4rec

    tr = seq_trainer(kind, bf16, data, seed, device)
    state = tr.init_state()
    grads = []
    step = tr.optimizer.step

    def recording_step(params, opt_state):
        if not grads:
            grads.append({k: p.grad.detach().cpu().clone() for k, p in params.items()})
        return step(params, opt_state)

    tr.optimizer.step = recording_step
    if control == "late_bias":
        for p in state.params.values():
            state.opt_state.optimizer.state[p] = {
                "step": torch.tensor(1.0, device=p.device), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
    patch = contextlib.nullcontext()
    if control == "erf_gelu":
        patch = mock.patch.object(bert4rec, "gelu_tanh", torch.nn.functional.gelu)
    with patch, deterministic_on_cpu(device):
        state, losses = tr.run_steps(state, batches, draws)
    return (losses.cpu(), {k: v.detach().cpu() for k, v in state.params.items()}, grads[0],
            tr)


@contextlib.contextmanager
def deterministic_on_cpu(device: torch.device):
    """On the CPU, `torch.use_deterministic_algorithms(True)` for the
    block, the previous setting restored after it: the backward of a
    gather (``index_put_`` with accumulate) then adds in one order, not in
    the threads' order, so two runs of a card-vs-CPU check's CPU reference
    (at one thread count) give the same bits. The card's side is left as
    it runs."""
    if device.type != "cpu":
        yield
        return
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)


def seq_readings(card, cpu) -> dict:
    """Card against CPU after 3 steps: the largest loss difference over
    the loss's size, the first gradients' over each leaf's largest, the
    parameters' (and the share of parameters over SEQ_PARAM_ATOL)."""
    (l_card, p_card, g_card), (l_cpu, p_cpu, g_cpu) = card, cpu
    loss = float(((l_card - l_cpu).abs() / l_cpu.abs().clamp(min=1.0)).max())
    grad = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30))
               for k in g_cpu)
    diffs = {k: (p_card[k] - p_cpu[k]).abs() for k in p_cpu}
    leaf = max(diffs, key=lambda k: float(diffs[k].max()))
    n = sum(d.numel() for d in diffs.values())
    over = sum(int((d > SEQ_PARAM_ATOL).sum()) for d in diffs.values())
    return dict(loss=loss, grad=grad, params=float(diffs[leaf].max()), leaf=leaf,
                share_over=over / n)


def seq_card_vs_cpu(dev) -> dict:
    """Each SEQ_VS_CPU configuration on the card and on the CPU takes the
    same 3 batches (the CPU trainer's first epoch batches) with the same
    draws (made on the host), at each of ZOO_SEEDS, on a 1,500 × 2,000
    stand-in's sequences (max_len SEQ_SMALL_LEN, batch SEQ_SMALL_BATCH).
    Checked: the losses, the first step's gradients before Adam, and the
    parameters after the 3 steps, each within its limit (SEQ_LIMITS, fp32
    and bf16 apart); then the eval of the CPU's final parameters on both
    (fp32: metrics within METRIC_ATOL). The SEQ_CONTROLS must each break
    the limit they name."""
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.data.sequences import sequences_from_interactions

    out, fails = {}, []
    cpu = torch.device("cpu")
    for seed in ZOO_SEEDS:
        inter = synthetic.powerlaw(ZOO_SMALL["n_users"], ZOO_SMALL["m_items"],
                                   avg_degree=ZOO_SMALL["avg_degree"], seed=seed, holdout_frac=0.2)
        data = sequences_from_interactions(inter, max_len=SEQ_SMALL_LEN)
        for name, (kind, bf16) in SEQ_VS_CPU.items():
            host = seq_trainer(kind, bf16, data, seed, cpu)  # the batches and draws
            batches = host.epoch_batches(0)[:3]
            g = torch.Generator().manual_seed(seed + 100)
            draws = [host.draw_step(b, g) for b in batches]
            card = seq_steps(kind, bf16, data, batches, draws, seed, dev)
            on_cpu = seq_steps(kind, bf16, data, batches, draws, seed, cpu)
            r = seq_readings(card[:3], on_cpu[:3])
            lim = SEQ_LIMITS["bf16" if bf16 else "fp32"]
            if not bf16:  # the eval of the same (the CPU's) parameters on both
                card[3].model.load_state_dict(on_cpu[1])
                on_card, on_host = card[3].evaluate(), on_cpu[3].evaluate()
                r["metrics"] = max(abs(on_card[k] - on_host[k]) for k in on_host)
                r["recall_wide"] = on_host[f"recall@{SEQ_VS_CPU_TOPKS[-1]}"]
                if r["metrics"] > METRIC_ATOL or r["recall_wide"] == 0:
                    fails.append(f"{name} seed {seed}: eval {on_card} vs {on_host}")
            for key in ("loss", "grad", "params"):
                if r[key] > lim[key]:
                    fails.append(f"{name} seed {seed}: {key} {r[key]:.3e} > {lim[key]}")
            if r["share_over"] > lim["share_over"]:
                fails.append(f"{name} seed {seed}: share of parameters over {SEQ_PARAM_ATOL} "
                             f"{r['share_over']:.3e} > {lim['share_over']}")
            out[f"{name} seed {seed}"] = r
            log(f"[seq] {name} seed {seed}: card vs CPU, 3 steps at batch {SEQ_SMALL_BATCH} "
                f"on {len(data.train_seqs)} sequences x {data.m_items} items: loss {r['loss']:.2e} "
                f"of its size, first gradients {r['grad']:.2e} of the leaf's largest, parameters "
                f"{r['params']:.2e} (at {r['leaf']}; share over {SEQ_PARAM_ATOL} "
                f"{r['share_over']:.2e}); eval max diff {r.get('metrics')}")
            if seed == SEED:
                for control, key in SEQ_CONTROLS.get(name, ()):
                    bad = seq_steps(kind, bf16 and control != "fp32", data, batches, draws,
                                    seed, dev, control)
                    rc = seq_readings(bad[:3], on_cpu[:3])
                    out[f"control {name} {control}"] = rc
                    if key is not None and rc[key] <= lim[key]:
                        fails.append(f"the control {control} on {name} passed the {key} check: "
                                     f"{rc[key]}")
                    log(f"[seq] control {control} on {name} on the card: loss {rc['loss']:.2e}, "
                        f"gradients {rc['grad']:.2e}, parameters {rc['params']:.2e}, share over "
                        f"{SEQ_PARAM_ATOL} {rc['share_over']:.2e} (limits {lim})")
    check(not fails, "card vs CPU: " + "; ".join(fails))
    return out


def seq_profile_steps(tr, state, what: str, steps: int = 5) -> dict:
    """``steps`` more train steps of a seq CLI run's trainer under
    torch.profiler after one warm step (outside the counted run), on the
    trainer's next epoch's batches and draws: wall and device µs a step,
    device events a step, the busy share and the four costliest rows."""
    from torch.profiler import ProfilerActivity, profile

    batches = tr.epoch_batches(state.epoch)[:steps + 1]
    draws = [tr.draw_step(b, tr.step_generator(state.epoch, i)) for i, b in enumerate(batches)]
    state, _ = tr.run_steps(state, batches[:1], draws[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_steps(state, batches[1:], draws[1:])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / steps
    rows = device_rows(prof)
    device_us = sum(t for _, t, _ in rows) / steps
    top = [[key[:70], t / steps, n / steps] for key, t, n in sorted(rows, key=lambda r: -r[1])[:4]]
    busy = device_us / wall_us if device_us else None
    kernels = sum(n for _, _, n in rows) / steps
    log(f"[profile] {what} step: {wall_us:.1f} us wall under the profiler, {device_us:.1f} us "
        f"device in {kernels:.0f} kernels and copies (busy share "
        f"{busy if busy is None else round(busy, 3)}); top: "
        + "; ".join(f"{k} {t:.1f} us x{n:.0f}" for k, t, n in top))
    return dict(wall_us=wall_us, device_us=device_us, kernels=kernels, busy=busy, top=top)


def seq_cli_run(argv, what: str):
    """`gsrs_tpu_torch.seq_cli.main` counted → (trainer, state, launches,
    seconds)."""
    from gsrs_tpu_torch import seq_cli

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer, state = seq_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_since(before)
    log(f"[seq] {what}: {wall:.2f} s, epoch {state.epoch}, launches {launches}")
    return trainer, state, launches, wall


def seq_cli_runs(root: str) -> dict:
    """Each SEQ_RUNS entry through `seq_cli.main` on the stand-in at the
    CLI's full width for SEQ_EPOCHS epochs, an eval every epoch, from an
    emptied checkpoint directory, counted: K1 once per eval batch
    (⌈N/256⌉ an eval), no K3 or K4; the CSVs, checkpoint listing and
    model_meta.json; then, uncounted, a warm eval, the SASRec resume
    check (`seq_resume_check`) and 5 profiled steps → ({run: results},
    the resume's results, the SASRec run's directory)."""
    import shutil

    runs = {}
    for name, extra in SEQ_RUNS.items():
        ckpt = os.path.join(root, f"seq_{name}")
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = ["--data_root", root, "--dataset", CLI_DATASET, "--epochs", str(SEQ_EPOCHS),
                "--eval_every", "1", "--checkpoint_dir", ckpt] + extra
        tr, state, launches, wall = seq_cli_run(argv, f"{name}, {SEQ_EPOCHS} epochs")
        check(state.epoch == SEQ_EPOCHS, f"{name}: ended at epoch {state.epoch}")
        tr_rows = csv_rows(os.path.join(ckpt, "train_epoch_metrics.csv"))
        va_rows = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))
        epochs = [str(e) for e in range(1, SEQ_EPOCHS + 1)]
        check([r["epoch"] for r in tr_rows] == epochs, f"{name}: train CSV {tr_rows}")
        check([r["epoch"] for r in va_rows] == ["0"] + epochs, f"{name}: valid CSV {va_rows}")
        losses = [float(r["train_loss"]) for r in tr_rows]
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        metrics = {k: float(v) for k, v in va_rows[-1].items() if "@" in k}
        check(all(np.isfinite(v) for v in metrics.values()), f"{name}: metrics {metrics}")
        listing = sorted(os.listdir(ckpt))
        bests = [n for n in listing if n.startswith("best-epoch")]
        check(set(listing) - set(bests) == {"last", "model_meta.json",
                                            "train_epoch_metrics.csv",
                                            "valid_epoch_metrics.csv"},
              f"{name}: checkpoint listing {listing}")
        with open(os.path.join(ckpt, "model_meta.json")) as f:
            meta = json.load(f)
        check(meta["kind"] == tr.model.__class__.__name__.lower() and meta["dim"] == 64
              and meta["blocks"] == 2 and meta["max_len"] == 50, f"{name}: meta {meta}")
        n_batches = tr._eval_seqs.shape[0]
        check(n_batches == -(-tr.n_eval // 256), f"{name}: {n_batches} eval batches")
        evals = len(va_rows)
        check(launches["masked_scores"] == evals * n_batches,
              f"{name}: masked_scores launched {launches['masked_scores']} times for {evals} "
              f"evals of {n_batches} batches")
        check_launched(launches, "exact_topk", evals * n_batches, name)
        check(launches["ell_gather_reduce"] == launches["fused_adam"] == 0,
              f"{name}: K3/K4 launched on the seq path: {launches}")
        # the loss's positives and negatives, and the transformers' input gather (GRU4Rec's
        # input gather is its own)
        check_launched(launches, "gather_rows_grad",
                       SEQ_GATHERS[name] * SEQ_EPOCHS * tr.steps_per_epoch, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.evaluate(state)
        torch.cuda.synchronize()
        warm_eval_s = time.perf_counter() - t0
        runs[name] = dict(
            epoch_s=[float(r["time_sec"]) for r in tr_rows], steps=tr.steps_per_epoch,
            sequences=tr.n_train, eval_batches=n_batches, warm_eval_s=warm_eval_s, run_s=wall,
            losses=losses, metrics=metrics, launches=launches, bests=bests)
        log(f"[seq] {name}: {runs[name]['epoch_s']} s/epoch ({tr.steps_per_epoch} steps of "
            f"{tr.batch_size} over {tr.n_train} sequences), warm eval {warm_eval_s:.3f} s "
            f"({n_batches} batches), run {wall:.2f} s; losses {losses}; {metrics}")
        if name == "sasrec":  # before the profiled steps move its parameters
            resume = seq_resume_check(dict(trainer=tr, state=state, ckpt=ckpt, argv=argv))
            sasrec_ckpt = ckpt
        runs[name]["profile"] = seq_profile_steps(tr, state, f"seq {name}")
        del tr, state
    return runs, resume, sasrec_ckpt


def seq_resume_check(first: dict) -> dict:
    """``--resume`` to SEQ_EPOCHS + 1 epochs from the SASRec run's
    directory must start at its last epoch and end bitwise equal to the
    first run's trainer taking that epoch in memory."""
    from gsrs_tpu_torch.train.checkpoint import CheckpointManager

    argv = [a if a != str(SEQ_EPOCHS) else str(SEQ_EPOCHS + 1) for a in first["argv"]]
    tr2, s2, launches, wall = seq_cli_run(argv + ["--resume"], "sasrec resume")
    ckpt = first["ckpt"]
    rows = csv_rows(os.path.join(ckpt, "train_epoch_metrics.csv"))
    check([r["epoch"] for r in rows] == [str(e) for e in range(1, SEQ_EPOCHS + 2)],
          f"train CSV after resume {rows}")
    check(s2.epoch == SEQ_EPOCHS + 1, f"the resumed run ended at epoch {s2.epoch}")
    n_batches = tr2._eval_seqs.shape[0]
    check(launches["masked_scores"] == 2 * n_batches,  # the eval at the resume epoch, the final
          f"the resumed run launched masked_scores {launches['masked_scores']} times")
    check_launched(launches, "exact_topk", 2 * n_batches, "the resumed SASRec run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s_full, _ = first["trainer"].train_epoch(first["state"])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    resumed = CheckpointManager(ckpt).restore(os.path.join(ckpt, "last"))["params"]
    whole = {k: p.detach().cpu() for k, p in s_full.params.items()}
    diff = max(float((resumed[k] - whole[k]).abs().max()) for k in whole)
    bitwise = all(torch.equal(resumed[k], whole[k]) for k in whole)
    check(bitwise, f"resumed vs uninterrupted SASRec parameters differ (max {diff})")
    log(f"[seq] resume: epoch {SEQ_EPOCHS} → {SEQ_EPOCHS + 1} from the checkpoint, against the "
        f"first run's trainer taking it in memory ({epoch_s:.2f} s): bitwise equal")
    return dict(run_s=wall, launches=launches, bitwise=bitwise, continued_epoch_s=epoch_s)


def seq_serving(dev, ckpt: str, root: str) -> dict:
    """``serve_seq export`` of the SASRec run, then ``serve_seq query`` of
    one session, counted (K1 once); its top-k against the plain version on
    the same card; then request latency of a `SeqRetriever` at 1 and 64
    sessions (p50 of SEQ_REQUESTS each) and K1's time at those shapes."""
    from gsrs_tpu_torch import serve_seq
    from gsrs_tpu_torch.ops.bitset import bitset_to_tensor
    from gsrs_tpu_torch.ops.scoring import masked_scores, masked_scores_reference

    art = os.path.join(root, "seq_sasrec.npz")
    t0 = time.perf_counter()
    _, text = run_quiet(serve_seq.main, ["export", "--checkpoint_dir", ckpt, "--out", art])
    export_s = time.perf_counter() - t0
    log(text.strip())
    r = serve_seq.load_seq_retriever(art)
    rng = np.random.default_rng(SEED)
    session = [int(i) for i in rng.choice(r.m_items, 12, replace=False)]
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, text = run_quiet(serve_seq.main, ["query", "--artifact", art, "--session",
                                         *map(str, session), "--k", str(K)])
    query_s = time.perf_counter() - t0
    launches = launches_since(before)
    check(launches["masked_scores"] == 1, f"query launched masked_scores "
          f"{launches['masked_scores']} times")
    check_launched(launches, "exact_topk", 1, "serve_seq query")
    printed = [int(p.split(":")[0]) for p in text.strip().split(": ", 1)[1].split()]
    check(not set(printed) & set(session), "a session item came back")
    seqs, seen = r._encode_sessions([session])
    with torch.no_grad():
        q = r.model.user_representations(torch.from_numpy(seqs).long().to(dev)).contiguous()
        plain = masked_scores_reference(q, r.model.catalog(), bitset_to_tensor(seen, dev))
    ref_top = torch.sort(plain, dim=1, descending=True, stable=True)[1][:, :K]
    same_topk([printed], plain, ref_top.cpu().numpy(), "serve_seq query vs plain top-k")
    log(f"[seq] serve_seq export {export_s:.2f} s, query {query_s:.2f} s: top-{K} equal to the "
        "plain version's on the card")

    sessions = [[int(i) for i in rng.choice(r.m_items, int(n), replace=False)]
                for n in rng.integers(3, 80, 64)]
    p50, k1 = {}, {}
    for n in (1, 64):
        r.batch_size = n
        r.recommend(sessions[:n], k=K)  # warm
        times = []
        for _ in range(SEQ_REQUESTS):
            t0 = time.perf_counter()
            r.recommend(sessions[:n], k=K)
            times.append(time.perf_counter() - t0)
        p50[n] = float(np.median(times)) * 1e3
        seqs, seen = r._encode_sessions(sessions[:n])
        with torch.no_grad():
            q = r.model.user_representations(torch.from_numpy(seqs).long().to(dev)).contiguous()
        items, rows = r.model.catalog(), bitset_to_tensor(seen, dev)
        b_ms, b_by = k1_least_ms(n, q.shape[1], items.shape[0], rows.shape[1])
        k1[n] = dict(bound_ms=b_ms, bound_by=b_by, **{key: kernel_ms(
            fn, reps, f"masked_scores B={n} (seq)")["ms"] for key, fn, reps in (
                ("ms", lambda: masked_scores(q, items, rows), 100),
                ("plain_ms", lambda: masked_scores_reference(q, items, rows), 30),
                ("library_ms", lambda: torch.matmul(q, items.T), 100))})
        log(f"[seq] request p50 at {n} session(s): {p50[n]:.3f} ms; K1 {k1[n]['ms'] * 1e3:.1f} us "
            f"(bound {b_ms * 1e3:.1f} us, {b_by}; plain {k1[n]['plain_ms'] * 1e3:.1f}; "
            f"torch.matmul {k1[n]['library_ms'] * 1e3:.1f})")
    return dict(export_s=export_s, query_s=query_s, launches=launches, p50_ms=p50, k1=k1)


def seq_learning_check() -> dict:
    """SASRec through `seq_cli.main` on the cluster-Markov data
    (``--synthetic``, the CLI's widths, lr 3e-3 as JAX's learnability test,
    SEQ_LEARN_EPOCHS epochs): recall@10 above twice its first value and
    above 0.2, the bound of tests/test_sequential.py (chance 0.05)."""
    from gsrs_tpu_torch import seq_cli

    argv = ["--synthetic", "--lr", "3e-3", "--epochs", str(SEQ_LEARN_EPOCHS), "--eval_every",
            str(SEQ_LEARN_EPOCHS), "--topks", "[10]"]
    t0 = time.perf_counter()
    (tr, state), text = run_quiet(seq_cli.main, argv)
    wall = time.perf_counter() - t0
    evals = [ln for ln in text.splitlines() if ln.startswith("[eval")]
    first, last = (float(ln.split("recall@10=")[1].split()[0]) for ln in (evals[0], evals[-1]))
    check(last > max(2 * first, 0.2), f"SASRec on Markov data: recall@10 {first} → {last}")
    log(f"[seq] learning check: SASRec recall@10 {first:.4f} → {last:.4f} after "
        f"{SEQ_LEARN_EPOCHS} epochs on {tr.data.name} ({wall:.2f} s)")
    return dict(first=first, last=last, run_s=wall)


def seq_phase(dev, out_dir: str) -> dict:
    """The sequential family on the card: card against CPU, each model
    through `seq_cli` at full width on the stand-in (counted), the SASRec
    resume, serve_seq export and query, the learning check, and the
    native host sampler's build."""
    from gsrs_tpu_torch.native import load_native_sampler

    vs_cpu = seq_card_vs_cpu(dev)
    runs, resume, sasrec_ckpt = seq_cli_runs(out_dir)
    serving = seq_serving(dev, sasrec_ckpt, out_dir)
    learn = seq_learning_check()
    t0 = time.perf_counter()
    native = load_native_sampler()
    native_s = time.perf_counter() - t0
    check(native is not None, "the native host sampler did not build")
    log(f"[seq] native host sampler built and loaded in {native_s:.2f} s")
    launches = {k: sum(r["launches"][k] for r in (*runs.values(), resume, serving))
                for k in ("masked_scores", "exact_topk", "gather_rows_grad")}
    return dict(card_vs_cpu=vs_cpu, runs=runs, resume=resume, serving=serving, learning=learn, native_build_s=native_s,
                launches=launches)


# ---------------------------------------------------------------- hits phase


def chance_recall(data, k: int) -> float:
    """A random ranker's expected recall@k: the mean over the test users
    of k over the items each has not seen in training."""
    degree = np.bincount(data.train_users, minlength=data.n_users)
    users = data.test_users()
    return float(np.mean(k / (data.m_items - degree[users])))


def random_test_split(data, seed: int):
    """``data`` with each test user's held-out item replaced by an item the
    user has not seen, drawn uniformly by a seeded numpy generator: the
    control, on which a trained model reads about chance."""
    rng = np.random.default_rng(seed)
    users, m = data.test_users(), data.m_items
    seen = data.train_users * m + data.train_items
    items = rng.integers(0, m, users.size)
    while True:
        again = np.isin(users * m + items, seen)
        if not again.any():
            break
        items[again] = rng.integers(0, m, int(again.sum()))
    return dataclasses.replace(data, test_dict={int(u): np.array([i], dtype=np.int64)
                                                for u, i in zip(users, items)})


def hits_argv(root: str) -> list:
    return ["--data_root", root, "--dataset", HITS_DATASET, "--model", "lgn", "--spmm", "ell",
            "--recdim", "64", "--layer", "3", "--bpr_batch", "2048", "--lr", str(HITS_LR),
            "--epochs", str(HITS_EPOCHS), "--eval_every", "1", "--topk_method", "exact",
            "--fused_adam", "pallas", "--tensorboard", "0",
            "--checkpoint_dir", os.path.join(root, HITS_CKPT)]


def hits_layouts(trainer, plain: torch.Tensor) -> dict:
    """Retrievers of the hits run's model in the natural
    (``use_pallas_scoring="off"``) and the bit-plane layout ("on") over
    every test user: the same top-20 ids, boundary swaps aside, with K1
    launched on the natural side only and K2 on the bit-plane side only."""
    from gsrs_tpu_torch.serve import Retriever, retriever_from_model

    live = retriever_from_model(trainer.model, trainer.data, batch_size=BATCH)
    users = trainer.data.test_users()
    tops, launches = {}, {}
    for mode in ("off", "on"):
        r = Retriever(live.user_emb, live.item_emb, live.seen_bitset, batch_size=BATCH,
                      use_pallas_scoring=mode, device=live.device)
        before = launch_counts()
        tops[mode] = r.recommend(users, k=K)[0]
        launches[mode] = launches_since(before)
    check(launches["off"]["masked_scores"] > 0 and launches["off"]["masked_scores_bitplane"] == 0
          and launches["on"]["masked_scores_bitplane"] > 0
          and launches["on"]["masked_scores"] == 0,
          f"hits Retrievers: launches natural {launches['off']}, bit-plane {launches['on']}")
    check(bool((tops["off"] >= 0).all()), "a test user has fewer than K unseen items")
    same_topk(tops["on"], plain, tops["off"], f"hits bit-plane vs natural Retriever top-{K}")
    log(f"[hits] the bit-plane and natural Retrievers' top-{K} of {users.size} test users equal, "
        f"boundary swaps aside; launches {launches}")
    return launches


def hits_phase(dev, out_dir: str) -> dict:
    """LightGCN at full width (3 layers, dim 64, ELL fp32, exact top-k, the
    fused Adam kernel) through `cli.main` on the clustered set of
    HITS_SHAPE for HITS_EPOCHS epochs with an eval each, counted: K4 on
    both sides, K3 once a step, K1 once an eval batch; its last recall@20
    at least HITS_FLOOR_VS_CHANCE times chance, and the same parameters on
    a random-item test split (the control) below that floor; the card
    against the CPU (`hits_card_vs_cpu`); the three top-k methods
    (`topk_method_checks`, threshold at least the floor); the natural and
    bit-plane Retrievers (`hits_layouts`). The tools phase (bench_eval,
    eval_checkpoint) and the mesh phase (its sharded eval) hold their
    checks on this run's checkpoint too."""
    import shutil

    from gsrs_tpu_torch import cli
    from gsrs_tpu_torch.data import synthetic
    from gsrs_tpu_torch.train.evaluator import Evaluator

    data_dir, ckpt = (os.path.join(out_dir, d) for d in (HITS_DATASET, HITS_CKPT))
    for d in (data_dir, ckpt):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    write_cli_dataset(synthetic.clustered(**HITS_SHAPE, seed=SEED), data_dir)
    data_s = time.perf_counter() - t0

    before = launch_counts()
    (tr, state), _, launches, run_s = counted(cli.main, hits_argv(out_dir))
    data, model = tr.data, tr.model
    chance = chance_recall(data, K)
    floor = HITS_FLOOR_VS_CHANCE * chance
    rows = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))
    steps = HITS_EPOCHS * tr.steps_per_epoch
    n_batches = tr.evaluator._users.shape[0]
    log(f"[hits] {data.n_users} users x {data.m_items} items, {data.train_size} train edges "
        f"(degree {data.train_size / data.n_users:.2f}), {len(data.test_dict)} test users; written "
        f"in {data_s:.2f} s; chance recall@{K} {chance:.6f}, floor {floor:.6f}; the run "
        f"{run_s:.2f} s, {steps} steps of 2048, launches {launches}")
    for r in rows:
        log(f"[hits] eval at epoch {r['epoch']}: recall@{K} {r[f'recall@{K}']}, ndcg@{K} "
            f"{r[f'ndcg@{K}']}")
    check(state.epoch == HITS_EPOCHS, f"the hits run ended at epoch {state.epoch}")
    check([r["epoch"] for r in rows] == [str(e) for e in range(HITS_EPOCHS + 1)],
          f"hits valid CSV {rows}")
    check(launches["fused_adam"] == adam_launches_per_step(model) * steps,
          f"hits: fused_adam launched {launches['fused_adam']} times in {steps} steps")
    check(launches["masked_scores"] == len(rows) * n_batches
          and launches["masked_scores_bitplane"] == 0,
          f"hits: K1/K2 launched {launches} for {len(rows)} evals of {n_batches} batches")
    check_launched(launches, "exact_topk", len(rows) * n_batches, "hits")
    for side in (model.ell.by_user, model.ell.by_item):  # each layer's forward and backward
        check(side.table.launches >= 2 * model.cfg.num_layers * steps,
              f"hits: K4 launched {side.table.launches} times on a side in {steps} steps")
    last = {k: float(v) for k, v in rows[-1].items() if "@" in k}
    check(last[f"recall@{K}"] >= floor, f"hits: the run's last recall@{K} {last} < floor {floor}")

    control = Evaluator(random_test_split(data, SEED + 1), model, tr.cfg.eval,
                        train_bitset=tr.sampler_state.train_bitset, device=dev).run()
    check(control[f"recall@{K}"] < floor,
          f"hits: the random-item control reads recall@{K} {control} >= floor {floor}")
    log(f"[hits] control (each test item replaced by a random unseen item): {control}")

    vs_cpu = hits_card_vs_cpu(tr, state, floor)
    methods = topk_method_checks(tr)
    check(methods["metrics"]["threshold"][f"recall@{K}"] >= floor,
          f"hits: threshold's recall@{K} {methods['metrics']['threshold']} < floor {floor}")
    layouts = hits_layouts(tr, vs_cpu.pop("plain_scores"))
    phase_launches = launches_since(before)
    torch.cuda.empty_cache()
    return dict(dataset=data_dir, ckpt=ckpt, shape=HITS_SHAPE, train_edges=data.train_size,
                test_users=len(data.test_dict), chance=chance, floor=floor, last=last,
                control=control, card_vs_cpu=vs_cpu, topk_methods=methods,
                layout_launches=layouts, run_launches=launches, launches=phase_launches,
                run_s=run_s, write_dataset_s=data_s,
                epoch_s=[float(r["time_sec"]) for r in csv_rows(
                    os.path.join(ckpt, "train_epoch_metrics.csv"))])


# --------------------------------------------------------------- tools phase
# The JAX package's user tools, ported (`gsrs_tpu_torch.tools`), each through its `main` on the
# card, on what the CLI, zoo, seq and hits phases left under the smoke's directory: the
# stand-in's dataset directory, the CLI run's pop-gate checkpoint (bf16, i2i, approx top-k), the
# zoo's lgn_segment run (fp32, exact top-k), the seq phase's SASRec run (exact top-k, resumed)
# and the hits phase's clustered dataset and run (fp32, exact top-k)
TOOLS_GRAPH_CKPT = "zoo_lgn_segment"
TOOLS_SEQ_CKPT = "seq_sasrec"
TOOLS_SEQ_EVAL = ["--testbatch", "256", "--topks", "[10,20]"]  # seq_cli's eval batch and top-k
TOOLS_SPMM = ["--batch", "2048", "8192", "--hybrid_cols", "8192", "--tiled", "64:2048",
              "--timed_epochs", "1"]
AMAZON_SHAPE = dict(B=2048, d=64, m=91599)  # bench_eval's amazon-book-scale eval batch
GATE_ATOL = 1e-5  # the pop gate on the card against the CPU
# bench_scaling: its default shapes (100k x 50k, batch 8192, bf16) on 1, 2 and 4 gloo ranks
# sharing the card; the steps cut from its 30, and bench_seq_markov's epochs from its 60, for
# the smoke's time (with 5 steps and 60 epochs a whole smoke took 990 s on an NVIDIA H100 80GB
# HBM3 at 700 W, against the 1200 s a run is allowed)
SCALING_ARGS = ["--devices", "1", "2", "4", "--dist_backend", "gloo", "--steps", "3"]
SWEEP_ARGS = ["--epochs", "2", "--eval_every", "1", "--lambdas", "0.1", "0.2", "--batch", "8192"]
PROFILE_ARGS = ["--epochs", "1", "--bpr_batch", "8192", "--eval"]
STANDIN_ARGS = ["--batch", "8192", "--timed_epochs", "1"]  # both shapes, both layouts
# K4's and K1's CUDA functions (csrc/ell_gather_reduce.cu, csrc/masked_scores.cu) by the
# names a profiler trace gives their kernels
TRACE_KERNELS = {"ell_gather_reduce": "ell_gather_kernel", "masked_scores": "masked_scores_kernel"}
MARKOV_ARGS = ["--epochs", "30"]
# SASRec and GRU4Rec must reach this multiple of the popularity ranker's recall@10 (the JAX
# tool read about 20x on the CPU at 60 epochs)
MARKOV_MIN_VS_POPULARITY = 5.0


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every kernel's launches counted from just
    before it → (its result, its standard output, the launches,
    seconds)."""
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, text = run_quiet(fn, *args, **kw)
    torch.cuda.synchronize()
    return out, text, launches_since(before), time.perf_counter() - t0


def tools_eval_checkpoint(root: str, hits_floor: float) -> dict:
    """`eval_checkpoint` on the zoo's lgn_segment run, the seq phase's
    SASRec run and the hits run (each evaluated with exact top-k): the
    last row of each run's valid CSV within METRIC_ATOL, the hits run's at
    least ``hits_floor`` in recall@20; K1 launched, K4 on the graph paths
    only, no K2 or K3."""
    from gsrs_tpu_torch.tools import eval_checkpoint

    out = {}
    for name, ckpt, dataset, extra in (("graph", TOOLS_GRAPH_CKPT, CLI_DATASET, []),
                                       ("sasrec", TOOLS_SEQ_CKPT, CLI_DATASET, TOOLS_SEQ_EVAL),
                                       ("hits", HITS_CKPT, HITS_DATASET, [])):
        ckpt = os.path.join(root, ckpt)
        metrics, text, launches, wall = counted(
            eval_checkpoint.main, ["--checkpoint_dir", ckpt, "--data_root", root, "--dataset",
                                   dataset] + extra)
        last = csv_rows(os.path.join(ckpt, "valid_epoch_metrics.csv"))[-1]
        want = {k: float(v) for k, v in last.items() if "@" in k}
        check(set(metrics) == set(want), f"eval_checkpoint {name}: {sorted(metrics)} vs the CSV's "
              f"{sorted(want)}")
        diff = max(abs(metrics[k] - want[k]) for k in want)
        check(diff <= METRIC_ATOL, f"eval_checkpoint {name}: metrics {metrics} differ from the "
              f"run's last eval {want} by {diff}")
        check(launches["masked_scores"] > 0 and launches["masked_scores_bitplane"] == 0
              and launches["fused_adam"] == 0, f"eval_checkpoint {name}: launches {launches}")
        check((launches["ell_gather_reduce"] > 0) == (name != "sasrec"),
              f"eval_checkpoint {name}: K4 launched {launches['ell_gather_reduce']} times")
        if name == "hits":
            check(want[f"recall@{K}"] >= hits_floor, f"eval_checkpoint hits: the run's last eval "
                  f"{want} is under the floor {hits_floor}")
        out[name] = dict(max_diff=diff, launches=launches, run_s=wall,
                         epoch=int(last["epoch"]), metrics=metrics)
        log(f"[tools] eval_checkpoint {name} (epoch {last['epoch']}): {wall:.2f} s; the run's last "
            f"eval {want} reproduced within {diff:.1e}; launches {launches}")
    out["launches"] = {k: sum(out[name]["launches"][k] for name in ("graph", "sasrec", "hits"))
                       for k in out["graph"]["launches"]}
    return out


def tools_bench_serving(dev, root: str, cli_model) -> dict:
    """`bench_serving` on the CLI run's checkpoint at the Gowalla shape
    (its int8 artifact in a temporary directory): every row launched K1;
    the fp32 batch-256 top-20 of its first request equals a Retriever of
    the CLI run's final model on the same ids (ties aside)."""
    import tempfile

    from gsrs_tpu_torch.data.dataset import load_dataset
    from gsrs_tpu_torch.ops.scoring import masked_scores_reference
    from gsrs_tpu_torch.serve import retriever_from_model
    from gsrs_tpu_torch.tools import bench_serving

    data_dir = os.path.join(root, CLI_DATASET)
    with tempfile.TemporaryDirectory() as artifacts:
        (rows, answers), text, launches, wall = counted(
            bench_serving.main, ["--checkpoint_dir", os.path.join(root, "cli_ckpt"),
                                 "--dataset_dir", data_dir, "--artifact_dir", artifacts])
    check("restored @ epoch" in text, "bench_serving did not restore the CLI run's checkpoint")
    for r in rows:
        check(r["launches"]["masked_scores"] > 0 and r["launches"]["masked_scores_bitplane"] == 0,
              f"bench_serving row {r}: launches")
        log(f"[tools] bench_serving {json.dumps(r)}")
    ids, items = answers[("fp32", 256)]
    live = retriever_from_model(cli_model, load_dataset(data_dir), batch_size=BATCH)
    live_items, _ = live.recommend(ids, k=K)
    ue, ie, seen = live._serve_tables
    idx = torch.as_tensor(ids, device=dev)
    with torch.no_grad():
        same_topk(items, masked_scores_reference(ue[idx], ie, seen[idx]), live_items,
                  "bench_serving fp32 B=256 vs the CLI model's Retriever")
    log(f"[tools] bench_serving: {wall:.2f} s; its fp32 batch-256 top-{K} equal to the CLI "
        "model's Retriever on the same ids")
    return dict(rows=rows, launches=launches, run_s=wall)


def bench_eval_launches(rows, what: str) -> None:
    """K2 in each bit-plane row only, K1 in the others."""
    for r in rows:
        k1, k2 = r["launches"]["masked_scores"], r["launches"]["masked_scores_bitplane"]
        bitplane = r["variant"] == "pallas-bitplane+exact"
        check((k2 > 0 and k1 == 0) if bitplane else (k1 > 0 and k2 == 0),
              f"bench_eval {what} {r['dataset']} {r['variant']}: K1 {k1}, K2 {k2}")
        log(f"[tools] bench_eval {what} {json.dumps(r)}")


def tools_bench_eval(dev, root: str, hits_floor: float) -> dict:
    """`bench_eval` on the stand-in's directory (the zoo's lgn_segment
    parameters) and the amazon-book-scale stand-in, all five variants: K2
    in the bit-plane row only, K1 in the others; exact and bit-plane
    metrics within METRIC_ATOL. Then on the hits run (``--skip_scale``),
    where a trained model hits: the exact, natural and bit-plane rows
    within METRIC_ATOL and at least ``hits_floor`` in recall@20, approx's
    at least its target less APPROX_SLACK of exact's. Then K1 and K2 at
    the amazon-book eval shape against their plain versions, timed."""
    from gsrs_tpu_torch.tools import bench_eval

    rows, text, launches, wall = counted(
        bench_eval.main, ["--dataset_dir", os.path.join(root, CLI_DATASET), "--checkpoint_dir",
                          os.path.join(root, TOOLS_GRAPH_CKPT)])
    check(len(rows) == 10, f"bench_eval printed {len(rows)} rows")
    bench_eval_launches(rows, "stand-in")
    for name in ("gowalla", "amazon-book-scale"):
        by = {r["variant"]: r for r in rows if r["dataset"] == name}
        diff = max(abs(by["exact"][k] - by["pallas-bitplane+exact"][k])
                   for k in ("recall@20", "ndcg@20"))
        check(diff <= METRIC_ATOL, f"bench_eval {name}: exact and bit-plane differ by {diff}")
    hits, text, hits_launches, hits_s = counted(
        bench_eval.main, ["--dataset_dir", os.path.join(root, HITS_DATASET), "--checkpoint_dir",
                          os.path.join(root, HITS_CKPT), "--skip_scale"])
    check(len(hits) == 5, f"bench_eval on the hits run printed {len(hits)} rows")
    check("restored" in text, "bench_eval did not restore the hits run's checkpoint")
    bench_eval_launches(hits, "hits")
    by = {r["variant"]: r for r in hits}
    hits_diff = max(abs(by[v][k] - by["exact"][k]) for v in ("pallas-natural+exact",
                                                              "pallas-bitplane+exact")
                    for k in ("recall@20", "ndcg@20"))
    check(hits_diff <= METRIC_ATOL,
          f"bench_eval hits: exact, natural and bit-plane rows differ by {hits_diff}")
    for v in ("exact", "pallas-natural+exact", "pallas-bitplane+exact"):
        check(by[v]["recall@20"] >= hits_floor,
              f"bench_eval hits {v}: recall@20 {by[v]['recall@20']} < floor {hits_floor}")
    target = bench_eval.build_parser().parse_args([]).recall_target
    check(by["approx"]["recall@20"] >= (target - APPROX_SLACK) * by["exact"]["recall@20"],
          f"bench_eval hits: approx's recall@20 {by['approx']['recall@20']} under "
          f"({target} - {APPROX_SLACK}) x exact's {by['exact']['recall@20']}")
    log(f"[tools] bench_eval on the hits run: {hits_s:.2f} s; exact, natural and bit-plane within "
        f"{hits_diff:.1e}, recall@20 {by['exact']['recall@20']} (floor {hits_floor:.6f}), approx "
        f"{by['approx']['recall@20']}")
    launches = {k: launches[k] + hits_launches[k] for k in launches}
    shape = AMAZON_SHAPE
    k1 = time_k1_at(dev, shape["B"], shape["d"], shape["m"], "amazon-book-scale eval")
    k2 = time_k1_at(dev, shape["B"], shape["d"], shape["m"], "amazon-book-scale eval",
                    bitplane=True)
    log(f"[tools] bench_eval: {wall:.2f} s for both datasets")
    return dict(rows=rows, hits_rows=hits, launches=launches, run_s=wall, hits_s=hits_s,
                hits_max_diff=hits_diff, k1=k1, k2=k2)


def tools_visualize(root: str) -> dict:
    """`visualize.gate_values` of the CLI run's pop-gate checkpoint on the
    card (K4 launched) against the CPU within GATE_ATOL, and
    `curve_series` of that run: one value a CSV row. Nothing is drawn."""
    from gsrs_tpu_torch.tools import visualize

    ckpt, data_dir = os.path.join(root, "cli_ckpt"), os.path.join(root, CLI_DATASET)
    (gate, pop), _, launches, wall = counted(visualize.gate_values, ckpt, data_dir)
    check(launches["ell_gather_reduce"] > 0, f"gate_values launched {launches}")
    t0 = time.perf_counter()
    gate_cpu, _ = run_quiet(visualize.gate_values, ckpt, data_dir, "cpu")[0]
    cpu_s = time.perf_counter() - t0
    diff = float(np.abs(gate - gate_cpu).max())
    check(gate.shape == pop.shape and bool(np.isfinite(gate).all()), "gate values")
    check(diff <= GATE_ATOL, f"the pop gate on the card differs from the CPU's by {diff}")
    series = visualize.curve_series(ckpt)
    for part, name in (("train", "train_epoch_metrics.csv"), ("valid", "valid_epoch_metrics.csv")):
        n = len(csv_rows(os.path.join(ckpt, name)))
        check(all(len(v) == n for v in series[part].values()) and series[part],
              f"curve_series {part}: {series[part]} for {n} CSV rows")
    log(f"[tools] visualize gates: {gate.size} items, gate {gate.min():.4f}–{gate.max():.4f} "
        f"(mean {gate.mean():.4f}), card vs CPU max diff {diff:.2e} (limit {GATE_ATOL}); "
        f"{wall:.2f} s on the card, {cpu_s:.2f} s on the CPU; K4 {launches['ell_gather_reduce']}; "
        f"curves: {len(series['train']['epoch'])} train and {len(series['valid']['epoch'])} valid "
        "rows")
    return dict(gate_diff=diff, gate_range=[float(gate.min()), float(gate.max())],
                launches=launches, card_s=wall, cpu_s=cpu_s)


def tools_compute_ppr(root: str) -> dict:
    """`compute_ppr` on the stand-in's directory (host, float64): each
    row of its weights sums to 1."""
    from gsrs_tpu_torch.tools import compute_ppr

    t0 = time.perf_counter()
    W, _ = run_quiet(compute_ppr.main, ["--dataset_dir", os.path.join(root, CLI_DATASET),
                                        "--out", os.path.join(root, "ppr_weights.npy")])
    wall = time.perf_counter() - t0
    n = GOWALLA_SHAPE["n_users"] + GOWALLA_SHAPE["m_items"]
    err = float(np.abs(W.sum(axis=1) - 1.0).max())
    check(W.shape == (n, 4) and err <= 1e-12, f"PPR weights {W.shape}, row sums off by {err}")
    log(f"[tools] compute_ppr: {wall:.2f} s for {W.shape} weights; rows sum to 1 within {err:.1e}")
    return dict(run_s=wall, row_sum_err=err)


def tools_bench_spmm_modes(root: str) -> dict:
    """`bench_spmm_modes` at batch 2048 and 8192 over ell, hybrid8192 and
    tiled 64:2048 (one timed epoch each): K4 launched on every row."""
    from gsrs_tpu_torch.tools import bench_spmm_modes

    rows, _, launches, wall = counted(bench_spmm_modes.main,
                                      ["--dataset_dir", os.path.join(root, CLI_DATASET)]
                                      + TOOLS_SPMM)
    check(len(rows) == 6, f"bench_spmm_modes printed {len(rows)} rows")
    for r in rows:
        check(r["launches"]["ell_gather_reduce"] > 0 and np.isfinite(r["last_loss"]),
              f"bench_spmm_modes row {r}")
        log(f"[tools] bench_spmm_modes {r['spmm']} batch {r['batch']}: {r['epoch_s']} s/epoch, "
            f"loss {r['last_loss']}, K4 {r['launches']['ell_gather_reduce']} launches")
    log(f"[tools] bench_spmm_modes: {wall:.2f} s with the layouts' builds")
    return dict(rows=rows, launches=launches, run_s=wall)


def tools_bench_seq() -> dict:
    """`bench_seq` at its defaults with one timed epoch: K1 on each eval
    batch (two evals a model), no other kernel; then one profiled step of
    each model's trainer (`seq_profile_steps`)."""
    from gsrs_tpu_torch.tools import bench_seq

    out, _, launches, wall = counted(bench_seq.main, ["--epochs", "1"])
    rows, profiles = [], {}
    for kind, (row, tr, state) in out.items():
        n_batches = tr._eval_seqs.shape[0]
        check(row["launches"]["masked_scores"] == 2 * n_batches
              and row["launches"]["ell_gather_reduce"] == row["launches"]["fused_adam"] == 0,
              f"bench_seq {kind}: launches {row['launches']} for 2 evals of {n_batches} batches")
        log(f"[tools] bench_seq {kind}: {row['epoch_s']} s/epoch ({tr.steps_per_epoch} steps of "
            f"{tr.batch_size}), {row['seqs_per_s']} seqs/s, eval {row['eval_s']} s "
            f"({n_batches} batches), recall@10 {row['recall@10']}")
        profiles[kind] = seq_profile_steps(tr, state, f"bench_seq {kind}", steps=1)
        rows.append(row)
    del out
    log(f"[tools] bench_seq: {wall:.2f} s with the data's build")
    return dict(rows=rows, profiles=profiles, launches=launches, run_s=wall)


def tools_bench_scaling() -> dict:
    """`bench_scaling` on 1, 2 and 4 gloo ranks sharing the card (a 1x1,
    2x1 and 2x2 mesh): finite losses, each size's warm-up loss (the same
    parameters and batch) within the bf16 mesh limit of size 1's, K4 on
    rank 0 of each. The ranks share one card and stage their collectives
    through host memory: the rows show that the mesh runs, not a speed-up."""
    from gsrs_tpu_torch.tools import bench_scaling

    rows, _, _, wall = counted(bench_scaling.main, SCALING_ARGS)
    check([r["mesh"] for r in rows] == ["1x1", "2x1", "2x2"],
          f"bench_scaling meshes {[r['mesh'] for r in rows]}")
    base = rows[0]["warmup_loss"]
    rtol = MESH_BLOCK_LIMITS["bf16"]["loss_rtol"]
    for r in rows:
        err = abs(r["warmup_loss"] - base) / abs(base)
        check(bool(np.isfinite(r["warmup_loss"])) and err <= rtol,
              f"bench_scaling {r['mesh']}: warm-up loss {r['warmup_loss']} vs {base} at size 1 "
              f"({err:.2e} > {rtol})")
        check(r["launches"]["ell_gather_reduce"] > 0, f"bench_scaling {r['mesh']}: {r['launches']}")
        log(f"[tools] bench_scaling {r['mesh']} ({r['backend'] or 'one process'}, "
            f"{r['ranks_per_card']} rank(s) on the card): {r['step_ms']} ms a step, "
            f"{r['examples_per_s']} examples/s, efficiency {r['scaling_efficiency']} (shared "
            f"card, host-staged gloo: not a speed-up); warm-up loss {r['warmup_loss']:.7f} "
            f"({err:.1e} of size 1's); K4 {r['launches']['ell_gather_reduce']} on rank 0")
    launches = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    log(f"[tools] bench_scaling: {wall:.2f} s with the ranks' start-up and data builds")
    return dict(rows=rows, launches=launches, run_s=wall)


def tools_sweep_xsimgcl(root: str) -> dict:
    """`sweep_xsimgcl` on the stand-in's directory, 2 configurations x 2
    epochs, an eval after each: finite losses, K4 and K1 launched."""
    import tempfile

    from gsrs_tpu_torch.tools import sweep_xsimgcl

    with tempfile.TemporaryDirectory() as ckpt_root:
        traj, text, launches, wall = counted(
            sweep_xsimgcl.main, ["--data_root", root, "--dataset", CLI_DATASET,
                                 "--checkpoint_root", ckpt_root] + SWEEP_ARGS)
    evals = [ln for ln in text.splitlines() if ln.startswith("  e")]
    check(sorted(traj) == [(0.1, 0.2), (0.2, 0.2)] and len(evals) == 4
          and all([r["epoch"] for r in rows] == [1, 2] for rows in traj.values()),
          f"sweep_xsimgcl printed {evals}")
    check(all(np.isfinite(r["loss"]) for rows in traj.values() for r in rows),
          "sweep_xsimgcl losses")
    check(launches["ell_gather_reduce"] > 0 and launches["masked_scores"] > 0,
          f"sweep_xsimgcl launches {launches}")
    configs = {f"l{lam}_e{eps}": dict(s_per_epoch_with_eval=rows[-1]["elapsed_s"] / 2,
                                      loss=[r["loss"] for r in rows],
                                      recall20=[r["recall@20"] for r in rows])
               for (lam, eps), rows in traj.items()}
    for ln in evals:
        log(f"[tools] sweep_xsimgcl{ln}")
    log(f"[tools] sweep_xsimgcl: {wall:.2f} s; s/epoch with its eval "
        + ", ".join(f"{k} {v['s_per_epoch_with_eval']:.3f}" for k, v in configs.items())
        + f"; launches {launches}")
    return dict(configs=configs, launches=launches, run_s=wall)


def trace_kernels(path: str) -> dict:
    """{kernel: device events whose name holds its CUDA function} in a
    Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(fn in n for n in names) for k, fn in TRACE_KERNELS.items()}


def tools_profile_epoch(root: str) -> dict:
    """`profile_epoch --eval` on the stand-in's directory: every phase in
    the summary, one trace file whose device events name K4's and K1's
    kernels."""
    import tempfile

    from gsrs_tpu_torch.tools import profile_epoch

    with tempfile.TemporaryDirectory() as trace:
        summary, _, launches, wall = counted(
            profile_epoch.main, ["--data_root", root, "--dataset", CLI_DATASET,
                                 "--trace_dir", trace] + PROFILE_ARGS)
        files = [os.path.join(trace, f) for f in os.listdir(trace) if f.endswith(".json")]
        check(len(files) == 1, f"profile_epoch wrote {os.listdir(trace)}")
        size = os.path.getsize(files[0])
        seen = trace_kernels(files[0])
    phases = {part.split(": ")[0]: part.split(": ")[1] for part in summary.split(" | ")}
    want = {"load_data", "init", "warmup_epoch_incl_compile", "warmup_eval_incl_compile",
            "epoch", "eval"}
    check(set(phases) == want, f"profile_epoch phases {sorted(phases)}")
    check(all(seen.values()), f"profile_epoch's trace: kernel events {seen}")
    check(launches["ell_gather_reduce"] > 0 and launches["masked_scores"] > 0,
          f"profile_epoch launches {launches}")
    log(f"[tools] profile_epoch: {summary}; trace {size / 2**20:.1f} MiB with {seen} device "
        f"events of K4 and K1; {wall:.2f} s")
    return dict(phases=phases, trace_mib=size / 2**20, trace_kernel_events=seen,
                launches=launches, run_s=wall)


def tools_bench_scale_standin() -> dict:
    """`bench_scale_standin`'s sweep (one subprocess a config) at batch
    8192 on both shapes and both layouts: four rows, none FAILED, each
    with device memory in use, K4 and K1 launched."""
    from gsrs_tpu_torch.tools import bench_scale_standin

    rows, _, _, wall = counted(bench_scale_standin.drive, STANDIN_ARGS)
    check([(r["shape"], r["spmm"]) for r in rows]
          == [(s, m) for s in bench_scale_standin.SHAPES for m in ("ell", "hybrid")]
          and not any("result" in r for r in rows), f"bench_scale_standin rows {rows}")
    for r in rows:
        check(r["hbm_gib_in_use"] > 0 and r["launches"]["ell_gather_reduce"] > 0
              and r["launches"]["masked_scores"] > 0, f"bench_scale_standin row {r}")
        log(f"[tools] bench_scale_standin {r['shape']} {r['spmm']} batch {r['batch']}: "
            f"{r['train_epoch_s']} s/epoch, eval {r['eval_s']} s ({r['eval_users_per_s']} "
            f"users/s), {r['hbm_gib_in_use']} GiB in use beside "
            f"{r['params_bytes'] / 2**30:.3f} GiB of parameters and "
            f"{r['layout_bytes'] / 2**30:.3f} GiB of layout; {r['edges']} edges; "
            f"launches {r['launches']}")
    launches = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    log(f"[tools] bench_scale_standin: {wall:.2f} s for the four subprocesses")
    return dict(rows=rows, launches=launches, run_s=wall)


def tools_bench_seq_markov() -> dict:
    """`bench_seq_markov` at its shapes for 30 epochs: SASRec and GRU4Rec at
    MARKOV_MIN_VS_POPULARITY times the popularity ranker's recall@10 or
    more (BERT4Rec's ratio reported), K1 on each eval batch."""
    from gsrs_tpu_torch.tools import bench_seq_markov

    rows, _, launches, wall = counted(bench_seq_markov.main, MARKOV_ARGS)
    by = {r["model"]: r for r in rows}
    for r in rows:
        log(f"[tools] bench_seq_markov {json.dumps(r)}")
    for kind in bench_seq_markov.KINDS:
        check(by[kind]["launches"]["masked_scores"] > 0, f"bench_seq_markov {kind}: "
              f"launches {by[kind]['launches']}")
    for kind in ("sasrec", "gru4rec"):
        check(by[kind]["vs_popularity_recall@10"] >= MARKOV_MIN_VS_POPULARITY,
              f"bench_seq_markov {kind}: recall@10 {by[kind]['recall@10']} is "
              f"{by[kind]['vs_popularity_recall@10']}x popularity's, under "
              f"{MARKOV_MIN_VS_POPULARITY}x")
    log(f"[tools] bench_seq_markov: {wall:.2f} s; vs popularity's recall@10: "
        + ", ".join(f"{k} {by[k]['vs_popularity_recall@10']}x" for k in bench_seq_markov.KINDS))
    return dict(rows=rows, launches=launches, run_s=wall)


def tools_phase(dev, out_dir: str, cli_model, hits_floor: float) -> dict:
    """The ported tools, in the order of ROADMAP A8, on the card."""
    out, seconds = {}, {}
    for name, fn, args in (("eval_checkpoint", tools_eval_checkpoint, (out_dir, hits_floor)),
                           ("bench_serving", tools_bench_serving, (dev, out_dir, cli_model)),
                           ("bench_eval", tools_bench_eval, (dev, out_dir, hits_floor)),
                           ("visualize", tools_visualize, (out_dir,)),
                           ("compute_ppr", tools_compute_ppr, (out_dir,)),
                           ("bench_spmm_modes", tools_bench_spmm_modes, (out_dir,)),
                           ("bench_seq", tools_bench_seq, ()),
                           ("bench_scaling", tools_bench_scaling, ()),
                           ("sweep_xsimgcl", tools_sweep_xsimgcl, (out_dir,)),
                           ("profile_epoch", tools_profile_epoch, (out_dir,)),
                           ("bench_scale_standin", tools_bench_scale_standin, ()),
                           ("bench_seq_markov", tools_bench_seq_markov, ())):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = seconds
    out["launches"] = {k: sum(v["launches"].get(k, 0) for v in out.values() if "launches" in v)
                       for k in ("masked_scores", "masked_scores_bitplane", "ell_gather_reduce",
                                 "fused_adam", "exact_topk", "exact_topk_plain")}
    log(f"[tools] seconds: {seconds}; launches {out['launches']}")
    check(out["launches"]["exact_topk_plain"] == 0,
          f"the tools ranked by the plain exact path: {out['launches']}")
    return out


# ---------------------------------------------------------------- mesh phase
# A 2 x 2 mesh of four gloo ranks on the one card (NCCL refuses two ranks on one
# device): LightGCN on the ELL layout in fp32 at full width through `cli.main` in
# every rank, the same batches through both step builders, a sharded eval and the
# sharded Retriever, each against the single card on the same parameters and batches;
# then SASRec through `seq_cli.main` on the same mesh against the single card; then NCCL.
MESH_AXES = (2, 2)
MESH_BATCH, MESH_STEPS, MESH_CHECK_STEPS = 2048, 10, 3
# mesh against one card: each limit sits between the largest sound reading and the
# control (a step that does not divide out the model-axis copies doubles the loss: 1.0).
# First chip run (NVIDIA H100 80GB HBM3, 700 W): losses 8.6e-8 of their size, parameters
# 6.0e-8, eval metrics equal, SASRec's CSV losses (6 decimals) equal, its metrics 3.4e-5
MESH_LIMITS = dict(loss_rtol=1e-5, param_atol=1e-5, metric_atol=1e-6,
                   seq_loss_rtol=1e-5, seq_metric_atol=2e-4)
MESH_SEQ_ARGS = ["--model", "sasrec", "--epochs", "1", "--eval_every", "1"]
# the mesh's tiled and hybrid runs: 3 seeded steps of each through `make_train_step` on the
# 2 x 2 mesh against the single card, on the stand-in padded to the model axis, with
# bench.py's training configuration (batch 131072, lr 1e-3): (a) bench.py's layout, tiled
# G64 x C2048 in bf16; (b) the hybrid layout at C = 8192 in bf16 with hash dropout; (c) a tiled
# layout whose 2,050 hub columns do not divide by the 4 ranks (whole on every rank, added by
# rank 0), in fp32
MESH_BLOCKS = {
    "tiled_bf16": dict(spmm_mode="tiled", tiled_groups=TILED_G, tiled_cols=TILED_C,
                       bf16_compute=True),
    "hybrid_bf16": dict(spmm_mode="hybrid", hybrid_cols=HYBRID_C, bf16_compute=True,
                        dropout=True, keep_prob=TILED_DROP[2]),
    "tiled_c2050": dict(spmm_mode="tiled", tiled_groups=TILED_G, tiled_cols=2050),
}
MESH_DIRECTIONS = ("user_from_item", "item_from_user")
# mesh against one card on those runs: losses by their relative error, parameters by their
# largest difference and the share of elements over TILED_PARAM_ATOL; each limit sits between
# the sound reading and the control's (the same 3 steps with the dense blocks added on every
# rank). fp32: sums in another order (PR 8's limits). bf16: the mesh rounds its partials where
# one card rounds its sums, about one bf16 rounding (2^-8) of the gradients apart, and an element
# whose gradient sits at that noise can flip its Adam sign. Chip readings (NVIDIA H100 80GB HBM3,
# 700 W): fp32 losses equal, parameters 6.0e-8; bf16 losses 1.7e-7 of their size, parameters
# 2.5e-4 and 2.8e-4 (a share 1.8e-5 and 3.6e-5 over 1e-4); the controls: losses 4.7e-2 to
# 7.3e-2 of their size, parameters 5.8e-3 to 5.9e-3 (a share 0.917 to 0.929 over 1e-4)
MESH_BLOCK_LIMITS = {
    "fp32": dict(loss_rtol=1e-5, param_atol=1e-5, share_over=0.0),
    "bf16": dict(loss_rtol=1e-4, param_atol=1e-3, share_over=TILED_BF16_PARAM_SHARE),
}
# a bf16 mesh layer against the fp32 layer of the bf16-rounded inputs and weights: one rounding
# more than one card's (TILED_BF16_ROUNDINGS), the psum's single rounding of its fp32 sum
MESH_BF16_ROUNDINGS = {"forward": 3, "backward": 4}


def mesh_cli_argv(root: str, ckpt: str, epochs: int, samples: int, resume: bool = False,
                  backend: str = "gloo") -> list:
    argv = ["--data_root", root, "--dataset", CLI_DATASET, "--epochs", str(epochs),
            "--epoch_samples", str(samples), "--bpr_batch", str(MESH_BATCH), "--eval_every",
            "1", "--fused_adam", "pallas", "--tensorboard", "0", "--checkpoint_dir", ckpt,
            "--data_axis", str(MESH_AXES[0]), "--model_axis", str(MESH_AXES[1]),
            "--dist_backend", backend]
    return argv + (["--resume"] if resume else [])


def padded_data(root: str, model_axis: int):
    """The config, data and graph `cli.main` builds for the mesh CLI run
    (the stand-in padded to the model axis) → (cfg, data, graph)."""
    from gsrs_tpu_torch import cli
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset, pad_nodes_to_multiple

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        mesh_cli_argv(root, os.devnull, 1, MESH_BATCH)))
    data = pad_nodes_to_multiple(load_dataset(cfg.data.dataset_dir, name=CLI_DATASET),
                                 model_axis)
    return cfg, data, build_graph(data, edge_pad_multiple=cfg.data.edge_pad_multiple)


def padded_model(root: str, device, model_axis: int):
    """The model and data `cli.main` builds for the mesh CLI run, here on
    ``device`` → (cfg, data, model)."""
    from gsrs_tpu_torch import cli
    from gsrs_tpu_torch.models.registry import build_model

    cfg, data, graph = padded_data(root, model_axis)
    model = build_model(cfg.model, graph, None, cli.layout_from_interactions(cfg.model, data),
                        device=device)
    return cfg, data, model


def hits_on_mesh(device, root: str) -> dict:
    """In a mesh rank: the hits run's checkpoint restored (`Trainer.
    resume_weights`) into the model that `cli.main` builds for the hits
    data on the mesh (the data padded to the model axis, as `padded_model`
    pads it; this rank's table rows), then the sharded eval: K1 on the
    rank's catalog shard, the model axis merging the top-k, counted."""
    from gsrs_tpu_torch import cli
    from gsrs_tpu_torch.data.adjacency import build_graph
    from gsrs_tpu_torch.data.dataset import load_dataset, pad_nodes_to_multiple
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.train.trainer import Trainer

    cfg = cli.config_from_args(cli.build_parser().parse_args(hits_argv(root) + [
        "--data_axis", str(MESH_AXES[0]), "--model_axis", str(MESH_AXES[1]), "--dist_backend",
        "gloo", "--resume"]))
    data = pad_nodes_to_multiple(load_dataset(cfg.data.dataset_dir, name=HITS_DATASET),
                                 MESH_AXES[1])
    graph = build_graph(data, edge_pad_multiple=cfg.data.edge_pad_multiple)
    model = build_model(cfg.model, graph, None, cli.layout_from_interactions(cfg.model, data),
                        device=device)
    trainer = Trainer(cfg, data, graph, model, device=device)
    state = trainer.resume_weights(trainer.init_state())
    before = launch_counts()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(state)
    return dict(epoch=state.epoch, metrics=metrics, eval_s=time.perf_counter() - t0,
                launches=launches_since(before))


def mesh_steps(model, cfg, mesh, builder, batches, generator_seed: int = SEED):
    """``builder``'s step from the seeded parameters over ``batches`` →
    (losses, the whole parameters after them, the step function and its
    state for more steps). A model with dropout draws its masks from a
    generator seeded alike on every rank and on the single card."""
    from gsrs_tpu_torch.parallel.collectives import all_gather_rows
    from gsrs_tpu_torch.parallel.sharding import GraphShardings
    from gsrs_tpu_torch.train.optim import make_optimizer

    sh = GraphShardings(mesh)
    if mesh.size > 1:
        sh.init_params(model, torch.Generator().manual_seed(generator_seed))
    else:
        model.init_params(torch.Generator().manual_seed(generator_seed))
    params = dict(model.named_parameters())
    optimizer, _ = make_optimizer(cfg.train, 1)
    opt_state = optimizer.init(params)
    step = builder(model, optimizer, mesh, cfg.train.decay)(params, opt_state)
    if cfg.model.dropout:
        step = functools.partial(step, generator=torch.Generator(mesh.device).manual_seed(
            generator_seed + 7))
    losses = []
    for users, pos, neg in batches:
        params, opt_state, loss = step(params, opt_state, *(torch.as_tensor(b, device=mesh.device)
                                                            for b in (users, pos, neg)))
        losses.append(float(loss))
    with torch.no_grad():
        whole = {k: (all_gather_rows(p.detach(), mesh) if k.endswith("_emb") else p.detach())
                 .cpu() for k, p in params.items()}
    return losses, whole, (step, params, opt_state)


class CollectiveClock:
    """Wall time of every torch.distributed collective the mesh code calls,
    each after a device synchronize (so pending kernels are not counted):
    gloo stages CUDA tensors through host memory, so these are host-staged
    times, not NVLink's."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter", "broadcast_object_list")

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.ms, self.calls, self.saved = dist, {}, {}, {}

    def __enter__(self):
        for name in self.NAMES:
            fn = getattr(self.dist, name)
            self.saved[name] = fn

            def timed(*a, _fn=fn, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.ms[_name] = self.ms.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return out

            setattr(self.dist, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def probe_bf16_all_reduce(mesh) -> str:
    """What the mesh's backend makes of a bf16 all-reduce itself (the
    port's psum does not ask it to: it sums in fp32): rank 0 holds 1 and
    the others 2^-9, so a sum rounded once reads 1 + 2^-7 on four ranks,
    one rounded after every add 1 → "sums to x". Both gloo and NCCL take
    bf16 on the card, so a refusal raises as any other fault does."""
    import torch.distributed as dist

    x = torch.tensor([1.0 if mesh.rank == 0 else 2.0**-9], dtype=torch.bfloat16,
                     device=mesh.device)
    dist.all_reduce(x, group=mesh.world)
    return f"sums to {float(x)}"


def clocked_steps(fn, batch, device, n: int = 5) -> dict:
    """ms a step of ``fn`` = (step, params, opt_state) from `mesh_steps` on
    ``batch``, after 2 warm-up steps; then ``n`` more with every collective
    timed (`CollectiveClock`) → {"step_ms", "step_ms_clocked",
    "collective_ms", "collective_calls"}, per step."""
    step, params, opt_state = fn
    users, pos, neg = (torch.as_tensor(b, device=device) for b in batch)

    def steps(k):
        nonlocal params, opt_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            params, opt_state, _ = step(params, opt_state, users, pos, neg)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / k

    steps(2)
    out = dict(step_ms=steps(n))
    with CollectiveClock() as clock:
        out["step_ms_clocked"] = steps(n)
    out["collective_ms"] = {k: v / n for k, v in clock.ms.items()}
    out["collective_calls"] = {k: v // n for k, v in clock.calls.items()}
    return out


def _one_rank_at_a_time(mesh, fn):
    """``fn()`` on each rank in turn while the others wait (four ranks share
    the card: a kernel timed while the others run would count their work)
    → this rank's result."""
    from gsrs_tpu_torch.parallel.collectives import barrier

    out = None
    for r in range(mesh.size):
        barrier(mesh)
        if mesh.rank == r:
            out = fn()
            torch.cuda.synchronize()
    barrier(mesh)
    return out


def block_config(name: str):
    """The ExperimentConfig of the mesh run ``name`` (`MESH_BLOCKS`):
    bench.py's, with the run's layout."""
    from gsrs_tpu_torch.bench import bench_config
    from gsrs_tpu_torch.config import ModelConfig

    return dataclasses.replace(bench_config(), model=ModelConfig(num_layers=3, embedding_dim=64,
                                                                 **MESH_BLOCKS[name]))


def block_layout(name: str, data, orders):
    """The whole layout of the mesh run ``name`` on ``data`` (CPU), the
    tiled ones over the spectral ``orders`` (bench.py's, G = 64)."""
    from gsrs_tpu_torch.data.adjacency import normalized_edge_weights
    from gsrs_tpu_torch.ops.hybrid import hybrid_from_interactions
    from gsrs_tpu_torch.ops.tiled import _build_tiled_graph

    cfg = block_config(name).model
    dtype = torch.bfloat16 if cfg.bf16_compute else torch.float32
    if cfg.spmm_mode == "hybrid":
        return hybrid_from_interactions(data, cols=cfg.hybrid_cols, dtype=dtype)
    users, items = data.train_users.astype(np.int64), data.train_items.astype(np.int64)
    w = normalized_edge_weights(users, items, data.user_degrees, data.item_degrees)
    return _build_tiled_graph(users, items, w.astype(np.float32), data.n_users, data.m_items,
                              cfg.tiled_groups, cfg.tiled_cols, dtype, 4, 0, orders)


def count_everywhere(placed, whole):
    """The control of a mesh run: the rank's ``placed`` layout with every
    direction's whole dense block (from ``whole``, on the rank's device)
    added on every rank, so the psum counts it mesh.size times."""
    def direction(p, w):
        names = {"dense", "top_src", "slot_w", "occ", "cols", "dense_dst", "dense_col"}
        kept = {f.name: getattr(w, f.name) for f in dataclasses.fields(w) if f.name in names}
        return dataclasses.replace(p, **kept, adds_dense=True)

    return dataclasses.replace(placed, **{k: direction(getattr(placed, k), getattr(whole, k))
                                          for k in MESH_DIRECTIONS})


def block_sides(ell) -> dict:
    """{(direction, side): EllSide} of a tiled or hybrid layout's K4 sides:
    each residual's forward (dst) and backward (src) side, tiled's occ."""
    sides = {}
    for name in MESH_DIRECTIONS:
        d = getattr(ell, name)
        sides[f"{name} residual fwd"] = d.residual.by_user
        sides[f"{name} residual bwd"] = d.residual.by_item
        if hasattr(d, "occ"):
            sides[f"{name} occ"] = d.occ
    return sides


def dense_bytes(ell) -> int:
    return sum(getattr(ell, k).dense.numel() * getattr(ell, k).dense.element_size()
               for k in MESH_DIRECTIONS)


def block_times(ell, n_users: int, m_items: int, reps: int = 100) -> dict:
    """Device ms a call of K4 on each K4 side of a tiled or hybrid layout
    (a rank's part or the whole) and of each dense product, forward and on
    the transposed view, at width 64 in the dense blocks' dtype."""
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce
    from gsrs_tpu_torch.ops.tiled import TiledGraph, _hub_product

    d, dtype = 64, ell.user_from_item.dense.dtype
    dev = ell.user_from_item.dense.device
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    n_src = {"user_from_item": m_items, "item_from_user": n_users}
    n_dst = {"user_from_item": n_users, "item_from_user": m_items}
    out = {}
    with torch.no_grad():
        for key, side in block_sides(ell).items():
            name = key.split()[0]
            rows = {"fwd": n_src[name], "bwd": n_dst[name]}.get(key.split()[-1])
            if rows is None:  # occ: the hub slots' cotangents
                t = getattr(ell, name)
                rows = t.groups * t.cols
            x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
            table = side.table
            buf = x.new_empty(table.n_rows + 1, d)
            out[f"{key} K4"] = device_ms(lambda: gather_reduce(table, x, out=buf), reps)
        for name in MESH_DIRECTIONS:
            t = getattr(ell, name)
            x_src = torch.randn(n_src[name], d, device=dev, generator=g).to(dtype)
            x_dst = torch.randn(n_dst[name], d, device=dev, generator=g).to(dtype)
            if isinstance(ell, TiledGraph):
                G, rows_g, C = t.groups, t.rows_g, t.cols
                a = t.dense.view(G, rows_g, C)
                fwd = x_src.index_select(0, t.top_src.reshape(-1)).reshape(G, C, d)
                bwd = x_dst.index_select(0, t.row_nat).view(G, rows_g, d)
            else:
                a, fwd, bwd = t.dense[None], x_src.index_select(0, t.top_src)[None], x_dst[None]
            for kind, lhs, rhs in (("fwd", a, fwd), ("transposed", a.transpose(1, 2), bwd)):
                out[f"{name} product {kind}"] = device_ms(lambda: _hub_product(lhs, rhs), reps)
    return out


def block_layer_check(model, whole, mesh) -> float:
    """One bf16 mesh layer forward and VJP, the rank's partials summed by
    the layer's psum, against the fp32 layer of the whole layout on the
    bf16-rounded inputs and weights → the largest error over its limit,
    `bf16_limit` of MESH_BF16_ROUNDINGS."""
    from gsrs_tpu_torch.ops.hybrid import hybrid_propagate_layer
    from gsrs_tpu_torch.ops.tiled import TiledGraph, tiled_propagate_layer
    from gsrs_tpu_torch.parallel.collectives import psum

    fn = tiled_propagate_layer if isinstance(whole, TiledGraph) else hybrid_propagate_layer
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    b16 = [torch.randn(n, 64, device=dev, generator=g).bfloat16()
           for n in (model.n_users, model.m_items, model.n_users, model.m_items)]
    got = psum(mesh, *layer_and_vjp(fn, model.ell, *b16))
    w32 = dataclasses.replace(whole, **{k: dataclasses.replace(
        getattr(whole, k), dense=getattr(whole, k).dense.float(),
        residual=rounded_ell(getattr(whole, k).residual)) for k in MESH_DIRECTIONS}).to(dev)
    ref = layer_and_vjp(fn, w32, *(a.float() for a in b16))
    mag = layer_and_vjp(fn, w32, *(a.float().abs() for a in b16))
    worst = 0.0
    for i, (a, want, m) in enumerate(zip(got, ref, mag)):
        check(a.dtype == torch.bfloat16, f"the bf16 mesh layer's output {i} is {a.dtype}")
        limit = bf16_limit(m, MESH_BF16_ROUNDINGS["forward" if i < 2 else "backward"])
        worst = max(worst, float(((a.float() - want).abs() / limit).max()))
    return worst


def _mesh_blocks(device, mesh, root: str, orders, batches) -> dict:
    """The tiled and hybrid runs of `MESH_BLOCKS` on this rank (see
    `mesh_phase`): each placed by `GraphShardings.place_model`, 3 counted
    steps, the dense bytes it holds, K4's launches on each of its sides,
    the control's first loss; for the bf16 runs the layer check and, one
    rank at a time, its K4 sides' and dense products' device times; for
    bench.py's run the step's collective share."""
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.sharding import GraphShardings

    _, data, graph = padded_data(root, MESH_AXES[1])
    sh = GraphShardings(mesh)
    out = {}
    for name in MESH_BLOCKS:
        cfg = block_config(name)
        whole = block_layout(name, data, orders)
        model = build_model(cfg.model, graph, None, whole, device=device)
        sh.place_model(model)
        before = launch_counts()
        losses, params, fn = mesh_steps(model, cfg, mesh, make_train_step, batches)
        torch.cuda.synchronize()
        r = dict(losses=losses, params=params if mesh.is_primary else None,
                 launches=launches_since(before),
                 sides={k: v.table.launches for k, v in block_sides(model.ell).items()},
                 dense_bytes=dense_bytes(model.ell), whole_dense_bytes=dense_bytes(whole),
                 adds_dense=[getattr(model.ell, k).adds_dense for k in MESH_DIRECTIONS])
        if cfg.model.bf16_compute:
            r["layer_over_limit"] = block_layer_check(model, whole, mesh)
            r["times"] = _one_rank_at_a_time(mesh, lambda: block_times(
                model.ell, model.n_users, model.m_items))
        if name == "tiled_bf16":
            r.update(clocked_steps(fn, batches[0], device, n=3))
        del fn
        control = build_model(cfg.model, graph, None, whole, device=device)
        sh.place_model(control)
        control.ell = count_everywhere(control.ell, whole.to(device))
        c_losses, c_params, _ = mesh_steps(control, cfg, mesh, make_train_step, batches)
        r["control_losses"] = c_losses
        r["control_params"] = c_params if mesh.is_primary else None
        out[name] = r
        del model, control, whole
        torch.cuda.empty_cache()
    return out


def _mesh_rank(device, root: str, batches, seq_root: str, orders, block_batches) -> dict:
    """One rank of the mesh phase (see `mesh_phase`)."""
    from unittest import mock

    from gsrs_tpu_torch import cli, seq_cli
    from gsrs_tpu_torch.ops.bitset import bitset_columns
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce
    from gsrs_tpu_torch.ops.scoring import masked_scores
    from gsrs_tpu_torch.parallel import collectives, dist_train
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.shard_map_train import make_shard_map_train_step
    from gsrs_tpu_torch.parallel.sharding import catalog_range
    from gsrs_tpu_torch.serve import retriever_from_model

    out = {}
    ckpt = os.path.join(root, "mesh_ckpt")
    # the CLI at full width: MESH_STEPS steps, an eval before and after, a checkpoint
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, first_state = cli.main(mesh_cli_argv(root, ckpt, 1, MESH_STEPS * MESH_BATCH), device)
    torch.cuda.synchronize()
    out["cli"] = dict(wall_s=time.perf_counter() - t0, epoch=first_state.epoch,
                      launches=launches_since(before), n_users=first.data.n_users,
                      m_items=first.data.m_items, steps=epoch_steps(first),
                      adam_per_step=adam_launches_per_step(first.model))
    before = launch_counts()
    trainer, state = cli.main(mesh_cli_argv(root, ckpt, 2, MESH_BATCH, resume=True), device)
    out["resume"] = dict(epoch=state.epoch, launches=launches_since(before),
                         steps=epoch_steps(trainer))
    # the resumed run against the first run's trainer taking that epoch in memory
    first.epoch_samples = MESH_BATCH
    first_state, _ = first.train_epoch(first_state)
    kept, resumed = (t._ckpt_state(s)["params"] for t, s in ((first, first_state),
                                                             (trainer, state)))
    out["resume_max_diff"] = max(float((kept[k] - resumed[k]).abs().max()) for k in kept)
    del first, first_state, kept, resumed
    mesh, model, cfg = trainer.mesh, trainer.model, trainer.cfg
    # the same batches through both step builders, from the seeded parameters; first the
    # control, whose step does not divide out the model-axis copies
    before = launch_counts()
    with mock.patch.object(dist_train, "local_share", lambda loss, mesh: loss / mesh.data_size):
        out["control_losses"] = mesh_steps(model, cfg, mesh, make_train_step, batches[:1])[0]
    for name, builder in (("gspmd", make_train_step), ("shard_map", make_shard_map_train_step)):
        losses, whole, fn = mesh_steps(model, cfg, mesh, builder, batches)
        out[name] = dict(losses=losses, params=whole if mesh.is_primary else None)
    out["steps_launches"] = launches_since(before)
    # eval and serving on the parameters of the shard_map steps
    before = launch_counts()
    t0 = time.perf_counter()
    out["metrics"] = trainer.evaluate(state)
    out["eval_s"] = time.perf_counter() - t0
    retriever = retriever_from_model(model, trainer.data, batch_size=BATCH, device=device,
                                     mesh=mesh)
    users = np.arange(N_REQUESTS * BATCH) * 7 % retriever.n_users
    out["top"] = retriever.recommend(users, k=K)
    out["eval_serve_launches"] = launches_since(before)
    out["hits"] = hits_on_mesh(device, root)
    # readings: the step's wall time, its collectives' share, each rank's kernels
    out.update(clocked_steps(fn, batches[0], device))
    x_items = collectives.all_gather_rows(model.item_emb.detach(), mesh).contiguous()
    table = model.ell.by_user.table
    buf = x_items.new_empty(table.n_rows + 1, x_items.shape[1])
    lo, hi = catalog_range(trainer.data.m_items, mesh)
    shard = x_items[lo:hi].contiguous()
    u = x_items.new_empty(MESH_BATCH, x_items.shape[1]).normal_()
    bits = trainer.sampler_state.train_bitset
    rows = bitset_columns(bits[torch.arange(MESH_BATCH, device=device) % bits.shape[0]], lo, hi)
    out["k4_user_side"] = _one_rank_at_a_time(mesh, lambda: kernel_ms(
        lambda: gather_reduce(table, x_items, None, out=buf), 50, f"rank {mesh.rank} K4"))
    out["k1_shard"] = _one_rank_at_a_time(mesh, lambda: kernel_ms(
        lambda: masked_scores(u, shard, rows), 50, f"rank {mesh.rank} K1"))
    out["local_slots"] = sum(c.numel() for c, _, _ in table.buckets)
    # the tiled and hybrid layouts, their dense blocks column-sharded
    out["bf16_all_reduce"] = probe_bf16_all_reduce(mesh)
    out["blocks"] = _mesh_blocks(device, mesh, root, orders, block_batches)
    # SASRec through seq_cli on the same mesh
    before = launch_counts()
    t0 = time.perf_counter()
    seq_tr, seq_state = seq_cli.main(["--data_root", root, "--dataset", CLI_DATASET,
                                      "--checkpoint_dir", os.path.join(seq_root, "mesh"),
                                      "--data_axis", str(MESH_AXES[0]), "--model_axis",
                                      str(MESH_AXES[1]), "--dist_backend", "gloo"]
                                     + MESH_SEQ_ARGS, device)
    torch.cuda.synchronize()
    out["seq"] = dict(wall_s=time.perf_counter() - t0, launches=launches_since(before),
                      rows=csv_rows(os.path.join(seq_root, "mesh", "valid_epoch_metrics.csv"))
                      if seq_tr.mesh.is_primary else None,
                      losses=csv_rows(os.path.join(seq_root, "mesh", "train_epoch_metrics.csv"))
                      if seq_tr.mesh.is_primary else None)
    return out


def _nccl_rank(device, root: str, batches) -> dict:
    """One NCCL rank on a 1 x 1 mesh whose axes are given the one-rank
    process group, so that NCCL's set-up and every collective of the mesh
    step run on the card."""
    import torch.distributed as dist

    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.mesh import Mesh
    from gsrs_tpu_torch.parallel.sharding import GraphShardings

    cfg, data, model = padded_model(root, device, MESH_AXES[1])
    world = dist.group.WORLD
    mesh = Mesh(1, 1, 0, device, dist.get_backend(), world, world, world)
    GraphShardings(mesh).place_model(model)
    before = launch_counts()
    losses, whole, _ = mesh_steps(model, cfg, mesh, make_train_step, batches)
    return dict(backend=dist.get_backend(), losses=losses, params=whole,
                launches=launches_since(before), bf16_all_reduce=probe_bf16_all_reduce(mesh))


def block_references(dev, data, graph):
    """The single card's side of the tiled and hybrid mesh runs on the
    padded stand-in ``data``: bench.py's spectral order (G = 64), 3
    batches of bench.py's size, and for each run of `MESH_BLOCKS` the
    losses and whole parameters of its 3 steps and, for the bf16 runs,
    the device times of the whole layout's K4 sides and dense products →
    ((orders, batches) for the ranks, {run: readings})."""
    from gsrs_tpu_torch.models.registry import build_model
    from gsrs_tpu_torch.ops.reorder import spectral_cluster_order
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.mesh import single_device_mesh

    t0 = time.perf_counter()
    orders = spectral_cluster_order(data.train_users.astype(np.int64),
                                    data.train_items.astype(np.int64), data.n_users,
                                    data.m_items, n_clusters=TILED_G)
    order_s = time.perf_counter() - t0
    train = block_config("tiled_bf16").train
    g = torch.Generator(dev).manual_seed(SEED + 3)
    state = make_sampler_state(data, dev)
    batches = [tuple(t.cpu().numpy() for t in sample_triplets(
        g, state, train.batch_size, neg_candidates=train.neg_candidates))
        for _ in range(MESH_CHECK_STEPS)]
    refs = {}
    for name in MESH_BLOCKS:
        cfg = block_config(name)
        t0 = time.perf_counter()
        layout = block_layout(name, data, orders)
        build_s = time.perf_counter() - t0
        model = build_model(cfg.model, graph, None, layout, device=dev)
        losses, params, _ = mesh_steps(model, cfg, single_device_mesh(dev), make_train_step,
                                       batches)
        refs[name] = dict(losses=losses, params=params, build_s=build_s,
                          dense_bytes=dense_bytes(model.ell))
        if cfg.model.bf16_compute:
            refs[name]["times"] = block_times(model.ell, model.n_users, model.m_items)
        del model, layout
        torch.cuda.empty_cache()
    log(f"[mesh] tiled and hybrid runs: spectral order {order_s:.2f} s; single card's losses "
        f"{ {k: v['losses'] for k, v in refs.items()} }")
    return (orders, batches), refs


def param_readings(got: dict, want: dict) -> dict:
    """The largest parameter difference and the share of elements over
    TILED_PARAM_ATOL."""
    diffs = [(got[k] - v).abs() for k, v in want.items()]
    n = sum(d.numel() for d in diffs)
    return dict(param_max=max(float(d.max()) for d in diffs),
                share_over=sum(int((d > TILED_PARAM_ATOL).sum()) for d in diffs) / n)


def check_blocks(ranks, refs) -> dict:
    """The tiled and hybrid mesh runs against the single card: losses and
    parameters within `MESH_BLOCK_LIMITS`, the control outside them, each
    rank's dense bytes a quarter of the block's (whole where C does not
    divide, added by rank 0 alone), K4 launched on every K4 side of every
    rank, the bf16 layer within its rounding limit → readings."""
    out = {}
    for name in MESH_BLOCKS:
        ref, got = refs[name], ranks[0]["blocks"][name]
        lim = MESH_BLOCK_LIMITS["bf16" if block_config(name).model.bf16_compute else "fp32"]
        loss_rel = max(abs(a / b - 1) for a, b in zip(got["losses"], ref["losses"]))
        params = param_readings(got["params"], ref["params"])
        control_rel = max(abs(a / b - 1) for a, b in zip(got["control_losses"], ref["losses"]))
        control = param_readings(got["control_params"], ref["params"])
        log(f"[mesh] {name}: mesh vs card, losses {loss_rel:.3e} of their size, parameters "
            f"{params['param_max']:.3e} ({params['share_over']:.2e} of them over "
            f"{TILED_PARAM_ATOL}); the control (the dense blocks counted on every rank): losses "
            f"{control_rel:.3e}, parameters {control['param_max']:.3e} "
            f"({control['share_over']:.2e} over); limits {lim}")
        check(loss_rel <= lim["loss_rtol"], f"{name}: mesh losses differ by {loss_rel}")
        check(params["param_max"] <= lim["param_atol"]
              and params["share_over"] <= lim["share_over"], f"{name}: parameters {params}")
        check(control_rel > lim["loss_rtol"],
              f"{name}: the control's losses passed ({control_rel})")
        check(control["param_max"] > lim["param_atol"]
              and control["share_over"] > lim["share_over"],
              f"{name}: the control's parameters passed a limit ({control})")
        m = block_config(name).model
        cols = m.hybrid_cols if m.spmm_mode == "hybrid" else m.tiled_cols
        divides = cols % (MESH_AXES[0] * MESH_AXES[1]) == 0
        for r, o in enumerate(ranks):
            b = o["blocks"][name]
            check(b["losses"] == got["losses"], f"rank {r}: {name} losses differ")
            want = b["whole_dense_bytes"] // (4 if divides else 1)
            check(b["dense_bytes"] == want and b["whole_dense_bytes"] == ref["dense_bytes"],
                  f"rank {r} {name}: {b['dense_bytes']} dense bytes, the block "
                  f"{b['whole_dense_bytes']}")
            check(all(a == (divides or r == 0) for a in b["adds_dense"]),
                  f"rank {r} {name}: adds the dense product {b['adds_dense']}")
            # every residual side runs K4; an occ side where the rank adds its dense product
            check(all((n > 0) == (("occ" not in side) or divides or r == 0)
                      for side, n in b["sides"].items()),
                  f"rank {r} {name}: K4 sides launched {b['sides']}")
            if "layer_over_limit" in b:
                check(b["layer_over_limit"] <= 1.0,
                      f"rank {r} {name}: bf16 layer {b['layer_over_limit']} of its limit")
        out[name] = dict(
            loss_rel=loss_rel, **params, control_loss_rel=control_rel,
            control_param_max=control["param_max"], control_share_over=control["share_over"],
            limits=lim,
            build_s=ref["build_s"], dense_bytes=[o["blocks"][name]["dense_bytes"] for o in ranks],
            whole_dense_bytes=got["whole_dense_bytes"],
            k4_sides=[o["blocks"][name]["sides"] for o in ranks],
            launches=[o["blocks"][name]["launches"] for o in ranks])
        if "times" in ref:
            out[name]["layer_over_limit"] = [o["blocks"][name]["layer_over_limit"]
                                             for o in ranks]
            out[name]["rank_ms"] = [o["blocks"][name]["times"] for o in ranks]
            out[name]["whole_ms"] = ref["times"]
            for key, ms in ref["times"].items():
                log(f"[mesh] {name} {key}: whole {ms * 1e3:.1f} us; ranks "
                    f"{[round(o['blocks'][name]['times'][key] * 1e3, 1) for o in ranks]} us")
        if "step_ms" in got:
            out[name].update({k: got[k] for k in ("step_ms", "step_ms_clocked",
                                                  "collective_ms", "collective_calls")})
            out[name]["collective_share"] = (sum(got["collective_ms"].values())
                                             / got["step_ms_clocked"])
            log(f"[mesh] {name}: step {got['step_ms']:.1f} ms, collectives "
                f"{got['collective_ms']} (share {out[name]['collective_share']:.3f})")
    return out


def mesh_phase(dev, out_dir: str, hits: dict) -> dict:
    """The (data, model) mesh on the card: builds nothing (the kernels are
    built), starts the four gloo ranks of `_mesh_rank` and checks them
    against the single card on the same parameters and batches (and their
    sharded eval of the hits run against ``hits``, the hits phase's
    result), then NCCL (`_nccl_rank` on one card, or the CLI across
    cards)."""
    import shutil

    from gsrs_tpu_torch import cli, seq_cli
    from gsrs_tpu_torch.ops.sampling import make_sampler_state, sample_triplets
    from gsrs_tpu_torch.parallel.dist_train import make_train_step
    from gsrs_tpu_torch.parallel.launch import spawn
    from gsrs_tpu_torch.parallel.mesh import single_device_mesh
    from gsrs_tpu_torch.serve import retriever_from_model
    from gsrs_tpu_torch.train.evaluator import Evaluator

    root = out_dir
    seq_root = os.path.join(root, "mesh_seq")
    for d in (os.path.join(root, "mesh_ckpt"), seq_root):
        shutil.rmtree(d, ignore_errors=True)
    t_phase = time.perf_counter()
    # the single card on the data the mesh pads: the same batches for both
    cfg, data, model = padded_model(root, dev, MESH_AXES[1])
    g = torch.Generator(dev).manual_seed(SEED)
    state = make_sampler_state(data, dev)
    batches = [tuple(t.cpu().numpy() for t in sample_triplets(g, state, MESH_BATCH))
               for _ in range(MESH_CHECK_STEPS)]
    losses, whole, _ = mesh_steps(model, cfg, single_device_mesh(dev), make_train_step, batches)
    blocks_in, block_refs = block_references(dev, data, model.graph)
    t0 = time.perf_counter()
    ranks = spawn(_mesh_rank, MESH_AXES[0] * MESH_AXES[1], root, batches, seq_root,
                  *blocks_in, device_type=dev.type, backend="gloo", timeout_s=900)
    spawn_s = time.perf_counter() - t0
    first = ranks[0]
    log(f"[mesh] 4 gloo ranks on one card: {spawn_s:.1f} s; CLI {first['cli']['wall_s']:.1f} s "
        f"for {MESH_STEPS} steps at {MESH_BATCH} and two evals")
    # every rank launched each kernel of its path
    for r, out in enumerate(ranks):
        for name in ("ell_gather_reduce", "masked_scores", "fused_adam"):
            check(out["cli"]["launches"][name] > 0, f"rank {r} launched no {name} in the CLI run")
            check(out["resume"]["launches"][name] > 0, f"rank {r}: no {name} in the resume")
        check(out["seq"]["launches"]["masked_scores"] > 0, f"rank {r}: the seq eval had no K1")
        check(out["cli"]["epoch"] == 1 and out["resume"]["epoch"] == 2,
              f"rank {r}: epochs {out['cli']['epoch']}, {out['resume']['epoch']}")
        for run in ("cli", "resume"):  # K3 once a step over the rank's leaves
            check(out[run]["launches"]["fused_adam"]
                  == out["cli"]["adam_per_step"] * out[run]["steps"],
                  f"rank {r}: fused_adam launched {out[run]['launches']['fused_adam']} times in "
                  f"the {run} run's {out[run]['steps']} steps")
    check((first["cli"]["n_users"], first["cli"]["m_items"]) == (data.n_users, data.m_items),
          "the mesh padded its data otherwise")
    # mesh against the single card, the same parameters and batches
    lim = MESH_LIMITS
    readings = {}
    for name in ("gspmd", "shard_map"):
        got = first[name]
        loss_rel = max(abs(a / b - 1) for a, b in zip(got["losses"], losses))
        param_err = max(float((got["params"][k] - whole[k]).abs().max()) for k in whole)
        readings[name] = dict(loss_rel=loss_rel, param_max=param_err)
        check(loss_rel <= lim["loss_rtol"], f"{name}: mesh losses differ by {loss_rel}")
        check(param_err <= lim["param_atol"], f"{name}: mesh parameters differ by {param_err}")
        for r, out in enumerate(ranks):
            check(out[name]["losses"] == got["losses"], f"rank {r}: {name} losses differ")
    # two runs on one mesh (the builders share their step), and the resume: bitwise where
    # the backend's sums are (logged), within the limits in any case
    repeat = max(float((first["gspmd"]["params"][k] - first["shard_map"]["params"][k]).abs().max())
                 for k in whole)
    check(repeat <= lim["param_atol"], f"two runs on one mesh differ by {repeat}")
    resume = max(out["resume_max_diff"] for out in ranks)
    check(resume <= RESUME_ATOL, f"the mesh resume differs from the run that kept going by {resume}")
    log(f"[mesh] two runs on one mesh: {'bitwise equal' if repeat == 0 else f'apart by {repeat}'}"
        f"; the resume: {'bitwise equal' if resume == 0 else f'apart by {resume}'}")
    control_rel = abs(first["control_losses"][0] / losses[0] - 1)
    check(control_rel > lim["loss_rtol"], f"the control passed the loss limit ({control_rel})")
    log(f"[mesh] gloo's own all-reduce of a bf16 tensor on the card: "
        f"{first['bf16_all_reduce']} (1 + 2^-7 = 1.0078125 if summed in fp32 and rounded once)")
    blocks = check_blocks(ranks, block_refs)
    # eval and serving on the shard_map steps' parameters, on one card
    model.load_state_dict({k: v.to(dev) for k, v in first["shard_map"]["params"].items()})
    ev = Evaluator(data, model, cfg.eval, device=dev)
    metrics = ev.run()
    metric_err = max(abs(first["metrics"][k] - v) for k, v in metrics.items())
    check(metric_err <= lim["metric_atol"], f"mesh eval metrics differ by {metric_err}")
    check(all(out["metrics"] == first["metrics"] for out in ranks), "ranks' metrics differ")
    # the hits run's sharded eval against one card's Evaluator, where a trained model hits
    one_card = hits["card_vs_cpu"]["card"]
    for r, out in enumerate(ranks):
        check(out["hits"]["epoch"] == HITS_EPOCHS, f"rank {r} restored the hits run at epoch "
              f"{out['hits']['epoch']}")
        check(out["hits"]["launches"]["masked_scores"] > 0,
              f"rank {r}: the hits eval launched {out['hits']['launches']}")
        check(out["hits"]["metrics"] == first["hits"]["metrics"], "ranks' hits metrics differ")
    hits_err = max(abs(first["hits"]["metrics"][k] - v) for k, v in one_card.items())
    check(hits_err <= lim["metric_atol"], f"the mesh's hits eval {first['hits']['metrics']} "
          f"differs from one card's {one_card} by {hits_err}")
    check(first["hits"]["metrics"][f"recall@{K}"] >= hits["floor"],
          f"the mesh's hits eval {first['hits']['metrics']} is under the floor {hits['floor']}")
    log(f"[mesh] the hits run's sharded eval on every rank: {first['hits']['metrics']} "
        f"({first['hits']['eval_s']:.2f} s); one card {one_card}; max diff {hits_err:.2e}")
    retriever = retriever_from_model(model, data, batch_size=BATCH, device=dev)
    users = np.arange(N_REQUESTS * BATCH) * 7 % retriever.n_users
    items, scores = retriever.recommend(users, k=K)
    ids = torch.as_tensor(users, device=dev)
    plain = retriever._serve_tables[0][ids] @ retriever._serve_tables[1].T
    check(bool((items >= 0).all()), "a request user has fewer than K unseen items")
    for r, out in enumerate(ranks):
        same_topk(out["top"][0], plain, items, f"mesh rank {r} top-{K}")
    # each rank's K4 side and K1 shard beside the single card's on the whole tables
    from gsrs_tpu_torch.ops.bitset import bitset_to_tensor, build_bitset
    from gsrs_tpu_torch.ops.ell_kernel import gather_reduce
    from gsrs_tpu_torch.ops.scoring import masked_scores

    x_items = model.item_emb.detach().contiguous()
    table = model.ell.by_user.table
    buf = x_items.new_empty(table.n_rows + 1, x_items.shape[1])
    whole_ms = dict(k4_user_side=kernel_ms(lambda: gather_reduce(table, x_items, None, out=buf),
                                           50, "one card's K4"))
    u = x_items.new_empty(MESH_BATCH, x_items.shape[1]).normal_()
    rows = bitset_to_tensor(build_bitset(data.train_users, data.train_items, data.n_users,
                                         data.m_items)[np.arange(MESH_BATCH) % data.n_users],
                            dev)
    whole_ms["k1_catalog"] = kernel_ms(lambda: masked_scores(u, x_items, rows), 50,
                                       "one card's K1")
    # the sequential family on the same mesh against the single card
    one_root = os.path.join(seq_root, "one")
    seq_tr, _ = seq_cli.main(["--data_root", root, "--dataset", CLI_DATASET, "--checkpoint_dir",
                              one_root] + MESH_SEQ_ARGS, dev)
    one_loss = [float(r["train_loss"]) for r in csv_rows(os.path.join(one_root,
                                                                      "train_epoch_metrics.csv"))]
    mesh_loss = [float(r["train_loss"]) for r in first["seq"]["losses"]]
    seq_loss_rel = max(abs(a / b - 1) for a, b in zip(mesh_loss, one_loss))
    one_rows = csv_rows(os.path.join(one_root, "valid_epoch_metrics.csv"))
    seq_metric_err = max(abs(float(a[k]) - float(b[k])) for a, b in zip(first["seq"]["rows"],
                                                                        one_rows)
                         for k in a if "@" in k)
    check(seq_loss_rel <= lim["seq_loss_rtol"], f"seq mesh losses differ by {seq_loss_rel}")
    check(seq_metric_err <= lim["seq_metric_atol"], f"seq mesh metrics differ by {seq_metric_err}")
    # NCCL: across cards when there are two or more, else a one-rank group on this card
    cards = torch.cuda.device_count()
    t0 = time.perf_counter()
    if cards >= 2:
        n = min(cards, 4)
        nccl = dict(mode=f"NCCL across {n} cards")
        argv = mesh_cli_argv(root, os.path.join(root, "mesh_nccl"), 1,
                             MESH_STEPS * MESH_BATCH, backend="nccl")
        argv[argv.index("--data_axis") + 1] = str(n // MESH_AXES[1] if n % 2 == 0 else n)
        argv[argv.index("--model_axis") + 1] = str(MESH_AXES[1] if n % 2 == 0 else 1)
        cli.main(argv)
    else:
        res = spawn(_nccl_rank, 1, root, batches, device_type=dev.type, backend="nccl",
                    timeout_s=600)[0]
        check(res["backend"] == "nccl", f"the one-rank group ran {res['backend']}")
        nccl_rel = max(abs(a / b - 1) for a, b in zip(res["losses"], losses))
        nccl_param = max(float((res["params"][k] - whole[k]).abs().max()) for k in whole)
        check(nccl_rel <= lim["loss_rtol"] and nccl_param <= lim["param_atol"],
              f"the NCCL 1 x 1 mesh differs from the card by {nccl_rel}, {nccl_param}")
        check(res["launches"]["ell_gather_reduce"] > 0 and res["launches"]["fused_adam"] > 0,
              f"the NCCL rank's launches {res['launches']}")
        nccl = dict(mode="NCCL as a one-rank group on one card", loss_rel=nccl_rel,
                    param_max=nccl_param, bf16_all_reduce=res["bf16_all_reduce"])
    nccl["s"] = time.perf_counter() - t0
    log(f"[mesh] {nccl['mode']}: {nccl['s']:.1f} s; NCCL's own bf16 all-reduce: "
        f"{nccl.get('bf16_all_reduce', 'not probed across cards')}")
    launches = {name: sum(out[k]["launches"][name] for out in ranks
                          for k in ("cli", "resume", "seq"))
                + sum(out[k][name] for out in ranks
                      for k in ("steps_launches", "eval_serve_launches"))
                + sum(out["hits"]["launches"][name] for out in ranks)
                + sum(b["launches"][name] for out in ranks for b in out["blocks"].values())
                for name in ("ell_gather_reduce", "masked_scores", "fused_adam", "exact_topk",
                             "exact_topk_plain")}
    check(launches["exact_topk"] > 0 and launches["exact_topk_plain"] == 0,
          f"the mesh ranks' exact top-k launches: {launches}")
    per_rank = [dict(k4_user_side=o["k4_user_side"], k1_shard=o["k1_shard"],
                     local_slots=o["local_slots"]) for o in ranks]
    whole_ms["slots"] = sum(c.numel() for c, _, _ in table.buckets)
    result = dict(
        axes=MESH_AXES, backend="gloo", gloo_bf16_all_reduce=first["bf16_all_reduce"],
        spawn_s=spawn_s, phase_s=time.perf_counter() - t_phase,
        cli=first["cli"], eval_s=first["eval_s"], readings=readings, control_loss_rel=control_rel,
        repeat_max_diff=repeat, resume_max_diff=resume,
        metric_err=metric_err, hits_metrics=first["hits"]["metrics"], hits_metric_err=hits_err,
        seq_loss_rel=seq_loss_rel, seq_metric_err=seq_metric_err,
        seq_wall_s=first["seq"]["wall_s"], step_ms=first["step_ms"],
        step_ms_clocked=first["step_ms_clocked"], collective_ms=first["collective_ms"],
        collective_calls=first["collective_calls"],
        collective_share=sum(first["collective_ms"].values()) / first["step_ms_clocked"],
        per_rank=per_rank, single_card=whole_ms, nccl=nccl, launches=launches, limits=lim,
        blocks=blocks)
    log(f"[mesh] step {result['step_ms']:.2f} ms, collectives {result['collective_ms']} "
        f"(share {result['collective_share']:.3f}); per rank {per_rank}")
    return result


# -------------------------------------------------------------- stress phase
# `python -m gsrs_tpu_torch.stress_pod`: the plan of BASELINE config 5 (50M users x 10M items,
# dim 256, a 4 x 16 mesh) on H100s; one run on the card at 1M users x 500k items, dim 256,
# degree 27, batch 65536, eval batch 1024 (a plan of 9.1 GiB), bf16 layers and the fused Adam
# kernel; then the harness's --smoke on a 2 x 2 mesh of gloo ranks on the card
STRESS_RUN = ["--n_users", "1000000", "--m_items", "500000", "--dim", "256", "--avg_degree",
              "27", "--batch", "65536", "--eval_batch", "1024", "--data_axis", "1",
              "--model_axis", "1", "--fused_adam", "pallas", "--steps", "10"]
STRESS_SMOKE = ["--smoke", "--dist_backend", "gloo", "--fused_adam", "pallas"]


def stress_phase(dev) -> dict:
    """The stress harness through its entry point: the plan, the run on the
    card (counted: K4 on its ELL sides, K1 on its eval, K3 on its tables;
    its peak device memory beside the plan's total), K4 on both sides of
    the run's ELL and K1 at the eval's shape held against their plain
    versions at the run's width in bf16 (K4) and fp32 (K1), then --smoke
    on four gloo ranks (rank 0's launches)."""
    from unittest import mock

    from gsrs_tpu_torch import stress_pod
    from gsrs_tpu_torch.models import registry

    plan = run_quiet(stress_pod.main, ["--plan_only", "--chip", "h100"])[0]
    log(f"[stress] BASELINE config 5 on H100s ({plan['mesh']}): "
        f"{plan['per_device_GiB']['total']} GiB a device, fits {plan['fits']}, "
        f"min_model_axis_for_fit {plan['min_model_axis_for_fit']}")
    built = []

    def keep_model(*a, _build=registry.build_model, **kw):
        built.append(_build(*a, **kw))
        return built[-1]

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(registry, "build_model", keep_model):
        res, text = run_quiet(stress_pod.main, STRESS_RUN, device=dev)
    wall_s = time.perf_counter() - t0
    launches = launches_since(before)
    check(text.rstrip().endswith("STRESS OK"), "the stress run did not print STRESS OK")
    for name in KERNELS:
        check(launches[name] > 0 and res["launches"][name] == launches[name],
              f"the stress run launched {launches[name]} {name} ({res['launches']})")
    (model,) = built
    steps = 1 + stress_pod.build_parser().parse_args(STRESS_RUN).steps  # the first, then timed
    check(launches["fused_adam"] == adam_launches_per_step(model) * steps,
          f"the stress run launched fused_adam {launches['fused_adam']} times in {steps} steps")
    check_launched(launches, "exact_topk", launches["masked_scores"], "the stress eval")
    mem = res["memory"]
    log(f"[stress] {res['edges']} edges, 1M x 500k x 256 on one card: {wall_s:.1f} s, of it "
        f"the build and first step {res['build_s']} s; train step "
        f"{res['train']['train_step_ms']} ms ({res['train']['examples_per_s']} examples/s, loss "
        f"{res['train']['loss']:.6f}); eval top-20 {res['eval']['eval_topk_ms']} ms; peak device "
        f"memory {mem['peak_device_GiB']} GiB against the plan's {mem['plan_total_GiB']} "
        f"GiB; launches {launches}")
    # K4 at the run's width (d = 256 in bf16: four columns a thread, two passes of the column
    # loop) on both sides of the run's ELL, then K1 at the eval's shape
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    k4 = {}
    with torch.no_grad():
        for side, rows in (("by_user", model.m_items), ("by_item", model.n_users)):
            x = torch.randn(rows, model.user_emb.shape[1], device=dev, generator=g).bfloat16()
            k4[side] = ell_side_check(getattr(model.ell, side).table, x, None,
                                      f"stress ELL {side} bf16 d={x.shape[1]}")
            log(f"[stress] K4 on the run's {side} side, bf16 ({rows}, {x.shape[1]}): max error "
                f"{k4[side]:.3e} of the bf16 limit")
            del x
    del model, built
    torch.cuda.empty_cache()
    k1 = time_k1_at(dev, 1024, 256, 500_000, "stress eval")
    t0 = time.perf_counter()
    small = stress_pod.main(STRESS_SMOKE, device=dev)
    smoke_s = time.perf_counter() - t0
    for name in KERNELS:
        check(small["launches"][name] > 0, f"the stress smoke's rank 0 launched no {name}")
    steps = 1 + stress_pod.build_parser().parse_args(STRESS_SMOKE).steps
    check(small["launches"]["fused_adam"] == steps,  # LightGCN's two tables: one launch a step
          f"the stress smoke's rank 0 launched fused_adam {small['launches']['fused_adam']} "
          f"times in {steps} steps")
    check_launched(small["launches"], "exact_topk", small["launches"]["masked_scores"],
                   "the stress smoke's rank 0")
    log(f"[stress] --smoke on 4 gloo ranks: {smoke_s:.1f} s; rank 0's launches "
        f"{small['launches']}")
    return dict(plan={k: plan[k] for k in ("mesh", "fits", "min_model_axis_for_fit",
                                           "per_device_GiB")},
                run={k: res[k] for k in ("train", "eval", "memory", "build_s", "edges")},
                wall_s=wall_s, k1=k1, k4_err_over_limit=k4, smoke_s=smoke_s,
                smoke={k: small[k] for k in ("train", "eval", "launches")},
                launches={k: launches[k] + small["launches"][k] for k in launches})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from gsrs_tpu_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    build_logs = build_kernels()
    log(f"[build] {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(library_path(k) for k in KERNELS)}")
    for name, text in build_logs.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line}")

    phase_s = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        return out

    data = training_data()
    errs = phase("kernels", kernel_phase, dev)
    errs.update(phase("kernels_train", kernel_phase_train, dev, data))
    ties = phase("topk_ties", exact_tie_check, dev)
    ties["kernel"] = phase("exact_topk", time_exact_topk, dev)
    grad_rows = phase("gather_rows_grad", time_gather_rows_grad, dev)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    serve = phase("serving", serving_phase, dev, GOWALLA_SHAPE, out_dir)
    train = phase("training", training_phase, dev, data)
    phase("card_vs_cpu", card_vs_cpu_phase, dev, train)
    ev = phase("eval", eval_phase, dev, train)
    drv = phase("drive", drive_phase, dev)
    tiled = phase("tiled", tiled_phase, dev, data)
    cli = phase("cli", cli_phase, dev, data, out_dir)
    zoo = phase("zoo", zoo_phase, dev, data, train["ell"], out_dir)
    seq = phase("seq", seq_phase, dev, out_dir)
    hits = phase("hits", hits_phase, dev, out_dir)
    tools = phase("tools", tools_phase, dev, out_dir, cli["model"], hits["floor"])
    mesh = phase("mesh", mesh_phase, dev, out_dir, hits)
    stress = phase("stress", stress_phase, dev)
    times = phase("time_training", time_training, dev, train)

    kernels = serve["kernels"]
    for k in kernels:
        k["max_abs_err"] = errs[k["name"]]
        # serving requests plus the training run's evals, plus the CLI and zoo runs' evals
        k["launches"] += ev["launches"][k["name"]]
        if k["name"] == "masked_scores":
            k["launches"] += cli["launches"]["masked_scores"] + zoo["launches"]["masked_scores"]
            k["launches_cli"] = cli["launches"]["masked_scores"]
            k["launches_zoo"] = zoo["launches"]["masked_scores"]
            k["at_d256"] = dict(zoo["k1_d256"], max_abs_err=max(errs["masked_scores_d256"],
                                                                zoo["k1_d256"]["max_abs_err"]),
                                launches_ngcf=zoo["runs"]["ngcf"]["launches"]["masked_scores"])
            # the sequential family's evals and session requests
            k["launches"] += seq["launches"]["masked_scores"]
            k["launches_seq"] = seq["launches"]["masked_scores"]
            k["seq_requests"] = {f"B={n}": v for n, v in seq["serving"]["k1"].items()}
    # launches per step: fused_adam counts its "pallas" steps only (3 warm-up
    # and 2 x 20 timed at 2048, 3 warm-up and two epochs at 8192; the "off"
    # steps use torch Adam)
    pallas_steps = 46 + 2 * train["trainer"].steps_per_epoch
    per_step = {"ell_gather_reduce": train["launches"]["ell_gather_reduce"] / train["steps"],
                "fused_adam": train["launches"]["fused_adam"] / pallas_steps}
    main_launches = {name: serve["launches"][name] + train["launches"][name]
                     + ev["launches"][name] + tiled["launches"][name] + cli["launches"][name]
                     + zoo["launches"][name] for name in per_step}
    model = train["trainer"].model
    kernels.append(time_adam(model, cli["model"], main_launches["fused_adam"],
                             per_step["fused_adam"], errs["fused_adam"],
                             times["adam_in_step_ms"]))
    kernels[-1]["launches_zoo"] = zoo["launches"]["fused_adam"]
    kernels[-1]["launches_ngcf"] = zoo["runs"]["ngcf"]["launches"]["fused_adam"]
    hybrid_k4_err = max(v for k, v in zoo["hybrid"]["errors"].items()
                        if k.startswith("ell_gather_reduce"))
    kernels.append(time_ell(model, main_launches["ell_gather_reduce"],
                            per_step["ell_gather_reduce"],
                            max(errs["ell_gather_reduce"], tiled["k4_err"], hybrid_k4_err)))
    kernels[-1]["launches_zoo"] = zoo["launches"]["ell_gather_reduce"]
    kernels[-1]["hybrid_sides"] = dict(zoo["hybrid"]["k4_sides"],
                                       launches=zoo["runs"]["lgn_hybrid"]["k4_sides"])
    kernels[-1]["launches_tiled_bench"] = tiled["launches"]["ell_gather_reduce"]
    kernels[-1]["tiled_sides"] = tiled["k4_sides"]
    kernels[-1]["launches_cli"] = cli["launches"]["ell_gather_reduce"]
    kernels[-1]["cli_sides"] = cli["sides"]
    i2i = cli["model"].i2i.ell.by_user
    x = cli["model"].item_emb.detach().float()
    with torch.no_grad():
        kernels[-1]["i2i_side"] = dict(time_ell_side("i2i forward", i2i.table, x,
                                                     side_csr(i2i, x.shape[0])),
                                       launches=cli["sides"]["i2i_forward"],
                                       max_abs_err=cli["i2i_k4_err"])
    kernels[-2]["launches_cli"] = cli["launches"]["fused_adam"]
    kernels.append(exact_topk_entry(ties["kernel"], {
        "serving": serve["launches"]["exact_topk"], "eval": ev["launches"]["exact_topk"],
        "cli": cli["launches"]["exact_topk"], "zoo": zoo["launches"]["exact_topk"],
        "seq": seq["launches"]["exact_topk"]}))
    kernels.append(gather_rows_entry(grad_rows, {
        "training": train["launches"]["gather_rows_grad"],
        "bench": tiled["launches"]["gather_rows_grad"],
        "cli": cli["launches"]["gather_rows_grad"], "zoo": zoo["launches"]["gather_rows_grad"],
        "seq": seq["launches"]["gather_rows_grad"]}))
    # the mesh phase's launches, summed over its ranks (K2 is off the mesh path)
    for k in kernels:
        k["launches_mesh"] = mesh["launches"].get(k["name"], 0)
        k["launches"] += k["launches_mesh"]
        if k["name"] == "masked_scores":
            k["mesh_rank_shard_ms"] = [r["k1_shard"]["ms"] for r in mesh["per_rank"]]
            k["mesh_single_card_catalog_ms"] = mesh["single_card"]["k1_catalog"]["ms"]
        if k["name"] == "ell_gather_reduce":
            k["mesh_rank_user_side_ms"] = [r["k4_user_side"]["ms"] for r in mesh["per_rank"]]
            k["mesh_single_card_user_side_ms"] = mesh["single_card"]["k4_user_side"]["ms"]
            # the tiled and hybrid runs: each K4 side, whole on one card and each rank's shard
            k["mesh_block_sides_ms"] = {
                run: {side: dict(whole=b["whole_ms"][side], ranks=[t[side] for t in b["rank_ms"]])
                      for side in b["whole_ms"] if side.endswith("K4")}
                for run, b in mesh["blocks"].items() if "whole_ms" in b}
        # the hits run and its checks, and the ported tools, on the card
        k["launches_hits"] = hits["launches"].get(k["name"], 0)
        k["launches_tools"] = tools["launches"].get(k["name"], 0)
        k["launches"] += k["launches_hits"] + k["launches_tools"]
        if k["name"] == "masked_scores":
            k["at_amazon_scale"] = tools["bench_eval"]["k1"]
        if k["name"] == "masked_scores_bitplane":
            k["at_amazon_scale"] = tools["bench_eval"]["k2"]
        # the stress harness: its run on the card and the rank 0 of its --smoke
        k["launches_stress"] = stress["launches"].get(k["name"], 0)
        k["launches"] += k["launches_stress"]
        if k["name"] == "masked_scores":
            k["stress_eval"] = stress["k1"]
        if k["name"] == "ell_gather_reduce":
            k["stress_sides_bf16_err_over_limit"] = stress["k4_err_over_limit"]
    ms = train["ms"]
    log(json.dumps({
        "card": card, "propagation_ms": serve["prop_ms"],
        "recommend_p50_ms": serve["recommend_p50_ms"],
        "recommend_device_busy": serve["recommend_device_busy"],
        "peak_device_mib_serving": serve["peak_mib"],
        "train_ms_per_step": {f"{b}_{f}": v for (b, f), v in ms.items()},
        "epoch_s_8192": train["epoch_s"], "eval_s": ev["eval_s"], "eval_metrics": ev["metrics"],
        "propagation_fwd_ms": times["fwd_ms"], "propagation_fwd_bwd_ms": times["fwd_bwd_ms"],
        "train_device_busy": times["train_device_busy"],
        "train_step_device_us": times["train_step_device_us"],
        "train_step_wall_us": times["train_step_wall_us"],
        "peak_device_mib_training": train["peak_mib"], "drive": drv, "topk": ties,
        "tiled": {k: v for k, v in tiled.items() if k not in ("k4_sides", "launches")},
        "cli": {k: v for k, v in cli.items() if k != "model"},
        "zoo": zoo,
        "seq": seq,
        "hits": hits,
        "tools": tools,
        "mesh": mesh,
        "stress": stress,
        "phase_s": phase_s, "smoke_s": time.perf_counter() - t_start,
    }))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
