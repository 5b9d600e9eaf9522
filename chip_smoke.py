"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the exit code is non-zero on any):

1. device: a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compiles every kernel source of the port with nvcc;
3. kernels: at the full width of the attention model (batch 2, T=8192,
   4 heads, d_head 64), each kernel (K1 forward in both modes, K4
   partials causal and not, K2 dK/dV, K3 dQ, K2/K3 in segment form
   against a K/V half with Tk=4096, and K2/K3 as the ring's non-causal
   8192x8192 step with the L and D of a T=16384 sequence) is held
   against its plain PyTorch
   version on the same inputs, in bfloat16 and float32, then timed with
   CUDA events against its plain version and against the PyTorch library
   call that computes the same function (``scaled_dot_product_attention``,
   a yardstick the port never calls).  With bf16 inputs all four run on
   the tensor cores and round P (K1/K4: the operand of P V) and dS (K2/K3)
   to bf16, so each has two references: the plain twin that rounds alike
   (tight), and the all-f32 twin (the gap that rounding costs, bounded
   and reported on the ``[check]`` lines and as ``f32_twin_gap``);
4. reference: a small network trains 2 steps on the card (kernels) and on
   the CPU (plain versions) from the same weights, in fp32; scores and
   params must agree;
5. training: the full-width network (CausalSelfAttention(n_out=256,
   n_heads=4, cache_len=8192) -> RnnOutputLayer(n_out=32, softmax,
   mcxent), n_in=64, adam, the card's default mixed_bf16 policy) takes
   3 fit steps; the score must be finite and every kernel's
   launch count must rise by exactly one per step; then one more step
   under ``torch.profiler`` splits the step's CUDA time into the port's
   kernels and everything else (top 5 kernels) and gives its idle share;
6. inference: ``output()`` of the trained net must be finite
   probabilities of the right shape;
7. ring: ``SequenceParallel(devices=["cuda"] * 4).attention(...,
   causal=True, impl="ring_flash")`` at batch 2, T=32768, 4 heads,
   d_head 64 (each shard the training slice's shape), forward and
   ``backward(g)``, in float32 and bfloat16, against the one-device
   ``flash_attention`` (K1-K3) at the same T (in bf16, on the GRID: the
   output against the same ring chain built from K4's rounded plain twin,
   the gradients against the one-device K2/K3 fed the ring forward's L and
   D, and the two whole chains within ``RING_CHAIN_REL``); one causal
   fwd+bwd must
   launch K4, K2 and K3 exactly 10 times each and K1 never; both paths
   are timed in bfloat16;
8. serving: the trained net of phase 5 behind
   ``serving.InferenceEngine(max_batch_size=4, max_latency_ms=5,
   timestep_buckets=(1024, 8192))``: three client threads send
   ``predict`` requests of (1, 700), (2, 1024) and (1, 8192) timesteps in
   rounds, each answer held against ``output()`` of that request alone;
   then decode sessions through ``predict_session`` after
   ``warmup_decode``: two concurrent sessions of a 1000-token prefill and
   40 single tokens (the ring hops 1024 -> 2048), one to the top bucket
   8192 and a ``SessionError`` past it; then the median ms per decoded
   token at batch 1
   and 4, at about 1000 and 8000 tokens held, beside its bytes bound;
   then the predict rounds, the two sessions and the top bucket again on
   an fp32 copy of the net, within 1e-5.
   The serving path launches none of K1-K4 (dense ``kv_ring_attention``,
   as in the JAX package);
9. feed-forward and convolutional (no hand kernel: cuDNN/cuBLAS through
   torch, as XLA lowerings in the JAX package): the ``mlp_sgd`` and
   ``cnn_adam`` regression goldens restored from
   ``tests/fixtures/regression/`` onto the card, under the card's default
   ``mixed_bf16`` policy (probabilities within ``GOLDEN_BF16_ATOL``) and as
   an fp32 copy built from the zip's configuration with
   ``compute_dtype="float32"`` (within ``GOLDEN_F32_ATOL``), each net then
   one ``fit`` step; a small CNN with every ported family (conv stride 2
   SAME, max and avg SAME pooling, BatchNormalization, LRN,
   GlobalPooling) on the card and on the CPU from the same weights in
   fp32, forward and two ``fit`` steps within ``REF_RTOL``; LeNet-5 at full
   width (``models/lenet.py``, batch 256, 28x28x1, 10 classes, the card's
   default policy) trains ``LENET_STEPS`` steps on seeded inputs whose
   labels are the argmax of a fixed random linear map, the score falling;
   the median ms per step over steps 2 to ``LENET_STEPS``, samples/s and
   peak memory, then one more step under ``torch.profiler`` (top 5 CUDA
   ops, idle share).  K1-K4 launch 0 times on this path;
10. recurrent (no hand kernel: cuBLAS and elementwise kernels through
   torch, where the JAX package has XLA's lowering of ``lax.scan``): the
   ``lstm_rmsprop_tbptt`` golden restored onto the card as in phase 9,
   each copy then one resumed tBPTT ``fit`` (iteration 2 -> 4); a
   2 x GravesLSTM(16) net under tBPTT 8 / back 5 and a
   GravesBidirectionalLSTM(16) -> masked global pooling net, card vs CPU
   in fp32 on ragged masked sequences of 21 steps, forward and two fits
   within ``REF_RTOL``; the char-RNN of BASELINE.md config #3
   (GravesLSTM(84 -> 256) -> GravesLSTM(256) -> RnnOutputLayer(84),
   rmsprop 0.1, the card's default policy) on a seeded Markov text, batch
   32, ``CHAR_FITS`` fits of ``CHAR_SEQ`` steps in tBPTT windows of 64,
   the score falling: ms per window (median of windows 2 to 32), chars/s,
   peak memory, one more window under ``torch.profiler``; ``rnn_time_step``
   over 64 single characters and two concurrent ``predict_session``s (a
   64-step prefill, then 32 single steps) against ``output()``, in bf16
   (``RNN_BF16_ATOL``) and on an fp32 copy (``RNN_F32_ATOL``); then
   ``ring_lstm_scan`` over 4 shards of one card at T=1024 against the
   one-device ``lstm_scan``, outputs, final carry and gradients within
   ``RING_LSTM_RTOL``, both timed.  K1-K4 launch 0 times on this path;
11. the training harness (no hand kernel: host numpy for the data,
   metrics, listeners and early stopping, torch ops for the forward, the
   argmax and the solvers' loss, gradient and line search, as XLA
   lowerings in the JAX package), as a user of ``examples/lenet_mnist.py``
   and ``examples/mlp_iris.py`` drives it: (a) LeNet-5 at full width under
   the card's default ``mixed_bf16`` trains on
   ``AsyncDataSetIterator(MnistDataSetIterator(128, 6400))`` (the
   procedural MNIST) for 2 epochs with ``ScoreIterationListener``,
   ``PerformanceListener`` and ``CollectScoresIterationListener``, then
   ``evaluate(MnistDataSetIterator(500, 2000, train=False))`` must exceed
   ``MNIST_MIN_ACCURACY`` and move 8,000 bytes (int32 indices), all on
   the per-batch path (``ingest="batch"``, the baseline of phase 13); fit
   and
   evaluate samples/s, peak memory, the seconds spent generating the data,
   and one more epoch of 10 batches under ``torch.profiler`` (idle share);
   (b) an fp32 copy of the trained net on the card and one on the CPU give
   the same confusion matrix, and the predictions of the bf16 net that
   differ from the fp32 copy's are counted; (c) ``EarlyStoppingTrainer``
   (``MaxEpochsTerminationCondition(3)``,
   ``ScoreImprovementEpochTerminationCondition(1)``, a
   ``DataSetLossCalculator`` over the test iterator, a
   ``LocalFileModelSaver`` in a temporary directory): the restored best
   model scores its recorded best score within ``ES_RESTORE_RTOL``; (d)
   the iris MLP with ``optimization_algo("lbfgs")`` and then
   ``"conjugate_gradient"``, fp32, ``SOLVER_FITS`` full-batch fits on the
   card and on the CPU from the same weights: params within ``REF_RTOL``,
   the score falling, ms and host reads per solver iteration.  K1-K4
   launch 0 times on this path;
12. the ComputationGraph ([graph] lines): (a) the ``graph_merge_nesterovs``
   golden restored onto the card as in phase 9; (b) a graph with two
   inputs, two outputs and every vertex type, card vs CPU in fp32 from
   the same weights, both outputs and ``GRAPH_REF_FITS`` fit steps within
   ``GRAPH_REF_RTOL``; (c) ResNet-50 at full width (``models/resnet.py``:
   224x224x3, 1000 classes, nesterovs 0.1, l2 1e-4, the card's
   ``mixed_bf16``; BASELINE.md config #2 as ``bench.py:336-356`` runs it)
   on one staged batch of ``RESNET_BATCH`` seeded images: ``RESNET_STEPS``
   fit steps (the median ms over steps 3 to ``RESNET_STEPS``, samples/s,
   peak memory, the data loss and the l2 term of each score), untimed
   steps until the score falls below the first (at most
   ``RESNET_MAX_STEPS`` in all), one more step under ``torch.profiler``
   (device events, busy ms, idle share, top 5 CUDA ops), the FLOPs of a
   step from the conv and dense shapes (three forwards) and their bound
   at the bf16 peak, ``output()`` ms at the same batch; (d) phase 5's
   network built with ``graph_builder()`` on its MultiLayerNetwork
   twin's weights, 2 fit steps each: the graph's params and scores equal
   the twin's, and K1, K2 and K3 launch once a step each on the graph's
   run (the ``graph`` path of the kernels line); (e) that graph behind
   ``InferenceEngine`` as phase 8 serves the list (``predict`` from three
   clients, two decode sessions through the graph's ``SessionCache``,
   against ``output()`` at ``BF16_PROB_ATOL``; no K1-K4 launch), and a
   trained graph with a GravesLSTM vertex whose session steps equal
   ``rnn_time_step`` over the same split;
13. the fused training runtime ([fused] lines; no hand kernel: the epoch
   cache replays one captured CUDA graph a step, ``nn/step_graph.py``,
   where the JAX package runs one ``lax.scan`` a fused epoch): (a)
   LeNet-5 (``mixed_bf16``) on the full procedural MNIST (60,000 images,
   batch 256) through ``fit(iterator)``'s default ``ingest="auto"`` with a
   ``CheckpointListener`` (every 500 iterations and each epoch's end,
   keeping 3), 2 epochs: the ``ingest_staged_bytes{path="cache"}`` gauge
   must read the u8 wire plus the f32 labels, epoch 2 runs under
   ``torch.profiler`` (idle share; it must make 0 host-to-device copies),
   samples/s of each epoch and of a third unprofiled one, then the test
   accuracy on 10,000 images above ``MNIST_MIN_ACCURACY``; (b) LeNet
   ``CAPTURE_STEPS`` steps captured against the eager per-batch path over
   the same batches, fp32 bitwise and mixed_bf16 within
   ``GOLDEN_BF16_ATOL`` (every comparison from (b) on runs with cuDNN's
   deterministic algorithms); (c) phase 5's network through
   ``ingest="cache"``: equal to the eager steps after
   ``ATTN_CACHE_STEPS``, and one more epoch under ``torch.profiler``, with
   the counts set to 0 just before it, shows K1-K3 inside the graph's
   replays (the wrappers count 0 there, since a replay runs no wrapper;
   the ``fused`` path of the kernels line is the profiler's count of
   each kernel in that epoch); (d) a checkpoint inside epoch 2 of a run
   whose ``CheckpointManager`` saves every ``RESUME_EVERY`` steps (each
   with a finite score), alone in a directory, resumed with
   ``resume_from="auto"``: bitwise the uninterrupted run; (e) an
   ``AsyncDataSetIterator`` with a ``NormalizerStandardize`` is not
   cacheable, so ``"auto"`` takes the window path: equal to
   ``ingest="batch"`` in fp32 bitwise, the bytes staged per window; (f)
   ResNet-50 through the graph's epoch cache at
   ``examples/sustained_training.py``'s configuration (1,280 bf16 images
   at 224x224x3, batch 128): a warm-up epoch, then 2 timed epochs
   (samples/s, peak memory, first and final score), one profiled epoch,
   and 2 steps captured against eager within ``GOLDEN_BF16_ATOL``; (g)
   the health guard: ``skip_update`` over NaN batches leaves params and
   updater state bitwise unchanged (cache, then per-batch), and under
   ``abort`` the card and the CPU name the same step and layer; (h)
   ``fit_scan`` against per-batch ``fit`` over the same batches, bitwise:
   fp32 LeNet as a MultiLayerNetwork and phase 5's network as a
   ComputationGraph (K1-K3 once a step);
14. transfer learning and VGG-16 ([transfer] lines; no hand kernel: cuDNN
   and cuBLAS through torch, XLA lowerings in the JAX package): (a)
   VGG-16 at full width (``keras/trained_models.vgg16``, BASELINE.md
   config #5 as ``bench.py:439`` builds it: 224x224x3, 1000 classes,
   nesterovs at ``VGG_LR``, the card's ``mixed_bf16``, 138,357,544
   params) on one staged batch of ``VGG_BATCH`` seeded images through
   ``VGG16ImagePreProcessor``: ``VGG_STEPS`` timed steps after
   ``VGG_WARMUP`` (median ms, samples/s, peak memory), untimed steps until
   the score falls below the first, one more step under
   ``torch.profiler`` (device events, busy ms, idle share, top 5 CUDA
   ops) and the FLOP bound of three forwards at the bf16 peak; (b)
   ``TransferLearning.builder`` on that net: frozen through the last pool
   (layer ``TUNE_FROZEN``), the head swapped for ``TUNE_CLASSES``
   classes, timed and profiled as (a) (the bound: the trunk's forward and
   three forwards of the head), a few steps timed with the frozen trunk
   differentiated (what keeping it out of autograd saves), then ``TUNE_EPOCHS`` epochs through
   ``fit(iterator)``'s default (the epoch cache), the frozen trunk
   bitwise unchanged after each; one step at ``MASTER_LR`` keeps the kept
   Dense layers within one bf16 ulp of the source (rtol 2^-7, atol
   ``BF16_ATOL``, element by element: the fp32 masters
   follow the transferred weights); (c) the importer's 64x64 VGG-16
   variant in fp32, its weights carried from the CPU by flat params:
   outputs, a transfer and one fine-tune step, card vs CPU within
   ``REF_RTOL``.  K1-K4 launch 0 times on this path;
15. embeddings ([embeddings] lines; no hand kernel: gathers, einsums and
   ``index_add_`` scatters through torch, XLA in the JAX package), at
   BASELINE.md config #4 (Word2Vec SGNS: vocab 10,000, dim 128, batch
   8,192, K=5): (a) the staged SGNS step of ``bench.py:483``, one step
   against the CPU, then ``EMB_RUNS`` runs of ``EMB_STEPS`` steps a route
   in turns, plain and with the unique-row aggregation of
   ``ops/scatter.py`` (ms a step, pairs/s, the hand bytes bound of
   ``bench.py:539-542``, a profiled window: the measurement behind
   ``scatter.CARD_AGGREGATES``); (b) ``SequenceVectors.fit`` through the
   device corpus pipeline as ``bench.py:564`` runs it (2,000 seeded
   sentences of 1,000 words, window 5, no HS): a warm-up fit, then
   ``EMB_FITS`` timed fits (pairs/s, pairs a pass), one profiled pass
   (device events, busy ms, idle share, top 5), peak memory, the loss a
   pair of the last pass below the first's; (c) one pass of skip-gram
   NS, skip-gram HS and CBOW HS+NS over a small corpus on the card and
   on the CPU from the same tables and draws (``host_draws``), within
   ``EMB_REF_RTOL``, and two passes on the card under
   ``torch.use_deterministic_algorithms(True)``, bitwise equal; (d)
   ``examples/word2vec_text.py``'s configuration through
   ``Word2Vec.Builder`` (the host path): ``"queen"`` among the 3 nearest
   to ``"king"``; (e) GloVe as ``bench.py:605`` (vocab 20,000, 400,000
   zipf triples): the fused and naive AdaGrad routes equal after one
   batch, then ``GLOVE_EPOCHS`` epochs of each (triples/s); (f) PV-DBOW as
   ``bench.py:783`` (1,200 documents of 500 words): pairs/s; PV-DM and
   ``infer_vector`` on 8 small documents, card against CPU.  K1-K4 launch
   0 times on this path.

Prints a JSON line of the reference, training, inference, ring, serving,
feed-forward/convolutional, recurrent, harness, graph, fused, transfer and
embeddings results, one
``{"kernels": [...]}`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

# full width of the repo's attention model
BATCH, SEQ, HEADS, D_HEAD = 2, 8192, 4, 64
N_IN, HIDDEN, N_OUT = 64, 256, 32
STEPS = 3
# the ring: 4 shards of the training slice's shape, T = 32768 in all
RING_SHARDS = 4
RING_SEQ = RING_SHARDS * SEQ
RING_STEPS = RING_SHARDS * (RING_SHARDS + 1) // 2   # causal steps with keys

# the card's published peaks (H100 SXM data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain.  An f32 result must agree to 1e-4 of max|plain|: both
# sides accumulate in f32 from the same inputs, in another order.  A bf16
# output is checked element by element: both sides round nearly the same
# f32 value to bf16, so they differ by at most one bf16 ulp, which is
# within 2^-7 of the value (atol 1e-5 covers the f32 noise near zero).
F32_RTOL = 1e-4
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# The bf16 kernels have two references, because the tensor-core bodies
# round P (K1/K4, as the operand of O += P V; the softmax statistics stay
# f32) and P and dS (K2/K3) to bf16, as the TPU kernel's default precision
# rounds P for its P V dot.  Against the plain twin that rounds alike
# (operand_dtype=bf16): the tolerances above (out element by element, f32
# results at F32_RTOL), which need both sides to round the same f32 P.
# From continuous random inputs the kernel's S and the twin's, summed in
# another order, straddle a bf16 rounding point now and then and round one
# ulp apart, which moves a result by up to 2^-7 of one of its terms, far
# above 1e-4 of max|plain| at small shapes; so the bf16 inputs lie on a
# grid of 1/8 in [-4, 4] (GRID), where every S and dP is exact in f32
# whatever the order.  Against the all-f32 twin: the rounded results (out,
# acc, the gradients) at TC_F32_GAP of max|plain|, the statistics (lse, m,
# l: rounding P does not touch them) at F32_RTOL.  One round-to-nearest
# moves each P and dS element by at most 2^-8 of itself, independently, so
# an output or gradient element (a sum of such terms against unit-scale
# operands) moves by about 2^-8/sqrt(3) = 2.3e-3 of its own size; 1e-2 of
# the largest element leaves a factor of 4 for the tail over all elements.
GRID = 8
TC_F32_GAP = 1e-2
REF_RTOL = 1e-4     # card vs CPU reference network, fp32
# Ring vs one device in bf16 (inputs on the GRID).  The ring's output is
# held element by element (rtol 2^-7, BF16_ATOL) against the same chain
# built from K4's rounded plain twin: K4 rounds P relative to each
# segment's own running max, K1 relative to the running max over all
# earlier keys, so the ring and one device round P apart, and only the
# chain that rounds as the ring does can be held that tightly.  The
# gradients are held element by element, rtol 2^-7 (one bf16 ulp, both
# sides round f32 sums taken in another order) and an atol of 1e-3 x RMS
# of the reference for elements near zero, where the f32 sums cancel and
# their order shows, against the one-device K2/K3 fed the ring forward's
# own L and D.  Across the two whole chains (ring vs one-device K1-K3) a P
# rounded from another max, or a P or dS element near a rounding midpoint
# (the ring's L, from log-sum-exp merges, and K1's differ in the last f32
# bits), moves one term of an output or gradient sum by up to 2^-7 of
# itself.  A few such terms per row: the chains are held element by
# element to rtol 2^-7 with an atol of RING_CHAIN_REL x max|one device|
# for the elements near zero.
RING_GRAD_ATOL_RMS = 1e-3
RING_CHAIN_REL = 1e-3
# Serving (phase 8).  The served probabilities (32 classes, about 1/32
# each) are held against output() of the same request alone.  Under
# mixed_bf16 at 1e-3: predict and the top-bucket token run the same dense
# forward as output() and agree exactly on an H100; the sessions sum the
# prefill chunk and the single tokens in another order and batch shape
# (bf16 activations) and came within 1.5e-5 there, so 1e-3 leaves ~60x
# for that while staying below the signal, max|p - 1/32|, which each
# check logs beside its error.  The fp32 copy (predict, the sessions and
# the top bucket) at 1e-5: f32 sums in another order, over another ring
# capacity.  Softmax rows sum to 1 within ROW_SUM_ATOL, as in phase 6.
SERVE_BUCKETS = (1024, SEQ)
PREDICT_SHAPES = ((1, 700), (2, 1024), (1, SEQ))
PREDICT_ROUNDS = 3
PREFILL, TOKENS, HOP_CAP = 1000, 40, 2048    # the ring hops 1024 -> 2048
TIMED_TOKENS, PROFILED_TOKENS = 64, 8
# tokens held before the timed steps; the timed and profiled steps stay
# in the bucket the prefill opened (1024 and 8192)
TIMED_HELD = (1024 - TIMED_TOKENS - PROFILED_TOKENS, SEQ - 256)
BF16_PROB_ATOL, F32_PROB_ATOL, ROW_SUM_ATOL = 1e-3, 1e-5, 1e-4
WAIT_S = 300.0
# Phase 9.  The goldens' probabilities: the fp32 copy within 1e-5 (f32
# sums in another order than the CPU that wrote them); the bf16 default
# within 5e-3: one bf16 rounding per operand and activation moves them by
# under 1e-3 under the mixed policy on the CPU (the same restore as
# tests/test_torch_model_serializer.py::
# test_an_fp32_zip_restores_under_the_mixed_policy), and their signal,
# max|p - 1/classes|, is 0.14 or more.
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / \
    "regression"
GOLDENS = ("mlp_sgd", "cnn_adam")
GOLDEN_F32_ATOL, GOLDEN_BF16_ATOL = 1e-5, 5e-3
LENET_BATCH, LENET_STEPS, LENET_BATCHES = 256, 30, 8
# Phase 10.  The char-RNN of BASELINE.md config #3 in the shape of
# bench.py:383 (bench_lstm): GravesLSTM(84 -> 256) -> GravesLSTM(256) ->
# RnnOutputLayer(84), rmsprop 0.1, seed 12, batch 32, tBPTT windows of the
# bench's 64 steps; each fit takes CHAR_SEQ steps, so 4 windows.  The text
# is a first-order Markov chain whose symbols have CHAR_FANOUT successors
# each, so the score can fall.  Sampling (rnn_time_step) and sessions
# carry h and c from step to step where output() runs one scan: under
# mixed_bf16 both carry bf16 over 64-96 steps but round the input
# projection of another shape, within 5e-3 on the probabilities (the
# issue's limit; the measured error is logged beside it); the fp32 copy
# within 1e-5.  The ring LSTM against the one-device scan in fp32: 1e-5 of
# max|one device| (f32 sums of the projection in another order).
CHAR_VOCAB, CHAR_HIDDEN, CHAR_BATCH = 84, 256, 32
CHAR_SEQ, CHAR_WINDOW, CHAR_FITS, CHAR_FANOUT = 256, 64, 8, 4
SAMPLE_STEPS, SESSION_PREFILL, SESSION_STEPS = 64, 64, 32
RNN_BF16_ATOL, RNN_F32_ATOL = 5e-3, 1e-5
RING_LSTM_SHARDS, RING_LSTM_T, RING_LSTM_RTOL = 4, 1024, 1e-5
# Phase 11.  The recipe of examples/lenet_mnist.py on the procedural MNIST,
# whose designed Bayes floor is about 2.5 %: 0.94 is the bar the verify
# recipe sets for 2 epochs of 6,400 examples (the example asserts 0.95).
# The restored early-stopping model runs the same bf16 forward on the same
# params as the run that recorded its score: 1e-5 relative.
MNIST_BATCH, MNIST_TRAIN, MNIST_EPOCHS = 128, 6400, 2
MNIST_TEST_BATCH, MNIST_TEST, MNIST_MIN_ACCURACY = 500, 2000, 0.94
PROFILED_BATCHES, ES_MAX_EPOCHS, ES_RESTORE_RTOL = 10, 3, 1e-5
SOLVER_ALGOS, SOLVER_FITS = ("lbfgs", "conjugate_gradient"), 10
# Phase 12.  The graph golden at phase 9's limits.  The all-vertex graph
# card vs CPU in fp32 within 1e-5 of max|CPU| (f32 sums in another order;
# nesterovs, which passes differences on without normalizing them as Adam
# would).  ResNet-50 as bench.py:336-356 runs it (BASELINE.md config #2):
# batch 128, 224x224x3, 1000 classes, 12 fit steps on one staged batch.
# The attention graph against its MultiLayerNetwork twin as phase 5
# trains it, 2 steps; graph serving at phase 8's limits; the LSTM graph's
# session against rnn_time_step, the same bf16 operations on the same
# shapes, at 1e-6.
GRAPH_GOLDEN = "graph_merge_nesterovs"
GRAPH_REF_T, GRAPH_REF_FITS, GRAPH_REF_RTOL = 9, 3, 1e-5
RESNET_BATCH, RESNET_STEPS, RESNET_MAX_STEPS = 128, 12, 80
GRAPH_ATTN_STEPS = 2
LSTM_GRAPH_FITS, LSTM_SESSION_ATOL = 5, 1e-6
# Phase 13.  examples/sustained_training.py's LeNet half (full MNIST,
# batch 256, a CheckpointListener every 500 iterations keeping 3, here
# also at each epoch's end) for 2 epochs, held to phase 11's accuracy bar;
# captured against eager over 8 LeNet steps (fp32 bitwise; bf16 within the
# goldens' 5e-3), the attention net over 4 and ResNet-50 over 2; a resume
# from a checkpoint 10 steps into epoch 2 of 50-step epochs; the window
# path over 8 batches in windows of 3; the sustained ResNet-50 half: 1,280
# bf16 images, batch 128, 2 timed epochs after a warm-up epoch.
FUSED_BATCH, FUSED_TRAIN, FUSED_TEST, FUSED_EPOCHS = 256, 60000, 10000, 2
CKPT_EVERY, CKPT_KEEP = 500, 3
CAPTURE_STEPS, ATTN_CACHE_STEPS = 8, 4
RESUME_TRAIN, RESUME_EVERY = 12800, 30
WINDOW_BATCHES, WINDOW_SIZE = 8, 3
RESNET_CACHE_N, RESNET_CACHE_EPOCHS = 1280, 2
# Phase 14.  VGG-16 (BASELINE.md config #5) as bench.py:439 builds it:
# vgg16() at 224x224x3, 1000 classes, batch 256, the card's mixed_bf16,
# nesterovs, on seeded 0-255 images through VGG16ImagePreProcessor.  From
# vgg16()'s He init the configuration's lr 1e-2 diverges on such images
# (on the CPU at batch 4 in fp32 the score went 762 -> 3.8e30 -> NaN in 3
# steps; 1e-4 diverged too, 1e-6 fell from 762 to 184 in one step), so
# the run takes VGG_LR, its one change to the configuration (a rate
# moves no time).  VGG_WARMUP untimed steps, then VGG_STEPS timed ones
# (the median), untimed steps until the score falls below the first (at
# most VGG_MAX_STEPS in all).  The fine-tune freezes through the last
# pool (layer TUNE_FROZEN) and swaps the head for TUNE_CLASSES classes:
# the same steps per batch, then TUNE_EPOCHS epochs of TUNE_CACHE_BATCHES
# batches through fit(iterator)'s default (the epoch cache); the frozen
# trunk must stay bitwise.  The master check: one step at MASTER_LR keeps
# the kept Dense layers within one bf16 ulp of the source, element by
# element (2^-7 of the value, and BF16_ATOL for the biases near 0, which
# a 1e-8 step may move by more than their own ulp); a fine-tune that
# started from the fresh init's masters would move the weights by their
# own size.  The importer's 64x64 variant (tests/test_keras_import.py:521)
# card vs CPU in fp32 at phase 9's REF_RTOL; the card's machine has no
# h5py, so its weights cross by flat params and the h5 reading is held by
# the CPU tests.
VGG_BATCH, VGG_WARMUP, VGG_STEPS, VGG_MAX_STEPS, VGG_LR = 256, 2, 12, 40, 1e-6
TUNE_FROZEN, TUNE_CLASSES, TUNE_CACHE_BATCHES, TUNE_EPOCHS = 17, 10, 2, 2
MASTER_LR, VGG_SMALL, VGG_SMALL_CLASSES = 1e-8, 64, 5
# Phase 15.  BASELINE.md config #4 (Word2Vec skip-gram with negative
# sampling) as bench.py builds it: the staged step of bench.py:483 (vocab
# 10,000, dim 128, batch 8,192 pairs, K=5, seeded indices, 2 x 800 steps,
# with and without the unique-row aggregation) and the end-to-end fit of
# bench.py:564 (2,000 seeded sentences of 1,000 words, window 5, no HS,
# batch 8,192, pair_generation="device": a warm-up fit, then EMB_FITS
# timed ones and a profiled one); GloVe as bench.py:605 (vocab 20,000,
# dim 128, batch 8,192, 400,000 zipf triples, 2 epochs a route); PV-DBOW
# as bench.py:783 (1,200 documents of 500 words, vocab 10,000, D128,
# K=5); examples/word2vec_text.py's configuration on the host path.
# Card against CPU in fp32 (the same tables, the same draws): the tables
# within EMB_REF_RTOL of max|CPU|.  On the card index_add_ adds duplicate
# rows by atomics and the einsums run on cuBLAS, so the sums come in
# another order; on the CPU a reordering of the duplicate sums alone (the
# aggregated route against the plain one) moves a one-pass table by up to
# 2.5e-6 of its largest entry, and one full-width GloVe batch (~3,100
# duplicates of its hottest row) by 2.9e-6, so 2e-5 leaves a factor of
# ~7.  GloVe's two routes are held after one batch: over 2 epochs the
# AdaGrad feedback grows that 2.9e-6 to 1.6e-3 on the CPU, the same math.
EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_K = 10000, 128, 8192, 5
EMB_STEPS, EMB_RUNS, EMB_PROFILED_STEPS = 800, 2, 20
EMB_WORDS, EMB_SENT_LEN, EMB_WINDOW, EMB_FITS = 2_000_000, 1000, 5, 3
EMB_REF_RTOL = 2e-5
GLOVE_VOCAB, GLOVE_TRIPLES, GLOVE_EPOCHS = 20000, 400_000, 2
PV_DOCS, PV_DOC_LEN = 1200, 500
W2V_SENTENCES = [
    "king man royal crown", "queen woman royal crown",
    "king rules the kingdom", "queen rules the kingdom",
    "the king is a man", "the queen is a woman",
    "a man walks the dog", "a woman walks the dog",
    "day sun bright light", "night moon dark light"] * 60


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(what: str, got: torch.Tensor, want: torch.Tensor,
            atol: float = BF16_ATOL, rel: float = F32_RTOL) -> dict:
    """Hold a kernel's result against its plain version; raises when they
    disagree.  A bf16 result is checked element by element (rtol 2^-7,
    ``atol``), an f32 one to ``rel`` of max|plain|.  Returns max|err| and
    max|err| / max|plain|."""
    bf16 = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{what}: non-finite values")
    scale = want.abs().max().item()
    if scale == 0.0:
        raise RuntimeError(f"{what}: the plain result is all zeros, the "
                           "comparison would prove nothing")
    diff = (got - want).abs()
    err = diff.max().item()
    if bf16:
        bad = int((diff > atol + BF16_RTOL * want.abs()).sum().item())
        ok, tol = bad == 0, f"rtol {BF16_RTOL:g}, atol {atol:g}, " \
                            f"element-wise; {bad} elements outside"
    else:
        ok, tol = err <= rel * scale, f"{rel:g} of max|plain|"
    log(f"[check] {what}: max_abs_err={err:.3e} rel={err / scale:.3e} "
        f"({tol})")
    if not ok:
        raise RuntimeError(f"{what}: disagrees with its reference ({tol})")
    return {"max_abs_err": err, "rel": err / scale}


# ------------------------------------------------------------- bounds
def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def causal_pairs(t: int) -> int:
    """(query, key) pairs of causal attention over t positions."""
    return t * (t + 1) // 2


def bound_ms(products: int, pairs: int, q: torch.Tensor, inputs,
             outputs) -> tuple:
    """Least time for ``products`` matrix products over ``pairs`` (query,
    key) pairs of bf16 ``q``'s batch and heads, each pair a d-long dot, at
    the bf16 peak, or for the bytes of ``inputs`` read once and ``outputs``
    written once: the larger, and which of the two it is."""
    assert q.dtype == torch.bfloat16
    b, _, h, d = q.shape
    flops = products * 2.0 * d * pairs * b * h
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = (nbytes(*inputs) + nbytes(*outputs)) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ------------------------------------------------------------- phases
KERNELS = ("flash_fwd", "flash_fwd_partials", "flash_bwd_dkdv",
           "flash_bwd_dq")


def randn(shape, gen, dtype) -> torch.Tensor:
    """Normal values on the card; for bf16 rounded to the exact-sum GRID."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if dtype == torch.bfloat16:
        x = (x * GRID).round().clamp(-4 * GRID, 4 * GRID) / GRID
    return x.to(dtype)


def bwd_twins(A, args, causal: bool, scale: float):
    """The plain K2/K3 results ((dk, dv), dq) that the kernels are held to:
    with P and dS rounded to bf16 for bf16 q and dO (the tensor-core
    route), else all-f32; and the all-f32 twin for the tensor-core route
    (None otherwise)."""
    q, g = args[0], args[3]
    tensor_core = q.dtype == g.dtype == torch.bfloat16
    twins = []
    for operands in ([torch.bfloat16, None] if tensor_core else [None]):
        twins.append((A.flash_dkdv_plain(*args, causal, scale,
                                         operand_dtype=operands),
                      A.flash_dq_plain(*args, causal, scale,
                                       operand_dtype=operands)))
    return twins[0], (twins[1] if tensor_core else None)


def fwd_twins(A, q, k, v, causal: bool, scale: float, mode: str):
    """The plain K1/K4 results in ``mode`` that the kernel is held to: with
    P rounded to bf16 for bf16 q/k/v (the tensor-core route), else
    all-f32; and the all-f32 twin for the tensor-core route (None
    otherwise)."""
    tensor_core = q.dtype == torch.bfloat16
    twins = [A.flash_forward_plain(q, k, v, causal, scale, mode,
                                   operand_dtype=operands)
             for operands in ([torch.bfloat16, None] if tensor_core
                              else [None])]
    return twins[0], (twins[1] if tensor_core else None)


def ring_step_inputs(A, gen, dtype, scale: float):
    """K2/K3's inputs as the ring launches them most often (6 of the 10
    launches of one causal 4-shard ring): a non-causal full SEQ x SEQ
    segment, the queries of the second half of a causal 2 * SEQ sequence
    against the keys of its first half, with that sequence's global L and
    D.  Returns (q, k, v, dO, causal=False, L, D)."""
    q, k, v, g = (randn((BATCH, 2 * SEQ, HEADS, D_HEAD), gen, dtype)
                  for _ in range(4))
    out, lse = A.flash_forward(q, k, v, causal=True, sm_scale=scale,
                               with_lse=True)
    late = slice(SEQ, 2 * SEQ)
    D = (g[:, late].float() * out[:, late].float()).sum(-1).contiguous()
    return (q[:, late].contiguous(), k[:, :SEQ].contiguous(),
            v[:, :SEQ].contiguous(), g[:, late].contiguous(), False,
            lse[:, late].contiguous(), D)


def phase_kernels(A, seed: int):
    """Each kernel against its plain version (bf16 and f32), then timed
    in bf16, the dtype the training path and the ring give it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (BATCH, SEQ, HEADS, D_HEAD)
    scale = 1.0 / D_HEAD ** 0.5
    half = SEQ // 2
    checks = {name: [] for name in KERNELS}
    gaps = {name: [] for name in KERNELS}
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = (randn(shape, gen, dtype) for _ in range(4))
        out, lse = A.flash_forward(q, k, v, causal=True, sm_scale=scale,
                                   with_lse=True)
        (plain_out, plain_lse), f32_twin = fwd_twins(
            A, q, k, v, True, scale, "normalized_lse")
        out_n = A.flash_forward(q, k, v, causal=True, sm_scale=scale,
                                with_lse=False)
        Drow = (g.float() * out.float()).sum(-1).contiguous()
        dk, dv = A.flash_dkdv(q, k, v, g, lse, Drow, causal=True,
                              sm_scale=scale)
        dq = A.flash_dq(q, k, v, g, lse, Drow, causal=True, sm_scale=scale)
        torch.cuda.synchronize()
        items = {
            "flash_fwd": [("out", out, plain_out),
                          ("out_normalized", out_n, plain_out),
                          ("lse", lse, plain_lse)],
            "flash_bwd_dkdv": [], "flash_bwd_dq": [],
            "flash_fwd_partials": [],
        }
        # against the all-f32 twin: (result, got, want, tolerance)
        gap_items = {name: [] for name in KERNELS}
        if f32_twin is not None:
            gap_items["flash_fwd"] += [("out", out, f32_twin[0], TC_F32_GAP),
                                       ("lse", lse, f32_twin[1], F32_RTOL)]

        def hold_bwd(label, got_dkdv, got_dq, args, causal):
            """K2/K3's results against their twins (see bwd_twins)."""
            twin, f32_twin = bwd_twins(A, args, causal, scale)
            (pdk, pdv), pdq = twin
            items["flash_bwd_dkdv"] += [(f"{label}dk", got_dkdv[0], pdk),
                                        (f"{label}dv", got_dkdv[1], pdv)]
            items["flash_bwd_dq"] += [(f"{label}dq", got_dq, pdq)]
            if f32_twin is not None:
                (pdk, pdv), pdq = f32_twin
                gap_items["flash_bwd_dkdv"] += [
                    (f"{label}dk", got_dkdv[0], pdk, TC_F32_GAP),
                    (f"{label}dv", got_dkdv[1], pdv, TC_F32_GAP)]
                gap_items["flash_bwd_dq"] += [
                    (f"{label}dq", got_dq, pdq, TC_F32_GAP)]

        hold_bwd("", (dk, dv), dq, (q, k, v, g, lse, Drow), True)
        del dk, dv, dq, plain_out, plain_lse, out_n, f32_twin
        # K4, causal (the diagonal ring step) and not (every other step)
        for causal in (True, False):
            got = A.flash_attention_partial(q, k, v, causal=causal,
                                            sm_scale=scale)
            want, f32_want = fwd_twins(A, q, k, v, causal, scale,
                                       "partials")
            results = ("acc", "m", "l")
            items["flash_fwd_partials"] += [
                (f"{r} causal={causal}", a, b)
                for r, a, b in zip(results, got, want)]
            if f32_want is not None:
                gap_items["flash_fwd_partials"] += [
                    (f"{r} causal={causal}", a, b,
                     TC_F32_GAP if r == "acc" else F32_RTOL)
                    for r, a, b in zip(results, got, f32_want)]
        # K2/K3 in segment form, Tq = SEQ against a K/V half (Tk = SEQ/2)
        # with the global L and D of the whole sequence: the causal first
        # half (local positions are global there) and the non-causal
        # second half; and the ring's most common step, Tq = Tk = SEQ
        # non-causal with the L and D of a 2 * SEQ sequence
        out_nc, lse_nc = A.flash_forward(q, k, v, causal=False,
                                         sm_scale=scale, with_lse=True)
        D_nc = (g.float() * out_nc.float()).sum(-1).contiguous()
        ring_step = ring_step_inputs(A, gen, dtype, scale)
        segments = {
            "first half causal": (q, k[:, :half], v[:, :half], g, True, lse,
                                  Drow),
            "second half": (q, k[:, half:], v[:, half:], g, False, lse_nc,
                            D_nc),
            f"ring step {SEQ}x{SEQ}": ring_step}
        for label, (q_, ks, vs, g_, causal, L_, D_) in segments.items():
            ks, vs = ks.contiguous(), vs.contiguous()
            sdk, sdv = A.flash_dkdv(q_, ks, vs, g_, L_, D_, causal=causal,
                                    sm_scale=scale)
            sdq = A.flash_dq(q_, ks, vs, g_, L_, D_, causal=causal,
                             sm_scale=scale)
            hold_bwd(f"segment {label} ", (sdk, sdv), sdq,
                     (q_, ks, vs, g_, L_, D_), causal)
        dname = str(dtype).replace("torch.", "")
        for name, results in items.items():
            for result, got, want in results:
                checks[name].append(
                    {"result": result, "inputs": dname,
                     **compare(f"{name} {result} ({dname} inputs)", got,
                               want)})
        for name, results in gap_items.items():
            for result, got, want, rel in results:
                gaps[name].append(
                    {"result": result, "inputs": dname,
                     **compare(f"{name} {result} ({dname} inputs) vs the "
                               "all-f32 twin", got.float(), want.float(),
                               rel=rel)})
        inputs[dtype] = (q, k, v, g, out, lse, Drow, lse_nc, D_nc,
                         ring_step)
        del items, gap_items, got, want, f32_want, sdk, sdv, sdq

    q, k, v, g, out, lse, Drow, lse_nc, D_nc, ring_step = \
        inputs[torch.bfloat16]
    rq, rk, rv, rg, _, rL, rD = ring_step
    del inputs[torch.float32]
    torch.cuda.empty_cache()
    A.reset_launches()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd(causal=True):
        return sdpa(qt, kt, vt, is_causal=causal, scale=scale)

    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qt, kt, vt))
    sdpa_out = sdpa(qr, kr, vr, is_causal=True, scale=scale)
    gt = g.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, (qr, kr, vr), gt,
                                   retain_graph=True)

    ks, vs = k[:, half:].contiguous(), v[:, half:].contiguous()
    plain = dict(iters=3, warmup=1)
    t = {
        "flash_fwd": time_ms(lambda: A.flash_forward(
            q, k, v, causal=True, sm_scale=scale, with_lse=True)),
        "flash_fwd_normalized": time_ms(lambda: A.flash_forward(
            q, k, v, causal=True, sm_scale=scale, with_lse=False)),
        "flash_fwd_partials": time_ms(lambda: A.flash_attention_partial(
            q, k, v, causal=False, sm_scale=scale)),
        "flash_bwd_dkdv": time_ms(lambda: A.flash_dkdv(
            q, k, v, g, lse, Drow, causal=True, sm_scale=scale)),
        "flash_bwd_dq": time_ms(lambda: A.flash_dq(
            q, k, v, g, lse, Drow, causal=True, sm_scale=scale)),
        "segment_dkdv": time_ms(lambda: A.flash_dkdv(
            q, ks, vs, g, lse_nc, D_nc, causal=False, sm_scale=scale)),
        "segment_dq": time_ms(lambda: A.flash_dq(
            q, ks, vs, g, lse_nc, D_nc, causal=False, sm_scale=scale)),
        "ring_step_dkdv": time_ms(lambda: A.flash_dkdv(
            rq, rk, rv, rg, rL, rD, causal=False, sm_scale=scale)),
        "ring_step_dq": time_ms(lambda: A.flash_dq(
            rq, rk, rv, rg, rL, rD, causal=False, sm_scale=scale)),
    }
    plain_t = {
        "flash_fwd": time_ms(lambda: A.flash_forward_plain(
            q, k, v, True, scale, "normalized_lse",
            operand_dtype=torch.bfloat16), **plain),
        "flash_fwd_partials": time_ms(lambda: A.flash_forward_plain(
            q, k, v, False, scale, "partials",
            operand_dtype=torch.bfloat16), **plain),
        "flash_bwd_dkdv": time_ms(lambda: A.flash_dkdv_plain(
            q, k, v, g, lse, Drow, True, scale,
            operand_dtype=torch.bfloat16), **plain),
        "flash_bwd_dq": time_ms(lambda: A.flash_dq_plain(
            q, k, v, g, lse, Drow, True, scale,
            operand_dtype=torch.bfloat16), **plain),
    }
    lib_fwd, lib_bwd = time_ms(sdpa_fwd), time_ms(sdpa_bwd)
    lib_fwd_full = time_ms(lambda: sdpa_fwd(causal=False))
    A.reset_launches()
    f32_grad = torch.empty(q.shape, dtype=torch.float32, device="meta")
    f32_seg = torch.empty(ks.shape, dtype=torch.float32, device="meta")
    rows = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
    bwd_in = (q, k, v, g, lse, Drow)
    seg_in = (q, ks, vs, g, lse_nc, D_nc)
    tri, full, seg = causal_pairs(SEQ), SEQ * SEQ, SEQ * half
    bounds = {
        # q, k, v in; out + lse out; two products (S = QK^T, PV)
        "flash_fwd": bound_ms(2, tri, q, (q, k, v), (out, lse)),
        # q, k, v in; acc, m, l out (f32); the same two, no causal half
        "flash_fwd_partials": bound_ms(2, full, q, (q, k, v),
                                       (f32_grad, rows, rows)),
        # q, k, v, dO, L, D in; dk, dv out (f32); four (S, dP, dV, dK)
        "flash_bwd_dkdv": bound_ms(4, tri, q, bwd_in, (f32_grad, f32_grad)),
        # same in; dq out (f32); three (S, dP, dQ)
        "flash_bwd_dq": bound_ms(3, tri, q, bwd_in, (f32_grad,)),
    }
    seg_bounds = {
        "flash_bwd_dkdv": bound_ms(4, seg, q, seg_in, (f32_seg, f32_seg)),
        "flash_bwd_dq": bound_ms(3, seg, q, seg_in, (f32_grad,)),
    }
    ring_in = (rq, rk, rv, rg, rL, rD)
    ring_bounds = {
        "flash_bwd_dkdv": bound_ms(4, full, q, ring_in, (f32_grad, f32_grad)),
        "flash_bwd_dq": bound_ms(3, full, q, ring_in, (f32_grad,)),
    }
    library = {"flash_fwd": lib_fwd, "flash_fwd_partials": lib_fwd_full,
               "flash_bwd_dkdv": lib_bwd, "flash_bwd_dq": lib_bwd}
    timing = {name: {"ms": t[name], "plain_ms": plain_t[name],
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1],
                     "library_ms": library[name],
                     "max_abs_err": max(c["max_abs_err"]
                                        for c in checks[name]),
                     "checks": checks[name]}
              for name in KERNELS}
    timing["flash_fwd"]["ms_normalized"] = t["flash_fwd_normalized"]
    for name in KERNELS:
        timing[name]["f32_twin_gap"] = gaps[name]
    for name, kind in (("flash_bwd_dkdv", "dkdv"), ("flash_bwd_dq", "dq")):
        timing[name]["segment_ms"] = t["segment_" + kind]
        timing[name]["segment_bound_ms"] = seg_bounds[name][0]
        timing[name]["ring_step_ms"] = t["ring_step_" + kind]
        timing[name]["ring_step_bound_ms"] = ring_bounds[name][0]
    log(f"[kernels] library yardsticks: sdpa fwd causal {lib_fwd:.4f} ms, "
        f"non-causal {lib_fwd_full:.4f} ms, sdpa bwd causal (dq, dk, dv "
        f"together) {lib_bwd:.4f} ms")
    return timing


def build_net(N, A, *, seed, n_in, hidden, heads, n_out, cache_len,
              compute_dtype=None, device=None):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    b = N.NeuralNetConfiguration.builder().seed(seed).updater("adam") \
        .learning_rate(1e-3)
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(CausalSelfAttention(n_out=hidden, n_heads=heads,
                                       cache_len=cache_len))
            .layer(RnnOutputLayer(n_out=n_out, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(inputs.recurrent(n_in, cache_len))
            .build())
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(conf, device=device).init()


def make_batch(seed: int, batch: int, t: int, n_in: int, n_out: int):
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, t, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, (batch, t))]
    return DataSet(x, y)


def phase_reference(N, A, seed: int) -> dict:
    """2 fp32 fit steps of a small net on the card (kernels) and on the
    CPU (plain versions) from the same weights: the card must agree."""
    kw = dict(seed=seed, n_in=16, hidden=64, heads=2, n_out=8,
              cache_len=200, compute_dtype="float32")
    card = build_net(N, A, **kw)
    cpu = build_net(N, A, device="cpu", **kw)
    cpu.set_flat_params(card.get_flat_params())
    ds = make_batch(seed + 1, 2, 200, 16, 8)
    A.reset_launches()
    worst = 0.0
    for step in range(2):
        card.fit(ds)
        cpu.fit(ds)
        a, b = card.score(), cpu.score()
        pa, pb = card.get_flat_params(), cpu.get_flat_params()
        p_rel = float(np.abs(pa - pb).max() / np.abs(pb).max())
        s_rel = abs(a - b) / abs(b)
        log(f"[reference] step {step}: score card={a:.7f} cpu={b:.7f} "
            f"rel={s_rel:.2e}; params rel={p_rel:.2e} (tol {REF_RTOL:g})")
        if not (s_rel <= REF_RTOL and p_rel <= REF_RTOL):
            raise RuntimeError("card and CPU reference disagree")
        worst = max(worst, s_rel, p_rel)
    if A.LAUNCHES["flash_fwd"] != 2 or A.LAUNCHES["flash_bwd_dq"] != 2:
        raise RuntimeError(f"reference net did not run on the kernels: "
                           f"{A.LAUNCHES}")
    return {"steps": 2, "max_rel": worst}


PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel",
                "flash_bwd_dq_kernel")     # K1 and K4 share flash_fwd_kernel


def profiled(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler`` and synchronize: the host wall
    ms (profiler overhead included), the number of device events, the
    CUDA ms by kernel name and the union of the device's busy intervals
    in ms.  Read from the profiler's raw events: their parse into
    ``FunctionEvent``s takes tens of seconds for a trace as long as a
    full-width Word2Vec pass (~70,000 device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    by_name = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy_ns, end = 0, None
    for a, b, _ in sorted(device):
        if end is None or a > end:
            busy_ns, end = busy_ns + b - a, b
        elif b > end:
            busy_ns, end = busy_ns + b - end, b
    return wall_ms, len(device), by_name, busy_ns / 1e6


def profile_step(net, ds, steady_ms: float) -> dict:
    """One more steady ``fit`` step under ``torch.profiler``: the CUDA time
    of the port's kernels by name, of everything else in all and by its 5
    largest kernels, and the step's idle share: 1 - (the union of the
    device's busy intervals) / (the host wall time of the profiled step,
    which includes the profiler's overhead), and against ``steady_ms``,
    the fastest unprofiled steady step of the same run."""
    def step():
        net.fit(ds)
        net.score()

    wall_ms, n_events, by_name, busy_ms = profiled(step)
    ours = {k: sum(ms for name, ms in by_name.items() if k in name)
            for k in PORT_KERNELS}
    rest = sorted(((ms, name) for name, ms in by_name.items()
                   if not any(k in name for k in PORT_KERNELS)),
                  reverse=True)
    result = {"device_events": n_events, "step_ms_profiled": wall_ms,
              "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms,
              "idle_share_steady": 1.0 - busy_ms / steady_ms,
              "port_kernels_ms": ours,
              "other_ms": sum(ms for ms, _ in rest),
              "other_top5": [{"name": name[:120], "ms": ms}
                             for ms, name in rest[:5]]}
    log(f"[profile] one fit step under torch.profiler: host "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
        f"{result['idle_share']:.3f}; {result['idle_share_steady']:.3f} of "
        f"the steady step, {steady_ms:.3f} ms; {n_events} device "
        f"events); port "
        f"kernels {ours}; everything else {result['other_ms']:.3f} ms, "
        f"top 5: " + "; ".join(f"{d['name'][:60]} {d['ms']:.3f}"
                               for d in result["other_top5"]))
    return result


def phase_training(N, A, seed: int):
    net = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN, heads=HEADS,
                    n_out=N_OUT, cache_len=SEQ)
    pol = net._pol()
    if pol.name != "mixed_bf16":
        raise RuntimeError(f"the card's default policy is {pol.name}")
    ds = make_batch(seed, BATCH, SEQ, N_IN, N_OUT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # counts of the main path's run only
    scores, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        s = net.score()           # a host read: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    launches = dict(A.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[training] scores {scores}; step ms {step_ms}; launches "
        f"{launches}; peak memory {peak / 2**30:.3f} GiB")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"non-finite training score: {scores}")
    expected = {name: STEPS for name in KERNELS}
    expected["flash_fwd_partials"] = 0         # the ring's kernel only
    if launches != expected:
        raise RuntimeError(f"launches in {STEPS} steps: {launches}, "
                           f"expected {expected}")
    return net, ds, {"scores": scores, "step_ms": step_ms,
                     "peak_mem_bytes": peak, "launches": launches,
                     "profile": profile_step(net, ds, min(step_ms[1:]))}


def phase_inference(net, ds) -> dict:
    t0 = time.perf_counter()
    out = net.output(ds.features)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if tuple(out.shape) != (BATCH, SEQ, N_OUT):
        raise RuntimeError(f"output shape {tuple(out.shape)}")
    if out.dtype != torch.float32 or not torch.isfinite(out).all():
        raise RuntimeError("output is not finite fp32")
    row_err = (out.sum(-1) - 1).abs().max().item()
    if row_err > 1e-4:
        raise RuntimeError(f"softmax rows do not sum to 1: {row_err}")
    log(f"[inference] output {tuple(out.shape)} in {ms:.1f} ms, row-sum "
        f"err {row_err:.2e}")
    return {"output_ms": ms, "row_sum_err": row_err}


def backward_at_ring_stats(A, S, q, k, v, g):
    """(dq, dk, dv) in q's dtype of one-device K2/K3 over the whole
    sequence, fed the L and D of the ring forward instead of K1's."""
    def shards(x):
        return [c.contiguous() for c in torch.chunk(x, RING_SHARDS, dim=1)]

    outs, lses = S._ring_flash_forward(shards(q), shards(k), shards(v), True,
                                       D_HEAD ** -0.5)
    out, L = torch.cat(outs, dim=1), torch.cat(lses, dim=1)
    D = (g.float() * out.float()).sum(-1)
    grads = A.flash_attention_bwd(q, k, v, None, L, g, causal=True,
                                  sm_scale=D_HEAD ** -0.5, D_row=D)
    return [x.to(q.dtype) for x in grads]


def ring_forward_twin(A, S, q, k, v):
    """The causal ring forward's output built from K4's plain twin that
    rounds P to bf16, merged by the ring's own ``_merge`` in the ring's
    order (shard i: its own K/V first, causal by local positions, then
    shards i - 1, ..., 0): what the bf16 ring forward computes, up to the
    order of f32 sums."""
    chunks = [torch.chunk(x, RING_SHARDS, dim=1) for x in (q, k, v)]
    qs, ks, vs = ([c.contiguous() for c in x] for x in chunks)
    outs = []
    for i in range(RING_SHARDS):
        state = S._empty_partials(qs[i])
        for j in range(i, -1, -1):
            part = A.flash_forward_plain(qs[i], ks[j], vs[j], j == i,
                                         D_HEAD ** -0.5, "partials",
                                         operand_dtype=torch.bfloat16)
            state = S._merge(*state, *part)
        o, _, l = state
        outs.append((o / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def phase_ring(A, S, seed: int) -> dict:
    """The ring flash attention over 4 shards on one card, forward and
    ``backward(g)``, against the one-device flash attention (K1-K3) at the
    same T, in f32 and bf16 (bf16 on the GRID: the output against the ring
    chain of K4's rounded twin, the gradients against one-device K2/K3 at
    the ring forward's L and D, and the whole chains at RING_CHAIN_REL);
    the exact launch counts of one causal fwd+bwd; both paths timed in
    bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    shape = (BATCH, RING_SEQ, HEADS, D_HEAD)
    sp = S.SequenceParallel(devices=["cuda"] * RING_SHARDS)
    expected = {"flash_fwd": 0, "flash_fwd_partials": RING_STEPS,
                "flash_bwd_dkdv": RING_STEPS, "flash_bwd_dq": RING_STEPS}

    def fwd_bwd(q, k, v, g, ring: bool):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = (sp.attention(*xs, causal=True, impl="ring_flash") if ring
               else A.flash_attention(*xs, causal=True))
        out.backward(g)
        return [out.detach()] + [x.grad for x in xs]

    result = {"shards": RING_SHARDS, "shape": list(shape), "checks": []}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (randn(shape, gen, dtype) for _ in range(4))
        torch.cuda.synchronize()
        A.reset_launches()        # counts of the ring's run only
        ring = fwd_bwd(q, k, v, g, True)
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        dname = str(dtype).replace("torch.", "")
        log(f"[ring] {dname} causal fwd+bwd launches {launches}")
        if launches != expected:
            raise RuntimeError(f"ring launches {launches}, expected "
                               f"{expected}")
        result["launches"] = launches
        ref = fwd_bwd(q, k, v, g, False)
        names = ("out", "dq", "dk", "dv")
        if dtype == torch.bfloat16:
            for name, got, want in zip(names, ring, ref):
                result["checks"].append(
                    {"result": name + " whole chain", "inputs": dname,
                     **compare(f"ring {name} vs one device, whole chains "
                               f"({dname} inputs)", got, want,
                               atol=RING_CHAIN_REL
                               * want.float().abs().max().item())})
            ref = ([ring_forward_twin(A, S, q, k, v)]
                   + backward_at_ring_stats(A, S, q, k, v, g))
        for name, got, want in zip(names, ring, ref):
            atol = (BF16_ATOL if name == "out" else RING_GRAD_ATOL_RMS
                    * want.float().pow(2).mean().sqrt().item())
            what = ("one device" if dtype == torch.float32
                    else "the ring chain of K4's rounded twin"
                    if name == "out"
                    else "one-device K2/K3 at the ring's L and D")
            result["checks"].append(
                {"result": name, "inputs": dname,
                 **compare(f"ring {name} vs {what} ({dname} inputs)",
                           got, want, atol=atol)})
        del ring, ref
        if dtype == torch.bfloat16:
            result["ring_ms"] = time_ms(lambda: fwd_bwd(q, k, v, g, True),
                                        iters=3, warmup=1)
            result["one_device_ms"] = time_ms(
                lambda: fwd_bwd(q, k, v, g, False), iters=3, warmup=1)
            log(f"[ring] bf16 fwd+bwd at T={RING_SEQ}: ring "
                f"{result['ring_ms']:.3f} ms, one device "
                f"{result['one_device_ms']:.3f} ms")
    return result


def run_threads(targets, errors) -> None:
    """Run each target on a thread of its own; raise the first error one
    of them recorded, or if one is still running after WAIT_S."""
    threads = [threading.Thread(target=t, daemon=True) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a serving client did not finish")
    if errors:
        raise errors[0]


def hold_probs(what: str, got: np.ndarray, want: np.ndarray,
               atol: float, tag: str = "serving") -> tuple:
    """Probabilities of the served path against the reference: the same
    shape, finite, rows summing to 1, within ``atol``.  Returns the error
    and the signal, max|want - 1/classes|: how far the reference is from
    the uniform output, which the limit must sit below to mean
    anything."""
    if not isinstance(got, np.ndarray) or got.shape != want.shape:
        raise RuntimeError(f"{what}: got {type(got).__name__} "
                           f"{getattr(got, 'shape', None)}, want "
                           f"{want.shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{what}: non-finite values")
    row_err = float(np.abs(got.sum(-1) - 1.0).max())
    err = float(np.abs(got - want).max())
    signal = float(np.abs(want - 1.0 / want.shape[-1]).max())
    log(f"[{tag}] {what}: max_abs_err={err:.3e} (atol {atol:g}), signal "
        f"max|p - 1/{want.shape[-1]}|={signal:.3e}, row-sum err "
        f"{row_err:.2e}")
    if err > atol or row_err > ROW_SUM_ATOL:
        raise RuntimeError(f"{what}: disagrees with output()")
    return err, signal


def worst(checks) -> dict:
    """The largest error and the smallest signal of several checks."""
    checks = list(checks)
    return {"max_abs_err": max(e for e, _ in checks),
            "min_signal": min(s for _, s in checks)}


def serve_predict(engine, net, rng, reg, atol: float) -> dict:
    """Three client threads, PREDICT_ROUNDS rounds: the two requests that
    share the 1024 bucket start together and the 8192 one 2 ms later, so
    the batcher can coalesce the first two."""
    xs = [rng.randn(b, t, N_IN).astype(np.float32) for b, t in
          PREDICT_SHAPES]
    refs = [net.output(x).cpu().numpy() for x in xs]
    outs, errors = {i: [] for i in range(len(xs))}, []
    barrier = threading.Barrier(len(xs))
    batches0 = reg.counter("serving_batches_total").value(
        engine=engine.name)

    def client(i):
        try:
            for _ in range(PREDICT_ROUNDS):
                barrier.wait(WAIT_S)
                if PREDICT_SHAPES[i][1] == SEQ:
                    time.sleep(0.002)
                outs[i].append(engine.predict(xs[i], timeout=WAIT_S))
        except Exception as e:     # raised by run_threads
            errors.append(e)
            barrier.abort()

    run_threads([lambda i=i: client(i) for i in range(len(xs))], errors)
    held = worst(hold_probs(f"{engine.name} predict {xs[i].shape} round "
                            f"{r}", got, refs[i], atol)
                 for i in outs for r, got in enumerate(outs[i]))
    requests = len(xs) * PREDICT_ROUNDS
    batches = reg.counter("serving_batches_total").value(
        engine=engine.name) - batches0
    if not batches < requests:
        raise RuntimeError(f"{requests} requests in {batches} batches: no "
                           "two were coalesced")
    lat = reg.histogram("serving_request_latency_ms").stats(
        model=engine.name)
    # output() of the longest request alone, warm (its reference above
    # was the first call at this shape)
    out_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.output(xs[-1])
        torch.cuda.synchronize()
        out_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[serving] {engine.name} predict: {requests} requests in "
        f"{batches:g} batches; "
        f"latency p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms; "
        f"output() of {xs[-1].shape} alone {out_ms} ms")
    return {"requests": requests, "batches": batches, **held,
            "latency_ms": {k: lat[k] for k in ("count", "p50", "p99",
                                               "max")},
            "output_ms_longest": out_ms}


def two_sessions(engine, net, rng, tag: str, atol: float) -> dict:
    """Two concurrent decode sessions: a PREFILL-token chunk, then TOKENS
    single tokens (the ring hops from 1024 to 2048), against ``output()``
    of each whole sequence."""
    xs = [rng.randn(1, PREFILL + TOKENS, N_IN).astype(np.float32)
          for _ in range(2)]
    outs, errors = {}, []

    def session(j):
        try:
            sid = f"{tag}-{j}"
            chunk = engine.predict_session(sid, xs[j][:, :PREFILL])
            steps = [engine.predict_session(sid, xs[j][:, t])[:, None]
                     for t in range(PREFILL, PREFILL + TOKENS)]
            outs[j] = np.concatenate([chunk] + steps, axis=1)
        except Exception as e:     # raised by run_threads
            errors.append(e)

    run_threads([lambda j=j: session(j) for j in range(2)], errors)
    caps = [engine.sessions.session_capacity(f"{tag}-{j}") for j in range(2)]
    if caps != [HOP_CAP, HOP_CAP]:
        raise RuntimeError(f"{tag} sessions hold rings of {caps}, not "
                           f"{HOP_CAP}")
    held = worst(hold_probs(f"{tag} session {j}", outs[j],
                            net.output(xs[j]).cpu().numpy(), atol)
                 for j in range(2))
    for j in range(2):
        engine.sessions.clear(f"{tag}-{j}")
    return {**held, "capacity": caps[0]}


def top_bucket(engine, net, rng, session_error, atol: float) -> dict:
    """A session prefilled to SEQ - 1 tokens, then one token (the top
    bucket SEQ); one more must raise ``SessionError``."""
    x = rng.randn(1, SEQ + 1, N_IN).astype(np.float32)
    engine.predict_session("top", x[:, :SEQ - 1])
    last = engine.predict_session("top", x[:, SEQ - 1])
    cap = engine.sessions.session_capacity("top")
    if cap != SEQ:
        raise RuntimeError(f"the top session holds a ring of {cap}")
    held = worst([hold_probs(f"{engine.name} top-bucket token", last,
                             net.output(x[:, :SEQ]).cpu().numpy()[:, -1],
                             atol)])
    refused = False
    try:
        engine.predict_session("top", x[:, SEQ])
    except session_error as e:
        refused = True
        log(f"[serving] token {SEQ + 1} refused: {e}")
    if not refused:
        raise RuntimeError(f"a session decoded past cache_len {SEQ}")
    engine.sessions.clear("top")
    return {**held, "capacity": cap, "refused_past_top": True}


def decode_timing(engine, net, rng, batch: int, held: int) -> dict:
    """Median host ms per decoded token (one session step of ``batch``
    rows) over TIMED_TOKENS steps from ``held`` tokens, with
    ``torch.cuda.synchronize()`` around each step; beside it the bytes
    bound of the hand model of ``bench.py`` (``bench_decode``): the
    weights read once and the K/V ring read once, at the dtypes the port
    keeps them in, over the card's memory rate.  Then PROFILED_TOKENS
    more steps under ``torch.profiler``: device events and busy ms a
    step, the idle share, the largest kernels."""
    x = rng.randn(batch, held + TIMED_TOKENS + PROFILED_TOKENS,
                  N_IN).astype(np.float32)
    sid = f"timed-{batch}-{held}"
    engine.predict_session(sid, x[:, :held])
    ms = []
    for t in range(held, held + TIMED_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict_session(sid, x[:, t])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(ms))

    def more_steps():
        for t in range(held + TIMED_TOKENS,
                       held + TIMED_TOKENS + PROFILED_TOKENS):
            engine.predict_session(sid, x[:, t])

    wall_ms, n_events, by_name, busy_ms = profiled(more_steps)
    top = sorted(((v, k) for k, v in by_name.items()), reverse=True)[:5]
    profile = {"steps": PROFILED_TOKENS,
               "device_events_per_step": n_events / PROFILED_TOKENS,
               "step_ms_profiled": wall_ms / PROFILED_TOKENS,
               "device_busy_ms_per_step": busy_ms / PROFILED_TOKENS,
               "idle_share": 1.0 - busy_ms / wall_ms,
               "idle_share_steady": 1.0 - busy_ms / PROFILED_TOKENS / median,
               "top5_ms_per_step": [{"name": k[:120],
                                     "ms": v / PROFILED_TOKENS}
                                    for v, k in top]}
    cap = engine.sessions.session_capacity(sid)
    ring = engine.sessions.get_carries(sid)[0][0]
    engine.sessions.clear(sid)
    weight_bytes = sum(p.numel() * p.element_size()
                       for tree in net.params for p in tree.values())
    # K and V of the tokens held at the middle timed step
    ring_bytes = (2 * batch * HEADS * (held + TIMED_TOKENS // 2) * D_HEAD
                  * ring.element_size())
    bound = (weight_bytes + ring_bytes) / PEAK_BYTES * 1e3
    log(f"[serving] decode batch {batch} at {held} tokens (ring {cap}): "
        f"median {median:.4f} ms/token step, {batch * 1e3 / median:.1f} "
        f"tokens/s; bytes bound {bound:.6f} ms; profiled: "
        f"{profile['device_events_per_step']:g} device events and "
        f"{profile['device_busy_ms_per_step']:.4f} ms busy a step, idle "
        f"share {profile['idle_share_steady']:.3f} of the median step; "
        "top: " + "; ".join(f"{d['name'][:50]} {d['ms']:.4f}"
                            for d in profile["top5_ms_per_step"]))
    return {"batch": batch, "held": held, "capacity": cap,
            "median_ms": median, "min_ms": float(min(ms)),
            "max_ms": float(max(ms)), "tokens_per_s": batch * 1e3 / median,
            "weight_bytes": weight_bytes, "ring_bytes": ring_bytes,
            "bound_ms": bound, "bound_by": "bytes", "profile": profile}


def phase_serving(N, A, net, seed: int) -> dict:
    """The serving path at full width: ``predict`` through the engine's
    buckets, decode sessions over the KV ring, decode timing; none of
    K1-K4 may launch."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  SessionError)
    rng = np.random.RandomState(seed + 3)
    reg = monitor.registry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # counts of the serving path only
    result = {}
    with InferenceEngine(net, max_batch_size=4, max_latency_ms=5,
                         timestep_buckets=SERVE_BUCKETS,
                         name="smoke") as engine:
        result["buckets"] = engine.warmup((SEQ, N_IN))
        result["predict"] = serve_predict(engine, net, rng, reg,
                                          BF16_PROB_ATOL)
        result["decode_warmed"] = engine.warmup_decode((N_IN,))
        if engine.warmup_decode((N_IN,)) != 0:
            raise RuntimeError("a second warmup_decode ran new shapes")
        result["sessions_bf16"] = two_sessions(engine, net, rng, "bf16",
                                               BF16_PROB_ATOL)
        result["top_bucket"] = top_bucket(engine, net, rng, SessionError,
                                          BF16_PROB_ATOL)
        result["timing"] = [decode_timing(engine, net, rng, batch, held)
                            for held in TIMED_HELD
                            for batch in (1, 4)]
    net32 = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN,
                      heads=HEADS, n_out=N_OUT, cache_len=SEQ,
                      compute_dtype="float32")
    net32.set_flat_params(net.get_flat_params())
    with InferenceEngine(net32, max_batch_size=4, max_latency_ms=5,
                         timestep_buckets=SERVE_BUCKETS,
                         name="smoke-f32") as engine:
        engine.warmup((SEQ, N_IN))
        result["predict_f32"] = serve_predict(engine, net32, rng, reg,
                                              F32_PROB_ATOL)
        result["sessions_f32"] = two_sessions(engine, net32, rng, "f32",
                                              F32_PROB_ATOL)
        result["top_bucket_f32"] = top_bucket(engine, net32, rng,
                                              SessionError, F32_PROB_ATOL)
    torch.cuda.synchronize()
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    result["launches"] = dict(A.LAUNCHES)
    log(f"[serving] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the serving path launched a flash kernel")
    return result


def fp32_copy(net, device="cuda"):
    """``net`` (a MultiLayerNetwork or a ComputationGraph) rebuilt on
    ``device`` from its configuration with ``compute_dtype="float32"``,
    with its params and iteration, and its updater state when ``net``
    keeps no fp32 masters (an fp32 net holds none to read them into)."""
    conf = copy.deepcopy(net.conf)
    conf.conf.compute_dtype = "float32"
    out = type(net)(conf, device=device).init()
    out.set_flat_params(net.get_flat_params())
    if not net._pol().master_weights:
        out.set_flat_updater_state(net.get_flat_updater_state())
    out.iteration = net.iteration
    return out


def fit_updates(net, shape) -> int:
    """Updates one ``fit`` of a batch of ``shape`` makes: one, or one per
    window under truncated BPTT."""
    if net.conf.backprop_type != "tbptt":
        return 1
    return -(-shape[1] // net.conf.tbptt_fwd_length)


def hold_golden(what: str, net, golden, atol: float,
                tag: str = "ffcnn") -> dict:
    """A restored net's probabilities on the golden's input against the
    stored prediction; then one ``fit`` (the labels of
    ``tests/test_regression_goldens.py``: a class per example, or per
    timestep) must give a finite score and advance the iteration by one
    update (one per window under tBPTT)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    want = golden["prediction"]
    got = net.output(golden["input"]).cpu().numpy()
    err = float(np.abs(got - want).max())
    signal = float(np.abs(want - 1.0 / want.shape[-1]).max())
    log(f"[{tag}] {what}: max_abs_err={err:.3e} (atol {atol:g}), signal "
        f"max|p - 1/{want.shape[-1]}|={signal:.3e}")
    if got.shape != want.shape or not err <= atol:
        raise RuntimeError(f"{what}: disagrees with its golden")
    rng = np.random.RandomState(3)
    y = np.eye(want.shape[-1], dtype=np.float32)[
        rng.randint(0, want.shape[-1], want.shape[:-1])]
    it = net.iteration
    net.fit(DataSet(golden["input"], y))
    score = net.score()
    updates = fit_updates(net, golden["input"].shape)
    if not (np.isfinite(score) and net.iteration == it + updates):
        raise RuntimeError(f"{what}: the resumed fit gave score {score}, "
                           f"iteration {it} -> {net.iteration}, not "
                           f"+{updates}")
    return {"max_abs_err": err, "signal": signal, "resumed_score": score,
            "iteration": net.iteration}


def phase_goldens(ms, names=GOLDENS, tag: str = "ffcnn") -> dict:
    out = {}
    for name in names:
        path = FIXTURES / f"{name}.zip"
        golden = dict(np.load(FIXTURES / f"{name}_golden.npz"))
        restore = (ms.restore_computation_graph if name.startswith("graph")
                   else ms.restore_multi_layer_network)
        net = restore(path)
        if net._pol().name != "mixed_bf16":
            raise RuntimeError(f"{name} restored under {net._pol().name}")
        net32 = fp32_copy(restore(path, device="cpu"))
        out[name] = {
            "bf16": hold_golden(f"{name} mixed_bf16", net, golden,
                                GOLDEN_BF16_ATOL, tag),
            "f32": hold_golden(f"{name} fp32 copy", net32, golden,
                               GOLDEN_F32_ATOL, tag)}
    return out


def all_families_cnn(N, device):
    """conv stride 2 SAME -> BN -> max SAME -> LRN -> conv SAME -> avg SAME
    -> global avg -> softmax, fp32, on ``device``."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNormalization, LocalResponseNormalization)
    from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (N.NeuralNetConfiguration.builder().seed(5).updater("adam")
            .learning_rate(1e-2).activation("relu").compute_dtype("float32")
            .list()
            .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="same"))
            .layer(BatchNormalization())
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="same"))
            .layer(LocalResponseNormalization(n=5, alpha=1e-2))
            .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                    convolution_mode="same"))
            .layer(SubsamplingLayer(pooling_type="avg", kernel_size=(3, 3),
                                    stride=(2, 2), convolution_mode="same"))
            .layer(GlobalPoolingLayer(pooling_type="avg"))
            .layer(OutputLayer(n_out=10))
            .set_input_type(inputs.convolutional(29, 27, 3)).build())
    return MultiLayerNetwork(conf, device=device).init()


def phase_cnn_reference(N) -> dict:
    """The all-families CNN on the card and on the CPU from the same
    weights in fp32: forward and two fit steps within REF_RTOL."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    card, cpu = all_families_cnn(N, "cuda"), all_families_cnn(N, "cpu")
    cpu.set_flat_params(card.get_flat_params())
    rng = np.random.RandomState(7)
    x = rng.randn(16, 29, 27, 3).astype(np.float32)
    ds = DataSet(x, np.eye(10, dtype=np.float32)[rng.randint(0, 10, 16)])

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    worst = rel(card.output(x).cpu().numpy(), cpu.output(x).numpy())
    log(f"[ffcnn] CNN forward card vs CPU rel={worst:.2e}")
    for step in range(2):
        card.fit(ds)
        cpu.fit(ds)
        s_rel = abs(card.score() - cpu.score()) / abs(cpu.score())
        p_rel = rel(card.get_flat_params(), cpu.get_flat_params())
        st_rel = max(rel(card.net_state[1][k].cpu().numpy(),
                         cpu.net_state[1][k].numpy()) for k in ("mean", "var"))
        log(f"[ffcnn] CNN step {step}: score card={card.score():.7f} "
            f"cpu={cpu.score():.7f} rel={s_rel:.2e}; params rel={p_rel:.2e}; "
            f"BN state rel={st_rel:.2e} (tol {REF_RTOL:g})")
        worst = max(worst, s_rel, p_rel, st_rel)
    if not worst <= REF_RTOL:
        raise RuntimeError("the CNN disagrees between card and CPU")
    return {"steps": 2, "max_rel": worst}


def lenet_data(seed: int):
    """LENET_BATCHES batches of seeded 28x28 images in [0, 1), labelled by
    the argmax of a fixed random linear map (a learnable labelling).  The
    map is constant over 4x4 pixel blocks, a feature LeNet's convolutions
    and pooling pick up within 30 steps; a map of independent pixels
    hardly moves the score in that time."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(seed)
    x = rng.rand(LENET_BATCHES * LENET_BATCH, 784).astype(np.float32)
    w = np.kron(rng.randn(7, 7, 10), np.ones((4, 4, 1))).reshape(784, 10)
    y = np.eye(10, dtype=np.float32)[np.argmax((x - 0.5) @ w, axis=1)]
    return [DataSet(x[i:i + LENET_BATCH], y[i:i + LENET_BATCH])
            for i in range(0, len(x), LENET_BATCH)]


def phase_lenet(seed: int) -> dict:
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(lenet()).init()
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"LeNet runs under {net._pol().name}")
    batches = lenet_data(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # LeNet's params and state, and
    scores, step_ms = [], []               # what earlier phases still hold
    for step in range(LENET_STEPS):
        t0 = time.perf_counter()
        net.fit(batches[step % LENET_BATCHES])
        s = net.score()           # a host read: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms[1:]))
    log(f"[ffcnn] LeNet-5 batch {LENET_BATCH}: score {scores[0]:.4f} -> "
        f"{scores[-1]:.4f}; first step {step_ms[0]:.1f} ms, median of steps "
        f"2-{LENET_STEPS} {median:.4f} ms ({LENET_BATCH * 1e3 / median:.0f} "
        f"samples/s); peak memory {peak / 2**20:.1f} MiB, "
        f"{held / 2**20:.1f} MiB held before the first step")
    if not (all(np.isfinite(scores)) and scores[-1] < scores[0]):
        raise RuntimeError(f"LeNet did not train: {scores}")
    return {"batch": LENET_BATCH, "params": net.num_params(),
            "scores": scores, "step_ms": step_ms, "median_step_ms": median,
            "samples_per_s": LENET_BATCH * 1e3 / median,
            "peak_mem_bytes": peak, "mem_before_bytes": held,
            "profile": profile_step(net, batches[0], min(step_ms[1:]))}


def phase_ffcnn(N, A, seed: int) -> dict:
    """Phase 9: the goldens, the card-vs-CPU CNN, LeNet-5; none of K1-K4
    may launch."""
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    torch.cuda.synchronize()
    A.reset_launches()            # counts of this path only
    result = {"goldens": phase_goldens(ms), "cnn_reference":
              phase_cnn_reference(N), "lenet": phase_lenet(seed)}
    result["launches"] = dict(A.LAUNCHES)
    log(f"[ffcnn] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the feed-forward/CNN path launched a flash "
                           "kernel")
    return result


# ------------------------------------------------------------ phase 10
def small_recurrent(N, device, bidirectional: bool):
    """fp32 on ``device``: 2 x GravesLSTM(16) -> RnnOutputLayer(6) under
    tBPTT 8 / back 5, or GravesBidirectionalLSTM(16) -> masked global avg
    pooling -> OutputLayer(6) under standard backprop; 10 inputs."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPoolingLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (N.NeuralNetConfiguration.builder().seed(5).updater("rmsprop")
         .learning_rate(1e-2).activation("tanh").compute_dtype("float32")
         .list())
    if bidirectional:
        b = (b.layer(GravesBidirectionalLSTM(n_out=16))
             .layer(GlobalPoolingLayer(pooling_type="avg"))
             .layer(OutputLayer(n_out=6)))
    else:
        b = (b.layer(GravesLSTM(n_out=16)).layer(GravesLSTM(n_out=16))
             .layer(RnnOutputLayer(n_out=6)).backprop_type("tbptt")
             .t_bptt_forward_length(8).t_bptt_backward_length(5))
    conf = b.set_input_type(inputs.recurrent(10, 21)).build()
    return MultiLayerNetwork(conf, device=device).init()


def phase_rnn_reference(N) -> dict:
    """The two small recurrent nets on the card and on the CPU from the
    same weights in fp32, on ragged right-padded masked sequences of 21
    steps: forward and two fits within REF_RTOL."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(11)
    x = rng.randn(6, 21, 10).astype(np.float32)
    lengths = np.array([21, 8, 13, 21, 17, 11])
    fm = (np.arange(21)[None, :] < lengths[:, None]).astype(np.float32)
    y_seq = np.eye(6, dtype=np.float32)[rng.randint(0, 6, (6, 21))]
    y_one = np.eye(6, dtype=np.float32)[rng.randint(0, 6, 6)]

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    out = {}
    for name, bidirectional, ds in (
            ("lstm_tbptt", False, DataSet(x, y_seq, features_mask=fm,
                                          labels_mask=fm)),
            ("bidirectional_pooled", True, DataSet(x, y_one,
                                                   features_mask=fm))):
        card = small_recurrent(N, "cuda", bidirectional)
        cpu = small_recurrent(N, "cpu", bidirectional)
        cpu.set_flat_params(card.get_flat_params())
        worst = rel(card.output(x, features_mask=fm).cpu().numpy(),
                    cpu.output(x, features_mask=fm).numpy())
        log(f"[recurrent] {name} forward card vs CPU rel={worst:.2e}")
        for step in range(2):
            card.fit(ds)
            cpu.fit(ds)
            s_rel = abs(card.score() - cpu.score()) / abs(cpu.score())
            p_rel = rel(card.get_flat_params(), cpu.get_flat_params())
            log(f"[recurrent] {name} fit {step}: score card="
                f"{card.score():.7f} cpu={cpu.score():.7f} rel={s_rel:.2e}; "
                f"params rel={p_rel:.2e} (tol {REF_RTOL:g}); iteration "
                f"{card.iteration}")
            worst = max(worst, s_rel, p_rel)
        if not worst <= REF_RTOL or card.iteration != cpu.iteration:
            raise RuntimeError(f"{name} disagrees between card and CPU")
        out[name] = {"fits": 2, "iteration": card.iteration,
                     "max_rel": worst}
    return out


def markov_ids(seed: int, rows: int, steps: int) -> np.ndarray:
    """Symbol ids of ``rows`` first-order Markov chains over CHAR_VOCAB
    symbols: each symbol has CHAR_FANOUT successors, weighted by a seeded
    Dirichlet draw."""
    rng = np.random.RandomState(seed)
    succ = np.stack([rng.choice(CHAR_VOCAB, CHAR_FANOUT, replace=False)
                     for _ in range(CHAR_VOCAB)])
    cum = np.cumsum(rng.dirichlet(np.ones(CHAR_FANOUT), CHAR_VOCAB), 1)
    ids = np.empty((rows, steps), np.int64)
    ids[:, 0] = rng.randint(0, CHAR_VOCAB, rows)
    u = rng.rand(rows, steps)
    for t in range(1, steps):
        prev = ids[:, t - 1]
        k = np.minimum((u[:, t, None] > cum[prev]).sum(1), CHAR_FANOUT - 1)
        ids[:, t] = succ[prev, k]
    return ids


def char_rnn(N):
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (GravesLSTM,
                                                               RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    V, H = CHAR_VOCAB, CHAR_HIDDEN
    conf = (N.NeuralNetConfiguration.builder().seed(12).updater("rmsprop")
            .learning_rate(0.1).weight_init("xavier").list()
            .layer(GravesLSTM(n_in=V, n_out=H, activation="tanh"))
            .layer(GravesLSTM(n_in=H, n_out=H, activation="tanh"))
            .layer(RnnOutputLayer(n_in=H, n_out=V, activation="softmax",
                                  loss="mcxent"))
            .backprop_type("tbptt").t_bptt_forward_length(CHAR_WINDOW)
            .t_bptt_backward_length(CHAR_WINDOW).build())
    return MultiLayerNetwork(conf).init()


def phase_char_rnn(N, seed: int):
    """CHAR_FITS fits of the char-RNN under the card's default policy,
    each a CHAR_SEQ-step batch in tBPTT windows, the score falling.  Each
    window is timed on the host clock from the end of the previous one to
    its own end after ``torch.cuda.synchronize()`` (the first window of a
    fit includes the batch upload); then one more window under
    ``torch.profiler``."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    net = char_rnn(N)
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"the char-RNN runs under {net._pol().name}")
    ids = markov_ids(seed, CHAR_BATCH, CHAR_FITS * CHAR_SEQ + 1)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    batches = [DataSet(eye[ids[:, i:i + CHAR_SEQ]],
                       eye[ids[:, i + 1:i + CHAR_SEQ + 1]])
               for i in range(0, CHAR_FITS * CHAR_SEQ, CHAR_SEQ)]
    stamps, update = [], net._update

    def timed_update(loss_fn):
        carries = update(loss_fn)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return carries

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    net._update = timed_update
    scores, t0 = [], time.perf_counter()
    for ds in batches:
        net.fit(ds)
        scores.append(net.score())
    del net._update
    peak = torch.cuda.max_memory_allocated()
    window_ms = list(np.diff([t0] + stamps) * 1e3)
    windows = CHAR_FITS * CHAR_SEQ // CHAR_WINDOW
    median = float(np.median(window_ms[1:]))
    chars = CHAR_BATCH * CHAR_WINDOW
    log(f"[recurrent] char-RNN: {len(window_ms)} windows of {CHAR_BATCH} x "
        f"{CHAR_WINDOW}; scores per fit {[round(s, 3) for s in scores]} "
        f"(uniform: {CHAR_WINDOW * np.log(CHAR_VOCAB):.3f}); first window "
        f"{window_ms[0]:.1f} ms, median of windows 2-{windows} "
        f"{median:.3f} ms ({chars * 1e3 / median:.0f} chars/s); peak memory "
        f"{peak / 2**20:.1f} MiB, {held / 2**20:.1f} MiB held before")
    if not (len(window_ms) == windows == net.iteration
            and all(np.isfinite(scores)) and scores[-1] < scores[0]):
        raise RuntimeError(f"the char-RNN did not train: {scores}, "
                           f"{net.iteration} windows")
    one_window = DataSet(batches[0].features[:, :CHAR_WINDOW],
                         batches[0].labels[:, :CHAR_WINDOW])
    return net, {"params": net.num_params(), "windows": windows,
                 "scores": scores, "window_ms": window_ms,
                 "median_window_ms": median,
                 "chars_per_s": chars * 1e3 / median,
                 "peak_mem_bytes": peak, "mem_before_bytes": held,
                 "profile": profile_step(net, one_window, median)}


def hold_sampling(net, x, atol: float, label: str) -> dict:
    """``rnn_time_step`` over each single step of ``x`` against
    ``output()`` of the whole of it."""
    full = net.output(x).cpu().numpy()
    net.rnn_clear_previous_state()
    stepped = np.stack([net.rnn_time_step(x[:, t]).cpu().numpy()
                        for t in range(x.shape[1])], 1)
    net.rnn_clear_previous_state()
    what = f"{label} rnn_time_step x {x.shape[1]}"
    return dict(zip(("max_abs_err", "signal"),
                    hold_probs(what, stepped, full, atol, "recurrent")))


def rnn_sessions(net, xs, atol: float, name: str) -> dict:
    """Two concurrent ``predict_session``s through ``InferenceEngine``: a
    SESSION_PREFILL-step chunk, then SESSION_STEPS single steps, against
    ``output()`` of each whole sequence."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    outs, errors = {}, []
    with InferenceEngine(net, name=name) as engine:
        def session(j):
            try:
                x = xs[j:j + 1]
                chunk = engine.predict_session(f"s{j}",
                                               x[:, :SESSION_PREFILL])
                steps = [engine.predict_session(f"s{j}", x[:, t])[:, None]
                         for t in range(SESSION_PREFILL, x.shape[1])]
                outs[j] = np.concatenate([chunk] + steps, axis=1)
            except Exception as e:     # raised by run_threads
                errors.append(e)

        run_threads([lambda j=j: session(j) for j in range(2)], errors)
        positions = [engine.sessions.session_position(f"s{j}")
                     for j in range(2)]
    if positions != [xs.shape[1]] * 2:
        raise RuntimeError(f"{name} sessions hold {positions} steps")
    return worst(hold_probs(f"{name} session {j}", outs[j],
                            net.output(xs[j:j + 1]).cpu().numpy(), atol,
                            "recurrent")
                 for j in range(2))


def phase_ring_lstm(S, seed: int) -> dict:
    """``ring_lstm_scan`` over RING_LSTM_SHARDS shards of one card against
    the one-device ``lstm_scan`` at T=RING_LSTM_T, batch 32, 84 inputs,
    H 256, fp32: outputs, the final (h, c) and the gradients of W, RW and
    b against a random cotangent; both timed (host clock, synchronized,
    fwd+bwd, in turns one device, ring, ring, one device) with the peak
    memory of each, then profiled once each."""
    from deeplearning4j_tpu_torch.nn import activations as act
    from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_scan
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    B, T, NI, H = CHAR_BATCH, RING_LSTM_T, CHAR_VOCAB, CHAR_HIDDEN

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    params = [randn(NI, 4 * H, scale=(2 / (NI + 4 * H)) ** 0.5),
              randn(H, 4 * H + 3, scale=(2 / (5 * H + 3)) ** 0.5),
              randn(4 * H, scale=0.1)]
    params = [p.requires_grad_() for p in params]
    x = randn(B, T, NI)
    carry = (torch.zeros(B, H, device="cuda"),) * 2
    fns = dict(afn=act.get("tanh"), gate_fn=act.get("sigmoid"))
    g = randn(B, T, H)

    def one():
        out, fin = lstm_scan(*params, x, carry, **fns)
        return out, fin

    def ring():
        outs, finals = S.ring_lstm_scan(
            *params, list(x.chunk(RING_LSTM_SHARDS, 1)), carry, **fns)
        if len(finals) != RING_LSTM_SHARDS:
            raise RuntimeError("the final carry is not on every shard")
        return torch.cat(outs, 1), finals[-1]

    def run(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out, (h, c) = fn()
        grads = torch.autograd.grad((out * g).sum(), params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        return [t.detach() for t in (out, h, c, *grads)], ms, peak

    ref, ms_one, peak_one = run(one)
    got, ms_ring, peak_ring = run(ring)
    errs = []
    for name, a, b in zip(("out", "h", "c", "dW", "dRW", "db"), got, ref):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"[recurrent] ring LSTM {name}: rel={rel:.3e} (tol "
            f"{RING_LSTM_RTOL:g})")
        errs.append(rel)
    if not max(errs) <= RING_LSTM_RTOL:
        raise RuntimeError("the ring LSTM disagrees with the one-device "
                           "scan")
    ms_ring2, ms_one2 = run(ring)[1], run(one)[1]
    # one more fwd+bwd of each under torch.profiler: its device events
    # and busy ms (the recompute's share of the ring's time)
    events = {name: profiled(lambda fn=fn: run(fn))[1::2]
              for name, fn in (("one_device", one), ("ring", ring))}
    log(f"[recurrent] ring LSTM T={T}, {RING_LSTM_SHARDS} shards fwd+bwd "
        f"{ms_ring:.1f}, {ms_ring2:.1f} ms (peak {peak_ring / 2**20:.1f} "
        f"MiB); one device {ms_one:.1f}, {ms_one2:.1f} ms (peak "
        f"{peak_one / 2**20:.1f} MiB); device events, busy ms: {events}")
    return {"T": T, "shards": RING_LSTM_SHARDS, "max_rel": max(errs),
            "ring_ms": [ms_ring, ms_ring2], "one_device_ms": [ms_one, ms_one2],
            "ring_peak_bytes": peak_ring, "one_device_peak_bytes": peak_one,
            "device_events_busy_ms": events}


def phase_recurrent(N, A, S, seed: int) -> dict:
    """Phase 10: the LSTM golden, the card-vs-CPU recurrent nets, the
    char-RNN, sampling and sessions, the ring LSTM; none of K1-K4 may
    launch."""
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    torch.cuda.synchronize()
    A.reset_launches()            # counts of this path only
    result = {"goldens": phase_goldens(ms, ("lstm_rmsprop_tbptt",),
                                       "recurrent"),
              "rnn_reference": phase_rnn_reference(N)}
    net, result["char_rnn"] = phase_char_rnn(N, seed)
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    text = eye[markov_ids(seed + 5, 4, SESSION_PREFILL + SESSION_STEPS)]
    net32 = fp32_copy(net)
    result["sampling_bf16"] = hold_sampling(net, text[:, :SAMPLE_STEPS],
                                            RNN_BF16_ATOL, "mixed_bf16")
    result["sampling_f32"] = hold_sampling(net32, text[:, :SAMPLE_STEPS],
                                           RNN_F32_ATOL, "fp32 copy")
    result["sessions_bf16"] = rnn_sessions(net, text, RNN_BF16_ATOL,
                                           "char-rnn")
    result["sessions_f32"] = rnn_sessions(net32, text, RNN_F32_ATOL,
                                          "char-rnn-f32")
    del net, net32
    torch.cuda.empty_cache()
    result["ring_lstm"] = phase_ring_lstm(S, seed)
    result["launches"] = dict(A.LAUNCHES)
    log(f"[recurrent] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the recurrent path launched a flash kernel")
    return result


# ------------------------------------------------------------ phase 11
def harness_lenet(ffcnn_samples_per_s: float) -> tuple:
    """(a): LeNet-5 trained through the iterator, the listeners and
    ``evaluate``, as examples/lenet_mnist.py does it."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator, ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners.listeners import (
        CollectScoresIterationListener, PerformanceListener,
        ScoreIterationListener)
    t0 = time.perf_counter()
    train = MnistDataSetIterator(MNIST_BATCH, MNIST_TRAIN)
    test = MnistDataSetIterator(MNIST_TEST_BATCH, MNIST_TEST, train=False)
    gen_s = time.perf_counter() - t0
    net = MultiLayerNetwork(lenet()).init()
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"LeNet runs under {net._pol().name}")
    perf, scores = PerformanceListener(1), CollectScoresIterationListener(1)
    net.set_listeners(ScoreIterationListener(25, out=sys.stderr), perf,
                      scores)
    it = AsyncDataSetIterator(train)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net.fit(it, epochs=MNIST_EPOCHS, ingest="batch")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    it.close()
    t0 = time.perf_counter()
    ev = net.evaluate(test)
    eval_s = time.perf_counter() - t0
    moved = monitor.registry().get("eval_bytes_transferred").value(
        path="indices")
    peak = torch.cuda.max_memory_allocated()
    steps = MNIST_EPOCHS * MNIST_TRAIN // MNIST_BATCH
    first = float(np.mean([s for _, s in scores.scores[:10]]))
    last = float(np.mean([s for _, s in scores.scores[-10:]]))
    fit_rate = steps * MNIST_BATCH / fit_s
    step_rate = perf.average_samples_per_sec(skip=1)
    # the same batch size without the iterator and the listeners: a clone
    # takes one epoch of pre-gathered batches, timed over the window
    bare = net.clone()
    src = train._ds
    pre = [DataSet(src.features[i:i + MNIST_BATCH],
                   src.labels[i:i + MNIST_BATCH])
           for i in range(0, MNIST_TRAIN, MNIST_BATCH)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ds in pre:
        bare.fit(ds)
    torch.cuda.synchronize()
    bare_rate = MNIST_TRAIN / (time.perf_counter() - t0)
    del bare
    log(f"[harness] LeNet-5 on MNIST: generated {MNIST_TRAIN} + "
        f"{MNIST_TEST} images in {gen_s:.2f} s; fit {steps} steps in "
        f"{fit_s:.3f} s = {fit_rate:.1f} samples/s over the window "
        f"(PerformanceListener's mean of per-step rates {step_rate:.1f}); "
        f"the same batch {MNIST_BATCH} from a list, no iterator or "
        f"listeners: {bare_rate:.1f} samples/s over one epoch (phase 9's "
        f"median step: {ffcnn_samples_per_s:.1f} at batch {LENET_BATCH}); "
        f"score {first:.4f} -> {last:.4f} (mean of "
        f"the first and last 10); evaluate {MNIST_TEST} in {eval_s:.3f} s "
        f"({MNIST_TEST / eval_s:.1f} samples/s), accuracy "
        f"{ev.accuracy():.4f} (> {MNIST_MIN_ACCURACY}), "
        f"eval_bytes_transferred {moved:.0f}; peak memory "
        f"{peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before)")
    if not (len(scores.scores) == steps and net.iteration == steps
            and np.isfinite(last) and last < first):
        raise RuntimeError(f"LeNet did not train through the iterator: "
                           f"{len(scores.scores)} scores, {first} -> {last}")
    if not ev.accuracy() > MNIST_MIN_ACCURACY:
        raise RuntimeError(f"LeNet reached {ev.accuracy()} on MNIST")
    if moved != MNIST_TEST * 4:
        raise RuntimeError(f"evaluate moved {moved} bytes, not "
                           f"{MNIST_TEST * 4}")
    # one more epoch of PROFILED_BATCHES batches through the same path
    n = PROFILED_BATCHES * MNIST_BATCH
    small = AsyncDataSetIterator(ListDataSetIterator(
        DataSet(src.features[:n], src.labels[:n]), MNIST_BATCH,
        shuffle=True))
    wall_ms, n_events, by_name, busy_ms = profiled(
        lambda: net.fit(small, ingest="batch"))
    small.close()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    profile = {"batches": PROFILED_BATCHES, "wall_ms": wall_ms,
               "device_events": n_events, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / wall_ms,
               "top5": [{"name": k[:120], "ms": v} for k, v in top]}
    log(f"[harness] one epoch of {PROFILED_BATCHES} batches under "
        f"torch.profiler: host {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {profile['idle_share']:.3f}, "
        f"{n_events} device events; top 5: " + "; ".join(
            f"{k[:50]} {v:.3f}" for k, v in top))
    result = {"generate_s": gen_s, "fit_s": fit_s, "steps": steps,
              "fit_samples_per_s": fit_rate,
              "listener_mean_step_samples_per_s": step_rate,
              "list_samples_per_s": bare_rate,
              "score_first10": first, "score_last10": last,
              "evaluate_s": eval_s, "evaluate_samples_per_s":
              MNIST_TEST / eval_s, "accuracy": ev.accuracy(),
              "eval_bytes_transferred": moved, "peak_mem_bytes": peak,
              "mem_before_bytes": held, "profile": profile}
    return net, train, test, result


def harness_card_vs_cpu(net, test) -> dict:
    """(b): fp32 copies of the trained net on the card and on the CPU give
    the same confusion matrix; the bf16 net's predictions that differ from
    the fp32 copy's are counted."""
    card, cpu = fp32_copy(net), fp32_copy(net, device="cpu")
    ev_card, ev_cpu = card.evaluate(test), cpu.evaluate(test)
    x = test._ds.features
    with torch.no_grad():
        p16 = net.output(x).argmax(-1).cpu().numpy()
        p32 = card.output(x).argmax(-1).cpu().numpy()
    differ = int((p16 != p32).sum())
    same = bool(np.array_equal(ev_card.confusion.matrix,
                               ev_cpu.confusion.matrix))
    log(f"[harness] fp32 card vs CPU confusion matrices identical: {same} "
        f"(accuracy {ev_card.accuracy():.4f} / {ev_cpu.accuracy():.4f}); "
        f"bf16 net vs its fp32 copy: {differ} of {len(p16)} predictions "
        "differ")
    if not same:
        raise RuntimeError("the fp32 confusion matrices of the card and "
                           "the CPU differ")
    return {"identical": same, "accuracy_f32": ev_card.accuracy(),
            "bf16_vs_f32_differ": differ}


def harness_early_stopping(train, test) -> dict:
    """(c): early stopping with a file saver; the best model, restored
    from its zip, scores its recorded best."""
    import tempfile

    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(lenet(seed=7)).init()
    with tempfile.TemporaryDirectory() as tmp:
        conf = (es.EarlyStoppingConfiguration.builder()
                .epoch_termination_conditions(
                    es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                    es.ScoreImprovementEpochTerminationCondition(1))
                .score_calculator(es.DataSetLossCalculator(test))
                .model_saver(es.LocalFileModelSaver(tmp)).build())
        t0 = time.perf_counter()
        result = es.EarlyStoppingTrainer(conf, net, train).fit()
        es_s = time.perf_counter() - t0
        best = result.best_model
        again = es.DataSetLossCalculator(test).calculate_score(best)
    rel = abs(again - result.best_model_score) / abs(result.best_model_score)
    log(f"[harness] early stopping: {result.termination_reason} "
        f"({result.termination_details}) after {result.total_epochs} "
        f"epochs in {es_s:.2f} s, scores {result.score_vs_epoch}, best "
        f"epoch {result.best_model_epoch} at {result.best_model_score:.6f};"
        f" restored best scores {again:.6f} (rel {rel:.2e}, tol "
        f"{ES_RESTORE_RTOL:g}) on {best.device}")
    if not (best is not net and best.device.type == "cuda"
            and rel <= ES_RESTORE_RTOL):
        raise RuntimeError("the restored best model does not score its "
                           "recorded best")
    return {"termination_reason": result.termination_reason,
            "termination_details": result.termination_details,
            "score_vs_epoch": result.score_vs_epoch,
            "best_epoch": result.best_model_epoch,
            "best_score": result.best_model_score, "restored_score": again,
            "rel": rel, "seconds": es_s}


def iris_mlp(N, algo: str, device):
    """examples/mlp_iris.py's network with ``optimization_algo(algo)``,
    fp32."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (N.NeuralNetConfiguration.builder()
            .seed(42).updater("adam").learning_rate(0.02)
            .activation("tanh").weight_init("xavier")
            .optimization_algo(algo).compute_dtype("float32").list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(inputs.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device=device).init()


def harness_solvers(N) -> dict:
    """(d): each line-search solver on the card and on the CPU from the
    same weights: params within REF_RTOL after SOLVER_FITS fits."""
    from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
    ds = iris_dataset()
    out = {}
    for algo in SOLVER_ALGOS:
        card, cpu = iris_mlp(N, algo, "cuda"), iris_mlp(N, algo, "cpu")
        cpu.set_flat_params(card.get_flat_params())
        s0 = card.score(ds)
        fit_ms = []
        for _ in range(SOLVER_FITS):
            t0 = time.perf_counter()
            card.fit(ds)          # returns after the score's host read
            fit_ms.append((time.perf_counter() - t0) * 1e3)
            cpu.fit(ds)
        s1 = card.score(ds)
        got, want = card.get_flat_params(), cpu.get_flat_params()
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        s_rel = abs(card.score() - cpu.score()) / abs(cpu.score())
        solver = card._solver
        syncs = solver.host_syncs / solver.iterations
        median = float(np.median(fit_ms[1:]))
        log(f"[harness] {algo}: score {s0:.6f} -> {s1:.6f}; card vs CPU "
            f"params rel={rel:.2e}, last pre-step score rel={s_rel:.2e} "
            f"(tol {REF_RTOL:g}); {median:.3f} ms a solver iteration "
            f"(median of fits 2-{SOLVER_FITS}, first {fit_ms[0]:.3f}), "
            f"{syncs:.2f} host reads an iteration")
        if not (rel <= REF_RTOL and s_rel <= REF_RTOL and s1 < s0):
            raise RuntimeError(f"the {algo} solver disagrees between card "
                               "and CPU or does not descend")
        out[algo] = {"score_before": s0, "score_after": s1,
                     "params_rel": rel, "score_rel": s_rel,
                     "iteration_ms": fit_ms, "median_iteration_ms": median,
                     "host_syncs_per_iteration": syncs}
    return out


def phase_harness(N, A, ffcnn_samples_per_s: float) -> dict:
    """Phase 11: LeNet-5 on MNIST through the iterator, listeners,
    evaluation and early stopping; the line-search solvers card vs CPU;
    none of K1-K4 may launch."""
    torch.cuda.synchronize()
    A.reset_launches()            # counts of this path only
    net, train, test, lenet_result = harness_lenet(ffcnn_samples_per_s)
    result = {"lenet_mnist": lenet_result,
              "card_vs_cpu": harness_card_vs_cpu(net, test)}
    del net
    torch.cuda.empty_cache()
    result["early_stopping"] = harness_early_stopping(train, test)
    result["solvers"] = harness_solvers(N)
    result["launches"] = dict(A.LAUNCHES)
    log(f"[harness] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the harness path launched a flash kernel")
    return result


# ------------------------------------------------------------ phase 12
def all_vertex_graph(N, device):
    """Two inputs (a masked sequence and a vector), two outputs, every
    vertex type (tests/test_torch_computation_graph.py's graph), fp32,
    nesterovs, on ``device``."""
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import computation_graph as cg
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.preprocessors import \
        FeedForwardToCnnPreProcessor
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesLSTM, RnnOutputLayer)
    g = (N.NeuralNetConfiguration.builder().seed(3).updater("nesterovs")
         .learning_rate(0.0625).activation("tanh").weight_init("xavier")
         .l2(1e-3).compute_dtype("float32").graph_builder()
         .add_inputs("seq", "vec")
         .add_layer("lstm", GravesLSTM(n_out=6), "seq")
         .add_vertex("last", cg.LastTimeStepVertex(mask_input="seq"), "lstm")
         .add_layer("dv", DenseLayer(n_out=6), "vec"))
    for op in ("add", "subtract", "product", "average", "max"):
        g.add_vertex(op, cg.ElementWiseVertex(op=op), "last", "dv")
    conf = (g.add_vertex("merge", cg.MergeVertex(), "add", "subtract",
                         "product", "average", "max")
            .add_vertex("subset", cg.SubsetVertex(from_index=2, to_index=13),
                        "merge")
            .add_vertex("scale", cg.ScaleVertex(scale_factor=0.5), "subset")
            .add_vertex("shift", cg.ShiftVertex(shift_factor=0.1), "scale")
            .add_vertex("l2n", cg.L2NormalizeVertex(), "shift")
            .add_vertex("stack", cg.StackVertex(), "l2n", "shift")
            .add_layer("shared", DenseLayer(n_out=5), "stack")
            .add_vertex("u0", cg.UnstackVertex(from_index=0, stack_size=2),
                        "shared")
            .add_vertex("u1", cg.UnstackVertex(from_index=1, stack_size=2),
                        "shared")
            .add_vertex("l2", cg.L2Vertex(), "u0", "u1")
            .add_vertex("img", cg.PreprocessorVertex(
                preprocessor=FeedForwardToCnnPreProcessor(2, 2, 3)), "shift")
            .add_layer("flat", DenseLayer(n_out=4), "img")
            .add_vertex("head_in", cg.MergeVertex(), "l2", "u1", "flat")
            .add_layer("ffout", OutputLayer(n_out=2), "head_in")
            .add_vertex("dup", cg.DuplicateToTimeSeriesVertex(
                reference_input="seq"), "flat")
            .add_vertex("seqm", cg.MergeVertex(), "lstm", "dup")
            .add_layer("rnnout", RnnOutputLayer(n_out=3), "seqm")
            .set_outputs("rnnout", "ffout")
            .set_input_types(inputs.recurrent(3, GRAPH_REF_T),
                             inputs.feed_forward(4))
            .build())
    return ComputationGraph(conf, device=device).init()


def graph_reference(N) -> dict:
    """(b): the all-vertex graph on the card and on the CPU from the same
    weights in fp32: both outputs and GRAPH_REF_FITS fit steps' params
    within GRAPH_REF_RTOL."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet
    card, cpu = all_vertex_graph(N, "cuda"), all_vertex_graph(N, "cpu")
    cpu.set_flat_params(card.get_flat_params())
    rng = np.random.RandomState(13)
    b, t = 16, GRAPH_REF_T
    x1 = rng.randn(b, t, 3).astype(np.float32)
    x2 = rng.randn(b, 4).astype(np.float32)
    fm = (np.arange(t)[None] < rng.randint(1, t + 1, b)[:, None]).astype(
        np.float32)
    y1 = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (b, t))]
    y2 = np.eye(2, dtype=np.float32)[rng.randint(0, 2, b)]
    mds = MultiDataSet([x1, x2], [y1, y2], [fm, None], [fm, None])

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    def outputs():
        return max(rel(o.cpu().numpy(), p.numpy()) for o, p in zip(
            card.output(x1, x2, features_masks=[fm, None]),
            cpu.output(x1, x2, features_masks=[fm, None])))

    worst = outputs()
    log(f"[graph] all-vertex graph outputs card vs CPU rel={worst:.2e}")
    for step in range(GRAPH_REF_FITS):
        card.fit(mds)
        cpu.fit(mds)
        s_rel = abs(card.score() - cpu.score()) / abs(cpu.score())
        p_rel = rel(card.get_flat_params(), cpu.get_flat_params())
        log(f"[graph] all-vertex step {step}: score card={card.score():.7f}"
            f" cpu={cpu.score():.7f} rel={s_rel:.2e}; params rel={p_rel:.2e}"
            f" (tol {GRAPH_REF_RTOL:g})")
        worst = max(worst, s_rel, p_rel)
    worst = max(worst, outputs())
    if not worst <= GRAPH_REF_RTOL:
        raise RuntimeError("the all-vertex graph disagrees between card and "
                           "CPU")
    return {"steps": GRAPH_REF_FITS, "max_rel": worst,
            "vertices": len(card.topo)}


def resnet_flops(net, batch: int) -> float:
    """Multiply-adds x 2 of one forward, from the shapes of every
    convolution and dense layer (the inferred output types of the
    configuration); a training step is taken as three forwards."""
    types = net.conf._inferred_types
    flops = 0.0
    for name, layer in net._slots():
        out, kind = types[name], type(layer).__name__
        if kind == "ConvolutionLayer":
            kh, kw = layer.kernel_size
            flops += (2.0 * batch * out.height * out.width * kh * kw
                      * layer.n_in * layer.n_out)
        elif kind in ("DenseLayer", "OutputLayer"):
            flops += 2.0 * batch * layer.n_in * layer.n_out
    return flops


def graph_resnet(seed: int) -> dict:
    """(c): ResNet-50 at full width (224x224x3, 1000 classes, nesterovs
    0.1, l2 1e-4, the card's mixed_bf16) on one batch of RESNET_BATCH
    RandomState(0) images with one-hot labels, staged on the card once as
    bench.py stages it: RESNET_STEPS fit steps, the median over steps 3 to
    RESNET_STEPS, a profiled step, output() at the same batch."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    net = ComputationGraph(resnet50()).init()
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"ResNet-50 runs under {net._pol().name}")
    rng = np.random.RandomState(0)
    f = rng.rand(RESNET_BATCH, 224, 224, 3).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, RESNET_BATCH)]
    ds = DataSet(torch.as_tensor(f, device=net.device),
                 torch.as_tensor(y, device=net.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    scores, l2, step_ms = [], [], []
    for _ in range(RESNET_STEPS):
        with torch.no_grad():     # the score's l2 term, outside the timing
            l2.append(float(net._reg_score(net.params)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        s = net.score()           # a host read: waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    data_loss = [s - r for s, r in zip(scores, l2)]
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms[2:]))
    flops = 3.0 * resnet_flops(net, RESNET_BATCH)
    bound = flops / PEAK_BF16_FLOPS * 1e3
    log(f"[graph] ResNet-50 batch {RESNET_BATCH}, 224x224, "
        f"{net.num_params()} params: score {scores[0]:.4f} -> "
        f"{scores[-1]:.4f}; first step {step_ms[0]:.1f} ms, median of steps "
        f"3-{RESNET_STEPS} {median:.3f} ms "
        f"({RESNET_BATCH * 1e3 / median:.1f} samples/s); {flops:.4e} FLOP a"
        f" step, bound {bound:.4f} ms at the bf16 peak ({bound / median:.3f}"
        f" of the median step); peak memory {peak / 2**30:.3f} GiB "
        f"({held / 2**30:.3f} GiB held before); data loss "
        f"{data_loss[0]:.4f} -> {data_loss[-1]:.4f}, l2 term {l2[0]:.4f} "
        f"-> {l2[-1]:.4f}")
    # From scratch at nesterovs 0.1, with no warm-up, the data loss first
    # rises (from ~8 to ~16 over steps 2-4 on the card, as the JAX
    # package's own run reports a score of 15.98 after its first 10
    # steps, examples/sustained_training.py), then falls: the one batch is
    # memorized, so more steps, untimed, must bring the score below the
    # first within RESNET_MAX_STEPS
    more = []
    while scores[-1] >= scores[0] and len(scores) + len(more) < \
            RESNET_MAX_STEPS and all(np.isfinite(scores + more)):
        net.fit(ds)
        more.append(net.score())
        if more[-1] < scores[0]:
            break
    log(f"[graph] ResNet-50 scores {scores}; then {len(more)} more steps "
        f"to fall below the first: {more}")
    if not (all(np.isfinite(scores + more))
            and (scores + more)[-1] < scores[0]):
        raise RuntimeError(f"ResNet-50 did not train: scores {scores}, "
                           f"{more}, l2 terms {l2}")
    profile = profile_step(net, ds, min(step_ms[2:]))
    out_ms = []
    x = ds.features
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net.output(x)
        torch.cuda.synchronize()
        out_ms.append((time.perf_counter() - t0) * 1e3)
    row_err = float((out.sum(-1) - 1).abs().max())
    log(f"[graph] ResNet-50 output() at batch {RESNET_BATCH}: {out_ms} ms "
        f"(the first cold), row-sum err {row_err:.2e}")
    if tuple(out.shape) != (RESNET_BATCH, 1000) or not \
            torch.isfinite(out).all() or row_err > ROW_SUM_ATOL:
        raise RuntimeError("ResNet-50 output() is not finite probabilities")
    return {"batch": RESNET_BATCH, "params": net.num_params(),
            "scores": scores, "l2_terms": l2, "data_loss": data_loss,
            "scores_after": more,
            "step_ms": step_ms, "median_step_ms": median,
            "samples_per_s": RESNET_BATCH * 1e3 / median,
            "flop_per_step": flops, "bound_ms": bound,
            "bound_by": "operations", "peak_mem_bytes": peak,
            "mem_before_bytes": held, "profile": profile,
            "output_ms": out_ms, "output_median_warm_ms":
            float(np.median(out_ms[1:]))}


def graph_attention(N, A, seed: int):
    """(d): the network of phase 5 built with graph_builder(), on the
    weights of a MultiLayerNetwork twin: 2 fit steps each on one batch;
    the graph's params and score must equal the twin's (bf16 params,
    element-wise within rtol 2^-7), and K1, K2, K3 must launch once a
    step each on the graph's run (the twin's run is not counted)."""
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    twin = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN, heads=HEADS,
                     n_out=N_OUT, cache_len=SEQ)
    conf = (N.NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(1e-3).graph_builder().add_inputs("in")
            .add_layer("attn", CausalSelfAttention(
                n_out=HIDDEN, n_heads=HEADS, cache_len=SEQ), "in")
            .add_layer("out", RnnOutputLayer(
                n_out=N_OUT, activation="softmax", loss="mcxent"), "attn")
            .set_outputs("out")
            .set_input_types(inputs.recurrent(N_IN, SEQ)).build())
    net = ComputationGraph(conf).init()
    net.set_flat_params(twin.get_flat_params())
    ds = make_batch(seed, BATCH, SEQ, N_IN, N_OUT)
    twin_scores = []
    for _ in range(GRAPH_ATTN_STEPS):
        twin.fit(ds)
        twin_scores.append(twin.score())
    torch.cuda.synchronize()
    A.reset_launches()            # counts of the graph's run only
    scores, step_ms = [], []
    for _ in range(GRAPH_ATTN_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        scores.append(net.score())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(A.LAUNCHES)
    expected = {name: GRAPH_ATTN_STEPS for name in KERNELS}
    expected["flash_fwd_partials"] = 0
    check = compare("graph vs MultiLayerNetwork params after "
                    f"{GRAPH_ATTN_STEPS} steps",
                    torch.as_tensor(net.get_flat_params()).bfloat16(),
                    torch.as_tensor(twin.get_flat_params()))
    log(f"[graph] attention graph at batch {BATCH}, T={SEQ}: scores "
        f"{scores} (twin {twin_scores}); step ms {step_ms}; launches "
        f"{launches}")
    if launches != expected:
        raise RuntimeError(f"graph launches in {GRAPH_ATTN_STEPS} steps: "
                           f"{launches}, expected {expected}")
    if not np.allclose(scores, twin_scores, rtol=BF16_RTOL, atol=0):
        raise RuntimeError("the graph's scores differ from its twin's")
    del twin
    return net, {"scores": scores, "twin_scores": twin_scores,
                 "step_ms": step_ms, "launches": launches,
                 "params_vs_twin": check}


def lstm_graph_session(N, seed: int) -> dict:
    """(e, second half): a graph with a GravesLSTM vertex (84 -> 256 ->
    RnnOutputLayer(84), the card's mixed_bf16), trained LSTM_GRAPH_FITS
    fits on a Markov text, behind InferenceEngine: a session's chunk of
    SESSION_PREFILL steps and SESSION_STEPS single steps against
    rnn_time_step over the same split (the same operations on the same
    shapes)."""
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    conf = (N.NeuralNetConfiguration.builder().seed(seed).updater("rmsprop")
            .learning_rate(0.1).graph_builder().add_inputs("chars")
            .add_layer("lstm", GravesLSTM(n_out=CHAR_HIDDEN,
                                          activation="tanh"), "chars")
            .add_layer("out", RnnOutputLayer(
                n_out=CHAR_VOCAB, activation="softmax", loss="mcxent"),
                "lstm")
            .set_outputs("out")
            .set_input_types(inputs.recurrent(CHAR_VOCAB)).build())
    from deeplearning4j_tpu_torch.datasets import DataSet
    net = ComputationGraph(conf).init()
    eye = np.eye(CHAR_VOCAB, dtype=np.float32)
    text = eye[markov_ids(seed + 9, 8, SESSION_PREFILL + SESSION_STEPS + 1)]
    for _ in range(LSTM_GRAPH_FITS):   # away from uniform outputs
        net.fit(DataSet(text[:, :-1], text[:, 1:]))
    x = text[:1, :-1]
    net.rnn_clear_previous_state()
    want = [net.rnn_time_step(x[:, :SESSION_PREFILL]).cpu().numpy()] + [
        net.rnn_time_step(x[:, t]).cpu().numpy()[:, None]
        for t in range(SESSION_PREFILL, x.shape[1])]
    with InferenceEngine(net, name="graph-lstm") as engine:
        got = [engine.predict_session("s", x[:, :SESSION_PREFILL])] + [
            engine.predict_session("s", x[:, t])[:, None]
            for t in range(SESSION_PREFILL, x.shape[1])]
        carry_paths = sorted(engine.sessions.get_carries("s"))
    err, signal = hold_probs("LSTM graph session vs rnn_time_step",
                             np.concatenate(got, 1),
                             np.concatenate(want, 1), LSTM_SESSION_ATOL,
                             "graph")
    if carry_paths != ["lstm", "out"]:
        raise RuntimeError(f"the session's carries are keyed {carry_paths}")
    return {"max_abs_err": err, "signal": signal,
            "steps": int(x.shape[1])}


def graph_serving(A, net, seed: int) -> dict:
    """(e): the attention graph of (d) behind InferenceEngine as phase 8
    serves the MultiLayerNetwork: predict from three clients and two
    decode sessions through the graph's SessionCache against output();
    none of K1-K4 may launch on it."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    rng = np.random.RandomState(seed + 11)
    torch.cuda.synchronize()
    A.reset_launches()
    result = {}
    with InferenceEngine(net, max_batch_size=4, max_latency_ms=5,
                         timestep_buckets=SERVE_BUCKETS,
                         name="graph-smoke") as engine:
        result["buckets"] = engine.warmup((SEQ, N_IN))
        result["predict"] = serve_predict(engine, net, rng,
                                          monitor.registry(), BF16_PROB_ATOL)
        result["decode_warmed"] = engine.warmup_decode((N_IN,))
        result["sessions"] = two_sessions(engine, net, rng, "graph",
                                          BF16_PROB_ATOL)
    result["launches"] = dict(A.LAUNCHES)
    if any(result["launches"].values()):
        raise RuntimeError("graph serving launched a flash kernel")
    return result


def phase_graph(N, A, seed: int) -> dict:
    """Phase 12: the ComputationGraph: the graph golden, the all-vertex
    graph card vs CPU, ResNet-50 at full width, the attention network as
    a graph (the ``graph`` path of the kernels line: K1-K3 once a step)
    and graph serving."""
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    torch.cuda.synchronize()
    A.reset_launches()
    result = {"golden": phase_goldens(ms, (GRAPH_GOLDEN,), "graph"),
              "reference": graph_reference(N)}
    torch.cuda.empty_cache()
    result["resnet50"] = graph_resnet(seed)
    torch.cuda.empty_cache()
    if any(A.LAUNCHES.values()):
        raise RuntimeError(f"the graph golden, the all-vertex graph or "
                           f"ResNet-50 launched a flash kernel: {A.LAUNCHES}")
    net, result["attention"] = graph_attention(N, A, seed)
    result["launches"] = result["attention"]["launches"]
    result["serving"] = graph_serving(A, net, seed)
    del net
    torch.cuda.empty_cache()
    result["lstm_session"] = lstm_graph_session(N, seed)
    log(f"[graph] launches {result['launches']}")
    return result


# ------------------------------------------------------------ phase 13
def device_split(prof) -> tuple:
    """(device events, busy ms as the union of their intervals, count of
    host-to-device copies) of a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in device):
        if end is None or a > end:
            busy_ms, end = busy_ms + b - a, b
        elif b > end:
            busy_ms, end = busy_ms + b - end, b
    htod = sum(1 for e in prof.events() if "HtoD" in e.name)
    return device, busy_ms / 1e3, htod


class EpochClock:
    """A listener: the synchronized wall seconds of each epoch, and
    ``torch.profiler`` over the whole of epoch ``profiled`` (started
    before the clock starts and stopped after it stops)."""

    def __init__(self, profiled: int):
        self.seconds, self._t0 = [], 0.0
        self.profiled, self.prof = profiled, None

    def iteration_done(self, model, iteration):
        pass

    def on_epoch_start(self, model):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        if model.epoch == self.profiled:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self._t0 = time.perf_counter()

    def on_epoch_end(self, model):
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - self._t0)
        if model.epoch == self.profiled:
            self.prof.__exit__(None, None, None)


def staged_bytes(path: str) -> float:
    from deeplearning4j_tpu_torch import monitor
    return monitor.gauge("ingest_staged_bytes").value(path=path)


def flat_state(net) -> tuple:
    return net.get_flat_params(), net.get_flat_updater_state()


def same_state(what: str, got, want, atol: float = 0.0) -> float:
    """Max |got - want| over the params and the updater state (the fp32
    masters included); 0 is required when ``atol`` is 0."""
    err = max(float(np.max(np.abs(g.astype(np.float64) - w)))
              if g.size else 0.0 for g, w in zip(got, want))
    bitwise = all(np.array_equal(g, w) for g, w in zip(got, want))
    log(f"[fused] {what}: max |diff| {err:.3e} over params and updater "
        f"state, bitwise {bitwise} (tol {atol:g})")
    if (atol == 0.0 and not bitwise) or err > atol:
        raise RuntimeError(f"{what}: captured and eager differ by {err}")
    return err


def fused_lenet(harness: dict, ffcnn: dict) -> tuple:
    """(a): LeNet-5 on the full procedural MNIST through fit(iterator)'s
    default ingest, the epoch cache, with a CheckpointListener; epoch 2
    under torch.profiler."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.listeners.listeners import \
        CheckpointListener
    t0 = time.perf_counter()
    train = MnistDataSetIterator(FUSED_BATCH, FUSED_TRAIN)
    test = MnistDataSetIterator(MNIST_TEST_BATCH, FUSED_TEST, train=False)
    gen_s = time.perf_counter() - t0
    net = MultiLayerNetwork(lenet()).init()
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"LeNet runs under {net._pol().name}")
    clock = EpochClock(profiled=1)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointListener(tmp, save_every_n_iterations=CKPT_EVERY,
                                  save_every_epochs=1, keep_last=CKPT_KEEP)
        net.set_listeners(clock, ckpt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net.fit(train, epochs=FUSED_EPOCHS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        ckpt.flush()
        written = len(ckpt.saved)
        kept = len(os.listdir(tmp))
    peak = torch.cuda.max_memory_allocated()
    staged = staged_bytes("cache")
    want = FUSED_TRAIN * 784 + FUSED_TRAIN * 10 * 4
    steps = -(-FUSED_TRAIN // FUSED_BATCH)
    iterations = net.iteration
    net.set_listeners(clock)           # one more epoch, not profiled
    net.fit(train)
    rates = [FUSED_TRAIN / s for s in clock.seconds]
    device, busy_ms, htod = device_split(clock.prof)
    wall_ms = clock.seconds[1] * 1e3
    idle = 1.0 - busy_ms / wall_ms
    t0 = time.perf_counter()
    acc = net.evaluate(test).accuracy()
    eval_s = time.perf_counter() - t0
    log(f"[fused] LeNet-5 on {FUSED_TRAIN} MNIST (generated with "
        f"{FUSED_TEST} test images in {gen_s:.2f} s), batch {FUSED_BATCH}, "
        f"{steps} steps an epoch through the epoch cache: staged "
        f"{staged:.0f} bytes (u8 wire + f32 labels: {want}); epoch seconds "
        f"{clock.seconds} = {rates[0]:.1f} and {rates[1]:.1f} samples/s "
        f"(per-batch path: phase 11's {harness['fit_samples_per_s']:.1f} "
        f"at batch 128 through the iterator, phase 9's median step "
        f"{ffcnn['lenet']['samples_per_s']:.1f} at batch 256); fit "
        f"{fit_s:.3f} s; epoch 2 under torch.profiler: host "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{idle:.4f}, {len(device)} device events, {htod} host-to-device "
        f"copies; test accuracy {acc:.4f} on {FUSED_TEST} (> "
        f"{MNIST_MIN_ACCURACY}) in {eval_s:.3f} s; {written} checkpoints "
        f"written, {kept} kept; {len(net._graphs)} captured step(s); peak "
        f"memory {peak / 2**20:.1f} MiB")
    if staged != want:
        raise RuntimeError(f"the cache staged {staged} bytes, not {want}")
    if not net._graphs or iterations != FUSED_EPOCHS * steps:
        raise RuntimeError("LeNet did not train through captured steps")
    if htod:
        raise RuntimeError(f"epoch 2 made {htod} host-to-device copies")
    if not acc > MNIST_MIN_ACCURACY:
        raise RuntimeError(f"LeNet reached {acc} on MNIST")
    if written != FUSED_EPOCHS:
        raise RuntimeError(f"{written} checkpoints written")
    return train, {
        "generate_s": gen_s, "epoch_s": clock.seconds,
        "samples_per_s": rates, "fit_s": fit_s, "staged_bytes": staged,
        "epoch2_wall_ms": wall_ms, "epoch2_busy_ms": busy_ms,
        "epoch2_idle_share": idle, "epoch2_device_events": len(device),
        "epoch2_htod_copies": htod, "accuracy": acc, "evaluate_s": eval_s,
        "checkpoints_written": written, "peak_mem_bytes": peak}


def lenet_pair(dtype):
    """Two LeNet-5s of one seed (the same initial weights)."""
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return [MultiLayerNetwork(lenet(compute_dtype=dtype)).init()
            for _ in range(2)]


def fused_captured_vs_eager(train) -> dict:
    """(b): CAPTURE_STEPS steps through the captured cache path against
    the same batches through the eager per-batch path, fp32 and bf16."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.dataset import attach_wire, wire_of
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    n = CAPTURE_STEPS * FUSED_BATCH
    src = train._ds
    u8, fmt = wire_of(src)
    ds = attach_wire(DataSet(src.features[:n], src.labels[:n]), u8[:n], fmt)
    out = {}
    for dtype, atol in (("float32", 0.0), (None, GOLDEN_BF16_ATOL)):
        cap, eager = lenet_pair(dtype)
        cap.fit(ListDataSetIterator(ds, FUSED_BATCH), ingest="cache")
        eager.fit(ListDataSetIterator(ds, FUSED_BATCH), ingest="batch")
        if not cap._graphs:
            raise RuntimeError("the cache path did not capture")
        name = cap._pol().name
        out[name] = same_state(f"LeNet {name}, {CAPTURE_STEPS} steps "
                               "captured vs eager", flat_state(cap),
                               flat_state(eager), atol)
    return out


def fused_attention(N, A, seed: int) -> dict:
    """(c): phase 5's network through fit(iterator, ingest="cache"),
    captured: equal to the eager per-batch path after ATTN_CACHE_STEPS
    steps.  One more epoch, with the counts set to 0 just before it,
    replays the graph under torch.profiler: the wrappers count nothing
    there (a replay runs no wrapper), and the profiler's kernel names
    give the launches of K1-K3 inside the replays, the ``fused`` path's
    counts (K4 shares K1's kernel name; the capturing fit's wrapper
    counts show it is not in the graph)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    ds = make_batch(seed, BATCH * ATTN_CACHE_STEPS, SEQ, N_IN, N_OUT)
    nets = [build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN,
                      heads=HEADS, n_out=N_OUT, cache_len=SEQ)
            for _ in range(2)]
    cap, eager = nets
    eager.fit(ListDataSetIterator(ds, BATCH), ingest="batch")
    A.reset_launches()
    cap.fit(ListDataSetIterator(ds, BATCH), ingest="cache")
    torch.cuda.synchronize()
    capturing = dict(A.LAUNCHES)     # the warm-up steps and the capture
    err = same_state(f"attention network, {ATTN_CACHE_STEPS} steps "
                     "captured vs eager", flat_state(cap), flat_state(eager))
    A.reset_launches()               # the replayed epoch's counts only
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cap.fit(ListDataSetIterator(ds, BATCH), ingest="cache")
        torch.cuda.synchronize()
    wrappers = dict(A.LAUNCHES)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    seen = {k: sum(1 for n in names if k in n) for k in PORT_KERNELS}
    launches = {"flash_fwd": seen["flash_fwd_kernel"],
                "flash_fwd_partials": 0,
                "flash_bwd_dkdv": seen["flash_bwd_dkdv_kernel"],
                "flash_bwd_dq": seen["flash_bwd_dq_kernel"]}
    log(f"[fused] attention cache path: wrapper counts of the capturing "
        f"fit {capturing}; one more epoch of replays: wrapper counts "
        f"{wrappers}, profiler kernels {seen}")
    if capturing["flash_fwd_partials"] or not all(
            capturing[k] for k in ("flash_fwd", "flash_bwd_dkdv",
                                   "flash_bwd_dq")):
        raise RuntimeError(f"the capturing fit's launches {capturing}")
    if any(wrappers.values()) or \
            any(seen[k] != ATTN_CACHE_STEPS for k in PORT_KERNELS):
        raise RuntimeError(f"K1-K3 did not run inside the graph's replays: "
                           f"profiler {seen}, wrappers {wrappers}")
    return {"max_abs_diff": err, "launches": launches,
            "capturing_fit_wrapper_counts": capturing,
            "profiler_kernels": seen}


def fused_resume(train) -> dict:
    """(d): a mid-epoch checkpoint from a manager whose step cadence
    splits the epoch, resumed with resume_from="auto", against the
    uninterrupted run, bitwise (mixed_bf16: fp32 masters included)."""
    import json
    import shutil
    import tempfile
    import zipfile

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.dataset import attach_wire, wire_of
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.resilience import (CheckpointManager,
                                                     list_checkpoints)
    n = RESUME_TRAIN
    src = train._ds
    u8, fmt = wire_of(src)
    ds = attach_wire(DataSet(src.features[:n], src.labels[:n]), u8[:n], fmt)

    def it():
        return ListDataSetIterator(ds, FUSED_BATCH, shuffle=True, seed=5)

    ref, run = lenet_pair(None)
    ref.fit(it(), epochs=2)
    with tempfile.TemporaryDirectory() as tmp:
        full, cold = os.path.join(tmp, "full"), os.path.join(tmp, "cold")
        run.fit(it(), epochs=2, checkpoint=CheckpointManager(
            full, every_steps=RESUME_EVERY, keep_last=8))
        same_state("the checkpointed run vs the uninterrupted one",
                   flat_state(run), flat_state(ref))
        mids = []
        for path in list_checkpoints(full):
            with zipfile.ZipFile(path) as zf:
                r = json.loads(zf.read("resume.json"))
            if r["epoch"] == 1 and r["step_in_epoch"] > 0:
                mids.append((path, r))
        path, r = mids[0]
        if not all(isinstance(m["score"], float) and np.isfinite(m["score"])
                   for _, m in mids):
            raise RuntimeError("a checkpoint lost its score: "
                               f"{[m['score'] for _, m in mids]}")
        os.makedirs(cold)
        shutil.copy(path, cold)
        resumed = lenet_pair(None)[0]
        resumed.fit(it(), epochs=2, checkpoint=CheckpointManager(cold),
                    resume_from="auto")
    log(f"[fused] resumed from {os.path.basename(path)} (score "
        f"{r['score']}, epoch {r['epoch']}, step {r['step_in_epoch']} of "
        f"{RESUME_TRAIN // FUSED_BATCH}) to iteration {resumed.iteration}")
    err = same_state("mid-epoch resume vs the uninterrupted run",
                     flat_state(resumed), flat_state(ref))
    if resumed.iteration != ref.iteration:
        raise RuntimeError("the resumed run stopped elsewhere")
    return {"checkpoint_iteration": r["iteration"],
            "step_in_epoch": r["step_in_epoch"], "max_abs_diff": err}


def fused_window(train) -> dict:
    """(e): an AsyncDataSetIterator with a standardizing preprocessor is
    not cacheable: "auto" takes the window path, equal to "batch" in
    fp32 bitwise."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator, ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.normalizers import \
        NormalizerStandardize
    from deeplearning4j_tpu_torch.nn.ingest import cacheable_source
    n = WINDOW_BATCHES * FUSED_BATCH
    ds = DataSet(train._ds.features[:n], train._ds.labels[:n])
    norm = NormalizerStandardize().fit(ds)

    def it():
        a = AsyncDataSetIterator(ListDataSetIterator(ds, FUSED_BATCH))
        a.set_preprocessor(norm)
        return a

    win, eager = lenet_pair("float32")
    src = it()
    if cacheable_source(src) is not None:
        raise RuntimeError("a preprocessed async iterator is cacheable")
    from deeplearning4j_tpu_torch import monitor
    monitor.gauge("ingest_staged_bytes").set(-1, path="window")
    win.fit(src, window=WINDOW_SIZE)
    src.close()
    last = staged_bytes("window")
    other = it()
    eager.fit(other, ingest="batch")
    other.close()
    row = FUSED_BATCH * (784 * 4 + 10 * 4)
    sizes = [min(WINDOW_SIZE, WINDOW_BATCHES - i)
             for i in range(0, WINDOW_BATCHES, WINDOW_SIZE)]
    per_window = [k * row for k in sizes]
    log(f"[fused] window path: {len(sizes)} windows of {sizes} batches, "
        f"staged bytes per window {per_window} (the gauge after the last: "
        f"{last:.0f})")
    if last != per_window[-1]:
        raise RuntimeError(f"the window path staged {last} bytes last")
    err = same_state("window vs batch, fp32", flat_state(win),
                     flat_state(eager))
    return {"windows": sizes, "staged_bytes_per_window": per_window,
            "max_abs_diff": err}


def attention_graph(N, seed: int):
    """Phase 5's network built with graph_builder()."""
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        CausalSelfAttention
    from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
    conf = (N.NeuralNetConfiguration.builder().seed(seed).updater("adam")
            .learning_rate(1e-3).graph_builder().add_inputs("in")
            .add_layer("attn", CausalSelfAttention(
                n_out=HIDDEN, n_heads=HEADS, cache_len=SEQ), "in")
            .add_layer("out", RnnOutputLayer(
                n_out=N_OUT, activation="softmax", loss="mcxent"), "attn")
            .set_outputs("out")
            .set_input_types(inputs.recurrent(N_IN, SEQ)).build())
    return ComputationGraph(conf).init()


def fused_scan(N, A, train, seed: int) -> dict:
    """(h): fit_scan (the batches stacked, staged on a side stream, an
    event before use) against the same batches through per-batch fit,
    bitwise: fp32 LeNet as a MultiLayerNetwork, and phase 5's network as
    a ComputationGraph under mixed_bf16 (K1-K3 once a step)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    src = train._ds
    lenet_batches = [DataSet(src.features[i * FUSED_BATCH:
                                          (i + 1) * FUSED_BATCH],
                             src.labels[i * FUSED_BATCH:
                                        (i + 1) * FUSED_BATCH])
                     for i in range(CAPTURE_STEPS)]
    attn_batches = [make_batch(seed + i, BATCH, SEQ, N_IN, N_OUT)
                    for i in range(ATTN_CACHE_STEPS)]
    out = {}
    for name, build, batches in (
            ("LeNet-5 fp32 (MultiLayerNetwork)",
             lambda: lenet_pair("float32")[0], lenet_batches),
            ("attention net mixed_bf16 (ComputationGraph)",
             lambda: attention_graph(N, seed), attn_batches)):
        scanned, eager = build(), build()
        A.reset_launches()
        scores = scanned.fit_scan(batches)
        launches = dict(A.LAUNCHES)
        eager_scores = []
        for ds in batches:
            eager.fit(ds)
            eager_scores.append(eager.score())
        err = same_state(f"fit_scan vs per-batch fit, {name}, "
                         f"{len(batches)} steps", flat_state(scanned),
                         flat_state(eager))
        if not np.array_equal(scores, np.asarray(eager_scores,
                                                 scores.dtype)):
            raise RuntimeError(f"fit_scan scores {scores} vs per-batch "
                               f"{eager_scores}")
        out[name] = {"steps": len(batches), "max_abs_diff": err,
                     "launches": launches}
    graph_launches = out["attention net mixed_bf16 (ComputationGraph)"][
        "launches"]
    if graph_launches != {"flash_fwd": ATTN_CACHE_STEPS,
                          "flash_fwd_partials": 0,
                          "flash_bwd_dkdv": ATTN_CACHE_STEPS,
                          "flash_bwd_dq": ATTN_CACHE_STEPS}:
        raise RuntimeError(f"fit_scan's launches {graph_launches}")
    return out


def resnet_data(n: int):
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(0)
    f = torch.from_numpy(rng.rand(n, 224, 224, 3).astype(np.float32)) \
        .to(torch.bfloat16)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, n)]
    return DataSet(f, y)


def fused_resnet(ds) -> dict:
    """(f): ResNet-50 through the graph's epoch cache at
    examples/sustained_training.py's configuration: bf16 host images,
    batch RESNET_BATCH, one warm-up epoch (upload and capture), then
    RESNET_CACHE_EPOCHS timed epochs."""
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    net = ComputationGraph(resnet50()).init()
    it = ListDataSetIterator(ds, RESNET_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(it, epochs=1)
    first = net.score()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    net.fit(it, epochs=RESNET_CACHE_EPOCHS)
    final = net.score()
    timed_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    staged = staged_bytes("cache")
    n = ds.num_examples()
    want = n * 224 * 224 * 3 * 2 + n * 1000 * 4
    rate = RESNET_CACHE_EPOCHS * n / timed_s
    wall_ms, n_events, by_name, busy_ms = profiled(lambda: net.fit(it))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[fused] ResNet-50 one more epoch under torch.profiler: host "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
        f"{1 - busy_ms / wall_ms:.4f}), {n_events} device events; top 5: "
        + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top))
    log(f"[fused] ResNet-50 graph cache, {n} bf16 images at 224x224, batch"
        f" {RESNET_BATCH}: staged {staged:.0f} bytes ({want}); warm-up epoch"
        f" {warm_s:.2f} s (upload, capture), {RESNET_CACHE_EPOCHS} epochs "
        f"in {timed_s:.3f} s = {rate:.1f} samples/s; score {first:.4f} "
        f"after the warm-up epoch -> {final:.4f}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    if staged != want or not net._graphs:
        raise RuntimeError("ResNet-50 did not train from the graph cache")
    if not (np.isfinite(first) and np.isfinite(final)):
        raise RuntimeError(f"ResNet-50 scores {first}, {final}")
    return {"examples": n, "staged_bytes": staged, "warmup_epoch_s": warm_s,
            "timed_s": timed_s, "samples_per_s": rate, "first_score": first,
            "final_score": final, "peak_mem_bytes": peak,
            "profiled_epoch": {"wall_ms": wall_ms, "busy_ms": busy_ms,
                               "idle_share": 1 - busy_ms / wall_ms,
                               "device_events": n_events,
                               "top5": [{"name": k[:120], "ms": v}
                                        for k, v in top]}}


def fused_resnet_vs_eager(ds) -> dict:
    """(f): 2 steps of ResNet-50 captured vs eager, mixed_bf16, within
    the graph golden's bf16 tolerance."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    n = 2 * RESNET_BATCH
    small = DataSet(ds.features[:n], ds.labels[:n])
    cap = ComputationGraph(resnet50()).init()
    cap.fit(ListDataSetIterator(small, RESNET_BATCH), ingest="cache")
    got = flat_state(cap)
    del cap
    torch.cuda.empty_cache()
    eager = ComputationGraph(resnet50()).init()
    eager.fit(ListDataSetIterator(small, RESNET_BATCH), ingest="batch")
    return {"max_abs_diff": same_state(
        "ResNet-50, 2 steps captured vs eager (mixed_bf16)", got,
        flat_state(eager), GOLDEN_BF16_ATOL)}


def fused_health(N) -> dict:
    """(g): skip_update on all-NaN batches leaves the params and the
    updater state bitwise unchanged on the cache and per-batch paths;
    under abort the card and the CPU name the same step and layer."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.monitor import health
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rng = np.random.RandomState(3)
    x = rng.rand(3 * FUSED_BATCH, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 3 * FUSED_BATCH)]
    nan = DataSet(np.full_like(x, np.nan), y)
    try:
        health.enable("skip_update")
        net = MultiLayerNetwork(lenet(compute_dtype="float32")).init()
        before = flat_state(net)
        net.fit(ListDataSetIterator(nan, FUSED_BATCH), ingest="cache")
        net.fit(DataSet(nan.features[:FUSED_BATCH], y[:FUSED_BATCH]))
        skipped = monitor.counter(health.SKIPPED_TOTAL).value()
        same_state("skip_update on NaN batches (cache, then per-batch)",
                   flat_state(net), before)
        health.enable("abort")
        x[FUSED_BATCH + 7, 100] = np.nan      # batch 2 of 3
        where = {}
        for device in ("cuda", "cpu"):
            net = MultiLayerNetwork(lenet(compute_dtype="float32"),
                                    device=device).init()
            try:
                net.fit(ListDataSetIterator(DataSet(x, y), FUSED_BATCH),
                        ingest="cache")
            except health.TrainingDivergedError as e:
                where[device] = (e.step, e.layer)
    finally:
        health.reset()
    log(f"[fused] health: {skipped:.0f} steps skipped; abort at (step, "
        f"layer) {where}")
    if skipped != 4 or where.get("cuda") is None or \
            where["cuda"] != where.get("cpu"):
        raise RuntimeError(f"the health guard: skipped {skipped}, {where}")
    return {"skipped": skipped, "abort": where["cuda"]}


def phase_fused(N, A, seed: int, harness: dict, ffcnn: dict) -> dict:
    """Phase 13: the fused training runtime: the epoch cache (a captured
    CUDA graph a step), the window path, mid-epoch resume, fit_scan, the
    health guard, with LeNet-5 on the full MNIST and ResNet-50 (the
    ``fused`` path of the kernels line: K1-K3 inside the attention net's
    graph replays, counted by the profiler)."""
    train, result = fused_lenet(harness, ffcnn)
    result = {"lenet": result}
    torch.cuda.empty_cache()
    images = resnet_data(RESNET_CACHE_N)
    result["resnet50"] = fused_resnet(images)
    torch.cuda.empty_cache()
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        result["captured_vs_eager"] = fused_captured_vs_eager(train)
        result["resnet50"]["captured_vs_eager"] = \
            fused_resnet_vs_eager(images)
        del images
        torch.cuda.empty_cache()
        result["attention"] = fused_attention(N, A, seed)
        result["launches"] = result["attention"]["launches"]
        torch.cuda.empty_cache()
        result["resume"] = fused_resume(train)
        result["window"] = fused_window(train)
        result["fit_scan"] = fused_scan(N, A, train, seed)
        result["health"] = fused_health(N)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    log(f"[fused] launches {result['launches']}")
    return result


# ------------------------------------------------------- phase 14
def layer_flops(net, batch: int) -> List[float]:
    """Multiply-adds x 2 of one forward of each layer of a
    MultiLayerNetwork, from the shapes its configuration infers (the
    input type through each preprocessor and layer)."""
    it = net.conf.input_type
    flops = []
    for i, layer in enumerate(net.layers):
        if i in net.conf.input_preprocessors:
            it = net.conf.input_preprocessors[i].output_type(it)
        out, kind = layer.output_type(it), type(layer).__name__
        if kind == "ConvolutionLayer":
            kh, kw = layer.kernel_size
            flops.append(2.0 * batch * out.height * out.width * kh * kw
                         * layer.n_in * layer.n_out)
        elif kind in ("DenseLayer", "OutputLayer"):
            flops.append(2.0 * batch * layer.n_in * layer.n_out)
        else:
            flops.append(0.0)
        it = out
    return flops


def vgg_images(seed: int, n: int, classes: int):
    """``n`` seeded 0-255 images through VGG16ImagePreProcessor and
    one-hot labels, on the host."""
    from deeplearning4j_tpu_torch.keras.trained_models import \
        VGG16ImagePreProcessor
    rng = np.random.RandomState(seed)
    f = VGG16ImagePreProcessor().transform(
        rng.rand(n, 224, 224, 3).astype(np.float32) * 255)
    return f, np.eye(classes, dtype=np.float32)[rng.randint(0, classes, n)]


def timed_steps(net, ds, warmup: int, steps: int):
    """``warmup`` untimed fit steps, then ``steps`` timed ones (host clock
    around a step that ends in a score read and a synchronize).  Returns
    (scores of the timed steps, their ms)."""
    for _ in range(warmup):
        net.fit(ds)
    scores, step_ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(ds)
        s = net.score()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    return scores, step_ms


def transfer_vgg(seed: int):
    """(a): VGG-16 at full width trains from scratch on one staged batch:
    the median step, samples/s, peak memory, a profiled step and the FLOP
    bound of three forwards at the bf16 peak."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.keras.trained_models import vgg16
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = vgg16()
    for u in [conf.conf.updater] + [l.updater for l in conf.layers]:
        u.learning_rate = VGG_LR
    net = MultiLayerNetwork(conf).init()
    if net._pol().name != "mixed_bf16":
        raise RuntimeError(f"VGG-16 runs under {net._pol().name}")
    if net.num_params() != 138_357_544:
        raise RuntimeError(f"VGG-16 has {net.num_params()} params")
    f, y = vgg_images(seed, VGG_BATCH, 1000)
    ds = DataSet(torch.as_tensor(f, device=net.device),
                 torch.as_tensor(y, device=net.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scores, step_ms = timed_steps(net, ds, VGG_WARMUP, VGG_STEPS)
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    flops = 3.0 * sum(layer_flops(net, VGG_BATCH))
    bound = flops / PEAK_BF16_FLOPS * 1e3
    more = []
    while scores[-1] >= scores[0] and len(scores) + len(more) < \
            VGG_MAX_STEPS and all(np.isfinite(scores + more)):
        net.fit(ds)
        more.append(net.score())
        if more[-1] < scores[0]:
            break
    log(f"[transfer] VGG-16 batch {VGG_BATCH}, 224x224, lr {VGG_LR:g}: "
        f"scores {scores}, then {more}; median step {median:.3f} ms "
        f"({VGG_BATCH * 1e3 / median:.1f} samples/s), steps {step_ms}; "
        f"{flops:.4e} FLOP a step, bound {bound:.4f} ms at the bf16 peak "
        f"({bound / median:.3f} of the median); peak memory "
        f"{peak / 2**30:.3f} GiB")
    if not (all(np.isfinite(scores + more))
            and (scores + more)[-1] < scores[0]):
        raise RuntimeError(f"VGG-16 did not train: {scores}, {more}")
    profile = profile_step(net, ds, min(step_ms))
    return net, {"batch": VGG_BATCH, "params": net.num_params(),
                 "lr": VGG_LR, "scores": scores, "scores_after": more,
                 "step_ms": step_ms, "median_step_ms": median,
                 "samples_per_s": VGG_BATCH * 1e3 / median,
                 "flop_per_step": flops, "bound_ms": bound,
                 "bound_by": "operations", "peak_mem_bytes": peak,
                 "profile": profile}


def frozen_trunk(net) -> List[Dict[str, torch.Tensor]]:
    return [{k: v.clone() for k, v in net.params[i].items()}
            for i in range(TUNE_FROZEN + 1)]


def trunk_unchanged(net, trunk, what: str) -> None:
    for i, tree in enumerate(trunk):
        for k, v in tree.items():
            if not torch.equal(net.params[i][k], v):
                raise RuntimeError(f"{what}: frozen layer {i} {k} moved")
    log(f"[transfer] {what}: the frozen trunk (layers 0-{TUNE_FROZEN}) is "
        "bitwise unchanged")


def transfer_finetune(vgg, seed: int) -> dict:
    """(b): the frozen-trunk fine-tune of (a)'s net, per batch and
    through the epoch cache, and the master check."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning

    def tuned(lr):
        return (TransferLearning.builder(vgg).fine_tune_learning_rate(lr)
                .set_feature_extractor(TUNE_FROZEN).remove_output_layer()
                .add_layer(OutputLayer(n_in=4096, n_out=TUNE_CLASSES))
                .build())

    net = tuned(VGG_LR)
    frozen = [l.frozen for l in net.layers]
    if frozen != [True] * (TUNE_FROZEN + 1) + [False] * 3:
        raise RuntimeError(f"frozen flags {frozen}")
    trunk = frozen_trunk(net)
    f, y = vgg_images(seed + 1, VGG_BATCH * TUNE_CACHE_BATCHES, TUNE_CLASSES)
    ds = DataSet(torch.as_tensor(f[:VGG_BATCH], device=net.device),
                 torch.as_tensor(y[:VGG_BATCH], device=net.device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scores, step_ms = timed_steps(net, ds, VGG_WARMUP, VGG_STEPS)
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(step_ms))
    per_layer = layer_flops(net, VGG_BATCH)
    # the trunk's forward, and three forwards of the trained head
    flops = sum(per_layer[:TUNE_FROZEN + 1]) + 3.0 * sum(
        per_layer[TUNE_FROZEN + 1:])
    bound = flops / PEAK_BF16_FLOPS * 1e3
    log(f"[transfer] fine-tune (layers 0-{TUNE_FROZEN} frozen, head "
        f"{TUNE_CLASSES} classes) batch {VGG_BATCH}: scores {scores}; "
        f"median step {median:.3f} ms ({VGG_BATCH * 1e3 / median:.1f} "
        f"samples/s), steps {step_ms}; {flops:.4e} FLOP a step, bound "
        f"{bound:.4f} ms ({bound / median:.3f} of the median); peak memory "
        f"{peak / 2**30:.3f} GiB")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"the fine-tune's scores {scores}")
    profile = profile_step(net, ds, min(step_ms))
    # the same steps with the frozen trunk differentiated, as a step that
    # reads its gradients (the health vector) must: what leaving it out
    # of autograd saves
    keys = {key for key, _ in net._slots()}
    net._grad_keys = lambda all_layers: keys
    _, diff_ms = timed_steps(net, ds, 1, VGG_WARMUP + 2)
    del net._grad_keys
    diff_median = float(np.median(diff_ms))
    log(f"[transfer] the same step with the frozen trunk in autograd: "
        f"median {diff_median:.3f} ms, steps {diff_ms}")
    trunk_unchanged(net, trunk, "per-batch fine-tune")
    del ds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(DataSet(f, y), VGG_BATCH),
            epochs=TUNE_EPOCHS)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    if not net._graphs:
        raise RuntimeError("fit(iterator) did not take the epoch cache")
    log(f"[transfer] fit(iterator) default: {TUNE_EPOCHS} epochs of "
        f"{TUNE_CACHE_BATCHES} batches from the epoch cache (one captured "
        f"graph a step, capture included) in {cache_s:.3f} s, score "
        f"{net.score():.4f}")
    trunk_unchanged(net, trunk, "epoch-cache fine-tune")
    del net, trunk
    torch.cuda.empty_cache()
    # the master check: without the masters re-derived from the
    # transferred weights, the first step would write the fresh init back
    probe = tuned(MASTER_LR)
    probe.fit(DataSet(torch.as_tensor(f[:VGG_BATCH], device=probe.device),
                      torch.as_tensor(y[:VGG_BATCH], device=probe.device)))
    worst, outside = 0.0, 0
    for i in range(TUNE_FROZEN + 1, len(vgg.layers) - 1):
        for k, src in vgg.params[i].items():
            ref = src.float()
            gap = (probe.params[i][k].float() - ref).abs()
            worst = max(worst, float(gap.max()))
            outside += int((gap > BF16_RTOL * ref.abs() + BF16_ATOL).sum())
    log(f"[transfer] master check: one step at lr {MASTER_LR:g} moves the "
        f"kept Dense layers by at most {worst:.3e} from the source; "
        f"{outside} elements outside one bf16 ulp (rtol {BF16_RTOL:g}, atol "
        f"{BF16_ATOL:g})")
    if outside:
        raise RuntimeError("the fine-tune did not start from the "
                           "transferred weights")
    return {"batch": VGG_BATCH, "classes": TUNE_CLASSES,
            "frozen_through": TUNE_FROZEN, "scores": scores,
            "step_ms": step_ms, "median_step_ms": median,
            "samples_per_s": VGG_BATCH * 1e3 / median,
            "flop_per_step": flops, "bound_ms": bound,
            "bound_by": "operations", "peak_mem_bytes": peak,
            "profile": profile, "trunk_in_autograd_step_ms": diff_ms,
            "trunk_in_autograd_median_ms": diff_median,
            "cache_epochs_s": cache_s,
            "master_max_abs": worst, "master_outside": outside}


def transfer_small(seed: int) -> dict:
    """(c): the importer's 64x64 VGG-16 variant in fp32, weights carried
    from the CPU to the card by flat params: outputs, then a transfer
    (trunk frozen, a new 3-class head with the CPU's weights) and one
    fine-tune step, card vs CPU within REF_RTOL."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.keras.trained_models import vgg16
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning

    def small():
        return vgg16(n_classes=VGG_SMALL_CLASSES, height=VGG_SMALL,
                     width=VGG_SMALL, compute_dtype="float32")

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    cpu = MultiLayerNetwork(small(), device="cpu").init()
    card = MultiLayerNetwork(small()).init()
    card.set_flat_params(cpu.get_flat_params())
    rng = np.random.RandomState(seed + 2)
    x = rng.rand(4, VGG_SMALL, VGG_SMALL, 3).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 4)]
    out_rel = rel(card.output(x).cpu().numpy(), cpu.output(x).numpy())
    nets = [(TransferLearning.builder(n).set_feature_extractor(TUNE_FROZEN)
             .remove_output_layer().add_layer(OutputLayer(n_in=4096, n_out=3))
             .build()) for n in (cpu, card)]
    nets[1].set_flat_params(nets[0].get_flat_params())
    for n in nets:
        n.fit(DataSet(x, y))
    p_rel = rel(nets[1].get_flat_params(), nets[0].get_flat_params())
    s_rel = abs(nets[1].score() - nets[0].score()) / abs(nets[0].score())
    log(f"[transfer] {VGG_SMALL}x{VGG_SMALL} VGG-16 fp32 card vs CPU: "
        f"outputs rel={out_rel:.2e}; after one fine-tune step params "
        f"rel={p_rel:.2e}, score rel={s_rel:.2e} (tol {REF_RTOL:g})")
    if not max(out_rel, p_rel, s_rel) <= REF_RTOL:
        raise RuntimeError("the 64x64 VGG-16 disagrees between card and CPU")
    return {"outputs_rel": out_rel, "params_rel": p_rel, "score_rel": s_rel}


def phase_transfer(A, seed: int) -> dict:
    """Phase 14: transfer learning and VGG-16 (the ``transfer`` path of the
    kernels line: it launches none of K1-K4)."""
    torch.cuda.synchronize()
    A.reset_launches()            # counts of the main path's run only
    vgg, result = transfer_vgg(seed)
    result = {"vgg16": result}
    torch.cuda.empty_cache()
    result["fine_tune"] = transfer_finetune(vgg, seed)
    del vgg
    torch.cuda.empty_cache()
    result["small_fp32"] = transfer_small(seed)
    result["launches"] = dict(A.LAUNCHES)
    log(f"[transfer] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the transfer path launched a flash kernel")
    return result


# ------------------------------------------------------------- phase 15
def emb_rel(what: str, got: torch.Tensor, want: torch.Tensor,
            rtol: float = EMB_REF_RTOL) -> float:
    """max|got - want| / max|want| of two tables (any devices); raises
    above ``rtol`` or on a non-finite value."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{what}: non-finite values")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rel = err / scale
    log(f"[embeddings] {what}: max|diff| {err:.3e}, {rel:.3e} of "
        f"max|ref| {scale:.3e} (tol {rtol:g})")
    if not rel <= rtol:
        raise RuntimeError(f"{what}: {rel:.3e} of max|ref| > {rtol:g}")
    return rel


class scatter_agg:
    """``DL4J_TPU_SCATTER_AGG`` set to ``on`` inside the block."""

    def __init__(self, on: bool):
        self.on, self.prev = on, None

    def __enter__(self):
        self.prev = os.environ.get("DL4J_TPU_SCATTER_AGG")
        os.environ["DL4J_TPU_SCATTER_AGG"] = "1" if self.on else "0"

    def __exit__(self, *exc):
        if self.prev is None:
            del os.environ["DL4J_TPU_SCATTER_AGG"]
        else:
            os.environ["DL4J_TPU_SCATTER_AGG"] = self.prev


class deterministic:
    """``torch.use_deterministic_algorithms(True)`` inside the block (with
    the cuBLAS workspace setting it asks for)."""

    def __enter__(self):
        self.prev = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        if self.prev is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.prev


def top_kernels(by_name: dict, n: int = 5) -> list:
    return [{"name": name[:120], "ms": ms} for ms, name in
            sorted(((ms, name) for name, ms in by_name.items()),
                   reverse=True)[:n]]


def sgns_inputs(device):
    """bench.py:483's staged SGNS batch: seeded syn0, zero syn1neg, the
    indices, labels and masks, lr 0.025."""
    rng = np.random.RandomState(0)
    V, D, B, K = EMB_VOCAB, EMB_DIM, EMB_BATCH, EMB_K
    syn0 = torch.from_numpy(rng.randn(V, D).astype(np.float32) * 0.01)
    inputs = torch.from_numpy(rng.randint(0, V, B))
    targets = torch.from_numpy(rng.randint(0, V, (B, 1 + K)))
    labels = torch.cat([torch.ones(1), torch.zeros(K)])
    args = (inputs, targets, labels, torch.ones((B, 1 + K)),
            torch.ones((B,)), torch.tensor(0.025))
    return (syn0.to(device), torch.zeros((V, D), device=device),
            tuple(a.to(device) for a in args))


def emb_sgns_step() -> dict:
    """(a) The staged SGNS step at full width, plain and aggregated: one
    step of each against the CPU, then EMB_RUNS runs of EMB_STEPS steps
    a route in turns (plain, aggregated, aggregated, plain; host clock,
    synchronized), then EMB_PROFILED_STEPS steps of each route under
    ``torch.profiler``.  The bound is bench.py:539-542's hand model of
    the bytes a step moves over the card's memory rate."""
    from deeplearning4j_tpu_torch.nlp.word2vec import _ns_update
    from deeplearning4j_tpu_torch.ops import scatter
    B, D, K = EMB_BATCH, EMB_DIM, EMB_K
    syn0, syn1, args = sgns_inputs("cuda")
    c0, c1, cargs = sgns_inputs("cpu")
    _ns_update(c0, c1, *cargs)
    checks = {}
    tables = {}
    for agg in (False, True):
        with scatter_agg(agg):
            s0, s1 = syn0.clone(), syn1.clone()
            _ns_update(s0, s1, *args)
        route = "aggregated" if agg else "plain"
        checks[route] = {
            "syn0": emb_rel(f"one SGNS step ({route}) card vs CPU", s0, c0),
            "syn1neg": emb_rel(f"one SGNS step ({route}) card vs CPU syn1neg",
                               s1, c1)}
        tables[agg] = (s0, s1)
    hand_bytes = (2 * B * D * 4 + 2 * B * (1 + K) * D * 4 + B * 4
                  + B * (1 + K) * (4 + 4 + 4))
    bound = hand_bytes / PEAK_BYTES * 1e3
    runs = {False: [], True: []}
    for agg in (False, True, True, False):
        s0, s1 = tables[agg]
        with scatter_agg(agg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EMB_STEPS):
                _, _, loss = _ns_update(s0, s1, *args)
            torch.cuda.synchronize()
        runs[agg].append((time.perf_counter() - t0) * 1e3 / EMB_STEPS)
        if not np.isfinite(loss.item()):
            raise RuntimeError("the staged SGNS step diverged")
    result = {"bytes_per_step": hand_bytes, "bound_ms": bound,
              "bound_by": "bytes", "steps_per_run": EMB_STEPS,
              "card_vs_cpu": checks}
    for agg in (False, True):
        s0, s1 = tables[agg]
        with scatter_agg(agg):
            wall, events, by_name, busy = profiled(
                lambda: [_ns_update(s0, s1, *args)
                         for _ in range(EMB_PROFILED_STEPS)])
        ms = float(np.mean(runs[agg]))
        route = "aggregated" if agg else "plain"
        result[route] = {
            "run_ms_per_step": runs[agg], "ms_per_step": ms,
            "pairs_per_s": B * 1e3 / ms, "bound_share": bound / ms,
            "device_events_per_step": events / EMB_PROFILED_STEPS,
            "device_busy_ms_per_step": busy / EMB_PROFILED_STEPS,
            "idle_share": 1.0 - busy / wall,
            "top5": top_kernels(by_name)}
        log(f"[embeddings] SGNS step V={EMB_VOCAB} D={D} B={B} K={K}, "
            f"{route}: {ms:.4f} ms a step (runs {runs[agg]}), "
            f"{B * 1e3 / ms:.1f} pairs/s; bytes bound {bound:.5f} ms "
            f"({bound / ms:.3f} of the step); profiled: "
            f"{events / EMB_PROFILED_STEPS:.1f} device events and "
            f"{busy / EMB_PROFILED_STEPS:.4f} ms busy a step, idle "
            f"{1.0 - busy / wall:.3f}; top 5: "
            + "; ".join(f"{d['name'][:60]} {d['ms']:.3f}"
                        for d in result[route]["top5"]))
    faster = result["aggregated"]["ms_per_step"] < \
        result["plain"]["ms_per_step"]
    result["faster_route"] = "aggregated" if faster else "plain"
    result["card_default_aggregates"] = scatter.CARD_AGGREGATES
    log(f"[embeddings] the faster route here: {result['faster_route']}; "
        f"the card's default aggregates: {scatter.CARD_AGGREGATES}")
    return result


def emb_corpus(seed: int = 0):
    """bench.py:564's corpus: EMB_WORDS // EMB_SENT_LEN seeded sentences
    of EMB_SENT_LEN words over EMB_VOCAB."""
    rng = np.random.RandomState(seed)
    return [["w%d" % w for w in rng.randint(0, EMB_VOCAB, EMB_SENT_LEN)]
            for _ in range(EMB_WORDS // EMB_SENT_LEN)]


def emb_fit() -> dict:
    """(b) End-to-end ``SequenceVectors.fit`` through the device pipeline
    at full width: a warm-up fit (vocab, corpus upload, one pass), then
    EMB_FITS timed fits (each one pass; ``finish()`` reads the counters,
    the completion barrier), one more under ``torch.profiler``."""
    from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors
    t0 = time.perf_counter()
    seqs = emb_corpus()
    sv = SequenceVectors(layer_size=EMB_DIM, window_size=EMB_WINDOW,
                         negative=EMB_K, use_hierarchic_softmax=False,
                         batch_size=EMB_BATCH, epochs=1,
                         min_word_frequency=1, pair_generation="device")
    if sv.device.type != "cuda":
        raise RuntimeError(f"SequenceVectors defaults to {sv.device}")
    sv.build_vocab(seqs)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sv.fit(seqs)
    warm_s = time.perf_counter() - t0
    first = dict(sv._device_pipeline_stats)
    secs = []
    for _ in range(EMB_FITS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sv.fit(seqs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    wall_ms, events, by_name, busy_ms = profiled(lambda: sv.fit(seqs))
    last = dict(sv._device_pipeline_stats)
    peak = torch.cuda.max_memory_allocated()
    pairs = last["pairs_trained"]
    med = float(np.median(secs))
    first_loss = first["loss_sum"] / first["pairs_trained"]
    last_loss = last["loss_sum"] / last["pairs_trained"]
    result = {"corpus_words": EMB_WORDS, "span": last["span"],
              "n_spans": last["n_spans"], "pairs_per_pass": pairs,
              "setup_s": setup_s, "warmup_fit_s": warm_s, "fit_s": secs,
              "pairs_per_s": pairs / med,
              "profiled_fit_ms": wall_ms, "device_events": events,
              "device_events_per_span": events / last["n_spans"],
              "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
              "idle_share_steady": 1.0 - busy_ms / (med * 1e3),
              "top5": top_kernels(by_name), "peak_mem_bytes": peak,
              "loss_per_pair_first": first_loss,
              "loss_per_pair_last": last_loss}
    log(f"[embeddings] fit: {EMB_WORDS} words, span {last['span']}, "
        f"{last['n_spans']} spans, {pairs:.0f} pairs a pass; setup "
        f"{setup_s:.2f} s, warm-up fit {warm_s:.2f} s, fits {secs} s: "
        f"{pairs / med:.1f} pairs/s; profiled pass {wall_ms:.1f} ms, "
        f"{events} device events ({events / last['n_spans']:.1f} a span), "
        f"busy {busy_ms:.1f} ms, idle {1.0 - busy_ms / wall_ms:.3f} "
        f"({result['idle_share_steady']:.3f} of the median fit); peak "
        f"{peak / 2**30:.3f} GiB; loss a pair {first_loss:.4f} -> "
        f"{last_loss:.4f}; top 5: " + "; ".join(
            f"{d['name'][:60]} {d['ms']:.2f}" for d in result["top5"]))
    if not (np.isfinite(last_loss) and last_loss < first_loss):
        raise RuntimeError(f"the fit's loss did not fall: {first_loss} -> "
                           f"{last_loss}")
    return result


EMB_CASES = {
    "skipgram_ns": dict(use_hierarchic_softmax=False, negative=4),
    "skipgram_hs": dict(use_hierarchic_softmax=True, negative=0),
    "cbow_hs_ns": dict(use_hierarchic_softmax=True, negative=3,
                       elements_learning_algorithm="cbow"),
}


def emb_small_pass(device, case: str) -> tuple:
    """One subsampled device-pipeline pass over a small zipf corpus with
    the draws of ``host_draws(7)``; the tables (on the CPU) and stats."""
    from deeplearning4j_tpu_torch.nlp.device_corpus import host_draws
    from deeplearning4j_tpu_torch.nlp.word2vec import SequenceVectors
    rng = np.random.RandomState(0)
    zipf = np.minimum(rng.zipf(1.3, 6000) - 1, 47)
    seqs = [["w%d" % w for w in zipf[i:i + 30]] for i in range(0, 6000, 30)]
    sv = SequenceVectors(layer_size=16, window_size=3, epochs=1,
                         batch_size=256, seed=5, sampling=2e-2,
                         pair_generation="device", device=device,
                         **EMB_CASES[case])
    sv.draw_source = host_draws(7)
    sv.fit(seqs)
    lt = sv.lookup_table
    return ({n: getattr(lt, n).cpu() for n in ("syn0", "syn1", "syn1neg")
             if getattr(lt, n) is not None}, sv._device_pipeline_stats)


def emb_card_vs_cpu() -> dict:
    """(c) One pass of each case on the card and on the CPU from the same
    tables and draws, within EMB_REF_RTOL; then two passes on the card
    under deterministic algorithms, bitwise equal."""
    result = {}
    for case in EMB_CASES:
        card, cs = emb_small_pass(None, case)
        cpu, ps = emb_small_pass("cpu", case)
        if cs["pairs_trained"] != ps["pairs_trained"]:
            raise RuntimeError(f"{case}: {cs['pairs_trained']} pairs on the "
                               f"card, {ps['pairs_trained']} on the CPU")
        rel = {n: emb_rel(f"{case} pass card vs CPU {n}", card[n], cpu[n])
               for n in cpu}
        with deterministic():
            a, _ = emb_small_pass(None, case)
            b, _ = emb_small_pass(None, case)
        same = all(torch.equal(a[n], b[n]) for n in a)
        log(f"[embeddings] {case}: two deterministic passes on the card "
            f"bitwise equal: {same}")
        if not same:
            raise RuntimeError(f"{case}: deterministic passes differ")
        result[case] = {"pairs": cs["pairs_trained"], "rel": rel,
                        "deterministic_bitwise": same}
    return result


def emb_example() -> dict:
    """(d) examples/word2vec_text.py's configuration through the port's
    ``Word2Vec.Builder`` on the card (the host path)."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w2v = (Word2Vec.Builder().min_word_frequency(2).layer_size(24)
           .window_size(3).seed(1).epochs(80).negative(5).batch_size(128)
           .build())
    w2v.fit(W2V_SENTENCES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nearest = w2v.words_nearest("king", top_n=3)
    analogy = w2v.words_nearest(["king", "woman"], negative=["man"],
                                top_n=3)
    log(f"[embeddings] word2vec_text: fit {secs:.2f} s on "
        f"{w2v.lookup_table.syn0.device}; nearest to 'king' {nearest}; "
        f"king - man + woman -> {analogy}")
    if w2v.lookup_table.syn0.device.type != "cuda":
        raise RuntimeError("Word2Vec trained off the card")
    if "queen" not in nearest:
        raise RuntimeError(f"'queen' is not near 'king': {nearest}")
    return {"fit_s": secs, "nearest": nearest, "analogy": analogy}


def glove_data(device):
    """bench.py:605's triples, order and init (numpy streams 0 and 1)."""
    rng = np.random.RandomState(0)
    n, V, D, B = GLOVE_TRIPLES, GLOVE_VOCAB, EMB_DIM, EMB_BATCH
    rows = np.minimum(rng.zipf(1.5, n) - 1, V - 1)
    cols = np.minimum(rng.zipf(1.5, n) - 1, V - 1)
    xs = rng.rand(n).astype(np.float32) * 50 + 1
    n_chunks = -(-n // B)
    order = np.full(n_chunks * B, -1, np.int64)
    order[:n] = rng.permutation(n)
    r = np.random.RandomState(1)
    W = (r.rand(V, D).astype(np.float32) - .5) / D
    Wc = (r.rand(V, D).astype(np.float32) - .5) / D
    data = [torch.from_numpy(a).to(device) for a in (
        rows, cols, np.log(xs),
        np.minimum(1.0, (xs / 100.0) ** 0.75).astype(np.float32))]
    order_d = torch.from_numpy(order.reshape(n_chunks, B)).to(device)
    return data, order_d, torch.from_numpy(W), torch.from_numpy(Wc)


def glove_tables(W, Wc, device):
    """Fresh naive tables and packed fused state from one init."""
    V, D = W.shape
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    naive = [W.to(device), Wc.to(device), z(V), z(V), z(V, D), z(V, D),
             z(V), z(V)]
    fused = [torch.cat([W.to(device), z(V, 1), z(V, D), z(V, 1)], dim=1),
             torch.cat([Wc.to(device), z(V, 1), z(V, D), z(V, 1)], dim=1)]
    return naive, fused


def emb_glove() -> dict:
    """(e) GloVe at bench.py:605's configuration: the two AdaGrad routes
    from the same init after one batch (within EMB_REF_RTOL), then
    GLOVE_EPOCHS epochs of each, timed (fused, naive)."""
    from deeplearning4j_tpu_torch.nlp.glove import (_glove_epoch,
                                                    _glove_epoch_fused)
    data, order, W, Wc = glove_data("cuda")
    lr = torch.tensor(0.05, device="cuda")
    D = EMB_DIM
    naive, fused = glove_tables(W, Wc, "cuda")
    _glove_epoch(*naive, *data, order[:1], lr)
    _glove_epoch_fused(*fused, *data, order[:1], lr)
    rel = {"W": emb_rel("GloVe one batch fused vs naive W",
                        fused[0][:, :D], naive[0]),
           "Wc": emb_rel("GloVe one batch fused vs naive Wc",
                         fused[1][:, :D], naive[1]),
           "b": emb_rel("GloVe one batch fused vs naive b",
                        fused[0][:, D], naive[2]),
           "hW": emb_rel("GloVe one batch fused vs naive hW",
                         fused[0][:, D + 1:2 * D + 1], naive[4])}
    B, n_chunks = EMB_BATCH, order.shape[0]
    hand_bytes = 2 * 2 * B * (2 * D + 2) * 4 + B * (4 + 4 + 4 + 4)
    bound = hand_bytes * n_chunks / PEAK_BYTES * 1e3
    result = {"one_batch_rel": rel, "epoch_bound_ms": bound,
              "bound_by": "bytes"}
    for route, fn in (("fused", _glove_epoch_fused), ("naive", _glove_epoch)):
        naive, fused = glove_tables(W, Wc, "cuda")
        tables = fused if route == "fused" else naive
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GLOVE_EPOCHS):
            loss = fn(*tables, *data, order, lr)
        loss = loss.item()
        secs = time.perf_counter() - t0
        rate = GLOVE_EPOCHS * GLOVE_TRIPLES / secs
        log(f"[embeddings] GloVe {route}: {GLOVE_EPOCHS} epochs of "
            f"{GLOVE_TRIPLES} triples (V={GLOVE_VOCAB}, D={D}, B={B}) in "
            f"{secs:.3f} s, {rate:.1f} triples/s, last epoch loss "
            f"{loss:.1f}; bytes bound {bound:.4f} ms an epoch")
        if not np.isfinite(loss):
            raise RuntimeError(f"GloVe {route} diverged")
        result[route] = {"seconds": secs, "triples_per_s": rate,
                         "epoch_ms": secs * 1e3 / GLOVE_EPOCHS,
                         "last_epoch_loss": loss}
    return result


def pv_small(device, mode: str):
    from deeplearning4j_tpu_torch.nlp.device_corpus import host_draws
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
        ParagraphVectors
    rng = np.random.RandomState(3)
    docs = [(" ".join("w%d" % w for w in np.minimum(
        rng.zipf(1.4, 40) - 1, 29)), "DOC_%d" % i) for i in range(8)]
    pv = ParagraphVectors(sequence_learning_algorithm=mode, layer_size=16,
                          window_size=3, negative=3, epochs=2,
                          batch_size=128, seed=9, pair_generation="device",
                          device=device)
    pv.draw_source = host_draws(11)
    pv.fit(docs)
    return pv, docs


def emb_pv() -> dict:
    """(f) PV-DBOW at bench.py:783's configuration through the device
    pipelines (a warm-up fit, then EMB_FITS timed fits: word and label
    pairs/s); then PV-DM (HS and NS) and ``infer_vector`` on 8 small
    documents, card against CPU from the same draws."""
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
        ParagraphVectors
    rng = np.random.RandomState(0)
    docs = [(" ".join("w%d" % w for w in rng.randint(0, EMB_VOCAB,
                                                     PV_DOC_LEN)),
             "DOC_%d" % i) for i in range(PV_DOCS)]
    pv = ParagraphVectors(sequence_learning_algorithm="dbow",
                          layer_size=EMB_DIM, negative=EMB_K,
                          use_hierarchic_softmax=False, epochs=1,
                          batch_size=EMB_BATCH, min_word_frequency=1,
                          pair_generation="device")
    t0 = time.perf_counter()
    pv.fit(docs)
    warm_s = time.perf_counter() - t0
    secs = []
    for _ in range(EMB_FITS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pv.fit(docs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    words = pv._device_pipeline_stats["pairs_trained"]
    labels = pv._device_dbow_stats["pairs_trained"]
    rate = (words + labels) / float(np.median(secs))
    log(f"[embeddings] PV-DBOW {PV_DOCS} docs x {PV_DOC_LEN} words: warm-up "
        f"fit {warm_s:.2f} s, fits {secs} s; {words:.0f} word + "
        f"{labels:.0f} label pairs a pass, {rate:.1f} pairs/s")
    result = {"dbow": {"warmup_fit_s": warm_s, "fit_s": secs,
                       "word_pairs_per_pass": words,
                       "label_pairs_per_pass": labels,
                       "pairs_per_s": rate}}
    del pv
    card, docs = pv_small(None, "dm")
    cpu, _ = pv_small("cpu", "dm")
    rel = {n: emb_rel(f"PV-DM card vs CPU {n}",
                      getattr(card.lookup_table, n),
                      getattr(cpu.lookup_table, n))
           for n in ("syn0", "syn1", "syn1neg")}
    text = docs[2][0].split()[:15]
    rel["infer_vector"] = emb_rel(
        "PV-DM infer_vector card vs CPU",
        torch.from_numpy(card.infer_vector(text)),
        torch.from_numpy(cpu.infer_vector(text)))
    result["dm_card_vs_cpu"] = rel
    return result


def phase_embeddings(A) -> dict:
    """Phase 15: the embeddings tier (the ``embeddings`` path of the
    kernels line: it launches none of K1-K4)."""
    torch.cuda.synchronize()
    A.reset_launches()            # counts of the main path's run only
    result, seconds = {}, {}
    for name, part in (("sgns_step", emb_sgns_step), ("fit", emb_fit),
                       ("card_vs_cpu", emb_card_vs_cpu),
                       ("example", emb_example), ("glove", emb_glove),
                       ("pv", emb_pv)):
        t0 = time.perf_counter()
        result[name] = part()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    result["seconds"] = seconds
    log(f"[embeddings] seconds by part {seconds}")
    result["launches"] = dict(A.LAUNCHES)
    log(f"[embeddings] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the embeddings path launched a flash kernel")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    card = card_line()
    log(f"[device] {card}")

    from deeplearning4j_tpu_torch.nn.conf import \
        neural_net_configuration as N
    from deeplearning4j_tpu_torch.ops import attention as A
    from deeplearning4j_tpu_torch.ops import kernel_build
    from deeplearning4j_tpu_torch.parallel import sequence as S

    t0 = time.perf_counter()
    for source in kernel_build.SOURCES:
        kernel_build.build(source)
    build_s = time.perf_counter() - t0
    log(f"[build] {len(kernel_build.SOURCES)} source(s) in {build_s:.1f} s")

    timing = phase_kernels(A, args.seed)
    reference = phase_reference(N, A, args.seed)
    net, ds, training = phase_training(N, A, args.seed)
    inference = phase_inference(net, ds)
    del ds
    torch.cuda.empty_cache()
    ring = phase_ring(A, S, args.seed)
    torch.cuda.empty_cache()
    serving = phase_serving(N, A, net, args.seed)
    del net
    torch.cuda.empty_cache()
    ffcnn = phase_ffcnn(N, A, args.seed)
    torch.cuda.empty_cache()
    recurrent = phase_recurrent(N, A, S, args.seed)
    torch.cuda.empty_cache()
    harness = phase_harness(N, A, ffcnn["lenet"]["samples_per_s"])
    torch.cuda.empty_cache()
    graph = phase_graph(N, A, args.seed)
    torch.cuda.empty_cache()
    fused = phase_fused(N, A, args.seed, harness["lenet_mnist"], ffcnn)
    torch.cuda.empty_cache()
    transfer = phase_transfer(A, args.seed)
    torch.cuda.empty_cache()
    embeddings = phase_embeddings(A)

    sources = {"flash_fwd": "deeplearning4j_tpu/ops/attention.py:222",
               "flash_fwd_partials": "deeplearning4j_tpu/ops/attention.py:290",
               "flash_bwd_dkdv": "deeplearning4j_tpu/ops/attention.py:479",
               "flash_bwd_dq": "deeplearning4j_tpu/ops/attention.py:502"}
    # the main paths, each run with the counts set to 0 just before it
    paths = {"training": training["launches"], "ring": ring["launches"],
             "serving": serving["launches"],
             "feedforward_cnn": ffcnn["launches"],
             "recurrent": recurrent["launches"],
             "harness": harness["launches"], "graph": graph["launches"],
             "fused": fused["launches"], "transfer": transfer["launches"],
             "embeddings": embeddings["launches"]}
    kernels = [dict(name=name, route="cuda",
                    source="deeplearning4j_tpu_torch/ops/csrc/"
                           "flash_attention.cu",
                    replaces=sources[name],
                    launches=sum(counts[name] for counts in paths.values()),
                    launches_by_path={path: counts[name]
                                      for path, counts in paths.items()},
                    **timing[name])
               for name in sources]
    print(json.dumps({"build_s": build_s, "reference": reference,
                      "training": training, "inference": inference,
                      "ring": ring, "serving": serving,
                      "feedforward_cnn": ffcnn, "recurrent": recurrent,
                      "harness": harness, "graph": graph, "fused": fused,
                      "transfer": transfer, "embeddings": embeddings}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
