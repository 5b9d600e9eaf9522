"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; the exit code is non-zero on any):

1. device: a CUDA card must be present; prints its name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. build: compiles every kernel source of the port, and the weight
   arena of phase 24's runner, with nvcc (one process a source, started
   together);
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
   (tight; for K1/K4 and K3 over the key tile of the body that ran,
   ``attention.fwd_key_tile`` and ``attention.bwd_key_tile``), and the
   all-f32 twin (the gap that rounding costs, bounded and reported on the
   ``[check]`` lines and as ``f32_twin_gap``).  Every bf16 launch of K1-K4
   here, timed ones included, must take its Hopper body (wgmma, TMA:
   ``flash_fwd_sm90_kernel``, ``flash_bwd_dkdv_sm90_kernel``,
   ``flash_bwd_dq_sm90_kernel``), the f32 ones the scalar bodies
   (``attention.BODY_LAUNCHES``; reported as ``body`` and
   ``body_launches``); then the updater's fused Adam
   (``adam_master_step_kernel``, ``ops/adam.py``) at the LFM2 cell's
   expert leaf (117,440,512 bf16 values with an fp32 master), a size with
   a tail and a view off 16 bytes, in both forms with a host and a device
   alpha, bit for bit against the torch ops it replaces, then timed in
   place against them and its byte bound (``[adam]`` line; the
   ``adam_master_step`` entry of the kernels line);
4. reference: a small network trains 2 steps on the card (kernels) and on
   the CPU (plain versions) from the same weights, in fp32; scores and
   params must agree, and each card step launches the fused Adam once a
   leaf (the master-less f32 route);
5. training: the full-width network (CausalSelfAttention(n_out=256,
   n_heads=4, cache_len=8192) -> RnnOutputLayer(n_out=32, softmax,
   mcxent), n_in=64, adam, the card's default mixed_bf16 policy) takes
   3 fit steps; the score must be finite and every kernel's
   launch count must rise by exactly one per step (the fused Adam's by one
   an Adam leaf a step, each leaf counted fused in
   ``updater_leaves_total``), every K1-K3 launch on
   its Hopper body (as on the bf16 ring of phase 7, the graph steps of
   phase 12 and the captured paths of phase 13: ``hopper_bodies``); then
   one
   more step
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
   0 times on this path;
16. DeepWalk, the language tools and the readers ([deepwalk] lines; no
   hand kernel: the walk steps, gathers, einsums and ``index_add_``
   through torch, XLA in the JAX package): (a) ``bench.py:717``'s
   configuration (20,000 vertices, 200,000 random edges, walk length 40,
   window 2, dim 128) through ``DeepWalk.Builder`` on the card, walks
   generated there: a warm-up epoch, then ``DW_TRIALS`` timed
   ``fit(g, walk_length=40, epochs=2)`` (pairs/s, median and spread),
   ``bench_deepwalk``'s bytes bound with the mean Huffman code length read
   from the code-mask table and pairs/s as a share of it, one profiled
   epoch (device events a chunk, busy ms, idle share), peak memory, the
   graph's build seconds on the host and the loss a pair; (b) a
   two-community graph: the device walks and their pair grid from the
   same draws bitwise equal on the card and the CPU, then one
   device-walk and one host-walk epoch of each, tables within
   ``EMB_REF_RTOL``, and two on the card under deterministic algorithms
   bitwise equal; (c) ``tests/test_graph.py``'s two-clique graph on the
   card: in-community similarity above cross-community; (d) the procedural
   ``CifarDataSetIterator`` through ``fit(iterator)``'s epoch cache on a
   small CNN (the u8 wire staged, 0 host-to-device copies in the
   profiled second epoch, a finite score), the iris MLP fed from a CSV by
   ``RecordReaderDataSetIterator`` card vs CPU (``DW_IRIS_RTOL``), and
   ``Word2Vec`` with ``JapaneseTokenizerFactory()`` over the lattice
   tests' sentences with the vocab of the same model on the CPU.  K1-K4
   launch 0 times on this path;
17. the pretraining families ([pretrain] lines; no hand kernel: cuBLAS
   products and elementwise torch ops, plain XLA products in the JAX
   package): (a) the DL4J 0.7 examples' ``DeepAutoEncoderExample`` at full
   width (nine RBMs 784-1000-500-250-100-30-100-250-500-1000 with
   kl_divergence, an OutputLayer 1000 -> 784, seed 123, line gradient
   descent, ``pretrain(True).backprop(True)``, batch 1000 of the
   procedural MNIST binarised at 0.5) under the card's ``mixed_bf16``:
   ``fit`` over ``DAE_BATCHES`` batches pretrains each RBM (ms a step,
   median and spread; each RBM's mean-field reconstruction error on a
   held-out batch must fall) and then fine-tunes one line-search iteration
   a batch (ms an iteration, host reads; the held-out score must fall; the
   first fine-tune step must land nearer the pretrained weights than the
   init, the params equal to their fp32 masters cast to bf16), one
   profiled pretrain step and fine-tune iteration (idle share), peak
   memory; (b) its ``VariationalAutoEncoderExample`` at full width (784 ->
   2, encoder and decoder (256, 256), leakyrelu, identity p(z|x),
   Bernoulli(sigmoid), rmsprop 1e-3, l2 1e-4, xavier, seed 12345, batch
   128, pretrain only): ``VAE_EPOCHS`` x ``VAE_BATCHES`` steps (ms a step;
   the ELBO loss and the held-out loss must fall and the held-out
   ``reconstruction_log_probability`` rise), one fp32 step's score and
   gradients card vs CPU on the same params and draws within
   ``REF_RTOL``; (c) LeNet-5 (BASELINE config #1, batch 256) with a
   ``CenterLossOutputLayer`` at the JAX defaults: one fp32 step's cL
   against the reference delta per batch and on the captured step, then
   ``CL_EPOCHS`` epochs per batch and from the epoch cache under
   ``mixed_bf16``, equal within ``GOLDEN_BF16_ATOL`` (ms a step of each);
   (d) an AutoEncoder on ``CurvesDataSetIterator``, a gaussian-visible
   RBM, a VAE with a composite distribution and a ComputationGraph with a
   pretrained vertex, card vs CPU in fp32 on one draw stream
   (``host_pretrain_draws``) within ``REF_RTOL``;
   ``check_pretrain_gradients`` of the card-trained VAE copied to the CPU
   in f64; a zip of every new layer written on the card and restored on
   the CPU (bitwise); the masters rule under sgd and adam; (e) the
   kill/resume harness (``resilience/chaos.py``) with its children on the
   card: the victim's return code -9, 0 score mismatches, the same final
   params.  K1-K4 launch 0 times on this path;
18. serving v2 and deployment ([serving_v2] and [deploy] lines; no hand
   kernel on the serving side: the int8 decode is three torch elementwise
   ops a leaf, the products cuBLAS/cuDNN): (a) phase 8's attention net
   behind a ``mixed_bf16`` and a ``quantize="int8"`` engine (buckets
   1024/8192, batch <= 4): model_bytes, probabilities, ms a decoded token
   at batch 1 and 4; LeNet-5 trained 2 epochs on MNIST behind an fp32 and
   an int8 engine, held to the JAX package's gates (top-1 agreement >=
   0.97, accuracy delta <= 0.02, probabilities within 0.02, model_bytes
   < 0.7x); VGG-16 under int8 (model_bytes against bf16 and f32, a
   batch's peak with the decoded copy); (b) VGG-16, ResNet-50, LeNet-5,
   the char-RNN (sessions) and the attention net in one ``ModelRegistry``
   under a budget of the largest model_bytes plus half the second, three
   round-robin passes: resident bytes within the budget, page-ins and
   evictions counted (page-in ms), every answer bitwise the answer
   before paging (deterministic cuDNN), no bucket callable made, each
   evict dropping ``memory_allocated`` by ``EVICT_FALL`` of its bytes;
   (c) ``bench_serving_v2``'s closed-loop sweep over that registry at 4,
   16 and 48 clients under an SLO of ``S2_SLO_X`` times the unloaded p99
   (sheds at 48), then ``bench_traffic``'s tenant mix in process (gold,
   free, public; observe mode: the unfairness gauge, the
   ``tenant_unfairness`` alert and its bundle; enforce: free shed more
   than gold); K1-K4 launch 0 times on (a)-(c); (d) LeNet-5 fitting at
   batch 256 publishes an epoch's weights through a
   ``DeploymentListener`` into a ``VersionedWeightStore``; a
   ``RolloutController`` canaries each on a held eval set under a
   constant client load (at least 2 promotions, 0 failed requests, the
   served accuracy up, no callable made), rolls back a garbage version
   (its ``rollout_rollback`` bundle) and refuses a corrupt zip with the
   engine unchanged; then the attention net's own ``fit`` step (K1-K3
   once) publishes a version that the rollout promotes, while a decode
   session opened before stays pinned to the old version, bitwise an
   engine holding the old weights, and one opened after takes the new.

19. the serving fleet ([fleet] lines; no hand kernel: the fleet's
   ``FLEET_SPECS["lstm"]`` (2 x GravesLSTM(256), n_in 32, n_out 16, batch
   buckets 1/2/4/8 x timestep buckets 8/16/32) runs cuBLAS and elementwise
   kernels in worker processes, each with its own CUDA context on this
   card): (a) a worker spawned against an empty build-cache namespace,
   terminated, and its replacement in the same namespace (both ready
   lines: boot, model build, warmup, first reply, serve-ready seconds,
   the device); (b) on the warm worker, 20 session steps over 4 sessions
   and one request in each of the two smallest timestep buckets through
   ``POST /predict``: all 200, ``serving_bucket_compiles_total`` (its
   ``/metrics``) unmoved after warmup, every answer within ``FL_ATOL``
   (expected bitwise) of an in-process engine on the same store weights;
   /predict p50/p99 through HTTP beside the in-process engine's; (c) K=1
   then K=3 workers behind ``FleetRouter.serve()``: a closed-loop probe
   of each (K=1's fixes the offered rate at 2.5x its rps, >= 20), then
   5 s of open-loop Poisson session load over 32 sessions on each
   (admitted rps over the window's wall time, p99, the send lag, shed
   fraction, unanswered requests, ``workers_healthy``, this process's
   CPU seconds: router and clients share its GIL), ``speedup_x`` and
   the closed-loop ratio K=3/K=1 (neither is the fleet's capacity: SLO
   shedding and this process's GIL set them); on each K an ill-shaped
   session step answers 400 with every worker healthy; (d) on a K=2
   fleet of its own whose workers hold no SLO (as the reference's live
   failover test), a SIGKILL of a session's home under a closed-loop
   session load: no non-200 answer, the worker respawned at its rank,
   the session home again; (e) K=3 scaled in to K=2, a ``FleetCanary``
   ramps w1 0.05 -> 1.0 to done, a second aborts on a p99 limit below
   the router's; (f) ``bench_deploy``'s HTTP half: LeNet-5 fits while a
   client loads ``POST /predict`` and an operator loop posts
   ``/deploy/lenet`` steps through the port's UIServer (at least 2
   promotions, 0 5xx, no callable made), then a corrupt snapshot pushed
   over HTTP answers 4xx with the engine unchanged; (g) every worker
   process terminated and reaped (its pid gone).  K1-K4 launch 0 times
   on this path: the count is this process's plus each worker's own,
   from the exit line a cleanly stopped worker prints (every worker but
   the SIGKILLed one must report).
20. the parallel tier ([parallel] lines, its results on a
   ``{"parallel": ...}`` JSON line; every slot on cuda:0, which the slot
   list names several times): (a) LeNet-5 at full width under
   ``ParallelWrapper(workers=4, averaging_frequency=2)`` (adam, 64 rows a
   worker, ``PAR_ROUNDS`` rounds) in f64, card vs CPU within
   ``PAR_F64_RTOL`` (in fp32 adam turns the rounding noise of near-zero
   gradients into steps of +-lr); ``workers=1`` bitwise the per-batch
   ``fit`` (deterministic algorithms); samples/s at workers 1 and 4 (one card time-sliced: no
   scaling number) beside the plain per-batch fit at 64 rows and phase
   9's, the ms a round's mean over the workers costs, and
   ``collective_overhead_report``; (b) phase 5's attention net under 2
   workers averaging every step, 2 rounds: K1-K3 launch 4 times each, all
   on their Hopper bodies (``launches_by_path.parallel``), every leaf
   of params, updater state and net state bitwise the two replicas
   stepped by hand and averaged leaf by leaf; ms a round, peak memory;
   (c) ZeRO over 4 slots of LeNet-5 in f64 against the big-batch fit
   within ``PAR_F64_RTOL``, ``ceil(total/4)``
   state elements a tensor a slot, a slot's bytes a quarter; ms a step
   against the plain step under ``mixed_bf16`` (the masters in the
   shard); (d) the deep autoencoder's widths as dense layers in 4
   stages x 8 microbatches of a 1000-row batch, fp32 against the serial
   step within ``REF_RTOL``; ms a step against the serial step; (e) the
   pod over NCCL, K = min(2, cards) ranks (one on a one-card machine)
   over a data=2 mesh: scores and param SHA-256 bitwise the 1-process
   run and the wrapper in this process, a SIGKILL at step 4 and a resume
   from the newest pod checkpoint bitwise, ``measure_collectives``, every
   worker reaped.  (c)-(e) launch no flash kernel.
21. the cluster-training tier ([scaleout] lines, its results on a
   ``{"scaleout": ...}`` JSON line): (a) LeNet-5 at full width under
   ``ClusterMultiLayer(ParameterAveragingTrainingMaster(num_workers=4,
   batch_size_per_worker=64, averaging_frequency=5))`` on the procedural
   MNIST (256 rows a step, ``SO_SPLITS`` splits), through the Direct and
   the Export approach: ms a split, the fold's ms, samples/s beside
   phase 9's, peak memory; the distributed ``evaluate``'s confusion
   matrix equal to ``net.evaluate``'s; ``workers=1`` bitwise the
   per-batch ``fit`` (deterministic algorithms); f64 card vs CPU within
   ``PAR_F64_RTOL``; (b) phase 5's attention net under 2 workers
   averaging every batch, 2 splits: K1-K3 launch 4 times each from the
   master's pool threads, all on their Hopper bodies
   (``launches_by_path.scaleout``), and every leaf of params, updater
   state and net state ``torch.equal`` to the last split's replicas
   folded by hand on the host; (c) ``ParameterServerParallelWrapper`` on
   LeNet-5 in process, 4 workers: the held-out score falls, one fp32
   worker bitwise the sequential fit, the ms of a store pull and push
   and of a replica's host-to-device and device-to-host copies; (d)
   ``bench_scaleout``'s configuration (bench.py:1525-1615) through the
   port: K=3 worker processes on the card against the TCP parameter
   server, 40 rounds, sync DP, async topk8 and f32, a SIGKILL of rank 2,
   the straggler pair at 250 ms on rank 1: both async accuracies and the
   kill's inside the 0.08 band of sync, ``wire_reduction_x`` >= 3, the
   victim's rc -9 with 2 survivors, every worker reaped; the crossover,
   staleness and each worker's ready seconds are readings; (e)
   ``ClusterWord2Vec`` (4 workers, layer 24, window 3, negative 5,
   minimum frequency 2; ``SO_W2V_EPOCHS`` epochs) with its tables on the
   card: the vocab the serial ``TextPipeline``'s, the last epoch's fold
   ``torch.equal`` to a host float64 fold of the workers' tables; (f)
   ``run_multi_host_training`` in a 1-rank NCCL group bitwise the master
   alone.  (a) and (c)-(f) launch no flash kernel.
22. clustering and t-SNE ([clustering] lines): (a) ``KMeansClustering(
   k=10)``, euclidean, on 10,000 procedural-MNIST rows of 784 (config
   #1's input width): the Lloyd loop's ms an iteration and host reads,
   peak memory, the assignments equal to the CPU run's from the same
   seed and the centers within ``CL_CENTER_RTOL``; (b) cosine k-means on
   phase 15's config-#4 word vectors (10,000 x 128), card vs CPU read;
   for both, one assignment step from the same centers may differ card vs
   CPU only at a near tie (``CL_TIE``), and the picks that TF32 distances
   would flip are read; (c) ``Tsne()`` at its defaults (perplexity 30,
   1000 iterations) on the word vectors, the tiled path: ms an iteration,
   peak memory below an (N, N) float32 matrix, KL falling from iteration
   0, the share of each point's 10 nearest neighbours kept at least
   ``CL_PRESERVED_X`` times chance, the coordinates published through the
   port's ``UIServer.set_tsne_data`` and read back from ``GET
   /tsne/data`` over HTTP, and 10 iterations card vs CPU from the same
   draws within ``CL_RTOL``; (d) the exact path at N = 4,096 MNIST rows:
   the same readings, the share of each point's 10 nearest in the
   embedding sharing its label at least ``CL_PURITY`` of that share in
   the standardised input; (e) a VP tree and
   a KD tree over the word vectors, every query held to brute force.
   Launches no flash kernel.
23. the streaming tier ([streaming] lines; 22 and 23 on a
   ``{"clustering": ..., "streaming": ...}`` JSON line): (a) a
   ``StreamBroker`` on localhost, 8,192 procedural-MNIST records (784
   features and a label, as CSV) produced to a topic of 4 partitions;
   (b) LeNet-5 (config #1) behind ``StreamingPipeline(mode="both",
   batch_size=64)`` over a ``BrokerRecordSource``: records a second,
   ``streaming_batch_ms`` p50/p99, the idle share of one profiled
   micro-batch, every micro-batch's predictions bitwise ``net.output`` on
   its padded rows and the trained params bitwise a plain ``fit`` of the
   same micro-batches (deterministic algorithms), the group's offsets at
   the end offsets; (c) at-least-once: a consumer crashes (no commit, no
   leave) mid-stream, a new one in the same group takes over after the
   session timeout, every offset processed at least once and the
   committed offsets at the end offsets; every thread the phase started
   joined.  Launches no flash kernel.
24. the native tier ([native] lines, a ``{"native": ...}`` JSON line):
   (a) ``examples/native_inference.py`` in the port: the 16-32-4 MLP, 5
   fit steps, batches 8, 8, 3 through ``NativeModelRunner`` (2 entries,
   answers equal to ``output()``); (b) LeNet-5 (batch 1, 8, 64, 256) and
   ResNet-50 (1, 32, 128 at 224x224) at full width through the runner,
   one captured CUDA graph a shape over the paged weight arena: ms of
   ``runner.output`` (host clock, numpy out) beside the eager
   ``output()`` with its host copy and the ``aot`` engine's ``predict``,
   captures, the graph pool's and the arena's bytes, the idle share of
   one profiled ``runner.output``, every answer bitwise the eager one
   (else within ``NT_FP32_RTOL``/``NT_BF16_RTOL``); (c) a LeNet-5 runner
   at ``max_shapes=4`` over 6 batch sizes twice: 8 evictions, at most 4
   entries, the pool bounded; (d) LeNet-5 and ResNet-50 behind
   ``backend="native"`` engines in a ``ModelRegistry`` that holds one:
   a page-out frees at least the arena's bytes (``mem_get_info``), the
   answers after each page-in bitwise those before, no capture and no
   leaf view's ``data_ptr()`` moved, page-in ms; (e) 60,000 MNIST rows
   as IDX files, the native decode bitwise numpy's; LeNet-5 one epoch at
   batch 256 from ``AsyncDataSetIterator`` on the native ring and on the
   Python thread (samples/s, idle share), the ring's batches bitwise a
   plain replay of its xorshift order and its params bitwise a plain
   ``fit`` over them (deterministic algorithms); (f) LeNet-5 through the
   Java DL4J zip and back, params bitwise; ``load_model_guess`` on a
   serializer zip served by the runner with (b)'s answer.  Launches no
   flash kernel.
25. the last modules ([ui_cloud] lines, a ``{"ui_cloud": ...}`` JSON
   line): (a) phase 24's LeNet-5 epoch (234 batches of 256 rows) as
   ``.npz`` files uploaded to a ``file://`` bucket through
   ``LocalFilesystemStorage``, one epoch of LeNet-5 (mixed_bf16) from
   ``RemoteDataSetIterator``: samples/s, the cache's download ms, params
   bitwise a plain ``fit`` over a ``ListDataSetIterator`` of the same
   batches (both ``ingest="batch"``, deterministic cuDNN), the idle share
   of 20 profiled batches; (b) on that fit ``HistogramIterationListener
   (frequency=25)`` and ``ConvolutionalIterationListener`` over an
   8-image probe: the last histograms equal ``np.histogram`` of
   ``param_table()`` at that firing, every PNG decodes to
   ``activation_grid`` of a separate eager ``feed_forward``, host ms a
   firing beside the step's ms; (c) ``ui.main.serve`` over a sqlite
   file, ``post_system_metrics`` of the trained net read back over HTTP,
   the listeners' components through ``render_page``, the server
   stopped; (d) under ``DL4J_TPU_LOCK_DEBUG=1`` and ``DL4J_TPU_SANITIZE=1``
   (set before the objects are built): an epoch-cache fit of LeNet-5 on
   60,000 rows (a warm-up epoch, ``sanitize_end_warmup()``, then 2 epochs,
   each one group and its tail) and an ``InferenceEngine`` session of
   phase 8's attention net decoding 1,030 single tokens across the
   1024 -> 2048 hop after ``warmup_decode``: 0 violations, each
   scenario's dispatches equal to its ceilings, lock-graph edges and no
   cycle; (e) a ``KerasBridgeServer`` on the card with (a)'s net
   registered: ``predict`` of 256 rows over TCP bitwise ``output()``,
   ``save`` over the wire restoring the params bytewise, a round trip's
   ms beside ``output()``'s, whether ``h5py`` imports (without it
   ``import_model`` must answer an error naming it); (f) a 1-host
   ``TpuPodProvisioner`` cluster whose command is the port's pod worker
   (8 steps, data 2) on a free coordinator port, ``launch_host0.sh`` run
   as a child: exit 0 and params bitwise the pod launcher's 1-rank pod of
   the same seed.  Launches no flash kernel.

Prints a JSON line of the reference, training, inference, ring, serving,
feed-forward/convolutional, recurrent, harness, graph, fused, transfer,
embeddings and deepwalk results, a ``{"pretrain": ...}`` JSON line, a
``{"serving_v2": ..., "deploy": ...}`` JSON line, a ``{"fleet": ...}``
JSON line, a ``{"parallel": ...}`` JSON line, a ``{"scaleout": ...}``
JSON line, a ``{"clustering": ..., "streaming": ...}`` JSON line, a
``{"native": ...}`` JSON line, a ``{"ui_cloud": ...}`` JSON line, one
``{"kernels":
[...]}`` JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
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
# Phase 16.  DeepWalk at bench.py:717's configuration (bench_deepwalk):
# 20,000 vertices, 200,000 random endpoint pairs from RandomState(0)
# (self-pairs dropped), walk length 40, window 2, dim 128, seed 7, batch
# 2,048 (the 2x-vertices clamp keeps it), walks on the device: one warm-up
# epoch, then DW_TRIALS timed fits of DW_EPOCHS epochs (bench.py's
# epochs_per_window and trials), one profiled epoch.  Card against CPU on
# a two-community graph of DW_SMALL vertices, walk length DW_SMALL_WALK,
# the same draws (host_walk_draws): walks and pair grid bitwise, tables
# within EMB_REF_RTOL of max|CPU| (phase 15's argument: atomic index_add_
# order, cuBLAS einsums), bitwise twice under deterministic algorithms.
# The readers: the procedural CIFAR-10 (DW_CIFAR images, batch
# DW_CIFAR_BATCH) through the epoch cache on a small CNN, 2 epochs, the
# second profiled; the iris MLP from a CSV through
# RecordReaderDataSetIterator, DW_IRIS_EPOCHS epochs, fp32 params card vs
# CPU within DW_IRIS_RTOL of max|CPU| (f32 sums in another order).
DW_VERTICES, DW_EDGES, DW_WALK, DW_WINDOW, DW_DIM = 20000, 200_000, 40, 2, 128
DW_SEED, DW_BATCH, DW_EPOCHS, DW_TRIALS = 7, 2048, 2, 3
DW_SMALL, DW_SMALL_WALK = 300, 20
DW_CIFAR, DW_CIFAR_BATCH, DW_IRIS_EPOCHS, DW_IRIS_RTOL = 2560, 128, 5, 1e-5
# Phase 17.  The DL4J 0.7 examples' DeepAutoEncoderExample at full width
# (nine RBMs 784-1000-500-250-100-30-100-250-500-1000 with kl_divergence,
# an OutputLayer 1000 -> 784 with mse and sigmoid, seed 123, line gradient
# descent, pretrain and backprop, batch 1000 of MNIST binarised at 0.5),
# cut to DAE_BATCHES batches: fit pretrains each RBM one step a batch, then
# fine-tunes one line-search iteration a batch; a further held-out batch
# scores the reconstructions.  At lr 0.1 a deep RBM's mean-field
# reconstruction error first rises for a few CD-1 steps (RBM 7, 250 ->
# 500: 0.028 -> 0.060 after 5 batches in the first call on the card)
# before it falls, so the cut keeps 12 batches.  Its VariationalAutoEncoderExample (784 -> 2,
# encoder and decoder (256, 256), batch 128, pretrain only) over
# VAE_EPOCHS epochs of VAE_BATCHES batches; reconstruction_log_probability
# over VAE_LOGP_SAMPLES samples.  Center loss on LeNet-5 (BASELINE config
# #1, batch 256) over CL_EPOCHS epochs of CL_BATCHES batches, per batch
# and from the epoch cache.  Card vs CPU in fp32 at REF_RTOL (f32 sums in
# another order over the same draws).
DAE_WIDTHS = (784, 1000, 500, 250, 100, 30, 100, 250, 500, 1000)
DAE_BATCH, DAE_BATCHES = 1000, 12
VAE_BATCH, VAE_BATCHES, VAE_EPOCHS, VAE_LOGP_SAMPLES = 128, 40, 8, 16
CL_BATCH, CL_BATCHES, CL_EPOCHS = 256, 8, 3
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
    route), else all-f32, dq summed over K3's key tile; and the all-f32
    twin for the tensor-core route (None otherwise)."""
    q, g = args[0], args[3]
    tensor_core = q.dtype == g.dtype == torch.bfloat16
    block = A.bwd_key_tile(q.shape[-1], A.bwd_route(*args[:4]))
    twins = []
    for operands in ([torch.bfloat16, None] if tensor_core else [None]):
        twins.append((A.flash_dkdv_plain(*args, causal, scale,
                                         operand_dtype=operands),
                      A.flash_dq_plain(*args, causal, scale, block=block,
                                       operand_dtype=operands)))
    return twins[0], (twins[1] if tensor_core else None)


def key_tile(A, q, k, v) -> int:
    """Keys of a K/V tile of the K1/K4 body that these card tensors take:
    the ``block`` of the plain twin that rounds P as that body does (the
    running max, and so the rounding, depends on where tiles start)."""
    return A.fwd_key_tile(q.shape[-1], A.fwd_route(q, k, v))


def fwd_twins(A, q, k, v, causal: bool, scale: float, mode: str):
    """The plain K1/K4 results in ``mode`` that the kernel is held to: with
    P rounded to bf16 for bf16 q/k/v (the tensor-core route), else
    all-f32, over the kernel's key tile; and the all-f32 twin for the
    tensor-core route (None otherwise)."""
    tensor_core = q.dtype == torch.bfloat16
    block = key_tile(A, q, k, v)
    twins = [A.flash_forward_plain(q, k, v, causal, scale, mode, block=block,
                                   operand_dtype=operands)
             for operands in ([torch.bfloat16, None] if tensor_core
                              else [None])]
    return twins[0], (twins[1] if tensor_core else None)


def hopper_bodies(A, what: str) -> dict:
    """K1-K4's launches by body since the counts were last set to 0;
    raises unless every one of them took its Hopper body (``sm90``)."""
    bodies = {name: dict(counts) for name, counts in A.BODY_LAUNCHES.items()}
    for name, counts in bodies.items():
        if counts["sm90"] != A.LAUNCHES[name]:
            raise RuntimeError(f"{what}: {name} launches by body {counts} of "
                               f"{A.LAUNCHES[name]}: not all on the Hopper "
                               "body")
    return bodies


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
    check_bodies = {}
    for dtype in (torch.bfloat16, torch.float32):
        A.reset_launches()
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
        body = "sm90" if dtype == torch.bfloat16 else "scalar"
        check_bodies[dname] = {n: dict(c) for n, c in
                               A.BODY_LAUNCHES.items()}
        for name, counts in check_bodies[dname].items():
            if counts[body] != A.LAUNCHES[name]:
                raise RuntimeError(f"{name} with {dname} inputs: launches by "
                                   f"body {counts}, expected all {body}")

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
    timed_bodies = hopper_bodies(A, "phase 3's timed kernels")
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
    for name in timed_bodies:
        # the body the bf16 launches (checked and timed) took
        timing[name]["body"] = "sm90"
        timing[name]["body_launches"] = {"checks": {d: c[name] for d, c in
                                                    check_bodies.items()},
                                         "timed": timed_bodies[name]}
    for name, kind in (("flash_bwd_dkdv", "dkdv"), ("flash_bwd_dq", "dq")):
        timing[name]["segment_ms"] = t["segment_" + kind]
        timing[name]["segment_bound_ms"] = seg_bounds[name][0]
        timing[name]["ring_step_ms"] = t["ring_step_" + kind]
        timing[name]["ring_step_bound_ms"] = ring_bounds[name][0]
    log(f"[kernels] K1-K4 launches by body: checks {check_bodies}, timed "
        f"{timed_bodies}")
    log(f"[kernels] library yardsticks: sdpa fwd causal {lib_fwd:.4f} ms, "
        f"non-causal {lib_fwd_full:.4f} ms, sdpa bwd causal (dq, dk, dv "
        f"together) {lib_bwd:.4f} ms")
    return timing


# The updater's fused Adam (phase 3, after K1-K4): at the leaf of the LFM2
# cell that sets its time, one of an MoE layer's three expert weights (32
# experts x 2048 x 1792, bf16 with an fp32 master), then a size whose tail
# the scalar loop takes and a view off 16 bytes (the scalar path); each in
# both forms, alpha a host float and the f64 entry of a device table, held
# bit for bit against the torch ops it replaces (compute_update's Adam and
# the master write) on the same inputs.  Bound by bytes: 28 a value.
ADAM_DEV = "cuda"
ADAM_N = 32 * 2048 * 1792
ADAM_TAIL_N = 2 ** 22 + 3
ADAM_BYTES_PER_VALUE = 28


def adam_leaf(n: int, gen, off16: bool):
    """A bf16 param of ``n`` values, its fp32 master and Adam moments (m
    and v from an earlier step's size), and a bf16 gradient; with
    ``off16`` each a view one element into its buffer."""
    def place(t):
        if not off16:
            return t
        buf = torch.empty(n + 1, dtype=t.dtype, device=t.device)
        buf[1:].copy_(t)
        return buf[1:]
    w = torch.randn(n, generator=gen, device=ADAM_DEV)
    m = torch.randn(n, generator=gen, device=ADAM_DEV) * 1e-2
    v = torch.rand(n, generator=gen, device=ADAM_DEV) * 1e-4
    g = (torch.randn(n, generator=gen, device=ADAM_DEV) * 1e-2).to(
        torch.bfloat16)
    return tuple(place(t) for t in (g, w, m, v, w.to(torch.bfloat16)))


def adam_plain(U, conf, g, w, m, v, p_dtype, alpha):
    """The torch ops the kernel replaces: ``(w', m', v', param')``."""
    u, new = U.compute_update(conf, {"x": g.float()},
                              {"m": {"x": m}, "v": {"x": v}}, 0,
                              params={"x": w}, scalars={"alpha": alpha})
    w1 = w - u["x"]
    return w1, new["m"]["x"], new["v"]["x"], w1.to(p_dtype)


def phase_adam(seed: int) -> dict:
    """``adam_master_step_kernel`` against the torch ops, bit for bit, at
    the LM's expert leaf, a tail and a view off 16 bytes, in both forms
    with a host and a device alpha; then timed in place with the device
    alpha (the captured step's call) against the ops and the byte
    bound."""
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.ops import adam
    conf = U.UpdaterConfig(updater="adam", learning_rate=1e-3,
                           adam_mean_decay=0.9, adam_var_decay=0.999)
    sc = adam.scalars(conf.adam_mean_decay, conf.adam_var_decay, U._EPS_ADAM)
    host = U.step_scalars(conf, 4)["alpha"]
    dev = torch.tensor(host, dtype=torch.float64, device=ADAM_DEV)
    gen = torch.Generator(device=ADAM_DEV).manual_seed(seed)
    adam.reset_launches()
    checks = []
    for n, off16 in ((ADAM_N, False), (ADAM_TAIL_N, False),
                     (ADAM_TAIL_N, True)):
        g, w, m, v, p = adam_leaf(n, gen, off16)
        with torch.no_grad():
            want = adam_plain(U, conf, g, w, m, v, p.dtype, host)
            for in_place in (False, True):
                for alpha in (host, dev):
                    ins = [t.clone() if in_place else t for t in (w, m, v, p)]
                    got = adam.master_step(g, *ins, alpha, sc, in_place)
                    if in_place and not all(a is b for a, b in
                                            zip(got, ins)):
                        raise RuntimeError("adam_master_step in place "
                                           "returned other tensors")
                    bad = [name for name, a, b in zip(
                        ("master", "m", "v", "param"), got, want)
                        if not (a.dtype == b.dtype and torch.equal(a, b))]
                    what = (f"adam_master_step n={n}"
                            f"{' off16' if off16 else ''} "
                            f"{'in_place' if in_place else 'out_of_place'} "
                            f"alpha {'device' if alpha is dev else 'host'}")
                    log(f"[check] {what}: "
                        f"{'bitwise' if not bad else 'differs in ' + str(bad)}")
                    if bad:
                        raise RuntimeError(f"{what}: not bitwise the torch "
                                           f"ops ({bad})")
                    checks.append(what)
        del g, w, m, v, p, want, ins, got
    launches = adam.LAUNCHES["adam_master_step"]
    if launches != len(checks):
        raise RuntimeError(f"adam_master_step launched {launches} times for "
                           f"{len(checks)} checks")
    g, w, m, v, p = adam_leaf(ADAM_N, gen, False)
    with torch.no_grad():
        ms = time_ms(lambda: adam.master_step(g, w, m, v, p, dev, sc, True))
        plain_ms = time_ms(lambda: adam_plain(U, conf, g, w, m, v, p.dtype,
                                              host))
    bound = ADAM_N * ADAM_BYTES_PER_VALUE / PEAK_BYTES * 1e3
    result = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": "bytes",
              "tb_per_s": ADAM_N * ADAM_BYTES_PER_VALUE / ms / 1e9,
              "values": ADAM_N, "checks": checks, "check_launches": launches}
    log(f"[adam] adam_master_step at {ADAM_N} bf16 values, in place, "
        f"device alpha: {ms:.4f} ms ({result['tb_per_s']:.3f} TB/s), the "
        f"torch ops {plain_ms:.4f} ms, bound {bound:.4f} ms by bytes; "
        f"{len(checks)} checks bitwise")
    return result


def adam_leaves(U, net) -> int:
    """The leaves of ``net`` its updater steps (frozen layers and direct
    updates left out)."""
    return sum(len(U.updatable_params(layer, net.params[key]))
               for key, layer in net._slots()
               if not getattr(layer, "frozen", False))


def fused_leaves_counted() -> dict:
    from deeplearning4j_tpu_torch.monitor import metrics
    from deeplearning4j_tpu_torch.nn import updaters as U
    c = metrics.registry().counter(U.LEAVES_COUNTER)
    return {(path, form): c.value(rule="adam", path=path, form=form)
            for path in ("fused", "ops")
            for form in ("in_place", "out_of_place")}


def check_adam_launches(what: str, net, steps: int, counted: dict) -> int:
    """The fused Adam launched once an Adam leaf a step, each leaf counted
    fused and out of place (eager steps); returns the launches."""
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.ops import adam
    leaves = adam_leaves(U, net)
    launches = adam.LAUNCHES["adam_master_step"]
    now = fused_leaves_counted()
    delta = {k: now[k] - counted[k] for k in now if now[k] != counted[k]}
    want = {("fused", "out_of_place"): steps * leaves}
    log(f"[{what}] adam_master_step launches {launches} for {leaves} Adam "
        f"leaves x {steps} steps; updater_leaves_total rose by {delta}")
    if launches != steps * leaves or delta != want:
        raise RuntimeError(f"{what}: adam_master_step launched {launches} "
                           f"times, counted {delta}; expected one an Adam "
                           f"leaf a step ({steps} x {leaves}), all fused")
    return launches


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
    from deeplearning4j_tpu_torch.ops import adam
    A.reset_launches()
    worst = 0.0
    for step in range(2):
        adam.reset_launches()
        counted = fused_leaves_counted()
        card.fit(ds)
        adam_launches = check_adam_launches("reference", card, 1, counted)
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
    return {"steps": 2, "max_rel": worst,
            "adam_launches": 2 * adam_launches}


# profiler kernel names: the Hopper bodies on every bf16 call of the main
# paths (K1 and K4 share flash_fwd_sm90_kernel), else the mma.sync or
# scalar bodies' kernels
PORT_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                "flash_bwd_dq_sm90_kernel", "flash_fwd_kernel",
                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


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
    from deeplearning4j_tpu_torch.ops import adam
    A.reset_launches()            # counts of the main path's run only
    adam.reset_launches()
    counted = fused_leaves_counted()
    scores, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        s = net.score()           # a host read: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        scores.append(s)
    launches = dict(A.LAUNCHES)
    adam_launches = check_adam_launches("training", net, STEPS, counted)
    bodies = hopper_bodies(A, "training")
    peak = torch.cuda.max_memory_allocated()
    log(f"[training] scores {scores}; step ms {step_ms}; launches "
        f"{launches}, by body {bodies}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"non-finite training score: {scores}")
    expected = {name: STEPS for name in KERNELS}
    expected["flash_fwd_partials"] = 0         # the ring's kernel only
    if launches != expected:
        raise RuntimeError(f"launches in {STEPS} steps: {launches}, "
                           f"expected {expected}")
    return net, ds, {"scores": scores, "step_ms": step_ms,
                     "peak_mem_bytes": peak, "launches": launches,
                     "adam_launches": adam_launches,
                     "body_launches": bodies,
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
    rounds P to bf16 (over K4's key tile), merged by the ring's own
    ``_merge`` in the ring's
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
                                         block=key_tile(A, qs[i], ks[j],
                                                        vs[j]),
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
        bodies = (hopper_bodies(A, "the bf16 ring")
                  if dtype == torch.bfloat16 else
                  {n: dict(c) for n, c in A.BODY_LAUNCHES.items()})
        log(f"[ring] {dname} causal fwd+bwd launches {launches}, by body "
            f"{bodies}")
        if launches != expected:
            raise RuntimeError(f"ring launches {launches}, expected "
                               f"{expected}")
        result["launches"] = launches
        result.setdefault("body_launches", {})[dname] = bodies
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
    bodies = hopper_bodies(A, "the attention graph")
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
                 "body_launches": bodies, "params_vs_twin": check}


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
    counts (K4 shares K1's kernel names; the capturing fit's wrapper
    counts show it is not in the graph, and its body counts that K1-K3
    took their Hopper bodies, as the profiler's names show for the
    replays)."""
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
    capturing_bodies = hopper_bodies(A, "the capturing fit")
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
    launches = {"flash_fwd_partials": 0}
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        launches[name] = seen[name + "_sm90_kernel"] + seen[name + "_kernel"]
    # K1-K3 on the Hopper bodies in every replay, the others never
    replayed = {k: ATTN_CACHE_STEPS if "sm90" in k else 0
                for k in PORT_KERNELS}
    log(f"[fused] attention cache path: wrapper counts of the capturing "
        f"fit {capturing}; one more epoch of replays: wrapper counts "
        f"{wrappers}, profiler kernels {seen}")
    if capturing["flash_fwd_partials"] or not all(
            capturing[k] for k in ("flash_fwd", "flash_bwd_dkdv",
                                   "flash_bwd_dq")):
        raise RuntimeError(f"the capturing fit's launches {capturing}")
    if any(wrappers.values()) or seen != replayed:
        raise RuntimeError(f"K1-K3 did not run inside the graph's replays "
                           f"on the expected bodies: profiler {seen} "
                           f"(expected {replayed}), wrappers {wrappers}")
    return {"max_abs_diff": err, "launches": launches,
            "capturing_fit_wrapper_counts": capturing,
            "capturing_fit_body_launches": capturing_bodies,
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
        bodies = hopper_bodies(A, f"fit_scan, {name}")
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
                     "launches": launches, "body_launches": bodies}
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
    from deeplearning4j_tpu_torch.datasets.dataset import wire_of
    MNIST_KEPT["u8"] = wire_of(train._ds)[0]       # phase 24's rows
    MNIST_KEPT["labels"] = train._ds.labels
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
            rtol: float = EMB_REF_RTOL, tag: str = "embeddings") -> float:
    """max|got - want| / max|want| of two tables (any devices); raises
    above ``rtol`` or on a non-finite value."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{what}: non-finite values")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    rel = err / scale
    log(f"[{tag}] {what}: max|diff| {err:.3e}, {rel:.3e} of "
        f"max|ref| {scale:.3e} (tol {rtol:g})")
    if not rel <= rtol:
        raise RuntimeError(f"{what}: {rel:.3e} of max|ref| > {rtol:g}")
    return rel


class env_set:
    """Environment variable ``name`` set to ``value`` inside the block."""

    def __init__(self, name: str, value: str):
        self.name, self.value, self.prev = name, value, None

    def __enter__(self):
        self.prev = os.environ.get(self.name)
        os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.prev is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.prev


def scatter_agg(on: bool) -> env_set:
    """``DL4J_TPU_SCATTER_AGG`` set to ``on`` inside the block."""
    return env_set("DL4J_TPU_SCATTER_AGG", "1" if on else "0")


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
    EMB_KEPT["vectors"] = sv.lookup_table.syn0.detach().float().cpu().numpy()
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


# ------------------------------------------------------------- phase 16
def dw_bench_graph():
    """bench.py:728-734: DW_EDGES random endpoint pairs over DW_VERTICES
    from RandomState(0), self-pairs dropped, undirected, weight 1."""
    from deeplearning4j_tpu_torch.graph import Graph
    rng = np.random.RandomState(0)
    g = Graph(DW_VERTICES)
    a = rng.randint(0, DW_VERTICES, DW_EDGES)
    b = rng.randint(0, DW_VERTICES, DW_EDGES)
    for i in range(DW_EDGES):
        if a[i] != b[i]:
            g.add_edge(int(a[i]), int(b[i]), 1.0, False)
    g.csr()
    return g


def dw_full() -> dict:
    """(a) bench_deepwalk's configuration on the card."""
    from deeplearning4j_tpu_torch.graph import DeepWalk
    t0 = time.perf_counter()
    g = dw_bench_graph()
    build_s = time.perf_counter() - t0
    dw = (DeepWalk.Builder().vector_size(DW_DIM).window_size(DW_WINDOW)
          .seed(DW_SEED).batch_size(DW_BATCH).build())
    if dw.device.type != "cuda":
        raise RuntimeError(f"DeepWalk defaults to {dw.device}")
    t0 = time.perf_counter()
    dw.initialize(g)
    init_s = time.perf_counter() - t0
    L = DW_WALK + 1
    pairs = DW_VERTICES * (L - 2 * DW_WINDOW) * 2 * DW_WINDOW
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dw.fit(g, walk_length=DW_WALK, epochs=1)       # warm-up
    warm_s = time.perf_counter() - t0
    first_loss = dw._cum_loss / pairs
    stats = dict(dw._walk_stats)
    if stats != {"route": "device", "batch": DW_BATCH, "pairs": pairs,
                 "chunks": -(-pairs // DW_BATCH)}:
        raise RuntimeError(f"the epoch ran as {stats}")
    secs = []
    for _ in range(DW_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dw.fit(g, walk_length=DW_WALK, epochs=DW_EPOCHS)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    before = dw._cum_loss
    wall_ms, events, by_name, busy_ms = profiled(
        lambda: dw.fit(g, walk_length=DW_WALK, epochs=1))
    last_loss = (dw._cum_loss - before) / pairs
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(secs))
    rate = DW_EPOCHS * pairs / med
    spread = (max(secs) - min(secs)) / med
    # bench.py:751-755's hand bytes model of an epoch
    avg_len = float(dw._cmask_dev.sum(dim=1).mean().item())
    hand_bytes = (pairs * (2 * DW_DIM * 4 + 2 * avg_len * DW_DIM * 4 + 8)
                  + DW_VERTICES * DW_WALK * 3 * 4)
    bound_ms = hand_bytes / PEAK_BYTES * 1e3
    bound_rate = pairs / (bound_ms / 1e3)
    chunks = stats["chunks"]
    s0 = dw.syn0
    if not (torch.isfinite(s0).all() and torch.isfinite(dw.syn1).all()):
        raise RuntimeError("DeepWalk's tables are not finite")
    result = {
        "vertices": DW_VERTICES, "edges": g.num_edges(),
        "csr_entries": int(g.csr()[1].size), "pairs_per_epoch": pairs,
        "chunks_per_epoch": chunks, "graph_build_s": build_s,
        "initialize_s": init_s, "warmup_epoch_s": warm_s, "fit_s": secs,
        "epochs_per_fit": DW_EPOCHS, "pairs_per_s": rate,
        "spread": spread, "mean_code_length": avg_len,
        "bytes_per_epoch": hand_bytes, "epoch_bound_ms": bound_ms,
        "bound_by": "bytes", "bound_share": rate / bound_rate,
        "profiled_epoch_ms": wall_ms, "device_events": events,
        "device_events_per_chunk": events / chunks,
        "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "top5": top_kernels(by_name), "peak_mem_bytes": peak,
        "loss_per_pair_first": first_loss, "loss_per_pair_last": last_loss}
    log(f"[deepwalk] bench_deepwalk: {DW_VERTICES} vertices, "
        f"{g.num_edges()} edges ({result['csr_entries']} CSR entries) built "
        f"on the host in {build_s:.2f} s, initialize {init_s:.2f} s; "
        f"{pairs} pairs an epoch in {chunks} chunks of {DW_BATCH}; warm-up "
        f"epoch {warm_s:.2f} s; fits of {DW_EPOCHS} epochs {secs} s: "
        f"{rate:.1f} pairs/s (median, spread {spread:.3f}); bytes bound "
        f"{bound_ms:.3f} ms an epoch at mean code length {avg_len:.2f} "
        f"({bound_rate:.1f} pairs/s; share {rate / bound_rate:.4f}); "
        f"profiled epoch {wall_ms:.1f} ms, {events} device events "
        f"({events / chunks:.1f} a chunk), busy {busy_ms:.1f} ms, idle "
        f"{1.0 - busy_ms / wall_ms:.3f}; peak {peak / 2**30:.3f} GiB; loss "
        f"a pair {first_loss:.4f} -> {last_loss:.4f}; top 5: " + "; ".join(
            f"{d['name'][:60]} {d['ms']:.2f}" for d in result["top5"]))
    if not (np.isfinite(last_loss) and last_loss < first_loss):
        raise RuntimeError(f"DeepWalk's loss did not fall: {first_loss} -> "
                           f"{last_loss}")
    return result


def dw_two_communities(size: int = DW_SMALL // 2, intra: int = 1500,
                       cross: int = 20, seed: int = 0):
    """Two random communities of ``size`` vertices joined by ``cross``
    edges (tests/test_torch_kernels_gpu.py's graph)."""
    from deeplearning4j_tpu_torch.graph import Graph
    rng = np.random.RandomState(seed)
    g = Graph(2 * size)
    for c in (0, size):
        a = rng.randint(0, size, intra) + c
        b = rng.randint(0, size, intra) + c
        for i, j in zip(a, b):
            if i != j:
                g.add_edge(int(i), int(j))
    for i, j in zip(rng.randint(0, size, cross),
                    rng.randint(size, 2 * size, cross)):
        g.add_edge(int(i), int(j))
    return g


def dw_small_epoch(device, route: str) -> tuple:
    """One epoch of the two-community graph on ``device`` by ``route``
    (device or host walks) from the same tables and draws."""
    from deeplearning4j_tpu_torch.graph.deepwalk import (DeepWalk,
                                                         host_walk_draws)
    g = dw_two_communities()
    dw = DeepWalk(vector_size=32, window_size=2, learning_rate=0.05, seed=7,
                  batch_size=512, device=device)
    dw.initialize(g)
    dw.draw_source = host_walk_draws(11)
    with env_set("DL4J_TPU_DEVICE_WALKS", "1" if route == "device" else "0"):
        dw.fit(g, walk_length=DW_SMALL_WALK, epochs=1)
    if dw._walk_stats["route"] != route:
        raise RuntimeError(f"the {route}-walk epoch ran {dw._walk_stats}")
    return {"syn0": dw.syn0.cpu(), "syn1": dw.syn1.cpu()}, dw._cum_loss


def dw_card_vs_cpu() -> dict:
    """(b) walks and pair grid bitwise, then each route's epoch card vs
    CPU and bitwise twice under deterministic algorithms."""
    from deeplearning4j_tpu_torch.graph.deepwalk import (device_walks,
                                                         host_walk_draws,
                                                         walk_pair_grid)
    g = dw_two_communities()
    indptr, indices, _ = g.csr()
    starts, u = host_walk_draws(11)(g.num_vertices(), DW_SMALL_WALK, 0)
    grids = {}
    for dev in ("cpu", "cuda"):
        walks = device_walks(
            torch.from_numpy(indptr.astype(np.int32)).to(dev),
            torch.from_numpy(indices.astype(np.int32)).to(dev),
            starts.to(dev), u.to(dev))
        grids[dev] = [walks.cpu()] + [t.cpu() for t in
                                       walk_pair_grid(walks, 2, 512)]
    walks_equal = all(torch.equal(a, b)
                      for a, b in zip(grids["cpu"], grids["cuda"]))
    log(f"[deepwalk] {g.num_vertices()} vertices, {g.num_edges()} edges: "
        f"walks {tuple(grids['cpu'][0].shape)} and pair grid "
        f"{tuple(grids['cpu'][1].shape)} card vs CPU bitwise equal: "
        f"{walks_equal}")
    if not walks_equal:
        raise RuntimeError("the device walks differ between card and CPU")
    result = {"walks_bitwise": walks_equal}
    for route in ("device", "host"):
        card, card_loss = dw_small_epoch(None, route)
        cpu, cpu_loss = dw_small_epoch("cpu", route)
        rel = {n: emb_rel(f"{route}-walk epoch card vs CPU {n}", card[n],
                          cpu[n], tag="deepwalk") for n in cpu}
        rel["loss"] = abs(card_loss - cpu_loss) / abs(cpu_loss)
        with deterministic():
            a, _ = dw_small_epoch(None, route)
            b, _ = dw_small_epoch(None, route)
        same = all(torch.equal(a[n], b[n]) for n in a)
        log(f"[deepwalk] {route}-walk epoch: loss card {card_loss:.3f}, "
            f"CPU {cpu_loss:.3f} (rel {rel['loss']:.2e}); two deterministic "
            f"epochs on the card bitwise equal: {same}")
        if not same or rel["loss"] > EMB_REF_RTOL:
            raise RuntimeError(f"the {route}-walk epoch disagrees")
        result[route] = {"rel": rel, "deterministic_bitwise": same}
    return result


def dw_learns() -> dict:
    """(c) tests/test_graph.py's two cliques of 10 joined by one bridge,
    the Builder of its test_fit_learns_communities, on the card."""
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    g = Graph(20)
    for start in (0, 10):
        for i in range(start, start + 10):
            for j in range(i + 1, start + 10):
                g.add_edge(i, j)
    g.add_edge(0, 10)
    dw = (DeepWalk.Builder().vector_size(16).window_size(2)
          .learning_rate(0.05).seed(12345).build())
    dw.initialize(g)
    dw.fit(g, walk_length=10, epochs=12)
    inside = float(np.mean([dw.similarity(i, j) for i in (2, 3, 13, 14)
                            for j in range(20) if j != i
                            and (j < 10) == (i < 10)]))
    across = float(np.mean([dw.similarity(i, j) for i in (2, 3, 13, 14)
                            for j in range(20) if (j < 10) != (i < 10)]))
    hits = sum(1 for probe in (2, 3, 13, 14)
               for v in dw.vertices_nearest(probe, 5)
               if (int(v) < 10) == (probe < 10))
    log(f"[deepwalk] two cliques on {dw.syn0.device}: mean similarity "
        f"in-community {inside:.4f}, cross {across:.4f}; {hits} of 20 "
        f"nearest neighbours in-community")
    if dw.syn0.device.type != "cuda" or not inside > across:
        raise RuntimeError("DeepWalk did not separate the communities")
    return {"in_community": inside, "cross_community": across,
            "nearest_in_community": hits}


def small_cnn(N):
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (N.NeuralNetConfiguration.builder().seed(3).updater("adam")
            .learning_rate(1e-3).weight_init("xavier").list()
            .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                    activation="relu"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=64, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(inputs.convolutional(32, 32, 3)).build())
    return MultiLayerNetwork(conf).init()


def dw_readers(N) -> dict:
    """(d) the readers feed the card."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.cifar import CifarDataSetIterator
    from deeplearning4j_tpu_torch.datasets.iris import iris_dataset
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.nlp.lang import JapaneseTokenizerFactory
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        with env_set("CIFAR_DIR", tmp):
            t0 = time.perf_counter()
            cifar = CifarDataSetIterator(DW_CIFAR_BATCH, DW_CIFAR)
            gen_s = time.perf_counter() - t0
        net = small_cnn(N)
        clock = EpochClock(profiled=1)
        net.set_listeners(clock)
        net.fit(cifar, epochs=2)
        device, busy_ms, htod = device_split(clock.prof)
        score = net.score()
        staged = staged_bytes("cache")
        want = DW_CIFAR * 32 * 32 * 3 + DW_CIFAR * 10 * 4
        wall_ms = clock.seconds[1] * 1e3
        log(f"[deepwalk] CIFAR-10 (procedural, {DW_CIFAR} images in "
            f"{gen_s:.2f} s) through the epoch cache on a small CNN: staged "
            f"{staged:.0f} bytes (u8 wire + f32 labels: {want}); epochs "
            f"{clock.seconds} s; epoch 2: {len(device)} device events, busy "
            f"{busy_ms:.2f} of {wall_ms:.2f} ms, {htod} host-to-device "
            f"copies; score {score:.4f}; {len(net._graphs)} captured step(s)")
        if staged != want or htod or not np.isfinite(score) \
                or not net._graphs:
            raise RuntimeError("CIFAR-10 did not train from the epoch cache")
        result["cifar"] = {"generate_s": gen_s, "epoch_s": clock.seconds,
                           "staged_bytes": staged, "epoch2_htod": htod,
                           "epoch2_idle_share": 1.0 - busy_ms / wall_ms,
                           "score": score}
        iris = iris_dataset()
        path = os.path.join(tmp, "iris.csv")
        with open(path, "w") as f:
            f.write("sepal_l,sepal_w,petal_l,petal_w,class\n")
            for x, y in zip(iris.features, iris.labels):
                f.write(",".join(repr(float(v)) for v in x)
                        + f",{int(np.argmax(y))}\n")
        card = iris_mlp(N, "stochastic_gradient_descent", "cuda")
        cpu = iris_mlp(N, "stochastic_gradient_descent", "cpu")
        p0 = card.get_flat_params()
        cpu.set_flat_params(p0)
        for net in (card, cpu):
            reader = CSVRecordReader(skip_num_lines=1).initialize(path)
            net.fit(RecordReaderDataSetIterator(reader, 50, label_index=4,
                                                num_possible_labels=3),
                    epochs=DW_IRIS_EPOCHS)
        got, want_p = card.get_flat_params(), cpu.get_flat_params()
        rel = float(np.abs(got - want_p).max() / np.abs(want_p).max())
        moved = float(np.abs(got - p0).max())
        log(f"[deepwalk] iris MLP from a CSV through "
            f"RecordReaderDataSetIterator, {DW_IRIS_EPOCHS} epochs: params "
            f"card vs CPU rel={rel:.2e} (tol {DW_IRIS_RTOL:g}), moved "
            f"{moved:.3e} from the init")
        if not (rel <= DW_IRIS_RTOL and moved > 0):
            raise RuntimeError("the iris MLP disagrees between card and CPU")
        result["iris_csv"] = {"params_rel": rel, "moved": moved}
    rng = np.random.RandomState(0)
    animals, foods = ["犬", "猫", "馬"], ["寿司", "ラーメン", "パン"]
    sentences = ["すもももももももものうち", "わたしはにほんごをべんきょうします",
                 "ここではきものをぬいでください", "東京大学で日本語を勉強しています",
                 "コンピュータを使って仕事をします", "今日は、いい天気です。"]
    for _ in range(120):
        group = animals if rng.rand() < 0.5 else foods
        sentences.append("と".join(rng.choice(group, 4)) + "です")
    card, cpu = (Word2Vec(tokenizer_factory=JapaneseTokenizerFactory(),
                          layer_size=12, window_size=3, min_word_frequency=1,
                          negative=5.0, use_hierarchic_softmax=False,
                          batch_size=128, seed=5, learning_rate=0.05,
                          device=dev) for dev in (None, "cpu"))
    card.fit(sentences)
    cpu.fit(sentences)
    vocab = [w.word for w in card.vocab.vocab_words()]
    same = vocab == [w.word for w in cpu.vocab.vocab_words()]
    sims = (card.similarity("犬", "猫"), card.similarity("犬", "寿司"))
    log(f"[deepwalk] Word2Vec with JapaneseTokenizerFactory on "
        f"{card.device}: {len(vocab)} words, the same vocab as on the CPU: "
        f"{same}; similarity of two animals {sims[0]:.4f}, of an animal and "
        f"a food {sims[1]:.4f}")
    if not (same and card.device.type == "cuda"
            and torch.isfinite(card.lookup_table.syn0).all()):
        raise RuntimeError("the Japanese Word2Vec differs from the CPU's")
    result["japanese_word2vec"] = {"vocab": len(vocab), "same_vocab": same,
                                   "similarities": sims}
    return result


def phase_deepwalk(A, N=None) -> dict:
    """Phase 16: DeepWalk at bench_deepwalk's full width, the card against
    the CPU, the readers and the language tools (the ``deepwalk`` path of
    the kernels line: it launches none of K1-K4)."""
    if N is None:
        from deeplearning4j_tpu_torch.nn.conf import \
            neural_net_configuration as N
    torch.cuda.synchronize()
    A.reset_launches()            # counts of the main path's run only
    result, seconds = {}, {}
    for name, part in (("full", dw_full), ("card_vs_cpu", dw_card_vs_cpu),
                       ("learns", dw_learns),
                       ("readers", lambda: dw_readers(N))):
        t0 = time.perf_counter()
        result[name] = part()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    result["seconds"] = seconds
    log(f"[deepwalk] seconds by part {seconds}")
    result["launches"] = dict(A.LAUNCHES)
    log(f"[deepwalk] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the deepwalk path launched a flash kernel")
    return result


# ------------------------------------------------------------ phase 17
def pre_mnist() -> dict:
    """The procedural MNIST images of phase 17, generated once: the deep
    autoencoder's batches and held-out batch and the VAE's, binarised at
    0.5, and LeNet's first CL_BATCHES batches as the iterator gives them
    (the u8 wire attached)."""
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    t0 = time.perf_counter()
    n = (DAE_BATCHES + 1) * DAE_BATCH
    it = MnistDataSetIterator(DAE_BATCH, n, shuffle=False)
    x = (it._ds.features >= 0.5).astype(np.float32)
    lenet = MnistDataSetIterator(CL_BATCH, CL_BATCH * CL_BATCHES,
                                 shuffle=False)
    seconds = time.perf_counter() - t0
    log(f"[pretrain] {n} + {CL_BATCH * CL_BATCHES} procedural MNIST images "
        f"in {seconds:.2f} s")
    return {"binary": x, "lenet": lenet, "seconds": seconds}


class StepClock:
    """A listener: the score each iteration left (a host read) and its
    synchronized wall ms, from the end of the one before (or ``start()``)
    to its own end; on the iterations of ``at`` a callback runs after the
    clock stops and before it starts again, so its time counts nowhere."""

    def __init__(self, at=None):
        self.ms, self.scores, self.at = [], [], dict(at or {})
        self._t0 = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def iteration_done(self, model, iteration):
        self.scores.append(float(model._score))
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - self._t0) * 1e3)
        if iteration in self.at:
            self.at[iteration](model)
        self.start()


def step_ms(clock: StepClock, first: int, count: int) -> List[float]:
    """ms of the iterations ``first``..``first + count - 1`` (1-based)."""
    return clock.ms[first - 1:first - 1 + count]


def spread(ms: List[float]) -> dict:
    return {"median": float(np.median(ms)), "min": float(np.min(ms)),
            "max": float(np.max(ms)), "n": len(ms)}


def deep_autoencoder(N):
    """The DL4J 0.7 examples' DeepAutoEncoderExample: nine RBMs
    784-1000-500-250-100-30-100-250-500-1000 (kl_divergence), an
    OutputLayer 1000 -> 784 (mse, sigmoid), seed 123, line gradient
    descent, pretrain and backprop."""
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.pretrain import RBM
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (N.NeuralNetConfiguration.builder().seed(123).iterations(1)
         .optimization_algo("line_gradient_descent").list())
    for n_in, n_out in zip(DAE_WIDTHS[:-1], DAE_WIDTHS[1:]):
        b.layer(RBM(n_in=n_in, n_out=n_out, loss="kl_divergence"))
    b.layer(OutputLayer(n_in=DAE_WIDTHS[-1], n_out=DAE_WIDTHS[0],
                        loss="mse", activation="sigmoid"))
    return MultiLayerNetwork(b.pretrain(True).backprop(True).build()).init()


def rbm_recon_mse(net, params, i: int, x: torch.Tensor) -> float:
    """Mean squared error of RBM ``i``'s mean-field reconstruction
    ``prop_down(prop_up(v))`` of its input v, the layers below and layer
    ``i`` at ``params``; in fp32."""
    with torch.no_grad():
        v, _, _ = net._forward(params, net.net_state, x, train=False,
                               rng=None, to_layer=i - 1)
        v = v.float()
        p = {k: t.float() for k, t in params[i].items()}
        layer = net.layers[i]
        return float(((layer.prop_down(p, layer.prop_up(p, v)) - v) ** 2)
                     .mean())


def pre_deep_ae(N, data) -> dict:
    """(a) the deep autoencoder at full width under mixed_bf16: ``fit``
    pretrains each RBM over DAE_BATCHES batches of 1000, then fine-tunes
    one line-search iteration a batch; then one profiled pretrain step and
    one profiled fine-tune iteration."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import updaters
    x = data["binary"]
    batches = [DataSet(x[i:i + DAE_BATCH], x[i:i + DAE_BATCH])
               for i in range(0, DAE_BATCHES * DAE_BATCH, DAE_BATCH)]
    held = DataSet(x[-DAE_BATCH:], x[-DAE_BATCH:])
    torch.cuda.reset_peak_memory_stats()
    net = deep_autoencoder(N)
    if net._pol().name != "mixed_bf16":
        raise RuntimeError("the deep autoencoder is not on mixed_bf16")
    n_rbm = len(DAE_WIDTHS) - 1
    pre_steps = n_rbm * DAE_BATCHES
    init = [{k: v.clone() for k, v in t.items()} for t in net.params]
    snap = {}

    def at_pretrained(model):
        snap["pretrained"] = [{k: v.clone() for k, v in t.items()}
                              for t in model.params]
        snap["masters_exact"] = all(
            torch.equal(model.params[i][k],
                        s[updaters.MASTER_KEY][k].to(torch.bfloat16))
            for i, s in enumerate(model.updater_state)
            for k in s[updaters.MASTER_KEY])
        snap["held_score"] = model.score(held)

    def at_first_finetune(model):
        snap["after_first"] = [{k: v.clone() for k, v in t.items()}
                               for t in model.params]

    clock = StepClock({pre_steps: at_pretrained,
                       pre_steps + 1: at_first_finetune})
    net.set_listeners(clock)
    t0 = time.perf_counter()
    clock.start()
    net.fit(batches)
    fit_s = time.perf_counter() - t0
    held_after = net.score(held)
    xh = net._tensor(held.features)
    layers = []
    for i in range(n_rbm):
        ms = step_ms(clock, i * DAE_BATCHES + 2, DAE_BATCHES - 1)
        before = rbm_recon_mse(net, snap["pretrained"][:i] + [init[i]], i,
                               xh)
        after = rbm_recon_mse(net, snap["pretrained"], i, xh)
        scores = clock.scores[i * DAE_BATCHES:(i + 1) * DAE_BATCHES]
        layers.append({"n_in": DAE_WIDTHS[i], "n_out": DAE_WIDTHS[i + 1],
                       "step_ms": spread(ms), "recon_mse_before": before,
                       "recon_mse_after": after, "scores": scores})
        log(f"[pretrain] RBM {i} ({DAE_WIDTHS[i]} -> {DAE_WIDTHS[i + 1]}): "
            f"{spread(ms)['median']:.3f} ms a pretrain step (median of "
            f"steps 2-{DAE_BATCHES}, min {min(ms):.3f}, max {max(ms):.3f}); "
            f"held-out reconstruction mse {before:.5f} -> {after:.5f}; "
            f"scores {scores[0]:.4f} ... {scores[-1]:.4f}")
        if not after < before:
            raise RuntimeError(f"pretraining RBM {i} did not lower its "
                               "reconstruction error")
    tune_ms = step_ms(clock, pre_steps + 2, DAE_BATCHES - 1)
    tune_scores = clock.scores[pre_steps:]

    def dist(a, b):
        return float(torch.sqrt(sum(((a[i][k].float() - b[i][k].float()) ** 2)
                                    .sum() for i in range(len(a))
                                    for k in a[i])))
    from_pre = dist(snap["after_first"], snap["pretrained"])
    from_init = dist(snap["after_first"], init)
    solver = net._solver
    log(f"[pretrain] deep autoencoder fine-tune: {spread(tune_ms)['median']:.3f} "
        f"ms a line-search iteration (median of {len(tune_ms)}), "
        f"{solver.host_syncs / solver.iterations:.2f} host reads an "
        f"iteration; held-out score {snap['held_score']:.6f} -> "
        f"{held_after:.6f}; the first fine-tune step lands {from_pre:.4f} "
        f"from the pretrained weights, {from_init:.4f} from the init; "
        f"params == bf16(masters) after pretraining: "
        f"{snap['masters_exact']}")
    if not (held_after < snap["held_score"] and from_pre < from_init
            and snap["masters_exact"]):
        raise RuntimeError("the fine-tune did not lower the score or did "
                           "not start from the pretrained weights")
    peak = torch.cuda.max_memory_allocated()
    net.set_listeners()
    prof = {}
    for what, fn in (("pretrain_step", lambda: net.pretrain_layer(
                          0, batches[0])),
                     ("finetune_iteration", lambda: net.fit(batches[0]))):
        wall_ms, n_events, by_name, busy_ms = profiled(fn)
        prof[what] = {"wall_ms": wall_ms, "device_events": n_events,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms,
                      "top5": top_kernels(by_name)}
        log(f"[pretrain] one profiled {what.replace('_', ' ')}: host "
            f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
            f"{1.0 - busy_ms / wall_ms:.3f}, {n_events} device events")
    return {"widths": list(DAE_WIDTHS), "batch": DAE_BATCH,
            "batches": DAE_BATCHES, "policy": net._pol().name,
            "fit_s": fit_s, "layers": layers,
            "finetune_ms": spread(tune_ms), "finetune_scores": tune_scores,
            "held_score_pretrained": snap["held_score"],
            "held_score_finetuned": held_after,
            "first_step_from_pretrained": from_pre,
            "first_step_from_init": from_init,
            "masters_exact": snap["masters_exact"],
            "host_syncs_per_iteration": solver.host_syncs
            / solver.iterations,
            "peak_memory_bytes": peak, "profiled": prof}


def mnist_vae(N, device="cuda", compute_dtype=None):
    """The DL4J 0.7 examples' VariationalAutoEncoderExample: 784 -> 2,
    encoder and decoder (256, 256), leakyrelu, identity p(z|x), a
    Bernoulli(sigmoid) reconstruction, rmsprop 1e-3, l2 1e-4, xavier,
    seed 12345, pretrain only."""
    from deeplearning4j_tpu_torch.nn.layers.variational import (
        BernoulliReconstructionDistribution, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (N.NeuralNetConfiguration.builder().seed(12345).updater("rmsprop")
         .learning_rate(1e-3).l2(1e-4).weight_init("xavier"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(VariationalAutoencoder(
                n_in=784, n_out=2, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), activation="leakyrelu",
                pzx_activation="identity",
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution(
                        activation="sigmoid"))))
            .pretrain(True).backprop(False).build())
    return MultiLayerNetwork(conf, device=device).init()


def held_vae(net, x: torch.Tensor, gen_seed: int) -> tuple:
    """(the pretrain loss on ``x`` with fixed draws, the mean of
    ``reconstruction_log_probability`` over VAE_LOGP_SAMPLES samples)."""
    from deeplearning4j_tpu_torch.nn.layers.pretrain import make_draws
    layer = net.layers[0]
    p = {k: v.float() for k, v in net.params[0].items()}
    gen = torch.Generator(device=x.device).manual_seed(gen_seed)
    with torch.no_grad():
        draws = make_draws(layer.pretrain_draw_specs(x.shape[0]), gen,
                           x.device, torch.float32)
        loss = float(layer.pretrain_loss(p, x, draws))
        gen.manual_seed(gen_seed + 1)
        logp = layer.reconstruction_log_probability(p, x, VAE_LOGP_SAMPLES,
                                                    gen=gen)
    return loss, float(logp.mean()), bool(torch.isfinite(logp).all())


def pre_vae(N, data) -> dict:
    """(b) the MNIST VAE at full width: VAE_EPOCHS epochs of VAE_BATCHES
    batches of 128 (the first through ``fit``, which pretrains, the rest
    through ``pretrain_layer``), then card vs CPU on one fp32 step's score
    and gradients."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers.pretrain import \
        host_pretrain_draws
    x = data["binary"]
    batches = [DataSet(x[i:i + VAE_BATCH], x[i:i + VAE_BATCH])
               for i in range(0, VAE_BATCHES * VAE_BATCH, VAE_BATCH)]
    xh = torch.as_tensor(x[-VAE_BATCH:], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    net = mnist_vae(N)
    loss0, logp0, _ = held_vae(net, xh, 7)
    clock = StepClock()
    net.set_listeners(clock)
    clock.start()
    net.fit(batches)
    net.pretrain_layer(0, batches, epochs=VAE_EPOCHS - 1)
    steps = VAE_EPOCHS * VAE_BATCHES
    ms = step_ms(clock, 2, steps - 1)
    loss1, logp1, finite = held_vae(net, xh, 7)
    first = float(np.mean(clock.scores[:20]))
    last = float(np.mean(clock.scores[-20:]))
    peak = torch.cuda.max_memory_allocated()
    log(f"[pretrain] MNIST VAE ({steps} pretrain steps, batch {VAE_BATCH}, "
        f"{net._pol().name}): {spread(ms)['median']:.3f} ms a step (median, "
        f"min {min(ms):.3f}, max {max(ms):.3f}); ELBO loss, mean of the "
        f"first and last 20 steps {first:.3f} -> {last:.3f}; held-out "
        f"loss {loss0:.3f} -> {loss1:.3f}; held-out "
        f"reconstruction_log_probability ({VAE_LOGP_SAMPLES} samples) "
        f"{logp0:.3f} -> {logp1:.3f}; peak {peak / 2**20:.1f} MiB")
    if not (last < first and loss1 < loss0 and logp1 > logp0 and finite):
        raise RuntimeError("the MNIST VAE did not learn")
    # card vs CPU, fp32: one step's score and gradients on the same
    # params and draws (rmsprop's first step divides each gradient by its
    # own size, so a gradient near 0 would turn the f32 sums' order into
    # a step of up to 4.5 lr; the update rules are held by the CPU tests)
    card, cpu = (mnist_vae(N, device, "float32") for device in ("cuda",
                                                                "cpu"))
    cpu.set_flat_params(card.get_flat_params())
    got = {}
    for net_ in (card, cpu):
        net_.pretrain_draw_source = host_pretrain_draws(11)
        with torch.no_grad():
            xin = net_._pretrain_input(0, net_._pretrain_features(
                batches[0]))
        draws = net_._pretrain_draws(net_.layers[0], xin, 0)
        got[net_.device.type] = net_.layers[0].pretrain_grads(
            net_.params[0], xin, draws)
    (s_card, g_card), (s_cpu, g_cpu) = got["cuda"], got["cpu"]
    rel = max(float((g_card[k].cpu() - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max()) for k in g_cpu)
    s_rel = abs(float(s_card) - float(s_cpu)) / abs(float(s_cpu))
    log(f"[pretrain] MNIST VAE one fp32 step card vs CPU on the same params "
        f"and draws: gradients rel={rel:.2e} (worst param, of its "
        f"max|CPU|), score rel={s_rel:.2e} (tol {REF_RTOL:g})")
    if not (rel <= REF_RTOL and s_rel <= REF_RTOL):
        raise RuntimeError("the VAE step disagrees between card and CPU")
    return {"steps": steps, "batch": VAE_BATCH, "step_ms": spread(ms),
            "score_first20": first, "score_last20": last,
            "held_loss": [loss0, loss1], "held_logp": [logp0, logp1],
            "peak_memory_bytes": peak,
            "card_vs_cpu": {"grads_rel": rel, "score_rel": s_rel}}


def center_lenet(N, compute_dtype=None):
    """LeNet-5 (BASELINE config #1, ``models/lenet.py``) with its output
    layer a CenterLossOutputLayer at the JAX defaults (alpha 0.05, lambda
    2e-4)."""
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        ConvolutionLayer, SubsamplingLayer)
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.training import \
        CenterLossOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (N.NeuralNetConfiguration.builder().seed(123).updater("adam")
         .learning_rate(1e-3).weight_init("xavier").activation("identity"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    conf = (b.list()
            .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5),
                                    stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(CenterLossOutputLayer(n_out=10, activation="softmax",
                                         loss="mcxent"))
            .set_input_type(inputs.convolutional_flat(28, 28, 1)).build())
    return MultiLayerNetwork(conf).init()


def center_delta(net, ds) -> tuple:
    """(cL before, the reference cL after one step on ``ds``): alpha *
    sum over a class's examples of (center - feature) / (count + 1)
    subtracted, the features the Dense layer's output."""
    layer = net.layers[-1]
    with torch.no_grad():
        feats = net.feed_forward(ds.features)[-2].double()
        lab = torch.as_tensor(ds.labels, device="cuda").double()
        c = net.params[-1]["cL"].double()
        counts = lab.sum(0)
        pull = lab.T @ feats - counts[:, None] * c
        want = c + layer.alpha * pull / (counts[:, None] + 1.0)
    return c, want


def pre_center_loss(N, data) -> dict:
    """(c) center loss on LeNet-5 at batch 256: the cL step against the
    reference delta in fp32 per batch and on the captured step; then
    CL_EPOCHS epochs under mixed_bf16 per batch and from the epoch cache,
    the same params within GOLDEN_BF16_ATOL, ms a step of each."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.dataset import attach_wire, wire_of
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    src = data["lenet"]._ds
    u8, fmt = wire_of(src)
    one = attach_wire(DataSet(src.features[:CL_BATCH],
                              src.labels[:CL_BATCH]), u8[:CL_BATCH], fmt)
    out = {"delta": {}}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for path in ("batch", "cache"):
            net = center_lenet(N, "float32")
            c0, want = center_delta(net, one)
            net.fit(ListDataSetIterator(one, CL_BATCH), ingest=path)
            if path == "cache" and not net._graphs:
                raise RuntimeError("the center-loss cache path did not "
                                   "capture")
            got = net.params[-1]["cL"].double()
            err = float((got - want).abs().max() / want.abs().max())
            moved = float((want - c0).abs().max())
            log(f"[pretrain] center loss, one fp32 step ({path}): cL "
                f"against the reference delta rel={err:.2e} (tol "
                f"{REF_RTOL:g}), the delta's max {moved:.4e}")
            if not (err <= REF_RTOL and moved > 0):
                raise RuntimeError(f"the center-loss cL step ({path}) is "
                                   "not the reference delta")
            out["delta"][path] = err
        it = data["lenet"]
        runs = {}
        for path in ("batch", "cache"):
            net = center_lenet(N)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(it._ds, CL_BATCH), ingest=path)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            net.fit(ListDataSetIterator(it._ds, CL_BATCH),
                    epochs=CL_EPOCHS - 1, ingest=path)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / (
                (CL_EPOCHS - 1) * CL_BATCHES)
            runs[path] = (net, ms, warm_s)
        err = same_state("center-loss LeNet mixed_bf16, cache vs per batch",
                         flat_state(runs["cache"][0]),
                         flat_state(runs["batch"][0]), GOLDEN_BF16_ATOL)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
    score = runs["cache"][0].score()
    log(f"[pretrain] center-loss LeNet-5 at batch {CL_BATCH} "
        f"({runs['batch'][0]._pol().name}): {runs['batch'][1]:.3f} ms a "
        f"step per batch, {runs['cache'][1]:.3f} ms from the epoch cache "
        f"(epochs 2-{CL_EPOCHS} of {CL_BATCHES} steps); score {score:.4f}")
    if not np.isfinite(score):
        raise RuntimeError("the center-loss LeNet score is not finite")
    out.update({"batch": CL_BATCH, "steps_per_epoch": CL_BATCHES,
                "epochs": CL_EPOCHS, "batch_step_ms": runs["batch"][1],
                "cache_step_ms": runs["cache"][1],
                "first_epoch_s": {p: r[2] for p, r in runs.items()},
                "cache_vs_batch_max_diff": err, "score": score})
    return out


def card_cpu_pair(build, seed: int = 21):
    """``build(device)`` on the card and on the CPU, the CPU net on the
    card's weights, both drawing from one CPU stream."""
    from deeplearning4j_tpu_torch.nn.layers.pretrain import \
        host_pretrain_draws
    card, cpu = build("cuda"), build("cpu")
    cpu.set_flat_params(card.get_flat_params())
    for net in (card, cpu):
        net.pretrain_draw_source = host_pretrain_draws(seed)
    return card, cpu


def hold_pair(what: str, card, cpu) -> float:
    got, want = card.get_flat_params(), cpu.get_flat_params()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"[pretrain] {what}: card vs CPU params rel={rel:.2e} (tol "
        f"{REF_RTOL:g}), iteration {card.iteration}")
    if not (rel <= REF_RTOL and card.iteration == cpu.iteration > 0):
        raise RuntimeError(f"{what}: the card disagrees with the CPU")
    return rel


def pre_small(N) -> dict:
    """(d) small checks, card against CPU in fp32 at REF_RTOL, the
    gradient check of a card-trained VAE, a zip from the card restored on
    the CPU, and the mixed_bf16 masters rule on the card."""
    import io

    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.curves import \
        CurvesDataSetIterator
    from deeplearning4j_tpu_torch.gradientcheck import \
        check_pretrain_gradients
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.core import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.pretrain import AutoEncoder, RBM
    from deeplearning4j_tpu_torch.nn.layers.training import \
        CenterLossOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.variational import (
        BernoulliReconstructionDistribution,
        CompositeReconstructionDistribution,
        GaussianReconstructionDistribution, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils import model_serializer as ms
    out = {}

    def mln(layers, dtype="float32", updater="sgd", lr=0.1,
            pretrain=False):
        # sgd: Adam's normalised step would magnify the order of the f32
        # sums into the update of a near-zero gradient
        def build(device):
            b = (N.NeuralNetConfiguration.builder().seed(3).updater(updater)
                 .learning_rate(lr).activation("sigmoid"))
            b = b.dtype(dtype) if dtype == "float64" else \
                b.compute_dtype(dtype)
            b = b.list()
            for layer in layers():
                b.layer(layer)
            return MultiLayerNetwork(b.pretrain(pretrain).build(),
                                     device=device).init()
        return build

    card, cpu = card_cpu_pair(mln(lambda: [
        AutoEncoder(n_in=784, n_out=64, corruption_level=0.3)]))
    for net in (card, cpu):
        net.pretrain(CurvesDataSetIterator(100, 500), epochs=2)
    out["autoencoder_curves"] = hold_pair("AutoEncoder on curves", card,
                                          cpu)
    rng = np.random.RandomState(5)
    g = DataSet(rng.randn(64, 16).astype(np.float32),
                np.zeros((64, 1), np.float32))
    card, cpu = card_cpu_pair(mln(lambda: [
        RBM(n_in=16, n_out=8, visible_unit="gaussian", k=2)]))
    for net in (card, cpu):
        net.pretrain(g, epochs=5)
    out["rbm_gaussian"] = hold_pair("gaussian-visible RBM (k=2)", card, cpu)

    def composite_vae():
        return [VariationalAutoencoder(
            n_in=16, n_out=3, encoder_layer_sizes=(12,),
            decoder_layer_sizes=(12,), num_samples=2, activation="tanh",
            reconstruction_distribution=CompositeReconstructionDistribution(
                parts=((10, GaussianReconstructionDistribution()),
                       (6, BernoulliReconstructionDistribution()))))]
    xv = rng.rand(64, 16).astype(np.float32)
    xv[:, 10:] = (xv[:, 10:] > 0.5)
    v = DataSet(xv, np.zeros((64, 1), np.float32))
    card, cpu = card_cpu_pair(mln(composite_vae))
    for net in (card, cpu):
        net.pretrain(v, epochs=5)
    out["vae_composite"] = hold_pair("VAE with a composite distribution",
                                     card, cpu)
    # the gradient check of the card-trained VAE, copied to the CPU in f64
    f64 = mln(composite_vae, dtype="float64")("cpu")
    f64.set_flat_params(card.get_flat_params().astype(np.float64))
    ok = check_pretrain_gradients(f64, v, 0)
    log(f"[pretrain] check_pretrain_gradients of the card-trained VAE on "
        f"the CPU in f64: {ok}")
    if not ok:
        raise RuntimeError("the card-trained VAE fails its gradient check")
    out["gradient_check"] = ok

    def graph(device):
        conf = (N.NeuralNetConfiguration.builder().seed(4).updater("sgd")
                .learning_rate(0.1).activation("sigmoid")
                .compute_dtype("float32").graph_builder().add_inputs("in")
                .add_layer("ae", AutoEncoder(n_in=16, n_out=8,
                                             corruption_level=0.2), "in")
                .add_layer("out", OutputLayer(n_in=8, n_out=3), "ae")
                .set_outputs("out").pretrain(True).build())
        return ComputationGraph(conf, device=device).init()
    yg = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]
    gd = DataSet(rng.rand(64, 16).astype(np.float32), yg)
    card, cpu = card_cpu_pair(graph)
    for net in (card, cpu):
        net.fit(gd, epochs=3)
    out["graph_pretrained_vertex"] = hold_pair(
        "ComputationGraph with a pretrained vertex", card, cpu)
    # a zip written on the card, restored on the CPU
    every = mln(lambda: [
        VariationalAutoencoder(n_in=16, n_out=6, encoder_layer_sizes=(8,),
                               decoder_layer_sizes=(8,)),
        AutoEncoder(n_in=6, n_out=5, corruption_level=0.1),
        RBM(n_in=5, n_out=4),
        CenterLossOutputLayer(n_in=4, n_out=3)], pretrain=True)("cuda")
    every.fit(DataSet(xv, yg))
    buf = io.BytesIO()
    ms.write_model(every, buf)
    back = ms.restore_multi_layer_network(io.BytesIO(buf.getvalue()),
                                          device="cpu")
    same = (np.array_equal(back.get_flat_params(), every.get_flat_params())
            and np.array_equal(back.get_flat_updater_state(),
                               every.get_flat_updater_state())
            and back._pretrain_done and back.iteration == every.iteration)
    orel = float((back.output(xv) - every.output(xv).cpu()).abs().max())
    log(f"[pretrain] a zip of VAE + AutoEncoder + RBM + center loss written "
        f"on the card, restored on the CPU: params and updater state "
        f"bitwise {same}, outputs max |diff| {orel:.2e}")
    if not (same and orel <= REF_RTOL):
        raise RuntimeError("the card's zip does not restore on the CPU")
    out["zip_card_to_cpu"] = {"bitwise": same, "output_max_diff": orel}
    # the mixed_bf16 masters rule on the card
    xm = rng.rand(32, 8).astype(np.float32)
    ym = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 32)]
    out["masters"] = {}
    for updater, lr in (("sgd", 0.5), ("adam", 0.05)):
        net = MultiLayerNetwork(
            N.NeuralNetConfiguration.builder().seed(1).updater(updater)
            .learning_rate(lr).activation("sigmoid").list()
            .layer(AutoEncoder(n_in=8, n_out=6, corruption_level=0.0))
            .layer(OutputLayer(n_in=6, n_out=2)).build()).init()
        init_w = net.params[0]["W"].float().clone()
        net.pretrain_layer(0, DataSet(xm, ym), epochs=20)
        pre_w = net.params[0]["W"].float().clone()
        exact = torch.equal(net.params[0]["W"], net.updater_state[0][
            "_master"]["W"].to(torch.bfloat16))
        net.fit(DataSet(xm, ym))
        moved = float((pre_w - init_w).abs().max())
        step = float((net.params[0]["W"].float() - pre_w).abs().max())
        log(f"[pretrain] mixed_bf16 {updater}: pretraining moved W by "
            f"{moved:.4f}, the first fit step by {step:.4f}; params == "
            f"bf16(masters) {exact}")
        if not (exact and step < 0.2 * moved):
            raise RuntimeError("a mixed_bf16 fine-tune does not start from "
                               "the pretrained weights")
        out["masters"][updater] = {"pretrain_moved": moved,
                                   "first_step": step}
    return out


def pre_chaos() -> dict:
    """(e) the kill/resume harness with its children on the card."""
    import tempfile

    from deeplearning4j_tpu_torch.resilience import chaos
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        report = chaos.run_chaos(workdir=tmp, device="cuda")
        seconds = time.perf_counter() - t0
    report.pop("workdir")
    log(f"[pretrain] chaos on the card: victim rc "
        f"{report['victim_returncode']}, {report['score_mismatches']} score "
        f"mismatches over {report['steps_compared']} steps, params match "
        f"{report['params_match']}, device {report['device']} "
        f"({seconds:.1f} s for the three children)")
    if not (report["parity"] and report["victim_returncode"] == -9
            and report["device"].startswith("cuda")):
        raise RuntimeError(f"the kill/resume harness failed on the card: "
                           f"{report}")
    report["seconds"] = seconds
    return report


def phase_pretrain(A, N=None) -> dict:
    """Phase 17: the pretraining families (the ``pretrain`` path of the
    kernels line: it launches none of K1-K4)."""
    if N is None:
        from deeplearning4j_tpu_torch.nn.conf import \
            neural_net_configuration as N
    torch.cuda.synchronize()
    A.reset_launches()            # counts of the main path's run only
    data = pre_mnist()
    result, seconds = {}, {"data": data["seconds"]}
    for name, part in (("deep_autoencoder", lambda: pre_deep_ae(N, data)),
                       ("vae", lambda: pre_vae(N, data)),
                       ("center_loss", lambda: pre_center_loss(N, data)),
                       ("small", lambda: pre_small(N)),
                       ("chaos", pre_chaos)):
        t0 = time.perf_counter()
        result[name] = part()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t0
    result["seconds"] = seconds
    log(f"[pretrain] seconds by part {seconds}")
    result["launches"] = dict(A.LAUNCHES)
    log(f"[pretrain] launches {result['launches']}")
    if any(result["launches"].values()):
        raise RuntimeError("the pretrain path launched a flash kernel")
    return result

# ---- phase 18: serving v2 and deployment ---------------------------------
# (a) int8: the attention net behind a bf16 and an int8 engine, LeNet-5
# trained on MNIST behind an fp32 and an int8 engine (the JAX package's
# gates of tests/test_serving_registry.py), VGG-16 under int8.
S2_MAX_BATCH = 4
S2_PREFILL, S2_DECODE_TOKENS = 64, 32
S2_LENET_TRAIN, S2_LENET_TEST, S2_LENET_EPOCHS = 6400, 2000, 2
S2_LENET_BATCH = 32                    # the served LeNet's largest batch
INT8_AGREE, INT8_ACC_DELTA, INT8_PROB_ATOL, INT8_BYTES_RATIO = \
    0.97, 0.02, 0.02, 0.7
# (b) the registry: five models under a budget of the largest model_bytes
# plus half the second largest; three round-robin passes.  After an evict,
# once in-flight batches let go, memory_allocated must fall by at least
# EVICT_FALL of the bytes the evict released.
S2_PASSES = 3
EVICT_FALL = 0.9
# (c) admission: bench_serving_v2's closed-loop sweep, then bench_traffic's
# tenant mix in process (poisson gold at 25% of a capacity probe with a 2x
# share, bursty free at 2.2x, diurnal public at 10%), observe then enforce.
S2_SWEEP = (4, 16, 48)
S2_SWEEP_S, S2_CAL_S = 2.0, 1.5
S2_SLO_X = 3.0                         # SLO = 3x the unloaded p99
TR_MAX_BATCH, TR_LATENCY_MS = 8, 2.0
TR_MIX = {"gold": ("poisson", 0.25), "free": ("bursty", 2.2),
          "public": ("diurnal", 0.10)}
TR_DUR = (3.0, 3.0, 4.0)              # calibrate, observe, enforce
# (d) deployment: LeNet-5 at batch 256, one published version an epoch.
DP_BATCH, DP_EPOCHS, DP_TRAIN, DP_EVAL = 256, 3, 6400, 512


def _mb(n: float) -> float:
    return n / 2**20


def s2_lenet(seed: int):
    """LeNet-5 (BASELINE config #1) trained S2_LENET_EPOCHS epochs on the
    procedural MNIST under the card's mixed_bf16, and the test set."""
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    train = MnistDataSetIterator(128, S2_LENET_TRAIN)
    test = MnistDataSetIterator(500, S2_LENET_TEST, train=False)
    net = MultiLayerNetwork(lenet()).init()
    net.fit(train, epochs=S2_LENET_EPOCHS)
    return net, np.asarray(test._ds.features), \
        np.argmax(np.asarray(test._ds.labels), axis=1)


def s2_predict_all(engine, x, chunk: int) -> np.ndarray:
    return np.concatenate([engine.predict(x[i:i + chunk], timeout=WAIT_S)
                           for i in range(0, len(x), chunk)])


def s2_decode_ms(engine, rng, batch: int) -> float:
    """Median host ms a decoded token (one session step of ``batch``
    rows, synchronized) over S2_DECODE_TOKENS steps after a prefill."""
    x = rng.randn(batch, S2_PREFILL + S2_DECODE_TOKENS, N_IN).astype(
        np.float32)
    sid = f"p18-{batch}"
    engine.predict_session(sid, x[:, :S2_PREFILL])
    ms = []
    for t in range(S2_PREFILL, S2_PREFILL + S2_DECODE_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict_session(sid, x[:, t])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    engine.sessions.clear(sid)
    return float(np.median(ms))


def s2_int8_attention(att, rng) -> dict:
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    out = {}
    with InferenceEngine(att, max_batch_size=S2_MAX_BATCH,
                         timestep_buckets=SERVE_BUCKETS,
                         name="p18-att-bf16") as eb, \
            InferenceEngine(att, max_batch_size=S2_MAX_BATCH,
                            timestep_buckets=SERVE_BUCKETS,
                            name="p18-att-int8", quantize="int8") as e8:
        for eng in (eb, e8):
            eng.warmup((SEQ, N_IN))
        for shape in ((2, SERVE_BUCKETS[0]),
                      (1, SERVE_BUCKETS[0] * 3 // 4)):
            x = rng.randn(*shape, N_IN).astype(np.float32)
            pb, p8 = eb.predict(x, timeout=WAIT_S), e8.predict(
                x, timeout=WAIT_S)
            if not (np.isfinite(p8).all() and np.abs(
                    p8.sum(-1) - 1).max() <= ROW_SUM_ATOL):
                raise RuntimeError("int8 attention probabilities are not "
                                   "finite softmax rows")
            out[f"predict_{shape[0]}x{shape[1]}"] = {
                "max_abs_vs_bf16": float(np.abs(p8 - pb).max()),
                "signal_max_abs_p_minus_uniform": float(
                    np.abs(pb - 1.0 / N_OUT).max())}
        out["decode_ms_per_token"] = {
            f"batch{b}": {"bf16": s2_decode_ms(eb, rng, b),
                          "int8": s2_decode_ms(e8, rng, b)}
            for b in (1, S2_MAX_BATCH)}
        out["model_bytes"] = {"bf16": eb.model_bytes(),
                              "int8": e8.model_bytes()}
    log(f"[serving_v2] attention int8: model_bytes {out['model_bytes']}; "
        + "; ".join(f"{k} max|p8 - pbf16| {v['max_abs_vs_bf16']:.2e} "
                    f"(signal {v['signal_max_abs_p_minus_uniform']:.2e})"
                    for k, v in out.items() if k.startswith("predict"))
        + f"; ms a decoded token {out['decode_ms_per_token']}")
    return out


def s2_int8_lenet(lenet_net, x, labels) -> dict:
    """The JAX package's int8 gates on the trained LeNet-5, f32 engine vs
    int8 engine over the test set."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    f32 = fp32_copy(lenet_net)
    with InferenceEngine(f32, max_batch_size=S2_LENET_BATCH,
                         max_latency_ms=1.0, name="p18-lenet-f32") as e32, \
            InferenceEngine(f32, max_batch_size=S2_LENET_BATCH,
                            max_latency_ms=1.0, name="p18-lenet-int8",
                            quantize="int8") as e8:
        y32 = s2_predict_all(e32, x, S2_LENET_BATCH)
        y8 = s2_predict_all(e8, x, S2_LENET_BATCH)
        bytes32, bytes8 = e32.model_bytes(), e8.model_bytes()
    acc32 = float(np.mean(np.argmax(y32, 1) == labels))
    acc8 = float(np.mean(np.argmax(y8, 1) == labels))
    agree = float(np.mean(np.argmax(y32, 1) == np.argmax(y8, 1)))
    prob = float(np.abs(y32 - y8).max())
    res = {"acc_f32": acc32, "acc_int8": acc8, "agreement": agree,
           "max_prob_diff": prob, "model_bytes_f32": bytes32,
           "model_bytes_int8": bytes8}
    log(f"[serving_v2] LeNet-5 f32 vs int8 on {len(x)} test images: "
        f"accuracy {acc32:.4f} vs {acc8:.4f} (delta tol {INT8_ACC_DELTA}), "
        f"top-1 agreement {agree:.4f} (>= {INT8_AGREE}), max |p| diff "
        f"{prob:.4f} (< {INT8_PROB_ATOL}), model_bytes {bytes32} -> "
        f"{bytes8} ({bytes8 / bytes32:.3f}x, < {INT8_BYTES_RATIO})")
    if not (abs(acc32 - acc8) <= INT8_ACC_DELTA and agree >= INT8_AGREE
            and prob < INT8_PROB_ATOL
            and bytes8 < INT8_BYTES_RATIO * bytes32):
        raise RuntimeError(f"LeNet-5 int8 fails the JAX gates: {res}")
    return res


def s2_int8_vgg(vgg, rng) -> dict:
    """VGG-16 under int8: model_bytes against bf16 and f32, and a batch's
    transient peak with the decoded copy, beside the bf16 engine's."""
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    x = rng.rand(2, 224, 224, 3).astype(np.float32)
    f32_bytes = sum(p.numel() * 4 for tree in vgg.params
                    for p in tree.values())
    res = {"params": vgg.num_params(), "model_bytes_f32": f32_bytes}
    outs = {}
    for mode in ("bf16", "int8"):
        t0 = time.perf_counter()
        eng = InferenceEngine(vgg, max_batch_size=2, name=f"p18-vgg-{mode}",
                              quantize="int8" if mode == "int8" else None)
        build_s = time.perf_counter() - t0
        with eng:
            eng.warmup((224, 224, 3))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[mode] = eng.predict(x, timeout=WAIT_S)
            torch.cuda.synchronize()
            res[mode] = {"model_bytes": eng.model_bytes(),
                         "resident_bytes": eng.resident_bytes(),
                         "batch2_peak_over_base_bytes":
                             torch.cuda.max_memory_allocated() - base,
                         "engine_build_s": build_s}
        eng.release_device_buffers()
    res["max_prob_diff"] = float(np.abs(outs["int8"] - outs["bf16"]).max())
    log(f"[serving_v2] VGG-16 ({res['params']} params) model_bytes: f32 "
        f"{_mb(f32_bytes):.1f} MiB, bf16 "
        f"{_mb(res['bf16']['model_bytes']):.1f} MiB, int8 "
        f"{_mb(res['int8']['model_bytes']):.1f} MiB; a batch of 2's peak "
        f"over the resident base: bf16 "
        f"{_mb(res['bf16']['batch2_peak_over_base_bytes']):.1f} MiB, int8 "
        f"{_mb(res['int8']['batch2_peak_over_base_bytes']):.1f} MiB (the "
        f"decoded copy); int8 engine build (host quantize) "
        f"{res['int8']['engine_build_s']:.2f} s; max |p8 - pbf16| "
        f"{res['max_prob_diff']:.2e}")
    if not (res["int8"]["model_bytes"] < 0.6 * res["bf16"]["model_bytes"]
            and np.isfinite(outs["int8"]).all()):
        raise RuntimeError(f"VGG-16 int8 keeps no fewer bytes: {res}")
    return res


class _PageLog:
    """Wraps an engine's page-in and evict primitives: page-in ms (the
    copy, synchronized) and bytes; for each evict, the bytes it released
    and how far ``torch.cuda.memory_allocated()`` fell once in-flight
    batches dropped their references."""

    def __init__(self, name, engine):
        self.name, self.pageins, self.evicts = name, [], []
        self.engine = engine
        ensure, release = engine.ensure_resident, \
            engine.release_device_buffers

        def paged_in():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = ensure()
            torch.cuda.synchronize()
            self.pageins.append(((time.perf_counter() - t0) * 1e3, n))
            return n

        def evicted():
            before = torch.cuda.memory_allocated()
            freed = release()
            t0 = time.perf_counter()
            fell = before - torch.cuda.memory_allocated()
            while fell < EVICT_FALL * freed and \
                    time.perf_counter() - t0 < 2.0:
                time.sleep(0.005)      # an in-flight batch still holds them
                fell = before - torch.cuda.memory_allocated()
            self.evicts.append({"freed": freed, "fell": fell,
                                "waited_ms": (time.perf_counter() - t0)
                                * 1e3})
            return freed

        engine.ensure_resident = paged_in
        engine.release_device_buffers = evicted

    def restore(self) -> None:
        del self.engine.ensure_resident, self.engine.release_device_buffers


def s2_registry(models, adm, rng) -> tuple:
    """(b) five models in one ModelRegistry under a budget that never
    holds VGG-16 and ResNet-50 together; three round-robin passes, every
    answer bitwise the model's answer before any paging."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    specs = {  # name: (net, max batch, timestep buckets, warmup shape, x)
        "vgg16": (models["vgg16"], 2, None, (224, 224, 3),
                  rng.rand(1, 224, 224, 3).astype(np.float32)),
        "resnet50": (models["resnet50"], 2, None, (224, 224, 3),
                     rng.rand(1, 224, 224, 3).astype(np.float32)),
        "lenet": (models["lenet"], 16, None, (784,),
                  rng.rand(2, 784).astype(np.float32)),
        "char_rnn": (models["char_rnn"], 4, None, None,
                     np.eye(CHAR_VOCAB, dtype=np.float32)[
                         rng.randint(0, CHAR_VOCAB, (1, S2_PASSES))]),
        "attention": (models["attention"], S2_MAX_BATCH, SERVE_BUCKETS,
                      (SEQ, N_IN),
                      rng.randn(1, SERVE_BUCKETS[0], N_IN).astype(
                          np.float32)),
    }
    engines, refs = {}, {}
    for name, (net, mb, tb, shape, x) in specs.items():
        eng = InferenceEngine(net, max_batch_size=mb, timestep_buckets=tb,
                              max_latency_ms=2.0, name=name,
                              admission=adm).start()
        if shape is not None:
            eng.warmup(shape)
        if name == "char_rnn":
            refs[name] = [eng.predict_session("ref", x[:, t])
                          for t in range(S2_PASSES)]
        else:
            refs[name] = eng.predict(x, timeout=WAIT_S)
        eng.release_device_buffers()
        engines[name] = eng
    sizes = sorted((e.model_bytes() for e in engines.values()),
                   reverse=True)
    budget = sizes[0] + sizes[1] // 2
    logs = {name: _PageLog(name, eng) for name, eng in engines.items()}
    reg = ModelRegistry(hbm_budget_bytes=budget)
    for name, eng in engines.items():
        reg.register(name, eng, start=False)

    def compiles():
        vals = monitor.snapshot().get("serving_bucket_compiles_total",
                                      {}).get("values", {})
        return sum(vals.values())

    c0 = compiles()
    max_resident, mismatches = reg.resident_bytes(), []
    for p in range(S2_PASSES):
        for name, (_, _, _, _, x) in specs.items():
            if name == "char_rnn":
                got = reg.predict(name, x[:, p], session="live")
                want = refs[name][p]
            else:
                got = reg.predict(name, x, timeout=WAIT_S)
                want = refs[name]
            if not np.array_equal(got, want):
                mismatches.append((p, name, float(np.abs(got - want).max())))
            max_resident = max(max_resident, reg.resident_bytes())
            if reg.resident_bytes() > budget:
                raise RuntimeError(f"resident {reg.resident_bytes()} over "
                                   f"the budget {budget}")
    for lg in logs.values():
        lg.restore()
    snap = monitor.snapshot()
    counts = {m: sum(snap.get(m, {}).get("values", {}).values())
              for m in ("serving_model_pageins_total",
                        "serving_model_evictions_total")}
    evicts = [dict(e, model=n) for n, lg in logs.items() for e in lg.evicts]
    short = [e for e in evicts if e["fell"] < EVICT_FALL * e["freed"]]
    pageins = {n: [{"ms": ms, "bytes": b} for ms, b in lg.pageins]
               for n, lg in logs.items() if lg.pageins}
    res = {"budget_bytes": budget,
           "model_bytes": {n: e.model_bytes() for n, e in engines.items()},
           "max_resident_bytes": max_resident,
           "pageins_total": counts["serving_model_pageins_total"],
           "evictions_total": counts["serving_model_evictions_total"],
           "pageins": pageins, "evicts": evicts,
           "compiles_moved": compiles() - c0, "mismatches": mismatches}
    log(f"[serving_v2] registry of 5 (budget {_mb(budget):.1f} MiB, "
        f"model_bytes MiB {({n: round(_mb(b), 2) for n, b in res['model_bytes'].items()})}): "
        f"{S2_PASSES} passes, max resident {_mb(max_resident):.1f} MiB, "
        f"page-ins {counts['serving_model_pageins_total']:g}, evictions "
        f"{counts['serving_model_evictions_total']:g}; page-in ms "
        + ", ".join(f"{n} {np.median([p['ms'] for p in v]):.3f} "
                    f"({_mb(v[0]['bytes']):.1f} MiB)"
                    for n, v in pageins.items())
        + f"; every evict: memory_allocated fell by "
        f"{min((e['fell'] / e['freed'] for e in evicts if e['freed']), default=0):.3f}"
        f"x of its model_bytes or more (max wait "
        f"{max((e['waited_ms'] for e in evicts), default=0):.1f} ms); "
        f"bucket compiles moved {res['compiles_moved']:g}; "
        f"answers bitwise: {not mismatches}")
    if mismatches or short or res["compiles_moved"] or not (
            counts["serving_model_pageins_total"]
            and counts["serving_model_evictions_total"] >= S2_PASSES):
        raise RuntimeError(f"the registry check failed: mismatches "
                           f"{mismatches}, short evicts {short}, {res}")
    return reg, engines, res


def s2_pct(lat, p):
    return lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3 if lat else None


def s2_sweep(reg, adm, rng) -> dict:
    """bench_serving_v2's closed-loop sweep over the registry: the SLO is
    S2_SLO_X times the unloaded p99 of one client that cycles through the
    five models, then S2_SWEEP clients for S2_SWEEP_S each, client i on
    model i mod 5 (the char-RNN and the attention net by session, the
    others by predict), every client backing off 2 ms after a shed."""
    from deeplearning4j_tpu_torch.serving import ServingError
    xs = {"vgg16": rng.rand(1, 224, 224, 3).astype(np.float32),
          "resnet50": rng.rand(1, 224, 224, 3).astype(np.float32),
          "lenet": rng.rand(1, 784).astype(np.float32),
          "char_rnn": np.eye(CHAR_VOCAB, dtype=np.float32)[[3]],
          "attention": rng.randn(1, N_IN).astype(np.float32)}
    names = ("char_rnn", "attention", "lenet", "resnet50", "vgg16")

    def level(clients: int, seconds: float, tag: str,
              rotate: bool = False) -> dict:
        lat, sheds, lock = [], [0] * clients, threading.Lock()
        stop_at = time.perf_counter() + seconds
        errors = []

        def client(i):
            n = 0
            while time.perf_counter() < stop_at:
                name = names[(i + n if rotate else i) % len(names)]
                t0 = time.perf_counter()
                try:
                    if name in ("char_rnn", "attention"):
                        # a fresh conversation every 256 tokens
                        reg.predict(name, xs[name], session=(
                            f"{tag}-{i}-{n // min(256, SEQ)}"))
                    else:
                        reg.predict(name, xs[name], timeout=WAIT_S)
                except ServingError:
                    sheds[i] += 1
                    time.sleep(0.002)
                    continue
                except Exception as e:        # a real failure
                    errors.append(repr(e))
                    return
                with lock:
                    lat.append(time.perf_counter() - t0)
                n += 1

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        elapsed = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"sweep clients failed: {errors[:3]}")
        lat.sort()
        done = len(lat)
        return {"clients": clients, "rps": done / elapsed,
                "admitted_p50_ms": s2_pct(lat, 0.50),
                "admitted_p99_ms": s2_pct(lat, 0.99), "shed": sum(sheds),
                "shed_fraction": sum(sheds) / max(1, done + sum(sheds))}

    adm.enforce = False
    cal = level(1, S2_CAL_S, "cal", rotate=True)
    slo = S2_SLO_X * cal["admitted_p99_ms"]
    adm.slo_p99_ms = slo
    adm.enforce = True
    levels = []
    for clients in S2_SWEEP:
        levels.append(level(clients, S2_SWEEP_S, f"c{clients}"))
    adm.enforce = False
    for lv in levels:
        log(f"[serving_v2] sweep {lv['clients']} clients: "
            f"{lv['rps']:.1f} rps admitted, p99 {lv['admitted_p99_ms']:.2f}"
            f" ms (SLO {slo:.2f} ms = {S2_SLO_X:g}x the unloaded p99 "
            f"{cal['admitted_p99_ms']:.2f} ms), shed "
            f"{lv['shed_fraction']:.3f}")
    if levels[-1]["shed"] == 0:
        raise RuntimeError(f"no shed at {S2_SWEEP[-1]} clients: {levels}")
    return {"unloaded": cal, "slo_p99_ms": slo, "levels": levels}


def tr_arrivals(kind: str, rate: float, duration_s: float, rng) -> list:
    """``bench.py``'s ``_arrival_times``: a Poisson process, or a thinned
    nonhomogeneous one (bursty: 3x the mean in a 25% duty cycle; diurnal:
    one sinusoidal day over the run), all at mean ``rate``."""
    if rate <= 0 or duration_s <= 0:
        return []
    if kind == "poisson":
        out, t = [], rng.exponential(1.0 / rate)
        while t < duration_s:
            out.append(t)
            t += rng.exponential(1.0 / rate)
        return out
    burst_x, duty = 3.0, 0.25
    period = max(0.5, duration_s / 4.0)
    base = (1.0 - duty * burst_x) / (1.0 - duty)

    def lam(t):
        if kind == "bursty":
            return rate * (burst_x if (t % period) / period < duty
                           else base)
        return rate * (1.0 + 0.8 * np.sin(2.0 * np.pi * t / duration_s))

    lam_max = rate * max(burst_x, 1.8)
    out, t = [], rng.exponential(1.0 / lam_max)
    while t < duration_s:
        if rng.rand() * lam_max < lam(t):
            out.append(t)
        t += rng.exponential(1.0 / lam_max)
    return out


def tr_open_loop(fire, arrivals, pool_size: int = 96) -> list:
    """``bench.py``'s ``_open_loop_tagged``: each arrival fires at its
    scheduled time; its latency is charged from the schedule.  Returns
    ``[(tag, code, latency_s)]``."""
    results, rec, nxt, cursor = [], threading.Lock(), threading.Lock(), [0]
    start = time.perf_counter()

    def runner():
        while True:
            with nxt:
                i = cursor[0]
                if i >= len(arrivals):
                    return
                cursor[0] = i + 1
            at, tag = arrivals[i]
            delay = at - (time.perf_counter() - start)
            if delay > 0:
                time.sleep(delay)
            try:
                code = fire(tag)
            except Exception:
                code = -1
            lat = (time.perf_counter() - start) - at
            with rec:
                results.append((tag, code, lat))

    pool = [threading.Thread(target=runner, daemon=True)
            for _ in range(min(pool_size, len(arrivals) or 1))]
    for th in pool:
        th.start()
    for th in pool:
        th.join(WAIT_S)
    return results


def s2_traffic(models, rng, flight_dir: str) -> dict:
    """bench_traffic's tenant mix in process: two LeNet engines and the
    char-RNN (sessions churning through a 2 s TTL) behind one fair
    admission controller; calibrate gold alone, overload in observe mode
    (the unfairness gauge and alert, with its bundle), then enforce."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry, QueueFull,
                                                  SloShed)
    from deeplearning4j_tpu_torch.serving.admission import (
        SloAdmissionController, publish_tenant_telemetry,
        reset_tenant_labels)
    reset_tenant_labels()
    monitor.alerts.reset()
    alert_eng = monitor.alerts.engine(interval_s=0.5)
    adm = SloAdmissionController(
        1e4, window_s=0.75, min_samples=30, refresh_s=0.02,
        tenants={"gold": {"share": 2.0}, "free": {"share": 1.0},
                 "public": {"share": 1.0}},
        fair=True, enforce=False, penalty_s=15.0)
    qcap = max(2, TR_MAX_BATCH // 2)
    engines = {n: InferenceEngine(models["lenet"], max_batch_size=TR_MAX_BATCH,
                                  max_latency_ms=TR_LATENCY_MS,
                                  queue_capacity=qcap, name=n, admission=adm)
               for n in ("t-lenet-a", "t-lenet-b")}
    engines["t-rnn"] = InferenceEngine(
        models["char_rnn"], max_batch_size=TR_MAX_BATCH,
        max_latency_ms=TR_LATENCY_MS, queue_capacity=qcap, name="t-rnn",
        admission=adm, session_ttl_s=2.0)
    reg = ModelRegistry()
    for n, eng in engines.items():
        reg.register(n, eng)
    x_dense = rng.rand(1, 784).astype(np.float32)
    x_step = np.eye(CHAR_VOCAB, dtype=np.float32)[[5]]
    engines["t-lenet-a"].warmup((784,))
    engines["t-lenet-b"].warmup((784,))
    engines["t-rnn"].predict_session("_warm", x_step)
    models_ = ["t-lenet-a", "t-lenet-b", "t-rnn"]
    pools = {"gold": models_[:2], "free": models_, "public": models_}
    pool_w = {}
    for tn, ms in pools.items():
        w = np.array([1.0 / (k + 1) ** 1.2 for k in range(len(ms))])
        pool_w[tn] = w / w.sum()

    def tag_for(tenant, t, r):
        ms = pools[tenant]
        m = ms[int(r.choice(len(ms), p=pool_w[tenant]))]
        sess = (f"{tenant}-{int(t)}-{int(r.randint(4))}"
                if m == "t-rnn" else None)
        return (tenant, m, sess, t)

    def fire(tag) -> int:
        tenant, model, sess = tag[:3]
        try:
            reg.predict(model, x_step if model == "t-rnn" else x_dense,
                        session=sess, timeout=20.0, block=False,
                        tenant=tenant)
            return 200
        except SloShed:
            return 503
        except QueueFull:
            return 429

    def schedule(specs, seed):
        merged = []
        for tenant, kind, rate, dur in specs:
            r = np.random.RandomState(seed + sum(ord(c) for c in tenant))
            for t in tr_arrivals(kind, rate, dur, r):
                merged.append((t, tag_for(tenant, t, r)))
        merged.sort(key=lambda p: p[0])
        return merged

    # capacity probe: closed-loop batched throughput on one LeNet engine
    probe_stop = time.perf_counter() + 0.8
    counts = [0] * (3 * TR_MAX_BATCH)

    def prober(i):
        while time.perf_counter() < probe_stop:
            engines["t-lenet-a"].predict(x_dense, timeout=5.0)
            counts[i] += 1

    run_threads([lambda i=i: prober(i) for i in range(len(counts))], [])
    probed = min(500.0, max(50.0, sum(counts) / 0.8))
    mix = {tn: (kind, f * probed) for tn, (kind, f) in TR_MIX.items()}
    dur1, dur2, dur3 = TR_DUR
    res1 = tr_open_loop(fire, schedule([("gold",) + mix["gold"] + (dur1,)],
                                       101))
    lat1 = sorted(l for tg, c, l in res1 if c == 200 and tg[3] > 0.3)
    unloaded = max(s2_pct(lat1, 0.99) or 5.0, 5.0)
    slo = max(1.2 * unloaded, unloaded + 1.5)
    adm.slo_p99_ms = slo
    adm.configure_tenant("gold", slo_p99_ms=slo, share=2.0)
    # observe: the offender crosses unshed; a watcher publishes the tenant
    # gauges and evaluates the alert rules while the overload is live
    monitor.flight_recorder.reset_rate_limit()
    peak, firing, stop = {"ratio": 0.0}, set(), threading.Event()

    def watcher():
        while not stop.is_set():
            publish_tenant_telemetry(adm, "t-lenet-a")
            u = adm.unfairness()
            if u["ratio"] > peak["ratio"]:
                peak.clear()
                peak.update(u)
            if "tenant_unfairness" not in firing:
                for s in alert_eng.evaluate_once():
                    if s["state"] == "firing":
                        firing.add(s["name"])
            stop.wait(0.2)

    wt = threading.Thread(target=watcher, daemon=True)
    wt.start()
    res2 = tr_open_loop(fire, schedule(
        [(tn,) + mix[tn] + (dur2,) for tn in mix], 202))
    stop.set()
    wt.join(WAIT_S)
    gauge = monitor.gauge("serving_tenant_unfairness").value(
        engine="t-lenet-a")
    bundles = sorted(os.listdir(flight_dir))
    alert_bundle = [b for b in bundles if "alert_tenant_unfairness" in b]
    gold2 = sorted(l for tg, c, l in res2 if tg[0] == "gold" and c == 200)
    # enforce: the same mix; the offender's excess goes first
    time.sleep(adm.window_s + 0.3)
    adm.enforce = True
    res3 = tr_open_loop(fire, schedule(
        [(tn,) + mix[tn] + (dur3,) for tn in mix], 303))
    adm.enforce = False
    ramp = dur3 / 3.0
    gold3 = sorted(l for tg, c, l in res3
                   if tg[0] == "gold" and c == 200 and tg[3] > ramp)

    def shed_frac(tenant):
        mine = [c for tg, c, _ in res3 if tg[0] == tenant]
        return (sum(1 for c in mine if c in (429, 503)) / len(mine)
                if mine else 0.0)

    errors = sum(1 for r in (res1, res2, res3) for _, c, _ in r if c == -1)
    admitted = sorted(l for _, c, l in res3 if c == 200)
    res = {"probed_rps": probed, "unloaded_gold_p99_ms": unloaded,
           "slo_p99_ms": slo, "observe_gold_p99_ms": s2_pct(gold2, 0.99),
           "observe_unfairness_peak": peak,
           "unfairness_gauge_after": gauge, "alerts_firing": sorted(firing),
           "alert_bundle": alert_bundle,
           "tenant_slo_violation_bundles": sum(
               "tenant_slo_violation" in b for b in bundles),
           "enforce_gold_p99_ms": s2_pct(gold3, 0.99),
           "enforce_admitted_p99_ms": s2_pct(admitted, 0.99),
           "enforce_shed_fraction": {tn: shed_frac(tn) for tn in mix},
           "errors": errors,
           "requests": [len(res1), len(res2), len(res3)]}
    log(f"[serving_v2] traffic (capacity probe {probed:.0f} rps): gold "
        f"unloaded p99 {unloaded:.2f} ms, SLO {slo:.2f} ms; observe: gold "
        f"p99 {res['observe_gold_p99_ms']} ms, unfairness peak "
        f"{peak.get('ratio')} (victim {peak.get('victim')}, offender "
        f"{peak.get('offender')}), alerts firing {sorted(firing)}, bundle "
        f"{alert_bundle[:1]}; enforce: gold p99 "
        f"{res['enforce_gold_p99_ms']} ms ({(res['enforce_gold_p99_ms'] or 0) / unloaded:.2f}x"
        f" unloaded), admitted p99 {res['enforce_admitted_p99_ms']} ms "
        f"vs SLO {slo:.2f}, shed fraction {res['enforce_shed_fraction']}; "
        f"requests {res['requests']}, errors {errors}")
    sf = res["enforce_shed_fraction"]
    if errors or not (peak["ratio"] > 0 and "tenant_unfairness" in firing
                      and alert_bundle and sf["free"] > 0
                      and sf["free"] > sf["gold"]):
        raise RuntimeError(f"the tenant mix failed its checks: {res}")
    reg.stop_all()
    monitor.alerts.reset()
    return res


def phase_serving_v2(N, A, seed: int) -> tuple:
    """Phase 18, the ``serving_v2`` path: (a) int8, (b) the registry,
    (c) admission.  Returns (models, result) for the deploy path."""
    import tempfile

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.keras.trained_models import vgg16
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.admission import \
        SloAdmissionController
    rng = np.random.RandomState(seed + 18)
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # counts of the serving_v2 path only
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    tmp = tempfile.TemporaryDirectory(prefix="p18_flight_")
    flight = tmp.name
    old_flight = os.environ.get("DL4J_TPU_FLIGHT_DIR")
    os.environ["DL4J_TPU_FLIGHT_DIR"] = flight
    seconds, result = {}, {}
    try:
        t0 = time.perf_counter()
        att = build_net(N, A, seed=seed + 18, n_in=N_IN, hidden=HIDDEN,
                        heads=HEADS, n_out=N_OUT, cache_len=SEQ)
        lenet_net, xt, yt = s2_lenet(seed)
        models = {"attention": att, "lenet": lenet_net,
                  "vgg16": MultiLayerNetwork(vgg16()).init(),
                  "resnet50": ComputationGraph(resnet50()).init(),
                  "char_rnn": char_rnn(N)}
        for name, net in models.items():
            if net._pol().name != "mixed_bf16":
                raise RuntimeError(f"{name} serves under {net._pol().name}")
        seconds["models"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["int8"] = {"attention": s2_int8_attention(att, rng),
                          "lenet": s2_int8_lenet(lenet_net, xt, yt),
                          "vgg16": s2_int8_vgg(models["vgg16"], rng)}
        seconds["int8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        adm = SloAdmissionController(1e4, window_s=1.0, min_samples=30,
                                     refresh_s=0.02, enforce=False)
        reg, engines, result["registry"] = s2_registry(models, adm, rng)
        seconds["registry"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["sweep"] = s2_sweep(reg, adm, rng)
        reg.stop_all()
        for eng in engines.values():
            eng.release_device_buffers()
        del reg, engines
        result["traffic"] = s2_traffic(models, rng, flight)
        seconds["admission"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        if old_flight is None:
            os.environ.pop("DL4J_TPU_FLIGHT_DIR", None)
        else:
            os.environ["DL4J_TPU_FLIGHT_DIR"] = old_flight
        tmp.cleanup()
    torch.cuda.synchronize()
    result["launches"] = dict(A.LAUNCHES)
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    result["seconds"] = dict(seconds, total=time.perf_counter() - t_phase)
    log(f"[serving_v2] launches {result['launches']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; seconds "
        f"{result['seconds']}")
    if any(result["launches"].values()):
        raise RuntimeError("the serving_v2 path launched a flash kernel")
    monitor.reset()
    return models, result


def dp_corrupt(path: str) -> None:
    """Rewrite flat.bin of a snapshot with one byte flipped under its
    (now stale) manifest."""
    import io
    import zipfile
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    data = bytearray(entries["flat.bin"])
    data[len(data) // 2] ^= 0xFF
    entries["flat.bin"] = bytes(data)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for n, b in entries.items():
            zf.writestr(n, b)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def dp_lenet(tmp: str, seed: int) -> dict:
    """(d) LeNet-5 fits at batch 256, a DeploymentListener publishes an
    epoch's weights, a RolloutController canaries each on a held eval set
    while a client sends a constant load; then a garbage version and a
    corrupt zip."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.deploy import (DeploymentListener,
                                                 RolloutController,
                                                 VersionedWeightStore,
                                                 WeightStoreCorruptError)
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    train = MnistDataSetIterator(DP_BATCH, DP_TRAIN)
    test = MnistDataSetIterator(500, S2_LENET_TEST, train=False)
    xt = np.asarray(test._ds.features)
    yt = np.argmax(np.asarray(test._ds.labels), axis=1)
    xe, ye = xt[:DP_EVAL], np.asarray(test._ds.labels)[:DP_EVAL]
    server = MultiLayerNetwork(lenet()).init()
    trainer = MultiLayerNetwork(lenet()).init()
    store = VersionedWeightStore(os.path.join(tmp, "lenet"))
    reg = ModelRegistry()
    eng = reg.register("lenet-deploy", InferenceEngine(
        server, max_batch_size=16, max_latency_ms=2.0,
        name="lenet-deploy"), warmup_shape=(784,))
    alert_eng = monitor.alerts.engine(interval_s=60.0)

    def compiles():
        return monitor.counter("serving_bucket_compiles_total").value(
            engine="lenet-deploy")

    acc0 = float(np.mean(np.argmax(s2_predict_all(eng, xt, 16), 1) == yt))
    c0 = compiles()
    ctl = RolloutController(reg, "lenet-deploy", store, canary_fraction=0.2,
                            eval_features=xe, eval_labels=ye,
                            min_probe_rounds=2)
    stop, stats, failures = threading.Event(), {"ok": 0}, []

    def client():
        i = 0
        while not stop.is_set():
            try:
                reg.predict("lenet-deploy", xt[i % len(xt)][None],
                            timeout=WAIT_S)
                stats["ok"] += 1
            except Exception as e:
                failures.append(repr(e))
            i += 1
            time.sleep(0.001)

    def settle(limit: int = 40) -> list:
        actions = []
        for _ in range(limit):
            alert_eng.evaluate_once()
            a = ctl.step()
            actions.append(a)
            if a in ("promote", "rollback") or (a == "noop"
                                               and ctl.state == "idle"):
                break
        return actions

    ct = threading.Thread(target=client, daemon=True)
    ct.start()
    trainer.set_listeners(DeploymentListener(store, every_n_iterations=0))
    actions, verdicts = [], []
    for _ in range(DP_EPOCHS):
        trainer.fit(train, epochs=1, ingest="batch")
        acts = settle()
        actions += acts
    promotions = actions.count("promote")
    n = trainer.num_params()
    garbage = store.publish(np.random.RandomState(seed).randn(n).astype(
        np.float32) * 100.0, source="garbage")
    g_actions = settle()
    bundle = ctl.last_bundle
    good = store.publish(trainer.get_flat_params(), source="corrupted")
    dp_corrupt(os.path.join(store.directory,
                            "weights-v%010d.zip" % good))
    before = (eng.versions(), eng.active_version, eng.canary_version)
    try:
        ctl.push(good)
        corrupt_raised = False
    except WeightStoreCorruptError:
        corrupt_raised = True
    after = (eng.versions(), eng.active_version, eng.canary_version)
    stop.set()
    ct.join(WAIT_S)
    acc1 = float(np.mean(np.argmax(s2_predict_all(eng, xt, 16), 1) == yt))
    swap = monitor.histogram("deploy_swap_seconds").stats(
        model="lenet-deploy")
    res = {"actions": actions, "promotions": promotions,
           "garbage_version": garbage, "garbage_actions": g_actions,
           "rollback_bundle": bundle, "corrupt_raised": corrupt_raised,
           "versions_unchanged": before == after, "served_ok": stats["ok"],
           "failures": len(failures), "acc_untrained": acc0,
           "acc_served": acc1, "compiles_moved": compiles() - c0,
           "active_version": eng.active_version,
           "deploy_swap_ms": {"count": swap["count"],
                              "p50": swap["p50"] * 1e3,
                              "max": swap["max"] * 1e3},
           "history": ctl.history}
    log(f"[deploy] LeNet-5 rollout: actions {actions}, {promotions} "
        f"promotions (active v{eng.active_version}); garbage v{garbage}: "
        f"{g_actions}, bundle {os.path.basename(bundle or '')}; corrupt zip "
        f"raised {corrupt_raised}, versions unchanged {before == after}; "
        f"client {stats['ok']} answers, {len(failures)} failures; served "
        f"accuracy {acc0:.4f} -> {acc1:.4f}; compiles moved "
        f"{res['compiles_moved']:g}; deploy_swap_seconds p50 "
        f"{res['deploy_swap_ms']['p50']:.3f} ms, max "
        f"{res['deploy_swap_ms']['max']:.3f} ms over {swap['count']}")
    if not (promotions >= 2 and acc1 > acc0 + 0.2 and not failures
            and res["compiles_moved"] == 0 and "rollback" in g_actions
            and bundle and os.path.isdir(bundle)
            and "rollout_rollback" in bundle and corrupt_raised
            and before == after):
        raise RuntimeError(f"the LeNet-5 rollout failed its checks: "
                           f"{ {k: v for k, v in res.items() if k != 'history'} }"
                           f" failures {failures[:3]}")
    reg.stop_all()
    return res


def dp_attention(N, A, tmp: str, seed: int) -> dict:
    """(d) the attention net at full width: its own fit step publishes a
    version, the rollout promotes it; a decode session opened before the
    promote keeps its pinned version, bitwise an engine that holds only
    the old weights; a session opened after uses the new one."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.deploy import (DeploymentListener,
                                                 RolloutController,
                                                 VersionedWeightStore)
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)

    def net():
        return build_net(N, A, seed=seed + 19, n_in=N_IN, hidden=HIDDEN,
                         heads=HEADS, n_out=N_OUT, cache_len=SEQ)

    server, trainer, old = net(), net(), net()
    for other in (trainer, old):
        other.set_flat_params(server.get_flat_params())
    rng = np.random.RandomState(seed + 19)
    x = rng.randn(1, S2_PREFILL + 2 * S2_DECODE_TOKENS, N_IN).astype(
        np.float32)
    store = VersionedWeightStore(os.path.join(tmp, "attention"))
    reg = ModelRegistry()
    opts = dict(max_batch_size=2, timestep_buckets=SERVE_BUCKETS,
                max_latency_ms=2.0)
    eng = reg.register("att-deploy", InferenceEngine(
        server, name="att-deploy", **opts), warmup_shape=(SEQ, N_IN))
    ref = InferenceEngine(old, name="att-old", **opts).start()
    gauge = monitor.gauge("serving_session_version_pinned")
    mism = []

    def both(sid, xs):
        a, b = eng.predict_session(sid, xs), ref.predict_session(sid, xs)
        if not np.array_equal(a, b):
            mism.append((sid, float(np.abs(a - b).max())))

    both("old", x[:, :S2_PREFILL])
    ds = make_batch(seed + 19, BATCH, SEQ, N_IN, N_OUT)
    trainer.set_listeners(DeploymentListener(store, every_n_iterations=1,
                                             publish_on_epoch_end=False))
    trainer.fit(ds)
    fit_steps = trainer.iteration
    ctl = RolloutController(reg, "att-deploy", store,
                            eval_features=rng.randn(
                                2, SERVE_BUCKETS[0], N_IN).astype(
                                np.float32),
                            min_agreement=0.0, min_probe_rounds=1)
    actions = [ctl.step(), ctl.step()]
    pinned_after_promote = gauge.value(model="att-deploy")
    for t in range(S2_PREFILL, S2_PREFILL + S2_DECODE_TOKENS):
        both("old", x[:, t])
    old_version = eng.sessions.session_version("old")
    snap = store.load(store.latest())
    new = net()
    new.set_flat_params(snap.flat)
    with InferenceEngine(new, name="att-new", **opts) as new_eng:
        a = eng.predict_session("new", x[:, :S2_PREFILL])
        b = new_eng.predict_session("new", x[:, :S2_PREFILL])
        new_equal = bool(np.array_equal(a, b))
        moved = float(np.abs(a - ref.predict_session(
            "probe", x[:, :S2_PREFILL])).max())
    new_version = eng.sessions.session_version("new")
    eng.sessions.clear("old")
    pinned_after_close = gauge.value(model="att-deploy")
    ref.stop()
    res = {"fit_steps": fit_steps, "published": store.versions(),
           "actions": actions, "active_version": eng.active_version,
           "old_session_version": old_version,
           "new_session_version": new_version,
           "old_session_bitwise": not mism, "mismatches": mism,
           "new_session_bitwise": new_equal,
           "new_vs_old_max_abs": moved,
           "pinned_gauge": [pinned_after_promote, pinned_after_close]}
    log(f"[deploy] attention net: {fit_steps} fit step(s) published "
        f"{store.versions()}; rollout {actions} (active "
        f"v{eng.active_version}); the session opened before the promote "
        f"stays on v{old_version}, bitwise the old-weights engine over "
        f"{S2_DECODE_TOKENS} more tokens: {not mism}; a new session on "
        f"v{new_version}, bitwise the new weights: {new_equal} (moved "
        f"{moved:.2e} from the old); serving_session_version_pinned "
        f"{pinned_after_promote:g} -> {pinned_after_close:g}")
    if not (actions == ["push", "promote"] and not mism and new_equal
            and old_version == 0 and new_version == eng.active_version == 1
            and pinned_after_promote == 1 and pinned_after_close == 0
            and moved > 0):
        raise RuntimeError(f"the attention rollout failed its checks: "
                           f"{res}")
    reg.stop_all()
    return res


def phase_deploy(N, A, seed: int) -> dict:
    """Phase 18, the ``deploy`` path: (d) the LeNet-5 rollout and the
    attention net's pinned sessions across a promote (K1-K3 launch once
    per attention fit step, K4 never)."""
    import tempfile

    from deeplearning4j_tpu_torch import monitor
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor.reset()
    A.reset_launches()            # counts of the deploy path only
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    old_flight = os.environ.get("DL4J_TPU_FLIGHT_DIR")
    result = {}
    try:
        with tempfile.TemporaryDirectory(prefix="p18_deploy_") as tmp:
            os.environ["DL4J_TPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
            result["lenet"] = dp_lenet(tmp, seed)
            result["attention"] = dp_attention(N, A, tmp, seed)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        if old_flight is None:
            os.environ.pop("DL4J_TPU_FLIGHT_DIR", None)
        else:
            os.environ["DL4J_TPU_FLIGHT_DIR"] = old_flight
        monitor.alerts.reset()
    torch.cuda.synchronize()
    result["launches"] = dict(A.LAUNCHES)
    result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    result["seconds"] = time.perf_counter() - t_phase
    steps = result["attention"]["fit_steps"]
    expected = {"flash_fwd": steps, "flash_fwd_partials": 0,
                "flash_bwd_dkdv": steps, "flash_bwd_dq": steps}
    log(f"[deploy] launches {result['launches']} (expected {expected}); "
        f"peak memory {result['peak_mem_bytes'] / 2**30:.3f} GiB; "
        f"{result['seconds']:.1f} s")
    if result["launches"] != expected:
        raise RuntimeError(f"deploy path launches {result['launches']}, "
                           f"expected {expected}")
    return result


# ---- phase 19: the serving fleet (A8's rest) --------------------------------

FL_MODEL = "lstm"            # FLEET_SPECS["lstm"]: 2 x GravesLSTM(256)
FL_SPAWN_S = 60.0            # wait_ready bound: a hung worker fails fast
FL_CAL_STEPS, FL_CAL_SESSIONS = 20, 4
FL_LAT_N = 100               # sequential requests a side, HTTP vs in-process
FL_PROBE_S, FL_PROBE_THREADS = 1.5, 4
FL_LOAD_S, FL_SESSIONS = 5.0, 32          # bench_fleet --smoke
FL_KILL_AT_S, FL_KILL_AFTER_S = 1.0, 2.0
FL_CANARY = (0.05, 0.25, 0.5, 1.0)
FL_CANARY_TICK_S = 0.3
FL_DRAIN_S = 60.0


def fl_post(url: str, payload: dict, timeout: float = 15.0) -> tuple:
    """``POST /predict``: (status, body); status -1 on a transport
    error."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url + "/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode() or "{}")
        except ValueError:
            return e.code, {}
    except Exception:
        return -1, {}


def fl_metric(url: str, name: str) -> float:
    """Sum of one series of a server's ``/metrics``."""
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=10.0) as resp:
        text = resp.read().decode()
    return sum(float(line.rsplit(" ", 1)[-1]) for line in text.splitlines()
               if line.startswith(name + " ") or line.startswith(name + "{"))


def fl_pct(ms: List[float], q: float):
    ms = sorted(ms)
    return ms[min(len(ms) - 1, int(q * len(ms)))] if ms else None


def fl_open_loop(fire, offered_qps: float, duration_s: float, seed: int,
                 pool_size: int = 64) -> dict:
    """``bench.py``'s open-loop generator: Poisson arrivals fixed up
    front, each latency measured from its scheduled arrival; 200 admitted,
    429/503 shed, -1 (no answer within ``fl_post``'s timeout, or never
    sent) unanswered, anything else an error.  Rates are over the
    window's wall time, from the first arrival to the last answer: when
    the pool or this process's GIL holds requests back, the window
    stretches past ``duration_s`` and the send lag (each request's send
    time past its scheduled arrival) says by how much, and the load was
    no longer open.  Also the host CPU seconds this process spent over
    the window (router, client and server threads share its GIL)."""
    rng = np.random.RandomState(seed)
    arrivals, t = [], rng.exponential(1.0 / offered_qps)
    while t < duration_s:
        arrivals.append(t)
        t += rng.exponential(1.0 / offered_qps)
    results, rec, nxt, cursor = [], threading.Lock(), threading.Lock(), [0]
    cpu0, start = os.times(), time.perf_counter()

    def runner():
        while True:
            with nxt:
                i = cursor[0]
                if i >= len(arrivals):
                    return
                cursor[0] = i + 1
            delay = arrivals[i] - (time.perf_counter() - start)
            if delay > 0:
                time.sleep(delay)
            late = (time.perf_counter() - start) - arrivals[i]
            code = fire()
            lat = (time.perf_counter() - start) - arrivals[i]
            with rec:
                results.append((code, lat, late))

    pool = [threading.Thread(target=runner, daemon=True)
            for _ in range(min(pool_size, len(arrivals) or 1))]
    for th in pool:
        th.start()
    for th in pool:
        th.join(timeout=120.0)
    wall = time.perf_counter() - start
    cpu1 = os.times()
    with rec:
        results = list(results)
    admitted = [lat * 1e3 for code, lat, _ in results if code == 200]
    shed = sum(1 for code, _, _ in results if code in (429, 503))
    # -1: no answer in time; a request still unsent when the pool's
    # threads were given up on never had one
    unanswered = (sum(1 for code, _, _ in results if code == -1)
                  + len(arrivals) - len(results))
    late_ms = [late * 1e3 for _, _, late in results]
    codes: Dict[int, int] = {}
    for code, _, _ in results:
        codes[code] = codes.get(code, 0) + 1
    return {"offered": len(arrivals), "codes": codes,
            "offered_qps": len(arrivals) / duration_s,
            "admitted": len(admitted), "shed": shed,
            "unanswered": unanswered,
            "shed_fraction": shed / max(1, len(arrivals)),
            "errors": len(arrivals) - len(admitted) - shed,
            "admitted_rps": len(admitted) / wall,
            "p50_ms": fl_pct(admitted, 0.50),
            "p99_ms": fl_pct(admitted, 0.99),
            "send_lag_p50_ms": fl_pct(late_ms, 0.50),
            "send_lag_p99_ms": fl_pct(late_ms, 0.99),
            "host_cpu_s": (cpu1.user - cpu0.user) + (cpu1.system
                                                     - cpu0.system),
            "nominal_s": duration_s, "wall_s": wall}


def fl_probe(url: str, step_row: list) -> float:
    """Closed-loop capacity: admitted session steps a second from
    FL_PROBE_THREADS clients over FL_PROBE_S."""
    counts, stop_at = [0] * FL_PROBE_THREADS, \
        time.perf_counter() + FL_PROBE_S

    def probe(i):
        j = i
        while time.perf_counter() < stop_at:
            if fl_post(url, {"model": "fleet",
                             "session": f"conv-{j % FL_SESSIONS}",
                             "features": step_row})[0] == 200:
                counts[i] += 1
            j += FL_PROBE_THREADS

    threads = [threading.Thread(target=probe, args=(i,))
               for i in range(FL_PROBE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return sum(counts) / FL_PROBE_S


def fl_router_class():
    """``FleetRouter`` that records every worker process it starts, so
    the teardown can check each was reaped, and every exit line its
    workers print (``reports``: their hand-kernel launches)."""
    from deeplearning4j_tpu_torch.serving.fleet import FleetRouter

    class TrackedRouter(FleetRouter):
        spawned: List = []
        reports: List = []

        def stop(self):
            super().stop()
            TrackedRouter.reports.extend(self.exit_reports)

        def _spawn(self, rank):
            proc = super()._spawn(rank)
            TrackedRouter.spawned.append(proc)
            return proc
    return TrackedRouter


def fl_respawn(common: dict, spawned: list, reports: list) -> tuple:
    """(a) One worker against an empty namespace, terminated (its exit
    line into ``reports``); then its replacement in the same namespace,
    kept as the warm worker."""
    from deeplearning4j_tpu_torch.serving.fleet import (WorkerHandle,
                                                        spawn_worker,
                                                        wait_ready)
    ready, warm = [], None
    for i in range(2):
        proc = spawn_worker(0, **common)
        spawned.append(proc)
        handle = WorkerHandle(0, proc, wait_ready(proc, FL_SPAWN_S))
        handle.start_drains()
        ready.append(handle.ready)
        log(f"[fleet] {('cold', 'warm')[i]} spawn ready line: "
            f"{json.dumps(handle.ready)}")
        if i == 0:
            reports.append(handle.terminate())
        else:
            warm = handle
    return warm, ready


def fl_serving(warm, common: dict, store, rng) -> dict:
    """(b) Session steps and the two smallest timestep buckets through the
    warm worker's ``POST /predict``: all 200, no bucket callable made
    after warmup, the answers those of an in-process engine on the same
    store weights; then /predict p50/p99 through HTTP beside the engine's
    in-process p50/p99."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    from deeplearning4j_tpu_torch.serving.fleet import (FLEET_SPECS,
                                                        build_fleet_conf)
    spec = FLEET_SPECS[common["model"]]
    conf, kw, warm_shape = build_fleet_conf(common["model"])
    ref = InferenceEngine(MultiLayerNetwork(conf, device=common["device"])
                          .init(), max_latency_ms=2.0, name="fleet-ref",
                          **kw).start()
    try:
        ref.warm_from_store(store)
        ref.warmup(warm_shape)
        url = warm.url
        c0 = fl_metric(url, "serving_bucket_compiles_total")
        rows = rng.randn(FL_CAL_STEPS, 1, spec["n_in"]).astype(np.float32)
        seqs = [rng.randn(1, tb, spec["n_in"]).astype(np.float32)
                for tb in spec["timestep_buckets"][:2]]
        codes, cal_ms, diffs = [], [], []
        for i in range(FL_CAL_STEPS):
            sid = f"cal-{i % FL_CAL_SESSIONS}"
            t0 = time.perf_counter()
            code, body = fl_post(url, {"model": "fleet", "session": sid,
                                       "features": rows[i].tolist()})
            cal_ms.append((time.perf_counter() - t0) * 1e3)
            codes.append(code)
            want = ref.predict_session(sid, rows[i])
            diffs.append(float(np.max(np.abs(
                np.asarray(body.get("output", np.nan), np.float32)
                - want))))
        for seq in seqs:
            code, body = fl_post(url, {"model": "fleet",
                                       "features": seq.tolist()})
            codes.append(code)
            diffs.append(float(np.max(np.abs(
                np.asarray(body.get("output", np.nan), np.float32)
                - ref.predict(seq)))))
        c1 = fl_metric(url, "serving_bucket_compiles_total")
        http_ms, local_ms = [], []
        for _ in range(FL_LAT_N):
            t0 = time.perf_counter()
            code, _ = fl_post(url, {"model": "fleet",
                                    "features": seqs[0].tolist()})
            http_ms.append((time.perf_counter() - t0) * 1e3)
            codes.append(code)
        for _ in range(FL_LAT_N):
            t0 = time.perf_counter()
            ref.predict(seqs[0])
            local_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ref.stop()
    res = {"codes_200": sum(c == 200 for c in codes),
           "requests": len(codes),
           "bucket_compiles": [c0, c1],
           "after_warmup_ready": warm.ready["bucket_compiles_after_warmup"],
           "max_abs_diff": max(diffs), "bitwise": max(diffs) == 0.0,
           "cal_p50_ms": fl_pct(cal_ms, 0.5),
           "http_p50_ms": fl_pct(http_ms, 0.5),
           "http_p99_ms": fl_pct(http_ms, 0.99),
           "in_process_p50_ms": fl_pct(local_ms, 0.5),
           "in_process_p99_ms": fl_pct(local_ms, 0.99)}
    log(f"[fleet] serving after warmup: {res['codes_200']}/"
        f"{res['requests']} answered 200; serving_bucket_compiles_total "
        f"{c0:g} -> {c1:g} (ready line {res['after_warmup_ready']:g}); "
        f"answers vs the in-process engine max|diff| "
        f"{res['max_abs_diff']:.3e} (bitwise {res['bitwise']}); /predict "
        f"T={spec['timestep_buckets'][0]} p50/p99 through HTTP "
        f"{res['http_p50_ms']:.3f}/{res['http_p99_ms']:.3f} ms, in process "
        f"{res['in_process_p50_ms']:.3f}/{res['in_process_p99_ms']:.3f} ms")
    if not (res["codes_200"] == len(codes) and c1 == c0
            and c0 == res["after_warmup_ready"]
            and res["max_abs_diff"] <= FL_ATOL):
        raise RuntimeError(f"fleet serving after warmup failed: {res}")
    return res


FL_ATOL = 1e-5       # the expected gap is 0: the same card, the same ops


def fl_failover(router, url: str, step_row: list) -> dict:
    """(d) SIGKILL a session's home worker under a closed-loop session
    load of 2 clients: no 5xx (no non-200 at all), the victim back at its
    rank, the session home again."""
    import signal
    sessions = [f"fo-{i}" for i in range(8)]
    home = router.pick(sessions[0]).name
    victim = router._workers[home]
    codes, refusals, stop = [], [], threading.Event()

    def client(i):
        j = i
        while not stop.is_set():
            code, body = fl_post(url, {"model": "fleet",
                                       "session": sessions[j % 8],
                                       "features": step_row})
            codes.append(code)
            if code != 200:       # what answered, for the failure's record
                refusals.append(f"{code} shed={body.get('shed')} "
                                f"{str(body.get('error'))[:80]}")
            j += 2

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    time.sleep(FL_KILL_AT_S)
    os.kill(victim.proc.pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    time.sleep(FL_KILL_AFTER_S)
    stop.set()
    for th in threads:
        th.join(timeout=30.0)
    respawn_s = None
    while time.perf_counter() - t_kill < FL_SPAWN_S + 10.0:
        h = router._workers.get(home)
        if h is not None and h.generation > 0 and h.healthy:
            respawn_s = time.perf_counter() - t_kill
            break
        time.sleep(0.1)
    back = router._workers.get(home)
    code_home = fl_post(url, {"model": "fleet", "session": sessions[0],
                              "features": step_row})[0]
    res = {"victim": home, "victim_pid": victim.proc.pid,
           "requests": len(codes), "non_200": sum(c != 200 for c in codes),
           "5xx": sum(c >= 500 for c in codes),
           "transport_errors": sum(c == -1 for c in codes),
           "refusals": dict(collections.Counter(refusals)),
           "respawn_s": respawn_s,
           "generation": back.generation if back else None,
           "home_again": router.pick(sessions[0]).name == home,
           "code_after": code_home,
           "ready": back.ready if back else None}
    log(f"[fleet] failover: SIGKILL {home} (pid {victim.proc.pid}) under "
        f"{len(codes)} session requests: {res['non_200']} non-200, "
        f"{res['5xx']} 5xx; respawned at its rank in {respawn_s} s "
        f"(generation {res['generation']}), session home again "
        f"{res['home_again']} ({code_home})")
    if not (res["non_200"] == 0 and respawn_s is not None
            and res["home_again"] and code_home == 200):
        raise RuntimeError(f"fleet failover failed: {res}")
    return res


def fl_failover_fleet(common: dict, Router, step_row: list) -> dict:
    """(d) on a K=2 fleet of its own whose workers hold no SLO, as the
    reference's live test runs it (``tests/test_fleet.py``
    ``test_live_fleet_affinity_sigkill_failover``).  A worker that holds
    an SLO answers a breach of its p99 with a shed (503, ``shed``) by
    design, and a SIGKILL beside it on the shared card can breach it:
    that answer is the admission controller's, which (c) measures, not
    the router's failover, which must cost no non-200 at all."""
    router = Router(2, slo_p99_ms=None, health_interval_s=0.25,
                    spawn_timeout_s=FL_SPAWN_S, **common)
    router.start()
    ui = router.serve()
    try:
        healthy = router.status()["healthy"]
        if healthy != 2:
            raise RuntimeError(f"failover fleet: status()['healthy'] = "
                               f"{healthy}")
        ready = [h.ready for h in router._workers.values()]
        res = fl_failover(router, f"http://127.0.0.1:{ui.port}", step_row)
        if router.status()["healthy"] != 2:
            raise RuntimeError("K=2 not whole after the respawn")
        res["fleet_ready"] = ready
        return res
    finally:
        ui.stop()
        router.stop()


def fl_canary(router, url: str, seq: list) -> dict:
    """(e) On the live K=2 fleet under sessionless load: a FleetCanary
    ramps w1 through FL_CANARY to done (w1's share of sessionless traffic
    at each notch); a second one with its p99 limit at half the router's
    windowed p99 aborts back to fraction 0."""
    from deeplearning4j_tpu_torch.deploy import FleetCanary
    stop, codes = threading.Event(), []

    def client():
        while not stop.is_set():
            codes.append(fl_post(url, {"model": "fleet",
                                       "features": seq})[0])

    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        c1 = FleetCanary(router, "w1", schedule=FL_CANARY)
        actions, shares = [], []
        for _ in range(len(FL_CANARY) + 2):
            act = c1.step()
            actions.append(act)
            if act != "ramp":
                break
            time.sleep(FL_CANARY_TICK_S)
            served = {n: h.served for n, h in router._workers.items()}
            shares.append(served.get("w1", 0) / max(1, sum(served.values())))
        observed = router.window_p99_ms()
        c2 = FleetCanary(router, "w1", schedule=(0.05, 1.0),
                         max_p99_ms=0.5 * observed)
        abort = c2.step()
        fraction_after = router._workers["w1"].route_fraction
    finally:
        stop.set()
        th.join(timeout=30.0)
    res = {"actions": actions, "w1_shares": shares,
           "window_p99_ms": observed, "abort_limit_ms": 0.5 * observed,
           "second": abort, "fraction_after_abort": fraction_after,
           "requests": len(codes), "non_200": sum(c != 200 for c in codes),
           "codes": {c: codes.count(c) for c in sorted(set(codes))}}
    log(f"[fleet] canary on K=2: {actions}, w1's sessionless share at "
        f"each notch {[round(s, 3) for s in shares]}; a second canary "
        f"with max_p99 {0.5 * observed:.2f} ms (router p99 "
        f"{observed:.2f}) -> {abort}, w1 fraction {fraction_after}; "
        f"{len(codes)} requests, {res['non_200']} non-200 (codes "
        f"{res['codes']})")
    if not (actions == ["ramp"] * len(FL_CANARY) + ["done"]
            and abort == "abort" and fraction_after == 0.0):
        raise RuntimeError(f"fleet canary failed: {res}")
    return res


def fl_fleets(common: dict, Router, step_row: list, seq: list,
              slo_p99_ms: float) -> dict:
    """(c) K=1 then K=3 behind ``FleetRouter.serve()`` under the same
    open-loop Poisson session load (the rate fixed at 2.5x the K=1
    closed-loop capacity, at least 20 rps); (e) the canaries on the K=3
    fleet scaled in to K=2."""
    import itertools
    res, offered = {}, None

    def fire_for(url):
        counter = itertools.count()

        def fire():
            j = next(counter) % FL_SESSIONS
            return fl_post(url, {"model": "fleet", "session": f"conv-{j}",
                                 "features": step_row})[0]
        return fire

    for k in (1, 3):
        t0 = time.perf_counter()
        router = Router(k, slo_p99_ms=slo_p99_ms,
                        health_interval_s=0.25 if k == 3 else 1.0,
                        spawn_timeout_s=FL_SPAWN_S, **common)
        router.start()
        start_s = time.perf_counter() - t0
        ui = router.serve()
        url = f"http://127.0.0.1:{ui.port}"
        try:
            healthy = router.status()["healthy"]
            ready = [h.ready for h in router._workers.values()]
            log(f"[fleet] K={k}: {healthy} of {k} workers ready in "
                f"{start_s:.1f} s on {sorted({r['device'] for r in ready})}")
            if healthy != k:
                raise RuntimeError(f"K={k}: status()['healthy'] = "
                                   f"{healthy}")
            out = {"start_s": start_s, "ready": ready}
            # an ill-shaped session step answers 400 and marks no worker
            # down (the router fails over on transport errors only)
            code, body = fl_post(url, {"model": "fleet", "session": "bad",
                                       "features": [step_row[0][:-1]]})
            out["ill_shaped"] = {"code": code,
                                 "healthy": router.status()["healthy"]}
            log(f"[fleet] K={k}: an ill-shaped session step answers {code} "
                f"({body.get('error')}); {out['ill_shaped']['healthy']} of "
                f"{k} workers healthy")
            if out["ill_shaped"] != {"code": 400, "healthy": k}:
                raise RuntimeError(
                    f"K={k}: ill-shaped step {out['ill_shaped']}")
            out["closed_loop_rps"] = fl_probe(url, step_row)
            if k == 1:
                offered = max(20.0, 2.5 * out["closed_loop_rps"])
            log(f"[fleet] K={k} closed-loop probe: "
                f"{out['closed_loop_rps']:.1f} rps over {FL_PROBE_S} s "
                f"with {FL_PROBE_THREADS} threads; offered rate "
                f"{offered:.1f} rps")
            load = fl_open_loop(fire_for(url), offered, FL_LOAD_S, seed=k)
            load["workers_healthy"] = router.status()["healthy"]
            out["load"] = load
            log(f"[fleet] K={k} open loop {FL_LOAD_S} s of arrivals at "
                f"{load['offered_qps']:.1f} rps over {FL_SESSIONS} sessions, "
                f"answered over {load['wall_s']:.2f} s of wall time: "
                f"admitted {load['admitted']} = {load['admitted_rps']:.1f} "
                f"rps, p50/p99 {load['p50_ms']}/{load['p99_ms']} ms from "
                f"the scheduled arrival, send lag p50/p99 "
                f"{load['send_lag_p50_ms']}/{load['send_lag_p99_ms']} ms, "
                f"shed fraction {load['shed_fraction']:.3f}, unanswered "
                f"{load['unanswered']}, errors {load['errors']} "
                f"(codes {load['codes']}), "
                f"workers_healthy {load['workers_healthy']}; this process "
                f"(router, clients) used {load['host_cpu_s']:.2f} CPU s")
            if k == 3:
                victim = router.scale_in()
                out["scaled_in"] = victim
                out["canary"] = fl_canary(router, url, seq)
            out["status"] = {key: router.status()[key]
                             for key in ("healthy", "ring", "scale_events",
                                         "window_p99_ms")}
            res[k] = out
        finally:
            ui.stop()
            router.stop()
    res["offered_qps"] = offered
    # neither ratio is the fleet's capacity: the open loop's admitted
    # rates are set by the workers' SLO controllers and, like the closed
    # loop's, by this process's GIL (router and clients)
    res["speedup_x"] = (res[3]["load"]["admitted_rps"]
                        / max(res[1]["load"]["admitted_rps"], 1e-9))
    res["closed_loop_speedup_x"] = (res[3]["closed_loop_rps"]
                                    / max(res[1]["closed_loop_rps"], 1e-9))
    log(f"[fleet] K=3 vs K=1: open loop admitted (over wall time) "
        f"{res[3]['load']['admitted_rps']:.1f} / "
        f"{res[1]['load']['admitted_rps']:.1f} = speedup_x "
        f"{res['speedup_x']:.2f} (SLO shedding); closed loop "
        f"{res[3]['closed_loop_rps']:.1f} / {res[1]['closed_loop_rps']:.1f}"
        f" = {res['closed_loop_speedup_x']:.2f}x (this process's GIL)")
    return res


def fl_deploy_http(tmp: str, device: str, train_n: int = DP_TRAIN) -> dict:
    """(f) ``bench_deploy``'s HTTP half on LeNet-5: a ``fit`` publishes an
    epoch's weights while a client loads ``POST /predict`` and an operator
    loop drives ``POST /deploy/lenet {"action": "step"}`` through the
    port's UIServer (``attach_registry`` + ``attach_deployment``): at
    least 2 promotions, 0 5xx; then a corrupt snapshot pushed over HTTP is
    refused with a 4xx and the engine unchanged."""
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    from deeplearning4j_tpu_torch.deploy import (DeploymentListener,
                                                 RolloutController,
                                                 VersionedWeightStore)
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    from deeplearning4j_tpu_torch.ui import UIServer
    train = MnistDataSetIterator(DP_BATCH, train_n)
    test = MnistDataSetIterator(500, S2_LENET_TEST, train=False)
    xt = np.asarray(test._ds.features)
    yt = np.argmax(np.asarray(test._ds.labels), axis=1)
    xe, ye = xt[:DP_EVAL], np.asarray(test._ds.labels)[:DP_EVAL]
    server = MultiLayerNetwork(lenet(), device=device).init()
    trainer = MultiLayerNetwork(lenet(), device=device).init()
    store = VersionedWeightStore(os.path.join(tmp, "lenet-http"))
    reg = ModelRegistry()
    eng = reg.register("lenet", InferenceEngine(
        server, max_batch_size=16, max_latency_ms=2.0, name="lenet"),
        warmup_shape=(784,))
    ctl = RolloutController(reg, "lenet", store, canary_fraction=0.2,
                            eval_features=xe, eval_labels=ye,
                            min_probe_rounds=2)
    ui = UIServer(port=0).attach_registry(reg).attach_deployment(ctl)
    ui.start()
    base = f"http://127.0.0.1:{ui.port}"

    def compiles():
        return monitor.counter("serving_bucket_compiles_total").value(
            engine="lenet")

    def deploy(payload):
        req = urllib.request.Request(
            base + "/deploy/lenet", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode() or "{}")

    acc0 = float(np.mean(np.argmax(s2_predict_all(eng, xt, 16), 1) == yt))
    c0 = compiles()
    client_codes, step_codes, actions = {}, {}, []
    stop, stop_roller = threading.Event(), threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            code = fl_post(base, {"model": "lenet",
                                  "features": xt[i % len(xt)][None]
                                  .tolist()})[0]
            client_codes[code] = client_codes.get(code, 0) + 1
            i += 1
            time.sleep(0.002)

    def roller():
        while not stop_roller.is_set():
            code, body = deploy({"action": "step"})
            step_codes[code] = step_codes.get(code, 0) + 1
            if body.get("action") not in (None, "noop"):
                actions.append(body["action"])
            time.sleep(0.01)

    def drain():
        deadline = time.perf_counter() + FL_DRAIN_S
        while time.perf_counter() < deadline:
            head = store.latest()
            if ctl.state == "idle" and head is not None and (
                    eng.active_version >= head or head in ctl.quarantined):
                return
            time.sleep(0.05)

    threads = [threading.Thread(target=client, daemon=True),
               threading.Thread(target=roller, daemon=True)]
    for th in threads:
        th.start()
    try:
        trainer.set_listeners(DeploymentListener(store,
                                                 every_n_iterations=0))
        for _ in range(DP_EPOCHS):
            trainer.fit(train, epochs=1, ingest="batch")
            drain()
        stop_roller.set()
        threads[1].join(timeout=30.0)
        promotions = sum(1 for h in ctl.history if h["action"] == "promote")
        bad = store.publish(trainer.get_flat_params(), source="corrupted")
        dp_corrupt(os.path.join(store.directory, "weights-v%010d.zip" % bad))
        before = (eng.versions(), eng.active_version, eng.canary_version)
        corrupt_code, corrupt_body = deploy({"action": "push",
                                             "version": bad})
        after = (eng.versions(), eng.active_version, eng.canary_version)
    finally:
        stop.set()
        stop_roller.set()
        for th in threads:
            th.join(timeout=30.0)
        ui.stop()
    acc1 = float(np.mean(np.argmax(s2_predict_all(eng, xt, 16), 1) == yt))
    moved = compiles() - c0
    reg.stop_all()
    n5xx = sum(v for c, v in list(client_codes.items())
               + list(step_codes.items()) if c >= 500 or c == -1)
    res = {"promotions": promotions, "actions": actions,
           "client_codes": client_codes, "step_codes": step_codes,
           "5xx": n5xx, "corrupt_code": corrupt_code,
           "corrupt_flag": corrupt_body.get("corrupt"),
           "engine_unchanged": before == after, "acc_untrained": acc0,
           "acc_served": acc1, "compiles_moved": moved,
           "active_version": eng.active_version}
    log(f"[fleet] deploy over HTTP: {promotions} promotions ({actions}); "
        f"client codes {client_codes}, /deploy step codes {step_codes}: "
        f"{n5xx} 5xx; corrupt v{bad} pushed over HTTP -> {corrupt_code} "
        f"(corrupt {res['corrupt_flag']}), engine unchanged "
        f"{before == after}; served accuracy {acc0:.4f} -> {acc1:.4f}; "
        f"compiles moved {moved:g}")
    if not (promotions >= 2 and n5xx == 0 and 400 <= corrupt_code < 500
            and before == after and moved == 0 and acc1 > acc0 + 0.2):
        raise RuntimeError(f"deploy over HTTP failed: {res}")
    return res


def phase_fleet(A, seed: int, device: str = "cuda", model: str = FL_MODEL,
                lenet_train: int = DP_TRAIN) -> dict:
    """Phase 19, the ``fleet`` path: (a) respawn, (b) serving after
    warmup through HTTP, (c) K=1 vs K=3, (d) failover on a K=2 fleet
    without an SLO, (e) FleetCanary,
    (f) deploy over HTTP, (g) every worker reaped.  The fleet's model
    launches no hand kernel; the LeNet-5 of (f) neither."""
    import tempfile

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.deploy import VersionedWeightStore
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving.fleet import (FLEET_SPECS,
                                                        build_fleet_conf)
    t_phase = time.perf_counter()
    monitor.reset()
    A.reset_launches()            # counts of the fleet path only
    rng = np.random.RandomState(seed + 19)
    spec = FLEET_SPECS[model]
    Router = fl_router_class()
    spawned: List = Router.spawned
    reports: List = Router.reports
    old_flight = os.environ.get("DL4J_TPU_FLIGHT_DIR")
    result, warm = {}, None
    tmp = tempfile.TemporaryDirectory(prefix="p19_fleet_")
    try:
        os.environ["DL4J_TPU_FLIGHT_DIR"] = os.path.join(tmp.name, "flight")
        conf, _, _ = build_fleet_conf(model, seed=seed + 19)
        net = MultiLayerNetwork(conf, device=device).init()
        store = VersionedWeightStore(os.path.join(tmp.name, "store"))
        result["store_version"] = store.publish_model(net, source="p19")
        result["params"] = net.num_params()
        del net
        common = dict(model=model, store_dir=store.directory,
                      cache_root=os.path.join(tmp.name, "cache"),
                      device=device)
        warm, result["respawn"] = fl_respawn(common, spawned, reports)
        result["serving"] = fl_serving(warm, common, store, rng)
        reports.append(warm.terminate())
        slo = max(50.0, 10.0 * result["serving"]["cal_p50_ms"])
        step_row = rng.randn(1, spec["n_in"]).round(4).tolist()
        seq = rng.randn(1, spec["timestep_buckets"][0],
                        spec["n_in"]).round(4).tolist()
        result["slo_p99_ms"] = slo
        result["fleets"] = fl_fleets(common, Router, step_row, seq, slo)
        result["failover"] = fl_failover_fleet(common, Router, step_row)
        result["deploy_http"] = fl_deploy_http(tmp.name, device,
                                               lenet_train)
    finally:
        if warm is not None:
            warm.terminate()
        for proc in spawned:        # (g) terminate and reap every worker
            if proc.poll() is None:
                proc.terminate()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        alive = [p.pid for p in spawned if p.poll() is None]
        for p in spawned:
            try:
                os.kill(p.pid, 0)
                alive.append(p.pid)
            except ProcessLookupError:
                pass
        if old_flight is None:
            os.environ.pop("DL4J_TPU_FLIGHT_DIR", None)
        else:
            os.environ["DL4J_TPU_FLIGHT_DIR"] = old_flight
        tmp.cleanup()
    result["workers_spawned"] = len(spawned)
    result["pids"] = [p.pid for p in spawned]
    readies = (result["respawn"] + result["fleets"][1]["ready"]
               + result["fleets"][3]["ready"]
               + result["failover"]["fleet_ready"]
               + [result["failover"]["ready"]])
    devices = sorted({r["device"] for r in readies})
    result["devices"] = devices
    if alive:
        raise RuntimeError(f"fleet workers still alive: {alive}")
    if device == "cuda" and not all(d.startswith("cuda:") for d in devices):
        raise RuntimeError(f"a fleet worker not on the card: {devices}")
    # the path's launches: this process's (the router, the in-process
    # engines of (b) and (f)) and each worker's from its exit line.  The
    # SIGKILLed worker cannot report, nor can one the router's health
    # tick replaced and had to kill; those are listed
    reports = [r for r in reports if r is not None]
    killed = result["failover"]["victim_pid"]
    unreported = sorted({p.pid for p in spawned}
                        - {r["pid"] for r in reports})
    if killed not in unreported or len(unreported) == len(spawned):
        raise RuntimeError(f"worker exit lines do not add up: unreported "
                           f"{unreported}, SIGKILLed {killed}")
    result["launches_front_door"] = dict(A.LAUNCHES)
    result["launches_workers"] = {
        name: sum(r["launches"][name] for r in reports)
        for name in A.LAUNCHES}
    result["worker_reports"] = len(reports)
    result["unreported_pids"] = unreported
    result["launches"] = {name: result["launches_front_door"][name]
                          + result["launches_workers"][name]
                          for name in A.LAUNCHES}
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[fleet] {len(spawned)} worker processes started, every pid "
        f"reaped; worker devices {devices}; launches {result['launches']} "
        f"(this process {result['launches_front_door']}, "
        f"{len(reports)} worker exit lines {result['launches_workers']}, "
        f"unreported {unreported}, of which SIGKILLed {killed}); phase 19 "
        f"in {result['seconds']:.1f} s")
    if any(result["launches"].values()):
        raise RuntimeError(f"fleet path launches {result['launches']}")
    return result


# ------------------------------------------------------------ phase 20
# The parallel tier on one card: every slot names cuda:0 (NCCL refuses
# two ranks on one card, so the pod runs one rank a card).  LeNet-5 (BASELINE
# config #1) under ParallelWrapper(4 workers, averaging every 2 steps, 64
# rows a worker) for PAR_ROUNDS rounds, card vs CPU in f64 at PAR_F64_RTOL;
# the attention net of phase 5 under 2 workers for PAR_ATTN_ROUNDS rounds
# (K1-K3 once a worker step), bitwise the replicas averaged by hand; ZeRO
# over 4 slots of LeNet-5 in f64 against the big-batch fit; the DL4J deep
# autoencoder's widths as dense layers in a 4-stage pipeline of 8
# microbatches of 125 rows; the pod scenario over NCCL.
PAR_WORKERS, PAR_AVG, PAR_BATCH, PAR_ROUNDS = 4, 2, 64, 4
PAR_TIMED_ROUNDS, PAR_PLAIN_STEPS = 8, 24
PAR_ATTN_WORKERS, PAR_ATTN_ROUNDS = 2, 2
ZERO_SLOTS, ZERO_STEPS, ZERO_TIMED = 4, 3, 12
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_STEPS, PIPE_TIMED = \
    4, 8, 1000, 3, 8
POD_STEPS, POD_DIE_AT, POD_TIMEOUT_S = 6, 4, 300.0
# (a) and (c) in f64: the card and the CPU, or ZeRO and the big-batch fit,
# add in other orders, ~1e-14 of max apart; the port's CPU tests hold f64
# nets at 1e-10
PAR_F64_RTOL = 1e-10
# the device of (a) and (c)-(e); "cpu" runs them here on the CPU (gloo
# pods) as a dry run of the phase: the verify skill shows how
PAR_DEV = "cuda"


def par_sync() -> None:
    if PAR_DEV == "cuda":
        torch.cuda.synchronize()


def par_ms(fn, reps: int) -> List[float]:
    """Synchronized wall ms of each of ``reps`` calls of ``fn``."""
    out = []
    for _ in range(reps):
        par_sync()
        t0 = time.perf_counter()
        fn()
        par_sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def par_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def par_lenet(device, dtype=None):
    """LeNet-5 (``models/lenet.py``: adam 1e-3, seed 123) on ``device``,
    under the device's default policy, or in ``dtype`` (``"float32"``
    computes in fp32, ``"float64"`` keeps and computes everything in f64)."""
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = lenet()
    if dtype == "float64":
        conf.conf.dtype = "float64"
    elif dtype is not None:
        conf.conf.compute_dtype = dtype
    return MultiLayerNetwork(conf, device=device).init()


def par_lenet_batches(seed: int) -> list:
    """phase 9's LeNet batches cut into PAR_BATCH-row batches (32 of
    them: PAR_ROUNDS rounds of PAR_WORKERS x PAR_AVG)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    return [DataSet(b.features[i:i + PAR_BATCH], b.labels[i:i + PAR_BATCH])
            for b in lenet_data(seed)
            for i in range(0, LENET_BATCH, PAR_BATCH)]


class cudnn_deterministic:
    """cuDNN's deterministic algorithms inside the block, no autotune."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.prev


def par_wrapper_lenet(seed: int, ffcnn: dict) -> dict:
    """(a) LeNet-5 under ParallelWrapper on one card named 4 times."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import tree_to
    from deeplearning4j_tpu_torch.parallel.scaling import \
        collective_overhead_report
    batches = par_lenet_batches(seed)
    per_round = PAR_WORKERS * PAR_AVG
    out = {"workers": PAR_WORKERS, "averaging_frequency": PAR_AVG,
           "batch_per_worker": PAR_BATCH, "rounds": PAR_ROUNDS}
    # card vs CPU: the same rounds from the same init, in f64: in fp32,
    # adam turns the rounding noise of near-zero gradients into steps of
    # +-lr (its first step is about lr * sign(g)), which no tolerance on
    # the params can hold; f64 leaves that noise far below adam's eps
    card, cpu = par_lenet(PAR_DEV, "float64"), par_lenet("cpu", "float64")
    if not np.array_equal(card.get_flat_params(), cpu.get_flat_params()):
        raise RuntimeError("LeNet's init differs between card and CPU")
    scores = {}
    for name, net, devices in (("card", card, [PAR_DEV] * PAR_WORKERS),
                               ("cpu", cpu, ["cpu"] * PAR_WORKERS)):
        pw = ParallelWrapper(net, workers=PAR_WORKERS,
                             averaging_frequency=PAR_AVG, devices=devices,
                             report_score=True)
        scores[name] = []
        for r in range(PAR_ROUNDS):
            pw.fit(batches[r * per_round:(r + 1) * per_round])
            scores[name].append(pw.last_score)
    rel = par_rel(card.get_flat_params(), cpu.get_flat_params())
    s_rel = abs(scores["card"][-1] - scores["cpu"][-1]) / abs(
        scores["cpu"][-1])
    log(f"[parallel] (a) LeNet-5 4 workers x avg 2, {PAR_ROUNDS} rounds "
        f"f64: scores card {scores['card']} cpu {scores['cpu']}; params "
        f"rel {rel:.3e}, score rel {s_rel:.3e} (tol {PAR_F64_RTOL:g})")
    if not (rel <= PAR_F64_RTOL and s_rel <= PAR_F64_RTOL):
        raise RuntimeError("the wrapper's LeNet disagrees card vs CPU")
    if not scores["card"][-1] < scores["card"][0]:
        raise RuntimeError(f"the wrapper's LeNet did not train: {scores}")
    out.update(card_vs_cpu_rel=rel, score_rel=s_rel, scores=scores["card"])
    # workers=1 is the per-batch fit, bitwise (the default policy)
    with deterministic(), cudnn_deterministic():
        one, ref = par_lenet(PAR_DEV), par_lenet(PAR_DEV)
        ParallelWrapper(one, workers=1, devices=[PAR_DEV]).fit(
            batches[:per_round])
        for ds in batches[:per_round]:
            ref.fit(ds)
        same = (np.array_equal(one.get_flat_params(),
                               ref.get_flat_params())
                and np.array_equal(one.get_flat_updater_state(),
                                   ref.get_flat_updater_state())
                and one.score() == ref.score()
                and one.iteration == ref.iteration)
    log(f"[parallel] (a) workers=1 vs fit over {per_round} batches: "
        f"bitwise {same}")
    if not same:
        raise RuntimeError("ParallelWrapper(workers=1) is not the per-batch "
                           "fit")
    out["workers1_bitwise_fit"] = True
    # samples/s at workers 1 and 4 against the plain per-batch fit
    timed = (batches * 4)[:PAR_TIMED_ROUNDS * per_round]
    rates = {}
    for workers in (1, PAR_WORKERS):
        net = par_lenet(PAR_DEV)
        pw = ParallelWrapper(net, workers=workers,
                             averaging_frequency=PAR_AVG,
                             devices=[PAR_DEV] * workers)
        n = PAR_TIMED_ROUNDS * workers * PAR_AVG
        pw.fit(timed[:workers * PAR_AVG])                  # warm
        ms = par_ms(lambda: (pw.fit(timed[:n]), net.score()), 3)
        best = min(ms)
        rates[workers] = {"samples_per_s": n * PAR_BATCH * 1e3 / best,
                          "ms_per_round": best / PAR_TIMED_ROUNDS,
                          "fit_ms": ms}
    net = par_lenet(PAR_DEV)
    for ds in timed[:2]:
        net.fit(ds)
    step_ms = par_ms(lambda: (net.fit(timed[0]), net.score()),
                     PAR_PLAIN_STEPS)
    plain = float(np.median(step_ms))
    # what averaging costs a round: the one mean over the workers' trees
    pw = ParallelWrapper(net, workers=PAR_WORKERS,
                         devices=[PAR_DEV] * PAR_WORKERS)
    score = torch.zeros((), device=PAR_DEV)
    trees = [(tree_to(net.params, d), net.updater_state, net.net_state,
              score, None) for d in pw.devices]
    mean_ms = par_ms(lambda: pw.runtime.mean_trees(trees), 10)
    overhead = collective_overhead_report(
        lambda: par_lenet(PAR_DEV), batch_size=PAR_BATCH,
        feature_shape=(784,), n_classes=10, steps=10, trials=3, pipeline=2)
    out.update(rates={str(k): v for k, v in rates.items()},
               plain_step_ms=plain,
               plain_samples_per_s=PAR_BATCH * 1e3 / plain,
               phase9_samples_per_s=ffcnn["lenet"]["samples_per_s"],
               averaging_ms=float(np.median(mean_ms)),
               collective_overhead=overhead)
    log(f"[parallel] (a) samples/s: workers=1 "
        f"{rates[1]['samples_per_s']:.1f}, workers={PAR_WORKERS} "
        f"{rates[PAR_WORKERS]['samples_per_s']:.1f} (one card, "
        f"time-sliced), plain fit at {PAR_BATCH} "
        f"{PAR_BATCH * 1e3 / plain:.1f} ({plain:.3f} ms a step), phase 9 "
        f"at {LENET_BATCH} {ffcnn['lenet']['samples_per_s']:.1f}; ms a "
        f"round {rates[PAR_WORKERS]['ms_per_round']:.3f}; averaging "
        f"{out['averaging_ms']:.3f} ms a round; overhead {overhead}")
    return out


def par_attention(N, A, seed: int) -> tuple:
    """(b) phase 5's net under ParallelWrapper(2 workers, averaging every
    step) on one card; returns (result, launches of the wrapper's run)."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import (tree_leaves,
                                                        tree_unflatten)
    net = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN, heads=HEADS,
                    n_out=N_OUT, cache_len=SEQ)
    hand = [net.clone() for _ in range(PAR_ATTN_WORKERS)]
    w = PAR_ATTN_WORKERS
    batches = [make_batch(seed + 200 + i, BATCH, SEQ, N_IN, N_OUT)
               for i in range(PAR_ATTN_ROUNDS * w)]
    pw = ParallelWrapper(net, workers=w, averaging_frequency=1,
                         devices=["cuda:0"] * w, prefetch_size=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # the parallel path's counts
    round_ms, scores = [], []
    for r in range(PAR_ATTN_ROUNDS):
        t0 = time.perf_counter()
        pw.fit(batches[r * w:(r + 1) * w])
        scores.append(net.score())
        round_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(A.LAUNCHES)
    bodies = hopper_bodies(A, "parallel")
    peak = torch.cuda.max_memory_allocated()
    expected = {name: PAR_ATTN_ROUNDS * w for name in KERNELS}
    expected["flash_fwd_partials"] = 0
    if launches != expected:
        raise RuntimeError(f"parallel launches {launches}, expected "
                           f"{expected}")
    # by hand: each replica steps its batch, then every leaf is averaged
    # in its own dtype, (a + b) / 2, as the wrapper's mean does
    for r in range(PAR_ATTN_ROUNDS):
        for i, rep in enumerate(hand):
            rep.fit(batches[r * w + i])
        for name in ("params", "updater_state", "net_state"):
            leaves = [tree_leaves(getattr(rep, name)) for rep in hand]
            mean = [(a + b) / 2 if a.is_floating_point() else a
                    for a, b in zip(*leaves)]
            for rep in hand:
                setattr(rep, name, tree_unflatten(getattr(rep, name), mean))
    # bitwise: every leaf of params, updater state (the fp32 masters
    # included) and net state, in its own dtype
    got, want = ([t for name in ("params", "updater_state", "net_state")
                  for t in tree_leaves(getattr(rep, name))]
                 for rep in (net, hand[0]))
    unequal = [i for i, (a, b) in enumerate(zip(got, want))
               if a.dtype != b.dtype or not torch.equal(a, b)]
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in zip(got, want))
    log(f"[parallel] (b) attention net B={BATCH} T={SEQ} under "
        f"{w} workers: scores {scores}; ms a round {round_ms}; peak memory "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} held before); "
        f"launches {launches}, by body {bodies}; params, updater and net "
        f"state vs by hand: {len(got)} leaves, {len(unequal)} unequal, "
        f"max|err| {err:.3e}")
    if len(got) != len(want) or unequal:
        raise RuntimeError(f"the wrapper's attention net is not bitwise the "
                           f"replicas averaged by hand: leaves {unequal}")
    if not all(np.isfinite(scores)):
        raise RuntimeError(f"non-finite parallel scores: {scores}")
    return ({"workers": w, "rounds": PAR_ATTN_ROUNDS, "scores": scores,
             "round_ms": round_ms, "peak_mem_bytes": peak,
             "mem_before_bytes": held,
             "vs_by_hand": {"leaves": len(got), "bitwise": True,
                            "max_abs_err": err},
             "body_launches": bodies}, launches)


def par_zero(seed: int) -> dict:
    """(c) ZeRO over 4 slots of one card, LeNet-5."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn import updaters as U
    from deeplearning4j_tpu_torch.parallel import ZeroShardedParallelWrapper
    batches = par_lenet_batches(seed)
    n = ZERO_SLOTS

    def big(group):
        return DataSet(np.concatenate([b.features for b in group]),
                       np.concatenate([b.labels for b in group]))

    z, ref = par_lenet(PAR_DEV, "float64"), par_lenet(PAR_DEV, "float64")
    zw = ZeroShardedParallelWrapper(z, workers=n, devices=[PAR_DEV] * n)
    for s in range(ZERO_STEPS):
        group = batches[s * n:(s + 1) * n]
        zw.fit(group)
        ref.fit(big(group))
    rel = par_rel(z.get_flat_params(), ref.get_flat_params())
    total = z.num_params()
    shard = -(-total // n)
    per_slot = zw.state_elements_per_replica()
    slot_bytes = sum(t.numel() * t.element_size()
                     for t in zw._state[0].values())
    full_bytes = sum(t.numel() * t.element_size()
                     for layer in ref.updater_state
                     for key in layer for t in layer[key].values())
    log(f"[parallel] (c) ZeRO x{n} LeNet-5 f64, {ZERO_STEPS} steps vs the "
        f"big-batch fit: params rel {rel:.3e} (tol {PAR_F64_RTOL:g}); state "
        f"elements a slot {per_slot} (2 x ceil({total}/{n}) = {2 * shard}); "
        f"bytes a slot {slot_bytes} of {full_bytes} "
        f"({slot_bytes / full_bytes:.4f})")
    if not rel <= PAR_F64_RTOL:
        raise RuntimeError("ZeRO disagrees with the big-batch fit")
    if per_slot != 2 * shard:
        raise RuntimeError(f"ZeRO holds {per_slot} state elements a slot")
    if not 0.25 <= slot_bytes / full_bytes <= 0.25 * (1 + n / total) + 1e-9:
        raise RuntimeError("a slot's state is not a quarter")
    # timed under the card's default policy (the masters in the shard)
    zt = par_lenet(PAR_DEV)
    zwt = ZeroShardedParallelWrapper(zt, workers=n, devices=[PAR_DEV] * n)
    if PAR_DEV == "cuda" and U.MASTER_KEY not in zwt.state_tree():
        raise RuntimeError("mixed_bf16 ZeRO keeps no master slice")
    group = batches[:n]
    zwt.fit(group)
    zero_ms = par_ms(lambda: (zwt.fit(group), zt.score()), ZERO_TIMED)
    pt = par_lenet(PAR_DEV)
    whole = big(group)
    pt.fit(whole)
    plain_ms = par_ms(lambda: (pt.fit(whole), pt.score()), ZERO_TIMED)
    out = {"slots": n, "steps": ZERO_STEPS, "params_rel": rel,
           "params": total, "state_elements_per_slot": per_slot,
           "state_bytes_per_slot": slot_bytes,
           "state_bytes_replicated": full_bytes,
           "mixed_state_elements_per_slot":
               zwt.state_elements_per_replica(),
           "step_ms": float(np.median(zero_ms)),
           "plain_step_ms": float(np.median(plain_ms)),
           "batch": n * PAR_BATCH}
    log(f"[parallel] (c) ZeRO step {out['step_ms']:.3f} ms (median of "
        f"{ZERO_TIMED}) vs the plain step {out['plain_step_ms']:.3f} ms at "
        f"batch {n * PAR_BATCH}, mixed_bf16 (masters in the shard, "
        f"{out['mixed_state_elements_per_slot']} elements a slot)")
    return out


def par_dae(N, device, fp32: bool):
    """The DL4J deep autoencoder's widths as dense layers (784-1000-500-
    250-100-30-100-250-500-1000, sigmoid) and an OutputLayer back to 784
    (mse, sigmoid), sgd 0.1, seed 123."""
    from deeplearning4j_tpu_torch.nn.layers.core import (DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (N.NeuralNetConfiguration.builder().seed(123).updater("sgd")
         .learning_rate(0.1).activation("sigmoid").weight_init("xavier"))
    if fp32:
        b = b.compute_dtype("float32")
    b = b.list()
    for n_in, n_out in zip(DAE_WIDTHS[:-1], DAE_WIDTHS[1:]):
        b = b.layer(DenseLayer(n_in=n_in, n_out=n_out))
    b = b.layer(OutputLayer(n_in=DAE_WIDTHS[-1], n_out=DAE_WIDTHS[0],
                            loss="mse", activation="sigmoid"))
    return MultiLayerNetwork(b.build(), device=device).init()


def par_pipeline(N, seed: int) -> dict:
    """(d) 4 stages x 8 microbatches of the deep autoencoder's widths."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import PipelineParallel
    rng = np.random.RandomState(seed + 7)
    data = [(rng.rand(PIPE_BATCH, DAE_WIDTHS[0]) > 0.5).astype(np.float32)
            for _ in range(PIPE_STEPS)]
    pp_net, ref = par_dae(N, PAR_DEV, True), par_dae(N, PAR_DEV, True)
    pp = PipelineParallel(pp_net, stages=PIPE_STAGES,
                          microbatches=PIPE_MICRO,
                          devices=[PAR_DEV] * PIPE_STAGES)
    for x in data:
        pp.fit([DataSet(x, x)])
        ref.fit(DataSet(x, x))
    rel = par_rel(pp_net.get_flat_params(), ref.get_flat_params())
    s_rel = abs(pp_net.score() - ref.score()) / abs(ref.score())
    log(f"[parallel] (d) pipeline {PIPE_STAGES} stages {pp.ranges} x "
        f"{PIPE_MICRO} microbatches, batch {PIPE_BATCH}, fp32, "
        f"{PIPE_STEPS} steps vs serial: params rel {rel:.3e}, score rel "
        f"{s_rel:.3e} (tol {REF_RTOL:g})")
    if not (rel <= REF_RTOL and s_rel <= REF_RTOL):
        raise RuntimeError("the pipeline disagrees with the serial step")
    timed = par_dae(N, PAR_DEV, False)
    ppt = PipelineParallel(timed, stages=PIPE_STAGES,
                           microbatches=PIPE_MICRO,
                           devices=[PAR_DEV] * PIPE_STAGES)
    ds = DataSet(data[0], data[0])
    ppt.fit([ds])
    pipe_ms = par_ms(lambda: (ppt.fit([ds]), timed.score()), PIPE_TIMED)
    serial = par_dae(N, PAR_DEV, False)
    serial.fit(ds)
    serial_ms = par_ms(lambda: (serial.fit(ds), serial.score()), PIPE_TIMED)
    out = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
           "batch": PIPE_BATCH, "ranges": pp.ranges,
           "params": pp_net.num_params(), "params_rel": rel,
           "score_rel": s_rel, "step_ms": float(np.median(pipe_ms)),
           "serial_step_ms": float(np.median(serial_ms))}
    log(f"[parallel] (d) pipeline step {out['step_ms']:.3f} ms vs serial "
        f"{out['serial_step_ms']:.3f} ms (median of {PIPE_TIMED}, "
        f"mixed_bf16)")
    return out


def par_pod(seed: int) -> dict:
    """(e) the pod over NCCL: K = min(2, cards) ranks, the mesh data=2."""
    import tempfile
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel import main as pm
    cards = torch.cuda.device_count() if PAR_DEV == "cuda" else 0
    k = min(2, cards) if PAR_DEV == "cuda" else 2
    backend = "nccl" if PAR_DEV == "cuda" else "gloo"
    common = dict(k=k, data=2, mode="dp", steps=POD_STEPS, device=PAR_DEV,
                  timeout=POD_TIMEOUT_S)
    t0 = time.perf_counter()
    pod = pm.run_pod(measure_collectives=True, **common)
    pod_s = time.perf_counter() - t0

    def ok(result, what):
        if result["returncodes"] != [0] * k:
            raise RuntimeError(f"{what}: rcs {result['returncodes']}: "
                               f"{result['stderr_tail']}")
        if any(r["backend"] != backend for r in result["reports"]):
            raise RuntimeError(f"{what}: not on {backend}: "
                               f"{result['reports']}")

    ok(pod, "pod")
    # the 1-process run of the same mesh: a K=1 pod where K is 2, and the
    # wrapper in this process (no process group) always
    single = pod if k == 1 else pm.run_pod(**dict(common, k=1))
    if k > 1:
        if single["returncodes"] != [0]:
            raise RuntimeError(f"1-process pod: {single['stderr_tail']}")
    with deterministic():
        net = pm.build_pod_net(seed=11, device=PAR_DEV)
        pw = ParallelWrapper(net, workers=2, prefetch_size=0,
                             devices=[PAR_DEV] * 2)
        scores = []
        for step in range(POD_STEPS):
            pw.fit(pm.make_pod_batches(step, 2, 16, 100))
            scores.append(float(np.float32(float(net._score))))
    in_process = {"scores": scores, "param_sha": pm.param_sha(net)}
    for name, other in (("1-process pod", single),
                        ("wrapper in process", in_process)):
        if (other["scores"] != pod["scores"]
                or other["param_sha"] != pod["param_sha"]):
            raise RuntimeError(f"the K={k} pod differs from the {name}: "
                               f"{pod['scores']} vs {other['scores']}")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        inter = pm.run_pod(checkpoint_dir=tmp, checkpoint_every=2,
                           die_at=(k - 1, POD_DIE_AT), relaunch=True,
                           **common)
        kill_s = time.perf_counter() - t1
    resumed = inter["resumed"]
    ok(resumed, "resumed pod")
    if inter["returncodes"][k - 1] != -9:
        raise RuntimeError(f"the victim was not killed: "
                           f"{inter['returncodes']}")
    if (resumed["reports"][0]["start_step"] != POD_DIE_AT
            or resumed["scores"] != pod["scores"]
            or resumed["param_sha"] != pod["param_sha"]):
        raise RuntimeError(f"kill/resume differs: {resumed['scores']} vs "
                           f"{pod['scores']}")
    reaped = all(r["reaped"] for r in (pod, single, inter, resumed))
    pids = sorted({p for r in (pod, single, inter, resumed)
                   for p in r["pids"]})
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except OSError:
            pass
    if not reaped or alive:
        raise RuntimeError(f"pod workers left running: {alive}")
    out = {"k": k, "cards": cards, "backend": backend, "data": 2,
           "steps": POD_STEPS, "scores": pod["scores"],
           "param_sha": pod["param_sha"],
           "devices": [r["device"] for r in pod["reports"]],
           "backends": [r["backend"] for r in pod["reports"]],
           "collectives_s": pod["reports"][0]["collectives"],
           "worker_elapsed_s": [r["elapsed_s"] for r in pod["reports"]],
           "pod_wall_s": pod_s, "kill_resume_wall_s": kill_s,
           "resumed_from": resumed["reports"][0]["resumed_from"],
           "workers_reaped": len(pids),
           "ran_at_k1": (["pod", "kill_resume"] if k == 1 else [])}
    log(f"[parallel] (e) pod K={k} on {cards} card(s) over {backend} "
        f"{out['devices']}: bitwise the 1-process run and the wrapper in "
        f"process; kill at step {POD_DIE_AT} and resume from "
        f"{out['resumed_from']} bitwise; collectives {out['collectives_s']}"
        f"; pod {pod_s:.1f} s, kill+resume {kill_s:.1f} s; "
        f"{len(pids)} workers reaped; ran at K=1: {out['ran_at_k1']}")
    return out


def phase_parallel(N, A, seed: int, ffcnn: dict) -> dict:
    """Phase 20: the parallel tier on the card ((a)-(e)); K1-K3 launch on
    (b) only, every launch on its Hopper body."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    A.reset_launches()            # the parallel path's counts
    result = {"wrapper_lenet": par_wrapper_lenet(seed, ffcnn)}
    if any(A.LAUNCHES.values()):
        raise RuntimeError("LeNet under the wrapper launched a flash kernel")
    result["attention"], launches = par_attention(N, A, seed)
    torch.cuda.empty_cache()
    A.reset_launches()
    result["zero"] = par_zero(seed)
    result["pipeline"] = par_pipeline(N, seed)
    result["pod"] = par_pod(seed)
    if any(A.LAUNCHES.values()):
        raise RuntimeError(f"ZeRO, the pipeline or the pod launched a flash "
                           f"kernel: {A.LAUNCHES}")
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t0
    return result


# ------------------------------------------------------------ phase 21
# The cluster-training tier on one card.  (a) LeNet-5 (BASELINE config #1)
# under ParameterAveragingTrainingMaster(4 workers x 64 rows, averaging
# every 5 batches): 4 x 64 = 256 rows a step, SO_SPLITS splits through the
# Direct and the Export approach on the procedural MNIST; workers=1
# bitwise the plain fit; f64 card vs CPU; the distributed evaluate.  (b)
# phase 5's attention net under 2 workers averaging every batch.  (c)
# ParameterServerParallelWrapper on LeNet-5 in process.  (d)
# bench_scaleout's configuration (bench.py:1525-1615): K=3 worker
# processes on the card against the TCP parameter server.  (e)
# ClusterWord2Vec at examples/word2vec_text.py's widths.  (f)
# run_multi_host_training in a 1-rank NCCL group.
SO_WORKERS, SO_BATCH, SO_AVG, SO_SPLITS = 4, 64, 5, 5
SO_F64_AVG, SO_F64_SPLITS = 2, 2
SO_EVAL_BATCH, SO_EVAL_ROWS = 256, 2048
SO_ATTN_WORKERS, SO_ATTN_SPLITS = 2, 2
SO_PS_WORKERS, SO_PS_BATCHES = 4, 64
SO_K, SO_ROUNDS, SO_DURATION, SO_STRAGGLER = 3, 40, 4.0, (1, 250.0)
SO_BAND, SO_WIRE_X = 0.08, 3.0
SO_W2V_WORKERS, SO_W2V_EPOCHS = 4, 10
# the device of every sub-phase; "cpu" runs (a) and (c)-(e) here on the
# CPU as a dry run of the phase, as PAR_DEV does for phase 20
SO_DEV = "cuda"


def so_sync() -> None:
    if SO_DEV == "cuda":
        torch.cuda.synchronize()


def so_mnist(n: int, batch: int, train: bool = True) -> list:
    """``n`` procedural MNIST images in batches of ``batch`` (phase 11's
    generator; flat 784-vectors with their u8 wire)."""
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    return list(MnistDataSetIterator(batch, n, train=train, shuffle=False))


def so_leaves(net) -> list:
    from deeplearning4j_tpu_torch.parallel.mesh import tree_leaves
    return [t for name in ("params", "updater_state", "net_state")
            for t in tree_leaves(getattr(net, name))]


def so_equal(a, b) -> bool:
    """Every leaf of params, updater state and net state ``torch.equal``,
    and the iteration and score the same."""
    la, lb = so_leaves(a), so_leaves(b)
    return (len(la) == len(lb)
            and all(x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(la, lb))
            and a.iteration == b.iteration and a.score() == b.score())


def so_data() -> tuple:
    """(train batches of SO_BATCH rows for SO_SPLITS splits, test batches,
    the seconds their generation took)."""
    t0 = time.perf_counter()
    batches = so_mnist(SO_SPLITS * SO_WORKERS * SO_AVG * SO_BATCH, SO_BATCH)
    test = so_mnist(SO_EVAL_ROWS, SO_EVAL_BATCH, train=False)
    return batches, test, time.perf_counter() - t0


def so_master_lenet(batches, test, gen_s: float, ffcnn: dict) -> dict:
    """(a) LeNet-5 under the averaging master at full width."""
    import tempfile
    from deeplearning4j_tpu_torch.scaleout import (
        ClusterMultiLayer, ParameterAveragingTrainingMaster)
    split_rows = SO_WORKERS * SO_AVG * SO_BATCH
    out = {"workers": SO_WORKERS, "batch_per_worker": SO_BATCH,
           "averaging_frequency": SO_AVG, "rows_per_step":
           SO_WORKERS * SO_BATCH, "splits": SO_SPLITS,
           "mnist_generate_s": gen_s}
    if SO_DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for approach in ("direct", "export"):
            net = par_lenet(SO_DEV)
            master = ParameterAveragingTrainingMaster(
                num_workers=SO_WORKERS, batch_size_per_worker=SO_BATCH,
                averaging_frequency=SO_AVG,
                export_dir=tmp if approach == "export" else None)
            front = ClusterMultiLayer(net, master)
            s0 = net.score(batches[0])
            so_sync()
            t1 = time.perf_counter()
            front.fit(batches)
            score = net.score()
            so_sync()
            total = time.perf_counter() - t1
            split_ms = [s["wall_time_sec"] * 1e3 for s in master.stats]
            fold_ms = [s["fold_time_sec"] * 1e3 for s in master.stats]
            steady = sum(split_ms[1:]) / 1e3
            runs[approach] = {
                "split_ms": split_ms, "fold_ms": fold_ms,
                "fit_s": total, "score_before": s0, "score": score,
                "samples_per_s": (len(split_ms) - 1) * split_rows / steady,
                "iteration": net.iteration}
            log(f"[scaleout] (a) {approach}: {len(split_ms)} splits of "
                f"{split_rows} rows; ms a split {split_ms[0]:.1f} (first, "
                f"replicas built) then median "
                f"{float(np.median(split_ms[1:])):.1f}; fold median "
                f"{float(np.median(fold_ms)):.3f} ms; "
                f"{runs[approach]['samples_per_s']:.1f} samples/s (splits "
                f"2-{len(split_ms)}); score {s0:.4f} -> {score:.4f}")
            if len(split_ms) != SO_SPLITS or net.iteration != \
                    SO_SPLITS * SO_AVG:
                raise RuntimeError(f"(a) {approach}: {len(split_ms)} splits,"
                                   f" iteration {net.iteration}")
            if not (np.isfinite(score) and score < s0):
                raise RuntimeError(f"(a) {approach} did not train: {s0} -> "
                                   f"{score}")
    out["runs"] = runs
    if SO_DEV == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        out["mem_before_bytes"] = held
    out["phase9_samples_per_s"] = ffcnn["lenet"]["samples_per_s"]
    log(f"[scaleout] (a) samples/s Direct "
        f"{runs['direct']['samples_per_s']:.1f}, Export "
        f"{runs['export']['samples_per_s']:.1f}, beside phase 9's plain "
        f"LeNet-5 step at {LENET_BATCH} rows "
        f"{out['phase9_samples_per_s']:.1f}; peak memory "
        + (f"{out['peak_mem_bytes'] / 2**30:.3f} GiB ("
           f"{out['mem_before_bytes'] / 2**30:.3f} held before)"
           if SO_DEV == "cuda" else "not measured (cpu)"))
    # the distributed evaluate folds 4 partitions' Evaluations by merge()
    ev = ClusterMultiLayer(net, master).evaluate(test)
    local = net.evaluate(test)
    same_cm = bool(np.array_equal(ev.confusion.matrix,
                                  local.confusion.matrix))
    out["evaluate"] = {"accuracy": ev.accuracy(), "rows": SO_EVAL_ROWS,
                       "confusion_equal": same_cm}
    log(f"[scaleout] (a) distributed evaluate over {SO_WORKERS} "
        f"partitions: accuracy {ev.accuracy():.4f}, confusion matrix "
        f"equal to net.evaluate: {same_cm}")
    if not same_cm:
        raise RuntimeError("the distributed evaluate differs from "
                           "net.evaluate")
    # workers=1 is the per-batch fit, bitwise (deterministic algorithms)
    one_n = 2 * SO_AVG
    with deterministic(), cudnn_deterministic():
        one, ref = par_lenet(SO_DEV), par_lenet(SO_DEV)
        ClusterMultiLayer(one, ParameterAveragingTrainingMaster(
            num_workers=1, batch_size_per_worker=SO_BATCH,
            averaging_frequency=SO_AVG)).fit(batches[:one_n])
        for ds in batches[:one_n]:
            ref.fit(ds)
        same = so_equal(one, ref)
    log(f"[scaleout] (a) workers=1 vs fit over {one_n} batches: bitwise "
        f"{same}")
    if not same:
        raise RuntimeError("the master with one worker is not the "
                           "per-batch fit")
    out["workers1_bitwise_fit"] = True
    # f64: the same splits on the card and on the CPU
    f64_n = SO_F64_SPLITS * SO_WORKERS * SO_F64_AVG
    card = par_lenet(SO_DEV, "float64")
    cpu = par_lenet("cpu", "float64")
    if not np.array_equal(card.get_flat_params(), cpu.get_flat_params()):
        raise RuntimeError("LeNet's init differs between card and CPU")
    for net in (card, cpu):
        ClusterMultiLayer(net, ParameterAveragingTrainingMaster(
            num_workers=SO_WORKERS, batch_size_per_worker=SO_BATCH,
            averaging_frequency=SO_F64_AVG)).fit(batches[:f64_n])
    rel = par_rel(card.get_flat_params(), cpu.get_flat_params())
    s_rel = abs(card.score() - cpu.score()) / abs(cpu.score())
    log(f"[scaleout] (a) f64 {SO_F64_SPLITS} splits of {SO_WORKERS} x "
        f"{SO_F64_AVG} card vs CPU: params rel {rel:.3e}, score rel "
        f"{s_rel:.3e} (tol {PAR_F64_RTOL:g})")
    if not (rel <= PAR_F64_RTOL and s_rel <= PAR_F64_RTOL):
        raise RuntimeError("the master's LeNet disagrees card vs CPU in f64")
    out["f64_card_vs_cpu"] = {"params_rel": rel, "score_rel": s_rel,
                              "splits": SO_F64_SPLITS}
    return out


def so_attention(N, A, seed: int) -> tuple:
    """(b) phase 5's net under the master, 2 workers averaging every
    batch; returns (result, the launches of the master's run)."""
    from deeplearning4j_tpu_torch.scaleout import (
        ClusterMultiLayer, ParameterAveragingTrainingMaster)
    from deeplearning4j_tpu_torch.scaleout.param_avg import \
        ParameterAveragingTrainingWorker
    results = []

    class Recording(ParameterAveragingTrainingWorker):
        def process_partition(self, partition):
            r = super().process_partition(partition)
            results.append(r)
            return r

    net = build_net(N, A, seed=seed, n_in=N_IN, hidden=HIDDEN, heads=HEADS,
                    n_out=N_OUT, cache_len=SEQ)
    w = SO_ATTN_WORKERS
    batches = [make_batch(seed + 300 + i, BATCH, SEQ, N_IN, N_OUT)
               for i in range(SO_ATTN_SPLITS * w)]
    master = ParameterAveragingTrainingMaster(
        num_workers=w, batch_size_per_worker=BATCH, averaging_frequency=1,
        worker_factory=Recording)
    front = ClusterMultiLayer(net, master)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()            # the scaleout path's counts
    split_ms = []
    before = None
    for s in range(SO_ATTN_SPLITS):
        if s == SO_ATTN_SPLITS - 1:
            before = net.clone()
            del results[:]
        t0 = time.perf_counter()
        front.fit(batches[s * w:(s + 1) * w])
        net.score()
        torch.cuda.synchronize()
        split_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(A.LAUNCHES)
    bodies = hopper_bodies(A, "scaleout")
    peak = torch.cuda.max_memory_allocated()
    expected = {name: SO_ATTN_SPLITS * w for name in KERNELS}
    expected["flash_fwd_partials"] = 0
    if launches != expected:
        raise RuntimeError(f"scaleout launches {launches}, expected "
                           f"{expected}")
    # the last split's fold by hand: the replicas' flat vectors averaged
    # in float64 on the host in worker order, written into the master as
    # it stood before the split
    if len(results) != w:
        raise RuntimeError(f"{len(results)} results in the last split")
    wts = np.array([r.batches_processed for r in results], np.float64)
    p = np.zeros_like(results[0].params, np.float64)
    u = np.zeros_like(results[0].updater_state, np.float64)
    for wt, r in zip(wts, results):
        p += wt * r.params.astype(np.float64)
        u += wt * r.updater_state.astype(np.float64)
    before.set_flat_params((p / wts.sum()).astype(results[0].params.dtype))
    before.set_flat_updater_state((u / wts.sum()).astype(
        results[0].updater_state.dtype))
    before.iteration += int(wts.max())
    got, want = so_leaves(net), so_leaves(before)
    unequal = [i for i, (a, b) in enumerate(zip(got, want))
               if a.dtype != b.dtype or not torch.equal(a, b)]
    log(f"[scaleout] (b) attention net B={BATCH} T={SEQ} under {w} workers "
        f"x {SO_ATTN_SPLITS} splits: ms a split {split_ms}; peak memory "
        f"{peak / 2**30:.3f} GiB ({held / 2**30:.3f} held before); launches "
        f"{launches}, by body {bodies}; params, updater and net state vs "
        f"the host fold: {len(got)} leaves, {len(unequal)} unequal; "
        f"iteration {net.iteration} (by hand {before.iteration})")
    if len(got) != len(want) or unequal or net.iteration != before.iteration:
        raise RuntimeError(f"the master's attention net is not the host "
                           f"fold of its replicas: leaves {unequal}")
    if not np.isfinite(net.score()):
        raise RuntimeError("non-finite score under the master")
    return ({"workers": w, "splits": SO_ATTN_SPLITS, "split_ms": split_ms,
             "peak_mem_bytes": peak, "mem_before_bytes": held,
             "vs_host_fold": {"leaves": len(got), "bitwise": True},
             "body_launches": bodies}, launches)


def so_timed(fn, into: list):
    """``fn`` wrapped to append each call's synchronized ms to ``into``."""
    def wrapped(*a, **kw):
        so_sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        so_sync()
        into.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapped


def so_ps_wrapper(batches, test) -> dict:
    """(c) ParameterServerParallelWrapper on LeNet-5 in process, on
    (a)'s MNIST batches; the score on (a)'s first test batch."""
    from deeplearning4j_tpu_torch.scaleout.param_server import \
        ParameterServerParallelWrapper
    batches = batches[:SO_PS_BATCHES]
    held_out = test[0]
    net = par_lenet(SO_DEV)
    pw = ParameterServerParallelWrapper(net, num_workers=SO_PS_WORKERS)
    ms = {"pull": [], "push": [], "set_params": [], "get_params": []}
    pw.server.pull = so_timed(pw.server.pull, ms["pull"])
    pw.server.push = so_timed(pw.server.push, ms["push"])
    for rep in pw._replicas:
        rep.set_flat_params = so_timed(rep.set_flat_params,
                                       ms["set_params"])
        rep.get_flat_params = so_timed(rep.get_flat_params,
                                       ms["get_params"])
    s0 = net.score(held_out)
    t0 = time.perf_counter()
    pw.fit(batches)
    so_sync()
    fit_s = time.perf_counter() - t0
    s1 = net.score(held_out)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[scaleout] (c) PS wrapper LeNet-5 {SO_PS_WORKERS} workers, "
        f"{len(batches)} batches of {SO_BATCH}: held-out score {s0:.4f} -> "
        f"{s1:.4f}, {pw.server.pushes} pushes in {fit_s:.2f} s; median ms: "
        f"store pull {med['pull']:.3f}, push {med['push']:.3f}, HtoD "
        f"set_flat_params {med['set_params']:.3f}, DtoH get_flat_params "
        f"{med['get_params']:.3f} ({net.num_params()} params)")
    if not (np.isfinite(s1) and s1 < s0):
        raise RuntimeError(f"the PS wrapper did not converge: {s0} -> {s1}")
    if pw.server.pushes != len(batches):
        raise RuntimeError(f"{pw.server.pushes} pushes for {len(batches)}")
    # one worker, fp32 (no masters re-derived from bf16 params at each
    # pull): the sequential fit, bitwise
    with deterministic(), cudnn_deterministic():
        one, ref = par_lenet(SO_DEV, "float32"), par_lenet(SO_DEV, "float32")
        ParameterServerParallelWrapper(one, num_workers=1).fit(batches[:8])
        for ds in batches[:8]:
            ref.fit(ds)
        same = bool(np.array_equal(one.get_flat_params(),
                                   ref.get_flat_params()))
    log(f"[scaleout] (c) one worker vs the sequential fit over 8 batches "
        f"(fp32): bitwise {same}")
    if not same:
        raise RuntimeError("the PS wrapper with one worker is not the "
                           "sequential fit")
    return {"workers": SO_PS_WORKERS, "batches": len(batches),
            "score_before": s0, "score": s1, "fit_s": fit_s,
            "pushes": pw.server.pushes, "median_ms": med,
            "params": net.num_params(), "one_worker_bitwise_fit": True}


def so_reaped(pids) -> list:
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except OSError:
            pass
    return alive


def so_async() -> dict:
    """(d) bench_scaleout's configuration through the port, on SO_DEV."""
    from deeplearning4j_tpu_torch.scaleout import async_trainer as at
    k, rounds, dev = SO_K, SO_ROUNDS, SO_DEV
    t0 = time.perf_counter()
    runs = {}

    def note(tag, rec):
        slim = {kk: vv for kk, vv in rec.items() if kk != "workers"}
        slim["ready_s"] = [w.get("ready_s") for w in rec.get("workers", [])]
        runs[tag] = slim
        log(f"[scaleout] (d) {tag}: accuracy {rec['accuracy']:.4f}, "
            f"{rec['samples_per_sec']} samples/s, wall {rec['wall_s']} s"
            + (f", rcs {rec['returncodes']}, wire {rec['wire_bytes']:.0f} "
               f"B, staleness max {rec['staleness_max']}, ready s "
               f"{slim['ready_s']}" if rec["mode"] == "async" else ""))
        return rec

    sync = note("sync_dp", at.run_sync_dp(k=k, rounds=rounds, device=dev))
    topk = note("async_topk8", at.run_async(k=k, codec="topk8",
                                            rounds=rounds, device=dev))
    f32 = note("async_f32", at.run_async(k=k, codec="f32", rounds=rounds,
                                         device=dev))
    kill = note("async_kill", at.run_async(
        k=k, codec="topk8", rounds=rounds,
        die_at_round=(k - 1, max(2, rounds // 3)), device=dev))
    a_thr = note("async_straggler", at.run_async(
        k=k, codec="topk8", rounds=rounds, duration=SO_DURATION,
        straggler=SO_STRAGGLER, device=dev))
    s_thr = note("sync_straggler", at.run_sync_dp(
        k=k, rounds=rounds, duration=SO_DURATION, straggler=SO_STRAGGLER,
        device=dev))
    crossover = (a_thr["samples_per_sec"] / s_thr["samples_per_sec"]
                 if s_thr["samples_per_sec"] else None)
    wire_x = (f32["wire_bytes"] / topk["wire_bytes"]
              if topk["wire_bytes"] else None)
    async_runs = (topk, f32, kill, a_thr)
    alive = so_reaped([p for r in async_runs for p in r["pids"]])
    out = {"k": k, "rounds": rounds, "device": dev,
           "straggler": list(SO_STRAGGLER), "duration_s": SO_DURATION,
           "acc_sync": sync["accuracy"], "acc_topk8": topk["accuracy"],
           "acc_f32": f32["accuracy"], "acc_kill": kill["accuracy"],
           "wire_bytes_f32": f32["wire_bytes"],
           "wire_bytes_topk8": topk["wire_bytes"], "wire_reduction_x": wire_x,
           "crossover_x": crossover,
           "async_samples_per_s": a_thr["samples_per_sec"],
           "sync_samples_per_s": s_thr["samples_per_sec"],
           "staleness_max": topk["staleness_max"],
           "staleness_bound": topk["staleness_bound"],
           "kill_returncodes": kill["returncodes"],
           "workers_reaped": len({p for r in async_runs for p in r["pids"]}),
           "seconds": time.perf_counter() - t0, "runs": runs}
    log(f"[scaleout] (d) K={k} x {rounds} rounds on {dev}: accuracy sync "
        f"{sync['accuracy']:.4f}, topk8 {topk['accuracy']:.4f}, f32 "
        f"{f32['accuracy']:.4f}, kill {kill['accuracy']:.4f} (band "
        f"{SO_BAND}); wire f32/topk8 {wire_x}; crossover async/sync under "
        f"the straggler {crossover} ({a_thr['samples_per_sec']} vs "
        f"{s_thr['samples_per_sec']} samples/s); staleness max "
        f"{topk['staleness_max']} (bound {topk['staleness_bound']}); "
        f"{out['workers_reaped']} workers reaped, alive {alive}; "
        f"{out['seconds']:.1f} s")
    for tag, rec in (("topk8", topk), ("f32", f32), ("kill", kill)):
        if abs(rec["accuracy"] - sync["accuracy"]) > SO_BAND:
            raise RuntimeError(f"async {tag} accuracy {rec['accuracy']} "
                               f"outside the band of sync "
                               f"{sync['accuracy']}")
    for tag, rec in (("topk8", topk), ("f32", f32)):
        if rec["returncodes"] != [0] * k:
            raise RuntimeError(f"async {tag}: rcs {rec['returncodes']}: "
                               f"{rec['stderr_tails']}")
    if not (wire_x and wire_x >= SO_WIRE_X):
        raise RuntimeError(f"wire reduction {wire_x} < {SO_WIRE_X}")
    if kill["returncodes"][k - 1] != -9 or kill["survivors"] != k - 1:
        raise RuntimeError(f"the kill run: rcs {kill['returncodes']}, "
                           f"{kill['survivors']} survivors: "
                           f"{kill['stderr_tails']}")
    if alive:
        raise RuntimeError(f"async workers left running: {alive}")
    return out


def so_recording_w2v():
    """A ClusterWord2Vec class that keeps its workers, so that their
    tables (each worker's last epoch) can be folded by hand."""
    from deeplearning4j_tpu_torch.scaleout.nlp import ClusterWord2Vec

    class Recording(ClusterWord2Vec):
        def _make_worker(self, seed):
            w = super()._make_worker(seed)
            self.kept = getattr(self, "kept", []) + [w]
            return w
    return Recording


def so_word2vec() -> dict:
    """(e) ClusterWord2Vec at examples/word2vec_text.py's widths."""
    from deeplearning4j_tpu_torch.scaleout.data import partition_evenly
    from deeplearning4j_tpu_torch.scaleout.nlp import TextPipeline
    Recording = so_recording_w2v()
    so_sync()
    t0 = time.perf_counter()
    w2v = Recording(num_workers=SO_W2V_WORKERS, min_word_frequency=2,
                    layer_size=24, window_size=3, seed=1,
                    epochs=SO_W2V_EPOCHS, negative=5, batch_size=128,
                    device=SO_DEV).fit(W2V_SENTENCES)
    so_sync()
    secs = time.perf_counter() - t0
    model = w2v.model
    serial = TextPipeline(num_workers=1, min_word_frequency=2)
    scache = serial.build_vocab_cache(W2V_SENTENCES)

    def words(cache):
        return [(v.word, v.index, v.element_frequency)
                for v in cache.vocab_words()]

    same_vocab = words(model.vocab) == words(scache)
    # the last epoch's fold by hand: float64 host average in worker order,
    # weighted by the words each worker trained
    parts = partition_evenly(serial.sequences, SO_W2V_WORKERS)
    n = np.array([max(sum(len(s) for s in p) * model.iterations, 1)
                  for p in parts], np.float64)
    n /= n.sum()
    folded = {}
    for name in ("syn0", "syn1", "syn1neg"):
        mats = [getattr(w.lookup_table, name) for w in w2v.kept]
        if mats[0] is None:
            continue
        acc = np.zeros(tuple(mats[0].shape), np.float64)
        for m, wt in zip(mats, n):
            acc += wt * m.cpu().numpy().astype(np.float64)
        want = torch.from_numpy(acc.astype(np.float32))
        got = getattr(model.lookup_table, name)
        folded[name] = bool(got.device.type == SO_DEV
                            and torch.equal(got.cpu(), want))
    nearest = model.words_nearest("king", top_n=3)
    log(f"[scaleout] (e) ClusterWord2Vec {SO_W2V_WORKERS} workers x "
        f"{SO_W2V_EPOCHS} epochs (layer 24, window 3, negative 5, min "
        f"frequency 2) on {model.lookup_table.syn0.device}: {secs:.2f} s; "
        f"vocab bitwise the serial TextPipeline's {same_vocab}; fold by "
        f"hand equal {folded}; nearest to 'king' {nearest}")
    if not same_vocab:
        raise RuntimeError("the cluster vocab differs from the serial one")
    if not folded or not all(folded.values()):
        raise RuntimeError(f"the Word2VecChange fold differs: {folded}")
    return {"workers": SO_W2V_WORKERS, "epochs": SO_W2V_EPOCHS,
            "fit_s": secs, "vocab_bitwise": True, "fold_bitwise": folded,
            "nearest_king": nearest}


def so_multi_host(seed: int) -> dict:
    """(f) run_multi_host_training in a 1-rank NCCL group: the master
    alone over the same paths, bitwise.  In fp32: the loop writes the
    mean back through ``set_flat_params``, which re-derives the fp32
    masters of a ``mixed_bf16`` net from its bf16 params."""
    import tempfile
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import mesh
    from deeplearning4j_tpu_torch.scaleout import (
        ParameterAveragingTrainingMaster, batch_and_export)
    from deeplearning4j_tpu_torch.scaleout.dcn import run_multi_host_training
    batches = par_lenet_batches(seed)[:2 * SO_WORKERS * 2]
    kw = dict(num_workers=SO_WORKERS, batch_size_per_worker=PAR_BATCH,
              averaging_frequency=2)
    port = mesh.pick_coordinator_port()
    with tempfile.TemporaryDirectory() as tmp, deterministic(), \
            cudnn_deterministic():
        paths = batch_and_export(batches, tmp)
        alone = par_lenet(SO_DEV, "float32")
        ParameterAveragingTrainingMaster(**kw).execute_training_paths(
            alone, paths)
        mesh.ensure_distributed(f"127.0.0.1:{port}", 1, 0, device=SO_DEV,
                                group_of_one=True)
        try:
            backend = dist.get_backend()
            net = par_lenet(SO_DEV, "float32")
            shard = run_multi_host_training(
                net, ParameterAveragingTrainingMaster(**kw), paths)
        finally:
            mesh._reset_bootstrap_for_tests()
        same = so_equal(net, alone)
    log(f"[scaleout] (f) run_multi_host_training in a 1-rank {backend} "
        f"group over {len(shard)} of {len(paths)} paths: bitwise the master "
        f"alone {same}")
    if len(shard) != len(paths) or not same:
        raise RuntimeError("run_multi_host_training in a group of one is not "
                           "the master alone")
    if SO_DEV == "cuda" and backend != "nccl":
        raise RuntimeError(f"the group ran on {backend}, not nccl")
    return {"backend": backend, "paths": len(paths), "bitwise": True}


def phase_scaleout(N, A, seed: int, ffcnn: dict) -> dict:
    """Phase 21: the cluster-training tier on the card ((a)-(f)); K1-K3
    launch on (b) only, every launch on its Hopper body."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    A.reset_launches()
    batches, test, gen_s = so_data()
    result = {"master_lenet": so_master_lenet(batches, test, gen_s, ffcnn)}
    if any(A.LAUNCHES.values()):
        raise RuntimeError("LeNet under the master launched a flash kernel")
    result["attention"], launches = so_attention(N, A, seed)
    torch.cuda.empty_cache()
    A.reset_launches()
    result["ps_wrapper"] = so_ps_wrapper(batches, test)
    result["async"] = so_async()
    result["word2vec"] = so_word2vec()
    result["multi_host"] = so_multi_host(seed)
    if any(A.LAUNCHES.values()):
        raise RuntimeError(f"(c)-(f) launched a flash kernel: {A.LAUNCHES}")
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t0
    return result


# ------------------------------------------------------------- phase 22
#
# Clustering and t-SNE on the card: k-means on config #1's input width
# and on config #4's word vectors, t-SNE of those vectors into the UI, the
# exact t-SNE path at its largest size, the host trees.  CL_DEV = "cpu"
# rehearses the phase on the CPU (at smaller CL_* sizes).

CL_DEV = "cuda"
CL_ROWS, CL_K, CL_MAX_ITER, CL_SEED = 10_000, 10, 100, 0
CL_EXACT_N = 4096            # the exact t-SNE path's largest size
CL_PARITY_ITERS, CL_PARITY_LR = 10, 10.0
CL_RTOL = 1e-4               # 10 t-SNE iterations card vs CPU, of max |y|
CL_CENTER_RTOL = 1e-5        # k-means centers card vs CPU
CL_TIE = 1e-5                # a relative gap below which a pick may flip
CL_KNN, CL_QUERIES, CL_KD_QUERIES = 10, 20, 5
CL_PRESERVED_X = 10.0        # t-SNE kNN kept: at least this times chance
CL_PURITY = 0.85             # exact t-SNE of MNIST: the same-label share
                             # of each point's 10-NN, of the input's
EMB_KEPT: Dict[str, np.ndarray] = {}   # phase 15's trained word vectors


def cl_sync() -> None:
    if CL_DEV == "cuda":
        torch.cuda.synchronize()


def cl_reset_peak() -> int:
    if CL_DEV != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def cl_peak() -> int:
    return torch.cuda.max_memory_allocated() if CL_DEV == "cuda" else 0


def cl_mnist(n: int) -> tuple:
    """``n`` procedural MNIST rows (784 features in [0, 1]) and labels."""
    from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
    ds = next(iter(MnistDataSetIterator(n, n, train=True, shuffle=False)))
    x = np.asarray(ds.features, np.float32).reshape(n, -1)
    return x, np.argmax(np.asarray(ds.labels), axis=1)


def cl_word_vectors() -> np.ndarray:
    """Phase 15's config-#4 Word2Vec vectors (``emb_fit`` keeps them);
    trained here when the phase runs alone."""
    if "vectors" not in EMB_KEPT:
        emb_fit()
    return EMB_KEPT["vectors"]


def cl_ties(x: np.ndarray, centers: np.ndarray, cosine: bool,
            idx: np.ndarray) -> float:
    """The largest relative gap between the best and second-best center
    (float64 on the host) of the rows ``idx``."""
    if not len(idx):
        return 0.0
    a, c = x[idx].astype(np.float64), centers.astype(np.float64)
    if cosine:
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-12)
        c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-12)
        s = np.sort(1.0 - a @ c.T, axis=1)
        return float(np.max(s[:, 1] - s[:, 0]))
    d = np.sort(((a[:, None, :] - c[None]) ** 2).sum(-1), axis=1)
    return float(np.max((d[:, 1] - d[:, 0]) / np.maximum(d[:, 0], 1e-12)))


def cl_step_check(what: str, x: np.ndarray, centers: np.ndarray,
                  cosine: bool) -> dict:
    """One assignment step from the same centers on CL_DEV and on the
    CPU: any disagreement must be a near tie (gap <= CL_TIE in float64).
    Also the reading of TF32 distances: how many picks flip with the
    matmul precision at "high"."""
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    pts = torch.as_tensor(x, device=CL_DEV)
    c = torch.as_tensor(centers, device=CL_DEV)
    with K.ieee_f32_matmul():
        dev = K._assign(pts, c, cosine).cpu().numpy()
        cpu = K._assign(torch.as_tensor(x), torch.as_tensor(centers),
                        cosine).numpy()
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = K._assign(pts, c, cosine).cpu().numpy()
    finally:
        torch.set_float32_matmul_precision(before)
    differ = np.nonzero(dev != cpu)[0]
    gap = cl_ties(x, centers, cosine, differ)
    out = {"step_differ": int(len(differ)), "step_differ_max_gap": gap,
           "tf32_flips": int((tf32 != dev).sum())}
    if gap > CL_TIE:
        raise RuntimeError(f"{what}: an assignment step differs card vs CPU "
                           f"off a near tie (gap {gap:.3g})")
    return out


def cl_kmeans(what: str, x: np.ndarray, metric: str,
              equal_assignments: bool) -> dict:
    """``KMeansClustering(CL_K)`` on CL_DEV and on the CPU from the same
    seed, and the Lloyd loop timed alone from the same k-means++
    centers."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    cosine = metric == "cosinesimilarity"
    km = KMeansClustering(CL_K, CL_MAX_ITER, metric, seed=CL_SEED,
                          device=CL_DEV)
    if km.device.type != CL_DEV:
        raise RuntimeError(f"KMeansClustering runs on {km.device}")
    t0 = time.perf_counter()
    got = km.apply_to(x)
    apply_s = time.perf_counter() - t0
    cpu = KMeansClustering(CL_K, CL_MAX_ITER, metric, seed=CL_SEED,
                           device="cpu")
    want = cpu.apply_to(x)
    pts = torch.as_tensor(x, device=CL_DEV)
    init = torch.as_tensor(km.seed_centers(x, CL_SEED), device=CL_DEV)
    held = cl_reset_peak()
    cl_sync()
    t0 = time.perf_counter()
    _, _, iters, reads = K.lloyd(pts, init, CL_K, CL_MAX_ITER, cosine)
    cl_sync()
    loop_ms = (time.perf_counter() - t0) * 1e3
    peak = cl_peak()
    same = int((got.assignments == want.assignments).sum())
    rel = float(np.max(np.abs(got.centers - want.centers))
                / max(np.max(np.abs(want.centers)), 1e-30))
    out = {"rows": int(x.shape[0]), "dim": int(x.shape[1]), "k": CL_K,
           "metric": metric, "iterations": km.iterations[0],
           "iterations_cpu": cpu.iterations[0], "host_reads": km.host_reads,
           "apply_s": apply_s, "lloyd_ms": loop_ms,
           "ms_per_iteration": loop_ms / max(iters, 1),
           "lloyd_host_reads": reads, "peak_bytes_over_held": peak - held,
           "assignments_equal": same, "centers_rel": rel,
           "cluster_sizes": [c.num_points() for c in got.get_clusters()]}
    out.update(cl_step_check(what, x, want.centers, cosine))
    log(f"[clustering] {what}: k-means k={CL_K} {metric} on "
        f"{x.shape[0]}x{x.shape[1]}: {iters} Lloyd iterations "
        f"({cpu.iterations[0]} on the CPU), {out['ms_per_iteration']:.4f} "
        f"ms an iteration, {km.host_reads} host reads, apply_to "
        f"{apply_s:.3f} s, peak +{(peak - held) / 2**20:.1f} MiB; card vs "
        f"CPU: {same}/{x.shape[0]} assignments equal, centers "
        f"{rel:.3g} of max; one step from the CPU's centers: "
        f"{out['step_differ']} differ (near ties, gap <= "
        f"{out['step_differ_max_gap']:.3g}); TF32 distances would flip "
        f"{out['tf32_flips']}")
    if equal_assignments and same != x.shape[0]:
        raise RuntimeError(f"{what}: {x.shape[0] - same} assignments differ "
                           "card vs CPU")
    if equal_assignments and rel > CL_CENTER_RTOL:
        raise RuntimeError(f"{what}: centers {rel:.3g} card vs CPU")
    return out


def cl_knn_rows(z: torch.Tensor, k: int, block: int = 1024) -> np.ndarray:
    """Each row's ``k`` nearest other rows (squared euclidean, blocked)."""
    n2 = (z * z).sum(1)
    out = []
    for s in range(0, z.shape[0], block):
        d = n2[s:s + block, None] + n2[None] - 2.0 * z[s:s + block] @ z.T
        d[:, s:s + block].diagonal().fill_(float("inf"))
        out.append(torch.topk(-d, k, dim=1).indices.cpu())
    return torch.cat(out).numpy()


def cl_preserved(x: np.ndarray, y: np.ndarray) -> float:
    """The share of each point's CL_KNN nearest neighbours in ``x`` kept
    among its CL_KNN nearest in the embedding ``y`` (chance is CL_KNN/N)."""
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    with K.ieee_f32_matmul():
        a = cl_knn_rows(torch.as_tensor(x, device=CL_DEV), CL_KNN)
        b = cl_knn_rows(torch.as_tensor(y, device=CL_DEV), CL_KNN)
    return float(np.mean([len(np.intersect1d(p, q)) for p, q in zip(a, b)])
                 / CL_KNN)


def cl_purity(z: np.ndarray, labels: np.ndarray) -> float:
    """The share of each row's CL_KNN nearest rows with its label."""
    from deeplearning4j_tpu_torch.clustering import kmeans as K
    with K.ieee_f32_matmul():
        knn = cl_knn_rows(torch.as_tensor(z, device=CL_DEV), CL_KNN)
    return float(np.mean(labels[knn] == labels[:, None]))


def cl_tsne(what: str, x: np.ndarray, **kw) -> tuple:
    """``Tsne(**kw)`` on CL_DEV: the fitted object and its readings."""
    from deeplearning4j_tpu_torch.plot import Tsne
    t = Tsne(device=CL_DEV, **kw)
    held = cl_reset_peak()
    t.fit(x)
    peak = cl_peak() - held
    iters = t.max_iter or float("nan")
    out = {"rows": int(x.shape[0]), "dim": int(x.shape[1]),
           "path": "exact" if x.shape[0] <= t.tile_threshold else "tiled",
           "max_iter": t.max_iter, "perplexity": t.perplexity,
           "affinities_ms": t.phase_ms["affinities"],
           "ms_per_iteration": t.phase_ms["iterations"] / iters,
           "host_reads": t.host_reads, "peak_bytes_over_held": peak,
           "nn_f32_bytes": 4 * x.shape[0] ** 2, "kl": t.kl_divergence}
    log(f"[clustering] {what}: t-SNE ({out['path']}) of {x.shape[0]}x"
        f"{x.shape[1]}, perplexity {t.perplexity}, {t.max_iter} "
        f"iterations: affinities {out['affinities_ms']:.1f} ms, "
        f"{out['ms_per_iteration']:.4f} ms an iteration, {t.host_reads} "
        f"host reads, peak +{peak / 2**20:.1f} MiB beside an (N, N) f32 "
        f"matrix's {out['nn_f32_bytes'] / 2**20:.1f} MiB, KL "
        f"{t.kl_divergence:.4f}")
    if not (np.isfinite(t.coords).all() and np.isfinite(t.kl_divergence)):
        raise RuntimeError(f"{what}: t-SNE gave non-finite values")
    return t, out


def cl_tsne_parity(what: str, x: np.ndarray, **kw) -> dict:
    """CL_PARITY_ITERS iterations on CL_DEV and on the CPU from the same
    seeded draws at learning rate CL_PARITY_LR (the default 200 with
    exaggeration 12 turns float32 rounding into ~1e-3 in 10 steps on any
    two devices), held at CL_RTOL of the largest coordinate."""
    from deeplearning4j_tpu_torch.plot import Tsne
    runs = [Tsne(device=dev, max_iter=CL_PARITY_ITERS,
                 learning_rate=CL_PARITY_LR, **kw).fit(x)
            for dev in (CL_DEV, "cpu")]
    scale = float(np.max(np.abs(runs[1].coords)))
    err = float(np.max(np.abs(runs[0].coords - runs[1].coords))) / scale
    kl = abs(runs[0].kl_divergence - runs[1].kl_divergence) / abs(
        runs[1].kl_divergence)
    log(f"[clustering] {what}: {CL_PARITY_ITERS} t-SNE iterations card vs "
        f"CPU {err:.3g} of max |y| ({scale:.4g}), KL {kl:.3g} relative "
        f"(limit {CL_RTOL})")
    if not (err <= CL_RTOL and kl <= CL_RTOL):
        raise RuntimeError(f"{what}: t-SNE card vs CPU {err:.3g}, KL "
                           f"{kl:.3g}")
    return {"iterations": CL_PARITY_ITERS, "learning_rate": CL_PARITY_LR,
            "max_rel": err, "kl_rel": kl}


def cl_ui_roundtrip(coords: np.ndarray, labels) -> dict:
    """Publish through the port's ``UIServer.set_tsne_data`` and read the
    coordinates back over HTTP from ``GET /tsne/data``."""
    import urllib.request
    from deeplearning4j_tpu_torch.ui.server import UIServer
    srv = UIServer(port=0).start()
    try:
        srv.set_tsne_data(coords, labels)
        t0 = time.perf_counter()
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/tsne/data", timeout=30) as r:
            body = json.loads(r.read())
        get_ms = (time.perf_counter() - t0) * 1e3
    finally:
        srv.stop()
    got = np.asarray(body["coords"])
    if not (np.array_equal(got, coords.astype(float))
            and body["labels"] == [str(l) for l in labels]):
        raise RuntimeError("GET /tsne/data did not return the coordinates")
    log(f"[clustering] /tsne/data: {len(got)} points back over HTTP in "
        f"{get_ms:.1f} ms")
    return {"points": int(len(got)), "get_ms": get_ms}


def cl_trees(v: np.ndarray) -> dict:
    """A VP tree and a KD tree over the word vectors, each query held to
    brute force."""
    from deeplearning4j_tpu_torch.clustering import KDTree, VPTree
    rng = np.random.RandomState(CL_SEED)
    queries = (v[rng.choice(len(v), CL_QUERIES, replace=False)]
               + 0.01 * rng.randn(CL_QUERIES, v.shape[1])).astype(
                   np.float32)
    t0 = time.perf_counter()
    vp = VPTree(v, "euclidean", seed=CL_SEED)
    vp_build = time.perf_counter() - t0
    vp_ms = []
    for q in queries:
        t0 = time.perf_counter()
        idx, dist = vp.knn(q, k=CL_KNN)
        vp_ms.append((time.perf_counter() - t0) * 1e3)
        brute = np.linalg.norm(v - q, axis=1)
        order = np.argsort(brute)[:CL_KNN]
        if not (set(idx.tolist()) == set(order.tolist())
                and np.allclose(dist, brute[order], rtol=1e-5)):
            raise RuntimeError("the VP tree's kNN differs from brute force")
    t0 = time.perf_counter()
    kd = KDTree(v.shape[1])
    for row in v:
        kd.insert(row)
    kd_build = time.perf_counter() - t0
    kd_ms = []
    for q in queries[:CL_KD_QUERIES]:
        t0 = time.perf_counter()
        d, p = kd.nn(q)
        kd_ms.append((time.perf_counter() - t0) * 1e3)
        brute = np.linalg.norm(v.astype(np.float64) - q, axis=1)
        if not (abs(d - brute.min()) <= 1e-5 * brute.min()
                and np.array_equal(p, v[np.argmin(brute)])):
            raise RuntimeError("the KD tree's nn differs from brute force")
    out = {"points": int(len(v)), "vp_build_s": vp_build,
           "vp_knn_ms_median": float(np.median(vp_ms)),
           "kd_build_s": kd_build, "kd_nn_ms_median": float(np.median(kd_ms)),
           "queries": [CL_QUERIES, CL_KD_QUERIES]}
    log(f"[clustering] trees over {len(v)}x{v.shape[1]}: VP build "
        f"{vp_build:.2f} s, {CL_KNN}-NN {out['vp_knn_ms_median']:.2f} ms; KD "
        f"build {kd_build:.2f} s, nn {out['kd_nn_ms_median']:.2f} ms; all "
        "held to brute force")
    return out


def phase_clustering(A) -> dict:
    """Phase 22: clustering and t-SNE (the ``clustering`` path of the
    kernels line: it launches none of K1-K4)."""
    t0 = time.perf_counter()
    cl_sync()
    A.reset_launches()
    x, labels = cl_mnist(CL_ROWS)
    words = cl_word_vectors()
    marks = [("data", time.perf_counter())]
    result = {"kmeans_mnist": cl_kmeans("(a)", x, "euclidean", True)}
    marks.append(("kmeans_mnist", time.perf_counter()))
    result["kmeans_words"] = cl_kmeans("(b)", words, "cosinesimilarity",
                                       False)
    marks.append(("kmeans_words", time.perf_counter()))
    t, tiled = cl_tsne("(c)", words)
    if tiled["path"] != "tiled" or tiled["peak_bytes_over_held"] >= (
            tiled["nn_f32_bytes"] if CL_DEV == "cuda" else 1):
        raise RuntimeError(f"(c) took the {tiled['path']} path with peak "
                           f"{tiled['peak_bytes_over_held']} bytes")
    start = cl_tsne("(c) at iteration 0", words, max_iter=0)[1]["kl"]
    tiled["kl_start"] = start
    tiled["knn_preserved"] = cl_preserved(words, t.coords)
    tiled["knn_chance"] = CL_KNN / len(words)
    log(f"[clustering] (c) KL {start:.4f} -> {t.kl_divergence:.4f}; "
        f"{tiled['knn_preserved']:.4f} of each point's {CL_KNN} nearest "
        f"kept (chance {tiled['knn_chance']:.4f})")
    if not (t.kl_divergence < start and tiled["knn_preserved"]
            >= CL_PRESERVED_X * tiled["knn_chance"]):
        raise RuntimeError("(c) the t-SNE of the word vectors did not learn")
    tiled["ui"] = cl_ui_roundtrip(t.coords, [f"w{i}" for i in
                                             range(len(words))])
    marks.append(("tsne_words", time.perf_counter()))
    tiled["card_vs_cpu"] = cl_tsne_parity("(c)", words)
    marks.append(("tsne_words_card_vs_cpu", time.perf_counter()))
    result["tsne_words"] = tiled
    xe, le = x[:CL_EXACT_N], labels[:CL_EXACT_N]
    t, exact = cl_tsne("(d)", xe)
    start = cl_tsne("(d) at iteration 0", xe, max_iter=0)[1]["kl"]
    exact["kl_start"] = start
    exact["label_purity"] = cl_purity(t.coords, le)
    # the input as fit sees it: each feature standardised
    exact["label_purity_input"] = cl_purity(
        (xe - xe.mean(0)) / np.maximum(xe.std(0), 1e-12), le)
    log(f"[clustering] (d) KL {start:.4f} -> {t.kl_divergence:.4f}; "
        f"{exact['label_purity']:.4f} of each point's {CL_KNN} nearest in "
        f"the embedding share its label "
        f"({exact['label_purity_input']:.4f} in the standardised input)")
    if exact["path"] != "exact" or not (
            t.kl_divergence < start and exact["label_purity"]
            >= CL_PURITY * exact["label_purity_input"]):
        raise RuntimeError("(d) the exact t-SNE of MNIST did not learn")
    marks.append(("tsne_mnist_exact", time.perf_counter()))
    exact["card_vs_cpu"] = cl_tsne_parity("(d)", xe)
    marks.append(("tsne_mnist_card_vs_cpu", time.perf_counter()))
    result["tsne_mnist_exact"] = exact
    result["trees"] = cl_trees(words)
    marks.append(("trees", time.perf_counter()))
    result["launches"] = dict(A.LAUNCHES)
    if any(result["launches"].values()):
        raise RuntimeError("the clustering path launched a flash kernel")
    result["seconds_by_part"] = {
        name: b - a for (_, a), (name, b) in zip(
            [("start", t0)] + marks[:-1], marks)}
    log(f"[clustering] seconds by part {result['seconds_by_part']}")
    result["seconds"] = time.perf_counter() - t0
    return result


# ------------------------------------------------------------- phase 23
#
# The streaming tier on the card: LeNet-5 (config #1) served and trained
# online from a broker topic.  ST_DEV = "cpu" rehearses it on the CPU.

ST_DEV = "cuda"
ST_RECORDS, ST_PARTS, ST_BATCH, ST_CHUNK = 8192, 4, 64, 256
ST_RESUME_RECORDS, ST_SESSION_S = 2048, 2.0
ST_WAIT_S = 120.0


def st_sync() -> None:
    if ST_DEV == "cuda":
        torch.cuda.synchronize()


def st_rows(n: int, first_id: int = 0) -> list:
    """``n`` procedural MNIST records as CSV: an id, 784 features, the
    label."""
    x, labels = cl_mnist(n)
    fmt = "%d," + ",".join(["%.4f"] * 784) + ",%d"
    return [fmt % (first_id + i, *x[i], labels[i]) for i in range(n)]


class StLedger:
    """A CSV converter behind the id column: keeps every delivered id and
    converted row, in delivery order."""

    def __init__(self):
        from deeplearning4j_tpu_torch.streaming import CsvRecordConverter
        self.inner = CsvRecordConverter(label_index=-1, num_classes=10)
        self.ids, self.rows = [], []

    def convert(self, record):
        head, _, rest = record.partition(",")
        row = self.inner.convert(rest)
        self.ids.append(int(head))
        self.rows.append(row)
        return row


def st_at_end(broker, group: str, topic: str) -> bool:
    """Whether the group's committed offsets are the topic's end offsets
    (a partition never committed counts as offset 0)."""
    done = broker.committed(group, topic)
    return all(done.get(p, 0) == end
               for p, end in broker.end_offsets(topic).items())


def st_wait(predicate, what: str) -> float:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > ST_WAIT_S:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def st_produce(broker, topic: str, rows: list) -> float:
    from deeplearning4j_tpu_torch.streaming import StreamProducer
    prod = StreamProducer(broker.host, broker.port)
    try:
        prod.create_topic(topic, ST_PARTS)
        t0 = time.perf_counter()
        for i in range(0, len(rows), ST_CHUNK):
            prod.produce(topic, rows[i:i + ST_CHUNK])     # round-robin
        return time.perf_counter() - t0
    finally:
        prod.close()


def st_replay(twin, ledger: StLedger, outs: list) -> int:
    """Each micro-batch's predictions are ``twin.output`` on the same
    padded rows, bitwise, and ``twin`` then fits the same rows cycled to
    ST_BATCH: afterwards its state must equal the pipeline's network."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    pos = 0
    for x, out in outs:
        n = len(x)
        feats = np.stack([f for f, _ in ledger.rows[pos:pos + n]])
        ys = np.stack([l for _, l in ledger.rows[pos:pos + n]])
        if not np.array_equal(feats, x):
            raise RuntimeError("a micro-batch is not the delivered rows")
        padded = np.concatenate([feats, np.repeat(feats[-1:], ST_BATCH - n,
                                                  axis=0)])
        want = twin.output(padded).detach().cpu().numpy()[:n]
        if not np.array_equal(out, want):
            raise RuntimeError(f"micro-batch at row {pos}: predictions are "
                               "not net.output of its rows")
        idx = np.arange(ST_BATCH) % n
        twin.fit(DataSet(feats[idx], ys[idx]))
        pos += n
    return pos


def st_lenet():
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(lenet(), device=ST_DEV).init()


def st_serve_and_train(broker) -> dict:
    """(a) 8,192 records to a 4-partition topic; (b) LeNet-5 behind
    ``StreamingPipeline(mode="both", batch_size=64)`` over a
    ``BrokerRecordSource``: records a second, ``streaming_batch_ms``, and
    the bitwise replay of every micro-batch."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.streaming import (BrokerRecordSource,
                                                    StreamConsumer,
                                                    StreamingPipeline)
    t0 = time.perf_counter()
    rows = st_rows(ST_RECORDS)
    make_s = time.perf_counter() - t0
    produce_s = st_produce(broker, "mnist", rows)
    net = st_lenet()
    twin = net.clone()
    ledger, outs = StLedger(), []
    src = BrokerRecordSource(StreamConsumer(broker.host, broker.port,
                                            "lenet", ["mnist"]),
                             fetch_size=ST_BATCH)
    pipe = StreamingPipeline(
        net, src, ledger, mode="both", batch_size=ST_BATCH,
        flush_interval=0.5, device=ST_DEV,
        on_prediction=lambda x, o: outs.append((x, o)))
    monitor.reset()
    st_sync()
    with deterministic(), cudnn_deterministic():
        pipe.start()
        try:
            secs = st_wait(lambda: pipe.batches_processed
                           >= ST_RECORDS // ST_BATCH, "the micro-batches")
        finally:
            pipe.stop(timeout=30.0)
            src.close()
        st_sync()
        stats = monitor.registry().histogram("streaming_batch_ms").stats()
        if pipe.errors or sorted(ledger.ids) != list(range(ST_RECORDS)):
            raise RuntimeError(f"(b) errors {pipe.errors[:3]}; delivered "
                               f"{len(ledger.ids)} of {ST_RECORDS}")
        replayed = st_replay(twin, ledger, outs)
        if replayed != ST_RECORDS or not so_equal(net, twin):
            raise RuntimeError("(b) the trained net is not a plain fit of "
                               "its micro-batches")
        profile = st_profiled_batch(twin, ledger)
    if not st_at_end(broker, "lenet", "mnist"):
        raise RuntimeError("(b) the group's offsets are not the end offsets")
    out = {"records": ST_RECORDS, "partitions": ST_PARTS,
           "batch_size": ST_BATCH, "make_rows_s": make_s,
           "produce_s": produce_s, "run_s": secs,
           "records_per_s": ST_RECORDS / secs,
           "batches": pipe.batches_processed,
           "streaming_batch_ms": {k: stats[k] for k in
                                  ("count", "p50", "p99", "max")},
           "counters": {name: monitor.counter(name).value() for name in
                        ("streaming_records_total",
                         "streaming_batches_total")},
           "profiled_batch": profile}
    log(f"[streaming] (a) {ST_RECORDS} records of 786 CSV columns made in "
        f"{make_s:.2f} s, produced to {ST_PARTS} partitions in "
        f"{produce_s:.2f} s; (b) LeNet-5 mode=both batch {ST_BATCH}: "
        f"{pipe.batches_processed} micro-batches in {secs:.2f} s "
        f"({out['records_per_s']:.1f} records/s), streaming_batch_ms p50 "
        f"{stats['p50']:.3f} p99 {stats['p99']:.3f} max {stats['max']:.3f};"
        f" predictions and params bitwise a plain replay; one micro-batch "
        f"profiled: host {profile['wall_ms']:.3f} ms, device busy "
        f"{profile['device_busy_ms']:.3f} ms, idle share "
        f"{profile['idle_share']:.3f}")
    return out


def st_profiled_batch(net, ledger: StLedger) -> dict:
    """One micro-batch (predict, host copy, fit) of a pipeline that is not
    started, under ``torch.profiler``."""
    from deeplearning4j_tpu_torch.streaming import (InMemoryRecordSource,
                                                    StreamingPipeline)
    pipe = StreamingPipeline(net, InMemoryRecordSource(), ledger.inner,
                             mode="both", batch_size=ST_BATCH,
                             device=ST_DEV)
    feats = [f for f, _ in ledger.rows[:ST_BATCH]]
    labels = [l for _, l in ledger.rows[:ST_BATCH]]
    pipe._process(feats, labels)                 # warm
    if ST_DEV != "cuda":
        return {"wall_ms": float("nan"), "device_busy_ms": float("nan"),
                "idle_share": float("nan"), "device_events": 0}
    wall_ms, events, _, busy_ms = profiled(
        lambda: pipe._process(feats, labels))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "device_events": events}


def st_at_least_once() -> dict:
    """(c) A consumer stops mid-stream without its last commit and
    without leaving (a crash); a new one in the same group takes over
    after the session timeout: every offset is processed at least once
    and the committed offsets end at the end offsets."""
    from deeplearning4j_tpu_torch.streaming import (BrokerRecordSource,
                                                    StreamBroker,
                                                    StreamConsumer,
                                                    StreamingPipeline)

    class Crashing(BrokerRecordSource):
        crashed = False

        def on_batch_processed(self):
            if not self.crashed:
                super().on_batch_processed()

    broker = StreamBroker(session_timeout=ST_SESSION_S)
    try:
        st_produce(broker, "resume", st_rows(ST_RESUME_RECORDS))
        net = st_lenet()

        def run(src, ledger):
            return StreamingPipeline(net, src, ledger, mode="both",
                                     batch_size=ST_BATCH, flush_interval=0.5,
                                     device=ST_DEV).start()

        first, second = StLedger(), StLedger()
        src1 = Crashing(StreamConsumer(broker.host, broker.port, "resume",
                                       ["resume"], heartbeat_interval=0.2),
                        fetch_size=ST_BATCH)
        pipe1 = run(src1, first)
        st_wait(lambda: pipe1.records_processed >= ST_RESUME_RECORDS // 2,
                "half the records")
        src1.crashed = True
        mark = pipe1.batches_processed
        st_wait(lambda: pipe1.batches_processed > mark, "an uncommitted batch")
        pipe1.stop(timeout=30.0)
        src1.consumer.close(leave=False)            # no leave: a crash
        committed = broker.committed("resume", "resume")
        src2 = BrokerRecordSource(StreamConsumer(
            broker.host, broker.port, "resume", ["resume"],
            heartbeat_interval=0.2), fetch_size=ST_BATCH)
        pipe2 = run(src2, second)
        try:
            secs = st_wait(lambda: st_at_end(broker, "resume", "resume"),
                           "the committed offsets to reach the end")
        finally:
            pipe2.stop(timeout=30.0)
            src2.close()
        seen = first.ids + second.ids
        missing = set(range(ST_RESUME_RECORDS)) - set(seen)
        out = {"records": ST_RESUME_RECORDS,
               "first_processed": len(first.ids),
               "committed_at_crash": sum(committed.values()),
               "second_processed": len(second.ids),
               "replayed": len(seen) - ST_RESUME_RECORDS,
               "takeover_s": secs, "missing": len(missing),
               "errors": len(pipe1.errors) + len(pipe2.errors)}
        log(f"[streaming] (c) at-least-once: the first consumer processed "
            f"{len(first.ids)}, {out['committed_at_crash']} committed at "
            f"its crash; the second processed {len(second.ids)} and "
            f"committed the end offsets in {secs:.2f} s; {out['replayed']} "
            f"replayed, {len(missing)} missing")
        if missing or out["errors"] or out["replayed"] < ST_BATCH:
            raise RuntimeError(f"(c) at-least-once failed: {out}")
        return out
    finally:
        broker.close()


def phase_streaming(A) -> dict:
    """Phase 23: the streaming tier (the ``streaming`` path of the
    kernels line: it launches none of K1-K4).  Every thread the phase
    starts must be gone when it ends."""
    from deeplearning4j_tpu_torch.streaming import StreamBroker
    t0 = time.perf_counter()
    before = set(threading.enumerate())
    st_sync()
    A.reset_launches()
    broker = StreamBroker()
    try:
        result = {"serve_and_train": st_serve_and_train(broker)}
    finally:
        broker.close()
    result["at_least_once"] = st_at_least_once()
    result["launches"] = dict(A.LAUNCHES)
    if any(result["launches"].values()):
        raise RuntimeError("the streaming path launched a flash kernel")
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive()]
    result["threads_left"] = left
    if left:
        raise RuntimeError(f"threads still alive after phase 23: {left}")
    result["seconds"] = time.perf_counter() - t0
    return result


# ------------------------------------------------------------- phase 24
#
# The native tier on the card: NativeModelRunner (captured CUDA graphs over
# a paged weight arena), the engine's native backend behind a
# ModelRegistry, the native data tier (the IDX decode and the prefetch
# ring), the Java DL4J zip and ModelGuesser.  NT_DEV = "cpu" with smaller
# NT_* sizes rehearses it on the CPU (the plain versions: eager callables,
# a host arena).

NT_DEV = "cuda"
NT_LENET_BATCHES = (1, 8, 64, 256)
NT_RESNET_BATCHES = (1, 32, 128)
NT_RESNET_SIZE = 224
NT_LRU_BATCHES = (1, 2, 4, 8, 16, 32)   # 6 sizes through max_shapes=4
NT_REPS = {"lenet": 20, "resnet": 5}
NT_FP32_RTOL, NT_BF16_RTOL = 1e-5, 1e-2
NT_MNIST_ROWS = 60000
NT_RING_BATCH = 256
NT_RING_SEED = 5
NT_PROFILED_BATCHES = 20
NT_PROFILED_CALLS = 10
MNIST_KEPT: Dict[str, np.ndarray] = {}   # phase 13's MNIST, for phase 24


def nt_sync() -> None:
    if NT_DEV == "cuda":
        torch.cuda.synchronize()


def nt_hold(what: str, got: np.ndarray, want: np.ndarray, bf16: bool
            ) -> dict:
    """Graph against eager: bitwise, else the max difference relative to
    the eager output's largest magnitude, within NT_FP32_RTOL
    (NT_BF16_RTOL for a bf16 network)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: shape {got.shape} against {want.shape}")
    if not np.isfinite(got).all():
        raise RuntimeError(f"{what}: non-finite outputs")
    if np.array_equal(got, want):
        return {"bitwise": True, "max_rel": 0.0}
    rel = float(np.max(np.abs(got.astype(np.float64) - want))
                / max(float(np.max(np.abs(want))), 1e-30))
    tol = NT_BF16_RTOL if bf16 else NT_FP32_RTOL
    log(f"[native] {what}: not bitwise, max |diff| / max |eager| {rel:.3e} "
        f"(held within {tol})")
    if rel > tol:
        raise RuntimeError(f"{what}: graph vs eager {rel} > {tol}")
    return {"bitwise": False, "max_rel": rel}


def nt_eager(net, x: np.ndarray) -> np.ndarray:
    out = net.output(x)
    return (out[0] if isinstance(out, list) else out).float().cpu().numpy()


def nt_ms(fn, reps: int) -> dict:
    fn()
    ms = []
    for _ in range(reps):
        nt_sync()
        t0 = time.perf_counter()
        fn()
        nt_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(ms)), "min": float(min(ms)),
            "max": float(max(ms))}


def nt_example() -> dict:
    """(a): examples/native_inference.py in the port: the 16-32-4 MLP, 5
    fit steps, then batches 8, 8, 3 through the runner."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.conf import inputs
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import \
        NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, \
        OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
    conf = (NeuralNetConfiguration.builder()
            .seed(9).updater("adam").learning_rate(0.02)
            .activation("relu").weight_init("xavier").list()
            .layer(DenseLayer(n_out=32))
            .layer(OutputLayer(n_out=4))
            .set_input_type(inputs.feed_forward(16))
            .build())
    net = MultiLayerNetwork(conf, device=NT_DEV).init()
    rng = np.random.RandomState(0)
    for _ in range(5):
        net.fit(DataSet(rng.randn(64, 16).astype(np.float32),
                        np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)]))
    checks = []
    with NativeModelRunner(net, device=NT_DEV) as runner:
        for batch in (8, 8, 3):
            x = rng.randn(batch, 16).astype(np.float32)
            checks.append(nt_hold(f"(a) batch {batch}", runner.output(x),
                                  nt_eager(net, x),
                                  net._pol().name != "fp32"))
        stats = runner.cache_stats()
    log(f"[native] (a) the example's MLP ({net._pol().name}): batches 8, 8, "
        f"3 through the runner, {stats}; bitwise "
        f"{[c['bitwise'] for c in checks]}")
    if stats["entries"] != 2:
        raise RuntimeError(f"(a) {stats['entries']} entries, not 2")
    return {"policy": net._pol().name, "cache": stats, "checks": checks}


def nt_models():
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return {"lenet": MultiLayerNetwork(lenet(), device=NT_DEV).init(),
            "resnet": ComputationGraph(resnet50(
                height=NT_RESNET_SIZE, width=NT_RESNET_SIZE),
                device=NT_DEV).init()}


def nt_input(name: str, batch: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if name == "lenet":
        return rng.rand(batch, 784).astype(np.float32)
    return rng.rand(batch, NT_RESNET_SIZE, NT_RESNET_SIZE, 3).astype(
        np.float32)


def nt_full_width(models) -> dict:
    """(b): LeNet-5 and ResNet-50 through NativeModelRunner at full width:
    ms of runner.output (host clock, numpy out) beside the eager output()
    with its host copy and the aot engine's predict; captures, pool bytes,
    arena bytes and a profiled runner.output's idle share; graph vs eager
    bitwise or within the stated tolerance."""
    from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    out = {}
    for name, batches in (("lenet", NT_LENET_BATCHES),
                          ("resnet", NT_RESNET_BATCHES)):
        net = models[name]
        bf16 = net._pol().name != "fp32"
        runner = NativeModelRunner(net, device=NT_DEV)
        engine = InferenceEngine(net, max_batch_size=max(batches),
                                 max_latency_ms=0.0,
                                 name=f"aot_{name}").start()
        rows, answers = [], {}
        try:
            for b in batches:
                x = nt_input(name, b, seed=b)
                t0 = time.perf_counter()
                y = runner.output(x)
                capture_ms = (time.perf_counter() - t0) * 1e3
                check = nt_hold(f"(b) {name} batch {b}", y,
                                nt_eager(net, x), bf16)
                answers[b] = (x, y)
                reps = NT_REPS[name]
                row = {"batch": b, "capture_ms": capture_ms, **check,
                       "runner_ms": nt_ms(lambda: runner.output(x), reps),
                       "eager_ms": nt_ms(lambda: nt_eager(net, x), reps),
                       "aot_predict_ms": nt_ms(
                           lambda: engine.predict(x, timeout=WAIT_S), reps)}
                if NT_DEV == "cuda":
                    # the pool after this capture beside the eager
                    # forward's own peak above what was held before it
                    row["pool_bytes"] = runner.cache_stats()["pool_bytes"]
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    nt_eager(net, x)
                    row["eager_peak_bytes"] = \
                        torch.cuda.max_memory_allocated() - held
                    wall, events, _, busy = profiled(lambda: [
                        runner.output(x) for _ in range(NT_PROFILED_CALLS)])
                    # no device event at all: the profiler saw nothing (the
                    # replays did run), so the share is not measured
                    row["profiled"] = {"calls": NT_PROFILED_CALLS,
                                       "wall_ms": wall,
                                       "device_events": events,
                                       "busy_ms": busy,
                                       "idle_share": (1.0 - busy / wall
                                                      if events else None)}
                rows.append(row)
                log(f"[native] (b) {name} batch {b}: runner "
                    f"{row['runner_ms']['median']:.3f} ms, eager output()+"
                    f"copy {row['eager_ms']['median']:.3f} ms, aot predict "
                    f"{row['aot_predict_ms']['median']:.3f} ms (medians of "
                    f"{reps}); capture call {capture_ms:.1f} ms; bitwise "
                    f"{check['bitwise']}"
                    + (f"; pool {_mb(row['pool_bytes'])} MiB after this "
                       f"capture, eager forward peak "
                       f"{_mb(row['eager_peak_bytes'])} MiB"
                       if "pool_bytes" in row else "")
                    + (f"; {NT_PROFILED_CALLS} profiled runner.output calls:"
                       f" idle share {row['profiled']['idle_share']} of "
                       f"{row['profiled']['wall_ms']:.3f} ms, "
                       f"{row['profiled']['device_events']} device events"
                       if "profiled" in row else ""))
            stats = runner.cache_stats()
            out[name] = {"policy": net._pol().name, "rows": rows,
                         "cache": stats, "arena_bytes": runner.arena_bytes,
                         "resident_bytes": runner.resident_bytes(),
                         "answers": answers}
            log(f"[native] (b) {name}: captures {stats['captures']}, "
                f"entries {stats['entries']}, pool {_mb(stats['pool_bytes'])}"
                f" MiB, arena {_mb(runner.arena_bytes)} MiB "
                f"({runner.resident_bytes()} bytes of leaves)")
            if stats["captures"] != (len(batches) if NT_DEV == "cuda"
                                     else 0):
                raise RuntimeError(f"(b) {name}: {stats['captures']} "
                                   f"captures for {len(batches)} shapes")
        finally:
            engine.stop()
            runner.close()
        nt_sync()
        if NT_DEV == "cuda":
            torch.cuda.empty_cache()
    return out


def nt_lru(net) -> dict:
    """(c): max_shapes=4, 6 batch sizes cycled twice through a LeNet-5
    runner: evictions counted, entries <= 4, pool bytes bounded."""
    from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
    pools = []
    with NativeModelRunner(net, max_shapes=4, device=NT_DEV) as runner:
        for cycle in range(2):
            for b in NT_LRU_BATCHES:
                runner.output(nt_input("lenet", b, seed=100 + b))
                stats = runner.cache_stats()
                if stats["entries"] > 4:
                    raise RuntimeError(f"(c) {stats['entries']} entries")
                pools.append((cycle, stats["pool_bytes"]))
        stats = runner.cache_stats()
        evictions = runner.evictions
    want = 2 * len(NT_LRU_BATCHES) - 4
    first = max(p for c, p in pools if c == 0)
    second = max(p for c, p in pools if c == 1)
    log(f"[native] (c) LRU: {len(NT_LRU_BATCHES)} sizes twice through "
        f"max_shapes=4: evictions {evictions} (want {want}), {stats}; pool "
        f"peak {_mb(first)} MiB in cycle 1, {_mb(second)} MiB in cycle 2")
    if evictions != want or stats["entries"] != 4:
        raise RuntimeError(f"(c) evictions {evictions}, entries "
                           f"{stats['entries']}")
    if second > 1.25 * first:
        raise RuntimeError(f"(c) the pool grew: {first} -> {second}")
    return {"evictions": evictions, "cache": stats,
            "pool_peak_bytes": [first, second]}


def nt_paging(models) -> dict:
    """(d): two backend="native" engines (LeNet-5, ResNet-50) in a
    ModelRegistry whose budget holds one; requests alternate.  A page-out
    frees at least the arena's bytes (mem_get_info: the arena is outside
    torch's allocator), answers after page-in are bitwise those before,
    no graph is captured again, every leaf view keeps its data_ptr."""
    from deeplearning4j_tpu_torch.serving import (InferenceEngine,
                                                  ModelRegistry)
    batch = {"lenet": 8, "resnet": 2}
    engines, refs, xs = {}, {}, {}
    for name, net in models.items():
        eng = InferenceEngine(net, backend="native", max_batch_size=8,
                              max_latency_ms=0.0, name=f"native_{name}")
        eng.start()
        xs[name] = nt_input(name, batch[name], seed=7)
        refs[name] = eng.predict(xs[name], timeout=WAIT_S)
        engines[name] = eng
    runners = {n: e.native_runner for n, e in engines.items()}
    ptrs = {n: [v.data_ptr() for v in r.leaf_views()]
            for n, r in runners.items()}
    captures = {n: r.cache_stats()["captures"] for n, r in runners.items()}
    freed = {}
    for name, eng in engines.items():
        r = runners[name]
        nt_sync()
        before = torch.cuda.mem_get_info()[0] if NT_DEV == "cuda" else 0
        released = eng.release_device_buffers()
        nt_sync()
        after = torch.cuda.mem_get_info()[0] if NT_DEV == "cuda" else 0
        freed[name] = {"released_bytes": released,
                       "mem_get_info_freed": after - before,
                       "arena_bytes": r.arena_bytes}
        if NT_DEV == "cuda" and after - before < r.arena_bytes:
            raise RuntimeError(f"(d) {name}: page-out freed "
                               f"{after - before} < {r.arena_bytes} bytes")
        if eng.resident_bytes() != 0:
            raise RuntimeError(f"(d) {name} still resident")
    budget = max(e.model_bytes() for e in engines.values()) + \
        min(e.model_bytes() for e in engines.values()) // 2
    reg = ModelRegistry(hbm_budget_bytes=budget)
    for name, eng in engines.items():
        reg.register(name, eng, start=False)
    seq, pageins = [], {n: [] for n in engines}
    try:
        for i in range(6):
            name = ("lenet", "resnet")[i % 2]
            t0 = time.perf_counter()
            got = reg.predict(name, xs[name], timeout=WAIT_S)
            seq.append((name, (time.perf_counter() - t0) * 1e3))
            if not np.array_equal(got, refs[name]):
                raise RuntimeError(f"(d) {name}: answer after page-in "
                                   "differs")
            other = engines["resnet" if name == "lenet" else "lenet"]
            if other.is_resident():
                raise RuntimeError("(d) the budget held both models")
        for name, eng in engines.items():
            for _ in range(3):
                eng.release_device_buffers()
                nt_sync()
                t0 = time.perf_counter()
                eng.ensure_resident()
                nt_sync()
                pageins[name].append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(eng.predict(xs[name], timeout=WAIT_S),
                                  refs[name]):
                raise RuntimeError(f"(d) {name}: answer differs")
        after_captures = {n: r.cache_stats()["captures"]
                          for n, r in runners.items()}
        after_ptrs = {n: [v.data_ptr() for v in r.leaf_views()]
                      for n, r in runners.items()}
    finally:
        for name in list(engines):
            reg.unregister(name)
    if after_captures != captures:
        raise RuntimeError(f"(d) captures moved: {captures} -> "
                           f"{after_captures}")
    if after_ptrs != ptrs:
        raise RuntimeError("(d) a leaf view moved")
    log(f"[native] (d) paging: budget {_mb(budget)} MiB; page-out freed "
        + ", ".join(f"{n} {_mb(f['mem_get_info_freed'])} MiB "
                    f"(arena {_mb(f['arena_bytes'])} MiB)"
                    for n, f in freed.items())
        + "; registry requests (ms) "
        + ", ".join(f"{n} {ms:.2f}" for n, ms in seq)
        + "; page-in ms " + ", ".join(
            f"{n} {[round(m, 3) for m in ms]}" for n, ms in pageins.items())
        + f"; captures unchanged {captures}; every leaf's data_ptr kept")
    return {"budget_bytes": budget, "freed": freed, "requests_ms": seq,
            "pagein_ms": pageins, "captures": captures}


def nt_write_idx(tmp: str, u8: np.ndarray, labels: np.ndarray) -> None:
    import struct
    n = u8.shape[0]
    with open(os.path.join(tmp, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, 28, 28) + u8.tobytes())
    with open(os.path.join(tmp, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">ii", 2049, n) +
                labels.argmax(1).astype(np.uint8).tobytes())


def nt_ring_order(n: int, batch: int, seed: int, batches: int):
    """The prefetch ring's row order, in plain Python: dataloader.cc's
    xorshift64 and its Fisher-Yates pass at each epoch's start."""
    mask = (1 << 64) - 1
    s = seed or 0x9E3779B97F4A7C15
    order = list(range(n))
    rows, pos = [], n
    for _ in range(batches):
        if pos + batch > n:
            for i in range(n - 1, 0, -1):
                s ^= (s << 13) & mask
                s ^= s >> 7
                s ^= (s << 17) & mask
                j = s % (i + 1)
                order[i], order[j] = order[j], order[i]
            pos = 0
        rows.append(order[pos:pos + batch])
        pos += batch
    return rows


def nt_data_tier(u8: np.ndarray, labels: np.ndarray) -> dict:
    """(e): NT_MNIST_ROWS procedural MNIST rows as IDX files, the native
    decode against the numpy one; LeNet-5 one epoch at batch 256 from
    AsyncDataSetIterator on the native ring and on the Python thread; the
    ring's batches bitwise a plain Python replay of its order, and the
    ring epoch's params bitwise a plain fit over those batches."""
    import tempfile

    from deeplearning4j_tpu_torch import nativeops
    from deeplearning4j_tpu_torch.datasets import DataSet, mnist
    from deeplearning4j_tpu_torch.datasets.dataset import attach_wire
    from deeplearning4j_tpu_torch.datasets.iterators import (
        AsyncDataSetIterator, ExistingDataSetIterator, ListDataSetIterator)
    from deeplearning4j_tpu_torch.datasets.normalizers import U8_PIXEL
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    out = {}
    t0 = time.perf_counter()
    nativeops.load_native()        # g++ at first use in this process
    out["load_native_ms"] = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        nt_write_idx(tmp, u8, labels)
        path = os.path.join(tmp, "train-images-idx3-ubyte")
        t0 = time.perf_counter()
        native = nativeops.idx_decode(path, normalize=False)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = mnist._read_idx(path)
        plain_ms = (time.perf_counter() - t0) * 1e3
        saved = os.environ.get("MNIST_DIR")
        os.environ["MNIST_DIR"] = tmp
        try:
            via_iterator = mnist.mnist_arrays_u8(True, u8.shape[0])
        finally:
            if saved is None:
                os.environ.pop("MNIST_DIR")
            else:
                os.environ["MNIST_DIR"] = saved
    if not (np.array_equal(native.reshape(plain.shape).astype(np.uint8),
                           plain) and np.array_equal(plain, u8)
            and np.array_equal(via_iterator[0], u8)
            and np.array_equal(via_iterator[1], labels)):
        raise RuntimeError("(e) the native IDX decode differs")
    out["decode_ms"] = {"native": native_ms, "numpy": plain_ms}
    log(f"[native] (e) {u8.shape[0]} MNIST rows as IDX: native decode "
        f"{native_ms:.1f} ms, numpy {plain_ms:.1f} ms, bitwise equal (the "
        f"library loaded in {out['load_native_ms']:.1f} ms before)")
    n = (u8.shape[0] // NT_RING_BATCH) * NT_RING_BATCH
    u8n, ln = u8[:n], labels[:n]
    ds = attach_wire(DataSet(U8_PIXEL.decode_host(u8n), ln), u8n, U8_PIXEL)

    def iterator(use_native: bool, shuffle: bool = True):
        return AsyncDataSetIterator(
            ListDataSetIterator(ds, NT_RING_BATCH, shuffle=shuffle,
                                seed=NT_RING_SEED), use_native=use_native)

    # the ring's batches against the plain replay of its order
    it = iterator(True)
    if not it.native:
        raise RuntimeError("(e) the native ring did not engage")
    ring = list(it)
    it.close()
    rows = nt_ring_order(n, NT_RING_BATCH, NT_RING_SEED, len(ring))
    for b, r in zip(ring, rows):
        if not (np.array_equal(b.features, ds.features[r])
                and np.array_equal(b.labels, ln[r])):
            raise RuntimeError("(e) a ring batch differs from the replay")
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for route, native_ring in (("ring", True), ("python", False)):
            net = MultiLayerNetwork(lenet(), device=NT_DEV).init()
            src = iterator(native_ring)
            nt_sync()
            t0 = time.perf_counter()
            net.fit(src, ingest="batch")
            nt_sync()
            secs = time.perf_counter() - t0
            src.close()
            row = {"samples_per_s": n / secs, "seconds": secs,
                   "batches": net.iteration}
            if route == "ring":
                ring_params = net.get_flat_params()   # before more fits
            if NT_DEV == "cuda":
                small = AsyncDataSetIterator(ListDataSetIterator(
                    DataSet(ds.features[:NT_PROFILED_BATCHES *
                                        NT_RING_BATCH],
                            ln[:NT_PROFILED_BATCHES * NT_RING_BATCH]),
                    NT_RING_BATCH, shuffle=True), use_native=native_ring)
                wall, events, _, busy = profiled(
                    lambda: net.fit(small, ingest="batch"))
                small.close()
                row["profiled"] = {"batches": NT_PROFILED_BATCHES,
                                   "wall_ms": wall, "device_events": events,
                                   "idle_share": 1.0 - busy / wall}
            out[route] = row
            log(f"[native] (e) LeNet-5 one epoch of {n} rows at batch "
                f"{NT_RING_BATCH} on the {route}: {row['samples_per_s']:.1f}"
                f" samples/s ({secs:.3f} s)"
                + (f"; {NT_PROFILED_BATCHES} profiled batches idle share "
                   f"{row['profiled']['idle_share']:.3f}"
                   if "profiled" in row else ""))
        replay = MultiLayerNetwork(lenet(), device=NT_DEV).init()
        replay.fit(ExistingDataSetIterator(ring), ingest="batch")
        replayed = replay.get_flat_params()
        same = np.array_equal(replayed, ring_params)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    if not same:
        raise RuntimeError(
            "(e) the ring epoch's params differ from a plain fit over its "
            "batches: max |diff| "
            f"{float(np.max(np.abs(replayed - ring_params)))}")
    log(f"[native] (e) {len(ring)} ring batches bitwise the replayed "
        "order; the ring epoch's params bitwise a plain fit over them")
    out["ring_batches"] = len(ring)
    return out


def nt_utils(models, lenet_answer) -> dict:
    """(f): LeNet-5 through the Java DL4J zip and back (params bitwise);
    load_model_guess on a port serializer zip gives a network that the
    runner serves with (b)'s answers."""
    import tempfile

    from deeplearning4j_tpu_torch.nn.native_runtime import NativeModelRunner
    from deeplearning4j_tpu_torch.utils.model_guesser import load_model_guess
    from deeplearning4j_tpu_torch.utils.model_serializer import write_model
    from deeplearning4j_tpu_torch.utils.reference_serializer import (
        read_reference_model, write_reference_model)
    net = models["lenet"]
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "lenet_dl4j.zip")
        write_reference_model(net, ref)
        back = read_reference_model(ref, device=NT_DEV)
        java_bitwise = np.array_equal(back.get_flat_params(),
                                      net.get_flat_params())
        zip_path = os.path.join(tmp, "lenet.zip")
        write_model(net, zip_path)
        guessed = load_model_guess(zip_path, device=NT_DEV)
    x, want = lenet_answer
    with NativeModelRunner(guessed, device=NT_DEV) as runner:
        got = runner.output(x)
    log(f"[native] (f) LeNet-5 through the Java DL4J zip: params bitwise "
        f"{java_bitwise}; load_model_guess -> {type(guessed).__name__}, "
        f"served through the runner: bitwise (b)'s answer "
        f"{np.array_equal(got, want)}")
    if not java_bitwise:
        raise RuntimeError("(f) the Java DL4J zip changed the params")
    if not np.array_equal(got, want):
        raise RuntimeError("(f) the guessed network's answer differs")
    return {"java_zip_params_bitwise": True, "guessed_bitwise": True}


def phase_native(A) -> dict:
    """Phase 24: the native tier (the ``native`` path of the kernels line:
    it launches none of K1-K4)."""
    from deeplearning4j_tpu_torch.datasets import mnist
    t0 = time.perf_counter()
    nt_sync()
    A.reset_launches()
    marks = []
    result = {"example": nt_example()}
    marks.append(("example", time.perf_counter()))
    models = nt_models()
    full = nt_full_width(models)
    marks.append(("full_width", time.perf_counter()))
    lenet_b = dict(full["lenet"]["answers"])
    for name in full:
        full[name].pop("answers")
    result["full_width"] = full
    result["lru"] = nt_lru(models["lenet"])
    marks.append(("lru", time.perf_counter()))
    result["paging"] = nt_paging(models)
    marks.append(("paging", time.perf_counter()))
    if "u8" in MNIST_KEPT:
        u8, labels = MNIST_KEPT["u8"], MNIST_KEPT["labels"]
    else:
        u8, labels = mnist.mnist_arrays_u8(True, NT_MNIST_ROWS)
    marks.append(("mnist", time.perf_counter()))
    result["data_tier"] = nt_data_tier(u8[:NT_MNIST_ROWS],
                                       labels[:NT_MNIST_ROWS])
    marks.append(("data_tier", time.perf_counter()))
    result["utils"] = nt_utils(models, lenet_b[8])
    marks.append(("utils", time.perf_counter()))
    result["launches"] = dict(A.LAUNCHES)
    if any(result["launches"].values()):
        raise RuntimeError("the native path launched a flash kernel")
    result["seconds_by_part"] = {
        name: b - a for (_, a), (name, b) in zip(
            [("start", t0)] + marks[:-1], marks)}
    log(f"[native] seconds by part {result['seconds_by_part']}")
    result["seconds"] = time.perf_counter() - t0
    return result


# ---------------------------------------------------------------- phase 25
UC_DEV = "cuda"
UC_BATCH = 256
UC_ROWS = 234 * UC_BATCH     # phase 24's LeNet-5 epoch: 59,904 rows
UC_CACHE_ROWS = 60000        # the armed epoch-cache fit: 234 steps + a tail
UC_HIST_EVERY = 25           # HistogramIterationListener(frequency=25)
UC_CONV_EVERY = 25
UC_PROBE = 8
UC_PROFILED_BATCHES = 20
UC_PREDICT_ROWS = 256
UC_DECODE_TOKENS = 1030      # single tokens: the ring hops 1024 -> 2048
UC_PREDICT_T = 64            # the armed engine's one predict bucket
UC_POD_STEPS = 8
UC_POD_TIMEOUT_S = 300.0


def uc_sync() -> None:
    if UC_DEV == "cuda":
        torch.cuda.synchronize()


def uc_mnist():
    """Phase 24's MNIST rows (its ``MNIST_KEPT``, else made here), float32
    features as the readers decode them."""
    from deeplearning4j_tpu_torch.datasets import mnist
    from deeplearning4j_tpu_torch.datasets.normalizers import U8_PIXEL
    rows = max(UC_ROWS, UC_CACHE_ROWS)
    if "u8" in MNIST_KEPT and MNIST_KEPT["u8"].shape[0] >= rows:
        u8, labels = MNIST_KEPT["u8"], MNIST_KEPT["labels"]
    else:
        u8, labels = mnist.mnist_arrays_u8(True, rows)
    return U8_PIXEL.decode_host(u8[:rows]), np.asarray(labels[:rows])


class uc_timed:
    """A listener wrapper that keeps the host ms of each of the inner
    listener's firings (``every``: its frequency)."""

    def __init__(self, inner, every: int):
        self.inner, self.every, self.ms = inner, every, []

    def iteration_done(self, model, iteration: int) -> None:
        t0 = time.perf_counter()
        self.inner.iteration_done(model, iteration)
        if iteration % self.every == 0:
            self.ms.append((time.perf_counter() - t0) * 1e3)


class uc_witness:
    """At each firing of the legacy listeners (after them in the list):
    the param table, and the grids of a separate eager ``feed_forward`` of
    the probe."""

    def __init__(self, probe, every: int):
        self.probe, self.every = probe, every
        self.tables, self.grids = {}, {}

    def iteration_done(self, model, iteration: int) -> None:
        from deeplearning4j_tpu_torch.ui.legacy import (activation_grid,
                                                        host_map)
        if iteration % self.every:
            return
        self.tables[iteration] = model.param_table()
        self.grids[iteration] = {
            i: activation_grid(host_map(a[0]))
            for i, a in enumerate(model.feed_forward(self.probe))
            if a.ndim == 4}


def uc_png(path: str) -> np.ndarray:
    """Decode the legacy listener's 8-bit grayscale PNG (filter 0 rows)."""
    import zlib
    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w = int.from_bytes(body[:4], "big")
            h = int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    return raw[:, 1:]


def uc_cloud_fit(tmp: str, x: np.ndarray, y: np.ndarray) -> tuple:
    """(a) and (b): the epoch as .npz batches in a file:// bucket, one
    epoch of LeNet-5 from ``RemoteDataSetIterator`` under the legacy
    listeners, against a plain fit over the same batches."""
    from deeplearning4j_tpu_torch.cloud import (LocalFilesystemStorage,
                                                RemoteDataSetIterator)
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.data import DataSetExportFunction
    from deeplearning4j_tpu_torch.ui.legacy import (
        ConvolutionalIterationListener, HistogramIterationListener)

    class TimedStorage(LocalFilesystemStorage):
        download_ms = 0.0
        downloads = 0

        def download(self, uri, local_path):
            t0 = time.perf_counter()
            out = super().download(uri, local_path)
            self.download_ms += (time.perf_counter() - t0) * 1e3
            self.downloads += 1
            return out

    out = {}
    n = (x.shape[0] // UC_BATCH) * UC_BATCH
    steps = n // UC_BATCH
    export = DataSetExportFunction(os.path.join(tmp, "export"))
    storage = TimedStorage()
    bucket = "file://" + os.path.join(tmp, "bucket")
    t0 = time.perf_counter()
    for i in range(steps):
        rows = slice(i * UC_BATCH, (i + 1) * UC_BATCH)
        path = export(DataSet(x[rows], y[rows]))
        storage.upload(path, f"{bucket}/lenet/batch_{i:04d}.npz")
        if i < UC_PROFILED_BATCHES:
            storage.upload(path, f"{bucket}/profiled/batch_{i:04d}.npz")
    out["export_upload_s"] = time.perf_counter() - t0
    probe = x[:UC_PROBE]
    hist = HistogramIterationListener(frequency=UC_HIST_EVERY)
    conv = ConvolutionalIterationListener(
        probe, frequency=UC_CONV_EVERY, output_dir=os.path.join(tmp, "png"))
    timed = [uc_timed(hist, UC_HIST_EVERY), uc_timed(conv, UC_CONV_EVERY)]
    witness = uc_witness(probe, UC_HIST_EVERY)
    with cudnn_deterministic():
        remote = MultiLayerNetwork(lenet(), device=UC_DEV).init()
        plain = MultiLayerNetwork(lenet(), device=UC_DEV).init()
        plain.set_flat_params(remote.get_flat_params())
        remote.set_listeners(*timed, witness)
        it = RemoteDataSetIterator(f"{bucket}/lenet", storage=storage,
                                   cache_dir=os.path.join(tmp, "cache"))
        uc_sync()
        t0 = time.perf_counter()
        remote.fit(it, ingest="batch")
        uc_sync()
        secs = time.perf_counter() - t0
        remote.set_listeners()
        t1 = time.perf_counter()
        plain.fit(ListDataSetIterator(DataSet(x[:n], y[:n]), UC_BATCH),
                  ingest="batch")
        uc_sync()
        plain_s = time.perf_counter() - t1
    a, b = remote.get_flat_params(), plain.get_flat_params()
    if remote.iteration != steps or not np.array_equal(a, b):
        raise RuntimeError(
            f"(a) the bucket's epoch differs from the plain fit: "
            f"{remote.iteration} steps, max |diff| "
            f"{float(np.max(np.abs(a - b)))}")
    out.update({"rows": n, "steps": steps, "seconds": secs,
                "samples_per_s": n / secs, "plain_seconds": plain_s,
                "plain_samples_per_s": n / plain_s,
                "download_ms": storage.download_ms,
                "downloads": storage.downloads,
                "download_ms_per_batch": storage.download_ms /
                max(1, storage.downloads), "params_bitwise": True})
    if UC_DEV == "cuda":
        small = RemoteDataSetIterator(
            f"{bucket}/profiled", storage=LocalFilesystemStorage(),
            cache_dir=os.path.join(tmp, "cache_profiled"))
        list(small)                     # downloaded before the profile
        wall, events, _, busy = profiled(
            lambda: plain.fit(small, ingest="batch"))
        out["profiled"] = {"batches": UC_PROFILED_BATCHES, "wall_ms": wall,
                           "device_events": events,
                           "idle_share": 1.0 - busy / wall}
    log(f"[ui_cloud] (a) {steps} batches of {UC_BATCH} ({n} rows) exported "
        f"and uploaded to {bucket} in {out['export_upload_s']:.2f} s; "
        f"LeNet-5 one epoch from RemoteDataSetIterator "
        f"{out['samples_per_s']:.1f} samples/s ({secs:.3f} s, listeners "
        f"on; the cache's downloads {storage.download_ms:.1f} ms for "
        f"{storage.downloads} objects), a plain fit over a "
        f"ListDataSetIterator {out['plain_samples_per_s']:.1f} samples/s; "
        f"params bitwise"
        + (f"; {UC_PROFILED_BATCHES} profiled batches idle share "
           f"{out['profiled']['idle_share']:.3f}" if "profiled" in out
           else ""))
    # (b): the listeners' outputs against the host's own numbers
    last = max(witness.tables)
    if sorted(witness.tables) != [it_ for it_ in range(
            UC_HIST_EVERY, steps + 1, UC_HIST_EVERY)]:
        raise RuntimeError(f"(b) fired at {sorted(witness.tables)}")
    for name, (it_, edges, counts) in hist.histograms.items():
        want_counts, want_edges = np.histogram(witness.tables[last][name],
                                               bins=hist.bins)
        if it_ != last or not (np.array_equal(counts, want_counts)
                               and np.array_equal(edges, want_edges)):
            raise RuntimeError(f"(b) the histogram of {name} differs")
    pngs = 0
    for path in conv.written:
        stem = os.path.basename(path)[len("conv_layer"):-len(".png")]
        layer, iteration = stem.split("_iter")
        want = witness.grids[int(iteration)][int(layer)]
        if not np.array_equal(uc_png(path), want):
            raise RuntimeError(f"(b) {path} differs from the eager grid")
        pngs += 1
    if pngs != len(witness.grids) * len(witness.grids[last]):
        raise RuntimeError(f"(b) {pngs} PNGs written")
    step_ms = secs * 1e3 / steps
    listeners = {"histogram_ms": timed[0].ms, "conv_ms": timed[1].ms,
                 "histogram_ms_median": float(np.median(timed[0].ms)),
                 "conv_ms_median": float(np.median(timed[1].ms)),
                 "firings": len(timed[0].ms), "pngs": pngs,
                 "step_ms": step_ms,
                 "histograms": len(hist.histograms),
                 "update_histograms": len(hist.update_histograms)}
    log(f"[ui_cloud] (b) {listeners['firings']} firings: the histogram "
        f"listener {listeners['histogram_ms_median']:.2f} ms, the "
        f"convolutional listener {listeners['conv_ms_median']:.2f} ms a "
        f"firing (median, host) beside {step_ms:.2f} ms a step; "
        f"{len(hist.histograms)} histograms equal np.histogram of "
        f"param_table() at iteration {last}, {pngs} PNGs equal the grids "
        f"of an eager feed_forward")
    return remote, hist, out, listeners


def uc_ui(net, hist, tmp: str) -> dict:
    """(c): ui.main's server over a sqlite file, the monitor's record of
    the trained net read back over HTTP, the listeners' page."""
    import urllib.request

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.ui import components, main
    server = main.serve(["--port", "0", "--storage-file",
                         os.path.join(tmp, "stats.db")], block=False)
    try:
        monitor.post_system_metrics(server.storage, net, "smoke")
        base = f"http://127.0.0.1:{server.port}"
        t0 = time.perf_counter()
        ov = json.loads(urllib.request.urlopen(
            base + "/train/overview/data?sid=smoke", timeout=30).read())
        get_ms = (time.perf_counter() - t0) * 1e3
        sessions = json.loads(urllib.request.urlopen(
            base + "/train/sessions", timeout=30).read())
    finally:
        server.stop()
    if [p[0] for p in ov["score_vs_iter"]] != [net.iteration]:
        raise RuntimeError(f"(c) the overview reads {ov['score_vs_iter']}")
    page = components.render_page(hist.components(), "Histogram listener")
    path = os.path.join(tmp, "histograms.html")
    with open(path, "w", encoding="utf-8") as f:
        f.write(page)
    charts = page.count("<svg")
    if charts != len(hist.components()):
        raise RuntimeError(f"(c) {charts} charts on the page")
    out = {"sessions": sessions, "overview_ms": get_ms,
           "page_bytes": len(page.encode()), "charts": charts,
           "score": ov["score_vs_iter"][0][1]}
    log(f"[ui_cloud] (c) ui.main on port {server.port}: the monitor's "
        f"record of iteration {net.iteration} read back over HTTP in "
        f"{get_ms:.1f} ms; the listeners' page {out['page_bytes']} bytes, "
        f"{charts} charts; server stopped")
    return out


def uc_armed(N, A, x: np.ndarray, y: np.ndarray) -> dict:
    """(d): the lock graph and the sanitizer armed before the objects are
    built: an epoch-cache fit of LeNet-5 (each epoch one group and its
    tail) and, behind an engine with one predict bucket, a decode session
    of phase 8's attention net across the 1024 -> 2048 hop between two
    predicts."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.analyze import lockgraph, sanitizer
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.models.lenet import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import InferenceEngine
    saved = {k: os.environ.get(k) for k in (lockgraph.ENV_FLAG,
                                            sanitizer.ENV_FLAG)}
    os.environ[lockgraph.ENV_FLAG] = "1"
    os.environ[sanitizer.ENV_FLAG] = "1"
    lockgraph.reset()
    sanitizer.reset()
    out = {}
    try:
        net = MultiLayerNetwork(lenet(), device=UC_DEV).init()
        src = ListDataSetIterator(DataSet(x, y), UC_BATCH)
        t0 = time.perf_counter()
        net.fit(src, ingest="cache")              # warm-up: the captures
        uc_sync()
        warm_s = time.perf_counter() - t0
        monitor.sanitize_end_warmup()
        t1 = time.perf_counter()
        net.fit(src, epochs=2, ingest="cache")
        uc_sync()
        fit_s = time.perf_counter() - t1
        att = build_net(N, A, seed=7, n_in=N_IN, hidden=HIDDEN,
                        heads=HEADS, n_out=N_OUT, cache_len=SEQ,
                        device=UC_DEV)
        tok = np.random.RandomState(8).randn(
            UC_DECODE_TOKENS, 1, N_IN).astype(np.float32)
        req = np.random.RandomState(9).randn(
            1, UC_PREDICT_T, N_IN).astype(np.float32)
        with InferenceEngine(att, max_batch_size=1, max_latency_ms=1,
                             timestep_buckets=(UC_PREDICT_T,),
                             name="armed") as engine:
            engine.warmup((UC_PREDICT_T, N_IN))
            warmed = engine.warmup_decode((N_IN,))
            monitor.sanitize_end_warmup()
            engine.predict(req)
            t2 = time.perf_counter()
            for t in range(UC_DECODE_TOKENS):
                engine.predict_session("armed", tok[t])
            decode_s = time.perf_counter() - t2
            cap = engine.sessions.session_capacity("armed")
            engine.predict(req)
        enforced = sanitizer.state().enforced()
        out.update({
            "cache_fit": {"warm_s": warm_s, "seconds": fit_s,
                          "samples_per_s": 2 * x.shape[0] / fit_s},
            "decode": {"tokens": UC_DECODE_TOKENS, "capacity": cap,
                       "warmed_shapes": warmed,
                       "ms_per_token": decode_s * 1e3 / UC_DECODE_TOKENS},
            "enforced": enforced,
            "violations": sanitizer.violations(),
            "lockgraph": lockgraph.graph().snapshot(),
            "lockgraph_edges": monitor.gauge("lockgraph_edges").value(),
            "lockgraph_cycles": monitor.counter(
                "lockgraph_cycles_total").value()})
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fit = enforced.get("fit.epoch_cache", {})
    dec = enforced.get("serving.decode_step", {})
    log(f"[ui_cloud] (d) armed: fit.epoch_cache {fit}, serving.decode_step "
        f"{dec} (ring {out['decode']['capacity']}, "
        f"{out['decode']['ms_per_token']:.2f} ms a token); violations "
        f"{len(out['violations'])}; lock graph {out['lockgraph']}")
    if out["violations"]:
        raise RuntimeError(f"(d) sanitizer violations {out['violations']}")
    if fit != {"occurrences": 2, "dispatches": 4, "ceilings": 4}:
        raise RuntimeError(f"(d) the epoch-cache fit's dispatches {fit}")
    if (dec.get("occurrences") != UC_DECODE_TOKENS - 1
            or dec["dispatches"] != dec["ceilings"] or cap != 2048):
        raise RuntimeError(f"(d) the decode session's dispatches {dec}, "
                           f"ring {cap}")
    if not out["lockgraph_edges"] > 0 or out["lockgraph_cycles"] \
            or out["lockgraph"]["cycles"]:
        raise RuntimeError(f"(d) lock graph {out['lockgraph']}")
    return out


def uc_bridge(net, tmp: str, x: np.ndarray) -> dict:
    """(e): the Keras bridge on the card with (a)'s net registered."""
    import importlib.util

    from deeplearning4j_tpu_torch.keras.bridge import (KerasBridgeClient,
                                                       KerasBridgeServer)
    from deeplearning4j_tpu_torch.utils.model_serializer import \
        restore_multi_layer_network
    rows = x[:UC_PREDICT_ROWS]
    h5py = importlib.util.find_spec("h5py") is not None
    with KerasBridgeServer(port=0, device=UC_DEV) as server:
        mid = server.register(net)
        client = KerasBridgeClient(server.host, server.port)
        try:
            features = rows.tolist()
            client.call("predict", model_id=mid, features=features[:2])
            t0 = time.perf_counter()
            reply = client.call("predict", model_id=mid, features=features)
            wire_ms = (time.perf_counter() - t0) * 1e3
            path = os.path.join(tmp, "bridge_lenet.zip")
            saved = client.call("save", model_id=mid, path=path)
            import_error = None
            if not h5py:
                try:
                    client.call("import_model",
                                path=os.path.join(tmp, "model.h5"))
                except RuntimeError as e:
                    import_error = str(e)
                if import_error is None or "h5py" not in import_error:
                    raise RuntimeError(f"(e) import_model without h5py "
                                       f"answered {import_error!r}")
        finally:
            client.close()
    got = np.asarray(reply["output"], np.float32)
    uc_sync()
    t1 = time.perf_counter()
    want = net.output(rows)
    uc_sync()
    local_ms = (time.perf_counter() - t1) * 1e3
    want = want.detach().float().cpu().numpy()
    if not np.array_equal(got, want):
        raise RuntimeError(f"(e) predict over TCP differs: max |diff| "
                           f"{float(np.max(np.abs(got - want)))}")
    back = restore_multi_layer_network(saved["path"], device=UC_DEV)
    if back.get_flat_params().tobytes() != net.get_flat_params().tobytes():
        raise RuntimeError("(e) save over the wire changed the params")
    out = {"rows": UC_PREDICT_ROWS, "round_trip_ms": wire_ms,
           "output_ms": local_ms, "predict_bitwise": True,
           "save_bitwise": True, "h5py": h5py,
           "import_model_error": import_error}
    log(f"[ui_cloud] (e) the Keras bridge on {UC_DEV}: predict of "
        f"{UC_PREDICT_ROWS} rows over TCP {wire_ms:.1f} ms (in-process "
        f"output() {local_ms:.2f} ms), bitwise; save over the wire restores "
        f"the params bytewise; h5py importable: {h5py}"
        + ("" if h5py else f"; import_model answers {import_error[:80]!r}"))
    return out


def uc_provision(tmp: str) -> dict:
    """(f): a 1-host cluster from TpuPodProvisioner whose command is the
    port's pod worker, launched through its launch_host0.sh, against the
    pod launcher's 1-rank pod of the same seed."""
    import shlex
    import socket

    from deeplearning4j_tpu_torch.cloud import TpuPodProvisioner
    from deeplearning4j_tpu_torch.parallel import main as pm
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = (f"{shlex.quote(sys.executable)} -m "
           f"deeplearning4j_tpu_torch.parallel.main --pod-worker --steps "
           f"{UC_POD_STEPS} --data 2 --device {UC_DEV}")
    prov = TpuPodProvisioner(1, "127.0.0.1", coordinator_port=port,
                             command=cmd)
    paths = prov.write(os.path.join(tmp, "cluster"))
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(["/bin/sh", paths[1]], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        stdout, stderr = proc.communicate(timeout=UC_POD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    launch_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"(f) launch_host0.sh exited {proc.returncode}: "
                           f"{stderr[-2000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    single = pm.run_pod(k=1, data=2, mode="dp", steps=UC_POD_STEPS,
                        device=UC_DEV, timeout=UC_POD_TIMEOUT_S)
    if single["returncodes"] != [0]:
        raise RuntimeError(f"(f) the 1-rank pod: {single['stderr_tail']}")
    if (report["param_sha"] != single["param_sha"]
            or report["scores"] != single["scores"]):
        raise RuntimeError(f"(f) the provisioned pod differs: "
                           f"{report['scores']} vs {single['scores']}")
    out = {"files": [os.path.basename(p) for p in paths],
           "coordinator": prov.coordinator_address, "returncode": 0,
           "launch_s": launch_s, "param_sha": report["param_sha"],
           "device": report["device"], "backend": report["backend"],
           "steps": UC_POD_STEPS, "pid_reaped": proc.poll() is not None}
    log(f"[ui_cloud] (f) launch_host0.sh ({prov.coordinator_address}) ran "
        f"the pod worker on {report['device']} over {report['backend']} in "
        f"{launch_s:.1f} s, exit 0; params bitwise the launcher's 1-rank "
        f"pod (sha {report['param_sha'][:12]})")
    return out


def phase_ui_cloud(N, A) -> dict:
    """Phase 25: the last modules (the ``ui_cloud`` path of the kernels
    line: it launches none of K1-K4)."""
    import tempfile
    t0 = time.perf_counter()
    uc_sync()
    A.reset_launches()
    marks = []
    x, y = uc_mnist()
    marks.append(("mnist", time.perf_counter()))
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        net, hist, result["cloud"], result["listeners"] = uc_cloud_fit(
            tmp, x[:UC_ROWS], y[:UC_ROWS])
        marks.append(("cloud_listeners", time.perf_counter()))
        result["ui"] = uc_ui(net, hist, tmp)
        marks.append(("ui", time.perf_counter()))
        result["armed"] = uc_armed(N, A, x[:UC_CACHE_ROWS],
                                   y[:UC_CACHE_ROWS])
        marks.append(("armed", time.perf_counter()))
        result["bridge"] = uc_bridge(net, tmp, x)
        marks.append(("bridge", time.perf_counter()))
        result["provision"] = uc_provision(tmp)
        marks.append(("provision", time.perf_counter()))
    result["launches"] = dict(A.LAUNCHES)
    if any(result["launches"].values()):
        raise RuntimeError("the ui_cloud path launched a flash kernel")
    result["seconds_by_part"] = {
        name: b - a for (_, a), (name, b) in zip(
            [("start", t0)] + marks[:-1], marks)}
    log(f"[ui_cloud] seconds by part {result['seconds_by_part']}")
    result["seconds"] = time.perf_counter() - t0
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # bitwise checks (phase 20's pods, workers=1 against fit) need the
    # deterministic cuBLAS workspace from the first CUDA call on; it is
    # the card's default size, so no earlier phase changes
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    from deeplearning4j_tpu_torch import nativeops
    t0 = time.perf_counter()
    # one nvcc a source, all started together: the kernels and the weight
    # arena of phase 24's runner
    builds = [(source, None, ()) for source in kernel_build.SOURCES] + [
        (nativeops.ARENA_SOURCE, nativeops.CSRC, ("cuda",))]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for fut in [pool.submit(kernel_build.build, *b) for b in builds]:
            fut.result()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(builds)} source(s) in {build_s:.1f} s")

    timing = phase_kernels(A, args.seed)
    adam_timing = phase_adam(args.seed)
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    deepwalk = phase_deepwalk(A, N)
    torch.cuda.empty_cache()
    pretrain = phase_pretrain(A, N)
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    _, serving_v2 = phase_serving_v2(N, A, args.seed)
    torch.cuda.empty_cache()
    deploy = phase_deploy(N, A, args.seed)
    torch.cuda.empty_cache()
    log(f"[deploy] phase 18 in {time.perf_counter() - t18:.1f} s; {card}")
    fleet = phase_fleet(A, args.seed)
    torch.cuda.empty_cache()
    log(f"[fleet] phase 19 in {fleet['seconds']:.1f} s; {card}")
    parallel = phase_parallel(N, A, args.seed, ffcnn)
    torch.cuda.empty_cache()
    log(f"[parallel] phase 20 in {parallel['seconds']:.1f} s; {card}")
    scaleout = phase_scaleout(N, A, args.seed, ffcnn)
    torch.cuda.empty_cache()
    log(f"[scaleout] phase 21 in {scaleout['seconds']:.1f} s; {card}")
    clustering = phase_clustering(A)
    EMB_KEPT.clear()
    torch.cuda.empty_cache()
    log(f"[clustering] phase 22 in {clustering['seconds']:.1f} s; {card}")
    streaming = phase_streaming(A)
    torch.cuda.empty_cache()
    log(f"[streaming] phase 23 in {streaming['seconds']:.1f} s; {card}")
    native = phase_native(A)
    torch.cuda.empty_cache()
    log(f"[native] phase 24 in {native['seconds']:.1f} s; {card}")
    ui_cloud = phase_ui_cloud(N, A)
    MNIST_KEPT.clear()
    torch.cuda.empty_cache()
    log(f"[ui_cloud] phase 25 in {ui_cloud['seconds']:.1f} s; {card}")

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
             "embeddings": embeddings["launches"],
             "deepwalk": deepwalk["launches"],
             "pretrain": pretrain["launches"],
             "serving_v2": serving_v2["launches"],
             "deploy": deploy["launches"], "fleet": fleet["launches"],
             "parallel": parallel["launches"],
             "scaleout": scaleout["launches"],
             "clustering": clustering["launches"],
             "streaming": streaming["launches"],
             "native": native["launches"],
             "ui_cloud": ui_cloud["launches"]}
    csrc = "deeplearning4j_tpu_torch/ops/csrc/"
    bodies = {"flash_fwd": csrc + "flash_fwd_sm90.cuh",
              "flash_fwd_partials": csrc + "flash_fwd_sm90.cuh",
              "flash_bwd_dkdv": csrc + "flash_bwd_sm90.cuh",
              "flash_bwd_dq": csrc + "flash_bwd_sm90.cuh"}
    kernels = [dict(name=name, route="cuda", source=bodies[name],
                    replaces=sources[name],
                    launches=sum(counts[name] for counts in paths.values()),
                    launches_by_path={path: counts[name]
                                      for path, counts in paths.items()},
                    **timing[name])
               for name in sources]
    adam_paths = {"kernels": adam_timing["check_launches"],
                  "reference": reference["adam_launches"],
                  "training": training["adam_launches"]}
    kernels.append(dict(
        name="adam_master_step", route="cuda", source=csrc + "adam_update.cu",
        replaces="deeplearning4j_tpu_torch/nn/updaters.py compute_update "
                 "(adam) and apply_layer_updates' master write, torch ops",
        launches=sum(adam_paths.values()), launches_by_path=adam_paths,
        **adam_timing))
    print(json.dumps({"build_s": build_s, "reference": reference,
                      "training": training, "inference": inference,
                      "ring": ring, "serving": serving,
                      "feedforward_cnn": ffcnn, "recurrent": recurrent,
                      "harness": harness, "graph": graph, "fused": fused,
                      "transfer": transfer, "embeddings": embeddings,
                      "deepwalk": deepwalk}))
    print(json.dumps({"pretrain": pretrain}))
    print(json.dumps({"serving_v2": serving_v2, "deploy": deploy},
                     default=str))
    print(json.dumps({"fleet": fleet}, default=str))
    print(json.dumps({"parallel": parallel}, default=str))
    print(json.dumps({"scaleout": scaleout}, default=str))
    print(json.dumps({"clustering": clustering, "streaming": streaming},
                     default=str))
    print(json.dumps({"native": native}, default=str))
    print(json.dumps({"ui_cloud": ui_cloud}, default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
