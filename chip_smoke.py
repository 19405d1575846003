#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``

Phases (a failing phase makes the script exit non-zero and print no
result line; each prints its seconds):
 1. device — the card's name and, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, its power limit;
 2. build — compile ``kernels/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` for
    sm_90a from this checkout, one nvcc each, in parallel; ptxas registers
    and spills per kernel (the phase fails if any kernel spills);
 3. forward kernel — flash_fwd against its plain PyTorch version on the
    card: out and lse on valid rows, f32 and bf16, causal and not, with and
    without segment ids (a padded row), at the serving prefill shape
    (1, 32, 1024, 128), a single-tile (2, 32, 512, 128), a streaming
    (1, 32, 2048, 128), a cross-length Lq=256 / Lk=512 shape, the training
    lanes' BERT (32, 12, 512, 64) and llama (4, 16, 2048, 128) shapes and a
    head_dim sweep; two f32 launches at the prefill shape must agree bit
    for bit; times (causal at the serving shapes, each lane's own masking
    at the lane shapes) of the kernel, the plain version and, as a
    yardstick only, ``torch.nn.functional.scaled_dot_product_attention``
    (for f32, with the names of the kernels SDPA ran);
 4. backward kernels — flash_bwd_fused, flash_bwd_dq and flash_bwd_dkv
    against ``flash_attention_backward_reference`` on the card: dq, dk, dv
    on valid rows, f32 and bf16, causal and not, with and without segment
    ids, at the BERT lane (32, 12, 512, 64) -> fused, the llama lane
    (4, 16, 2048, 128) -> dq + dkv, cross 256/512 -> fused, L=384 -> dq +
    dkv and a head_dim sweep on both routes; two f32 dq and two f32 dkv
    launches at the llama lane shape, and the dk, dv of two f32 fused
    launches at the BERT lane shape, must agree bit for bit; autograd through
    ``flash_attention`` at both lane shapes; times of each kernel in f32
    and bf16 at the same shapes, the plain backward and, as a yardstick
    only, SDPA's backward in the same dtype (dq, dk, dv by
    ``torch.autograd.grad`` of one recorded SDPA forward), read twice: CUDA
    events around the call, and the sum of its device kernels in one
    ``torch.profiler`` window (the number the ``library_ms`` column takes),
    with the names of those kernels;
 5. serving oracle — the Gluon llama_small (``llama_model`` +
    ``initialize`` on the card) served on the card (prefill 256: the flash
    kernel) must be token-identical to greedy full re-encode, and its
    ``save_parameters`` / ``load_parameters`` round trip bit for bit;
 6. serve — the Gluon llama3_8b at full width (32 layers, vocab 128256,
    f32, random weights drawn on the card by ``initialize``, no gradient
    buffers; the peak memory may grow by the weights alone) behind
    ``ServingEngine(
    max_batch=8, block_tokens=16, max_seq=2048, prefill_tokens=1024)``
    answers 8 requests of 100-1000 prompt tokens, 16 new tokens each; the
    forward kernel's counter must grow by >= layers per prefill; the
    decode steps after the first run under ``analysis.no_retrace()``
    (they build nothing); one prefill is repeated with attention bound to
    the plain version and the logits compared;
 7. tier — the rest of serving at full width: (a) the serve phase's
    llama3_8b behind ``ServingEngine(max_batch=8, block_tokens=16,
    max_seq=2048, prefill_tokens=1024)`` answers 8 requests sharing a
    768-token system prompt (48 blocks) with distinct 32-224-token tails,
    16 new tokens each, with ``prefix_cache`` off and on: tokens equal,
    >= 7 hits, fewer prefill positions with the cache, >= 32 flash
    launches a cold prefill; wall ms of a cold prefill and of a hit
    admission; (b) ``spec_k=3`` with the target as its own draft (weights
    shared, a second pool: k+1 tokens every verify dispatch) and with a
    llama_small draft at vocab 128256: tokens equal plain decoding;
    decode ms an emitted token beside plain decoding, the accepted-draft
    histogram; (c) transformer_base (vocab 32768) serves 8 sources of
    100-256 tokens padded to ``prefill_tokens=256``: tokens equal the
    port's ``greedy_decode`` of the same model on the card, >= 6 flash
    launches a prefill (one per encoder layer); (d) the SLO histograms'
    p50/p99 of TTFT and TPOT over (a)-(c); (e) ``serving.Router`` over two
    llama_small replicas (vocab 32000, one seed) started as
    ``python -m mxnet_tpu_torch.serving.replica`` on this card, both
    engines built (their heartbeats), bursts of 32 requests until replica
    0 is SIGKILLed while it decodes (at most 3): every answer equals
    an in-process engine's, the death, the retry and the respawn are
    counted, and no process is left after ``Router.stop()``; the whole
    phase runs with the lock-order checker armed (``MXNET_LOCKCHECK=1`` in
    this process and in both replicas): no ``LockOrderError``, the edges
    recorded here printed;
 8. train oracle — bert_3_128_2 at seq 512 (fused backward) and llama_small
    at seq 1024 (dq + dkv) train 6 steps on the card (``TrainStep`` captured
    as a CUDA graph: one eager warm-up, then 5 replays) and on the CPU
    (plain versions) from the same f32 weights and batches, Adam's rate
    falling every step: per-step losses agree; then dropout 0.1 draws new
    masks on every replay, a replay after ``load_parameters`` reads the
    loaded weights, and a forward that reads to the host raises
    ``MXNetError`` at capture (the card and its memory fine after it);
 9. train lanes — bench.py's bert_seq512 (BERT-base, batch 32, seq 512)
    and llama_seq2048 (8 layers, 2048 units, batch 4, seq 2048) lanes at
    full width, in bf16 with multi-precision Adam, then again in f32 with
    plain Adam (``bert_seq512_f32``, ``llama_seq2048_f32``, bench.py's
    lanes under MXNET_BENCH_DTYPE=float32), 8 captured ``TrainStep``
    steps on one batch (the 6 replays after the eager call and the
    capture under ``analysis.no_retrace()``), each lane's perf-gate record
    of GATE_REPLAYS more replays with the cost ledger armed (one armed
    dispatch a replay, no build, the lane's flash launches a replay), and
    padded BERT steps whose lengths ride in the
    batch: losses finite and falling, kernel launches per step (a replay
    counts its capture's; every launch in the lane's dtype; none on the
    CUDA-core route for wide bf16 heads), median step ms, samples/s, MFU
    against the dtype's peak, peak memory, idle share and one profiled
    step's device time by kernel family, beside the same model's eager
    Gluon loop; the bf16 BERT lane again at ``n_micro=4`` (losses agree,
    peak memory of each) and the f32 llama lane again with remat per
    decoder block (losses agree, less peak memory, step ms of both);
10. gluon — MXNet's canonical Gluon loop (``autograd.record()``,
    ``SoftmaxCELoss``, ``backward()``, ``gluon.Trainer("adam").step(B)``)
    over the Gluon BERT: (a) bert_3_128_2 built on the CPU and carried to
    the card by its ``collect_params()`` names trains 3 steps on a padded
    seq-512 batch on both devices, per-step losses agreeing; (b)
    bert_12_768_12 (vocab 30522, batch 32, seq 512) in f32, hybridized,
    8 steps, then the same weights and batch through ``TrainStep``
    (per-step losses agree) and 3 steps not hybridized (the NDArray path;
    losses agree); (c) the same model cast to bf16 with multi-precision
    Adam, 8 steps, then ``TrainStep`` the same; every Gluon step launches
    12 forward and 12 fused-backward kernels of its dtype's route; median
    step ms, samples/s, MFU, peak memory and profiled idle share of the
    Gluon loop beside the captured ``TrainStep``'s;
11. mt — ``transformer_base`` (6 + 6 layers, 512, FFN 2048, 8 heads,
    vocabulary 32,768) at batch 16, source and target 256 tokens
    (lengths in [128, 256], Zipf-drawn tokens), label smoothing 0.1,
    Adam (0.9, 0.98, 1e-9) with a linear warm-up, dropout 0.1: 20 steps
    of the Gluon loop in f32 and in bf16 under ``amp.init``, 20 of the
    captured ``TrainStep`` (a block that unpacks source, target and
    lengths from one tensor) in f32 and under amp, each from the same
    weights: losses falling, 18 flash forward and 18 fused backward
    launches a step in the run's dtype; at dropout 0, 3 Gluon steps
    equal 3 captured steps; ``greedy_decode`` of 4 sentences at max_len
    64 equals the full forward's argmax; step ms, target tokens/s, MFU,
    peak memory, idle share and device ms by family;
12. vision — the convolution, pooling, BatchNorm and pad ops card vs CPU,
    a small bottleneck ResNet (7x7 stem, max-pool) card vs CPU on the
    same weights carried by name (predict outputs, one SGD step, the
    running statistics), then bench.py's ResNet-50 lane: resnet50_v1
    (classes 1000, Xavier, hybridized) at batch 64, 224x224, 8 SGD
    momentum steps on one batch through the Gluon loop and through
    ``TrainStep``, in f32 and after ``net.cast("bfloat16")`` (BatchNorm
    kept f32, multi-precision SGD); 2 imperative steps; the two paths
    agreeing under deterministic cuDNN; ``save_parameters`` /
    ``load_parameters`` into a fresh net bit-identical in npz and dmlc
    (and bf16 in npz); no flash launch, no TF32 kernel in f32; step ms,
    images/s, FLOPs per step (counted from the layers), MFU, peak memory,
    idle share and device time by kernel family; then one card step per
    zoo family beyond the ResNets (alexnet, vgg16_bn, densenet121,
    squeezenet1.1, inceptionv3 at 299, mobilenet1.0, mobilenetv2_1.0):
    logits card vs CPU at batch 2 and the CPU parity tests' input size on
    weights carried by name, then 3 SGD steps at batch 32 in f32 (losses
    finite), step ms and images/s;
13. loop — MXNet's training loop around the model: (a) every optimizer
    of ``mx.optimizer`` with a schedule, 3 steps of the small bottleneck
    ResNet on the card and on the CPU, f32 and bf16 (multi_precision: the
    f32 masters held as f32, each bf16 weight its master rounded);
    ``update_on_kvstore`` against the trainer's update and an explicit
    store, bit for bit; ``save_states``/``load_states`` mid-run bit for
    bit; a 4-worker DataLoader bit-identical to one process; (b)
    resnet50_v1 one epoch (10 steps of 64 from 640 host images of ten
    classes) through ``gluon.data.DataLoader(num_workers=4)`` with
    RandomFlipLeftRight, ToTensor and Normalize, NAG with a MultiFactor
    schedule, ``Trainer(kvstore="local")``, accuracy, top-5 and loss
    metrics every batch, f32 and bf16, beside the vision phase's loop (SGD,
    one pre-staged batch); the local store's reduction of ResNet-50's
    gradients timed at 1, 2 and 4 replicas on the card; NAG at 0.025 in
    f32 and bf16 through the Trainer and in bf16 through TrainStep, each
    Trainer step held against a plain NAG, the loss curves printed; (d)
    ``Estimator.fit`` of resnet18_v1 over 4 batches with a
    CheckpointHandler, reloaded bit for bit; (c) BERT-base's widths cut to
    6 layers, bf16 10 steps from a 2-worker DataLoader, LAMB with
    polynomial warmup-decay, Loss and Accuracy of the argmax, beside the
    gluon phase's Adam loop; losses falling, the schedules' rates, no
    loader fallback, no worker left, 6 bf16 forward and 6 bf16 fused
    backward launches a BERT step;
    step ms, images or samples/s, MFU, peak memory, idle share, ms in
    next() and in the metrics' update;
14. nd — the rest of ``mx.nd``: (a) every op the port registers, the
    samplers apart (``mxnet_tpu_torch/ops/sweep.py``: 268 ops under 309
    names), on the card and on the CPU from the same numpy inputs,
    outputs, dtypes and the gradients of the differentiable ops; (b) every
    sampler on the card: one seed twice gives the same draws, two seeds
    different ones; at 10^6 draws per parameter set the mean and variance
    within 5 standard errors and a goodness-of-fit p-value (KS, or
    chi-square for a discrete distribution) above 1e-3; (c)
    ``contrib.masked_encdec_att`` (B 32, Lq 256, Lk 512, valid lengths in
    [256, 512]) and ``contrib.multihead_attention`` (self length 512,
    causal and not) at the zoo transformer's base widths (512 units, 8
    heads) in f32 and bf16, forward and gradients, against the same op
    with the flash call bound to its plain version on the card and against
    the CPU; their device ms and the flash kernels' share;
15. rnn — ``gluon.rnn`` over the ``RNN`` op: (a) the op in its four
    modes, uni- and bidirectional, 2 layers, T 35, N 32, I 256, H 512,
    f32, on the card against the CPU (outputs, final states, the
    gradients of data, flat parameters and states), each through cuDNN
    (``aten::_cudnn_rnn`` in its profile; its kernels printed); (b)
    ``ctc_loss`` and ``gluon.loss.CTCLoss`` card vs CPU, loss and
    gradient; (c) a small tied LSTM LM (vocab 1000, 2 x 128, bptt 35,
    batch 4, dropout 0) 3 SGD steps on both devices from the same weights
    carried by name; (d) the word-level LM of MXNet's Gluon example at its
    medium configuration (vocab 33278, WikiText-2's, on a synthetic
    corpus; emsize = nhid = 650, 2 layers, dropout 0.5, tied; bptt 35,
    batch 32, f32) trained 20 BPTT segments by the canonical loop (state
    carried and detached, ``clip_global_norm``, ``Trainer("sgd", lr
    20).step``): losses finite and falling, median step ms, tokens/s,
    MFU, peak memory, idle share, device time by family and the LSTM
    layer's own device ms.  No flash kernel launches;
16. det — (a) YOLOv3-DarkNet53 (``yolo3_darknet53(classes=80)``) at 416,
    batch 8 (GluonCV train_yolo3.py's --data-shape 416, one GPU's share of
    its batch 64 over 8), SGD lr 0.001, momentum 0.9, wd 5e-4,
    ``step(batch)``, targets from the host ``YOLOV3TargetGenerator`` for
    1-20 random boxes an image padded to 50, 10 steps on one batch in f32
    and in bf16 (BatchNorm f32, multi-precision SGD): losses finite and
    falling, step ms, images/s, MFU (FLOPs counted from the layers, 3x the
    forward), peak memory, idle share, device ms by family; the f32 net's
    outputs and loss on one image card vs CPU on the same weights, and
    ``yolo3_decode`` (topk 100, conf 0.1, nms 0.45) of the batch card vs
    CPU; (b) SSD300's multibox path (MXNet example/ssd, vgg16_reduced at
    300: 8,732 anchors from MultiBoxPrior, MultiBoxTarget with hard
    negatives 3:1, MultiBoxDetection nms 0.45, nms_topk 400) at batch 32
    and 21 classes card vs CPU, each op timed; (c) Proposal (Faster
    R-CNN's RPN, 6000 -> 300 at 0.7 on (1, 18, 38, 50)), ROIPooling 7x7
    and roi_align 14x14 on 300 rois of (1, 1024, 38, 50), R-FCN's
    PSROIPooling (21 classes, 7x7), DeformableConvolution 3x3 512 -> 512
    on (1, 512, 38, 50), FlowNetC's Correlation (kernel 1, displacement
    20, stride2 2, pad 20, on (8, 256, 48, 64)) and SpatialTransformer on
    (32, 3, 224, 224): forward and gradients card vs CPU (ROIPooling and
    roi_align on the first ``DET_CPU_ROIS`` rois, Correlation on the
    first image: both devices run the slice), device and wall ms of the
    full shape.  No flash kernel launches;
17. moe — ``gluon.contrib.SparseMoE`` at google/switch-base-8's widths
    (768, 3072, 8 experts, capacity factor 1.25; GELU, see ``MOE``) on 16 x
    512 tokens with a router skewed by the inputs' mean (tokens dropped at
    capacity), k = 1 and k = 2, f32: forward and backward card vs CPU on
    the same weights, aux losses and dropped tokens equal; device ms and
    peak memory.  No flash kernel launches;
18. image — the port's data input: (a) an ImageNet-shaped ``.rec`` (MXNet's
    example/image-classification recipe: im2rec at shorter side 480, JPEG
    quality 95) of 1280 synthetic images of 100 classes, aspects 4:3,
    3:4, 3:2 and 1:1, written by ``recordio.pack_img`` through the port's
    JPEG encoder in parallel threads: size, KiB a record, seconds; (b)
    ``ImageRecordIter`` (224, batch 64, shuffle, random crop and mirror,
    the recipe's mean and std, ``ctx=cpu``) images/s at 1, 2, 4 and
    ``os.cpu_count()`` threads and at ``resize=256``, N threads
    bit-identical to 1, a decoded crop against ``imdecode`` + crop +
    normalize (1 raw unit / std), ``os.cpu_count()`` and ``/dev/shm``;
    (c) ``resnet50_v1`` (100 classes, Xavier) trained 20 steps from the
    ``.rec`` (``preprocess_threads=cpu_count``, ``ctx`` the card), SGD
    momentum 0.9, wd 1e-4 at lr 0.005 after a 3-step warmup (see
    IMAGE_SGD), in f32 and in bf16: losses falling,
    median step ms, images/s, MFU, ms in ``next()``, idle share and the
    same step on one pre-staged batch; (d) ``ImageRecordDataset`` with
    GluonCV's ImageNet train transforms through ``DataLoader(num_workers=
    cpu_count)`` (images/s), and ``DecodedImageRecordDataset`` through the
    decode-pool path, bit-identical to ``num_workers=0`` and to
    ``ImageRecordIter``; (e) LeNet (MXNet's symbols/lenet.py in
    ``gluon.nn``) one epoch on a synthetic learnable MNIST in idx-ubyte
    (60000 + 10000) through ``vision.MNIST`` and a 4-worker DataLoader,
    SGD lr 0.05 (train_mnist.py's), momentum 0.9: ms a step, samples/s,
    test accuracy > 0.9;
    (f) ``imresize`` of a 375x500 image, all five codes, at (224, 224) and
    (341, 256) on the card against the CPU (within 1), device ms.  No
    flash kernel launches;
19. util — the training utilities as a user's script drives them, on
    BERT-base at bench.py's bert_seq512 width cut to 6 layers (vocab
    30522, batch 32, seq 512, bf16, multi-precision Adam at 1e-4, dropout
    0; attention on the
    flash forward and the fused backward), see ``util_phase``: (a) 3
    steps with ``MXNET_OPTIMIZER_FUSED=1`` and 3 with 0 from the same
    weights on the same gradients: weights bitwise equal, median step ms
    of both, ``optimizer_fusion.exec_builds()`` after steps 1 and 3; (b)
    ``Trainer(kvstore=mx.kv.create("local"), compression_params={"type":
    "2bit", "threshold": 0.5})``: one step's packed codes and residuals
    on the card equal to the same gradients compressed on the CPU, step
    ms against the uncompressed store, and one step of each under
    torch.profiler (wall, device busy, kernels); (c) 4 uninterrupted
    steps, then ``checkpoint.auto_resume(save_every=2)`` whose step
    raises once at step 2, then a run that sends itself SIGTERM during
    step 1 and a fresh net and trainer resumed from its directory: every
    curve equal to the uninterrupted one bit for bit (each step replays
    the uninterrupted run's gradient after its own backward: the fused
    backward's dq sums by atomics), save and restore ms and one step's
    bytes on disk, the directories deleted; (d) ``Monitor(1,
    ".*FullyConnected.*")`` over two eager steps (finite stats), nothing after ``uninstall``, in a captured
    CUDA graph or in a captured ``TrainStep``; (e) ``Speedometer`` fed
    ``BatchEndParam`` within 5 % of the phase's own samples/s; (f)
    ``engine.waitall()``, NaiveEngine raising an asynchronous CUDA error
    at the op that caused it and the default engine at the next read (a
    child process each), ``runtime.Features()``; (g)
    ``test_utils.check_consistency`` over ``[gpu(0), cpu(0)]`` on
    FullyConnected, LayerNorm and dot with a bf16 first input; (h) a
    ``CustomOp`` with a backward on the card against the CPU's gradient,
    which ``check_numeric_gradient`` holds;
20. sym — the symbolic API on a post-LN encoder built from ``mx.sym``
    ops at BERT-base's widths (vocab 30522, 768 units, 12 heads, FFN 3072
    with GELU, token and position ``Embedding``, the interleaved qkv into
    ``contrib.masked_selfatt`` with a ``valid_length`` input, a head over
    every position into ``SoftmaxOutput``; see ``SYM``): (a) at 2 layers,
    batch 2, sequence 512 (lengths 384-512), one ``Executor`` forward and
    backward on the card and on the CPU from the same parameters: loss,
    outputs and every gradient; ``Module(context=[gpu(0), gpu(0)])``
    against one context over 2 SGD steps; a ``BucketingModule`` over
    buckets 512 and 256 on the card and on the CPU; (b) 12 layers, batch
    32, f32: ``Module.fit`` with Adam over an ``NDArrayIter`` of synthetic
    tokens (a copy task), 8 steps: losses finite and falling, 12 f32
    forward and 12 f32 fused backward launches a step, median step ms,
    samples/s, MFU (FLOPs counted from the layers, 3x the forward), peak
    memory, idle share; (c) ``save_checkpoint``, ``load_checkpoint`` and
    ``SymbolBlock.imports`` of the head at batch 8 against
    ``Module.predict`` of ``Module.load``, a rebind at batch 4; (d)
    ``amp.init`` + ``amp.convert_model`` of the checkpoint served by
    ``SymbolBlock``: logits against the f32 ones, 12 bf16 forward
    launches.
21. ops — operations on the port's own telemetry: (a) bench.py's
    bert_seq512 (BERT-base, batch 32, seq 512, bf16, captured
    ``TrainStep``) with ``telemetry.enable()``, ``costmodel.arm()`` and
    ``httpd.start(0)``: one warm-up (analysed into the cost ledger), the
    capture, 20 replays; the ``parallel.TrainStep`` entry's FLOPs within
    1 % of the layers' hand count (GEMMs 3x the forward, the pooler's
    forward, attention 12·layers·B·L²·units); its bytes, peak bytes,
    capture seconds and calls; ``lane_summary``'s analytic MFU beside
    bench.py's formula MFU and the roofline verdict; the step clock's 20
    steps, each a sum of its phases, its summary and verdict; 12 forward
    and 12 fused backward flash launches a replay; scrapes of
    ``/metrics`` (equal to ``to_prometheus()``), ``/statusz`` (its
    verdict the clock's), ``/ledger.json`` (lists the site) and
    ``/healthz`` (200) between replays; the median step ms with telemetry
    and the ledger on and off, in turns (on within 5 % of off); (b)
    ``mx.profiler`` around one replay and then 3 more, each in a
    ``profiler.scope``: the host trace holds the 3 scopes, the device
    trace (``torch.profiler``) 12 launches a step of each flash kernel
    after the first scope opens; (c) a child process trains
    bert_3_128_2 on the card through the Gluon loop with a chaos ``exit``
    armed at ``trainer.step`` after 2 steps: it leaves a flight-recorder
    dump with spans, the registry, a step-clock summary of >= 1 step and
    the armed site; SIGUSR2 to this process dumps and it runs on;
    ``checkpoint.auto_resume`` saves and then restores the BERT-base
    weights: one observation in each checkpoint histogram and one resume;
    (d) ``serving.Router`` over two llama_small replicas (as in the tier
    phase) with ``MXNET_TELEMETRY_DIR`` set answers 8 requests of 256
    prompt tokens: after ``stop()`` three shards (replicas 0 and 1, the
    router 2), the merged trace has pids {0, 1, 2}, each merged counter
    is the sum over the shards, and no process is left.
22. quant — INT8 post-training quantization (``contrib.quantization``,
    the int8 products on cuBLASLt through ``torch._int_mm``): (a) the zoo
    BERT at BERT-base (12 layers, 768 units, 12 heads, vocab 30522, f32,
    Normal(0.02) weights from --seed), ``quantize_net(calib_mode=
    "entropy")`` on 2 batches of 8 x 512, then batch 32 x 512 with
    lengths 384-512: all 50 Dense layers int8, attention float on the f32
    flash forward (12 launches a forward); float and int8 median ms over
    20 forwards each in turns, calibration seconds, peak memory, the
    int8 sequence output against the float one; one int8 forward under
    torch.profiler runs 50 ``aten::_int_mm``, no float matmul and none of
    the float forward's GEMM kernels; layer 0's qkv product at (16384,
    768) x (2304, 768) card against CPU bit for bit in int32; the flash
    forward at (32, 12, 512, 64) against its plain version on layer 0's
    q, k, v; (b) resnet50_v1, batch 32 at 224, BatchNorm statistics from
    the data, ``calib_mode="naive"`` on 32 other images: 53 Conv2D and the
    Dense int8 (54 ``aten::_int_mm``), the stem's and a 3x3 layer's int8
    convolutions card against CPU bit for bit in int32, top-1 agreement,
    float and int8 ms; (c) the sym phase's 12-layer encoder up to its
    head through ``optimize_for("INT8")`` (49 nodes), forward at 8 x 512
    against float, 12 f32 flash launches;
23. sparse — sparse storage: (a) a LibSVM file of 65,536 rows over
    1,000,000 features, 39 non-zeros a row (the LIBSVM collection's
    Criteo set: 13 integer and 26 categorical fields) read by
    ``LibSVMIter(batch_size=1024)``; a factorization machine (factor 16,
    the reference's ``examples/sparse/factorization_machine.py``) whose w
    and v live in a ``SparsePS`` (server-side SGD for 25 steps, then
    Adagrad) trains 50 steps: ``row_sparse_pull`` of the touched rows onto
    the card, forward and backward through ``sparse.dot``, a push of the
    row-sparse gradients; the same run on the CPU: losses and tables
    agree, untouched rows bit-unchanged, the first SGD and the first
    Adagrad step of the store against a dense update of the same rows
    computed apart; steps/s, pull, compute and push ms; (b)
    ``Embedding(1_000_000, 64, sparse_grad=True)`` under ``gluon.Trainer``
    3 SGD steps on the card and on the CPU: each step's
    ``grad(stype="row_sparse")`` holds exactly the touched rows, the
    tables agree, untouched rows bit-unchanged; (c) ``_sparse_dot_csr``
    and its gradients at an FM batch's shapes, card against CPU.
24. np — ``mx.np``, ``npx`` and ``mx.util``: (a) every ``np.*`` registry
    name (370, ``np.fft`` and ``np.linalg`` included) on the card and on
    the CPU on the same seeded inputs (``mxnet_tpu_torch/numpy/_sweep.py``):
    outputs and dtypes, every output on the card; the names that
    synchronised with the host (``torch.cuda.set_sync_debug_mode``) are
    printed; (b) BERT-base at bench.py's bert_seq512 width (the util
    phase's net: vocab 30522, batch 32, seq 512, bf16, hybridized,
    multi-precision Adam 1e-4, dropout 0) trained 8 steps under
    ``npx.set_np()`` by ``gluon.Trainer`` on tokens and labels drawn by
    ``mx.np.random.randint`` on the card, with a hybridized loss head
    written only in ``mx.np`` / ``npx`` (``npx.log_softmax`` of the f32
    logits, ``np.take_along_axis``, ``np.mean``): step 1's loss against
    ``SoftmaxCELoss`` on the same logits, the curve against the same 8
    steps written in ``mx.nd`` from the same start weights and batch, the
    parameters through ``npx.save`` / ``npx.load`` bit for bit, 12 bf16
    forward and 12 bf16 fused backward launches a step and no other;
    median step ms, samples/s, MFU, peak memory and idle share.
25. sp — the device mesh and sequence parallelism (``parallel.DeviceMesh``
    of shards that share the card): (a) ``sequence_parallel_attention``
    (ring) and ``ulysses_sequence_parallel_attention`` over a 4-shard
    ``sp`` axis at llama3_8b's attention shape (32 heads, kv from 8 heads
    repeated, head_dim 128, causal, scale 1/sqrt(128)): q (1, 32, 16384,
    128) bf16 and (1, 32, 4096, 128) f32, and the ring again in f32 with
    the last 1000 positions padded (segment ids); out, dq, dk, dv against
    ``flash_attention`` over the whole sequence on the card, the flash
    launches of one call (the ring 10 forward blocks, 10 dq and 10 dkv;
    Ulysses 4 of each), device ms of the forward and of forward +
    backward beside the unsharded call; the flash kernels themselves
    against ``flash_attention_plain`` on the same inputs (out, dq, dk,
    dv) at every shape this phase gives them: the unsharded call, the
    ring's diagonal block (causal) and an off-diagonal one (not), and
    Ulysses' head group, at (a)'s three cases and at the shapes of (b)'s
    dp shard, B 1 x L 4096 bf16 (the fused call (1, 32, 4096, 128), ring
    blocks (1, 32, 1024, 128), Ulysses (1, 8, 4096, 128));
    (b) ``LlamaModel`` at llama3_8b's
    widths (vocab 128256, 4096 units, FFN 14336, 32 heads, 8 kv heads)
    cut to 2 layers, bf16, B 2 x L 4096, 3 ``TrainStep`` steps with
    multi-precision Adam (1e-4) on ``DeviceMesh((2, 4), ("dp", "sp"))``
    for each of ``attn_impl`` fused, ring and ulysses from the same
    weights and batch, each dp shard running its batch row: the loss
    curves, launches a step (ring 2 x 2 x 10 forward, dq and dkv; Ulysses
    2 x 2 x 4; fused 2 x 2), median step ms of 3
    more replays, tokens/s, MFU, peak memory and one profiled step's idle
    share; (c) ``parallel.allreduce`` (sum, mean) and ``allgather`` over
    4 shards equal to plain torch sums and concatenation bit for bit;
    ``mx.kv.create("dist_sync")`` is a world of one over NCCL, and its
    ``pushpull_list`` of (b)'s last gradients equals the local store's
    bit for bit.
26. shard — sharding rules, the sharded TrainStep, the autoshard planner
    and GPipe on ``LlamaModel`` at llama3_8b's widths (vocab 128256, 4096
    units, FFN 14336, 32 heads, 8 kv heads) cut to 2 layers, bf16,
    multi-precision Adam (1e-4), each mesh's shards sharing the card:
    (a) ``partition_rules=sharding.rule_pack("llama")`` on
    ``DeviceMesh((2, 2), ("dp", "tp"))``, B 2 x L 4096, 4 steps against
    the unsharded step on the same weights and batch (2e-3 relative),
    each shard's parameter and optimizer-state bytes beside the unsharded
    totals / tp, the blocks' tp path counted, 8 forward, 8 dq and 8 dK/dV
    flash launches a step (each tp shard's head group, (1, 16, 4096,
    128)), step ms, MFU, peak and idle share of both; (d) that net saved
    (gathered on save) and restored into a fresh net split by a step, the
    parameters bit for bit, then one SGD step of each bit for bit; (b)
    ``autoshard.plan`` for 4 shards, B 4 x L 2048, under 0.4 and 0.5 of
    the dp-only ``estimate_memory`` (the second must carry fsdp), and
    ``TrainStep(plan=)`` 4 steps against the unsharded step (2e-3),
    the estimate's per-device bytes beside each shard's measured bytes
    and the card's peak; (c) ``pipeline.PipelinedBlock`` over the 2
    decoder blocks on a pp mesh of 2, 4 microbatches of 2048 tokens: the
    output and the stacked gradients against the blocks in turn, forward
    + backward ms of both, 8 + 8 + 8 launches; the flash kernels against
    ``flash_attention_plain`` at (1, 16, 4096, 128) and (1, 32, 2048,
    128); one bf16 GEMM (8192 x 4096) @ (4096 x d), d = 32 ... 512, its
    efficiency (the planner's tile term).
27. gate — the perf gate on the card: ``tools/torch_perfgate.py --check
    --device cuda --jobs 7`` against the card tier
    ``tests/perf_baseline_torch_cuda.json`` (each of the seven lanes in a
    child that loads the built kernels) must pass under the bands (exact
    dispatches, builds, executables and counters; FLOPs and bytes 2 %,
    peak memory 5 %); each lane's record, observed wall and flash launches
    printed; ``MXNET_KVSTORE_BUCKET_MB=0`` must turn
    ``trainer_fused_kvstore`` red (exit 1, more dispatches a step); the
    f32 kernels against ``flash_attention_plain`` at the lanes' shapes,
    (2, 2, 512, 64) (single-tile forward, fused backward) and (1, 4,
    2048, 16) causal (streaming forward, dq, dkv).
The second-to-last line is ``{"kernels": [...]}``: ``flash_fwd`` at the
f32 prefill shape (``launches`` counts all train lanes' timed steps,
``serve_launches`` the serve phase's, ``f32_launches`` the f32 launches of
both, ``gluon_launches`` those of the Gluon loop's timed steps, f32 and
bf16), and each backward entry point twice, bf16 (``flash_bwd_*``, the
tensor-core kernels, launches of the bf16 lanes) and f32
(``flash_bwd_*_f32``, the CUDA-core kernels, launches of the f32 lanes),
every entry with the tier phase's launches (``tier_launches``: llama3_8b's
cold prefills and transformer_base's encoder on the forward; 0 on the
backward rows),
the fused ones with the Gluon loop's launches in its dtype
(``gluon_launches``), every entry with the vision phase's launches
(``vision_launches``, 0: ResNet-50 has no attention) and the loop
phase's BERT steps (``loop_launches``: the bf16 forward and fused
backward; 0 elsewhere) and the nd phase's attention ops (``nd_launches``:
the forward and, in each dtype's row, the fused backward, which both
shapes take; 0 on dq and dkv) and the rnn phase's (``rnn_launches``, 0:
the LSTM LM has no attention) and the det, moe and image phases'
(``det_launches``, ``moe_launches``, ``image_launches``: 0, no
attention) and the mt phase's timed steps (``mt_launches``: the forward
of both dtypes; each backward row the fused launches of its dtype, 0 on
dq and dkv) and the util phase's BERT-base steps (``util_launches``: the
bf16 forward and fused backward; 0 elsewhere) and the sym phase's
(``sym_launches``: on the forward both dtypes, with ``sym_f32_launches``
the f32 ones; the f32 fused backward on its row; 0 elsewhere) and the
ops phase's 20 replays (``ops_launches``: the bf16 forward and fused
backward; 0 elsewhere) and the quant phase's timed int8 BERT-base
forwards (``quant_launches``: 12 each on the f32 forward; 0 elsewhere)
and the sparse phase's (``sparse_launches``, 0: no attention) and the np
phase's 8 BERT-base steps (``np_launches``: the bf16 forward and fused
backward; 0 elsewhere) and the sp phase's llama steps (``sp_launches``:
the bf16 forward, dq and dkv; 0 on the fused and f32 rows) and the shard
phase's tp and plan steps and pipeline (``shard_launches``: the bf16
forward, dq and dkv; 0 on the fused and f32 rows) and the gate phase's
lane children (``gate_launches``: the f32 forward, fused, dq and dkv of
its two train lanes; 0 on the bf16 rows);
the last line is ``{"ok": true, "device": {...}}``.

Tolerances.  Forward, on valid rows: f32 out and lse 2e-5 max abs error
(f32 accumulation in another order); bf16 lse 1e-4; bf16 out at most 2
bf16 ulps of max(|ref|, 2^-6) per element.  out is rounded to bf16 once,
so a kernel that sums in another order differs by one ulp where a value
sits near a rounding boundary.  An absolute bound (4e-3) is half an ulp
at |out| in [1, 2), so one such flip there would fail it, and it says
nothing about small values; the floor keeps near-zero outputs from asking
for more than f32 sums give.  The plain version streams kv at the
kernel's tile (``kv_tile``) so p rounds relative to the same running
maxima, and on the card it computes the bf16 tensor-core kernels'
products on the tensor cores too (``flash_attention._product``): with
f32 products, p rounds differently wherever s differs in its last f32
bit, which moved out by up to 5.5 ulps at the causal BERT lane shape on
an H100.  Backward (max abs error over
max |ref|, valid rows): f32 1e-4 (sum order; the fused kernel's dq sums
with atomics in an order that changes from run to run); bf16 5e-3, about
twice the worst seen on an H100 (2.2e-3: ds rounds to bf16 where f32
values an ulp apart round differently).  Prefill logits kernel vs plain:
1e-3.  Train oracle: per-step losses 1e-4 relative (f32, 3 Adam steps);
the same for the Gluon oracle, the Gluon loop against ``TrainStep`` (f32,
8 steps) and the imperative against the hybridized loop (f32, 3 steps).
The captured step: its per-step losses card vs CPU TRAIN_TOL like the
eager step's, a replay after ``load_parameters`` and a replayed padded
BERT step (lr 0) against the eager call TRAIN_TOL (0 seen: the same
kernels); bf16 BERT at n_micro=4 against n_micro=1 BF16_LOSS_TOL (1e-2,
LOOP_ORACLE_TOL's bf16 bound; 3.06e-5 seen on an H100: bf16 gradients
sum in another order); f32 llama with remat against without TRAIN_TOL
(0 seen: the recompute repeats the forward's kernels); mt: the dropout-0
Gluon loop against the captured step TRAIN_TOL, greedy tokens equal to
the full forward's argmax at every position (the dense path below
length 256 masks the buffer's tail to exact zeros).
Vision: each op card vs CPU 1e-5 of max |ref| (f32 sums in another
order; 6.2e-7 seen on an H100); the small ResNet's outputs, loss and
statistics 1e-4 of max |ref|; the ResNet-50 Gluon loop against
``TrainStep`` and the imperative steps TRAIN_TOL relative, under
deterministic cuDNN (0 seen); checkpoints bit for bit.  Loop: the
optimizers card vs CPU ``LOOP_ORACLE_TOL`` (below), the loader, the
store and the states bit for bit.  nd: each op card vs CPU 1e-5 of max
|CPU| elementwise and 1e-4 for sums, products, linear algebra and
attention (cuBLAS and cuSOLVER sum in another order), gradients 1e-4,
decompositions by their invariants (reconstruction and orthogonality 1e-4
of |A|, values 1e-4); the attention ops against their plain flash
versions at the kernel phases' bounds, against the CPU f32 2e-5 out and
1e-4 gradients, bf16 2^-6 of max |ref| (``ND_BF16_HOST_TOL``).  Zoo
(vision): logits card vs CPU 1e-4 of max |CPU|.  rnn: the RNN op card vs
CPU 1e-4 of max |CPU| for outputs, states and gradients (``RNN_FWD_TOL``
says why not 1e-5); CTC 1e-4 (its CUDA backward sums with atomics); the
LM oracle's per-step losses TRAIN_TOL relative.  det: YOLO's raw
outputs card vs CPU 1e-4 of max |CPU| and its loss 1e-5 relative (f32
convolutions sum in another order), decoded rows and the SSD targets' and
detections' classes equal, their coordinates 1e-5, the ops 1e-4 of max
|CPU| (``DET_OP_TOL``: the ops that sum, and gradients that scatter-add);
moe: outputs and gradients 1e-5 of max |CPU|.  image: the N-thread
decode and the decode-pool loader bit for bit; a decoded crop 1 raw unit
/ std of imdecode + crop + normalize (the lanes multiply by 1/std or
divide by std); imresize card vs CPU 1 (float32 sums in another order
round across .5).  sym: the oracle's loss card vs CPU 1e-4 relative and
each output and gradient 1e-3 of max |CPU| (``SYM_ORACLE_TOL``, f32, TF32
off; 2.7e-6 seen on an H100); multi-context and bucketing outputs 1e-3 of
max, parameters after the steps TRAIN_TOL of max; SymbolBlock against
``Module.predict`` and its rebind 1e-4 of max (the same kernels: 0 seen);
the bf16 serve's logits 2^-5 of max |f32| (``SYM_BF16_TOL``; 6.0e-3 seen).
ops: the cost ledger's FLOPs of the step within 1 % of the hand count
(both count the same GEMMs and the flash formula: equal seen), the step
clock's phases equal to each step's total (to 1e-9 relative), the median
step with telemetry and the ledger on at most 5 % (``OPS_OVERHEAD``)
above off (0.9984 of it seen on an H100).
quant: int32 products card vs CPU bit for bit; int8 against float, each
over max |float|: the mean |d| 0.03 and the max 0.30 (the reference's
own bounds for entropy calibration, whose KL thresholds clip outliers)
and the cosine 0.98, on BERT-base's sequence output and the symbolic
encoder's logits; ResNet-50 top-1 agreement 0.9 and cosine 0.98; the
flash forward at the path's shape 2e-5.  sparse: FM losses and tables
card vs CPU 1e-4 relative (``index_add`` sums with atomics on the card),
a store step against the dense update 1e-6, ``_sparse_dot_csr`` and its
gradients 1e-5 of max |CPU|, the Embedding tables 1e-5 of max.  np: each
case card vs CPU ``_sweep.TOL`` of max |CPU| (1e-5 elementwise, 1e-4 for
what sums, sorts or factors; integers, bools and host values equal;
decompositions by their invariants); the np loss at step 1 against
``SoftmaxCELoss`` 1e-6 relative (the same f32 log-softmax, the mean in
another order); the np curve against the nd curve 2e-3 relative a step
(``NP_CURVE_TOL``: the fused backward's dq sums by atomics, so two runs of
one step differ in the last bits, and Adam carries that on); the saved
parameters bit for bit.  sp: against the unsharded flash call, over max
|ref|, f32 out 1e-5 and gradients 1e-4 (sums in another order), bf16 out
1e-2 and gradients 2e-2 (``SP_TOL``: the ring rounds each block's output,
and each block's dq, dk and dv, to bf16 before their f32 sums), and
the same ``SP_TOL`` for the kernels against their plain version at the
phase's shapes, over max |plain|; the ring
and Ulysses llama losses against the fused ones ``BF16_LOSS_TOL``
relative a step; the collectives and the stores bit for bit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # H100 SXM, dense
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (None, 1e-4)}  # (out, lse)
BF16_OUT_ULPS = 2          # bf16 out: ulps of max(|ref|, 2^-6), per element
LOGITS_TOL = 1e-3


def _log(msg):
    print(msg, flush=True)


def _time_ms(torch, fn, iters=20, reps=5, warmup=3):
    """Median per-call device time (CUDA events) over ``reps`` runs of
    ``iters`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _bound_ms(B, H, Lq, Lk, D, dtype_name, causal, pairs=None):
    """Least time for the work: flops (4 B H Lq Lk D, halved when causal;
    4 H D ``pairs`` where segment ids keep only ``pairs`` query-key pairs
    of the batch) over the type's peak, or bytes (q, k, v read once; out,
    lse written once) over HBM bandwidth — the larger, and which one
    bounds."""
    elt = 4 if dtype_name == "float32" else 2
    flops = 4.0 * H * D * pairs if pairs is not None else \
        4.0 * B * H * Lq * Lk * D * (0.5 if causal else 1.0)
    nbytes = elt * B * H * (2 * Lq * D + 2 * Lk * D) + 4 * B * H * Lq
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bf16_ulps(torch, got, ref, rows):
    """max over valid rows of |got - ref| in bf16 ulps of max(|ref|, 2^-6)
    (a bf16 ulp of x in [2^e, 2^(e+1)) is 2^(e-7))."""
    mag = ref.float().abs().clamp(min=2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - ref.float()).abs() / ulp
            * rows[:, None, :, None]).max().item()


def _segs(torch, B, L, pad, dev):
    """(B, L) int32 ids: row 0 padded by ``pad`` positions, others full."""
    valid = torch.tensor([L - pad] + [L] * (B - 1), device=dev)
    return (torch.arange(L, device=dev)[None, :] < valid[:, None]) \
        .to(torch.int32)


def kernel_phase(torch, fa):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    shapes = [("prefill", 1, 32, 1024, 1024, 128),
              ("single-tile", 2, 32, 512, 512, 128),
              ("streaming", 1, 32, 2048, 2048, 128),
              ("cross", 2, 32, 256, 512, 128)]
    # the training lanes' shapes: the BERT lane runs non-causal (padded
    # batches with segment ids), the llama lane causal
    lanes = [("bert-lane", 32, 12, 512, 512, 64, False),
             ("llama-lane", 4, 16, 2048, 2048, 128, True)]
    # every output-column layout of the kernel, ragged tiles included
    head_dims = [(f"head_dim {D}", 2, 2, 200, 328, D)
                 for D in (8, 40, 64, 96, 136, 200, 256)]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    errors = {}
    for label, B, H, Lq, Lk, D in shapes + [l[:6] for l in lanes] \
            + head_dims:
        for dname, dt in dtypes.items():
            q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(dt)
            k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
            v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
            scale = 1.0 / D ** 0.5
            for causal in (False, True):
                for with_seg in (False, True):
                    sq = _segs(torch, B, Lq, 37, dev) if with_seg else None
                    skv = _segs(torch, B, Lk, 53, dev) if with_seg else None
                    out, lse = fa._fwd(q, k, v, sq, skv, causal, scale)
                    torch.cuda.synchronize()
                    ref, ref_lse = fa.flash_attention_reference(
                        q, k, v, sq, skv, causal, scale,
                        block_k=fa.kv_tile(dt, D))
                    rows = torch.ones(B, Lq, dtype=torch.bool, device=dev) \
                        if sq is None else sq.bool()
                    e_out = ((out.float() - ref.float()).abs()
                             * rows[:, None, :, None]).max().item()
                    e_lse = ((lse - ref_lse).abs() * rows[:, None, :]) \
                        .max().item()
                    tol_out, tol_lse = TOL[dname]
                    if tol_out is None:
                        ulps = _bf16_ulps(torch, out, ref, rows)
                        ok_out = ulps <= BF16_OUT_ULPS
                        shown = f"{e_out:.3e} ({ulps:.2f} ulp)"
                    else:
                        ok_out, shown = e_out <= tol_out, f"{e_out:.3e}"
                    ok = ok_out and e_lse <= tol_lse
                    key = (label, dname, causal, with_seg)
                    errors[key] = (e_out, e_lse)
                    _log(f"check {label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} "
                         f"{dname} causal={causal} seg={with_seg}: out err "
                         f"{shown} lse err {e_lse:.3e} "
                         f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"flash_fwd disagrees with its plain version at "
                            f"{key}: out {shown} (tol {tol_out or BF16_OUT_ULPS}"
                            f"{'' if tol_out else ' ulp'}), lse {e_lse} (tol "
                            f"{tol_lse})")
    # the CUDA-core kernel sums without atomics: two launches on the same
    # inputs give the same bits
    B, H, L, D = 1, 32, 1024, 128
    q, k, v = (torch.randn(B, H, L, D, generator=gen, device=dev)
               for _ in range(3))
    first = fa._fwd(q, k, v, None, None, True, D ** -0.5)
    again = fa._fwd(q, k, v, None, None, True, D ** -0.5)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    _log(f"check determinism prefill B={B} H={H} L={L} D={D} float32 "
         f"causal=True: two launches {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("flash_fwd f32 is not deterministic")

    timings, sdpa_kernels = {}, {}
    timed = [(label, B, H, Lq, Lk, D, True, dname)
             for label, B, H, Lq, Lk, D in shapes for dname in dtypes]
    timed += [lane + ("bfloat16",) for lane in lanes]
    for label, B, H, Lq, Lk, D, causal, dname in timed:
        dt = dtypes[dname]
        q = torch.randn(B, H, Lq, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B, H, Lk, D, generator=gen, device=dev).to(dt)
        scale = 1.0 / D ** 0.5
        t_k = _time_ms(torch, lambda: fa._fwd(q, k, v, None, None, causal,
                                              scale))
        t_p = _time_ms(torch, lambda: fa.flash_attention_reference(
            q, k, v, None, None, causal, scale), iters=5)
        t_l = _time_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(
                           q, k, v, is_causal=causal, scale=scale))
        bound, bound_by = _bound_ms(B, H, Lq, Lk, D, dname, causal)
        timings[(label, dname)] = (t_k, t_p, t_l, bound, bound_by)
        extra = ""
        if dname == "float32":
            _, names = _device_ms(torch, lambda: torch.nn.functional
                                  .scaled_dot_product_attention(
                                      q, k, v, is_causal=causal,
                                      scale=scale), iters=1)
            sdpa_kernels[label] = names
            extra = f"; sdpa ran {names}"
        _log(f"time {label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} {dname} "
             f"causal={causal}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
             f"sdpa {t_l:.4f} ms, bound {bound:.4f} ms ({bound_by}), "
             f"kernel/bound {t_k / bound:.2f}, kernel/sdpa {t_k / t_l:.2f}"
             + extra)
    return errors, timings, sdpa_kernels


BWD_TOL = {"float32": 1e-4, "bfloat16": 5e-3}   # relative to max |ref|


def _bwd_bound_ms(kind, B, H, Lq, Lk, D, dtype_name, causal):
    """Least time for one backward kernel's work: operations (10, 6 or 8
    B H Lq Lk D for fused, dq and dkv, halved when causal) over the type's
    peak, or bytes (inputs read once, outputs written once) over HBM
    bandwidth — the larger, and which one bounds."""
    elt = 4 if dtype_name == "float32" else 2
    mult = {"fused": 10, "dq": 6, "dkv": 8}[kind]
    flops = mult * B * H * Lq * Lk * D * (0.5 if causal else 1.0)
    ins = elt * B * H * (2 * Lq * D + 2 * Lk * D) + 2 * 4 * B * H * Lq
    outs = {"fused": elt * B * H * (Lq + 2 * Lk) * D,
            "dq": elt * B * H * Lq * D,
            "dkv": elt * B * H * 2 * Lk * D}[kind]
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = (ins + outs) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _errs(got, ref, rows):
    """(max |got - ref|, that over max |ref|) over rows (B, L) marked
    valid."""
    m = rows[:, None, :, None]
    diff = ((got.float() - ref.float()).abs() * m).max().item()
    return diff, diff / max((ref.float().abs() * m).max().item(), 1e-30)


def bwd_kernel_phase(torch, fa):
    """The three backward kernels against the plain backward on the card:
    dq, dk, dv on valid rows, f32 and bf16, causal and not, with and
    without segment ids (a padded row); then autograd through
    ``flash_attention`` at the two lane shapes; then times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    shapes = [("bert-lane", 32, 12, 512, 512, 64),        # fused
              ("llama-lane", 4, 16, 2048, 2048, 128),     # dq + dkv
              ("cross", 2, 12, 256, 512, 64),             # fused
              ("L384", 2, 8, 384, 384, 64)]               # dq + dkv
    for D in (8, 40, 64, 96, 136, 200, 256):
        shapes.append((f"head_dim {D} fused", 2, 2, 200, 328, D))
        shapes.append((f"head_dim {D} split", 2, 2, 384, 640, D))
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {d: 0.0 for d in dtypes}
    errors = {}
    for label, B, H, Lq, Lk, D in shapes:
        fused = fa.bwd_is_fused(Lq, Lk)
        for dname, dt in dtypes.items():
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                           .to(dt) for L in (Lq, Lk, Lk, Lq))
            scale = 1.0 / D ** 0.5
            for causal in (False, True):
                for with_seg in (False, True):
                    sq = _segs(torch, B, Lq, 37, dev) if with_seg else None
                    skv = _segs(torch, B, Lk, 53, dev) if with_seg else None
                    out, lse = fa._fwd(q, k, v, sq, skv, causal, scale)
                    got = fa._bwd(q, k, v, sq, skv, out, lse, do, causal,
                                  scale)
                    torch.cuda.synchronize()
                    ref = fa.flash_attention_backward_reference(
                        q, k, v, sq, skv, out, lse, do, causal, scale)
                    rq = torch.ones(B, Lq, device=dev) if sq is None \
                        else sq.float()
                    rk = torch.ones(B, Lk, device=dev) if skv is None \
                        else skv.float()
                    pairs = [_errs(g, r, rows) for g, r, rows in
                             zip(got, ref, (rq, rk, rk))]
                    errs = [rel for _, rel in pairs]
                    e = max(errs)
                    worst[dname] = max(worst[dname], e)
                    key = (label, dname, causal, with_seg)
                    errors[key] = [a for a, _ in pairs]   # dq, dk, dv
                    ok = e <= BWD_TOL[dname]
                    _log(f"check bwd {'fused' if fused else 'dq+dkv'} "
                         f"{label} B={B} H={H} Lq={Lq} Lk={Lk} D={D} {dname}"
                         f" causal={causal} seg={with_seg}: rel err dq "
                         f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
                         f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"flash backward kernel disagrees with its plain "
                            f"version at {key}: {errs} (tol "
                            f"{BWD_TOL[dname]})")
    _log(f"bwd worst relative error: f32 {worst['float32']:.3e}, bf16 "
         f"{worst['bfloat16']:.3e}")

    # the CUDA-core dq and dkv kernels sum without atomics: two launches on
    # the same inputs give the same bits, and so do fused's dk, dv (its dq
    # goes through atomics and is not reproducible bit for bit)
    for kind, B, H, L, D, causal in [("dq", 4, 16, 2048, 128, True),
                                     ("dkv", 4, 16, 2048, 128, True),
                                     ("fused", 32, 12, 512, 64, False)]:
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                       for _ in range(4))
        out, lse = fa._fwd(q, k, v, None, None, causal, D ** -0.5)
        x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                           D ** -0.5)
        launch, what = {
            "dq": (lambda x: (fa.launch_bwd_dq(x),), "dq"),
            "dkv": (fa.launch_bwd_dkv, "dk, dv"),
            "fused": (lambda x: fa.launch_bwd_fused(x)[1:], "dk, dv")}[kind]
        first, again = launch(x), launch(x)
        same = all(torch.equal(a, b) for a, b in zip(first, again))
        _log(f"check determinism bwd {kind} B={B} H={H} L={L} D={D} float32 "
             f"causal={causal}: {what} of two launches "
             f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"flash_bwd {kind} f32 {what} is not "
                                 f"deterministic")

    # autograd through flash_attention at the lanes' shapes and types
    for label, B, H, L, D, causal, want in [
            ("bert-lane", 32, 12, 512, 64, False, "fused"),
            ("llama-lane", 4, 16, 2048, 128, True, "split")]:
        q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        seg = _segs(torch, B, L, 100, dev) if label == "bert-lane" else None
        scale = 1.0 / D ** 0.5
        before = (fa.bwd_fused_launches, fa.bwd_dq_launches,
                  fa.bwd_dkv_launches)
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        out = fa.flash_attention(qg, kg, vg, seg, seg, causal, scale)
        got = torch.autograd.grad(out, (qg, kg, vg), do)
        after = (fa.bwd_fused_launches, fa.bwd_dq_launches,
                 fa.bwd_dkv_launches)
        o2, lse = fa._fwd(q, k, v, seg, seg, causal, scale)
        ref = fa.flash_attention_backward_reference(q, k, v, seg, seg, o2,
                                                    lse, do, causal, scale)
        rows = torch.ones(B, L, device=dev) if seg is None else seg.float()
        e = max(_errs(g, r, rows)[1] for g, r in zip(got, ref))
        step = [a - b for a, b in zip(after, before)]
        want_step = [1, 0, 0] if want == "fused" else [0, 1, 1]
        _log(f"check autograd {label} bf16 causal={causal}: rel err "
             f"{e:.2e}, launches fused/dq/dkv {step}")
        if e > BWD_TOL["bfloat16"] or step != want_step:
            raise AssertionError(f"autograd through flash_attention at "
                                 f"{label}: err {e}, launches {step}")

    timings = {}
    for kind, B, H, L, D, causal in [("fused", 32, 12, 512, 64, False),
                                     ("dq", 4, 16, 2048, 128, True),
                                     ("dkv", 4, 16, 2048, 128, True)]:
        launch = {"fused": fa.launch_bwd_fused, "dq": fa.launch_bwd_dq,
                  "dkv": fa.launch_bwd_dkv}[kind]
        # f32 (the CUDA-core kernels), then bf16 (the tensor cores), each
        # with the plain version and SDPA's backward in the same dtype
        for dname in ("float32", "bfloat16"):
            dt = dtypes[dname]
            shape = (f"B={B} H={H} Lq=Lk={L} D={D} {dname} "
                     f"{'causal' if causal else 'non-causal'}")
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen, device=dev)
                           .to(dt) for _ in range(4))
            scale = 1.0 / D ** 0.5
            out, lse = fa._fwd(q, k, v, None, None, causal, scale)
            x = fa.prepare_bwd(q, k, v, None, None, out, lse, do, causal,
                               scale)
            t_k = _time_ms(torch, lambda: launch(x))
            bound, bound_by = _bwd_bound_ms(kind, B, H, L, L, D, dname,
                                            causal)
            t_p = _time_ms(torch, lambda: fa.flash_attention_backward_reference(
                q, k, v, None, None, out, lse, do, causal, scale), iters=3,
                reps=3)
            # SDPA's backward alone: dq, dk, dv of one recorded forward
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            o = torch.nn.functional.scaled_dot_product_attention(
                qg, kg, vg, is_causal=causal, scale=scale)

            def sdpa_bwd():
                return torch.autograd.grad(o, (qg, kg, vg), do,
                                           retain_graph=True)

            t_le = _time_ms(torch, sdpa_bwd)
            t_l, names = _device_ms(torch, sdpa_bwd)
            del o
            rec = {"shape": shape, "ms": t_k, "plain_ms": t_p,
                   "library_ms": t_l, "library_events_ms": t_le,
                   "library_kernels": names, "bound_ms": bound,
                   "bound_by": bound_by}
            pre = "f32_" if dname == "float32" else ""
            timings.setdefault(kind, {}).update(
                {pre + key: val for key, val in rec.items()})
            _log(f"time bwd {kind} {shape}: kernel {t_k:.4f} ms, "
                 f"plain {t_p:.4f} ms, sdpa bwd (dq+dk+dv) {t_l:.4f} ms "
                 f"device kernels, {t_le:.4f} ms CUDA events, bound "
                 f"{bound:.4f} ms ({bound_by}), kernel/bound "
                 f"{t_k / bound:.2f}, kernel/sdpa {t_k / t_l:.2f}; sdpa ran "
                 f"{names}")
    return errors, worst, timings


def _llama_init(tmx, std):
    """The zoo llama's random weights: Normal(0, std) matrices, ones for
    the norms."""
    return tmx.init.Mixed([".*norm_weight", ".*"],
                          [tmx.init.One(), tmx.init.Normal(std)])


def _llama_net(tmx, llama, name, vocab, ctx, seed, std=0.02, train=True):
    """The Gluon zoo llama ``name`` initialized on ``ctx`` from ``seed``
    (the device's generator: no host copy); without ``train`` it has no
    gradient buffers (serving)."""
    net = llama.llama_model(name, vocab_size=vocab, prefix="llm_")
    if not train:
        net.collect_params().setattr("grad_req", "null")
    tmx.random.seed(seed)
    net.initialize(_llama_init(tmx, std), ctx=ctx)
    return net


def oracle_phase(torch, tmx, llama, serving):
    """Paged serving on the card == greedy full re-encode (token identity,
    the reference's serving oracle); prefill and re-encode run at L=256,
    so both go through the flash kernel.  Then the net's
    ``save_parameters`` / ``load_parameters`` round trip into a fresh
    llama on the card, bit for bit."""
    net = _llama_net(tmx, llama, "llama_small", 101, tmx.gpu(), 7, 0.05,
                     train=False)
    P = 256
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=4, block_tokens=16,
                                max_seq=P, prefill_tokens=P)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(3, 101, n).tolist() for n in (5, 40, 131, 200)]
    new = 12
    outs = eng.generate(prompts, max_new_tokens=new)
    with torch.inference_mode():
        for p, got in zip(prompts, outs):
            buf = torch.zeros((1, P), dtype=torch.long, device="cuda")
            buf[0, :len(p)] = torch.tensor(p)
            n, want = len(p), []
            for _ in range(new):
                nxt = int(net(buf)[0, n - 1].argmax())
                want.append(nxt)
                buf[0, n] = nxt
                n += 1
            if got != want:
                raise AssertionError(
                    f"served tokens {got} != re-encode {want} for a "
                    f"{len(p)}-token prompt")
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "llama_small.params")
        net.save_parameters(f)
        back = llama.llama_model("llama_small", vocab_size=101,
                                 prefix="other_")
        back.load_parameters(f, ctx=tmx.gpu())
    a, b = net.collect_params().values(), back.collect_params().values()
    if not all(torch.equal(x.data()._data, y.data()._data)
               for x, y in zip(a, b)):
        raise AssertionError("llama_small did not reload bit for bit")
    _log(f"oracle llama_small (Gluon llama): {len(prompts)} requests "
         f"token-identical to greedy re-encode; save_parameters / "
         f"load_parameters of {len(a)} parameters bit for bit")


def serve_phase(torch, fa, tmx, llama, serving, args):
    vocab = 128256
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = _llama_net(tmx, llama, "llama3_8b", vocab, tmx.gpu(), args.seed,
                     train=False)
    torch.cuda.synchronize()
    layers = len(net.blocks)
    n_params = sum(p.numel() for p in net.parameters())
    if {p.dtype for p in net.parameters()} != {torch.float32}:
        raise AssertionError("llama3_8b serving is meant to run in f32")
    grown = torch.cuda.max_memory_allocated() - before
    _log(f"serve: llama3_8b (Gluon llama, initialize on the card) "
         f"layers={layers} params={n_params} ({n_params * 4 / 1e9:.2f} GB "
         f"f32) built in {time.perf_counter() - t0:.1f} s; peak memory "
         f"grew {grown / 2**30:.2f} GiB")
    if grown > n_params * 4 + 2**30:
        raise AssertionError("initialize made a second copy of the weights "
                             f"({grown} bytes for {n_params * 4})")
    eng = serving.ServingEngine(net, eos_id=-1, max_batch=8, block_tokens=16,
                                max_seq=2048, prefill_tokens=1024)
    ad = eng.adapter
    prefill_s, decode_s = [], []
    orig_prefill, orig_decode = ad.prefill, ad.decode

    def timed_prefill(*a, **kw):
        t = time.perf_counter()
        r = orig_prefill(*a, **kw)           # returns a host int: synced
        prefill_s.append(time.perf_counter() - t)
        return r

    def timed_decode(*a, **kw):
        t = time.perf_counter()
        if decode_s:
            # the steady decode steps build nothing
            with tmx.analysis.no_retrace():
                r = orig_decode(*a, **kw)    # returns host numpy: synced
        else:
            r = orig_decode(*a, **kw)
        decode_s.append(time.perf_counter() - t)
        return r

    ad.prefill, ad.decode = timed_prefill, timed_decode
    rng = np.random.RandomState(args.seed)
    lens = np.linspace(100, 1000, 8).astype(int)
    prompts = [rng.randint(3, vocab, int(n)).tolist() for n in lens]
    new = 16
    _reset_counts(fa)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new)
    wall = time.perf_counter() - t0
    counts = _counts(fa)
    launches = counts["flash_fwd"]
    ad.prefill, ad.decode = orig_prefill, orig_decode
    for p, o in zip(prompts, outs):
        if len(o) != new or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"bad output for a {len(p)}-token prompt: "
                                 f"{o}")
    if len(prefill_s) < len(prompts) or launches < layers * len(prefill_s):
        raise AssertionError(
            f"flash kernel launched {launches} times over {len(prefill_s)} "
            f"prefills of {layers} layers")
    _log(f"serve: {len(prompts)} requests x {new} tokens in {wall:.2f} s; "
         f"{len(prefill_s)} prefills (P=1024) median "
         f"{statistics.median(prefill_s) * 1e3:.1f} ms "
         f"[{', '.join(f'{s * 1e3:.1f}' for s in prefill_s)}]; "
         f"{len(decode_s)} decode steps (B=8, all after the first under "
         f"no_retrace()) median "
         f"{statistics.median(decode_s) * 1e3:.1f} ms; flash launches "
         f"{launches} ({launches / len(prefill_s):.1f} per prefill); "
         f"launches {counts}")
    row = np.zeros(eng.cache.max_blocks_per_seq, np.int32)   # scratch row
    tok_k, logits_k = ad.prefill_logits(prompts[-1], row)
    tok_p, logits_p = ad.prefill_logits(prompts[-1], row,
                                        flash_reference=True)
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("non-finite prefill logits")
    err = (logits_k - logits_p).abs().max().item()
    _log(f"serve: prefill logits kernel vs plain max abs err {err:.3e} "
         f"(|logits| max {logits_p.abs().max().item():.3f}, tol "
         f"{LOGITS_TOL}); first token kernel {tok_k} plain {tok_p} "
         f"served {outs[-1][0]}")
    if err > LOGITS_TOL or tok_k != outs[-1][0]:
        raise AssertionError("prefill with the kernel disagrees with the "
                             "plain version or with the served token")
    return counts, net


TIER = {"shared": 768, "tail_min": 32, "tail_max": 224, "requests": 8,
        "new": 16, "spec_k": 3, "mt_min": 100, "mt_max": 256,
        "router_requests": 32, "router_vocab": 32000, "router_new": 16,
        "router_bursts": 3}
TIER_ENGINE = dict(max_batch=8, block_tokens=16, max_seq=2048,
                   prefill_tokens=1024)
TIER_REPLICA = dict(max_batch=8, block_tokens=16, max_seq=512,
                    prefill_tokens=256)


def _hist_quantiles(h, qs=(0.5, 0.99)):
    """Upper bucket bounds (seconds) below which a fraction ``q`` of a
    telemetry histogram's observations lie ("+Inf" past the last)."""
    snap = h.snapshot()
    out = []
    for q in qs:
        want = q * snap["count"]
        out.append(next((f"{b:g}" for b, c in snap["buckets"].items()
                         if c >= want), "+Inf"))
    return out


def _timed(obj, name, sink):
    """Wrap ``obj.name`` (a call that returns host values, so it ends
    synchronised) to append its wall seconds to ``sink``."""
    orig = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        r = orig(*a, **kw)
        sink.append(time.perf_counter() - t)
        return r
    setattr(obj, name, timed)


def _served(torch, serving, net, prompts, new, **kw):
    """One ServingEngine run of ``prompts``: (tokens, engine, wall s,
    prefill s per call, decode-side s per call).  The engine is returned
    so callers read its cache; they drop it before the next run."""
    gc.collect()
    torch.cuda.empty_cache()
    eng = serving.ServingEngine(net, eos_id=kw.pop("eos_id", -1), **kw)
    pre, dec = [], []
    ads = [eng.adapter] + ([eng._spec] if eng._spec is not None else [])
    for ad in ads:
        _timed(ad, "prefill", pre)
        if hasattr(ad, "prefill_tail"):
            _timed(ad, "prefill_tail", pre)
        _timed(ad, "decode", dec)
        if hasattr(ad, "decode_multi"):
            _timed(ad, "decode_multi", dec)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=new)
    wall = time.perf_counter() - t0
    return outs, eng, wall, pre, dec


def _tier_prefix(torch, fa, tmx, serving, net, args, smi):
    """Prefix cache at llama3_8b width: 8 requests sharing a 768-token
    system prompt (48 blocks of 16) with distinct tails, off then on."""
    tel = tmx.telemetry
    vocab = int(net.embed.weight.shape[0])
    layers = len(net.blocks)
    rng = np.random.RandomState(args.seed + 17)
    shared = rng.randint(3, vocab, TIER["shared"]).tolist()
    tails = np.linspace(TIER["tail_min"], TIER["tail_max"],
                        TIER["requests"]).astype(int)
    prompts = [shared + rng.randint(3, vocab, int(n)).tolist()
               for n in tails]
    pos = tel.counter("mxnet_serving_prefill_positions_total")
    runs = {}
    for on in (False, True):
        p0, f0 = pos.value, fa.launches
        outs, eng, wall, pre, dec = _served(
            torch, serving, net, prompts, TIER["new"], prefix_cache=on,
            **TIER_ENGINE)
        cache = eng.cache
        runs[on] = {"outs": outs, "wall": wall, "pre": pre, "dec": dec,
                    "positions": pos.value - p0, "flash": fa.launches - f0,
                    "hits": cache.prefix_hits,
                    "hit_tokens": cache.prefix_hit_tokens,
                    "cow": cache.cow_copies,
                    "pool_gib": sum(k.numel() + v.numel() for k, v in
                                    eng.adapter._kv) * 4 / 2**30}
        del eng, cache
    off, on = runs[False], runs[True]
    for o in off["outs"]:
        if len(o) != TIER["new"] or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"tier prefix: bad output {o}")
    if on["outs"] != off["outs"]:
        bad = sum(a != b for a, b in zip(on["outs"], off["outs"]))
        raise AssertionError(f"tier prefix: {bad} of {len(prompts)} "
                             "requests differ with the prefix cache on")
    cold_on = TIER["requests"] - on["hits"]
    if on["hits"] < TIER["requests"] - 1 \
            or on["positions"] >= off["positions"] \
            or off["flash"] < layers * TIER["requests"] \
            or on["flash"] < layers * cold_on:
        raise AssertionError(f"tier prefix: hits {on['hits']}, prefill "
                             f"positions {on['positions']} (off "
                             f"{off['positions']}), flash launches "
                             f"{on['flash']} / {off['flash']}")
    hit_ms = [s * 1e3 for s in on["pre"][1:]]
    _log(f"tier prefix: llama3_8b, {TIER['requests']} requests sharing "
         f"{TIER['shared']} tokens, tails {tails.tolist()}, "
         f"{TIER['new']} new tokens; tokens equal with the cache on and "
         f"off; hits {on['hits']}, hit tokens {on['hit_tokens']}, COW "
         f"{on['cow']}; prefill positions {on['positions']} on vs "
         f"{off['positions']} off; flash launches {on['flash']} on vs "
         f"{off['flash']} off ({off['flash'] / TIER['requests']:.1f} a "
         f"cold prefill); KV pool {on['pool_gib']:.2f} GiB ({smi})")
    _log(f"tier prefix: cold prefill wall ms median "
         f"{statistics.median(off['pre']) * 1e3:.1f} "
         f"[{', '.join(f'{s * 1e3:.1f}' for s in off['pre'])}]; hit "
         f"admission (tail chunks of 16) wall ms "
         f"[{', '.join(f'{s:.1f}' for s in hit_ms)}] for tails "
         f"{tails[1:].tolist()}; generate wall {off['wall']:.2f} s off, "
         f"{on['wall']:.2f} s on ({smi})")
    return prompts, off


def _tier_spec(torch, fa, tmx, llama, serving, net, prompts, plain, args,
               smi):
    """Speculative decoding at llama3_8b width, spec_k=3: the target as its
    own draft (weights shared, a second pool), then a llama_small draft at
    the target's vocabulary."""
    tel = tmx.telemetry
    vocab = int(net.embed.weight.shape[0])
    k, new = TIER["spec_k"], TIER["new"]
    hist = tel.REGISTRY.get("mxnet_serving_accepted_draft_tokens")
    steps = tel.counter("mxnet_serving_decode_steps_total")

    def per_token_ms(run):
        wall, pre = run[2], run[3]
        return (wall - sum(pre)) / (new - 1) * 1e3

    plain_ms = (plain["wall"] - sum(plain["pre"])) / (new - 1) * 1e3
    small = _llama_net(tmx, llama, "llama_small", vocab, tmx.gpu(),
                       args.seed + 1, train=False)
    lines = []
    for label, draft in (("identical", net), ("llama_small", small)):
        h0 = list(hist._raw()[1])
        s0 = steps.value
        run = _served(torch, serving, net, prompts, new, draft_model=draft,
                      spec_k=k, **TIER_ENGINE)
        outs, ms = run[0], per_token_ms(run)
        del run                       # the engine and its two pools
        n_steps = steps.value - s0
        accepted = [b - a for a, b in zip(h0, hist._raw()[1])]
        if outs != plain["outs"]:
            bad = sum(a != b for a, b in zip(outs, plain["outs"]))
            raise AssertionError(f"tier spec ({label} draft): {bad} "
                                 "requests differ from plain decoding")
        want = -(-(new - 1) // (k + 1))
        if label == "identical" and n_steps != want:
            raise AssertionError(
                f"tier spec: the identical draft took {n_steps} verify "
                f"dispatches for {new - 1} tokens, not {want} (k+1 each)")
        lines.append(f"{label} draft: {n_steps} verify dispatches, "
                     f"{(new - 1) / n_steps:.2f} tokens a dispatch a "
                     f"request, decode {ms:.2f} ms an "
                     f"emitted token, accepted-draft histogram (le 0, 1, "
                     f"2, 3, ...) {accepted[:5]}")
    del small
    _log(f"tier spec: llama3_8b, spec_k={k}, tokens equal plain greedy for "
         f"both drafts; plain decode {plain_ms:.2f} ms an emitted token; "
         + "; ".join(lines) + f" ({smi})")


def _tier_mt(torch, fa, tmx, serving, args, smi):
    """transformer-base served from padded 256-token sources against the
    port's greedy_decode of the same model on the card."""
    tr = tmx.gluon.model_zoo.transformer
    gpu = tmx.gpu()
    mt = tr.transformer_model(MT["name"], vocab_size=MT["vocab"],
                              dropout=0.0, prefix="mtserve_")
    mt.collect_params().setattr("grad_req", "null")
    tmx.random.seed(args.seed)
    mt.initialize(tmx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(args.seed + 23)
    lens = np.linspace(TIER["mt_min"], TIER["mt_max"],
                       TIER["requests"]).astype(int)
    srcs = [rng.randint(3, MT["vocab"], int(n)).tolist() for n in lens]
    new = TIER["new"]
    f0 = fa.launches
    outs, eng, wall, pre, dec = _served(
        torch, serving, mt, srcs, new, eos_id=MT_EOS, bos_id=MT_BOS,
        max_batch=8, block_tokens=16, max_seq=256, prefill_tokens=256)
    flash = fa.launches - f0
    del eng
    padded = np.zeros((len(srcs), 256), np.int32)
    for i, s in enumerate(srcs):
        padded[i, :len(s)] = s
    ref = tr.greedy_decode(
        mt, tmx.nd.array(padded, ctx=gpu, dtype="int32"), MT_BOS, MT_EOS,
        max_len=new + 1,
        src_valid_length=tmx.nd.array(lens, ctx=gpu, dtype="int32"))
    want = []
    for row in ref:
        toks = [int(t) for t in row[1:]]
        want.append(toks[:toks.index(MT_EOS) + 1] if MT_EOS in toks
                    else toks)
    if outs != want:
        bad = sum(a != b for a, b in zip(outs, want))
        raise AssertionError(f"tier mt: {bad} of {len(srcs)} sources "
                             "differ from greedy_decode")
    if flash < MT["layers"] * len(srcs):
        raise AssertionError(f"tier mt: {flash} flash launches for "
                             f"{len(srcs)} prefills of {MT['layers']} "
                             "encoder layers")
    _log(f"tier mt: transformer_base (vocab {MT['vocab']}), {len(srcs)} "
         f"sources of {lens.tolist()} tokens padded to 256, {new} new "
         f"tokens: equal to greedy_decode; flash launches {flash} "
         f"({flash / len(srcs):.1f} a prefill); encoder prefill wall ms "
         f"median {statistics.median(pre) * 1e3:.2f}, decode step "
         f"{statistics.median(dec) * 1e3:.2f} (B=8); generate "
         f"{wall:.2f} s ({smi})")


def _tier_wait_running(router, workdir, count, timeout_s):
    """Wait until ``count`` replicas' heartbeats report their engine
    built (phase "running")."""
    from mxnet_tpu_torch.resilience import heartbeat
    deadline = time.monotonic() + timeout_s
    while True:
        beats = heartbeat.read_all(os.path.join(workdir, "hb"))
        phases = {i: b.get("phase") for i, b in beats.items()}
        if sum(p == "running" for p in phases.values()) >= count:
            return
        if time.monotonic() > deadline or "failed" in phases.values():
            raise AssertionError(
                f"tier router: replica engines not built (waited up to "
                f"{timeout_s} s): phases {phases}, "
                f"{router.replica_status()}")
        time.sleep(0.05)


def _tier_replica_logs(workdir, nbytes=1500):
    """The end of each replica's log under the router's workdir."""
    out = []
    logs = os.path.join(workdir, "logs")
    for fn in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        with open(os.path.join(logs, fn), "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            tail = f.read().decode("utf-8", "replace")
        out.append(f"{fn}: ...{tail}")
    return "replica logs: " + (" | ".join(out) or "none")


def _tier_router(torch, tmx, serving, args, smi):
    """Two llama_small replicas (the same seed) as subprocesses on this
    card behind one Router; one is SIGKILLed while it decodes."""
    import shutil
    import signal
    from mxnet_tpu_torch.serving.replica import build_llama
    tel = tmx.telemetry
    V, new, n = TIER["router_vocab"], TIER["router_new"], \
        TIER["router_requests"]
    rng = np.random.RandomState(args.seed + 31)
    prompts = [rng.randint(3, V, int(m)).tolist()
               for m in rng.randint(20, 241, n)]
    net = build_llama("llama_small", V, args.seed, "gpu")
    oracle = serving.ServingEngine(net, eos_id=-1, **TIER_REPLICA) \
        .generate(prompts, max_new_tokens=new)
    del net
    # the phase's engines are gone: give their cached blocks back to the
    # card before two more processes take memory there
    gc.collect()
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving.replica",
           "--model", "llama_small", "--vocab", str(V), "--seed",
           str(args.seed), "--eos", "-1"]
    for key, val in TIER_REPLICA.items():
        cmd += ["--" + key.replace("_", "-"), str(val)]
    workdir = tempfile.mkdtemp(prefix="mx_tier_router_")
    names = ("dispatched", "retries", "replica_deaths", "respawns")
    c0 = {m: tel.counter(f"mxnet_router_{m}_total").value for m in names}
    router = serving.Router(cmd, 2, workdir, hang_s=120.0,
                            env_extra={"MXNET_LOCKCHECK": "1"})
    killed, bursts = None, []
    try:
        t0 = time.perf_counter()
        router.start()
        if router.wait_up(timeout_s=180) != 2:
            raise AssertionError("tier router: replicas did not come up: "
                                 f"{router.replica_status()}")
        # a replica is "up" once its socket accepts, before its model is
        # built: wait for both engines, so a burst meets two decoders
        _tier_wait_running(router, workdir, 2, 180)
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # kill replica 0 once decoding has begun (a request answered)
        # while it still holds requests; when a burst ends with replica 0
        # empty before that could be seen, the next burst tries again
        for _ in range(TIER["router_bursts"]):
            hs = [router.submit(p, max_new_tokens=new) for p in prompts]
            bursts.append(hs)
            deadline = time.monotonic() + 120
            while killed is None and not all(h.ready() for h in hs):
                st = router.replica_status()[0]
                if st["state"] != "up":
                    raise AssertionError(
                        "tier router: replica 0 went down before the "
                        f"kill: {router.replica_status()}")
                if st["inflight"] > 0 and any(h.ready() for h in hs):
                    killed = st["pid"]
                    os.kill(killed, signal.SIGKILL)
                elif time.monotonic() > deadline:
                    raise AssertionError(
                        "tier router: a burst was not answered in 120 s: "
                        f"{router.replica_status()}")
                time.sleep(0.002)
            if killed is not None:
                break
        if killed is None:
            raise AssertionError(
                f"tier router: replica 0 held no request once decoding "
                f"had begun, in {len(bursts)} bursts")
        got = [[h.result(timeout=300) for h in hs] for hs in bursts]
        serve_s = time.perf_counter() - t0
        deadline = time.monotonic() + 30
        while tel.counter("mxnet_router_respawns_total").value \
                == c0["respawns"] and time.monotonic() < deadline:
            time.sleep(0.05)
        status = router.replica_status()
        # read before stop(): the router counts the end of a replica it
        # shuts down (its socket's EOF) as a death too
        delta = {m: tel.counter(f"mxnet_router_{m}_total").value - c0[m]
                 for m in names}
        order_errors = _tier_lock_order_errors(workdir)
    except AssertionError as exc:
        free, total = torch.cuda.mem_get_info()
        raise AssertionError(
            f"{exc}; card memory free {free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB; {_tier_replica_logs(workdir)}") \
            from None
    finally:
        router.stop()
        shutil.rmtree(workdir, ignore_errors=True)
    live = {p: i for p, i in _descendants().items() if i[1] != "Z"}
    for hs in got:
        if hs != oracle:
            bad = sum(a != b for a, b in zip(hs, oracle))
            raise AssertionError(f"tier router: {bad} of {n} answers "
                                 "differ from the in-process engine")
    if delta["replica_deaths"] < 1 or delta["respawns"] < 1 \
            or delta["retries"] < 1:
        raise AssertionError(f"tier router: counters {delta}")
    if live:
        raise AssertionError(f"tier router: processes left: {live}")
    if order_errors:
        raise AssertionError(f"tier router: a replica raised "
                             f"LockOrderError: {order_errors}")
    _log(f"tier router: 2 llama_small replicas (vocab {V}) up and built "
         f"in {up_s:.1f} s; {len(bursts)} burst(s) of {n} requests x "
         f"{new} tokens answered in "
         f"{serve_s:.2f} s with replica 0 (pid {killed}) SIGKILLed while "
         f"decoding; all equal to the in-process engine; counters "
         f"{delta}; replicas {[(s['state'], s['respawns']) for s in status]}"
         f"; no process left ({smi})")


def _tier_lock_order_errors(workdir):
    """The replicas' log lines naming a LockOrderError."""
    logs = os.path.join(workdir, "logs")
    found = []
    for fn in sorted(os.listdir(logs)) if os.path.isdir(logs) else ():
        with open(os.path.join(logs, fn), errors="replace") as f:
            found += [f"{fn}: {ln.strip()}" for ln in f
                      if "LockOrderError" in ln]
    return found


def tier_phase(torch, fa, mx, llama, serving, net, args, smi):
    """The rest of serving on the card (see the module docstring, phase
    7): the prefix cache and speculative decoding at llama3_8b width, the
    MT adapter on transformer_base, and the router tier with a replica
    killed; then the SLO histograms of the in-process engines.  The lock
    order checker is armed throughout (``MXNET_LOCKCHECK=1`` in this
    process, the router's, and in both replicas)."""
    tmx = mx["pkg"]
    tel = tmx.telemetry
    an = tmx.analysis
    tel.REGISTRY.reset()
    _reset_counts(fa)
    an.arm_lockcheck(True)
    an.lockcheck_reset()
    try:
        prompts, plain = _tier_prefix(torch, fa, tmx, serving, net, args,
                                      smi)
        _tier_spec(torch, fa, tmx, llama, serving, net, prompts, plain,
                   args, smi)
        _tier_mt(torch, fa, tmx, serving, args, smi)
        counts = _counts(fa)
        ttft = _hist_quantiles(
            tel.REGISTRY.get("mxnet_serving_ttft_seconds"))
        tpot = _hist_quantiles(
            tel.REGISTRY.get("mxnet_serving_tpot_seconds"))
        _log(f"tier slo: in-process engines of the phase, histogram bucket "
             f"bounds: TTFT p50 <= {ttft[0]} s, p99 <= {ttft[1]} s; TPOT "
             f"p50 <= {tpot[0]} s, p99 <= {tpot[1]} s ({smi})")
        _tier_router(torch, tmx, serving, args, smi)
        edges = an.lockcheck_edges()
    finally:
        an.arm_lockcheck(None)
        an.lockcheck_reset()
    _log(f"tier lockcheck: MXNET_LOCKCHECK=1 in this process and both "
         f"replicas, no LockOrderError; {len(edges)} acquisition edge(s) "
         f"recorded here: {sorted(edges)}")
    return counts


TRAIN_TOL = 1e-4       # relative, per-step losses card vs CPU (f32)


def _bert_loss(ops_nn):
    def loss_fn(out, labels):
        logits = out[2]
        return ops_nn.softmax_cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            labels.reshape(-1)) / labels.numel()
    return loss_fn


def _llama_loss(ops_nn):
    def loss_fn(out, labels):
        return ops_nn.softmax_cross_entropy(
            out.reshape(-1, out.shape[-1]).float(),
            labels.reshape(-1)) / labels.numel()
    return loss_fn


_COUNTERS = {"flash_fwd": "launches",
             "flash_bwd_fused": "bwd_fused_launches",
             "flash_bwd_dq": "bwd_dq_launches",
             "flash_bwd_dkv": "bwd_dkv_launches",
             "flash_fwd_wide_bf16": "fwd_wide_bf16_launches",
             "flash_bwd_fused_wide_bf16": "bwd_fused_wide_bf16_launches",
             "flash_bwd_dq_wide_bf16": "bwd_dq_wide_bf16_launches",
             "flash_bwd_dkv_wide_bf16": "bwd_dkv_wide_bf16_launches",
             "flash_fwd_f32": "fwd_f32_launches",
             "flash_bwd_fused_f32": "bwd_fused_f32_launches",
             "flash_bwd_dq_f32": "bwd_dq_f32_launches",
             "flash_bwd_dkv_f32": "bwd_dkv_f32_launches"}


def _counts(fa):
    return {k: getattr(fa, attr) for k, attr in _COUNTERS.items()}


def _dtype_count(counts, kind, f32):
    """Launches of backward entry point ``kind`` in f32 (``f32``) or in
    bf16 (all launches less the f32 ones; the phases run no other
    dtype)."""
    n_f32 = counts[f"flash_bwd_{kind}_f32"]
    return n_f32 if f32 else counts[f"flash_bwd_{kind}"] - n_f32


def _reset_counts(fa):
    for attr in _COUNTERS.values():
        setattr(fa, attr, 0)


TRAIN_ORACLE_STEPS = 6     # step 1 warms up, step 2 captures; 2-6 replay


def _oracle_adam(mx):
    """Adam whose rate falls every step (FactorScheduler 0.8): a captured
    step that froze its rate would show it."""
    return mx["optimizer"].Adam(
        learning_rate=1e-3, lr_scheduler=mx["pkg"].lr_scheduler
        .FactorScheduler(step=1, factor=0.8))


def train_oracle_phase(torch, fa, mx):
    """A small model trains TRAIN_ORACLE_STEPS steps on the card (TrainStep
    captured: one warm-up, then replays) and on the CPU (plain versions,
    eager) from the same weights and batches, f32, under a rate that falls
    every step: per-step losses agree to TRAIN_TOL, and every step
    launches its layers' kernels (the replays' counts included).
    bert_3_128_2 at seq 512 runs the fused backward, llama_small at seq
    1024 (causal) the dq + dkv pair.  Then, on the card: dropout 0.1 under
    replays at lr 0 draws new masks (two replays on one batch give
    different losses); after ``load_parameters`` between two steps the
    next (replayed) step's loss equals a fresh TrainStep's on the same
    weights; a net whose forward reads a value to the host raises
    MXNetError at capture, and the card works on after it."""
    import copy
    bert, llama, tmx = mx["bert"], mx["llama"], mx["pkg"]
    S = TRAIN_ORACLE_STEPS
    cases = [
        ("bert_3_128_2 seq 512", lambda: bert.bert_model(
            "bert_3_128_2", vocab_size=1000, max_length=512, dropout=0.0,
            device="cpu", generator=torch.Generator().manual_seed(11)),
         _bert_loss(mx["nn"]), 4, 512, "flash_bwd_fused", 3),
        ("llama_small seq 1024", lambda: _llama_net(
            tmx, llama, "llama_small", 1000, tmx.cpu(), 11),
         _llama_loss(mx["nn"]), 2, 1024, "flash_bwd_dq", 4),
    ]
    for label, build, loss_fn, B, L, kernel, layers in cases:
        cpu_net = build()
        card_net = copy.deepcopy(cpu_net).to("cuda")
        rng = np.random.RandomState(12)
        toks = rng.randint(0, 1000, (S, B, L))
        labs = rng.randint(0, 1000, (S, B, L))
        losses = []
        _reset_counts(fa)
        for net in (card_net, cpu_net):
            opt = _oracle_adam(mx)
            step = mx["parallel"].TrainStep(net, loss_fn, opt)
            losses.append(step.run(toks, labs).cpu().numpy())
            if net is card_net:
                counts = _counts(fa)
        rates = [opt.lr_scheduler(n) for n in range(1, S + 1)]
        rel = float(np.max(np.abs(losses[0] - losses[1])
                           / np.abs(losses[1])))
        _log(f"oracle train {label}: {S} steps (card: 1 eager, {S - 1} "
             f"replayed), rates {[round(r, 6) for r in rates]}; card "
             f"{losses[0].tolist()} cpu {losses[1].tolist()} rel {rel:.2e} "
             f"(tol {TRAIN_TOL}); launches {counts}")
        if not rel <= TRAIN_TOL or counts[kernel] < layers * S:
            raise AssertionError(f"train oracle {label} failed: rel {rel}, "
                                 f"launches {counts}")
    _capture_checks(torch, tmx, mx)


def _capture_checks(torch, tmx, mx):
    """The captured step's dropout, reload and host-read checks (see
    train_oracle_phase)."""
    bert = mx["bert"]
    loss_fn = _bert_loss(mx["nn"])
    rng = np.random.RandomState(13)
    toks = torch.tensor(rng.randint(0, 1000, (4, 512)), device="cuda")
    labs = torch.tensor(rng.randint(0, 1000, (4, 512)), device="cuda")

    def small(dropout, seed):
        return bert.bert_model(
            "bert_3_128_2", vocab_size=1000, max_length=512, dropout=dropout,
            device="cuda", generator=torch.Generator("cuda").manual_seed(seed))

    # dropout 0.1 at lr 0: the weights stay, only the masks move
    step = mx["parallel"].TrainStep(small(0.1, 14), loss_fn,
                                    mx["optimizer"].Adam(learning_rate=0.0))
    drop = [float(step(toks, labs)) for _ in range(4)]
    _log(f"capture dropout 0.1, lr 0, one batch: losses {drop} (steps 2-4 "
         f"replayed)")
    if len(set(drop[1:])) != 3:
        raise AssertionError(f"replays reuse one dropout mask: {drop}")

    # load_parameters between two steps: the replay reads the loaded values
    net = small(0.0, 15)
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "start.params")
        net.save_parameters(fname)
        step = mx["parallel"].TrainStep(net, loss_fn, _oracle_adam(mx))
        trained = [float(step(toks, labs)) for _ in range(3)]
        net.load_parameters(fname, ctx=tmx.gpu())
        replayed = float(step(toks, labs))
        net.load_parameters(fname, ctx=tmx.gpu())
        fresh = float(mx["parallel"].TrainStep(net, loss_fn,
                                               _oracle_adam(mx))(toks, labs))
    rel = abs(replayed - fresh) / abs(fresh)
    _log(f"capture load_parameters: losses {trained}, then after loading "
         f"the start weights {replayed} (replayed) vs a fresh TrainStep's "
         f"{fresh} on them: rel {rel:.2e} (tol {TRAIN_TOL})")
    if not (rel <= TRAIN_TOL and replayed == trained[0]
            and replayed != trained[-1]):
        raise AssertionError("the replay after load_parameters does not "
                             "read the loaded weights")

    class HostRead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(8, 8)

        def forward(self, x):
            y = self.lin(x)
            return y / float(y.abs().max())          # a read to the host

    step = mx["parallel"].TrainStep(HostRead().cuda(), lambda o, l: (
        (o - l) ** 2).mean(), "sgd")
    x = torch.randn(4, 8, device="cuda")
    step(x, x)                                       # eager warm-up: runs
    _fresh_peak(torch)
    reserved = torch.cuda.memory_reserved()
    try:
        step(x, x)
    except tmx.MXNetError as e:
        _log(f"capture host read: MXNetError: {str(e)[:400]}")
    else:
        raise AssertionError("a forward that reads to the host was "
                             "captured without an error")
    step = None
    ok = float(torch.ones(1024, device="cuda").sum())
    after = mx["parallel"].TrainStep(small(0.0, 16), loss_fn, "adam")
    after_losses = [float(after(toks, labs)) for _ in range(3)]
    after = None
    _fresh_peak(torch)
    grown = (torch.cuda.memory_reserved() - reserved) / 2**20
    _log(f"capture host read: the card works on ({ok}); a new TrainStep "
         f"{after_losses}; reserved memory grew {grown:.1f} MiB over both")
    if ok != 1024.0 or not all(np.isfinite(after_losses)) or grown > 1024:
        raise AssertionError("the card does not work after a failed capture "
                             "(or its memory leaks)")


def _profiled(torch, fn, host_ops=False, warmup=False):
    """Run fn once under torch.profiler: (wall ms to the end of its device
    work, [(device ms, count, kernel name)] largest first), and with
    ``host_ops`` also {host op name: calls}.  With ``warmup`` fn runs once
    before, traced but not counted (CUPTI can miss kernels right after a
    trace starts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warmup else None) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if warmup:
            prof.step()
    rows, ops = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("ProfilerStep"):
            continue            # the warm-up schedule's step span
        if ev.device_type != DeviceType.CUDA:
            # host ops: their kernels are listed apart
            ops[ev.key] = ops.get(ev.key, 0) + ev.count
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    return (wall, rows, ops) if host_ops else (wall, rows)


def _device_ms(torch, fn, iters=20):
    """(device time per call of fn, names of the kernels it ran, cut to 100
    characters): the sum of its kernels' times in one torch.profiler window
    of ``iters`` calls, after a warm-up."""
    for _ in range(3):
        fn()

    def window():
        for _ in range(iters):
            fn()

    _, rows = _profiled(torch, window)
    return (sum(r[0] for r in rows) / iters,
            sorted({r[2][:100] for r in rows}))


# kernel families of a profiled step: the first family one of whose words
# is in the kernel's name, else "other"
_GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet")
FLASH_FAMILIES = (("flash_fwd", ("flash_fwd",)), ("flash_bwd", ("flash_bwd",)),
                  ("gemm", _GEMM_WORDS))
VISION_FAMILIES = (
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "winograd",
                     "implicit", "precomputed")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("pooling", ("pool",)),
    ("gemm", _GEMM_WORDS),
    ("optimizer", ("foreach", "multi_tensor")))


def _profile_step(torch, step_fn, label, families=FLASH_FAMILIES, steps=1):
    """Device time of one step by kernel family (torch.profiler), against
    the step's wall time; prints the top kernels.  ``step_fn`` may run
    ``steps`` steps: times are then per step, averaged over them."""
    wall, rows = _profiled(torch, step_fn)
    wall /= steps
    rows = [(ms / steps, n, key) for ms, n, key in rows]
    total = sum(r[0] for r in rows)
    fams = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    for ms, _, key in rows:
        k = key.lower()
        fam = next((f for f, words in families
                    if any(w in k for w in words)), "other")
        fams[fam] += ms
    _log(f"profile {label}: one step wall {wall:.1f} ms"
         + (f" (mean of {steps})" if steps > 1 else "")
         + f", device busy {total:.1f} ms (idle share "
         f"{max(0.0, 1 - total / wall):.3f}); "
         + ", ".join(f"{k} {v:.1f} ms" for k, v in fams.items()))
    for ms, n, key in rows[:12]:
        _log(f"profile {label}:   {ms:9.3f} ms  x{n:<4d} {key[:100]}")
    return {"wall_ms": wall, "device_ms": total, "families": fams,
            "kernels": [r[2] for r in rows],
            "launches": sum(r[1] for r in rows) / steps}


# bench.py's training lanes (:529-535) and the dtype each runs in; the f32
# lanes are the same lanes under MXNET_BENCH_DTYPE=float32 (bench.py:392),
# with plain f32 Adam as bench.py takes it there (multi_precision only for
# bf16)
TRAIN_LANES = (("bert_seq512", "bfloat16"), ("llama_seq2048", "bfloat16"),
               ("bert_seq512_f32", "float32"),
               ("llama_seq2048_f32", "float32"))


BF16_LOSS_TOL = 1e-2   # relative, per-step losses of two bf16 runs


def _lane_model(torch, mx, lane, dtype, seed, remat=False):
    """(the lane's Gluon model, its loss, flops a token, layers, B, L,
    vocab): weights Normal(0.02) drawn on the card in ``dtype`` from
    ``seed``, so two builds are equal."""
    bert, llama, tmx = mx["bert"], mx["llama"], mx["pkg"]
    if lane.startswith("bert_seq512"):
        layers, units, B, L, vocab = 12, 768, 32, 512, 30522
        net = bert.bert_model(
            "bert_12_768_12", vocab_size=vocab, max_length=L, dropout=0.0,
            dtype=dtype, generator=torch.Generator(device="cuda")
            .manual_seed(seed))
        n_matmul = sum(p.numel() for n, p in net.named_parameters()
                       if "word_embed" not in n and "position" not in n)
        return (net, _bert_loss(mx["nn"]),
                6 * n_matmul + 12 * layers * units * L, layers, B, L, vocab)
    layers, units, B, L, vocab = 8, 2048, 4, 2048, 8192
    net = llama.LlamaModel(vocab_size=vocab, num_layers=layers, units=units,
                           hidden=5504, heads=16, kv_heads=8, prefix="llm_",
                           remat=remat)
    if dtype != torch.float32:
        net.cast(dtype)         # before initialize: drawn in bf16
    tmx.random.seed(seed)
    net.initialize(_llama_init(tmx, 0.02), ctx=tmx.gpu())
    n_matmul = sum(p.numel() for n, p in net.named_parameters()
                   if not n.startswith("embed"))
    return (net, _llama_loss(mx["nn"]),
            6 * n_matmul + 6 * layers * units * L, layers, B, L, vocab)


GATE_REPLAYS = 4       # replays in a lane's perf-gate window


def _gate_record(torch, fa, tmx, step, toks, labs, lane, dname, want):
    """The perf gate's record of a captured step's replays
    (``telemetry.perfgate``'s ``_steady_capture`` and ``_finish_record``):
    the cost ledger armed, one analysed call, then GATE_REPLAYS replays
    under ``no_retrace()``.  Each replay must be one armed dispatch, build
    nothing, and launch ``want`` (kernel -> launches a step)."""
    from mxnet_tpu_torch.telemetry import perfgate as pg
    tel = tmx.telemetry
    tel.costmodel.arm()
    tel.clear()
    try:
        step(toks, labs)                    # the ledger analyses this call
        torch.cuda.synchronize()
        before = _counts(fa)
        with tmx.analysis.no_retrace():
            steady = pg._steady_capture(lambda: step(toks, labs),
                                        iters=GATE_REPLAYS)
        torch.cuda.synchronize()
        rec = pg._finish_record({"lane": lane}, "parallel.TrainStep", steady,
                                dtype=dname)
    finally:
        tel.costmodel.disarm()
        tel.clear()
    got = {k: (_counts(fa)[k] - before[k]) / GATE_REPLAYS for k in want}
    _log(f"lane {lane} gate record: metrics {rec['metrics']}; observed "
         f"{rec['observed']}; flash launches a replay {got}")
    m = rec["metrics"]
    if m["dispatches_per_step"] != 1.0 or m["retraces_steady"] != 0 \
            or m["executables"] != 1 or got != want:
        raise AssertionError(f"{lane}: gate record {m}, launches a replay "
                             f"{got}, want {want}")
    return rec


def _timed_steps(torch, step, toks, labs, steps):
    """``steps`` TrainStep calls, each drained: (losses, wall ms)."""
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(step(toks, labs))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    return [float(x) for x in losses], step_ms


def _fresh_peak(torch):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _eager_gluon(torch, tmx, lane, net, toks, labs, f32, steps=4):
    """The lane's model through the eager Gluon loop (hybridized, record,
    SoftmaxCELoss, backward, Trainer("adam").step): median ms of steps
    2-``steps``, peak memory and one profiled step's idle share."""
    for p in net.collect_params().values():
        p.data()._data.grad = None
    _fresh_peak(torch)
    net.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam", {
        "learning_rate": 1e-4, "multi_precision": not f32})
    inputs, labels = _gluon_inputs(tmx, tmx.gpu(), toks, labs)
    head = (lambda out: out[2]) if lane.startswith("bert") \
        else (lambda out: out)
    losses, ms = _gluon_steps(tmx, net, inputs, labels, steps, trainer, head)
    prof = _profile_step(torch, lambda: _gluon_steps(
        tmx, net, inputs, labels, 1, trainer, head), lane + " eager Gluon")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{lane} eager Gluon loop: losses {losses}")
    return {"step_ms": statistics.median(ms[1:]), "peak_gib": peak,
            "idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])}


def _packed(torch, net):
    """``net`` (the BERT) called on (B, L + 1) int tokens whose last column
    is each row's valid length: the length enters the captured step as
    data, where a Python attribute would be frozen at capture."""
    class Packed(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x[:, :-1], x[:, -1])
    return Packed()


def train_lane_phase(torch, fa, mx, args):
    """bench.py's training lanes at full width on the card through the
    captured ``TrainStep``: weights Normal(0.02) from a seeded generator
    on the card in the lane's dtype, Adam at lr 1e-4 (multi_precision for
    bf16, plain for f32), dropout 0; 8 steps on one repeated batch (one
    eager warm-up, then the capture and replays).  The loss must be finite
    and fall; each step (a replay's counts are its capture's) must launch
    the forward and the backward kernels per layer, in the lane's dtype
    and on its route (bf16: tensor cores only; f32: no bf16 launch);
    prints median step ms of the replays, samples/s, MFU (bench.py's flop
    formulas against the dtype's peak), peak memory and idle share, beside
    the same model's eager Gluon loop.  The BERT lanes also take padded
    steps whose lengths ride in the batch (``_packed``); the bf16 BERT lane
    runs again at n_micro=4 (losses within BF16_LOSS_TOL of n_micro=1);
    the f32 llama lane again with remat per decoder block (losses within
    TRAIN_TOL, less peak memory)."""
    tmx = mx["pkg"]
    results = {}
    counts_total = {k: 0 for k in _counts(fa)}
    steps = 8
    for lane, dname in TRAIN_LANES:
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dname]
        f32 = dname == "float32"
        # earlier phases' models (llama3_8b's 32 GB) may sit in reference
        # cycles until a collection: free them before measuring the peak
        _fresh_peak(torch)
        _log(f"lane {lane}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
             f"allocated before the model is built")
        t0 = time.perf_counter()
        sfx = "_f32" if f32 else ""
        net, loss_fn, flops_tok, layers, B, L, vocab = _lane_model(
            torch, mx, lane, dtype, args.seed)
        if lane.startswith("bert"):
            want = {"flash_fwd" + sfx: layers, "flash_bwd_fused" + sfx: layers}
        else:
            want = {"flash_fwd" + sfx: layers, "flash_bwd_dq" + sfx: layers,
                    "flash_bwd_dkv" + sfx: layers}
        if {p.dtype for p in net.parameters()} != {dtype}:
            raise AssertionError(f"{lane}: weights are not all {dname}")
        n_params = sum(p.numel() for p in net.parameters())
        opt = mx["optimizer"].Adam(learning_rate=1e-4, multi_precision=not f32)
        step = mx["parallel"].TrainStep(net, loss_fn, opt)
        rng = np.random.RandomState(args.seed)
        toks_np = rng.randint(0, vocab, (B, L))
        labs_np = rng.randint(0, vocab, (B, L))
        toks = torch.tensor(toks_np, device="cuda")
        labs = torch.tensor(labs_np, device="cuda")
        torch.cuda.synchronize()
        _log(f"lane {lane}: {n_params} params, {dname}, built in "
             f"{time.perf_counter() - t0:.1f} s")
        _reset_counts(fa)
        # an eager call, then the capture; the replays build nothing
        losses, step_ms = _timed_steps(torch, step, toks, labs, 2)
        with tmx.analysis.no_retrace():
            more, more_ms = _timed_steps(torch, step, toks, labs, steps - 2)
        losses, step_ms = losses + more, step_ms + more_ms
        counts = _counts(fa)
        prof = _profile_step(torch, lambda: step(toks, labs), lane)
        peak = torch.cuda.max_memory_allocated()
        # after the peak and the profile: the gate's analysed call runs
        # eagerly beside the captured graph's pool
        _gate_record(torch, fa, tmx, step, toks, labs, lane, dname, want)
        extra = {}
        if lane.startswith("bert_seq512"):
            extra = _padded_steps(torch, fa, mx, net, loss_fn, toks, labs,
                                  layers, f32, rng)
        med = statistics.median(step_ms[2:])
        sps = B / (med / 1e3)
        mfu = sps * L * flops_tok / PEAK_FLOPS[dname]
        for k in counts_total:
            counts_total[k] += counts[k]
        _log(f"lane {lane}: losses {[round(x, 5) for x in losses]}; step ms "
             f"{[round(x, 1) for x in step_ms]} (1 eager, then captured); "
             f"median (steps 3-{steps}) {med:.2f} ms, {sps:.2f} samples/s, "
             f"MFU {mfu:.4f} ({PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s "
             f"{dname}), peak memory {peak / 2**30:.2f} GiB; launches over "
             f"{steps} steps {counts} {extra}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{lane}: losses not finite and falling: "
                                 f"{losses}")
        for k, per_step in want.items():
            if counts[k] < per_step * steps:
                raise AssertionError(f"{lane}: {k} launched {counts[k]} "
                                     f"times in {steps} steps of {layers} "
                                     f"layers")
        wide = sum(n for k, n in counts.items() if k.endswith("_wide_bf16"))
        if wide:
            raise AssertionError(f"{lane}: {wide} bf16 launches ran on the "
                                 f"CUDA-core route for wide heads")
        # every launch in the lane's dtype: the f32 counters count all of
        # them in an f32 lane and none in a bf16 lane
        for kernel in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                       "flash_bwd_dkv"):
            n, n32 = counts[kernel], counts[kernel + "_f32"]
            if n32 != (n if f32 else 0):
                raise AssertionError(f"{lane}: {n - n32} bf16 and {n32} f32 "
                                     f"{kernel} launches in a {dname} lane")
        results[lane] = {"step_ms": med, "samples_per_s": sps, "mfu": mfu,
                         "peak_gib": peak / 2**30, "profile": prof,
                         "idle_share": max(0.0, 1 - prof["device_ms"]
                                           / prof["wall_ms"])}
        step = opt = None
        eager = _eager_gluon(torch, tmx, lane, net, toks_np, labs_np, f32)
        results[lane]["eager"] = eager
        _log(f"lane {lane}: captured TrainStep {med:.2f} ms a step, idle "
             f"share {results[lane]['idle_share']:.3f}, peak "
             f"{peak / 2**30:.2f} GiB; eager Gluon loop "
             f"{eager['step_ms']:.2f} ms, idle share "
             f"{eager['idle_share']:.3f}, peak {eager['peak_gib']:.2f} GiB")
        net = None
        if lane == "bert_seq512":
            results[lane]["n_micro"] = _n_micro_run(
                torch, mx, lane, dtype, args.seed, toks, labs, losses,
                peak / 2**30, steps)
        elif lane == "llama_seq2048_f32":
            results[lane]["remat"] = _remat_run(
                torch, fa, mx, lane, dtype, args.seed, toks, labs, losses,
                peak / 2**30, med, steps, layers)
    return counts_total, results


def _padded_steps(torch, fa, mx, net, loss_fn, toks, labs, layers, f32,
                  rng):
    """BERT steps on padded batches, the lengths packed into the batch as
    its last column, at lr 0 so the weights stay: the replay with lengths
    A equals the eager warm-up with A, and lengths B give another loss.
    Every step launches the lane's fused backward per layer."""
    B, L = toks.shape
    lens_a = torch.tensor(rng.randint(L // 2, L + 1, B), device="cuda")
    lens_b = torch.tensor(rng.randint(L // 2, L + 1, B), device="cuda")
    step = mx["parallel"].TrainStep(
        _packed(torch, net), loss_fn, mx["optimizer"].Adam(
            learning_rate=0.0, multi_precision=not f32))
    before = fa.bwd_fused_launches
    got = [float(step(torch.cat([toks, lens[:, None]], 1), labs))
           for lens in (lens_a, lens_a, lens_b)]
    fused = fa.bwd_fused_launches - before
    rel = abs(got[1] - got[0]) / abs(got[0])
    if not (np.isfinite(got).all() and rel <= TRAIN_TOL
            and got[2] != got[1] and fused >= 3 * layers):
        raise AssertionError(f"padded BERT steps: losses {got}, rel {rel}, "
                             f"fused launches {fused}")
    return {"padded_losses": got, "padded_rel": rel, "padded_fused": fused}


def _n_micro_run(torch, mx, lane, dtype, seed, toks, labs, want, peak,
                 steps):
    """The lane again from the same weights at n_micro=4: per-step losses
    within BF16_LOSS_TOL of n_micro=1's ``want``; peak memory of each."""
    _fresh_peak(torch)
    net, loss_fn = _lane_model(torch, mx, lane, dtype, seed)[:2]
    step = mx["parallel"].TrainStep(
        net, loss_fn, mx["optimizer"].Adam(learning_rate=1e-4,
                                           multi_precision=True), n_micro=4)
    losses, ms = _timed_steps(torch, step, toks, labs, steps)
    peak4 = torch.cuda.max_memory_allocated() / 2**30
    rel = _rel(losses, want)
    med = statistics.median(ms[2:])
    _log(f"lane {lane} n_micro=4: losses {[round(x, 5) for x in losses]} "
         f"rel {rel:.2e} to n_micro=1 (tol {BF16_LOSS_TOL}); step {med:.2f} "
         f"ms; peak memory n_micro=1 {peak:.2f} GiB, n_micro=4 {peak4:.2f} "
         f"GiB")
    if not rel <= BF16_LOSS_TOL:
        raise AssertionError(f"{lane}: n_micro=4 losses {losses} vs {want}")
    return {"rel": rel, "step_ms": med, "peak_gib": peak4}


def _remat_run(torch, fa, mx, lane, dtype, seed, toks, labs, want, peak,
               plain_ms, steps, layers):
    """The lane again from the same weights with remat per decoder block:
    per-step losses within TRAIN_TOL of the plain run's ``want``, less
    peak memory; the forward kernel runs twice a layer (the recompute)."""
    _fresh_peak(torch)
    net, loss_fn = _lane_model(torch, mx, lane, dtype, seed, remat=True)[:2]
    step = mx["parallel"].TrainStep(
        net, loss_fn, mx["optimizer"].Adam(learning_rate=1e-4))
    _reset_counts(fa)
    losses, ms = _timed_steps(torch, step, toks, labs, steps)
    counts = _counts(fa)
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    rel = _rel(losses, want)
    med = statistics.median(ms[2:])
    _log(f"lane {lane} remat: losses {[round(x, 5) for x in losses]} rel "
         f"{rel:.2e} (tol {TRAIN_TOL}); step {med:.2f} ms (plain "
         f"{plain_ms:.2f}); peak memory {peak_r:.2f} GiB (plain {peak:.2f}); "
         f"launches {counts}")
    if not (rel <= TRAIN_TOL and peak_r < peak
            and counts["flash_fwd_f32"] >= 2 * layers * steps):
        raise AssertionError(f"{lane} remat: rel {rel}, peak {peak_r} vs "
                             f"{peak}, launches {counts}")
    return {"rel": rel, "step_ms": med, "peak_gib": peak_r}


def _gluon_inputs(tmx, ctx, toks, labs, vl=None):
    """The batch as NDArrays on ``ctx``: (net inputs, labels)."""
    x = [tmx.nd.array(toks, ctx=ctx)]
    if vl is not None:
        x.append(tmx.nd.array(vl, ctx=ctx))
    return x, tmx.nd.array(labs, ctx=ctx)


def _gluon_steps(tmx, net, inputs, labels, steps, trainer, head=None):
    """``steps`` iterations of MXNet's canonical loop on one batch:
    record, SoftmaxCELoss on the f32 logits (``head(out)``; without
    ``head`` the BERT's MLM logits ``out[2]``), backward, Trainer.step(B).  Returns the per-step losses (the per-token
    mean) and wall ms."""
    loss_fn = tmx.gluon.loss.SoftmaxCELoss()
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        with tmx.autograd.record():
            out = net(*inputs)
            logits = (out[2] if head is None else head(out)) \
                .astype("float32", copy=False)
            loss = loss_fn(logits, labels)
        loss.backward()
        trainer.step(labels.shape[0])
        losses.append(loss.mean())
        tmx.nd.waitall()
        step_ms.append((time.perf_counter() - t) * 1e3)
    return [float(l.asscalar()) for l in losses], step_ms


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                        / np.abs(np.asarray(b))))


def gluon_oracle(torch, fa, tmx):
    """(a) bert_3_128_2 built once on the CPU, carried to the card by its
    collect_params() names; 3 hybridized Gluon steps on a padded batch on
    both devices: per-step losses agree to TRAIN_TOL."""
    bert = tmx.gluon.model_zoo.bert
    nets = {}
    for ctx in (tmx.cpu(), tmx.gpu()):
        nets[ctx] = bert.BERTModel(vocab_size=1000, num_layers=3, units=128,
                                   hidden_size=512, num_heads=2,
                                   max_length=512, dropout=0.0,
                                   prefix="bert_")
    tmx.random.seed(21)
    nets[tmx.cpu()].initialize(tmx.init.Normal(0.02), ctx=tmx.cpu())
    nets[tmx.gpu()].initialize(tmx.init.Zero(), ctx=tmx.gpu())
    card = nets[tmx.gpu()].collect_params()
    for name, p in nets[tmx.cpu()].collect_params().items():
        card[name].set_data(p.data())
    rng = np.random.RandomState(22)
    B, L = 4, 512
    toks = rng.randint(0, 1000, (B, L))
    labs = rng.randint(0, 1000, (B, L))
    vl = rng.randint(L // 2, L + 1, B)
    losses = {}
    for ctx in (tmx.gpu(), tmx.cpu()):
        net = nets[ctx]
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                    {"learning_rate": 1e-3})
        inputs, labels = _gluon_inputs(tmx, ctx, toks, labs, vl)
        if ctx == tmx.gpu():
            _reset_counts(fa)
        losses[ctx], _ = _gluon_steps(tmx, net, inputs, labels, 3, trainer)
        if ctx == tmx.gpu():
            counts = _counts(fa)
    rel = _rel(losses[tmx.gpu()], losses[tmx.cpu()])
    _log(f"oracle gluon bert_3_128_2 seq 512 padded {vl.tolist()}: card "
         f"{losses[tmx.gpu()]} cpu {losses[tmx.cpu()]} rel {rel:.2e} (tol "
         f"{TRAIN_TOL}); launches {counts}")
    if not rel <= TRAIN_TOL or counts["flash_bwd_fused"] < 3:
        raise AssertionError(f"gluon oracle failed: rel {rel}, launches "
                             f"{counts}")


def _lane_numbers(torch, dname, step_ms, B, L, flops_tok, prof):
    med = statistics.median(step_ms[2:])
    sps = B / (med / 1e3)
    return {"step_ms": med, "samples_per_s": sps,
            "mfu": sps * L * flops_tok / PEAK_FLOPS[dname],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])}


def gluon_phase(torch, fa, mx, args, smi):
    """The Gluon loop over bert_12_768_12 (vocab 30522, batch 32, seq 512,
    dropout 0) on the card: (a) the oracle above; (b) f32 (MXNet's default
    dtype): initialize(Normal(0.02), ctx=gpu), hybridize, Trainer("adam",
    lr 1e-4), 8 steps on one batch; then the same weights and batch through
    parallel.TrainStep (losses agree to TRAIN_TOL), and 3 steps of the
    imperative NDArray path (no hybridize; losses agree with the first 3);
    (c) bf16 via net.cast("bfloat16") and multi_precision Adam, 8 steps,
    then TrainStep the same.  Each Gluon step must launch 12 flash_fwd and
    12 fused backward kernels of the lane's dtype and route and no dq or
    dkv; losses finite and falling.  Prints step ms, samples/s, MFU, peak
    memory and profiled idle share of the Gluon loop beside TrainStep's."""
    tmx = mx["pkg"]
    gluon_oracle(torch, fa, tmx)
    bert = tmx.gluon.model_zoo.bert
    layers, units, B, L, vocab, steps = 12, 768, 32, 512, 30522, 8
    gc.collect()
    torch.cuda.empty_cache()
    gpu = tmx.gpu()
    net = bert.BERTModel(vocab_size=vocab, num_layers=layers, units=units,
                         hidden_size=3072, num_heads=12, max_length=L,
                         dropout=0.0, prefix="bert_")
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Normal(0.02), ctx=gpu)
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    n_matmul = sum(p.numel() for n, p in net.named_parameters()
                   if "word_embed" not in n and "position" not in n)
    flops_tok = 6 * n_matmul + 12 * layers * units * L
    rng = np.random.RandomState(args.seed)
    toks = rng.randint(0, vocab, (B, L))
    labs = rng.randint(0, vocab, (B, L))
    loss_fn = _bert_loss(mx["nn"])
    inputs, labels = _gluon_inputs(tmx, gpu, toks, labs)
    results, gluon_counts = {}, {}

    def restart():
        """The start weights again; no gradient left from the last run."""
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        f32 = dname == "float32"
        sfx = "_f32" if f32 else ""
        lane = f"gluon_bert_seq512{sfx}"
        restart()
        net.hybridize()
        if not f32:
            net.cast("bfloat16")
        if {p.data()._data.dtype for p in params.values()} != {dtype}:
            raise AssertionError(f"{lane}: weights are not all {dname}")
        trainer = tmx.gluon.Trainer(params, "adam", {
            "learning_rate": 1e-4, "multi_precision": not f32})
        _reset_counts(fa)
        losses, step_ms = _gluon_steps(tmx, net, inputs, labels, steps,
                                       trainer)
        counts = _counts(fa)
        gluon_counts[dname] = counts

        prof = _profile_step(torch, lambda: _gluon_steps(
            tmx, net, inputs, labels, 1, trainer), lane)
        results[lane] = _lane_numbers(torch, dname, step_ms, B, L, flops_tok,
                                      prof)
        _log(f"lane {lane}: losses {[round(x, 5) for x in losses]}; step ms "
             f"{[round(x, 1) for x in step_ms]}; launches over {steps} steps "
             f"{counts}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{lane}: losses not finite and falling: "
                                 f"{losses}")
        want = {"flash_fwd": layers * steps, "flash_bwd_fused": layers * steps,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "flash_fwd_f32": layers * steps if f32 else 0,
                "flash_bwd_fused_f32": layers * steps if f32 else 0}
        wide = sum(n for k, n in counts.items() if k.endswith("_wide_bf16"))
        if any(counts[k] != n for k, n in want.items()) or wide:
            raise AssertionError(f"{lane}: launches {counts}, want {want} "
                                 f"and no wide bf16 launch")

        # the same weights and batch through parallel.TrainStep
        restart()
        opt = mx["optimizer"].Adam(learning_rate=1e-4, multi_precision=not f32)
        step = mx["parallel"].TrainStep(net, loss_fn, opt)
        tt, tl = torch.tensor(toks, device="cuda"), \
            torch.tensor(labs, device="cuda")
        ts_losses, ts_ms = [], []
        for _ in range(steps):
            t = time.perf_counter()
            ts_losses.append(step(tt, tl))
            torch.cuda.synchronize()
            ts_ms.append((time.perf_counter() - t) * 1e3)
        ts_losses = [float(x) for x in ts_losses]
        prof = _profile_step(torch, lambda: step(tt, tl), f"trainstep{sfx}")
        results[f"trainstep_bert_seq512{sfx}"] = _lane_numbers(
            torch, dname, ts_ms, B, L, flops_tok, prof)
        rel = _rel(losses, ts_losses)
        _log(f"lane {lane}: TrainStep on the same weights and batch, losses "
             f"{[round(x, 5) for x in ts_losses]} rel {rel:.2e}")
        if f32 and not rel <= TRAIN_TOL:
            raise AssertionError(f"{lane}: Gluon loop and TrainStep disagree "
                                 f"(rel {rel}, tol {TRAIN_TOL})")
        step = opt = None
        if f32:
            # the imperative NDArray path: no hybridize
            restart()
            net.hybridize(active=False)
            trainer = tmx.gluon.Trainer(params, "adam",
                                        {"learning_rate": 1e-4})
            _reset_counts(fa)
            imp, _ = _gluon_steps(tmx, net, inputs, labels, 3, trainer)
            counts = _counts(fa)
            rel = _rel(imp, losses[:3])
            _log(f"lane {lane}: imperative (not hybridized) losses "
                 f"{[round(x, 5) for x in imp]} rel {rel:.2e}; launches "
                 f"{counts}")
            if not rel <= TRAIN_TOL or counts["flash_bwd_fused_f32"] != 36:
                raise AssertionError(f"{lane}: imperative path: rel {rel}, "
                                     f"launches {counts}")
        trainer = None
    for lane, r in results.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['samples_per_s']:.2f} samples/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB, idle share {r['idle_share']:.3f} "
             f"({smi})")
    return gluon_counts, results


# transformer-base MT at full width (Vaswani et al.: 6 + 6 layers, 512,
# FFN 2048, 8 heads; vocabulary 32,768, transformer_model's default):
# batch 16 x 256 tokens a side, about 4,096, one GPU's share of the
# paper's 25k-token batches; Adam beta (0.9, 0.98), eps 1e-9, a linear
# warm-up; label smoothing 0.1; dropout 0.1 in the timed runs
MT = {"name": "transformer_base", "layers": 6, "units": 512,
      "hidden": 2048, "heads": 8, "vocab": 32768, "batch": 16, "len": 256,
      "min_len": 128, "steps": 20, "lr": 5e-4, "warmup": 5,
      "oracle_steps": 3, "decode_rows": 4, "decode_len": 64}
MT_PAD, MT_BOS, MT_EOS = 0, 1, 2


def _mt_batch(seed):
    """Source, target-in, labels (B, L) and source lengths: tokens from a
    Zipf law over the vocabulary (rank r drawn with weight 1 / (r + 10)),
    lengths in [min_len, len], padding 0 past them (labels too: the loss
    ignores index 0), the target shifted right behind BOS."""
    rng = np.random.RandomState(seed)
    B, L, V = MT["batch"], MT["len"], MT["vocab"]
    w = 1.0 / (np.arange(3, V) + 7.0)
    draw = lambda: rng.choice(np.arange(3, V), (B, L), p=w / w.sum())  # noqa: E731
    src, tgt = draw(), draw()
    src_len = rng.randint(MT["min_len"], L + 1, B)
    tgt_len = rng.randint(MT["min_len"], L + 1, B)
    pos = np.arange(L)[None, :]
    src = np.where(pos < src_len[:, None], src, MT_PAD)
    labels = np.where(pos < tgt_len[:, None], tgt, MT_PAD)
    tgt_in = np.concatenate([np.full((B, 1), MT_BOS), labels[:, :-1]], 1)
    return (src.astype(np.int32), tgt_in.astype(np.int32),
            labels.astype(np.int32), src_len.astype(np.int32))


def _mt_flops(B, L):
    """Forward FLOPs of one batch, counted from the layers: 2 in out a row
    of every Dense (the decoder's cross [k, v] projection runs on the
    memory's rows), the tied output projection, and 4 Lq Lk units a row
    of the batch for each attention (Q K^T and P V, causal counted
    whole)."""
    U, H, V, n = MT["units"], MT["hidden"], MT["vocab"], MT["layers"]
    rows = B * L
    dense = n * rows * 2 * (4 * U * U + 2 * U * H) \
        + n * rows * 2 * (6 * U * U + 2 * U * H) + rows * 2 * U * V
    attention = n * 3 * 4 * B * L * L * U
    return dense + attention


def mt_phase(torch, fa, mx, args, smi):
    """transformer_base (``gluon.model_zoo.transformer``) trained at full
    width on the card on the flash kernels (see MT): the reference's
    examples/transformer_mt flow, the Gluon loop (record, forward,
    LabelSmoothedCELoss(0.1, ignore_index=0), backward, Trainer("adam")
    .step(B)), MT["steps"] steps in f32, then as many in bf16 under
    ``amp.init("bfloat16")`` (turned off after), then as many through the
    captured ``TrainStep`` over a block that unpacks (source, target,
    source lengths) from one int tensor, in f32 and under amp; each run
    from the same weights.  The loss falls in each (the mean of the last 5 steps under
    the first 5); each step launches the flash forward 18 times (6 encoder
    self, 6 causal decoder self, 6 cross at Lq = Lk = 256) and the fused
    backward 18 times (both sides one 512 block), all in the run's dtype.
    With dropout 0, MT["oracle_steps"] steps of the Gluon loop and of the
    captured TrainStep agree to TRAIN_TOL.  ``greedy_decode`` of
    MT["decode_rows"] sentences at max_len MT["decode_len"] emits, at
    each position before a row's EOS, the argmax of the full forward over
    its own output.  Prints step ms, tokens/s (target tokens the loss
    counts), MFU, peak memory, idle share (1 - a profiled step's device ms
    over the unprofiled median) and device ms by family."""
    tmx = mx["pkg"]
    tr = tmx.gluon.model_zoo.transformer
    gpu = tmx.gpu()
    B, L, steps = MT["batch"], MT["len"], MT["steps"]
    src, tgt_in, labels, src_len = _mt_batch(args.seed)
    tokens = int((labels != MT_PAD).sum())
    flops = 3 * _mt_flops(B, L)
    _fresh_peak(torch)

    def build(dropout):
        return tr.transformer_model(MT["name"], vocab_size=MT["vocab"],
                                    dropout=dropout, prefix="mt_")

    net = build(0.1)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    net.hybridize()
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    loss_blk = tmx.gluon.loss.LabelSmoothedCELoss(smoothing=0.1,
                                                  ignore_index=MT_PAD)
    inputs = [tmx.nd.array(a, ctx=gpu, dtype="int32")
              for a in (src, tgt_in, src_len)]
    lab_nd = tmx.nd.array(labels, ctx=gpu, dtype="int32")

    def adam():
        sched = tmx.lr_scheduler.FactorScheduler(
            step=10 ** 9, base_lr=MT["lr"], warmup_steps=MT["warmup"],
            warmup_begin_lr=MT["lr"] / MT["warmup"])
        return mx["optimizer"].Adam(learning_rate=MT["lr"], beta1=0.9,
                                    beta2=0.98, epsilon=1e-9,
                                    lr_scheduler=sched)

    def restart(model=None):
        for k, p in (model or net).collect_params().items():
            p.set_data(start[k])
            p.data()._data.grad = None
        _fresh_peak(torch)

    def gluon_steps(model, n, trainer):
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            with tmx.autograd.record():
                loss = loss_blk(model(*inputs), lab_nd)
            loss.backward()
            trainer.step(B)
            losses.append(loss.mean())
            tmx.nd.waitall()
            ms.append((time.perf_counter() - t) * 1e3)
        return [float(x.asscalar()) for x in losses], ms

    class Packed(torch.nn.Module):
        """(B, 2 L + 1) int: source, target-in, the source's length."""

        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            return self.model(x[:, :L], x[:, L:2 * L], x[:, -1])

    packed = torch.tensor(np.concatenate([src, tgt_in, src_len[:, None]], 1),
                          device="cuda")
    lab_t = torch.tensor(labels, device="cuda")

    def trainstep(model, n):
        step = mx["parallel"].TrainStep(Packed(model), lambda o, l: loss_blk(
            o, l), adam())
        losses, ms = _timed_steps(torch, step, packed, lab_t, n)
        return losses, ms, step

    def check_run(label, losses, counts, n, f32):
        fwd = counts["flash_fwd"]
        fused = counts["flash_bwd_fused"]
        in_dtype = (counts["flash_fwd_f32"], counts["flash_bwd_fused_f32"]) \
            == ((fwd, fused) if f32 else (0, 0))
        falls = np.mean(losses[-5:]) < np.mean(losses[:5]) \
            and losses[-1] < losses[0]
        if not (all(np.isfinite(losses)) and falls and fwd == 18 * n
                and fused == 18 * n and in_dtype
                and counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 0):
            raise AssertionError(f"mt {label}: losses {losses}, launches "
                                 f"{counts}")

    results = {}

    def record(label, losses, ms, prof, counts):
        med = statistics.median(ms[2:])
        dname = "float32" if "f32" in label else "bfloat16"
        r = {"step_ms": med, "tokens_per_s": tokens / (med / 1e3),
             "mfu": flops / (med / 1e3) / PEAK_FLOPS[dname],
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "idle_share": max(0.0, 1 - prof["device_ms"] / med),
             "families": prof["families"]}
        results[label] = r
        _log(f"mt {label}: losses {[round(x, 4) for x in losses]}; step ms "
             f"{[round(x, 1) for x in ms]}; median (steps 3-{len(ms)}) "
             f"{med:.2f} ms, {r['tokens_per_s']:.0f} target tokens/s, MFU "
             f"{r['mfu']:.4f} ({PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s "
             f"{dname}), peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}; launches {counts}")

    counts_total = {k: 0 for k in _counts(fa)}

    def add(counts):
        for k in counts_total:
            counts_total[k] += counts[k]

    # (1) the Gluon loop in f32, (2) in bf16 under amp
    for label, amp in (("gluon_f32", False), ("gluon_bf16_amp", True)):
        restart()
        if amp:
            tmx.amp.init("bfloat16")
        try:
            trainer = tmx.gluon.Trainer(params, adam())
            _reset_counts(fa)
            losses, ms = gluon_steps(net, steps, trainer)
            counts = _counts(fa)
            prof = _profile_step(torch, lambda: gluon_steps(net, 1, trainer),
                                 f"mt {label}")
        finally:
            if amp:
                tmx.amp.off()
        add(counts)
        check_run(label, losses, counts, steps, not amp)
        record(label, losses, ms, prof, counts)
        trainer = None
    # (3) the captured TrainStep, f32, then bf16 under amp
    for label, amp in (("trainstep_f32", False), ("trainstep_bf16_amp", True)):
        restart()
        if amp:
            tmx.amp.init("bfloat16")
        try:
            _reset_counts(fa)
            losses, ms, step = trainstep(net, steps)
            counts = _counts(fa)
            prof = _profile_step(torch, lambda: step(packed, lab_t),
                                 f"mt {label}")
        finally:
            if amp:
                tmx.amp.off()
        add(counts)
        check_run(label, losses, counts, steps, not amp)
        record(label, losses, ms, prof, counts)
        step = None

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("amp.off() left TF32 on")
    # dropout 0: the Gluon loop and the captured TrainStep agree
    exact = build(0.0)
    exact.initialize(tmx.init.Zero(), ctx=gpu)
    exact.hybridize()
    restart(exact)
    want, _ = gluon_steps(exact, MT["oracle_steps"],
                          tmx.gluon.Trainer(exact.collect_params(), adam()))
    restart(exact)
    got = trainstep(exact, MT["oracle_steps"])[0]
    rel = _rel(got, want)
    _log(f"mt oracle, dropout 0: Gluon loop {want}, captured TrainStep "
         f"{got}: rel {rel:.2e} (tol {TRAIN_TOL})")
    if not rel <= TRAIN_TOL:
        raise AssertionError(f"mt: the Gluon loop and TrainStep disagree "
                             f"(rel {rel})")

    # greedy decode against the argmax of the full forward
    n = MT["decode_rows"]
    src_nd = tmx.nd.array(src[:n], ctx=gpu, dtype="int32")
    vl_nd = tmx.nd.array(src_len[:n], ctx=gpu, dtype="int32")
    t0 = time.perf_counter()
    out = tr.greedy_decode(exact, src_nd, MT_BOS, MT_EOS,
                           max_len=MT["decode_len"], src_valid_length=vl_nd)
    decode_s = time.perf_counter() - t0
    buf = np.full((n, MT["decode_len"]), MT_EOS, np.int32)
    buf[:, :out.shape[1]] = out
    full = exact(src_nd, tmx.nd.array(buf, ctx=gpu, dtype="int32"),
                 vl_nd).asnumpy().argmax(-1)
    bad = 0
    for b in range(n):
        eos = np.nonzero(out[b, 1:] == MT_EOS)[0]
        end = eos[0] + 1 if len(eos) else out.shape[1] - 1
        bad += int((full[b, :end] != out[b, 1:end + 1]).sum())
    _log(f"mt greedy_decode: {n} sentences, max_len {MT['decode_len']}, "
         f"{out.shape[1]} tokens in {decode_s:.2f} s; positions that differ "
         f"from the full forward's argmax: {bad}")
    if bad:
        raise AssertionError(f"mt greedy_decode differs from the full "
                             f"forward's argmax at {bad} positions")
    for label, r in results.items():
        _log(f"train mt {label}: step {r['step_ms']:.2f} ms, "
             f"{r['tokens_per_s']:.0f} tokens/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB, idle share {r['idle_share']:.3f}, "
             f"device ms " + ", ".join(f"{k} {v:.1f}" for k, v in
                                       r["families"].items()) + f" ({smi})")
    return counts_total, results


VISION_BATCH, VISION_SIZE = 64, 224   # bench.py:545-547
# bench.py:158-159 takes SGD lr 0.1, momentum 0.9 at batch 64 to time the
# step; from Xavier weights that rate does not train: one 64-image batch's
# loss went 7.82 -> 5.29 -> 9.66 over 8 steps on an H100.  The phase takes
# the reference recipe's 0.1 per 256 images, scaled to the batch: 0.025
VISION_SGD = {"learning_rate": 0.1 * VISION_BATCH / 256, "momentum": 0.9}
VISION_OP_TOL = 1e-5    # card vs CPU per op, f32: max |err| / max |ref|
VISION_NET_TOL = 1e-4   # card vs CPU small ResNet: outputs, loss, statistics


def _rel_err(torch, got, ref):
    """max |got - ref| / max |ref| over two tensors (any devices)."""
    g, r = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))


def _vision_op_cases(tmx, rng):
    """(name, fn(ctx) -> list of NDArrays) for each op of the vision path,
    at the small oracle ResNet's shapes."""
    nd = tmx.nd

    def arr(*shape, lo=None):
        a = rng.uniform(lo, 1.5, shape) if lo is not None \
            else rng.randn(*shape)
        return a.astype(np.float32)

    x, w7 = arr(4, 3, 64, 64), arr(16, 3, 7, 7) * 0.1
    a16, w3 = arr(4, 16, 16, 16), arr(16, 16, 3, 3) * 0.1
    a64, w1 = arr(4, 64, 16, 16), arr(128, 64, 1, 1) * 0.1
    b128 = arr(128)
    g, b = arr(64, lo=0.5), arr(64) * 0.1
    mm, mv = arr(64) * 0.1, arr(64, lo=0.5)
    top = arr(4, 512, 2, 2)

    def bn(ctx, train):
        stats = [nd.array(mm, ctx=ctx), nd.array(mv, ctx=ctx)]
        mode = tmx.autograd.train_mode if train else \
            tmx.autograd.predict_mode
        with mode():
            out = nd.BatchNorm(nd.array(a64, ctx=ctx), nd.array(g, ctx=ctx),
                               nd.array(b, ctx=ctx), *stats, eps=1e-5,
                               fix_gamma=False)
        return [out] + stats

    return [
        ("Convolution 7x7/2 stem", lambda c: [nd.Convolution(
            nd.array(x, ctx=c), nd.array(w7, ctx=c), kernel=(7, 7),
            stride=(2, 2), pad=(3, 3), num_filter=16, no_bias=True)]),
        ("Convolution 3x3", lambda c: [nd.Convolution(
            nd.array(a16, ctx=c), nd.array(w3, ctx=c), kernel=(3, 3),
            pad=(1, 1), num_filter=16, no_bias=True)]),
        ("Convolution 1x1/2 bias", lambda c: [nd.Convolution(
            nd.array(a64, ctx=c), nd.array(w1, ctx=c), nd.array(b128, ctx=c),
            kernel=(1, 1), stride=(2, 2), num_filter=128)]),
        ("Pooling max 3/2/1", lambda c: [nd.Pooling(
            nd.array(a16, ctx=c), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
            pool_type="max")]),
        ("Pooling global avg", lambda c: [nd.Pooling(
            nd.array(top, ctx=c), global_pool=True, pool_type="avg")]),
        ("BatchNorm train (out, mean, var)", lambda c: bn(c, True)),
        ("BatchNorm predict (out, mean, var)", lambda c: bn(c, False)),
        ("pad reflect", lambda c: [nd.pad(
            nd.array(a16, ctx=c), mode="reflect",
            pad_width=(0, 0, 0, 0, 1, 1, 1, 1))]),
    ]


def _vision_sgd_step(tmx, net, x, y, trainer, B):
    """One step of the ResNet loop: record, softmax cross-entropy of the
    f32 logits over B (bench.py:149-151), backward, Trainer.step(1)."""
    with tmx.autograd.record():
        out = net(x)
        loss = tmx.nd.softmax_cross_entropy(
            out.astype("float32", copy=False), y) / B
    loss.backward()
    trainer.step(1)
    return loss


def vision_oracle(torch, tmx):
    """(a) Every op of the vision path, then a small bottleneck ResNet with
    the 7x7 stem and max-pool (ResNetV1(BottleneckV1, [1,1,1,1],
    [16,64,128,256,512], classes=10), batch 4, 64x64) on the card and on
    the CPU from the same weights carried by name: predict-mode outputs,
    one hybridized Trainer SGD step's loss, the running statistics after
    it, and the outputs after it."""
    from mxnet_tpu_torch import convert
    v = tmx.gluon.model_zoo.vision
    rng = np.random.RandomState(31)
    gpu, cpu = tmx.gpu(), tmx.cpu()
    for name, fn in _vision_op_cases(tmx, rng):
        card, host = fn(gpu), fn(cpu)
        err = max(_rel_err(torch, c._data, h._data)
                  for c, h in zip(card, host))
        _log(f"oracle vision op {name}: card vs CPU {err:.2e} (tol "
             f"{VISION_OP_TOL})")
        if not err <= VISION_OP_TOL:
            raise AssertionError(f"vision op {name}: {err}")

    def build():
        return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1],
                          [16, 64, 128, 256, 512], classes=10,
                          prefix="oracle_")

    B = 4
    x = rng.randn(B, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.float32)
    host = build()
    tmx.random.seed(32)
    host.initialize(tmx.init.Xavier(), ctx=cpu)
    with tmx.autograd.pause():
        host(tmx.nd.array(x, ctx=cpu))
    for k, p in host.collect_params().items():
        if k.endswith("running_mean"):
            p.set_data(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))
        elif k.endswith("running_var"):
            p.set_data(rng.uniform(0.5, 1.5, p.shape).astype(np.float32))
    card = convert.load_by_name(
        build(), {k: p.data().asnumpy()
                  for k, p in host.collect_params().items()}, device="cuda")
    res = {}
    for ctx, net in ((gpu, card), (cpu, host)):
        xs, ys = tmx.nd.array(x, ctx=ctx), tmx.nd.array(y, ctx=ctx)
        with tmx.autograd.predict_mode():
            before = net(xs)
        net.hybridize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9})
        loss = _vision_sgd_step(tmx, net, xs, ys, trainer, B)
        with tmx.autograd.predict_mode():
            after = net(xs)
        stats = [p.data()._data for k, p in net.collect_params().items()
                 if "running" in k]
        res[ctx] = (before._data, loss._data.detach(), after._data, stats)
    errs = {"predict": _rel_err(torch, res[gpu][0], res[cpu][0]),
            "loss": _rel_err(torch, res[gpu][1], res[cpu][1]),
            "after step": _rel_err(torch, res[gpu][2], res[cpu][2]),
            "statistics": max(_rel_err(torch, a, b) for a, b in
                              zip(res[gpu][3], res[cpu][3]))}
    _log(f"oracle vision small ResNetV1 bottleneck (batch {B}, 64x64): card "
         f"vs CPU " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
         + f" (tol {VISION_NET_TOL}); loss {res[cpu][1].item():.5f}")
    if not max(errs.values()) <= VISION_NET_TOL:
        raise AssertionError(f"vision oracle: {errs}")


def _net_flops(torch, tmx, net, x):
    """Forward FLOPs of ``net`` on ``x`` from its own layers, counted by
    forward hooks: 2 C_out (C_in / groups) k_h k_w H_out W_out per
    convolution, 2 in out per Dense row.  This forward also resolves the
    deferred shapes (predict mode: the statistics stay)."""
    nn = tmx.gluon.nn
    total = [0]

    def conv(block, inputs, out):
        c_out, c_in_g, kh, kw = block.weight.shape
        total[0] += 2 * c_out * c_in_g * kh * kw * out.shape[0] \
            * out.shape[2] * out.shape[3]

    def dense(block, inputs, out):
        total[0] += 2 * math.prod(block.weight.shape) * out.shape[0]

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2D)
                                     else dense)
             for m in net.modules() if isinstance(m, (nn.Conv2D, nn.Dense))]
    with tmx.autograd.pause(), torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return total[0]


def vision_phase(torch, fa, mx, args, smi):
    """The reference's ResNet-50 lane (bench.py:126-193, :545-547) on the
    card: (a) the oracle above; (b) f32: get_model("resnet50_v1",
    classes=1000), initialize(Xavier(), ctx=gpu), hybridize(),
    Trainer("sgd", VISION_SGD), softmax cross-entropy / B, 8 steps on one
    batch of 64 images at 224x224 from --seed, then parallel.TrainStep
    from the same weights, statistics and batch, both timed; both again
    under cudnn.deterministic, losses agreeing to TRAIN_TOL, and 2
    imperative steps (not hybridized) agreeing with the first 2; (d)
    save_parameters in npz and in dmlc, load_parameters into a fresh
    resnet50_v1 on the card: predict-mode outputs and every parameter
    bit-identical; (c) bf16 by net.cast with multi-precision SGD, every
    BatchNorm parameter still f32, the same runs, and a round trip of the
    bf16 net through npz, bit-identical.  Losses finite and falling,
    running statistics moved, no flash kernel launched; f32 runs no TF32
    kernel.  Prints step ms, images/s, FLOPs per step, MFU, peak memory,
    idle share and device time by kernel family per lane."""
    tmx = mx["pkg"]
    vision_oracle(torch, tmx)
    v = tmx.gluon.model_zoo.vision
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts(fa)
    gpu, B, size, classes, steps = tmx.gpu(), VISION_BATCH, VISION_SIZE, \
        1000, 8
    net = tmx.gluon.model_zoo.get_model("resnet50_v1", classes=classes)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    rng = np.random.RandomState(args.seed)
    x = rng.randn(B, 3, size, size).astype(np.float32)
    y = rng.randint(0, classes, B).astype(np.float32)
    flops_img = _net_flops(torch, tmx, net, tmx.nd.array(x[:1], ctx=gpu))
    flops_step = 3 * B * flops_img
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    stats = [k for k in params.keys() if "running" in k]
    ops_nn = mx["nn"]
    results, counts = {}, {}
    _log(f"vision resnet50_v1: {len(params)} parameters "
         f"({sum(p.data()._data.numel() for p in params.values())} values), "
         f"{flops_img / 1e9:.4f} GFLOP forward per image, "
         f"{flops_step / 1e12:.4f} TFLOP per training step (3x forward, "
         f"batch {B})")

    def restart():
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def moved():
        return all(not torch.equal(params[k].data()._data, start[k])
                   for k in stats)

    def numbers(dname, step_ms, prof):
        med = statistics.median(step_ms[2:])
        ips = B / (med / 1e3)
        return {"step_ms": med, "images_per_s": ips,
                "flops_per_step": flops_step,
                "mfu": flops_step / (med / 1e3) / PEAK_FLOPS[dname],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "idle_share": max(0.0, 1 - prof["device_ms"]
                                  / prof["wall_ms"]),
                "families": prof["families"]}

    def gluon_run(dname, xs, ys, n):
        trainer = tmx.gluon.Trainer(params, "sgd", dict(
            VISION_SGD, multi_precision=dname == "bfloat16"))
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses.append(_vision_sgd_step(tmx, net, xs, ys, trainer, B))
            tmx.nd.waitall()
            ms.append((time.perf_counter() - t) * 1e3)
        return [float(l.asscalar()) for l in losses], ms, trainer

    def check_falls(lane, losses):
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
                or not moved():
            raise AssertionError(f"{lane}: losses {losses} not finite and "
                                 f"falling, or statistics unmoved")

    def check_no_tf32(lane, prof):
        tf32 = [k for k in prof["kernels"] if "tf32" in k.lower()]
        if tf32:
            raise AssertionError(f"{lane}: TF32 kernels in an f32 step: "
                                 f"{tf32[:3]}")

    def trainstep_run(dname, tx, ty, n):
        opt = mx["optimizer"].SGD(multi_precision=dname == "bfloat16",
                                  **VISION_SGD)
        step = mx["parallel"].TrainStep(
            net, lambda out, lab: ops_nn.softmax_cross_entropy(
                out.float(), lab) / B, opt)
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses.append(step(tx, ty))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return [float(x) for x in losses], ms, step

    def lane_run(lane, dname, xs, ys):
        """The timed Gluon loop and TrainStep with cuDNN's default
        algorithms, as a user runs them; then both again, and 2 imperative
        steps (f32), under cudnn.deterministic: cuDNN's default backward
        algorithms sum in a run-dependent order, which 8 SGD steps of
        ResNet-50 amplify from 4e-6 to 1e-2 of the loss."""
        f32 = dname == "float32"
        tx, ty = xs._data, ys._data
        restart()
        losses, ms, trainer = gluon_run(dname, xs, ys, steps)
        check_falls(lane, losses)
        prof = _profile_step(torch, lambda: _vision_sgd_step(
            tmx, net, xs, ys, trainer, B), lane, VISION_FAMILIES)
        results[lane] = numbers(dname, ms, prof)
        _log(f"lane {lane}: Gluon loop losses "
             f"{[round(l, 5) for l in losses]}; step ms "
             f"{[round(t, 1) for t in ms]}")
        trainer = None
        restart()
        ts_losses, ts_ms, step = trainstep_run(dname, tx, ty, steps)
        check_falls(lane + " TrainStep", ts_losses)
        ts_prof = _profile_step(torch, lambda: step(tx, ty),
                                f"{lane}_trainstep", VISION_FAMILIES)
        results[f"{lane}_trainstep"] = numbers(dname, ts_ms, ts_prof)
        _log(f"lane {lane}: TrainStep losses "
             f"{[round(l, 5) for l in ts_losses]}; step ms "
             f"{[round(t, 1) for t in ts_ms]}")
        step = None
        if f32:
            check_no_tf32(lane, prof)
            check_no_tf32(lane + " TrainStep", ts_prof)
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            restart()
            want, _, _ = gluon_run(dname, xs, ys, steps)
            restart()
            got, _, _ = trainstep_run(dname, tx, ty, steps)
            rel = _rel(got, want)
            _log(f"lane {lane}: deterministic cuDNN, Gluon loop "
                 f"{[round(l, 5) for l in want]}, TrainStep on the same "
                 f"weights, statistics and batch rel {rel:.2e} (tol "
                 f"{TRAIN_TOL})")
            if not rel <= TRAIN_TOL:
                raise AssertionError(f"{lane}: TrainStep and the Gluon loop "
                                     f"disagree (rel {rel})")
            if f32:
                restart()
                net.hybridize(active=False)
                imp, _, _ = gluon_run(dname, xs, ys, 2)
                net.hybridize()
                rel = _rel(imp, want[:2])
                _log(f"lane {lane}: imperative (not hybridized) losses "
                     f"{[round(l, 5) for l in imp]} rel {rel:.2e} (tol "
                     f"{TRAIN_TOL})")
                if not rel <= TRAIN_TOL:
                    raise AssertionError(f"{lane}: imperative path rel "
                                         f"{rel}")
        finally:
            torch.backends.cudnn.deterministic = prev

    def roundtrip(fmt, hybridized, dtype=None):
        prev = os.environ.get("MXNET_PARAMS_FORMAT")
        os.environ["MXNET_PARAMS_FORMAT"] = fmt
        try:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, f"resnet50_v1.{fmt}.params")
                net.save_parameters(path)
                fresh = v.resnet50_v1(classes=classes)
                fresh.hybridize(hybridized)
                if dtype:
                    fresh.cast(dtype)
                fresh.load_parameters(path, ctx=gpu)
        finally:
            if prev is None:
                os.environ.pop("MXNET_PARAMS_FORMAT")
            else:
                os.environ["MXNET_PARAMS_FORMAT"] = prev
        probe = xs if dtype is None else xs.astype(dtype)
        with tmx.autograd.predict_mode():
            a, b = net(probe)._data, fresh(probe)._data
        same = torch.equal(a, b) and all(
            p.data()._data.dtype == q.data()._data.dtype
            and torch.equal(p.data()._data, q.data()._data)
            for p, q in zip(params.values(),
                            fresh.collect_params().values()))
        _log(f"checkpoint resnet50_v1 {dtype or 'float32'} via {fmt}: "
             f"{len(params)} parameters, predict-mode outputs and every "
             f"parameter bit-identical: {same}")
        if not same:
            raise AssertionError(f"checkpoint via {fmt} not bit-identical")

    xs, ys = tmx.nd.array(x, ctx=gpu), tmx.nd.array(y, ctx=gpu)
    net.hybridize()
    # (b) f32, then (d) its checkpoint in both formats
    lane_run("vision_resnet50_f32", "float32", xs, ys)
    roundtrip("npz", True)
    roundtrip("dmlc", True)

    # (c) bf16: cast (BatchNorm stays f32), multi-precision SGD
    restart()
    net.cast("bfloat16")
    wrong = [k for k, p in params.items()
             if p.data()._data.dtype != (torch.float32 if "batchnorm" in k
                                         else torch.bfloat16)]
    if wrong:
        raise AssertionError(f"bf16 cast: dtypes of {wrong[:4]}")
    lane_run("vision_resnet50_bf16", "bfloat16", xs.astype("bfloat16"), ys)
    roundtrip("npz", True, "bfloat16")

    net = params = start = None
    gc.collect()
    torch.cuda.empty_cache()
    vision_zoo(torch, tmx, args)

    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"vision path launched flash kernels: {counts}")
    for lane, r in results.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['images_per_s']:.2f} images/s, "
             f"{r['flops_per_step'] / 1e12:.4f} TFLOP/step, MFU "
             f"{r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}; device ms "
             + ", ".join(f"{k} {t:.1f}" for k, t in r["families"].items())
             + f" ({smi})")
    return counts, results


# one card step per zoo family beyond the ResNets: (name, training size,
# the size of the family's CPU parity test in tests/test_torch_zoo.py)
VISION_ZOO = (("alexnet", 224, 224), ("vgg16_bn", 224, 32),
              ("densenet121", 224, 224), ("squeezenet1.1", 224, 32),
              ("inceptionv3", 299, 299), ("mobilenet1.0", 224, 32),
              ("mobilenetv2_1.0", 224, 32))
VISION_ZOO_BATCH, VISION_ZOO_STEPS = 32, 3


def vision_zoo(torch, tmx, args):
    """Each family of VISION_ZOO on the card: (a) built on the CPU at its
    parity size (batch 2, Xavier), carried to the card by name, predict-
    mode logits card vs CPU within VISION_NET_TOL of max |CPU|; (b) at
    batch 32 and its training size, Xavier on the card, hybridized,
    VISION_ZOO_STEPS SGD steps (VISION_SGD) on one batch in f32: losses
    finite; step ms (median after the first) and images/s."""
    from mxnet_tpu_torch import convert
    v = tmx.gluon.model_zoo.vision
    gpu, cpu, B = tmx.gpu(), tmx.cpu(), VISION_ZOO_BATCH
    rng = np.random.RandomState(args.seed + 12)
    results = {}
    for name, size, test_size in VISION_ZOO:
        host = v.get_model(name, classes=10, prefix="zoo_")
        tmx.random.seed(args.seed)
        host.initialize(tmx.init.Xavier(), ctx=cpu)
        x2 = rng.randn(2, 3, test_size, test_size).astype(np.float32)
        with tmx.autograd.predict_mode():
            want = host(tmx.nd.array(x2, ctx=cpu))._data
        card = convert.load_by_name(
            v.get_model(name, classes=10, prefix="zoo_"),
            {k: p.data().asnumpy() for k, p in
             host.collect_params().items()}, device="cuda")
        with tmx.autograd.predict_mode():
            got = card(tmx.nd.array(x2, ctx=gpu))._data
        err = _rel_err(torch, got, want)
        host = card = None
        net = v.get_model(name, classes=1000)
        net.initialize(tmx.init.Xavier(), ctx=gpu)
        net.hybridize()
        xs = tmx.nd.array(rng.randn(B, 3, size, size).astype(np.float32),
                          ctx=gpu)
        ys = tmx.nd.array(rng.randint(0, 1000, B).astype(np.float32),
                          ctx=gpu)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", VISION_SGD)
        losses, ms = [], []
        for _ in range(VISION_ZOO_STEPS):
            t = time.perf_counter()
            losses.append(float(_vision_sgd_step(
                tmx, net, xs, ys, trainer, B).asscalar()))
            ms.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(ms[1:])
        _log(f"vision zoo {name}: card vs CPU logits (batch 2, "
             f"{test_size}x{test_size}) {err:.2e} (tol {VISION_NET_TOL}); "
             f"batch {B} at {size}x{size} f32, {VISION_ZOO_STEPS} SGD "
             f"steps: losses {[round(l, 5) for l in losses]}, step ms "
             f"{[round(t, 1) for t in ms]}, median {med:.2f} ms, "
             f"{B / (med / 1e3):.1f} images/s")
        if not (err <= VISION_NET_TOL and np.isfinite(losses).all()):
            raise AssertionError(f"vision zoo {name}: card vs CPU {err}, "
                                 f"losses {losses}")
        results[f"zoo_{name}"] = {"step_ms": med,
                                  "images_per_s": B / (med / 1e3)}
        net = trainer = xs = None
        gc.collect()
        torch.cuda.empty_cache()
    return results


# -- the loop phase: the Gluon training loop around the model ----------------

# every optimizer of mx.optimizer, each with a schedule, for the small-ResNet
# oracle (card vs CPU, 3 steps)
LOOP_OPTIMIZERS = {
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    "nag": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "adamw": {"learning_rate": 1e-3, "wd": 1e-2},
    "lars": {"learning_rate": 0.5, "momentum": 0.9, "wd": 1e-4},
    "rmsprop": {"learning_rate": 1e-3, "centered": True},
    "ftrl": {"learning_rate": 0.1, "lamda1": 1e-4},
    "signum": {"learning_rate": 1e-3, "momentum": 0.9},
    "lamb": {"learning_rate": 1e-3, "wd": 0.01},
    "adagrad": {"learning_rate": 0.01},
    "adadelta": {"rho": 0.9},
}
# card vs CPU after 3 steps on the same gradients, max |err| / max |ref|
# per parameter and over the losses.  f32: cuDNN and the CPU sum in other
# orders (6.2e-7 per op, 2.4e-6 for the small ResNet's step, in the
# vision oracle); 1e-5 for the losses and every parameter.  bf16: the
# update is f32 math on each trained parameter's f32 value (the master of
# a bf16 weight, BatchNorm's f32 gamma and beta themselves) fed the same
# gradients, so those values are held to f32's 1e-5 (LOOP_MASTER_TOL), and
# each bf16 weight must be its master rounded, bit for bit, on both
# devices (card and CPU weights then differ by at most one bf16 ulp, where
# the masters straddle a rounding boundary).  The losses and BatchNorm's
# running statistics come from each device's own bf16 forward, which
# rounds its products in other places: 1e-2, about two ulps (2^-8 of the
# value) of the largest
LOOP_ORACLE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
LOOP_MASTER_TOL = 1e-5
IMAGENET_MEAN, IMAGENET_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
LOOP_IMAGES, LOOP_BERT_SAMPLES, LOOP_STEPS = 640, 320, 10
# the loop phase's data has something to learn within one epoch of distinct
# batches (random labels over 1000 classes do not: the loss cannot fall
# below ln 1000 and wanders): images of ten of the 1000 classes whose
# brightness grows with the class, and BERT asked for its own input tokens
LOOP_CLASSES, LOOP_SHADE = 10, 12
# LAMB moves each layer by lr times its norm per step: at 1e-4 the BERT
# loss does not move in 10 steps; at 1e-2 it falls.  NAG at the vision
# phase's 0.025 (the reference recipe's 0.1 per 256 images, which assumes
# epochs of warmup) overshoots after a 3-step warmup on distinct batches:
# the bf16 ResNet-50 loss rose far above its start on the card.  The loop
# takes 0.005; the rate witness runs 0.025 in both dtypes, through the
# Trainer and through TrainStep, each Trainer step held against a plain
# NAG, so the loss curves at 0.025 are printed in every run
LOOP_LAMB_LR = 1e-2
LOOP_NAG = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
LOOP_NAG_WITNESS_LR = 0.025
# bert_12_768_12's widths, its depth cut from 12 layers to 6 (the smoke's
# time goes to later phases; every check of the phase stays)
LOOP_BERT = {"layers": 6, "units": 768, "hidden": 3072, "heads": 12,
             "batch": 32, "seq": 512, "vocab": 30522}


def _small_resnet(tmx):
    v = tmx.gluon.model_zoo.vision
    return v.ResNetV1(v.BottleneckV1, [1, 1, 1, 1], [16, 64, 128, 256, 512],
                      classes=10, prefix="oracle_")


def _image_loader(tmx, x, y, num_workers, flip=True, B=VISION_BATCH):
    """(b)'s loader: an ArrayDataset of host uint8 HWC images and labels,
    RandomFlipLeftRight (unless ``flip`` is False), ToTensor, Normalize;
    shuffled, last batch discarded."""
    t = tmx.gluon.data.vision.transforms
    ds = tmx.gluon.data.ArrayDataset(tmx.nd.array(x, ctx=tmx.cpu()),
                                     tmx.nd.array(y, ctx=tmx.cpu()))
    steps = [t.RandomFlipLeftRight()] if flip else []
    ds = ds.transform_first(t.Compose(steps + [
        t.ToTensor(), t.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]))
    return tmx.gluon.data.DataLoader(ds, batch_size=B, shuffle=True,
                                     last_batch="discard",
                                     num_workers=num_workers, timeout=300)


def loop_oracle(torch, tmx, x, y):
    """(a) On the card against the CPU or against itself: every optimizer
    with a schedule, 3 steps of the small bottleneck ResNet, f32 and bf16
    (multi_precision); the store owning the update against the trainer
    owning it; save_states / load_states mid-run; the worker loader
    against one process."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.data import dataloader
    gpu, cpu, B = tmx.gpu(), tmx.cpu(), 4
    rng = np.random.RandomState(41)
    xs = rng.randn(B, 3, 64, 64).astype(np.float32)
    ys = rng.randint(0, 10, B).astype(np.float32)
    host = _small_resnet(tmx)
    tmx.random.seed(42)
    host.initialize(tmx.init.Xavier(), ctx=cpu)
    with tmx.autograd.pause():
        host(tmx.nd.array(xs, ctx=cpu))
    start = {k: p.data().asnumpy() for k, p in host.collect_params().items()}
    card = convert.load_by_name(_small_resnet(tmx), start, device="cuda")
    nets = {gpu: card, cpu: host}
    for net in nets.values():
        net.hybridize()

    def trainer(ctx, name, kw, dname, **tkw):
        """A Trainer on ``ctx``'s net, reset to the start weights."""
        for k, p in nets[ctx].collect_params().items():
            p.set_data(start[k])
        kw = dict(kw, lr_scheduler=tmx.lr_scheduler.FactorScheduler(
            step=1, factor=0.7), multi_precision=dname == "bfloat16")
        return tmx.gluon.Trainer(nets[ctx].collect_params(), name, kw,
                                 **tkw), kw

    def forward_backward(ctx, dname):
        a = tmx.nd.array(xs, ctx=ctx).astype(dname)
        with tmx.autograd.record():
            loss = tmx.nd.softmax_cross_entropy(nets[ctx](a).astype(
                "float32", copy=False), tmx.nd.array(ys, ctx=ctx)) / B
        loss.backward()
        return float(loss.asscalar())

    def weights(ctx):
        return {k: p.data()._data.detach().clone()
                for k, p in nets[ctx].collect_params().items()}

    def f32_values(ctx, tr):
        """Each trained parameter's f32 value: its master where the weight
        is bf16 (multi_precision), else the weight itself."""
        out = {}
        for i, (k, p) in enumerate(nets[ctx].collect_params().items()):
            if p.grad_req != "null":
                w = p.data()._data
                out[k] = (tr._states[i][0] if w.dtype == torch.bfloat16
                          else w).detach().clone()
        return out

    def pair(name, kw, dname):
        """3 steps on both devices; each step the card's update takes the
        CPU's gradients.  The devices' own gradients differ by rounding,
        and where a gradient is near 0 (the bias of a convolution ahead of
        a BatchNorm, a channel ReLU shuts) Adam-like updates scale that
        difference up to steps of lr; with one gradient the updates must
        agree."""
        tr = {c: trainer(c, name, kw, dname)[0] for c in (cpu, gpu)}
        host_p = nets[cpu].collect_params()
        card_p = nets[gpu].collect_params()
        losses = {cpu: [], gpu: []}
        for _ in range(3):
            for c in (cpu, gpu):
                losses[c].append(forward_backward(c, dname))
            with torch.no_grad():
                for k, p in host_p.items():
                    if p.grad_req != "null":
                        card_p[k].grad()._data.copy_(p.grad()._data)
            for c in (cpu, gpu):
                tr[c].step(1)
        return (losses, weights(gpu), weights(cpu), f32_values(gpu, tr[gpu]),
                f32_values(cpu, tr[cpu]))

    def worst(a, b, keys):
        """(max |a - b| / max |b| over ``keys``, the key where it is)."""
        return max((_rel_err(torch, a[k], b[k]), k) for k in keys)

    def card_run(name, kw, dname, steps, save_at=None, **tkw):
        tr, kw = trainer(gpu, name, kw, dname, **tkw)
        for i in range(steps):
            forward_backward(gpu, dname)
            tr.step(1)
            if i + 1 == save_at:
                with tempfile.TemporaryDirectory() as d:
                    f = os.path.join(d, "oracle.states")
                    tr.save_states(f)
                    tr = tmx.gluon.Trainer(nets[gpu].collect_params(), name,
                                           kw, **tkw)
                    tr.load_states(f)
        return weights(gpu)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dname in ("float32", "bfloat16"):
            if dname == "bfloat16":
                for net in nets.values():
                    net.cast("bfloat16")
            tol = LOOP_ORACLE_TOL[dname]
            for name, kw in LOOP_OPTIMIZERS.items():
                losses, pc, ph, mc, mh = pair(name, kw, dname)
                lc, lh = losses[gpu], losses[cpu]
                el = _rel_err(torch, torch.tensor(lc), torch.tensor(lh))
                if dname == "float32":
                    ep, wk = worst(pc, ph, pc)
                    ok = ep <= tol
                    what = f"parameters {ep:.2e} ({wk}) (tol {tol})"
                else:
                    em, mk = worst(mc, mh, mc)
                    ew, wk = worst(pc, ph, mc)
                    es, sk = worst(pc, ph, [k for k in pc if k not in mc])
                    rounded = all(torch.equal(w[k], m[k].to(w[k].dtype))
                                  for w, m in ((pc, mc), (ph, mh))
                                  for k in m if w[k].dtype != m[k].dtype)
                    ok = em <= LOOP_MASTER_TOL and es <= tol and rounded
                    what = (f"f32 masters and weights {em:.2e} ({mk}) (tol "
                            f"{LOOP_MASTER_TOL}), trained weights {ew:.2e} "
                            f"({wk}), each bf16 weight its master rounded: "
                            f"{rounded}, running statistics {es:.2e} ({sk}) "
                            f"(tol {tol})")
                _log(f"oracle loop {name} {dname}: 3 steps card "
                     f"{[round(v, 6) for v in lc]} cpu "
                     f"{[round(v, 6) for v in lh]}, losses {el:.2e} (tol "
                     f"{tol}), {what}, of max |ref|")
                if not (el <= tol and ok):
                    raise AssertionError(f"loop oracle {name} {dname}: "
                                         f"losses {el}, {what}")
            # no store (one replica), the store owning the update, and an
            # explicit store reducing the one replica: the same bits
            nag = LOOP_OPTIMIZERS["nag"]
            plain = card_run("nag", nag, dname, 3, kvstore="local")
            on_kv = card_run("nag", nag, dname, 3, kvstore="local",
                             update_on_kvstore=True)
            store = card_run("nag", nag, dname, 3,
                             kvstore=tmx.kv.create("local"))
            same = all(torch.equal(plain[k], on_kv[k])
                       and torch.equal(plain[k], store[k]) for k in plain)
            # a states file written after step 2 and read by a new
            # Trainer: steps 3-4 as without it
            lamb = LOOP_OPTIMIZERS["lamb"]
            want = card_run("lamb", lamb, dname, 4)
            got = card_run("lamb", lamb, dname, 4, save_at=2)
            reload_same = all(torch.equal(want[k], got[k]) for k in want)
            _log(f"oracle loop {dname}: no store / update_on_kvstore / an "
                 f"explicit store, parameters bit-identical: {same}; "
                 f"save_states/load_states after step 2 of 4 (lamb), "
                 f"bit-identical: {reload_same}")
            if not (same and reload_same):
                raise AssertionError(f"loop oracle {dname}: kvstore {same}, "
                                     f"states {reload_same}")
    finally:
        torch.backends.cudnn.deterministic = prev

    # the worker loader against one process, transforms without the flip
    before = dataloader.fallbacks
    with_workers = _image_loader(tmx, x, y, 4, flip=False)
    try:
        np.random.seed(43)
        got = [(a._data, b._data) for a, b in with_workers]
    finally:
        with_workers._shutdown_pool()
    np.random.seed(43)
    want = [(a._data, b._data) for a, b in _image_loader(tmx, x, y, 0,
                                                         flip=False)]
    same = len(got) == len(want) == len(x) // VISION_BATCH and all(
        torch.equal(a, c) and torch.equal(b, d)
        for (a, b), (c, d) in zip(got, want))
    _log(f"oracle loop DataLoader: {len(got)} batches of {VISION_BATCH} with "
         f"4 workers bit-identical to one process: {same}; fallbacks "
         f"{dataloader.fallbacks - before}; batches on {got[0][0].device}")
    if not same or dataloader.fallbacks != before \
            or got[0][0].device != gpu.torch_device():
        raise AssertionError("loop oracle: the worker loader differs")


def _kvstore_times(torch, tmx, params):
    """pushpull_list of every trained gradient through a local store, on
    the card: one replica (the store's copies) and 2 and 4 replicas on the
    same card (copies of the gradients; the reduction's tree_sum adds).
    {replicas: median ms of 8}."""
    grads = [p.grad() for p in params.values() if p.grad_req != "null"]
    keys = list(range(len(grads)))
    nbytes = sum(g._data.numel() * g._data.element_size() for g in grads)
    times = {}
    for n in (1, 2, 4):
        kv = tmx.kv.create("local")
        kv.init(keys, [g.copy() for g in grads])
        vals = [[g.copy() for _ in range(n)] if n > 1 else g.copy()
                for g in grads]
        times[n] = statistics.median(_timed_ms(
            tmx, lambda: kv.pushpull_list(keys, vals, vals), 10)[2:])
        _log(f"kvstore local pushpull_list: {len(keys)} ResNet-50 gradients "
             f"({nbytes / 1e6:.1f} MB), {n} replica(s) on the card, "
             f"{times[n]:.3f} ms (median of 8)")
        kv = vals = None
    return times


def _nag_witness(torch, tmx, mx, net, params, restart, batches, schedule, B):
    """The loop's ResNet-50 from its start weights on ``batches`` (the
    first epoch's, fetched once) with NAG at LOOP_NAG_WITNESS_LR and
    ``schedule(lr)``: the Trainer in f32 and in bf16 (multi_precision),
    then TrainStep in bf16.  After every Trainer step each trained
    parameter's f32 value (a bf16 weight's master) is held against a plain
    NAG (the reference's nag_mom_update, tensor by tensor) of an f32 copy
    fed the same gradients, to LOOP_MASTER_TOL of its max |value|, and
    each bf16 weight must be its master rounded.  Returns {run: losses};
    the losses are not checked."""
    lr, ops_nn = LOOP_NAG_WITNESS_LR, mx["nn"]
    nag = dict(LOOP_NAG, learning_rate=lr)
    plist = list(params.values())
    trained = [i for i, p in enumerate(plist) if p.grad_req != "null"]
    curves = {}
    for dname in ("float32", "bfloat16"):
        mp = dname == "bfloat16"
        net.cast(dname)
        restart()
        trainer = tmx.gluon.Trainer(params, "nag", dict(
            nag, lr_scheduler=schedule(lr), multi_precision=mp),
            kvstore="local")
        plain = [plist[i].data()._data.detach().float().clone()
                 for i in trained]
        moms = [torch.zeros_like(w) for w in plain]
        rates = schedule(lr)
        losses, err, rounded, ms = [], 0.0, True, []
        torch.cuda.reset_peak_memory_stats()
        for k, (xb, yb) in enumerate(batches, 1):
            t = time.perf_counter()
            loss = _loop_step(tmx, net, xb, yb, trainer, dname, B)[1]
            ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss.mean().asscalar()))
            with torch.no_grad():
                for j, i in enumerate(trained):
                    p = plist[i]
                    g = p.grad()._data.float() / B + nag["wd"] * p.wd_mult \
                        * plain[j]
                    moms[j].mul_(nag["momentum"]).add_(g)
                    plain[j].sub_(rates(k) * p.lr_mult
                                  * (g + nag["momentum"] * moms[j]))
                    w = p.data()._data
                    value = trainer._states[i][0] if w.dtype != torch.float32 \
                        else w
                    rounded &= torch.equal(w, value.to(w.dtype))
                    err = max(err, float((value - plain[j]).abs().max()
                                         / plain[j].abs().max()))
        lane = f"nag_witness_{'bf16' if mp else 'f32'}_trainer"
        curves[lane] = losses
        peak = torch.cuda.max_memory_allocated() / 2**30
        xb, yb = batches[-1]
        prof = _profile_step(torch, lambda: _loop_step(
            tmx, net, xb, yb, trainer, dname, B), lane, VISION_FAMILIES)
        med = statistics.median(ms[2:])
        _log(f"{lane}: NAG lr {lr}, losses {[round(v, 5) for v in losses]}; "
             f"f32 values against a plain NAG on the same gradients "
             f"{err:.2e} of max |value| (tol {LOOP_MASTER_TOL}), each bf16 "
             f"weight its master rounded: {rounded}; eager Gluon step "
             f"{med:.2f} ms (median of steps 3-{len(ms)}), idle share "
             f"{max(0.0, 1 - prof['device_ms'] / med):.3f}, peak "
             f"{peak:.2f} GiB")
        if not (err <= LOOP_MASTER_TOL and rounded):
            raise AssertionError(f"{lane}: the NAG update is not the plain "
                                 f"one: {err}, rounded {rounded}")
        # no graph of the Gluon steps may stay referenced: its gradient
        # accumulators would tie TrainStep's capture to the default stream
        trainer = plain = moms = loss = None
    # TrainStep, bf16: the same data, schedule and multi_precision
    restart()
    net.cast("bfloat16")
    opt = mx["optimizer"].NAG(multi_precision=True, lr_scheduler=schedule(lr),
                              **nag)
    step = mx["parallel"].TrainStep(
        net, lambda out, lab: ops_nn.softmax_cross_entropy(
            out.float(), lab) / B, opt)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for xb, yb in batches:
        x = xb._data.to(torch.bfloat16)
        t = time.perf_counter()
        losses.append(float(step(x, yb._data)))
        ms.append((time.perf_counter() - t) * 1e3)
    curves["nag_witness_bf16_trainstep"] = losses
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile_step(torch, lambda: step(x, yb._data),
                         "nag_witness_bf16_trainstep", VISION_FAMILIES)
    med = statistics.median(ms[2:])
    _log(f"nag_witness_bf16_trainstep: NAG lr {lr}, losses "
         f"{[round(v, 5) for v in losses]}; captured step {med:.2f} ms "
         f"(median of steps 3-{len(ms)}; step 1 eager, 2 the capture), idle "
         f"share {max(0.0, 1 - prof['device_ms'] / med):.3f}, peak "
         f"{peak:.2f} GiB")
    return curves


def _loop_step(tmx, net, x, y, trainer, dtype, B):
    """record, forward, SoftmaxCrossEntropyLoss on f32 logits, backward,
    Trainer.step(B), the device drained: (logits, per-sample losses)."""
    if dtype != "float32":
        x = x.astype(dtype)
    with tmx.autograd.record():
        out = net(x)
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            out.astype("float32", copy=False), y)
    loss.backward()
    trainer.step(B)
    tmx.nd.waitall()
    return out, loss


def _loop_epoch(tmx, it, step, update, steps, trainer, B):
    """``steps`` iterations of the canonical loop: next(it), ``step(x, y)``
    (forward, loss, backward, Trainer.step; the device drained), then
    ``update(y, *step's outputs)`` (the metrics; returns the batch's loss
    sum).  Per step: loss mean, wall ms, ms waiting in next(), ms of the
    metrics' update (the host copies and numpy work) and the learning
    rate the optimizer used."""
    rec = {k: [] for k in ("losses", "step_ms", "wait_ms", "metric_ms",
                           "lr")}
    for _ in range(steps):
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        outs = step(x, y)
        t2 = time.perf_counter()
        total = update(y, *outs)
        t3 = time.perf_counter()
        rec["losses"].append(total / B)
        rec["wait_ms"].append((t1 - t0) * 1e3)
        rec["metric_ms"].append((t3 - t2) * 1e3)
        rec["step_ms"].append((t3 - t0) * 1e3)
        rec["lr"].append(trainer.learning_rate)
    return rec


def _loop_numbers(torch, rec, B, prof):
    """The run's numbers.  The idle share sets the device time per step
    (profiled) against the median step's wall time (not profiled): the
    profiler's own host cost per op would stretch a host-bound step."""
    window = slice(2, None)             # steps 3-10, as the other phases
    med = statistics.median(rec["step_ms"][window])
    return {"step_ms": med, "per_s": B / (med / 1e3),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "idle_share": max(0.0, 1 - prof["device_ms"] / med),
            "wait_ms": statistics.mean(rec["wait_ms"][window]),
            "first_wait_ms": rec["wait_ms"][0],
            "metric_ms": statistics.mean(rec["metric_ms"][window])}


def _check_run(lane, rec, want_lr):
    _log(f"lane {lane}: losses {[round(v, 5) for v in rec['losses']]}; "
         f"step ms {[round(v, 1) for v in rec['step_ms']]}; next() ms "
         f"{[round(v, 1) for v in rec['wait_ms']]}; metric ms "
         f"{[round(v, 2) for v in rec['metric_ms']]}; lr {rec['lr']}")
    losses = rec["losses"]
    if not all(np.isfinite(losses)) \
            or not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{lane}: losses {losses} not finite, or the "
                             f"last three steps' mean not below the first "
                             f"step's loss")
    if not np.allclose(rec["lr"], want_lr, rtol=1e-12, atol=0):
        raise AssertionError(f"{lane}: rates {rec['lr']}, the schedule "
                             f"{want_lr}")


def _timed_ms(tmx, step, steps):
    ms = []
    for _ in range(steps):
        t = time.perf_counter()
        step()
        tmx.nd.waitall()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def loop_phase(torch, fa, mx, args, smi):
    """The loop phase: (a) the oracle above; (b) resnet50_v1 (1000 classes,
    Xavier from --seed, hybridized) trained one epoch (10 steps of 64) from
    a DataLoader over 640 host uint8 images with 4 workers
    (RandomFlipLeftRight, ToTensor, Normalize), NAG with a MultiFactor
    schedule and warmup, Trainer(kvstore="local"), accuracy, top-5 and loss
    metrics every batch; f32, then bf16 (net.cast, BatchNorm f32,
    multi_precision); each beside the vision phase's loop (SGD, one
    pre-staged batch) on the same weights; the store's reduction timed and
    the rate witness (_nag_witness); (d) Estimator.fit on resnet18_v1
    over 4 batches of (b)'s loader with a CheckpointHandler, the checkpoint
    reloaded bit for bit; (c) BERT-base bf16 10 steps from a 2-worker
    DataLoader, LAMB with a polynomial warmup-decay schedule, the loss and
    the accuracy of the argmax, beside the gluon phase's Adam loop on one
    batch.  The data is from --seed (LOOP_CLASSES, LOOP_SHADE; BERT
    reconstructs its tokens); NAG runs at LOOP_NAG's rate, LAMB at
    LOOP_LAMB_LR.  In every lane the last three steps' mean loss is below
    the first step's, the rates are the schedules', the loader never falls
    back and no worker outlives the phase; BERT launches 12 bf16 forward
    and 12 bf16 fused backward kernels a step, ResNet none."""
    import multiprocessing
    from mxnet_tpu_torch.gluon.data import dataloader
    tmx = mx["pkg"]
    gpu, B, size, classes = tmx.gpu(), VISION_BATCH, VISION_SIZE, 1000
    rng = np.random.RandomState(args.seed)
    y = rng.randint(0, LOOP_CLASSES, LOOP_IMAGES)
    x = (rng.randint(0, 256 - LOOP_SHADE * LOOP_CLASSES,
                     (LOOP_IMAGES, size, size, 3))
         + LOOP_SHADE * y[:, None, None, None]).astype(np.uint8)
    loop_oracle(torch, tmx, x, y)
    fallbacks0 = dataloader.fallbacks
    results = {}

    # (b) ResNet-50 through the DataLoader
    gc.collect()
    torch.cuda.empty_cache()
    _reset_counts(fa)
    loader = _image_loader(tmx, x, y, 4)
    procs = list(loader._pool._pool)
    net = tmx.gluon.model_zoo.get_model("resnet50_v1", classes=classes)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    flops_step = 3 * B * _net_flops(torch, tmx, net, tmx.nd.array(
        np.zeros((1, 3, size, size), np.float32), ctx=gpu))
    net.hybridize()
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    np.random.seed(args.seed)
    staged = next(iter(_image_loader(tmx, x, y, 0)))

    def restart():
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    nag_kw = LOOP_NAG

    def schedule(lr=nag_kw["learning_rate"]):
        return tmx.lr_scheduler.MultiFactorScheduler(
            step=[6, 8], factor=0.1, base_lr=lr, warmup_steps=3)

    kv_ms = None
    for dname in ("float32", "bfloat16"):
        lane = f"loop_resnet50_{'f32' if dname == 'float32' else 'bf16'}"
        mp = dname == "bfloat16"
        restart()
        if mp:
            net.cast("bfloat16")
        trainer = tmx.gluon.Trainer(params, "nag", dict(
            nag_kw, lr_scheduler=schedule(), multi_precision=mp),
            kvstore="local")
        metrics = tmx.metric.create(["acc", tmx.metric.TopKAccuracy(5)])
        loss_metric = tmx.metric.Loss()

        def update(y_, out, loss):
            before = loss_metric.sum_metric
            metrics.update([y_], [out])
            loss_metric.update(None, [loss])
            return loss_metric.sum_metric - before

        def step(x_, y_):
            return _loop_step(tmx, net, x_, y_, trainer, dname, B)

        np.random.seed(args.seed)
        it = iter(loader)
        rec = _loop_epoch(tmx, it, step, update, LOOP_STEPS, trainer, B)
        _check_run(lane, rec, [schedule()(k)
                               for k in range(1, LOOP_STEPS + 1)])
        _log(f"lane {lane}: metrics {metrics.get_name_value()} "
             f"{loss_metric.get_name_value()}")
        np.random.seed(args.seed + 1)
        it = iter(loader)
        for _ in range(2):
            step(*next(it))

        def iterations(n=3):
            for _ in range(n):
                x_, y_ = next(it)
                update(y_, *step(x_, y_))

        prof = _profile_step(torch, iterations, lane, VISION_FAMILIES, 3)
        r = results[lane] = _loop_numbers(torch, rec, B, prof)
        r["mfu"] = flops_step / (r["step_ms"] / 1e3) / PEAK_FLOPS[dname]
        if not mp:
            kv_ms = _kvstore_times(torch, tmx, params)
        trainer = it = None
        # the vision phase's loop on the same weights: SGD, one batch
        restart()
        if mp:
            net.cast("bfloat16")
        sgd = tmx.gluon.Trainer(params, "sgd", dict(VISION_SGD,
                                                    multi_precision=mp))
        bx, by = staged[0].astype(dname), staged[1].astype("float32")
        base = []
        ms = _timed_ms(tmx, lambda: base.append(_vision_sgd_step(
            tmx, net, bx, by, sgd, B)), LOOP_STEPS)
        med = statistics.median(ms[2:])
        results[lane + "_prestaged_sgd"] = {"step_ms": med,
                                            "per_s": B / (med / 1e3)}
        _log(f"lane {lane}: the vision phase's loop (SGD, one pre-staged "
             f"batch) on the "
             f"same weights, step ms {[round(v, 1) for v in ms]}, losses "
             f"{[round(float(v.asscalar()), 5) for v in base]}")
        sgd = base = None
    # NAG at LOOP_NAG_WITNESS_LR on the loop's first ten batches, fetched once
    np.random.seed(args.seed)
    random.seed(args.seed)
    it = iter(loader)
    batches = [next(it) for _ in range(LOOP_STEPS)]
    it = None
    witness = _nag_witness(torch, tmx, mx, net, params, restart, batches,
                           schedule, B)
    batches = None
    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"the ResNet loop launched flash kernels: "
                             f"{counts}")
    # the share of next() that is the batch's host-to-card copy
    host = np.ones((B, 3, size, size), np.float32)
    copy_ms = statistics.median(_timed_ms(
        tmx, lambda: torch.from_numpy(host).to(gpu.torch_device()), 10)[2:])
    _log(f"host-to-card copy of one {host.nbytes / 1e6:.1f} MB f32 batch "
         f"(pageable, as the loader's): {copy_ms:.2f} ms (median of 8)")
    host = None

    # (d) Estimator.fit on resnet18_v1 over 4 batches of the same loader
    est_net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=classes)
    est_net.initialize(tmx.init.Xavier(), ctx=gpu)
    est_net.hybridize()
    est_mod = tmx.gluon.contrib.estimator
    est = est_mod.Estimator(
        est_net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=["acc"], trainer=tmx.gluon.Trainer(
            est_net.collect_params(), "nag", dict(nag_kw)))
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        est.fit(loader, epochs=1, batches=4, event_handlers=[
            est_mod.CheckpointHandler(d, model_prefix="resnet18")])
        fit_s = time.perf_counter() - t
        fresh = tmx.gluon.model_zoo.get_model("resnet18_v1",
                                              classes=classes)
        fresh.load_parameters(os.path.join(d, "resnet18-epoch0.params"),
                              ctx=gpu)
        states = os.path.exists(os.path.join(d, "resnet18-epoch0.states"))
    same = all(torch.equal(p.data()._data, q.data()._data)
               for p, q in zip(est_net.collect_params().values(),
                               fresh.collect_params().values()))
    _log(f"estimator resnet18_v1: fit 4 batches in {fit_s:.1f} s, "
         f"{est.train_loss_metric.get()} {est.train_metrics[0].get()}; "
         f"checkpoint reloads bit for bit: {same}; trainer states saved: "
         f"{states}")
    if not (same and states):
        raise AssertionError("estimator checkpoint does not reload")
    loader._shutdown_pool()
    net = est = est_net = fresh = loader = staged = params = start = None
    gc.collect()
    torch.cuda.empty_cache()

    # (c) BERT-base bf16 through a DataLoader, LAMB with warmup-decay
    bert = tmx.gluon.model_zoo.bert
    layers, units, Bb, L, vocab = (LOOP_BERT[k] for k in (
        "layers", "units", "batch", "seq", "vocab"))
    bnet = bert.BERTModel(vocab_size=vocab, num_layers=layers, units=units,
                          hidden_size=LOOP_BERT["hidden"],
                          num_heads=LOOP_BERT["heads"], max_length=L,
                          dropout=0.0, prefix="bert_")
    tmx.random.seed(args.seed)
    bnet.initialize(tmx.init.Normal(0.02), ctx=gpu)
    bparams = bnet.collect_params()
    n_matmul = sum(p.numel() for n, p in bnet.named_parameters()
                   if "word_embed" not in n and "position" not in n)
    flops_tok = 6 * n_matmul + 12 * layers * units * L
    bnet.hybridize()
    bnet.cast("bfloat16")
    bstart = {k: p.data()._data.detach().clone() for k, p in bparams.items()}
    toks = rng.randint(0, vocab, (LOOP_BERT_SAMPLES, L))
    bloader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(toks, toks), batch_size=Bb, shuffle=True,
        last_batch="discard", num_workers=2, timeout=300)
    procs += list(bloader._pool._pool)

    def brestart():
        for k, p in bparams.items():
            p.set_data(bstart[k])
            p.data()._data.grad = None
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def poly():
        return tmx.lr_scheduler.PolyScheduler(max_update=LOOP_STEPS,
                                              base_lr=LOOP_LAMB_LR, pwr=1,
                                              warmup_steps=2)

    brestart()
    trainer = tmx.gluon.Trainer(bparams, "lamb", {
        "learning_rate": LOOP_LAMB_LR, "wd": 0.01, "lr_scheduler": poly(),
        "multi_precision": True}, kvstore="local")
    lossf = tmx.gluon.loss.SoftmaxCELoss()
    loss_m, acc_m = tmx.metric.Loss(), tmx.metric.Accuracy()

    def bert_step(tb, lb):
        with tmx.autograd.record():
            logits = bnet(tb)[2]
            loss = lossf(logits.astype("float32", copy=False), lb)
        loss.backward()
        trainer.step(Bb)
        tmx.nd.waitall()
        return logits, loss

    def bert_update(lb, logits, loss):
        before = loss_m.sum_metric
        loss_m.update(None, [loss])
        acc_m.update([lb], [logits.argmax(axis=-1)])
        return loss_m.sum_metric - before

    _reset_counts(fa)
    np.random.seed(args.seed)
    it = iter(bloader)
    rec = _loop_epoch(tmx, it, bert_step, bert_update, LOOP_STEPS, trainer,
                      Bb)
    bert_counts = _counts(fa)
    lane = "loop_bert_seq512"
    _check_run(lane, rec, [poly()(k) for k in range(1, LOOP_STEPS + 1)])
    _log(f"lane {lane}: {loss_m.get()} {acc_m.get()}; launches over "
         f"{LOOP_STEPS} steps {bert_counts}")
    want = {"flash_fwd": layers * LOOP_STEPS,
            "flash_bwd_fused": layers * LOOP_STEPS}
    if any(n != want.get(k, 0) for k, n in bert_counts.items()):
        raise AssertionError(f"{lane}: launches {bert_counts}, want {want} "
                             f"and no other")
    np.random.seed(args.seed + 1)
    it = iter(bloader)
    for _ in range(2):
        tb, lb = next(it)
        bert_step(tb, lb)

    def bert_iterations(n=3):
        for _ in range(n):
            tb_, lb_ = next(it)
            bert_update(lb_, *bert_step(tb_, lb_))

    prof = _profile_step(torch, bert_iterations, lane, FLASH_FAMILIES, 3)
    r = results[lane] = _loop_numbers(torch, rec, Bb, prof)
    r["mfu"] = r["per_s"] * L * flops_tok / PEAK_FLOPS["bfloat16"]
    bloader._shutdown_pool()
    it = trainer = None
    # the gluon phase's loop on the same weights: Adam, one batch
    brestart()
    adam = tmx.gluon.Trainer(bparams, "adam", {"learning_rate": 1e-4,
                                               "multi_precision": True})
    _, ms = _gluon_steps(tmx, bnet, [tb], lb, LOOP_STEPS, adam)
    med = statistics.median(ms[2:])
    results[lane + "_prestaged_adam"] = {"step_ms": med,
                                         "per_s": Bb / (med / 1e3)}
    _log(f"lane {lane}: the gluon phase's loop (Adam, one pre-staged "
         f"batch) on the "
         f"same weights, step ms {[round(v, 1) for v in ms]}")
    adam = bnet = bparams = bstart = tb = lb = None
    gc.collect()
    torch.cuda.empty_cache()

    alive = [p for p in procs if p.is_alive()]
    if alive or multiprocessing.active_children():
        raise AssertionError(f"DataLoader workers outlive their loaders: "
                             f"{alive or multiprocessing.active_children()}")
    if dataloader.fallbacks != fallbacks0:
        raise AssertionError(f"the DataLoader fell back "
                             f"{dataloader.fallbacks - fallbacks0} times")
    for lane, r in results.items():
        unit = "samples/s" if "bert" in lane else "images/s"
        extra = "" if "idle_share" not in r else (
            f", MFU {r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
            f"{r['idle_share']:.3f}, next() {r['wait_ms']:.2f} ms (first "
            f"{r['first_wait_ms']:.1f}), metric.update {r['metric_ms']:.2f} "
            f"ms")
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, {r['per_s']:.2f} "
             f"{unit}{extra} ({smi})")
    _log("kvstore local pushpull_list (ResNet-50 gradients): "
         + ", ".join(f"{n} replica{'s' if n > 1 else ''} {t:.3f} ms"
                     for n, t in kv_ms.items()) + f" ({smi})")
    for lane, losses in witness.items():
        _log(f"rate witness {lane}: NAG lr {LOOP_NAG_WITNESS_LR}, losses "
             f"{[round(v, 5) for v in losses]} ({smi})")
    return bert_counts, results


# -- nd: the rest of mx.nd ----------------------------------------------------

ND_SAMPLER_DRAWS = 10 ** 6      # draws per parameter set of each sampler
ND_TRANSFORMER = {"units": 512, "heads": 8, "batch": 32, "lq": 256,
                  "lk": 512, "self_len": 512}   # zoo transformer.py:45
ND_CPU_BATCH = 4                # batch rows the CPU recomputes
# bf16 card vs CPU, of max |CPU|: 4 bf16 ulps at the largest value.  The
# CPU's bf16 path rounds p, the output and each gradient step at other
# points than the flash tiles (a dense softmax and bf16 autograd), so each
# side sits about 2 ulps from the f32 result (7.1e-3 seen on an H100)
ND_BF16_HOST_TOL = 2.0 ** -6


def _nd_sweep(tmx, sweep):
    """Every op the port registers (the samplers apart) on the card and on
    the CPU from the same numpy inputs (``ops/sweep.py``): outputs and
    dtypes, and for a differentiable op the gradients of sum(out * w),
    within ``sweep.TOL`` of max |CPU| (1e-5 elementwise, 1e-4 for sums,
    linear algebra and attention; gradients 1e-4), the decompositions by
    their invariants.  Returns (ops compared, mismatches)."""
    names = sweep.sweep_ops()
    bad = []
    for name in names:
        arrays, attrs = sweep.op_inputs(name)
        got, got_g = sweep.run(tmx, name, arrays, attrs, tmx.gpu())
        want, want_g = sweep.run(tmx, name, arrays, attrs, tmx.cpu())
        err, tol = sweep.close(name, got, want, arrays)
        gerr = max((sweep.rel_err(g, w) for g, w in zip(got_g, want_g)),
                   default=0.0) if len(got_g) == len(want_g) else math.inf
        same_dtypes = [g.dtype for g in got] == [w.dtype for w in want]
        if err > tol or gerr > sweep.TOL["reduction"] or not same_dtypes:
            bad.append(name)
            _log(f"nd sweep MISMATCH {name}: outputs {err:.3g} (bound "
                 f"{tol:g}), gradients {gerr:.3g}, dtypes "
                 f"{[str(g.dtype) for g in got]} vs "
                 f"{[str(w.dtype) for w in want]}")
    _log(f"nd sweep: {len(names)} ops compared card vs CPU (of "
         f"{len(tmx.ops.registry.list_ops())} registered names, the "
         f"{len(sweep.SAMPLERS)} samplers apart), {len(bad)} mismatches")
    return len(names), bad


def _nd_default_context(tmx):
    """With no ctx, the samplers, mx.random, the creation ops and linalg
    land on the card.  Returns the names that did not."""
    nd = tmx.nd
    outs = {"nd.random.uniform": nd.random.uniform(shape=(4,)),
            "nd.random.randint": nd.random.randint(low=0, high=3,
                                                   shape=(4,)),
            "random.randn": tmx.random.randn(2, 2),
            "random.normal": tmx.random.normal(shape=(3,)),
            "nd.eye": nd.eye(N=3), "nd.linspace": nd.linspace(num=5),
            "nd.linalg.gemm2": nd.linalg.gemm2(nd.ones((2, 2)),
                                               nd.ones((2, 2)))}
    return [k for k, v in outs.items() if v.context.device_type != "gpu"]


def _nd_draw(tmx, name, arrays, attrs, ctx):
    reg = tmx.ops.registry
    out = reg.invoke(reg.get(name), [tmx.nd.array(a, ctx=ctx)
                                     for a in arrays], dict(attrs), ctx=ctx)
    out = out.asnumpy()
    return out.argmax(-1) if name == "gumbel_softmax" else out


def _nd_samplers(tmx, sweep):
    """With no ctx, the samplers land on the card (_nd_default_context);
    each sampler on the card: the same seed gives the same draws and
    two seeds different ones (1000 draws); at ND_SAMPLER_DRAWS draws per
    parameter set, f32, the sample mean and variance lie within 5
    standard errors of the distribution's and the goodness-of-fit p-value
    (KS, or chi-square for a discrete distribution) is above 1e-3.
    ``shuffle`` permutes rows, reproducibly."""
    gpu = tmx.gpu()
    bad = [f"{n} not on the card" for n in _nd_default_context(tmx)]
    for name, arrays, attrs, _ in sweep.sampler_cases(1000):
        draws = []
        for seed in (11, 11, 12):
            tmx.random.seed(seed)
            draws.append(_nd_draw(tmx, name, arrays, attrs, gpu))
        if not np.array_equal(draws[0], draws[1]) \
                or np.array_equal(draws[0], draws[2]):
            bad.append(f"{name} seeding")
    x = np.arange(4000, dtype=np.float32).reshape(1000, 4)
    perms = []
    for seed in (5, 5):
        tmx.random.seed(seed)
        perms.append(tmx.nd.shuffle(tmx.nd.array(x, ctx=gpu)).asnumpy())
    if not np.array_equal(perms[0], perms[1]) \
            or not np.array_equal(np.sort(perms[0][:, 0]), x[:, 0]) \
            or np.array_equal(perms[0], x):
        bad.append("shuffle")
    tmx.random.seed(13)
    for name, arrays, attrs, dists in sweep.sampler_cases(ND_SAMPLER_DRAWS):
        t0 = time.perf_counter()
        rows = _nd_draw(tmx, name, arrays, attrs, gpu).reshape(len(dists),
                                                               -1)
        t_draw = time.perf_counter() - t0
        for row, dist in zip(rows, dists):
            mz, vz, p = sweep.draw_stats(row, dist)
            ok = abs(mz) < 5 and abs(vz) < 5 and p > 1e-3
            _log(f"nd sampler {name} {dist[0]}{dist[1]}: {row.size} draws "
                 f"({t_draw:.2f} s with the copy): mean z {mz:+.2f}, var z "
                 f"{vz:+.2f}, fit p {p:.3g}" + ("" if ok else "  FAIL"))
            if not ok:
                bad.append(f"{name} {dist}")
    return bad


def _nd_attention_cases(rng):
    """(label, op, numpy inputs, attrs) at the zoo transformer's base
    widths: masked_encdec_att with valid lengths in [Lq, Lk], and
    multihead_attention at self length, not causal and causal."""
    t = ND_TRANSFORMER
    E, B, L = t["units"], t["batch"], t["self_len"]

    def arr(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    valid = rng.integers(t["lq"], t["lk"] + 1, B).astype(np.float32)
    return [
        (f"masked_encdec_att B={B} Lq={t['lq']} Lk={t['lk']} units={E} "
         f"heads={t['heads']}", "contrib.masked_encdec_att",
         [arr(t["lq"], B, E), arr(t["lk"], B, 2 * E), valid],
         {"heads": t["heads"]}),
        (f"multihead_attention B={B} L={L} units={E} heads={t['heads']}",
         "contrib.multihead_attention", [arr(L, B, E) for _ in range(3)],
         {"heads": t["heads"], "causal": False}),
        (f"multihead_attention causal B={B} L={L} units={E} "
         f"heads={t['heads']}", "contrib.multihead_attention",
         [arr(L, B, E) for _ in range(3)],
         {"heads": t["heads"], "causal": True}),
    ]


def _nd_inputs(tmx, arrays, ctx, dtype, batch=None):
    """The (L, B, E) inputs in ``dtype`` with a gradient buffer, the
    valid lengths (B,) in float32; ``batch`` keeps that many batch rows.
    Returns (inputs, the ones with a gradient)."""
    if batch is not None:
        arrays = [a[:, :batch] if a.ndim == 3 else a[:batch]
                  for a in arrays]
    ins = [tmx.nd.array(a, ctx=ctx, dtype=dtype if a.ndim == 3 else None)
           for a in arrays]
    floats = [a for a in ins if a.ndim == 3]
    for a in floats:
        a.attach_grad()
    return ins, floats


def _nd_attention_run(torch, tmx, name, arrays, attrs, ctx, dtype,
                      batch=None, flash_reference=False):
    """(out, grads of sum(out * w) in the inputs' order) as float32 CPU
    tensors; w is fixed for the full batch and cut with it."""
    reg = tmx.ops.registry
    L, B, E = arrays[0].shape
    w = np.random.RandomState(1).standard_normal((L, B, E)) \
        .astype(np.float32)[:, :batch]
    ins, floats = _nd_inputs(tmx, arrays, ctx, dtype, batch)
    with tmx.autograd.record():
        out = reg.invoke(reg.get(name), ins,
                         dict(attrs, flash_reference=flash_reference))
        (out * tmx.nd.array(w, ctx=ctx, dtype=dtype)).sum().backward()
    return [torch.from_numpy(out.asnumpy())] + \
        [torch.from_numpy(a.grad.asnumpy()) for a in floats]


def _nd_attention(torch, fa, tmx, args):
    """(c) the contrib attention family at the transformer's base widths,
    f32 and bf16, forward and gradients: each op against itself with the
    flash call bound to its plain version on the card
    (``flash_reference=True``), at the kernel phases' bounds (out: f32
    2e-5 max abs error, bf16 2 ulps of max(|ref|, 2^-6); gradients f32
    1e-4, bf16 5e-3 of max |ref|), and its first ND_CPU_BATCH batch rows
    against the CPU (the dense cross path, or the plain flash versions at
    self length): f32 2e-5 out and 1e-4 gradients, bf16 ND_BF16_HOST_TOL
    of max |ref|.  Returns the flash launches of the kernel
    runs (reset just before them, read just after), the cases and the
    failures."""
    gpu, cpu = tmx.gpu(), tmx.cpu()
    cases = _nd_attention_cases(np.random.default_rng(args.seed))
    dtypes = ("float32", "bfloat16")
    _reset_counts(fa)
    runs = {(d, c[0]): _nd_attention_run(torch, tmx, c[1], c[2], c[3], gpu,
                                         d)
            for d in dtypes for c in cases}
    torch.cuda.synchronize()
    launches = _counts(fa)
    bad = []
    for dname in dtypes:
        for label, name, arrays, attrs in cases:
            got = runs[(dname, label)]
            plain = _nd_attention_run(torch, tmx, name, arrays, attrs, gpu,
                                      dname, flash_reference=True)
            host = _nd_attention_run(torch, tmx, name, arrays, attrs, cpu,
                                     dname, batch=ND_CPU_BATCH)
            if dname == "float32":
                e_out = (got[0] - plain[0]).abs().max().item()
                out_ok = e_out <= TOL["float32"][0]
            else:                   # (L, B, E) as (B, 1, L, E), every row
                g, p = (t.permute(1, 0, 2)[:, None] for t in (got[0],
                                                             plain[0]))
                e_out = _bf16_ulps(torch, g, p,
                                   torch.ones(g.shape[0], g.shape[2]))
                out_ok = e_out <= BF16_OUT_ULPS
            e_grad = max(_rel_err(torch, g, r)
                         for g, r in zip(got[1:], plain[1:]))
            sub = [g[:, :ND_CPU_BATCH] for g in got]
            e_host_out = (sub[0] - host[0]).abs().max().item() \
                if dname == "float32" else _rel_err(torch, sub[0], host[0])
            e_host_grad = max(_rel_err(torch, g, r)
                              for g, r in zip(sub[1:], host[1:]))
            if dname == "float32":
                host_ok = e_host_out <= TOL["float32"][0] \
                    and e_host_grad <= BWD_TOL["float32"]
            else:
                host_ok = max(e_host_out, e_host_grad) <= ND_BF16_HOST_TOL
            ok = out_ok and e_grad <= BWD_TOL[dname] and host_ok
            unit = "max abs" if dname == "float32" else "bf16 ulps"
            _log(f"nd attention {label} {dname}: kernel vs plain out "
                 f"{e_out:.3g} ({unit}), grads {e_grad:.3g} (rel); card vs "
                 f"CPU (batch {ND_CPU_BATCH}) out {e_host_out:.3g}, grads "
                 f"{e_host_grad:.3g}" + ("" if ok else "  FAIL"))
            if not ok:
                bad.append(f"{label} {dname}")
    return launches, cases, bad


def _nd_attention_times(torch, tmx, cases, smi):
    """Device ms of one forward and backward of each case (its mean over
    10 in one torch.profiler window), and the flash kernels' share."""
    gpu = tmx.gpu()
    reg = tmx.ops.registry
    for dname in ("float32", "bfloat16"):
        for label, name, arrays, attrs in cases:
            ins, _ = _nd_inputs(tmx, arrays, gpu, dname)

            def step():
                with tmx.autograd.record():
                    out = reg.invoke(reg.get(name), ins, dict(attrs))
                out.backward()

            for _ in range(3):
                step()
            iters = 10
            _, rows = _profiled(torch, lambda: [step() for _ in
                                                range(iters)])
            total = sum(r[0] for r in rows) / iters
            flash = sum(r[0] for r in rows if "flash_" in r[2]) / iters
            _log(f"time nd {label} {dname}: forward+backward device "
                 f"{total:.3f} ms, flash kernels {flash:.3f} ms (share "
                 f"{flash / max(total, 1e-9):.3f}) ({smi})")


def nd_phase(torch, fa, mx, args, smi):
    """The nd phase: (a) the op sweep card vs CPU (_nd_sweep); (b) the
    samplers on the card (_nd_samplers); (c) masked_encdec_att and
    multihead_attention at the zoo transformer's base widths through the
    flash kernels (_nd_attention), with their device times.  Fails on any
    mismatch or failed check, or if the attention ops launched no flash
    forward or backward kernel."""
    from mxnet_tpu_torch.ops import sweep
    tmx = mx["pkg"]
    t0 = time.perf_counter()
    n_ops, bad_ops = _nd_sweep(tmx, sweep)
    t1 = time.perf_counter()
    bad_draws = _nd_samplers(tmx, sweep)
    t2 = time.perf_counter()
    launches, cases, bad_att = _nd_attention(torch, fa, tmx, args)
    t3 = time.perf_counter()
    _nd_attention_times(torch, tmx, cases, smi)
    _log(f"nd: sweep {t1 - t0:.1f} s, samplers {t2 - t1:.1f} s, attention "
         f"{t3 - t2:.1f} s, times {time.perf_counter() - t3:.1f} s; flash "
         f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                  if v))
    want_bwd = "flash_bwd_fused" if fa.bwd_is_fused(
        ND_TRANSFORMER["lq"], ND_TRANSFORMER["lk"]) else "flash_bwd_dq"
    if not launches["flash_fwd"] or not launches[want_bwd]:
        raise AssertionError(f"the attention ops launched no flash kernel: "
                             f"{launches}")
    if bad_ops or bad_draws or bad_att:
        raise AssertionError(f"nd phase: op mismatches {bad_ops}, samplers "
                             f"{bad_draws}, attention {bad_att}")
    return launches, n_ops


# -- the rnn phase: gluon.rnn over the RNN op and the word-level LM -----------

RNN_OP_SHAPE = {"T": 35, "N": 32, "I": 256, "H": 512, "layers": 2}
# card vs CPU, max |err| / max |CPU|, outputs and final states: the nd
# phase's bound for ops that sum (1e-4).  The recurrence carries each
# step's f32 rounding into the next, and cuDNN sums in another order than
# the CPU: on the same inputs one GRU case read 3.3e-7 in one H100 run and
# 8.2e-6 in the next, too near 1e-5 for a bound
RNN_FWD_TOL = 1e-4
RNN_GRAD_TOL = 1e-4     # the same for the gradients
CTC_TOL = 1e-4          # ctc_loss card vs CPU, loss and gradient (the CUDA
                        # backward sums with atomics: not bit-stable)
LM_ORACLE = {"vocab": 1000, "hidden": 128, "layers": 2, "bptt": 35,
             "batch": 4, "steps": 3}
# the medium configuration of MXNet's Gluon word-language-model example
# (example/gluon/word_language_model/README.md: --tied --nhid 650 --emsize
# 650 --dropout 0.5, 2 layers, bptt 35, batch 32, lr 20, clip 0.25) at
# WikiText-2's vocabulary, on a synthetic corpus.  The summed loss's
# gradient is clipped at clip * bptt * batch and Trainer.step takes bptt *
# batch: the per-token mean's gradient clipped at 0.25, as the example's
# recipe means.  With step(batch) the update is bptt = 35 times that, and
# at lr 20 the loss rose from 10.41 to 106.8 in 6 steps on an H100
LM_FULL = {"vocab": 33278, "hidden": 650, "layers": 2, "dropout": 0.5,
           "bptt": 35, "batch": 32, "segments": 20, "lr": 20.0,
           "clip": 0.25}
RNN_FAMILIES = (("cudnn_rnn", ("rnn", "lstm", "gru", "persist")),
                ("gemm", _GEMM_WORDS))


def _lm_corpus(vocab, length, seed):
    """examples/rnn/lstm_lm.py's synthetic corpus: each token is 7 times
    the last plus one of 0-2, mod the vocabulary."""
    rng = np.random.RandomState(seed)
    data = np.zeros(length, np.int64)
    steps = rng.randint(0, 3, length)
    for i in range(1, length):
        data[i] = (data[i - 1] * 7 + steps[i]) % vocab
    return data


def _lm_class(tmx):
    """The Gluon word_language_model's RNNModel (LSTM, tied): dropout on
    the embedding and on the LSTM's output, the decoder sharing the
    embedding's weight."""
    gluon = tmx.gluon

    class RNNModel(gluon.Block):
        def __init__(self, vocab, hidden, layers, dropout, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(
                    vocab, hidden, weight_initializer=tmx.init.Uniform(0.1))
                self.rnn = gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                          input_size=hidden)
                self.decoder = gluon.nn.Dense(vocab, in_units=hidden,
                                              params=self.encoder.params)
            self.hidden = hidden

        def forward(self, inputs, state):
            emb = self.drop(self.encoder(inputs))
            out, state = self.rnn(emb, state)
            out = self.drop(out)
            return self.decoder(out.reshape((-1, self.hidden))), state

        def begin_state(self, *args, **kwargs):
            return self.rnn.begin_state(*args, **kwargs)

    return RNNModel


def _lm_step(tmx, net, trainer, loss_fn, x, y, state, max_norm, tokens):
    """One step of the example's loop: the state detached, SoftmaxCE
    summed by backward, clip_global_norm, Trainer.step(tokens)."""
    state = [s.detach() for s in state]
    with tmx.autograd.record():
        out, state = net(x, state)
        loss = loss_fn(out, y.reshape((-1,)))
    loss.backward()
    tmx.gluon.utils.clip_global_norm(
        [p.grad() for p in net.collect_params().values()], max_norm)
    trainer.step(tokens)
    return loss, state


def _rnn_op_case(tmx, mode, bidirectional, ctx, arrays):
    """The RNN op on ``ctx``: outputs (out, h, c) and the gradients of
    sum(out * w) + sum(states) w.r.t. data, parameters and states."""
    nd = tmx.nd
    S = RNN_OP_SHAPE
    ins = [nd.array(a, ctx=ctx) for a in arrays]
    for a in ins:
        a.attach_grad()
    w = nd.array(np.cos(np.arange(arrays[0].shape[0] * arrays[0].shape[1]
                                  * S["H"] * (2 if bidirectional else 1)))
                 .astype(np.float32).reshape(arrays[0].shape[0],
                                             arrays[0].shape[1], -1),
                 ctx=ctx)
    with tmx.autograd.record():
        outs = nd.RNN(*ins, state_size=S["H"], num_layers=S["layers"],
                      mode=mode, bidirectional=bidirectional,
                      state_outputs=True)
        head = (outs[0] * w).sum() + sum(o.sum() for o in outs[1:])
    head.backward()
    return [o._data for o in outs], [a.grad._data for a in ins]


def _rnn_ops(torch, tmx, args):
    """(a) The RNN op, each mode, uni- and bidirectional, 2 layers, at
    RNN_OP_SHAPE in f32 on the card against the CPU; one profiled call per
    mode must run through cuDNN (``aten::_cudnn_rnn``) and its kernels are
    printed.  Returns {case: (fwd err, grad err, device ms)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops.nn import rnn_infer
    S = RNN_OP_SHAPE
    rng = np.random.RandomState(args.seed + 13)
    results = {}
    for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu"):
        for bi in (False, True):
            d = 2 if bi else 1
            size = rnn_infer([(S["T"], S["N"], S["I"]), None], {
                "mode": mode, "state_size": S["H"],
                "num_layers": S["layers"], "bidirectional": bi})[1][0]
            arrays = [rng.randn(S["T"], S["N"], S["I"]),
                      rng.uniform(-1, 1, size) / np.sqrt(S["H"]),
                      rng.randn(S["layers"] * d, S["N"], S["H"]) * 0.5]
            if mode == "lstm":
                arrays.append(rng.randn(S["layers"] * d, S["N"], S["H"])
                              * 0.5)
            arrays = [a.astype(np.float32) for a in arrays]
            card, card_g = _rnn_op_case(tmx, mode, bi, tmx.gpu(), arrays)
            host, host_g = _rnn_op_case(tmx, mode, bi, tmx.cpu(), arrays)
            fwd = max(_rel_err(torch, c, h) for c, h in zip(card, host))
            grad = max(_rel_err(torch, c, h)
                       for c, h in zip(card_g, host_g))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _rnn_op_case(tmx, mode, bi, tmx.gpu(), arrays)
                torch.cuda.synchronize()
            ops = {ev.key for ev in prof.key_averages()}
            cuda = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA
                    and not ev.key.startswith(("Memcpy", "Memset"))]
            kernels = sorted({ev.key[:80] for ev in cuda
                              if any(w in ev.key.lower() for w in
                                     ("rnn", "lstm", "gru", "persist"))})
            dev_ms = sum(getattr(ev, "self_device_time_total",
                                 getattr(ev, "self_cuda_time_total", 0))
                         for ev in cuda) / 1e3
            name = f"{mode}{'_bidirectional' if bi else ''}"
            _log(f"rnn op {name} (T {S['T']}, N {S['N']}, I {S['I']}, H "
                 f"{S['H']}, {S['layers']} layers, f32): card vs CPU "
                 f"outputs/states {fwd:.2e} (tol {RNN_FWD_TOL}), gradients "
                 f"{grad:.2e} (tol {RNN_GRAD_TOL}); forward+backward "
                 f"device {dev_ms:.3f} ms; cuDNN: "
                 f"{'aten::_cudnn_rnn' in ops}; kernels {kernels}")
            if not (fwd <= RNN_FWD_TOL and grad <= RNN_GRAD_TOL):
                raise AssertionError(f"RNN op {name}: card vs CPU {fwd}, "
                                     f"gradients {grad}")
            if "aten::_cudnn_rnn" not in ops or not kernels:
                raise AssertionError(f"RNN op {name} did not run cuDNN's "
                                     f"RNN kernels: {sorted(ops)[:20]}")
            results[name] = (fwd, grad, dev_ms)
    return results


def _ctc_check(torch, tmx, args):
    """(b) ctc_loss (blank 'first', with lengths) and gluon CTCLoss (NTC,
    blank 'last', label lengths) on the card against the CPU: losses and
    the gradients of the logits within CTC_TOL of max |CPU|."""
    rng = np.random.RandomState(args.seed + 14)
    T, N, C, L = 50, 32, 30, 20
    data = rng.randn(T, N, C).astype(np.float32)
    lab_len = rng.randint(5, L + 1, N)
    dat_len = rng.randint(2 * L + 1, T + 1, N)
    first = np.zeros((N, L), np.float32)
    last = np.full((N, L), -1, np.float32)
    for i, n in enumerate(lab_len):
        first[i, :n] = rng.randint(1, C, n)
        last[i, :n] = rng.randint(0, C - 1, n)

    def op(ctx):
        nd = tmx.nd
        x = nd.array(data, ctx=ctx)
        x.attach_grad()
        with tmx.autograd.record():
            loss = nd.ctc_loss(x, nd.array(first, ctx=ctx),
                               nd.array(dat_len.astype(np.float32), ctx=ctx),
                               nd.array(lab_len.astype(np.float32), ctx=ctx),
                               use_data_lengths=True, use_label_lengths=True,
                               blank_label="first")
        loss.backward()
        return loss._data, x.grad._data

    def layer(ctx):
        nd = tmx.nd
        x = nd.array(data.transpose(1, 0, 2).copy(), ctx=ctx)
        x.attach_grad()
        fn = tmx.gluon.loss.CTCLoss()
        with tmx.autograd.record():
            loss = fn(x, nd.array(last, ctx=ctx), None,
                      nd.array(lab_len.astype(np.float32), ctx=ctx))
        loss.backward()
        return loss._data, x.grad._data

    for name, fn in (("ctc_loss op", op), ("gluon CTCLoss", layer)):
        card, host = fn(tmx.gpu()), fn(tmx.cpu())
        errs = [_rel_err(torch, c, h) for c, h in zip(card, host)]
        _log(f"rnn {name} (T {T}, N {N}, C {C}, labels up to {L}): card vs "
             f"CPU loss {errs[0]:.2e}, gradient {errs[1]:.2e} (tol "
             f"{CTC_TOL}); mean loss {float(host[0].detach().mean()):.4f}")
        if not (max(errs) <= CTC_TOL and bool(torch.isfinite(card[0]).all())):
            raise AssertionError(f"{name}: card vs CPU {errs}")


def _lm_oracle(torch, tmx, args):
    """(c) The tied LM at LM_ORACLE (dropout 0) trains 3 steps on the card
    and on the CPU from the same weights, carried by name: per-step losses
    within TRAIN_TOL relative."""
    from mxnet_tpu_torch import convert
    c = LM_ORACLE
    RNNModel = _lm_class(tmx)
    corpus = _lm_corpus(c["vocab"], c["bptt"] * c["steps"] * c["batch"]
                        + c["batch"], args.seed + 15)
    batches = corpus.reshape(c["batch"], -1).T.astype(np.float32)
    host = RNNModel(c["vocab"], c["hidden"], c["layers"], 0.0,
                    prefix="lm_oracle_")
    tmx.random.seed(args.seed + 16)
    host.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    card = convert.load_by_name(
        RNNModel(c["vocab"], c["hidden"], c["layers"], 0.0,
                 prefix="lm_oracle_"),
        {k: p.data().asnumpy() for k, p in host.collect_params().items()},
        device="cuda")
    losses = {}
    for ctx, net in ((tmx.gpu(), card), (tmx.cpu(), host)):
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": LM_FULL["lr"]})
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        state = net.begin_state(batch_size=c["batch"], ctx=ctx)
        out = []
        for i in range(c["steps"]):
            b = c["bptt"]
            x = tmx.nd.array(batches[i * b:(i + 1) * b], ctx=ctx)
            y = tmx.nd.array(batches[i * b + 1:(i + 1) * b + 1], ctx=ctx)
            loss, state = _lm_step(tmx, net, trainer, loss_fn, x, y, state,
                                   LM_FULL["clip"] * b * c["batch"],
                                   b * c["batch"])
            out.append(float(loss.mean().asscalar()))
        losses[ctx] = out
    rel = _rel(losses[tmx.gpu()], losses[tmx.cpu()])
    _log(f"rnn oracle tied LM (vocab {c['vocab']}, {c['layers']} x "
         f"{c['hidden']}, bptt {c['bptt']}, batch {c['batch']}, dropout 0, "
         f"SGD lr {LM_FULL['lr']}, clip): card losses "
         f"{[round(v, 5) for v in losses[tmx.gpu()]]}, CPU "
         f"{[round(v, 5) for v in losses[tmx.cpu()]]}, rel {rel:.2e} (tol "
         f"{TRAIN_TOL})")
    if not rel <= TRAIN_TOL:
        raise AssertionError(f"LM oracle: card vs CPU rel {rel}")


def _lm_flops(c):
    """Forward FLOPs of one BPTT segment: the LSTM's 2 (4H H + 4H H) per
    token and layer (every layer's input is H wide: emsize = nhid), and
    the tied decoder's 2 H vocab per token."""
    tokens, H = c["bptt"] * c["batch"], c["hidden"]
    lstm = c["layers"] * tokens * 2 * (4 * H * H + 4 * H * H)
    return lstm, tokens * 2 * H * c["vocab"]


def _lm_full(torch, tmx, args, smi):
    """(d) The tied LM at LM_FULL on the card: 20 BPTT segments, the state
    carried and detached, clip_global_norm(0.25 bptt batch), SGD lr 20,
    step(bptt batch); losses finite and falling (the mean of the last 5
    below the first 5's); one Parameter for the tied weight; step ms,
    tokens/s, MFU, peak memory, idle share and device time by family."""
    c = LM_FULL
    gpu = tmx.gpu()
    RNNModel = _lm_class(tmx)
    net = RNNModel(c["vocab"], c["hidden"], c["layers"], c["dropout"],
                   prefix="lm_")
    tmx.random.seed(args.seed + 17)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    params = net.collect_params()
    n_values = sum(math.prod(p.shape) for p in params.values())
    if net.decoder.weight is not net.encoder.weight:
        raise AssertionError("the decoder is not tied to the embedding")
    n_tok = c["bptt"] * c["segments"] * c["batch"] + c["batch"]
    corpus = _lm_corpus(c["vocab"], n_tok, args.seed + 18)
    batches = corpus.reshape(c["batch"], -1).T.astype(np.float32)
    batches = tmx.nd.array(batches, ctx=gpu)
    trainer = tmx.gluon.Trainer(params, "sgd", {"learning_rate": c["lr"]})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    state = net.begin_state(batch_size=c["batch"], ctx=gpu)
    b, max_norm = c["bptt"], c["clip"] * c["bptt"] * c["batch"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(c["segments"]):
        x, y = batches[i * b:(i + 1) * b], batches[i * b + 1:(i + 1) * b + 1]
        t = time.perf_counter()
        loss, state = _lm_step(tmx, net, trainer, loss_fn, x, y, state,
                               max_norm, b * c["batch"])
        losses.append(float(loss.mean().asscalar()))
        ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    lstm_f, dec_f = _lm_flops(c)
    step_flops = 3 * (lstm_f + dec_f)
    med = statistics.median(ms[2:])
    tokens = b * c["batch"]
    holder = {"state": state}

    def one_step():
        x, y = batches[:b], batches[1:b + 1]
        _, holder["state"] = _lm_step(tmx, net, trainer, loss_fn, x, y,
                                      holder["state"], max_norm,
                                      b * c["batch"])

    prof = _profile_step(torch, one_step, "rnn_lm_full", RNN_FAMILIES)
    # the LSTM layer alone, forward and backward at the LM's shape
    emb = tmx.nd.array(np.random.RandomState(args.seed).randn(
        b, c["batch"], c["hidden"]).astype(np.float32), ctx=gpu)

    def lstm_alone():
        with tmx.autograd.record():
            out, _ = net.rnn(emb, [s.detach() for s in holder["state"]])
        out.backward()

    lstm_ms, lstm_kernels = _device_ms(torch, lstm_alone, iters=5)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    _log(f"rnn lm full width: vocab {c['vocab']}, emsize = nhid = "
         f"{c['hidden']}, {c['layers']} layers, dropout {c['dropout']}, "
         f"tied, bptt {b}, batch {c['batch']}, f32; {len(params)} "
         f"Parameters, {n_values} values; {(lstm_f + dec_f) / 1e9:.2f} "
         f"GFLOP forward ({lstm_f / 1e9:.2f} LSTM, {dec_f / 1e9:.2f} "
         f"decoder), {step_flops / 1e9:.2f} GFLOP per step")
    _log(f"rnn lm full width: losses {[round(v, 4) for v in losses]}; "
         f"step ms {[round(t, 2) for t in ms]}")
    _log(f"rnn lm full width: median step {med:.2f} ms (steps 3-"
         f"{c['segments']}), {tokens / (med / 1e3):.0f} tokens/s, MFU "
         f"{step_flops / (med / 1e3) / PEAK_FLOPS['float32']:.4f} (f32 "
         f"peak {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s), peak "
         f"{peak:.2f} GiB; the LSTM alone (forward+backward, device) "
         f"{lstm_ms:.3f} ms ({smi})")
    _log(f"rnn lm full width: LSTM kernels {lstm_kernels[:8]}")
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"full-width LM: losses {losses} not finite "
                             f"and falling")
    return {"step_ms": med, "tokens_per_s": tokens / (med / 1e3),
            "mfu": step_flops / (med / 1e3) / PEAK_FLOPS["float32"],
            # device time of one profiled step over the unprofiled median
            # (the profiler's own host work inflates the profiled wall)
            "peak_gib": peak, "idle_share": max(
                0.0, 1 - prof["device_ms"] / med),
            "families": prof["families"], "lstm_ms": lstm_ms,
            "losses": losses}


def rnn_phase(torch, fa, mx, args, smi):
    """The rnn phase: (a) the RNN op card vs CPU through cuDNN; (b) CTC;
    (c) the small LM oracle; (d) the full-width tied LM.  Fails on any
    mismatch, on a non-cuDNN RNN, on a loss that is not finite and
    falling, or if any flash kernel launched (the LM has no attention).
    Returns the flash counts of the phase (all 0) and the LM's numbers."""
    tmx = mx["pkg"]
    _reset_counts(fa)
    t0 = time.perf_counter()
    _rnn_ops(torch, tmx, args)
    t1 = time.perf_counter()
    _ctc_check(torch, tmx, args)
    _lm_oracle(torch, tmx, args)
    t2 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    lm = _lm_full(torch, tmx, args, smi)
    counts = _counts(fa)
    _log(f"rnn: op checks {t1 - t0:.1f} s, ctc and oracle {t2 - t1:.1f} s, "
         f"full-width LM {time.perf_counter() - t2:.1f} s; flash launches "
         f"{sum(counts.values())}")
    if any(counts.values()):
        raise AssertionError(f"the rnn phase launched flash kernels: "
                             f"{counts}")
    _log(f"train rnn_lm_full: step {lm['step_ms']:.2f} ms, "
         f"{lm['tokens_per_s']:.0f} tokens/s, MFU {lm['mfu']:.4f}, peak "
         f"{lm['peak_gib']:.2f} GiB, idle share {lm['idle_share']:.3f}; "
         f"device ms " + ", ".join(f"{k} {t:.2f}" for k, t in
                                   lm["families"].items()) + f" ({smi})")
    return counts, lm


# -- the det phase: YOLOv3 at full width, the SSD heads, the vision ops -------

DET_YOLO = {"size": 416, "batch": 8, "classes": 80, "steps": 10,
            "max_boxes": 50}
# GluonCV train_yolo3.py's defaults
DET_SGD = {"learning_rate": 0.001, "momentum": 0.9, "wd": 5e-4}
DET_OUT_TOL = 1e-4      # raw outputs card vs CPU, of max |CPU| (f32 sums)
DET_LOSS_TOL = 1e-5     # the loss card vs CPU, relative
DET_OP_TOL = 1e-4       # the vision ops card vs CPU, of max |CPU|
DET_BOX_TOL = 1e-5      # decoded and target coordinates card vs CPU
DET_CPU_ROIS = 32       # rois the CPU recomputes for ROIPooling, roi_align
# MXNet example/ssd symbol/symbol_factory.py, vgg16_reduced at 300
SSD300 = {"maps": (38, 19, 10, 5, 3, 1),
          "sizes": ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                    (.71, .79), (.88, .961)),
          "ratios": ((1, 2, .5), (1, 2, .5, 3, 1 / 3), (1, 2, .5, 3, 1 / 3),
                     (1, 2, .5, 3, 1 / 3), (1, 2, .5), (1, 2, .5)),
          "steps": tuple(v / 300 for v in (8, 16, 32, 64, 100, 300)),
          "batch": 32, "classes": 21}


def _det_labels(rng, B, classes, max_boxes):
    """B images of 1-20 random corner boxes in [0, 1], [cls, x0, y0, x1,
    y1] rows padded to ``max_boxes`` with -1."""
    out = np.full((B, max_boxes, 5), -1.0, np.float32)
    for b in range(B):
        n = rng.randint(1, 21)
        x0, y0 = rng.uniform(0, 0.8, n), rng.uniform(0, 0.8, n)
        x1 = x0 + rng.uniform(0.05, 1.0, n) * (1 - x0)
        y1 = y0 + rng.uniform(0.05, 1.0, n) * (1 - y0)
        out[b, :n] = np.stack([rng.randint(0, classes, n), x0, y0, x1, y1],
                              1)
    return out


def _in_fresh_thread(fn):
    """fn() in a new thread: the Gluon prefix counters start at 0, so a
    net built there is named as another built the same way."""
    import threading
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def _det_yolo(torch, tmx, args, smi):
    """YOLOv3-DarkNet53 (80 classes, the full backbone and three heads) at
    416, batch 8, SGD (GluonCV's defaults), targets from the host
    generator, DET_YOLO["steps"] steps on one batch, f32 then bf16
    (BatchNorm f32, multi-precision SGD): losses finite and falling; the
    f32 net's outputs and loss on one image card vs CPU on the same
    weights; ``yolo3_decode`` on the trained batch card vs CPU.  Returns
    the lanes' numbers."""
    yolo = tmx.gluon.model_zoo.yolo
    c = DET_YOLO
    B, size, classes = c["batch"], c["size"], c["classes"]
    gpu = tmx.gpu()
    rng = np.random.RandomState(args.seed)
    x = rng.randn(B, 3, size, size).astype(np.float32)
    labels = _det_labels(rng, B, classes, c["max_boxes"])
    t0 = time.perf_counter()
    tgt = yolo.YOLOV3TargetGenerator(classes, input_size=size)(labels)
    gen_ms = (time.perf_counter() - t0) * 1e3
    loss_fn = yolo.YOLOV3Loss()
    results = {}
    for dname in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net = _in_fresh_thread(lambda: yolo.yolo3_darknet53(classes=classes))
        tmx.random.seed(args.seed)
        net.initialize(tmx.init.Xavier(), ctx=gpu)
        xs = tmx.nd.array(x, ctx=gpu)
        flops = _net_flops(torch, tmx, net, tmx.nd.array(x[:1], ctx=gpu))
        flops_step = 3 * B * flops
        if dname == "bfloat16":
            net.cast("bfloat16")
            xs = xs.astype("bfloat16")
            if not all(p.data()._data.dtype == torch.float32
                       for k, p in net.collect_params().items()
                       if "batchnorm" in k):
                raise AssertionError("YOLO bf16: BatchNorm is not float32")
        net.hybridize()
        targets = [[tmx.nd.array(t, ctx=gpu) for t in s] for s in tgt]
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(
            DET_SGD, multi_precision=dname == "bfloat16"))

        def step():
            with tmx.autograd.record():
                preds = [p.astype("float32", copy=False) for p in net(xs)]
                loss = loss_fn(tmx.nd, preds, targets)
            loss.backward()
            trainer.step(B)         # train_yolo3.py's step(batch_size)
            return loss

        losses, ms = [], []
        for _ in range(c["steps"]):
            t = time.perf_counter()
            losses.append(step())
            tmx.nd.waitall()
            ms.append((time.perf_counter() - t) * 1e3)
        losses = [float(v.asscalar()) for v in losses]
        prof = _profile_step(torch, step, f"yolo3 {dname}",
                             families=VISION_FAMILIES)
        med = statistics.median(ms[2:])
        r = {"step_ms": med, "images_per_s": B / (med / 1e3),
             "gflop_forward_per_image": flops / 1e9,
             "mfu": flops_step / (med / 1e3) / PEAK_FLOPS[dname],
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"]),
             "families": prof["families"], "losses": losses}
        results[dname] = r
        _log(f"det yolo3_darknet53 {dname}: losses "
             f"{[round(v, 3) for v in losses]}; step ms "
             f"{[round(v, 1) for v in ms]}; median (steps 3-{c['steps']}) "
             f"{med:.2f} ms, {r['images_per_s']:.2f} images/s, "
             f"{flops / 1e9:.4f} GFLOP forward per image, MFU "
             f"{r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}; device ms "
             + ", ".join(f"{k} {v:.2f}" for k, v in prof["families"].items())
             + f" ({smi})")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"YOLO {dname}: losses {losses} not finite "
                                 f"and falling")
        if dname == "float32":
            _det_yolo_oracle(torch, tmx, yolo, net, x, tgt, loss_fn)
        net = trainer = targets = xs = None
    _log(f"det: the host target generator took {gen_ms:.1f} ms for the "
         f"batch")
    return results


def _det_yolo_oracle(torch, tmx, yolo, net, x, tgt, loss_fn):
    """The trained f32 net card vs CPU: one image's raw outputs and loss
    (the training forward), on a CPU net carried the card's weights and
    statistics by name; then ``yolo3_decode`` (topk 100, conf 0.1, nms
    0.45) of the whole batch's predict-mode outputs on the card and of the
    same outputs on the CPU."""
    from mxnet_tpu_torch import convert
    gpu, cpu = tmx.gpu(), tmx.cpu()
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    cpu_net = convert.load_by_name(
        _in_fresh_thread(lambda: yolo.yolo3_darknet53(
            classes=DET_YOLO["classes"])), params, "yolo oracle", "cpu")
    cpu_net.hybridize()
    one = [[t[:1] for t in s] for s in tgt]
    outs = []
    for n, ctx in ((net, gpu), (cpu_net, cpu)):
        with tmx.autograd.record():     # BatchNorm on the batch's statistics
            preds = n(tmx.nd.array(x[:1], ctx=ctx))
            loss = loss_fn(tmx.nd, preds, [[tmx.nd.array(t, ctx=ctx)
                                            for t in s] for s in one])
        outs.append(([p.asnumpy() for p in preds], float(loss.asscalar())))
    (card, card_loss), (host, host_loss) = outs
    err = max(float(np.abs(a - b).max() / np.abs(b).max())
              for a, b in zip(card, host))
    lerr = abs(card_loss - host_loss) / abs(host_loss)
    _log(f"det yolo oracle: raw outputs card vs CPU {err:.3e} of max |CPU| "
         f"(tol {DET_OUT_TOL}), loss {card_loss:.6f} vs {host_loss:.6f} "
         f"({lerr:.3e} relative, tol {DET_LOSS_TOL})")
    if not err <= DET_OUT_TOL or not lerr <= DET_LOSS_TOL:
        raise AssertionError("YOLO card vs CPU disagree")
    preds = net(tmx.nd.array(x, ctx=gpu))
    tmx.nd.waitall()
    t = time.perf_counter()
    size = DET_YOLO["size"]
    det = yolo.yolo3_decode(preds, input_size=size, topk=100)
    det_np = det.asnumpy()
    card_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    want = yolo.yolo3_decode([p.as_in_context(cpu) for p in preds],
                             input_size=size, topk=100).asnumpy()
    cpu_ms = (time.perf_counter() - t) * 1e3
    kept = (det_np[..., 0] >= 0).sum(1)
    same = np.array_equal(det_np[..., 0], want[..., 0]) and \
        np.abs(det_np - want).max() <= DET_BOX_TOL
    _log(f"det yolo3_decode: {det_np.shape}, rows kept per image "
         f"{kept.tolist()}; card {card_ms:.2f} ms (wall, the NMS included) "
         f"vs CPU {cpu_ms:.2f} ms; card == CPU: {same}")
    if not same or kept.sum() == 0:
        raise AssertionError("yolo3_decode: the card's rows are not the "
                             "CPU's")


def _det_time(torch, fn, iters=5):
    """(device ms, wall ms) per call of fn: the profiler's kernel time
    over ``iters`` calls, and the median wall time with a sync."""
    dev, _ = _device_ms(torch, fn, iters)
    wall = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    return dev, statistics.median(wall)


def _det_op(torch, tmx, sweep, label, name, arrays, attrs, smi,
            cpu_arrays=None, exact=False):
    """One op at a published shape: forward (and, when differentiable, the
    gradients of sum(out * w)) on the card and on the CPU from the same
    numpy inputs (``cpu_arrays``, a slice both devices run, where the CPU
    would take too long), within DET_OP_TOL of max |CPU| (``exact``:
    equal); then the card's forward + backward at the full shape timed.
    Returns the error."""
    ca = arrays if cpu_arrays is None else cpu_arrays
    got, got_g = sweep.run(tmx, name, ca, attrs, tmx.gpu())
    want, want_g = sweep.run(tmx, name, ca, attrs, tmx.cpu())
    errs = [sweep.rel_err(g, w) for g, w in zip(got + got_g, want + want_g)]
    err = max(errs) if len(got_g) == len(want_g) else math.inf
    if exact:
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        err = 0.0 if same else math.inf
    op = tmx.ops.registry.get(name)
    ins = [tmx.nd.array(a, ctx=tmx.gpu(), dtype=a.dtype) for a in arrays]
    grad = op.differentiable
    if grad:
        for i, a in enumerate(arrays):
            if a.dtype.kind == "f":
                ins[i].attach_grad()

    def fwd_bwd():
        if not grad:
            return tmx.ops.registry.invoke(op, ins, dict(attrs))
        with tmx.autograd.record():
            out = tmx.ops.registry.invoke(op, ins, dict(attrs))
            outs = out if isinstance(out, list) else [out]
            head = sum(o.sum() for o in outs)
        head.backward()
        return head

    dev, wall = _det_time(torch, fwd_bwd)
    shapes = [tuple(a.shape) for a in arrays]
    _log(f"det op {label} {name} {shapes}: card vs CPU "
         f"{'equal' if exact and err == 0 else f'{err:.3e}'}"
         f"{' (on a slice)' if cpu_arrays is not None else ''}; "
         f"{'forward + backward' if grad else 'forward'} device "
         f"{dev:.3f} ms, wall {wall:.3f} ms ({smi})")
    if not err <= DET_OP_TOL:
        raise AssertionError(f"det op {label}: card vs CPU {err}")
    return err


def _ssd_anchors(tmx, ctx):
    """SSD300's 8,732 anchors: MultiBoxPrior over the six feature maps."""
    c = SSD300
    outs = []
    for fm, sz, ra, st in zip(c["maps"], c["sizes"], c["ratios"],
                              c["steps"]):
        feat = tmx.nd.zeros((1, 1, fm, fm), ctx=ctx)
        outs.append(tmx.nd.contrib.MultiBoxPrior(feat, sizes=sz, ratios=ra,
                                                 steps=(st, st)))
    return tmx.nd.concat(*outs, dim=1)


def _det_ssd(torch, tmx, args, smi):
    """SSD300's multibox path (MXNet example/ssd, vgg16_reduced at 300):
    the anchors, MultiBoxTarget (hard negatives 3:1) and MultiBoxDetection
    (nms 0.45, nms_topk 400) at batch 32 and 21 classes on the card and on
    the CPU: class targets, masks and detection rows equal, loc targets
    within DET_BOX_TOL; device and wall ms of each op."""
    c = SSD300
    rng = np.random.RandomState(args.seed + 1)
    anchors = {ctx: _ssd_anchors(tmx, ctx) for ctx in (tmx.gpu(), tmx.cpu())}
    A = anchors[tmx.cpu()].shape[1]
    if A != 8732 or not np.array_equal(anchors[tmx.gpu()].asnumpy(),
                                       anchors[tmx.cpu()].asnumpy()):
        raise AssertionError(f"SSD300 anchors: {A}, or card != CPU")
    B, K = c["batch"], c["classes"]
    labels = _det_labels(rng, B, K - 1, 20)
    cls_pred = rng.rand(B, K, A).astype(np.float32)
    logits = rng.randn(B, K, A).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc_pred = (rng.randn(B, A * 4) * 0.1).astype(np.float32)
    res = {}
    for ctx in (tmx.gpu(), tmx.cpu()):
        nd = lambda a: tmx.nd.array(a, ctx=ctx)  # noqa: E731
        anc = anchors[ctx]

        def target(anc=anc, nd=nd):
            return tmx.nd.contrib.MultiBoxTarget(
                anc, nd(labels), nd(cls_pred), negative_mining_ratio=3.0)

        def detect(anc=anc, nd=nd):
            return tmx.nd.contrib.MultiBoxDetection(
                nd(prob), nd(loc_pred), anc, nms_threshold=0.45,
                nms_topk=400)

        res[ctx] = ([o.asnumpy() for o in target()], detect().asnumpy())
        if ctx == tmx.gpu():
            t_target = _det_time(torch, target)
            t_detect = _det_time(torch, detect)
    (tg, dg), (tc, dc) = res[tmx.gpu()], res[tmx.cpu()]
    loc_err = float(np.abs(tg[0] - tc[0]).max())
    ok = (loc_err <= DET_BOX_TOL and np.array_equal(tg[1], tc[1])
          and np.array_equal(tg[2], tc[2])
          and np.array_equal(dg[..., 0], dc[..., 0])
          and float(np.abs(dg - dc).max()) <= DET_BOX_TOL)
    _log(f"det ssd300: {A} anchors, batch {B}, {K} classes; MultiBoxTarget "
         f"positives {int((tg[2] > 0).sum())}, hard negatives "
         f"{int((tg[2] == 0).sum())}, loc card vs CPU {loc_err:.3e}, device "
         f"{t_target[0]:.3f} ms, wall {t_target[1]:.3f} ms; "
         f"MultiBoxDetection rows kept {int((dg[..., 0] >= 0).sum())}, "
         f"device {t_detect[0]:.3f} ms, wall {t_detect[1]:.3f} ms (the NMS "
         f"on the card); card == CPU: {ok} ({smi})")
    if not ok:
        raise AssertionError("SSD300 multibox: card != CPU")


def _det_ops(torch, tmx, args, smi):
    """The other detection and sampling ops at their published shapes,
    card vs CPU (``_det_op``)."""
    from mxnet_tpu_torch.ops import sweep
    rng = np.random.RandomState(args.seed + 2)
    f32 = np.float32

    def rois(n, h, w):
        x0, y0 = rng.uniform(0, w - 64, n), rng.uniform(0, h - 64, n)
        x1 = x0 + rng.uniform(32, 400, n)
        y1 = y0 + rng.uniform(32, 300, n)
        return np.stack([np.zeros(n), x0, y0, np.minimum(x1, w - 1),
                         np.minimum(y1, h - 1)], 1).astype(f32)

    # Faster R-CNN's RPN on a 600 x 800 image: stride 16, 9 anchors
    A = 9
    cls = rng.rand(1, 2 * A, 38, 50).astype(f32)
    _det_op(torch, tmx, sweep, "Faster R-CNN RPN", "contrib.Proposal",
            [cls, (rng.randn(1, 4 * A, 38, 50) * 0.2).astype(f32),
             np.array([[600, 800, 1.0]], f32)],
            {"scales": (8, 16, 32), "ratios": (0.5, 1, 2),
             "feature_stride": 16, "rpn_pre_nms_top_n": 6000,
             "rpn_post_nms_top_n": 300, "threshold": 0.7,
             "output_score": True}, smi)
    feat = rng.randn(1, 1024, 38, 50).astype(f32)
    r300 = rois(300, 600, 800)
    for name, pooled in (("ROIPooling", (7, 7)),
                         ("contrib.roi_align", (14, 14))):
        _det_op(torch, tmx, sweep, "Faster R-CNN C4 head", name,
                [feat, r300], {"pooled_size": pooled,
                               "spatial_scale": 1 / 16}, smi,
                cpu_arrays=[feat, r300[:DET_CPU_ROIS]])
    _det_op(torch, tmx, sweep, "R-FCN 21 classes", "contrib.PSROIPooling",
            [rng.randn(1, 21 * 49, 38, 50).astype(f32), r300],
            {"spatial_scale": 1 / 16, "output_dim": 21, "pooled_size": 7,
             "group_size": 7}, smi)
    _det_op(torch, tmx, sweep, "Deformable ConvNets",
            "contrib.DeformableConvolution",
            [rng.randn(1, 512, 38, 50).astype(f32),
             (rng.randn(1, 18, 38, 50) * 2).astype(f32),
             (rng.randn(512, 512, 3, 3) * 0.02).astype(f32),
             np.zeros(512, f32)],
            {"kernel": (3, 3), "pad": (1, 1), "num_filter": 512}, smi)
    d1 = rng.randn(8, 256, 48, 64).astype(f32)
    d2 = rng.randn(8, 256, 48, 64).astype(f32)
    _det_op(torch, tmx, sweep, "FlowNetC", "Correlation", [d1, d2],
            {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
             "stride2": 2, "pad_size": 20}, smi,
            cpu_arrays=[d1[:1], d2[:1]])
    theta = np.tile(np.array([[0.9, 0.1, 0.05, -0.1, 0.9, -0.05]], f32),
                    (32, 1)) + (rng.randn(32, 6) * 0.05).astype(f32)
    _det_op(torch, tmx, sweep, "STN", "SpatialTransformer",
            [rng.randn(32, 3, 224, 224).astype(f32), theta],
            {"target_shape": (224, 224)}, smi)


def det_phase(torch, fa, mx, args, smi):
    """The det phase: YOLOv3 trains (_det_yolo), the SSD300 multibox path
    (_det_ssd), the vision ops at their published shapes (_det_ops).  No
    flash kernel launches (none of it has attention).  Returns the flash
    counts of the phase and YOLO's numbers."""
    tmx = mx["pkg"]
    _reset_counts(fa)
    t0 = time.perf_counter()
    yolo = _det_yolo(torch, tmx, args, smi)
    t1 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _det_ssd(torch, tmx, args, smi)
    t2 = time.perf_counter()
    _det_ops(torch, tmx, args, smi)
    counts = _counts(fa)
    _log(f"det: yolo {t1 - t0:.1f} s, ssd {t2 - t1:.1f} s, ops "
         f"{time.perf_counter() - t2:.1f} s; flash launches "
         f"{sum(counts.values())}")
    if any(counts.values()):
        raise AssertionError(f"the det phase launched flash kernels: "
                             f"{counts}")
    return counts, yolo


# -- the moe phase: SparseMoE at Switch-Base-8's widths -----------------------

# google/switch-base-8: d_model 768, d_ff 3072, 8 experts, top-1, capacity
# factor 1.25; 16 sequences of 512 tokens.  The layer's default GELU, not
# Switch's ReLU: with ReLU the f32 pre-activations within rounding of 0
# fall on either side of the kink on each device, and the first expert
# layer's gradients differed by 3.5e-2 of max |CPU| on an H100 (the
# outputs and other gradients by <= 1.5e-6)
MOE = {"units": 768, "hidden": 3072, "experts": 8, "capacity_factor": 1.25,
       "activation": "gelu", "batch": 16, "seq": 512}
MOE_TOL = 1e-5          # outputs and gradients card vs CPU, of max |CPU|


def _moe_dropped(torch, x, gate_w, E, k, C):
    """Token choices dropped at capacity: the layer's routing replayed."""
    probs = torch.softmax(x @ gate_w, -1)
    topi = torch.topk(probs, k, dim=-1).indices
    count = torch.zeros(E, device=x.device)
    dropped = 0
    for j in range(k):
        oh = torch.nn.functional.one_hot(topi[:, j], E).float()
        pos = torch.cumsum(oh, 0) - oh + count
        count = count + oh.sum(0)
        dropped += int(((pos * oh).sum(-1) >= C).sum())
    return dropped


def moe_phase(torch, fa, mx, args, smi):
    """SparseMoE at Switch-Base-8's widths on 8192 tokens, k = 1 (Switch)
    and k = 2 (GShard), f32, hybridized: forward + backward of sum(y w) +
    aux on the card and on the CPU on the same weights: outputs and the
    gradients of every parameter and of the input within MOE_TOL of max
    |CPU|, aux losses equal (MOE_TOL relative), dropped-token counts
    equal; device ms and peak memory."""
    tmx = mx["pkg"]
    from mxnet_tpu_torch.gluon.contrib import SparseMoE
    c = MOE
    rng = np.random.RandomState(args.seed + 3)
    N = c["batch"] * c["seq"]
    # a shared offset skews the router, so that some experts overflow
    x = (rng.randn(c["batch"], c["seq"], c["units"]) + 0.3) \
        .astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    _reset_counts(fa)
    for k in (1, 2):
        def build():
            return SparseMoE(c["units"], c["hidden"], c["experts"],
                             num_experts_per_token=k,
                             capacity_factor=c["capacity_factor"],
                             activation=c["activation"])
        nets = {}
        for ctx in (tmx.gpu(), tmx.cpu()):
            nets[ctx] = _in_fresh_thread(build)
        tmx.random.seed(args.seed)
        nets[tmx.gpu()].initialize(tmx.init.Xavier(), ctx=tmx.gpu())
        for name, p in nets[tmx.gpu()].collect_params().items():
            nets[tmx.cpu()].collect_params()[name].set_data(
                p.data().as_in_context(tmx.cpu()))
        C = nets[tmx.gpu()].capacity(N)
        res = {}
        for ctx, net in nets.items():
            net.hybridize()
            xs = tmx.nd.array(x, ctx=ctx)
            xs.attach_grad()
            w = tmx.nd.array(head, ctx=ctx)

            def run(net=net, xs=xs, w=w):
                with tmx.autograd.record():
                    y, aux = net(xs)
                    loss = (y * w).sum() + aux
                loss.backward()
                return y, aux

            if ctx == tmx.gpu():
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            y, aux = run()
            gate = net.gate_weight.data()._data
            res[ctx] = {
                "y": y.asnumpy(), "aux": float(aux.asscalar()),
                "grads": {"x": xs.grad.asnumpy(), **{
                    n.split("_", 1)[1]: p.grad().asnumpy()
                    for n, p in net.collect_params().items()}},
                "dropped": _moe_dropped(
                    torch, xs._data.reshape(N, -1), gate, c["experts"], k,
                    C)}
            if ctx == tmx.gpu():
                peak = torch.cuda.max_memory_allocated() / 2**30
                dev, wall = _det_time(torch, run)
        g, h = res[tmx.gpu()], res[tmx.cpu()]
        errs = {n: float(np.abs(a - h["grads"][n]).max()
                         / np.abs(h["grads"][n]).max())
                for n, a in g["grads"].items()}
        errs["y"] = float(np.abs(g["y"] - h["y"]).max()
                          / np.abs(h["y"]).max())
        err = max(errs.values())
        aux_err = abs(g["aux"] - h["aux"]) / abs(h["aux"])
        _log(f"moe switch-base-8 k={k}: {N} tokens, capacity {C} a expert, "
             f"dispatch {N * c['experts'] * C * 4 / 1e6:.0f} MB f32; "
             f"dropped {g['dropped']} (CPU {h['dropped']}); aux "
             f"{g['aux']:.6f} (CPU {h['aux']:.6f}); outputs and gradients "
             f"card vs CPU {err:.3e} of max |CPU| (tol {MOE_TOL}; "
             + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
             + "); forward "
             f"+ backward device {dev:.3f} ms, wall {wall:.3f} ms, peak "
             f"{peak:.2f} GiB ({smi})")
        if not err <= MOE_TOL or not aux_err <= MOE_TOL \
                or g["dropped"] != h["dropped"]:
            raise AssertionError(f"SparseMoE k={k}: card != CPU")
    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"the moe phase launched flash kernels: "
                             f"{counts}")
    return counts


# -- the image phase: RecordIO, the codec, ImageRecordIter, the datasets ------

# MXNet's example/image-classification ImageNet recipe packs with
# tools/im2rec.py at shorter side 480, JPEG quality 95 (ImageNet records
# are ~100-200 KB); here 1280 synthetic images of 100 classes from --seed
IMAGE_RECS, IMAGE_SHORT, IMAGE_QUALITY, IMAGE_CLASSES = 1280, 480, 95, 100
IMAGE_ASPECTS = ((4, 3), (3, 4), (3, 2), (1, 1))
IMAGE_BATCH, IMAGE_SIZE = 64, 224
# ImageRecordIter's mean/std in raw RGB units (the recipe's)
IMAGE_RGB_MEAN = (123.68, 116.779, 103.939)
IMAGE_RGB_STD = (58.393, 57.12, 57.375)
# the recipe's SGD (momentum 0.9, wd 1e-4), at the loop phase's rate and
# warmup (LOOP_NAG): from Xavier weights on distinct batches the recipe's
# lr 0.1 raised the loss 5.9 -> 31.1 in 3 steps (batch 16, 96 px) and its
# 0.1 per 256 images (0.025) 5.5 -> 11.9 in 10 (batch 32), where 0.005
# after a 3-step warmup took it 5.59 -> 4.33-4.82 in 12 (batch 64, 224 px;
# CPU runs of this phase's code)
IMAGE_SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}
IMAGE_WARMUP = 3
IMAGE_STEPS = 20            # one epoch of the .rec at batch 64
IMAGE_RATE_BATCHES = 4      # batches timed per decode-throughput reading
LENET_TRAIN, LENET_TEST, LENET_BATCH = 60000, 10000, 100
# MXNet's example/image-classification/train_mnist.py rate (0.05) with
# momentum 0.9: at 0.1 one epoch from Xavier weights diverged on one of
# three sample orders (loss 2.32 -> 53.85, test accuracy 0.10; a CPU run
# of this phase's code) and on the card (2.30 -> 95.16)
LENET_SGD = {"learning_rate": 0.05, "momentum": 0.9}


def _photo(seed, idx):
    """(BGR uint8 image, label) of record ``idx``: shorter side 480 at an
    aspect from IMAGE_ASPECTS; a smooth random field, a colour cast and
    stripes whose colour, angle and frequency the class sets, and grain,
    so that it compresses like a photo and a net can learn the class."""
    rng = np.random.default_rng([seed, idx])
    label = int(rng.integers(IMAGE_CLASSES))
    aw, ah = IMAGE_ASPECTS[int(rng.integers(len(IMAGE_ASPECTS)))]
    h, w = (IMAGE_SHORT, IMAGE_SHORT * aw // ah) if aw >= ah \
        else (IMAGE_SHORT * ah // aw, IMAGE_SHORT)
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    theta = np.pi * (label % 10) / 10
    freq = 2 * np.pi * (2 + label // 10) / 160
    stripes = np.cos(freq * (x * np.cos(theta) + y * np.sin(theta))
                     + rng.uniform(0, 2 * np.pi))
    smooth = np.cos(x * rng.uniform(0.005, 0.03) + rng.uniform(0, 6)) \
        * np.cos(y * rng.uniform(0.005, 0.03) + rng.uniform(0, 6))
    colour = np.random.default_rng([seed, 10**6 + label]) \
        .uniform(-1, 1, 3).astype(np.float32)
    img = (128 + 60 * colour + 30 * stripes[..., None] * colour
           + 30 * smooth[..., None] * rng.uniform(-1, 1, 3)
           + rng.standard_normal((h, w, 3), dtype=np.float32) * 6)
    return np.clip(img, 0, 255).astype(np.uint8), label


def _write_imagenet_rec(tmx, root, seed):
    """The .rec/.idx of IMAGE_RECS records, encoded in parallel threads
    (the codec's encode runs without the GIL); (rec path, seconds,
    bytes)."""
    from concurrent.futures import ThreadPoolExecutor
    rio = tmx.recordio
    rec, idx = os.path.join(root, "train.rec"), os.path.join(root,
                                                             "train.idx")

    def encode(i):
        img, label = _photo(seed, i)
        return rio.pack_img(rio.IRHeader(0, float(label), i, 0), img,
                            quality=IMAGE_QUALITY, img_fmt=".jpg")

    t0 = time.perf_counter()
    w = rio.MXIndexedRecordIO(idx, rec, "w")
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for i, body in enumerate(pool.map(encode, range(IMAGE_RECS))):
            w.write_idx(i, body)
    w.close()
    return rec, time.perf_counter() - t0, os.path.getsize(rec)


def _record_iter(tmx, rec, threads, ctx, seed, resize=-1, shuffle=True):
    m, s = IMAGE_RGB_MEAN, IMAGE_RGB_STD
    return tmx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, IMAGE_SIZE, IMAGE_SIZE),
        batch_size=IMAGE_BATCH, shuffle=shuffle, rand_crop=True,
        rand_mirror=True, mean_r=m[0], mean_g=m[1], mean_b=m[2],
        std_r=s[0], std_g=s[1], std_b=s[2], resize=resize,
        preprocess_threads=threads, seed=seed, ctx=ctx)


def _decode_rate(tmx, rec, threads, seed, resize=-1):
    """ImageRecordIter on the host: the first batch (the pool's start-up
    with it) timed apart, then images/s over IMAGE_RATE_BATCHES batches;
    returns (images/s, first-batch s, the batches as numpy)."""
    it = _record_iter(tmx, rec, threads, tmx.cpu(), seed, resize)
    try:
        t0 = time.perf_counter()
        batches = [next(it)]
        t1 = time.perf_counter()
        batches += [next(it) for _ in range(IMAGE_RATE_BATCHES)]
        t2 = time.perf_counter()
    finally:
        it.close()
    rate = IMAGE_RATE_BATCHES * IMAGE_BATCH / (t2 - t1)
    return rate, t1 - t0, [(b.data[0].asnumpy(), b.label[0].asnumpy())
                           for b in batches]


def _check_decoded_crop(tmx, rec, seed, batches):
    """Record 0 of the first batch against imdecode + crop + mirror +
    normalize at the draws the reference's native lane makes: max |err|
    in raw units (must be <= 1)."""
    from mxnet_tpu_torch.io.io import _mix_seed
    reader = tmx.recordio.MXIndexedRecordIO(rec[:-4] + ".idx", rec, "r")
    order = np.arange(IMAGE_RECS)
    eseed = _mix_seed(seed, 0)
    np.random.RandomState(eseed).shuffle(order)
    _, buf = tmx.recordio.unpack(reader.read_idx(int(order[0])))
    reader.close()
    with tmx.cpu():
        img = tmx.image.imdecode(buf).asnumpy().astype(np.float32)
    rng = np.random.RandomState(_mix_seed(eseed, 0))
    ih, iw = img.shape[:2]
    x0 = rng.randint(0, iw - IMAGE_SIZE + 1)
    y0 = rng.randint(0, ih - IMAGE_SIZE + 1)
    crop = img[y0:y0 + IMAGE_SIZE, x0:x0 + IMAGE_SIZE]
    if rng.rand() < 0.5:
        crop = crop[:, ::-1]
    want = ((crop - np.float32(IMAGE_RGB_MEAN))
            / np.float32(IMAGE_RGB_STD)).transpose(2, 0, 1)
    err = np.abs(batches[0][0][0] - want) \
        * np.float32(IMAGE_RGB_STD).reshape(3, 1, 1)
    return float(err.max())


def _image_train(torch, tmx, rec, args, smi):
    """resnet50_v1 (100 classes, Xavier from --seed, hybridized) trained
    IMAGE_STEPS steps from ImageRecordIter(preprocess_threads=cpu_count,
    ctx=gpu) with SGD IMAGE_SGD after IMAGE_WARMUP warmup steps, in f32
    and then bf16 (net.cast, BatchNorm f32, multi-precision) from the same
    weights; losses must fall.  The same step on one pre-staged batch in
    the same run says how far the decode holds the card back."""
    gpu, B = tmx.gpu(), IMAGE_BATCH
    net = tmx.gluon.model_zoo.get_model("resnet50_v1",
                                        classes=IMAGE_CLASSES)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    flops_img = _net_flops(torch, tmx, net, tmx.nd.zeros(
        (1, 3, IMAGE_SIZE, IMAGE_SIZE), ctx=gpu))
    flops_step = 3 * B * flops_img
    net.hybridize()
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    results = {}
    for dname in ("float32", "bfloat16"):
        for k, p in params.items():
            p.set_data(start[k])
            p.data()._data.grad = None
        if dname == "bfloat16":
            net.cast("bfloat16")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = tmx.gluon.Trainer(params, "sgd", dict(
            IMAGE_SGD, multi_precision=dname == "bfloat16",
            lr_scheduler=tmx.lr_scheduler.FactorScheduler(
                step=10**6, base_lr=IMAGE_SGD["learning_rate"],
                warmup_steps=IMAGE_WARMUP, warmup_begin_lr=0.0)))
        it = _record_iter(tmx, rec, os.cpu_count(), gpu, args.seed)
        try:
            rec_ = {"losses": [], "step_ms": [], "wait_ms": []}
            for _ in range(IMAGE_STEPS):
                t0 = time.perf_counter()
                batch = next(it)
                t1 = time.perf_counter()
                _, loss = _loop_step(tmx, net, batch.data[0],
                                     batch.label[0], trainer, dname, B)
                t2 = time.perf_counter()
                rec_["losses"].append(float(loss.mean().asscalar()))
                rec_["wait_ms"].append((t1 - t0) * 1e3)
                rec_["step_ms"].append((t2 - t0) * 1e3)
            it.reset()

            def iterations(n=3):
                for _ in range(n):
                    b = next(it)
                    _loop_step(tmx, net, b.data[0], b.label[0], trainer,
                               dname, B)

            next(it)
            prof = _profile_step(torch, iterations, f"image_resnet50_"
                                 f"{dname}", VISION_FAMILIES, 3)
            staged = next(it)
        finally:
            it.close()
        x, y = staged.data[0], staged.label[0]
        staged_ms = _timed_ms(tmx, lambda: _loop_step(
            tmx, net, x, y, trainer, dname, B), 8)[2:]
        losses = rec_["losses"]
        lane = f"image_resnet50_{dname}"
        _log(f"lane {lane}: losses {[round(v, 4) for v in losses]}; step "
             f"ms {[round(v, 1) for v in rec_['step_ms']]}; next() ms "
             f"{[round(v, 1) for v in rec_['wait_ms']]}")
        if not all(np.isfinite(losses)) \
                or not np.mean(losses[-5:]) < losses[0]:
            raise AssertionError(f"{lane}: losses {losses} not finite, or "
                                 f"the last five steps' mean not below "
                                 f"the first step's loss")
        med = statistics.median(rec_["step_ms"][2:])
        staged_med = statistics.median(staged_ms)
        r = results[lane] = {
            "step_ms": med, "images_per_s": B / (med / 1e3),
            "mfu": flops_step / (med / 1e3) / PEAK_FLOPS[dname],
            "wait_ms": statistics.mean(rec_["wait_ms"][2:]),
            "first_wait_ms": rec_["wait_ms"][0],
            "idle_share": max(0.0, 1 - prof["device_ms"] / med),
            "staged_ms": staged_med,
            "staged_mfu": flops_step / (staged_med / 1e3) / PEAK_FLOPS[dname],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        _log(f"image resnet50_v1 {dname} from the .rec: step "
             f"{r['step_ms']:.2f} ms (median of steps 3-{IMAGE_STEPS}), "
             f"{r['images_per_s']:.1f} images/s, MFU {r['mfu']:.4f} "
             f"({flops_img / 1e9:.4f} GFLOP forward an image, 3x to train), "
             f"next() {r['wait_ms']:.2f} ms (first {r['first_wait_ms']:.1f} "
             f"ms, the pool's start-up with it), idle share "
             f"{r['idle_share']:.3f}; the same step on one pre-staged batch "
             f"{staged_med:.2f} ms (MFU {r['staged_mfu']:.4f}); peak "
             f"{r['peak_gib']:.2f} GiB ({smi})")
        trainer = None
    return results


def _gluon_transform_loader(torch, tmx, rec, smi):
    """ImageRecordDataset with GluonCV's ImageNet train transforms through
    DataLoader(num_workers=cpu_count), one epoch: images/s; no worker
    batch may fall back to this process."""
    t = tmx.gluon.data.vision.transforms
    d = tmx.gluon.data
    n_workers, B = os.cpu_count(), IMAGE_BATCH
    ds = d.vision.ImageRecordDataset(rec).transform_first(t.Compose([
        t.RandomResizedCrop(IMAGE_SIZE), t.RandomFlipLeftRight(),
        t.RandomColorJitter(0.4, 0.4, 0.4), t.RandomLighting(0.1),
        t.ToTensor(), t.Normalize(mean=IMAGENET_MEAN, std=IMAGENET_STD)]))
    before = d.dataloader.fallbacks
    loader = d.DataLoader(ds, batch_size=B, shuffle=True,
                          last_batch="discard", num_workers=n_workers,
                          timeout=60)
    try:
        it = iter(loader)
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        n = 0
        for x, y in it:
            n += 1
        t2 = time.perf_counter()
    finally:
        loader._shutdown_pool()
    if tuple(x.shape) != (B, 3, IMAGE_SIZE, IMAGE_SIZE) \
            or not bool(torch.isfinite(x._data).all()) \
            or d.dataloader.fallbacks != before:
        raise AssertionError(f"Gluon transform loader: batch {x.shape}, "
                             f"{d.dataloader.fallbacks - before} fallbacks")
    rate = n * B / (t2 - t1)
    _log(f"image gluon ImageRecordDataset + RandomResizedCrop, flip, "
         f"ColorJitter(0.4, 0.4, 0.4), Lighting(0.1), ToTensor, Normalize, "
         f"DataLoader(num_workers={n_workers}): {rate:.1f} images/s over "
         f"batches 2-{n + 1} of the epoch (first batch {t1 - t0:.2f} s) "
         f"({smi})")
    return rate


def _decode_pool_loader(tmx, rec, seed, smi):
    """DecodedImageRecordDataset through the DataLoader's decode-pool path
    (cpu_count workers): bit-identical to num_workers=0 and to
    ImageRecordIter(shuffle=False) on the same seed; images/s."""
    from mxnet_tpu_torch.io.io import _mix_seed
    d = tmx.gluon.data
    n_workers, B = os.cpu_count(), IMAGE_BATCH
    n = 4 * B
    m, s = IMAGE_RGB_MEAN, IMAGE_RGB_STD
    dds = d.vision.DecodedImageRecordDataset(
        rec, (3, IMAGE_SIZE, IMAGE_SIZE), rand_crop=True, rand_mirror=True,
        mean=m, std=s, seed=_mix_seed(seed, 0))
    sampler = d.SequentialSampler(n)

    def epoch(workers):
        ld = d.DataLoader(dds, batch_size=B, sampler=sampler,
                          num_workers=workers, timeout=60)
        try:
            t0 = time.perf_counter()
            out = [(a.asnumpy(), b.asnumpy()) for a, b in ld]
            return out, time.perf_counter() - t0, ld._use_decode_pool
        finally:
            ld._shutdown_pool()

    one, t_one, _ = epoch(0)
    pooled, t_pool, used = epoch(n_workers)
    if not used:
        raise AssertionError("DataLoader did not take the decode-pool path")
    it = _record_iter(tmx, rec, 1, tmx.cpu(), seed, shuffle=False)
    try:
        via_iter = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                    for b, _ in zip(it, range(n // B))]
    finally:
        it.close()
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               and np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
               for a, b, c in zip(one, pooled, via_iter))
    _log(f"image gluon DecodedImageRecordDataset, decode-pool DataLoader("
         f"num_workers={n_workers}): {n / t_pool:.1f} images/s over {n} "
         f"images with the pool's start-up ({n / t_one:.1f} with "
         f"num_workers=0); batches bit-identical to num_workers=0 and to "
         f"ImageRecordIter on the same seed: {same} ({smi})")
    if not same or len(one) != n // B:
        raise AssertionError("the decode-pool loader is not bit-identical")
    return n / t_pool


def _write_mnist(root, seed):
    """A learnable MNIST in idx-ubyte: each class a fixed random stroke
    pattern (smoothed), shifted by up to 3 pixels, with noise."""
    rng = np.random.default_rng(seed)
    protos = rng.random((10, 20, 20)) < 0.18
    k = np.ones(3, np.float32) / 3
    protos = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1,
                                 protos.astype(np.float32))
    protos = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 2,
                                 protos)
    protos /= protos.max(axis=(1, 2), keepdims=True)
    for prefix, n in (("train", LENET_TRAIN), ("t10k", LENET_TEST)):
        labels = rng.integers(0, 10, n).astype(np.uint8)
        imgs = np.zeros((n, 28, 28), np.float32)
        dx, dy = rng.integers(0, 9, n), rng.integers(0, 9, n)
        for i in range(n):
            imgs[i, dy[i]:dy[i] + 20, dx[i]:dx[i] + 20] = protos[labels[i]]
        imgs = imgs * 255 * rng.uniform(0.6, 1.0, (n, 1, 1)) \
            + rng.normal(0, 20, imgs.shape)
        imgs = np.clip(imgs, 0, 255).astype(np.uint8)
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(np.array([2051, n, 28, 28], ">u4").tobytes()
                    + imgs.tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(np.array([2049, n], ">u4").tobytes() + labels.tobytes())


def _lenet(tmx):
    """MXNet's example/image-classification/symbols/lenet.py in gluon.nn."""
    nn = tmx.gluon.nn
    net = nn.HybridSequential(prefix="lenet_")
    with net.name_scope():
        net.add(nn.Conv2D(20, 5, activation="tanh"),
                nn.MaxPool2D(2, 2),
                nn.Conv2D(50, 5, activation="tanh"),
                nn.MaxPool2D(2, 2),
                nn.Flatten(),
                nn.Dense(500, activation="tanh"),
                nn.Dense(10))
    return net


def _lenet_mnist(torch, tmx, root, args, smi):
    """LeNet one epoch on the synthetic MNIST: MNIST(root).transform_first(
    ToTensor()), DataLoader(batch 100, 4 workers), SGD LENET_SGD; test
    accuracy must exceed 0.9."""
    _write_mnist(root, args.seed)
    v, gpu = tmx.gluon.data.vision, tmx.gpu()
    train = v.MNIST(root).transform_first(v.transforms.ToTensor())
    test = v.MNIST(root, train=False).transform_first(
        v.transforms.ToTensor())
    net = _lenet(tmx)
    tmx.random.seed(args.seed)
    net.initialize(tmx.init.Xavier(), ctx=gpu)
    net.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", LENET_SGD)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    dl = tmx.gluon.data.dataloader
    before = dl.fallbacks
    np.random.seed(args.seed)           # the sampler's order
    loader = tmx.gluon.data.DataLoader(train, batch_size=LENET_BATCH,
                                       shuffle=True, num_workers=4,
                                       timeout=60)
    ms, losses = [], []
    try:
        t0 = time.perf_counter()
        last = t0
        for x, y in loader:
            with tmx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(LENET_BATCH)
            losses.append(loss)
            now = time.perf_counter()
            ms.append((now - last) * 1e3)
            last = now
        tmx.nd.waitall()
        wall = time.perf_counter() - t0
    finally:
        loader._shutdown_pool()
    first, final = float(losses[0].mean().asscalar()), \
        float(losses[-1].mean().asscalar())
    correct = total = 0
    test_loader = tmx.gluon.data.DataLoader(test, batch_size=1000,
                                            num_workers=4, timeout=60)
    try:
        for x, y in test_loader:
            pred = net(x).argmax(axis=1)
            correct += int((pred == y.astype("float32")).sum().asscalar())
            total += x.shape[0]
    finally:
        test_loader._shutdown_pool()
    acc = correct / total
    med = statistics.median(ms[5:])
    _log(f"image lenet mnist: {len(ms)} steps of {LENET_BATCH} "
         f"({LENET_TRAIN} synthetic images, DataLoader 4 workers): step "
         f"{med:.3f} ms (median), {LENET_TRAIN / wall:.1f} samples/s over "
         f"the epoch ({wall:.2f} s); loss {first:.4f} -> {final:.4f}; test "
         f"accuracy {acc:.4f} over {total} ({smi})")
    if not acc > 0.9 or dl.fallbacks != before:
        raise AssertionError(f"LeNet test accuracy {acc} <= 0.9, or "
                             f"{dl.fallbacks - before} loader fallbacks")
    return {"step_ms": med, "samples_per_s": LENET_TRAIN / wall,
            "accuracy": acc}


def _imresize_card(torch, tmx, seed, smi):
    """imresize of a 375x500 uint8 image for all five interp codes at
    (224, 224) and (341, 256) on the card against the same call on the
    CPU: within 1; device ms of each."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:375, 0:500]
    img = np.clip(np.stack([128 + 100 * np.sin(xx / 9.0 + k)
                            * np.cos(yy / 13.0) for k in range(3)], -1)
                  + rng.randn(375, 500, 3) * 20, 0, 255).astype(np.uint8)
    src_gpu = tmx.nd.array(img, ctx=tmx.gpu())
    src_cpu = tmx.nd.array(img, ctx=tmx.cpu())
    worst = 0
    for w, h in ((224, 224), (341, 256)):
        for interp in range(5):
            got = tmx.image.imresize(src_gpu, w, h, interp)
            want = tmx.image.imresize(src_cpu, w, h, interp)
            err = int(np.abs(got.asnumpy().astype(int)
                             - want.asnumpy()).max())
            worst = max(worst, err)
            dev, _ = _device_ms(torch, lambda: tmx.image.imresize(
                src_gpu, w, h, interp), iters=10)
            _log(f"image imresize 375x500 -> {w}x{h} interp {interp}: card "
                 f"vs CPU max |diff| {err}, device {dev:.4f} ms ({smi})")
    if worst > 1:
        raise AssertionError(f"imresize card vs CPU differs by {worst}")


def image_phase(torch, fa, mx, args, smi):
    """The image phase (the port's data input on the card's machine):
    (1) an ImageNet-shaped .rec written by the port (recordio.pack_img
    through the port's JPEG encoder); (2) the forked-worker loaders:
    ImageRecordDataset with GluonCV's transforms, and LeNet on a
    synthetic MNIST; (3) ImageRecordIter's decode rate at 1, 2, 4 and
    cpu_count threads and on the resize lane, N threads bit-identical to
    1, a decoded crop against imdecode + crop + normalize; (4) resnet50_v1
    trained from the .rec in f32 and bf16, and the decode-pool DataLoader;
    (5) imresize on the card.  No flash kernel launches."""
    tmx = mx["pkg"]
    from mxnet_tpu_torch.io import pipeline
    _reset_counts(fa)
    root = tempfile.mkdtemp(prefix="mx_image_")
    try:
        shm = pipeline.shm_free_bytes()
        slab = (int(os.environ.get("MXNET_IO_PREFETCH", "2")) + 1) \
            * IMAGE_BATCH * (3 * IMAGE_SIZE * IMAGE_SIZE * 4 + 4)
        _log(f"image host: os.cpu_count() {os.cpu_count()}, /dev/shm free "
             f"{shm / 2**20:.1f} MiB (a pipeline's slabs at batch "
             f"{IMAGE_BATCH}: {slab / 2**20:.1f} MiB)")
        t0 = time.perf_counter()
        rec, enc_s, size = _write_imagenet_rec(tmx, root, args.seed)
        _log(f"image .rec: {IMAGE_RECS} records (shorter side "
             f"{IMAGE_SHORT}, JPEG q{IMAGE_QUALITY}, 4:2:0, encoded by the "
             f"port in {os.cpu_count()} threads) in {enc_s:.2f} s: "
             f"{size / 2**20:.1f} MiB, {size / IMAGE_RECS / 1024:.1f} KiB a "
             f"record")
        # the forked-worker loaders first, before any decode pool
        t1 = time.perf_counter()
        gl_rate = _gluon_transform_loader(torch, tmx, rec, smi)
        lenet = _lenet_mnist(torch, tmx, root, args, smi)
        t2 = time.perf_counter()
        rates = {}
        base = None
        for threads in sorted({1, 2, 4, os.cpu_count()}):
            rate, first, batches = _decode_rate(tmx, rec, threads,
                                                args.seed)
            rates[threads] = rate
            if base is None:
                base = batches
                crop_err = _check_decoded_crop(tmx, rec, args.seed, batches)
            same = all(np.array_equal(a[0], b[0])
                       and np.array_equal(a[1], b[1])
                       for a, b in zip(base, batches))
            _log(f"image ImageRecordIter decode {threads} thread(s): "
                 f"{rate:.1f} images/s ({rate / threads:.1f} a thread; "
                 f"first batch {first:.2f} s), batches bit-identical to 1 "
                 f"thread: {same} ({smi})")
            if not same:
                raise AssertionError(f"{threads} threads: batches differ")
        rate, first, _ = _decode_rate(tmx, rec, os.cpu_count(), args.seed,
                                      resize=256)
        rates["resize256"] = rate
        _log(f"image ImageRecordIter resize=256 (decode, shorter-side "
             f"resize, crop) {os.cpu_count()} threads: {rate:.1f} images/s "
             f"(first batch {first:.2f} s) ({smi})")
        _log(f"image decoded crop vs imdecode + crop + normalize: max "
             f"{crop_err:.2e} raw units (bound 1)")
        if not crop_err <= 1.0:
            raise AssertionError(f"decoded crop off by {crop_err} units")
        t3 = time.perf_counter()
        train = _image_train(torch, tmx, rec, args, smi)
        pool_rate = _decode_pool_loader(tmx, rec, args.seed, smi)
        t4 = time.perf_counter()
        _imresize_card(torch, tmx, args.seed, smi)
        t5 = time.perf_counter()
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    counts = _counts(fa)
    _log(f"image: .rec {t1 - t0:.1f} s, gluon loader and lenet "
         f"{t2 - t1:.1f} s, decode rates {t3 - t2:.1f} s, resnet50 and the "
         f"decode-pool loader {t4 - t3:.1f} s, imresize {t5 - t4:.1f} s; "
         f"flash launches {sum(counts.values())}")
    if any(counts.values()):
        raise AssertionError(f"the image phase launched flash kernels: "
                             f"{counts}")
    return counts, {"decode": rates, "train": train, "gluon": gl_rate,
                    "decode_pool": pool_rate, "lenet": lenet}


# -- the util phase: the training utilities on BERT-base ---------------------

# bench.py's bert_seq512 lane (:529-531) at full width: vocab 30522, batch
# 32, seq 512, bf16 with multi-precision Adam; dropout 0 (the checkpoints
# carry no random generator, as the reference's do not)
# BERT-base's widths, its depth cut from 12 layers to 6 (the np phase's
# BERT-base keeps 12: NP_LAYERS)
UTIL = {"layers": 6, "units": 768, "hidden": 3072, "heads": 12,
        "vocab": 30522, "batch": 32, "len": 512, "lr": 1e-4,
        "fused_steps": 3, "curve_steps": 4, "fault_at": 2, "sigterm_at": 1,
        "compress": {"type": "2bit", "threshold": 0.5}}
SPEEDOMETER_TOL = 0.05     # its samples/s against the phase's own clock
TURN_STEPS = 2             # timed steps a turn (after one to warm up)

# the child that shows where an asynchronous CUDA error surfaces: an
# out-of-range gather asserts on the device; NaiveEngine synchronizes after
# the op (the error raises there), the default engine at the next read
_NAIVE_CHILD = r"""
import sys
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import engine
from mxnet_tpu_torch.ops import registry

@registry.register("smoke_gather")
def _gather(x, i):
    return x[i]

engine.set_engine_type(sys.argv[1])
x = mx.nd.ones((4,), ctx=mx.gpu())
i = mx.nd.array([7], ctx=mx.gpu(), dtype="int64")
try:
    y = registry.invoke("smoke_gather", [x, i])
except RuntimeError as e:
    print("raised at the op:", str(e).splitlines()[0])
    sys.exit(0)
try:
    y.asnumpy()
except RuntimeError as e:
    print("raised at the read:", str(e).splitlines()[0])
    sys.exit(0)
print("no error")
sys.exit(1)
"""


def _util_net(torch, tmx, seed, layers=None):
    """BERT-base's widths as Gluon blocks on the card, hybridized, bf16,
    ``layers`` deep (the util phase's UTIL["layers"] by default)."""
    bert = tmx.gluon.model_zoo.bert
    u = UTIL
    net = bert.BERTModel(vocab_size=u["vocab"],
                         num_layers=layers or u["layers"],
                         units=u["units"], hidden_size=u["hidden"],
                         num_heads=u["heads"], max_length=u["len"],
                         dropout=0.0, prefix="bert_")
    tmx.random.seed(seed)
    net.initialize(tmx.init.Normal(0.02), ctx=tmx.gpu())
    net.hybridize()
    net.cast("bfloat16")
    return net


class _UtilRun:
    """The BERT-base steps of the util phase: one net, its start weights,
    one batch; ``step`` runs record, SoftmaxCELoss, backward, then
    optionally records the gradients or replaces them by recorded ones
    (the fused backward's dq sums by atomics, so two backward passes of
    one step differ in the last bits: replaying a run's gradients makes a
    resumed run comparable bit for bit), and Trainer.step."""

    def __init__(self, torch, tmx, net, toks, labs):
        self.torch, self.tmx, self.net = torch, tmx, net
        self.params = net.collect_params()
        self.start = {k: p.data()._data.detach().clone()
                      for k, p in self.params.items()}
        self.inputs, self.labels = _gluon_inputs(tmx, tmx.gpu(), toks, labs)
        self.loss_fn = tmx.gluon.loss.SoftmaxCELoss()

    def restart(self, net=None):
        """The start weights in ``net`` (default this run's), no grads."""
        params = self.params if net is None else net.collect_params()
        for k, p in params.items():
            p.set_data(self.start[k])
            p.data()._data.grad = None

    def trainer(self, net=None, **kw):
        net = self.net if net is None else net
        return self.tmx.gluon.Trainer(
            net.collect_params(), "adam",
            {"learning_rate": UTIL["lr"], "multi_precision": True}, **kw)

    def grads(self, net=None):
        net = self.net if net is None else net
        return [p.list_grad()[0]._data for p in net.collect_params().values()
                if p.grad_req != "null"]

    def step(self, trainer, net=None, record=None, replay=None, before=None):
        """One step; returns (loss, wall ms)."""
        tmx, net = self.tmx, (self.net if net is None else net)
        t = time.perf_counter()
        with tmx.autograd.record():
            logits = net(*self.inputs)[2].astype("float32", copy=False)
            loss = self.loss_fn(logits, self.labels)
        loss.backward()
        if record is not None:
            record.append([g.clone() for g in self.grads(net)])
        if replay is not None:
            self.torch._foreach_copy_(self.grads(net), replay)
        if before is not None:
            before()
        trainer.step(self.labels.shape[0])
        value = float(loss.mean().asscalar())
        tmx.nd.waitall()
        return value, (time.perf_counter() - t) * 1e3

    def weights(self, net=None):
        net = self.net if net is None else net
        return [p.data()._data.detach().clone()
                for p in net.collect_params().values()]


def _same_bits(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _util_fused(torch, tmx, run):
    """Three steps with MXNET_OPTIMIZER_FUSED=1, then three with 0 from the
    same weights on the first run's gradients: the weights must be
    bitwise equal.  Returns the numbers to print."""
    fus = tmx.optimizer_fusion
    out, grads, weights = {}, [], {}
    for fused in ("1", "0"):
        os.environ["MXNET_OPTIMIZER_FUSED"] = fused
        fus.reset()             # the signatures of earlier phases' BERT
        run.restart()
        trainer = run.trainer()
        builds, ms, losses = [fus.exec_builds()], [], []
        for i in range(UTIL["fused_steps"]):
            loss, t = run.step(trainer, record=grads if fused == "1"
                               else None,
                               replay=None if fused == "1" else grads[i])
            losses.append(loss)
            ms.append(t)
            builds.append(fus.exec_builds())
        if (trainer._fused_kind() is not None) != (fused == "1"):
            raise AssertionError(f"fused={fused}: the trainer's route is "
                                 f"{trainer._fused_kind()}")
        weights[fused] = run.weights()
        out[fused] = {"ms": statistics.median(ms), "step_ms": ms,
                      "losses": losses,
                      "exec_builds": [builds[1] - builds[0],
                                      builds[3] - builds[0]]}
    if not _same_bits(torch, weights["1"], weights["0"]):
        raise AssertionError("fused and per-parameter Adam disagree")
    # step ms in turns (fused, per-parameter, per-parameter, fused), each
    # turn a fresh trainer, one step to warm up and TURN_STEPS timed
    turns = {"1": [], "0": []}
    for fused in ("1", "0", "0", "1"):
        os.environ["MXNET_OPTIMIZER_FUSED"] = fused
        run.restart()
        trainer = run.trainer()
        run.step(trainer)
        turns[fused] += [run.step(trainer)[1] for _ in range(TURN_STEPS)]
    os.environ["MXNET_OPTIMIZER_FUSED"] = "1"
    b1, b3 = out["1"]["exec_builds"]
    if b1 != 1 or b3 != 1 or out["0"]["exec_builds"] != [0, 0]:
        raise AssertionError(f"exec_builds not flat: {out}")
    _log(f"util fused: {len(weights['1'])} parameters in one update; "
         f"weights bitwise equal after {UTIL['fused_steps']} steps; "
         f"losses {out['1']['losses']} and {out['0']['losses']}; exec_builds "
         f"after step 1 and 3: {b1}, {b3} (per-parameter: "
         f"{out['0']['exec_builds']}); step ms of those runs: fused "
         f"{[round(x, 1) for x in out['1']['step_ms']]}, per-parameter "
         f"{[round(x, 1) for x in out['0']['step_ms']]}")
    ms = {k: statistics.median(v) for k, v in turns.items()}
    _log(f"util fused: in turns, median of {len(turns['1'])} steps each: "
         f"fused {ms['1']:.2f} ms, per-parameter {ms['0']:.2f} ms")
    return {"fused_ms": ms["1"], "per_param_ms": ms["0"]}


def _util_compression(torch, tmx, run):
    """Trainer(kvstore=local, compression_params=2bit 0.5): one step's
    packed codes and residuals on the card against the same gradient
    compressed on the CPU (equal bytes); step ms against the uncompressed
    store in the same call."""
    from mxnet_tpu_torch.kvstore.compression import GradientCompression
    ms = {False: [], True: []}
    checked = False
    for compressed in (False, True, True, False):       # in turns
        run.restart()
        kw = {"compression_params": UTIL["compress"]} if compressed else {}
        trainer = run.trainer(kvstore=tmx.kv.create("local"), **kw)
        times, seen = [], {}
        run.step(trainer)                     # the store is made here
        for i in range(TURN_STEPS):
            check = compressed and i == 0 and not checked
            if check:
                gc_ = trainer._kvstore._compression
                spy_of = gc_.compress

                def spy(key, slot, grad, _f=spy_of):
                    packed, shape, dtype = _f(key, slot, grad)
                    seen[key] = packed
                    return packed, shape, dtype
                gc_.compress = spy
                host = {}

                def before():
                    for k, p in enumerate(trainer._params):
                        if p.grad_req != "null":
                            host[k] = (
                                p.list_grad()[0]._data.to("cpu", copy=True),
                                gc_._residuals[(k, 0)].to("cpu", copy=True))
            _, t = run.step(trainer, before=before if check else None)
            times.append(t)
            if check:
                gc_.compress = spy_of
                cpu = GradientCompression(UTIL["compress"])
                n_bytes = 0
                for k, (g, res) in host.items():
                    cpu._residuals[(k, 0)] = res
                    packed, _, _ = cpu.compress(k, 0, g)
                    if not torch.equal(packed, seen[k].cpu()) or \
                            not torch.equal(cpu._residuals[(k, 0)],
                                            gc_._residuals[(k, 0)].cpu()):
                        raise AssertionError(f"compression of key {k}: the "
                                             "card and the CPU differ")
                    n_bytes += packed.numel()
                checked = True
                _log(f"util compression: {len(host)} keys, {n_bytes} packed "
                     f"bytes, codes and residuals equal to the CPU's")
        ms[compressed] += times
        if compressed != (trainer._kvstore._compression is not None):
            raise AssertionError("the store's compression is not as asked")
    med = {k: statistics.median(v) for k, v in ms.items()}
    _log(f"util compression: in turns, median of {len(ms[True])} steps "
         f"each: {med[True]:.2f} ms compressed against {med[False]:.2f} ms "
         f"uncompressed (the same store)")
    # where the compressed step's extra time goes: one step of each traced
    trace = {}
    for compressed in (False, True):
        run.restart()
        kw = {"compression_params": UTIL["compress"]} if compressed else {}
        trainer = run.trainer(kvstore=tmx.kv.create("local"), **kw)
        run.step(trainer)
        trace[compressed] = _profile_step(
            torch, lambda tr=trainer: run.step(tr),
            "util " + ("compressed" if compressed else "uncompressed"),
            families=FLASH_FAMILIES + (("optimizer",
                                        ("foreach", "multi_tensor")),))
    extra = {k: trace[True][k] - trace[False][k]
             for k in ("wall_ms", "device_ms", "launches")}
    _log(f"util compression trace: the compressed step against the "
         f"uncompressed one: wall +{extra['wall_ms']:.2f} ms, device busy "
         f"+{extra['device_ms']:.2f} ms, kernels +{extra['launches']:.0f} "
         f"({extra['launches'] / len(host):.1f} a key)")
    return {"compressed_ms": med[True], "uncompressed_ms": med[False],
            "compressed_device_ms": trace[True]["device_ms"],
            "uncompressed_device_ms": trace[False]["device_ms"],
            "compressed_kernels": trace[True]["launches"],
            "uncompressed_kernels": trace[False]["launches"]}


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _util_resume(torch, tmx, run, root):
    """4 uninterrupted steps (their gradients recorded); auto_resume with
    save_every=2 whose train_fn raises once at step 2; a run that sends
    itself SIGTERM during step 1, then a fresh net and trainer resumed
    from its directory.  Every resumed curve equals the uninterrupted one
    bit for bit (each step replays the recorded gradient after its own
    backward).  Then save and restore ms and one step's bytes on disk."""
    import signal
    n = UTIL["curve_steps"]
    ck = tmx.checkpoint
    run.restart()
    trainer = run.trainer()
    grads, ref = [], []
    for _ in range(n):
        ref.append(run.step(trainer, record=grads)[0])
    # the same steps with their own gradients: how far the atomics move
    run.restart()
    trainer = run.trainer()
    own = [run.step(trainer)[0] for _ in range(n)]
    _log(f"util resume: uninterrupted losses {[round(x, 5) for x in ref]}; "
         f"a second run with its own gradients differs by rel "
         f"{_rel(own, ref):.2e} (the fused backward's dq atomics)")
    if not ref[-1] < ref[0]:
        raise AssertionError(f"util: losses not falling: {ref}")

    run.restart()
    trainer = run.trainer()
    curve, faulted = {}, []

    def train_fn(step):
        loss, _ = run.step(trainer, replay=grads[step])
        if step == UTIL["fault_at"] and not faulted:
            faulted.append(step)
            raise RuntimeError("injected fault after the update")
        curve[step] = loss
        return step < n - 1

    d1 = os.path.join(root, "fault")
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        last = ck.auto_resume(train_fn, d1, net=run.net, trainer=trainer,
                              save_every=2, max_to_keep=2)
    got = [curve.get(s) for s in range(n)]
    _log(f"util resume: fault at step {UTIL['fault_at']}: "
         f"{[str(w.message)[:90] for w in caught]}; curve equal: "
         f"{got == ref}; steps kept {ck.CheckpointManager(d1).all_steps()}")
    if last != n - 1 or got != ref or not faulted:
        raise AssertionError(f"resume after a fault: {got} against {ref}")

    run.restart()
    trainer = run.trainer()
    curve = {}

    def make_fn(net, tr, kill_at=None):
        def fn(step):
            loss, _ = run.step(tr, net=net, replay=grads[step])
            curve[step] = loss
            if step == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return step < n - 1
        return fn

    d2 = os.path.join(root, "sigterm")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stop = ck.auto_resume(make_fn(run.net, trainer, UTIL["sigterm_at"]),
                              d2, net=run.net, trainer=trainer, save_every=8,
                              max_to_keep=2)
    fresh = _util_net(torch, tmx, 12345)      # other weights, overwritten
    fresh_trainer = run.trainer(net=fresh)
    last = ck.auto_resume(make_fn(fresh, fresh_trainer), d2, net=fresh,
                          trainer=fresh_trainer, save_every=8,
                          max_to_keep=2)
    got = [curve.get(s) for s in range(n)]
    _log(f"util resume: SIGTERM at step {UTIL['sigterm_at']}: stopped at "
         f"{stop} ({[str(w.message)[:60] for w in caught]}), a fresh net and "
         f"trainer resumed to {last}; joined curve equal: {got == ref}")
    if stop != UTIL["sigterm_at"] or last != n - 1 or got != ref:
        raise AssertionError(f"resume after SIGTERM: {got} against {ref}")
    fresh = fresh_trainer = None

    # one step saved and restored by hand, timed
    mgr = ck.CheckpointManager(os.path.join(root, "timed"), max_to_keep=2)
    want = run.weights()
    torch.cuda.synchronize()
    t = time.perf_counter()
    mgr.save(0, net=run.net, trainer=trainer)
    save_ms = (time.perf_counter() - t) * 1e3
    nbytes = _dir_bytes(os.path.join(root, "timed", "0"))
    run.restart()
    trainer = run.trainer()
    t = time.perf_counter()
    step, _ = mgr.restore(net=run.net, trainer=trainer)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    if step != 0 or not _same_bits(torch, run.weights(), want):
        raise AssertionError("a restored step is not the saved one")
    _log(f"util checkpoint: save {save_ms:.1f} ms, restore "
         f"{restore_ms:.1f} ms, one step on disk {nbytes} bytes "
         f"({nbytes / 1e9:.3f} GB: bf16 weights, the f32 masters and Adam's "
         f"two f32 moments)")
    return {"save_ms": save_ms, "restore_ms": restore_ms,
            "step_bytes": nbytes}


def _util_monitor(torch, tmx, mx, run):
    """Monitor(1, ".*FullyConnected.*") over two eager (not hybridized)
    steps: finite stats for every matching op; nothing after uninstall,
    in a hand-captured CUDA graph (NaiveEngine on: no synchronisation in
    the capture either), or in a captured TrainStep's replays."""
    net, rows = run.net, []
    net.hybridize(active=False)
    trainer = run.trainer()
    mon = tmx.monitor.Monitor(1, pattern=".*FullyConnected.*")
    mon.install()
    for _ in range(2):
        mon.tic()
        run.step(trainer)
        rows.append(mon.toc())
    mon.uninstall()
    mon.activated = True
    run.step(trainer)
    after = mon.toc()
    net.hybridize()
    names = [[r[1] for r in b] for b in rows]
    if not rows[0] or names[0] != names[1] or after or not all(
            math.isfinite(r[2]) for b in rows for r in b):
        raise AssertionError(f"monitor: {len(rows[0])}, {len(rows[1])} rows, "
                             f"{len(after)} after uninstall")

    x = tmx.nd.array(np.ones((64, 768), np.float32), ctx=tmx.gpu())
    w = tmx.nd.array(np.ones((256, 768), np.float32), ctx=tmx.gpu())
    mon.install()
    tmx.engine.set_engine_type("NaiveEngine")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            tmx.nd.FullyConnected(x, w, num_hidden=256, no_bias=True)
        torch.cuda.current_stream().wait_stream(side)
        mon.tic()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = tmx.nd.FullyConnected(x, w, num_hidden=256, no_bias=True)
        graph.replay()
        in_graph = mon.toc()
    finally:
        tmx.engine.set_engine_type("ThreadedEnginePerDevice")
    if in_graph or float(y.asnumpy()[0, 0]) != 768.0:
        raise AssertionError(f"monitor saw {len(in_graph)} rows in a capture")

    tt = torch.tensor(run.inputs[0].asnumpy(), device="cuda")
    tl = torch.tensor(run.labels.asnumpy(), device="cuda")
    step = mx["parallel"].TrainStep(net, _bert_loss(mx["nn"]), mx[
        "optimizer"].Adam(learning_rate=UTIL["lr"], multi_precision=True))
    in_step = []
    for _ in range(3):              # warm-up, capture, replay
        mon.tic()
        step(tt, tl)
        in_step.append(len(mon.toc()))
    torch.cuda.synchronize()
    mon.uninstall()
    step = None
    _log(f"util monitor: {len(rows[0])} FullyConnected outputs a step "
         f"(mean |x| of the first {rows[0][0][2]:.5f}, all finite), the same "
         f"names in both steps; after uninstall {len(after)}; in a captured "
         f"graph {len(in_graph)}; in TrainStep's warm-up, capture and "
         f"replay {in_step}")
    if any(in_step):
        raise AssertionError(f"monitor saw TrainStep's ops: {in_step}")


def _util_speedometer(tmx, run):
    """Speedometer(32, frequent=2) fed BatchEndParam after each of 7 steps:
    its samples/s within SPEEDOMETER_TOL of the phase's own clock over the
    same batches."""
    import logging
    trainer = run.trainer()
    B = UTIL["batch"]
    sp = tmx.callback.Speedometer(B, frequent=2)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    root = logging.getLogger()
    handler, level = Keep(), root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    marks = []
    try:
        for nbatch in range(7):
            if nbatch:
                run.step(trainer)
            marks.append(time.perf_counter())
            sp(tmx.model.BatchEndParam(epoch=0, nbatch=nbatch,
                                       eval_metric=None, locals=None))
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    said = [float(m.split("Speed: ")[1].split()[0]) for m in records
            if "Speed:" in m]
    own = [2 * B / (marks[i] - marks[i - 2]) for i in (2, 4, 6)]
    _log(f"util speedometer: {records}; own samples/s "
         f"{[round(x, 2) for x in own]}")
    if len(said) != 3 or any(abs(s - o) > SPEEDOMETER_TOL * o
                             for s, o in zip(said, own)):
        raise AssertionError(f"Speedometer {said} against {own}")


def _util_engine_runtime(torch, tmx):
    """engine.waitall; NaiveEngine raising at the failing op and the
    default engine at the next read (a child process each: a device-side
    assert ends the CUDA context); runtime.Features()."""
    tmx.engine.waitall()
    here = os.path.dirname(os.path.abspath(__file__))
    said = {}
    for mode in ("NaiveEngine", "ThreadedEnginePerDevice"):
        r = subprocess.run([sys.executable, "-c", _NAIVE_CHILD, mode],
                           cwd=here, capture_output=True, text=True,
                           timeout=300)
        said[mode] = r.stdout.strip().splitlines()[-1:] or [r.stderr[-300:]]
        if r.returncode != 0:
            raise AssertionError(f"{mode} child: {r.returncode} {said[mode]} "
                                 f"{r.stderr[-500:]}")
    if not said["NaiveEngine"][0].startswith("raised at the op") or \
            not said["ThreadedEnginePerDevice"][0].startswith(
                "raised at the read"):
        raise AssertionError(f"engine: {said}")
    feats = tmx.runtime.Features()
    _log(f"util engine: NaiveEngine: {said['NaiveEngine'][0]}; default: "
         f"{said['ThreadedEnginePerDevice'][0]}")
    _log(f"util runtime: {feats}")
    for name, want in (("CUDA", True), ("CUDNN", True), ("TPU", False),
                       ("XLA", False), ("PALLAS", False)):
        if feats.is_enabled(name) != want:
            raise AssertionError(f"runtime feature {name} is not {want}")


def _util_consistency(torch, tmx):
    """check_consistency over [gpu(0), cpu(0)] on FullyConnected,
    LayerNorm and dot with a bf16 first input and f32 others (C.12 on the
    card: float32 outputs within float32's default tolerances)."""
    tu = tmx.test_utils
    r = np.random.RandomState(7)
    x = r.randn(512, 768).astype(np.float32)
    cases = {
        "FullyConnected": (lambda a, w, b: tmx.nd.FullyConnected(
            a.astype("bfloat16"), w, b, num_hidden=3072),
            [x, r.randn(3072, 768).astype(np.float32) * 0.02,
             r.randn(3072).astype(np.float32)]),
        "LayerNorm": (lambda a, g, b: tmx.nd.LayerNorm(
            a.astype("bfloat16"), g, b),
            [x, r.randn(768).astype(np.float32),
             r.randn(768).astype(np.float32)]),
        "dot": (lambda a, b: tmx.nd.dot(a.astype("bfloat16"), b),
                [x, r.randn(768, 1024).astype(np.float32) * 0.02]),
    }
    for name, (f, ins) in cases.items():
        outs = tu.check_consistency(f, ins)
        dt = f(*[tmx.nd.array(a, ctx=tmx.gpu()) for a in ins]).dtype
        if len(outs) != 2 or dt != np.float32:
            raise AssertionError(f"{name}: {len(outs)} contexts, {dt}")
    _log(f"util consistency: {sorted(cases)} with a bf16 first input: "
         f"float32 outputs, gpu(0) within float32's tolerances of cpu(0)")


def _util_custom_op(torch, tmx):
    """A CustomOp with a backward (y = x^2 s) on the card: its gradients
    against the CPU's, which check_numeric_gradient holds to central
    differences."""
    name = "smoke_square_scale"
    if name not in tmx.operator.get_all_registered():
        @tmx.operator.register(name)
        class _Prop(tmx.operator.CustomOpProp):
            def list_arguments(self):
                return ["data", "scale"]

            def create_operator(self, ctx, shapes, dtypes):  # noqa: ARG002
                class Op(tmx.operator.CustomOp):
                    def forward(self, is_train, req, in_data, out_data,
                                aux):  # noqa: ARG002
                        x, s = in_data
                        self.assign(out_data[0], req[0], x * x * s)

                    def backward(self, req, out_grad, in_data, out_data,
                                 in_grad, aux):  # noqa: ARG002
                        x, s = in_data
                        self.assign(in_grad[0], req[0],
                                    2 * x * s * out_grad[0])
                        self.assign(in_grad[1], req[1], x * x * out_grad[0])
                return Op()

    def f(x, s):
        return tmx.nd.Custom(x, s, op_type=name)

    r = np.random.RandomState(3)
    ins = [r.randn(4, 5), r.randn(4, 5)]
    tmx.test_utils.check_numeric_gradient(f, ins, ctx=tmx.cpu(), rtol=1e-4,
                                          atol=1e-6)
    grads = {}
    for ctx in (tmx.gpu(), tmx.cpu()):
        xs = [tmx.nd.array(a, ctx=ctx) for a in ins]
        for v in xs:
            v.attach_grad()
        with tmx.autograd.record():
            y = f(*xs)
        y.backward()
        grads[ctx] = [v.grad.asnumpy() for v in xs]
        if ctx == tmx.gpu() and y._data.device.type != "cuda":
            raise AssertionError("the custom op left the card")
    for g, c in zip(grads[tmx.gpu()], grads[tmx.cpu()]):
        tmx.test_utils.assert_almost_equal(g, c, names=("gpu", "cpu"))
    _log("util custom op: x^2 s on the card, its backward's gradients "
         "equal to the CPU's, which central differences confirm")


def util_phase(torch, fa, mx, args, smi):
    """The training utilities as a user's script drives them, on BERT-base
    at bench.py's bert_seq512 width (vocab 30522, batch 32, seq 512, bf16,
    multi-precision Adam, dropout 0), attention through the flash forward
    and the fused backward: the fused optimizer against the per-parameter
    update, 2-bit compression against the CPU, checkpoint and resume after
    a fault and after SIGTERM, the monitor, the Speedometer, the engine,
    runtime features, check_consistency with mixed dtypes and a CustomOp.
    Returns (launch counts of the BERT steps, numbers)."""
    tmx = mx["pkg"]
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.RandomState(args.seed + 16)
    toks = rng.randint(0, UTIL["vocab"], (UTIL["batch"], UTIL["len"]))
    labs = rng.randint(0, UTIL["vocab"], (UTIL["batch"], UTIL["len"]))
    run = _UtilRun(torch, tmx, _util_net(torch, tmx, args.seed), toks, labs)
    saved_env = os.environ.get("MXNET_OPTIMIZER_FUSED")
    root = tempfile.mkdtemp(prefix="mx_util_")
    numbers = {}
    _reset_counts(fa)
    try:
        numbers.update(_util_fused(torch, tmx, run))
        numbers.update(_util_compression(torch, tmx, run))
        numbers.update(_util_resume(torch, tmx, run, root))
        counts = _counts(fa)
        _util_monitor(torch, tmx, mx, run)
        _util_speedometer(tmx, run)
    finally:
        if saved_env is None:
            os.environ.pop("MXNET_OPTIMIZER_FUSED", None)
        else:
            os.environ["MXNET_OPTIMIZER_FUSED"] = saved_env
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    if os.path.exists(root):
        raise AssertionError(f"{root} is left behind")
    run = None
    gc.collect()
    torch.cuda.empty_cache()
    _util_engine_runtime(torch, tmx)
    _util_consistency(torch, tmx)
    _util_custom_op(torch, tmx)
    _log(f"util launches over the fused, compression and resume steps: "
         f"{counts}")
    if counts["flash_fwd"] < UTIL["layers"] or counts["flash_bwd_fused"] < \
            UTIL["layers"] or counts["flash_bwd_fused"] % UTIL["layers"] \
            or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"] \
            or counts["flash_fwd_f32"] or counts["flash_bwd_fused_f32"]:
        raise AssertionError(f"util: launches {counts}")
    _log(f"util numbers ({smi}): " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in numbers.items()))
    return counts, numbers


# -- sym: the symbolic API ----------------------------------------------------

# the post-LN encoder at BERT-base's widths (bench.py:529-531) built from
# mx.sym ops; the oracle, multi-context and bucketing legs cut its depth and
# batch, the train leg runs it at full width
SYM = {"layers": 12, "units": 768, "heads": 12, "ffn": 3072,
       "vocab": 30522, "batch": 32, "len": 512, "min_len": 384,
       "oracle_layers": 2, "oracle_batch": 2, "batches": 4, "epochs": 2,
       "lr": 1e-4, "serve_batch": 8, "rebind_batch": 4}
SYM_LOSS_TOL = 1e-4     # relative, the oracle's loss card vs CPU (f32)
SYM_ORACLE_TOL = 1e-3   # of max |CPU|, each output and gradient (f32)
SYM_SERVE_TOL = 1e-4    # of max |ref|: SymbolBlock against Module.predict
SYM_BF16_TOL = 2**-5    # of max |f32 logits|: the bf16 serve's logits


def _sym_encoder(sym, name, layers):
    """The encoder as a Symbol: token and position Embedding, LayerNorm,
    ``layers`` post-LN blocks (interleaved qkv, ``contrib.masked_selfatt``
    with ``valid_length``, GELU FFN), a head over every position into
    SoftmaxOutput; its args are data (B, L), valid_length (B,) and
    softmax_label (B, L)."""
    s = SYM
    U = s["units"]
    with name.NameManager():
        data, vl = sym.var("data"), sym.var("valid_length")
        tok = sym.Embedding(data, input_dim=s["vocab"], output_dim=U,
                            name="word_embed")
        pos = sym.Embedding(sym.contrib.arange_like(data, axis=1),
                            input_dim=s["len"], output_dim=U,
                            name="pos_embed")
        x = sym.LayerNorm(sym.broadcast_add(tok, pos), name="embed_ln")
        x = sym.transpose(x, axes=(1, 0, 2))
        for i in range(layers):
            qkv = sym.FullyConnected(x, num_hidden=3 * U, flatten=False,
                                     name=f"l{i}_qkv")
            att = sym.contrib.masked_selfatt(qkv, vl, heads=s["heads"],
                                             name=f"l{i}_att")
            proj = sym.FullyConnected(att, num_hidden=U, flatten=False,
                                      name=f"l{i}_proj")
            x = sym.LayerNorm(x + proj, name=f"l{i}_ln1")
            h = sym.FullyConnected(x, num_hidden=s["ffn"], flatten=False,
                                   name=f"l{i}_ffn1")
            h = sym.LeakyReLU(h, act_type="gelu", name=f"l{i}_gelu")
            h = sym.FullyConnected(h, num_hidden=U, flatten=False,
                                   name=f"l{i}_ffn2")
            x = sym.LayerNorm(x + h, name=f"l{i}_ln2")
        x = sym.transpose(x, axes=(1, 0, 2))
        logits = sym.FullyConnected(x, num_hidden=s["vocab"], flatten=False,
                                    name="head")
        return sym.SoftmaxOutput(logits, name="softmax")


def _sym_flops(B, L, layers):
    """FLOPs of one training step counted from the graph's layers: the
    forward's matmuls (qkv, projection, FFN, the head over every position)
    and attention's two products over the full length, 3x for forward and
    backward."""
    s = SYM
    U, F, V = s["units"], s["ffn"], s["vocab"]
    per_token = layers * (2 * (4 * U * U + 2 * U * F) + 4 * L * U) \
        + 2 * U * V
    return 3 * B * L * per_token


def _sym_batch(rng, B, L, lo):
    """Token ids, valid lengths in [lo, L] and labels (the tokens
    themselves: a copy task the loss can fall on), float32."""
    toks = rng.randint(0, SYM["vocab"], (B, L)).astype(np.float32)
    lens = rng.randint(lo, L + 1, (B,)).astype(np.float32)
    return toks, lens, toks.copy()


def _sym_params(sym, shapes, seed):
    """Normal(0.02) weights, unit norm scales, zero shifts and biases, as
    numpy, for every argument that is not an input."""
    rng = np.random.RandomState(seed)
    args, _, _ = sym.infer_shape(**shapes)
    out = {}
    for n, shp in zip(sym.list_arguments(), args):
        if n in shapes:
            continue
        if n.endswith("gamma"):
            out[n] = np.ones(shp, np.float32)
        elif n.endswith(("beta", "bias")):
            out[n] = np.zeros(shp, np.float32)
        else:
            out[n] = (0.02 * rng.standard_normal(shp)).astype(np.float32)
    return out


def _sym_loss(torch, probs, labels):
    """Mean cross entropy of SoftmaxOutput's probabilities, on their
    device."""
    lab = labels.to(probs.device).long().unsqueeze(-1)
    return float(-torch.log(probs.gather(-1, lab).clamp_min(1e-30)).mean())


def _rel_to_max(torch, got, ref):
    """max |got - ref| over max |ref|, on ref's device, in float32."""
    ref = ref.detach().float()
    got = got.detach().to(ref.device, torch.float32)
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _sym_oracle(torch, tmx, seed):
    """The 2-layer graph through an Executor on the card and on the CPU
    from the same parameters: loss, outputs and every gradient; and its
    ``Symbol.eval`` of the numpy inputs with ``ctx=gpu(0)``."""
    B, L = SYM["oracle_batch"], SYM["len"]
    sym = _sym_encoder(tmx.sym, tmx.name, SYM["oracle_layers"])
    shapes = {"data": (B, L), "valid_length": (B,), "softmax_label": (B, L)}
    params = _sym_params(sym, shapes, seed)
    toks, lens, labs = _sym_batch(np.random.RandomState(seed + 1), B, L,
                                  SYM["min_len"])
    feed = dict(params, data=toks, valid_length=lens, softmax_label=labs)
    runs = []
    for ctx in (tmx.gpu(0), tmx.cpu()):
        ex = sym.simple_bind(ctx, **shapes)
        ex.copy_params_from({k: tmx.nd.array(v, ctx=ctx)
                             for k, v in feed.items()})
        (out,) = ex.forward(is_train=True)
        ex.backward()
        runs.append((_sym_loss(torch, out._data, torch.from_numpy(labs)),
                     out._data, {k: g._data for k, g in ex.grad_dict.items()
                                 if k in params}))
    (gl, go, gg), (cl, co, cg) = runs
    # Symbol.eval of numpy inputs with ctx=gpu(0) runs on the card
    (ev,) = sym.eval(ctx=tmx.gpu(0), **feed)
    eval_dev = ev._data.device.type
    eval_err = _rel_to_max(torch, ev._data, co)
    loss_err = abs(gl - cl) / abs(cl)
    out_err = _rel_to_max(torch, go, co)
    grad_err = {k: _rel_to_max(torch, gg[k], cg[k]) for k in cg}
    worst = max(grad_err, key=grad_err.get)
    _log(f"sym oracle ({SYM['oracle_layers']} layers, B {B}, L {L}, f32, "
         f"TF32 {torch.backends.cuda.matmul.allow_tf32}): loss card "
         f"{gl:.6f} CPU {cl:.6f} (rel {loss_err:.2e}), outputs {out_err:.2e}"
         f", gradients worst {worst} {grad_err[worst]:.2e} of max |CPU| "
         f"over {len(grad_err)}; eval of numpy inputs on {eval_dev} "
         f"{eval_err:.2e}")
    if torch.backends.cuda.matmul.allow_tf32 or loss_err > SYM_LOSS_TOL \
            or out_err > SYM_ORACLE_TOL or grad_err[worst] > SYM_ORACLE_TOL \
            or eval_dev != "cuda" or eval_err > SYM_ORACLE_TOL:
        raise AssertionError("sym oracle: card and CPU disagree")
    return sym, params


def _sym_module(tmx, sym, context, B, params, opt):
    mod = tmx.mod.Module(sym, data_names=("data", "valid_length"),
                         label_names=("softmax_label",), context=context)
    mod.bind(data_shapes=[("data", (B, SYM["len"])),
                          ("valid_length", (B,))],
             label_shapes=[("softmax_label", (B, SYM["len"]))])
    ctx = context[0] if isinstance(context, list) else context
    mod.init_params(arg_params={k: tmx.nd.array(v, ctx=ctx)
                                for k, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
    return mod


def _sym_databatch(tmx, toks, lens, labs, ctx):
    L = toks.shape[1]
    return tmx.io.DataBatch(
        data=[tmx.nd.array(toks, ctx=ctx), tmx.nd.array(lens, ctx=ctx)],
        label=[tmx.nd.array(labs, ctx=ctx)],
        provide_data=[tmx.io.DataDesc("data", toks.shape),
                      tmx.io.DataDesc("valid_length", lens.shape)],
        provide_label=[tmx.io.DataDesc("softmax_label", labs.shape)])


def _sym_multi_context(torch, tmx, sym, params, seed):
    """Module over [gpu(0), gpu(0)] (two executors, half the batch each)
    against one context: outputs and parameters after 2 SGD steps."""
    B, L = 2 * SYM["oracle_batch"], SYM["len"]
    batch = _sym_databatch(tmx, *_sym_batch(np.random.RandomState(seed + 2),
                                            B, L, SYM["min_len"]),
                           tmx.gpu(0))
    opt = (("learning_rate", 0.1), ("rescale_grad", 1.0 / B))
    runs = []
    for context in (tmx.gpu(0), [tmx.gpu(0), tmx.gpu(0)]):
        mod = _sym_module(tmx, sym, context, B, params, opt)
        for _ in range(2):
            mod.forward_backward(batch)
            mod.update()
        mod.forward(batch, is_train=False)
        arg, _ = mod.get_params()
        runs.append((mod.get_outputs()[0]._data, arg, len(mod._execs)))
    (o1, a1, n1), (o2, a2, n2) = runs
    out_err = _rel_to_max(torch, o2, o1)
    par_err = max(_rel_to_max(torch, a2[k]._data, a1[k]._data) for k in a1)
    _log(f"sym multi-context ({n2} executors on one card vs {n1}, B {B}, "
         f"2 SGD steps): outputs {out_err:.2e}, parameters {par_err:.2e} of "
         f"max |one context|")
    if n2 != 2 or out_err > SYM_ORACLE_TOL or par_err > TRAIN_TOL:
        raise AssertionError("sym: multi-context disagrees with one context")


def _sym_bucketing(torch, tmx, fa, params, seed):
    """BucketingModule over buckets 512 and 256 on the card and on the
    CPU from the same parameters, batches 512, 256, 512 with SGD: each
    step's outputs and the parameters after; the flash launches of the
    card's run."""
    B = SYM["oracle_batch"]
    rng = np.random.RandomState(seed + 3)
    batches = [(key, _sym_batch(rng, B, key, key * 3 // 4))
               for key in (512, 256, 512)]

    def gen(key):  # noqa: ARG001 - one graph for every length
        return (_sym_encoder(tmx.sym, tmx.name, SYM["oracle_layers"]),
                ("data", "valid_length"), ("softmax_label",))

    runs = []
    for ctx in (tmx.gpu(0), tmx.cpu()):
        _reset_counts(fa)
        mod = tmx.mod.BucketingModule(gen, default_bucket_key=512,
                                      context=ctx)
        mod.bind(data_shapes=[("data", (B, 512)), ("valid_length", (B,))],
                 label_shapes=[("softmax_label", (B, 512))])
        mod.init_params(arg_params={k: tmx.nd.array(v, ctx=ctx)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=(
            ("learning_rate", 0.1), ("rescale_grad", 1.0 / B)))
        outs = []
        for key, arrays in batches:
            batch = _sym_databatch(tmx, *arrays, ctx)
            batch.bucket_key = key
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0]._data)
        arg, _ = mod.get_params()
        runs.append((outs, arg, _counts(fa), sorted(mod._buckets)))
    (go, ga, counts, keys), (co, ca, _, _) = runs
    out_err = max(_rel_to_max(torch, g, c) for g, c in zip(go, co))
    par_err = max(_rel_to_max(torch, ga[k]._data, ca[k]._data) for k in ca)
    _log(f"sym bucketing (buckets {keys}, batches 512, 256, 512, card vs "
         f"CPU): outputs {out_err:.2e}, parameters {par_err:.2e} of max "
         f"|CPU|; card launches {counts}")
    if keys != [256, 512] or out_err > SYM_ORACLE_TOL \
            or par_err > TRAIN_TOL or counts["flash_fwd_f32"] != \
            3 * SYM["oracle_layers"] or counts["flash_bwd_fused_f32"] != \
            3 * SYM["oracle_layers"]:
        raise AssertionError("sym: bucketing disagrees")
    return counts


def _sym_loss_metric(torch, tmx):
    """An EvalMetric whose value is the loss of SoftmaxOutput's
    probabilities, computed on the card (no host copy of the (B, L,
    vocab) outputs); ``losses`` keeps one per update."""
    class SymLoss(tmx.metric.EvalMetric):
        def __init__(self):
            self.losses = []
            super().__init__("sym-ce")

        def update(self, labels, preds):
            v = _sym_loss(torch, preds[0]._data, labels[0]._data)
            self.losses.append(v)
            self._incr(v, 1)

    return SymLoss()


def _sym_train(torch, tmx, fa, args, smi):
    """The full-width encoder trained by ``Module.fit`` with Adam on an
    NDArrayIter of synthetic tokens: losses, step ms, samples/s, MFU,
    peak memory, idle share, the memory a step holds after its backward
    and the flash launches of the timed steps."""
    s = SYM
    B, L, layers = s["batch"], s["len"], s["layers"]
    sym = _sym_encoder(tmx.sym, tmx.name, layers)
    rng = np.random.RandomState(args.seed + 4)
    n = B * s["batches"]
    toks, lens, labs = _sym_batch(rng, n, L, s["min_len"])
    it = tmx.io.NDArrayIter({"data": toks, "valid_length": lens},
                            {"softmax_label": labs}, batch_size=B,
                            shuffle=False)
    mod = tmx.mod.Module(sym, data_names=("data", "valid_length"),
                         label_names=("softmax_label",),
                         context=tmx.gpu(0))
    metric = _sym_loss_metric(torch, tmx)
    stamps = []

    def stamp(param):  # noqa: ARG001
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    _fresh_peak(torch)
    tmx.random.seed(args.seed)
    _reset_counts(fa)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=s["epochs"], optimizer="adam",
            optimizer_params=(("learning_rate", s["lr"]),),
            initializer=tmx.init.Normal(0.02), eval_metric=metric,
            batch_end_callback=stamp)
    counts = _counts(fa)
    steps = len(metric.losses)
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    it.reset()
    batch = next(iter(it))

    def one_step():
        mod.forward_backward(batch)
        mod.update()

    prof = _profile_step(torch, one_step, "sym train")
    # memory a step holds after its backward (through update, metric and
    # callbacks): Module's, whose backward frees the graph as it walks it,
    # against executors that keep it for another backward (the default)
    held = []
    for retain in (False, True):
        gc.collect()
        mod.forward(batch, is_train=True)
        if retain:
            for e in mod._execs:
                e.backward(retain_graph=True)
        else:
            mod.backward()
        torch.cuda.synchronize()
        held.append(torch.cuda.memory_allocated() / 2**30)
    for e in mod._execs:
        e.backward(retain_graph=False)      # lets the kept graph go
    med = statistics.median(step_ms[2:])
    sps = B / (med / 1e3)
    flops = _sym_flops(B, L, layers)
    numbers = {"steps": steps, "step_ms": med, "samples_per_s": sps,
               "mfu": flops / (med / 1e3) / PEAK_FLOPS["float32"],
               "peak_gib": peak,
               "held_after_backward_gib": held[0],
               "held_retained_gib": held[1],
               "idle_share": max(0.0, 1 - prof["device_ms"]
                                 / prof["wall_ms"]),
               "rescale_grad": mod._optimizer.rescale_grad}
    _log(f"sym train losses: {[round(x, 4) for x in metric.losses]}")
    _log(f"sym train launches over the {steps} timed steps: {counts}")
    _log(f"sym train ({layers} layers, {s['units']} units, B {B}, L {L}, "
         f"f32, Adam {s['lr']}, {smi}): {steps} steps, median step "
         f"{med:.2f} ms, {sps:.2f} samples/s, {flops / 1e12:.2f} TFLOP a "
         f"step, MFU {numbers['mfu']:.4f} (of 67 TFLOP/s), peak {peak:.2f} "
         f"GiB, idle share {numbers['idle_share']:.3f}; held after a "
         f"step's backward {held[0]:.2f} GiB (Module), {held[1]:.2f} GiB "
         f"with the graph retained")
    losses = metric.losses
    if steps != s["batches"] * s["epochs"] \
            or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"sym train: losses {losses}")
    if counts["flash_fwd_f32"] != layers * steps \
            or counts["flash_bwd_fused_f32"] != layers * steps \
            or counts["flash_fwd"] != counts["flash_fwd_f32"] \
            or counts["flash_bwd_fused"] != counts["flash_bwd_fused_f32"] \
            or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]:
        raise AssertionError(f"sym train: launches {counts}")
    return mod, (toks, lens, labs), counts, numbers


def _sym_serve(torch, tmx, fa, mod, data, root):
    """``save_checkpoint`` then ``load_checkpoint``; the head served by
    ``SymbolBlock.imports`` at batch 8 against ``Module.predict`` of a
    ``Module.load`` of the checkpoint, a rebind at batch 4; then bf16 under
    ``amp.init`` after ``amp.convert_model``.  Returns the serve's
    launches (f32 and bf16)."""
    s = SYM
    nb = s["serve_batch"]
    toks, lens, labs = (a[:nb] for a in data)
    prefix = os.path.join(root, "encoder")
    t0 = time.perf_counter()
    mod.save_checkpoint(prefix, 1)
    t_save = time.perf_counter() - t0
    names = dict(data_names=("data", "valid_length"),
                 label_names=("softmax_label",))
    t0 = time.perf_counter()
    sym, arg, aux = tmx.model.load_checkpoint(prefix, 1)
    t_load = time.perf_counter() - t0
    if sorted(arg) != sorted(mod.get_params()[0]):
        raise AssertionError("sym: the checkpoint's parameters differ")
    pmod = tmx.mod.Module.load(prefix, 1, context=tmx.gpu(0), **names)
    pmod.bind(data_shapes=[("data", (nb, s["len"])), ("valid_length", (nb,))],
              label_shapes=[("softmax_label", (nb, s["len"]))],
              for_training=False)
    it = tmx.io.NDArrayIter({"data": toks, "valid_length": lens},
                            {"softmax_label": labs}, batch_size=nb)
    _reset_counts(fa)
    want = pmod.predict(it)[0]._data
    del pmod
    head = sym.get_internals()["head_output"]
    params = f"{prefix}-0001.params"
    blk = tmx.gluon.SymbolBlock.imports(head, ["data", "valid_length"],
                                        params, ctx=tmx.gpu(0))
    ins = (tmx.nd.array(toks, ctx=tmx.cpu()), tmx.nd.array(lens,
                                                          ctx=tmx.cpu()))
    logits = blk(*ins)._data
    serve_err = _rel_to_max(torch, torch.softmax(logits, -1), want)
    r = s["rebind_batch"]
    small = blk(*(a[:r] for a in ins))._data
    rebind_err = _rel_to_max(torch, small, logits[:r])
    f32_counts = _counts(fa)
    _log(f"sym serve: checkpoint saved in {t_save:.2f} s, loaded in "
         f"{t_load:.2f} s ({os.path.getsize(params) / 2**20:.1f} MiB); "
         f"SymbolBlock at batch {nb} vs Module.predict {serve_err:.2e} of "
         f"max, rebind at batch {r} {rebind_err:.2e}; launches {f32_counts}")
    if serve_err > SYM_SERVE_TOL or rebind_err > SYM_SERVE_TOL \
            or f32_counts["flash_fwd_f32"] != 3 * s["layers"]:
        raise AssertionError("sym serve: SymbolBlock disagrees")
    del blk
    tmx.amp.init()
    try:
        sym16, arg16, aux16 = tmx.amp.convert_model(sym, arg, aux)
        tmx.model.save_checkpoint(prefix + "-bf16", 1, head, arg16, aux16)
        blk16 = tmx.gluon.SymbolBlock.imports(
            head, ["data", "valid_length"], prefix + "-bf16-0001.params",
            ctx=tmx.gpu(0))
        _reset_counts(fa)
        logits16 = blk16(*ins)._data
        torch.cuda.synchronize()
        bf16_counts = _counts(fa)
    finally:
        tmx.amp.off()
    bf16_err = _rel_to_max(torch, logits16, logits)
    dtypes = sorted({str(v.dtype).replace("torch.", "")
                     for v in arg16.values()})
    _log(f"sym bf16 serve (amp.init + convert_model, parameters {dtypes}): "
         f"logits {logits16.dtype} vs f32 {bf16_err:.2e} of max |f32|; "
         f"launches {bf16_counts}")
    bf16_fwd = bf16_counts["flash_fwd"] - bf16_counts["flash_fwd_f32"]
    if bf16_err > SYM_BF16_TOL or bf16_fwd != s["layers"] \
            or bf16_counts["flash_fwd_f32"]:
        raise AssertionError("sym bf16 serve: logits or launches")
    return {k: f32_counts[k] + bf16_counts[k] for k in f32_counts}


def sym_phase(torch, fa, mx, args, smi):
    """The symbolic API on the card: the 2-layer oracle card vs CPU,
    Module over two contexts of one card, BucketingModule card vs CPU,
    the full-width encoder trained by ``Module.fit``, its checkpoint
    served by ``SymbolBlock`` in f32 and bf16.  Returns (launch counts of
    the whole phase, numbers)."""
    tmx = mx["pkg"]
    gc.collect()
    torch.cuda.empty_cache()
    total = dict.fromkeys(_COUNTERS, 0)

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    _reset_counts(fa)
    sym2, params = _sym_oracle(torch, tmx, args.seed + 30)
    _sym_multi_context(torch, tmx, sym2, params, args.seed + 30)
    add(_counts(fa))
    add(_sym_bucketing(torch, tmx, fa, params, args.seed + 30))
    del params
    mod, data, train_counts, numbers = _sym_train(torch, tmx, fa, args, smi)
    add(train_counts)
    root = tempfile.mkdtemp(prefix="mx_sym_")
    try:
        add(_sym_serve(torch, tmx, fa, mod, data, root))
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"sym launches over the phase: {total}")
    _log(f"sym numbers ({smi}): " + ", ".join(
        f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in numbers.items()))
    return total, numbers


# -- phase 21: operations ---------------------------------------------------

OPS_REPLAYS = 20
OPS_TURNS = 4          # on/off alternations of the overhead measurement
OPS_TURN_STEPS = 8
OPS_OVERHEAD = 0.05    # telemetry on may cost at most 5 % of a step


def _bert_hand_flops(layers, units, hidden, vocab, B, L):
    """A BERT training step's FLOPs from its layer shapes: each Dense's
    GEMM 2·T·in·out forward and twice that backward (the q/k/v, proj and
    FFN GEMMs of every layer and the MLM decoder), the pooler's forward
    alone (the loss reads only the decoder), attention 12·layers·B·L²·
    units (4·B·L²·units forward, twice that backward)."""
    T = B * L
    per_layer = 2 * T * (4 * units * units + 2 * units * hidden)
    gemm = 3 * (layers * per_layer + 2 * T * units * vocab)
    return gemm + 2 * B * units * units + 12 * layers * B * L * L * units


def _http_get(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _ops_scrape(tel, port, site):
    """/metrics, /statusz, /ledger.json and /healthz of the live server,
    each held against the process's own view."""
    status, body = _http_get(port, "/metrics")
    want = tel.to_prometheus()
    if status != 200 or body != want:
        raise AssertionError(f"ops: /metrics ({status}) differs from "
                             "to_prometheus()")
    status, body = _http_get(port, "/statusz")
    verdict = tel.STEP_CLOCK.verdict()
    if status != 200 or json.loads(body)["stepclock"]["verdict"] != verdict:
        raise AssertionError(f"ops: /statusz ({status}) verdict is not the "
                             f"step clock's {verdict}")
    status, body = _http_get(port, "/ledger.json")
    sites = {e["site"] for e in json.loads(body)["costmodel"]["entries"]}
    if status != 200 or site not in sites:
        raise AssertionError(f"ops: /ledger.json ({status}) lists {sites}")
    status, body = _http_get(port, "/healthz")
    if status != 200 or not json.loads(body)["ok"]:
        raise AssertionError(f"ops: /healthz {status} {body}")


def _ops_step(torch, fa, mx, args, smi, tmp):
    """(a) and (b): the captured BERT-base step under telemetry, the cost
    ledger, the scrape server and the profiler."""
    tmx = mx["pkg"]
    tel, prof = tmx.telemetry, tmx.profiler
    cm, httpd = tel.costmodel, tel.httpd
    dname, dtype = "bfloat16", torch.bfloat16
    _fresh_peak(torch)
    net, loss_fn, flops_tok, layers, B, L, vocab = _lane_model(
        torch, mx, "bert_seq512", dtype, args.seed)
    units, hidden = 768, 3072
    step = mx["parallel"].TrainStep(net, loss_fn, mx["optimizer"].Adam(
        learning_rate=1e-4, multi_precision=True))
    rng = np.random.RandomState(args.seed + 21)
    toks = torch.tensor(rng.randint(0, vocab, (B, L)), device="cuda")
    labs = torch.tensor(rng.randint(0, vocab, (B, L)), device="cuda")
    site = "parallel.TrainStep"
    tel.clear()
    tel.enable()
    cm.arm()
    port = httpd.start(0, host="127.0.0.1")
    try:
        t0 = time.perf_counter()
        step(toks, labs)            # eager warm-up: the ledger's analysis
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        step(toks, labs)            # the capture (its seconds: compile_s)
        torch.cuda.synchronize()
        tel.STEP_CLOCK.reset()
        _reset_counts(fa)
        losses, step_ms = [], []
        for i in range(OPS_REPLAYS):
            loss, ms = _timed_steps(torch, step, toks, labs, 1)
            losses += loss
            step_ms += ms
            if i % 5 == 4:
                _ops_scrape(tel, port, site)
        counts = _counts(fa)
        summary = tel.STEP_CLOCK.summary()
        records = list(tel.STEP_CLOCK._window)
        report = tel.report(cost=True)
        ents = cm.LEDGER.entries(site)
        calls = cm.LEDGER.calls(site)
        med = statistics.median(step_ms)
        lane = cm.lane_summary(site, step_seconds=med / 1e3, dtype=dname)
        # telemetry and the ledger on and off, in turns
        on_ms, off_ms = [], []
        for turn in range(2 * OPS_TURNS):
            on = turn % 2 == 0
            (tel.enable if on else tel.disable)()
            (cm.arm if on else cm.disarm)()
            (on_ms if on else off_ms).extend(_timed_steps(
                torch, step, toks, labs, OPS_TURN_STEPS)[1])
        tel.enable()
        cm.arm()
        # (b) the profiler around 3 replays, each a scope; one replay
        # first, outside them (CUPTI missed 2 of the first replay's
        # kernels right after the trace started in one run on an H100)
        prof.set_config(filename=os.path.join(tmp, "profile.json"))
        prof.start()
        step(toks, labs)
        torch.cuda.synchronize()
        _reset_counts(fa)
        for _ in range(3):
            with prof.scope("step"):
                step(toks, labs)
        torch.cuda.synchronize()
        prof.stop()
        prof.dump()
        prof_counts = _counts(fa)
    finally:
        httpd.stop()
        cm.disarm()
        tel.disable()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ops: losses {losses}")
    if len(ents) != 1:
        raise AssertionError(f"ops: {len(ents)} ledger entries for {site}")
    e = ents[0]
    hand = _bert_hand_flops(layers, units, hidden, vocab, B, L)
    if abs(e["flops"] / hand - 1) > 0.01:
        raise AssertionError(f"ops: ledger FLOPs {e['flops']:.0f} vs the "
                             f"hand count {hand:.0f}")
    sps = B / (med / 1e3)
    formula_mfu = sps * L * flops_tok / PEAK_FLOPS[dname]
    _log(f"ops ledger: {site} FLOPs {e['flops']:.0f} (hand count {hand}, "
         f"ratio {e['flops'] / hand:.6f}), bytes {e['bytes_accessed']:.0f},"
         f" peak bytes {e['peak_bytes']} ({e['peak_bytes'] / 2**30:.2f} "
         f"GiB), capture {e['compile_s']:.3f} s (warm-up with the analysis "
         f"{warm_s:.2f} s, of it {e['analysis_s']:.2f} s analysed), calls "
         f"{calls} ({smi})")
    _log(f"ops ledger: median replay {med:.2f} ms; analytic MFU "
         f"{lane['analytic_mfu']:.4f} (ledger FLOPs / step / "
         f"{lane['peak_flops'] / 1e12:.1f} TFLOP/s) beside bench.py's "
         f"formula MFU {formula_mfu:.4f} ({PEAK_FLOPS[dname] / 1e12:.0f} "
         f"TFLOP/s); arithmetic intensity {lane['arithmetic_intensity']}, "
         f"ridge {lane['ridge_flops_per_byte']}: {lane['verdict']} ({smi})")
    for line in report.splitlines():
        _log(f"ops report: {line}")
    if calls != OPS_REPLAYS + 2:
        raise AssertionError(f"ops: {calls} ledger calls, want "
                             f"{OPS_REPLAYS + 2}")
    if summary["steps"] != OPS_REPLAYS:
        raise AssertionError(f"ops: the step clock holds {summary['steps']} "
                             f"steps, want {OPS_REPLAYS}")
    for rec in records:
        parts = sum(rec[p] for p in ("data_wait", "h2d", "compute", "comms",
                                     "optimizer"))
        if abs(parts - rec["total"]) > 1e-9 * max(1.0, rec["total"]):
            raise AssertionError(f"ops: phases {parts} != total {rec}")
    _log(f"ops stepclock: {summary['steps']} steps, verdict "
         f"{summary['verdict']}; median ms "
         + ", ".join(f"{p} {v['median'] * 1e3:.3f}"
                     for p, v in summary["phases"].items()))
    for kind in ("flash_fwd", "flash_bwd_fused"):
        if counts[kind] != layers * OPS_REPLAYS:
            raise AssertionError(f"ops: {kind} launched {counts[kind]} "
                                 f"times in {OPS_REPLAYS} replays")
    on, off = statistics.median(on_ms), statistics.median(off_ms)
    _log(f"ops overhead: median step {on:.3f} ms with telemetry and the "
         f"ledger on, {off:.3f} ms with both off ({OPS_TURNS} turns of "
         f"{OPS_TURN_STEPS} steps each, alternating; on/off "
         f"{on / off:.4f}) ({smi})")
    if on > off * (1 + OPS_OVERHEAD):
        raise AssertionError(f"ops: telemetry on costs {on / off - 1:.1%}")
    # (b) the traces
    with open(os.path.join(tmp, "profile.json")) as f:
        host = json.load(f)
    scopes = [ev for ev in host["traceEvents"] if ev.get("name")
              == "scope:step"]
    with open(prof.device_trace_path()) as f:
        dev = json.load(f)
    # the kernels that started after the first scope opened on the host
    ranges = [ev["ts"] for ev in dev["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and ev.get("name") == "step"]
    kernels = [ev["name"] for ev in dev["traceEvents"]
               if ev.get("cat") == "kernel" and ranges
               and ev["ts"] >= min(ranges)]
    seen = {k: sum(k in name for name in kernels)
            for k in ("flash_fwd_bf16_tc_kernel",
                      "flash_bwd_fused_bf16_tc_kernel")}
    _log(f"ops profiler: host trace {len(host['traceEvents'])} events, "
         f"{len(scopes)} step scopes; device trace {len(ranges)} step "
         f"ranges, {len(kernels)} kernel events in the 3 replays, flash "
         f"{seen}; wrappers counted "
         f"{ {k: prof_counts[k] for k in ('flash_fwd', 'flash_bwd_fused')} }")
    if len(scopes) != 3 or len(ranges) != 3:
        raise AssertionError(f"ops: {len(scopes)} step scopes in the host "
                             f"trace, {len(ranges)} in the device trace")
    if any(n != 3 * layers for n in seen.values()):
        raise AssertionError(f"ops: the device trace holds {seen} flash "
                             f"kernels over 3 steps of {layers} layers")
    return net, counts


def _ops_flightrec(torch, tmx, net, tmp, smi):
    """(c): a chaos exit in a child on the card, SIGUSR2 here, and
    auto_resume's checkpoint telemetry at BERT-base."""
    import signal
    tel = tmx.telemetry
    d = os.path.join(tmp, "flightrec")
    os.makedirs(d)
    code = (
        "import numpy as np, torch\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.gluon.model_zoo import bert\n"
        "net = bert.bert_model('bert_3_128_2', vocab_size=1000, "
        "max_length=512, dropout=0.0, generator=torch.Generator("
        "device='cuda').manual_seed(0))\n"
        "tr = mx.gluon.Trainer(net.collect_params(), 'adam', "
        "{'learning_rate': 1e-4})\n"
        "r = np.random.RandomState(0)\n"
        "x = mx.nd.array(r.randint(0, 1000, (4, 512)), ctx=mx.gpu())\n"
        "y = mx.nd.array(r.randint(0, 1000, (4, 512)), ctx=mx.gpu())\n"
        "loss_fn = mx.gluon.loss.SoftmaxCELoss()\n"
        "for i in range(5):\n"
        "    with mx.autograd.record():\n"
        "        loss = loss_fn(net(x)[2], y)\n"
        "    loss.backward()\n"
        "    tr.step(4)\n"
        "    print('step', i, float(loss.mean().asscalar()), flush=True)\n")
    env = {**os.environ, "MXNET_FLIGHTREC_DIR": d, "MXNET_TELEMETRY": "1",
           "MXNET_CHAOS": "1", "MXNET_CHAOS_SITES": "trainer.step:exit:1:0:2"}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    child_s = time.perf_counter() - t0
    dumps = sorted(f for f in os.listdir(d) if f.startswith("flightrec-"))
    if res.returncode != 1 or len(dumps) != 1 \
            or "chaos.exit.trainer.step" not in dumps[0]:
        raise AssertionError(f"ops flightrec: child rc {res.returncode}, "
                             f"dumps {dumps}: {res.stderr[-2000:]}")
    with open(os.path.join(d, dumps[0])) as f:
        rec = json.load(f)
    names = {ev["name"] for ev in rec["spans"]}
    if "trainer.step" not in names or not rec["metrics"] \
            or rec["stepclock"]["steps"] < 1 \
            or rec["chaos"]["armed_sites"] != ["trainer.step"] \
            or rec["chaos"]["faults_fired"] != 1:
        raise AssertionError(f"ops flightrec: dump {sorted(rec)} spans "
                             f"{sorted(names)[:10]} stepclock "
                             f"{rec['stepclock']['steps']} chaos "
                             f"{rec['chaos']}")
    _log(f"ops flightrec: child (bert_3_128_2, Gluon loop on the card) "
         f"printed {res.stdout.strip().splitlines()} and exited "
         f"{res.returncode} at the armed trainer.step in {child_s:.1f} s; "
         f"dump {dumps[0]}: {len(rec['spans'])} spans, "
         f"{len(rec['metrics'])} metrics, step clock "
         f"{rec['stepclock']['steps']} steps ({rec['stepclock']['verdict']})"
         f", chaos {rec['chaos']}")
    # SIGUSR2 here: a dump, and the process runs on
    prev = os.environ.get("MXNET_FLIGHTREC_DIR")
    os.environ["MXNET_FLIGHTREC_DIR"] = d
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not [
                f for f in os.listdir(d) if f.endswith("sigusr2.json")]:
            time.sleep(0.01)
    finally:
        if prev is None:
            os.environ.pop("MXNET_FLIGHTREC_DIR")
        else:
            os.environ["MXNET_FLIGHTREC_DIR"] = prev
    usr2 = [f for f in os.listdir(d) if f.endswith("sigusr2.json")]
    if len(usr2) != 1:
        raise AssertionError(f"ops flightrec: SIGUSR2 left {usr2}")
    # auto_resume at BERT-base: a save, then a restore and a save
    names = ("mxnet_checkpoint_save_seconds",
             "mxnet_checkpoint_restore_seconds")

    def counts():
        return [tel.REGISTRY.get(n).count for n in names] + [
            tel.REGISTRY.get("mxnet_resilience_resumes_total").value]
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-4,
                                 "multi_precision": True})
    ckpt = os.path.join(tmp, "ckpt")
    tel.enable()
    try:
        c0 = counts()
        t0 = time.perf_counter()
        tmx.checkpoint.auto_resume(lambda s: False, ckpt, net=net,
                                   trainer=trainer)
        c1 = counts()
        last = tmx.checkpoint.auto_resume(lambda s: False, ckpt, net=net,
                                          trainer=trainer)
        c2 = counts()
        ckpt_s = time.perf_counter() - t0
    finally:
        tel.disable()
    first = [b - a for a, b in zip(c0, c1)]
    second = [b - a for a, b in zip(c1, c2)]
    if first != [1, 0, 0] or second != [1, 1, 1] or last != 1:
        raise AssertionError(f"ops checkpoint: (save, restore, resume) "
                             f"observations {first} then {second}, last "
                             f"step {last}")
    _log(f"ops checkpoint: auto_resume at BERT-base saved step 0, then "
         f"restored it (one observation in each histogram, one resume) and "
         f"saved step 1, in {ckpt_s:.1f} s; SIGUSR2 dumped {usr2[0]} and "
         f"the run went on ({smi})")


def _ops_aggregate(torch, tmx, serving, args, tmp, smi):
    """(d): two llama_small replicas behind a Router, each process a
    telemetry shard."""
    import shutil
    tel = tmx.telemetry
    agg = tel.aggregate
    d = os.path.join(tmp, "shards")
    V = TIER["router_vocab"]
    rng = np.random.RandomState(args.seed + 41)
    prompts = [rng.randint(3, V, 256).tolist() for _ in range(8)]
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving.replica",
           "--model", "llama_small", "--vocab", str(V), "--seed",
           str(args.seed), "--eos", "-1"]
    for key, val in TIER_REPLICA.items():
        cmd += ["--" + key.replace("_", "-"), str(val)]
    workdir = tempfile.mkdtemp(prefix="mx_ops_router_")
    saved = {k: os.environ.get(k) for k in ("MXNET_TELEMETRY_DIR",
                                            "MXNET_TELEMETRY")}
    os.environ.update(MXNET_TELEMETRY_DIR=d, MXNET_TELEMETRY="1")
    label = tel.get_tracer().process_label
    router = serving.Router(cmd, 2, workdir, hang_s=120.0)
    pids = []
    tel.enable()
    try:
        t0 = time.perf_counter()
        router.start()
        if router.wait_up(timeout_s=180) != 2:
            raise AssertionError("ops router: replicas did not come up: "
                                 f"{router.replica_status()}")
        pids = [s["pid"] for s in router.replica_status()]
        got = [h.result(timeout=300) for h in
               [router.submit(p, max_new_tokens=8) for p in prompts]]
        serve_s = time.perf_counter() - t0
    finally:
        router.stop()
        shutil.rmtree(workdir, ignore_errors=True)
        tel.disable()
        agg.export_snapshot(d)          # the router's shard: rank 2
        agg.set_rank(None)
        tel.get_tracer().set_process_label(label)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    live = {p: i for p, i in _descendants().items()
            if i[1] != "Z" and p in pids}
    if live:
        raise AssertionError(f"ops router: processes left: {live}")
    snaps = agg.load_snapshots(d)
    ranks = [s["rank"] for s in snaps]
    trace = agg.merged_chrome_trace(snaps)
    trace_pids = {ev.get("pid") for ev in trace["traceEvents"]}
    spans = {ev["pid"]: 0 for ev in trace["traceEvents"]}
    for ev in trace["traceEvents"]:
        spans[ev["pid"]] += ev.get("ph") == "X"
    merged = agg.merged_registry(snaps)
    bad = []
    for m in merged.all_metrics():
        if m.kind != "counter":
            continue
        want = sum(e.get("value", 0) for s in snaps for e in s["metrics"]
                   if e["name"] == m.name and (e.get("labels") or {})
                   == dict(m.labels))
        if m.value != want:
            bad.append((m.name, m.value, want))
    prefills = [sum(e["value"] for e in s["metrics"]
                    if e["name"] == "mxnet_serving_prefills_total")
                for s in snaps if s["rank"] in (0, 1)]
    if ranks != [0, 1, 2] or trace_pids != {0, 1, 2} or bad \
            or len(got) != 8 or sum(prefills) != 8:
        raise AssertionError(f"ops aggregate: ranks {ranks}, trace pids "
                             f"{trace_pids}, counter sums off {bad[:5]}")
    _log(f"ops aggregate: Router over 2 llama_small replicas answered 8 "
         f"requests of 256 prompt tokens in {serve_s:.1f} s; shards of "
         f"ranks {ranks}; merged trace pids {sorted(trace_pids)} with "
         f"{spans} complete events; "
         f"{sum(1 for m in merged.all_metrics() if m.kind == 'counter')} "
         f"merged counters each the sum over the shards; prefills by replica "
         f"{prefills}; no process left ({smi})")


def ops_phase(torch, fa, mx, args, smi):
    """Operations on the port's telemetry (module docstring, phase 21)."""
    from mxnet_tpu_torch import serving
    import shutil
    tmp = tempfile.mkdtemp(prefix="mx_ops_")
    try:
        net, counts = _ops_step(torch, fa, mx, args, smi, tmp)
        _ops_flightrec(torch, mx["pkg"], net, tmp, smi)
        del net
        _fresh_peak(torch)
        _ops_aggregate(torch, mx["pkg"], serving, args, tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts, None


# -- phase 22: INT8 quantization ---------------------------------------------

QUANT = {"layers": 12, "units": 768, "hidden": 3072, "heads": 12,
         "vocab": 30522, "batch": 32, "len": 512, "min_len": 384,
         "calib_batch": 8, "calib_batches": 2, "iters": 20,
         "resnet_batch": 32, "resnet_size": 224, "resnet_calib": 2,
         "resnet_iters": 10, "sym_batch": 8}
# int8 against float (per-tensor symmetric ranges), each output over its
# max |float|: the mean |int8 - float| and the max, the reference's own
# bounds for entropy calibration (tests/test_quantization.py: KL
# thresholds clip the tails, so the worst element is a clipped outlier),
# and the cosine of the flattened outputs (BERT-base's sequence output
# read a max of 0.206 and a cosine of 0.99948 on an H100)
QUANT_MEAN = 0.03
QUANT_MAX = 0.30
QUANT_COS = 0.98
# ResNet-50 (naive ranges from 32 other images, 54 int8 products) is held
# as a classifier: top-1 agreement with float and the logits' cosine; its
# mean error is printed (0.0315 of max on an H100, top-1 agreement 1.0)
QUANT_RESNET_TOP1 = 0.9


def _in_turns(torch, fns, iters):
    """Median ms (CUDA events) of one call of each of ``fns`` (name -> fn,
    each run once before), called in turns (a b, b a, ...) ``iters`` times
    each."""
    names = list(fns)
    ms = {n: [] for n in names}
    for i in range(iters):
        for n in (names if i % 2 == 0 else names[::-1]):
            ms[n].append(_time_ms(torch, fns[n], iters=1, reps=1, warmup=0))
    return {n: statistics.median(v) for n, v in ms.items()}


def _calibrated_s(torch, fn):
    """Seconds of fn() (a calibration) to the end of its device work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _mean_rel(got, ref):
    """mean |got - ref| over max |ref|."""
    ref = ref.detach().float()
    return float((got.detach().float() - ref).abs().mean()
                 / ref.abs().max().clamp_min(1e-30))


def _quant_errs(rel, mean, cos):
    return (f"max|d|/max|float| {rel:.4e} (tol {QUANT_MAX}), mean "
            f"{mean:.4e} (tol {QUANT_MEAN}), cosine {cos:.6f} (min "
            f"{QUANT_COS})")


def _quant_ok(rel, mean, cos):
    return rel <= QUANT_MAX and mean <= QUANT_MEAN and cos >= QUANT_COS


def _cosine(torch, a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    return float((a @ b) / (a.norm() * b.norm()).clamp_min(1e-300))


_FLOAT_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
                  "aten::linear", "aten::baddbmm")


def _gemm_kernels(kernels):
    return [k for k in kernels if any(w in k[2].lower()
                                      for w in _GEMM_WORDS)]


def _gemm_check(torch, label, fn_float, fn_int8, want_int_mm, want_flash):
    """The int8 forward's host ops hold ``want_int_mm`` ``aten::_int_mm``
    and no float matmul (attention is the flash kernel); its device trace
    holds ``want_flash`` flash forwards and at least ``want_int_mm`` int8
    GEMM kernels (so the trace lost none), none of them a GEMM kernel of
    the float forward.  Each forward is traced after a warm-up forward in
    the trace.  Returns the int8 GEMM kernels' names."""
    _, ker_q, ops_q = _profiled(torch, fn_int8, host_ops=True, warmup=True)
    _, ker_f = _profiled(torch, fn_float, warmup=True)
    n_int = ops_q.get("aten::_int_mm", 0)
    floats = {k: v for k, v in ops_q.items() if k in _FLOAT_MATMULS}
    float_names = {k[2] for k in _gemm_kernels(ker_f)}
    gemm_q = _gemm_kernels(ker_q)
    shared = sorted({k[2][:80] for k in gemm_q if k[2] in float_names})
    names = sorted({k[2][:100] for k in gemm_q})
    n_gemm = sum(k[1] for k in gemm_q)
    n_flash = sum(k[1] for k in ker_q if "flash_fwd" in k[2])
    busy = sum(k[0] for k in ker_q)
    gemm_ms = sum(k[0] for k in gemm_q)
    flash_ms = sum(k[0] for k in ker_q if "flash_fwd" in k[2])
    _log(f"quant {label} profile: {n_int} aten::_int_mm, float matmul ops "
         f"{floats or 'none'}; int8 GEMM kernels {n_gemm} launches "
         f"{names}; flash forward kernels {n_flash} launches; float GEMM "
         f"kernels of the float forward among them: {shared or 'none'}; "
         f"int8 forward device busy {busy:.2f} ms: int8 GEMM {gemm_ms:.2f}, "
         f"flash {flash_ms:.2f}, other {busy - gemm_ms - flash_ms:.2f} "
         f"(float forward {sum(k[0] for k in ker_f):.2f})")
    for ms, n, key in ker_q[:8]:
        _log(f"quant {label} profile:   {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    if n_int != want_int_mm or floats or shared or n_gemm < want_int_mm \
            or n_flash != want_flash:
        raise AssertionError(f"quant {label}: the int8 forward ran "
                             f"{n_int} int8 products (want {want_int_mm}), "
                             f"{n_gemm} int8 GEMM kernels, {n_flash} flash "
                             f"forwards (want {want_flash}), float matmuls "
                             f"{floats}, float GEMM kernels {shared}")
    return names


def _quant_bert_net(tmx, ctx, seed):
    q = QUANT
    net = tmx.gluon.model_zoo.bert.BERTModel(
        vocab_size=q["vocab"], num_layers=q["layers"], units=q["units"],
        hidden_size=q["hidden"], num_heads=q["heads"], max_length=q["len"],
        dropout=0.0, prefix="bert_")
    net.collect_params().setattr("grad_req", "null")
    tmx.random.seed(seed)
    net.initialize(tmx.init.Normal(0.02), ctx=ctx)
    return net


def _quant_bert(torch, fa, tmx, args, smi, ctx):
    """(a) INT8 post-training quantization of BERT-base (entropy
    calibration on 2 batches of 8 x 512) serving batch 32 x 512, lengths
    384-512; attention stays float on the flash forward.  Returns the
    flash launches of the timed int8 forwards and the numbers."""
    from mxnet_tpu_torch.contrib import quantization as qz
    from mxnet_tpu_torch.ops import contrib as ops_contrib
    from mxnet_tpu_torch.ops import quantization as tq
    q = QUANT
    seed = args.seed + 40
    net_f = _quant_bert_net(tmx, ctx, seed)
    net_q = _quant_bert_net(tmx, ctx, seed)
    rng = np.random.RandomState(seed)
    B, L = q["batch"], q["len"]
    toks = tmx.nd.array(rng.randint(0, q["vocab"], (B, L))
                        .astype(np.int32), ctx=ctx)
    vl = tmx.nd.array(rng.randint(q["min_len"], L + 1, (B,))
                      .astype(np.float32), ctx=ctx)
    calib = [tmx.nd.array(rng.randint(0, q["vocab"], (q["calib_batch"], L))
                          .astype(np.int32), ctx=ctx)
             for _ in range(q["calib_batches"])]
    calib_s = _calibrated_s(torch, lambda: qz.quantize_net(
        net_q, calib_data=calib, calib_mode="entropy"))
    wrappers = [m for m in net_q.modules() if isinstance(m,
                                                         qz.QuantizedDense)]
    n_dense = q["layers"] * 4 + 2
    if len(wrappers) != n_dense:
        raise AssertionError(f"quant bert: {len(wrappers)} Dense layers "
                             f"quantized, want {n_dense}")
    cell0 = net_q.encoder.cells[0]
    seen = {}
    hooks = [cell0.attn_qkv.register_forward_pre_hook(
        lambda b, a: seen.setdefault("x", a[0]._data)),
             cell0.attn_qkv.register_forward_hook(
        lambda b, a, o: seen.setdefault("qkv", o._data))]
    with torch.no_grad():
        ref = [o._data for o in net_f(toks, vl)]
        got = [o._data for o in net_q(toks, vl)]
    for h in hooks:
        h.remove()
    rel, mean = _rel_to_max(torch, got[0], ref[0]), _mean_rel(got[0], ref[0])
    cos = _cosine(torch, got[0], ref[0])
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    shapes = [tuple(t.shape) for t in got]
    del ref, got
    # flash launches of each timed int8 forward (deltas: the float
    # forwards between them launch the same kernel)
    _reset_counts(fa)
    launches = {"flash_fwd": 0, "flash_fwd_f32": 0}
    per_fwd = set()

    def fwd_f():
        with torch.no_grad():
            net_f(toks, vl)

    def fwd_q():
        a, b = fa.launches, fa.fwd_f32_launches
        with torch.no_grad():
            net_q(toks, vl)
        per_fwd.add((fa.launches - a, fa.fwd_f32_launches - b))
        launches["flash_fwd"] += fa.launches - a
        launches["flash_fwd_f32"] += fa.fwd_f32_launches - b

    _fresh_peak(torch)
    times = _in_turns(torch, {"float": fwd_f, "int8": fwd_q}, q["iters"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = q["layers"]
    if per_fwd != {(want, want)} or \
            launches["flash_fwd"] != want * q["iters"]:
        raise AssertionError(f"quant bert: flash forward launches a forward "
                             f"(all, f32) {per_fwd}, want {want}")
    gemms = _gemm_check(torch, "bert", fwd_f, lambda: net_q(toks, vl),
                        n_dense, want)
    # the flash forward at this path's shape against its plain version,
    # on layer 0's q, k, v (outside the counted forwards)
    qkv = seen["qkv"]
    qh, kh, vh = (t.permute(1, 2, 0, 3) for t in
                  ops_contrib._split_interleaved(qkv, q["heads"]))
    seg = ops_contrib._seg_of(vl._data, L, qkv.device)
    scale = 1.0 / (q["units"] // q["heads"]) ** 0.5
    with torch.no_grad():
        out_k, _ = fa._fwd(qh, kh, vh, seg, seg, False, scale)
        out_p, _ = fa.flash_attention_reference(
            qh, kh, vh, seg, seg, False, scale,
            block_k=fa.kv_tile(torch.float32, q["units"] // q["heads"]))
    att_err = ((out_k - out_p).abs() * seg.bool()[:, None, :, None]) \
        .max().item()
    D = q["units"] // q["heads"]
    att = {"shape": f"B={B} H={q['heads']} Lq=Lk={L} D={D} float32 "
                    f"non-causal, segment ids"}
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    att["ms"] = _time_ms(torch, lambda: fa._fwd(qh, kh, vh, seg, seg,
                                                False, scale))
    att["plain_ms"] = _time_ms(torch, lambda: fa.flash_attention_reference(
        qh, kh, vh, seg, seg, False, scale), iters=5)
    att["library_ms"] = _time_ms(torch, lambda: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     qh, kh, vh, attn_mask=mask,
                                     scale=scale))
    # the query-key pairs the segment ids keep: sum over rows and ids of
    # (positions with that id)^2
    pairs = int((torch.nn.functional.one_hot(seg.long()).sum(1).long() ** 2)
                .sum())
    att["bound_ms"], att["bound_by"] = _bound_ms(
        B, q["heads"], L, L, D, "float32", False, pairs=pairs)
    _log(f"quant flash forward at {att['shape']}: kernel "
         f"{att['ms']:.4f} ms, plain {att['plain_ms']:.4f}, SDPA "
         f"{att['library_ms']:.4f}, bound {att['bound_ms']:.4f} "
         f"({att['bound_by']}; the segment ids keep {pairs} query-key "
         f"pairs, {pairs / (B * L * L):.4f} of B L^2) ({smi})")
    # one layer's int8 product at full size, card against the CPU
    w = cell0.attn_qkv
    xq = tq.quantize(seen["x"], w._input_range(seen["x"]))
    xq = xq.reshape(-1, xq.shape[-1])
    real_x = float(w._real_x)

    def int_fc(c):
        r = [tmx.nd.array(np.float32(v), ctx=c) for v in
             (-real_x, real_x, -float(w._real_w), float(w._real_w))]
        return tmx.nd.contrib.quantized_fully_connected(
            tmx.nd.NDArray(xq.to(tmx.nd.ndarray._device(c)), c),
            tmx.nd.NDArray(w.qweight.to(tmx.nd.ndarray._device(c)), c),
            *r, num_hidden=w.qweight.shape[0], flatten=False)[0]._data
    fc_card, fc_cpu = int_fc(ctx), int_fc(tmx.cpu())
    fc_equal = fc_card.dtype == fc_cpu.dtype == torch.int32 and \
        torch.equal(fc_card.cpu(), fc_cpu)
    numbers = {"float_ms": times["float"], "int8_ms": times["int8"],
               "calib_s": calib_s, "rel": rel, "mean_rel": mean,
               "cos": cos, "peak_gib": peak, "att_err": att_err,
               "flash": att}
    _log(f"quant bert: BERT-base batch {B} x {L} (lengths {q['min_len']}-"
         f"{L}), {n_dense} Dense layers int8 (entropy calibration on "
         f"{q['calib_batches']} x {q['calib_batch']} x {L} in "
         f"{calib_s:.2f} s); median forward float {times['float']:.2f}"
         f" ms, int8 {times['int8']:.2f} ms ({q['iters']} each, in turns); "
         f"sequence output int8 vs float {_quant_errs(rel, mean, cos)}; "
         f"outputs "
         f"{shapes} finite {finite}; peak {peak:.2f} GiB; flash f32 "
         f"forward {want} launches a forward; attention kernel vs "
         f"plain at ({B}, {q['heads']}, {L}, {q['units'] // q['heads']}) "
         f"f32 {att_err:.3e} (tol {TOL['float32'][0]}); layer 0 qkv "
         f"({xq.shape[0]}, {xq.shape[1]}) x {tuple(w.qweight.shape)} int32 "
         f"card == CPU: {fc_equal} ({smi})")
    if not (finite and _quant_ok(rel, mean, cos) and fc_equal
            and att_err <= TOL["float32"][0] and gemms is not None):
        raise AssertionError(f"quant bert failed: {numbers}, int32 equal "
                             f"{fc_equal}, finite {finite}")
    del net_f, net_q
    return launches, numbers


def _resnet_pair(torch, tmx, ctx, seed, x_stats):
    """Two resnet50_v1 with the same weights, each BatchNorm's moving
    statistics those of its input on ``x_stats`` (one train-mode pass at
    momentum 0), as a trained net's are.  With the initial statistics (0,
    1) the random net does not normalize: the spread of its activations
    grows through the 16 residual blocks, and per-tensor int8 ranges lose
    the small channels (the logits' cosine falls below QUANT_COS)."""
    nets = []
    for _ in range(2):
        net = tmx.gluon.model_zoo.get_model("resnet50_v1", classes=1000)
        net.collect_params().setattr("grad_req", "null")
        tmx.random.seed(seed)
        net.initialize(tmx.init.Xavier(magnitude=2), ctx=ctx)
        nets.append(net)
    bns = [m for m in nets[0].modules()
           if isinstance(m, tmx.gluon.nn.BatchNorm)]
    for m in bns:
        m._momentum = 0.0
    with torch.no_grad(), tmx.autograd.train_mode():
        nets[0](x_stats)
    for m in bns:
        m._momentum = 0.9
    src = nets[0]._collect_params_with_prefix()
    for k, p in nets[1]._collect_params_with_prefix().items():
        p.set_data(src[k].data())
    return nets


def _quant_resnet(torch, tmx, args, smi, ctx):
    """(b) resnet50_v1, batch 32 at 224, naive calibration: every Conv2D
    and the Dense int8; the stem's and a 3x3 layer's int8 convolutions
    on the card equal the CPU's in int32; top-1 agreement and ms."""
    from mxnet_tpu_torch.contrib import quantization as qz
    from mxnet_tpu_torch.ops import quantization as tq
    q = QUANT
    B, S = q["resnet_batch"], q["resnet_size"]
    rng = np.random.RandomState(args.seed + 41)
    x = tmx.nd.array(rng.randn(B, 3, S, S).astype(np.float32), ctx=ctx)
    net_f, net_q = _resnet_pair(torch, tmx, ctx, args.seed + 41,
                                tmx.nd.array(rng.randn(B, 3, S, S).astype(
                                    np.float32), ctx=ctx))
    calib = [tmx.nd.array(rng.randn(B // 2, 3, S, S).astype(np.float32),
                          ctx=ctx) for _ in range(q["resnet_calib"])]
    calib_s = _calibrated_s(torch, lambda: qz.quantize_net(
        net_q, calib_data=calib, calib_mode="naive"))
    convs = [m for m in net_q.modules() if isinstance(m, qz.QuantizedConv2D)]
    dense = [m for m in net_q.modules() if isinstance(m, qz.QuantizedDense)]
    stem = convs[0]
    k3 = next(m for m in convs if m.qweight.shape[2] == 3)
    seen = {}
    hooks = [m.register_forward_pre_hook(
        lambda b, a, k=k: seen.setdefault(k, a[0]._data))
        for k, m in (("stem", stem), ("3x3", k3))]
    with torch.no_grad():
        ref = net_f(x)._data
        got = net_q(x)._data
    for h in hooks:
        h.remove()
    top1 = float((ref.argmax(1) == got.argmax(1)).float().mean())
    rel, mean = _rel_to_max(torch, got, ref), _mean_rel(got, ref)
    cos = _cosine(torch, got, ref)
    finite = bool(torch.isfinite(got).all())

    def conv(m, key, c):
        xq = tq.quantize(seen[key], m._input_range(seen[key]))
        dev = tmx.nd.ndarray._device(c)
        rw, rx = float(m._real_w), float(m._real_x)
        return tmx.nd.contrib.quantized_conv(
            tmx.nd.NDArray(xq.to(dev), c), tmx.nd.NDArray(m.qweight.to(dev),
                                                          c),
            *[tmx.nd.array(np.float32(v), ctx=c)
              for v in (-rx, rx, -rw, rw)],
            stride=m._stride, pad=m._pad, dilate=m._dilate)[0]._data
    equal = {}
    for key, m in (("stem", stem), ("3x3", k3)):
        a, b = conv(m, key, ctx), conv(m, key, tmx.cpu())
        equal[key] = (tuple(a.shape), a.dtype == b.dtype == torch.int32
                      and torch.equal(a.cpu(), b))

    def fwd(net):
        def run():
            with torch.no_grad():
                net(x)
        return run
    times = _in_turns(torch, {"float": fwd(net_f), "int8": fwd(net_q)},
                      q["resnet_iters"])
    gemms = _gemm_check(torch, "resnet50", fwd(net_f), fwd(net_q),
                        len(convs) + len(dense), 0)
    _log(f"quant resnet50_v1: batch {B} at {S}, {len(convs)} Conv2D and "
         f"{len(dense)} Dense int8 (naive calibration on "
         f"{q['resnet_calib']} x {B // 2} images in {calib_s:.2f} "
         f"s); median forward float {times['float']:.2f} ms, int8 "
         f"{times['int8']:.2f} ms; top-1 agreement with float {top1:.4f} "
         f"(min {QUANT_RESNET_TOP1}), logits max|d|/max|float| {rel:.4e}, "
         f"mean {mean:.4e}, cosine {cos:.6f} (min {QUANT_COS}); "
         f"int32 card == CPU: " + ", ".join(
             f"{k} {v[0]} {v[1]}" for k, v in equal.items()) + f" ({smi})")
    if not (finite and top1 >= QUANT_RESNET_TOP1 and cos >= QUANT_COS
            and gemms is not None and all(v[1] for v in equal.values())):
        raise AssertionError(f"quant resnet failed: top-1 {top1}, cosine "
                             f"{cos}, equal "
                             f"{equal}, finite {finite}")
    del net_f, net_q
    return {"resnet_float_ms": times["float"],
            "resnet_int8_ms": times["int8"], "resnet_top1": top1,
            "resnet_rel": rel, "resnet_mean_rel": mean, "resnet_cos": cos}


def _quant_sym(torch, fa, tmx, args, smi, ctx):
    """(c) the sym phase's encoder (12 layers, BERT-base widths) up to its
    head, through ``optimize_for("INT8")``, forward at 8 x 512 against its
    float forward."""
    s = SYM
    B, L = QUANT["sym_batch"], s["len"]
    head = _sym_encoder(tmx.sym, tmx.name, s["layers"]) \
        .get_internals()["head_output"]
    shapes = {"data": (B, L), "valid_length": (B,)}
    params = _sym_params(head, shapes, args.seed + 42)
    rng = np.random.RandomState(args.seed + 42)
    toks, lens, _ = _sym_batch(rng, B, L, s["min_len"])
    q = head.optimize_for("INT8")
    n_q = int(q.attr("__int8_quantized_nodes__"))
    want_q = 4 * s["layers"] + 1
    if sorted(q.list_arguments()) != sorted(head.list_arguments()) \
            or n_q != want_q:
        raise AssertionError(f"quant sym: {n_q} nodes rewritten (want "
                             f"{want_q}), arguments "
                             f"{sorted(set(q.list_arguments()) ^ set(head.list_arguments()))}")
    feed = dict(params, data=toks, valid_length=lens)
    ref = head.eval(ctx=ctx, **feed)[0]._data
    before = fa.fwd_f32_launches
    got = q.eval(ctx=ctx, **feed)[0]._data
    n_flash = fa.fwd_f32_launches - before
    rel, mean = _rel_to_max(torch, got, ref), _mean_rel(got, ref)
    cos = _cosine(torch, got, ref)
    finite = bool(torch.isfinite(got).all())
    _log(f"quant sym: the {s['layers']}-layer symbolic encoder's head through "
         f"optimize_for('INT8'): {n_q} FullyConnected nodes int8, forward "
         f"at {B} x {L}: logits {_quant_errs(rel, mean, cos)}, {n_flash} "
         f"f32 flash forward launches ({smi})")
    if not (finite and _quant_ok(rel, mean, cos)
            and n_flash == s["layers"]):
        raise AssertionError(f"quant sym failed: rel {rel}, cos {cos}, "
                             f"finite {finite}, flash {n_flash}")
    return {"sym_rel": rel, "sym_mean_rel": mean, "sym_cos": cos}


def quant_phase(torch, fa, mx, args, smi):
    """INT8 quantization on the card (module docstring, phase 22).
    Returns (the launch counts of the timed int8 BERT forwards, numbers)."""
    tmx = mx["pkg"]
    ctx = tmx.gpu()
    gc.collect()
    _fresh_peak(torch)
    launches, numbers = _quant_bert(torch, fa, tmx, args, smi, ctx)
    gc.collect()
    _fresh_peak(torch)
    numbers.update(_quant_resnet(torch, tmx, args, smi, ctx))
    gc.collect()
    _fresh_peak(torch)
    numbers.update(_quant_sym(torch, fa, tmx, args, smi, ctx))
    gc.collect()
    _fresh_peak(torch)
    counts = dict.fromkeys(_COUNTERS, 0)
    counts.update(launches)
    _log(f"quant numbers ({smi}): " + ", ".join(
        f"{k} {v:.4f}" for k, v in numbers.items() if k != "flash"))
    return counts, numbers


# -- phase 23: sparse storage --------------------------------------------------

# the LIBSVM collection's Criteo set: 1,000,000 features, 39 non-zeros a
# row (13 integer fields and 26 categorical ones); the reference's
# examples/sparse/factorization_machine.py shape, factor 16
SPARSE = {"features": 1_000_000, "int_fields": 13, "cat_fields": 26,
          "rows": 65536, "batch": 1024, "factor": 16, "steps": 50,
          "sgd_steps": 25, "lr": 0.1, "adagrad_lr": 0.05,
          "emb_rows": 1_000_000, "emb_dim": 64, "emb_steps": 3,
          "emb_batch": (64, 32)}
SPARSE_LOSS_TOL = 1e-4    # relative, FM losses card vs CPU a step
SPARSE_DOT_TOL = 1e-5     # of max |CPU|: _sparse_dot_csr and gradients
SPARSE_UPDATE_TOL = 1e-6  # relative: a store step against a dense update


def _criteo_like_file(path, seed):
    """``SPARSE["rows"]`` LibSVM rows of 39 features in 1,000,000: field
    f's ids in a range of its own (13 integer fields of 100 ids, the
    categorical fields sharing the rest), drawn with a skew so that rows
    share features; integer fields carry log-counts, categorical ones 1;
    labels from a random linear model.  Returns the true weights."""
    s = SPARSE
    rng = np.random.RandomState(seed)
    nf = s["int_fields"] + s["cat_fields"]
    sizes = [100] * s["int_fields"]
    cat = (s["features"] - sum(sizes)) // s["cat_fields"]
    sizes += [cat] * s["cat_fields"]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    u = rng.rand(s["rows"], nf)
    ids = offsets + np.minimum((u ** 3 * np.array(sizes)).astype(np.int64),
                               np.array(sizes) - 1)
    vals = np.ones((s["rows"], nf), np.float32)
    vals[:, :s["int_fields"]] = np.round(np.log1p(
        rng.poisson(3.0, (s["rows"], s["int_fields"]))), 4)
    vals[vals == 0] = 0.5
    true_w = rng.randn(s["features"]).astype(np.float32)
    y = ((vals * true_w[ids]).sum(1) > 0).astype(int)
    with open(path, "w") as f:
        for r in range(s["rows"]):
            f.write(f"{y[r]} " + " ".join(
                f"{i}:{v:g}" for i, v in zip(ids[r], vals[r])) + "\n")


def _fm_step(torch, tmx, sp, ps, csr, label, w0, ctx, s, sink):
    """One FM step, under ``with ctx:``: pull the touched rows of w and v
    onto ``ctx``, the forward and backward through ``sparse.dot`` over the
    batch's columns renumbered into the pulled rows, a push of the
    row-sparse gradients.  Returns the loss and the touched rows."""
    cols = csr.indices._data
    uniq = torch.unique(cols)
    t0 = time.perf_counter()
    w_rows = ps.row_sparse_pull("w", tmx.nd.NDArray(uniq, ctx))
    v_rows = ps.row_sparse_pull("v", tmx.nd.NDArray(uniq, ctx))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    local = torch.searchsorted(w_rows.indices._data, cols)
    n = uniq.numel()
    x = sp.CSRNDArray(csr.data, csr.indptr, tmx.nd.NDArray(local, ctx),
                      (csr.shape[0], n), ctx=ctx)
    x2 = sp.CSRNDArray(tmx.nd.NDArray(csr.data._data ** 2, ctx), csr.indptr,
                       x.indices, (csr.shape[0], n), ctx=ctx)
    wb, vb = w_rows.data.copy(), v_rows.data.copy()
    for a in (wb, vb, w0):
        a.attach_grad()
    with tmx.autograd.record():
        linear = sp.dot(x, wb).reshape((-1,))
        xv = sp.dot(x, vb)
        x2v2 = sp.dot(x2, vb * vb)
        inter = 0.5 * (xv * xv - x2v2).sum(axis=1)
        logit = w0 + linear + inter
        loss = (tmx.nd.relu(logit) - logit * label + tmx.nd.log1p(
            tmx.nd.exp(-tmx.nd.abs(logit)))).mean()
    loss.backward()
    idx = w_rows.indices
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ps.push("w", sp.RowSparseNDArray(wb.grad, idx, (s["features"], 1),
                                     ctx=ctx))
    ps.push("v", sp.RowSparseNDArray(vb.grad, idx,
                                     (s["features"], s["factor"]), ctx=ctx))
    t3 = time.perf_counter()
    with torch.no_grad():
        w0._data -= s["lr"] * w0.grad._data
    sink.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    return float(loss.asnumpy()), uniq


def _fm_run(torch, tmx, it, ctx, s, seed, check=None):
    """The FM over the ``LibSVMIter`` ``it``'s batches on ``ctx``, its w and
    v in a SparsePS: ``sgd_steps`` with server-side SGD, the rest with
    Adagrad.  Returns (losses, the store, its initial v, touched rows,
    times)."""
    from mxnet_tpu_torch.kvstore.sparse_ps import SparsePS
    from mxnet_tpu_torch.ndarray import sparse as sp
    ps = SparsePS()
    gen = torch.Generator().manual_seed(seed)
    v0 = torch.randn(s["features"], s["factor"], generator=gen) * 0.01
    ps.init("w", tmx.nd.zeros((s["features"], 1), ctx=tmx.cpu()))
    ps.init("v", tmx.nd.NDArray(v0.clone(), tmx.cpu()))
    ps.set_optimizer(tmx.optimizer.SGD(learning_rate=s["lr"],
                                       rescale_grad=1.0))
    w0 = tmx.nd.zeros((1,), ctx=ctx)
    losses, touched, times = [], [], []
    it.reset()
    with ctx:           # the batches land on ctx
        for step, batch in enumerate(it):
            if step == s["steps"]:
                break
            if step == s["sgd_steps"]:
                ps.set_optimizer(tmx.optimizer.AdaGrad(
                    learning_rate=s["adagrad_lr"], eps=1e-7))
            if check is not None and step in (0, s["sgd_steps"]):
                check(step, ps)
            loss, uniq = _fm_step(torch, tmx, sp, ps, batch.data[0],
                                  batch.label[0], w0, ctx, s, times)
            losses.append(loss)
            touched.append(uniq.cpu())
    return losses, ps, v0, torch.unique(torch.cat(touched)), times


def _sparse_fm(torch, tmx, args, smi, ctx, it):
    """(a) the factorization machine: card against the CPU, untouched rows
    bit-unchanged, a store step against a dense update; (c)
    ``_sparse_dot_csr`` and its gradients at the FM's batch shapes, card
    against the CPU."""
    s = SPARSE
    updates = {}

    def check(step, ps):
        """The v table before the step, from which
        ``_sparse_dense_update`` replays it."""
        updates[step] = ps._tables["v"].value.clone()

    t0 = time.perf_counter()
    losses, ps, v0, touched, times = _fm_run(torch, tmx, it, ctx, s,
                                             args.seed + 43, check)
    run_s = time.perf_counter() - t0
    losses_cpu, ps_cpu, _, _, _ = _fm_run(torch, tmx, it, tmx.cpu(), s,
                                          args.seed + 43)
    rel = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(losses, losses_cpu))
    v_end = ps._tables["v"].value
    mask = torch.ones(s["features"], dtype=torch.bool)
    mask[touched] = False
    untouched_same = torch.equal(v_end[mask], v0[mask])
    moved = int((v_end[touched] != v0[touched]).any(1).sum())
    table_rel = _rel_to_max(torch, v_end, ps_cpu._tables["v"].value)
    # a dense update computed apart: replay step 0 (SGD) and the first
    # Adagrad step from the saved tables and the card's gradients
    upd_err = _sparse_dense_update(torch, tmx, it, ctx, s, updates)
    pull = statistics.median(t[0] for t in times)
    comp = statistics.median(t[1] for t in times)
    push = statistics.median(t[2] for t in times)
    steps_s = len(losses) / run_s
    _log(f"sparse fm: {s['rows']} rows x {s['features']} features, "
         f"{s['int_fields'] + s['cat_fields']} non-zeros a row, batch "
         f"{s['batch']}, factor {s['factor']}, {len(losses)} steps "
         f"({s['sgd_steps']} server-side SGD, then Adagrad); loss "
         f"{losses[0]:.5f} -> {losses[-1]:.5f}; card vs CPU losses max rel "
         f"{rel:.3e}, v table {table_rel:.3e} of max (tol "
         f"{SPARSE_LOSS_TOL}); "
         f"{int(touched.numel())} rows touched ({moved} moved), untouched "
         f"bit-unchanged {untouched_same}; dense update max rel "
         f"{upd_err:.3e} (tol {SPARSE_UPDATE_TOL}); {steps_s:.2f} steps/s, "
         f"median pull {pull:.2f} ms, forward+backward {comp:.2f} ms, push "
         f"{push:.2f} ms ({smi})")
    if not (rel <= SPARSE_LOSS_TOL and table_rel <= SPARSE_LOSS_TOL
            and untouched_same and moved > 0
            and upd_err <= SPARSE_UPDATE_TOL
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"sparse fm failed: rel {rel}, untouched "
                             f"{untouched_same}, update {upd_err}")
    return {"fm_steps_per_s": steps_s, "fm_pull_ms": pull,
            "fm_push_ms": push, "fm_compute_ms": comp,
            "fm_loss_rel": rel}


def _sparse_dense_update(torch, tmx, it, ctx, s, tables):
    """The two checked steps (SGD at 0, Adagrad at ``sgd_steps``) replayed
    on one batch each: the store's new rows against the plain update of
    the same rows with the merged gradient, computed here."""
    from mxnet_tpu_torch.kvstore.sparse_ps import SparsePS
    from mxnet_tpu_torch.ndarray import sparse as sp
    worst = 0.0
    it.reset()
    with ctx:
        batches = [b for b, _ in zip(it, range(s["sgd_steps"] + 1))]
    for step, table in tables.items():
        ps = SparsePS()
        ps.init("w", tmx.nd.zeros((s["features"], 1), ctx=tmx.cpu()))
        ps.init("v", tmx.nd.NDArray(table.clone(), tmx.cpu()))
        sgd = step < s["sgd_steps"]
        ps.set_optimizer(tmx.optimizer.SGD(learning_rate=s["lr"],
                                           rescale_grad=1.0) if sgd else
                         tmx.optimizer.AdaGrad(learning_rate=s["adagrad_lr"],
                                               eps=1e-7))
        b = batches[step]
        grads = {}
        orig = ps.push

        def push(key, g, _orig=orig):
            grads[key] = g
            _orig(key, g)
        ps.push = push
        with ctx:
            _fm_step(torch, tmx, sp, ps, b.data[0], b.label[0],
                     tmx.nd.zeros((1,), ctx=ctx), ctx, s, [])
        g = grads["v"]
        rows = g.indices._data.cpu()
        gv = g.data._data.cpu()
        old = table[rows]
        if sgd:
            want = old - s["lr"] * gv
        else:           # the first step of a fresh history: h = g^2
            want = old + gv / (gv * gv + 1e-7).sqrt() * -s["adagrad_lr"]
        got = ps._tables["v"].value[rows]
        worst = max(worst, float((got - want).abs().max()
                                 / want.abs().max()))
        untouched = torch.ones(s["features"], dtype=torch.bool)
        untouched[rows] = False
        if not torch.equal(ps._tables["v"].value[untouched],
                           table[untouched]):
            raise AssertionError("sparse: a push moved an untouched row")
    return worst


def _sparse_dot_check(torch, tmx, it, ctx, s):
    """(c) ``_sparse_dot_csr`` at an FM batch's shapes (1024 rows over its
    touched columns, factor 16), plain and transposed, with the gradients
    of its csr values and dense operand: card against the CPU."""
    it.reset()
    with ctx:
        batch = next(it)
    csr = batch.data[0]
    cols = csr.indices._data.cpu()
    uniq, local = torch.unique(cols, return_inverse=True)
    n = uniq.numel()
    rng = np.random.RandomState(7)
    rhs = rng.randn(n, s["factor"]).astype(np.float32)
    rhs_t = rng.randn(s["batch"], s["factor"]).astype(np.float32)
    head = rng.randn(s["batch"], s["factor"]).astype(np.float32)
    head_t = rng.randn(n, s["factor"]).astype(np.float32)
    out = {}
    for c in (ctx, tmx.cpu()):
        dev = tmx.nd.ndarray._device(c)
        res = []
        for transpose, r_np, h_np in ((False, rhs, head),
                                      (True, rhs_t, head_t)):
            data = tmx.nd.NDArray(csr.data._data.to(dev).clone(), c)
            r = tmx.nd.array(r_np, ctx=c)
            data.attach_grad()
            r.attach_grad()
            with tmx.autograd.record():
                o = tmx.nd._sparse_dot_csr(
                    data, tmx.nd.NDArray(csr.indptr._data.to(dev), c),
                    tmx.nd.NDArray(local.to(dev), c), r,
                    transpose_a=transpose, num_cols=n)
                loss = (o * tmx.nd.array(h_np, ctx=c)).sum()
            loss.backward()
            res += [o._data, data.grad._data, r.grad._data]
        out[c] = res
    errs = [_rel_to_max(torch, a, b) for a, b in zip(out[ctx],
                                                     out[tmx.cpu()])]
    _log(f"sparse dot: _sparse_dot_csr ({s['batch']} x {n}, "
         f"{csr.data.shape[0]} stored) @ ({n}, {s['factor']}) and its "
         f"transpose, outputs and gradients card vs CPU max rel "
         f"{max(errs):.3e} (tol {SPARSE_DOT_TOL})")
    if max(errs) > SPARSE_DOT_TOL:
        raise AssertionError(f"sparse dot: card vs CPU {errs}")
    return max(errs)


def _sparse_embedding(torch, tmx, args, smi, ctx):
    """(b) ``Embedding(1_000_000, 64, sparse_grad=True)`` under
    ``gluon.Trainer`` (SGD) a few steps on the card and on the CPU from
    the same table: each step's ``grad(stype="row_sparse")`` holds exactly
    the touched rows; the tables agree and untouched rows stay bit for
    bit."""
    s = SPARSE
    rng = np.random.RandomState(args.seed + 44)
    table = (rng.standard_normal((s["emb_rows"], s["emb_dim"])) * 0.01) \
        .astype(np.float32)
    head = rng.randn(s["emb_dim"]).astype(np.float32)
    batches = [rng.randint(0, s["emb_rows"], s["emb_batch"])
               .astype(np.float32) for _ in range(s["emb_steps"])]
    res, ok_rows, ms = {}, True, []
    for c in (ctx, tmx.cpu()):
        emb = tmx.gluon.nn.Embedding(s["emb_rows"], s["emb_dim"],
                                     sparse_grad=True)
        emb.initialize(tmx.init.Zero(), ctx=c)
        emb.weight.set_data(tmx.nd.array(table, ctx=c))
        tr = tmx.gluon.Trainer(emb.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        w = tmx.nd.array(head, ctx=c)
        for toks in batches:
            t = tmx.nd.array(toks, ctx=c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tmx.autograd.record():
                loss = (emb(t) * w).sum()
            loss.backward()
            g = emb.weight.grad(stype="row_sparse")
            tr.step(toks.shape[0])
            torch.cuda.synchronize()
            if c is ctx:
                ms.append((time.perf_counter() - t0) * 1e3)
            want = np.unique(toks.astype(np.int64))
            ok_rows &= np.array_equal(g.indices.asnumpy(), want)
        res[c] = emb.weight.data()._data.cpu()
    card, cpu = res[ctx], res[tmx.cpu()]
    touched = np.unique(np.concatenate(batches).astype(np.int64))
    mask = torch.ones(s["emb_rows"], dtype=torch.bool)
    mask[torch.from_numpy(touched)] = False
    same_untouched = torch.equal(card[mask], torch.from_numpy(table)[mask])
    rel = _rel_to_max(torch, card, cpu)
    _log(f"sparse embedding: Embedding({s['emb_rows']}, {s['emb_dim']}, "
         f"sparse_grad=True), {s['emb_steps']} Trainer SGD steps of "
         f"{s['emb_batch']} tokens: grad(stype='row_sparse') holds exactly "
         f"the touched rows {ok_rows}; card vs CPU table max rel {rel:.3e} "
         f"(tol {SPARSE_DOT_TOL}); untouched rows bit-unchanged "
         f"{same_untouched}; median step {statistics.median(ms):.2f} ms "
         f"({smi})")
    if not (ok_rows and same_untouched and rel <= SPARSE_DOT_TOL):
        raise AssertionError(f"sparse embedding failed: rows {ok_rows}, "
                             f"untouched {same_untouched}, rel {rel}")
    return {"emb_step_ms": statistics.median(ms), "emb_rel": rel}


def sparse_phase(torch, fa, mx, args, smi):
    """Sparse storage on the card (module docstring, phase 23).  Returns
    (launch counts: none, numbers)."""
    import shutil
    tmx = mx["pkg"]
    ctx = tmx.gpu()
    gc.collect()
    _fresh_peak(torch)
    _reset_counts(fa)
    root = tempfile.mkdtemp(prefix="mx_sparse_")
    try:
        path = os.path.join(root, "criteo_like.libsvm")
        t0 = time.perf_counter()
        _criteo_like_file(path, args.seed + 43)
        t1 = time.perf_counter()
        it = tmx.io.LibSVMIter(data_libsvm=path,
                               data_shape=(SPARSE["features"],),
                               batch_size=SPARSE["batch"])
        t2 = time.perf_counter()
        with ctx:
            n_rows = sum(b.data[0].shape[0] - b.pad for b in it)
        _log(f"sparse data: {os.path.getsize(path) / 2**20:.1f} MiB LibSVM "
             f"written in {t1 - t0:.1f} s; LibSVMIter read {n_rows} rows "
             f"in {t2 - t1:.1f} s")
        numbers = _sparse_fm(torch, tmx, args, smi, ctx, it)
        numbers["dot_rel"] = _sparse_dot_check(torch, tmx, it, ctx, SPARSE)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers.update(_sparse_embedding(torch, tmx, args, smi, ctx))
    counts = _counts(fa)
    if any(counts.values()):
        raise AssertionError(f"sparse: a flash kernel ran: {counts}")
    _log(f"sparse numbers ({smi}): " + ", ".join(
        f"{k} {v:.4g}" for k, v in numbers.items()))
    return counts, numbers


# -- np: mx.np, npx and util --------------------------------------------------

NP_STEPS = 8
NP_LAYERS = 12         # the np phase's BERT-base: the whole depth
NP_LOSS_TOL = 1e-6     # relative: the np head's step-1 loss, SoftmaxCELoss
NP_CURVE_TOL = 2e-3    # relative a step: the np curve against the nd curve


def _np_sweep(torch, tmx):
    """Every np.* registry name on the card and on the CPU from the same
    seeded inputs (``numpy/_sweep.py``): values within ``_sweep.TOL``,
    dtypes equal, every output array on the card.  The card's calls run
    under ``torch.cuda.set_sync_debug_mode("warn")`` (inputs made first),
    which names the functions that synchronised with the host.  Returns
    (cases, mismatches, synchronised names)."""
    import warnings
    from mxnet_tpu_torch.numpy import _sweep
    bad, synced = [], []
    with warnings.catch_warnings():     # the mode's own first warning
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    for name in _sweep.names():
        want = _sweep.run(tmx.np, name, tmx.cpu())
        with tmx.gpu():
            xs = [tmx.np.array(a) for a in _sweep.inputs(name)]
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = _sweep.leaves(_sweep.call(tmx.np, name, xs))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        where = [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]
        if where:
            synced.append(f"{name} ({where[0]})")
        off_card = [type(v).__name__ for v in out if hasattr(v, "context")
                    and v.context.device_type != "gpu"]
        got = _sweep.to_numpy(out)
        err, tol, same = _sweep.close(name, got, want)
        if err > tol or not same or off_card:
            bad.append(name)
            _log(f"np sweep MISMATCH {name}: {err:.3g} (bound {tol:g}), "
                 f"dtypes {[str(g.dtype) for g in got]} vs "
                 f"{[str(w.dtype) for w in want]}, off the card {off_card}")
    # the registry runs the same ops: with no inputs, on the current context
    with tmx.gpu():
        for name, attrs in [("zeros", {"shape": (2, 3)}),
                            ("arange", {"start": 5}), ("eye", {"N": 3})]:
            out = tmx.ops.invoke("np." + name, [], attrs)
            if out.context.device_type != "gpu":
                bad.append(name)
                _log(f"np sweep MISMATCH mx.ops.invoke('np.{name}') made "
                     f"its array on {out.context}")
    listed = [n for n in synced if n.split(" ")[0] in _sweep.HOST_SYNC]
    _log(f"np sweep: {len(_sweep.names())} np.* names card vs CPU, "
         f"{len(bad)} mismatches; {len(synced)} synchronised with the host "
         f"(the first place each did): {synced}; {len(listed)} of them have "
         f"shapes that depend on the values (_sweep.HOST_SYNC)")
    return len(_sweep.names()), bad, synced


def _np_dispatch_us(torch, tmx, calls=2000):
    """Host microseconds a call of ``mx.np.add`` and of ``mx.nd.elemwise_add``
    on two 4-element card arrays (one launch each), in turns np, nd, nd,
    np, each turn timed after a synchronize to the synchronize after its
    last call: the dispatch's host cost beside the nd op's."""
    with tmx.gpu():
        a = tmx.np.array(np.arange(4, dtype=np.float32))
        b = tmx.np.array(np.ones(4, dtype=np.float32))
    fns = {"np": tmx.np.add, "nd": tmx.nd.elemwise_add}
    for f in fns.values():
        f(a, b)
    us = {"np": [], "nd": []}
    for kind in ("np", "nd", "nd", "np"):
        f = fns[kind]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f(a, b)
        torch.cuda.synchronize()
        us[kind].append((time.perf_counter() - t0) / calls * 1e6)
    return {k: statistics.median(v) for k, v in us.items()}


def _np_head(tmx):
    """The MLM loss in mx.np / npx only, a hybridized block: the mean
    negative log-likelihood of the labels under the f32 logits."""
    np_, npx = tmx.np, tmx.npx

    class NpMLMLoss(tmx.gluon.HybridBlock):
        def hybrid_forward(self, F, logits, labels):
            logp = npx.log_softmax(np_.astype(logits, "float32"), axis=-1)
            picked = np_.take_along_axis(logp, np_.expand_dims(labels, -1),
                                         axis=-1)
            return np_.negative(np_.mean(picked))
    head = NpMLMLoss()
    head.hybridize()
    return head


def _np_bert(torch, fa, tmx, args, smi):
    """BERT-base trained NP_STEPS steps under npx.set_np() with the np
    head, on tokens and labels from mx.np.random on the card; then the
    same steps in mx.nd from the same start; save/load through npx.
    Returns (launch counts of the np steps, numbers)."""
    u = UTIL
    B, L = u["batch"], u["len"]
    _fresh_peak(torch)
    net = _util_net(torch, tmx, args.seed, layers=NP_LAYERS)
    params = net.collect_params()
    start = {k: p.data()._data.detach().clone() for k, p in params.items()}
    trainer = tmx.gluon.Trainer(params, "adam", {
        "learning_rate": u["lr"], "multi_precision": True})
    head = _np_head(tmx)
    tmx.npx.set_np()
    try:
        tmx.np.random.seed(args.seed + 24)
        toks = tmx.np.random.randint(0, u["vocab"], size=(B, L))
        labs = tmx.np.random.randint(0, u["vocab"], size=(B, L))
        if toks.context != tmx.gpu() or labs.dtype != np.int64:
            raise AssertionError(f"np.random drew {toks.context} "
                                 f"{labs.dtype}")

        def np_step(losses, ms, check=False):
            t = time.perf_counter()
            with tmx.autograd.record():
                logits = net(toks)[2]
                loss = head(logits, labs)
            loss.backward()
            if check:
                ce = tmx.gluon.loss.SoftmaxCELoss()(
                    logits.astype("float32", copy=False), labs).mean()
                a, b = float(loss.asscalar()), float(ce.asscalar())
                _log(f"np head: step-1 loss {a!r} against SoftmaxCELoss "
                     f"{b!r} on the same logits (rel {abs(a - b) / b:.2e})")
                if abs(a - b) > NP_LOSS_TOL * abs(b):
                    raise AssertionError(f"np loss {a} against {b}")
            trainer.step(1)
            losses.append(loss)
            tmx.nd.waitall()
            ms.append((time.perf_counter() - t) * 1e3)

        _reset_counts(fa)
        np_losses, ms = [], []
        for i in range(NP_STEPS):
            np_step(np_losses, ms, check=i == 0)
        counts = _counts(fa)
        np_losses = [float(l.asscalar()) for l in np_losses]
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = _profile_step(torch, lambda: np_step([], []),
                             "np BERT-base step")
        with tempfile.TemporaryDirectory(prefix="mx_np_") as d:
            f = os.path.join(d, "params.npz")
            saved = {k: p.data() for k, p in params.items()}
            tmx.npx.save(f, saved)
            back = tmx.npx.load(f)
            same = set(back) == set(saved) and all(
                back[k].dtype == saved[k].dtype and torch.equal(
                    back[k]._data.to(saved[k]._data.device), saved[k]._data)
                for k in saved)
        if not same:
            raise AssertionError("npx.save / npx.load changed a parameter")
    finally:
        tmx.npx.reset_np()
    want = {k: NP_STEPS * NP_LAYERS for k in ("flash_fwd",
                                              "flash_bwd_fused")}
    if {k: counts[k] for k in want} != want or any(
            v for k, v in counts.items() if k not in want):
        raise AssertionError(f"np BERT-base launches {counts}")
    # the same steps in mx.nd from the same start weights and batch
    for k, p in params.items():
        p.set_data(start[k])
        p.data()._data.grad = None
    trainer = tmx.gluon.Trainer(params, "adam", {
        "learning_rate": u["lr"], "multi_precision": True})
    nd_losses, _ = _gluon_steps(tmx, net, [toks], labs, NP_STEPS, trainer)
    rel = [abs(a - b) / abs(b) for a, b in zip(np_losses, nd_losses)]
    _log(f"np BERT-base: np curve {[round(x, 5) for x in np_losses]}, nd "
         f"curve {[round(x, 5) for x in nd_losses]}, max rel "
         f"{max(rel):.2e} (bound {NP_CURVE_TOL:g})")
    if max(rel) > NP_CURVE_TOL or not np_losses[-1] < np_losses[0]:
        raise AssertionError(f"np curve {np_losses} against nd {nd_losses}")
    med = statistics.median(ms[1:])
    # the gluon phase's count: 6 x the non-embedding weights a token, and
    # attention's 12 x layers x units x L
    n_matmul = sum(p.numel() for n, p in net.named_parameters()
                   if "word_embed" not in n and "position" not in n)
    flops_tok = 6 * n_matmul + 12 * NP_LAYERS * u["units"] * L
    numbers = {"step_ms": med, "samples_per_s": B / (med / 1e3),
               "mfu": B / (med / 1e3) * L * flops_tok
               / PEAK_FLOPS["bfloat16"],
               "peak_gib": peak,
               "idle_share": max(0.0, 1 - prof["device_ms"]
                                 / prof["wall_ms"])}
    _log(f"np BERT-base ({smi}): median step {med:.2f} ms of steps 2-"
         f"{NP_STEPS}, {numbers['samples_per_s']:.2f} samples/s, MFU "
         f"{numbers['mfu']:.4f}, peak {peak:.2f} GiB, idle share "
         f"{numbers['idle_share']:.3f}; launches {counts}")
    return counts, numbers


def np_phase(torch, fa, mx, args, smi):
    """mx.np, npx and util on the card: the sweep of every np.* name card
    against CPU, then BERT-base trained under npx.set_np() with an np loss
    head.  Returns (launch counts of the BERT steps, numbers)."""
    tmx = mx["pkg"]
    gc.collect()
    torch.cuda.empty_cache()
    n, bad, synced = _np_sweep(torch, tmx)
    if bad:
        raise AssertionError(f"np sweep: {len(bad)} of {n} mismatch: {bad}")
    us = _np_dispatch_us(torch, tmx)
    _log(f"np dispatch ({smi}): mx.np.add {us['np']:.2f} us a call, "
         f"mx.nd.elemwise_add {us['nd']:.2f} us (host clock, 4-element "
         f"card arrays, median of two turns of 2000 calls)")
    counts, numbers = _np_bert(torch, fa, tmx, args, smi)
    numbers.update({"sweep_names": n, "sweep_mismatches": len(bad),
                    "sweep_synchronised": len(synced),
                    "np_add_us": us["np"], "nd_add_us": us["nd"]})
    gc.collect()
    torch.cuda.empty_cache()
    return counts, numbers


# -- sp: the device mesh, sequence-parallel attention, the dist kvstore -------

# llama3_8b (LLAMA_CONFIGS["llama3_8b"]): 32 heads, 8 kv heads, head_dim
# 128, 4096 units, FFN 14336, vocab 128256; its attention over a 4-shard
# sequence axis of the one card at 16384 positions (bf16) and 4096 (f32,
# and f32 with the last 1000 positions padded), then the model cut to 2
# layers at B 2 x L 4096 on a dp 2 x sp 4 mesh of the card
SP = {"shards": 4, "heads": 32, "kv_heads": 8, "head_dim": 128,
      "len_bf16": 16384, "len_f32": 4096, "pad": 1000,
      "vocab": 128256, "layers": 2, "units": 4096, "hidden": 14336,
      "batch": 2, "len": 4096, "steps": 3, "lr": 1e-4}
# (out, gradients) over max |ref| against the unsharded flash call: f32
# sums in another order; in bf16 each ring block's output is rounded to
# bf16 before the f32 merge and each block's dq, dk, dv before their f32
# sum (up to 4 roundings a position where the unsharded call has one)
SP_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 2e-2)}
SP_IMPLS = ("fused", "ring", "ulysses")
SP_DP = 2           # the dp axis of the sp llama's mesh


def _sp_launches(impl, n, layers=1):
    """Flash launches of one forward + backward of ``layers`` attention
    calls: the ring's n(n+1)/2 causal blocks, Ulysses' n head groups, the
    unsharded call; every sequence here is longer than BWD_BLOCK, so each
    backward is one dq and one dkv launch."""
    per = {"ring": n * (n + 1) // 2, "ulysses": n, "fused": 1}[impl]
    return {"flash_fwd": per * layers, "flash_bwd_dq": per * layers,
            "flash_bwd_dkv": per * layers, "flash_bwd_fused": 0}


def _sp_grads(torch, attend, q, k, v, do):
    """(out, dq, dk, dv) of ``attend(q, k, v)`` and the gradients of
    sum(out * do)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = attend(*leaves)
    return (out.detach(), *torch.autograd.grad(out, leaves, do))


def _sp_plain(torch, fa, label, dname, q, k, v, do, seg_q, seg_kv, causal,
              scale, phase="sp"):
    """The flash kernels (``flash_attention``, forward and backward)
    against their plain version on the same inputs, at one shape the sp
    path gives them: out, dq, dk, dv over max |plain|, within SP_TOL."""
    def attend(fn):
        return lambda a, b, c: fn(a, b, c, seg_q, seg_kv, causal, scale)
    got = _sp_grads(torch, attend(fa.flash_attention), q, k, v, do)
    want = _sp_grads(torch, attend(fa.flash_attention_plain), q, k, v, do)
    errs = [((a.float() - b.float()).abs().max()
             / b.float().abs().max()).item() for a, b in zip(got, want)]
    tol_out, tol_grad = SP_TOL[dname]
    _log(f"{phase} plain {label} {tuple(q.shape)} kv {tuple(k.shape)[2]} "
         f"{dname} causal={causal}: out, dq, dk, dv against the plain "
         f"version {[f'{e:.2e}' for e in errs]} of max |plain| (bounds "
         f"{tol_out:g}, {tol_grad:g})")
    if errs[0] > tol_out or max(errs[1:]) > tol_grad:
        raise AssertionError(f"{phase} plain {label} {dname}: {errs}")
    return errs


def _sp_plain_cases(torch, fa, dname, L_label, q, k, v, do, seg, n, scale,
                    ulysses=True):
    """_sp_plain at the shapes ring and Ulysses give the kernels for one
    (q, k, v) over n shards: the unsharded call, the ring's diagonal block
    (0, 0) causal and its block (1, 0) not, and Ulysses' head group."""
    Lb = q.shape[2] // n

    def blk(t, i):
        return t[:, :, i * Lb:(i + 1) * Lb]

    def sblk(i):
        return None if seg is None else seg[:, i * Lb:(i + 1) * Lb]
    cases = [("unsharded", q, k, v, do, seg, seg, True),
             ("ring block (0, 0)", blk(q, 0), blk(k, 0), blk(v, 0),
              blk(do, 0), sblk(0), sblk(0), True),
             ("ring block (1, 0)", blk(q, 1), blk(k, 0), blk(v, 0),
              blk(do, 1), sblk(1), sblk(0), False)]
    if ulysses:
        g = q.shape[1] // n
        cases.append(("ulysses group", q[:, :g], k[:, :g], v[:, :g],
                      do[:, :g], None, None, True))
    return {name: _sp_plain(torch, fa, f"{name} {L_label}", dname,
                            *(t.contiguous() if t is not None else None
                              for t in ts), causal, scale)
            for name, *ts, causal in cases}


def _sp_kernels(torch, fa, tmx, smi):
    """Ring and Ulysses on DeviceMesh((4,), ("sp",)) of the card against
    flash_attention over the whole sequence: out, dq, dk, dv, the launches
    of one call, and device ms beside the unsharded call.  The flash
    kernels themselves are held against their plain version at each shape
    this path and the llama's give them (_sp_plain_cases)."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.kernels.ring_attention import \
        sequence_parallel_attention as ring
    from mxnet_tpu_torch.kernels.ulysses import \
        ulysses_sequence_parallel_attention as ulysses
    n, H, D = SP["shards"], SP["heads"], SP["head_dim"]
    mesh = parallel.DeviceMesh((n,), ("sp",), devices=[tmx.gpu(0)] * n)
    scale = 1.0 / math.sqrt(D)
    g = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for dname, L, padded in (("bfloat16", SP["len_bf16"], False),
                             ("float32", SP["len_f32"], False),
                             ("float32", SP["len_f32"], True)):
        dt = getattr(torch, dname)

        def draw(heads):
            return torch.randn(1, heads, L, D, generator=g, device="cuda",
                               dtype=dt)
        q, do = draw(H), draw(H)
        k, v = (draw(SP["kv_heads"]).repeat_interleave(
            H // SP["kv_heads"], dim=1) for _ in range(2))
        seg = _segs(torch, 1, L, SP["pad"], "cuda") if padded else None
        fns = {"fused": lambda a, b, c: fa.flash_attention(
                   a, b, c, seg, seg, True, scale),
               "ring": lambda a, b, c: ring(a, b, c, mesh, "sp", seg, seg,
                                            True, scale)}
        if not padded:
            fns["ulysses"] = lambda a, b, c: ulysses(
                a, b, c, mesh, "sp", causal=True, sm_scale=scale)
        want = _sp_grads(torch, fns["fused"], q, k, v, do)
        tol_out, tol_grad = SP_TOL[dname]
        label = f"{dname} L={L}" + (f" padded {SP['pad']}" if padded else "")
        out[("plain", dname, padded)] = _sp_plain_cases(
            torch, fa, dname, label, q, k, v, do, seg, n, scale,
            ulysses=not padded)
        ms = {}
        for impl, fn in fns.items():
            _reset_counts(fa)
            got = _sp_grads(torch, fn, q, k, v, do)
            counts = _counts(fa)
            want_counts = _sp_launches(impl, n)
            if {c: counts[c] for c in want_counts} != want_counts or \
                    counts["flash_fwd_f32"] != (
                        want_counts["flash_fwd"] if dname == "float32"
                        else 0):
                raise AssertionError(f"sp {impl} {label}: launches "
                                     f"{counts}, want {want_counts}")
            errs = [((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
                    for a, b in zip(got, want)]
            ms[impl] = (
                _time_ms(torch, lambda f=fn: f(q, k, v), iters=2, reps=3,
                         warmup=1),
                _time_ms(torch, lambda f=fn: _sp_grads(torch, f, q, k, v,
                                                       do),
                         iters=2, reps=3, warmup=1))
            if impl != "fused":
                _log(f"sp {impl} {label}: out, dq, dk, dv against the "
                     f"unsharded flash call {[f'{e:.2e}' for e in errs]} "
                     f"of max |ref| (bounds {tol_out:g}, {tol_grad:g}); "
                     f"launches a call: forward {counts['flash_fwd']}, dq "
                     f"{counts['flash_bwd_dq']}, dkv {counts['flash_bwd_dkv']}")
                if errs[0] > tol_out or max(errs[1:]) > tol_grad:
                    raise AssertionError(f"sp {impl} {label}: {errs}")
                out[(impl, dname, padded)] = {"errs": errs}
        _log(f"sp times {label} ({smi}): forward / forward+backward ms: "
             + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b)
                         in ms.items()))
        for impl in fns:
            if impl != "fused":
                out[(impl, dname, padded)].update(
                    {"ms": ms[impl], "fused_ms": ms["fused"]})
        del q, k, v, do, want
    # the llama's shapes (L 4096 bf16 on sp 4, the B 2 batch split over
    # dp 2: B 1 a dp shard): its fused call, its ring blocks and its
    # Ulysses head groups
    B, L = SP["batch"] // SP_DP, SP["len"]
    q, do = (torch.randn(B, H, L, D, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, SP["kv_heads"], L, D, generator=g, device="cuda",
                        dtype=torch.bfloat16).repeat_interleave(
                            H // SP["kv_heads"], dim=1) for _ in range(2))
    out[("plain", "llama")] = _sp_plain_cases(
        torch, fa, "bfloat16", f"llama B={B} L={L}", q, k, v, do, None, n,
        scale)
    return out


def _sp_llama(torch, fa, mx, args, smi):
    """llama3_8b's widths cut to 2 layers, bf16, B 2 x L 4096, 3 TrainStep
    steps with multi-precision Adam for each attn_impl on a dp 2 x sp 4
    mesh of the card, from the same weights and batch.  Returns (per impl:
    losses, launch counts, numbers; the last run's gradients)."""
    from mxnet_tpu_torch import parallel
    tmx, llama = mx["pkg"], mx["llama"]
    s = SP
    mesh = parallel.DeviceMesh((2, 4), ("dp", "sp"), devices=[tmx.gpu(0)] * 8)
    rng = np.random.RandomState(args.seed + 25)
    toks = rng.randint(0, s["vocab"], (s["batch"], s["len"]))
    toks = torch.tensor(toks, dtype=torch.int32, device="cuda")
    labs = torch.roll(toks, -1, dims=1)
    runs, grads = {}, None
    prev = parallel.current_mesh()
    parallel.set_mesh(mesh)
    try:
        for impl in SP_IMPLS:
            _fresh_peak(torch)
            net = llama.LlamaModel(
                vocab_size=s["vocab"], num_layers=s["layers"],
                units=s["units"], hidden=s["hidden"], heads=s["heads"],
                kv_heads=s["kv_heads"], attn_impl=impl, prefix="llm_")
            net.cast(torch.bfloat16)        # drawn in bf16
            tmx.random.seed(args.seed)
            net.initialize(_llama_init(tmx, 0.02), ctx=tmx.gpu())
            # the tokens split over sp only where attention runs over it
            step = parallel.TrainStep(
                net, _llama_loss(mx["nn"]), mx["optimizer"].Adam(
                    learning_rate=s["lr"], multi_precision=True),
                mesh=mesh, data_spec=("dp",) if impl == "fused"
                else ("dp", "sp"))
            _reset_counts(fa)
            losses, _ = _timed_steps(torch, step, toks, labs, s["steps"])
            counts = _counts(fa)
            # the batch splits over the mesh's 2 dp shards, each running
            # its own forward: 2 x the attention calls of one forward
            want = {k: v * s["steps"] for k, v in _sp_launches(
                impl, s["shards"], s["layers"] * SP_DP).items()}
            if {k: counts[k] for k in want} != want or any(
                    counts[k] for k in counts if k not in want):
                raise AssertionError(f"sp llama {impl}: launches {counts}, "
                                     f"want {want}")
            _, ms = _timed_steps(torch, step, toks, labs, 3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            prof = _profile_step(torch, lambda: step(toks, labs),
                                 f"sp llama {impl}")
            med = statistics.median(ms)
            n_matmul = sum(p.numel() for n_, p in net.named_parameters()
                           if not n_.startswith("embed"))
            flops_tok = 6 * n_matmul + 6 * s["layers"] * s["units"] \
                * s["len"]
            tps = s["batch"] * s["len"] / (med / 1e3)
            runs[impl] = {
                "losses": losses, "counts": counts, "step_ms": med,
                "tokens_per_s": tps,
                "mfu": tps * flops_tok / PEAK_FLOPS["bfloat16"],
                "peak_gib": peak,
                "idle_share": max(0.0, 1 - prof["device_ms"]
                                  / prof["wall_ms"])}
            if impl == SP_IMPLS[-1]:
                grads = [p.grad.detach().clone() for p in step._params]
            step = net = None
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        parallel.set_mesh(prev)
    fused = runs["fused"]["losses"]
    for impl in SP_IMPLS:
        r = runs[impl]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], fused))
        _log(f"sp llama {impl} ({smi}): losses "
             f"{[round(x, 5) for x in r['losses']]} (max rel {rel:.2e} "
             f"against fused, bound {BF16_LOSS_TOL:g}); step "
             f"{r['step_ms']:.2f} ms, {r['tokens_per_s']:.1f} tokens/s, "
             f"MFU {r['mfu']:.4f}, peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}; launches over {s['steps']} steps "
             f"{ {k: v for k, v in r['counts'].items() if v} }")
        if rel > BF16_LOSS_TOL or not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"sp llama {impl}: {r['losses']} against "
                                 f"fused {fused}")
    return runs, grads


def _sp_collectives(torch, tmx, grads, smi):
    """allreduce / allgather over 4 shards of the card against plain torch;
    mx.kv.create("dist_sync") as a world of one over NCCL: its
    pushpull_list of the llama's gradients equals the local store's bit
    for bit."""
    from mxnet_tpu_torch import parallel
    g = torch.Generator(device="cuda").manual_seed(26)
    ts = [torch.randn(1024, 1024, generator=g, device="cuda")
          for _ in range(SP["shards"])]
    ctxs = [tmx.gpu(0)] * SP["shards"]
    vals = [tmx.nd.NDArray(t, c) for t, c in zip(ts, ctxs)]
    plain = ts[0] + ts[1] + ts[2] + ts[3]
    checks = {
        "allreduce sum": (parallel.allreduce(vals), plain),
        "allreduce mean": (parallel.allreduce(vals, op="mean"),
                           plain / SP["shards"]),
        "allgather": (parallel.allgather(vals), torch.cat(ts))}
    for name, (outs, want) in checks.items():
        if len(outs) != SP["shards"] or not all(
                torch.equal(o._data, want) and o.ctx == tmx.gpu(0)
                for o in outs):
            raise AssertionError(f"sp {name} differs from plain torch")
    kv = tmx.kv.create("dist_sync")
    if (kv.backend, kv.rank, kv.num_workers) != ("nccl", 0, 1):
        raise AssertionError(f"dist_sync: {kv.backend} rank {kv.rank} of "
                             f"{kv.num_workers}")
    local = tmx.kv.create("local")
    keys = list(range(len(grads)))
    vals = [tmx.nd.NDArray(t, tmx.gpu(0)) for t in grads]
    outs, ms = {}, {}
    for name, store in (("dist", kv), ("local", local)):
        for k, t in zip(keys, grads):
            store.init(k, tmx.nd.NDArray(torch.zeros_like(t), tmx.gpu(0)))
        outs[name] = [tmx.nd.NDArray(torch.empty_like(t), tmx.gpu(0))
                      for t in grads]
        ms[name] = []
        for _ in range(2):      # the first dist call creates NCCL's comm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.pushpull_list(keys, vals, outs[name])
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    same = all(torch.equal(a._data, b._data)
               for a, b in zip(outs["dist"], outs["local"]))
    nbytes = sum(t.numel() * t.element_size() for t in grads)
    _log(f"sp collectives ({smi}): allreduce sum and mean, allgather over "
         f"{SP['shards']} shards of the card equal to plain torch; "
         f"dist_sync: {kv.backend}, rank {kv.rank} of {kv.num_workers}; "
         f"pushpull_list of {len(grads)} gradients ({nbytes / 2**30:.2f} "
         f"GiB) equal to the local store's bit for bit: {same}; host ms "
         f"of two calls: dist {ms['dist'][0]:.1f} (with NCCL's set-up), "
         f"{ms['dist'][1]:.1f}; local {ms['local'][0]:.1f}, "
         f"{ms['local'][1]:.1f}")
    if not same:
        raise AssertionError("dist_sync and local pushpull_list differ")


def sp_phase(torch, fa, mx, args, smi):
    """The device mesh and sequence-parallel attention on the card: (a)
    ring and Ulysses at llama3_8b's attention shape against the unsharded
    flash kernels; (b) llama3_8b's widths, 2 layers, trained through
    TrainStep on a dp x sp mesh with each attn_impl; (c) the eager
    collectives and the dist kvstore over NCCL.  Returns (launch counts
    of (b)'s steps, numbers)."""
    tmx = mx["pkg"]
    gc.collect()
    torch.cuda.empty_cache()
    kernels = _sp_kernels(torch, fa, tmx, smi)
    runs, grads = _sp_llama(torch, fa, mx, args, smi)
    _sp_collectives(torch, tmx, grads, smi)
    grads = None
    counts = {k: sum(r["counts"][k] for r in runs.values())
              for k in _COUNTERS}
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"kernels": kernels, "llama": runs}


# -- the shard phase: sharding rules, the sharded step, autoshard, GPipe -----

# llama3_8b's widths cut to 2 layers, bf16, multi-precision Adam; (a) tp on
# a dp 2 x tp 2 mesh of the card, B 2 x L 4096; (b) the autoshard plan for
# 4 shards, B 4 x L 2048; (c) GPipe over the 2 blocks, 4 microbatches of
# 2048 tokens
SHARD = {"vocab": 128256, "layers": 2, "units": 4096, "hidden": 14336,
         "heads": 32, "kv_heads": 8, "head_dim": 128, "lr": 1e-4,
         "steps": 4, "timed": 3, "tp_batch": 2, "tp_len": 4096,
         "plan_batch": 4, "plan_len": 2048, "plan_shards": 4,
         "pipe_micro": 4, "pipe_batch": 4, "pipe_len": 2048}
# the plan's budget over the dp-only estimate: the reference's recipe takes
# 0.4, where at this cut depth (a 128256-word head over 2 layers: the
# logits dominate) only tp 4 with 4 microbatches fits; at 0.5 the first
# fitter is fsdp 4 (both printed)
SHARD_BUDGETS = (0.4, 0.5)
# the pipeline against the sequential blocks, over max |ref|: the output
# (each microbatch's products round in bf16 as the whole batch's do, but
# cuBLAS may pick another kernel at another M) and the weights' gradients
# (the 4 microbatches' bf16 gradients add in bf16 where one product over
# the batch accumulates in f32)
SHARD_PIPE_TOL = (2e-2, 5e-2)


def _shard_llama(torch, tmx, llama, seed):
    s = SHARD
    net = llama.LlamaModel(
        vocab_size=s["vocab"], num_layers=s["layers"], units=s["units"],
        hidden=s["hidden"], heads=s["heads"], kv_heads=s["kv_heads"],
        prefix="llm_")
    net.cast(torch.bfloat16)            # drawn in bf16
    tmx.random.seed(seed)
    net.initialize(_llama_init(tmx, 0.02), ctx=tmx.gpu())
    return net


def _shard_batch(torch, seed, B, L):
    rng = np.random.RandomState(seed)
    toks = torch.tensor(rng.randint(0, SHARD["vocab"], (B, L)),
                        dtype=torch.int32, device="cuda")
    return toks, torch.roll(toks, -1, dims=1)


def _shard_bytes(torch, step, mesh):
    """Per shard (row-major): the bytes of the parameter slices and of
    their optimizer state that shard holds (a whole parameter counts in
    every shard)."""
    import itertools
    from mxnet_tpu_torch.parallel import _flat
    state_of = {id(t): st for t, st in zip(step._params, step._states)}
    out = []
    for coords in itertools.product(*(range(n) for n in mesh.shape)):
        pb = sb = 0
        for p in step.net.collect_params().values():
            t = p._slices.held_by(coords) if p._slices is not None \
                else p.data()._data
            pb += t.numel() * t.element_size()
            sb += sum(x.numel() * x.element_size()
                      for x in _flat(state_of.get(id(t)), []))
        out.append((pb, sb))
    return out


def _shard_run(torch, fa, tmx, mx, net, label, toks, labs, smi, **kw):
    """SHARD["steps"] TrainStep steps (multi-precision Adam), counted,
    then SHARD["timed"] timed replays and one profiled step: (losses,
    launch counts of the counted steps, numbers, step)."""
    s = SHARD
    step = tmx.parallel.TrainStep(
        net, _llama_loss(mx["nn"]), mx["optimizer"].Adam(
            learning_rate=s["lr"], multi_precision=True), **kw)
    _fresh_peak(torch)
    _reset_counts(fa)
    losses, _ = _timed_steps(torch, step, toks, labs, s["steps"])
    counts = _counts(fa)
    _, ms = _timed_steps(torch, step, toks, labs, s["timed"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = _profile_step(torch, lambda: step(toks, labs), f"shard {label}")
    med = statistics.median(ms)
    n_matmul = sum(p.shape[0] * p.shape[1] for n_, p in
                   net.collect_params().items()
                   if len(p.shape) == 2 and "tok_" not in n_)
    tokens = toks.numel()
    flops_tok = 6 * n_matmul + 6 * s["layers"] * s["units"] * toks.shape[1]
    tps = tokens / (med / 1e3)
    return losses, counts, {
        "step_ms": med, "tokens_per_s": tps,
        "mfu": tps * flops_tok / PEAK_FLOPS["bfloat16"], "peak_gib": peak,
        "idle_share": max(0.0, 1 - prof["device_ms"] / prof["wall_ms"])}, \
        step


def _shard_check_launches(label, counts, per_step):
    want = {"flash_fwd": per_step, "flash_bwd_dq": per_step,
            "flash_bwd_dkv": per_step}
    want = {k: v * SHARD["steps"] for k, v in want.items()}
    if {k: counts[k] for k in want} != want or any(
            counts[k] for k in counts if k not in want):
        raise AssertionError(f"shard {label}: launches {counts}, want "
                             f"{want}")


def _shard_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _shard_tp(torch, fa, mx, args, smi):
    """(a): llama_rules on dp 2 x tp 2 against the unsharded step from the
    same weights and batch; returns (launch counts, numbers, the trained
    sharded net, its mesh, the batch)."""
    tmx, llama = mx["pkg"], mx["llama"]
    from mxnet_tpu_torch import sharding
    s = SHARD
    toks, labs = _shard_batch(torch, args.seed + 26, s["tp_batch"],
                              s["tp_len"])
    ref_losses, _, ref, step = _shard_run(
        torch, fa, tmx, mx, _shard_llama(torch, tmx, llama, args.seed),
        "tp unsharded", toks, labs, smi)
    ref_params = sum(p.data()._data.numel() * 2 for p in
                     step.net.collect_params().values())
    ref_state = sum(x.numel() * x.element_size() for st in step._states
                    for x in tmx.parallel._flat(st, []))
    step = None
    gc.collect()
    torch.cuda.empty_cache()
    mesh = tmx.parallel.DeviceMesh((2, 2), ("dp", "tp"),
                                   devices=[tmx.gpu(0)] * 4)
    net = _shard_llama(torch, tmx, llama, args.seed)
    before = dict(llama.TP_COUNTS)
    losses, counts, num, step = _shard_run(
        torch, fa, tmx, mx, net, "tp dp2xtp2", toks, labs, smi, mesh=mesh,
        partition_rules=sharding.rule_pack("llama"))
    split = llama.TP_COUNTS["split"] - before["split"]
    gathered = llama.TP_COUNTS["gathered"] - before["gathered"]
    per_shard = _shard_bytes(torch, step, mesh)
    rel = _shard_rel(losses, ref_losses)
    _log(f"shard tp ({smi}): llama3_8b widths, {s['layers']} layers, bf16, "
         f"B {s['tp_batch']} x L {s['tp_len']}, rule_pack('llama') on "
         f"dp 2 x tp 2 of the card: losses {[round(x, 5) for x in losses]}"
         f" against the unsharded step's "
         f"{[round(x, 5) for x in ref_losses]} (max rel {rel:.2e}, bound "
         f"{SHARD_LOSS_TOL:g}); blocks on the tp path {split}, gathered "
         f"{gathered} (Python forwards: the eager step and the capture); "
         f"launches over {s['steps']} steps "
         f"{ {k: v for k, v in counts.items() if v} }")
    for i, (pb, sb) in enumerate(per_shard):
        _log(f"shard tp bytes: shard {i}: parameters {pb / 2**30:.3f} GiB, "
             f"optimizer state {sb / 2**30:.3f} GiB; unsharded totals / tp:"
             f" {ref_params / 2 / 2**30:.3f} GiB, "
             f"{ref_state / 2 / 2**30:.3f} GiB")
    for label, r in (("unsharded", ref), ("dp2xtp2", num)):
        _log(f"shard tp {label} ({smi}): step {r['step_ms']:.2f} ms, "
             f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB, idle share {r['idle_share']:.3f}")
    if rel > SHARD_LOSS_TOL or not all(map(math.isfinite, losses)):
        raise AssertionError(f"shard tp: {losses} against {ref_losses}")
    # each Python forward (the eager first step, the capture) runs every
    # block on the tp path once a data shard
    if not split or split % (2 * s["layers"]) or gathered:
        raise AssertionError(f"shard tp: tp path taken {split} times, "
                             f"gathered {gathered}")
    # a data shard's blocks attend per tp shard: dp x tp x layers a step
    _shard_check_launches("tp", counts, 2 * 2 * s["layers"])
    step = None
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"ref": ref, "tp": num, "losses": losses,
                    "ref_losses": ref_losses}, net, mesh, (toks, labs)


def _shard_plan(torch, fa, mx, args, smi):
    """(b): the plan for 4 shards under a budget below the dp-only
    estimate, trained through TrainStep(plan=) against the unsharded step
    from the same weights and batch."""
    tmx, llama = mx["pkg"], mx["llama"]
    from mxnet_tpu_torch import autoshard
    from mxnet_tpu_torch.telemetry import costmodel as tcm
    s = SHARD
    B, L, n = s["plan_batch"], s["plan_len"], s["plan_shards"]
    shapes = llama.LlamaModel(
        vocab_size=s["vocab"], num_layers=s["layers"], units=s["units"],
        hidden=s["hidden"], heads=s["heads"], kv_heads=s["kv_heads"],
        prefix="llm_")
    shapes.cast(torch.bfloat16)         # shapes and dtypes, no values
    dp_est = tcm.estimate_memory(shapes, {"dp": n}, None, batch=B, seq=L,
                                 data_axes=("dp",), multi_precision=True)
    plans = {}
    for frac in SHARD_BUDGETS:
        plans[frac] = autoshard.plan(
            shapes, global_batch=B, seq=L, n_devices=n, multi_precision=True,
            hbm_budget_bytes=int(frac * dp_est["total_bytes"]))
        _log(f"shard plan ({smi}): budget {frac} x the dp-only estimate "
             f"{dp_est['total_bytes'] / 2**30:.2f} GiB: {plans[frac]!r}, "
             f"estimated step {plans[frac].step_time_s:.4f} s; runners "
             f"{plans[frac].search['top']}")
    plan = plans[SHARD_BUDGETS[-1]]
    if "fsdp" not in plan.mesh_axes:
        raise AssertionError(f"shard plan: {plan!r} carries no fsdp")
    toks, labs = _shard_batch(torch, args.seed + 27, B, L)
    ref_losses, _, ref, step = _shard_run(
        torch, fa, tmx, mx, _shard_llama(torch, tmx, llama, args.seed),
        "plan unsharded", toks, labs, smi)
    step = None
    gc.collect()
    torch.cuda.empty_cache()
    losses, counts, num, step = _shard_run(
        torch, fa, tmx, mx, _shard_llama(torch, tmx, llama, args.seed),
        "plan", toks, labs, smi, plan=plan)
    per_shard = _shard_bytes(torch, step, step.mesh)
    est = plan.estimate
    rel = _shard_rel(losses, ref_losses)
    _log(f"shard plan ({smi}): TrainStep(plan=) on {step.mesh!r} "
         f"(rule_pack {plan.rule_pack}, data_spec {plan.data_spec}, n_micro "
         f"{plan.n_micro}, remat {plan.remat}), B {B} x L {L}: losses "
         f"{[round(x, 5) for x in losses]} against the unsharded step's "
         f"{[round(x, 5) for x in ref_losses]} (max rel {rel:.2e}, bound "
         f"{SHARD_LOSS_TOL:g}); launches over {s['steps']} steps "
         f"{ {k: v for k, v in counts.items() if v} }")
    for i, (pb, sb) in enumerate(per_shard):
        _log(f"shard plan bytes: shard {i}: parameters {pb / 2**30:.3f} GiB"
             f" (estimate {est['params_bytes'] / 2**30:.3f}), optimizer "
             f"state {sb / 2**30:.3f} GiB (estimate "
             f"{est['opt_state_bytes'] / 2**30:.3f}); estimate per device "
             f"{est['total_bytes'] / 2**30:.3f} GiB; the card's peak over "
             f"all {n} shards {num['peak_gib']:.2f} GiB")
    num["est_step_ms"] = plan.step_time_s * 1e3
    for label, r in (("unsharded", ref), ("planned", num)):
        _log(f"shard plan {label} ({smi}): step {r['step_ms']:.2f} ms"
             + (f" (the plan's estimated step {r['est_step_ms']:.2f} ms)"
                if "est_step_ms" in r else "")
             + f", {r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f}, "
             f"peak {r['peak_gib']:.2f} GiB, idle share "
             f"{r['idle_share']:.3f}")
    if rel > SHARD_LOSS_TOL or not all(map(math.isfinite, losses)):
        raise AssertionError(f"shard plan: {losses} against {ref_losses}")
    data_shards = 1
    for a in tmx.parallel._entry_axes(plan.data_spec[0]) \
            if plan.data_spec else ():
        data_shards *= plan.mesh_shape[a]
    # a tp axis the batch does not split over computes each block's
    # attention per tp shard (the heads divide here)
    tp = plan.mesh_shape.get("tp", 1)
    _shard_check_launches("plan", counts,
                          s["layers"] * data_shards * plan.n_micro * tp)
    step = None
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"ref": ref, "plan": num, "losses": losses,
                    "ref_losses": ref_losses, "mesh": plan.mesh_shape}


def _shard_pipe(torch, fa, mx, args, smi):
    """(c): PipelinedBlock over the 2 decoder blocks on a pp mesh of 2
    shards of the card, 4 microbatches, against the blocks in turn."""
    tmx, llama = mx["pkg"], mx["llama"]
    from mxnet_tpu_torch import pipeline
    s = SHARD
    net = _shard_llama(torch, tmx, llama, args.seed)
    blocks = net.blocks
    mesh = tmx.parallel.DeviceMesh((2,), ("pp",), devices=[tmx.gpu(0)] * 2)
    g = torch.Generator(device="cuda").manual_seed(args.seed + 28)
    x = torch.randn(s["pipe_batch"], s["pipe_len"], s["units"], generator=g,
                    device="cuda", dtype=torch.bfloat16)
    w = torch.randn(x.shape, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    piped = pipeline.PipelinedBlock(blocks, mesh,
                                    n_microbatches=s["pipe_micro"])
    names = list(blocks[0].collect_params().keys())
    own = [[p.data()._data for p in b.collect_params().values()]
           for b in blocks]

    def run_pipe():
        out = piped(x)._data
        leaves = [t for k in names for t in piped.stacked[k]]
        return out, torch.autograd.grad((out.float() * w).sum(), leaves)

    def run_seq():
        y = x
        for b in blocks:
            y = b(y)
        return y, torch.autograd.grad((y.float() * w).sum(),
                                      [t for ts in own for t in ts])

    _reset_counts(fa)
    out, grads = run_pipe()
    torch.cuda.synchronize()
    counts = _counts(fa)
    ref, ref_grads = run_seq()
    out_err = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
    # the pipeline's gradients come name-major (stage 0, stage 1 of each
    # name), the blocks' block-major
    S = len(blocks)
    grad_err = 0.0
    for i, _ in enumerate(names):
        for st in range(S):
            a, b = grads[i * S + st], ref_grads[st * len(names) + i]
            grad_err = max(grad_err, ((a.float() - b.float()).abs().max()
                                      / b.float().abs().max()).item())
    t_pipe = _time_ms(torch, run_pipe, iters=1, reps=3, warmup=1)
    t_seq = _time_ms(torch, run_seq, iters=1, reps=3, warmup=1)
    want = {"flash_fwd": S * s["pipe_micro"],
            "flash_bwd_dq": S * s["pipe_micro"],
            "flash_bwd_dkv": S * s["pipe_micro"]}
    _log(f"shard pipe ({smi}): PipelinedBlock over {S} llama3_8b-width "
         f"blocks on pp {S} of the card, {s['pipe_micro']} microbatches of "
         f"{s['pipe_batch'] // s['pipe_micro']} x {s['pipe_len']}, bf16: "
         f"output {out_err:.2e} and stacked gradients {grad_err:.2e} of "
         f"max |sequential| (bounds {SHARD_PIPE_TOL[0]:g}, "
         f"{SHARD_PIPE_TOL[1]:g}); forward + backward {t_pipe:.2f} ms "
         f"against the sequential blocks' {t_seq:.2f} ms; launches "
         f"{ {k: v for k, v in counts.items() if v} }")
    if out_err > SHARD_PIPE_TOL[0] or grad_err > SHARD_PIPE_TOL[1]:
        raise AssertionError(f"shard pipe: {out_err}, {grad_err}")
    if {k: counts[k] for k in want} != want or any(
            counts[k] for k in counts if k not in want):
        raise AssertionError(f"shard pipe: launches {counts}, want {want}")
    return counts, {"pipe_ms": t_pipe, "seq_ms": t_seq, "out_err": out_err,
                    "grad_err": grad_err}


def _shard_ckpt(torch, mx, net, mesh, batch, args, smi):
    """(d): the tp-sharded net of (a) saved (gathered on save) and
    restored into a fresh net already split by a step: the parameters bit
    for bit; then one more step of each equal bit for bit."""
    tmx, llama = mx["pkg"], mx["llama"]
    from mxnet_tpu_torch import sharding
    toks, labs = batch
    rules = sharding.rule_pack("llama")

    def sgd_step(n, lr):
        return tmx.parallel.TrainStep(
            n, _llama_loss(mx["nn"]), mx["optimizer"].SGD(learning_rate=lr),
            mesh=mesh, partition_rules=rules)

    import shutil
    d = tempfile.mkdtemp(prefix="mx_shard_ckpt_")
    try:
        t0 = time.perf_counter()
        mgr = tmx.checkpoint.CheckpointManager(d)
        mgr.save(4, net=net)
        t_save = time.perf_counter() - t0
        fresh = _shard_llama(torch, tmx, llama, args.seed + 1)
        sgd_step(fresh, 0.0)(toks, labs)        # splits it
        t0 = time.perf_counter()
        mgr.restore(net=fresh)
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(a.data()._data, b.data()._data) for a, b in
                   zip(net.collect_params().values(),
                       fresh.collect_params().values()))
        split = all((a._slices is None) == (b._slices is None) for a, b in
                    zip(net.collect_params().values(),
                        fresh.collect_params().values()))
        la = float(sgd_step(net, 1e-4)(toks, labs))
        lb = float(sgd_step(fresh, 1e-4)(toks, labs))
        after = all(torch.equal(a.data()._data, b.data()._data) for a, b in
                    zip(net.collect_params().values(),
                        fresh.collect_params().values()))
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    _log(f"shard ckpt ({smi}): the dp 2 x tp 2 net gathered on save "
         f"({size / 2**30:.2f} GiB in {t_save:.1f} s) and restored into a "
         f"fresh split net in {t_restore:.1f} s: parameters bit-equal "
         f"{same}, split alike {split}; one more SGD step: loss {la!r} "
         f"and {lb!r}, parameters bit-equal {after}")
    if not (same and split and after and la == lb):
        raise AssertionError("shard ckpt: the restored net differs")


def _shard_kernels(torch, fa):
    """The flash kernels against their plain version at the shapes this
    phase gives them: (1, 16, 4096, 128) (a tp shard's head group) and
    (1, 32, 2048, 128) (a plan data shard, a pipeline microbatch), bf16,
    causal."""
    s = SHARD
    g = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    for H, L in ((s["heads"] // 2, s["tp_len"]), (s["heads"],
                                                  s["plan_len"])):
        q, k, v, do = (torch.randn(1, H, L, s["head_dim"], generator=g,
                                   device="cuda", dtype=torch.bfloat16)
                       for _ in range(4))
        out[(H, L)] = _sp_plain(torch, fa, f"({H} heads, L {L})",
                                "bfloat16", q, k, v, do, None, None, True,
                                1.0 / math.sqrt(s["head_dim"]),
                                phase="shard")
    return out


def _shard_gemm_tile(torch, smi):
    """One bf16 GEMM (8192 x 4096) @ (4096 x d) for d = 32 ... 512: its
    efficiency against the card's bf16 peak, for the planner's tile
    term."""
    eff = {}
    for d in (32, 64, 128, 256, 512):
        a = torch.randn(8192, 4096, device="cuda", dtype=torch.bfloat16)
        b = torch.randn(4096, d, device="cuda", dtype=torch.bfloat16)
        t = _time_ms(torch, lambda: a @ b, iters=20, reps=5, warmup=3)
        eff[d] = 2.0 * 8192 * 4096 * d / (t / 1e3) / PEAK_FLOPS["bfloat16"]
    _log(f"shard gemm tile ({smi}): bf16 (8192 x 4096) @ (4096 x d), "
         f"efficiency against the bf16 peak: "
         + ", ".join(f"d {d} {e:.3f}" for d, e in eff.items()))
    return eff


def shard_phase(torch, fa, mx, args, smi):
    """Sharding rules, the sharded TrainStep, the autoshard planner and
    GPipe on the card: (a) tensor parallelism, (b) the plan, (c) the
    pipeline, (d) the checkpoint; the flash kernels against their plain
    version at the phase's shapes; the GEMM tile term.  Returns (launch
    counts of (a), (b) and (c), numbers)."""
    gc.collect()
    torch.cuda.empty_cache()
    tp_counts, tp, net, mesh, batch = _shard_tp(torch, fa, mx, args, smi)
    _shard_ckpt(torch, mx, net, mesh, batch, args, smi)
    net = batch = None
    gc.collect()
    torch.cuda.empty_cache()
    plan_counts, plan = _shard_plan(torch, fa, mx, args, smi)
    pipe_counts, pipe = _shard_pipe(torch, fa, mx, args, smi)
    kernels = _shard_kernels(torch, fa)
    tile = _shard_gemm_tile(torch, smi)
    counts = {k: tp_counts[k] + plan_counts[k] + pipe_counts[k]
              for k in _COUNTERS}
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"tp": tp, "plan": plan, "pipe": pipe,
                    "kernels": kernels, "tile": tile}


SHARD_LOSS_TOL = 2e-3   # relative, sharded against unsharded bf16 losses


# -- gate: the perf gate on the card ------------------------------------------------

GATE = {"baseline": os.path.join("tests", "perf_baseline_torch_cuda.json"),
        "jobs": 7, "budget_s": 60.0, "timeout_s": 600}
# the kernels at the gate lanes' shapes: bert_seq512 (bert_3_128_2: 2
# heads of 64, batch 2, seq 512, no mask: the single-tile forward and the
# fused backward) and llama_longseq (4 heads of 16 after GQA, seq 2048,
# causal: the streaming forward, dq and dkv), f32
GATE_SHAPES = (("bert_seq512", (2, 2, 512, 64), False),
               ("llama_longseq", (1, 4, 2048, 16), True))
# each lane's flash launches: its run() calls (two warm-up, two in the
# window, one drain) x scan steps x layers; bert_headline's seq 32 takes
# the dense path, and the other lanes run no flash kernel
_GATE_CALLS = 5
GATE_LAUNCHES = {
    "bert_seq512": {k: _GATE_CALLS * 2 * 3 for k in (
        "flash_fwd", "flash_fwd_f32", "flash_bwd_fused",
        "flash_bwd_fused_f32")},
    "llama_longseq": {k: _GATE_CALLS * 1 * 2 for k in (
        "flash_fwd", "flash_fwd_f32", "flash_bwd_dq", "flash_bwd_dq_f32",
        "flash_bwd_dkv", "flash_bwd_dkv_f32")},
}


def _gate_cli(torch, root, env, *args):
    res = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "torch_perfgate.py"),
         *args], capture_output=True, text=True, env=env, cwd=root,
        timeout=GATE["timeout_s"])
    try:
        report = json.loads(res.stdout)
    except ValueError:
        report = None
    return res.returncode, report, res.stderr


def gate_phase(torch, fa, mx, args, smi):
    """The perf gate on the card: ``tools/torch_perfgate.py --check
    --device cuda`` against the card tier (seven lanes, one child each,
    loading the built kernels), each lane's record and observed wall
    printed; the red path (``MXNET_KVSTORE_BUCKET_MB=0`` must exit 1);
    the flash kernels against their plain version at the lanes' shapes.
    Returns (the lanes' flash launches, numbers)."""
    del args
    root = os.path.dirname(os.path.abspath(__file__))
    baseline = os.path.join(root, GATE["baseline"])
    env = dict(os.environ, MXNET_PERFGATE_BASELINE=baseline)
    env.pop("MXNET_KVSTORE_BUCKET_MB", None)
    tmp = tempfile.mkdtemp(prefix="mx_gate_")
    records_path = os.path.join(tmp, "records.json")
    t0 = time.perf_counter()
    try:
        rc, report, err = _gate_cli(
            torch, root, env, "--check", "--device", "cuda", "--jobs",
            str(GATE["jobs"]), "--json", "--records", records_path)
        check_s = time.perf_counter() - t0
        if rc != 0 or report is None or not report["ok"]:
            raise AssertionError(f"gate: --check exited {rc}: {report}; "
                                 f"{err[-3000:]}")
        with open(records_path) as f:
            records = json.load(f)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    counts = {k: 0 for k in _COUNTERS}
    for name, rec in sorted(records.items()):
        launches = rec["observed"].pop("flash_launches")
        for k, n in launches.items():
            counts[k] += n
        got = {k: n for k, n in launches.items() if n}
        _log(f"gate lane {name} ({smi}): {report['lanes'][name]['verdict']}"
             f"; metrics {rec['metrics']}; counters {rec['counters']}; "
             f"sites {sorted(rec['sites'])}; observed {rec['observed']}; "
             f"flash launches {got}")
        if got != GATE_LAUNCHES.get(name, {}):
            raise AssertionError(f"gate lane {name}: flash launches {got}, "
                                 f"want {GATE_LAUNCHES.get(name, {})}")
    t1 = time.perf_counter()
    rc, red, err = _gate_cli(
        torch, root, dict(env, MXNET_KVSTORE_BUCKET_MB="0"), "--check",
        "--device", "cuda", "--lanes", "trainer_fused_kvstore", "--json")
    red_s = time.perf_counter() - t1
    fails = {} if red is None else {
        f["metric"]: f for f in
        red["lanes"]["trainer_fused_kvstore"]["failures"]}
    d = fails.get("dispatches_per_step")
    if rc != 1 or d is None or not d["got"] > d["base"]:
        raise AssertionError(f"gate: the red path exited {rc}: {red}; "
                             f"{err[-2000:]}")
    _log(f"gate red path ({smi}): MXNET_KVSTORE_BUCKET_MB=0 -> exit 1, "
         f"trainer_fused_kvstore dispatches a step {d['base']} -> "
         f"{d['got']}, drifted {sorted(fails)}")
    gate_s = time.perf_counter() - t0
    _log(f"gate: 7 lanes within the card tier's bands (exact dispatches, "
         f"builds, executables and counters; FLOPs and bytes 2 %, peak 5 "
         f"%) in {check_s:.1f} s (--jobs {GATE['jobs']}), red path "
         f"{red_s:.1f} s, {gate_s:.1f} s in all (budget "
         f"{GATE['budget_s']:.0f} s)")
    if gate_s > GATE["budget_s"]:
        raise AssertionError(f"gate: {gate_s:.1f} s, over its budget of "
                             f"{GATE['budget_s']:.0f} s")
    g = torch.Generator(device="cuda").manual_seed(37)
    errs = {}
    for lane, shape, causal in GATE_SHAPES:
        q, k, v, do = (torch.randn(*shape, generator=g, device="cuda")
                       for _ in range(4))
        errs[lane] = _sp_plain(torch, fa, f"{lane} lane", "float32", q, k,
                               v, do, None, None, causal,
                               1.0 / math.sqrt(shape[-1]), phase="gate")
    return counts, {"check_s": check_s, "red_s": red_s, "gate_s": gate_s,
                    "kernel_errs": errs}


def _ptxas_summary(log):
    """(kernel<template args>, registers, spill-store bytes, ptxas's spill
    line) for every compiled kernel."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"(flash_[a-z_]*?(?:bf16_tc_)?kernel)I(.*?)E+v",
                          mangled)
            name, spill = (f"{m.group(1)}<{m.group(2)}>" if m
                           else mangled[-60:]), ""
        elif "spill stores" in line and name:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split(",")[0].strip()
            m = re.search(r"(\d+) bytes spill stores", spill)
            out.append((name, regs, int(m.group(1)) if m else 0, spill))
            name = None
    return out


def _phase(label, fn, *a):
    t0 = time.perf_counter()
    r = fn(*a)
    _log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return r


PR_SET_CHILD_SUBREAPER = 36


def _become_subreaper():
    """Make this process the subreaper of everything it starts, so that a
    process whose parent ends first (a fork server's worker) is still a
    descendant that ``_stop_processes`` finds.  False where there is no
    prctl (not Linux)."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def _descendants():
    """{pid: (parent pid, state letter, command)} of every descendant of
    this process, zombies included, from /proc."""
    procs = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # the command may hold spaces and parentheses: split after the last
        head, rest = stat[:stat.rindex(")")], stat[stat.rindex(")") + 2:]
        fields = rest.split()
        procs[int(d)] = (int(fields[1]), fields[0], head[head.index("(") + 1:])
    out, frontier = {}, [os.getpid()]
    while frontier:
        p = frontier.pop()
        for c, info in procs.items():
            if info[0] == p and c not in out:
                out[c] = info
                frontier.append(c)
    return out


def _stop_processes(grace_s=30.0):
    """Stop and reap every process this run started: multiprocessing's
    children; its fork server and resource tracker, which end when this
    process closes its pipe to them (each ``_stop`` closes it and waits);
    then any descendant still running, with SIGTERM and then SIGKILL.
    Returns {pid: command} of the processes that had to be signalled;
    raises if one is still there after that."""
    import multiprocessing as mp
    import signal
    import threading
    gc.collect()        # close iterators and loaders no longer referenced
    for p in mp.active_children():
        p.terminate()
    for p in mp.active_children():
        p.join(grace_s)
    for mod, attr in (("multiprocessing.forkserver", "_forkserver"),
                      ("multiprocessing.resource_tracker",
                       "_resource_tracker")):
        stop = getattr(getattr(sys.modules.get(mod), attr, None), "_stop",
                       None)
        if stop is None:
            continue

        def quiet(stop=stop):
            try:
                stop()
            except Exception:  # noqa: BLE001 (the sweep below ends it)
                pass
        t = threading.Thread(target=quiet, daemon=True)
        t.start()
        t.join(grace_s)
    signalled = {}
    for sig in (signal.SIGTERM, signal.SIGKILL):
        live = {p: i for p, i in _descendants().items() if i[1] != "Z"}
        if not live:
            break
        signalled.update((p, i[2]) for p, i in live.items())
        for pid in live:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline and any(
                i[1] != "Z" for i in _descendants().values()):
            time.sleep(0.05)
    deadline = time.monotonic() + grace_s
    while (left := _descendants()) and time.monotonic() < deadline:
        # a zombie whose parent is this process (its own child, or an
        # orphan handed to it as subreaper) is reaped here
        for pid, (ppid, state, _) in left.items():
            if ppid == os.getpid() and state == "Z":
                try:
                    os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    pass
        time.sleep(0.05)
    if left:
        raise AssertionError(f"processes outlive the run: {left}")
    return signalled


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from mxnet_tpu_torch.kernels import _build
        from mxnet_tpu_torch.kernels import flash_attention as fa
        from mxnet_tpu_torch.gluon.model_zoo import bert, llama
        import mxnet_tpu_torch
        from mxnet_tpu_torch import optimizer, parallel, serving
        from mxnet_tpu_torch.ops import nn as ops_nn
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    mx = {"bert": bert, "llama": llama, "optimizer": optimizer,
          "parallel": parallel, "nn": ops_nn, "pkg": mxnet_tpu_torch}
    # flight-recorder dumps (a process this run signals leaves one) go to
    # a directory of this run, removed at its end
    flightrec_dir = tempfile.mkdtemp(prefix="mx_flightrec_")
    os.environ.setdefault("MXNET_FLIGHTREC_DIR", flightrec_dir)

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    _log(f"device: {kind} (torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    _log(smi)

    t0 = time.perf_counter()
    _build.build_kernel_libraries(["flash_fwd", "flash_bwd"])
    _log(f"build: flash_fwd.cu and flash_bwd.cu for sm_90a (two nvcc in "
         f"parallel) in {time.perf_counter() - t0:.1f} s")
    for src in ("flash_fwd", "flash_bwd"):
        for name, regs, spilled, spill in _ptxas_summary(
                _build.build_log(src)):
            _log(f"ptxas {src}: {name}: {regs}; {spill}")
            if spilled:
                raise AssertionError(f"{name} spills {spilled} bytes")

    errors, timings, sdpa_kernels = _phase("forward kernel", kernel_phase,
                                           torch, fa)
    bwd_errors, _, bwd_times = _phase("backward kernels", bwd_kernel_phase,
                                      torch, fa)
    _phase("serving oracle", oracle_phase, torch, mx["pkg"], llama, serving)
    serve_counts, net8b = _phase("serve", serve_phase, torch, fa, mx["pkg"],
                                 llama, serving, args)
    tier_counts = _phase("tier", tier_phase, torch, fa, mx, llama, serving,
                         net8b, args, smi)
    del net8b
    _phase("train oracle", train_oracle_phase, torch, fa, mx)
    train_launches, lanes = _phase("train lanes", train_lane_phase, torch,
                                   fa, mx, args)
    gluon_counts, _ = _phase("gluon", gluon_phase, torch, fa, mx, args, smi)
    mt_counts, _ = _phase("mt", mt_phase, torch, fa, mx, args, smi)
    vision_counts, _ = _phase("vision", vision_phase, torch, fa, mx, args,
                              smi)
    loop_counts, _ = _phase("loop", loop_phase, torch, fa, mx, args, smi)
    nd_counts, _ = _phase("nd", nd_phase, torch, fa, mx, args, smi)
    rnn_counts, _ = _phase("rnn", rnn_phase, torch, fa, mx, args, smi)
    det_counts, _ = _phase("det", det_phase, torch, fa, mx, args, smi)
    moe_counts = _phase("moe", moe_phase, torch, fa, mx, args, smi)
    image_counts, _ = _phase("image", image_phase, torch, fa, mx, args, smi)
    util_counts, _ = _phase("util", util_phase, torch, fa, mx, args, smi)
    sym_counts, _ = _phase("sym", sym_phase, torch, fa, mx, args, smi)
    ops_counts, _ = _phase("ops", ops_phase, torch, fa, mx, args, smi)
    quant_counts, quant_numbers = _phase("quant", quant_phase, torch, fa, mx,
                                         args, smi)
    sparse_counts, _ = _phase("sparse", sparse_phase, torch, fa, mx, args,
                              smi)
    np_counts, _ = _phase("np", np_phase, torch, fa, mx, args, smi)
    sp_counts, _ = _phase("sp", sp_phase, torch, fa, mx, args, smi)
    shard_counts, _ = _phase("shard", shard_phase, torch, fa, mx, args,
                             smi)
    gate_counts, _ = _phase("gate", gate_phase, torch, fa, mx, args, smi)

    t_k, t_p, t_l, bound, bound_by = timings[("prefill", "float32")]
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:185,248",
        "shape": "B=1 H=32 Lq=Lk=1024 D=128 float32 causal",
        "launches": train_launches["flash_fwd"],
        "serve_launches": serve_counts["flash_fwd"],
        # the tier phase: llama3_8b cold prefills (prefix cache off and
        # on, speculation) and transformer_base's encoder
        "tier_launches": tier_counts["flash_fwd"],
        "max_abs_err": errors[("prefill", "float32", True, False)][0],
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": t_l,
        "library_kernels": sdpa_kernels["prefill"],
        # f32 launches counted by the wrapper in serving and the lanes
        "f32_launches": serve_counts["flash_fwd_f32"]
        + train_launches["flash_fwd_f32"],
        # the Gluon loop's timed steps, f32 and bf16 lanes
        "gluon_launches": sum(c["flash_fwd"] for c in gluon_counts.values()),
        # the ResNet-50 vision phase has no attention
        "vision_launches": vision_counts["flash_fwd"],
        # the loop phase's timed steps: BERT bf16 (ResNet-50 launches none)
        "loop_launches": loop_counts["flash_fwd"],
        # the nd phase's attention ops, f32 and bf16
        "nd_launches": nd_counts["flash_fwd"],
        # the rnn phase: the LSTM LM has no attention
        "rnn_launches": rnn_counts["flash_fwd"],
        # the det and moe phases: YOLO, the SSD heads, MoE: no attention
        "det_launches": det_counts["flash_fwd"],
        "moe_launches": moe_counts["flash_fwd"],
        # the image phase: ResNet-50 and LeNet from the .rec and MNIST
        "image_launches": image_counts["flash_fwd"],
        # the mt phase's timed steps: transformer_base, f32 and bf16
        "mt_launches": mt_counts["flash_fwd"],
        # the util phase's BERT-base bf16 steps (fused optimizer,
        # compression, checkpoint and resume)
        "util_launches": util_counts["flash_fwd"],
        # the sym phase: the symbolic encoder's oracle, buckets, Module
        # steps and SymbolBlock serves, f32 and bf16
        "sym_launches": sym_counts["flash_fwd"],
        "sym_f32_launches": sym_counts["flash_fwd_f32"],
        # the ops phase's 20 replays of the BERT-base bf16 step under
        # telemetry and the cost ledger
        "ops_launches": ops_counts["flash_fwd"],
        # the quant phase's timed int8 BERT-base forwards (12 f32 launches
        # each); the sparse phase has no attention
        "quant_launches": quant_counts["flash_fwd"],
        "sparse_launches": sparse_counts["flash_fwd"],
        # the np phase's 8 BERT-base bf16 steps under npx.set_np()
        "np_launches": np_counts["flash_fwd"],
        # the sp phase's llama steps (fused, ring and Ulysses), bf16
        "sp_launches": sp_counts["flash_fwd"],
        # the shard phase's tp steps, plan steps and pipeline, bf16
        "shard_launches": shard_counts["flash_fwd"],
        # the gate phase's seven lane children (f32): bert_seq512's
        # single-tile forward, llama_longseq's streaming forward
        "gate_launches": gate_counts["flash_fwd"],
    }]
    # the f32 kernel at the quant path's shape, on its own q, k, v
    att = quant_numbers["flash"]
    kernels[0].update({"quant_shape": att["shape"],
                       "quant_max_abs_err": quant_numbers["att_err"],
                       **{f"quant_{k}": att[k] for k in (
                           "ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by")}})
    t_k, t_p, t_l, bound, bound_by = timings[("single-tile", "float32")]
    kernels[0].update({
        "single_tile_shape": "B=2 H=32 Lq=Lk=512 D=128 float32 causal",
        "single_tile_ms": t_k, "single_tile_plain_ms": t_p,
        "single_tile_library_ms": t_l, "single_tile_bound_ms": bound,
        "single_tile_bound_by": bound_by,
        "single_tile_library_kernels": sdpa_kernels["single-tile"]})
    # the bf16 tensor-core kernel at the training lanes' shapes
    for lane, prefix in (("llama-lane", "lane"), ("bert-lane", "bert_lane")):
        t_k, t_p, t_l, bound, bound_by = timings[(lane, "bfloat16")]
        kernels[0].update({
            f"{prefix}_shape": {"llama-lane": "B=4 H=16 Lq=Lk=2048 D=128 "
                                              "bfloat16 causal",
                                "bert-lane": "B=32 H=12 Lq=Lk=512 D=64 "
                                             "bfloat16 non-causal"}[lane],
            f"{prefix}_ms": t_k, f"{prefix}_plain_ms": t_p,
            f"{prefix}_library_ms": t_l, f"{prefix}_bound_ms": bound,
            f"{prefix}_bound_by": bound_by})
    def err_of(kind_, dname):
        if kind_ == "fused":
            return max(bwd_errors[("bert-lane", dname, False, False)])
        e = bwd_errors[("llama-lane", dname, True, False)]
        return e[0] if kind_ == "dq" else max(e[1:])

    # one entry per backward entry point and dtype: bf16 runs the
    # tensor-core kernels (tc::), f32 the CUDA-core ones; launches are the
    # train lanes' (the bf16 lanes' for bf16, the f32 lanes' for f32)
    cuda_core = {"fused": "simt::flash_bwd_dkv_kernel<float, DP, BK, BQ, "
                          "true>",
                 "dq": "simt::flash_bwd_dq_kernel<float, DP, BQ, BK>",
                 "dkv": "simt::flash_bwd_dkv_kernel<float, DP, BK, BQ, "
                        "false>"}
    for kind_, line in (("fused", 464), ("dq", 373), ("dkv", 417)):
        t = bwd_times[kind_]
        n_all = train_launches[f"flash_bwd_{kind_}"]
        n_f32 = train_launches[f"flash_bwd_{kind_}_f32"]
        for dname, pre in (("bfloat16", ""), ("float32", "f32_")):
            kernels.append({
                "name": f"flash_bwd_{kind_}" + ("_f32" if pre else ""),
                "kernel": cuda_core[kind_] if pre
                else f"tc::flash_bwd_{kind_}_bf16_tc_kernel<DP>",
                "route": "cuda",
                "source": "mxnet_tpu_torch/kernels/csrc/flash_bwd.cu",
                "replaces": f"mxnet_tpu/kernels/flash_attention.py:{line}",
                "shape": t[pre + "shape"],
                "launches": n_f32 if pre else n_all - n_f32,
                "max_abs_err": err_of(kind_, dname),
                "ms": t[pre + "ms"],
                "plain_ms": t[pre + "plain_ms"],
                "bound_ms": t[pre + "bound_ms"],
                "bound_by": t[pre + "bound_by"],
                "library_ms": t[pre + "library_ms"],
                "library_events_ms": t[pre + "library_events_ms"],
                "library_kernels": t[pre + "library_kernels"],
                "vision_launches": vision_counts[
                    f"flash_bwd_{kind_}" + ("_f32" if pre else "")],
                "loop_launches": loop_counts[
                    f"flash_bwd_{kind_}" + ("_f32" if pre else "")],
                "nd_launches": _dtype_count(nd_counts, kind_, pre),
                "rnn_launches": _dtype_count(rnn_counts, kind_, pre),
                "det_launches": _dtype_count(det_counts, kind_, pre),
                "moe_launches": _dtype_count(moe_counts, kind_, pre),
                "image_launches": _dtype_count(image_counts, kind_, pre),
                "mt_launches": _dtype_count(mt_counts, kind_, pre),
                "util_launches": _dtype_count(util_counts, kind_, pre),
                "sym_launches": _dtype_count(sym_counts, kind_, pre),
                "ops_launches": _dtype_count(ops_counts, kind_, pre),
                "quant_launches": _dtype_count(quant_counts, kind_, pre),
                "sparse_launches": _dtype_count(sparse_counts, kind_, pre),
                "np_launches": _dtype_count(np_counts, kind_, pre),
                "sp_launches": _dtype_count(sp_counts, kind_, pre),
                "shard_launches": _dtype_count(shard_counts, kind_, pre),
                "tier_launches": _dtype_count(tier_counts, kind_, pre),
                "gate_launches": _dtype_count(gate_counts, kind_, pre),
            })
            if kind_ == "fused":
                kernels[-1]["gluon_launches"] = \
                    gluon_counts[dname]["flash_bwd_fused"]
    for lane, r in lanes.items():
        _log(f"train {lane}: step {r['step_ms']:.2f} ms, "
             f"{r['samples_per_s']:.2f} samples/s, MFU {r['mfu']:.4f}, peak "
             f"{r['peak_gib']:.2f} GiB ({smi})")
    signalled = _stop_processes()
    import shutil
    shutil.rmtree(flightrec_dir, ignore_errors=True)
    _log(f"processes: the fork server and resource tracker stopped; "
         f"{len(signalled)} other process(es) had to be signalled"
         + (f": {signalled}" if signalled else ""))
    _log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    _become_subreaper()
    try:
        rc = main()
    finally:
        # on a failed phase too; a no-op after main's own call
        _stop_processes()
    sys.exit(rc)
