#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure exits non-zero before the last line:

1. environment: the card's name and power limit (nvidia-smi), CUDA and
   torch versions; TF32 off for convolutions and matmuls.
2. build: every hand-written kernel from mxnet_tpu_torch/csrc, one nvcc
   per source, all at once; the K3, K1 and K2 libraries must hold TF32
   tensor-core MMA instructions (HMMA with TF32 operands in cuobjdump
   -sass), and K3's library bf16 and f16 wgmma ones (HGMMA: its 16-bit
   mainloop) and no 16-bit mma.sync (HMMA.16816).
3. kernel parity on the card, at the shapes the main paths give each
   kernel plus ragged ones: K4 (norm_act_fwd) and K5 (norm_act_bwd)
   against their plain PyTorch versions (f32, bf16, and f16 bit-equal),
   K3 (conv_gemm) against a float64 product of the same operands (f32,
   bf16 and f16 operands); reruns of K3 and K5 must be bit-identical.
   K2 (flash_attn) against its plain version (reference attention,
   mask -1e30) at the demo shape of examples/long_context, each head
   width the kernel instantiates and ragged T and D, reruns
   bit-identical; K1 (linear) against a float64 act(x @ w.T + b), one
   CUDA launch a call (torch.profiler), reruns bit-identical, and a
   sha256 digest of its output at each shape on seeded inputs; K6 (Rtc,
   NVRTC): an axpy body and the same body with float4 loads and with
   read-only (__ldg) loads bit-equal to 2*x+y, a gelu-like body within
   rtol 1e-4, an in-place push equal to 2*x, a bad body raising with
   NVRTC's log.
4. kernel timing: median of CUDA-event times with the L2 cache flushed
   before each launch, beside the plain version, the one-call PyTorch
   yardstick where there is one and the bound (bytes at 3.35 TB/s or
   operations at the data-sheet rate, whichever is longer: K1, K2 and K3
   at 495/3 TFLOP/s, three TF32 passes for float32 accuracy, with the
   67 TFLOP/s CUDA-core bound beside it as simt_bound_ms), summed over
   the launches of one ResNet-50 forward (K4) or training step (K3, K5);
   K2 at the demo shape and at T=16384 (beside
   scaled_dot_product_attention), K1 at three layers, the MNIST MLP's
   three, five around the narrow tile's limit and phase 22's pipeline
   stage (beside addmm and its activation),
   the Rtc axpy and its float4 and __ldg bodies beside 2*x+y and
   torch.add.
5. serving at full width: ResNet-50, 224x224, 1000 classes, NHWC,
   random seeded weights, served through Module -> InferenceServer ->
   FusedInfer from two client threads; kernel launch counts are zeroed
   just before and read just after; served argmax against a direct
   Executor.forward; card probabilities against the port on the CPU.
6. training at full width: the same network through Module.fit (SGD,
   momentum 0.9, wd 1e-4, rescale_grad 1/32) over 5 batches of 32 from
   seed 0, first through the classic loop, then through the fused step
   (fit(fused_step=True): one eager step, one CUDA graph capture, a
   replay a batch after the first) from the same weights; for each,
   launch counts zeroed just before and read just after (K3 105, K4 53
   and K5 53 a step: in the classic loop every step, in the fused loop
   the eager step and the launches the capture records, since a replay
   runs no wrapper), finite losses, every param and moving statistic
   changed; the fused loop's params, moving statistics, losses and
   metric equal the classic loop's bit for bit; both loops' host step
   time (median of steps 2-5 between batch-end callbacks, card
   synchronised), img/s, peak allocated memory and a torch.profiler
   breakdown over two steps (device ms a step, busy share, and the
   launches the card ran, counted from the kernel events: 105, 53 and
   53 a step in both loops; the fused replay also by CUDA events); one
   classic step at batch 2 on the card against the port on the CPU.
   Then the MNIST path: idx files written from seeded numpy (separable
   class templates), the MLP and LeNet through
   FeedForward(fused_step=True) over MNISTIter batches of 128 for 2
   epochs (LeNet runs K3 three times a step), losses falling and
   held-out accuracy >= 0.97, two more replays under torch.profiler
   (LeNet: K3 three times a replay), and three fused steps of each at
   batch 2 on the card against the port on the CPU.
7. entry points at full width, launch counts zeroed just before and
   read just after: parallel.make_ring_attention over a one-rank "sp"
   mesh at the demo's (1, 4096, 8, 32), causal, impl "ulysses" (K2 once
   a call) and "ring" (K2 never), each against reference_attention,
   ulysses_attention and ring_attention called with the reference's
   signature (the axis name positional, resolved against that mesh: K2
   once and never), and one backward through ulysses against autograd
   through the reference;
   fused_linear at ResNet-50's head on the card's ResNet features
   against the FullyConnected output; two Rtc pushes.
8. checkpoints at full width: ResNet-50 NHWC, batch 32, f32, phase 6's
   SGD settings, six batches from seed 0, fit(fused_step=True).
   (a) uninterrupted: losses L and final params P; (b) MXNET_TPU_CKPT_DIR
   with a snapshot every 3 steps: losses equal L bit for bit, ckpt.saves,
   ckpt.bytes, ckpt.save_ms and the saving steps' host time against the
   other replays'; (c) a fresh module resumed from the step-3 snapshot:
   ckpt.restores 1, losses L[3..5] and params P bit for bit, one capture,
   launch counts zeroed just before and read just after (K3 210, K4 106,
   K5 106: the eager step and the capture), the restore time; (d) data
   b0, b1, b2, b3, b3 with manager.rollback() to the step-3 snapshot
   after the first b3: the replay that follows gives L[3] bit for bit,
   the params end equal to (a)'s after four steps, one capture;
   (e) Module.save_checkpoint with the optimizer states, loaded by a
   Module on the CPU: params and momenta bit-equal; (f) a child process
   trains the MNIST MLP on the card (fit(fused_step=True),
   MXNET_TPU_CKPT_DIR set) and sends itself SIGTERM after step 5: it must
   end by the signal with a "preempt" snapshot of step 5, and a second
   child resumes from it and finishes the epoch (each bounded by a
   timeout). One summary line: snapshot MB, save ms, restore ms, the
   saving step's host ms against the median step's.
9. fit's health and input plane at full width: ResNet-50 NHWC, batch
   32, f32, phase 6's SGD settings, 8 batches from seed 0 through
   fit(fused_step=True) with telemetry on, launch counts zeroed just
   before and read just after every fit (K3 210, K4 106, K5 106: the
   eager step and the capture; one capture each). (1) plain,
   MXNET_TPU_DEVICE_STAGING=1 and MXNET_TPU_FEED_DEPTH=2, each with a
   batch-end callback that synchronises the card and without one:
   params, moving statistics and losses bit-equal to the plain fit; the
   wall ms a step over batches 3-6, the host ms a step copying batches
   in on the training thread, io.feed_stall_ms a step and the busy
   share of the last two steps (torch.profiler). (2) MXNET_TPU_NUMWATCH
   at EVERY_N=1 with device staging, the metrics server (port 0) and
   the flight recorder armed: params bit-equal to unarmed, the compiled
   kernels' events a replay unchanged, device ms a step (CUDA events)
   and kernel events a replay armed against unarmed, the fetch ms, the
   pack's grad l2, max-abs and update/weight ratio against a float64
   recomputation on the card (rtol 1e-5); /metrics and /healthz over
   loopback, the step ring (one record a step, the capturing step
   labelled recompile), a FlightRecorder dump with steps.jsonl and
   numwatch.jsonl. (3) the
   skip guard across an all-NaN batch: weights, momenta and metric sums
   bit-identical, numwatch.skipped_steps 1. (4) the rollback guard with
   MXNET_TPU_CKPT_DIR: a weight poisoned in place is named (kind
   "param") and restored into the same storage, losses finite after.
   (5) a default Monitor: its rows equal norm(x)/sqrt(size) recomputed
   on the card.
10. the ImageNet models at scale: AlexNet (with LRN), VGG-16, GoogLeNet
   and ResNet-50 at 224x224 and Inception-v3 at 299x299, NCHW, 1000
   classes, batch 32, f32, phase 6's SGD settings, 5 batches of seeded
   synthetic images, seeded Xavier weights. For each: the classic loop,
   then fit(fused_step=True) from the same weights, launch counts zeroed
   just before and read just after each (K3 2 x convolutions - 1 a step:
   9, 25, 113, 187 and 105; K4 and K5 0, as NCHW BatchNorm is
   elementwise); one capture; params, moving statistics, losses and the
   metric bit-equal, Dropout masks included; AlexNet once more through
   PrefetchingIter(ResizeIter(NDArrayIter)), bit-equal to the plain
   iterator; two profiled replays (K3 launches, device ms, busy share,
   time by group: K3, the cuDNN forward, copies); host step ms and img/s
   of both loops; peak allocated memory; one batch-2 step on the card
   against the CPU with the Dropout masks keyed by node name (loss
   within rtol 1e-4, update within 1e-2 of its norm); K3 alone over the
   step's products beside torch.matmul; the NCHW -> channels-last
   copies of K3's wrapper timed alone. Then K3 against a float64 product
   at every product of the five steps that phase 3 does not hold, and
   MXRecordIO/MXIndexedRecordIO round trips of packed records (no PIL).
11. every fusable optimizer at full width: phase 6's network, data,
   wd and rescale_grad with ccSGD (momentum 0.9), NAG (momentum 0.9),
   Adam (lr 1e-3, clip_gradient 5), AdaGrad (lr 0.01), RMSProp (lr
   0.002 under FactorScheduler(step=2, factor=0.5)) and AdaDelta. (a)
   For each, the classic loop then fit(fused_step=True) from the same
   weights, launch counts zeroed just before and read just after each
   (K3 105, K4 53, K5 53 a classic step; 210/106/106 for the fused
   loop's eager step and capture); one capture; params, every
   optimizer state tensor, moving statistics, losses and the metric
   bit-equal; one more fused step against a float64 recomputation of
   the update from its pre-step weights, gradients, states and
   hyperparameter rows (within 1e-5 of each tensor's largest
   magnitude); two profiled replays (device ms a step, busy share,
   K3/K4/K5 from the kernel events); the update alone, captured over
   copies of the step's tensors, its device ms a replay (profiler and
   CUDA events) beside its bound (w, g and the states read, w and the
   states written, at 3.35 TB/s) and its share of the step; host step
   ms, img/s and peak allocated memory of each loop. (b) Adam through
   the fused step: the skip guard across an all-NaN batch (weights,
   both states and metric sums bit-identical), a snapshot at step 3
   resumed in a fresh module (losses and params bit for bit, one
   capture, update counts carried), save_checkpoint's optimizer states
   loaded by a Module on the CPU bit-equal. (c) SGLD, one classic step:
   the standardised noise's mean and std over all 25.6 M elements;
   fit(fused_step=True) with SGLD raises. (d) An MLP 784-512-1 with
   LinearRegressionOutput, batch 128, through the fused step with
   [mse, mae, rmse] folded in the graph, against a float64
   recomputation from the outputs (rtol 1e-6). (e) dot, clip, norm,
   onehot_encode, crop_assign, mx.nd.Convolution and the Test
   optimizer on the card against the CPU; mx.random.set_state
   replaying two draws on the card.
12. the bucketed LSTM language model at the upstream example's width (2
   layers, 200 hidden, 200 embedding, a vocabulary of 10000, batch 32),
   Xavier (in, 2.34) weights from seed 0, SGD lr 0.01, wd 1e-5, launch
   counts zeroed just before and read just after each fit (K1-K6: 0, no
   op on this path has a compiled kernel). (a) BucketingModule over
   lstm_unroll with buckets 10-60, three batches of seeded synthetic
   sentences a bucket (18 steps), the initial states fed as zero data,
   through fit's classic loop: six bucket modules over one set of
   parameter tensors (data_ptr), finite losses, every param changed;
   host step ms by bucket (median after the binding step), tokens/s,
   peak memory, two profiled steps of bucket 60 (device ms, busy share,
   kernel groups); one bucket-10 batch on the card against the CPU from
   the same weights (outputs within 2e-5 and the update within 1e-3 of
   their norms). (b) Module over lstm_fused (the RNN op on cuDNN) at seq
   60, 5 batches through the classic loop, then fit(fused_step=True)
   from the same weights: one capture, params, losses and the metric
   bit-equal; host step ms, tokens/s, peak memory, two profiled replays
   and CUDA events. (c) every op the slice registers, forward and
   backward at small seeded shapes on the card against the CPU (f32
   rtol 1e-5 / atol 1e-6; dot, batch_dot, Deconvolution and sum 1e-4 /
   1e-5; gradients ten times the rtol), Embedding's out-of-range ids,
   rrelu's draw by distribution, and the RNN in its four modes, one and
   two directions, 2 layers, on cuDNN against the per-step loop on the
   card (1e-4 of the largest magnitude), reruns bit-identical.
13. Fast R-CNN and LSTM-OCR at full width. (a) VGG-16 Fast R-CNN as
   upstream example/rcnn builds it: get_vgg(16)'s convolutions, pools
   1-4, ROIPooling(7x7, 1/16) on the hand-written roi_pool kernel, fc6
   and fc7 with Dropout, 21 classes into SoftmaxOutput and 84 box
   deltas into smooth_l1 and MakeLoss; 2 seeded 600x1000 images a
   batch, 128 rois (64 an image, 25% foreground) sampled from 2000
   seeded proposals an image and its ground truth; SGD lr 0.001,
   momentum 0.9, wd 5e-4, conv1_x and conv2_x fixed; 5 batches through
   the classic loop then fit(fused_step=True) from the same Xavier
   weights: one capture, params, losses and metric bit-equal, K3 17 and
   roi_pool 2 launches a step (fixed params changed nothing, every
   other param changed), two profiled replays (device ms, busy share,
   time by group), roi_pool's forward and backward at the path's shape
   against the plain version (bit-equal forward, gradient within 1e-6
   of its largest) and its times beside the plain version's and the
   byte bound; K3 against a float64 product at each of the step's
   products (read off the graph) that phase 3 does not hold; one
   classic step at full width over 16 of the rois on the card against
   the CPU (each loss within rtol 1e-4, the update within 1e-2 of its
   norm). (b) the same graph with the sampler as a
   proposal_target Custom op: 3 classic batches bit-equal to (a)'s,
   fit(fused_step=True) refused naming the node. (c) upstream
   lstm_ocr: (32, 80 x 30) sliced into 80 frames, 2 unrolled LSTM
   layers of 100, FC(11), WarpCTC; 5 batches of seeded digit strings
   through both loops: one capture, bit-equal, no compiled kernel; the
   NLL within rtol 1e-4 of torch's ctc_loss; frames/s; one classic
   step on the card against the CPU (outputs within 2e-5 and each
   param's update within 1e-3, normwise). (d)
   SpatialTransformer, Correlation at FlowNetC's displacement 20 over
   (2, 256, 48, 64), softmax_cross_entropy and CTCLoss on the card
   against the CPU; roi_pool against its plain version over ragged
   rois (a zero plateau, empty bins, tiny rois) on a map holding a NaN
   and an infinity (their bins give 0, no gradient), reruns
   bit-identical;
   uniform and normal by distribution over 2^20 draws in train and in
   inference; the bfloat16 ROIPooling repair: roi_pool in bf16 and f16
   at 13a's shape (forward bit-equal to the plain version, gradient
   within 8 epsilons of the dtype of the sum of its terms' magnitudes,
   timed), then 3 steps of 13a's Fast R-CNN under compute_dtype
   bfloat16 through both loops from the same weights: one capture,
   bit-equal, roi_pool 2 launches a step, all bf16. (e) group2ctx with gpu(0) beside cpu(0) against a
   one-device bind, 13a's params through mem://, print_summary of
   13a's graph.
14. mixed precision and the adaptive serving plane. (a) K3 over the
   step's 105 products with bf16 and with f16 operands, laid out as the
   convolution path hands them over (the stem's 147-wide patch rows at a
   pitch of 152), timed beside the plain version, the one-call yardstick
   (torch.mm with a float32 result where this torch has it, else
   torch.matmul in the 16-bit type) and the bound (989 TFLOP/s or 3.35
   TB/s), a line a product (TFLOP/s, share of the bound) and the padded
   copy that a contiguous stem operand would take. (c) phase 6's fit under
   compute_dtype bfloat16: the classic loop, then fit(fused_step=True)
   from the same weights: one capture; params, moving statistics,
   losses and the metric bit-equal; params, gradients and aux float32;
   K3 105, K4 53 and K5 53 a step, every one with bf16 operands (the
   launch records, and the kernel events of two profiled replays by
   their template instantiation), no padded copy of a K3 operand;
   every param changed, losses finite;
   host step ms, img/s, peak memory and the breakdown by group beside
   phase 6's f32 numbers; one classic bf16 step at batch 2 on the card
   against the CPU (loss within rtol 1e-2; the whole update within twice
   the CPU's own bf16-to-f32 distance, normwise); 3 float16 steps, fused bit-equal to classic. (d) the
   trained bf16 model behind InferenceServer (ladder 1-32, adaptive,
   SLO 50 ms): seeded open-loop Poisson arrivals from two client threads,
   an interactive lane (1-4 rows, deadline 50 ms) and a batch lane (16
   rows, deadline 200 ms), 5 s at 800 img/s then 2 s at 3000 img/s;
   served probabilities against a direct bf16 forward of the same rows
   (2e-2) and the f32 server (5e-2), argmax equal where the top-2
   log-probability margin exceeds 0.1; no interactive request shed while
   an expired batch-lane request is pending; ladder shapes only, one
   dispatch a batch, K4 53 a batch in bf16; refresh_from_snapshot of a
   snapshot with one changed param copies that param alone into the
   served pack, in place; p50/p99 by lane, img/s, served and shed by
   lane, dispatch reasons, mean occupancy and the controller state. The
   trained model's outputs are one-hot to float32, so the probabilities
   are held again on phase 5's seeded weights, requests of 1-32 rows
   through a bf16 server against a direct bf16 forward (0.1 of the
   largest probability) and an f32 server (0.25 of it).
15. the input plane at full width. (a) crop_norm, the device feed's
   crop, mirror and normalisation of uint8 frames, at (32, 256, 256, 3)
   -> 224 with seeded offsets and half the rows mirrored, in NHWC and
   NCHW: bit-equal to its plain version; timed beside the plain version
   and the byte bound (the crops read, the float32 batch written). (b)
   1024 seeded 256x256x3 frames with labels 0-999 written in the decoded
   cache's layout (201 MB; no JPEG decode: the card's machine has no
   PIL); ResNet-50 NHWC at batch 32 (phase 6's weights and SGD) trained
   one epoch (32 steps) through fit(fused_step=True) from
   CachedImageRecordIter(device_feed=True, rand_crop, rand_mirror, the
   upstream means) with MXNET_TPU_FEED_DEPTH=2: one capture; launches
   (the eager step and the capture) K3 210, K4 106, K5 106, crop_norm 2,
   and two profiled replays the same; params after 4 steps bit-equal to
   the classic loop's over the same iterator seed (which materialises
   through crop_norm); ndarray.h2d_bytes a batch at most a third of the
   float32 crops'; host step ms, img/s, device ms and busy share,
   io.feed_stall_ms, and the fed img/s over phase 6's device-resident
   img/s. (c) the same fit for 8 steps in device_augment and host-crop
   mode: img/s of each. (d) a snapshot after step 5 (MXNET_TPU_CKPT_DIR);
   a fresh iterator seeked to its data state hands out the uninterrupted
   run's next batch (frames and aug values) bit for bit, and a fresh
   module and iterator resumed from it train the rest of the epoch to
   (b)'s losses and params bit for bit, one capture.
16. the mirrored backward and device observability at full width.
   (a) ResNet-50 NHWC at batch 32, f32, through fit(fused_step=True)
   unmirrored and with MXNET_BACKWARD_DO_MIRROR=1 from phase 6's weights
   and data: one capture each; launches (the eager step and the capture)
   K3 210, K5 106, and K4 106 unmirrored, 106 plus twice the BatchNorms
   the plan recomputes mirrored, and two profiled replays the same; the
   mirrored params, moving statistics and losses bit-equal to the
   unmirrored ones; peak allocated memory above the start (the mirrored
   one must be lower) and device ms a replay of both, and the kernel
   events a replay the mirror adds (K4, cuDNN forwards); a mirrored
   classic-loop fit bit-equal to phase 6's classic loop. (b) the compile
   registry on (MXNET_TPU_XPROF) over a mirrored fused fit at batch 32
   and one at batch 16: one fused_step record a fit with its signature
   and the eager step's FLOPs, the second's cause naming the data's
   shape change, StepTrace's compiles delta at each capturing step; one
   replay's op breakdown by kernel category summing to its kernel time;
   analyze's MFU against the H100 data-sheet peak; host step ms with the
   registry on. (c) MXNET_TPU_SANITIZE=transfer,retrace,donation,locks,
   deadlock over mirrored fused fits: no trip on the clean path; a
   planted .item() in a batch-end callback raises and counts a transfer
   trip; a state moved after warmup captures again and the retrace
   sanitizer raises; host step ms armed. (d) profiler.start/stop around
   two replays in an annotate range: the trace names K3, K4 and K5 and
   the range.
17. one process over several cards (ROADMAP.md Queue A item 10a).
   (a) one card: ResNet-50 NHWC at batch 32 from phase 6's weights and
   data through fit over [gpu(0)] with kvstore "device_sync" (which takes
   the fused step by default) and with "device" and fused_step=True:
   each one capture, launches (the eager step and the capture) K3 210,
   K4 106, K5 106, two profiled replays the same, params bit-equal to
   phase 6's. (b) with two or more cards visible, tools/torch_dp_check.py's
   run() in this process over every visible card at 32 a card (the
   fit over the cards against one card at the same global batch, the
   replicas bit-identical, one capture, K3, K4 and K5 on every card, the
   exchange's cross-card sum against a float64 sum, the planted
   per-card-statistics control outside the bound); with one card it
   prints "17b: not run, 1 card visible" and claims nothing. 17b runs
   after every one-card phase (18, 19, 20a and 21a), before 20b and 21b.
18. the dist stores (ROADMAP.md Queue A item 10b). (a) a one-worker
   dist_sync (no launcher environment) on [gpu(0)]: fit takes the fused
   step by default, one capture, launches (the eager step and the
   capture) K3 210, K4 106, K5 106, two profiled replays the same,
   params bit-equal to phase 6's, the update on the worker. (b)
   dist_async with two workers on the card, started by tools/launch.py
   (this script with --async-child): ResNet-50 NHWC at batch 32 each
   from phase 6's weights, rank 0 hosting the parameter server thread on
   the host; three pushes a worker (Module.update: push every gradient,
   pull every weight) in a fixed order by the store's barriers; the
   server's final weights bit-equal to a one-process replay of the same
   pushes in the same order through the optimizer rank 0 shipped, on the
   CPU; rescale_grad 1/64; num_dead_node() 0 after both close; the
   push/pull round's ms. (c) with two or more cards visible,
   tools/torch_dist_check.py's run() over every visible card (its
   workers in their own processes); with one card it prints "18c: not
   run, 1 card visible" and claims nothing.
19. the autotuner (ROADMAP.md Queue A item 11b). (a)
   mxnet_tpu_torch.autotune.run_smoke over the distinct K3 products (42)
   and K4/K5 shapes (12) of phase 6's step, in f32 and bf16: K3's split-K
   chunk (the kernel's rule, no split, half and twice its splits), K4's
   grid cap (its own, 2, 8, 16 and 32 blocks an SM), K5's row blocks
   (its own, half, twice, four times), each candidate launched through
   the wrapper and held against the plain version first (K3 within 1e-6
   of sum|a||b| and bit-identical on a rerun, K4 bit-equal, K5 dx as
   phase 3 and its sums bit-identical on a rerun: a wrong one raises),
   timed by CUDA events (median of 10, L2 flushed), 5 s a search; rows
   through the fence (no MFU over 100%, no time under the kernel's
   bound), winners cached under the card's name; the default's and the
   winner's ms a shape and summed over a step. (b) phase 6's fit with
   MXNET_TPU_AUTOTUNE=1 over that cache: the classic loop, then the fused
   step: one capture, bit-equal to the classic loop, launches 210/106/106
   and two profiled replays the same, the 66 f32 signatures' tuned
   configs applied; the untuned fused fit and its float32 floor (its
   distance when the images move by 1 +- 2^-23): the tuned params and
   moving statistics within 4 floors (at least 1e-4) of it, normwise;
   device ms a replay tuned and untuned, in turns. 19b's fits start from
   phase 6's weights with each residual block's last BatchNorm gamma at
   0.25, as tools/torch_dp_check.py conditions them: with every gamma
   at 1 the untuned fit moves 0.98 of its update when its images move
   by one rounding, which leaves no bound.
20. fsdp, tp and the sharding API (ROADMAP.md Queue A item 10c). (a)
   one card: parallel.build_sgd_train_step over a one-rank (dp, fsdp)
   DeviceMesh, its params placed by fsdp_param_spec rules
   (make_param_shardings, shard_args), one step of ResNet-50 NHWC at
   batch 32 from phase 6's seed-0 weights with the residual blocks' last
   BatchNorm gamma at 0.25, in f32 and in bf16 (compute_dtype), against
   the same SGD step taken by the classic loop (lr 0.0125/32 with
   rescale 1, momentum 0, wd 0): params and moving statistics within
   one floor (the classic step's distance when its images move by one
   rounding of the dtype, 1 +- 2^-23 or 1 +- 2^-8), at least 1e-6,
   normwise as a share of its update; outputs finite, (32, 1000);
   launches K3 105, K4 53, K5 53 a step. (b) with two or more cards
   visible, tools/torch_shard_check.py's part (a) in this process over
   every visible card (fit under MXNET_TPU_MESH_FSDP at the number of
   cards and at 2 against dp and against one card at the global batch:
   within 4 float32 floors, replicas bit-equal after the gather, one
   capture, 105/53/53 a replay on every card, optimizer-state bytes a
   card 1/fsdp of dp's); with one card it prints "20b: not run, 1 card
   visible". 20b runs after 17b.
21. the fused step over several cards with the uint8 device feed and
   with Dropout (ROADMAP.md Queue A, the two 10a leftovers). (a) one
   card: AlexNet NCHW at batch 32 (224 x 224, Dropout as the zoo builds
   it) through fit(fused_step=True) and the classic loop from the same
   generator seed (mx.random.seed(0)), 3 steps: one capture, params,
   moving statistics, outputs and losses bit-equal, each Dropout's keep
   mask (read by a tap where its input is not zero) fresh at each
   replay, the keep rate within 5 standard errors of 1 - p, K3 9 a
   replay (profiled). (b) with two or more cards visible,
   tools/torch_dp_feed_check.py's run() in this process over every
   visible card, after 20b: ResNet-50 NHWC at 32 a card trained from a
   seeded uint8 cache (1024 frames of 256^2) with each card cropping its
   rows inside the one CUDA graph, against one card at the global batch
   (within 4 float32 floors), the classic loop over the cards
   (bit-equal) and fsdp over the cards; each card's crop bit-equal to
   its rows of the one-card crop; crop_norm 1, K3 105, K4 53, K5 53 a
   replay on every card; then AlexNet, VGG-16 and Inception-v3 with
   Dropout over the cards, fused against classic bit-equal, masks fresh
   each replay and different across cards; both planted controls
   caught. With one card it prints "21b: not run, 1
   card visible". 21b runs after 20b.
22. pipeline and expert parallelism (ROADMAP.md Queue A item 10d). (a)
   one card, TF32 off, seeded weights: parallel.pipeline_forward over a
   one-rank pp mesh with one K1 stage, tanh(x @ w.T + b) at 4096 -> 4096
   (w ~ N(0, 1/4096), b ~ N(0, 0.01)), 8 microbatches of 32 rows: K1 8
   launches (counts zeroed just before, read just after), the output
   bit-equal to sequential_reference and within linear parity's bound
   of tanh(x @ w.T + b) in float64; one build_pipeline_train_step
   step (mean squared error against seeded labels, lr 0.05) within one
   float32 floor (normwise, as a share of the update; the oracle's
   distance when its inputs move by 1 +- 2^-23) of the sequential
   oracle's SGD step by autograd, K1 8 launches; the same step at 2 rows
   a microbatch on the card against the port on the CPU, rtol 1e-5.
   Switch-Base-8's expert layer (d_model 768, d_ff 3072, 8 experts)
   through parallel.moe_ffn_local over a one-rank ep mesh at 4096 tokens
   (with a common offset, so that top-1 at capacity factor 1.25
   overflows experts): the zero rows equal the drops that _route's
   positions give and the experts' counts over capacity; top-1 and
   top-2 at capacity factor 8.0 (no drops) against moe_reference, rtol
   and atol 1e-5; one top-2 backward against autograd through the dense
   oracle (each gradient within 1e-5 normwise); 256 tokens on the card
   against the port on the CPU; forward and forward+backward ms of both
   layers (CUDA events). (b) with two or more cards visible,
   tools/torch_pp_moe_check.py's run over every visible card, one NCCL
   process a card, after 21b: pp = cards against the sequential oracle
   on one card (outputs bit-equal, K1 8 + cards - 1 launches a forward
   on every rank, one step within 4 float32 floors), pp = cards/2 x dp 2
   on DTensor stages, ep = cards with Switch-Base-8 and 4096 tokens a
   card against one card, eight SGD steps whose loss falls, the first
   step's gradients against one card's, and the planted control (a
   router gradient left unsummed) caught. With one card it prints "22b:
   not run, 1 card visible". 22b runs last in the process.
23. report: one JSON line of kernel records, the card line, then
   {"ok": true, "device": {...}} as the last line.

``--report PATH`` also writes the per-shape records and the main paths'
breakdowns to PATH as JSON. ``--ckpt-child DIR`` is phase 8's child
process and ``--async-child DIR`` one of phase 18b's workers, which the
phases start themselves.
"""
import argparse
import contextlib
import faulthandler
import gc
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, float32 without tensor cores
# H100 SXM data sheet, dense TF32 on the tensor cores over three passes: the
# least time for float32-accurate products (hi*lo + lo*hi + hi*hi)
TF32X3_FLOPS_PER_S = 495e12 / 3
TF32_KERNELS = ("conv_gemm", "linear", "flash_attn")
BATCH = 32
IMAGE = (224, 224, 3)
BN_LAYERS = 53                 # BatchNorm layers of ResNet-50
CONV_GEMMS = 105               # 53 weight + 52 input gradients (not the stem's)
TRAIN_STEPS = 5
TRAIN_OPT = (("learning_rate", 0.0125), ("momentum", 0.9), ("wd", 1e-4),
             ("rescale_grad", 1.0 / BATCH))
GATE_GAMMA_B3 = 0.25           # see gate_module
SPIN_CYCLES = 1_000_000        # ~0.5 ms at the H100's 1.98 GHz boost clock
REQUEST_ROWS = [1, 3, 8, 17, 32, 1, 3, 8, 17, 32, 3, 8]
# (rows, channels, element offset): ragged edges, the scalar path, the
# no-shared-memory path (C > 4096) and a misaligned pointer
RAGGED_SHAPES = [(1000, 100, 0), (7, 3, 0), (4096, 66, 0), (64, 5000, 0),
                 (4096, 64, 1)]
# (M, N, K, transpose_a): ragged edges, one split, many splits, a bare 1x1x1
RAGGED_GEMMS = [(257, 33, 1001, True), (129, 65, 7, False), (1, 1, 1, True),
                (1000, 130, 4099, False)]
# (B, T, H, D) of attention: examples/long_context/ring_attention_demo.py's
# shape, each head width K2 instantiates, and ragged T with D between them
DEMO_ATTN = (1, 4096, 8, 32)
FLASH_SHAPES = [DEMO_ATTN, (2, 1024, 4, 64), (1, 512, 2, 128),
                (1, 256, 2, 256), (2, 100, 2, 48), (1, 1000, 4, 96)]
FLASH_TIMED = [DEMO_ATTN + (False,), DEMO_ATTN + (True,),
               (1, 16384, 8, 128, True)]
# (M, K, N, acts) of the fused linear: the JAX test's shape, ResNet-50's
# classifier head (which the TPU gate refuses), a large layer, a ragged
# one, phase 22's pipeline stage
LINEAR_ACTS = ("none", "relu", "tanh", "sigmoid")
LINEAR_CASES = [(128, 256, 128, LINEAR_ACTS), (BATCH, 2048, 1000, ("none",)),
                (8192, 4096, 4096, ("relu",)), (257, 1001, 33, LINEAR_ACTS),
                (32, 4096, 4096, ("tanh",))]
# timed: the first three cases, the MNIST MLP's layers at batch 128
# (mxnet_tpu/models/mlp.py: 784 -> 128 relu -> 64 relu -> 10), then
# layers with 32, 64, 96 and 128 wide tiles, around the narrow tile's
# limit (two thirds of a wave: 88 on 132 SMs)
LINEAR_TIMED = [(128, 256, 128, "none"), (BATCH, 2048, 1000, "none"),
                (8192, 4096, 4096, "relu"), (128, 784, 128, "relu"),
                (128, 128, 64, "relu"), (128, 64, 10, "none"),
                (512, 1024, 1024, "none"), (1024, 1024, 1024, "none"),
                (768, 2048, 2048, "none"), (1024, 2048, 2048, "none"),
                (4096, 1024, 512, "none"),
                (32, 4096, 4096, "tanh")]     # phase 22's pipeline stage
RTC_N = 1 << 24                # elements of each array of the Rtc bodies
MNIST_TRAIN = 5120             # 40 batches of 128
MNIST_TEST = 1024
MNIST_BATCH = 128
MNIST_EPOCHS = 2
# separable templates at 40/255 pixel noise: both networks should reach
# every held-out digit; 0.97 leaves room for a few hard samples
MNIST_MIN_ACC = 0.97
CKPT_STEPS = 6                 # the checkpoint phase's batches of 32
CKPT_EVERY = 3                 # its periodic cadence: snapshots at 3 and 6
CKPT_DIE_AT = 5                # the SIGTERM child's last step
CKPT_CHILD_TIMEOUT_S = 300


def check(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, "nvidia-smi failed: %s" % res.stderr)
    return res.stdout.strip().splitlines()[0]


def bn_shapes(mx):
    """(rows, channels) -> count of ResNet-50 NHWC BatchNorm applies at
    batch 32, read off the graph."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(BATCH,) + IMAGE)
    counts = {}
    for name, shape in zip(internals.list_outputs(), outs):
        if name.endswith("_bn_output"):
            key = (int(np.prod(shape[:-1])), int(shape[-1]))
            counts[key] = counts.get(key, 0) + 1
    check(sum(counts.values()) == BN_LAYERS, "expected 53 BatchNorms")
    return counts


def _bf16_ulp(torch, t):
    mag = torch.clamp(t.double().abs(), min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def norm_act_fwd_parity(torch, kernels, shapes):
    """Kernel vs plain on the card for every (rows, channels, offset),
    dtype and act; a nonzero offset starts x that many elements into
    its buffer, off the 16-byte alignment the vector path needs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    cases = 0
    for rows, c, offset in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            base = (torch.randn(rows * c + offset, generator=gen,
                                device="cuda") * 2.0 + 0.5).to(dtype)
            x = base[offset:].view(rows, c)
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            shift = torch.randn(c, generator=gen, device="cuda")
            for act in ("none", "relu"):
                got = kernels.fused_norm_act(x, scale, shift, act)
                torch.cuda.synchronize()
                want = kernels.fused_norm_act_plain(x, scale, shift, act)
                torch.cuda.synchronize()
                diff = (got.double() - want.double()).abs()
                mag = want.double().abs()
                if dtype == torch.float32:
                    bound = 1e-6 * torch.clamp(mag, min=1.0)
                elif dtype == torch.float16:
                    bound = torch.zeros_like(mag)   # bit-equal
                else:
                    bound = _bf16_ulp(torch, want)
                bad = int((diff > bound).sum())
                check(bad == 0 and bool(torch.isfinite(got).all()),
                      "norm_act_fwd %s %s act=%s: %d values off (max "
                      "diff %g)" % ((rows, c, offset), dtype, act, bad,
                                    float(diff.max())))
                name = str(dtype).replace("torch.", "")
                worst[name] = max(worst[name], float(diff.max()))
                cases += 1
    return worst, cases


def time_ms(torch, fn, flush, reps=20):
    """Median ms of fn() over reps, each launch timed alone by CUDA
    events with the L2 cache flushed before it. A 0.5 ms spin kernel
    ahead of the start event keeps the card busy while the host makes
    fn's launches, so the events time the device's work and not the
    wrapper's Python and ctypes overhead (tens of us, as long as the
    small kernels themselves)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def norm_act_fwd_timing(torch, kernels, counts):
    flush = torch.empty(64 << 20, device="cuda")   # 256 MB > 50 MB L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_out, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                         "bytes": 0, "flops": 0}
    for (rows, c), n in sorted(counts.items()):
        x = torch.randn(rows, c, generator=gen, device="cuda")
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        shift = torch.randn(c, generator=gen, device="cuda")
        k = time_ms(torch, lambda: kernels.fused_norm_act(x, scale, shift,
                                                          "none"), flush)
        p = time_ms(torch, lambda: kernels.fused_norm_act_plain(
            x, scale, shift, "none"), flush)
        lib = time_ms(torch, lambda: torch.addcmul(shift, x, scale), flush)
        nbytes = 2 * rows * c * 4 + 2 * c * 4
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                          2 * rows * c / F32_FLOPS_PER_S)
        rows_out.append({"rows": rows, "channels": c, "per_forward": n,
                         "ms": k, "plain_ms": p, "library_ms": lib,
                         "bound_ms": bound, "bytes": nbytes,
                         "gb_per_s": nbytes / k / 1e6})
        print("  norm_act_fwd (%7d, %4d) x%-2d kernel %.4f ms  plain %.4f "
              "ms  addcmul %.4f ms  bound %.4f ms  (%.0f GB/s)"
              % (rows, c, n, k, p, lib, bound, nbytes / k / 1e6))
        tot["ms"] += n * k
        tot["plain_ms"] += n * p
        tot["library_ms"] += n * lib
        tot["bytes"] += n * nbytes
        tot["flops"] += n * 2 * rows * c
    tot["bound_ms"] = 1e3 * max(tot["bytes"] / HBM_BYTES_PER_S,
                                tot["flops"] / F32_FLOPS_PER_S)
    return rows_out, tot


def norm_act_bwd_parity(torch, kernels, shapes):
    """K5 against its plain version on the card for every (rows,
    channels, offset), dtype and act: dx float32 bit-equal, bfloat16
    within one ulp; dscale/dshift within 1e-5 * sum|term| of a float64
    sum; a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"dx_float32": 0.0, "dx_bfloat16": 0.0, "dx_float16": 0.0,
             "sums_abs": 0.0, "sums_rel": 0.0}
    cases = 0
    for rows, c, offset in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            base = (torch.randn(rows * c + offset, generator=gen,
                                device="cuda") * 2.0 + 0.5).to(dtype)
            x = base[offset:].view(rows, c)
            g = torch.randn(rows, c, generator=gen, device="cuda").to(dtype)
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            shift = torch.randn(c, generator=gen, device="cuda")
            for act in ("none", "relu"):
                got = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
                again = kernels.fused_norm_act_bwd(x, scale, shift, g, act)
                torch.cuda.synchronize()
                where = "norm_act_bwd %s %s act=%s" % ((rows, c, offset),
                                                       dtype, act)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      where + ": a rerun is not bit-identical")
                pdx, _, _ = kernels.fused_norm_act_bwd_plain(
                    x, scale, shift, g, act)
                diff = (got[0].double() - pdx.double()).abs()
                if dtype != torch.bfloat16:
                    ok = float(diff.max()) == 0.0
                    key = "dx_" + str(dtype).replace("torch.", "")
                    worst[key] = max(worst[key], float(diff.max()))
                else:
                    ok = bool((diff <= _bf16_ulp(torch, pdx)).all())
                    worst["dx_bfloat16"] = max(worst["dx_bfloat16"],
                                               float(diff.max()))
                check(ok and bool(torch.isfinite(got[0]).all()),
                      where + ": dx off by %g" % float(diff.max()))
                gd = g.double()
                if act == "relu":
                    pre = x.float() * scale + shift
                    gd = torch.where(pre > 0, gd, torch.zeros_like(gd))
                for out, term in ((got[1], gd * x.double()), (got[2], gd)):
                    err = (out.double() - term.sum(0)).abs()
                    mag = term.abs().sum(0)
                    check(bool((err <= 1e-5 * mag).all()),
                          where + ": a per-channel sum is off by %g"
                          % float(err.max()))
                    worst["sums_abs"] = max(worst["sums_abs"],
                                            float(err.max()))
                    worst["sums_rel"] = max(worst["sums_rel"], float(
                        (err / torch.clamp(mag, min=1e-30)).max()))
                cases += 1
    return worst, cases


def norm_act_bwd_timing(torch, kernels, counts):
    """K5 at the 53 (rows, channels) of one training step, float32,
    act none (BatchNorm's apply); bytes bound it."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows_out, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "flops": 0}
    for (rows, c), n in sorted(counts.items()):
        x = torch.randn(rows, c, generator=gen, device="cuda")
        g = torch.randn(rows, c, generator=gen, device="cuda")
        scale = torch.rand(c, generator=gen, device="cuda") + 0.5
        shift = torch.randn(c, generator=gen, device="cuda")
        k = time_ms(torch, lambda: kernels.fused_norm_act_bwd(
            x, scale, shift, g, "none"), flush)
        p = time_ms(torch, lambda: kernels.fused_norm_act_bwd_plain(
            x, scale, shift, g, "none"), flush)
        # x and g read, dx written; scale, shift read, dscale, dshift written
        nbytes = 3 * rows * c * 4 + 4 * c * 4
        flops = 4 * rows * c
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rows_out.append({"rows": rows, "channels": c, "per_step": n,
                         "ms": k, "plain_ms": p, "bound_ms": bound,
                         "bytes": nbytes, "gb_per_s": nbytes / k / 1e6})
        print("  norm_act_bwd (%7d, %4d) x%-2d kernel %.4f ms  plain %.4f ms"
              "  bound %.4f ms  (%.0f GB/s)"
              % (rows, c, n, k, p, bound, nbytes / k / 1e6))
        tot["ms"] += n * k
        tot["plain_ms"] += n * p
        tot["bytes"] += n * nbytes
        tot["flops"] += n * flops
    tot["bound_ms"] = 1e3 * max(tot["bytes"] / HBM_BYTES_PER_S,
                                tot["flops"] / F32_FLOPS_PER_S)
    return rows_out, tot


def _shape_param(text):
    return tuple(int(v) for v in text.strip("()").split(",") if v.strip())


def conv_gemm_shapes(mx):
    """(M, N, K, transpose_a) -> count of the K3 products of one
    ResNet-50 NHWC training step at batch 32, read off the graph: per
    convolution the weight gradient (patches^T @ g: M = kh*kw*C, N = O,
    K = N*HO*WO) and, unless its input is the data, the input gradient
    (patches(g~) @ w~: M = N*H*W, N = C, K = kh*kw*O)."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=(BATCH,) + IMAGE)
    shape_of = dict(zip(internals.list_outputs(), outs))
    nodes = json.loads(sym.tojson())["nodes"]
    counts = {}
    convs = 0
    for node in nodes:
        if node["op"] != "Convolution":
            continue
        convs += 1
        src = nodes[node["inputs"][0][0]]
        is_data = src["op"] == "null"
        n, h, w, c = shape_of[src["name"] if is_data
                              else src["name"] + "_output"]
        kh, kw = _shape_param(node["param"]["kernel"])
        o = int(node["param"]["num_filter"])
        _, ho, wo, _ = shape_of[node["name"] + "_output"]
        keys = [(kh * kw * c, o, n * ho * wo, True)]
        if not is_data:
            keys.append((n * h * w, c, kh * kw * o, False))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    check(convs == BN_LAYERS and sum(counts.values()) == CONV_GEMMS,
          "expected 53 convolutions and 105 conv GEMMs, got %d and %d"
          % (convs, sum(counts.values())))
    return counts


def conv_gemm_parity(torch, kernels, shapes, dtypes=("float32", "bfloat16")):
    """K3 against a float64 product of the same operands, for each of
    ``dtypes`` (float32, bfloat16, float16; the 16-bit ones through the
    16-bit mainloop): every element within 1e-6 * sum|a||b|; a rerun
    bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"abs_float32": 0.0, "abs_bfloat16": 0.0, "abs_float16": 0.0,
             "rel": 0.0, "rel_16": 0.0}
    cases = 0
    for m, n, k, trans in shapes:
        for dtype in (getattr(torch, d) for d in dtypes):
            a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                            device="cuda").to(dtype)
            b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
            got = kernels.matmul_f32acc(a, b, trans)
            again = kernels.matmul_f32acc(a, b, trans)
            torch.cuda.synchronize()
            where = "conv_gemm (%d, %d, %d, transpose=%s) %s" % (
                m, n, k, trans, dtype)
            check(torch.equal(got, again), where + ": a rerun differs")
            ad = a.double().t() if trans else a.double()
            err = (got.double() - ad @ b.double()).abs()
            mag = ad.abs() @ b.double().abs()
            check(bool((err <= 1e-6 * mag).all()),
                  where + ": error %g above 1e-6 * sum|a||b|"
                  % float((err - 1e-6 * mag).max()))
            name = "abs_" + str(dtype).replace("torch.", "")
            worst[name] = max(worst[name], float(err.max()))
            rel = float((err / torch.clamp(mag, min=1e-30)).max())
            worst["rel"] = max(worst["rel"], rel)
            if dtype != torch.float32:
                worst["rel_16"] = max(worst["rel_16"], rel)
            cases += 1
            del a, b, ad, err, mag, got, again
    return worst, cases


def conv_gemm_timing(torch, kernels, counts, reps=20, verbose=True):
    """K3 at the (M, N, K, transpose) products of one training step,
    float32 operands, beside the plain version and torch.matmul on the
    same operands; the bound is the longer of 2MNK at the 3xTF32 rate
    and the bytes (A and B read, C written) at the memory rate, and the
    CUDA-core bound (2MNK at the float32 rate) stands beside it."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows_out = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0}
    for (m, n, k, trans), cnt in sorted(counts.items()):
        a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                        device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        at = a.t() if trans else a
        kern = time_ms(torch, lambda: kernels.matmul_f32acc(a, b, trans),
                       flush, reps)
        plain = time_ms(torch, lambda: kernels.matmul_f32acc_plain(a, b,
                                                                   trans),
                        flush, reps)
        lib = time_ms(torch, lambda: torch.matmul(at, b), flush, reps)
        nbytes = (m * k + k * n + m * n) * 4
        flops = 2 * m * n * k
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / TF32X3_FLOPS_PER_S)
        simt = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
        rows_out.append({"m": m, "n": n, "k": k, "transpose_a": trans,
                         "per_step": cnt, "ms": kern, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "simt_bound_ms": simt,
                         "tflops": flops / kern / 1e9})
        if verbose:
            print("  conv_gemm (%6d, %4d, %6d, %s) x%-2d kernel %.4f ms  "
                  "plain %.4f ms  matmul %.4f ms  bound %.4f ms (simt %.4f)  "
                  "(%.1f TFLOP/s)" % (m, n, k, "T" if trans else "N", cnt,
                                      kern, plain, lib, bound, simt,
                                      flops / kern / 1e9))
        tot["ms"] += cnt * kern
        tot["plain_ms"] += cnt * plain
        tot["library_ms"] += cnt * lib
        tot["bytes"] += cnt * nbytes
        tot["flops"] += cnt * flops
        del a, b, at
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    t_flops = tot["flops"] / TF32X3_FLOPS_PER_S
    tot["bound_ms"] = 1e3 * max(t_bytes, t_flops)
    tot["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
    tot["simt_bound_ms"] = 1e3 * max(t_bytes,
                                     tot["flops"] / F32_FLOPS_PER_S)
    return rows_out, tot


def flash_parity(torch, kernels):
    """K2 against its plain version on the card (TF32 off), causal and
    not: every element within rtol 2e-4 / atol 2e-5
    (tests/test_pallas_rtc.py:119-133), a rerun bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst, cases = 0.0, 0
    for shape in FLASH_SHAPES:
        q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
                   for _ in range(3))
        for causal in (False, True):
            got = kernels.flash_attention(q, k, v, causal=causal)
            again = kernels.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            where = "flash_attn %s causal=%s" % (shape, causal)
            check(torch.equal(got, again), where + ": a rerun differs")
            want = kernels.flash_attention_plain(q, k, v, causal=causal)
            err = (got - want).abs()
            bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
            check(bad == 0 and bool(torch.isfinite(got).all()),
                  where + ": %d values beyond rtol 2e-4 / atol 2e-5 (max abs "
                  "err %g)" % (bad, float(err.max())))
            worst = max(worst, float(err.max()))
            cases += 1
        del q, k, v, got, again, want, err
    return worst, cases


def _act64(torch, pre, act):
    return {"none": pre, "relu": torch.relu(pre), "tanh": torch.tanh(pre),
            "sigmoid": torch.sigmoid(pre)}[act]


def cuda_kernels(torch, fn):
    """Names of the kernels the card ran for fn(), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def linear_digests(torch, kernels):
    """sha256 (first 16 hex digits) of K1's output bytes at every
    LINEAR_CASES shape and act on fixed seeded inputs: two trees whose K1
    splits K alike give equal digests on one card."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for m, k, n, acts in LINEAR_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        for act in acts:
            y = kernels.fused_linear(x, w, b, act).cpu().numpy()
            out["(%d, %d) -> %d %s" % (m, k, n, act)] = hashlib.sha256(
                y.tobytes()).hexdigest()[:16]
        del x, w, b
    return out


def linear_parity(torch, kernels):
    """K1 against act(x @ w.T + b) in float64: every element within 1e-6
    of sum|x||w| + |b| (K3's bound), plus 2e-7 (one libm ulp) for tanh
    and sigmoid; a rerun bit-identical; one CUDA launch a call (one more
    call at every shape and act under one torch.profiler session)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst, cases = {"abs": 0.0, "rel": 0.0}, 0
    calls = []
    for m, k, n, acts in LINEAR_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        pre = x.double() @ w.double().t() + b.double()
        mag = x.double().abs() @ w.double().abs().t() + b.double().abs()
        for act in acts:
            got = kernels.fused_linear(x, w, b, act)
            again = kernels.fused_linear(x, w, b, act)
            torch.cuda.synchronize()
            calls.append((x, w, b, act))
            where = "linear (%d, %d) -> %d act=%s" % (m, k, n, act)
            check(torch.equal(got, again), where + ": a rerun differs")
            err = (got.double() - _act64(torch, pre, act)).abs()
            slack = 2e-7 if act in ("tanh", "sigmoid") else 0.0
            check(bool((err <= 1e-6 * mag + slack).all()),
                  where + ": error %g above 1e-6 * (sum|x||w| + |b|)"
                  % float((err - 1e-6 * mag - slack).max()))
            worst["abs"] = max(worst["abs"], float(err.max()))
            worst["rel"] = max(worst["rel"], float((err / mag).max()))
            cases += 1
        del pre, mag, got, again, err
    ran = cuda_kernels(torch, lambda: [kernels.fused_linear(*c)
                                       for c in calls])
    check(len(ran) == len(calls) and all("linear_kernel" in r for r in ran),
          "%d fused_linear calls ran %d kernels, want one linear_kernel "
          "each: %s" % (len(calls), len(ran), sorted(set(ran))))
    return worst, cases


def rtc_bodies(torch, mx, n):
    """The two Rtc kernels of tests/test_pallas_rtc.py:82-107 as CUDA
    bodies over n float32 elements, with their arrays."""
    from mxnet_tpu_torch.rtc import Rtc

    gen = torch.Generator(device="cuda").manual_seed(13)

    def nd(t):
        return mx.nd.NDArray(t, mx.gpu(0))

    x = nd(torch.randn(n, generator=gen, device="cuda"))
    y = nd(torch.randn(n, generator=gen, device="cuda"))
    out = nd(torch.zeros(n, device="cuda"))
    index = "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
    axpy = Rtc("axpy", [("x", x), ("y", y)], [("out", out)],
               index + "if (i < %dLL) out[i] = 2.0f * x[i] + y[i];" % n)
    gelu = Rtc("gelu_ish", [("x", x)], [("out", out)],
               index + "if (i < %dLL) {\n  float v = x[i];\n"
               "  out[i] = v / (1.0f + expf(-1.702f * v));\n}" % n)
    return axpy, gelu, x, y, out


def rtc_dims(n):
    return (-(-n // 256),), (256,)


def rtc_yardsticks(x, y, out, n):
    """The axpy body written two other ways, as yardsticks of what the
    launch route allows, not kernels the port calls: "float4", four
    elements a thread by 16-byte loads, and "ldg", one element a thread
    read through the read-only path (what __restrict__ parameters let the
    compiler choose). Each maps to its Rtc, grid and block."""
    from mxnet_tpu_torch.rtc import Rtc

    check(n % 4 == 0, "the float4 body takes a multiple of 4 elements")
    index = "long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n"
    float4 = ("long long i = ((long long)blockIdx.x * blockDim.x + "
              "threadIdx.x) * 4;\nif (i < %dLL) {\n"
              "  float4 a = *reinterpret_cast<const float4*>(x + i);\n"
              "  float4 c = *reinterpret_cast<const float4*>(y + i);\n"
              "  *reinterpret_cast<float4*>(out + i) = make_float4(2.0f * a.x"
              " + c.x, 2.0f * a.y + c.y, 2.0f * a.z + c.z, 2.0f * a.w + c.w);"
              "\n}" % n)
    ldg = index + ("if (i < %dLL) out[i] = 2.0f * __ldg(x + i) + "
                   "__ldg(y + i);" % n)
    arrays = ([("x", x), ("y", y)], [("out", out)])
    return {"float4": (Rtc("axpy4", *arrays, float4), (-(-n // 1024),),
                       (256,)),
            "ldg": (Rtc("axpy_ldg", *arrays, ldg),) + rtc_dims(n)}


def rtc_parity(torch, mx):
    """The axpy body bit-equal to 2*x+y, the gelu-like body within rtol
    1e-4 of the plain torch expression, a bad body raising with NVRTC's
    log."""
    from mxnet_tpu_torch.rtc import Rtc

    axpy, gelu, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    axpy.push([x, y], [out], grid, block)
    torch.cuda.synchronize()
    check(torch.equal(out.handle, 2 * x.handle + y.handle),
          "Rtc axpy differs from 2*x+y")
    gelu.push([x], [out], grid, block)
    torch.cuda.synchronize()
    v = x.handle
    want = v / (1 + torch.exp(-1.702 * v))
    rel = float(((out.handle - want).abs() / want.abs().clamp(min=1e-30))
                .max())
    check(rel <= 1e-4, "Rtc gelu_ish off by rtol %g" % rel)
    # in place: x is the input and the output
    z = mx.nd.NDArray(x.handle.clone(), mx.gpu(0))
    scale2 = Rtc("scale2", [("x", z)], [("out", z)],
                 "long long i = (long long)blockIdx.x * blockDim.x + "
                 "threadIdx.x;\nif (i < %dLL) out[i] = 2.0f * x[i];" % RTC_N)
    scale2.push([z], [z], grid, block)
    torch.cuda.synchronize()
    check(torch.equal(z.handle, 2 * x.handle), "in-place Rtc push of "
          "out[i] = 2.0f * x[i] differs from 2*x")
    for name, (body, grid_, block_) in rtc_yardsticks(x, y, out,
                                                      RTC_N).items():
        out.handle.zero_()
        body.push([x, y], [out], grid_, block_)
        torch.cuda.synchronize()
        check(torch.equal(out.handle, 2 * x.handle + y.handle),
              "the %s axpy body differs from 2*x+y" % name)
    try:
        Rtc("bad", [("x", x)], [("out", out)], "this is not CUDA !!!")
    except mx.MXNetError as e:
        check("NVRTC failed to compile" in str(e) and "error" in str(e),
              "a bad Rtc body raised without NVRTC's log: %s" % e)
        log_head = str(e).splitlines()[1][:120]
    else:
        raise RuntimeError("chip_smoke check failed: a bad Rtc body compiled")
    return {"axpy_max_abs_err": 0.0, "gelu_max_rel_err": rel,
            "bad_body_log": log_head}


def flash_timing(torch, kernels):
    """K2 beside its plain version and scaled_dot_product_attention on
    (B, H, T, D) f32 (timed, never called by the port). The bound: 4 *
    B*H*D flops a (query, key) pair the mask keeps (T*T, or T*(T+1)/2
    causal) at the 3xTF32 rate, or q, k, v, o at the memory rate; the
    CUDA-core bound (the flops at the f32 rate) beside it."""
    import torch.nn.functional as F

    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for b, t, h, d, causal in FLASH_TIMED:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda")
                   for _ in range(3))
        qh, kh, vh = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        kern = time_ms(torch, lambda: kernels.flash_attention(
            q, k, v, causal=causal), flush)
        plain = time_ms(torch, lambda: kernels.flash_attention_plain(
            q, k, v, causal=causal), flush)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), flush)
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 4 * b * h * d * pairs
        nbytes = 4 * b * t * h * d * 4
        bound = 1e3 * max(flops / TF32X3_FLOPS_PER_S,
                          nbytes / HBM_BYTES_PER_S)
        simt = 1e3 * max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
        rows.append({"shape": [b, t, h, d], "causal": causal, "ms": kern,
                     "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                     "simt_bound_ms": simt, "flops": flops,
                     "tflops": flops / kern / 1e9})
        print("  flash_attn %s causal=%-5s kernel %.4f ms  plain %.4f ms  "
              "sdpa %.4f ms  bound %.4f ms (simt %.4f)  (%.1f TFLOP/s)"
              % ((b, t, h, d), causal, kern, plain, lib, bound, simt,
                 flops / kern / 1e9))
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


def linear_timing(torch, kernels):
    """K1 beside its plain version and addmm plus the activation (timed,
    never called by the port); the bound is the longer of 2MNK at the
    3xTF32 rate and x, w, b read and out written at the memory rate; the
    CUDA-core bound (2MNK at the f32 rate) beside it."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for m, k, n, act in LINEAR_TIMED:
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda")
        b = torch.randn(n, generator=gen, device="cuda")
        wt = w.t()
        kern = time_ms(torch, lambda: kernels.fused_linear(x, w, b, act),
                       flush)
        plain = time_ms(torch, lambda: kernels.fused_linear_plain(x, w, b,
                                                                  act), flush)
        if act == "relu":
            lib = time_ms(torch, lambda: torch.relu(torch.addmm(b, x, wt)),
                          flush)
        elif act == "tanh":
            lib = time_ms(torch, lambda: torch.tanh(torch.addmm(b, x, wt)),
                          flush)
        else:
            lib = time_ms(torch, lambda: torch.addmm(b, x, wt), flush)
        flops = 2 * m * n * k
        nbytes = (m * k + n * k + n + m * n) * 4
        t_ops, t_bytes = flops / TF32X3_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        rows.append({"m": m, "k": k, "n": n, "act": act, "ms": kern,
                     "plain_ms": plain, "library_ms": lib,
                     "bound_ms": 1e3 * max(t_ops, t_bytes),
                     "simt_bound_ms": 1e3 * max(flops / F32_FLOPS_PER_S,
                                                t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "tflops": flops / kern / 1e9})
        print("  linear (%5d, %4d) -> %4d %-4s kernel %.4f ms  plain %.4f ms"
              "  addmm %.4f ms  bound %.4f ms (%s)  (%.1f TFLOP/s)"
              % (m, k, n, act, kern, plain, lib, rows[-1]["bound_ms"],
                 rows[-1]["bound_by"], flops / kern / 1e9))
        del x, w, b, wt
    return rows


def rtc_timing(torch, mx):
    """The axpy body over RTC_N elements beside its rtc_yardsticks bodies,
    2*x+y and the one PyTorch call that computes it,
    torch.add(y, x, alpha=2); bytes bound it (x and y read, out
    written)."""
    flush = torch.empty(64 << 20, device="cuda")
    axpy, _, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    kern = time_ms(torch, lambda: axpy.push([x, y], [out], grid, block),
                   flush)
    yard = {name: time_ms(torch, lambda: body.push([x, y], [out], g, b),
                          flush)
            for name, (body, g, b) in rtc_yardsticks(x, y, out,
                                                     RTC_N).items()}
    plain = time_ms(torch, lambda: 2 * x.handle + y.handle, flush)
    lib = time_ms(torch, lambda: torch.add(y.handle, x.handle, alpha=2.0),
                  flush)
    bound = 1e3 * 3 * RTC_N * 4 / HBM_BYTES_PER_S
    print("  rtc axpy (%d elements) kernel %.4f ms  float4 body %.4f ms  "
          "ldg body %.4f ms  2*x+y %.4f ms  torch.add %.4f ms  bound %.4f ms"
          % (RTC_N, kern, yard["float4"], yard["ldg"], plain, lib, bound))
    return {"n": RTC_N, "ms": kern, "yardstick_ms": yard,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bound}


def resnet_head_inputs(mx, batch):
    """ResNet-50's pooled features and fc1 output on the card for one
    seeded batch, with fc1's weight and bias (the served module's seeded
    params): the head's (batch, 2048) -> 1000 layer."""
    ctx = mx.gpu(0)
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    names = internals.list_outputs()
    flat = [n for n in names if n.startswith("flatten")]
    check(len(flat) == 1, "expected one Flatten before fc1, got %s" % flat)

    def pick(name):
        return mx.sym.Symbol([internals._outputs[names.index(name)]])

    head = mx.sym.Group([pick(flat[0]), pick("fc1_output")])
    args, aux = build_module(mx, ctx, batch).get_params()
    arrays = {k: a.as_in_context(ctx) for k, a in args.items()}
    rng = np.random.RandomState(21)
    arrays["data"] = mx.nd.array(
        rng.randn(batch, *IMAGE).astype(np.float32), ctx=ctx)
    ex = head.bind(ctx, arrays, grad_req="null",
                   aux_states={k: a.as_in_context(ctx)
                               for k, a in aux.items()})
    feats, logits = ex.forward()
    return (feats.handle, logits.handle, arrays["fc1_weight"].handle,
            arrays["fc1_bias"].handle)


def entry_points_main_path(torch, mx, kernels):
    """Phase 7: the slice's three entry points on the card at full
    width, launch counts zeroed just before and read just after."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel

    rng = np.random.RandomState(20)
    q, k, v = (torch.from_numpy(rng.randn(*DEMO_ATTN).astype(np.float32))
               .to("cuda") for _ in range(3))
    want = parallel.reference_attention(q, k, v, causal=True)
    feats, fc_out, weight, bias = resnet_head_inputs(mx, BATCH)
    axpy, gelu, x, y, out = rtc_bodies(torch, mx, RTC_N)
    grid, block = rtc_dims(RTC_N)
    res = {"attention": {}}
    mesh = parallel.make_mesh({"sp": 1})
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for impl in ("ulysses", "ring"):
            attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                                impl=impl)
            before = kernels.flash_attn_launches
            t0 = time.perf_counter()
            got = attn(q, k, v)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            launched = kernels.flash_attn_launches - before
            err = (got - want).abs()
            bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
            check(bad == 0, "make_ring_attention impl=%s: %d values beyond "
                  "rtol 2e-4 / atol 2e-5 of reference_attention" % (impl, bad))
            res["attention"][impl] = {"flash_attn_launches": launched,
                                      "max_abs_err": float(err.max()),
                                      "host_ms": ms}
        # the reference's signature: the mesh axis by name, positionally,
        # resolved against the mesh make_mesh built last
        for impl, fn in (("ulysses", parallel.ulysses_attention),
                         ("ring", parallel.ring_attention)):
            before = kernels.flash_attn_launches
            got = fn(q, k, v, "sp", True)
            torch.cuda.synchronize()
            err = (got - want).abs()
            bad = int((err > 2e-5 + 2e-4 * want.abs()).sum())
            check(bad == 0, "%s_attention(q, k, v, 'sp', True): %d values "
                  "beyond rtol 2e-4 / atol 2e-5 of reference_attention"
                  % (impl, bad))
            res["attention"][impl + "_axis_name"] = {
                "flash_attn_launches": kernels.flash_attn_launches - before,
                "max_abs_err": float(err.max())}
        check(res["attention"]["ulysses_axis_name"]["flash_attn_launches"]
              == 1 and res["attention"]["ring_axis_name"][
                  "flash_attn_launches"] == 0,
              "flash_attn launches by axis name: ulysses %d (want 1), ring "
              "%d (want 0)"
              % (res["attention"]["ulysses_axis_name"]["flash_attn_launches"],
                 res["attention"]["ring_axis_name"]["flash_attn_launches"]))
        check(res["attention"]["ulysses"]["flash_attn_launches"] == 1
              and res["attention"]["ring"]["flash_attn_launches"] == 0,
              "flash_attn launches a call: ulysses %d (want 1), ring %d (want "
              "0)" % (res["attention"]["ulysses"]["flash_attn_launches"],
                      res["attention"]["ring"]["flash_attn_launches"]))
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        attn = parallel.make_ring_attention(mesh, "sp", causal=True,
                                            impl="ulysses")
        (attn(*leaves) ** 2).sum().backward()
        ref = [a.clone().requires_grad_() for a in (q, k, v)]
        (parallel.reference_attention(*ref, causal=True) ** 2).sum() \
            .backward()
        worst = 0.0
        for name, a, r in zip("qkv", leaves, ref):
            err = (a.grad - r.grad).abs()
            check(bool((err <= 1e-4 + 1e-3 * r.grad.abs()).all()),
                  "ulysses d%s differs from autograd through the reference "
                  "beyond rtol 1e-3 / atol 1e-4 (max %g)"
                  % (name, float(err.max())))
            worst = max(worst, float(err.max()))
        res["attention"]["ulysses_grad_max_abs_err"] = worst
        logits = kernels.fused_linear(feats, weight, bias)
        axpy.push([x, y], [out], grid, block)
        gelu.push([x], [out], grid, block)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    fd, wd = feats.double(), weight.double()
    ref = fd @ wd.t() + bias.double()
    mag = fd.abs() @ wd.abs().t() + bias.double().abs()
    err = (logits.double() - ref).abs()
    check(bool((err <= 1e-6 * mag).all()), "fused_linear at the ResNet-50 "
          "head: error above 1e-6 * (sum|x||w| + |b|)")
    fc_diff = (logits - fc_out).abs()
    fc_err = float(fc_diff.max())
    check(bool((fc_diff <= 4e-6 * mag).all()), "fused_linear and the "
          "FullyConnected output differ beyond 4e-6 * (sum|x||w| + |b|)")
    print("entry points: ulysses (K2 x%d) and ring (K2 x%d) at %s causal, "
          "max abs err vs reference %.3g / %.3g, ulysses grads %.3g; "
          "fused_linear at the ResNet-50 head %s -> 1000 vs FullyConnected "
          "%.3g; launches %s"
          % (res["attention"]["ulysses"]["flash_attn_launches"],
             res["attention"]["ring"]["flash_attn_launches"], DEMO_ATTN,
             res["attention"]["ulysses"]["max_abs_err"],
             res["attention"]["ring"]["max_abs_err"], worst,
             tuple(feats.shape), fc_err, launches))
    want_counts = {"norm_act_fwd": 0, "norm_act_bwd": 0, "conv_gemm": 0,
                   "linear": 1, "flash_attn": 3, "rtc": 2, "roi_pool": 0, "crop_norm": 0}
    check(launches == want_counts, "entry-point launches %s, want %s (K2 "
          "once for each ulysses forward: make_ring_attention's, the one "
          "by axis name and the one under the backward)"
          % (launches, want_counts))
    res.update({"launches": launches, "head_vs_fc_max_abs": fc_err,
                "head_max_abs_err": float(err.max())})
    return res


def build_module(mx, ctx, batch, arg_np=None, aux_np=None,
                 compute_dtype=None):
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)], for_training=False)
    if arg_np is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                       seed=0))
        args, aux = mod.get_params()
        rng = np.random.RandomState(0)
        for name, arr in args.items():
            if name.endswith("gamma"):
                arr[:] = rng.uniform(0.5, 1.0, arr.shape).astype(np.float32)
            elif name.endswith("beta"):
                arr[:] = (rng.randn(*arr.shape) * 0.1).astype(np.float32)
        for name, arr in aux.items():
            v = (rng.uniform(0.5, 2.0, arr.shape) if name.endswith("var")
                 else rng.randn(*arr.shape) * 0.1)
            arr[:] = v.astype(np.float32)
        mod.set_params(args, aux)
    else:
        mod.init_params(None, arg_params=arg_np, aux_params=aux_np)
    return mod


def serve_main_path(torch, mx, kernels, card):
    mod = build_module(mx, mx.gpu(0), BATCH)
    rng = np.random.RandomState(1)
    images = rng.randn(sum(REQUEST_ROWS), *IMAGE).astype(np.float32)
    offs = np.cumsum([0] + REQUEST_ROWS)
    payloads = [images[offs[i]:offs[i + 1]] for i in range(len(REQUEST_ROWS))]
    srv = mx.serving.InferenceServer(mod, top_k=1, max_batch=BATCH)
    try:
        reqs = [None] * len(payloads)

        def client(idx):
            for i in idx:
                reqs[i] = srv.submit([payloads[i]])
                time.sleep(0.002)

        kernels.reset_launch_counts()
        threads = [threading.Thread(target=client,
                                    args=(range(t, len(payloads), 2),))
                   for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        check(not any(t.is_alive() for t in threads), "client hung")
        served = [r.get(300)[0] for r in reqs]
        launches = kernels.launch_counts()
        stats = srv.stats()
    finally:
        srv.close()
    batches = stats["batches"]
    print("main path: %d requests, %d rows, %d batches %s, launches %s"
          % (len(reqs), sum(REQUEST_ROWS), batches,
             stats["batches_by_bucket"], launches))
    check(stats["errors"] == 0, "serving errors: %s" % stats)
    check(launches["norm_act_fwd"] == BN_LAYERS * batches,
          "norm_act_fwd launched %d times for %d batches (want 53 each)"
          % (launches["norm_act_fwd"], batches))

    # served argmax against a direct Executor.forward on the same rows
    ex = mod._exec_group.executor
    checked = 0
    for rows, top in zip(payloads, served):
        pad = np.zeros((BATCH,) + IMAGE, np.float32)
        pad[:len(rows)] = rows
        probs = ex.forward(data=pad)[0].asnumpy()[:len(rows)]
        check(np.all(np.isfinite(probs)), "non-finite probabilities")
        # margin between the top two log-probabilities (= logits)
        top2 = np.log(np.sort(probs, axis=1)[:, -2:].astype(np.float64))
        decisive = top2[:, 1] - top2[:, 0] > 1e-3
        check(np.array_equal(top[decisive], probs.argmax(1)[decisive]),
              "served argmax differs from the direct forward")
        checked += int(decisive.sum())
    print("argmax: %d of %d rows decisive (top-2 logit margin > 1e-3), all "
          "equal to the direct forward" % (checked, sum(REQUEST_ROWS)))
    check(checked >= sum(REQUEST_ROWS) // 2, "too few decisive rows")

    # argmax ties take the first maximum on the card, as jnp.argmax does
    ties = torch.tensor([[0.0, 2.0, 2.0, 1.0]] * 3, device="cuda")
    check(torch.argmax(ties, dim=-1).tolist() == [1, 1, 1],
          "torch.argmax on the card does not take the first maximum")

    # top_k=0 probabilities on the card against the port on the CPU
    two = images[:2]
    with mx.serving.InferenceServer(mod, top_k=0, max_batch=BATCH) as srv0:
        (gpu_probs,) = srv0.infer([two], timeout=300)
    args, aux = mod.get_params()
    cpu_mod = build_module(mx, mx.cpu(), 2, args, aux)
    cpu_probs = cpu_mod.predict(two).asnumpy()
    err = float(np.abs(gpu_probs - cpu_probs).max())
    print("card vs CPU probabilities (2 images): max abs diff %.3g "
          "(bound 1e-4)" % err)
    check(err <= 1e-4, "card and CPU probabilities differ by %g" % err)

    # steady-state latency and throughput at bucket 32
    lat = []
    with mx.serving.InferenceServer(mod, top_k=1, max_batch=BATCH) as srv1:
        for i in range(12):
            req = srv1.submit([images[:BATCH]])
            req.get(300)
            if i >= 2:
                lat.append(req.latency_ms)
    p50 = float(np.median(lat))
    print("bucket 32: p50 request latency %.3f ms, %.1f img/s  [%s]"
          % (p50, BATCH * 1e3 / p50, card))
    breakdown = forward_breakdown(torch, mx, mod, images[:BATCH])
    print("bucket 32 breakdown: H2D %.3f ms, forward %.3f ms on the card "
          "(device busy %.1f%% under the profiler), NHWC .contiguous() "
          "copies per forward: %d  [%s]"
          % (breakdown["h2d_ms"], breakdown["forward_ms"],
             100 * breakdown["busy_share"],
             breakdown["nhwc_copies_per_forward"], card))
    for group, ms in sorted(breakdown["by_group_ms"].items(),
                            key=lambda kv: -kv[1]):
        print("  %-22s %.4f ms per forward" % (group, ms))
    return {"launches": launches["norm_act_fwd"], "batches": batches,
            "batches_by_bucket": stats["batches_by_bucket"],
            "decisive_rows": checked, "cpu_vs_card_max_abs": err,
            "bucket32_p50_ms": p50, "bucket32_img_per_s": BATCH * 1e3 / p50,
            "bucket32_latencies_ms": lat, "breakdown": breakdown}


def _kernel_group(name):
    low = name.lower()
    if "norm_act" in low:
        return "norm_act_fwd (K4)"
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transforms"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd")):
        return "convolution (cuDNN)"
    if "pool" in low:
        return "pooling"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "elementwise" in low or "softmax" in low or "reduce" in low:
        return "elementwise/softmax"
    return "other"


def forward_breakdown(torch, mx, mod, batch):
    """Where one bucket-32 request's time goes on the card: the H2D of
    the host batch and the forward (CUDA events, 10 runs each, medians),
    then kernel time by group and the device's busy share over three
    forwards under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fused = mx.fused_step.make_fused_infer(mod._exec_group.executor,
                                           ["data"], top_k=1)

    def events(fn, reps=10):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    h2d = events(lambda: torch.from_numpy(batch).to("cuda"))
    x_dev = torch.from_numpy(batch).to("cuda")
    fused([x_dev])
    copies0 = mx.ops.nn.nhwc_copies
    fused([x_dev])
    copies = mx.ops.nn.nhwc_copies - copies0
    fwd = events(lambda: fused([x_dev]))
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fused([x_dev])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    groups, kernels_us = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(e.self_device_time_total)
        kernels_us.append((us, e.key))
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us
    busy_us = sum(us for us, _ in kernels_us)
    check(busy_us > 0, "the profiler saw no device time")
    kernels_us.sort(reverse=True)
    return {"h2d_ms": h2d, "forward_ms": fwd,
            "nhwc_copies_per_forward": copies,
            "profiled_wall_ms_per_forward": wall_s * 1e3 / reps,
            "device_ms_per_forward": busy_us / 1e3 / reps,
            "busy_share": busy_us / 1e6 / wall_s,
            "by_group_ms": {g: us / 1e3 / reps for g, us in groups.items()},
            "top_kernels": [{"name": n[:160], "ms_per_forward": us / 1e3 / reps}
                            for us, n in kernels_us[:12]]}


def _train_group(name):
    low = name.lower()
    if "conv_gemm" in low:
        return "conv_gemm (K3)"
    if "norm_act_bwd" in low:
        return "norm_act_bwd (K5)"
    if "norm_act" in low:
        return "norm_act_fwd (K4)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach SGD)"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd")):
        return "convolution forward (cuDNN)"
    return "other"


def train_module(mx, ctx, batch, seed, compute_dtype=None):
    """ResNet-50 NHWC bound for training at ``batch``, Xavier weights
    (fan-in, magnitude 2) from ``seed``; the same seed gives the same
    weights on every device. ``compute_dtype`` is the Module's."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)],
             label_shapes=[("softmax_label", (batch,))], for_training=True)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    return mod


def _host(params):
    return {k: v.asnumpy().copy() for k, v in params.items()}


def train_data(steps=TRAIN_STEPS):
    """``steps`` batches of 32 images and labels from seed 0."""
    rng = np.random.RandomState(0)
    images = rng.randn(steps * BATCH, *IMAGE).astype(np.float32)
    labels = rng.randint(0, 1000, steps * BATCH).astype(np.float32)
    return images, labels


def _resnet_launches(steps):
    """The compiled kernels' launches of ``steps`` ResNet-50 training
    steps, by wrapper."""
    return {"norm_act_fwd": BN_LAYERS * steps,
            "norm_act_bwd": BN_LAYERS * steps,
            "conv_gemm": CONV_GEMMS * steps, "linear": 0, "flash_attn": 0,
            "roi_pool": 0, "crop_norm": 0}


def fit_module(torch, mx, kernels, mod, images, labels, fused, wrap=None,
               optimizer="sgd", optimizer_params=TRAIN_OPT,
               after_batch=None, kvstore="local"):
    """Module.fit of the bound ``mod`` over one epoch of ``images`` in
    batches of 32 on the card, the classic loop or the fused step; launch
    counts and the peak of allocated memory zeroed just before and read
    just after. Per step: the loss of the forward's probabilities and
    the host clock at the batch-end callback, with the card
    synchronised; then ``after_batch(param, mod)``. ``wrap`` wraps the
    NDArrayIter (and is closed after)."""
    metric = mx.metric.Accuracy()
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = torch.from_numpy(labels[param.nbatch * BATCH:
                                      (param.nbatch + 1) * BATCH]).to(
            probs.device, torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if after_batch is not None:
            after_batch(param, mod)

    it = mx.io.NDArrayIter(images, labels, batch_size=BATCH)
    if wrap is not None:
        it = wrap(it)
    mx.random.seed(0)   # Dropout's masks: the same stream in every fit
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mod.fit(it, num_epoch=1, optimizer=optimizer,
            optimizer_params=optimizer_params, eval_metric=metric,
            batch_end_callback=on_batch, fused_step=fused, kvstore=kvstore)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if wrap is not None:
        it.close()
    args, aux = (_host(p) for p in mod.get_params())
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = float(np.median(steps_ms))
    return {"mod": mod, "metric": metric, "launches": launches,
            "losses": [float(v) for v in losses], "steps_ms": steps_ms,
            "step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
            "peak_bytes": peak, "peak_above_start_bytes": peak - base,
            "args": args, "aux": aux, "accuracy": metric.get()[1]}


def fit_resnet(torch, mx, kernels, images, labels, fused):
    """fit_module over TRAIN_STEPS batches from train_module's seed-0
    weights, checked: the launches of every step (classic) or of the
    eager step and the capture (fused), finite losses, every param and
    moving statistic changed."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    args0, aux0 = (_host(p) for p in mod.get_params())
    run = fit_module(torch, mx, kernels, mod, images, labels, fused)
    launches, losses = run["launches"], run["losses"]
    args1, aux1 = run["args"], run["aux"]
    # a replay runs no wrapper: the fused loop's wrappers count the eager
    # step and the capture (fused_train_path counts the replays)
    counted = 2 if fused else TRAIN_STEPS
    want = dict(_resnet_launches(counted), rtc=0)
    loop = "fused" if fused else "classic"
    print("training main path (%s loop): %d steps of %d, launches %s, "
          "losses %s" % (loop, len(losses), BATCH, launches,
                         ["%.4f" % v for v in losses]))
    check(launches == want, "%s training launches %s, want %s (53, 53 and "
          "105 a step, %d steps)" % (loop, launches, want, counted))
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          "%s training losses %s" % (loop, losses))
    unchanged = [k for k in args0 if np.array_equal(args0[k], args1[k])]
    check(not unchanged, "params unchanged by training: %s" % unchanged)
    stale = [k for k in aux0 if np.array_equal(aux0[k], aux1[k])]
    check(not stale, "moving statistics unchanged: %s" % stale)
    check(all(np.all(np.isfinite(v)) for v in args1.values()),
          "non-finite params after training")
    return run


def print_breakdown(loop, breakdown, card):
    print("%s step breakdown: %.3f ms on the card per step (device busy "
          "%.1f%% under the profiler, %.3f ms a step on the host clock)  "
          "[%s]" % (loop, breakdown["device_ms_per_step"],
                    100 * breakdown["busy_share"],
                    breakdown["profiled_wall_ms_per_step"], card))
    for group, ms in sorted(breakdown["by_group_ms"].items(),
                            key=lambda kv: -kv[1]):
        print("  %-30s %.4f ms per step" % (group, ms))


def train_main_path(torch, mx, kernels, card, images, labels):
    """The classic loop (forward_backward, update, update_metric)."""
    run = fit_resnet(torch, mx, kernels, images, labels, fused=False)
    del run["metric"]
    print("classic step (median of steps 2-%d): %.3f ms, %.1f img/s, peak "
          "allocated %.3f GB (%.3f above the start)  [%s]"
          % (TRAIN_STEPS, run["step_ms"], run["img_per_s"],
             run["peak_bytes"] / 1e9, run["peak_above_start_bytes"] / 1e9,
             card))
    run["breakdown"] = train_breakdown(torch, mx, kernels, run.pop("mod"),
                                       images[:BATCH], labels[:BATCH])
    print_breakdown("classic", run["breakdown"], card)
    check_profiled_launches("classic", run["breakdown"])
    run["gate"] = train_gate(mx, images, labels)
    return run


def fused_train_path(torch, mx, kernels, card, images, labels, classic):
    """The fused loop: Module.fit(fused_step=True) from the same weights,
    data and optimizer as the classic loop. One eager step, one capture,
    a replay a batch after the first; the classic loop's launches a step;
    params and moving statistics after 5 steps bit-equal to the classic
    loop's."""
    run = fit_resnet(torch, mx, kernels, images, labels, fused=True)
    mod = run.pop("mod")
    step = mod._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    print("fused step counters: %s" % counters)
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": TRAIN_STEPS - 1},
          "fused step counters %s, want one eager step, one capture and "
          "a replay a batch after the first" % counters)
    diffs = {}
    for name, mine, theirs in (("params", run["args"], classic["args"]),
                               ("aux", run["aux"], classic["aux"])):
        diffs[name] = max(float(np.max(np.abs(mine[k] - theirs[k])))
                          for k in theirs)
        unequal = [k for k in theirs if not np.array_equal(mine[k],
                                                           theirs[k])]
        check(not unequal, "fused and classic %s differ after %d steps at "
              "%s (max abs diff %g)" % (name, TRAIN_STEPS, unequal[:5],
                                        diffs[name]))
    check(run["losses"] == classic["losses"], "fused losses %s, classic %s"
          % (run["losses"], classic["losses"]))
    check(run["accuracy"] == classic["accuracy"], "fused metric %r, classic "
          "%r" % (run["accuracy"], classic["accuracy"]))
    print("fused vs classic after %d steps: params and moving statistics "
          "bit-equal (max abs diff %g / %g), losses and accuracy equal"
          % (TRAIN_STEPS, diffs["params"], diffs["aux"]))
    print("fused step (median of steps 2-%d): %.3f ms, %.1f img/s, peak "
          "allocated %.3f GB (%.3f above the start)  [%s]"
          % (TRAIN_STEPS, run["step_ms"], run["img_per_s"],
             run["peak_bytes"] / 1e9, run["peak_above_start_bytes"] / 1e9,
             card))
    run["breakdown"] = fused_breakdown(torch, mx, kernels, step,
                                       run["metric"], images[:BATCH],
                                       labels[:BATCH])
    print_breakdown("fused", run["breakdown"], card)
    check_profiled_launches("fused", run["breakdown"])
    print("fused replay: %.3f ms a step on the card by CUDA events, %.3f ms "
          "of host time to enqueue a step on an idle card (copy in, "
          "hyperparameters, replay)  [%s]"
          % (run["breakdown"]["event_ms_per_step"],
             run["breakdown"]["host_enqueue_ms"], card))
    run.pop("metric")
    run.update(counters=counters, max_abs_diff_vs_classic=diffs)
    return run


def check_profiled_launches(loop, breakdown):
    """The launches the card ran in the profiled steps, counted from the
    kernel events: 105 K3, 53 K4 and 53 K5 a step."""
    want = _resnet_launches(breakdown["steps"])
    print("%s: launches the card ran in %d profiled steps (kernel events): "
          "%s" % (loop, breakdown["steps"], breakdown["launches"]))
    check(breakdown["launches"] == want, "%s: the card ran %s in %d "
          "profiled steps, want %s" % (loop, breakdown["launches"],
                                       breakdown["steps"], want))


def train_breakdown(torch, mx, kernels, mod, images, labels):
    """Kernel time by group and the device's busy share over two
    training steps (forward_backward + update) under torch.profiler."""
    batch = mx.io.DataBatch([images], [labels])

    def classic_step():
        mod.forward_backward(batch)
        mod.update()

    classic_step()
    torch.cuda.synchronize()
    return _profile_steps(torch, kernels, classic_step)


def _profile_steps(torch, kernels, run_step, reps=2, group=None,
                   warm=False):
    """Kernel time by group (``group``, default _train_group), the busy
    share and the compiled kernels' launches (``kernels.launches_in``
    over the kernel events) of ``reps`` calls of ``run_step`` under
    torch.profiler. With ``warm``, one more call runs first in the same
    session and is not counted: late in the whole run the profiler missed
    the first kernels of a session's first CUDA graph replay (15b's
    crop_norm, its graph's first node), so only the device events from a
    spin kernel launched after that call on are read."""
    group = group or _train_group
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            run_step()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)     # the marker: a kernel of its own
        t0 = time.perf_counter()
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups, kernels_us, names = {}, [], []
    if warm:
        (mark,) = [e for e in events if "spin_kernel" in e.name]
        events = [e for e in events if e is not mark
                  and e.time_range.start >= mark.time_range.start]
        by_name = {}
        for e in events:
            us, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + float(e.time_range.elapsed_us()),
                               count + 1)
        averages = [(n, us, count) for n, (us, count) in by_name.items()]
    else:
        averages = [(e.key, float(e.self_device_time_total), e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
    for key, us, count in averages:
        names += [key] * count
        kernels_us.append((us, key))
        g = group(key)
        groups[g] = groups.get(g, 0.0) + us
    busy_us = sum(us for us, _ in kernels_us)
    check(busy_us > 0, "the profiler saw no device time")
    kernels_us.sort(reverse=True)
    # kernels on several streams overlap (cuDNN's RNN does): the union of
    # their intervals is the time the card was busy
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    union_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union_us += b - max(a, end)
            end = b
    return {"steps": reps, "launches": kernels.launches_in(names),
            "profiled_wall_ms_per_step": wall_s * 1e3 / reps,
            "device_ms_per_step": busy_us / 1e3 / reps,
            "busy_share": busy_us / 1e6 / wall_s,
            "device_union_ms_per_step": union_us / 1e3 / reps,
            "busy_union_share": union_us / 1e6 / wall_s,
            "by_group_ms": {g: us / 1e3 / reps for g, us in groups.items()},
            "top_kernels": [{"name": n[:160], "ms_per_step": us / 1e3 / reps,
                             "group": group(n)}
                            for us, n in kernels_us[:20]]}


def fused_breakdown(torch, mx, kernels, step, metric, images, labels,
                    reps=2, group=None):
    """Two replays of the captured step under torch.profiler (kernel time
    by ``group``, default _train_group); then the
    device time of 10 back-to-back steps by CUDA events, and the host
    time to enqueue one step on an idle card (median of 10, each after a
    synchronise: with work queued, the step waits for the copy out of
    its pinned buffer two steps back)."""
    batch = mx.io.DataBatch([images], [labels])
    step.step(batch, metric)
    torch.cuda.synchronize()
    # warm: late in the run the profiler can miss the first kernels of a
    # session's first replay (_profile_steps)
    res = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                         reps, group, warm=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        step.step(batch, metric)
    end.record()
    torch.cuda.synchronize()
    res["event_ms_per_step"] = start.elapsed_time(end) / 10
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step.step(batch, metric)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    res["host_enqueue_ms"] = 1e3 * float(np.median(host))
    return res


def gate_module(mx, ctx, gamma_b3=None, compute_dtype=None):
    """The training gate's network: :func:`train_module` at batch 2 with
    the gamma of each residual block's last BatchNorm at ``gamma_b3``
    (default GATE_GAMMA_B3)
    (the zero-init-residual recipe of Goyal et al., 2017, kept nonzero so
    that every convolution still gets a gradient). With every gamma at 1
    the step is chaotic in float32 at batch 2: a stage-3 BatchNorm sees
    98 rows a channel, so one ReLU whose pre-activation sits within
    rounding of zero moves a weight gradient by several percent, and the
    port on the CPU against itself, input perturbed by 1e-7, already
    misses rtol 1e-3 / atol 1e-5 by 2.3e-4 at the stem
    (tools/torch_gate_conditioning.py)."""
    gamma_b3 = GATE_GAMMA_B3 if gamma_b3 is None else gamma_b3
    mod = train_module(mx, ctx, 2, seed=1, compute_dtype=compute_dtype)
    args, aux = mod.get_params()
    for name, arr in args.items():
        if name.endswith("_b3_bn_gamma"):
            arr[:] = np.full(arr.shape, gamma_b3, np.float32)
    mod.set_params(args, aux)
    return mod


def train_gate(mx, images, labels):
    """One training step at batch 2 on the card (the kernels) against the
    port on the CPU (their plain versions), same params and data: loss
    within rtol 1e-4, params after the step within rtol 1e-3 / atol
    1e-5."""
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = gate_module(mx, ctx)
        mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
        mod.forward_backward(mx.io.DataBatch([images[:2]], [labels[:2]]))
        mod.update()
        probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
        loss = float(-np.log(probs[np.arange(2),
                                   labels[:2].astype(int)]).mean())
        res.append((loss, _host(mod.get_params()[0])))
    (lg, pg), (lc, pc) = res
    worst = max((float(np.max(np.abs(pg[k] - pc[k])
                              - 1e-3 * np.abs(pc[k]))), k) for k in pc)
    print("training gate (batch 2, card vs CPU): loss %.6f vs %.6f, params "
          "worst excess over rtol 1e-3 %.3g (atol 1e-5) at %s"
          % (lg, lc, worst[0], worst[1]))
    check(abs(lg - lc) <= 1e-4 * abs(lc), "loss %g on the card, %g on the "
          "CPU" % (lg, lc))
    check(worst[0] <= 1e-5, "param %s differs beyond rtol 1e-3 / atol 1e-5"
          % worst[1])
    return {"loss_card": lg, "loss_cpu": lc, "worst_param": worst[1],
            "worst_excess": worst[0]}


def write_mnist_idx(out_dir, seed=0):
    """MNIST-format idx files (train-images-idx3-ubyte and the rest) from
    seeded numpy: a 28x28 template of bright strokes a class, each sample
    its class's template shifted by up to two pixels with Gaussian pixel
    noise. The classes are separable; no PIL, no download."""
    rng = np.random.RandomState(seed)
    templates = (rng.rand(10, 28, 28) < 0.2) * 200.0
    for prefix, n in (("train", MNIST_TRAIN), ("t10k", MNIST_TEST)):
        labels = rng.randint(0, 10, n)
        shifts = rng.randint(-2, 3, (n, 2))
        images = np.stack([np.roll(templates[c], tuple(d), axis=(0, 1))
                           for c, d in zip(labels, shifts)])
        images = np.clip(images + rng.randn(n, 28, 28) * 40.0, 0, 255)
        with open(os.path.join(out_dir, "%s-images-idx3-ubyte" % prefix),
                  "wb") as f:
            f.write(struct.pack(">IIII", 0x803, n, 28, 28))
            f.write(images.astype(np.uint8).tobytes())
        with open(os.path.join(out_dir, "%s-labels-idx1-ubyte" % prefix),
                  "wb") as f:
            f.write(struct.pack(">II", 0x801, n))
            f.write(labels.astype(np.uint8).tobytes())


def mnist_iter(mx, data_dir, split, net, batch, shuffle=True):
    return mx.io.MNISTIter(
        image=os.path.join(data_dir, "%s-images-idx3-ubyte" % split),
        label=os.path.join(data_dir, "%s-labels-idx1-ubyte" % split),
        batch_size=batch, flat=net == "mlp", shuffle=shuffle, seed=0)


def mnist_main_path(torch, mx, kernels, card):
    """The MLP and LeNet through FeedForward(fused_step=True) over
    MNISTIter batches of 128 for MNIST_EPOCHS epochs, launch counts zeroed
    just before each fit and read just after (LeNet: K3 three times a
    step, the weight gradients of both convolutions and conv2's input
    gradient; a replay runs no wrapper, so the wrappers count the eager
    step and the capture); losses fall, held-out accuracy reaches
    MNIST_MIN_ACC; two more replays under torch.profiler run K3 three
    times each for LeNet (kernel events); then three fused steps at batch
    2 on the card against the port on the CPU."""
    res = {}
    with tempfile.TemporaryDirectory() as data_dir:
        write_mnist_idx(data_dir)
        for net in ("mlp", "lenet"):
            losses = []

            def on_batch(param, losses=losses):
                probs = param.locals["self"].get_outputs()[0].handle
                lab = param.locals["data_batch"].label[0].handle.to(
                    probs.device, torch.int64)
                losses.append(-torch.log(probs.gather(1, lab[:, None]))
                              .mean())

            sym = getattr(mx.models, "get_" + net)()
            model = mx.model.FeedForward(
                sym, ctx=mx.gpu(0), num_epoch=MNIST_EPOCHS,
                learning_rate=0.1, momentum=0.9, wd=1e-4,
                initializer=mx.init.Xavier(magnitude=2.0, seed=3),
                fused_step=True)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            model.fit(mnist_iter(mx, data_dir, "train", net, MNIST_BATCH),
                      batch_end_callback=on_batch)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
            step = model._module._fused_step
            steps = len(losses)
            losses = [float(v) for v in losses]
            acc = model.score(mnist_iter(mx, data_dir, "t10k", net,
                                         MNIST_BATCH, shuffle=False))
            head = float(np.mean(losses[:5]))
            tail = float(np.mean(losses[-5:]))
            print("mnist %s: %d fused steps of %d in %.2f s (eager %d, "
                  "captures %d, replays %d), launches %s, loss %.4f -> "
                  "%.4f (mean of the first and last 5), held-out accuracy "
                  "%.4f  [%s]" % (net, steps, MNIST_BATCH, fit_s,
                                  step.eager_steps, step.captures,
                                  step.dispatches, launches, head, tail, acc,
                                  card))
            check((step.eager_steps, step.captures, step.dispatches)
                  == (1, 1, steps - 1), "mnist %s fused counters" % net)
            gemms = 3 if net == "lenet" else 0
            want = {"norm_act_fwd": 0, "norm_act_bwd": 0,
                    "conv_gemm": 2 * gemms, "linear": 0, "flash_attn": 0,
                    "roi_pool": 0, "crop_norm": 0}
            check(launches == dict(want, rtc=0), "mnist %s launches %s "
                  "(the eager step and the capture), want %s"
                  % (net, launches, want))
            batch = mnist_iter(mx, data_dir, "train", net,
                               MNIST_BATCH).next()
            metric = mx.metric.Accuracy()
            ran = _profile_steps(torch, kernels,
                                 lambda: step.step(batch, metric))
            want["conv_gemm"] = ran["steps"] * gemms
            print("mnist %s: launches the card ran in %d profiled replays "
                  "(kernel events): %s" % (net, ran["steps"],
                                           ran["launches"]))
            check(ran["launches"] == want, "mnist %s: the card ran %s in "
                  "%d profiled replays, want %s"
                  % (net, ran["launches"], ran["steps"], want))
            check(all(np.isfinite(losses)) and tail < 0.5 * head,
                  "mnist %s losses did not fall: %.4f -> %.4f"
                  % (net, head, tail))
            check(acc >= MNIST_MIN_ACC, "mnist %s held-out accuracy %.4f < "
                  "%.2f" % (net, acc, MNIST_MIN_ACC))
            res[net] = {"steps": steps, "fit_s": fit_s, "launches": launches,
                        "replays_profiled": ran["steps"],
                        "replay_launches": ran["launches"],
                        "loss_first5": head, "loss_last5": tail,
                        "heldout_accuracy": acc,
                        "gate": mnist_gate(mx, data_dir, net)}
    return res


def mnist_gate(mx, data_dir, net):
    """Three fused steps at batch 2 (eager, capture and replay on the
    card) against the port on the CPU from the same weights and data:
    per-step losses within rtol 1e-4, params within rtol 1e-3 / atol
    1e-5."""
    it = mnist_iter(mx, data_dir, "train", net, 6, shuffle=False)
    batch = it.next()
    x, y = batch.data[0].asnumpy(), batch.label[0].asnumpy()
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        losses = []

        def on_batch(param, losses=losses):
            probs = param.locals["self"].get_outputs()[0].asnumpy()
            lab = y[2 * param.nbatch:2 * param.nbatch + 2].astype(int)
            losses.append(-np.log(probs.astype(np.float64)[
                np.arange(2), lab]).mean())

        mod = mx.mod.Module(getattr(mx.models, "get_" + net)(), context=ctx)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=2), num_epoch=1,
                initializer=mx.init.Xavier(magnitude=2.0, seed=5),
                optimizer_params=(("learning_rate", 0.01), ("momentum", 0.9)),
                batch_end_callback=on_batch, fused_step=True)
        res.append((losses, _host(mod.get_params()[0]), mod._fused_step))
    (lg, pg, sg), (lc, pc, _) = res
    check((sg.eager_steps, sg.captures, sg.dispatches) == (1, 1, 2),
          "mnist gate: fused counters on the card")
    worst = max((float(np.max(np.abs(pg[k] - pc[k])
                              - 1e-3 * np.abs(pc[k]))), k) for k in pc)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    print("mnist %s gate (3 fused steps of 2, card vs CPU): losses %s vs "
          "%s, params worst excess over rtol 1e-3 %.3g (atol 1e-5) at %s"
          % (net, ["%.6f" % v for v in lg], ["%.6f" % v for v in lc],
             worst[0], worst[1]))
    check(loss_err <= 1e-4, "mnist %s losses on the card %s, on the CPU %s"
          % (net, lg, lc))
    check(worst[0] <= 1e-5, "mnist %s param %s differs beyond rtol 1e-3 / "
          "atol 1e-5" % (net, worst[1]))
    return {"losses_card": lg, "losses_cpu": lc, "worst_param": worst[1],
            "worst_excess": worst[0]}


def ckpt_fit(torch, mx, images, labels, after_batch=None, optimizer="sgd",
             optimizer_params=TRAIN_OPT):
    """Module.fit(fused_step=True) over one epoch of the batches of
    ``images`` from train_module's seed-0 weights, MXNET_TPU_CKPT_* as the
    environment has them. Per step: the loss of the forward's
    probabilities and the host clock at the batch-end callback with the
    card synchronised; then ``after_batch(param, mod)``."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = torch.from_numpy(labels[param.nbatch * BATCH:
                                      (param.nbatch + 1) * BATCH]).to(
            probs.device, torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if after_batch is not None:
            after_batch(param, mod)

    torch.cuda.synchronize()
    mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
            num_epoch=1, optimizer=optimizer,
            optimizer_params=optimizer_params,
            eval_metric=mx.metric.Accuracy(), batch_end_callback=on_batch,
            fused_step=True)
    args, aux = (_host(p) for p in mod.get_params())
    return {"mod": mod, "losses": [float(v) for v in losses],
            "steps_ms": [1e3 * (b - a) for a, b in zip(marks, marks[1:])],
            "args": args, "aux": aux}


def _check_params_equal(what, got, want):
    for name in ("args", "aux"):
        unequal = [k for k in want[name]
                   if not np.array_equal(got[name][k], want[name][k])]
        check(not unequal, "%s: %s differ at %s" % (what, name, unequal[:5]))


def _keep_only_step(ckpt, directory, step):
    """Trim the store's manifest to the snapshot of ``step``: a resume
    from a mid-run save, as after a preemption there."""
    store = ckpt.SnapshotStore(directory)
    man = store._read_manifest()
    man["snapshots"] = [e for e in man["snapshots"] if e["step"] == step]
    check(len(man["snapshots"]) == 1, "no snapshot of step %d" % step)
    ckpt.atomic_write_bytes(store._manifest_path(),
                            json.dumps(man).encode())


def checkpoint_main_path(torch, mx, kernels, card):
    """Phase 8 on ResNet-50 NHWC at batch 32 through the fused step:
    (a) an uninterrupted fit of CKPT_STEPS batches; (b) the same with a
    snapshot every CKPT_EVERY steps, losses bit-equal; (c) a fresh module
    resumed from the step-3 snapshot, the rest bit-equal, one capture,
    launch counts zeroed just before and read just after; (d) batches
    b0-b3 then b3 again after a rollback to the step-3 snapshot into the
    live graph; (e) Module.save_checkpoint files loaded on the CPU; (f) a
    child trained on the card and ended by SIGTERM, then resumed."""
    from mxnet_tpu_torch import checkpoint as ckpt

    tel = mx.telemetry
    images, labels = train_data(CKPT_STEPS)
    four = {}

    def keep_four(param, mod):
        if param.nbatch == 3:
            four["args"], four["aux"] = (_host(p) for p in mod.get_params())

    a = ckpt_fit(torch, mx, images, labels, keep_four)
    check(len(a["losses"]) == CKPT_STEPS and all(np.isfinite(a["losses"])),
          "checkpoint (a): losses %s" % a["losses"])
    res = {"losses": a["losses"]}
    env = ("MXNET_TPU_CKPT_DIR", "MXNET_TPU_CKPT_EVERY_N_STEPS",
           "MXNET_TPU_CKPT_RESUME")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tel.reset()
        tel.enable()
        # (b) the cadence: saving perturbs nothing
        os.environ.update({env[0]: os.path.join(tmp, "b"),
                           env[1]: str(CKPT_EVERY), env[2]: "0"})
        b = ckpt_fit(torch, mx, images, labels)
        check(b["losses"] == a["losses"], "checkpoint (b): losses with "
              "snapshots %s, without %s" % (b["losses"], a["losses"]))
        _check_params_equal("checkpoint (b)", b, a)
        saves = tel.peek("ckpt.saves")
        check(saves == CKPT_STEPS // CKPT_EVERY, "checkpoint (b): %s saves"
              % saves)
        snap = tel.snapshot()["ckpt"]
        saving = [b["steps_ms"][i - 2] for i in range(CKPT_EVERY,
                                                      CKPT_STEPS + 1,
                                                      CKPT_EVERY)]
        plain = [v for i, v in enumerate(b["steps_ms"])
                 if i > 0 and (i + 2) % CKPT_EVERY]
        res["cadence"] = {
            "saves": saves, "bytes": snap["bytes"],
            "snapshot_mb": snap["bytes"] / saves / 1e6,
            "save_ms": snap["save_ms"], "capture_ms": snap["snapshot_ms"],
            "save_ms_median": float(np.median([snap["save_ms"]["min"],
                                               snap["save_ms"]["max"]])),
            "saving_step_ms": saving, "other_step_ms": plain,
            "other_step_ms_median": float(np.median(plain)),
            "steps_ms": b["steps_ms"], "uninterrupted_steps_ms":
                a["steps_ms"]}
        cad = res["cadence"]
        print("checkpoint (b) cadence every %d steps: losses bit-equal to "
              "the uninterrupted run; ckpt.saves %d, ckpt.bytes %d (%.1f MB "
              "a snapshot), ckpt.save_ms median %.1f (min %.1f, max %.1f; "
              "serialise, hash, write), capture (device fetch and param "
              "digests) %.1f ms a save; host "
              "step of the saving steps %s ms against the median of the "
              "other replays %.3f ms  [%s]"
              % (CKPT_EVERY, saves, snap["bytes"], cad["snapshot_mb"],
                 cad["save_ms_median"], snap["save_ms"]["min"],
                 snap["save_ms"]["max"],
                 snap["snapshot_ms"]["sum"] / snap["snapshot_ms"]["count"],
                 ["%.3f" % v for v in saving], cad["other_step_ms_median"],
                 card))
        # (c) a fresh module resumes from the step-3 snapshot
        _keep_only_step(ckpt, os.path.join(tmp, "b"), CKPT_EVERY)
        os.environ.update({env[1]: "0", env[2]: "1"})
        tel.reset()
        kernels.reset_launch_counts()
        c = ckpt_fit(torch, mx, images, labels)
        launches = kernels.launch_counts()
        step = c["mod"]._fused_step
        counters = (step.eager_steps, step.captures, step.dispatches)
        restore_ms = tel.peek("ckpt.restore_ms", "hist_sum")
        print("checkpoint (c) resume from step %d: ckpt.restores %s, "
              "restore %.1f ms (read, check, unpickle, copy in), losses %s, "
              "step counters (eager, captures, replays) %s, launches %s  "
              "[%s]" % (CKPT_EVERY, tel.peek("ckpt.restores"), restore_ms,
                        ["%.4f" % v for v in c["losses"]], counters,
                        launches, card))
        check(tel.peek("ckpt.restores") == 1, "checkpoint (c): restores")
        check(c["losses"] == a["losses"][CKPT_EVERY:], "checkpoint (c): "
              "resumed losses %s, uninterrupted %s"
              % (c["losses"], a["losses"][CKPT_EVERY:]))
        _check_params_equal("checkpoint (c)", c, a)
        check(counters == (1, 1, CKPT_STEPS - CKPT_EVERY - 1),
              "checkpoint (c): step counters %s" % (counters,))
        want = dict(_resnet_launches(2), rtc=0)
        check(launches == want, "checkpoint (c): launches %s, want %s (the "
              "eager step and the capture)" % (launches, want))
        res["resume"] = {"restore_ms": restore_ms, "losses": c["losses"],
                         "counters": counters, "launches": launches}
        # (d) a rollback into the live graph
        os.environ.update({env[0]: os.path.join(tmp, "d"),
                           env[1]: str(CKPT_EVERY), env[2]: "0"})
        ims = np.concatenate([images[:4 * BATCH],
                              images[3 * BATCH:4 * BATCH]])
        labs = np.concatenate([labels[:4 * BATCH],
                               labels[3 * BATCH:4 * BATCH]])
        rolled = {}

        def roll_back(param, mod):
            if param.nbatch == 3:
                rolled["info"] = param.locals["ckpt"].rollback()

        d = ckpt_fit(torch, mx, ims, labs, roll_back)
        step = d["mod"]._fused_step
        counters = (step.eager_steps, step.captures, step.dispatches)
        print("checkpoint (d) rollback to step %s after b3, then b3 again: "
              "losses %s, step counters %s  [%s]"
              % (rolled.get("info", {}).get("step"),
                 ["%.4f" % v for v in d["losses"]], counters, card))
        check(rolled.get("info", {}).get("step") == CKPT_EVERY,
              "checkpoint (d): rollback %s" % rolled)
        check(d["losses"][:4] == a["losses"][:4]
              and d["losses"][4] == a["losses"][3],
              "checkpoint (d): losses %s, want %s then %r"
              % (d["losses"], a["losses"][:4], a["losses"][3]))
        _check_params_equal("checkpoint (d)", d, four)
        check(counters == (1, 1, 4), "checkpoint (d): step counters %s"
              % (counters,))
        res["rollback"] = {"losses": d["losses"], "counters": counters}
        res["files"] = checkpoint_files(mx, c["mod"], tmp)
    finally:
        for k in env:
            os.environ.pop(k, None)
        tel.disable()
        tel.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    res["sigterm"] = checkpoint_sigterm(card)
    print("checkpoint phase, ResNet-50 NHWC batch 32 f32, fused step: "
          "snapshot %.1f MB, save %.1f ms (median of %d; capture "
          "%.1f ms more), restore %.1f ms, saving step %.3f ms against "
          "the median step %.3f ms  [%s]"
          % (res["cadence"]["snapshot_mb"], res["cadence"]["save_ms_median"],
             res["cadence"]["saves"],
             res["cadence"]["capture_ms"]["sum"]
             / res["cadence"]["capture_ms"]["count"],
             res["resume"]["restore_ms"], res["cadence"]["saving_step_ms"][0],
             res["cadence"]["other_step_ms_median"], card))
    return res


def _state_arrays(state):
    """An optimizer state (None, an NDArray or a tuple) as numpy arrays."""
    if state is None:
        return []
    parts = state if isinstance(state, tuple) else (state,)
    return [p.asnumpy() for p in parts]


def checkpoint_files(mx, mod, tmp, optimizer="sgd",
                     optimizer_params=TRAIN_OPT):
    """(e): save_checkpoint with the optimizer states on the card, loaded
    into a Module on the CPU; params and optimizer states bit-equal."""
    prefix = os.path.join(tmp, "resnet50")
    t0 = time.perf_counter()
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    save_s = time.perf_counter() - t0
    cpu = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                             context=mx.cpu())
    cpu.bind(data_shapes=[("data", (1,) + IMAGE)],
             label_shapes=[("softmax_label", (1,))])
    cpu.init_optimizer(optimizer=optimizer,
                       optimizer_params=optimizer_params)
    cpu.load_optimizer_states(prefix + "-0001.states")
    want = dict(zip(("args", "aux"), (_host(p) for p in mod.get_params())))
    got = dict(zip(("args", "aux"), (_host(p) for p in cpu.get_params())))
    _check_params_equal("checkpoint (e) files on the CPU", got, want)
    states = mod._updater.states
    unequal = [i for i, s in states.items()
               if not all(np.array_equal(a, b) for a, b in zip(
                   _state_arrays(cpu._updater.states[i]),
                   _state_arrays(s)))]
    check(sorted(cpu._updater.states) == sorted(states) and not unequal,
          "checkpoint (e): momenta differ at %s" % unequal[:5])
    sizes = {ext: os.path.getsize("%s-0001.%s" % (prefix, ext))
             for ext in ("params", "states")}
    print("checkpoint (e) files: save_checkpoint with optimizer states in "
          "%.2f s (%s bytes), loaded by a Module on the CPU: params and "
          "the optimizer states of %d params bit-equal"
          % (save_s, sizes, len(states)))
    return {"save_s": save_s, "bytes": sizes, "momenta": len(states)}


def checkpoint_sigterm(card):
    """(f): a child trains the MNIST MLP on the card through
    fit(fused_step=True) with MXNET_TPU_CKPT_DIR set and sends itself
    SIGTERM after step CKPT_DIE_AT: it must end by the signal with a
    "preempt" snapshot of that step; a second child resumes from it and
    runs the epoch to its end."""
    import signal

    tmp = tempfile.mkdtemp(prefix="chip_smoke_sigterm_")
    try:
        write_mnist_idx(tmp)
        snaps = os.path.join(tmp, "snaps")
        env = dict(os.environ, MXNET_TPU_CKPT_DIR=snaps,
                   MXNET_TPU_CKPT_EVERY_N_STEPS="0",
                   MXNET_TPU_CRASH_DIR=os.path.join(tmp, "crash"),
                   CKPT_CHILD_DIE_AT=str(CKPT_DIE_AT))
        cmd = [sys.executable, os.path.abspath(__file__), "--ckpt-child",
               tmp]
        runs = []
        for die in (True, False):
            if not die:
                env.pop("CKPT_CHILD_DIE_AT")
            t0 = time.perf_counter()
            try:
                r = subprocess.run(cmd, env=env, capture_output=True,
                                   text=True, timeout=CKPT_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                check(False, "checkpoint (f): the child ran past %d s"
                      % CKPT_CHILD_TIMEOUT_S)
            runs.append((r, time.perf_counter() - t0))
            with open(os.path.join(snaps, "MANIFEST.json")) as f:
                last = json.load(f)["snapshots"][-1]
            if die:
                check(r.returncode == -signal.SIGTERM, "checkpoint (f): the "
                      "child ended with %s, not by SIGTERM: %s"
                      % (r.returncode, r.stderr[-2000:]))
                check(last["reason"] == "preempt"
                      and last["step"] == CKPT_DIE_AT, "checkpoint (f): "
                      "newest snapshot %s" % last)
                preempt = last
        r = runs[-1][0]
        check(r.returncode == 0, "checkpoint (f): the resumed child ended "
              "with %s: %s" % (r.returncode, r.stderr[-2000:]))
        with open(os.path.join(tmp, "stream.txt")) as f:
            seen = [tuple(map(int, line.split()[:2])) for line in f]
        batches = MNIST_TRAIN // MNIST_BATCH
        check(seen == [(0, i) for i in range(CKPT_DIE_AT)]
              + [(0, i) for i in range(CKPT_DIE_AT, batches)],
              "checkpoint (f): the steps the two children ran: %s" % seen)
        check(os.path.exists(os.path.join(tmp, "completed")),
              "checkpoint (f): the resumed child did not finish")
        print("checkpoint (f) SIGTERM: the child ended by the signal (rc %d) "
              "after step %d with a \"%s\" snapshot of step %d (%d bytes); "
              "a second child resumed and ran steps %d-%d; %.1f s and %.1f s "
              "of wall time  [%s]"
              % (runs[0][0].returncode, CKPT_DIE_AT, preempt["reason"],
                 preempt["step"], preempt["bytes"], CKPT_DIE_AT + 1,
                 batches, runs[0][1], runs[1][1], card))
        return {"rc": runs[0][0].returncode, "snapshot": preempt,
                "wall_s": [t for _, t in runs]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ckpt_child(data_dir):
    """The SIGTERM phase's child: the MNIST MLP on the card through
    Module.fit(fused_step=True) over MNISTIter for one epoch, the
    checkpoint manager armed by MXNET_TPU_CKPT_*; each step appends
    ``epoch nbatch`` to ``stream.txt``; with CKPT_CHILD_DIE_AT it sends
    itself SIGTERM after that step; at the end it writes ``completed``."""
    import signal

    import mxnet_tpu_torch as mx

    die_at = int(os.environ.get("CKPT_CHILD_DIE_AT", "0"))
    steps = [0]

    def on_batch(param):
        steps[0] += 1
        with open(os.path.join(data_dir, "stream.txt"), "a") as f:
            f.write("%d %d\n" % (param.epoch, param.nbatch))
        if steps[0] == die_at:
            os.kill(os.getpid(), signal.SIGTERM)

    mod = mx.mod.Module(mx.models.get_mlp(), context=mx.gpu(0))
    mod.fit(mnist_iter(mx, data_dir, "train", "mlp", MNIST_BATCH),
            num_epoch=1, initializer=mx.init.Xavier(magnitude=2.0, seed=3),
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            batch_end_callback=on_batch, fused_step=True)
    with open(os.path.join(data_dir, "completed"), "w") as f:
        f.write("ok")
    return 0


# ---------------------------------------------------------------------------
# phase 9: fit's health and input plane through the fused step
# ---------------------------------------------------------------------------

PLANE_STEPS = 9                # batches of 32 a phase-9 fit
PLANE_WINDOW = (2, 6)          # timed: the steps after batch 2 to batch 6;
#                                profiled: the last two (batches 7 and 8)
PLANE_ENV = ("MXNET_TPU_DEVICE_STAGING", "MXNET_TPU_FEED_DEPTH",
             "MXNET_TPU_NUMWATCH", "MXNET_TPU_NUMWATCH_EVERY_N",
             "MXNET_TPU_NUMWATCH_GUARD", "MXNET_TPU_CKPT_DIR",
             "MXNET_TPU_METRICS_PORT", "MXNET_TPU_FLIGHT_RECORDER",
             "MXNET_TPU_CRASH_DIR")


def plane_fit(torch, mx, kernels, images, labels, env, sync=True,
              after_batch=None, monitor=None, profile=True):
    """One fit(fused_step=True) of ResNet-50 NHWC at batch 32 from
    train_module's seed-0 weights over the batches of ``images``, with
    ``env`` set for the fit and telemetry on; launch counts zeroed just
    before and read just after. ``sync``: the batch-end callback
    synchronises the card every batch; otherwise only at the timing
    window's ends. Measured: the window's wall ms a step, the host ms a
    step spent copying batches in on the training thread (the executor
    group's load_data_batch, plus device staging's ``_stage`` where it
    runs on this thread), io.feed_stall_ms a step, and the device's busy
    share over the last two steps under torch.profiler (started after
    the timing window, stopped at the last batch-end callback after a
    synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    tel = mx.telemetry
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    group = mod._exec_group
    load = group.load_data_batch
    copy_in = []

    def timed_load(batch):
        t0 = time.perf_counter()
        load(batch)
        copy_in.append(time.perf_counter() - t0)

    group.load_data_batch = timed_load
    losses, marks, window = [], [], {}
    prof = tprofile(activities=[ProfilerActivity.CUDA]) if profile else None
    n = len(labels) // BATCH
    # on the card before the fit: a pageable upload in the callback would
    # wait for the card, a synchronise in disguise
    lab_all = torch.from_numpy(labels).to(torch.device("cuda", 0),
                                          torch.int64)

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = lab_all[param.nbatch * BATCH:(param.nbatch + 1) * BATCH]
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        if sync or param.nbatch in PLANE_WINDOW:
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if param.nbatch in PLANE_WINDOW:
            window[param.nbatch] = (
                marks[-1], tel.peek("io.feed_stall_ms", "hist_sum") or 0.0,
                tel.peek("io.staging.h2d_ms", "hist_sum") or 0.0,
                len(copy_in))
        if after_batch is not None:
            after_batch(param, mod)
        if prof is not None and param.nbatch == n - 3:
            torch.cuda.synchronize()
            window["prof_t0"] = time.perf_counter()
            prof.start()
        if prof is not None and param.nbatch == n - 1:
            torch.cuda.synchronize()
            window["prof_wall"] = time.perf_counter() - window["prof_t0"]
            prof.stop()

    saved = {k: os.environ.get(k) for k in PLANE_ENV}
    os.environ.update(env)
    mx.tracing.shutdown()   # a fresh step ring, server and recorder a fit
    tel.reset()
    tel.enable()
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
                num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
                eval_metric=mx.metric.Accuracy(), batch_end_callback=on_batch,
                fused_step=True, monitor=monitor)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        busy = None
        if prof is not None:
            busy_us = sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA)
            busy = busy_us / 1e6 / window["prof_wall"]
        snap = tel.snapshot()
        records = mx.tracing.step_trace().records()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tel.disable()
    steps = PLANE_WINDOW[1] - PLANE_WINDOW[0]
    # a fit shorter than the window times nothing
    a, b = (window.get(PLANE_WINDOW[0]),
            window.get(PLANE_WINDOW[1], window.get(PLANE_WINDOW[0])))
    # device staging stages on this thread; a feed scheduler on its worker
    staged_here = env.get("MXNET_TPU_FEED_DEPTH", "0") == "0"
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(counters == (1, 1, n - 1), "plane fit %s: step counters %s" %
          (env, counters))
    want = dict(_resnet_launches(2), rtc=0)
    check(launches == want, "plane fit %s: launches %s, want %s (the eager "
          "step and the capture)" % (env, launches, want))
    losses = [float(v) for v in losses]
    args, aux = (_host(p) for p in mod.get_params())
    return {
        "mod": mod, "losses": losses, "args": args, "aux": aux,
        "launches": launches, "counters": counters, "snapshot": snap,
        "records": records,
        "wall_ms_per_step": 1e3 * (b[0] - a[0]) / steps,
        "host_step_ms_median": 1e3 * float(np.median(np.diff(marks))),
        "copy_in_ms_per_step": 1e3 * sum(copy_in[a[3]:b[3]]) / steps
        + ((b[2] - a[2]) / steps if staged_here else 0.0),
        "feed_stall_ms_per_step": (b[1] - a[1]) / steps,
        "busy_share": busy}


def _drop(run):
    """Free a fit's module on the card before the next one."""
    import gc

    run.pop("mod", None)
    gc.collect()


def _replay_device_ms(torch, mx, kernels, step, images, labels, reps=10):
    """Device ms a step by CUDA events over ``reps`` back-to-back calls of
    the captured step, and the kernel events a replay under
    torch.profiler (two replays)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    metric = step._fold or mx.metric.Accuracy()
    step.step(batch, metric)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        step.step(batch, metric)
    end.record()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step.step(batch, metric)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (start.elapsed_time(end) / reps, len(names) / 2,
            kernels.launches_in(names))


def plane_main_path(torch, mx, kernels, card):
    """Phase 9 on ResNet-50 NHWC at batch 32 through fit(fused_step=True):
    (1) plain, device staging and feed depth 2, each with and without a
    synchronising batch-end callback, params bit-equal; (2) the numerics
    plane at EVERY_N=1 against unarmed (params bit-equal, one capture,
    launches unchanged, device ms and kernel events a replay, fetch ms,
    the pack against a recomputation on the card), with device staging,
    the metrics server and the flight recorder armed, /metrics and
    /healthz fetched over loopback, the step ring checked and a
    FlightRecorder dump; (3) the skip guard across a NaN batch; (4) the
    rollback guard into the live graph; (5) a default Monitor's rows."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    images, labels = train_data(PLANE_STEPS)
    res = {"configs": {}}
    base = None
    # the profiler's first start sets up its tracing: not in a window
    with tprofile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    # (1) staging and the feed scheduler, with and without a sync callback
    for name, env in (("plain", {}),
                      ("staging", {"MXNET_TPU_DEVICE_STAGING": "1"}),
                      ("feed_depth_2", {"MXNET_TPU_FEED_DEPTH": "2"})):
        for sync in (True, False):
            run = plane_fit(torch, mx, kernels, images, labels, env, sync)
            key = "%s_%s" % (name, "sync" if sync else "nosync")
            if base is None:
                base = run
            else:
                _check_params_equal("plane (1) %s" % key, run, base)
                check(run["losses"] == base["losses"], "plane (1) %s: "
                      "losses %s, plain %s" % (key, run["losses"],
                                               base["losses"]))
            res["configs"][key] = {k: run[k] for k in (
                "wall_ms_per_step", "host_step_ms_median",
                "copy_in_ms_per_step", "feed_stall_ms_per_step",
                "busy_share", "launches")}
            c = res["configs"][key]
            print("plane (1) %-22s wall %.3f ms a step (host step median "
                  "%.3f), copy-in on the training thread %.3f ms a step, "
                  "io.feed_stall_ms %.3f a step, busy %.1f%%  [%s]"
                  % (key, c["wall_ms_per_step"], c["host_step_ms_median"],
                     c["copy_in_ms_per_step"], c["feed_stall_ms_per_step"],
                     100 * c["busy_share"], card))
            if run is not base:
                _drop(run)
    print("plane (1): staging and feed depth 2 leave params, moving "
          "statistics and losses bit-equal to the plain fit")
    # (2) the numerics plane at EVERY_N=1 against unarmed
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plane_")
    recomputed = {}

    def recompute(param, mod):
        # after the timing window: the recomputation syncs per parameter
        ex = mod._exec_group.executor
        plane = param.locals["numwatch"]
        if param.nbatch == PLANE_STEPS - 2:
            recomputed["w"] = [ex.arg_dict[n].handle.double().clone()
                               for n in plane.names]
        if param.nbatch == PLANE_STEPS - 1:
            worst = 0.0
            body = plane._last_body
            for i, name in enumerate(plane.names):
                g = ex.grad_dict[name].handle.double()
                w_old = recomputed["w"][i]
                upd = ex.arg_dict[name].handle.double() - w_old
                want = [float(g.norm()), float(g.abs().max()),
                        float(upd.norm() / w_old.norm())]
                got = [float(np.sqrt(body[i, 0])), float(body[i, 1]),
                       float(np.sqrt(body[i, 6] / body[i, 4]))]
                for gv, wv in zip(got, want):
                    worst = max(worst, abs(gv - wv) / max(abs(wv), 1e-30))
            recomputed["worst_rel"] = worst
            recomputed["names"] = len(plane.names)

    armed_env = {"MXNET_TPU_NUMWATCH": "1", "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                 "MXNET_TPU_DEVICE_STAGING": "1",
                 "MXNET_TPU_METRICS_PORT": "0",
                 "MXNET_TPU_FLIGHT_RECORDER": "1",
                 "MXNET_TPU_CRASH_DIR": os.path.join(tmp, "crash")}
    try:
        armed = plane_fit(torch, mx, kernels, images, labels, armed_env,
                          after_batch=recompute, profile=False)
        _check_params_equal("plane (2) numwatch armed", armed, base)
        check(armed["losses"] == base["losses"], "plane (2): losses")
        check(recomputed.get("worst_rel", 1.0) <= 1e-5, "plane (2): the "
              "pack's grad l2, max-abs and update/weight ratio against the "
              "recomputation: worst rel err %s" % recomputed.get("worst_rel"))
        step = armed["mod"]._fused_step
        plane = step._numwatch
        fetch = []
        for _ in range(5):
            t0 = time.perf_counter()
            plane.fetch()
            fetch.append(1e3 * (time.perf_counter() - t0))
        # unarmed, armed, unarmed, armed, unarmed, armed in one process
        timed = {False: [], True: []}
        for _ in range(3):
            for is_armed, st in ((False, base["mod"]._fused_step),
                                 (True, step)):
                timed[is_armed].append(_replay_device_ms(
                    torch, mx, kernels, st, images, labels))
        u_ms, u_events, u_launch = (
            float(np.median([t[0] for t in timed[False]])),
            timed[False][0][1], timed[False][0][2])
        a_ms, a_events, a_launch = (
            float(np.median([t[0] for t in timed[True]])),
            timed[True][0][1], timed[True][0][2])
        _drop(base)
        check(a_launch == u_launch, "plane (2): kernel events of the "
              "compiled kernels a replay %s armed, %s unarmed"
              % (a_launch, u_launch))
        res["numwatch"] = {
            "unarmed_device_ms": u_ms, "armed_device_ms": a_ms,
            "device_ms_runs": {"unarmed": [t[0] for t in timed[False]],
                               "armed": [t[0] for t in timed[True]]},
            "unarmed_kernel_events": u_events,
            "armed_kernel_events": a_events,
            "fetch_ms_median": float(np.median(fetch)),
            "pack_worst_rel_err": recomputed["worst_rel"],
            "params": recomputed["names"],
            "wall_ms_per_step": armed["wall_ms_per_step"],
            "unarmed_wall_ms_per_step":
                res["configs"]["staging_sync"]["wall_ms_per_step"],
            "launches": armed["launches"]}
        nw = res["numwatch"]
        print("plane (2) numwatch EVERY_N=1: params bit-equal to unarmed, "
              "captures 1, launches %s; device %.3f ms a step armed against "
              "%.3f unarmed (+%.1f%%; medians of 3 interleaved runs of 10 "
              "replays), kernel events a replay %d against "
              "%d, fetch %.3f ms, pack vs recomputation over %d params "
              "worst rel err %.3g (bound 1e-5); wall a step with staging "
              "%.3f against %.3f ms unarmed  [%s]"
              % (armed["launches"], a_ms, u_ms, 100 * (a_ms / u_ms - 1),
                 a_events, u_events, nw["fetch_ms_median"], nw["params"],
                 nw["pack_worst_rel_err"], nw["wall_ms_per_step"],
                 nw["unarmed_wall_ms_per_step"], card))
        res["server"] = plane_server_checks(mx, armed)
        res["flight"] = plane_flight_dump(mx, tmp)
        _drop(armed)
        res["skip"] = plane_skip_guard(torch, mx, kernels, images, labels,
                                       card)
        res["rollback"] = plane_rollback_guard(torch, mx, kernels, images,
                                               labels, tmp, card)
        res["monitor"] = plane_monitor(torch, mx, kernels, images, labels,
                                       card)
    finally:
        mx.tracing.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def plane_server_checks(mx, armed):
    """(2) cont.: /metrics and /healthz over loopback while the metrics
    server from MXNET_TPU_METRICS_PORT=0 runs; the step ring."""
    import urllib.request

    server = mx.tracing.metrics_server()
    check(server is not None, "plane (2): no metrics server")
    url = "http://127.0.0.1:%d" % server.port
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        text = r.read().decode()
    with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
        health = json.loads(r.read().decode())
    names = {line.split("{")[0] for line in text.splitlines()
             if line and not line.startswith("#")}
    for want in ("mxnet_tpu_step_dispatches", "mxnet_tpu_numwatch_fetches",
                 "mxnet_tpu_numwatch_grad_norm",
                 "mxnet_tpu_io_staging_batches",
                 "mxnet_tpu_io_staging_h2d_ms_count"):
        check(want in names, "plane (2): /metrics lacks %s" % want)
    recs = armed["records"]
    check(len(recs) == PLANE_STEPS and [r["nbatch"] for r in recs]
          == list(range(PLANE_STEPS)), "plane (2): step ring %s"
          % [r.get("nbatch") for r in recs])
    labels = [r["dominant"] for r in recs]
    check(labels[1] == "recompile" and "recompile" not in labels[2:],
          "plane (2): dominant labels %s (the capturing step is the "
          "second)" % labels)
    check(health["status"] == "ok" and health["steps"] == PLANE_STEPS,
          "plane (2): /healthz %s" % health)
    print("plane (2) metrics server :%d: /metrics %d samples with "
          "step.dispatches, numwatch.*, io.staging.*; /healthz %s; step "
          "ring %d records, "
          "dominant %s" % (server.port, len(names), health, len(recs),
                           labels))
    return {"samples": len(names), "healthz": health, "dominant": labels}


def plane_flight_dump(mx, tmp):
    d = mx.tracing.flight_recorder().dump("chip_smoke")
    check(d is not None, "plane (2): the flight recorder did not dump")
    files = sorted(os.listdir(d))
    for want in ("steps.jsonl", "numwatch.jsonl", "meta.json"):
        check(want in files, "plane (2): dump lacks %s: %s" % (want, files))
    with open(os.path.join(d, "steps.jsonl")) as f:
        steps = sum(1 for _ in f)
    with open(os.path.join(d, "numwatch.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    check(steps == PLANE_STEPS and meta["steps_recorded"] == PLANE_STEPS
          and rows and rows[-1]["nonfinite"] == 0,
          "plane (2): dump steps %d, meta %s, rows %d"
          % (steps, meta.get("steps_recorded"), len(rows)))
    print("plane (2) flight recorder dump: %s; steps.jsonl %d records, "
          "numwatch.jsonl %d rows" % (files, steps, len(rows)))
    return {"files": files, "steps": steps, "numwatch_rows": len(rows)}


def plane_skip_guard(torch, mx, kernels, images, labels, card):
    """(3): GUARD=skip, batch 3 all NaN: the weights, momenta and metric
    sums after it bit-identical to before it; one skip; one capture."""
    ims = images.copy()
    ims[3 * BATCH:4 * BATCH] = np.nan
    kept = {}

    def keep(param, mod):
        ex = mod._exec_group.executor
        state = ([ex.arg_dict[n].handle.clone() for n in mod._param_names]
                 + [s.handle.clone() for s in mod._updater.states.values()]
                 + [param.eval_metric._acc.clone()])
        if param.nbatch == 2:
            kept["before"] = state
        if param.nbatch == 3:
            kept["same"] = all(torch.equal(a, b) for a, b in
                               zip(state, kept["before"]))
            kept["skips"] = mx.telemetry.peek("numwatch.skipped_steps")

    run = plane_fit(torch, mx, kernels, ims, labels,
                    {"MXNET_TPU_NUMWATCH": "1",
                     "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                     "MXNET_TPU_NUMWATCH_GUARD": "skip"},
                    after_batch=keep, profile=False)
    check(kept.get("same"), "plane (3): the state moved across the NaN "
          "batch")
    check(kept.get("skips") == 1, "plane (3): numwatch.skipped_steps %s"
          % kept.get("skips"))
    check(all(np.isfinite(run["losses"][4:])), "plane (3): losses after "
          "the skip %s" % run["losses"])
    print("plane (3) skip guard: weights, momenta and metric sums "
          "bit-identical across the NaN batch, numwatch.skipped_steps 1, "
          "captures 1, launches %s, losses after %s  [%s]"
          % (run["launches"], ["%.4f" % v for v in run["losses"][4:]],
             card))
    _drop(run)
    return {"skips": 1, "launches": run["launches"]}


def plane_rollback_guard(torch, mx, kernels, images, labels, tmp, card):
    """(4): GUARD=rollback with MXNET_TPU_CKPT_DIR: a weight poisoned with
    NaN in place after batch 1; the next fetch names it (kind "param")
    and rolls back into the live graph (the same storage, one capture);
    the following steps have finite losses."""
    seen = {}

    def poison(param, mod):
        plane = param.locals["numwatch"]
        ex = mod._exec_group.executor
        if param.nbatch == 1:
            seen["ptrs"] = [a.handle.data_ptr() for a in ex.arg_arrays]
            ex.arg_dict["fc1_weight"].handle.fill_(float("nan"))
            rollback = plane._rollback

            def spy(extras):
                seen["prov"] = plane.provenance()
                t0 = time.perf_counter()
                rollback(extras)
                seen["ms"] = 1e3 * (time.perf_counter() - t0)
            plane._rollback = spy
        if param.nbatch == 2:
            seen["rollbacks"] = mx.telemetry.peek("numwatch.rollbacks")
            seen["same"] = seen["ptrs"] == [a.handle.data_ptr()
                                            for a in ex.arg_arrays]

    run = plane_fit(torch, mx, kernels, images[:5 * BATCH],
                    labels[:5 * BATCH],
                    {"MXNET_TPU_NUMWATCH": "1",
                     "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                     "MXNET_TPU_NUMWATCH_GUARD": "rollback",
                     "MXNET_TPU_CKPT_DIR": os.path.join(tmp, "ckpt")},
                    after_batch=poison, profile=False)
    check(seen.get("prov") == ("fc1_weight", "param", 3),
          "plane (4): provenance %s" % (seen.get("prov"),))
    check(seen.get("rollbacks") == 1 and seen.get("same"),
          "plane (4): rollbacks %s, storage unchanged %s"
          % (seen.get("rollbacks"), seen.get("same")))
    check(all(np.isfinite(run["losses"][3:])), "plane (4): losses after "
          "the rollback %s" % run["losses"])
    saves = run["snapshot"]["ckpt"]["saves"]
    print("plane (4) rollback guard: provenance %s, numwatch.rollbacks 1, "
          "rollback %.1f ms, storage unchanged, captures 1, losses after "
          "%s, healthy saves %d (%.1f ms median)  [%s]"
          % (seen["prov"], seen["ms"],
             ["%.4f" % v for v in run["losses"][3:]], saves,
             run["snapshot"]["ckpt"]["save_ms"]["p50"], card))
    _drop(run)
    return {"provenance": list(seen["prov"]), "rollback_ms": seen["ms"],
            "healthy_saves": saves, "launches": run["launches"],
            "save_ms_p50": run["snapshot"]["ckpt"]["save_ms"]["p50"]}


def plane_monitor(torch, mx, kernels, images, labels, card):
    """(5): a default Monitor through the fused step (it arms the plane
    by itself): at batch 4 its rows equal norm(x)/sqrt(size) of the
    weights before that step's update and of its gradients, recomputed
    on the card."""
    got = {}

    class Keeping(mx.monitor.Monitor):
        def toc_print(self):
            got[self.step] = self.toc()

    mon = Keeping(interval=1)
    pre = {}

    def recompute(param, mod):
        ex = mod._exec_group.executor
        if param.nbatch == 3:
            pre.update({n: a.handle.double().clone()
                        for n, a in ex.arg_dict.items()})
        if param.nbatch == 4:
            pre["grads"] = {n: g.handle.double().clone()
                            for n, g in ex.grad_dict.items()}

    run = plane_fit(torch, mx, kernels, images[:5 * BATCH],
                    labels[:5 * BATCH], {}, after_batch=recompute,
                    monitor=mon, profile=False)
    rows = got[5]
    worst = 0.0
    for _, name, stat in rows:
        t = (pre["grads"][name[:-5]] if name.endswith("_grad")
             else pre[name])
        want = float(t.norm() / t.numel() ** 0.5)
        # the row prints 6 decimals: half a unit of the last, and rtol 1e-5
        worst = max(worst, abs(float(stat) - want) / (5e-7 + 1e-5 * want))
    n_params = len(pre["grads"])
    check(len(rows) == 2 * n_params and worst <= 1.0, "plane (5): %d rows "
          "for %d params, worst error %g of the bound against the "
          "recomputation" % (len(rows), n_params, worst))
    print("plane (5) default Monitor through the fused step: %d rows at "
          "batch 4 equal norm(x)/sqrt(size) recomputed on the card (worst "
          "%.3g of the bound 5e-7 + 1e-5 x value, the rows' 6 decimals); "
          "captures 1, launches %s" % (len(rows), worst, run["launches"]))
    _drop(run)
    return {"rows": len(rows), "worst_rel_err": worst,
            "launches": run["launches"]}


# ---------------------------------------------------------------------------
# 10. the ImageNet models at scale, NCHW
# ---------------------------------------------------------------------------
# name, the models function, its keyword arguments, input side; the K3 launches a
# step (2 x convolutions - 1: the first convolution reads the data,
# which needs no gradient) and the convolutions, from the reference's
# symbols
MODELS = [("alexnet", "get_alexnet", {}, 224, 9, 5),
          ("vgg16", "get_vgg", {"num_layers": 16}, 224, 25, 13),
          ("googlenet", "get_googlenet", {}, 224, 113, 57),
          ("inception_v3", "get_inception_v3", {}, 299, 187, 94),
          ("resnet50_nchw", "get_resnet50", {"layout": "NCHW"}, 224, 105,
           53)]
MODEL_STEPS = 5                # batches of 32 a phase-10 fit
MODEL_CLASSES = 1000
MODEL_GATE_BETA = 2.0          # see model_gate
RECORDIO_RECORDS = 64


def model_symbol(mx, fn, kwargs):
    return getattr(mx.models, fn)(num_classes=MODEL_CLASSES, **kwargs)


def model_convs(mx, sym, data_shape):
    """Every convolution of ``sym`` at ``data_shape`` (NCHW): its input
    and output shapes, kernel, and whether its input is the data; and
    the K3 products of one training step, (M, N, K, transpose_a) ->
    count, as conv_gemm_shapes reads them off ResNet-50 NHWC."""
    internals = sym.get_internals()
    _, outs, _ = internals.infer_shape(data=data_shape)
    shape_of = dict(zip(internals.list_outputs(), outs))
    nodes = json.loads(sym.tojson())["nodes"]
    convs, counts = [], {}
    for node in nodes:
        if node["op"] != "Convolution":
            continue
        src = nodes[node["inputs"][0][0]]
        is_data = src["op"] == "null"
        n, c, h, w = shape_of[src["name"] if is_data
                              else src["name"] + "_output"]
        kh, kw = _shape_param(node["param"]["kernel"])
        out = shape_of[node["name"] + "_output"]
        _, o, ho, wo = out
        convs.append({"name": node["name"], "x": (n, c, h, w),
                      "g": tuple(out), "is_data": is_data})
        keys = [(kh * kw * c, o, n * ho * wo, True)]
        if not is_data:
            keys.append((n * h * w, c, kh * kw * o, False))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    return convs, counts


def _model_group(name):
    low = name.lower()
    if "conv_gemm" in low:
        return "conv_gemm (K3)"
    if "norm_act" in low:
        return "norm_act (K4/K5)"
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transforms (cuDNN)"
    if "catarray" in low:
        return "concat"
    if "copy" in low:
        return "copies (layout, im2col, pads)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach SGD)"
    if any(k in low for k in ("conv", "fprop", "xmma", "implicit", "cudnn",
                              "winograd", "dgrad", "wgrad", "sm90_")):
        return "convolution forward (cuDNN)"
    if "gemm" in low or "cutlass" in low:
        return "matmul (cuBLAS)"
    if "pool" in low:
        return "pooling"
    return "other elementwise/reductions"


def layout_copy_ms(torch, convs):
    """The NCHW -> channels-last copies that K3's wrapper makes in one
    training step (``_Conv2d.backward``: the output cotangent and the
    input of every convolution), each timed alone by CUDA events at its
    shape (median of 5, L2 flushed), summed."""
    flush = torch.empty(64 << 20, device="cuda")
    cache = {}
    total = 0.0
    for conv in convs:
        for shape in (conv["x"], conv["g"]):
            if shape not in cache:
                t = torch.randn(*shape, device="cuda")
                cache[shape] = time_ms(torch, lambda: t.movedim(1, -1)
                                       .contiguous(), flush, reps=5)
                del t
            total += cache[shape]
    return total


def model_data(name, side, steps=MODEL_STEPS):
    """``steps`` batches of 32 seeded synthetic images (NCHW) and labels."""
    rng = np.random.default_rng(sum(map(ord, name)))
    images = rng.standard_normal((steps * BATCH, 3, side, side),
                                 dtype=np.float32)
    labels = rng.integers(0, MODEL_CLASSES, steps * BATCH).astype(np.float32)
    return images, labels


def model_module(mx, sym, ctx, shape, seed=0):
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))], for_training=True)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                   seed=seed))
    return mod


def _same_run(what, got, want):
    for name in ("args", "aux"):
        unequal = [k for k in want[name]
                   if not np.array_equal(got[name][k], want[name][k])]
        check(not unequal, "%s: %s differ at %s" % (what, name, unequal[:5]))
    check(got["losses"] == want["losses"], "%s: losses %s against %s"
          % (what, got["losses"], want["losses"]))
    check(got["accuracy"] == want["accuracy"], "%s: metric %r against %r"
          % (what, got["accuracy"], want["accuracy"]))


def _mask_keyed_dropout(torch, mx, sym):
    """Patch the port's Dropout so that, in train mode, each node draws
    its keep-mask from numpy seeded by its name, on the CPU and on the
    card alike (the card's Philox and the CPU generator draw different
    masks). Returns the function that undoes the patch."""
    import zlib

    nn = mx.ops.nn
    names = {id(n.op): n.name for n in sym._topo()
             if not n.is_variable and type(n.op).__name__ == "Dropout"}
    saved = nn.Dropout.apply

    def apply(self, ctx, inputs, aux):
        x = inputs[0]
        if not ctx.is_train or self.p <= 0.0:
            return [x], []
        rng = np.random.RandomState(zlib.crc32(names[id(self)].encode()))
        keep = torch.from_numpy(rng.rand(*x.shape) < 1.0 - self.p)
        return [torch.where(keep.to(x.device), x / (1.0 - self.p),
                            torch.zeros_like(x))], []

    nn.Dropout.apply = apply

    def undo():
        nn.Dropout.apply = saved
    return undo


def model_gate(torch, mx, sym, images, labels):
    """One classic training step at batch 2 on the card (the kernels)
    against the port on the CPU (their plain versions), the same seed-1
    weights, data and Dropout masks (keyed by node name, see
    _mask_keyed_dropout). Conditioned as the CPU parity tests are
    (tests/torch_vision_helpers.py): every BatchNorm beta at 2, and
    ResNet's residual blocks' last BatchNorm gamma at 0.25, so that few
    ReLU inputs sit within rounding of zero. Bound: the loss within rtol
    1e-4, the update of all params together within 1e-2 of its norm."""
    res = []
    undo = _mask_keyed_dropout(torch, mx, sym)
    try:
        for ctx in (mx.gpu(0), mx.cpu()):
            mod = model_module(mx, sym, ctx, (2,) + images.shape[1:], seed=1)
            args, aux = mod.get_params()
            start = {}
            for name, arr in args.items():
                if name.endswith("_bn_beta"):
                    arr[:] = np.full(arr.shape, MODEL_GATE_BETA, np.float32)
                if name.endswith("_b3_bn_gamma"):
                    arr[:] = np.full(arr.shape, GATE_GAMMA_B3, np.float32)
                start[name] = arr.asnumpy().copy()
            mod.set_params(args, aux)
            mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
            mod.forward_backward(mx.io.DataBatch([images[:2]], [labels[:2]]))
            mod.update()
            probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
            loss = float(-np.log(probs[np.arange(2),
                                       labels[:2].astype(int)]).mean())
            res.append((loss, _host(mod.get_params()[0]), start))
            del mod
    finally:
        undo()
    (lg, pg, s0), (lc, pc, _) = res
    diff = np.concatenate([(pg[k] - pc[k]).ravel() for k in pc])
    upd = np.concatenate([(pc[k] - s0[k]).ravel() for k in pc])
    rel = float(np.linalg.norm(diff) / np.linalg.norm(upd))
    check(abs(lg - lc) <= 1e-4 * abs(lc), "gate loss %g on the card, %g on "
          "the CPU" % (lg, lc))
    check(rel <= 1e-2, "gate: the card's update differs from the CPU's by "
          "%.3g of its norm (bound 1e-2)" % rel)
    return {"loss_card": lg, "loss_cpu": lc, "update_rel_err": rel}


def model_path(torch, mx, kernels, card, spec):
    """Phase 10 for one network: the classic loop and the fused step
    (bit-equal, launches, one capture), profiled replays, the batch-2
    gate, K3 alone over the step's products beside torch.matmul, and the
    layout copies."""
    name, fn, kwargs, side, k3_step, n_convs = spec
    sym = model_symbol(mx, fn, kwargs)
    shape = (BATCH, 3, side, side)
    convs, gemms = model_convs(mx, sym, shape)
    check(len(convs) == n_convs and sum(gemms.values()) == k3_step,
          "%s: %d convolutions and %d K3 products a step, want %d and %d"
          % (name, len(convs), sum(gemms.values()), n_convs, k3_step))
    images, labels = model_data(name, side)
    zero = {"norm_act_fwd": 0, "norm_act_bwd": 0, "linear": 0,
            "flash_attn": 0, "rtc": 0, "roi_pool": 0, "crop_norm": 0}

    def fit(fused, wrap=None):
        mod = model_module(mx, sym, mx.gpu(0), shape)
        return fit_module(torch, mx, kernels, mod, images, labels, fused,
                          wrap)

    classic = fit(False)
    classic.pop("mod")
    classic.pop("metric")
    check(classic["launches"] == dict(zero, conv_gemm=k3_step * MODEL_STEPS),
          "%s classic launches %s, want K3 %d a step and no other"
          % (name, classic["launches"], k3_step))
    check(all(np.isfinite(classic["losses"])), "%s: losses %s"
          % (name, classic["losses"]))
    fused = fit(True)
    mod, metric = fused.pop("mod"), fused.pop("metric")
    step = mod._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": MODEL_STEPS - 1},
          "%s fused counters %s" % (name, counters))
    check(fused["launches"] == dict(zero, conv_gemm=2 * k3_step),
          "%s fused launches %s, want K3 %d (the eager step and the "
          "capture) and no other" % (name, fused["launches"], 2 * k3_step))
    _same_run("%s fused against classic" % name, fused, classic)
    out = {"model": name, "input": list(shape), "convolutions": len(convs),
           "k3_per_step": k3_step, "counters": counters,
           "launches_classic": classic["launches"],
           "launches_fused": fused["launches"], "losses": fused["losses"]}
    if name == "alexnet":
        wrapped = fit(True, wrap=lambda it: mx.io.PrefetchingIter(
            mx.io.ResizeIter(it, MODEL_STEPS)))
        wrapped.pop("mod")
        wrapped.pop("metric")
        _same_run("alexnet through PrefetchingIter(ResizeIter(NDArrayIter)) "
                  "against NDArrayIter", wrapped, fused)
        out["prefetch_resize_bit_equal"] = True
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    step.step(batch, metric)
    torch.cuda.synchronize()
    prof = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                          group=_model_group)
    check(prof["launches"] == dict(
        {k: 0 for k in kernels.LAUNCH_KERNELS}, conv_gemm=2 * k3_step),
        "%s: two profiled replays ran %s, want K3 %d"
        % (name, prof["launches"], 2 * k3_step))
    del mod, step, metric, batch
    torch.cuda.empty_cache()
    out.update(
        step_ms_classic=classic["step_ms"], step_ms_fused=fused["step_ms"],
        img_per_s_classic=classic["img_per_s"],
        img_per_s_fused=fused["img_per_s"],
        peak_gb_classic=classic["peak_bytes"] / 1e9,
        peak_gb_fused=fused["peak_bytes"] / 1e9,
        peak_above_start_gb_classic=classic["peak_above_start_bytes"] / 1e9,
        peak_above_start_gb_fused=fused["peak_above_start_bytes"] / 1e9,
        replays_profiled=prof)
    out["gate"] = model_gate(torch, mx, sym, images, labels)
    _, out["k3_alone"] = conv_gemm_timing(torch, kernels, gemms, reps=10,
                                          verbose=False)
    out["layout_copies_ms"] = layout_copy_ms(torch, convs)
    out["gemms"] = sorted(gemms)
    groups = prof["by_group_ms"]
    print("phase 10 %s NCHW %dx%d batch %d f32: host step %.3f / %.3f ms "
          "(classic / fused), %.1f / %.1f img/s, device %.3f ms a step, busy "
          "%.1f%%, peak %.3f / %.3f GB (%.3f / %.3f above the fit's start); "
          "K3 %.3f ms a step in the replay over "
          "%d launches (alone %.3f, torch.matmul %.3f, bound %.3f); cuDNN "
          "forward %.3f ms; copies %.3f ms (the NCHW layout copies alone "
          "%.3f), cuDNN layout transforms %.3f ms; gate loss %.6f / %.6f, "
          "update %.3g of its norm  [%s]"
          % (name, side, side, BATCH, classic["step_ms"], fused["step_ms"],
             classic["img_per_s"], fused["img_per_s"],
             prof["device_ms_per_step"], 100 * prof["busy_share"],
             classic["peak_bytes"] / 1e9, fused["peak_bytes"] / 1e9,
             classic["peak_above_start_bytes"] / 1e9,
             fused["peak_above_start_bytes"] / 1e9,
             groups.get("conv_gemm (K3)", 0.0), k3_step,
             out["k3_alone"]["ms"], out["k3_alone"]["library_ms"],
             out["k3_alone"]["bound_ms"],
             groups.get("convolution forward (cuDNN)", 0.0),
             groups.get("copies (layout, im2col, pads)", 0.0),
             out["layout_copies_ms"],
             groups.get("layout transforms (cuDNN)", 0.0),
             out["gate"]["loss_card"], out["gate"]["loss_cpu"],
             out["gate"]["update_rel_err"], card))
    return out


def recordio_roundtrip(mx, tmp):
    """MXRecordIO and MXIndexedRecordIO round trips of packed records
    (scalar and vector labels, payloads of every length mod 4) on the
    card's host: no PIL."""
    rio = mx.recordio
    rng = np.random.RandomState(11)
    recs = []
    for i in range(RECORDIO_RECORDS):
        label = float(i) if i % 2 else [float(i), 0.5 * i, -1.0]
        recs.append((label, rng.bytes(int(rng.randint(0, 4096)))))
    rec, idx = os.path.join(tmp, "r.rec"), os.path.join(tmp, "r.idx")
    with rio.MXIndexedRecordIO(idx, rec, "w") as w:
        for i, (label, payload) in enumerate(recs):
            w.write_idx(i, rio.pack(rio.IRHeader(0, label, i, 0), payload))
    seq = []
    with rio.MXRecordIO(rec, "r") as r:
        while True:
            buf = r.read()
            if buf is None:
                break
            seq.append(rio.unpack(buf))
    check([p for _, p in seq] == [p for _, p in recs],
          "recordio: the sequential read differs from what was written")
    with rio.MXIndexedRecordIO(idx, rec, "r") as r:
        for i in rng.permutation(RECORDIO_RECORDS)[:16]:
            header, payload = rio.unpack(r.read_idx(int(i)))
            check(payload == recs[i][1] and header.id == i
                  and np.array_equal(np.asarray(header.label, np.float32),
                                     np.asarray(recs[i][0], np.float32)),
                  "recordio: record %d read by key differs" % i)
    return {"records": RECORDIO_RECORDS, "bytes": os.path.getsize(rec)}


def models_main_path(torch, mx, kernels, card):
    """Phase 10: every network of MODELS through model_path, then K3
    against a float64 product at each of their step's products that
    phase 3 did not check, and the RecordIO round trips."""
    runs = {}
    for spec in MODELS:
        runs[spec[0]] = model_path(torch, mx, kernels, card, spec)
        torch.cuda.empty_cache()
    phase3 = set(conv_gemm_shapes(mx))
    new = sorted({tuple(g) for r in runs.values() for g in r["gemms"]}
                 - phase3)
    worst, cases = conv_gemm_parity(torch, kernels, new)
    print("phase 10 conv_gemm parity: %d cases (%d products of the five "
          "steps that phase 3 does not hold, f32 and bf16), reruns "
          "bit-identical, max abs err vs float64 f32 %g; max %.3g of "
          "sum|a||b| (bound 1e-6)" % (cases, len(new),
                                       worst["abs_float32"], worst["rel"]))
    with tempfile.TemporaryDirectory() as tmp:
        rec = recordio_roundtrip(mx, tmp)
    print("phase 10 recordio: %d packed records written and read back, "
          "sequentially and by key (%d bytes)" % (rec["records"],
                                                 rec["bytes"]))
    return {"models": runs, "k3_parity": dict(worst, cases=cases,
                                              products=len(new)),
            "recordio": rec}


# ---------------------------------------------------------------------------
# phase 11: every fusable optimizer through the fused step, the guards and
# snapshots with Adam, SGLD, a regression head, the imperative functions
# ---------------------------------------------------------------------------

OPTIM_KINDS = ("ccsgd", "nag", "adam", "adagrad", "rmsprop", "adadelta")
# bytes an update must move a param element: w, g and the states read,
# w and the states written (float32)
OPTIM_STATES = {"ccsgd": 1, "nag": 1, "adam": 2, "adagrad": 1, "rmsprop": 3,
                "adadelta": 2}
OPTIM_REL_TOL = 1e-5           # a fused step against its float64 update
REG_STEPS = 5                  # batches of 128 through the regression MLP
REG_BATCH = 128
SGLD_LR = 1e-4


def optim_params(mx, kind):
    """Phase 11's settings of ``kind``: phase 6's wd and rescale_grad, and
    a fresh schedule object each call (a schedule keeps state)."""
    base = {"wd": 1e-4, "rescale_grad": 1.0 / BATCH}
    extra = {"ccsgd": {"learning_rate": 0.0125, "momentum": 0.9},
             "nag": {"learning_rate": 0.0125, "momentum": 0.9},
             "adam": {"learning_rate": 1e-3, "clip_gradient": 5.0},
             "adagrad": {"learning_rate": 0.01},
             "rmsprop": {"learning_rate": 0.002, "lr_scheduler":
                         mx.lr_scheduler.FactorScheduler(step=2,
                                                         factor=0.5)},
             "adadelta": {}, "sgld": {"learning_rate": SGLD_LR}}[kind]
    return dict(base, **extra)


def _host_states(mod):
    return {i: [a.copy() for a in _state_arrays(s)]
            for i, s in mod._updater.states.items()}


def update64(torch, kind, w, g, states, row, clipped):
    """The update of one parameter in float64, written from the JAX
    package's _update_math: ``row`` is its hyperparameter row
    (rescale_grad, the kind's scalars, clip)."""
    g = g * row[0]
    if clipped:
        g = g.clamp(-row[-1], row[-1])
    sc = row[1:-1]
    if kind in ("ccsgd", "nag"):
        lr, wd, mom = sc
        g = g + wd * w
        (m,) = states
        if kind == "nag":
            m = mom * m + g
            return w - lr * (g + mom * m), [m]
        m = mom * m - lr * g
        return w + m, [m]
    if kind == "adam":
        step_lr, wd, b1, b2, eps = sc
        mean, var = states
        g = g + wd * w
        mean = b1 * mean + (1 - b1) * g
        var = b2 * var + (1 - b2) * g * g
        return w - step_lr * mean / (torch.sqrt(var) + eps), [mean, var]
    if kind == "adagrad":
        lr, wd, eps = sc
        (acc,) = states
        acc = acc + g * g
        return w - lr * (g / torch.sqrt(acc + eps) + wd * w), [acc]
    if kind == "rmsprop":
        lr, wd, g1, g2 = sc
        n, gs, delta = states
        g = g + wd * w
        n = (1 - g1) * g * g + g1 * n
        gs = (1 - g1) * g + g1 * gs
        delta = g2 * delta - lr * g / torch.sqrt(n - gs * gs + 1e-4)
        return w + delta, [n, gs, delta]
    wd, rho, eps = sc   # adadelta
    acc_g, acc_d = states
    acc_g = rho * acc_g + (1 - rho) * g * g
    cur = torch.sqrt(acc_d + eps) / torch.sqrt(acc_g + eps) * g
    acc_d = rho * acc_d + (1 - rho) * cur * cur
    return w - cur - wd * w, [acc_g, acc_d]


def optim_float64_check(torch, mx, kind, mod, metric, images, labels):
    """One more fused step (a replay) on the card against the float64
    update of its pre-step weights and states, its gradients and the
    hyperparameter rows the replay read: the largest difference of each
    tensor within OPTIM_REL_TOL of its largest magnitude."""
    step, opt = mod._fused_step, mod._optimizer
    items, _ = step._params()
    w0 = [w.clone() for _, w, _, _ in items]
    s0 = [[t.clone() for t in s] for _, _, _, s in items]
    step.step(mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]]), metric)
    torch.cuda.synchronize()
    (h2d,) = opt._scalars.values()
    hyper = h2d.dst.double()
    groups, clipped = opt.structure([i for i, _, _, _ in items])[:2]
    worst = 0.0
    for gi, group in enumerate(groups):
        for p in group:
            _, w, g, s = items[p]
            want_w, want_s = update64(
                torch, kind, w0[p].double(), g.double(),
                [t.double() for t in s0[p]], hyper[gi], clipped)
            for got, want in [(w, want_w)] + list(zip(s, want_s)):
                scale = float(want.abs().max()) or 1.0
                worst = max(worst, float((got.double() - want).abs().max())
                            / scale)
    check(worst <= OPTIM_REL_TOL, "%s: a fused step differs from its "
          "float64 update by %.3g of the largest magnitude (bound %g)"
          % (kind, worst, OPTIM_REL_TOL))
    return worst


def _optim_group(name):
    low = name.lower()
    if "multi_tensor_apply" in low or "foreach" in low:
        return "update (foreach)"
    return _train_group(name)


def optim_update_timing(torch, kind, mod):
    """The update alone, captured as a CUDA graph over copies of the
    step's weights, gradients, states and hyperparameters: device ms a
    replay from torch.profiler's kernel events (and by CUDA events over
    20 replays), its kernel count, and the bound: the bytes it must move
    at HBM_BYTES_PER_S."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step, opt = mod._fused_step, mod._optimizer
    items, _ = step._params()
    ws = [w.clone() for _, w, _, _ in items]
    gs = [g.clone() for _, _, g, _ in items]
    ss = [tuple(t.clone() for t in s) for _, _, _, s in items]
    (h2d,) = opt._scalars.values()
    hyper = h2d.dst.clone()
    structure = opt.structure([i for i, _, _, _ in items])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.apply(structure, hyper, ws, gs, ss)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        opt.apply(structure, hyper, ws, gs, ss)
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            graph.replay()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us += float(e.self_device_time_total)
            n += e.count
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    elems = sum(w.numel() for w in ws)
    nbytes = 4 * elems * (3 + 2 * OPTIM_STATES[kind])
    del graph, ws, gs, ss
    return {"update_ms": us / 1e3 / 2, "update_kernels": n / 2,
            "update_event_ms": start.elapsed_time(end) / 20,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bytes": nbytes,
            "param_elements": elems}


def optim_kind_path(torch, mx, kernels, card, kind, images, labels):
    """(a) for one optimizer: the classic loop, then the fused step from
    the same weights; launches, one capture, everything bit-equal; one
    replay against its float64 update; the profiled fused step and the
    update alone beside its bound."""
    runs = {}
    for fused in (False, True):
        gc.collect()   # the last fit's module: its peak is not this one's
        torch.cuda.empty_cache()
        mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
        runs[fused] = fit_module(torch, mx, kernels, mod, images, labels,
                                 fused, optimizer=kind,
                                 optimizer_params=optim_params(mx, kind))
        runs[fused]["states"] = _host_states(mod)
        if not fused:
            del runs[fused]["mod"], mod
            torch.cuda.empty_cache()
    classic, fused = runs[False], runs[True]
    mod = fused.pop("mod")
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(classic["launches"] == dict(_resnet_launches(TRAIN_STEPS), rtc=0),
          "%s classic launches %s" % (kind, classic["launches"]))
    check(fused["launches"] == dict(_resnet_launches(2), rtc=0),
          "%s fused launches %s, want the eager step's and the capture's"
          % (kind, fused["launches"]))
    check(counters == (1, 1, TRAIN_STEPS - 1), "%s fused counters %s"
          % (kind, counters))
    check(all(np.isfinite(fused["losses"])), "%s losses %s"
          % (kind, fused["losses"]))
    _same_run("%s fused against classic" % kind, fused, classic)
    n_states = {len(v) for v in fused["states"].values()}
    check(n_states == {OPTIM_STATES[kind]}, "%s: %s state tensors a param"
          % (kind, n_states))
    unequal = [i for i, v in classic["states"].items()
               if not all(np.array_equal(a, b) for a, b in
                          zip(v, fused["states"][i]))]
    check(not unequal and classic["states"].keys() == fused["states"].keys(),
          "%s: optimizer states differ at %s" % (kind, unequal[:5]))
    check(all(np.isfinite(v).all() for v in fused["args"].values()),
          "%s: nonfinite params" % kind)
    metric = mx.metric.Accuracy()
    worst = optim_float64_check(torch, mx, kind, mod, metric, images,
                                labels)
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    prof = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                          group=_optim_group)
    check_profiled_launches("%s fused" % kind, prof)
    upd = optim_update_timing(torch, kind, mod)
    del mod, step, metric
    torch.cuda.empty_cache()
    out = {"kind": kind, "counters": counters,
           "launches_classic": classic["launches"],
           "launches_fused": fused["launches"], "losses": fused["losses"],
           "state_tensors_a_param": OPTIM_STATES[kind],
           "float64_max_rel_diff": worst,
           "step_device_ms": prof["device_ms_per_step"],
           "busy_share": prof["busy_share"],
           "by_group_ms": prof["by_group_ms"],
           "update_share_of_step": upd["update_ms"]
           / prof["device_ms_per_step"],
           "step_ms_classic": classic["step_ms"],
           "step_ms_fused": fused["step_ms"],
           "img_per_s_classic": classic["img_per_s"],
           "img_per_s_fused": fused["img_per_s"],
           "peak_gb_classic": classic["peak_bytes"] / 1e9,
           "peak_gb_fused": fused["peak_bytes"] / 1e9, **upd}
    print("optimizer %s, ResNet-50 NHWC batch 32 f32: classic and fused "
          "bit-equal (params, %d state tensors a param, moving statistics, "
          "losses, metric), one capture; a replay against float64 %.3g "
          "(bound %g); update %.4f ms a replay (profiler, %d kernels; "
          "%.4f ms by CUDA events), bound %.4f ms (%.1f MB at 3.35 TB/s), "
          "%.1f%% of the fused step's %.3f ms on the card (busy %.1f%%); "
          "host step %.3f / %.3f ms, %.1f / %.1f img/s, peak allocated "
          "%.3f / %.3f GB (classic / fused)  [%s]"
          % (kind, OPTIM_STATES[kind], worst, OPTIM_REL_TOL,
             upd["update_ms"], upd["update_kernels"],
             upd["update_event_ms"], upd["bound_ms"], upd["bytes"] / 1e6,
             100 * out["update_share_of_step"], prof["device_ms_per_step"],
             100 * prof["busy_share"], classic["step_ms"], fused["step_ms"],
             classic["img_per_s"], fused["img_per_s"],
             out["peak_gb_classic"], out["peak_gb_fused"], card))
    return out


def optim_adam_guards(torch, mx, kernels, card, images, labels):
    """(b) Adam through the fused step: the skip guard across an all-NaN
    batch (weights, both states, metric sums bit-identical), a snapshot
    at step 3 resumed in a fresh module (losses and params bit for bit,
    one capture, the eager step's and the capture's launches), and
    save_checkpoint's optimizer states loaded by a Module on the CPU."""
    from mxnet_tpu_torch import checkpoint as ckpt

    res = {}
    ims = images.copy()
    ims[3 * BATCH:4 * BATCH] = np.nan
    kept = {}

    def keep(param, mod):
        ex = mod._exec_group.executor
        state = ([ex.arg_dict[n].handle.clone() for n in mod._param_names]
                 + [t.clone() for s in mod._updater.states.values()
                    for t in (s[0].handle, s[1].handle)]
                 + [param.eval_metric._acc.clone()])
        if param.nbatch == 2:
            kept["before"] = state
        if param.nbatch == 3:
            kept["same"] = len(state) == len(kept["before"]) and all(
                torch.equal(a, b) for a, b in zip(state, kept["before"]))
            kept["skips"] = mx.telemetry.peek("numwatch.skipped_steps")

    guard_env = {"MXNET_TPU_NUMWATCH": "1", "MXNET_TPU_NUMWATCH_EVERY_N": "1",
                 "MXNET_TPU_NUMWATCH_GUARD": "skip"}
    os.environ.update(guard_env)
    mx.telemetry.reset()
    mx.telemetry.enable()
    try:
        mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
        run = fit_module(torch, mx, kernels, mod, ims, labels, True,
                         optimizer="adam",
                         optimizer_params=optim_params(mx, "adam"),
                         after_batch=keep)
    finally:
        for k in guard_env:
            os.environ.pop(k, None)
        mx.telemetry.disable()
        mx.telemetry.reset()
    step = run.pop("mod")._fused_step
    check(kept.get("same"), "optim (b): Adam's weights, states or metric "
          "sums moved across the NaN batch")
    check(kept.get("skips") == 1, "optim (b): skipped steps %s"
          % kept.get("skips"))
    check(step.captures == 1, "optim (b): captures %d" % step.captures)
    check(all(np.isfinite(run["losses"][4:])), "optim (b): losses %s"
          % run["losses"])
    print("optim (b) Adam skip guard: weights, both states a param and the "
          "metric sums bit-identical across the NaN batch, one skip, one "
          "capture, launches %s  [%s]" % (run["launches"], card))
    res["skip_guard"] = {"skips": 1, "launches": run["launches"]}
    del step, run, mod
    torch.cuda.empty_cache()

    env = ("MXNET_TPU_CKPT_DIR", "MXNET_TPU_CKPT_EVERY_N_STEPS",
           "MXNET_TPU_CKPT_RESUME")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_optim_")
    adam = tuple(optim_params(mx, "adam").items())
    cimages, clabels = train_data(CKPT_STEPS)
    try:
        os.environ.update({env[0]: tmp, env[1]: str(CKPT_EVERY),
                           env[2]: "0"})
        b = ckpt_fit(torch, mx, cimages, clabels, optimizer="adam",
                     optimizer_params=adam)
        del b["mod"]
        _keep_only_step(ckpt, tmp, CKPT_EVERY)
        os.environ.update({env[1]: "0", env[2]: "1"})
        kernels.reset_launch_counts()
        c = ckpt_fit(torch, mx, cimages, clabels, optimizer="adam",
                     optimizer_params=adam)
        launches = kernels.launch_counts()
        step = c["mod"]._fused_step
        counters = (step.eager_steps, step.captures, step.dispatches)
        check(c["losses"] == b["losses"][CKPT_EVERY:], "optim (b): resumed "
              "Adam losses %s, uninterrupted %s"
              % (c["losses"], b["losses"][CKPT_EVERY:]))
        _check_params_equal("optim (b) Adam resume", c, b)
        check(counters == (1, 1, CKPT_STEPS - CKPT_EVERY - 1),
              "optim (b): resumed counters %s" % (counters,))
        check(launches == dict(_resnet_launches(2), rtc=0),
              "optim (b): resumed launches %s" % launches)
        t = c["mod"]._optimizer._index_update_count
        check(set(t.values()) == {CKPT_STEPS}, "optim (b): update counts "
              "after the resume %s" % sorted(set(t.values())))
        print("optim (b) Adam snapshot at step %d resumed in a fresh module: "
              "losses %s and params bit-equal to the uninterrupted run, "
              "update counts %d, counters %s, launches %s  [%s]"
              % (CKPT_EVERY, ["%.4f" % v for v in c["losses"]], CKPT_STEPS,
                 counters, launches, card))
        res["resume"] = {"losses": c["losses"], "counters": counters,
                         "launches": launches}
        res["files"] = checkpoint_files(mx, c["mod"], tmp, "adam", adam)
    finally:
        for k in env:
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def optim_sgld(torch, mx, kernels, card, images, labels):
    """(c) SGLD through the classic loop, one step at full width: the
    standardised noise (w1 - w0 + lr/2 g)/sqrt(lr), g the rescaled
    gradient plus weight decay, over every parameter element; the fused
    step refuses SGLD."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    ex = mod._exec_group.executor
    w0 = {n: ex.arg_dict[n].handle.double() for n in mod._param_names
          if n in ex.grad_dict}
    opts = optim_params(mx, "sgld")
    run = fit_module(torch, mx, kernels, mod, images[:BATCH],
                     labels[:BATCH], False, optimizer="sgld",
                     optimizer_params=opts)
    check(run["launches"] == dict(_resnet_launches(1), rtc=0),
          "optim (c) SGLD launches %s" % run["launches"])
    check(mod._exec_group.executor is ex, "optim (c): the module bound again")
    lr = opts["learning_rate"]
    z = []
    for name, w in w0.items():
        g = ex.grad_dict[name].handle.double() * opts["rescale_grad"] \
            + opts["wd"] * w
        z.append(((ex.arg_dict[name].handle.double() - w + lr / 2 * g)
                  / np.sqrt(lr)).reshape(-1))
    z = torch.cat(z)
    mean, std = float(z.mean()), float(z.std())
    check(abs(mean) < 0.01 and abs(std - 1) < 0.01, "optim (c) SGLD noise: "
          "mean %g, std %g over %d elements" % (mean, std, z.numel()))
    raised = None
    try:
        mod.fit(mx.io.NDArrayIter(images[:BATCH], labels[:BATCH],
                                  batch_size=BATCH),
                num_epoch=1, optimizer="sgld", optimizer_params=opts,
                fused_step=True)
    except mx.MXNetError as e:
        raised = str(e)
    check(raised is not None and "SGLD" in raised, "optim (c): "
          "fit(fused_step=True) with SGLD did not raise")
    print("optim (c) SGLD, one classic step at full width: standardised "
          "noise mean %.3g, std %.5f over %d elements; fused step refused: "
          "%s  [%s]" % (mean, std, z.numel(), raised, card))
    del mod, run, z
    torch.cuda.empty_cache()
    return {"noise_mean": mean, "noise_std": std,
            "elements": sum(v.numel() for v in w0.values()),
            "fused_refused": raised}


def regression_net(mx):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=512, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=1, name="fc2")
    return mx.sym.LinearRegressionOutput(net, name="lro")


def optim_regression(torch, mx, kernels, card):
    """(d) An MLP 784-512-1 with LinearRegressionOutput, batch 128,
    through fit(fused_step=True) with eval_metric [mse, mae, rmse]: the
    metric folds inside the graph (one capture), and each value is
    within rtol 1e-6 of a float64 recomputation from the outputs."""
    rng = np.random.RandomState(0)
    x = rng.rand(REG_STEPS * REG_BATCH, 784).astype(np.float32)
    y = (x @ (rng.randn(784, 1) / 28)).astype(np.float32)
    outs = []

    def record(param):
        outs.append(param.locals["self"].get_outputs()[0].asnumpy().copy())

    metric = mx.metric.create(["mse", "mae", "rmse"])
    mod = mx.mod.Module(regression_net(mx), context=mx.gpu(0),
                        label_names=["lro_label"])
    kernels.reset_launch_counts()
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=REG_BATCH,
                              label_name="lro_label"),
            num_epoch=1, eval_metric=metric,
            initializer=mx.init.Xavier(seed=1),
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            batch_end_callback=record, fused_step=True)
    launches = kernels.launch_counts()
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(step._fold is metric, "optim (d): the metric did not fold in "
          "the step")
    check(counters == (1, 1, REG_STEPS - 1), "optim (d): counters %s"
          % (counters,))
    errs = [y[i * REG_BATCH:(i + 1) * REG_BATCH].astype(np.float64) - o
            for i, o in enumerate(outs)]
    want = [np.mean([(e ** 2).mean() for e in errs]),
            np.mean([np.abs(e).mean() for e in errs]),
            np.mean([np.sqrt((e ** 2).mean()) for e in errs])]
    got = metric.get()[1]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    check(max(rel) <= 1e-6, "optim (d): metric %s, host %s (rel %s)"
          % (got, want, rel))
    print("optim (d) regression MLP 784-512-1 batch 128, fused step: "
          "[mse, mae, rmse] folded in the graph = %s, float64 from the "
          "outputs %s (max rel %.3g, bound 1e-6), counters %s, launches %s"
          "  [%s]" % (["%.6g" % v for v in got], ["%.6g" % v for v in want],
                      max(rel), counters, launches, card))
    return {"metric": got, "host": want, "max_rel": max(rel),
            "counters": counters, "launches": launches}


def optim_imperative(torch, mx, card):
    """(e) The imperative functions on the card against the port on the
    CPU, on seeded inputs: dot, clip, norm, onehot_encode, crop_assign,
    mx.nd.Convolution, the Test optimizer's NDArray arithmetic, and
    mx.random.set_state replaying two draws."""
    rng = np.random.RandomState(3)
    a = rng.randn(256, 512).astype(np.float32)
    b = rng.randn(512, 128).astype(np.float32)
    x = rng.randn(8, 16, 28, 28).astype(np.float32)
    w = rng.randn(32, 16, 3, 3).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    idx = rng.randint(0, 10, 64).astype(np.float32)
    small = rng.randn(2, 3).astype(np.float32)

    def run(ctx):
        nd = mx.nd
        A, B = nd.array(a, ctx=ctx), nd.array(b, ctx=ctx)
        out = {"dot": nd.dot(A, B), "clip": nd.clip(A, -0.5, 0.7),
               "norm": nd.norm(A),
               "onehot_encode": nd.onehot_encode(
                   nd.array(idx, ctx=ctx), nd.zeros((64, 10), ctx=ctx)),
               "crop_assign": nd.crop_assign(A, nd.array(small, ctx=ctx),
                                             (5, 7), (7, 10)),
               "Convolution": nd.Convolution(
                   nd.array(x, ctx=ctx), nd.array(w, ctx=ctx),
                   nd.array(bias, ctx=ctx), kernel=(3, 3), num_filter=32,
                   pad=(1, 1))}
        opt = mx.optimizer.create("test", rescale_grad=0.5)
        upd = mx.optimizer.get_updater(opt)
        wt = nd.array(a, ctx=ctx)
        for k in range(3):
            upd(0, nd.array(a * (k + 1), ctx=ctx), wt)
        out["test_optimizer"] = wt
        out["test_optimizer_state"] = upd.states[0]
        return {k: v.asnumpy() for k, v in out.items()}

    card_out, cpu_out = run(mx.gpu(0)), run(mx.cpu())
    rel = {}
    for k, want in cpu_out.items():
        got = card_out[k]
        rel[k] = float(np.abs(got.astype(np.float64) - want).max()
                       / max(np.abs(want).max(), 1e-30))
        exact = k in ("clip", "onehot_encode", "crop_assign",
                      "test_optimizer", "test_optimizer_state")
        check(rel[k] == 0 if exact else rel[k] <= 1e-5, "optim (e): %s on "
              "the card differs from the CPU by %.3g of its largest "
              "magnitude" % (k, rel[k]))
    mx.random.seed(21)
    mx.random.uniform(shape=(1000,), ctx=mx.gpu(0))
    state = mx.random.get_state()
    first = [mx.random.normal(shape=(4096,), ctx=mx.gpu(0)).asnumpy(),
             mx.random.uniform(shape=(4096,), ctx=mx.gpu(0)).asnumpy()]
    mx.random.set_state(state)
    again = [mx.random.normal(shape=(4096,), ctx=mx.gpu(0)).asnumpy(),
             mx.random.uniform(shape=(4096,), ctx=mx.gpu(0)).asnumpy()]
    check(all(np.array_equal(p, q) for p, q in zip(first, again))
          and not np.array_equal(first[0], first[1]),
          "optim (e): set_state did not replay the card's draws")
    print("optim (e) imperative functions on the card against the CPU "
          "(max difference over the largest magnitude): %s; set_state "
          "replayed two draws on the card exactly  [%s]"
          % (json.dumps({k: float("%.3g" % v) for k, v in rel.items()}),
             card))
    return {"rel_diff": rel, "set_state_replay": True}


def optim_main_path(torch, mx, kernels, card, images, labels):
    """Phase 11: (a) each fusable optimizer, classic loop then fused step,
    (b) Adam under the guards, (c) SGLD, (d) a regression head, (e) the
    imperative functions."""
    kinds = {}
    for kind in OPTIM_KINDS:
        kinds[kind] = optim_kind_path(torch, mx, kernels, card, kind,
                                      images, labels)
    return {"kinds": kinds,
            "adam_guards": optim_adam_guards(torch, mx, kernels, card,
                                             images, labels),
            "sgld": optim_sgld(torch, mx, kernels, card, images, labels),
            "regression": optim_regression(torch, mx, kernels, card),
            "imperative": optim_imperative(torch, mx, card)}


# ---------------------------------------------------------------------------
# phase 12: the bucketed LSTM language model, the fused RNN and the slice's
# ops on the card
# ---------------------------------------------------------------------------
LM_LAYERS = 2                  # the upstream example's model (lstm_bucketing.py)
LM_HIDDEN = 200
LM_EMBED = 200
LM_VOCAB = 10000               # a PTB-sized vocabulary
LM_BATCH = 32
LM_BUCKETS = (10, 20, 30, 40, 50, 60)
LM_BATCHES_PER_BUCKET = 3      # the first of each binds the bucket's module
LM_OPT = (("learning_rate", 0.01), ("momentum", 0.0), ("wd", 1e-5))
LM_FUSED_SEQ = 60
LM_FUSED_STEPS = 5
LM_INIT = ["l%d_init_%s" % (i, k) for i in range(LM_LAYERS) for k in "ch"]
LM_GATE_OUT = 2e-5             # card vs CPU, bucket 10: outputs, normwise
LM_GATE_UPDATE = 1e-3          # ... and the update (params after - before)
OP_RTOL, OP_ATOL = 1e-5, 1e-6  # 12c: card vs CPU, f32
OP_RTOL_SUM, OP_ATOL_SUM = 1e-4, 1e-5   # ops that sum in another order
RNN_SWEEP = (20, 8, 32, 64)    # T, N, in, H of the cuDNN-vs-loop sweep


def lm_sentences(seed=0):
    """LM_BATCHES_PER_BUCKET batches of LM_BATCH sentences for every
    bucket, lengths uniform over (previous bucket, bucket], tokens 1 ..
    LM_VOCAB - 1 padded with 0; the next token is the label. Returns
    [(bucket, ids, labels)] in a seeded order."""
    rng = np.random.RandomState(seed)
    plan, prev = [], 0
    for bucket in LM_BUCKETS:
        for _ in range(LM_BATCHES_PER_BUCKET):
            ids = np.zeros((LM_BATCH, bucket), np.float32)
            for row in ids:
                n = rng.randint(prev + 1, bucket + 1)
                row[:n] = rng.randint(1, LM_VOCAB, n)
            labels = np.zeros_like(ids)
            labels[:, :-1] = ids[:, 1:]
            plan.append((bucket, ids, labels))
        prev = bucket
    order = rng.permutation(len(plan))
    return [plan[i] for i in order]


def lm_sym_gen(mx):
    def sym_gen(seq_len):
        net = mx.models.lstm_unroll(LM_LAYERS, seq_len, LM_VOCAB, LM_HIDDEN,
                                    LM_EMBED, LM_VOCAB)
        return net, tuple(["data"] + LM_INIT), ("softmax_label",)
    return sym_gen


def lm_batch(mx, ctx, bucket, ids, labels):
    """A bucket's DataBatch with its arrays on ``ctx`` and the initial
    states as zero data."""
    data = [mx.nd.array(ids, ctx=ctx)] + [
        mx.nd.zeros((LM_BATCH, LM_HIDDEN), ctx=ctx) for _ in LM_INIT]
    return mx.io.DataBatch(
        data, [mx.nd.array(labels, ctx=ctx)], bucket_key=bucket,
        provide_data=[mx.io.DataDesc("data", (LM_BATCH, bucket))] + [
            mx.io.DataDesc(n, (LM_BATCH, LM_HIDDEN)) for n in LM_INIT],
        provide_label=[mx.io.DataDesc("softmax_label", (LM_BATCH, bucket))])


class LMBatches:
    """The sentences' batches, already on the card, as a DataIter whose
    provide_data is the default (largest) bucket's."""

    def __init__(self, mx, batches):
        self._batches = batches
        self._mx = mx
        self.batch_size = LM_BATCH
        self._cur = 0

    @property
    def provide_data(self):
        return [self._mx.io.DataDesc("data", (LM_BATCH, LM_BUCKETS[-1]))] + [
            self._mx.io.DataDesc(n, (LM_BATCH, LM_HIDDEN)) for n in LM_INIT]

    @property
    def provide_label(self):
        return [self._mx.io.DataDesc("softmax_label",
                                     (LM_BATCH, LM_BUCKETS[-1]))]

    def reset(self):
        self._cur = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._cur >= len(self._batches):
            raise StopIteration
        self._cur += 1
        return self._batches[self._cur - 1]

    next = __next__


def _lm_loss(torch, probs, labels):
    """Mean cross-entropy of (T*N, V) probabilities against (N, T) labels,
    taken time-major as the graph takes them; a device scalar."""
    lab = labels.t().reshape(-1).to(torch.int64)
    return -torch.log(probs.gather(1, lab[:, None])).mean()


def _lm_group(name):
    low = name.lower()
    if "gemm" in low or "cutlass" in low or "sm90_xmma" in low:
        return "matmul (cuBLAS)"
    if "rnn" in low or "lstm" in low or "persist" in low:
        return "RNN (cuDNN)"
    if "embedding" in low:
        return "embedding"
    if "softmax" in low:
        return "softmax"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "optimizer (foreach SGD)"
    if "reduce" in low:
        return "reductions"
    if "copy" in low or "cat" in low or "gather" in low \
            or "index" in low:
        return "copies and gathers"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def lm_gate(torch, mx, params, bucket, ids, labels):
    """One batch of ``bucket`` through lstm_unroll from ``params`` with
    phase 12's SGD, on the card and on the CPU: outputs and the update
    (params after minus before) normwise."""
    runs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        sym, data_names, label_names = lm_sym_gen(mx)(bucket)
        mod = mx.mod.Module(sym, data_names, label_names, context=ctx)
        batch = lm_batch(mx, ctx, bucket, ids, labels)
        mod.bind(batch.provide_data, batch.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=LM_OPT)
        mod.forward_backward(batch)
        mod.update()
        runs.append((mod.get_outputs()[0].asnumpy().copy(),
                     _host(mod.get_params()[0])))
    return dict(_lstm_gate("12a: bucket %d" % bucket, runs, params),
                bucket=bucket)


def _lstm_gate(what, runs, params):
    """An LSTM's card-against-CPU step from ``runs`` ((outputs, params
    after) on the card, then on the CPU) and the params before: the
    outputs and each param's update normwise, within LM_GATE_OUT and
    LM_GATE_UPDATE (no ReLU or max to tip: the sides differ by
    rounding)."""
    (out_c, p_c), (out_h, p_h) = runs
    out_err = float(np.linalg.norm(out_c.astype(np.float64) - out_h)
                    / np.linalg.norm(out_h))
    upd_err = {k: float(np.linalg.norm((p_c[k] - params[k]).astype(
        np.float64) - (p_h[k] - params[k])) / max(np.linalg.norm(
            p_h[k] - params[k]), 1e-30)) for k in params}
    worst = max(upd_err.values())
    check(out_err <= LM_GATE_OUT and worst <= LM_GATE_UPDATE,
          "%s on the card against the CPU: outputs %.3g (bound %g), worst "
          "update %.3g (bound %g) %s" % (what, out_err, LM_GATE_OUT, worst,
                                         LM_GATE_UPDATE, upd_err))
    return {"outputs_normwise": out_err, "update_normwise_worst": worst,
            "bounds": [LM_GATE_OUT, LM_GATE_UPDATE]}


def lm_bucketing_path(torch, mx, kernels, card):
    """12a: BucketingModule over lstm_unroll through fit's classic loop,
    every bucket's batches on the card before the fit."""
    plan = lm_sentences()
    batches = [lm_batch(mx, mx.gpu(0), b, ids, lab) for b, ids, lab in plan]
    mod = mx.mod.BucketingModule(lm_sym_gen(mx),
                                 default_bucket_key=LM_BUCKETS[-1],
                                 context=mx.gpu(0))
    it = LMBatches(mx, batches)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34,
                                   seed=0))
    params0 = _host(mod.get_params()[0])
    losses, marks = [], []

    def on_batch(param):
        batch = param.locals["data_batch"]
        losses.append(_lm_loss(torch, mod.get_outputs()[0].handle,
                               batch.label[0].handle))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=LM_OPT,
            eval_metric=mx.metric.Accuracy(), batch_end_callback=on_batch)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    params1 = _host(mod.get_params()[0])
    check(sorted(mod._buckets) == list(LM_BUCKETS),
          "12a: bucket modules %s" % sorted(mod._buckets))
    owner = mod._buckets[LM_BUCKETS[-1]]._exec_group.executor
    for b, m in mod._buckets.items():
        ex = m._exec_group.executor
        alien = [n for n in params0
                 if ex.arg_dict[n].handle.data_ptr()
                 != owner.arg_dict[n].handle.data_ptr()]
        check(not alien, "12a: bucket %d holds its own %s" % (b, alien))
    check(len(losses) == len(plan) and all(np.isfinite(losses)),
          "12a: losses %s" % losses)
    same = [k for k in params0 if np.array_equal(params0[k], params1[k])]
    check(not same, "12a: params unchanged by training: %s" % same)
    check(launches == dict.fromkeys(launches, 0),
          "12a: compiled kernels launched on the LSTM path: %s" % launches)
    # host step ms by bucket: the steps after each bucket's first (which
    # binds the bucket's module)
    steps = [(plan[i][0], 1e3 * (marks[i] - (marks[i - 1] if i
                                             else t_start)))
             for i in range(len(plan))]
    first_ms, by_bucket = {}, {}
    for b, ms in steps:
        if b in first_ms:
            by_bucket.setdefault(b, []).append(ms)
        else:
            first_ms[b] = ms
    step_ms = {b: float(np.median(v)) for b, v in sorted(by_bucket.items())}
    tokens = sum(LM_BATCH * b * len(v) for b, v in by_bucket.items())
    tok_s = tokens / (sum(sum(v) for v in by_bucket.values()) / 1e3)
    # two steps of the largest bucket under the profiler
    top = next(bt for bt in batches if bt.bucket_key == LM_BUCKETS[-1])

    def step_top():
        mod.forward_backward(top)
        mod.update()

    step_top()
    torch.cuda.synchronize()
    breakdown = _profile_steps(torch, kernels, step_top, 2, _lm_group)
    gate = lm_gate(torch, mx, params0, *next(p for p in plan
                                             if p[0] == LM_BUCKETS[0]))
    print("phase 12a bucketed LSTM LM (lstm_unroll, %dx%d, embed %d, vocab "
          "%d, batch %d, buckets %s, %d batches, classic loop): %d bucket "
          "modules over one set of %d parameter tensors; losses %.4f -> "
          "%.4f; host step ms by bucket (median after the binding step) %s; "
          "%.1f tokens/s; peak allocated %.3f GB; launches %s  [%s]"
          % (LM_LAYERS, LM_HIDDEN, LM_EMBED, LM_VOCAB, LM_BATCH,
             list(LM_BUCKETS), len(plan), len(mod._buckets), len(params0),
             losses[0], losses[-1],
             json.dumps({b: round(v, 3) for b, v in step_ms.items()}),
             tok_s, peak / 1e9, launches, card))
    print("phase 12a bucket %d, two profiled steps: %.3f ms of kernels a "
          "step (%.3f ms with overlaps counted once), busy %.1f%%, %.3f ms "
          "a step on the host clock; groups %s"
          % (LM_BUCKETS[-1], breakdown["device_ms_per_step"],
             breakdown["device_union_ms_per_step"],
             100 * breakdown["busy_union_share"],
             breakdown["profiled_wall_ms_per_step"],
             json.dumps({g: round(v, 3) for g, v in sorted(
                 breakdown["by_group_ms"].items(), key=lambda kv: -kv[1])})))
    print("phase 12a card vs CPU, one bucket-%d batch from the same "
          "weights: outputs %.3g (bound %g), worst update %.3g (bound %g), "
          "normwise" % (gate["bucket"], gate["outputs_normwise"], LM_GATE_OUT,
                        gate["update_normwise_worst"], LM_GATE_UPDATE))
    return {"launches": launches, "losses": losses,
            "step_ms_by_bucket": step_ms, "first_step_ms": first_ms,
            "tokens_per_s": tok_s, "peak_bytes": peak,
            "peak_above_start_bytes": peak - base,
            "breakdown_top_bucket": breakdown, "gate": gate,
            "buckets": sorted(mod._buckets), "params": len(params0)}


def lm_fused_module(mx, params=None):
    sym = mx.models.lstm_fused(LM_LAYERS, LM_FUSED_SEQ, LM_VOCAB, LM_HIDDEN,
                               LM_EMBED, LM_VOCAB)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind([("data", (LM_BATCH, LM_FUSED_SEQ))],
             [("softmax_label", (LM_BATCH, LM_FUSED_SEQ))])
    if params is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34,
                                       seed=0))
    else:
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
    return mod


def lm_fused_fit(torch, mx, kernels, mod, ids, labels, fused):
    """fit over ``ids``/``labels`` in batches of 32 on the card, the
    classic loop or the fused step; per step the loss from the outputs
    (labels already on the card) and the host clock with the card
    synchronised."""
    metric = mx.metric.Accuracy()
    losses, marks = [], []
    labels_dev = torch.from_numpy(labels).cuda()

    def on_batch(param):
        lab = labels_dev[param.nbatch * LM_BATCH:
                         (param.nbatch + 1) * LM_BATCH]
        losses.append(_lm_loss(torch, mod.get_outputs()[0].handle, lab))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    it = mx.io.NDArrayIter(ids, labels, batch_size=LM_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=LM_OPT,
            eval_metric=metric, batch_end_callback=on_batch,
            fused_step=fused)
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = float(np.median(steps_ms))
    return {"launches": kernels.launch_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "losses": [float(v) for v in losses], "steps_ms": steps_ms,
            "step_ms": step_ms,
            "tokens_per_s": LM_BATCH * LM_FUSED_SEQ * 1e3 / step_ms,
            "accuracy": metric.get()[1], "metric": metric,
            "params": _host(mod.get_params()[0])}


def lm_fused_path(torch, mx, kernels, card):
    """12b: lstm_fused (the RNN op, mode lstm, cuDNN) at seq 60 through
    the classic loop, then fit(fused_step=True) from the same weights."""
    rng = np.random.RandomState(1)
    n = LM_FUSED_STEPS * LM_BATCH
    ids = rng.randint(1, LM_VOCAB, (n, LM_FUSED_SEQ)).astype(np.float32)
    labels = np.zeros_like(ids)
    labels[:, :-1] = ids[:, 1:]
    mod = lm_fused_module(mx)
    params0 = _host(mod.get_params()[0])
    classic = lm_fused_fit(torch, mx, kernels, mod, ids, labels, False)
    fmod = lm_fused_module(mx, params0)
    fused = lm_fused_fit(torch, mx, kernels, fmod, ids, labels, True)
    step = fmod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(counters == (1, 1, LM_FUSED_STEPS - 1),
          "12b: fused counters (eager, captures, replays) %s" % (counters,))
    check(classic["losses"] == fused["losses"],
          "12b: losses classic %s, fused %s" % (classic["losses"],
                                               fused["losses"]))
    diff = [k for k in params0
            if not np.array_equal(classic["params"][k], fused["params"][k])]
    check(not diff, "12b: params differ from the classic loop: %s" % diff)
    check(classic["accuracy"] == fused["accuracy"],
          "12b: metric classic %r, fused %r" % (classic["accuracy"],
                                                fused["accuracy"]))
    check(all(np.isfinite(classic["losses"])), "12b: losses %s"
          % classic["losses"])
    for run in (classic, fused):
        check(run["launches"] == dict.fromkeys(run["launches"], 0),
              "12b: compiled kernels launched: %s" % run["launches"])
    breakdown = fused_breakdown(
        torch, mx, kernels, step, fused["metric"],
        mx.nd.array(ids[:LM_BATCH], ctx=mx.cpu()),
        mx.nd.array(labels[:LM_BATCH], ctx=mx.cpu()), group=_lm_group)
    print("phase 12b fused RNN LM (lstm_fused, RNN mode lstm on cuDNN, seq "
          "%d, batch %d): classic / fused host step %.3f / %.3f ms, %.1f / "
          "%.1f tokens/s, peak allocated %.3f / %.3f GB; one capture "
          "(eager, captures, replays) %s; params, losses and metric "
          "bit-equal; fused replay: %.3f ms of kernels (%.3f ms with "
          "overlaps counted once; CUDA events %.3f), busy %.1f%%; groups "
          "%s  [%s]"
          % (LM_FUSED_SEQ, LM_BATCH, classic["step_ms"], fused["step_ms"],
             classic["tokens_per_s"], fused["tokens_per_s"],
             classic["peak_bytes"] / 1e9, fused["peak_bytes"] / 1e9,
             counters, breakdown["device_ms_per_step"],
             breakdown["device_union_ms_per_step"],
             breakdown["event_ms_per_step"],
             100 * breakdown["busy_union_share"],
             json.dumps({g: round(v, 3) for g, v in sorted(
                 breakdown["by_group_ms"].items(),
                 key=lambda kv: -kv[1])}), card))
    for run in (classic, fused):
        del run["metric"], run["params"]
    return {"classic": classic, "fused": fused, "counters": counters,
            "replay": breakdown}


def _op_cases(mx):
    """12c's sweep: (label, build(sym), {arg: numpy}, grad args, bounds)
    for every op the slice registers, at small seeded shapes."""
    rng = np.random.RandomState(12)
    sym = mx.sym

    def x(*shape, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    v = sym.Variable
    f32 = (OP_RTOL, OP_ATOL)
    summed = (OP_RTOL_SUM, OP_ATOL_SUM)
    cases = []

    def one(label, op, args=None, bounds=f32, **params):
        data = args if args is not None else {"data": x(4, 6, 5)}
        cases.append((label, lambda: getattr(sym, op)(v("data"), **params),
                      data, ["data"], bounds))

    for op in ("exp", "sin", "cos", "square", "abs", "negative", "sign",
               "round", "ceil", "floor"):
        one(op, op)
    for op in ("log", "sqrt", "rsqrt"):
        one(op, op, {"data": x(4, 6, 5, lo=0.5, hi=2.0)})
    one("clip", "clip", a_min=-0.5, a_max=0.7)
    one("argmax_channel", "argmax_channel")
    one("smooth_l1", "smooth_l1", scalar=2.0)
    for op in ("sum", "max", "min"):
        one(op, op, axis=(1,), bounds=summed if op == "sum" else f32)
        one(op + "_axis", op + "_axis", keepdims=True,
            bounds=summed if op == "sum" else f32)
    one("broadcast_axis", "broadcast_axis", {"data": x(1, 6, 1)},
        axis=(0, 2), size=(4, 5))
    one("Reshape", "Reshape", shape=(0, -1))
    one("Reshape_target_shape", "Reshape", target_shape=(-1,))
    one("Cast", "Cast", dtype="float64")
    one("transpose", "transpose", axes=(2, 0, 1))
    one("SwapAxis", "SwapAxis", dim1=0, dim2=1)
    one("expand_dims", "expand_dims", axis=1)
    one("SliceChannel", "SliceChannel", num_outputs=3, axis=1,
        squeeze_axis=False)
    one("SliceChannel_squeeze", "SliceChannel", num_outputs=5, axis=2,
        squeeze_axis=True)
    one("Crop", "Crop", {"data": x(2, 3, 6, 6)}, h_w=(3, 4), offset=(1, 1))
    one("crop", "crop", begin=(1, 0, 1), end=(3, 4, 5))
    one("_crop_assign_scalar", "_crop_assign_scalar", scalar=3.0,
        begin=(0, 1, 1), end=(2, 3, 4))
    one("_CrossDeviceCopy", "_CrossDeviceCopy")
    one("slice_axis", "slice_axis", axis=2, begin=1, end=4)
    one("Flip", "Flip", axis=1)
    one("BlockGrad", "BlockGrad")
    one("MakeLoss", "MakeLoss", grad_scale=0.5)
    one("IdentityAttachKLSparseReg", "IdentityAttachKLSparseReg",
        {"data": x(4, 6, 5, lo=0.05, hi=0.6)}, penalty=0.01)
    for act in ("leaky", "elu"):
        one("LeakyReLU_" + act, "LeakyReLU", act_type=act, slope=0.2)
    one("SoftmaxActivation", "SoftmaxActivation")
    one("SoftmaxActivation_channel", "SoftmaxActivation", mode="channel")
    for mode in ("instance", "channel", "spatial"):
        one("L2Normalization_" + mode, "L2Normalization",
            {"data": x(2, 3, 4, 4)}, mode=mode)
    one("UpSampling", "UpSampling", {"data": x(2, 3, 4, 4)}, scale=2,
        num_args=1)
    for op in ("SequenceLast", "SequenceMask", "SequenceReverse"):
        one(op, op, {"data": x(7, 4, 5)})
        cases.append((op + "_lengths", lambda op=op: getattr(sym, op)(
            v("data"), v("len"), use_sequence_length=True),
            {"data": x(7, 4, 5), "len": np.array([3, 7, 1, 5], np.float32)},
            ["data"], f32))

    def two(label, op, lhs, rhs, bounds=f32, **params):
        cases.append((label, lambda: getattr(sym, op)(v("lhs"), v("rhs"),
                                                     **params),
                      {"lhs": lhs, "rhs": rhs}, ["lhs", "rhs"], bounds))

    for op in ("broadcast_plus", "broadcast_minus", "broadcast_mul"):
        two(op, op, x(4, 1, 5), x(1, 6, 5))
    two("broadcast_div", "broadcast_div", x(4, 6, 5), x(4, 1, 1, lo=0.5,
                                                         hi=2.0))
    two("broadcast_power", "broadcast_power", x(4, 6, 1, lo=0.5, hi=2.0),
        x(1, 6, 5))
    two("element_mask", "element_mask", x(4, 6, 5),
        np.array([1, 0, 1, 1], np.float32))
    two("_crop_assign", "_crop_assign", x(4, 6, 5), x(2, 3, 2),
        begin=(1, 2, 0), end=(3, 5, 2))
    two("dot", "dot", x(64, 96), x(96, 48), summed)
    two("dot_transpose", "dot", x(96, 64), x(48, 96), summed,
        transpose_a=True, transpose_b=True)
    two("batch_dot", "batch_dot", x(4, 32, 24), x(4, 24, 16), summed)
    cases.append(("LeakyReLU_prelu", lambda: sym.LeakyReLU(
        v("data"), v("gamma"), act_type="prelu"),
        {"data": x(2, 3, 4, 4), "gamma": x(3, lo=0.1, hi=0.4)},
        ["data", "gamma"], f32))
    cases.append(("Deconvolution", lambda: sym.Deconvolution(
        v("data"), v("w"), v("b"), kernel=(3, 3), num_filter=8,
        stride=(2, 2), pad=(1, 1), num_group=2),
        {"data": x(2, 4, 7, 7), "w": x(4, 4, 3, 3) * 0.3, "b": x(8)},
        ["data", "w", "b"], summed))
    cases.append(("Deconvolution_nhwc", lambda: sym.Deconvolution(
        v("data"), v("w"), kernel=(2, 2), num_filter=6, stride=(2, 2),
        no_bias=True, layout="NHWC"),
        {"data": x(2, 5, 5, 4), "w": x(4, 6, 2, 2) * 0.3},
        ["data", "w"], summed))
    cases.append(("SVMOutput", lambda: sym.SVMOutput(
        v("data"), v("label"), margin=1.0, regularization_coefficient=0.5),
        {"data": x(8, 5), "label": rng.randint(0, 5, 8).astype(np.float32)},
        ["data"], f32))
    cases.append(("Embedding", lambda: sym.Embedding(
        v("data"), v("w"), input_dim=50, output_dim=16),
        {"data": np.array([[0, 7, 49, -1], [50, 3, 3, -51]], np.float32),
         "w": x(50, 16)}, ["w"], f32))
    return cases


def _run_op(mx, build, args, grads, ctx, heads_seed=17):
    """A train forward and a backward with seeded head gradients of one
    op on ``ctx``; aux states start at 0.3. (outputs, grads) as float64
    numpy."""
    net = build()
    arrays = {k: mx.nd.array(a, ctx=ctx, dtype=a.dtype)
              for k, a in args.items()}
    gr = {k: mx.nd.zeros(args[k].shape, ctx=ctx) for k in grads}
    _, _, aux_shapes = net.infer_shape(**{k: a.shape
                                          for k, a in args.items()})
    ex = net.bind(ctx, arrays, args_grad=gr,
                  grad_req={k: "write" if k in grads else "null"
                            for k in args},
                  aux_states=[mx.nd.full(s, 0.3, ctx=ctx)
                              for s in aux_shapes])
    outs = ex.forward(is_train=True)
    hrng = np.random.RandomState(heads_seed)
    ex.backward([mx.nd.array(hrng.randn(*o.shape).astype(np.float32),
                             ctx=ctx) for o in outs])
    return ([o.asnumpy().astype(np.float64) for o in outs],
            {k: g.asnumpy().astype(np.float64) for k, g in gr.items()})


def _close(a, b, rtol, atol):
    """max |a - b| - (atol + rtol |b|), over finite elements; NaN where
    NaN in both. <= 0 passes."""
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if not np.array_equal(nan_a, nan_b):
        return float("inf")
    ok = ~nan_b
    if not ok.any():
        return -1.0
    return float(np.max(np.abs(a[ok] - b[ok]) - atol - rtol * np.abs(b[ok])))


def lm_op_sweep(torch, mx, card):
    """12c: every op of the slice forward and backward on the card against
    the port on the CPU; the RNN in four modes, bidirectional, 2 layers,
    on cuDNN against the plain per-step loop on the card, with cuDNN's
    backward rerun bit-identically; Embedding's out-of-range ids without
    a device assert; rrelu's draw on the card by distribution."""
    from mxnet_tpu_torch.ops.seq import rnn_param_size, rnn_plain

    worst, failed, n = {}, [], 0
    for label, build, args, grads, (rtol, atol) in _op_cases(mx):
        card_out, card_g = _run_op(mx, build, args, grads, mx.gpu(0))
        cpu_out, cpu_g = _run_op(mx, build, args, grads, mx.cpu())
        margin = max([_close(a, b, rtol, atol)
                      for a, b in zip(card_out, cpu_out)]
                     + [_close(card_g[k], cpu_g[k], 10 * rtol, atol)
                        for k in grads])
        worst[label] = margin
        n += 1
        if margin > 0:
            failed.append(label)
    check(not failed, "12c: ops outside their bounds on the card: %s"
          % {k: worst[k] for k in failed})
    emb = next(c for c in _op_cases(mx) if c[0] == "Embedding")
    nan_rows = np.isnan(_run_op(mx, emb[1], emb[2], emb[3],
                                mx.gpu(0))[0][0]).all(axis=-1)
    check(nan_rows.tolist() == [[False] * 4, [True, False, False, True]],
          "12c: Embedding's out-of-range rows on the card: %s" % nan_rows)
    torch.cuda.synchronize()

    t_len, batch, inp, hid = RNN_SWEEP
    rnn_worst, reruns = {}, True
    gen = torch.Generator().manual_seed(3)
    for mode in ("rnn_relu", "rnn_tanh", "lstm", "gru"):
        for bi in (False, True):
            dirs = 2 if bi else 1
            size = rnn_param_size(2, inp, hid, bi, mode)
            host = [torch.randn(t_len, batch, inp, generator=gen),
                    torch.randn(size, generator=gen) * 0.1,
                    torch.randn(2 * dirs, batch, hid, generator=gen),
                    torch.randn(2 * dirs, batch, hid, generator=gen)]
            op = mx.ops.seq.RNN(state_size=hid, num_layers=2, mode=mode,
                                bidirectional=bi, state_outputs=True)
            octx = mx.ops.OpContext(True, None)

            def grads_of(fn):
                leaves = [t.cuda().requires_grad_() for t in host]
                outs = fn(leaves)
                hrng = torch.Generator(device="cuda").manual_seed(5)
                heads = [torch.randn(o.shape, generator=hrng,
                                     device="cuda") for o in outs]
                torch.autograd.backward(outs, heads)
                return ([o.detach() for o in outs],
                        [t.grad if t.grad is not None
                         else torch.zeros_like(t) for t in leaves])

            def cudnn(ls):
                return op.apply(octx, ls[:4] if mode == "lstm" else ls[:3],
                                [])[0]

            def plain(ls):
                out, h, c = rnn_plain(ls[0], ls[1], ls[2],
                                      ls[3] if mode == "lstm" else None,
                                      mode, 2, hid, bi)
                return [out, h] + ([c] if mode == "lstm" else [])

            a_out, a_g = grads_of(cudnn)
            b_out, b_g = grads_of(cudnn)
            reruns &= all(torch.equal(p, q) for p, q in
                          zip(a_out + a_g, b_out + b_g))
            p_out, p_g = grads_of(plain)
            used = 4 if mode == "lstm" else 3
            rel = max(float((p - q).abs().max() / q.abs().max())
                      for p, q in zip(a_out + a_g[:used],
                                      p_out + p_g[:used]))
            rnn_worst["%s%s" % (mode, "_bi" if bi else "")] = rel
    check(max(rnn_worst.values()) <= OP_RTOL_SUM,
          "12c: cuDNN RNN against the per-step loop on the card: %s (bound "
          "%g of each tensor's largest magnitude)" % (rnn_worst, OP_RTOL_SUM))
    check(reruns, "12c: cuDNN's RNN forward/backward reruns differ")
    lrelu = mx.sym.LeakyReLU(mx.sym.Variable("data"), act_type="rrelu",
                             lower_bound=0.1, upper_bound=0.3)
    ex = mx.executor.Executor(lrelu, mx.gpu(0), [mx.nd.array(
        -np.ones((256, 256), np.float32), ctx=mx.gpu(0))], seed=4)
    slope = -ex.forward(is_train=True)[0].asnumpy()
    check(slope.min() >= 0.1 and slope.max() <= 0.3
          and abs(slope.mean() - 0.2) < 2e-3
          and abs(slope.std() - 0.2 / 12 ** 0.5) < 2e-3,
          "12c: rrelu slopes on the card: min %g max %g mean %g std %g"
          % (slope.min(), slope.max(), slope.mean(), slope.std()))
    print("phase 12c op sweep on the card against the CPU: %d cases, "
          "forward and backward, within rtol %g / atol %g (dot, "
          "batch_dot, Deconvolution, sum: %g / %g; gradients 10x rtol); "
          "worst margin %.3g (<= 0 passes); Embedding's ids 50 and -51 "
          "give NaN rows and -1 the last row, as on the CPU; cuDNN RNN (4 modes x 1-2 directions, 2 layers, T %d N "
          "%d in %d H %d) against the per-step loop on the card: worst %.3g "
          "of the largest magnitude (bound %g), reruns bit-identical; rrelu "
          "slopes mean %.5f std %.5f  [%s]"
          % (n, OP_RTOL, OP_ATOL, OP_RTOL_SUM, OP_ATOL_SUM, max(worst.values()), t_len,
             batch, inp, hid, max(rnn_worst.values()), OP_RTOL_SUM,
             slope.mean(), slope.std(), card))
    return {"cases": n, "worst_margin": worst, "rnn_rel": rnn_worst,
            "rnn_reruns_bit_identical": reruns,
            "rrelu": [float(slope.mean()), float(slope.std())]}


def lm_main_path(torch, mx, kernels, card):
    """Phase 12: 12a bucketed training, 12b the fused RNN through the
    fused step, 12c the op sweep."""
    return {"bucketing": lm_bucketing_path(torch, mx, kernels, card),
            "fused": lm_fused_path(torch, mx, kernels, card),
            "ops": lm_op_sweep(torch, mx, card)}


# ---------------------------------------------------------------------------
# phase 13: Fast R-CNN on VGG-16 and LSTM-OCR with WarpCTC at full width,
# the vision and CTC ops on the card, the executor surface
# ---------------------------------------------------------------------------
RCNN_IMAGES = 2                # images a batch (Fast R-CNN's IMS_PER_BATCH)
RCNN_HW = (600, 1000)          # the shorter side 600, the longer 1000
RCNN_ROIS = 128                # rois a batch, 64 an image
RCNN_FG = 0.25                 # foreground fraction of the rois
RCNN_PROPOSALS = 2000          # proposals an image
RCNN_GT = 4                    # ground-truth boxes an image
RCNN_CLASSES = 21              # PASCAL VOC's 20 classes and background
RCNN_STDS = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
RCNN_STEPS = 5
RCNN_CUSTOM_STEPS = 3
RCNN_OPT = (("learning_rate", 0.001), ("momentum", 0.9), ("wd", 5e-4))
# conv1_x and conv2_x stay fixed, as Fast R-CNN trains VGG-16
RCNN_FIXED = ["conv%d_%d_%s" % (s, i, k) for s in (1, 2) for i in (1, 2)
              for k in ("weight", "bias")]
# K3 a step: a weight gradient for conv3_1..conv5_3 (9) and an input
# gradient for conv3_2..conv5_3 (8: conv3_1's input needs none)
RCNN_K3_STEP = 17
RCNN_DATA = ["data", "rois"]
RCNN_LABELS = ["label", "bbox_target", "bbox_weight"]
RCNN_GATE_EVERY = 8            # the gate's rois: every 8th, 16 of the 128
OCR_T, OCR_FEAT, OCR_HIDDEN, OCR_LAYERS = 80, 30, 100, 2
OCR_BATCH, OCR_LABEL, OCR_CLASSES, OCR_STEPS = 32, 4, 11, 5
# upstream lstm_ocr's SGD (lr 0.001, momentum 0.9, wd 1e-5) with the
# repository's warpctc example's clip
OCR_OPT = (("learning_rate", 0.001), ("momentum", 0.9), ("wd", 1e-5),
           ("clip_gradient", 1.0), ("rescale_grad", 1.0 / OCR_BATCH))
OCR_INIT = ["l%d_init_%s" % (i, k) for i in range(OCR_LAYERS) for k in "hc"]


def vgg16_fast_rcnn(mx, inputs=None):
    """Fast R-CNN over VGG-16 as a user builds it (upstream example/rcnn):
    get_vgg(16)'s conv1_1..conv5_3 and pools 1-4, pool5 replaced by
    ROIPooling(7x7, 1/16), fc6 and fc7 (4096, ReLU, Dropout 0.5),
    cls_score into SoftmaxOutput, bbox_pred into smooth_l1 of the
    weighted difference into MakeLoss(1/128). Returns the two heads.
    ``inputs`` gives symbols for rois, label, bbox_target and
    bbox_weight (default: variables of those names)."""
    s = mx.sym
    inp = {n: s.Variable(n) for n in ["rois"] + RCNN_LABELS}
    inp.update(inputs or {})
    net = s.Variable("data")
    for stage, (reps, nf) in enumerate(zip((2, 2, 3, 3, 3),
                                           (64, 128, 256, 512, 512))):
        for i in range(reps):
            net = s.Activation(data=s.Convolution(
                data=net, num_filter=nf, kernel=(3, 3), pad=(1, 1),
                name="conv%d_%d" % (stage + 1, i + 1)), act_type="relu",
                name="relu%d_%d" % (stage + 1, i + 1))
        if stage < 4:
            net = s.Pooling(data=net, kernel=(2, 2), stride=(2, 2),
                            pool_type="max", name="pool%d" % (stage + 1))
    net = s.ROIPooling(net, inp["rois"], pooled_size=(7, 7),
                       spatial_scale=1.0 / 16, name="roi_pool5")
    net = s.Flatten(data=net, name="flatten")
    for i in (6, 7):
        net = s.FullyConnected(data=net, num_hidden=4096, name="fc%d" % i)
        net = s.Activation(data=net, act_type="relu", name="relu%d" % i)
        net = s.Dropout(data=net, p=0.5, name="drop%d" % i)
    cls = s.SoftmaxOutput(data=s.FullyConnected(
        data=net, num_hidden=RCNN_CLASSES, name="cls_score"),
        label=inp["label"], normalization="batch", name="cls_prob")
    bbox = s.FullyConnected(data=net, num_hidden=4 * RCNN_CLASSES,
                            name="bbox_pred")
    diff = inp["bbox_weight"] * (bbox - inp["bbox_target"])
    loss = s.MakeLoss(s.smooth_l1(diff, scalar=1.0, name="bbox_loss_"),
                      grad_scale=1.0 / RCNN_ROIS, name="bbox_loss")
    return [cls, loss]


def _boxes(rng, n, h, w, lo, hi):
    """``n`` boxes [x1, y1, x2, y2] inside (h, w), sides in [lo, hi)."""
    bw, bh = rng.uniform(lo, hi, n), rng.uniform(lo, hi, n)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)


def rcnn_scenes(steps, seed=0):
    """``steps`` batches of seeded images (2, 3, 600, 1000), ground-truth
    boxes (2, RCNN_GT, 5: box and class 1..20) and proposals (2 * 2000,
    5: image index and box), half jittered around the ground truth."""
    rng = np.random.RandomState(seed)
    h, w = RCNN_HW
    out = []
    for _ in range(steps):
        gt = np.zeros((RCNN_IMAGES, RCNN_GT, 5), np.float32)
        props = []
        for b in range(RCNN_IMAGES):
            gt[b, :, :4] = _boxes(rng, RCNN_GT, h, w, 60, 400)
            gt[b, :, 4] = rng.randint(1, RCNN_CLASSES, RCNN_GT)
            near = np.repeat(gt[b, :, :4], RCNN_PROPOSALS // 2 // RCNN_GT, 0)
            side = np.repeat(near[:, 2:] - near[:, :2], 2, 1)
            near = near + rng.uniform(-0.25, 0.25, near.shape) * side
            boxes = np.concatenate([near, _boxes(
                rng, RCNN_PROPOSALS - len(near), h, w, 20, 500)])
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w - 1)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h - 1)
            props.append(np.concatenate(
                [np.full((len(boxes), 1), b, np.float32), boxes], 1))
        out.append({"data": rng.standard_normal(
            (RCNN_IMAGES, 3) + RCNN_HW).astype(np.float32),
            "gt_boxes": gt,
            "proposals": np.concatenate(props).astype(np.float32)})
    return out


def _iou(a, b):
    """IoU of (n, 4) boxes against (m, 4), in pixels (+1 widths)."""
    iw = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0]) + 1).clip(0)
    ih = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1]) + 1).clip(0)
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)
    inter = iw * ih
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def sample_rois(rng, proposals, gt):
    """Fast R-CNN's roi sampling for one batch (upstream
    rcnn/io/rcnn.py sample_rois): for each image the proposals and its
    ground truth, foreground IoU >= 0.5 (up to 25% of its 64), background
    IoU in [0.1, 0.5); labels, and bbox targets (dx, dy, dw, dh) over
    (0.1, 0.1, 0.2, 0.2) at the class's four columns with weight 1.
    Returns rois (128, 5), label (128,), bbox_target and bbox_weight
    (128, 84), float32."""
    per = RCNN_ROIS // RCNN_IMAGES
    fg_max = int(round(RCNN_FG * per))
    rois, labels, targets, weights = [], [], [], []
    for b in range(RCNN_IMAGES):
        boxes = np.concatenate([proposals[proposals[:, 0] == b, 1:],
                                gt[b, :, :4]])
        ov = _iou(boxes, gt[b, :, :4])
        best, arg = ov.max(1), ov.argmax(1)
        fg = np.flatnonzero(best >= 0.5)
        bg = np.flatnonzero((best < 0.5) & (best >= 0.1))
        n_fg = min(fg_max, len(fg))
        keep = np.concatenate([
            rng.choice(fg, n_fg, replace=False),
            rng.choice(bg, per - n_fg, replace=len(bg) < per - n_fg)])
        lab = gt[b, arg[keep], 4].copy()
        lab[n_fg:] = 0
        ex, g = boxes[keep], gt[b, arg[keep], :4]
        ew, eh = ex[:, 2] - ex[:, 0] + 1, ex[:, 3] - ex[:, 1] + 1
        gw, gh = g[:, 2] - g[:, 0] + 1, g[:, 3] - g[:, 1] + 1
        delta = np.stack([(g[:, 0] + 0.5 * gw - ex[:, 0] - 0.5 * ew) / ew,
                          (g[:, 1] + 0.5 * gh - ex[:, 1] - 0.5 * eh) / eh,
                          np.log(gw / ew), np.log(gh / eh)], 1) / RCNN_STDS
        t = np.zeros((per, 4 * RCNN_CLASSES), np.float32)
        wt = np.zeros_like(t)
        for i, c in enumerate(lab.astype(int)):
            if c:
                t[i, 4 * c:4 * c + 4] = delta[i]
                wt[i, 4 * c:4 * c + 4] = 1.0
        rois.append(np.concatenate([np.full((per, 1), b), ex], 1))
        labels.append(lab)
        targets.append(t)
        weights.append(wt)
    return (np.concatenate(rois).astype(np.float32),
            np.concatenate(labels).astype(np.float32),
            np.concatenate(targets), np.concatenate(weights))


def rcnn_batches(scenes, seed=7):
    """The scenes with their rois sampled in order by one RandomState."""
    rng = np.random.RandomState(seed)
    out = []
    for sc in scenes:
        rois, label, target, weight = sample_rois(rng, sc["proposals"],
                                                  sc["gt_boxes"])
        out.append(dict(sc, rois=rois, label=label, bbox_target=target,
                        bbox_weight=weight))
    return out


class ListIter:
    """A DataIter over ready batches (numpy dicts), on the host. ``mx``
    may be either package (the CPU tests feed both with it)."""

    def __init__(self, mx, batches, data_names, label_names):
        self._mx, self._batches = mx, batches
        self._data, self._label = data_names, label_names
        self.batch_size = batches[0][data_names[0]].shape[0]
        self._cur = 0

    def _descs(self, names):
        return [self._mx.io.DataDesc(n, self._batches[0][n].shape)
                for n in names]

    @property
    def provide_data(self):
        return self._descs(self._data)

    @property
    def provide_label(self):
        return self._descs(self._label)

    def reset(self):
        self._cur = 0

    def __iter__(self):
        return self

    def batch(self, i):
        b, cpu = self._batches[i], self._mx.cpu()
        return self._mx.io.DataBatch(
            [self._mx.nd.array(b[n], ctx=cpu) for n in self._data],
            [self._mx.nd.array(b[n], ctx=cpu) for n in self._label], pad=0)

    def __next__(self):
        if self._cur >= len(self._batches):
            raise StopIteration
        self._cur += 1
        return self.batch(self._cur - 1)

    next = __next__


def rcnn_metric(mx, label_out=None):
    """The classification head's accuracy, read off the labels (or, with
    ``label_out``, off that output, where the labels are made inside the
    graph)."""

    class RCNNAccuracy(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("rcnn_acc")

        def update(self, labels, preds):
            lab = (preds[label_out] if label_out is not None
                   else labels[0]).asnumpy().astype(int)
            self.sum_metric += float(
                (preds[0].asnumpy().argmax(1) == lab).sum())
            self.num_inst += len(lab)

    return RCNNAccuracy()


def _register_proposal_target(mx):
    """Fast R-CNN's proposal_target as a CustomOp (upstream
    rcnn/symbol/proposal_target.py): proposals and gt boxes in, rois,
    labels, bbox targets and weights out, sampled by the same RandomState
    as rcnn_batches; no gradient (need_top_grad False)."""

    class ProposalTarget(mx.operator.CustomOp):
        def __init__(self, seed):
            self._rng = np.random.RandomState(seed)

        def forward(self, is_train, req, in_data, out_data, aux):
            res = sample_rois(self._rng, in_data[0].asnumpy(),
                              in_data[1].asnumpy())
            for i, r in enumerate(res):
                self.assign(out_data[i], req[i], r)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            for i, g in enumerate(in_grad):
                self.assign(g, req[i], 0)

    @mx.operator.register("proposal_target")
    class ProposalTargetProp(mx.operator.CustomOpProp):
        def __init__(self, seed="7"):
            super().__init__(need_top_grad=False)
            self._seed = int(seed)

        def list_arguments(self):
            return ["proposals", "gt_boxes"]

        def list_outputs(self):
            return ["rois", "label", "bbox_target", "bbox_weight"]

        def infer_shape(self, in_shape):
            return in_shape, [(RCNN_ROIS, 5), (RCNN_ROIS,),
                              (RCNN_ROIS, 4 * RCNN_CLASSES),
                              (RCNN_ROIS, 4 * RCNN_CLASSES)], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return ProposalTarget(self._seed)


def rcnn_custom_symbol(mx):
    """vgg16_fast_rcnn with its rois, label, bbox target and bbox weight
    made inside the graph by a proposal_target Custom node from all the
    proposals and the gt boxes; the label is a third, gradient-blocked
    output (the metric reads it)."""
    s = mx.sym
    pt = s.Custom(s.Variable("proposals"), s.Variable("gt_boxes"),
                  op_type="proposal_target", seed="7",
                  name="proposal_target")
    heads = vgg16_fast_rcnn(mx, dict(zip(["rois"] + RCNN_LABELS, pt)))
    return mx.sym.Group(heads + [s.BlockGrad(pt[1], name="label_out")])


def _rcnn_group(name):
    low = name.lower()
    if "conv_gemm" in low:
        return "conv_gemm (K3)"
    if "roi_pool_fwd" in low:
        return "roi_pool forward"
    if "roi_pool_bwd" in low:
        return "roi_pool backward"
    if any(k in low for k in ("fprop", "implicit", "conv", "winograd",
                              "cudnn")):
        return "convolution forward (cuDNN)"
    if "gemm" in low or "gemv" in low or "cutlass" in low:
        return "fc GEMMs (cuBLAS)"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "SGD (foreach)"
    if "copy" in low:
        return "copies (layout, im2col, pads)"
    if "pool" in low:
        return "pooling"
    return "elementwise and reductions"


def _zero_launches(kernels):
    return dict.fromkeys(kernels.launch_counts(), 0)


def rcnn_module(mx, sym, data_names, label_names, batch, init_args=None,
                ctx=None, compute_dtype=None):
    """``sym`` bound for training on ``ctx`` (default: the card) at
    ``batch``'s shapes with conv1_x and conv2_x fixed; Xavier (fan-in,
    magnitude 2) from seed 0, or ``init_args``; ``compute_dtype`` the
    Module's when given."""
    dtype = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    mod = mx.mod.Module(sym, data_names=data_names, label_names=label_names,
                        context=ctx or mx.gpu(0), fixed_param_names=RCNN_FIXED,
                        **dtype)
    mod.bind(data_shapes=[(n, batch[n].shape) for n in data_names],
             label_shapes=[(n, batch[n].shape) for n in label_names],
             for_training=True)
    if init_args is None:
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.0,
                                       seed=0))
    else:
        mod.init_params(arg_params=init_args)
    return mod


def rcnn_fit(torch, mx, kernels, mod, it, fused, metric, label_of,
             after=None, opt=RCNN_OPT):
    """Module.fit of ``mod`` over ``it`` on the card (the classic loop or
    the fused step), Dropout's stream seeded as in every compared fit,
    launch counts and the allocation peak zeroed just before and read
    just after. Per step: the classification loss and the mean bbox
    loss of the outputs and the host clock at the batch-end callback,
    the card synchronised; then ``after(param)``, whose time no step
    counts."""
    losses, ends, starts = [], [], []

    def on_batch(param):
        outs = param.locals["self"].get_outputs()
        probs = outs[0].handle
        lab = label_of(param, outs).to(probs.device, torch.int64)
        losses.append(torch.stack([
            -torch.log(probs.gather(1, lab[:, None])).mean(),
            outs[1].handle.sum() / outs[1].shape[0]]))
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if after is not None:
            after(param)
        starts.append(time.perf_counter())

    mx.random.seed(0)   # Dropout's masks: the same stream in every fit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=opt,
            eval_metric=metric, batch_end_callback=on_batch,
            fused_step=fused)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps_ms = [1e3 * (b - a) for a, b in zip(starts, ends[1:])]
    return {"launches": launches, "peak_bytes": peak,
            "losses": [[float(x) for x in v] for v in losses],
            "steps_ms": steps_ms, "step_ms": float(np.median(steps_ms)),
            "args": _host(mod.get_params()[0]), "metric": metric.get()[1]}


def _same_fit(what, got, want):
    unequal = [k for k in want["args"]
               if not np.array_equal(got["args"][k], want["args"][k])]
    check(not unequal, "%s: params differ at %s" % (what, unequal[:5]))
    check(got["losses"] == want["losses"], "%s: losses %s against %s"
          % (what, got["losses"], want["losses"]))
    check(got["metric"] == want["metric"], "%s: metric %r against %r"
          % (what, got["metric"], want["metric"]))


def roi_pool_timing(torch, kernels, rois):
    """roi_pool's forward and backward at the main path's shape (conv5_3
    of two 600x1000 images, relu'd seeded normals: about half the map is
    zero, as after relu5_3) over the path's rois, by CUDA events with the
    L2 flushed, beside the plain version (chunked, bounded-memory
    gradient) and the byte bound; the kernel's forward against the plain
    one (bit-equal) and its gradient (rtol 1e-6 of the largest), reruns
    bit-identical."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w = RCNN_HW[0] // 16, RCNN_HW[1] // 16
    feat = torch.relu(torch.randn(RCNN_IMAGES, 512, h, w, generator=gen,
                                  device="cuda"))
    g = torch.randn(len(rois), 512, 7, 7, generator=gen, device="cuda")
    args = ((7, 7), 1.0 / 16)
    flush = torch.empty(64 << 20, device="cuda")
    out, count = kernels.roi_pool_fwd(feat, rois, *args)
    dx = kernels.roi_pool_bwd(feat, rois, out, count, g, *args)
    out2, _ = kernels.roi_pool_fwd(feat, rois, *args)
    dx2 = kernels.roi_pool_bwd(feat, rois, out, count, g, *args)
    check(torch.equal(out, out2) and torch.equal(dx, dx2),
          "roi_pool: reruns differ")
    res = {"fwd_ms": time_ms(torch, lambda: kernels.roi_pool_fwd(
        feat, rois, *args), flush),
        "bwd_ms": time_ms(torch, lambda: kernels.roi_pool_bwd(
            feat, rois, out, count, g, *args), flush)}
    try:
        with torch.no_grad():
            plain = kernels.roi_pool_plain(feat, rois, *args)
            res["plain_fwd_ms"] = time_ms(torch, lambda: kernels.roi_pool_plain(
                feat, rois, *args), flush, reps=3)
        pdx = kernels.roi_pool_plain_grad(feat, rois, g, *args)
        res["plain_bwd_ms"] = time_ms(torch, lambda: kernels.roi_pool_plain_grad(
            feat, rois, g, *args), flush, reps=3)
    except torch.cuda.OutOfMemoryError as e:
        res["plain_oom"] = str(e).splitlines()[0]
        plain = pdx = None
    if plain is not None:
        check(torch.equal(out, plain), "roi_pool forward differs from the "
              "plain version at the main path's shape: max abs err %g"
              % float((out - plain).abs().max()))
        err = float((dx - pdx).abs().max())
        check(err <= 1e-6 * float(pdx.abs().max()), "roi_pool backward: "
              "max abs err %g against the plain version" % err)
        res["bwd_max_abs_err"] = err
    f4 = 4
    nbytes = f4 * (feat.numel() * 2 + rois.numel() * 2 + out.numel()
                   + g.numel() + dx.numel())
    res.update(ms=res["fwd_ms"] + res["bwd_ms"],
               plain_ms=(res.get("plain_fwd_ms", float("nan"))
                         + res.get("plain_bwd_ms", float("nan"))),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bytes=nbytes, zero_share=float((feat == 0).float().mean()),
               mask_elements=len(rois) * 512 * 49 * h * w)
    del feat, g, out, count, dx, dx2, out2, plain, pdx, flush
    torch.cuda.empty_cache()
    return res


def rcnn_k3_products(mx, sym):
    """The K3 products of one Fast R-CNN training step, (M, N, K,
    transpose_a) -> count, read off the trunk's convolutions (all 3x3) by
    model_convs: a weight gradient for each convolution past the fixed
    conv1_x and conv2_x, an input gradient for each past conv3_1
    (nothing before conv3_1 trains)."""
    trunk = sym.get_internals()["relu5_3_output"]
    convs, _ = model_convs(mx, trunk, (RCNN_IMAGES, 3) + RCNN_HW)
    counts = {}
    for conv in convs:
        if conv["name"].split("_")[0] in ("conv1", "conv2"):
            continue
        (n, c, h, w), (_, o, ho, wo) = conv["x"], conv["g"]
        keys = [(9 * c, o, n * ho * wo, True)]
        if conv["name"] != "conv3_1":
            keys.append((n * h * w, c, 9 * o, False))
        for key in keys:
            counts[key] = counts.get(key, 0) + 1
    check(sum(counts.values()) == RCNN_K3_STEP, "13a: %d K3 products a "
          "step read off the graph, want %d" % (sum(counts.values()),
                                                RCNN_K3_STEP))
    return counts


def _rcnn_loss(probs, bbox, label):
    """The classification NLL (mean) and the bbox loss (mean over rois) of
    one step's outputs, float64 on the host."""
    probs = probs.astype(np.float64)
    cls = float(-np.log(probs[np.arange(len(label)),
                              label.astype(int)]).mean())
    return cls, float(bbox.astype(np.float64).sum() / bbox.shape[0])


def rcnn_gate(torch, mx, sym, init, batch):
    """One classic step of 13a's graph at full width (2 images of
    600x1000, every layer at its width) over every RCNN_GATE_EVERY-th roi
    of ``batch``, on the card (K3, roi_pool, cuDNN) and on the CPU (their
    plain versions), from the same weights ``init`` with the same Dropout
    masks (keyed by node name, see _mask_keyed_dropout). Bound, as
    model_gate's: each loss within rtol 1e-4, the update of all params
    together within 1e-2 of its norm."""
    narrow = {k: (v[::RCNN_GATE_EVERY] if k in RCNN_LABELS + ["rois"]
                  else v) for k, v in batch.items()}
    res = []
    undo = _mask_keyed_dropout(torch, mx, sym)
    try:
        for ctx in (mx.gpu(0), mx.cpu()):
            t0 = time.perf_counter()
            mod = rcnn_module(mx, sym, RCNN_DATA, RCNN_LABELS, narrow, init,
                              ctx=ctx)
            mod.init_optimizer(optimizer="sgd", optimizer_params=RCNN_OPT)
            it = ListIter(mx, [narrow], RCNN_DATA, RCNN_LABELS)
            mod.forward_backward(it.batch(0))
            mod.update()
            outs = [o.asnumpy() for o in mod.get_outputs()]
            res.append((_rcnn_loss(outs[0], outs[1], narrow["label"]),
                        _host(mod.get_params()[0]),
                        1e3 * (time.perf_counter() - t0)))
            del mod
    finally:
        undo()
    (lg, pg, ms_card), (lc, pc, ms_cpu) = res
    start = {k: v.asnumpy() for k, v in init.items()}
    diff = np.concatenate([(pg[k] - pc[k]).ravel() for k in pc])
    upd = np.concatenate([(pc[k] - start[k]).ravel() for k in pc])
    rel = float(np.linalg.norm(diff) / np.linalg.norm(upd))
    for name, a, b in (("classification", lg[0], lc[0]),
                       ("bbox", lg[1], lc[1])):
        check(abs(a - b) <= 1e-4 * abs(b), "13a gate: %s loss %g on the "
              "card, %g on the CPU" % (name, a, b))
    check(rel <= 1e-2, "13a gate: the card's update differs from the CPU's "
          "by %.3g of its norm (bound 1e-2)" % rel)
    return {"rois": len(narrow["rois"]), "loss_card": lg, "loss_cpu": lc,
            "update_rel_err": rel, "ms_card": ms_card, "ms_cpu": ms_cpu}


def rcnn_main_path(torch, mx, kernels, card):
    """13a Fast R-CNN on VGG-16 at full width through both loops, 13b the
    same graph with a proposal_target Custom op (classic loop; the fused
    step refuses), and roi_pool at the path's shape."""
    scenes = rcnn_scenes(RCNN_STEPS)
    batches = rcnn_batches(scenes)
    sym = mx.sym.Group(vgg16_fast_rcnn(mx))
    zero = _zero_launches(kernels)

    labels = [torch.from_numpy(b["label"]).cuda() for b in batches]

    def label_of(param, outs):
        return labels[param.nbatch]

    def fit(fused, after=None, init_args=None):
        mod = rcnn_module(mx, sym, RCNN_DATA, RCNN_LABELS, batches[0],
                          init_args)
        it = ListIter(mx, batches, RCNN_DATA, RCNN_LABELS)
        return mod, rcnn_fit(torch, mx, kernels, mod, it, fused,
                             rcnn_metric(mx), label_of, after)

    after3 = {}

    def keep_three(param):
        if param.nbatch == RCNN_CUSTOM_STEPS - 1:
            after3["args"] = _host(param.locals["self"].get_params()[0])

    mod, classic = fit(False, keep_three)
    init = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
            _host(rcnn_module(mx, sym, RCNN_DATA, RCNN_LABELS, batches[0])
                  .get_params()[0]).items()}
    del mod
    check(classic["launches"] == dict(zero, conv_gemm=RCNN_K3_STEP
                                      * RCNN_STEPS, roi_pool=2 * RCNN_STEPS),
          "13a classic launches %s, want K3 %d and roi_pool 2 a step"
          % (classic["launches"], RCNN_K3_STEP))
    check(all(np.isfinite(classic["losses"]).ravel()), "13a losses %s"
          % classic["losses"])
    for k, v in classic["args"].items():
        check(np.array_equal(v, init[k].asnumpy()) == (k in RCNN_FIXED),
              "13a: %s %s" % (k, "moved" if k in RCNN_FIXED else
                              "did not change"))
    mod, fused = fit(True)
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(counters == (1, 1, RCNN_STEPS - 1), "13a fused counters %s"
          % (counters,))
    check(fused["launches"] == dict(zero, conv_gemm=2 * RCNN_K3_STEP,
                                    roi_pool=4),
          "13a fused launches %s (the eager step and the capture)"
          % fused["launches"])
    _same_fit("13a fused against classic", fused, classic)
    it = ListIter(mx, batches, RCNN_DATA, RCNN_LABELS)
    batch, metric = it.batch(0), rcnn_metric(mx)
    step.step(batch, metric)
    torch.cuda.synchronize()
    prof = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                          group=_rcnn_group)
    check(prof["launches"] == dict(
        {k: 0 for k in kernels.LAUNCH_KERNELS}, conv_gemm=2 * RCNN_K3_STEP,
        roi_pool=4), "13a: two profiled replays ran %s" % prof["launches"])
    rois = torch.from_numpy(batches[0]["rois"]).cuda()
    del mod, step, batch
    torch.cuda.empty_cache()
    timing = roi_pool_timing(torch, kernels, rois)
    # K3 against float64 at the step's products no earlier phase holds
    products = rcnn_k3_products(mx, sym)
    new = sorted(set(products) - set(conv_gemm_shapes(mx)))
    k3_worst, k3_cases = conv_gemm_parity(torch, kernels, new)
    torch.cuda.empty_cache()
    gate = rcnn_gate(torch, mx, sym, init, batches[0])
    torch.cuda.empty_cache()
    groups = prof["by_group_ms"]
    img_s = lambda run: RCNN_IMAGES * 1e3 / run["step_ms"]
    print("13a Fast R-CNN VGG-16 %dx%d, %d images, %d rois, %d classes, "
          "f32: host step %.3f / %.3f ms (classic / fused), %.2f / %.2f "
          "img/s, device %.3f ms a step, busy %.1f%%, peak %.3f / %.3f GB; "
          "launches classic %s, fused %s; by group ms a step: %s  [%s]"
          % (RCNN_HW[0], RCNN_HW[1], RCNN_IMAGES, RCNN_ROIS, RCNN_CLASSES,
             classic["step_ms"], fused["step_ms"], img_s(classic),
             img_s(fused), prof["device_ms_per_step"],
             100 * prof["busy_share"], classic["peak_bytes"] / 1e9,
             fused["peak_bytes"] / 1e9, classic["launches"],
             fused["launches"],
             {k: round(v, 3) for k, v in sorted(groups.items())}, card))
    print("13a roi_pool at (2, 512, %d, %d), %d rois, 7x7: forward %.4f ms, "
          "backward %.4f ms (kernel); plain %s; bound %.4f ms (bytes); the "
          "reference's mask would hold %d elements  [%s]"
          % (RCNN_HW[0] // 16, RCNN_HW[1] // 16, RCNN_ROIS, timing["fwd_ms"],
             timing["bwd_ms"], timing.get("plain_oom") or
             "forward %.3f ms, gradient %.3f ms" % (timing["plain_fwd_ms"],
                                                    timing["plain_bwd_ms"]),
             timing["bound_ms"], timing["mask_elements"], card))
    print("13a conv_gemm parity: %d cases (%d of the step's %d distinct "
          "products, f32 and bf16), reruns bit-identical, max abs err vs "
          "float64 f32 %g, bf16 %g; max %.3g of sum|a||b| (bound 1e-6)"
          % (k3_cases, len(new), len(products), k3_worst["abs_float32"],
             k3_worst["abs_bfloat16"], k3_worst["rel"]))
    print("13a gate, one classic step over %d rois at full width, card "
          "against CPU: losses %s / %s (rtol 1e-4), update %.3g of its norm "
          "(bound 1e-2); %.0f ms on the card, %.0f ms on the CPU"
          % (gate["rois"], ["%.6f" % v for v in gate["loss_card"]],
             ["%.6f" % v for v in gate["loss_cpu"]], gate["update_rel_err"],
             gate["ms_card"], gate["ms_cpu"]))

    # 13b: the rois from a Custom op, classic loop, 3 batches
    _register_proposal_target(mx)
    csym = rcnn_custom_symbol(mx)
    names = ["data", "proposals", "gt_boxes"]
    custom_batches = scenes[:RCNN_CUSTOM_STEPS]
    mod = rcnn_module(mx, csym, names, [], custom_batches[0], init)
    it = ListIter(mx, custom_batches, names, [])
    kernels.reset_launch_counts()
    custom = rcnn_fit(torch, mx, kernels, mod, it, False,
                      rcnn_metric(mx, label_out=2),
                      lambda param, outs: outs[2].handle)
    unequal = [k for k in after3["args"]
               if not np.array_equal(custom["args"][k], after3["args"][k])]
    check(not unequal, "13b: params after %d batches differ from 13a's "
          "classic loop at %s" % (RCNN_CUSTOM_STEPS, unequal[:5]))
    check(custom["losses"] == classic["losses"][:RCNN_CUSTOM_STEPS],
          "13b losses %s against 13a's %s" % (custom["losses"],
                                              classic["losses"]))
    refused = None
    try:
        mod.fit(ListIter(mx, custom_batches, names, []), num_epoch=1,
                optimizer="sgd", optimizer_params=RCNN_OPT,
                eval_metric=rcnn_metric(mx, label_out=2), fused_step=True)
    except mx.MXNetError as e:
        refused = str(e)
    check(refused is not None and "proposal_target" in refused,
          "13b: fit(fused_step=True) over a Custom node did not refuse: %s"
          % refused)
    del mod
    torch.cuda.empty_cache()
    print("13b proposal_target as a Custom op: %d batches through the "
          "classic loop, params and losses bit-equal to 13a's, host step "
          "%.3f ms; fused step refused: %s  [%s]"
          % (RCNN_CUSTOM_STEPS, custom["step_ms"], refused, card))
    return {"symbol": sym, "args": classic["args"],
            "classic": {k: v for k, v in classic.items() if k != "args"},
            "fused": {k: v for k, v in fused.items() if k != "args"},
            "counters": counters, "replays_profiled": prof,
            "roi_pool": timing, "gate": gate,
            "k3_parity": dict(k3_worst, cases=k3_cases, products=len(new)),
            "img_per_s_classic": img_s(classic),
            "img_per_s_fused": img_s(fused),
            "custom": {"step_ms": custom["step_ms"], "refused": refused,
                       "launches": custom["launches"],
                       "losses": custom["losses"]}}


def lstm_ocr(mx, seq_len=OCR_T, hidden=OCR_HIDDEN, layers=OCR_LAYERS,
             num_label=OCR_LABEL, classes=OCR_CLASSES):
    """Upstream example/warpctc lstm_ocr's model (by default at its
    widths): the (B, T * F) input sliced into ``seq_len`` frames,
    ``layers`` unrolled LSTM layers of ``hidden`` (initial states as
    data), the hidden states concatenated time-major into FC(classes),
    WarpCTC(label_length, input_length). ``mx`` may be either package
    (the CPU tests build the narrow model with it)."""
    s = mx.sym
    with mx.name.NameManager():
        cells = [{k: s.Variable("l%d_%s" % (i, k)) for k in
                  ("i2h_weight", "i2h_bias", "h2h_weight", "h2h_bias")}
                 for i in range(layers)]
        state = [(s.Variable("l%d_init_h" % i), s.Variable("l%d_init_c" % i))
                 for i in range(layers)]
        frames = s.SliceChannel(s.Variable("data"), num_outputs=seq_len,
                                axis=1, name="slice")
        hidden_all = []
        for t in range(seq_len):
            h = frames[t]
            for i in range(layers):
                p, (ph, pc) = cells[i], state[i]
                gates = (s.FullyConnected(data=h, weight=p["i2h_weight"],
                                          bias=p["i2h_bias"],
                                          num_hidden=4 * hidden,
                                          name="t%d_l%d_i2h" % (t, i))
                         + s.FullyConnected(data=ph, weight=p["h2h_weight"],
                                            bias=p["h2h_bias"],
                                            num_hidden=4 * hidden,
                                            name="t%d_l%d_h2h" % (t, i)))
                g = s.SliceChannel(gates, num_outputs=4, axis=1,
                                   name="t%d_l%d_slice" % (t, i))
                c = (s.Activation(g[1], act_type="sigmoid") * pc
                     + s.Activation(g[0], act_type="sigmoid")
                     * s.Activation(g[2], act_type="tanh"))
                h = s.Activation(g[3], act_type="sigmoid") * s.Activation(
                    c, act_type="tanh")
                state[i] = (h, c)
            hidden_all.append(h)
        pred = s.FullyConnected(data=s.Concat(*hidden_all, dim=0),
                                num_hidden=classes, name="pred")
        return s.WarpCTC(pred, s.Variable("label"), label_length=num_label,
                         input_length=seq_len, name="ctc")


def ocr_batches(steps, seed=0, seq_len=OCR_T, feat=OCR_FEAT, batch=OCR_BATCH,
                hidden=OCR_HIDDEN, layers=OCR_LAYERS):
    """toy_ctc.gen_batch's synthetic digit strings at ``feat`` features:
    each of OCR_LABEL digits spans an equal share of the frames, one-hot
    in feature ``digit % feat`` plus noise 0.15; labels digit + 1 (blank
    0); zero initial states."""
    rng = np.random.RandomState(seed)
    span = seq_len // OCR_LABEL
    out = []
    for _ in range(steps):
        data = np.zeros((batch, seq_len, feat), np.float32)
        labels = np.zeros((batch, OCR_LABEL), np.float32)
        for b in range(batch):
            digits = rng.randint(0, 10, OCR_LABEL)
            labels[b] = digits + 1
            for i, d in enumerate(digits):
                data[b, i * span:(i + 1) * span, d % feat] = 1.0
        data += rng.randn(*data.shape).astype(np.float32) * 0.15
        one = {"data": data.reshape(batch, seq_len * feat), "label": labels}
        for i in range(layers):
            for k in "hc":
                one["l%d_init_%s" % (i, k)] = np.zeros((batch, hidden),
                                                       np.float32)
        out.append(one)
    return out


def ocr_metric(mx):
    """Greedy CTC decoding (collapse repeats, drop blanks) of each
    sequence against its (B, L) label row: the share read exactly
    (upstream lstm_ocr's Accuracy). ``mx`` may be either package."""

    class SeqAccuracy(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("seq_acc")

        def update(self, labels, preds):
            lab = labels[0].asnumpy()
            best = preds[0].asnumpy().argmax(1).reshape(-1, len(lab))
            for b, row in enumerate(lab):
                seq = [c for i, c in enumerate(best[:, b])
                       if c and (i == 0 or c != best[i - 1, b])]
                self.sum_metric += float(seq == [int(v) for v in row if v])
                self.num_inst += 1

    return SeqAccuracy()


def ocr_gate(torch, mx, sym, params, batch):
    """One classic step of LSTM-OCR at full width from ``params`` with
    13c's SGD on the card and on the CPU, held as 12a's (_lstm_gate)."""
    names = ["data"] + OCR_INIT
    runs, ms = [], []
    for ctx in (mx.gpu(0), mx.cpu()):
        t0 = time.perf_counter()
        mod = mx.mod.Module(sym, data_names=names, label_names=["label"],
                            context=ctx)
        mod.bind(data_shapes=[(n, batch[n].shape) for n in names],
                 label_shapes=[("label", batch["label"].shape)],
                 for_training=True)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=OCR_OPT)
        mod.forward_backward(ListIter(mx, [batch], names, ["label"]).batch(0))
        mod.update()
        runs.append((mod.get_outputs()[0].asnumpy().copy(),
                     _host(mod.get_params()[0])))
        ms.append(1e3 * (time.perf_counter() - t0))
        del mod
    return dict(_lstm_gate("13c gate", runs, params), ms_card=ms[0],
                ms_cpu=ms[1])


def ocr_main_path(torch, mx, kernels, card):
    """13c: LSTM-OCR with WarpCTC through both loops, bit-equal, one
    capture; its NLL against torch's ctc_loss; frames a second."""
    batches = ocr_batches(OCR_STEPS)
    sym = lstm_ocr(mx)
    names = ["data"] + OCR_INIT
    zero = _zero_launches(kernels)

    def fit(fused):
        mod = mx.mod.Module(sym, data_names=names, label_names=["label"],
                            context=mx.gpu(0))
        mod.bind(data_shapes=[(n, batches[0][n].shape) for n in names],
                 label_shapes=[("label", batches[0]["label"].shape)],
                 for_training=True)
        mod.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34,
                                       seed=0))
        start = _host(mod.get_params()[0])
        outs, marks = [], []

        def on_batch(param):
            outs.append(param.locals["self"].get_outputs()[0].handle.clone())
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        metric = ocr_metric(mx)
        mx.random.seed(0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mod.fit(ListIter(mx, batches, names, ["label"]), num_epoch=1,
                optimizer="sgd", optimizer_params=OCR_OPT,
                eval_metric=metric, batch_end_callback=on_batch,
                fused_step=fused)
        launches = kernels.launch_counts()
        steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        return mod, {"launches": launches, "outs": outs,
                     "step_ms": float(np.median(steps_ms)),
                     "args": _host(mod.get_params()[0]),
                     "metric": metric.get()[1], "start": start}

    _, classic = fit(False)
    mod, fused = fit(True)
    step = mod._fused_step
    counters = (step.eager_steps, step.captures, step.dispatches)
    check(counters == (1, 1, OCR_STEPS - 1), "13c fused counters %s"
          % (counters,))
    check(classic["launches"] == zero and fused["launches"] == zero,
          "13c launches %s / %s, want none" % (classic["launches"],
                                               fused["launches"]))
    unequal = [k for k in classic["args"]
               if not np.array_equal(fused["args"][k], classic["args"][k])]
    check(not unequal, "13c: params differ at %s" % unequal[:5])
    check(all(torch.equal(a, b) for a, b in zip(fused["outs"],
                                                classic["outs"])),
          "13c: outputs differ between the loops")
    check(fused["metric"] == classic["metric"], "13c metric %r against %r"
          % (fused["metric"], classic["metric"]))
    # the NLL of the last batch against torch's own CTC (independent)
    from mxnet_tpu_torch.ops.ctc import ctc_neg_log_likelihood

    lp = torch.log(fused["outs"][-1]).reshape(OCR_T, OCR_BATCH, -1)
    labels = torch.from_numpy(batches[-1]["label"]).cuda()
    ours = ctc_neg_log_likelihood(lp, labels)
    ref = torch.nn.functional.ctc_loss(
        lp, labels.long(), torch.full((OCR_BATCH,), OCR_T, dtype=torch.long),
        torch.full((OCR_BATCH,), OCR_LABEL, dtype=torch.long), blank=0,
        reduction="none")
    nll_err = float(((ours - ref).abs() / ref.abs()).max())
    check(nll_err <= 1e-4, "13c: NLL against torch's ctc_loss, max rel err "
          "%g" % nll_err)
    check(bool(torch.isfinite(ours).all()), "13c: NLL not finite")
    gate = ocr_gate(torch, mx, sym, classic["start"], batches[0])
    it = ListIter(mx, batches, names, ["label"])
    batch, metric = it.batch(0), ocr_metric(mx)
    step.step(batch, metric)
    torch.cuda.synchronize()
    prof = _profile_steps(torch, kernels, lambda: step.step(batch, metric),
                          group=_lm_group)
    frames = lambda run: OCR_T * OCR_BATCH * 1e3 / run["step_ms"]
    print("13c LSTM-OCR (2 x %d, T=%d, %d features, batch %d) into WarpCTC: "
          "host step %.3f / %.3f ms (classic / fused), %.0f / %.0f frames/s, "
          "replay device %.3f ms (union %.3f), busy %.1f%%; one capture, "
          "bit-equal; NLL vs torch ctc_loss max rel err %.3g; mean NLL "
          "%.4f  [%s]"
          % (OCR_HIDDEN, OCR_T, OCR_FEAT, OCR_BATCH, classic["step_ms"],
             fused["step_ms"], frames(classic), frames(fused),
             prof["device_ms_per_step"], prof["device_union_ms_per_step"],
             100 * prof["busy_union_share"], nll_err,
             float(ours.mean()), card))
    print("13c gate, one classic step, card against CPU: outputs %.3g "
          "(bound %g), worst update %.3g (bound %g) normwise; %.0f ms on the "
          "card, %.0f ms on the CPU" % (
              gate["outputs_normwise"], LM_GATE_OUT,
              gate["update_normwise_worst"], LM_GATE_UPDATE,
              gate["ms_card"], gate["ms_cpu"]))
    del mod, step
    return {"counters": counters, "launches_classic": classic["launches"],
            "launches_fused": fused["launches"],
            "step_ms_classic": classic["step_ms"],
            "step_ms_fused": fused["step_ms"],
            "frames_per_s_classic": frames(classic),
            "frames_per_s_fused": frames(fused), "nll_rel_err": nll_err,
            "gate": gate,
            "replays_profiled": prof}


def vision_op_checks(torch, mx, kernels, card):
    """13d: the slice's ops on the card against the port on the CPU; the
    roi_pool kernel against its plain version over ragged rois; the
    sample ops by distribution in both modes."""
    rng = np.random.RandomState(21)
    s = mx.sym
    res = {}

    def both(label, build, args, grads, rtol, atol):
        got = _run_op(mx, build, args, grads, mx.gpu(0))
        want = _run_op(mx, build, args, grads, mx.cpu())
        worst = max([_close(a, b, rtol, atol) for a, b in zip(got[0],
                                                             want[0])]
                    + [_close(got[1][k], want[1][k], 10 * rtol, 10 * atol)
                       for k in grads])
        check(worst <= 0, "13d %s: card against CPU off by %g beyond rtol "
              "%g" % (label, worst, rtol))
        res[label] = worst

    v = s.Variable
    both("SpatialTransformer", lambda: s.SpatialTransformer(
        v("data"), v("loc"), target_shape=(12, 15)),
        {"data": rng.randn(2, 3, 16, 20).astype(np.float32),
         "loc": (np.array([0.9, 0.1, 0.05, -0.1, 1.1, 0.02]) + rng.randn(
             2, 6) * 0.05).astype(np.float32)}, ["data", "loc"], 1e-5, 1e-6)
    # FlowNetC's correlation: displacement 20, stride2 2, pad 20
    both("Correlation", lambda: s.Correlation(
        v("data1"), v("data2"), kernel_size=1, max_displacement=20,
        stride1=1, stride2=2, pad_size=20),
        {"data1": rng.randn(2, 256, 48, 64).astype(np.float32),
         "data2": rng.randn(2, 256, 48, 64).astype(np.float32)},
        ["data1", "data2"], 1e-4, 1e-5)
    both("softmax_cross_entropy", lambda: s.softmax_cross_entropy(
        v("data"), v("label")),
        {"data": rng.randn(16, 21).astype(np.float32),
         "label": rng.randint(0, 21, 16).astype(np.float32)}, ["data"],
        1e-5, 1e-6)
    both("CTCLoss", lambda: s.CTCLoss(v("data"), v("label")),
         {"data": rng.randn(OCR_T, OCR_BATCH, OCR_CLASSES).astype(np.float32),
          "label": rng.randint(0, OCR_CLASSES, (OCR_BATCH, OCR_LABEL))
          .astype(np.float32)}, ["data"], 1e-4, 1e-5)
    # roi_pool against its plain version: ragged rois over a map with a
    # zero plateau, a NaN and an infinity (their bins give 0, no gradient)
    feat = torch.from_numpy(rng.randn(2, 64, 37, 62).astype(np.float32))
    feat[0, :, :12, :20] = 0.0
    feat[1, 3, 20, 30] = float("nan")
    feat[0, 5, 25, 40] = float("inf")
    rois = np.concatenate([
        sample_rois(np.random.RandomState(3), *[
            rcnn_scenes(1)[0][k] for k in ("proposals", "gt_boxes")])[0],
        np.array([[0, 0, 0, 400, 250],        # over the zero plateau
                  [1, 900, 500, 1400, 900],   # past the edge: empty bins
                  [0, 100, 100, 104, 104],    # smaller than the 7x7 grid
                  [1.9, 0, 0, 999, 599]], np.float32)])
    rois_t = torch.from_numpy(rois)
    g = torch.from_numpy(rng.randn(len(rois), 64, 7, 7).astype(np.float32))
    args = ((7, 7), 1.0 / 16)
    fc, rc, gc = feat.cuda(), rois_t.cuda(), g.cuda()
    out, count = kernels.roi_pool_fwd(fc, rc, *args)
    dx = kernels.roi_pool_bwd(fc, rc, out, count, gc, *args)
    out2, _ = kernels.roi_pool_fwd(fc, rc, *args)
    dx2 = kernels.roi_pool_bwd(fc, rc, out, count, gc, *args)
    torch.cuda.synchronize()
    check(torch.equal(out, out2) and torch.equal(dx, dx2),
          "13d roi_pool: reruns differ")
    plain = kernels.roi_pool_plain(fc, rc, *args)
    pdx = kernels.roi_pool_plain_grad(fc, rc, gc, *args)
    check(torch.equal(out, plain), "13d roi_pool: forward differs from the "
          "plain version (max abs err %g)" % float((out - plain).abs().max()))
    err = float((dx - pdx).abs().max())
    check(err <= 1e-6 * float(pdx.abs().max()), "13d roi_pool: gradient "
          "max abs err %g against the plain version" % err)
    check(float(dx[1, 3, 20, 30]) == 0 and float(dx[0, 5, 25, 40]) == 0,
          "13d roi_pool: a NaN or an infinity took a gradient")
    cpu_out = kernels.roi_pool(feat, rois_t, *args)
    check(torch.equal(out.cpu(), cpu_out), "13d roi_pool: card against the "
          "CPU's plain version")
    res["roi_pool_grad_max_abs_err"] = err
    res["roi_pool_ties"] = int((count > 1).sum())
    res["roi_pool_empty_bins"] = int((count == 0).sum())
    # the sample ops by distribution, 2^20 draws, train and inference
    n = 1 << 20
    for op, params, mean, var, m4 in [
            ("uniform", dict(low=-2.0, high=3.0), 0.5, 25.0 / 12,
             9.0 / 5 * (25.0 / 12) ** 2),
            ("normal", dict(loc=1.5, scale=2.0), 1.5, 4.0, 3 * 16.0)]:
        for is_train in (False, True):
            ex = getattr(s, op)(shape=(n,), **params).bind(
                mx.gpu(0), {}, grad_req="null")
            x = ex.forward(is_train=is_train)[0].handle.double()
            dm, dv = float(x.mean()) - mean, float(x.var()) - var
            check(abs(dm) < 4 * np.sqrt(var / n)
                  and abs(dv) < 4 * np.sqrt((m4 - var ** 2) / n),
                  "13d %s (train %s): mean %+g, var %+g off" % (
                      op, is_train, dm, dv))
            res["%s_%s" % (op, "train" if is_train else "infer")] = (dm, dv)
    print("13d ops on the card against the CPU: %s; roi_pool: forward "
          "bit-equal to the plain version over %d ragged rois on a map with "
          "a NaN and an infinity (%d tied bins, %d giving 0), gradient max abs err %.3g, reruns bit-identical; "
          "sample ops within 4 sigma over 2^20 draws in both modes  [%s]"
          % ({k: "%.3g" % v for k, v in res.items()
              if k in ("SpatialTransformer", "Correlation",
                       "softmax_cross_entropy", "CTCLoss")}, len(rois),
             res["roi_pool_ties"], res["roi_pool_empty_bins"], err, card))
    return res


def surface_checks(torch, mx, rcnn):
    """13e: group2ctx (gpu(0) beside cpu(0)) against a one-device bind, a
    mem:// round trip of 13a's params, print_summary of 13a's symbol."""
    s = mx.sym
    with mx.name.NameManager():
        with mx.AttrScope(ctx_group="dev1"):
            fc1 = s.FullyConnected(s.Variable("data"), num_hidden=64,
                                   name="fc1")
            act1 = s.Activation(fc1, act_type="relu")
        with mx.AttrScope(ctx_group="dev2"):
            net = s.SoftmaxOutput(s.FullyConnected(act1, num_hidden=10,
                                                   name="fc2"),
                                  name="softmax")
    rng = np.random.RandomState(4)
    shapes, _, _ = net.infer_shape(data=(16, 32), softmax_label=(16,))
    host = {n: (rng.randn(*sh) * 0.3).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)}
    host["softmax_label"] = rng.randint(0, 10, 16).astype(np.float32)
    runs = []
    for g2c in (None, {"dev1": mx.gpu(0), "dev2": mx.cpu(0)}):
        args = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in host.items()}
        grads = {k: mx.nd.zeros(v.shape, ctx=mx.gpu(0)) for k, v in
                 host.items() if k != "softmax_label"}
        ex = net.bind(mx.gpu(0), args, args_grad=grads, group2ctx=g2c)
        ex.forward(is_train=True)
        ex.backward()
        runs.append((ex.outputs[0].asnumpy(),
                     {k: g.asnumpy() for k, g in grads.items()}))
    (o1, g1), (o2, g2) = runs
    check(np.allclose(o2, o1, rtol=1e-5, atol=1e-7), "13e group2ctx outputs")
    for k in g1:
        check(np.allclose(g2[k], g1[k], rtol=1e-4, atol=1e-7),
              "13e group2ctx gradient %s" % k)
    params = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
              rcnn["args"].items()}
    mx.nd.save("mem://rcnn/params.nd", params)
    back = mx.nd.load("mem://rcnn/params.nd", ctx=mx.cpu())
    check(sorted(back) == sorted(params) and all(
        np.array_equal(back[k].asnumpy(), rcnn["args"][k]) for k in back),
        "13e: the mem:// round trip changed 13a's params")
    mx.filesystem._SCHEMES["mem"].clear()
    summary = mx.viz.print_summary(rcnn["symbol"], {
        "data": (RCNN_IMAGES, 3) + RCNN_HW, "rois": (RCNN_ROIS, 5)})
    check("roi_pool5(ROIPooling)" in summary, "13e: print_summary")
    print("13e group2ctx {dev1: gpu(0), dev2: cpu(0)} equals the one-device "
          "bind (outputs rtol 1e-5, grads rtol 1e-4); 13a's %d params "
          "through mem:// bit-equal" % len(params))
    return {"params_mem_roundtrip": len(params)}


def rcnn_ocr_main_path(torch, mx, kernels, card):
    """Phase 13: 13a/13b Fast R-CNN, 13c LSTM-OCR, 13d op checks and the
    bfloat16 ROIPooling repair, 13e the executor surface."""
    rcnn = rcnn_main_path(torch, mx, kernels, card)
    ocr = ocr_main_path(torch, mx, kernels, card)
    ops = vision_op_checks(torch, mx, kernels, card)
    ops["bf16"] = rcnn_bf16_checks(torch, mx, kernels, card, rcnn["symbol"])
    surface = surface_checks(torch, mx, rcnn)
    for key in ("symbol", "args"):
        rcnn.pop(key)
    return {"rcnn": rcnn, "ocr": ocr, "ops": ops, "surface": surface}


RCNN_BF16_STEPS = 3
#: the 16-bit roi_pool backward against the plain version, in units of the
#: dtype's epsilon of the sum of the terms' magnitudes at each pixel (the
#: kernel sums in float32, the plain version in the dtype; the bound of
#: tests/test_torch_queue_c.py against JAX)
ROI_16_EPS = 8


def roi_pool_16bit(torch, kernels, rois, dtype):
    """roi_pool in ``dtype`` at 13a's shape (relu'd seeded normals,
    (2, 512, 37, 62), the path's rois): the forward bit-equal to the plain
    version, the gradient within ROI_16_EPS epsilons of the dtype of the
    sum of its terms' magnitudes (the kernel's gradient for |g|), reruns
    bit-identical; the kernel's and the plain version's times."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    h, w = RCNN_HW[0] // 16, RCNN_HW[1] // 16
    feat = torch.relu(torch.randn(RCNN_IMAGES, 512, h, w, generator=gen,
                                  device="cuda")).to(dtype)
    g = torch.randn(len(rois), 512, 7, 7, generator=gen,
                    device="cuda").to(dtype)
    args = ((7, 7), 1.0 / 16)
    flush = torch.empty(64 << 20, device="cuda")
    out, count = kernels.roi_pool_fwd(feat, rois, *args)
    dx = kernels.roi_pool_bwd(feat, rois, out, count, g, *args)
    out2, _ = kernels.roi_pool_fwd(feat, rois, *args)
    dx2 = kernels.roi_pool_bwd(feat, rois, out, count, g, *args)
    name = str(dtype).replace("torch.", "")
    check(out.dtype == dx.dtype == dtype and torch.equal(out, out2)
          and torch.equal(dx, dx2), "13d roi_pool %s: reruns differ" % name)
    with torch.no_grad():
        plain = kernels.roi_pool_plain(feat, rois, *args)
    pdx = kernels.roi_pool_plain_grad(feat, rois, g, *args)
    check(torch.equal(out, plain), "13d roi_pool %s: forward differs from "
          "the plain version" % name)
    abs_sum = kernels.roi_pool_bwd(feat, rois, out, count, g.abs(),
                                   *args).double()
    err = (dx.double() - pdx.double()).abs()
    eps = torch.finfo(dtype).eps
    rel = float((err / abs_sum.clamp(min=1e-30)).max()) / eps
    check(bool((err <= ROI_16_EPS * eps * abs_sum).all()), "13d roi_pool "
          "%s: gradient off the plain version by %.3g epsilons of the sum "
          "of its terms (bound %d)" % (name, rel, ROI_16_EPS))
    res = {"fwd_ms": time_ms(torch, lambda: kernels.roi_pool_fwd(
        feat, rois, *args), flush),
        "bwd_ms": time_ms(torch, lambda: kernels.roi_pool_bwd(
            feat, rois, out, count, g, *args), flush),
        "plain_fwd_ms": time_ms(torch, lambda: kernels.roi_pool_plain(
            feat, rois, *args), flush, reps=3),
        "plain_bwd_ms": time_ms(torch, lambda: kernels.roi_pool_plain_grad(
            feat, rois, g, *args), flush, reps=3),
        "bwd_max_abs_err": float(err.max()), "bwd_max_eps_of_abs_sum": rel}
    b2 = 2
    nbytes = (b2 * (feat.numel() * 2 + out.numel() + g.numel() + dx.numel())
              + 4 * rois.numel() + 4 * count.numel())
    res.update(ms=res["fwd_ms"] + res["bwd_ms"],
               plain_ms=res["plain_fwd_ms"] + res["plain_bwd_ms"],
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    del feat, g, out, count, dx, dx2, out2, plain, pdx, abs_sum, flush
    torch.cuda.empty_cache()
    return res


def rcnn_bf16_checks(torch, mx, kernels, card, sym):
    """13d, the bfloat16 ROIPooling repair: roi_pool in bfloat16 and
    float16 at 13a's shape against the plain version, then
    RCNN_BF16_STEPS steps of 13a's Fast R-CNN under compute_dtype
    bfloat16 through the classic loop and the fused step from the same
    Xavier weights: one capture, params, losses and metric bit-equal,
    roi_pool 2 launches a step, every one in bfloat16."""
    batches = rcnn_batches(rcnn_scenes(RCNN_BF16_STEPS))
    rois = torch.from_numpy(batches[0]["rois"]).cuda()
    res = {name: roi_pool_16bit(torch, kernels, rois, dt)
           for name, dt in (("bfloat16", torch.bfloat16),
                            ("float16", torch.float16))}
    labels = [torch.from_numpy(b["label"]).cuda() for b in batches]
    zero = _zero_launches(kernels)
    runs = {}
    for fused in (False, True):
        mod = rcnn_module(mx, sym, RCNN_DATA, RCNN_LABELS, batches[0],
                          compute_dtype="bfloat16")
        run = rcnn_fit(torch, mx, kernels, mod,
                       ListIter(mx, batches, RCNN_DATA, RCNN_LABELS), fused,
                       rcnn_metric(mx),
                       lambda param, outs: labels[param.nbatch])
        run["records"] = kernels.launch_records().get("roi_pool", {})
        if fused:
            step = mod._fused_step
            run["counters"] = (step.eager_steps, step.captures,
                               step.dispatches)
        runs["fused" if fused else "classic"] = run
        del mod
        torch.cuda.empty_cache()
    classic, fused = runs["classic"], runs["fused"]
    check(classic["launches"] == dict(zero, conv_gemm=RCNN_K3_STEP
                                      * RCNN_BF16_STEPS,
                                      roi_pool=2 * RCNN_BF16_STEPS),
          "13d bf16 classic launches %s" % classic["launches"])
    check(fused["launches"] == dict(zero, conv_gemm=2 * RCNN_K3_STEP,
                                    roi_pool=4),
          "13d bf16 fused launches %s (the eager step and the capture)"
          % fused["launches"])
    check(classic["records"] == {"bfloat16": 2 * RCNN_BF16_STEPS}
          and fused["records"] == {"bfloat16": 4}, "13d: roi_pool launches "
          "by dtype %s / %s, want all bfloat16"
          % (classic["records"], fused["records"]))
    check(fused["counters"] == (1, 1, RCNN_BF16_STEPS - 1),
          "13d bf16 fused counters %s" % (fused["counters"],))
    check(all(np.isfinite(classic["losses"]).ravel()), "13d bf16 losses %s"
          % classic["losses"])
    _same_fit("13d bf16 fused against classic", fused, classic)
    res["fit"] = {k: {"losses": r["losses"], "launches": r["launches"],
                      "step_ms": r["step_ms"], "records": r["records"]}
                  for k, r in runs.items()}
    b, f = res["bfloat16"], res["float16"]
    print("13d roi_pool at (2, 512, %d, %d), %d rois, 7x7 in bf16 / f16: "
          "forward bit-equal to the plain version, gradient within %.3g / "
          "%.3g epsilons of the sum of its terms (bound %d), reruns "
          "bit-identical; forward %.4f / %.4f ms, backward %.4f / %.4f ms, "
          "plain %.3f + %.3f / %.3f + %.3f ms, bound %.4f ms  [%s]"
          % (RCNN_HW[0] // 16, RCNN_HW[1] // 16, len(rois),
             b["bwd_max_eps_of_abs_sum"], f["bwd_max_eps_of_abs_sum"],
             ROI_16_EPS, b["fwd_ms"], f["fwd_ms"], b["bwd_ms"], f["bwd_ms"],
             b["plain_fwd_ms"], b["plain_bwd_ms"], f["plain_fwd_ms"],
             f["plain_bwd_ms"], b["bound_ms"], card))
    print("13d Fast R-CNN under compute_dtype bfloat16, %d steps: fused "
          "bit-equal to classic (params, losses, metric), one capture, "
          "launches classic %s, fused %s, roi_pool by dtype %s; host step "
          "%.3f / %.3f ms  [%s]"
          % (RCNN_BF16_STEPS, classic["launches"], fused["launches"],
             classic["records"], classic["step_ms"], fused["step_ms"], card))
    return res


# ---------------------------------------------------------------------------
# phase 14: mixed precision and the adaptive serving plane: ResNet-50 NHWC
# trained and served in bfloat16
# ---------------------------------------------------------------------------
F16_FLOPS_PER_S = 989e12       # H100 SXM data sheet, dense bf16 and fp16
MP_DTYPE = "bfloat16"
MP_F16_STEPS = 3               # float16 batches through both loops
MP_GATE_LOSS_RTOL = 1e-2       # card vs CPU in bfloat16, batch 2: the loss
MP_GATE_NOISE = 2.0            # ... and the update, against bf16's own noise
MP_LADDER = (1, 2, 4, 8, 16, 32)
MP_SLO_MS = 50.0
MP_LANES = {"interactive": {"rows": (1, 4), "deadline_ms": 50.0},
            "batch": {"rows": (16, 16), "deadline_ms": 200.0}}
MP_PHASES = ((5.0, 800.0), (2.0, 3000.0))   # (seconds, images a second)
MP_POOL = 256                  # distinct seeded images the requests draw
MP_PROB_VS_F32 = 0.05          # served bf16 probabilities vs the f32 server
MP_PROB_VS_DIRECT = 0.02       # ... vs a direct bf16 forward of the rows
MP_DECISIVE = 0.1              # top-2 log-probability margin held to argmax
# phase 5's unsaturated weights: bounds relative to the largest probability
# (bf16 keeps 8 bits: each of ~50 layers rounds by 2^-9 relative, so a
# logit of magnitude a few moves by hundredths, a probability by percents;
# a bucket's other cuDNN algorithm moves it by less)
MP_REL_VS_F32 = 0.25
MP_REL_VS_DIRECT = 0.1
MP_REL_DECISIVE = 0.5


def _mm_f32_out(torch):
    """``torch.mm(a, b, out_dtype=torch.float32)`` where this torch has
    it (the one-call yardstick of a 16-bit product with a float32 result),
    else None."""
    a = torch.ones(2, 2, device="cuda", dtype=torch.bfloat16)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return None
    return lambda x, y: torch.mm(x, y, out_dtype=torch.float32)


def conv_gemm_timing16(torch, kernels, counts, dtype, reps=20):
    """K3 with 16-bit operands at the step's products beside the plain
    version (widened float32 products, TF32 off) and the nearest one-call
    yardstick (``torch.mm`` with a float32 output, else ``torch.matmul``
    in the 16-bit type, which rounds its output); the bound is the longer
    of 2MNK at the dense 16-bit rate and the bytes (2-byte operands read,
    the float32 result written) at the memory rate. Operands come as the
    convolution path gives them: an A whose rows are not a multiple of 8
    elements (the stem's 147) at the padded pitch ``_patches`` writes,
    read in place; ``pad_copy_ms`` is the copy (``kernels.pitched16``)
    that the same values, contiguous, would take in the wrapper."""
    flush = torch.empty(64 << 20, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    mm32 = _mm_f32_out(torch)
    lib_call = ("torch.mm(out_dtype=float32)" if mm32 is not None
                else "torch.matmul in %s" % dtype)
    rows_out = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
           "flops": 0}
    for (m, n, k, trans), cnt in sorted(counts.items()):
        a = torch.randn(*((k, m) if trans else (m, k)), generator=gen,
                        device="cuda").to(dtype)
        b = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        pad = None
        if a.shape[1] % 8:
            pad = time_ms(torch, lambda: kernels.pitched16(a), flush, reps)
            a = kernels.pitched16(a)
        at = a.t() if trans else a
        kernels.reset_launch_counts()
        kern = time_ms(torch, lambda: kernels.matmul_f32acc(a, b, trans),
                       flush, reps)
        check(kernels.conv_gemm_pad_copies == 0, "conv_gemm %s %s: the "
              "wrapper copied an operand the conv path lays out"
              % ((m, n, k, trans), dtype))
        plain = time_ms(torch, lambda: kernels.matmul_f32acc_plain(
            a, b, trans), flush, reps)
        lib = time_ms(torch, (lambda: mm32(at, b)) if mm32 is not None
                      else (lambda: torch.matmul(at, b)), flush, reps)
        nbytes = (m * k + k * n) * 2 + m * n * 4
        flops = 2 * m * n * k
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F16_FLOPS_PER_S)
        rows_out.append({"m": m, "n": n, "k": k, "transpose_a": trans,
                         "per_step": cnt, "ms": kern, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound,
                         "tflops": flops / kern / 1e9,
                         "share_of_bound": bound / kern,
                         "pad_copy_ms": pad})
        print("  conv_gemm %s (%6d, %4d, %6d, %s) x%-2d kernel %.4f ms  "
              "%s %.4f ms  bound %.4f ms  %.1f TFLOP/s  %.2f of the bound%s"
              % (str(dtype).replace("torch.", ""), m, n, k,
                 "T" if trans else "N", cnt, kern,
                 "torch.mm" if mm32 is not None else "torch.matmul", lib,
                 bound, flops / kern / 1e9, bound / kern,
                 "" if pad is None else "  (padded copy %.4f ms)" % pad))
        tot["ms"] += cnt * kern
        tot["plain_ms"] += cnt * plain
        tot["library_ms"] += cnt * lib
        tot["bytes"] += cnt * nbytes
        tot["flops"] += cnt * flops
        del a, b, at
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S
    t_flops = tot["flops"] / F16_FLOPS_PER_S
    tot["bound_ms"] = 1e3 * max(t_bytes, t_flops)
    tot["bound_by"] = "operations" if t_flops >= t_bytes else "bytes"
    tot["library_call"] = lib_call
    return rows_out, tot


def _typed_launches(torch, kernels, names, dtype):
    """The compiled kernels' launches among profiler kernel ``names``,
    and how many of the K3/K4/K5 ones ran their ``dtype`` instantiation
    (conv_gemm_kernel<__nv_bfloat16|__half, ...>, norm_act's
    Half16<false|true>)."""
    tags = {torch.bfloat16: ("__nv_bfloat16", "Half16<false>"),
            torch.float16: ("__half", "Half16<true>")}[dtype]
    typed = {"conv_gemm": 0, "norm_act_fwd": 0, "norm_act_bwd": 0}
    for name in names:
        counted = kernels.launches_in([name])
        for key in typed:
            if counted[key] and any(t + "," in name or t + ">" in name
                                    for t in tags):
                typed[key] += 1
    return kernels.launches_in(names), typed


def _mp_profile(torch, mx, kernels, step, metric, images, labels, dtype):
    """fused_breakdown of two replays, with the kernel events' names
    kept to check the typed instantiations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    res = fused_breakdown(torch, mx, kernels, step, metric, images, labels)
    batch = mx.io.DataBatch([images], [labels])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step.step(batch, metric)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    res["typed_launches"] = _typed_launches(torch, kernels, names, dtype)[1]
    return res


def _mp_dtype_ok(kernels, steps, dtype_name):
    """Every K3/K4/K5 launch a fit's wrappers counted ran ``dtype_name``
    operands."""
    rec = kernels.launch_records()
    want = _resnet_launches(steps)
    return all(rec.get(k, {}) == {dtype_name: want[k]}
               for k in ("conv_gemm", "norm_act_fwd", "norm_act_bwd")), rec


def mp_fit(torch, mx, kernels, dtype, fused, steps, images, labels):
    """fit_module of ResNet-50 NHWC at batch 32 from train_module's seed-0
    weights under ``compute_dtype=dtype``, checked: the launches of every
    step (classic) or of the eager step and the capture (fused), each
    with ``dtype`` operands; finite losses; every param and moving
    statistic changed; params, gradients and aux float32."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0, compute_dtype=dtype)
    args0, aux0 = (_host(p) for p in mod.get_params())
    run = fit_module(torch, mx, kernels, mod, images[:steps * BATCH],
                     labels[:steps * BATCH], fused)
    counted = 2 if fused else steps
    loop = "%s %s" % (dtype, "fused" if fused else "classic")
    ok, rec = _mp_dtype_ok(kernels, counted, dtype)
    print("phase 14 %s: %d steps, launches by dtype %s, losses %s"
          % (loop, steps, rec, ["%.4f" % v for v in run["losses"]]))
    check(ok, "%s launches by dtype %s, want 105/53/53 a step of %s"
          % (loop, rec, dtype))
    check(kernels.conv_gemm_pad_copies == 0, "%s: %d padded copies of K3 "
          "operands (the conv path lays them out at a readable pitch)"
          % (loop, kernels.conv_gemm_pad_copies))
    check(all(np.isfinite(run["losses"])), "%s losses %s"
          % (loop, run["losses"]))
    unchanged = [k for k in args0 if np.array_equal(args0[k],
                                                    run["args"][k])]
    check(not unchanged, "%s: params unchanged: %s" % (loop, unchanged))
    stale = [k for k in aux0 if np.array_equal(aux0[k], run["aux"][k])]
    check(not stale, "%s: moving statistics unchanged: %s" % (loop, stale))
    ex = mod._exec_group.executor
    dtypes = {str(a.handle.dtype) for a in
              ex.arg_arrays + [g for g in ex.grad_arrays if g is not None]
              + ex.aux_arrays}
    check(dtypes == {"torch.float32"}, "%s: params/grads/aux in %s"
          % (loop, dtypes))
    return run


def mp_gate(mx, images, labels):
    """One classic bfloat16 step at batch 2 on the card against the port
    on the CPU in bfloat16, same params and data, with the CPU's float32
    step beside them: the loss within rtol MP_GATE_LOSS_RTOL, and the
    card's whole update (every param's, end to end) no further from the
    CPU's bfloat16 update than MP_GATE_NOISE times the CPU's own
    bfloat16-to-float32 distance. A fixed fraction cannot be held: at
    batch 2 a random ResNet-50's step is chaotic (a stage-3 BatchNorm
    sees 98 rows a channel; phase 6's gate lowers the residual gammas
    for it in float32), and 16-bit rounding feeds that chaos 2^16 times
    more than float32 does (the first run: 0.24 of the update's norm
    whole, 0.51 at the stem's BatchNorm gamma, loss equal to 7 digits).
    The per-tensor worst is printed."""
    res = []
    t0 = time.perf_counter()
    for ctx, dtype in ((mx.gpu(0), MP_DTYPE), (mx.cpu(), MP_DTYPE),
                       (mx.cpu(), None)):
        mod = gate_module(mx, ctx, compute_dtype=dtype)
        before = _host(mod.get_params()[0])
        mod.init_optimizer(optimizer="sgd", optimizer_params=TRAIN_OPT)
        mod.forward_backward(mx.io.DataBatch([images[:2]], [labels[:2]]))
        mod.update()
        probs = mod.get_outputs()[0].asnumpy().astype(np.float64)
        loss = float(-np.log(probs[np.arange(2),
                                   labels[:2].astype(int)]).mean())
        after = _host(mod.get_params()[0])
        res.append((loss, {k: after[k] - before[k] for k in after}))
    (lg, ug), (lc, uc), (l32, u32) = res

    def dist(a, b):
        return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2.0) for k in b)))

    norm = float(np.sqrt(sum(np.sum(uc[k] ** 2.0) for k in uc)))
    whole, noise = dist(ug, uc) / norm, dist(uc, u32) / norm
    worst = max((float(np.linalg.norm(ug[k] - uc[k])
                        / max(np.linalg.norm(uc[k]), 1e-30)), k)
                for k in uc if np.linalg.norm(uc[k]) > 0)
    print("phase 14c gate (batch 2): loss card bf16 %.6f, CPU bf16 %.6f, "
          "CPU f32 %.6f; update card vs CPU bf16 %.3g of its norm, CPU bf16 "
          "vs f32 %.3g (bound: %g x that), worst tensor %.3g at %s, %.1f s"
          % (lg, lc, l32, whole, noise, MP_GATE_NOISE, worst[0], worst[1],
             time.perf_counter() - t0))
    check(abs(lg - lc) <= MP_GATE_LOSS_RTOL * abs(lc),
          "bf16 loss %g on the card, %g on the CPU" % (lg, lc))
    check(whole <= MP_GATE_NOISE * noise, "bf16 update off by %g of its "
          "norm, %g x the CPU's bf16-to-f32 distance" % (whole,
                                                        whole / noise))
    return {"loss_card": lg, "loss_cpu": lc, "loss_cpu_f32": l32,
            "whole_update": whole, "bf16_vs_f32": noise,
            "worst_update": worst[0], "worst_param": worst[1]}


def mp_train_path(torch, mx, kernels, card, images, labels, f32_classic,
                  f32_fused):
    """14c: phase 6's fit under compute_dtype bfloat16, classic then
    fused from the same weights; the card-vs-CPU gate; float16 fused
    against classic."""
    classic = mp_fit(torch, mx, kernels, MP_DTYPE, False, TRAIN_STEPS,
                     images, labels)
    classic["breakdown"] = train_breakdown(
        torch, mx, kernels, classic.pop("mod"), images[:BATCH],
        labels[:BATCH])
    check_profiled_launches("phase 14 bf16 classic", classic["breakdown"])
    fused = mp_fit(torch, mx, kernels, MP_DTYPE, True, TRAIN_STEPS, images,
                   labels)
    mod = fused.pop("mod")
    step = mod._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": TRAIN_STEPS - 1},
          "bf16 fused counters %s" % counters)
    _same_run("bf16 fused vs classic", fused, classic)
    fused["breakdown"] = _mp_profile(torch, mx, kernels, step,
                                     fused["metric"], images[:BATCH],
                                     labels[:BATCH], torch.bfloat16)
    check_profiled_launches("phase 14 bf16 fused", fused["breakdown"])
    typed = fused["breakdown"]["typed_launches"]
    check(typed == {k: v for k, v in _resnet_launches(2).items()
                    if k in typed},
          "bf16 replays ran %s bfloat16 K3/K4/K5 instantiations, want "
          "105/53/53 a replay" % typed)
    for run in (classic, fused):
        run.pop("metric", None)
        del run["args"], run["aux"]
    for loop, run, ref in (("classic", classic, f32_classic),
                           ("fused", fused, f32_fused)):
        print("phase 14c %s, ResNet-50 NHWC batch 32, bf16 / f32: host step "
              "%.3f / %.3f ms, %.1f / %.1f img/s, device %.3f / %.3f ms a "
              "step, busy %.1f%% / %.1f%%, peak %.3f / %.3f GB  [%s]"
              % (loop, run["step_ms"], ref["step_ms"], run["img_per_s"],
                 ref["img_per_s"], run["breakdown"]["device_ms_per_step"],
                 ref["breakdown"]["device_ms_per_step"],
                 100 * run["breakdown"]["busy_share"],
                 100 * ref["breakdown"]["busy_share"],
                 run["peak_bytes"] / 1e9, ref["peak_bytes"] / 1e9, card))
    groups = sorted(set(fused["breakdown"]["by_group_ms"])
                    | set(f32_fused["breakdown"]["by_group_ms"]))
    for g in groups:
        print("  %-30s bf16 %.4f / f32 %.4f ms a replay"
              % (g, fused["breakdown"]["by_group_ms"].get(g, 0.0),
                 f32_fused["breakdown"]["by_group_ms"].get(g, 0.0)))
    for label, run in (("bf16", fused), ("f32", f32_fused)):
        for k in run["breakdown"].get("top_kernels", [])[:12]:
            print("    %s top: %.4f ms  %s" % (label, k["ms_per_step"],
                                              k["name"][:110]))
    gate = mp_gate(mx, images, labels)
    f16c = mp_fit(torch, mx, kernels, "float16", False, MP_F16_STEPS,
                  images, labels)
    f16f = mp_fit(torch, mx, kernels, "float16", True, MP_F16_STEPS,
                  images, labels)
    check(f16f["mod"]._fused_step.captures == 1, "f16 fused: captures %d"
          % f16f["mod"]._fused_step.captures)
    _same_run("f16 fused vs classic", f16f, f16c)
    print("phase 14c float16: %d steps fused bit-equal to classic, one "
          "capture, losses %s" % (MP_F16_STEPS, ["%.4f" % v for v in
                                                 f16f["losses"]]))
    f16 = {"classic_launches": f16c["launches"],
           "fused_launches": f16f["launches"], "losses": f16f["losses"],
           "step_ms": {"classic": f16c["step_ms"], "fused": f16f["step_ms"]}}
    return {"classic": classic, "fused": fused, "counters": counters,
            "gate": gate, "float16": f16, "mod": mod}


def _poisson_arrivals(rng, seconds, img_rate):
    """Open-loop arrivals of both lanes over ``seconds`` at ``img_rate``
    images a second, half of them from each lane: (t, lane, rows)."""
    out = []
    for lane, spec in MP_LANES.items():
        lo, hi = spec["rows"]
        rate = 0.5 * img_rate / ((lo + hi) / 2.0)
        t = rng.exponential(1.0 / rate)
        while t < seconds:
            out.append((t, lane, int(rng.randint(lo, hi + 1))))
            t += rng.exponential(1.0 / rate)
    return sorted(out)


def mp_serve_path(torch, mx, kernels, card, trained):
    """14d: the trained bf16 ResNet-50 behind InferenceServer (ladder
    1-32, adaptive, SLO 50 ms), seeded open-loop Poisson traffic in two
    lanes from two client threads; the phase's checks."""
    args, aux = trained.get_params()
    arg_np = {k: v.asnumpy() for k, v in args.items()}
    aux_np = {k: v.asnumpy() for k, v in aux.items()}
    mod = build_module(mx, mx.gpu(0), BATCH, arg_np, aux_np,
                       compute_dtype=MP_DTYPE)
    rng = np.random.RandomState(14)
    pool = rng.randn(MP_POOL, *IMAGE).astype(np.float32)
    # direct forwards of every pool row: bf16 and f32, batch 32
    ex = mod._exec_group.executor
    direct = np.concatenate([ex.forward(data=pool[i:i + BATCH])[0].asnumpy()
                             for i in range(0, MP_POOL, BATCH)])
    ref32 = build_module(mx, mx.gpu(0), BATCH, arg_np, aux_np)
    with mx.serving.InferenceServer(ref32, top_k=0, max_batch=BATCH,
                                    buckets=MP_LADDER, adaptive=False) as s32:
        f32 = np.concatenate([s32.infer([pool[i:i + BATCH]], timeout=300)[0]
                              for i in range(0, MP_POOL, BATCH)])
    srv = mx.serving.InferenceServer(mod, top_k=0, max_batch=BATCH,
                                     buckets=MP_LADDER, slo_ms=MP_SLO_MS,
                                     adaptive=True)
    sched = srv.scheduler
    shed_violations = []
    plain_shed = sched._maybe_shed

    def watched_shed(now):
        # the order guarantee: no interactive request is shed while an
        # expired batch-lane request stays pending
        before = {id(r): r for r in sched._pending}
        plain_shed(now)
        kept = {id(r) for r in sched._pending}
        shed = [r for k, r in before.items() if k not in kept]
        if any(r.priority == "interactive" for r in shed) and any(
                r.priority == "batch" and r.t_deadline is not None
                and now > r.t_deadline for r in sched._pending):
            shed_violations.append(now)

    sched._maybe_shed = watched_shed
    try:
        for rung in MP_LADDER:   # warm each bucket: libraries, cuDNN picks
            srv.infer([pool[:rung]], timeout=300)
        warm = sched.occupancy_snapshot()
        dispatches0 = srv._fused.dispatches
        traj0 = len(sched.wait_trajectory())
        arrivals = _poisson_arrivals(np.random.RandomState(15),
                                     MP_PHASES[0][0], MP_PHASES[0][1])
        arrivals += [(t + MP_PHASES[0][0], lane, rows) for t, lane, rows in
                     _poisson_arrivals(np.random.RandomState(16),
                                       MP_PHASES[1][0], MP_PHASES[1][1])]
        reqs = {lane: [] for lane in MP_LANES}
        kernels.reset_launch_counts()
        t_start = time.perf_counter()

        def client(lane):
            pick = np.random.RandomState(17 + len(lane))
            for t, l, rows in arrivals:
                if l != lane:
                    continue
                delay = t_start + t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                i = int(pick.randint(0, MP_POOL - rows + 1))
                reqs[lane].append((t, i, sched.submit(
                    [pool[i:i + rows]],
                    deadline_ms=MP_LANES[lane]["deadline_ms"],
                    priority=lane)))

        threads = [threading.Thread(target=client, args=(lane,))
                   for lane in MP_LANES]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        check(not any(th.is_alive() for th in threads), "a client hung")
        for lane in reqs:
            for _, _, r in reqs[lane]:
                r._done.wait(300)
        wall = time.perf_counter() - t_start
        launches = kernels.launch_counts()
        records = kernels.launch_records()
        stats = srv.stats()
        traj = sched.wait_trajectory()[traj0:]
        occ = sched.occupancy_snapshot()
        dispatches = srv._fused.dispatches - dispatches0
    finally:
        sched._maybe_shed = plain_shed
    # checks
    batches = occ["batches"] - warm["batches"]
    check(dispatches == batches, "%d dispatches for %d batches"
          % (dispatches, batches))
    check({t["bucket"] for t in traj} <= set(MP_LADDER),
          "off-ladder buckets %s" % sorted({t["bucket"] for t in traj}))
    check(srv.compiles <= len(MP_LADDER), "%d batch shapes" % srv.compiles)
    check(launches["norm_act_fwd"] == BN_LAYERS * batches
          and records.get("norm_act_fwd") == {MP_DTYPE: BN_LAYERS * batches},
          "serving launches %s (%s) for %d batches" % (launches, records,
                                                       batches))
    check(not shed_violations, "an interactive request was shed while an "
          "expired batch-lane request was pending (%d times)"
          % len(shed_violations))
    lane_out = {}
    worst_direct = worst_f32 = 0.0
    decisive = agree = 0
    for lane, items in reqs.items():
        lat, served, shed = [], 0, 0
        for _, i, r in items:
            if isinstance(r.error, mx.serving.RequestShed):
                shed += 1
                continue
            check(r.error is None, "request failed: %r" % r.error)
            served += 1
            lat.append(r.latency_ms)
            probs = r.result[0]
            want = direct[i:i + r.rows]
            check(np.all(np.isfinite(probs)), "non-finite probabilities")
            worst_direct = max(worst_direct,
                               float(np.abs(probs - want).max()))
            worst_f32 = max(worst_f32, float(np.abs(
                probs - f32[i:i + r.rows]).max()))
            with np.errstate(divide="ignore"):
                top2 = np.log(np.sort(want, axis=1)[:, -2:].astype(
                    np.float64))
            sure = top2[:, 1] - top2[:, 0] > MP_DECISIVE
            decisive += int(sure.sum())
            agree += int((probs.argmax(1) == want.argmax(1))[sure].sum())
        comps = {}
        for _, _, r in items:
            for k, v in (r.components or {}).items():
                comps.setdefault(k, []).append(v)
        lane_out[lane] = {
            "requests": len(items), "served": served, "shed": shed,
            "p50_ms": float(np.percentile(lat, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat, 99)) if lat else None,
            "components_p50_ms": {k: float(np.median(v))
                                  for k, v in comps.items()}}
    rows_served = occ["served"] - warm["served"]
    reasons = {}
    for t in traj:
        reasons[t["reason"]] = reasons.get(t["reason"], 0) + 1
    print("phase 14d serving, bf16 ResNet-50 NHWC, ladder %s, SLO %.0f ms, "
          "adaptive: %.1f s, %d rows served (%.1f img/s), %d batches, mean "
          "occupancy %.3f, reasons %s, controller %s  [%s]"
          % (list(MP_LADDER), MP_SLO_MS, wall, rows_served,
             rows_served / wall, batches,
             (occ["occ_sum"] - warm["occ_sum"]) / max(batches, 1), reasons,
             sched.controller_state(), card))
    for lane, st in lane_out.items():
        print("  lane %-11s %5d requests, %5d served, %4d shed, p50 %s ms, "
              "p99 %s ms; component medians %s"
              % (lane, st["requests"], st["served"], st["shed"],
                 st["p50_ms"], st["p99_ms"],
                 {k: round(v, 3) for k, v in
                  st["components_p50_ms"].items()}))
    print("  served vs direct bf16 forward: max abs %.3g (bound %g); vs the "
          "f32 server: max abs %.3g (bound %g); argmax equal on %d of %d "
          "decisive rows (top-2 log-probability margin > %g)"
          % (worst_direct, MP_PROB_VS_DIRECT, worst_f32, MP_PROB_VS_F32,
             agree, decisive, MP_DECISIVE))
    check(worst_direct <= MP_PROB_VS_DIRECT, "served probabilities %g off "
          "the direct bf16 forward" % worst_direct)
    check(worst_f32 <= MP_PROB_VS_F32, "served probabilities %g off the "
          "f32 server's" % worst_f32)
    check(decisive > 0 and agree == decisive, "argmax equal on %d of %d "
          "decisive rows" % (agree, decisive))
    # delta refresh from a snapshot: seed, change one param, refresh
    payload = mx.checkpoint.snapshot(trained)
    srv.refresh_from_snapshot(payload)
    fused = srv._fused
    seeded = fused.last_refresh_changed
    ptrs = [t.data_ptr() for t in fused._param_vals]
    compiles = srv.compiles
    name = "fc1_weight" if "fc1_weight" in payload["params"] else sorted(
        payload["params"])[-1]
    new = dict(payload)
    new["params"] = dict(payload["params"])
    new["params"][name] = payload["params"][name] * np.float32(1.5)
    new["param_digests"] = dict(payload["param_digests"])
    new["param_digests"][name] = mx.checkpoint.param_digest(
        new["params"][name])
    srv.refresh_from_snapshot(new)
    changed, moved = fused.last_refresh_changed, fused.last_refresh_bytes
    srv.infer([pool[:1]], timeout=300)
    srv.close()
    pos = [mod._exec_group.executor.arg_names[i]
           for i in fused._p_idx].index(name)
    check(srv._fused is fused and changed == 1
          and moved == new["params"][name].nbytes
          and [t.data_ptr() for t in fused._param_vals] == ptrs
          and srv.compiles == compiles,
          "refresh: changed %d (want 1), %d bytes, packed tensors kept %s, "
          "batch shapes %d -> %d" % (changed, moved, [t.data_ptr() for t in
                                                    fused._param_vals] ==
                                     ptrs, compiles, srv.compiles))
    check(np.array_equal(fused._param_vals[pos].cpu().numpy(),
                         new["params"][name]),
          "the served pack does not hold the refreshed %s" % name)
    print("  refresh_from_snapshot: seeded %d params, then 1 changed param "
          "(%s, %d bytes) copied in place, no new batch shape"
          % (seeded, name, moved))
    return {"lanes": lane_out, "wall_s": wall, "rows_served": rows_served,
            "img_per_s": rows_served / wall, "batches": batches,
            "reasons": reasons, "mean_occupancy":
                (occ["occ_sum"] - warm["occ_sum"]) / max(batches, 1),
            "controller": sched.controller_state(), "launches": launches,
            "launch_records": records, "stats": stats,
            "max_abs_vs_direct": worst_direct, "max_abs_vs_f32": worst_f32,
            "decisive_rows": decisive, "refresh_seeded": seeded,
            "trajectory": traj}


def mp_serve_parity(mx):
    """The bf16 server's probabilities where they are not saturated:
    phase 5's seeded weights (the trained model's outputs are one-hot to
    float32, so there the comparisons below hold trivially). Requests of
    1-32 rows over seeded images through a bf16 InferenceServer (ladder
    1-32) against a direct bf16 Executor.forward of the same rows (batch
    32) within MP_REL_VS_DIRECT of the largest probability, and against
    an f32 server within MP_REL_VS_F32 of it; argmax equal where the
    direct forward's top-2 log-probability margin exceeds
    MP_REL_DECISIVE."""
    rng = np.random.RandomState(18)
    pool = rng.randn(BATCH * 4, *IMAGE).astype(np.float32)
    mod16 = build_module(mx, mx.gpu(0), BATCH, compute_dtype=MP_DTYPE)
    ex = mod16._exec_group.executor
    direct = np.concatenate([ex.forward(data=pool[i:i + BATCH])[0].asnumpy()
                             for i in range(0, len(pool), BATCH)])
    args, aux = mod16.get_params()
    mod32 = build_module(mx, mx.gpu(0), BATCH,
                         {k: v.asnumpy() for k, v in args.items()},
                         {k: v.asnumpy() for k, v in aux.items()})
    got = {}
    for name, mod in (("bf16", mod16), ("f32", mod32)):
        with mx.serving.InferenceServer(mod, top_k=0, max_batch=BATCH,
                                        buckets=MP_LADDER,
                                        adaptive=False) as srv:
            parts, off = [], 0
            for rows in (1, 3, 8, 17, 32, 32, 32, 2):
                rows = min(rows, BATCH, len(pool) - off)
                if rows <= 0:
                    break
                parts.append(srv.infer([pool[off:off + rows]],
                                       timeout=300)[0])
                off += rows
            got[name] = np.concatenate(parts)
    n = len(got["bf16"])
    top = float(got["f32"].max())
    vs_direct = float(np.abs(got["bf16"] - direct[:n]).max()) / top
    vs_f32 = float(np.abs(got["bf16"] - got["f32"]).max()) / top
    with np.errstate(divide="ignore"):
        top2 = np.log(np.sort(direct[:n], axis=1)[:, -2:].astype(
            np.float64))
    sure = top2[:, 1] - top2[:, 0] > MP_REL_DECISIVE
    agree = int((got["bf16"].argmax(1) == direct[:n].argmax(1))[sure].sum())
    print("phase 14d probabilities, phase 5's weights (largest %.3g): bf16 "
          "served vs direct bf16 forward max abs %.3g of the largest (bound "
          "%g), vs the f32 server %.3g (bound %g); argmax equal on %d of %d "
          "rows whose top-2 log-probability margin exceeds %g"
          % (top, vs_direct, MP_REL_VS_DIRECT, vs_f32, MP_REL_VS_F32, agree,
             int(sure.sum()), MP_REL_DECISIVE))
    check(vs_direct <= MP_REL_VS_DIRECT, "bf16 served probabilities %g "
          "(of the largest) off the direct forward" % vs_direct)
    check(vs_f32 <= MP_REL_VS_F32, "bf16 served probabilities %g (of the "
          "largest) off the f32 server's" % vs_f32)
    check(agree == int(sure.sum()), "argmax differs on %d decisive rows"
          % (int(sure.sum()) - agree))
    return {"vs_direct_of_largest": vs_direct, "vs_f32_of_largest": vs_f32,
            "decisive_rows": int(sure.sum()), "rows": n,
            "largest_probability": top}


def mixed_precision_main_path(torch, mx, kernels, card, images, labels,
                              f32_classic, f32_fused, gemms):
    """Phase 14: (a) K3's 16-bit products over the step, timed; (c)
    training in bf16 and f16; (d) serving the trained bf16 model."""
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).replace("torch.", "")
        rows, tot = conv_gemm_timing16(torch, kernels, gemms, dtype)
        out["k3_" + name] = {"shapes": rows, "total": tot}
        print("phase 14a conv_gemm per step (105 launches, %s): kernel %.4f "
              "ms, plain %.4f ms, %s %.4f ms, bound %.4f ms (%s), %.1f "
              "TFLOP  [%s]" % (name, tot["ms"], tot["plain_ms"],
                               tot["library_call"], tot["library_ms"],
                               tot["bound_ms"], tot["bound_by"],
                               tot["flops"] / 1e12, card))
    train = mp_train_path(torch, mx, kernels, card, images, labels,
                          f32_classic, f32_fused)
    out["train"] = train
    out["serve"] = mp_serve_path(torch, mx, kernels, card, train.pop("mod"))
    out["serve"]["parity_untrained"] = mp_serve_parity(mx)
    return out


# ---------------------------------------------------------------------------
# phase 15: the input plane: ResNet-50 trained from the uint8 decoded-image
# cache, the crop and normalisation inside the fused step's CUDA graph
# ---------------------------------------------------------------------------
FEED_FRAMES = 1024             # seeded 256x256x3 frames in the cache: 201 MB
FEED_STORE = 256               # the store: the 224 crop plus its margin
FEED_CROP = 224
FEED_MEAN = (123.68, 116.779, 103.939)   # examples/image_classification
FEED_DEPTH = 2                 # MXNET_TPU_FEED_DEPTH of every phase-15 fit
FEED_PARITY_STEPS = 4          # fused against classic after this many steps
FEED_MODE_STEPS = 8            # 15c's fits in the other modes
FEED_SNAPSHOT_STEP = 5         # 15d: the snapshot's step


class Take:
    """The first ``n`` batches of each epoch of ``base``; the checkpoint
    state is the base's, and a seek counts the batches it consumed."""

    def __init__(self, base, n):
        self.base, self.n, self.batch_size = base, n, base.batch_size
        self._k = 0

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    def reset(self):
        self.base.reset()
        self._k = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._k >= self.n:
            raise StopIteration
        self._k += 1
        return self.base.next()

    next = __next__

    def get_checkpoint_state(self):
        return self.base.get_checkpoint_state()

    def set_checkpoint_state(self, state):
        self._k = int(state.get("batches", 0))
        self.base.set_checkpoint_state(state)


def write_feed_cache(prefix, seed=0):
    """FEED_FRAMES seeded uint8 frames of FEED_STORE^2 x 3 with labels
    0-999 in the decoded cache's layout (mxnet_tpu_torch/io_cache.py):
    what build_decoded_cache writes, without the JPEG decode (PIL), which
    the card's machine lacks (tools/torch_dp_feed_check.py's writer)."""
    _tools_module("torch_dp_feed_check").write_cache(
        prefix, FEED_FRAMES, FEED_STORE, seed)


def feed_iter(mx, prefix, mode):
    """The cached iterator of train_imagenet.py's recipe (random crops
    and mirrors, the upstream means), NHWC, seed 0: ``mode`` "feed"
    (device_feed), "augment" (device_augment) or "host" (host crops,
    normalised on the card)."""
    flags = {"feed": {"device_feed": True}, "augment": {"device_augment": True},
             "host": {"device_feed": False}}[mode]
    with mx.gpu(0):
        return mx.io_cache.CachedImageRecordIter(
            prefix, (3, FEED_CROP, FEED_CROP), BATCH, shuffle=True,
            rand_crop=True, rand_mirror=True, seed=0, output_layout="NHWC",
            mean_r=FEED_MEAN[0], mean_g=FEED_MEAN[1], mean_b=FEED_MEAN[2],
            **flags)


def feed_fit(torch, mx, kernels, it, fused, after_batch=None, env=()):
    """Module.fit of ResNet-50 NHWC (train_module's seed-0 weights, phase
    6's SGD) over ``it`` on the card with MXNET_TPU_FEED_DEPTH=FEED_DEPTH
    and the variables ``env`` (pairs), telemetry on, launch counts zeroed
    just before and read just after. Per step: the loss of the forward's
    probabilities against the batch's labels and the host clock at the
    batch-end callback, the card synchronised; then ``after_batch(param,
    mod)``."""
    tel = mx.telemetry
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    losses, marks = [], []

    def on_batch(param):
        probs = param.locals["self"].get_outputs()[0].handle
        lab = param.locals["data_batch"].label[0].handle.to(probs.device,
                                                            torch.int64)
        losses.append(-torch.log(probs.gather(1, lab[:, None])).mean())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if after_batch is not None:
            after_batch(param, mod)

    env = dict(env, MXNET_TPU_FEED_DEPTH=str(FEED_DEPTH))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    mx.random.seed(0)
    tel.reset()
    tel.enable()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=TRAIN_OPT,
                eval_metric=mx.metric.Accuracy(),
                batch_end_callback=on_batch, fused_step=fused)
        launches = kernels.launch_counts()
        stall = (tel.peek("io.feed_stall_ms", "hist_sum") or 0.0,
                 tel.peek("io.feed_stall_ms") or 0)
        h2d = tel.peek("ndarray.h2d_bytes") or 0
        feed_batches = tel.peek("step.fused_feed_batches") or 0
        restores = tel.peek("ckpt.restores") or 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tel.disable()
        tel.reset()
    steps_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    step_ms = float(np.median(steps_ms))
    run = {"mod": mod, "launches": launches,
           "losses": [float(v) for v in losses], "steps_ms": steps_ms,
           "step_ms": step_ms, "img_per_s": BATCH * 1e3 / step_ms,
           "stall_ms_sum": stall[0], "stall_count": stall[1],
           "h2d_bytes": h2d, "feed_batches": feed_batches,
           "restores": restores}
    run["args"], run["aux"] = (_host(p) for p in mod.get_params())
    if fused:
        step = mod._fused_step
        run["counters"] = (step.eager_steps, step.captures, step.dispatches)
    return run


def crop_norm_timing(torch, kernels, card):
    """15a: crop_norm at ResNet-50's feed, (32, 256, 256, 3) uint8 cut to
    224, seeded offsets, half the rows mirrored, the upstream means: bit-
    equal to the plain version in both layouts; the kernel's time (CUDA
    events, L2 flushed) beside the plain version's and the byte bound
    (the crops read as uint8, the batch written as float32)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (BATCH, FEED_STORE, FEED_STORE, 3),
                      dtype=torch.uint8, device="cuda", generator=gen)
    margin = FEED_STORE - FEED_CROP + 1
    tops = torch.randint(0, margin, (BATCH,), dtype=torch.int32,
                         device="cuda", generator=gen)
    lefts = torch.randint(0, margin, (BATCH,), dtype=torch.int32,
                          device="cuda", generator=gen)
    mirror = torch.arange(BATCH, device="cuda") % 2 == 0
    mean = torch.tensor(FEED_MEAN, device="cuda")
    scale = torch.ones(1, device="cuda")
    args = (x, tops, lefts, mirror, mean, scale, (FEED_CROP, FEED_CROP))
    flush = torch.empty(64 << 20, device="cuda")
    res = {}
    for layout in ("NHWC", "NCHW"):
        got = kernels.crop_norm(*args, layout)
        again = kernels.crop_norm(*args, layout)
        want = kernels.crop_normalize_plain(*args, layout)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, again),
              "15a crop_norm %s differs from the plain version (max abs err "
              "%g)" % (layout, float((got - want).abs().max())))
        res[layout] = {
            "ms": time_ms(torch, lambda: kernels.crop_norm(*args, layout),
                          flush),
            "plain_ms": time_ms(torch, lambda: kernels.crop_normalize_plain(
                *args, layout), flush)}
    crop = BATCH * FEED_CROP * FEED_CROP * 3
    nbytes = crop + 4 * crop + 4 * (3 * BATCH + 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    del x, flush
    torch.cuda.empty_cache()
    out = dict(res["NHWC"], bound_ms=bound, bound_by="bytes", bytes=nbytes,
               nchw_ms=res["NCHW"]["ms"], nchw_plain_ms=res["NCHW"]["plain_ms"],
               max_abs_err=0.0)
    print("15a crop_norm %s uint8 -> %d crops, half mirrored: bit-equal "
          "to the plain version in NHWC and NCHW; NHWC %.4f ms (plain "
          "%.4f), NCHW %.4f ms (plain %.4f), bound %.4f ms (%d bytes at "
          "3.35 TB/s)  [%s]"
          % ((BATCH, FEED_STORE, FEED_STORE, 3), FEED_CROP, out["ms"],
             out["plain_ms"], out["nchw_ms"], out["nchw_plain_ms"], bound,
             nbytes, card))
    return out


def feed_main_path(torch, mx, kernels, card, resident):
    """Phase 15: (a) crop_norm against its plain version and timed; (b)
    ResNet-50 NHWC trained for one epoch from a uint8 cache through
    fit(fused_step=True), the crop and normalisation inside the graph,
    against the classic loop; (c) the same fit in device_augment and
    host-crop mode; (d) a snapshot after step FEED_SNAPSHOT_STEP resumed
    in a fresh iterator and module. ``resident`` is phase 6's fused run
    (device-resident float32 batches), whose img/s the fed rate is read
    against."""
    res = {"crop_norm": crop_norm_timing(torch, kernels, card)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_feed_")
    try:
        prefix = os.path.join(tmp, "imagenet")
        t0 = time.perf_counter()
        write_feed_cache(prefix)
        write_s = time.perf_counter() - t0
        # (b) one epoch through the fused step, the params after
        # FEED_PARITY_STEPS kept for the classic loop's
        kept = {}

        def keep(param, mod):
            if param.nbatch == FEED_PARITY_STEPS - 1:
                kept["args"], kept["aux"] = (_host(p) for p in
                                             mod.get_params())

        fed = feed_fit(torch, mx, kernels, feed_iter(mx, prefix, "feed"),
                       True, keep)
        steps = FEED_FRAMES // BATCH
        check(len(fed["losses"]) == steps and all(np.isfinite(fed["losses"])),
              "15b losses %s" % fed["losses"])
        check(fed["counters"] == (1, 1, steps - 1), "15b fused counters %s, "
              "want one eager step, one capture, a replay a batch after"
              % (fed["counters"],))
        want = dict(_resnet_launches(2), rtc=0, crop_norm=2)
        check(fed["launches"] == want, "15b launches %s, want %s (the eager "
              "step and the capture)" % (fed["launches"], want))
        check(fed["feed_batches"] == steps, "15b step.fused_feed_batches %s"
              % fed["feed_batches"])
        f32_batch = BATCH * FEED_CROP * FEED_CROP * 3 * 4
        h2d_batch = fed["h2d_bytes"] / steps
        check(h2d_batch <= f32_batch / 3, "15b: %d bytes a batch to the "
              "card, more than a third of the float32 crops' %d"
              % (h2d_batch, f32_batch))
        classic = feed_fit(torch, mx, kernels,
                           Take(feed_iter(mx, prefix, "feed"),
                                FEED_PARITY_STEPS), False)
        check(classic["launches"] == dict(_resnet_launches(FEED_PARITY_STEPS),
                                          rtc=0, crop_norm=FEED_PARITY_STEPS),
              "15b classic launches %s" % classic["launches"])
        _check_params_equal("15b fused against classic after %d steps"
                            % FEED_PARITY_STEPS, kept, classic)
        check(classic["losses"] == fed["losses"][:FEED_PARITY_STEPS],
              "15b losses classic %s, fused %s" % (classic["losses"],
                                                   fed["losses"]))
        # two replays under the profiler, each with a batch staged on the
        # card as the fit's feed scheduler stages it
        step, metric = fed["mod"]._fused_step, mx.metric.Accuracy()
        staged = mx.io_pipeline.DeviceStagingIter(
            feed_iter(mx, prefix, "feed"), ctx=mx.gpu(0))
        batch = next(staged)
        step.step(batch, metric)
        torch.cuda.synchronize()
        prof = _profile_steps(torch, kernels,
                              lambda: step.step(batch, metric), warm=True)
        check(prof["launches"] == dict(_resnet_launches(2), crop_norm=2),
              "15b: two profiled replays ran %s" % prof["launches"])
        del fed["mod"], step, batch, staged
        gc.collect()
        torch.cuda.empty_cache()
        ratio = fed["img_per_s"] / resident["img_per_s"]
        stall = fed["stall_ms_sum"] / max(fed["stall_count"], 1)
        print("15b ResNet-50 NHWC from the uint8 cache (%d frames of "
              "%dx%dx3, written in %.1f s), fit(fused_step=True), feed "
              "depth %d: host step %.3f ms, %.1f img/s, device %.3f ms a "
              "step, busy %.1f%%, io.feed_stall_ms %.3f a step; %d bytes a "
              "batch to the card against %d for float32 crops (%.4f); "
              "launches %s, two replays %s; fused bit-equal to the classic "
              "loop after %d steps; fed / device-resident (phase 6) img/s "
              "%.4f  [%s]"
              % (FEED_FRAMES, FEED_STORE, FEED_STORE, write_s, FEED_DEPTH,
                 fed["step_ms"], fed["img_per_s"], prof["device_ms_per_step"],
                 100 * prof["busy_share"], stall, h2d_batch, f32_batch,
                 h2d_batch / f32_batch, fed["launches"], prof["launches"],
                 FEED_PARITY_STEPS, ratio, card))
        res["feed"] = {k: v for k, v in fed.items() if k not in ("args",
                                                                 "aux")}
        res["feed"].update(breakdown=prof, ratio_to_resident=ratio,
                           stall_ms_per_step=stall,
                           h2d_bytes_per_batch=h2d_batch,
                           f32_bytes_per_batch=f32_batch,
                           cache_write_s=write_s)
        res["classic"] = {"launches": classic["launches"],
                          "losses": classic["losses"]}
        # (c) the other two modes
        for mode in ("augment", "host"):
            run = feed_fit(torch, mx, kernels,
                           Take(feed_iter(mx, prefix, mode), FEED_MODE_STEPS),
                           True)
            check(run["counters"] == (1, 1, FEED_MODE_STEPS - 1)
                  and all(np.isfinite(run["losses"])),
                  "15c %s: counters %s, losses %s"
                  % (mode, run["counters"], run["losses"]))
            check(run["launches"] == dict(_resnet_launches(2), rtc=0,
                                          crop_norm=FEED_MODE_STEPS),
                  "15c %s launches %s (crop_norm in the iterator, a batch)"
                  % (mode, run["launches"]))
            res[mode] = {k: run[k] for k in ("step_ms", "img_per_s",
                                             "launches", "stall_ms_sum",
                                             "h2d_bytes", "losses")}
            del run
            gc.collect()
            torch.cuda.empty_cache()
        print("15c %d steps each: device_augment %.1f img/s (host step %.3f "
              "ms), host crops %.1f img/s (%.3f ms), beside 15b's device "
              "feed %.1f img/s (%.3f ms)  [%s]"
              % (FEED_MODE_STEPS, res["augment"]["img_per_s"],
                 res["augment"]["step_ms"], res["host"]["img_per_s"],
                 res["host"]["step_ms"], fed["img_per_s"], fed["step_ms"],
                 card))
        res["resume"] = feed_resume(torch, mx, kernels, card, prefix, fed,
                                    tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def feed_resume(torch, mx, kernels, card, prefix, fed, tmp):
    """15d: a fit of FEED_SNAPSHOT_STEP steps with MXNET_TPU_CKPT_DIR
    (a snapshot at its last step); a fresh iterator seeked to the
    snapshot's data state hands out 15b's next batch (frames and aug
    values) bit for bit; a fresh module and iterator resumed from the
    snapshot train the rest of the epoch to 15b's losses and params bit
    for bit, with one capture."""
    directory = os.path.join(tmp, "ckpt")
    snap = feed_fit(torch, mx, kernels,
                    Take(feed_iter(mx, prefix, "feed"), FEED_SNAPSHOT_STEP),
                    True, env={"MXNET_TPU_CKPT_DIR": directory,
                               "MXNET_TPU_CKPT_EVERY_N_STEPS":
                                   str(FEED_SNAPSHOT_STEP),
                               "MXNET_TPU_CKPT_RESUME": "0"})
    del snap["mod"]
    check(snap["losses"] == fed["losses"][:FEED_SNAPSHOT_STEP],
          "15d: losses with the snapshot %s, 15b's %s"
          % (snap["losses"], fed["losses"][:FEED_SNAPSHOT_STEP]))
    found = mx.checkpoint.SnapshotStore(directory).load_latest()
    check(found is not None and found[0]["nbatch"] == FEED_SNAPSHOT_STEP - 1,
          "15d: no snapshot of step %d" % FEED_SNAPSHOT_STEP)
    payload = found[0]
    state = dict(payload["data_iter"], batches=FEED_SNAPSHOT_STEP)
    seeked = feed_iter(mx, prefix, "feed")
    seeked.set_checkpoint_state(state)
    straight = feed_iter(mx, prefix, "feed")
    straight.reset()
    for _ in range(FEED_SNAPSHOT_STEP):
        next(straight)
    got, want = next(seeked), next(straight)
    check(np.array_equal(got.data[0].asnumpy(), want.data[0].asnumpy())
          and np.array_equal(got.label[0].asnumpy(), want.label[0].asnumpy())
          and all(np.array_equal(np.asarray(got.aug[k]),
                                 np.asarray(want.aug[k])) for k in want.aug),
          "15d: the seeked iterator's batch %d differs from the "
          "uninterrupted one's" % FEED_SNAPSHOT_STEP)
    resumed = feed_fit(torch, mx, kernels, feed_iter(mx, prefix, "feed"),
                       True, env={"MXNET_TPU_CKPT_DIR": directory,
                                  "MXNET_TPU_CKPT_EVERY_N_STEPS": "0",
                                  "MXNET_TPU_CKPT_RESUME": "1"})
    del resumed["mod"]
    steps = FEED_FRAMES // BATCH
    check(resumed["restores"] == 1, "15d: restores %s" % resumed["restores"])
    check(resumed["counters"] == (1, 1, steps - FEED_SNAPSHOT_STEP - 1),
          "15d: resumed counters %s" % (resumed["counters"],))
    check(resumed["losses"] == fed["losses"][FEED_SNAPSHOT_STEP:],
          "15d: resumed losses differ from 15b's")
    _check_params_equal("15d resumed against 15b", resumed, fed)
    gc.collect()
    torch.cuda.empty_cache()
    print("15d snapshot after step %d, resumed in a fresh iterator and "
          "module: batch %d's frames and aug values bit-equal to the "
          "uninterrupted run's, the remaining %d steps' losses and the "
          "params bit-equal to 15b's, counters %s  [%s]"
          % (FEED_SNAPSHOT_STEP, FEED_SNAPSHOT_STEP,
             steps - FEED_SNAPSHOT_STEP, resumed["counters"], card))
    return {"losses": resumed["losses"], "counters": resumed["counters"],
            "launches": resumed["launches"]}


MIRROR_STEPS = TRAIN_STEPS     # 16a: batches of 32 a fit, as phase 6
SANITIZE_ALL = "transfer,retrace,donation,locks,deadlock"
OBS_BATCH = 16                 # 16b's second fit: another batch size
OBS_STEPS = 3
OBS_PLANT_AT = 2               # 16c: the batch whose callback reads .item()
OBS_REALLOC_AT = 3             # 16c: the batch after which a state moves


@contextlib.contextmanager
def _environ(**values):
    """``os.environ`` with ``values`` set (None: unset) inside."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mirror_plan(mx):
    """What the mirrored backward recomputes in one ResNet-50 NHWC step:
    its runs (``executor.remat_plan``), and the BatchNorms (one K4 launch
    each) and convolutions (one cuDNN forward each) inside recomputed
    runs."""
    from mxnet_tpu_torch.executor import remat_plan

    runs = remat_plan(mx.models.get_resnet50(num_classes=1000,
                                             layout="NHWC"))
    ops = [n.op.op_name for run, _, _, recompute in runs if recompute
           for n in run]
    return {"runs": len(runs),
            "recomputed_runs": sum(1 for r in runs if r[3]),
            "bn": ops.count("BatchNorm"), "conv": ops.count("Convolution")}


def mirror_module(mx, mirror, batch=BATCH):
    """train_module's seed-0 ResNet-50, bound with MXNET_BACKWARD_DO_MIRROR
    set to ``mirror``."""
    with _environ(MXNET_BACKWARD_DO_MIRROR="1" if mirror else "0"):
        mod = train_module(mx, mx.gpu(0), batch, seed=0)
    check(mod._exec_group.executor.mirror == mirror,
          "the executor's mirror flag is %s, want %s"
          % (mod._exec_group.executor.mirror, mirror))
    return mod


def _mirror_launches(plan, steps, mirror):
    want = dict(_resnet_launches(steps), rtc=0)
    if mirror:
        want["norm_act_fwd"] += plan["bn"] * steps
    return want


def _group_counts(torch, run_step, reps=2):
    """Kernel events a call by _train_group over ``reps`` calls under
    torch.profiler (counts, not times: the recomputed forwards)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # one uncounted call first, then a marker kernel: late in the run
        # the profiler can miss the first kernels of a session's first
        # replay (_profile_steps' warm)
        run_step()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        for _ in range(reps):
            run_step()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    (mark,) = [e for e in events if "spin_kernel" in e.name]
    counts = {}
    for e in events:
        if e is not mark and e.time_range.start >= mark.time_range.start:
            g = _train_group(e.name)
            counts[g] = counts.get(g, 0) + 1
    return {g: n / reps for g, n in counts.items()}


def mirror_fits(torch, mx, kernels, card, images, labels, classic_params):
    """16a: ResNet-50 NHWC at batch 32, f32, through fit(fused_step=True)
    unmirrored and mirrored from the same weights, then a mirrored
    classic-loop fit; each checked for its launches (the mirrored K4
    count rises by the recomputed BatchNorms) and one capture; the
    mirrored fits' params, moving statistics and losses bit-equal to the
    unmirrored ones'; peak allocated memory and device ms a replay of
    both."""
    plan = mirror_plan(mx)
    print("16a mirrored backward: %d runs (%d recomputed), a step "
          "recomputes %d BatchNorms (K4) and %d convolutions (cuDNN "
          "forward)" % (plan["runs"], plan["recomputed_runs"], plan["bn"],
                        plan["conv"]))
    runs = {}
    for name, mirror in (("plain", False), ("mirror", True)):
        mod = mirror_module(mx, mirror)
        run = fit_module(torch, mx, kernels, mod, images, labels, True)
        step = mod._fused_step
        counters = {"eager_steps": step.eager_steps,
                    "captures": step.captures, "dispatches": step.dispatches}
        want = _mirror_launches(plan, 2, mirror)
        print("16a %s fused: counters %s, launches %s, losses %s"
              % (name, counters, run["launches"],
                 ["%.4f" % v for v in run["losses"]]))
        check(counters == {"eager_steps": 1, "captures": 1,
                           "dispatches": MIRROR_STEPS - 1},
              "16a %s: fused step counters %s" % (name, counters))
        check(run["launches"] == want, "16a %s: launches %s, want %s"
              % (name, run["launches"], want))
        check(all(np.isfinite(run["losses"])), "16a %s: losses %s"
              % (name, run["losses"]))
        run["breakdown"] = fused_breakdown(torch, mx, kernels, step,
                                           run["metric"], images[:BATCH],
                                           labels[:BATCH])
        got = run["breakdown"]["launches"]
        want2 = {k: v for k, v in _mirror_launches(plan, 2, mirror).items()
                 if k in got}
        check(got == want2, "16a %s: two profiled replays ran %s, want %s"
              % (name, got, want2))
        run["groups"] = _group_counts(
            torch, lambda: step.step(mx.io.DataBatch(
                [images[:BATCH]], [labels[:BATCH]]), run["metric"]))
        run.update(counters=counters, step=step, mod=mod)
        runs[name] = run
    plain, mirror = runs["plain"], runs["mirror"]
    for what in ("args", "aux"):
        unequal = [k for k in plain[what]
                   if not np.array_equal(plain[what][k], mirror[what][k])]
        check(not unequal, "16a: mirrored and unmirrored fused %s differ "
              "after %d steps at %s" % (what, MIRROR_STEPS, unequal[:5]))
    check(plain["losses"] == mirror["losses"], "16a: mirrored losses %s, "
          "unmirrored %s" % (mirror["losses"], plain["losses"]))
    print("16a mirrored vs unmirrored fused fit after %d steps: params, "
          "moving statistics and losses bit-equal" % MIRROR_STEPS)
    for name in ("plain", "mirror"):
        run = runs[name]
        print("16a %s fused: peak allocated %.3f GB (%.3f above the "
              "start), device %.3f ms a replay (profiler; %.3f by CUDA "
              "events), host step %.3f ms, kernel events a replay %s  [%s]"
              % (name, run["peak_bytes"] / 1e9,
                 run["peak_above_start_bytes"] / 1e9,
                 run["breakdown"]["device_ms_per_step"],
                 run["breakdown"]["event_ms_per_step"], run["step_ms"],
                 {g: run["groups"][g] for g in sorted(run["groups"])},
                 card))
    check(mirror["peak_above_start_bytes"] < plain["peak_above_start_bytes"],
          "16a: the mirrored fit's peak above its start, %d bytes, is not "
          "below the unmirrored one's, %d" % (
              mirror["peak_above_start_bytes"],
              plain["peak_above_start_bytes"]))
    added = {g: mirror["groups"].get(g, 0) - plain["groups"].get(g, 0)
             for g in set(mirror["groups"]) | set(plain["groups"])}
    print("16a kernel events a replay added by the mirror: %s" % {
        g: v for g, v in sorted(added.items()) if v})
    check(added.get("norm_act_fwd (K4)") == plan["bn"],
          "16a: the mirror added %s K4 launches a replay, want %d"
          % (added.get("norm_act_fwd (K4)"), plan["bn"]))
    mod = mirror_module(mx, True)
    cl = fit_module(torch, mx, kernels, mod, images, labels, False)
    want = _mirror_launches(plan, MIRROR_STEPS, True)
    print("16a mirrored classic: launches %s, losses %s"
          % (cl["launches"], ["%.4f" % v for v in cl["losses"]]))
    check(cl["launches"] == want, "16a mirrored classic: launches %s, "
          "want %s" % (cl["launches"], want))
    for what, ref in zip(("args", "aux"), classic_params):
        unequal = [k for k in ref if not np.array_equal(ref[k], cl[what][k])]
        check(not unequal, "16a: mirrored classic %s differ from phase "
              "6's classic loop at %s" % (what, unequal[:5]))
    print("16a mirrored classic fit: params and moving statistics "
          "bit-equal to phase 6's classic loop")
    return {"plan": plan, "runs": runs, "classic": cl, "added": added}


def xprof_checks(torch, mx, kernels, card, images, labels, mirror_step_ms):
    """16b: the compile registry over two mirrored fused fits at batch 32
    and OBS_BATCH, telemetry on: each capture recorded with its
    signature and the eager step's FLOPs; the second names the data's
    shape change; StepTrace's ``compiles`` delta at each capturing step;
    one replay's op breakdown sums to its kernel time; analyze's MFU."""
    xp, tel = mx.xprof, mx.telemetry
    xp.reset()
    xp.enable()
    tel.reset()
    tel.enable()
    mx.tracing.step_trace().reset()
    try:
        mod = mirror_module(mx, True)
        run = fit_module(torch, mx, kernels, mod, images, labels, True)
        mod16 = mirror_module(mx, True, OBS_BATCH)
        n16 = OBS_BATCH * OBS_STEPS
        mod16.fit(mx.io.NDArrayIter(images[:n16], labels[:n16],
                                    batch_size=OBS_BATCH),
                  num_epoch=1, optimizer="sgd",
                  optimizer_params=TRAIN_OPT,
                  eval_metric=mx.metric.Accuracy(), fused_step=True)
        recs = [r for r in xp.records() if r.site == "fused_step"]
        cause = xp.last_retrace_cause()
        trace = mx.tracing.step_trace().records()
        compiles = [(r["step"], r["deltas"].get("compiles"), r["dominant"])
                    for r in trace if r["deltas"].get("compiles")]
        summary = xp.summary()
    finally:
        xp.disable()
        tel.disable()
    print("16b registry: %d fused_step records, times %s s, flops %s; "
          "cause %r; StepTrace steps with compiles %s; totals %s"
          % (len(recs), [r.compile_time_s for r in recs],
             [r.flops for r in recs], cause, compiles, summary["totals"]))
    check(len(recs) == 2, "16b: %d fused_step records, want one a fit"
          % len(recs))
    sig = dict(recs[0].signature)
    check(sig.get("data", ((),))[0] == (BATCH,) + IMAGE,
          "16b: the capture's signature holds data %s" % (sig.get("data"),))
    check(all(r.flops and r.compile_time_s > 0 for r in recs),
          "16b: a record without FLOPs or time: %s"
          % [r.to_dict() for r in recs])
    want = "(%s)float32 -> (%s)float32 on data" % (
        ",".join(map(str, (BATCH,) + IMAGE)),
        ",".join(map(str, (OBS_BATCH,) + IMAGE)))
    check(cause is not None and want in cause,
          "16b: the recapture's cause %r does not name %r" % (cause, want))
    check(len(compiles) == 2 and all(d == "compile" for _, _, d in compiles),
          "16b: StepTrace's compiles deltas %s, want one capturing step a "
          "fit labelled compile" % compiles)
    # one replay of the batch-32 fit's step (the registry off), with the
    # FLOPs its eager step counted
    step, metric = mod._fused_step, run["metric"]
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    step.step(batch, metric)
    torch.cuda.synchronize()
    bd = xp.profile_breakdown(lambda: step.step(batch, metric), reps=1,
                              flops=step.step_flops)
    cats = {c: v for c, v in bd.items() if c != "total"}
    total = bd["total"]
    check(total["count"] > 0 and abs(sum(v["ms"] for v in cats.values())
                                      - total["ms"]) <= 1e-9 * total["ms"],
          "16b: the op breakdown's categories %s do not sum to %s"
          % (cats, total))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        step.step(batch, metric)
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / 10
    mfu = xp.analyze(total["flops"], None, step_time_s=replay_ms / 1e3)
    print("16b op breakdown of one mirrored replay, ms / kernels / FLOPs: "
          "%s; total %.3f ms in %d kernels, %.3f TFLOP (eager step, "
          "FlopCounterMode + K3)  [%s]"
          % ({c: (round(v["ms"], 4), v["count"], v.get("flops"))
              for c, v in cats.items()}, total["ms"], total["count"],
             total["flops"] / 1e12, card))
    print("16b analyze: %.3f ms a replay (CUDA events), %s TFLOP/s "
          "achieved, MFU %s%% of the %s TFLOP/s bf16 data-sheet peak of "
          "%s  [%s]" % (replay_ms, mfu.get("achieved_tflops"),
                        mfu.get("analytic_mfu_pct"), mfu["peak_tflops"],
                        mfu["device_kind"], card))
    check(mfu["peak_tflops"] is not None and total["flops"] > 0,
          "16b: analyze knows no peak for %r, or the step counted %s FLOPs"
          % (mfu["device_kind"], total["flops"]))
    print("16b host step with xprof and telemetry on: %.3f ms (16a "
          "mirrored %.3f ms)  [%s]" % (run["step_ms"], mirror_step_ms, card))
    return {"records": [r.to_dict() for r in recs], "cause": cause,
            "compiles": compiles, "breakdown": bd, "replay_ms": replay_ms,
            "analyze": mfu, "step_ms": run["step_ms"]}


def _sanitized_fit(torch, mx, images, labels, after_batch=None):
    """A mirrored fused fit at batch 32 under MXNET_TPU_SANITIZE=all with
    telemetry on; the host clock at each batch-end callback (the card
    synchronised inside an intentional_transfer window), then
    ``after_batch(param, mod)``. Returns (mod, step marks, the raised
    exception or None)."""
    san = mx.analysis.sanitizers
    marks = []

    def on_batch(param):
        with san.intentional_transfer():
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if after_batch is not None:
            after_batch(param, mod)

    mod = mirror_module(mx, True)
    err = None
    mx.random.seed(0)
    with _environ(MXNET_TPU_SANITIZE=SANITIZE_ALL):
        try:
            mod.fit(mx.io.NDArrayIter(images, labels, batch_size=BATCH),
                    num_epoch=1, optimizer="sgd",
                    optimizer_params=TRAIN_OPT,
                    eval_metric=mx.metric.Accuracy(),
                    batch_end_callback=on_batch, fused_step=True)
        except Exception as e:    # the planted faults' raises, checked after
            err = e
        finally:
            mx.tracing.shutdown()     # the deadlock watchdog
    return mod, marks, err


def sanitizer_checks(torch, mx, card, images, labels, mirror_step_ms):
    """16c: every sanitizer armed on mirrored fused fits at batch 32: no
    trip on the clean path; a planted ``.item()`` in a batch-end callback
    raises and counts a transfer trip; a state moved after warmup makes
    the step capture again, which the retrace sanitizer refuses."""
    tel, san = mx.telemetry, mx.analysis.sanitizers
    tel.reset()
    tel.enable()
    try:
        mod, marks, err = _sanitized_fit(torch, mx, images, labels)
        check(err is None, "16c: the clean sanitized fit raised %r" % err)
        trips = tel.peek("sanitizer.trips") or 0
        step = mod._fused_step
        check(trips == 0 and step.captures == 1,
              "16c: clean path: %d sanitizer trips, %d captures"
              % (trips, step.captures))
        step_ms = float(np.median([1e3 * (b - a)
                                   for a, b in zip(marks, marks[1:])]))

        def plant_item(param, _mod):
            if param.nbatch == OBS_PLANT_AT:
                param.locals["self"].get_outputs()[0].handle.sum().item()

        _, _, item_err = _sanitized_fit(torch, mx, images, labels,
                                        plant_item)
        transfer = tel.peek("sanitizer.trips.transfer") or 0
        mode = torch.cuda.get_sync_debug_mode()
        check(item_err is not None and san.is_transfer_guard_error(item_err)
              and transfer == 1 and mode == 0,
              "16c: a planted .item() gave %r, %d transfer trips, sync "
              "debug mode %d after the fit" % (item_err, transfer, mode))

        def move_state(param, m):
            if param.nbatch == OBS_REALLOC_AT:
                st = m._updater.states[0]
                st._data = st._data.clone()

        _, _, retrace_err = _sanitized_fit(torch, mx, images, labels,
                                           move_state)
        retrace = tel.peek("sanitizer.trips.retrace") or 0
        check(isinstance(retrace_err, san.SanitizerError) and retrace == 1,
              "16c: a recapture after warmup gave %r, %d retrace trips"
              % (retrace_err, retrace))
    finally:
        tel.disable()
        tel.reset()
    print("16c sanitizers (%s) on mirrored fused fits: clean path 0 trips, "
          "1 capture; a planted .item() at batch %d: %r, 1 transfer trip; "
          "a state moved after batch %d: %r, 1 retrace trip"
          % (SANITIZE_ALL, OBS_PLANT_AT, str(item_err)[:80], OBS_REALLOC_AT,
             str(retrace_err)[:80]))
    print("16c host step with every sanitizer armed: %.3f ms (16a "
          "mirrored %.3f ms)  [%s]" % (step_ms, mirror_step_ms, card))
    return {"step_ms": step_ms}


def profiler_checks(torch, mx, images, labels, step, metric):
    """16d: profiler.start/stop around two replays of the mirrored step,
    each in an annotate range: the trace holds K3's, K4's and K5's
    kernels and the range."""
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    logdir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    try:
        mx.profiler.start(logdir)
        for _ in range(2):
            with mx.profiler.annotate("chip_smoke.replay"):
                step.step(batch, metric)
        torch.cuda.synchronize()
        path = mx.profiler.stop()
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        size = os.path.getsize(path)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    seen = {k: any(k in n for n in names) for k in (
        "conv_gemm_kernel", "norm_act_vec_kernel",
        "norm_act_bwd_partial_kernel", "chip_smoke.replay")}
    print("16d profiler trace: %d bytes, %d distinct event names, holds %s"
          % (size, len(names), seen))
    check(all(seen.values()), "16d: the trace lacks %s"
          % [k for k, v in seen.items() if not v])
    return {"trace_bytes": size, "seen": seen}


def mirror_obs_main_path(torch, mx, kernels, card, images, labels,
                         classic_params):
    """Phase 16: the mirrored backward and device observability on
    ResNet-50 NHWC at batch 32."""
    t0 = time.perf_counter()
    mir = mirror_fits(torch, mx, kernels, card, images, labels,
                      classic_params)
    m = mir["runs"]["mirror"]
    xprof = xprof_checks(torch, mx, kernels, card, images, labels,
                         m["step_ms"])
    san = sanitizer_checks(torch, mx, card, images, labels, m["step_ms"])
    prof = profiler_checks(torch, mx, images, labels, m["step"], m["metric"])
    for run in mir["runs"].values():
        for k in ("step", "mod", "metric", "args", "aux"):
            run.pop(k, None)
    for k in ("mod", "metric", "args", "aux"):
        mir["classic"].pop(k, None)
    print("phase 16: %.1f s" % (time.perf_counter() - t0))
    return {"mirror": mir, "xprof": xprof, "sanitizers": san,
            "profiler": prof}


# ---------------------------------------------------------------------------
# 17. one process over several cards
# ---------------------------------------------------------------------------
def dp_one_card_fit(torch, mx, kernels, card, images, labels, classic_args,
                    kvstore, fused, label="17a"):
    """17a (18a under ``dist_sync``): phase 6's fused fit over [gpu(0)]
    under ``kvstore``: one capture, the eager step's and the capture's
    launches, two profiled replays' launches, params bit-equal to phase
    6's."""
    mod = train_module(mx, [mx.gpu(0)], BATCH, seed=0)
    run = fit_module(torch, mx, kernels, mod, images, labels, fused,
                     kvstore=kvstore)
    step = mod._fused_step
    check(mod._fused_step_active and step is not None,
          "%s %s: the fit did not take the fused step" % (label, kvstore))
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": TRAIN_STEPS - 1},
          "%s %s: fused step counters %s" % (label, kvstore, counters))
    want = dict(_resnet_launches(2), rtc=0)
    check(run["launches"] == want, "%s %s: launches %s, want %s"
          % (label, kvstore, run["launches"], want))
    unequal = [k for k in classic_args
               if not np.array_equal(run["args"][k], classic_args[k])]
    check(not unequal, "%s %s: params differ from phase 6's at %s"
          % (label, kvstore, unequal[:5]))
    breakdown = fused_breakdown(torch, mx, kernels, step, run["metric"],
                                images[:BATCH], labels[:BATCH])
    check_profiled_launches("%s %s" % (label, kvstore), breakdown)
    print("%s %s over [gpu(0)]: captures %d, launches %s, params bit-equal "
          "to phase 6's, host step %.3f ms, device %.3f ms a replay  [%s]"
          % (label, kvstore, step.captures, run["launches"], run["step_ms"],
             breakdown["event_ms_per_step"], card))
    return {"counters": counters, "launches": run["launches"],
            "update_on_kvstore": mod._update_on_kvstore,
            "replays_profiled": breakdown["launches"],
            "step_ms": run["step_ms"],
            "event_ms_per_step": breakdown["event_ms_per_step"]}


def dp_main_path(torch, mx, kernels, card, images, labels, classic_args):
    """Phase 17a on one card (17b, over every visible card, runs last in
    the process: :func:`dp_multi_path`)."""
    t0 = time.perf_counter()
    out = {"device_sync": dp_one_card_fit(torch, mx, kernels, card, images,
                                          labels, classic_args,
                                          "device_sync", None),
           "device": dp_one_card_fit(torch, mx, kernels, card, images,
                                     labels, classic_args, "device", True)}
    out["seconds"] = time.perf_counter() - t0
    print("phase 17a: %.1f s" % out["seconds"])
    return out


def _tools_module(name):
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tools"))
    import importlib

    return importlib.import_module(name)


def dp_multi_path(torch, mx, kernels, card):
    """17b: over every visible card through tools/torch_dp_check.py, or a
    line saying it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print("17b: not run, 1 card visible")
        return None
    t0 = time.perf_counter()
    # in this process, after every earlier phase: a user's fit over
    # several cards in a process that has done other card work
    torch_dp_check = _tools_module("torch_dp_check")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = torch_dp_check.run(torch, mx, kernels, n)
    check(not rec["failed"], "17b over %d cards: %s" % (n, rec["failed"]))
    print("17b over %d cards: the fit within %.3g of one card's (bound "
          "%.3g), replicas bit-identical, one capture, exchange %.3f ms, "
          "statistics %.3f ms, %.1f img/s against %.1f on one card; "
          "control (per-card statistics) %.3g, caught  [%s]"
          % (n, rec["params_vs_one_card_normwise"], rec["params_bound"],
             rec["exchange_graph_ms"], rec["statistics_graph_ms"],
             rec["img_per_s"], rec["img_per_s_one_card"],
             rec["control"]["params_vs_one_card_normwise"], card))
    rec["phase_seconds"] = time.perf_counter() - t0
    print("phase 17b: %.1f s" % rec["phase_seconds"])
    return rec


# ---------------------------------------------------------------------------
# 18. the dist stores
# ---------------------------------------------------------------------------
ASYNC_WORKERS = 2              # 18b: dist_async workers on the one card
ASYNC_PUSHES = 3               # pushes a worker, in a fixed order
ASYNC_TIMEOUT_S = 300
_LAUNCHER_ENV = ("MXTPU_COORDINATOR", "MXTPU_NUM_WORKERS",
                 "MXTPU_WORKER_RANK", "MXTPU_PS_PORT")


def _free_port_pair():
    """A port p with p and p + 1 free: the launcher's coordinator and the
    parameter server (the coordinator's port + 1)."""
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
                return p
    raise RuntimeError("no free port pair")


def train_module_names(mx):
    """ResNet-50 NHWC's parameter names in the Module's order."""
    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    return [n for n in sym.list_arguments()
            if n not in ("data", "softmax_label")]


def async_child(work):
    """18b's worker (``tools/launch.py`` starts two): ResNet-50 NHWC at
    batch 32 on gpu(0) from train_module's seed-0 weights under
    ``dist_async`` (rank 0 hosts the server thread). In turn, ordered by
    the store's barriers, each rank runs forward and backward on its own
    batch and pushes every gradient through ``Module.update`` (push, then
    pull the server's weights), ASYNC_PUSHES times. Each rank saves what
    it pushed; rank 0 saves its first weights, the optimizer it shipped
    to the server and the server's final weights; each rank times its
    push/pull rounds. Rank 1 closes first; rank 0 then reads
    num_dead_node() and closes (stopping the server)."""
    import pickle

    import torch

    import mxnet_tpu_torch as mx

    rank = int(os.environ["MXTPU_WORKER_RANK"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = train_data(ASYNC_PUSHES * ASYNC_WORKERS)
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    names = mod._param_names
    first = {n: v.asnumpy().copy() for n, v in mod.get_params()[0].items()}
    kv = mx.kv.create("dist_async")
    # rescale_grad left to the Module: 1 / (the batch x the workers)
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params=[p for p in TRAIN_OPT
                                         if p[0] != "rescale_grad"])
    ex = mod._exec_group.executor
    pushed, rounds_ms = {}, []
    for s in range(ASYNC_PUSHES):
        for r in range(ASYNC_WORKERS):
            if r == rank:
                rows = slice((s * ASYNC_WORKERS + r) * BATCH,
                             (s * ASYNC_WORKERS + r + 1) * BATCH)
                mod.forward_backward(mx.io.DataBatch(
                    [mx.nd.array(images[rows], ctx=mx.cpu())],
                    [mx.nd.array(labels[rows], ctx=mx.cpu())]))
                for i, n in enumerate(names):
                    pushed["%d:%d" % (s, i)] = \
                        ex.grad_dict[n].asnumpy().copy()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.update()
                torch.cuda.synchronize()
                rounds_ms.append(1e3 * (time.perf_counter() - t0))
            kv.barrier()
    np.savez(os.path.join(work, "pushed%d.npz" % rank), **pushed)
    rec = {"rank": rank, "workers": kv.num_workers,
           "update_on_kvstore": mod._update_on_kvstore,
           "rescale_grad": mod._optimizer.rescale_grad,
           "rounds_ms": rounds_ms, "server_thread": kv._server is not None}
    if rank == 0:
        final = {str(i): kv._client.call("pull", i)
                 for i in range(len(names))}
        np.savez(os.path.join(work, "server_final.npz"), **final)
        np.savez(os.path.join(work, "first.npz"),
                 **{str(i): first[n] for i, n in enumerate(names)})
        with open(os.path.join(work, "optimizer.pkl"), "wb") as f:
            f.write(pickle.dumps(mod._optimizer))
    kv.barrier()
    closed = os.path.join(work, "closed1")
    if rank == 1:
        kv.close()
        open(closed, "w").close()
    else:
        deadline = time.monotonic() + 60
        while not os.path.exists(closed) and time.monotonic() < deadline:
            time.sleep(0.05)
        rec["dead_after_close"] = kv.num_dead_node()
        kv.close()
    with open(os.path.join(work, "rank%d.json" % rank), "w") as f:
        json.dump(rec, f)
    return 0


def async_replay(mx, work, n_params):
    """18b's pushes replayed in one process on the CPU, in the order the
    barriers gave them (push s of rank 0, then of rank 1, each key in
    order, as the server applies them), through the optimizer rank 0
    shipped, from rank 0's first weights."""
    import pickle

    with open(os.path.join(work, "optimizer.pkl"), "rb") as f:
        opt = pickle.loads(f.read())
    first = np.load(os.path.join(work, "first.npz"))
    weights = {i: mx.nd.array(first[str(i)], ctx=mx.cpu())
               for i in range(n_params)}
    states = {}
    pushed = [np.load(os.path.join(work, "pushed%d.npz" % r))
              for r in range(ASYNC_WORKERS)]
    for s in range(ASYNC_PUSHES):
        for r in range(ASYNC_WORKERS):
            for i in range(n_params):
                g = mx.nd.array(pushed[r]["%d:%d" % (s, i)], ctx=mx.cpu())
                if i not in states:
                    states[i] = opt.create_state(i, weights[i])
                opt.update(i, weights[i], g, states[i])
    return {i: w.asnumpy() for i, w in weights.items()}


def dist_async_path(torch, mx, card):
    """18b: two dist_async workers on the card through tools/launch.py;
    the server's final weights bit-equal to the replay of the same pushes
    in the same order on the CPU; no dead node after both close."""
    work = tempfile.mkdtemp(prefix="chip_smoke_async_")
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, os.path.join(here, "tools", "launch.py"),
               "-n", str(ASYNC_WORKERS), "--coordinator",
               "127.0.0.1:%d" % _free_port_pair(), sys.executable,
               os.path.abspath(__file__), "--async-child", work]
        env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
        env["PYTHONPATH"] = here
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=ASYNC_TIMEOUT_S)
            rc, err = r.returncode, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, err = 124, str(e.stderr)
        wall = time.perf_counter() - t0
        left = [k for k in range(ASYNC_WORKERS) if not os.path.exists(
            os.path.join(work, "rank%d.json" % k))]
        check(rc == 0 and not left, "18b: the workers failed (launch.py rc "
              "%s; ranks that left no result %s): %s"
              % (rc, left, err[-3000:]))
        recs = []
        for k in range(ASYNC_WORKERS):
            with open(os.path.join(work, "rank%d.json" % k)) as f:
                recs.append(json.load(f))
        for rec in recs:
            check(rec["workers"] == ASYNC_WORKERS and rec["update_on_kvstore"]
                  and abs(rec["rescale_grad"] - 1.0 / (BATCH * ASYNC_WORKERS))
                  < 1e-12, "18b: rank %d's store %s" % (rec["rank"], rec))
        check(recs[0]["server_thread"] and not recs[1]["server_thread"],
              "18b: rank 0 did not host the server thread: %s" % recs)
        check(recs[0]["dead_after_close"] == 0,
              "18b: num_dead_node() %s after both closed"
              % recs[0]["dead_after_close"])
        names = train_module_names(mx)
        t1 = time.perf_counter()
        want = async_replay(mx, work, len(names))
        replay_s = time.perf_counter() - t1
        got = np.load(os.path.join(work, "server_final.npz"))
        unequal = [names[i] for i in want
                   if not np.array_equal(got[str(i)], want[i])]
        check(not unequal, "18b: the server's weights differ from the "
              "replay at %s" % unequal[:5])
        first = np.load(os.path.join(work, "first.npz"))
        moved = sum(not np.array_equal(got[str(i)], first[str(i)])
                    for i in want)
        check(moved == len(want), "18b: %d of %d weights moved"
              % (moved, len(want)))
        rounds = [ms for rec in recs for ms in rec["rounds_ms"]]
        print("18b dist_async, %d workers on one card, ResNet-50 NHWC at "
              "batch %d, %d pushes a worker in a fixed order: the server's "
              "weights (%d tensors) bit-equal to the CPU replay of the same "
              "pushes; num_dead_node 0 after both closed; push/pull round "
              "%s ms (median %.1f); %.1f s of workers, %.1f s of replay  "
              "[%s]" % (ASYNC_WORKERS, BATCH, ASYNC_PUSHES, len(want),
                        ["%.1f" % ms for ms in rounds],
                        float(np.median(rounds)), wall, replay_s, card))
        return {"ranks": recs, "round_ms": rounds,
                "round_ms_median": float(np.median(rounds)),
                "workers_s": wall, "replay_s": replay_s,
                "tensors": len(want)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def dist_main_path(torch, mx, kernels, card, images, labels, classic_args):
    """Phase 18: (a) a one-worker dist_sync (no launcher) on [gpu(0)],
    which fit gives the fused step; (b) dist_async with two workers on
    the card; (c) over every visible card, tools/torch_dist_check.py."""
    t0 = time.perf_counter()
    with _environ(**dict.fromkeys(_LAUNCHER_ENV)):
        kv = mx.kv.create("dist_sync")
        check(type(kv).__name__ == "KVStoreDist"
              and (kv.rank, kv.num_workers) == (0, 1)
              and kv.in_jit_gradient_exchange,
              "18a: dist_sync without a launcher is not a one-worker world")
        one = dp_one_card_fit(torch, mx, kernels, card, images, labels,
                              classic_args, "dist_sync", None, label="18a")
    check(not one["update_on_kvstore"], "18a: the update ran on the store")
    out = {"one_worker": one, "async": dist_async_path(torch, mx, card)}
    n = torch.cuda.device_count()
    if n < 2:
        print("18c: not run, 1 card visible")
        out["multi"] = None
    else:
        torch_dist_check = _tools_module("torch_dist_check")
        rec = torch_dist_check.run(torch, mx, kernels, n)
        check(not rec["failed"], "18c over %d workers: %s"
              % (n, rec["failed"]))
        print("18c over %d workers: ranks bit-identical, params %.3g of the "
              "reference's update away (bound %.3g), %.1f img/s against "
              "%.1f on one card; control %.3g, caught  [%s]"
              % (n, rec["params_vs_reference_normwise"],
                 rec["bounds"]["params"], rec["img_per_s"],
                 rec["img_per_s_one_card"],
                 rec["control"]["params_vs_reference_normwise"], card))
        out["multi"] = rec
    out["seconds"] = time.perf_counter() - t0
    print("phase 18: %.1f s" % out["seconds"])
    return out


AUTOTUNE_BUDGET_S = 5.0        # 19a: each (site, signature) search's budget
AUTOTUNE_REPS = 10             # 19a: timed launches a measured candidate
AUTOTUNE_SITES = 2 * 42 + 2 * 2 * 12   # 19a: K3's 42 products, K4's and
                                       # K5's 12 shapes, f32 and bf16


def autotune_tune(torch, card, gemms, norms, tmp):
    """19a: autotune.run_smoke over the distinct K3 products ``gemms``
    and K4/K5 shapes ``norms`` of phase 6's step, in f32 and bf16, into a
    cache and rows under ``tmp``; every measured candidate held against
    the plain version (a wrong one raises), the rows fenced, every winner
    keyed by the card's name."""
    from mxnet_tpu_torch import autotune

    cache = os.path.join(tmp, "cache.json")
    rows_path = os.path.join(tmp, "rows.jsonl")
    print("19a: tuning K3 at %d products, K4 and K5 at %d shapes, f32 and "
          "bf16, %.1f s budget a search  [%s]"
          % (len(gemms), len(norms), AUTOTUNE_BUDGET_S, card))
    with _environ(MXNET_TPU_AUTOTUNE_BUDGET_S=str(AUTOTUNE_BUDGET_S)):
        s = autotune.run_smoke(gemms, norms, jsonl_path=rows_path,
                               cache_path=cache, reps=AUTOTUNE_REPS,
                               log=print)
    kind = torch.cuda.get_device_name(0)
    results = [r for by_sig in s["sites"].values() for r in by_sig.values()]
    check(len(results) == AUTOTUNE_SITES, "19a: %d searches, want %d"
          % (len(results), AUTOTUNE_SITES))
    check(all(r["best"] is not None for r in results),
          "19a: a search measured no candidate")
    entries = json.load(open(cache))["entries"]
    check(len(entries) == AUTOTUNE_SITES
          and all(key.endswith("|" + kind) for key in entries),
          "19a: the cache holds %d entries, not all keyed by %r"
          % (len(entries), kind))
    with open(rows_path) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == s["rows_written"] and all(r["valid"] for r in rows),
          "19a: %d rows on disk, %d written" % (len(rows), s["rows_written"]))
    for r in s["refused_rows"]:
        print("19a refused: %s %s %s: %s" % (r["site"], r["sig"],
                                             r["candidate"], r["refused"]))
    print("19a: %d searches in %.1f s, %d rows written, %d refused, "
          "non-default winners %d  [%s]"
          % (len(results), s["seconds"], s["rows_written"],
             s["rows_refused"], sum(bool(r.get("non_default"))
                                    for r in results), card))
    return s, cache


def _tuned_step_ms(summary, kernel, dtype, counts):
    """The kernel's ms a step at the default and at the winner, summed
    over the step's launches (``counts`` by shape) from 19a's searches."""
    from mxnet_tpu_torch import autotune

    by_sig = {}
    for key, n in counts.items():
        if kernel == "conv_gemm":
            sig = autotune.gemm_sig(*key[:3], dtype, key[3])
        else:
            sig = autotune.norm_sig("fwd" if kernel == "norm_act_fwd"
                                    else "bwd", *key, dtype)
        by_sig[sig] = n
    site = "conv_backward" if kernel == "conv_gemm" else "norm_act"
    out = {"default_ms": 0.0, "tuned_ms": 0.0, "non_default": 0,
           "shapes": len(by_sig)}
    for sig, n in by_sig.items():
        r = summary["sites"][site][sig]
        out["default_ms"] += n * r["default_ms"]
        out["tuned_ms"] += n * r["best"]["step_time_ms"]
        out["non_default"] += bool(r.get("non_default"))
    return out


def _conditioned_fit(torch, mx, kernels, images, labels, fused, gamma_b3):
    """fit_module over TRAIN_STEPS batches from train_module's seed-0
    weights with each residual block's last BatchNorm gamma at
    ``gamma_b3`` (tools/torch_dp_check.py's conditioning: with every
    gamma at 1 a random ResNet-50 trained in float32 moves most of its
    update when its input moves by one rounding); the launches of every
    step (classic) or of the eager step and the capture (fused) checked."""
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0)
    args, aux = mod.get_params()
    for name, arr in args.items():
        if name.endswith("_b3_bn_gamma"):
            arr[:] = np.full(arr.shape, gamma_b3, np.float32)
    mod.set_params(args, aux)
    start = (_host(args), _host(aux))
    run = fit_module(torch, mx, kernels, mod, images, labels, fused)
    want = dict(_resnet_launches(2 if fused else TRAIN_STEPS), rtc=0)
    check(run["launches"] == want, "19b %s fit: launches %s, want %s"
          % ("fused" if fused else "classic", run["launches"], want))
    check(all(np.isfinite(run["losses"])), "19b: losses %s" % run["losses"])
    run["start"] = start
    return run


def autotune_fit(torch, mx, kernels, card, images, labels, cache):
    """19b: phase 6's fit, conditioned as tools/torch_dp_check.py's
    (GAMMA_B3), with MXNET_TPU_AUTOTUNE=1 over 19a's cache: the classic
    loop, then the fused step (one capture, bit-equal to the classic
    loop, 105/53/53 launches a replay); the untuned fused fit and the
    float32 floor (the untuned fit's distance when the images move by one
    rounding, 1 +- 2^-23, as tools/torch_dp_check.py reckons it): the
    tuned params within FLOOR_FACTOR floors (at least MIN_BOUND) of the
    untuned ones, normwise; device ms a replay tuned and untuned, in
    turns."""
    from mxnet_tpu_torch import autotune

    dp = _tools_module("torch_dp_check")

    def fit(imgs, fused):
        return _conditioned_fit(torch, mx, kernels, imgs, labels, fused,
                                dp.GAMMA_B3)

    saved = autotune.CACHE_FILE
    autotune.CACHE_FILE = cache
    autotune.reset()
    try:
        with _environ(MXNET_TPU_AUTOTUNE="1"):
            classic = fit(images, False)
            _drop(classic)
            tuned = fit(images, True)
        applied = dict(autotune._lookups)
    finally:
        autotune.CACHE_FILE = saved
        autotune.reset()
    kind = torch.cuda.get_device_name(0)
    f32 = [cfg for (site, sig, chip), cfg in applied.items()
           if chip == kind and sig.endswith("float32") and cfg is not None]
    check(len(f32) == 42 + 12 + 12, "19b: %d tuned configs applied to the "
          "f32 step, want 66 (42 K3, 12 K4, 12 K5)" % len(f32))
    step = tuned["mod"]._fused_step
    counters = {"eager_steps": step.eager_steps, "captures": step.captures,
                "dispatches": step.dispatches}
    check(counters == {"eager_steps": 1, "captures": 1,
                       "dispatches": TRAIN_STEPS - 1},
          "19b: tuned fused step counters %s" % counters)
    for what in ("args", "aux"):
        unequal = [k for k in classic[what]
                   if not np.array_equal(tuned[what][k], classic[what][k])]
        check(not unequal, "19b: tuned fused and classic %s differ at %s"
              % (what, unequal[:5]))
    check(tuned["losses"] == classic["losses"]
          and tuned["accuracy"] == classic["accuracy"],
          "19b: tuned fused losses/metric differ from the classic loop's")
    breakdown = fused_breakdown(torch, mx, kernels, step, tuned["metric"],
                                images[:BATCH], labels[:BATCH])
    check_profiled_launches("19b tuned fused", breakdown)
    untuned = fit(images, True)
    args0, aux0 = untuned["start"]
    floors = {"args": 0.0, "aux": 0.0}
    for scale in (1 + 2.0 ** -23, 1 - 2.0 ** -23):
        moved = fit(images * np.float32(scale), True)
        _drop(moved)
        for what, start_of in (("args", args0), ("aux", aux0)):
            floors[what] = max(floors[what], dp._normwise(
                moved[what], untuned[what], start_of))
    dist, bounds = {}, {}
    for what, start_of in (("args", args0), ("aux", aux0)):
        dist[what] = dp._normwise(tuned[what], untuned[what], start_of)
        bounds[what] = max(dp.FLOOR_FACTOR * floors[what], dp.MIN_BOUND)
        check(dist[what] <= bounds[what], "19b: tuned %s %g of the untuned "
              "update away, bound %g (%d x the float32 floor %g)"
              % (what, dist[what], bounds[what], dp.FLOOR_FACTOR,
                 floors[what]))
    batch = mx.io.DataBatch([images[:BATCH]], [labels[:BATCH]])
    ms = {"tuned": [], "untuned": []}
    for which in ("tuned", "untuned", "untuned", "tuned"):
        run = tuned if which == "tuned" else untuned
        st, metric = run["mod"]._fused_step, run["metric"]
        st.step(batch, metric)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(10):
            st.step(batch, metric)
        t1.record()
        torch.cuda.synchronize()
        ms[which].append(t0.elapsed_time(t1) / 10)
    print("19b: tuned fit over 19a's cache (residual blocks' last gamma "
          "%g): one capture, classic and fused bit-equal, launches %s, two "
          "profiled replays %s; params %.4g and moving statistics %.4g of "
          "the untuned update away (float32 floors %.4g / %.4g, bounds %.4g "
          "/ %.4g); device ms a replay tuned %s, untuned %s (in turns)  [%s]"
          % (dp.GAMMA_B3, tuned["launches"], breakdown["launches"],
             dist["args"], dist["aux"], floors["args"], floors["aux"],
             bounds["args"], bounds["aux"],
             ["%.3f" % v for v in ms["tuned"]],
             ["%.3f" % v for v in ms["untuned"]], card))
    out = {"counters": counters, "launches_classic": classic["launches"],
           "launches_fused": tuned["launches"],
           "replays_profiled": breakdown["launches"],
           "normwise_vs_untuned": dist, "float32_floor": floors,
           "bounds": bounds, "replay_ms": ms,
           "applied_f32_configs": len(f32)}
    for run in (tuned, untuned):
        _drop(run)
    return out


def autotune_main_path(torch, mx, kernels, card, images, labels):
    """Phase 19: tune K3, K4 and K5 on the card (19a), then fit ResNet-50
    under the tuned cache (19b)."""
    t0 = time.perf_counter()
    gemms, norms = conv_gemm_shapes(mx), bn_shapes(mx)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    try:
        summary, cache = autotune_tune(torch, card, gemms, norms, tmp)
        fit = autotune_fit(torch, mx, kernels, card, images, labels, cache)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = {}
    for kernel, counts in (("conv_gemm", gemms), ("norm_act_fwd", norms),
                           ("norm_act_bwd", norms)):
        for dtype in ("float32", "bfloat16"):
            steps["%s_%s" % (kernel, dtype)] = t = _tuned_step_ms(
                summary, kernel, dtype, counts)
            print("19a %s %s a step: default %.4f ms, tuned %.4f ms, %d of "
                  "%d shapes non-default  [%s]"
                  % (kernel, dtype, t["default_ms"], t["tuned_ms"],
                     t["non_default"], t["shapes"], card))
    seconds = time.perf_counter() - t0
    print("phase 19: %.1f s" % seconds)
    return {"tune": {k: v for k, v in summary.items() if k != "sites"},
            "searches": summary["sites"], "step_ms": steps, "fit": fit,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 20. fsdp, tp and the sharding API
# ---------------------------------------------------------------------------
SHARD_LR = 0.0125 / BATCH      # 20a: the step sums the batch's gradients
SHARD_UNIT = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -8}


def shard_classic_step(torch, mx, kernels, images, labels, dtype, gamma_b3):
    """One classic-loop SGD step of ResNet-50 NHWC at batch 32 from
    train_module's seed-0 weights (residual gammas at ``gamma_b3``), at
    lr SHARD_LR with rescale 1, momentum 0 and wd 0 (the sharded train
    step's update): (start args, start aux, args, aux)."""
    cd = None if dtype == "float32" else dtype
    mod = train_module(mx, mx.gpu(0), BATCH, seed=0, compute_dtype=cd)
    args, aux = mod.get_params()
    for name, arr in args.items():
        if name.endswith("_b3_bn_gamma"):
            arr[:] = np.full(arr.shape, gamma_b3, np.float32)
    mod.set_params(args, aux)
    start = (_host(args), _host(aux))
    import warnings

    with warnings.catch_warnings():
        # one step has no step time (the median of no intervals)
        warnings.simplefilter("ignore", RuntimeWarning)
        run = fit_module(torch, mx, kernels, mod, images[:BATCH],
                         labels[:BATCH], False, optimizer_params=(
                             ("learning_rate", SHARD_LR), ("momentum", 0.0),
                             ("wd", 0.0), ("rescale_grad", 1.0)))
    return start, run["args"], run["aux"]


def shard_build_step(torch, mx, kernels, start, images, labels, dtype):
    """20a's main path: parallel.build_sgd_train_step over a one-rank
    (dp, fsdp) DeviceMesh, params placed by fsdp_param_spec rules through
    make_param_shardings and shard_args, one step at batch 32; the
    wrappers' counts zeroed just before the step and read just after."""
    import torch.distributed as dist
    from mxnet_tpu_torch import parallel

    sym = mx.models.get_resnet50(num_classes=1000, layout="NHWC")
    args, aux = start
    mesh = parallel.make_mesh({"dp": 1, "fsdp": 1})
    try:
        rules = [parallel.ShardingRule(".*", parallel.fsdp_param_spec(
            (1,), mesh))]
        params = parallel.shard_args(mesh, args, parallel.make_param_shardings(
            mesh, {k: v.shape for k, v in args.items()}, rules))
        aux_t = [torch.from_numpy(aux[n]).cuda()
                 for n in sym.list_auxiliary_states()]
        step, names = parallel.build_sgd_train_step(
            sym, ["data"], ["softmax_label"], lr=SHARD_LR,
            compute_dtype=None if dtype == "float32" else dtype)
        data = {"data": torch.from_numpy(images[:BATCH]).cuda(),
                "softmax_label": torch.from_numpy(labels[:BATCH]).cuda()}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        outs, new, new_aux = step(params, data, aux_t, 0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = kernels.launch_counts()
        got = {k: v.full_tensor().cpu().numpy() for k, v in new.items()}
        got_aux = {n: a.cpu().numpy() for n, a in
                   zip(sym.list_auxiliary_states(), new_aux)}
        probs = outs[0]
    finally:
        dist.destroy_process_group()
    check(bool(torch.isfinite(probs).all())
          and tuple(probs.shape) == (BATCH, 1000),
          "20a %s: outputs %s, finite %s" % (dtype, tuple(probs.shape),
                                             bool(torch.isfinite(probs).all())))
    return got, got_aux, launches, ms


def shard_one_card(torch, mx, kernels, card, images, labels):
    """20a: the sharded train step against the classic loop's step, in
    f32 and bf16, within one floor of that dtype (the classic step's
    distance when its images move by one rounding of the dtype, 1 +- u),
    at least 1e-6, normwise as a share of the classic step's update."""
    dp = _tools_module("torch_dp_check")
    out = {}
    for dtype in ("float32", "bfloat16"):
        start, want, want_aux = shard_classic_step(
            torch, mx, kernels, images, labels, dtype, dp.GAMMA_B3)
        floors = {"args": 0.0, "aux": 0.0}
        for scale in (1 + SHARD_UNIT[dtype], 1 - SHARD_UNIT[dtype]):
            _, moved, moved_aux = shard_classic_step(
                torch, mx, kernels, images * np.float32(scale), labels,
                dtype, dp.GAMMA_B3)
            floors["args"] = max(floors["args"], dp._normwise(
                moved, want, start[0]))
            floors["aux"] = max(floors["aux"], dp._normwise(
                moved_aux, want_aux, start[1]))
        got, got_aux, launches, ms = shard_build_step(
            torch, mx, kernels, start, images, labels, dtype)
        rec = {"launches": launches, "host_ms": ms, "floor": floors}
        want_l = dict(_resnet_launches(1), rtc=0)
        check(launches == want_l, "20a %s: build_sgd_train_step launched %s, "
              "want %s" % (dtype, launches, want_l))
        for what, g, w, s0 in (("args", got, want, start[0]),
                               ("aux", got_aux, want_aux, start[1])):
            dist_ = dp._normwise(g, w, s0)
            bound = max(floors[what], 1e-6)
            rec["%s_vs_classic_normwise" % what] = dist_
            rec["%s_bound" % what] = bound
            check(dist_ <= bound, "20a %s: the sharded step's %s %g of the "
                  "classic step's update away, bound %g (the floor)"
                  % (dtype, what, dist_, bound))
        print("20a build_sgd_train_step over a one-rank (dp, fsdp) mesh, %s: "
              "params %.4g / moving statistics %.4g of the classic step's "
              "update away (floors %.4g / %.4g), launches %s, host %.1f ms "
              "(the first call)  [%s]"
              % (dtype, rec["args_vs_classic_normwise"],
                 rec["aux_vs_classic_normwise"], floors["args"],
                 floors["aux"], launches, ms, card))
        out[dtype] = rec
    return out


def shard_multi_path(torch, mx, kernels, card):
    """20b: tools/torch_shard_check.py's part (a) in this process over
    every visible card, or a line saying it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print("20b: not run, 1 card visible")
        return None
    t0 = time.perf_counter()
    check_tool = _tools_module("torch_shard_check")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = check_tool.run_a(torch, mx, kernels, n)
    check(not rec["failed"], "20b over %d cards: %s" % (n, rec["failed"]))
    rec["phase_seconds"] = time.perf_counter() - t0
    print("phase 20b: %.1f s" % rec["phase_seconds"])
    return rec


def shard_main_path(torch, mx, kernels, card, images, labels):
    """Phase 20a on one card (20b, over every visible card, runs last in
    the process: :func:`shard_multi_path`)."""
    t0 = time.perf_counter()
    out = shard_one_card(torch, mx, kernels, card, images, labels)
    out["seconds"] = time.perf_counter() - t0
    print("phase 20a: %.1f s" % out["seconds"])
    return out


# ---------------------------------------------------------------------------
# 21. the fused step over several cards with the device feed and Dropout
# ---------------------------------------------------------------------------
def dropout_one_card(torch, mx, kernels, card):
    """21a: tools/torch_dp_feed_check.py's Dropout part over [gpu(0)],
    AlexNet only: what the multi-card path's "fused equals classic" holds
    to on one card."""
    t0 = time.perf_counter()
    tool = _tools_module("torch_dp_feed_check")
    rec = tool.run_b(torch, mx, kernels, 1, models={"alexnet": None})
    check(not rec["failed"], "21a: %s" % rec["failed"])
    m = rec["models"]["alexnet"]
    print("21a AlexNet NCHW %s with Dropout on one card: captures %d, "
          "fused == classic over %d steps (params, moving statistics, "
          "outputs, losses) %s, masks differ between replays by %.3f, keep "
          "rates %s, launches in two replays %s  [%s]"
          % ("x".join(map(str, m["input"])), m["counters"]["captures"],
             rec["steps"], m["fused_equals_classic"],
             m["mask_disagreement_between_replays"][0],
             ["%.4f" % v for v in m["keep_rate_by_card_and_node"]],
             m["launches_per_card_2_replays"][0], card))
    rec["phase_seconds"] = time.perf_counter() - t0
    print("phase 21a: %.1f s" % rec["phase_seconds"])
    return rec


def dp_feed_multi_path(torch, mx, kernels, card):
    """21b: tools/torch_dp_feed_check.py's run() in this process over
    every visible card, or a line saying it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print("21b: not run, 1 card visible")
        return None
    t0 = time.perf_counter()
    tool = _tools_module("torch_dp_feed_check")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = tool.run(torch, mx, kernels, n)
    check(not rec["failed"], "21b over %d cards: %s" % (n, rec["failed"]))
    for line in tool.summary(rec, card):
        print("21b " + line)
    rec["phase_seconds"] = time.perf_counter() - t0
    print("phase 21b: %.1f s" % rec["phase_seconds"])
    return rec


# ---------------------------------------------------------------------------
# 22. pipeline and expert parallelism
# ---------------------------------------------------------------------------
PP_HID = 4096                  # 22a: VGG-16's fc7, 4096 -> 4096
PP_MICROBATCHES, PP_ROWS = 8, 32
MOE_TOKENS = 4096              # 22a: 8 sequences of 512
MOE_SWITCH = (8, 768, 3072)    # Switch-Base-8: experts, d_model, d_ff
MOE_TOL = 1e-5                 # y: rtol and atol; gradients: normwise
MOE_CPU_TOKENS = 256


def _cpu_mesh(torch, axis):
    """A one-rank CPU DeviceMesh over a gloo group of its own: the
    process group in place may be NCCL's alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    group = dist.new_group(ranks=[0], backend="gloo")
    return DeviceMesh.from_group(group, "cpu", mesh_dim_names=(axis,))


def pp_one_card(torch, mx, kernels, card):
    """22a's pipeline: a one-rank pp mesh, one K1 stage at 4096, the
    stage, oracle step and learning rate tools/torch_pp_moe_check.py's."""
    from mxnet_tpu_torch import parallel

    tool = _tools_module("torch_pp_moe_check")
    dp, stage, lr = tool.dp, tool.ranks.stage_fn, tool.PP_LR
    rng = np.random.RandomState(22)
    w_np = (rng.randn(1, PP_HID, PP_HID) / np.sqrt(PP_HID)).astype(np.float32)
    b_np = (rng.randn(1, PP_HID) * 0.1).astype(np.float32)
    mb_np = rng.randn(PP_MICROBATCHES, PP_ROWS, PP_HID).astype(np.float32)
    lab_np = rng.randn(PP_MICROBATCHES, PP_ROWS, PP_HID).astype(np.float32)
    dev = torch.device("cuda", 0)
    w, b, mb, lab = (torch.from_numpy(a).to(dev)
                     for a in (w_np, b_np, mb_np, lab_np))
    mesh = parallel.make_mesh({"pp": 1})
    out = {}
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = parallel.pipeline_forward(stage, {"w": w, "b": b}, mb, "pp",
                                      mesh=mesh)
    out["launches_forward"] = kernels.launch_counts()
    check(out["launches_forward"]["linear"] == PP_MICROBATCHES,
          "22a pipeline_forward launched K1 %d times, want %d"
          % (out["launches_forward"]["linear"], PP_MICROBATCHES))
    with torch.no_grad():
        seq = torch.stack([parallel.sequential_reference(
            stage, [{"w": w[0], "b": b[0]}], m) for m in mb])
    check(y.shape == mb.shape and bool(torch.isfinite(y).all()),
          "22a pipeline output %s, not finite or not %s"
          % (tuple(y.shape), tuple(mb.shape)))
    check(torch.equal(y, seq), "22a pipeline output not bit-equal to "
          "sequential_reference: max abs err %g"
          % float((y - seq).abs().max()))
    # K1's output against its plain version in float64 on the same card
    # tensors, at linear_parity's bound
    pre = mb.double() @ w[0].double().t() + b[0].double()
    mag = mb.double().abs() @ w[0].double().abs().t() + b[0].double().abs()
    err = (y.double() - torch.tanh(pre)).abs()
    check(bool((err <= 1e-6 * mag + 2e-7).all()), "22a pipeline output "
          "off tanh(x @ w.T + b) by %g above 1e-6 * (sum|x||w| + |b|)"
          % float((err - 1e-6 * mag - 2e-7).max()))
    out["output_max_abs_err_vs_float64"] = float(err.max())
    del pre, mag, err
    step = parallel.build_pipeline_train_step(
        stage, tool.ranks.mse, mesh, PP_MICROBATCHES, lr=lr)
    kernels.reset_launch_counts()
    loss, new = step({"w": w, "b": b}, mb, lab)
    out["launches_step"] = kernels.launch_counts()
    check(out["launches_step"]["linear"] == PP_MICROBATCHES,
          "22a the train step launched K1 %d times, want %d"
          % (out["launches_step"]["linear"], PP_MICROBATCHES))
    got = {k: v.cpu().numpy() for k, v in new.items()}
    start = {"w": w_np, "b": b_np}
    _, want, floor = tool._oracle_floor(torch, parallel, (w_np, b_np, mb_np,
                                                          lab_np), dev)
    dist_ = dp._normwise(got, want, start)
    check(dist_ <= floor, "22a the train step %g of the oracle's update "
          "away, bound %g (one float32 floor)" % (dist_, floor))
    out.update(loss=loss.item(), step_vs_oracle_normwise=dist_,
               float32_floor_normwise=floor)
    # the same step at 2 rows a microbatch, card against CPU
    small = [a[:, :2].contiguous() for a in (mb, lab)]
    _, card_new = step({"w": w, "b": b}, *small)
    cpu_step = parallel.build_pipeline_train_step(
        stage, tool.ranks.mse, _cpu_mesh(torch, "pp"), PP_MICROBATCHES,
        lr=lr)
    _, cpu_new = cpu_step({"w": w.cpu(), "b": b.cpu()},
                          *(a.cpu() for a in small))
    # rtol 1e-5, with an atol of 1e-5 of the tensor's largest entry for
    # the entries near zero; gate: the largest error as a share of the
    # error allowed
    gate = 0.0
    for k in ("w", "b"):
        c, h = card_new[k].cpu(), cpu_new[k]
        allowed = 1e-5 * (h.abs() + float(h.abs().max()))
        gate = max(gate, float(((c - h).abs() / allowed).max()))
        check(bool(((c - h).abs() <= allowed).all()), "22a the 2-row "
              "step's %s on the card off the CPU's by %g"
              % (k, float((c - h).abs().max())))
    out["card_vs_cpu_err_share_of_allowed"] = gate
    out["card_vs_cpu_update_normwise"] = dp._normwise(
        {k: v.cpu().numpy() for k, v in card_new.items()},
        {k: v.numpy() for k, v in cpu_new.items()}, start)
    with torch.no_grad():
        out["forward_ms"] = dp._event_ms(
            torch, lambda: parallel.pipeline_forward(
                stage, {"w": w, "b": b}, mb, "pp", mesh=mesh))
    out["step_ms"] = dp._event_ms(torch, lambda: step({"w": w, "b": b}, mb,
                                                      lab))
    print("22a pipeline over a one-rank pp mesh, K1 stage %d -> %d tanh, %d "
          "microbatches of %d: K1 %d launches a forward and %d a step, "
          "output bit-equal to sequential_reference and %.3g off float64, "
          "the step %.3g of the oracle's update away (one float32 floor %.3g), 2-row step card "
          "vs CPU at %.3g of rtol 1e-5 (its update %.3g apart, normwise); "
          "forward %.3f ms, forward+backward+update %.3f ms  [%s]"
          % (PP_HID, PP_HID, PP_MICROBATCHES, PP_ROWS,
             out["launches_forward"]["linear"],
             out["launches_step"]["linear"],
             out["output_max_abs_err_vs_float64"], dist_, floor, gate,
             out["card_vs_cpu_update_normwise"], out["forward_ms"],
             out["step_ms"], card))
    return out


def moe_one_card(torch, mx, kernels, card):
    """22a's MoE: Switch-Base-8's expert layer over a one-rank ep mesh."""
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import moe

    dp = _tools_module("torch_dp_check")
    experts, d_model, d_ff = MOE_SWITCH
    rng = np.random.RandomState(23)
    params_np = parallel.init_moe_params(rng, experts, d_model, d_ff)
    # a common offset skews the random router's choices, so that top-1
    # at capacity factor 1.25 overflows some experts
    x_np = (rng.randn(MOE_TOKENS, d_model)
            + 0.5 * rng.randn(d_model)).astype(np.float32)
    t_np = rng.randn(MOE_TOKENS, d_model).astype(np.float32)
    dev = torch.device("cuda", 0)
    params = {k: torch.from_numpy(v).to(dev) for k, v in params_np.items()}
    x, target = torch.from_numpy(x_np).to(dev), torch.from_numpy(t_np).to(dev)
    mesh = parallel.make_mesh({"ep": 1})
    out = {}
    with torch.no_grad():
        cap = parallel.expert_capacity(MOE_TOKENS, experts, 1, 1.25)
        y, aux = parallel.moe_ffn_local(params, x, "ep", 1, 1.25, mesh=mesh)
        token = moe._route(x, params["router"], experts, 1, cap)[0]
        zero_rows = int((y.abs().sum(dim=1) == 0).sum())
        assigned = torch.bincount(moe._softmax(x @ params["router"])
                                  .argmax(dim=1), minlength=experts)
    over = int((assigned - cap).clamp_min(0).sum())
    out.update(capacity=cap, dropped=zero_rows,
               dropped_by_route=MOE_TOKENS - int(token.numel()),
               assigned_by_expert=assigned.tolist(),
               dropped_by_counts=over)
    check(zero_rows == out["dropped_by_route"] == over and over > 0,
          "22a MoE top-1: %d zero rows, _route keeps %d of %d tokens, the "
          "experts' counts %s over capacity %d drop %d (and some must)"
          % (zero_rows, token.numel(), MOE_TOKENS, assigned.tolist(), cap,
             over))
    check(bool(torch.isfinite(y).all()) and float(aux) > 0,
          "22a MoE top-1: y not finite or aux %g" % float(aux))
    out["aux"] = float(aux)
    for top_k in (1, 2):
        with torch.no_grad():
            y, _ = parallel.moe_ffn_local(params, x, "ep", top_k, 8.0,
                                          mesh=mesh)
            want = parallel.moe_reference(params, x, top_k)
        ok = torch.allclose(y, want, rtol=MOE_TOL, atol=MOE_TOL)
        err = float((y - want).abs().max())
        check(ok, "22a MoE top-%d at capacity factor 8 off moe_reference by "
              "%g" % (top_k, err))
        out["top%d_vs_reference_max_abs_err" % top_k] = err

    def grads(fn):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        xs = x.detach().requires_grad_(True)
        torch.mean((fn(leaves, xs) - target) ** 2).backward()
        return dict({k: v.grad.cpu().numpy() for k, v in leaves.items()},
                    x=xs.grad.cpu().numpy())

    got = grads(lambda p, t: parallel.moe_ffn_local(p, t, "ep", 2, 8.0,
                                                    mesh=mesh)[0])
    want = grads(lambda p, t: parallel.moe_reference(p, t, 2))
    errs = {k: dp._normwise({k: got[k]}, {k: want[k]}, {k: 0})
            for k in want}
    check(all(v <= MOE_TOL for v in errs.values()), "22a MoE top-2 "
          "gradients off the dense oracle's (normwise, bound %g): %s"
          % (MOE_TOL, errs))
    out["grads_vs_reference_normwise"] = errs
    # 256 tokens, card against CPU
    xs = x[:MOE_CPU_TOKENS]
    with torch.no_grad():
        yc, ac = parallel.moe_ffn_local(params, xs, "ep", 1, 1.25, mesh=mesh)
        cpu = {k: v.cpu() for k, v in params.items()}
        yh, ah = parallel.moe_ffn_local(cpu, xs.cpu(), "ep", 1, 1.25,
                                        mesh=_cpu_mesh(torch, "ep"))
    err = float((yc.cpu() - yh).abs().max())
    check(torch.allclose(yc.cpu(), yh, rtol=MOE_TOL, atol=MOE_TOL)
          and abs(float(ac) - float(ah)) <= MOE_TOL * abs(float(ah)),
          "22a MoE %d tokens on the card off the CPU's by %g (aux %g vs %g)"
          % (MOE_CPU_TOKENS, err, float(ac), float(ah)))
    out["card_vs_cpu_max_abs_err"] = err

    def fwd_bwd():
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        y, aux = parallel.moe_ffn_local(leaves, x, "ep", 1, 1.25, mesh=mesh)
        (torch.mean((y - target) ** 2) + 0.01 * aux).backward()

    with torch.no_grad():
        out["forward_ms"] = dp._event_ms(
            torch, lambda: parallel.moe_ffn_local(params, x, "ep", 1, 1.25,
                                                  mesh=mesh))
    out["forward_backward_ms"] = dp._event_ms(torch, fwd_bwd)
    print("22a Switch-Base-8 expert layer over a one-rank ep mesh, %d "
          "tokens, d_model %d, d_ff %d, %d experts: top-1 at capacity "
          "factor 1.25 (capacity %d, tokens by expert %s) drops %d tokens, "
          "as _route's positions and the counts give; top-1/top-2 at 8.0 vs moe_reference max abs err %.3g / "
          "%.3g; top-2 gradients vs the dense oracle (normwise) %s; %d "
          "tokens card vs CPU %.3g; forward %.3f ms, forward+backward %.3f "
          "ms  [%s]"
          % (MOE_TOKENS, d_model, d_ff, experts, cap,
             out["assigned_by_expert"], zero_rows,
             out["top1_vs_reference_max_abs_err"],
             out["top2_vs_reference_max_abs_err"],
             {k: "%.3g" % v for k, v in errs.items()}, MOE_CPU_TOKENS, err,
             out["forward_ms"], out["forward_backward_ms"], card))
    return out


def pp_moe_one_card(torch, mx, kernels, card):
    """Phase 22a on one card (22b, over every visible card, runs last in
    the process: :func:`pp_moe_multi_path`). The one-rank meshes' process
    groups are destroyed at its end, as phases 7 and 20a destroy theirs,
    so that no later phase runs beside them."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        out = {"pipeline": pp_one_card(torch, mx, kernels, card),
               "moe": moe_one_card(torch, mx, kernels, card)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    print("phase 22a: %.1f s" % out["seconds"])
    return out


def pp_moe_multi_path(torch, mx, kernels, card):
    """22b: tools/torch_pp_moe_check.py's run over every visible card, one
    process a card, or a line saying it did not run."""
    n = torch.cuda.device_count()
    if n < 2:
        print("22b: not run, 1 card visible")
        return None
    t0 = time.perf_counter()
    tool = _tools_module("torch_pp_moe_check")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = tool.run(torch, n)
    check(not rec["failed"], "22b over %d cards: %s" % (n, rec["failed"]))
    for line in tool.summary(rec):
        print("22b " + line)
    rec["phase_seconds"] = time.perf_counter() - t0
    print("phase 22b: %.1f s" % rec["phase_seconds"])
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", help="write the full record here (JSON)")
    parser.add_argument("--ckpt-child", metavar="DIR",
                        help="run phase 8's SIGTERM child over DIR (the "
                        "phase starts it)")
    parser.add_argument("--async-child", metavar="DIR",
                        help="run one of phase 18b's dist_async workers "
                        "over DIR (the phase starts them through "
                        "tools/launch.py)")
    opts = parser.parse_args()
    # a crash in native code prints every thread's Python stack
    faulthandler.enable()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import _build
        from mxnet_tpu_torch.ops import kernels
    except ImportError as e:
        print("chip_smoke: the mxnet_tpu_torch package is not beside this "
              "script (%s)" % e, file=sys.stderr)
        return 2
    if opts.ckpt_child:
        return ckpt_child(opts.ckpt_child)
    if opts.async_child:
        return async_child(opts.async_child)
    # every phase profiles replays of CUDA graphs: CUPTI stays set up
    mx.profiler.keep_cupti()

    # 1. environment
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %d device(s): %s"
          % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
             torch.cuda.get_device_name(0)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s"
          % (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32))

    # 2. build
    t0 = time.perf_counter()
    log = _build.build_all()
    print("build: %s in %.1f s" % (sorted(_build.SOURCES),
                                   time.perf_counter() - t0))
    for name, rec in log.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  %s: %s" % (name, line.strip()))
    sass = {name: _build.tf32_mma_count(name) for name in TF32_KERNELS}
    print("TF32 tensor-core MMA instructions (cuobjdump -sass, HMMA ... "
          "TF32): %s" % sass)
    check(all(sass.values()), "a kernel that must run on the tensor cores "
          "holds no TF32 MMA instruction: %s" % sass)
    mma16 = _build.mma_counts("conv_gemm")
    print("conv_gemm tensor-core MMA instructions by instruction and "
          "operand type (cuobjdump -sass): %s" % mma16)
    check(mma16["hgmma"]["bf16"] > 0 and mma16["hgmma"]["f16"] > 0,
          "conv_gemm holds no bf16 or f16 wgmma (HGMMA): %s" % mma16)
    check(mma16["hmma"]["bf16"] == 0 and mma16["hmma"]["f16"] == 0,
          "conv_gemm still holds a 16-bit mma.sync (HMMA.16816): %s"
          % mma16)

    # 3. parity on the card
    counts = bn_shapes(mx)
    shapes = [(r, c, 0) for r, c in sorted(counts)] + RAGGED_SHAPES
    fwd_worst, cases = norm_act_fwd_parity(torch, kernels, shapes)
    print("norm_act_fwd parity: %d cases, max abs err f32 %g, bf16 %g, "
          "f16 %g (bit-equal)" % (cases, fwd_worst["float32"],
                                  fwd_worst["bfloat16"], fwd_worst["float16"]))
    bwd_worst, cases = norm_act_bwd_parity(torch, kernels, shapes)
    print("norm_act_bwd parity: %d cases, reruns bit-identical, dx max abs "
          "err f32 %g, bf16 %g, f16 %g; dscale/dshift vs float64: max abs "
          "err %g, max %.3g of sum|term| (bound 1e-5)"
          % (cases, bwd_worst["dx_float32"], bwd_worst["dx_bfloat16"],
             bwd_worst["dx_float16"], bwd_worst["sums_abs"],
             bwd_worst["sums_rel"]))
    gemms = conv_gemm_shapes(mx)
    gemm_worst, cases = conv_gemm_parity(
        torch, kernels, sorted(gemms) + RAGGED_GEMMS,
        ("float32", "bfloat16", "float16"))
    print("conv_gemm parity: %d cases (%d distinct products of the step + "
          "%d ragged, f32, bf16 and f16 operands), reruns bit-identical, "
          "max abs err vs float64 f32 %g, bf16 %g, f16 %g; max %.3g of "
          "sum|a||b| (16-bit %.3g; bound 1e-6)"
          % (cases, len(gemms), len(RAGGED_GEMMS),
             gemm_worst["abs_float32"], gemm_worst["abs_bfloat16"],
             gemm_worst["abs_float16"], gemm_worst["rel"],
             gemm_worst["rel_16"]))
    flash_worst, cases = flash_parity(torch, kernels)
    print("flash_attn parity: %d cases (%d shapes, causal and not), reruns "
          "bit-identical, max abs err vs plain %g (bound rtol 2e-4 / atol "
          "2e-5)" % (cases, len(FLASH_SHAPES), flash_worst))
    linear_worst, cases = linear_parity(torch, kernels)
    print("linear parity: %d cases, one launch a call, reruns "
          "bit-identical, max abs err vs float64 %g; max %.3g of "
          "sum|x||w|+|b| (bound 1e-6)"
          % (cases, linear_worst["abs"], linear_worst["rel"]))
    digests = linear_digests(torch, kernels)
    print("linear digests (sha256 of the output, seed 15): %s"
          % json.dumps(digests))
    rtc_check = rtc_parity(torch, mx)
    print("rtc parity: axpy and its float4 and ldg bodies bit-equal to "
          "2*x+y, gelu_ish max rel err %.3g (bound 1e-4), an in-place push "
          "equal to 2*x, bad body refused: %s"
          % (rtc_check["gelu_max_rel_err"], rtc_check["bad_body_log"]))

    # 4. timing at the main paths' shapes
    fwd_shapes, fwd_tot = norm_act_fwd_timing(torch, kernels, counts)
    print("norm_act_fwd per forward (53 launches, f32): kernel %.4f ms, "
          "plain %.4f ms, addcmul %.4f ms, bound %.4f ms  [%s]"
          % (fwd_tot["ms"], fwd_tot["plain_ms"], fwd_tot["library_ms"],
             fwd_tot["bound_ms"], card))
    bwd_shapes, bwd_tot = norm_act_bwd_timing(torch, kernels, counts)
    print("norm_act_bwd per step (53 launches, f32): kernel %.4f ms, plain "
          "%.4f ms, bound %.4f ms  [%s]"
          % (bwd_tot["ms"], bwd_tot["plain_ms"], bwd_tot["bound_ms"], card))
    gemm_shapes, gemm_tot = conv_gemm_timing(torch, kernels, gemms)
    print("conv_gemm per step (105 launches, f32): kernel %.4f ms, plain "
          "%.4f ms, torch.matmul %.4f ms, bound %.4f ms (%s; simt %.4f), "
          "%.1f TFLOP  [%s]"
          % (gemm_tot["ms"], gemm_tot["plain_ms"], gemm_tot["library_ms"],
             gemm_tot["bound_ms"], gemm_tot["bound_by"],
             gemm_tot["simt_bound_ms"], gemm_tot["flops"] / 1e12, card))
    flash_rows = flash_timing(torch, kernels)
    linear_rows = linear_timing(torch, kernels)
    rtc_time = rtc_timing(torch, mx)
    print("timed on [%s]" % card)

    # 5. serving, 6. training: the main paths
    serve = serve_main_path(torch, mx, kernels, card)
    images, labels = train_data()
    train = train_main_path(torch, mx, kernels, card, images, labels)
    fused = fused_train_path(torch, mx, kernels, card, images, labels, train)
    classic_params = (train["args"], train["aux"])     # phase 16's
    for run in (train, fused):
        del run["args"], run["aux"]
    print("classic vs fused, ResNet-50 NHWC batch 32 f32: host step %.3f / "
          "%.3f ms, %.1f / %.1f img/s, device busy %.1f%% / %.1f%%, device "
          "%.3f / %.3f ms a step, peak allocated %.3f / %.3f GB  [%s]"
          % (train["step_ms"], fused["step_ms"], train["img_per_s"],
             fused["img_per_s"], 100 * train["breakdown"]["busy_share"],
             100 * fused["breakdown"]["busy_share"],
             train["breakdown"]["device_ms_per_step"],
             fused["breakdown"]["device_ms_per_step"],
             train["peak_bytes"] / 1e9, fused["peak_bytes"] / 1e9, card))
    mnist = mnist_main_path(torch, mx, kernels, card)

    # 7. the slice's entry points at full width
    entry = entry_points_main_path(torch, mx, kernels)

    # 8. checkpoints through the fused step at full width
    ckpt_run = checkpoint_main_path(torch, mx, kernels, card)

    # 9. fit's health and input plane through the fused step at full width
    plane = plane_main_path(torch, mx, kernels, card)

    # 10. the ImageNet models at scale, NCHW, through the fused step
    models = models_main_path(torch, mx, kernels, card)
    model_paths = {}
    for name, run in models["models"].items():
        for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
            model_paths.setdefault(kernel, {}).update({
                "models_%s_classic" % name: run["launches_classic"][kernel],
                "models_%s_fused" % name: run["launches_fused"][kernel],
                "models_%s_fused_2_replays_profiled" % name:
                    run["replays_profiled"]["launches"][kernel]})

    # 11. every fusable optimizer through the fused step at full width
    optim = optim_main_path(torch, mx, kernels, card, images, labels)
    for kind, run in optim["kinds"].items():
        for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
            model_paths[kernel].update({
                "optim_%s_classic" % kind: run["launches_classic"][kernel],
                "optim_%s_fused" % kind: run["launches_fused"][kernel]})
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel]["optim_adam_ckpt_resume"] = \
            optim["adam_guards"]["resume"]["launches"][kernel]

    # 12. the bucketed LSTM language model, the fused RNN and the slice's
    # ops at full width
    lm = lm_main_path(torch, mx, kernels, card)
    lm_paths = {kernel: {
        "lm_bucketing_classic": count,
        "lm_fused_rnn_classic": lm["fused"]["classic"]["launches"][kernel],
        "lm_fused_rnn_fused": lm["fused"]["fused"]["launches"][kernel]}
        for kernel, count in lm["bucketing"]["launches"].items()}
    # the profiler's kernel events name the compiled kernels, not a user's
    # Rtc body
    for kernel, count in lm["fused"]["replay"]["launches"].items():
        lm_paths[kernel]["lm_fused_rnn_2_replays_profiled"] = count
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update(lm_paths[kernel])

    # 13. Fast R-CNN on VGG-16 and LSTM-OCR with WarpCTC at full width, the
    # slice's ops on the card, the executor surface
    det = rcnn_ocr_main_path(torch, mx, kernels, card)
    rcnn, ocr = det["rcnn"], det["ocr"]
    det_paths = {kernel: {
        "rcnn_classic": rcnn["classic"]["launches"][kernel],
        "rcnn_fused": rcnn["fused"]["launches"][kernel],
        "rcnn_custom_classic": rcnn["custom"]["launches"][kernel],
        "ocr_classic": ocr["launches_classic"][kernel],
        "ocr_fused": ocr["launches_fused"][kernel]}
        for kernel in rcnn["classic"]["launches"]}
    for kernel, count in rcnn["replays_profiled"]["launches"].items():
        det_paths[kernel]["rcnn_fused_2_replays_profiled"] = count
        det_paths[kernel]["ocr_fused_2_replays_profiled"] = \
            ocr["replays_profiled"]["launches"][kernel]
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update(det_paths[kernel])
    for kernel in ("linear", "flash_attn", "rtc"):
        lm_paths[kernel].update(det_paths[kernel])

    # 14. mixed precision and the adaptive serving plane: ResNet-50 NHWC
    # trained and served in bfloat16
    mp = mixed_precision_main_path(torch, mx, kernels, card, images,
                                   labels, train, fused, gemms)
    mp_train, mp_serve = mp["train"], mp["serve"]
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update({
            "mp_bf16_classic": mp_train["classic"]["launches"][kernel],
            "mp_bf16_fused": mp_train["fused"]["launches"][kernel],
            "mp_bf16_fused_2_replays_profiled":
                mp_train["fused"]["breakdown"]["launches"][kernel],
            "mp_f16_classic": mp_train["float16"]["classic_launches"][kernel],
            "mp_f16_fused": mp_train["float16"]["fused_launches"][kernel],
            "mp_bf16_serve": mp_serve["launches"][kernel]})
    for kernel in ("linear", "flash_attn", "rtc"):
        lm_paths[kernel].update({
            "mp_bf16_classic": mp_train["classic"]["launches"][kernel],
            "mp_bf16_fused": mp_train["fused"]["launches"][kernel],
            "mp_bf16_serve": mp_serve["launches"][kernel]})
    k3b, k3h = mp["k3_bfloat16"]["total"], mp["k3_float16"]["total"]

    # 15. the input plane: ResNet-50 trained from the uint8 cache, the crop
    # and normalisation inside the fused step's graph
    feed = feed_main_path(torch, mx, kernels, card, fused)
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update({
            "feed_fused": feed["feed"]["launches"][kernel],
            "feed_fused_2_replays_profiled":
                feed["feed"]["breakdown"]["launches"][kernel],
            "feed_classic": feed["classic"]["launches"][kernel],
            "feed_augment_fused": feed["augment"]["launches"][kernel],
            "feed_host_fused": feed["host"]["launches"][kernel],
            "feed_resume_fused": feed["resume"]["launches"][kernel]})
    for kernel in ("linear", "flash_attn", "rtc"):
        lm_paths[kernel].update({
            "feed_fused": feed["feed"]["launches"][kernel],
            "feed_classic": feed["classic"]["launches"][kernel]})
    roi16 = det["ops"]["bf16"]

    # 16. the mirrored backward and device observability: ResNet-50 NHWC
    # trained mirrored; the compile registry, sanitizers and profiler
    obs = mirror_obs_main_path(torch, mx, kernels, card, images, labels,
                               classic_params)

    # 17a. one process over several cards: device_sync and device on one
    # card (17b, over every visible card, runs last)
    dp = dp_main_path(torch, mx, kernels, card, images, labels,
                      classic_params[0])

    # 18. the dist stores: a one-worker dist_sync, dist_async with two
    # workers on the card, dist_sync over every visible card
    dist = dist_main_path(torch, mx, kernels, card, images, labels,
                          classic_params[0])
    del classic_params

    # 19. the autotuner: K3, K4 and K5 tuned on the card, then phase 6's
    # fit under the tuned cache
    tune = autotune_main_path(torch, mx, kernels, card, images, labels)
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update({
            "autotune_tuned_classic":
                tune["fit"]["launches_classic"][kernel],
            "autotune_tuned_fused": tune["fit"]["launches_fused"][kernel],
            "autotune_tuned_fused_2_replays_profiled":
                tune["fit"]["replays_profiled"][kernel]})

    # 20a. the sharding API: build_sgd_train_step over a one-rank (dp,
    # fsdp) mesh against the classic loop's step, f32 and bf16
    shard = shard_main_path(torch, mx, kernels, card, images, labels)
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update({
            "shard_build_step_%s" % d: shard[d]["launches"][kernel]
            for d in ("float32", "bfloat16")})
    # 21a. Dropout through the fused step on one card, as the multi-card
    # path holds it
    drop = dropout_one_card(torch, mx, kernels, card)
    alex = drop["models"]["alexnet"]["launches_per_card_2_replays"][0]
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel]["dropout_alexnet_one_card_2_replays_profiled"] \
            = alex[kernel]
    # 22a. pipeline and expert parallelism on one card: a K1 stage at 4096
    # over a one-rank pp mesh, Switch-Base-8's expert layer over a
    # one-rank ep mesh
    pp_moe = pp_moe_one_card(torch, mx, kernels, card)
    for kernel in ("linear", "flash_attn", "rtc"):
        lm_paths[kernel].update({
            "pp_one_card_forward":
                pp_moe["pipeline"]["launches_forward"][kernel],
            "pp_one_card_train_step":
                pp_moe["pipeline"]["launches_step"][kernel]})
    # 17b. one process over every visible card when there are two or more
    dp["multi"] = dp_multi_path(torch, mx, kernels, card)
    # 20b. fsdp over every visible card, after 17b
    shard["multi"] = shard_multi_path(torch, mx, kernels, card)
    # 21b. the device feed and Dropout over every visible card, after 20b
    drop["multi"] = dp_feed_multi_path(torch, mx, kernels, card)
    # 22b. pipeline and expert parallelism over every visible card, one
    # process a card, after 21b
    pp_moe["multi"] = pp_moe_multi_path(torch, mx, kernels, card)
    if pp_moe["multi"] is not None:
        for tag in ("pp", "pp_dp"):
            if tag in pp_moe["multi"]:
                p = pp_moe["multi"][tag]
                name = "".join("%s%d" % kv for kv in p["mesh"].items())
                for r, n in enumerate(p["k1_launches_a_forward_by_rank"]):
                    lm_paths["linear"]["%s_rank%d_forward" % (name, r)] = n
    feed_cards = {}
    if drop["multi"] is not None:
        a = drop["multi"]["a"]
        for d, counts in a["launches_per_card_2_replays"].items():
            for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd",
                           "crop_norm"):
                feed_cards.setdefault(kernel, {})[
                    "dp_feed_card%s_2_replays_profiled" % d] = counts[kernel]
        for name, m in drop["multi"]["b"]["models"].items():
            for d, counts in m["launches_per_card_2_replays"].items():
                model_paths["conv_gemm"][
                    "dp_dropout_%s_card%s_2_replays_profiled" % (name, d)] \
                    = counts["conv_gemm"]
        for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
            model_paths[kernel].update(feed_cards[kernel])
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        for kv in ("device_sync", "device"):
            model_paths[kernel].update({
                "dp_%s_fused" % kv: dp[kv]["launches"][kernel],
                "dp_%s_fused_2_replays_profiled" % kv:
                    dp[kv]["replays_profiled"][kernel]})
        model_paths[kernel].update({
            "dist_sync_one_worker_fused":
                dist["one_worker"]["launches"][kernel],
            "dist_sync_one_worker_fused_2_replays_profiled":
                dist["one_worker"]["replays_profiled"][kernel]})
    mirror = obs["mirror"]
    for kernel in ("conv_gemm", "norm_act_fwd", "norm_act_bwd"):
        model_paths[kernel].update({
            "mirror_fused": mirror["runs"]["mirror"]["launches"][kernel],
            "mirror_fused_2_replays_profiled":
                mirror["runs"]["mirror"]["breakdown"]["launches"][kernel],
            "mirror_classic": mirror["classic"]["launches"][kernel]})
    for kernel in ("linear", "flash_attn", "rtc"):
        lm_paths[kernel].update({
            "mirror_fused": mirror["runs"]["mirror"]["launches"][kernel],
            "mirror_classic": mirror["classic"]["launches"][kernel]})

    # 23. report
    train_scope = "%d launches of one ResNet-50 NHWC training step, batch " \
        "32, f32"
    fused_note = ("*_fused: the wrappers' counts over the fused fit, its "
                  "eager step and the launches its CUDA graph capture "
                  "recorded (a replay runs no wrapper); "
                  "*_2_replays_profiled: the launches the card ran in two "
                  "replays, counted from torch.profiler's kernel events; "
                  "train_fused_ckpt_resume: the wrappers' counts over the "
                  "checkpoint phase's resumed fit (its eager step and its "
                  "capture); train_fused_plane_numwatch: the same over "
                  "phase 9's fit with the numerics plane, the metrics "
                  "server and the flight recorder armed (every phase-9 "
                  "fit is checked to count the same); models_<net>_*: "
                  "phase 10's fits of AlexNet, VGG-16, GoogLeNet, "
                  "Inception-v3 and ResNet-50 in NCHW at batch 32 (classic: "
                  "5 steps; fused: the eager step and the capture; "
                  "replays: two, from the kernel events); optim_<kind>_*: "
                  "phase 11's ResNet-50 NHWC fits at batch 32 with each "
                  "fusable optimizer (classic: 5 steps; fused: the eager "
                  "step and the capture); optim_adam_ckpt_resume: its "
                  "Adam fit resumed from a snapshot; lm_*: phase 12's "
                  "bucketed lstm_unroll fit (18 classic steps) and the "
                  "lstm_fused fits (classic: 5 steps; fused: the eager "
                  "step and the capture; replays: two, from the kernel "
                  "events), none of whose ops has a compiled kernel; "
                  "rcnn_*: phase 13a's Fast R-CNN fits on VGG-16 at "
                  "600x1000 (classic: 5 steps; fused: the eager step and "
                  "the capture; replays: two, from the kernel events), "
                  "rcnn_custom_classic: 13b's 3 classic steps with the "
                  "rois from a Custom op; ocr_*: 13c's LSTM-OCR fits "
                  "(classic: 5 steps; fused: the eager step and the "
                  "capture; replays: two); mp_*: phase 14's ResNet-50 "
                  "NHWC fits at batch 32 under compute_dtype bfloat16 "
                  "(classic: 5 steps; fused: the eager step and the "
                  "capture; replays: two) and float16 (3 steps; fused: "
                  "the eager step and the capture), and its bf16 "
                  "InferenceServer's Poisson traffic; feed_*: phase 15's "
                  "ResNet-50 NHWC fits at batch 32 from the uint8 cache "
                  "with feed depth 2 (fused: 32 steps of the device feed, "
                  "the eager step and the capture; replays: two; classic: "
                  "4 steps; augment/host: 8 steps in device_augment and "
                  "host-crop mode, crop_norm launched by the iterator; "
                  "resume: 15d's resumed fit); mirror_*: phase 16's "
                  "ResNet-50 NHWC fits at batch 32 with "
                  "MXNET_BACKWARD_DO_MIRROR=1 (fused: the eager step and "
                  "the capture; replays: two; classic: 5 steps), where a "
                  "step launches K4 once more for each BatchNorm its "
                  "backward recomputes; dp_*: phase 17a's ResNet-50 NHWC "
                  "fused fits at batch 32 over [gpu(0)] under the "
                  "device_sync and device stores (the eager step and the "
                  "capture; replays: two); dist_sync_one_worker_*: phase "
                  "18a's fused fit under a one-worker dist_sync (the eager "
                  "step and the capture; replays: two); autotune_tuned_*: "
                  "phase 19b's fits with MXNET_TPU_AUTOTUNE=1 over 19a's "
                  "cache (classic: 5 steps; fused: the eager step and the "
                  "capture; replays: two); shard_build_step_*: phase 20a's "
                  "one parallel.build_sgd_train_step call at batch 32 over "
                  "a one-rank (dp, fsdp) DeviceMesh, f32 and bf16; "
                  "dropout_alexnet_one_card_*: phase 21a's two profiled "
                  "replays of AlexNet with Dropout at batch 32; "
                  "dp_feed_card<k>_*: phase 21b's two profiled replays of "
                  "ResNet-50 NHWC from the uint8 feed on card k (32 a "
                  "card); dp_dropout_<net>_card<k>_*: 21b's two profiled "
                  "replays of each Dropout network on card k; "
                  "pp_one_card_*: phase 22a's pipeline_forward over 8 "
                  "microbatches and one build_pipeline_train_step step "
                  "on a one-rank pp mesh (a K1 stage a tick); "
                  "pp<n>[dp<m>]_rank<k>_forward: 22b's pipeline_forward "
                  "on rank k of n stages (num_mb + n - 1 ticks, a K1 "
                  "launch each)")
    records = [{
        "name": "norm_act_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:579",
        "launches": train["launches"]["norm_act_fwd"],
        "launches_by_path": {
            "serve": serve["launches"],
            "train": train["launches"]["norm_act_fwd"],
            "train_fused": fused["launches"]["norm_act_fwd"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["norm_act_fwd"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["norm_act_fwd"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["norm_act_fwd"],
            **model_paths["norm_act_fwd"]},
        "launches_note": fused_note,
        "max_abs_err": fwd_worst["float32"],
        "max_err_f32": fwd_worst["float32"],
        "max_err_bf16": fwd_worst["bfloat16"],
        "max_err_f16": fwd_worst["float16"],
        "ms": fwd_tot["ms"], "plain_ms": fwd_tot["plain_ms"],
        "bound_ms": fwd_tot["bound_ms"], "bound_by": "bytes",
        "library_ms": fwd_tot["library_ms"],
        "scope": "53 launches of one ResNet-50 NHWC forward, batch 32, f32",
        "autotune": {d: tune["step_ms"]["norm_act_fwd_" + d]
                     for d in ("float32", "bfloat16")},
    }, {
        "name": "norm_act_bwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/norm_act.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:610",
        "launches": train["launches"]["norm_act_bwd"],
        "launches_by_path": {
            "train": train["launches"]["norm_act_bwd"],
            "train_fused": fused["launches"]["norm_act_bwd"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["norm_act_bwd"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["norm_act_bwd"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["norm_act_bwd"],
            **model_paths["norm_act_bwd"]},
        "launches_note": fused_note,
        "max_abs_err": max(bwd_worst["dx_float32"], bwd_worst["sums_abs"]),
        "max_err_dx_f32": bwd_worst["dx_float32"],
        "max_err_dx_bf16": bwd_worst["dx_bfloat16"],
        "max_err_dx_f16": bwd_worst["dx_float16"],
        "max_sum_err_of_abs_sum": bwd_worst["sums_rel"],
        "ms": bwd_tot["ms"], "plain_ms": bwd_tot["plain_ms"],
        "bound_ms": bwd_tot["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes dx, dscale and "
                        "dshift together",
        "scope": train_scope % BN_LAYERS,
        "autotune": {d: tune["step_ms"]["norm_act_bwd_" + d]
                     for d in ("float32", "bfloat16")},
    }, {
        "name": "conv_gemm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/conv_gemm.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:319",
        "launches": train["launches"]["conv_gemm"],
        "launches_by_path": {
            "train": train["launches"]["conv_gemm"],
            "train_fused": fused["launches"]["conv_gemm"],
            "train_fused_2_replays_profiled":
                fused["breakdown"]["launches"]["conv_gemm"],
            "train_fused_ckpt_resume":
                ckpt_run["resume"]["launches"]["conv_gemm"],
            "train_fused_plane_numwatch":
                plane["numwatch"]["launches"]["conv_gemm"],
            "mnist_lenet_fused": mnist["lenet"]["launches"]["conv_gemm"],
            "mnist_lenet_fused_2_replays_profiled":
                mnist["lenet"]["replay_launches"]["conv_gemm"],
            **model_paths["conv_gemm"]},
        "launches_note": fused_note,
        "max_abs_err": max(gemm_worst["abs_float32"],
                           models["k3_parity"]["abs_float32"]),
        "max_err_bf16": max(gemm_worst["abs_bfloat16"],
                            models["k3_parity"]["abs_bfloat16"]),
        "max_err_f16": gemm_worst["abs_float16"],
        "max_err_of_abs_product_16bit": gemm_worst["rel_16"],
        "mma_sass": mma16,
        "bf16_ms": k3b["ms"], "bf16_plain_ms": k3b["plain_ms"],
        "bf16_bound_ms": k3b["bound_ms"], "bf16_bound_by": k3b["bound_by"],
        "bf16_library_ms": k3b["library_ms"],
        "bf16_library_call": k3b["library_call"],
        "bf16_pad_copy_ms": [r["pad_copy_ms"] for r in
                             mp["k3_bfloat16"]["shapes"]
                             if r["pad_copy_ms"] is not None],
        "f16_ms": k3h["ms"], "f16_plain_ms": k3h["plain_ms"],
        "f16_bound_ms": k3h["bound_ms"], "f16_library_ms": k3h["library_ms"],
        "bf16_launches": mp_train["classic"]["launches"]["conv_gemm"],
        "launch_records_note": "mp_* paths: every K3/K4/K5 launch with "
                               "16-bit operands (launch_records)",
        "max_err_of_abs_product": max(gemm_worst["rel"],
                                      models["k3_parity"]["rel"]),
        "ms": gemm_tot["ms"], "plain_ms": gemm_tot["plain_ms"],
        "bound_ms": gemm_tot["bound_ms"], "bound_by": gemm_tot["bound_by"],
        "simt_bound_ms": gemm_tot["simt_bound_ms"],
        "tf32_mma_sass": sass["conv_gemm"],
        "library_ms": gemm_tot["library_ms"],
        "library_call": "torch.matmul on the same operands",
        "scope": train_scope % CONV_GEMMS,
        "autotune": {d: tune["step_ms"]["conv_gemm_" + d]
                     for d in ("float32", "bfloat16")},
        "autotune_note": "phase 19a: the kernel's ms a step (default_ms: "
                         "its own launch rule; tuned_ms: each shape's "
                         "winner), summed over the step's launches",
    }, {
        "name": "linear", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/linear.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:56",
        "launches": entry["launches"]["linear"],
        "launches_by_path": dict(entry_points=entry["launches"]["linear"],
                                 **lm_paths["linear"]),
        "launches_note": fused_note,
        "max_abs_err": linear_worst["abs"],
        "max_err_of_abs_product": linear_worst["rel"],
        "ms": linear_rows[1]["ms"], "plain_ms": linear_rows[1]["plain_ms"],
        "bound_ms": linear_rows[1]["bound_ms"],
        "bound_by": linear_rows[1]["bound_by"],
        "simt_bound_ms": linear_rows[1]["simt_bound_ms"],
        "tf32_mma_sass": sass["linear"],
        "library_ms": linear_rows[1]["library_ms"],
        "library_call": "torch.addmm (plus the activation)",
        "small_layer_ms": linear_rows[0]["ms"],
        "small_layer_library_ms": linear_rows[0]["library_ms"],
        "small_layer_bound_ms": linear_rows[0]["bound_ms"],
        "pipeline_stage_ms": linear_rows[-1]["ms"],
        "pipeline_stage_plain_ms": linear_rows[-1]["plain_ms"],
        "pipeline_stage_bound_ms": linear_rows[-1]["bound_ms"],
        "pipeline_stage_bound_by": linear_rows[-1]["bound_by"],
        "pipeline_stage_library_ms": linear_rows[-1]["library_ms"],
        "digests": digests,
        "scope": "one call at ResNet-50's head, (%d, 2048) -> 1000, f32, "
                 "the entry-point path's shape; small_layer_*: (128, 256) "
                 "-> 128; pipeline_stage_*: phase 22's stage, (32, 4096) "
                 "-> 4096 tanh (library: tanh(addmm))" % BATCH,
    }, {
        "name": "flash_attn", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attn.cu",
        "replaces": "mxnet_tpu/ops/pallas_kernels.py:154",
        "launches": entry["launches"]["flash_attn"],
        "launches_by_path": dict(
            entry_points=entry["launches"]["flash_attn"],
            **lm_paths["flash_attn"]),
        "launches_note": fused_note,
        "max_abs_err": flash_worst,
        "ms": flash_rows[1]["ms"], "plain_ms": flash_rows[1]["plain_ms"],
        "bound_ms": flash_rows[1]["bound_ms"], "bound_by": "operations",
        "simt_bound_ms": flash_rows[1]["simt_bound_ms"],
        "tf32_mma_sass": sass["flash_attn"],
        "library_ms": flash_rows[1]["library_ms"],
        "library_call": "F.scaled_dot_product_attention on (B, H, T, D)",
        "scope": "one call at the demo's %s, causal, f32, the ulysses "
                 "path's shape" % (DEMO_ATTN,),
    }, {
        "name": "rtc", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py (NVRTC, body compiled at run "
                  "time)",
        "replaces": "mxnet_tpu/rtc.py:71",
        "launches": entry["launches"]["rtc"],
        "launches_by_path": dict(entry_points=entry["launches"]["rtc"],
                                 **lm_paths["rtc"]),
        "launches_note": fused_note,
        "max_abs_err": rtc_check["axpy_max_abs_err"],
        "gelu_max_rel_err": rtc_check["gelu_max_rel_err"],
        "ms": rtc_time["ms"], "plain_ms": rtc_time["plain_ms"],
        "bound_ms": rtc_time["bound_ms"], "bound_by": "bytes",
        "library_ms": rtc_time["library_ms"],
        "yardstick_ms": rtc_time["yardstick_ms"],
        "library_call": "torch.add(y, x, alpha=2), the axpy body's function",
        "library_note": "a user kernel: the body timed is one choice of "
                        "many; every time here is the axpy body's",
        "scope": "one push of the axpy body over %d float32 elements"
                 % RTC_N,
    }, {
        "name": "roi_pool", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/roi_pool.cu",
        "replaces": "mxnet_tpu/ops/vision.py:28 (ROIPooling in XLA; no "
                    "Pallas kernel: a port-only kernel)",
        "launches": rcnn["classic"]["launches"]["roi_pool"],
        "launches_by_path": dict(det_paths["roi_pool"], **{
            k: 0 for k in model_paths["conv_gemm"] if k not in
            det_paths["roi_pool"]}),
        "launches_note": fused_note + "; a training step launches "
                         "roi_pool twice (forward and backward)",
        "max_abs_err": rcnn["roi_pool"]["bwd_max_abs_err"],
        "forward_bit_equal": True,
        "ms": rcnn["roi_pool"]["ms"], "plain_ms": rcnn["roi_pool"]["plain_ms"],
        "fwd_ms": rcnn["roi_pool"]["fwd_ms"],
        "bwd_ms": rcnn["roi_pool"]["bwd_ms"],
        "plain_fwd_ms": rcnn["roi_pool"].get("plain_fwd_ms"),
        "plain_bwd_ms": rcnn["roi_pool"].get("plain_bwd_ms"),
        "plain_oom": rcnn["roi_pool"].get("plain_oom"),
        "bound_ms": rcnn["roi_pool"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call computes ROIPooling",
        "bf16_ms": roi16["bfloat16"]["ms"],
        "bf16_fwd_ms": roi16["bfloat16"]["fwd_ms"],
        "bf16_bwd_ms": roi16["bfloat16"]["bwd_ms"],
        "bf16_plain_ms": roi16["bfloat16"]["plain_ms"],
        "bf16_bound_ms": roi16["bfloat16"]["bound_ms"],
        "bf16_bwd_max_eps_of_abs_sum":
            roi16["bfloat16"]["bwd_max_eps_of_abs_sum"],
        "f16_ms": roi16["float16"]["ms"],
        "f16_plain_ms": roi16["float16"]["plain_ms"],
        "f16_bwd_max_eps_of_abs_sum":
            roi16["float16"]["bwd_max_eps_of_abs_sum"],
        "bf16_launches_by_path": {
            "rcnn_bf16_%s" % k: v["launches"]["roi_pool"]
            for k, v in roi16["fit"].items()},
        "scope": "one training step's forward and backward at Fast R-CNN's "
                 "conv5_3, (2, 512, 37, 62) f32, 128 rois, 7x7 bins; "
                 "max_abs_err: the backward against the plain version "
                 "(the forward is bit-equal); bf16_*/f16_*: the same in "
                 "16 bits (13d), the backward within %d epsilons of the "
                 "sum of its terms' magnitudes" % ROI_16_EPS,
    }, {
        "name": "crop_norm", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/crop_norm.cu",
        "replaces": "mxnet_tpu/io_cache.py:455 and mxnet_tpu/fused_step.py"
                    ":543 (the device feed's crop and normalisation in XLA; "
                    "no Pallas kernel: a port-only kernel)",
        "launches": feed["feed"]["launches"]["crop_norm"],
        "launches_by_path": {
            "feed_fused": feed["feed"]["launches"]["crop_norm"],
            "feed_fused_2_replays_profiled":
                feed["feed"]["breakdown"]["launches"]["crop_norm"],
            "feed_classic": feed["classic"]["launches"]["crop_norm"],
            "feed_augment_fused": feed["augment"]["launches"]["crop_norm"],
            "feed_host_fused": feed["host"]["launches"]["crop_norm"],
            "feed_resume_fused": feed["resume"]["launches"]["crop_norm"],
            **feed_cards.get("crop_norm", {})},
        "launches_note": fused_note + "; a fused step launches crop_norm "
                         "once, inside its graph (over several cards once "
                         "on each card, on its rows: dp_feed_card<k>_*, "
                         "21b); the classic loop once a batch when it "
                         "materialises the feed",
        "ms_a_replay_by_card": (
            None if drop["multi"] is None else
            drop["multi"]["a"]["crop_norm_ms_a_replay_by_card"]),
        "ms_a_replay_by_card_note": "21b: crop_norm's kernel time in a "
                                    "replay of the fused step over the "
                                    "cards, 32 rows a card (torch.profiler)",
        "max_abs_err": feed["crop_norm"]["max_abs_err"],
        "ms": feed["crop_norm"]["ms"], "plain_ms": feed["crop_norm"]["plain_ms"],
        "nchw_ms": feed["crop_norm"]["nchw_ms"],
        "nchw_plain_ms": feed["crop_norm"]["nchw_plain_ms"],
        "bound_ms": feed["crop_norm"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call crops, mirrors and "
                        "normalises",
        "scope": "one launch at ResNet-50's feed, (32, 256, 256, 3) uint8 "
                 "-> (32, 224, 224, 3) float32 NHWC, half the rows "
                 "mirrored; bound: the crops' bytes read once, the batch "
                 "written once, at 3.35 TB/s; max_abs_err: against the "
                 "plain version (bit-equal)",
    }]
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "cuda": torch.version.cuda, "kernels": records,
                       "norm_act_fwd_shapes": fwd_shapes,
                       "norm_act_bwd_shapes": bwd_shapes,
                       "conv_gemm_shapes": gemm_shapes,
                       "flash_attn_shapes": flash_rows,
                       "linear_shapes": linear_rows, "rtc_timing": rtc_time,
                       "main_path": serve, "train_path": train,
                       "train_fused_path": fused, "mnist_path": mnist,
                       "entry_points": entry,
                       "checkpoint_path": {k: v for k, v in ckpt_run.items()
                                           if k != "mod"},
                       "plane_path": plane, "models_path": models,
                       "optim_path": optim, "lm_path": lm,
                       "detection_ocr_path": det,
                       "mixed_precision_path": mp,
                       "feed_path": feed, "mirror_obs_path": obs,
                       "dp_path": dp, "dist_path": dist,
                       "autotune_path": tune, "shard_path": shard,
                       "dp_feed_dropout_path": drop,
                       "pp_moe_path": pp_moe}, f,
                      indent=1,
                      default=str)
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
