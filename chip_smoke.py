#!/usr/bin/env python3
"""Smoke run of qtpu_torch on one NVIDIA GPU — the quickest proof that the
port builds and serves on the card.

    python3 chip_smoke.py          # from the repository root, one CUDA device

Phases (any failure exits non-zero; the last line is printed only on
success):

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``qtpu_torch/csrc`` (one ``nvcc`` per source,
   all started together);
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it at batch 8 — outputs must be identical (same
   formula, same order, same card): K1 and K2 at ResNet-50's shapes (K1
   also at B = 128: layer1 conv3 and conv1, layer2_0's downsample, layer4
   conv3, the fc; every K1 row on the kernel its dispatch picks — the TMA +
   wgmma ring, or the narrow-row kernel ``csrc/wgmma_narrow.cuh`` for rows
   of 4-byte multiples and N < 64 — and on the old mma.sync loop forced,
   which must agree, the ring forced too on narrow rows it can address),
   K1 at MobileNet-v2's (block1's K = 96 project, block2's and block3's K =
   24 expands with relu6, block2's narrow project with the int8 residual,
   at B = 8 and 128 on the narrow-row kernel; the f32 relu6 head), K3 (its
   halo kernel) at three of its
   depthwise shapes and at two of them at B = 128, K2 at ResNet-50's 3×3s
   (B = 8 layer1 and layer2_0; B = 128 the stride-1 conv2 of every stage
   and the stride-2 conv2 of layer2_0-layer4_0: the implicit GEMM on the
   TMA + wgmma ring, pads read in the kernel) and at the quantized stems
   (Ci = 3: MobileNet-v1's 3×3/2, ResNet-50's 7×7/2 with SAME pads and
   with torchvision's (3, 3): the stem kernel),
   every K2 row also on the old mma.sync loop forced, which must agree,
   and the fused bottleneck kernels at one ResNet-50 block per stage: K4
   (qproj) at layer1_0 (stride 1) and layer2_0-layer4_0 (stride 2), K5
   (qtail) and K6 (qblock) at layer1-layer4, at B = 8 and B = 128, on the
   wgmma kernel their dispatch gives them (``ops/qproj.k4_path``: K1's
   ring as a two-GEMM tile; ``ops/qtail.tail_path``) and on the older
   mma.sync kernel forced, which must agree, and the chained kernels at the
   runs the chained engines give them — K7 (qstage) at ResNet-50's four
   identity runs, K8 (qstage_proj) at its whole layer1, K9 (qivr) at
   MobileNet-v2's five inverted-residual runs, on the kernel their dispatch
   gives (``ops/qstage.stage_path``, ``stage_proj_path``,
   ``ops/qivr.ivr_path``: the wgmma runner ``csrc/wgmma_phase.cuh``,
   planned by ``ops/chain_plan.chain_plan``; K8 its own instantiation;
   K9's block2 run, C = 24, on its narrow-row path) and on the older kernel
   forced with ``path="igemm"``, which must agree; K4-K9 also against the
   unfused K1/K2/K3 sequence each replaces; K1's int4 entry at
   ``resnet50_int4w_int8a_qat``'s shapes (layer1_0 conv3 with the int8
   residual, layer3 conv1, layer4 conv3, layer4_0's f32 downsample), also
   against the int8 entry on the unpacked weights; the im2col conv at
   ResNet-50's quantized 7×7/2 stem, also against K2 (its stem kernel);
   for the module SERVE path and the KL configs, at B = 8 and 128: K2's
   raw int32 accumulator at zero-point-padded shapes (ResNet-50's layer1
   3×3 and a 3×3/2 on wgmma, the pads corrected by zp·tapsum; LeNet-5's
   conv1, 28² Ci = 1 5×5 SAME, and conv2, 14² Ci = 6 VALID, on the
   small-channel kernel, pads written in the kernel; ResNet-18's 1×1/2
   downsample as a 1×1 window on wgmma), K3's raw accumulator at
   MobileNet-v2's block2, K1's raw accumulator at LeNet-5's fc shapes (K =
   400 / 120 / 84, N = 120 / 84 / 10), K1 and K2 (wgmma, the stem and
   the small kernels) requantising onto symmetric grids (shift 0) at
   ResNet-18's and ResNet-20's shapes (its 16- and 32-channel 3×3s, an int8
   residual, the stride-2 conv1s) — each also on the old loop forced,
   which must agree, and the small and stem kernels' rows on the small
   kernel with each multiply (mma.sync, wgmma) forced; the raw accumulators
   at the QAT
   trainer's B = 16 (config 5's layer1_1 conv1, layer1 3×3, layer2_0's
   3×3/2 and 1×1/2 downsample; config 3's block2 expand, depthwise and
   project and its Ci = 3 stem); and the integer-forward QAT conv
   (``ops/qat_int.qat_int_conv``) at those eight shapes against its plain
   version (``qat_int_conv_plain``, the float64 accumulator) on the card:
   the int32 accumulators, the output and both gradients equal; the fp32
   simulation on the card (TF32 off) against the integer forward, rel-L2
   ≤ 1e-5; the fp32 stems from uint8 pixels to int8 codes (K10,
   ``ops/qstem.stem_fp32_codes``) at ResNet-50's 7×7/2 and MobileNet-v2's
   3×3/2 ReLU6, B = 8 and 128, bit-equal to their plain versions
   (cuDNN's conv, whose tap order K10 keeps, and PyTorch's glue), and
   ResNet's max-pool on codes (K11) exactly, each timed beside that plain
   sequence (its yardstick);
4. the slices, each driven with the launch counters zeroed just before and
   read just after.  Every engine served through ``ServingEngine`` replays
   one CUDA graph a bucket (``serve/graphs.py``), and ``drive`` serves it
   under the profiler: its launches are the replayed kernels counted by
   name in the trace, each round's equal to the direct forward's, none
   plain, and route by route equal to what the graphs recorded at capture
   (which each replay adds to the counters); (a) every response of every
   round bit-equal to the engine's eager forward of the same rows padded
   as served, (c) 24 requests through a one-bucket engine of the same
   forward (pipelined rounds) each its own rows:
   * ``build_engine`` for ``resnet50_imagenet_int8_ptq_fp32stem`` at full
     width (224×224, 1000 classes, seeded random weights, calibrate,
     freeze) serves requests spanning two batch buckets through
     ``ServingEngine``: 37 K1 and 16 K2 launches per forward, one K10
     (the fp32 stem from the pixels to codes) and one K11 (the max-pool on
     codes), none on the plain path; the served logits are finite and
     match the flat engine's forward (every fp32-stem ResNet forward below
     also launches one K10 and one K11, every fp32-stem MobileNet forward
     one K10, every ImageNet ResNet with a quantized stem one K11);
   * the same frozen tree served by ``ExperimentalResNetInt8Engine`` in its
     three configurations, through ``ServingEngine`` with a forward factory:
     ``tail`` (``use_qtail`` + ``use_qproj``: 17 K1, 4 K2, 4 K4, 12 K5 per
     forward), ``block`` (``use_qblock`` + ``use_qproj``: 5 K1, 4 K2,
     4 K4, 12 K6) and ``stage`` (``use_qstage`` + ``qstage_proj`` +
     ``use_qproj``: 4 K1, 3 K2, 3 K4, 3 K7, 1 K8);
   * the same for ``mobilenetv2_imagenet_int8_ptq_fp32stem`` (17 inverted
     residuals, the 320→1280 head): 35 K1, 17 K3 and 1 K10 launches per
     forward, no K2, none on the plain path; the same tree through
     ``ExperimentalMobileNetV2Int8Engine`` ``ivr`` (``use_qivr``: 15 K1,
     7 K3, 5 K9);
   * one direct forward each of ``mobilenetv1_imagenet_int8_ptq_fp32stem``
     and ``mobilenetv1_imagenet_int8_ptq``: 14 K1 and 13 K3 launches, plus
     one K2 for the quantized 3×3/2 stem; one direct forward of
     ``resnet50_imagenet_int8_ptq`` (the quantized 7×7/2 stem): 37 K1 and
     17 K2 (16 3×3s and the stem);
   * ``build_engine`` for ``resnet50_int4w_int8a_qat`` (int4 weights, EMA
     calibration, stem and fc in fp32) serves through ``ServingEngine``:
     36 K1 and 16 K2 per forward; the same tree on
     ``ResNetInt8Engine(packed_int4=True)`` through a forward factory: 36 of
     K1's int4 entry and 16 K2, no int8 K1; one forward of its ``stage``
     configuration with ``packed_int4``: 7 K1 int4, 5 K2, 3 K4, 2 K7, 1 K8
     (layer4 stays unchained: its consumer is the fp32 fc);
   * ``build_engine`` for ``lenet_mnist_int8`` serves through
     ``ServingEngine`` on the module SERVE path (3 K1 and 2 K2 a forward),
     its logits equal to the SERVE
     model's called directly; ``build_engine`` for
     ``resnet18_cifar10_int8_kl`` (flat engine, BasicBlock, the int8 CIFAR
     stem on K2's stem kernel, symmetric grids: 4 K1, 17 K2) and one
     forward of its tree on the module path (1 K1, 20 K2: the downsamples
     as 1×1 windows); ``build_engine`` for ``resnet20_cifar10_int8_kl``
     (3 K1, 19 K2; its 16- and 32-channel 3×3s on the small kernel);
     ``resnet50_imagenet_int8_ptq_fp32stem`` with ``exclude=("stem*",
     "*/down")`` through ``build_engine`` on the module path at full width
     (33 K1 and 16 K2 a forward, all raw, no pad copy); one module-path
     forward of ``mobilenetv2_imagenet_int8_ptq_fp32stem`` with
     ``exclude=("stem*", "block1/*")`` (33 K1, 16 K3 raw); one flat-engine
     forward of ``resnet101_imagenet_int8_ptq_fp32stem`` (71 K1, 33 K2),
     calibrated on 2 of its 8 batches (a cut, to keep the script short);
     each build's calibration seconds, the KL configs' histogram pass and
     host threshold search apart;
   * the QAT trainer, BASELINE configs 5 (``resnet50_int4w_int8a_qat``)
     and 3 (``mobilenetv2_imagenet_int8_qat``) at full width (224², 1000
     classes, B = 16) with the integer forward, through
     ``examples.run.experiment`` (the path ``run_experiment`` takes: fp32
     steps, convert, QAT steps, evaluation, its JSON line), cut to
     ``n_train`` 64, ``n_eval`` 32, one fp32 and one QAT epoch, under the
     profiler: the run's launches, counted by name in its trace (and the
     counters, the graphs' records on replays, equal to them route by
     route), equal its QAT forwards (steps and eval batches) times one
     QAT forward's, which the module path's routing gives (config 5: 33
     K1 + 19 K2; config 3: 34 K1 + 1 K2 + 17 K3), none plain, the
     parameters finite; its trace holds the expected CUDA-graph captures
     and launches; one more QAT step launching exactly that, its
     loss finite; then each QAT-trained model frozen from its EMA state
     and served on its flat engine through ``ServingEngine`` (config 5:
     36 K1 + 16 K2; config 3: 35 K1 + 1 K2 + 17 K3);
   * on every one of these runs K1's, K2's, K3's, K5's and K6's launches
     are also counted by kernel (``launches_wgmma``/``_wgmma_cp``/
     ``_igemm`` of K1's int8 entry, ``_wgmma``/``_igemm`` of its int4
     entry, ``launches_wgmma``/``_stem``/``_small``/``_igemm`` of K2,
     ``launches_halo``/``_scalar`` of K3, ``launches_wgmma``/``_igemm`` of
     K5 and K6, which must add up to the launch counts), and so are
     zero-point pad copies (``qops.resolve_and_pad.calls``, through which
     K2's old loop pads too): no K1 or K2 launch of any run may take the
     old mma.sync loops but the narrow fcs of a batch (LeNet-5's fc2 and
     fc3, the CIFAR fcs: fewer than 512 rows, where the old loop is the
     faster), and no run may copy a pad; every K1 and K2
     launch of the ResNet-50 and config-5 engines must take the wgmma
     kernels, the runs that took the old loops before the narrow-row and
     small kernels (MobileNet-v2 and ``ivr``, LeNet-5, ResNet-18 KL and
     its module path, ResNet-20 KL, config 3's QAT run and its frozen
     engine) their K1 / K2 launches there, the int8 stems of
     MobileNet-v1 and ResNet-50 K2's stem kernel, every K3 launch the halo
     kernel, every K5 and K6 launch (the tail and block runs' 12 a
     forward) the wgmma kernel, every K4 launch (4 a tail or block
     forward, 3 a stage one) the two-GEMM tile, every K7 launch (3 a stage
     forward, 2 a packed one), K8 launch (1 a stage forward) and K9 launch
     (5 an ivr forward) the runner, and no run may copy an activation to
     pad it;
5. the ResNet-50 (product, tail, block, stage, and the product engine
   with the quantized stem), MobileNet-v2 (product, ivr) and
   quantized-stem MobileNet-v1 engines against the same engines on
   the CPU (the plain path) on two images: codes after every step of the
   forward (a block, or a chained run) follow the tie rule (equal except
   one step on ≤ 0.1% of elements; v1's last block emits f32, equal to rtol
   1e-6), logits agree to rel-L2 ≤ 1e-4; on the card, the tail, block,
   stage and ivr engines' codes after every step equal the product
   engine's (the fused and chained kernels are bit-exact against the
   sequence they replace); the same for config 5's packed and packed
   ``stage`` engines, against its product engine (the int8 entry on the
   unpacked weights) on the card, the last block's f32 output (the fp32
   fc's input) equal to the CPU's to 1e-6 of its largest value; the
   ResNet-18/20 KL and ResNet-101 flat engines walked step by step the
   same way; the module-path models (LeNet-5, ResNet-18 KL, the ResNet-50
   and MobileNet-v2 ones) against the same trees' models on the CPU: the
   codes at every quantized layer's input by the tie rule, logits to
   rel-L2 ≤ 1e-4; the QAT-frozen models walked the same way; one QAT step
   of each config (integer forward, B = 2, full width) on the card
   against the same step on the CPU from the same weights, teacher-forced
   layer by layer (each layer's CPU copy takes the input, the output
   gradient and the batch statistics the card's saw: outputs rel-L2 ≤
   1e-5, parameter gradients rel-L2 ≤ 1e-3, running statistics rtol
   1e-6, EMA observers equal; weight codes that cross a tie from the
   CPU's one-ulp-off fp32 sqrt in BatchNorm's fold held by the tie rule,
   the CPU then run on the card's codes — C22; a layer whose output is
   off by more than 1e-5 has its codes compared card against CPU and
   logged) and as a whole step (losses finite and within rtol 5e-2: codes
   across ties amplify);  ``python3 chip_smoke.py --qat-check N`` repeats
   config 3's teacher-forced check N times alone, after measuring the fp32
   sqrt's rounding on both devices: C22's regression check, to run after
   a change to ``ops/qat_int.py``, BatchNorm's fold or ``nn/layers``'
   batch statistics (the QAT step as graphs, ROADMAP's next slice, changes
   them);
7. the HTTP server (runs before the timings of 6): phase 4's ResNet-50
   tree (fp32 stem) saved by ``utils.checkpoint`` (``--save-frozen``'s
   code) and served by ``python -m qtpu_torch.serve --load-frozen``
   (server A), while a second server process imports a torchvision-named
   ResNet-50 of seeded weights (``--torch-ckpt``, ``resnet50_imagenet_
   int8_ptq``: torchvision geometry, the 7×7/2 stem padded (3, 3)),
   calibrates it on the card and serves it with ``--uint8-ingest``
   (server B, ``--save-frozen``).  Meanwhile, in this process: the native
   ``preprocess_quantize`` equal to its plain version on 8 images; the
   bf16 stem (``stem_dtype=torch.bfloat16``) on phase 4's tree, 37 K1 +
   16 K2 + K10 + K11 a forward, none plain, walked card against CPU; the same tree
   through ``build_engine(load_frozen=...)`` behind the HTTP front in
   process, 4 client threads × 6 requests of 1-8 images, 37 K1 + 16 K2
   a round.  Server B's uint8 answers equal ``forward_codes`` on the
   host codes of the tree it saved, and the f32 path of that tree to
   atol 1e-4 with equal argmax; SIGTERM stops it.  Its int8-ingest
   forward launches 37 K1 + 17 K2 (16 wgmma, the stem kernel once; no pad
   copy) and is walked card against CPU.  Then server A answers the same
   requests: every response equal to the direct forward to 1e-6 of its
   largest logit (bit-equal ones counted); then, with server B stopped
   and this process idle on the card, a timed window of 480 requests
   cycling through them (each response checked too), whose client-side
   p50/p90/p99 per request and images/s are printed; ``/healthz`` 200,
   ``/stats`` counting the images, ``/metrics`` with
   ``qtpu_serving_healthy 1``, a malformed body 400 and healthy after,
   SIGTERM exit 0 with its STOPPED line.  The ResNet-50 forwards (f32
   stem, bf16 stem, the torchvision tree on f32 and on int8 codes)
   graph-timed at B = 128, and the f32-stem and int8-ingest forwards
   profiled by kernel, the elementwise kernels by the PyTorch operation
   that launched them.  The servers' buckets are graphed (their READY
   lines name them and the graph memory, logged), and the served round
   is timed eager and graphed at B = 8, 32 and 128 on the scheduler's
   clock (``bench/serve_rounds.round_ms``).  Both servers are killed if
   the phase fails;
6. timings with CUDA events after warm-up: engine images/s as served
   (the eager body, ``eager_forward``, launched from Python) with the device
   time of the same forward captured
   as one CUDA graph beside it — LeNet-5, ResNet-18 KL and ResNet-20 KL at
   B = 8 and 128, the ResNet-50 module path at B = 128 beside the flat
   engine's ResNet-50 (only its stem in fp32), ResNet-50 (product at B = 8
   and 128,
   tail, block, stage at 128), config 5's product and packed engines at
   B = 8 and 128, MobileNet-v2 (product, ivr) at B = 32 and 128; each kernel's
   device time (repeated launches captured in a CUDA graph) beside its
   bound, its plain version (K1 and K2 also beside the old mma.sync loop;
   K2's with and without the zero-point pad copy it needed; K5 and K6
   beside their older mma.sync kernel, with the plan ``tail_plan`` gives;
   K4, K7, K8 and K9 beside their older kernel at B = 8 and B = 128, with
   the plan ``chain_plan`` gives)
   and a
   library yardstick that computes the
   int32 accumulator only, without the epilogue: ``torch._int_mm`` for K1
   (cuBLAS fp32 ``torch.mm``, TF32 off, on the codes as floats where
   ``_int_mm`` refuses the shape: M ≤ 16, K or N off a multiple of 8;
   for the int4 entry on the unpacked weight, beside the int8 entry's
   time), cuDNN's fp32 ``F.conv2d`` (TF32 off; ``groups=C`` for K3) on the
   zero-point-padded codes for K2, K3 and the im2col conv (which also has
   K2's time beside it) (no single PyTorch call computes
   a fused bottleneck piece or a chained run, so K4-K9 have none); for
   K4-K9 also the device
   time of the unfused K1/K2/K3 sequence each replaces, at B = 8 and
   B = 128 (K5 and K6 as rows of their own at B = 128; K4 and K7-K9 at
   B = 128 first held against their plain version and the unfused sequence,
   as the B = 128 plans — K7's two tiles a unit, the fused modes of the runs
   that split at B = 8 — run only there); a profiler
   breakdown of one B = 128 forward of each engine (for the ResNet-50
   module path also the elementwise kernels' time by the PyTorch operation
   that launched them, with its input shapes); the device time of
   ``qops.spatial_mean`` beside ``torch.mean`` at the ResNet-18 (4×4×512)
   and ResNet-20 (8×8×64) heads at B = 128; for K1's rows whose yardstick
   is cuBLAS ``torch.mm``, the kernels that one such call launches.

Phase 6 also times one train step (forward + backward + AdamW) of each
QAT config at B = 16 — the fp32 step, the QAT step on the simulation and
on the integer forward — and profiles an integer-forward step by kernel
family (K1/K2/K3, cuDNN's fp32 convs, PyTorch's elementwise kernels by
the operation that launched them).

8. the parallel runtime (``qtpu_torch/parallel``) as two ranks on the one
   card: two processes this script starts (``python chip_smoke.py
   --phase8-rank DIR``, ``parallel.launch.run_world``: ``QTPU_*``
   variables, a file rendezvous, backend gloo — NCCL refuses two ranks on
   one card — a deadline of its own past which both are killed), both on
   ``cuda:0``, loading phase 4's frozen ResNet-50 and MobileNet-v2 trees
   through ``utils/checkpoint``: (a) TP = 2 — ResNet-50 at B = 8 and 32
   and MobileNet-v2 at B = 8 over ``shard_variables``' slices, the codes
   after the stem and every step and the logits bit-equal to TP = 1 on the
   same rank, each rank's launches a forward by route (37 K1 + 16 K2 on
   half the channels; 35 K1 + 17 K3), none plain, the all-gathers a
   forward and how many were staged on the host (gloo's collectives take
   host tensors: ``parallel.collectives`` copies CUDA tensors there and
   back explicitly), and the eager wall ms of the B = 32 ResNet-50 forward
   at TP = 2 and TP = 1 with the all-gathers' share; (b) DP = 2 lockstep
   serving through ``ServingEngine(mesh=...)`` with ``round_timeout_s``,
   each rank submitting its own requests, the second wave from rank 0
   alone (rank 1 idle in that round), every rank's rows bit-equal to the
   single-process forward; (c) ``spatial_conv2d`` at sp = 2 — ResNet-50's
   7×7/2 stem geometry (zero point −3), the 3×3/2 max-pool of its codes and
   a layer1 3×3 (zero point 11) on K2's raw entry — equal to the unsharded
   K2 result and ``maxpool_codes``; (d) ``pipeline_apply``, layer3's
   identity blocks 1 and 2 as two stages over 4 microbatches, equal to the
   blocks in sequence; (e) one DP = 2 integer-forward QAT step of config 5
   at full width (B = 16, 8 a rank) against the single-process step from
   the same weights: losses rtol 1e-4, parameters rtol 2e-4 / atol 2e-5,
   observers within the same bounds — or, where codes at ties move the
   free-running step beyond that, held as phase 5 holds a QAT step (loss
   rtol 5e-2) and teacher-forced: the single step's batch statistics
   replayed in the DP step, which must then meet those bounds (parameters
   but for 0.1% of them, each within AdamW's 2·lr).  Any failure in a rank
   fails the phase.  Rank 0 also records the collectives of one B = 32
   TP = 2 ResNet-50 forward (``collectives.recording``) for phase 9.
9. the tooling (``qtpu_torch/bench``): (a) ``capture_trace`` of 10
   forwards of phase 4's ResNet-50 and MobileNet-v2 product engines at
   B = 128, ``parse_trace`` and ``layer_table`` printed per layer: the
   scopes must be qtpu's (stem, layer1_0 … layer4_2, head; stem, block0 …
   block16, head), every K1/K2 (K1/K3) kernel inside one (37 + 16, 35 + 17
   a forward), at most 1% of the device time outside every scope, and the
   scopes' sum within 5% of phase 6's profiled busy time; (b)
   ``time_scan_fit`` of the B = 128 ResNet-50 forward within 3% of phase
   6's graph time; (c) ``dp_scaling`` of the ResNet-50 forward at B = 32
   a rank through a world of ranks (dp = 1; dp = 2 only with two cards);
   (d) ``scaling_projection.project`` of phase 8's recorded collectives
   with the TP = 1 graph time at B = 32; (e) the rows of (a)-(c) appended
   with ``receipts.log_receipt`` under the work directory and read back;
   and the eager B = 8 forward with and without a trace running.
10. the flat engines' own entry points compiled per input shape, as qtpu
   jits them (``serve/flat_engine.py``: one CUDA graph per entry and
   shape), on phase 4's engines at full width — ResNet-50 (product, tail,
   block, stage), the int8-stem ResNet-50, config 5 (product, packed,
   packed stage), MobileNet-v2 (product, ivr), MobileNet-v1 with its int8
   stem, ResNet-18/20 KL — ``forward`` at B = 8 and 128 (MobileNet-v2 32
   and 128), ``forward_codes`` on the int8 stems, ``forward_u8`` on the
   fp32 stems: each graphed call bit-equal to the eager body, two outputs
   kept across calls on other inputs (and a third call) still right, a
   replay's launches counted by kernel name in a trace equal route by route
   to an eager call's (one ``cudaGraphLaunch``, no capture), ms a call
   graphed and eager (``timed_eager``, device-resident input) and each
   graph's bytes (an engine's graphs share one pool: what each capture
   added); every engine's graphs freed before the next; then the
   histogram observer's update (256 partial histograms) against the same
   update counted by ``torch.bincount`` at ResNet-18 KL's and ResNet-50's
   layer1 (equal counts; each one's kernels' device time in a trace, the
   port's as a graph, bincount's from Python), and each update's first
   three calls in a fresh process (``--cold-hist``, both orders);
   ``calibrate`` eager, graphed, graphed, eager on the same model and
   batches (``serve.cli.calibration_inputs``) of ResNet-50 (min-max),
   config 5 (EMA) and ResNet-18/20 KL: ``quant_stats`` and
   ``quant_params`` bit-equal, each pass's seconds in each run.  Every earlier phase calls the
   engines' eager bodies (``eager_forward`` …) where it times, traces or
   counts one forward, so no engine holds a graph when phase 10 starts
   (checked): phase 6's and 9's numbers are the eager body's, as before.

The graph timers (``timed``, ``timed_eager``, ``events_ms``), the peak
rates and ``bound`` are ``qtpu_torch.bench.timing``'s; every profile goes
through ``qtpu_torch.bench.profile.trace``.  Each phase's seconds are
printed as it ends.  The line before the last is ``{"kernels": [...]}``;
the last line is ``{"ok": true, "device": {...}}``.
"""
import collections
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from qtpu_torch.bench.profile import trace  # noqa: E402
from qtpu_torch.bench.timing import (PEAK_CUDA_CORE_OPS,  # noqa: E402
                                     bound, device_label, events_ms, timed,
                                     timed_eager)

# torch.profiler's Chrome traces (git-ignored, under the build directory;
# emptied when a run starts, so it holds one run's)
TRACE_DIR = os.path.join(ROOT, "qtpu_torch", "build", "smoke", "traces")
SRC_K1 = "qtpu_torch/csrc/qmatmul.cu"
SRC_K2 = "qtpu_torch/csrc/qconv.cu"
SRC_K3 = "qtpu_torch/csrc/qdepthwise.cu"
SRC_K4 = "qtpu_torch/csrc/qproj.cu"
SRC_K5 = "qtpu_torch/csrc/qtail.cu"
SRC_K6 = "qtpu_torch/csrc/qblock.cu"
SRC_K7 = "qtpu_torch/csrc/qstage_wg.cu"
SRC_K8 = "qtpu_torch/csrc/qstage_proj_wg.cu"
SRC_K9 = "qtpu_torch/csrc/qivr_wg.cu"
SRC_IM2COL = "qtpu_torch/ops/qim2col.py"
SRC_STEM = "qtpu_torch/csrc/qstem.cu"
TPU_K1 = "qtpu/ops/pallas/qmatmul.py:108"
TPU_K2 = "qtpu/ops/pallas/qconv.py:70"
TPU_K2S = "qtpu/ops/pallas/qconv_dispatch.py:42"
TPU_K3 = "qtpu/ops/pallas/qdepthwise.py:53"
TPU_K4 = "qtpu/ops/pallas/qproj.py:69"
TPU_K4_2D = "qtpu/ops/pallas/qproj.py:152"
TPU_K5 = "qtpu/ops/pallas/qtail.py:94"
TPU_K6 = "qtpu/ops/pallas/qblock.py:93"
TPU_K7 = "qtpu/ops/pallas/qstage.py:159"
TPU_K8 = "qtpu/ops/pallas/qstage.py:268"
TPU_K9 = "qtpu/ops/pallas/qivr.py:112"
TPU_IM2COL = "qtpu/ops/pallas/qim2col.py:31"
NO_TPU_STEM = ("none: qtpu left the excluded stem's conv, its glue and the "
               "max-pool on codes to XLA")
NO_LIBRARY = ("no single PyTorch call computes a fused bottleneck piece "
              "or a chained run (two or more convolutions with requants "
              "between)")
# launch counts are tuples (K1 .. K9, K1's int4 entry, the im2col conv,
# plain-version calls, then launches by kernel: K1's int8 entry on wgmma,
# on igemm, its int4 entry on wgmma, on igemm, K2 on wgmma, stem, igemm, K3
# on halo, scalar, K5, K6, K7, K9, K4 and K8 each on wgmma, igemm, the
# zero-point pad copies made on the way to K2 or K3, then K1's int8 entry
# on its narrow-row kernel and K2 on its small-channel kernel, then the
# fp32 stem kernel K10 and the max-pool on codes K11, each with its one
# route); expected counts give the first twelve and K10, K11
# (``expected_part``)
KIDX = {**{f"K{i + 1}": i for i in range(9)}, "K1w4": 9, "im2col": 10,
        "K10": 36, "K11": 38}
PLAIN = 11
SPLIT = {"K1": {"wgmma": 12, "wgmma_cp": 34, "igemm": 13},
         "K1w4": {"wgmma": 14, "igemm": 15},
         "K2": {"wgmma": 16, "stem": 17, "small": 35, "igemm": 18},
         "K3": {"halo": 19, "scalar": 20},
         "K5": {"wgmma": 21, "igemm": 22}, "K6": {"wgmma": 23, "igemm": 24},
         "K7": {"wgmma": 25, "igemm": 26}, "K9": {"wgmma": 27, "igemm": 28},
         "K4": {"wgmma": 29, "igemm": 30}, "K8": {"wgmma": 31, "igemm": 32},
         "K10": {"stem": 37}, "K11": {"pool": 39}}
PADS = 33
NCOUNTS = 40
# experimental engine configurations: flags, launches per forward
STAGE_FLAGS = dict(use_qstage=True, qstage_proj=True, use_qproj=True)
RN50_FUSED = {"tail": (dict(use_qtail=True, use_qproj=True),
                       (17, 4, 0, 4, 12, 0, 0, 0, 0, 0, 0, 0, 1, 1)),
              "block": (dict(use_qblock=True, use_qproj=True),
                        (5, 4, 0, 4, 0, 12, 0, 0, 0, 0, 0, 0, 1, 1)),
              "stage": (STAGE_FLAGS, (4, 3, 0, 3, 0, 0, 3, 1, 0, 0, 0, 0,
                                      1, 1))}
MNV2_IVR = (15, 0, 7, 0, 0, 0, 0, 0, 5, 0, 0, 0, 1, 0)
# config 5 (stem and fc in fp32): the product engine runs its 36 1×1 GEMMs
# on K1's int8 entry (unpacked weights), the packed engine on the int4
# entry; the stage engine chains layer1 (K8) and the layer2/layer3 runs
# (K7), K4 takes layer2_0-layer4_0's conv3 + downsample, and layer4 stays
# unchained (its consumer is the fp32 fc): the int4 entry runs the conv1 of
# layer2_0-layer4_0 and layer4_1-4_2's conv1 and conv3 (7), K2 the five
# unchained 3×3s
CFG5_PRODUCT = (36, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1)
CFG5_PACKED = (0, 16, 0, 0, 0, 0, 0, 0, 0, 36, 0, 0, 1, 1)
CFG5_STAGE = (0, 5, 0, 3, 0, 0, 2, 1, 0, 7, 0, 0, 1, 1)
RN50 = "resnet50_imagenet_int8_ptq_fp32stem"
# ResNet-50 with its int8 7×7/2 stem: the product engine's 37 K1 and 16 K2,
# plus one K2 (the stem kernel) for the stem
RN50_INT8STEM = "resnet50_imagenet_int8_ptq"
RN50_INT8STEM_FWD = (37, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1)
CFG5 = "resnet50_int4w_int8a_qat"
MNV2 = "mobilenetv2_imagenet_int8_ptq_fp32stem"
MNV1 = ("mobilenetv1_imagenet_int8_ptq_fp32stem",
        "mobilenetv1_imagenet_int8_ptq")
# the module SERVE path and the KL configs, with their launches per forward:
# LeNet-5 on the module path (fc1-fc3 on K1, conv1 and conv2 on K2);
# ResNet-18 KL on the flat engine (three downsamples and the fc on K1, the
# stem and sixteen 3×3s on K2) and its tree on the module path (the fc on
# K1; the stem, the 3×3s and the three 1×1/2 downsamples, as 1×1 windows,
# on K2); ResNet-20 KL (two downsamples and the fc; the stem and eighteen
# 3×3s); ResNet-50 on the module path with its stem and downsamples in fp32
# (thirty-two 1×1s and the fc on K1, sixteen 3×3s on K2); MobileNet-v2 on
# the module path with its stem and block1 in fp32 (33 K1, 16 K3);
# ResNet-101 on the flat engine (66 1×1s, 4 downsamples and the fc on K1,
# 33 3×3s on K2)
LENET = "lenet_mnist_int8"
RN18 = "resnet18_cifar10_int8_kl"
RN20 = "resnet20_cifar10_int8_kl"
RN101 = "resnet101_imagenet_int8_ptq_fp32stem"
RN50_MODULE_EXCLUDE = ("stem*", "*/down")
MNV2_MODULE_EXCLUDE = ("stem*", "block1/*")
RN50_MODULE = f"{RN50} exclude={RN50_MODULE_EXCLUDE}"
MNV2_MODULE = f"{MNV2} exclude={MNV2_MODULE_EXCLUDE}"
LENET_FWD = (3, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
RN18_FWD = (4, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
RN18_MODULE_FWD = (1, 20, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
RN20_FWD = (3, 19, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
RN50_MODULE_FWD = (33, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
MNV2_MODULE_FWD = (33, 0, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
RN101_FWD = (71, 33, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1)
RN101_CALIB_BATCHES = 2     # of the config's 8, to keep the script short
# every serving run launches K1 and K2 on their wgmma kernels, the stem
# kernel, the narrow-row or the small-channel kernel, and copies no zero
# point pad (LeNet-5's conv1, the module path's raw CIFAR stem, ResNet-20's
# 16- and 32-channel 3×3s and config 3's raw QAT stem read their pads in
# the small kernel); the old mma.sync loops take only the fcs whose rows
# TMA cannot address, below the narrow-row kernel's 512 rows (a batch):
# their K1 launches a forward on igemm
FC_IGEMM = {"lenet": 2, "rn18": 1, "rn18_module": 1, "rn20": 1}
# the QAT trainer's runs, cut from the configs' budgets (full width: 224²,
# 1000 classes, B = 16), with the integer forward
QAT_RUNS = {"qat_cfg5": "resnet50_int4w_int8a_qat",
            "qat_cfg3": "mobilenetv2_imagenet_int8_qat"}
QAT_CUT = dict(n_train=64, n_eval=32, fp32_epochs=1, qat_epochs=1,
               qat_forward="int")
# launches one QAT forward makes by the module path's routing: config 5
# (stem and fc fp32): 33 K1 (16 conv1, 16 conv3, layer1_0's 1×1/1
# downsample), 19 K2 (16 3×3s, three 1×1/2 downsamples); config 3: 34 K1
# (16 expands, 17 projects, the head), 1 K2 (the Ci = 3 stem), 17 K3; the
# quantized fc is dense and runs the simulation (qtpu's integer forward
# covers convs only); no K10 or K11 (the flat engines' stems), so the
# twelve that ``qat_launches`` gives
QAT_FWD = {"qat_cfg5": (33, 19, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
           "qat_cfg3": (34, 1, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0)}
# the integer-forward QAT step at B = 16 as its CUDA graph, predicted (PERF.md
# §6) from the eager step's device-busy time in phase 6's earlier profiles
QAT_STEP_PREDICTED = {"qat_cfg5": "55-90", "qat_cfg3": "30-55"}
# the QAT-frozen models served on their flat engines: config 5 as
# CFG5_PRODUCT; config 3 with its quantized stem (K2's stem kernel) and fc
QAT_SERVED = {"qat_cfg5": CFG5_PRODUCT,
              "qat_cfg3": (35, 1, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)}
# the integer-forward QAT conv's shapes at the trainer's B = 16: (what, Ci,
# Co, kernel, stride, groups, H, weight bits) — config 5's layer1_1 conv1,
# layer1 conv2, layer2_0 conv2 (3×3/2) and downsample (1×1/2), config 3's
# block2 expand, depthwise and project and its Ci = 3 stem
QAT_INT_CASES = (
    ("config 5 layer1_1 conv1 1x1", 256, 64, 1, 1, 1, 56, 4),
    ("config 5 layer1 conv2 3x3", 64, 64, 3, 1, 1, 56, 4),
    ("config 5 layer2_0 conv2 3x3/2", 128, 128, 3, 2, 1, 56, 4),
    ("config 5 layer2_0 down 1x1/2", 256, 512, 1, 2, 1, 56, 4),
    ("config 3 block2 expand 1x1", 24, 144, 1, 1, 1, 56, 8),
    ("config 3 block2 dw 3x3", 144, 144, 3, 1, 144, 56, 8),
    ("config 3 block2 project 1x1", 144, 24, 1, 1, 1, 56, 8),
    ("config 3 stem 3x3/2", 3, 32, 3, 2, 1, 224, 8),
)


# phase 7: the HTTP server (``python -m qtpu_torch.serve``) — 4 client
# threads x 6 requests of 1-8 images checked, then 480 of them timed (every
# response checked too); the torchvision-named ResNet-50 that
# the second server imports (--torch-ckpt), served with --uint8-ingest; the
# launches one forward makes on its int8-ingest path (37 K1, 16 K2 on
# wgmma and the stem kernel for the quantized 7×7/2 stem, K11 its max-pool)
# and with the bf16 stem (37 K1, 16 K2; K10 on bf16-rounded operands, K11)
HTTP_THREADS, HTTP_REQUESTS, HTTP_MAX_IMAGES = 4, 6, 8
HTTP_TIMED_REQUESTS = 480   # server A's timed window: several seconds
HTTP_BUCKETS = "8,32"
HTTP_BUCKET_LIST = [8, 32]
# the served round, eager and graphed (phase 7, bench.serve_rounds)
ROUND_BUCKETS = (8, 32, 128)
ROUND_REPEATS = 20
RN50_FWD = (37, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1)
RN50_TV_FWD = (37, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1)
# the K2 rows whose launches phase 7 counts, and their pads where not SAME
PHASE7_PATHS = ("rn50_tv",)
K2_PADS = {"RN50 torchvision int8 stem 7x7/2": ((3, 3), (3, 3))}
SERVER_START_S = 300        # a server's start: imports, build, warm-up
HTTP_TIMEOUT_S = 120


class SmokeFailure(Exception):
    pass


def expected_part(c):
    """The part of a counts tuple a forward's expectation gives: K1 .. K9,
    K1's int4 entry, the im2col conv, plain-version calls, then K10 (the
    fp32 stem kernel) and K11 (the max-pool on codes)."""
    return tuple(c[:PLAIN + 1]) + (c[KIDX["K10"]], c[KIDX["K11"]])


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def eager_entry(flat, entry="forward"):
    """A flat engine's eager body of ``entry`` (``eager_forward``, ...: its
    launches from Python, no graph); a module-path model's ``forward``,
    which is eager."""
    return getattr(flat, f"eager_{entry}", None) or getattr(flat, entry)


def log(*a):
    print(*a, flush=True)


def tv_resnet50_state(seed):
    """A ResNet-50 ``state_dict`` in torchvision's names and shapes
    (conv1/bn1, layerN.M.convK/bnK, layerN.0.downsample.0/1, fc) from
    seeded random weights: He-normal convs, BatchNorm affine and running
    statistics drawn near their neutral values."""
    import torch
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(key, co, ci, k):
        sd[f"{key}.weight"] = (torch.randn(co, ci, k, k, generator=g)
                               * (2.0 / (ci * k * k)) ** 0.5)

    def bn(key, c):
        sd[f"{key}.weight"] = 0.5 + 0.5 * torch.rand(c, generator=g)
        sd[f"{key}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_mean"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{key}.running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, (n, w) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512))):
        for b in range(n):
            t = f"layer{s + 1}.{b}"
            for k, (co, ci, kk) in enumerate(((w, cin, 1), (w, w, 3),
                                              (4 * w, w, 1))):
                conv(f"{t}.conv{k + 1}", co, ci, kk)
                bn(f"{t}.bn{k + 1}", co)
            if b == 0:
                conv(f"{t}.downsample.0", 4 * w, cin, 1)
                bn(f"{t}.downsample.1", 4 * w)
            cin = 4 * w
    sd["fc.weight"] = torch.randn(1000, cin, generator=g) * cin ** -0.5
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def start_server(args, what):
    """``python -m qtpu_torch.serve *args`` from the checkout's root; its
    merged output lines go to a queue, read by :func:`wait_line`."""
    import queue
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", "qtpu_torch.serve", "--host", "127.0.0.1",
         "--port", "0", *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT)
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)
    threading.Thread(target=pump, daemon=True, name=what).start()
    return proc, lines, []


def wait_line(server, prefix, timeout):
    """The JSON after ``prefix`` on the server's first line that starts
    with it; fails on a timeout or when the server's output ends first."""
    import queue
    proc, lines, seen = server
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        try:
            line = lines.get(timeout=max(left, 0.01)) if left > 0 else None
        except queue.Empty:
            line = None
        if line is None:
            raise SmokeFailure(f"server {proc.args[3:]}: no {prefix.strip()}"
                               f" line within {timeout} s (exit "
                               f"{proc.poll()}); its output:\n"
                               + "".join(seen[-40:]))
        seen.append(line)
        if line.startswith(prefix):
            return json.loads(line[len(prefix):])


def stop_server(server, timeout=60):
    """SIGTERM; the exit code and the STOPPED line's stats."""
    import signal
    proc = server[0]
    proc.send_signal(signal.SIGTERM)
    stats = wait_line(server, "QTPU_SERVE_STOPPED ", timeout)
    return proc.wait(timeout=timeout), stats


def http(url, body=None):
    """One request; (status, body bytes) — HTTP errors are answers too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, body,
                                    timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def post_npy(url, arr):
    import io

    import numpy as np
    buf = io.BytesIO()
    np.save(buf, arr)
    code, body = http(url + "/predict", buf.getvalue())
    check(code == 200, f"POST {url}/predict: {code} {body[:300]!r}")
    return np.load(io.BytesIO(body))


def drive_http(url, requests, threads):
    """``requests`` (arrays) posted by ``threads`` client threads, each
    taking the next one; returns (logits per request, client-side seconds
    per request, wall seconds)."""
    import threading
    out = [None] * len(requests)
    lat = [None] * len(requests)
    errors = []
    nxt = iter(range(len(requests)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            try:
                out[i] = post_npy(url, requests[i])
            except Exception as e:   # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")
                return
            lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    pool = [threading.Thread(target=client) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=HTTP_TIMEOUT_S * len(requests))
    wall = time.perf_counter() - t0
    check(not errors and all(o is not None for o in out),
          f"HTTP clients failed: {errors[:3]}")
    return out, lat, wall


def qat_launches(model):
    """The launches one integer-forward QAT forward of a converted model
    makes, by the module path's routing of each quantized conv
    (``ops.qat_int.conv_kind``): (K1, K2, K3, then zeros as the launch
    tuples have them)."""
    import torch
    from qtpu_torch.nn.layers import layer_paths
    from qtpu_torch.ops.qat_int import conv_kind

    n = {"gemm": 0, "conv": 0, "depthwise": 0}
    for m in layer_paths(model).values():
        if m.spec is None or isinstance(m, torch.nn.Linear):
            continue
        n[conv_kind(m.kernel, m.stride, m.padding, m.groups,
                    m.conv.in_channels, m.conv.out_channels)] += 1
    return (n["gemm"], n["conv"], n["depthwise"]) + (0,) * 9


def qat_layer_parts(layer, x, g, run_layer):
    """One QAT layer's forward and backward (``run_layer(layer, x, g)``)
    with the integer forward's parts recorded from ``ops.qat_int``: the
    activation grid and codes, the folded weight, its scale and codes, the
    int32 accumulator, the output; all on the host."""
    from qtpu_torch.ops import qat_int

    rec = {}
    wc, ac, ia = qat_int.weight_codes, qat_int.act_codes, qat_int.int_acc

    def weight_codes(w, bits, per_channel):
        codes, scale = wc(w, bits, per_channel)
        rec.update(w_fold=w.detach().cpu(), w_scale=scale.cpu(),
                   w_codes=codes.cpu())
        return codes, scale

    def act_codes(x, scale, zp_u, bits, symmetric):
        codes = ac(x, scale, zp_u, bits, symmetric)
        rec.update(act_scale=scale.cpu(), act_zp=zp_u.cpu(),
                   x_codes=codes.cpu())
        return codes

    def int_acc(x_q, w_q, **kw):
        acc = ia(x_q, w_q, **kw)
        rec["acc"] = acc.cpu()
        return acc

    qat_int.weight_codes, qat_int.act_codes, qat_int.int_acc = (
        weight_codes, act_codes, int_acc)
    try:
        rec["y"] = run_layer(layer, x, g).detach().cpu()
    finally:
        qat_int.weight_codes, qat_int.act_codes, qat_int.int_acc = wc, ac, ia
    return rec


def qat_step_vs_cpu(what, model, policy, torch, seed=7):
    """One QAT step (the integer forward) of ``model`` converted by
    ``policy``, on the card and on the CPU from the same weights and one
    B = 2 batch at full width.  The whole step: loss, gradients and
    statistics reported, the losses finite and within rtol 5e-2 (fp32 sums
    in another order put codes across ties, which later layers' batch
    statistics and EMA ranges amplify: the gradients come out unrelated).
    Layer by layer, teacher-forced: each layer's CPU copy (its state
    before the step) takes the input and the output gradient the card's
    layer saw, and the batch statistics the card's layer computed (their
    values; the gradient through them is the CPU's own) — outputs to
    rel-L2 ≤ 1e-5, every parameter's gradient to rel-L2 ≤ 1e-3 (cuDNN's
    and the CPU's fp32 weight gradients sum over B·H·W positions in
    other orders: MobileNet-v2's stem, 2·112², reaches 1.2e-4), BatchNorm
    running statistics to rtol 1e-6, the EMA observers equal.  The fold
    factor γ / sqrt(var + eps) of the same statistics came out one ulp
    apart on the two devices while the CPU's fp32 sqrt was not correctly
    rounded, and a folded weight then crossed a tie (C22; the fold now
    takes ``utils.numerics.sqrt_rn``): weight codes are held by the tie
    rule and the CPU's copy is run again on the card's codes.  A layer
    whose output is off by more than 1e-5 is run once more on each device
    with the integer forward's parts recorded, and the codes that differ
    are logged.  Returns the weight codes across a tie, by layer."""
    import copy

    import numpy as np

    from qtpu_torch.nn import layers as qlayers
    from qtpu_torch.nn.layers import layer_paths
    from qtpu_torch.ops import qat_int
    from qtpu_torch.train import create_train_state, train_step
    from qtpu_torch.transform import convert_model
    from qtpu_torch.utils.device import fp32_exact

    batch_stats, current, card_stats = qlayers._batch_stats, [None], {}

    def record(y):
        m, v = batch_stats(y)
        card_stats[current[0]] = (m.detach().cpu(), v.detach().cpu())
        return m, v

    def replay(y):
        m, v = batch_stats(y)
        cm, cv = (t.to(m.device) for t in card_stats[current[0]])
        return m + (cm - m).detach(), v + (cv - v).detach()

    gpu = convert_model(model, policy)
    cpu = copy.deepcopy(gpu).to("cpu")
    pre = copy.deepcopy(cpu)
    rs = np.random.default_rng(seed)
    xb = rs.standard_normal((2, 224, 224, 3)).astype(np.float32)
    yb = rs.integers(0, 1000, 2)
    seen = {}

    def hook(path):
        def fwd(_mod, args, out):
            rec = seen[path] = {"x": args[0].detach().clone(),
                                "y": out.detach().clone()}
            out.register_hook(lambda g: rec.__setitem__(
                "g", g.detach().clone()))
        return fwd

    def enter(path):
        def pre(_mod, _args):
            current[0] = path
        return pre
    glayers = layer_paths(gpu)
    handles = [m.register_forward_hook(hook(p))
               for p, m in glayers.items()]
    handles += [m.register_forward_pre_hook(enter(p))
                for p, m in glayers.items()]
    qlayers._batch_stats = record
    try:
        mg = train_step(create_train_state(gpu, 1e-4), xb, yb)
        torch.cuda.synchronize()
    finally:
        qlayers._batch_stats = batch_stats
        for h in handles:
            h.remove()
    mc = train_step(create_train_state(cpu, 1e-4), xb, yb)
    lg, lc = float(mg["loss"]), float(mc["loss"])
    loss_rel = abs(lg - lc) / abs(lc)
    clayers = layer_paths(cpu)
    grad_rel, stat_rel = [], []
    for path, m in glayers.items():
        cm = dict(clayers[path].named_parameters())
        for name, p in m.named_parameters():
            grad_rel.append(((p.grad.cpu() - cm[name].grad).norm()
                             / cm[name].grad.norm().clamp_min(1e-30)
                             ).item())
        for name, b in m.named_buffers():
            cb = dict(clayers[path].named_buffers())[name]
            if b.is_floating_point() and b.numel() > 0:
                stat_rel.append(((b.cpu() - cb).abs().max() / cb.abs(
                ).max().clamp_min(1e-30)).item())
    log(f"{what}: one QAT step (integer forward) at B = 2, card vs CPU "
        f"from the same weights: loss {lg:.6f} vs {lc:.6f} (rel "
        f"{loss_rel:.2e}); gradients' rel-L2 per tensor median "
        f"{float(np.median(grad_rel)):.2e}, worst {max(grad_rel):.2e}; "
        f"BatchNorm and EMA state worst rel {max(stat_rel):.2e}")
    check(np.isfinite(lg) and np.isfinite(lc) and loss_rel <= 5e-2,
          f"{what}: QAT step loss card {lg} vs CPU {lc}")
    worst = {"y": 0.0, "grad": 0.0, "stats": 0.0}
    where = {}
    def teacher_forced(path, layer, x, g):
        """``layer`` (a copy of the layer's state before the step) on the
        card's input, output gradient and batch statistics."""
        if x.is_floating_point():
            x.requires_grad_()
        current[0] = path
        qlayers._batch_stats = replay
        try:
            with fp32_exact():
                out = layer(x)
                out.backward(g)
        finally:
            qlayers._batch_stats = batch_stats
        return out

    def card_codes(codes, scale):
        """``ops.qat_int.weight_codes`` giving the card's weight codes and
        scales (C22 below)."""
        def weight_codes(w, bits, per_channel):
            return codes.to(w.device), scale.to(w.device)
        return weight_codes

    def sigmas(path, o, dev):
        """BatchNorm's sqrt(var + eps) of channel ``o`` from the card's
        batch statistics for ``path``, computed on the card and on the CPU
        (a layer without BatchNorm: none)."""
        if path not in card_stats:
            return ""
        var = card_stats[path][1][o:o + 1] + qlayers.BN_EPS
        return (f"; σ on the card {float(torch.sqrt(var.to(dev))):.9g}, on "
                f"the CPU {float(torch.sqrt(var)):.9g}")

    ties = {}
    for path, m_pre in layer_paths(pre).items():
        rec = seen[path]
        layer = copy.deepcopy(m_pre).train()
        out = teacher_forced(path, layer, rec["x"].cpu(), rec["g"].cpu())
        y_rel = ((out.detach() - rec["y"].cpu()).norm()
                 / rec["y"].norm().cpu().clamp_min(1e-30)).item()
        if y_rel > 1e-5:
            # the integer forward's codes, the same copy on the card and on
            # the CPU
            card = qat_layer_parts(copy.deepcopy(m_pre).to(
                rec["x"].device).train(), rec["x"].clone(), rec["g"],
                functools.partial(teacher_forced, path))
            host = qat_layer_parts(copy.deepcopy(m_pre).train(),
                                   rec["x"].cpu(), rec["g"].cpu(),
                                   functools.partial(teacher_forced, path))
            differ = {k: int((card[k] != host[k]).sum())
                      for k in ("x_codes", "w_codes", "acc", "y")}
            # C22: BatchNorm's fold factor γ / sqrt(var + eps) came out
            # one ulp apart on the card and on the CPU from the same
            # statistics while the fold took PyTorch's fp32 sqrt, which on
            # the CPU (its AVX-512 path) misses the correctly rounded root
            # by one ulp on about 0.6% of inputs (``sqrt_rounding``; the
            # fold now takes ``sqrt_rn``) — and a folded weight then crossed
            # a rounding tie on one side only: a weight code one step
            # apart, the layer's output off by that step (5.31e-5 rel-L2 at
            # block16/expand, 4.65e-5 at the head).  Held by the tie rule —
            # weight codes equal except one step on at most 0.1% of them,
            # activation codes equal — and the CPU's copy then runs on the
            # card's weight codes and scales, so that everything else is
            # held as tightly as in every other layer.
            dw = (card["w_codes"].int() - host["w_codes"].int()).abs()
            n_tie = int((dw > 0).sum())
            check(int(dw.max()) <= 1 and n_tie <= 1e-3 * dw.numel()
                  and differ["x_codes"] == 0, f"{what} {path}: y rel-L2 "
                  f"{y_rel:.2e}, codes off the tie rule: {n_tie} of "
                  f"{dw.numel()} weight codes differ, by up to "
                  f"{int(dw.max())}; elements differing {differ}")
            ties[path] = (n_tie, dw.numel())
            co = card["w_scale"].reshape(-1, *[1] * (dw.dim() - 1))
            ho = host["w_scale"].reshape(co.shape)
            for i in torch.nonzero(dw.reshape(-1))[:5, 0].tolist():
                o = i // (dw.numel() // dw.shape[0])
                log(f"{what} {path} (y rel-L2 {y_rel:.2e}; elements "
                    f"differing {differ}): weight {i} (channel {o}) across a "
                    f"tie — card code {int(card['w_codes'].view(-1)[i])} = "
                    f"round("
                    f"{float(card['w_fold'].view(-1)[i] / co.view(-1)[o]):.7f}"
                    f"), CPU code {int(host['w_codes'].view(-1)[i])} = round("
                    f"{float(host['w_fold'].view(-1)[i] / ho.view(-1)[o]):.7f}"
                    f"){sigmas(path, o, rec['x'].device)}")
            layer = copy.deepcopy(m_pre).train()
            wc = qat_int.weight_codes
            qat_int.weight_codes = card_codes(card["w_codes"],
                                              card["w_scale"])
            try:
                out = teacher_forced(path, layer, rec["x"].cpu(),
                                     rec["g"].cpu())
            finally:
                qat_int.weight_codes = wc
            y_rel = ((out.detach() - rec["y"].cpu()).norm()
                     / rec["y"].norm().cpu().clamp_min(1e-30)).item()
        got = {"y": y_rel}
        gparams = dict(glayers[path].named_parameters())
        got["grad"] = max(((p.grad - gparams[n].grad.cpu()).norm()
                           / gparams[n].grad.norm().cpu().clamp_min(1e-30)
                           ).item() for n, p in layer.named_parameters())
        gbufs = dict(glayers[path].named_buffers())
        got["stats"] = 0.0
        for name, b in layer.named_buffers():
            g_ref = gbufs[name].cpu()
            if name.startswith("in_q."):
                check(torch.equal(b, g_ref), f"{what} {path}: observer "
                      f"{name} differs")
            elif b.is_floating_point():
                got["stats"] = max(got["stats"], ((b - g_ref).abs().max()
                                   / g_ref.abs().max().clamp_min(1e-30)
                                   ).item())
        for k, v in got.items():
            if v >= worst[k]:
                worst[k], where[k] = v, path
    log(f"{what}: weight codes across a tie (C22, held by the tie rule, "
        f"the CPU on the card's codes): {ties or 'none'}")
    log(f"{what}: teacher-forced over {len(seen)} layers (each layer's CPU "
        f"copy on the card's input, output gradient and batch statistics): "
        f"outputs worst "
        f"rel-L2 {worst['y']:.2e} ({where['y']}), parameter gradients worst "
        f"rel-L2 {worst['grad']:.2e} ({where['grad']}), running statistics "
        f"worst rel {worst['stats']:.2e} ({where['stats']}), EMA observers "
        "equal")
    check(worst["y"] <= 1e-5 and worst["grad"] <= 1e-3
          and worst["stats"] <= 1e-6, f"{what}: teacher-forced layers "
          f"outside their tolerances: {worst}")
    return ties


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    shutil.rmtree(TRACE_DIR, ignore_errors=True)   # this run's traces only
    import copy

    import numpy as np
    import torch.nn.functional as F

    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.examples.run import experiment
    from qtpu_torch.nn.layers import layer_paths
    from qtpu_torch.ops import _build, qat_int, qops
    from qtpu_torch.ops import fakequant as fq
    from qtpu_torch.ops import qblock as k6
    from qtpu_torch.ops import qconv as k2
    from qtpu_torch.ops import qdepthwise as k3
    from qtpu_torch.ops import qim2col
    from qtpu_torch.ops import qivr as k9
    from qtpu_torch.ops import qmatmul as k1
    from qtpu_torch.ops import qproj as k4
    from qtpu_torch.ops import qstage as k78
    from qtpu_torch.ops import qstem
    from qtpu_torch.ops import qtail as k5
    from qtpu_torch.ops.chain_plan import chain_plan
    from qtpu_torch.bench.serve_rounds import round_ms, submit_burst
    from qtpu_torch.serve.cli import (build_engine, calibration_inputs,
                                      freeze_from_config, serve_module)
    from qtpu_torch.serve.dispatch import resnet_arch
    from qtpu_torch.data.native import pack_batch
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.serve.experimental import (
        ExperimentalMobileNetV2Int8Engine, ExperimentalResNetInt8Engine)
    from qtpu_torch.serve.fused_ops import (grid_of, tree_to_device,
                                            u8_normalize_coeffs)
    from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
    from qtpu_torch.serve.mobilenet_v1_engine import (V1_STRIDES,
                                                      MobileNetV1Int8Engine)
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine
    from qtpu_torch.data import Dataset
    from qtpu_torch.train import create_train_state, evaluate, train_step
    from qtpu_torch.train.loop import eval_graphs
    from qtpu_torch.calib import observers as obs
    from qtpu_torch.transform import calibrate, convert_model, freeze
    from qtpu_torch.utils.device import fp32_exact
    from qtpu_torch.utils.graphs import launch_counters, read_counters

    dev = torch.device("cuda")
    t_phase = [time.monotonic()]

    def phase_done(what):
        """Each phase's seconds, for the script's time budget."""
        now = time.monotonic()
        log(f"phase {what}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # -- 1. the card ------------------------------------------------------------
    card = device_label(dev)
    log(card)

    # -- 2. build ------------------------------------------------------------------
    t0 = time.monotonic()
    info = _build.build()
    log(f"build: {time.monotonic() - t0:.1f} s (" + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in info.items()) + ")")
    for k, v in info.items():
        entry = spill = ""
        for line in v["log"].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:     # entry, spills, then registers
                log(f"  {k} {entry[:100]}: {line.strip()}; {spill}")

    phase_done("1-2 (card, build)")

    # -- 3. kernels against their plain versions, main-path shapes at B=8 ----------
    g = torch.Generator(device="cpu").manual_seed(0)

    def i8(*shape, lo=-128, hi=128):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int8).to(dev)

    def coeffs(n, ncols_k, **kw):
        w_scale = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(dev)
        colsum = torch.randint(-127 * ncols_k // 8, 127 * ncols_k // 8, (n,),
                               generator=g, dtype=torch.int32).to(dev)
        bias = torch.randn(n, generator=g).to(dev)
        return qops.epilogue_coeffs(act_scale=0.02, act_zp=-9,
                                    w_scale=w_scale, colsum=colsum,
                                    bias=bias, **kw)

    def compare(label, run_k, run_p):
        y, y_ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = (y.double() - y_ref.double()).abs().max().item()
        check(y.dtype == y_ref.dtype and y.shape == y_ref.shape and err == 0,
              f"{label}: kernel differs from plain (max abs {err})")
        log(f"{label}: exact vs plain")
        return y, err

    requant = dict(requant_scale=0.05, requant_zp=-20, relu=True)
    relu6 = dict(requant_scale=0.05, requant_zp=-20, relu=True, act_max=6.0)
    mnv2_proj = dict(requant_scale=0.05, requant_zp=-20)   # linear project
    sym = dict(requant_scale=0.05, requant_symmetric=True)
    # (path, label, M, K, N, epilogue, residual)
    k1_cases = [
        ("rn50", "layer1 conv3 +int8 residual", 25088, 64, 256,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("rn50", "layer1 conv1 requant", 25088, 256, 64, requant, None),
        ("rn50", "layer2_0 downsample f32", 6272, 256, 512, {}, None),
        ("rn50", "fc raw_acc", 8, 2048, 1000, None, None),
        ("mnv2", "block1 project", 25088, 96, 24, mnv2_proj, None),
        ("mnv2", "block2 expand relu6", 25088, 24, 144, relu6, None),
        ("mnv2", "block2 project +int8 residual", 25088, 144, 24,
         dict(res_scale=0.04, res_zp=-7, **mnv2_proj), "i8"),
        ("mnv2", "block3 expand relu6", 25088, 24, 144, relu6, None),
        ("mnv2", "head f32 relu6", 392, 320, 1280,
         dict(relu=True, act_max=6.0), None),
        # the same ResNet-50 GEMMs at B = 128, the engines' timed batch
        ("rn50", "B=128 layer1 conv3 +int8 residual", 401408, 64, 256,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("rn50", "B=128 layer1 conv1 requant", 401408, 256, 64, requant,
         None),
        ("rn50", "B=128 layer2_0 downsample f32", 100352, 256, 512, {}, None),
        ("rn50", "B=128 layer4 conv3 +int8 residual", 6272, 512, 2048,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("rn50", "B=128 fc raw_acc", 128, 2048, 1000, None, None),
        # MobileNet-v2's four 24-byte GEMMs at B = 128 (56² maps: the
        # narrow-row kernel's main-path rows)
        ("mnv2", "B=128 block1 project", 401408, 96, 24, mnv2_proj, None),
        ("mnv2", "B=128 block2 expand relu6", 401408, 24, 144, relu6, None),
        ("mnv2", "B=128 block2 project +int8 residual", 401408, 144, 24,
         dict(res_scale=0.04, res_zp=-7, **mnv2_proj), "i8"),
        ("mnv2", "B=128 block3 expand relu6", 401408, 24, 144, relu6, None),
        # MobileNet-v2's N = 16 and N = 32 projects (rows TMA can address,
        # N < 64: the narrow-row kernel, the TMA ring forced beside it)
        ("mnv2", "B=128 block0 project N=16", 1605632, 32, 16, mnv2_proj,
         None),
        ("mnv2", "B=128 block4 project N=32 +int8 residual", 100352, 192, 32,
         dict(res_scale=0.04, res_zp=-7, **mnv2_proj), "i8"),
        # the module SERVE path's raw accumulators at LeNet-5's fc shapes
        # (rows of 120 and 84 bytes, and N = 10's 40-byte output rows, on
        # the narrow-row kernel), and a requant onto a symmetric grid
        # (shift 0, the KL configs' grids) at ResNet-18's layer2_0
        # downsample shape
        ("lenet", "LeNet fc1 raw_acc", 8, 400, 120, None, None),
        ("lenet", "LeNet fc2 raw_acc", 8, 120, 84, None, None),
        ("lenet", "LeNet fc3 raw_acc", 8, 84, 10, None, None),
        ("lenet", "B=128 LeNet fc1 raw_acc", 128, 400, 120, None, None),
        ("lenet", "B=128 LeNet fc2 raw_acc", 128, 120, 84, None, None),
        ("lenet", "B=128 LeNet fc3 raw_acc", 128, 84, 10, None, None),
        ("rn18", "RN18 1x1 symmetric requant", 2048, 64, 128, sym, None),
        ("rn18", "B=128 RN18 1x1 symmetric requant", 32768, 64, 128, sym,
         None),
        # the integer-forward QAT conv's raw accumulators at B = 16 (the
        # trainer's batch): config 5's layer1_1 conv1, config 3's block2
        # expand (24-byte rows) and project (N = 24), both on the
        # narrow-row kernel
        ("qat_cfg5", "QAT B=16 layer1_1 conv1 raw", 50176, 256, 64, None,
         None),
        ("qat_cfg3", "QAT B=16 block2 expand raw", 50176, 24, 144, None,
         None),
        ("qat_cfg3", "QAT B=16 block2 project raw", 50176, 144, 24, None,
         None),
    ]
    kernels = []
    for path, label, M, K, N, kw, res in k1_cases:
        x, w = i8(M, K), i8(N, K, lo=-127)
        raw = kw is None
        co, mode = (None, None) if raw else coeffs(N, K, **kw)
        r = i8(M, N) if res == "i8" else None

        def run_k(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
            return k1.qmatmul_folded(x, w, co, mode, r, raw_acc=raw)

        def run_p(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
            return k1.qmatmul_folded_plain(x, w, co, mode, r, raw_acc=raw)

        def run_old(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
            return k1.qmatmul_folded(x, w, co, mode, r, raw_acc=raw,
                                     path="igemm")

        kpath = k1.k1_path(x, w, k1.out_dtype_of(mode, torch.float32, raw),
                           r, co, mode)
        y, err = compare(f"K1 {label} [{kpath}]", run_k, run_p)
        check(torch.equal(y, run_old()), f"K1 {label}: the {kpath} and "
              "igemm kernels differ")
        extra = {}
        tma, narrow, _ = k1._k1_fit(x, w, y.dtype, r, co, mode)
        if kpath == "wgmma_cp" and tma:
            # rows TMA can address, N < 64: the TMA ring forced beside it

            def run_ring(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
                return k1.qmatmul_folded(x, w, co, mode, r, raw_acc=raw,
                                         path="wgmma")

            check(torch.equal(y, run_ring()), f"K1 {label}: the wgmma_cp "
                  "and wgmma kernels differ")
            extra["wgmma_ms"] = timed(run_ring, 50)
        elif kpath == "igemm" and narrow:
            # a batch's fc below k1.NARROW_MIN_M rows: the narrow-row
            # kernel forced beside the old loop that k1_path keeps

            def run_cp(x=x, w=w, co=co, mode=mode, r=r, raw=raw):
                return k1.qmatmul_folded(x, w, co, mode, r, raw_acc=raw,
                                         path="wgmma_cp")

            check(torch.equal(y, run_cp()), f"K1 {label}: the igemm and "
                  "wgmma_cp kernels differ")
            extra["wgmma_cp_ms"] = timed(run_cp, 50)
        nbytes = M * K + N * K + y.element_size() * M * N + \
            (0 if raw else 8 * N) + (M * N if r is not None else 0)
        b_ms, b_by = bound(nbytes, 2 * M * N * K)
        wt = w.t()
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            # torch._int_mm needs more than 16 rows, K and N multiples of 8
            lib_call = "torch._int_mm"
            lib_ms = timed(lambda: torch._int_mm(x, wt), 50)
        else:
            # cuBLAS fp32 (TF32 off) on the codes as floats: the int32
            # accumulator exactly while |acc| < 2^24
            lib_call = "torch.mm fp32"
            xf, wf = x.float(), wt.float()
            with fp32_exact():
                # 20 calls of warm-up first (cuBLAS picks its kernel at the
                # first call of a shape), then the kernels of one call
                for _ in range(20):
                    torch.mm(xf, wf)
                lib_call += " (" + ", ".join(device_kernels(
                    torch, lambda: torch.mm(xf, wf))) + ")"
                lib_ms = timed(lambda: torch.mm(xf, wf), 50)
        kernels.append(dict(
            name=f"qmatmul_fused [{label}]", route="cuda", source=SRC_K1,
            replaces=TPU_K1, path=path, shape=f"M={M} K={K} N={N}",
            k1_path=kpath, max_abs_err=err, ms=timed(run_k, 50),
            igemm_ms=timed(run_old, 50),
            eager_ms=timed_eager(run_k, 50),
            plain_ms=timed(run_p, 5 if M < 100000 else 2), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, library_call=lib_call,
            **extra))
        del x, w, r, y, run_k, run_p, run_old
        torch.cuda.empty_cache()

    # K1's int4 entry at config 5's B = 8 shapes: exact against its plain
    # version and against the int8 entry on the unpacked weight
    k1w4_cases = [
        ("layer1_0 conv3 +int8 residual", 25088, 64, 256,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("layer3 conv1 requant", 1568, 1024, 256, requant, None),
        ("layer4 conv3 +int8 residual", 392, 512, 2048,
         dict(res_scale=0.04, res_zp=-7, **requant), "i8"),
        ("layer4_0 downsample f32", 392, 1024, 2048, {}, None),
    ]
    for label, M, K, N, kw, res in k1w4_cases:
        x, w = i8(M, K), i8(N, K, lo=-7, hi=8)
        w4 = k1.pack_int4_nk(w)
        co, mode = coeffs(N, K, **kw)
        r = i8(M, N) if res == "i8" else None

        def run_k(x=x, w4=w4, co=co, mode=mode, r=r):
            return k1.qmatmul_folded_w4(x, w4, co, mode, r)

        def run_p(x=x, w4=w4, co=co, mode=mode, r=r):
            return k1.qmatmul_folded_w4_plain(x, w4, co, mode, r)

        def run_8(x=x, w=w, co=co, mode=mode, r=r):
            return k1.qmatmul_folded(x, w, co, mode, r)

        def run_old(x=x, w4=w4, co=co, mode=mode, r=r):
            return k1.qmatmul_folded_w4(x, w4, co, mode, r, path="igemm")

        y, err = compare(f"K1 int4 {label}", run_k, run_p)
        check(torch.equal(y, run_8()), f"K1 int4 {label}: differs from the "
              "int8 entry on the unpacked weight")
        check(torch.equal(y, run_old()), f"K1 int4 {label}: the wgmma and "
              "igemm kernels differ")
        out_res = y.element_size() * M * N + 8 * N + \
            (M * N if r is not None else 0)
        b_ms, b_by = bound(M * K + N * K // 2 + out_res, 2 * M * N * K)
        wt = w.t()
        kernels.append(dict(
            name=f"qmatmul_fused w_packed=True [{label}]", route="cuda",
            source=SRC_K1, replaces=TPU_K1, path="cfg5_packed",
            kernel="K1w4", shape=f"M={M} K={K} N={N}", max_abs_err=err,
            k1_path=k1.k1_path(x, w4, y.dtype, r, co, mode),
            ms=timed(run_k, 50), igemm_ms=timed(run_old, 50),
            eager_ms=timed_eager(run_k, 50),
            plain_ms=timed(run_p, 5), bound_ms=b_ms, bound_by=b_by,
            int8_ms=timed(run_8, 50),
            int8_bound_ms=bound(M * K + N * K + out_res, 2 * M * N * K)[0],
            library_ms=timed(lambda: torch._int_mm(x, wt), 50)))
    log("K1 int4 equal to K1 int8 on the unpacked weights")

    def small_variants(label, y, x, w, co, mode, r, kargs, kpath):
        """The small kernel with each multiply forced (mma.sync, and wgmma
        from Co = 16) on a row the small or the stem kernel takes: equal to
        ``y``, and timed — the small kernel's choice between them, and the
        stem kernel's against it."""
        if kpath not in ("small", "stem"):
            return {}
        out = {}
        for mma in ("sync", "wgmma") if w.shape[0] > 8 else ("sync",):
            def run(mma=mma):
                return k2.qconv2d_folded(x, w, co, mode, r, path="small",
                                         small_mma=mma, **kargs)

            check(torch.equal(run(), y), f"K2 {label}: the small kernel "
                  f"with {mma} differs from the {kpath} kernel")
            out[f"small_{mma}_ms"] = timed(run, 20)
        return out

    def conv_fp32_ms(xp, w_oihw, s, groups=1):
        """Library yardstick for K2/K3: cuDNN's fp32 conv (TF32 off) on the
        zero-point-padded codes, channels-last as the codes lie — the int32
        accumulator only (exact while |acc| < 2^24), no epilogue."""
        xf = xp.float().permute(0, 3, 1, 2)
        wf = w_oihw.float().contiguous(memory_format=torch.channels_last)
        with fp32_exact():
            return timed(lambda: F.conv2d(xf, wf, stride=s,
                                                 groups=groups), 50)

    # (path, label, B, H, Ci, Co, kernel, stride, TPU kernel): ResNet-50's
    # 3x3s at B = 8 and, at B = 128, the stride-1 conv2 of every stage and
    # the stride-2 conv2 of layer2_0-layer4_0; the two quantized stems
    # (Ci = 3); every row on the kernel k2_path gives it (the implicit GEMM
    # or the stem kernel) with the pads read in the kernel, and on the old
    # mma.sync loop forced, which must agree
    k2_cases = [
        ("rn50", "layer1 conv2 3x3/1", 8, 56, 64, 64, 3, 1, TPU_K2),
        ("rn50", "layer2_0 conv2 3x3/2", 8, 56, 128, 128, 3, 2, TPU_K2S),
        ("mnv1", "MNv1 int8 stem 3x3/2", 8, 224, 3, 32, 3, 2, TPU_K2S),
        ("rn50_int8stem", "RN50 int8 stem 7x7/2", 8, 224, 3, 64, 7, 2,
         TPU_K2S),
        ("rn50_tv", "RN50 torchvision int8 stem 7x7/2", 8, 224, 3, 64, 7, 2,
         TPU_K2S),
        ("rn50", "B=128 layer1 conv2 3x3/1", 128, 56, 64, 64, 3, 1, TPU_K2),
        ("rn50", "B=128 layer2 conv2 3x3/1", 128, 28, 128, 128, 3, 1, TPU_K2),
        ("rn50", "B=128 layer3 conv2 3x3/1", 128, 14, 256, 256, 3, 1, TPU_K2),
        ("rn50", "B=128 layer4 conv2 3x3/1", 128, 7, 512, 512, 3, 1, TPU_K2),
        ("rn50", "B=128 layer2_0 conv2 3x3/2", 128, 56, 128, 128, 3, 2,
         TPU_K2S),
        ("rn50", "B=128 layer3_0 conv2 3x3/2", 128, 28, 256, 256, 3, 2,
         TPU_K2S),
        ("rn50", "B=128 layer4_0 conv2 3x3/2", 128, 14, 512, 512, 3, 2,
         TPU_K2S),
    ]
    for path, label, B, H, Ci, Co, k, s, tpu in k2_cases:
        x = i8(B, H, H, Ci)
        pads = K2_PADS.get(label) or qops.same_pads((H, H), (k, k), (s, s))
        w = i8(Co, k * k * Ci, lo=-127)
        co, mode = coeffs(Co, k * k * Ci, **requant)
        ts = k2.tapsum_of(w, (k, k))
        kargs = dict(kernel_hw=(k, k), stride=s, pads=pads, zp=-9)
        xp = qops.pad_nhwc(x, pads, -9).contiguous()

        def run_k(x=x, w=w, co=co, mode=mode, ts=ts, kargs=kargs):
            return k2.qconv2d_folded(x, w, co, mode, tapsum=ts, **kargs)

        def run_p(x=x, w=w, co=co, mode=mode, kargs=kargs):
            return k2.qconv2d_folded_plain(x, w, co, mode, **kargs)

        def run_old(xp=xp, w=w, co=co, mode=mode, k=k, s=s):
            # the old loop alone, on the zero-point-padded copy
            return k2.qconv2d_folded(xp, w, co, mode, kernel_hw=(k, k),
                                     stride=s, path="igemm")

        def run_old_pad(x=x, w=w, co=co, mode=mode, kargs=kargs):
            # the old loop as the engines ran it: the pad copy, then K2
            return k2.qconv2d_folded(x, w, co, mode, path="igemm", **kargs)

        kpath = k2.k2_path(x, w, pads, s, co, mode, kernel_hw=(k, k))
        check(kpath == ("stem" if Ci == 3 else "wgmma"),
              f"K2 {label}: k2_path gives {kpath!r}")
        y, err = compare(f"K2 {label} [{kpath}]", run_k, run_p)
        check(torch.equal(y, run_old()) and torch.equal(y, run_old_pad()),
              f"K2 {label}: the {kpath} and igemm kernels differ")
        extra = small_variants(label, y, x, w, co, mode, None, kargs, kpath)
        M = B * y.shape[1] * y.shape[2]
        nbytes = x.numel() + w.numel() + 8 * Co + y.numel()
        b_ms, b_by = bound(nbytes, 2 * M * Co * k * k * Ci)
        # K2's weight rows are (kh, kw, ci)-major: back to OIHW for cuDNN
        w_oihw = w.reshape(Co, k, k, Ci).permute(0, 3, 1, 2)
        kernels.append(dict(
            name=f"qconv2d_fused [{label}]", route="cuda", source=SRC_K2,
            replaces=tpu, path=path, kernel="K2", k2_path=kpath,
            shape=f"B={B} H={H} Ci={Ci} Co={Co} {k}x{k}/{s}",
            max_abs_err=err, ms=timed(run_k, 50),
            igemm_ms=timed(run_old, 20),
            igemm_pad_ms=timed(run_old_pad, 20),
            eager_ms=timed_eager(run_k, 20),
            plain_ms=timed(run_p, 5 if B == 8 else 2), bound_ms=b_ms,
            bound_by=b_by, library_ms=conv_fp32_ms(xp, w_oihw, s), **extra))
        del x, xp, w, y, run_k, run_p, run_old, run_old_pad
        torch.cuda.empty_cache()

    # the im2col conv (patches in PyTorch + one K1 launch) at ResNet-50's
    # quantized 7×7/2 stem, against its plain version and K2
    B, H, Ci, Co = 8, 224, 3, 64
    x, w_hwio = i8(B, H, H, Ci), i8(7, 7, Ci, Co, lo=-127)
    ikw = dict(act_scale=0.02, act_zp=-9,
               w_scale=(torch.rand(Co, generator=g) * 0.01 + 1e-3).to(dev),
               colsum=w_hwio.int().sum((0, 1, 2)),
               bias=torch.randn(Co, generator=g).to(dev), **requant)
    xp = qops.pad_nhwc(x, qops.same_pads((H, H), (7, 7), (2, 2)),
                       -9).contiguous()
    w_nk = k2.weight_ohwi(w_hwio)
    co, mode = k1.fold(**ikw)

    def run_k():
        return qim2col.qconv2d_im2col(x, w_hwio, strides=(2, 2), **ikw)

    def run_p():
        return qim2col.qconv2d_im2col_plain(x, w_hwio, strides=(2, 2), **ikw)

    def run_k2():
        return k2.qconv2d_folded(x, w_nk, co, mode, kernel_hw=(7, 7),
                                 stride=2, pads=qops.same_pads(
                                     (H, H), (7, 7), (2, 2)), zp=-9)

    y, err = compare("im2col RN50 int8 stem 7x7/2", run_k, run_p)
    check(torch.equal(y, run_k2()), "im2col: differs from K2 at the stem")
    log("im2col equal to K2 (its stem kernel) at ResNet-50's stem")
    M = B * 112 * 112
    b_ms, b_by = bound(x.numel() + w_hwio.numel() + 8 * Co + y.numel(),
                       2 * M * Co * 147)
    kernels.append(dict(
        name="qconv2d_im2col [RN50 int8 stem 7x7/2]", route="cuda",
        source=SRC_IM2COL, replaces=TPU_IM2COL, path=None, kernel="im2col",
        shape=f"B={B} H={H} Ci={Ci} Co={Co} 7x7/2 (K=147 padded to 160)",
        max_abs_err=err, ms=timed(run_k, 50),
        eager_ms=timed_eager(run_k, 50), plain_ms=timed(run_p, 3),
        k2_ms=timed(run_k2, 50), bound_ms=b_ms, bound_by=b_by,
        library_ms=conv_fp32_ms(xp, w_hwio.permute(3, 2, 0, 1), 2)))

    # the fp32 stems from uint8 pixels to int8 codes (K10, ops/qstem.py) at
    # ResNet-50's 7x7/2 and MobileNet-v2's 3x3/2 ReLU6, SAME pads, B = 8 and
    # 128, and ResNet's max-pool on those codes (K11): each bit-equal to its
    # plain version (K10 sums the taps in the order of cuDNN's fp32 NHWC
    # conv); library = the plain sequence (cuDNN's conv and PyTorch's
    # glue), timed as the yardstick only, beside cuDNN's conv alone; the
    # equality holds for the cuDNN whose tap order K10 keeps, so each row
    # names the cuDNN it ran on
    cudnn = torch.backends.cudnn.version()
    norm = u8_normalize_coeffs((0.485, 0.456, 0.406), (0.229, 0.224, 0.225),
                               3, device=dev)
    for path, label, Co, K, act_max in (
            ("rn50", "RN50 fp32 stem 7x7/2", 64, 7, None),
            ("mnv2", "MNv2 fp32 stem 3x3/2 relu6", 32, 3, 6.0)):
        w_hwio = (torch.randn((K, K, 3, Co), generator=g)
                  * (2.0 / (K * K * 3)) ** 0.5).to(dev)
        sw = qstem.prepare_stem(
            w_hwio, (torch.randn(Co, generator=g) * 0.1).to(dev))
        skw = dict(strides=(2, 2), padding="SAME", act_max=act_max,
                   grid=(0.03, -128, False), norm=norm)
        for B in (8, 128):
            x8 = torch.randint(0, 256, (B, 224, 224, 3), generator=g,
                               dtype=torch.uint8).to(dev)

            def run_k(x8=x8):
                return qstem.stem_fp32_codes(x8, sw, **skw)

            def run_p(x8=x8):
                return qstem.stem_fp32_codes_plain(x8, sw, **skw)

            y, y_ref = run_k(), run_p()
            torch.cuda.synchronize()
            d = (y.int() - y_ref.int()).abs()
            frac = (d > 0).float().mean().item()
            check(y.shape == y_ref.shape and frac == 0.0,
                  f"K10 {label} B={B}: kernel vs plain max step "
                  f"{d.max().item()}, {frac:.2e} of codes differ (cuDNN "
                  f"{cudnn})")
            log(f"K10 {label} B={B}: codes equal to the plain version's "
                f"(cuDNN {cudnn})")
            xp = qops.pad_nhwc(x8.float() * norm[0] + norm[1], qops.same_pads(
                (224, 224), (K, K), (2, 2)), 0.0).permute(0, 3, 1, 2)
            with fp32_exact():
                conv_ms = timed(lambda: F.conv2d(xp, sw.w_oihw, stride=2),
                                50)
            del xp
            plain_ms = timed(run_p, 5)
            b_ms, b_by = bound(x8.numel() + y.numel() + 4 * (
                sw.w_taps.numel() + Co), 0,
                cuda_core_ops=2 * y.numel() * K * K * 3)
            kernels.append(dict(
                name=f"stem_fp32_codes [{label}]", route="cuda",
                source=SRC_STEM, replaces=NO_TPU_STEM, path=path,
                kernel="K10", shape=f"B={B} 224x224x3 uint8 -> Co={Co} "
                f"{K}x{K}/2 SAME", max_abs_err=d.max().item(),
                codes_differ=frac, ms=timed(run_k, 50),
                eager_ms=timed_eager(run_k, 50), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=plain_ms,
                library_call="cuDNN fp32 F.conv2d and PyTorch's normalize, "
                "bias, activation and quantize (the plain sequence)",
                cudnn_conv_ms=conv_ms, cudnn=cudnn))
            if path == "rn50":
                pads = qops.same_pads(y.shape[1:3], (3, 3), (2, 2))

                def pool_k(y=y, pads=pads):
                    return qstem.maxpool_codes(y, pads)

                def pool_p(y=y, pads=pads):
                    return qstem.maxpool_codes_plain(y, pads)

                yp, err = compare(f"K11 RN50 max-pool 3x3/2 B={B}", pool_k,
                                  pool_p)
                pool_ms = timed(pool_p, 20)
                b_ms, b_by = bound(y.numel() + yp.numel(), 0)
                kernels.append(dict(
                    name="maxpool_codes [RN50 3x3/2 on int8 codes]",
                    route="cuda", source=SRC_STEM, replaces=NO_TPU_STEM,
                    path=path, kernel="K11", shape=f"B={B} 112x112x64 "
                    "int8 -> 56x56, SAME (pad -128)", max_abs_err=err,
                    ms=timed(pool_k, 50), eager_ms=timed_eager(pool_k, 50),
                    plain_ms=pool_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=pool_ms, library_call="the pad and nine "
                    "strided torch.maximum (the plain sequence)"))
            del x8, y, y_ref, d
            torch.cuda.empty_cache()

    k3_cases = [
        ("block1 dw 3x3/2", 8, 112, 96, 2),
        ("block2 dw 3x3/1", 8, 56, 144, 1),
        ("block14 dw 3x3/1", 8, 7, 960, 1),
        ("B=128 block2 dw 3x3/1", 128, 56, 144, 1),
        ("B=128 block14 dw 3x3/1", 128, 7, 960, 1),
    ]
    for label, B, H, C, s in k3_cases:
        x = i8(B, H, H, C)
        w = i8(9, C, lo=-127)
        co, mode = coeffs(C, 9, **relu6)

        def run_k(x=x, w=w, co=co, mode=mode, s=s):
            return k3.qdepthwise_folded(x, w, co, mode, kernel_hw=(3, 3),
                                        stride=s, padding="SAME", zp=-9)

        def run_p(x=x, w=w, co=co, mode=mode, s=s):
            return k3.qdepthwise_folded_plain(x, w, co, mode,
                                              kernel_hw=(3, 3), stride=s,
                                              padding="SAME", zp=-9)

        y, err = compare(f"K3 {label}", run_k, run_p)
        plan = k3.k3_plan(B, H, H, C, y.shape[1], y.shape[2], (3, 3), s,
                          sms=torch.cuda.get_device_properties(
                              dev).multi_processor_count)
        check(plan.path == "halo", f"K3 {label}: plan {plan}")
        # memory-bound: input and output once, the (9, C) weight, A and B;
        # 9 multiply-adds per output element on CUDA cores
        nbytes = x.numel() + y.numel() + w.numel() + 8 * C
        b_ms, b_by = bound(nbytes, 2 * 9 * y.numel(), PEAK_CUDA_CORE_OPS)
        xp = qops.pad_nhwc(x, qops.same_pads((H, H), (3, 3), (s, s)), -9)
        kernels.append(dict(
            name=f"qdepthwise_fused [{label}]", route="cuda", source=SRC_K3,
            replaces=TPU_K3, path="mnv2", shape=f"B={B} H={H} C={C} 3x3/{s}",
            k3_plan=f"{plan.path} rows {plan.th} channels {plan.cc} "
            f"threads {plan.threads}",
            max_abs_err=err, ms=timed(run_k, 50),
            eager_ms=timed_eager(run_k, 20),
            plain_ms=timed(run_p, 5 if B == 8 else 2), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=conv_fp32_ms(xp.contiguous(),
                                    w.t().reshape(C, 1, 3, 3), s, groups=C)))

    # the module SERVE path's raw accumulators and the KL configs'
    # symmetric grids on K2: raw int32 at zero-point-padded shapes (on
    # wgmma the pads read 0 by TMA and corrected by zp·tapsum; LeNet's convs
    # on the small kernel, the pads written in the kernel), the 1×1/2
    # window that runs the module path's quantized downsample, and ReLU +
    # requant onto a symmetric grid (shift 0) on wgmma, the stem kernel
    # and the small kernel (ResNet-20's 3×3s); every row also on the old
    # loop forced, which must agree, and the small kernel's rows (and the
    # stem kernel's) with either multiply of the small kernel forced
    rn20_res = dict(sym, relu=True, res_scale=0.04, res_zp=0)
    # (path, label, B, H, Ci, Co, kernel, stride, padding, zp, epilogue,
    # the path k2_path must give, TPU kernel)
    k2_more = []
    for B in (8, 128):
        pre = "" if B == 8 else "B=128 "
        k2_more += [
            ("rn50_module", f"{pre}layer1 conv2 3x3/1 raw", B, 56, 64, 64, 3,
             1, "SAME", -9, None, "wgmma", TPU_K2),
            ("rn50_module", f"{pre}layer2_0 conv2 3x3/2 raw", B, 56, 128,
             128, 3, 2, "SAME", 23, None, "wgmma", TPU_K2S),
            ("lenet", f"{pre}LeNet conv1 5x5 SAME raw", B, 28, 1, 6, 5, 1,
             "SAME", -17, None, "small", TPU_K2),
            ("lenet", f"{pre}LeNet conv2 5x5 VALID raw", B, 14, 6, 16, 5, 1,
             "VALID", 5, None, "small", TPU_K2),
            ("rn18_module", f"{pre}RN18 layer2_0 down 1x1/2 raw", B, 32, 64,
             128, 1, 2, "SAME", 7, None, "wgmma", TPU_K2S),
            ("rn18", f"{pre}RN18 stem 3x3/1 symmetric", B, 32, 3, 64, 3, 1,
             "SAME", 0, dict(sym, relu=True), "stem", TPU_K2),
            ("rn18", f"{pre}RN18 layer1 conv1 3x3/1 symmetric", B, 32, 64,
             64, 3, 1, "SAME", 0, dict(sym, relu=True), "wgmma", TPU_K2),
            # ResNet-20's 16- and 32-channel 3×3s (symmetric grids, an int8
            # residual on each block's conv2, the stride-2 conv1s)
            ("rn20", f"{pre}RN20 layer1 conv2 3x3/1 +int8 residual", B, 32,
             16, 16, 3, 1, "SAME", 0, rn20_res, "small", TPU_K2),
            ("rn20", f"{pre}RN20 layer2_0 conv1 3x3/2", B, 32, 16, 32, 3, 2,
             "SAME", 0, dict(sym, relu=True), "small", TPU_K2S),
            ("rn20", f"{pre}RN20 layer2 conv2 3x3/1 +int8 residual", B, 16,
             32, 32, 3, 1, "SAME", 0, rn20_res, "small", TPU_K2),
            ("rn20", f"{pre}RN20 layer3_0 conv1 3x3/2", B, 16, 32, 64, 3, 2,
             "SAME", 0, dict(sym, relu=True), "small", TPU_K2S),
        ]
    # the integer-forward QAT conv's raw accumulators at B = 16: config 5's
    # layer1 3×3, layer2_0's 3×3/2 and 1×1/2 downsample, config 3's Ci = 3
    # stem (the raw accumulator: the small kernel)
    k2_more += [
        ("qat_cfg5", "QAT B=16 layer1 conv2 3x3/1 raw", 16, 56, 64, 64, 3, 1,
         "SAME", -9, None, "wgmma", TPU_K2),
        ("qat_cfg5", "QAT B=16 layer2_0 conv2 3x3/2 raw", 16, 56, 128, 128, 3,
         2, "SAME", 23, None, "wgmma", TPU_K2S),
        ("qat_cfg5", "QAT B=16 layer2_0 down 1x1/2 raw", 16, 56, 256, 512, 1,
         2, "SAME", 7, None, "wgmma", TPU_K2S),
        ("qat_cfg3", "QAT B=16 stem 3x3/2 raw", 16, 224, 3, 32, 3, 2, "SAME",
         -5, None, "small", TPU_K2S),
    ]
    for (path, label, B, H, Ci, Co, k, s, padding, zp, kw, want,
         tpu) in k2_more:
        raw = kw is None
        x = i8(B, H, H, Ci, lo=-128 if zp else -127)
        pads = qops.resolve_pads((H, H), (k, k), (s, s), padding)
        OH, OW = k2.out_hw((H, H), (k, k), s, pads)
        w = i8(Co, k * k * Ci, lo=-127)
        co, mode = (None, None) if raw else coeffs(Co, k * k * Ci, **kw)
        r = (i8(B, OH, OW, Co, lo=-127) if not raw and "res_scale" in kw
             else None)
        kargs = dict(kernel_hw=(k, k), stride=s, pads=pads, zp=zp,
                     raw_acc=raw)
        ts = k2.tapsum_of(w, (k, k))
        xp = qops.pad_nhwc(x, pads, zp).contiguous()

        def run_k(x=x, w=w, co=co, mode=mode, r=r, ts=ts, kargs=kargs):
            return k2.qconv2d_folded(x, w, co, mode, r, tapsum=ts, **kargs)

        def run_p(x=x, w=w, co=co, mode=mode, r=r, kargs=kargs):
            return k2.qconv2d_folded_plain(x, w, co, mode, r, **kargs)

        def run_old(xp=xp, w=w, co=co, mode=mode, r=r, k=k, s=s, raw=raw):
            # the old loop alone, on the zero-point-padded copy
            return k2.qconv2d_folded(xp, w, co, mode, r, kernel_hw=(k, k),
                                     stride=s, raw_acc=raw, path="igemm")

        def run_old_pad(x=x, w=w, co=co, mode=mode, r=r, kargs=kargs):
            # the old loop with the pad copy it needs
            return k2.qconv2d_folded(x, w, co, mode, r, path="igemm",
                                     **kargs)

        kpath = k2.k2_path(x, w, pads, s, co, mode, kernel_hw=(k, k),
                           out_dtype=torch.int32 if raw else torch.int8,
                           residual=r)
        check(kpath == want, f"K2 {label}: k2_path gives {kpath!r}")
        y, err = compare(f"K2 {label} [{kpath}]", run_k, run_p)
        check(torch.equal(y, run_old()) and torch.equal(y, run_old_pad()),
              f"K2 {label}: the {kpath} and igemm kernels differ")
        extra = small_variants(label, y, x, w, co, mode, r, kargs, kpath)
        if path.startswith("qat_"):
            # the QAT step's form: the pad code a 0-d int32 on the card —
            # with tapsum prepared, as run_k; and as the QAT conv calls it,
            # tapsum computed from the live weights at each call
            zd = torch.tensor(zp, dtype=torch.int32, device=dev)

            def run_zd(x=x, w=w, kargs=kargs, zd=zd, ts=ts):
                return k2.qconv2d_folded(x, w, None, None, tapsum=ts,
                                         **dict(kargs, zp=zd))

            def run_qat(x=x, w=w, kargs=kargs, zd=zd):
                return k2.qconv2d_folded(x, w, None, None,
                                         **dict(kargs, zp=zd))
            check(torch.equal(run_zd(), y) and torch.equal(run_qat(), y),
                  f"K2 {label}: the pad code on the card differs from the "
                  "host scalar")
            extra["device_pad_code_ms"] = timed(run_zd, 20)
            extra["qat_call_ms"] = timed(run_qat, 20)
        M = B * y.shape[1] * y.shape[2]
        nbytes = x.numel() + w.numel() + y.numel() * y.element_size() + (
            0 if raw else 8 * Co) + (0 if r is None else r.numel())
        b_ms, b_by = bound(nbytes, 2 * M * Co * k * k * Ci)
        w_oihw = w.reshape(Co, k, k, Ci).permute(0, 3, 1, 2)
        kernels.append(dict(
            name=f"qconv2d_fused [{label}]", route="cuda", source=SRC_K2,
            replaces=tpu, path=path, kernel="K2", k2_path=kpath,
            shape=f"B={B} H={H} Ci={Ci} Co={Co} {k}x{k}/{s} {padding} "
            f"zp={zp}", max_abs_err=err, ms=timed(run_k, 20),
            igemm_ms=timed(run_old, 10),
            igemm_pad_ms=timed(run_old_pad, 10),
            eager_ms=timed_eager(run_k, 10),
            plain_ms=timed(run_p, 2), bound_ms=b_ms, bound_by=b_by,
            library_ms=conv_fp32_ms(xp, w_oihw, s), **extra))
        del x, xp, w, y, r, run_k, run_p, run_old, run_old_pad
        torch.cuda.empty_cache()

    # K3's raw accumulator (the module path's depthwise, and the QAT conv's
    # at the trainer's B = 16) at MobileNet-v2's block2 shape
    for B, path, label in (
            (8, "mnv2_module", "block2 dw 3x3/1 raw"),
            (128, "mnv2_module", "B=128 block2 dw 3x3/1 raw"),
            (16, "qat_cfg3", "QAT B=16 block2 dw 3x3/1 raw")):
        x, w = i8(B, 56, 56, 144), i8(9, 144, lo=-127)
        dargs = dict(kernel_hw=(3, 3), stride=1, padding="SAME", zp=-41,
                     raw_acc=True)

        def run_k(x=x, w=w):
            return k3.qdepthwise_folded(x, w, None, None, **dargs)

        def run_p(x=x, w=w):
            return k3.qdepthwise_folded_plain(x, w, None, None, **dargs)

        y, err = compare(f"K3 {label}", run_k, run_p)
        extra = {}
        if path.startswith("qat_"):
            zd = torch.tensor(-41, dtype=torch.int32, device=dev)

            def run_zd(x=x, w=w, zd=zd):
                return k3.qdepthwise_folded(x, w, None, None,
                                            **dict(dargs, zp=zd))
            check(torch.equal(run_zd(), y), f"K3 {label}: the pad code on "
                  "the card differs from the host scalar")
            extra["device_pad_code_ms"] = timed(run_zd, 20)
        plan = k3.k3_plan(B, 56, 56, 144, 56, 56, (3, 3), 1,
                          sms=torch.cuda.get_device_properties(
                              dev).multi_processor_count)
        check(plan.path == "halo", f"K3 {label}: plan {plan}")
        b_ms, b_by = bound(x.numel() + 4 * y.numel() + w.numel(),
                           2 * 9 * y.numel(), PEAK_CUDA_CORE_OPS)
        xp = qops.pad_nhwc(x, ((1, 1), (1, 1)), -41)
        kernels.append(dict(
            name=f"qdepthwise_fused [{label}]", route="cuda", source=SRC_K3,
            replaces=TPU_K3, path=path,
            shape=f"B={B} H=56 C=144 3x3/1 zp=-41",
            k3_plan=f"{plan.path} rows {plan.th} channels {plan.cc} "
            f"threads {plan.threads}",
            max_abs_err=err, ms=timed(run_k, 20),
            eager_ms=timed_eager(run_k, 10),
            plain_ms=timed(run_p, 2), bound_ms=b_ms, bound_by=b_by,
            library_ms=conv_fp32_ms(xp.contiguous(),
                                    w.t().reshape(144, 1, 3, 3), 1,
                                    groups=144), **extra))
        del x, w, y, xp, run_k, run_p
        torch.cuda.empty_cache()
    log("K2 and K3 raw accumulators exact at zero-point-padded shapes; K1 "
        "and K2 exact on symmetric grids")

    def fused_case(kind, B, H, cmid, cout, cin, stride=1):
        """K4/K5/K6 at one ResNet-50 shape: (run kernel, run plain, run the
        unfused K1/K2 sequence it replaces, bytes, operations).  All three
        take the same coefficients; the zero point -9 of ``coeffs`` is
        conv2's pad code."""
        Ho = -(-H // stride)
        M = B * Ho * Ho
        res_i8 = dict(res_scale=0.04, res_zp=-7, **requant)
        if kind == "K4":
            b, x = i8(B, Ho, Ho, cmid), i8(B, H, H, cin)
            w3, wd = i8(cout, cmid, lo=-127), i8(cout, cin, lo=-127)
            co3, mode3 = coeffs(cout, cmid, res_f32=True, **requant)
            cod, dmode = coeffs(cout, cin)
            args = (b, x, w3, wd, co3, mode3, cod)

            def unfused():
                xd = x[:, ::stride, ::stride, :].reshape(-1, cin)
                td = k1.qmatmul_folded(xd, wd, cod, dmode)
                return k1.qmatmul_folded(b.reshape(-1, cmid), w3, co3, mode3,
                                         td).reshape(B, Ho, Ho, cout)
            return (lambda path=None: k4.qproj_folded(*args, stride=stride,
                                                      path=path),
                    lambda: k4.qproj_folded_plain(*args, stride=stride),
                    unfused,
                    b.numel() + M * cin + w3.numel() + wd.numel() + M * cout
                    + 16 * cout, 2 * M * cout * (cmid + cin))
        w2 = i8(cmid, 9 * cmid, lo=-127)
        w3 = i8(cout, cmid, lo=-127)
        co2, mode2 = coeffs(cmid, 9 * cmid, **requant)
        co3, mode3 = coeffs(cout, cmid, **res_i8)
        tail_ops = 2 * M * cmid * 9 * cmid + 2 * M * cout * cmid

        def tail_unfused(a, r):
            bq = k2.qconv2d_folded(qops.pad_nhwc(a, ((1, 1), (1, 1)), -9),
                                   w2, co2, mode2, kernel_hw=(3, 3))
            return k1.qmatmul_folded(bq.reshape(-1, cmid), w3, co3, mode3,
                                     r.reshape(-1, cout)).reshape(
                                         B, H, H, cout)
        if kind == "K5":
            a, r = i8(B, H, H, cmid), i8(B, H, H, cout)
            args = (a, r, w2, w3, co2, mode2, co3, mode3)
            return (lambda path=None: k5.qtail_folded(*args, pad=1, zp=-9,
                                                      path=path),
                    lambda: k5.qtail_folded_plain(*args, pad=1, zp=-9),
                    lambda: tail_unfused(a, r),
                    a.numel() + 2 * M * cout + w2.numel() + w3.numel()
                    + 8 * (cmid + cout), tail_ops)
        x = i8(B, H, H, cout)
        w1 = i8(cmid, cout, lo=-127)
        co1, mode1 = coeffs(cmid, cout, **requant)
        args = (x, w1, w2, w3, co1, mode1, co2, mode2, co3, mode3)

        def block_unfused():
            a = k1.qmatmul_folded(x.reshape(-1, cout), w1, co1, mode1)
            return tail_unfused(a.reshape(B, H, H, cmid), x)
        return (lambda path=None: k6.qblock_folded(*args, zp2=-9, path=path),
                lambda: k6.qblock_folded_plain(*args, zp2=-9),
                block_unfused,
                2 * x.numel() + w1.numel() + w2.numel() + w3.numel()
                + 8 * (2 * cmid + cout),
                tail_ops + 2 * M * cout * cmid)

    # (kind, label, H, Cmid, Cout, Cin, stride): ResNet-50's blocks at B = 8,
    # one case of each kernel per stage (H is the block input's); K5 and K6
    # also at B = 128
    fused_cases = [
        ("K4", "layer1_0 proj, stride 1", 56, 64, 256, 64, 1),
        ("K4", "layer2_0 proj, stride 2", 56, 128, 512, 256, 2),
        ("K4", "layer3_0 proj, stride 2", 28, 256, 1024, 512, 2),
        ("K4", "layer4_0 proj, stride 2", 14, 512, 2048, 1024, 2),
        ("K5", "layer1 tail", 56, 64, 256, 256, 1),
        ("K5", "layer2 tail", 28, 128, 512, 512, 1),
        ("K5", "layer3 tail", 14, 256, 1024, 1024, 1),
        ("K5", "layer4 tail", 7, 512, 2048, 2048, 1),
        ("K6", "layer1 block", 56, 64, 256, 256, 1),
        ("K6", "layer2 block", 28, 128, 512, 512, 1),
        ("K6", "layer3 block", 14, 256, 1024, 1024, 1),
        ("K6", "layer4 block", 7, 512, 2048, 2048, 1),
    ]
    fused_cases += [(kind, f"B=128 {label}", *rest) for kind, label, *rest
                    in fused_cases if kind in ("K5", "K6")]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fused_meta = {"K4": ("qproj2d_fused", SRC_K4, TPU_K4_2D, "tail"),
                  "K5": ("qtail_fused", SRC_K5, TPU_K5, "tail"),
                  "K6": ("qbottleneck_fused", SRC_K6, TPU_K6, "block")}
    for kind, label, H, cmid, cout, cin, s in fused_cases:
        B = 128 if label.startswith("B=128") else 8
        run_k, run_p, run_u, nbytes, ops = fused_case(kind, B, H, cmid,
                                                      cout, cin, s)
        y, err = compare(f"{kind} {label}", run_k, run_p)
        check(torch.equal(run_u(), y), f"{kind} {label}: kernel differs "
              "from the unfused K1/K2 sequence")
        b_ms, b_by = bound(nbytes, ops)
        name, src, tpu, path = fused_meta[kind]
        row = dict(
            name=f"{name} [{label}]", route="cuda", source=src, replaces=tpu,
            path=path, kernel=kind, case=(H, cmid, cout, cin, s),
            shape=f"B={B} H={H} Cmid={cmid} Cout={cout} Cin={cin} /{s}",
            max_abs_err=err, ms=timed(run_k, 50 if B == 8 else 20),
            eager_ms=timed_eager(run_k, 50 if B == 8 else 20),
            plain_ms=timed(run_p, 5 if B == 8 else 2),
            unfused_ms=timed(run_u, 50 if B == 8 else 20),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library_note=NO_LIBRARY)
        if kind == "K4":
            row["kind"] = kind      # also timed at B = 128 below
            # the two-GEMM tile k4_path gives it, against the older
            # mma.sync kernel forced at the same shape
            n0 = k4.qproj_folded.launches_wgmma
            y = run_k()
            check(k4.qproj_folded.launches_wgmma == n0 + 1, f"K4 {label}: "
                  "not on the wgmma kernel")
            check(torch.equal(run_k("igemm"), y), f"K4 {label}: the wgmma "
                  "and igemm kernels differ")
            row.update(k4_path="wgmma",
                       igemm_ms=timed(lambda: run_k("igemm"), 50))
        else:
            del row["case"]
            # K5 / K6: the wgmma kernel tail_path gives them, against the
            # older mma.sync kernel forced at the same shape
            fn = k5.qtail_folded if kind == "K5" else k6.qblock_folded
            n0 = fn.launches_wgmma
            y = run_k()
            check(fn.launches_wgmma == n0 + 1, f"{kind} {label}: not on the "
                  "wgmma kernel")
            check(torch.equal(run_k("igemm"), y), f"{kind} {label}: the "
                  "wgmma and igemm kernels differ")
            plan = k5.tail_plan(B, H, H, cmid, cout, sms=sms,
                                block=kind == "K6")
            row.update(igemm_ms=timed(lambda: run_k("igemm"),
                                      20 if B == 8 else 5),
                       plan=f"cluster {plan.cs}, 8x8 tiles {plan.tiles} "
                       f"({plan.rows:.1%} of rows in the image), grid "
                       f"{plan.grid}, {plan.stages} stages, {plan.smem} B "
                       f"shared, {plan.per_sm} a SM")
        kernels.append(row)
        del run_k, run_p, run_u, y
        torch.cuda.empty_cache()
    log("K4-K6 equal to the unfused K1/K2 sequences they replace; K4, K5 "
        "and K6 on the wgmma kernel, equal to the older kernel")

    pad1 = ((1, 1), (1, 1))

    def chain_unfused(x, w1, w2, w3, co, B, H, cin, cmid):
        """K7's chain as the product engine runs it: K1 → K2 (zero-point
        pad) → K1 + residual per block, the blocks' coefficients."""
        for i in range(w1.shape[0]):
            (co1, m1), (co2, m2), (co3, m3), zp = co.block(i)
            a = k1.qmatmul_folded(x.reshape(-1, cin), w1[i], co1, m1)
            b = k2.qconv2d_folded(qops.pad_nhwc(a.reshape(B, H, H, cmid),
                                                pad1, zp), w2[i], co2, m2,
                                  kernel_hw=(3, 3))
            x = k1.qmatmul_folded(b.reshape(-1, cmid), w3[i], co3, m3,
                                  x.reshape(-1, cin)).reshape(B, H, H, cin)
        return x

    def chain_case(kind, B, H, dims):
        """K7/K8/K9 at one run of the chained engines: (run kernel, run
        plain, run the unfused K1/K2/K3 sequence it replaces, bytes, int8
        GEMM operations, CUDA-core operations, run the older kernel forced
        (``path="igemm"``), the kernel the dispatch takes and its plan).
        Bytes count x once in and once out, the weights and the coefficient
        rows."""
        M = B * H * H
        res_i8 = dict(res_scale=0.04, res_zp=-7, **requant)
        if kind == "K9":
            c, e, n = dims
            x = i8(B, H, H, c)
            w1, wd, w3 = (i8(n, e, c, lo=-127), i8(n, 9, e, lo=-127),
                          i8(n, c, e, lo=-127))
            co = k78.stack_chain([
                (coeffs(e, c, **relu6), coeffs(e, 9, **relu6),
                 coeffs(c, e, requant_scale=0.05, requant_zp=-20,
                        res_scale=0.04, res_zp=-7), -9) for _ in range(n)])
            args = (x, w1, wd, w3, co)

            def unfused():
                y = x
                for i in range(n):
                    (co1, m1), (co2, m2), (co3, m3), zp = co.block(i)
                    a = k1.qmatmul_folded(y.reshape(-1, c), w1[i], co1, m1)
                    d = k3.qdepthwise_folded(
                        a.reshape(B, H, H, e), wd[i], co2, m2,
                        kernel_hw=(3, 3), stride=1, padding="SAME", zp=zp)
                    y = k1.qmatmul_folded(d.reshape(-1, e), w3[i], co3, m3,
                                          y.reshape(-1, c)).reshape(
                                              B, H, H, c)
                return y
            kpath = k9.ivr_path(B, H, H, c, e, co, *args[:4], sms=sms)
            return (lambda: k9.qivr_folded(*args),
                    lambda: k9.qivr_folded_plain(*args), unfused,
                    2 * x.numel() + w1.numel() + wd.numel() + w3.numel()
                    + n * (16 * e + 8 * c + 48),
                    2 * M * n * e * 2 * c, 2 * M * n * e * 9,
                    lambda: k9.qivr_folded(*args, path="igemm"), kpath,
                    chain_plan("ivr", B, H, H, c, e, sms=sms))
        if kind == "K7":
            cin, cmid, n = dims
        else:
            cp, cm, cin, cmid, n = dims
        x = i8(B, H, H, cin if kind == "K7" else cp)
        w1, w2, w3 = (i8(n, cmid, cin, lo=-127), i8(n, cmid, 9 * cmid,
                                                     lo=-127),
                      i8(n, cin, cmid, lo=-127))
        co = k78.stack_chain([
            (coeffs(cmid, cin, **requant), coeffs(cmid, 9 * cmid, **requant),
             coeffs(cin, cmid, **res_i8), -9) for _ in range(n)])
        nbytes = (x.numel() + M * cin + w1.numel() + w2.numel() + w3.numel()
                  + n * (16 * cmid + 8 * cin + 48))
        ops = 2 * M * n * cmid * (2 * cin + 9 * cmid)
        if kind == "K7":
            args = (x, w1, w2, w3, co)
            return (lambda: k78.qstage_folded(*args),
                    lambda: k78.qstage_folded_plain(*args),
                    lambda: chain_unfused(x, w1, w2, w3, co, B, H, cin,
                                          cmid),
                    nbytes, ops, 0,
                    lambda: k78.qstage_folded(*args, path="igemm"),
                    k78.stage_path(B, H, H, cin, cmid, co, *args[:4],
                                   sms=sms),
                    chain_plan("stage", B, H, H, cin, cmid, sms=sms))
        wp = (i8(cm, cp, lo=-127), i8(cm, 9 * cm, lo=-127),
              i8(cin, cm, lo=-127), i8(cin, cp, lo=-127))
        pco = k78.stack_chain([(coeffs(cm, cp, **requant),
                                coeffs(cm, 9 * cm, **requant),
                                coeffs(cin, cm, res_f32=True, **requant),
                                -9)])
        cod, dmode = coeffs(cin, cp)
        args = (x, *wp, pco, cod, w1, w2, w3, co)

        def unfused():
            (co1, m1), (co2, m2), (co3, m3), zp = pco.block(0)
            a = k1.qmatmul_folded(x.reshape(-1, cp), wp[0], co1, m1)
            b = k2.qconv2d_folded(qops.pad_nhwc(a.reshape(B, H, H, cm), pad1,
                                                zp), wp[1], co2, m2,
                                  kernel_hw=(3, 3))
            td = k1.qmatmul_folded(x.reshape(-1, cp), wp[3], cod, dmode)
            x1 = k1.qmatmul_folded(b.reshape(-1, cm), wp[2], co3, m3, td)
            return chain_unfused(x1.reshape(B, H, H, cin), w1, w2, w3, co, B,
                                 H, cin, cmid)
        return (lambda: k78.qstage_proj_folded(*args),
                lambda: k78.qstage_proj_folded_plain(*args), unfused,
                nbytes + sum(w.numel() for w in wp) + 16 * cm + 16 * cin
                + 48, ops + 2 * M * (cm * (cp + 9 * cm + cin) + cp * cin), 0,
                lambda: k78.qstage_proj_folded(*args, path="igemm"),
                k78.stage_proj_path(B, H, H, cp, cm, cin, cmid, pco, co, n,
                                    *args[:5], w1, w2, w3, sms=sms),
                chain_plan("stage_proj", B, H, H, cin, cm, sms=sms))

    # (kind, label, H, dims): the chained engines' runs at B = 8 — K7
    # (Cin, Cmid, blocks), K8 (Cp, Cm, Co, Cmid, chained blocks), K9 (C, E,
    # blocks); H is the run's
    chain_cases = [
        ("K7", "layer1 run", 56, (256, 64, 2)),
        ("K7", "layer2 run", 28, (512, 128, 3)),
        ("K7", "layer3 run", 14, (1024, 256, 5)),
        ("K7", "layer4 run", 7, (2048, 512, 2)),
        ("K8", "layer1 whole stage", 56, (64, 64, 256, 64, 2)),
        ("K9", "block2 run", 56, (24, 144, 1)),
        ("K9", "block4-5 run", 28, (32, 192, 2)),
        ("K9", "block7-9 run", 14, (64, 384, 3)),
        ("K9", "block11-12 run", 14, (96, 576, 2)),
        ("K9", "block14-15 run", 7, (160, 960, 2)),
    ]
    chain_meta = {"K7": ("qstage_fused", SRC_K7, TPU_K7, "stage"),
                  "K8": ("qstage_proj_fused", SRC_K8, TPU_K8, "stage"),
                  "K9": ("qivr_fused", SRC_K9, TPU_K9, "ivr")}
    for kind, label, H, dims in chain_cases:
        (run_k, run_p, run_u, nbytes, ops, dw_ops, run_o, kpath,
         plan) = chain_case(kind, 8, H, dims)
        y, err = compare(f"{kind} {label}", run_k, run_p)
        check(torch.equal(run_u(), y), f"{kind} {label}: kernel differs "
              "from the unfused K1/K2/K3 sequence")
        b_ms, b_by = bound(nbytes, ops, cuda_core_ops=dw_ops)
        name, src, tpu, path = chain_meta[kind]
        extra = {}
        if run_o is not None:   # the runner and the older kernel
            check(torch.equal(run_o(), y), f"{kind} {label}: the older "
                  "kernel forced differs from the dispatched one")
            check(kpath == "wgmma", f"{kind} {label}: dispatched to "
                  f"{kpath}")
            extra = dict(chain_path=kpath, igemm_ms=timed(run_o, 50),
                         plan=None if kpath != "wgmma" else
                         f"{plan.mode}, w {plan.w}, {plan.tm} tile(s) a "
                         f"unit, {plan.stages} stages, {plan.smem} B shared, "
                         f"grid {plan.grid}")
        kernels.append(dict(
            name=f"{name} [{label}]", route="cuda", source=src, replaces=tpu,
            path=path, kernel=kind, kind=kind, case=(H, dims),
            shape=f"B=8 H={H} " + " ".join(
                f"{k}={v}" for k, v in zip(
                    {"K7": ("Cin", "Cmid", "N"),
                     "K8": ("Cp", "Cm", "Co", "Cmid", "N"),
                     "K9": ("C", "E", "N")}[kind], dims)),
            max_abs_err=err, ms=timed(run_k, 50),
            eager_ms=timed_eager(run_k, 50),
            plain_ms=timed(run_p, 3),
            unfused_ms=timed(run_u, 50), bound_ms=b_ms, bound_by=b_by,
            library_ms=None, library_note=NO_LIBRARY, **extra))
        del run_k, run_p, run_u, run_o
    log("K7-K9 equal to the unfused K1/K2/K3 sequences they replace; K7, "
        "K8 and K9 on the runner, equal to the older kernel forced")

    # the integer-forward QAT conv at the trainer's B = 16 (config 5: int4
    # weights; config 3: int8): the kernels' int32 accumulator against the
    # plain float64 one on the card, the conv's output and both gradients
    # against qat_int_conv_plain on the card (equal; the backward's conv
    # transposes on cuDNN's deterministic algorithms — its default wgrad
    # at some shapes sums with atomics, in another order each run), and
    # the simulation on the card (cuDNN fp32, TF32 off) against the
    # integer forward
    def deterministic_cudnn():
        return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                          deterministic=True,
                                          allow_tf32=False)
    gq = torch.Generator(device="cpu").manual_seed(12)
    for what, Ci, Co, k, s, groups, H, w_bits in QAT_INT_CASES:
        x = (torch.randn((16, Ci, H, H), generator=gq) * 2).to(dev)
        w = (torch.randn((Co, Ci // groups, k, k), generator=gq) * 0.1
             ).to(dev)
        scale, zp_u = fq.affine_qparams(x.min(), x.max(), 8)
        kw = dict(w_bits=w_bits, strides=(s, s), groups=groups)
        w_codes, _ = qat_int.weight_codes(w, w_bits, True)
        x_codes = qat_int.act_codes(x.permute(0, 2, 3, 1), scale, zp_u, 8,
                                    False).contiguous()
        pad_zp = int(torch.round(zp_u).item()) - 128
        acc_args = dict(stride=s, padding="SAME", groups=groups, zp=pad_zp)
        acc = qat_int.int_acc(x_codes, w_codes, **acc_args)
        acc_p = qat_int.int_acc_plain(x_codes, w_codes, **acc_args)
        check(torch.equal(acc, acc_p), f"qat_int {what}: int32 accumulator "
              "differs from the plain version")
        # the pad code as the QAT step keeps it: a 0-d int32 on the card,
        # which K2 and K3 read from device memory (K2's old loop, forced,
        # pads its copy from it on the card)
        pad_dev = (torch.round(zp_u) - 128).to(torch.int32)
        kind = qat_int.conv_kind((k, k), (s, s), "SAME", groups, Ci, Co)
        acc_d = qat_int.int_acc(x_codes, w_codes,
                                **dict(acc_args, zp=pad_dev))
        check(torch.equal(acc_d, acc) and torch.equal(acc_d, acc_p),
              f"qat_int {what}: the accumulator with the pad code on the "
              "card differs from the host scalar's or the plain version")
        if kind == "conv":
            w_nk = w_codes.permute(0, 2, 3, 1).reshape(Co, -1).contiguous()
            pads = qops.resolve_pads((H, H), (k, k), (s, s), "SAME")
            old = k2.qconv2d_folded(x_codes, w_nk, None, None,
                                    kernel_hw=(k, k), stride=s, pads=pads,
                                    zp=pad_dev, raw_acc=True, path="igemm")
            check(torch.equal(old, acc), f"qat_int {what}: the old loop on "
                  "the pad copy filled from the card's pad code differs")
        del acc_d
        outs = {}
        for name, fn in (("kernel", qat_int.qat_int_conv),
                         ("plain", qat_int.qat_int_conv_plain)):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xr, wr, scale, zp_u, **kw)
            with deterministic_cudnn():
                y.backward(torch.ones_like(y) * 0.01)
            outs[name] = (y.detach(), xr.grad, wr.grad)
        for t_k, t_p, part in zip(outs["kernel"], outs["plain"],
                                  ("y", "dx", "dw")):
            check(torch.equal(t_k, t_p), f"qat_int {what}: {part} differs "
                  "from the plain version")
        with fp32_exact():
            xq = fq.fake_quant(x, scale, zp_u, bits=8, signed=False,
                               symmetric=False)
            wq = fq.fake_quant_weight(w, bits=w_bits, channel_axis=0)
            pads = qops.resolve_pads((H, H), (k, k), (s, s), "SAME")
            (hlo, hhi), (wlo, whi) = pads
            y_sim = F.conv2d(F.pad(xq, (wlo, whi, hlo, hhi)), wq, stride=s,
                             groups=groups)
        y = outs["kernel"][0]
        rel = ((y_sim - y).norm() / y.norm()).item()
        check(rel <= 1e-5, f"qat_int {what}: simulation vs integer forward "
              f"rel-L2 {rel}")
        log(f"qat_int_conv {what} B=16 ({kind}): int32 accumulator (pad "
            f"code {pad_zp} as a host scalar and on the card"
            + (", also on the old loop forced" if kind == "conv" else "")
            + "), y, dx and dw (the pad code on the card) equal to the "
            f"plain version on the card; simulation vs integer forward "
            f"rel-L2 {rel:.2e}")
        del x, w, acc, acc_p, outs, y, y_sim, xq, wq
        torch.cuda.empty_cache()

    kmods = (k1.qmatmul_folded, k2.qconv2d_folded, k3.qdepthwise_folded,
             k4.qproj_folded, k5.qtail_folded, k6.qblock_folded,
             k78.qstage_folded, k78.qstage_proj_folded, k9.qivr_folded,
             k1.qmatmul_folded_w4, qim2col.qconv2d_im2col)
    plains = (k1.qmatmul_folded_plain, k2.qconv2d_folded_plain,
              k3.qdepthwise_folded_plain, k4.qproj_folded_plain,
              k5.qtail_folded_plain, k6.qblock_folded_plain,
              k78.qstage_folded_plain, k78.qstage_proj_folded_plain,
              k9.qivr_folded_plain, k1.qmatmul_folded_w4_plain,
              qstem.stem_fp32_codes_plain, qstem.maxpool_codes_plain)
    # the kernels with one route each, counted on ``launches``
    single = {"K10": qstem.stem_fp32_codes, "K11": qstem.maxpool_codes}

    split_of = {"K1": k1.qmatmul_folded, "K1w4": k1.qmatmul_folded_w4,
                "K2": k2.qconv2d_folded, "K3": k3.qdepthwise_folded,
                "K5": k5.qtail_folded, "K6": k6.qblock_folded,
                "K7": k78.qstage_folded, "K9": k9.qivr_folded,
                "K4": k4.qproj_folded, "K8": k78.qstage_proj_folded}

    def zero_counts():
        for fn, attr in launch_counters().values():
            setattr(fn, attr, 0)

    def counts():
        """(K1 .. K9, K1 int4, im2col launches, plain-version calls, the
        launches by kernel of K1 int8, K1 int4, K2, K3, K5, K6, K7, K9, K4
        and K8, zero-point pad copies, K10 and K11, at SPLIT's, PADS' and
        KIDX's indices); raises unless each entry's kernels add up to its
        launches."""
        c = [*(k.launches for k in kmods), sum(p.calls for p in plains)]
        c += [0] * (NCOUNTS - len(c))
        for name, fn in split_of.items():
            for kp, i in SPLIT[name].items():
                c[i] = getattr(fn, f"launches_{kp}")
        for name, fn in single.items():
            (i,) = SPLIT[name].values()
            c[KIDX[name]] = c[i] = fn.launches
        c[PADS] = qops.resolve_and_pad.calls
        for name, idx in SPLIT.items():
            check(sum(c[i] for i in idx.values()) == c[KIDX[name]],
                  f"{name}: launches by kernel " + ", ".join(
                      f"{kp} {c[i]}" for kp, i in idx.items()) +
                  f" do not add up to {c[KIDX[name]]}")
        return tuple(c)

    def fmt_counts(c):
        return ", ".join(f"{k} {c[i]}" for k, i in KIDX.items()) + \
            f", plain path {c[PLAIN]}; by kernel " + "; ".join(
                f"{name} " + ", ".join(f"{kp} {c[i]}" for kp, i in idx.items())
                for name, idx in SPLIT.items()) + f"; pad copies {c[PADS]}"

    def one_forward(flat, x, expect, what, entry="forward"):
        zero_counts()
        with torch.inference_mode():
            y = eager_entry(flat, entry)(x)
        torch.cuda.synchronize()
        got = counts()
        check(expected_part(got) == expect, f"{what}: one forward launched "
              f"K1..K9/K1 "
              f"int4/im2col/plain/K10/K11 = {expected_part(got)}, expected "
              f"{expect}")
        check(bool(torch.isfinite(y).all()), f"{what}: logits not finite")
        log(f"{what}, one forward: {fmt_counts(got)}")
        return got

    phase_done("3 (kernels against plain)")

    # -- 4. the slices through ServingEngine ----------------------------------------
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((45, 224, 224, 3)).astype(np.float32)

    def route_counts(c):
        """{(kernel, route): launches} of a counts() tuple, nonzero only."""
        return {(name, kp): c[i] for name, idx in SPLIT.items()
                for kp, i in idx.items() if c[i]}

    def traced_routes(events):
        """{(kernel, route): launches} of the device kernels in ``events``,
        counted by name (``kernel_family``)."""
        from torch.autograd import DeviceType
        got = collections.Counter()
        for e in events:
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            m = re.match(r"(K\d+)( int4)? \S+ \[(\w+)\]$",
                         kernel_family(e.name) or "")
            if m:
                got[(m[1] + ("w4" if m[2] else ""), m[3])] += 1
        return dict(got)

    def traced_call(warm, fn, what):
        """``warm()`` then ``fn()`` under the profiler, ``warm`` as its
        unrecorded warm-up step (a trace's first kernels can be lost).
        Returns (fn()'s counts as counts() gives them, with the launches by
        kernel and route counted by name from the trace's device kernels —
        the im2col calls, plain-version calls and pad copies, Python that a
        replay does not run, from the counters —; the host's CUDA runtime
        calls by name, cudaStreamBeginCapture and cudaGraphLaunch among
        them; fn()'s result).  Raises unless the counters — an eager launch
        counted where it launched, a replay adding its graph's records —
        equal the kernels that the trace saw, route by route."""
        from torch.autograd import DeviceType
        with trace(TRACE_DIR, "cuda", warmup=1) as t:
            warm()
            torch.cuda.synchronize()
            t.step()
            # the recorded step's first kernels can still be lost (an eager
            # forward of the stage engine lacked its first five, the stem
            # kernels among them): a few kernels and a pause open the step
            pad = torch.zeros(1, device=dev)
            for _ in range(8):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            added = counts()
        events = t.profiler.events()
        seen = traced_routes(events)
        check(seen == route_counts(added), f"{what}: the kernels the trace "
              f"saw by name {seen}, the counters (the graphs' records on "
              f"replays) {route_counts(added)}")
        c = [0] * NCOUNTS
        for (name, kp), n in seen.items():
            c[SPLIT[name][kp]] = n
            c[KIDX[name]] += n
        for i in (KIDX["im2col"], PLAIN, PADS):
            c[i] = added[i]
        api = collections.Counter(e.name for e in events
                                  if e.device_type == DeviceType.CPU
                                  and e.name.startswith("cuda"))
        return tuple(c), api, out

    def traced_window(engine, warm, window, what):
        """``traced_call`` of a served window: (its counts, its rounds by
        bucket, window()'s result)."""
        rpb0 = {}

        def counted():
            rpb0.update(engine.stats()["rounds_per_bucket"])
            return window()
        c, _, out = traced_call(warm, counted, what)
        rpb = engine.stats()["rounds_per_bucket"]
        by_bucket = {b: n - rpb0.get(b, 0) for b, n in rpb.items()
                     if n > rpb0.get(b, 0)}
        return c, by_bucket, out

    def logged_rounds(engine):
        """Record every round ``engine`` resolves: [(bucket, futures)]."""
        rounds, resolve = [], engine._resolve_round

        def logged(batch, b, *rest):
            rounds.append((b, [fut for _, fut, _ in batch]))
            return resolve(batch, b, *rest)
        engine._resolve_round = logged
        return rounds

    def eager_rows(engine, rows, b):
        """The engine's eager forward of ``rows`` packed into bucket ``b``
        as a round packs them (zero rows after), its first len(rows)."""
        packed = pack_batch(list(rows), pad_to=b, dtype=engine._raw_dtype,
                            shape=engine._img_shape)
        with torch.no_grad():
            out = engine._fwd(engine.vars, engine._upload(packed))
        return out.cpu().numpy()[:len(rows)]

    def rounds_equal_eager(engine, rounds, sent, what):
        """(a): every response of every logged round bit-equal to the
        engine's eager forward of that round's rows, padded as served;
        ``sent``: [(future, image)] of every request."""
        image = {id(f): im for f, im in sent}
        for b, rf in rounds:
            ref = eager_rows(engine, [image[id(f)] for f in rf], b)
            got = np.stack([f.result() for f in rf])
            bad = int((~(got == ref).all(axis=-1)).sum())
            check(bad == 0, f"{what}: {bad} of {len(rf)} responses of a "
                  f"bucket-{b} round differ from the eager forward of the "
                  "same rows")
        return len(rounds)

    def drive(what, engine, flat, per_fwd, classes, imgs=imgs, exact=False):
        """One direct forward at B = 8 (its launches by kernel); then through
        ``engine`` — a ServingEngine whose warmup captured one CUDA graph a
        bucket — under the profiler (``traced_window``): a burst of 8 as the
        warm-up step, then 45 requests in two waves and bursts of 20 and 8,
        every bucket replayed, every round logged.  The run's launches are
        the replayed kernels counted by name in the trace: each round's
        those of the direct forward, and route by route those the graphs
        recorded (the bucket-8 graph holds the direct forward's launches,
        no graph a plain call or pad copy).
        Then (a) every response bit-equal to the engine's eager forward of
        its round's rows, padded as served; (c) 24 requests through a second
        engine of the same forward with one bucket, 8: pipelined rounds of
        one bucket, each response its own rows' eager forward.  The served
        logits also against ``flat``'s direct forward of all 45 (another
        batch size): rel-L2 ≤ 1e-4, or with ``exact`` equal."""
        sent = []

        # each burst and wave reaches the scheduler at once (submit_burst),
        # so its round's bucket does not hang on the host's load
        def burst(n=8):
            fs = submit_burst(engine, imgs[:n])
            for f in fs:
                f.result(timeout=300)
            sent.extend(zip(fs, imgs[:n]))

        def window():
            wave1 = submit_burst(engine, imgs[:5])
            got = [f.result(timeout=300) for f in wave1]
            wave2 = submit_burst(engine, imgs[5:])
            got += [f.result(timeout=300) for f in wave2]
            sent.extend(zip(wave1 + wave2, imgs))
            burst(20)               # bucket 32's round
            burst()
            return np.stack(got)

        try:
            one_forward(flat, torch.from_numpy(imgs[:8]).to(dev), per_fwd,
                        what)
            held = {k: n for k, n in read_counters(launch_counters()).items()
                    if n}
            st = engine.stats()
            check(engine.graphed_buckets == list(engine.buckets) and
                  all(st["graph_bytes"][b] > 0 for b in engine.buckets),
                  f"{what}: buckets {engine.buckets}, graphed "
                  f"{engine.graphed_buckets}")
            check(st["graph_launches"][8] == held, f"{what}: the bucket-8 "
                  f"graph holds {st['graph_launches'][8]}, the direct "
                  f"forward launched {held}")
            check(not any(k.endswith(".calls") for g in
                          st["graph_launches"].values() for k in g),
                  f"{what}: a graph holds a plain call or pad copy: "
                  f"{st['graph_launches']}")
            log_r = logged_rounds(engine)
            run_counts, by_bucket, served = traced_window(engine, burst,
                                                          window, what)
        finally:
            engine.stop()
        rounds = sum(by_bucket.values())
        check(expected_part(run_counts) == tuple(n * rounds
                                                 for n in per_fwd),
              f"{what}: {rounds} replayed rounds {by_bucket} launched, "
              f"counted in the trace, K1..K9/K1 int4/im2col/plain/K10/K11 = "
              f"{expected_part(run_counts)}")
        check(sorted(by_bucket) == list(engine.buckets),
              f"{what}: the replayed rounds {by_bucket} missed a bucket")
        check(served.shape == (45, classes) and np.isfinite(served).all(),
              "served logits not finite / mis-shaped")
        with torch.inference_mode():
            direct = eager_entry(flat)(torch.from_numpy(imgs)).cpu().numpy()
        rel = float(np.linalg.norm(served - direct) / np.linalg.norm(direct))
        check(rel <= 1e-4, f"{what}: served logits vs forward: rel-L2 {rel}")
        check(not exact or np.array_equal(served, direct),
              f"{what}: served logits differ from the direct forward's")
        n_eq = rounds_equal_eager(engine, log_r, sent, what)
        # (c) pipelined rounds of one bucket
        pipe = ServingEngine(None, engine.vars, batch_buckets=(8,),
                             max_wait_ms=20.0, forward_fn=engine._fwd,
                             preprocess_fn=engine._preprocess,
                             raw_dtype=engine._raw_dtype, device=dev)
        try:
            pipe.warmup(imgs.shape[1:])
            log_p = logged_rounds(pipe)
            futs = [pipe.submit(im) for im in imgs[:24]]
            for f in futs:
                f.result(timeout=300)
            sp = pipe.stats()
        finally:
            pipe.stop()
        check(sp["rounds_per_bucket"].get(8, 0) >= 2, f"{what}: 24 requests "
              f"took {sp['rounds_per_bucket']} rounds, not two of bucket 8")
        rounds_equal_eager(pipe, log_p, list(zip(futs, imgs)),
                           f"{what} [pipelined]")
        mib = {b: round(n / 2**20, 1) for b, n in st["graph_bytes"].items()}
        log(f"{what}: 45 requests and bursts of 20 and 8 in {rounds} rounds "
            f"{by_bucket}, each replaying its bucket's CUDA graph (graph "
            f"memory MiB {mib}); the kernels counted by name in their trace, "
            f"equal route by route to the graphs' records: "
            f"{fmt_counts(run_counts)}; (a) the responses of all {n_eq} "
            f"rounds bit-equal to the eager forward of their rows; (c) "
            f"{sp['rounds_per_bucket'][8]} pipelined rounds of bucket 8, "
            f"each its own rows; rel-L2 vs the direct forward of all 45 "
            f"{rel:.2e}")
        return run_counts

    def serve(cfg, make_flat, per_fwd, imgs=imgs, what=None, exact=False):
        """``build_engine`` for ``cfg`` (a config or its name), driven; the
        flat engine ``make_flat`` builds over its tree, or for the module
        SERVE path the engine's own model, is the direct forward."""
        cfg = CONFIGS[cfg] if isinstance(cfg, str) else cfg
        what = what or cfg.name
        t0 = time.monotonic()
        # a 20 ms collection window: the burst of 40 lands in a bucket above 8
        engine, info = build_engine(cfg, buckets=(8, 32, 128),
                                    max_wait_ms=20.0, device=dev)
        cs = info["calib_seconds"]
        log(f"build_engine ({what}): {time.monotonic() - t0:.1f} s, "
            f"{info['serve_path']}, buckets {info['buckets']}; calibration "
            f"range pass {cs['range']:.2f} s, histogram pass "
            f"{cs['hist']:.2f} s, threshold search (host) "
            f"{cs['search']:.2f} s")
        flat = (engine.model if info["serve_path"] == "module"
                else make_flat(engine.vars))
        run_counts = drive(what, engine, flat, per_fwd, cfg.num_classes,
                           imgs=imgs, exact=exact)
        return flat, run_counts, engine.vars

    cfg = CONFIGS[RN50]
    arch = resnet_arch(cfg.model, num_classes=cfg.num_classes,
                       image_size=cfg.image_size, width=cfg.width,
                       cifar_stem=cfg.cifar_stem)
    rn50, rn50_counts, rn50_vars = serve(
        RN50, lambda v: ResNetInt8Engine(v, arch, device=dev), RN50_FWD)
    # the experimental engine's two configurations on the same frozen tree,
    # served as qtpu serves it: ServingEngine with a forward factory
    fused, path_counts = {}, {"rn50": rn50_counts}
    def serve_factory(what, tree, flat, per_fwd, imgs=imgs, classes=1000):
        """``flat`` served as qtpu serves an experimental engine:
        ServingEngine with a forward factory, over ``tree``."""
        engine = ServingEngine(None, tree, batch_buckets=(8, 32, 128),
                               max_wait_ms=20.0,
                               forward_factory=lambda sv: eager_entry(flat),
                               device=dev)
        engine.warmup(imgs.shape[1:])
        return drive(what, engine, flat, per_fwd, classes, imgs=imgs)

    for cname, (flags, per_fwd) in RN50_FUSED.items():
        flat = fused[cname] = ExperimentalResNetInt8Engine(
            rn50_vars, arch, device=dev, **flags)
        path_counts[cname] = serve_factory(f"{RN50} [{cname}]", rn50_vars,
                                           flat, per_fwd)
    mnv2, mnv2_counts, mnv2_vars = serve(
        MNV2, lambda v: MobileNetV2Int8Engine(v, num_classes=1000,
                                              device=dev),
        (35, 0, 17, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0))
    ivr = ExperimentalMobileNetV2Int8Engine(mnv2_vars, num_classes=1000,
                                            device=dev, use_qivr=True)
    check(sum(p["nrun"] for p in ivr._qivr_prep.values()) == 10
          and len(ivr._qivr_prep) == 5, "ivr: not 10 blocks in 5 runs")
    path_counts["ivr"] = serve_factory(f"{MNV2} [ivr]", mnv2_vars, ivr,
                                       MNV2_IVR)
    for name in MNV1:
        c = CONFIGS[name]
        t0 = time.monotonic()
        tree = freeze_from_config(c, device=dev)
        log(f"freeze ({name}): {time.monotonic() - t0:.1f} s")
        mnv1 = MobileNetV1Int8Engine(tree, num_classes=c.num_classes,
                                     device=dev)
        mnv1_counts = one_forward(mnv1, torch.from_numpy(imgs[:8]).to(dev),
                                  (14, int("stem" in tree["qweights"]), 13,
                                   0, 0, 0, 0, 0, 0, 0, 0, 0,
                                   int("stem" not in tree["qweights"]), 0),
                                  name)
    # the last of MNV1 has the quantized stem: K2 at Ci = 3
    check(mnv1_counts[1] == 1, f"{MNV1[-1]}: the int8 stem did not run K2")
    path_counts.update(mnv2=mnv2_counts, mnv1=mnv1_counts)
    # ResNet-50 with the quantized 7×7/2 stem (K2 at Ci = 3): one direct
    # forward of the product engine (the same architecture as RN50's)
    t0 = time.monotonic()
    rn50s_vars = freeze_from_config(CONFIGS[RN50_INT8STEM], device=dev)
    log(f"freeze ({RN50_INT8STEM}): {time.monotonic() - t0:.1f} s")
    rn50s = ResNetInt8Engine(rn50s_vars, arch, device=dev)
    path_counts["rn50_int8stem"] = one_forward(
        rn50s, torch.from_numpy(imgs[:8]).to(dev), RN50_INT8STEM_FWD,
        RN50_INT8STEM)

    # config 5: int4 weights, EMA calibration, stem and fc in fp32
    cfg5 = CONFIGS[CFG5]
    arch5 = resnet_arch(cfg5.model, num_classes=cfg5.num_classes,
                        image_size=cfg5.image_size, width=cfg5.width,
                        cifar_stem=cfg5.cifar_stem)
    prod5, path_counts["cfg5"], vars5 = serve(
        CFG5, lambda v: ResNetInt8Engine(v, arch5, device=dev), CFG5_PRODUCT)
    packed5 = ResNetInt8Engine(vars5, arch5, device=dev, packed_int4=True)
    path_counts["cfg5_packed"] = serve_factory(f"{CFG5} [packed_int4]",
                                               vars5, packed5, CFG5_PACKED)
    stage5 = ExperimentalResNetInt8Engine(vars5, arch5, device=dev,
                                          packed_int4=True, **STAGE_FLAGS)
    path_counts["cfg5_stage"] = one_forward(
        stage5, torch.from_numpy(imgs[:8]).to(dev), CFG5_STAGE,
        f"{CFG5} [stage, packed_int4]")

    # the module SERVE path and the KL configs (symmetric grids)
    small = np.random.default_rng(2)
    imgs_mnist = small.standard_normal((45, 28, 28, 1)).astype(np.float32)
    imgs_cifar = small.standard_normal((45, 32, 32, 3)).astype(np.float32)
    lenet, path_counts["lenet"], lenet_vars = serve(
        LENET, None, LENET_FWD, imgs=imgs_mnist, exact=True)
    cfg18 = CONFIGS[RN18]
    arch18 = resnet_arch(cfg18.model, num_classes=cfg18.num_classes,
                         image_size=cfg18.image_size, width=cfg18.width,
                         cifar_stem=cfg18.cifar_stem)
    rn18, path_counts["rn18"], rn18_vars = serve(
        RN18, lambda v: ResNetInt8Engine(v, arch18, device=dev), RN18_FWD,
        imgs=imgs_cifar)
    rn18_mod = serve_module(cfg18, rn18_vars, device=dev)
    path_counts["rn18_module"] = serve_factory(
        f"{RN18} [module path]", rn18_vars, rn18_mod, RN18_MODULE_FWD,
        imgs=imgs_cifar, classes=cfg18.num_classes)
    cfg20 = CONFIGS[RN20]
    arch20 = resnet_arch(cfg20.model, num_classes=cfg20.num_classes,
                         image_size=cfg20.image_size, width=cfg20.width,
                         cifar_stem=cfg20.cifar_stem)
    rn20, path_counts["rn20"], rn20_vars = serve(
        RN20, lambda v: ResNetInt8Engine(v, arch20, device=dev), RN20_FWD,
        imgs=imgs_cifar)
    cfg50m = dataclasses.replace(CONFIGS[RN50], exclude=RN50_MODULE_EXCLUDE)
    rn50m, path_counts["rn50_module"], rn50m_vars = serve(
        cfg50m, None, RN50_MODULE_FWD, what=RN50_MODULE)
    cfg2m = dataclasses.replace(CONFIGS[MNV2], exclude=MNV2_MODULE_EXCLUDE)
    t0 = time.monotonic()
    mnv2m_vars = freeze_from_config(cfg2m, device=dev)
    log(f"freeze ({MNV2_MODULE}): {time.monotonic() - t0:.1f} s")
    mnv2m = serve_module(cfg2m, mnv2m_vars, device=dev)
    path_counts["mnv2_module"] = one_forward(
        mnv2m, torch.from_numpy(imgs[:8]).to(dev), MNV2_MODULE_FWD,
        MNV2_MODULE)
    cfg101 = dataclasses.replace(CONFIGS[RN101],
                                 calib_batches=RN101_CALIB_BATCHES)
    t0 = time.monotonic()
    rn101_vars = freeze_from_config(cfg101, device=dev)
    log(f"freeze ({RN101}, {RN101_CALIB_BATCHES} calibration batches): "
        f"{time.monotonic() - t0:.1f} s")
    arch101 = resnet_arch(cfg101.model, num_classes=cfg101.num_classes,
                          image_size=cfg101.image_size, width=cfg101.width,
                          cifar_stem=cfg101.cifar_stem)
    rn101 = ResNetInt8Engine(rn101_vars, arch101, device=dev)
    path_counts["rn101"] = one_forward(
        rn101, torch.from_numpy(imgs[:8]).to(dev), RN101_FWD, RN101)

    # the QAT trainer (BASELINE configs 5 and 3) at full width, cut to
    # QAT_CUT: experiment() — the path run_experiment takes: fp32 steps,
    # convert, QAT steps on the integer forward, evaluation, its JSON line —
    # traced (traced_call), its launches counted by name in the trace; the
    # launches one QAT forward makes, derived from the model by the module
    # path's routing (ops.qat_int.conv_kind); one more QAT step on a copy
    # with the counts zeroed, which must launch exactly that; then the
    # QAT-trained model frozen from its own EMA state and served on its flat
    # engine through ServingEngine
    qat = {}
    labels16 = rng.integers(0, 1000, 16)
    for key, cname in QAT_RUNS.items():
        qcfg = dataclasses.replace(CONFIGS[cname], **QAT_CUT)
        log(f"{cname}: experiment at full width ({qcfg.image_size}², "
            f"{qcfg.num_classes} classes, B = {qcfg.batch_size}), cut to "
            + ", ".join(f"{k}={v}" for k, v in QAT_CUT.items()))
        t0 = time.monotonic()
        # the whole experiment under the profiler: its launches by kernel
        # and route counted by name from the card's trace (the replays'
        # recorded counts held against it), its captures and replays from
        # the host's CUDA runtime calls
        qrun, api, qex = traced_call(
            lambda: torch.ones(1, device=dev).add_(1),
            lambda: experiment(qcfg, seed=0, verbose=False, device=dev),
            f"{cname}: the experiment")
        # its steps and evaluations as CUDA graphs: a fit's first two steps
        # eager, the third captured and replayed, the rest replayed; an
        # evaluation's first batch captured and replayed, the rest replayed
        # (fp32 and QAT, one batch shape each)
        steps = qcfg.n_train // qcfg.batch_size
        evals = -(-qcfg.n_eval // qcfg.batch_size)
        shapes = 1 + (qcfg.n_eval % qcfg.batch_size != 0)
        want_caps = 2 + 2 * shapes
        want_reps = (steps * qcfg.fp32_epochs - 2 + steps * qcfg.qat_epochs
                     - 2 + 2 * evals)
        caps, reps = api["cudaStreamBeginCapture"], api["cudaGraphLaunch"]
        check(caps == want_caps and reps == want_reps, f"{cname}: the "
              f"experiment's trace holds {caps} captures and {reps} graph "
              f"launches, not {want_caps} and {want_reps}")
        qfwd = qat_launches(qex.eval_model)
        # QAT forwards: the training steps, the evaluation batches and the
        # two warm-up forwards before each evaluation graph's capture (a
        # capture launches nothing)
        qn = steps * qcfg.qat_epochs + evals + 2 * shapes
        check(qfwd == QAT_FWD[key], f"{cname}: the module path's routing "
              f"gives {qfwd} launches a QAT forward, not {QAT_FWD[key]}")
        check(expected_part(qrun) == tuple(qn * n for n in qfwd) + (0, 0),
              f"{cname}: the run's {qn} QAT forwards launched "
              f"K1..K9/K1 int4/im2col/plain/K10/K11 = {expected_part(qrun)}")
        check(all(bool(torch.isfinite(p).all())
                  for p in qex.eval_model.parameters()),
              f"{cname}: non-finite parameters after QAT")
        probe = copy.deepcopy(qex.eval_model)
        zero_counts()
        qm = train_step(create_train_state(probe, qcfg.qat_lr), imgs[:16],
                        labels16)
        torch.cuda.synchronize()
        qone = counts()
        check(expected_part(qone) == qfwd + (0, 0), f"{cname}: one QAT step "
              f"launched {expected_part(qone)}, expected {qfwd} and no K10 "
              "or K11")
        check(bool(torch.isfinite(qm["loss"])), f"{cname}: QAT loss "
              f"{float(qm['loss'])}")
        del probe
        # the compiled QAT step against the eager one under the profiler:
        # a replay's kernels by name equal an eager step's, route by route,
        # and the counts its graph's records added
        traced = {}
        for how in ("graphed", "eager"):
            st = create_train_state(copy.deepcopy(qex.eval_model),
                                    qcfg.qat_lr)
            if how == "eager":
                st.run_eagerly()
            for _ in range(3):
                train_step(st, imgs[:16], labels16)
            check(len(st.graphs) == (how == "graphed"), f"{cname}: "
                  f"{how} state holds {len(st.graphs)} graphs")
            c, _, _ = traced_call(
                lambda: train_step(st, imgs[:16], labels16),
                lambda: train_step(st, imgs[:16], labels16),
                f"{cname}: the {how} step")
            traced[how] = route_counts(c)
            del st
        check(traced["graphed"] == traced["eager"], f"{cname}: a replayed "
              f"step's kernels {traced['graphed']}, an eager step's "
              f"{traced['eager']}")
        log(f"{cname}: experiment {time.monotonic() - t0:.1f} s, "
            f"{qn} QAT forwards (training steps, eval batches, the eval "
            f"graph's two warm-ups), the kernels counted by name in its "
            f"trace, equal route by route to the counters: "
            f"{fmt_counts(qrun)}; one QAT forward by the module path's "
            f"routing: {qfwd[0]} K1 + {qfwd[1]} K2 + {qfwd[2]} K3, "
            f"as one QAT step launched them: {fmt_counts(qone)}; that "
            f"step's loss {float(qm['loss']):.4f}; in its trace {caps} "
            f"graphs captured and {reps} replayed (fp32 and QAT steps, "
            f"evaluations); a "
            f"replayed step's kernels by name and route equal an eager "
            f"step's: {traced['graphed']}")
        path_counts[key] = qrun
        t0 = time.monotonic()
        qtree = freeze(qex.eval_model, qex.eval_model.quant)
        qflat = (ResNetInt8Engine(qtree, arch5, device=dev)
                 if key == "qat_cfg5" else
                 MobileNetV2Int8Engine(qtree, num_classes=1000, device=dev))
        log(f"{cname}: frozen from its EMA state in "
            f"{time.monotonic() - t0:.1f} s")
        path_counts[f"{key}_served"] = serve_factory(
            f"{cname} QAT-frozen", qtree, qflat, QAT_SERVED[key])
        qat[key] = (qcfg, qex, qtree, qflat)

    # by kernel: every K1 and K2 launch of the ResNet-50 and config-5
    # engines on the wgmma kernels, MobileNet-v1's int8 stem on the stem
    # kernel, every K3 launch on the halo kernel (every depthwise of the
    # MobileNets has C % 16 == 0); in every run no K1 or K2 launch on the
    # old mma.sync loops (the 24-byte rows and N < 64 on K1's narrow-row
    # kernel, the small-channel convs on K2's small kernel) but FC_IGEMM's
    # fcs, and no zero-point pad copy on the way to K2 or K3
    s1, s1w4, s2, s3 = SPLIT["K1"], SPLIT["K1w4"], SPLIT["K2"], SPLIT["K3"]
    for key, c in path_counts.items():
        if key in ("rn50", "tail", "block", "stage", "cfg5", "cfg5_packed",
                   "cfg5_stage", "rn50_module", "rn101", "qat_cfg5",
                   "qat_cfg5_served"):
            check(c[s1["wgmma"]] == c[KIDX["K1"]]
                  and c[s1w4["wgmma"]] == c[KIDX["K1w4"]],
                  f"{key}: K1 launches {c[KIDX['K1']]} + int4 "
                  f"{c[KIDX['K1w4']]}, on wgmma {c[s1['wgmma']]} + "
                  f"{c[s1w4['wgmma']]}")
            check(c[s2["wgmma"]] == c[KIDX["K2"]] > 0, f"{key}: K2 "
                  f"launches {c[KIDX['K2']]}, on wgmma {c[s2['wgmma']]}")
        fc = FC_IGEMM.get(key, 0) * (
            c[KIDX["K1"]] // {"lenet": LENET_FWD, "rn18": RN18_FWD,
                              "rn18_module": RN18_MODULE_FWD,
                              "rn20": RN20_FWD}.get(key, (1,))[0])
        check(c[s1["igemm"]] == fc and c[s1w4["igemm"]] == 0
              and c[s2["igemm"]] == 0,
              f"{key}: the old mma.sync loops took K1 {c[s1['igemm']]} "
              f"(want {fc}: the fcs below 512 rows), K1 int4 "
              f"{c[s1w4['igemm']]} and K2 {c[s2['igemm']]} launches")
        check(c[s3["halo"]] == c[KIDX["K3"]], f"{key}: K3 launches "
              f"{c[KIDX['K3']]}, on the halo kernel {c[s3['halo']]}")
        check(c[PADS] == 0, f"{key}: {c[PADS]} zero-point pad copies")
    # the runs that took the old loops before the narrow-row and small
    # kernels: their K1 / K2 launches a forward on the new kernels
    rounds = {k: path_counts[k][KIDX["K1"]] // fwd[0] for k, fwd in (
        ("mnv2", (35,)), ("ivr", MNV2_IVR), ("lenet", LENET_FWD),
        ("rn20", RN20_FWD), ("rn18", RN18_FWD),
        ("rn18_module", RN18_MODULE_FWD), ("qat_cfg3", QAT_FWD[
            "qat_cfg3"]), ("qat_cfg3_served", QAT_SERVED["qat_cfg3"]))}
    for key, k1_new, k2_new in (
            ("mnv2", 4, 0), ("ivr", 2, 0), ("lenet", 0, 2),
            ("rn20", 1, 13), ("rn18", 0, 0), ("rn18_module", 0, 1),
            ("qat_cfg3", 4, 1), ("qat_cfg3_served", 4, 0)):
        c, n = path_counts[key], rounds.get(key, 1)
        check(c[s1["wgmma_cp"]] >= k1_new * n and c[s2["small"]] == k2_new
              * n, f"{key}: K1 narrow-row {c[s1['wgmma_cp']]}, K2 small "
              f"{c[s2['small']]} over {n} forwards (want at least {k1_new} "
              f"and {k2_new} a forward)")
    # K5 and K6: every launch of every run on the wgmma kernel (the tail
    # and block runs' 12 a forward)
    for key, c in path_counts.items():
        for kern in ("K5", "K6"):
            sp = SPLIT[kern]
            check(c[sp["igemm"]] == 0 and c[sp["wgmma"]] == c[KIDX[kern]],
                  f"{key}: {kern} launches {c[KIDX[kern]]}, on wgmma "
                  f"{c[sp['wgmma']]}, on the older kernel {c[sp['igemm']]}")
    check(path_counts["tail"][SPLIT["K5"]["wgmma"]] > 0
          and path_counts["block"][SPLIT["K6"]["wgmma"]] > 0,
          "the tail / block runs launched no K5 / K6 on wgmma")
    # K7, K8 and K9: every launch of the stage, packed stage and ivr runs
    # on the runner; K4: every launch of the tail, block and stage runs on
    # the two-GEMM tile
    sp7, sp9 = SPLIT["K7"], SPLIT["K9"]
    sp4, sp8 = SPLIT["K4"], SPLIT["K8"]
    for key, c in path_counts.items():
        for kern, sp in (("K7", sp7), ("K9", sp9), ("K4", sp4), ("K8", sp8)):
            check(c[sp["igemm"]] == 0 and c[sp["wgmma"]] == c[KIDX[kern]],
                  f"{key}: {kern} launches {c[KIDX[kern]]}, on the runner "
                  f"{c[sp['wgmma']]}, on the older kernel {c[sp['igemm']]}")
    check(path_counts["stage"][sp7["wgmma"]] > 0
          and path_counts["cfg5_stage"][sp7["wgmma"]] > 0
          and path_counts["ivr"][sp9["wgmma"]] > 0,
          "the stage / packed stage / ivr runs launched no K7 / K9 on the "
          "runner")
    check(all(path_counts[k][sp4["wgmma"]] > 0 and
              (path_counts[k][sp8["wgmma"]] > 0) == (k in ("stage",
                                                          "cfg5_stage"))
              for k in ("tail", "block", "stage", "cfg5_stage")),
          "the tail / block / stage / packed stage runs launched no K4 on "
          "the two-GEMM tile, or the stage runs no K8 on the runner")
    check(path_counts["mnv1"][s2["stem"]] == 1, "the MobileNet-v1 int8 "
          "stem did not take K2's stem kernel")
    # ResNet-18 KL: the int8 CIFAR stem on the stem kernel, the 3×3s on
    # wgmma, onto symmetric grids
    c = path_counts["rn18"]
    rounds18 = c[KIDX["K2"]] // RN18_FWD[1]
    check(c[s2["stem"]] == rounds18 and c[s2["wgmma"]] == 16 * rounds18,
          f"{RN18}: K2 stem {c[s2['stem']]}, wgmma {c[s2['wgmma']]} over "
          f"{rounds18} forwards (want 1 and 16 a forward)")
    check(path_counts["mnv2_module"][s3["halo"]] == 16,
          f"{MNV2_MODULE}: K3 raw not on the halo kernel 16 times")
    c = path_counts["rn50_int8stem"]
    check(c[s1["igemm"]] == 0 and c[s2["wgmma"]] == 16
          and c[s2["stem"]] == 1,
          f"{RN50_INT8STEM}: K1 igemm {c[s1['igemm']]}, K2 wgmma "
          f"{c[s2['wgmma']]} and stem {c[s2['stem']]} (want 0, 16 and 1)")
    log("launches by kernel per serving run: "
        + "; ".join(f"{k}: " + ", ".join(
            f"{name} " + " ".join(f"{kp} {c[i]}" for kp, i in idx.items())
            for name, idx in SPLIT.items()) + f", pad copies {c[PADS]}"
                    for k, c in path_counts.items()))
    srcs = (SRC_K1, SRC_K2, SRC_K3, SRC_K4, SRC_K5, SRC_K6)

    def set_launches(kern):
        """A row's launches from its path's counted run."""
        c = path_counts[kern["path"]]
        kern["launches"] = c[KIDX[kern["kernel"]]]
        if kern["kernel"] in SPLIT:
            kern["path_launches"] = {kp: c[i] for kp, i in
                                     SPLIT[kern["kernel"]].items()}

    for kern in kernels:
        if "kernel" not in kern:
            kern["kernel"] = f"K{srcs.index(kern['source']) + 1}"
        if kern["path"] in PHASE7_PATHS:
            continue               # counted in phase 7
        # no engine calls the im2col conv: its launches are those counted
        # over every path's serving run (each checked to be 0 above)
        if kern["path"] is None:
            kern["launches"] = sum(c[KIDX["im2col"]]
                                   for c in path_counts.values())
        else:
            set_launches(kern)

    phase_done("4 (serving runs)")

    # -- 5. the same trees on the CPU plain path -------------------------------------
    x2 = torch.from_numpy(imgs[:2])

    def tie_rule(a, b, where):
        d = (a.cpu().int() - b.int()).abs()
        frac = (d > 0).float().mean().item()
        check(d.max().item() <= 1 and frac <= 1e-3,
              f"{where}: card vs CPU codes max diff {d.max().item()}, "
              f"{frac:.2e} of codes differ")
        return frac

    def logits_agree(flat, cpu, what, x2=x2, entry="forward"):
        with torch.inference_mode():
            y_gpu = eager_entry(flat, entry)(x2).cpu().numpy()
            y_cpu = eager_entry(cpu, entry)(x2).numpy()
        rel = float(np.linalg.norm(y_gpu - y_cpu) / np.linalg.norm(y_cpu))
        check(rel <= 1e-4, f"{what}: card vs CPU logits rel-L2 {rel}")
        return rel

    def first_grid(eng):
        if isinstance(eng, MobileNetV2Int8Engine):
            return eng._block_in_grid(eng._blocks()[0][0])
        return grid_of(eng._node(eng._block_names()[0][0], "conv1"))

    def walk_vs_cpu(flat, cpu, what, ref=None, x2=x2, codes=False):
        """Step by step through the forward's plan (a block, or a chained
        run), card against CPU (tie rule), and, given the product engine
        ``ref`` on the card, the codes after each step against its blocks'
        (the fused and chained kernels are bit-exact against the sequence
        they replace, so none may differ).  ``codes``: ``x2`` holds int8
        codes on the stem's grid (the int8 ingest's ``forward_codes``)."""
        worst, differ = 0.0, 0
        with torch.inference_mode():
            gg, cg = first_grid(flat), first_grid(cpu)
            g_codes = flat._stem(x2.to(dev), gg, pre_quantized=codes)
            worst = max(worst, tie_rule(
                g_codes, cpu._stem(x2, cg, pre_quantized=codes), "stem"))
            plan = flat._plan()
            for step in plan:
                g_out, gn = flat._step(g_codes, gg, step)
                c_out, cn = cpu._step(g_codes.cpu(), cg, step)
                if g_out.is_floating_point():   # f32 for an excluded fc
                    d = (g_out.cpu() - c_out).abs().max().item()
                    check(d <= 1e-6 * c_out.abs().max().item(),
                          f"{what} step {step}: card vs CPU f32 max diff {d}")
                else:
                    worst = max(worst, tie_rule(g_out, c_out,
                                                f"{what} step {step}"))
                if ref is not None:
                    r_out, rg = g_codes, gg
                    for k in range(step[0], step[0] + step[1]):
                        r_out, rg = ref._step(r_out, rg, (k, 1, None))
                    differ += int((g_out != r_out).sum().item())
                g_codes, gg, cg = g_out, gn, cn
        rel_cpu = logits_agree(flat, cpu, what, x2,
                               "forward_codes" if codes else "forward")
        check(differ == 0, f"{what}: {differ} codes differ from the product "
              "engine's on the card")
        log(f"{what}, card vs CPU plain path over {len(plan)} steps: worst "
            f"step {worst:.2e} of codes differ, logits rel-L2 {rel_cpu:.2e}"
            + ("" if ref is None else
               "; card vs the product engine on the card: 0 codes differ "
               "at every step"))

    walk_vs_cpu(rn50, ResNetInt8Engine(rn50_vars, arch, device="cpu"), RN50)
    walk_vs_cpu(rn50s, ResNetInt8Engine(rn50s_vars, arch, device="cpu"),
                RN50_INT8STEM)
    for cname, (flags, _) in RN50_FUSED.items():
        walk_vs_cpu(fused[cname], ExperimentalResNetInt8Engine(
            rn50_vars, arch, device="cpu", **flags), f"{RN50} [{cname}]",
            ref=rn50)
    walk_vs_cpu(mnv2, MobileNetV2Int8Engine(mnv2_vars, num_classes=1000,
                                            device="cpu"), MNV2)
    walk_vs_cpu(ivr, ExperimentalMobileNetV2Int8Engine(
        mnv2_vars, num_classes=1000, device="cpu", use_qivr=True),
        f"{MNV2} [ivr]", ref=mnv2)
    # config 5: the packed engines against the CPU, and against the product
    # engine (the int8 entry on the unpacked weights) on the card
    walk_vs_cpu(packed5, ResNetInt8Engine(vars5, arch5, device="cpu",
                                          packed_int4=True),
                f"{CFG5} [packed_int4]", ref=prod5)
    walk_vs_cpu(stage5, ExperimentalResNetInt8Engine(
        vars5, arch5, device="cpu", packed_int4=True, **STAGE_FLAGS),
        f"{CFG5} [stage, packed_int4]", ref=prod5)

    # the KL configs' flat engines, walked step by step
    x2c = torch.from_numpy(imgs_cifar[:2])
    walk_vs_cpu(rn18, ResNetInt8Engine(rn18_vars, arch18, device="cpu"),
                RN18, x2=x2c)
    walk_vs_cpu(rn20, ResNetInt8Engine(rn20_vars, arch20, device="cpu"),
                RN20, x2=x2c)
    walk_vs_cpu(rn101, ResNetInt8Engine(rn101_vars, arch101, device="cpu"),
                RN101)

    def module_vs_cpu(card, cfg, tree, x, what):
        """A module-path model on the card against the same tree's model on
        the CPU, both fed ``x``: each quantized layer's input quantized
        onto its grid (tie rule), and the logits (rel-L2 ≤ 1e-4)."""
        cpu = serve_module(cfg, tree_to_device(tree, torch.device("cpu")),
                           device="cpu")
        seen, hooks = {}, []
        for name, model in (("card", card), ("cpu", cpu)):
            for path in model.kinds:
                layer = model.net.get_submodule(path.replace("/", "."))

                def hook(m, args, key=(name, path)):
                    g = m.node["grid"]
                    a = args[0] if args[0].dim() == 2 else \
                        args[0].permute(0, 2, 3, 1)
                    seen[key] = qops.quantize_act(a, g.scale, g.zp,
                                                  symmetric=g.sym)
                hooks.append(layer.register_forward_pre_hook(hook))
        try:
            rel = logits_agree(card, cpu, what, x)
        finally:
            for h in hooks:
                h.remove()
        worst = max(tie_rule(seen["card", p], seen["cpu", p],
                             f"{what} {p}") for p in card.kinds)
        log(f"{what}, card vs CPU plain path at the inputs of its "
            f"{len(card.kinds)} quantized layers: worst layer {worst:.2e} of "
            f"codes differ, logits rel-L2 {rel:.2e}")

    module_vs_cpu(lenet, CONFIGS[LENET], lenet_vars,
                  torch.from_numpy(imgs_mnist[:2]), LENET)
    module_vs_cpu(rn18_mod, cfg18, rn18_vars, x2c, f"{RN18} [module path]")
    module_vs_cpu(rn50m, cfg50m, rn50m_vars, x2, RN50_MODULE)
    module_vs_cpu(mnv2m, cfg2m, mnv2m_vars, x2, MNV2_MODULE)

    # MobileNet-v1 with the quantized stem (K2 at Ci = 3), the tree of the
    # last phase-4 forward
    cpu = MobileNetV1Int8Engine(tree, num_classes=1000, device="cpu")
    n = len(V1_STRIDES)

    def dw_grid(eng, i):
        return grid_of(eng._node(f"block{i}", "dw")) if i < n else None

    with torch.inference_mode():
        g_codes = mnv1._stem(x2.to(dev), dw_grid(mnv1, 0))
        worst = tie_rule(g_codes, cpu._stem(x2, dw_grid(cpu, 0)), "stem")
        for i in range(n):
            g_out = mnv1._block(g_codes, i, dw_grid(mnv1, i + 1))
            c_out = cpu._block(g_codes.cpu(), i, dw_grid(cpu, i + 1))
            if i + 1 < n:
                worst = max(worst, tie_rule(g_out, c_out, f"block{i}"))
            else:       # the last pointwise emits f32 for the mean-pool
                d = (g_out.cpu() - c_out).abs().max().item()
                check(d <= 1e-6 * c_out.abs().max().item(),
                      f"block{i}: card vs CPU f32 max diff {d}")
            g_codes = g_out
    rel_cpu = logits_agree(mnv1, cpu, MNV1[-1])
    log(f"{MNV1[-1]}, card vs CPU plain path: worst block {worst:.2e} of "
        f"codes differ, last block f32 equal to rtol 1e-6, logits rel-L2 "
        f"{rel_cpu:.2e}")

    # the QAT-frozen models: card against the CPU on the same trees
    for key, (qcfg, qex, qtree, qflat) in qat.items():
        qcpu = (ResNetInt8Engine(qtree, arch5, device="cpu")
                if key == "qat_cfg5" else
                MobileNetV2Int8Engine(qtree, num_classes=1000, device="cpu"))
        walk_vs_cpu(qflat, qcpu, f"{qcfg.name} QAT-frozen")
        del qcpu
    for key, (qcfg, qex, qtree, qflat) in qat.items():
        qat_step_vs_cpu(qcfg.name, qex.model, qcfg.policy(), torch)

    # the compiled steps against eager ones, at full width and B = 16: from
    # the same weights and batches, five steps with graphs (two eager, the
    # capture, replays) and five with graphs off, bit-equal after every
    # step — loss, acc, every parameter, AdamW's state, BatchNorm's
    # running statistics and every observer buffer (cuDNN's deterministic
    # algorithms in both: its default weight gradients sum with atomics,
    # in another order each run); then evaluate graphed against eager,
    # with a remainder batch
    rs5 = np.random.default_rng(15)
    steps5 = [(rs5.standard_normal((16, 224, 224, 3)).astype(np.float32),
               rs5.integers(0, 1000, 16)) for _ in range(5)]

    def same_state(a, b):
        """The names of the tensors (state_dict, AdamW state) that differ."""
        bad = [n for (n, t), u in zip(a.model.state_dict().items(),
                                      b.model.state_dict().values())
               if not torch.equal(t, u)]
        for i, (p, q) in enumerate(zip(a.model.parameters(),
                                       b.model.parameters())):
            sa, sb = a.optimizer.state[p], b.optimizer.state[q]
            bad += [f"adamw[{i}].{k}" for k in sa
                    if not torch.equal(sa[k], sb[k])]
        return bad

    for key, (qcfg, qex, qtree, qflat) in qat.items():
        forms = ("int", "sim", "fp32") if key == "qat_cfg5" else ("int",)
        for form in forms:
            states = {}
            for how in ("graphed", "eager"):
                m = (copy.deepcopy(qex.model) if form == "fp32" else
                     convert_model(qex.model, dataclasses.replace(
                         qcfg.policy(), qat_forward=form)))
                states[how] = create_train_state(m, qcfg.qat_lr)
            states["eager"].run_eagerly()
            with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                            deterministic=True,
                                            allow_tf32=False):
                for i, (xb, yb) in enumerate(steps5):
                    mg = train_step(states["graphed"], xb, yb)
                    me = train_step(states["eager"], xb, yb)
                    bad = same_state(states["graphed"], states["eager"])
                    check(all(torch.equal(mg[k], me[k]) for k in mg)
                          and not bad, f"{qcfg.name} {form} step {i}: "
                          f"graphed {float(mg['loss'])} vs eager "
                          f"{float(me['loss'])}; differing {bad[:5]}")
            check(len(states["graphed"].graphs) == 1, f"{qcfg.name} {form}: "
                  f"{len(states['graphed'].graphs)} graphs")
            log(f"{qcfg.name} {form} steps B=16: five graphed (two eager, "
                f"capture, replays) bit-equal to five eager (loss, acc, "
                f"parameters, AdamW state, BatchNorm statistics, "
                f"observers), last loss {float(mg['loss']):.6f}; graph "
                f"{states['graphed'].graph_bytes() / 2 ** 20:.1f} MiB")
            del states, mg, me
            torch.cuda.empty_cache()
        eds = Dataset(imgs[:40], rng.integers(0, 1000, 40), 1000)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            ev_e = evaluate(qex.eval_model, eds, 16, graphed=False)
            ev_g = evaluate(qex.eval_model, eds, 16)
        check(ev_g == ev_e and len(eval_graphs(qex.eval_model)) == 2,
              f"{qcfg.name}: evaluate graphed {ev_g}, eager {ev_e}, "
              f"{len(eval_graphs(qex.eval_model))} graphs")
        log(f"{qcfg.name}: evaluate over 40 images at B = 16 (16, 16, 8) "
            f"graphed equals eager: top-1, top-5 {ev_g}")

    phase_done("5 (card against CPU)")

    # -- 7. the HTTP server, ``python -m qtpu_torch.serve``, on the card --------
    # Two server processes start together beside this one: A serves phase
    # 4's ResNet-50 tree (fp32 stem) saved by --save-frozen's code path, B
    # imports a torchvision-named ResNet-50 (seeded weights, --torch-ckpt),
    # calibrates it and serves it with --uint8-ingest onto its quantized
    # stem.  While they start, this process checks the new forwards (the
    # host int8 ingest, the bf16 stem) card against CPU with their launches
    # counted, and serves A's tree through the same HTTP front in process
    # with the launches counted; then B answers over HTTP and stops, and A
    # answers a checked window, then a timed one.
    from qtpu_torch.data import native
    from qtpu_torch.serve.cli import build_engine as cli_build_engine
    from qtpu_torch.serve.http_front import serve_http
    from qtpu_torch.utils import checkpoint as ckpt

    work = os.path.join(ROOT, "qtpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    frozen_a = os.path.join(work, "frozen_rn50")
    frozen_b = os.path.join(work, "frozen_rn50_tv")
    tv_pth = os.path.join(work, "tv_resnet50.pth")
    ckpt.save(frozen_a, rn50_vars)
    torch.save(tv_resnet50_state(seed=13), tv_pth)
    torch.cuda.empty_cache()
    servers = {}
    try:
        servers["A"] = start_server(
            ["--config", RN50, "--load-frozen", frozen_a, "--buckets",
             HTTP_BUCKETS], "server A")
        servers["B"] = start_server(
            ["--config", RN50_INT8STEM, "--torch-ckpt", tv_pth,
             "--uint8-ingest", "--save-frozen", frozen_b, "--buckets",
             HTTP_BUCKETS], "server B")

        # the host ingest: the native library against its plain version
        x8 = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
        q_nat = native.preprocess_quantize(x8, (0.0,), (1.0,), 0.0173, -37)
        check(np.array_equal(q_nat, native.preprocess_quantize_plain(
            x8, (0.0,), (1.0,), 0.0173, -37)),
            "preprocess_quantize: the native library differs from plain")
        log(f"preprocess_quantize (native, {native.library_path().name}) "
            "equal to its plain version on 8 images 224²")

        # the bf16 stem on phase 4's tree: launches, card against CPU
        bf16 = ResNetInt8Engine(rn50_vars, arch, device=dev,
                                stem_dtype=torch.bfloat16)
        path_counts["rn50_bf16"] = one_forward(
            bf16, torch.from_numpy(imgs[:8]).to(dev), RN50_FWD,
            f"{RN50} [bf16 stem]")
        walk_vs_cpu(bf16, ResNetInt8Engine(rn50_vars, arch, device="cpu",
                                           stem_dtype=torch.bfloat16),
                    f"{RN50} [bf16 stem]")

        # A's tree through the HTTP front in this process, launches counted
        rs = np.random.default_rng(17)
        plan = [rs.standard_normal((int(rs.integers(1, HTTP_MAX_IMAGES + 1)),
                                    224, 224, 3)).astype(np.float32)
                for _ in range(HTTP_THREADS * HTTP_REQUESTS)]
        n_img = sum(len(r) for r in plan)
        imgs_round = rs.standard_normal((max(ROUND_BUCKETS), 224, 224, 3)
                                        ).astype(np.float32)
        with torch.inference_mode():
            direct = [rn50.eager_forward(torch.from_numpy(r).to(dev)).cpu(
            ).numpy() for r in plan]
        eng, info = cli_build_engine(
            CONFIGS[RN50], buckets=(8, 32), load_frozen=frozen_a,
            device=dev)
        server, _ = serve_http(eng, host="127.0.0.1", port=0, block=False)
        url_in = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            # the plan's first request as the trace's warm-up step
            c, by_bucket, got = traced_window(
                eng, lambda: drive_http(url_in, plan[:1], 1),
                lambda: drive_http(url_in, plan, HTTP_THREADS)[0],
                f"{RN50} over HTTP in process")
            path_counts["rn50_http"] = c
            st = eng.stats()
        finally:
            server.shutdown()
            eng.stop()
        rounds = sum(by_bucket.values())
        check(expected_part(c) == tuple(n * rounds for n in RN50_FWD),
              f"{RN50} over HTTP in process: {rounds} rounds launched, "
              f"counted in the trace, {fmt_counts(c)}")
        check(st["images"] == n_img + len(plan[0]), f"in-process HTTP: "
              f"{st['images']} of {n_img} + {len(plan[0])} images counted")

        def agree(got, ref, what):
            """Max |Δ| over max |ref| per response; counts bit-equal ones."""
            worst, equal = 0.0, 0
            for i, (a, b) in enumerate(zip(got, ref)):
                check(a.shape == b.shape and np.isfinite(a).all(),
                      f"{what} response {i}: {a.shape} vs {b.shape}")
                d = float(np.abs(a - b).max() / np.abs(b).max())
                worst = max(worst, d)
                equal += int(np.array_equal(a, b))
            check(worst <= 1e-6, f"{what}: logits differ from the in-process "
                  f"engine by {worst:.2e} of their largest")
            return worst, equal

        w_in, eq_in = agree(got, direct, f"{RN50} HTTP in process")
        check(info["graphed_buckets"] == HTTP_BUCKET_LIST,
              f"in-process HTTP engine: {info}")
        log(f"{RN50} through the HTTP front in process ({info['serve_path']}"
            f", graphed buckets {info['graphed_buckets']}, graph memory "
            f"{info['graph_bytes'] / 2**20:.1f} MiB"
            f", {len(plan)} requests, {n_img} images, {rounds} rounds "
            f"{by_bucket}; the kernels counted by name in their trace): "
            f"{fmt_counts(c)}; {eq_in} of "
            f"{len(plan)} responses bit-equal to the direct forward, worst "
            f"{w_in:.2e}")

        # server B: --torch-ckpt --uint8-ingest --save-frozen
        ready = wait_line(servers["B"], "QTPU_SERVE_READY ", SERVER_START_S)
        check(ready["serve_path"] == "flat-engine+int8-ingest"
              and ready["raw_dtype"] == "uint8" and ready["torch_pad"]
              and ready["graphed_buckets"] == HTTP_BUCKET_LIST,
              f"server B: READY {ready}")
        graph_mib = {"B": ready["graph_bytes"] / 2**20}
        url_b = f"http://127.0.0.1:{ready['port']}"
        tv_tree = ckpt.load(frozen_b, device=dev)
        arch_tv = resnet_arch("resnet50", num_classes=1000, image_size=224,
                              torch_pad=True, cifar_stem=False)
        tv = ResNetInt8Engine(tv_tree, arch_tv, device=dev)
        plan8 = [rs.integers(0, 256, (int(rs.integers(1, HTTP_MAX_IMAGES
                                                      + 1)), 224, 224, 3),
                             dtype=np.uint8) for _ in range(2 * HTTP_THREADS)]
        s_tv, zp_tv = tv.stem_grid()[:2]
        with torch.inference_mode():
            direct8 = [tv.eager_forward_codes(torch.from_numpy(
                native.preprocess_quantize(r, (0.0,), (1.0,), s_tv, zp_tv)
            ).to(dev)).cpu().numpy() for r in plan8]
            f32_8 = [tv.eager_forward(torch.from_numpy(
                r.astype(np.float32) / 255.0).to(dev)).cpu().numpy()
                for r in plan8]
        got_b, _, _ = drive_http(url_b, plan8, HTTP_THREADS)
        w_b, eq_b = agree(got_b, direct8, f"{RN50_INT8STEM} server B")
        worst_f32 = max(float(np.abs(a - b).max())
                        for a, b in zip(got_b, f32_8))
        check(worst_f32 <= 1e-4 and all(
            (a.argmax(-1) == b.argmax(-1)).all()
            for a, b in zip(got_b, f32_8)),
            f"server B: uint8 ingest vs the f32 path max |Δ| {worst_f32}")
        rc, stopped = stop_server(servers.pop("B"))
        check(rc == 0, f"server B: exit {rc} on SIGTERM")
        log(f"{RN50_INT8STEM} server B (--torch-ckpt torchvision-named "
            f"ResNet-50, --uint8-ingest, --save-frozen; {card}): "
            f"{len(plan8)} uint8 requests, {eq_b} of {len(plan8)} responses "
            f"bit-equal to forward_codes on the host codes of the saved tree "
            f"(worst {w_b:.2e}); the f32 path of the same tree max |Δ| "
            f"{worst_f32:.2e}, argmax equal; SIGTERM exit 0")

        # the int8 ingest in process: launches (the torchvision 7×7/2 stem
        # on K2's stem kernel, no pad copy), card against CPU
        q8 = torch.from_numpy(native.preprocess_quantize(
            x8, (0.0,), (1.0,), s_tv, zp_tv))
        c = path_counts["rn50_tv"] = one_forward(
            tv, q8.to(dev), RN50_TV_FWD, f"{RN50_INT8STEM} torchvision "
            "[int8 ingest]", entry="forward_codes")
        check(c[SPLIT["K2"]["stem"]] == 1 and c[SPLIT["K2"]["wgmma"]] == 16
              and c[PADS] == 0 and c[13] == 0,
              f"torchvision int8 ingest: K2 stem {c[SPLIT['K2']['stem']]}, "
              f"wgmma {c[SPLIT['K2']['wgmma']]}, pad copies {c[PADS]}")
        walk_vs_cpu(tv, ResNetInt8Engine(tv_tree, arch_tv, device="cpu"),
                    f"{RN50_INT8STEM} torchvision [int8 ingest]",
                    x2=q8[:2], codes=True)
        for kern in kernels:
            if kern["path"] in PHASE7_PATHS:
                set_launches(kern)

        # server A: python -m qtpu_torch.serve --load-frozen.  Timed only
        # now: server B has stopped, and this process runs nothing on the
        # card while its clients wait.  The checked window (the plan) warms
        # it up; the timed window is HTTP_TIMED_REQUESTS requests cycling
        # through the plan, every response checked too.
        ready = wait_line(servers["A"], "QTPU_SERVE_READY ", SERVER_START_S)
        check(ready["device"] == "cuda" and ready["serve_path"] ==
              "flat-engine" and ready["raw_dtype"] == "float32"
              and ready["graphed_buckets"] == HTTP_BUCKET_LIST,
              f"server A: READY {ready}")
        graph_mib["A"] = ready["graph_bytes"] / 2**20
        url = f"http://127.0.0.1:{ready['port']}"
        got_a, _, _ = drive_http(url, plan, HTTP_THREADS)
        w_a, eq_a = agree(got_a, direct, f"{RN50} server A")
        cycle = [i % len(plan) for i in range(HTTP_TIMED_REQUESTS)]
        timed_plan = [plan[i] for i in cycle]
        n_timed = sum(len(r) for r in timed_plan)
        rounds_before = json.loads(
            http(url + "/stats")[1])["rounds_per_bucket"]
        torch.cuda.synchronize()
        got_t, lat, wall = drive_http(url, timed_plan, HTTP_THREADS)
        w_t, eq_t = agree(got_t, [direct[i] for i in cycle],
                          f"{RN50} server A, timed window")
        code, body = http(url + "/healthz")
        check(code == 200, f"server A /healthz: {code}")
        code, body = http(url + "/stats")
        sa = json.loads(body)
        check(code == 200 and sa["images"] == n_img + n_timed,
              f"server A /stats: {code} {sa}")
        code, body = http(url + "/metrics")
        check(code == 200 and b"qtpu_serving_healthy 1" in body
              and b'qtpu_serving_rounds_per_bucket{bucket="' in body,
              f"server A /metrics: {code} {body[:300]!r}")
        code, body = http(url + "/predict", b"not an npy payload")
        check(code == 400, f"server A, malformed body: {code}")
        check(http(url + "/healthz")[0] == 200,
              "server A unhealthy after a malformed body")
        rc, stopped = stop_server(servers.pop("A"))
        check(rc == 0 and stopped["images"] == n_img + n_timed,
              f"server A: exit {rc} on SIGTERM, STOPPED {stopped}")
        ms = np.array(lat) * 1e3
        timed_rounds = {k: v - rounds_before.get(k, 0)
                        for k, v in sa["rounds_per_bucket"].items()}
        log(f"{RN50} server A (python -m qtpu_torch.serve --load-frozen, "
            f"buckets {HTTP_BUCKETS}; {card}): checked window {len(plan)} "
            f"requests, {eq_a} bit-equal to the in-process forward (worst "
            f"{w_a:.2e}); timed window after server B stopped: "
            f"{len(timed_plan)} requests of 1-{HTTP_MAX_IMAGES} f32 224² "
            f"images from {HTTP_THREADS} client threads in this process, "
            f"{n_timed} images in {wall:.3f} s = {n_timed / wall:.1f} img/s; "
            f"client-side per request p50 {np.percentile(ms, 50):.2f} ms, "
            f"p90 {np.percentile(ms, 90):.2f} ms, p99 "
            f"{np.percentile(ms, 99):.2f} ms, max {ms.max():.2f} ms; rounds "
            f"{timed_rounds}; {eq_t} of {len(timed_plan)} responses "
            f"bit-equal (worst {w_t:.2e}); malformed body 400, healthy "
            f"after; SIGTERM exit 0; one CUDA graph a bucket, graphed "
            f"{HTTP_BUCKET_LIST}, graph memory A {graph_mib['A']:.1f} MiB, "
            f"B {graph_mib['B']:.1f} MiB")

        # the served round, eager and graphed, at B = 8, 32 and 128: the
        # scheduler's wall time from dispatch to resolve
        # (bench.serve_rounds), one burst a round, on phase 4's tree
        round_rows = {}
        for mode in ("eager", "graphed"):
            eng = ServingEngine(
                None, rn50_vars, batch_buckets=ROUND_BUCKETS,
                max_wait_ms=50.0, device=dev, forward_factory=lambda v:
                ResNetInt8Engine(v, arch, device=dev).eager_forward)
            if mode == "eager":
                eng.serve_eagerly()
            eng.warmup((224, 224, 3))
            try:
                for b in ROUND_BUCKETS:
                    round_ms(eng, imgs_round, b, 1)
                    round_rows[mode, b] = round_ms(eng, imgs_round, b,
                                                   ROUND_REPEATS)
                st = eng.stats()
            finally:
                eng.stop()
            check(sum(st["graphed"].values()) == (len(ROUND_BUCKETS) if
                  mode == "graphed" else 0), f"{mode} rounds: {st}")
            if mode == "graphed":
                graph_mib["rounds"] = {b: round(n / 2**20, 1) for b, n in
                                       st["graph_bytes"].items()}
        log(f"{RN50} served round, the scheduler's wall ms from dispatch to "
            f"resolve, median [min-max] of {ROUND_REPEATS} rounds, one burst "
            f"a round ({card}): " + "; ".join(
                f"B = {b} eager " + " graphed ".join(
                    f"{np.median(round_rows[m, b]):.3f} "
                    f"[{min(round_rows[m, b]):.3f}-"
                    f"{max(round_rows[m, b]):.3f}]"
                    for m in ("eager", "graphed"))
                for b in ROUND_BUCKETS)
            + f"; graph memory MiB {graph_mib['rounds']}")

        # graph-timed forwards at B = 128
        x128 = torch.randn((128, 224, 224, 3), generator=g).to(dev)
        q128 = torch.randint(-128, 128, (128, 224, 224, 3), generator=g,
                             dtype=torch.int8).to(dev)
        with torch.inference_mode():
            t7 = {"f32 stem": timed(lambda: rn50.eager_forward(x128), 5),
                  "bf16 stem": timed(lambda: bf16.eager_forward(x128), 5),
                  "torchvision, f32 in": timed(
                      lambda: tv.eager_forward(x128), 5),
                  "torchvision, int8 ingest": timed(
                      lambda: tv.eager_forward_codes(q128), 5)}
        log(f"ResNet-50 forward B=128 as one CUDA graph ({card}): "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in t7.items()))
        profile_forward(f"{RN50} [f32 stem]", rn50, x128, torch, by_op=True)
        profile_forward(f"{RN50_INT8STEM} torchvision [int8 ingest]",
                        types.SimpleNamespace(forward=tv.eager_forward_codes),
                        q128, torch, by_op=True)
        del x128, q128
    finally:
        for proc, _, _ in servers.values():
            proc.kill()
            proc.wait(timeout=60)
        torch.cuda.empty_cache()
    phase_done("7 (HTTP server)")

    # -- 6. engine throughput and a profile ------------------------------------------
    graph_ms, busy_ms = {}, {}
    for what, flat, batches in ((LENET, lenet, (8, 128)),
                                (RN18, rn18, (8, 128)),
                                (RN20, rn20, (8, 128)),
                                (RN50_MODULE, rn50m, (128,)),
                                (RN50, rn50, (8, 128)),
                                (CFG5, prod5, (8, 128)),
                                (f"{CFG5} [packed_int4]", packed5, (8, 128)),
                                (f"{RN50} [tail]", fused["tail"], (128,)),
                                (f"{RN50} [block]", fused["block"], (128,)),
                                (f"{RN50} [stage]", fused["stage"], (128,)),
                                (MNV2, mnv2, (32, 128)),
                                (f"{MNV2} [ivr]", ivr, (32, 128))):
        hwc = ((28, 28, 1) if flat is lenet else
               (32, 32, 3) if flat in (rn18, rn20) else (224, 224, 3))
        for B in batches:
            x = torch.randn((B, *hwc), generator=g).to(dev)
            with torch.inference_mode():
                body = eager_entry(flat)
                ms = timed_eager(lambda: body(x), 10)
                graph_ms[what, B] = timed(lambda: body(x), 5)
            log(f"{what} engine forward B={B}: {ms:.3f} ms, "
                f"{B / ms * 1e3:.1f} img/s (device time as one CUDA graph: "
                f"{graph_ms[what, B]:.3f} ms)")
        busy_ms[what, x.shape[0]] = profile_forward(what, flat, x, torch,
                                                    by_op=flat is rn50m)
    # the fixed-order head mean against torch.mean at the CIFAR heads
    for what, shape in ((RN18, (128, 4, 4, 512)), (RN20, (128, 8, 8, 64))):
        x = torch.randn(shape, generator=g).to(dev)
        log(f"{what} head mean B=128 {shape[1]}x{shape[2]}x{shape[3]}: "
            f"qops.spatial_mean "
            f"{timed(lambda: qops.spatial_mean(x), 10):.4f} ms, "
            f"torch.mean "
            f"{timed(lambda: torch.mean(x, dim=(1, 2)), 10):.4f} ms "
            "(device time, CUDA graph)")
    log(f"{RN50_MODULE} on the module SERVE path B=128: "
        f"{graph_ms[RN50_MODULE, 128]:.3f} ms as one CUDA graph, the flat "
        f"engine on {RN50} (only the stem in fp32) "
        f"{graph_ms[RN50, 128]:.3f} ms")
    # K4-K9 against the unfused sequence at the B = 128 operating point
    for kern in kernels:
        if "kind" not in kern:
            continue
        kind = kern.pop("kind")
        run_o = None
        if kind in chain_meta:
            H, dims = kern.pop("case")
            (run_k, run_p, run_u, nbytes, ops, dw_ops, run_o, kpath,
             plan) = chain_case(kind, 128, H, dims)
            kern["bound_ms_b128"] = bound(nbytes, ops,
                                          cuda_core_ops=dw_ops)[0]
        else:
            H, cmid, cout, cin, s = kern.pop("case")
            run_k, run_p, run_u, nbytes, ops = fused_case(kind, 128, H, cmid,
                                                          cout, cin, s)
            kern["bound_ms_b128"] = bound(nbytes, ops)[0]
            n0 = k4.qproj_folded.launches_wgmma
            run_k()
            kpath = ("wgmma" if k4.qproj_folded.launches_wgmma == n0 + 1
                     else "igemm")

            def run_o(run_k=run_k):
                return run_k("igemm")
        # the B = 128 plans (K7's two tiles a unit, the fused modes of the
        # runs that split at B = 8) against the plain version too
        y, _ = compare(f"{kern['name']} B=128", run_k, run_p)
        check(torch.equal(y, run_u()), f"{kern['name']}: kernel "
              "differs from the unfused sequence at B = 128")
        kern["ms_b128"] = timed(run_k, 10)
        kern["unfused_ms_b128"] = timed(run_u, 10)
        if run_o is not None:   # the older kernel forced
            check(torch.equal(run_o(), y) and kpath == kern.get(
                "chain_path", kern.get("k4_path")),
                  f"{kern['name']}: the older kernel differs at B = 128, or "
                  f"the dispatch took {kpath}")
            kern["igemm_ms_b128"] = timed(run_o, 10)
            if kpath == "wgmma" and kind in chain_meta:
                kern["plan_b128"] = (f"{plan.mode}, w {plan.w}, {plan.tm} "
                                     f"tile(s) a unit, {plan.stages} stages")
        del run_k, run_p, run_u, run_o, y
        torch.cuda.empty_cache()
    for kern in kernels:
        extra = ""
        if "k1_path" in kern:
            extra = (f"; on {kern['k1_path']}, the old mma.sync loop "
                     f"{kern['igemm_ms']:.4f} ms; the run's "
                     f"launches by kernel {kern['path_launches']}")
        elif "k2_path" in kern:
            extra = (f"; on {kern['k2_path']}, the old mma.sync loop "
                     f"{kern['igemm_ms']:.4f} ms on the padded copy, "
                     f"{kern['igemm_pad_ms']:.4f} ms with its pad copy; the "
                     f"run's launches by kernel "
                     f"{kern['path_launches']}")
        elif "k3_plan" in kern:
            extra = (f"; {kern['k3_plan']}; the run's launches by "
                     f"kernel {kern['path_launches']}")
        if "wgmma_ms" in kern:
            extra += (f"; the TMA ring forced {kern['wgmma_ms']:.4f} ms")
        if "wgmma_cp_ms" in kern:
            extra += (f"; the narrow-row kernel forced "
                      f"{kern['wgmma_cp_ms']:.4f} ms")
        if "small_sync_ms" in kern:
            extra += (f"; the small kernel forced, mma.sync "
                      f"{kern['small_sync_ms']:.4f} ms" + (
                          "" if "small_wgmma_ms" not in kern else
                          f", wgmma {kern['small_wgmma_ms']:.4f} ms"))
        if "int8_ms" in kern:
            extra += (f"; K1's int8 entry on the unpacked weight "
                      f"{kern['int8_ms']:.4f} ms (its bound "
                      f"{kern['int8_bound_ms']:.4f} ms)")
        elif "k2_ms" in kern:
            extra = f"; K2 on the same conv {kern['k2_ms']:.4f} ms"
        if "chain_path" in kern:
            extra += (f"; on {kern['chain_path']}"
                      + (f" (plan: {kern['plan']})" if kern["plan"] else "")
                      + f", the older kernel forced {kern['igemm_ms']:.4f} "
                      "ms")
        elif "plan" in kern:
            extra += (f"; the older mma.sync kernel {kern['igemm_ms']:.4f} "
                      f"ms; plan: {kern['plan']}")
        elif "k4_path" in kern:
            extra += (f"; on {kern['k4_path']}, the older mma.sync kernel "
                      f"{kern['igemm_ms']:.4f} ms")
        if "unfused_ms" in kern:
            extra += (f"; the unfused K1/K2/K3 sequence "
                      f"{kern['unfused_ms']:.4f} ms")
        if "ms_b128" in kern:
            extra += (f"; at B = 128 {kern['ms_b128']:.4f} ms against "
                      f"{kern['unfused_ms_b128']:.4f} ms unfused" + (
                          "" if "bound_ms_b128" not in kern else
                          f" (bound {kern['bound_ms_b128']:.4f} ms)") + (
                          "" if "igemm_ms_b128" not in kern else
                          f", the older kernel {kern['igemm_ms_b128']:.4f} "
                          f"ms" + (f" (plan: {kern['plan_b128']})"
                                   if "plan_b128" in kern else "")))
        log(f"{kern['name']} {kern['shape']}: {kern['ms']:.4f} ms on the "
            f"device, {kern['eager_ms']:.4f} ms launched from Python (bound "
            f"{kern['bound_ms']:.4f} ms, {kern['bound_by']}; plain "
            f"{kern['plain_ms']:.3f} ms; library {kern['library_ms']}{extra}; "
            + (f"{kern['launches']} launches in the {kern['path']} run)"
               if kern["path"] else
               f"no engine calls it: {kern['launches']} launches over every "
               "serving run)"))
    log("library: K1 torch._int_mm (where it takes the shape; else cuBLAS "
        "fp32 torch.mm, TF32 off, on the codes as floats; K1 int4: "
        "torch._int_mm on the unpacked weight; no PyTorch call takes int4), "
        "K2/K3 and the im2col conv cuDNN fp32 "
        "F.conv2d (TF32 off) on the zero-point-padded codes — the int32 "
        f"accumulator only; K4-K9 none: {NO_LIBRARY}")

    # the QAT trainer's step (forward + backward + AdamW) at B = 16, full
    # width, with CUDA events over 5 steps after 3 of warm-up (graphed: two
    # eager, the capture and its replay): the fp32 step, the QAT step on
    # the simulation and on the integer forward, each as its CUDA graph and
    # eagerly (graphs off), in one run, and the graph's bytes; then one
    # integer-forward QAT step profiled, graphed and eager
    log(f"training steps on {card}")
    y16 = rng.integers(0, 1000, 16)
    for key, (qcfg, qex, qtree, qflat) in qat.items():
        step_ms, gbytes = {}, {}
        for form in ("fp32", "sim", "int"):
            for how in ("graphed", "eager"):
                qmodel = (copy.deepcopy(qex.model) if form == "fp32" else
                          convert_model(qex.model, dataclasses.replace(
                              qcfg.policy(), qat_forward=form)))
                qst = create_train_state(qmodel, qcfg.qat_lr)
                if how == "eager":
                    qst.run_eagerly()
                for _ in range(3):
                    train_step(qst, imgs[:16], y16)
                torch.cuda.synchronize()
                step_ms[form, how] = events_ms(
                    lambda: [train_step(qst, imgs[:16], y16)
                             for _ in range(5)], 5)
                gbytes[form] = max(gbytes.get(form, 0), qst.graph_bytes())
                if form == "int":
                    profile_step(f"{qcfg.name} QAT step (integer forward, "
                                 f"{how})", qst, imgs[:16], y16, torch)
                del qmodel, qst
                torch.cuda.empty_cache()
        log(f"{qcfg.name} train step B=16 (forward + backward + AdamW, "
            f"CUDA events over 5 steps after 3 of warm-up), graphed / "
            f"eager: " + ", ".join(
                f"{name} {step_ms[form, 'graphed']:.3f} / "
                f"{step_ms[form, 'eager']:.3f} ms (graph "
                f"{gbytes[form] / 2 ** 20:.1f} MiB)"
                for form, name in (("fp32", "fp32"), ("sim", "QAT simulation"),
                                   ("int", "QAT integer forward")))
            + f"; predicted for the integer step graphed: "
            f"{QAT_STEP_PREDICTED[key]} ms ({card})")
    phase_done("6 (timings)")

    # -- 8. the parallel runtime: two ranks (gloo) on the one card --------------------
    ckpt.save(os.path.join(work, "frozen_mnv2"), mnv2_vars)
    torch.cuda.empty_cache()
    phase8(dev, work, card, torch)
    phase_done("8 (parallel runtime)")

    # -- 9. the tooling: per-layer traces, the slope fit, DP scaling, the
    # projection, receipts --------------------------------------------------------------
    phase9(dev, work, card, torch, {RN50: rn50, MNV2: mnv2}, graph_ms,
           busy_ms)
    phase_done("9 (the tooling)")

    # -- 10. the flat engines' own entries compiled per input shape, and
    # calibration's passes per batch shape ----------------------------------------------
    def entry_input(eng, entry, B, hwc, seed):
        gen = torch.Generator().manual_seed(seed)
        if entry == "forward_u8":
            return torch.randint(0, 256, (B, *hwc), generator=gen,
                                 dtype=torch.uint8).to(dev)
        x = torch.randn((B, *hwc), generator=gen).to(dev)
        if entry == "forward_codes":
            sg = eng.stem_grid()
            return qops.quantize_act(x, sg.scale, sg.zp, symmetric=sg.sym)
        return x

    rows10 = []
    for what, eng, hwc, keys in (
            (RN50, rn50, (224, 224, 3),
             (("forward", 8), ("forward", 128), ("forward_u8", 8))),
            (f"{RN50} [tail]", fused["tail"], (224, 224, 3),
             (("forward", 8), ("forward", 128))),
            (f"{RN50} [block]", fused["block"], (224, 224, 3),
             (("forward", 8), ("forward", 128))),
            (f"{RN50} [stage]", fused["stage"], (224, 224, 3),
             (("forward", 8), ("forward", 128))),
            (RN50_INT8STEM, rn50s, (224, 224, 3),
             (("forward", 8), ("forward_codes", 8), ("forward_codes", 128))),
            (CFG5, prod5, (224, 224, 3), (("forward", 8), ("forward", 128))),
            (f"{CFG5} [packed_int4]", packed5, (224, 224, 3),
             (("forward", 8), ("forward", 128))),
            (f"{CFG5} [stage, packed_int4]", stage5, (224, 224, 3),
             (("forward", 8), ("forward", 128))),
            (MNV2, mnv2, (224, 224, 3),
             (("forward", 32), ("forward", 128), ("forward_u8", 32))),
            (f"{MNV2} [ivr]", ivr, (224, 224, 3),
             (("forward", 32), ("forward", 128))),
            (MNV1[-1], mnv1, (224, 224, 3),
             (("forward", 8), ("forward_codes", 8), ("forward", 128))),
            (RN18, rn18, (32, 32, 3), (("forward", 8), ("forward", 128))),
            (RN20, rn20, (32, 32, 3), (("forward", 8), ("forward", 128)))):
        check(not eng.graphs, f"{what}: graphs before phase 10: "
              f"{sorted(eng.graphs)}")
        for i, (entry, B) in enumerate(keys):
            fn, body = getattr(eng, entry), eager_entry(eng, entry)
            name = f"{what} {entry} B={B}"
            x = entry_input(eng, entry, B, hwc, 10 * i)
            x2 = entry_input(eng, entry, B, hwc, 10 * i + 1)
            with torch.inference_mode():
                ref, ref2 = body(x), body(x2)
                y = fn(x)                  # captured, then replayed
                key = (entry, tuple(x.shape))
                check(key in eng.graphs, f"{name}: no graph after the "
                      f"first call ({sorted(eng.graphs)})")
                y2 = fn(x2)
                check(torch.equal(y, ref) and torch.equal(y2, ref2),
                      f"{name}: a replay differs from the eager body")
                check(y.data_ptr() != y2.data_ptr(), f"{name}: two calls "
                      "returned one buffer")
                # the launches of a replay against an eager call's, counted
                # by kernel name in a trace, route by route
                c_e, _, _ = traced_call(lambda: body(x), lambda: body(x),
                                        f"{name} [eager]")
                c_g, api, y3 = traced_call(lambda: fn(x), lambda: fn(x),
                                           f"{name} [replay]")
                check(c_g == c_e and c_g[PLAIN] == 0 and any(
                    c_g[:PLAIN]), f"{name}: a replay launched "
                      f"{fmt_counts(c_g)}, the eager body {fmt_counts(c_e)}")
                check(api.get("cudaGraphLaunch", 0) == 1
                      and not api.get("cudaStreamBeginCapture", 0),
                      f"{name}: the call's runtime calls {dict(api)}")
                check(torch.equal(y3, ref) and torch.equal(y, ref)
                      and torch.equal(y2, ref2), f"{name}: an output held "
                      "across calls changed, or a later replay differs")
                ms_g = timed_eager(lambda: fn(x), 20)
                ms_e = timed_eager(lambda: body(x), 20)
            nbytes = eng.graphs[key].nbytes
            rows10.append((name, ms_g, ms_e, nbytes))
            log(f"{name} ({card}): graphed {ms_g:.3f} ms a call, eager "
                f"{ms_e:.3f} ms (timed_eager, 20 calls from a "
                f"device-resident input); graph {nbytes / 2 ** 20:.1f} MiB; "
                "two calls bit-equal to the eager body and still held "
                "after a third; a replay's launches equal the eager body's "
                f"by route ({fmt_counts(c_g)}; one cudaGraphLaunch)")
            del x, x2, ref, ref2, y, y2, y3
        eng.free_graphs()
        torch.cuda.empty_cache()
    log("phase 10 graphed / eager ms a call and graph MiB per (entry, "
        f"shape) ({card}): " + "; ".join(
            f"{n} {g:.3f} / {e:.3f} ({b / 2 ** 20:.1f} MiB)"
            for n, g, e, b in rows10))

    # the histogram observer's update against the same update counted by
    # torch.bincount (which reads its size back to the host, so a graph
    # cannot hold it) on ReLU'd activations at ResNet-18 KL's layer1
    # (B = 64) and ResNet-50's layer1 (B = 16): the device time of each
    # one's kernels in a trace, the port's as a graph, bincount's launched
    # from Python (its host read included)
    for what, shape in ((f"{RN18} layer1 B=64", (64, 32, 32, 64)),
                        (f"{RN50} layer1 B=16", (16, 56, 56, 256))):
        xh = torch.relu(torch.randn(shape, generator=g)).to(dev)
        hs = obs.hist_set_range(obs.hist_init(device=dev), xh.abs().amax())
        check(torch.equal(obs.hist_update(hs, xh)["counts"],
                          bincount_hist_update(torch, hs, xh)),
              f"{what}: the histogram's counts differ from torch.bincount's")
        dev_ms = {k: traced_kernel_ms(torch, fn, 20) for k, fn in (
            ("port", lambda: obs.hist_update(hs, xh)),
            ("bincount", lambda: bincount_hist_update(torch, hs, xh)))}
        port_ms = timed(lambda: obs.hist_update(hs, xh), 20)
        bincount_ms = timed_eager(
            lambda: bincount_hist_update(torch, hs, xh), 20)
        log(f"histogram update of |x| into {obs.HIST_NBINS} bins, {what} "
            f"({xh.numel()} values, ReLU'd; {card}): device time of the "
            f"kernels in a trace, the port's ({obs.HIST_ROWS} partial "
            f"histograms) {fmt_ms(dev_ms['port'])} ms, on torch.bincount "
            f"{fmt_ms(dev_ms['bincount'])} ms; the port's as a CUDA graph "
            f"{port_ms:.4f} ms, on bincount from Python (its host read "
            f"included) {bincount_ms:.4f} ms; the counts equal")
        del xh, hs
    # each update's first calls in a fresh process, both orders: what the
    # process's first histogram pass pays to load its kernels
    for order in ("port,bincount", "bincount,port"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--cold-hist", order], capture_output=True,
                             text=True, timeout=300, cwd=ROOT)
        check(res.returncode == 0, f"--cold-hist {order}: exit "
              f"{res.returncode}: {res.stderr[-2000:]}")
        first = json.loads(res.stdout.strip().splitlines()[-1])
        log(f"histogram update, first three calls in a fresh process, "
            f"{order} ({RN18} layer1 B=64, wall ms, synchronised; {card}): "
            + "; ".join(f"{k} " + ", ".join(f"{v:.3f}" for v in ms)
                        for k, ms in first.items()))

    # calibration's passes, graphed against eager on the card, in the
    # order eager, graphed, graphed, eager (neither way always second)
    def cal_differs(a, b):
        st_a, st_b = a["quant_stats"], b["quant_stats"]
        bad = [f"{p}/{k}" for p in st_a for k, v in st_a[p].items()
               if (not torch.equal(v, st_b[p][k])
                   if isinstance(v, torch.Tensor) else v != st_b[p][k])]
        bad += [f"{p}/{k}" for p, q in a["quant_params"].items()
                for k in ("act_scale", "act_zp")
                if not torch.equal(q[k], b["quant_params"][p][k])]
        return bad + ([] if st_a.keys() == st_b.keys() else ["layers"])

    for name in (RN50, CFG5, RN18, RN20):
        model, policy, batches = calibration_inputs(CONFIGS[name], device=dev)
        runs = [(graphed, calibrate(model, policy, batches, graphed=graphed))
                for graphed in (False, True, True, False)]
        for graphed, cal in runs[1:]:
            bad = cal_differs(runs[0][1], cal)
            check(not bad, f"{name}: calibration (graphed {graphed}) "
                  f"differs from the first eager one at {bad[:8]}")
        st = runs[0][1]["quant_stats"]
        observers = sorted({policy.spec_for(p).act_observer for p in st})
        log(f"{name} calibration ({', '.join(observers)}; "
            f"{len(st)} layers, {CONFIGS[name].calib_batches} batches of "
            f"{CONFIGS[name].batch_size}; {card}): quant_stats and "
            "quant_params bit-equal graphed and eager; seconds in the order "
            "eager, graphed, graphed, eager: " + ", ".join(
                f"{k} " + " / ".join(f"{cal['seconds'][k]:.3f}"
                                     for _, cal in runs)
                for k in ("range", "hist", "search")))
        del runs, model, batches
        torch.cuda.empty_cache()
    phase_done("10 (graphed entries and calibration)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def device_kernels(torch, fn):
    """The names (cut to 60 characters) of the device kernels one call of
    ``fn`` launches (``bench.profile.trace``)."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with trace(TRACE_DIR, "cuda") as t:
        fn()
        torch.cuda.synchronize()
    return [e.name[:60] for e in t.profiler.events()
            if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation] or ["none reported"]


def traced_kernel_ms(torch, fn, n):
    """Device ms a call of ``fn``: the time of its kernels in a trace of
    ``n`` calls (``profiled``), over ``n``; copies between host and card
    and the host's waits are not in it.  None if the trace held no device
    time."""
    from torch.autograd import DeviceType
    averages, _, _ = profiled(torch, lambda: [fn() for _ in range(n)],
                              False)
    us = sum(e.self_device_time_total for e in averages
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation
             and not e.key.startswith(("ProfilerStep", "Memcpy")))
    return us / n / 1e3 if us else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def bincount_hist_update(torch, state, x):
    """The histogram observer's update as it counted before it was
    captured in a graph: the same bins, counted by ``torch.bincount``
    (which on the card reads the largest index back to the host); the new
    counts."""
    counts = state["counts"]
    nbins = counts.shape[0]
    amax = torch.clamp_min(state["amax"], 1e-12)
    ax = torch.abs(x).to(torch.float32).reshape(-1)
    idx = torch.clamp((ax / amax * nbins).to(torch.int32), 0, nbins - 1)
    batch = torch.bincount(idx.to(torch.int64), minlength=nbins)
    return counts + batch.to(torch.float32)


def cold_hist(order: str) -> int:
    """``--cold-hist A,B``: in this fresh process, the first three calls of
    each histogram update — ``port`` the observer's (``hist_update``),
    ``bincount`` :func:`bincount_hist_update` — in the order given, wall
    ms each (synchronised), on ReLU'd activations at ResNet-18 KL's layer1
    (B = 64), after the kernels the two share (the bin index, the casts,
    the add) have run once.  Prints one JSON line."""
    import torch

    from qtpu_torch.calib import observers as obs
    x = torch.relu(torch.randn((64, 32, 32, 64),
                               generator=torch.Generator().manual_seed(0)))
    x = x.cuda()
    hs = obs.hist_set_range(obs.hist_init(device=x.device), x.amax())
    nb = obs.HIST_NBINS
    idx = torch.clamp((torch.abs(x).to(torch.float32).reshape(-1)
                       / torch.clamp_min(hs["amax"], 1e-12) * nb
                       ).to(torch.int32), 0, nb - 1)
    _ = hs["counts"] + idx[:nb].to(torch.int64).to(torch.float32)
    fns = {"port": lambda: obs.hist_update(hs, x),
           "bincount": lambda: bincount_hist_update(torch, hs, x)}
    out = {}
    for name in order.split(","):
        out[name] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps(out))
    return 0


def profiled(torch, run, record_shapes):
    """One call of ``run`` traced by ``bench.profile.trace`` after one call
    of warm-up under its schedule — a forward traced alone lacked its first
    kernels on the card (the fp32 stem's conv, the int8 stem kernel): (the
    per-kernel averages, the events, the traced call's wall ms)."""
    wall = []
    with trace(TRACE_DIR, "cuda", warmup=1,
               record_shapes=record_shapes) as t:
        for i in range(2):
            if i:       # the recorded call starts after the recording does
                time.sleep(0.05)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            t.step()
    return t.profiler.key_averages(), t.profiler.events(), wall[-1]


def elementwise_by_op(events):
    """The PyTorch elementwise kernels' device time by the outermost
    operation that launched them and the ranks of its inputs (a 4-d tensor
    against a (C,) vector or a 0-dim tensor tells a broadcast apart):
    (op, kernel family, ranks) → [launches, µs, the first call's input
    shapes]."""
    ops = {}
    for e in events:
        ks = [k for k in getattr(e, "kernels", ())
              if "elementwise_kernel" in k.name]
        if not ks:
            continue
        top = e      # up to the outermost op inside any span (a scope)
        while (top.cpu_parent is not None
               and not top.cpu_parent.is_user_annotation
               and not top.cpu_parent.name.startswith("ProfilerStep")):
            top = top.cpu_parent
        for k in ks:
            fam = ("unvectorised" if re.search(r"\belementwise_kernel<",
                                               k.name)
                   else "vectorised")
            key = (top.name, fam,
                   tuple(len(sh) for sh in top.input_shapes))
            n, us, shapes = ops.get(key, (0, 0.0, None))
            ops[key] = (n + 1, us + k.duration, shapes or top.input_shapes)
    return ops


def kernel_family(key):
    """The port's kernel (and which of its kernels) a device kernel name
    belongs to, or None."""
    return (
        "K10 stem_fp32_codes [stem]" if "stem_codes_kernel" in key else
        "K11 maxpool_codes [pool]" if "maxpool_codes_kernel" in key else
        "K8 qstage_proj_fused [igemm]"
        if re.search(r"qstage_kernel<\w+, true>", key) else
        "K8 qstage_proj_fused [wgmma]"
        if re.search(r"chain_kernel<false, \d+, \d+, false, true>", key)
        else
        "K7 qstage_fused [igemm]" if "qstage_kernel" in key else
        "K9 qivr_fused [igemm]" if "qivr_kernel" in key else
        "K7 qstage_fused [wgmma]" if "chain_kernel<false" in key else
        "K9 qivr_fused [wgmma]" if "chain_kernel<true" in key else
        "K4 qproj_fused [wgmma]" if "qproj_wg_kernel" in key else
        "K4 qproj_fused [igemm]" if "qproj_kernel" in key else
        "K5 qtail_fused [wgmma]" if "tail_wg_kernel<false" in key else
        "K6 qbottleneck_fused [wgmma]" if "tail_wg_kernel<true" in key else
        "K5 qtail_fused [igemm]" if "qtail_kernel" in key else
        "K6 qbottleneck_fused [igemm]" if "qblock_kernel" in key else
        "K2 qconv2d_fused [wgmma]" if "ConvX" in key else
        "K2 qconv2d_fused [stem]" if "stem_kernel" in key else
        "K2 qconv2d_fused [small]" if "small_kernel" in key else
        "K1 qmatmul_fused [wgmma_cp]" if "narrow_gemm_kernel" in key else
        "K1 int4 qmatmul_fused_w4 [wgmma]"
        if re.search(r"wgmma_gemm_kernel<\d+, \d+, true", key) else
        "K1 qmatmul_fused [wgmma]" if "wgmma_gemm_kernel" in key else
        "K1 int4 qmatmul_fused_w4 [igemm]" if "GemmLoader, true>" in key
        else
        "K1 qmatmul_fused [igemm]" if "GemmLoader" in key else
        "K2 qconv2d_fused [igemm]" if "ConvLoader" in key else
        "K3 qdepthwise_fused [halo]" if "dw_halo_kernel" in key else
        "K3 qdepthwise_fused [scalar]" if "dw_scalar_kernel" in key else
        None)


def step_family(key):
    """A training step's device kernel by family: the port's kernels,
    cuDNN's and cuBLAS's fp32 kernels (the statistics conv, the
    simulation's conv, the conv transposes, the fp32 layers), PyTorch's
    elementwise and reduction kernels (fake-quant, BatchNorm, the
    observers, AdamW), else the name."""
    fam = kernel_family(key)
    if fam:
        return fam
    low = key.lower()
    if any(t in low for t in ("cudnn", "xmma", "implicit_convolve",
                              "conv2d", "dgrad", "wgrad", "fprop")):
        return "cuDNN fp32 conv"
    if any(t in low for t in ("gemm", "cublas", "cutlass")):
        return "cuBLAS fp32 matmul"
    if "elementwise_kernel" in key:
        return "PyTorch elementwise"
    if "reduce_kernel" in key:
        return "PyTorch reduction"
    return key[:70]


def profile_step(what, state, x, y, torch):
    """Device time of one training step by kernel family (torch.profiler),
    the share of the step's wall time the card was busy, and the
    elementwise kernels by the PyTorch operation that launched them."""
    from torch.autograd import DeviceType

    from qtpu_torch.train import train_step

    averages, events, wall_ms = profiled(
        torch, lambda: train_step(state, x, y), True)
    fams = {}
    for e in averages:
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or e.key.startswith("ProfilerStep")):  # spans, not kernels
            continue
        fam = step_family(e.key)
        n, us = fams.get(fam, (0, 0.0))
        fams[fam] = (n + e.count, us + e.self_device_time_total)
    total = sum(us for _, us in fams.values())
    if not total:
        log(f"{what} profile: no device time reported (not measured)")
        return
    top = sorted(fams.items(), key=lambda kv: -kv[1][1])[:12]
    log(f"{what} profile B={len(y)}: device busy {total / 1e3:.3f} ms of "
        f"{wall_ms:.3f} ms wall (profiled); by family: " + "; ".join(
            f"{k} x{n} {us / 1e3:.3f} ms ({100 * us / total:.1f}%)"
            for k, (n, us) in top))
    ops = sorted(elementwise_by_op(events).items(), key=lambda kv: -kv[1][1])
    log(f"{what} profile: elementwise kernels by the operation that "
        "launched them: " + "; ".join(
            f"{op} {fam} ranks {list(ranks)} x{n} {us / 1e3:.3f} ms "
            f"({100 * us / total:.1f}%)"
            for (op, fam, ranks), (n, us, _) in ops[:15]))


def profile_forward(what, flat, x, torch, by_op=False):
    """Device time of one forward by kernel (torch.profiler), and the share
    of the forward's wall time the card was busy; with ``by_op`` also the
    elementwise kernels by the operation that launched them.  Returns the
    busy ms (None if the profiler reported no device time)."""
    from torch.autograd import DeviceType

    def by_family(averages):
        fams = {}
        for e in averages:
            if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                    or e.key.startswith("ProfilerStep")):  # spans
                continue
            fam = kernel_family(e.key) or e.key[:70]
            n, us = fams.get(fam, (0, 0.0))
            fams[fam] = (n + e.count, us + e.self_device_time_total)
        return fams

    # a trace on the card now and then loses the forward's first kernels
    # (once all of MobileNet-v2's fp32 stem, 1.6 of its 3.6 ms; PERF.md
    # §6): of two traces, the one with more device time is the whole
    body = eager_entry(flat)           # the eager forward's launches
    with torch.inference_mode():
        body(x)
        torch.cuda.synchronize()
        takes = []
        for _ in range(2):
            averages, events, wall_ms = profiled(
                torch, lambda: body(x), by_op)
            fams = by_family(averages)
            takes.append((sum(us for _, us in fams.values()), fams, events,
                          wall_ms))
    total, fams, events, wall_ms = max(takes, key=lambda t: t[0])
    if not total:
        log(f"{what} profile: no device time reported (not measured)")
        return None
    if min(t[0] for t in takes) < 0.95 * total:
        log(f"{what} profile: one of two traces held "
            f"{min(t[0] for t in takes) / 1e3:.3f} of {total / 1e3:.3f} ms "
            "of device time (kernels lost): the other kept")
    top = sorted(fams.items(), key=lambda kv: -kv[1][1])[:10]
    log(f"{what} profile B={x.shape[0]} forward: device busy "
        f"{total / 1e3:.3f} ms of {wall_ms:.3f} ms wall (profiled); by "
        "kernel: " + "; ".join(
            f"{k} x{n} {us / 1e3:.3f} ms ({100 * us / total:.1f}%)"
            for k, (n, us) in top))
    if by_op:
        ops = sorted(elementwise_by_op(events).items(), key=lambda kv:
                     -kv[1][1])
        log(f"{what} profile B={x.shape[0]}: elementwise kernels by the "
            "operation that launched them: " + "; ".join(
                f"{op} {fam} ranks {list(ranks)} x{n} {us / 1e3:.3f} ms "
                f"({100 * us / total:.1f}%), first inputs {shapes}"
                for (op, fam, ranks), (n, us, shapes) in ops))
    return total / 1e3


# -- 9. the tooling ------------------------------------------------------------------

PHASE9_STEPS = 10          # (a): traced forwards a table
# (a): each product engine's scopes (qtpu's names) and the launches of its
# kernels a forward, every one inside a scope
PHASE9_TRACED = {RN50: ({"K1": 37, "K2": 16, "K10": 1, "K11": 1},
                        ("stem", *(f"layer{i + 1}_{j}" for i, n in
                                   enumerate((3, 4, 6, 3)) for j in range(n)),
                         "head")),
                 MNV2: ({"K1": 35, "K3": 17, "K10": 1},
                        ("stem", *(f"block{i}" for i in range(17)), "head"))}
PHASE9_UNATTRIBUTED = 0.01  # (a): the largest share of device time outside
PHASE9_BUSY = 0.05          # (a): the scopes' sum against phase 6's busy
PHASE9_FIT = 0.03           # (b): time_scan_fit against phase 6's graph
# (b): the chains' lengths; 20 forwards apart, so the slope's noise stays
# inside PHASE9_FIT of a 5 ms forward (chains of 3 and 13 read +3.4% once)
PHASE9_CHAINS = (5, 25)


def phase9(dev, work, card, torch, engines, graph_ms, busy_ms):
    """The tooling of ``qtpu_torch.bench`` on the card: (a) the per-layer
    tables of the ResNet-50 and MobileNet-v2 product engines at B = 128;
    (b) ``time_scan_fit`` of the ResNet-50 B = 128 forward against phase
    6's graph time; (c) ``dp_scaling`` of the ResNet-50 forward at B = 32 a
    rank; (d) the projection of phase 8's TP = 2 collectives with the
    TP = 1 graph time at B = 32; (e) the rows of (a)-(c) as receipts under
    ``work``, read back; and the eager B = 8 forward with and without a
    trace running (the scopes' host cost)."""
    import collections

    from qtpu_torch.bench.receipts import log_receipt
    from qtpu_torch.bench.scaling import dp_scaling
    from qtpu_torch.bench.scaling_projection import project
    from qtpu_torch.bench.timing import time_scan_fit
    from qtpu_torch.bench.tracing import (UNATTRIBUTED, capture_trace,
                                          format_table, layer_table,
                                          parse_trace)

    receipts = os.path.join(work, "receipts", "phase9.jsonl")
    if os.path.exists(receipts):
        os.remove(receipts)
    logged = 0

    def receipt(rec):
        nonlocal logged
        log_receipt("phase9", dict(rec, device=card), path=receipts)
        logged += 1

    g = torch.Generator().manual_seed(9)
    rn50 = engines[RN50]
    # (a) the per-layer tables
    for what, flat in engines.items():
        want, scopes = PHASE9_TRACED[what]
        x = torch.randn((128, 224, 224, 3), generator=g).to(dev)
        t0 = time.monotonic()
        # the eager body: a replayed graph runs none of the scopes
        path = capture_trace(flat.eager_forward, x, steps=PHASE9_STEPS,
                             logdir=TRACE_DIR)
        records = parse_trace(path)
        rows = layer_table(records, PHASE9_STEPS)
        secs = time.monotonic() - t0
        log(format_table(rows, title=(
            f"phase 9 (a) {what} product engine B=128, per layer over "
            f"{PHASE9_STEPS} traced forwards, {card} ({secs:.1f} s)")))
        got = {r["scope"] for r in rows} - {UNATTRIBUTED}
        check(got == set(scopes), f"{what}: traced scopes {sorted(got)}, "
              f"expected qtpu's {list(scopes)}")
        by_scope = collections.defaultdict(collections.Counter)
        for r in records:
            fam = kernel_family(r.name) if r.category == "kernel" else None
            if fam and fam.split()[0] in want:
                by_scope[r.scope or UNATTRIBUTED][fam.split()[0]] += 1
        check(UNATTRIBUTED not in by_scope, f"{what}: kernels outside every "
              f"scope: {dict(by_scope.get(UNATTRIBUTED, {}))}")
        total = {k: sum(c[k] for c in by_scope.values()) for k in want}
        check(total == {k: n * PHASE9_STEPS for k, n in want.items()},
              f"{what}: traced launches {total} over {PHASE9_STEPS} "
              f"forwards, expected {want} a forward")
        all_us = sum(r["us"] for r in rows)
        un_us = sum(r["us"] for r in rows if r["scope"] == UNATTRIBUTED)
        scoped_ms = (all_us - un_us) / 1e3
        busy = busy_ms.get((what, 128))
        check(un_us <= PHASE9_UNATTRIBUTED * all_us,
              f"{what}: {un_us:.1f} of {all_us:.1f} us a forward outside "
              "every scope")
        check(busy is not None and abs(scoped_ms - busy)
              <= PHASE9_BUSY * busy, f"{what}: the scopes sum to "
              f"{scoped_ms:.3f} ms a forward, phase 6 profiled {busy} ms")
        ops = sum(r.ops + r.cuda_core_ops for r in records) / PHASE9_STEPS
        log(f"  {what}: kernels a forward by scope "
            + "; ".join(f"{s} " + " ".join(f"{k} x{n // PHASE9_STEPS}"
                                          for k, n in sorted(c.items()))
                        for s, c in by_scope.items())
            + f"; unattributed {un_us:.1f} us of {all_us:.1f} "
            f"({100 * un_us / all_us:.2f}%); scopes {scoped_ms:.3f} ms "
            f"against phase 6's profiled busy {busy:.3f} ms; the kernels' "
            f"noted work {ops / 128 / 1e9:.3f} GOP an image")
        for r in rows:
            receipt(dict(phase="9a", engine=what, batch=128,
                         steps=PHASE9_STEPS, **r))
        del x
        torch.cuda.empty_cache()

    # (b) the slope fit against phase 6's graph time
    x = torch.randn((128, 224, 224, 3), generator=g).to(dev)
    with torch.inference_mode():
        fit_ms = 1e3 * time_scan_fit(
            lambda c: c + 0.0 * rn50.eager_forward(c).sum(), x,
            n_short=PHASE9_CHAINS[0], n_long=PHASE9_CHAINS[1])
    ref = graph_ms[RN50, 128]
    log(f"phase 9 (b) {RN50} B=128: time_scan_fit {fit_ms:.3f} ms a "
        f"forward (chains of {PHASE9_CHAINS[0]} and {PHASE9_CHAINS[1]}, "
        "each one CUDA graph; the carry add "
        f"included), phase 6's graph {ref:.3f} ms ({card})")
    check(abs(fit_ms - ref) <= PHASE9_FIT * ref, f"time_scan_fit "
          f"{fit_ms:.3f} ms against phase 6's {ref:.3f} ms")
    receipt(dict(phase="9b", engine=RN50, batch=128, fit_ms=fit_ms,
                 graph_ms=ref))
    del x
    torch.cuda.empty_cache()

    # (c) DP scaling: dp = 1 on one card, dp = 2 only with two
    cards = torch.cuda.device_count()
    dps = (1, 2) if cards >= 2 else (1,)
    dp_dir = os.path.join(work, "phase9_dp")
    shutil.rmtree(dp_dir, ignore_errors=True)
    os.makedirs(dp_dir)
    t0 = time.monotonic()
    sc = dp_scaling("qtpu_torch.bench.scaling:factory_forward",
                    (224, 224, 3), dps=dps, batch_per_device=32,
                    factory_kwargs=dict(
                        config=RN50,
                        load_frozen=os.path.join(work, "frozen_rn50")),
                    device="cuda", n_short=3, n_long=13, timeout_s=300,
                    workdir=dp_dir)
    check(all(v > 0 for v in sc["images_per_sec"].values()),
          f"dp_scaling: {sc}")
    log(f"phase 9 (c) dp_scaling {RN50} B=32 a rank ({card}; "
        f"{time.monotonic() - t0:.1f} s): " + "; ".join(
            f"dp = {dp}: {sc['images_per_sec'][dp]:.1f} img/s, efficiency "
            f"{sc['efficiency_vs_linear'][dp]:.3f}" for dp in dps)
        + ("" if cards >= 2 else "; dp = 2: one card: not measured"))
    for dp in dps:
        receipt(dict(phase="9c", engine=RN50, batch_per_device=32, dp=dp,
                     images_per_sec=sc["images_per_sec"][dp],
                     efficiency_vs_linear=sc["efficiency_vs_linear"][dp]))

    # (d) the projection of phase 8's TP = 2 forward
    with open(os.path.join(work, "phase8_rank0.json")) as f:
        tp = json.load(f)["tp_records"]
    check(len(tp["records"]) == tp["calls"], f"phase 8 recorded "
          f"{len(tp['records'])} collectives of {tp['calls']} calls")
    x = torch.randn((tp["batch"], 224, 224, 3), generator=g).to(dev)
    with torch.inference_mode():
        t1_ms = timed(lambda: rn50.eager_forward(x), 5)
    proj = project(t1_ms / 1e3, tp["records"], tp["tp"], tp=tp["tp"])
    log(f"phase 9 (d) projection of the TP = {tp['tp']} B = {tp['batch']} "
        f"{RN50} forward ({len(tp['records'])} collectives, "
        + ", ".join(f"{k} x{n}" for k, n in collections.Counter(
            r["kind"] for r in tp["records"]).items())
        + f") with the TP = 1 graph time {t1_ms:.3f} ms ({card}; NVLink "
        f"450 GB/s each way, alpha 1 — a model): {json.dumps(proj)}")

    # the scopes' host cost: the eager B = 8 forward as served, without and
    # with a trace running
    x = torch.randn((8, 224, 224, 3), generator=g).to(dev)
    with torch.inference_mode():
        plain_ms = timed_eager(lambda: rn50.eager_forward(x), 20)
        with trace(TRACE_DIR, "cuda"):
            traced_ms = timed_eager(lambda: rn50.eager_forward(x), 20)
    log(f"phase 9 {RN50} eager B=8 forward ({card}): {plain_ms:.3f} ms "
        f"without a trace (the scopes null contexts), {traced_ms:.3f} ms "
        "with one running (the profiler and the scopes recording)")

    # (e) the receipts, read back
    with open(receipts) as f:
        back = [json.loads(line) for line in f]
    check(len(back) == logged and all(r["device"] == card and r["ts"]
                                      for r in back),
          f"receipts: {len(back)} lines read back, {logged} logged")
    log(f"phase 9 (e) receipts: {logged} rows of (a)-(c) appended to "
        f"{os.path.relpath(receipts, ROOT)} and read back")


# -- 8. the parallel runtime: two ranks on the one card ------------------------------

PHASE8_RANKS = 2
PHASE8_TIMEOUT_S = 400     # the world's deadline: both ranks killed past it
PHASE8_BACKEND = "gloo"    # NCCL refuses two ranks on one card
PHASE8_QAT_B = 16          # (e): the global batch, 8 a rank
PHASE8_TIMED = 5           # (a): eager forwards timed at B = 32


def phase8(dev, work, card, torch):
    """Start the two ranks (``phase8_rank``) with the frozen ResNet-50 and
    MobileNet-v2 trees saved under ``work``, wait for both, check and print
    what they measured.  Either rank failing fails the phase; the ranks are
    killed on any failure and past ``PHASE8_TIMEOUT_S``."""
    import numpy as np

    from qtpu_torch.parallel.launch import run_world

    rdzv = os.path.join(work, "phase8_rdzv")
    for f in os.listdir(work):
        if f.startswith("phase8_"):
            os.remove(os.path.join(work, f))
    t0 = time.monotonic()
    res = run_world([sys.executable, os.path.abspath(__file__),
                     "--phase8-rank", work], PHASE8_RANKS, rdzv,
                    timeout_s=PHASE8_TIMEOUT_S, backend=PHASE8_BACKEND,
                    cwd=ROOT)
    wall = time.monotonic() - t0
    for r in res:
        for line in r.output.splitlines():
            if line.startswith("phase8 "):
                log(f"rank {r.rank}: {line[7:]}")
        check(r.returncode == 0, f"phase 8 rank {r.rank} exited "
              f"{r.returncode}:\n{r.output[-8000:]}")
    out = []
    for r in range(PHASE8_RANKS):
        with open(os.path.join(work, f"phase8_rank{r}.json")) as f:
            out.append(json.load(f))
    for r, o in enumerate(out):
        check(o["backend"] == PHASE8_BACKEND and o["world"] == PHASE8_RANKS,
              f"rank {r}: backend {o['backend']}, world {o['world']}")
        for what, t in o["tp"].items():
            check(t["equal"], f"rank {r} {what}: TP = 2 codes or logits "
                  f"differ from TP = 1 ({t['differ']})")
            check(t["plain"] == 0, f"rank {r} {what}: plain versions ran")
            check(t["per_forward"] == t["want"], f"rank {r} {what}: launches "
                  f"{t['per_forward']}, expected {t['want']}")
            check(t["graphs"] == 0, f"rank {r} {what}: the TP = 2 engine's "
                  f"forward captured {t['graphs']} graphs (a sliced tree "
                  "runs eagerly)")
        check(o["dp"]["own_rows_equal"], f"rank {r}: DP rows differ")
        check(o["dp"]["images"] == o["dp"]["served"], f"rank {r}: served "
              f"{o['dp']['images']} images, submitted {o['dp']['served']}")
        for what, ok in o["spatial"]["equal"].items():
            check(ok, f"rank {r} spatial {what}: differs from unsharded")
        check(o["spatial"]["plain"] == 0, f"rank {r}: spatial ran plain")
        check(o["pipeline"]["equal"], f"rank {r}: pipeline differs")
    check(out[1]["dp"]["idle_rounds"] >= 1, "DP serving: rank 1 was never "
          "idle in a round")
    check(out[0]["dp"]["rounds"] == out[1]["dp"]["rounds"],
          "DP serving: the ranks ran different rounds")
    q = out[0]["qat"]
    check(q["replicated"], "DP QAT: the ranks' states differ")
    check(all(np.isfinite(v) for v in (q["loss_dp"], q["loss_single"])),
          f"DP QAT: loss not finite {q}")
    strict = (q["loss_rel"] <= 1e-4 and q["param_off"] == 0
              and q["observer_off"] == 0)
    if not strict:
        # codes at ties move the free-running step: held as phase 5 holds
        # a whole-network QAT step — the loss within rtol 5e-2 — and
        # teacher-forced: the single step's batch statistics replayed in
        # the DP step (the values; the gradient through the DP step's own)
        check(q["loss_rel"] <= 5e-2, f"DP QAT: loss rel {q['loss_rel']}")
        t = q["forced"]
        check(t["loss_rel"] <= 1e-4 and t["observer_off"] == 0
              and t["param_off"] <= max(2, 1e-3 * t["params"])
              and t["param_worst_abs"] <= 2 * q["lr"] * 1.01,
              f"DP QAT teacher-forced outside its bounds: {t}")
    log(f"phase 8 ({PHASE8_RANKS} ranks, backend {PHASE8_BACKEND}, both on "
        f"{out[0]['device']}; {card}): world {wall:.1f} s (rank 0's "
        f"sections: {out[0]['seconds']})")
    for r, o in enumerate(out):
        for what, t in o["tp"].items():
            log(f"  (a) rank {r} {what} TP = 2: codes after every step and "
                f"logits bit-equal to TP = 1 ({t['steps']} steps); per "
                f"forward {t['per_forward']} by route {t['routes']}, plain "
                f"0; all-gathers {t['all_gathers']} a forward "
                f"({t['staged']} staged on the host: gloo takes host "
                f"tensors); sharded nodes {t['sharded']}")
    for r, o in enumerate(out):
        log(f"  rank {r}: collectives staged through the host (gloo takes "
            f"host tensors; the compute stays on the card): the TP forward "
            f"all_gather ({o['tp']['ResNet-50 B=8']['staged']} a ResNet-50 "
            "forward), " + "; ".join(
                f"{what} " + (", ".join(f"{k} {v}" for k, v in c.items())
                              or "none")
                for what, c in o["staged"].items()))
    ta = out[0]["timing"]
    log(f"  (a) ResNet-50 B = 32 eager wall, {PHASE8_TIMED} forwards after "
        f"a warm one ({card}): TP = 2 (both ranks on the one card, gloo) "
        f"{ta['tp2_ms']:.3f} ms, TP = 1 (rank 0 alone) {ta['tp1_ms']:.3f} "
        f"ms; the all-gathers {ta['gather_ms']:.3f} ms of a "
        f"{ta['gather_fwd_ms']:.3f} ms synchronised forward "
        f"({100 * ta['gather_ms'] / ta['gather_fwd_ms']:.1f}%)")
    for r, o in enumerate(out):
        d = o["dp"]
        log(f"  (b) rank {r} DP = 2 lockstep serving (round_timeout_s "
            f"{d['round_timeout_s']}): {d['served']} own requests, rounds "
            f"{d['rounds']}, {d['idle_rounds']} idle; own rows bit-equal to "
            f"the single-process forward")
        s = o["spatial"]
        log(f"  (c) rank {r} spatial sp = 2: {', '.join(s['equal'])} equal "
            f"to the unsharded K2 raw / pool; the sharded calls' K2 "
            f"launches by route {s['routes']}, plain 0; halo exchanges "
            f"{s['ppermute']}")
        log(f"  (d) rank {r} pipeline: 2 stages (layer3_1, layer3_2) x 4 "
            f"microbatches equal to the blocks in sequence; sends "
            f"{o['pipeline']['ppermute']}")
    log(f"  (e) DP = 2 QAT step ({CFG5}, integer forward, B = "
        f"{PHASE8_QAT_B}, 8 a rank) against the single-process step: loss "
        f"{q['loss_dp']:.7f} vs {q['loss_single']:.7f} (rel "
        f"{q['loss_rel']:.2e}); parameters off rtol 2e-4 / atol 2e-5: "
        f"{q['param_off']} of {q['params']} (worst abs {q['param_worst_abs']:.2e}); "
        f"observers off: {q['observer_off']}; "
        + ("held strictly" if strict else
           f"codes at ties move it, held as phase 5 holds; teacher-forced "
           f"(the single step's batch statistics replayed): loss rel "
           f"{q['forced']['loss_rel']:.2e}, parameters off "
           f"{q['forced']['param_off']} (worst abs "
           f"{q['forced']['param_worst_abs']:.2e}), observers off "
           f"{q['forced']['observer_off']}"))


def phase8_rank(work):
    """One rank of phase 8 (module docstring); writes its results to
    ``work/phase8_rank<r>.json``."""
    import copy

    import numpy as np
    import torch
    import torch.distributed as dist

    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.nn import layers as qlayers
    from qtpu_torch.ops import qconv as k2
    from qtpu_torch.ops import qdepthwise as k3
    from qtpu_torch.ops import qmatmul as k1
    from qtpu_torch.ops import qops
    from qtpu_torch.parallel import (collectives, distributed,
                                     make_mesh, make_pipeline_mesh,
                                     make_spatial_mesh, pipeline_apply,
                                     shard_variables, spatial_conv2d,
                                     spatial_max_pool, stage_local)
    from qtpu_torch.parallel.mesh import sharded_nodes
    from qtpu_torch.serve.cli import build_model
    from qtpu_torch.serve.dispatch import resnet_arch
    from qtpu_torch.serve.engine import ServingEngine
    from qtpu_torch.serve.fused_ops import grid_of
    from qtpu_torch.serve.mobilenet_engine import MobileNetV2Int8Engine
    from qtpu_torch.serve.resnet_engine import ResNetInt8Engine, maxpool_codes
    from qtpu_torch.train import create_train_state, train_step
    from qtpu_torch.transform import convert_model
    from qtpu_torch.utils import checkpoint as ckpt

    distributed.initialize_from_env(backend=PHASE8_BACKEND)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = distributed.rank_device()
    sync = dist.new_group(backend="gloo")
    seconds, t_sec = {}, [time.monotonic()]

    def section(name):
        now = time.monotonic()
        seconds[name] = round(now - t_sec[0], 1)
        t_sec[0] = now

    kernels = {"K1": (k1.qmatmul_folded, ("wgmma", "wgmma_cp", "igemm")),
               "K2": (k2.qconv2d_folded, ("wgmma", "stem", "small",
                                          "igemm")),
               "K3": (k3.qdepthwise_folded, ("halo", "scalar"))}
    plains = (k1.qmatmul_folded_plain, k2.qconv2d_folded_plain,
              k3.qdepthwise_folded_plain)

    def zero():
        for fn, routes in kernels.values():
            fn.launches = 0
            for r in routes:
                setattr(fn, f"launches_{r}", 0)
        for p in plains:
            p.calls = 0
        collectives.reset_counts()

    def launches():
        return ({k: fn.launches for k, (fn, _) in kernels.items()},
                {k: {r: getattr(fn, f"launches_{r}") for r in routes}
                 for k, (fn, routes) in kernels.items()},
                sum(p.calls for p in plains))

    def staged_by_name():
        """The collectives staged through the host since the last reset,
        by name (gloo's collectives take host tensors)."""
        return {k.split(".")[0]: v for k, v in collectives.counts.items()
                if k.endswith(".host_staged")}

    out = {"backend": dist.get_backend(), "world": world, "device": str(dev),
           "staged": {}}

    # (a) TP = 2 forwards: codes after every step and logits against TP = 1
    rn_tree = ckpt.load(os.path.join(work, "frozen_rn50"), device=dev)
    mn_tree = ckpt.load(os.path.join(work, "frozen_mnv2"), device=dev)
    tp_mesh = make_mesh(dp=1, tp=world)
    cfg = CONFIGS[RN50]
    arch = resnet_arch(cfg.model, num_classes=cfg.num_classes,
                       image_size=cfg.image_size, width=cfg.width,
                       cifar_stem=cfg.cifar_stem)
    engines = {
        "ResNet-50": (ResNetInt8Engine(rn_tree, arch, device=dev),
                      ResNetInt8Engine(shard_variables(rn_tree, tp_mesh),
                                       arch, device=dev),
                      (8, 32), {"K1": 37, "K2": 16, "K3": 0}, rn_tree),
        "MobileNet-v2": (MobileNetV2Int8Engine(mn_tree, num_classes=1000,
                                               device=dev),
                         MobileNetV2Int8Engine(
                             shard_variables(mn_tree, tp_mesh),
                             num_classes=1000, device=dev),
                         (8,), {"K1": 35, "K2": 0, "K3": 17}, mn_tree)}

    def first_grid(eng):
        if isinstance(eng, MobileNetV2Int8Engine):
            return eng._block_in_grid(eng._blocks()[0][0])
        return grid_of(eng._node(eng._block_names()[0][0], "conv1"))

    def walk(eng, x):
        """The codes after the stem and every step of the plan, then the
        logits."""
        g = first_grid(eng)
        codes = [eng._stem(x, g)]
        for step in eng._plan():
            y, g = eng._step(codes[-1], g, step)
            codes.append(y)
        return codes, eng.eager_forward(x)

    out["tp"] = {}
    with torch.inference_mode():
        for what, (ref, tp, batches, want, tree) in engines.items():
            for B in batches:
                x = torch.from_numpy(np.random.default_rng(B).standard_normal(
                    (B, 224, 224, 3)).astype(np.float32)).to(dev)
                tp.forward(x)                               # warm
                zero()
                y = tp.forward(x)
                torch.cuda.synchronize()
                per_fwd, routes, plain = launches()
                gathers = collectives.counts["all_gather"]
                staged = collectives.counts["all_gather.host_staged"]
                c_ref, y_ref = walk(ref, x)
                c_tp, y_tp = walk(tp, x)
                differ = [i for i, (a, b) in enumerate(zip(c_ref, c_tp))
                          if not torch.equal(a, b)]
                out["tp"][f"{what} B={B}"] = dict(
                    graphs=len(tp.graphs) + len(ref.graphs),
                    equal=not differ and torch.equal(y, y_ref)
                    and torch.equal(y_tp, y_ref), differ=differ,
                    steps=len(c_ref), per_forward=per_fwd, routes=routes,
                    plain=plain, want=want, all_gathers=gathers,
                    staged=staged, sharded=sharded_nodes(
                        shard_variables(tree, tp_mesh)["qweights"]))
        # eager wall of the B = 32 ResNet-50 forward: TP = 2 on both ranks,
        # TP = 1 on rank 0 alone, and the all-gathers' share
        ref, tp = engines["ResNet-50"][:2]
        x = torch.from_numpy(np.random.default_rng(32).standard_normal(
            (32, 224, 224, 3)).astype(np.float32)).to(dev)

        def wall_ms(fn):
            fn()
            torch.cuda.synchronize()
            dist.barrier(group=sync)
            t0 = time.perf_counter()
            for _ in range(PHASE8_TIMED):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / PHASE8_TIMED

        timing = {"tp2_ms": wall_ms(lambda: tp.forward(x))}
        if rank == 0:
            timing["tp1_ms"] = wall_ms(lambda: ref.eager_forward(x))
        else:
            dist.barrier(group=sync)
        dist.barrier(group=sync)
        gather, spent = collectives.all_gather, [0.0]

        def timed_gather(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = gather(*a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return y

        collectives.all_gather = timed_gather
        try:
            tp.forward(x)
            torch.cuda.synchronize()
            dist.barrier(group=sync)
            spent[0] = 0.0
            t0 = time.perf_counter()
            for _ in range(PHASE8_TIMED):
                tp.forward(x)
            torch.cuda.synchronize()
            timing["gather_fwd_ms"] = ((time.perf_counter() - t0) * 1e3
                                       / PHASE8_TIMED)
            timing["gather_ms"] = spent[0] * 1e3 / PHASE8_TIMED
        finally:
            collectives.all_gather = gather
        out["timing"] = timing
        # the collectives of one B = 32 TP forward, for phase 9's projection
        collectives.reset_counts()
        with collectives.recording() as records:
            tp.forward(x)
        torch.cuda.synchronize()
        out["tp_records"] = dict(tp=world, batch=32, config=RN50,
                                 records=records,
                                 calls=sum(v for k, v in
                                           collectives.counts.items()
                                           if "." not in k))
    section("tp")

    # (b) DP = 2 lockstep serving: own requests, an idle round on rank 1
    dp_mesh = make_mesh(dp=world, tp=1)
    eng = ServingEngine(None, rn_tree, mesh=dp_mesh, batch_buckets=(8, 32),
                        max_wait_ms=20.0, round_timeout_s=60.0, device=dev,
                        forward_factory=lambda sv: ResNetInt8Engine(
                            sv, arch, device=dev).eager_forward)
    eng.warmup((224, 224, 3))
    imgs = np.random.default_rng(100 + rank).standard_normal(
        (7, 224, 224, 3)).astype(np.float32)
    first = eng.predict(imgs[:3 + rank])           # both ranks: 3 and 4
    dist.barrier(group=sync)
    second = eng.predict(imgs[3 + rank:]) if rank == 0 else imgs[:0]
    dist.barrier(group=sync)
    eng.stop()
    st = eng.stats()
    served = np.concatenate([first, second]) if len(second) else first
    mine = imgs[:len(served)]
    with torch.inference_mode():
        direct = ref.eager_forward(torch.from_numpy(mine).to(dev)).cpu(
        ).numpy()
    out["dp"] = dict(own_rows_equal=bool(np.array_equal(served, direct)),
                     served=len(served), rounds=st["rounds_per_bucket"],
                     idle_rounds=st["idle_rounds"], images=st["images"],
                     round_timeout_s=60.0)
    section("dp")

    # (c) spatial_conv2d / spatial_max_pool at sp = 2 on K2's raw entry
    sp = make_spatial_mesh(sp=world)
    g = torch.Generator().manual_seed(8)

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=g,
                             dtype=torch.int8).to(dev)

    h = rank
    stem_x, stem_w = i8(2, 224, 224, 3), i8(7, 7, 3, 64)
    l1_x, l1_w = i8(2, 56, 56, 64), i8(3, 3, 64, 64)
    equal = {}
    with torch.inference_mode():
        def whole(x, w, s, zp):
            w_nk = w.reshape(-1, w.shape[-1]).t().contiguous()
            pads = qops.same_pads(x.shape[1:3], w.shape[:2], (s, s))
            return k2.qconv2d_folded(
                x, w_nk, None, None, kernel_hw=tuple(w.shape[:2]), stride=s,
                pads=pads, zp=zp, tapsum=k2.tapsum_of(w_nk, w.shape[:2]),
                raw_acc=True)

        def rows(t):
            n = t.shape[1] // world
            return t[:, h * n:(h + 1) * n].contiguous()

        def requant(acc):
            return torch.clamp(torch.div(acc, 512, rounding_mode="floor"),
                               -128, 127).to(torch.int8)

        full_stem = whole(stem_x, stem_w, 2, -3)
        full_codes = requant(full_stem)
        full_pool = maxpool_codes(full_codes, qops.same_pads(
            full_codes.shape[1:3], (3, 3), (2, 2)))
        full_l1 = whole(l1_x, l1_w, 1, 11)
        zero()                      # the sharded calls' launches alone
        acc = spatial_conv2d(rows(stem_x), stem_w, sp, strides=(2, 2), zp=-3)
        equal["7x7/2 stem"] = bool(torch.equal(acc, rows(full_stem)))
        pooled = spatial_max_pool(requant(acc), sp)
        equal["3x3/2 max-pool"] = bool(torch.equal(pooled, rows(full_pool)))
        acc = spatial_conv2d(rows(l1_x), l1_w, sp, zp=11)
        equal["layer1 3x3"] = bool(torch.equal(acc, rows(full_l1)))
        torch.cuda.synchronize()
    _, routes, plain = launches()
    out["staged"]["spatial"] = staged_by_name()
    out["spatial"] = dict(equal=equal, routes=routes["K2"], plain=plain,
                          ppermute=collectives.counts["ppermute"])
    section("spatial")

    # (d) pipeline_apply: layer3's identity blocks 1 and 2 as two stages
    pipe = make_pipeline_mesh(world)
    names = [n for n, i, j in ref._block_names() if i == 2][1:1 + world]
    grids = [grid_of(ref._node(n, "conv1")) for n in names] + [
        ref._next_grid([n for n, _, _ in ref._block_names()].index(
            names[-1]))]

    def stage(i, x):
        i = int(i)
        return ref._bottleneck(x, grids[i], names[i], (1, 1), grids[i + 1])

    micro = i8(4, 2, 14, 14, 1024)
    collectives.reset_counts()
    with torch.inference_mode():
        got = pipeline_apply(stage, stage_local(torch.arange(world), pipe),
                             micro, pipe)
        want = torch.stack([stage(1, stage(0, m)) for m in micro])
    out["staged"]["pipeline"] = staged_by_name()
    out["pipeline"] = dict(equal=bool(torch.equal(got, want)),
                           ppermute=collectives.counts["ppermute"])
    section("pipeline")

    # (e) one DP = 2 integer-forward QAT step of config 5 at full width
    qcfg = CONFIGS[CFG5]
    policy = dataclasses.replace(qcfg.policy(), qat_forward="int")
    rs = np.random.default_rng(16)
    xb = rs.standard_normal((PHASE8_QAT_B, 224, 224, 3)).astype(np.float32)
    yb = rs.integers(0, qcfg.num_classes, PHASE8_QAT_B)
    fresh = convert_model(build_model(qcfg, seed=0, device=dev), policy)
    batch_stats = qlayers._batch_stats

    def step(model, mesh, stats=None, record=None):
        """One step; ``record`` collects the batch statistics, ``stats``
        replays them (the values; the gradient through this step's own)."""
        it = iter(stats or ())

        def hooked(y):
            m, v = batch_stats(y)
            if record is not None:
                record.append((m.detach().clone(), v.detach().clone()))
            if stats is not None:
                rm, rv = next(it)
                m, v = m + (rm - m).detach(), v + (rv - v).detach()
            return m, v

        qlayers._batch_stats = hooked
        try:
            st = create_train_state(model, qcfg.qat_lr)
            loss = float(train_step(st, xb, yb, mesh=mesh)["loss"])
        finally:
            qlayers._batch_stats = batch_stats
        torch.cuda.synchronize()
        return loss, model

    single_stats = []
    collectives.reset_counts()
    if rank == 0:
        loss_s, single = step(copy.deepcopy(fresh), None,
                              record=single_stats)
    obj = [[(m.cpu(), v.cpu()) for m, v in single_stats]]
    dist.broadcast_object_list(obj, src=0, group=sync)
    stats = [(m.to(dev), v.to(dev)) for m, v in obj[0]]
    loss_d, dp_model = step(copy.deepcopy(fresh), dp_mesh)
    loss_f, forced = step(copy.deepcopy(fresh), dp_mesh, stats=stats)
    digest = torch.stack([p.detach().double().sum()
                          for p in dp_model.parameters()]).cpu()
    digests = [torch.empty_like(digest) for _ in range(world)]
    dist.all_gather(digests, digest, group=sync)

    def compare(a, b):
        """(params off rtol 2e-4 / atol 2e-5, their count, worst abs, the
        observer buffers off)."""
        off = n = 0
        worst = 0.0
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            d = (p.detach() - q.detach()).abs()
            off += int((d > 2e-5 + 2e-4 * q.detach().abs()).sum())
            n += p.numel()
            worst = max(worst, float(d.max()))
        obs = 0
        for (name, x), y in zip(a.named_buffers(), b.buffers()):
            if ".in_q." in f".{name}" and x.is_floating_point():
                obs += int(((x - y).abs() > 2e-5 + 2e-4 * y.abs()).sum())
            elif ".in_q." in f".{name}":
                obs += int((x != y).sum())
        return off, n, worst, obs

    if rank == 0:
        off, n, worst, obs = compare(dp_model, single)
        foff, _, fworst, fobs = compare(forced, single)
        out["qat"] = dict(
            loss_dp=loss_d, loss_single=loss_s,
            loss_rel=abs(loss_d - loss_s) / abs(loss_s), param_off=off,
            params=n, param_worst_abs=worst, observer_off=obs,
            lr=qcfg.qat_lr,
            replicated=all(torch.equal(d, digests[0]) for d in digests),
            forced=dict(loss_rel=abs(loss_f - loss_s) / abs(loss_s),
                        param_off=foff, params=n, param_worst_abs=fworst,
                        observer_off=fobs))
    out["staged"]["qat"] = staged_by_name()
    section("qat")
    out["seconds"] = seconds
    with open(os.path.join(work, f"phase8_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"phase8 done in {sum(seconds.values()):.1f} s: {seconds}",
          flush=True)
    dist.barrier(group=sync)
    return 0


def sqrt_rounding(torch, dev):
    """C22's cause, measured: fp32 ``torch.sqrt`` and the port's
    ``utils.numerics.sqrt_rn`` (its BatchNorm fold's) on the CPU and on the
    card against the correctly rounded root (float64, rounded once) on 10M
    uniform inputs in [1e-5, 4); ``sqrt_rn`` must be off on none."""
    from qtpu_torch.utils.numerics import sqrt_rn

    x = torch.rand(10_000_000, generator=torch.Generator().manual_seed(0)
                   ) * 4 + 1e-5
    exact = torch.sqrt(x.double()).float()
    off = {f"{name} {where}": int((fn(x.to(d)).cpu() != exact).sum())
           for name, fn in (("torch.sqrt", torch.sqrt), ("sqrt_rn", sqrt_rn))
           for where, d in (("CPU", "cpu"), ("card", dev))}
    log(f"fp32 square roots against the correctly rounded root on "
        f"{x.numel()} uniform inputs in [1e-5, 4), off by an ulp (CPU "
        f"capability {torch.backends.cpu.get_cpu_capability()}): {off}")
    check(off["sqrt_rn CPU"] == 0 and off["sqrt_rn card"] == 0,
          f"sqrt_rn is not correctly rounded: {off}")
    return off


def qat_check(n: int) -> int:
    """``python3 chip_smoke.py --qat-check N``: phase 5's teacher-forced QAT
    check of config 3 run N times (the B = 2 batch from seeds 7, 8, ...) on
    one model trained as phase 4 trains it, each run's diagnostics logged;
    exit 1 if any run fails the check."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from qtpu_torch.examples.configs import CONFIGS
    from qtpu_torch.examples.run import experiment
    from qtpu_torch.ops import _build

    dev = torch.device("cuda")
    log(device_label(dev))
    _build.build()
    qcfg = dataclasses.replace(CONFIGS[QAT_RUNS["qat_cfg3"]], **QAT_CUT)
    qex = experiment(qcfg, seed=0, verbose=False, device=dev)
    failed = 0
    try:
        sqrt_rounding(torch, dev)
    except SmokeFailure as e:
        failed += 1
        log(f"sqrt_rounding FAILED: {e}")
    n_tie = 0
    for i in range(n):
        try:
            ties = qat_step_vs_cpu(f"{qcfg.name} check {i}", qex.model,
                                   qcfg.policy(), torch, seed=7 + i)
            n_tie += sum(t for t, _ in ties.values())
        except SmokeFailure as e:
            failed += 1
            log(f"check {i} FAILED: {e}")
    log(f"{qcfg.name}: {n - failed} of {n} teacher-forced checks passed; "
        f"weight codes across a tie from BatchNorm's fold (C22), all "
        f"checks: {n_tie}")
    return int(failed > 0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase8-rank"]:
        sys.exit(phase8_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--qat-check"]:
        sys.exit(qat_check(int(sys.argv[2])))
    if sys.argv[1:2] == ["--cold-hist"]:
        sys.exit(cold_hist(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
