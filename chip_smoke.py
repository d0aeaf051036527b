#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card)::

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``backscrub_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source);
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the committed synthetic segm_lite-shaped model at
   640x480 and 1280x720): K3 (blend + YUYV pack) byte-identical, K1
   (front) and K2 (body, the persistent ``bs_body_mega``: one launch, its
   phase count printed, two runs bit-identical) within allclose(atol=2e-3,
   rtol=1e-3); times each with CUDA events and as device time (the
   profiler's kernel time), K2 also as one event pair around 100
   back-to-back runs; the barrier microbenchmark
   (a cooperative grid sync and a cluster sync, microseconds each);
4. runs ``FramePipeline`` for 50 frames of a seeded moving sequence at
   640x480 and 1280x720 on ``cuda``, checks that every kernel's launch
   counter rose as the path requires (``bs_body_mega`` once a frame, no
   other body kernel), and holds YUYV and mask against the
   port's plain path on the card under the repo's tolerance invariant (at
   most 2% of a frame's bytes differ, at most 0.2% over the sequence);
5. the deeplab path on the committed synthetic deeplabv3_257-shaped model
   at 640x480: K1 at the 257x257 canvas, K2' (the prefix plan) and K2''
   (the flat continuation plan), each one ``bs_body_mega`` launch a run
   over its op table (table ops and phases printed, two runs
   bit-identical), against their plain versions (K2' allclose(atol=2e-3,
   rtol=1e-3); K2'' against ``run_plain(gemm="bf16x3")``, its own
   arithmetic, at MATCHED_ATOL/RTOL and a mean-abs bar, the f32 distance
   printed as the precision gap beside the twins' one-ulp noise floor),
   timed with CUDA events and as device time; the wgmma GEMM tile
   (``csrc/gemm_wg.cuh``) that the continuation's table runs as its GEMM
   ops, alone (``bs_gemm``, its standalone probe) at every 1x1 shape of
   the continuation: at three terms (the bf16x3 split of "high") against
   ``conv1x1_plain`` (allclose(2e-3, 1e-3)) and ``conv1x1_bf16x3_plain``
   (1e-5 relative), bit-identical over two runs, with its device time
   beside ``torch.addmm``'s (f32, TF32 off), and at six terms
   (``terms=6``, "highest") on the same terms against
   ``conv1x1_bf16x6_plain``, each summed over a frame's 29 GEMMs; in the
   SASS every GEMM kernel and the one-, three- and six-term tables hold
   HGMMA, and no kernel HMMA; then 30 frames held out
   from the synthetic model's fit (seed 1, frames 30-59) of
   ``FramePipeline`` against the plain path (K2'' in bf16x3) on the card under
   the tolerance invariant (every decode flip a near-tie of class 15's
   margin, the EMAs equal wherever the decode never flipped, no byte off
   by more than 1 outside the post's footprint of the EMA pixels that
   differ), every
   launch counter checked by kernel (``bs_body_mega`` twice a frame, no
   other body kernel), and a person fraction strictly inside (0.01, 0.99);
6. K4 (blend + NV12/I420 pack) byte-identical to its plain version at
   640x480 and 1280x720 (step 3) and at 42x58, 480x642 (W % 4 == 2) and a
   480x642 view off a 4-byte boundary (its per-block path), and K5 (the
   standalone bilateral) within allclose(atol=2e-3, rtol=1e-3) of its
   plain version at the classic path's canvases (segm 96x160, deeplab
   257x257, a batch of 4 at 257x257), rounded bytes off by at most 1;
   CUDA-event times, device times warm and cold (``device_ms_cold``: a
   128 MB buffer overwritten before each launch, so the inputs come from
   HBM; K3 too);
7. the classic path: 30 frames of ``FramePipeline(edge_fused=False,
   output_format="nv12")`` on the segm model at 640x480 (one K5 and one
   K4 launch a frame, no K1/K2/K3), then I420 frames, then a
   ``flip_horizontal`` run that takes no K4 (the JAX package's gate),
   each held against the plain path on the card under the tolerance
   invariant;
8. the staged path: 10 frames of ``MaskGen(fused=False)`` with stage
   hooks on the deeplab model at 640x480 (one K5 launch a frame at
   257x257, hooks in order), masks held to the deeplab rule above;
9. a pipeline constructed without ``device=`` lands on ``cuda``; then the
   default (fused) segm path with NV12 out: 10 frames at 640x480, each
   one K1, one K2 and one K4 launch and no K3 or K5 (counted frame by
   frame), held against the plain path under the tolerance invariant,
   then one I420 frame;
10. P1-P7, the probe kernels of ``tools/probe_mosaic.py``
   (``csrc/probes.cu``), through ``tools/probe_hopper.py`` on the
   original's inputs: the probe path once from zeroed counts (each kernel
   within the original's atol of its numpy reference), each kernel
   against its plain twin (P1, P2, P5-P7 bit-identical, P3 at DEFAULT,
   HIGH and HIGHEST and P4 within 1e-5), two runs bit-identical, device
   times beside the library calls' (P3's precisions on one line), every
   probe also cold; P1 and P2 bit-identical to their twins at
   ``probe_hopper.STENCIL_SHAPES`` and a view off 16 bytes, P6 and P7 at
   ``probe_hopper.COPY_SHAPES`` and views off 16 bytes, P5 at
   ``probe_hopper.CAT_SHAPES`` and with either source off 16 bytes, each on
   the kernel its shape picks (the vector or the scalar path, by the
   profiler's kernel name); the two launch floors warm and cold, one CTA
   of one warp each: an empty kernel (``bs_probe_empty``) and a 16-byte
   load and store a lane (``bs_probe_touch``), no kernels of the port's,
   so not in the JSON line; P1, P2 and P5-P7's distance to both; P4's
   cluster size; in the SASS (``cuobjdump -sass`` of the built library),
   P3's DEFAULT and HIGH kernels checked for HGMMA (the wgmma
   instruction) and P5-P7's vector kernels for every load issued before
   the first store;
11. the default family, mlkit selfie, on the committed synthetic
   selfie-shaped model: the fused path with YUYV out at 640x480 and
   1280x720 (K1 at the 256x256 canvas, K2 on its 128-wide body, the
   threshold tail, K3) and the classic path with NV12 out at 640x480 (K5,
   the executor, the threshold decode, K4), each FAMILY_FRAMES frames with
   every kernel of the path launched once a frame (counted frame by
   frame), held against the plain path under the decode flip rule
   (|logit - logit(0.65)| <= 1e-3) and the tolerance invariant; K1 and K2
   against their plain versions, K1/K2/K3 device times beside their
   bounds, K2's phases by the device clock, host-clock ms/frame, device
   busy a frame and the idle share; the numbers on a ``selfie:`` line
   before the last two;
12. segm_full (Meet full) on the committed synthetic 144x256 model, on the
   same terms: fused YUYV at 640x480 (a letterboxed canvas) and 1280x720
   (K1 at the 144x256 canvas, K2 on its 128-wide segm body, the
   two-channel tail, K3), fused NV12 at 640x480 (K4 in place of K3) and
   classic NV12 (K5, the executor, K4), the margin out1 - out0; a
   ``segm_full:`` line;
13. BodyPix on the committed synthetic 257x257 MobileNetV1 model: fused
   YUYV at both sizes through K1, K2' alone (the prefix plan: the spec
   turns the continuation off), the graph executor over the dilated 33x33
   remainder (its device time and operations a call), the threshold
   decode on the logit, the two-stage post (upscale, round, box blur) and
   K3; classic NV12 and the staged MaskGen with hooks at 640x480 (K5 at
   257x257), the margin the logit less 0.65; a ``bodypix:`` line;
14. the program itself: ``backscrub_tpu_torch.cli.main`` in-process on
   the card (``-c test: --cg 640x480 -m`` the synthetic mlkit model
   ``--frames 60 -v file:<tmp>.yuv --stats-json``), five times: plain,
   ``--drain-thread``, ``--staging-force``, ``--staging`` (the probe's
   decision printed) and ``--sink-format nv12``; each file exactly 60
   frames and byte-identical to 60 direct ``FramePipeline.step`` calls on
   the same ``SyntheticSource`` frames from a fresh EMA, and K1, K2 and K3
   (K4 for NV12) launched exactly once a frame by each run; then fps and
   stage ms from the stats line, the CLI's host ms/frame beside a bare
   ``step`` loop's, and the device idle share of a 20-frame profiled
   window of ``ServingLoop.run``; a ``cli:`` line;
15. MJPG (``mjpg_phase``): ``bs_jpeg_decode`` (``csrc/jpeg.cu``: the
   decode after the host's entropy decode, two kernels a call) byte-equal
   to its plain twin on every committed JPEG (``tests/data/mjpg_*``:
   4:2:0 at 640x480; 4:2:2, 4:4:4, 4:4:0, 4:1:1 and grayscale at 64x48)
   and to their committed cv2.imdecode sha256s, and on the synthetic
   camera's JPEGs at 640x480 and 1280x720, its device time warm and cold
   beside its bound (coefficients in, BGR out) and the plain twin's device
   time and operations; the encoder (PyTorch ops on the card, the host's
   Huffman pack) against the committed cv2.imencode sha256s, its device
   time and operations a frame; ``backscrub-torch -c mjpg:`` in-process on
   the mlkit model, YUYV out at 640x480 and ``--sink-format mjpg`` at
   640x480 and 1280x720, each file byte-identical to direct steps on the
   same JPEGs, one decode call, K1 and K2 a frame (K3 with YUYV out); then
   fps and stage ms of ``-c test:``, MJPG ingest (pre-encoded JPEGs) and
   YUYV ingest (a fake raw camera), twice in turns; an ``mjpg:`` line;
16. the post options (``options_phase``): ``refine:guided``,
   ``morph:open:3`` and ``u8exact`` on segm_lite and mlkit at 640x480,
   fused: K1, the graph executor over the body (the JAX route: no body
   plan), the post with the option, K3, counted frame by frame, held to
   the plain route under the decode flip rule and the tolerance invariant
   outside the flips' footprint through the option's post; device busy a
   frame beside the fused tail's; an ``options:`` line;
17. the precision modes (``precision_phase``): every family's bf16 fused
   path, each bf16 plan (``body_mega_kernel<1>``, K2'' with the one-term
   GEMM) held op by op on the kernel's own inputs at allclose(2e-3, 1e-3)
   with a control that must miss it, the frames against the plain bf16
   path with the f32 path as the control, device busy in both; the
   one-term wgmma GEMM tile alone at every shape (its sum over a frame
   beside ``torch.addmm`` on bf16 operands); every family's int8 classic
   path; ``backscrub-torch
   --bf16`` and ``--int8``; a ``precision:`` line;
18. multi-stream serving (``multistream_phase``): K1 (segm_lite, mlkit,
   deeplab), K2 (segm_lite, mlkit), K2' and K2'' (deeplab, f32 and bf16
   tables), K3 and K4 over stream batches of 4 and 8 at 640x480, each one
   launch a batch, each image bit-identical to its own launch, the batch
   against the plain version at the single-frame bars, device us a batch
   and a frame cold (L2 flushed) beside the bound a batch, and warm
   (L2-resident), the plans' workspace bytes; ``MultiStreamPipeline`` on
   mlkit and deeplab, 4 streams for 30 ticks (one K1, one launch of each
   plan and one K3 a tick, counted from zero) against solo
   ``FramePipeline`` steps under the decode flip rule (deeplab's limit
   MS_DEEPLAB_TIE) and the tolerance invariant, every stage of the edge
   path traced against its solo form on the batch's own inputs tick by
   tick (``_stage_trace``), mlkit bit-identical to the solo steps at every
   stage and byte, both also with the canvas and executor remainder image
   by image (no flip), deeplab with a planted fault (bf16 dots) that its
   limit must catch;
   ``MultiStreamServer`` (pull) deliveries byte-identical to direct steps
   at 1, 2, 4 and 8 streams, then fps per card (median and range of five
   windows of 2 s) and a profiled window's host ms, device busy and idle
   share a tick; ``MultiGeometryServer`` over mlkit 640x480, segm_lite 1280x720 and
   an ``mjpg:`` stream, byte-identical to direct steps of each bucket;
   ``cli_multi.main`` with three ``test:`` streams to files, byte-identical
   to direct steps, K1, K2 and K3 once a tick a bucket; a ``multistream:``
   line, and each batched kernel's numbers under ``batched`` in the
   kernels line;
19. the C ABI (``capi_phase``; ``backscrub_tpu_torch/native/bs_capi.cc``,
   built by ``_build.capi_library``) on the synthetic segm_lite model at
   640x480, 60 ``SyntheticSource`` frames: the shim by ctypes in this
   interpreter with ``BACKSCRUB_TORCH_DEVICE`` unset (the card), fused
   (``onmask`` only: one K1 and one K2 launch a frame, no K5, ``onmask``
   once a frame) and staged (every hook: K5 once a frame, no K1 or K2, the
   hooks in the order prep, infer, mask), each byte-identical to an
   in-process ``MaskGen`` on the same frames; NULL with an ``ondebug``
   message for an unknown option, a missing model and
   ``BACKSCRUB_TORCH_DEVICE=bogus``; the native consumer
   (``_build.native_program``: ``native/demo.cc`` and ``native/bsio.cc``
   linked against the shim) as a subprocess on the same frames from a raw
   BGR file (``--cg 640x480 -n 60 -H``), its masks byte-equal to the fused C
   path's and its YUYV to the port's plain composite of them
   (``alpha_blend_u8``, ``flip``, ``rgb_to_yuyv`` with the reference chroma
   order over green), its fps from its ``-d`` lines; ``entry()``'s step
   over four frames, the EMA carried, byte-identical to
   ``FramePipeline.step`` in one K1, K2 and K3 launch a call;
   host ms a frame of the C loop and of ``MaskGen.process`` in turns of at
   least 2 s, five alternating C/process pairs (the C overhead their
   median difference, beside each kind's spread), then ``process_bytes``
   twice; a ``capi:`` line,
   and the C path's launches as ``capi_launches`` of K1, K2 and K5 in the
   kernels line;
20. fine-tuning (``train_phase``): seeded moving frames at 640x480
   labelled by the mlkit teacher's fused ``MaskGen`` (one K1 and one K2
   launch a frame, the tail), segm_lite distilled on them at its full
   96x160 input, batch 8, TRAIN_STEPS Adam steps on the card and the same
   steps from the same parameters on the CPU through the same port code
   (losses rtol 1e-4, parameters within 2·lr·n, every loss finite, the
   last below the first), a checkpoint written before the last step and
   resumed to the same last loss, the tuned weights exported to a
   ``.tflite`` that the port's loader reads back as their f16 rounding,
   served through ``family_fused`` (one K1, K2 and K3 launch a frame, the
   flip rule and the tolerance invariant against the plain path); host ms
   and device ms a train step beside the card's name and power limit, the
   phase's seconds; a ``train:`` line, and the phase's launches as
   ``train_launches`` of K1, K2 and K3 in the kernels line;
21. the (data, model) mesh (``mesh_phase``): NCCL puts no two ranks on
   one card, so the world is one rank and the mesh (1, 1), every
   collective on a group of one; ``python3 chip_smoke.py --mesh-child
   OUT`` runs in a child process under MESH_TIMEOUT (an NCCL start that
   hangs fails the phase): ``entry.dryrun_multichip(1)``, then from zeroed
   counts the mesh's frame path (3 streams at 640x480), a
   MultiGeometryServer with a BodyPix bucket (K2') and ``cli_multi
   --data-axis 2`` (three ``test:`` streams to files), each byte-identical
   to the no-mesh path and K1, K2, K2' and K3 launched as counted; a
   (1, 1) dp + tp + sp train step against the one-card Trainer (losses
   rtol 1e-6, parameters within 2·lr·n); host ms a frame-path tick, a
   MultiStreamServer tick and a train step with and without the mesh, the
   median and spread of turns of at least MESH_WINDOW_S in alternating
   pairs, and each one's device busy and idle share over a profiled
   window; a ``mesh:`` line, and its launches as
   ``mesh_launches`` of K1, K2, K2' and K3 in the kernels line;
22. a model of the user's own (``byo_phase``): the op-coverage graph
   (``tests/data/ops_synth_coverage.tflite``: every op kind TF's converter
   emits of the lowerings no bundled family uses, a WHILE and an IF whose
   subgraphs own weights) through the port's loader on the card, held to
   its committed golden (the JAX executor's output on the CPU: f32 within
   1e-5 + 1e-5·|ref|, integers and bools exactly), its op histogram, the
   WHILE's trip count and the largest error printed; the converted U-Net
   (``tests/data/unet_synth_256x256.tflite``, the "unknown" spec) through
   ``FramePipeline`` at 640x480 for FAMILY_FRAMES frames three times, fused
   with YUYV out (K1, the graph executor over the whole body: no body
   plan, K3), fused with NV12 out (K4) and classic with YUYV out (K5, the
   executor, K3), every frame's launches counted, K1 or K5 against its
   plain version, the frames held to the plain path under the decode flip
   rule and the tolerance invariant, host ms/frame over a clean loop and
   device busy a frame (the family runs' own checks: ``family_fused`` with
   no body plan, ``family_classic`` with YUYV out); ``backscrub-torch -m <unet>`` over BYO_CLI_FRAMES ``test:``
   frames byte-equal to direct steps; the coverage model's parameters
   (its subgraphs' weights included) exported on the card, reloaded and
   rerun bit-identical; a line before each check, a ``byo:`` line, and
   the U-Net runs' launches as ``byo_launches`` of K1, K3, K4 and K5 in
   the kernels line;
23. deeplab at "highest" (``highest_phase``): the continuation's dots
   "bf16x6", its table the six-term instantiation; K2'' on a held-out
   frame's prefix output against ``run_plain(gemm="bf16x6")`` at
   allclose(atol=2e-3, rtol=1e-3) and the mean-abs bar, two runs
   bit-identical, its distances to the f32 and three-term twins and its
   device time beside the three-term table's; then HIGHEST_FRAMES held-out
   frames of ``FramePipeline(precision="highest")`` against the plain path
   in the same arithmetic under the decode flip rule, every launch
   counted; ``body_cont_highest`` and ``gemm_highest`` in the kernels line;
24. the tools (``tools_phase``): ``tools/roofline_torch.py`` (segm_lite at
   1280x720) and ``tools/ab_torch.py`` (deeplab at "highest") in
   subprocesses started together, each exit 0, each last line naming the
   card and its power limit; a ``tools:`` line;
25. prints one JSON line with every kernel's numbers (launches from the
   run of the path it serves, errors and times measured here, and the
   bound: the larger of the bytes it must move over 3.35 TB/s and its
   operations over the peak of their type, 67 TFLOP/s f32 or 989 TFLOP/s
   bf16 on the tensor cores, counted by ``backscrub_tpu_torch/utils/
   roofline.py``; every kernel also with ``device_ms`` (the
   profiler's kernel time a call, at the main path's shapes: K1 on the
   segm canvas, K3 and K4 at 640x480, K5 at segm's 96x160; printed
   earlier for K1 on the deeplab canvas and K3 and K4 at 1280x720 too),
   the GEMM and K2 with
   ``b2b_ms`` (an event pair around 100 back-to-back calls), the GEMM with
   ``library_ms`` = ``torch.addmm`` and its device and back-to-back times;
   K4's ``launches`` are the fused NV12 run's, K5's the classic run's;
   the GEMM's ``launches`` are the GEMM ops that the continuation's
   ``bs_body_mega`` launches ran on the main path, its other numbers those
   of the standalone probe at the ASPP shape; K2'' with its
   ``precision_gap``; P1-P7 with their launches on the probe path,
   ``main_path_launches`` 0, ``device_ms``, ``device_ms_cold`` and
   ``library_ms`` or null), then
   ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and the script exits non-zero; without CUDA it exits 1
before printing any result.
"""

import collections
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the counting behind every bound below (the H100 SXM's peaks, each
# kernel's bytes and operations): backscrub_tpu_torch/utils/roofline.py
from backscrub_tpu_torch.utils.roofline import (bf16_work, bilateral_work, bound,  # noqa: E402
                                                cont_work, front_work, gemm_ops, gemm_work,
                                                jpeg_decode_work, pack_420_work,
                                                pack_yuyv_work)

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(REPO, "tests", "data", "segm_synth_lite_96x160.tflite")
SIZES = ((640, 480), (1280, 720))
FRAMES = 50
DEEPLAB = os.path.join(REPO, "tests", "data", "deeplab_synth_257.tflite")
DEEPLAB_SIZE, DEEPLAB_FRAMES = (640, 480), 30
HIGHEST_FRAMES = 15         # held-out deeplab frames of the "highest" run
PERSON, TIE = 15, 1e-3      # deeplab's person class; a near-tie decode margin
# deeplab's batch-vs-solo flip limit (multistream_pipelines): above the
# sound batch's largest flip |margin| (6.08e-3 on an H100), below a planted
# fault's (one-pass bf16 dots: 0.507), both read by that phase
MS_DEEPLAB_TIE = 0.02
ATOL, RTOL = 2e-3, 1e-3
# K2'' against its plain version in its own arithmetic (bf16x3 GEMMs).  The
# split rounds each GEMM input's low half to bf16, so a one-ulp difference
# in an input (another summation order upstream) moves the chain's output
# ~20x more than in f32: on an H100 (700 W) a one-ulp nudge of the first
# held-out frame's continuation input moved the bf16x3 plain plan by
# 5.89e-4 at most and the f32 one by 3.24e-5 (deeplab_phase prints this
# each run).  So the max-abs bar sits above that floor, and the mean-abs bar
# discriminates: tests/test_torch_deeplab.py::
# test_continuation_bf16x3_noise_floor holds the floor's mean under half of
# it and a GEMM that drops one cross term over ten times it.
MATCHED_ATOL, MATCHED_RTOL, MATCHED_MEAN = 2e-3, 1e-4, 1e-4
PROBE_TOL = 1e-5           # P3 and P4 against their plain twins (summation order)
# every probe's kernels by their profiler names, which its warm and cold
# times sum (the L2 flush's elementwise_kernel holds "se_kernel" as well);
# "::dw9_" is both stencil paths, "::strided_copy_" both copy paths,
# "::concat_" both concat paths
PROBE_KERNELS = {"P1": "::dw9_", "P2": "::dw9_", "P3": "::dot_kernel", "P4": "::se_kernel",
                 "P5": "::concat_", "P6": "::strided_copy_", "P7": "::strided_copy_"}
FRAME_TOL, MEAN_TOL = 0.02, 0.002
CLASSIC_SIZE, CLASSIC_FRAMES, STAGED_FRAMES = (640, 480), 30, 10
FUSED_420_FRAMES = 10      # the fused segm path with NV12 out
L2_FLUSH_BYTES = 128 << 20  # overwritten before each cold launch: over twice the 50 MB L2
VARIANT_FRAMES = 5         # classic I420 and flipped runs
# the other families' synthetic models: mlkit selfie (the default: 256x256
# in, one channel out, threshold decode), segm_full (144x256 in, two
# channels out) and BodyPix (257x257 in, a 33x33 logit out, threshold
# decode); frames a family's fused or classic run, frames of the profiled
# window
SELFIE = os.path.join(REPO, "tests", "data", "selfie_synth_mlkit_256x256.tflite")
SEGM_FULL = os.path.join(REPO, "tests", "data", "segm_synth_full_144x256.tflite")
BODYPIX = os.path.join(REPO, "tests", "data", "body-pix_synth_050_8_257.tflite")
FAMILY_FRAMES, FAMILY_WINDOW = 30, 20
# a model of the user's own (byo_phase): the converted U-Net, the
# op-coverage graph and its golden outputs (tools/make_synth_{unet,coverage}.py);
# frames of each U-Net run and of the CLI run; the coverage bars (f32
# within COVERAGE_ATOL + COVERAGE_RTOL * |ref|, integers and bools exactly)
UNET = os.path.join(REPO, "tests", "data", "unet_synth_256x256.tflite")
COVERAGE = os.path.join(REPO, "tests", "data", "ops_synth_coverage.tflite")
COVERAGE_GOLDEN = os.path.join(REPO, "tests", "data", "ops_synth_coverage.npz")
BYO_CLI_FRAMES = 10
COVERAGE_ATOL = COVERAGE_RTOL = 1e-5
# the program itself: backscrub_tpu_torch.cli.main at the CLI's default
# geometry and family, frames a run, frames of the serving loop's profiled
# window; the serving modes that must change no byte
CLI_SIZE, CLI_FRAMES, CLI_WINDOW = (640, 480), 60, 20
MJPG_DATA = os.path.join(REPO, "tests", "data")
MJPG_CLI = (((640, 480), 20), ((1280, 720), 10))   # -c mjpg: --sink-format mjpg runs
MJPG_FPS_FRAMES = 60       # the fps runs: -c test:, MJPG and YUYV ingest at 640x480
# (option, PipelineConfig fields, environment): u8exact is the
# BACKSCRUB_U8_EXACT default, as the CLI and the C ABI take it
OPTIONS = (("refine:guided", dict(mask_refine="guided"), {}),
           ("morph:open:3", dict(mask_morph="open:3"), {}),
           ("u8exact", {}, {"BACKSCRUB_U8_EXACT": "1"}))
OPTION_FRAMES = 10
# the precision modes (precision_phase): frames a family's bf16 run and
# profiled window; CONTROL_SHARE, the largest share of the f32 path's
# reading (the control: a port that ignored bf16) that a bf16 reading
# against the plain bf16 path may reach; MIN_CELLS, the decode cells the
# bf16 effect must span for a mask IoU to resolve it
# (tests/test_torch_precision_masks.py)
PRECISION_FRAMES, CONTROL_SHARE, MIN_CELLS = 10, 0.85, 10
CLI_MODES = (("plain", []), ("drain-thread", ["--drain-thread"]),
             ("staging-force", ["--staging-force"]), ("staging", ["--staging"]),
             ("nv12", ["--sink-format", "nv12"]))
GEMM_REL = 1e-5            # the GEMM against its plain twin in its arithmetic, relative
# the six-term result's distance to f32 against the three-term one's: at
# most 1/SIX_TERM_RATIO of it for K2'' at highest (as
# tests/test_torch_highest.py's RATIO), 1/SIX_TERM_GEMM_RATIO for the GEMM
# alone at each shape (its f32 reference rounds too)
SIX_TERM_RATIO, SIX_TERM_GEMM_RATIO = 10, 2


def ulp_nudge(x, seed):
    """``x`` with every element moved one ulp up or down (seeded signs)."""
    import torch
    s = np.random.default_rng(seed).choice([-1.0, 1.0], tuple(x.shape)).astype(np.float32)
    return torch.nextafter(x, x + torch.from_numpy(s).to(x.device) * 1e30)


def b2b_ms(fn, n=100, warmup=3):
    """ms a call of ``fn`` from one CUDA event pair around ``n`` back-to-back
    calls, divided by ``n``: device time where the device is slower than
    the host's launches, else the host's launch rate."""
    import torch
    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n=100, warmup=3, attempts=5, cold=None, kernel=None):
    """Device time (ms) a call of ``fn``: the torch.profiler's sum of the
    card's kernel (and copy) time over ``n`` calls, divided by ``n``.  With
    ``kernel``, a kernel name launched once a call, only the kernels whose
    name holds it are summed, divided by their count.  With ``cold``, such
    a name, a buffer of L2_FLUSH_BYTES is overwritten before each call (so
    the inputs come from HBM) and only the kernels whose name holds
    ``cold`` are summed, divided by their count.  The profiler leaves out
    the first kernels of a window (99 of 100 launches were counted on an
    H100; 28 of 30 cold K1 launches in three windows running, in another
    call; 98 of 100 of the JPEG decode's IDCT kernel behind three short
    sleeps, in another), so each window opens with eight
    ``torch.cuda._sleep`` kernels of ~10 us that nothing sums.  A window
    that records no device events at all, or (with a name) under ``n - 1``
    of the named kernel, is measured again, up to ``attempts`` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    name = cold or kernel
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    counts = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(20000)
            for i in range(n):
                if cold:
                    flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and "spin_kernel" not in e.key and (name is None or name in e.key)]
        counts.append(sum(e.count for e in ev))
        total = sum(e.self_device_time_total for e in ev)
        if total > 0 and (name is None or n - 1 <= counts[-1] <= n):
            return total / 1e3 / (counts[-1] if name else n)
    raise RuntimeError(f"the profiler saw no device time{f' of {n} {name}' if name else ''} "
                       f"in {attempts} windows (kernels counted: {counts})")


def barrier_us():
    """The cost of one phase barrier: ``bs_barrier_bench`` runs 2000 and 0
    barriers back to back in one launch, for a cooperative grid of one CTA
    an SM (grid.sync) and one cluster of 16 CTAs (cluster.sync)."""
    from backscrub_tpu_torch import _build
    res = {}
    for name, kind, size in (("grid", 0, 0), ("cluster16", 1, 16)):
        t = [b2b_ms(lambda: _build.launch("bs_barrier_bench", n, kind, size), n=5)
             for n in (2000, 0)]
        res[name] = (t[0] - t[1]) * 1e3 / 2000
    return res


def timed(fn, n=30, warmup=3):
    """Mean ms per call of ``fn`` from CUDA event pairs around each call,
    with each output folded into a checksum outside the timed pairs."""
    import torch
    for _ in range(warmup):
        fn()
    checksum = torch.zeros((), dtype=torch.float64, device="cuda")
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        checksum += out.double().sum()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n, float(checksum)


def kernel_phase(w, h):
    """K1, K2, K3 and K4 against their plain versions at one frame size."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                      blend_pack_yuyv, blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h), device="cuda")
    edge = pipe.maskgen.edge
    if edge is None or edge.body_plan is None:
        raise RuntimeError("the synthetic model did not take the fused path")
    frame = torch.from_numpy(moving_frames(w, h, 1)[0]).cuda()
    res = {}
    with torch.no_grad():
        canvas, kw = edge.canvas(frame), edge.front_kwargs()
        k1 = front_fused(canvas, edge.front_params, **kw)
        p1 = front_plain(canvas, edge.front_params, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(k1, p1, atol=ATOL, rtol=RTOL)
        res["front"] = dict(max_abs_err=float((k1 - p1).abs().max()),
                            ms=timed(lambda: front_fused(canvas, edge.front_params, **kw)),
                            plain_ms=timed(lambda: front_plain(canvas, edge.front_params, **kw)),
                            device_ms=device_ms(
                                lambda: front_fused(canvas, edge.front_params, **kw)),
                            bound=bound(*front_work(kw, k1.shape[0])))

        plan = edge.body_plan
        x = k1.reshape(k1.shape[0], -1)
        before = dict(body_launch.by_kernel)
        k2, p2 = plan.run_cuda(x).clone(), plan.run_plain(x)
        k2b = plan.run_cuda(x)
        torch.cuda.synchronize()
        if dict(body_launch.by_kernel - collections.Counter(before)) != {"bs_body_mega": 2}:
            raise AssertionError("K2 did not run as one bs_body_mega launch a run")
        torch.testing.assert_close(k2, p2, atol=ATOL, rtol=RTOL)
        if not torch.equal(k2, k2b):
            raise AssertionError("two K2 runs differ")
        res["body"] = dict(max_abs_err=float((k2 - p2).abs().max()),
                           ms=timed(lambda: plan.run_cuda(x)),
                           plain_ms=timed(lambda: plan.run_plain(x)),
                           device_ms=device_ms(lambda: plan.run_cuda(x)),
                           b2b_ms=b2b_ms(lambda: plan.run_cuda(x)),
                           bound=bound(*plan.work()))
        bars = barrier_us()
        print(f"kernel body {w}x{h}: bs_body_mega, {len(plan.mega.ops)} table ops in "
              f"{plan.mega.phases} phases ({plan.mega.phases - 1} barriers) for "
              f"{len(plan.plan)} plan ops, {plan.mega.smem_bytes} B shared memory a CTA, "
              f"device {res['body']['device_ms'] * 1e3:.2f} us a run (back to back "
              f"{res['body']['b2b_ms'] * 1e3:.2f} us); barrier "
              f"microbenchmark: cooperative grid sync {bars['grid']:.3f} us, cluster "
              f"(16 CTAs) sync {bars['cluster16']:.3f} us")

        rng = np.random.default_rng(3)
        bg = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).cuda()
        mask = rng.integers(0, 256, (h, w), np.uint8)
        mask[: h // 4] = 0
        mask[h // 4: h // 2] = 255
        mask = torch.from_numpy(mask).cuda()
        for order in ("reference", "yuy2"):
            for cc in (False, True):
                k3 = blend_pack_yuyv(frame, bg, mask, order, cc)
                p3 = blend_pack_yuyv_plain(frame, bg, mask, order, cc)
                if not torch.equal(k3, p3):
                    raise AssertionError(f"K3 differs from its plain version "
                                         f"({order}, correct_colors={cc})")
        res["pack"] = dict(max_abs_err=0.0,
                           ms=timed(lambda: blend_pack_yuyv(frame, bg, mask)),
                           plain_ms=timed(lambda: blend_pack_yuyv_plain(frame, bg, mask)),
                           device_ms=device_ms(lambda: blend_pack_yuyv(frame, bg, mask)),
                           device_ms_cold=device_ms(lambda: blend_pack_yuyv(frame, bg, mask),
                                                    cold="blend_pack_yuyv_kernel"),
                           bound=bound(*pack_yuyv_work(h, w)))
        for layout in ("nv12", "i420"):
            k4 = blend_pack_420(frame, bg, mask, layout)
            if not torch.equal(k4, blend_pack_420_plain(frame, bg, mask, layout)):
                raise AssertionError(f"K4 differs from its plain version ({layout})")
        res["pack_420"] = dict(max_abs_err=0.0,
                               ms=timed(lambda: blend_pack_420(frame, bg, mask)),
                               plain_ms=timed(lambda: blend_pack_420_plain(frame, bg, mask)),
                               device_ms=device_ms(lambda: blend_pack_420(frame, bg, mask)),
                               device_ms_cold=device_ms(
                                   lambda: blend_pack_420(frame, bg, mask),
                                   cold="blend_pack_420_kernel"),
                               bound=bound(*pack_420_work(h, w)))
    for name, r in res.items():
        print(f"kernel {name} {w}x{h}: max_abs_err={r['max_abs_err']:.3g} "
              f"kernel {r['ms'][0]:.4f} ms (checksum {r['ms'][1]:.6g}) "
              f"plain {r['plain_ms'][0]:.4f} ms (checksum {r['plain_ms'][1]:.6g}) "
              f"device {r['device_ms'] * 1e3:.3f} us"
              + (f" (cold {r['device_ms_cold'] * 1e3:.3f} us)" if "device_ms_cold" in r else "")
              + f" bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return res


def plain_step(pipe, frame, bg, ema, layout="yuyv"):
    """The port's fused segm path with every kernel replaced by its plain
    version; ``layout`` "yuyv" (K3's plain version) or "nv12"/"i420"
    (K4's)."""
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420_plain, blend_pack_yuyv_plain
    from backscrub_tpu_torch.pipeline.edge import front_plain
    e = pipe.maskgen.edge
    h = front_plain(e.canvas(frame), e.front_params, **e.front_kwargs())
    body = e.body_plan.run_plain(h.reshape(h.shape[0], -1))
    ema = e.tail(body, ema)
    mask = e.postprocess(ema)
    out = (blend_pack_yuyv_plain(frame, bg, mask) if layout == "yuyv"
           else blend_pack_420_plain(frame, bg, mask, layout))
    return out, mask, ema


def pipeline_phase(w, h):
    """50 frames through FramePipeline on cuda: launch counts, outputs
    against the plain path, ms/frame."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_yuyv
    from backscrub_tpu_torch.pipeline.edge import front_fused
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h), device="cuda")
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, FRAMES)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    for f in frames[:10]:             # warm-up: library load, allocator, cuBLAS
        pipe.step(f, bg)
    if pipe.maskgen.edge.body_plan.launches_per_run != 1:
        raise AssertionError("K2 is not one launch a run")
    want = dict(front=FRAMES, body=FRAMES, pack=FRAMES)

    def drive(keep):
        """One pass of the sequence from a fresh EMA; returns the launch
        counts of the pass and, with ``keep``, its outputs (the timed pass
        drops them, as a camera loop does, so the allocator reuses blocks)."""
        pipe.reset()
        torch.cuda.synchronize()
        front_fused.launches = body_launch.launches = blend_pack_yuyv.launches = 0
        body_launch.by_kernel.clear()
        outs = []
        for f in frames:
            out = pipe.step(f, bg)
            if keep:
                outs.append(out)
        torch.cuda.synchronize()
        counts = dict(front=front_fused.launches, body=body_launch.launches,
                      pack=blend_pack_yuyv.launches)
        if counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": FRAMES}:
            raise AssertionError(f"launch counts {counts} {dict(body_launch.by_kernel)}, "
                                 f"expected {want} and bs_body_mega once a frame")
        return counts, outs

    t0 = time.perf_counter()
    launches, _ = drive(keep=False)
    ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    _, outs = drive(keep=True)

    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device="cuda")
    fracs = []
    with torch.no_grad():
        for f, (yuyv, mask) in zip(frames, outs):
            if yuyv.shape != (h, 2 * w) or mask.shape != (h, w) \
                    or yuyv.dtype != torch.uint8 or mask.dtype != torch.uint8:
                raise AssertionError(f"output shapes {yuyv.shape} {mask.shape}")
            ry, rm, ema = plain_step(pipe, f, bg, ema)
            fracs.append(_held_bytes([(yuyv, ry), (mask, rm)], "segm fused path"))
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"{100 * np.mean(fracs):.4f}% of bytes differ on average")
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    print(f"pipeline {w}x{h}: {FRAMES} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized), launches {launches}, differing bytes vs plain path "
          f"mean {100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}% (no byte off by "
          f"more than 1), person fraction {person:.3f}")
    return launches, ms


def _held(name, k, p, fn_k, fn_p, atol=ATOL, rtol=RTOL):
    """Hold kernel output ``k`` against plain ``p``; time both callables."""
    import torch
    torch.cuda.synchronize()
    torch.testing.assert_close(k, p, atol=atol, rtol=rtol)
    r = dict(max_abs_err=float((k - p).abs().max()), ms=timed(fn_k), plain_ms=timed(fn_p))
    print(f"kernel {name} deeplab {DEEPLAB_SIZE[0]}x{DEEPLAB_SIZE[1]}: "
          f"max_abs_err={r['max_abs_err']:.3g} kernel {r['ms'][0]:.4f} ms "
          f"(checksum {r['ms'][1]:.6g}) plain {r['plain_ms'][0]:.4f} ms "
          f"(checksum {r['plain_ms'][1]:.6g})")
    return r


def gemm_phase(cont, device):
    """The continuation table's GEMM tile alone (``bs_gemm``, the standalone
    probe built from the same gemm_wg.cuh, its weights laid out once by
    ``wgmma_weights``) at every 1x1 shape of the continuation ``cont`` (its
    weights, seeded inputs at L = 33 * 33): at three terms (the bf16x3
    split of "high") against conv1x1_plain (allclose) and
    conv1x1_bf16x3_plain (GEMM_REL relative), two runs bit-identical,
    device time beside torch.addmm's (bias, no activation, f32 with TF32
    off); at six terms (``terms=6``, "highest") on the same terms against
    conv1x1_bf16x6_plain and at most 1/SIX_TERM_GEMM_RATIO of the
    three-term tile's distance from conv1x1_plain, its device time beside
    the three-term tile's and torch.addmm's, summed over a frame; the SASS
    of every GEMM kernel and body table (HGMMA, no HMMA).  Returns the
    kernels-line numbers of both term counts at the largest shape (the ASPP
    projection)."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import (_WG_TILES, _wg_tile, conv1x1_bf16x3_plain,
                                                    conv1x1_bf16x6_plain, conv1x1_gemm,
                                                    conv1x1_plain, gemm_config, wgmma_weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    ws = cont._weights_on(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = collections.defaultdict(list)
    for p in gemm_ops(cont):
        shapes[cont.weights[p[3]].shape].append(p)
    split, split6 = {}, {}
    frame_us = lib_frame_us = six_frame_us = 0.0
    with torch.no_grad():
        for (co, ci), ps in sorted(shapes.items()):
            _, tin, _, wi, bi, act = ps[0]
            gw, gb = ws[wi], ws[bi]
            L = cont.meta[tin].rows * cont.meta[tin].w
            sp = split[wi] = wgmma_weights(gw, 3, L)
            gx = torch.from_numpy(np.random.default_rng(co * 1000 + ci).uniform(
                0, 2, (ci, L)).astype(np.float32)).to(device)
            k, k2 = (conv1x1_gemm(gw, gb, gx, act, split=sp) for _ in range(2))
            pf, pb = conv1x1_plain(gw, gb, gx, act), conv1x1_bf16x3_plain(gw, gb, gx, act)
            torch.cuda.synchronize()
            torch.testing.assert_close(k, pf, atol=ATOL, rtol=RTOL)
            rel = float((k - pb).abs().max() / pb.abs().max())
            if rel > GEMM_REL or not torch.equal(k, k2):
                raise AssertionError(f"GEMM {co}x{ci}: {rel:.3g} from bf16x3, or runs differ")
            sp6 = split6[wi] = wgmma_weights(gw, 6, L)
            k6, k6b = (conv1x1_gemm(gw, gb, gx, act, split=sp6, terms=6) for _ in range(2))
            p6 = conv1x1_bf16x6_plain(gw, gb, gx, act)
            torch.cuda.synchronize()
            rel6 = float((k6 - p6).abs().max() / p6.abs().max())
            if rel6 > GEMM_REL or not torch.equal(k6, k6b):
                raise AssertionError(f"six-term GEMM {co}x{ci}: {rel6:.3g} from bf16x6, or "
                                     f"runs differ")
            gap3, gap6 = float((k - pf).abs().max()), float((k6 - pf).abs().max())
            if gap6 * SIX_TERM_GEMM_RATIO > gap3:
                raise AssertionError(f"six-term GEMM {co}x{ci}: {gap6:.3g} from f32, not "
                                     f"1/{SIX_TERM_GEMM_RATIO} of three terms' {gap3:.3g}")
            dev6 = device_ms(lambda: conv1x1_gemm(gw, gb, gx, "NONE", split=sp6, terms=6))
            six_frame_us += 1e3 * dev6 * len(ps)
            dev = device_ms(lambda: conv1x1_gemm(gw, gb, gx, "NONE", split=sp))
            lib = device_ms(lambda: torch.addmm(gb[:, None], gw, gx))
            bb = b2b_ms(lambda: conv1x1_gemm(gw, gb, gx, "NONE", split=sp))
            tile, nsplit, _ = gemm_config(co, ci, L, sms)
            wn, wt = _WG_TILES[tile], _WG_TILES[_wg_tile(co, L)]
            tile6, nsplit6, _ = gemm_config(co, ci, L, sms, 6)
            wn6, wt6 = _WG_TILES[tile6], _WG_TILES[_wg_tile(co, L)]
            b = bound(*gemm_work(co, ci, L))
            frame_us += 1e3 * dev * len(ps)
            lib_frame_us += 1e3 * lib * len(ps)
            print(f"gemm {co}x{ci} by {ci}x{L} ({len(ps)} a frame): tile 64x{wn} split "
                  f"{nsplit}, {-(-co // wn) * -(-L // 64) * nsplit} CTAs (in the table: tile "
                  f"64x{wt}, {-(-co // wt) * -(-L // 64)} CTAs); max_abs_err vs f32 "
                  f"{gap3:.3g}, vs bf16x3 {rel:.3g} relative; device "
                  f"{dev * 1e3:.3f} us (back to back {bb * 1e3:.3f} us), torch.addmm "
                  f"{lib * 1e3:.3f} us, bound {b[0] * 1e3:.3f} us ({b[1]}); six terms: vs "
                  f"f32 {gap6:.3g}, vs bf16x6 {rel6:.3g} relative, tile 64x{wn6} split "
                  f"{nsplit6}, {-(-co // wn6) * -(-L // 64) * nsplit6} CTAs (in the table 64x"
                  f"{wt6}, {-(-co // wt6) * -(-L // 64)} CTAs), device {dev6 * 1e3:.3f} us, bound "
                  f"{bound(*gemm_work(co, ci, L, terms=6))[0] * 1e3:.3f} us")
        co, ci = max(shapes, key=lambda s: s[0] * s[1])
        _, tin, _, wi, bi, act = shapes[(co, ci)][0]
        gw, gb, sp = ws[wi], ws[bi], split[wi]
        gx = torch.from_numpy(np.random.default_rng(6).uniform(
            0, 2, (ci, cont.meta[tin].rows * cont.meta[tin].w)).astype(np.float32)).to(device)
        r = _held(f"gemm {co}x{ci}x{gx.shape[1]}", conv1x1_gemm(gw, gb, gx, split=sp),
                  conv1x1_plain(gw, gb, gx), lambda: conv1x1_gemm(gw, gb, gx, split=sp),
                  lambda: conv1x1_plain(gw, gb, gx))
        r.update(bound=bound(*gemm_work(co, ci, gx.shape[1])),
                 device_ms=device_ms(lambda: conv1x1_gemm(gw, gb, gx, split=sp)),
                 b2b_ms=b2b_ms(lambda: conv1x1_gemm(gw, gb, gx, split=sp)),
                 library_ms=timed(lambda: torch.addmm(gb[:, None], gw, gx)),
                 library_device_ms=device_ms(lambda: torch.addmm(gb[:, None], gw, gx)),
                 library_b2b_ms=b2b_ms(lambda: torch.addmm(gb[:, None], gw, gx)))
        sp6 = split6[wi]
        k6 = conv1x1_gemm(gw, gb, gx, split=sp6, terms=6)
        p6 = conv1x1_bf16x6_plain(gw, gb, gx)
        r6 = _held(f"gemm_highest {co}x{ci}x{gx.shape[1]}", k6, p6,
                   lambda: conv1x1_gemm(gw, gb, gx, split=sp6, terms=6),
                   lambda: conv1x1_bf16x6_plain(gw, gb, gx))
        r6.update(rel_err=float((k6 - p6).abs().max() / p6.abs().max()),
                  f32_max_abs_err=float((k6 - conv1x1_plain(gw, gb, gx)).abs().max()),
                  bound=bound(*gemm_work(co, ci, gx.shape[1], terms=6)),
                  device_ms=device_ms(lambda: conv1x1_gemm(gw, gb, gx, split=sp6, terms=6)),
                  three_term_device_ms=r["device_ms"], library_ms=r["library_ms"],
                  library_device_ms=r["library_device_ms"], frame_us=six_frame_us,
                  library_frame_us=lib_frame_us)
        r.update(frame_us=frame_us, library_frame_us=lib_frame_us)
    print("gemm tiles in the SASS (HGMMA, HMMA, UBLKCP): "
          + json.dumps(gemm_tiles_in_sass(sass_functions())))
    print(f"gemm {co}x{ci}: device {r['device_ms'] * 1e3:.3f} us, torch.addmm device "
          f"{r['library_device_ms'] * 1e3:.3f} us; back to back {r['b2b_ms'] * 1e3:.3f} vs "
          f"{r['library_b2b_ms'] * 1e3:.3f} us; wrapper {r['ms'][0]:.4f} ms vs "
          f"{r['library_ms'][0]:.4f} ms; a deeplab frame's {sum(map(len, shapes.values()))} "
          f"GEMMs: {frame_us:.2f} us of device time (torch.addmm {lib_frame_us:.2f} us, six "
          f"terms {six_frame_us:.2f} us); six terms at {co}x{ci}: device "
          f"{r6['device_ms'] * 1e3:.3f} us, {r6['rel_err']:.3g} relative from its twin, "
          f"{r6['f32_max_abs_err']:.3g} from f32")
    return r, r6


def deeplab_phase():
    """The deeplab path: K1 at 257x257, K2', K2'' and the GEMM against their
    plain versions, then DEEPLAB_FRAMES frames of FramePipeline on cuda
    against the plain path, with every launch counter checked."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

    w, h = DEEPLAB_SIZE
    pipe = FramePipeline(DEEPLAB, PipelineConfig(width=w, height=h), device="cuda")
    e = pipe.maskgen.edge
    if e is None or e.prefix_plan is None or e.cont_plan is None:
        raise RuntimeError("the deeplab model did not take the prefix + continuation path")
    pre, cont = e.prefix_plan, e.cont_plan
    dils = sorted({p[8] for p in cont.plan if p[0] == "dw"})
    for name, plan in (("prefix", pre), ("continuation", cont)):
        mt = plan.mega
        print(f"deeplab {name}: {len(plan.plan)} plan ops -> {dict(plan.kernels_per_run)} a "
              f"run, {len(mt.ops)} table ops {dict(mt.kinds)} in {mt.phases} phases, "
              f"{mt.smem_bytes} B shared memory a CTA")
        if dict(plan.kernels_per_run) != {"bs_body_mega": 1}:
            raise AssertionError(f"the deeplab {name} is not one bs_body_mega launch a run")
    print(f"deeplab continuation depthwise dilations {dils}")
    if cont.mega.kinds["gemm"] == 0 or not {2, 4} <= set(dils) \
            or not any(m.get("bn") for m in cont.mega.ops):
        raise AssertionError("the continuation table lacks the GEMM, the broadcast "
                             "or the dilated depthwise convs")
    frames = _deeplab_held_out()
    res = {}
    with torch.no_grad():
        canvas, kw = e.canvas(frames[0]), e.front_kwargs()
        k1 = front_fused(canvas, e.front_params, **kw)
        res["front"] = _held("front", k1, front_plain(canvas, e.front_params, **kw),
                             lambda: front_fused(canvas, e.front_params, **kw),
                             lambda: front_plain(canvas, e.front_params, **kw))
        res["front"]["bound"] = bound(*front_work(kw, k1.shape[0]))
        res["front"]["device_ms"] = device_ms(lambda: front_fused(canvas, e.front_params, **kw))
        print(f"kernel front deeplab: device {res['front']['device_ms'] * 1e3:.3f} us, bound "
              f"{res['front']['bound'][0] * 1e3:.3f} us ({res['front']['bound'][1]})")
        x = k1.reshape(k1.shape[0], -1)
        before = collections.Counter(body_launch.by_kernel)
        k2, k2b = pre.run_cuda(x).clone(), pre.run_cuda(x)
        k3, k3b = cont.run_cuda(k2).clone(), cont.run_cuda(k2)
        torch.cuda.synchronize()
        if dict(body_launch.by_kernel - before) != {"bs_body_mega": 4}:
            raise AssertionError("a deeplab plan did not run as one bs_body_mega launch")
        if not (torch.equal(k2, k2b) and torch.equal(k3, k3b)):
            raise AssertionError("two runs of a deeplab table differ")
        res["body_prefix"] = _held("body_prefix", k2, pre.run_plain(x),
                                   lambda: pre.run_cuda(x), lambda: pre.run_plain(x))
        res["body_prefix"]["bound"] = bound(*pre.work())
        res["body_prefix"]["device_ms"] = device_ms(lambda: pre.run_cuda(x))
        # held to the plain plan in the kernel's own arithmetic (its GEMM ops
        # bf16x3); the f32 plain plan's distance is the precision gap
        res["body_cont"] = _held("body_cont", k3, cont.run_plain(k2, gemm="bf16x3"),
                                 lambda: cont.run_cuda(k2),
                                 lambda: cont.run_plain(k2, gemm="bf16x3"),
                                 atol=MATCHED_ATOL, rtol=MATCHED_RTOL)
        matched, f32 = cont.run_plain(k2, gemm="bf16x3"), cont.run_plain(k2)
        mean = float((k3 - matched).abs().mean())
        gap = float((k3 - f32).abs().max())
        # the twins' own noise floor: their input nudged by one ulp
        nudged = ulp_nudge(k2, 7)
        floor = float((cont.run_plain(nudged, gemm="bf16x3") - matched).abs().max())
        floor_f32 = float((cont.run_plain(nudged) - f32).abs().max())
        res["body_cont"].update(precision_gap=gap, mean_abs_err=mean)
        print(f"deeplab continuation: against run_plain(gemm='bf16x3') max_abs_err "
              f"{res['body_cont']['max_abs_err']:.3g} (allclose(atol={MATCHED_ATOL:g}, "
              f"rtol={MATCHED_RTOL:g})), mean {mean:.3g} (<= {MATCHED_MEAN:g}); precision gap "
              f"to the f32 plain plan {gap:.3g} (mean {float((k3 - f32).abs().mean()):.3g}); "
              f"a one-ulp nudge of the input moves the bf16x3 plain plan by {floor:.3g}, the "
              f"f32 one by {floor_f32:.3g}")
        if mean > MATCHED_MEAN:
            raise AssertionError(f"K2'' is {mean:.3g} from its matched twin on average")
        res["body_cont"]["bound"] = bound(*cont_work(cont))
        res["body_cont"]["device_ms"] = device_ms(lambda: cont.run_cuda(k2))
        print(f"deeplab tables, device time a run: prefix "
              f"{res['body_prefix']['device_ms'] * 1e3:.2f} us, continuation "
              f"{res['body_cont']['device_ms'] * 1e3:.2f} us")
        res["gemm"], res["gemm_highest"] = gemm_phase(cont, k2.device)

    launches, ms = _deeplab_frames(pipe, frames, "bf16x3", "deeplab")
    print("deeplab bounds: " + ", ".join(f"{k} {r['bound'][0]:.5f} ms ({r['bound'][1]})"
                                         for k, r in res.items()))
    return res, launches, ms


def _deeplab_held_out(n=DEEPLAB_FRAMES):
    """``n`` deeplab frames on the card held out from the synthetic model's
    fit (seed 0, frames 0-29): another seed's grain and frame indices 30
    on (the pose repeats every ~21 frames)."""
    import torch
    from make_synth_segm import moving_frames
    w, h = DEEPLAB_SIZE
    return [torch.from_numpy(f).cuda()
            for f in moving_frames(w, h, DEEPLAB_FRAMES + n, seed=1)[DEEPLAB_FRAMES:]]


def highest_phase(high_device_ms):
    """deeplab at "highest" (``precision="highest"``): the continuation's
    dots "bf16x6", its table ``body_mega_kernel<0, 6>`` with the six-term
    GEMM tile, the TPU's HIGHEST that the JAX flat continuation asks of
    dot_general.  K2'' on a held-out frame's prefix output: one launch, two
    runs bit-identical, against ``run_plain(gemm="bf16x6")`` (allclose(ATOL,
    RTOL) and the mean-abs bar: the six terms carry f32's rounding, so the
    f32 bars hold, and would pass three terms too), its distance to the
    f32 plain plan at most 1/SIX_TERM_RATIO of the three-term twin's, its
    device time beside the three-term table's (``high_device_ms``);
    then HIGHEST_FRAMES held-out frames of the pipeline against the plain
    path in the same arithmetic under the decode flip rule
    (``_deeplab_frames``).  Returns (kernels-line numbers, launches)."""
    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    w, h = DEEPLAB_SIZE
    pipe = FramePipeline(DEEPLAB, PipelineConfig(width=w, height=h), device="cuda",
                         precision="highest")
    e = pipe.maskgen.edge
    pre, cont = e.prefix_plan, e.cont_plan
    if (pre.dots, cont.dots) != ("f32", "bf16x6"):
        raise AssertionError(f"deeplab at highest: dots {pre.dots}, {cont.dots}")
    frames = _deeplab_held_out(HIGHEST_FRAMES)
    with torch.no_grad():
        k2 = pre.run_cuda(e.front(frames[0]).reshape(16, -1)).clone()
        k3, k3b = cont.run_cuda(k2).clone(), cont.run_cuda(k2)
        torch.cuda.synchronize()
        if not torch.equal(k3, k3b):
            raise AssertionError("two runs of the highest continuation differ")
        r = _held("body_cont_highest", k3, cont.run_plain(k2, gemm="bf16x6"),
                  lambda: cont.run_cuda(k2), lambda: cont.run_plain(k2, gemm="bf16x6"))
        six, three, f32 = (cont.run_plain(k2, g) for g in ("bf16x6", "bf16x3", "f32"))
        mean = float((k3 - six).abs().mean())
        if mean > MATCHED_MEAN:
            raise AssertionError(f"highest K2'' is {mean:.3g} from its twin on average")
        gap, gap3 = float((k3 - f32).abs().max()), float((three - f32).abs().max())
        if gap * SIX_TERM_RATIO > gap3:
            raise AssertionError(f"highest K2'' is {gap:.3g} from the f32 plain plan, not "
                                 f"1/{SIX_TERM_RATIO} of the three-term twin's {gap3:.3g}")
        r.update(mean_abs_err=mean, precision_gap=gap, three_term_gap=gap3,
                 device_ms=device_ms(lambda: cont.run_cuda(k2)),
                 three_term_device_ms=high_device_ms, bound=bound(*cont_work(cont)),
                 phases=cont.mega.phases)
    print(f"deeplab continuation at highest: {cont.mega.phases} phases, "
          f"{cont.mega.smem_bytes} B shared memory a CTA; against run_plain(gemm='bf16x6') "
          f"max_abs_err {r['max_abs_err']:.3g}, mean {mean:.3g}; to the f32 plain plan "
          f"{r['precision_gap']:.3g} (the three-term twin's {r['three_term_gap']:.3g}); "
          f"device {r['device_ms'] * 1e3:.2f} us a run (three terms "
          f"{high_device_ms * 1e3:.2f} us), bound {r['bound'][0] * 1e3:.3f} us "
          f"({r['bound'][1]})")
    launches, r["frame_ms"] = _deeplab_frames(pipe, frames, "bf16x6", "deeplab highest")
    return r, launches


def _deeplab_frames(pipe, frames, gemm, tag):
    """``frames`` of the deeplab ``pipe`` on the card from a fresh EMA,
    every launch counter checked (one K1, K2' and K2'' launch, one K3 and
    the continuation's GEMM table ops a frame, no other body kernel),
    against the plain path (K2'' in ``gemm`` arithmetic) frame by frame
    under the decode flip rule.  Returns (launches, host ms a frame)."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_yuyv, blend_pack_yuyv_plain
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    from backscrub_tpu_torch.pipeline.edge import front_fused, post_footprint

    e = pipe.maskgen.edge
    pre, cont = e.prefix_plan, e.cont_plan
    h, w = frames[0].shape[:2]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    for f in frames[:5]:
        pipe.step(f, bg)
    n = len(frames)
    want_kernels = {"bs_body_mega": 2 * n}
    want = dict(front=n, body_prefix=n, body_cont=n, pack=n, gemm=n * cont.mega.kinds["gemm"])

    def drive(keep):
        """One pass from a fresh EMA; with ``keep``, the outputs and the EMA
        after each frame."""
        pipe.reset()
        torch.cuda.synchronize()
        front_fused.launches = body_launch.launches = blend_pack_yuyv.launches = 0
        pre.launches = cont.launches = 0
        body_launch.by_kernel.clear()
        body_launch.table_ops.clear()
        outs = []
        for f in frames:
            out = pipe.step(f, bg)
            if keep:
                outs.append(out + (pipe.maskgen.ema.clone(),))
        torch.cuda.synchronize()
        counts = dict(front=front_fused.launches, body_prefix=pre.launches,
                      body_cont=cont.launches, pack=blend_pack_yuyv.launches,
                      gemm=body_launch.table_ops["gemm"])
        if counts != want or dict(body_launch.by_kernel) != want_kernels:
            raise AssertionError(f"launch counts {counts} {dict(body_launch.by_kernel)}, "
                                 f"expected {want} {want_kernels}")
        return counts, outs

    t0 = time.perf_counter()
    launches, _ = drive(keep=False)
    ms = (time.perf_counter() - t0) * 1e3 / n
    _, outs = drive(keep=True)
    print(f"{tag} launches by kernel over {n} frames: {dict(body_launch.by_kernel)}; "
          f"table ops run: {dict(body_launch.table_ops)}")

    # The plain path, frame by frame from the same fresh EMA.  A decode
    # decision may flip where class 15's margin is a near-tie (the two
    # paths sum in different orders); the flip moves that EMA pixel by up
    # to 224 for the frames the EMA carries it, and the mask and YUYV bytes
    # it reaches through the post by more than 1.  So: every flip must be a
    # near-tie (|margin| <= TIE in the plain logits); the EMAs must be equal
    # at every pixel whose decode never flipped; and outside the footprint
    # of the pixels where the EMAs differ, no mask or YUYV byte may be off
    # by more than 1.
    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device="cuda")
    ever = torch.zeros_like(ema, dtype=torch.bool)
    fracs, flips, flip_margin, masked = [], 0, 0.0, 0
    with torch.no_grad():
        for f, (yuyv, mask, ema_k) in zip(frames, outs):
            if yuyv.shape != (h, 2 * w) or mask.shape != (h, w):
                raise AssertionError(f"output shapes {yuyv.shape} {mask.shape}")
            logits = e.body(e.front(f, plain=True), plain=True, gemm=gemm).permute(1, 2, 0)
            ema = ema_update(ema, decode_val(logits, e.spec))
            rm = e.postprocess(ema)
            k, m = _flip_rule(ema_k, ema, _person_margin(logits), ever)
            flips, flip_margin = flips + k, max(flip_margin, m)
            foot = post_footprint(ema_k != ema, e.geo, e.post_mats)
            foot_yuyv = _yuyv_footprint(foot)
            masked += int(foot.sum()) + int(foot_yuyv.sum())
            fracs.append(_held_bytes([(yuyv, blend_pack_yuyv_plain(f, bg, rm)), (mask, rm)],
                                     f"{tag} fused path", [foot_yuyv, foot]))
    person = float((outs[-1][1] < 128).float().mean())
    print(f"pipeline {tag} {w}x{h}: {n} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized), launches {launches}, differing bytes vs plain path mean "
          f"{100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}% ({sum(map(bool, fracs))} "
          f"frames differ), decode flips against the matched plain path {flips} "
          f"(largest |margin| {flip_margin:.3g}), "
          f"bytes in the flips' footprint {masked} of {n * 3 * h * w} (none off by more "
          f"than 1 outside it), person fraction {person:.3f}")
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"{tag} outputs outside the tolerance invariant")
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    return launches, ms


def _counters():
    """Every kernel's launch counter: name -> (object holding ``launches``)."""
    from backscrub_tpu_torch.ops.image_kernels import bilateral5
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420, blend_pack_yuyv
    from backscrub_tpu_torch.pipeline.edge import front_fused
    return dict(front=front_fused, body=body_launch, pack=blend_pack_yuyv,
                pack_420=blend_pack_420, bilateral=bilateral5, jpeg_decode=decode_jpeg_bgr)


def _zero_counts():
    for c in _counters().values():
        c.launches = 0


def _counts():
    return {k: c.launches for k, c in _counters().items()}


def _canvas(mg, frame):
    """The classic preprocess's canvas before the bilateral: the K5 input."""
    from backscrub_tpu_torch.pipeline.maskgen import preprocess
    return preprocess(frame, mg.geo, dataclasses.replace(mg.spec, scale=1.0, offset=0.0),
                      use_bilateral=False).contiguous()


def _plain_input(mg, frame):
    """The classic preprocess with K5's plain version: the plain path's
    model input."""
    import torch
    from backscrub_tpu_torch.pipeline.image import bilateral5 as bilateral5_plain
    from backscrub_tpu_torch.pipeline.maskgen import normalize
    return normalize(torch.round(bilateral5_plain(_canvas(mg, frame))), mg.spec)


def bilateral_phase(segm, deeplab):
    """K5 against its plain version at the classic path's canvases: segm
    96x160, deeplab 257x257, and a batch of 4 deeplab canvases.  ``segm``
    and ``deeplab`` are the classic and staged phases' MaskGens at 640x480."""
    import torch
    from backscrub_tpu_torch.ops.image_kernels import bilateral5
    from backscrub_tpu_torch.pipeline.image import bilateral5 as bilateral5_plain
    from make_synth_segm import moving_frames

    w, h = CLASSIC_SIZE
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, 4)]
    cases = {"segm 96x160": _canvas(segm, frames[0]),
             "deeplab 257x257": _canvas(deeplab, frames[0]),
             "deeplab 4x257x257": torch.stack([_canvas(deeplab, f) for f in frames])}
    res = {}
    with torch.no_grad():
        for name, x in cases.items():
            k, p = bilateral5(x), bilateral5_plain(x)
            torch.cuda.synchronize()
            torch.testing.assert_close(k, p, atol=ATOL, rtol=RTOL)
            rd = (torch.round(k) - torch.round(p)).abs()
            if float(rd.max()) > 1:
                raise AssertionError(f"K5 {name}: a rounded byte off by {float(rd.max())}")
            px = x.numel() // 3
            r = dict(max_abs_err=float((k - p).abs().max()),
                     ms=timed(lambda: bilateral5(x)), plain_ms=timed(lambda: bilateral5_plain(x)),
                     device_ms=device_ms(lambda: bilateral5(x)),
                     device_ms_cold=device_ms(lambda: bilateral5(x), cold="bilateral_kernel"),
                     bound=bound(*bilateral_work(px)))
            print(f"kernel bilateral {name}: max_abs_err={r['max_abs_err']:.3g}, rounded "
                  f"bytes differing {100 * float((rd > 0).float().mean()):.4f}%, kernel "
                  f"{r['ms'][0]:.4f} ms (checksum {r['ms'][1]:.6g}) plain "
                  f"{r['plain_ms'][0]:.4f} ms (checksum {r['plain_ms'][1]:.6g}), device "
                  f"{r['device_ms'] * 1e3:.3f} us (cold {r['device_ms_cold'] * 1e3:.3f} us), "
                  f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
            res[name] = r
    return res


def _held_bytes(pairs, what, foot=None):
    """The tolerance invariant over (kernel, plain) u8 pairs of one frame:
    no byte off by more than 1 (outside ``foot``, where given: a bool mask
    a pair, the bytes that decode flips reach through the post), at most
    FRAME_TOL of the bytes differ.  Returns the frame's differing share."""
    import torch
    frac = float(torch.cat([(a != b).flatten() for a, b in pairs]).float().mean())
    worst = 0
    for (a, b), f in zip(pairs, foot or [None] * len(pairs)):
        d = (a.int() - b.int()).abs()
        worst = max(worst, int((d if f is None else torch.where(f, 0, d)).max()))
    if worst > 1 or frac > FRAME_TOL:
        raise AssertionError(f"{what}: max byte diff {worst}"
                             f"{'' if foot is None else ' outside the footprint of the flips'}, "
                             f"{100 * frac:.3f}% differ")
    return frac


def _flip_margin(ema_k, ema, margin):
    """The largest |margin| at a pixel whose decode bits (5-7) differ
    between ``ema_k`` and ``ema`` (0 where none do), and those pixels."""
    flipped = (ema_k >> 5) != (ema >> 5)
    return (float(margin[flipped].abs().max()) if flipped.any() else 0.0), flipped


def _flip_rule(ema_k, ema, margin, ever_flipped, tie=TIE):
    """The decode flip rule on one frame: ``ema_k`` the kernel path's EMA,
    ``ema`` the plain path's, ``margin`` the plain path's decode value less
    its threshold a pixel (the decision flips at 0).  Every pixel whose
    decode bits (5-7) differ must sit at |margin| <= ``tie``, and the EMAs
    must be equal wherever no decode has flipped (``ever_flipped``, updated
    in place).  Returns (flips, largest |margin| of a flip)."""
    import torch
    worst, flipped = _flip_margin(ema_k, ema, margin)
    ever_flipped |= flipped
    if not torch.equal(ema_k[~ever_flipped], ema[~ever_flipped]):
        raise AssertionError("the EMAs differ at a pixel whose decode never flipped")
    if worst > tie:
        raise AssertionError(f"a decode flip at |margin| {worst:.3g} is not a near-tie")
    return int(flipped.sum()), worst


def _person_margin(logits):
    """The argmax_person decode's margin (H, W): the person class's logit
    less the largest other one (the decision flips at 0)."""
    import torch
    others = torch.cat([logits[..., :PERSON], logits[..., PERSON + 1:]], -1)
    return logits[..., PERSON] - others.max(-1).values


def _yuyv_footprint(foot):
    """A frame's pixel footprint (H, W) as the bytes of its YUYV (H, 2W):
    a pixel pair's four bytes wherever either pixel is in it."""
    h, w = foot.shape
    return foot.reshape(h, w // 2, 2).any(-1)[..., None].expand(h, w // 2, 4).reshape(h, 2 * w)


def classic_pipeline():
    """The classic segm path with NV12 out at CLASSIC_SIZE on the card."""
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    w, h = CLASSIC_SIZE
    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h, edge_fused=False,
                                               output_format="nv12"), device="cuda")
    if pipe.maskgen.edge is not None:
        raise AssertionError("edge_fused=False took the fused edge path")
    return pipe


def classic_phase(pipe):
    """The classic path on the card: CLASSIC_FRAMES frames of ``pipe``
    (NV12 out), then I420, then a horizontal flip (no K4: the JAX package's
    gate), each held against the plain path (K5's and K4's plain
    versions)."""
    import torch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420_plain
    from backscrub_tpu_torch.pipeline.image import alpha_blend_u8
    from make_synth_segm import moving_frames

    w, h = CLASSIC_SIZE
    n = CLASSIC_FRAMES
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()

    def drive(frs, keep, flip_h=False):
        pipe.reset()
        torch.cuda.synchronize()
        _zero_counts()
        outs = []
        for f in frs:
            out = pipe.step(f, bg, flip_horizontal=flip_h)
            if keep:
                outs.append(out)
        torch.cuda.synchronize()
        return _counts(), outs

    def check(frs, outs, flip_h):
        mg = pipe.maskgen
        ema = torch.full(mg.ema_shape, 255, dtype=torch.uint8, device="cuda")
        fracs = []
        with torch.no_grad():
            for f, (out, mask) in zip(frs, outs):
                rm, ema = mg._decode_post(mg._infer(_plain_input(mg, f)), ema)
                ro = (pipe.finish(alpha_blend_u8(bg, f, rm), True, False) if flip_h
                      else blend_pack_420_plain(f, bg, rm, pipe.cfg.output_format))
                if out.shape != ro.shape or out.dtype != torch.uint8:
                    raise AssertionError(f"output shape {tuple(out.shape)} {out.dtype}")
                fracs.append(_held_bytes([(out, ro), (mask, rm)], "classic path"))
        if not torch.equal(mg.ema, ema):
            raise AssertionError("the classic path's EMA differs from the plain path's")
        if float(np.mean(fracs)) > MEAN_TOL:
            raise AssertionError(f"{100 * np.mean(fracs):.4f}% of bytes differ on average")
        return fracs

    for f in frames[:5]:                 # warm-up
        pipe.step(f, bg)
    t0 = time.perf_counter()
    launches, _ = drive(frames, keep=False)
    ms = (time.perf_counter() - t0) * 1e3 / n
    want = dict(front=0, body=0, pack=0, pack_420=n, bilateral=n, jpeg_decode=0)
    if launches != want:
        raise AssertionError(f"classic launch counts {launches}, expected {want}")
    counts, outs = drive(frames, keep=True)
    fracs = check(frames, outs, False)
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    print(f"pipeline classic nv12 {w}x{h}: {n} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized), launches {launches}, differing bytes vs plain path mean "
          f"{100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}%, person fraction "
          f"{person:.3f}")
    # the variants reuse the pipeline: I420 by its config (the output
    # format is read per step), the flip by the per-step override
    m = VARIANT_FRAMES
    nv12 = pipe.cfg
    for fmt, flip_h, k4 in (("i420", False, m), ("nv12", True, 0)):
        pipe.cfg = dataclasses.replace(nv12, output_format=fmt)
        counts, outs = drive(frames[:m], keep=True, flip_h=flip_h)
        if counts != dict(want, pack_420=k4, bilateral=m):
            raise AssertionError(f"launch counts {counts} with {fmt}, flip_h={flip_h}")
        fracs = check(frames[:m], outs, flip_h)
        print(f"pipeline classic {fmt} flip_horizontal={flip_h}: {m} frames, launches "
              f"{counts}, differing bytes max {100 * max(fracs):.4f}%")
    pipe.cfg = nv12
    return launches, ms


def pack420_shapes():
    """K4 byte-identical to its plain version, NV12 and I420, where its
    vector path does not cover the frame: 42x58 and 480x642 (W % 4 == 2:
    every block per-block) and a 480x642 frame that is a view one row into
    a larger one (off a 4-byte boundary, 1926 bytes in)."""
    import torch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_420, blend_pack_420_plain
    cases = []
    for h, w in ((42, 58), (480, 642), (481, 642)):
        rng = np.random.default_rng(h + w)
        fr, bg = (torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8)).cuda()
                  for _ in range(2))
        m = rng.integers(0, 256, (h, w), np.uint8)
        m[: h // 4], m[h // 4: h // 2] = 255, 0
        cases.append((f"{h}x{w}", fr, bg, torch.from_numpy(m).cuda()))
    name, fr, bg, m = cases.pop()
    cases.append(("480x642 view off a word boundary", fr[1:], bg[1:], m[1:]))
    if fr[1:].data_ptr() % 4 == 0 or not fr[1:].is_contiguous():
        raise AssertionError("the view is not a contiguous frame off a word boundary")
    for name, fr, bg, m in cases:
        for layout in ("nv12", "i420"):
            if not torch.equal(blend_pack_420(fr, bg, m, layout),
                               blend_pack_420_plain(fr, bg, m, layout)):
                raise AssertionError(f"K4 differs from its plain version ({name}, {layout})")
    print("kernel pack_420: byte-identical to plain, NV12 and I420, at "
          + ", ".join(c[0] for c in cases))


def fused_420_phase():
    """The default (fused) segm path with NV12 out at CLASSIC_SIZE on the
    card: FUSED_420_FRAMES frames, each one K1, one K2 (``bs_body_mega``)
    and one K4 launch and no K3 or K5; output and mask held against the
    plain path (K1, K2 and K4 by their plain versions) under the tolerance
    invariant; then one I420 frame on the same pipeline."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    w, h = CLASSIC_SIZE
    n = FUSED_420_FRAMES
    pipe = FramePipeline(MODEL, PipelineConfig(width=w, height=h, output_format="nv12"),
                         device="cuda")
    if pipe.maskgen.edge is None or pipe.maskgen.edge.body_plan is None:
        raise AssertionError("the default nv12 pipeline did not take the fused path")
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()
    for f in frames[:3]:                 # warm-up
        pipe.step(f, bg)
    want = dict(front=1, body=1, pack=0, pack_420=1, bilateral=0, jpeg_decode=0)

    def drive(frs):
        """Frames from a fresh EMA, the launch counts checked frame by
        frame; returns the outputs and the summed counts."""
        pipe.reset()
        torch.cuda.synchronize()
        outs, total = [], collections.Counter()
        for f in frs:
            _zero_counts()
            body_launch.by_kernel.clear()
            outs.append(pipe.step(f, bg))
            counts = _counts()
            if counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": 1}:
                raise AssertionError(f"fused {pipe.cfg.output_format} launch counts a frame "
                                     f"{counts} {dict(body_launch.by_kernel)}, expected {want}")
            total.update(counts)
        torch.cuda.synchronize()
        return outs, {k: total[k] for k in want}

    def check(frs, outs):
        ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device="cuda")
        fracs = []
        with torch.no_grad():
            for f, (out, mask) in zip(frs, outs):
                ro, rm, ema = plain_step(pipe, f, bg, ema, pipe.cfg.output_format)
                if out.shape != ro.shape or out.dtype != torch.uint8:
                    raise AssertionError(f"output shape {tuple(out.shape)} {out.dtype}")
                fracs.append(_held_bytes([(out, ro), (mask, rm)], "fused 4:2:0 path"))
        if float(np.mean(fracs)) > MEAN_TOL:
            raise AssertionError(f"{100 * np.mean(fracs):.4f}% of bytes differ on average")
        return fracs

    t0 = time.perf_counter()
    outs, launches = drive(frames)
    ms = (time.perf_counter() - t0) * 1e3 / n
    fracs = check(frames, outs)
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate mask: person fraction {person}")
    print(f"pipeline fused nv12 {w}x{h}: {n} frames, {ms:.4f} ms/frame (host clock, "
          f"synchronized, launch counts read a frame), launches {launches}, differing "
          f"bytes vs plain path mean {100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}%, "
          f"person fraction {person:.3f}")
    nv12 = pipe.cfg
    pipe.cfg = dataclasses.replace(nv12, output_format="i420")
    outs, counts = drive(frames[:1])
    fracs = check(frames[:1], outs)
    pipe.cfg = nv12
    print(f"pipeline fused i420 {w}x{h}: 1 frame, launches {counts}, differing bytes "
          f"{100 * fracs[0]:.4f}%")
    return launches, ms


def staged_maskgen(calls, path=DEEPLAB, tag="deeplab"):
    """The staged MaskGen of ``path`` (a 257x257 model) at DEEPLAB_SIZE on
    the card, its hooks appending to ``calls``."""
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    w, h = DEEPLAB_SIZE
    mg = MaskGen(path, w, h, fused=False, device="cuda",
                 onprep=lambda: calls.append("prep"), oninfer=lambda: calls.append("infer"),
                 onmask=lambda: calls.append("mask"))
    if mg.edge is not None or tuple(mg.model.input_shape[1:3]) != (257, 257):
        raise AssertionError(f"the staged {tag} MaskGen is not the classic 257x257 path")
    return mg


def staged_phase(mg, calls, tag="deeplab", margin=_person_margin):
    """STAGED_FRAMES frames of the staged MaskGen ``mg`` (fused=False,
    stage hooks appending to ``calls``): one K5 launch a frame, hooks in
    order, masks against the plain path under the decode flip rule
    (``margin`` of the model output; deeplab's person margin by default)."""
    import torch
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    from backscrub_tpu_torch.pipeline.edge import post_footprint, postprocess_mask
    from make_synth_segm import moving_frames

    w, h = DEEPLAB_SIZE
    n = STAGED_FRAMES
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    for f in frames[:2]:
        mg.process(f)
    mg.reset()
    torch.cuda.synchronize()
    calls.clear()
    _zero_counts()
    t0 = time.perf_counter()
    outs = [(mg.process(f), mg.ema.clone()) for f in frames]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    launches = _counts()
    if launches != dict(front=0, body=0, pack=0, pack_420=0, bilateral=n, jpeg_decode=0):
        raise AssertionError(f"staged launch counts {launches}")
    if calls != ["prep", "infer", "mask"] * n:
        raise AssertionError(f"stage hooks fired as {calls[:6]}...")
    ema = torch.full(mg.ema_shape, 255, dtype=torch.uint8, device=mg.device)
    ever = torch.zeros_like(ema, dtype=torch.bool)
    flips, flip_margin, fracs = 0, 0.0, []
    with torch.no_grad():
        for f, (mask, ema_k) in zip(frames, outs):
            logits = mg._infer(_plain_input(mg, f))
            ema = ema_update(ema, decode_val(logits, mg.spec))
            rm = postprocess_mask(ema, mg.geo, mg.post_mats)
            k, m = _flip_rule(ema_k, ema, margin(logits), ever)
            flips, flip_margin = flips + k, max(flip_margin, m)
            foot = post_footprint(ema_k != ema, mg.geo, mg.post_mats)
            fracs.append(_held_bytes([(mask, rm)], f"staged {tag} path", [foot]))
    print(f"staged {tag} {w}x{h}: {n} frames, {ms:.4f} ms/frame (host clock, synchronized), "
          f"launches {launches}, hooks in order, decode flips {flips} (largest |margin| "
          f"{flip_margin:.3g}), mask bytes differing mean {100 * np.mean(fracs):.4f}% max "
          f"{100 * max(fracs):.4f}%, none off by more than 1 outside the flips' footprint")
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"staged {tag} masks outside the tolerance invariant")
    return dict(ms_per_frame=ms, flips=flips, flip_margin=flip_margin)


def _window(step, frames, n):
    """A profiled window of ``n`` steps, opened by an uncounted
    ``torch.cuda._sleep`` (the profiler leaves out a window's first
    kernel): (device busy ms a frame, the profiler's device time (kernels,
    copies) summed; device operations a frame; {name: device us a frame})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for i in range(n):
            step(frames[i % len(frames)])
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    busy = sum(e.self_device_time_total for e in ev)
    return (busy / 1e3 / n, sum(e.count for e in ev) / n,
            {e.key: e.self_device_time_total / n for e in ev})


def _kernel_us(by_name, name):
    """Device us a frame of the kernels whose name holds ``name``."""
    return sum(t for k, t in by_name.items() if name in k)


def _logit_margin(out):
    """The selfie decode's margin on the model's probability (H, W, 1): its
    logit less logit(0.65), float64 (the decision flips at 0)."""
    import torch
    p = out[..., 0].double()
    return torch.log(p / (1 - p)) - float(np.log(0.65 / 0.35))


def _threshold_margin(out):
    """BodyPix's decode margin on the model's logit (H, W, 1): less 0.65."""
    return out[..., 0] - 0.65


def _two_channel_margin(out):
    """The two-channel decode's margin (H, W, 2): out1 - out0."""
    return out[..., 1] - out[..., 0]


def _edge_plain(e, frame, ema, margin):
    """The fused path's mask chain on the plain versions: (the decode's
    margin a pixel, new EMA); the tail's value less its threshold, or front
    only ``margin`` of the model output."""
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    body = e.body(e.front(frame, plain=True), plain=True)
    if e.info.tail_ok:
        body = body.reshape(body.shape[0], -1)
        return e.tail_logits(body) - e.info.tail_threshold, e.tail(body, ema)
    out = body.permute(1, 2, 0)
    return margin(out), ema_update(ema, decode_val(out, e.spec))


def _nv12_footprint(foot):
    """A frame's pixel footprint (H, W) as the bytes of its NV12 (3H/2, W):
    the Y plane a pixel, the chroma rows a 2x2 block."""
    import torch
    h, w = foot.shape
    uv = foot.reshape(h // 2, 2, w // 2, 2).any(3).any(1)
    return torch.cat([foot, uv[..., None].expand(h // 2, w // 2, 2).reshape(h // 2, w)])


def device_kernels(fn, n=20, warmup=3):
    """(device ms a call, device operations a call) of ``fn`` over a
    profiled window of ``n`` calls (``_window``'s)."""
    for _ in range(warmup):
        fn()
    busy, ops, _ = _window(lambda _: fn(), [None], n)
    return busy, ops


def _plan_checks(tag, r, plan, k1):
    """The fused path's body plan on K1's output ``k1``: one bs_body_mega
    launch a run, against its plain version (allclose), two runs
    bit-identical; its device time, bound and phases by the device clock
    into ``r``.  Returns the executor remainder's input (1, rows, w, c)."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    with torch.no_grad():
        x = k1.reshape(k1.shape[0], -1)
        before = collections.Counter(body_launch.by_kernel)
        k2, k2b = plan.run_cuda(x).clone(), plan.run_cuda(x)
        p2 = plan.run_plain(x)
        torch.cuda.synchronize()
        if dict(body_launch.by_kernel - before) != {"bs_body_mega": 2}:
            raise AssertionError(f"the {tag} body did not run as one bs_body_mega launch a run")
        torch.testing.assert_close(k2, p2, atol=ATOL, rtol=RTOL)
        if not torch.equal(k2, k2b):
            raise AssertionError(f"two {tag} body runs differ")
        phases = np.median(np.array([plan.phase_ns(x) for _ in range(10)]), axis=0)
        r.update(body_err=float((k2 - p2).abs().max()),
                 body_us=device_ms(lambda: plan.run_cuda(x)) * 1e3,
                 body_bound_us=bound(*plan.work())[0] * 1e3,
                 phases=plan.mega.phases, table_ops=len(plan.mega.ops),
                 phase_us=[round(float(t) / 1e3, 3) for t in phases])
    m = plan.out_meta
    return p2.reshape(m.c, m.rows, m.w).permute(1, 2, 0)[None]


def family_fused(tag, path, w, h, fmt="yuyv", margin=None, body_plan=True):
    """A model family's fused path at one frame size: FramePipeline on
    ``path`` with ``fmt`` out (YUYV: K3, else K4).  The body is one plan:
    the full span (K2, the tail after it) or the prefix (K2', the graph
    executor over the rest, the decode by ``margin`` of the model output);
    with ``body_plan`` False, a model that no plan compiles for (a model
    of the user's own): the graph executor over the whole body after K1.
    K1 and the plan against their plain versions on the first frame
    (allclose, the plan one launch, two runs bit-identical), their and the
    pack's device times and bounds, the plan's phases by the device clock,
    the executor remainder's device time and operations a call; then
    FAMILY_FRAMES frames from a fresh EMA, one K1, one plan (``bs_body_mega``)
    and one pack launch a frame and no other kernel of the port's (counted
    frame by frame), held against the plain path under the decode flip
    rule and the tolerance invariant; host-clock ms/frame, device busy and
    operations a frame, the pack's device time in the pipeline and the
    idle share; the launches by kernel over the counted frames."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                      blend_pack_yuyv, blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain, post_footprint
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    pipe = FramePipeline(path, PipelineConfig(width=w, height=h, output_format=fmt),
                         device="cuda")
    e = pipe.maskgen.edge
    if not body_plan:
        if e is None or e.plans or e.rest is None or e.info.tail_ok:
            raise AssertionError(f"{tag} did not take K1 and the executor over the body")
    elif e is None or (e.body_plan is None) == (e.prefix_plan is None) or e.cont_plan is not None:
        raise AssertionError(f"{tag} did not take the fused path with one body plan")
    plan, n, yuyv = e.body_plan or e.prefix_plan, FAMILY_FRAMES, fmt == "yuyv"
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()

    def pack(f, mask):
        return blend_pack_yuyv(f, bg, mask) if yuyv else blend_pack_420(f, bg, mask, fmt)

    def pack_plain(f, mask):
        return (blend_pack_yuyv_plain(f, bg, mask) if yuyv
                else blend_pack_420_plain(f, bg, mask, fmt))

    r = dict(plan="K2" if e.body_plan is not None else "K2'" if plan else "executor")
    with torch.no_grad():
        canvas, kw = e.canvas(frames[0]), e.front_kwargs()
        k1 = front_fused(canvas, e.front_params, **kw)
        p1 = front_plain(canvas, e.front_params, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(k1, p1, atol=ATOL, rtol=RTOL)
        r.update(front_err=float((k1 - p1).abs().max()),
                 front_us=device_ms(lambda: front_fused(canvas, e.front_params, **kw)) * 1e3,
                 front_bound_us=bound(*front_work(kw, k1.shape[0]))[0] * 1e3)
    if plan is not None:
        rest_in = _plan_checks(tag, r, plan, k1)
    else:
        rest_in = p1.permute(1, 2, 0)[None]
    with torch.no_grad():
        mask0 = e.postprocess(_edge_plain(e, frames[0], pipe.maskgen.ema, margin)[1])
        r.update(pack_us=device_ms(lambda: pack(frames[0], mask0)) * 1e3,
                 pack_bound_us=bound(*(pack_yuyv_work if yuyv else pack_420_work)(h, w))[0]
                 * 1e3)
        if e.rest is not None:
            rest_ms, r["rest_ops"] = device_kernels(lambda: e.rest(rest_in))
            r["rest_us"] = rest_ms * 1e3
    for f in frames[:5]:                 # warm-up
        pipe.step(f, bg)
    want = dict(front=1, body=int(plan is not None), pack=int(yuyv), pack_420=int(not yuyv),
                bilateral=0, jpeg_decode=0)
    want_body = {"bs_body_mega": 1} if plan is not None else {}
    total = collections.Counter()

    def drive():
        pipe.reset()
        torch.cuda.synchronize()
        outs = []
        for f in frames:
            _zero_counts()
            body_launch.by_kernel.clear()
            out = pipe.step(f, bg)
            outs.append(out + (pipe.maskgen.ema.clone(),))
            counts = _counts()
            if counts != want or dict(body_launch.by_kernel) != want_body:
                raise AssertionError(f"{tag} fused {fmt} launch counts a frame {counts} "
                                     f"{dict(body_launch.by_kernel)}, expected {want}")
            total.update(counts)
        torch.cuda.synchronize()
        return outs

    pipe.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        pipe.step(f, bg)
    torch.cuda.synchronize()
    r["ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / n
    busy, ops, by_name = _window(lambda f: pipe.step(f, bg), frames, FAMILY_WINDOW)
    r.update(busy_ms_per_frame=busy, ops_per_frame=ops,
             idle_share=1 - busy / r["ms_per_frame"],
             pack_pipeline_us=_kernel_us(by_name, "blend_pack_yuyv_kernel" if yuyv
                                         else "blend_pack_420_kernel"))
    outs = drive()
    ema = torch.full(pipe.maskgen.ema_shape, 255, dtype=torch.uint8, device=pipe.device)
    ever = torch.zeros_like(ema, dtype=torch.bool)
    fracs, flips, flip_margin = [], 0, 0.0
    with torch.no_grad():
        for f, (out, mask, ema_k) in zip(frames, outs):
            if out.shape != pack_plain(f, mask).shape or mask.shape != (h, w):
                raise AssertionError(f"output shapes {out.shape} {mask.shape}")
            mrg, ema = _edge_plain(e, f, ema, margin)
            k, mm = _flip_rule(ema_k, ema, mrg, ever)
            flips, flip_margin = flips + k, max(flip_margin, mm)
            rm = e.postprocess(ema)
            foot = post_footprint(ema_k != ema, e.geo, e.post_mats)
            fracs.append(_held_bytes([(out, pack_plain(f, rm)), (mask, rm)],
                                     f"{tag} fused path",
                                     [_yuyv_footprint(foot) if yuyv else _nv12_footprint(foot),
                                      foot]))
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"{tag}: {100 * np.mean(fracs):.4f}% of bytes differ on average")
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate {tag} mask: person fraction {person}")
    r.update(flips=flips, flip_margin=flip_margin, mean_diff=float(np.mean(fracs)),
             max_diff=max(fracs), person=person, launches=dict(total))
    pk = "K3" if yuyv else "K4"
    rest = (f", executor {'remainder' if plan else 'body'} {r['rest_us']:.2f} us in "
            f"{r['rest_ops']:.0f} device operations a call" if "rest_us" in r else "")
    body = (f", {r['plan']} {r['body_us']:.2f} us in {r['phases']} phases (bound "
            f"{r['body_bound_us']:.3f})" if plan else "")
    errs = (f"K1/{r['plan']} max_abs_err {r['front_err']:.3g} / {r['body_err']:.3g}" if plan
            else f"K1 max_abs_err {r['front_err']:.3g}")
    print(f"{tag} fused {fmt} {w}x{h}: K1 {r['front_us']:.3f} us (bound "
          f"{r['front_bound_us']:.3f}){body}{rest}, {pk} {r['pack_us']:.3f} us alone "
          f"(bound {r['pack_bound_us']:.3f}), {r['pack_pipeline_us']:.3f} in the pipeline; "
          f"{errs}; {n} frames, "
          f"{r['ms_per_frame']:.4f} ms/frame (host clock), device busy "
          f"{r['busy_ms_per_frame']:.4f} ms/frame in {r['ops_per_frame']:.1f} device "
          f"operations, idle share {r['idle_share']:.3f}; one K1, "
          f"{r['plan'] + ', ' if plan else ''}{pk} launch a "
          f"frame; vs plain path: decode flips {flips} (largest |margin| {flip_margin:.3g}), "
          f"differing bytes mean {100 * r['mean_diff']:.4f}% max {100 * r['max_diff']:.4f}%, "
          f"person fraction {person:.3f}")
    if plan:
        print(f"{tag} {r['plan']} {w}x{h} phases by the device clock (median of 10 runs, us): "
              f"{r['phase_us']}")
    return r


def family_classic(tag, path, margin, fmt="nv12", **mode):
    """A model family's classic path at CLASSIC_SIZE with ``fmt`` out (NV12
    the path the C ABI's staged MaskGen takes when hooks are set): K5 at
    the model's canvas, the graph executor, the decode, the post, K4 (K3
    for YUYV).  FAMILY_FRAMES frames timed on the host clock, then again
    from a fresh EMA with one K5 and one pack launch a frame and no other
    kernel of the port's (counted frame by frame), held against the plain
    path (K5's and the pack's plain versions) under the decode flip rule
    (``margin`` of the model output) and the tolerance invariant; K5
    against its plain version at the model's canvas, K5's and the pack's
    device times alone and in the pipeline beside their bounds, host-clock
    ms/frame, device busy and operations a frame, the idle share and the
    launches by kernel over the counted frames.  ``mode``: the pipeline's
    precision arguments (``quantize="int8"``)."""
    import torch
    from backscrub_tpu_torch.ops.image_kernels import bilateral5
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                      blend_pack_yuyv, blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.edge import post_footprint
    from backscrub_tpu_torch.pipeline.image import bilateral5 as bilateral5_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    w, h = CLASSIC_SIZE
    n, yuyv = FAMILY_FRAMES, fmt == "yuyv"
    pk = "k3" if yuyv else "k4"
    pipe = FramePipeline(path, PipelineConfig(width=w, height=h, edge_fused=False,
                                              output_format=fmt), device="cuda", **mode)
    mg = pipe.maskgen
    if mg.edge is not None:
        raise AssertionError(f"the {tag} classic path took the fused edge path")
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (h, w, 3), np.uint8)).cuda()

    def pack(f, mask):
        return blend_pack_yuyv(f, bg, mask) if yuyv else blend_pack_420(f, bg, mask, fmt)

    def pack_plain(f, mask):
        return (blend_pack_yuyv_plain(f, bg, mask) if yuyv
                else blend_pack_420_plain(f, bg, mask, fmt))

    with torch.no_grad():
        canvas = _canvas(mg, frames[0])
        k5, p5 = bilateral5(canvas), bilateral5_plain(canvas)
        torch.cuda.synchronize()
        torch.testing.assert_close(k5, p5, atol=ATOL, rtol=RTOL)
        if float((torch.round(k5) - torch.round(p5)).abs().max()) > 1:
            raise AssertionError(f"K5 at the {tag} canvas: a rounded byte off by more than 1")
        mask0 = mg._decode_post(mg._infer(_plain_input(mg, frames[0])), mg.ema)[0]
        px = canvas.numel() // 3
        r = {"k5_err": float((k5 - p5).abs().max()),
             "k5_us": device_ms(lambda: bilateral5(canvas)) * 1e3,
             "k5_bound_us": bound(*bilateral_work(px))[0] * 1e3,
             f"{pk}_us": device_ms(lambda: pack(frames[0], mask0)) * 1e3,
             f"{pk}_bound_us": bound(*(pack_yuyv_work if yuyv else pack_420_work)(h, w))[0]
             * 1e3}
    for f in frames[:3]:
        pipe.step(f, bg)
    busy, ops, by_name = _window(lambda f: pipe.step(f, bg), frames, FAMILY_WINDOW)
    r.update({"busy_ms_per_frame": busy, "ops_per_frame": ops,
              "k5_pipeline_us": _kernel_us(by_name, "bilateral_kernel"),
              f"{pk}_pipeline_us": _kernel_us(by_name, "blend_pack_yuyv_kernel" if yuyv
                                              else "blend_pack_420_kernel")})
    pipe.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        pipe.step(f, bg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    pipe.reset()
    want = dict(front=0, body=0, pack=int(yuyv), pack_420=int(not yuyv), bilateral=1,
                jpeg_decode=0)
    outs, total = [], collections.Counter()
    for f in frames:
        _zero_counts()
        outs.append(pipe.step(f, bg) + (mg.ema.clone(),))
        if _counts() != want:
            raise AssertionError(f"{tag} classic {fmt} launch counts a frame {_counts()}, "
                                 f"expected {want}")
        total.update(_counts())
    torch.cuda.synchronize()
    ema = torch.full(mg.ema_shape, 255, dtype=torch.uint8, device=mg.device)
    ever = torch.zeros_like(ema, dtype=torch.bool)
    fracs, flips, flip_margin = [], 0, 0.0
    with torch.no_grad():
        for f, (out, mask, ema_k) in zip(frames, outs):
            y = mg._infer(_plain_input(mg, f))
            rm, ema = mg._decode_post(y, ema)
            k, m = _flip_rule(ema_k, ema, margin(y), ever)
            flips, flip_margin = flips + k, max(flip_margin, m)
            foot = post_footprint(ema_k != ema, mg.geo, mg.post_mats)
            ro = pack_plain(f, rm)
            if out.shape != ro.shape or out.dtype != torch.uint8:
                raise AssertionError(f"output shape {tuple(out.shape)} {out.dtype}")
            fracs.append(_held_bytes([(out, ro), (mask, rm)], f"{tag} classic path",
                                     [_yuyv_footprint(foot) if yuyv else _nv12_footprint(foot),
                                      foot]))
    if float(np.mean(fracs)) > MEAN_TOL:
        raise AssertionError(f"{tag} classic: {100 * np.mean(fracs):.4f}% of bytes differ "
                             f"on average")
    person = float((outs[-1][1] < 128).float().mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate {tag} mask: person fraction {person}")
    r.update(ms_per_frame=ms, idle_share=1 - r["busy_ms_per_frame"] / ms, flips=flips,
             flip_margin=flip_margin, launches=dict(total))
    print(f"{tag} classic {fmt} {w}x{h}: K5 at the {canvas.shape[0]}x{canvas.shape[1]} canvas "
          f"{r['k5_us']:.3f} us alone (bound {r['k5_bound_us']:.3f}, max_abs_err "
          f"{r['k5_err']:.3g}), {r['k5_pipeline_us']:.3f} in the pipeline; {pk.upper()} "
          f"{r[pk + '_us']:.3f} us alone (bound {r[pk + '_bound_us']:.3f}), "
          f"{r[pk + '_pipeline_us']:.3f} in the pipeline; "
          f"{n} frames, {ms:.4f} ms/frame (host clock), device busy "
          f"{r['busy_ms_per_frame']:.4f} ms/frame in {r['ops_per_frame']:.1f} device "
          f"operations, idle share {r['idle_share']:.3f}; one K5 and one {pk.upper()} launch a "
          f"frame; vs plain path: decode flips {flips} (largest |margin| {flip_margin:.3g}), "
          f"differing bytes mean {100 * np.mean(fracs):.4f}% max {100 * max(fracs):.4f}%, "
          f"person fraction {person:.3f}")
    return r


def selfie_phase():
    """The default family (mlkit selfie, synthetic) through K1, K2, the
    threshold tail and K3 at both frame sizes, then its classic NV12 path.
    Returns the numbers by run."""
    res = {f"fused {w}x{h}": family_fused("selfie", SELFIE, w, h) for w, h in SIZES}
    res["classic nv12 {}x{}".format(*CLASSIC_SIZE)] = family_classic("selfie", SELFIE,
                                                                     _logit_margin)
    return res


def segm_full_phase():
    """segm_full (Meet full, synthetic, 144x256) through K1, K2, the
    two-channel tail and K3 at both frame sizes, K4 in place of K3 at
    640x480 (fused NV12), then its classic NV12 path.  Returns the numbers
    by run."""
    res = {f"fused yuyv {w}x{h}": family_fused("segm_full", SEGM_FULL, w, h) for w, h in SIZES}
    size = "{}x{}".format(*CLASSIC_SIZE)
    res[f"fused nv12 {size}"] = family_fused("segm_full", SEGM_FULL, *CLASSIC_SIZE, fmt="nv12")
    res[f"classic nv12 {size}"] = family_classic("segm_full", SEGM_FULL, _two_channel_margin)
    return res


def bodypix_phase():
    """BodyPix (synthetic, 257x257 in, 33x33 logit out) through K1, K2'
    alone, the executor over the dilated remainder, the threshold decode,
    the two-stage post and K3 at both frame sizes; then its classic NV12
    path and its staged MaskGen with hooks at 640x480.  Returns the numbers
    by run."""
    res = {f"fused yuyv {w}x{h}": family_fused("bodypix", BODYPIX, w, h,
                                               margin=_threshold_margin) for w, h in SIZES}
    size = "{}x{}".format(*CLASSIC_SIZE)
    res[f"classic nv12 {size}"] = family_classic("bodypix", BODYPIX, _threshold_margin)
    calls = []
    mg = staged_maskgen(calls, BODYPIX, "bodypix")
    res[f"staged {size}"] = staged_phase(mg, calls, "bodypix", _threshold_margin)
    return res


def _serving_window(loop, frames, n):
    """A profiled window of ``loop.run`` over ``n`` frames (null sink),
    opened by an uncounted ``torch.cuda._sleep``: (host ms a frame between
    two synchronizations, device busy ms a frame, the profiler's kernel and
    copy time summed)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    it = iter(frames[:n])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if loop.run(lambda: next(it, None), lambda a: None) != n:
            raise AssertionError("the serving loop did not take every frame")
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / n
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key)
    return host, busy / 1e3 / n


def cli_phase():
    """The program on the card: ``cli.main`` in each of CLI_MODES at
    CLI_SIZE on the default family (synthetic mlkit), every output file
    byte-identical to direct ``step`` calls and every kernel of the path
    launched once a frame; then the loop's numbers beside a bare ``step``
    loop's.  Returns the numbers by run."""
    import contextlib
    import io
    import tempfile
    import torch
    from backscrub_tpu_torch import cli
    from backscrub_tpu_torch.io.streams import SyntheticSource
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.runtime.serving import ServingLoop

    (w, h), n = CLI_SIZE, CLI_FRAMES
    src = SyntheticSource(w, h)
    frames = [src.read() for _ in range(n)]
    pipes = {fmt: FramePipeline(SELFIE, PipelineConfig(width=w, height=h, output_format=fmt),
                                device="cuda") for fmt in ("yuyv", "nv12")}
    golden = {fmt: b"".join(p.step(f)[0].cpu().numpy().tobytes() for f in frames)
              for fmt, p in pipes.items()}
    pipe = pipes["yuyv"]
    pipe.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in frames:
        pipe.step(f)
    torch.cuda.synchronize()
    res = {"bare step loop": {"ms_per_frame": (time.perf_counter() - t0) * 1e3 / n}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in CLI_MODES:
            fmt = "nv12" if "nv12" in extra else "yuyv"
            out, stats = os.path.join(tmp, f"{name}.yuv"), os.path.join(tmp, f"{name}.jsonl")
            argv = ["-c", "test:", "--cg", f"{w}x{h}", "-m", SELFIE, "--frames", str(n),
                    "-v", f"file:{out}", "--stats-json", stats, *extra]
            err = io.StringIO()
            _zero_counts()
            body_launch.by_kernel.clear()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            counts = _counts()
            sys.stderr.write(err.getvalue())
            want = dict(front=n, body=n, pack=n * (fmt == "yuyv"),
                        pack_420=n * (fmt == "nv12"), bilateral=0, jpeg_decode=0)
            if rc != 0 or counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": n}:
                raise AssertionError(f"cli {name}: rc {rc}, launches {counts} "
                                     f"{dict(body_launch.by_kernel)}, expected {want}")
            with open(out, "rb") as fh:
                data = fh.read()
            if data != golden[fmt]:
                raise AssertionError(f"cli {name}: {len(data)} bytes written, not the "
                                     f"{len(golden[fmt])} bytes of {n} direct steps")
            with open(stats) as fh:
                rec = json.loads(fh.read().splitlines()[-1])
            if not rec.get("final") or rec["frames"] != n:
                raise AssertionError(f"cli {name}: stats line {rec}")
            res[name] = dict(rec, ms_per_frame=1e3 / rec["fps"])
            probe = [ln for ln in err.getvalue().splitlines() if ln.startswith("staging:")]
            if name == "staging":
                if len(probe) != 1:
                    raise AssertionError(f"cli staging: no probe decision printed {probe}")
                res[name]["probe"] = probe[0]
    loop = ServingLoop(pipe, depth=3)
    it = iter(frames[:5])
    loop.run(lambda: next(it, None), lambda a: None)   # warm-up
    host, busy = _serving_window(loop, frames, CLI_WINDOW)
    res["serving window"] = dict(ms_per_frame=host, busy_ms_per_frame=busy,
                                 idle_share=1 - busy / host)
    print(f"cli {w}x{h}: {n} frames a run, each file byte-identical to direct steps, one "
          f"K1, K2 and K3 (K4 for nv12) launch a frame; fps "
          + ", ".join(f"{k} {res[k]['fps']}" for k, _ in CLI_MODES)
          + f"; host ms/frame {res['plain']['ms_per_frame']:.4f} (cli) vs "
          f"{res['bare step loop']['ms_per_frame']:.4f} (bare step loop); serving window "
          f"{host:.4f} ms/frame, device busy {busy:.4f}, idle share {1 - busy / host:.3f}; "
          f"{res['staging']['probe']}")
    return res


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.cpu().numpy().tobytes() if hasattr(t, "cpu") else t).hexdigest()


def _cli_run(argv, want, n):
    """``cli.main(argv)`` in-process from zeroed counts: its stderr, the
    launch counts checked against ``want`` and ``bs_body_mega`` n times
    (none where n is 0)."""
    import contextlib
    import io
    from backscrub_tpu_torch import cli
    from backscrub_tpu_torch.ops.megakernel import body_launch
    err = io.StringIO()
    _zero_counts()
    body_launch.by_kernel.clear()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    counts = _counts()
    sys.stderr.write(err.getvalue())
    if rc != 0 or counts != want or dict(body_launch.by_kernel) != (
            {"bs_body_mega": n} if n else {}):
        raise AssertionError(f"cli {argv}: rc {rc}, launches {counts} "
                             f"{dict(body_launch.by_kernel)}, expected {want}")
    return err.getvalue()


def mjpg_phase():
    """The MJPG path on the card.  ``bs_jpeg_decode`` byte-equal to its plain
    twin on every committed JPEG (4:2:0 at 640x480, 4:2:2, 4:4:4, 4:4:0,
    4:1:1 and grayscale at 64x48) and to their committed cv2.imdecode
    hashes, and on the synthetic camera's JPEGs at 640x480 and 1280x720;
    its device time warm and cold against its bound, the plain twin's
    device time and operations.  The encoder (PyTorch ops on the card + the
    host packer) against the committed cv2.imencode hashes, its device
    time and operations a frame.  ``backscrub-torch -c mjpg:`` on the mlkit
    model, in-process: YUYV out at 640x480 and MJPG out at both sizes, each
    file byte-identical to direct steps on the same JPEGs, one decode call,
    K1 and K2 a frame (and K3 with YUYV out).  Then fps and stages of
    ``-c test:`` (BGR), MJPG ingest (pre-encoded JPEGs, entropy-decoded in
    the loop) and YUYV ingest (a fake raw camera) in turns.  Returns the
    kernel's numbers, its launches on the MJPG path and the numbers by run."""
    import functools
    import tempfile
    import torch
    from backscrub_tpu_torch.io import streams
    from backscrub_tpu_torch.io.jpeg import JpegEntropyDecoder, JpegHuffmanEncoder, make_info
    from backscrub_tpu_torch.ops.jpeg_kernels import decode_jpeg_bgr, decode_jpeg_bgr_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.pipeline.image import rgb_to_yuyv
    from backscrub_tpu_torch.pipeline.jpeg_enc import encode_jpeg_coefs, stream_qtabs
    from make_synth_mjpg import JSON, encode_input, split

    def on_card(coefs, q):
        return ([torch.from_numpy(c).cuda() for c in coefs],
                torch.from_numpy(np.asarray(q, np.int32)).cuda())

    with open(os.path.join(MJPG_DATA, JSON)) as fh:
        meta = json.load(fh)
    checked = []
    for name, frames in meta["frames"].items():
        with open(os.path.join(MJPG_DATA, name), "rb") as fh:
            data = fh.read()
        for jpg, f in zip(split(data, frames), frames):
            dec = JpegEntropyDecoder()
            ct, qt = on_card(*dec.decode(jpg))
            k = decode_jpeg_bgr(ct, qt, dec.info)
            if not torch.equal(k, decode_jpeg_bgr_plain(ct, qt, dec.info)) \
                    or _sha(k) != f["decoded_sha256"]:
                raise AssertionError(f"bs_jpeg_decode on {name} ({f['sampling']}) differs from "
                                     "its plain twin or cv2.imdecode's committed hash")
            checked.append(f"{f['sampling']} {f['width']}x{f['height']}")
    for e in meta["encodes"]:
        info = make_info(e["width"], e["height"], {
            "420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
            "444": ((1, 1), (1, 1), (1, 1))}[e["sampling"]])
        qt = stream_qtabs(e["quality"])
        coefs = encode_jpeg_coefs(torch.from_numpy(encode_input(e["width"], e["height"],
                                                                e["seed"])).cuda(),
                                  torch.from_numpy(qt.astype(np.int32)).cuda(), info)
        if _sha(JpegHuffmanEncoder(info, qt).encode([c.cpu().numpy() for c in coefs])) \
                != e["sha256"]:
            raise AssertionError(f"the encoder on the card is not cv2.imencode's bytes ({e})")
    print(f"mjpg: bs_jpeg_decode byte-equal to its plain twin and to cv2.imdecode's committed "
          f"hashes on {len(checked)} JPEGs ({', '.join(checked)}); the encoder on the card "
          f"writes cv2.imencode's committed bytes for {len(meta['encodes'])} inputs")

    res, kern = {}, {}
    with torch.no_grad():
        for w, h in SIZES:
            dec = JpegEntropyDecoder()
            coefs, q = dec.decode(streams.SyntheticJpegCamera(w, h)())
            ct, qt = on_card(coefs, q)
            info = dec.info
            k = decode_jpeg_bgr(ct, qt, info)
            if not torch.equal(k, decode_jpeg_bgr_plain(ct, qt, info)):
                raise AssertionError(f"bs_jpeg_decode differs from its plain twin at {w}x{h}")
            nbytes, ops = jpeg_decode_work(coefs, w, h)
            call = functools.partial(decode_jpeg_bgr, ct, qt, info)
            plain = functools.partial(decode_jpeg_bgr_plain, ct, qt, info)
            plain_dev, plain_ops = device_kernels(plain)
            # one launch a call: device_ms finds jpeg_decode_kernel once a
            # call (n - 1 to n in a window of n) and no other device time
            one, every = device_ms(call, kernel="jpeg_decode_kernel"), device_ms(call)
            if every > 1.05 * one:
                raise AssertionError(f"bs_jpeg_decode at {w}x{h}: {every * 1e3:.3f} us of device "
                                     f"time a call, {one * 1e3:.3f} of it jpeg_decode_kernel")
            r = dict(max_abs_err=0.0, ms=timed(call), plain_ms=timed(plain), device_ms=one,
                     device_ms_cold=device_ms(call, cold="jpeg_decode_kernel"),
                     launches_a_call=1, plain_device_ms=plain_dev, plain_ops=plain_ops,
                     bound=bound(nbytes, ops), library_ms=None)
            kern[f"{w}x{h}"] = r
            comp = k
            enc_q = torch.from_numpy(stream_qtabs(85).astype(np.int32)).cuda()
            out_info = make_info(w, h)
            enc_dev, enc_ops = device_kernels(lambda: encode_jpeg_coefs(comp, enc_q, out_info))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                encode_jpeg_coefs(comp, enc_q, out_info)
            torch.cuda.synchronize()
            res[f"encode {w}x{h}"] = dict(device_ms=enc_dev, ops=enc_ops,
                                          host_ms=(time.perf_counter() - t0) * 1e3 / 20)
            print(f"mjpg decode {w}x{h}: bs_jpeg_decode {r['device_ms'] * 1e3:.3f} us device "
                  f"in one launch a call (jpeg_decode_kernel; all kernels "
                  f"{every * 1e3:.3f}; cold "
                  f"{r['device_ms_cold'] * 1e3:.3f}), bound {r['bound'][0] * 1e3:.3f} us "
                  f"({r['bound'][1]}, {nbytes / 1e6:.3f} MB); events {r['ms'][0]:.4f} ms a call "
                  f"vs plain {r['plain_ms'][0]:.4f}; plain twin {plain_dev * 1e3:.2f} us device "
                  f"in {plain_ops:.0f} operations; encode {enc_dev * 1e3:.2f} us device in "
                  f"{enc_ops:.0f} operations, {res[f'encode {w}x{h}']['host_ms']:.3f} ms host a "
                  f"frame")

    # the program: -c mjpg: decoded in the loop's thread, so every JPEG is
    # a frame and the files are deterministic
    real_src = streams.JpegSource
    streams.JpegSource = functools.partial(real_src, prefetch=False)
    launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp:
            runs = [((640, 480), 20, "yuyv")] + [(size, n, "mjpg") for size, n in MJPG_CLI]
            for (w, h), n, sink in runs:
                cam, dec = streams.SyntheticJpegCamera(w, h), JpegEntropyDecoder()
                frames = []
                for _ in range(n):
                    coefs, q = dec.decode(cam())
                    frames.append((tuple(c.copy() for c in coefs), q))
                pipe = FramePipeline(SELFIE, PipelineConfig(
                    width=w, height=h, input_format="mjpg", jpeg_info=dec.info,
                    output_format=sink), device="cuda")
                if sink == "mjpg":
                    enc = JpegHuffmanEncoder(pipe.out_jpeg_info, pipe.out_jpeg_qtabs)
                    golden = b"".join(enc.encode([c.cpu().numpy() for c in pipe.step(f)[0]])
                                      for f in frames)
                else:
                    golden = b"".join(pipe.step(f)[0].cpu().numpy().tobytes() for f in frames)
                del pipe
                out = os.path.join(tmp, "o.yuv" if sink == "yuyv" else "o.mjpg")
                stats = os.path.join(tmp, "s.jsonl")
                argv = ["-c", "mjpg:", "--cg", f"{w}x{h}", "-m", SELFIE, "--frames", str(n),
                        "-v", f"file:{out}", "--stats-json", stats]
                if sink == "mjpg":
                    argv += ["--sink-format", "mjpg"]
                want = dict(front=n, body=n, pack=n * (sink == "yuyv"), pack_420=0, bilateral=0,
                            jpeg_decode=n)
                _cli_run(argv, want, n)
                if sink == "yuyv":
                    launches = n
                with open(out, "rb") as fh:
                    if fh.read() != golden:
                        raise AssertionError(f"cli -c mjpg: {w}x{h} {sink}: not the bytes of "
                                             f"{n} direct steps")
                with open(stats) as fh:
                    rec = json.loads(fh.read().splitlines()[-1])
                res[f"cli mjpg {w}x{h} {sink}"] = dict(rec, ms_per_frame=1e3 / rec["fps"])
            # fps in turns: BGR, MJPG ingest, YUYV ingest, BGR, MJPG, YUYV
            w, h = CLI_SIZE
            n = MJPG_FPS_FRAMES
            pattern = streams.SyntheticSource(w, h)
            bgr = [pattern.read() for _ in range(n)]
            cam = streams.SyntheticJpegCamera(w, h)
            jpgs = [cam() for _ in range(n)]
            yuyv = [rgb_to_yuyv(torch.from_numpy(f).flip(-1), "yuy2").reshape(h, 2 * w).numpy()
                    for f in bgr]

            class RawCamera:
                width, height, raw_format = w, h, "yuyv"

                def __init__(self):
                    self.i = 0

                def read_raw(self):
                    self.i += 1
                    return yuyv[(self.i - 1) % n]

                def close(self):
                    pass

            def open_source(uri, *a, **k):
                if uri.startswith("mjpg:"):
                    it = iter(jpgs)
                    return streams.JpegSource(lambda: next(it, None))
                if uri == "/dev/video-yuyv":
                    return RawCamera()
                return real_open(uri, *a, **k)

            real_open = streams.open_source
            streams.open_source = open_source
            try:
                for rnd in range(2):
                    for tag, cam_uri, extra in (("bgr", "test:", {}), ("mjpg", "mjpg:",
                                                                       dict(jpeg_decode=n)),
                                                ("yuyv", "/dev/video-yuyv", {})):
                        stats = os.path.join(tmp, f"fps-{tag}.jsonl")
                        argv = ["-c", cam_uri, "--cg", f"{w}x{h}", "-m", SELFIE, "--frames",
                                str(n), "-v", f"file:{os.path.join(tmp, 'f.yuv')}",
                                "--stats-json", stats]
                        want = dict(front=n, body=n, pack=n, pack_420=0, bilateral=0,
                                    jpeg_decode=0)
                        want.update(extra)
                        _cli_run(argv, want, n)
                        with open(stats) as fh:
                            rec = json.loads(fh.read().splitlines()[-1])
                        res.setdefault(f"fps {tag}", []).append(
                            {k: rec[k] for k in rec if k in ("fps", "grab_ms", "dispatch_ms",
                                                            "sink_ms")})
            finally:
                streams.open_source = real_open
    finally:
        streams.JpegSource = real_src
    print(f"mjpg cli: -c mjpg: files byte-identical to direct steps "
          f"({', '.join(k for k in res if k.startswith('cli'))}), one bs_jpeg_decode call, K1 "
          f"and K2 a frame; fps in turns " + "; ".join(
              f"{t} " + " / ".join(f"{r['fps']:.2f}" for r in res[f'fps {t}'])
              for t in ("bgr", "mjpg", "yuyv")))
    return kern, launches, res


def _option_footprint(ema_pixels, geo, cfg):
    """The frame pixels that the EMA pixels ``ema_pixels`` reach through the
    post with ``cfg``'s options: the morphology's reach at model
    resolution, then the two-stage post's footprint (bilinear taps, 5x5
    blur; it covers the u8 post's and guided's upscale), then for guided
    the filter's reach at frame resolution (two box means of its radius)."""
    import torch
    import torch.nn.functional as F
    from backscrub_tpu_torch.pipeline.edge import GUIDED_RADIUS, post_footprint
    m = ema_pixels.float()
    if cfg.mask_morph:
        op, *k = cfg.mask_morph.split(":")
        reach = (int(k[0]) if k and k[0] else 3) // 2 * (2 if op in ("open", "close") else 1)
        m = F.max_pool2d(m[None, None], 2 * reach + 1, 1, reach)[0, 0]
    foot = post_footprint(m > 0, geo, None)
    if cfg.mask_refine == "guided":
        r = 2 * GUIDED_RADIUS
        foot = F.max_pool2d(foot.float()[None, None], 2 * r + 1, 1, r)[0, 0] > 0
    return foot


def options_phase():
    """The post options on the card: ``refine:guided``, ``morph:open:3`` and
    ``u8exact`` on segm_lite and mlkit, fused, at 640x480.  Each takes the
    JAX package's route — K1, the graph executor over the body (no body
    plan), the decode, the post with the option — and K3; OPTION_FRAMES
    frames from a fresh EMA, the launches counted frame by frame, held to
    the plain route (K1's plain version) under the decode flip rule and
    the tolerance invariant outside the flips' footprint through the
    option's post.  Device busy a frame beside the default route's (the
    fused tail) and the kernels each step launched.  Returns the numbers by
    run."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import blend_pack_yuyv_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    w, h = 640, 480
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, OPTION_FRAMES)]
    res = {}
    for tag, path, margin in (("segm_lite", MODEL, _two_channel_margin),
                              ("mlkit", SELFIE, _logit_margin)):
        base = FramePipeline(path, PipelineConfig(width=w, height=h), device="cuda")
        for f in frames[:3]:
            base.step(f)
        busy, ops, _ = _window(lambda f: base.step(f), frames, OPTION_FRAMES)
        res[f"{tag} fused tail"] = dict(busy_ms_per_frame=busy, ops_per_frame=ops)
        del base
        for name, opts, env in OPTIONS:
            cfg = PipelineConfig(width=w, height=h, **opts)
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                pipe = FramePipeline(path, cfg, device="cuda")
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            e = pipe.maskgen.edge
            if e is None or e.plans or e.info.tail_ok or e.rest is None:
                raise AssertionError(f"{tag} {name}: not the JAX route (K1, the executor)")
            for f in frames[:3]:
                pipe.step(f)
            busy, ops, _ = _window(lambda f: pipe.step(f), frames, OPTION_FRAMES)
            pipe.reset()
            want = dict(front=1, body=0, pack=1, pack_420=0, bilateral=0, jpeg_decode=0)
            ema = pipe.maskgen.ema.clone()
            ever = torch.zeros_like(ema, dtype=torch.bool)
            fracs, flips, worst = [], 0, 0.0
            green = pipe.green
            with torch.no_grad():
                for f in frames:
                    _zero_counts()
                    body_launch.by_kernel.clear()
                    out, mask = pipe.step(f)
                    counts = _counts()
                    if counts != want or body_launch.by_kernel:
                        raise AssertionError(f"{tag} {name}: launches {counts} "
                                             f"{dict(body_launch.by_kernel)}, expected {want}")
                    mrg, ema = _edge_plain(e, f, ema, margin)
                    k, mm = _flip_rule(pipe.maskgen.ema, ema, mrg, ever)
                    flips, worst = flips + k, max(worst, mm)
                    rm = e.postprocess(ema, f)
                    foot = _option_footprint(pipe.maskgen.ema != ema, e.geo, cfg)
                    fracs.append(_held_bytes([(out, blend_pack_yuyv_plain(f, green, rm)),
                                              (mask, rm)], f"{tag} {name}",
                                             [_yuyv_footprint(foot), foot]))
            if float(np.mean(fracs)) > MEAN_TOL:
                raise AssertionError(f"{tag} {name}: {100 * np.mean(fracs):.4f}% of bytes "
                                     "differ on average")
            res[f"{tag} {name}"] = dict(busy_ms_per_frame=busy, ops_per_frame=ops, flips=flips,
                                        flip_margin=worst, mean_diff=float(np.mean(fracs)))
            print(f"options {tag} {name} {w}x{h}: kernels a frame K1 (bs_front) + K3 "
                  f"(blend_pack_yuyv), no body plan (the executor runs the body: "
                  f"{ops:.0f} device operations a frame in all); device busy {busy:.4f} "
                  f"ms/frame against the fused tail's "
                  f"{res[f'{tag} fused tail']['busy_ms_per_frame']:.4f}; vs the plain route: "
                  f"decode flips {flips} (largest |margin| {worst:.3g}), differing bytes mean "
                  f"{100 * float(np.mean(fracs)):.4f}%")
            del pipe
    return res


def _plan_bf16(plan, x, tag):
    """A bf16 plan's one launch on ``x``: two runs bit-identical, and the
    kernel held op by op (``BodyPlan.rows_on_card``: each phase's rows run
    on the kernel's own workspace of the phase before, against
    ``walk_phase``'s plain rows on it) at allclose(ATOL, RTOL), where only
    the summation order differs.  The control, the plain rows with the
    dots' activations left unrounded, must miss that bar on some row, so
    the check tells a kernel that skipped the rounding.  The whole span
    against ``run_plain(x, "bf16")`` is printed beside what the bf16 dots
    move the twin, not held: the rounding of every dot operand turns the
    two summation orders' f32 ulps into bf16 ulps that the ops after carry
    on (tests/test_torch_precision.py).  Returns the kernels-line numbers
    and the kernel's output."""
    import torch
    k, k2 = plan.run_cuda(x).clone(), plan.run_cuda(x)
    p = plan.run_plain(x, "bf16")
    p32 = plan.run_plain(x, "bf16x3" if plan.flat else "f32")
    torch.cuda.synchronize()
    if not torch.equal(k, k2):
        raise AssertionError(f"{tag}: two bf16 runs differ")
    rows = off = 0
    worst = ctl_worst = 0.0
    for phase, kind, got, want, ctl in plan.rows_on_card(x):
        rows += 1
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{tag}: a {kind} row of phase {phase} is {err:.3g} from its "
                                 f"plain row on the kernel's inputs")
        worst = max(worst, err)
        off += not torch.allclose(ctl, want, atol=ATOL, rtol=RTOL)
        ctl_worst = max(ctl_worst, float((ctl - want).abs().max()))
    if not off:
        raise AssertionError(f"{tag}: the rows with unrounded activations meet the bar too")
    dist, effect = (k - p).abs(), (p - p32).abs()
    r = dict(max_abs_err=worst, rows_held=rows, control_rows_off=off, control_max_err=ctl_worst,
             e2e_max_abs_err=float(dist.max()), e2e_mean_abs_err=float(dist.mean()),
             effect_mean=float(effect.mean()), effect_max=float(effect.max()),
             ms=timed(lambda: plan.run_cuda(x)), plain_ms=timed(lambda: plan.run_plain(x, "bf16")),
             device_ms=device_ms(lambda: plan.run_cuda(x)), bound=bound(*bf16_work(plan)),
             phases=plan.mega.phases)
    print(f"kernel {tag} bf16: {r['phases']} phases, device {r['device_ms'] * 1e3:.2f} us (bound "
          f"{r['bound'][0] * 1e3:.3f} us, {r['bound'][1]}); op by op: {rows} rows within "
          f"allclose({ATOL:g}, {RTOL:g}) of their plain rows, max_abs_err {worst:.3g}; the "
          f"control (activations unrounded) off the bar on {off} rows, max {ctl_worst:.3g}; "
          f"the span against run_plain(gemm='bf16') {r['e2e_max_abs_err']:.3g} max, "
          f"{r['e2e_mean_abs_err']:.3g} mean (the bf16 dots move the twin "
          f"{r['effect_max']:.3g} max, {r['effect_mean']:.3g} mean)")
    return r, k


def _iou(a, b):
    a, b = a < 128, b < 128
    return float((a & b).sum()) / max(float((a | b).sum()), 1.0)


def precision_family(tag, path, margin):
    """A family's bf16 mode fused at 640x480 (``compute_dtype=bfloat16,
    precision="default"``): each plan's bf16 table held op by op
    (``_plan_bf16``); PRECISION_FRAMES frames from a fresh EMA with one K1,
    one ``bs_body_mega`` a plan and one K3 launch a frame (counted frame by
    frame), held against the plain path in the same arithmetic
    (``step_mask(plain=True, gemm="bf16")``, its EMA its own) with the f32
    path on the same frames as the control, the reading of a port that
    ignored bf16; every bf16 reading at most CONTROL_SHARE of the
    control's (tests/test_torch_precision_masks.py's bars, the port's plain
    path in the JAX package's place):
    - where the body runs wholly in the plans, the decode flip rule with
      the near-tie at CONTROL_SHARE of the largest |margin| at which the
      f32 path's decode differs from the plain path's (the EMAs equal
      wherever no decode flipped, no mask byte off by more than 1 outside
      the flips' footprint; bf16 flips are many, so the tolerance
      invariant's shares are not held inside it);
    - where the executor runs a bf16 span, the last mask's IoU at least
      1 - CONTROL_SHARE (1 - J), J the f32 path's IoU against the plain
      path, where that effect spans at least MIN_CELLS decode cells; else
      (BodyPix's 33x33 decode grid) the decode input's mean distance from
      the plain path at most CONTROL_SHARE of the f32 path's, every frame.
    The bf16 path's IoU against the f32 path is at least J - 0.01.  Device
    busy a frame in bf16 beside f32, the executor remainder's device time
    in both.  Returns (numbers, the plans' kernels-line numbers, launches
    by counter and table op)."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    from backscrub_tpu_torch.pipeline.edge import post_footprint
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from make_synth_segm import moving_frames

    w, h = CLASSIC_SIZE
    n = PRECISION_FRAMES
    frames = [torch.from_numpy(f).cuda() for f in moving_frames(w, h, n)]
    cfg = PipelineConfig(width=w, height=h)
    p32 = FramePipeline(path, cfg, device="cuda")
    p16 = FramePipeline(path, cfg, device="cuda", compute_dtype=torch.bfloat16,
                        precision="default")
    e, e32 = p16.maskgen.edge, p32.maskgen.edge
    if e is None or not e.plans or any(p.dots != "bf16" for p in e.plans):
        raise AssertionError(f"{tag} bf16 did not take the fused path with bf16 plans")
    res, kern = dict(plans=[p.mega.phases for p in e.plans]), {}
    with torch.no_grad():
        x = e.front(frames[0]).reshape(e.plans[0].in_meta.c, -1)
        for plan, name in zip(e.plans, ("body_prefix", "body_cont") if len(e.plans) == 2
                              else ("body" if e.info.tail_ok else "body_prefix",)):
            kern[name], x = _plan_bf16(plan, x, f"{tag} {name}")
        if e.rest is not None:
            m = e.plans[-1].out_meta
            rest_in = x.reshape(m.c, m.rows, m.w).permute(1, 2, 0)[None]
            res["rest_bf16_us"], res["rest_bf16_ops"] = (
                v * f for v, f in zip(device_kernels(lambda: e.rest(rest_in)), (1e3, 1)))
            res["rest_f32_us"], res["rest_f32_ops"] = (
                v * f for v, f in zip(device_kernels(lambda: e32.rest(rest_in.float())), (1e3, 1)))
    for p in (p32, p16):
        for f in frames[:3]:
            p.step(f)
    res["busy_f32_ms_per_frame"], res["ops_f32_per_frame"], _ = _window(p32.step, frames, n)
    res["busy_bf16_ms_per_frame"], res["ops_bf16_per_frame"], _ = _window(p16.step, frames, n)
    p16.reset()
    p32.reset()
    want = dict(front=1, body=len(e.plans), pack=1, pack_420=0, bilateral=0, jpeg_decode=0)
    launches = collections.Counter()
    table_ops = collections.Counter()
    ema = torch.full(p16.maskgen.ema_shape, 255, dtype=torch.uint8, device=p16.device)
    kernels_only = e.rest is None
    seq, ratios = [], []
    with torch.no_grad():
        for f in frames:
            _zero_counts()
            body_launch.by_kernel.clear()
            body_launch.table_ops.clear()
            _, mask = p16.step(f)
            counts = _counts()
            if counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": len(e.plans)}:
                raise AssertionError(f"{tag} bf16 launches a frame {counts} "
                                     f"{dict(body_launch.by_kernel)}, expected {want}")
            launches.update(counts)
            table_ops.update(body_launch.table_ops)
            _, mask32 = p32.step(f)
            ema_prev = ema
            body = e.body(e.front(f, plain=True), plain=True, gemm="bf16")
            if e.info.tail_ok:
                body = body.reshape(body.shape[0], -1)
                mrg, ema = e.tail_logits(body) - e.info.tail_threshold, e.tail(body, ema_prev)
            else:
                out = body.permute(1, 2, 0).float()
                mrg, ema = margin(out), ema_update(ema_prev, decode_val(out, e.spec))
                k_out, f32_out = (g.body(g.front(f)).float() for g in (e, e32))
                ratios.append(float((k_out - body.float()).abs().mean())
                              / float((f32_out - body.float()).abs().mean()))
            seq.append((p16.maskgen.ema.clone(), p32.maskgen.ema.clone(), ema, mrg, mask,
                        e.postprocess(ema, f)))
    J = _iou(seq[-1][5], mask32)
    iou = _iou(mask, seq[-1][5])
    res.update(iou_plain=iou, J=J, iou_f32=_iou(mask, mask32), launches=dict(launches),
               table_ops=dict(table_ops))
    if kernels_only:
        control = max(_flip_margin(e32k, ep, mrg)[0] for _, e32k, ep, mrg, _, _ in seq)
        tie = CONTROL_SHARE * control
        ever = torch.zeros_like(ema, dtype=torch.bool)
        flips, worst, off_foot = 0, 0.0, []
        for ek, _, ep, mrg, mk, mp in seq:
            k, mm = _flip_rule(ek, ep, mrg, ever, tie)
            flips, worst = flips + k, max(worst, mm)
            foot = post_footprint(ek != ep, e.geo, e.post_mats)
            d = torch.where(foot, 0, (mk.int() - mp.int()).abs())
            if int(d.max()) > 1:
                raise AssertionError(f"{tag} bf16: a mask byte off by {int(d.max())} "
                                     "outside the flips' footprint")
            off_foot.append(float((d > 0).float().mean()))
        res.update(flips=flips, flip_margin=worst, control_flip_margin=control, tie=tie,
                   off_footprint_diff=max(off_foot))
        check = (f"decode flips {flips} at |margin| <= {worst:.3g}, the near-tie "
                 f"{tie:.3g} ({CONTROL_SHARE:g} x the f32 path's flips' {control:.3g}), mask "
                 f"bytes differing outside their footprint at most "
                 f"{100 * res['off_footprint_diff']:.3f}% a frame")
    else:
        cells = int(((seq[-1][1] >> 7) != (seq[-1][2] >> 7)).sum())
        bar = 1 - CONTROL_SHARE * (1 - J)
        res.update(cells=cells, iou_bar=bar, decode_ratio=max(ratios))
        if cells >= MIN_CELLS and iou < bar:
            raise AssertionError(f"{tag} bf16: mask IoU {iou:.4f} against the plain path, under "
                                 f"{bar:.4f} (J {J:.4f})")
        if cells < MIN_CELLS and max(ratios) > CONTROL_SHARE:
            raise AssertionError(f"{tag} bf16: the decode input {max(ratios):.3g} of the f32 "
                                 f"path's distance from the plain path")
        check = (f"mask IoU {iou:.4f}, bar {bar:.4f} (J {J:.4f}, the bf16 effect {cells} "
                 f"decode cells: " + ("held" if cells >= MIN_CELLS else "read") + "); decode "
                 f"input at most {max(ratios):.3g} of the f32 path's distance ("
                 + ("read" if cells >= MIN_CELLS else "held") + ")")
    if res["iou_f32"] < J - 0.01:
        raise AssertionError(f"{tag} bf16: IoU {res['iou_f32']:.4f} against f32, J {J:.4f}")
    rest = (f"; executor remainder {res['rest_bf16_us']:.2f} us in bf16 vs "
            f"{res['rest_f32_us']:.2f} us in f32 ({res['rest_bf16_ops']:.0f} / "
            f"{res['rest_f32_ops']:.0f} operations)" if "rest_bf16_us" in res else "")
    print(f"precision {tag} fused {w}x{h}: device busy {res['busy_bf16_ms_per_frame']:.4f} "
          f"ms/frame in bf16 vs {res['busy_f32_ms_per_frame']:.4f} in f32 "
          f"({res['ops_bf16_per_frame']:.1f} / {res['ops_f32_per_frame']:.1f} operations){rest}; "
          f"{n} frames, launches {dict(launches)}; vs the bf16 plain path: {check}; IoU "
          f"against f32 {res['iou_f32']:.4f}")
    return res, kern


def gemm_bf16_phase(cont, dev):
    """The one-term wgmma tile alone (``bs_gemm`` with terms=1, gemm_wg.cuh,
    its weights laid out once by ``wgmma_weights``) at every 1x1 shape of
    the deeplab continuation: against conv1x1_bf16_plain (GEMM_REL
    relative: one dot, the summation order alone), two runs bit-identical,
    its device time and torch.addmm's on bf16 operands (f32 out) summed
    over a frame's GEMMs; at the ASPP shape also beside the three-term
    tile's.  Returns the kernels-line numbers at the ASPP shape."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import (conv1x1_bf16_plain, conv1x1_gemm,
                                                    wgmma_weights)
    ws = cont._weights_on(dev)
    shapes = collections.defaultdict(list)
    for p in gemm_ops(cont):
        shapes[cont.weights[p[3]].shape].append(p)
    frame_us = lib_frame_us = 0.0
    with torch.no_grad():
        for (co, ci), ps in sorted(shapes.items()):
            _, tin, _, wi, bi, act = ps[0]
            gw, gb = ws[wi], ws[bi]
            L = cont.meta[tin].rows * cont.meta[tin].w
            gx = torch.from_numpy(np.random.default_rng(co * 1000 + ci).uniform(
                0, 2, (ci, L)).astype(np.float32)).to(dev)
            one = wgmma_weights(gw, 1, L)
            k, k2 = (conv1x1_gemm(gw, gb, gx, act, split=one, terms=1) for _ in range(2))
            pb = conv1x1_bf16_plain(gw, gb, gx, act)
            torch.cuda.synchronize()
            rel = float((k - pb).abs().max() / pb.abs().max())
            if rel > GEMM_REL or not torch.equal(k, k2):
                raise AssertionError(f"one-term GEMM {co}x{ci}: {rel:.3g} from its twin, or "
                                     f"runs differ")
            wb, xb, bb = gw.bfloat16(), gx.bfloat16(), gb.bfloat16()[:, None]
            dev1 = device_ms(lambda: conv1x1_gemm(gw, gb, gx, split=one, terms=1))
            lib = device_ms(lambda: torch.addmm(bb, wb, xb))
            frame_us += 1e3 * dev1 * len(ps)
            lib_frame_us += 1e3 * lib * len(ps)
            print(f"gemm bf16 {co}x{ci} by {ci}x{L} ({len(ps)} a frame): one term "
                  f"{dev1 * 1e3:.3f} us, torch.addmm on bf16 operands {lib * 1e3:.3f} us, "
                  f"bound {bound(*gemm_work(co, ci, L, terms=1))[0] * 1e3:.3f} us; vs "
                  f"conv1x1_bf16_plain {rel:.3g} relative")
        co, ci = max(shapes, key=lambda s: s[0] * s[1])
        _, tin, _, wi, bi, act = shapes[(co, ci)][0]
        gw, gb = ws[wi], ws[bi]
        L = cont.meta[tin].rows * cont.meta[tin].w
        gx = torch.from_numpy(np.random.default_rng(6).uniform(0, 2, (ci, L)).astype(
            np.float32)).to(dev)
        sp, one = wgmma_weights(gw, 3, L), wgmma_weights(gw, 1, L)
        k, k2 = (conv1x1_gemm(gw, gb, gx, split=one, terms=1) for _ in range(2))
        pb = conv1x1_bf16_plain(gw, gb, gx)
        torch.cuda.synchronize()
        rel = float((k - pb).abs().max() / pb.abs().max())
        if rel > GEMM_REL or not torch.equal(k, k2):
            raise AssertionError(f"one-term GEMM {co}x{ci}: {rel:.3g} from its twin, or runs differ")
        wb, xb, bb = gw.bfloat16(), gx.bfloat16(), gb.bfloat16()[:, None]
        r = dict(max_abs_err=float((k - pb).abs().max()), rel_err=rel,
                 ms=timed(lambda: conv1x1_gemm(gw, gb, gx, split=one, terms=1)),
                 plain_ms=timed(lambda: conv1x1_bf16_plain(gw, gb, gx)),
                 device_ms=device_ms(lambda: conv1x1_gemm(gw, gb, gx, split=one, terms=1)),
                 three_term_device_ms=device_ms(lambda: conv1x1_gemm(gw, gb, gx, split=sp)),
                 library_ms=timed(lambda: torch.addmm(bb, wb, xb)),
                 library_device_ms=device_ms(lambda: torch.addmm(bb, wb, xb)),
                 bound=bound(*gemm_work(co, ci, L, terms=1)), frame_us=frame_us,
                 library_frame_us=lib_frame_us)
    print(f"gemm bf16 {co}x{ci} by {ci}x{L}: one term {r['device_ms'] * 1e3:.3f} us, three terms "
          f"{r['three_term_device_ms'] * 1e3:.3f} us, torch.addmm on bf16 operands "
          f"{r['library_device_ms'] * 1e3:.3f} us; bound {r['bound'][0] * 1e3:.3f} us "
          f"({r['bound'][1]}); vs conv1x1_bf16_plain {rel:.3g} relative; a deeplab frame's "
          f"{sum(map(len, shapes.values()))} GEMMs: one term {frame_us:.2f} us of device time, "
          f"torch.addmm on bf16 operands {lib_frame_us:.2f} us")
    return r


def precision_cli():
    """``backscrub-torch`` in-process on the card at CLI_SIZE on the default
    family (mlkit): plain, ``--bf16`` and ``--int8``, CLI_FRAMES frames each,
    each file byte-identical to direct ``FramePipeline.step`` calls in the
    same mode on the same frames, each kernel of its route launched once a
    frame (``--bf16``: K1, K2, K3; ``--int8``: the classic stages, K5 and
    K3); fps and stage ms from the stats line.  Returns them by mode."""
    import contextlib
    import io
    import tempfile
    import torch
    from backscrub_tpu_torch import cli
    from backscrub_tpu_torch.io.streams import SyntheticSource
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

    (w, h), n = CLI_SIZE, CLI_FRAMES
    src = SyntheticSource(w, h)
    frames = [src.read() for _ in range(n)]
    modes = (("plain", [], {}, dict(front=n, body=n, pack=n, bilateral=0)),
             ("bf16", ["--bf16"], dict(compute_dtype=torch.bfloat16, precision="default"),
              dict(front=n, body=n, pack=n, bilateral=0)),
             ("int8", ["--int8"], dict(quantize="int8"), dict(front=0, body=0, pack=n, bilateral=n)))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, flags, kw, want in modes:
            pipe = FramePipeline(SELFIE, PipelineConfig(width=w, height=h), device="cuda", **kw)
            golden = b"".join(pipe.step(f)[0].cpu().numpy().tobytes() for f in frames)
            del pipe
            out, stats = os.path.join(tmp, f"{name}.yuv"), os.path.join(tmp, f"{name}.jsonl")
            argv = ["-c", "test:", "--cg", f"{w}x{h}", "-m", SELFIE, "--frames", str(n),
                    "-v", f"file:{out}", "--stats-json", stats, *flags]
            err = io.StringIO()
            _zero_counts()
            body_launch.by_kernel.clear()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            counts = {k: v for k, v in _counts().items() if k in want}
            sys.stderr.write(err.getvalue())
            if rc != 0 or counts != want:
                raise AssertionError(f"cli {name}: rc {rc}, launches {counts}, expected {want}")
            with open(out, "rb") as fh:
                if fh.read() != golden:
                    raise AssertionError(f"cli {name}: not the bytes of {n} direct steps")
            with open(stats) as fh:
                rec = json.loads(fh.read().splitlines()[-1])
            res[name] = dict(rec, ms_per_frame=1e3 / rec["fps"])
    print(f"precision cli {w}x{h} mlkit, {n} frames a run, each byte-identical to direct steps "
          f"in its mode: fps " + ", ".join(f"{k} {v['fps']}" for k, v in res.items()))
    return res


def precision_phase():
    """The bf16 and int8 modes on the card: every family's bf16 fused path
    (``precision_family``), the one-term GEMM alone, every family's int8
    classic path against its plain version (``family_classic`` with
    ``quantize="int8"``), and the program with ``--bf16`` and ``--int8``.
    Returns (numbers, kernels-line numbers by name, launches by name)."""
    families = (("segm_lite", MODEL, _two_channel_margin),
                ("segm_full", SEGM_FULL, _two_channel_margin), ("mlkit", SELFIE, _logit_margin),
                ("deeplab", DEEPLAB, _person_margin), ("bodypix", BODYPIX, _threshold_margin))
    res, kern, launches = {}, {}, {}
    for tag, path, margin in families:
        res[f"{tag} bf16"], k = precision_family(tag, path, margin)
        if tag == "segm_lite":
            kern["body_bf16"] = k["body"]
            launches["body_bf16"] = res[f"{tag} bf16"]["launches"]["body"]
        if tag == "deeplab":
            kern["body_prefix_bf16"], kern["body_cont_bf16"] = k["body_prefix"], k["body_cont"]
            launches["body_prefix_bf16"] = launches["body_cont_bf16"] = PRECISION_FRAMES
            launches["gemm_bf16"] = res[f"{tag} bf16"]["table_ops"]["gemm"]
    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    p16 = FramePipeline(DEEPLAB, PipelineConfig(width=640, height=480), device="cuda",
                        compute_dtype=torch.bfloat16, precision="default")
    kern["gemm_bf16"] = gemm_bf16_phase(p16.maskgen.edge.cont_plan, p16.device)
    for tag, path, margin in families:
        res[f"{tag} int8 classic"] = family_classic(f"{tag} int8", path, margin,
                                                    quantize="int8")
    res["cli"] = precision_cli()
    return res, kern, launches


# the multi-stream phase: stream batches of MS_BATCHES through K1-K4 at
# MS_SIZE; MultiStreamPipeline at MS_STREAMS streams for MS_TICKS ticks
# against solo steps; the servers; fps per card at MS_FPS_STREAMS, the
# median of MS_FPS_WINDOWS windows of at least MS_FPS_SECONDS each, with a
# profiled window of MS_WINDOW ticks each;
# cli_multi for MS_CLI_FRAMES frames
MS_SIZE, MS_BATCHES, MS_STREAMS, MS_TICKS = (640, 480), (4, 8), 4, 30
MS_FPS_STREAMS, MS_WINDOW, MS_CLI_FRAMES = (1, 2, 4, 8), 20, 10
MS_FPS_WINDOWS, MS_FPS_SECONDS = 5, 2.0


def _stream_frames(w, h, streams, n):
    """n ticks of ``streams`` streams' frames, (n, streams, h, w, 3) u8:
    stream s the moving sequence of seed s."""
    from make_synth_segm import moving_frames
    return np.stack([moving_frames(w, h, n, seed=s) for s in range(streams)], axis=1)


def _batch_held(tag, run, plain, S, counter, work, hold, cold):
    """One kernel over a stream batch of S: ``run(None)`` the batch,
    ``run(s)`` image s alone.  One launch a batch (``counter()``: the
    launches so far), each image bit-identical to its own launch, the batch
    against ``plain()``: byte-equal (``hold`` "equal"), allclose (``hold``
    the atol/rtol dict), or its distance printed (``hold`` None); the
    device time a batch cold (``cold`` the kernel's profiler name: the L2
    flushed before each launch, as a fresh tick's frames come from HBM)
    beside the bound a batch (``work``: one image's (bytes, f32 ops[, bf16
    ops]), times S), and warm (the same inputs again, L2-resident).
    Returns (the numbers, the batch's result)."""
    import torch
    c0 = counter()
    k = run(None)
    if counter() - c0 != 1:
        raise AssertionError(f"{tag} S={S}: {counter() - c0} launches for one batch")
    for s in range(S):
        if not torch.equal(k[s], run(s)):
            raise AssertionError(f"{tag} S={S}: image {s} differs from its one-image launch")
    p = plain()
    torch.cuda.synchronize()
    if hold == "equal" and not torch.equal(k, p):
        raise AssertionError(f"{tag} S={S}: the batch differs from its plain version")
    if isinstance(hold, dict):
        torch.testing.assert_close(k, p, **hold)
    dev = device_ms(lambda: run(None), n=30)
    dev_cold = device_ms(lambda: run(None), n=30, cold=cold)
    b = bound(*(S * v for v in work))
    r = dict(max_abs_err=float((k.float() - p.float()).abs().max()),
             device_us_cold=dev_cold * 1e3, device_us_frame_cold=dev_cold * 1e3 / S,
             device_us=dev * 1e3, device_us_frame=dev * 1e3 / S, bound_us=b[0] * 1e3,
             bound_by=b[1])
    print(f"batch {tag} S={S}: one launch, each image bit-identical to its own launch, "
          f"max_abs_err {r['max_abs_err']:.3g} vs plain"
          + (" (printed: the single launches are held op by op)" if hold is None else "")
          + f"; device cold {r['device_us_cold']:.2f} us a batch, "
          f"{r['device_us_frame_cold']:.2f} a frame, bound {r['bound_us']:.3f} us a batch "
          f"({b[1]}); warm (L2-resident) {r['device_us']:.2f} us a batch, "
          f"{r['device_us_frame']:.2f} a frame")
    return r, k


def _phase_kinds(tag, plan, x):
    """The plan's phase clock by op kind (``BodyPlan.phase_kinds``) on the
    batch's first image and on the batch ``x``, printed a kind a line;
    returns {kind: [phases, us at S = 1, us at S]}."""
    one, many = plan.phase_kinds(x[0]), plan.phase_kinds(x)
    S = x.shape[0]
    print(f"phases by op kind {tag}: {sum(t for _, t in one.values()) / 1e3:.2f} us at S = 1, "
          f"{sum(t for _, t in many.values()) / 1e3:.2f} at S = {S}")
    for k in sorted(one, key=lambda k: -many[k][1]):
        print(f"  {k}: {one[k][0]} phases, {one[k][1] / 1e3:.2f} / {many[k][1] / 1e3:.2f} us")
    return {k: [one[k][0], one[k][1] / 1e3, many[k][1] / 1e3] for k in one}


def multistream_kernels(frames):
    """K1 (segm_lite, mlkit, deeplab), K2 (segm_lite, mlkit), K2' and K2''
    (deeplab, f32 and bf16 tables), K3 and K4 over stream batches of
    MS_BATCHES at MS_SIZE (``_batch_held``): the single-frame bars (K1, K2,
    K2' allclose(ATOL, RTOL); K2'' against run_plain(gemm="bf16x3") at
    MATCHED_ATOL/RTOL; K3 and K4 byte-equal; the bf16 tables, whose single
    launches precision_phase holds op by op, by each image's bit identity
    to them, the distance to run_plain(gemm="bf16") printed); the plans'
    workspace bytes a batch and, at the largest batch, their phase clock by
    op kind at S = 1 and S (``_phase_kinds``).  Returns {kernel key: {S:
    numbers}}."""
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.ops.pack_kernels import (blend_pack_420, blend_pack_420_plain,
                                                      blend_pack_yuyv, blend_pack_yuyv_plain)
    from backscrub_tpu_torch.pipeline.edge import front_fused, front_plain
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig

    w, h = MS_SIZE
    cfg = PipelineConfig(width=w, height=h)
    pipes = {"segm_lite": FramePipeline(MODEL, cfg, device="cuda"),
             "mlkit": FramePipeline(SELFIE, cfg, device="cuda"),
             "deeplab": FramePipeline(DEEPLAB, cfg, device="cuda"),
             "deeplab_bf16": FramePipeline(DEEPLAB, cfg, device="cuda",
                                           compute_dtype=torch.bfloat16, precision="default")}
    out = collections.defaultdict(dict)
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for S in MS_BATCHES:
            fr = torch.from_numpy(frames[0, :S]).cuda()
            for tag, pipe in pipes.items():
                e = pipe.maskgen.edge
                canvas, kw = e.canvas(fr), e.front_kwargs()
                cout = (e.front_params.numel() - 13) // 28
                r, x = _batch_held(
                    f"K1 {tag}",
                    lambda s: front_fused(canvas if s is None else canvas[s], e.front_params,
                                          **kw),
                    lambda: front_plain(canvas, e.front_params, **kw), S,
                    lambda: front_fused.launches, front_work(kw, cout),
                    dict(atol=ATOL, rtol=RTOL), "front_kernel")
                if tag != "deeplab_bf16":
                    out["front" if tag == "segm_lite" else f"front {tag}"][S] = r
                x = x.reshape(S, x.shape[1], -1)
                for plan in e.plans:
                    name = "body" if plan is e.body_plan else (
                        "body_prefix" if plan is e.prefix_plan else "body_cont")
                    gemm = {"f32": "f32", "bf16x3": "bf16x3", "bf16": "bf16"}[plan.dots]
                    hold, work = dict(atol=ATOL, rtol=RTOL), plan.work()
                    if gemm == "bf16x3":
                        hold, work = dict(atol=MATCHED_ATOL, rtol=MATCHED_RTOL), cont_work(plan)
                    elif gemm == "bf16":
                        name, hold, work = name + "_bf16", None, bf16_work(plan)
                    xin = x
                    r, x = _batch_held(
                        f"{name} {tag}", lambda s: plan(xin if s is None else xin[s]),
                        lambda: plan.run_plain(xin, gemm), S,
                        lambda: body_launch.by_kernel["bs_body_mega"], work, hold,
                        "body_mega_kernel")
                    r.update(workspace_bytes=4 * S * plan.ws_stride, phases=plan.mega.phases)
                    if S == max(MS_BATCHES):
                        r["phase_us_by_kind"] = _phase_kinds(f"{name} {tag}", plan, xin)
                    out[name if tag != "mlkit" else f"{name} {tag}"][S] = r
            fb, bg = (torch.from_numpy(rng.integers(0, 256, (S, h, w, 3), np.uint8)).cuda()
                      for _ in range(2))
            mask = torch.from_numpy(rng.integers(0, 256, (S, h, w), np.uint8)).cuda()
            mask[:, : h // 4] = 0
            mask[:, h // 4: h // 2] = 255

            def sel(s):
                return (fb, bg, mask) if s is None else (fb[s], bg[s], mask[s])

            out["pack"][S], _ = _batch_held(
                "K3", lambda s: blend_pack_yuyv(*sel(s)),
                lambda: blend_pack_yuyv_plain(fb, bg, mask), S,
                lambda: blend_pack_yuyv.launches, pack_yuyv_work(h, w), "equal",
                "blend_pack_yuyv_kernel")
            for layout in ("nv12", "i420"):
                r, _ = _batch_held(
                    f"K4 {layout}", lambda s: blend_pack_420(*sel(s), layout),
                    lambda: blend_pack_420_plain(fb, bg, mask, layout), S,
                    lambda: blend_pack_420.launches, pack_420_work(h, w), "equal",
                    "blend_pack_420_kernel")
                if layout == "nv12":
                    out["pack_420"][S] = r
    return out


def _ms_sources(frames, streams):
    """Pull sources over ``frames`` (n, streams, h, w, 3): stream s's
    frames in order, then None."""
    its = [iter(frames[:, s]) for s in range(streams)]
    return [lambda it=it: next(it, None) for it in its]


def _ms_cycle(frames, streams):
    """Pull sources that never end: stream s's frames of ``frames`` (n,
    streams, h, w, 3) over and over."""
    its = [itertools.cycle(frames[:, s]) for s in range(streams)]
    return [lambda it=it: next(it) for it in its]


def _stage_trace(e, frames):
    """Where a stream batch departs from solo steps: MS_TICKS ticks of the
    edge path ``e`` over ``frames`` (n, S, H, W, 3) from fresh EMAs, each
    stage fed the batch's own inputs (the frames, the previous stage's
    batch output, the batch's EMA) and run over the batch and then image by
    image in a solo step's form (no batch axis, as ``FramePipeline.step``
    calls it).  Returns, per stage (the canvas contraction, K1, each body
    plan, the executor remainder, the tail's new EMA or the decode, the
    post: K3's mask input), the elements that differ, summed over every
    tick and image; and, where the post is the fold-blur one, the same
    count for its products taken as one GEMM over the batch's rows (the
    formulation ``edge.fold_blur_post`` had before it went image by image:
    a control, printed, not held)."""
    import torch
    from backscrub_tpu_torch.pipeline.decode import decode_val, ema_update
    from backscrub_tpu_torch.pipeline.edge import front_fused, pad_to_frame
    S, res, kw = frames.shape[1], {}, e.front_kwargs()
    one_gemm = 0

    def split(name, fn, *xs):
        b = fn(*xs)
        res[name] = res.get(name, 0) + sum(int((b[s] != fn(*(x[s] for x in xs))).sum())
                                           for s in range(S))
        return b

    def plan_stage(plan):
        m = plan.out_meta
        return lambda x: plan(x.reshape(x.shape[:-2] + (-1,))).reshape(
            x.shape[:-3] + (m.c, m.rows, m.w))

    def rest(x):
        y = e.rest(x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return y.reshape(tuple(x.shape[:-3]) + tuple(y.shape[1:]))

    ema = torch.full((S,) + tuple(e.model.output_shape[1:3]), 255, dtype=torch.uint8,
                     device="cuda")
    with torch.no_grad():
        for k in range(MS_TICKS):
            fr = torch.from_numpy(frames[k, :S]).cuda()
            h = split("K1", lambda c: front_fused(c, e.front_params, **kw),
                      split("canvas", e.canvas, fr))
            for i, plan in enumerate(e.plans):
                h = split(f"plan {i}", plan_stage(plan), h)
            if e.rest is not None:
                h = split("rest", rest, h)
            if e.info.tail_ok:
                ema = split("tail", lambda x, m: e.tail(x.flatten(-2), m), h, ema)
            else:
                ema = split("decode", lambda x, m: ema_update(
                    m, decode_val(x.movedim(-3, -1).float(), e.spec)), h, ema)
            split("post", e.postprocess, ema)
            if e.post_mats is not None:
                ah, aw = e.post_mats
                y = torch.matmul(torch.matmul(ah, ema.float()), aw.T)
                one = pad_to_frame(torch.clamp(torch.round(y), 0, 255).to(torch.uint8), e.geo)
                one_gemm += sum(int((one[s] != e.postprocess(ema[s])).sum()) for s in range(S))
    return res, (one_gemm if e.post_mats is not None else None)


def _ms_run(ms, frames, bg):
    """MS_TICKS ticks of ``ms`` from fresh EMAs: (outputs, masks, EMAs) a
    tick."""
    S = ms.n_streams
    ms.reset()
    outs = []
    for k in range(MS_TICKS):
        out, masks = ms.step(frames[k, :S], bg)
        outs.append((out, masks, ms.ema.clone()))
    return outs


def _solo_refs(path, cfg, frames, bg, margin):
    """Solo FramePipeline steps of each of MS_STREAMS streams over
    MS_TICKS ticks from fresh EMAs: for each tick and stream (output, mask,
    EMA, the plain path's decode margin)."""
    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline
    S = MS_STREAMS
    solos = [FramePipeline(path, cfg, device="cuda") for _ in range(S)]
    e = solos[0].maskgen.edge
    refs = []
    with torch.no_grad():
        for k in range(MS_TICKS):
            row = []
            for s in range(S):
                f = torch.from_numpy(frames[k, s]).cuda()
                prev = solos[s].maskgen.ema
                so, sm = solos[s].step(f, bg[s])
                row.append((so, sm, solos[s].maskgen.ema.clone(),
                            _edge_plain(e, f, prev, margin)[0]))
            refs.append(row)
    return e, refs


def _against_solo(tag, outs, refs, e, tie):
    """A batched run's ticks against the solo references: the decode flip
    rule at ``tie`` and the tolerance invariant outside the flips' post
    footprint.  Returns (flips, largest |margin| of a flip, differing
    bytes, each frame's differing share)."""
    import torch
    from backscrub_tpu_torch.pipeline.edge import post_footprint
    ever = [torch.zeros_like(refs[0][s][2], dtype=torch.bool) for s in range(MS_STREAMS)]
    fracs, diff_bytes, flips, worst = [], 0, 0, 0.0
    for (out, masks, ema_b), row in zip(outs, refs):
        for s, (so, sm, ema_s, mrg) in enumerate(row):
            kf, mm = _flip_rule(ema_b[s], ema_s, mrg, ever[s], tie=tie)
            flips, worst = flips + kf, max(worst, mm)
            foot = post_footprint(ema_b[s] != ema_s, e.geo, e.post_mats)
            pairs = [(out[s], so), (masks[s], sm)]
            fracs.append(_held_bytes(pairs, f"multistream {tag} stream {s}",
                                     [_yuyv_footprint(foot), foot]))
            diff_bytes += sum(int((a != b).sum()) for a, b in pairs)
    return flips, worst, diff_bytes, fracs


def _image_by_image(e):
    """Make the edge path ``e`` run its canvas contraction and executor
    remainder image by image (a diagnostic: the stages that a batch
    computes otherwise than one frame, ``_stage_trace``)."""
    import torch
    canvas, rest = e.canvas, e.rest
    e.canvas = lambda f: torch.stack([canvas(fi) for fi in f]) if f.dim() == 4 else canvas(f)
    if rest is not None:
        e.rest = lambda x: torch.cat([rest(x[i:i + 1]) for i in range(x.shape[0])])


def multistream_pipelines(frames):
    """MultiStreamPipeline on mlkit and deeplab at MS_SIZE, MS_STREAMS
    streams for MS_TICKS ticks from fresh EMAs (stream s the moving
    sequence of seed s): one K1, one launch of each body plan and one K3 a
    tick (counted from zero over the run), against solo FramePipeline steps
    of each stream under the decode flip rule (the solo path's plain
    margin) and the tolerance invariant outside the flips' post footprint;
    the differing bytes printed, and ``_stage_trace`` over every tick.
    mlkit must equal the solo steps bit for bit, at every stage and in
    every output byte (its fold-blur post takes a batch's products image by
    image, ``edge.fold_blur_post``); deeplab's flips are held to
    MS_DEEPLAB_TIE.  Then for both another batched run on the same frames
    with the canvas and the executor remainder image by image
    (``_image_by_image``), whose EMAs must equal the solo ones on every
    tick (no flip: the batch-size-dependent library algorithms of those two
    stages are deeplab's flips' cause), mlkit's bytes too; and for deeplab
    a planted fault, the batch's dots in one bf16 pass
    (``compute_dtype=bfloat16, precision="default"``), whose largest flip
    |margin| must exceed MS_DEEPLAB_TIE (the limit catches it).  Returns
    {family: numbers}.
    """
    import torch
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig

    w, h = MS_SIZE
    S, n = MS_STREAMS, MS_TICKS
    cfg = PipelineConfig(width=w, height=h)
    bg = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (S, h, w, 3), np.uint8)).cuda()
    res = {}
    for tag, path, margin, tie in (("mlkit", SELFIE, None, TIE),
                                   ("deeplab", DEEPLAB, _person_margin, MS_DEEPLAB_TIE)):
        ms = MultiStreamPipeline(path, cfg, S, device="cuda")
        ms.step(frames[0, :S], bg)        # warm-up
        plans = len(ms.pipe.maskgen.edge.plans)
        torch.cuda.synchronize()
        _zero_counts()
        body_launch.by_kernel.clear()
        with torch.no_grad():
            outs = _ms_run(ms, frames, bg)
        counts = _counts()
        want = dict(front=n, body=n * plans, pack=n, pack_420=0, bilateral=0, jpeg_decode=0)
        if counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": n * plans}:
            raise AssertionError(f"multistream {tag}: launches {counts} "
                                 f"{dict(body_launch.by_kernel)}, expected {want}")
        trace, one_gemm = _stage_trace(ms.pipe.maskgen.edge, frames)
        e, refs = _solo_refs(path, cfg, frames, bg, margin)
        with torch.no_grad():
            flips, flip_margin, diff_bytes, fracs = _against_solo(tag, outs, refs, e, tie)
        if float(np.mean(fracs)) > MEAN_TOL:
            raise AssertionError(f"multistream {tag}: {100 * np.mean(fracs):.4f}% of bytes "
                                 "differ on average")
        res[tag] = dict(streams=S, ticks=n, flips=flips, flip_margin=flip_margin, tie=tie,
                        differing_bytes=diff_bytes, mean_diff=float(np.mean(fracs)),
                        max_diff=max(fracs), stage_trace=trace, post_one_gemm=one_gemm)
        print(f"multistream {tag} {w}x{h}: {S} streams x {n} ticks, one K1, {plans} "
              f"bs_body_mega and one K3 launch a tick; against solo steps: decode flips "
              f"{flips} (largest |margin| {flip_margin:.3g}, limit {tie:.3g}), {diff_bytes} "
              f"bytes differ (mean {100 * res[tag]['mean_diff']:.4f}%, max "
              f"{100 * res[tag]['max_diff']:.4f}% of a frame's); elements each stage gives "
              f"otherwise over the batch than in a solo step on the same inputs, all ticks: "
              f"{trace}" + ("" if one_gemm is None else f"; the post as one GEMM over the "
                            f"batch's rows (control): {one_gemm}"))
        if tag == "mlkit" and (flips or diff_bytes or any(trace.values())):
            raise AssertionError(f"multistream mlkit: the stream batch departs from solo "
                                 f"steps: {flips} flips, {diff_bytes} bytes, stages {trace}")
        _image_by_image(ms.pipe.maskgen.edge)
        with torch.no_grad():
            outs = _ms_run(ms, frames, bg)
            ema_off = sum(int((ema_b[s] != row[s][2]).sum())
                          for (_, _, ema_b), row in zip(outs, refs) for s in range(S))
            if ema_off:
                raise AssertionError(f"multistream {tag}: with the canvas and the remainder "
                                     f"image by image, {ema_off} EMA bytes differ from solo "
                                     "steps")
            by_image = _against_solo(tag, outs, refs, e, 0.0)
        if tag == "mlkit" and by_image[2]:
            raise AssertionError(f"multistream mlkit: with the canvas image by image, "
                                 f"{by_image[2]} bytes differ from solo steps")
        res[tag].update(image_by_image_flips=by_image[0], image_by_image_bytes=by_image[2])
        print(f"multistream {tag}: with the canvas and the executor remainder image by "
              f"image, every EMA equals the solo steps' (0 flips), {by_image[2]} bytes differ")
        if margin is None:
            continue
        bad = MultiStreamPipeline(path, cfg, S, device="cuda", compute_dtype=torch.bfloat16,
                                  precision="default")
        with torch.no_grad():
            outs = _ms_run(bad, frames, bg)
            planted = max(_flip_margin(ema_b[s], row[s][2], row[s][3])[0]
                          for (_, _, ema_b), row in zip(outs, refs) for s in range(S))
        if planted <= tie:
            raise AssertionError(f"multistream {tag}: the planted fault's flips reach only "
                                 f"|margin| {planted:.3g}, within the limit {tie:.3g}")
        res[tag].update(planted_flip_margin=planted)
        print(f"multistream {tag}: planted fault (the batch's dots one bf16 pass): flips "
              f"reach |margin| {planted:.3g}, over the limit {tie:.3g}")
    return res


def _server_window(server, ticks):
    """A profiled window of ``ticks`` ticks of ``server`` (opened by an
    uncounted ``torch.cuda._sleep``): (host ms a tick between two
    synchronizations, device busy ms a tick)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks):
            if not server.tick():
                raise AssertionError("a server ran out of frames in its profiled window")
        server.finish()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / ticks
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key)
    return host, busy / 1e3 / ticks


def multistream_servers(frames):
    """MultiStreamServer (pull) on mlkit fused YUYV at MS_SIZE with S of
    MS_FPS_STREAMS: deliveries byte-identical to direct steps of the same
    batches; then fps per card (every stream's deliveries into counting
    sinks, the streams cycling over their frames): the median and range of
    MS_FPS_WINDOWS windows of at least MS_FPS_SECONDS each, and host ms,
    device busy and the idle share of a MS_WINDOW-tick profiled window.
    Returns {S: numbers}."""
    import torch
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer

    w, h = MS_SIZE
    cfg = PipelineConfig(width=w, height=h)
    res = {}
    for S in MS_FPS_STREAMS:
        n = MS_TICKS
        direct = MultiStreamPipeline(SELFIE, cfg, S, device="cuda")
        want = [[] for _ in range(S)]
        for k in range(n):
            out = direct.step(frames[k, :S])[0].cpu().numpy()
            for s in range(S):
                want[s].append(out[s].tobytes())
        got = [[] for _ in range(S)]
        server = MultiStreamServer(MultiStreamPipeline(SELFIE, cfg, S, device="cuda"),
                                   _ms_sources(frames[:n], S),
                                   [lambda a, g=g: g.append(a.tobytes()) for g in got])
        if server.run() != n or got != want:
            raise AssertionError(f"MultiStreamServer S={S}: deliveries differ from direct steps")
        delivered = [0]

        def count(_a):
            delivered[0] += 1

        server = MultiStreamServer(MultiStreamPipeline(SELFIE, cfg, S, device="cuda"),
                                   _ms_cycle(frames, S), [count] * S)
        server.ms.step(frames[0, :S])     # warm-up
        server.ms.reset()
        fps, ms_tick = [], []
        for _ in range(MS_FPS_WINDOWS):
            torch.cuda.synchronize()
            d0, ticks, t0 = delivered[0], 0, time.perf_counter()
            while time.perf_counter() - t0 < MS_FPS_SECONDS:
                if not server.tick():
                    raise AssertionError(f"S={S}: a cycling source ran out")
                ticks += 1
            server.finish()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if delivered[0] - d0 != S * ticks:
                raise AssertionError(f"S={S}: {ticks} ticks, {delivered[0] - d0} deliveries")
            fps.append(S * ticks / dt)
            ms_tick.append(dt * 1e3 / ticks)
        host, busy = _server_window(server, MS_WINDOW)
        res[S] = dict(fps=float(np.median(fps)), fps_min=min(fps), fps_max=max(fps),
                      fps_windows=fps, ms_per_tick=float(np.median(ms_tick)),
                      window_ms_per_tick=host, busy_ms_per_tick=busy,
                      idle_share=1 - busy / host)
        print(f"MultiStreamServer mlkit {w}x{h} S={S}: {n} ticks byte-identical to direct "
              f"steps; fps per card median {res[S]['fps']:.2f} [{min(fps):.2f}, "
              f"{max(fps):.2f}] over {MS_FPS_WINDOWS} windows of {MS_FPS_SECONDS:g} s "
              f"({res[S]['ms_per_tick']:.4f} ms a tick); profiled window of {MS_WINDOW} "
              f"ticks: host {host:.4f} ms a tick, device busy {busy:.4f} ms a tick, idle "
              f"share {res[S]['idle_share']:.3f}")
    return res


def multistream_geometries():
    """MultiGeometryServer with a 640x480 mlkit stream, a 1280x720
    segm_lite stream and an ``mjpg:`` stream (the synthetic MJPG camera at
    640x480 on mlkit): three buckets, each stream's deliveries
    byte-identical to direct steps of a one-stream MultiStreamPipeline on
    the frames its source gave."""
    from backscrub_tpu_torch.io.streams import JpegSource, SyntheticJpegCamera, SyntheticSource
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig
    from backscrub_tpu_torch.runtime.multistream import MultiGeometryServer

    n = 5
    jpeg = JpegSource(SyntheticJpegCamera(640, 480))
    specs = [(SyntheticSource(640, 480), 640, 480, None, SELFIE),
             (SyntheticSource(1280, 720), 1280, 720, None, MODEL),
             (jpeg, 640, 480, jpeg.jpeg_info, SELFIE)]
    fed = [[] for _ in specs]
    got = [[] for _ in specs]

    def source(src, k):
        def read():
            f = src.read()
            fed[k].append((tuple(c.copy() for c in f[0]), np.array(f[1]))
                          if isinstance(f, tuple) else f.copy())
            return f
        return read

    streams = [(source(src, k), got[k].append, w, h, None, info, model)
               for k, (src, w, h, info, model) in enumerate(specs)]
    server = MultiGeometryServer(SELFIE, PipelineConfig(width=0, height=0), streams,
                                 device="cuda")
    if server.n_groups != 3 or server.run(frames=n) != n:
        raise AssertionError("MultiGeometryServer: not three buckets of n ticks")
    jpeg.close()
    for k, (_, w, h, info, model) in enumerate(specs):
        cfg = PipelineConfig(width=w, height=h, input_format="mjpg" if info else "bgr",
                             jpeg_info=info)
        direct = MultiStreamPipeline(model, cfg, 1, device="cuda")
        for i in range(n):
            f = fed[k][i]
            batch = (tuple(c[None] for c in f[0]), np.asarray(f[1])[None]) if info else f[None]
            want = direct.step(batch)[0][0].cpu().numpy()
            if not np.array_equal(got[k][i], want):
                raise AssertionError(f"MultiGeometryServer stream {k} tick {i} differs from "
                                     "direct steps")
    print(f"MultiGeometryServer: mlkit 640x480, segm_lite 1280x720 and mjpg: 640x480 in "
          f"{server.n_groups} buckets, {n} ticks, every delivery byte-identical to direct "
          f"steps of its bucket")


def multistream_cli():
    """``cli_multi.main`` in-process: three ``test:`` streams (two at
    640x480, one at 1280x720, the mlkit model) to ``file:`` sinks for
    MS_CLI_FRAMES frames, counted from zero: each file exactly the frames'
    bytes of direct steps of its bucket, and K1, K2 and K3 launched once a
    tick a bucket."""
    import contextlib
    import io
    import tempfile
    from backscrub_tpu_torch import cli_multi
    from backscrub_tpu_torch.io.streams import SyntheticSource
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig

    n = MS_CLI_FRAMES
    geos = ((640, 480), (640, 480), (1280, 720))
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, f"s{k}.yuv") for k in range(len(geos))]
        argv = ["-m", SELFIE, "--frames", str(n)]
        for (w, h), f in zip(geos, files):
            argv += ["--stream", f"src=test:,sink=file:{f},geo={w}x{h}"]
        err = io.StringIO()
        _zero_counts()
        body_launch.by_kernel.clear()
        with contextlib.redirect_stderr(err):
            rc = cli_multi.main(argv)
        counts = _counts()
        sys.stderr.write(err.getvalue())
        want = dict(front=2 * n, body=2 * n, pack=2 * n, pack_420=0, bilateral=0,
                    jpeg_decode=0)
        if rc != 0 or counts != want or dict(body_launch.by_kernel) != {"bs_body_mega": 2 * n}:
            raise AssertionError(f"cli_multi: rc {rc}, launches {counts} "
                                 f"{dict(body_launch.by_kernel)}, expected {want}")
        data = []
        for f in files:
            with open(f, "rb") as fh:
                data.append(fh.read())
    for (w, h), members in (((640, 480), (0, 1)), ((1280, 720), (2,))):
        ms = MultiStreamPipeline(SELFIE, PipelineConfig(width=w, height=h), len(members),
                                 device="cuda")
        srcs = [SyntheticSource(w, h) for _ in members]
        outs = [ms.step(np.stack([s.read() for s in srcs]))[0].cpu().numpy()
                for _ in range(n)]
        for j, k in enumerate(members):
            want = b"".join(o[j].tobytes() for o in outs)
            if data[k] != want:
                raise AssertionError(f"cli_multi stream {k}: {len(data[k])} bytes, not the "
                                     f"{len(want)} of {n} direct steps of its bucket")
    print(f"cli_multi: 3 test: streams in 2 buckets, {n} frames each, every file "
          f"byte-identical to direct steps of its bucket, K1, K2 and K3 once a tick a bucket")


def multistream_phase():
    """The multi-stream slice on the card: ``multistream_kernels``,
    ``multistream_pipelines``, ``multistream_servers``,
    ``multistream_geometries`` and ``multistream_cli``.  Returns (the
    batched kernel numbers, the ``multistream:`` line's numbers)."""
    w, h = MS_SIZE
    frames = _stream_frames(w, h, max(MS_FPS_STREAMS + MS_BATCHES + (MS_STREAMS,)), MS_TICKS)
    batched = multistream_kernels(frames)
    line = dict(pipelines=multistream_pipelines(frames),
                fps_per_card={f"S={S}": r for S, r in multistream_servers(frames).items()})
    multistream_geometries()
    multistream_cli()
    line["kernels"] = {k: {f"S={S}": {n: v for n, v in r.items()}
                           for S, r in by_s.items()} for k, by_s in batched.items()}
    return batched, line


CAPI_SIZE, CAPI_FRAMES = (640, 480), 60   # the C ABI phase: segm_lite, SyntheticSource
CAPI_TIMEOUT = 300                        # the demo's subprocess, startup included
CAPI_WINDOW_S, CAPI_PAIRS = 2.0, 5        # each timed turn's least window; C/process pairs


def _capi_lib():
    """The port's C ABI (``_build.capi_library``) loaded by ctypes into this
    interpreter, its argument types set."""
    import ctypes
    from backscrub_tpu_torch import _build
    lib = ctypes.CDLL(_build.capi_library())
    P, S = ctypes.c_void_p, ctypes.c_size_t
    lib.bs_tensorflow_version.restype = ctypes.c_char_p
    lib.bs_maskgen_new_ex.restype = P
    lib.bs_maskgen_new_ex.argtypes = [ctypes.c_char_p, S, S, S, ctypes.c_char_p] + [P] * 5
    lib.bs_maskgen_process.restype = ctypes.c_bool
    lib.bs_maskgen_process.argtypes = [P, P, P]
    lib.bs_maskgen_delete.argtypes = [P]
    return lib


def _capi_run(lib, frames, options=b"", hooks=(None, None, None), ondebug=None,
              window_s=0.0):
    """A context on the synthetic segm_lite model at CAPI_SIZE, every frame
    through ``bs_maskgen_process`` (the frames over and over until
    ``window_s`` has passed, at least once), then deleted: (the first
    pass's masks (n, H, W) u8, host ms a frame of the process loop)."""
    import ctypes
    (w, h), n = CAPI_SIZE, len(frames)
    ptr = (lambda f: ctypes.cast(f, ctypes.c_void_p) if f is not None else None)
    ctx = lib.bs_maskgen_new_ex(MODEL.encode(), 2, w, h, options, ptr(ondebug),
                                *map(ptr, hooks), None)
    if not ctx:
        raise AssertionError(f"bs_maskgen_new_ex({options!r}) returned NULL")
    masks, spare = np.zeros((n, h, w), np.uint8), np.zeros((h, w), np.uint8)
    done = 0
    t0 = time.perf_counter()
    while True:
        for i, f in enumerate(frames):
            dst = masks[i] if done < n else spare
            if not lib.bs_maskgen_process(ctx, f.ctypes.data, dst.ctypes.data):
                raise AssertionError(f"bs_maskgen_process failed at frame {done}")
            done += 1
        if time.perf_counter() - t0 >= window_s:
            break
    ms = (time.perf_counter() - t0) * 1e3 / done
    lib.bs_maskgen_delete(ctx)
    return masks, ms


def _maskgen_loop(frames, as_bytes=False, window_s=0.0, **kw):
    """An in-process ``MaskGen`` on the card over ``frames`` (over and over
    until ``window_s`` has passed, at least once): (the first pass's masks,
    host ms a frame of the loop, ended by a synchronization).  ``as_bytes``
    calls ``process_bytes``, the C ABI's own entry, in place of
    ``process``."""
    import torch
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    (w, h), n = CAPI_SIZE, len(frames)
    mg = MaskGen(MODEL, w, h, device="cuda", **kw)
    call = ((lambda f: mg.process_bytes(f.tobytes(), h, w)) if as_bytes else mg.process)
    out, done = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        for f in frames:
            m = call(f)
            if done < n:
                out.append(m)
            done += 1
        if time.perf_counter() - t0 >= window_s:
            break
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / done
    if as_bytes:
        return np.stack([np.frombuffer(b, np.uint8).reshape(h, w) for b in out]), ms
    return torch.stack(out).cpu().numpy(), ms


def _capi_counts(what, want, body):
    counts = _counts()
    from backscrub_tpu_torch.ops.megakernel import body_launch
    by_kernel = dict(body_launch.by_kernel)
    if counts != want or by_kernel != body:
        raise AssertionError(f"capi {what}: launches {counts} {by_kernel}, expected {want} "
                             f"{body}")
    return counts


def capi_phase():
    """The C ABI on the card (``backscrub_tpu_torch/native/bs_capi.cc``): the
    shim by ctypes in this interpreter, fused (K1 and K2 a frame, ``onmask``
    a frame) and staged (K5 a frame, the hooks in the reference order), each
    byte-identical to an in-process ``MaskGen`` on the same frames; NULL with
    an ``ondebug`` message for an unknown option, a missing model and an
    unknown ``BACKSCRUB_TORCH_DEVICE``; the native consumer
    (``native/demo.cc`` linked against the shim) as a subprocess on the same
    frames from a raw BGR file, its masks byte-equal to the fused C path's
    and its YUYV to the plain composite of those masks; ``entry()`` over
    four frames byte-identical to ``FramePipeline.step`` in one K1, K2 and
    K3 launch a call; and
    host ms a frame of the C loop against ``MaskGen.process`` in turns of at
    least CAPI_WINDOW_S, CAPI_PAIRS alternating C/process pairs, then
    ``process_bytes`` twice.  Returns (the
    ``capi:`` line's numbers, the C path's launches by kernel)."""
    import ctypes
    import site
    import tempfile
    import torch
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.entry import entry
    from backscrub_tpu_torch.io.streams import SyntheticSource
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.pipeline.image import alpha_blend_u8, flip, rgb_to_yuyv

    (w, h), n = CAPI_SIZE, CAPI_FRAMES
    os.environ.pop("BACKSCRUB_TORCH_DEVICE", None)   # the C ABI's default: the card
    t0 = time.perf_counter()
    lib = _capi_lib()
    build_s = time.perf_counter() - t0
    version = lib.bs_tensorflow_version().decode()
    if version != f"torch-{torch.__version__}":
        raise AssertionError(f"bs_tensorflow_version: {version}")
    src = SyntheticSource(w, h)
    frames = [np.ascontiguousarray(src.read()) for _ in range(n)]
    res = {"version": version, "shim_build_s": build_s}
    CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
    DBG = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_char_p)

    # (a) fused: onmask (and ondebug) only
    want_fused, _ = _maskgen_loop(frames)
    fired = collections.Counter()
    onmask = CB(lambda _c: fired.update(["mask"]))
    _zero_counts()
    body_launch.by_kernel.clear()
    fused, _ = _capi_run(lib, frames, hooks=(None, None, onmask))
    launches = _capi_counts("fused", dict(front=n, body=n, pack=0, pack_420=0, bilateral=0,
                                          jpeg_decode=0), {"bs_body_mega": n})
    if dict(fired) != {"mask": n} or not np.array_equal(fused, want_fused):
        raise AssertionError(f"capi fused: hooks {dict(fired)}, masks "
                             f"{int((fused != want_fused).sum())} bytes off MaskGen's")

    # (b) staged: every stage hook, in the reference order
    want_staged, _ = _maskgen_loop(frames, fused=False)
    order = []
    hooks = tuple(CB(lambda _c, k=k: order.append(k)) for k in ("prep", "infer", "mask"))
    _zero_counts()
    body_launch.by_kernel.clear()
    staged, _ = _capi_run(lib, frames, hooks=hooks)
    launches["bilateral"] = _capi_counts(
        "staged", dict(front=0, body=0, pack=0, pack_420=0, bilateral=n, jpeg_decode=0),
        {})["bilateral"]
    if order != ["prep", "infer", "mask"] * n or not np.array_equal(staged, want_staged):
        raise AssertionError(f"capi staged: hooks {order[:6]}... ({len(order)}), masks "
                             f"{int((staged != want_staged).sum())} bytes off MaskGen's")

    # (c) failures come back as NULL with an ondebug message
    for what, model, options, env, want in (
            ("unknown option", MODEL, b"bogus:1", None, b"unknown maskgen option"),
            ("missing model", "/no/such/model.tflite", b"", None, b"not found"),
            ("unknown device", MODEL, b"", "bogus", b"BACKSCRUB_TORCH_DEVICE")):
        msgs = []
        ondebug = DBG(lambda _c, m: msgs.append(m))
        if env:
            os.environ["BACKSCRUB_TORCH_DEVICE"] = env
        try:
            ctx = lib.bs_maskgen_new_ex(model.encode(), 2, w, h, options,
                                        ctypes.cast(ondebug, ctypes.c_void_p),
                                        None, None, None, None)
        finally:
            os.environ.pop("BACKSCRUB_TORCH_DEVICE", None)
        if ctx or not any(want in m for m in msgs):
            raise AssertionError(f"capi {what}: context {ctx}, ondebug {msgs}")

    # (d) the native consumer on the same frames, from a raw BGR file
    t0 = time.perf_counter()
    demo = _build.native_program()
    res["demo_build_s"] = time.perf_counter() - t0
    env = dict(os.environ, PYTHONPATH=":".join([REPO] + site.getsitepackages()))
    with tempfile.TemporaryDirectory() as tmp:
        src_path, out, dump = (os.path.join(tmp, f) for f in ("in.bgr", "out.yuyv", "m.raw"))
        with open(src_path, "wb") as fh:
            for f in frames:
                fh.write(f.tobytes())
        t0 = time.perf_counter()
        r = subprocess.run([demo, "--cg", f"{w}x{h}", "-n", str(n), "-H", "-c", src_path,
                            "-v", out, "--dump-mask", dump, "-m", MODEL, "-d"],
                           env=env, capture_output=True, text=True, timeout=CAPI_TIMEOUT)
        res["demo_wall_s"] = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"demo exit {r.returncode}: {r.stderr[-3000:]}")
        yuyv = np.fromfile(out, np.uint8)
        dmasks = np.fromfile(dump, np.uint8)
    if dmasks.size != n * h * w or not np.array_equal(dmasks.reshape(n, h, w), fused):
        raise AssertionError("demo masks: not byte-equal to the fused C path's")
    green = torch.zeros((h, w, 3), dtype=torch.uint8)
    green[..., 1] = 255
    for i, f in enumerate(frames):
        comp = flip(alpha_blend_u8(green, torch.from_numpy(f), torch.from_numpy(fused[i])),
                    horizontal=True)
        want = rgb_to_yuyv(comp, chroma_order="reference").numpy().tobytes()
        if yuyv[i * h * w * 2:(i + 1) * h * w * 2].tobytes() != want:
            raise AssertionError(f"demo YUYV frame {i}: not the plain composite's bytes")
    fps = [float(ln.rsplit(None, 2)[-2]) for ln in r.stderr.splitlines()
           if ln.startswith("frame ")]
    stages = collections.defaultdict(list)
    for ln in r.stderr.splitlines():
        if ln.startswith("frame "):
            parts = ln.split()
            for k in ("grab", "mask", "post", "sink"):
                stages[k].append(int(parts[parts.index(k) + 1]) / 1e6)
    warm = slice(10, None)   # the first frames build and warm the plans
    res["demo"] = dict(frames=n, fps_median=float(np.median(fps[warm])),
                       fps_min=float(np.min(fps[warm])), fps_max=float(np.max(fps[warm])),
                       **{f"{k}_ms_median": float(np.median(v[warm])) for k, v in stages.items()})

    # (e) the flagship entry on its example frame and three more, the EMA
    # carried: one K1, K2 and K3 launch a call, FramePipeline.step's bytes
    fn, (frame, bg, ema) = entry(MODEL, device="cuda")
    pipe = FramePipeline(MODEL, PipelineConfig(width=640, height=480), device="cuda")
    for k, f in enumerate([frame] + [torch.from_numpy(x).cuda() for x in frames[:3]]):
        want_out, want_mask = pipe.step(f, bg)
        _zero_counts()
        body_launch.by_kernel.clear()
        out, mask, ema = fn(f, bg, ema)
        _capi_counts("entry", dict(front=1, body=1, pack=1, pack_420=0, bilateral=0,
                                   jpeg_decode=0), {"bs_body_mega": 1})
        if not (torch.equal(out, want_out) and torch.equal(mask, want_mask)
                and torch.equal(ema, pipe.maskgen.ema)):
            raise AssertionError(f"entry() call {k}: not byte-identical to FramePipeline.step")

    # (f) host ms a frame in turns of at least CAPI_WINDOW_S each: CAPI_PAIRS
    # C/process pairs in alternating order (C P, P C, C P, ...), then
    # process_bytes twice
    kinds = [k for i in range(CAPI_PAIRS) for k in (("c", "process"), ("process", "c"))[i % 2]]
    turns = []
    for kind in kinds + ["process_bytes", "process_bytes"]:
        if kind == "c":
            m, ms = _capi_run(lib, frames, window_s=CAPI_WINDOW_S)
        else:
            m, ms = _maskgen_loop(frames, as_bytes=kind == "process_bytes",
                                  window_s=CAPI_WINDOW_S)
        if not np.array_equal(m, fused):
            raise AssertionError(f"capi timing turn {kind}: masks differ")
        turns.append((kind, ms))
    res["window_s"] = CAPI_WINDOW_S
    res["turns_ms_per_frame"] = [[k, ms] for k, ms in turns]
    by = collections.defaultdict(list)
    for k, ms in turns:
        by[k].append(ms)
    # each C turn less the process turn of its pair
    over = [c - p for c, p in zip(by["c"], by["process"])]
    res["c_overhead_ms_per_frame"] = over
    res["c_overhead_ms_median"] = float(np.median(over))
    res["process_ms_spread"] = max(by["process"]) - min(by["process"])
    res["c_ms_spread"] = max(by["c"]) - min(by["c"])
    print(f"capi {w}x{h}: {version}; fused C path {n} frames byte-identical to MaskGen, "
          f"launches {launches}; staged byte-identical, hooks in order; NULL + ondebug for "
          f"3 faults; demo masks and YUYV byte-equal, median {res['demo']['fps_median']:.1f} "
          f"fps; entry() = FramePipeline.step in one K1/K2/K3; ms/frame in turns of "
          f">= {CAPI_WINDOW_S} s " + ", ".join(f"{k} {ms:.4f}" for k, ms in turns)
          + f"; C overhead median {res['c_overhead_ms_median']:.4f} ms/frame over "
          f"{CAPI_PAIRS} pairs (process turns' spread {res['process_ms_spread']:.4f}, "
          f"C turns' {res['c_ms_spread']:.4f})")
    return res, launches


TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = (640, 480), 8, 4, 1e-3
TRAIN_TIMED = 5            # card steps timed on the host clock and by the profiler


def train_phase(smi):
    """Fine-tuning on the card (the port's ``train/``): TRAIN_BATCH seeded
    moving frames at TRAIN_SIZE labelled by the mlkit teacher's fused
    ``MaskGen`` (one K1 and one K2 launch a frame, counted from zero, then
    the tail), segm_lite distilled on them at its full 96x160 input and
    published widths, TRAIN_STEPS Adam steps on the card of the batches
    ``SegmentationData.batches`` draws (flips and jitter) and the same
    steps from the same parameters on the CPU: every loss finite, the last
    below the first, the card's losses within rtol 1e-4 of the CPU's and
    its parameters within 2·lr·n; TF32 off inside ``Trainer``.  A
    checkpoint written before the last step and resumed by a fresh card
    Trainer gives the uninterrupted run's last loss.  The tuned weights
    export to a ``.tflite`` that the port's loader reads back as their f16
    rounding, served by ``family_fused`` (one K1, K2 and K3 launch a frame,
    against the plain path).  Then host ms and device ms a train step (a
    separate Trainer; ``device_ms`` over TRAIN_TIMED steps).  Returns (the
    numbers, the launches of K1, K2 and K3)."""
    import tempfile
    import torch
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.pipeline.maskgen import MaskGen
    from backscrub_tpu_torch.tflite.export import export_params_to_tflite
    from backscrub_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from backscrub_tpu_torch.train.data import SegmentationData
    from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer
    from make_synth_segm import moving_frames

    t0 = time.perf_counter()
    w, h = TRAIN_SIZE
    spec, cfg = spec_for_model(MODEL), TrainConfig(learning_rate=TRAIN_LR)
    teacher = MaskGen(SELFIE, w, h, device="cuda")
    if teacher.edge is None:
        raise AssertionError("the mlkit teacher did not take the fused path")
    card, host = load_model(MODEL, "cuda"), load_model(MODEL, "cpu")
    frames = moving_frames(w, h, TRAIN_BATCH, seed=7)
    _zero_counts()
    ds = SegmentationData.self_label(frames, teacher, card, spec)
    teacher_launches = _counts()
    want = dict(front=TRAIN_BATCH, body=TRAIN_BATCH, pack=0, pack_420=0, bilateral=0,
                jpeg_decode=0)
    if teacher_launches != want:
        raise AssertionError(f"teacher labels: launches {teacher_launches}, expected {want}")
    person = float((ds.y > 0.5).mean())
    if not 0.01 < person < 0.99:
        raise AssertionError(f"degenerate teacher labels: person share {person}")
    batches = list(ds.batches(TRAIN_BATCH, rng=np.random.default_rng(0), epochs=TRAIN_STEPS))

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tg, tc = Trainer(card, spec, config=cfg), Trainer(host, spec, config=cfg)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("Trainer left TF32 on")
    ckpt_dir = tempfile.mkdtemp(prefix="bs_train_")
    ckpt = os.path.join(ckpt_dir, "ck.npz")
    losses_card, losses_cpu = [], []
    for i, (x, y) in enumerate(batches):
        if i == TRAIN_STEPS - 1:
            save_checkpoint(ckpt, tg.params, tg.opt_state, step=i)
        losses_card.append(tg.step(x, y))
        losses_cpu.append(tc.step(x, y))
    if not np.all(np.isfinite(losses_card)) or not losses_card[-1] < losses_card[0]:
        raise AssertionError(f"card losses {losses_card}: not finite or not falling")
    rel = float(np.max(np.abs(np.subtract(losses_card, losses_cpu)) / np.abs(losses_cpu)))
    if rel > 1e-4:
        raise AssertionError(f"card losses {losses_card} vs CPU {losses_cpu}: rel {rel:.3g}")
    worst, off, total = 0.0, 0, 0
    for k, v in tc.params.items():
        d = (tg.params[k].detach().cpu() - v.detach()).abs()
        worst, off, total = max(worst, float(d.max())), off + int((d > 1e-6).sum()), total + d.numel()
    if worst > 2 * TRAIN_LR * TRAIN_STEPS:
        raise AssertionError(f"card parameters {worst:.3g} from the CPU's after "
                             f"{TRAIN_STEPS} steps, over 2·lr·n")
    resumed = Trainer(card, spec, config=cfg)
    params, opt, step = load_checkpoint(ckpt, resumed.params, resumed.opt_state)
    resumed.params, resumed.opt_state = params, opt
    resumed_loss = resumed.step(*batches[-1])
    if step != TRAIN_STEPS - 1 or resumed_loss != losses_card[-1]:
        raise AssertionError(f"resumed at step {step}: loss {resumed_loss!r}, the "
                             f"uninterrupted run's {losses_card[-1]!r}")

    tuned = os.path.join(ckpt_dir, "segm_tuned_96x160.tflite")
    written = export_params_to_tflite(MODEL, card, tg.params, tuned)
    back = load_model(tuned, "cuda")
    for k, v in tg.params.items():
        if not torch.equal(back.params[k], v.detach().half().float()):
            raise AssertionError(f"the exported {k} does not read back as its f16 rounding")
    served = family_fused("segm tuned", tuned, w, h)   # one K1, K2, K3 a frame, checked
    shutil.rmtree(ckpt_dir)

    timer = Trainer(card, spec, config=cfg)
    x, y = batches[0]
    for _ in range(2):
        timer.step(x, y)
    t1 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        timer.step(x, y)
    step_ms = (time.perf_counter() - t1) * 1e3 / TRAIN_TIMED
    step_device_ms = device_ms(lambda: timer.step(x, y), n=TRAIN_TIMED, warmup=0)
    seconds = time.perf_counter() - t0
    res = dict(card=smi, teacher_launches=teacher_launches, person_share=person,
               losses_card=losses_card, losses_cpu=losses_cpu, loss_rel_max=rel,
               param_diff_max=worst, param_share_over_1e6=off / total,
               resumed_loss=resumed_loss, exported_tensors=written,
               ms_per_step=step_ms, device_ms_per_step=step_device_ms,
               idle_share=1 - step_device_ms / step_ms, seconds=seconds,
               served={k: v for k, v in served.items() if k != "phase_us"})
    print(f"train ({smi}): teacher labels in one K1 and K2 launch a frame; segm_lite batch "
          f"{TRAIN_BATCH}, {TRAIN_STEPS} Adam steps: card losses {losses_card}, CPU "
          f"{losses_cpu} (rel {rel:.3g}), parameters {worst:.3g} apart at most "
          f"({100 * off / total:.3f}% over 1e-6); resumed loss equal; {written} tensors "
          f"exported and served; {step_ms:.3f} ms a step (host clock), device busy "
          f"{step_device_ms:.3f} ms")
    return res, {k: teacher_launches[k] + FAMILY_FRAMES for k in ("front", "body", "pack")}


MESH_TIMEOUT = 300         # the mesh child's time limit, its start and NCCL's included
MESH_SIZE, MESH_STREAMS, MESH_TICKS = (640, 480), 3, 10
MESH_TRAIN_BATCH, MESH_TRAIN_STEPS = 8, 3
MESH_WINDOW_S, MESH_PAIRS = 2.0, 3     # each timed turn's least window; one-card/mesh pairs
MESH_PROFILED = dict(tick=40, server=40, step=10)   # calls in a profiled window
MESH_TOP = 8               # host operations listed a kind, by their own time


def mesh_phase(smi):
    """The (data, model) mesh on the card (``parallel/mesh.py``): NCCL
    puts no two ranks on one card, so on this machine the world is one
    rank and the mesh (1, 1); every collective of the path still runs, on
    groups of one.  ``mesh_child`` runs in a child process under
    MESH_TIMEOUT, so an NCCL start that hangs fails the phase instead of
    stalling the script; a child that fails fails the script.  Returns
    (the numbers, the mesh path's launches of K1, K2, K2' and K3)."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mesh.json")
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-child", out],
                           cwd=REPO, capture_output=True, text=True, timeout=MESH_TIMEOUT)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            raise AssertionError(f"the mesh child exited {r.returncode}:\n{r.stderr[-4000:]}")
        with open(out) as f:
            res = json.load(f)
    res["card"], res["seconds"] = smi, time.perf_counter() - t0
    launches = res.pop("launches")
    t = res["timing"]
    print(f"mesh ({smi}): the world of one, mesh {res['mesh']}: dryrun, frame path, server "
          f"and cli_multi --data-axis 2 byte-identical to the no-mesh path; train step losses "
          f"{res['train']['losses_mesh']} vs one card {res['train']['losses_one']} (rel "
          f"{res['train']['loss_rel_max']:.3g}), parameters {res['train']['param_diff_max']:.3g}"
          f" apart; host ms a call, median of {res['pairs']} turns of >= {res['window_s']} s "
          f"(spread), then a profiled window's device busy ms and idle share: "
          + "; ".join(f"{k} {v['median_ms']:.4f} ({v['spread_ms']:.4f}), busy "
                      f"{v['busy_ms']:.4f}, idle {v['idle_share']:.3f}" for k, v in t.items())
          + f"; launches {launches}")
    return res, launches


def mesh_child(out_path):
    """The mesh phase's work, in a world of one on NCCL: the dryrun, then
    the no-mesh references, then the mesh path from zeroed counts (the
    frame path's MultiStreamPipeline, a MultiGeometryServer of a segm_lite
    bucket and a BodyPix bucket on K2', and ``cli_multi --data-axis 2``
    with three ``test:`` streams to files), each byte-identical to its
    reference; a (1, 1) dp + tp + sp train step against the one-card
    Trainer (losses rtol 1e-6, parameters within 2·lr·n); host ms a
    frame-path tick, a server tick and a train step with and without the
    mesh in alternating turns, and device busy over a profiled window."""
    import contextlib
    import io
    import tempfile
    import torch
    import torch.distributed as dist
    from backscrub_tpu_torch import _build, cli_multi
    from backscrub_tpu_torch.entry import dryrun_multichip
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.models.specs import spec_for_model
    from backscrub_tpu_torch.ops.megakernel import body_launch
    from backscrub_tpu_torch.parallel.mesh import make_mesh
    from backscrub_tpu_torch.parallel.streams import MultiStreamPipeline
    from backscrub_tpu_torch.pipeline.frame import PipelineConfig
    from backscrub_tpu_torch.runtime.multistream import MultiGeometryServer
    from backscrub_tpu_torch.train.trainer import TrainConfig, Trainer

    _build.lib()
    dry = dryrun_multichip(1, device="cuda")
    mesh = make_mesh(1, device="cuda")
    w, h = MESH_SIZE
    S, n = MESH_STREAMS, MESH_TICKS
    frames = _stream_frames(w, h, S, n)
    cfg = PipelineConfig(width=w, height=h)

    def server(m):
        """A segm_lite bucket of two streams and a BodyPix bucket of one,
        pull mode, n ticks: each stream's deliveries, and the server."""
        got = [[] for _ in range(S)]
        its = [iter(frames[:, s]) for s in range(S)]
        streams = [(lambda it=its[s]: next(it, None), got[s].append, w, h, None, None,
                    BODYPIX if s == S - 1 else None) for s in range(S)]
        srv = MultiGeometryServer(MODEL, PipelineConfig(width=0, height=0), streams, m,
                                  device="cuda")
        if srv.run(frames=n) != n or srv.n_groups != 2:
            raise AssertionError("mesh server: not two buckets of n ticks")
        return [b"".join(a.tobytes() for a in g) for g in got], srv

    def cli(tmp, extra):
        files = [os.path.join(tmp, f"{extra and 'mesh'}{k}.yuv") for k in range(S)]
        argv = ["-m", MODEL, "--frames", str(n), *extra]
        for f in files:
            argv += ["--stream", f"src=test:,sink=file:{f},geo={w}x{h}"]
        with contextlib.redirect_stderr(io.StringIO()):
            if cli_multi.main(argv) != 0:
                raise AssertionError(f"cli_multi {extra} failed")
        out = []
        for f in files:
            with open(f, "rb") as fh:
                out.append(fh.read())
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # the references, off the mesh
        one = MultiStreamPipeline(MODEL, cfg, S, device="cuda")
        ref_pipe = [tuple(a.cpu().numpy() for a in one.step(f)) for f in frames]
        ref_server, _ = server(None)
        ref_cli = cli(tmp, [])
        # the mesh path, counted from zero
        _zero_counts()
        meshed = MultiStreamPipeline(MODEL, cfg, S, mesh)
        got_pipe = [tuple(a.cpu().numpy() for a in meshed.step(f)) for f in frames]
        got_server, srv = server(mesh)
        got_cli = cli(tmp, ["--data-axis", "2"])
        counts = _counts()
    bp = srv.servers[[k[0] for k in srv._keys].index(BODYPIX)].ms.pipe.maskgen.edge.prefix_plan
    launches = dict(front=counts["front"], body=counts["body"] - bp.launches,
                    body_prefix=bp.launches, pack=counts["pack"])
    want = dict(front=n + 2 * n + n, body=n + n + n, body_prefix=n, pack=n + 2 * n + n)
    if launches != want or counts["pack_420"] or counts["bilateral"]:
        raise AssertionError(f"mesh path launches {counts} ({launches}), expected {want}")
    for tag, got, ref in (("frame path", got_pipe, ref_pipe), ("server", got_server, ref_server),
                          ("cli_multi --data-axis 2", got_cli, ref_cli)):
        for a, b in zip(got, ref):
            if not all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) \
                    else a != b:
                raise AssertionError(f"mesh {tag}: not byte-identical to the no-mesh path")

    # the (1, 1) mesh train step, dp + tp + sp, against the one-card Trainer
    rng = np.random.default_rng(11)
    x = rng.random((MESH_TRAIN_BATCH, 96, 160, 3), np.float32)
    y = (rng.random((MESH_TRAIN_BATCH, 96, 160)) > 0.5).astype(np.float32)
    spec = spec_for_model(MODEL)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, spatial_shard=True)
    tm = Trainer(load_model(MODEL, "cuda"), spec, mesh, tcfg)
    to = Trainer(load_model(MODEL, "cuda"), spec, config=TrainConfig(learning_rate=TRAIN_LR))
    lm = [tm.step(x, y) for _ in range(MESH_TRAIN_STEPS)]
    lo = [to.step(x, y) for _ in range(MESH_TRAIN_STEPS)]
    rel = float(np.max(np.abs(np.subtract(lm, lo)) / np.abs(lo)))
    pm, po = tm.params, to.params
    worst = max(float((pm[k] - v.detach()).abs().max()) for k, v in po.items())
    if rel > 1e-6 or worst > 2 * TRAIN_LR * MESH_TRAIN_STEPS:
        raise AssertionError(f"mesh train step: losses {lm} vs one card {lo} (rel {rel:.3g}), "
                             f"parameters {worst:.3g} apart")

    # host ms a call in turns of at least MESH_WINDOW_S, MESH_PAIRS pairs in
    # alternating order (one card first, then the mesh first, ...): the
    # frame path's tick (the mesh's also without its gathers, step_local on
    # its rows), a MultiStreamServer's tick (pull, three endless sources)
    # and a train step; then a profiled window of each for device busy
    from backscrub_tpu_torch.parallel.streams import take_rows
    from backscrub_tpu_torch.runtime.multistream import MultiStreamServer

    def endless(s):
        it = itertools.cycle(frames[:, s])
        return lambda: next(it)

    servers = {who: MultiStreamServer(p, [endless(s) for s in range(S)],
                                      [lambda _o: None] * S)
               for who, p in (("one", one), ("mesh", meshed))}
    calls = {("tick", "one"): lambda: one.step(frames[0]),
             ("tick", "mesh"): lambda: meshed.step(frames[0]),
             ("tick", "local"): lambda: meshed.step_local(take_rows(frames[0], meshed.rows)),
             ("server", "one"): servers["one"].tick,
             ("server", "mesh"): servers["mesh"].tick,
             ("step", "one"): lambda: to.step(x, y),
             ("step", "mesh"): lambda: tm.step(x, y)}

    def turn(fn):
        fn()
        torch.cuda.synchronize()
        k, t = 0, time.perf_counter()
        while time.perf_counter() - t < MESH_WINDOW_S:
            fn()
            k += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / k

    turns = collections.defaultdict(list)
    for i in range(MESH_PAIRS):
        for what in ("tick", "server", "step"):
            for who in (("one", "mesh"), ("mesh", "one"))[i % 2]:
                turns[what, who].append(turn(calls[what, who]))
                if (what, who) == ("tick", "mesh"):
                    turns["tick", "local"].append(turn(calls["tick", "local"]))

    def profiled(fn, n):
        """(host ms, device busy ms) a call over a profiled window of n
        calls, opened by an uncounted ``torch.cuda._sleep``."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t) * 1e3 / n
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key)
        if not busy:
            raise AssertionError("the profiler saw no device time in the mesh's window")
        return host, busy / 1e3 / n

    def host_ops(fn, n):
        """The host's operations by their own time, us a call, over a window
        of n calls profiled on the host (which slows the host: shares only)."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ev = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        total = sum(e.self_cpu_time_total for e in ev)
        return dict(total_us=total / n,
                    top=[[e.key, e.self_cpu_time_total / n, e.count / n] for e in ev[:MESH_TOP]])

    timing = {}
    for (what, who), ms in turns.items():
        host, busy = profiled(calls[what, who], MESH_PROFILED[what])
        timing[f"{what}_{who}"] = dict(
            turns_ms=ms, median_ms=float(np.median(ms)), spread_ms=max(ms) - min(ms),
            profiled_host_ms=host, busy_ms=busy, idle_share=1 - busy / host,
            host_ops=host_ops(calls[what, who], MESH_PROFILED[what]))
    for srv in servers.values():
        srv.finish()
    res = dict(mesh=dict(mesh.shape), world=dist.get_world_size(), backend=dist.get_backend(),
               dryrun=dry, launches=launches, ticks=n, streams=S,
               window_s=MESH_WINDOW_S, pairs=MESH_PAIRS, timing=timing,
               train=dict(losses_mesh=lm, losses_one=lo, loss_rel_max=rel, param_diff_max=worst,
                          batch=MESH_TRAIN_BATCH))
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def device_check():
    """A pipeline built without ``device=`` runs on the card."""
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    pipe = FramePipeline(MODEL, PipelineConfig(width=320, height=240))
    if pipe.device.type != "cuda" or pipe.maskgen.ema.device.type != "cuda":
        raise AssertionError(f"the default device is {pipe.device}, not cuda")
    print(f"default device: {pipe.device}")


def sass_functions(path=None):
    """{function header: its SASS} of the library at ``path``, the built
    one by default (``cuobjdump -sass``)."""
    from backscrub_tpu_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path or _build.library_path()], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return {fn.split("\n", 1)[0]: fn for fn in sass.split("Function : ")[1:]}


def wgmma_in_sass(sass):
    """Raise unless each of P3's DEFAULT and HIGH kernels (``dot_kernel<0,
    *>``, ``<1, *>``, the vector and the scalar path) holds HGMMA in
    ``sass`` (sass_functions), the instruction wgmma compiles to, so that a
    kernel that did not compile to it is not reported as one.  Returns the
    HGMMA counts by precision, a count a kernel."""
    counts = {"DEFAULT": [], "HIGH": []}
    for head, fn in sass.items():
        for mode, name in enumerate(counts):
            if f"dot_kernelILi{mode}E" in head:
                counts[name].append(fn.count("HGMMA"))
    if any(len(c) != 2 or not all(c) for c in counts.values()):
        raise AssertionError(f"P3's wgmma kernels hold no HGMMA in their SASS: {counts}")
    return counts


def gemm_tiles_in_sass(sass):
    """Raise unless, in ``sass`` (sass_functions), every instantiation of
    the wgmma GEMM tile's standalone kernel (``gemm_wg_kernel<BN, 1 | 3 |
    6>``, five widths each) and the three tables that run it
    (``body_mega_kernel<1, 1>``, ``<0, 3>`` and ``<0, 6>``) hold HGMMA
    (wgmma), and no kernel of the library holds HMMA (mma.sync).  Returns
    {kernel: (HGMMA, HMMA, UBLKCP)} counts, UBLKCP the bulk copy."""
    counts = {}
    for head, fn in sass.items():
        m = re.search(r"gemm_wg_kernelILi(\d+)ELi(\d)E|body_mega_kernelILi(\d)ELi(\d)E", head)
        if m:
            name = (f"gemm_wg_kernel<{m.group(1)}, {m.group(2)}>" if m.group(1) else
                    f"body_mega_kernel<{m.group(3)}, {m.group(4)}>")
            counts[name] = (fn.count("HGMMA"), fn.count("HMMA"), fn.count("UBLKCP"))
    tables = {"body_mega_kernel<1, 1>", "body_mega_kernel<0, 3>", "body_mega_kernel<0, 6>"}
    wg = [k for k in counts if k.startswith("gemm_wg") or k in tables]
    hmma = [head for head, fn in sass.items() if "HMMA" in fn]
    if len(wg) != 18 or not tables <= set(wg) or any(counts[k][0] == 0 for k in wg) or hmma:
        raise AssertionError(f"the GEMM tiles' SASS: {counts}; HMMA in {hmma}")
    return counts


def loads_first_in_sass(sass):
    """Raise unless the copies' vector kernels (P6 and P7's
    ``strided_copy_kernel<S>``, S = 2 and 1, and P5's ``concat_kernel`` on
    the same body) issue every LDG before their first STG in ``sass``, so
    that all of a thread's loads are in flight together.  Returns the LDG
    count by probe."""
    counts = {}
    for head, fn in sass.items():
        m = re.search(r"strided_copy_kernelILi(\d)E|\d(concat_kernel)E", head)
        if m:
            probe = {"1": "P7", "2": "P6"}.get(m.group(1), "P5")
            lines = fn.splitlines()
            ldg = [i for i, line in enumerate(lines) if "LDG" in line]
            stg = [i for i, line in enumerate(lines) if "STG" in line]
            if not ldg or not stg or max(ldg) > min(stg):
                raise AssertionError(f"{probe}'s vector kernel issues a load after its first "
                                     f"store (LDG lines {ldg}, STG lines {stg})")
            counts[probe] = len(ldg)
    if sorted(counts) != ["P5", "P6", "P7"]:
        raise AssertionError(f"the SASS holds the copies' vector kernels of {sorted(counts)} "
                             f"only")
    return counts


def launch_floors():
    """Device us a launch, (warm, cold), of the two floors, one CTA of one
    warp each: ``bs_probe_empty`` (a kernel that does nothing) and
    ``bs_probe_touch`` (each lane loads 16 bytes and stores them to another
    buffer; the copy is checked)."""
    import torch
    from backscrub_tpu_torch import _build
    src = torch.rand(128, device="cuda")
    dst = torch.zeros_like(src)
    fns = {"empty": lambda: _build.launch("bs_probe_empty"),
           "touch": lambda: _build.launch("bs_probe_touch", src.data_ptr(), dst.data_ptr())}
    floors = {k: (device_ms(fn, kernel=f"::{k}_kernel") * 1e3,
                  device_ms(fn, cold=f"::{k}_kernel") * 1e3) for k, fn in fns.items()}
    torch.cuda.synchronize()
    if not torch.equal(dst, src):
        raise AssertionError("bs_probe_touch did not copy its 512 bytes")
    return floors


def probe_phase():
    """P1-P7, the probe kernels of tools/probe_mosaic.py (csrc/probes.cu),
    on the original's inputs through tools/probe_hopper.py: the probe path
    once with the counts from 0 (each kernel against the original's numpy
    reference at its atol), then each kernel against its plain twin (P1, P2
    and P5-P7 bit-identical, P3 and P4 within PROBE_TOL), two runs
    bit-identical, the library call against the reference too; CUDA-event
    and device times.  Returns {probe name: numbers} and the path's
    launches by kernel id."""
    import torch
    import probe_hopper
    from backscrub_tpu_torch import _build
    from backscrub_tpu_torch.ops import probe_kernels as pk
    from backscrub_tpu_torch.pipeline.maskgen import set_precision_policy

    if any(k.launches for k in pk.KERNELS):
        raise AssertionError("a probe kernel ran on the pipelines' paths")
    set_precision_policy()
    ps = probe_hopper.probes("cuda")
    res = {}
    with torch.no_grad():
        for k in pk.KERNELS:
            k.launches = 0
        checked = probe_hopper.run(ps)
        torch.cuda.synchronize()
        launches = {p.kernel_id: p.counter.launches for p in ps}
        if launches != dict(P1=1, P2=1, P3=3, P4=1, P5=1, P6=1, P7=1):
            raise AssertionError(f"the probe path launched {launches}")
        for p, ok, err in checked:
            if not ok:
                raise AssertionError(f"{p.kernel_id} {p.name}: {err:.3g} from the "
                                     f"original's reference (atol {p.atol:g})")
            k, k2, pl = p.kernel(), p.kernel(), p.plain()
            lib = p.library() if p.library else None
            torch.cuda.synchronize()
            diff = float((k - pl).abs().max())
            if (not torch.equal(k, pl)) if p.exact else diff > PROBE_TOL:
                raise AssertionError(f"{p.kernel_id} {p.name}: {diff:.3g} from its plain twin")
            if not torch.equal(k, k2):
                raise AssertionError(f"{p.kernel_id} {p.name}: two runs differ")
            if lib is not None and not np.allclose(lib.float().cpu().numpy(), p.ref,
                                                   atol=p.atol, rtol=1e-4):
                raise AssertionError(f"{p.kernel_id} {p.name}: the library call is off")
            r = res[p.name] = dict(
                kernel_id=p.kernel_id, site=p.site, max_abs_err=diff, ms=timed(p.kernel),
                plain_ms=timed(p.plain),
                device_ms=device_ms(p.kernel, kernel=PROBE_KERNELS[p.kernel_id]),
                device_ms_cold=device_ms(p.kernel, cold=PROBE_KERNELS[p.kernel_id]),
                bound=bound(p.nbytes, p.ops, p.bf16_ops))
            if lib is not None:
                r.update(library_ms=timed(p.library),
                         library_device_ms=device_ms(p.library))
            print(f"probe {p.kernel_id} {p.name}: vs plain {diff:.3g}"
                  f"{' (bit-identical)' if p.exact else ''}, vs the original's reference "
                  f"{err:.3g} (atol {p.atol:g}); device {r['device_ms'] * 1e3:.3f} us "
                  f"(warm)"
                  f", {r['device_ms_cold'] * 1e3:.3f} us (cold), library "
                  + (f"{r['library_device_ms'] * 1e3:.3f} us" if lib is not None else "none")
                  + f", bound {r['bound'][0] * 1e3:.3f} us ({r['bound'][1]}); kernel "
                  f"{r['ms'][0]:.4f} ms plain {r['plain_ms'][0]:.4f} ms (event pairs)")
    for what, cases, kernels in (
            ("P1/P2 stencil", probe_hopper.stencil_cases("cuda"), probe_hopper.STENCIL_KERNELS),
            ("P6/P7 copy", probe_hopper.copy_cases("cuda"), probe_hopper.COPY_KERNELS),
            ("P5 concat", probe_hopper.cat_cases("cuda"), probe_hopper.CAT_KERNELS)):
        for name, kernel, plain, vec in cases:
            k, pl = kernel(), plain()
            torch.cuda.synchronize()
            if not torch.equal(k, pl):
                raise AssertionError(f"{what} {name}: {float((k - pl).abs().max()):.3g} from "
                                     f"its plain twin")
            names = probe_hopper.launched_kernels(kernel)
            if len(names) != 1 or kernels[vec] not in names[0]:
                raise AssertionError(f"{what} {name} ran {names}, not {kernels[vec]}")
        print(f"probe {what} bit-identical to its twins at {len(cases)} shapes, each on the "
              f"path its shape picks (profiler names {sorted(kernels.values())})")
    floors = launch_floors()
    print("launch floors, device us warm / cold: " + ", ".join(
        f"{k} {w:.3f} / {c:.3f}" for k, (w, c) in floors.items()))
    for kid in ("P1", "P2", "P5", "P6", "P7"):
        r = next(r for r in res.values() if r["kernel_id"] == kid)
        w, c = r["device_ms"] * 1e3, r["device_ms_cold"] * 1e3
        print(f"probe {kid} above the floors, device us warm / cold: " + ", ".join(
            f"{k} {w - fw:.3f} / {c - fc:.3f}" for k, (fw, fc) in floors.items()))
    sass = sass_functions()
    print(f"probe P5-P7's vector kernels issue every load before their first store in the "
          f"SASS (LDGs by probe: {loads_first_in_sass(sass)})")
    dots = {n[4:]: res[n]["device_ms"] * 1e3 for n in ("dot_default", "dot_high", "dot_highest")}
    print(f"probe P4 runs as one cluster of {_build.lib().bs_probe_se_cluster()} CTAs; P3's "
          f"DEFAULT and HIGH kernels hold HGMMA in their SASS: {wgmma_in_sass(sass)}")
    print(f"probe P3 (16x16 @ 16x3840) device us: DEFAULT {dots['default']:.3f}, HIGH "
          f"(bf16x3) {dots['high']:.3f}, HIGHEST (f32) {dots['highest']:.3f}; torch.matmul "
          f"f32 {res['dot_highest']['library_device_ms'] * 1e3:.3f}, bf16 operands "
          f"{res['dot_default']['library_device_ms'] * 1e3:.3f}")
    return res, launches


def coverage_check(device):
    """The op-coverage graph through the port's loader and executor on
    ``device``, held to its committed golden (the JAX executor's output on
    the CPU): f32 within COVERAGE_ATOL + COVERAGE_RTOL * |ref|, integers
    and bools exactly.  Prints a line before each check.  Returns (the
    model, the outputs on the host, the WHILE's trip count, the largest
    f32 error)."""
    import torch
    from backscrub_tpu_torch._build import resolve_device
    from backscrub_tpu_torch.graph.executor import load_model
    from backscrub_tpu_torch.ops.control_flow import while_op

    print(f"byo: loading {os.path.basename(COVERAGE)} with the port's loader on {device}")
    model = load_model(COVERAGE, device)
    gold = np.load(COVERAGE_GOLDEN)
    hist = {}
    for g in model.graph.subgraphs or [model.graph]:
        for k, v in g.op_histogram().items():
            hist[k] = hist.get(k, 0) + v
    print(f"byo: coverage graph, {len(model.graph.subgraphs or [1])} subgraphs, op histogram "
          + json.dumps(dict(sorted(hist.items()))))
    while_op.iterations = 0
    with torch.no_grad():
        ys = [y.cpu().numpy()
              for y in model(torch.from_numpy(gold["x"]).to(resolve_device(device)))]
    trips = while_op.iterations
    print(f"byo: checking the WHILE trip count: {trips} (golden {int(gold['trips'])})")
    if trips != int(gold["trips"]):
        raise AssertionError(f"the WHILE ran {trips} times, the golden {int(gold['trips'])}")
    err = 0.0
    for i, y in enumerate(ys):
        ref = gold[f"jax_{i}"]
        print(f"byo: checking output {i} ({ref.dtype}, {ref.size} values) against the golden")
        if y.dtype != ref.dtype or y.shape != ref.shape:
            raise AssertionError(f"coverage output {i}: {y.dtype} {y.shape}, golden "
                                 f"{ref.dtype} {ref.shape}")
        if ref.dtype.kind == "f":
            d = np.abs(y.astype(np.float64) - ref)
            err = max(err, float(d.max()))
            if not (d <= COVERAGE_ATOL + COVERAGE_RTOL * np.abs(ref)).all():
                raise AssertionError(f"coverage output {i}: largest error {d.max():.3g}")
        elif not np.array_equal(y, ref):
            raise AssertionError(f"coverage output {i}: {int((y != ref).sum())} values differ")
    print(f"byo: coverage graph held to its golden, largest f32 error {err:.3g}")
    return model, ys, trips, err


def byo_cpu_twin(frames=2):
    """byo_phase's CPU twin, for a machine without a card: the coverage
    graph against its golden and the U-Net FramePipeline for ``frames``
    frames on the CPU (the kernels' plain versions).  Returns its numbers."""
    import torch
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_synth_segm import moving_frames
    _, _, trips, err = coverage_check("cpu")
    w, h = CLASSIC_SIZE
    print(f"byo: the U-Net through FramePipeline on the CPU, {frames} frames at {w}x{h}")
    pipe = FramePipeline(UNET, PipelineConfig(width=w, height=h), device="cpu")
    if pipe.maskgen.edge is None or pipe.maskgen.edge.plans:
        raise AssertionError("the U-Net did not take K1 and the executor")
    mask = None
    for f in moving_frames(w, h, frames):
        out, mask = pipe.step(torch.from_numpy(f))
        if out.shape != (h, 2 * w) or out.dtype != torch.uint8:
            raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    return dict(trips=trips, max_abs_err=err, frames=frames,
                person=float((mask < 128).float().mean()))


def byo_phase(smi):
    """A model of the user's own: the op-coverage graph on the card against
    its golden (``coverage_check``); the converted U-Net served through
    FramePipeline fused with YUYV and NV12 out (``family_fused`` with no
    body plan) and classic with YUYV (``family_classic``), then
    ``backscrub-torch -m <unet>`` byte-equal to direct steps; the coverage model's parameters (its subgraphs' weights
    included) exported on the card, reloaded and rerun bit-identical.
    Returns (numbers, launches by kernel over the U-Net runs)."""
    import tempfile
    import torch
    from backscrub_tpu_torch.io.streams import SyntheticSource
    from backscrub_tpu_torch.pipeline.frame import FramePipeline, PipelineConfig
    from backscrub_tpu_torch.tflite.export import export_params_to_tflite
    from backscrub_tpu_torch.graph.executor import load_model

    t_phase = time.perf_counter()
    model, ys, trips, err = coverage_check("cuda")
    res = {"coverage": dict(trips=trips, max_abs_err=err)}
    w, h = CLASSIC_SIZE
    launches = collections.Counter()
    for fmt, pk in (("yuyv", "K3"), ("nv12", "K4")):
        print(f"byo: the U-Net fused with {fmt} out at {w}x{h}: checking K1 and {pk} against "
              f"their plain versions, no body plan, every frame's launches, the frames "
              f"against the plain path")
        res[f"fused {fmt}"] = family_fused("byo unet", UNET, w, h, fmt=fmt,
                                           margin=_logit_margin, body_plan=False)
        launches.update(res[f"fused {fmt}"]["launches"])
    print(f"byo: the U-Net classic with yuyv out at {w}x{h}: checking K5 and K3 against their "
          f"plain versions, every frame's launches, the frames against the plain path")
    res["classic yuyv"] = family_classic("byo unet", UNET, _logit_margin, fmt="yuyv")
    launches.update(res["classic yuyv"]["launches"])
    n = BYO_CLI_FRAMES
    src = SyntheticSource(w, h)
    cli_frames = [src.read() for _ in range(n)]
    pipe = FramePipeline(UNET, PipelineConfig(width=w, height=h), device="cuda")
    golden = b"".join(pipe.step(f)[0].cpu().numpy().tobytes() for f in cli_frames)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "unet.yuv")
        print(f"byo: backscrub-torch -m {os.path.basename(UNET)} -c test: --frames {n}, "
              "checking its exit code, launches and bytes")
        _cli_run(["-c", "test:", "--cg", f"{w}x{h}", "-m", UNET, "--frames", str(n),
                  "-v", f"file:{out}"],
                 dict(front=n, body=0, pack=n, pack_420=0, bilateral=0, jpeg_decode=0), 0)
        with open(out, "rb") as fh:
            data = fh.read()
        if data != golden:
            raise AssertionError(f"byo cli: {len(data)} bytes written, not the {len(golden)} "
                                 f"bytes of {n} direct steps")
        print("byo: exporting the coverage model's parameters on the card, reloading, rerunning")
        tuned = {k: v * 1.25 if v.is_floating_point() else v for k, v in model.params.items()}
        path = os.path.join(tmp, "coverage_tuned.tflite")
        written = export_params_to_tflite(COVERAGE, model, tuned, path)
        subs = sorted({m["subgraph"] for m in model.weight_meta.values()})
        back = load_model(path, "cuda")
        with torch.no_grad():
            x = torch.from_numpy(np.load(COVERAGE_GOLDEN)["x"]).cuda()
            a = model.raw_fn(tuned, x)
            b = back(x)
        for i, (u, v) in enumerate(zip(a, b)):
            if not torch.equal(u, v):
                raise AssertionError(f"byo export: output {i} of the reloaded file differs")
        for k, v in tuned.items():
            if not torch.equal(back.params[k], v):
                raise AssertionError(f"byo export: parameter {k} did not round-trip")
    res["cli"] = dict(frames=n, bytes=len(golden))
    res["export"] = dict(tensors=written, subgraphs=subs)
    res["seconds"] = time.perf_counter() - t_phase
    f, c = res["fused yuyv"], res["classic yuyv"]
    print(f"byo: {smi}: the U-Net at {w}x{h}, fused {f['ms_per_frame']:.4f} ms/frame (device "
          f"busy {f['busy_ms_per_frame']:.4f}), classic {c['ms_per_frame']:.4f} ms/frame "
          f"(device busy {c['busy_ms_per_frame']:.4f}); launches {dict(launches)}; export of "
          f"{written} tensors in subgraphs {subs} reloaded bit-identical; the CLI's "
          f"{len(golden)} bytes equal to direct steps; {res['seconds']:.2f} s")
    return res, dict(launches)


TOOLS_TIMEOUT = 300        # each tool's subprocess, its start and the card's included


def tools_phase():
    """The per-op roofline and the A/B tools over the port, in two
    subprocesses started together (their times share the card, so the
    numbers here are a check that they run, not a measurement):
    ``tools/roofline_torch.py`` on segm_lite at 1280x720 (3 steps of
    warm-up, a profiled window of 5) and ``tools/ab_torch.py`` on deeplab
    at "highest" (20 steps, the parity dumps of a synthetic camera JPEG at
    1280x720).  Either one's non-zero exit fails the run; each last line
    must name the card and its power limit, the roofline's rows must add up
    to its busy time with K1, K2 and K3 once a step each, and the A/B run
    must report the six-term continuation and write both dumps at their
    shapes.  Returns the tools' numbers."""
    import tempfile
    import torch
    from backscrub_tpu_torch.io.streams import SyntheticJpegCamera
    name = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        jpg = os.path.join(tmp, "frame.jpg")
        with open(jpg, "wb") as fh:
            fh.write(SyntheticJpegCamera(1280, 720)())
        tools = os.path.join(REPO, "tools")
        cmds = {"roofline": [sys.executable, os.path.join(tools, "roofline_torch.py"),
                             "--steps", "5", "--warmup", "3", "--top", "12"],
                "ab": [sys.executable, os.path.join(tools, "ab_torch.py"), "--model", "deeplab",
                       "--precision", "highest", "--iters", "20", "--image", jpg,
                       "--out-dir", tmp, "--tag", "smoke"]}
        procs = {k: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, cwd=REPO) for k, c in cmds.items()}
        out = {}
        try:
            for k, proc in procs.items():
                so, se = proc.communicate(timeout=TOOLS_TIMEOUT)
                if k == "roofline":
                    print(se.strip()[-4000:])
                if proc.returncode != 0:
                    raise AssertionError(f"tools/{k}: exit {proc.returncode}\n{se[-3000:]}")
                out[k] = json.loads(so.strip().splitlines()[-1])
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        rl, ab = out["roofline"], out["ab"]
        for k, rec in out.items():
            if rec["device"]["name"] != name or not rec["device"]["power_limit"]:
                raise AssertionError(f"tools/{k}: device {rec['device']}")
        calls = {r["op"]: r["calls_per_step"] for r in rl["rows"]}
        if any(calls.get(k) != 1 for k in ("K1 front", "K2 body plan", "K3 blend + YUYV")) \
                or not 0 <= rl["idle_share"] <= 1:
            raise AssertionError(f"tools/roofline: rows {calls}, idle {rl['idle_share']}")
        mask, arg = (np.load(os.path.join(tmp, f"ab_torch_deeplab_smoke_{k}.npy"))
                     for k in ("mask", "arg"))
        if ab["dots"] != ["f32", "bf16x6"] or mask.shape != (720, 1280) \
                or arg.shape != (257, 257):
            raise AssertionError(f"tools/ab: dots {ab['dots']}, dumps {mask.shape} {arg.shape}")
    print(f"tools: roofline_torch segm_lite 1280x720 busy {rl['busy_us_per_step']:.2f} us a "
          f"step, idle share {rl['idle_share']:.4f}, {len(rl['rows'])} rows shown; ab_torch "
          f"deeplab highest {ab['ms_per_frame_median']:.4f} ms a frame (median), busy "
          f"{ab['busy_ms_per_frame']:.4f} ms, person fraction of the decode "
          f"{ab['decode_person_frac']:.3f} (both tools at once on the card)")
    return {"roofline": {k: rl[k] for k in ("busy_us_per_step", "window_us_per_step",
                                            "idle_share", "device")},
            "roofline_rows": [{k: r.get(k) for k in ("op", "us_per_step", "calls_per_step",
                                                     "bound_us", "share_of_roof")}
                              for r in rl["rows"]],
            "ab": {k: v for k, v in ab.items() if k != "dumps"}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from backscrub_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    nvcc = _build._Lib.build_seconds
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s ("
          + (f"nvcc {nvcc:.2f} s" if nvcc is not None else "cached library") + ")")

    kernels = {size: kernel_phase(*size) for size in SIZES}
    runs = {size: pipeline_phase(*size) for size in SIZES}
    t0 = time.perf_counter()
    dl_kernels, dl_launches, _ = deeplab_phase()
    print(f"deeplab phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    highest, highest_launches = highest_phase(dl_kernels["body_cont"]["device_ms"])
    print(f"highest phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    classic, calls = classic_pipeline(), []
    staged = staged_maskgen(calls)
    k5 = bilateral_phase(classic.maskgen, staged)
    classic_launches, _ = classic_phase(classic)
    staged_phase(staged, calls)
    device_check()
    print(f"bilateral, classic, staged and device phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    pack420_shapes()
    fused_420_launches, _ = fused_420_phase()
    print(f"K4 shapes and fused 4:2:0 phases: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    probes, probe_launches = probe_phase()
    print(f"probe phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    selfie = selfie_phase()
    print(f"selfie phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    segm_full = segm_full_phase()
    print(f"segm_full phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bodypix = bodypix_phase()
    print(f"bodypix phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cli_res = cli_phase()
    print(f"cli phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    jpeg_kernel, jpeg_launches, mjpg = mjpg_phase()
    print(f"mjpg phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    options = options_phase()
    print(f"options phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    precision, prec_kernels, prec_launches = precision_phase()
    print(f"precision phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    batched, multistream = multistream_phase()
    print(f"multistream phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    capi, capi_launches = capi_phase()
    print(f"capi phase: {time.perf_counter() - t0:.2f} s")
    train, train_launches = train_phase(smi.stdout.strip().splitlines()[0])
    print(f"train phase: {train['seconds']:.2f} s")
    mesh, mesh_launches = mesh_phase(smi.stdout.strip().splitlines()[0])
    print(f"mesh phase: {mesh['seconds']:.2f} s")
    byo, byo_launches = byo_phase(smi.stdout.strip().splitlines()[0])
    print(f"byo phase: {byo['seconds']:.2f} s")
    t0 = time.perf_counter()
    tools = tools_phase()
    print(f"tools phase: {time.perf_counter() - t0:.2f} s")
    main_size = SIZES[0]
    # launches: each kernel's count from the run of the path it serves
    launches = dict(runs[main_size][0], body_prefix=dl_launches["body_prefix"],
                    body_cont=dl_launches["body_cont"], gemm=dl_launches["gemm"],
                    pack_420=fused_420_launches["pack_420"],
                    bilateral=classic_launches["bilateral"], jpeg_decode=jpeg_launches,
                    body_cont_highest=highest_launches["body_cont"],
                    gemm_highest=highest_launches["gemm"], **prec_launches)
    results = dict(kernels[main_size], body_prefix=dl_kernels["body_prefix"],
                   body_cont=dl_kernels["body_cont"], gemm=dl_kernels["gemm"],
                   bilateral=k5["segm 96x160"], jpeg_decode=jpeg_kernel["640x480"],
                   body_cont_highest=highest, gemm_highest=dl_kernels["gemm_highest"],
                   **prec_kernels)
    meta = {
        "front": ("backscrub_tpu_torch/csrc/front.cu", "backscrub_tpu/pipeline/edge.py:424"),
        "body": ("backscrub_tpu_torch/csrc/body_mega.cu",
                 "backscrub_tpu/ops/megakernel.py:660 (BodyMega, full span)"),
        "pack": ("backscrub_tpu_torch/csrc/blend_pack.cu",
                 "backscrub_tpu/ops/pallas_kernels.py:156"),
        "body_prefix": ("backscrub_tpu_torch/csrc/body_mega.cu",
                        "backscrub_tpu/ops/megakernel.py:712 (BodyMega, prefix mode)"),
        "body_cont": ("backscrub_tpu_torch/csrc/body_mega.cu",
                      "backscrub_tpu/ops/megakernel.py:794 (BodyMega flat=True, "
                      "continuation chain)"),
        "gemm": ("backscrub_tpu_torch/csrc/gemm_wg.cuh",
                 "backscrub_tpu/ops/megakernel.py:501 (BodyMega flat=True, the bf16x3 "
                 "1x1-conv dots of the continuation chain)"),
        "pack_420": ("backscrub_tpu_torch/csrc/blend_pack.cu",
                     "backscrub_tpu/ops/pallas_kernels.py:242"),
        "bilateral": ("backscrub_tpu_torch/csrc/bilateral.cu",
                      "backscrub_tpu/ops/pallas_kernels.py:71"),
        "jpeg_decode": ("backscrub_tpu_torch/csrc/jpeg.cu",
                        "no pallas_call: backscrub_tpu/pipeline/jpeg.py:207 (decode_jpeg_bgr, "
                        "jnp that XLA fuses into the frame program)"),
        # the bf16 mode's instantiations: launches from the bf16 runs of
        # precision_phase (segm_lite's K2; deeplab's K2', K2'' and their GEMM
        # table ops), the GEMM's other numbers the one-term tile alone
        "body_bf16": ("backscrub_tpu_torch/csrc/body_mega.cu",
                      "backscrub_tpu/ops/megakernel.py:660 (BodyMega, full span, DEFAULT: "
                      "one-pass bf16 dots)"),
        "body_prefix_bf16": ("backscrub_tpu_torch/csrc/body_mega.cu",
                             "backscrub_tpu/ops/megakernel.py:712 (BodyMega, prefix mode, "
                             "DEFAULT)"),
        "body_cont_bf16": ("backscrub_tpu_torch/csrc/body_mega.cu",
                           "backscrub_tpu/ops/megakernel.py:794 (BodyMega flat=True, DEFAULT)"),
        "gemm_bf16": ("backscrub_tpu_torch/csrc/gemm_wg.cuh",
                      "backscrub_tpu/ops/megakernel.py:516 (BodyMega flat=True, the DEFAULT "
                      "dots of the continuation chain)"),
        # "highest" (highest_phase): the continuation's table with the
        # six-term GEMM tile; the GEMM's other numbers the tile alone
        "body_cont_highest": ("backscrub_tpu_torch/csrc/body_mega.cu",
                              "backscrub_tpu/ops/megakernel.py:794 (BodyMega flat=True, "
                              "HIGHEST)"),
        "gemm_highest": ("backscrub_tpu_torch/csrc/gemm_wg.cuh",
                         "backscrub_tpu/ops/megakernel.py:516 (BodyMega flat=True, the HIGHEST "
                         "dots of the continuation chain: the TPU's six bf16 passes)"),
    }
    # the C ABI's launches (capi_phase): K1 and K2 fused, K5 staged
    for name, count in capi_launches.items():
        if count:
            results[name]["capi_launches"] = count
    # the fine-tuning phase's launches: the teacher's K1 and K2, the tuned
    # model's K1, K2 and K3
    for name, count in train_launches.items():
        results[name]["train_launches"] = count
    # the mesh phase's launches: its frame path, server (K2' the BodyPix
    # bucket's) and cli_multi --data-axis 2, counted from zero in its child
    for name, count in mesh_launches.items():
        results[name]["mesh_launches"] = count
    # the byo phase's launches: the U-Net's fused (K1, K3, K4) and classic
    # (K5, K3) runs, which byo_phase counted frame by frame
    for name in ("front", "pack", "pack_420", "bilateral"):
        if not byo_launches.get(name):
            raise AssertionError(f"the byo phase launched no {name} kernel")
        results[name]["byo_launches"] = byo_launches[name]
    # the stream batches' numbers (multistream_phase) beside each kernel's
    for name, by_s in batched.items():
        if name in results:
            results[name]["batched"] = {f"S={S}": r for S, r in by_s.items()}
    # P1-P7: launches from the probe path (probe_phase checked that the
    # pipelines launched none: main_path_launches); each kernel's first
    # run, so P3 at DEFAULT, the original's first precision
    for name, r in probes.items():
        key = f"probe_{r['kernel_id']}"
        if key not in meta:
            launches[key] = probe_launches[r["kernel_id"]]
            results[key] = dict(r, main_path_launches=0)
            meta[key] = ("backscrub_tpu_torch/csrc/probes.cu", f"{r['site']} ({name})")
    # library_ms where one PyTorch call computes the same function (the
    # GEMM's torch.addmm, the probes' library twins); "device_ms" where
    # measured (the profiler's kernel time a call)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"][0],
         "plain_ms": results[name]["plain_ms"][0],
         "bound_ms": results[name]["bound"][0],
         "bound_by": results[name]["bound"][1],
         "library_ms": results[name]["library_ms"][0]
         if results[name].get("library_ms") is not None else None,
         **{k: results[name][k] for k in ("device_ms", "device_ms_cold", "b2b_ms",
                                         "library_device_ms", "plain_device_ms",
                                         "library_b2b_ms", "precision_gap",
                                         "main_path_launches", "mean_abs_err",
                                         "three_term_device_ms", "three_term_gap", "rows_held",
                                         "control_rows_off", "batched", "capi_launches",
                                         "train_launches", "mesh_launches", "byo_launches",
                                         "frame_us", "library_frame_us")
            if k in results[name]}}
        for name, (src, rep) in meta.items()]}
    print(f"chip_smoke phases: {time.perf_counter() - t_start:.2f} s (the whole script)")
    for tag, res in (("selfie", selfie), ("segm_full", segm_full), ("bodypix", bodypix),
                     ("cli", cli_res), ("options", options), ("precision", precision)):
        print(f"{tag}: " + json.dumps({k: {n: v for n, v in r.items() if n != "phase_us"}
                                       for k, r in res.items()}))
    print("mjpg: " + json.dumps(dict(mjpg, decode={k: {n: v for n, v in r.items()}
                                                   for k, r in jpeg_kernel.items()})))
    print("multistream: " + json.dumps(multistream))
    print("capi: " + json.dumps(capi))
    print("train: " + json.dumps(train))
    print("mesh: " + json.dumps(mesh))
    print("byo: " + json.dumps(byo))
    print("tools: " + json.dumps(tools))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.path.insert(0, REPO)
        sys.path.insert(0, os.path.join(REPO, "tools"))
        mesh_child(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
