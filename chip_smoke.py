#!/usr/bin/env python3
"""Drive the PyTorch port (dfm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure raises and no result is printed:
  1. device   card name and power limit (nvidia-smi), torch / CUDA
  2. build    nvcc for every kernel source, all at once
  3. kernels  K1 warp_prev (the sweep, its points computed in the
              kernel, at the KITTI meta and a flip + crop + scale meta, its
              points also held against plane_sweep_grids, 2e-3 px), K3
              attention_sample, K2 frustum_stereo_sample (fused: stereo +
              sem samples x K3's attention + concat, the two halves held
              apart, the sem half, ~1/288 of the stereo half's size, to
              one bf16 rounding of its own size) at the DfM-KITTI
              main-path shapes; K8a pack_vol, K8b
              unpack_vol, K4 conv_p2p (with and without the residual),
              K7a unpack_affine_res (stem exit and pred exit), K7b
              gn_affine_res_packed (with and without residual and relu),
              K5 conv_s2_p2d and K6 pack_parity8 at both volumes the main
              path gives them, the stereo trunk's 72 depth slices and the
              reduced mono trunk's 44: each kernel against its plain
              PyTorch version on the same inputs (stated tolerance), the
              zero border of every chain tensor a kernel writes, K4, K5
              and K6 run twice and compared bit for bit, kernel / plain /
              one-call library times (CUDA events, median of 20 after
              warmup), and the bound: the bytes the function needs (rows
              of a gathered table it touches, coordinates, volumes in
              and out) over 3.35 TB/s, against its operations over the
              peak for their type (f32 67 TFLOP/s; K4's and K5's bf16
              products on the tensor cores 989 TFLOP/s, dense); K4's
              achieved TFLOP/s and share of that peak, K3's time over
              `F.grid_sample`'s; for K1, K2, K3, K4, K5 (both depths) and
              K9a, K9b also the device time of the kernels of one call
              (torch.profiler), without the host time around them (K9a:
              also of its conv kernel alone, without the fold of its
              partials). Then
              the K9 block: K9a conv3d_zpack (with its GroupNorm finish
              kernel) and K9b conv3d_pallas, on no model path, at the DfM
              trunk width (72, 80, 320, 32) bf16, in float32 at a smaller
              shape, K9b 16 -> 8 (bf16, f32) and 42 -> 42 and K9a 8 -> 32
              and 16 -> 24 (bf16, the `wgmma` code), each against its
              plain version, K9a's partials, its finish against the
              plain apply step (bit for bit) and `conv3d_gn` with
              residual and relu, twice bit for bit, with times, bound and
              the `F.conv3d` time (K9a, K9b: the ratio to it, the share
              of the bf16 peak, the device code each case ran); then
              their own path: the entry points
              `convgn.conv3d_zpack`, `convgn.conv3d_gn` and
              `cuda.conv3d.conv3d` once each with the launch counts set to 0
              just before and read just after
  4. main     full DfMConfig, 1x2x320x1280, bf16, seeded random weights,
              the default form (banded stems, reduced-depth mono trunk,
              both trunks on the conv chain from the cost volume to the
              pred exit): `init_dfm_model` (3 requests) and
              `init_dfm_stream` (first frame + 2 stream steps), each run
              with the launch counts set to 0 just before and read just
              after, all ten main-path kernels launched on both (K9a,
              K9b on neither), the counts of each request checked;
              then the form with only the stereo
              stem and pred ConvNorm on the chain (`packed='stem'`) and
              the dense form (`use_band=False, packed=False`), 2 timed
              requests after a warm-up each, so that the three forms'
              ms/frame and peak memory come from one run; plus decode +
              NMS on full-shape head outputs with live scores
  5. parity   tiny config in float32 with TF32 off, dense form: the same
              weights on the CPU (plain versions) and on the card
              (K1-K3); and bf16 on the card, default form against the
              dense form and against the `packed='stem'` form from the
              same weights and inputs, at the tiny config and at full
              width, the form that ran checked by its launch counts
  6. eval     a synthetic KITTI tree in a temporary directory (4 frames
              of 375x1242 and 370x1224 PNGs written with the five row
              filters in turn, KITTI's own P2 of two drives, poses with
              0.8 m of forward motion, labels with Car, Pedestrian,
              Cyclist, Van and DontCare rows, velodyne points; frame 2
              without a prev image): `dfm_tpu_torch.tools.create_data`
              and then the CLI `dfm_tpu_torch.tools.test` on
              configs/dfm_r34_kitti_3class.py with a seeded checkpoint
              (mmcv layout, with teacher and BatchNorm-counter keys), in
              processes of their own, to 36 finite AP lines; in process
              `dataset_inference` on the default form from that
              checkpoint, with the launch counts set to 0 just before and
              read just after (each main-path kernel at its per-request
              count per frame, K9a / K9b none), the checkpoint round trip
              (the loaded model's detections equal the saved model's bit
              for bit, cuDNN deterministic), the GT echo (Car 3d easy AP
              above 99), the tiny config's annos on the card against
              the CPU's plain versions (f32, TF32 off, a 192x384 crop,
              the same seeded live weights on both, names equal, scores
              within 1e-3, boxes 2e-3, 2D boxes 0.1 px), and the
              ms per frame split into PNG decode, pipeline, model
              (synchronised) and annos, kitti_eval's ms and the peak
              memory
  7. train    (a) the tiny config in float32, TF32 off, seeded live
              weights, one training sample of the synthetic tree (flip,
              scale, photometric distortion) and the same depth-loss
              pixels on both: forward + backward on the card (K1, K2
              forward and backward, K3 forward: launches checked) against
              the CPU's plain versions, every loss term (rtol 1e-3) and
              every parameter's gradient and the whole gradient by
              relative L2 within 3x their own movement on the CPU under
              one ulp of seeded weight noise (at least 1e-3), no
              parameter with a CPU gradient left without one on the
              card; (b) the backward kernels K1-bwd
              (`warp_prev_sweep_bwd`) and K2-bwd
              (`frustum_voxel_features_bwd`) at the full-width training
              shapes in float32 against `torch.autograd.grad` of the plain
              forwards, with times, bound and `F.grid_sample`'s backward
              on the same taps, two calls of each bit for bit (the
              gathers have no atomics); device times by `span_ms`: K1-bwd
              at a quarter, half and all of the depths, K2-bwd whole and
              each half's tiles alone (the other map given no rows); (c) the
              train CLI `dfm_tpu_torch.tools.train` on configs/dfm_r34_kitti_3class.py
              with `model.type=DfM` at full width on the tree (train and
              val infos from `create_data`) in processes of their own: 4
              steps (finite loss terms and grad_norm logged, a checkpoint
              and the KITTI eval at the end of the epoch), a resume to
              step 6 from the saved optimizer state (its sha1 checked),
              `tools.test` on the step-6 checkpoint, and a type it does
              not train (EncoderDecoder3D) refused; (d) full-width training
              steps in process:
              two warm-up steps, then three with the launch counts set
              to 0 just before and read just after (a step: K1, K2 one
              forward and one backward each, K3 one forward, no other
              kernel), each split into data, forward, backward and
              optimizer (synchronised), and the peak memory; (e) 30 steps at lr 1e-3 on one frame at the
              tiny config (no augmentation): the mean loss of the last 5
              below that of the first 5
  8. full     DfMFull training (the flagship config's type: FPN + ATSS 2D
              head, the frozen dense LiDAR teacher, the imitation), on
              phase 7's tree: (a) the tiny config in float32, TF32 off,
              seeded live weights, a training sample with 4,096 teacher
              points and 2D targets from its gt boxes, the same depth
              pixels: every loss term on the card against the CPU (rtol
              1e-3), the gradients by phase 7 (a)'s rule, launches
              checked, and after the update the teacher's parameters
              unchanged bit for bit and its running variances moved;
              (b) the full DfMConfig, f32, phase 7's full-width
              training samples + 16,384 teacher points uniform in the
              point-cloud range + 2D targets (projected corners'
              extent, projected 3D centre): 2 warm-up steps, then 3 with
              the launch counts set to 0 just before and read just after
              (K1, K2, K3, K1-bwd, K2-bwd once a step), every term
              finite, the split into data / forward / backward /
              optimizer beside phase 7 (d)'s, the peak memory, the ATSS
              positives and the imitation cells of the last batch (> 0);
              (c) the train CLI on configs/dfm_r34_kitti_3class.py with
              `--synthetic` and a teacher file written here in flax's
              msgpack format: 2 steps (the teacher restored, the four
              new terms finite), a resume to 3 (the optimizer's sha1),
              the teacher's parameters in the checkpoint equal to the
              file's, and `tools.test` on that checkpoint to 36 AP lines
  9. mvdfm    MultiViewDfM (MV-FCOS3D++, configs/multiview_dfm_r101_
              waymo_camsync.py), no port kernel on its path: (a) a tiny
              config (ResNet-50, 3 views, 2 frames, 32x48, a 4x16x16
              grid) in float32, TF32 off, seeded live weights, on the
              card and on the CPU: trunk + FPN level 0, the sampled
              volume, the BEV map and the head outputs within relative L2
              1e-4, the detections' labels equal and scores / boxes
              within 1e-3, no port-kernel launch; (b) a synthetic Waymo
              kitti_format tree (2 frames, 5 PNG views at Waymo's camera
              sizes, infos with lidar2img, annos, cam_sync_annos, context
              and timestamps; PNG decode ms per view), then the full
              camsync config on its first frame (1 x 5 x 640x960) in bf16
              and f32: ms per request (host clock ending in a
              synchronise, median of 3 after 2 warm-ups), ms per stage
              (trunk + FPN, view sample, neck, head, predict), their
              GFLOP and TFLOP/s, peak memory, 0 port-kernel launches,
              finite detections; (c) `dfm_tpu_torch.tools.test` on the
              camsync config in processes of their own: the full config
              on the card with a seeded live checkpoint over the tree, to
              15 finite LET lines from `python_fallback`, and a tiny
              config on a tree at 1/20 of the sizes on the card and on
              the CPU (f32, TF32 off), their detections equal within 1e-3
 10. ddp      data parallelism (`dfm_tpu_torch/parallel/`) and
              MultiViewDfM training: (a) a process group of one on NCCL in
              this process: the full-width f32 DfM step (TF32 off) with
              the group against the same step without one (loss terms
              rtol 1e-5, gradients and BatchNorm statistics by phase 7
              (a)'s rule, each one's movement the larger of its
              movements under one ulp of weight noise (two seeds); the
              bit-equal gradients of a repeat of the step reported),
              K1, K2, K3, K1-bwd and K2-bwd launched once; (b) two ranks
              on the one card under gloo (torchrun, this script with
              `--ddp-rank`), B = 1 each at full width, against this
              process at B = 2 (as (a): the loss rtol 1e-5, gradients
              and BatchNorm statistics by phase 7 (a)'s rule; the two
              ranks bit-equal), then 3 timed steps a rank
              after 2 warm-ups: ms split into data (the whole global
              batch decoded, as the CLI's ranks do), forward, backward,
              all-reduce and optimizer, the all-reduce's bytes, the peak
              memory per process, launches; (c) the CLIs under torchrun
              beside (a): `tools.train` (one rank, NCCL) 2 steps at full
              width on a KITTI tree as phase 7's and `--auto-resume` to
              3 (the optimizer's sha1), `tools.test` under 2 gloo ranks
              on that tree (phase 6's checkpoint) and on phase 9's small
              Waymo tree (the tiny config, a live checkpoint): the 36 AP
              and 15 LET lines equal to one process's; (d) MultiViewDfM
              training: a tiny config (ResNet-18, 2 views of 64x96,
              128x192 and 256x384), the card's f32 gradients (cuDNN, TF32
              off) and the CPU's against the CPU's float64 step (oneDNN
              off), the card's error within 3x the CPU's own at every
              size (each parameter and the whole gradient, at least
              1e-3), at 128x192 also card against CPU by phase 7 (a)'s
              rule, 0 port-kernel launches; `tools.train` on the camsync
              config
              with `--synthetic` for 2 steps and `tools.test` on its
              checkpoint (15 finite LET lines); the full camsync config
              in f32 on phase 9's first frame, B = 1: 3 steps after 2
              warm-ups split into data, forward, backward and optimizer,
              the peak memory, 0 port-kernel launches
 11. temporal the 10-sweeps MultiViewDfM config (configs/multiview_dfm_
              r101_waymo_camsync_10sweeps.py: two frames concatenated,
              `DfMNeck`), the CenterHead and the depth head, no port
              kernel on their paths: (a) tiny variants (ResNet-18, 2
              frames x 2 views of 64x96: the 10-sweeps model, its
              CenterHead variant, the 3D backbone + voxel_sample depth
              head variant) in f32, TF32 off, seeded live weights, card
              against CPU: every output within relative L2 1e-4, the
              detections' labels equal and scores / boxes within 1e-3, no
              port-kernel launch; (b) the full 10-sweeps config on frame 1
              of phase 9's tree (1 x 2 frames x 5 views x 640x960, the
              sweep's lidar2img rewritten by ego-motion) in bf16 and f32:
              ms per request (median of 3 after 2 warm-ups), ms per stage
              (trunk + FPN, view sample, DfMNeck, head, predict), their
              GFLOP and TFLOP/s, peak memory, 0 port-kernel launches;
              (c) `tools.test` with the 10-sweeps config in processes of
              their own: the full config on the card over phase 9's tree
              (2 frames a sample) to 15 finite LET lines, and a tiny
              config on the small tree under 2 gloo ranks (torchrun) with
              the LET lines of one process; (d) one full-width f32
              training step of the 10-sweeps model at B = 1 after a
              warm-up, split into data, forward, backward and optimizer,
              its peak memory, 0 port-kernel launches
 12. mono     the FCOS3D / PGD monocular family on KITTI (configs/
              fcos3d_r101_kitti_mono.py, pgd_r101_kitti_mono.py), no port
              kernel on its path: (a) tiny FCOS3D and PGD (ResNet-18,
              width 64, 2 x 128x192) in f32, TF32 off, seeded live
              weights, card against CPU: every level output within
              relative L2 1e-4, the detections' labels equal and scores /
              boxes within 1e-3, one training step's loss terms within
              rtol 1e-3 and gradients by phase 7 (a)'s rule (its movers
              also the CPU's step on the batch in reverse order, as in
              (d)), no port-kernel launch; (d) two gloo ranks of the tiny PGD
              (torchrun, this script with `--mono-rank`), B = 1 each,
              against this process at B = 2 by phase 10 (b)'s rule (its
              movers also the step on the batch in reverse order:
              BatchNorm's E[x^2] - E[x]^2 rounds by summation order); (c)
              on a KITTI tree (phase 7's writer, `create_data`), in
              processes of their own beside (a) and (d): `tools.test` on
              both configs at full width with seeded live checkpoints to
              36 finite AP lines, in bf16, and in f32 (TF32 off) with
              NMS keeping every box (`model.nms_thr=1.0`: no IoU decision
              to flip under rounding) unfused and with `--fuse-conv-bn`
              (every BatchNorm, 104, folded; its
              detections within 1e-4 x (1 + |value|) of the unfused
              run's, each matched to its nearest of its class, the 2D
              boxes within 1e-4 of the image width, the AP lines printed
              beside), `--synthetic` on every
              ported config, `tools.train` on the PGD config for 2 steps,
              `--auto-resume` to 3 (the optimizer's sha1) and
              `tools.test` on that checkpoint; (b) after them, the full
              configs at 1 x 384x1280 (frame 0 of the tree) in bf16 and
              f32, each unfused and with the BatchNorm fold: ms per
              request (median of 3 after 2 warm-ups), ms per stage
              (trunk + FPN, head, predict) with their GFLOP and TFLOP/s,
              peak memory, 0 port-kernel launches; the fold's outputs
              against the unfused ones (f32, TF32 off: relative L2 1e-4;
              bf16: within 2x bf16's own distance from the unfused f32
              model); one f32 PGD training step at B = 2 on the tree's
              images after a warm-up, split into data, forward, backward
              and optimizer, with its peak memory
 13. dla      SMOKE and MonoFlex (DLA-34, the DLA neck's 16 DCNv2 layers),
              no port kernel on their path, every deformable layer with
              live offsets (`live_dcn`: +-3 px and more): (a) card vs CPU
              in f32 with TF32 off: the DCN op's output and its four
              gradients (stride 1 and 2, dilation 2, DCNv1; relative L2
              1e-5), the DCN ResNet-18 (1e-4), the models at 2 x 64x96
              (MonoFlex with edge fusion): dense outputs 1e-4, the decode
              of the same outputs, one step's terms (rtol 1e-3) and
              gradients by phase 7 (a)'s rule (movers: three ulp noises
              and the batch reversed); (c) in processes of their own beside
              (a): SMOKE `tools.test` on a KITTI tree (`data.type=
              KittiMono`) with a live checkpoint to 36 AP lines in bf16
              and in f32 (TF32 off) unfused and with `--fuse-conv-bn` (55
              BatchNorms; detections matched as phase 12's), `--synthetic`
              on both configs, the shipped configs refused without KITTI
              mono data or `--synthetic` (rc 2), `tools.train` SMOKE 2
              steps and a resume to 3, MonoFlex `--synthetic` 2 steps
              (`tools.test` on a trained checkpoint: the CPU tests); (b)
              after them: one
              DeformConv2d(64, 64) at 96x320 against `F.conv2d` of the
              same shape with both bounds, then the full configs at 1 x
              384x1280 in bf16 and f32, unfused and folded: ms per
              request (median of 3 after 2 warm-ups), per stage (trunk,
              neck with its 16 DCN layers' CUDA-event time, head,
              predict) with GFLOP and TFLOP/s, peak memory, 0 port-kernel
              launches; one f32 training step of each at its per-chip
              batch (SMOKE 8 on the tree's images, MonoFlex 4 synthetic)
              split into data, forward, backward and optimizer, with its
              peak memory
 14. imvoxel  ImVoxelNet on KITTI (configs/imvoxelnet_kitti_car.py), no
              port kernel on its path: (a) a tiny model (ResNet-18, grid
              (4, 16, 16), 2 x 64x96) in f32, TF32 off, seeded live
              weights, card against CPU: every output within relative L2
              1e-4, the decode's labels equal and scores / boxes within
              1e-3, one step's loss terms within rtol 1e-3 and gradients
              by phase 7 (a)'s rule (movers: two ulp noises and the batch
              reversed); (c) in processes of their own beside (a):
              `tools.test` and `tools.train` with `--synthetic` at the
              full config, both refused without it (rc 2); (b) the full
              config at 1 x 384x1280 in bf16 and f32, unfused and folded:
              ms per request (median of 3 after 2 warm-ups), per stage
              (trunk + FPN, voxel sample, neck_3d, head, predict), peak
              memory, 0 port-kernel launches; one f32 training step at
              the config's B = 4, split and peak
 15. nuscenes nuScenes-mono (configs/fcos3d_r101_nus_mono.py,
              pgd_r101_nus_mono_1x.py): (a) the committed JPEG fixtures
              (tests/data/jpeg/) decoded by the port equal to their PNGs
              and cv2 digests, the host ms of the 1600x900 decode; (b)
              both configs at the raw 900x1600 in bf16 and f32: ms per
              request and per stage (trunk + FPN, head, predict), peak,
              0 launches; (c) beside them, `tools.test` of each with a
              live checkpoint on a nuScenes tree of the fixture JPEGs:
              17 finite metric lines (the APs, TP errors, mAP, NDS)
 16. waymo_cam PGD-Waymo's camera modes and the mono demo: (a) a tiny PGD
              on the five 'cam_frame' samples of a frame, f32, TF32 off,
              card against CPU (decode within 1e-3) and the five
              cameras' merges equal; (b) the full pgd_r101_waymo_mv3d
              config on one camera at its 1280x1920 in bf16 and f32: ms
              per request and stage, peak, 0 launches, the merge's host
              ms; (c) `tools.test` refusing both PGD-Waymo configs on a
              Waymo tree (rc 2, the reason named) and decoding them with
              `--synthetic`; (d) the demo (FCOS3D R101, bf16, a live
              checkpoint) on the 1600x900 fixture JPEG: detections
              printed, its PNG read back
17-20. lidar  the Waymo converter, the generic FrustumToVoxel, the SECOND
              family, DfMWithTeacher(sparse) (`lidar_phases`; no two
              trainings at B = 6 on the card at once)
 21. lidar2   CenterPoint, SA-SSD, Part-A2 and PointRCNN at their configs,
              no port kernel on their paths (`lidar2_phase`): (d)'s CLIs
              started first (`tools.test --synthetic` on the four,
              `tools.train` PartA2 / PointRCNN `--synthetic` and SA-SSD
              (B = 2) on a KITTI velodyne tree beside (a) and (b),
              CenterPoint on it beside (c)), the refusals in process; (a) tiny configs
              card vs CPU in f32, TF32 off: index outputs equal (voxel keys, proposal labels and masks;
              FPS, ball groups and 3-NN on blob-heavy clouds), features
              within 1e-5; (b) requests at full width in bf16 and f32,
              median of 3 after 2 warm-ups, by stage, peak memory, 0
              port-kernel launches, FPS's share of a PointRCNN request;
              (c) one f32 training step of each at its per-chip batch,
              split and peak
 22. indoor   3DSSD, MVX and VoteNet (ScanNet, SUN RGB-D), no port
              kernel on their paths (`indoor_phase`): (d) synthetic
              ScanNet / SUN RGB-D trees through `create_data`, the CLIs
              (VoteNet `tools.test` to indoor AP on both, `tools.train`
              and a resume on ScanNet, 3DSSD / MVX `--synthetic`) beside
              (a) and (b); (a) tiny configs card vs CPU, f32, TF32 off:
              every sampled index equal, outputs within 1e-5; (b)
              full-width requests in bf16 and f32 by stage (median of 2
              after a warm-up), peak, 0 launches, FPS's share; (c) one f32 step of each at its
              per-chip batch, split and peak
 23. indoor2  GroupFree3D, ImVoteNet and H3DNet at their configs, no port
              kernel on their paths (`indoor2_phase`): (d) a ScanNet tree
              of 50,000-point scenes and a SUN RGB-D tree through
              `create_data`, the CLIs started first (`tools.test` of
              GroupFree3D / H3DNet to indoor AP, `tools.train` of each,
              B = 2; ImVoteNet `--synthetic` test and train, and refusing
              SUN RGB-D data, rc 2; EncoderDecoder3D refused) beside (a)
              and (b); (a) the tests' tiny configs card vs CPU in f32,
              TF32 off (ImVoteNet without and with the image branch,
              H3DNet without and with the cues): seeds, KPS candidates,
              proposal FPS and groups, decoded 2D classes in slot order,
              fusion masks and primitive groups equal, outputs within
              1e-4; (b) requests at full width (GroupFree3D 50,000
              points, H3DNet 40,000 with 4 towers, ImVoteNet 20,000 with a
              530x730 image and 16 2D box slots) in bf16 and f32, median
              of 2 after a warm-up, by stage, peak, 0 port-kernel
              launches, FPS's share; (c) one f32 step of each at its
              per-chip batch (GroupFree3D B = 4, ImVoteNet B = 8, H3DNet
              B = 8), split and peak
After each phase, the most memory in use on the card (every process).
Then the kernels JSON line, the card line, and the result line.
Exits non-zero without a result when there is no CUDA device or the
package is not beside the script.
"""

import gc
import json
import re
import struct
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM published peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12    # H100 SXM bf16 on the tensor cores, dense
REPS = 20
IMG_HW = (320, 1280)
MONO_DEPTH = 44               # slices of the reduced mono volume of 72 planes

# kernel launches of one request (one backbone pass) at full width, by form
SAMPLING = dict(warp_prev=1, frustum_stereo_sample=1, attention_sample=1)
NO_CHAIN = dict(pack_vol=0, conv_p2p=0, unpack_affine_res=0, conv_s2_p2d=0,
                pack_parity8=0, gn_affine_res_packed=0, unpack_vol=0)
# K9a (with its GroupNorm finish), K9b: on no model path (their path is
# their own entry points); the backward kernels of K1 and K2 run in
# training only (phase 7)
OFF_PATH = dict(conv3d_zpack=0, conv3d_gn_finish=0, conv3d_pallas=0,
                warp_prev_bwd=0, frustum_stereo_sample_bwd=0)
LAUNCHES_OF = {
    'dense': {**SAMPLING, **NO_CHAIN, **OFF_PATH},
    # K8a prev + pred, K4 dres0 + dres1 + pred, K7a stem + pred exit
    'stem': {**SAMPLING, **NO_CHAIN, **OFF_PATH, 'pack_vol': 2,
             'conv_p2p': 3, 'unpack_affine_res': 2},
    # stereo: K8a, K4 x3, K5, K6, K7b x2 (stem + hourglass exit), K7a, K8b;
    # mono: K8a, K5, K6, K7b (hourglass exit), K4, K7a, K8b
    'chain': {**SAMPLING, **OFF_PATH, 'pack_vol': 2, 'conv_p2p': 4,
              'unpack_affine_res': 2, 'conv_s2_p2d': 2, 'pack_parity8': 2,
              'gn_affine_res_packed': 3, 'unpack_vol': 2},
    # 12 depth planes have no reduced-depth plan: the mono trunk is dense
    'chain, stereo trunk only': {
        **SAMPLING, **OFF_PATH, 'pack_vol': 1, 'conv_p2p': 3,
        'unpack_affine_res': 1, 'conv_s2_p2d': 1, 'pack_parity8': 1,
        'gn_affine_res_packed': 2, 'unpack_vol': 1},
}
# one training step (float32, the banded form): K1 and K2 forward and
# backward, K3 forward, nothing of the conv chain or of K9
LAUNCHES_OF['train'] = {**LAUNCHES_OF['dense'], 'warp_prev_bwd': 1,
                        'frustum_stereo_sample_bwd': 1}
# the ten kernels of the main path
MAIN_PATH = [k for k, n in LAUNCHES_OF['chain'].items() if n]
TRAIN_PATH = [k for k, n in LAUNCHES_OF['train'].items() if n]
BWD_KERNELS = ('warp_prev_bwd', 'frustum_stereo_sample_bwd')
# K9's path: conv3d_zpack and conv3d_gn (K9a, + the finish), conv3d
# (K9b), once each
K9_PATH = {**dict.fromkeys(LAUNCHES_OF['chain'], 0), 'conv3d_zpack': 2,
           'conv3d_gn_finish': 1, 'conv3d_pallas': 1}
FORM_ARGS = {'chain': {}, 'stem': dict(packed='stem'),
             'dense': dict(use_band=False, packed=False)}


def check_launches(got, form, requests, what):
    want = {k: n * requests for k, n in LAUNCHES_OF[form].items()}
    check(dict(got) == want, f'{what}: launched {dict(got)}, the {form} '
          f'form launches {want} in {requests} request(s)')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


def cuda_ms(fn, reps=REPS, warmup=3):
    """Median milliseconds of `fn` over `reps` launches, CUDA events."""
    for _ in range(warmup):
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
    return float(np.median(times))


def device_ms(fn, reps=5, kernel=None):
    """Device time of the kernels one call of `fn` launches (their sum,
    torch.profiler; of those whose name holds `kernel`, if given),
    without the host time around them that `cuda_ms` also sees. Every
    kernel must show a multiple of `reps` events: a profile that lost
    some is taken again once, then the phase fails."""
    import collections
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, kept = 0.0, collections.Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (kernel is None
                                                      or kernel in e.name):
                us += e.time_range.elapsed_us()
                kept[e.name] += 1
        if all(n % reps == 0 for n in kept.values()):
            return us / 1e3 / reps
    check(False, f'device_ms: the profiler kept {dict(kept)} events of '
          f'{reps} calls')


def span_ms(fn, reps=5):
    """Device milliseconds of one call of `fn`: CUDA events around `reps`
    calls queued behind a sleeping kernel, so that the card runs them back
    to back with no host time between them (the kernels' own time and
    their launch gaps of a few microseconds). Fails if the card reached
    the calls before the host had queued them all."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)    # about 0.1 s of the card's clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not start.query(), 'span_ms: the card ran out of queued work '
          'before the calls were queued')
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f'nvidia-smi failed: {res.stderr}')
    return res.stdout.strip().splitlines()[0]


class CardMemory:
    """The card's memory in use by every process on it (nvidia-smi's
    memory.used, read every 50 ms by a process of its own), at its highest
    since the last `mark`: the phases that run processes beside this one
    share the card's memory with them."""

    def __init__(self):
        import threading
        self.peak = self.total = 0
        self.lock = threading.Lock()
        self.proc = subprocess.Popen(
            ['nvidia-smi', '--query-gpu=memory.used,memory.total',
             '--format=csv,noheader,nounits', '-lms', '50'],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                used, total = (int(x) for x in line.split(',')[:2])
            except ValueError:
                continue
            with self.lock:
                self.peak, self.total = max(self.peak, used), total

    def mark(self, what):
        with self.lock:
            peak, self.peak = self.peak, 0
        print(f'card memory: {what} at most {peak} MiB of {self.total} MiB '
              'in use (every process on the card)', flush=True)

    def close(self):
        self.proc.kill()
        self.proc.wait()


def kitti_meta(batch, device):
    """KITTI-like intrinsics (f = 721.5 px) and 0.8 m forward
    ego-motion."""
    from dfm_tpu_torch.models.detectors.dfm import BatchMeta
    h, w = IMG_HW
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 721.5
    cam[0, 2], cam[1, 2] = w / 2, h / 2
    meta = BatchMeta.identity(batch, np.repeat(cam[None], batch, 0), device)
    c2p = torch.eye(4, device=device).repeat(batch, 1, 1)
    c2p[:, 2, 3] = 0.8
    meta.cur2prev = c2p
    return meta


# --- a synthetic KITTI raw tree (phase 6; the port's tests use it too)

# KITTI's P2 of two drives (a non-zero translation column), its R0_rect and
# Tr_velo_to_cam (frame 000000 of the object split)
KITTI_P2 = (
    ((7.215377e+02, 0, 6.095593e+02, 4.485728e+01),
     (0, 7.215377e+02, 1.728540e+02, 2.163791e-01),
     (0, 0, 1, 2.745884e-03)),
    ((7.070493e+02, 0, 6.040814e+02, 4.575831e+01),
     (0, 7.070493e+02, 1.805066e+02, -3.454157e-01),
     (0, 0, 1, 4.981016e-03)))
KITTI_R0 = (9.999239e-01, 9.837760e-03, -7.445048e-03, -9.869795e-03,
            9.999421e-01, -4.278459e-03, 7.402527e-03, 4.351614e-03,
            9.999631e-01)
KITTI_V2C = (7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03,
             1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02,
             9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01)
# (id, (H, W), P2, prev image): two widths, two intrinsics, one frame
# whose prev image is absent (the pipeline then pairs the frame with
# itself)
KITTI_FRAMES = ((0, (375, 1242), 0, True), (1, (370, 1224), 1, True),
                (2, (375, 1242), 0, False), (3, (370, 1224), 1, True))
# camera-frame objects: name, (h, w, l), bottom centre (x, y, z), ry;
# 11 cars a frame, so that four frames hold the 41 easy cars that the
# 40-point AP needs to reach 100 on a perfect echo (n ground truths give
# at most (n - 1) / 40 below that)
KITTI_OBJECTS = tuple(
    [('Car', (1.5, 1.6, 3.9), (x, 1.65, z), -1.57 + 0.05 * k)
     for k, (x, z) in enumerate(((-3, 9), (3, 9), (-7, 14), (-3.5, 14),
                                 (0, 14), (3.5, 14), (7, 14), (-8, 20),
                                 (-4, 20), (4, 20), (8, 20)))]
    + [('Pedestrian', (1.75, 0.6, 0.8), (0.0, 1.7, 9.0), -1.2),
       ('Pedestrian', (1.75, 0.6, 0.8), (0.0, 1.7, 20.0), 0.4),
       ('Cyclist', (1.7, 0.6, 1.8), (-1.5, 1.7, 24.0), 1.5),
       ('Cyclist', (1.7, 0.6, 1.8), (6.0, 1.7, 24.0), -1.5),
       ('Van', (2.1, 1.9, 4.8), (10.0, 1.7, 26.0), 0.3)])
FORWARD_M = 0.8               # ego-motion from the prev frame to the frame


def _box_corners(dims, loc, ry):
    """(8, 3) camera-frame corners of a KITTI box (bottom centre)."""
    h, w, l = dims
    x = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * l / 2
    y = np.array([0, 0, 0, 0, -1, -1, -1, -1]) * h
    z = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * w / 2
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([c * x + s * z + loc[0], y + loc[1],
                     -s * x + c * z + loc[2]], 1)


def write_kitti_tree(root, seed=0, frames=KITTI_FRAMES):
    """A KITTI object-split tree under `root`: training/{image_2,
    prev_2, calib, poses, label_2, velodyne} and ImageSets/{train,val}.txt
    (the same frames), the images random from `seed`; returns the frame
    ids."""
    import os
    from dfm_tpu_torch.data.png import png_bytes
    rng = np.random.default_rng(seed)
    base = os.path.join(root, 'training')
    for sub in ('image_2', 'prev_2', 'calib', 'poses', 'label_2',
                'velodyne'):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)
    fmt = lambda v: ' '.join(f'{x:.12e}' for x in np.ravel(v))  # noqa: E731
    for idx, (h, w), pi, with_prev in frames:
        sid = f'{idx:06d}'
        yy, xx = np.mgrid[0:h + 8, 0:w + 8]
        scene = (np.sin(xx / 23.0 + idx)[..., None] * 60
                 + np.cos(yy / 13.0)[..., None] * 40 + [90, 110, 130]
                 + rng.normal(0, 12, (h + 8, w + 8, 3)))
        scene = np.clip(scene, 0, 255).astype(np.uint8)
        with open(os.path.join(base, 'image_2', sid + '.png'), 'wb') as f:
            f.write(png_bytes(scene[4:4 + h, 4:4 + w]))
        if with_prev:
            with open(os.path.join(base, 'prev_2', sid + '_01.png'),
                      'wb') as f:
                f.write(png_bytes(scene[6:6 + h, 2:2 + w]))
        p2 = np.asarray(KITTI_P2[pi])
        with open(os.path.join(base, 'calib', sid + '.txt'), 'w') as f:
            for k in range(4):
                f.write(f'P{k}: {fmt(p2)}\n')
            f.write(f'R0_rect: {fmt(KITTI_R0)}\nTr_velo_to_cam: '
                    f'{fmt(KITTI_V2C)}\nTr_imu_to_velo: {fmt(np.eye(4)[:3])}\n')
        cur = np.eye(4)
        cur[:3, 3] = (0.3 * idx, 0.0, 5.0 * idx)
        prev = cur.copy()
        prev[2, 3] -= FORWARD_M
        np.savetxt(os.path.join(base, 'poses', sid + '.txt'),
                   np.stack([cur.ravel(), prev.ravel()]))
        lines = []
        for name, dims, loc, ry in KITTI_OBJECTS:
            corners = _box_corners(dims, loc, ry)
            uvw = np.concatenate([corners, np.ones((8, 1))], 1) @ p2.T
            uv = uvw[:, :2] / uvw[:, 2:]
            box = (max(uv[:, 0].min(), 0), max(uv[:, 1].min(), 0),
                   min(uv[:, 0].max(), w - 1), min(uv[:, 1].max(), h - 1))
            alpha = ry - np.arctan2(loc[0], loc[2])
            lines.append(f'{name} 0.00 0 {alpha:.2f} {fmt(box)} '
                         f'{fmt(dims)} {fmt(loc)} {ry:.2f}')
        lines.append('DontCare -1 -1 -10 500.0 160.0 560.0 200.0 -1 -1 -1 '
                     '-1000 -1000 -1000 -10')
        with open(os.path.join(base, 'label_2', sid + '.txt'), 'w') as f:
            f.write('\n'.join(lines) + '\n')
        n = 4000          # velodyne points ahead of the car (x forward)
        pts = np.stack([rng.uniform(4, 45, n), rng.uniform(-12, 12, n),
                        rng.uniform(-1.7, 0.8, n), rng.uniform(0, 1, n)], 1)
        pts.astype(np.float32).tofile(
            os.path.join(base, 'velodyne', sid + '.bin'))
    ids = [f[0] for f in frames]
    for split in ('train', 'val'):
        with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'w') as f:
            f.write('\n'.join(f'{i:06d}' for i in ids) + '\n')
    return ids


# --- a synthetic Waymo kitti_format tree (phase 9; the port's tests use it
# too): Waymo's five cameras at their sizes (H, W), yaw from the vehicle's x
WAYMO_CAMERAS = (('FRONT', (1280, 1920), 0.0),
                 ('FRONT_LEFT', (1280, 1920), 0.785),
                 ('FRONT_RIGHT', (1280, 1920), -0.785),
                 ('SIDE_LEFT', (886, 1920), 1.571),
                 ('SIDE_RIGHT', (886, 1920), -1.571))
WAYMO_FOCAL = 2055.0          # px at 1920 wide, about Waymo's front camera
WAYMO_CAMERA_AT = (1.43, 0.0, 2.18)   # vehicle frame (the LET metric's)
# vehicle-frame objects: label, bottom-centre box (x, y, z, l, w, h, yaw),
# most visible camera
WAYMO_OBJECTS = (
    (0, (15.0, 0.0, 0.0, 4.5, 2.0, 1.6, 0.1), 'FRONT'),
    (0, (25.0, -5.0, 0.0, 4.6, 2.0, 1.7, -0.2), 'FRONT'),
    (0, (12.0, 10.0, 0.0, 4.4, 1.9, 1.5, 1.3), 'FRONT_LEFT'),
    (0, (0.5, 12.0, 0.0, 4.5, 2.0, 1.6, 0.0), 'SIDE_LEFT'),
    (1, (10.0, -3.0, 0.0, 0.8, 0.7, 1.75, 0.0), 'FRONT'),
    (2, (18.0, 4.0, 0.0, 1.8, 0.7, 1.7, 0.5), 'FRONT'))


def waymo_lidar2img(yaw, hw, scale=1.0):
    """(4, 4) vehicle -> pixel projection of a camera at WAYMO_CAMERA_AT
    looking along `yaw`, principal point at the image centre."""
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[s, -c, 0], [0, 0, -1], [c, s, 0]])   # right, down, fwd
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ np.asarray(WAYMO_CAMERA_AT)
    k = np.eye(4)
    k[0, 0] = k[1, 1] = WAYMO_FOCAL * scale
    k[0, 2], k[1, 2] = hw[1] / 2, hw[0] / 2
    return k @ ext


def write_waymo_tree(root, seed=0, frames=2, scale=1.0):
    """A Waymo kitti_format tree under `root`: `frames` frames of one
    context, five PNG views each at Waymo's camera sizes times `scale`
    (training/image_{v}/{idx:07d}.png), and `waymo_infos_val.pkl` with
    lidar2img, ego2global (2 m of forward motion a frame), the objects as
    'annos' and 'cam_sync_annos' (gt_boxes / gt_boxes_3d bottom-centre,
    labels, names, camera_names, num_lidar_points), context_name and
    timestamp_micros, and from frame 1 on 'sweeps': the previous frame's
    views, ego2global and timestamp (the 10-sweeps config's reference
    frame); returns the infos."""
    import os
    import pickle
    from dfm_tpu_torch.data.png import png_bytes
    rng = np.random.default_rng(seed)
    names = ('Car', 'Pedestrian', 'Cyclist')
    boxes = np.array([b for _, b, _ in WAYMO_OBJECTS])
    labels = np.array([lb for lb, _, _ in WAYMO_OBJECTS])
    annos = dict(gt_boxes=boxes, gt_boxes_3d=boxes, labels=labels,
                 names=[names[lb] for lb in labels],
                 camera_names=[c for _, _, c in WAYMO_OBJECTS],
                 num_lidar_points=np.full(len(boxes), 50))
    infos = []
    for idx in range(frames):
        views = []
        for v, (_, (h, w), yaw) in enumerate(WAYMO_CAMERAS):
            h, w = int(h * scale), int(w * scale)
            path = f'training/image_{v}/{idx:07d}.png'
            os.makedirs(os.path.join(root, os.path.dirname(path)),
                        exist_ok=True)
            yy, xx = np.mgrid[0:h, 0:w]
            img = (np.sin(xx / 37.0 + idx + v)[..., None] * 50
                   + np.cos(yy / 19.0)[..., None] * 40 + [100, 110, 120]
                   + rng.normal(0, 10, (h, w, 3)))
            with open(os.path.join(root, path), 'wb') as f:
                f.write(png_bytes(np.clip(img, 0, 255).astype(np.uint8)))
            l2i = waymo_lidar2img(yaw, (h, w), scale)
            views.append(dict(image_path=path, lidar2img=l2i,
                              cam2img=l2i, height=h, width=w))
        e2g = np.eye(4)
        e2g[0, 3] = 2.0 * idx
        infos.append(dict(sample_idx=idx, context_name='synthetic_ctx',
                          timestamp_micros=1_000_000 + 100_000 * idx,
                          images=views, ego2global=e2g,
                          annos=dict(annos), cam_sync_annos=dict(annos)))
        if idx:
            prev = infos[idx - 1]
            infos[idx]['sweeps'] = [dict(
                images=prev['images'], ego2global=prev['ego2global'],
                timestamp_micros=prev['timestamp_micros'])]
    with open(os.path.join(root, 'waymo_infos_val.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    return infos


def _pb_varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb(fn, value):
    """One protobuf field: an int as a varint, a float as a 64-bit double
    (wire type 1), bytes / str length-delimited."""
    if isinstance(value, bool) or isinstance(value, int):
        return _pb_varint(fn << 3) + _pb_varint(int(value))
    if isinstance(value, float):
        return _pb_varint(fn << 3 | 1) + struct.pack('<d', value)
    if isinstance(value, str):
        value = value.encode()
    return _pb_varint(fn << 3 | 2) + _pb_varint(len(value)) + bytes(value)


def _pb_box(box7):
    """A Label.Box of a bottom-centre (x, y, z, l, w, h, yaw) box."""
    x, y, z, le, wi, he, yaw = map(float, box7)
    return b''.join(_pb(k, v) for k, v in (
        (1, x), (2, y), (3, z + he / 2), (4, wi), (5, le), (6, he),
        (7, yaw)))


def waymo_frame_record(idx, jpegs, context='synthetic_segment'):
    """The bytes of one Waymo `Frame` proto: five cameras of
    WAYMO_CAMERAS (extrinsic vehicle <- camera at WAYMO_CAMERA_AT along
    each yaw, intrinsics f_u, f_v, c_u, c_v and five zero distortion terms,
    the size of its image), each camera's JPEG `jpegs[v]` = (bytes, (H,
    W)),
    the pose (2 m of forward motion a frame) and LiDAR labels: the
    objects of WAYMO_OBJECTS (types 1, 2, 4), the first two with their
    most visible camera named and the first with a camera-synced box 0.2 m
    ahead, a sign (type 3) and a car behind the vehicle that no camera
    sees."""
    types = (1, 2, 4)
    cams, imgs = b'', b''
    for v, (name, _, yaw) in enumerate(WAYMO_CAMERAS):
        data, (h, w) = jpegs[v]
        c, s_ = np.cos(yaw), np.sin(yaw)
        ext = np.eye(4)
        ext[:3, :3] = [[c, -s_, 0], [s_, c, 0], [0, 0, 1]]
        ext[:3, 3] = WAYMO_CAMERA_AT
        f = WAYMO_FOCAL * w / 1920.0
        intr = (f, f, w / 2.0, h / 2.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        cal = _pb(1, v + 1) + b''.join(_pb(2, float(x)) for x in intr) + \
            _pb(3, b''.join(_pb(1, float(x)) for x in ext.reshape(-1))) + \
            _pb(4, w) + _pb(5, h)
        cams += _pb(2, cal)
        imgs += _pb(4, _pb(1, v + 1) + _pb(2, data))
    labels = b''
    objects = [(types[lb], box, cam if i < 2 else '')
               for i, (lb, box, cam) in enumerate(WAYMO_OBJECTS)]
    objects += [(3, (20.0, 3.0, 0.0, 0.5, 0.5, 2.0, 0.0), ''),
                (1, (-20.0, 0.0, 0.0, 4.5, 2.0, 1.6, 0.0), '')]
    for i, (t, box, cam) in enumerate(objects):
        lab = _pb(1, _pb_box(box)) + _pb(3, t) + _pb(4, f'obj{i}') + \
            _pb(7, 30 + i)
        if cam:
            lab += _pb(11, cam)
        if i == 0:
            lab += _pb(12, _pb_box((box[0] + 0.2,) + tuple(box[1:])))
        labels += _pb(6, lab)
    pose = np.eye(4)
    pose[0, 3] = 2.0 * idx
    return (_pb(1, _pb(1, context) + cams) + _pb(2, 1_000_000 + 100_000 * idx)
            + _pb(3, b''.join(_pb(1, float(x)) for x in pose.reshape(-1)))
            + imgs + labels)


def write_waymo_tfrecord(path, frames=2, jpegs=None):
    """A TFRecord file of `frames` `waymo_frame_record`s (the small JPEG
    fixtures of tests/data/jpeg as the five cameras' images unless
    `jpegs` gives others); the crcs are zeros (the parser skips them).
    Returns the file's size."""
    import os
    if jpegs is None:
        folder, man = _jpeg_fixtures()
        jpegs = []
        for k in ('small_420', 'small_444', 'small_422_rst', 'small_420',
                  'small_444'):
            with open(os.path.join(folder, k + '.jpg'), 'rb') as f:
                jpegs.append((f.read(), tuple(man[k]['shape'][:2])))
    with open(path, 'wb') as f:
        for i in range(frames):
            rec = waymo_frame_record(i, jpegs)
            f.write(struct.pack('<Q', len(rec)) + b'\0' * 4 + rec +
                    b'\0' * 4)
    return os.path.getsize(path)


def teacher_tree(teacher, seed):
    """A seeded flax tree {'params', 'batch_stats'} in the layout of the JAX
    teacher file for the port's `LidarTeacher` `teacher` (its shapes, by
    `dfm_full_key_map`): kernels (k..., I, O) lecun-scaled, norm scales
    near 1, biases and means small, variances in [0.5, 1.5)."""
    from dfm_tpu_torch.utils.weights import dfm_full_key_map
    rng = np.random.default_rng(seed)
    sd = teacher.state_dict()
    tree = {'params': {}, 'batch_stats': {}}

    def put(group, path, leaf, value):
        node = tree[group]
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.astype(np.float32)

    for prefix, fpath, kind in dfm_full_key_map():
        if fpath[0] != 'lidar_teacher':
            continue
        w = sd[prefix[len('lidar_teacher.'):] + '.weight']
        path = fpath[1:]
        if kind.startswith('conv'):
            io = tuple(w.shape[:2]) if kind.startswith('convt') else \
                (w.shape[1], w.shape[0])
            shape = tuple(w.shape[2:]) + io
            put('params', path, 'kernel', rng.standard_normal(shape)
                / np.sqrt(np.prod(shape[:-1])))
            continue
        c = w.shape[0]
        put('params', path, 'scale', 1 + 0.1 * rng.standard_normal(c))
        put('params', path, 'bias', 0.1 * rng.standard_normal(c))
        if kind == 'bn':
            put('batch_stats', path, 'mean', 0.1 * rng.standard_normal(c))
            put('batch_stats', path, 'var', 0.5 + rng.random(c))
    return tree


def needed_bytes(plain, table, row_elems, *args):
    """Bytes of the rows of `table` (`row_elems` elements each) that the
    function needs: rows with a nonzero gradient through the plain
    version (every tap weight is >= 0, so nothing cancels)."""
    t = table.float().requires_grad_()
    with torch.enable_grad():
        out = plain(t, *args)
        out = out[0] if isinstance(out, tuple) else out
        out.sum().backward()
    rows = t.grad.reshape(-1, row_elems)
    return int((rows != 0).any(1).sum()) * row_elems * table.element_size()


def reporter(results):
    """The (agree, report) pair of the kernel checks: agree holds a
    kernel's result against its plain version's, report prints a
    kernel's line and keeps its entry of the kernels JSON in
    `results`."""
    def agree(name, got, want, tol):
        """Max abs err of kernel against plain, within atol + rtol."""
        err = (got.float() - want.float()).abs()
        limit = tol[0] + tol[1] * want.float().abs()
        check(bool((err <= limit).all()),
              f'{name}: kernel disagrees with its plain version '
              f'(max abs err {float(err.max())})')
        return float(err.max())

    def report(name, src, replaces, err, tol, ms, plain_ms, lib_ms, nbytes,
               flops, peak=F32_FLOPS, **extra):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        results[name] = dict(
            name=name, route='cuda', source=src, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by='bytes' if t_bytes >= t_ops else 'operations',
            library_ms=lib_ms, **extra)
        lib = 'none' if lib_ms is None else f'{lib_ms:.4f}'
        more = ''.join(f' {k} {v:.3g}' if k.startswith('max_abs_err') else
                       f' {k} {v:.4f}' if isinstance(v, float) else
                       f' {k} {v}' for k, v in extra.items())
        print(f'kernel {name}: max_abs_err {err:.3g} '
              f'(tol atol {tol[0]} + rtol {tol[1]}) ms {ms:.4f} '
              f'plain_ms {plain_ms:.4f} library_ms {lib}{more} '
              f'bytes {nbytes} flops {flops} '
              f'bound_ms {max(t_bytes, t_ops):.4f}', flush=True)

    return agree, report


def kernel_phase(cfg, dev):
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import cost_volume as CV
    from dfm_tpu_torch.ops import frustum_separable as FS
    from dfm_tpu_torch.ops.cuda import sampling as K
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    h, w = IMG_HW
    meta = kitti_meta(1, dev)
    depths = torch.as_tensor(cfg.downsampled_depths(), device=dev)
    d = len(depths)
    hq, wq = h // cfg.cost_sample_factor, w // cfg.cost_sample_factor
    coors = cfg.coordinates_3d()
    xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
    u, v = FS.slab_uv(meta.cam2img, xs, ys, zs)
    nz, ny, nx = cfg.voxel_grid_size()
    results = {}
    agree, report = reporter(results)

    # K1 at (1, 320, 1280, 32) -> (1, 72, 80, 320, 32): the sweep (grid
    # computed in the kernel) at the KITTI meta and at a flip + crop +
    # scale meta
    prev = torch.randn(1, h, w, cfg.stereo_channels[1], generator=gen,
                       device=dev).to(bf)
    step = cfg.cost_sample_factor

    def sweep_inputs(m):
        return CV.sweep_params(m.ori_cam2img, m.cur2prev, m.org_w, m.flip,
                               m.crop_offset, m.scale_factor, 1)

    params = sweep_inputs(meta)
    aug = kitti_meta(1, dev)
    aug.flip = torch.ones(1, device=dev)
    aug.crop_offset = torch.tensor([[24.0, 8.0]], device=dev)
    aug.scale_factor = torch.full((1,), 1.1, device=dev)
    tol1 = (1e-2, 1e-2)
    err1 = 0.0
    for m in (meta, aug):
        pm = sweep_inputs(m)
        got = K.warp_prev_sweep(prev, pm, depths, hq, wq, step)
        want = CV.warp_prev_plain(prev, *CV.sweep_coords_plain(
            pm, depths, hq, wq, step))
        err1 = max(err1, agree('warp_prev_sweep', got, want, tol1))
        # the sweep's points against the grids of plane_sweep_grids
        _, grid = CV.plane_sweep_grids(
            depths, m.ori_cam2img, m.cur2prev, (h, w), step, 1, m.org_w,
            m.flip, m.crop_offset, m.scale_factor)
        pu, pv = CV.sweep_coords_plain(pm, depths, hq, wq, step)
        gap = max(float((pu - grid[..., 0]).abs().max()),
                  float((pv - grid[..., 1]).abs().max()))
        check(gap <= 2e-3, f'sweep points {gap} px from plane_sweep_grids')
    _, grid = CV.plane_sweep_grids(
        depths, meta.ori_cam2img, meta.cur2prev, (h, w), step, 1,
        meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)
    gu, gv = grid[..., 0].contiguous(), grid[..., 1].contiguous()
    prev_nchw = prev.permute(0, 3, 1, 2).contiguous()
    norm = torch.stack([gu / (w - 1) * 2 - 1, gv / (h - 1) * 2 - 1],
                       -1).reshape(1, d * hq, wq, 2).to(bf)
    sweep = lambda: K.warp_prev_sweep(prev, params, depths, hq, wq,  # noqa
                                      step)
    report('warp_prev', 'dfm_tpu_torch/csrc/warp_prev.cu',
           'dfm_tpu/ops/pallas/cost_warp.py:142', err1, tol1,
           cuda_ms(sweep),
           cuda_ms(lambda: CV.warp_prev_plain(prev, *CV.sweep_coords_plain(
               params, depths, hq, wq, step))),
           cuda_ms(lambda: F.grid_sample(prev_nchw, norm,
                                         align_corners=True)),
           needed_bytes(CV.warp_prev_plain, prev, prev.shape[-1], gu, gv)
           + params.numel() * 4 + d * 4 + got.numel() * got.element_size(),
           8 * got.numel(), device_ms=device_ms(sweep),
           ms_sweep_params=cuda_ms(lambda: sweep_inputs(meta)),
           ms_plane_sweep_grids=cuda_ms(lambda: CV.plane_sweep_grids(
               depths, meta.ori_cam2img, meta.cur2prev, (h, w), step, 1,
               meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)),
           library_device_ms=device_ms(
               lambda: F.grid_sample(prev_nchw, norm, align_corners=True)))

    def lib_grid(depth_bins, hh, ww):
        """grid_sample coords (x, y, z) in [-1, 1] of every voxel."""
        zi = (torch.as_tensor(xs, device=dev) - cfg.depth_min) / (
            cfg.depth_max - cfg.depth_min) * (depth_bins - 1)
        gx = (u / (IMG_HW[1] - 1) * (ww - 1)).transpose(1, 2)[:, None]
        gy = (v / (IMG_HW[0] - 1) * (hh - 1)).transpose(1, 2)[:, :, None]
        g = torch.stack(torch.broadcast_tensors(
            gx / (ww - 1) * 2 - 1, gy / (hh - 1) * 2 - 1,
            (zi / (depth_bins - 1) * 2 - 1).view(1, 1, 1, -1)), -1)
        return g.reshape(1, nz, ny, nx, 3)

    # K3 at (1, 288, 320, 1280) -> (1, 20, 304, 288) f32; its output is
    # the attention the fused K2 takes
    cost = torch.randn(1, d, hq, wq, generator=gen, device=dev)
    sm = FS.build_fine_softmax_volume(cost, cfg.depth_downsample, IMG_HW,
                                      bf)
    df = d * cfg.depth_downsample
    dsf = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, df)
    tabf = FS.depth_tables(dsf, dev)
    att = K.attention_sample(sm, u, v, dsf, IMG_HW)
    want = FS.attention_sample_plain(sm, u, v, *tabf, IMG_HW)
    sm_ncdhw = sm[:, None]
    g3 = lib_grid(df, h, w).to(bf)
    k3_ms = cuda_ms(lambda: K.attention_sample(sm, u, v, dsf, IMG_HW))
    k3_lib = cuda_ms(lambda: F.grid_sample(sm_ncdhw, g3, align_corners=True))
    report('attention_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:233',
           agree('attention_sample', att, want, (1e-5, 1e-5)), (1e-5, 1e-5),
           k3_ms,
           cuda_ms(lambda: FS.attention_sample_plain(sm, u, v, *tabf,
                                                     IMG_HW)),
           k3_lib,
           needed_bytes(FS.attention_sample_plain, sm, 1, u, v, *tabf,
                        IMG_HW)
           + (u.numel() + v.numel()) * 4 + att.numel() * 4,
           16 * att.numel(), ratio_to_grid_sample=k3_ms / k3_lib,
           device_ms=device_ms(
               lambda: K.attention_sample(sm, u, v, dsf, IMG_HW)),
           library_device_ms=device_ms(
               lambda: F.grid_sample(sm_ncdhw, g3, align_corners=True)))
    del sm, sm_ncdhw, g3

    # K2 fused at (1, 72, 80, 320, 32) + sem (1, 80, 320, 32) + K3's
    # attention -> (1, 20, 304, 288, 64)
    vol = torch.randn(1, d, hq, wq, cfg.cv_channels, generator=gen,
                      device=dev).to(bf)
    sem = torch.randn(1, hq, wq, cfg.sem_channels[1], generator=gen,
                      device=dev).to(bf)
    ds = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
    tabs = FS.depth_tables(ds, dev)
    fused = lambda: K.frustum_voxel_features(vol, sem, att, u, v,  # noqa
                                             ds, IMG_HW)
    got = fused()
    want = FS.frustum_voxel_features_plain(vol, sem, att, u, v, *tabs,
                                           IMG_HW)
    check(got.shape == (1, nz, ny, nx, vol.shape[-1] + sem.shape[-1]),
          f'frustum_voxel_features: shape {tuple(got.shape)}')
    # the halves apart: the sem half is the sem sample times K3's
    # attention (~1/288 here), so the stereo half's bound would not see it
    c = vol.shape[-1]
    sem_tol = (1e-5, 2.0 ** -8)       # one bf16 rounding of its own size
    err_stereo = agree('frustum_voxel_features stereo half', got[..., :c],
                       want[..., :c], (1e-2, 1e-2))
    err_sem = agree('frustum_voxel_features sem half', got[..., c:],
                    want[..., c:], sem_tol)
    check(bool((want[..., c:] != 0).any()),
          'frustum_voxel_features: the sem half is all zero')
    vol_ncdhw = vol.permute(0, 4, 1, 2, 3).contiguous()
    g2 = lib_grid(d, hq, wq).to(bf)
    sem_rows = needed_bytes(
        lambda s, *a: FS.frustum_voxel_features_plain(vol.float(), s, att,
                                                      *a),
        sem, sem.shape[-1], u, v, *tabs, IMG_HW)
    vol_rows = needed_bytes(FS.stereo_sample_plain, vol, vol.shape[-1], u,
                            v, *tabs, IMG_HW)
    report('frustum_stereo_sample', 'dfm_tpu_torch/csrc/frustum_sample.cu',
           'dfm_tpu/ops/pallas/frustum_sample.py:92',
           max(err_stereo, err_sem), (1e-2, 1e-2),
           cuda_ms(fused),
           cuda_ms(lambda: FS.frustum_voxel_features_plain(
               vol, sem, att, u, v, *tabs, IMG_HW)),
           cuda_ms(lambda: F.grid_sample(vol_ncdhw, g2,
                                         align_corners=True)),
           vol_rows + sem_rows + att.numel() * 4
           + (u.numel() + v.numel()) * 4 + got.numel() * 2,
           16 * got[..., :c].numel() + 9 * got[..., c:].numel(),
           max_abs_err_stereo=err_stereo, max_abs_err_sem=err_sem,
           sem_tol=f'atol {sem_tol[0]} + rtol {sem_tol[1]}',
           device_ms=device_ms(fused),
           library_device_ms=device_ms(
               lambda: F.grid_sample(vol_ncdhw, g2, align_corners=True)))
    del g2, vol_ncdhw
    chain_kernel_phase(vol[0], gen, agree, report)
    for name, n in conv3d_kernel_phase(vol[0], gen, agree, report).items():
        if name in results:     # the backward kernels report in phase 7
            results[name]['launches'] = n
    return results


def moments_agree(name, ps, want_ps, n):
    """Per-slice moments (summed over tiles) against the plain version's:
    sums of squares rtol 1e-4; sums rtol 1e-4 + atol 1e-6 * sqrt(n * sum
    of squares), n values per sum."""
    got_z, want_z = ps.sum(1).double(), want_ps.sum(1).double()
    lim = 1e-4 * want_z.abs()
    lim[:, 0] += 1e-6 * (n * want_z[:, 1]).sqrt()
    check(bool(((got_z - want_z).abs() <= lim).all()),
          f'{name}: moments disagree')


def chain_kernel_phase(x, gen, agree, report):
    """K8a, K8b, K4, K7a, K7b, K5, K6 at the two volumes the main path
    gives them: the stereo trunk's (72, 80, 320, 32) bf16 and the reduced
    mono trunk's (44, 80, 320, 32), where K4 splits the depth in other
    chunks and K7a's scale and bias come from moments weighted by the
    slice multiplicities. The copies (K8a, K8b, K6) and K7b against their
    plain versions' bits (K7a within a rounding); the convs agree with
    the plain versions to one bf16 rounding (atol 1e-2 + rtol 1e-2: the
    f32 sums of 864 products are taken in another order, so a result near
    a rounding boundary may round the other way). Moments: sums of
    squares rtol 1e-4; sums rtol 1e-4 + atol 1e-6 * sqrt(N * sum of
    squares), N values per sum (a sum of signed terms cancels, so its
    error scales with the terms, not with the sum). The plain K4 and K5
    convolve in f32 with cuDNN's TF32 off (bf16-valued operands are exact
    either way). Kernel times at both depths; plain and library times,
    and the bound, at depth 72."""
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import conv_chain as CC
    from dfm_tpu_torch.ops.cuda import conv_chain as KC
    from dfm_tpu_torch.ops.reduced_depth import make_reduced_plan
    src = 'dfm_tpu_torch/csrc/conv_chain.cu'
    src_p2p = 'dfm_tpu_torch/csrc/conv_p2p.cuh'
    src_hg = 'dfm_tpu_torch/csrc/hourglass_chain.cu'
    jax_src = 'dfm_tpu/ops/pallas/conv_chain.py'
    tol = (1e-2, 1e-2)
    dev = x.device
    d, h, w, c = x.shape
    plan = make_reduced_plan(d)
    check(plan is not None and plan.dr == MONO_DEPTH,
          f'the reduced mono depth of {d} planes is not {MONO_DEPTH}')
    weight = torch.randn(c, c, 3, 3, 3, generator=gen, device=dev) \
        / (27 * c) ** 0.5
    w64 = torch.randn(2 * c, c, 3, 3, 3, generator=gen, device=dev) \
        / (27 * c) ** 0.5
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    beta = torch.randn(c, generator=gen, device=dev)

    def at_depth(depth):
        """Every check of the seven kernels on `depth` slices; the kernel
        times, and what the depth-72 report needs besides."""
        xd = x if depth == d else x[:depth].contiguous()
        zw = None if depth == d else plan.mult(0)
        at = f'(D={depth})'
        m = dict(err={}, ms={})

        # K8a
        cv = KC.pack_vol(xd)
        check(torch.equal(cv.data, CC.pack_vol_plain(xd).data),
              f'pack_vol: kernel differs from its plain version {at}')
        check(cv.border_is_zero(), f'pack_vol: border not zero {at}')
        m['ms']['pack_vol'] = cuda_ms(lambda: KC.pack_vol(xd))

        # K8b: bit for bit the copy of the interior, which is also the
        # one PyTorch call of the same function
        got = KC.unpack_vol(cv)
        check(torch.equal(got, CC.unpack_vol_plain(cv)),
              f'unpack_vol: kernel differs from its plain version {at}')
        check(torch.equal(got, xd), f'pack_vol, unpack_vol: round trip {at}')
        m['ms']['unpack_vol'] = cuda_ms(lambda: KC.unpack_vol(cv))

        # K4, both residual modes, and K5
        flag = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            errs = []
            for residual in (False, True):
                out, ps = KC.conv_p2p(cv, weight, residual)
                out2, ps2 = KC.conv_p2p(cv, weight, residual)
                check(torch.equal(out.data, out2.data)
                      and torch.equal(ps, ps2),
                      f'conv_p2p: two runs differ {at}')
                check(out.border_is_zero(), f'conv_p2p: border not zero {at}')
                want, wps = CC.conv_p2p_plain(cv, weight, residual)
                errs.append(agree('conv_p2p', out.data, want.data, tol))
                moments_agree(f'conv_p2p (residual={residual}) {at}', ps,
                              wps, h * w)
                if not residual:
                    u, ups = out, ps
            m['err']['conv_p2p'] = max(errs)

            y, ps = KC.conv_s2_p2d(cv, w64)
            y2, ps2 = KC.conv_s2_p2d(cv, w64)
            check(torch.equal(y, y2) and torch.equal(ps, ps2),
                  f'conv_s2_p2d: two runs differ {at}')
            check(tuple(y.shape) == (depth // 2, h // 2, w // 2, 2 * c),
                  f'conv_s2_p2d: shape {tuple(y.shape)}')
            want, wps = CC.conv_s2_plain(cv, w64)
            m['err']['conv_s2_p2d'] = agree('conv_s2_p2d', y, want, tol)
            moments_agree(f'conv_s2_p2d {at}', ps, wps, h * w // 4)
            m['s2_bytes'] = (cv.data.numel() * 2 + y.numel() * 2
                             + w64.numel() * 2 + ps.numel() * 4)
            if depth == d:
                m['p2p_plain_ms'] = cuda_ms(
                    lambda: CC.conv_p2p_plain(cv, weight))
                m['s2_plain_ms'] = cuda_ms(lambda: CC.conv_s2_plain(cv, w64))
        finally:
            torch.backends.cudnn.allow_tf32 = flag
        m['ms']['conv_p2p'] = cuda_ms(lambda: KC.conv_p2p(cv, weight))
        m['ms']['conv_p2p residual'] = cuda_ms(
            lambda: KC.conv_p2p(cv, weight, True))
        m['ms']['conv_s2_p2d'] = cuda_ms(lambda: KC.conv_s2_p2d(cv, w64))
        m['s2_device_ms'] = device_ms(lambda: KC.conv_s2_p2d(cv, w64))

        # the scale and bias as the main path makes them: GroupNorm of
        # K4's result from its moments, the slices of the reduced volume
        # weighted by their multiplicities
        sc, bs = CC.gn_scale_bias(ups, u.shape, gamma, beta, c, zw)

        # K7a: stem exit (residual, no relu) and pred exit (relu)
        m['err']['unpack_affine_res'] = max(
            agree('unpack_affine_res', KC.unpack_affine(u, sc, bs, res, relu),
                  CC.unpack_affine_plain(u, sc, bs, res, relu), tol)
            for res, relu in ((cv, False), (None, True)))
        m['ms']['unpack_affine_res'] = cuda_ms(
            lambda: KC.unpack_affine(u, sc, bs, cv, False))
        m['ms']['unpack_affine_res relu'] = cuda_ms(
            lambda: KC.unpack_affine(u, sc, bs, None, True))

        # K7b: the stem and hourglass exits (residual, no relu) and the
        # other three modes, bit for bit (separate f32 multiply and add
        # in both)
        for res, relu in ((cv, False), (None, True), (cv, True),
                          (None, False)):
            got = KC.affine_chain(u, sc, bs, res, relu)
            check(torch.equal(got.data,
                              CC.affine_mask(u, sc, bs, relu, res).data),
                  f'gn_affine_res_packed: kernel differs from its plain '
                  f'version (residual={res is not None}, relu={relu}) {at}')
            check(got.border_is_zero(),
                  f'gn_affine_res_packed: border not zero {at}')
        m['ms']['gn_affine_res_packed'] = cuda_ms(
            lambda: KC.affine_chain(u, sc, bs, cv, False))
        m['ms']['gn_affine_res_packed relu'] = cuda_ms(
            lambda: KC.affine_chain(u, sc, bs, None, True))

        # K6 on sub-volumes laid out as `convt1_parity` leaves them (a
        # strided view, the eight parities of a voxel side by side) and
        # contiguous: the interleave bit for bit, the moments of the
        # stored values, twice
        buf = torch.randn(depth // 2 + 1, h // 2 + 1, w // 2 + 1, 8, c,
                          generator=gen, device=dev).to(x.dtype)
        par = buf[:depth // 2, :h // 2, :w // 2].permute(3, 0, 1, 2, 4)
        got, ps = KC.pack_parity8(par)
        for again in (par, par.contiguous()):
            got2, ps2 = KC.pack_parity8(again)
            check(torch.equal(got.data, got2.data) and torch.equal(ps, ps2),
                  f'pack_parity8: two runs differ {at}')
        want, wps = CC.pack_parity8_plain(par)
        check(torch.equal(got.data, want.data),
              f'pack_parity8: kernel differs from its plain version {at}')
        check(got.border_is_zero(), f'pack_parity8: border not zero {at}')
        moments_agree(f'pack_parity8 {at}', ps, wps, h * w)
        m['ms']['pack_parity8'] = cuda_ms(lambda: KC.pack_parity8(par))
        m['p8_bytes'] = (par.numel() * 2 + got.data.numel() * 2
                         + ps.numel() * 4)
        if depth == d:
            m['p8_plain_ms'] = cuda_ms(lambda: CC.pack_parity8_plain(par))
            m['ps_bytes'] = ups.numel() * 4
            m['tensors'] = (cv, u, sc, bs)
        return m

    mono, full = at_depth(MONO_DEPTH), at_depth(d)
    cv, u, sc, bs = full['tensors']
    nvox = d * h * w
    dense_bytes, chain_bytes = x.numel() * 2, cv.data.numel() * 2
    x5 = x.permute(3, 0, 1, 2)[None]               # NCDHW view, NDHWC memory
    w5, x64 = weight.to(x.dtype), w64.to(x.dtype)

    def lib_moments(wt, stride):
        y = F.conv3d(x5, wt, stride=stride, padding=1).float()
        return y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))

    def rep(name, source, line, plain_ms, lib_ms, nbytes, flops, modes=(),
            **kw):
        """One kernel's line: exact copies have tolerance 0; `modes` are
        the kernel's other timed modes."""
        exact = name not in full['err']
        extra = {f'ms_{mode}': full['ms'][f'{name} {mode}'] for mode in modes}
        extra[f'ms_depth{MONO_DEPTH}'] = mono['ms'][name]
        for mode in modes:
            extra[f'ms_{mode}_depth{MONO_DEPTH}'] = mono['ms'][f'{name} {mode}']
        extra.update(kw.pop('extra', {}))
        report(name, source, jax_src + line,
               0.0 if exact else max(full['err'][name], mono['err'][name]),
               (0, 0) if exact else tol, full['ms'][name], plain_ms, lib_ms,
               nbytes, flops, **kw, **extra)

    rep('pack_vol', src, ':444', cuda_ms(lambda: CC.pack_vol_plain(x)),
        cuda_ms(lambda: F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))),
        dense_bytes + chain_bytes, 0)
    rep('unpack_vol', src, ':515', cuda_ms(lambda: CC.unpack_vol_plain(cv)),
        cuda_ms(lambda: cv.interior().contiguous()),
        dense_bytes + chain_bytes, 0)
    p2p_flops = 2 * 27 * c * c * nvox
    p2p_tflops = p2p_flops / full['ms']['conv_p2p'] / 1e9
    rep('conv_p2p', src_p2p, ':233', full['p2p_plain_ms'],
        cuda_ms(lambda: F.conv3d(x5, w5, padding=1)),
        2 * chain_bytes + weight.numel() * 2 + full['ps_bytes'],
        p2p_flops, modes=('residual',), peak=BF16_TENSOR_FLOPS,
        extra=dict(library_with_moments_ms=cuda_ms(
            lambda: lib_moments(w5, 1)), tflops=p2p_tflops,
            bf16_peak_share=p2p_tflops * 1e12 / BF16_TENSOR_FLOPS,
            device_ms=device_ms(lambda: KC.conv_p2p(cv, weight))))
    # no single PyTorch call computes K7a, K7b or K6: no library time
    rep('unpack_affine_res', src, ':624',
        cuda_ms(lambda: CC.unpack_affine_plain(u, sc, bs, cv, False)), None,
        3 * dense_bytes + 2 * c * 4, 3 * x.numel(), modes=('relu',))
    rep('gn_affine_res_packed', src, ':935',
        cuda_ms(lambda: CC.affine_mask(u, sc, bs, False, cv)), None,
        3 * chain_bytes + 2 * c * 4, 3 * x.numel(), modes=('relu',))
    rep('conv_s2_p2d', src_hg, ':814', full['s2_plain_ms'],
        cuda_ms(lambda: F.conv3d(x5, x64, stride=2, padding=1)),
        full['s2_bytes'], 2 * 27 * c * 2 * c * nvox // 8,
        peak=BF16_TENSOR_FLOPS,
        extra=dict(library_with_moments_ms=cuda_ms(
            lambda: lib_moments(x64, 2)), device_ms=full['s2_device_ms'],
            **{f'device_ms_depth{MONO_DEPTH}': mono['s2_device_ms']}))
    rep('pack_parity8', src_hg, ':1033', full['p8_plain_ms'], None,
        full['p8_bytes'], 3 * x.numel())

    # the tap products that feed K6 (plain matrix products, no kernel of
    # the port): with K6 they are the transposed conv, to one bf16 rounding
    post = torch.randn(d // 2, h // 2, w // 2, 2 * c, generator=gen,
                       device=dev).to(x.dtype)
    wt = torch.randn(2 * c, c, 3, 3, 3, generator=gen, device=dev) \
        / (8 * c) ** 0.5
    post5, wt5 = post.permute(3, 0, 1, 2)[None], wt.to(x.dtype)
    up = KC.pack_parity8(CC.convt1_parity(post, wt))[0].interior()
    ref = F.conv_transpose3d(post5, wt5, None, 2, 1, 1)[0].permute(1, 2, 3, 0)
    err = agree('convt1_parity + pack_parity8', up, ref, tol)
    print(f'convt1_parity + pack_parity8 vs F.conv_transpose3d: max_abs_err '
          f'{err:.3g} (tol atol {tol[0]} + rtol {tol[1]}) convt1_parity ms '
          f'{cuda_ms(lambda: CC.convt1_parity(post, wt)):.4f} '
          f'conv_transpose3d ms '
          f'{cuda_ms(lambda: F.conv_transpose3d(post5, wt5, None, 2, 1, 1)):.4f}',
          flush=True)


def conv3d_kernel_phase(x, gen, agree, report):
    """K9a (`ops/cuda/conv3d.py:conv3d_stats`: the moment instance of the
    `wgmma` code for bf16 with C, C_out % 8 == 0, the direct kernel
    elsewhere; and its finish `gn_finish`) and K9b (`conv3d`: the `wgmma`
    code for bf16 with C, C_out % 8 == 0, the direct kernel elsewhere) at
    the DfM trunk width (72, 80, 320, 32) bf16, in float32 at (16, 40, 96,
    32), K9b 16 -> 8 (bf16, f32) and 42 -> 42 (f32: weights chunked over
    C_out), K9a 8 -> 32 and 16 -> 24 (bf16, two chunks): outputs against
    the plain versions, bf16 to one rounding (atol 1e-2 + rtol 1e-2), f32
    atol 1e-4 + rtol 1e-4 (the same f32 products summed in another order;
    cuDNN's TF32 off for the plain convs); K9a's partials in the JAX layout
    as the chain's moments (sums of squares rtol 1e-4, sums rtol 1e-4 +
    atol 1e-6 * sqrt(n * sum of squares)); the finish kernel bit for bit
    its plain apply step on the same inputs; `conv3d_gn` with residual and
    relu to one rounding more; every kernel run twice, bit for bit. Times
    at the DfM width. Then K9's own path, the entry points once each with
    the launch counts set to 0 just before; returns those counts."""
    import torch.nn.functional as F
    from dfm_tpu_torch.ops import conv3d as C3
    from dfm_tpu_torch.ops import convgn as G
    from dfm_tpu_torch.ops.cuda import conv3d as KC3
    from dfm_tpu_torch.ops.cuda import sampling as K
    src = 'dfm_tpu_torch/csrc/conv3d.cu'
    dev = x.device
    d, h, w, c = x.shape
    th = 8

    def weights(c_in, c_out):
        return torch.randn(c_out, c_in, 3, 3, 3, generator=gen,
                           device=dev) / (27 * c_in) ** 0.5

    def volume(shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def partials_agree(name, ps, want, n):
        got, want = ps.double(), want.double()
        lim = 1e-4 * want.abs()
        lim[..., 0, :] += 1e-6 * (n * want[..., 1, :]).sqrt()
        check(bool(((got - want).abs() <= lim).all()),
              f'{name}: partials disagree')

    def code(xx, ww, route):
        return (f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}: '
                + ('direct' if route is None else f'wgmma {route}'))

    w32 = weights(c, c)
    small = (16, 40, 96)
    # (volume, weights, tolerance) of each case; the DfM width first
    cases = [(x, w32, (1e-2, 1e-2)),
             (volume(small + (c,), torch.float32), w32, (1e-4, 1e-4))]
    zpack_cases = cases + [
        (volume(small + (8,), x.dtype), weights(8, c), (1e-2, 1e-2)),
        (volume(small + (16,), x.dtype), weights(16, 24), (1e-2, 1e-2))]
    conv_cases = cases + [
        (volume(small + (16,), x.dtype), weights(16, 8), (1e-2, 1e-2)),
        (volume(small + (16,), torch.float32), weights(16, 8), (1e-4, 1e-4)),
        (volume((8,) + small[1:] + (42,), torch.float32), weights(42, 42),
         (1e-4, 1e-4))]
    err = {'conv3d_zpack': 0.0, 'conv3d_pallas': 0.0}
    codes = {'conv3d_zpack': [], 'conv3d_pallas': []}
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for xx, ww, tol in zpack_cases:
            at = f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}'
            out, ps = KC3.conv3d_stats(xx, ww, th)
            out2, ps2 = KC3.conv3d_stats(xx, ww, th)
            check(torch.equal(out, out2) and torch.equal(ps, ps2),
                  f'conv3d_zpack: two runs differ {at}')
            want, wps = G.conv3d_zpack_plain(xx, ww, th)
            err['conv3d_zpack'] = max(err['conv3d_zpack'],
                                      agree('conv3d_zpack', out, want, tol))
            partials_agree(f'conv3d_zpack {at}', ps, wps, th * xx.shape[2])
            co = ww.shape[0]
            gamma = torch.rand(co, generator=gen, device=dev) + 0.5
            beta = torch.randn(co, generator=gen, device=dev)
            res = volume(xx.shape[:3] + (co,), xx.dtype)
            sc, bs = G.gn_partials_affine(ps, out.shape, gamma, beta, 8)
            for r, relu in ((res, True), (None, False)):
                check(torch.equal(KC3.gn_finish(out, sc, bs, r, relu),
                                  G.gn_finish_plain(out, sc, bs, r, relu)),
                      f'conv3d_gn_finish: kernel differs from its plain '
                      f'version {at} (residual={r is not None}, '
                      f'relu={relu})')
            gn = [f(xx, ww, gamma, beta, 8, residual=res, relu=True, th=th)
                  for f in (G.conv3d_gn, G.conv3d_gn_plain)]
            agree(f'conv3d_gn {at}', *gn, tuple(2 * t for t in tol))
            check(bool((gn[0] >= 0).all()), f'conv3d_gn: relu {at}')
            codes['conv3d_zpack'].append(code(xx, ww, KC3.stats_route(
                xx.dtype, xx.shape[-1], co)[0]))
        for xx, ww, tol in conv_cases:
            at = f'{tuple(xx.shape)} -> {ww.shape[0]} {xx.dtype}'
            out = KC3.conv3d(xx, ww)
            check(torch.equal(out, KC3.conv3d(xx, ww)),
                  f'conv3d_pallas: two runs differ {at}')
            err['conv3d_pallas'] = max(
                err['conv3d_pallas'],
                agree('conv3d_pallas', out, C3.conv3d_plain(xx, ww), tol))
            codes['conv3d_pallas'].append(code(xx, ww, KC3.tensor_core_chunks(
                xx.dtype, xx.shape[-1], ww.shape[0])))
        plain_ms = {'conv3d_zpack': cuda_ms(
                        lambda: G.conv3d_zpack_plain(x, w32, th)),
                    'conv3d_pallas': cuda_ms(
                        lambda: C3.conv3d_plain(x, w32))}
    finally:
        torch.backends.cudnn.allow_tf32 = flag

    x5, w5 = x.permute(3, 0, 1, 2)[None], w32.to(x.dtype)

    def lib_moments():
        y = F.conv3d(x5, w5, padding=1).float()
        return y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))

    xf = cases[1][0]
    (cb, wb), (cf, wf) = (case[:2] for case in conv_cases[2:4])
    lib_ms = cuda_ms(lambda: F.conv3d(x5, w5, padding=1))
    lib_dev = device_ms(lambda: F.conv3d(x5, w5, padding=1))
    flops = 2 * 27 * c * c * d * h * w
    vol_bytes = 2 * x.numel() * x.element_size() + w32.numel() * 4
    gamma, beta = torch.rand(c, device=dev) + 0.5, torch.randn(c, device=dev)

    # the finish at the DfM width: GroupNorm of K9a's result with the
    # residual x and relu, as conv3d_gn applies it
    out, ps = KC3.conv3d_stats(x, w32, th)
    sc, bs = G.gn_partials_affine(ps, out.shape, gamma, beta, 8)
    fin = lambda: KC3.gn_finish(out, sc, bs, x, True)       # noqa: E731
    fin_bytes = 3 * out.numel() * out.element_size() + 2 * c * 4
    fin_dev = device_ms(fin)
    report('conv3d_gn_finish', src, 'dfm_tpu/ops/pallas/convgn.py:216',
           agree('conv3d_gn_finish', fin(),
                 G.gn_finish_plain(out, sc, bs, x, True), (0, 0)), (0, 0),
           cuda_ms(fin),
           cuda_ms(lambda: G.gn_finish_plain(out, sc, bs, x, True)), None,
           fin_bytes, 4 * out.numel(), device_ms=fin_dev)

    stats = lambda: KC3.conv3d_stats(x, w32, th)              # noqa: E731
    gn = lambda: G.conv3d_gn(x, w32, gamma, beta, 8,          # noqa: E731
                             residual=x, relu=True, th=th)
    k9a_ms, k9a_dev = cuda_ms(stats), device_ms(stats)
    report('conv3d_zpack', 'dfm_tpu_torch/csrc/conv_dense.cuh (its moment '
           'instance, from conv3d.cu; the direct kernel of conv3d.cu for '
           'other routes)', 'dfm_tpu/ops/pallas/convgn.py:162',
           err['conv3d_zpack'], (1e-2, 1e-2), k9a_ms,
           plain_ms['conv3d_zpack'], lib_ms,
           vol_bytes + (d // 4) * (h // th) * 2 * 4 * c * 4, flops,
           peak=BF16_TENSOR_FLOPS, device_ms=k9a_dev,
           kernel_device_ms=device_ms(stats, kernel='conv_dense_kernel'),
           library_device_ms=lib_dev, ratio_to_conv3d=k9a_ms / lib_ms,
           bf16_peak_share=flops / k9a_ms * 1e3 / BF16_TENSOR_FLOPS,
           device_bf16_peak_share=flops / k9a_dev * 1e3 / BF16_TENSOR_FLOPS,
           library_with_moments_ms=cuda_ms(lib_moments),
           ms_conv3d_gn_residual_relu=cuda_ms(gn),
           device_ms_conv3d_gn_residual_relu=device_ms(gn),
           finish_device_ms=fin_dev,
           finish_bound_ms=fin_bytes / HBM_BYTES_PER_S * 1e3,
           ms_f32_16x40x96=cuda_ms(lambda: KC3.conv3d_stats(xf, w32, th)),
           codes=codes['conv3d_zpack'])
    del out, ps
    k9b_ms = cuda_ms(lambda: KC3.conv3d(x, w32))
    k9b_dev = device_ms(lambda: KC3.conv3d(x, w32))
    report('conv3d_pallas', 'dfm_tpu_torch/csrc/conv_dense.cuh (from '
           'conv3d.cu; the direct kernel of conv3d.cu for other routes)',
           'dfm_tpu/ops/pallas/conv3d.py:119',
           err['conv3d_pallas'], (1e-2, 1e-2), k9b_ms,
           plain_ms['conv3d_pallas'], lib_ms, vol_bytes, flops,
           peak=BF16_TENSOR_FLOPS, device_ms=k9b_dev,
           library_device_ms=lib_dev, ratio_to_conv3d=k9b_ms / lib_ms,
           bf16_peak_share=flops / k9b_ms * 1e3 / BF16_TENSOR_FLOPS,
           device_bf16_peak_share=flops / k9b_dev * 1e3 / BF16_TENSOR_FLOPS,
           ms_f32_16x40x96=cuda_ms(lambda: KC3.conv3d(xf, w32)),
           ms_f32_16x40x96_c16_to_8=cuda_ms(lambda: KC3.conv3d(cf, wf)),
           ms_bf16_16x40x96_c16_to_8=cuda_ms(lambda: KC3.conv3d(cb, wb)),
           codes=codes['conv3d_pallas'])

    # K9's path: the entry points a caller uses, at the DfM width
    torch.cuda.synchronize()
    K.reset_launch_counts()
    out, ps = G.conv3d_zpack(x, G.pack_weights(w32), th)
    y = G.conv3d_gn(x, w32, gamma, beta, 8, residual=x, relu=True, th=th)
    z = KC3.conv3d(x, w32)
    torch.cuda.synchronize()
    counts = dict(K.LAUNCHES)
    check(counts == K9_PATH, f'K9 path: launched {counts}, want {K9_PATH}')
    for t in (out, ps, y, z):
        check(bool(torch.isfinite(t).all()), 'K9 path: non-finite output')
    check(tuple(ps.shape) == (d // 4, h // th, 2, 4 * c)
          and y.shape == z.shape == out.shape == x.shape,
          f'K9 path: shapes {tuple(out.shape)} {tuple(ps.shape)}')
    print(f'K9 path (conv3d_zpack, conv3d_gn, conv3d at {tuple(x.shape)}): '
          f'launches {counts}', flush=True)
    return {k: counts[k] for k in OFF_PATH}


def _finite_dets(det, what):
    for k in ('boxes3d', 'scores'):
        check(bool(torch.isfinite(det[k]).all()), f'{what}: non-finite {k}')
    return int(det['mask'].sum())


def main_phase(cfg, dev):
    from dfm_tpu_torch.apis import init_dfm_model, init_dfm_stream
    from dfm_tpu_torch.models.detectors.dfm import dfm_predict
    from dfm_tpu_torch.ops.cuda import sampling as K
    h, w = IMG_HW
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        rng.randn(4, h, w, 3).astype(np.float32)).to(dev)
    meta = kitti_meta(1, dev)
    counts = {}

    def requests(handle, idx, what):
        """Two-frame requests on frames[i:i+2]; ms of each."""
        ms = []
        for i in idx:
            t0 = time.perf_counter()
            det = handle['infer'](frames[None, i:i + 2], meta)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            kept = _finite_dets(det, what)
        return ms, kept

    # the default form: bf16 on the card, banded + the full conv chain
    handle = init_dfm_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ms, kept = requests(handle, range(3), 'init_dfm_model')
    counts['model'] = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f'main init_dfm_model: ms/frame {[round(x, 3) for x in ms]} '
          f'kept {kept} peak_mem_bytes {peak} launches {counts["model"]}',
          flush=True)

    stream = init_dfm_stream(cfg)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    ms = []
    t0 = time.perf_counter()
    det, cache = stream['infer_first'](frames[None, 1:3], meta)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
    _finite_dets(det, 'infer_first')
    for i in (0, 3):
        t0 = time.perf_counter()
        det, cache = stream['infer_stream'](frames[None, i], meta, cache)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        _finite_dets(det, 'infer_stream')
    counts['stream'] = dict(K.LAUNCHES)
    print(f'main init_dfm_stream: ms/frame {[round(x, 3) for x in ms]} '
          f'launches {counts["stream"]}', flush=True)
    for path, c in counts.items():
        for name in MAIN_PATH:
            check(c[name] > 0, f'{name} never launched on the {path} path')
        check_launches(c, 'chain', 3, f'the {path} path')
    del stream, cache

    # the two earlier forms in the same run, for comparison, and the
    # default form once more after them (the first requests above also
    # pay the warm-up of cuDNN and of the allocator)
    for form in ('stem', 'dense'):
        other = init_dfm_model(cfg, **FORM_ARGS[form])
        requests(other, [0], f'{form} warm-up')
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        ms, _ = requests(other, (1, 2), f'{form} form')
        check_launches(K.LAUNCHES, form, 2, f'the {form} form')
        print(f'main {form} form ({FORM_ARGS[form]}): ms/frame '
              f'{[round(x, 3) for x in ms]} peak_mem_bytes '
              f'{torch.cuda.max_memory_allocated()}', flush=True)
        del other
    ms, _ = requests(handle, (1, 2), 'default form again')
    print(f'main default form again, after the other forms: ms/frame '
          f'{[round(x, 3) for x in ms]}', flush=True)
    del handle

    # decode + rotated NMS at the full head shape with live scores
    _, ny, nx = cfg.voxel_grid_size()
    g = torch.Generator(device=dev).manual_seed(1)
    heads = dict(cls_score=torch.randn(1, ny, nx, 18, generator=g,
                                       device=dev) * 1.5 - 2.0,
                 bbox_pred=torch.randn(1, ny, nx, 42, generator=g,
                                       device=dev) * 0.3,
                 dir_pred=torch.randn(1, ny, nx, 12, generator=g,
                                      device=dev))
    t0 = time.perf_counter()
    det = dfm_predict(heads, cfg)
    torch.cuda.synchronize()
    kept = _finite_dets(det, 'dfm_predict')
    check(kept > 0, 'dfm_predict kept no box of live scores')
    print(f'main dfm_predict full-shape heads: kept {kept} ms '
          f'{(time.perf_counter() - t0) * 1e3:.3f}', flush=True)
    return counts['model']


def _tiny_inputs():
    from dfm_tpu_torch.models.detectors.dfm import BatchMeta, DfMConfig
    cfg = DfMConfig(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5),
                    nms_pre=128, max_num=8)
    h, w = 64, 128
    img = torch.from_numpy(np.random.RandomState(2).randn(
        1, 2, h, w, 3).astype(np.float32))
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = 200.0
    cam[0, 2], cam[1, 2] = w / 2, h / 2
    meta = BatchMeta.identity(1, cam[None])
    meta.org_w = torch.full((1,), float(w))
    meta.cur2prev = meta.cur2prev.clone()
    meta.cur2prev[:, 2, 3] = 0.6
    return cfg, img, meta


OUT_KEYS = ('depth_cost', 'volume_feat', 'bev_feat', 'cls_score',
            'bbox_pred', 'dir_pred')


def parity_phase(full_cfg, dev):
    from dfm_tpu_torch.apis import init_dfm_model
    from dfm_tpu_torch.ops.cuda import sampling as K
    cfg, img, meta = _tiny_inputs()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        K.reset_launch_counts()
        for d in ('cpu', dev):
            model = init_dfm_model(cfg, torch.float32, d, use_band=False,
                                   packed=False)['model']
            with torch.inference_mode():
                outs[d] = model(img.to(d), meta.to(d))
        check_launches(K.LAUNCHES, 'dense', 1, 'f32 dense parity run')
        tol = 2e-3
        worst = 0.0
        for key in OUT_KEYS:
            a, b = outs['cpu'][key], outs[dev][key].cpu()
            err = float((a - b).abs().max())
            worst = max(worst, err)
            check(torch.allclose(a, b, atol=tol, rtol=tol),
                  f'CPU vs CUDA {key}: max abs err {err}')
        print(f'parity tiny f32 (TF32 off) dense form cpu vs cuda: max abs '
              f'err {worst:.3g} (tol atol {tol} + rtol {tol})', flush=True)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags

    # bf16 on the card: the default form (banded + the full conv chain, all
    # ten kernels) against the dense form and against the form with only
    # the stem and pred ConvNorm on the chain, same weights (seed 0) and
    # inputs. They compute the same function with bf16 roundings at other
    # places, so they are held together by the error's size against the
    # output's: ||a - b|| <= 0.05 ||b|| for every output (bf16 keeps 3
    # digits; dozens of layers lie between the trunks and the heads), and
    # for the trunk's own output, depth_cost, also elementwise within
    # atol 0.15 + rtol 0.15 (the JAX package's bf16 tolerance for it).
    # The tiny config's 12 depth planes have no reduced-depth plan, so
    # only the full-width run takes the mono trunk through the chain: the
    # launch counts show which form each run took.
    rng = np.random.RandomState(0)
    full_img = torch.from_numpy(rng.randn(1, 2, *IMG_HW, 3).astype(
        np.float32))
    for name, c, im, mt, chain_runs in (
            ('tiny', cfg, img, meta, 'chain, stereo trunk only'),
            ('full width', full_cfg, full_img, kitti_meta(1, dev), 'chain')):
        outs = {}
        for form, kw in FORM_ARGS.items():
            model = init_dfm_model(c, **kw)['model']
            K.reset_launch_counts()
            with torch.inference_mode():
                outs[form] = model(im.to(dev), mt.to(dev))
            check_launches(K.LAUNCHES, chain_runs if form == 'chain'
                           else form, 1, f'bf16 parity {name}, {form} form')
            del model
        for other in ('dense', 'stem'):
            worst = 0.0
            for key in OUT_KEYS:
                a, b = outs['chain'][key].float(), outs[other][key].float()
                check(bool(torch.isfinite(a).all()),
                      f'{name} {key} not finite')
                rel = float((a - b).norm() / b.norm().clamp(min=1e-6))
                worst = max(worst, rel)
                check(rel <= 0.05, f'bf16 default vs {other} form, {name} '
                      f'{key}: relative L2 error {rel}')
            a, b = (outs[f]['depth_cost'].float() for f in ('chain', other))
            err = float((a - b).abs().max())
            check(bool(((a - b).abs() <= 0.15 + 0.15 * b.abs()).all()),
                  f'bf16 default vs {other} form, {name} depth_cost: max '
                  f'abs err {err}')
            print(f'parity {name} bf16 on the card, default form vs {other} '
                  f'form: worst relative L2 error {worst:.3g} (tol 0.05), '
                  f'depth_cost max abs err {err:.3g} (tol atol 0.15 + rtol '
                  f'0.15)', flush=True)


EVAL_EXTRA_KEYS = ('lidar_model.backbone.compress_conv.conv.weight',
                   'backbone.bn1.num_batches_tracked')
AP_LINE = re.compile(r'^(Car|Pedestrian|Cyclist)_\w+: (\S+)$', re.M)


def _live_weights(model, seed, cls_bias):
    """Seeded noise (a CPU generator, so that every device gets the same
    values) on every tensor of `model` (5 % of its mean magnitude, at
    least 5e-4) and on every bias (std 0.1), and `cls_bias` added to the
    classification bias: detections that depend on the image and pass
    the score threshold (the CenterHead's heatmap bias likewise)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g) * 0.05 * float(
                t.float().abs().mean().clamp(min=0.01))
            if name.endswith('.bias'):
                noise += torch.randn(t.shape, generator=g) * 0.1
            if name.endswith(('conv_cls.bias', 'heatmap_final.bias')):
                noise += cls_bias
            t.add_(noise.to(t.device, t.dtype))
    return model


def _ref_checkpoint(cfg, path):
    """A model of `init_dfm_model(cfg)` with `_live_weights(seed 1, +3)`,
    saved as an mmcv checkpoint beside a DfMFull teacher key and a
    BatchNorm counter; returns its handle."""
    from dfm_tpu_torch.apis import init_dfm_model
    handle = init_dfm_model(cfg)
    _live_weights(handle['model'], 1, 3.0)
    sd = {k: v.cpu() for k, v in handle['model'].state_dict().items()}
    sd[EVAL_EXTRA_KEYS[0]] = torch.zeros(8, 4, 3, 3)
    sd[EVAL_EXTRA_KEYS[1]] = torch.tensor(7)
    torch.save({'meta': {'epoch': 60, 'CLASSES': ('Car', 'Pedestrian',
                                                  'Cyclist')},
                'state_dict': sd}, path)
    return handle


def _annos_agree(what, got, want, tol):
    """Annos of two runs: names and counts equal; scores within tol[0],
    location / dimensions / rotation_y / alpha within tol[1], 2D boxes
    within tol[2] px. Returns the live annos and the worst errors."""
    check(len(got) == len(want), f'{what}: {len(got)} vs {len(want)} frames')
    worst = dict(score=0.0, box=0.0, bbox=0.0)
    live = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(list(g['name']) == list(w['name']),
              f'{what}, frame {i}: names {list(g["name"])} vs '
              f'{list(w["name"])}')
        live += len(w['name'])
        if not len(w['name']):
            continue
        err = {k: float(np.abs(np.asarray(g[k], np.float64)
                               - np.asarray(w[k], np.float64)).max())
               for k in ('score', 'location', 'dimensions', 'rotation_y',
                         'alpha', 'bbox')}
        worst['score'] = max(worst['score'], err['score'])
        worst['box'] = max(worst['box'], err['location'], err['dimensions'],
                           err['rotation_y'], err['alpha'])
        worst['bbox'] = max(worst['bbox'], err['bbox'])
    for (k, v), t in zip(worst.items(), tol):
        check(v <= t, f'{what}: {k} max abs err {v} over {t}')
    return live, worst


def eval_phase(cfg, dev):
    """6. eval: a synthetic KITTI tree -> info pickle -> the CLI from a
    config and a checkpoint to AP; in process `dataset_inference` with
    its launches per frame, the checkpoint round trip, the GT echo, the
    card's annos against the CPU's, and the per-frame time split."""
    import os
    import tempfile
    from dfm_tpu_torch.apis import (dataset_inference, detect_sample,
                                    init_dfm_model)
    from dfm_tpu_torch.data import pipeline as PL
    from dfm_tpu_torch.data.kitti import KittiDataset
    from dfm_tpu_torch.data.png import read_png
    from dfm_tpu_torch.evaluation.kitti_eval import kitti_eval
    from dfm_tpu_torch.evaluation.results import detections_to_kitti_annos
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.ops.cuda import sampling as K
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    with tempfile.TemporaryDirectory() as root:
        ids = write_kitti_tree(root)
        first = os.path.join(root, 'training', 'image_2', '000000.png')
        png_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            img = read_png(first)
            png_ms.append((time.perf_counter() - t0) * 1e3)
        check(img is not None and img.shape == (375, 1242, 3),
              'read_png of a 375x1242 frame')
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
             'kitti', '--root', root, '--splits', 'val'], cwd=here, env=env,
            capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f'create_data failed: {res.stderr}')
        pkl = os.path.join(root, 'kitti_infos_val.pkl')
        ckpt = os.path.join(root, 'ref.pth')
        saved = _ref_checkpoint(cfg, ckpt)

        # (b) the CLI, from the config and the checkpoint to AP
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.test',
             os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py'),
             '--checkpoint', ckpt, '--cfg-options',
             f'data.data_root={root}'], cwd=here, env=env,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(res.returncode == 0, f'tools.test failed: {res.stderr[-3000:]}')
        aps = [float(m.group(2)) for m in AP_LINE.finditer(res.stdout)]
        check(len(aps) == 36 and all(np.isfinite(aps)),
              f'tools.test printed {len(aps)} AP lines: {res.stdout[-2000:]}')
        car = re.search(r'^Car_3d_moderate_strict: (\S+)$', res.stdout, re.M)
        print(f'eval cli: {len(ids)} frames, {len(aps)} finite AP lines, '
              f'Car_3d_moderate_strict {car.group(1)}, {cli_s:.1f} s in its '
              'own process', flush=True)

        # (c) in process: the default form from the checkpoint, launches
        ds = KittiDataset(root, pkl, train=False, pipeline_kwargs=dict(
            crop_size=IMG_HW, max_gt=32))
        handle = init_dfm_model(cfg)
        rest = handle['load_checkpoint'](ckpt)
        check(rest == sorted(EVAL_EXTRA_KEYS), f'keys not taken: {rest}')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        annos = dataset_inference(handle, ds)
        torch.cuda.synchronize()
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(counts, 'chain', len(ids), 'dataset_inference')
        live = sum(len(a['name']) for a in annos)
        check(live > 0, 'dataset_inference: no live box from the checkpoint')
        print(f'eval dataset_inference: {len(annos)} frames, {live} annos, '
              f'peak_mem_bytes {peak}, launches per frame '
              f'{ {k: n / len(ids) for k, n in counts.items() if n} }',
              flush=True)

        # the checkpoint round trip: the loaded model's detections are the
        # saved model's, bit for bit (cuDNN deterministic for both runs)
        sample = ds.get_sample(0, np.random.default_rng(0))
        det_flag = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            a, b = detect_sample(saved, sample), detect_sample(handle, sample)
        finally:
            torch.backends.cudnn.deterministic = det_flag
        check(all(np.array_equal(a[k], b[k]) for k in a) and a.keys() ==
              b.keys(), 'the checkpoint round trip changed the detections')
        check(int(a['mask'].sum()) > 0, 'round trip: no live detection')
        del saved

        # the GT echo: the labels' own boxes through converter + evaluator
        echo = []
        for info in ds.infos:
            gt = info['annos']
            n = len(gt['labels'])
            echo.append(detections_to_kitti_annos(
                dict(boxes3d=gt['gt_boxes_pl'], labels=gt['labels'],
                     scores=np.full(n, 0.9, np.float32),
                     mask=np.ones(n, bool)),
                np.asarray(info['calib']['P2'])[:3], (375, 1242)))
        ap = kitti_eval(ds.gt_annos(), echo)['Car_3d_easy_strict']
        check(ap > 99, f'GT echo: Car 3d easy AP {ap}')
        print(f'eval gt echo: Car_3d_easy_strict {ap:.4f} (> 99)', flush=True)

        # (d) the per-frame split: decode, pipeline, model (synchronised),
        # annos; then kitti_eval on the frames' annos
        decode = [0.0]

        def timed_read(path):
            t = time.perf_counter()
            try:
                return read_png(path)
            finally:
                decode[0] += time.perf_counter() - t

        split = []
        rng = np.random.default_rng(0)
        PL.read_png = timed_read
        try:
            for i in range(len(ds)):
                decode[0] = 0.0
                t0 = time.perf_counter()
                s = ds.get_sample(i, rng)
                t1 = time.perf_counter()
                det = detect_sample(handle, s)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                annos[i] = detections_to_kitti_annos(
                    det, np.asarray(ds.infos[i]['calib']['P2'])[:3],
                    (375, 1242))
                t3 = time.perf_counter()
                split.append((decode[0], t1 - t0 - decode[0], t2 - t1,
                              t3 - t2))
        finally:
            PL.read_png = read_png
        t0 = time.perf_counter()
        kitti_eval(ds.gt_annos(), annos)
        eval_ms = (time.perf_counter() - t0) * 1e3
        ms = np.asarray(split) * 1e3
        print('eval per frame ms (decode, pipeline, model, annos): '
              + ' | '.join(', '.join(f'{x:.3f}' for x in row) for row in ms)
              + f'; mean {", ".join(f"{x:.3f}" for x in ms.mean(0))}; '
              f'kitti_eval {eval_ms:.3f} ms for {len(ds)} frames; png '
              f'decode of one 375x1242 frame {min(png_ms):.3f} ms (best of '
              f'3); peak_mem_bytes {peak}', flush=True)
        del handle

        # the card's annos against the CPU's plain versions: tiny config,
        # float32, TF32 off, the same live weights on both sides, a crop
        # of 192 x 384 that holds the horizon and the objects
        tiny = DfMConfig(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5),
                         nms_pre=128, max_num=8)
        small = KittiDataset(root, pkl, train=False,
                             pipeline_kwargs=dict(crop_size=(192, 384)))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            outs = {}
            for d in ('cpu', dev):
                h = init_dfm_model(tiny, torch.float32, d)
                _live_weights(h['model'], 2, 4.0)
                outs[d] = dataset_inference(h, small)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        tol = (1e-3, 2e-3, 0.1)
        live, worst = _annos_agree('tiny f32 annos, card vs CPU',
                                   outs[dev], outs['cpu'], tol)
        check(live > 0, 'tiny f32 annos: no live box')
        check(len({tuple(np.round(a['score'], 5)) for a in outs['cpu']}) > 1,
              'tiny f32 annos: the same in every frame')
        print(f'eval tiny f32 annos card vs cpu: {live} annos, names equal, '
              f'max abs err score {worst["score"]:.3g} box '
              f'{worst["box"]:.3g} bbox {worst["bbox"]:.3g} px (tol score '
              f'{tol[0]}, box {tol[1]}, bbox {tol[2]} px)', flush=True)
    return counts


def _rel_l2(got, want):
    """Relative L2 distance of each parameter's gradient and of the whole
    gradient (name -> tensor of both, want's names)."""
    rel, num, den = {}, 0.0, 0.0
    for n, w in want.items():
        d = float((got[n].cpu().double() - w.double()).norm())
        nw = float(w.double().norm())
        rel[n] = d / nw if nw > 0 else d
        num += d * d
        den += nw * nw
    return rel, (num / den) ** 0.5


def _grad_compare(what, got, want, noisy):
    """Gradients of the card against the CPU's (name -> tensor or None),
    held to the CPU's own rounding: `noisy` are the CPU's gradients with
    one ulp of seeded relative noise on every weight (or a tuple of such
    runs, each parameter's movement the largest of theirs). Every
    parameter with a nonzero CPU gradient has a nonzero card one; each
    parameter's relative L2 is within max(TRAIN_GRAD_FLOOR,
    TRAIN_GRAD_FACTOR x that parameter's under the noise), the whole
    gradient's likewise. Returns (worst relative L2, its parameter,
    whole, whole under the noise)."""
    missing = [n for n, w in want.items() if w is not None and
               bool(w.abs().sum() > 0) and (got[n] is None or
                                            not bool(got[n].abs().sum() > 0))]
    check(not missing, f'{what}: no gradient on the card for {missing}')
    for n, w in want.items():
        if w is None:
            check(got[n] is None or not bool(got[n].abs().sum() > 0),
                  f'{what}: {n} has a card gradient and no CPU one')
    want = {n: w for n, w in want.items() if w is not None}
    rel, whole = _rel_l2(got, want)
    runs = [_rel_l2(x, want) for x in (
        noisy if isinstance(noisy, tuple) else (noisy,))]
    noise = {n: max(r[0][n] for r in runs) for n in want}
    whole_noise = max(r[1] for r in runs)
    bad = {n: (r, noise[n]) for n, r in rel.items()
           if r > max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR * noise[n])}
    check(not bad, f'{what}: gradients off beyond the rounding noise '
          f'(relative L2, noise): {bad}')
    check(whole <= max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR * whole_noise),
          f'{what}: whole gradient relative L2 {whole}, under one ulp of '
          f'weight noise {whole_noise}')
    worst = max(rel, key=rel.get)
    return rel[worst], worst, whole, whole_noise


# phase 7 (a): the card's float32 gradients against the CPU's at the tiny
# config, TF32 off. The float32 gradients of the 2D trunk and the depth
# predictors are ill-conditioned at this size (BatchNorm and GroupNorm
# statistics over a few pixels): one ulp of relative noise on the
# weights moves the CPU's own gradient of some parameters by 2e-2 and the
# whole gradient by 1e-2 (relative L2). So each gradient is held to
# TRAIN_GRAD_FACTOR times its own movement under that noise (measured in
# the run, on the CPU), and at least to TRAIN_GRAD_FLOOR
TRAIN_GRAD_FACTOR = 3.0
TRAIN_GRAD_FLOOR = 1e-3
TRAIN_LOSS_RTOL = 1e-3
TRAIN_TINY = dict(depth_num_bins=48, voxel_size=(3.6, 3.8, 0.5), nms_pre=128,
                  max_num=8, num_depth_sample_pixels=2048)
TRAIN_TINY_CROP = (192, 384)
# phase 7 (b): the backward kernels against torch.autograd.grad of the
# plain forwards; the kernels sum each gradient in another order (float32)
BWD_TOL = (1e-3, 1e-4)
TRAIN_TIMED_STEPS = 3         # phase 7 (d)
def _in_background(jobs):
    """Run the (name, fn) jobs in threads; returns a join function that
    waits for them and raises the first job's error again."""
    import threading
    errors, threads = {}, []

    def wrap(name, fn):
        try:
            fn()
        except Exception as e:        # raised again by join
            errors[name] = e

    for name, fn in jobs:
        threads.append(threading.Thread(target=wrap, args=(name, fn)))
        threads[-1].start()

    def join():
        for t in threads:
            t.join()
        for e in errors.values():
            raise e
    return join


def _train_cli(root, config, here, env):
    """Phase 7 (c): the train CLI at full width in processes of its own: 4
    steps (one epoch of the 4 frames: a checkpoint and the KITTI eval), a
    resume to 6, the eval CLI on the last checkpoint, and a type the port
    does not train refused."""
    import os
    from dfm_tpu_torch.tools.train import optimizer_digest
    work = os.path.join(root, 'w')
    base = [sys.executable, '-m', 'dfm_tpu_torch.tools.train', config,
            '--cfg-options', 'model.type=DfM', f'data.data_root={root}',
            '--work-dir', work]
    t0 = time.perf_counter()
    res = subprocess.run(base + ['--max-steps', '4'], cwd=here, env=env,
                         capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f'tools.train failed: {res.stderr[-3000:]}')
    with open(os.path.join(work, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    keys = ('loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
            'loss_dense_depth', 'grad_norm')
    check([r['step'] for r in recs] == [1, 4], f'logged steps '
          f'{[r["step"] for r in recs]}')
    check(all(np.isfinite(r[f'train/{k}']) for r in recs for k in keys),
          f'tools.train logged a non-finite term: {recs}')
    evals = re.findall(r'^\[eval\] (\S+): (\S+)$', res.stdout, re.M)
    check(len(evals) == 6 and all(np.isfinite(float(x)) for _, x in
                                 evals), f'tools.train eval: {evals}')
    ckpt4 = os.path.join(work, 'ckpts', 'step_4.pth')
    digest = optimizer_digest(torch.load(
        ckpt4, map_location='cpu', weights_only=True)['optimizer'])
    print(f'train (c) cli: 4 steps at full width in {cli_s:.1f} s in its '
          f'own process; logged '
          + '; '.join(f'step {r["step"]} ' + ', '.join(
              f'{k} {r[f"train/{k}"]:.5g}' for k in keys) for r in recs)
          + f'; eval {len(evals)} finite 3d-moderate APs', flush=True)
    res = subprocess.run(base + ['--max-steps', '6', '--auto-resume'],
                         cwd=here, env=env, capture_output=True,
                         text=True, timeout=900)
    check(res.returncode == 0, f'tools.train --auto-resume failed: '
          f'{res.stderr[-3000:]}')
    check(f'resumed from step 4 (optimizer state sha1 {digest})'
          in res.stdout, f'resume: {res.stdout[-2000:]}')
    with open(os.path.join(work, 'metrics.jsonl')) as f:
        logged = [json.loads(line)['step'] for line in f]
    check(logged == [1, 4, 6] and re.search(r'^step 6/6 ', res.stdout,
                                            re.M) is not None,
          f'resume did not end at step 6: logged {logged}')
    last = os.path.join(work, 'ckpts', 'step_6.pth')
    check(os.path.exists(last), 'no checkpoint at step 6')
    res = subprocess.run(
        [sys.executable, '-m', 'dfm_tpu_torch.tools.test', config,
         '--checkpoint', last, '--cfg-options',
         f'data.data_root={root}'], cwd=here, env=env,
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f'tools.test of the trained checkpoint '
          f'failed: {res.stderr[-3000:]}')
    aps = [float(m.group(2)) for m in AP_LINE.finditer(res.stdout)]
    check(len(aps) == 36 and all(np.isfinite(aps)),
          f'tools.test printed {len(aps)} AP lines')
    res = subprocess.run(
        [sys.executable, '-m', 'dfm_tpu_torch.tools.train', config,
         '--cfg-options', 'model.type=EncoderDecoder3D',
         f'data.data_root={root}', '--work-dir',
         os.path.join(root, 'mono')], cwd=here, env=env,
        capture_output=True, text=True, timeout=300)
    check(res.returncode == 2 and 'not ported yet' in res.stderr,
          f'the EncoderDecoder3D type: rc {res.returncode} '
          f'{res.stderr[-500:]}')
    print(f'train (c) resume: from step 4 with the saved optimizer '
          f'state (sha1 {digest}) to step 6; tools.test on step_6.pth: '
          f'{len(aps)} finite AP lines; EncoderDecoder3D refused (rc '
          f'{res.returncode})', flush=True)


def _full_cli(root, here, env):
    """Phase 8 (c): the train CLI on the flagship config (DfMFull) with
    --synthetic and a teacher file in flax's msgpack format: 2 steps, a
    resume to 3, then tools.test on the checkpoint over the KITTI tree."""
    import os
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.models.detectors.teacher import LidarTeacher
    from dfm_tpu_torch.tools.train import optimizer_digest
    from dfm_tpu_torch.utils.msgpack_tree import (load_msgpack_tree,
                                                  msgpack_dumps)
    from dfm_tpu_torch.utils.weights import teacher_state_dict
    full = DfMConfig()
    config = os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py')
    teacher = os.path.join(root, 'teacher.msgpack')
    tree = teacher_tree(LidarTeacher(
        full.point_cloud_range, full.voxel_size,
        volume_channels=full.cv_channels, bev_channels=full.bev_channels), 7)
    with open(teacher, 'wb') as f:
        f.write(msgpack_dumps(tree))
    work = os.path.join(root, 'full')
    base = [sys.executable, '-m', 'dfm_tpu_torch.tools.train', config,
            '--synthetic', '--work-dir', work, '--cfg-options',
            f'model.teacher_checkpoint={teacher}']
    t0 = time.perf_counter()
    res = subprocess.run(base + ['--max-steps', '2'], cwd=here, env=env,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(res.returncode == 0, f'DfMFull tools.train failed: '
          f'{res.stderr[-3000:]}')
    check(f'[teacher] restored from {teacher}' in res.stdout,
          f'no teacher restored: {res.stdout[-2000:]}')
    with open(os.path.join(work, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    keys = ('loss', 'loss_cls', 'loss_bbox', 'loss_dir', 'loss_iou',
            'loss_dense_depth', 'loss_cls2d', 'loss_bbox2d',
            'loss_centerness2d', 'loss_imitation', 'grad_norm')
    check([r['step'] for r in recs] == [1, 2] and all(
        np.isfinite(r.get(f'train/{k}', np.nan)) for r in recs for k in keys),
        f'DfMFull tools.train logged {recs}')
    ckpt2 = os.path.join(work, 'ckpts', 'step_2.pth')
    digest = optimizer_digest(torch.load(
        ckpt2, map_location='cpu', weights_only=True)['optimizer'])
    t0 = time.perf_counter()
    res = subprocess.run(base + ['--max-steps', '3', '--auto-resume'],
                         cwd=here, env=env, capture_output=True, text=True,
                         timeout=600)
    resume_s = time.perf_counter() - t0
    check(res.returncode == 0 and f'resumed from step 2 (optimizer state '
          f'sha1 {digest})' in res.stdout, f'DfMFull resume: rc '
          f'{res.returncode} {res.stdout[-2000:]} {res.stderr[-2000:]}')
    last = os.path.join(work, 'ckpts', 'step_3.pth')
    saved = torch.load(last, map_location='cpu', weights_only=True)
    want = teacher_state_dict(load_msgpack_tree(teacher))
    params = [k for k in want if not k.endswith(('running_mean',
                                                 'running_var'))]
    check(all(torch.equal(saved['state_dict'][f'lidar_teacher.{k}'],
                          want[k]) for k in params),
          "the teacher's parameters in step_3.pth differ from the file's")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, '-m', 'dfm_tpu_torch.tools.test', config,
         '--checkpoint', last, '--cfg-options', f'data.data_root={root}'],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    test_s = time.perf_counter() - t0
    check(res.returncode == 0, f'tools.test of the DfMFull checkpoint '
          f'failed: {res.stderr[-3000:]}')
    aps = [float(m.group(2)) for m in AP_LINE.finditer(res.stdout)]
    check(len(aps) == 36 and all(np.isfinite(aps)),
          f'tools.test printed {len(aps)} AP lines')
    print(f'full (c) cli: DfMFull on configs/dfm_r34_kitti_3class.py '
          f'--synthetic, 2 steps in {cli_s:.1f} s in its own process, the '
          f'teacher restored from a flax msgpack file ({len(params)} '
          f'parameters, equal in step_3.pth); logged '
          + '; '.join(f'step {r["step"]} ' + ', '.join(
              f'{k} {r[f"train/{k}"]:.5g}' for k in keys) for r in recs)
          + f'; resume from step 2 (sha1 {digest}) to 3 in {resume_s:.1f} s; '
          f'tools.test on step_3.pth: {len(aps)} finite AP lines in '
          f'{test_s:.1f} s', flush=True)


def train_phase(cfg, dev, results):
    """7. train: (a) the card's gradients against the CPU's, (b) the
    backward kernels against their plain versions at full width, (c)
    the train CLI at full width with a resume and an eval of its
    checkpoint (`_train_cli`), (d) one full-width step in process with
    its launches, time split and peak memory, (e) an overfit of one frame;
    then phase 8 (`full_train_phase`) on the same KITTI tree. The CLIs of
    (c) and of phase 8 (c) run in processes of their own beside (a) and
    (e), and are joined before (b), the first timed section."""
    import os
    import tempfile
    import torch.nn.functional as F
    from dfm_tpu_torch.data.collate import build_batch
    from dfm_tpu_torch.data.kitti import KittiDataset, build_kitti_infos
    from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
    from dfm_tpu_torch.models.heads.depth_head import sample_depth_pixels
    from dfm_tpu_torch.ops import cost_volume as CV
    from dfm_tpu_torch.ops import frustum_separable as FS
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.schedule import liga_schedule, step_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    config = os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py')
    agree, report = reporter(results)
    with tempfile.TemporaryDirectory() as root:
        ids = write_kitti_tree(root)
        infos = build_kitti_infos(root, ids)
        res = subprocess.run(
            [sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
             'kitti', '--root', root, '--splits', 'train', 'val'], cwd=here,
            env=env, capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f'create_data failed: {res.stderr}')
        # (c) and phase 8 (c): the CLIs in processes of their own, beside
        # (a) and (e), joined before anything is timed
        join_cli = _in_background([
            ('train (c)', lambda: _train_cli(root, config, here, env)),
            ('full (c)', lambda: _full_cli(root, here, env))])

        # (a) gradients, card against CPU: the same live weights, one
        # training sample (flip, scale, photometric) and the same depth
        # pixels on both
        tiny = DfMConfig(**TRAIN_TINY)
        ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
            crop_size=TRAIN_TINY_CROP, flip_ratio=0.5, max_gt=32))
        sample = ds.get_sample(0, np.random.default_rng(3))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            side = {}
            pix = None
            for d, noise in (('cpu', False), ('cpu', True), (dev, False)):
                model = _live_weights(init_weights(DfM(tiny)), 4, 0.0)
                if noise:         # one ulp of relative noise, seeded
                    g = torch.Generator().manual_seed(1)
                    with torch.no_grad():
                        for p in model.parameters():
                            p.mul_(1 + 1.2e-7 * torch.randn(p.shape,
                                                            generator=g))
                model = model.to(d)
                img, meta, gt = build_batch([sample], d)
                if pix is None:
                    pix = sample_depth_pixels(
                        gt['depth_img'], tiny.num_depth_sample_pixels,
                        torch.Generator().manual_seed(0))
                step = TrainStep(model, make_optimizer(model),
                                 liga_schedule(1e-3))
                K.reset_launch_counts()
                total, losses = step.forward(img, meta, gt,
                                             depth_pix_idx=pix.to(d))
                step.backward(total)
                if d != 'cpu':
                    torch.cuda.synchronize()
                side['cpu, ulp noise' if noise else d] = dict(
                    losses={k: float(v.detach()) for k, v in
                            dict(loss=total, **losses).items()},
                    grads={n: (None if p.grad is None else
                               p.grad.detach().cpu())
                           for n, p in model.named_parameters()},
                    launches=dict(K.LAUNCHES))
                del model, step, total, losses
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        for k, want in side['cpu']['losses'].items():
            got = side[dev]['losses'][k]
            check(np.isfinite(got) and abs(got - want) <= TRAIN_LOSS_RTOL * (
                abs(want) + 1e-6), f'train tiny {k}: card {got} vs cpu {want}')
        worst, name, whole, whole_noise = _grad_compare(
            'train tiny', side[dev]['grads'], side['cpu']['grads'],
            side['cpu, ulp noise']['grads'])
        check_launches(side[dev]['launches'], 'train', 1, 'train tiny step')
        print(f'train (a) tiny f32 card vs cpu: losses '
              f'{ {k: round(v, 6) for k, v in side[dev]["losses"].items()} } '
              f'(cpu { {k: round(v, 6) for k, v in side["cpu"]["losses"].items()} }, '
              f'rtol {TRAIN_LOSS_RTOL}); gradients of '
              f'{len(side["cpu"]["grads"])} parameters, worst relative L2 '
              f'{worst:.3g} ({name}), whole {whole:.3g}; under one ulp of '
              f'weight noise the CPU\'s whole gradient moves {whole_noise:.3g} '
              f'(tol {TRAIN_GRAD_FACTOR} x each parameter\'s movement, at '
              f'least {TRAIN_GRAD_FLOOR}); none missing; launches '
              f'{ {k: n for k, n in side[dev]["launches"].items() if n} }',
              flush=True)
        del side

        # (e) overfit one frame at the tiny config: no flip, scale or
        # photometric distortion (the evaluation pipeline), 30 steps at a
        # constant lr 1e-3
        frame = KittiDataset(root, infos, train=False, pipeline_kwargs=dict(
            crop_size=TRAIN_TINY_CROP, max_gt=32)).get_sample(
                0, np.random.default_rng(0))
        model = init_weights(DfM(tiny)).to(dev)
        step = TrainStep(model, make_optimizer(model), step_schedule(1e-3))
        img, meta, gt = build_batch([frame], dev)
        curve = []
        for i in range(30):
            m = step(img, meta, gt,
                     torch.Generator(device=dev).manual_seed(i))
            curve.append(float(m['loss']))
        first, last = float(np.mean(curve[:5])), float(np.mean(curve[-5:]))
        check(np.isfinite(curve).all() and last < first,
              f'overfit: mean loss of the last 5 steps {last} not below the '
              f'first 5 {first}: {curve}')
        print(f'train (e) overfit one frame, tiny, 30 steps at lr 1e-3: mean '
              f'loss first 5 {first:.5f}, last 5 {last:.5f}', flush=True)
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
        join_cli()

        # (b) the backward kernels at the full-width training shapes
        # (float32): K1's gradient of prev, K2's of vol and sem
        gen = torch.Generator(device=dev).manual_seed(5)
        h, w = IMG_HW
        meta = kitti_meta(1, dev)
        depths = torch.as_tensor(cfg.downsampled_depths(), device=dev)
        d = len(depths)
        step_px = cfg.cost_sample_factor
        hq, wq = h // step_px, w // step_px
        c = cfg.stereo_channels[1]
        params = CV.sweep_params(meta.ori_cam2img, meta.cur2prev, meta.org_w,
                                 meta.flip, meta.crop_offset,
                                 meta.scale_factor, 1)
        prev_shape = (1, h, w, c)
        gout1 = torch.randn(1, d, hq, wq, c, generator=gen, device=dev)
        bwd1 = lambda: K.warp_prev_sweep_bwd(  # noqa: E731
            gout1, params, depths, prev_shape, step_px)
        plain1 = lambda: K.warp_prev_sweep_bwd_plain(  # noqa: E731
            gout1, params, depths, prev_shape, step_px)
        got, want = bwd1(), plain1()
        check(bool((want != 0).any()), 'warp_prev_bwd: the gradient is zero')
        err1 = agree('warp_prev_sweep_bwd', got, want, BWD_TOL)
        check(torch.equal(got, bwd1()), 'warp_prev_bwd: two calls differ '
              '(the gather has no atomics)')
        _, grid = CV.plane_sweep_grids(
            depths, meta.ori_cam2img, meta.cur2prev, (h, w), step_px, 1,
            meta.org_w, meta.flip, meta.crop_offset, meta.scale_factor)
        norm = torch.stack([grid[..., 0] / (w - 1) * 2 - 1,
                            grid[..., 1] / (h - 1) * 2 - 1],
                           -1).reshape(1, d * hq, wq, 2)
        lib_in = torch.zeros(1, c, h, w, device=dev, requires_grad=True)
        lib_out = F.grid_sample(lib_in, norm, align_corners=True)
        lib_g = torch.randn(lib_out.shape, generator=gen, device=dev)
        lib1 = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_in, lib_g, retain_graph=True)
        # device time against the depths: the first quarter and half of
        # them, and all
        by_depths = {}
        for nd in (d // 4, d // 2, d):
            part = gout1[:, :nd].contiguous()
            by_depths[nd] = span_ms(lambda: K.warp_prev_sweep_bwd(
                part, params, depths[:nd], prev_shape, step_px))
        del part
        report('warp_prev_bwd', 'dfm_tpu_torch/csrc/warp_prev.cu',
               'dfm_tpu/ops/pallas/cost_warp.py:142', err1, BWD_TOL, cuda_ms(bwd1), cuda_ms(plain1, reps=5),
               cuda_ms(lib1), (gout1.numel() + got.numel()) * 4
               + params.numel() * 4 + d * 4, 8 * gout1.numel(),
               device_ms=by_depths[d], device_ms_by_depths=by_depths,
               library_device_ms=span_ms(lib1),
               note='backward of K1 (JAX: XLA autodiff of its f32 path); '
                    'device ms: span_ms')
        del got, want, lib_in, lib_out, lib_g, norm, grid, gout1

        coors = cfg.coordinates_3d()
        xs, ys, zs = coors[0, 0, :, 0], coors[0, :, 0, 1], coors[:, 0, 0, 2]
        u, v = FS.slab_uv(meta.cam2img, xs, ys, zs)
        nz, ny, nx = cfg.voxel_grid_size()
        cost = torch.randn(1, d, hq, wq, generator=gen, device=dev)
        df = d * cfg.depth_downsample
        sm = FS.build_fine_softmax_volume(cost, cfg.depth_downsample, IMG_HW,
                                          torch.float32)
        dsf = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, df)
        att = K.attention_sample(sm, u, v, dsf, IMG_HW)
        del sm
        ds2 = FS.slab_depth_static(xs, cfg.depth_min, cfg.depth_max, d)
        cs = cfg.sem_channels[1]
        vol_shape = (1, d, hq, wq, c)
        sem_shape = (1, hq, wq, cs)
        gout2 = torch.randn(1, nz, ny, nx, c + cs, generator=gen, device=dev)
        bwd2 = lambda: K.frustum_voxel_features_bwd(  # noqa: E731
            gout2, att, u, v, ds2, IMG_HW, vol_shape, sem_shape)
        plain2 = lambda: K.frustum_voxel_features_bwd_plain(  # noqa: E731
            gout2, att, u, v, ds2, IMG_HW, vol_shape, sem_shape)
        (gv, gs), (wv, ws) = bwd2(), plain2()
        check(bool((wv != 0).any()) and bool((ws != 0).any()),
              'frustum_voxel_features_bwd: a gradient is zero')
        err_vol = agree('frustum_voxel_features_bwd vol', gv, wv, BWD_TOL)
        err_sem = agree('frustum_voxel_features_bwd sem', gs, ws, BWD_TOL)
        check(all(torch.equal(a, b) for a, b in zip((gv, gs), bwd2())),
              'frustum_stereo_sample_bwd: two calls differ (the gather has '
              'no atomics)')
        # the device split: each half's tiles alone, the other map given
        # no rows (sem (1, 0, wq, cs): stereo tiles only; vol
        # (1, d, 0, wq, c): sem tiles only)
        split = dict(
            stereo_device_ms=span_ms(lambda: K.frustum_voxel_features_bwd(
                gout2, att, u, v, ds2, IMG_HW, vol_shape, (1, 0, wq, cs))),
            sem_device_ms=span_ms(lambda: K.frustum_voxel_features_bwd(
                gout2, att, u, v, ds2, IMG_HW, (1, d, 0, wq, c), sem_shape)))
        zi = (torch.as_tensor(xs, device=dev) - cfg.depth_min) / (
            cfg.depth_max - cfg.depth_min) * (d - 1)
        gx = (u / (w - 1) * (wq - 1)).transpose(1, 2)[:, None]
        gy = (v / (h - 1) * (hq - 1)).transpose(1, 2)[:, :, None]
        g3 = torch.stack(torch.broadcast_tensors(
            gx / (wq - 1) * 2 - 1, gy / (hq - 1) * 2 - 1,
            (zi / (d - 1) * 2 - 1).view(1, 1, 1, -1)), -1).reshape(
                1, nz, ny, nx, 3)
        lib_in = torch.zeros(1, c, d, hq, wq, device=dev, requires_grad=True)
        lib_out = F.grid_sample(lib_in, g3, align_corners=True)
        lib_g = torch.randn(lib_out.shape, generator=gen, device=dev)
        lib2 = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_in, lib_g, retain_graph=True)
        report('frustum_stereo_sample_bwd',
               'dfm_tpu_torch/csrc/frustum_sample.cu',
               'dfm_tpu/ops/pallas/frustum_sample.py:92',
               max(err_vol, err_sem), BWD_TOL, cuda_ms(bwd2),
               cuda_ms(plain2, reps=5), cuda_ms(lib2),
               (gout2.numel() + att.numel() + u.numel() + v.numel()
                + gv.numel() + gs.numel()) * 4,
               2 * 8 * gout2[..., :c].numel() + 3 * 4 * gout2[..., c:].numel(),
               max_abs_err_vol=err_vol, max_abs_err_sem=err_sem,
               device_ms=span_ms(bwd2), **split,
               library_device_ms=span_ms(lib2),
               note='backward of K2 (JAX: XLA autodiff of its f32 path); '
                    'device ms: span_ms')
        del gv, gs, wv, ws, lib_in, lib_out, lib_g, g3, gout2, att, cost
        gc.collect()
        torch.cuda.empty_cache()

        # (d) full-width training steps in process: two warm-up steps
        # (cuDNN's and the allocator's first calls), then three steps
        # with the launch counts set to 0 just before and read just
        # after, each split into data, forward, backward and optimizer
        full = DfMConfig()
        model = init_weights(DfM(full)).to(dev)
        step = TrainStep(model, make_optimizer(model), liga_schedule(1e-3))
        train_ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
            crop_size=IMG_HW, flip_ratio=0.5, max_gt=32))
        rng = np.random.default_rng(0)
        for i in range(2):
            img, meta, gt = build_batch([train_ds.get_sample(i, rng)], dev)
            step(img, meta, gt, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        splits = []
        for i in range(TRAIN_TIMED_STEPS):
            t0 = time.perf_counter()
            img, meta, gt = build_batch(
                [train_ds.get_sample((i + 2) % len(ids), rng)], dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            total, losses = step.forward(
                img, meta, gt, torch.Generator(device=dev).manual_seed(i))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            step.backward(total)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            norm = step.update()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            splits.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                           (t4 - t3) * 1e3])
            vals = {k: float(v.detach())
                    for k, v in dict(loss=total, **losses).items()}
            check(all(np.isfinite(x) for x in vals.values())
                  and np.isfinite(float(norm)), f'full-width step: {vals}')
        counts = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check_launches(counts, 'train', TRAIN_TIMED_STEPS,
                       'the full-width train steps')
        for name in TRAIN_PATH:
            check(counts[name] > 0, f'{name} never launched in the steps')
        for name in BWD_KERNELS:
            results[name]['launches'] = counts[name] // TRAIN_TIMED_STEPS
        med = np.median(np.asarray(splits), axis=0)
        print(f'train (d) full-width steps, f32, B = 1, after 2 warm-up '
              f'steps, ms (data, forward, backward, optimizer): '
              + ' | '.join(', '.join(f'{x:.3f}' for x in row)
                           for row in splits)
              + f'; median {", ".join(f"{x:.3f}" for x in med)}, total '
              f'{float(np.median(np.sum(splits, 1))):.3f}; peak_mem_bytes '
              f'{peak}; last losses { {k: round(x, 5) for k, x in vals.items()} }'
              f' grad_norm {float(norm):.5g}; launches per step '
              f'{ {k: n // TRAIN_TIMED_STEPS for k, n in counts.items() if n} }',
              flush=True)
        del model, step, total, losses, img, meta, gt
        gc.collect()
        torch.cuda.empty_cache()

        # phase 8 trains DfMFull on this tree, beside (d)'s median split
        full_train_phase(cfg, dev, root, ids, infos, med)


# phase 8: teacher points of a full-width sample, about as many as a KITTI
# scan has in the camera's view; the tiny config's
FULL_POINTS = 16384
TINY_POINTS = 4096


def full_targets(sample, cfg, rng, n_points):
    """Add DfMFull's batch keys to a pipeline sample: `n_points` teacher
    points uniform in the point-cloud range (as `_dfm_synth`), and 2D
    targets from the sample's own gt boxes: the extent of the projected
    corners clipped to the image and, as `centers2d`, the projected 3D
    centre (the reference's append_3d_centers); padded gt rows get
    zeros."""
    from dfm_tpu_torch.evaluation.results import (_corners_cam,
                                                  pseudo_lidar_boxes_to_cam)
    pcr = np.asarray(cfg.point_cloud_range)
    sample['points'] = (rng.random((n_points, 3)) * (pcr[3:] - pcr[:3])
                        + pcr[:3]).astype(np.float32)
    sample['point_mask'] = np.ones(n_points, bool)
    boxes, mask = sample['gt_boxes'], sample['gt_mask']
    k = np.asarray(sample['cam2img'], np.float64)
    h, w = sample['img'].shape[1:3]

    def project(p):                                     # (..., 3) -> (..., 2)
        uvw = p @ k[:3, :3].T + k[:3, 3]
        return uvw[..., :2] / uvw[..., 2:3]

    loc, dims, ry = pseudo_lidar_boxes_to_cam(boxes.astype(np.float64))
    uv = project(_corners_cam(loc, dims, ry))              # (G, 8, 2)
    box2d = np.concatenate([uv.min(1), uv.max(1)], -1)
    box2d = np.clip(box2d, 0, [w - 1, h - 1, w - 1, h - 1])
    centre = loc - np.stack([np.zeros_like(ry), dims[:, 1] / 2,
                             np.zeros_like(ry)], 1)     # bottom -> gravity
    m = mask[:, None]
    sample['gt_bboxes2d'] = np.where(m, box2d, 0).astype(np.float32)
    sample['centers2d'] = np.where(m, project(centre), 0).astype(np.float32)
    return sample


def full_train_phase(cfg, dev, root, ids, infos, bare_med):
    """8. DfMFull training: (a) the card's losses and gradients against
    the CPU's, the teacher frozen, (b) full-width steps with their split,
    peak memory, launches, ATSS positives and imitation cells; (c), the
    train CLI on the flagship config with a teacher file, a resume, and
    `tools.test` on its checkpoint, is `_full_cli`, run beside phase 7 (a)
    and (e). `root` holds phase 7's KITTI tree (frames `ids`, `infos`)
    with its train and val info files."""
    import os
    from dfm_tpu_torch.data.collate import build_batch
    from dfm_tpu_torch.data.kitti import KittiDataset
    from dfm_tpu_torch.models.builder import atss_config
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.models.detectors.dfm_full import (DfMFull,
                                                         bev_cell_centers)
    from dfm_tpu_torch.models.detectors.imitation import imitation_mask
    from dfm_tpu_torch.models.heads.atss2d import (atss2d_anchors,
                                                   atss2d_targets)
    from dfm_tpu_torch.models.heads.depth_head import sample_depth_pixels
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py')
    atss = atss_config(load_config(config).model)
    frozen = ('lidar_teacher',)
    t_phase = time.perf_counter()

    # (a) card against CPU at the tiny config, TF32 off: the same live
    # weights, one training sample with teacher points and 2D targets,
    # the same depth pixels
    tiny = DfMConfig(**TRAIN_TINY)
    ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
        crop_size=TRAIN_TINY_CROP, flip_ratio=0.5, max_gt=32))
    sample = full_targets(ds.get_sample(0, np.random.default_rng(3)), tiny,
                          np.random.default_rng(4), TINY_POINTS)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        side = {}
        pix = None
        for d, noise in (('cpu', False), ('cpu', True), (dev, False)):
            model = _live_weights(init_weights(DfMFull(tiny, atss)), 4, 0.0)
            if noise:             # one ulp of relative noise, seeded
                g = torch.Generator().manual_seed(1)
                with torch.no_grad():
                    for p in model.parameters():
                        p.mul_(1 + 1.2e-7 * torch.randn(p.shape, generator=g))
            model = model.to(d)
            img, meta, gt = build_batch([sample], d)
            if pix is None:
                pix = sample_depth_pixels(
                    gt['depth_img'], tiny.num_depth_sample_pixels,
                    torch.Generator().manual_seed(0))
            step = TrainStep(model, make_optimizer(model,
                                                   frozen_prefixes=frozen),
                             liga_schedule(1e-3))
            before = {k: v.clone() for k, v in
                      model.lidar_teacher.state_dict().items()}
            K.reset_launch_counts()
            total, losses = step.forward(img, meta, gt,
                                         depth_pix_idx=pix.to(d))
            step.backward(total)
            if d != 'cpu':
                torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            # copies: the update clips the gradients in place
            grads = {n: (None if p.grad is None else
                         p.grad.detach().cpu().clone())
                     for n, p in model.named_parameters()}
            step.update()
            after = model.lidar_teacher.state_dict()
            stats = [k for k in before if k.endswith('running_var')]
            check(all(torch.equal(before[k], after[k]) for k in before
                      if not k.endswith(('running_mean', 'running_var'))),
                  f'{d}: the update changed a teacher parameter')
            check(all(not torch.equal(before[k], after[k]) for k in stats),
                  f'{d}: a teacher running variance did not move')
            side['cpu, ulp noise' if noise else d] = dict(
                losses={k: float(v.detach()) for k, v in
                        dict(loss=total, **losses).items()},
                grads=grads, launches=launches)
            del model, step, total, losses
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    want = side['cpu']['losses']
    check(set(want) >= {'loss_cls2d', 'loss_bbox2d', 'loss_centerness2d',
                        'loss_imitation'}, f'terms {sorted(want)}')
    for k, w in want.items():
        got = side[dev]['losses'][k]
        check(np.isfinite(got) and abs(got - w) <= TRAIN_LOSS_RTOL * (
            abs(w) + 1e-6), f'full tiny {k}: card {got} vs cpu {w}')
    worst, name, whole, whole_noise = _grad_compare(
        'full tiny', side[dev]['grads'], side['cpu']['grads'],
        side['cpu, ulp noise']['grads'])
    check_launches(side[dev]['launches'], 'train', 1, 'full tiny step')
    print(f'full (a) tiny f32 DfMFull card vs cpu: losses '
          f'{ {k: round(v, 6) for k, v in side[dev]["losses"].items()} } '
          f'(cpu { {k: round(v, 6) for k, v in want.items()} }, rtol '
          f'{TRAIN_LOSS_RTOL}); gradients of {len(side["cpu"]["grads"])} '
          f'parameters, worst relative L2 {worst:.3g} ({name}), whole '
          f'{whole:.3g}, under one ulp of weight noise {whole_noise:.3g}; '
          f'the update left the teacher\'s parameters bit for bit and moved '
          f'its running statistics (card and cpu); launches '
          f'{ {k: n for k, n in side[dev]["launches"].items() if n} }; '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    del side

    # (b) full-width f32 steps: two warm-ups, then three with the launch
    # counts set to 0 just before and read just after
    t_b = time.perf_counter()
    full = DfMConfig()
    model = init_weights(DfMFull(full, atss)).to(dev)
    step = TrainStep(model, make_optimizer(model, frozen_prefixes=frozen),
                     liga_schedule(1e-3))
    train_ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
        crop_size=IMG_HW, flip_ratio=0.5, max_gt=32))
    rng = np.random.default_rng(0)

    def batch(i):
        return build_batch([full_targets(train_ds.get_sample(
            i % len(ids), rng), full, rng, FULL_POINTS)], dev)

    for i in range(2):
        step(*batch(i), torch.Generator(device=dev).manual_seed(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    splits = []
    for i in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        img, meta, gt = batch(i + 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        total, losses = step.forward(
            img, meta, gt, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.backward(total)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        norm = step.update()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        splits.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                       (t4 - t3) * 1e3])
        vals = {k: float(v.detach())
                for k, v in dict(loss=total, **losses).items()}
        check(len(vals) == 10 and all(np.isfinite(x) for x in vals.values())
              and np.isfinite(float(norm)), f'full-width DfMFull step: {vals}')
    counts = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check_launches(counts, 'train', TRAIN_TIMED_STEPS,
                   'the full-width DfMFull steps')
    # what the last batch reaches: ATSS positives, imitation cells
    anchors, sizes = atss2d_anchors(IMG_HW, atss, dev)
    positives = int(atss2d_targets(anchors, sizes, gt, atss)[2].sum())
    with torch.no_grad():
        im = model(img, meta, gt['points'], gt['point_mask'])['imitation']
        centers = torch.as_tensor(bev_cell_centers(full), device=dev)
        cells = {k: int(imitation_mask(im[f'{k}_target'], centers,
                                       gt['gt_boxes'], gt['gt_mask']).sum())
                 for k in ('bev', 'volume')}
    check(positives > 0 and min(cells.values()) > 0,
          f'full-width DfMFull: ATSS positives {positives}, imitation '
          f'cells {cells}')
    med = np.median(np.asarray(splits), axis=0)
    print(f'full (b) full-width DfMFull steps, f32, B = 1, '
          f'{FULL_POINTS} teacher points, after 2 warm-up steps, ms (data, '
          f'forward, backward, optimizer): '
          + ' | '.join(', '.join(f'{x:.3f}' for x in row) for row in splits)
          + f'; median {", ".join(f"{x:.3f}" for x in med)}, total '
          f'{float(np.median(np.sum(splits, 1))):.3f} (bare DfM, phase 7 '
          f'(d): {", ".join(f"{x:.3f}" for x in bare_med)}); peak_mem_bytes '
          f'{peak}; last losses { {k: round(x, 5) for k, x in vals.items()} }'
          f' grad_norm {float(norm):.5g}; ATSS positives {positives}; '
          f'imitation cells {cells}; launches per step '
          f'{ {k: n // TRAIN_TIMED_STEPS for k, n in counts.items() if n} }; '
          f'{time.perf_counter() - t_b:.1f} s', flush=True)
    del model, step, total, losses, img, meta, gt, im
    gc.collect()
    torch.cuda.empty_cache()

    print(f'full phase {time.perf_counter() - t_phase:.1f} s', flush=True)

# phase 9: MultiViewDfM (MV-FCOS3D++, the camsync config) on the card
MV_TINY = dict(num_views=3, num_frames=2, feat_channels=16,
               voxel_range=(-8, -8, -1, 8, 8, 3), voxel_grid=(4, 16, 16),
               anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3,
               backbone_depth=50, nms_pre=128, max_num=8)
MV_TINY_HW = (32, 48)
MV_HW = (640, 960)            # the camsync config's data.target_hw
MV_STAGE_REL_L2 = 1e-4        # card vs CPU, float32 with TF32 off
MV_DET_TOL = (1e-3, 1e-3)     # scores atol; boxes atol + rtol
MV_WARMUP, MV_TIMED = 2, 3
# the CLI's tiny MultiViewDfM (card vs CPU) on a tree at 1/20 of the sizes
MV_CLI_TINY = ('data.target_hw=(32,48)', 'model.backbone_depth=18',
               'model.feat_channels=16', 'model.voxel_grid=(4,24,30)',
               'model.max_num=20')
LET_LINE = re.compile(r'^(Vehicle|Pedestrian|Cyclist|Sign|Overall) '
                      r'(mAP|mAPH|mAPL): (\S+)$', re.M)


def _mv_inputs(cfg, hw, frames, seed):
    """Seeded images (1, F, V, H, W, 3) and the synthetic Waymo cameras'
    lidar2img (1, F, V, 4, 4) at (H, W), earlier frames moved 1.5 m back
    along x (ego-motion)."""
    v = cfg.num_views
    imgs = np.random.RandomState(seed).randn(1, frames, v, *hw, 3)
    l2i = np.zeros((1, frames, v, 4, 4), np.float32)
    for f in range(frames):
        move = np.eye(4)
        move[0, 3] = 1.5 * f
        for i in range(v):
            yaw = WAYMO_CAMERAS[i][2]
            l2i[0, f, i] = waymo_lidar2img(yaw, hw, hw[1] / 1920) @ move
    return torch.from_numpy(imgs.astype(np.float32)), torch.from_numpy(l2i)


def _mv_stages(model, imgs, l2i, cfg):
    """The stages of one request, each ended by a synchronise on the
    card: (outputs, ms of trunk + FPN, view sample, neck, head,
    predict)."""
    from dfm_tpu_torch.models.detectors.multiview_dfm import mvdfm_predict
    sync = torch.cuda.synchronize if imgs.is_cuda else (lambda: None)
    out, ms = {}, []
    with torch.inference_mode():
        for name, fn in (
                ('feat0', lambda: model.image_features(imgs)),
                ('volume', lambda: model.sample_volume(
                    out['feat0'], l2i, tuple(imgs.shape[3:5]))),
                ('bev', lambda: model.neck_3d(out['volume'])),
                ('heads', lambda: model.bbox_head_3d(out['bev'])),
                ('det', lambda: mvdfm_predict(dict(zip(
                    ('cls_score', 'bbox_pred', 'dir_pred'), out['heads'])),
                    cfg))):
            t0 = time.perf_counter()
            out[name] = fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _mv_dets_agree(what, got, want, tol):
    """Kept detections of two runs (lists of 'boxes_3d' / 'scores_3d' /
    'labels_3d' dicts): counts and labels equal, scores within tol[0],
    boxes within tol[1] absolute + tol[1] relative. Returns the number of
    detections and the worst score and box errors."""
    check(len(got) == len(want), f'{what}: {len(got)} vs {len(want)} frames')
    n, worst = 0, [0.0, 0.0]
    for i, (g, w) in enumerate(zip(got, want)):
        check(np.array_equal(g['labels_3d'], w['labels_3d']),
              f'{what}, frame {i}: labels {g["labels_3d"]} vs '
              f'{w["labels_3d"]}')
        n += len(w['labels_3d'])
        if not len(w['labels_3d']):
            continue
        ds = np.abs(g['scores_3d'] - w['scores_3d'])
        db = np.abs(g['boxes_3d'] - w['boxes_3d'])
        worst[0] = max(worst[0], float(ds.max()))
        worst[1] = max(worst[1], float(db.max()))
        check(bool((ds <= tol[0]).all()), f'{what}, frame {i}: scores off '
              f'by {ds.max()}')
        check(bool((db <= tol[1] + tol[1] * np.abs(w['boxes_3d'])).all()),
              f'{what}, frame {i}: boxes off by {db.max()}')
    return n, worst


def mvdfm_phase(dev, trees=None):
    """Phase 9: (a) the tiny config card vs CPU, (b) the full camsync
    config in bf16 and f32, (c) the Waymo CLI on a synthetic tree. The
    trees go to `trees['full']` and `trees['small']` (phase 10 reads
    them), or to a temporary directory."""
    import os
    import pickle
    import tempfile
    from dfm_tpu_torch.apis import init_mvdfm_model
    from dfm_tpu_torch.data.png import read_png
    from dfm_tpu_torch.data.waymo import WaymoDataset
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.multiview_dfm import MVDfMConfig
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, 'configs',
                          'multiview_dfm_r101_waymo_camsync.py')

    # (a) tiny: every stage and the detections, card vs CPU, f32, TF32 off
    tiny = MVDfMConfig(**MV_TINY)
    imgs, l2i = _mv_inputs(tiny, MV_TINY_HW, tiny.num_frames, 3)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        K.reset_launch_counts()
        for d in ('cpu', dev):
            h = init_mvdfm_model(tiny, torch.float32, d)
            _live_weights(h['model'], 4, 2.0)
            outs[d], _ = _mv_stages(h['model'], imgs.to(d), l2i.to(d), tiny)
        check(not any(K.LAUNCHES.values()), f'tiny MultiViewDfM launched '
              f'port kernels: {K.LAUNCHES}')
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    rel = {}
    for key in ('feat0', 'volume', 'bev', 'heads'):
        a = outs['cpu'][key]
        b = outs[dev][key]
        a, b = (torch.cat([t.flatten() for t in x]) if isinstance(x, tuple)
                else x.flatten() for x in (a, b))
        rel[key] = float((b.cpu().double() - a.double()).norm()
                         / a.double().norm())
        check(rel[key] <= MV_STAGE_REL_L2, f'tiny MultiViewDfM {key} card vs '
              f'CPU: relative L2 {rel[key]}')
    seen = float((outs['cpu']['volume'].abs().sum(1) > 0).float().mean())
    check(0.05 < seen < 1, f'tiny MultiViewDfM: {seen} of the voxels seen')
    dets = {}
    for d in ('cpu', dev):
        det = {k: v[0].cpu().numpy() for k, v in outs[d]['det'].items()}
        m = det['mask'].astype(bool)
        dets[d] = [dict(boxes_3d=det['boxes3d'][m], scores_3d=det['scores'][m],
                        labels_3d=det['labels'][m])]
    n, worst = _mv_dets_agree('tiny MultiViewDfM dets card vs CPU',
                              dets[dev], dets['cpu'], MV_DET_TOL)
    check(n > 0, 'tiny MultiViewDfM: no live detection')
    print(f'mvdfm tiny f32 (TF32 off) card vs cpu: relative L2 '
          f'{ {k: float(f"{v:.3g}") for k, v in rel.items()} } (tol '
          f'{MV_STAGE_REL_L2}), {seen:.3f} of the voxels seen, {n} dets, '
          f'max abs err score {worst[0]:.3g} box {worst[1]:.3g} (tol '
          f'{MV_DET_TOL}), launches 0', flush=True)
    del outs

    with tempfile.TemporaryDirectory() as tmp:
        trees = trees or dict(full=os.path.join(tmp, 'full'),
                              small=os.path.join(tmp, 'small'))
        root, small = trees['full'], trees['small']
        t0 = time.perf_counter()
        infos = write_waymo_tree(root)
        write_waymo_tree(small, scale=0.05)
        tree_s = time.perf_counter() - t0
        full = MVDfMConfig()
        ds = WaymoDataset(root, infos, target_hw=MV_HW, cam_sync=True)
        png_ms = []
        for cam in infos[0]['images']:
            t0 = time.perf_counter()
            read_png(os.path.join(root, cam['image_path']))
            png_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        sample = ds.get_sample(0)
        frame_ms = (time.perf_counter() - t0) * 1e3
        imgs = torch.from_numpy(sample['imgs'])[None].to(dev)
        l2i = torch.from_numpy(sample['lidar2img'])[None].to(dev)
        print(f'mvdfm data: synthetic trees {tree_s:.1f} s; png decode '
              f'ms per view {[round(x, 1) for x in png_ms]} (5 views '
              f'{sum(png_ms):.1f}); assemble_multiview_sample of one frame '
              f'{frame_ms:.1f} ms (decode, resize, normalise)', flush=True)

        # (b) the full camsync config: bf16 (the default) and f32
        for dtype in (torch.bfloat16, torch.float32):
            h = init_mvdfm_model(full, dtype)
            model = h['model']
            with torch.no_grad():    # live scores: nms_pre boxes into NMS
                model.bbox_head_3d.conv_cls.bias.fill_(-1.0)
            for _ in range(MV_WARMUP):
                h['infer'](imgs, l2i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            ms = []
            for _ in range(MV_TIMED):
                t0 = time.perf_counter()
                det = h['infer'](imgs, l2i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(K.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            check(not any(launches.values()), f'MultiViewDfM launched port '
                  f'kernels: {launches}')
            kept = _finite_dets(det, f'MultiViewDfM {dtype}')
            check(kept > 0, f'MultiViewDfM {dtype}: no live detection')
            runs = [_mv_stages(model, imgs, l2i, full)
                    for _ in range(MV_TIMED)]
            stages = np.median([r[1] for r in runs], 0)
            out = runs[-1][0]
            del runs
            vol = out['volume']
            check(tuple(vol.shape) == (1, full.feat_channels,
                                       *full.voxel_grid) and
                  bool(torch.isfinite(vol).all()), 'full volume')
            check(tuple(out['bev'].shape) == (1, 256, *full.voxel_grid[1:])
                  and bool(torch.isfinite(out['bev']).all()), 'full BEV')
            seen = float((vol.abs().sum(1) > 0).float().mean())
            trunk = _flops_of(model.image_features, imgs)
            neck = _flops_of(model.neck_3d, vol)
            names = ('trunk+fpn', 'view sample', 'neck', 'head', 'predict')
            tf32 = (' (TF32 convs '
                    f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})'
                    if dtype == torch.float32 else '')
            print(f'mvdfm full {str(dtype)[6:]}{tf32}: ms/request '
                  f'{[round(x, 3) for x in ms]} median '
                  f'{float(np.median(ms)):.3f}; stages ms (median of '
                  f'{MV_TIMED}) ' + ', '.join(
                      f'{n} {x:.3f}' for n, x in zip(names, stages))
                  + f'; GFLOP trunk+fpn {trunk / 1e9:.1f} neck '
                  f'{neck / 1e9:.1f} (TFLOP/s {trunk / stages[0] / 1e9:.1f}, '
                  f'{neck / stages[2] / 1e9:.1f}); peak_mem_bytes {peak}; '
                  f'kept {kept}; {seen:.3f} of the voxels seen; port-kernel '
                  f'launches {sum(launches.values())}', flush=True)
            del h, model, out, vol
            gc.collect()
            torch.cuda.empty_cache()

        # (c) the CLI on the trees: the full config on the card (bf16), and
        # the tiny config on the card and on the CPU in f32 (TF32 off)
        ckpt = os.path.join(root, 'live.pth')
        h = init_mvdfm_model(full, torch.float32, 'cpu')
        _live_weights(h['model'], 5, 4.0)
        torch.save(h['model'].state_dict(), ckpt)
        del h
        env = dict(os.environ, PYTHONPATH=here, NVIDIA_TF32_OVERRIDE='0')

        def cli(data_root, *extra, options=()):
            return subprocess.Popen(
                [sys.executable, '-m', 'dfm_tpu_torch.tools.test', config,
                 *extra, '--cfg-options', f'data.data_root={data_root}',
                 'data.cam_sync=True', *options], cwd=here, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        t0 = time.perf_counter()
        tiny_pkl = {d: os.path.join(small, f'{d}.pkl') for d in ('cpu', dev)}
        tiny_ckpt = os.path.join(small, 'tiny.pth')
        h = init_mvdfm_model(build_detector(merge_options(
            load_config(config), list(MV_CLI_TINY)).model), torch.float32,
            'cpu')
        _live_weights(h['model'], 6, 4.0)
        torch.save(h['model'].state_dict(), tiny_ckpt)
        del h
        procs = {d: cli(small, '--dtype', 'float32', '--device', d,
                        '--checkpoint', tiny_ckpt, '--out', tiny_pkl[d],
                        options=MV_CLI_TINY) for d in ('cpu', dev)}
        full_proc = cli(root, '--checkpoint', ckpt)
        res = {}
        for name, p in [*procs.items(), ('full', full_proc)]:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f'tools.test ({name}) failed: '
                  f'{err[-3000:]}')
            lets = LET_LINE.findall(out)
            check(len(lets) == 15 and all(np.isfinite(float(v))
                                         for _, _, v in lets) and
                  '[metric] python_fallback' in out,
                  f'tools.test ({name}) printed {len(lets)} LET lines: '
                  f'{out[-2000:]}')
            res[name] = out
        cli_s = time.perf_counter() - t0
        got = {}
        for d in ('cpu', dev):
            with open(tiny_pkl[d], 'rb') as f:
                got[d] = pickle.load(f)
        n, worst = _mv_dets_agree('tools.test tiny card vs CPU', got[dev],
                                  got['cpu'], MV_DET_TOL)
        check(n > 0, 'tools.test tiny: no live detection')
        overall = re.search(r'^Overall mAP: (\S+)$', res['full'], re.M)
        dets = re.findall(r'^\[\d+/\d+\] dets=(\d+)$', res['full'], re.M)
        print(f'mvdfm cli: the full config on the card, 2 frames of 5 '
              f'Waymo-size views, dets {dets}, 15 LET lines from '
              f'python_fallback, Overall mAP {overall.group(1)}; the tiny '
              f'config card vs cpu (f32, TF32 off): {n} dets, labels equal, '
              f'max abs err score {worst[0]:.3g} box {worst[1]:.3g}; '
              f'{cli_s:.1f} s for the three processes', flush=True)
    print(f'mvdfm phase {time.perf_counter() - t_phase:.1f} s', flush=True)


# phase 10: data parallelism (parallel/dist.py) and MultiViewDfM training
DDP_LOSS_RTOL = 1e-5          # (b): the loss of the group against one process
DDP_WARMUP, DDP_TIMED = 2, 3  # (b) timed steps per rank
# (d) tiny: the card's float32 gradients (cuDNN, TF32 off) and the CPU's
# against the CPU's float64 ones on the same ReLU branches, at three view
# sizes (`mvdfm_tiny_gradients`); at 128x192 also phase 7 (a)'s rule
# against the CPU's float32 step
MV_TRAIN_HW = (128, 192)
MV_TRAIN_HWS = ((64, 96), (128, 192), (256, 384))
MV_TRAIN_TINY = dict(num_views=2, num_frames=1, feat_channels=16,
                     voxel_range=(-8, -8, -1, 8, 8, 3),
                     voxel_grid=(4, 16, 16),
                     anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3,
                     backbone_depth=18, nms_pre=128, max_num=8)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _run(cmd, timeout=600):
    """`cmd` in a process of its own from the repo root, the package on
    its path; its CompletedProcess (text output)."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run(cmd, cwd=here, env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=timeout)


def _torchrun(n, *args):
    return [sys.executable, '-m', 'torch.distributed.run',
            f'--nproc_per_node={n}', '--master_addr=127.0.0.1',
            f'--master_port={_free_port()}', *args]


def _no_tf32():
    """Turn TF32 off (cuDNN's convolutions and cuBLAS's matmuls in float32
    precision); returns the flags to restore."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return flags


def _set_tf32(flags):
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def _ulp_noise(model, seed=1):
    """One ulp of seeded relative noise on every parameter (phase 7 (a))."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1.2e-7 * torch.randn(p.shape, generator=g))
    return model


def _grads_and_stats(step, total, losses):
    """After `step.reduce()`: the loss terms of the global batch, every
    gradient and every BatchNorm running statistic, on the host."""
    from dfm_tpu_torch.parallel import dist as D
    model = step.model
    return dict(
        losses={k: float(v) for k, v in D.sum_scalars(dict(
            loss=total.detach(), **{k: v.detach() for k, v in
                                    losses.items()})).items()},
        grads={n: p.grad.detach().cpu().clone() for n, p in
               model.named_parameters()},
        stats={n: b.detach().cpu().clone() for n, b in model.named_buffers()
               if n.endswith(('running_mean', 'running_var'))})


def _losses_agree(what, got, want, rtol):
    worst = 0.0
    for k, w in want.items():
        err = abs(got[k] - w) / (abs(w) + 1e-6)
        worst = max(worst, err)
        check(np.isfinite(got[k]) and err <= rtol,
              f'{what} {k}: {got[k]} vs {w} (rtol {rtol})')
    return worst


def _ddp_compare(what, got, want, movers, again):
    """Loss terms, gradients and BatchNorm statistics of `got` against
    `want` (dicts of `_grads_and_stats`), the gradients and statistics by
    phase 7 (a)'s rule: each one's movement the largest of its movements
    in the `movers`, want's run under one ulp of weight noise (two
    seeds). `again` is want's run repeated, whose bit-equal gradients
    the line reports. Returns a line of the errors."""
    loss_err = _losses_agree(what, got['losses'], want['losses'],
                             DDP_LOSS_RTOL)
    g = _grad_compare(f'{what} gradients', got['grads'], want['grads'],
                      tuple(m['grads'] for m in movers))
    s = _grad_compare(f'{what} BatchNorm statistics', got['stats'],
                      want['stats'], tuple(m['stats'] for m in movers))

    def equal(a):
        return sum(torch.equal(a['grads'][n], w)
                   for n, w in want['grads'].items())

    return (f'loss terms worst rel {loss_err:.3g} (rtol {DDP_LOSS_RTOL}); '
            f'gradients worst relative L2 {g[0]:.3g} ({g[1]}), whole '
            f'{g[2]:.3g} (under one ulp of weight noise: {g[3]:.3g}), '
            f'{equal(got)} of {len(want["grads"])} bit-equal '
            f'({equal(again)} in the repeat); BatchNorm statistics worst '
            f'{s[0]:.3g}, whole {s[2]:.3g} (noise {s[3]:.3g})')


def ddp_rank(work):
    """One rank of phase 10 (b), started by torchrun on the card: the
    parity step (TF32 off) on its rows of the global batch of 2, then
    DDP_WARMUP + DDP_TIMED timed steps (each, as the train CLI's ranks
    do, decoding the whole global batch and drawing its depth pixels,
    then taking its rows), split into data, forward, backward,
    all-reduce and optimizer; writes rank<r>.pt to `work`."""
    import hashlib
    import os
    from dfm_tpu_torch.data.collate import build_batch
    from dfm_tpu_torch.data.kitti import KittiDataset
    from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.parallel import dist as D
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.train import draw_depth_pixels, step_generator
    from dfm_tpu_torch.utils.weights import init_weights
    dev = D.init_from_env()
    r = D.rank()
    inp = torch.load(os.path.join(work, 'inputs.pt'), weights_only=False)
    ds = KittiDataset(inp['root'], inp['infos'], train=True,
                      pipeline_kwargs=dict(crop_size=IMG_HW, flip_ratio=0.5,
                                           max_gt=32))
    model = _live_weights(init_weights(DfM(DfMConfig())), 4, 0.0).to(dev)
    step = TrainStep(model, make_optimizer(model), liga_schedule(1e-3))
    rng = np.random.default_rng(3)
    samples = [ds.get_sample(i, rng) for i in range(2)]
    img, meta, gt = build_batch(samples[r:r + 1], dev)
    flags = _no_tf32()
    try:
        total, losses = step.forward(
            img, meta, gt, depth_pix_idx=D.shard_batch(inp['pix'].to(dev)))
        step.backward(total)
        step.reduce()
        torch.cuda.synchronize()
    finally:
        _set_tf32(flags)
    out = _grads_and_stats(step, total, losses)
    h = hashlib.sha1()
    for n in sorted(out['grads']):
        h.update(out['grads'][n].numpy().tobytes())
    for n in sorted(out['stats']):
        h.update(out['stats'][n].numpy().tobytes())
    out.update(digest=h.hexdigest(), reduce_bytes=step.reduce_bytes,
               backend=D.backend(), world=D.world_size(), device=str(dev))
    if r:
        out = {k: v for k, v in out.items() if k not in ('grads', 'stats')}
    step.update()
    del total, losses, img, meta, gt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    splits = []
    for i in range(DDP_WARMUP + DDP_TIMED):
        if i == DDP_WARMUP:
            K.reset_launch_counts()
        D.barrier()
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        img, meta, gt = build_batch(
            [ds.get_sample((2 * i + j) % len(ds), rng) for j in range(2)],
            dev)
        gen = step_generator(0, i, dev)
        img, meta, gt, pix = D.shard_batch(
            (img, meta, gt, draw_depth_pixels(step.model.cfg, gt, gen)))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total, losses = step.forward(img, meta, gt, gen, pix)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step.backward(total)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step.reduce()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        norm = step.update()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        check(np.isfinite(float(total)) and np.isfinite(float(norm)),
              f'rank {r}: step {i} not finite')
        if i >= DDP_WARMUP:
            splits.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    out.update(splits=splits, peak=torch.cuda.max_memory_allocated(),
               launches=dict(K.LAUNCHES))
    torch.save(out, os.path.join(work, f'rank{r}.pt'))
    D.destroy()
    return 0


def ddp_phase(cfg, dev, results, waymo_trees):
    """10. data parallelism and MultiViewDfM training: (a) a group of one
    on NCCL against no group, (b) two ranks on the one card under gloo
    against one process at the same global batch, with their step split,
    all-reduce bytes and peak memory, (c) the CLIs under torchrun, (d)
    MultiViewDfM training. `waymo_trees` holds phase 9's Waymo trees
    ('full', 'small')."""
    import os
    import tempfile
    import threading
    from dfm_tpu_torch.apis import init_mvdfm_model
    from dfm_tpu_torch.data.collate import build_batch
    from dfm_tpu_torch.data.kitti import KittiDataset, build_kitti_infos
    from dfm_tpu_torch.data.waymo import WaymoDataset
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.dfm import DfM, DfMConfig
    from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                              MVDfMConfig)
    from dfm_tpu_torch.models.heads.depth_head import sample_depth_pixels
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.parallel import dist as D
    from dfm_tpu_torch.runtime.adapters import mv_to_device
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.train import optimizer_digest
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    kitti_cfg = os.path.join(here, 'configs', 'dfm_r34_kitti_3class.py')
    mv_cfg = os.path.join(here, 'configs',
                          'multiview_dfm_r101_waymo_camsync.py')
    run = _run


    with tempfile.TemporaryDirectory() as root:
        # phase 7's KITTI tree (the same writer and seed) with its infos
        ids = write_kitti_tree(root)
        infos = build_kitti_infos(root, ids)
        res = run([sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
                   'kitti', '--root', root, '--splits', 'train', 'val'])
        check(res.returncode == 0, f'create_data failed: {res.stderr}')
        ckpt = os.path.join(root, 'ref.pth')
        _ref_checkpoint(cfg, ckpt)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the CLIs, in processes of their own while (a) runs in this
        # one (nothing of (a) is timed)
        cli = {}
        work = os.path.join(root, 'w')
        train = ['-m', 'dfm_tpu_torch.tools.train', kitti_cfg,
                 '--cfg-options', 'model.type=DfM', f'data.data_root={root}',
                 '--work-dir', work, '--max-steps']

        def train_cli():
            cli['train'] = run(_torchrun(1, *train, '2'))
            cli['resume'] = run(_torchrun(1, *train, '3', '--auto-resume'))

        kitti_test = ['-m', 'dfm_tpu_torch.tools.test', kitti_cfg,
                      '--checkpoint', ckpt, '--cfg-options',
                      f'data.data_root={root}']
        small = waymo_trees['small']
        mv_live = os.path.join(root, 'mv_live.pth')
        h = init_mvdfm_model(build_detector(merge_options(
            load_config(mv_cfg), list(MV_CLI_TINY)).model), torch.float32,
            'cpu')
        _live_weights(h['model'], 6, 4.0)
        torch.save(h['model'].state_dict(), mv_live)
        del h
        waymo_test = ['-m', 'dfm_tpu_torch.tools.test', mv_cfg,
                      '--checkpoint', mv_live, '--dtype', 'float32',
                      '--cfg-options', f'data.data_root={small}',
                      'data.cam_sync=True', *MV_CLI_TINY]

        def eval_cli(name, n, cmd):
            def go():
                cli[name] = run(_torchrun(n, *cmd) if n > 1
                                else [sys.executable, *cmd])
            return go

        t_cli = time.perf_counter()
        join_cli = _in_background(
            [('train', train_cli)] + [
                (f'{kind}{n}', eval_cli(f'{kind}{n}', n, cmd))
                for kind, cmd in (('kitti', kitti_test),
                                  ('waymo', waymo_test)) for n in (1, 2)])

        # (a) a group of one on NCCL: the full-width f32 step (TF32 off)
        # with the group against the same step without one
        full = DfMConfig()
        ds = KittiDataset(root, infos, train=True, pipeline_kwargs=dict(
            crop_size=IMG_HW, flip_ratio=0.5, max_gt=32))
        rng = np.random.default_rng(3)
        samples = [ds.get_sample(i, rng) for i in range(2)]
        img, meta, gt = build_batch(samples[:1], dev)
        pix = sample_depth_pixels(
            gt['depth_img'], full.num_depth_sample_pixels,
            torch.Generator(device=dev).manual_seed(0), full.depth_min,
            full.depth_max)

        def parity_step(inputs, noise=None):
            model = _live_weights(init_weights(DfM(full)), 4, 0.0)
            model = (model if noise is None else
                     _ulp_noise(model, noise)).to(dev)
            step = TrainStep(model, make_optimizer(model),
                             liga_schedule(1e-3))
            K.reset_launch_counts()
            total, losses = step.forward(*inputs)
            step.backward(total)
            step.reduce()
            torch.cuda.synchronize()
            out = _grads_and_stats(step, total, losses)
            out.update(launches=dict(K.LAUNCHES),
                       reduce_bytes=step.reduce_bytes)
            del model, step, total, losses
            gc.collect()
            torch.cuda.empty_cache()
            return out

        inputs = (img, meta, gt, None, pix)
        flags = _no_tf32()
        keys = ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE',
                'LOCAL_RANK', 'LOCAL_WORLD_SIZE')
        saved_env = {k: os.environ.get(k) for k in keys}
        try:
            alone, again = parity_step(inputs), parity_step(inputs)
            movers = [parity_step(inputs, noise=seed) for seed in (1, 2)]
            os.environ.update(MASTER_ADDR='127.0.0.1',
                              MASTER_PORT=str(_free_port()), RANK='0',
                              WORLD_SIZE='1', LOCAL_RANK='0',
                              LOCAL_WORLD_SIZE='1')
            D.init_from_env()
            check(D.backend() == 'nccl' and D.world_size() == 1,
                  f'group of one: backend {D.backend()}')
            group = parity_step(inputs)
        finally:
            D.destroy()
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            _set_tf32(flags)
        check(not D.is_active(), 'the group of one outlived (a)')
        line = _ddp_compare('ddp (a) group of one', group, alone, movers,
                            again)
        check_launches(group['launches'], 'train', 1, 'ddp (a) group step')
        for name in TRAIN_PATH:
            results[name]['launches_ddp_group_step'] = group['launches'][name]
        print(f'ddp (a) group of one (nccl), full DfMConfig f32 (TF32 '
              f'off), B = 1, against no group: {line}; all-reduce '
              f'{group["reduce_bytes"]} bytes; launches '
              f'{ {k: n for k, n in group["launches"].items() if n} }',
              flush=True)
        del alone, again, movers, group, img, meta, gt
        join_cli()
        cli_s = time.perf_counter() - t_cli

        # (b) two ranks on the one card under gloo (NCCL refuses two ranks
        # on one card), B = 1 each, against one process at B = 2
        img, meta, gt = build_batch(samples, dev)
        pix2 = sample_depth_pixels(
            gt['depth_img'], full.num_depth_sample_pixels,
            torch.Generator(device=dev).manual_seed(0), full.depth_min,
            full.depth_max)
        flags = _no_tf32()
        try:
            inputs = (img, meta, gt, None, pix2)
            one, again = parity_step(inputs), parity_step(inputs)
            movers = [parity_step(inputs, noise=seed) for seed in (1, 2)]
        finally:
            _set_tf32(flags)
        del img, meta, gt
        gc.collect()
        torch.cuda.empty_cache()
        ddp_dir = os.path.join(root, 'ddp')
        os.makedirs(ddp_dir)
        torch.save(dict(root=root, infos=infos, pix=pix2.cpu()),
                   os.path.join(ddp_dir, 'inputs.pt'))
        t0 = time.perf_counter()
        res = run(_torchrun(2, os.path.join(here, 'chip_smoke.py'),
                            '--ddp-rank', ddp_dir), timeout=900)
        ranks_s = time.perf_counter() - t0
        check(res.returncode == 0, f'ddp (b) ranks failed: '
              f'{res.stderr[-3000:]}')
        ranks = [torch.load(os.path.join(ddp_dir, f'rank{r}.pt'),
                            weights_only=False) for r in range(2)]
        check(all(o['backend'] == 'gloo' and o['world'] == 2 for o in ranks),
              f'ddp (b): {[(o["backend"], o["world"]) for o in ranks]}')
        check(ranks[0]['digest'] == ranks[1]['digest'], 'ddp (b): the two '
              "ranks' gradients or BatchNorm statistics differ")
        line = _ddp_compare('ddp (b) two ranks', ranks[0], one, movers, again)
        for o in ranks:
            check_launches(o['launches'], 'train', DDP_TIMED,
                           'ddp (b) rank steps')
        names = ('data', 'forward', 'backward', 'all-reduce', 'optimizer')
        print(f'ddp (b) two ranks on one card (gloo), full DfMConfig f32, '
              f'B = 1 each, against one process at B = 2 (TF32 off): '
              f'{line}; ranks on {ranks[0]["device"]}, {ranks_s:.1f} s for '
              f'the two processes', flush=True)
        for r, o in enumerate(ranks):
            med = np.median(np.asarray(o['splits']), 0)
            print(f'ddp (b) rank {r}: {DDP_TIMED} steps after {DDP_WARMUP} '
                  f'warm-ups (TF32 as the CLI has it, each decoding the '
                  f'global batch of 2), ms ' + ' | '.join(
                      ', '.join(f'{x:.3f}' for x in row)
                      for row in o['splits'])
                  + f'; median ' + ', '.join(
                      f'{n} {x:.3f}' for n, x in zip(names, med))
                  + f', total {float(np.median(np.sum(o["splits"], 1))):.3f}'
                  f'; all-reduce {o["reduce_bytes"]} bytes; peak_mem_bytes '
                  f'{o["peak"]}; launches per step '
                  f'{ {k: n // DDP_TIMED for k, n in o["launches"].items() if n} }',
                  flush=True)
        del one, again, movers, ranks, inputs

        # (c) the CLIs' results
        for k in ('train', 'resume', 'kitti1', 'kitti2', 'waymo1',
                  'waymo2'):
            check(cli[k].returncode == 0, f'ddp (c) {k} failed: '
                  f'{cli[k].stderr[-3000:]}')
        check('rank 0 of 1 (nccl)' in cli['train'].stdout,
              f'ddp (c) train: {cli["train"].stdout[-1000:]}')
        digest = optimizer_digest(torch.load(
            os.path.join(work, 'ckpts', 'step_2.pth'), map_location='cpu',
            weights_only=True)['optimizer'])
        check(f'resumed from step 2 (optimizer state sha1 {digest})'
              in cli['resume'].stdout and os.path.exists(
                  os.path.join(work, 'ckpts', 'step_3.pth')),
              f'ddp (c) resume: {cli["resume"].stdout[-2000:]}')
        with open(os.path.join(work, 'metrics.jsonl')) as f:
            logged = [json.loads(line)['step'] for line in f]
        check(logged == [1, 2, 3], f'ddp (c) logged steps {logged}')
        aps = [re.findall(r'^(?:Car|Pedestrian|Cyclist)_\w+: \S+$',
                          cli[f'kitti{n}'].stdout, re.M) for n in (1, 2)]
        check(len(aps[0]) == 36 and aps[0] == aps[1],
              f'ddp (c) tools.test KITTI: 2 ranks {aps[1]} vs 1 {aps[0]}')
        car = re.search(r'^Car_3d_moderate_strict: (\S+)$',
                        cli['kitti2'].stdout, re.M).group(1)
        lets = [LET_LINE.findall(cli[f'waymo{n}'].stdout) for n in (1, 2)]
        check(len(lets[0]) == 15 and lets[0] == lets[1],
              f'ddp (c) tools.test Waymo: 2 ranks {lets[1]} vs 1 {lets[0]}')
        print(f'ddp (c) cli: torchrun --nproc_per_node=1 tools.train (nccl) '
              f'2 steps at full width on the KITTI tree and a resume to 3 '
              f'(optimizer sha1 {digest}); tools.test under 2 gloo ranks: '
              f'the 36 KITTI AP lines and the 15 Waymo LET lines equal to '
              f'one process\'s (Car_3d_moderate_strict {car}); '
              f'{cli_s:.1f} s for the six processes beside (a)', flush=True)

    # (d) MultiViewDfM training: the train CLI in processes of its own
    # while the tiny config's card-vs-CPU gradients run here, then one
    # full-width camsync step alone on the card
    with tempfile.TemporaryDirectory() as root:
        mv_cli = {}
        work = os.path.join(root, 'w')

        def mv_train_cli():
            mv_cli['train'] = run([
                sys.executable, '-m', 'dfm_tpu_torch.tools.train', mv_cfg,
                '--synthetic', '--max-steps', '2', '--work-dir', work])
            if mv_cli['train'].returncode == 0:
                mv_cli['test'] = run([
                    sys.executable, '-m', 'dfm_tpu_torch.tools.test',
                    mv_cfg, '--checkpoint',
                    os.path.join(work, 'ckpts', 'step_2.pth'),
                    '--cfg-options', f'data.data_root={waymo_trees["small"]}',
                    'data.cam_sync=True', 'data.target_hw=(32,48)'])

        t_cli = time.perf_counter()
        join_cli = _in_background([('mv train', mv_train_cli)])

        mvdfm_tiny_gradients(dev)
        join_cli()
        mv_cli_s = time.perf_counter() - t_cli
        for k in ('train', 'test'):
            check(k in mv_cli and mv_cli[k].returncode == 0,
                  f'mvdfm train (d) CLI {k} failed: '
                  f'{mv_cli[k].stderr[-3000:] if k in mv_cli else ""}')
        lets = LET_LINE.findall(mv_cli['test'].stdout)
        check(len(lets) == 15 and all(np.isfinite(float(v))
                                     for _, _, v in lets),
              f'mvdfm train (d) tools.test: {len(lets)} LET lines')
        step2 = re.search(r'^step 2/2 .*$', mv_cli['train'].stdout, re.M)
        check(step2 is not None and 'loss_cls=' in step2.group(0),
              f'mvdfm train (d) CLI: {mv_cli["train"].stdout[-1000:]}')
        print(f'mvdfm train (d) cli: tools.train --synthetic at the camsync '
              f'config, 2 steps ({step2.group(0)}); tools.test on its '
              f'checkpoint: 15 finite LET lines; {mv_cli_s:.1f} s',
              flush=True)

        # the full camsync config, f32, B = 1: phase 9's first frame
        full_mv = MVDfMConfig()
        ds = WaymoDataset(waymo_trees['full'], os.path.join(
            waymo_trees['full'], 'waymo_infos_val.pkl'), target_hw=MV_HW,
            cam_sync=True)
        t0 = time.perf_counter()
        sample = ds.get_sample(0)
        decode_ms = (time.perf_counter() - t0) * 1e3
        frame = dict(img=sample['imgs'][None],
                     lidar2img=sample['lidar2img'][None],
                     **{k: sample[k][None] for k in ('gt_boxes', 'gt_labels',
                                                     'gt_mask')})
        check(int(sample['gt_mask'].sum()) > 0, 'mvdfm train: no gt box')
        model = init_weights(MultiViewDfM(full_mv)).to(dev)
        step = TrainStep(model, make_optimizer(model), liga_schedule(5e-4))
        splits = []
        for i in range(2 + 3):
            if i == 2:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
            t = [time.perf_counter()]
            imgs, l2i, gt = mv_to_device(frame, dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            total, losses = step.forward(imgs, l2i, gt)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            step.backward(total)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            norm = step.update()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            vals = {k: float(v.detach()) for k, v in
                    dict(loss=total, **losses).items()}
            check(all(np.isfinite(x) for x in vals.values()) and
                  np.isfinite(float(norm)), f'mvdfm train full: {vals}')
            if i >= 2:
                splits.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
        peak = torch.cuda.max_memory_allocated()
        launches = sum(K.LAUNCHES.values())
        check(launches == 0, f'mvdfm train full: {dict(K.LAUNCHES)}')
        med = np.median(np.asarray(splits), 0)
        print(f'mvdfm train (d) full camsync config, f32 (TF32 as PyTorch '
              f'has it), B = 1, 1 x 5 x 640x960, phase 9\'s first frame '
              f'({int(sample["gt_mask"].sum())} gt boxes; its decode and '
              f'assembly {decode_ms:.1f} ms, once), 3 steps after 2 '
              f'warm-ups, ms (data = host to device, forward, backward, '
              f'optimizer): ' + ' | '.join(', '.join(f'{x:.3f}' for x in row)
                                         for row in splits)
              + f'; median {", ".join(f"{x:.3f}" for x in med)}, total '
              f'{float(np.median(np.sum(splits, 1))):.3f}; peak_mem_bytes '
              f'{peak}; last losses { {k: round(x, 5) for k, x in vals.items()} }'
              f' grad_norm {float(norm):.5g}; port-kernel launches {launches}',
              flush=True)
        del model, step, total, losses, imgs, l2i, gt
        gc.collect()
        torch.cuda.empty_cache()
    print(f'ddp phase {time.perf_counter() - t_phase:.1f} s', flush=True)


class _ReluMasks:
    """Within `with`: every `F.relu` records its input's sign mask
    (`record`, a list) or, given `masks` (another run's, in call order),
    applies them (x * mask): the run then takes the recorded run's branch
    of each ReLU kink."""

    def __init__(self, masks=None):
        self.masks, self.record = masks, []

    def __enter__(self):
        import torch.nn.functional as F
        self.orig = F.relu

        def relu(x, inplace=False):
            i = len(self.record)
            self.record.append((x > 0).cpu())
            if self.masks is None:
                return self.orig(x, inplace=inplace)
            return x * self.masks[i].to(x.device, x.dtype)

        F.relu = relu
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F
        F.relu = self.orig


def mvdfm_tiny_gradients(dev):
    """Phase 10 (d)'s tiny MultiViewDfM (ResNet-18, 2 views) gradients at
    MV_TRAIN_HWS, against the CPU's float64 step (oneDNN off): a float32
    step's ReLU kinks within its rounding of 0 may take the other branch
    (a single such element in the 3D neck moves this tiny model's whole
    gradient by percents), so each float32 step is held against the
    float64 step on its own branches (`_ReluMasks`): the card's (cuDNN,
    TF32 off) error, each parameter and the whole gradient, within
    TRAIN_GRAD_FACTOR x the CPU's float32 error (at least
    TRAIN_GRAD_FLOOR); the raw float64 distances and the flipped ReLU
    elements printed. At MV_TRAIN_HW also the card against the CPU's
    float32 step by phase 7 (a)'s rule. `python3 -c "import chip_smoke;
    chip_smoke.mvdfm_tiny_gradients('cuda')"` runs it alone."""
    from dfm_tpu_torch.models.detectors.multiview_dfm import (MultiViewDfM,
                                                              MVDfMConfig)
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import mv_synth, mv_to_device
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.utils.weights import init_weights
    tiny = MVDfMConfig(**MV_TRAIN_TINY)

    def side(batch, d, dtype, noise=False, masks=None):
        model = _live_weights(init_weights(MultiViewDfM(tiny)), 4, 0.0)
        model = (_ulp_noise(model, 1) if noise else model).to(d, dtype)
        step = TrainStep(model, make_optimizer(model), liga_schedule(1e-3))
        K.reset_launch_counts()
        imgs, l2i, gt = mv_to_device(batch, d)
        with torch.backends.mkldnn.flags(enabled=dtype != torch.float64), \
                _ReluMasks(masks) as relu:
            total, losses = step.forward(imgs.to(dtype), l2i.to(dtype), gt)
            step.backward(total)
        step.reduce()
        return dict(_grads_and_stats(step, total, losses), masks=relu.record,
                    launches=sum(K.LAUNCHES.values()))

    for hw in MV_TRAIN_HWS:
        batch = mv_synth(tiny, 2, 3, *hw)
        flags = _no_tf32()
        try:
            runs = dict(f64=side(batch, 'cpu', torch.float64),
                        cpu=side(batch, 'cpu', torch.float32),
                        card=side(batch, dev, torch.float32))
            for k in ('cpu', 'card'):
                runs[f'f64 on the {k} branches'] = side(
                    batch, 'cpu', torch.float64, masks=runs[k]['masks'])
            if hw == MV_TRAIN_HW:
                runs['cpu, noise'] = side(batch, 'cpu', torch.float32,
                                          noise=True)
        finally:
            _set_tf32(flags)
        check(runs['card']['launches'] == 0,
              'mvdfm train tiny: port kernels launched')
        flips = {k: sum(int((a != b).sum()) for a, b in zip(
            runs[k]['masks'], runs['f64']['masks'])) for k in ('cpu', 'card')}
        raw = {k: _rel_l2(runs[k]['grads'], runs['f64']['grads'])[1]
               for k in ('cpu', 'card')}
        rel = {k: _rel_l2(runs[k]['grads'],
                          runs[f'f64 on the {k} branches']['grads'])
               for k in ('cpu', 'card')}
        limit = {n: max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR * r)
                 for n, r in rel['cpu'][0].items()}
        ratio = {n: r / max(TRAIN_GRAD_FLOOR / TRAIN_GRAD_FACTOR,
                            rel['cpu'][0][n])
                 for n, r in rel['card'][0].items()}
        worst = max(ratio, key=ratio.get)
        print(f'mvdfm train (d) tiny against float64 (CPU, oneDNN off), '
              f'B = 2 of {hw}: ReLU elements on the other branch than '
              f'float64: CPU {flips["cpu"]}, card {flips["card"]}; whole '
              f'relative L2 against float64 CPU f32 {raw["cpu"]:.3g}, card '
              f'f32 (cuDNN, TF32 off) {raw["card"]:.3g}; on their own '
              f'branches CPU {rel["cpu"][1]:.3g}, card {rel["card"][1]:.3g}; '
              f'worst card parameter {worst} {rel["card"][0][worst]:.3g} '
              f'({ratio[worst]:.3g}x the larger of the CPU\'s '
              f'{rel["cpu"][0][worst]:.3g} and '
              f'{TRAIN_GRAD_FLOOR / TRAIN_GRAD_FACTOR:.2g}; held at '
              f'{TRAIN_GRAD_FACTOR:g}x); launches 0', flush=True)
        bad = {n: (r, limit[n]) for n, r in rel['card'][0].items()
               if r > limit[n]}
        check(not bad, f'mvdfm train tiny {hw}: card gradients beyond '
              f'3x the CPU\'s float32 error against float64: {bad}')
        check(rel['card'][1] <= max(TRAIN_GRAD_FLOOR, TRAIN_GRAD_FACTOR
                                    * rel['cpu'][1]),
              f'mvdfm train tiny {hw}: whole card gradient '
              f'{rel["card"][1]} against float64, the CPU\'s '
              f'{rel["cpu"][1]}')
        if hw != MV_TRAIN_HW:
            continue
        loss_err = _losses_agree('mvdfm train tiny', runs['card']['losses'],
                                 runs['cpu']['losses'], TRAIN_LOSS_RTOL)
        g = _grad_compare('mvdfm train tiny', runs['card']['grads'],
                          runs['cpu']['grads'], runs['cpu, noise']['grads'])
        print(f'mvdfm train (d) tiny f32 (TF32 off) card vs cpu, '
              f'B = 2 of {MV_TRAIN_HW}: losses '
              f'{ {k: round(v, 6) for k, v in runs["card"]["losses"].items()} } '
              f'worst rel {loss_err:.3g} (rtol {TRAIN_LOSS_RTOL}); '
              f'gradients of {len(runs["cpu"]["grads"])} parameters, '
              f'worst relative L2 {g[0]:.3g} ({g[1]}), whole {g[2]:.3g} '
              f'(one ulp of weight noise: {g[3]:.3g}); launches 0',
              flush=True)


# phase 11: the 10-sweeps MultiViewDfM config (two frames concatenated,
# DfMNeck), the CenterHead and the voxel_sample depth head
MV_TEMPORAL_TINY = dict(num_views=2, num_frames=2, feat_channels=16,
                        voxel_range=(-8, -8, -1, 8, 8, 3),
                        voxel_grid=(4, 16, 16),
                        anchor_ranges=((-8, -8, 0.0, 8, 8, 0.0),) * 3,
                        backbone_depth=18, nms_pre=128, max_num=8,
                        frame_fusion='concat', neck_3d='dfm')
MV_TEMPORAL_VARIANTS = (
    ('10-sweeps', {}),
    ('center', dict(bbox_head='center')),
    ('depth head', dict(frame_fusion='mean', neck_3d='imvoxel',
                        with_backbone_3d=True, with_depth_head=True,
                        depth_min=1.0, depth_max=8.0, depth_num_bins=16)))
MV_TEMPORAL_HW = (64, 96)
MV_TEMPORAL_TRAIN_WARMUP = 1


def _detections(det):
    """Kept detections of `mvdfm_predict`'s output (sample 0), numpy."""
    if 'scores_3d' in det:                   # CenterHead: padded, sample 0
        det = {k: v.cpu().numpy() for k, v in det.items()}
        keep = det['scores_3d'] > 0
        return {k: v[keep] for k, v in det.items()}
    det = {k: v[0].cpu().numpy() for k, v in det.items()}
    m = det['mask'].astype(bool)
    return dict(boxes_3d=det['boxes3d'][m], scores_3d=det['scores'][m],
                labels_3d=det['labels'][m])


def _flat_outputs(out):
    """The forward's outputs as name -> tensor (the CenterHead's branch
    maps as task{t}.{name})."""
    flat = {k: v for k, v in out.items() if k != 'task_outs'}
    for t, branches in enumerate(out.get('task_outs', ())):
        flat.update({f'task{t}.{k}': v for k, v in branches.items()})
    return flat


def temporal_phase(dev, trees):
    """11. (a) the tiny 10-sweeps, CenterHead and depth-head variants card
    vs CPU, (b) the full 10-sweeps config in bf16 and f32, (c) tools.test
    with the 10-sweeps config on phase 9's trees (their infos carry
    sweeps), (d) one full-width f32 training step. `trees` holds phase 9's
    Waymo trees ('full', 'small')."""
    import os
    from dfm_tpu_torch.apis import init_mvdfm_model
    from dfm_tpu_torch.data.waymo import WaymoDataset, frames_per_sample
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.multiview_dfm import (
        MultiViewDfM, MVDfMConfig, mvdfm_predict)
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import mv_to_device
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, 'configs',
                          'multiview_dfm_r101_waymo_camsync_10sweeps.py')

    # (c) starts first: tools.test with the 10-sweeps config in processes
    # of their own, the full config on the card over the full tree (bf16),
    # the tiny one on the small tree in one process and under two gloo
    # ranks (f32, TF32 off)
    cfg10 = build_detector(load_config(config).model)
    ckpt = os.path.join(trees['full'], 'live10.pth')
    h = init_mvdfm_model(cfg10, torch.float32, 'cpu')
    _live_weights(h['model'], 8, 4.0)
    torch.save(h['model'].state_dict(), ckpt)
    tiny_ckpt = os.path.join(trees['small'], 'tiny10.pth')
    h = init_mvdfm_model(build_detector(merge_options(
        load_config(config), list(MV_CLI_TINY)).model), torch.float32, 'cpu')
    _live_weights(h['model'], 9, 4.0)
    torch.save(h['model'].state_dict(), tiny_ckpt)
    del h
    env = dict(os.environ, PYTHONPATH=here, NVIDIA_TF32_OVERRIDE='0')

    def cli(launcher, data_root, *extra, options=()):
        return subprocess.Popen(
            [*launcher, '-m', 'dfm_tpu_torch.tools.test', config, *extra,
             '--cfg-options', f'data.data_root={data_root}',
             'data.cam_sync=True', *options], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    t_cli = time.perf_counter()
    tiny_args = ('--dtype', 'float32', '--checkpoint', tiny_ckpt)
    procs = dict(
        full=cli([sys.executable], trees['full'], '--checkpoint', ckpt),
        one=cli([sys.executable], trees['small'], *tiny_args,
                options=MV_CLI_TINY),
        two=cli(_torchrun(2), trees['small'], *tiny_args,
                options=MV_CLI_TINY))

    # (a) tiny variants: every output and the detections, card vs CPU
    for name, extra in MV_TEMPORAL_VARIANTS:
        tiny = MVDfMConfig(**dict(MV_TEMPORAL_TINY, **extra))
        imgs, l2i = _mv_inputs(tiny, MV_TEMPORAL_HW, tiny.num_frames, 5)
        flags = _no_tf32()
        outs, dets = {}, {}
        try:
            K.reset_launch_counts()
            for d in ('cpu', dev):
                h = init_mvdfm_model(tiny, torch.float32, d)
                _live_weights(h['model'], 7, 2.0)
                with torch.inference_mode():
                    out = h['model'](imgs.to(d), l2i.to(d))
                    dets[d] = [_detections(mvdfm_predict(out, tiny))]
                outs[d] = {k: v.cpu() for k, v in _flat_outputs(out).items()}
            launches = sum(K.LAUNCHES.values())
        finally:
            _set_tf32(flags)
        check(launches == 0, f'tiny {name}: port kernels launched')
        rel = {k: float((outs[dev][k].double() - v.double()).norm()
                        / v.double().norm()) for k, v in outs['cpu'].items()}
        bad = {k: r for k, r in rel.items() if not r <= MV_STAGE_REL_L2}
        check(not bad, f'tiny {name} card vs CPU (relative L2): {bad}')
        n, worst = _mv_dets_agree(f'tiny {name} dets card vs CPU', dets[dev],
                                  dets['cpu'], MV_DET_TOL)
        check(n > 0, f'tiny {name}: no live detection')
        print(f'temporal (a) tiny {name} f32 (TF32 off) card vs cpu, 1 x '
              f'{tiny.num_frames} frames x {tiny.num_views} views of '
              f'{MV_TEMPORAL_HW}: {len(rel)} outputs, worst relative L2 '
              f'{max(rel.values()):.3g} ({max(rel, key=rel.get)}; tol '
              f'{MV_STAGE_REL_L2}); {n} dets, max abs err score '
              f'{worst[0]:.3g} box {worst[1]:.3g} (tol {MV_DET_TOL}); '
              f'launches 0', flush=True)
        del outs, h, out

    # (c) the CLIs' results
    res = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        check(p.returncode == 0, f'tools.test 10-sweeps ({name}) failed: '
              f'{err[-3000:]}')
        lets = LET_LINE.findall(out)
        check(len(lets) == 15 and all(np.isfinite(float(v))
                                     for _, _, v in lets) and
              '2 frame(s) a sample' in out,
              f'tools.test 10-sweeps ({name}): {len(lets)} LET lines: '
              f'{out[-2000:]}')
        res[name] = out
    cli_s = time.perf_counter() - t_cli
    lines = {k: LET_LINE.findall(res[k]) for k in ('one', 'two')}
    check(lines['one'] == lines['two'], f'tools.test 10-sweeps: two ranks '
          f'{lines["two"]} against one process {lines["one"]}')
    dets = re.findall(r'^\[\d+/\d+\] dets=(\d+)$', res['full'], re.M)
    overall = re.search(r'^Overall mAP: (\S+)$', res['full'], re.M)
    print(f'temporal (c) cli: tools.test with the 10-sweeps config, the full '
          f'config on the card over the tree (2 frames a sample: frame 1 '
          f'with frame 0 as its sweep, frame 0 repeated), dets {dets}, 15 '
          f'LET lines, Overall mAP {overall.group(1)}; the tiny config on '
          f'the small tree under 2 gloo ranks: the 15 LET lines of one '
          f'process; {cli_s:.1f} s for the processes (beside (a))', flush=True)
    # (b) the full 10-sweeps config on frame 1 of the full tree (its sweep
    # is frame 0): bf16 (the default) and f32
    frames = frames_per_sample(load_config(config).data, cfg10)
    check(frames == 2, f'the 10-sweeps config stacks {frames} frames')
    ds = WaymoDataset(trees['full'], os.path.join(
        trees['full'], 'waymo_infos_val.pkl'), num_frames=frames,
        target_hw=MV_HW, cam_sync=True)
    t0 = time.perf_counter()
    sample = ds.get_sample(1)
    decode_ms = (time.perf_counter() - t0) * 1e3
    check(not np.allclose(sample['lidar2img'][0], sample['lidar2img'][1]),
          "frame 1's sweep has the current frame's lidar2img")
    imgs = torch.from_numpy(sample['imgs'])[None].to(dev)
    l2i = torch.from_numpy(sample['lidar2img'])[None].to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        h = init_mvdfm_model(cfg10, dtype)
        model = h['model']
        with torch.no_grad():    # live scores: nms_pre boxes into NMS
            model.bbox_head_3d.conv_cls.bias.fill_(-1.0)
        for _ in range(MV_WARMUP):
            h['infer'](imgs, l2i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        ms = []
        for _ in range(MV_TIMED):
            t0 = time.perf_counter()
            det = h['infer'](imgs, l2i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(not any(launches.values()), f'10-sweeps MultiViewDfM launched '
              f'port kernels: {launches}')
        kept = _finite_dets(det, f'10-sweeps MultiViewDfM {dtype}')
        check(kept > 0, f'10-sweeps MultiViewDfM {dtype}: no live detection')
        runs = [_mv_stages(model, imgs, l2i, cfg10) for _ in range(MV_TIMED)]
        stages = np.median([r[1] for r in runs], 0)
        out = runs[-1][0]
        del runs
        vol = out['volume']
        check(tuple(vol.shape) == (1, 2 * cfg10.feat_channels,
                                   *cfg10.voxel_grid) and
              bool(torch.isfinite(vol).all()), '10-sweeps volume')
        check(tuple(out['bev'].shape) == (1, 256, *cfg10.voxel_grid[1:])
              and bool(torch.isfinite(out['bev']).all()), '10-sweeps BEV')
        trunk = _flops_of(model.image_features, imgs)
        neck = _flops_of(model.neck_3d, vol)
        names = ('trunk+fpn', 'view sample', 'DfMNeck', 'head', 'predict')
        tf32 = (' (TF32 convs '
                f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})'
                if dtype == torch.float32 else '')
        print(f'temporal (b) 10-sweeps full {str(dtype)[6:]}{tf32}, 1 x 2 '
              f'frames x 5 views x 640x960 (frame 1 of the tree and its '
              f'sweep; assembly {decode_ms:.1f} ms, once): ms/request '
              f'{[round(x, 3) for x in ms]} median '
              f'{float(np.median(ms)):.3f}; stages ms (median of '
              f'{MV_TIMED}) ' + ', '.join(
                  f'{n} {x:.3f}' for n, x in zip(names, stages))
              + f'; GFLOP trunk+fpn {trunk / 1e9:.1f} DfMNeck '
              f'{neck / 1e9:.1f} (TFLOP/s {trunk / stages[0] / 1e9:.1f}, '
              f'{neck / stages[2] / 1e9:.1f}); peak_mem_bytes {peak}; kept '
              f'{kept}; port-kernel launches {sum(launches.values())}',
              flush=True)
        del h, model, out, vol, det
        gc.collect()
        torch.cuda.empty_cache()

    # (d) one full-width f32 training step of the 10-sweeps model, B = 1,
    # on that sample, after a warm-up step
    frame = dict(img=sample['imgs'][None],
                 lidar2img=sample['lidar2img'][None],
                 **{k: sample[k][None] for k in ('gt_boxes', 'gt_labels',
                                                 'gt_mask')})
    check(int(sample['gt_mask'].sum()) > 0, '10-sweeps train: no gt box')
    model = init_weights(MultiViewDfM(cfg10)).to(dev)
    step = TrainStep(model, make_optimizer(model), liga_schedule(5e-4))
    for i in range(MV_TEMPORAL_TRAIN_WARMUP + 1):
        if i == MV_TEMPORAL_TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
        t = [time.perf_counter()]
        batch = mv_to_device(frame, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total, losses = step.forward(*batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step.backward(total)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        norm = step.update()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals = {k: float(v.detach()) for k, v in
                dict(loss=total, **losses).items()}
        check(all(np.isfinite(x) for x in vals.values()) and
              np.isfinite(float(norm)), f'10-sweeps train full: {vals}')
    split = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    peak = torch.cuda.max_memory_allocated()
    launches = sum(K.LAUNCHES.values())
    check(launches == 0, f'10-sweeps train full: {dict(K.LAUNCHES)}')
    print(f'temporal (d) 10-sweeps full config training, f32 (TF32 as '
          f'PyTorch has it), B = 1, 1 x 2 x 5 x 640x960 ('
          f'{int(sample["gt_mask"].sum())} gt boxes), one step after '
          f'{MV_TEMPORAL_TRAIN_WARMUP} warm-up, ms (data = host to device, '
          f'forward, backward, optimizer): '
          + ', '.join(f'{x:.3f}' for x in split)
          + f'; total {sum(split):.3f}; peak_mem_bytes {peak}; losses '
          f'{ {k: round(x, 5) for k, x in vals.items()} } grad_norm '
          f'{float(norm):.5g}; port-kernel launches {launches}', flush=True)
    del model, step, total, losses, batch
    gc.collect()
    torch.cuda.empty_cache()

    print(f'temporal phase {time.perf_counter() - t_phase:.1f} s', flush=True)


# phase 12: the mono family (FCOS3D, PGD) on KITTI, no port kernel on its
# path
MONO_TINY = dict(backbone_depth=18, in_channels=64, feat_channels=64,
                 depth_branch=(16,), nms_pre=200, max_num=20)
MONO_TINY_HW = (128, 192)
MONO_HW = (384, 1280)         # the KITTI mono configs' data.img_hw
MONO_LEVEL_REL_L2 = 1e-4      # (a) card vs CPU, float32 with TF32 off
MONO_DET_TOL = (1e-3, 1e-3)   # (a) scores atol; boxes atol + rtol
MONO_LOSS_RTOL = 1e-3         # (a) the loss terms, card vs CPU
MONO_FOLD_REL_L2 = 1e-4       # (b) fused vs unfused, float32, TF32 off
# (b) bf16: the fold may move each output at most this many times as far
# as bf16 itself moves it from the float32 unfused model
MONO_FOLD_BF16_FACTOR = 2.0
MONO_WARMUP, MONO_TIMED = 2, 3
MONO_DET_ATOL = 1e-4          # (c) fused vs unfused CLI detections (f32)
MONO_PAIR_OPTIONS = ('model.nms_thr=1.0',)   # (c) that pair: no suppression
MONO_CONFIGS = ('fcos3d_r101_kitti_mono.py', 'pgd_r101_kitti_mono.py')
PORTED_CONFIGS = MONO_CONFIGS + (
    'dfm_r34_kitti_3class.py', 'multiview_dfm_r101_waymo_camsync.py',
    'multiview_dfm_r101_waymo_camsync_10sweeps.py')


def _mono_dets(det):
    """Padded detections (B, max_num, ...) -> per sample the kept ones as
    `_mv_dets_agree` takes them."""
    det = {k: v.detach().cpu().numpy() for k, v in det.items()}
    out = []
    for i in range(det['mask'].shape[0]):
        m = det['mask'][i].astype(bool)
        out.append(dict(boxes_3d=det['boxes3d'][i][m],
                        scores_3d=det['scores'][i][m],
                        labels_3d=det['labels'][i][m]))
    return out


def _mono_levels(outs):
    """The head's per-level dicts -> name -> the levels' values
    concatenated (float32, on the host)."""
    return {k: torch.cat([o[k].detach().float().reshape(-1).cpu()
                          for o in outs]) for k in outs[0]}


def _rel_l2s(got, want):
    return {k: float((got[k].double() - v.double()).norm()
                     / v.double().norm().clamp(min=1e-30))
            for k, v in want.items()}


def _mono_tiny_step(kind, dev, batch, noise=None, reverse=False):
    """One train-mode forward + backward of the tiny model of `kind` on
    `dev` (seeded live weights, + one ulp of noise with seed `noise`; the
    batch's samples in reverse order with `reverse`): the loss terms,
    every gradient and the BatchNorm statistics."""
    from dfm_tpu_torch.models.builder import mono_model
    from dfm_tpu_torch.runtime.adapters import mono_to_device
    from dfm_tpu_torch.utils.weights import init_weights
    model = _live_weights(init_weights(mono_model(dict(type=kind,
                                                       **MONO_TINY)), 5),
                          6, 3.0)
    model = (model if noise is None else _ulp_noise(model, noise)).to(dev)
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
    img, cam2img, gt = mono_to_device(batch, dev)
    total, losses = model.train().forward_train(img, cam2img, gt)
    total.backward()
    return dict(
        losses={k: float(v) for k, v in dict(loss=total.detach(), **{
            k: v.detach() for k, v in losses.items()}).items()},
        grads={n: None if p.grad is None else p.grad.detach().cpu()
               for n, p in model.named_parameters()},
        stats={n: b.detach().cpu().clone() for n, b in model.named_buffers()
               if n.endswith(('running_mean', 'running_var'))})


def _annos_match(what, got, want):
    """One frame's KITTI annos of two runs: the same names, and each of
    `got`'s detections matched one to one to `want`'s of its name at the
    nearest location (scores within float32 rounding may rank two
    detections in either order); location, dimensions, rotation_y and
    score within MONO_DET_ATOL x (1 + |value|), the 2D box within
    MONO_DET_ATOL x 1242 px. Returns the largest difference."""
    names = np.asarray(want['name'])
    check(sorted(got['name']) == sorted(names), f'{what}: names '
          f'{list(got["name"])} vs {list(names)}')
    loc = np.asarray(want['location'], np.float64)
    taken, err = set(), 0.0
    for i, name in enumerate(got['name']):
        free = [j for j in np.flatnonzero(names == name) if j not in taken]
        d = np.abs(loc[free] - np.asarray(got['location'][i])).max(1)
        j = free[int(np.argmin(d))]
        taken.add(j)
        for k in ('location', 'dimensions', 'rotation_y', 'score', 'bbox'):
            g = np.asarray(got[k], np.float64)[i]
            w = np.asarray(want[k], np.float64)[j]
            diff = float(np.abs(g - w).max())
            tol = MONO_DET_ATOL * 1242 if k == 'bbox' else \
                float((MONO_DET_ATOL * (1 + np.abs(w))).min())
            check(diff <= tol, f'{what} {k}: {g} vs {w}')
            err = max(err, diff)
    return err


def mono_rank(work):
    """One rank of phase 12 (d), started by torchrun on the card: the tiny
    PGD's parity step (TF32 off) on its row of the global batch of 2;
    writes rank<r>.pt to `work`."""
    import hashlib
    import os
    from dfm_tpu_torch.models.builder import mono_model
    from dfm_tpu_torch.parallel import dist as D
    from dfm_tpu_torch.runtime.adapters import mono_to_device
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.utils.weights import init_weights
    dev = D.init_from_env()
    r = D.rank()
    inp = torch.load(os.path.join(work, 'inputs.pt'), weights_only=False)
    model = _live_weights(init_weights(mono_model(dict(type='PGD',
                                                       **MONO_TINY)), 5),
                          6, 3.0).to(dev)
    step = TrainStep(model, make_optimizer(model), liga_schedule(1e-3))
    img, cam2img, gt = D.shard_batch(mono_to_device(inp['batch'], dev))
    flags = _no_tf32()
    try:
        total, losses = step.forward(img, cam2img, gt)
        step.backward(total)
        step.reduce()
        torch.cuda.synchronize()
    finally:
        _set_tf32(flags)
    out = _grads_and_stats(step, total, losses)
    h = hashlib.sha1()
    for n in sorted(out['grads']):
        h.update(out['grads'][n].numpy().tobytes())
    for n in sorted(out['stats']):
        h.update(out['stats'][n].numpy().tobytes())
    out.update(digest=h.hexdigest(), backend=D.backend(),
               world=D.world_size(), device=str(dev),
               reduce_bytes=step.reduce_bytes)
    if r:
        out = {k: v for k, v in out.items() if k not in ('grads', 'stats')}
    torch.save(out, os.path.join(work, f'rank{r}.pt'))
    D.destroy()
    return 0


def mono_phase(dev):
    """12. the mono family: (a) tiny FCOS3D and PGD card vs CPU, (b) the
    full configs timed in bf16 and f32, with and without the BatchNorm
    fold, and one f32 PGD training step, (c) the CLIs on a KITTI tree,
    (d) two gloo ranks of the tiny PGD against one process."""
    import os
    import tempfile
    import threading
    from dfm_tpu_torch.models.builder import mono_model
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    configs = {c: os.path.join(here, 'configs', c) for c in PORTED_CONFIGS}
    pgd_cfg = configs[MONO_CONFIGS[1]]
    env = dict(os.environ, PYTHONPATH=here)
    no_tf32_env = dict(env, NVIDIA_TF32_OVERRIDE='0')

    with tempfile.TemporaryDirectory() as root:
        # (c) starts first: a KITTI tree, create_data, then the CLIs in
        # processes of their own while (a), (b) and (d) run here
        ids = write_kitti_tree(root)
        res = _run([sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
                    'kitti', '--root', root, '--splits', 'train', 'val'])
        check(res.returncode == 0, f'mono create_data: {res.stderr}')
        ckpts = {}
        for i, c in enumerate(MONO_CONFIGS):
            cfg = load_config(configs[c])
            model = _live_weights(init_weights(mono_model(cfg.model)),
                                  20 + i, 3.0)
            ckpts[c] = os.path.join(root, f'live_{i}.pth')
            torch.save(model.state_dict(), ckpts[c])
            del model
        procs, cli = {}, {}

        def start(name, cmd, e=env):
            procs[name] = subprocess.Popen(
                [sys.executable, '-m', *cmd], cwd=here, env=e,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def test_cmd(c, *extra, options=()):
            return ['dfm_tpu_torch.tools.test', configs[c], '--checkpoint',
                    ckpts[c], *extra, '--cfg-options',
                    f'data.data_root={root}', *options]

        t_cli = time.perf_counter()
        for c in MONO_CONFIGS:
            tag = c.split('_')[0]
            start(f'{tag} bf16', test_cmd(c))
            # the fused / unfused pair without NMS's suppression: an IoU
            # within float32 rounding of nms_thr (some 5e5 pairs of the
            # 1,000 candidates of random weights) would keep another box
            for fused in (False, True):
                out = os.path.join(root, f'{tag}_{int(fused)}.pkl')
                start(f'{tag} f32{" fused" * fused}', test_cmd(
                    c, '--dtype', 'float32', '--out', out,
                    *(['--fuse-conv-bn'] if fused else []),
                    options=MONO_PAIR_OPTIONS), no_tf32_env)
        for c in PORTED_CONFIGS:
            start(f'synthetic {c}', ['dfm_tpu_torch.tools.test', configs[c],
                                     '--synthetic'])
        work = os.path.join(root, 'w')
        train = ['dfm_tpu_torch.tools.train', pgd_cfg, '--work-dir', work,
                 '--cfg-options', f'data.data_root={root}', '--max-steps']

        chain_procs = {}

        def train_chain():
            for name, cmd in (('train', train + ['2']),
                              ('resume', train + ['3', '--auto-resume']),
                              ('trained', [
                                  'dfm_tpu_torch.tools.test', pgd_cfg,
                                  '--checkpoint',
                                  os.path.join(work, 'ckpts', 'step_3.pth'),
                                  '--cfg-options',
                                  f'data.data_root={root}'])):
                p = chain_procs[name] = subprocess.Popen(
                    [sys.executable, '-m', *cmd], cwd=here, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                out, err = p.communicate(timeout=900)
                cli[name] = subprocess.CompletedProcess(p.args, p.returncode,
                                                        out, err)
                if p.returncode:
                    return

        chain = threading.Thread(target=train_chain)
        chain.start()
        try:
            _mono_checks(dev, root, ids, configs, procs, chain, cli, work,
                         t_cli)
        finally:
            for p in list(procs.values()) + list(chain_procs.values()):
                if p.poll() is None:
                    p.kill()
            chain.join()
    print(f'mono phase {time.perf_counter() - t_phase:.1f} s', flush=True)


def _mono_checks(dev, root, ids, configs, procs, chain, cli, work, t_cli):
    """Phase 12 (a), (d), the CLIs' results (c) and (b), while the CLIs
    that `mono_phase` started run."""
    import os
    import pickle
    from dfm_tpu_torch.apis import init_mono_model
    from dfm_tpu_torch.data.kitti import build_kitti_infos
    from dfm_tpu_torch.data.kitti_mono import (load_mono_image,
                                               mono_info_from_native)
    from dfm_tpu_torch.models.builder import (build_detector,
                                              mono_backbone_depth,
                                              mono_model)
    from dfm_tpu_torch.models.detectors.fcos_mono3d import (
        fcos_mono3d_predict)
    from dfm_tpu_torch.models.layers import BatchNorm
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.train import KittiMonoSource, optimizer_digest
    from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    pgd_cfg = configs[MONO_CONFIGS[1]]

    # (a) tiny FCOS3D and PGD card vs CPU, f32, TF32 off
    batch = mono_synth(2, 11, *MONO_TINY_HW, kpts=True)
    flags = _no_tf32()
    try:
        for kind in ('FCOSMono3D', 'PGD'):
            cfg = build_detector(dict(type=kind, **MONO_TINY))
            outs, dets = {}, {}
            K.reset_launch_counts()
            for d in ('cpu', dev):
                model = _live_weights(init_weights(mono_model(dict(
                    type=kind, **MONO_TINY)), 5), 6, 3.0).to(d).eval()
                img, cam2img, _ = mono_to_device(batch, d)
                with torch.inference_mode():
                    o = model(img)
                    dets[d] = _mono_dets(fcos_mono3d_predict(
                        o, MONO_TINY_HW, cam2img, cfg))
                outs[d] = _mono_levels(o)
            # the movers: two ulp noises and the batch reversed (the
            # BatchNorm moments' summation order, see (d))
            cpu = _mono_tiny_step(kind, 'cpu', batch)
            movers = tuple(_mono_tiny_step(kind, 'cpu', batch, seed)
                           for seed in (1, 2)) + (_mono_tiny_step(
                               kind, 'cpu', batch, reverse=True),)
            card = _mono_tiny_step(kind, dev, batch)
            launches = sum(K.LAUNCHES.values())
            check(launches == 0, f'mono tiny {kind}: port kernels '
                  f'launched {dict(K.LAUNCHES)}')
            rel = _rel_l2s(outs[dev], outs['cpu'])
            bad = {k: r for k, r in rel.items()
                   if not r <= MONO_LEVEL_REL_L2}
            check(not bad, f'mono tiny {kind} card vs CPU levels: {bad}')
            n, worst = _mv_dets_agree(f'mono tiny {kind} dets',
                                      dets[dev], dets['cpu'],
                                      MONO_DET_TOL)
            check(n > 0, f'mono tiny {kind}: no live detection')
            loss_err = _losses_agree(f'mono tiny {kind} step',
                                     card['losses'], cpu['losses'],
                                     MONO_LOSS_RTOL)
            g = _grad_compare(f'mono tiny {kind} gradients',
                              card['grads'], cpu['grads'],
                              tuple(m['grads'] for m in movers))
            print(f'mono (a) tiny {kind} (ResNet-18, width 64) f32 '
                  f'(TF32 off) card vs cpu, 2 x {MONO_TINY_HW}: '
                  f'{len(rel)} outputs, worst relative L2 '
                  f'{max(rel.values()):.3g} ({max(rel, key=rel.get)}; '
                  f'tol {MONO_LEVEL_REL_L2}); {n} dets, max abs err '
                  f'score {worst[0]:.3g} box {worst[1]:.3g} (tol '
                  f'{MONO_DET_TOL}); step: {len(cpu["losses"])} terms, '
                  f'worst rel {loss_err:.3g} (rtol {MONO_LOSS_RTOL}), '
                  f'gradients worst relative L2 {g[0]:.3g} ({g[1]}), '
                  f'whole {g[2]:.3g} (under the movers, two ulp noises '
                  f'and the batch reversed: {g[3]:.3g}); launches 0',
                  flush=True)
            del model, o, cpu, card, movers
    finally:
        _set_tf32(flags)

    # (d) two gloo ranks of the tiny PGD (B = 1 each) against this
    # process at B = 2, by phase 10 (b)'s rule (TF32 off), with one
    # more mover: this process's step on the batch in reverse order.
    # BatchNorm's E[x^2] - E[x]^2 (JAX's formula) cancels in float32
    # for channels whose mean dwarfs their spread; the order of its
    # sums moves a few gradients of the tiny model by ~1e-2 (CPU,
    # seeded live weights), which weight noise does not reach
    flags = _no_tf32()
    try:
        def one_step(noise=None, reverse=False):
            model = _live_weights(init_weights(mono_model(dict(
                type='PGD', **MONO_TINY)), 5), 6, 3.0)
            model = (model if noise is None else
                     _ulp_noise(model, noise)).to(dev)
            step = TrainStep(model, make_optimizer(model),
                             liga_schedule(1e-3))
            b = {k: v[::-1].copy() for k, v in batch.items()} \
                if reverse else batch
            total, losses = step.forward(*mono_to_device(b, dev))
            step.backward(total)
            step.reduce()
            return _grads_and_stats(step, total, losses)

        one, again = one_step(), one_step()
        movers = [one_step(seed) for seed in (1, 2)] + \
            [one_step(reverse=True)]
    finally:
        _set_tf32(flags)
    ddp_dir = os.path.join(root, 'ddp')
    os.makedirs(ddp_dir)
    torch.save(dict(batch=batch), os.path.join(ddp_dir, 'inputs.pt'))
    t0 = time.perf_counter()
    res = _run(_torchrun(2, os.path.join(here, 'chip_smoke.py'),
                         '--mono-rank', ddp_dir), timeout=600)
    ranks_s = time.perf_counter() - t0
    check(res.returncode == 0, f'mono (d) ranks: {res.stderr[-3000:]}')
    ranks = [torch.load(os.path.join(ddp_dir, f'rank{r}.pt'),
                        weights_only=False) for r in range(2)]
    check(all(o['backend'] == 'gloo' and o['world'] == 2 for o in ranks),
          f'mono (d): {[(o["backend"], o["world"]) for o in ranks]}')
    check(ranks[0]['digest'] == ranks[1]['digest'], "mono (d): the two "
          "ranks' gradients or BatchNorm statistics differ")
    line = _ddp_compare('mono (d) two ranks', ranks[0], one, movers,
                        again)
    print(f'mono (d) two ranks on one card (gloo), tiny PGD f32, B = 1 '
          f'each, against one process at B = 2 (TF32 off; movers: two '
          f'ulp noises and the batch reversed): {line}; '
          f'all-reduce {ranks[0]["reduce_bytes"]} bytes; '
          f'{ranks_s:.1f} s for the two processes', flush=True)
    del one, again, movers, ranks
    gc.collect()

    # (c) the CLIs' results, before anything is timed
    for name, p in procs.items():
        out, err = p.communicate(timeout=900)
        check(p.returncode == 0, f'mono (c) {name}: {err[-3000:]}')
        cli[name] = subprocess.CompletedProcess(p.args, p.returncode,
                                                out, err)
    chain.join()
    cli_s = time.perf_counter() - t_cli
    for name in ('train', 'resume', 'trained'):
        check(name in cli and cli[name].returncode == 0,
              f'mono (c) {name}: '
              f'{cli[name].stderr[-3000:] if name in cli else "not run"}')
    aps = {}
    for name, r in cli.items():
        if name.startswith('synthetic'):
            check('finite=True' in r.stdout, f'mono (c) {name}: '
                  f'{r.stdout[-1500:]}')
            continue
        if name in ('train', 'resume'):
            continue
        found = AP_LINE.findall(r.stdout)
        check(len(found) == 36 and all(np.isfinite(float(v))
                                       for _, v in found),
              f'mono (c) {name}: {len(found)} AP lines: '
              f'{r.stdout[-1500:]}')
        aps[name] = re.findall(r'^\S+: \S+$', r.stdout, re.M)
    worst = {}
    for c in MONO_CONFIGS:
        tag = c.split('_')[0]
        # every BatchNorm of the model (ResNet-101: the stem, 33 blocks
        # x 3 and 4 downsamples, 104)
        n_bn = sum(isinstance(m, BatchNorm) for m in mono_model(
            load_config(configs[c]).model).modules())
        check(f'[fuse] {n_bn} BatchNorm(s) folded' in
              cli[f'{tag} f32 fused'].stdout, f'mono (c) {tag}: '
              f'{cli[f"{tag} f32 fused"].stdout[-1000:]}')
        annos = []
        for fused in (0, 1):
            with open(os.path.join(root, f'{tag}_{fused}.pkl'),
                      'rb') as f:
                annos.append(pickle.load(f))
        err = max(_annos_match(f'mono (c) {tag} fused', f, p)
                  for p, f in zip(*annos))
        worst[tag] = (err, sum(len(a['name']) for a in annos[0]),
                      aps[f'{tag} f32 fused'] == aps[f'{tag} f32'])
        car = [re.search(r'^Car_3d_moderate_strict: (\S+)$',
                         cli[f'{tag} {k}'].stdout, re.M).group(1)
               for k in ('bf16', 'f32', 'f32 fused')]
        pairs = zip(aps[f'{tag} f32 fused'], aps[f'{tag} f32'])
        print(f'mono (c) {tag} Car_3d_moderate_strict bf16 / f32 / f32 '
              f'fused: {" / ".join(car)}; the 36 AP lines, f32 fused / '
              f'unfused: ' + ', '.join(
                  f'{a.split(": ")[0]} {a.split(": ")[1]}/'
                  f'{b.split(": ")[1]}' for a, b in pairs), flush=True)
    digest = optimizer_digest(torch.load(
        os.path.join(work, 'ckpts', 'step_2.pth'), map_location='cpu',
        weights_only=True)['optimizer'])
    check(f'resumed from step 2 (optimizer state sha1 {digest})'
          in cli['resume'].stdout and 'step 3/3' in cli['resume'].stdout,
          f'mono (c) resume: {cli["resume"].stdout[-2000:]}')
    step2 = re.search(r'^step 2/2 .*$', cli['train'].stdout, re.M)
    check(step2 is not None and 'loss_consistency=' in step2.group(0),
          f'mono (c) train: {cli["train"].stdout[-1000:]}')
    print(f'mono (c) cli: tools.test on both configs (full width, live '
          f'checkpoints, the tree\'s 4 frames): 36 finite AP lines each '
          f'in bf16, in f32 (TF32 off) and in f32 with --fuse-conv-bn, '
          f'those two with {" ".join(MONO_PAIR_OPTIONS)}; '
          f'fused vs unfused f32 detections (count, max abs err, AP '
          f'lines equal): ' + ', '.join(
              f'{t} {n} {e:.3g} {eq}' for t, (e, n, eq) in worst.items())
          + f' (tol {MONO_DET_ATOL} x (1 + |value|), the 2D boxes '
          f'{MONO_DET_ATOL} x 1242 px); --synthetic finite on {len(PORTED_CONFIGS)} configs; '
          f'tools.train PGD 2 steps ({step2.group(0)[:200]}...), resume '
          f'to 3 (optimizer sha1 {digest}), tools.test on step_3.pth: '
          f'36 AP lines; {cli_s:.1f} s for the processes', flush=True)
    # (b) the full configs at 1 x 384 x 1280 (frame 0 of the tree)
    info0 = build_kitti_infos(root, ids[:1])[0]
    mono_info = mono_info_from_native(info0, root, MONO_HW)
    img = torch.from_numpy(load_mono_image(mono_info['image_path'],
                                           MONO_HW))[None].to(dev)
    cam2img = torch.from_numpy(mono_info['calib']['P2'])[None].to(dev)
    for c in MONO_CONFIGS:
        mc = load_config(configs[c]).model
        cfg = build_detector(mc)
        ref = {}
        for dtype in (torch.float32, torch.bfloat16):
            h = init_mono_model(cfg, mono_backbone_depth(mc), dtype)
            model = h['model']
            head = getattr(model.bbox_head, 'fcos3d', model.bbox_head)
            with torch.no_grad():   # live scores: nms_pre boxes in NMS
                head.conv_cls.bias.fill_(0.0)
            for fused in (False, True):
                if fused:
                    n_fold = fuse_conv_bn(model)
                flags = _no_tf32()
                try:
                    with torch.inference_mode():
                        levels = _mono_levels(model(img))
                finally:
                    _set_tf32(flags)
                ref[(dtype, fused)] = levels
                for _ in range(MONO_WARMUP):
                    h['infer'](img, cam2img)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
                ms = []
                for _ in range(MONO_TIMED):
                    t0 = time.perf_counter()
                    det = h['infer'](img, cam2img)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                peak = torch.cuda.max_memory_allocated()
                launches = sum(K.LAUNCHES.values())
                check(launches == 0, f'{c}: port kernels launched')
                kept = _finite_dets(det, f'{c} {dtype}')
                stages = []
                for _ in range(MONO_TIMED):
                    t = [time.perf_counter()]
                    with torch.inference_mode():
                        feats = model.features(img)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        outs = model.bbox_head(feats)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        fcos_mono3d_predict(outs, MONO_HW, cam2img, cfg)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                    stages.append([(b - a) * 1e3 for a, b in
                                   zip(t, t[1:])])
                st = np.median(stages, 0)
                trunk = _flops_of(model.features, img)
                headf = _flops_of(model.bbox_head, feats)
                tf32 = ('' if dtype == torch.bfloat16 else
                        f' (TF32 convs '
                        f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})')
                fold = f', BatchNorm folded ({n_fold})' if fused else ''
                print(f'mono (b) {c} {str(dtype)[6:]}{tf32}{fold}, 1 x '
                      f'{MONO_HW[0]}x{MONO_HW[1]}: ms/request '
                      f'{[round(x, 3) for x in ms]} median '
                      f'{float(np.median(ms)):.3f}; stages ms (median '
                      f'of {MONO_TIMED}) trunk+fpn {st[0]:.3f}, head '
                      f'{st[1]:.3f}, predict {st[2]:.3f}; GFLOP '
                      f'trunk+fpn {trunk / 1e9:.1f} head '
                      f'{headf / 1e9:.1f} (TFLOP/s '
                      f'{trunk / st[0] / 1e9:.1f}, '
                      f'{headf / st[1] / 1e9:.1f}); peak_mem_bytes '
                      f'{peak}; kept {kept}; port-kernel launches '
                      f'{launches}', flush=True)
                del feats, outs, det
            del h, model, head
            gc.collect()
            torch.cuda.empty_cache()
        f32 = _rel_l2s(ref[(torch.float32, True)],
                       ref[(torch.float32, False)])
        bf16 = _rel_l2s(ref[(torch.bfloat16, True)],
                        ref[(torch.bfloat16, False)])
        level = _rel_l2s(ref[(torch.bfloat16, False)],
                         ref[(torch.float32, False)])
        bad = {k: r for k, r in f32.items() if not r <= MONO_FOLD_REL_L2}
        check(not bad, f'{c} f32 fold vs unfused: {bad}')
        bad = {k: (r, level[k]) for k, r in bf16.items()
               if not r <= MONO_FOLD_BF16_FACTOR * level[k]}
        check(not bad, f'{c} bf16 fold vs unfused (against bf16 vs f32): '
              f'{bad}')
        print(f'mono (b) {c} fold vs unfused, relative L2 per output: '
              f'f32 (TF32 off) worst {max(f32.values()):.3g} (tol '
              f'{MONO_FOLD_REL_L2}); bf16 '
              + ', '.join(f'{k} {bf16[k]:.3g} (bf16 vs f32 '
                          f'{level[k]:.3g})' for k in bf16)
              + f' (tol {MONO_FOLD_BF16_FACTOR}x bf16 vs f32)',
              flush=True)

    # (b) one full-width f32 PGD training step at B = 2 after a warm-up
    pcfg = merge_options(load_config(pgd_cfg),
                         [f'data.data_root={root}'])
    source = KittiMonoSource(pcfg, 2)
    model = init_weights(mono_model(pcfg.model)).to(dev)
    step = TrainStep(model, make_optimizer(model), liga_schedule(2e-3))
    rng = np.random.default_rng(0)
    for i in range(2):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
        t = [time.perf_counter()]
        inputs = source.next_batch(i, rng, dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total, losses = step.forward(*inputs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step.backward(total)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        norm = step.update()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals = {k: float(v.detach()) for k, v in
                dict(loss=total, **losses).items()}
        check(all(np.isfinite(x) for x in vals.values()) and
              np.isfinite(float(norm)), f'PGD train full: {vals}')
    split = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    peak = torch.cuda.max_memory_allocated()
    launches = sum(K.LAUNCHES.values())
    check(launches == 0, f'PGD train full: {dict(K.LAUNCHES)}')
    print(f'mono (b) PGD full config training, f32 (TF32 as PyTorch has '
          f'it), B = 2, 2 x {MONO_HW[0]}x{MONO_HW[1]} KITTI images of the '
          f'tree, one step after a warm-up, ms (data = decode + resize '
          f'+ host to device, forward, backward, optimizer): '
          + ', '.join(f'{x:.3f}' for x in split)
          + f'; total {sum(split):.3f}; peak_mem_bytes {peak}; losses '
          f'{ {k: round(x, 4) for k, x in vals.items()} } grad_norm '
          f'{float(norm):.5g}; port-kernel launches {launches}',
          flush=True)
    del model, step, total, losses, inputs
    gc.collect()
    torch.cuda.empty_cache()


# phase 13: SMOKE and MonoFlex (DLA-34, the DLA neck's DCNv2) on KITTI, no
# port kernel on their path
DLA_CONFIGS = ('smoke_dla34_kitti.py', 'monoflex_dla34_kitti.py')
DLA_TINY_HW = (64, 96)
DLA_HW = MONO_HW              # a KITTI image resized, as the mono configs
DLA_KITTI = ('data.type=KittiMono',)   # SMOKE on the KITTI tree
DCN_REL_L2 = 1e-5             # (a) the op and its gradients, card vs CPU
DLA_REL_L2 = 1e-4             # (a) dense outputs card vs CPU, f32, TF32 off
DLA_DET_TOL = (1e-5, 1e-4)    # (a) decode of the same outputs
DLA_LOSS_RTOL = 1e-3          # (a) loss terms card vs CPU
DCN_OFFSET_SCALE = 8.0        # conv_offset std x sqrt(fan_in): +-3 px and
DCN_STEP_SCALE = 1.0          # more; the steps' (see tests/test_torch_smoke)
DCN_LAYER_HW = (96, 320)      # the neck's stride-4 map at 384x1280
DLA_TRAIN_BATCH = {'SMOKEMono3D': 8, 'MonoFlex': 4}   # the configs' per chip


def live_dcn(model, seed, scale=DCN_OFFSET_SCALE):
    """Seeded offset convs in every `DeformConv2d` of `model` (a CPU
    generator): weights normal with std scale / sqrt(fan_in), biases std
    0.5: offsets of a few pixels (some taps off the map), mask logits away
    from 0 (the port's and JAX's zero init hides a wrong offset layout)."""
    from dfm_tpu_torch.models.layers import DeformConv2d
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv2d):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=g) * scale /
                        float(w[0].numel()) ** 0.5)
                m.conv_offset.bias.copy_(
                    torch.randn(m.conv_offset.bias.shape, generator=g) * 0.5)
    return model


def _dla_model(kind, seed, scale=DCN_OFFSET_SCALE, **opts):
    from dfm_tpu_torch.models.builder import mono_model
    from dfm_tpu_torch.utils.weights import init_weights
    return live_dcn(_live_weights(init_weights(mono_model(dict(
        type=kind, **opts)), seed), seed + 1, 0.0), seed + 2, scale)


def _dcn_case(stride, dilation, modulated, seed):
    """Inputs of one op case at the neck's widths: x (2, 64, 48, 80),
    offsets in +-3 px (a quarter on integer coordinates), the mask, the
    weight, the output's cotangent."""
    g = torch.Generator().manual_seed(seed)
    ho, wo = (48 - 1) // stride + 1, (80 - 1) // stride + 1
    off = (torch.randn(2, 18, ho, wo, generator=g) * 1.5).clamp(-3, 3)
    whole = torch.rand(off.shape, generator=g) < 0.25
    off = torch.where(whole, off.round(), off)
    return dict(x=torch.randn(2, 64, 48, 80, generator=g), off=off,
                mask=torch.rand(2, 9, ho, wo, generator=g)
                if modulated else None,
                w=torch.randn(64, 64, 3, 3, generator=g) * 0.05,
                cot=torch.randn(2, 64, ho, wo, generator=g))


def _dcn_run(case, dev, stride, dilation):
    """The op's output and its four gradients on `dev`, on the host."""
    from dfm_tpu_torch.ops.deform_conv import deform_conv2d
    args = {k: None if v is None else
            v.detach().clone().to(dev).requires_grad_(k != 'cot')
            for k, v in case.items()}
    out = deform_conv2d(args['x'], args['off'], args['mask'], args['w'],
                        stride, dilation)
    (out * args['cot']).sum().backward()
    res = dict(out=out.detach().cpu())
    for k in ('x', 'off', 'mask', 'w'):
        if args[k] is not None:
            res[f'd{k}'] = args[k].grad.cpu()
    return res


def _dla_step(kind, dev, batch, noise=None, reverse=False):
    """One train-mode forward + backward of the DLA model of `kind` with
    live offsets at the steps' scale (`_mono_tiny_step` for DLA): the loss
    terms, every gradient (zero where the loss does not reach) and the
    BatchNorm statistics."""
    from dfm_tpu_torch.runtime.adapters import mono_to_device
    opts = dict(use_edge_fusion=True) if kind == 'MonoFlex' else {}
    model = _dla_model(kind, 30, DCN_STEP_SCALE, **opts)
    model = (model if noise is None else _ulp_noise(model, noise)).to(dev)
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
    img, cam2img, gt = mono_to_device(batch, dev)
    total, losses = model.train().forward_train(img, cam2img, gt)
    total.backward()
    return dict(
        losses={k: float(v) for k, v in dict(loss=total.detach(), **{
            k: v.detach() for k, v in losses.items()}).items()},
        grads={n: (torch.zeros_like(p) if p.grad is None else p.grad)
               .detach().cpu() for n, p in model.named_parameters()})


def dla_phase(dev):
    """13. SMOKE and MonoFlex: (a) the DCN op, the DCN ResNet-18 and the
    tiny-input models card vs CPU, (b) the full configs timed in bf16 and
    f32, unfused and folded, the neck's deformable layers apart, one f32
    training step of each at its per-chip batch, (c) the CLIs on a KITTI
    tree."""
    import os
    import tempfile
    import threading
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    configs = {c: os.path.join(here, 'configs', c) for c in DLA_CONFIGS}
    smoke_cfg, flex_cfg = (configs[c] for c in DLA_CONFIGS)
    env = dict(os.environ, PYTHONPATH=here)
    no_tf32_env = dict(env, NVIDIA_TF32_OVERRIDE='0')

    with tempfile.TemporaryDirectory() as root:
        # (c) starts first: a KITTI tree, create_data, then the CLIs in
        # processes of their own while (a) runs here
        ids = write_kitti_tree(root)
        res = _run([sys.executable, '-m', 'dfm_tpu_torch.tools.create_data',
                    'kitti', '--root', root, '--splits', 'train', 'val'])
        check(res.returncode == 0, f'dla create_data: {res.stderr}')
        live = os.path.join(root, 'smoke_live.pth')
        torch.save(_dla_model('SMOKEMono3D', 40).state_dict(), live)
        procs, cli = {}, {}
        kitti = ['--cfg-options', f'data.data_root={root}', *DLA_KITTI]

        def start(name, cmd, e=env):
            procs[name] = subprocess.Popen(
                [sys.executable, '-m', *cmd], cwd=here, env=e,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        t_cli = time.perf_counter()
        test = ['dfm_tpu_torch.tools.test', smoke_cfg, '--checkpoint', live]
        start('smoke bf16', test + kitti)
        for fused in (False, True):
            start(f'smoke f32{" fused" * fused}', test + [
                '--dtype', 'float32', '--out',
                os.path.join(root, f'smoke_{int(fused)}.pkl')]
                + ['--fuse-conv-bn'] * fused + kitti, no_tf32_env)
        for c in DLA_CONFIGS:
            start(f'synthetic {c}', ['dfm_tpu_torch.tools.test', configs[c],
                                     '--synthetic'])
        start('monoflex train', ['dfm_tpu_torch.tools.train', flex_cfg,
                                 '--synthetic', '--max-steps', '2',
                                 '--work-dir', os.path.join(root, 'wf')])
        start('smoke refused', ['dfm_tpu_torch.tools.test', smoke_cfg,
                                '--cfg-options', f'data.data_root={root}'])
        start('monoflex refused', ['dfm_tpu_torch.tools.train', flex_cfg,
                                   '--work-dir', os.path.join(root, 'wr')])
        work = os.path.join(root, 'w')
        train = ['dfm_tpu_torch.tools.train', smoke_cfg, '--work-dir', work,
                 *kitti, '--max-steps']
        chain = [('train', train + ['2']),
                 ('resume', train + ['3', '--auto-resume'])]
        chain_procs = {}

        def train_chain():
            for name, cmd in chain:
                p = chain_procs[name] = subprocess.Popen(
                    [sys.executable, '-m', *cmd], cwd=here, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
                out, err = p.communicate(timeout=900)
                cli[name] = subprocess.CompletedProcess(p.args, p.returncode,
                                                        out, err)
                if p.returncode:
                    return

        thread = threading.Thread(target=train_chain)
        thread.start()
        try:
            _dla_parity(dev)
            for name, p in procs.items():
                out, err = p.communicate(timeout=900)
                cli[name] = subprocess.CompletedProcess(p.args, p.returncode,
                                                        out, err)
            thread.join()
            for name, _ in chain:
                check(name in cli and cli[name].returncode == 0,
                      f'dla (c) {name}: {cli[name].stderr[-3000:]}'
                      if name in cli else f'dla (c) {name}: not run')
            _dla_cli_checks(root, cli, work, time.perf_counter() - t_cli)
            _dla_timed(dev, root, ids, configs)
        finally:
            for p in list(procs.values()) + list(chain_procs.values()):
                if p.poll() is None:
                    p.kill()
            thread.join()
    print(f'dla phase {time.perf_counter() - t_phase:.1f} s', flush=True)


def _dla_parity(dev):
    """13 (a): card vs CPU, float32 with TF32 off."""
    from dfm_tpu_torch.models.backbones.resnet import ResNet
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
    from dfm_tpu_torch.utils.weights import init_weights
    flags = _no_tf32()
    try:
        K.reset_launch_counts()
        worst = {}
        for stride, dilation, modulated in ((1, 1, True), (2, 1, True),
                                            (1, 2, False)):
            case = _dcn_case(stride, dilation, modulated, 50 + stride)
            cpu, card = (_dcn_run(case, d, stride, dilation)
                         for d in ('cpu', dev))
            rel = _rel_l2s(card, cpu)
            bad = {k: r for k, r in rel.items() if not r <= DCN_REL_L2}
            check(not bad, f'dcn op s{stride} d{dilation} card vs CPU: {bad}')
            worst[(stride, dilation, modulated)] = max(rel.values())
        resnet = live_dcn(init_weights(ResNet(18, stage_with_dcn=(
            False, True, True, True)), 7), 8).eval()
        x = torch.randn(2, 3, *DLA_TINY_HW,
                        generator=torch.Generator().manual_seed(9))
        with torch.inference_mode():
            outs = {d: [o.cpu() for o in resnet.to(d)(x.to(d))]
                    for d in ('cpu', dev)}
        res_rel = max(_rel_l2s(dict(enumerate(outs[dev])),
                               dict(enumerate(outs['cpu']))).values())
        check(res_rel <= DLA_REL_L2, f'DCN ResNet-18 card vs CPU: {res_rel}')
        print(f'dla (a) DCNv2 op card vs CPU f32 (TF32 off), x (2, 64, 48, '
              f'80), offsets +-3 px: worst relative L2 of the output and '
              f'the four gradients per (stride, dilation, mask): '
              + ', '.join(f'{k} {v:.3g}' for k, v in worst.items())
              + f' (tol {DCN_REL_L2}); DCN ResNet-18 (stages 2-4) live '
              f'offsets, 2 x {DLA_TINY_HW}: {res_rel:.3g} (tol '
              f'{DLA_REL_L2})', flush=True)
        batch = mono_synth(2, 11, *DLA_TINY_HW, flex=True)
        for kind in ('SMOKEMono3D', 'MonoFlex'):
            opts = dict(use_edge_fusion=True) if kind == 'MonoFlex' else {}
            model = _dla_model(kind, 20, **opts).eval()
            img, cam2img, _ = mono_to_device(batch, 'cpu')
            outs, dets = {}, {}
            for d in ('cpu', dev):
                with torch.inference_mode():
                    o = model.to(d)(img.to(d))
                    outs[d] = {k: v.cpu() for k, v in o.items()}
                    # the decode of the CPU's outputs: the same peaks
                    shared = {k: v.to(d) for k, v in outs['cpu'].items()}
                    dets[d] = _mono_dets(model.predict(
                        shared, DLA_TINY_HW, cam2img.to(d)))
            rel = _rel_l2s(outs[dev], outs['cpu'])
            bad = {k: r for k, r in rel.items() if not r <= DLA_REL_L2}
            check(not bad, f'dla tiny {kind} card vs CPU: {bad}')
            n, dw = _mv_dets_agree(f'dla tiny {kind} dets', dets[dev],
                                   dets['cpu'], DLA_DET_TOL)
            check(n > 0, f'dla tiny {kind}: no live detection')
            # the deformable layers carry rounding into their sample
            # points: three ulp noises and the batch reversed
            cpu = _dla_step(kind, 'cpu', batch)
            movers = tuple(_dla_step(kind, 'cpu', batch, seed)
                           for seed in (1, 2, 3)) + (_dla_step(
                               kind, 'cpu', batch, reverse=True),)
            card = _dla_step(kind, dev, batch)
            loss_err = _losses_agree(f'dla tiny {kind} step',
                                     card['losses'], cpu['losses'],
                                     DLA_LOSS_RTOL)
            g = _grad_compare(f'dla tiny {kind} gradients', card['grads'],
                              cpu['grads'], tuple(m['grads'] for m in movers))
            print(f'dla (a) tiny-input {kind}'
                  f'{" (edge fusion)" * bool(opts)} f32 (TF32 off) card vs '
                  f'cpu, 2 x {DLA_TINY_HW}, live offsets: {len(rel)} '
                  f'outputs, worst relative L2 {max(rel.values()):.3g} '
                  f'({max(rel, key=rel.get)}; tol {DLA_REL_L2}); decode of '
                  f'the same outputs: {n} dets, max abs err score '
                  f'{dw[0]:.3g} box {dw[1]:.3g}; step: {len(cpu["losses"])} '
                  f'terms, worst rel {loss_err:.3g} (rtol {DLA_LOSS_RTOL}), '
                  f'gradients worst relative L2 {g[0]:.3g} ({g[1]}), whole '
                  f'{g[2]:.3g} (movers: three ulp noises and the batch '
                  f'reversed: {g[3]:.3g})', flush=True)
            del model, cpu, card, movers
        check(sum(K.LAUNCHES.values()) == 0,
              f'dla (a): port kernels launched {dict(K.LAUNCHES)}')
    finally:
        _set_tf32(flags)
    gc.collect()
    torch.cuda.empty_cache()


def _dla_cli_checks(root, cli, work, cli_s):
    """13 (c): the CLIs' results."""
    import os
    import pickle
    from dfm_tpu_torch.tools.train import optimizer_digest
    for name, r in cli.items():
        if name.endswith('refused'):
            check(r.returncode == 2 and '--synthetic' in r.stderr,
                  f'dla (c) {name}: rc {r.returncode} {r.stderr[-500:]}')
        else:
            check(r.returncode == 0, f'dla (c) {name}: {r.stderr[-3000:]}')
    for c in DLA_CONFIGS:
        check('finite=True' in cli[f'synthetic {c}'].stdout,
              f'dla (c) synthetic {c}: {cli[f"synthetic {c}"].stdout[-800:]}')
    aps = {}
    for name in ('smoke bf16', 'smoke f32', 'smoke f32 fused'):
        found = AP_LINE.findall(cli[name].stdout)
        check(len(found) == 36 and all(np.isfinite(float(v))
                                       for _, v in found),
              f'dla (c) {name}: {len(found)} AP lines: '
              f'{cli[name].stdout[-1500:]}')
        aps[name] = re.search(r'^Car_3d_moderate_strict: (\S+)$',
                              cli[name].stdout, re.M).group(1)
    check('[fuse] 55 BatchNorm(s) folded' in cli['smoke f32 fused'].stdout,
          f'dla (c) fold: {cli["smoke f32 fused"].stdout[-800:]}')
    annos = []
    for fused in (0, 1):
        with open(os.path.join(root, f'smoke_{fused}.pkl'), 'rb') as f:
            annos.append(pickle.load(f))
    err = max(_annos_match('dla (c) smoke fused', f, p)
              for p, f in zip(*annos))
    n_det = sum(len(a['name']) for a in annos[0])
    digest = optimizer_digest(torch.load(
        os.path.join(work, 'ckpts', 'step_2.pth'), map_location='cpu',
        weights_only=True)['optimizer'])
    check(f'resumed from step 2 (optimizer state sha1 {digest})'
          in cli['resume'].stdout and 'step 3/3' in cli['resume'].stdout,
          f'dla (c) resume: {cli["resume"].stdout[-2000:]}')
    step2 = re.search(r'^step 2/2 .*$', cli['train'].stdout, re.M)
    flex2 = re.search(r'^step 2/2 .*$', cli['monoflex train'].stdout, re.M)
    check(step2 is not None and 'loss_bbox=' in step2.group(0) and
          flex2 is not None and 'loss_ori=' in flex2.group(0),
          f'dla (c) train: {cli["train"].stdout[-800:]} '
          f'{cli["monoflex train"].stdout[-800:]}')
    print(f'dla (c) cli: SMOKE tools.test on the KITTI tree (36 AP lines '
          f'each; Car_3d_moderate_strict bf16 / f32 / f32 fused '
          f'{aps["smoke bf16"]} / {aps["smoke f32"]} / '
          f'{aps["smoke f32 fused"]}, live checkpoint), the 55 BatchNorms '
          f'folded: {n_det} detections, fused vs unfused max abs err '
          f'{err:.3g} (tol {MONO_DET_ATOL} x (1 + |value|)); --synthetic '
          f'finite on both configs; the shipped configs refused without '
          f'KITTI mono data / --synthetic (rc 2); tools.train SMOKE 2 '
          f'steps ({step2.group(0)[:160]}...), resume to 3 (optimizer sha1 '
          f'{digest}); MonoFlex --synthetic 2 steps ({flex2.group(0)[:160]}...); {cli_s:.1f} s '
          f'for the processes', flush=True)


def _dcn_layer_times(dev):
    """One DeformConv2d(64, 64) at the neck's 96x320 map, live offsets, in
    f32 and bf16: ms of the layer (its offset conv included) and of
    `F.conv2d` of the same shape (CUDA events, median of 20), and the
    bound of each: bytes (x in, the 64 outputs out) over 3.35 TB/s against
    operations over the type's peak."""
    import torch.nn.functional as F
    from dfm_tpu_torch.models.layers import DeformConv2d
    from dfm_tpu_torch.utils.weights import init_weights
    layer = live_dcn(init_weights(DeformConv2d(64, 64), 3), 4).to(dev).eval()
    p = DCN_LAYER_HW[0] * DCN_LAYER_HW[1]
    out = []
    for dtype, peak in ((torch.float32, F32_FLOPS),
                        (torch.bfloat16, BF16_TENSOR_FLOPS)):
        x = torch.randn(1, 64, *DCN_LAYER_HW, device=dev).to(dtype)
        w = layer.weight.to(dtype)
        elt = x.element_size()
        with torch.inference_mode():
            ms = cuda_ms(lambda: layer(x))
            conv_ms = cuda_ms(lambda: F.conv2d(x, w, None, 1, 1))
        nbytes = 2 * 64 * p * elt
        conv_ops = 2 * 9 * 64 * 64 * p
        dcn_ops = conv_ops + 2 * 9 * 64 * 27 * p
        out.append((str(dtype)[6:], ms, conv_ms,
                     max(nbytes / HBM_BYTES_PER_S, dcn_ops / peak) * 1e3,
                     max(nbytes / HBM_BYTES_PER_S, conv_ops / peak) * 1e3))
    return out


def _dla_timed(dev, root, ids, configs):
    """13 (b): the full configs at 1 x 384x1280 (frame 0 of the tree), then
    one f32 training step of each at its per-chip batch."""
    from dfm_tpu_torch.apis import init_mono_model
    from dfm_tpu_torch.data.kitti import build_kitti_infos
    from dfm_tpu_torch.data.kitti_mono import (load_mono_image,
                                               mono_info_from_native)
    from dfm_tpu_torch.models.builder import build_detector, mono_model
    from dfm_tpu_torch.models.layers import DeformConv2d
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import mono_synth, mono_to_device
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.train import KittiMonoSource
    from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    from dfm_tpu_torch.utils.weights import init_weights
    info0 = build_kitti_infos(root, ids[:1])[0]
    mono_info = mono_info_from_native(info0, root, DLA_HW)
    img = torch.from_numpy(load_mono_image(mono_info['image_path'],
                                           DLA_HW))[None].to(dev)
    cam2img = torch.from_numpy(mono_info['calib']['P2'])[None].to(dev)
    for dtype, ms, conv_ms, bound, conv_bound in _dcn_layer_times(dev):
        print(f'dla (b) one DeformConv2d(64, 64) at 1 x 64 x '
              f'{DCN_LAYER_HW[0]}x{DCN_LAYER_HW[1]} {dtype}, live offsets: '
              f'{ms:.4f} ms (bound {bound:.4f}) against F.conv2d of the '
              f'same shape {conv_ms:.4f} ms (bound {conv_bound:.4f}): '
              f'{ms / conv_ms:.1f}x', flush=True)
    for c in DLA_CONFIGS:
        mc = load_config(configs[c]).model
        cfg = build_detector(mc)
        flops = None
        for dtype in (torch.float32, torch.bfloat16):
            h = init_mono_model(cfg, dtype=dtype)
            model = live_dcn(h['model'], 5)
            for fused in (False, True):
                if fused:
                    n_fold = fuse_conv_bn(model)
                for _ in range(MONO_WARMUP):
                    h['infer'](img, cam2img)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
                ms = []
                for _ in range(MONO_TIMED):
                    t0 = time.perf_counter()
                    det = h['infer'](img, cam2img)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                peak = torch.cuda.max_memory_allocated()
                launches = sum(K.LAUNCHES.values())
                check(launches == 0, f'{c}: port kernels launched')
                kept = _finite_dets(det, f'{c} {dtype}')
                stages, dcn = [], []
                events = []
                hooks = [m.register_forward_pre_hook(
                    lambda *a: events.append(torch.cuda.Event(
                        enable_timing=True)) or events[-1].record())
                    for m in model.modules() if isinstance(m, DeformConv2d)]
                hooks += [m.register_forward_hook(
                    lambda *a: events.append(torch.cuda.Event(
                        enable_timing=True)) or events[-1].record())
                    for m in model.modules() if isinstance(m, DeformConv2d)]
                for _ in range(MONO_TIMED):
                    events.clear()
                    t = [time.perf_counter()]
                    with torch.inference_mode():
                        feats = model.backbone(img.permute(0, 3, 1, 2).to(
                            dtype))
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        feat = model.neck(feats)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        outs = model.bbox_head(feat)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        model.predict(outs, DLA_HW, cam2img)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                    stages.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
                    dcn.append(sum(a.elapsed_time(b) for a, b in zip(
                        events[0::2], events[1::2])))
                for hk in hooks:
                    hk.remove()
                check(len(events) == 32, f'{c}: {len(events)} DCN events')
                st = np.median(stages, 0)
                if flops is None:     # the same in every dtype and form
                    flops = [_flops_of(model.backbone,
                                       img.permute(0, 3, 1, 2).to(dtype)),
                             _flops_of(model.neck, feats),
                             _flops_of(model.bbox_head, feat)]
                tf32 = ('' if dtype == torch.bfloat16 else
                        f' (TF32 convs '
                        f'{"on" if torch.backends.cudnn.allow_tf32 else "off"})')
                fold = f', BatchNorm folded ({n_fold})' if fused else ''
                print(f'dla (b) {c} {str(dtype)[6:]}{tf32}{fold}, 1 x '
                      f'{DLA_HW[0]}x{DLA_HW[1]}, live offsets: ms/request '
                      f'{[round(v, 3) for v in ms]} median '
                      f'{float(np.median(ms)):.3f}; stages ms (median of '
                      f'{MONO_TIMED}) trunk {st[0]:.3f}, neck {st[1]:.3f} '
                      f'(its 16 DCN layers {float(np.median(dcn)):.3f}, CUDA '
                      f'events), head {st[2]:.3f}, predict {st[3]:.3f}; '
                      f'GFLOP trunk {flops[0] / 1e9:.1f} neck '
                      f'{flops[1] / 1e9:.1f} head {flops[2] / 1e9:.1f} '
                      f'(TFLOP/s {flops[0] / st[0] / 1e9:.1f}, '
                      f'{flops[1] / st[1] / 1e9:.1f}, '
                      f'{flops[2] / st[2] / 1e9:.1f}); peak_mem_bytes '
                      f'{peak}; kept {kept}; port-kernel launches '
                      f'{launches}', flush=True)
                del feats, feat, outs, det
            del h, model
            gc.collect()
            torch.cuda.empty_cache()

    # one full-width f32 step of each at the config's per-chip batch
    for c, kind in zip(DLA_CONFIGS, ('SMOKEMono3D', 'MonoFlex')):
        b = DLA_TRAIN_BATCH[kind]
        cfg = merge_options(load_config(configs[c]),
                            [f'data.data_root={root}', *DLA_KITTI])
        check(cfg.data.batch_size_per_chip == b, f'{c}: batch {b}')
        model = live_dcn(init_weights(mono_model(cfg.model)), 6,
                         DCN_STEP_SCALE).to(dev)
        step = TrainStep(model, make_optimizer(model), liga_schedule(2e-3))
        source = KittiMonoSource(cfg, b) if kind == 'SMOKEMono3D' else None
        rng = np.random.default_rng(0)
        for i in range(2):
            if i == 1:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                K.reset_launch_counts()
            t = [time.perf_counter()]
            inputs = source.next_batch(i, rng, dev) if source else \
                mono_to_device(mono_synth(b, i, *DLA_HW, flex=True), dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            total, losses = step.forward(*inputs)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            step.backward(total)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            norm = step.update()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            vals = {k: float(v.detach()) for k, v in
                    dict(loss=total, **losses).items()}
            check(all(np.isfinite(v) for v in vals.values()) and
                  np.isfinite(float(norm)), f'{kind} train full: {vals}')
        split = [(b2 - a) * 1e3 for a, b2 in zip(t, t[1:])]
        peak = torch.cuda.max_memory_allocated()
        launches = sum(K.LAUNCHES.values())
        check(launches == 0, f'{kind} train full: {dict(K.LAUNCHES)}')
        print(f'dla (b) {kind} full config training, f32 (TF32 as PyTorch '
              f'has it), B = {b}, {b} x {DLA_HW[0]}x{DLA_HW[1]} '
              f'({"the tree" if source else "synthetic"} images), one step '
              f'after a warm-up, ms (data, forward, backward, optimizer): '
              + ', '.join(f'{v:.3f}' for v in split)
              + f'; total {sum(split):.3f}; peak_mem_bytes {peak}; losses '
              f'{ {k: round(v, 4) for k, v in vals.items()} } grad_norm '
              f'{float(norm):.5g}; port-kernel launches {launches}',
              flush=True)
        del model, step, total, losses, inputs
        gc.collect()
        torch.cuda.empty_cache()


IMVOXEL_CONFIG = 'imvoxelnet_kitti_car.py'
IMVOXEL_TINY = dict(feat_channels=16, voxel_range=(0.0, -8.0, -2.0, 16.0,
                                                   8.0, 2.0),
                    voxel_grid=(4, 16, 16),
                    anchor_ranges=((0.0, -8.0, -1.78, 16.0, 8.0, -1.78),),
                    backbone_depth=18, nms_pre=128, max_num=8)
IMVOXEL_TINY_HW = (64, 96)
IMVOXEL_HW = (384, 1280)      # the config's data.input_size
IMVOXEL_REL_L2 = 1e-4         # (a) dense outputs card vs CPU, f32, TF32 off
IMVOXEL_DET_TOL = (1e-3, 1e-3)
NUS_CONFIGS = ('fcos3d_r101_nus_mono.py', 'pgd_r101_nus_mono_1x.py')
NUS_HW = (900, 1600)          # the raw nuScenes image JAX's sample gives
NUS_METRIC_LINES = 17         # 10 class APs, mAP, 5 TP errors, NDS
WAYMO_CAM_CONFIGS = ('pgd_r101_waymo_mono3d.py', 'pgd_r101_waymo_mv3d.py')
WAYMO_CAM_TINY = dict(backbone_depth=18, in_channels=32, feat_channels=32,
                      depth_branch=(16,), nms_pre=100, max_num=20)
JPEG_FIXTURES = ('tests', 'data', 'jpeg')


def _request_times(infer, stages, what, launches_ok=True,
                   warmup=MONO_WARMUP, timed=MONO_TIMED):
    """`infer()` after `warmup` calls, timed `timed` times (host clock,
    synchronised), then `stages` (a list of (name, fn(prev) -> out), the
    first called with None) timed apart `timed` times; the peak memory of
    the timed requests and the port-kernel launches, checked 0. Returns
    (request ms list, stage ms medians, peak, the last request's
    output)."""
    from dfm_tpu_torch.ops.cuda import sampling as K
    for _ in range(warmup):
        infer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    ms = []
    for _ in range(timed):
        t0 = time.perf_counter()
        out = infer()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    launches = sum(K.LAUNCHES.values())
    check(launches == 0, f'{what}: port kernels launched '
          f'{dict(K.LAUNCHES)}')
    per = []
    with torch.inference_mode():
        for _ in range(timed):
            x, t = None, []
            for _, fn in stages:
                t0 = time.perf_counter()
                x = fn(x)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            per.append(t)
    return ms, dict(zip([n for n, _ in stages], np.median(per, 0))), peak, \
        out


def _stage_line(what, ms, st, peak, timed=MONO_TIMED):
    return (f'{what}: ms/request {[round(v, 3) for v in ms]} median '
            f'{float(np.median(ms)):.3f}; stages ms (median of {timed}) '
            + ', '.join(f'{k} {v:.3f}' for k, v in st.items())
            + f'; peak_mem_bytes {peak}; port-kernel launches 0')


def _train_step_line(what, model, batch_fn, dev):
    """One f32 training step after a warm-up, split into data, forward,
    backward and optimizer; its peak memory and 0 port-kernel launches."""
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    step = TrainStep(model, make_optimizer(model), liga_schedule(1e-4))
    for i in range(2):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
        t = [time.perf_counter()]
        inputs = batch_fn(i)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        total, losses = step.forward(*inputs)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step.backward(total)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        norm = step.update()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        vals = {k: float(v.detach()) for k, v in
                dict(loss=total, **losses).items()}
        check(all(np.isfinite(v) for v in vals.values()) and
              np.isfinite(float(norm)), f'{what}: {vals}')
    split = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    launches = sum(K.LAUNCHES.values())
    check(launches == 0, f'{what}: {dict(K.LAUNCHES)}')
    print(f'{what}: one step after a warm-up, ms (data, forward, backward, '
          f'optimizer): ' + ', '.join(f'{v:.3f}' for v in split)
          + f'; total {sum(split):.3f}; peak_mem_bytes '
          f'{torch.cuda.max_memory_allocated()}; losses '
          f'{ {k: round(v, 4) for k, v in vals.items()} } grad_norm '
          f'{float(norm):.5g}; port-kernel launches 0', flush=True)


def _start(procs, name, cmd, env=None):
    """`python -m cmd...` in a process of its own from the repo root."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    procs[name] = subprocess.Popen(
        [sys.executable, '-m', *cmd], cwd=here,
        env=env or dict(os.environ, PYTHONPATH=here),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(procs, timeout=900):
    """Wait for every process of `procs` -> name -> CompletedProcess."""
    out = {}
    for name, p in procs.items():
        o, e = p.communicate(timeout=timeout)
        out[name] = subprocess.CompletedProcess(p.args, p.returncode, o, e)
    return out


def _kill(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()


def _kitti_lidar2img(hw, f=721.5):
    """A KITTI-like lidar2img for an (h, w) image: the camera at the
    lidar's origin looking down x, focal `f` scaled to the width."""
    h, w = hw
    cam = np.eye(4, dtype=np.float32)
    cam[0, 0] = cam[1, 1] = f * w / 1242.0
    cam[0, 2], cam[1, 2] = w / 2.0, h / 2.0
    rot = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                    [0, 0, 0, 1]], np.float32)
    return cam @ rot


def _imvoxel_tiny_step(dev, batch, noise=None, reverse=False):
    """One train-mode forward + backward of the tiny ImVoxelNet on `dev`
    (seeded live weights, + one ulp of noise with seed `noise`; the batch
    reversed with `reverse`): loss terms, gradients."""
    from dfm_tpu_torch.models.detectors.imvoxelnet import (ImVoxelNet,
                                                           ImVoxelNetConfig)
    from dfm_tpu_torch.runtime.adapters import mv_to_device
    from dfm_tpu_torch.utils.weights import init_weights
    model = _live_weights(init_weights(ImVoxelNet(ImVoxelNetConfig(
        **IMVOXEL_TINY)), 5), 6, 3.0)
    model = (model if noise is None else _ulp_noise(model, noise)).to(dev)
    if reverse:
        batch = {k: v[::-1].copy() for k, v in batch.items()}
    imgs, l2i, gt = mv_to_device(batch, dev)
    total, losses = model.train().forward_train(imgs, l2i, gt)
    total.backward()
    return dict(
        losses={k: float(v) for k, v in dict(loss=total.detach(), **{
            k: v.detach() for k, v in losses.items()}).items()},
        grads={n: None if p.grad is None else p.grad.detach().cpu()
               for n, p in model.named_parameters()})


def imvoxel_phase(dev):
    """14. ImVoxelNet on KITTI (configs/imvoxelnet_kitti_car.py): (a) the
    tiny model card vs CPU, (b) the full config's request timed by stage
    in bf16 and f32, unfused and folded, one f32 step at B = 4, (c) the
    `--synthetic` CLIs and the refusals without it."""
    import os
    import tempfile
    from dfm_tpu_torch.apis import init_imvoxelnet_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.imvoxelnet import (
        ImVoxelNet, ImVoxelNetConfig, imvoxelnet_predict)
    from dfm_tpu_torch.runtime.adapters import imvoxel_synth, mv_to_device
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.fuse_conv_bn import fuse_conv_bn
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(here, 'configs', IMVOXEL_CONFIG)
    procs = {}
    with tempfile.TemporaryDirectory() as work:
        try:
            # (c) in processes of their own while (a) runs here
            _start(procs, 'test synthetic', ['dfm_tpu_torch.tools.test',
                                             config, '--synthetic'])
            _start(procs, 'test refused', ['dfm_tpu_torch.tools.test',
                                           config])
            _start(procs, 'train synthetic', [
                'dfm_tpu_torch.tools.train', config, '--synthetic',
                '--max-steps', '2', '--work-dir', os.path.join(work, 'w')])
            _start(procs, 'train refused', ['dfm_tpu_torch.tools.train',
                                            config, '--work-dir',
                                            os.path.join(work, 'r')])
            # (a) card vs CPU, f32 with TF32 off
            flags = _no_tf32()
            try:
                cfg = ImVoxelNetConfig(**IMVOXEL_TINY)
                batch = imvoxel_synth(cfg, 2, 0, *IMVOXEL_TINY_HW)
                outs, dets = {}, {}
                for d in ('cpu', dev):
                    model = _live_weights(init_weights(ImVoxelNet(cfg), 5),
                                          6, 3.0).to(d).eval()
                    imgs, l2i, _ = mv_to_device(batch, d)
                    with torch.inference_mode():
                        out = model(imgs, l2i)
                        dets[d] = _mono_dets(imvoxelnet_predict(
                            {k: v.cpu() for k, v in out.items()}, cfg))
                    outs[d] = {k: v.float().cpu() for k, v in out.items()}
                rel = _rel_l2s(outs[dev], outs['cpu'])
                check(max(rel.values()) <= IMVOXEL_REL_L2,
                      f'imvoxel (a) outputs card vs CPU: {rel}')
                n_det, worst = _mv_dets_agree('imvoxel (a) decode',
                                              dets[dev], dets['cpu'],
                                              IMVOXEL_DET_TOL)
                check(n_det > 0, 'imvoxel (a): no live detection')
                cpu = _imvoxel_tiny_step('cpu', batch)
                card = _imvoxel_tiny_step(dev, batch)
                movers = (_imvoxel_tiny_step('cpu', batch, noise=1)['grads'],
                          _imvoxel_tiny_step('cpu', batch, noise=2)['grads'],
                          _imvoxel_tiny_step('cpu', batch,
                                             reverse=True)['grads'])
                loss_err = _losses_agree('imvoxel (a) step', card['losses'],
                                         cpu['losses'], TRAIN_LOSS_RTOL)
                g_worst, g_name, g_whole, g_noise = _grad_compare(
                    'imvoxel (a) step', card['grads'], cpu['grads'], movers)
            finally:
                _set_tf32(flags)
            print(f'imvoxel (a) tiny ImVoxelNet (ResNet-18, grid '
                  f'{IMVOXEL_TINY["voxel_grid"]}, 2 x {IMVOXEL_TINY_HW[0]}x'
                  f'{IMVOXEL_TINY_HW[1]}) f32, TF32 off, card vs CPU: '
                  f'outputs relative L2 max {max(rel.values()):.3g}; '
                  f'{n_det} detections, scores / boxes off by at most '
                  f'{worst[0]:.3g} / {worst[1]:.3g}; one step: loss terms '
                  f'rtol {loss_err:.3g}, gradients worst {g_worst:.3g} '
                  f'({g_name}), whole {g_whole:.3g} (CPU movers '
                  f'{g_noise:.3g})',
                  flush=True)
            cli = _finish(procs)
            for name in ('test synthetic', 'train synthetic'):
                check(cli[name].returncode == 0, f'imvoxel (c) {name}: '
                      f'{cli[name].stderr[-3000:]}')
            check('finite=True' in cli['test synthetic'].stdout and
                  'step 2/2' in cli['train synthetic'].stdout,
                  'imvoxel (c): the synthetic CLIs printed no result')
            for name in ('test refused', 'train refused'):
                check(cli[name].returncode == 2 and '--synthetic' in
                      cli[name].stderr, f'imvoxel (c) {name}: rc '
                      f'{cli[name].returncode} {cli[name].stderr[-500:]}')
            print('imvoxel (c) tools.test --synthetic (finite) and '
                  'tools.train --synthetic (2 steps) at the full config; '
                  'both refused without --synthetic (rc 2)', flush=True)
        finally:
            _kill(procs)

    # (b) the full config
    mcfg = build_detector(load_config(config).model)
    l2i = torch.from_numpy(_kitti_lidar2img(IMVOXEL_HW))[None].to(dev)
    img = torch.randn((1,) + IMVOXEL_HW + (3,), generator=torch.Generator(
        ).manual_seed(0)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        h = init_imvoxelnet_model(mcfg, dtype)
        model = _live_weights(h['model'], 7, 3.0)
        for fused in (False, True):
            n_fold = fuse_conv_bn(model) if fused else 0
            stages = [
                ('trunk + FPN', lambda _: model.image_features(img)),
                ('voxel sample', lambda f: model.sample_volume(
                    f, l2i, IMVOXEL_HW)),
                ('neck_3d', lambda v: model.neck_3d(v)),
                ('head', lambda b: dict(zip(
                    ('cls_score', 'bbox_pred', 'dir_pred'),
                    model.bbox_head(b)))),
                ('predict', lambda o: imvoxelnet_predict(o, mcfg))]
            ms, st, peak, det = _request_times(
                lambda: h['infer'](img, l2i), stages, 'imvoxel (b)')
            kept = _finite_dets(det, 'imvoxel (b)')
            tf32 = '' if dtype == torch.bfloat16 else ' (TF32 as PyTorch ' \
                'has it)'
            fold = f', BatchNorm folded ({n_fold})' if fused else ''
            print(_stage_line(
                f'imvoxel (b) full config {str(dtype)[6:]}{tf32}{fold}, 1 x '
                f'{IMVOXEL_HW[0]}x{IMVOXEL_HW[1]}, volume '
                f'{mcfg.voxel_grid} x {mcfg.feat_channels}', ms, st, peak)
                + f'; kept {kept}', flush=True)
        del h, model
        gc.collect()
        torch.cuda.empty_cache()
    b = load_config(config).data.batch_size_per_chip
    model = init_weights(ImVoxelNet(mcfg)).to(dev)
    _train_step_line(
        f'imvoxel (b) full config training, f32 (TF32 as PyTorch has it), '
        f'B = {b} synthetic {IMVOXEL_HW[0]}x{IMVOXEL_HW[1]}', model,
        lambda i: mv_to_device(imvoxel_synth(mcfg, b, i, *IMVOXEL_HW), dev),
        dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f'imvoxel phase {time.perf_counter() - t_phase:.1f} s', flush=True)


def _jpeg_fixtures():
    """(folder, manifest) of the committed JPEG fixtures."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    folder = os.path.join(here, *JPEG_FIXTURES)
    with open(os.path.join(folder, 'manifest.json')) as f:
        return folder, json.load(f)


def _nus_tree(root, folder, n=2):
    """A nuScenes-mono tree of the 1600x900 fixture JPEG (n copies, each
    with its own intrinsics) and its infos pickle with a few GT boxes."""
    import os
    import pickle
    import shutil
    os.makedirs(os.path.join(root, 'samples', 'CAM_FRONT'))
    rng = np.random.default_rng(0)
    infos = []
    for i in range(n):
        path = f'samples/CAM_FRONT/{i}.jpg'
        shutil.copy(os.path.join(folder, 'nus_1600x900_420.jpg'),
                    os.path.join(root, path))
        g = 6
        boxes = np.concatenate([rng.uniform(-10, 10, (g, 1)),
                                rng.uniform(0.5, 2, (g, 1)),
                                rng.uniform(8, 40, (g, 1)),
                                rng.uniform(0.5, 4, (g, 3)),
                                rng.uniform(-np.pi, np.pi, (g, 1)),
                                rng.normal(0, 2, (g, 2))], 1)
        infos.append(dict(
            token=f'tok{i}', img_path=path, width=1600, height=900,
            cam2img=np.array([[1266.4 + 10 * i, 0, 816.3], [0, 1266.4, 491.5],
                              [0, 0, 1]]),
            gt_boxes=boxes.astype(np.float32),
            gt_names=['car', 'pedestrian', 'truck', 'barrier',
                      'traffic_cone', 'bicycle'],
            gt_attrs=rng.integers(0, 9, g)))
    with open(os.path.join(root, 'nuscenes_infos_mono_val.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    return infos


def nuscenes_phase(dev):
    """15. nuScenes-mono: (a) the JPEG fixtures decoded to their committed
    PNGs and digests, the host ms of the 1600x900 decode, (b) FCOS3D-nus
    and PGD-nus requests at 900x1600 by stage in bf16 and f32, (c)
    `tools.test` on a tree of the fixture JPEGs to the NDS lines."""
    import hashlib
    import os
    import tempfile
    from dfm_tpu_torch.apis import init_mono_model
    from dfm_tpu_torch.data.jpeg import read_jpeg
    from dfm_tpu_torch.data.pipeline import normalize_image
    from dfm_tpu_torch.data.png import read_png
    from dfm_tpu_torch.models.builder import (build_detector,
                                              mono_backbone_depth, mono_model)
    from dfm_tpu_torch.models.heads.fcos_mono3d import pad44
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    configs = {c: os.path.join(here, 'configs', c) for c in NUS_CONFIGS}
    folder, manifest = _jpeg_fixtures()
    procs = {}
    with tempfile.TemporaryDirectory() as root:
        try:
            # (c) in processes of their own while (a) and (b) run here
            _nus_tree(root, folder)
            for c, path in configs.items():
                live = os.path.join(root, f'{c}.pth')
                torch.save(_live_weights(init_weights(mono_model(
                    load_config(path).model)), 8, 3.0).state_dict(), live)
                _start(procs, c, ['dfm_tpu_torch.tools.test', path,
                                  '--checkpoint', live, '--cfg-options',
                                  f'data.data_root={root}'])
            # (a) the fixtures
            decode_ms, img = [], None
            for name, m in sorted(manifest.items()):
                path = os.path.join(folder, name + '.jpg')
                t0 = time.perf_counter()
                got = read_jpeg(path)
                if list(got.shape) == [NUS_HW[0], NUS_HW[1], 3]:
                    decode_ms.append((time.perf_counter() - t0) * 1e3)
                    img = got
                check(hashlib.sha256(got.tobytes()).hexdigest() == m['sha256'],
                      f'nuscenes (a) {name}: decode differs from cv2.imdecode')
                if m['png']:
                    check(np.array_equal(got, read_png(os.path.join(
                        folder, name + '.png'))), f'nuscenes (a) {name}: '
                        'decode differs from its PNG')
            big = os.path.join(folder, 'nus_1600x900_420.jpg')
            for _ in range(2):
                t0 = time.perf_counter()
                read_jpeg(big)
                decode_ms.append((time.perf_counter() - t0) * 1e3)
            print(f'nuscenes (a) {len(manifest)} JPEG fixtures decoded '
                  f'bit for bit as cv2.imdecode (their PNGs and digests); '
                  f'host ms of the 1600x900 4:2:0 decode '
                  f'({os.path.getsize(big)} bytes) '
                  f'{[round(v, 1) for v in decode_ms]} median '
                  f'{float(np.median(decode_ms)):.1f}', flush=True)
            # (b) the requests at 900x1600
            norm = torch.from_numpy(normalize_image(img.astype(
                np.float32)))[None].to(dev)
            cam = pad44(torch.tensor([[1266.4, 0, 816.3, 0],
                                      [0, 1266.4, 491.5, 0],
                                      [0, 0, 1, 0]]))[None].to(dev)
            for c, path in configs.items():
                mc = load_config(path).model
                cfg = build_detector(mc)
                for dtype in (torch.bfloat16, torch.float32):
                    h = init_mono_model(cfg, mono_backbone_depth(mc), dtype)
                    model = _live_weights(h['model'], 9, 3.0)
                    stages = [('trunk + FPN', lambda _: model.features(norm)),
                              ('head', lambda f: model.bbox_head(f)),
                              ('predict', lambda o: model.predict(
                                  o, NUS_HW, cam))]
                    ms, st, peak, det = _request_times(
                        lambda: h['infer'](norm, cam), stages,
                        f'nuscenes (b) {c}')
                    kept = _finite_dets(det, f'nuscenes (b) {c}')
                    check('velocity' in det and 'attrs' in det,
                          f'nuscenes (b) {c}: no velocity / attributes')
                    tf32 = '' if dtype == torch.bfloat16 else \
                        ' (TF32 as PyTorch has it)'
                    print(_stage_line(
                        f'nuscenes (b) {c} {str(dtype)[6:]}{tf32}, 1 x '
                        f'{NUS_HW[0]}x{NUS_HW[1]}', ms, st, peak)
                        + f'; kept {kept}', flush=True)
                    del h, model
                    gc.collect()
                    torch.cuda.empty_cache()
            cli = _finish(procs)
            for c in configs:
                res = cli[c]
                check(res.returncode == 0, f'nuscenes (c) {c}: '
                      f'{res.stderr[-3000:]}')
                lines = re.findall(r'^([A-Za-z_]+): (-?[0-9.]+|nan)$',
                                   res.stdout, re.M)
                check(len(lines) == NUS_METRIC_LINES and all(
                    np.isfinite(float(v)) for _, v in lines),
                    f'nuscenes (c) {c}: {len(lines)} metric lines '
                    f'{res.stdout[-1500:]}')
                dets = re.findall(r'dets=(\d+)', res.stdout)
                print(f'nuscenes (c) tools.test {c} (full width, bf16, live '
                      f'checkpoint) on {len(dets)} fixture JPEGs: dets '
                      f'{dets}; ' + ', '.join(f'{k} {v}' for k, v in lines
                                              if k in ('mAP', 'NDS')),
                      flush=True)
        finally:
            _kill(procs)
    print(f'nuscenes phase {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def waymo_cam_phase(dev):
    """16. PGD-Waymo's camera modes and the mono demo: (a) the tiny PGD on
    'cam_frame' samples card vs CPU and the five cameras' merge, (b) the
    full PGD-Waymo request at 1280x1920 by stage and the merge's ms, (c)
    the `tools.test` refusal and `--synthetic`, (d) the demo on a fixture
    image writing its PNG."""
    import os
    import tempfile
    from dfm_tpu_torch.apis import init_mono_model
    from dfm_tpu_torch.data.png import read_png
    from dfm_tpu_torch.data.waymo import WaymoDataset
    from dfm_tpu_torch.models.builder import (build_detector,
                                              mono_backbone_depth, mono_model)
    from dfm_tpu_torch.models.heads.fcos_mono3d import FCOS3DConfig
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    configs = {c: os.path.join(here, 'configs', c)
               for c in WAYMO_CAM_CONFIGS}
    folder, _ = _jpeg_fixtures()
    procs = {}
    with tempfile.TemporaryDirectory() as root:
        try:
            small, full = os.path.join(root, 'small'), os.path.join(root,
                                                                    'full')
            write_waymo_tree(small, scale=0.05, frames=1)
            for c, path in configs.items():
                _start(procs, f'refused {c}', [
                    'dfm_tpu_torch.tools.test', path, '--cfg-options',
                    f'data.data_root={small}'])
                _start(procs, f'synthetic {c}', ['dfm_tpu_torch.tools.test',
                                                 path, '--synthetic'])
            demo_ckpt = os.path.join(root, 'demo.pth')
            torch.save(_live_weights(init_weights(mono_model(dict(
                type='FCOSMono3D'))), 10, 3.0).state_dict(), demo_ckpt)
            demo_png = os.path.join(root, 'vis.png')
            _start(procs, 'demo', ['dfm_tpu_torch.demo.mono_det_demo',
                                   os.path.join(folder,
                                                'nus_1600x900_420.jpg'),
                                   '--fx', '1266.4', '--checkpoint',
                                   demo_ckpt, '--out', demo_png])
            write_waymo_tree(full, frames=1)
            # (a) the tiny PGD on the five cameras of a frame, card vs CPU
            mc = dict(load_config(configs[WAYMO_CAM_CONFIGS[1]]).model
                      .to_dict(), **WAYMO_CAM_TINY)
            ds = WaymoDataset(small, os.path.join(small,
                                                  'waymo_infos_val.pkl'),
                              target_hw=(64, 96), load_mode='cam_frame')
            check(len(ds) == 5, f'waymo_cam (a): {len(ds)} camera samples')
            flags = _no_tf32()
            try:
                per_dev = {}
                for d in ('cpu', dev):
                    model = _live_weights(init_weights(mono_model(mc)), 11,
                                          3.0).to(d).eval()
                    per_cam = []
                    for i in range(len(ds)):
                        s = ds.get_sample(i)
                        l2i = torch.from_numpy(s['lidar2img'][0, 0])
                        img = torch.from_numpy(s['imgs'][0])
                        with torch.inference_mode():
                            det = model.predict(model(img.to(d)), (64, 96),
                                                l2i[None].to(d))
                        per_cam.append(_mono_dets(det)[0])
                    per_dev[d] = per_cam
                n_det, worst = _mv_dets_agree('waymo_cam (a)', per_dev[dev],
                                              per_dev['cpu'], MONO_DET_TOL)
                merged = {d: ds.merge_multi_view_boxes([
                    dict(boxes3d=r['boxes_3d'], scores=r['scores_3d'],
                         labels=r['labels_3d']) for r in per_dev[d]])
                    for d in per_dev}
                check(np.array_equal(merged[dev]['labels'],
                                     merged['cpu']['labels']) and
                      np.allclose(merged[dev]['boxes3d'],
                                  merged['cpu']['boxes3d'], atol=1e-3,
                                  rtol=1e-3),
                      'waymo_cam (a): the merges differ')
            finally:
                _set_tf32(flags)
            print(f'waymo_cam (a) tiny PGD on the 5 cam_frame samples of a '
                  f'frame (64x96), f32, TF32 off, card vs CPU: {n_det} '
                  f'detections, scores / boxes off by at most '
                  f'{worst[0]:.3g} / {worst[1]:.3g}; merged '
                  f'{len(merged[dev]["labels"])} boxes on both', flush=True)
            # (b) the full PGD-Waymo request at 1280x1920
            path = configs[WAYMO_CAM_CONFIGS[1]]
            lc = load_config(path)
            hw = tuple(lc.data.input_size)
            cfg = build_detector(lc.model)
            ds = WaymoDataset(full, os.path.join(full, 'waymo_infos_val.pkl'),
                              target_hw=hw, load_mode='cam_frame')
            samples = [ds.get_sample(i) for i in range(len(ds))]
            for dtype in (torch.bfloat16, torch.float32):
                h = init_mono_model(cfg, mono_backbone_depth(lc.model), dtype)
                model = _live_weights(h['model'], 12, 3.0)
                img = torch.from_numpy(samples[0]['imgs'][0]).to(dev)
                cam = torch.from_numpy(samples[0]['lidar2img'][0]).to(dev)
                stages = [('trunk + FPN', lambda _: model.features(img)),
                          ('head', lambda f: model.bbox_head(f)),
                          ('predict', lambda o: model.predict(o, hw, cam))]
                ms, st, peak, det = _request_times(
                    lambda: h['infer'](img, cam), stages, 'waymo_cam (b)')
                per_cam = []
                for s in samples:
                    det = h['infer'](torch.from_numpy(s['imgs'][0]).to(dev),
                                     torch.from_numpy(s['lidar2img'][0]).to(
                                         dev))
                    _finite_dets(det, 'waymo_cam (b)')
                    d0 = _mono_dets(det)[0]
                    per_cam.append(dict(boxes3d=d0['boxes_3d'],
                                        scores=d0['scores_3d'],
                                        labels=d0['labels_3d']))
                t0 = time.perf_counter()
                merged = ds.merge_multi_view_boxes(per_cam)
                merge_ms = (time.perf_counter() - t0) * 1e3
                tf32 = '' if dtype == torch.bfloat16 else \
                    ' (TF32 as PyTorch has it)'
                print(_stage_line(
                    f'waymo_cam (b) {WAYMO_CAM_CONFIGS[1]} {str(dtype)[6:]}'
                    f'{tf32}, one camera 1 x {hw[0]}x{hw[1]} (its lidar2img '
                    'as the projection)', ms, st, peak)
                    + f'; the 5 cameras\' merge (host) {merge_ms:.1f} ms, '
                    f'{sum(len(r["scores"]) for r in per_cam)} -> '
                    f'{len(merged["scores"])} boxes', flush=True)
                del h, model
                gc.collect()
                torch.cuda.empty_cache()
            cli = _finish(procs)
            for c in configs:
                r, syn = cli[f'refused {c}'], cli[f'synthetic {c}']
                check(r.returncode == 2 and 'max pool' in r.stderr,
                      f'waymo_cam (c) {c}: rc {r.returncode} '
                      f'{r.stderr[-500:]}')
                check(syn.returncode == 0 and 'finite=True' in syn.stdout,
                      f'waymo_cam (c) {c} --synthetic: {syn.stderr[-2000:]}')
            print('waymo_cam (c) tools.test refuses both PGD-Waymo configs '
                  'on a Waymo tree (rc 2, the reason named) and decodes '
                  'them with --synthetic', flush=True)
            d = cli['demo']
            check(d.returncode == 0, f'waymo_cam (d) demo: '
                  f'{d.stderr[-3000:]}')
            n = int(re.search(r'^(\d+) detections', d.stdout, re.M).group(1))
            vis = read_png(demo_png)
            check(vis is not None and vis.shape == NUS_HW + (3,) and n > 0,
                  f'waymo_cam (d) demo: {n} detections, image '
                  f'{None if vis is None else vis.shape}')
            drawn = int(np.all(vis == (0, 255, 0), -1).sum())
            print(f'waymo_cam (d) the mono demo (FCOS3D R101, bf16, live '
                  f'checkpoint) on the 1600x900 fixture JPEG: {n} '
                  f'detections, {drawn} pixels drawn, its PNG read back',
                  flush=True)
        finally:
            _kill(procs)
    print(f'waymo_cam phase {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def phase14_alone(dev='cuda'):
    """Phase 14 without the others (no kernel built: the path has none):
    `python3 -c "import chip_smoke; chip_smoke.phase14_alone()"`."""
    imvoxel_phase(dev)


def phase15_alone(dev='cuda'):
    """Phase 15 without the others (no kernel built):
    `python3 -c "import chip_smoke; chip_smoke.phase15_alone()"`."""
    nuscenes_phase(dev)


def phase16_alone(dev='cuda'):
    """Phase 16 without the others (no kernel built):
    `python3 -c "import chip_smoke; chip_smoke.phase16_alone()"`."""
    waymo_cam_phase(dev)


def phase13_alone(dev='cuda'):
    """Phase 13 without the others (no kernel built: the path has none):
    `python3 -c "import chip_smoke; chip_smoke.phase13_alone()"`."""
    dla_phase(dev)


def phase12_alone(dev='cuda'):
    """Phase 12 without the others (no kernel built: the path has none):
    `python3 -c "import chip_smoke; chip_smoke.phase12_alone()"`."""
    mono_phase(dev)


def phase10_alone(dev='cuda'):
    """Phase 10 without the others (the kernels built, phase 9's Waymo
    trees written here): `python3 -c "import chip_smoke;
    chip_smoke.phase10_alone()"`."""
    import os
    import tempfile
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.ops.cuda import build
    print(f'build: {build.build_all():.1f} s', flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        trees = dict(full=os.path.join(tmp, 'full'),
                     small=os.path.join(tmp, 'small'))
        write_waymo_tree(trees['full'])
        write_waymo_tree(trees['small'], scale=0.05)
        ddp_phase(DfMConfig(), dev, {k: {} for k in TRAIN_PATH}, trees)


def phase11_alone(dev='cuda'):
    """Phase 11 without the others (phase 9's Waymo trees written here, no
    kernel built: the path has none): `python3 -c "import chip_smoke;
    chip_smoke.phase11_alone()"`."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trees = dict(full=os.path.join(tmp, 'full'),
                     small=os.path.join(tmp, 'small'))
        write_waymo_tree(trees['full'])
        write_waymo_tree(trees['small'], scale=0.05)
        temporal_phase(dev, trees)


# --- phases 17-20: the Waymo converter, the generic FrustumToVoxel, the
# SECOND LiDAR family and DfMWithTeacher with the sparse teacher
WAYMO_RAW_FRAMES = 3
MV_CAMSYNC_CONFIG = 'multiview_dfm_r101_waymo_camsync.py'
LIDAR_CONFIGS = ('hv_second_kitti_3class.py',
                 'hv_second_kitti_3class_freeanchor.py')
LIDAR_POINTS = 18000
LIDAR_TINY = dict(
    point_cloud_range=(0, -8, -2, 16, 8, 1.2), voxel_size=(0.4, 0.4, 0.4),
    max_points_per_voxel=5, cv_channels=8, bev_channels=16,
    anchor_ranges=((0, -8, -0.6, 16, 8, -0.6), (0, -8, -0.6, 16, 8, -0.6),
                   (0, -8, -1.78, 16, 8, -1.78)),
    nms_pre=256, max_num=30, score_thr=0.05)
LIDAR_REL_L2 = 1e-5           # card against CPU, float32, TF32 off
# a sparse teacher whose dense output is (2, 16, 16); capacity overflowed
SPARSE_SMALL = dict(voxel_size=(0.9, 0.95, 0.25), sparse_shape=(17, 64, 64),
                    capacity=640)
SPARSE_REL_L2 = 1e-5
TEACHER_POINTS = 20000        # phase 20's full-width step
GENERIC_REL = 2e-2            # generic against separable FrustumToVoxel


def lidar_cloud(pcr, n, seed, clusters=20):
    """(n, 3) float32 points uniform in `pcr` with `clusters` dense blobs
    (voxels of more than 5 points), a few outside."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(pcr[:3], np.float64), np.asarray(pcr[3:], np.float64)
    pts = rng.uniform(lo - 0.5, hi + 0.5, (n, 3))
    per = n // (4 * clusters)
    for c in range(clusters):
        pts[c * per:(c + 1) * per] = rng.uniform(lo + 1, hi - 1) + \
            0.05 * rng.standard_normal((per, 3))
    return pts.astype(np.float32)


def _timed(fn, reps=3):
    """fn() once, then `reps` times on the host clock (synchronised) ->
    (ms list, peak memory of the timed calls, the last output)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, torch.cuda.max_memory_allocated(), out


def waymo_convert_phase(procs, work):
    """17. Waymo TFRecords -> the port's kitti_format tree: records of
    WAYMO_RAW_FRAMES frames (five cameras, the JPEG fixtures) written here,
    converted (`tools/data_converter/waymo_converter.py`, host ms a frame),
    read back by `WaymoDataset`, the GT .bin of `create_waymo_gt_bin`, and
    MultiViewDfM camsync's `tools.test` started on the tree against it (its
    LET lines are read in `_lidar_cli_checks`). Returns the tree's root."""
    import os
    import pickle
    from dfm_tpu_torch.data.waymo import WaymoDataset
    from dfm_tpu_torch.tools import create_waymo_gt_bin
    from dfm_tpu_torch.tools.data_converter import waymo_converter
    here = os.path.dirname(os.path.abspath(__file__))
    rec_dir = os.path.join(work, 'waymo_records')
    out = os.path.join(work, 'waymo_converted')
    os.makedirs(rec_dir)
    size = write_waymo_tfrecord(os.path.join(rec_dir, 'segment-0.tfrecord'),
                                WAYMO_RAW_FRAMES)
    t0 = time.perf_counter()
    check(waymo_converter.main(['--tfrecord-dir', rec_dir, '--out', out])
          == 0, 'waymo (17): the converter failed')
    convert_ms = (time.perf_counter() - t0) * 1e3 / WAYMO_RAW_FRAMES
    info_path = os.path.join(out, 'waymo_infos_val.pkl')
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)
    check(len(infos) == WAYMO_RAW_FRAMES and all(
        len(i['images']) == 5 and len(i['annos']['gt_boxes']) == 7
        for i in infos), 'waymo (17): converted infos')
    ds = WaymoDataset(out, info_path, target_hw=(640, 960), cam_sync=True)
    t0 = time.perf_counter()
    sample = ds.get_sample(1)
    read_ms = (time.perf_counter() - t0) * 1e3
    views = np.abs(sample['imgs']).reshape(5, -1).max(1)
    check(np.isfinite(sample['imgs']).all() and (views > 0).all() and
          int(sample['gt_mask'].sum()) == 6, 'waymo (17): the sample')
    gt = os.path.join(out, 'gt.bin')
    check(create_waymo_gt_bin.main(['--infos', info_path, '--out', gt]) == 0,
          'waymo (17): create_waymo_gt_bin')
    _start(procs, 'waymo test', [
        'dfm_tpu_torch.tools.test',
        os.path.join(here, 'configs', MV_CAMSYNC_CONFIG), '--waymo-gt-bin',
        gt, '--cfg-options', f'data.data_root={out}', 'data.cam_sync=True'])
    print(f'waymo (17) conversion: {WAYMO_RAW_FRAMES} frames of 5 cameras '
          f'({size} bytes of TFRecord) -> kitti_format tree, host ms a frame '
          f'{convert_ms:.3f}; WaymoDataset sample (5 JPEG views to 640x960) '
          f'{read_ms:.3f} ms, 6 cam-synced gt; GT .bin '
          f'{os.path.getsize(gt)} bytes; tools.test (MultiViewDfM camsync) '
          'started on the tree', flush=True)
    return out


def frustum_generic_phase(dev):
    """18. FrustumToVoxel's generic branch at the full DfMConfig (72
    planes at 80x320, 64 channels in, the (20, 304, 288) grid) in bf16
    and f32: ms and peak memory against the separable branch (K2 / K3) on
    the same inputs, and their outputs within GENERIC_REL."""
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.models.necks.frustum_to_voxel import FrustumToVoxel
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    cfg = DfMConfig()
    d, h, w = cfg.num_downsampled_bins, IMG_HW[0] // 4, IMG_HW[1] // 4
    g = torch.Generator().manual_seed(0)
    stereo = torch.randn((1, d, h, w, 32), generator=g)
    cost = 2 * torch.randn((1, d, h, w), generator=g)
    sem = torch.randn((1, h, w, 32), generator=g)
    cam = np.eye(4, dtype=np.float32)
    cam[:3] = KITTI_P2[0]
    cam2img = torch.from_numpy(cam)[None].to(dev)
    coors = cfg.coordinates_3d()
    lines = []
    for dtype in (torch.bfloat16, torch.float32):
        neck = init_weights(FrustumToVoxel(64, 32, cfg.depth_min,
                                           cfg.depth_max)).to(dev).eval()
        args = [x.to(dev, dtype) for x in (stereo, cost, sem)]
        outs, res = {}, {}
        for sep in (False, True):
            neck.separable = sep
            K.reset_launch_counts()
            with torch.inference_mode():
                ms, peak, out = _timed(lambda: neck(
                    args[0], args[1], args[2], coors, cam2img, IMG_HW))
            launched = {k: n for k, n in K.LAUNCHES.items() if n}
            check(bool(launched) == sep, f'frustum (18) separable={sep}: '
                  f'launches {launched}')
            outs[sep] = out.float()
            res[sep] = (ms, peak)
        rel = float((outs[False] - outs[True]).norm() /
                    outs[True].norm().clamp(min=1e-30))
        check(np.isfinite(rel) and rel <= GENERIC_REL and
              float(outs[True].abs().max()) > 0,
              f'frustum (18) {dtype}: generic against separable {rel}')
        lines.append(
            f'{str(dtype)[6:]}: generic ms {[round(v, 3) for v in res[False][0]]}'
            f' peak_mem_bytes {res[False][1]}; separable ms '
            f'{[round(v, 3) for v in res[True][0]]} peak_mem_bytes '
            f'{res[True][1]}; relative L2 {rel:.3g}')
        del neck, args, outs
        torch.cuda.empty_cache()
    print(f'frustum (18) FrustumToVoxel at the full DfMConfig ({d} planes at '
          f'{h}x{w}, 64 channels, grid {cfg.voxel_grid_size()}), B = 1, '
          'after one call: ' + ' | '.join(lines)
          + f'; {time.perf_counter() - t_phase:.1f} s', flush=True)


def _kitti_lidar_trees(work):
    """Two KITTI trees with velodyne points and train / val infos, the
    second with `create_data --with-gt-db`'s database."""
    import os
    from dfm_tpu_torch.tools import create_data
    roots = []
    for tag, extra in (('plain', []), ('gtdb', ['--with-gt-db'])):
        root = os.path.join(work, f'kitti_lidar_{tag}')
        write_kitti_tree(root)
        check(create_data.main(['kitti', '--root', root, '--splits', 'train',
                                'val'] + extra) == 0,
              f'voxelnet (19) create_data {tag}')
        roots.append(root)
    check(os.path.exists(os.path.join(roots[1],
                                      'dfm_gt_database_infos.pkl')),
          'voxelnet (19): no GT database')
    return roots


def _voxelnet_train(procs, work, tag, root, batch=None):
    """19 (c): `tools.train` at hv_second_kitti_3class.py (its B = 6, or
    `batch`), 3 steps on the KITTI velodyne tree `root`, in a process of
    its own."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    _start(procs, f'lidar train {tag}', [
        'dfm_tpu_torch.tools.train',
        os.path.join(here, 'configs', LIDAR_CONFIGS[0]), '--max-steps', '3',
        '--work-dir', os.path.join(work, f'lidar_{tag}'),
        '--cfg-options', f'data.data_root={root}'] + (
            [f'data.batch_size_per_chip={batch}'] if batch else []))


def voxelnet_phase(dev, procs, work):
    """19. The SECOND LiDAR family at configs/hv_second_kitti_3class.py
    (18,000 points, grid 20x400x352, 5 points a voxel): (a) card against
    CPU at a tiny grid, (b) requests in bf16 and f32 by stage, a
    DynamicVoxelNet request (its training steps: `voxelnet_steps`), (c)
    `tools.test --synthetic` and `tools.train` on a KITTI tree without
    the GT database at B = 6 and on one with it at B = 2 (two trainings
    at B = 6, ~30 GB each, and the rest of phases 17-20 would outgrow the
    card), started here in processes of their own."""
    import os
    from dfm_tpu_torch.apis import init_lidar_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.dynamic_voxelnet import (
        DynamicVoxelNet, DynamicVoxelNetConfig)
    from dfm_tpu_torch.models.detectors.voxelnet import (
        VoxelNet, VoxelNetConfig, voxelnet_predict)
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    configs = [os.path.join(here, 'configs', c) for c in LIDAR_CONFIGS]
    plain, gtdb = _kitti_lidar_trees(work)
    _voxelnet_train(procs, work, 'plain', plain)
    _voxelnet_train(procs, work, 'gtdb', gtdb, batch=2)
    _start(procs, 'lidar test', ['dfm_tpu_torch.tools.test', configs[0],
                                 '--synthetic'])

    # (a) the card against the CPU at the tiny grid, f32, TF32 off
    pts = torch.from_numpy(np.stack([lidar_cloud(
        LIDAR_TINY['point_cloud_range'], 3000, s) for s in (0, 1)]))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    flags = _no_tf32()
    try:
        rels = {}
        for cls, cfg_cls, opts in (
                (VoxelNet, VoxelNetConfig, {}),
                (DynamicVoxelNet, DynamicVoxelNetConfig,
                 dict(max_points_per_voxel=None))):
            cfg = cfg_cls(**dict(LIDAR_TINY, **opts))
            outs = {}
            for d in ('cpu', dev):
                model = _live_weights(init_weights(cls(cfg), 5), 6,
                                      3.0).to(d).eval()
                with torch.inference_mode():
                    out = model(pts.to(d), mask.to(d))
                outs[d] = {k: v.float().cpu() for k, v in out.items()}
            rel = _rel_l2s(outs[dev], outs['cpu'])
            rels[cls.__name__] = max(rel.values())
            check(rels[cls.__name__] <= LIDAR_REL_L2,
                  f'voxelnet (19a) {cls.__name__} card vs CPU: {rel}')
    finally:
        _set_tf32(flags)
    print(f'voxelnet (19a) tiny grid (8, 40, 40), 2 x 3000 points, f32, TF32 '
          f'off, card vs CPU: outputs relative L2 max '
          f'{ {k: float(f"{v:.3g}") for k, v in rels.items()} }', flush=True)

    # (b) the full config: requests, training steps
    mcfg = build_detector(load_config(configs[0]).model)
    pcr = mcfg.point_cloud_range
    req = torch.from_numpy(lidar_cloud(pcr, LIDAR_POINTS, 2))[None].to(dev)
    req_mask = torch.ones(req.shape[:2], dtype=torch.bool, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        h = init_lidar_model(mcfg, dtype)
        model = _live_weights(h['model'], 7, 3.0)
        enc = model.encoder
        stages = [
            ('voxelize', lambda _: enc.voxelize(req, req_mask)),
            ('encoder + BEV', lambda x: enc.encode(x)[1]),
            ('head', lambda bev: dict(zip(
                ('cls_score', 'bbox_pred', 'dir_pred'),
                model.bbox_head(bev.permute(0, 3, 1, 2))))),
            ('predict', lambda o: voxelnet_predict(o, mcfg))]
        ms, st, peak, det = _request_times(lambda: h['infer'](req, req_mask),
                                           stages, 'voxelnet (19b)')
        kept = _finite_dets(det, 'voxelnet (19b)')
        tf32 = '' if dtype == torch.bfloat16 else ' (TF32 as PyTorch has it)'
        print(_stage_line(
            f'voxelnet (19b) {LIDAR_CONFIGS[0]} request {str(dtype)[6:]}'
            f'{tf32}, {LIDAR_POINTS} points, grid {enc.grid_size()}', ms, st,
            peak) + f'; kept {kept}', flush=True)
        del h, model, enc
        gc.collect()
        torch.cuda.empty_cache()
    dyn = DynamicVoxelNetConfig(**{**vars(mcfg), 'max_points_per_voxel':
                                   None})
    h = init_lidar_model(dyn, torch.float32)
    ms, peak, det = _timed(lambda: h['infer'](req, req_mask))
    kept = _finite_dets(det, 'voxelnet (19b) dynamic')
    print(f'voxelnet (19b) DynamicVoxelNet request f32 (TF32 as PyTorch has '
          f'it): ms {[round(v, 3) for v in ms]}; peak_mem_bytes {peak}; kept '
          f'{kept}', flush=True)
    del h
    print(f'voxelnet phase (a, b) {time.perf_counter() - t_phase:.1f} s',
          flush=True)


def voxelnet_steps(dev):
    """19 (b)'s f32 training steps at B = 6, run once (c)'s processes have
    ended: their training at B = 6 and these together would outgrow the
    card's memory."""
    import os
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.models.detectors.voxelnet import VoxelNet
    from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    configs = [os.path.join(here, 'configs', c) for c in LIDAR_CONFIGS]
    b = load_config(configs[0]).data.batch_size_per_chip
    for config in configs:
        cfg = build_detector(load_config(config).model)
        model = init_weights(VoxelNet(cfg)).to(dev)
        _train_step_line(
            f'voxelnet (19b) {os.path.basename(config)} training step '
            f'(bbox_head {cfg.bbox_head}), f32 (TF32 as PyTorch has it), '
            f'B = {b} x {LIDAR_POINTS} points', model,
            lambda i, c=cfg: lidar_to_device(lidar_synth(
                c, b, i, n=LIDAR_POINTS), dev), dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def _second_state_dict(teacher, seed):
    """A seeded SECOND teacher state dict in the reference's key names
    (`lidar_model.middle_encoder.*` in spconv v2's (kz, ky, kx, C_in,
    C_out) layout, `lidar_model.backbone.*` the BEV hourglass) for the
    port's `SparseLidarTeacher` `teacher`, and the port state dict it
    should convert to."""
    from dfm_tpu_torch.utils.weights import SPARSE_ENCODER_LAYERS
    from dfm_tpu_torch.utils.weights import init_weights
    init_weights(teacher, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in teacher.state_dict().items():
            if name.endswith(('running_mean', 'bias')):
                t.add_(0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith(('running_var', 'weight')) and t.dim() == 1:
                t.mul_(1 + 0.2 * torch.rand(t.shape, generator=g))
    port = teacher.state_dict()
    layers = ['conv_input', 'encoder_layers.encoder_layer1.0'] + [
        f'encoder_layers.encoder_layer{s + 1}.{j}'
        for s in (1, 2, 3) for j in (0, 1, 2)]
    sd = {}
    for (conv, bn), layer in zip(SPARSE_ENCODER_LAYERS, layers):
        k = port[f'middle_encoder.{conv}.kernel']
        sd[f'middle_encoder.{layer}.0.weight'] = k.reshape(
            3, 3, 3, k.shape[1], k.shape[2])
        for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
            sd[f'middle_encoder.{layer}.1.{leaf}'] = \
                port[f'middle_encoder.{bn}.{leaf}']
    k = port['middle_encoder.conv_out.kernel']
    sd['middle_encoder.conv_out.0.weight'] = k.reshape(1, 1, 1, *k.shape[1:])
    for name, t in port.items():
        if name.startswith('bev.'):
            sd['backbone.' + name[len('bev.'):]] = t
    return {f'lidar_model.{k}': v.clone() for k, v in sd.items()}, port


def sparse_teacher_phase(dev, work):
    """20. DfMWithTeacher(teacher_encoder='sparse') at the full DfMConfig:
    (a) the sparse teacher card against CPU at a small sparse shape, (b)
    the teacher's weights from the SECOND converter on a seeded state dict
    in the reference's key names, (c) full-width f32 steps at B = 1 with
    TEACHER_POINTS points: the split, peak memory, occupied voxels against
    the capacity, one launch each of K1, K2, K3, K1-bwd and K2-bwd a
    step."""
    import os
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.models.detectors.dfm_with_teacher import \
        DfMWithTeacher
    from dfm_tpu_torch.models.detectors.teacher import SparseLidarTeacher
    from dfm_tpu_torch.ops.cuda import sampling as K
    from dfm_tpu_torch.runtime.adapters import dfm_synth, to_device
    from dfm_tpu_torch.runtime.schedule import liga_schedule
    from dfm_tpu_torch.runtime.train import TrainStep, make_optimizer
    from dfm_tpu_torch.tools.model_converters import \
        convert_second_checkpoints as CONV
    from dfm_tpu_torch.utils.msgpack_tree import load_msgpack_tree
    from dfm_tpu_torch.utils.weights import init_weights, teacher_state_dict
    t_phase = time.perf_counter()
    full = DfMConfig()
    pcr = full.point_cloud_range
    # (a) card against CPU, a small sparse shape past its capacity
    pts = torch.from_numpy(np.stack([lidar_cloud(pcr, 1500, s)
                                     for s in (3, 4)]))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    flags = _no_tf32()
    try:
        outs, keys = {}, {}
        for d in ('cpu', dev):
            t = init_weights(SparseLidarTeacher(pcr, bev_channels=16,
                                                **SPARSE_SMALL), 3)
            t = t.to(d).eval()
            with torch.inference_mode():
                keys[d] = [x.cpu() for x in t.voxelize(pts.to(d),
                                                       mask.to(d))]
                vol, bev = t(pts.to(d), mask.to(d))
            outs[d] = dict(vol=vol.float().cpu(), bev=bev.float().cpu())
        rel = _rel_l2s(outs[dev], outs['cpu'])
        check(torch.equal(keys[dev][0], keys['cpu'][0]) and
              torch.equal(keys[dev][2], keys['cpu'][2]) and
              max(rel.values()) <= SPARSE_REL_L2,
              f'sparse (20a) card vs CPU: keys equal '
              f'{torch.equal(keys[dev][0], keys["cpu"][0])}, {rel}')
    finally:
        _set_tf32(flags)
    print(f'sparse (20a) SparseLidarTeacher {SPARSE_SMALL}, 2 x 1500 points, '
          f'f32, TF32 off, card vs CPU: keys and masks equal, '
          f'{int(keys["cpu"][2].sum())} of {2 * SPARSE_SMALL["capacity"]} '
          f'slots active, outputs relative L2 '
          f'{ {k: float(f"{v:.3g}") for k, v in rel.items()} }', flush=True)

    # (b) the teacher's weights through the converter
    model = init_weights(DfMWithTeacher(full, 'sparse'))
    sd, want = _second_state_dict(SparseLidarTeacher(
        pcr, bev_channels=full.bev_channels), 11)
    src, dst = os.path.join(work, 'second.pth'), os.path.join(
        work, 'sparse_teacher.msgpack')
    torch.save({'state_dict': sd}, src)
    t0 = time.perf_counter()
    check(CONV.main([src, dst]) == 0, 'sparse (20b) the converter failed')
    conv_ms = (time.perf_counter() - t0) * 1e3
    missing, unexpected = model.lidar_teacher.load_state_dict(
        teacher_state_dict(load_msgpack_tree(dst), 'sparse'), strict=True)
    check(all(torch.equal(v, want[k]) for k, v in
              model.lidar_teacher.state_dict().items()),
          'sparse (20b): the converted teacher differs from its weights')
    print(f'sparse (20b) SECOND state dict ({len(sd)} reference keys) -> '
          f'converter ({conv_ms:.1f} ms) -> teacher_state_dict(sparse): the '
          'seeded weights, bit for bit', flush=True)

    # (c) full-width steps
    model = model.to(dev)
    step = TrainStep(model, make_optimizer(
        model, frozen_prefixes=('lidar_teacher',)), liga_schedule(1e-3))
    before = {k: v.clone() for k, v in model.lidar_teacher.state_dict()
              .items()}

    def batch(i):
        b = dfm_synth(full, 1, i, h=IMG_HW[0], w=IMG_HW[1], full=True)
        b['points'] = lidar_cloud(pcr, TEACHER_POINTS, 10 + i)[None]
        b['point_mask'] = np.ones((1, TEACHER_POINTS), bool)
        for k in ('gt_bboxes2d', 'centers2d'):
            b.pop(k, None)
        return to_device(b, dev)

    for i in range(2):
        step(*batch(i), torch.Generator(device=dev).manual_seed(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for i in range(2):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        img, meta, gt = batch(i + 2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        total, losses = step.forward(
            img, meta, gt, torch.Generator(device=dev).manual_seed(i))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        step.backward(total)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        norm = step.update()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        check_launches(dict(K.LAUNCHES), 'train', 1,
                       f'sparse (20c) step {i}')
        splits.append([(t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                       (t4 - t3) * 1e3])
        vals = {k: float(v.detach())
                for k, v in dict(loss=total, **losses).items()}
        check('loss_imitation' in vals and all(np.isfinite(x) for x in
                                               vals.values()),
              f'sparse (20c) step: {vals}')
    peak = torch.cuda.max_memory_allocated()
    after = model.lidar_teacher.state_dict()
    check(all(torch.equal(before[k], after[k]) for k in before
              if not k.endswith(('running_mean', 'running_var'))),
          'sparse (20c): the update changed a teacher parameter')
    with torch.no_grad():
        occupied = int(model.lidar_teacher.voxelize(
            gt['points'], gt['point_mask'])[2].sum())
    print(f'sparse (20c) DfMWithTeacher(sparse) full DfMConfig, f32 (TF32 as '
          f'PyTorch has it), B = 1, {TEACHER_POINTS} points, after 2 warm-up '
          'steps, ms (data, forward, backward, optimizer): '
          + ' | '.join(', '.join(f'{x:.3f}' for x in row) for row in splits)
          + f'; peak_mem_bytes {peak}; occupied voxels {occupied} of '
          f'{model.lidar_teacher.capacity}; losses '
          f'{ {k: round(x, 5) for k, x in vals.items()} } grad_norm '
          f'{float(norm):.5g}; launches per step '
          f'{ {k: n for k, n in K.LAUNCHES.items() if n} } (K1, K2, K3, '
          f'K1-bwd, K2-bwd once each); teacher parameters unchanged; '
          f'{time.perf_counter() - t_phase:.1f} s', flush=True)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()


def _lidar_cli_checks(procs):
    """The processes of phases 17 and 19: the LET lines of tools.test on
    the converted Waymo tree, tools.train's steps on the KITTI trees (the
    GT database read where it exists), tools.test --synthetic."""
    t0 = time.perf_counter()
    cli = _finish(procs)
    for name, res in cli.items():
        check(res.returncode == 0, f'{name}: rc {res.returncode} '
              f'{res.stderr[-3000:]}')
    out = cli['waymo test'].stdout
    lets = re.findall(r'^(?:Vehicle|Pedestrian|Cyclist|Sign|Overall) '
                      r'mAP\w?: (\S+)$', out, re.M)
    check(len(lets) == 15 and all(np.isfinite(float(x)) for x in lets) and
          f'[{WAYMO_RAW_FRAMES}/{WAYMO_RAW_FRAMES}]' in out,
          f'waymo (17) tools.test: {out[-2000:]}')
    for tag in ('plain', 'gtdb'):
        out = cli[f'lidar train {tag}'].stdout
        check('step 3/3' in out and ('ObjectSample GT database' in out) ==
              (tag == 'gtdb'), f'voxelnet (19c) train {tag}: {out[-2000:]}')
    check('[synthetic-eval] VoxelNet: decoded 5 output arrays, finite=True'
          in cli['lidar test'].stdout, 'voxelnet (19c) tools.test')
    print(f'waymo (17) tools.test on the converted tree: '
          f'{len(lets)} LET lines ({", ".join(lets[-3:])} overall); voxelnet '
          '(19c) tools.train 3 steps on KITTI velodyne trees without (B = '
          '6) and with (B = 2) the GT database, tools.test --synthetic '
          'finite; waited '
          f'{time.perf_counter() - t0:.1f} s for them', flush=True)


def lidar_phases(dev):
    """Phases 17-20, their processes collected at the end, then phase 19's
    training steps: no two trainings at B = 6 (about 30 GB each) share
    the card."""
    import tempfile
    t0 = time.perf_counter()
    procs = {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        try:
            waymo_convert_phase(procs, work)
            voxelnet_phase(dev, procs, work)
            frustum_generic_phase(dev)
            sparse_teacher_phase(dev, work)
            _lidar_cli_checks(procs)
            voxelnet_steps(dev)
        finally:
            _kill(procs)
    print(f'phases 17-20 {time.perf_counter() - t0:.1f} s', flush=True)


def phases17_20_alone(dev='cuda'):
    """Phases 17-20 by themselves, the kernels built first."""
    from dfm_tpu_torch.ops.cuda import build
    print(card_line(), flush=True)
    build.build_all()
    lidar_phases(dev)


LIDAR2_CONFIGS = dict(CenterPoint='centerpoint_second_waymo.py',
                      SASSD='sassd_kitti_3class.py',
                      PartA2='parta2_kitti_3class.py',
                      PointRCNN='point_rcnn_kitti.py')
# (b) / (c): points a request / a training sample (each config's
# data.max_points, Part-A2's inherited from the SECOND config)
LIDAR2_POINTS = dict(CenterPoint=32000, SASSD=18000, PartA2=18000,
                     PointRCNN=16384)
LIDAR2_RANGE = (0.0, -8.0, -2.0, 16.0, 8.0, 1.2)
LIDAR2_ANCHORS = ((0, -8, -0.6, 16, 8, -0.6), (0, -8, -0.6, 16, 8, -0.6),
                  (0, -8, -1.78, 16, 8, -1.78))
# (a): the tiny configs of tests/test_torch_{centerpoint,sassd,parta2,
# point_rcnn}.py, and the points a sample
LIDAR2_TINY = dict(
    CenterPoint=dict(point_cloud_range=LIDAR2_RANGE,
                     voxel_size=(0.4, 0.4, 0.8), max_points_per_voxel=5,
                     encoder_channels=8, second_channels=(16, 32),
                     second_layers=(1, 1), fpn_channels=(16, 16),
                     head=dict(share_conv_channel=16, head_conv=16,
                               voxel_size=(0.4, 0.4), pc_range=(0.0, -8.0),
                               max_per_task=20)),
    SASSD=dict(point_cloud_range=LIDAR2_RANGE, voxel_size=(0.4, 0.4, 0.4),
               max_points_per_voxel=5, cv_channels=8, bev_channels=16,
               anchor_ranges=LIDAR2_ANCHORS, nms_pre=256, max_num=30),
    PartA2=dict(point_cloud_range=LIDAR2_RANGE, voxel_size=(0.5, 0.5, 0.4),
                sparse_shape=(9, 32, 32), voxel_capacity=256, unet_base=8,
                bev_channels=16, anchor_ranges=LIDAR2_ANCHORS,
                num_proposals=8, roi_grid=4, roi_pool='points', max_num=6),
    PointRCNN=dict(point_cloud_range=LIDAR2_RANGE,
                   sa_points=(64, 32, 16, 8), num_proposals=32,
                   rpn_nms_thr=0.5, roi_num_points=32, max_num=8))
LIDAR2_TINY_POINTS = 1200
LIDAR2_TRAIN_STEPS = 2        # (d) the CLIs' steps
LIDAR2_INDEX_KEYS = ('keys', 'vmask', 'prop_labels', 'prop_mask',
                     'labels', 'labels_3d', 'mask')


def _lidar2_outputs(out):
    """A model's outputs (CenterPoint's per-task list flattened) on the
    CPU."""
    if isinstance(out, list):
        out = {f'task{i}.{k}': v for i, d in enumerate(out)
               for k, v in d.items()}
    return {k: v.detach().cpu() for k, v in out.items()}


def _lidar2_agree(what, got, want):
    """Index outputs equal, float ones within LIDAR_REL_L2 -> the largest
    relative L2."""
    worst = 0.0
    for k, v in want.items():
        if v.is_floating_point() and k not in LIDAR2_INDEX_KEYS:
            r = float((got[k].double() - v.double()).norm() /
                      v.double().norm().clamp(min=1e-30))
            check(r <= LIDAR_REL_L2, f'{what} {k}: relative L2 {r}')
            worst = max(worst, r)
        else:
            check(torch.equal(got[k], v), f'{what} {k}: indices differ')
    return worst


def _lidar2_parity(dev):
    """(a) The four models at their tiny configs and the PointNet++
    indices, card against CPU, f32, TF32 off."""
    from dfm_tpu_torch.models.backbones import pointnet2 as P2
    from dfm_tpu_torch.models.builder import build_detector, lidar_class
    from dfm_tpu_torch.utils.weights import init_weights
    pts = torch.from_numpy(np.stack([lidar_cloud(
        LIDAR2_RANGE, LIDAR2_TINY_POINTS, s) for s in (3, 4)]))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    flags = _no_tf32()
    lines = []
    try:
        for kind, opts in LIDAR2_TINY.items():
            cfg = build_detector(dict(type=kind, **opts))
            outs = {}
            for d in ('cpu', dev):
                model = _live_weights(init_weights(lidar_class(cfg)(cfg), 5),
                                      6, 0.0).to(d).eval()
                with torch.inference_mode():
                    outs[d] = _lidar2_outputs(model(pts.to(d), mask.to(d)))
            worst = _lidar2_agree(f'lidar2 (21a) {kind}', outs[dev],
                                  outs['cpu'])
            extra = ''
            if 'prop_mask' in outs['cpu']:
                extra = (f', proposals kept '
                         f'{int(outs["cpu"]["prop_mask"].sum())}')
            if 'vmask' in outs['cpu']:
                extra += f', active voxels {int(outs["cpu"]["vmask"].sum())}'
            lines.append(f'{kind} {worst:.3g}{extra}')
        # the PointNet++ index ops on a cloud with dense blobs (ties)
        cloud = torch.from_numpy(np.stack([lidar_cloud(
            (0, -40, -3, 70.4, 40, 1), 4096, s) for s in (5, 6)]))
        got = {}
        for d in ('cpu', dev):
            xyz = cloud.to(d)
            idx = P2.farthest_point_sample(xyz, 1024)
            ctr = P2.gather_points(xyz, idx)
            feats = torch.arange(4096, device=d, dtype=torch.float32)[
                None, :, None].expand(2, -1, 1)
            got[d] = dict(fps=idx, ball=P2.ball_group(xyz, feats, ctr, 0.8,
                                                      32),
                          dilated=P2.ball_group(xyz, feats, ctr, 1.6, 32,
                                                0.8),
                          nn3=P2.lowest_k(P2._sq_dist(ctr[:, :, None],
                                                      xyz[:, None]), 3))
        for k in got['cpu']:
            check(torch.equal(got[dev][k].cpu(), got['cpu'][k]),
                  f'lidar2 (21a) PointNet++ {k}: card and CPU differ')
    finally:
        _set_tf32(flags)
    print('lidar2 (21a) tiny configs, 2 x {} points, f32, TF32 off, card vs '
          'CPU: index outputs (voxel keys, masks, proposal labels and masks) '
          'equal, outputs relative L2 max: '.format(LIDAR2_TINY_POINTS)
          + '; '.join(lines) + '; FPS 1024 of 2 x 4096, ball groups (0.8, '
          '32; dilated 0.8-1.6) and 3-NN indices equal', flush=True)


def _lidar2_stages(kind, model, cfg, req, mask):
    """(name, fn(prev) -> out) of one request, by stage."""
    from dfm_tpu_torch.models.builder import lidar_predict
    predict = lidar_predict(cfg)
    if kind == 'CenterPoint':
        return [('voxelize', lambda _: model.voxelize(req, mask)),
                ('encoder', model.bev),
                ('SECOND + FPN', lambda x: model.neck(model.backbone(x))),
                ('head', model.bbox_head),
                ('predict', lambda o: predict(o, cfg))]
    if kind == 'SASSD':
        enc = model.encoder

        def head(vb):
            cls, reg, dirs = model.bbox_head(vb[1].permute(0, 3, 1, 2))
            return vb[0], dict(cls_score=cls, bbox_pred=reg, dir_pred=dirs)

        def aux(vo):
            model.aux(req, vo[0])
            return vo[1]

        return [('voxelize', lambda _: enc.voxelize(req, mask)),
                ('encoder + BEV', enc.encode), ('head', head), ('aux', aux),
                ('predict', lambda o: predict(o, cfg))]
    if kind == 'PartA2':
        st = {}

        def unet(v):
            st['v'] = v
            seg, bottom = model.unet(*v)
            st['seg'] = (seg, model.seg_cls(seg)[..., 0], model.part_reg(seg))
            return bottom

        def pool(props):
            st['props'] = props
            keys, vfeat, vmask = st['v']
            return model.roi_pool(props['boxes3d'], keys, vfeat, vmask,
                                  *st['seg'])

        def head(pooled):
            rc, rr = model.roi_head(pooled)
            p = st['props']
            return dict(proposals=p['boxes3d'], prop_labels=p['labels'],
                        prop_mask=p['mask'], rcnn_cls=rc, rcnn_reg=rr)

        return [('voxelize', lambda _: model.voxelize(req, mask)),
                ('sparse U-Net', unet),
                ('RPN', lambda b: model.rpn(b)),
                ('proposals', lambda o: model.proposals(*o)),
                ('RoI pool', pool), ('RoI head', head),
                ('predict', lambda o: predict(o, cfg))]
    st = {}

    def props(s1):
        st['s1'] = s1
        return model.proposals(s1[0], s1[2], s1[3])

    def roi(p):
        rc, rr = model.roi_stage(req, st['s1'][1], p[4], p[0])
        return dict(proposals=p[0], prop_labels=p[2], prop_mask=p[3],
                    rcnn_cls=rc, rcnn_reg=rr)

    return [('backbone + FP + RPN', lambda _: model.stage1(req)),
            ('proposals', props), ('RoI stage', roi),
            ('predict', lambda o: predict(o, cfg))]


def _lidar2_fps_share(infer, req):
    """One request with every FPS call timed apart (synchronised before
    and after it: the request's FPS time and its whole time in the same
    run) -> (FPS ms, request ms, FPS calls)."""
    from dfm_tpu_torch.models.backbones import pointnet2 as P2
    from dfm_tpu_torch.models.backbones import pointnet2_msg as P2M
    from dfm_tpu_torch.models.detectors import imvotenet as PI
    from dfm_tpu_torch.models.detectors import votenet as PV
    fps = P2.farthest_point_sample
    spent = []

    def timed(xyz, npoint):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fps(xyz, npoint)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return out

    P2.farthest_point_sample = P2M.farthest_point_sample = \
        PV.farthest_point_sample = PI.farthest_point_sample = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        infer(req)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        P2.farthest_point_sample = P2M.farthest_point_sample = \
            PV.farthest_point_sample = PI.farthest_point_sample = fps
    return sum(spent), total, len(spent)


def _lidar2_requests(dev):
    """(b) Each config at full width: requests in bf16 and f32 by stage,
    peak memory, 0 port-kernel launches; PointRCNN's FPS share."""
    from dfm_tpu_torch.apis import init_lidar_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.runtime.config import load_config
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    for kind, config in LIDAR2_CONFIGS.items():
        mcfg = build_detector(load_config(os.path.join(
            here, 'configs', config)).model)
        n = LIDAR2_POINTS[kind]
        req = torch.from_numpy(lidar_cloud(mcfg.point_cloud_range, n,
                                           21))[None].to(dev)
        mask = torch.ones(req.shape[:2], dtype=torch.bool, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            h = init_lidar_model(mcfg, dtype)
            model = _live_weights(h['model'], 7, 3.0)
            ms, st, peak, det = _request_times(
                lambda: h['infer'](req, mask), _lidar2_stages(
                    kind, model, mcfg, req, mask), f'lidar2 (21b) {kind}')
            det = {k: v for k, v in det.items()}
            check(all(bool(torch.isfinite(v).all()) for v in det.values()
                      if v.is_floating_point()), f'lidar2 (21b) {kind}: '
                  'detections not finite')
            tf32 = '' if dtype == torch.bfloat16 else \
                ' (TF32 as PyTorch has it)'
            grid = dict(CenterPoint=lambda: f', grid {mcfg.grid_size}',
                        SASSD=lambda: f', grid {model.encoder.grid_size()}',
                        PartA2=lambda: f', sparse grid {mcfg.sparse_shape}, '
                        f'{mcfg.voxel_capacity} voxels, pool '
                        f'{mcfg.roi_pool!r} at {mcfg.roi_grid}',
                        PointRCNN=lambda: '')[kind]()
            print(_stage_line(
                f'lidar2 (21b) {config} request {str(dtype)[6:]}{tf32}, '
                f'{n} points{grid}', ms, st, peak), flush=True)
            if kind == 'PointRCNN':
                fps, total, calls = _lidar2_fps_share(h['infer'], req)
                print(f'lidar2 (21b) PointRCNN {str(dtype)[6:]}: FPS '
                      f'({calls} calls) {fps:.3f} ms of one request of '
                      f'{total:.3f} ms (each call synchronised): share '
                      f'{fps / total:.3f}', flush=True)
            del h, model
            gc.collect()
            torch.cuda.empty_cache()


def _lidar2_steps(dev):
    """(c) One f32 training step of each config at its per-chip batch."""
    from dfm_tpu_torch.models.builder import build_detector, lidar_class
    from dfm_tpu_torch.runtime.adapters import lidar_synth, lidar_to_device
    from dfm_tpu_torch.runtime.config import load_config
    from dfm_tpu_torch.utils.weights import init_weights
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    for kind, config in LIDAR2_CONFIGS.items():
        cfg = load_config(os.path.join(here, 'configs', config))
        mcfg = build_detector(cfg.model)
        b = cfg.data.batch_size_per_chip
        n = LIDAR2_POINTS[kind]
        model = init_weights(lidar_class(mcfg)(mcfg)).to(dev)
        _train_step_line(
            f'lidar2 (21c) {config} training step, f32 (TF32 as PyTorch has '
            f'it), B = {b} x {n} points', model,
            lambda i, c=mcfg: lidar_to_device(lidar_synth(c, b, i, n=n),
                                              dev), dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def _lidar2_train(procs, work, root, kind):
    """(d) `tools.train` of `kind`'s config in a process of its own, on the
    KITTI velodyne tree `root` (CenterPoint, SASSD) or with `--synthetic`
    (PartA2, PointRCNN), at its per-chip batch but SA-SSD's (B = 2: its
    B = 6 takes 31 GB, as much as (c)'s step, beside the rest of (d))."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    data = ['--synthetic', '--cfg-options'] if kind in (
        'PartA2', 'PointRCNN') else [
        '--cfg-options', 'data.type=KittiDataset', f'data.data_root={root}']
    if kind == 'SASSD':
        data.append('data.batch_size_per_chip=2')
    _start(procs, f'lidar2 train {kind}', [
        'dfm_tpu_torch.tools.train',
        os.path.join(here, 'configs', LIDAR2_CONFIGS[kind]), '--max-steps',
        str(LIDAR2_TRAIN_STEPS), '--work-dir',
        os.path.join(work, f'lidar2_{kind}')] + data)


def _lidar2_clis(procs, work):
    """(d) The CLIs in processes of their own: `tools.test --synthetic` on
    each config and `tools.train` of all but CenterPoint (whose follows
    beside (c), `lidar2_phase`). In process, the refusals: tools.train
    PartA2 / PointRCNN without `--synthetic`, tools.test CenterPoint on
    its WaymoDataset (rc 2 each). Returns the KITTI velodyne tree."""
    import contextlib
    import io
    import os
    from dfm_tpu_torch.tools import create_data
    from dfm_tpu_torch.tools import test as test_cli
    from dfm_tpu_torch.tools import train as train_cli
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(work, 'kitti_lidar2')
    write_kitti_tree(root)
    check(create_data.main(['kitti', '--root', root, '--splits', 'train'])
          == 0, 'lidar2 (21d) create_data')
    for kind, config in LIDAR2_CONFIGS.items():
        path = os.path.join(here, 'configs', config)
        _start(procs, f'lidar2 test {kind}', ['dfm_tpu_torch.tools.test', path,
                                              '--synthetic'])
        if kind != 'CenterPoint':
            _lidar2_train(procs, work, root, kind)
    refused = []
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        for kind in ('PartA2', 'PointRCNN'):
            refused.append(train_cli.main([
                os.path.join(here, 'configs', LIDAR2_CONFIGS[kind]),
                '--work-dir', os.path.join(work, 'refused')]))
        refused.append(test_cli.main([os.path.join(
            here, 'configs', LIDAR2_CONFIGS['CenterPoint'])]))
    check(refused == [2, 2, 2] and err.getvalue().count('--synthetic') == 3,
          f'lidar2 (21d) refusals: {refused} {err.getvalue()[-1500:]}')
    return root


def _lidar2_cli_checks(procs):
    """Wait for (d)'s processes of `procs` (emptied) and check what each
    printed -> the names checked and the seconds waited."""
    t0 = time.perf_counter()
    cli = _finish(procs)
    procs.clear()
    arrays = dict(CenterPoint=3, SASSD=5, PartA2=4, PointRCNN=4)
    for name, res in cli.items():
        check(res.returncode == 0, f'{name}: rc {res.returncode} '
              f'{res.stderr[-3000:]}')
        kind = name.split()[-1]
        if name.startswith('lidar2 test'):
            check(f'[synthetic-eval] {kind}: decoded {arrays[kind]} output '
                  'arrays, finite=True' in res.stdout,
                  f'lidar2 (21d) tools.test {kind}')
        else:
            check(f'step {LIDAR2_TRAIN_STEPS}/{LIDAR2_TRAIN_STEPS}' in
                  res.stdout, f'lidar2 (21d) tools.train {kind}: '
                  f'{res.stdout[-2000:]}')
    return list(cli), time.perf_counter() - t0


def lidar2_phase(dev):
    """21. CenterPoint, SA-SSD, Part-A2 and PointRCNN, no port kernel on
    their paths: (d)'s CLIs but CenterPoint's training started first, (a)
    card against CPU at tiny sizes, (b) full-width requests; those CLIs
    collected, CenterPoint's training (15 GB) started, (c) the full-width
    training steps (SA-SSD's 31 GB), that CLI collected."""
    import tempfile
    t0 = time.perf_counter()
    procs = {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        try:
            root = _lidar2_clis(procs, work)
            _lidar2_parity(dev)
            _lidar2_requests(dev)
            names, waited = _lidar2_cli_checks(procs)
            _lidar2_train(procs, work, root, 'CenterPoint')
            _lidar2_steps(dev)
            more, more_s = _lidar2_cli_checks(procs)
            check(len(names + more) == 8, f'lidar2 (21d): {names + more}')
            print(f'lidar2 (21d) tools.test --synthetic on the four configs '
                  f'(finite decodes), tools.train {LIDAR2_TRAIN_STEPS} steps '
                  'each (CenterPoint, and SASSD at B = 2, on a KITTI '
                  'velodyne tree, '
                  'PartA2 and PointRCNN --synthetic), the refusals rc 2 '
                  f'naming --synthetic; waited {waited:.1f} s for them after '
                  f'(b), {more_s:.1f} s for CenterPoint\'s after (c)',
                  flush=True)
        finally:
            _kill(procs)
    print(f'phase 21 {time.perf_counter() - t0:.1f} s', flush=True)


def phase21_alone(dev='cuda'):
    """Phase 21 by itself (no kernel build: none lies on its paths)."""
    print(card_line(), flush=True)
    lidar2_phase(dev)


SUNRGBD_NAMES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                 'dresser', 'night_stand', 'bookshelf', 'bathtub')
# NYU40 ids of ScanNet's 18 classes
SCANNET_NYU_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34,
                   36, 39)


def _room_points(rng, n, centres):
    """(n, 6) float32 xyz + rgb: half uniform in a 6 x 6 x 2.5 m room, the
    rest in blobs around `centres`."""
    per = (n - n // 2) // len(centres) + 1
    blobs = np.concatenate([c + 0.3 * rng.standard_normal((per, 3))
                            for c in centres])[:n - n // 2]
    pts = np.concatenate([rng.uniform((-3, 0, -1), (3, 6, 1.5),
                                      (n // 2, 3)), blobs])
    return np.concatenate([pts, rng.uniform(0, 255, (n, 3))],
                          1).astype(np.float32)


def write_sunrgbd_tree(root, seed=0, splits=(('train', (1, 2)),
                                             ('val', (3, 4))),
                       points=3000, jpeg=None):
    """SUN RGB-D's extracted layout under `root`/sunrgbd_trainval:
    `{split}_data_idx.txt`, depth/{idx:06d}.mat ('instance': (points, 6)
    xyz rgb, `scipy.io.savemat`), image/{idx:06d}.jpg (the `jpeg` bytes,
    the committed small_420 fixture if None; the last frame has no
    image), calib/ (Rt and K, column-major rows) and label/ (three objects
    of the ten classes and a 'lamp' a frame), random from `seed`."""
    import os
    import scipy.io as sio
    if jpeg is None:
        folder, _ = _jpeg_fixtures()
        with open(os.path.join(folder, 'small_420.jpg'), 'rb') as f:
            jpeg = f.read()
    rng = np.random.default_rng(seed)
    tv = os.path.join(root, 'sunrgbd_trainval')
    for sub in ('depth', 'image', 'calib', 'label'):
        os.makedirs(os.path.join(tv, sub), exist_ok=True)
    last = max(i for _, ids in splits for i in ids)
    for split, ids in splits:
        with open(os.path.join(tv, f'{split}_data_idx.txt'), 'w') as f:
            f.write('\n'.join(str(i) for i in ids) + '\n')
        for idx in ids:
            name = f'{idx:06d}'
            objs = []
            for j, cls in enumerate(list(rng.choice(SUNRGBD_NAMES, 3)) +
                                    ['lamp']):
                ctr = rng.uniform((-2, 1.5, -0.5), (2, 5, 0.8))
                half = rng.uniform(0.3, 1.0, 3)
                yaw = rng.uniform(-np.pi, np.pi)
                objs.append((cls, ctr, half, yaw))
            sio.savemat(os.path.join(tv, 'depth', name + '.mat'), dict(
                instance=_room_points(rng, points, [o[1] for o in objs])))
            if idx != last:
                with open(os.path.join(tv, 'image', name + '.jpg'),
                          'wb') as f:
                    f.write(jpeg)
            rt = np.eye(3) + 0.01 * rng.standard_normal((3, 3))
            k = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]])
            with open(os.path.join(tv, 'calib', name + '.txt'), 'w') as f:
                for m in (rt, k):
                    f.write(' '.join(f'{x:.6f}' for x in m.ravel('F'))
                            + '\n')
            with open(os.path.join(tv, 'label', name + '.txt'), 'w') as f:
                for cls, ctr, half, yaw in objs:
                    box2d = rng.uniform(0, 300, 4)
                    vals = [*box2d, *ctr, half[1], half[0], half[2],
                            np.cos(yaw), np.sin(yaw)]
                    f.write(cls + ' ' + ' '.join(f'{v:.6f}' for v in vals)
                            + '\n')
    return root


def write_scannet_tree(root, seed=0, splits=(
        ('train', ('scene0000_00', 'scene0001_00')),
        ('val', ('scene0002_00', 'scene0003_00'))), points=3000):
    """ScanNet's extracted layout under `root`: meta_data/scannetv2_{split}
    .txt and scannet_instance_data/{scene}_{vert, ins_label, sem_label,
    aligned_bbox, unaligned_bbox, axis_align_matrix}.npy: four boxes a
    scene of NYU40 ids of the 18 classes, each with its points' instance
    and semantic labels, the scene turned about z and shifted by its
    axis_align_matrix, random from `seed`."""
    import os
    rng = np.random.default_rng(seed)
    inst = os.path.join(root, 'scannet_instance_data')
    os.makedirs(inst, exist_ok=True)
    os.makedirs(os.path.join(root, 'meta_data'), exist_ok=True)
    for split, ids in splits:
        with open(os.path.join(root, 'meta_data', f'scannetv2_{split}.txt'),
                  'w') as f:
            f.write('\n'.join(ids) + '\n')
        for sid in ids:
            ctrs = rng.uniform((-2, 1, -0.5), (2, 5, 0.8), (4, 3))
            dims = rng.uniform(0.4, 1.8, (4, 3))
            nyu = rng.choice(SCANNET_NYU_IDS, 4)
            vert = _room_points(rng, points, list(ctrs))
            ins = np.zeros(points, np.int64)
            sem = np.zeros(points, np.int64)
            for j in range(4):
                inside = (np.abs(vert[:, :3] - ctrs[j]) <= dims[j] / 2).all(1)
                ins[inside], sem[inside] = j + 1, nyu[j]
            ang = rng.uniform(-0.3, 0.3)
            c, s = np.cos(ang), np.sin(ang)
            align = np.array([[c, -s, 0, rng.uniform(-1, 1)],
                              [s, c, 0, rng.uniform(-1, 1)], [0, 0, 1, 0.1],
                              [0, 0, 0, 1]])
            # the scene as scanned: the aligned one moved by the inverse
            raw = vert.copy()
            raw[:, :3] = (vert[:, :3] - align[:3, 3]) @ align[:3, :3]
            aligned = np.concatenate([ctrs, dims, nyu[:, None]], 1)
            unaligned = aligned.copy()
            unaligned[:, :3] = (ctrs - align[:3, 3]) @ align[:3, :3]
            for key, arr in (('vert', raw), ('ins_label', ins),
                             ('sem_label', sem), ('aligned_bbox', aligned),
                             ('unaligned_bbox', unaligned),
                             ('axis_align_matrix', align)):
                np.save(os.path.join(inst, f'{sid}_{key}.npy'), arr)
    return root


INDOOR_CONFIGS = dict(SSD3DNet='ssd3d_kitti_car.py',
                      MVXFasterRCNN='mvx_fasterrcnn_kitti.py',
                      VoteNet_ScanNet='votenet_scannet.py',
                      VoteNet_SUNRGBD='votenet_sunrgbd.py')
# (b) points a request: 3DSSD's data.num_points, the VoxelNet request's,
# each VoteNet config's data.num_points
INDOOR_POINTS = dict(SSD3DNet=16384, MVXFasterRCNN=18000,
                     VoteNet_ScanNet=40000, VoteNet_SUNRGBD=20000)
MVX_HW = (384, 1280)
# (b) warm-up and timed requests of phases 22 and 23
INDOOR2_WARMUP, INDOOR2_TIMED = 1, 2
INDOOR_TRAIN_STEPS = 2        # (d) the CLIs' steps
# (a): the tiny configs of tests/test_torch_{ssd3d,mvx,votenet}.py
SSD3D_TINY = dict(
    num_candidates=16, sa_num_points=((64,), (32,), (16, 16)),
    sa_fps_ranges=((-1,), (-1,), (32, -1)),
    sa_radii=((0.5, 1.0, 2.0), (1.0, 2.0, 4.0), (2.0, 4.0, 6.0)),
    sa_num_samples=((8, 8, 16), (8, 8, 16), (8, 8, 8)),
    sa_channels=(((8, 8, 16), (8, 8, 16), (8, 8, 16)),
                 ((16, 16, 16), (16, 16, 16), (16, 16, 16)),
                 ((16, 16, 32), (16, 16, 32), (16, 16, 32))),
    sa_aggregation=(16, 24, 32), agg_ks=(8, 16),
    agg_mlps=((16, 16, 32), (16, 16, 32)), shared_channels=(32, 16),
    point_cloud_range=LIDAR2_RANGE, score_thr=0.0, max_num=8)
MVX_TINY = dict(
    LIDAR2_TINY['SASSD'], anchor_sizes=((0.8, 0.6, 1.73), (1.76, 0.6, 1.73),
                                        (3.9, 1.6, 1.56)),
    img_channels=16, fusion_mid=16)
VOTENET_TINY = dict(num_classes=4, num_heading_bins=3, num_proposals=16,
                    mean_sizes=((0.8, 0.8, 0.9), (1.8, 1.8, 1.2),
                                (0.6, 0.6, 0.7), (1.4, 1.5, 0.8)))
INDOOR_INDEX_KEYS = ('seed_points', 'seed_xyz', 'fusion_valid', 'labels',
                     'labels_3d', 'mask')


def _indoor_scene(n, seed, side=2.0):
    """(1, n, 4) points in a `side` m cube with a height column."""
    rng = np.random.default_rng(seed)
    pts = rng.random((1, n, 3)) * side
    return torch.from_numpy(np.concatenate([pts, pts[..., 2:] - 0.1],
                                           -1).astype(np.float32))


def _index_groups(xyz, centers, radius, k):
    """The ball groups of `centers` over `xyz` as point indices (an index
    channel grouped with the points)."""
    from dfm_tpu_torch.models.backbones import pointnet2 as P2
    idx = torch.arange(xyz.shape[1], device=xyz.device, dtype=xyz.dtype)
    return P2.ball_group(xyz, idx[None, :, None].expand(xyz.shape[0], -1, 1),
                         centers, radius, k)[..., 3]


def _indoor_parity(dev):
    """(a) 3DSSD, MVX and VoteNet at their tiny configs, card against CPU,
    f32, TF32 off: the sampled indices (FPS / F-FPS / FS of every stage,
    the vote aggregation's and the proposals' ball groups, the proposals'
    FPS), MVX's PointFusion validity equal, every float output within
    LIDAR_REL_L2."""
    from dfm_tpu_torch.models.backbones import pointnet2 as P2
    from dfm_tpu_torch.models.detectors.mvx_two_stage import (MVXConfig,
                                                              MVXFasterRCNN)
    from dfm_tpu_torch.models.detectors.ssd3d import SSD3DConfig, SSD3DNet
    from dfm_tpu_torch.models.detectors.votenet import (VoteNet,
                                                        VoteNetConfig)
    from dfm_tpu_torch.utils.weights import init_weights
    cloud = np.stack([lidar_cloud(LIDAR2_RANGE, LIDAR2_TINY_POINTS, s)
                      for s in (3, 4)])
    inten = np.random.default_rng(5).random(cloud.shape[:2] + (1,))
    pts4 = torch.from_numpy(np.concatenate([cloud, inten], -1).astype(
        np.float32))
    pts3 = torch.from_numpy(cloud)
    mask = torch.ones(pts3.shape[:2], dtype=torch.bool)
    img = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 64, 96, 3)).astype(np.float32))
    l2i = torch.from_numpy(np.tile(_kitti_lidar2img((64, 96), 400.0)[None],
                                   (2, 1, 1)))
    room = torch.cat([_indoor_scene(2500, 7), _indoor_scene(2500, 8)])
    flags = _no_tf32()
    lines = []
    try:
        cases = (
            ('SSD3DNet', SSD3DNet(SSD3DConfig(**SSD3D_TINY)), (pts4,)),
            ('MVXFasterRCNN', MVXFasterRCNN(MVXConfig(**MVX_TINY)),
             (pts3, mask, img, l2i)),
            ('VoteNet', VoteNet(VoteNetConfig(**VOTENET_TINY)), (room,)))
        for kind, model, args in cases:
            model = _live_weights(init_weights(model, 5), 6, 0.0)
            outs, extra = {}, ''
            for d in ('cpu', dev):
                m = model.to(d).eval()
                a = [x.to(d) for x in args]
                with torch.inference_mode():
                    out = _lidar2_outputs(m(*a))
                    if kind == 'SSD3DNet':
                        feat = m.backbone(a[0])
                        for i, ix in enumerate(feat['sa_indices'][1:]):
                            out[f'sa{i}_indices'] = ix.cpu()
                        seeds = feat['sa_xyz'][-1]
                        cand = out['aggregated_points'].to(d)
                        for r, k in zip(m.cfg.agg_radii, m.cfg.agg_ks):
                            out[f'agg_group_{r}'] = _index_groups(
                                seeds, cand, r, k).cpu()
                    elif kind == 'VoteNet':
                        votes = out['vote_xyz'].to(d)
                        cidx = P2.farthest_point_sample(
                            votes, m.cfg.num_proposals)
                        out['proposal_fps'] = cidx.cpu()
                        out['proposal_groups'] = _index_groups(
                            votes, P2.gather_points(votes, cidx),
                            m.cfg.vote_radius, m.cfg.vote_k).cpu()
                outs[d] = out
            worst = 0.0
            for k, v in outs['cpu'].items():
                got = outs[dev][k]
                if v.is_floating_point() and k not in INDOOR_INDEX_KEYS \
                        and not k.endswith(('_indices', '_fps')) and \
                        'group' not in k:
                    r = float((got.double() - v.double()).norm() /
                              v.double().norm().clamp(min=1e-30))
                    check(r <= LIDAR_REL_L2,
                          f'indoor (22a) {kind} {k}: relative L2 {r}')
                    worst = max(worst, r)
                else:
                    check(torch.equal(got, v),
                          f'indoor (22a) {kind} {k}: card and CPU differ')
            if kind == 'MVXFasterRCNN':
                extra = f', PointFusion valid ' \
                    f'{float(outs["cpu"]["fusion_valid"].float().mean()):.3f}'
            lines.append(f'{kind} {worst:.3g}{extra}')
            model.to('cpu')
    finally:
        _set_tf32(flags)
    print('indoor (22a) tiny configs, f32, TF32 off, card vs CPU: 3DSSD\'s '
          'FPS / F-FPS / FS indices of every stage and its aggregation '
          'groups, MVX\'s PointFusion validity, VoteNet\'s seeds, proposal '
          'FPS and ball groups equal; outputs relative L2 max: '
          + '; '.join(lines), flush=True)


def _indoor_request(kind, mcfg, dev, seed=22):
    """The inputs of one full-width request of `kind`."""
    n = INDOOR_POINTS[kind]
    if kind.startswith('VoteNet'):
        side = 8.0 if kind.endswith('ScanNet') else 6.0
        return (_indoor_scene(n, seed, side).to(dev),)
    pts = torch.from_numpy(lidar_cloud(mcfg.point_cloud_range, n, seed))
    if kind == 'SSD3DNet':
        inten = torch.from_numpy(np.random.default_rng(seed).random(
            (n, 1)).astype(np.float32))
        return (torch.cat([pts, inten], -1)[None].to(dev),)
    img = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1,) + MVX_HW + (3,)).astype(np.float32))
    l2i = torch.from_numpy(_kitti_lidar2img(MVX_HW)[None])
    return (pts[None].to(dev), torch.ones((1, n), dtype=torch.bool,
                                          device=dev), img.to(dev),
            l2i.to(dev))


def _indoor_stages(kind, model, cfg, req):
    """(name, fn(prev) -> out) of one request, by stage."""
    from dfm_tpu_torch.models.builder import lidar_predict
    predict = lidar_predict(cfg)
    st = {}
    if kind == 'SSD3DNet':
        def vote(s):
            st['s'] = s
            return model.candidates(*s)

        def agg(c):
            st['c'] = c
            return model.vote_aggregation(*st['s'], target_xyz=c[0])[1]

        def heads(f):
            cls, reg = model.heads(f)
            nd = cfg.num_dir_bins
            cand, off, seed = st['c']
            return dict(cls_score=cls, center_offset=reg[..., :3],
                        size=reg[..., 3:6], dir_class=reg[..., 6:6 + nd],
                        dir_res_norm=reg[..., 6 + nd:6 + 2 * nd],
                        aggregated_points=cand, vote_offset=off,
                        seed_points=seed)

        return [('backbone', lambda _: model.seeds(req[0])),
                ('vote', vote), ('aggregation', agg), ('heads', heads),
                ('predict', lambda o: predict(o, cfg))]
    if kind == 'MVXFasterRCNN':
        pts, mask, img, l2i = req

        def head(bev):
            cls, reg, dirs = model.bbox_head(bev[1].permute(0, 3, 1, 2))
            return dict(cls_score=cls, bbox_pred=reg, dir_pred=dirs)

        return [('image backbone + FPN', lambda _: model.image_features(img)),
                ('point fusion', lambda f: model.fuse(
                    pts, f, l2i, tuple(img.shape[1:3]))[0]),
                ('voxel encoder + BEV', lambda p: model.pts_encoder(p, mask)),
                ('head', head), ('predict', lambda o: predict(o, cfg))]

    def props(v):
        c, raw = model.proposals(*v)
        return dict(centers=c, raw=raw)

    return [('backbone', lambda _: model.backbone(req[0].to(model.dtype))),
            ('vote', lambda s: model.votes(*s)), ('proposals', props),
            ('predict', lambda o: predict(o, cfg))]


def _indoor_requests(dev):
    """(b) Each config at full width: requests in bf16 and f32 by stage
    (since phase 23 came, INDOOR2_WARMUP warm-ups and INDOOR2_TIMED timed,
    as phase 23's), peak memory, 0 port-kernel launches, FPS's share of a
    request."""
    import os
    from dfm_tpu_torch.apis import init_lidar_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.runtime.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    for kind, config in INDOOR_CONFIGS.items():
        mcfg = build_detector(load_config(os.path.join(
            here, 'configs', config)).model)
        req = _indoor_request(kind, mcfg, dev)
        for dtype in (torch.bfloat16, torch.float32):
            h = init_lidar_model(mcfg, dtype)
            model = _live_weights(h['model'], 7, 3.0)
            ms, st, peak, det = _request_times(
                lambda: h['infer'](*req), _indoor_stages(kind, model, mcfg,
                                                         req),
                f'indoor (22b) {kind}', warmup=INDOOR2_WARMUP,
                timed=INDOOR2_TIMED)
            check(all(bool(torch.isfinite(v).all()) for v in det.values()
                      if v.is_floating_point()), f'indoor (22b) {kind}: '
                  'detections not finite')
            tf32 = '' if dtype == torch.bfloat16 else \
                ' (TF32 as PyTorch has it)'
            extra = f', image {MVX_HW[0]}x{MVX_HW[1]}' \
                if kind == 'MVXFasterRCNN' else ''
            print(_stage_line(
                f'indoor (22b) {config} request {str(dtype)[6:]}{tf32}, '
                f'{INDOOR_POINTS[kind]} points{extra}', ms, st, peak,
                INDOOR2_TIMED), flush=True)
            fps, total, calls = _lidar2_fps_share(
                lambda _: h['infer'](*req), req[0])
            print(f'indoor (22b) {kind} {str(dtype)[6:]}: FPS ({calls} '
                  f'calls) {fps:.3f} ms of one request of {total:.3f} ms '
                  f'(each call synchronised): share {fps / total:.3f}',
                  flush=True)
            del h, model
            gc.collect()
            torch.cuda.empty_cache()


def _indoor_steps(dev, scannet_root):
    """(c) One f32 training step of each config at its per-chip batch:
    3DSSD and MVX on synthetic batches at (b)'s points (MVX's images at
    384x1280 through a KITTI-like camera), VoteNet ScanNet on the ScanNet
    tree's train scenes (`IndoorSource`: the points sampled and augmented
    on the host in the data time)."""
    import os
    from dfm_tpu_torch.models.builder import build_detector, lidar_class
    from dfm_tpu_torch.runtime.adapters import (lidar_synth, lidar_to_device,
                                                mvx_synth, mvx_to_device)
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.tools.train import IndoorSource
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    for kind in ('SSD3DNet', 'MVXFasterRCNN', 'VoteNet_ScanNet'):
        config = INDOOR_CONFIGS[kind]
        cfg = load_config(os.path.join(here, 'configs', config))
        mcfg = build_detector(cfg.model)
        b = cfg.data.batch_size_per_chip
        n = INDOOR_POINTS[kind]
        if kind == 'SSD3DNet':
            def batch_fn(i, c=mcfg):
                return lidar_to_device(lidar_synth(c, b, i, n=n), dev)
        elif kind == 'MVXFasterRCNN':
            l2i = np.tile(_kitti_lidar2img(MVX_HW)[None], (b, 1, 1))

            def batch_fn(i, c=mcfg):
                batch = mvx_synth(c, b, i, n=n, h=MVX_HW[0], w=MVX_HW[1])
                return mvx_to_device(dict(batch, lidar2img=l2i), dev)
        else:
            src = IndoorSource(merge_options(cfg, [
                f'data.data_root={scannet_root}']), b)
            rng = np.random.default_rng(0)

            def batch_fn(i):
                return src.next_batch(i, rng, dev)
        model = init_weights(lidar_class(mcfg)(mcfg)).to(dev)
        _train_step_line(
            f'indoor (22c) {config} training step, f32 (TF32 as PyTorch '
            f'has it), B = {b} x {n} points', model, batch_fn, dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def _indoor_clis(procs, work):
    """(d) The CLIs in processes of their own: `create_data scannet` and
    `sunrgbd` on extracted trees written here (in process), then
    `tools.test` of VoteNet on each tree to the indoor AP lines,
    `tools.train` of VoteNet ScanNet (B = 2) on its tree, and `tools.test`
    / `tools.train` (B = 2) `--synthetic` of 3DSSD and MVX. Returns the
    trees."""
    import contextlib
    import io
    import os
    from dfm_tpu_torch.tools import create_data
    here = os.path.dirname(os.path.abspath(__file__))
    roots = dict(scannet=os.path.join(work, 'scannet'),
                 sunrgbd=os.path.join(work, 'sunrgbd'))
    write_scannet_tree(roots['scannet'], points=50000)
    write_sunrgbd_tree(roots['sunrgbd'], points=30000)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for name, root in roots.items():
            check(create_data.main([name, '--root', root, '--splits',
                                    'train', 'val']) == 0,
                  f'indoor (22d) create_data {name}')
    check(buf.getvalue().count('wrote 2 infos') == 4,
          f'indoor (22d) create_data: {buf.getvalue()}')
    convert_s = time.perf_counter() - t0
    cfgs = {k: os.path.join(here, 'configs', c)
            for k, c in INDOOR_CONFIGS.items()}
    for name, key in (('scannet', 'VoteNet_ScanNet'),
                      ('sunrgbd', 'VoteNet_SUNRGBD')):
        _start(procs, f'indoor test {name}', [
            'dfm_tpu_torch.tools.test', cfgs[key], '--cfg-options',
            f'data.data_root={roots[name]}'])
    _start(procs, 'indoor train scannet', [
        'dfm_tpu_torch.tools.train', cfgs['VoteNet_ScanNet'], '--max-steps',
        str(INDOOR_TRAIN_STEPS), '--work-dir',
        os.path.join(work, 'votenet'), '--cfg-options',
        f'data.data_root={roots["scannet"]}', 'data.batch_size_per_chip=2'])
    for kind in ('SSD3DNet', 'MVXFasterRCNN'):
        _start(procs, f'indoor synthetic-test {kind}', [
            'dfm_tpu_torch.tools.test', cfgs[kind], '--synthetic'])
        _start(procs, f'indoor synthetic-train {kind}', [
            'dfm_tpu_torch.tools.train', cfgs[kind], '--synthetic',
            '--max-steps', str(INDOOR_TRAIN_STEPS), '--work-dir',
            os.path.join(work, kind), '--cfg-options',
            'data.batch_size_per_chip=2'])
    return roots, convert_s


INDOOR_AP = re.compile(r'^(mA[PR]_0\.(?:25|50)): (\S+)$', re.M)


def _indoor_cli_checks(procs):
    """Wait for (d)'s processes of `procs` (emptied) and check what each
    printed -> the names checked, the AP lines and the seconds waited."""
    t0 = time.perf_counter()
    cli = _finish(procs)
    procs.clear()
    aps = {}
    for name, res in cli.items():
        check(res.returncode == 0, f'{name}: rc {res.returncode} '
              f'{res.stderr[-3000:]}')
        if name.startswith('indoor test'):
            lines = dict(INDOOR_AP.findall(res.stdout))
            check(len(lines) == 4 and all(np.isfinite(float(v))
                                          for v in lines.values()),
                  f'{name}: {res.stdout[-2000:]}')
            aps[name.split()[-1]] = lines
        elif name.startswith('indoor synthetic-test'):
            kind = name.split()[-1]
            n = 4 if kind == 'SSD3DNet' else 5
            check(f'[synthetic-eval] {kind}: decoded {n} output arrays, '
                  'finite=True' in res.stdout, f'{name}: {res.stdout[-2000:]}')
        elif 'resume' in name:
            check('resumed from step 2' in res.stdout and
                  f'step {INDOOR_TRAIN_STEPS + 1}/{INDOOR_TRAIN_STEPS + 1}'
                  in res.stdout, f'{name}: {res.stdout[-2000:]}')
        else:
            check(f'step {INDOOR_TRAIN_STEPS}/{INDOOR_TRAIN_STEPS}' in
                  res.stdout, f'{name}: {res.stdout[-2000:]}')
    return list(cli), aps, time.perf_counter() - t0


def indoor_phase(dev):
    """22. 3DSSD, MVX and VoteNet (ScanNet, SUN RGB-D), no port kernel on
    their paths: (d)'s trees converted and its CLIs started, (a) card
    against CPU at tiny sizes, (b) full-width requests; those CLIs
    collected, VoteNet's resume to step 3 started, (c) the full-width
    training steps, the resume collected."""
    import os
    import tempfile
    t0 = time.perf_counter()
    procs = {}
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as work:
        try:
            roots, convert_s = _indoor_clis(procs, work)
            _indoor_parity(dev)
            _indoor_requests(dev)
            names, aps, waited = _indoor_cli_checks(procs)
            _start(procs, 'indoor train scannet resume', [
                'dfm_tpu_torch.tools.train',
                os.path.join(here, 'configs', INDOOR_CONFIGS[
                    'VoteNet_ScanNet']), '--max-steps',
                str(INDOOR_TRAIN_STEPS + 1), '--auto-resume', '--work-dir',
                os.path.join(work, 'votenet'), '--cfg-options',
                f'data.data_root={roots["scannet"]}',
                'data.batch_size_per_chip=2'])
            _indoor_steps(dev, roots['scannet'])
            more, _, more_s = _indoor_cli_checks(procs)
            check(len(names + more) == 8, f'indoor (22d): {names + more}')
            print(f'indoor (22d) create_data scannet + sunrgbd (2 + 2 '
                  f'scenes each) {convert_s:.1f} s on the host; tools.test '
                  'VoteNet to indoor AP: '
                  + '; '.join(f'{k} ' + ', '.join(f'{m} {v}' for m, v in
                                                  sorted(a.items()))
                              for k, a in sorted(aps.items()))
                  + f'; tools.train VoteNet ScanNet {INDOOR_TRAIN_STEPS} '
                  f'steps (B = 2) and a resume to {INDOOR_TRAIN_STEPS + 1}; '
                  f'tools.test / tools.train (B = 2, {INDOOR_TRAIN_STEPS} '
                  'steps) --synthetic of 3DSSD and MVX; waited '
                  f'{waited:.1f} s for them after (b), {more_s:.1f} s for '
                  'the resume after (c)', flush=True)
        finally:
            _kill(procs)
    print(f'phase 22 {time.perf_counter() - t0:.1f} s', flush=True)


def phase22_alone(dev='cuda'):
    """Phase 22 by itself (no kernel build: none lies on its paths)."""
    print(card_line(), flush=True)
    indoor_phase(dev)


INDOOR2_CONFIGS = dict(GroupFree3DNet='groupfree3d_scannet.py',
                       ImVoteNet='imvotenet_sunrgbd.py',
                       H3DNet='h3dnet_scannet.py')
# (b) points a request: each config's data.num_points
INDOOR2_POINTS = dict(GroupFree3DNet=50000, ImVoteNet=20000, H3DNet=40000)
SUNRGBD_HW = (530, 730)       # SUN RGB-D's image size (w 730, h 530)
INDOOR2_STEP_B = dict(GroupFree3DNet=4, ImVoteNet=8, H3DNet=8)
INDOOR2_TRAIN_STEPS = 2       # (d) the CLIs' steps
# (a): the tiny configs of tests/test_torch_{groupfree3d,imvotenet,
# h3dnet}.py
GROUPFREE3D_TINY = dict(
    num_classes=4, num_proposal=16, num_decoder_layers=2, embed_dims=32,
    num_heads=4, ffn_channels=64, mean_sizes=VOTENET_TINY['mean_sizes'],
    sa_points=(256, 128, 64, 32), sa_ks=(16, 8, 8, 8),
    sa_mlps=((16, 16, 32), (32, 32, 64), (32, 32, 64), (32, 32, 64)),
    fp_channels=((64, 64), (64, 48)), max_num=16)
IMVOTENET_TINY = dict(VOTENET_TINY, img_max_boxes=16)
H3DNET_TINY = dict(VOTENET_TINY, num_backbones=2)
INDOOR2_TINY_HW = (50, 70)
# (a) card against CPU, f32, TF32 off: a stage's, tower's or head's
# outputs together (GroupFree3D's seed objectness, one dot product of 32
# features that cancels to a small logit, moved 1.5e-5 in the first run)
INDOOR2_REL_L2 = 1e-4


def _sunrgbd_view(n, seed, hw=None, boxes=16):
    """One SUN RGB-D-like frame: (1, n, 4) depth-frame points (x right in
    [-3, 3), y forward in [1, 7), z up in [-1, 1.5), the height above the
    lowest as the fourth column), a 0-255 image (1, h, w, 3), `boxes` 2D
    box slots (1, boxes, 6) (the first half live) and SUN RGB-D's
    depth2img (1, 3, 4): K (f 529.5 px, the principal point at the
    centre) times the depth-to-camera flip, scaled to the image (`hw`,
    SUNRGBD_HW if None)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform((-3, 1, -1), (3, 7, 1.5), (n, 3))
    pts = np.concatenate([pts, pts[:, 2:] - pts[:, 2].min()], 1)
    h, w = hw or SUNRGBD_HW
    img = rng.integers(0, 256, (1, h, w, 3)).astype(np.float32)
    bb = np.zeros((1, boxes, 6), np.float32)
    live = boxes // 2
    xy = rng.uniform(0, (w * 0.7, h * 0.7), (live, 2))
    bb[0, :live, :4] = np.concatenate([xy, xy + rng.uniform(
        0.1, 0.3, (live, 2)) * (w, h)], 1)
    bb[0, :live, 4] = rng.uniform(0.2, 0.9, live)
    bb[0, :live, 5] = rng.integers(0, 10, live)
    f = 529.5 * w / 730.0
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    flip = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]])
    d2i = np.concatenate([k @ flip, np.zeros((3, 1))], 1)[None]
    return tuple(torch.from_numpy(np.asarray(x, np.float32))
                 for x in (pts[None], img, bb, d2i))


def _flat_outputs(out, prefix=''):
    """Nested dicts / lists / tuples of tensors -> {path: CPU tensor}."""
    if torch.is_tensor(out):
        return {prefix: out.detach().cpu()}
    items = out.items() if isinstance(out, dict) else enumerate(out)
    flat = {}
    for k, v in items:
        flat.update(_flat_outputs(v, f'{prefix}.{k}' if prefix else str(k)))
    return flat


def _indoor2_indices(kind, model, out, args):
    """The sampled indices of one tiny request on its device: GroupFree3D's
    KPS candidates; each vote tower's proposal FPS and ball groups;
    ImVoteNet's decoded 2D classes and fusion mask; H3DNet's primitive
    groups of the keypoints."""
    from dfm_tpu_torch.models.backbones import pointnet2 as P2
    from dfm_tpu_torch.models.detectors import h3dnet as PH
    from dfm_tpu_torch.models.detectors import imvotenet as PI
    from dfm_tpu_torch.models.detectors.votenet import votenet_predict
    idx = {}
    if kind.startswith('GroupFree3D'):
        idx['candidate_idx'] = out['candidate_idx']
        return idx
    towers = ('joint', 'pts', 'img') if kind.startswith('ImVoteNet') \
        else ('initial',)
    for name in towers:
        votes = out[name]['vote_xyz']
        cidx = P2.farthest_point_sample(votes, model.cfg.num_proposals)
        idx[f'{name}.proposal_fps'] = cidx
        idx[f'{name}.proposal_groups'] = _index_groups(
            votes, P2.gather_points(votes, cidx), model.cfg.vote_radius,
            model.cfg.vote_k)
    if kind.startswith('ImVoteNet'):
        bb = args[3]
        if model.cfg.with_img_branch:
            bb = model.image_branch(args[2])[1]
            idx['decoded_2d_classes'] = bb[..., 5]
        idx['fusion_mask'] = PI.vote_fusion_cues(
            out['joint']['seed_xyz'], bb, args[2], args[4],
            model.cfg.num_classes, model.cfg.max_imvote_per_pixel)[2]
        return idx
    with torch.no_grad():
        boxes = votenet_predict(out['initial'], model.cfg)['boxes_3d']
    surf, line = PH.box_surface_line_centers(boxes)
    prims = out['prims']
    k = model.cfg.primitive_k
    if model.cfg.with_cues:
        pairs = (('surface', torch.cat([prims['z'][1], prims['xy'][1]], 1),
                  surf, model.cfg.surface_radius),
                 ('line', prims['line'][1], line, model.cfg.line_radius))
    else:
        pairs = (('all', torch.cat([prims[m][1] for m in PH.MODES], 1),
                  torch.cat([surf, line], 2), model.cfg.primitive_radius),)
    for name, xyz, kp, radius in pairs:
        idx[f'primitive_groups.{name}'] = _index_groups(
            xyz, kp.reshape(kp.shape[0], -1, 3), radius, k)
    return idx


def _indoor2_parity(dev):
    """(a) GroupFree3D, ImVoteNet (without and with the image branch) and
    H3DNet (without and with the cues) at their tests' tiny configs,
    card against CPU, f32, TF32 off: the seeds and every sampled index
    equal (FPS and ball groups through the seeds, the KPS candidates, the
    vote towers' proposal FPS and groups, the decoded 2D boxes' classes
    in their order, the fusion mask, the primitive groups), the outputs
    within INDOOR2_REL_L2 (a stage's or tower's keys together)."""
    from dfm_tpu_torch.models.detectors.groupfree3d import (
        GroupFree3DConfig, GroupFree3DNet)
    from dfm_tpu_torch.models.detectors.h3dnet import H3DNet, H3DNetConfig
    from dfm_tpu_torch.models.detectors.imvotenet import (ImVoteNet,
                                                          ImVoteNetConfig)
    from dfm_tpu_torch.utils.weights import init_weights
    room = _indoor_scene(2500, 9)
    view = _sunrgbd_view(2500, 10, INDOOR2_TINY_HW, 6)
    cases = (
        ('GroupFree3D', GroupFree3DNet(GroupFree3DConfig(**GROUPFREE3D_TINY)),
         (room,)),
        ('ImVoteNet', ImVoteNet(ImVoteNetConfig(**IMVOTENET_TINY)),
         (view[0], None) + view[1:]),
        ('ImVoteNet image branch', ImVoteNet(ImVoteNetConfig(
            **IMVOTENET_TINY, with_img_branch=True)), (view[0], None)
         + view[1:]),
        ('H3DNet', H3DNet(H3DNetConfig(**H3DNET_TINY)), (room,)),
        ('H3DNet cues', H3DNet(H3DNetConfig(**H3DNET_TINY, with_cues=True)),
         (room,)))
    flags = _no_tf32()
    lines = []
    try:
        for kind, model, args in cases:
            model = _live_weights(init_weights(model, 5), 6, 0.0)
            outs, idx = {}, {}
            for d in ('cpu', dev):
                m = model.to(d).eval()
                a = [None if x is None else x.to(d) for x in args]
                with torch.inference_mode():
                    out = m(*a)
                    idx[d] = {k: v.cpu() for k, v in _indoor2_indices(
                        kind, m, out, a).items()}
                outs[d] = _flat_outputs(out)
            for k, v in idx['cpu'].items():
                check(torch.equal(idx[dev][k], v), f'indoor2 (23a) {kind} '
                      f'{k}: card and CPU differ')
            worst = 0.0
            groups = {}
            for k, v in outs['cpu'].items():
                got = outs[dev][k]
                if not v.is_floating_point() or k.endswith('seed_xyz') or \
                        k in ('seed_points', 'query_points_xyz'):
                    check(torch.equal(got, v), f'indoor2 (23a) {kind} {k}: '
                          'card and CPU differ')
                    continue
                g = '.'.join(k.split('.')[:2])
                a_, b_ = groups.get(g, ([], []))
                groups[g] = (a_ + [got.double().ravel()],
                             b_ + [v.double().ravel()])
            for g, (a_, b_) in groups.items():
                a_, b_ = torch.cat(a_), torch.cat(b_)
                r = float((a_ - b_).norm() / b_.norm().clamp(min=1e-30))
                check(r <= INDOOR2_REL_L2, f'indoor2 (23a) {kind} {g}: '
                      f'relative L2 {r}')
                if r >= worst:
                    worst, where = r, g
            lines.append(f'{kind} {worst:.3g} ({where}; '
                         f'{len(idx["cpu"])} index sets)')
            model.to('cpu')
    finally:
        _set_tf32(flags)
    print('indoor2 (23a) tiny configs, f32, TF32 off, card vs CPU: seeds, '
          'KPS candidates, proposal FPS and ball groups, decoded 2D classes '
          '(in slot order), fusion masks and primitive groups equal; '
          'outputs relative L2 max: ' + '; '.join(lines), flush=True)


def _indoor2_request(kind, dev, seed=23):
    """The inputs of one full-width request of `kind`."""
    n = INDOOR2_POINTS[kind]
    if kind == 'ImVoteNet':
        pts, img, bb, d2i = _sunrgbd_view(n, seed)
        return (pts.to(dev), None, img.to(dev), bb.to(dev), d2i.to(dev))
    return (_indoor_scene(n, seed, 8.0).to(dev),)


def _indoor2_stages(kind, model, cfg, req):
    """(name, fn(prev) -> out) of one request, by stage."""
    from dfm_tpu_torch.models.builder import lidar_predict
    predict = lidar_predict(cfg)
    st = {}
    if kind == 'GroupFree3DNet':
        def sampling(s):
            st['s'] = s
            return model.sampling(*s)

        def decoder(c):
            st['c'] = c
            return model.decoder(st['s'][0], st['s'][1], c[2], c[3])

        return [('backbone', lambda _: model.backbone(req[0].to(
            model.dtype))), ('sampling', sampling), ('decoder', decoder),
            ('predict', lambda stages: predict(dict(stages=stages), cfg))]
    if kind == 'ImVoteNet':
        pts, _, img, _, d2i = req

        def backbone(b):
            st['b'] = b
            return model.backbone(pts.to(model.dtype))

        def fusion(s):
            st['s'] = s
            return model.image_features(s[0], st['b'], img, d2i)

        def towers(f):
            xyz, sf = st['s']
            return dict(joint=model.joint(xyz, torch.cat([sf, f], -1)),
                        pts=model.pts(xyz, sf), img=model.img(xyz, f))

        return [('img_branch', lambda _: model.image_branch(img)[1]),
                ('backbone', backbone), ('fusion', fusion),
                ('towers', towers), ('predict', lambda o: predict(o, cfg))]

    def rpn(s):
        st['s'] = s
        return model.rpn(*s)

    def prims(i):
        st['i'] = i
        return model.primitives(*st['s'])

    def refine(p):
        matched, extra = model.match(st['i'], p)
        return dict(refined=model.refine(st['i'], matched))

    return [('backbones', lambda _: model.backbones(req[0])), ('rpn', rpn),
            ('primitives', prims), ('refine', refine),
            ('predict', lambda o: predict(o, cfg))]


def _indoor2_requests(dev):
    """(b) Each config at full width: requests in bf16 and f32 by stage
    (INDOOR2_WARMUP warm-ups, INDOOR2_TIMED timed), peak memory, 0
    port-kernel launches, FPS's share of a request."""
    import os
    from dfm_tpu_torch.apis import init_imvotenet_model, init_lidar_model
    from dfm_tpu_torch.models.builder import build_detector
    from dfm_tpu_torch.runtime.config import load_config
    here = os.path.dirname(os.path.abspath(__file__))
    for kind, config in INDOOR2_CONFIGS.items():
        mcfg = build_detector(load_config(os.path.join(
            here, 'configs', config)).model)
        req = _indoor2_request(kind, dev)
        init = init_imvotenet_model if kind == 'ImVoteNet' \
            else init_lidar_model
        for dtype in (torch.bfloat16, torch.float32):
            h = init(mcfg, dtype)
            model = _live_weights(h['model'], 7, 3.0)
            ms, st, peak, det = _request_times(
                lambda: h['infer'](*req), _indoor2_stages(kind, model, mcfg,
                                                          req),
                f'indoor2 (23b) {kind}', warmup=INDOOR2_WARMUP,
                timed=INDOOR2_TIMED)
            check(all(bool(torch.isfinite(v).all()) for v in det.values()
                      if v.is_floating_point()), f'indoor2 (23b) {kind}: '
                  'detections not finite')
            tf32 = '' if dtype == torch.bfloat16 else \
                ' (TF32 as PyTorch has it)'
            extra = f', image {SUNRGBD_HW[0]}x{SUNRGBD_HW[1]}, 16 2D box ' \
                'slots' if kind == 'ImVoteNet' else ''
            print(_stage_line(
                f'indoor2 (23b) {config} request {str(dtype)[6:]}{tf32}, '
                f'{INDOOR2_POINTS[kind]} points{extra}', ms, st, peak,
                INDOOR2_TIMED), flush=True)
            fps, total, calls = _lidar2_fps_share(
                lambda r: h['infer'](*r), req)
            print(f'indoor2 (23b) {kind} {str(dtype)[6:]}: FPS ({calls} '
                  f'calls) {fps:.3f} ms of one request of {total:.3f} ms '
                  f'(each call synchronised): share {fps / total:.3f}',
                  flush=True)
            del h, model
            gc.collect()
            torch.cuda.empty_cache()


def _indoor2_steps(dev, scannet_root):
    """(c) One f32 training step of each config at its per-chip batch
    (INDOOR2_STEP_B): GroupFree3D and H3DNet on the ScanNet tree's train
    scenes (`IndoorSource`: the points sampled and augmented on the host
    in the data time), ImVoteNet on `imvotenet_synth` batches at full
    width (20,000 points, 530x730 images, 16 2D box slots)."""
    import os
    from dfm_tpu_torch.models.builder import build_detector, lidar_class
    from dfm_tpu_torch.runtime.adapters import (imvotenet_synth,
                                                imvotenet_to_device)
    from dfm_tpu_torch.runtime.config import load_config, merge_options
    from dfm_tpu_torch.tools.train import IndoorSource
    from dfm_tpu_torch.utils.weights import init_weights
    here = os.path.dirname(os.path.abspath(__file__))
    for kind, config in INDOOR2_CONFIGS.items():
        cfg = load_config(os.path.join(here, 'configs', config))
        mcfg = build_detector(cfg.model)
        b, n = INDOOR2_STEP_B[kind], INDOOR2_POINTS[kind]
        if kind == 'ImVoteNet':
            def batch_fn(i, c=mcfg):
                return imvotenet_to_device(imvotenet_synth(
                    c, b, i, n=n, h=SUNRGBD_HW[0], w=SUNRGBD_HW[1], m=16),
                    dev)
            width = dict(point_channels=3)
        else:
            src = IndoorSource(merge_options(cfg, [
                f'data.data_root={scannet_root}']), b)
            rng = np.random.default_rng(0)

            def batch_fn(i, s=src, r=rng):
                return s.next_batch(i, r, dev)
            width = {}
        model = init_weights(lidar_class(mcfg)(mcfg, **width)).to(dev)
        _train_step_line(
            f'indoor2 (23c) {config} training step, f32 (TF32 as PyTorch '
            f'has it), B = {b} x {n} points', model, batch_fn, dev)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def _indoor2_clis(procs, work):
    """(d) The CLIs in processes of their own: a ScanNet tree (2 + 2
    scenes of 50,000 points) and a SUN RGB-D tree converted here (in
    process), then `tools.test` of GroupFree3D and H3DNet on the ScanNet
    tree to the indoor AP lines, `tools.train` of each (B = 2) on it,
    ImVoteNet's `tools.test` / `tools.train` (B = 2) with `--synthetic`
    and both refusing the SUN RGB-D tree (rc 2, the image inputs named),
    and `tools.test` refusing a type the port does not run
    (EncoderDecoder3D). Returns the ScanNet tree and the host seconds of
    the conversion."""
    import contextlib
    import io
    import os
    from dfm_tpu_torch.tools import create_data
    here = os.path.dirname(os.path.abspath(__file__))
    roots = dict(scannet=os.path.join(work, 'scannet'),
                 sunrgbd=os.path.join(work, 'sunrgbd'))
    t0 = time.perf_counter()
    write_scannet_tree(roots['scannet'], seed=2, points=50000)
    write_sunrgbd_tree(roots['sunrgbd'], seed=2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        for name, root in roots.items():
            check(create_data.main([name, '--root', root, '--splits',
                                    'train', 'val']) == 0,
                  f'indoor2 (23d) create_data {name}')
    check(buf.getvalue().count('wrote 2 infos') == 4,
          f'indoor2 (23d) create_data: {buf.getvalue()}')
    convert_s = time.perf_counter() - t0
    cfgs = {k: os.path.join(here, 'configs', c)
            for k, c in INDOOR2_CONFIGS.items()}
    scannet = f'data.data_root={roots["scannet"]}'
    for kind in ('GroupFree3DNet', 'H3DNet'):
        _start(procs, f'indoor2 test {kind}', [
            'dfm_tpu_torch.tools.test', cfgs[kind], '--cfg-options',
            scannet])
        _start(procs, f'indoor2 train {kind}', [
            'dfm_tpu_torch.tools.train', cfgs[kind], '--max-steps',
            str(INDOOR2_TRAIN_STEPS), '--work-dir', os.path.join(work, kind),
            '--cfg-options', scannet, 'data.batch_size_per_chip=2'])
    _start(procs, 'indoor2 synthetic-test ImVoteNet', [
        'dfm_tpu_torch.tools.test', cfgs['ImVoteNet'], '--synthetic'])
    _start(procs, 'indoor2 synthetic-train ImVoteNet', [
        'dfm_tpu_torch.tools.train', cfgs['ImVoteNet'], '--synthetic',
        '--max-steps', str(INDOOR2_TRAIN_STEPS), '--work-dir',
        os.path.join(work, 'imvotenet'), '--cfg-options',
        'data.batch_size_per_chip=2'])
    sun = ['--cfg-options', f'data.data_root={roots["sunrgbd"]}']
    _start(procs, 'indoor2 refused-test ImVoteNet', [
        'dfm_tpu_torch.tools.test', cfgs['ImVoteNet']] + sun)
    _start(procs, 'indoor2 refused-train ImVoteNet', [
        'dfm_tpu_torch.tools.train', cfgs['ImVoteNet'], '--work-dir',
        os.path.join(work, 'refused')] + sun)
    _start(procs, 'indoor2 refused-type EncoderDecoder3D', [
        'dfm_tpu_torch.tools.test',
        os.path.join(here, 'configs', 'pointnet2_ssg_s3dis_seg.py')])
    return roots['scannet'], convert_s


def _indoor2_cli_checks(procs):
    """Wait for (d)'s processes (emptied) and check what each printed ->
    the names checked, the AP lines and the seconds waited."""
    t0 = time.perf_counter()
    cli = _finish(procs)
    procs.clear()
    aps = {}
    for name, res in cli.items():
        if 'refused' in name:
            want = 'not ported' if 'type' in name else 'depth2img'
            check(res.returncode == 2 and want in res.stderr,
                  f'{name}: rc {res.returncode} {res.stderr[-2000:]}')
            continue
        check(res.returncode == 0, f'{name}: rc {res.returncode} '
              f'{res.stderr[-3000:]}')
        if name.startswith('indoor2 test'):
            lines = dict(INDOOR_AP.findall(res.stdout))
            check(len(lines) == 4 and all(np.isfinite(float(v))
                                          for v in lines.values()),
                  f'{name}: {res.stdout[-2000:]}')
            aps[name.split()[-1]] = lines
        elif name.startswith('indoor2 synthetic-test'):
            check('[synthetic-eval] ImVoteNet: decoded 3 output arrays, '
                  'finite=True' in res.stdout, f'{name}: '
                  f'{res.stdout[-2000:]}')
        else:
            check(f'step {INDOOR2_TRAIN_STEPS}/{INDOOR2_TRAIN_STEPS}' in
                  res.stdout, f'{name}: {res.stdout[-2000:]}')
    return list(cli), aps, time.perf_counter() - t0


def indoor2_phase(dev):
    """23. GroupFree3D, ImVoteNet and H3DNet, no port kernel on their
    paths: (d)'s trees converted and its CLIs started, (a) card against
    CPU at tiny sizes, (b) full-width requests; the CLIs collected, then
    (c) the full-width training steps."""
    import tempfile
    t0 = time.perf_counter()
    procs = {}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        try:
            scannet, convert_s = _indoor2_clis(procs, work)
            _indoor2_parity(dev)
            _indoor2_requests(dev)
            names, aps, waited = _indoor2_cli_checks(procs)
            check(len(names) == 9, f'indoor2 (23d): {names}')
            print(f'indoor2 (23d) create_data scannet (50,000 points a '
                  f'scene) + sunrgbd {convert_s:.1f} s on the host; '
                  'tools.test to indoor AP: '
                  + '; '.join(f'{k} ' + ', '.join(f'{m} {v}' for m, v in
                                                  sorted(a.items()))
                              for k, a in sorted(aps.items()))
                  + f'; tools.train GroupFree3D and H3DNet '
                  f'{INDOOR2_TRAIN_STEPS} steps (B = 2) on the tree; '
                  'ImVoteNet tools.test / tools.train --synthetic, both '
                  'refusing SUN RGB-D data (rc 2); EncoderDecoder3D '
                  f'refused (rc 2); waited {waited:.1f} s for them after '
                  '(b)', flush=True)
            _indoor2_steps(dev, scannet)
        finally:
            _kill(procs)
    print(f'phase 23 {time.perf_counter() - t0:.1f} s', flush=True)


def phase23_alone(dev='cuda'):
    """Phase 23 by itself (no kernel build: none lies on its paths)."""
    print(card_line(), flush=True)
    indoor2_phase(dev)


def _flops_of(fn, *args):
    """Floating-point operations of `fn(*args)` (torch's FlopCounterMode:
    the convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def run_phases(cfg, dev, mem):
    """Phases 3-23; the card's memory in use after each -> the kernels'
    results."""
    import os
    import tempfile
    results = kernel_phase(cfg, dev)
    from dfm_tpu_torch.ops.cuda import conv_chain as KC
    gc.collect()
    check(not KC._WGMMA_WEIGHTS, f'{len(KC._WGMMA_WEIGHTS)} weight layouts '
          'outlived the kernel phase (the table keeps no weight alive)')
    mem.mark('phase 3')
    launches = main_phase(cfg, dev)
    for name, n in launches.items():
        if name in results:
            results[name]['main_path_launches' if name in OFF_PATH
                          else 'launches'] = n
    mem.mark('phase 4')
    parity_phase(cfg, dev)
    mem.mark('phase 5')
    eval_phase(cfg, dev)
    mem.mark('phase 6')
    train_phase(cfg, dev, results)
    mem.mark('phase 7-8')
    with tempfile.TemporaryDirectory() as tmp:
        trees = dict(full=os.path.join(tmp, 'full'),
                     small=os.path.join(tmp, 'small'))
        mvdfm_phase(dev, trees)
        mem.mark('phase 9')
        ddp_phase(cfg, dev, results, trees)
        mem.mark('phase 10')
        temporal_phase(dev, trees)
        mem.mark('phase 11')
    for n, phase in ((12, mono_phase), (13, dla_phase), (14, imvoxel_phase),
                     (15, nuscenes_phase), (16, waymo_cam_phase),
                     ('17-20', lidar_phases), (21, lidar2_phase),
                     (22, indoor_phase), (23, indoor2_phase)):
        phase(dev)
        mem.mark(f'phase {n}')
    return results


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    from dfm_tpu_torch.models.detectors.dfm import DfMConfig
    from dfm_tpu_torch.ops.cuda import build

    card = card_line()
    print(f'device: {card} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {torch.cuda.get_device_name(0)}',
          flush=True)
    secs = build.build_all()
    print(f'build: {secs:.1f} s for {len(build.SOURCES)} sources', flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line \
                    or 'Performance' in line:
                print(f'build {name}: {line.strip()}')

    dev = 'cuda'
    cfg = DfMConfig()
    mem = CardMemory()
    try:
        results = run_phases(cfg, dev, mem)
    finally:
        mem.close()
    print(json.dumps({'kernels': list(results.values())}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--ddp-rank']:       # phase 10 (b), one rank
        sys.exit(ddp_rank(sys.argv[2]))
    if sys.argv[1:2] == ['--mono-rank']:      # phase 12 (d), one rank
        sys.exit(mono_rank(sys.argv[2]))
    sys.exit(main())
