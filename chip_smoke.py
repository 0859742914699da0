#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one card: the repair data path,
serving and training every model family, and the repair demos.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then
drives the main path through the entry points a user calls, at the paper's
64 MiB HDFS block size (one stripe of each code is 9 x 64 MiB = 576 MiB):

1. kernel vs plain: the GF(2^8) kernel against ``gf_matmul_table`` on the
   card, byte-exact, over the reference's test shapes, ragged widths and
   every product shape of the main path at full width; timed with CUDA
   events at the four parity encodes and DRC(9,6,3)'s batched NodeEncode,
   RelayerEncode and decode, in turns, 5 rounds of 10 launches (median,
   min-max spread, share of the byte bound).  A ``[1 model]`` line gives the
   TPU kernel's int8 bitplane product at each timed shape at the int8
   tensor-core rate: a computed cost of that algorithm, not a measurement;
2. encode: systematic in-place encode of one stripe per code;
3. repair: layered repair of nodes 0 and n-1 per code, through both
   ``RepairPlan.execute`` and ``spmd_repair``, byte-exact, with the traced
   byte counters held to ``traffic_blocks() * alpha * sub`` and DRC's
   cross-rack blocks to Eq. (3);
4. node recovery: ``spmd_node_recovery`` of node 0 over 8 stripes of
   DRC(9,6,3) (4.5 GiB of payload), rotating relayers;
5. checkpoint: ``CheckpointManager`` saves a ~256 MiB f32 + bf16 state with
   DRC(9,6,3), one node file is deleted, and the load must repair it;
6. serve, on StarCoder2-3B at full width (30 layers, d 3072, 24 query heads
   over 2 KV heads, head dim 128, d_ff 12288, vocab 49152) in bf16, with
   weights from ``init_model`` and a seeded generator:
   a. the flash-attention kernel against ``flash_attention_ref`` on the card
      over the reference's sweep (f32 atol 3e-5, bf16 atol 3e-2) and at the
      model's layer shape, each case also within 1e-2 relative Frobenius
      error and 2^-7 of its row's scale per element.  At the layer shape
      (4 x 4096) and at the ragged 2 x 1500 the kernel and PyTorch's
      ``scaled_dot_product_attention`` (timed only, never on the path) are
      timed in turns, kernel then SDPA, 5 rounds of 20 launches each: the
      median, the min-max spread, the achieved TFLOP/s and the share of the
      bound; the plain version is timed once;
   b. prefill: ``make_prefill_step`` on 4 prompts of 4096 tokens and on 2
      prompts of 1500 (a ragged length), the flash kernel once per layer,
      each held against the same forward through the chunked plain path;
   c. serve: ``ServeEngine`` prefills 8 prompts of 128 tokens and generates
      32 tokens greedily, under ``obs.tracing``.
   One prefill forward and four decode steps also run under
   ``torch.profiler``, for their device time by kernel;
7. the process-group executor: phase 6's model is freed, then
   ``repro_torch.dist.mesh_run`` spawns r*w = 9 ranks on this card over
   ``gloo`` (the kernels were built before, each rank loads them), each with
   its own payload, and runs ``spmd_repair(..., mesh=make_repair_mesh(3, 3))``
   for the four codes at nodes 0 and n-1 and ``spmd_node_recovery`` of
   DRC(9,6,3) over 4 stripes: the collector's output byte-equal to the stripe,
   every rank's GF products on the card, the bytes sent between pods equal
   to the plans' cross-rack bytes.  Its times are host-staged ``gloo`` times
   on one card, not a network or NCCL figure;
8. the evaluation layer: ``multi_failure_repair`` (DRC(9,6,3) with 2 and 3
   failures, RS(9,6,3) with 3), ``CodeSwitcher.switch`` between RS(8,6,4)
   and DRC(9,6,3), decoded back, byte-equal; ``FaultToleranceManager``
   ``execute`` (repair and decode) and ``rescale`` to DRC(6,4,3) on phase
   5's 256 MiB state, every leaf bit-equal; and the simulator's Table 3 row
   of DRC(9,6,3), from host code;
9. train, through ``init_train_state``, ``make_train_step`` and
   ``SyntheticStream``, 2 x 4096 tokens a step in 2 microbatches, AdamW
   state in f32, WSD schedule:
   a. StarCoder2-3B at full width and depth (``remat="full"``, KV chunks of
      512): a warm-up step with a hook on every parameter's gradient (each
      finite and nonzero), 3 steps timed by the host clock and CUDA events,
      one under ``torch.profiler``; every loss finite and the launcher's own
      success test (``launch.train.training_ok``) passed; peak memory;
   b. the same widths cut to 2 layers (at 30 layers the checkpoint's
      serialized state and stripe do not fit beside the live state): 2
      steps, ``CheckpointManager.save`` with DRC(9,6,3), 2 steps, ``node_2.bin``
      deleted, ``load`` through the layered repair, the state copied back in
      place and byte-equal to the saved one, cross-rack blocks equal to the
      plan's, every GF product on the card; the 2 steps replayed.
   Neither may launch the flash kernel (it has no backward);
10. the model families beyond the dense one, after phase 9 has freed the
   training state, each at its published width in bf16 with random seeded
   weights, freed before the next: 10a dbrx-132b (16 experts, top-4; depth
   cut to 4 of 40 layers), 10b zamba2-1.2b (38 Mamba2 layers and the shared
   block's 6 calls), 10c xlstm-125m (9 mLSTM, 3 sLSTM), 10d internvl2-1b
   (256 seeded patch embeddings ahead of the text), 10e whisper-small (1500
   seeded frames through the encoder, 448 text tokens).  For each: the
   flash kernel against its plain version at the family's new attention
   shapes, timed in turns with SDPA; ``make_prefill_step`` on 2 x 4096
   positions through the kernel (its launches per forward counted), held
   against the chunked plain path, timed by CUDA events (median of 3, each
   after a warm-up); ``ServeEngine`` at batch 8 on 32-token prompts plus 32
   greedy tokens (whisper with ``state["enc"]`` set from the encoder), its
   logits at the last prompt position held against the full forward's, and
   its decode step under ``torch.profiler``; peak memory.  10a also counts
   the (token, choice) pairs the prefill dropped over capacity and checks
   that decode at batch 8 drops none;
11. every family trained, after phase 10, one at a time, at its published
   width in bf16 with random seeded weights, AdamW state in the config's
   ``opt_state_dtype`` (bf16 for the MoEs), ``remat`` full, KV chunks of 512,
   on one repeated batch of 2 x 2048 positions of ``SyntheticStream`` (vlm:
   256 patch embeddings + 1792 tokens; whisper: 1500 frames and 448 tokens):
   11a dbrx-132b and 11b grok-1-314b (depth cut to 1 layer by memory: see
   ``FAMILY_TRAIN``), 11d xlstm-125m at 4 of 12 blocks (by time), and 11c
   zamba2-1.2b, 11e internvl2-1b and 11f whisper-small at full depth.  A warm-up step with a hook on every
   parameter's gradient (each finite and nonzero; grok's unused ``moe.gate``
   gets none: its moments stay zero and it equals its decayed self), 2 steps
   timed by the host clock and CUDA events, one under ``torch.profiler``;
   the loss lower after two updates; the MoE's dropped pairs; peak memory;
   no flash launch (training takes the chunked attention);
   g. 11f's trained state (parameters and f32 moments) encoded as a
   DRC(9,6,3) checkpoint on the card, node 0 lost and restored through the
   layered repair, every leaf byte-equal;
12. the paper's two repair demos, ``repro_torch.examples.quickstart`` and
   ``repair_layering`` (with its Chrome trace and summary written under a
   temporary directory), through ``main(argv)`` on the card: their own
   checks, the summary's cross-rack bytes equal to the plans', every GF
   product on the card;
13. the sharded prefill, after every earlier model is freed:
   ``make_prefill_step(cfg, mesh=, rules=)`` through ``dist.model_run`` on 8
   ``gloo`` ranks sharing this card as a (data 2, model 4) mesh, one model at
   a time: 13a StarCoder2-3B at full width and depth, ``tp`` rules, 2 x 4096
   tokens (the flash kernel on each rank's 6 of 24 query heads; the 2 kv
   heads do not divide 4 and stay whole); 13b dbrx-132b (2 of 40 layers,
   ``tp``: expert parallel, 16 experts over 4) and 13c grok-1-314b (1 of 64,
   ``tp_sp`` with ``sharding="ffn"``: every expert's FFN shard on every rank,
   tokens sequence-parallel), each at a drop-free capacity on 2 x 1024 and
   at its config's on 2 x 2048.  Rank 0's logits are held to one process's
   on the same seeded weights (5% of the largest logit), every rank's first
   flash call's local shards to the plain version, the MoE's ``all_to_all``
   to 2 a layer (13b) and none (13c); the pairs dropped, each rank's peak
   memory, collectives by kind and bytes staged through the host, and the
   slowest rank's time (host-staged ``gloo``, not NCCL) are printed;
14. training and decode over the same mesh, one run at a time:
   ``make_train_step(cfg, tcfg, mesh=, rules=)`` and ``ServeEngine(...,
   mesh=, rules=)`` through ``dist.model_run`` on the 8 ranks: 14a
   StarCoder2-3B trained at full width (4 of 30 layers) under ``fsdp`` (2 x
   4096 tokens, a warm-up and a timed step), 14b dbrx-132b (1 of 40 layers)
   under ``fsdp``, expert parallel, at a drop-free capacity on 2 x 512 and
   at its config's on 2 x 1024; 14c StarCoder2-3B (4 of 30 layers) and 14d
   dbrx-132b (2 of 40 layers) decoded under ``tp`` (batch 8, 16 prompt and 16 greedy
   tokens).  Each is held to one process's run on the same seeded weights:
   rank 0's first loss within 1% and gradient norm within 5%, the dense
   loss falling; the decode's logits within 5% of the largest (14d with
   every token routed to every expert, then at its config's top 4), the
   share of equal greedy tokens printed; the MoE's own ``all_to_all``
   counted forward and backward.  Each rank's peak memory, the slowest
   rank's time, collectives by kind forward and backward and bytes staged
   through the host are printed (host-staged ``gloo``, not NCCL).  14e
   trains StarCoder2-3B (full width, 4 of 30 layers, 2 x 4096 tokens) under
   ``tp2d``, whose ``_StridedShard`` gradient layouts torch 2.11's DTensor
   cannot redistribute into (``sharding.redistribute`` reduces and slices),
   held as 14a;
15. the ssm, hybrid, vlm and audio families over the same mesh at their
   published widths and depths in bf16 (xlstm-125m, zamba2-1.2b,
   internvl2-1b, whisper-small), in one spawn after the parent's
   one-process run of each: 15a-d prefill under ``tp`` on 2 x 2048
   positions (internvl2's 256 seeded patches first; whisper's 1,500 seeded
   frames and 448 text tokens), rank 0's logits within 5% of the largest
   of one process's and the flash kernel on each rank's local heads held
   to its plain version; 15e-h one warm-up and one timed train step under
   ``fsdp`` (``remat="full"``, each config's AdamW state, 2 x 1024
   positions; whisper 2 x 448), held as 14a; 15i-l decode under ``tp``
   (batch 8, 16 prompt and 16 greedy tokens, KV caches of 64), held as 14c;
16. the pod axis (16a: StarCoder2-3B, 4 layers, over (pod 2, data 2, model
   2)), the sharded checkpoint with a lost node (16b) and the launch layer's
   dry run on fake card tensors (16c): see ``phase_pod`` and ``phase_dryrun``;
17. the verification layer (``phase_check``): ``repro_torch.check``'s plan
   sweep, lowered sweep, lint and mutation self-tests in this process; the
   built kernels' launch-geometry queries held equal to the Python models
   the checker sweeps, at every shape of its ``cuda-kernel`` sweep; and
   guard-band launches (GF into an offset view of a 0xA5-filled buffer on
   the aligned and the unaligned path, flash into an output with padded
   strides whose gaps hold NaN), the guards untouched and the outputs equal
   to the plain versions.  At most ``CHECK_PHASE_S`` seconds, printed beside
   the card's name and power limit;
18. the traced layer (``phase_traced``): ``repro_torch.check.traced``'s
   sweep (15 dispatch traces of the entry points on fake card tensors) and
   its mutation self-test in this process; real card runs of the
   checkpoint encode, the GF product and the xlstm serve step held equal op
   by op to the fake captures; the host cost of a GF call through the
   custom op ``repro_torch::gf_matmul`` against the bare launch.  At most
   ``TRACED_PHASE_S`` seconds.

The build prints ptxas's report of every kernel (registers, spills) and the
bf16 flash kernel's geometry (tiles, stages, dynamic shared memory, the
registers ``setmaxnreg`` gives its producer and consumer warpgroups, and its
TMA boxes), held equal to the wrapper's ``hopper_geometry``.  The
GF kernel's launches are counted over phases 2-5 (``launches``, comparable
with earlier runs) and per phase (``launches_by_phase``: 2-5, 7 summed over
the ranks, 8, 9, 11g, 12, 14, 15, 16b, 18), the flash kernel's over 6b-6c,
10a-e, 13 and 15 (summed over the ranks; and over 9, 11, 14 and 18, where it
must be 0).  Any
mismatch or exception exits non-zero.  The last three lines of standard
output are the kernels JSON line, the card's name and power limit, and the
result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.code_base import drc_min_cross_rack_blocks  # noqa: E402
from repro_torch.core.codes import make_code  # noqa: E402
from repro_torch.core.gf_torch import gf_matmul_table  # noqa: E402
from repro_torch.core.multi_failure import CodeSwitcher, multi_failure_repair  # noqa: E402
from repro_torch.dist import mesh_run, model_run  # noqa: E402
from repro_torch.examples import quickstart, repair_layering  # noqa: E402
from repro_torch.dist.collectives import (  # noqa: E402
    plan_to_spmd,
    spmd_node_recovery,
    spmd_repair,
)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    hopper_config,
    hopper_geometry,
)
from repro_torch.kernels.gf_matmul import gf_matmul_batched  # noqa: E402
from repro_torch.launch.train import training_ok  # noqa: E402
from repro_torch.models import backbone, mlp  # noqa: E402
from repro_torch.serve import ServeEngine, make_prefill_step  # noqa: E402
from repro_torch.storage import ClusterSim  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    DataConfig,
    ScheduleConfig,
    SyntheticStream,
    TrainConfig,
    init_opt_state,
    init_train_state,
    learning_rate,
    make_train_step,
    train_state,
)
from repro_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    copy_state_,
    encode_state,
    make_encode_step,
    restore_state,
    state_to_bytes,
)
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.fault_tolerance import FaultToleranceManager  # noqa: E402

SEED = 0
BLOCK_BYTES = 64 * 2**20  # the paper's HDFS block (examples/repair_layering_demo.py)
CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]
# tests/test_kernels.py SHAPES, plus the ragged widths of the reference tests
SHAPES = [
    (1, 1, 128), (2, 3, 128), (3, 6, 256), (4, 12, 384), (9, 18, 512),
    (8, 27, 1024), (16, 64, 2048), (27, 162, 512), (3, 6, 17), (3, 6, 333),
]
RECOVERY_STRIPES = 8
# phase 7: the node recovery's stripes
MESH_RECOVERY_STRIPES = 4
# phase 8: failure sets of multi_failure_repair
MULTI_FAILURES = [(("DRC", 9, 6, 3), [0, 8]), (("DRC", 9, 6, 3), [1, 4, 7]),
                  (("RS", 9, 6, 3), [0, 4, 8])]
DEVICE = "cuda"
# NVIDIA H100 SXM data sheet (dense): HBM rate, int8 and bf16 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_FLOPS_PER_S = 989e12
SERVE_ARCH = "starcoder2-3b"
# tests/test_flash_attention.py SWEEP: b, sq, sk, h, kvh, d, causal
FLASH_SWEEP = [
    (1, 256, 256, 2, 2, 64, True), (2, 512, 512, 1, 1, 128, True),
    (1, 256, 512, 2, 2, 64, False), (1, 256, 256, 4, 2, 64, True),
    (2, 256, 256, 8, 2, 32, True), (1, 128, 384, 3, 1, 64, False),
]
FLASH_ATOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}
# 6a also holds every case to a relative Frobenius error and, per element, to
# 2^-7 of the row's own scale (see ``flash_errors``): at S 4096 a typical
# |out| is about 0.03, as large as the absolute tolerance.
FLASH_REL_FRO = 1e-2
FLASH_REL_SCALE = 2.0**-7
FLASH_SCALE_FLOOR = 1e-6
PREFILL_BATCH, PREFILL_LEN = 4, 4096  # 4096: StarCoder2's sliding-window span
# a prompt length that is no multiple of the kernel's 64-row tile (nor of 256)
RAGGED_BATCH, RAGGED_LEN = 2, 1500
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 128, 32
# 6b: the flash forward's last-position logits against the chunked plain
# path's.  Both round activations to bf16 after every product, in other
# places (the kernel scales S in f32 after QK^T, the plain path scales q in
# bf16 before it), and those 2^-8 relative differences compound over 30
# layers: allow 5% of the largest logit.
PREFILL_RTOL = 0.05
# 6a timing: the kernel and SDPA alternate, ROUNDS rounds of REPS launches
FLASH_ROUNDS, FLASH_REPS = 5, 20
# phase 1 timing: the five GF products alternate, ROUNDS rounds of REPS launches
GF_ROUNDS, GF_REPS = 5, 10
# phase 9: StarCoder2-3B trained at full width, 2 x 4096 tokens a step (its
# 4096 window) in 2 microbatches, every block rematerialised, KV chunks of 512
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_CHUNK = 2, 4096, 2, 512
TRAIN_TIMED_STEPS = 3
# at the launcher's 3e-4 the fourth update of 9a overshot on the card (loss
# 10.19 -> 11.29): with a 2-step warm-up, 1e-4 keeps the loss falling
TRAIN_LR = 1e-4
# 9b: full widths, depth cut to 2 layers: at 30 layers ``encode_state``'s
# serialized state (31.8 GB) and stripe (47.7 GB) do not fit beside the live
# training state (~51 GB) in 80 GB
CKPT_LAYERS = 2
# phase 10: the families beyond the dense one at their published widths, one
# at a time: (label, arch, layers or None for the config's).  dbrx's depth is
# cut to 4 of 40 layers: 40 are about 131.6e9 parameters, 263 GB in bf16; 4
# are about 14.3e9, 28.5 GB.
FAMILIES = [("10a", "dbrx-132b", 4), ("10b", "zamba2-1.2b", None),
            ("10c", "xlstm-125m", None), ("10d", "internvl2-1b", None),
            ("10e", "whisper-small", None)]
FAMILY_BATCH, FAMILY_LEN = 2, 4096  # prefill: 2 x 4096 positions (vlm: 256 + 3840)
WHISPER_TEXT = 448  # Whisper's text context: the decoder's prefill length
FAMILY_TIMED = 3  # prefill: median of 3 timed forwards, each after a warm-up
ENGINE_BATCH, ENGINE_PROMPT, ENGINE_NEW = 8, 32, 32
# the engine's logits at the last prompt position against the full forward's
# there: the engine feeds the prompt through decode steps (a KV cache with an
# f32 softmax, the xLSTM and Mamba2 recurrences with f32 states), the forward
# takes the flash kernel and the chunked SSD/mLSTM forms, which round
# activations to bf16 in other places; allow 5% of the largest logit, as 6b
# (MoE: against a forward at a capacity that drops nothing, since the
# forward's capacity counts all 8 x 32 tokens and decode's only 8).  xlstm:
# 10%: the chunked mLSTM rounds its (q.k) scores and decay-weighted products
# to bf16 where the decode keeps f32 memories, and the reference's own bf16
# decode departs from its forward by as much as the port's does
# (tests/test_torch_families.py::test_bf16_decode_gap_matches_reference)
ENGINE_RTOL = {"ssm": 0.10}
ENGINE_RTOL_DEFAULT = 0.05
# the seeded visual and frame embeddings are drawn as the token embedding table is
STUB_EMBED_STD = 0.02
# phase 11: every family trained at its published width in bf16, one at a
# time: (label, arch, layers or None for the config's).  The MoEs' depth is
# cut by memory: a bf16 state of params, grads and AdamW's bf16 moments is 8
# bytes a parameter, dbrx's layer 4.49e9 parameters (35.9 GB), grok's 6.53e9
# (52.2 GB), and the update's f32 temporaries of one slice, the global norm's
# of the largest leaf (up to 12.9 GB for grok's experts) and the backward's
# come on top: a second layer does not fit in 80 GB for either.  xlstm's
# depth is cut by time to 4 of 12 blocks (3 mLSTM, 1 sLSTM, as phase 15):
# its sLSTM's Python time loop made 11d host-bound, 105-135 s of the script
# with its profile's 449,000 kernels, the most of any part of phase 11
FAMILY_TRAIN = [("11a", "dbrx-132b", 1), ("11b", "grok-1-314b", 1),
                ("11c", "zamba2-1.2b", None), ("11d", "xlstm-125m", 4),
                ("11e", "internvl2-1b", None), ("11f", "whisper-small", None)]
# 2 x 2048 positions a step: vlm 256 patch embeddings + 1792 text tokens,
# audio 1500 frames through the encoder and the 448-token text context
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_POSITIONS = 2, 2048
FAMILY_TRAIN_TIMED = 2  # one warm-up step, then 2 timed, then 1 profiled
# phase 13: the sharded prefill over a (data 2, model 4) mesh of 8 gloo ranks
# on this one card: (label, arch, layers or None, rules, MoE sharding or
# None).  dbrx is cut to 2 of 40 layers (7.75e9 parameters, 15.5 GB in bf16,
# held over model and replicated over data: about 31 GB across the ranks),
# grok to 1 of 64 (6.53e9, about 26 GB); the ranks build the seeded model
# whole in rounds (as many at once as half the card holds) and keep their
# blocks
SHARDED = [("13a", "starcoder2-3b", None, "tp", None), ("13b", "dbrx-132b", 2, "tp", None),
           ("13c", "grok-1-314b", 1, "tp_sp", "ffn")]
SHARDED_MESH = (2, 4)
SHARDED_DENSE = (2, 4096)  # 13a's prefill: 2 x 4096 tokens (its window)
# the MoEs: rank 0's logits are held to one process's at a capacity factor of
# E / top_k, where every expert takes every token (none is dropped, here or
# there: each rank counts capacity over its own tokens, so at the config's
# capacity the drops differ from one process's), on 2 x 1024 tokens: the
# drop-free expert activations are E / (capacity_factor * top_k) times the
# config's, on 8 ranks at once.  Then the config's capacity on 2 x 2048, for
# the pairs it drops and the time
SHARDED_MOE_PARITY = (2, 1024)
SHARDED_MOE = (2, 2048)
# phase 14: training and decode over phase 13's mesh, one run at a time.
# 14a StarCoder2-3B trained at full width under ``fsdp``, 4 of 30 layers
# (cut from 30, which took 34.1 s a step, to leave room for phase 15 in the
# script's time): 2 x 4096 tokens (one row a data half) in one microbatch,
# every block rematerialised, KV chunks of 512, its config's f32 AdamW, WSD
# at peak 1e-4 entered past its warm-up (``model_run.train_config``, as
# 9a): a warm-up step, then a timed one.  14b dbrx-132b trained at 1 of 40
# layers under ``fsdp`` (expert parallel; its config's bf16 AdamW state):
# 4.49e9 parameters, 8 bytes each over 8 ranks, 4.5 GB a rank and 36 GB in
# all, and each rank's 4 experts gathered over data (1.6 GB); at the
# drop-free capacity on 2 x 512 tokens for parity, then at the config's on
# 2 x 1024, a warm-up and a timed step.  Tokens cut from 2 x 2048: there
# (and at the drop-free capacity on 2 x 1024) a rank's rematerialised
# experts' f32 products, (4, 2560, 10752) and (4, 4096, 10752), ran the card
# out of memory, 78.3 of 79.2 GB in use by 9 processes
# 14c StarCoder2-3B (full width, 4 of 30 layers: cut from 30, 1.41 s a
# token, as 14a) and 14d dbrx-132b (2 of 40 layers, 31 GB across
# the ranks, as 13b) decoded under ``tp``: batch 8, 16-token prompts (cut
# from 32 in PR 24 by time: 14c-d and 15i-l fed them in 60-78 s) fed
# through the decode step, then 16 greedy tokens, KV caches of 64.  14d's
# parity run routes every token to all 16 experts: at the config's top 4 of
# 16 random routers, bf16 differences of the mesh's partial sums flip a
# near-tied 4th expert, and a row whose expert flipped departs (on the
# H100 one of 8 rows by 13% of the largest logit, the other 7 within 1.4%);
# the config's top 4 then runs for the time and the greedy tokens
# 14e StarCoder2-3B at full width, 4 of 30 layers, under ``tp2d`` (ffn and
# vocab over model x data, the parameters' ``_StridedShard`` layouts): 2 x
# 4096 tokens, a warm-up step and a timed one, held as 14a
MESH_TRAIN = [("14a", "starcoder2-3b", 4, (2, 4096), "fsdp"),
              ("14b", "dbrx-132b", 1, (2, 1024), "fsdp"),
              ("14e", "starcoder2-3b", 4, (2, 4096), "tp2d")]
MESH_TRAIN_MOE_PARITY = (2, 512)
MESH_TRAIN_STEPS = 2  # a warm-up step, then a timed one
MESH_DECODE = [("14c", "starcoder2-3b", 4), ("14d", "dbrx-132b", 2)]
MESH_DECODE_BATCH, MESH_DECODE_PROMPT, MESH_DECODE_NEW, MESH_DECODE_KV = 8, 16, 16, 64
# rank 0's first step against one process's on the same seeded weights and
# batch: bf16 activations, other orders of sums (the mesh's partial sums and
# reductions) and, for the MoE, the balance loss of each rank's own tokens
MESH_LOSS_RTOL, MESH_NORM_RTOL = 0.01, 0.05
# phase 15: the ssm, hybrid, vlm and audio families at their published
# widths in bf16 over phase 13's mesh, in one spawn: (labels of the
# prefill, train and decode runs, arch, layers).  Depth cut to make room for
# phases 16 and 18: xlstm 4 of 12 blocks (3 mLSTM, 1 sLSTM), zamba2 6 of 38
# Mamba2 layers (one call of the shared block), internvl2 8 of 24, whisper's
# decoder 4 of 12 (its encoder whole).  Prefill under ``tp`` on
# FAMILY_MESH_PREFILL positions a row (internvl2's 256 patches among them;
# whisper's 1,500 frames and WHISPER_TEXT tokens), training under ``fsdp``
# on FAMILY_MESH_TRAIN (whisper WHISPER_TEXT), ``remat="full"`` and each
# config's AdamW state, decode under ``tp`` as 14c.  The sLSTM's time loop
# runs whole on each rank (wh gathered once a block)
FAMILY_MESH = [(("15a", "15e", "15i"), "xlstm-125m", 4), (("15b", "15f", "15j"), "zamba2-1.2b", 6),
               (("15c", "15g", "15k"), "internvl2-1b", 8),
               (("15d", "15h", "15l"), "whisper-small", 4)]
FAMILY_MESH_PREFILL = (2, 2048)
FAMILY_MESH_TRAIN = (2, 1024)
# phase 16: the pod axis and the sharded checkpoint, one spawn of 8 gloo
# ranks as a (pod 2, data 2, model 2) mesh (``multi_pod`` rules: the batch
# over pod x data).  16a StarCoder2-3B at full width, 4 of 30 layers (as 14a
# and 14c): prefill under ``tp`` on 4 x 2048, a warm-up and a timed ``fsdp``
# train step on 4 x 1024, remat, held to one process's at 2% of the largest
# logit, loss 0.5%, norm 2%.  16b the same at 2 layers (rank 0 gathers the
# 4.9 GB state beside the ranks' blocks and codes it), two steps, then
# DRC(9,6,3) save, node 2 lost, load into the layout through the layered
# repair, one step resumed against the uninterrupted one
POD_ARCH, POD_MESH, POD_LAYERS, POD_CKPT_LAYERS = "starcoder2-3b", (2, 2, 2), 4, 2
POD_PREFILL, POD_TRAIN = (4, 2048), (4, 1024)
POD_LOGIT_RTOL, POD_LOSS_RTOL, POD_NORM_RTOL = 0.02, 0.005, 0.02
# 16c: the dry run on the production meshes (fake tensors on a fake group of
# 256 or 512 ranks: counts, nothing launched) and the roofline probe of a
# train cell on the multi-pod mesh; the reference's band of the useful FLOP
# share is printed beside the probe's
DRYRUN_CELLS = [("starcoder2-3b", "prefill_32k", False), ("starcoder2-3b", "prefill_32k", True)]
PROBE_CELL = ("starcoder2-3b", "train_4k", True)
REFERENCE_USEFUL_BAND = (0.8, 1.3)  # tests/test_artifacts.py::test_train_cells_probe_validated
# phase 17: the verification layer's gate takes seconds on the host; the
# phase (gate, geometry queries, guard-band launches) must stay within this
CHECK_PHASE_S = 60.0
# 17c: guard-band launches at the ragged shapes: GF (G, R, K, B) and the
# output's byte offset inside its 0xA5-filled buffer (an odd offset or B
# takes the unaligned path, the last the 16-byte aligned one); flash (b, sq,
# sk, h, kvh, d, causal) and dtype, the output padded by GUARD_PAD rows of S,
# heads and head-dim columns filled with NaN
GF_GUARD = [((9, 5, 7, 333), 4097), ((1, 6, 12, 65_541), 4096), ((1, 200, 8, 5_008), 4096)]
FLASH_GUARD = [((2, 333, 517, 8, 2, 64, True), torch.bfloat16),
               ((2, 1500, 1500, 24, 2, 128, True), torch.bfloat16),
               ((2, 77, 130, 6, 3, 32, False), torch.float32)]
GUARD_PAD = (3, 1, 8)
GUARD_BYTES = 4096
# phase 18: the traced layer's sweep and self-test take seconds on the host;
# the phase (sweep, self-test, the real card runs held to the fake captures,
# the GF custom op's host cost) must stay within this
TRACED_PHASE_S = 60.0
# 18c: host-timed calls of each GF launch path a round, in turns
OP_COST_CALLS = 50
OP_COST_ROUNDS = 3


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sub_bytes(alpha: int) -> int:
    return math.ceil(BLOCK_BYTES / alpha / 128) * 128


def rand_bytes(shape: tuple[int, ...], gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=DEVICE, generator=gen)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(r: int, k: int, b: int, g: int = 1) -> tuple[float, str]:
    """Least time for a (G, R, K, B) GF(256) product by any implementation:
    each input read once and the output written once, over the HBM rate."""
    return g * ((r + k) * b + r * k) / HBM_BYTES_PER_S * 1e3, "bytes"


def int8_bitplane_ms(r: int, k: int, b: int, g: int = 1) -> float:
    """The TPU kernel's int8 bitplane product, (8R, 8K) x (8K, B), at the
    int8 tensor-core rate: the computed cost of one algorithm that nothing
    here runs, neither a floor nor a measurement."""
    return g * 2 * (8 * r) * (8 * k) * b / INT8_OPS_PER_S * 1e3


class KernelCheck:
    """Byte-exact comparisons of the kernel with its plain version."""

    def __init__(self) -> None:
        self.compared = 0
        self.mismatched = 0
        self.max_abs_err = 0

    def compare(self, m: torch.Tensor, x: torch.Tensor, label: str) -> torch.Tensor:
        y = gf_matmul_batched(m, x)
        torch.cuda.synchronize()
        for i in range(m.shape[0]):
            want = gf_matmul_table(m[i], x[i])
            diff = (y[i].int() - want.int()).abs()
            bad = int((diff != 0).sum())
            self.mismatched += bad
            self.max_abs_err = max(self.max_abs_err, int(diff.max()) if diff.numel() else 0)
            self.compared += want.numel()
            check(bad == 0, f"kernel vs plain at {label}[{i}]: {bad} bytes differ")
        return y


def phase_kernel(gen: torch.Generator) -> dict:
    kc = KernelCheck()
    for r, k, b in SHAPES:
        kc.compare(rand_bytes((1, r, k), gen), rand_bytes((1, k, b), gen), f"{r}x{k}x{b}")
    kc.compare(rand_bytes((9, 5, 7), gen), rand_bytes((9, 7, 333), gen), "batched ragged")
    timed = {}  # label -> (m, x, out): the products timed in turns
    repair_steps = {}  # DRC(9,6,3)'s NodeEncode, RelayerEncode and decode
    plain = {}
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = sub_bytes(code.alpha)
        ka = code.k * code.alpha
        # the full-width parity encode
        m = torch.from_numpy(np.ascontiguousarray(code.generator[ka:])).to(DEVICE)[None]
        x = rand_bytes((1, ka, sub), gen)
        kc.compare(m, x, f"{code!r} encode")
        out = torch.empty((1, m.shape[1], sub), dtype=torch.uint8, device=DEVICE)
        timed[f"{code!r} encode"] = (m, x, out)
        plain[f"{code!r} encode"] = cuda_ms(lambda: gf_matmul_table(m[0], x[0]), reps=2)
        # the emulated mesh's batched products of one repair, at full width
        spec = plan_to_spmd(code, code.repair_plan(0))
        nm = torch.from_numpy(spec.node_mats).to(DEVICE)
        xs = rand_bytes((code.n, code.alpha, sub), gen)
        kc.compare(nm, xs, f"{code!r} node_encode")
        steps = {f"{code!r} node_encode": (nm, xs)}
        del xs
        if spec.ru:
            rel = spec.rel_idx.astype(np.int64)
            rm = torch.from_numpy(np.ascontiguousarray(spec.relayer_mats[rel])).to(DEVICE)
            xr = rand_bytes((len(rel), rm.shape[2], sub), gen)
            kc.compare(rm, xr, f"{code!r} relayer_encode")
            steps[f"{code!r} relayer_encode"] = (rm, xr)
            del xr
        dm = torch.from_numpy(spec.decode).to(DEVICE)[None]
        xd = rand_bytes((1, dm.shape[2], sub), gen)
        kc.compare(dm, xd, f"{code!r} decode")
        steps[f"{code!r} decode"] = (dm, xd)
        del xd
        if (fam, n, k, r) == CODES[0]:  # DRC(9,6,3)'s repair steps are timed too
            for label, (sm, sx) in steps.items():
                out = torch.empty((sm.shape[0], sm.shape[1], sub), dtype=torch.uint8,
                                  device=DEVICE)
                repair_steps[label] = (sm, sx, out)
        del steps
        torch.cuda.empty_cache()
    timed.update(repair_steps)
    turns = time_in_turns({label: (lambda m=m, x=x, o=o: gf_matmul_batched(m, x, o))
                           for label, (m, x, o) in timed.items()}, GF_ROUNDS, GF_REPS)
    timings = []
    model = {}  # label -> the int8 bitplane product's computed ms
    for label, (m, x, _) in timed.items():
        g, r, k = m.shape
        b = x.shape[2]
        b_ms, b_by = bound(r, k, b, g)
        t = turns[label]
        timings.append({"label": label, "shape": [g, r, k, b], "ms": t["ms"],
                        "ms_spread": t["ms_spread"], "rounds_ms": t["rounds_ms"],
                        "plain_ms": plain.get(label), "bound_ms": b_ms, "bound_by": b_by,
                        "bound_share": b_ms / t["ms"]})
        model[label] = int8_bitplane_ms(r, k, b, g)
    del timed
    torch.cuda.empty_cache()
    return {"check": kc, "timings": timings, "int8_bitplane_ms": model}


def phase_encode(gen: torch.Generator) -> dict:
    stripes, out = {}, {}
    for fam, n, k, r in CODES:
        code = make_code(fam, n, k, r)
        sub = sub_bytes(code.alpha)
        ka = code.k * code.alpha
        data = rand_bytes((ka, sub), gen)
        stripe = torch.empty((code.n * code.alpha, sub), dtype=torch.uint8, device=DEVICE)
        stripe[:ka].copy_(data)
        step = make_encode_step(code, sub, DEVICE)
        step(stripe)
        torch.cuda.synchronize()
        check(torch.equal(stripe[:ka], data), f"{code!r}: encode touched the data rows")
        parity = gf_matmul_table(code.generator[ka:], data)
        check(torch.equal(stripe[ka:], parity), f"{code!r}: parity differs from the plain version")
        ms = cuda_ms(lambda: step(stripe), reps=3)
        stripes[(fam, n, k, r)] = stripe.view(code.n, code.alpha, sub)
        out[repr(code)] = {"ms": ms, "stripe_bytes": stripe.numel(), "sub": sub}
        del data, parity
    return {"stripes": stripes, "results": out}


def _check_traffic(tr: obs.Tracer, plan, code, sub: int, label: str) -> dict:
    t = plan.traffic_blocks()
    got = {}
    for scope in ("inner", "cross"):
        want = round(t[f"{scope}_rack_blocks"] * code.alpha) * sub
        got[scope] = tr.counter_value(f"repair.bytes.{scope}_rack")
        check(got[scope] == want, f"{label}: {scope}-rack bytes {got[scope]} != {want}")
    if code.name.startswith("DRC"):
        eq3 = drc_min_cross_rack_blocks(code.n, code.k, code.r)
        check(abs(t["cross_rack_blocks"] - eq3) < 1e-9,
              f"{label}: cross-rack blocks {t['cross_rack_blocks']} != Eq. (3) {eq3}")
    return {"inner_bytes": got["inner"], "cross_bytes": got["cross"],
            "cross_rack_blocks": t["cross_rack_blocks"]}


def phase_repair(stripes: dict) -> dict:
    out = {}
    for (fam, n, k, r), payloads in stripes.items():
        code = make_code(fam, n, k, r)
        sub = payloads.shape[2]
        for failed in (0, n - 1):
            label = f"{code!r} node {failed}"
            plan = code.repair_plan(failed)
            helpers = {i: payloads[i] for i in plan.participants()}
            with obs.tracing("plan") as tr:
                rebuilt = plan.execute(helpers)
            check(torch.equal(rebuilt, payloads[failed]), f"{label}: plan repair differs")
            row = _check_traffic(tr, plan, code, sub, f"{label} plan")
            row["plan_ms"] = cuda_ms(lambda: plan.execute(helpers), reps=1)
            with obs.tracing("spmd") as tr:
                rec, spec = spmd_repair(code, failed, payloads)
            got = rec[spec.target_pod * spec.w]
            check(torch.equal(got, payloads[failed]), f"{label}: spmd repair differs")
            _check_traffic(tr, plan, code, sub, f"{label} spmd")
            del rec, got
            row["spmd_ms"] = cuda_ms(lambda: spmd_repair(code, failed, payloads), reps=1)
            out[label] = row
            torch.cuda.empty_cache()
    return out


def phase_recovery(gen: torch.Generator) -> dict:
    code = make_code("DRC", 9, 6, 3)
    sub = sub_bytes(code.alpha)
    ka = code.k * code.alpha
    step = make_encode_step(code, sub, DEVICE)
    stripes = torch.empty((RECOVERY_STRIPES, code.n * code.alpha, sub),
                          dtype=torch.uint8, device=DEVICE)
    for s in range(RECOVERY_STRIPES):
        stripes[s, :ka] = rand_bytes((ka, sub), gen)
        step(stripes[s])
    payloads = stripes.view(RECOVERY_STRIPES, code.n, code.alpha, sub)
    with obs.tracing("recovery") as tr:
        out, specs = spmd_node_recovery(code, 0, payloads)
    for s, spec in enumerate(specs):
        check(torch.equal(out[s, spec.target_pod * spec.w], payloads[s, 0]),
              f"node recovery stripe {s} differs")
    rel_sets = {tuple(sp.rel_idx.tolist()) for sp in specs}
    check(len(rel_sets) > 1, f"relayers did not rotate: {rel_sets}")
    plan_cross = sum(round(code.repair_plan(0, rotation=s).traffic_blocks()["cross_rack_blocks"]
                           * code.alpha) * sub for s in range(RECOVERY_STRIPES))
    check(tr.counter_value("repair.bytes.cross_rack") == plan_cross,
          "node recovery cross-rack bytes differ from the plans'")
    del out
    ms = cuda_ms(lambda: spmd_node_recovery(code, 0, payloads), reps=1)
    return {"stripes": RECOVERY_STRIPES, "payload_bytes": payloads.numel(),
            "relayer_sets": len(rel_sets), "ms": ms,
            "cross_bytes": tr.counter_value("repair.bytes.cross_rack")}


def make_state(gen: torch.Generator) -> dict:
    """~256 MiB: 8 layers of an f32 weight and two bf16 moments, + a step."""
    state = {"step": torch.tensor([7], dtype=torch.int32, device=DEVICE), "layers": {}}
    for i in range(8):
        state["layers"][f"{i:02d}"] = {
            "w": torch.randn((2048, 2048), generator=gen, device=DEVICE),
            "m": torch.randn((2048, 2048), generator=gen, device=DEVICE).bfloat16(),
            "v": torch.rand((2048, 2048), generator=gen, device=DEVICE).bfloat16(),
        }
    return state


def phase_checkpoint(gen: torch.Generator) -> dict:
    state = make_state(gen)
    nbytes = sum(t.numel() * t.element_size() for t in checkpoint.tensors(state))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, family="DRC", n=9, k=6, r=3, device=DEVICE)
        mgr.save(1, state)
        os.remove(os.path.join(d, "step_00000001", "node_1.bin"))
        got, step, report = mgr.load(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(step == 1 and report.mode == "repair", f"checkpoint load: step {step}, {report}")
    for a, b in zip(checkpoint.tensors(got), checkpoint.tensors(state)):
        check(a.dtype == b.dtype and a.shape == b.shape, "checkpoint leaf shape/dtype")
        check(torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)),
              "checkpoint state is not bit-equal")
    return {"state_bytes": nbytes, "mode": report.mode,
            "cross_rack_blocks": report.cross_rack_blocks, "host_s": dt}


def phase_mesh() -> dict:
    """7: the process-group executor, 9 ranks on this card over gloo."""
    cases = [mesh_run.Case(spec, failed, sub_bytes(make_code(*spec).alpha), seed=i)
             for i, spec in enumerate(CODES) for failed in (0, spec[1] - 1)]
    cases.append(mesh_run.Case(CODES[0], 0, sub_bytes(make_code(*CODES[0]).alpha),
                               seed=len(CODES), stripes=MESH_RECOVERY_STRIPES))
    with tempfile.TemporaryDirectory() as d:
        rows = mesh_run.run(cases, workdir=d, device=DEVICE)
    out = {}
    for case, row in zip(cases, rows):
        code = make_code(*case.code)
        label = f"{code!r} node {case.failed}" + (f" x{case.stripes} stripes" if case.stripes
                                                  else "")
        check(row["equal"], f"mesh {label}: the collector's output differs")
        check(row["others_zero"], f"mesh {label}: a rank other than the collector wrote")
        check(all(c["cuda"] > 0 and c["ref"] == 0 for c in row["gf_calls"]),
              f"mesh {label}: a rank's GF products did not run on the card: {row['gf_calls']}")
        cross = sum(round(code.repair_plan(case.failed, rotation=s).traffic_blocks()[
            "cross_rack_blocks"] * code.alpha) * case.sub for s in range(max(1, case.stripes)))
        check(row["pod_sent_bytes"] == cross == row["counters"]["repair.bytes.cross_rack"],
              f"mesh {label}: {row['pod_sent_bytes']} bytes sent between pods, the plans' "
              f"cross-rack bytes are {cross}")
        if case.stripes:
            check(len(row["relayer_sets"]) > 1, f"mesh {label}: relayers did not rotate")
        out[label] = {"ranks": row["world"], "sub": case.sub, "block_bytes": BLOCK_BYTES,
                      "pod_sent_bytes": row["pod_sent_bytes"],
                      "host_staged_bytes": row["counters"]["repair.bytes.host_staged"],
                      "launches": row["launches"], "gloo_host_staged_ms": row["ms"]}
    return out


def phase_evaluation(gen: torch.Generator) -> dict:
    """8: multi-failure repair, code switching, the FT manager's restore and
    rescale on the card, and the simulator's Table 3 row."""
    out = {}
    for spec, failed in MULTI_FAILURES:
        code = make_code(*spec)
        sub = sub_bytes(code.alpha)
        ka = code.k * code.alpha
        stripe = torch.empty((code.n * code.alpha, sub), dtype=torch.uint8, device=DEVICE)
        stripe[:ka] = rand_bytes((ka, sub), gen)
        make_encode_step(code, sub, DEVICE)(stripe)
        nodes = stripe.view(code.n, code.alpha, sub)
        avail = {i: nodes[i] for i in range(code.n) if i not in failed}
        got, report = multi_failure_repair(code, failed, avail)
        torch.cuda.synchronize()
        for f in failed:
            check(torch.equal(got[f], nodes[f]), f"multi-failure {code!r} {failed}: node {f}")
        del got
        ms = cuda_ms(lambda: multi_failure_repair(code, failed, avail), reps=1)
        out[f"multi_failure {code!r} {failed}"] = {
            "helpers": report.helpers, "cross_rack_blocks": report.cross_rack_blocks, "ms": ms}
        del stripe, nodes, avail
        torch.cuda.empty_cache()
    sw = CodeSwitcher()
    blocks = rand_bytes((6, BLOCK_BYTES), gen)
    for accesses in (0, 20):  # cold: RS(8,6,4); then hot: DRC(9,6,3)
        for _ in range(accesses):
            sw.record_access(0)
        coded = sw.switch(0, blocks)
        code = make_code(*sw.target_code(0))
        data = code.decode({i: coded[i] for i in range(code.k)})
        check(torch.equal(data.reshape(6, -1)[:, :BLOCK_BYTES], blocks),
              f"code switch to {code!r}: decoded blocks differ")
        del coded, data
        ms = cuda_ms(lambda: sw.switch(0, blocks), reps=1)
        out[f"switch to {code!r}"] = {"placement": sw.placement[0], "ms": ms}
    del blocks
    torch.cuda.empty_cache()
    state = make_state(gen)
    ckpt = encode_state(state, family="DRC", n=9, k=6, r=3, device=DEVICE)
    mgr = FaultToleranceManager()

    def state_equal(got: dict) -> bool:
        return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(checkpoint.tensors(got), checkpoint.tensors(state)))

    for lost in ([1], [0, 4, 8]):
        got, report, action = mgr.execute(ckpt, state, lost)
        torch.cuda.synchronize()
        check(state_equal(got), f"ft execute {lost}: state is not bit-equal")
        del got
        ms = cuda_ms(lambda: mgr.execute(ckpt, state, lost), reps=1)
        out[f"ft execute {lost}"] = {"kind": action.kind, "mode": report.mode, "ms": ms}
    new = mgr.rescale(ckpt, state, n=6, k=4, r=3)
    got, report = restore_state(new, state, available=set(range(6)) - {2})
    torch.cuda.synchronize()
    check(new.code_spec == ("DRC", 6, 4, 3) and state_equal(got),
          "ft rescale: the re-encoded state is not bit-equal")
    del got, new
    ms = cuda_ms(lambda: mgr.rescale(ckpt, state, n=6, k=4, r=3), reps=1)
    out["ft rescale DRC(9,6,3) -> DRC(6,4,3)"] = {"restore_mode": report.mode, "ms": ms}
    del ckpt, state
    torch.cuda.empty_cache()
    out["simulator table3 DRC(9,6,3) 63 MiB 1 Gb/s (s, computed)"] = \
        ClusterSim().table3_breakdown(make_code("DRC", 9, 6, 3), block_mib=63.0)
    return out


def flash_flops(b: int, sq: int, sk: int, h: int, d: int, causal: bool) -> int:
    """4·d FLOP per (row, visible column) pair: QK^T and PV, 2·d each."""
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    return 4 * b * h * d * pairs


def flash_bound(b: int, sq: int, sk: int, h: int, kvh: int, d: int, causal: bool,
                itemsize: int) -> tuple[float, str]:
    """Least time for one attention forward: q, k, v read once and o written
    once, against its FLOP (``flash_flops``) at the bf16 rate."""
    flops = flash_flops(b, sq, sk, h, d, causal)
    moved = itemsize * (2 * b * sq * h * d + 2 * b * sk * kvh * d)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_errors(got, q, k, v, causal: bool) -> dict:
    """The kernel's output against ``flash_attention_ref`` on the same inputs:
    the max abs error against the plain version's output in q's dtype, and,
    against its unrounded f32 output (the same arithmetic on the inputs cast
    to f32), the relative Frobenius error and the max of |err| over the row's
    own scale, ``attention(q, k, |v|)`` = sum_j p_j |v_j| / l.  Rounding P and
    the output to bf16 moves an element by at most about 2^-8 of that scale
    each (P's rounding error is at most 2^-8 * sum_j p_j |v_j| / l), at any
    row length; f32 inputs stay far inside it."""
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = flash_attention_ref(qf, kf, vf, causal=causal)
    scale = flash_attention_ref(qf, kf, vf.abs(), causal=causal)
    got = got.float()
    diff = (got - ref).abs()
    return {"max_abs_err": float((got - ref.to(q.dtype).float()).abs().max()),
            "rel_fro_err": float(diff.norm() / ref.norm()),
            "max_err_over_scale": float((diff / (scale + FLASH_SCALE_FLOOR)).max())}


def check_flash(errs: dict, atol: float, what: str) -> None:
    check(errs["max_abs_err"] <= atol and errs["rel_fro_err"] <= FLASH_REL_FRO
          and errs["max_err_over_scale"] <= FLASH_REL_SCALE, f"flash {what}: {errs}")


def time_in_turns(fns: dict, rounds: int, reps: int) -> dict:
    """Each of ``fns`` timed in turns (a, b, a, b, ...) over ``rounds`` rounds
    of ``reps`` launches: per name, the median ms per call, its min-max
    spread, and every round's ms."""
    times: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, reps))
    return {name: {"ms": float(np.median(ts)), "ms_spread": [min(ts), max(ts)], "rounds_ms": ts}
            for name, ts in times.items()}


def flash_timing(q, k, v, causal: bool) -> dict:
    """The kernel and SDPA on the same (B, S, H, D) inputs, timed in turns,
    with the kernel's achieved TFLOP/s and share of its bound."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, S, D) views
    turns = time_in_turns({
        "kernel": lambda: flash_attention(q, k, v, causal=causal),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True),
    }, FLASH_ROUNDS, FLASH_REPS)
    kern, sdpa = turns["kernel"], turns["sdpa"]
    b_ms, b_by = flash_bound(b, sq, sk, h, kvh, d, causal, q.element_size())
    flops = flash_flops(b, sq, sk, h, d, causal)
    return {"shape": [b, sq, sk, h, kvh, d], "causal": causal,
            "ms": kern["ms"], "ms_spread": kern["ms_spread"], "rounds_ms": kern["rounds_ms"],
            "tflops": flops / kern["ms"] / 1e9, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / kern["ms"],
            "library_ms": sdpa["ms"], "library_ms_spread": sdpa["ms_spread"],
            "library_tflops": flops / sdpa["ms"] / 1e9,
            "kernel_over_library": kern["ms"] / sdpa["ms"]}


def phase_flash(gen: torch.Generator, cfg, batch: int, seq: int,
                ragged_batch: int, ragged_len: int) -> dict:
    """6a: the kernel against its plain version, then timed at the layer shape
    and at a ragged one."""
    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    errs = {}
    for dtype, atol in FLASH_ATOL.items():
        worst = {}
        for b, sq, sk, h, kvh, d, causal in FLASH_SWEEP:
            q, k, v = rand(b, sq, h, d, dtype=dtype), rand(b, sk, kvh, d, dtype=dtype), \
                rand(b, sk, kvh, d, dtype=dtype)
            got = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            e = flash_errors(got, q, k, v, causal)
            check_flash(e, atol, f"{dtype} {(b, sq, sk, h, kvh, d, causal)}")
            worst = {key: max(val, worst.get(key, 0.0)) for key, val in e.items()}
        errs[str(dtype).replace("torch.", "")] = worst
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rand(batch, seq, h, d, dtype=torch.bfloat16)
    k = rand(batch, seq, kvh, d, dtype=torch.bfloat16)
    v = rand(batch, seq, kvh, d, dtype=torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    e = flash_errors(got, q, k, v, True)
    check_flash(e, FLASH_ATOL[torch.bfloat16], "at the model shape")
    del got
    timing = flash_timing(q, k, v, True)
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), reps=2)
    del q, k, v
    q = rand(ragged_batch, ragged_len, h, d, dtype=torch.bfloat16)
    k = rand(ragged_batch, ragged_len, kvh, d, dtype=torch.bfloat16)
    v = rand(ragged_batch, ragged_len, kvh, d, dtype=torch.bfloat16)
    ragged = flash_timing(q, k, v, True)
    return {"dtype": "bfloat16", **e, "errs_sweep": errs, **timing, "plain_ms": plain_ms,
            "ragged": ragged}


def profile_device(fn, steps: int, *, warmup: bool = True, top: int = 5, ops: int = 0) -> dict:
    """Device time of ``steps`` calls of ``fn`` under ``torch.profiler``, after
    one call outside it (``warmup``): the kernels' summed time against the
    host clock of the window, the number of kernels, and the ``top`` largest
    kernels by time.  With ``ops``, also the device time of the ``ops``
    largest aten ops by name, and by name and input shapes (recording the
    shapes costs host time: the window's busy share then reads low).
    Reports no device time where the profiler saw none."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    # host ops only where they are read: without them the trace reads faster
    acts = [torch.profiler.ProfilerActivity.CUDA] + (
        [torch.profiler.ProfilerActivity.CPU] if ops else [])
    with torch.profiler.profile(activities=acts, record_shapes=ops > 0) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
    by_name: dict[str, float] = {}
    # aten ops (host events) by the device time of their own kernels, and calls
    by_op: dict[str, list[float]] = {}
    by_op_shape: dict[tuple[str, str], list[float]] = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        elif ops and e.self_device_time_total > 0:
            ms = e.self_device_time_total / 1e3
            for table, key in ((by_op, e.name), (by_op_shape, (e.name, str(e.input_shapes)[:120]))):
                acc = table.setdefault(key, [0.0, 0])
                acc[0] += ms
                acc[1] += 1
    busy_ms = sum(by_name.values())
    largest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": busy_ms / steps, "kernels_per_step": n / steps,
           "device_busy_share": busy_ms / wall_ms,
           "top_ms_per_step": [[name[:80], ms / steps] for name, ms in largest]}
    if ops:
        for label, table in (("top_ops_ms_per_step", by_op),
                             ("top_op_shapes_ms_per_step", by_op_shape)):
            rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:ops]
            out[label] = [[*(key if isinstance(key, tuple) else (key,)), ms / steps, calls / steps]
                          for key, (ms, calls) in rows]
    out["summary_s"] = time.perf_counter() - t  # host time to stop and read the trace
    return out


def phase_prefill(gen: torch.Generator, cfg, model, batch: int, seq: int, *,
                  profile: bool = True) -> dict:
    """6b: the full-sequence forward through the flash kernel, held against
    the chunked plain path."""
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=DEVICE)
    step = make_prefill_step(cfg, device=DEVICE)
    before = flash_attention.launches
    logits = step(model, {"tokens": tokens})
    torch.cuda.synchronize()
    per_forward = flash_attention.launches - before
    if DEVICE == "cuda":
        check(per_forward == cfg.n_layers,
              f"prefill launched the flash kernel {per_forward} times, not {cfg.n_layers}")
    check(logits.shape == (batch, cfg.padded_vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "prefill logits are not finite")
    ms = cuda_ms(lambda: step(model, {"tokens": tokens}), reps=2)
    t = time.perf_counter()
    plain = make_prefill_step(cfg, device=DEVICE, use_flash=False)(model, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    diff = float((logits.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    top1 = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
    check(diff <= PREFILL_RTOL * scale,
          f"prefill logits differ from the plain path by {diff} (max |logit| {scale})")
    del plain
    out = {"batch": batch, "seq": seq, "flash_launches_per_forward": per_forward,
           "ms": ms, "plain_path_ms": plain_ms, "max_abs_diff": diff,
           "max_abs_logit": scale, "top1_agreement": top1}
    if profile:
        out["profile"] = profile_device(lambda: step(model, {"tokens": tokens}), steps=1)
    return out


def phase_serve(gen: torch.Generator, cfg, model, batch: int, prompt: int, new: int) -> dict:
    """6c: the engine's prefill (decode steps over the prompt) and greedy
    generation, with its spans and counters."""
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=DEVICE)
    eng = ServeEngine(cfg, model, batch=batch, kv_len=prompt + new + 8, device=DEVICE)
    with obs.tracing("serve") as tr:
        t = time.perf_counter()
        last = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        t = time.perf_counter()
        out = eng.generate(new)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
    check(last.shape == (batch, cfg.padded_vocab) and bool(torch.isfinite(last).all()),
          "serve prefill logits")
    check(out.shape == (batch, new) and out.dtype == torch.int32, f"tokens {tuple(out.shape)}")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab, "tokens outside the vocab")
    check(eng.position == prompt + new, f"position {eng.position}")
    got = {k: tr.counter_value(f"serve.tokens.{k}") for k in ("prefill", "decode")}
    check(got == {"prefill": batch * prompt, "decode": batch * new}, f"counters {got}")
    check(len(tr.spans_named("serve.prefill")) == 1 and len(tr.spans_named("serve.generate")) == 1,
          "serve spans")
    # the decode step alone, at the last position (the cache slot it writes is spare)
    tok = out[:, -1:]
    prof = profile_device(lambda: eng._step(model, eng.state, tok, eng.position), steps=4)
    return {"batch": batch, "prompt": prompt, "new": new, "kv_len": eng.kv_len,
            "position": eng.position, "counters": got,
            "prefill_ms_per_step": prefill_s * 1e3 / prompt,
            "decode_ms_per_step": gen_s * 1e3 / new, "decode_profile": prof}


def train_config(steps: int) -> TrainConfig:
    """Phase 9's training: the launcher's WSD schedule over ``steps`` (warm-up
    of 2 steps) at peak ``TRAIN_LR``, in ``TRAIN_MICRO`` microbatches."""
    return TrainConfig(schedule=ScheduleConfig(kind="wsd", peak_lr=TRAIN_LR, warmup_steps=2,
                                               total_steps=steps),
                       microbatches=TRAIN_MICRO, attn_chunk=TRAIN_CHUNK)


def timed_step(step_fn, model, opt, batch, step: int) -> dict:
    """One train step timed by the host clock to its synchronised end and by
    CUDA events; the loss, lr and grad norm read after it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start.record()
    _, _, metrics = step_fn(model, opt, batch, step)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    return {"step": step, "host_ms": host_ms, "cuda_ms": start.elapsed_time(end),
            **{k: float(metrics[k]) for k in ("loss", "lr", "grad_norm")}}


def phase_train(gen: torch.Generator, cfg, batch: int, seq: int) -> dict:
    """9a: ``init_train_state`` and ``make_train_step`` at the config's full
    width and depth: a warm-up step with a hook on every parameter's
    gradient, profiled by aten op and input shape, ``TRAIN_TIMED_STEPS``
    timed steps and one under ``torch.profiler`` for the busy share, all on
    the stream's first batch, so that the launcher's success test reads the
    updates and not the spread between batches."""
    steps = 2 + TRAIN_TIMED_STEPS
    tcfg = train_config(steps)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, opt = init_train_state(gen, cfg, tcfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticStream(cfg, DataConfig(seed=SEED, batch=batch, seq=seq), device=DEVICE).batch_at(0)
    step_fn = make_train_step(cfg, tcfg)
    flash_before = flash_attention.launches
    # the first step's gradients, one norm per parameter and microbatch
    norms: dict[str, list[torch.Tensor]] = {}
    hooks = [p.register_hook(lambda g, name=name: norms.setdefault(name, []).append(
        torch.linalg.vector_norm(g.float()))) for name, p in model.named_parameters()]
    rows = []
    try:  # the warm-up step also gives the device time by op and shape
        ops_prof = profile_device(lambda: rows.append(timed_step(step_fn, model, opt, data, 0)),
                                  steps=1, warmup=False, top=0, ops=12)
    finally:
        for h in hooks:
            h.remove()
    missing = [name for name, _ in model.named_parameters() if len(norms.get(name, ())) != TRAIN_MICRO]
    check(not missing, f"9a: no gradient in every microbatch for {missing[:5]}")
    per_param = {name: torch.stack(v) for name, v in norms.items()}
    bad = [name for name, v in per_param.items()
           if not bool(torch.isfinite(v).all()) or float(v.sum()) == 0.0]
    check(not bad, f"9a: first-step gradients not finite or all zero for {bad[:5]}")
    least = min(per_param.items(), key=lambda kv: float(kv[1].sum()))
    for step in range(1, 1 + TRAIN_TIMED_STEPS):
        row = timed_step(step_fn, model, opt, data, step)
        rows.append(row)
    last = steps - 1
    prof = profile_device(lambda: rows.append(timed_step(step_fn, model, opt, data, last)),
                          steps=1, warmup=False, top=12)
    losses = [r["loss"] for r in rows]
    check(all(math.isfinite(x) for x in losses), f"9a: losses {losses}")
    check(training_ok(losses), f"9a: the launcher's success test fails on {losses}")
    check(flash_attention.launches == flash_before,
          "9a: the train step launched the flash kernel (it has no backward)")
    timed = rows[1:1 + TRAIN_TIMED_STEPS]
    host_ms = float(np.median([r["host_ms"] for r in timed]))
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": batch,
           "seq": seq, "microbatches": TRAIN_MICRO, "remat": cfg.remat,
           "attn_chunk": TRAIN_CHUNK, "init_s": init_s, "steps": rows,
           "step_host_ms_median": host_ms,
           "step_cuda_ms_median": float(np.median([r["cuda_ms"] for r in timed])),
           "tokens_per_s": batch * seq / host_ms * 1e3,
           "grad_norm_least": [least[0], float(least[1].sum())],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "max_memory_reserved": torch.cuda.max_memory_reserved(),
           "profile": prof,
           "warmup_ops": {k: ops_prof[k] for k in ("device_ms_per_step", "top_ops_ms_per_step",
                                                    "top_op_shapes_ms_per_step", "summary_s")}}
    del model, opt, step_fn, data
    torch.cuda.empty_cache()
    return out


def phase_train_checkpoint(gen: torch.Generator, cfg, batch: int, seq: int) -> dict:
    """9b: train, save with DRC(9,6,3), train on, lose ``node_2.bin``, load
    through the layered repair, copy the restored state in place and replay
    the steps after the save."""
    tcfg = train_config(4)
    model, opt = init_train_state(gen, cfg, tcfg, device=DEVICE)
    stream = SyntheticStream(cfg, DataConfig(seed=SEED, batch=batch, seq=seq), device=DEVICE)
    step_fn = make_train_step(cfg, tcfg)
    first, replay = [], []
    for step in range(2):
        first.append(timed_step(step_fn, model, opt, stream.batch_at(step), step))
    with tempfile.TemporaryDirectory() as d, obs.tracing("9b") as tr:
        mgr = CheckpointManager(d, family="DRC", n=9, k=6, r=3, keep=1, device=DEVICE)
        live = train_state(model, opt)
        saved = state_to_bytes(live)[0]  # a copy: the leaves are concatenated
        state_bytes = saved.numel()
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt = mgr.save(2, live)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t
        stripe_bytes = sum(p.numel() for p in ckpt.payloads.values())
        del ckpt
        for step in (2, 3):
            first.append(timed_step(step_fn, model, opt, stream.batch_at(step), step))
        os.remove(os.path.join(mgr._stepdir(2), "node_2.bin"))
        gf_save = sum(sp.dur_us for sp in tr.spans_named("kernel.gf_matmul")) / 1e3
        t = time.perf_counter()
        restored, step, report = mgr.load(live)
        copy_state_(live, restored)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        del restored
        gf_load = sum(sp.dur_us for sp in tr.spans_named("kernel.gf_matmul")) / 1e3 - gf_save
        spans = {name: [sp.dur_us / 1e3 for sp in tr.spans_named(name)] for name in (
            "ckpt.encode", "ckpt.save", "ckpt.load", "ckpt.restore")}
        calls = {path: tr.counter_value("kernel.gf_matmul.calls", path=path)
                 for path in ("cuda", "ref")}
    plan_cross = make_code("DRC", 9, 6, 3).repair_plan(2).traffic_blocks()["cross_rack_blocks"]
    check(step == 2 and report.mode == "repair", f"9b: load gave step {step}, {report}")
    check(report.cross_rack_blocks == plan_cross,
          f"9b: cross-rack blocks {report.cross_rack_blocks} != the plan's {plan_cross}")
    check(torch.equal(state_to_bytes(live)[0], saved), "9b: the restored state is not byte-equal")
    check(calls["cuda"] > 0 and calls["ref"] == 0, f"9b: GF products by path {calls}")
    del saved
    for step in (2, 3):
        replay.append(timed_step(step_fn, model, opt, stream.batch_at(step), step))
    losses = [r["loss"] for r in first + replay]
    check(all(math.isfinite(x) for x in losses), f"9b: losses {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    del model, opt, live, step_fn
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
            "state_bytes": state_bytes, "stripe_bytes": stripe_bytes,
            "mode": report.mode, "cross_rack_blocks": report.cross_rack_blocks,
            "plan_cross_rack_blocks": plan_cross, "gf_calls": calls,
            "save_host_s": save_s, "save_gf_device_ms": gf_save,
            "load_host_s": load_s, "load_gf_device_ms": gf_load, "spans_ms": spans,
            "losses_first_pass": [r["loss"] for r in first[2:]],
            "losses_replayed": [r["loss"] for r in replay],
            "step_host_ms": [r["host_ms"] for r in first + replay]}


def flash_per_forward(cfg) -> int:
    """Flash launches in one full-sequence forward of ``cfg``'s family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":  # the shared block, once per whole segment
        return cfg.n_layers // (cfg.shared_attn_every or cfg.n_layers)
    if cfg.family == "audio":  # encoder self-attention, decoder self and cross
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def family_flash_shapes(cfg) -> list[tuple]:
    """The attention shapes phase 10 gives the flash kernel: (b, sq, sk, h,
    kvh, d, causal)."""
    h, kvh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.family == "ssm":
        return []
    if cfg.family == "audio":
        f = cfg.encoder_seq
        return [(FAMILY_BATCH, f, f, h, kvh, d, False),  # encoder
                (FAMILY_BATCH, WHISPER_TEXT, WHISPER_TEXT, h, kvh, d, True),  # decoder self
                (FAMILY_BATCH, WHISPER_TEXT, f, h, kvh, d, False),  # cross, prefill
                (ENGINE_BATCH, 1, f, h, kvh, d, False)]  # cross, one decode step
    return [(FAMILY_BATCH, FAMILY_LEN, FAMILY_LEN, h, kvh, d, True)]


def family_flash_case(gen: torch.Generator, shape: tuple) -> dict:
    """The kernel against its plain version at one of phase 10's shapes
    (bf16), then timed in turns with SDPA."""
    b, sq, sk, h, kvh, d, causal = shape
    q = torch.randn((b, sq, h, d), generator=gen, device=DEVICE).bfloat16()
    k = torch.randn((b, sk, kvh, d), generator=gen, device=DEVICE).bfloat16()
    v = torch.randn((b, sk, kvh, d), generator=gen, device=DEVICE).bfloat16()
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    e = flash_errors(got, q, k, v, causal)
    check_flash(e, FLASH_ATOL[torch.bfloat16], f"phase 10 at {shape}")
    timing = flash_timing(q, k, v, causal)
    return {**e, **{key: timing[key] for key in (
        "shape", "causal", "ms", "ms_spread", "tflops", "bound_ms", "bound_by", "bound_share",
        "library_ms", "kernel_over_library")}}


def family_inputs(gen: torch.Generator, cfg, batch: int, positions: int) -> dict:
    """A prefill batch of ``positions`` positions: token ids, and the
    family's stub inputs drawn from the seed (vlm: ``vision_tokens`` patch
    embeddings ahead of the text; audio: ``encoder_seq`` frames, and
    ``WHISPER_TEXT`` tokens)."""
    dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32

    def embeds(n):
        return (torch.randn((batch, n, cfg.d_model), generator=gen, device=DEVICE)
                * STUB_EMBED_STD).to(dtype)

    text = positions
    out = {}
    if cfg.family == "vlm":
        out["vis_embeds"] = embeds(cfg.vision_tokens)
        text = positions - cfg.vision_tokens
    if cfg.family == "audio":
        out["frames"] = embeds(cfg.encoder_seq)
        text = min(positions, WHISPER_TEXT)
    out["tokens"] = torch.randint(0, cfg.vocab, (batch, text), generator=gen, device=DEVICE)
    return out


def phase_family(gen: torch.Generator, cfg) -> dict:
    """10a-e: one family at full width: its new attention shapes through the
    flash kernel against the plain version; the prefill through the kernel,
    held against the chunked plain path; ``ServeEngine`` at batch 8, its
    logits at the last prompt position held against the full forward's.
    Returns the results and the flash launches of the main path (the
    prefill, the plain-path comparison excluded, and the engine)."""
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = backbone.init_model(cfg, generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t}
    out["flash_cases"] = [family_flash_case(gen, shape) for shape in family_flash_shapes(cfg)]

    batch = family_inputs(gen, cfg, FAMILY_BATCH, FAMILY_LEN)
    step = make_prefill_step(cfg, device=DEVICE)
    flash_attention.launches = 0  # the main path's launches from here
    with obs.tracing("prefill") as tr:
        logits = step(model, batch)
        torch.cuda.synchronize()
    per_forward = flash_attention.launches
    check(per_forward == flash_per_forward(cfg),
          f"{cfg.name}: prefill launched the flash kernel {per_forward} times, not "
          f"{flash_per_forward(cfg)}")
    check(logits.shape == (FAMILY_BATCH, cfg.padded_vocab), f"{cfg.name}: prefill logits "
          f"{tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), f"{cfg.name}: prefill logits not finite")
    out["prefill"] = {"batch": FAMILY_BATCH,
                      **{key: list(val.shape) for key, val in batch.items()},
                      "flash_launches_per_forward": per_forward,
                      **time_in_turns({"prefill": lambda: step(model, batch)},
                                      FAMILY_TIMED, 1)["prefill"]}
    if cfg.moe:  # the combine's bf16 index_add_ is order-dependent: rerun and compare
        again = step(model, batch)
        out["prefill"]["rerun_bit_equal"] = bool(torch.equal(again, logits))
        out["prefill"]["rerun_max_abs_diff"] = float((again.float() - logits.float()).abs().max())
        del again
        out["prefill"]["moe_pairs"] = {
            "routed": tr.counter_value("moe.pairs.routed"),
            "dropped": tr.counter_value("moe.pairs.dropped"),
            "capacity": mlp.capacity(cfg.moe, FAMILY_BATCH * batch["tokens"].shape[1],
                                     cfg.moe.top_k)}
    launches = flash_attention.launches
    if per_forward:  # the same forward through the chunked plain path
        t = time.perf_counter()
        plain = make_prefill_step(cfg, device=DEVICE, use_flash=False)(model, batch)
        torch.cuda.synchronize()
        diff = float((logits.float() - plain.float()).abs().max())
        scale = float(plain.float().abs().max())
        check(diff <= PREFILL_RTOL * scale, f"{cfg.name}: prefill logits differ from the "
              f"plain path by {diff} (max |logit| {scale})")
        out["prefill"].update({"plain_path_ms": (time.perf_counter() - t) * 1e3,
                               "max_abs_diff": diff, "max_abs_logit": scale,
                               "top1_agreement": float(
                                   (logits.argmax(-1) == plain.argmax(-1)).float().mean())})
        del plain
    del logits, batch
    flash_attention.launches = launches

    prompts = torch.randint(0, cfg.vocab, (ENGINE_BATCH, ENGINE_PROMPT), generator=gen,
                            device=DEVICE)
    eng = ServeEngine(cfg, model, batch=ENGINE_BATCH, kv_len=ENGINE_PROMPT + ENGINE_NEW + 8,
                      device=DEVICE)
    full_batch = {"tokens": prompts}
    if cfg.family == "audio":  # the caller sets the encoder's output, as the reference
        full_batch["frames"] = family_inputs(gen, cfg, ENGINE_BATCH, 1)["frames"]
        with torch.no_grad():
            eng.state["enc"] = backbone._run_encoder(model, cfg, full_batch["frames"])
    before = flash_attention.launches
    with obs.tracing("serve") as tr:
        t = time.perf_counter()
        last = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        t = time.perf_counter()
        toks = eng.generate(ENGINE_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
    check(bool(torch.isfinite(last).all()), f"{cfg.name}: engine logits not finite")
    check(toks.shape == (ENGINE_BATCH, ENGINE_NEW) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.padded_vocab, f"{cfg.name}: engine tokens")
    check(eng.position == ENGINE_PROMPT + ENGINE_NEW, f"{cfg.name}: position {eng.position}")
    steps = ENGINE_PROMPT + ENGINE_NEW
    per_step = (flash_attention.launches - before) / steps
    want_step = cfg.n_layers if cfg.family == "audio" else 0  # the cross-attention
    check(per_step == want_step, f"{cfg.name}: {per_step} flash launches per decode step, "
          f"not {want_step}")
    out["engine"] = {"batch": ENGINE_BATCH, "prompt": ENGINE_PROMPT, "new": ENGINE_NEW,
                     "prefill_ms_per_step": prefill_s * 1e3 / ENGINE_PROMPT,
                     "decode_ms_per_step": gen_s * 1e3 / ENGINE_NEW,
                     "flash_launches_per_step": per_step}
    if cfg.moe:
        dropped = tr.counter_value("moe.pairs.dropped")
        check(dropped == 0, f"{cfg.name}: decode at batch {ENGINE_BATCH} dropped {dropped} pairs")
        out["engine"]["moe_pairs"] = {"routed": tr.counter_value("moe.pairs.routed"),
                                      "dropped": dropped}
    launches = flash_attention.launches
    fwd_cfg = cfg
    if cfg.moe:
        fwd_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=(
            cfg.moe.num_experts / cfg.moe.top_k)))
    full = make_prefill_step(fwd_cfg, device=DEVICE)(model, full_batch)
    diff = float((last - full.float()).abs().max())
    scale = float(full.float().abs().max())
    rtol = ENGINE_RTOL.get(cfg.family, ENGINE_RTOL_DEFAULT)
    check(diff <= rtol * scale, f"{cfg.name}: the engine's last prompt logits differ "
          f"from the forward's by {diff} (max |logit| {scale}, allowed {rtol} of it)")
    out["engine"].update({"vs_forward_max_abs_diff": diff, "max_abs_logit": scale,
                          "vs_forward_rtol": rtol,
                          "vs_forward_top1": float((last.argmax(-1) == full.argmax(-1))
                                                   .float().mean())})
    flash_attention.launches = launches
    tok = toks[:, -1:]  # the decode step alone at the next position (a spare cache slot)
    out["engine"]["decode_profile"] = profile_device(
        lambda: eng._step(model, eng.state, tok, eng.position), steps=4)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    del model, eng, full, last, toks, full_batch
    torch.cuda.empty_cache()
    return out, launches


def family_train_seq(cfg) -> int:
    """The stream's text length for 2048 positions (the vlm's patch
    embeddings come first; whisper's text context is 448)."""
    if cfg.family == "vlm":
        return FAMILY_TRAIN_POSITIONS - cfg.vision_tokens
    if cfg.family == "audio":
        return WHISPER_TEXT
    return FAMILY_TRAIN_POSITIONS


def phase_family_train(gen: torch.Generator, cfg) -> tuple[dict, dict, int]:
    """11a-f: ``init_train_state`` and ``make_train_step`` for one family at
    its published width in bf16, AdamW state in the config's
    ``opt_state_dtype``, ``remat`` full, KV chunks of 512, one microbatch,
    phase 9's WSD at peak ``TRAIN_LR`` entered past its warm-up (every step
    updates), on one repeated batch of the stream: a warm-up step with a hook
    on every parameter's gradient (under ``obs.tracing`` for the MoE's pair
    counters), ``FAMILY_TRAIN_TIMED`` timed steps and one under
    ``torch.profiler``.  Returns the results, the model's training state
    (for 11g, whisper's only: the caller frees it) and the flash launches."""
    warm = 2
    steps = warm + 2 + FAMILY_TRAIN_TIMED
    tcfg = TrainConfig(optimizer=AdamWConfig(state_dtype=cfg.opt_state_dtype),
                       schedule=ScheduleConfig(kind="wsd", peak_lr=TRAIN_LR, warmup_steps=warm,
                                               total_steps=steps),
                       attn_chunk=TRAIN_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, opt = init_train_state(gen, cfg, tcfg, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = sum(p.numel() * (2 * p.element_size() + 2 * opt["m"][n].element_size())
                      for n, p in model.named_parameters())
    seq = family_train_seq(cfg)
    data = SyntheticStream(cfg, DataConfig(seed=SEED, batch=FAMILY_TRAIN_BATCH, seq=seq),
                           device=DEVICE).batch_at(0)
    positions = FAMILY_TRAIN_BATCH * (seq + (cfg.vision_tokens if cfg.family == "vlm" else 0))
    step_fn = make_train_step(cfg, tcfg)
    named = dict(model.named_parameters())
    unused = [n for n in named if cfg.moe and cfg.mlp_act != "swiglu" and n.endswith("moe.gate")]
    before_unused = {n: named[n].detach().clone() for n in unused}
    flash_attention.launches = 0  # this phase's launches: there must be none
    norms: dict[str, torch.Tensor] = {}
    hooks = [p.register_hook(lambda g, name=name: norms.__setitem__(
        name, torch.linalg.vector_norm(g.float()))) for name, p in named.items()]
    try:
        with obs.tracing(cfg.name) as tr:
            rows = [timed_step(step_fn, model, opt, data, warm)]
    finally:
        for h in hooks:
            h.remove()
    check(set(norms) == set(named) - set(unused),
          f"{cfg.name}: gradients of {sorted(set(named) - set(unused) - set(norms))[:5]} "
          f"missing, or of an unused parameter present")
    bad = [n for n, v in norms.items() if not bool(torch.isfinite(v)) or float(v) == 0.0]
    check(not bad, f"{cfg.name}: first-step gradients not finite or zero for {bad[:5]}")
    wd = tcfg.optimizer.weight_decay
    for n in unused:  # a zero gradient: AdamW's decay alone, in f32, rounded to bf16
        was = before_unused.pop(n)
        decayed = (was.float() - learning_rate(warm, tcfg.schedule) * (wd * was.float())
                   ).to(was.dtype)
        check(float(opt["m"][n].abs().max()) == 0.0 and float(opt["v"][n].abs().max()) == 0.0,
              f"{cfg.name}: {n}'s gradient was not zero")
        check(torch.equal(named[n].detach(), decayed), f"{cfg.name}: {n} is not its decayed self")
    del before_unused
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers, "params": n_params,
           "state_bytes_reckoned": state_bytes, "opt_state_dtype": cfg.opt_state_dtype,
           "remat": cfg.remat, "attn_chunk": TRAIN_CHUNK, "microbatches": 1,
           "batch": FAMILY_TRAIN_BATCH, "positions": positions,
           **{key: list(val.shape) for key, val in data.items()}, "init_s": init_s,
           "unused_zero_grad": unused, "grad_norm_least": min(
               ([n, float(v)] for n, v in norms.items()), key=lambda kv: kv[1])}
    del norms
    if cfg.moe:  # counted at every forward of the MoE, remat's recompute included
        out["moe_pairs"] = {"routed": tr.counter_value("moe.pairs.routed"),
                            "dropped": tr.counter_value("moe.pairs.dropped")}
        check(out["moe_pairs"]["routed"] > 0, f"{cfg.name}: no MoE pair routed")
    for i in range(FAMILY_TRAIN_TIMED):
        rows.append(timed_step(step_fn, model, opt, data, warm + 1 + i))
    prof = profile_device(lambda: rows.append(timed_step(step_fn, model, opt, data, steps - 1)),
                          steps=1, warmup=False, top=8)
    losses = [r["loss"] for r in rows]
    check(all(math.isfinite(x) for x in losses), f"{cfg.name}: losses {losses}")
    check(losses[2] < losses[0], f"{cfg.name}: the loss did not fall over two updates: {losses}")
    flash = flash_attention.launches
    check(flash == 0, f"{cfg.name}: the train step launched the flash kernel {flash} times")
    timed = rows[1:1 + FAMILY_TRAIN_TIMED]
    host_ms = float(np.median([r["host_ms"] for r in timed]))
    out.update({"steps": rows, "step_host_ms_median": host_ms,
                "step_cuda_ms_median": float(np.median([r["cuda_ms"] for r in timed])),
                "positions_per_s": positions / host_ms * 1e3,
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "max_memory_reserved": torch.cuda.max_memory_reserved(),
                "profile": prof})
    state = train_state(model, opt) if cfg.family == "audio" else None
    del model, opt, step_fn, data, named
    torch.cuda.empty_cache()
    return out, state, flash


def phase_state_checkpoint(state: dict) -> dict:
    """11g: a trained state (whisper-small's parameters and f32 moments)
    encoded as a DRC(9,6,3) checkpoint on the card, node 0 lost and restored
    through the layered repair: every leaf byte-equal."""
    gf_matmul_batched.launches = 0
    with obs.tracing("11g") as tr:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ckpt = encode_state(state, family="DRC", n=9, k=6, r=3, device=DEVICE)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t
        gf_encode = sum(sp.dur_us for sp in tr.spans_named("kernel.gf_matmul")) / 1e3
        t = time.perf_counter()
        got, report = restore_state(ckpt, state, available=set(range(1, 9)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        gf_restore = sum(sp.dur_us for sp in tr.spans_named("kernel.gf_matmul")) / 1e3 - gf_encode
        calls = {path: tr.counter_value("kernel.gf_matmul.calls", path=path)
                 for path in ("cuda", "ref")}
    launches = gf_matmul_batched.launches
    plan_cross = make_code("DRC", 9, 6, 3).repair_plan(0).traffic_blocks()["cross_rack_blocks"]
    check(report.mode == "repair" and report.cross_rack_blocks == plan_cross,
          f"11g: restore {report}, the plan's cross-rack blocks {plan_cross}")
    want, got_leaves = checkpoint.tensors(state), checkpoint.tensors(got)
    check(len(want) == len(got_leaves) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
        for a, b in zip(want, got_leaves)), "11g: a restored leaf is not byte-equal")
    check(calls["cuda"] > 0 and calls["ref"] == 0, f"11g: GF products by path {calls}")
    check(launches > 0, "11g: the GF kernel was launched no time")
    out = {"leaves": len(want), "state_bytes": ckpt.total_bytes,
           "stripe_bytes": sum(p.numel() for p in ckpt.payloads.values()),
           "mode": report.mode, "cross_rack_blocks": report.cross_rack_blocks,
           "plan_cross_rack_blocks": plan_cross, "gf_launches": launches, "gf_calls": calls,
           "encode_host_s": encode_s, "encode_gf_device_ms": gf_encode,
           "restore_host_s": restore_s, "restore_gf_device_ms": gf_restore}
    del ckpt, got
    return out


def sharded_cases() -> list[tuple[str, str, model_run.Case]]:
    """13's runs: (label, ``parity`` or ``config``, case), in order; the
    runs of one model follow each other, so the ranks build it once."""
    out = []
    for label, arch, layers, mode, sharding in SHARDED:
        base = dict(arch=arch, mode=mode, mesh=SHARDED_MESH, layers=layers,
                    moe_sharding=sharding, seed=SEED)
        moe = get_config(arch).moe
        if moe is None:
            b, s = SHARDED_DENSE
            out.append((label, "parity", model_run.Case(**base, batch=b, seq=s)))
            continue
        b, s = SHARDED_MOE_PARITY
        out.append((label, "parity", model_run.Case(
            **base, batch=b, seq=s, capacity_factor=moe.num_experts / moe.top_k)))
        b, s = SHARDED_MOE
        out.append((label, "config", model_run.Case(**base, batch=b, seq=s)))
    return out


def phase_sharded() -> tuple[dict, int]:
    """13: the sharded prefill, ``make_prefill_step(cfg, mesh=, rules=)``,
    through ``dist.model_run`` on 8 gloo ranks sharing this card.  Each
    parity run's rank 0 logits are held to one process's on the same seeded
    weights (``make_prefill_step`` without a mesh, here, before the ranks
    start: its flash launches are a yardstick and are not counted), within 5%
    of the largest logit, as 6b; every rank's first flash call's local shards
    are held to the plain version at bf16's 3e-2; the MoE's own
    ``all_to_all`` are 2 a layer for dbrx (EP) and none for grok (TP); the
    pairs dropped are none at the drop-free capacity and counted at the
    config's.  Returns the results and the flash launches, summed over the
    ranks."""
    cases = sharded_cases()
    refs = {}
    before = flash_attention.launches
    for label, kind, case in cases:
        if kind != "parity":
            continue
        model = model_run.seeded_model(case, DEVICE)
        step = make_prefill_step(model_run.case_config(case), device=DEVICE)
        with obs.tracing("13 reference") as tr:
            refs[label] = step(model, {"tokens": torch.from_numpy(model_run.case_tokens(case))})
            refs[label] = refs[label].float().cpu()
        check(tr.counter_value("moe.pairs.dropped") == 0, f"{label}: one process dropped pairs")
        del model, step
        torch.cuda.empty_cache()
    flash_attention.launches = before
    with tempfile.TemporaryDirectory() as d:
        rows = model_run.run([case for _, _, case in cases], workdir=d, device=DEVICE)
    out, launches = {}, 0
    for (label, kind, case), row in zip(cases, rows):
        cfg = model_run.case_config(case)
        got = torch.from_numpy(row["logits"])
        check(bool(torch.isfinite(got).all()), f"{label} {kind}: non-finite logits")
        check(tuple(got.shape) == (case.batch, cfg.padded_vocab),
              f"{label} {kind}: logits of shape {tuple(got.shape)}")
        ranks = row["ranks"]
        res = {"arch": case.arch, "layers": cfg.n_layers, "rules": case.mode,
               "mesh": list(case.mesh), "tokens": [case.batch, case.seq],
               "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
               "gloo_host_staged_ms_slowest_rank": row["ms"],
               "ms_by_rank": [r["ms"] for r in ranks],
               "build_s_by_rank": [r["build_s"] for r in ranks],
               "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
               "peak_reserved_bytes_by_rank": [r["peak_reserved_bytes"] for r in ranks],
               "host_staged_bytes_by_rank": [r["host_staged_bytes"] for r in ranks],
               "collectives_rank0": ranks[0]["collectives"],
               "moe_collectives_rank0": ranks[0]["moe_collectives"],
               "flash_launches": row["flash_launches"],
               "flash_max_abs_err": max(r["flash_max_abs_err"] for r in ranks),
               "flash_shape_rank0": ranks[0]["flash_shape"]}
        check(all(r["flash_launches"] == cfg.n_layers for r in ranks),
              f"{label} {kind}: flash launches by rank {[r['flash_launches'] for r in ranks]}")
        check(res["flash_max_abs_err"] <= FLASH_ATOL[torch.bfloat16],
              f"{label} {kind}: the flash kernel on local shards is "
              f"{res['flash_max_abs_err']} from its plain version")
        launches += row["flash_launches"]
        if cfg.moe is not None:
            a2a = [r["moe_collectives"]["all_to_all"] for r in ranks]
            want = 2 * cfg.n_layers if case.moe_sharding != "ffn" else 0
            check(all(n == want for n in a2a), f"{label} {kind}: the MoE's all_to_all by rank "
                  f"{a2a}, want {want} each")
            res["pairs_routed_by_rank"] = [r["pairs_routed"] for r in ranks]
            res["pairs_dropped_by_rank"] = [r["pairs_dropped"] for r in ranks]
        if kind == "parity":
            ref = refs[label]
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            res.update(max_abs_err_vs_one_process=err, largest_logit=scale)
            check(err <= PREFILL_RTOL * scale, f"{label}: rank 0's logits are {err} from one "
                  f"process's (largest logit {scale})")
            if cfg.moe is not None:
                check(sum(res["pairs_dropped_by_rank"]) == 0, f"{label}: drop-free run dropped")
        out[f"{label} {kind}"] = res
    return out, launches


def mesh_cases() -> list[tuple[str, str, model_run.Case]]:
    """14's runs: (label, ``parity`` or ``config``, case), in order."""
    out = []
    for label, arch, layers, (b, s), mode in MESH_TRAIN:
        base = dict(arch=arch, kind="train", mode=mode, mesh=SHARDED_MESH, layers=layers,
                    remat="full", seed=SEED)
        moe = get_config(arch).moe
        if moe is None:
            out.append((label, "parity", model_run.Case(
                **base, batch=b, seq=s, steps=MESH_TRAIN_STEPS)))
            continue
        pb, ps = MESH_TRAIN_MOE_PARITY
        out.append((label, "parity", model_run.Case(
            **base, batch=pb, seq=ps, steps=1, capacity_factor=moe.num_experts / moe.top_k)))
        out.append((label, "config", model_run.Case(**base, batch=b, seq=s,
                                                    steps=MESH_TRAIN_STEPS)))
    for label, arch, layers in MESH_DECODE:
        base = dict(arch=arch, kind="decode", mode="tp", mesh=SHARDED_MESH, layers=layers,
                    seed=SEED, batch=MESH_DECODE_BATCH, seq=MESH_DECODE_PROMPT,
                    new=MESH_DECODE_NEW, kv_len=MESH_DECODE_KV)
        moe = get_config(arch).moe
        if moe is None:
            out.append((label, "parity", model_run.Case(**base)))
            continue
        out.append((label, "parity", model_run.Case(**base, top_k=moe.num_experts)))
        out.append((label, "config", model_run.Case(**base)))
    return out


def family_mesh_cases() -> list[tuple[str, str, model_run.Case]]:
    """15's runs: (label, ``parity``, case); each family's prefill and decode
    under ``tp`` follow each other, so the ranks build its model once for
    both, then its train run builds its own."""
    out = []
    for (pre, train, dec), arch, layers in FAMILY_MESH:
        cfg = get_config(arch)
        base = dict(arch=arch, mesh=SHARDED_MESH, seed=SEED, layers=layers)
        text = WHISPER_TEXT if cfg.family == "audio" else None
        b, s = FAMILY_MESH_PREFILL
        out.append((pre, "parity", model_run.Case(**base, mode="tp", batch=b, seq=text or s)))
        out.append((dec, "parity", model_run.Case(
            **base, kind="decode", mode="tp", batch=MESH_DECODE_BATCH, seq=MESH_DECODE_PROMPT,
            new=MESH_DECODE_NEW, kv_len=MESH_DECODE_KV)))
        b, s = FAMILY_MESH_TRAIN
        out.append((train, "parity", model_run.Case(
            **base, kind="train", mode="fsdp", batch=b, seq=text or s, remat="full",
            steps=MESH_TRAIN_STEPS)))
    return out


def mesh_reference(case: model_run.Case) -> dict:
    """One process's run of a phase-14 or -15 case on the same seeded
    weights: a prefill's logits at the last position, a train case's first
    step (its loss, norm and the pairs it dropped), or a decode case's
    engine (the logits at the last prompt position and the greedy tokens;
    the audio family's frames through its encoder first).  Everything it
    allocated is freed."""
    cfg = model_run.case_config(case)
    model = model_run.seeded_model(case, DEVICE)
    with obs.tracing("mesh reference") as tr:
        if case.kind == "prefill":
            inputs = {k: torch.from_numpy(v) for k, v in model_run.case_inputs(case).items()}
            out = {"logits": make_prefill_step(cfg, device=DEVICE)(model, inputs).float().cpu()}
        elif case.kind == "train":
            tcfg = model_run.train_config(case)
            model.requires_grad_(True)
            opt = init_opt_state(model, tcfg.optimizer)
            batch = {k: torch.from_numpy(v).to(DEVICE)
                     for k, v in model_run.case_batch(case).items()}
            metrics = make_train_step(cfg, tcfg)(model, opt, batch, model_run.TRAIN_WARMUP)[2]
            out = {key: float(metrics[key]) for key in ("loss", "grad_norm", "moe_aux")}
            del opt, batch, metrics
        else:
            engine = ServeEngine(cfg, model, batch=case.batch, kv_len=case.kv_len, device=DEVICE)
            inputs = model_run.case_inputs(case)
            if "frames" in inputs:
                engine.encode(torch.from_numpy(inputs["frames"]))
            logits = engine.prefill(torch.from_numpy(inputs["tokens"]))
            out = {"logits": logits.float().cpu(), "tokens": engine.generate(case.new).cpu()}
            del engine, logits
    out["pairs_dropped"] = int(tr.counter_value("moe.pairs.dropped"))
    del model
    torch.cuda.empty_cache()
    return out


def _mesh_row(ranks: list[dict]) -> dict:
    """What 14 prints of one timed run on every rank."""
    return {"gloo_host_staged_ms_slowest_rank": max(r["ms"] for r in ranks),
            "collective_bytes_by_axis_rank0": ranks[0]["collective_bytes_by_axis"],
            "ms_by_rank": [r["ms"] for r in ranks],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
            "peak_reserved_bytes_by_rank": [r["peak_reserved_bytes"] for r in ranks],
            "host_staged_bytes_by_rank": [r["host_staged_bytes"] for r in ranks],
            "collectives_forward_rank0": ranks[0]["collectives"],
            "collectives_backward_rank0": ranks[0]["backward_collectives"],
            "mesh_collectives_by_phase_rank0": ranks[0]["moe_collectives_by_phase"],
            "pairs_routed_by_rank": [r["pairs_routed"] for r in ranks],
            "pairs_dropped_by_rank": [r["pairs_dropped"] for r in ranks]}


def phase_mesh_runs(smi: str, phase: str, cases: list) -> tuple[dict, int]:
    """14 and 15: ``make_prefill_step(cfg, mesh=, rules=)``,
    ``make_train_step(cfg, tcfg, mesh=, rules=)`` and ``ServeEngine(...,
    mesh=, rules=)`` through ``dist.model_run`` on 8 gloo ranks sharing this
    card, ``cases`` (label, role, case) in one spawn.  A prefill's rank 0
    logits are held within ``PREFILL_RTOL`` of the largest of one
    process's, every rank's first flash call's local shards to the plain
    version, and its flash launches to ``flash_per_forward`` a rank.  Each run's reference is one process's on the same seeded weights
    and inputs, run here before the ranks start: rank 0's first train step's
    loss within ``MESH_LOSS_RTOL`` and its gradient norm within
    ``MESH_NORM_RTOL`` of one process's (the MoE at a drop-free capacity,
    where neither drops a pair), the dense model's loss lower after its
    first update; the decode's logits at the last prompt position within
    ``PREFILL_RTOL`` of the largest (the MoE routing every token to every
    expert), and the share of greedy tokens equal to one process's printed; the MoE's own ``all_to_all`` 2 a layer in each
    forward, and in a train step's backward its reverse pair and the
    rematerialised forward's.  Each run's line is printed before it is
    checked.  Returns the results and the flash launches, summed over the
    ranks (none in training, which takes the chunked attention, and in
    decode only the audio decoder's cross-attention's, one a layer a
    step)."""
    refs = {}
    before = flash_attention.launches
    for label, role, case in cases:
        if role == "parity" or case.kind == "decode":
            t = time.perf_counter()
            refs[f"{label} {role}"] = {**mesh_reference(case), "host_s": time.perf_counter() - t}
    flash_attention.launches = before  # the references' launches are yardsticks
    parent_bytes = torch.cuda.memory_allocated()
    parent_reserved = torch.cuda.memory_reserved()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        rows = model_run.run([case for _, _, case in cases], workdir=d, device=DEVICE)
    out = {f"{phase} ranks": {"spawn_host_s": time.perf_counter() - t,
                              "parent_allocated_bytes": parent_bytes,
                              "parent_reserved_bytes": parent_reserved}}
    print(f"[{phase} ranks] {json.dumps(out[f'{phase} ranks'])}")
    launches = 0
    for (label, role, case), row in zip(cases, rows):
        cfg = model_run.case_config(case)
        ranks = row["ranks"]
        launches += row["flash_launches"]
        res = {"arch": case.arch, "kind": case.kind, "layers": cfg.n_layers,
               "rules": case.mode, "mesh": list(case.mesh), "tokens": [case.batch, case.seq],
               "capacity_factor": cfg.moe.capacity_factor if cfg.moe else None,
               "top_k": cfg.moe.top_k if cfg.moe else None,
               "build_s_by_rank": [r["build_s"] for r in ranks],
               "flash_launches": row["flash_launches"]}
        ref = refs.get(f"{label} {role}")
        if ref is not None:
            res["one_process_host_s"] = ref["host_s"]
        if case.kind == "prefill":
            got = torch.from_numpy(row["logits"])
            res.update(max_abs_err_vs_one_process=float((got - ref["logits"]).abs().max())
                       if got.shape == ref["logits"].shape else None,
                       largest_logit=float(ref["logits"].abs().max()),
                       flash_max_abs_err=max((r["flash_max_abs_err"] or 0.0) for r in ranks),
                       flash_launches_by_rank=[r["flash_launches"] for r in ranks],
                       **_mesh_row(ranks))
        elif case.kind == "train":
            res["steps"] = [{"step": at[0]["step"], "loss": at[0]["loss"],
                             "grad_norm": at[0]["grad_norm"], "moe_aux": at[0]["moe_aux"],
                             "loss_by_rank": [r["loss"] for r in at], **_mesh_row(at)}
                            for at in ([r["steps"][n] for r in ranks] for n in range(case.steps))]
            res["loss_change"] = res["steps"][-1]["loss"] - res["steps"][0]["loss"]
            if case.checkpoint:
                res["checkpoint_by_rank"] = [r["checkpoint"] for r in ranks]
            if ref is not None:
                res.update(loss_one_process=ref["loss"], grad_norm_one_process=ref["grad_norm"],
                           moe_aux_one_process=ref["moe_aux"],
                           pairs_dropped_one_process=ref["pairs_dropped"])
        else:
            got = torch.from_numpy(row["logits"])
            tokens = torch.from_numpy(row["tokens"])
            shape_ok = tuple(got.shape) == tuple(ref["logits"].shape)
            err_rows = (got - ref["logits"]).abs().amax(dim=-1) if shape_ok else None
            res.update(max_abs_err_vs_one_process=float(err_rows.max()) if shape_ok else None,
                       max_abs_err_by_row=err_rows.tolist() if shape_ok else None,
                       largest_logit=float(ref["logits"].abs().max()),
                       greedy_equal_share=float((tokens == ref["tokens"]).float().mean()),
                       prefill=_mesh_row([r["prefill"] for r in ranks]),
                       generate=_mesh_row(ranks),
                       generate_ms_per_token_slowest_rank=row["ms"] / case.new)
        print(f"[{label} {role}] {smi}, 8 gloo ranks on one card, host-staged gloo times, not "
              f"a network or NCCL figure: {json.dumps(res)}")
        out[f"{label} {role}"] = res
        if case.kind == "prefill":
            check_mesh_prefill(label, cfg, res, got)
        else:
            want = 0
            if case.kind == "decode" and cfg.family == "audio":  # the encoder, then the
                steps = case.seq + case.new                      # cross-attention a step
                want = math.prod(case.mesh) * (cfg.encoder_layers
                                                            + cfg.n_layers * steps)
            check(row["flash_launches"] == want, f"{label} {role}: {row['flash_launches']} "
                  f"flash launches over the ranks, want {want}")
        if case.kind == "train":
            check_mesh_train(label, role, cfg, res, ref)
        elif case.kind == "decode":
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
            check(tuple(got.shape) == (case.batch, cfg.padded_vocab),
                  f"{label}: logits of shape {tuple(got.shape)}")
            if role == "parity":
                rtol = ENGINE_RTOL.get(cfg.family, ENGINE_RTOL_DEFAULT)
                check(res["max_abs_err_vs_one_process"] <= rtol * res["largest_logit"],
                      f"{label}: rank 0's logits are {res['max_abs_err_vs_one_process']} from "
                      f"one process's (largest logit {res['largest_logit']})")
            if cfg.moe is not None:
                a2a = [r["moe_collectives"]["all_to_all"] for r in ranks]
                check(all(x == 2 * cfg.n_layers * case.new for x in a2a),
                      f"{label}: the MoE's all_to_all by rank {a2a} over {case.new} steps")
    return out, launches


def check_mesh_prefill(label: str, cfg, res: dict, got: torch.Tensor) -> None:
    """15a–d's checks of one prefill's printed result (see phase_mesh_runs)."""
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite logits")
    check(res["max_abs_err_vs_one_process"] is not None and
          res["max_abs_err_vs_one_process"] <= PREFILL_RTOL * res["largest_logit"],
          f"{label}: rank 0's logits are {res['max_abs_err_vs_one_process']} from one "
          f"process's (largest logit {res['largest_logit']})")
    want = flash_per_forward(cfg)
    check(all(n == want for n in res["flash_launches_by_rank"]),
          f"{label}: flash launches by rank {res['flash_launches_by_rank']}, want {want} each")
    check(res["flash_max_abs_err"] <= FLASH_ATOL[torch.bfloat16],
          f"{label}: the flash kernel on local shards is {res['flash_max_abs_err']} from its "
          f"plain version")


def check_mesh_train(label: str, role: str, cfg, res: dict, ref: dict | None) -> None:
    """14a–b, 14e and 15e–h's checks of one run's printed result (see
    phase_mesh_runs)."""
    for step in res["steps"]:
        losses = step["loss_by_rank"]
        check(all(math.isfinite(x) for x in losses), f"{label} {role}: losses {losses}")
        check(max(losses) - min(losses) <= 1e-6 * abs(losses[0]),
              f"{label} {role}: the ranks' losses differ: {losses}")
        if cfg.moe is not None:
            by_phase = step["mesh_collectives_by_phase_rank0"]
            remat = 2 if cfg.remat != "none" else 1
            check(by_phase["forward"]["all_to_all"] == 2 * cfg.n_layers and
                  by_phase["backward"]["all_to_all"] == 2 * cfg.n_layers * remat,
                  f"{label} {role}: the MoE's all_to_all by phase {by_phase}")
    first = res["steps"][0]
    if ref is not None:
        check(abs(first["loss"] - ref["loss"]) <= MESH_LOSS_RTOL * abs(ref["loss"]),
              f"{label}: rank 0's loss {first['loss']} against one process's {ref['loss']}")
        check(abs(first["grad_norm"] - ref["grad_norm"]) <= MESH_NORM_RTOL * ref["grad_norm"],
              f"{label}: rank 0's gradient norm {first['grad_norm']} against one process's "
              f"{ref['grad_norm']}")
        if cfg.moe is not None:
            check(ref["pairs_dropped"] == 0 and sum(first["pairs_dropped_by_rank"]) == 0,
                  f"{label}: a drop-free run dropped pairs")
    if cfg.moe is None:
        check(res["loss_change"] < 0, f"{label}: the loss did not fall: {res['steps']}")


def pod_cases() -> list[tuple[str, str, model_run.Case]]:
    """16a's prefill and train runs and 16b's checkpointed train run."""
    base = dict(arch=POD_ARCH, mesh=POD_MESH, seed=SEED)
    b, s = POD_PREFILL
    out = [("16a", "parity", model_run.Case(**base, mode="tp", layers=POD_LAYERS, batch=b,
                                            seq=s))]
    b, s = POD_TRAIN
    train = dict(base, kind="train", mode="fsdp", batch=b, seq=s, remat="full",
                 steps=MESH_TRAIN_STEPS)
    out.append(("16a-train", "parity", model_run.Case(**train, layers=POD_LAYERS)))
    out.append(("16b", "config", model_run.Case(**train, layers=POD_CKPT_LAYERS,
                                                 checkpoint=True)))
    return out


def phase_pod(smi: str) -> tuple[dict, int, int]:
    """16a and 16b: ``phase_mesh_runs`` of ``pod_cases`` (its checks at
    phase 14's tolerances), then 16a held tighter (rank 0's logits within
    ``POD_LOGIT_RTOL`` of the largest of one process's, the first step's
    loss within ``POD_LOSS_RTOL`` and norm within ``POD_NORM_RTOL``, flash
    launches on every rank, bytes moved over the pod axis's group), and
    16b: every rank's restored blocks bit-equal to its saved ones, the same
    report on every rank (node 2 repaired), the payloads' CRCs equal to a
    one-process encode of the gathered state, the resumed step's loss equal
    to the uninterrupted step's, GF launches.  Returns the results, the
    flash launches over the ranks and the GF launches."""
    out, flash = phase_mesh_runs(smi, "16", pod_cases())
    pre, tr = out["16a parity"], out["16a-train parity"]
    check(pre["max_abs_err_vs_one_process"] <= POD_LOGIT_RTOL * pre["largest_logit"],
          f"16a: rank 0's logits are {pre['max_abs_err_vs_one_process']} from one process's "
          f"(largest {pre['largest_logit']})")
    check(all(n > 0 for n in pre["flash_launches_by_rank"]),
          f"16a: flash launches by rank {pre['flash_launches_by_rank']}")
    first = tr["steps"][0]
    check(abs(first["loss"] - tr["loss_one_process"]) <= POD_LOSS_RTOL * tr["loss_one_process"],
          f"16a: loss {first['loss']} against one process's {tr['loss_one_process']}")
    check(abs(first["grad_norm"] - tr["grad_norm_one_process"])
          <= POD_NORM_RTOL * tr["grad_norm_one_process"],
          f"16a: norm {first['grad_norm']} against one process's {tr['grad_norm_one_process']}")
    pod_bytes = first["collective_bytes_by_axis_rank0"].get("pod", 0)
    check(pod_bytes > 0, f"16a: no bytes over the pod axis: {first}")
    ck = out["16b config"]["checkpoint_by_rank"]
    root = ck[0]
    gf = sum(r["gf_launches"] for r in ck)
    check(all(r["restored_equal"] for r in ck), "16b: a rank's restored blocks differ")
    check(len({(r["mode"], tuple(r["repaired_nodes"]), r["cross_rack_blocks"]) for r in ck}) == 1
          and root["mode"] == "repair" and root["repaired_nodes"] == [2],
          f"16b: reports {[(r['mode'], r['repaired_nodes']) for r in ck]}")
    check(root["crcs"] == root["crcs_one_process"],
          "16b: the sharded save's CRCs differ from a one-process save's")
    check(all(r["resumed"]["loss"] == r["uninterrupted"]["loss"] for r in ck),
          f"16b: resumed {root['resumed']} against uninterrupted {root['uninterrupted']}")
    check(gf > 0, "16b: the checkpoint launched the GF kernel no time")
    summary = {"pod_bytes_rank0_train_step": pod_bytes,
               "save_s": root["save_s"], "load_s": root["load_s"], "gf_ms": root["gf_ms"],
               "gf_launches": gf, "mode": root["mode"],
               "cross_rack_blocks": root["cross_rack_blocks"],
               "resumed": root["resumed"], "uninterrupted": root["uninterrupted"]}
    print(f"[16b checkpoint] {smi}, 8 gloo ranks on one card, host clock: "
          f"{json.dumps(summary)}")
    out["16b summary"] = summary
    return out, flash, gf


def phase_dryrun(smi: str) -> dict:
    """16c: ``dryrun.run_cell`` of each ``DRYRUN_CELLS`` cell and the
    roofline probe of ``PROBE_CELL``, fake card tensors on a fake group in
    this process (nothing is allocated or launched), each cell in a group
    of its own that ``launch.mesh.fake_world`` makes and takes down.
    Checks: every cell ``ok``, the multi-pod peak no more than the
    single-pod one, the flash kernel's custom op counted in the prefill (its
    FLOP formula), the probe's useful FLOP share finite and positive
    (printed beside the reference's band), no process group left."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, roofline_probe

    out = {}
    for arch, shape, multi in DRYRUN_CELLS:
        t = time.perf_counter()
        res = dryrun.run_cell(arch, shape, multi_pod=multi, rules_mode="tp",
                              device=DEVICE, verbose=False)
        res["host_s"] = time.perf_counter() - t
        out[f"{shape} {res['mesh']}"] = res
        shown = {k: res.get(k) for k in ("arch", "shape", "mesh", "rules", "status",
                                          "n_devices", "memory", "roofline", "flops_by_op",
                                          "collectives", "host_s")}
        print(f"[16c dryrun] host {smi}, computed from the H100 data sheet's rates, not "
              f"measured: {json.dumps(shown)}")
        check(res["status"] == "ok", f"16c: {arch} {shape} {res['mesh']}: {res['status']}")
        check(res["flops_by_op"].get("repro_torch.flash_attention", 0) > 0,
              f"16c: the flash op was not counted: {res['flops_by_op']}")
    single, multi = (out[f"{DRYRUN_CELLS[0][1]} {m}"]["memory"]["per_device_total_gib"]
                     for m in ("single", "multi"))
    check(multi <= single, f"16c: multi-pod {multi} GiB against single-pod {single}")
    arch, shape, multi_pod = PROBE_CELL
    t = time.perf_counter()
    probe = roofline_probe.probe_cell(arch, shape, multi_pod=multi_pod, device=DEVICE)
    probe["host_s"] = time.perf_counter() - t
    ratio = probe["roofline"]["useful_flops_ratio"]
    lo, hi = REFERENCE_USEFUL_BAND
    probe["in_reference_band"] = lo <= ratio <= hi
    out["probe"] = probe
    print(f"[16c probe] host {smi}, computed from the H100 data sheet's rates, not "
          f"measured: {json.dumps(probe)}")
    check(math.isfinite(ratio) and ratio > 0, f"16c: useful FLOP share {ratio}")
    check(not dist.is_initialized(), "16c left a process group behind")
    return out


def phase_demos() -> tuple[dict, int]:
    """12: the paper's two repair demos through their ``main(argv)`` on the
    card: quickstart at its 64 KiB subblocks, and the layering walk-through
    with its trace written under a temporary directory, its summary's
    cross-rack bytes held to the plans'.  Returns the results and the GF
    launches."""
    gf_matmul_batched.launches = 0
    quick = quickstart.main(["--device", DEVICE])
    quick_launches = gf_matmul_batched.launches
    with tempfile.TemporaryDirectory() as d:
        layering = repair_layering.main(["--device", DEVICE,
                                         "--trace-out", os.path.join(d, "trace.json")])
        with open(layering["summary"]) as f:
            counters = json.load(f)["counters"]
    launches = gf_matmul_batched.launches
    want = sum(make_code(*spec).repair_plan(0).traffic_blocks()["cross_rack_blocks"]
               * make_code(*spec).alpha * repair_layering.SUB_BYTES
               for spec in repair_layering.TRACED_CODES)
    cross = sum(counters["repair.bytes.cross_rack"].values())
    check(abs(cross - want) < 0.5, f"12: traced cross-rack bytes {cross} != the plans' {want}")
    check(set(counters["kernel.gf_matmul.calls"]) == {"path=cuda"},
          f"12: GF products by path {counters['kernel.gf_matmul.calls']}")
    check(quick["restore_mode"] == "repair" and quick_launches > 0,
          f"12: quickstart restore {quick['restore_mode']}, {quick_launches} GF launches")
    check(launches > quick_launches, "12: the layering demo launched the GF kernel no time")
    return {"quickstart": {k: quick[k] for k in ("sub_bytes", "cross_rack", "restore_mode")},
            "quickstart_gf_launches": quick_launches,
            "layering_cross_rack_bytes": cross, "plans_cross_rack_bytes": want,
            "layering_codes": layering["codes"],
            "layering_gf_launches": launches - quick_launches}, launches


def phase_check(smi: str) -> dict:
    """17: the verification layer on the card.  (a) ``repro_torch.check``'s
    plan sweep, lowered sweep and lint of the port and this script, and both
    mutation self-tests, in this process: no FAIL, every mutation caught (the
    lowered ones by their owner alone), the record counts by family and
    status; (b) at every GF and flash shape of the ``cuda-kernel`` sweep the
    built kernels' ``..._query`` launch equal to the Python model at this
    card's SM count and blocks per SM, and the model clean under the
    geometry rules; (c) guard-band launches through the launchers' own
    bindings (not counted as launches): GF into an offset view of a buffer
    filled with 0xA5, flash into an output with padded strides whose gaps
    hold NaN; the guard untouched and the output equal to the plain version
    (GF byte for byte, flash within ``FLASH_ATOL``)."""
    from repro_torch.check.__main__ import lint_targets, summary
    from repro_torch.check.lowered import cuda as ccuda
    from repro_torch.check.lowered import run_lowered_sweep, self_test_lowered
    from repro_torch.check.plan import run_registry_sweep, self_test
    from repro_torch.check.report import CheckReport
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf_matmul as gk

    t0 = time.perf_counter()
    report = CheckReport(plan_records=run_registry_sweep(), lowered_records=run_lowered_sweep(),
                         lint_records=lint_targets(Path(ROOT)))
    counts = summary(report)
    plan_rows, lowered_rows = self_test(), self_test_lowered()
    gate_s = time.perf_counter() - t0
    print(f"[17a check] {smi}: {json.dumps({'records': counts, 'gate_s': gate_s})}")
    for f in report.failures():
        print(f"[17a check] FAIL {f.rule}: {f.message}")
    check(report.ok, f"17a: {len(report.failures())} FAIL finding(s)")
    check(len(report.plan_records) == 144, f"17a: {len(report.plan_records)} plan records")
    for family, want in (("spmd-schedule", 46), ("shard-rules", 50), ("cuda-kernel", 12)):
        got = sum(counts.get(f"lowered {family}", {}).values())
        check(got >= want if family == "cuda-kernel" else got == want,
              f"17a: {got} {family} records")
    missed = [row[0] for row in plan_rows if not row[2]] + [
        row[0] for row in lowered_rows if not (row[2] and row[3])]
    check(not missed, f"17a: mutations not caught by their owner alone: {missed}")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gf_lib, fa_lib = build.load("gf_matmul"), build.load("flash_attention")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    per_sm = set()
    gf_shapes = ccuda.gf_sweep_shapes()
    for label, shape in gf_shapes:
        got = gk.geometry_query(gf_lib, *shape)
        model = gk.gf_matmul_geometry(*shape, sms=sms, per_sm=got["per_sm"])
        per_sm.add(got["per_sm"])
        check(got == model.query_fields(), f"17b: {label} {shape}: the kernel's launch {got} "
              f"!= the model's {model.query_fields()}")
        check(not ccuda.analyze_geometry(model), f"17b: {label} fails the geometry rules")
    flash_shapes = ccuda.flash_sweep_shapes()
    for label, dtype, (b, sq, sk, h, kvh, d, causal) in flash_shapes:
        got = fa.work_geometry_query(fa_lib, b, sq, sk, h, kvh, d, dtypes[dtype])
        model = fa.flash_attention_work_geometry(b, sq, sk, h, kvh, d, dtypes[dtype], sms,
                                                 causal=causal)
        check(got == model.query_fields(), f"17b: {label}: the kernel's launch {got} != the "
              f"model's {model.query_fields()}")
        check(not ccuda.analyze_geometry(model), f"17b: {label} fails the geometry rules")
    print(f"[17b geometry] {sms} SMs, GF blocks per SM {sorted(per_sm)}: {len(gf_shapes)} GF "
          f"and {len(flash_shapes)} flash launches equal to their models")

    gf_guard = []
    for (g, r, k, b), offset in GF_GUARD:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + g * r * k)
        m, x = rand_bytes((g, r, k), gen), rand_bytes((g, k, b), gen)
        buf = torch.full((offset + g * r * b + GUARD_BYTES,), 0xA5, dtype=torch.uint8,
                         device=DEVICE)
        out = buf[offset:offset + g * r * b].view(g, r, b)
        aligned = b % 16 == 0 and out.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0
        gk.launch(gk._launch_fn(), m, x, out)
        torch.cuda.synchronize()
        guard_ok = bool((buf[:offset] == 0xA5).all()) and bool(
            (buf[offset + g * r * b:] == 0xA5).all())
        equal = all(torch.equal(out[i], gf_matmul_table(m[i], x[i])) for i in range(g))
        gf_guard.append({"shape": [g, r, k, b], "offset": offset, "aligned_path": aligned,
                         "guard_ok": guard_ok, "equal": equal})
        check(guard_ok and equal, f"17c: GF guard band at {(g, r, k, b)}: {gf_guard[-1]}")
    check({row["aligned_path"] for row in gf_guard} == {True, False},
          "17c: the GF guard launches missed the aligned or the unaligned path")
    flash_guard = []
    for (b, sq, sk, h, kvh, d, causal), dtype in FLASH_GUARD:
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + sq + h)
        q = torch.randn((b, sq, h, d), generator=gen, device=DEVICE).to(dtype)
        k = torch.randn((b, sk, kvh, d), generator=gen, device=DEVICE).to(dtype)
        v = torch.randn((b, sk, kvh, d), generator=gen, device=DEVICE).to(dtype)
        ps, ph, pd = GUARD_PAD
        full = torch.full((b, sq + ps, h + ph, d + pd), float("nan"), dtype=dtype,
                          device=DEVICE)
        out = full[:, :sq, :h, :d]
        fa.launch(fa._launch_fn(), q, k, v, causal, out=out)
        torch.cuda.synchronize()
        gaps = torch.ones(full.shape, dtype=torch.bool, device=DEVICE)
        gaps[:, :sq, :h, :d] = False
        guard_ok = bool(torch.isnan(full[gaps]).all())
        err = float((out.float() - flash_attention_ref(q, k, v, causal=causal).float())
                    .abs().max())
        flash_guard.append({"shape": [b, sq, sk, h, kvh, d], "causal": causal,
                            "dtype": str(dtype), "strides": list(out.stride()),
                            "guard_ok": guard_ok, "max_abs_err": err})
        check(guard_ok and err <= FLASH_ATOL[dtype],
              f"17c: flash guard band at {(b, sq, sk, h, kvh, d)}: {flash_guard[-1]}")
    phase_s = time.perf_counter() - t0
    print(f"[17c guard] {json.dumps({'gf': gf_guard, 'flash': flash_guard})}")
    print(f"[17 check] {smi}: {phase_s:.1f} s")
    check(phase_s <= CHECK_PHASE_S, f"17: {phase_s:.1f} s, over {CHECK_PHASE_S} s")
    return {"records": counts, "gate_s": gate_s, "phase_s": phase_s,
            "geometry_shapes_checked": {"gf_matmul": len(gf_shapes),
                                        "flash_attention": len(flash_shapes)},
            "guard_ok": {"gf_matmul": all(r["guard_ok"] and r["equal"] for r in gf_guard),
                         "flash_attention": all(r["guard_ok"] for r in flash_guard)}}


def phase_traced(smi: str, spmd_ms: float) -> tuple[dict, int]:
    """18: the traced layer on the card.  (a) ``repro_torch.check.traced``'s
    sweep (15 dispatch traces of the port's entry points on fake card
    tensors, the repair over every rank of a fake ``(pod, node)`` world) and
    its self-test in this process: every record PASS, each of the 9
    mutations caught by its owner alone; (b) real card runs of the
    checkpoint encode, the GF product and the xlstm serve step at the sweep's
    shapes, captured the same way and held equal op by op (name, dtypes,
    shapes) to the sweep's fake captures, their results right (the GF bytes
    equal to the plain version, the logits finite); (c) the host cost of one
    GF call through the custom op ``repro_torch::gf_matmul`` and through the
    wrapper against the bare ctypes launch, at phase 1's DRC(9,6,3)
    NodeEncode shape, beside phase 3's ``spmd_repair`` ms.  Returns the
    results and (b)'s GF launches."""
    from repro_torch.check import traced
    from repro_torch.check.traced import capture as tcap
    from repro_torch.kernels import gf_matmul as gk

    t0 = time.perf_counter()
    programs = {p.name: p for p in traced.sweep_programs()}
    records = [traced.record(p) for p in programs.values()]
    base = programs["spmd_repair[DRC(6,4,3) failed=0]"]
    rows = traced.self_test_traced(base)
    sweep_s = time.perf_counter() - t0
    kinds: dict[str, dict[str, int]] = {}
    for rec in records:
        row = kinds.setdefault(rec.kind, {})
        row[rec.status] = row.get(rec.status, 0) + 1
    cross = {rec.label: rec.info["traced_cross_bytes"] for rec in records
             if "traced_cross_bytes" in rec.info}
    print(f"[18a traced] {smi}: {json.dumps({'records': kinds, 'cross_bytes': cross, 'ops': {rec.label: rec.info['ops'] for rec in records}, 'sweep_and_self_test_s': sweep_s})}")
    for rec in records:
        for f in rec.findings:
            print(f"[18a traced] FAIL {f.rule}: {f.message}")
    check(len(records) == 15 and all(rec.status == "PASS" for rec in records),
          f"18a: {[(rec.label, rec.status) for rec in records]}")
    missed = [row[0] for row in rows if not (row[2] and row[3])]
    check(len(rows) == 9 and not missed, f"18a: mutations not caught by their owner alone: "
          f"{missed}")

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 18)
    gf_matmul_batched.launches = 0
    flash_before = flash_attention.launches
    real = [tcap.capture_checkpoint_encode(fake=False, generator=gen),
            tcap.capture_gf_cuda(fake=False, generator=gen),
            tcap.capture_serve_decode(fake=False, generator=gen)]
    torch.cuda.synchronize()
    gf_launches = gf_matmul_batched.launches
    check(gf_launches == 2, f"18b: {gf_launches} GF launches, not the encode's and the product's")
    check(flash_attention.launches == flash_before, "18b launched the flash kernel")
    same = {}
    for p in real:
        want, got = tcap.signature(programs[p.name]), tcap.signature(p)
        first = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
                     None if len(want) == len(got) else min(len(want), len(got)))
        same[p.name] = {"ops": len(got), "equal": got == want}
        check(got == want, f"18b: {p.name}: the card's run ({len(got)} ops) differs from the "
              f"fake capture ({len(want)} ops) at op {first}: "
              f"{got[first] if first is not None and first < len(got) else None} against "
              f"{want[first] if first is not None and first < len(want) else None}")
        rec = traced.record(p)
        check(rec.status == "PASS", f"18b: {p.name}: {[f.message for f in rec.findings]}")
    (coded,), stripe = real[0].meta["call"]
    code = real[0].meta["code"]
    ka = code.k * code.alpha
    check(torch.equal(stripe[ka:], gf_matmul_table(code.generator[ka:], stripe[:ka])),
          "18b: the encode's parity differs from the plain version")
    (m, x), y = real[1].meta["call"]
    check(torch.equal(y, gf_matmul_table(m, x)), "18b: the GF product differs from the plain "
          "version")
    _, (logits, _state) = real[2].meta["call"]
    check(bool(torch.isfinite(logits.float()).all()), "18b: the serve step's logits not finite")
    del real, coded, stripe, m, x, y, logits, _state
    print(f"[18b real runs] {smi}: {json.dumps(same)}")

    code = make_code("DRC", 9, 6, 3)
    spec = plan_to_spmd(code, code.repair_plan(0))
    sub = sub_bytes(code.alpha)
    nm = torch.from_numpy(spec.node_mats).to(DEVICE)
    xs = rand_bytes((code.n, code.alpha, sub), gen)
    out = torch.empty((code.n, nm.shape[1], sub), dtype=torch.uint8, device=DEVICE)
    fn = gk._launch_fn()
    paths = {"bare_launch": lambda: gk.launch(fn, nm, xs, out),
             "custom_op": lambda: torch.ops.repro_torch.gf_matmul(nm, xs, out),
             "wrapper": lambda: gf_matmul_batched(nm, xs, out)}
    host_us: dict[str, list[float]] = {name: [] for name in paths}
    for call in paths.values():
        call()
    torch.cuda.synchronize()
    for _ in range(OP_COST_ROUNDS):
        for name, call in paths.items():
            for _ in range(OP_COST_CALLS):
                t = time.perf_counter()
                call()
                host_us[name].append((time.perf_counter() - t) * 1e6)
            torch.cuda.synchronize()
    gf_matmul_batched.launches = gf_launches  # the timing's launches are not the path's
    check(torch.equal(out[0], gf_matmul_table(nm[0], xs[0])), "18c: NodeEncode differs")
    med = {name: float(np.median(v)) for name, v in host_us.items()}
    with tcap.fake_mode():
        fake_x = torch.empty((code.n, code.alpha, 256), dtype=torch.uint8, device=DEVICE)
        emulated = tcap.capture_call("spmd_repair", tcap.REPAIR,
                                     lambda p: spmd_repair(code, 0, p)[0], (fake_x,),
                                     fake=True)
    per_repair = sum(op.name == "repro_torch.gf_matmul.default" for op in emulated.ops)
    extra_us = per_repair * (med["custom_op"] - med["bare_launch"])
    cost = {"shape": [code.n, int(nm.shape[1]), code.alpha, sub], "calls": OP_COST_CALLS,
            "rounds": OP_COST_ROUNDS, "host_us_median": med,
            "host_us_min": {name: float(min(v)) for name, v in host_us.items()},
            "op_over_bare_us": med["custom_op"] - med["bare_launch"],
            "gf_calls_per_spmd_repair": per_repair, "spmd_repair_ms": spmd_ms,
            "op_share_of_spmd_repair": extra_us / 1e3 / spmd_ms}
    print(f"[18c op cost] {smi}, host clock: {json.dumps(cost)}")
    del nm, xs, out
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"[18 traced] {smi}: {phase_s:.1f} s")
    check(phase_s <= TRACED_PHASE_S, f"18: {phase_s:.1f} s, over {TRACED_PHASE_S} s")
    return {"records": kinds, "cross_bytes": cross, "sweep_s": sweep_s, "real_runs": same,
            "op_cost": cost, "phase_s": phase_s}, gf_launches


def ptxas_report(log: str) -> list[dict]:
    """ptxas's lines for each kernel of one build log: the (mangled) entry,
    its registers at entry, spill stores and loads, and static shared memory.
    A kernel that calls ``setmaxnreg`` changes its count after entry."""
    rows: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            rows.append({"entry": m.group(1), "registers": 0, "spill_stores": 0,
                         "spill_loads": 0, "smem_static": 0})
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem_static"] = int(sm.group(1)) if sm else 0
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in build.build_logs.items():
        kernels = ptxas_report(log)
        print(f"[build {name}] {len(kernels)} kernels, registers max "
              f"{max((r['registers'] for r in kernels), default=0)}, spill stores max "
              f"{max((r['spill_stores'] for r in kernels), default=0)} bytes")
        for row in kernels:
            print(f"[build {name}] {json.dumps(row)}")
    for d in (32, 64, 128):
        geo = hopper_config(d)
        check(geo == hopper_geometry(d), f"head dim {d}: kernel geometry {geo} != "
              f"the wrapper's {hopper_geometry(d)}")
        print(f"[build flash_attention] bf16 kernel at head dim {d}: {json.dumps(geo)}")
    print(f"[build] {build_s:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    phases = {}
    t = time.perf_counter()
    k1 = phase_kernel(gen)
    phases["kernel"] = {"timings": k1["timings"], "host_s": time.perf_counter() - t}
    kc = k1["check"]
    print(f"[1 kernel] {kc.compared} bytes compared, {kc.mismatched} differ")
    for row in k1["timings"]:
        print(f"[1 kernel] {json.dumps(row)}")
    print("[1 model] computed, not measured: the TPU kernel's int8 bitplane product at "
          f"the int8 tensor-core rate, ms: {json.dumps(k1['int8_bitplane_ms'])}")

    gf_matmul_batched.launches = 0  # count the main path's launches only
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    enc = phase_encode(gen)
    phases["encode"] = {"codes": enc["results"], "host_s": time.perf_counter() - t}
    print(f"[2 encode] {json.dumps(enc['results'])}")
    t = time.perf_counter()
    rep = phase_repair(enc["stripes"])
    phases["repair"] = {"cases": rep, "host_s": time.perf_counter() - t}
    for label, row in rep.items():
        print(f"[3 repair] {label}: {json.dumps(row)}")
    del enc
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rec = phase_recovery(gen)
    phases["recovery"] = {**rec, "host_s": time.perf_counter() - t}
    print(f"[4 recovery] {json.dumps(rec)}")
    torch.cuda.empty_cache()
    ck = phase_checkpoint(gen)
    phases["checkpoint"] = ck
    print(f"[5 checkpoint] {json.dumps(ck)}")
    launches = gf_matmul_batched.launches
    check(launches > 0, "the main path launched the GF kernel no time")
    print(f"[peak 1-5] {torch.cuda.max_memory_allocated()} bytes allocated")
    torch.cuda.empty_cache()  # free the GF phases' cache before the model

    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SERVE_ARCH)
    t = time.perf_counter()
    model = backbone.init_model(cfg, generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    fl = phase_flash(gen, cfg, PREFILL_BATCH, PREFILL_LEN, RAGGED_BATCH, RAGGED_LEN)
    print(f"[6a flash] {json.dumps(fl)}")
    flash_attention.launches = 0  # count the serve path's launches only
    t = time.perf_counter()
    pre = phase_prefill(gen, cfg, model, PREFILL_BATCH, PREFILL_LEN)
    print(f"[6b prefill] {json.dumps(pre)}")
    rag = phase_prefill(gen, cfg, model, RAGGED_BATCH, RAGGED_LEN, profile=False)
    print(f"[6b prefill ragged] {json.dumps(rag)}")
    srv = phase_serve(gen, cfg, model, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
    print(f"[6c serve] {json.dumps(srv)}")
    flash_launches = flash_attention.launches
    check(flash_launches > 0, "the serve path launched the flash kernel no time")
    phases["serve"] = {"init_s": init_s, "host_s": time.perf_counter() - t}
    print(f"[peak 6] {torch.cuda.max_memory_allocated()} bytes allocated; "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    del model
    torch.cuda.empty_cache()  # free the model before nine ranks share the card

    t = time.perf_counter()
    mesh = phase_mesh()
    phases["mesh"] = {"host_s": time.perf_counter() - t}
    for label, row in mesh.items():
        print(f"[7 mesh] {label}, 9 ranks over gloo on one card, host-staged, not a network "
              f"or NCCL figure: {json.dumps(row)}")
    mesh_launches = sum(row["launches"] for row in mesh.values())
    check(mesh_launches > 0, "the ranks launched the GF kernel no time")
    torch.cuda.reset_peak_memory_stats()
    gf_matmul_batched.launches = 0
    t = time.perf_counter()
    ev = phase_evaluation(gen)
    phases["evaluation"] = {"host_s": time.perf_counter() - t}
    eval_launches = gf_matmul_batched.launches
    check(eval_launches > 0, "the evaluation layer launched the GF kernel no time")
    for label, row in ev.items():
        print(f"[8 evaluation] {label}: {json.dumps(row)}")
    print(f"[peak 8] {torch.cuda.max_memory_allocated()} bytes allocated")
    del ev
    torch.cuda.empty_cache()

    train_cfg = get_config(SERVE_ARCH)
    check(train_cfg.remat == "full", f"{train_cfg.name} trains with remat {train_cfg.remat}")
    gf_matmul_batched.launches = 0
    flash_before = flash_attention.launches
    t = time.perf_counter()
    tr9 = phase_train(gen, train_cfg, TRAIN_BATCH, TRAIN_SEQ)
    phases["train"] = {"host_s": time.perf_counter() - t}
    print(f"[9a train] {smi}: {json.dumps(tr9)}")
    t = time.perf_counter()
    ck9 = phase_train_checkpoint(gen, dataclasses.replace(train_cfg, n_layers=CKPT_LAYERS),
                                 TRAIN_BATCH, TRAIN_SEQ)
    phases["train_checkpoint"] = {"host_s": time.perf_counter() - t}
    print(f"[9b checkpoint] {smi}: {json.dumps(ck9)}")
    train_launches = gf_matmul_batched.launches
    check(train_launches > 0, "the checkpoint loop launched the GF kernel no time")
    train_flash_launches = flash_attention.launches - flash_before
    check(train_flash_launches == 0, "phase 9 launched the flash kernel")

    family_launches = {}
    family_flash = []
    for label, arch, layers in FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t = time.perf_counter()
        fam, family_launches[label] = phase_family(gen, cfg)
        phases[f"family {label}"] = {"host_s": time.perf_counter() - t}
        check(family_launches[label] > 0 or cfg.family == "ssm",
              f"{label}: the main path launched the flash kernel no time")
        family_flash += [{"arch": arch, **case} for case in fam["flash_cases"]]
        print(f"[{label} {arch}] {smi}: {json.dumps(fam)}")

    family_train = {}
    whisper_state = None
    for label, arch, layers in FAMILY_TRAIN:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        check(cfg.remat == "full", f"{cfg.name} trains with remat {cfg.remat}")
        t = time.perf_counter()
        fam, state, family_train[label] = phase_family_train(gen, cfg)
        phases[f"train {label}"] = {"host_s": time.perf_counter() - t}
        print(f"[{label} train {arch}] {smi}: {json.dumps(fam)}")
        if state is not None:
            whisper_state = state
    check(whisper_state is not None, "11f gave no training state for 11g")
    t = time.perf_counter()
    ck11 = phase_state_checkpoint(whisper_state)
    phases["train 11g"] = {"host_s": time.perf_counter() - t}
    print(f"[11g checkpoint whisper-small] {smi}: {json.dumps(ck11)}")
    del whisper_state, state  # the loop's last state is whisper's too
    torch.cuda.empty_cache()
    t = time.perf_counter()
    demos, demo_launches = phase_demos()
    phases["demos"] = {"host_s": time.perf_counter() - t}
    print(f"[12 demos] {json.dumps(demos)}")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    sharded, sharded_launches = phase_sharded()
    phases["sharded"] = {"host_s": time.perf_counter() - t}
    for label, row in sharded.items():
        print(f"[{label}] {smi}, 8 gloo ranks on one card, host-staged gloo times, not a "
              f"network or NCCL figure: {json.dumps(row)}")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    gf_matmul_batched.launches = 0
    _, mesh_launches_14 = phase_mesh_runs(smi, "14", mesh_cases())
    gf_launches_14 = gf_matmul_batched.launches
    phases["mesh train and decode"] = {"host_s": time.perf_counter() - t}

    torch.cuda.empty_cache()
    t = time.perf_counter()
    gf_matmul_batched.launches = 0
    _, mesh_launches_15 = phase_mesh_runs(smi, "15", family_mesh_cases())
    check(mesh_launches_15 > 0, "phase 15 launched the flash kernel no time")
    gf_launches_15 = gf_matmul_batched.launches
    phases["mesh families"] = {"host_s": time.perf_counter() - t}

    torch.cuda.empty_cache()
    t = time.perf_counter()
    gf_matmul_batched.launches = 0
    _, pod_flash, pod_gf = phase_pod(smi)
    check(pod_flash > 0, "16a launched the flash kernel no time")
    phases["pod axis and sharded checkpoint"] = {"host_s": time.perf_counter() - t}
    t = time.perf_counter()
    flash_before = flash_attention.launches
    phase_dryrun(smi)
    check(flash_attention.launches == flash_before, "16c launched the flash kernel")
    phases["dry run"] = {"host_s": time.perf_counter() - t}
    t = time.perf_counter()
    gf_before, flash_before = gf_matmul_batched.launches, flash_attention.launches
    chk = phase_check(smi)
    check((gf_matmul_batched.launches, flash_attention.launches) == (gf_before, flash_before),
          "17 counted a launch of the main path's wrappers")
    phases["check"] = {"host_s": time.perf_counter() - t}
    t = time.perf_counter()
    _, gf_launches_18 = phase_traced(smi, rep["DRC(9,6,3) node 0"]["spmd_ms"])
    phases["traced"] = {"host_s": time.perf_counter() - t}

    head = k1["timings"][0]  # DRC(9,6,3) full-width parity encode
    kernels = {"kernels": [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul.py:110",
        "launches": launches,
        "launches_by_phase": {"2-5": launches, "7": mesh_launches, "8": eval_launches,
                              "9": train_launches, "11g": ck11["gf_launches"],
                              "12": demo_launches, "14": gf_launches_14,
                              "15": gf_launches_15, "16b (8 ranks)": pod_gf,
                              "18": gf_launches_18},
        "max_abs_err": kc.max_abs_err,
        "mismatched_bytes": kc.mismatched,
        "ms": head["ms"],
        "ms_spread": head["ms_spread"],
        "bound_share": head["bound_share"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "geometry_shapes_checked": chk["geometry_shapes_checked"]["gf_matmul"],
        "guard_ok": chk["guard_ok"]["gf_matmul"],
        "shape": head["shape"],
        "shapes": [{key: row[key] for key in (
            "label", "shape", "ms", "ms_spread", "bound_ms", "bound_share")}
            for row in k1["timings"]],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": (flash_launches + sum(family_launches.values()) + sharded_launches
                     + mesh_launches_14 + mesh_launches_15 + pod_flash),
        "launches_by_phase": {"6b-6c": flash_launches, "9": train_flash_launches,
                              **{f"{label} {arch}": family_launches[label]
                                 for label, arch, _ in FAMILIES},
                              "11": sum(family_train.values()),
                              "13 (8 ranks)": sharded_launches,
                              "14 (8 ranks)": mesh_launches_14,
                              "15 (8 ranks)": mesh_launches_15,
                              "16a (8 ranks)": pod_flash, "16c (fake tensors)": 0,
                              "18": 0},
        "max_abs_err": fl["max_abs_err"],
        "rel_fro_err": fl["rel_fro_err"],
        "max_err_over_scale": fl["max_err_over_scale"],
        "errs_sweep": fl["errs_sweep"],
        "ms": fl["ms"],
        "ms_spread": fl["ms_spread"],
        "tflops": fl["tflops"],
        "bound_share": fl["bound_share"],
        "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"],
        "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
        "library_ms_spread": fl["library_ms_spread"],
        "kernel_over_library": fl["kernel_over_library"],
        "geometry_shapes_checked": chk["geometry_shapes_checked"]["flash_attention"],
        "guard_ok": chk["guard_ok"]["flash_attention"],
        "shape": fl["shape"],
        "ragged": {key: fl["ragged"][key] for key in (
            "shape", "ms", "ms_spread", "tflops", "bound_ms", "bound_share", "library_ms",
            "kernel_over_library")},
        "phase10_shapes": [{key: case[key] for key in (
            "arch", "shape", "causal", "max_abs_err", "rel_fro_err", "ms", "bound_ms",
            "bound_share", "library_ms")} for case in family_flash],
    }]}
    print(json.dumps({"phases_host_s": {k: v["host_s"] for k, v in phases.items()},
                      "build_s": build_s, "total_s": time.perf_counter() - t0}))
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
