"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``src/repro_torch`` only (no ``jax``, nothing of ``repro``):

1. builds every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   per source, all at once) and prints the card's name and power limit;
2. holds each kernel to its plain PyTorch version, bit for bit, and times
   both (``torch.profiler`` device time over 50 calls): K1
   ``grid_push_decide``, K2 ``grid_push_decide_sched`` and K3
   ``bfs_relabel_sweeps`` at the grid path's shapes (4 x 512^2; K2 and K3
   also at the checkerboard's 1 x 256^2, K3 from the seeds and from
   mid-fixpoint planes, for 1, 3, 8 and 20 sweeps, with ``ds`` on and off,
   and over every tile shape it may be launched with), K4
   ``bidding`` at the assignment path's (8 x 512^2, with ``torch.topk``
   as its one-call yardstick) and K5 ``frontier`` at the matching path's
   (4 x 4096^2, with ``torch.min`` over a packed key as its yardstick);
   K6 ``flash_attention_fwd`` within 3e-5 (float32) and 2e-2 (bfloat16)
   of its plain version over the JAX kernel test's sweep, tails and head
   widths off its tiles (``FLASH_TAILS``), at the serve path's prefill
   shape (8 x 1024 tokens, 9 heads over 3 kv heads, dh 64, causal, float32
   and bfloat16) and at the MoE serve path's (8 x 1024 tokens, 32 heads
   over 8 kv heads, dh 128, causal, float32, on ``flash_fwd_mma``), with
   ``F.scaled_dot_product_attention`` timed as its yardstick at both, and
   at the MLA serve path's (8 x 1024 tokens, 128 heads, qk 192, v 128,
   causal, float32, on ``flash_fwd_mma``); K4 and K5 are timed once more with the L2 flushed before
   every call, and K5 also at 3% and 95% of its rows labeled (``[k5]``
   lines: each time against its bound);
3. drives the grid path, ``maxflow_grid_batch`` on 4 seeded
   ``random_grid_problem`` instances of 512 x 512, with ``backend="pallas"``
   and ``backend="xla"``: both converge, match the scipy oracle, satisfy
   ``check_no_violations`` and agree on every leaf;
4. drives ``backend="balanced"`` on the same batch (oracle flows) and on
   ``checkerboard_problem(256, 256)`` (flow 256, 448 rounds, 12
   heuristics: the JAX package's counts);
5. drives the assignment path, ``solve_assignment`` on 8 x 512^2 seeded
   weights in [0, 100], for ``method="auction"`` and ``"pushrelabel"``
   on ``backend="pallas"`` and ``"xla"``: scipy's optimal weights, the
   JAX package's rounds, the backends equal on every leaf; every K4
   launch on its vector path, and K4's time per launch in each profiled
   ``pallas`` solve against its bound (``[k4]`` lines, ``in_solve`` of
   the ``bidding`` row);
6. drives the matching path, ``match_bipartite_batch`` on 4 seeded
   4096 x 4096 graphs at p = 4/n on both backends: Hopcroft-Karp's
   cardinalities, the JAX package's phases, the backends equal; K5 runs
   once per frontier sweep, 150 launches and 150 ``frontier_`` kernels in
   the profiled ``pallas`` solve, and one more ``pallas`` solve with a
   hook on ``core.matching.bfs._expand`` counts the labeled rows K5 reads
   (1,436,825; a ``[k5]`` line holds them against K5's time in the solve);
7. drives the LLM serving path, smollm-135m at full width (30 layers) on
   weights from ``repro_torch.interop.numpy_params`` (seed 0): 8 prompts
   of 1024 tokens and 16 new tokens through ``make_prefill_step`` and
   ``make_serve_step``, a warm-up and two timed runs. Each run's tokens and
   logits are held to the JAX package's top-5 per step and request
   (``tests/torch_smoke_serve.json``, see ``check_serve``); K6 must launch
   once per layer in each prefill, every launch of the profiled prefill on
   the wgmma kernel ``flash_fwd_wgmma``, and never in a decode step.
   Matmuls stay in full float32 (``torch.backends.cuda.matmul.allow_tf32``
   is False);
8. drives the batch front end, compaction and refill (``phase_batch``,
   ROADMAP M3) on three ragged queues from SEED through ``solve_batch``
   with ``backend="pallas"``: 8 ``random_grid_problem`` grids of 128^2 to
   512^2 (``BATCH_GRID_SHAPES``) padded to one 8 x 512^2 bucket
   (``bucket="max"``), 8 assignment weight matrices in [0, 100] of n =
   128 to 512 (``BATCH_ASSIGN_NS``, auction) in pow2 buckets of 128, 256
   and 512, and 4 Erdos-Renyi graphs at p = 4 / n_r of 1024^2 to 4096^2
   (``BATCH_MATCH_SHAPES``, ``bucket="max"``). Each queue is solved
   masked and compacted in turns (masked, compacted, compacted, masked)
   after a masked warm-up: compacted must equal masked on every leaf,
   counter and ``BucketStats`` (but its ``compact`` flag), each driver's
   second solve its first, every result its oracle (scipy's flows and
   weights, Hopcroft-Karp's cardinalities), and each solve must launch
   the path's kernels (K1 and K3, K4, K5). The grid queue runs once more
   on ``backend="balanced"`` (K2, K3), compacted against masked. Then a
   ``RefillSolver`` of ``REFILL_CAPACITY`` (4) slots per kind on the
   queue's largest bucket shape is seeded with 4 of that bucket's
   requests and admits the others (the bucket's requests again where it
   holds no more than 4): at least one must enter after cycle 0, and
   every result must equal that request's closed masked batch result on
   every leaf. ``[batch]`` lines give per queue the walls in turns,
   device busy and idle share of each driver (one device-only profile
   each), the instances each driver computed (the sum of
   ``CycleEvent.gathered``: bucket size x cycles for the masked one),
   the device time of the compacted driver's gathers and scatters
   (``GATHER_SCATTER_KERNELS``) and the kernels' launches per solve.
   Then each queue goes through device lanes (ROADMAP M7,
   ``drive_lanes``): ``make_solver_mesh()`` must be one lane on the card,
   and it (masked) and two lanes on the one card (masked and compacted,
   buckets padded to the lanes with inert instances) must give the
   masked results without lanes on every leaf (``[lanes]`` lines);
9. drives warm starts (``phase_warm``, ROADMAP M6) on the main paths'
   batches: the 4 x 512^2 grids of phase 3 with WARM_GRID_SHARE (1%) of
   their arcs moved by up to +-4 and of their sink capacities by up to
   +-2, on ``pallas`` and ``balanced``; the 8 x 512^2 weights of phase 5
   with WARM_ASSIGN_SHARE (0.1%) of them moved by +-3, both methods on
   ``pallas``; the 4 x 4096^2 graphs of phase 6 with WARM_MATCH_TOGGLES
   (64) entries toggled each, on ``pallas``. Each batch is solved cold,
   its solutions cached (``solution_of``), and the mutated batch solved
   cold and warm (``WarmStart(solution, base_problem)``) through
   ``solve_batch(warm=)``, ``solve_warm(compact=True)`` and a warm-seeded
   ``RefillSolver``, and on ``pallas`` paths once more on ``xla``: every
   warm result must equal the masked warm one bit for bit, every solve
   the oracle (scipy, Hopcroft-Karp), and each warm kernel solve must
   launch its path's kernels (``xla`` none of K1, K2, K4, K5). ``[warm]``
   lines give warm and cold rounds per instance, walls and the device
   busy of one profiled warm and cold solve each;
10. drives the serving engines (``phase_engine``, ROADMAP M8): the main
   paths' batches (4 x 512^2 grids, 8 x 512^2 weights, 4 x 4096^2
   graphs, ``pallas``) as one queue interleaved by kind through a
   ``SolverEngine``, untraced and traced, equal to each other, to
   ``solve_batch`` of each kind and to the oracles, launching K1, K3, K4
   and K5 (the grids once more on ``balanced``: K2, K3); then
   ``phase_batch``'s three ragged queues as one stream in an order from
   SEED, through a traced ``AsyncSolverEngine`` of one and of two lanes
   (each lane on a CUDA stream of its own), refill off and on, every
   future equal to the sync flush of the stream bit for bit. ``[engine]``
   lines give per run the wall of the stream, device busy summed and as a
   union of intervals (one more profiled run), the seconds and the share
   of the wall under each span name, each bucket's device-solve seconds,
   the metrics snapshot and its ``prometheus_text``; the two-lane closed
   run's trace is saved to ``build/engine_trace.json``. The closed stream
   runs once more at one lane, then two, with the thread switch interval
   cut to 0.5 ms. Last, ``phase_warm``'s edits go through
   ``submit(base=ticket, delta=...)`` and must equal its warm results;
11. reads the launch counts of every solve of phases 3 to 10 (each set to
   0 just before its solve and read just after) and fails if a kernel of
   that solve was never launched, or if K4 or K5 was launched by an
   ``xla`` solve. K3 counts launches (one per call of up to 8 sweeps) and
   sweeps; each grid solve logs both, and K3's device time per launch
   inside the profiled solve against its bound per call;
12. drives the MoE serving path (``phase_moe``, ROADMAP M9b.1):
   phi3.5-moe at full width (d_model 4096, 32 heads over 8 kv heads of
   128, 16 experts of d_ff 6400, top-2, ``router="flow"``) cut to
   MOE_LAYERS (2) layers, on ``numpy_params`` weights (seed 0), float32.
   First the port's ``auction_route`` and ``topk_route`` on the card, on
   the JAX package's own gate logits of each MoE layer of the prefill and
   on a seeded skewed score set (the auction raises prices on both), must
   give the JAX package's dispatch, demand and prices bit for bit and its
   combine weights within 1e-6 (``tests/torch_smoke_moe.npz``). Then a
   warm-up and two timed generations of the serve phase's prompts (8 x
   1024 tokens, 16 new) are held to the JAX package's top-5 per step
   (``tests/torch_smoke_moe.json``) by ``check_serve``, up to the first
   step whose routing the JAX side found unstable under float32-sized
   perturbations (``moe_stops``: none in the committed constants), and
   the port's dispatch in every MoE layer to JAX's wherever compared; K6
   must launch once per layer in each prefill, all on ``flash_fwd_mma``,
   never in a decode step, and no other port kernel may launch. A
   profiled prefill and decode step give device busy, idle share, the
   largest device items and their split by kernel name;
13. drives the MLA serving path (``phase_mla``, ROADMAP M9b.2):
   deepseek-v2 at full width (d_model 5120, 128 heads, MLA with q_lora
   1536, kv_lora 512, qk 128 + 64, v 128; 160 experts of d_ff 1536, top-6,
   2 shared, ``router="flow"``) cut to DS_LAYERS (2) layers, layer 0 the
   dense prefix (SwiGLU of d_ff 12,288) and layer 1 the MoE, on
   ``numpy_params`` weights (seed 0), float32. The routers on the card
   route the JAX package's layer-1 gate logits and the skewed set as JAX
   did (a price must rise on the skewed set); after one prefill the
   hidden state after layer 0 and layer 0's ``c_kv`` / ``k_rope`` cache
   rows, at every MLA_SAMPLE-th position and the last, lie within
   LOGIT_TOL x the largest |value| of JAX's
   (``tests/torch_smoke_deepseek.npz``); then generations as in phase 12
   against ``tests/torch_smoke_deepseek.json``, with ``moe_stops``'
   exact rule for tokens whose last-layer routing JAX found unstable; and
   in each of the port's own generations, the routing decisions that
   differ from JAX's where JAX's marks call them stable are counted
   (``unmarked_flips``; MLA_UNMARKED_FLIPS bounds them);
14. drives the SSM serving path (``phase_ssm``, ROADMAP M9b.3):
   mamba2-370m at full width and depth (48 layers, d_model 1024, d_inner
   2048, 32 heads of 64, d_state 128, d_conv 4, chunk 256, tied
   embeddings; no attention) on ``numpy_params`` weights (seed 0),
   float32. After one prefill the SSM ``state`` and ``conv`` rows of
   layers SSM_LAYERS (0 and 47) for the first SSM_REQUESTS (2) requests
   lie within LOGIT_TOL x JAX's largest |value| of each
   (``tests/torch_smoke_mamba.npz``); then a warm-up and two timed
   generations of the serve phase's prompts are held to JAX's top-5 per
   step (``tests/torch_smoke_mamba.json``) by ``check_serve``, and no port
   kernel (K1-K6) may launch in a prefill or a decode step. A profiled
   prefill and decode step give device busy, idle share, the largest
   device items and their split by kernel name, and the phase logs the
   peak device memory;
15. drives the training path (``phase_train``, ROADMAP M9b.6):
   smollm-135m at full width and depth (30 layers, d_model 576, 9 / 3
   heads of 64, vocab 49,152) on ``numpy_params`` weights (seed 0),
   float32 with TF32 off, TRAIN_STEPS (3) steps of ``make_train_step`` on
   8 x 1024-token batches from the port's ``make_batch`` (DataConfig seed
   0) with the train CLI's optimizer settings. The step-0 gradients of
   ``embed``, layer 0's ``wq``, layer 29's ``w2`` and ``final_norm`` at
   sampled entries, each step's loss, lr and ``grad_norm`` are held to
   the JAX package's ``make_train_step`` on the same weights and rows
   (``tests/torch_smoke_train.json``); K6 (with its log-sum-exp output)
   must launch twice per layer in each step (the forward and the
   recompute of the config's remat ``"full"``), all on
   ``flash_fwd_wgmma``, and no other port kernel; the train state must
   come back from ``checkpoint.store`` bit for bit. The first step is a
   warm-up and the others are timed (tok/s); a profiled step gives device
   busy, idle share, the largest device items and their split by kernel
   name; the phase logs the peak device memory. Then ``remat_modes``:
   the gradients under remat ``"none"`` and ``"dots"`` equal ``"full"``'s
   bit for bit, and a step under each mode gives its wall and peak beside
   the dry run's predicted peak. Phase 2 also holds K6's
   log-sum-exp output to its plain version's (LSE_TOL) at every shape
   and times it at the serve shape;
16. drives the encoder (``phase_encoder``, ROADMAP M9b.4): hubert-xlarge
   at full width and depth (48 layers, d_model 1280, 16 heads of 80,
   non-causal, no RoPE, sinusoidal positions, LayerNorm, GELU, the
   512-wide frontend; 945,912,320 parameters) on ``numpy_params``
   weights, float32 with TF32 off. Its encoder forward (``apply_model``
   under ``torch.inference_mode``) on ENC_B x ENC_S frames of the port's
   ``make_batch``: a warm-up and two timed runs, the logits at
   ``sample_positions`` held to JAX's (``tests/torch_smoke_encoder.npz``)
   within LOGIT_TOL, K6 launched once per layer, all on
   ``flash_fwd_mma``; then ENC_STEPS steps of ``make_train_step`` on
   ENC_TRAIN_B x ENC_S frames held to JAX's loss, lr and grad_norm, the
   step-0 gradients of ENCODER_LEAVES to JAX's and none reaching
   ``embed`` (``tests/torch_smoke_encoder.json``), K6 twice per layer in
   each step (remat ``"full"``), then ``remat_modes`` as phase 15; every
   batch's rows must hash as the constants' did. Phase
   2 holds K6 at the forward's shape (8 x 1024 frames, 16 heads of 80,
   non-causal) and at the train step's (4 x 1024 frames, with its lse)
   to its plain version and times it at the forward's against
   ``F.scaled_dot_product_attention``;
17. drives the int8 KV cache (``phase_kvq``, ROADMAP M9b.5): smollm-135m
   with ``kv_quant=True`` on the serve phase's weights and prompts, run
   as phase 7 runs the float cache: a warm-up and two timed generations
   held to the JAX package's kv-quant top-5 per step
   (``tests/torch_smoke_kvq.json``) by ``check_serve``, K6 once per layer
   in each prefill and never in decode, a profiled prefill and decode
   step; then after one more prefill the int8 cache of layers KVQ_LAYERS
   dequantised lies within one code step of the float cache's; the
   decode step's wall is logged beside the float cache's, with the
   cache's bytes;
18. reads the dry run (``phase_dryrun``, ROADMAP M9b.7), counted on
   ``meta`` by processes started with the smoke: every arch x shape of
   the reference for one card, each ``ok`` or skipped exactly where the
   reference's ``cell_skip_reason`` says (a ``[dryrun]`` line each, and
   jamba-v0.1's predicted memory), then runs smollm-135m's prefill_32k
   (32 x 32,768 tokens) and decode_32k (a cache of 32,767 tokens at the
   largest power-of-two batch predicted within DRYRUN_DECODE_BYTES) whole
   on the card in bfloat16 through ``run_cell(device="cuda")``, counted
   and then timed: the card's FLOPs and bytes equal to the ``meta``
   count, each peak within DRYRUN_PEAK_TOL of the prediction, finite
   logits, K6 once per layer in the prefill and never in decode; the
   wall against the roofline time, and K6 alone at the prefill's shape.

19. drives the model meshes (``phase_mesh``, ROADMAP M9b.8, before the
   dry run) with ranks of one process group that share the card over gloo
   (``launch.mesh.spawn``; each rank builds its blocks of the model with
   ``models.model.shard_model``, a server in its serving placement
   (``fsdp=False``), and sets its launch counts to 0 just before the
   path and reads them just after), three runs at once: smollm-135m at
   full width and depth on ``numpy_params`` weights served on 1 x 3
   ranks (8 x 1024 prompts, 16 new tokens; every step's logits within
   ``check_serve``'s rule of the single-rank port's, each rank launching
   K6 once per layer on its 3 of the 9 heads in each prefill),
   phi3.5-moe at full width and MOE_LAYERS layers served on 2 x 2 (its
   routing held bit for bit to a single rank routing as 2 data ranks,
   ``grouped_sharder(2)``, on the mesh's gate logits, and its logits to
   that run's under ``check_serve``'s rule), and smollm-135m trained on
   2 x 3 for MESH_TRAIN_STEPS steps of 8 x 1024 tokens under remat
   ``"full"`` (loss and grad_norm within the train check's tolerances of
   the single-rank step's on the same weights and rows; K6 twice per
   layer per step on every rank); then (ROADMAP M9b.8b), while the
   single-rank references of those three run, two runs on 1 x 2:
   deepseek-v2 at full width and DS_LAYERS layers (MLA, 64 of its 128
   heads a rank, the caches' sequence split: the absorbed decode's
   flash-decoding combine; routing held bit for bit to a single rank's
   on the mesh's gate logits; K6 once per layer per prefill on each
   rank's heads, never in decode) and mamba2-370m at full width and
   depth (Mamba2, 16 of its 32 heads a rank; no port
   kernel launched), both drawn on the card from a generator of SEED and
   held to the single-rank port under ``check_serve``'s rule, with K6
   alone at the MLA ranks' head shard. Each rank's reckoned bytes are
   logged first (``[mesh]`` lines). A rank that fails, or any mismatch,
   fails the run.

The phases' walls are logged on one ``[walls]`` line at the end
(``train``, ``encoder``, ``kvq``, ``mesh`` and ``dryrun`` among them).

Prints one JSON line per kernel summary, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a CUDA device, and in a directory that holds nothing else of the
repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B, H, W = 4, 512, 512          # the main path's batch
SEED = 0
# the balanced backend's worst case for the fixed cadence, and the JAX
# package's (flow, rounds, heuristics) on it
CHECKERBOARD = (256, 256)
CHECKERBOARD_WANT = (256.0, 448, 12)
# cost-scaling assignment: B x n x n weights in [0, 100] (the paper's cost
# range, section 6), and matching: B Erdos-Renyi n x n graphs at p = 4 / n
ASSIGN_B, ASSIGN_N = 8, 512
MATCH_B, MATCH_N = 4, 4096
# the JAX package's rounds (assignment, per method) and phases (matching)
# per instance on those batches, from a CPU run of
# `PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_smoke_constants.py`
ASSIGN_ROUNDS_WANT = {
    "auction": (320, 384, 352, 368, 336, 384, 368, 352),
    "pushrelabel": (720, 816, 752, 752, 800, 800, 800, 784)}
MATCH_ROUNDS_WANT = (8, 10, 8, 7)
# the serve path: the model, batch, prompt length and new tokens; the JAX
# package's top-5 logits per step on the same weights and prompts, from a
# CPU run of `PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py serve`
SERVE_ARCH = "smollm-135m"
SERVE_B, SERVE_S, SERVE_NEW = 8, 1024, 16
SERVE_CONSTANTS = ROOT / "tests" / "torch_smoke_serve.json"
# the MoE serve path: phi3.5-moe at full width cut to MOE_LAYERS layers
# (its float32 weights, 168 GB at 32 layers, do not fit one card, and the
# JAX constants are made on a CPU), on SERVE_B x SERVE_S prompts and
# SERVE_NEW new tokens. The JAX package's top-5 logits per step are in
# MOE_CONSTANTS; its gate logits, dispatch and routing-stability marks per
# MoE layer in MOE_ROUTING (`PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py moe`). A routing decision is unstable when
# it changes with the scores moved by MOE_PERTURB x the set's largest
# |score| x N(0, 1) in any of MOE_DRAWS draws: about the gap between cuBLAS
# and XLA-CPU float32 products. The skewed score set adds a per-expert
# offset of std MOE_SKEW, on which the auction's price rounds engage
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 2
MOE_CONSTANTS = ROOT / "tests" / "torch_smoke_moe.json"
MOE_ROUTING = ROOT / "tests" / "torch_smoke_moe.npz"
MOE_PERTURB = 1e-6
MOE_DRAWS = 4
MOE_SKEW = 0.5
# the MLA serve path: deepseek-v2 at full width cut to DS_LAYERS layers:
# layer 0 the dense prefix (MLA, SwiGLU of d_ff 12,288), layer 1 MLA and
# the MoE (160 experts, top-6, 2 shared), every kind of layer the model
# has (60 float32 layers are about 944 GB, 2 are 21.4 GB), on the serve
# phase's prompts. The JAX package's top-5 logits per step are in
# MLA_CONSTANTS; in MLA_ROUTING its routing as in MOE_ROUTING, with a
# routing-stability mark per prefill token (``moe_stops``), and, at every
# MLA_SAMPLE-th prompt position and the last, the hidden state after layer
# 0 and layer 0's cache rows (`PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py deepseek`)
MLA_ARCH = "deepseek-v2-236b"
DS_LAYERS = 2
MLA_CONSTANTS = ROOT / "tests" / "torch_smoke_deepseek.json"
MLA_ROUTING = ROOT / "tests" / "torch_smoke_deepseek.npz"
MLA_SAMPLE = 64
# the SSM serve path: mamba2-370m at full width and depth (368,338,432
# parameters, 1.47 GB in float32), on the serve phase's prompts. The JAX
# package's top-5 logits per step are in SSM_CONSTANTS; its SSM state and
# conv rows after the prefill, of layers SSM_LAYERS for the first
# SSM_REQUESTS requests, in SSM_STATES (`PYTHONPATH=src JAX_PLATFORMS=cpu
# python tests/torch_smoke_constants.py mamba`)
SSM_ARCH = "mamba2-370m"
SSM_CONSTANTS = ROOT / "tests" / "torch_smoke_mamba.json"
SSM_STATES = ROOT / "tests" / "torch_smoke_mamba.npz"
SSM_LAYERS = (0, 47)
SSM_REQUESTS = 2
# the training path: smollm-135m at full width and depth on numpy_params
# weights, float32 (no TF32), TRAIN_STEPS steps of make_train_step on
# TRAIN_B x TRAIN_S-token batches from the port's make_batch (DataConfig
# seed SEED), with the train CLI's optimizer settings (peak lr TRAIN_LR,
# TRAIN_WARMUP warm-up steps, the cosine's decay over the run). The JAX
# package's loss, lr and grad_norm per step, and its step-0 gradients of
# TRAIN_LEAVES at TRAIN_SAMPLE flat indices of each (its largest |g| among
# them) are in TRAIN_CONSTANTS (`PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py train`). TRAIN_LEAVES maps a port
# parameter to its JAX params-tree path and its index along the stacked
# period axis (None for a leaf outside ``body``)
TRAIN_ARCH = "smollm-135m"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 20
TRAIN_CONSTANTS = ROOT / "tests" / "torch_smoke_train.json"
# the rows make_batch gives on the card, on which the JAX constants were
# made: numpy's Generator.zipf, which draws them, differs between numpy
# versions (`python3 tests/torch_smoke_train_rows.py OUT.npz` on the card)
TRAIN_ROWS = ROOT / "tests" / "torch_smoke_train.npz"
TRAIN_LEAVES = {
    "embed": (("embed",), None),
    "layers.0.mixer.wq.weight": (("body", "sub0", "mixer", "wq"), 0),
    "layers.29.ffn.w2.weight": (("body", "sub0", "ffn", "w2"), 29),
    "final_norm.g": (("final_norm", "g"), None)}
TRAIN_SAMPLE = 1024
# the encoder path: hubert-xlarge at full width and depth (48 layers,
# d_model 1280, 16 heads of 80, non-causal, the 512-wide frontend; 3.78 GB
# of float32 weights) on numpy_params weights, float32 with TF32 off. Its
# forward (``apply_model`` under ``torch.inference_mode``) on ENC_B x
# ENC_S frames, the embeds of the port's make_batch (DataConfig seed SEED,
# step 0), then ENC_STEPS steps of make_train_step on ENC_TRAIN_B x ENC_S
# frames with the train CLI's optimizer settings (TRAIN_LR, TRAIN_WARMUP,
# decay over the run). The JAX package's logits at sample_positions of
# every request are in ENCODER_LOGITS; its loss, lr and grad_norm per
# step, its step-0 gradients of ENCODER_LEAVES at TRAIN_SAMPLE flat
# indices of each (as TRAIN_LEAVES) and the SHA-256 of each batch's rows
# (``rows_digest``) in ENCODER_CONSTANTS (`PYTHONPATH=src JAX_PLATFORMS=cpu
# python tests/torch_smoke_constants.py encoder`)
ENCODER_ARCH = "hubert-xlarge"
ENC_B, ENC_S = 8, 1024
ENC_TRAIN_B, ENC_STEPS = 4, 3
ENCODER_CONSTANTS = ROOT / "tests" / "torch_smoke_encoder.json"
ENCODER_LOGITS = ROOT / "tests" / "torch_smoke_encoder.npz"
ENCODER_LEAVES = {
    "frontend.weight": (("frontend",), None),
    "layers.0.mixer.wq.weight": (("body", "sub0", "mixer", "wq"), 0),
    "layers.47.ffn.w2.weight": (("body", "sub0", "ffn", "w2"), 47),
    "final_norm.b": (("final_norm", "b"), None),
    "lm_head.weight": (("lm_head",), None)}
# the int8 KV cache: smollm-135m with kv_quant on the serve phase's
# weights, prompts and new tokens; the JAX package's top-5 per step in
# KVQ_CONSTANTS (`PYTHONPATH=src JAX_PLATFORMS=cpu python
# tests/torch_smoke_constants.py kvq`); after a prefill the codes of
# layers KVQ_LAYERS, dequantised, lie within one code step (their scale)
# of the float cache's keys and values of the same prefill
KVQ_CONSTANTS = ROOT / "tests" / "torch_smoke_kvq.json"
KVQ_LAYERS = (0, 29)
# The training check's tolerances against JAX: float32 on both sides
# (cuBLAS, K6's split-TF32 forward, the plain attention backward against
# XLA on the CPU), other summation orders. The loss of each step within
# TRAIN_LOSS_TOL x JAX's and grad_norm within TRAIN_NORM_TOL x JAX's; the
# sampled step-0 gradients within TRAIN_GRAD_TOL x the leaf's largest |g|
# (JAX's). A backward that misreads K6's log-sum-exp (a base-2 or a
# missing scale) rescales every attention gradient by far more
TRAIN_LOSS_TOL = 1e-4
TRAIN_NORM_TOL = 1e-3
TRAIN_GRAD_TOL = 1e-3
# deepseek's gate logits on the card differ from JAX's on the CPU by up to
# 7.7e-6 of their largest |logit| (after layer 0 and K6; phi's first layer
# has no such depth), so its marks move the scores by 1e-5 of it
MLA_PERTURB = 1e-5
# the routing decisions of the port's own deepseek generations (not
# pinned) that may differ from JAX's where JAX's marks call them stable
# (``unmarked_flips``): none of 6,955 prefill and 120 decode decisions
# did on an H100, so any one fails the phase
MLA_UNMARKED_FLIPS = 0
# the router's combine weights (softmaxes in [0, 1]) against JAX's
COMBINE_TOL = 1e-6
# Each of the port's logits at JAX's top-5 ids must lie within LOGIT_TOL x
# the step's largest |logit| (JAX's, per request) of JAX's value. Both run
# in float32 (no TF32) and differ only in summation order (cuBLAS and K6
# against XLA on the CPU); at smoke size on the CPU that difference is
# about 1e-6 of the largest logit, and 1e-3 leaves room for 30 layers and
# 1024 positions while a kernel that drops a key tile or reads the wrong
# kv head moves the logits far more (phase 2 holds K6 itself to 3e-5).
LOGIT_TOL = 1e-3
# K6 against its plain version: (B, Sq, Sk, H, KV, dh, dv), causal, dtype
# -- the JAX kernel test's sweep (dh != dv, MQA, non-causal) and its
# bfloat16 case; the serve path's shape is added from SERVE_* in phase 2
FLASH_SWEEP = [
    ((2, 64, 64, 4, 2, 16, 16), True, torch.float32),
    ((1, 128, 128, 6, 3, 32, 16), False, torch.float32),
    ((2, 256, 256, 8, 8, 64, 64), True, torch.float32),
    ((1, 64, 64, 4, 1, 16, 8), True, torch.float32),
    ((1, 512, 512, 2, 2, 32, 32), True, torch.float32),
    ((2, 64, 64, 4, 2, 16, 16), True, torch.bfloat16),
]
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# K6's log-sum-exp output against the plain version's, absolute, natural
# log units: the scores differ by about 1e-6 of their size (split TF32,
# bf16 products exact in float32) and the sums by the SFU's exp2 (2 ulp)
LSE_TOL = 1e-4
# K6 in float32 and bfloat16, besides the serve shape: (B, Sq, Sk, H, KV,
# dh, dv), causal, dtype -- Sq and Sk off the 64-row query and 64/32-key
# tiles, Sq != Sk both ways, MQA, every head-width class
FLASH_TAILS = [
    ((1, 100, 1000, 4, 1, 64, 64), False, torch.float32),
    ((1, 1000, 100, 4, 2, 64, 64), True, torch.float32),
    ((2, 77, 77, 4, 2, 8, 8), True, torch.float32),
    ((1, 100, 100, 4, 2, 24, 24), False, torch.float32),
    ((1, 100, 100, 4, 2, 72, 72), True, torch.float32),
    ((1, 129, 129, 4, 2, 192, 128), False, torch.float32),
    ((1, 100, 100, 2, 2, 256, 256), True, torch.float32),
    ((1, 100, 1000, 4, 1, 72, 40), False, torch.bfloat16),
    ((1, 65, 65, 2, 1, 256, 256), True, torch.bfloat16),
]
# phase_batch: ragged queues through the batch front end (``solve_batch``),
# each solved masked and compacted in turns. Grids are random_grid_problem
# (max_cap 10, terminal density 0.5) padded to one 8 x 512^2 bucket;
# assignment weights uniform in [0, 100] in pow2 buckets of 128, 256 and
# 512; matching Erdos-Renyi graphs at p = 4 / n_r padded to 4096^2. Then
# one RefillSolver per kind of REFILL_CAPACITY slots on the queue's
# largest bucket shape
BATCH_GRID_SHAPES = ((128, 128), (192, 256), (256, 256), (320, 384),
                     (384, 384), (448, 512), (512, 512), (512, 512))
BATCH_ASSIGN_NS = (128, 192, 256, 320, 384, 448, 509, 512)
BATCH_MATCH_SHAPES = ((1024, 1024), (2048, 3000), (3000, 4096),
                      (4096, 4096))
REFILL_CAPACITY = 4
# phase_warm: each batch of the main paths (4 x 512^2 grids, 8 x 512^2
# assignment weights, 4 x 4096^2 graphs) solved, then mutated and solved
# again warm from its cached solutions. Grids: WARM_GRID_SHARE of the
# arcs moved by up to +-4 and of the sink capacities by up to +-2 (the
# delta of the reference's warm tests, on a share of the grid); weights:
# WARM_ASSIGN_SHARE of them moved by +-3 within [0, 100]; graphs:
# WARM_MATCH_TOGGLES entries toggled each
WARM_GRID_SHARE = 0.01
WARM_ASSIGN_SHARE = 0.001
WARM_MATCH_TOGGLES = 64
# phase_engine: the serving engines on the main paths' kernels, one
# SolverEngine / AsyncSolverEngine knob set for all three kinds; the async
# runs see no deadline (batches form by size, the rest by ``flush_now``),
# so every batch holds one kind's whole queue, as the sync flush does
ENGINE_KW = {"maxflow": dict(backend="pallas"),
             "assignment": dict(backend="pallas", method="auction"),
             "matching": dict(backend="pallas")}
ENGINE_MAX_BATCH = 8
ENGINE_NO_DEADLINE_MS = 600_000.0
SPAN_NAMES = ("submit", "queue-wait", "bucket/pad", "device-solve",
              "refill-admission", "resolve")
# the kernels of the compacted driver's gathers (``index_select``) and
# scatters (``index_copy_``), by name; the solves launch them nowhere else
GATHER_SCATTER_KERNELS = ("indexSelect", "index_copy")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate (data sheet)
# H100 SXM dense tensor-core rates (data sheet): K6 runs a float32 product
# as three TF32 products, a bfloat16 one as one bf16 product
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
L2_FLUSH_BYTES = 128 << 20     # written between calls to time K4, K5 L2-cold
TRACE_PRIMER_OPS = 2000  # device ops ahead of each ``traced`` run
TRACE_GAP_S = 0.01  # idle card between them and the run
# K5's shares of labeled rows, timed on their own (half first: the row's
# main input); a matching solve's sweeps run from 2% to 96%
K5_SHARES = (0.5, 0.03, 0.95)
# K5 launches and labeled-row reads (rows with root < INF, summed over the
# batch and the calls) in one matching pallas solve of the smoke's graphs;
# they do not depend on the machine (a CPU count with the hook of
# ``k5_reads``), so any other count means the solve changed
K5_READS_WANT = (150, 1_436_825)
# the dry run (``phase_dryrun``, ROADMAP M9b.7): every arch x shape
# counted on ``meta`` for one card (``python -m repro_torch.launch.dryrun
# --all``) and the train phases' steps under each remat mode
# (``write_train_predictions``), each in a process of its own started with
# the smoke and writing under DRYRUN_DIR; then DRYRUN_ARCH's prefill_32k
# and decode_32k cells run whole on the card in bfloat16, the decode cell
# at the largest power-of-two batch up to its shape's whose predicted peak
# fits DRYRUN_DECODE_BYTES. Each cell's FLOPs and bytes counted on the
# card must equal the ``meta`` count, and its peak device memory lie
# within DRYRUN_PEAK_TOL of the prediction
DRYRUN_DIR = ROOT / "build" / "dryrun"
DRYRUN_ARCH = "smollm-135m"
DRYRUN_DECODE_BYTES = 60 * 2 ** 30
DRYRUN_PEAK_TOL = 0.15
DRYRUN_TIMEOUT_S = 900
REMAT_MODES = ("full", "none", "dots")
# the model-parallel path (ROADMAP M9b.8): ranks of one process group that
# share the one card (gloo over CUDA tensors, launch.mesh.mesh_backend),
# started by launch.mesh.spawn; (data, model) per run. smollm-135m served
# on 1 x 3 (3 of its 9 q heads, 1 of its 3 kv heads, 512 of its 1536
# hidden units and 16,384 of its 49,152 vocabulary ids a rank) and trained
# on 2 x 3 (4 of the 8 rows a data rank) for MESH_TRAIN_STEPS steps;
# phi3.5-moe at MOE_LAYERS layers served on 2 x 2 (8 of its 16 experts a
# rank). Each held to the single-rank port on the card: serving under
# check_serve's rule, training within TRAIN_LOSS_TOL / TRAIN_NORM_TOL,
# phi's routing bit for bit with a single rank routing as 2 data ranks
# (grouped_sharder(2)) on the mesh's gate logits. MLA and Mamba2 on a
# model axis (ROADMAP M9b.8b), served on 1 x 2 and drawn on the card as
# phi is: deepseek-v2 at DS_LAYERS layers (64 of its 128 heads, 80 of its
# 160 experts a rank; S_max 1040 split over the model axis) and mamba2-370m
# at full depth (16 of its 32 heads a rank). deepseek's ranks
# draw 21.4 GB each in turn, so they start after the first three runs.
# Results in MESH_DIR
MESH_DIR = ROOT / "build" / "mesh"
MESH_SERVE, MESH_TRAIN, MESH_MOE = (1, 3), (2, 3), (2, 2)
MESH_MLA, MESH_SSM = (1, 2), (1, 2)
MESH_TRAIN_STEPS = 2
# K6's bounds (ms) at the smoke's shapes, from the formula chip_smoke.py
# held before repro_torch.roofline took it over: (B, Sq, Sk, H, KV, dh,
# dv), causal, dtype -- serve (float32, bfloat16), phi, deepseek, hubert's
# forward and train step
K6_BOUNDS_MS = {
    ((8, 1024, 1024, 9, 3, 64, 64), True, torch.float32):
        0.058624930909090905,
    ((8, 1024, 1024, 9, 3, 64, 64), True, torch.bfloat16):
        0.009780701314459048,
    ((8, 1024, 1024, 32, 8, 128, 128), True, torch.float32):
        0.4168883975757576,
    ((8, 1024, 1024, 128, 128, 192, 128), True, torch.float32):
        2.0844419878787876,
    ((8, 1024, 1024, 16, 16, 80, 80), False, torch.float32):
        0.2603010482424242,
    ((4, 1024, 1024, 16, 16, 80, 80), False, torch.float32):
        0.1301505241212121,
}
KERNEL_SOURCES = {
    "grid_push_decide": ("src/repro_torch/kernels/csrc/grid_push.cu",
                         "src/repro/kernels/grid_push/kernel.py:116"),
    "grid_push_decide_sched": ("src/repro_torch/kernels/csrc/grid_push.cu",
                               "src/repro/kernels/grid_push/kernel.py:167"),
    "bfs_relabel_sweeps": ("src/repro_torch/kernels/csrc/bfs_relabel.cu",
                           "src/repro/kernels/bfs_relabel/kernel.py:94"),
    "bidding": ("src/repro_torch/kernels/csrc/bidding.cu",
                "src/repro/kernels/bidding/kernel.py:67"),
    "frontier": ("src/repro_torch/kernels/csrc/frontier.cu",
                 "src/repro/kernels/frontier/kernel.py:71"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:81"),
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


K3_SWEEPS = "bfs_relabel_sweeps.sweeps"   # K3's sweep count in read_counts
# what the port's kernels are called in a profile (csrc/*.cu)
PORT_KERNEL_SYMBOLS = tuple(
    f"{p}(anonymous namespace)::{k}" for p in ("", "void ")
    for k in ("grid_push_decide", "bfs_relabel_sweep", "bidding_kernel",
              "frontier_", "flash_fwd_"))


def device_events(averages):
    """``(self device us, count, name)`` of every device-side event of a
    ``torch.profiler`` run's ``key_averages()`` (kernels, memsets,
    copies), largest first. The host ops that launched them report the
    same time again, so they are left out."""
    from torch.autograd import DeviceType
    return sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in averages
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)


def trace_device_events(events):
    """``device_events`` of ``traced`` device events (``torch.profiler``'s
    raw trace, made without ``acc_events``): the same rows, without the
    Python event tree the profiler builds for ``key_averages()``, which
    takes tens of seconds for a solve of 100,000 device ops."""
    acc = {}
    for ev in events:
        us, n = acc.get(ev.name(), (0.0, 0))
        acc[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return sorted(((us, n, key) for key, (us, n) in acc.items()),
                  reverse=True)


def device_union_s(events) -> float:
    """Seconds in which at least one of ``traced``'s device events was
    running: the union of their intervals. Below the summed busy time
    exactly when events on several streams overlapped."""
    return union_seconds((ev.start_ns() / 1e9, ev.end_ns() / 1e9)
                         for ev in events)


class Timing(NamedTuple):
    """One timing of ``time_ms`` or ``time_cold_ms``."""
    ms: float        # device ms per call
    loop_ms: float | None  # CUDA events around the loop, per call
    source: str      # where ``ms`` came from: "profiler", "loop", "events"


def traced(run):
    """``run()`` in a ``torch.profiler`` trace of the device, after
    TRACE_PRIMER_OPS one-element adds. The first device events of a trace
    can go unrecorded: in a whole smoke run on an H100, 3 in the first
    trace, more in each later one, 45 in the last and once 464; before
    the primer, the first of them were the run's own (once a K6 launch
    of hubert's forward). The primer takes that loss. The device events
    that start after the host's clock read between the primer and the
    run (TRACE_GAP_S of idle card on either side) are the run's. Returns
    how many primer ops the trace recorded, the run's device events and
    what it returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        primer = torch.empty(1, device="cuda")
        for _ in range(TRACE_PRIMER_OPS):
            primer.add_(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_GAP_S)
        t_split = time.time_ns()
        time.sleep(TRACE_GAP_S)
        out = run()
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA
              and ev.duration_ns() > 0]
    kept = [ev for ev in events if ev.start_ns() >= t_split]
    return len(events) - len(kept), kept, out


def profiled_ms(run, reps: int, symbol: str | None = None,
                only_symbol: bool = False) -> float | None:
    """Device ms per call of ``run(i)``, ``i`` in ``range(reps)``, from
    ``torch.profiler``: the self device time of every device event (only
    of kernels whose name holds ``symbol`` with ``only_symbol``) over
    ``reps``. Now and then, after many profiled runs in one process, a
    run records no device event at all, or a third of a kernel's
    launches, or misses one launch of a window; so a run counts only when
    every kind of event it times was seen at least 0.9 ``reps`` times,
    kernels holding ``symbol`` among them. Up to three runs; None when
    none counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           acc_events=True) as prof:
            for i in range(reps):
                run(i)
            torch.cuda.synchronize()
        rows = [r for r in device_events(prof.key_averages())
                if not only_symbol or symbol in r[2]]
        if (rows and all(r[1] >= 0.9 * reps for r in rows)
                and (symbol is None or any(symbol in r[2] for r in rows))):
            return sum(r[0] for r in rows) / 1e3 / reps
    return None


def time_ms(fn, reps: int = 50, symbol: str | None = None) -> Timing:
    """Device and loop ms per call of ``fn()``, after a warm-up call.

    Device ms is the device time of every kernel that ``reps`` calls ran
    (``profiled_ms``; ``symbol`` names the kernel a wrapper launches): the
    work on the card, without the host's launch overhead. Loop ms is CUDA
    events around a Python loop of ``reps`` calls, so it also holds the
    host's launch rate when that is slower than the card. When no profiler
    run counts, device ms is the loop ms, an upper bound: ``source``
    says "loop" and a line says so."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(stop) / reps
    ms = profiled_ms(lambda i: fn(), reps, symbol)
    if ms is not None:
        return Timing(ms, loop_ms, "profiler")
    log(f"[time] no torch.profiler run saw every device event for 0.9 "
        f"of the calls: device ms is the loop's {loop_ms:.4f} ms")
    return Timing(loop_ms, loop_ms, "loop")


def time_cold_ms(fn, symbol: str, reps: int = 50) -> Timing:
    """Device ms per call of ``fn()`` with a cold L2: ``L2_FLUSH_BYTES``
    are written before every call, and only the device time of kernels
    whose name holds ``symbol`` is counted (not the flush). When no
    profiled run counts (see ``profiled_ms``), CUDA events around each
    call give the time: ``source`` says "events" and a line says so."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def run(i):
        flush.fill_(i & 255)
        fn()
    run(0)
    torch.cuda.synchronize()
    ms = profiled_ms(run, reps, symbol, only_symbol=True)
    if ms is not None:
        return Timing(ms, None, "profiler")
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (start, stop) in enumerate(marks):
        flush.fill_(i & 255)
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in marks) / reps
    log(f"[time] no torch.profiler run saw {symbol} kernels for 0.9 of "
        f"the calls: {ms:.4f} ms from CUDA events around each call")
    return Timing(ms, None, "events")


def took(row: dict, key: str, t: Timing) -> float:
    """``t.ms``, with its source noted as ``row["ms_from"][key]``."""
    row.setdefault("ms_from", {})[key] = t.source
    return t.ms


def bound(nbytes: float, nops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for moving ``nbytes`` and doing ``nops`` ops at
    ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    """Bit pattern of a 32-bit tensor (so -0.0 and 0.0 differ)."""
    return t.contiguous().view(torch.int32)


def compare(got, want, what: str) -> float:
    """Require bitwise equality; returns the max abs difference (0.0)."""
    err = 0.0
    for g, w in zip(got, want):
        if g is None and w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        err = max(err, (g.double() - w.double()).abs().max().item())
        if not torch.equal(bits(g), bits(w)):
            raise AssertionError(f"{what}: kernel != plain version "
                                 f"(max abs err {err})")
    return err


def random_state(rng, dev, shape=None):
    """Random decision inputs at ``shape`` (b, h, w), by default the main
    path's (B, H, W): integer caps with zeros, half the nodes active,
    heights spread over [0, 2N)."""
    from repro_torch.core.maxflow.ref import random_grid_problem
    nb, nh, nw = shape or (B, H, W)
    n_nodes = nh * nw + 2
    probs = [random_grid_problem(rng, nh, nw) for _ in range(nb)]
    cap = np.stack([p[0] for p in probs], axis=1)
    cs = np.stack([p[1] for p in probs])
    ct = np.stack([p[2] for p in probs])
    e = rng.integers(0, 20, (nb, nh, nw)) * (rng.random((nb, nh, nw)) < 0.5)
    h = rng.integers(0, 2 * n_nodes, (nb, nh, nw))
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    return (t(e, torch.float32), t(h, torch.int32), t(cap, torch.float32),
            t(cs, torch.float32), t(ct, torch.float32), n_nodes)


def assignment_weights() -> np.ndarray:
    """The assignment phase's ``(ASSIGN_B, n, n)`` int64 weights."""
    return np.random.default_rng(SEED).integers(
        0, 101, size=(ASSIGN_B, ASSIGN_N, ASSIGN_N))


def matching_adjacency() -> np.ndarray:
    """The matching phase's ``(MATCH_B, n, n)`` bool adjacencies."""
    from repro_torch.core.matching.ref import random_bipartite
    rng = np.random.default_rng(SEED)
    return np.stack([random_bipartite(rng, MATCH_N, MATCH_N, 4 / MATCH_N)
                     for _ in range(MATCH_B)])


def phase_kernels(dev, card: str) -> dict:
    """Each kernel against its plain version, bitwise (K6 within its
    tolerance), with timings."""
    from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                      grid_push_decide_sched)
    from repro_torch.kernels.grid_push.ops import tile_schedule, tile_shape
    from repro_torch.kernels.grid_push.ref import (grid_push_decide_ref,
                                                   grid_push_decide_sched_ref)
    rng = np.random.default_rng(SEED)
    e, h, cap, cs, ct, n_nodes = random_state(rng, dev)
    nodes = B * H * W
    out = {}

    # K1: 32 B in (e, h, 4 caps, 2 terminal caps), 28 B out (h_new, 6
    # deltas) per node; about 30 compare/select/min ops per node.
    args = (e, h, cap, cs, ct, n_nodes)
    err = compare(grid_push_decide(*args), grid_push_decide_ref(*args), "K1")
    b_ms, b_by = bound(60 * nodes, 30 * nodes)
    out["grid_push_decide"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: grid_push_decide(*args),
                  lambda: grid_push_decide_ref(*args), "grid_push_decide"))

    # K2: some tiles active, some not (whole 64x64 tiles of e zeroed).
    bh, bw = tile_shape(H, W)
    keep = torch.tensor(rng.random((B, H // bh, W // bw)) < 0.5, device=dev)
    keep = keep.repeat_interleave(bh, 1).repeat_interleave(bw, 2)
    e2 = torch.where(keep, e, torch.zeros_like(e))
    sched, n_act = tile_schedule(e2 > 0, bh, bw)
    args2 = (e2, h, cap, cs, ct, sched, n_act, n_nodes)
    kw = dict(block_h=bh, block_w=bw)
    got = grid_push_decide_sched(*args2, **kw)
    err = compare(got, grid_push_decide_sched_ref(*args2, bh, bw), "K2")
    compare(got, grid_push_decide(e2, h, cap, cs, ct, n_nodes), "K2 vs K1")
    # 256^2 alone (B = 1), as the checkerboard solve launches it: 16 tiles
    # of 64 x 64, some idle
    board_args, board_kw = k2_board_args(rng, dev)
    compare(grid_push_decide_sched(*board_args, **board_kw),
            grid_push_decide_sched_ref(*board_args, *board_kw.values()),
            "K2 256^2")
    compare(grid_push_decide_sched(*board_args, **board_kw),
            grid_push_decide(*board_args[:5], board_args[-1]),
            "K2 256^2 vs K1")
    active_nodes = int(n_act.sum()) * bh * bw
    # decided tiles move K1's 60 B per node; identity tiles read h and
    # write h_new and 6 zero deltas (32 B); plus the schedule itself
    b_ms, b_by = bound(60 * active_nodes + 32 * (nodes - active_nodes)
                       + 4 * (sched.numel() + n_act.numel()),
                       30 * active_nodes)
    row = out["grid_push_decide_sched"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        active_tiles=int(n_act.sum()), tiles=int(sched.numel()),
        **timings(lambda: grid_push_decide_sched(*args2, **kw),
                  lambda: grid_push_decide_sched_ref(*args2, bh, bw),
                  "grid_push_decide"))
    row["board_ms"] = took(row, "board_ms", time_ms(
        lambda: grid_push_decide_sched(*board_args, **board_kw),
        symbol="grid_push_decide"))
    # grid_push.cu's launch: one block per 256-node chunk of every tile of
    # every instance (the formula, not a reading of the launch)
    log(f"[kernels] K2 launch by grid_push.cu's formula: "
        f"{int(sched.numel()) * -(-bh * bw // 256)} blocks of 256 threads "
        f"at {B} x {H} x {W}, {-(-bh * bw // 256) * board_args[5].numel()} "
        f"at 1 x {CHECKERBOARD[0]} x {CHECKERBOARD[1]}")

    out["bfs_relabel_sweeps"] = kernels_k3(dev, cap, cs, ct, n_nodes)
    for row in out.values():
        row["library_ms"] = None   # no single PyTorch call computes K1-K3
    out.update(kernels_assignment_matching(dev))
    out.update(kernels_flash(dev))
    for name, row in out.items():
        lib = row["library_ms"]
        how = ("equal to" if row.get("equal", True)
               else f"within {row['tolerance']} of")
        log(f"[kernels] {name}: {how} plain, device {row['ms']:.4f} ms "
            f"(loop {row['loop_ms']:.4f} ms; plain device "
            f"{row['plain_ms']:.4f} ms, loop {row['plain_loop_ms']:.4f} ms; "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}) on {card}")
    return out


def k2_board_args(rng, dev):
    """K2's inputs at the checkerboard solve's shape, 1 x 256^2, with every
    other 64 x 64 tile idle."""
    from repro_torch.kernels.grid_push.ops import tile_schedule, tile_shape
    e, h, cap, cs, ct, n_nodes = random_state(rng, dev,
                                              (1, *CHECKERBOARD))
    bh, bw = tile_shape(*CHECKERBOARD)
    e.view(1, -1, bh, CHECKERBOARD[1] // bw, bw)[:, ::2, :, 1::2] = 0
    sched, n_act = tile_schedule(e > 0, bh, bw)
    return ((e, h, cap, cs, ct, sched, n_act, n_nodes),
            dict(block_h=bh, block_w=bw))


def k3_planes(cap, cs, ct, n_nodes, calls: int):
    """K3's seeds and the planes after ``calls`` plain calls of SWEEPS
    sweeps from them (so wavefronts cross tile edges in the next call)."""
    from repro_torch.core.maxflow.grid import INF_H
    from repro_torch.kernels.bfs_relabel.kernel import SWEEPS
    from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref
    seed_t = torch.where(ct > 0, 1, INF_H).to(torch.int32)
    seed_s = torch.where(cs > 0, n_nodes + 1, INF_H).to(torch.int32)
    dt, ds = seed_t, seed_s
    for _ in range(calls):
        dt, ds, _ = bfs_relabel_sweeps_ref(cap, seed_t, seed_s, dt, ds,
                                           sweeps=SWEEPS)
    return seed_t, seed_s, dt, ds


def k3_bound(nodes: int, with_ds: bool) -> tuple[float, str]:
    """K3's bound per call of SWEEPS sweeps: caps, seeds and planes read
    once, planes written once, 40 B per node (28 B with ds off); the
    sweeps' integer work, about 18 ops per node, sweep and plane."""
    from repro_torch.kernels.bfs_relabel.kernel import SWEEPS
    planes = 2 if with_ds else 1
    return bound((12 * planes + 16) * nodes, 18 * planes * SWEEPS * nodes)


def kernels_k3(dev, cap, cs, ct, n_nodes) -> dict:
    """K3 against its plain version, bitwise (planes and ``changed``), at
    the grid path's 4 x 512^2 and at the checkerboard's 1 x 256^2: from the
    seeds, from mid-fixpoint planes, for 1, 3, SWEEPS and 20 sweeps (20
    takes three launches), with ds on and off; then every tile shape of
    ``TILES`` at both shapes. Times the SWEEPS-sweep call with both planes
    from the seeds (the balanced relabel's first call) and the tile
    shapes."""
    from repro_torch.core.maxflow.ref import checkerboard_problem
    from repro_torch.kernels.bfs_relabel.kernel import (
        SWEEPS, TILES, _sweeps, bfs_relabel_sweeps, launch_geometry)
    from repro_torch.kernels.bfs_relabel.ref import bfs_relabel_sweeps_ref

    def check(args, sweeps, what, tiles=None):
        return compare(_sweeps(*args, sweeps, tiles),
                       bfs_relabel_sweeps_ref(*args, sweeps=sweeps), what)

    bc, bs, bt = (torch.tensor(a, device=dev).unsqueeze(a.ndim - 2)
                  for a in checkerboard_problem(*CHECKERBOARD))
    shapes = {"batch": (cap, cs, ct, n_nodes),
              "board": (bc, bs, bt, CHECKERBOARD[0] * CHECKERBOARD[1] + 2)}
    err, inputs = 0.0, {}
    for name, (c, s_, t_, n) in shapes.items():
        for calls in (0, 3):
            seed_t, seed_s, dt, ds = k3_planes(c, s_, t_, n, calls)
            for sweeps in (1, 3, SWEEPS, 20):
                what = f"K3 {name} after {calls} calls, {sweeps} sweeps"
                err = max(err, check((c, seed_t, seed_s, dt, ds), sweeps,
                                     what))
                check((c, seed_t, None, dt, None), sweeps, what + " ds off")
        inputs[name] = (c,) + k3_planes(c, s_, t_, n, 0)[:2] * 2
    args3 = inputs["batch"]
    row = timings(lambda: bfs_relabel_sweeps(*args3),
                  lambda: bfs_relabel_sweeps_ref(*args3, sweeps=SWEEPS),
                  "bfs_relabel_sweep")
    tiles_ms = {}
    for tiles in TILES:
        key = "{}x{}".format(*tiles)
        tiles_ms[key] = {}
        for name, args in inputs.items():
            check(args, SWEEPS, f"K3 {name} tiles {key}", tiles)
            tiles_ms[key][name] = took(
                row, f"tiles_ms.{key}.{name}",
                time_ms(lambda: _sweeps(*args, SWEEPS, tiles),
                        symbol="bfs_relabel_sweep"))
        log(f"[kernels] K3 tiles {key}: batch {tiles_ms[key]['batch']:.4f} "
            f"ms, board {tiles_ms[key]['board']:.4f} ms")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, args in inputs.items():
        log(f"[kernels] K3 {name} launch as launch_geometry picks it: "
            f"{launch_geometry(*args[1].shape, SWEEPS, True, n_sm)}")
    b_ms, b_by = k3_bound(cap[0].numel(), True)
    board_ms = took(row, "board_ms",
                    time_ms(lambda: bfs_relabel_sweeps(*inputs["board"]),
                            symbol="bfs_relabel_sweep"))
    board_bound = k3_bound(bc[0].numel(), True)[0]
    log(f"[kernels] K3 board: device {board_ms:.4f} ms against its bound "
        f"{board_bound:.4f} ms ({board_ms / board_bound:.2f}x)")
    return dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                sweeps_per_call=SWEEPS, tiles_ms=tiles_ms,
                board_ms=board_ms, **row)


def k4_k5_inputs(dev):
    """K4's and K5's inputs at the assignment and matching phases' shapes,
    from one generator, K4's draws first: ``(c, p_y, mask)`` and
    ``{share: (adj, root_row, match_row)}`` over ``K5_SHARES``.

    K4: the assignment phase's scaled costs, random prices, a fifth of the
    arcs masked (fixed or matched) and every 64th row fully masked. K5:
    the matching phase's graphs with ``share`` of the rows labeled (a
    solve's sweeps run from 2% to 96%), roots drawn from the rows, random
    matched columns; half labeled, the row's main input, is drawn first
    (the input of every earlier reading)."""
    from repro_torch.kernels.frontier.ref import INF
    rng = np.random.default_rng(SEED + 1)
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    B, n = ASSIGN_B, ASSIGN_N
    c = t(-(n + 1) * assignment_weights(), torch.int32)
    p_y = t(rng.integers(-(n + 1) * 100, 1, (B, n)), torch.int32)
    m = rng.random((B, n, n)) < 0.2
    m[:, ::64] = True
    B, n = MATCH_B, MATCH_N
    adj = t(matching_adjacency(), torch.bool)
    k5 = {}
    for share in K5_SHARES:
        labeled = rng.random((B, n)) < share
        root = t(np.where(labeled, rng.integers(0, n, (B, n)), INF),
                 torch.int32)
        k5[share] = (adj, root, t(rng.integers(-1, n, (B, n)), torch.int32))
    return (c, p_y, t(m, torch.bool)), k5


def kernels_assignment_matching(dev) -> dict:
    """K4 and K5 against their plain versions at the assignment and
    matching phases' shapes (``k4_k5_inputs``), bitwise, with timings,
    L2-warm and L2-cold (K5 at each share of labeled rows), and the
    one-call PyTorch yardstick of each (``library_ms``, timed only)."""
    from repro_torch.kernels.bidding.kernel import bidding
    from repro_torch.kernels.bidding.ref import INF, bidding_ref
    from repro_torch.kernels.frontier.kernel import (
        frontier, launch_geometry, max_active_clusters)
    from repro_torch.kernels.frontier.ref import frontier_ref
    out = {}
    args, inputs = k4_k5_inputs(dev)
    c, p_y, mask = args
    B, n = ASSIGN_B, ASSIGN_N
    k4_geometry(args)
    err = compare(bidding(*args), bidding_ref(*args), "K4")
    masked = torch.where(mask, INF, c - p_y[:, None, :])
    b_ms, b_by = k4_bound()
    row = out["bidding"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: bidding(*args), lambda: bidding_ref(*args),
                  "bidding_kernel"))
    row["library_ms"] = took(row, "library_ms", time_ms(
        lambda: torch.topk(masked, 2, dim=-1, largest=False)))
    row["cold_ms"] = took(row, "cold_ms", time_cold_ms(
        lambda: bidding(*args), "bidding_kernel"))
    log(f"[kernels] K4 L2-warm {row['ms']:.4f} ms, L2-cold "
        f"{row['cold_ms']:.4f} ms; bound {b_ms:.4f} ms")

    B, n = MATCH_B, MATCH_N
    err = max(compare(frontier(*a), frontier_ref(*a), f"K5 {share:.0%}")
              for share, a in inputs.items())
    args5 = inputs[0.5]
    adj, root, match = args5
    rows = torch.arange(n, device=dev, dtype=torch.int64)
    cand = (adj & (root < INF)[..., None]
            & (match[..., None] != torch.arange(n, device=dev)))
    key = torch.where(cand, (root.to(torch.int64)[..., None] << 32)
                      | rows[:, None], torch.iinfo(torch.int64).max)
    labeled = int((root < INF).sum())
    b_ms, b_by = k5_bound(labeled, launches=1)
    row = out["frontier"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        labeled_rows=labeled, rows=B * n,
        **timings(lambda: frontier(*args5), lambda: frontier_ref(*args5),
                  "frontier_"))
    row["library_ms"] = took(row, "library_ms",
                             time_ms(lambda: torch.min(key, dim=-2)))
    # the labeled rows' adjacency fits in the 50 MB L2 across the repeated
    # calls of the time above; time it from cold too
    row["cold_ms"] = took(row, "cold_ms", time_cold_ms(
        lambda: frontier(*args5), "frontier_"))
    g = launch_geometry(B, n, n, True)
    log(f"[kernels] K5 launch as launch_geometry picks it: {g}; the card "
        f"holds {max_active_clusters(g)} such clusters at once, the grid "
        f"has {g.grid[0] * g.grid[1] // g.cluster}")
    row["regimes"] = {}
    for share, a in inputs.items():
        labeled = int((a[1] < INF).sum())
        name = f"{share:.2f}"
        if share == 0.5:
            warm, cold = row["ms"], row["cold_ms"]
        else:
            warm = took(row, f"regimes.{name}.ms",
                        time_ms(lambda: frontier(*a), symbol="frontier_"))
            cold = took(row, f"regimes.{name}.cold_ms", time_cold_ms(
                lambda: frontier(*a), "frontier_"))
        row["regimes"][name] = dict(labeled_rows=labeled, ms=warm,
                                    cold_ms=cold)
        bound_share = k5_bound(labeled, launches=1)[0]
        log(f"[k5] {labeled} of {B * n} rows labeled ({share:.0%}): "
            f"L2-warm {warm:.4f} ms, L2-cold {cold:.4f} ms "
            f"({L2_FLUSH_BYTES >> 20} MB written before each call); bound "
            f"{bound_share:.4f} ms by bytes ({bound_share / warm:.0%} / "
            f"{bound_share / cold:.0%} of it)")
    return out


def k4_bound() -> tuple[float, str]:
    """K4's least time for one call at the assignment phase's shape: c and
    mask read once (5 B per entry), p_y read and 3 outputs written (16 B
    per row); about 4 integer ops per entry."""
    B, n = ASSIGN_B, ASSIGN_N
    return bound(5 * B * n * n + 16 * B * n, 4 * B * n * n)


def k4_geometry(args):
    """Log K4's launch at the assignment phase's shape as
    ``launch_geometry`` picks it for these tensors; it must be the vector
    path."""
    from repro_torch.kernels.bidding.kernel import (aligned_for_vectors,
                                                    launch_geometry)
    *batch, n_r, n_c = args[0].shape
    g = launch_geometry(int(np.prod(batch)), n_r, n_c,
                        aligned_for_vectors(*args))
    log(f"[kernels] K4 launch as launch_geometry picks it: {g}")
    if not g.vec:
        raise AssertionError(f"K4 at {tuple(args[0].shape)}: the scalar "
                             f"path, not the vector path: {g}")
    return g


def k5_bound(reads: int, launches: int) -> tuple[float, str]:
    """K5's least time over ``launches`` calls at the matching phase's
    shape that read ``reads`` labeled rows in all: each labeled row's
    adjacency once (1 B per entry; no other row is needed), both row
    labels (8 B per row) and both outputs (8 B per column) once per call;
    about 4 ops per entry read."""
    need = reads * MATCH_N
    return bound(need + 16 * launches * MATCH_B * MATCH_N, 4 * need)


def flash_inputs(rng, dims, dtype, dev):
    """Random normal q, k, v of the sweep's ``(B, Sq, Sk, H, KV, dh, dv)``."""
    B, Sq, Sk, H, KV, dh, dv = dims
    return tuple(torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                              device=dev).to(dtype)
                 for shape in ((B, Sq, H, dh), (B, Sk, KV, dh),
                               (B, Sk, KV, dv)))


def flash_bounds(dims, causal: bool, dtype) -> dict:
    """K6's least time at ``dims``: its work as ``repro_torch.roofline``
    counts it (q, k, v read and o written once, 2*dh + 2*dv flops per
    (query, key) pair, pos_q >= pos_k when causal) at the rate of the units
    the kernel runs them on (float32: three TF32 products each; bfloat16:
    one bf16 product), and at the FFMA rate the first design ran on
    (``ffma_ms``). The bounds of the shapes in K6_BOUNDS_MS must not
    move."""
    from repro_torch.roofline import flash_attention_work
    B, Sq, Sk, H, KV, dh, dv = dims
    pairs, flops, nbytes = flash_attention_work(
        B, Sq, Sk, H, KV, dh, dv, causal=causal,
        itemsize=4 if dtype == torch.float32 else 2)
    if dtype == torch.float32:
        b_ms, b_by = bound(nbytes, 3 * flops, TF32_OPS_PER_S)
    else:
        b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
    want = K6_BOUNDS_MS.get((dims, causal, dtype))
    if want is not None and b_ms != want:
        raise AssertionError(f"K6's bound at {dims} moved: {b_ms} ms, "
                             f"{want} ms before")
    return dict(bound_ms=b_ms, bound_by=b_by, causal_pairs=pairs,
                ffma_ms=bound(nbytes, flops)[0])


def kernels_flash(dev) -> dict:
    """K6 against its plain version over FLASH_SWEEP, FLASH_TAILS, at the
    serve path's prefill shape in float32 and bfloat16, at phi's and
    deepseek's prefill shapes and at hubert's forward and train step
    shapes (non-causal; the train step's backward reads the lse), output
    within FLASH_TOL and lse within LSE_TOL, with timings and
    ``F.scaled_dot_product_attention`` (causal, GQA, on the head-major
    views) as its one-call yardstick, timed only."""
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, launch_geometry)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(SEED + 2)
    cfg = get_config(SERVE_ARCH)
    serve = (SERVE_B, SERVE_S, SERVE_S, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
             cfg.dh)
    mcfg = get_config(MOE_ARCH)
    moe = (SERVE_B, SERVE_S, SERVE_S, mcfg.n_heads, mcfg.n_kv_heads,
           mcfg.dh, mcfg.dh)
    dcfg = get_config(MLA_ARCH)
    mla = (SERVE_B, SERVE_S, SERVE_S, dcfg.n_heads, dcfg.n_kv_heads,
           dcfg.mla.qk_nope_dim + dcfg.mla.qk_rope_dim, dcfg.mla.v_dim)
    hubert = encoder_attention_shape(ENC_B)
    routed = {moe: True, mla: True, hubert: False}
    cases = FLASH_SWEEP + FLASH_TAILS + [(moe, True, torch.float32),
                                         (mla, True, torch.float32),
                                         (hubert, False, torch.float32),
                                         (encoder_attention_shape(
                                             ENC_TRAIN_B), False,
                                          torch.float32),
                                         (serve, True, torch.bfloat16),
                                         (serve, True, torch.float32)]
    sweep, shapes = [], {}
    for dims, causal, dtype in cases:
        q, k, v = flash_inputs(rng, dims, dtype, dev)
        got = flash_attention_fwd(q, k, v, causal=causal)
        want, want_lse = flash_attention_ref(q, k, v, causal=causal,
                                             return_lse=True)
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError(f"K6 {dims}: {got.dtype} {got.shape}")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= FLASH_TOL[dtype]:
            raise AssertionError(f"K6 {dims} causal={causal} {dtype}: max "
                                 f"abs err {err} > {FLASH_TOL[dtype]}")
        got2, lse = flash_attention_fwd(q, k, v, causal=causal,
                                        return_lse=True)
        lse_err = (lse - want_lse).abs().max().item()
        same = torch.equal(got2, got)
        if not same or lse.dtype != torch.float32 or not lse_err <= LSE_TOL:
            raise AssertionError(f"K6 {dims} causal={causal} {dtype} with "
                                 f"its lse: lse max abs err {lse_err} "
                                 f"(tolerance {LSE_TOL}); output equal to "
                                 f"the call without: {same}")
        del got2, lse, want_lse
        sweep.append(dict(dims=list(dims), causal=causal,
                          dtype=str(dtype).split(".")[1], max_abs_err=err,
                          lse_max_abs_err=lse_err))
        log(f"[kernels] K6 {dims} causal={causal} {dtype}: max abs err "
            f"{err:.3g} (tolerance {FLASH_TOL[dtype]}); lse {lse_err:.3g} "
            f"(tolerance {LSE_TOL}), output unchanged by it")
        if dims in routed:
            shapes[dims] = kernels_flash_at(dims, routed[dims], q, k, v,
                                            want, err)
            del q, k, v, want
            continue
        if dims == serve and dtype == torch.bfloat16:
            bf16 = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True),
                           symbol="flash_fwd_")
            bf16_bound = flash_bounds(dims, True, dtype)
            log(f"[kernels] K6 bfloat16 at the serve shape: device "
                f"{bf16.ms:.4f} ms, bound {bf16_bound['bound_ms']:.4f} ms by "
                f"{bf16_bound['bound_by']}")
    geo = launch_geometry(serve[0], serve[1], serve[3], serve[5], serve[6])
    log(f"[kernels] K6 serve launch as launch_geometry picks it: {geo}")
    b = flash_bounds(serve, True, torch.float32)
    log(f"[kernels] K6 serve bounds: {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} (split TF32), {b['ffma_ms']:.4f} ms at the FFMA "
        f"rate")
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2) - want).abs().max().item()
    log(f"[kernels] K6 yardstick scaled_dot_product_attention: max abs "
        f"diff {lib_err:.3g} from the plain version (timed only)")
    row = dict(equal=False, tolerance=FLASH_TOL[torch.float32],
               max_abs_err=sweep[-1]["max_abs_err"], bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], causal_pairs=b["causal_pairs"],
               sweep=sweep,
               **timings(lambda: flash_attention_fwd(q, k, v, causal=True),
                         lambda: flash_attention_ref(q, k, v, causal=True),
                         "flash_fwd_"))
    row["bf16_ms"] = took(row, "bf16_ms", bf16)
    row["lse_ms"] = took(row, "lse_ms", time_ms(
        lambda: flash_attention_fwd(q, k, v, causal=True, return_lse=True),
        symbol="flash_fwd_"))
    log(f"[kernels] K6 at the serve shape with its lse output: device "
        f"{row['lse_ms']:.4f} ms, without {row['ms']:.4f} ms")
    row["library_ms"] = took(row, "library_ms", time_ms(library))
    row["moe_shape"], row["mla_shape"] = shapes[moe], shapes[mla]
    row["hubert_shape"] = shapes[hubert]
    return {"flash_attention_fwd": row}


def encoder_attention_shape(batch: int) -> tuple:
    """K6's ``(B, Sq, Sk, H, KV, dh, dv)`` in hubert-xlarge at ``batch`` x
    ENC_S frames (non-causal, MHA)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(ENCODER_ARCH)
    return (batch, ENC_S, ENC_S, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
            cfg.dh)


def kernels_flash_at(dims, causal: bool, q, k, v, want, err) -> dict:
    """K6 at a routed serve path's prefill shape, float32, causal
    (phi3.5-moe: 32 heads over 8 kv heads of 128; deepseek-v2's MLA: 128
    heads, qk 192, v 128, scale 192 ** -0.5), or at the encoder's forward
    shape, non-causal (hubert-xlarge: 16 heads of 80), already held to its
    plain version in ``kernels_flash``: its launch geometry, device ms,
    the plain version's and ``F.scaled_dot_product_attention``'s, and its
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_fwd, launch_geometry)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    geo = launch_geometry(dims[0], dims[1], dims[3], dims[5], dims[6])
    b = flash_bounds(dims, causal, torch.float32)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2) - want).abs().max().item()
    row = dict(dims=list(dims), causal=causal, max_abs_err=err,
               bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               causal_pairs=b["causal_pairs"],
               **timings(lambda: flash_attention_fwd(q, k, v, causal=causal),
                         lambda: flash_attention_ref(q, k, v, causal=causal),
                         "flash_fwd_"))
    row["library_ms"] = took(row, "library_ms", time_ms(library))
    log(f"[kernels] K6 at the shape {dims} causal={causal}: launch {geo}; "
        f"device {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {row['library_ms']:.4f} ms, max abs "
        f"diff {lib_err:.3g} from the plain version), bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} (split TF32), "
        f"{b['ffma_ms']:.4f} ms at the FFMA rate")
    return row


def timings(kernel, plain, symbol: str) -> dict:
    """Device and loop ms per call of a kernel's wrapper, whose kernel's
    name holds ``symbol``, and of its plain version (see ``time_ms``), with
    where each device ms came from (``ms_from``)."""
    k, p = time_ms(kernel, symbol=symbol), time_ms(plain)
    return dict(ms=k.ms, plain_ms=p.ms, loop_ms=k.loop_ms,
                plain_loop_ms=p.loop_ms,
                ms_from={"ms": k.source, "plain_ms": p.source})


def counters():
    from repro_torch.kernels.bfs_relabel.kernel import bfs_relabel_sweeps
    from repro_torch.kernels.bidding.kernel import bidding
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.frontier.kernel import frontier
    from repro_torch.kernels.grid_push.kernel import (grid_push_decide,
                                                      grid_push_decide_sched)
    return {f.__name__: f for f in (grid_push_decide, grid_push_decide_sched,
                                    bfs_relabel_sweeps, bidding, frontier,
                                    flash_attention_fwd)}


def reset_counts():
    for f in counters().values():
        f.launches = 0
    counters()["bfs_relabel_sweeps"].sweeps = 0


def read_counts() -> dict:
    """Launches per kernel, and K3's sweeps under ``K3_SWEEPS``."""
    got = {name: f.launches for name, f in counters().items()}
    got[K3_SWEEPS] = counters()["bfs_relabel_sweeps"].sweeps
    return got


def require_launched(counts: dict, names, phase: str):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{phase}: {name} was never launched")


def require_not_launched(counts: dict, names, phase: str):
    for name in names:
        if counts[name] != 0:
            raise AssertionError(f"{phase}: {name} was launched "
                                 f"{counts[name]} times")


def require_same(a: dict, b: dict, what: str):
    """Every leaf of two ``to_numpy`` results equal, dtypes included
    (nested dicts too)."""
    for key, v in a.items():
        if isinstance(v, dict):
            require_same(v, b[key], f"{what}.{key}")
        elif (v is None) != (b[key] is None) or (v is not None and (
                v.dtype != b[key].dtype or not np.array_equal(v, b[key]))):
            raise AssertionError(f"{what}: results differ in {key}")


def solve(fn, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def profile(what: str, wall: float, fn, *a, top: int = 8,
            split: bool = False, **kw) -> dict:
    """One more run of ``fn`` under ``torch.profiler`` (``traced``, after
    its primer), tracing the device alone: device busy time (the sum of
    every device op's own time), the ops that take most of it, the port's
    own kernels (their time inside the solve) and the gathers' and
    scatters' (``GATHER_SCATTER_KERNELS``), summed from the raw trace
    (``trace_device_events``). The idle share divides busy by ``wall``,
    the unprofiled solve's time, since the profiler slows the host.
    Outside the counted runs. Returns the busy seconds, the idle share,
    the number of device ops (kernels, copies, memsets),
    ``{kernel: (ms, launches)}`` of the port's kernels and the gathers'
    and scatters' ms."""
    primed, events, (_, secs) = traced(lambda: solve(fn, *a, **kw))
    rows = trace_device_events(events)
    busy = sum(r[0] for r in rows) / 1e6
    union = device_union_s(events)
    launches = sum(r[1] for r in rows)
    gather_ms = sum(r[0] for r in rows
                    if any(k in r[2] for k in GATHER_SCATTER_KERNELS)) / 1e3
    log(f"[profile] {what}: wall {wall:.4f} s unprofiled ({secs:.4f} s "
        f"profiled), device busy {busy:.4f} s, idle share "
        f"{1 - busy / wall:.3f}, {launches} device ops ({primed} of "
        f"the {TRACE_PRIMER_OPS} primer ops before it recorded)")
    for us, count, key in rows[:top]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")
    port = {}
    for us, count, key in rows:
        if key.startswith(PORT_KERNEL_SYMBOLS):
            name = key.split("::", 1)[1].split("(")[0].split("<")[0]
            ms, n = port.get(name, (0.0, 0))
            port[name] = (ms + us / 1e3, n + count)
    for name, (ms, count) in port.items():
        log(f"[profile]   port kernel {name}: {ms:.3f} ms over {count} "
            f"launches, {ms / count:.4f} ms each")
    out = dict(busy_s=busy, idle_share=1 - busy / wall, launches=launches,
               port_kernels=port, gather_scatter_ms=gather_ms, union_s=union)
    if split:
        out["split_ms"] = device_split(rows)
        log(f"[profile]   device ms by kernel name: "
            + ", ".join(f"{k} {v:.3f}" for k, v in out["split_ms"].items()))
    return out


def check_oracle(res, oracle, what: str, invariant: bool = True):
    """Converged, oracle flows and (fixed cadence) no violating edge. The
    balanced backend's bidirectional relabel can leave an edge from a
    source-reachable node into a doubly unreached one violating the
    invariant at the end of a solve, in the reference as in the port, so
    it is not checked there."""
    from repro_torch.core.maxflow.grid import check_no_violations
    if not bool(res.converged.all()):
        raise AssertionError(f"{what}: not converged")
    flows = res.flow.reshape(-1).tolist()
    if flows != [float(f) for f in oracle]:
        raise AssertionError(f"{what}: flows {flows} != oracle {oracle}")
    if invariant and not bool(check_no_violations(res.state).all()):
        raise AssertionError(f"{what}: height invariant violated")


def phase_main(dev, problems, oracle, counts: dict):
    """Fixed cadence: pallas and xla on the batch, every leaf equal."""
    from repro_torch.core.maxflow.grid import GridProblem, maxflow_grid_batch
    from repro_torch.interop import to_numpy
    prob = GridProblem(*(np.stack([p[k] for p in problems]) for k in range(3)))
    results, walls = {}, {}
    for backend in ("pallas", "xla"):
        reset_counts()
        res, walls[backend] = solve(maxflow_grid_batch, prob,
                                    backend=backend, device=dev)
        counts[backend] = read_counts()
        check_oracle(res, oracle, backend)
        results[backend] = to_numpy(res)
        log(f"[main] backend={backend}: flows {res.flow.tolist()}, rounds "
            f"{res.rounds.tolist()}, heuristics {res.heuristics.tolist()}, "
            f"{walls[backend]:.4f} s, launches {counts[backend]}")
    require_launched(counts["pallas"], ["grid_push_decide",
                                        "bfs_relabel_sweeps"], "pallas")
    require_launched(counts["xla"], ["bfs_relabel_sweeps"], "xla")
    in_solve = {}
    for backend in ("pallas", "xla"):
        prof = profile(f"backend={backend} batch", walls[backend],
                       maxflow_grid_batch, prob, backend=backend, device=dev)
        in_solve[backend] = grid_in_solve(backend, prof, counts[backend],
                                          B * H * W, with_ds=False)
    require_same(results["pallas"], results["xla"], "pallas vs xla")
    return prob, in_solve


def phase_balanced(dev, prob, oracle, counts: dict):
    """Balanced backend: the batch against the oracle, then the
    checkerboard against the JAX package's counts. Each of the two solves
    has its own launch counts."""
    from repro_torch.core.maxflow.grid import (GridProblem, maxflow_grid,
                                               maxflow_grid_batch)
    from repro_torch.core.maxflow.ref import checkerboard_problem
    balanced = ["grid_push_decide_sched", "bfs_relabel_sweeps"]
    reset_counts()
    res, batch_wall = solve(maxflow_grid_batch, prob, backend="balanced",
                            device=dev)
    counts["balanced_batch"] = read_counts()
    check_oracle(res, oracle, "balanced", invariant=False)
    log(f"[balanced] batch: flows {res.flow.tolist()}, rounds "
        f"{res.rounds.tolist()}, heuristics {res.heuristics.tolist()}, "
        f"{batch_wall:.4f} s, launches {counts['balanced_batch']}")
    require_launched(counts["balanced_batch"], balanced, "balanced batch")

    board = GridProblem(*checkerboard_problem(*CHECKERBOARD))
    reset_counts()
    res, board_wall = solve(maxflow_grid, board, backend="balanced",
                            max_rounds=500_000, device=dev)
    counts["balanced_checkerboard"] = read_counts()
    got = (float(res.flow), int(res.rounds), int(res.heuristics))
    log(f"[balanced] checkerboard {CHECKERBOARD}: flow, rounds, heuristics "
        f"= {got}, {board_wall:.4f} s, launches "
        f"{counts['balanced_checkerboard']}")
    if got != CHECKERBOARD_WANT or not bool(res.converged):
        raise AssertionError(f"checkerboard {CHECKERBOARD}: {got} != "
                             f"{CHECKERBOARD_WANT}")
    require_launched(counts["balanced_checkerboard"], balanced,
                     "balanced checkerboard")
    prof = profile("backend=balanced batch", batch_wall, maxflow_grid_batch,
                   prob, backend="balanced", device=dev)
    in_solve = {"balanced_batch": grid_in_solve(
        "balanced_batch", prof, counts["balanced_batch"], B * H * W,
        with_ds=True)}
    prof = profile(f"backend=balanced checkerboard {CHECKERBOARD}",
                   board_wall, maxflow_grid, board, backend="balanced",
                   max_rounds=500_000, device=dev)
    in_solve["balanced_checkerboard"] = grid_in_solve(
        "balanced_checkerboard", prof, counts["balanced_checkerboard"],
        CHECKERBOARD[0] * CHECKERBOARD[1], with_ds=True)
    return in_solve


def grid_in_solve(what: str, prof: dict, counts: dict, nodes: int,
                  with_ds: bool) -> dict:
    """The port's kernels inside one profiled grid solve: device ms,
    launches and ms per launch; for K3 also the solve's sweeps (from the
    counters of its unprofiled run) and the bound per call (``k3_bound``:
    the sink-only ``bfs_heights`` relaxes ``dt`` alone, the balanced
    relabel both planes), which is logged and not returned. Adds the
    solve's busy seconds and idle share."""
    out = dict(busy_s=prof["busy_s"], idle_share=prof["idle_share"])
    for name, (ms, n) in prof["port_kernels"].items():
        out[name] = dict(ms=ms, launches=n, ms_per_launch=ms / n)
        if name.startswith("bfs_relabel_sweep"):
            b_ms = k3_bound(nodes, with_ds)[0]
            out[name]["sweeps"] = counts[K3_SWEEPS]
            log(f"[k3] {what}: {counts['bfs_relabel_sweeps']} launches, "
                f"{counts[K3_SWEEPS]} sweeps; {ms:.3f} ms in the solve, "
                f"{ms / n:.4f} ms per launch against {b_ms:.4f} ms per call "
                f"({ms / n / b_ms:.2f}x the bound)")
    return out


def solve_in_turns(what: str, dev, counts: dict, check, fn, *a,
                   **kw) -> dict:
    """Solve with ``backend="pallas"``, ``"xla"``, ``"xla"``, ``"pallas"``,
    in turns, so host drift over the four solves hits both backends alike,
    after one uncounted warm-up solve of the first instance per backend.

    Before each solve the launch counts are set to 0 and just after it
    they are read: the first solve of a backend records them under
    ``counts[f"{what}_{backend}"]``, and the second must launch the same.
    ``check(solve_id, res)`` runs on every result; the second result of a
    backend must equal its first on every leaf, and ``pallas`` must equal
    ``xla``. Then each backend is profiled once (``profile``) against the
    mean of its two unprofiled walls. Returns ``{backend: [wall, wall]}``
    and ``{backend: profile}``.
    """
    from repro_torch.interop import to_numpy
    for backend in ("pallas", "xla"):   # warm-up: loads the kernels used
        solve(fn, *(x[:1] for x in a), backend=backend, device=dev, **kw)
    results, walls = {}, {"pallas": [], "xla": []}
    for backend in ("pallas", "xla", "xla", "pallas"):
        solve_id = f"{what}_{backend}"
        reset_counts()
        res, wall = solve(fn, *a, backend=backend, device=dev, **kw)
        got = read_counts()
        log(f"[{what}] {backend}: {wall:.4f} s, launches {got}")
        check(solve_id, res)
        if solve_id in counts:
            if got != counts[solve_id]:
                raise AssertionError(f"{solve_id}: launches {got} != first "
                                     f"solve's {counts[solve_id]}")
            require_same(to_numpy(res), results[backend], f"{solve_id} rerun")
        counts.setdefault(solve_id, got)
        results.setdefault(backend, to_numpy(res))
        walls[backend].append(wall)
    require_same(results["pallas"], results["xla"], what)
    profiles = {backend: profile(f"{what} {backend}",
                                 sum(walls[backend]) / 2, fn, *a,
                                 backend=backend, device=dev, **kw)
                for backend in ("pallas", "xla")}
    return walls, profiles


def phase_assignment(dev, counts: dict) -> dict:
    """``solve_assignment`` on ASSIGN_B x n^2 weights for both methods on
    both backends: scipy's optimal weights, the JAX package's rounds,
    ``pallas`` equal to ``xla`` on every leaf, K4 on ``pallas`` only and
    on its vector path in every launch (a hook on the wrapper's
    ``launch_geometry``, restored after). Returns K4's device time in each
    method's profiled ``pallas`` solve: ms, launches, ms per launch and
    the bound per launch (``k4_bound``)."""
    from repro_torch.core.assignment.cost_scaling import solve_assignment
    from repro_torch.core.assignment.ref import optimal_weight
    from repro_torch.kernels.bidding import kernel as bidk
    w = assignment_weights()
    optimum = [optimal_weight(x) for x in w]
    log(f"[assignment] scipy optimal weights {optimum}")
    in_solve = {}
    geometry, paths = bidk.launch_geometry, set()

    def recorded(*a):
        g = geometry(*a)
        paths.add("vector" if g.vec else "scalar")
        return g
    for method in ("auction", "pushrelabel"):
        def check(solve_id, res):
            log(f"[{solve_id}] weights {res.weight.tolist()}, rounds "
                f"{res.rounds.tolist()}")
            if not bool(res.converged.all()):
                raise AssertionError(f"{solve_id}: not converged")
            if res.weight.tolist() != optimum:
                raise AssertionError(f"{solve_id}: weights != scipy")
            if tuple(res.rounds.tolist()) != ASSIGN_ROUNDS_WANT[method]:
                raise AssertionError(f"{solve_id}: rounds != JAX package's "
                                     f"{ASSIGN_ROUNDS_WANT[method]}")

        what = f"assignment_{method}"
        bidk.launch_geometry = recorded
        try:
            _, profiles = solve_in_turns(what, dev, counts, check,
                                         solve_assignment, w, method=method)
        finally:
            bidk.launch_geometry = geometry
        require_launched(counts[f"{what}_pallas"], ["bidding"], what)
        require_not_launched(counts[f"{what}_xla"], ["bidding"], what)
        if paths != {"vector"}:
            raise AssertionError(f"{what}: K4 took the paths {paths}, not "
                                 f"the vector path alone")
        ms, n = profiles["pallas"]["port_kernels"]["bidding_kernel"]
        b_ms = k4_bound()[0]
        in_solve[method] = dict(ms=ms, launches=n, ms_per_launch=ms / n,
                                bound_ms_per_launch=b_ms)
        log(f"[k4] {what} pallas: {n} bidding_kernel kernels in the "
            f"profiled solve ({counts[f'{what}_pallas']['bidding']} launches "
            f"counted in the first), K4 device {ms:.4f} ms per "
            f"profiled solve, {ms / n:.4f} per launch against a bound of "
            f"{b_ms:.4f} ms per launch ({b_ms / (ms / n):.0%} of it); "
            f"bound {b_ms * n:.4f} ms per solve")
    return in_solve


def phase_matching(dev, counts: dict) -> dict:
    """``match_bipartite_batch`` on MATCH_B graphs of n^2 on both backends:
    Hopcroft-Karp's cardinalities, the JAX package's phases, the backends
    equal on every leaf, K5 on ``pallas`` only, once per frontier sweep
    (``K5_READS_WANT``: launches in the solve, device kernels in its
    profile, and the labeled rows they read, from ``k5_reads``). Returns
    the walls and K5's device time in the profiled ``pallas`` solve."""
    from repro_torch.core.matching import hopcroft_karp, match_bipartite_batch
    adj = matching_adjacency()
    oracle = [hopcroft_karp(a)[2] for a in adj]
    log(f"[matching] Hopcroft-Karp cardinalities {oracle}")

    def check(solve_id, res):
        log(f"[{solve_id}] cardinalities {res.cardinality.tolist()}, phases "
            f"{res.rounds.tolist()}")
        if not bool(res.converged.all()):
            raise AssertionError(f"{solve_id}: not converged")
        if res.cardinality.tolist() != oracle:
            raise AssertionError(f"{solve_id}: cardinalities != oracle")
        if tuple(res.rounds.tolist()) != MATCH_ROUNDS_WANT:
            raise AssertionError(f"{solve_id}: phases != JAX package's "
                                 f"{MATCH_ROUNDS_WANT}")

    walls, profiles = solve_in_turns("matching", dev, counts, check,
                                     match_bipartite_batch, adj)
    require_launched(counts["matching_pallas"], ["frontier"], "matching")
    require_not_launched(counts["matching_xla"], ["frontier"], "matching")
    k5 = {name: v for name, v in profiles["pallas"]["port_kernels"].items()
          if name.startswith("frontier_")}
    ms, kernels = (sum(v[i] for v in k5.values()) for i in range(2))
    launches, reads = k5_reads(dev, adj, check)
    if (launches, reads) != K5_READS_WANT or kernels != launches:
        raise AssertionError(
            f"matching pallas: K5 ran {launches} launches reading {reads} "
            f"labeled rows ({kernels} frontier_ kernels in the profiled "
            f"solve), not {K5_READS_WANT}")
    b_ms = k5_bound(reads, launches)[0]
    log(f"[k5] matching pallas: {launches} launches, {reads} labeled-row "
        f"reads ({reads / launches / (MATCH_B * MATCH_N):.1%} of the rows "
        f"per launch); bound {b_ms:.4f} ms per solve, "
        f"{b_ms / launches:.4f} per launch; K5 device {ms:.4f} ms per "
        f"profiled solve, {ms / launches:.4f} per launch (the bound is "
        f"{b_ms / ms:.0%} of it)")
    return {"matching": walls,
            "k5_in_solve": dict(ms=ms, launches=kernels,
                                ms_per_launch=ms / kernels,
                                labeled_row_reads=reads)}


def k5_reads(dev, adj, check) -> tuple[int, int]:
    """One more unprofiled ``pallas`` solve, its result checked like the
    others, with a hook on ``core.matching.bfs._expand`` (restored after)
    that counts K5's calls and the labeled rows each reads (root < INF,
    over the whole batch). Returns ``(calls, labeled rows)``; the launch
    count must equal the calls."""
    from repro_torch.core.matching import bfs, match_bipartite_batch
    from repro_torch.kernels.frontier.ref import INF
    expand, seen = bfs._expand, []

    def counted(adj_, root_row, match_row, backend):
        if backend == "pallas":
            seen.append(int((root_row < INF).sum()))
        return expand(adj_, root_row, match_row, backend)
    bfs._expand = counted
    try:
        reset_counts()
        res, _ = solve(match_bipartite_batch, adj, backend="pallas",
                       device=dev)
        launched = read_counts()["frontier"]
    finally:
        bfs._expand = expand
    check("matching_pallas_counted", res)
    if launched != len(seen):
        raise AssertionError(f"K5 launched {launched} times in "
                             f"{len(seen)} frontier sweeps")
    return len(seen), sum(seen)


class Queue(NamedTuple):
    """One ragged queue of ``phase_batch``."""
    kind: str
    payloads: list
    bucket: str
    kw: dict          # solver knobs besides ``device``
    kernels: tuple    # the kernels its solves must launch


def batch_queues() -> list:
    """The three ragged queues of ``phase_batch``, from SEED."""
    from repro_torch.core.matching.ref import random_bipartite
    from repro_torch.core.maxflow.grid import GridProblem
    from repro_torch.core.maxflow.ref import random_grid_problem
    rng = np.random.default_rng(SEED)
    grids = [GridProblem(*random_grid_problem(rng, h, w))
             for h, w in BATCH_GRID_SHAPES]
    ws = [rng.integers(0, 101, (n, n)) for n in BATCH_ASSIGN_NS]
    adjs = [random_bipartite(rng, nl, nr, 4 / nr)
            for nl, nr in BATCH_MATCH_SHAPES]
    return [
        Queue("maxflow", grids, "max", dict(backend="pallas"),
              ("grid_push_decide", "bfs_relabel_sweeps")),
        Queue("assignment", ws, "pow2",
              dict(backend="pallas", method="auction"), ("bidding",)),
        Queue("matching", adjs, "max", dict(backend="pallas"),
              ("frontier",)),
    ]


def batch_oracle(q: Queue) -> list:
    """scipy's flows and optimal weights, Hopcroft-Karp's cardinalities."""
    from repro_torch.core.assignment.ref import optimal_weight
    from repro_torch.core.matching.ref import hopcroft_karp
    from repro_torch.core.maxflow.ref import maxflow_grid_ref
    if q.kind == "maxflow":
        return [maxflow_grid_ref(*p) for p in q.payloads]
    if q.kind == "assignment":
        return [optimal_weight(w) for w in q.payloads]
    return [hopcroft_karp(a)[2] for a in q.payloads]


def check_batch(kind: str, res: list, oracle: list, what: str):
    """Every request converged to the oracle's value."""
    field = {"maxflow": "flow", "assignment": "weight",
             "matching": "cardinality"}[kind]
    got = [getattr(r, field).item() for r in res]
    if not all(bool(r.converged) for r in res):
        raise AssertionError(f"{what}: not converged")
    if got != oracle:
        raise AssertionError(f"{what}: {field} {got} != oracle {oracle}")


def drive_queue(q: Queue, dev, counts: dict, oracle: list,
                label: str) -> dict:
    """``solve_batch`` on ``q`` masked and compacted in turns (masked,
    compacted, compacted, masked) after one uncounted masked solve. The
    cycle events of that warm-up (a ``masked=True`` hook) and of the first
    compacted solve (a plain hook: that driver reads its live set every
    cycle anyway) count the instances each driver computes. Launch counts
    are set to 0 just before each solve and read just after, under
    ``counts[f"{label}_{driver}"]``; a driver's second solve must launch
    what its first did and give the same results and ``BucketStats``.
    Compacted must equal masked on every leaf and counter and on every
    ``BucketStats`` but its ``compact`` flag; every solve is checked
    against the oracle. Each driver is profiled once. Returns the masked
    results (``to_numpy``), walls, profiles and cycle events."""
    from repro_torch.core.batch import solve_batch
    from repro_torch.core.solver_loop import cycle_events
    from repro_torch.interop import to_numpy

    def run(compact, stats=None):
        return solve_batch(q.kind, q.payloads, bucket=q.bucket,
                           compact=compact, stats_out=stats, device=dev,
                           **q.kw)

    drivers = {False: "masked", True: "compacted"}
    events = {False: [], True: []}
    with cycle_events(events[False].append, masked=True):
        solve(run, False)
    walls, results, stats = {False: [], True: []}, {}, {}
    for compact in (False, True, True, False):
        name = f"{label}_{drivers[compact]}"
        st = []
        record = compact and not events[True]
        reset_counts()
        with (cycle_events(events[True].append) if record
              else contextlib.nullcontext()):
            res, wall = solve(run, compact, st)
        got = read_counts()
        check_batch(q.kind, res, oracle, name)
        out = [to_numpy(r) for r in res]
        if name in counts:
            if got != counts[name]:
                raise AssertionError(f"{name}: launches {got} != first "
                                     f"solve's {counts[name]}")
            for i, (a, b) in enumerate(zip(out, results[compact])):
                require_same(a, b, f"{name} rerun, request {i}")
            if st != stats[compact]:
                raise AssertionError(f"{name} rerun: BucketStats differ")
        counts.setdefault(name, got)
        results.setdefault(compact, out)
        stats.setdefault(compact, st)
        walls[compact].append(wall)
        log(f"[batch] {name}: {wall:.4f} s, launches {got}")
    for i, (a, b) in enumerate(zip(results[True], results[False])):
        require_same(a, b, f"{label} compacted vs masked, request {i}")
    if [x._replace(compact=False) for x in stats[True]] != stats[False]:
        raise AssertionError(f"{label}: compacted BucketStats "
                             f"{stats[True]} != masked {stats[False]}")
    for compact in (False, True):
        require_launched(counts[f"{label}_{drivers[compact]}"], q.kernels,
                         f"{label}_{drivers[compact]}")
    buckets = [(x.shape, x.n_real, round(x.spread, 3)) for x in stats[True]]
    log(f"[batch] {label}: buckets (shape, requests, rounds spread) "
        f"{buckets}")
    profiles = {compact: profile(f"{label} {drivers[compact]}",
                                 sum(walls[compact]) / 2, run, compact)
                for compact in (False, True)}
    return dict(results=results[False], walls=walls, profiles=profiles,
                events=events)


def batch_report(label: str, q: Queue, out: dict, counts: dict,
                 card: str):
    """The ``[batch]`` lines of one queue: walls in turns, device busy and
    idle share, the instances each driver computed (the sum of
    ``CycleEvent.gathered``: bucket size x cycles for the masked driver),
    the device time of the compacted driver's gathers and scatters, and
    the kernels' launches per solve."""
    w, p, ev = out["walls"], out["profiles"], out["events"]
    g_masked = sum(e.gathered for e in ev[False])
    g_comp = sum(e.gathered for e in ev[True])
    live = sum(e.n_live for e in ev[True])
    log(f"[batch] {label} on {card}: walls masked "
        f"{w[False][0]:.4f} / {w[False][1]:.4f} s, compacted "
        f"{w[True][0]:.4f} / {w[True][1]:.4f} s (in turns m, c, c, m)")
    log(f"[batch] {label}: device busy masked {p[False]['busy_s']:.4f} s "
        f"(idle share {p[False]['idle_share']:.3f}), compacted "
        f"{p[True]['busy_s']:.4f} s (idle share "
        f"{p[True]['idle_share']:.3f}); gather/scatter device "
        f"{p[True]['gather_scatter_ms']:.3f} ms compacted, "
        f"{p[False]['gather_scatter_ms']:.3f} ms masked")
    if ev[False]:
        log(f"[batch] {label}: instance-cycles computed, masked (bucket "
            f"size x cycles) {g_masked}, compacted (sum of gathered) "
            f"{g_comp}, live {live}: {1 - g_comp / g_masked:.1%} fewer; "
            f"{len(ev[False])} masked and {len(ev[True])} compacted cycles")
    keys = ("grid_push_decide", "grid_push_decide_sched",
            "bfs_relabel_sweeps", "bidding", "frontier")
    for driver in ("masked", "compacted"):
        c = counts[f"{label}_{driver}"]
        log(f"[batch] {label} {driver}: launches per solve "
            f"{ {k: c[k] for k in keys if c[k]} }")


def drive_refill(q: Queue, dev, counts: dict, masked: list):
    """A ``RefillSolver`` of ``REFILL_CAPACITY`` slots on ``q``'s largest
    bucket shape, seeded with the first requests of that bucket; ``admit``
    supplies the others (the bucket's requests again where it holds no
    more than the capacity) as slots free up. At least one must enter
    after cycle 0, and every request's result must equal its closed
    masked batch result (``masked``, same padding shape) on every leaf."""
    from repro_torch.core.batch import prepare_buckets
    from repro_torch.core.refill import RefillSolver
    from repro_torch.core.solver_loop import cycle_events
    from repro_torch.interop import to_numpy
    big = max(prepare_buckets(q.kind, q.payloads, bucket=q.bucket),
              key=lambda b: int(np.prod(b.shape)))
    order = list(big.idxs)
    while len(order) <= REFILL_CAPACITY:
        order += list(big.idxs)
    rest = order[REFILL_CAPACITY:]
    cycle, admitted = [None], []

    def admit(n_free):
        take = rest[:n_free]
        del rest[:n_free]
        if take:
            admitted.append((cycle[0], len(take)))
        return [q.payloads[i] for i in take]

    session = RefillSolver(q.kind, shape=big.shape,
                           capacity=REFILL_CAPACITY, device=dev, **q.kw)
    name = f"refill_{q.kind}"
    reset_counts()
    with cycle_events(lambda ev: cycle.__setitem__(0, ev.cycle)):
        got, wall = solve(session.run,
                          [q.payloads[i] for i in order[:REFILL_CAPACITY]],
                          admit=admit)
    counts[name] = read_counts()
    require_launched(counts[name], q.kernels, name)
    if sorted(got) != list(range(len(order))):
        raise AssertionError(f"{name}: results for {sorted(got)}")
    for r, i in enumerate(order):
        require_same(to_numpy(got[r]), masked[i],
                     f"{name}: request {r} (payload {i}) vs closed batch")
    late = sum(n for c, n in admitted if c is not None)
    if late < 1:
        raise AssertionError(f"{name}: no admission after cycle 0 "
                             f"({admitted})")
    log(f"[batch] {name}: {len(order)} requests on {big.shape} x "
        f"{REFILL_CAPACITY} slots, admitted (after cycle, n) {admitted}, "
        f"{wall:.4f} s, launches {counts[name]}; every result equals its "
        f"closed masked batch")


def phase_batch(dev, counts: dict, card: str) -> dict:
    """The batch front end, compaction and refill on the card (ROADMAP
    M3): the three ragged queues masked and compacted in turns
    (``drive_queue``, ``batch_report``), the maxflow queue once more on
    the balanced backend (K2, K3; one solve per driver), then a refill
    session per kind (``drive_refill``). Returns walls and busy times,
    and each queue's oracle values by kind."""
    summary, oracles = {}, {}
    for q in batch_queues():
        oracle = oracles[q.kind] = batch_oracle(q)
        log(f"[batch] {q.kind}: {len(q.payloads)} requests, bucket "
            f"{q.bucket!r}, {q.kw}, oracle {oracle}")
        label = f"batch_{q.kind}"
        out = drive_queue(q, dev, counts, oracle, label)
        batch_report(label, q, out, counts, card)
        summary[label] = {d: dict(walls=out["walls"][c],
                                  busy_s=out["profiles"][c]["busy_s"])
                          for c, d in ((False, "masked"),
                                       (True, "compacted"))}
        if q.kind == "maxflow":
            bal = q._replace(kw=dict(backend="balanced"),
                             kernels=("grid_push_decide_sched",
                                      "bfs_relabel_sweeps"))
            drive_balanced(bal, dev, counts, oracle)
        drive_refill(q, dev, counts, out["results"])
        drive_lanes(q, dev, counts, out["results"])
    return summary, oracles


def drive_balanced(q: Queue, dev, counts: dict, oracle: list):
    """The maxflow queue on ``backend="balanced"``: one masked and one
    compacted solve, oracle flows, equal on every leaf."""
    from repro_torch.core.batch import solve_batch
    from repro_torch.interop import to_numpy
    out = {}
    for compact, driver in ((False, "masked"), (True, "compacted")):
        name = f"batch_maxflow_balanced_{driver}"
        reset_counts()
        res, wall = solve(solve_batch, q.kind, q.payloads, bucket=q.bucket,
                          compact=compact, device=dev, **q.kw)
        counts[name] = read_counts()
        check_batch(q.kind, res, oracle, name)
        require_launched(counts[name], q.kernels, name)
        out[driver] = [to_numpy(r) for r in res]
        log(f"[batch] {name}: {wall:.4f} s, launches {counts[name]}")
    for i, (a, b) in enumerate(zip(out["compacted"], out["masked"])):
        require_same(a, b, f"balanced compacted vs masked, request {i}")


def drive_lanes(q: Queue, dev, counts: dict, masked: list):
    """Device lanes on the card (ROADMAP M7): ``make_solver_mesh()`` is
    one lane on the one card; it (masked) and two lanes on that card
    (masked and compacted, each bucket padded to the lanes with inert
    instances) must give ``q``'s masked results without lanes on every
    leaf and launch the queue's kernels."""
    from repro_torch.core.batch import solve_batch
    from repro_torch.interop import to_numpy
    from repro_torch.launch.mesh import make_solver_mesh
    one = make_solver_mesh()
    if len(one.devices) != 1 or one.devices[0].type != dev.type:
        raise AssertionError(f"make_solver_mesh(): lanes {one.devices}, "
                             f"not one on {dev}")
    two = make_solver_mesh(2, device=dev)
    for mesh, compact, label in ((one, False, "one_lane"),
                                 (two, False, "two_lanes_masked"),
                                 (two, True, "two_lanes_compacted")):
        name = f"lanes_{q.kind}_{label}"
        stats = []
        reset_counts()
        res, wall = solve(solve_batch, q.kind, q.payloads, bucket=q.bucket,
                          compact=compact, mesh=mesh, stats_out=stats,
                          device=dev, **q.kw)
        counts[name] = read_counts()
        require_launched(counts[name], q.kernels, name)
        for i, r in enumerate(res):
            require_same(to_numpy(r), masked[i], f"{name}: request {i}")
        pads = [x.n_pad for x in stats]
        if pads != [-x.n_real % len(mesh.devices) for x in stats]:
            raise AssertionError(f"{name}: inert padding {pads}")
        log(f"[lanes] {name}: {len(mesh.devices)} lane(s) on {dev}, "
            f"buckets (requests, inert pad) "
            f"{[(x.n_real, x.n_pad) for x in stats]}, {wall:.4f} s; equal "
            f"to the solve without lanes")


def warm_mutate_grid(rng, p):
    """Move WARM_GRID_SHARE of the arcs by up to +-4 (arcs off the grid
    stay 0) and of the sink capacities by up to +-2, at least 0."""
    from repro_torch.core.maxflow.grid import GridProblem
    cap = np.array(p[0], np.float32)
    ct = np.array(p[2], np.float32)
    hit = rng.random(cap.shape) < WARM_GRID_SHARE
    moved = np.maximum(cap + rng.integers(-4, 5, cap.shape), 0)
    cap = np.where(hit & (cap > 0), moved, cap).astype(np.float32)
    hit = rng.random(ct.shape) < WARM_GRID_SHARE
    ct = np.where(hit, np.maximum(ct + rng.integers(-2, 3, ct.shape), 0),
                  ct).astype(np.float32)
    return GridProblem(cap, np.asarray(p[1]), ct)


def warm_mutate_weights(rng, w):
    """Move WARM_ASSIGN_SHARE of the weights by +-3, within [0, 100]."""
    hit = rng.random(w.shape) < WARM_ASSIGN_SHARE
    step = rng.choice(np.array([-3, 3]), size=w.shape)
    return np.where(hit, np.clip(w + step, 0, 100), w)


def warm_mutate_adj(rng, a):
    """Toggle WARM_MATCH_TOGGLES entries of one adjacency."""
    a = a.copy()
    nl, nr = a.shape
    idx = rng.choice(nl * nr, size=WARM_MATCH_TOGGLES, replace=False)
    a.flat[idx] ^= True
    return a


def drive_warm(what: str, kind: str, bases: list, mutated: list,
               oracle: list, dev, counts: dict, kw: dict, kernels,
               plain_kw: dict | None) -> dict:
    """A warm re-solve of ``mutated`` from the cached solutions of
    ``bases`` (``WarmStart(solution, base_problem)``) through the normal
    entry points: ``solve_batch(warm=)`` (masked), ``solve_warm(compact=
    True)``, and a ``RefillSolver`` seeded warm (``run(warm=)``), against
    a cold ``solve_batch`` of ``mutated``. Launch counts are set to 0
    just before each solve and read just after (``counts[f"{what}_..."]``);
    each warm solve must launch ``kernels``. Every warm result must equal
    the masked warm one on every leaf, converge to the oracle's value as
    the cold solve does, and with ``plain_kw`` equal the warm solve on the
    plain path (``backend="xla"``) bit for bit. Logs and returns the warm
    and cold rounds and the device busy of one profiled warm and cold
    solve each."""
    from repro_torch.core.batch import solve_batch
    from repro_torch.core.kinds import get_kind
    from repro_torch.core.refill import RefillSolver
    from repro_torch.core.warm import (WarmStart, build_warm_state,
                                       delta_bound, solve_warm)
    from repro_torch.interop import to_numpy
    k = get_kind(kind)
    rt, warm_fn = k.refill(device=dev, **kw), k.warm_state(device=dev, **kw)
    base_res = solve_batch(kind, bases, device=dev, **kw)
    warm = {i: WarmStart(k.solution_of(r), base_problem=bases[i])
            for i, r in enumerate(base_res)}
    shape = rt.shape_of(k.validate(mutated[0]))
    runs = {
        "cold": (solve_batch, (kind, mutated), kw),
        "warm_masked": (solve_batch, (kind, mutated), dict(warm=warm, **kw)),
        "warm_compacted": (solve_warm, (kind, mutated, warm),
                           dict(compact=True, **kw)),
        "warm_refill": (lambda: RefillSolver(
            kind, shape=shape, capacity=len(mutated), device=dev,
            **kw).run(mutated, warm=warm), (), {}),
    }
    if plain_kw is not None:
        runs["warm_plain"] = (solve_batch, (kind, mutated),
                              dict(warm=warm, **plain_kw))
    out, walls = {}, {}
    for run, (fn, a, extra) in runs.items():
        name = f"{what}_{run}"
        reset_counts()
        res, walls[run] = solve(fn, *a, device=dev, **extra) if a else \
            solve(fn)
        counts[name] = read_counts()
        if run == "warm_plain":
            require_not_launched(counts[name], [
                n for n in kernels if n != "bfs_relabel_sweeps"], name)
        elif run != "cold":
            require_launched(counts[name], kernels, name)
        res = [res[i] for i in range(len(mutated))]
        check_batch(kind, res, oracle, name)
        out[run] = res
        log(f"[warm] {name}: {walls[run]:.4f} s, rounds "
            f"{[int(r.rounds) for r in res]}, launches {counts[name]}")
    want = [to_numpy(r) for r in out["warm_masked"]]
    for run, res in out.items():
        if run != "cold":
            for i, r in enumerate(res):
                require_same(to_numpy(r), want[i], f"{what} {run} vs "
                             f"warm_masked, request {i}")
    # the warm init alone, as solve_warm builds it (per instance, batch-1)
    # and inside it delta_bound's host work, outside the counted solves
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, p in enumerate(mutated):
        v = k.validate(p)
        build_warm_state(k, rt, warm_fn, rt.pad_one(v, shape), v, warm[i],
                         shape)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for p, b in zip(mutated, bases):
        delta_bound(k.validate(p), k.validate(b))
    bound_s = time.perf_counter() - t0
    rounds = {run: [int(r.rounds) for r in out[run]]
              for run in ("cold", "warm_masked")}
    prof = {run: profile(f"{what} {run}", walls[run], runs[run][0],
                         *runs[run][1], device=dev, **runs[run][2])
            for run in ("cold", "warm_masked")}
    ratio_sum = sum(rounds["warm_masked"]) / sum(rounds["cold"])
    ratio_max = max(rounds["warm_masked"]) / max(rounds["cold"])
    log(f"[warm] {what}: rounds warm {rounds['warm_masked']} / cold "
        f"{rounds['cold']}: sum {ratio_sum:.3f}, max {ratio_max:.3f}; "
        f"walls warm {walls['warm_masked']:.4f} / cold {walls['cold']:.4f} "
        f"s; device busy warm {prof['warm_masked']['busy_s']:.4f} / cold "
        f"{prof['cold']['busy_s']:.4f} s (idle share "
        f"{prof['warm_masked']['idle_share']:.3f} / "
        f"{prof['cold']['idle_share']:.3f}); warm init {init_s:.4f} s "
        f"(delta_bound {bound_s:.4f} s); every warm driver and path equal, "
        f"oracle optima")
    return dict(rounds=rounds, ratio_sum=ratio_sum, ratio_max=ratio_max,
                walls=walls, busy_s={r: p["busy_s"] for r, p in prof.items()},
                init_s=init_s, bound_s=bound_s,
                kernels={r: p["port_kernels"] for r, p in prof.items()},
                bases=bases, mutated=mutated, warm=want)


def phase_warm(dev, counts: dict, grids: list, card: str) -> dict:
    """Warm start on the card (ROADMAP M6), ``drive_warm`` on each main
    path's batch: the grids (``pallas``: K1, K3; ``balanced``: K2, K3),
    the assignment weights (auction and push-relabel on ``pallas``: K4)
    and the graphs (``pallas``: K5), each mutated from SEED + 2."""
    from repro_torch.core.assignment.ref import optimal_weight
    from repro_torch.core.maxflow.grid import GridProblem
    from repro_torch.core.matching.ref import hopcroft_karp
    from repro_torch.core.maxflow.ref import maxflow_grid_ref
    rng = np.random.default_rng(SEED + 2)
    bases = [GridProblem(*p) for p in grids]
    mutated = [warm_mutate_grid(rng, p) for p in bases]
    oracle = [maxflow_grid_ref(*p) for p in mutated]
    log(f"[warm] grids {len(bases)} x {bases[0].cap_src.shape}: "
        f"{int(sum((a.cap_nbr != b.cap_nbr).sum() for a, b in zip(mutated, bases)))} "
        f"arcs and {int(sum((a.cap_sink != b.cap_sink).sum() for a, b in zip(mutated, bases)))} "
        f"sink capacities changed; scipy flows {oracle}")
    out = {}
    for backend, kernels in (
            ("pallas", ("grid_push_decide", "bfs_relabel_sweeps")),
            ("balanced", ("grid_push_decide_sched", "bfs_relabel_sweeps"))):
        out[f"maxflow_{backend}"] = drive_warm(
            f"warm_maxflow_{backend}", "maxflow", bases, mutated, oracle,
            dev, counts, dict(backend=backend), kernels,
            dict(backend="xla") if backend == "pallas" else None)
    ws = list(assignment_weights())
    mutated = [warm_mutate_weights(rng, w) for w in ws]
    oracle = [optimal_weight(w) for w in mutated]
    log(f"[warm] assignment {len(ws)} x {ws[0].shape}: "
        f"{int(sum((a != b).sum() for a, b in zip(mutated, ws)))} weights "
        f"changed; scipy optima {oracle}")
    for method in ("auction", "pushrelabel"):
        out[f"assignment_{method}"] = drive_warm(
            f"warm_assignment_{method}", "assignment", ws, mutated, oracle,
            dev, counts, dict(backend="pallas", method=method), ("bidding",),
            dict(backend="xla", method=method))
    adjs = list(matching_adjacency())
    mutated = [warm_mutate_adj(rng, a) for a in adjs]
    oracle = [hopcroft_karp(a)[2] for a in mutated]
    log(f"[warm] matching {len(adjs)} x {adjs[0].shape}: "
        f"{WARM_MATCH_TOGGLES} entries toggled each; Hopcroft-Karp "
        f"{oracle}")
    out["matching"] = drive_warm(
        "warm_matching", "matching", adjs, mutated, oracle, dev, counts,
        dict(backend="pallas"), ("frontier",), dict(backend="xla"))
    for name, r in out.items():
        log(f"[warm] {name} on {card}: warm / cold rounds, sum "
            f"{r['ratio_sum']:.3f}, max {r['ratio_max']:.3f}; device busy "
            f"{r['busy_s']['warm_masked']:.4f} / {r['busy_s']['cold']:.4f} "
            f"s")
    return out


def engine_results(eng, stream: list) -> tuple[list, float]:
    """Submit ``(kind, payload)`` ``stream`` to a ``SolverEngine`` and
    flush it: the results in stream order (``to_numpy``) and the wall."""
    from repro_torch.interop import to_numpy
    tickets = [eng.submit(kind, p) for kind, p in stream]
    out, wall = solve(eng.flush)
    return [to_numpy(out[t]) for t in tickets], wall


def require_same_list(got: list, want: list, what: str):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, {len(want)} "
                             f"wanted")
    for i, (a, b) in enumerate(zip(got, want)):
        require_same(a, b, f"{what}, request {i}")


def span_seconds(tracer) -> dict:
    """Seconds per span name, summed over the tracer's spans."""
    out = dict.fromkeys(SPAN_NAMES, 0.0)
    for sp in tracer.spans():
        out[sp.name] = out.get(sp.name, 0.0) + (sp.t1 - sp.t0)
    return out


def union_seconds(intervals) -> float:
    """Length of the union of ``(t0, t1)`` intervals."""
    total, end = 0.0, None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total, end = total + (t1 - t0), t1
        elif t1 > end:
            total, end = total + (t1 - end), t1
    return total


def span_cover(tracer) -> dict:
    """Seconds per span name in which at least one span of that name was
    open (the union of their intervals), and ``hand-off``: the union, per
    ticket, of the time from its queue-wait's end to its solve's start
    (the batch's bucket/pad, then its wait for a free lane)."""
    by_name, ends, starts = {}, {}, {}
    for sp in tracer.spans():
        by_name.setdefault(sp.name, []).append((sp.t0, sp.t1))
        t = sp.attrs.get("ticket")
        if sp.name == "queue-wait":
            ends[t] = sp.t1
        elif sp.name == "solve":
            starts[t] = sp.t0
    out = {n: union_seconds(by_name.get(n, [])) for n in SPAN_NAMES}
    out["hand-off"] = union_seconds(
        [(ends[t], starts[t]) for t in ends if t in starts])
    return out


def engine_sync(dev, counts: dict, grids: list, oracle: list) -> None:
    """The sync engine at full width: the main paths' batches (4 x 512^2
    grids, 8 x 512^2 weights, 4 x 4096^2 graphs) as one queue interleaved
    by kind, flushed untraced and traced. Each flush must equal
    ``solve_batch`` of each kind and the oracles, bit for bit the one the
    other, and launch K1, K3, K4 and K5; the grids once more on
    ``balanced`` must launch K2 and K3 and equal its ``solve_batch``."""
    from repro_torch.core.assignment.ref import optimal_weight
    from repro_torch.core.batch import solve_batch
    from repro_torch.core.matching.ref import hopcroft_karp
    from repro_torch.core.maxflow.grid import GridProblem
    from repro_torch.interop import to_numpy
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import SolverEngine
    queues = {"maxflow": [GridProblem(*p) for p in grids],
              "assignment": list(assignment_weights()),
              "matching": list(matching_adjacency())}
    stream = [(kind, q[i]) for i in range(max(map(len, queues.values())))
              for kind, q in queues.items() if i < len(q)]
    solved = {kind: solve_batch(kind, q, device=dev, **ENGINE_KW[kind])
              for kind, q in queues.items()}
    oracles = {"maxflow": oracle,
               "assignment": [optimal_weight(w)
                              for w in queues["assignment"]],
               "matching": [hopcroft_karp(a)[2]
                            for a in queues["matching"]]}
    for kind, res in solved.items():
        check_batch(kind, res, oracles[kind], f"engine_sync {kind} oracle")
    want = {kind: [to_numpy(r) for r in res] for kind, res in solved.items()}
    order = {kind: [i for i, (k, _) in enumerate(stream) if k == kind]
             for kind in queues}
    runs = {}
    for name, tracer in (("engine_sync", None),
                         ("engine_sync_traced", Tracer())):
        eng = SolverEngine(device=dev, solver_kw=ENGINE_KW, tracer=tracer)
        reset_counts()
        res, wall = engine_results(eng, stream)
        counts[name] = read_counts()
        require_launched(counts[name], ("grid_push_decide",
                                        "bfs_relabel_sweeps", "bidding",
                                        "frontier"), name)
        for kind, idx in order.items():
            require_same_list([res[i] for i in idx], want[kind],
                              f"{name} {kind} vs solve_batch")
        runs[name] = res
        spans = "" if tracer is None else f", spans {span_seconds(tracer)}"
        log(f"[engine] {name}: {len(stream)} requests, {wall:.4f} s{spans}")
    require_same_list(runs["engine_sync_traced"], runs["engine_sync"],
                      "engine_sync traced vs untraced")
    name = "engine_sync_balanced"
    kw = {"maxflow": dict(backend="balanced")}
    reset_counts()
    res, wall = engine_results(SolverEngine(device=dev, solver_kw=kw),
                               [("maxflow", p) for p in queues["maxflow"]])
    counts[name] = read_counts()
    require_launched(counts[name], ("grid_push_decide_sched",
                                    "bfs_relabel_sweeps"), name)
    require_same_list(res, [to_numpy(r) for r in solve_batch(
        "maxflow", queues["maxflow"], device=dev, **kw["maxflow"])],
        f"{name} vs solve_batch")
    log(f"[engine] {name}: {wall:.4f} s, launches {counts[name]}")


def engine_stream() -> tuple[list, list]:
    """``phase_batch``'s three ragged queues as one stream of ``(kind,
    payload)`` in an order drawn from SEED, and each request's position
    in its queue."""
    src = [(q.kind, i, p) for q in batch_queues()
           for i, p in enumerate(q.payloads)]
    order = np.random.default_rng(SEED + 3).permutation(len(src))
    return ([src[j][::2] for j in order], [src[j][1] for j in order])


def drive_async(dev, counts: dict, stream: list, want: list, n_lanes: int,
                refill: bool, card: str, trace_path=None) -> dict:
    """``stream`` through a traced ``AsyncSolverEngine`` of ``n_lanes``
    lanes (each on its own CUDA stream), ``refill`` off or on: every
    future must equal the sync flush (``want``) bit for bit and the path's
    kernels must launch. Logs the wall of the whole stream, the device
    busy (summed and as the union of intervals) and idle share of one
    more profiled run, the seconds per span name, the metrics snapshot
    and its ``prometheus_text``; saves the Chrome trace to
    ``trace_path``."""
    from repro_torch.interop import to_numpy
    from repro_torch.obs import Tracer, prometheus_text
    from repro_torch.serve.scheduler import AsyncSolverEngine
    name = f"engine_async_lanes{n_lanes}_{'refill' if refill else 'closed'}"

    def run(tracer=None):
        with AsyncSolverEngine(device=dev, n_lanes=n_lanes, refill=refill,
                               max_batch=ENGINE_MAX_BATCH,
                               max_delay_ms=ENGINE_NO_DEADLINE_MS,
                               solver_kw=ENGINE_KW, tracer=tracer) as eng:
            futs = [eng.submit(kind, p) for kind, p in stream]
            eng.flush_now()
            res = [f.result(timeout=600) for f in futs]
        return eng, res

    tracer = Tracer()
    reset_counts()
    (eng, res), wall = solve(run, tracer)
    counts[name] = read_counts()
    require_launched(counts[name], ("grid_push_decide", "bfs_relabel_sweeps",
                                    "bidding", "frontier"), name)
    require_same_list([to_numpy(r) for r in res], want,
                      f"{name} vs sync flush")
    spans, cover = span_seconds(tracer), span_cover(tracer)
    snap = eng.metrics.snapshot()
    prof = profile(name, wall, run)
    log(f"[engine] {name} on {card}: {len(stream)} requests in {wall:.4f} "
        f"s; device busy {prof['busy_s']:.4f} s summed, "
        f"{prof['union_s']:.4f} s as a union of intervals (overlap "
        f"{prof['busy_s'] / prof['union_s']:.3f}); idle share "
        f"{1 - prof['union_s'] / wall:.3f}; launches {counts[name]}")
    log(f"[engine] {name}: seconds per span (summed) "
        + ", ".join(f"{k} {v:.4f}" for k, v in spans.items())
        + f"; {len(tracer.spans())} spans")
    log(f"[engine] {name}: share of the wall under each span (union) "
        + ", ".join(f"{k} {v / wall:.3f}" for k, v in cover.items()))
    log(f"[engine] {name}: device-solve seconds by kind "
        + ", ".join(f"{sp.attrs['kind']} {sp.t1 - sp.t0:.4f}"
                    for sp in tracer.spans() if sp.name == "device-solve")
        + f" (switch interval {sys.getswitchinterval()} s)")
    log(f"[engine] {name}: metrics {json.dumps(snap)}")
    log(f"[engine] {name}: prometheus_text\n{prometheus_text(snap)}")
    if trace_path is not None:
        tracer.save(trace_path)
        log(f"[engine] {name}: Chrome trace in {trace_path}")
    return dict(wall=wall, busy_s=prof["busy_s"], union_s=prof["union_s"],
                spans=spans, cover=cover)


def engine_switch_probe(dev, stream: list, want: list, card: str,
                        interval: float = 5e-4) -> dict:
    """The closed-batch stream at one lane, then two, with the
    interpreter's thread switch interval cut to ``interval`` and restored
    after: whether the two lanes' wall is the lane threads waiting for
    their turn at the GIL. Results must still equal the sync flush."""
    from repro_torch.interop import to_numpy
    from repro_torch.serve.scheduler import AsyncSolverEngine

    def run(n_lanes):
        with AsyncSolverEngine(device=dev, n_lanes=n_lanes,
                               max_batch=ENGINE_MAX_BATCH,
                               max_delay_ms=ENGINE_NO_DEADLINE_MS,
                               solver_kw=ENGINE_KW) as eng:
            futs = [eng.submit(kind, p) for kind, p in stream]
            eng.flush_now()
            return [f.result(timeout=600) for f in futs]

    walls = {1: [], 2: []}
    old = sys.getswitchinterval()
    sys.setswitchinterval(interval)
    try:
        for n_lanes in (1, 2):
            res, wall = solve(run, n_lanes)
            require_same_list([to_numpy(r) for r in res], want,
                              f"switch probe, {n_lanes} lanes")
            walls[n_lanes].append(wall)
    finally:
        sys.setswitchinterval(old)
    log(f"[engine] switch interval {interval} s (default {old}) on {card}: "
        f"walls one lane {walls[1][0]:.4f} s, two lanes {walls[2][0]:.4f} "
        f"s: two / one {walls[2][0] / walls[1][0]:.3f}")
    return walls


def engine_warm(dev, counts: dict, warm: dict) -> None:
    """Warm re-solves through the engine: each path's bases solved, then
    ``submit(base=ticket, delta=...)`` with ``phase_warm``'s edits as
    ``GraphDelta``s; every result must equal ``phase_warm``'s masked warm
    result bit for bit and launch the path's kernels."""
    from repro_torch.core.warm import GraphDelta, SolutionCache
    from repro_torch.interop import to_numpy
    from repro_torch.serve.engine import SolverEngine

    def deltas(kind, base, new):
        fields = ("cap_nbr", "cap_sink") if kind == "maxflow" else (None,)
        out = []
        for f in fields:
            a, b = (np.asarray(getattr(x, f) if f else x)
                    for x in (base, new))
            idx = np.nonzero(a != b)
            out.append(GraphDelta(idx=idx, values=b[idx], field=f))
        return out

    for path, kind, kernels in (
            ("maxflow_pallas", "maxflow",
             ("grid_push_decide", "bfs_relabel_sweeps")),
            ("assignment_auction", "assignment", ("bidding",)),
            ("matching", "matching", ("frontier",))):
        w = warm[path]
        # four 4096^2 graphs and their solutions pass the cache's default
        # 64 MiB budget, which would evict the first base before its turn
        eng = SolverEngine(device=dev, solver_kw=ENGINE_KW,
                           cache=SolutionCache(max_bytes=1 << 30))
        tickets = [eng.submit(kind, b) for b in w["bases"]]
        eng.flush()
        name = f"engine_warm_{path}"
        warm_t = [eng.submit(kind, base=t, delta=deltas(kind, b, m))
                  for t, b, m in zip(tickets, w["bases"], w["mutated"])]
        reset_counts()
        out, wall = solve(eng.flush)
        counts[name] = read_counts()
        require_launched(counts[name], kernels, name)
        require_same_list([to_numpy(out[t]) for t in warm_t], w["warm"],
                          f"{name} vs phase_warm")
        log(f"[engine] {name}: {len(warm_t)} warm requests from base "
            f"tickets, {wall:.4f} s, equal to phase_warm's warm results")


def phase_engine(dev, counts: dict, grids: list, oracle: list, warm: dict,
                 batch_oracles: dict, card: str) -> dict:
    """The serving engines on the card (ROADMAP M8): the sync engine at
    full width (``engine_sync``), ``phase_batch``'s ragged queues as one
    stream through ``AsyncSolverEngine`` at one and two lanes, refill off
    and on, each equal to the sync flush (``drive_async``), the closed
    stream under a short thread switch interval
    (``engine_switch_probe``), and warm requests through the engine
    (``engine_warm``). Returns the async runs' walls, busy times and span
    seconds."""
    from repro_torch.serve.engine import SolverEngine
    engine_sync(dev, counts, grids, oracle)
    stream, index = engine_stream()
    reset_counts()
    want, wall = engine_results(SolverEngine(device=dev,
                                             solver_kw=ENGINE_KW), stream)
    counts["engine_stream_sync"] = read_counts()
    field = {"maxflow": "flow", "assignment": "weight",
             "matching": "cardinality"}
    for (kind, _), i, r in zip(stream, index, want):   # phase_batch's
        if r[field[kind]].item() != batch_oracles[kind][i]:   # oracle
            raise AssertionError(f"engine stream {kind} request {i}: "
                                 f"{r[field[kind]]} != oracle "
                                 f"{batch_oracles[kind][i]}")
    log(f"[engine] sync flush of the {len(stream)}-request stream: "
        f"{wall:.4f} s, oracle values, launches "
        f"{counts['engine_stream_sync']}")
    out = {}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    for n_lanes in (1, 2):
        for refill in (False, True):
            out[(n_lanes, refill)] = drive_async(
                dev, counts, stream, want, n_lanes, refill, card,
                trace_path=build / "engine_trace.json"
                if (n_lanes, refill) == (2, False) else None)
    for refill in (False, True):
        one, two = out[(1, refill)], out[(2, refill)]
        log(f"[engine] refill {'on' if refill else 'off'} on {card}: two "
            f"lanes / one lane: wall {two['wall'] / one['wall']:.3f}, busy "
            f"summed {two['busy_s'] / one['busy_s']:.3f}, union "
            f"{two['union_s'] / one['union_s']:.3f}")
    engine_switch_probe(dev, stream, want, card)
    engine_warm(dev, counts, warm)
    return out


def serve_prompts(vocab: int, B: int = SERVE_B, S: int = SERVE_S,
                  seed: int = SEED + 1) -> np.ndarray:
    """The serve phase's ``(B, S)`` int32 prompt tokens."""
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def top5_records(logits: np.ndarray) -> dict:
    """Per request of one step's ``(B, vocab)`` logits: the five largest
    (ids, first index first among equals, as ``argmax``), their values and
    the largest |logit|."""
    ids = np.argsort(-logits, axis=-1, kind="stable")[:, :5]
    return {"ids": ids.tolist(),
            "logits": np.take_along_axis(logits, ids, -1).tolist(),
            "absmax": np.abs(logits).max(-1).tolist()}


def moe_config(cfg):
    """The MoE serve phase's config: ``cfg`` (either package's phi3.5-moe)
    at full width, cut to MOE_LAYERS layers."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=MOE_LAYERS)


def moe_setup() -> dict:
    """What the MoE constants were made for."""
    return dict(arch=MOE_ARCH, n_layers=MOE_LAYERS, B=SERVE_B, S=SERVE_S,
                max_new=SERVE_NEW, seed=SEED, perturb=MOE_PERTURB,
                draws=MOE_DRAWS, skew=MOE_SKEW)


def mla_config(cfg):
    """The MLA serve phase's config: ``cfg`` (either package's deepseek-v2)
    at full width, cut to DS_LAYERS layers."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=DS_LAYERS)


def mla_setup() -> dict:
    """What the MLA constants were made for."""
    return dict(moe_setup(), arch=MLA_ARCH, n_layers=DS_LAYERS,
                perturb=MLA_PERTURB, sample=MLA_SAMPLE)


def sample_positions(S: int = SERVE_S) -> np.ndarray:
    """Every MLA_SAMPLE-th prompt position and the last (every request's
    prompt is S long)."""
    return np.unique(np.r_[np.arange(0, S, MLA_SAMPLE), S - 1])


def layer0_rows(model, prompts: torch.Tensor, S_max: int) -> dict:
    """One prefill through ``make_prefill_step``: the hidden state after
    layer 0 (a forward hook on it) and layer 0's cache rows (MLA: ``c_kv``
    and ``k_rope``) at ``sample_positions``, as float32 numpy arrays."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step
    B, S = prompts.shape
    pos = torch.tensor(sample_positions(S), device=prompts.device)
    caches = init_caches(model.cfg, B, S_max, dtype=torch.float32,
                         device=prompts.device)
    rows = {}

    def hook(module, args, out):
        rows["hidden"] = out[0][:, pos].float().cpu().numpy()
    handle = model.layers[0].register_forward_hook(hook)
    try:
        make_prefill_step(model)(prompts, caches)
    finally:
        handle.remove()
    rows["c_kv"] = caches[0].k[:, pos].float().cpu().numpy()
    rows["k_rope"] = caches[0].v[:, pos].float().cpu().numpy()
    return rows


def check_rows(got: np.ndarray, ref, what: str, tol: float) -> float:
    """``got`` against the JAX package's ``ref``: the same shape, within
    ``tol`` x JAX's largest |value|. Returns the error as a share of its
    tolerance."""
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError(f"{what}: shape {got.shape}, JAX's {ref.shape}")
    lim = tol * np.abs(ref).max()
    err = float(np.abs(got - ref).max())
    if not err <= lim:
        raise AssertionError(f"{what}: off JAX's by {err:.3g} > {lim:.3g}")
    return err / lim


def check_layer0(got: dict, want, tol: float = LOGIT_TOL) -> dict:
    """``layer0_rows`` against the JAX package's (``want``: the npz's
    ``layer0_*``): each within ``tol`` x JAX's largest |value|. Returns
    each error as a share of its tolerance."""
    return {key: check_rows(got[key], want[f"layer0_{key}"],
                            f"layer 0 {key}", tol)
            for key in ("hidden", "c_kv", "k_rope")}


def ssm_setup() -> dict:
    """What the SSM constants were made for."""
    return dict(arch=SSM_ARCH, B=SERVE_B, S=SERVE_S, max_new=SERVE_NEW,
                seed=SEED, layers=list(SSM_LAYERS), requests=SSM_REQUESTS)


def ssm_rows(model, prompts: torch.Tensor, S_max: int) -> dict:
    """One prefill through ``make_prefill_step``: the SSM ``state`` and
    ``conv`` rows of layers SSM_LAYERS for the first SSM_REQUESTS
    requests, as float32 numpy arrays ``(layers, requests, ...)``."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step
    B = prompts.shape[0]
    caches = init_caches(model.cfg, B, S_max, dtype=torch.float32,
                         device=prompts.device)
    _, state = make_prefill_step(model)(prompts, caches)
    return {k: np.stack([getattr(state.caches[i], k)[:SSM_REQUESTS].float()
                         .cpu().numpy() for i in SSM_LAYERS])
            for k in ("state", "conv")}


def check_ssm_rows(got: dict, want, tol: float = LOGIT_TOL) -> dict:
    """``ssm_rows`` against the JAX package's (``want``: the npz): the
    ``state`` and ``conv`` rows of each layer within ``tol`` x JAX's
    largest |value| of that leaf in that layer. Returns each error as a
    share of its tolerance."""
    if list(np.asarray(want["layers"])) != list(SSM_LAYERS):
        raise AssertionError(f"SSM rows of layers {want['layers']}, not "
                             f"{SSM_LAYERS}")
    return {f"layer {layer} {k}": check_rows(got[k][i], want[k][i],
                                             f"layer {layer} SSM {k}", tol)
            for k in ("state", "conv") for i, layer in enumerate(SSM_LAYERS)}


def moe_skewed_scores(T: int, E: int, seed: int = SEED + 3) -> np.ndarray:
    """``(T, E)`` float32 N(0, 1) scores plus a per-expert offset of std
    MOE_SKEW: some experts overflow, so the auction raises prices."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((T, E), dtype=np.float32)
    return s + rng.standard_normal((1, E), dtype=np.float32) * np.float32(
        MOE_SKEW)


def port_serve(model, prompts: torch.Tensor, max_new: int, S_max: int):
    """One greedy generation through ``make_prefill_step`` and
    ``make_serve_step``, each step timed and its launch counts read (set
    to 0 just before it). Returns the steps' ``(tokens, logits)`` as numpy,
    the prefill wall, the decode steps' walls and the counts of the
    prefill and of each decode step."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    dev = prompts.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    B = prompts.shape[0]
    if model.shd.mesh is not None:      # this rank's rows of the batch
        B *= model.shd.data_groups
    caches = init_caches(model.cfg, B, S_max, dtype=torch.float32, device=dev,
                         shd=model.shd)
    prefill, step = make_prefill_step(model), make_serve_step(model)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    nxt, state = prefill(prompts, caches)
    sync()
    t_prefill = time.perf_counter() - t0
    c_prefill = read_counts()
    outs = [(nxt, state.logits)]
    t_steps, c_steps = [], []
    for _ in range(max_new - 1):
        reset_counts()
        t0 = time.perf_counter()
        nxt, state = step(state)
        sync()
        t_steps.append(time.perf_counter() - t0)
        c_steps.append(read_counts())
        outs.append((nxt, state.logits))
    steps = [(t.cpu().numpy(), lg.float().cpu().numpy()) for t, lg in outs]
    return steps, t_prefill, t_steps, c_prefill, c_steps, state


def check_serve(steps, want: list, tol: float = LOGIT_TOL,
                stop: list | None = None) -> dict:
    """Hold a generation's ``steps`` (``(tokens (B,), logits (B, vocab))``
    per step) to the JAX package's ``top5_records`` per step.

    Per request and step: the port's logits at JAX's five ids lie within
    ``tol`` x JAX's largest |logit| of JAX's values; where JAX's top-2 gap
    exceeds that tolerance, the port's token is JAX's first id. At the
    first step where the gap does not (a real near-tie), that request's
    later steps are not compared: its continuation may rightly differ.
    ``stop[b]`` (optional) is the first step of request ``b`` not to
    compare at all (``moe_stops``: a routing decision that float32
    rounding can flip). Returns the steps compared per request, the
    near-tie steps and the largest error as a share of its tolerance."""
    B = len(want[0]["ids"])
    compared, ties, worst = [0] * B, [], 0.0
    for b in range(B):
        for t, ((tokens, logits), rec) in enumerate(zip(steps, want)):
            if stop is not None and t >= stop[b]:
                break
            ids = np.asarray(rec["ids"][b])
            vals = np.asarray(rec["logits"][b], dtype=np.float64)
            tol_b = tol * rec["absmax"][b]
            err = np.abs(logits[b, ids].astype(np.float64) - vals).max()
            worst = max(worst, err / tol_b)
            if err > tol_b:
                raise AssertionError(
                    f"serve step {t} request {b}: top-5 logits differ from "
                    f"the JAX package's by {err:.3g} > {tol_b:.3g}")
            compared[b] += 1
            if vals[0] - vals[1] <= tol_b:
                ties.append((b, t))
                break
            if int(tokens[b]) != int(ids[0]):
                raise AssertionError(
                    f"serve step {t} request {b}: token {int(tokens[b])} != "
                    f"the JAX package's {int(ids[0])} (gap "
                    f"{vals[0] - vals[1]:.3g})")
    return dict(steps_compared=compared, near_ties=ties,
                worst_err_over_tol=float(worst))


def serve_generations(tag: str, dev, counts: dict, cfg,
                      constants: pathlib.Path, setup: dict) -> dict:
    """``cfg`` (smollm-135m at full width, with or without ``kv_quant``)
    on ``numpy_params`` weights: a warm-up and two timed generations of
    SERVE_B x SERVE_S prompts and SERVE_NEW tokens, each held to the JAX
    package's top-5 per step in ``constants`` (made for ``setup``), K6
    launched once per layer in each prefill and never in decode; then one
    profiled prefill (every K6 launch on ``flash_fwd_wgmma``) and one
    profiled decode step. The launch counts go to ``counts`` as
    ``{tag}_prefill`` and ``{tag}_decode``. Returns the walls, the
    profiles, the mean decode step wall (``t_step``), the model, the
    prompts and the last generation's state."""
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"TF32 matmuls are on; the {tag} check assumes "
                             f"full float32")
    want = json.loads(constants.read_text())
    if {k: want[k] for k in setup} != setup:
        raise AssertionError(f"{constants.name} was made for "
                             f"{ {k: want[k] for k in setup} }, not {setup}")
    t0 = time.perf_counter()
    model = model_from_params(cfg, numpy_params(cfg, SEED), device=dev)
    prompts = torch.tensor(serve_prompts(cfg.vocab, SERVE_B, SERVE_S),
                           device=dev)
    log(f"[{tag}] {cfg.name} (kv_quant {cfg.kv_quant}): {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, "
        f"{sum(p.numel() for p in model.parameters())} parameters on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    S_max = SERVE_S + SERVE_NEW
    walls = []
    for run in ("warm-up", "run 1", "run 2"):
        steps, t_pre, t_steps, c_pre, c_steps, state = port_serve(
            model, prompts, SERVE_NEW, S_max)
        got = check_serve(steps, want["steps"])
        if c_pre["flash_attention_fwd"] != cfg.n_layers:
            raise AssertionError(f"{tag} prefill: K6 launched "
                                 f"{c_pre['flash_attention_fwd']} times, not "
                                 f"once per layer ({cfg.n_layers})")
        require_not_launched(c_pre, [n for n in c_pre
                                     if n != "flash_attention_fwd"],
                             f"{tag} prefill")
        for c in c_steps:
            require_not_launched(c, list(c), f"{tag} decode step")
        tokens = np.stack([t for t, _ in steps], 1)
        log(f"[{tag}] {run}: prefill {t_pre * 1e3:.2f} ms "
            f"({SERVE_B * SERVE_S / t_pre:.0f} tok/s), decode "
            f"{np.mean(t_steps) * 1e3:.3f} ms per token step "
            f"({SERVE_B / np.mean(t_steps):.0f} tok/s), launches per "
            f"prefill {c_pre['flash_attention_fwd']}; JAX check {got}; "
            f"request 0 tokens {tokens[0].tolist()}")
        if run != "warm-up":
            walls.append((t_pre, float(np.mean(t_steps))))
            counts.setdefault(f"{tag}_prefill", c_pre)
            counts.setdefault(f"{tag}_decode", {
                n: sum(c[n] for c in c_steps) for n in c_pre})
    t_pre = sum(w[0] for w in walls) / len(walls)
    t_step = sum(w[1] for w in walls) / len(walls)
    caches = init_caches(cfg, SERVE_B, S_max, dtype=torch.float32,
                         device=dev)
    pre = profile_k6(f"{tag} prefill 8 x 1024", t_pre, "flash_fwd_wgmma",
                     cfg.n_layers, make_prefill_step(model), prompts, caches,
                     top=16, split=True)
    dec = profile(f"{tag} decode step", t_step, make_serve_step(model),
                  state, top=16, split=True)
    return dict(walls=walls, prefill=pre, decode=dec, t_step=t_step,
                model=model, prompts=prompts, state=state)


def phase_serve(dev, counts: dict) -> dict:
    """smollm-135m at full width and depth with the float cache
    (``serve_generations``)."""
    from repro_torch.configs.base import get_config
    return serve_generations(
        "serve", dev, counts, get_config(SERVE_ARCH), SERVE_CONSTANTS,
        dict(arch=SERVE_ARCH, B=SERVE_B, S=SERVE_S, max_new=SERVE_NEW,
             seed=SEED))


@contextlib.contextmanager
def record_routing(scores: bool = False):
    """Wrap the port's MoE routers where ``models.mlp`` calls them: every
    call appends ``(router name, capacity, dispatch)`` (the dispatch a copy
    on the device; with ``scores`` also the scores routed) to the yielded
    list, in call order."""
    from repro_torch.models import mlp
    seen = []
    originals = {n: getattr(mlp, n) for n in ("auction_route", "topk_route")}

    def spy(name):
        def route(s, k, capacity, **kw):
            r = originals[name](s, k, capacity, **kw)
            seen.append((name, capacity, r.dispatch.clone())
                        + ((s.clone(),) if scores else ()))
            return r
        return route
    try:
        for name in originals:
            setattr(mlp, name, spy(name))
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(mlp, name, fn)


@contextlib.contextmanager
def pinned_prefill_routing(scores):
    """Route each MoE layer of the prefill (``router="flow"``: the port's
    ``auction_route``, where ``models.mlp`` calls it) on the JAX package's
    gate logits of that layer (``scores``, in call order) in place of the
    port's own, so that the prefill's dispatch is JAX's: the routers route
    JAX's logits as JAX did, bit for bit (``moe_routers``). The combine
    weights still come from the port's logits. Yields, per layer, the
    largest |port - JAX| gate logit as a share of JAX's largest |logit|."""
    from repro_torch.models import mlp
    original = mlp.auction_route
    diffs = []

    def route(s, k, capacity, **kw):
        ref = torch.tensor(scores[len(diffs)], device=s.device)
        diffs.append(float((s.float() - ref).abs().max() / ref.abs().max()))
        return original(ref, k, capacity, **kw)
    try:
        mlp.auction_route = route
        yield diffs
    finally:
        mlp.auction_route = original


def check_routing(got, want: dict, what: str) -> dict:
    """A port ``Routing`` against the JAX package's (``want``: its fields
    as numpy arrays): dispatch and demand equal, prices equal bit for bit,
    combine within COMBINE_TOL. Returns the tokens routed, the largest
    price and the combine error."""
    d = got.dispatch.cpu().numpy()
    if not np.array_equal(d, want["dispatch"]):
        raise AssertionError(f"{what}: dispatch differs from the JAX "
                             f"package's in "
                             f"{int((d != want['dispatch']).any(-1).sum())} "
                             f"tokens")
    if not np.array_equal(got.demand.cpu().numpy(), want["demand"]):
        raise AssertionError(f"{what}: demand differs")
    prices = got.prices.cpu().numpy()
    if not np.array_equal(prices.view(np.int32),
                          want["prices"].view(np.int32)):
        raise AssertionError(f"{what}: prices differ by up to "
                             f"{np.abs(prices - want['prices']).max()}")
    err = float(np.abs(got.combine.cpu().numpy() - want["combine"]).max())
    if not err <= COMBINE_TOL:
        raise AssertionError(f"{what}: combine off by {err} (tolerance "
                             f"{COMBINE_TOL})")
    return dict(routed=int(d.sum()), max_price=float(prices.max()),
                combine_err=err)


def moe_routers(dev, cfg, want, card: str, tag: str = "moe") -> dict:
    """The port's ``auction_route`` and ``topk_route`` on the card, on the
    JAX package's gate logits of each MoE layer of the prefill and on the
    skewed score set, at the prefill's capacity, against the JAX
    package's routing of the same scores (``check_routing``); each router
    timed once per score set."""
    from repro_torch.core.routing import auction_route, topk_route
    e = cfg.moe
    cap = int(want["capacity"])
    fields = ("dispatch", "combine", "prices", "demand")
    n = len(want["prefill_scores"])
    sets = [(f"prefill layer {int(layer)}", "prefill", i) for i, layer in
            enumerate(want.get("moe_layers", range(n)))]
    sets.append(("skewed", "skewed", ...))
    out = {}
    for what, prefix, at in sets:
        scores = want[f"{prefix}_scores"][at]
        s = torch.tensor(scores, device=dev)
        routers = {"auction": lambda: auction_route(
                       s, e.top_k, cap, n_iters=e.router_iters),
                   "topk": lambda: topk_route(s, e.top_k, cap)}
        for name, route in routers.items():
            res = check_routing(
                route(), {f: want[f"{prefix}_{name}_{f}"][at] for f in fields},
                f"{name}_route on {what}")
            res["ms"] = time_ms(route).ms
            out[f"{name} {what}"] = res
            log(f"[{tag}] {name}_route on the card, {what} "
                f"{tuple(scores.shape)}, capacity {cap}: equal to the JAX "
                f"package's (dispatch, demand, prices; combine within "
                f"{res['combine_err']:.3g}); {res['routed']} routed, prices "
                f"up to {res['max_price']:.6g}; device {res['ms']:.4f} ms "
                f"on {card}")
    return out


def local_marks(want, layer: int):
    """The prefill tokens marked unstable in MoE layer ``layer`` (index
    into the npz's MoE layers), where such a mark can move nothing but its
    own token's last hidden row, else None. That holds when the layer is
    the model's last (no later layer reads the row, and every cache is
    built from the layers' inputs, free of this routing), the auction's
    largest demand there is below capacity - 1 (one moved pick cannot fill
    an expert) and no price rose (no token bid against another): then the
    auction is every token's own top-k. Constants without per-token marks
    (phi3.5-moe's) give None."""
    if "prefill_token_unstable" not in want:
        return None
    cap = int(want["capacity"])
    if (int(want["moe_layers"][layer]) != int(want["n_layers"]) - 1
            or int(want["prefill_auction_demand"][layer].max()) >= cap - 1
            or bool((want["prefill_auction_prices"][layer] > 0).any())):
        return None
    return np.asarray(want["prefill_token_unstable"][layer], bool)


def moe_stops(want) -> tuple[list, str]:
    """Per request, the first step not compared with the JAX constants,
    and why. An unstable prefill routing decision stops every request at
    step 0 (capacity couples all tokens, and the caches carry it on),
    unless ``local_marks`` confines it to its own token: then it stops
    only the request whose last prompt position it is (the prefill reads
    only that row's logits). Past that, each request stops at the first
    decode step in which its routing is unstable in some layer (decode
    routes each token on its own)."""
    B = want["decode_unstable"].shape[-1]
    n_steps = want["decode_unstable"].shape[0] + 1
    S = want["prefill_dispatch"].shape[-2] // B
    layers = want.get("moe_layers", np.arange(len(want["prefill_unstable"])))
    stops, why = [n_steps] * B, []
    for i in np.flatnonzero(want["prefill_unstable"]):
        marks = local_marks(want, i)
        if marks is None:
            return [0] * B, (f"prefill routing unstable at layer "
                             f"{int(layers[i])} "
                             f"({int(want['prefill_flips'][i])} tokens move): "
                             f"nothing compared")
        hit = [b for b in range(B) if marks[(b + 1) * S - 1]]
        for b in hit:
            stops[b] = 0
        why.append(f"prefill routing unstable at layer {int(layers[i])}, "
                   f"the last, only at tokens "
                   f"{np.flatnonzero(marks).tolist()} (slack capacity, no "
                   f"price rose): requests {hit} not compared")
    decode = []
    for b in range(B):
        steps = np.flatnonzero(want["decode_unstable"][:, :, b].any(-1))
        if steps.size and int(steps[0]) + 1 < stops[b]:
            stops[b] = int(steps[0]) + 1
            decode.append(f"request {b} from step {stops[b]}")
    if decode:
        why.append("decode routing unstable: " + ", ".join(decode))
    return stops, "; ".join(why) or "every step's routing stable"


def check_moe_dispatch(seen: list, want, compared: list, n_layers: int):
    """The port's dispatch in each MoE layer of the prefill and of each
    decode step (``record_routing``) against the JAX package's wherever it
    was compared: the prefill's layers up to the first unstable one when
    any request was compared (an unstable layer that ``local_marks``
    confines is compared but for its marked tokens), each decode step of
    request ``b`` before ``compared[b]``. ``n_layers`` counts the MoE
    layers. A difference there fails the run: JAX's routing was stable.
    Returns the layers and token rows held equal."""
    if len(seen) != n_layers * (want["decode_dispatch"].shape[0] + 1):
        raise AssertionError(f"moe: {len(seen)} router calls")
    rows = 0
    if max(compared) > 0:
        for layer in range(n_layers):
            d = seen[layer][2].cpu().numpy()
            ref = want["prefill_dispatch"][layer]
            keep = np.ones(ref.shape[:-1], bool)
            if want["prefill_unstable"][layer]:
                marks = local_marks(want, layer)
                if marks is None:
                    break
                keep = ~marks.reshape(keep.shape)
            if not np.array_equal(d[keep], ref[keep]):
                raise AssertionError(f"moe prefill layer {layer}: the port's "
                                     f"dispatch differs from JAX's stable one")
            rows += int(keep.sum())
    for i, (_, _, d) in enumerate(seen[n_layers:]):
        t, layer = divmod(i, n_layers)
        d = d.cpu().numpy()
        for b, n in enumerate(compared):
            if t + 1 < n:
                if not np.array_equal(d[..., b, :],
                                      want["decode_dispatch"][t, layer, ..., b, :]):
                    raise AssertionError(
                        f"moe decode step {t + 1} layer {layer} request {b}: "
                        f"the port's dispatch differs from JAX's stable one")
                rows += 1
    return rows


def unmarked_flips(seen: list, want, port_tokens: np.ndarray,
                   jax_tokens: np.ndarray) -> dict:
    """The routing decisions of the port's own generation (``seen``, as
    ``record_routing`` gives it) that differ from the JAX package's where
    JAX's marks call them stable: per MoE layer of the prefill, the token
    rows not marked in ``prefill_token_unstable``; per decode step, MoE
    layer and request not marked in ``decode_unstable``, while the
    request's tokens fed so far are JAX's (the step's inputs are then
    JAX's up to rounding). Returns how many differ and how many were
    compared, prefill and decode, and the first (layer, token) and (step,
    layer, request) that differ."""
    n = len(want["prefill_scores"])
    out = dict(prefill=0, prefill_rows=0, decode=0, decode_rows=0,
               prefill_at=[], decode_at=[])
    for layer in range(n):
        ref = want["prefill_dispatch"][layer]
        keep = ~np.asarray(want["prefill_token_unstable"][layer],
                           bool).reshape(ref.shape[:-1])
        moved = (seen[layer][2].cpu().numpy() != ref).any(-1) & keep
        out["prefill"] += int(moved.sum())
        out["prefill_rows"] += int(keep.sum())
        out["prefill_at"] += [(layer, int(t)) for t in
                              np.flatnonzero(moved)[:8]]
    for i, (_, _, d) in enumerate(seen[n:]):
        t, layer = divmod(i, n)     # decode call t feeds token t
        d = d.cpu().numpy()
        for b in range(port_tokens.shape[0]):
            if (want["decode_unstable"][t, layer, b] or not np.array_equal(
                    port_tokens[b, :t + 1], jax_tokens[b, :t + 1])):
                continue
            out["decode_rows"] += 1
            ref = want["decode_dispatch"][t, layer, ..., b, :]
            if not np.array_equal(d[..., b, :], ref):
                out["decode"] += 1
                out["decode_at"].append((t + 1, layer, b))
    return out


def device_split(rows) -> dict:
    """Device ms of a profile's rows by kernel name: K6 (``flash_fwd_``),
    matrix products (``gemm``), sorts and top-k (the routers' and the
    dispatch's), gathers, scatters and indexing (dispatch and combine),
    and the rest (elementwise, reductions, copies)."""
    classes = (("K6", ("flash_fwd_",)), ("gemm", ("gemm",)),
               ("sort/topk", ("sort", "topk", "radix", "bitonic")),
               ("index/scatter/gather", ("index", "scatter", "gather")))
    out = {name: 0.0 for name, _ in classes}
    out["other"] = 0.0
    for us, _, key in rows:
        low = key.lower()
        name = next((n for n, pats in classes
                     if any(p in low for p in pats)), "other")
        out[name] += us / 1e3
    return out


def routed_serve(tag: str, dev, counts: dict, model, want: dict, routing,
                 card: str) -> dict:
    """A warm-up and two timed generations of SERVE_B x SERVE_S prompts
    and SERVE_NEW tokens on a routed model, each held to the JAX constants
    (``want``) by ``check_serve`` up to ``moe_stops`` and the port's
    dispatch to JAX's where it was compared (``check_moe_dispatch``); K6
    launched once per layer in each prefill, all on ``flash_fwd_mma``,
    never in decode, and no other port kernel; then one profiled prefill
    and one profiled decode step. ``tag`` names the phase in the log and
    in ``counts``."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    cfg = model.cfg
    prompts = torch.tensor(serve_prompts(cfg.vocab, SERVE_B, SERVE_S),
                           device=dev)
    stops, why = moe_stops(routing)
    S_max = SERVE_S + SERVE_NEW
    walls, own = [], []
    for run in ("warm-up", "run 1", "run 2"):
        with record_routing() as seen:
            steps, t_pre, t_steps, c_pre, c_steps, state = port_serve(
                model, prompts, SERVE_NEW, S_max)
        got = check_serve(steps, want["steps"], stop=stops)
        rows = check_moe_dispatch(seen, routing, got["steps_compared"],
                                  len(routing["prefill_scores"]))
        tokens = np.stack([t for t, _ in steps], 1)
        flips = (unmarked_flips(seen, routing, tokens,
                                np.asarray(want["tokens"]))
                 if "prefill_token_unstable" in routing else None)
        if c_pre["flash_attention_fwd"] != cfg.n_layers:
            raise AssertionError(f"{tag} prefill: K6 launched "
                                 f"{c_pre['flash_attention_fwd']} times, not "
                                 f"once per layer ({cfg.n_layers})")
        require_not_launched(c_pre, [n for n in c_pre
                                     if n != "flash_attention_fwd"],
                             f"{tag} prefill")
        for c in c_steps:
            require_not_launched(c, list(c), f"{tag} decode step")
        log(f"[{tag}] {run}: prefill {t_pre * 1e3:.2f} ms "
            f"({SERVE_B * SERVE_S / t_pre:.0f} tok/s), decode "
            f"{np.mean(t_steps) * 1e3:.3f} ms per token step "
            f"({SERVE_B / np.mean(t_steps):.0f} tok/s); JAX check {got}, "
            f"stopped where {why}; {rows} routed token rows held to JAX's "
            f"dispatch; the port's own routing off JAX's at decisions JAX "
            f"marked stable: {flips}; request 0 tokens {tokens[0].tolist()}")
        own.append(flips)
        if run != "warm-up":
            walls.append((t_pre, float(np.mean(t_steps))))
            counts.setdefault(f"{tag}_prefill", c_pre)
            counts.setdefault(f"{tag}_decode", {
                n: sum(c[n] for c in c_steps) for n in c_pre})
    pinned = None
    if min(stops) == 0:
        pinned = pinned_serve(tag, model, prompts, want, routing)
    t_pre = sum(w[0] for w in walls) / len(walls)
    t_step = sum(w[1] for w in walls) / len(walls)
    caches = init_caches(cfg, SERVE_B, S_max, dtype=torch.float32,
                         device=dev)
    pre = profile_k6(f"{tag} prefill 8 x 1024", t_pre, "flash_fwd_mma",
                     cfg.n_layers, make_prefill_step(model), prompts, caches,
                     top=16, split=True)
    dec = profile(f"{tag} decode step", t_step, make_serve_step(model),
                  state, top=16, split=True)
    log(f"[{tag}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
    return dict(walls=walls, prefill=pre, decode=dec, stops=stops, why=why,
                pinned=pinned, own_routing=own)


def pinned_serve(tag: str, model, prompts, want: dict, routing) -> dict:
    """One more generation, untimed, whose prefill routes on the JAX
    package's gate logits (``pinned_prefill_routing``): where the JAX side
    marked prefill routing decisions that float32 rounding can flip, this
    holds everything else end to end (attention, the dense and expert
    products, combine, caches, the decode steps) to the JAX constants by
    ``check_serve``, stopping only at unstable decode routing, with the
    prefill's dispatch equal to JAX's and each decode step's where
    compared."""
    if model.cfg.moe.router != "flow":
        raise AssertionError(f"{tag}: pinned routing is for the auction")
    stable = dict(routing, prefill_unstable=np.zeros_like(
        routing["prefill_unstable"]))
    stops, why = moe_stops(stable)
    with pinned_prefill_routing(routing["prefill_scores"]) as diffs, \
            record_routing() as seen:
        steps, *_ = port_serve(model, prompts, SERVE_NEW,
                               SERVE_S + SERVE_NEW)
    got = check_serve(steps, want["steps"], stop=stops)
    rows = check_moe_dispatch(seen, stable, got["steps_compared"],
                              len(routing["prefill_scores"]))
    log(f"[{tag}] pinned prefill routing (JAX's gate logits; the port's "
        f"differ by up to {diffs} of their largest |logit|): JAX check "
        f"{got}, stopped where {why}; {rows} routed token rows held to "
        f"JAX's dispatch")
    return dict(got, logit_diff=diffs, rows=rows)


def routed_model(tag: str, cfg, dev):
    """``cfg``'s model on ``numpy_params`` weights (seed SEED) on ``dev``,
    logged with its size and how long numpy took to draw it."""
    from repro_torch.interop import model_from_params, numpy_params
    t0 = time.perf_counter()
    params = numpy_params(cfg, SEED)
    t_numpy = time.perf_counter() - t0
    model = model_from_params(cfg, params, device=dev)
    del params
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts of {cfg.moe.d_ff_expert}, top "
        f"{cfg.moe.top_k}, router {cfg.moe.router}: {n_params} parameters "
        f"on the card ({torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated) in {time.perf_counter() - t0:.1f} s ({t_numpy:.1f} s "
        f"of it numpy)")
    return model, n_params


def load_constants(constants: pathlib.Path, routing: pathlib.Path,
                   setup: dict) -> tuple[dict, dict]:
    """A routed phase's JAX constants (JSON and npz), checked to have been
    made for ``setup``."""
    want = json.loads(constants.read_text())
    if {k: want[k] for k in setup} != setup:
        raise AssertionError(f"{constants.name} was made for "
                             f"{ {k: want[k] for k in setup} }, not {setup}")
    return want, dict(np.load(routing))


def phase_moe(dev, counts: dict, card: str) -> dict:
    """phi3.5-moe at full width and MOE_LAYERS layers on ``numpy_params``
    weights: the routers on the card against the JAX package's routing of
    its own gate logits (``moe_routers``), then ``routed_serve``."""
    from repro_torch.configs.base import get_config
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the MoE check assumes "
                             "full float32")
    want, routing = load_constants(MOE_CONSTANTS, MOE_ROUTING, moe_setup())
    cfg = moe_config(get_config(MOE_ARCH))
    routers = moe_routers(dev, cfg, routing, card)
    model, n_params = routed_model("moe", cfg, dev)
    out = routed_serve("moe", dev, counts, model, want, routing, card)
    return dict(out, routers=routers, n_params=n_params)


def phase_mla(dev, counts: dict, card: str) -> dict:
    """deepseek-v2 at full width and DS_LAYERS layers (the dense prefix,
    then MLA and the MoE) on ``numpy_params`` weights: the routers on the
    card against the JAX package's routing of layer 1's gate logits and of
    the skewed set (a price must rise there); one prefill's hidden state
    after layer 0 and layer 0's cache rows against JAX's
    (``check_layer0``: MLA prefill, K6 at dh 192 / dv 128, RoPE, both
    norms, the cache layout and the dense prefix, free of routing); then
    ``routed_serve``."""
    from repro_torch.configs.base import get_config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the MLA check assumes "
                             "full float32")
    want, routing = load_constants(MLA_CONSTANTS, MLA_ROUTING, mla_setup())
    cfg = mla_config(get_config(MLA_ARCH))
    routers = moe_routers(dev, cfg, routing, card, "mla")
    if not routers["auction skewed"]["max_price"] > 0:
        raise AssertionError("mla: the auction raised no price on the "
                             "skewed set")
    model, n_params = routed_model("mla", cfg, dev)
    prompts = torch.tensor(serve_prompts(cfg.vocab, SERVE_B, SERVE_S),
                           device=dev)
    layer0 = check_layer0(layer0_rows(model, prompts, SERVE_S + SERVE_NEW),
                          routing)
    log(f"[mla] layer 0 after one prefill, at {len(sample_positions())} "
        f"positions of each request: hidden state and c_kv / k_rope cache "
        f"rows within LOGIT_TOL of JAX's (error / tolerance {layer0})")
    out = routed_serve("mla", dev, counts, model, want, routing, card)
    flips = max(f["prefill"] + f["decode"] for f in out["own_routing"])
    if flips > MLA_UNMARKED_FLIPS:
        raise AssertionError(f"mla: the port's own routing differs from "
                             f"JAX's at {flips} decisions JAX marked stable "
                             f"(allowed {MLA_UNMARKED_FLIPS}): "
                             f"{out['own_routing']}")
    return dict(out, routers=routers, n_params=n_params, layer0=layer0)


def phase_ssm(dev, counts: dict, card: str) -> dict:
    """mamba2-370m at full width and depth on ``numpy_params`` weights:
    one prefill's SSM rows against JAX's (``check_ssm_rows``: the conv,
    the SSD chunk scan over 4 chunks of 256, the state at the first and
    the last layer); a warm-up and two timed generations of SERVE_B x
    SERVE_S prompts and SERVE_NEW tokens, each held to the JAX package's
    constants, no port kernel launched in a prefill or a decode step;
    then one profiled prefill and one profiled decode step."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the SSM check assumes "
                             "full float32")
    want, rows_want = load_constants(SSM_CONSTANTS, SSM_STATES, ssm_setup())
    cfg = get_config(SSM_ARCH)
    t0 = time.perf_counter()
    params = numpy_params(cfg, SEED)
    t_numpy = time.perf_counter() - t0
    model = model_from_params(cfg, params, device=dev)
    del params
    n_params = sum(p.numel() for p in model.parameters())
    s = cfg.ssm
    log(f"[ssm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {s.d_inner(cfg.d_model)}, {s.n_heads(cfg.d_model)} heads "
        f"of {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}: {n_params} "
        f"parameters on the card ({torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB allocated) in {time.perf_counter() - t0:.1f} s "
        f"({t_numpy:.1f} s of it numpy)")
    prompts = torch.tensor(serve_prompts(cfg.vocab, SERVE_B, SERVE_S),
                           device=dev)
    S_max = SERVE_S + SERVE_NEW
    rows = check_ssm_rows(ssm_rows(model, prompts, S_max), rows_want)
    log(f"[ssm] after one prefill, requests 0-{SSM_REQUESTS - 1}: SSM state "
        f"and conv rows of layers {SSM_LAYERS} within LOGIT_TOL of JAX's "
        f"(error / tolerance {rows})")
    walls = []
    for run in ("warm-up", "run 1", "run 2"):
        steps, t_pre, t_steps, c_pre, c_steps, state = port_serve(
            model, prompts, SERVE_NEW, S_max)
        got = check_serve(steps, want["steps"])
        require_not_launched(c_pre, list(c_pre), "ssm prefill")
        for c in c_steps:
            require_not_launched(c, list(c), "ssm decode step")
        tokens = np.stack([t for t, _ in steps], 1)
        log(f"[ssm] {run}: prefill {t_pre * 1e3:.2f} ms "
            f"({SERVE_B * SERVE_S / t_pre:.0f} tok/s), decode "
            f"{np.mean(t_steps) * 1e3:.3f} ms per token step "
            f"({SERVE_B / np.mean(t_steps):.0f} tok/s); JAX check {got}; "
            f"request 0 tokens {tokens[0].tolist()}")
        if run != "warm-up":
            walls.append((t_pre, float(np.mean(t_steps))))
            counts.setdefault("ssm_prefill", c_pre)
            counts.setdefault("ssm_decode", {
                n: sum(c[n] for c in c_steps) for n in c_pre})
    t_pre = sum(w[0] for w in walls) / len(walls)
    t_step = sum(w[1] for w in walls) / len(walls)
    caches = init_caches(cfg, SERVE_B, S_max, dtype=torch.float32,
                         device=dev)
    pre = profile("ssm prefill 8 x 1024", t_pre, make_prefill_step(model),
                  prompts, caches, top=16, split=True)
    dec = profile("ssm decode step", t_step, make_serve_step(model), state,
                  top=16, split=True)
    for what, prof in (("prefill", pre), ("decode step", dec)):
        if prof["port_kernels"]:
            raise AssertionError(f"ssm {what}: port kernels "
                                 f"{prof['port_kernels']} in the profile")
    peak = torch.cuda.max_memory_allocated()
    log(f"[ssm] peak device memory {peak / 2**30:.2f} GiB; on {card}")
    return dict(walls=walls, prefill=pre, decode=dec, rows=rows,
                n_params=n_params, peak_bytes=peak)


def train_setup() -> dict:
    return dict(arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S, n_steps=TRAIN_STEPS,
                seed=SEED, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                leaves=list(TRAIN_LEAVES),
                rows_numpy=str(np.load(TRAIN_ROWS)["numpy_version"]))


def encoder_setup() -> dict:
    return dict(arch=ENCODER_ARCH, B=ENC_B, S=ENC_S, train_B=ENC_TRAIN_B,
                n_steps=ENC_STEPS, seed=SEED, lr=TRAIN_LR,
                warmup=TRAIN_WARMUP, leaves=list(ENCODER_LEAVES),
                sample=TRAIN_SAMPLE,
                positions=sample_positions(ENC_S).tolist())


def kvq_setup() -> dict:
    return dict(arch=SERVE_ARCH, kv_quant=True, B=SERVE_B, S=SERVE_S,
                max_new=SERVE_NEW, seed=SEED)


def encoder_data(global_batch: int):
    """The encoder phase's ``DataConfig`` (either package's ``DataConfig``
    takes these fields): hubert's vocab, ENC_S frames of its frontend
    width, seed SEED."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    cfg = get_config(ENCODER_ARCH)
    return DataConfig(vocab=cfg.vocab, seq_len=ENC_S,
                      global_batch=global_batch, seed=SEED,
                      frontend_dim=cfg.frontend_dim)


def rows_digest(batch: dict) -> str:
    """SHA-256 of a frames batch's rows: the bytes of ``embeds`` (float32)
    then of ``labels`` (int32), numpy arrays or tensors."""
    import hashlib
    h = hashlib.sha256()
    for key in ("embeds", "labels"):
        x = batch[key]
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    """A port parameter (or its gradient) in the JAX layout, as numpy: an
    ``nn.Linear`` weight transposed back to the ``x @ W`` matrix."""
    t = t.detach().float().cpu()
    return (t.T if name.endswith(".weight") else t).numpy()


def check_train_grads(grads: dict, want: dict) -> dict:
    """The step-0 gradients of TRAIN_LEAVES at the JAX constants' sampled
    flat indices (JAX layout), each within TRAIN_GRAD_TOL x the leaf's
    largest |g| (JAX's). Returns error / tolerance per leaf."""
    out = {}
    for name, rec in want.items():
        got = jax_layout(name, grads[name])
        if list(got.shape) != rec["shape"]:
            raise AssertionError(f"train grad {name}: shape {got.shape}, "
                                 f"JAX's {rec['shape']}")
        vals = got.reshape(-1)[np.asarray(rec["index"])].astype(np.float64)
        tol = TRAIN_GRAD_TOL * rec["absmax"]
        err = np.abs(vals - np.asarray(rec["value"])).max()
        if not err <= tol:
            raise AssertionError(f"train step-0 grad of {name}: max abs "
                                 f"err {err:.3g} > {tol:.3g} at the "
                                 f"sampled indices")
        out[name] = float(err / tol)
    return out


def check_train_metrics(step: int, m: dict, want: dict) -> dict:
    """One step's loss and grad_norm within their tolerances of JAX's
    (relative), its lr JAX's float32. Returns error / tolerance."""
    lr = float(m["lr"])
    if np.float32(lr) != np.float32(want["lr"]):
        raise AssertionError(f"train step {step}: lr {lr} != JAX's "
                             f"{want['lr']}")
    out = {}
    for key, tol in (("loss", TRAIN_LOSS_TOL),
                     ("grad_norm", TRAIN_NORM_TOL)):
        err = abs(float(m[key]) - want[key]) / abs(want[key])
        if not err <= tol:
            raise AssertionError(f"train step {step}: {key} "
                                 f"{float(m[key])} vs JAX's {want[key]}: "
                                 f"relative error {err:.3g} > {tol}")
        out[key] = err / tol
    return out


def phase_train(dev, counts: dict, card: str) -> dict:
    """smollm-135m at full width and depth, trained on the card from
    ``numpy_params`` weights: the step-0 gradients of TRAIN_LEAVES and
    TRAIN_STEPS steps of ``make_train_step`` (the first a warm-up, the
    others timed) held to the JAX package's constants, K6 launched twice
    per layer in each step (the forward and remat ``"full"``'s recompute;
    set to 0 just before it, read just after) and no other port kernel; a
    save and restore of the train state through ``checkpoint.store`` bit
    for bit; one profiled step (every port kernel in it
    ``flash_fwd_wgmma``, two per layer) and the peak device
    memory."""
    import shutil

    from repro_torch.checkpoint import store
    from repro_torch.configs.base import get_config
    from repro_torch.core.masking import tree_leaves
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        load_state_tree, loss_fn,
                                        make_train_step, params_of,
                                        state_tree)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the train check assumes "
                             "full float32")
    want = json.loads(TRAIN_CONSTANTS.read_text())
    setup = train_setup()
    if {k: want[k] for k in setup} != setup:
        raise AssertionError(f"{TRAIN_CONSTANTS.name} was made for "
                             f"{ {k: want[k] for k in setup} }, not {setup}")
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    model = model_from_params(cfg, numpy_params(cfg, SEED), device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                      global_batch=TRAIN_B, seed=SEED)
    batches = [make_batch(dcfg, step, dev) for step in range(TRAIN_STEPS)]
    rows = np.load(TRAIN_ROWS)
    for step, batch in enumerate(batches):
        for key in ("tokens", "labels"):
            if not np.array_equal(batch[key].cpu().numpy(), rows[key][step]):
                raise AssertionError(
                    f"make_batch's {key} of step {step} differ from the rows "
                    f"the JAX constants were made on (numpy "
                    f"{rows['numpy_version']} there, {np.__version__} here): "
                    f"remake {TRAIN_ROWS.name} with "
                    f"tests/torch_smoke_train_rows.py on this machine, then "
                    f"the constants")
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
        f"{cfg.dh}, vocab {cfg.vocab}: {n_params} parameters and "
        f"{TRAIN_STEPS} batches of {TRAIN_B} x {TRAIN_S} tokens on the card "
        f"in {time.perf_counter() - t0:.1f} s")

    params = params_of(model)
    loss, _ = loss_fn(model, batches[0])
    grads = dict(zip(TRAIN_LEAVES, torch.autograd.grad(
        loss, [params[n] for n in TRAIN_LEAVES])))
    del loss
    grad_check = check_train_grads(grads, want["grads"])
    del grads
    log(f"[train] step-0 gradients at {TRAIN_SAMPLE} sampled entries of "
        f"each leaf against JAX's (error / tolerance): {grad_check}")

    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        decay_steps=TRAIN_STEPS))
    state = init_train_state(cfg, tcfg, model)
    step_fn = make_train_step(cfg, tcfg)
    walls, checks = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        (state, m), wall = solve(step_fn, state, batches[step])
        c = read_counts()
        if c["flash_attention_fwd"] != 2 * cfg.n_layers:
            raise AssertionError(f"train step {step}: K6 launched "
                                 f"{c['flash_attention_fwd']} times, not "
                                 f"twice per layer ({2 * cfg.n_layers}: "
                                 f"the forward and remat's recompute)")
        require_not_launched(c, [n for n in c if n != "flash_attention_fwd"],
                             f"train step {step}")
        checks.append(check_train_metrics(step, m, want["steps"][step]))
        ref = want["steps"][step]
        log(f"[train] step {step}{' (warm-up)' if step == 0 else ''}: "
            f"{wall * 1e3:.2f} ms ({TRAIN_B * TRAIN_S / wall:.0f} tok/s), "
            f"loss {float(m['loss']):.6f} (JAX {ref['loss']:.6f}), "
            f"grad_norm {float(m['grad_norm']):.6f} (JAX "
            f"{ref['grad_norm']:.6f}), lr {float(m['lr']):.4g}; error / "
            f"tolerance {checks[-1]}; K6 launches "
            f"{c['flash_attention_fwd']}")
        if step:
            walls.append(wall)
        counts.setdefault("train_step", c)

    path = ROOT / "build" / "train_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    tree = state_tree(state)
    t0 = time.perf_counter()
    store.save(str(path), TRAIN_STEPS, tree)
    back = store.restore(str(path), TRAIN_STEPS, tree, device=dev)
    t_ckpt = time.perf_counter() - t0
    saved, restored = tree_leaves(tree), tree_leaves(back)
    if len(saved) != len(restored) or not all(
            a.dtype == b.dtype and b.device.type == dev.type
            and torch.equal(a, b.to(a.device))
            for a, b in zip(saved, restored)):
        raise AssertionError("train state: a leaf did not come back from "
                             "checkpoint.store bit for bit")
    state = load_state_tree(state, back)
    shutil.rmtree(path, ignore_errors=True)
    log(f"[train] save and restore of the train state ({len(saved)} leaves,"
        f" step {int(state.opt.step)}): every leaf back bit for bit, "
        f"{t_ckpt:.1f} s")

    t_step = sum(walls) / len(walls)
    prof = profile_k6(f"train step {TRAIN_B} x {TRAIN_S}", t_step,
                      "flash_fwd_wgmma", 2 * cfg.n_layers, step_fn, state,
                      batches[0], top=16, split=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"[train] mean of the timed steps {t_step * 1e3:.2f} ms "
        f"({TRAIN_B * TRAIN_S / t_step:.0f} tok/s); peak device memory "
        f"{peak / 2**30:.2f} GiB; on {card}")
    modes = remat_modes("train", cfg, tcfg, state, batches[0], card)
    return dict(walls=walls, profile=prof, peak_bytes=peak,
                grad_check=grad_check, checks=checks, n_params=n_params,
                remat=modes)


def check_encoder_rows(batches: dict, want: dict):
    """The frames and labels the port's ``make_batch`` gave here (``{"forward":
    batch, "train": [batch per step]}``) against the SHA-256 of the rows the
    JAX constants were made on."""
    got = {"forward": rows_digest(batches["forward"]),
           "train": [rows_digest(b) for b in batches["train"]]}
    if got != want["rows"]:
        raise AssertionError(
            f"make_batch's frames or labels differ from the rows the JAX "
            f"constants were made on (numpy {want['numpy_version']} there, "
            f"{np.__version__} here): remake {ENCODER_CONSTANTS.name} with "
            f"tests/torch_smoke_constants.py encoder on rows that match")


def phase_encoder(dev, counts: dict, card: str) -> dict:
    """hubert-xlarge at full width and depth on ``numpy_params`` weights.
    First its encoder forward (``apply_model`` under
    ``torch.inference_mode``) on ENC_B x ENC_S frames: a warm-up and two
    timed runs, each one's logits at ``sample_positions`` held to JAX's
    within LOGIT_TOL x JAX's largest |logit|, K6 launched once per layer
    (non-causal) and no other port kernel, then one profiled run. Then
    training from the same weights: the step-0 gradients of
    ENCODER_LEAVES against JAX's (``embed`` reached by none) and ENC_STEPS
    steps of ``make_train_step`` on ENC_TRAIN_B x ENC_S frames (the first
    a warm-up, the others timed), each step's loss, lr and grad_norm held
    to JAX's, K6 launched twice per layer in each step (remat ``"full"``)
    and no other port kernel; one profiled step, the peak device memory
    and ``remat_modes``. The rows of every batch must be the ones the
    constants were made on."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.interop import model_from_params, numpy_params
    from repro_torch.models.model import apply_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        loss_fn, make_train_step, params_of)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the encoder check assumes "
                             "full float32")
    want = json.loads(ENCODER_CONSTANTS.read_text())
    setup = encoder_setup()
    if {k: want[k] for k in setup} != setup:
        raise AssertionError(f"{ENCODER_CONSTANTS.name} was made for "
                             f"{ {k: want[k] for k in setup} }, not {setup}")
    logits_want = np.load(ENCODER_LOGITS)["logits"]
    cfg = get_config(ENCODER_ARCH)
    t0 = time.perf_counter()
    params = numpy_params(cfg, SEED)
    t_numpy = time.perf_counter() - t0
    model = model_from_params(cfg, params, device=dev)
    del params
    n_params = sum(p.numel() for p in model.parameters())
    fwd = make_batch(encoder_data(ENC_B), 0, dev)
    batches = [make_batch(encoder_data(ENC_TRAIN_B), step, dev)
               for step in range(ENC_STEPS)]
    check_encoder_rows({"forward": fwd, "train": batches}, want)
    log(f"[encoder] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.dh}, d_ff {cfg.d_ff}, "
        f"frontend {cfg.frontend_dim}, vocab {cfg.vocab}, causal "
        f"{cfg.causal}: {n_params} parameters on the card "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated) in "
        f"{time.perf_counter() - t0:.1f} s ({t_numpy:.1f} s of it numpy); "
        f"every batch's rows are the constants'")

    pos = torch.tensor(sample_positions(ENC_S), device=dev)

    @torch.inference_mode()
    def forward():
        return apply_model(model, {"embeds": fwd["embeds"]}).logits

    frames = ENC_B * ENC_S
    walls = []
    for run in ("warm-up", "run 1", "run 2"):
        torch.cuda.synchronize()
        reset_counts()
        logits, wall = solve(forward)
        c = read_counts()
        if c["flash_attention_fwd"] != cfg.n_layers:
            raise AssertionError(f"encoder forward: K6 launched "
                                 f"{c['flash_attention_fwd']} times, not "
                                 f"once per layer ({cfg.n_layers})")
        require_not_launched(c, [n for n in c if n != "flash_attention_fwd"],
                             "encoder forward")
        got = logits[:, pos].float().cpu().numpy()
        del logits
        err = check_rows(got, logits_want, "encoder forward logits",
                         LOGIT_TOL)
        log(f"[encoder] forward {run}: {wall * 1e3:.2f} ms "
            f"({frames / wall:.0f} frames/s); logits at {len(pos)} "
            f"positions of each request within LOGIT_TOL of JAX's (error "
            f"/ tolerance {err:.3g}); K6 launches "
            f"{c['flash_attention_fwd']}")
        if run != "warm-up":
            walls.append(wall)
            counts.setdefault("encoder_forward", c)
    t_fwd = sum(walls) / len(walls)
    prof_fwd = profile_k6(f"encoder forward {ENC_B} x {ENC_S}", t_fwd,
                          "flash_fwd_mma", cfg.n_layers, forward, top=16,
                          split=True)

    params = params_of(model)
    loss, _ = loss_fn(model, batches[0])
    g = torch.autograd.grad(loss, [params[n] for n in ENCODER_LEAVES]
                            + [params["embed"]], allow_unused=True)
    del loss
    if g[-1] is not None:
        raise AssertionError("encoder: the loss reaches embed, which the "
                             "frontend replaces (JAX's gradient there is 0)")
    grad_check = check_train_grads(dict(zip(ENCODER_LEAVES, g)),
                                   want["grads"])
    del g
    log(f"[encoder] step-0 gradients at {TRAIN_SAMPLE} sampled entries of "
        f"each leaf against JAX's (error / tolerance): {grad_check}; none "
        f"reaches embed (JAX's is 0)")

    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP, decay_steps=ENC_STEPS))
    state = init_train_state(cfg, tcfg, model)
    step_fn = make_train_step(cfg, tcfg)
    frames = ENC_TRAIN_B * ENC_S
    steps, checks = [], []
    for step in range(ENC_STEPS):
        torch.cuda.synchronize()
        reset_counts()
        (state, m), wall = solve(step_fn, state, batches[step])
        c = read_counts()
        if c["flash_attention_fwd"] != 2 * cfg.n_layers:
            raise AssertionError(f"encoder train step {step}: K6 launched "
                                 f"{c['flash_attention_fwd']} times, not "
                                 f"twice per layer ({2 * cfg.n_layers}: "
                                 f"the forward and remat's recompute)")
        require_not_launched(c, [n for n in c if n != "flash_attention_fwd"],
                             f"encoder train step {step}")
        checks.append(check_train_metrics(step, m, want["steps"][step]))
        ref = want["steps"][step]
        log(f"[encoder] train step {step}"
            f"{' (warm-up)' if step == 0 else ''}: {wall * 1e3:.2f} ms "
            f"({frames / wall:.0f} frames/s), loss {float(m['loss']):.6f} "
            f"(JAX {ref['loss']:.6f}), grad_norm "
            f"{float(m['grad_norm']):.6f} (JAX {ref['grad_norm']:.6f}), lr "
            f"{float(m['lr']):.4g}; error / tolerance {checks[-1]}; K6 "
            f"launches {c['flash_attention_fwd']}")
        if step:
            steps.append(wall)
        counts.setdefault("encoder_train_step", c)
    t_step = sum(steps) / len(steps)
    prof_step = profile_k6(f"encoder train step {ENC_TRAIN_B} x {ENC_S}",
                           t_step, "flash_fwd_mma", 2 * cfg.n_layers, step_fn,
                           state, batches[0], top=16, split=True)
    peak = torch.cuda.max_memory_allocated()
    log(f"[encoder] forward {t_fwd * 1e3:.2f} ms ({ENC_B * ENC_S / t_fwd:.0f}"
        f" frames/s), train step {t_step * 1e3:.2f} ms "
        f"({frames / t_step:.0f} frames/s), means of the timed runs; peak "
        f"device memory {peak / 2**30:.2f} GiB; on {card}")
    modes = remat_modes("encoder", cfg, tcfg, state, batches[0], card)
    return dict(forward_walls=walls, step_walls=steps, forward=prof_fwd,
                step=prof_step, peak_bytes=peak, grad_check=grad_check,
                checks=checks, n_params=n_params, remat=modes)


def profile_k6(what: str, wall: float, kernel: str, n: int, fn, *a,
               **kw) -> dict:
    """``profile`` of one run of ``fn``, whose profile must hold ``n`` K6
    launches, every one on ``kernel``, and no other port kernel."""
    prof = profile(what, wall, fn, *a, **kw)
    seen = {name: m for name, (_, m) in prof["port_kernels"].items()}
    if seen != {kernel: n}:
        raise AssertionError(f"{what}: the profile saw port kernels {seen}, "
                             f"not {n} launches of {kernel}")
    return prof


def kvq_rows(model, prompts: torch.Tensor, S_max: int) -> dict:
    """One prefill of ``prompts`` into the int8 cache and one into a float
    cache: per layer of KVQ_LAYERS, the largest |codes x scale - float|
    of k and v over the prompt as a share of the row's scale (one code
    step; rounding gives at most half of it)."""
    import dataclasses

    from repro_torch.models.model import init_caches
    from repro_torch.serve.engine import make_prefill_step
    B, S = prompts.shape
    prefill = make_prefill_step(model)
    fcfg = dataclasses.replace(model.cfg, kv_quant=False)
    _, sq = prefill(prompts, init_caches(model.cfg, B, S_max,
                                         dtype=torch.float32,
                                         device=prompts.device))
    _, sf = prefill(prompts, init_caches(fcfg, B, S_max, dtype=torch.float32,
                                         device=prompts.device))
    out = {}
    for i in KVQ_LAYERS:
        cq, cf = sq.caches[i], sf.caches[i]
        for name, q, s, x in (("k", cq.k_q, cq.k_s, cf.k),
                              ("v", cq.v_q, cq.v_s, cf.v)):
            q, s, x = q[:, :S], s[:, :S], x[:, :S]
            err = ((q.float() * s - x).abs() / s.clamp_min(1e-30)).max()
            out[f"layer {i} {name}"] = float(err)
            if not float(err) <= 1.0:
                raise AssertionError(f"kvq layer {i} {name}: dequantised "
                                     f"cache off the float cache's by "
                                     f"{float(err):.3g} code steps")
    return out


def phase_kvq(dev, counts: dict, card: str, float_step: float) -> dict:
    """smollm-135m with ``kv_quant=True`` at full width and depth on the
    serve phase's ``numpy_params`` weights and prompts: its generations
    held to the JAX package's kv-quant constants (``serve_generations``);
    then, after one more prefill, the int8 cache of layers KVQ_LAYERS
    dequantised within one code step of the float cache of the same
    prefill (``kvq_rows``); the decode step's wall beside the float
    cache's (``float_step``, phase_serve's) and the cache's bytes."""
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(SERVE_ARCH), kv_quant=True)
    out = serve_generations("kvq", dev, counts, cfg, KVQ_CONSTANTS,
                            kvq_setup())
    rows = kvq_rows(out["model"], out["prompts"], SERVE_S + SERVE_NEW)
    log(f"[kvq] after one prefill: the int8 cache of layers {KVQ_LAYERS} "
        f"dequantised within one code step of the float cache's (largest "
        f"error in code steps {rows})")
    caches = out["state"].caches
    q_bytes = sum(x.numel() * x.element_size() for c in caches
                  for x in c[:4])
    f_bytes = 2 * 4 * sum(c.k_q.numel() for c in caches)
    log(f"[kvq] decode step {out['t_step'] * 1e3:.3f} ms on the int8 cache, "
        f"{float_step * 1e3:.3f} ms on the float32 cache (phase_serve); "
        f"cache {q_bytes} bytes (int8 codes and float32 scales) against "
        f"{f_bytes} in float32 ({q_bytes / f_bytes:.3f}); on {card}")
    return dict(walls=out["walls"], prefill=out["prefill"],
                decode=out["decode"], rows=rows, cache_bytes=q_bytes,
                float_cache_bytes=f_bytes)


def start_dryrun() -> list:
    """Start the ``meta`` counts in processes of their own (no card: each
    sees no CUDA device): the ``--all`` sweep and the train phases'
    predictions. Returns ``[(name, process, log file)]``."""
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    cmds = {
        "all": [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                "--out", str(DRYRUN_DIR / "all.json")],
        "train": [sys.executable, "-c",
                  "import chip_smoke; chip_smoke.write_train_predictions("
                  f"{str(DRYRUN_DIR / 'train.json')!r})"]}
    jobs = []
    for name, cmd in cmds.items():
        fh = open(DRYRUN_DIR / f"{name}.log", "w")
        jobs.append((name, subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=fh,
                                            stderr=subprocess.STDOUT), fh))
    return jobs


def stop_dryrun(jobs: list) -> None:
    for _, proc, fh in jobs:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        fh.close()


def finish_dryrun(jobs: list) -> dict:
    """Wait for the ``meta`` counts; their JSON by job name."""
    out = {}
    for name, proc, fh in jobs:
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        finally:
            stop_dryrun([(name, proc, fh)])
        if rc != 0:
            tail = (DRYRUN_DIR / f"{name}.log").read_text()[-3000:]
            raise AssertionError(f"dry run job {name} exited {rc}:\n{tail}")
        out[name] = json.loads((DRYRUN_DIR / f"{name}.json").read_text())
    return out


def train_predictions() -> dict:
    """The train phases' steps counted on ``meta``, float32 as the phases
    run them, under each of REMAT_MODES: ``{"train" | "encoder": {mode:
    {peak_bytes, entry_bytes, flops, bytes, k6}}}``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.specs import train_cell
    from repro_torch.roofline_hlo import analyze
    out = {}
    for tag, arch, B, S in (("train", TRAIN_ARCH, TRAIN_B, TRAIN_S),
                            ("encoder", ENCODER_ARCH, ENC_TRAIN_B, ENC_S)):
        out[tag] = {}
        for mode in REMAT_MODES:
            cfg = dataclasses.replace(get_config(arch), remat=mode)
            cell = train_cell(cfg, B, S, param_dtype=torch.float32)
            acc = analyze(cell.fn, *cell.args)
            out[tag][mode] = dict(
                peak_bytes=acc["peak_bytes"], entry_bytes=acc["entry_bytes"],
                flops=acc["flops"], bytes=acc["bytes"],
                k6=acc["by_op"]["repro_torch.flash_attention_fwd"]["count"])
    return out


def write_train_predictions(path: str) -> None:
    pathlib.Path(path).write_text(json.dumps(train_predictions()))


def remat_modes(tag: str, cfg, tcfg, state, batch, card: str) -> dict:
    """The train phase's model under each of REMAT_MODES: the gradients of
    ``loss_fn`` on ``batch``, every one equal to ``"full"``'s bit for bit
    (a dense model: the recompute runs the same kernels on the same
    inputs), K6 launched twice a layer under ``"full"`` and ``"dots"``
    and once under ``"none"``; then, under each mode, a warm-up step and a
    timed one, its wall and peak device memory beside the dry run's
    prediction (the peak above what the step finds allocated, against
    the predicted peak above the step's inputs: the caller still holds
    the train state it passed in, whose moments the steps replace)."""
    from repro_torch.train.step import loss_fn, make_train_step, params_of
    pred = json.loads((DRYRUN_DIR / "train.json").read_text())[tag]
    params = params_of(state.model)
    names = list(params)
    full = None
    for mode in REMAT_MODES:
        want_k6 = cfg.n_layers * (1 if mode == "none" else 2)
        torch.cuda.synchronize()
        reset_counts()
        loss, _ = loss_fn(state.model, batch, remat=mode)
        g = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
        torch.cuda.synchronize()
        c = read_counts()
        if c["flash_attention_fwd"] != want_k6 or pred[mode]["k6"] != want_k6:
            raise AssertionError(f"{tag} gradients under remat {mode}: K6 "
                                 f"launched {c['flash_attention_fwd']} times"
                                 f" (the dry run counts {pred[mode]['k6']}),"
                                 f" not {want_k6}")
        if full is None:
            full = g
        else:
            differ = [n for n, a, b in zip(names, full, g)
                      if (a is None) != (b is None)
                      or (a is not None and not torch.equal(a, b))]
            if differ:
                raise AssertionError(f"{tag}: the gradients under remat "
                                     f"{mode} differ from full's in "
                                     f"{differ[:4]} ({len(differ)} leaves)")
        del g, loss
    del full
    log(f"[{tag}] remat: the gradients under none and dots equal full's bit "
        f"for bit in all {len(names)} leaves; K6 launches {cfg.n_layers} "
        f"(none) and {2 * cfg.n_layers} (full, dots)")
    out = {}
    for mode in REMAT_MODES:
        step = make_train_step(dataclasses.replace(cfg, remat=mode), tcfg)
        state, _ = step(state, batch)       # warm-up: the allocator grows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        (state, m), wall = solve(step, state, batch)
        c = read_counts()
        peak = torch.cuda.max_memory_allocated()
        p = pred[mode]
        out[mode] = dict(wall=wall, peak=peak, peak_above=peak - base,
                         predicted_peak=p["peak_bytes"],
                         predicted_above=p["peak_bytes"] - p["entry_bytes"],
                         k6=c["flash_attention_fwd"],
                         loss=float(m["loss"]))
        log(f"[{tag}] remat {mode}: train step {wall * 1e3:.2f} ms, K6 "
            f"{c['flash_attention_fwd']}; peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the "
            f"step's {base / 2**30:.2f}); the dry run predicts "
            f"{p['peak_bytes'] / 2**30:.2f} GiB "
            f"({out[mode]['predicted_above'] / 2**30:.2f} above the inputs' "
            f"{p['entry_bytes'] / 2**30:.2f}); on {card}")
    return out


def dryrun_line(r: dict) -> str:
    if r["status"] != "ok":
        return f"{r['arch']}/{r['shape']}: {r['status']} ({r.get('reason')})"
    fits = "fits" if r["bytes_per_chip"] <= 80e9 else "does not fit"
    return (f"{r['arch']}/{r['shape']}: flops {r['flops_per_chip']:.4g}, "
            f"bytes {r['bytes_per_chip_accessed']:.4g}, predicted "
            f"{r['bytes_per_chip'] / 2**30:.2f} GiB per card ({fits} one "
            f"80 GB card), t=(c {r['t_compute_ms']:.2f} | m "
            f"{r['t_memory_ms']:.2f} | x {r['t_collective_ms']:.2f}) ms, "
            f"bound by {r['bottleneck']}, roofline {r['roofline_frac']:.3f},"
            f" K6 {r['k6_launches']}, counted in {r['count_s']} s")


def last_logits(out) -> torch.Tensor:
    """A prefill's or decode step's ``(next tokens, ServeState)``: the
    logits that chose the tokens."""
    return out[1].logits


def k6_alone(cfg, B: int, S: int, card: str) -> dict:
    """K6 alone at a prefill's shape of ``cfg`` (``B`` x ``S`` tokens,
    causal, bfloat16, random normal inputs): device ms of one call (3
    calls profiled) against its bound."""
    dims = (B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.dh)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for shape in ((B, S, cfg.n_heads, cfg.dh),
                             (B, S, cfg.n_kv_heads, cfg.dh),
                             (B, S, cfg.n_kv_heads, cfg.dh)))
    t = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True), reps=3,
                symbol="flash_fwd_")
    b = flash_bounds(dims, True, torch.bfloat16)
    log(f"[dryrun] K6 alone at {dims}, causal, bfloat16: {t.ms:.3f} ms "
        f"({t.source}), bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
        f"({t.ms / b['bound_ms']:.2f}x); on {card}")
    return dict(dims=list(dims), ms=t.ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"])


def dryrun_on_card(shape: str, batch: int, counts: dict, card: str,
                   device: str = "cuda") -> dict:
    """DRYRUN_ARCH's cell at ``batch`` rows, counted on ``meta``, then
    built on the card (bf16 weights drawn there) and run twice through
    ``run_cell(device="cuda")``'s count (the warm-up) and once more alone
    (timed): the card's count equal to the ``meta`` count, the peak device
    memory of both runs within DRYRUN_PEAK_TOL of the predicted peak,
    finite logits, K6 launched once a layer in a prefill and never in a
    decode step (counts set to 0 just before each run, read just after)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import SHAPES
    cfg = get_config(DRYRUN_ARCH)
    kind = SHAPES[shape]["kind"]
    want_k6 = cfg.n_layers if kind == "prefill" else 0
    meta = run_cell(DRYRUN_ARCH, shape, batch=batch, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    got = run_cell(DRYRUN_ARCH, shape, device=device, batch=batch,
                   verbose=False, keep_output=True)
    torch.cuda.synchronize()
    t_counted = time.perf_counter() - t0
    c_counted = read_counts()
    if got["status"] != "ok":
        raise AssertionError(f"dry run {DRYRUN_ARCH}/{shape} on the card: "
                             f"{got['error']}")
    peak_counted = torch.cuda.max_memory_allocated() - base
    cell, out = got.pop("cell"), got.pop("out")
    finite = bool(torch.isfinite(last_logits(out)).all())
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out, wall = solve(cell.fn, *cell.args)
    c = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    finite = finite and bool(torch.isfinite(last_logits(out)).all())
    del out, cell
    counts.setdefault(f"dryrun_{kind}", c)
    pred = meta["bytes_per_chip"]
    row = dict(
        batch=batch, wall=wall, counted_s=t_counted, meta=meta,
        flops=got["flops_per_chip"], bytes=got["bytes_per_chip_accessed"],
        card_predicted_peak=got["bytes_per_chip"], predicted_peak=pred,
        peak=peak, peak_counted=peak_counted, k6=c["flash_attention_fwd"],
        k6_counted=c_counted["flash_attention_fwd"],
        t_step=meta["t_step_ms"] / 1e3, bound_by=meta["bottleneck"],
        share=meta["t_step_ms"] / 1e3 / wall)
    log(f"[dryrun] {DRYRUN_ARCH}/{shape} on the card, batch {batch}: wall "
        f"{wall * 1e3:.2f} ms (the counted warm-up with the build "
        f"{t_counted:.1f} s); roofline {meta['t_step_ms']:.2f} ms bound by "
        f"{meta['bottleneck']} (c {meta['t_compute_ms']:.2f} | m "
        f"{meta['t_memory_ms']:.2f} ms), share {row['share']:.3f}; peak "
        f"{peak / 2**30:.3f} GiB (counted run {peak_counted / 2**30:.3f}) "
        f"against {pred / 2**30:.3f} predicted ({peak / pred:.3f}x); flops "
        f"{row['flops']:.6g} and bytes {row['bytes']:.6g} on the card, "
        f"{meta['flops_per_chip']:.6g} and "
        f"{meta['bytes_per_chip_accessed']:.6g} on meta; K6 {row['k6']} "
        f"(counted run {row['k6_counted']}); logits finite {finite}; on "
        f"{card}")
    if (row["flops"], row["bytes"]) != (meta["flops_per_chip"],
                                        meta["bytes_per_chip_accessed"]):
        raise AssertionError(f"dry run {shape}: the card's count differs "
                             f"from meta's")
    for what, p in (("timed", peak), ("counted", peak_counted)):
        if abs(p / pred - 1) > DRYRUN_PEAK_TOL:
            raise AssertionError(f"dry run {shape}: the {what} run's peak "
                                 f"{p} is {p / pred:.3f}x the predicted "
                                 f"{pred}")
    if not finite:
        raise AssertionError(f"dry run {shape}: a logit is not finite")
    if row["k6"] != want_k6 or row["k6_counted"] != want_k6:
        raise AssertionError(f"dry run {shape}: K6 launched {row['k6']} and "
                             f"{row['k6_counted']} times, not {want_k6}")
    require_not_launched(c, [n for n in c if n not in (
        "flash_attention_fwd", K3_SWEEPS)], f"dry run {shape}")
    if kind == "prefill":
        row["k6_alone"] = k6_alone(cfg, batch, SHAPES[shape]["seq_len"],
                                   card)
    return row


def phase_dryrun(dev, counts: dict, card: str, jobs: list) -> dict:
    """The ``meta`` sweep of every arch x shape (``[dryrun]`` line per
    cell; each ``ok``, or ``skip`` exactly where ``cell_skip_reason`` says
    so; jamba-v0.1's rows for its card run), then DRYRUN_ARCH's
    prefill_32k at its global batch and decode_32k at the largest power of
    two up to its global batch whose predicted peak fits
    DRYRUN_DECODE_BYTES, each run whole on the card (``dryrun_on_card``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import LM_ARCHS, run_cell
    from repro_torch.launch.specs import SHAPES, cell_skip_reason
    res = finish_dryrun(jobs)
    rows = res["all"]
    if [(r["arch"], r["shape"]) for r in rows] != [
            (a, s) for a in LM_ARCHS for s in SHAPES]:
        raise AssertionError("the dry run's cells are not the 10 archs x 4 "
                             "shapes")
    for r in rows:
        skip = cell_skip_reason(get_config(r["arch"]), r["shape"])
        log(f"[dryrun] {dryrun_line(r)}")
        if r["status"] != ("skip" if skip else "ok") or (
                skip and r["reason"] != skip):
            raise AssertionError(f"dry run {r['arch']}/{r['shape']}: "
                                 f"{r['status']} ({r.get('error')}), the "
                                 f"reference's skip reason {skip}")
    jamba = {r["shape"]: round(r["bytes_per_chip"] / 2**30, 2)
             for r in rows if r["arch"] == "jamba-v0.1-52b"}
    log(f"[dryrun] jamba-v0.1-52b at its full depth, bf16, predicted GiB "
        f"per card (M9b.3b): {jamba}")
    shape = SHAPES["decode_32k"]
    batch = shape["global_batch"]
    preds = {}
    while True:
        r = (rows[[(x["arch"], x["shape"]) for x in rows].index(
            (DRYRUN_ARCH, "decode_32k"))] if batch == shape["global_batch"]
            else run_cell(DRYRUN_ARCH, "decode_32k", batch=batch,
                          verbose=False))
        preds[batch] = r["bytes_per_chip"]
        if r["bytes_per_chip"] <= DRYRUN_DECODE_BYTES or batch == 1:
            break
        batch //= 2
    log(f"[dryrun] {DRYRUN_ARCH}/decode_32k predicted GiB by batch "
        f"{ {b: round(p / 2**30, 2) for b, p in preds.items()} }: batch "
        f"{batch} on the card")
    cells = {"prefill_32k": dryrun_on_card(
        "prefill_32k", SHAPES["prefill_32k"]["global_batch"], counts, card,
        dev.type),
        "decode_32k": dryrun_on_card("decode_32k", batch, counts, card,
                                     dev.type)}
    return dict(rows=rows, cells=cells, train=res["train"])


# ---------------------------------------------------------------------------
# The model-parallel path: ranks on the one card
# ---------------------------------------------------------------------------

def mesh_bytes(cfg, mesh: tuple, train: bool) -> dict:
    """Each rank's reckoned bytes (float32): its blocks of the parameters
    (``Sharder.spec`` of every leaf on a ``mesh`` of (data, model); a
    server's in the serving placement, ``shard_model(fsdp=False)``, whole
    over data), and in training the largest layer's blocks made whole
    over data (FSDP gathers one layer at a time), the gradients (blocks)
    and the AdamW moments (whole on every rank, as the reference's
    launcher places them)."""
    import types

    from repro_torch.launch.specs import model_axes
    from repro_torch.models.layers import Sharder
    from repro_torch.models.model import Model
    sizes = dict(zip(("data", "model"), mesh))
    shd = Sharder(types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                        shape=mesh))
    axes = model_axes(cfg)
    blocks, layers, n_all = 0, {}, 0
    for name, p in Model(cfg, device="meta").named_parameters():
        spec = shd.spec(p.shape, axes[name] if train else tuple(
            None if a == "fsdp" else a for a in axes[name]))
        n = p.numel() // math.prod(sizes[e] for e in spec if e)
        blocks += 4 * n
        w = 4 * n * (sizes["data"] if "data" in spec else 1)
        key = name.split(".")[1] if name.startswith("layers.") else name
        layers[key] = layers.get(key, 0) + w
        n_all += p.numel()
    out = dict(param_blocks=blocks)
    if train:
        out.update(layer_whole=max(layers.values()), grads=blocks,
                   moments=2 * 4 * n_all)
    out["total"] = sum(out.values())
    return out


def mesh_rank(rank: int, world: int, job: dict) -> None:
    """One rank of a ``phase_mesh`` run (started by ``launch.mesh.spawn``):
    builds its blocks of the model, drives the path through the port's
    entry points with its launch counts set to 0 just before and read just
    after, and saves what it got to ``MESH_DIR/{job}.{rank}.pt``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import Sharder
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    shd = Sharder(make_host_mesh(job["mesh"][1]))
    got = {"rank": rank, "data": shd.axis("data").index,
           "model": shd.axis("model").index}
    t0 = time.perf_counter()
    if job["kind"] == "serve":
        model = mesh_serve_model(job, shd, dev)
        got["build_s"] = time.perf_counter() - t0
        # phi is drawn whole on the card: the build's peak apart
        got["build_peak"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prompts = shd.batch_rows(torch.tensor(
            serve_prompts(model.cfg.vocab), device=dev))
        with record_routing(scores=True) as seen:
            steps, t_pre, t_steps, c_pre, c_steps, _ = port_serve(
                model, prompts, SERVE_NEW, SERVE_S + SERVE_NEW)
        got.update(steps=steps, t_prefill=t_pre, t_steps=t_steps,
                   c_prefill=c_pre, c_steps=c_steps,
                   routing=[(n, c, d.cpu(), sc.cpu())
                            for n, c, d, sc in seen],
                   peak=torch.cuda.max_memory_allocated())
    else:
        got.update(mesh_train(shd, dev))
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(got, MESH_DIR / f"{job['name']}.{rank}.pt")


def smollm_weights() -> pathlib.Path:
    """smollm-135m's ``numpy_params`` weights (as ``phase_serve``'s) saved
    once for the ranks, which load them (memory-mapped) in place of drawing
    135 M numbers each."""
    from repro_torch.configs.base import get_config
    from repro_torch.interop import model_from_params, numpy_params
    cfg = get_config(SERVE_ARCH)
    path = MESH_DIR / "smollm-135m.pt"
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    torch.save(model_from_params(cfg, numpy_params(cfg, SEED),
                                 device="cpu").state_dict(), path)
    return path


def smollm_placed(shd, dev, fsdp: bool = True):
    """smollm-135m on ``smollm_weights``, this rank's blocks on ``dev``
    (the whole model without a mesh; ``fsdp=False``: the serving
    placement)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model, shard_model
    model = Model(get_config(SERVE_ARCH), device="cpu")
    model.load_state_dict(torch.load(MESH_DIR / "smollm-135m.pt",
                                     mmap=True, weights_only=True))
    if shd.mesh is None:
        return model.to(dev)
    return shard_model(model, shd, device=dev, fsdp=fsdp)


def mesh_config(arch: str):
    """The config a mesh run draws on the card: phi3.5-moe at MOE_LAYERS
    layers, deepseek-v2 at DS_LAYERS, mamba2-370m whole; full width."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return {MOE_ARCH: moe_config, MLA_ARCH: mla_config,
            SSM_ARCH: lambda c: c}[arch](cfg)


def mesh_serve_model(job: dict, shd, dev):
    """smollm-135m from ``numpy_params`` (as ``phase_serve``), or
    ``mesh_config``'s model drawn on the card from a generator of SEED (the
    single-rank reference draws the same), placed on ``shd`` in the
    serving placement (``shard_model(fsdp=False)``: split over model,
    whole over data): the ranks take turns building the whole model and
    keeping their blocks, so the card holds one whole model at a time."""
    from repro_torch.models.model import init_model, shard_model
    if job["arch"] == SERVE_ARCH:
        return smollm_placed(shd, dev, fsdp=False)
    import torch.distributed as dist
    cfg = mesh_config(job["arch"])
    model = None
    for turn in range(shd.mesh.size()):
        if turn == dist.get_rank():
            model = shard_model(init_model(
                cfg, torch.Generator(device=dev).manual_seed(SEED),
                device=dev), shd, fsdp=False)
            torch.cuda.empty_cache()
        shd.barrier()
    return model


def mesh_train_setup():
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import TrainConfig
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr_peak=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
        decay_steps=TRAIN_STEPS))
    return cfg, tcfg, DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                 global_batch=TRAIN_B, seed=SEED)


def mesh_train(shd, dev) -> dict:
    """MESH_TRAIN_STEPS steps of ``make_train_step`` (remat ``"full"``, as
    ``phase_train``) on smollm-135m from ``numpy_params`` and the
    ``make_batch`` rows of each step, this rank's rows of them (all of
    them without a mesh). Returns the metrics, walls and counts."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.step import init_train_state, make_train_step
    cfg, tcfg, dcfg = mesh_train_setup()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tcfg, smollm_placed(shd, dev))
    fn = make_train_step(cfg, tcfg)
    out = {"metrics": [], "walls": [], "counts": [],
           "build_s": time.perf_counter() - t0}
    for step in range(MESH_TRAIN_STEPS):
        batch = {k: shd.batch_rows(x)
                 for k, x in make_batch(dcfg, step, dev).items()}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["counts"].append(read_counts())
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def mesh_run(name: str, kind: str, arch: str, mesh: tuple) -> list:
    """Start ``prod(mesh)`` ranks for one run and read back each rank's
    result (a rank that fails fails the run: ``spawn`` raises)."""
    from repro_torch.launch.mesh import mesh_backend, spawn
    world = mesh[0] * mesh[1]
    for f in MESH_DIR.glob(f"{name}.*.pt"):
        f.unlink()
    t0 = time.perf_counter()
    spawn(mesh_rank, world, dict(name=name, kind=kind, arch=arch, mesh=mesh),
          device="cuda")
    wall = time.perf_counter() - t0
    got = [torch.load(MESH_DIR / f"{name}.{r}.pt", weights_only=False)
           for r in range(world)]
    build = [g["build_peak"] for g in got if "build_peak" in g]
    log(f"[mesh] {name}: {world} ranks on {mesh[0]} x {mesh[1]} over "
        f"{mesh_backend(world, 'cuda')}, {wall:.1f} s from start to end "
        f"(each rank's build {max(g['build_s'] for g in got):.1f} s at "
        f"most, peak device memory per rank "
        f"{max(g['peak'] for g in got) / 2**30:.2f} GiB"
        + (f", {max(build) / 2**30:.2f} GiB while building" if build
           else "") + ")")
    return got


def start_mesh_runs(*runs):
    """Start ``mesh_run`` of each of ``runs`` (its arguments), all at once
    (one thread each; their ranks share the card). Returns ``join()``,
    which waits for every run and returns their results; a run that fails
    fails it once all have ended."""
    import threading
    got, errors = [None] * len(runs), []

    def go(i, args):
        try:
            got[i] = mesh_run(*args)
        except BaseException as e:      # re-raised below, after the join
            errors.append(e)
    threads = [threading.Thread(target=go, args=(i, a))
               for i, a in enumerate(runs)]
    for t in threads:
        t.start()

    def join() -> list:
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return got
    return join


def mesh_k6(got: list, name: str, n_layers: int, counts: dict, key: str):
    """Every rank launched K6 once per layer in its prefill (on its heads)
    and nothing in decode; the launches go to ``counts[key]``."""
    for g in got:
        c = g["c_prefill"]
        if c["flash_attention_fwd"] != n_layers:
            raise AssertionError(f"{name} rank {g['rank']}: K6 launched "
                                 f"{c['flash_attention_fwd']} times in the "
                                 f"prefill, not once per layer ({n_layers})")
        require_not_launched(c, [n for n in c if n != "flash_attention_fwd"],
                             f"{name} prefill")
        for cs in g["c_steps"]:
            require_not_launched(cs, list(cs), f"{name} decode step")
    counts[key] = {n: sum(g["c_prefill"][n] for g in got)
                   for n in got[0]["c_prefill"]}


def mesh_rows(got: list, step_key: int = 1) -> list:
    """The mesh's generation as one batch: per step, the tokens and logits
    of every data rank's rows (model rank 0's), in row order; the ranks of
    each model row must agree on the tokens."""
    heads = sorted((g for g in got if g["model"] == 0),
                   key=lambda g: g["data"])
    for g in got:
        h = next(x for x in heads if x["data"] == g["data"])
        for (t, _), (t0, _) in zip(g["steps"], h["steps"]):
            if not np.array_equal(t, t0):
                raise AssertionError(f"rank {g['rank']}'s tokens differ "
                                     f"from its model row's")
    return [(np.concatenate([h["steps"][i][0] for h in heads]),
             np.concatenate([h["steps"][i][1] for h in heads]))
            for i in range(len(heads[0]["steps"]))]


def mesh_smollm_serve(dev, counts: dict, got: list) -> dict:
    """The 1 x 3 ranks' generation (``got``) against the single-rank port's
    on the same weights and prompts."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import NO_MESH
    cfg = get_config(SERVE_ARCH)
    mesh_k6(got, "mesh serve", cfg.n_layers, counts, "mesh_serve_prefill")
    model = smollm_placed(NO_MESH, dev)
    ref, t_pre, *_ = port_serve(model, torch.tensor(
        serve_prompts(cfg.vocab), device=dev), SERVE_NEW,
        SERVE_S + SERVE_NEW)
    del model
    check = check_serve(mesh_rows(got), [top5_records(lg) for _, lg in ref])
    t_mesh = max(g["t_prefill"] for g in got)
    step_mesh = max(np.mean(g["t_steps"]) for g in got)
    log(f"[mesh] smollm-135m serve on 1 x 3: each rank's K6 launches per "
        f"prefill {[g['c_prefill']['flash_attention_fwd'] for g in got]}; "
        f"against the single-rank port (check_serve's rule) {check}; "
        f"prefill {t_mesh * 1e3:.1f} ms (single rank {t_pre * 1e3:.1f} ms), "
        f"decode {step_mesh * 1e3:.1f} ms a step")
    return dict(check=check, prefill_s=t_mesh, single_prefill_s=t_pre,
                decode_step_s=step_mesh)


def mesh_smollm_train(dev, counts: dict, got: list) -> dict:
    """The 2 x 3 ranks' steps (``got``) against the single rank's on the
    same weights and rows."""
    from repro_torch.models.layers import NO_MESH
    cfg = mesh_train_setup()[0]
    ref = mesh_train(NO_MESH, dev)
    torch.cuda.empty_cache()
    errs = []
    for g in got:
        for step, (m, w) in enumerate(zip(g["metrics"], ref["metrics"])):
            dl = abs(m["loss"] - w["loss"]) / abs(w["loss"])
            dn = abs(m["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
            if not (dl <= TRAIN_LOSS_TOL and dn <= TRAIN_NORM_TOL):
                raise AssertionError(
                    f"mesh train rank {g['rank']} step {step}: loss "
                    f"{m['loss']} / grad_norm {m['grad_norm']} against the "
                    f"single rank's {w['loss']} / {w['grad_norm']}")
            errs.append((dl / TRAIN_LOSS_TOL, dn / TRAIN_NORM_TOL))
        for c in g["counts"]:
            if c["flash_attention_fwd"] != 2 * cfg.n_layers:
                raise AssertionError(f"mesh train rank {g['rank']}: K6 "
                                     f"launched {c['flash_attention_fwd']} "
                                     f"times, not twice per layer")
    counts["mesh_train_step"] = {n: sum(g["counts"][-1][n] for g in got)
                                 for n in got[0]["counts"][-1]}
    wall = [max(g["walls"][i] for g in got) for i in range(MESH_TRAIN_STEPS)]
    log(f"[mesh] smollm-135m train on 2 x 3 ({TRAIN_B} x {TRAIN_S} tokens, "
        f"{TRAIN_B // MESH_TRAIN[0]} rows a data rank, remat full): losses "
        f"{[m['loss'] for m in got[0]['metrics']]} against the single "
        f"rank's {[m['loss'] for m in ref['metrics']]}, grad_norm "
        f"{[m['grad_norm'] for m in got[0]['metrics']]} against "
        f"{[m['grad_norm'] for m in ref['metrics']]}; largest error / "
        f"tolerance (loss, grad_norm) {max(errs)}; K6 launches per step "
        f"per rank {[g['counts'][-1]['flash_attention_fwd'] for g in got]};"
        f" step walls {[round(w, 3) for w in wall]} s (single rank "
        f"{[round(w, 3) for w in ref['walls']]} s)")
    return dict(errs=max(errs), walls=wall, single_walls=ref["walls"])


@contextlib.contextmanager
def pinned_routing(calls: list):
    """Route every MoE call of ``models.mlp`` on the given scores (one per
    call, in call order) in place of the port's own; yields the calls'
    ``(name, capacity, dispatch, largest |own - given| / largest |given|)``."""
    from repro_torch.models import mlp
    originals = {n: getattr(mlp, n) for n in ("auction_route", "topk_route")}
    seen = []

    def pin(name):
        def route(s, k, capacity, **kw):
            ref = calls[len(seen)].to(s.device)
            r = originals[name](ref, k, capacity, **kw)
            seen.append((name, capacity, r.dispatch.clone(), float(
                (s.float() - ref).abs().max() / ref.abs().max())))
            return r
        return route
    try:
        for name in originals:
            setattr(mlp, name, pin(name))
        yield seen
    finally:
        for name, fn in originals.items():
            setattr(mlp, name, fn)


def grouped_sharder(n: int):
    """A ``Sharder`` without a mesh whose ``data_groups`` is ``n``: one
    card's MoE routes its batch as ``n`` data ranks would."""
    from repro_torch.models.layers import Sharder

    class GroupedSharder(Sharder):
        @property
        def data_groups(self) -> int:
            return n
    return GroupedSharder()


def mesh_routed_serve(dev, counts: dict, got: list, arch: str,
                      mesh: tuple) -> dict:
    """An MoE model's ranks on ``mesh`` (``got``: phi3.5-moe on 2 x 2,
    deepseek-v2 on 1 x 2); then one rank routing as the mesh's data ranks
    (``grouped_sharder``) on the mesh's gate logits: its router gives the
    mesh's dispatch bit for bit and its logits agree with the mesh's."""
    from repro_torch.models.model import init_model
    cfg = mesh_config(arch)
    tag = f"mesh {cfg.name}"
    mesh_k6(got, tag, cfg.n_layers, counts, f"mesh_{arch}_prefill")
    heads = sorted((g for g in got if g["model"] == 0),
                   key=lambda g: g["data"])
    for g in got:           # a model row routes alike
        h = heads[g["data"]]
        for a, b in zip(g["routing"], h["routing"]):
            if not torch.equal(a[2], b[2]):
                raise AssertionError(f"{tag} rank {g['rank']} routed "
                                     f"otherwise than its model row")
    n_calls = len(heads[0]["routing"])
    scores = [torch.cat([h["routing"][i][3] for h in heads])
              for i in range(n_calls)]
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    model.shd = grouped_sharder(mesh[0])
    with pinned_routing(scores) as seen:
        ref, t_pre, *_ = port_serve(model, torch.tensor(
            serve_prompts(cfg.vocab), device=dev), SERVE_NEW,
            SERVE_S + SERVE_NEW)
    del model
    torch.cuda.empty_cache()
    if len(seen) != n_calls:
        raise AssertionError(f"{tag}: {len(seen)} router calls, the mesh's "
                             f"ranks made {n_calls}")
    routed = 0
    for i, (name, cap, disp, _) in enumerate(seen):
        want = torch.cat([h["routing"][i][2] for h in heads])
        if name != heads[0]["routing"][i][0] or cap != \
                heads[0]["routing"][i][1]:
            raise AssertionError(f"{tag} router call {i}: {name} at "
                                 f"capacity {cap}, the mesh's "
                                 f"{heads[0]['routing'][i][:2]}")
        if not torch.equal(disp.cpu(), want):
            raise AssertionError(f"{tag} router call {i} ({name}): the "
                                 f"single rank's dispatch differs from the "
                                 f"mesh's in "
                                 f"{int((disp.cpu() != want).any(-1).sum())}"
                                 f" tokens")
        routed += int(want.sum())
    check = check_serve(mesh_rows(got), [top5_records(lg) for _, lg in ref])
    drift = max(d for *_, d in seen)
    t_mesh = max(g["t_prefill"] for g in got)
    step_mesh = max(np.mean(g["t_steps"]) for g in got)
    log(f"[mesh] {cfg.name} ({cfg.n_layers} layers) serve on {mesh[0]} x "
        f"{mesh[1]}: {n_calls} router calls (prefill {n_calls // SERVE_NEW} "
        f"auctions of "
        f"{SERVE_B // mesh[0] * SERVE_S} tokens a group), {routed} "
        f"decisions, dispatch equal bit for bit; the single rank's own gate "
        f"logits off the mesh's by {drift:.3g} of their largest; logits "
        f"against it (check_serve's rule) {check}; prefill "
        f"{t_mesh * 1e3:.1f} ms (single rank {t_pre * 1e3:.1f} ms), decode "
        f"{step_mesh * 1e3:.1f} ms a step; K6 launches per prefill "
        f"{[g['c_prefill']['flash_attention_fwd'] for g in got]}")
    return dict(check=check, routed=routed, drift=drift, prefill_s=t_mesh,
                single_prefill_s=t_pre, decode_step_s=step_mesh)


def mesh_ssm_serve(dev, counts: dict, got: list) -> dict:
    """mamba2-370m's 1 x 2 ranks (``got``) against the single-rank port on
    the same weights and prompts; no port kernel launched on any rank."""
    from repro_torch.models.model import init_model
    cfg = mesh_config(SSM_ARCH)
    for g in got:
        require_not_launched(g["c_prefill"], list(g["c_prefill"]),
                             f"mesh ssm rank {g['rank']} prefill")
        for c in g["c_steps"]:
            require_not_launched(c, list(c), f"mesh ssm rank {g['rank']} "
                                 f"decode step")
    counts["mesh_ssm_prefill"] = {n: sum(g["c_prefill"][n] for g in got)
                                  for n in got[0]["c_prefill"]}
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    ref, t_pre, t_steps, *_ = port_serve(model, torch.tensor(
        serve_prompts(cfg.vocab), device=dev), SERVE_NEW,
        SERVE_S + SERVE_NEW)
    del model
    torch.cuda.empty_cache()
    check = check_serve(mesh_rows(got), [top5_records(lg) for _, lg in ref])
    t_mesh = max(g["t_prefill"] for g in got)
    step_mesh = max(np.mean(g["t_steps"]) for g in got)
    log(f"[mesh] {cfg.name} ({cfg.n_layers} layers) serve on {MESH_SSM[0]} "
        f"x {MESH_SSM[1]}, {SERVE_NEW} new tokens: against the single-rank "
        f"port (check_serve's rule) {check}; prefill {t_mesh * 1e3:.1f} ms "
        f"(single rank {t_pre * 1e3:.1f} ms), decode {step_mesh * 1e3:.1f} "
        f"ms a step (single rank {np.mean(t_steps) * 1e3:.1f} ms); no port "
        f"kernel launched")
    return dict(check=check, prefill_s=t_mesh, single_prefill_s=t_pre,
                decode_step_s=step_mesh)


def mesh_k6_alone(card: str) -> dict:
    """K6 alone at an MLA rank's prefill on 1 x 2 (SERVE_B x SERVE_S, its
    64 of deepseek-v2's 128 heads, qk 192 / v 128, causal, float32, scale
    192 ** -0.5): device ms of one call against its bound."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    cfg = mesh_config(MLA_ARCH)
    m = cfg.mla
    H = cfg.n_heads // MESH_MLA[1]
    qk = m.qk_nope_dim + m.qk_rope_dim
    dims = (SERVE_B, SERVE_S, SERVE_S, H, H, qk, m.v_dim)
    q, k, v = flash_inputs(np.random.default_rng(SEED), dims, torch.float32,
                           torch.device("cuda"))
    t = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                            scale=qk ** -0.5),
                reps=10, symbol="flash_fwd_")
    b = flash_bounds(dims, True, torch.float32)
    log(f"[mesh] K6 alone at an MLA rank's head shard {dims}, causal, "
        f"float32: {t.ms:.4f} ms a launch ({t.source}), bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"({t.ms / b['bound_ms']:.2f}x); on {card}")
    return dict(dims=list(dims), ms=t.ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"])


def phase_mesh(dev, counts: dict, card: str) -> dict:
    """The model meshes (ROADMAP M9b.8, M9b.8b) on the one card: each
    rank's reckoned bytes, then smollm-135m served on 1 x 3, phi3.5-moe
    served on 2 x 2 and smollm-135m trained on 2 x 3, the 13 ranks at
    once; then deepseek-v2 (MLA) and mamba2-370m (Mamba2) served on 1 x 2
    while the first three are held to the single-rank port; each run held
    to the single-rank port (see MESH_DIR's note)."""
    from repro_torch.configs.base import get_config
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the mesh checks assume "
                             "full float32")
    plans = [("serve", get_config(SERVE_ARCH), MESH_SERVE, False),
             ("train", get_config(TRAIN_ARCH), MESH_TRAIN, True),
             ("moe", mesh_config(MOE_ARCH), MESH_MOE, False),
             ("mla", mesh_config(MLA_ARCH), MESH_MLA, False),
             ("ssm", mesh_config(SSM_ARCH), MESH_SSM, False)]
    for name, cfg, mesh, train in plans:
        b = mesh_bytes(cfg, mesh, train)
        log(f"[mesh] {name} ({cfg.name}, {mesh[0]} x {mesh[1]}): reckoned "
            f"per rank " + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                                     for k, v in b.items())
            + f"; {mesh[0] * mesh[1]} ranks {mesh[0] * mesh[1] * b['total'] / 2**30:.2f}"
            f" GiB of the card's 80 with activations on top")
    smollm_weights()
    t0 = time.perf_counter()
    serve, moe, train = start_mesh_runs(
        ("serve", "serve", SERVE_ARCH, MESH_SERVE),
        ("moe", "serve", MOE_ARCH, MESH_MOE),
        ("train", "train", TRAIN_ARCH, MESH_TRAIN))()
    t1 = time.perf_counter()
    join = start_mesh_runs(("mla", "serve", MLA_ARCH, MESH_MLA),
                           ("ssm", "serve", SSM_ARCH, MESH_SSM))
    try:
        out = {"serve": mesh_smollm_serve(dev, counts, serve),
               "moe": mesh_routed_serve(dev, counts, moe, MOE_ARCH,
                                        MESH_MOE),
               "train": mesh_smollm_train(dev, counts, train)}
    finally:
        mla, ssm = join()
    t2 = time.perf_counter()
    out["mla"] = mesh_routed_serve(dev, counts, mla, MLA_ARCH, MESH_MLA)
    out["mla"]["k6"] = mesh_k6_alone(card)
    out["ssm"] = mesh_ssm_serve(dev, counts, ssm)
    log(f"[mesh] every rank of every run ended with code 0 on {card}; the "
        f"first three runs {t1 - t0:.1f} s, then deepseek-v2's and "
        f"mamba2's beside their checks {t2 - t1:.1f} s, their checks "
        f"{time.perf_counter() - t2:.1f} s")
    return out


def timed(walls: dict, name: str, fn, *a, **kw):
    """``fn(*a, **kw)``, its wall in seconds kept as ``walls[name]`` and
    logged."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    walls[name] = time.perf_counter() - t0
    log(f"[{name}] done in {walls[name]:.1f} s")
    return out


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 1
    jobs = start_dryrun()
    try:
        return run_smoke(jobs)
    finally:
        stop_dryrun(jobs)


def run_smoke(jobs: list) -> int:
    from repro_torch.core.maxflow.ref import (maxflow_grid_ref,
                                              random_grid_problem)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[build] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, report in _build.build_all().items():
        log(f"[build] {name}.cu:\n{report.strip()}")
    walls = {"build": time.perf_counter() - t0}
    log(f"[build] done in {walls['build']:.1f} s")

    kernels = timed(walls, "kernels", phase_kernels, dev, card)

    rng = np.random.default_rng(SEED)
    problems = [random_grid_problem(rng, H, W) for _ in range(B)]
    oracle = [maxflow_grid_ref(*p) for p in problems]
    log(f"[main] scipy oracle flows {oracle}")
    counts = {}
    prob, in_solve = timed(walls, "main", phase_main, dev, problems, oracle,
                           counts)
    in_solve.update(timed(walls, "balanced", phase_balanced, dev, prob,
                          oracle, counts))
    kernels["bidding"]["in_solve"] = timed(walls, "assignment",
                                           phase_assignment, dev, counts)
    kernels["frontier"]["in_solve"] = timed(
        walls, "matching", phase_matching, dev, counts)["k5_in_solve"]
    batch, batch_oracles = timed(walls, "batch", phase_batch, dev, counts,
                                 card)
    log(f"[batch] {batch}")
    warm = timed(walls, "warm", phase_warm, dev, counts, problems, card)
    timed(walls, "engine", phase_engine, dev, counts, problems, oracle, warm,
          batch_oracles, card)
    serve = timed(walls, "serve", phase_serve, dev, counts)
    k6 = serve["prefill"]["port_kernels"]
    kernels["flash_attention_fwd"]["prefill_ms_per_launch"] = (
        sum(ms for ms, _ in k6.values()) / sum(n for _, n in k6.values()))
    float_step = serve["t_step"]
    del serve
    moe = timed(walls, "moe", phase_moe, dev, counts, card)
    ms, n = moe["prefill"]["port_kernels"]["flash_fwd_mma"]
    kernels["flash_attention_fwd"]["moe_shape"].update(
        prefill_ms_per_launch=ms / n, prefill_launches=n)
    del moe
    mla = timed(walls, "mla", phase_mla, dev, counts, card)
    ms, n = mla["prefill"]["port_kernels"]["flash_fwd_mma"]
    kernels["flash_attention_fwd"]["mla_shape"].update(
        prefill_ms_per_launch=ms / n, prefill_launches=n)
    del mla
    timed(walls, "ssm", phase_ssm, dev, counts, card)
    train = timed(walls, "train", phase_train, dev, counts, card)
    ms, n = train["profile"]["port_kernels"]["flash_fwd_wgmma"]
    kernels["flash_attention_fwd"]["train"] = dict(
        launches_per_step=counts["train_step"]["flash_attention_fwd"],
        profiled_ms_per_launch=ms / n)
    del train
    enc = timed(walls, "encoder", phase_encoder, dev, counts, card)
    (f_ms, f_n), (s_ms, s_n) = (enc[k]["port_kernels"]["flash_fwd_mma"]
                                for k in ("forward", "step"))
    kernels["flash_attention_fwd"]["hubert_shape"].update(
        launches_per_forward=counts["encoder_forward"]["flash_attention_fwd"],
        launches_per_train_step=counts["encoder_train_step"][
            "flash_attention_fwd"],
        forward_ms_per_launch=f_ms / f_n, train_ms_per_launch=s_ms / s_n,
        train_bound_ms=flash_bounds(encoder_attention_shape(ENC_TRAIN_B),
                                    False, torch.float32)["bound_ms"])
    del enc
    timed(walls, "kvq", phase_kvq, dev, counts, card, float_step)
    mesh = timed(walls, "mesh", phase_mesh, dev, counts, card)
    kernels["flash_attention_fwd"]["mla_mesh_shard"] = dict(
        mesh["mla"]["k6"], prefill_launches=counts[
            f"mesh_{MLA_ARCH}_prefill"]["flash_attention_fwd"])
    del mesh
    dry = timed(walls, "dryrun", phase_dryrun, dev, counts, card, jobs)
    pre = dry["cells"]["prefill_32k"]
    kernels["flash_attention_fwd"]["prefill_32k"] = dict(
        launches=pre["k6"], wall_ms=pre["wall"] * 1e3, batch=pre["batch"])
    del dry
    # K1-K3 inside each profiled grid solve, under the wrapper's name
    for name, symbol in (("grid_push_decide", "grid_push_decide_kernel"),
                         ("grid_push_decide_sched",
                          "grid_push_decide_sched_kernel"),
                         ("bfs_relabel_sweeps", "bfs_relabel_sweep_tiles")):
        kernels[name]["in_solve"] = {k: v[symbol] for k, v in in_solve.items()
                                     if symbol in v}
    kernels["bfs_relabel_sweeps"]["sweeps_per_solve"] = {
        k: c[K3_SWEEPS] for k, c in counts.items() if c[K3_SWEEPS]}
    busy = {k: (v["busy_s"], v["idle_share"]) for k, v in in_solve.items()}
    log(f"[grid] device busy (s) and idle share per solve: {busy}")

    # max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by (+ details;
    # K6 replaces equal with its tolerance) come from phase_kernels;
    # launches are summed over the solves, and listed per solve where
    # non-zero
    rows = [{**dict(name=name, route="cuda", source=source,
                    replaces=replaces,
                    launches=sum(c[name] for c in counts.values()),
                    launches_per_solve={k: c[name]
                                        for k, c in counts.items() if c[name]},
                    equal=True, card=card), **kernels[name]}
            for name, (source, replaces) in KERNEL_SOURCES.items()]
    walls["all"] = time.perf_counter() - t0
    log(f"[walls] seconds per phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    log(f"[done] launches per phase {counts}; {walls['all']:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
